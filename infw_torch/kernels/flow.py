"""The flow tier's device columns and programs: kernels K7 (the fused flow
probe) and K8 (the flow batch insert), their plain versions, and the age
sweep and occupancy count.

Counterpart of the flow half of the JAX package's ``kernels/jaxpath.py``
(``FlowTable``, ``flow_key_words``, ``_flow_hash``, ``_flow_slots``,
``_flow_probe_core``, ``_flow_insert_core``, ``jitted_flow_age``,
``jitted_flow_occupancy``).  There those programs are XLA, not Pallas;
here the probe and the insert are hand-written CUDA kernels
(``csrc/flow_table.cu``), because as torch ops each would be a few dozen
launches of gathers and scatters per chunk.

- ``FlowTable``: C = pages * slab_entries rows, int32 tensors on one
  device: ``keys`` (C, 8) holding the u32 key words, ``vg`` (C, 2)
  [cached res16 verdict, tenant generation], ``se`` (C, 2) [FLOW_* state,
  last-seen epoch], ``cnt`` (C, 3) [packets, sum(len >> 8), sum(len &
  0xFF)], plus ``winner`` (C,), K8's per-slot scratch, -1 between calls.
- ``flow_probe`` (K7): serve the cached verdicts of a packed 4- or 7-word
  wire and update the hit lanes' counters and TCP state in place; returns
  the fused read-back buffer that ``split_flow_probe_outputs`` decodes.
- ``flow_insert`` (K8): batch-insert miss verdicts in place; returns
  (4,) int32 [inserts, evictions, promotes, 0].
- ``flow_probe_resident`` / ``flow_insert_resident``: the same kernels
  through their resident entries, for the resident step
  (kernels/resident.py): both serve the device epoch + 1 (a (1,) int32
  tensor, so a CUDA graph replays them with the epoch of their turn); the
  probe writes into a caller-given buffer; the insert takes the whole
  batch, the stateless verdicts as packed res16 words and the probe's hit
  bitmap, merges the verdicts of the lanes that missed into the probe's
  res16 words, inserts those lanes only (lane_ok = ~hit), writes its
  counts where the caller says and advances the device epoch.
- ``flow_age`` / ``flow_occupancy``: one elementwise pass and one
  reduction over ``se``, plain PyTorch on both devices.

Both kernels update the columns in place.  XLA reads every lane's
candidate rows from the old columns before any scatter; each kernel keeps
that in one cooperative launch whose phases are grid barriers apart (see
the source).  On a CPU tensor the wrappers run the plain versions; on a
CUDA tensor they launch the kernel or raise.  A call checks the table's
columns and geometry only when the table is not the last one checked
(``_check_table``), its other operands every time, and allocates one
buffer: the output with the kernel's lane scratch behind it.
"""
from __future__ import annotations

import ctypes
import weakref
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..constants import (
    FLOW_EMPTY,
    FLOW_EST,
    FLOW_FIN,
    FLOW_KEY_WORDS,
    FLOW_NEW,
    IPPROTO_TCP,
    KIND_IPV4,
    KIND_IPV6,
    TCP_ACK,
    TCP_FIN,
    TCP_RST,
    TCP_SYN,
)
from . import _build
from .arena_walk import arena_pages
from .torchpath import DeviceBatch, _pack_res16, unpack_res16_host, unpack_wire, wrap_int32

INT32_MAX = np.iinfo(np.int32).max
PROBE_KERNEL = _build.Kernel(
    "flow_probe", "infw_flow_probe",
    [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10 + [ctypes.c_void_p],
    source="flow_table",
)
INSERT_KERNEL = _build.Kernel(
    "flow_insert", "infw_flow_insert",
    [ctypes.c_void_p] * 13 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
    source="flow_table",
)
PROBE_RESIDENT_KERNEL = _build.Kernel(
    "flow_probe_resident", "infw_flow_probe_resident",
    [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
    source="flow_table",
)
INSERT_RESIDENT_KERNEL = _build.Kernel(
    "flow_insert_resident", "infw_flow_insert_resident",
    [ctypes.c_void_p] * 16 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    source="flow_table",
)


class FlowTable(NamedTuple):
    """The flow tier's device columns (see the module docstring)."""

    keys: torch.Tensor    # (C, 8) int32: tenant, ifindex, ip0..3, m0, m1
    vg: torch.Tensor      # (C, 2) int32: cached res16 verdict, tenant generation
    se: torch.Tensor      # (C, 2) int32: FLOW_* state, last-seen epoch
    cnt: torch.Tensor     # (C, 3) int32: packets, sum(len >> 8), sum(len & 0xFF)
    winner: torch.Tensor  # (C,) int32: K8's per-slot scratch, -1 between calls

    @property
    def capacity(self) -> int:
        return self.se.shape[0]


#: the four columns a flow table's state is (``winner`` is scratch)
COLUMNS = ("keys", "vg", "se", "cnt")


def empty_flow_table(capacity: int, device) -> FlowTable:
    """Zero columns of ``capacity`` rows and a cleared scratch."""
    z = lambda w: torch.zeros((capacity, w), dtype=torch.int32, device=device)  # noqa: E731
    return FlowTable(keys=z(FLOW_KEY_WORDS), vg=z(2), se=z(2), cnt=z(3),
                     winner=torch.full((capacity,), -1, dtype=torch.int32, device=device))


def clone_flow_table(flow: FlowTable) -> FlowTable:
    return FlowTable(*(t.clone() for t in flow))


# --- the plain versions --------------------------------------------------------


def flow_key_words(b: DeviceBatch, tenant: torch.Tensor) -> torch.Tensor:
    """(B, 8) int64 u32 key words covering every field the verdict depends
    on (jaxpath.flow_key_words); pkt_len only feeds statistics."""
    m0 = ((b.proto.long() & 0xFF) | ((b.dst_port.long() & 0xFFFF) << 8)
          | ((b.kind.long() & 3) << 24) | ((b.l4_ok.long() & 1) << 26))
    m1 = (b.icmp_type.long() & 0xFF) | ((b.icmp_code.long() & 0xFF) << 8)
    cols = [tenant.long(), b.ifindex.long()] + [b.ip_words[:, k].long() for k in range(4)]
    return torch.stack(cols + [m0, m1], dim=1) & 0xFFFFFFFF


def flow_hash(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """FNV-1a over the 8 key words -> (h1, h2 | 1), u32 in int64 with the
    32-bit wrap after each multiply (jaxpath._flow_hash)."""
    h = torch.full(keys.shape[:1], 0x811C9DC5, dtype=torch.int64, device=keys.device)
    for w in range(FLOW_KEY_WORDS):
        h = ((h ^ keys[:, w]) * 0x01000193) & 0xFFFFFFFF
    return h, (h >> 16) | 1  # h < 2^32: the shift is logical


def flow_slots(keys: torch.Tensor, page: torch.Tensor, *, slab_entries: int,
               ways: int) -> torch.Tensor:
    """(B, W) int64 global candidate slots: page-local double hashing, page
    -1 clipped to 0 so ineligible lanes still gather in range
    (jaxpath._flow_slots)."""
    h1, h2 = flow_hash(keys)
    w = torch.arange(ways, dtype=torch.int64, device=keys.device)[None, :]
    local = (h1[:, None] + w * h2[:, None]) & (slab_entries - 1)
    return page.clamp(min=0)[:, None] * slab_entries + local


def _lanes(flow: FlowTable, gens, page_table, wire, tenant, *, slab_entries, ways):
    b = unpack_wire(wire)
    page = arena_pages(page_table, tenant)
    keyw = flow_key_words(b, tenant)
    cand = flow_slots(keyw, page, slab_entries=slab_entries, ways=ways)
    is_ip = (b.kind == KIND_IPV4) | (b.kind == KIND_IPV6)
    mygen = gens[tenant.long().clamp(0, gens.shape[0] - 1)]
    # the u32 keys compared as their int32 bit patterns
    keyw32 = wrap_int32(keyw)
    match_all = torch.all(flow.keys[cand] == keyw32[:, None, :], dim=2)
    return b, page, keyw32, cand, is_ip, mygen, match_all


def _counter_rows(pkt_len: torch.Tensor) -> torch.Tensor:
    ln = pkt_len.long()
    return torch.stack([torch.ones_like(ln), (ln >> 8) & 0xFFFFFF, ln & 0xFF], dim=1)


def pack_bits32(mask: torch.Tensor) -> torch.Tensor:
    """(B,) bool -> ceil(B / 32) int32 LSB-first bitmap words
    (jaxpath._pack_bits32)."""
    b = mask.shape[0]
    nw = -(-b // 32)
    m = torch.zeros(nw * 32, dtype=torch.int64, device=mask.device)
    m[:b] = mask.long()
    shifts = torch.arange(32, dtype=torch.int64, device=mask.device)
    return wrap_int32((m.view(nw, 32) << shifts).sum(dim=1))


def unpack_bits32(words: torch.Tensor, b: int) -> torch.Tensor:
    """Inverse of pack_bits32 on the tensor's device -> (b,) bool."""
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = ((words.long() & 0xFFFFFFFF)[:, None] >> shifts) & 1
    return bits.reshape(-1)[:b] != 0


def unpack_res16(words: torch.Tensor, b: int) -> torch.Tensor:
    """Packed res16 words -> (b,) int64 on the tensor's device (the
    inverse of torchpath._pack_res16)."""
    w = words.long() & 0xFFFFFFFF
    return torch.stack([w & 0xFFFF, w >> 16], dim=1).reshape(-1)[:b]


def unpack_bits32_host(words: np.ndarray, b: int) -> np.ndarray:
    u = np.asarray(words).view(np.uint32)
    bits = (u[:, None] >> np.arange(32, dtype=np.uint32)[None, :]) & 1
    return bits.reshape(-1)[:b].astype(bool)


def probe_out_words(b: int) -> int:
    """Words of K7's read-back buffer: the u16 results, the hit bitmap,
    then [hits, stale]."""
    return (b + 1) // 2 + -(-b // 32) + 2


def split_flow_probe_outputs(arr: np.ndarray, b: int):
    """Host inverse of the probe's fused buffer -> (res16[b], hit mask (b,)
    bool, hits, stale) (jaxpath.split_flow_probe_outputs)."""
    nw = (b + 1) // 2
    res16 = unpack_res16_host(arr[:nw], b)
    nh = -(-b // 32)
    hit = unpack_bits32_host(arr[nw: nw + nh], b)
    return res16, hit, int(arr[nw + nh]), int(arr[nw + nh + 1])


def flow_probe_plain(flow: FlowTable, gens, page_table, wire, tenant, tflags,
                     epoch_now: int, max_age: int, *, slab_entries: int,
                     ways: int) -> torch.Tensor:
    """K7's function in plain PyTorch (jaxpath._flow_probe_core): a lane
    hits on the first way whose key matches, whose state is EST or FIN,
    whose generation is the tenant's and whose epoch is within ``max_age``
    of ``epoch_now`` (int32 wrap); a match that fails only the generation
    is a stale reject.  The hit lanes' ``cnt`` rows gain [1, len >> 8, len
    & 0xFF], then one max over ``se`` (FIN half-close, the last-seen
    epoch) lands before one min (RST teardown).  Updates ``flow.se`` and
    ``flow.cnt`` in place; returns the fused int32 buffer."""
    b, page, _keyw, cand, is_ip, mygen, match_all = _lanes(
        flow, gens, page_table, wire, tenant, slab_entries=slab_entries, ways=ways)
    elig = is_ip & (b.l4_ok != 0) & (page >= 0)
    ese = flow.se[cand]
    evg = flow.vg[cand]
    match = match_all & elig[:, None]
    live = ese[:, :, 0] >= FLOW_EST
    gen_ok = evg[:, :, 1] == mygen[:, None]
    fresh = wrap_int32(epoch_now - ese[:, :, 1].long()) <= max_age
    hit_w = match & live & gen_ok & fresh
    stale_w = match & live & fresh & ~gen_ok
    widx = torch.arange(ways, device=wire.device)[None, :]
    first = torch.where(hit_w, widx, ways).min(dim=1).values
    hit = first < ways
    pick = first.clamp(max=ways - 1)[:, None]
    sel = cand.gather(1, pick)[:, 0]
    stale = stale_w.any(dim=1) & ~hit
    served = torch.where(hit, evg[:, :, 0].gather(1, pick)[:, 0], 0)

    hs = sel[hit]
    cnt = flow.cnt.long().index_add_(0, hs, _counter_rows(b.pkt_len)[hit])
    flow.cnt.copy_(wrap_int32(cnt))
    is_tcp = b.proto == IPPROTO_TCP
    fin = is_tcp & ((tflags & TCP_FIN) != 0)
    rst = is_tcp & ((tflags & TCP_RST) != 0)
    state_mx = torch.where(fin, FLOW_FIN, -1).to(torch.int32)[hit]
    se0, se1 = flow.se[:, 0].clone(), flow.se[:, 1].clone()
    se0.scatter_reduce_(0, hs, state_mx, "amax")
    se1.scatter_reduce_(0, hs, torch.full_like(state_mx, epoch_now), "amax")
    hr = sel[hit & rst]
    se0.scatter_reduce_(0, hr, torch.full_like(hr, FLOW_EMPTY, dtype=torch.int32), "amin")
    se1.scatter_reduce_(0, hr, torch.full_like(hr, INT32_MAX, dtype=torch.int32), "amin")
    flow.se.copy_(torch.stack([se0, se1], dim=1))
    counts = torch.stack([hit.sum(), stale.sum()]).to(torch.int32)
    return torch.cat([_pack_res16(served), pack_bits32(hit), counts])


def flow_insert_plain(flow: FlowTable, gens, page_table, wire, tenant, tflags,
                      verdict, epoch_now: int, *, slab_entries: int,
                      ways: int, lane_ok=None) -> torch.Tensor:
    """K8's function in plain PyTorch (jaxpath._flow_insert_core): each
    lane picks the way holding its key (any live state), else the first
    empty way, else the oldest epoch (the first of equal epochs); the last
    eligible lane of a slot in batch order writes the row, whose counters
    are the sums over every eligible lane that chose the slot.  RST lanes,
    non-IP kinds, l4_ok = 0, page -1 and, when ``lane_ok`` (B,) bool is
    given, its False lanes are ineligible.  Updates ``keys``, ``vg``,
    ``se`` and ``cnt`` in place; returns (4,) int32 [inserts, evictions,
    promotes, 0]."""
    b, page, keyw32, cand, is_ip, mygen, match_all = _lanes(
        flow, gens, page_table, wire, tenant, slab_entries=slab_entries, ways=ways)
    is_tcp = b.proto == IPPROTO_TCP
    syn = is_tcp & ((tflags & TCP_SYN) != 0)
    ack = is_tcp & ((tflags & TCP_ACK) != 0)
    fin = is_tcp & ((tflags & TCP_FIN) != 0)
    rst = is_tcp & ((tflags & TCP_RST) != 0)
    elig = is_ip & (b.l4_ok != 0) & (page >= 0) & ~rst
    if lane_ok is not None:
        elig = elig & lane_ok
    ese = flow.se[cand]
    est, eep = ese[:, :, 0], ese[:, :, 1]
    match_w = match_all & (est > 0)
    empty_w = est == 0
    widx = torch.arange(ways, device=wire.device)[None, :]
    m_first = torch.where(match_w, widx, ways).min(dim=1).values
    e_first = torch.where(empty_w, widx, ways).min(dim=1).values
    oldest = eep.argmin(dim=1)  # the first of equal epochs
    way = torch.where(m_first < ways, m_first, torch.where(e_first < ways, e_first, oldest))
    slot = cand.gather(1, way[:, None])[:, 0]
    matched = m_first < ways
    old_state = est.gather(1, way[:, None])[:, 0]

    # per distinct slot of the eligible lanes: the last lane and the sums
    el = torch.nonzero(elig)[:, 0]
    uniq, inv = torch.unique(slot[el], return_inverse=True)
    last = torch.full((uniq.shape[0],), -1, dtype=torch.int64, device=wire.device)
    last.scatter_reduce_(0, inv, el, "amax")
    seeds = torch.zeros((uniq.shape[0], 3), dtype=torch.int64, device=wire.device)
    seeds.index_add_(0, inv, _counter_rows(b.pkt_len)[el])
    win_el = last[inv] == el
    win = torch.zeros_like(elig)
    win[el[win_el]] = True

    state_val = torch.where(fin, FLOW_FIN,
                            torch.where(is_tcp & syn & ~ack, FLOW_NEW, FLOW_EST)).to(torch.int32)
    ws = slot[win]
    flow.keys[ws] = keyw32[win]
    vg = torch.stack([verdict.to(torch.int32) & 0xFFFF, mygen.to(torch.int32)], dim=1)
    flow.vg[ws] = vg[win]
    flow.se[ws] = torch.stack([state_val, torch.full_like(state_val, epoch_now)], dim=1)[win]
    flow.cnt[ws] = wrap_int32(seeds[inv[win_el]])
    evict = win & ~matched & (old_state > 0)
    promote = win & matched & (old_state == FLOW_NEW) & (state_val == FLOW_EST)
    return torch.stack([win.sum(), evict.sum(), promote.sum(), win.new_zeros((), dtype=torch.int64)]
                       ).to(torch.int32)


def served_epoch(epoch_dev: torch.Tensor) -> int:
    """The epoch a resident launch serves: the device epoch + 1, with the
    int32 wrap of XLA's add."""
    return int(wrap_int32(epoch_dev.long()[0] + 1))


def flow_probe_resident_plain(flow: FlowTable, gens, page_table, wire, tenant, tflags,
                              epoch_dev, max_age: int, out, *, slab_entries: int,
                              ways: int) -> torch.Tensor:
    """K7's resident entry in plain PyTorch: flow_probe_plain at the
    served epoch (``epoch_dev`` is read, not written), its buffer copied
    into ``out``; returns ``out``'s first probe_out_words(B) words."""
    fused = flow_probe_plain(flow, gens, page_table, wire, tenant, tflags,
                             served_epoch(epoch_dev), max_age, slab_entries=slab_entries,
                             ways=ways)
    out[: fused.shape[0]].copy_(fused)
    return out[: fused.shape[0]]


def flow_insert_resident_plain(flow: FlowTable, gens, page_table, wire, tenant, tflags,
                               verdict16, hit_bits, merged, counts, epoch_dev, *,
                               slab_entries: int, ways: int) -> torch.Tensor:
    """K8's resident entry in plain PyTorch (jaxpath._resident_step_core's
    merge and ``_flow_insert_core(..., lane_ok=~hit)``): the lanes whose
    bit in ``hit_bits`` is 0 take their verdict from ``verdict16`` (packed
    res16 words) into ``merged`` and are inserted at the served epoch; the
    hit lanes keep ``merged`` and are not eligible.  Writes the four counts
    into ``counts`` and the served epoch into ``epoch_dev``; returns
    ``counts``."""
    B = wire.shape[0]
    nw = (B + 1) // 2
    e1 = served_epoch(epoch_dev)
    hit = unpack_bits32(hit_bits[: -(-B // 32)], B)
    verdict = unpack_res16(verdict16[:nw], B)
    served = unpack_res16(merged[:nw], B)
    merged[:nw].copy_(_pack_res16(torch.where(hit, served, verdict)))
    c = flow_insert_plain(flow, gens, page_table, wire, tenant, tflags, verdict, e1,
                          slab_entries=slab_entries, ways=ways, lane_ok=~hit)
    counts[:4].copy_(c)
    epoch_dev.fill_(e1)
    return counts[:4]


def flow_age(se: torch.Tensor, cutoff: int) -> torch.Tensor:
    """Free, in place, every live entry last seen strictly before
    ``cutoff`` (jaxpath.jitted_flow_age); returns the count as a 0-d int32
    tensor."""
    expire = (se[:, 0] > 0) & (se[:, 1] < cutoff)
    se[:, 0].masked_fill_(expire, FLOW_EMPTY)
    return expire.sum().to(torch.int32)


def flow_occupancy(se: torch.Tensor) -> torch.Tensor:
    """Live entries (jaxpath.jitted_flow_occupancy), a 0-d int32 tensor."""
    return (se[:, 0] > 0).sum().to(torch.int32)


# --- the kernels -----------------------------------------------------------------

#: the last table whose columns and geometry passed _check_table: weak
#: references to its five tensors, the device, slab_entries and ways
_checked_table = None


def _bad_tensor(t, dev) -> str:
    """Why ``t`` is no operand of the kernels on ``dev`` ("" when it is)."""
    if t.device != dev or t.dtype != torch.int32:
        return f"must be int32 on {dev}, got {t.dtype} on {t.device}"
    if not t.is_contiguous() or t.data_ptr() % 16:
        return "must be contiguous and 16-byte aligned"
    return ""


def _check_table(who: str, flow: FlowTable, dev, slab_entries: int, ways: int) -> None:
    """The five columns and the geometry, checked once per table: a call
    with the table, device and geometry last checked (the same five tensor
    objects) skips the checks; any other table is checked in full."""
    global _checked_table
    seen = _checked_table
    if (seen is not None and seen[1] == dev and seen[2] == slab_entries and seen[3] == ways
            and all(ref() is t for ref, t in zip(seen[0], flow))):
        return
    C = flow.capacity
    shapes = {"keys": (C, FLOW_KEY_WORDS), "vg": (C, 2), "se": (C, 2), "cnt": (C, 3),
              "winner": (C,)}
    for name in FlowTable._fields:
        t = getattr(flow, name)
        bad = _bad_tensor(t, dev)
        if bad:
            raise ValueError(f"{who}: {name} {bad}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{who}: {name} {tuple(t.shape)}, expected {shapes[name]}")
    if slab_entries < 1 or slab_entries & (slab_entries - 1) or C % slab_entries:
        raise ValueError(f"{who}: slab_entries {slab_entries} must be a power of two "
                         f"dividing the capacity {C}")
    if not 1 <= ways <= 8:
        raise ValueError(f"{who}: ways must be in [1, 8], got {ways}")
    if C > INT32_MAX:
        raise ValueError(f"{who}: capacity {C} past int32")
    _checked_table = (tuple(weakref.ref(t) for t in flow), dev, slab_entries, ways)


def _check_operands(who: str, gens, page_table, wire, lanes) -> None:
    """The per-call operands: the wire, the (B,) lane columns (tenant,
    flags and the insert's verdicts) and the generation and page vectors."""
    dev = wire.device
    if wire.dim() != 2 or wire.shape[1] not in (4, 7):
        raise ValueError(f"{who}: wire {tuple(wire.shape)}, expected (B, 4) or (B, 7)")
    B = wire.shape[0]
    for name, t in (("wire", wire), ("gens", gens), ("page_table", page_table)) + lanes:
        bad = _bad_tensor(t, dev)
        if bad:
            raise ValueError(f"{who}: {name} {bad}")
    for name, t in lanes:
        if tuple(t.shape) != (B,):
            raise ValueError(f"{who}: {name} {tuple(t.shape)}, expected ({B},)")
    if gens.dim() != 1 or page_table.dim() != 1 or gens.shape[0] < 1 or page_table.shape[0] < 1:
        raise ValueError(f"{who}: gens and page_table must be non-empty vectors")


def _with_scratch(words: int, B: int, device) -> Tuple[torch.Tensor, int]:
    """One allocation for a call: ``words`` of output, then the kernel's
    (B, 2) lane scratch from an even word; returns (buffer, scratch
    address)."""
    at = words + (words & 1)
    buf = torch.empty(at + 2 * B, dtype=torch.int32, device=device)
    return buf, buf.data_ptr() + 4 * at


def _launch(kernel: "_build.Kernel", device, *args) -> None:
    """Call ``kernel`` on the current stream of ``device``, entering the
    device only when it is not the current one."""
    if device.index == torch.cuda.current_device():
        kernel.launch(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            kernel.launch(*args, torch.cuda.current_stream().cuda_stream)


def flow_probe(flow: FlowTable, gens, page_table, wire, tenant, tflags, epoch_now: int,
               max_age: int, *, slab_entries: int, ways: int, _grid: int = 0) -> torch.Tensor:
    """Kernel K7.  A CPU tensor runs flow_probe_plain; a CUDA tensor
    launches the CUDA kernel (building it on first use) or raises.  The
    columns are updated in place; returns the fused int32 buffer.
    ``_grid`` > 0 caps the kernel's grid (tests)."""
    if wire.device.type == "cpu":
        return flow_probe_plain(flow, gens, page_table, wire, tenant, tflags, epoch_now, max_age,
                                slab_entries=slab_entries, ways=ways)
    if wire.device.type != "cuda":
        raise ValueError(f"flow_probe: unsupported device {wire.device}")
    _check_table("flow_probe", flow, wire.device, slab_entries, ways)
    _check_operands("flow_probe", gens, page_table, wire, (("tenant", tenant), ("tflags", tflags)))
    B = wire.shape[0]
    words = probe_out_words(B)
    buf, scratch = _with_scratch(words, B, wire.device)
    _launch(PROBE_KERNEL, wire.device,
            wire.data_ptr(), tenant.data_ptr(), tflags.data_ptr(), flow.keys.data_ptr(),
            flow.vg.data_ptr(), flow.se.data_ptr(), flow.cnt.data_ptr(), gens.data_ptr(),
            page_table.data_ptr(), buf.data_ptr(), scratch,
            B, wire.shape[1], gens.shape[0], page_table.shape[0], flow.capacity, slab_entries,
            ways, int(epoch_now), int(max_age), int(_grid))
    return buf[:words]


def flow_insert(flow: FlowTable, gens, page_table, wire, tenant, tflags, verdict,
                epoch_now: int, *, slab_entries: int, ways: int, _grid: int = 0) -> torch.Tensor:
    """Kernel K8.  A CPU tensor runs flow_insert_plain; a CUDA tensor
    launches the CUDA kernel (building it on first use) or raises.  The
    columns are updated in place and ``flow.winner`` is left at -1;
    returns (4,) int32 [inserts, evictions, promotes, 0].  ``_grid`` > 0
    caps the kernel's grid (tests)."""
    if wire.device.type == "cpu":
        return flow_insert_plain(flow, gens, page_table, wire, tenant, tflags, verdict, epoch_now,
                                 slab_entries=slab_entries, ways=ways)
    if wire.device.type != "cuda":
        raise ValueError(f"flow_insert: unsupported device {wire.device}")
    _check_table("flow_insert", flow, wire.device, slab_entries, ways)
    _check_operands("flow_insert", gens, page_table, wire,
                    (("tenant", tenant), ("tflags", tflags), ("verdict", verdict)))
    B = wire.shape[0]
    buf, scratch = _with_scratch(4, B, wire.device)
    _launch(INSERT_KERNEL, wire.device,
            wire.data_ptr(), tenant.data_ptr(), tflags.data_ptr(), verdict.data_ptr(),
            flow.keys.data_ptr(), flow.vg.data_ptr(), flow.se.data_ptr(), flow.cnt.data_ptr(),
            flow.winner.data_ptr(), gens.data_ptr(), page_table.data_ptr(), buf.data_ptr(),
            scratch, B, wire.shape[1], gens.shape[0], page_table.shape[0], flow.capacity,
            slab_entries, ways, int(epoch_now), int(_grid))
    return buf[:4]


def _check_view(who: str, name: str, t, dev, words: int) -> None:
    """A resident operand that may be a view into a larger buffer: a
    contiguous int32 vector of at least ``words`` words on ``dev``."""
    if t.device != dev or t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{who}: {name} must be a contiguous int32 vector on {dev}")
    if t.shape[0] < words:
        raise ValueError(f"{who}: {name} has {t.shape[0]} words, needs {words}")


def _lane_scratch(B: int, device) -> torch.Tensor:
    """The kernels' (B, 2) int32 lane scratch, 16-byte aligned."""
    return torch.empty(2 * B + 4, dtype=torch.int32, device=device)


def flow_probe_resident(flow: FlowTable, gens, page_table, wire, tenant, tflags, epoch_dev,
                        max_age: int, out, scratch=None, *, slab_entries: int, ways: int,
                        _grid: int = 0) -> torch.Tensor:
    """Kernel K7 through its resident entry: the probe at the device epoch
    + 1 (``epoch_dev`` a (1,) int32 tensor, read and not written), its
    buffer written into ``out`` (at least probe_out_words(B) words).  A
    CPU tensor runs flow_probe_resident_plain; a CUDA tensor launches the
    kernel or raises.  ``scratch`` is the kernel's lane scratch (allocated
    when None); returns ``out``'s first probe_out_words(B) words."""
    if wire.device.type == "cpu":
        return flow_probe_resident_plain(flow, gens, page_table, wire, tenant, tflags, epoch_dev,
                                         max_age, out, slab_entries=slab_entries, ways=ways)
    if wire.device.type != "cuda":
        raise ValueError(f"flow_probe_resident: unsupported device {wire.device}")
    who = "flow_probe_resident"
    _check_table(who, flow, wire.device, slab_entries, ways)
    _check_operands(who, gens, page_table, wire, (("tenant", tenant), ("tflags", tflags)))
    B = wire.shape[0]
    words = probe_out_words(B)
    _check_view(who, "epoch_dev", epoch_dev, wire.device, 1)
    _check_view(who, "out", out, wire.device, words)
    if scratch is None:
        scratch = _lane_scratch(B, wire.device)
    _check_view(who, "scratch", scratch, wire.device, 2 * B)
    if scratch.data_ptr() % 8:
        raise ValueError(f"{who}: scratch must be 8-byte aligned")
    _launch(PROBE_RESIDENT_KERNEL, wire.device,
            wire.data_ptr(), tenant.data_ptr(), tflags.data_ptr(), flow.keys.data_ptr(),
            flow.vg.data_ptr(), flow.se.data_ptr(), flow.cnt.data_ptr(), gens.data_ptr(),
            page_table.data_ptr(), out.data_ptr(), scratch.data_ptr(), epoch_dev.data_ptr(),
            B, wire.shape[1], gens.shape[0], page_table.shape[0], flow.capacity, slab_entries,
            ways, int(max_age), int(_grid))
    return out[:words]


def flow_insert_resident(flow: FlowTable, gens, page_table, wire, tenant, tflags, verdict16,
                         hit_bits, merged, counts, epoch_dev, scratch=None, *,
                         slab_entries: int, ways: int, _grid: int = 0) -> torch.Tensor:
    """Kernel K8 through its resident entry (see the module docstring):
    ``verdict16`` the ceil(B/2) packed res16 words of the stateless
    classify of the whole batch, ``hit_bits`` the probe's ceil(B/32)
    bitmap words, ``merged`` the probe's ceil(B/2) res16 words (the missed
    lanes' verdicts are written into them), ``counts`` 4 words for
    [inserts, evictions, promotes, 0], ``epoch_dev`` the (1,) int32 device
    epoch, which the call advances to the epoch it served.  A CPU tensor
    runs flow_insert_resident_plain; a CUDA tensor launches the kernel or
    raises.  Returns ``counts``' first 4 words."""
    if wire.device.type == "cpu":
        return flow_insert_resident_plain(flow, gens, page_table, wire, tenant, tflags,
                                          verdict16, hit_bits, merged, counts, epoch_dev,
                                          slab_entries=slab_entries, ways=ways)
    if wire.device.type != "cuda":
        raise ValueError(f"flow_insert_resident: unsupported device {wire.device}")
    who = "flow_insert_resident"
    _check_table(who, flow, wire.device, slab_entries, ways)
    _check_operands(who, gens, page_table, wire, (("tenant", tenant), ("tflags", tflags)))
    B = wire.shape[0]
    nw, nh = (B + 1) // 2, -(-B // 32)
    for name, t, words in (("verdict16", verdict16, nw), ("hit_bits", hit_bits, nh),
                           ("merged", merged, nw), ("counts", counts, 4),
                           ("epoch_dev", epoch_dev, 1)):
        _check_view(who, name, t, wire.device, words)
    if scratch is None:
        scratch = _lane_scratch(B, wire.device)
    _check_view(who, "scratch", scratch, wire.device, 2 * B)
    if scratch.data_ptr() % 8:
        raise ValueError(f"{who}: scratch must be 8-byte aligned")
    _launch(INSERT_RESIDENT_KERNEL, wire.device,
            wire.data_ptr(), tenant.data_ptr(), tflags.data_ptr(), verdict16.data_ptr(),
            hit_bits.data_ptr(), merged.data_ptr(), flow.keys.data_ptr(), flow.vg.data_ptr(),
            flow.se.data_ptr(), flow.cnt.data_ptr(), flow.winner.data_ptr(), gens.data_ptr(),
            page_table.data_ptr(), counts.data_ptr(), scratch.data_ptr(), epoch_dev.data_ptr(),
            B, wire.shape[1], gens.shape[0], page_table.shape[0], flow.capacity, slab_entries,
            ways, int(_grid))
    return counts[:4]
