"""The telemetry plane's device sketches: kernel K9 (the sketch update), its
plain version and the bit-exact host model.

Counterpart of the JAX package's ``infw/kernels/sketch.py``.  There the
update (``_sketch_update_core``) is XLA, no Pallas kernel: a standalone
launch per admission on the multi-dispatch path (``jitted_sketch_update``)
and one stage of the resident step (``jaxpath._resident_step_core``).
Here it is a hand-written CUDA kernel (``csrc/sketch_update.cu``), because
as torch ops it would be a few dozen launches of gathers and scatters per
admission.

State (``SketchState``, int32 tensors on one device, updated in place so
a CUDA graph of the resident step keeps their addresses):

- ``cms`` (D, W): count-min rows over the (tenant, src, kind | verdict)
  key; an add wraps in int32, then the whole array is clamped at ``sat``;
- ``keys`` (K, 6) u32 words / ``cnt`` (K,): the ways-way set-associative
  heavy-hitter table; a lane whose post-update estimate beats its slot's
  count replaces it (the largest wanting lane index wins a slot);
- ``tcnt`` (T, 4): exact per-tenant [packets, allows, denies, pure SYNs].

Beside the state the wrappers take ``winner`` (K,) int32, the per-slot
scratch of K9's first design, -1 between calls (``empty_winner``): the
entries keep it in their signatures, and K9 leaves it as it is (its plans
keep their bids in shared memory or in the call's scratch).

- ``sketch_update`` (K9, classic entry): (B, 4 | 7) wire, (B,) tenant,
  flags and u32 results;
- ``sketch_update_resident`` (K9, resident entry): the same with the
  results read from the resident step's packed u16 words (the merged
  verdicts K8 wrote);
- ``sketch_clear``: the state zeroed in place (the drain's reset).

On a CPU tensor the wrappers run ``sketch_update_plain``, which mirrors
``_sketch_update_core`` statement for statement; on a CUDA tensor they
launch K9 or raise.  ``HostSketchModel`` mirrors every update in numpy.

K9 has two plans, chosen per call by ``plan_for`` (a pure function of B,
the geometry and the card's opt-in shared-memory limit, so one CUDA graph
always captures one plan): "S", one block with the whole state in shared
memory, for B up to ``BLOCK_PLAN_MAX_LANES`` lanes where it fits; "L", a
cooperative grid (block-local tallies of the adds, the state staged in
each block's shared memory where it fits), for the rest.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..constants import ALLOW, DENY, IPPROTO_TCP, KIND_IPV4, KIND_IPV6, TCP_ACK, TCP_SYN
from . import _build
from .flow import unpack_res16
from .torchpath import unpack_wire, wrap_int32

#: sketch key words: [tenant, ip0, ip1, ip2, ip3, (kind << 8) | action]
SKETCH_KEY_WORDS = 6

KERNEL = _build.Kernel(
    "sketch_update", "infw_sketch_update",
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [ctypes.c_void_p],
)
RESIDENT_KERNEL = _build.Kernel(
    "sketch_update_resident", "infw_sketch_update_resident",
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [ctypes.c_void_p],
    source="sketch_update",
)
#: the library's set-up entry (no kernel): raises K9's shared-memory caps on
#: the current device and returns the card's opt-in limit a block, in bytes
PREPARE = _build.Kernel("sketch_prepare", "infw_sketch_prepare", [ctypes.c_int],
                        source="sketch_update")

#: threads of a block on both plans, and lanes a thread keeps in registers
#: (csrc/sketch_update.cu kThreads, kRegLanes)
BLOCK_THREADS, REG_LANES = 1024, 4
#: the crossover: plan S serves calls of at most this many lanes (measured
#: on an H100 by ``python -m infw_torch.tools.sketch_plans``; PERF.md)
BLOCK_PLAN_MAX_LANES = 2048
#: each plan's code in the C entry's ``plan`` argument
PLANS = {"L": 0, "S": 1}


def _pow2(n: int, floor: int = 8) -> int:
    return max(floor, 1 << (max(int(n), 1) - 1).bit_length())


class SketchSpec(NamedTuple):
    """Geometry of one telemetry plane."""

    depth: int = 4            # count-min rows
    width: int = 2048         # buckets per row (power of two)
    topk: int = 256           # heavy-hitter slots (power of two)
    ways: int = 4             # set-associative probes per key
    sat: int = 0x7FFFFFFF     # count-min saturation clamp
    max_tenants: int = 1

    @staticmethod
    def make(depth: int = 4, width: int = 2048, topk: int = 256,
             ways: int = 4, sat: int = 0x7FFFFFFF,
             max_tenants: int = 1) -> "SketchSpec":
        if depth < 1 or depth > 8:
            raise ValueError(f"sketch depth must be in [1, 8], got {depth}")
        if not 1 <= ways <= 8:
            raise ValueError(f"sketch ways must be in [1, 8], got {ways}")
        if sat < 1:
            raise ValueError(f"sketch sat must be >= 1, got {sat}")
        if max_tenants < 1:
            raise ValueError("sketch max_tenants must be >= 1")
        return SketchSpec(
            depth=int(depth), width=_pow2(width), topk=_pow2(topk),
            ways=int(ways), sat=int(sat), max_tenants=int(max_tenants),
        )


class SketchState(NamedTuple):
    """The telemetry tensors (numpy in the host model's mirror)."""

    cms: object   # (D, W) int32
    keys: object  # (K, 6) uint32 (int32 bit patterns on the device)
    cnt: object   # (K,) int32
    tcnt: object  # (T, 4) int32 [pkts, allows, denies, syns]


def zero_state_host(spec: SketchSpec) -> SketchState:
    return SketchState(
        cms=np.zeros((spec.depth, spec.width), np.int32),
        keys=np.zeros((spec.topk, SKETCH_KEY_WORDS), np.uint32),
        cnt=np.zeros(spec.topk, np.int32),
        tcnt=np.zeros((spec.max_tenants, 4), np.int32),
    )


def zero_state(spec: SketchSpec, device) -> SketchState:
    """Zero int32 state tensors on ``device``."""
    z = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=device)  # noqa: E731
    return SketchState(cms=z(spec.depth, spec.width), keys=z(spec.topk, SKETCH_KEY_WORDS),
                       cnt=z(spec.topk), tcnt=z(spec.max_tenants, 4))


def empty_winner(spec: SketchSpec, device) -> torch.Tensor:
    """K9's per-slot scratch, -1 between calls."""
    return torch.full((spec.topk,), -1, dtype=torch.int32, device=device)


def state_to_host(state: SketchState) -> dict:
    """Host copies of the four tensors (``keys`` as uint32); copies also on
    the CPU, where the state is then reset in place."""
    out = {k: getattr(state, k).cpu().numpy().copy() for k in SketchState._fields}
    out["keys"] = out["keys"].view(np.uint32)
    return out


def sketch_clear(state: SketchState) -> None:
    """Zero the state in place (the drain's reset: the addresses a CUDA
    graph baked stay)."""
    for t in state:
        t.zero_()


# --- shared key/hash forms ------------------------------------------------------


def _key_words_np(f, tenant: np.ndarray, res: np.ndarray) -> np.ndarray:
    """(B, 6) uint32 key from host-unpacked wire fields (flow.host_unpack_
    wire) and verdicts."""
    act = (np.asarray(res).astype(np.uint32)) & np.uint32(0xFF)
    w5 = act | ((f["kind"].astype(np.uint32) & np.uint32(3)) << np.uint32(8))
    return np.stack([
        tenant.astype(np.uint32),
        f["ip_words"][:, 0].astype(np.uint32),
        f["ip_words"][:, 1].astype(np.uint32),
        f["ip_words"][:, 2].astype(np.uint32),
        f["ip_words"][:, 3].astype(np.uint32),
        w5,
    ], axis=1)


def _hash_np(keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """FNV-1a over the 6 key words -> (h1, h2); h2 forced odd (the flow
    tier's double-hash form, wrapping u32 arithmetic)."""
    h = np.full(keys.shape[0], 0x811C9DC5, np.uint32)
    for w in range(SKETCH_KEY_WORDS):
        h = (h ^ keys[:, w].astype(np.uint32)) * np.uint32(0x01000193)
    return h, (h >> np.uint32(16)) | np.uint32(1)


# --- the host model ---------------------------------------------------------------


class HostSketchModel:
    """Bit-exact numpy mirror of the sketch update: the same key and hash
    forms, the same scatter order (count-min add and clamp -> top-K matched
    max -> top-K winner-lane replace -> tenant counters) and the same
    dedup rules."""

    def __init__(self, spec: SketchSpec) -> None:
        self.spec = spec
        s = zero_state_host(spec)
        self.cms, self.keys, self.cnt, self.tcnt = (s.cms, s.keys, s.cnt, s.tcnt)

    def columns(self):
        return {"cms": self.cms, "keys": self.keys, "cnt": self.cnt, "tcnt": self.tcnt}

    def clear(self) -> None:
        s = zero_state_host(self.spec)
        self.cms, self.keys, self.cnt, self.tcnt = (s.cms, s.keys, s.cnt, s.tcnt)

    def update(self, wire: np.ndarray, res: np.ndarray,
               tenant: Optional[np.ndarray] = None,
               tflags: Optional[np.ndarray] = None) -> None:
        from ..flow import host_unpack_wire

        spec = self.spec
        wire = np.asarray(wire, np.uint32)
        b = wire.shape[0]
        f = host_unpack_wire(wire)
        tenant = (np.zeros(b, np.int32) if tenant is None
                  else np.asarray(tenant, np.int32))
        tflags = (np.zeros(b, np.int32) if tflags is None
                  else np.asarray(tflags, np.int32))
        res = np.asarray(res).astype(np.uint32)
        keyw = _key_words_np(f, tenant, res)
        is_ip = (f["kind"] == KIND_IPV4) | (f["kind"] == KIND_IPV6)
        t_ok = (tenant >= 0) & (tenant < spec.max_tenants)
        elig = is_ip & t_ok
        h1, h2 = _hash_np(keyw)
        D, W, K, Wy = spec.depth, spec.width, spec.topk, spec.ways
        rows = np.arange(D, dtype=np.uint32)[None, :]
        col = ((h1[:, None] + rows * h2[:, None])
               & np.uint32(W - 1)).astype(np.int64)      # (B, D)
        flat = rows.astype(np.int64) * W + col
        # 1. count-min add + saturation clamp
        cms = self.cms.reshape(-1)
        np.add.at(cms, flat[elig].reshape(-1), 1)
        np.minimum(cms, np.int32(spec.sat), out=cms)
        self.cms = cms.reshape(D, W)
        # post-update estimate: min over rows
        est = np.min(self.cms.reshape(-1)[flat], axis=1).astype(np.int32)
        # 2. heavy-hitter probe
        wid = np.arange(Wy, dtype=np.uint32)[None, :]
        cand = ((h1[:, None] + wid * h2[:, None])
                & np.uint32(K - 1)).astype(np.int64)     # (B, Wy)
        ek = self.keys[cand]                             # (B, Wy, 6)
        ecnt = self.cnt[cand]                            # (B, Wy)
        occupied = ecnt > 0
        match_w = np.all(ek == keyw[:, None, :], axis=2) & occupied
        match_w &= elig[:, None]
        widx = np.arange(Wy, dtype=np.int32)[None, :]
        m_first = np.min(np.where(match_w, widx, Wy), axis=1)
        matched = m_first < Wy
        mslot = np.sum(np.where(widx == m_first[:, None], cand, 0), axis=1)
        # matched refresh: order-free max scatter
        np.maximum.at(self.cnt, mslot[matched], est[matched])
        # replacement: first empty way, else min-count way; replace only
        # when the estimate strictly beats the resident count
        e_first = np.min(np.where(~occupied, widx, Wy), axis=1)
        vmin = np.argmin(ecnt, axis=1).astype(np.int32)
        vway = np.where(e_first < Wy, e_first, vmin)
        vslot = np.sum(np.where(widx == vway[:, None], cand, 0), axis=1)
        vcnt = np.where(
            e_first < Wy, 0,
            np.sum(np.where(widx == vway[:, None], ecnt, 0), axis=1),
        )
        want = elig & ~matched & (est > vcnt)
        lane = np.arange(b, dtype=np.int64)
        winner = np.full(K + 1, -1, np.int64)
        np.maximum.at(winner, np.where(want, vslot, K), lane)
        win = want & (winner[np.clip(vslot, 0, K)] == lane)
        ws = vslot[win]
        self.keys[ws] = keyw[win]
        self.cnt[ws] = est[win]
        # 3. exact per-tenant counters
        act = (res & 0xFF).astype(np.int32)
        is_tcp = f["proto"] == IPPROTO_TCP
        syn = is_tcp & ((tflags & TCP_SYN) != 0) & ((tflags & TCP_ACK) == 0)
        upd = np.stack([
            np.ones(b, np.int32),
            (act == ALLOW).astype(np.int32),
            (act == DENY).astype(np.int32),
            syn.astype(np.int32),
        ], axis=1)
        np.add.at(self.tcnt, np.clip(tenant, 0, spec.max_tenants - 1)[elig], upd[elig])


# --- the plain version -------------------------------------------------------------


def _key_words(batch, tenant: torch.Tensor, res: torch.Tensor) -> torch.Tensor:
    """(B, 6) int64 u32 key words (sketch._key_words_jax)."""
    w5 = (res.long() & 0xFF) | ((batch.kind.long() & 3) << 8)
    cols = [tenant.long()] + [batch.ip_words[:, k].long() for k in range(4)] + [w5]
    return torch.stack(cols, dim=1) & 0xFFFFFFFF


def _hash(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """FNV-1a over the 6 key words -> (h1, h2 | 1), u32 in int64."""
    h = torch.full(keys.shape[:1], 0x811C9DC5, dtype=torch.int64, device=keys.device)
    for w in range(SKETCH_KEY_WORDS):
        h = ((h ^ keys[:, w]) * 0x01000193) & 0xFFFFFFFF
    return h, (h >> 16) | 1


def sketch_update_plain(sk: SketchState, wire: torch.Tensor, tenant: torch.Tensor,
                        tflags: torch.Tensor, res: torch.Tensor, spec: SketchSpec) -> None:
    """K9's function in plain PyTorch (sketch._sketch_update_core, statement
    for statement): ``wire`` (B, 4 | 7) int32, ``tenant``, ``tflags`` and
    ``res`` (B,) (the verdicts' low byte is the action).  Updates the four
    tensors of ``sk`` in place."""
    D, W, K, Wy = spec.depth, spec.width, spec.topk, spec.ways
    dev = wire.device
    batch = unpack_wire(wire)
    B = wire.shape[0]
    keyw = _key_words(batch, tenant, res)
    is_ip = (batch.kind == KIND_IPV4) | (batch.kind == KIND_IPV6)
    t_ok = (tenant >= 0) & (tenant < spec.max_tenants)
    elig = is_ip & t_ok
    h1, h2 = _hash(keyw)
    rows = torch.arange(D, dtype=torch.int64, device=dev)[None, :]
    col = (h1[:, None] + rows * h2[:, None]) & (W - 1)
    flat = rows * W + col                                   # (B, D)
    # 1. count-min add (wrapping in int32) + saturation clamp
    cms = sk.cms.reshape(-1).long()
    idx = flat[elig].reshape(-1)
    cms.index_add_(0, idx, torch.ones_like(idx))
    cms = torch.minimum(wrap_int32(cms), torch.tensor(spec.sat, dtype=torch.int32, device=dev))
    sk.cms.copy_(cms.reshape(D, W))
    est = cms[flat].min(dim=1).values                       # (B,) int32
    # 2. heavy-hitter table
    wid = torch.arange(Wy, dtype=torch.int64, device=dev)[None, :]
    cand = (h1[:, None] + wid * h2[:, None]) & (K - 1)     # (B, Wy)
    keyw32 = wrap_int32(keyw)
    ek = sk.keys[cand]                                      # (B, Wy, 6)
    ecnt = sk.cnt[cand]                                     # (B, Wy)
    occupied = ecnt > 0
    match_w = torch.all(ek == keyw32[:, None, :], dim=2) & occupied & elig[:, None]
    m_first = torch.where(match_w, wid, Wy).min(dim=1).values
    matched = m_first < Wy
    mslot = cand.gather(1, m_first.clamp(max=Wy - 1)[:, None])[:, 0]
    cnt = sk.cnt.clone()
    cnt.scatter_reduce_(0, mslot[matched], est[matched], "amax")
    e_first = torch.where(~occupied, wid, Wy).min(dim=1).values
    vmin = ecnt.argmin(dim=1)  # the first of ties
    vway = torch.where(e_first < Wy, e_first, vmin)
    vslot = cand.gather(1, vway[:, None])[:, 0]
    vcnt = torch.where(e_first < Wy, torch.zeros_like(est), ecnt.gather(1, vway[:, None])[:, 0])
    want = elig & ~matched & (est > vcnt)
    lane = torch.arange(B, dtype=torch.int64, device=dev)
    winner = torch.full((K + 1,), -1, dtype=torch.int64, device=dev)
    winner.scatter_reduce_(0, torch.where(want, vslot, K), lane, "amax")
    win = want & (winner[vslot] == lane)
    ws = vslot[win]
    sk.keys[ws] = keyw32[win]
    cnt[ws] = est[win]
    sk.cnt.copy_(cnt)
    # 3. exact per-tenant counters
    act = res.long() & 0xFF
    is_tcp = batch.proto == IPPROTO_TCP
    syn = is_tcp & ((tflags & TCP_SYN) != 0) & ((tflags & TCP_ACK) == 0)
    upd = torch.stack([torch.ones_like(act), (act == ALLOW).long(), (act == DENY).long(),
                       syn.long()], dim=1)
    trow = tenant.long().clamp(0, spec.max_tenants - 1)[elig]
    tcnt = sk.tcnt.long().index_add_(0, trow, upd[elig])
    sk.tcnt.copy_(wrap_int32(tcnt))


# --- the kernel --------------------------------------------------------------------


def block_plan_bytes(b: int, spec: SketchSpec) -> int:
    """Plan S's shared memory at ``b`` lanes (csrc/sketch_update.cu
    block_words): the bids (K 8-byte words), cms, cnt, the slots' key
    hashes, the matched maxima, tcnt and keys, rounded to 16 bytes, then a
    16-byte carry a lane past the register lanes."""
    words = spec.depth * spec.width + 11 * spec.topk + 4 * spec.max_tenants
    spill = max(0, b - REG_LANES * BLOCK_THREADS)
    return 4 * ((words + 3) // 4 * 4) + 16 * spill


def grid_scratch_words(b: int, spec: SketchSpec) -> int:
    """Plan L's scratch at ``b`` lanes (csrc/sketch_update.cu
    grid_scratch_head): the bids (K 8-byte words), the matched maxima (K
    words) and a count of blocks, to 16 bytes, then a 16-byte carry a
    lane."""
    return (3 * spec.topk + 4) // 4 * 4 + 4 * b


def plan_for(b: int, spec: SketchSpec, smem_limit: int) -> str:
    """K9's plan for a call of ``b`` lanes on a card whose blocks may opt in
    to ``smem_limit`` bytes of shared memory: "S" (one block, the state in
    shared memory) up to the crossover where it fits, else "L" (the
    cooperative grid)."""
    return ("S" if b <= BLOCK_PLAN_MAX_LANES and block_plan_bytes(b, spec) <= smem_limit
            else "L")


_SMEM_LIMIT: dict = {}


def smem_limit(device: torch.device) -> int:
    """The opt-in shared memory a block may use on ``device`` (a CUDA
    device, current), in bytes; the first call on a device also raises K9's
    shared-memory caps there (outside any graph capture: each graph the
    port captures runs once eagerly first)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SMEM_LIMIT:
        got = PREPARE.query(0)
        if got <= 0:
            raise RuntimeError(f"sketch_update: the set-up on cuda:{index} failed with error "
                               f"{-got}")
        _SMEM_LIMIT[index] = got
    return _SMEM_LIMIT[index]


def _check(who: str, sk: SketchState, winner, spec: SketchSpec, wire, tenant, tflags,
           res, res_words: int) -> None:
    dev = wire.device
    if wire.dim() != 2 or wire.shape[1] not in (4, 7):
        raise ValueError(f"{who}: wire {tuple(wire.shape)}, expected (B, 4) or (B, 7)")
    B = wire.shape[0]
    shapes = (("cms", sk.cms, (spec.depth, spec.width)),
              ("keys", sk.keys, (spec.topk, SKETCH_KEY_WORDS)),
              ("cnt", sk.cnt, (spec.topk,)), ("tcnt", sk.tcnt, (spec.max_tenants, 4)),
              ("winner", winner, (spec.topk,)), ("wire", wire, (B, wire.shape[1])),
              ("tenant", tenant, (B,)), ("tflags", tflags, (B,)))
    for name, t, shape in shapes:
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous int32 on {dev}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{who}: {name} {tuple(t.shape)}, expected {shape}")
    if res.device != dev or res.dtype != torch.int32 or res.dim() != 1 or not res.is_contiguous():
        raise ValueError(f"{who}: res must be a contiguous int32 vector on {dev}")
    if res.shape[0] < res_words:
        raise ValueError(f"{who}: res has {res.shape[0]} words, needs {res_words}")
    if spec.width & (spec.width - 1) or spec.topk & (spec.topk - 1):
        raise ValueError(f"{who}: width and topk must be powers of two")
    if not 1 <= spec.depth <= 8 or not 1 <= spec.ways <= 8:
        raise ValueError(f"{who}: depth and ways must be in [1, 8]")


def kernel_args(sk: SketchState, winner, spec: SketchSpec, wire, tenant, tflags, res,
                spill, grid: int, plan: str) -> tuple:
    """The C entry's arguments but the stream (``spill`` plan L's scratch,
    None on plan S)."""
    return (wire.data_ptr(), tenant.data_ptr(), tflags.data_ptr(), res.data_ptr(),
            sk.cms.data_ptr(), sk.keys.data_ptr(), sk.cnt.data_ptr(), sk.tcnt.data_ptr(),
            winner.data_ptr(), None if spill is None else spill.data_ptr(), wire.shape[0],
            wire.shape[1], spec.depth, spec.width, spec.topk, spec.ways, spec.max_tenants,
            spec.sat, int(grid), PLANS[plan])


def _launch(kernel: "_build.Kernel", sk: SketchState, winner, spec: SketchSpec, wire, tenant,
            tflags, res, scratch, grid: int, plan: Optional[str]) -> None:
    B = wire.shape[0]
    dev = wire.device
    limit = smem_limit(dev)
    if plan is None:
        plan = "L" if grid > 0 else plan_for(B, spec, limit)
    if plan not in PLANS:
        raise ValueError(f"{kernel.name}: plan {plan!r}, expected one of {sorted(PLANS)}")
    if plan == "S" and (grid > 0 or block_plan_bytes(B, spec) > limit):
        raise ValueError(f"{kernel.name}: plan S takes no grid cap and needs "
                         f"{block_plan_bytes(B, spec)} bytes of shared memory ({limit} on {dev})")
    if plan == "S":
        scratch = None
    else:
        words = grid_scratch_words(B, spec)
        if scratch is None:
            scratch = torch.empty(words, dtype=torch.int32, device=dev)
        elif scratch.numel() < words or scratch.data_ptr() % 16:
            raise ValueError(f"{kernel.name}: scratch needs {words} words, 16-byte aligned")
    args = kernel_args(sk, winner, spec, wire, tenant, tflags, res, scratch, grid, plan)
    kernel.launch(*args, torch.cuda.current_stream().cuda_stream)


def _launch_on(kernel: "_build.Kernel", sk: SketchState, winner, spec: SketchSpec, wire, *rest):
    """_launch with ``wire``'s device current."""
    if wire.device.index == torch.cuda.current_device():
        _launch(kernel, sk, winner, spec, wire, *rest)
    else:
        with torch.cuda.device(wire.device):
            _launch(kernel, sk, winner, spec, wire, *rest)


def sketch_update(sk: SketchState, wire: torch.Tensor, tenant: torch.Tensor,
                  tflags: torch.Tensor, res: torch.Tensor, spec: SketchSpec,
                  winner: Optional[torch.Tensor] = None, scratch: Optional[torch.Tensor] = None,
                  _grid: int = 0, _plan: Optional[str] = None) -> None:
    """Kernel K9, classic entry: ``res`` (B,) int32 holding the u32
    verdicts.  A CPU tensor runs sketch_update_plain; a CUDA tensor
    launches K9 (building it on first use) or raises.  ``winner`` is the
    (K,) per-slot scratch, -1 on entry and on return (made when None; both
    plans keep their bids elsewhere and leave it as it is); ``scratch``
    plan L's scratch (``grid_scratch_words``, made when None); ``_plan``
    "S" or "L" forces a plan, ``_grid`` > 0 caps plan L's grid and selects
    plan L (tests); otherwise ``plan_for`` chooses."""
    if wire.device.type == "cpu":
        sketch_update_plain(sk, wire, tenant, tflags, res, spec)
        return
    if wire.device.type != "cuda":
        raise ValueError(f"sketch_update: unsupported device {wire.device}")
    if winner is None:
        winner = empty_winner(spec, wire.device)
    _check("sketch_update", sk, winner, spec, wire, tenant, tflags, res, wire.shape[0])
    if wire.shape[0] == 0:
        return
    _launch_on(KERNEL, sk, winner, spec, wire, tenant, tflags, res, scratch, _grid, _plan)


def sketch_update_resident(sk: SketchState, wire: torch.Tensor, tenant: torch.Tensor,
                           tflags: torch.Tensor, res16_words: torch.Tensor, spec: SketchSpec,
                           winner: Optional[torch.Tensor] = None,
                           scratch: Optional[torch.Tensor] = None, _grid: int = 0,
                           _plan: Optional[str] = None) -> None:
    """Kernel K9, resident entry (step 4 of kernels/resident.py's step):
    the verdicts are the ceil(B/2) packed u16 words ``res16_words`` (the
    merged results K8 wrote into the step's output).  Otherwise as
    ``sketch_update``."""
    B = wire.shape[0]
    if wire.device.type == "cpu":
        res = unpack_res16(res16_words[: (B + 1) // 2], B)
        sketch_update_plain(sk, wire, tenant, tflags, res, spec)
        return
    if wire.device.type != "cuda":
        raise ValueError(f"sketch_update_resident: unsupported device {wire.device}")
    if winner is None:
        winner = empty_winner(spec, wire.device)
    _check("sketch_update_resident", sk, winner, spec, wire, tenant, tflags, res16_words,
           (B + 1) // 2)
    if B == 0:
        return
    _launch_on(RESIDENT_KERNEL, sk, winner, spec, wire, tenant, tflags, res16_words, scratch,
               _grid, _plan)


def formulation(state: dict, wire: np.ndarray, res: np.ndarray, tenant: np.ndarray,
                tflags: np.ndarray, spec: SketchSpec, plan: str = "S",
                blocks: int = 1) -> dict:
    """K9's phases replayed in numpy, lane by lane as its threads run them
    (``csrc/sketch_update.cu``), on host copies ``state`` (the four arrays,
    updated in place).  The adds: each eligible lane adds 1 to its D
    buckets and its row of tcnt, int32 wrapping; on plan "S" into the
    block's copy, on plan "L" into each of ``blocks`` blocks' tallies (a
    block takes a contiguous run of ceil(B / blocks) lanes), which are then
    added into the state.  Each lane's probe, by one pass over the ways
    (the lowest occupied way holding the key, compared only where the hash
    of the slot's key, taken before any write, equals the lane's; the first
    empty way; the first way of least count); then its estimate
    min_d(min(cms, sat)) (plan L clamps the whole array first, plan S when
    it writes the array back) and a wanting lane's bid; then each slot
    settled: the largest bidding lane stores its key and estimate, else the
    matched lanes' max raises the count.  Returns {"matched", "winners",
    "max_and_win"}: how many lanes matched, how many won a slot, and how
    many slots had both a matched lane and a winner (the case where the
    winner's store overrides)."""
    from ..flow import host_unpack_wire

    D, W, K, Wy = spec.depth, spec.width, spec.topk, spec.ways
    wire = np.asarray(wire, np.uint32)
    b = wire.shape[0]
    f = host_unpack_wire(wire)
    tenant = np.asarray(tenant, np.int32)
    tflags = np.asarray(tflags, np.int32)
    res = np.asarray(res).astype(np.uint32)
    keyw = _key_words_np(f, tenant, res)
    h1, h2 = _hash_np(keyw)
    elig = (((f["kind"] == KIND_IPV4) | (f["kind"] == KIND_IPV6))
            & (tenant >= 0) & (tenant < spec.max_tenants))
    act = (res & 0xFF).astype(np.int64)
    syn = ((f["proto"] == IPPROTO_TCP) & ((tflags & TCP_SYN) != 0)
           & ((tflags & TCP_ACK) == 0))
    keys, cnt = state["keys"], state["cnt"]
    idx = [[int(d * W + ((int(h1[i]) + d * int(h2[i])) & 0xFFFFFFFF & (W - 1)))
            for d in range(D)] for i in range(b)]
    # the adds: per block (plan L's tallies) or into the one block's copy
    group = (np.arange(b) // -(-b // blocks) if plan == "L" and b
             else np.zeros(b, np.int64))
    cms = state["cms"].reshape(-1).astype(np.int64)
    tcnt = state["tcnt"].astype(np.int64)
    for g in range(blocks if plan == "L" else 1):
        tally, ttally = np.zeros_like(cms), np.zeros_like(tcnt)
        for i in np.nonzero(elig & (group == g))[0]:
            for c in idx[i]:
                tally[c] += 1
            ttally[tenant[i]] += [1, act[i] == ALLOW, act[i] == DENY, syn[i]]
        cms += tally
        tcnt += ttally
    cms = ((cms + 2**31) % 2**32 - 2**31).astype(np.int32)
    state["tcnt"][:] = ((tcnt + 2**31) % 2**32 - 2**31).astype(np.int32)
    if plan == "L":
        np.minimum(cms, np.int32(spec.sat), out=cms)
    kh1 = _hash_np(keys)[0]  # the slots' key hashes, before any write
    winner = np.full(K, -1, np.int64)
    lanes = []
    for i in range(b):
        if not elig[i]:
            lanes.append((0, -1, -1))
            continue
        est = min(min(int(cms[c]), spec.sat) for c in idx[i])
        m_slot = e_slot = v_slot = -1
        v_cnt = 0
        for w in range(Wy):
            slot = (int(h1[i]) + w * int(h2[i])) & 0xFFFFFFFF & (K - 1)
            c = int(cnt[slot])
            if w == 0 or c < v_cnt:
                v_cnt, v_slot = c, slot
            if c > 0:
                if (m_slot < 0 and kh1[slot] == h1[i]
                        and np.array_equal(keys[slot], keyw[i])):
                    m_slot = slot
            elif e_slot < 0:
                e_slot = slot
        if m_slot >= 0:
            lanes.append((est, m_slot, -1))
            continue
        want_slot, floor = (e_slot, 0) if e_slot >= 0 else (v_slot, v_cnt)
        if est > floor:
            winner[want_slot] = max(winner[want_slot], i)
            lanes.append((est, -1, want_slot))
        else:
            lanes.append((est, -1, -1))
    # the maxima and the winners' stores
    stats = {"matched": 0, "winners": 0, "max_and_win": 0}
    for i, (est, m_slot, v_slot) in enumerate(lanes):
        if m_slot >= 0:
            stats["matched"] += 1
            if winner[m_slot] < 0:
                cnt[m_slot] = max(int(cnt[m_slot]), est)
            else:
                stats["max_and_win"] += 1
        if v_slot >= 0 and winner[v_slot] == i:
            stats["winners"] += 1
            keys[v_slot] = keyw[i]
            cnt[v_slot] = est
    state["cms"] = np.minimum(cms, np.int32(spec.sat)).reshape(D, W)
    return stats
