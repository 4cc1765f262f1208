"""Dense classify path: host table packing, kernel K1 and its plain version.

Counterpart of the JAX package's ``kernels/pallas_dense.py``.  Tables of at
most MAX_DENSE_TARGETS entries are classified compare-all: every packet is
tested against every (key, mask) entry of the 160-bit LPM key space
(ifindex || source IP), the longest matching prefix wins (first index on
ties, IPv4 packets capped at /32), and the winner's rule slots are scanned
in order for the first hit (kernel.c:189-258).

- ``build_dense_tables``: CompiledTables -> DenseTables on one device, with
  the TPU packing's eligibility errors (more than 4096 entries, rule width
  above 128, ruleIds above 127) and its byte masking of every field, and
  the tensor-core operands of the LPM (``lpm_planes``, ``lpm_constants``,
  ``lpm_order``);
- ``dense_classify``: the wrapper of the hand-written CUDA kernel
  ``csrc/dense_classify.cu`` (which replaces the Pallas
  ``_classify_kernel``; its LPM runs on the int8 tensor cores).  On a CUDA
  tensor it launches the kernel or raises; on a CPU tensor it runs
  ``dense_classify_plain``;
- ``dense_classify_plain``: the same function in plain PyTorch, chunked
  over packets so it also runs at 2^20 packets on the card;
- ``classify_dense`` / ``classify_dense_wire_fused``: the forward pass
  around the kernel (wire unpack, verdict, statistics, one-buffer output).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..compiler import CompiledTables
from ..constants import KIND_IPV4
from . import _build
from .torchpath import (
    DeviceBatch,
    batch_from_fields,
    finalize,
    fuse_wire_outputs,
    packet_fields,
    resolve_device,
    rule_scan,
    unpack_wire,
)

MAX_DENSE_TARGETS = 4096
MAX_RULE_ID = 0x7F    # ruleId shares a byte with the action bit
MAX_RULE_WIDTH = 128
TILE = 128            # entry rows are padded to a multiple of 128
ENTRY_COLS = 12       # key0..4, mask0..4, mask_len, 0
KEY_BITS = 160        # the LPM key: ifindex || source IP
N_TILE = 8            # entries per tensor-core n-tile of the kernel
MAX_GROUPS = 64       # groups of the kernel's entry order (a kernel argument)
LONGER = 8            # group info: entries longer than /32
FOLDED = 16           # group info: one ifindex, its key word out of the product
LPM_BIG = 1 << 21     # above every score key (mask_len + 1) << 12 | (4095 - t)
LPM_NEVER = -(1 << 30)  # the constant of an entry that never matches

KERNEL = _build.Kernel(
    "dense_classify",
    "infw_dense_classify",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
)


class DenseTables(NamedTuple):
    """Dense-path table operands on one device.

    entries:   (Tp, 12) int32 — key words 0..4, mask words 0..4 (uint32 bit
               patterns), mask_len (-1 for padding rows), 0; Tp is the entry
               count rounded up to a multiple of TILE.
    rules:     (Tp, R, 2) int32 — one packed slot per rule:
               [ridAct | proto<<8 | icmpType<<16 | icmpCode<<24,
                portStart | portEnd<<16], ridAct = ruleId<<1 | (action-1),
               all-zero for empty slots and padding rows.
    planes:    (Tp, 160) int8 — M0 - M1 per entry (``lpm_planes``), the
               transpose of the TPU packing's ``mdt``.
    lpm_const: (Tp,) int32 — the score constant per entry (``lpm_constants``).
    order:     (Tk,) int32 — the entries the kernel walks in its groups,
               -1 for padding (``lpm_order``).
    groups:    (G, 3) int32 on the host, G <= MAX_GROUPS — per group of
               ``order``: its size (a multiple of N_TILE), its info (the
               k-steps its planes need | LONGER for entries longer than /32
               | FOLDED for one ifindex's entries, whose ifindex word the
               kernel compares instead of multiplying) and that ifindex;
               the kernel takes it by value.
    The rule slots are padded to an even count (the kernel reads two at a
    time); a padding slot is empty and never hits."""

    entries: torch.Tensor
    rules: torch.Tensor
    planes: torch.Tensor
    lpm_const: torch.Tensor
    order: torch.Tensor
    groups: torch.Tensor


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def lpm_planes(key_words: np.ndarray, mask_words: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The TPU kernel's LPM operands per entry: (T, 5) key and mask words ->
    planes (T, 160) int8 = M0 - M1 in {-1, 0, 1} and rowsum(M1) (T,) int32,
    with M0 = mask & ~prefix, M1 = mask & prefix over the key's bits in
    big-endian order (bit k of word w is (word >> (31 - k)) & 1).  A packet
    whose key bits are ``bits`` has bits . planes[t] + rowsum(M1)[t] in-mask
    mismatches with entry t: never negative, zero iff it matches."""
    shift = np.arange(31, -1, -1, dtype=np.uint32)

    def unpack(words: np.ndarray) -> np.ndarray:
        w = np.asarray(words, np.uint32)
        return ((w[:, :, None] >> shift) & 1).reshape(w.shape[0], KEY_BITS).astype(np.int8)

    prefix, mask = unpack(key_words), unpack(mask_words)
    m1 = mask & prefix
    return (mask & (1 - prefix)) - m1, m1.sum(axis=1, dtype=np.int32)


def lpm_constants(m1sum: np.ndarray, mask_len: np.ndarray) -> np.ndarray:
    """(T,) int32 score constants: c_t = key_t - LPM_BIG * rowsum(M1)_t with
    key_t = (mask_len + 1) << 12 | (4095 - t), so that c_t - LPM_BIG * (bits .
    planes[t]) is key_t when entry t matches and negative otherwise: the
    longest prefix has the largest key and, among equal lengths, the first
    index.  LPM_NEVER for an entry that never matches (mask_len outside
    0..128, padding rows among them)."""
    mlen = np.asarray(mask_len, np.int64)
    t = np.arange(mlen.shape[0], dtype=np.int64)
    key = ((mlen + 1) << 12) | (4095 - t)
    c = key - LPM_BIG * np.asarray(m1sum, np.int64)
    return np.where((mlen >= 0) & (mlen <= 128), c, LPM_NEVER).astype(np.int32)


def lpm_order(key_words: np.ndarray, mask_words: np.ndarray,
              mask_len: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The kernel's entry order and its groups.  Entries are grouped by
    whether mask_len exceeds 32 (an IPv4 packet matches only the others),
    by the k-steps (32-bit key words) their masks cover (the planes past
    them are zero, so their products are skipped), and, for every ifindex
    with at least N_TILE entries whose ifindex word is fully masked, by
    that ifindex: such a "folded" group leaves the ifindex word out of the
    product (the kernel compares it once per packet instead) while the
    table stays within MAX_GROUPS groups.  Each group is padded with -1 to
    a multiple of N_TILE; entries that never match (mask_len outside
    0..128) are left out.  Returns order (Tk,) int32 and groups (G, 3)
    int32 rows [size, k-steps | LONGER | FOLDED, ifindex]; a folded group
    counts its k-steps from word 1."""
    kw = np.asarray(key_words, np.uint32)
    mw = np.asarray(mask_words, np.uint32)
    mlen = np.asarray(mask_len, np.int64)
    live = (mlen >= 0) & (mlen <= 128)
    longer = mlen > 32
    covered = mw != 0  # (T, 5)
    steps = np.where(covered.any(axis=1), 5 - np.argmax(covered[:, ::-1], axis=1), 1)
    foldable = live & (mw[:, 0] == 0xFFFFFFFF)

    def n_groups(folded: np.ndarray) -> int:
        rest = live & ~folded
        return (len(set(zip(longer[rest], steps[rest])))
                + len(set(zip(kw[folded, 0], longer[folded], steps[folded]))))

    folded = np.zeros(len(mlen), bool)
    ifx, counts = np.unique(kw[foldable, 0], return_counts=True)
    for x in ifx[np.argsort(-counts, kind="stable")]:
        trial = folded | (foldable & (kw[:, 0] == x))
        if counts[ifx == x][0] >= N_TILE and n_groups(trial) <= MAX_GROUPS:
            folded = trial
    order, groups = [np.zeros(0, np.int32)], []

    def add(sel: np.ndarray, info: int, ifindex: int) -> None:
        idx = np.nonzero(sel)[0].astype(np.int32)
        if len(idx):
            pad = -len(idx) % N_TILE
            order.append(np.concatenate([idx, np.full(pad, -1, np.int32)]))
            groups.append((len(idx) + pad, info, ifindex))

    for lg in (False, True):
        for ks in range(1, 6):
            add(live & ~folded & (longer == lg) & (steps == ks), ks | (LONGER if lg else 0), 0)
    for x in np.unique(kw[folded, 0]):
        for lg in (False, True):
            for ks in range(1, 6):
                add(folded & (kw[:, 0] == x) & (longer == lg) & (steps == ks),
                    (ks - 1) | FOLDED | (LONGER if lg else 0), int(np.uint32(x).view(np.int32)))
    return np.concatenate(order), np.asarray(groups, np.int32).reshape(-1, 3)


def row_info(groups: np.ndarray) -> np.ndarray:
    """(Tk,) int32: each row of the kernel's order with its group's info."""
    groups = np.asarray(groups)
    return np.repeat(groups[:, 1], groups[:, 0])


def build_dense_tables(tables: CompiledTables, device=None) -> DenseTables:
    """Host-side packing of CompiledTables into the dense layout on
    ``device`` (resolve_device).  Raises ValueError for tables the packing
    cannot hold, with the same checks in the same order as the TPU packing
    (pallas_dense.build_pallas_tables)."""
    device = resolve_device(device)
    T = tables.num_entries
    if T > MAX_DENSE_TARGETS:
        raise ValueError(
            f"dense kernel supports up to {MAX_DENSE_TARGETS} targets, got {T}"
        )
    if tables.rule_width > MAX_RULE_WIDTH:
        raise ValueError(
            f"rule_width {tables.rule_width} > {MAX_RULE_WIDTH}: ruleId would "
            "not fit in the packed (ruleId<<1)|action byte"
        )
    rules = np.asarray(tables.rules[:T], np.int64)
    max_rid = int(rules[..., 0].max()) if T else 0
    if max_rid > MAX_RULE_ID:
        raise ValueError(
            f"max ruleId {max_rid} > {MAX_RULE_ID} does not fit the packed "
            "(ruleId<<1)|action byte"
        )
    Tp = _round_up(max(T, 1), TILE)
    entries = np.zeros((Tp, ENTRY_COLS), np.int64)
    entries[:, 10] = -1
    entries[:T, 0:5] = np.asarray(tables.key_words[:T], np.uint32)
    entries[:T, 5:10] = np.asarray(tables.mask_words[:T], np.uint32)
    entries[:T, 10] = np.asarray(tables.mask_len[:T], np.int32)

    R = rules.shape[1]
    packed = np.zeros((Tp, R + R % 2, 2), np.int64)
    if T:
        # Byte masking exactly as the TPU packing: action clipped to
        # {DENY, ALLOW}, protocol and ICMP fields to a byte, ports to 16 bits.
        act = np.clip(rules[..., 6], 1, 2) - 1
        rid_act = np.where(rules[..., 0] != 0, ((rules[..., 0] & 0x7F) << 1) | act, 0)
        packed[:T, :R, 0] = (
            rid_act
            | ((rules[..., 1] & 0xFF) << 8)
            | ((rules[..., 4] & 0xFF) << 16)
            | ((rules[..., 5] & 0xFF) << 24)
        )
        packed[:T, :R, 1] = (rules[..., 2] & 0xFFFF) | ((rules[..., 3] & 0xFFFF) << 16)

    planes, m1sum = lpm_planes(entries[:, 0:5], entries[:, 5:10])
    order, groups = lpm_order(entries[:, 0:5], entries[:, 5:10], entries[:, 10])
    # a folded entry's constant leaves out the ifindex word's M1 bits
    folded = np.zeros(Tp, bool)
    folded[order[((row_info(groups) & FOLDED) != 0) & (order >= 0)]] = True
    m1sum = m1sum - np.where(folded, (planes[:, :32] == -1).sum(axis=1), 0)

    def put(a: np.ndarray) -> torch.Tensor:
        a32 = (a & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
        return torch.from_numpy(np.ascontiguousarray(a32)).to(device)

    return DenseTables(
        entries=put(entries), rules=put(packed),
        planes=torch.from_numpy(planes).to(device),
        lpm_const=torch.from_numpy(lpm_constants(m1sum, entries[:, 10])).to(device),
        order=torch.from_numpy(order).to(device), groups=torch.from_numpy(groups),
    )


def _unpack_rule_slots(slots: torch.Tensor) -> torch.Tensor:
    """(..., R, 2) packed slots -> (..., R, 7) rule rows
    [ruleId, proto, portStart, portEnd, icmpType, icmpCode, action]."""
    x, y = slots[..., 0], slots[..., 1]
    rid_act = x & 0xFF
    return torch.stack(
        [
            rid_act >> 1,
            (x >> 8) & 0xFF,
            y & 0xFFFF,
            (y >> 16) & 0xFFFF,
            (x >> 16) & 0xFF,
            (x >> 24) & 0xFF,
            (rid_act & 1) + 1,
        ],
        dim=-1,
    )


def dense_classify_plain(
    fields: torch.Tensor, words: torch.Tensor, dt: DenseTables, chunk: int = 1 << 14
) -> torch.Tensor:
    """K1's function in plain PyTorch: (B, 8) fields + (B, 4) words ->
    (B, 2) int32 [result, tidx or -1]."""
    B = fields.shape[0]
    key, mask, mlen = dt.entries[:, 0:5], dt.entries[:, 5:10], dt.entries[:, 10]
    Tp = dt.entries.shape[0]
    iota = torch.arange(Tp, device=fields.device, dtype=torch.int32)
    out = torch.empty((B, 2), dtype=torch.int32, device=fields.device)
    for s in range(0, B, chunk):
        f, w = fields[s : s + chunk], words[s : s + chunk]
        pkt = torch.cat([f[:, 1:2], w], dim=1)  # (b, 5) LPM key words
        diff = torch.zeros((f.shape[0], Tp), dtype=torch.int32, device=f.device)
        for k in range(5):
            diff |= (pkt[:, k : k + 1] ^ key[None, :, k]) & mask[None, :, k]
        cap = torch.where(f[:, 0:1] == KIND_IPV4, 32, 128)
        ok = (diff == 0) & (mlen >= 0) & (mlen <= cap)
        score = torch.where(ok, mlen + 1, 0)
        best = score.max(dim=1, keepdim=True).values
        tidx = torch.where((score == best) & (score > 0), iota, Tp).min(dim=1).values
        matched = best[:, 0] > 0
        slots = dt.rules[tidx.clamp(max=Tp - 1).long()]  # (b, R, 2)
        slots = torch.where(matched[:, None, None], slots, 0)
        result = rule_scan(_unpack_rule_slots(slots), batch_from_fields(f, w))
        out[s : s + chunk, 0] = result
        out[s : s + chunk, 1] = torch.where(matched, tidx, -1)
    return out


def _groups_fit(groups: torch.Tensor, Tk: int) -> bool:
    """``groups`` is a host (G, 3) int32 table of ``lpm_order``'s shape
    whose sizes cover the Tk rows of ``order`` in whole n-tiles, with
    1..5 k-steps (0..4 from word 1 when folded)."""
    if (groups.device.type != "cpu" or groups.dtype != torch.int32 or groups.dim() != 2
            or groups.shape[1] != 3 or groups.shape[0] > MAX_GROUPS or not groups.is_contiguous()):
        return False
    size, info = groups[:, 0], groups[:, 1]
    folded = (info & FOLDED) != 0
    steps = (info & 7) + folded.int()  # counted from word 0
    return (int(size.sum()) == Tk and bool((size % N_TILE == 0).all())
            and bool((info & ~(7 | LONGER | FOLDED) == 0).all())
            and bool(((steps >= 1) & (steps <= 5)).all()))


def dense_classify(
    fields: torch.Tensor, words: torch.Tensor, dt: DenseTables
) -> torch.Tensor:
    """Kernel K1: (B, 8) int32 fields + (B, 4) int32 words -> (B, 2) int32
    [result, tidx or -1].  A CPU tensor runs the plain version; a CUDA
    tensor launches the CUDA kernel (building it on first use) or raises."""
    if fields.device.type == "cpu":
        return dense_classify_plain(fields, words, dt)
    if fields.device.type != "cuda":
        raise ValueError(f"dense_classify: unsupported device {fields.device}")
    B = fields.shape[0]
    Tp = dt.entries.shape[0]
    R = dt.rules.shape[1]
    Tk = dt.order.shape[0]
    if fields.shape != (B, 8) or words.shape != (B, 4):
        raise ValueError(
            f"dense_classify: fields {tuple(fields.shape)} / words "
            f"{tuple(words.shape)}, expected (B, 8) / (B, 4)"
        )
    if (dt.entries.shape != (Tp, ENTRY_COLS) or Tp % TILE or Tp > MAX_DENSE_TARGETS
            or dt.rules.shape != (Tp, R, 2) or dt.planes.shape != (Tp, KEY_BITS)
            or R % 2 or dt.lpm_const.shape != (Tp,) or dt.order.dim() != 1
            or not _groups_fit(dt.groups, Tk)):
        raise ValueError("dense_classify: the tables are not a DenseTables layout")
    operands = (fields, words, dt.planes, dt.lpm_const, dt.order, dt.rules)
    for t in operands:
        want = torch.int8 if t is dt.planes else torch.int32
        if t.device != fields.device or t.dtype != want:
            raise ValueError("dense_classify: operands must be int32 (planes int8) on one device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("dense_classify: operands must be contiguous and 16-byte aligned")
    out = torch.empty((B, 2), dtype=torch.int32, device=fields.device)
    with torch.cuda.device(fields.device):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL.launch(
            *(t.data_ptr() for t in operands), dt.groups.data_ptr(), out.data_ptr(), B, Tk,
            dt.groups.shape[0], R, stream,
        )
    return out


def classify_dense(
    dt: DenseTables, batch: DeviceBatch
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full forward pass through K1: (results int32, xdp int32, stats
    (MAX_TARGETS, 6) int32), as pallas_dense.classify_pallas."""
    fields, words = packet_fields(batch)
    out = dense_classify(fields, words, dt)
    return finalize(out[:, 0], batch)


def classify_dense_wire_fused(dt: DenseTables, wire: torch.Tensor) -> torch.Tensor:
    """Packed wire (B, 3|4|6|7) int32 in, ONE int32 buffer out: ceil(B/2)
    words of u16-pair-packed results, then the (MAX_TARGETS, 6) stats —
    the single device-to-host read per batch."""
    res, _xdp, stats = classify_dense(dt, unpack_wire(wire))
    return fuse_wire_outputs(res & 0xFFFF, stats)
