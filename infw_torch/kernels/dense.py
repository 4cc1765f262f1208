"""Dense classify path: host table packing, kernel K1 and its plain version.

Counterpart of the JAX package's ``kernels/pallas_dense.py``.  Tables of at
most MAX_DENSE_TARGETS entries are classified compare-all: every packet is
tested against every (key, mask) entry of the 160-bit LPM key space
(ifindex || source IP), the longest matching prefix wins (first index on
ties, IPv4 packets capped at /32), and the winner's rule slots are scanned
in order for the first hit (kernel.c:189-258).

- ``build_dense_tables``: CompiledTables -> DenseTables on one device, with
  the TPU packing's eligibility errors (more than 4096 entries, rule width
  above 128, ruleIds above 127) and its byte masking of every field;
- ``dense_classify``: the wrapper of the hand-written CUDA kernel
  ``csrc/dense_classify.cu`` (which replaces the Pallas
  ``_classify_kernel``).  On a CUDA tensor it launches the kernel or
  raises; on a CPU tensor it runs ``dense_classify_plain``;
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
TILE = 128            # entry rows are padded to a multiple of the kernel's tile
ENTRY_COLS = 12       # key0..4, mask0..4, mask_len, 0

KERNEL = _build.Kernel(
    "dense_classify",
    "infw_dense_classify",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
)


class DenseTables(NamedTuple):
    """Dense-path table operands on one device.

    entries: (Tp, 12) int32 — key words 0..4, mask words 0..4 (uint32 bit
             patterns), mask_len (-1 for padding rows), 0; Tp is the entry
             count rounded up to a multiple of TILE.
    rules:   (Tp, R, 2) int32 — one packed slot per rule:
             [ridAct | proto<<8 | icmpType<<16 | icmpCode<<24,
              portStart | portEnd<<16], ridAct = ruleId<<1 | (action-1),
             all-zero for empty slots and padding rows."""

    entries: torch.Tensor
    rules: torch.Tensor


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


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
    packed = np.zeros((Tp, R, 2), np.int64)
    if T:
        # Byte masking exactly as the TPU packing: action clipped to
        # {DENY, ALLOW}, protocol and ICMP fields to a byte, ports to 16 bits.
        act = np.clip(rules[..., 6], 1, 2) - 1
        rid_act = np.where(rules[..., 0] != 0, ((rules[..., 0] & 0x7F) << 1) | act, 0)
        packed[:T, :, 0] = (
            rid_act
            | ((rules[..., 1] & 0xFF) << 8)
            | ((rules[..., 4] & 0xFF) << 16)
            | ((rules[..., 5] & 0xFF) << 24)
        )
        packed[:T, :, 1] = (rules[..., 2] & 0xFFFF) | ((rules[..., 3] & 0xFFFF) << 16)

    def put(a: np.ndarray) -> torch.Tensor:
        a32 = (a & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
        return torch.from_numpy(np.ascontiguousarray(a32)).to(device)

    return DenseTables(entries=put(entries), rules=put(packed))


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
    operands = (fields, words, dt.entries, dt.rules)
    if fields.shape != (B, 8) or words.shape != (B, 4):
        raise ValueError(
            f"dense_classify: fields {tuple(fields.shape)} / words "
            f"{tuple(words.shape)}, expected (B, 8) / (B, 4)"
        )
    if dt.entries.shape != (Tp, ENTRY_COLS) or Tp % TILE or dt.rules.shape != (Tp, R, 2):
        raise ValueError(
            f"dense_classify: entries {tuple(dt.entries.shape)} / rules "
            f"{tuple(dt.rules.shape)} are not a DenseTables layout"
        )
    for t in operands:
        if t.device != fields.device or t.dtype != torch.int32:
            raise ValueError("dense_classify: operands must be int32 on one device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("dense_classify: operands must be contiguous and 16-byte aligned")
    out = torch.empty((B, 2), dtype=torch.int32, device=fields.device)
    with torch.cuda.device(fields.device):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL.launch(
            fields.data_ptr(), words.data_ptr(), dt.entries.data_ptr(),
            dt.rules.data_ptr(), out.data_ptr(), B, Tp, R, stream,
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
