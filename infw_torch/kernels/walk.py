"""Trie classify path: device operands, kernel K2 and its plain version.

Counterpart of the JAX package's fused deep walk (``kernels/pallas_walk.py``)
and of its XLA trie walk (``jaxpath.trie_walk`` + ``gather_rule_rows`` +
``rule_scan``).  Tables above the dense limit are classified by walking
the poptrie (layout.build_poptrie): the DIR-16 root slot of (ifindex, top
16 address bits), then one 8-bit level per node row with a popcount-rank
child step, then the winning target's rule row scanned in order for the
first hit.

- ``build_trie_tables``: CompiledTables -> TrieTables on one device;
- ``trie_walk_classify``: the wrapper of the hand-written CUDA kernel
  ``csrc/trie_walk.cu`` (which replaces the Pallas ``_make_walk_kernel``).
  On a CUDA tensor it launches the kernel or raises; on a CPU tensor it
  runs ``trie_walk_classify_plain``;
- ``trie_walk_classify_plain``: the same function in plain PyTorch,
  chunked over packets so it also runs at 2^20 packets on the card;
- ``classify_walk`` / ``classify_walk_wire_fused``: the forward pass
  around the kernel (wire unpack, verdict, statistics, one-buffer output).

``n_levels`` is the number of trie levels walked: all of them for a mixed
batch, ``layout.v4_trie_depth`` for an IPv4-only chunk, 1 + d for an IPv6
chunk of depth class d.  The rule scan follows ``rule_scan``: the action
and ruleId are reported as stored (masked to 8 and 24 bits), unlike the
dense packing, which clips the action to {DENY, ALLOW}.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..compiler import CompiledTables, trie_levels_for_mask
from ..layout import build_poptrie
from . import _build
from .torchpath import (
    DeviceBatch,
    batch_from_fields,
    finalize,
    fuse_wire_outputs,
    gather_rule_rows,
    packet_fields,
    resolve_device,
    rule_scan,
    trie_walk,
    unpack_wire,
)

#: the deepest trie the walk reads: the root level plus 8-bit levels down
#: to bit 128 (a /128 prefix)
MAX_LEVELS = trie_levels_for_mask(128)
ROW_WORDS = 18  # child_base, target_base, child bitmap x8, target bitmap x8
#: packets per step of the plain version, which bounds its temporaries
PLAIN_CHUNK = 1 << 16

KERNEL = _build.Kernel(
    "trie_walk",
    "infw_trie_walk",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
)


class TrieTables(NamedTuple):
    """Trie-path table operands on one device (int32 tensors):

    root_lut:   (L,) ifindex -> level-0 node (0 = none);
    l0:         (n_0 * 65536, 2) DIR-16 root slots [child + 1, target + 1];
    deep:       (N, 18) the poptrie node rows of levels 1.. concatenated
                (uint32 bit patterns);
    level_rows: (n_levels - 1, 2) [first row in ``deep``, row count] per
                deep level;
    targets:    (P,) target + 1 per deep-level target, 0 sentinel first;
    rules:      (T, R, 7) the compiled rule rows;
    deep_rows:  the row counts of ``level_rows`` on the host."""

    root_lut: torch.Tensor
    l0: torch.Tensor
    deep: torch.Tensor
    level_rows: torch.Tensor
    targets: torch.Tensor
    rules: torch.Tensor
    deep_rows: Tuple[int, ...]

    @property
    def n_levels(self) -> int:
        return 1 + len(self.deep_rows)

    def levels(self, n_levels: int):
        """The first ``n_levels`` levels in trie_walk's form."""
        out, off = [self.l0], 0
        for n in self.deep_rows[: n_levels - 1]:
            out.append(self.deep[off : off + n])
            off += n
        return out


def build_trie_tables(tables: CompiledTables, device=None) -> TrieTables:
    """Host-side packing of CompiledTables into the trie layout (a full
    upload to ``device``, resolve_device).  Raises ValueError for a trie
    deeper than MAX_LEVELS."""
    device = resolve_device(device)
    levels, targets = build_poptrie(tables)
    if len(levels) > MAX_LEVELS:
        raise ValueError(f"trie has {len(levels)} levels; the walk reads at most {MAX_LEVELS}")
    deep = levels[1:]
    counts = np.array([d.shape[0] for d in deep], np.int64)
    level_rows = np.stack([np.cumsum(counts) - counts, counts], axis=1).astype(np.int32)

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return TrieTables(
        root_lut=put(np.asarray(tables.root_lut, np.int32)),
        l0=put(levels[0]),
        deep=put(
            np.concatenate(deep).view(np.int32) if deep
            else np.zeros((0, ROW_WORDS), np.int32)
        ),
        level_rows=put(level_rows.reshape(-1, 2)),
        targets=put(np.asarray(targets, np.int32)),
        rules=put(np.asarray(tables.rules, np.int32)),
        deep_rows=tuple(int(c) for c in counts),
    )


def _check_levels(tt: TrieTables, n_levels: int) -> None:
    if not 1 <= n_levels <= tt.n_levels:
        raise ValueError(f"n_levels {n_levels} outside [1, {tt.n_levels}]")


def trie_walk_classify_plain(
    fields: torch.Tensor, words: torch.Tensor, tt: TrieTables, n_levels: int
) -> torch.Tensor:
    """K2's function in plain PyTorch: (B, 8) fields + (B, 4) words ->
    (B, 2) int32 [result, tidx or -1] after walking ``n_levels`` levels."""
    _check_levels(tt, n_levels)
    levels = tt.levels(n_levels)
    out = torch.empty((fields.shape[0], 2), dtype=torch.int32, device=fields.device)
    for s in range(0, fields.shape[0], PLAIN_CHUNK):
        e = s + PLAIN_CHUNK
        batch = batch_from_fields(fields[s:e], words[s:e])
        tidx = trie_walk(levels, tt.targets, tt.root_lut, batch)
        out[s:e, 0] = rule_scan(gather_rule_rows(tt.rules, tidx), batch)
        out[s:e, 1] = tidx.to(torch.int32)
    return out


def trie_walk_classify(
    fields: torch.Tensor, words: torch.Tensor, tt: TrieTables, n_levels: int
) -> torch.Tensor:
    """Kernel K2: (B, 8) int32 fields + (B, 4) int32 words -> (B, 2) int32
    [result, tidx or -1] after walking ``n_levels`` levels.  A CPU tensor
    runs the plain version; a CUDA tensor launches the CUDA kernel
    (building it on first use) or raises."""
    if fields.device.type == "cpu":
        return trie_walk_classify_plain(fields, words, tt, n_levels)
    if fields.device.type != "cuda":
        raise ValueError(f"trie_walk_classify: unsupported device {fields.device}")
    _check_levels(tt, n_levels)
    B = fields.shape[0]
    T, R = tt.rules.shape[0], tt.rules.shape[1]
    if fields.shape != (B, 8) or words.shape != (B, 4):
        raise ValueError(
            f"trie_walk_classify: fields {tuple(fields.shape)} / words "
            f"{tuple(words.shape)}, expected (B, 8) / (B, 4)"
        )
    if (
        tt.l0.dim() != 2 or tt.l0.shape[1] != 2 or tt.l0.shape[0] % 65536
        or tt.deep.shape != (sum(tt.deep_rows), ROW_WORDS)
        or tt.level_rows.shape != (tt.n_levels - 1, 2)
        or tt.rules.shape != (T, R, 7) or tt.targets.dim() != 1 or tt.root_lut.dim() != 1
    ):
        raise ValueError("trie_walk_classify: operands are not a TrieTables layout")
    operands = (fields, words) + tuple(tt[:6])
    for t in operands:
        if t.device != fields.device or t.dtype != torch.int32:
            raise ValueError("trie_walk_classify: operands must be int32 on one device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("trie_walk_classify: operands must be contiguous and 16-byte aligned")
    out = torch.empty((B, 2), dtype=torch.int32, device=fields.device)
    with torch.cuda.device(fields.device):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL.launch(
            fields.data_ptr(), words.data_ptr(), tt.root_lut.data_ptr(), tt.l0.data_ptr(),
            tt.deep.data_ptr(), tt.level_rows.data_ptr(), tt.targets.data_ptr(),
            tt.rules.data_ptr(), out.data_ptr(),
            B, tt.root_lut.shape[0], tt.l0.shape[0], tt.targets.shape[0], T, R, n_levels,
            stream,
        )
    return out


def classify_walk(
    tt: TrieTables, batch: DeviceBatch, n_levels: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full forward pass through K2: (results int32, xdp int32, stats
    (MAX_TARGETS, 6) int32), as jaxpath.classify(use_trie=True)."""
    fields, words = packet_fields(batch)
    return finalize(trie_walk_classify(fields, words, tt, n_levels)[:, 0], batch)


def classify_walk_wire_fused(tt: TrieTables, wire: torch.Tensor, n_levels: int) -> torch.Tensor:
    """Packed wire (B, 3|4|6|7) int32 in, ONE int32 buffer out: ceil(B/2)
    words of u16-pair-packed results, then the (MAX_TARGETS, 6) stats."""
    res, _xdp, stats = classify_walk(tt, unpack_wire(wire), n_levels)
    return fuse_wire_outputs(res & 0xFFFF, stats)
