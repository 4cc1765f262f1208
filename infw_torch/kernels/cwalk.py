"""Compressed ctrie classify path: device operands, kernel K3 and its plain
version.

Counterpart of the JAX package's compressed walk (``jaxpath.device_ctrie``,
``ctrie_walk_rows``, ``classify_ctrie[_wire_fused]``) and of its fused
Pallas skip-node walk (``kernels/pallas_walk.py``).  The layout is
layout.build_cpoptrie's: the DIR-16 root slot of (ifindex, top 16 address
bits), then at most ``d_max`` skip nodes of one merged node array (each
checks its absorbed chain bits, consumes an 8-bit stride and rank-indexes
its contiguous children), then the winning target's joined row
(layout.joined_by_tidx, uint16 packed rules) scanned in order for the
first hit.

- ``build_ctrie_tables``: CompiledTables -> CTrieTables on one device
  (ValueError for rule tables the uint16 joined rows cannot hold);
  ``ctrie_tables_from_arrays`` does the upload from host arrays, also those
  of the JAX package's ctrie upload (``jaxpath.device_ctrie``);
- ``ctrie_walk_classify``: the wrapper of the hand-written CUDA kernel
  ``csrc/ctrie_walk.cu`` (which replaces the Pallas ``_make_cwalk_kernel``
  together with the root stage and the rules tail around it).  On a CUDA
  tensor it launches the kernel or raises; on a CPU tensor it runs
  ``ctrie_walk_classify_plain``;
- ``ctrie_walk_classify_plain``: the same function in plain PyTorch
  (ctrie_walk_rows, joined_rule_rows, rule_scan), chunked over packets so
  it also runs at 2^20 packets on the card;
- ``classify_ctrie`` / ``classify_ctrie_wire_fused``: the forward pass
  around the kernel (wire unpack, verdict, statistics, one-buffer output);
  ``classify_ctrie_res16`` / ``classify_ctrie_wire8``: the results-only
  pass of the v4-compact wire formats (wire8 here, delta in
  kernels/wire_decode.py).

As on the trie path, the rule scan reports action and ruleId as stored.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..compiler import CompiledTables
from ..layout import build_cpoptrie, joined_by_tidx
from . import _build
from .torchpath import (
    DeviceBatch,
    _pack_res16,
    batch_from_fields,
    ctrie_walk_rows,
    finalize,
    fuse_wire_outputs,
    joined_rule_rows,
    looked_up_results,
    packet_fields,
    resolve_device,
    rule_scan,
    unpack_wire,
    unpack_wire8,
)

NODE_WORDS = 20  # child_base, target_base, skip_len, skip_bits, bitmaps 8 + 8
#: packets per step of the plain version, which bounds its temporaries
PLAIN_CHUNK = 1 << 16

KERNEL = _build.Kernel(
    "ctrie_walk",
    "infw_ctrie_walk",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
)


class CTrieTables(NamedTuple):
    """Ctrie-path table operands on one device:

    root_lut: (L,) int32 ifindex -> level-0 root (0 = none);
    l0:       (n_0 * 65536, 2) int32 root slots [node id + 1, tidx + 1];
    nodes:    (N, 20) int32 skip-node rows (uint32 bit patterns);
    targets:  (P,) int32 tidx + 1 per target position, 0 sentinel first;
    joined:   (T + 1, 3 + 5R) int16 joined rows (uint16 bit patterns),
              indexed by tidx + 1;
    d_max:    the most skip nodes a walk visits.

    Rows past the layout's own (the zero padding of the JAX package's
    bucketed upload) are unreachable: zero bitmaps, no target points
    there."""

    root_lut: torch.Tensor
    l0: torch.Tensor
    nodes: torch.Tensor
    targets: torch.Tensor
    joined: torch.Tensor
    d_max: int


def ctrie_tables_from_arrays(l0, nodes, targets, joined, root_lut, d_max: int,
                             device=None) -> CTrieTables:
    """Host arrays of the ctrie layout -> CTrieTables on ``device``
    (resolve_device).  The numpy arrays of the JAX package's
    ``jaxpath.device_ctrie`` upload, bucket-padded or not, carry over as
    they are (``{f: np.asarray(getattr(cdev, f)) for f in ("l0", "nodes",
    "targets", "joined", "root_lut")}``): padding rows are zero, so the walk
    never reaches them."""
    device = resolve_device(device)

    def put(a: np.ndarray, dtype) -> torch.Tensor:
        a = np.require(np.asarray(a).view(dtype), requirements="CW")
        return torch.from_numpy(a).to(device)

    return CTrieTables(
        root_lut=put(np.asarray(root_lut, np.int32), np.int32),
        l0=put(np.asarray(l0, np.int32), np.int32),
        nodes=put(np.asarray(nodes, np.uint32), np.int32),
        targets=put(np.asarray(targets, np.int32), np.int32),
        joined=put(np.asarray(joined, np.uint16), np.int16),
        d_max=int(d_max),
    )


def build_ctrie_tables(tables: CompiledTables, device=None) -> CTrieTables:
    """Host-side packing of CompiledTables into the ctrie layout (a full
    upload to ``device``, resolve_device).  Raises ValueError when
    joined_by_tidx cannot pack the rule table."""
    device = resolve_device(device)
    joined = joined_by_tidx(tables)
    if joined is None:
        raise ValueError("build_ctrie_tables: the rules do not fit the uint16 joined rows")
    l0, nodes, targets, d_max = build_cpoptrie(tables)
    return ctrie_tables_from_arrays(l0, nodes, targets, joined, tables.root_lut, d_max, device)


def ctrie_walk_classify_plain(fields: torch.Tensor, words: torch.Tensor,
                              ct: CTrieTables) -> torch.Tensor:
    """K3's function in plain PyTorch: (B, 8) fields + (B, 4) words ->
    (B, 2) int32 [result, tidx or -1]."""
    out = torch.empty((fields.shape[0], 2), dtype=torch.int32, device=fields.device)
    for s in range(0, fields.shape[0], PLAIN_CHUNK):
        e = s + PLAIN_CHUNK
        batch = batch_from_fields(fields[s:e], words[s:e])
        rows, sel = ctrie_walk_rows(ct, batch, ct.d_max)
        out[s:e, 0] = rule_scan(joined_rule_rows(rows), batch)
        out[s:e, 1] = (sel - 1).to(torch.int32)
    return out


def ctrie_walk_classify(fields: torch.Tensor, words: torch.Tensor,
                        ct: CTrieTables) -> torch.Tensor:
    """Kernel K3: (B, 8) int32 fields + (B, 4) int32 words -> (B, 2) int32
    [result, tidx or -1].  A CPU tensor runs the plain version; a CUDA
    tensor launches the CUDA kernel (building it on first use) or
    raises."""
    if fields.device.type == "cpu":
        return ctrie_walk_classify_plain(fields, words, ct)
    if fields.device.type != "cuda":
        raise ValueError(f"ctrie_walk_classify: unsupported device {fields.device}")
    B = fields.shape[0]
    if fields.shape != (B, 8) or words.shape != (B, 4):
        raise ValueError(
            f"ctrie_walk_classify: fields {tuple(fields.shape)} / words "
            f"{tuple(words.shape)}, expected (B, 8) / (B, 4)"
        )
    W = ct.joined.shape[-1]
    if (
        ct.l0.dim() != 2 or ct.l0.shape[1] != 2 or ct.l0.shape[0] % 65536
        or ct.nodes.dim() != 2 or ct.nodes.shape[1] != NODE_WORDS
        or ct.joined.dim() != 2 or W < 3 or (W - 3) % 5
        or ct.targets.dim() != 1 or ct.root_lut.dim() != 1 or ct.d_max < 0
    ):
        raise ValueError("ctrie_walk_classify: operands are not a CTrieTables layout")
    for t in (fields, words) + tuple(ct[:5]):
        want = torch.int16 if t is ct.joined else torch.int32
        if t.device != fields.device or t.dtype != want:
            raise ValueError("ctrie_walk_classify: operands must be on one device, "
                             "int32 (joined int16)")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("ctrie_walk_classify: operands must be contiguous and 16-byte aligned")
    out = torch.empty((B, 2), dtype=torch.int32, device=fields.device)
    with torch.cuda.device(fields.device):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL.launch(
            fields.data_ptr(), words.data_ptr(), ct.root_lut.data_ptr(), ct.l0.data_ptr(),
            ct.nodes.data_ptr(), ct.targets.data_ptr(), ct.joined.data_ptr(), out.data_ptr(),
            B, ct.root_lut.shape[0], ct.l0.shape[0], ct.nodes.shape[0], ct.targets.shape[0],
            ct.joined.shape[0], (W - 3) // 5, ct.d_max,
            stream,
        )
    return out


def classify_ctrie(ct: CTrieTables, batch: DeviceBatch
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full forward pass through K3: (results int32, xdp int32, stats
    (MAX_TARGETS, 6) int32), as jaxpath.classify_ctrie."""
    fields, words = packet_fields(batch)
    return finalize(ctrie_walk_classify(fields, words, ct)[:, 0], batch)


def classify_ctrie_wire_fused(ct: CTrieTables, wire: torch.Tensor) -> torch.Tensor:
    """Packed wire (B, 3|4|6|7) int32 in, ONE int32 buffer out: ceil(B/2)
    words of u16-pair-packed results, then the (MAX_TARGETS, 6) stats."""
    res, _xdp, stats = classify_ctrie(ct, unpack_wire(wire))
    return fuse_wire_outputs(res & 0xFFFF, stats)


def classify_ctrie_res16(ct: CTrieTables, batch: DeviceBatch) -> torch.Tensor:
    """The v4-compact formats' classify (wire8, delta) through K3: the
    results only, as ceil(B/2) int32 words of u16-pair-packed results (the
    host derives the statistics).  No depth truncation: the walk's per-lane
    /32 cap bounds an IPv4 descent."""
    fields, words = packet_fields(batch)
    return _pack_res16(looked_up_results(ctrie_walk_classify(fields, words, ct)[:, 0], batch))


def classify_ctrie_wire8(ct: CTrieTables, wire: torch.Tensor, ifmap: torch.Tensor) -> torch.Tensor:
    """wire8 (B, 2) int32 + its (16,) ifindex dictionary in, packed res16
    out (jaxpath.jitted_classify_ctrie_wire8_fused)."""
    return classify_ctrie_res16(ct, unpack_wire8(wire, ifmap))
