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
  (ValueError for rule tables the uint16 joined rows cannot hold), with
  ``pad=True`` the node, target, joined and root-LUT row counts bucketed
  as jaxpath.device_ctrie(pad=True) does.  TorchClassifier serves padded
  builds only; ``pad=False`` is the reference's unpadded layout, which the
  port is held against;
- ``patch_ctrie``: the incremental device update of a padded upload
  (jaxpath.patch_ctrie): a rules-only edit rewrites the dirty targets'
  joined rows, a structural one the changed rows of every array; the
  result equals a fresh padded build bit for bit;
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
- ``walk_depths``: the skip steps each packet's walk takes;
- ``classify_ctrie_wire_fused`` / ``classify_ctrie_wire8``: the whole
  device pass of a classify, wire in, the one read-back buffer out; on a
  CUDA tensor one memset and one launch of K3's fused entry
  (``infw_ctrie_wire_fused``, counted by ``FUSED_KERNEL``: the wire
  decoded in registers, the u16 results and the per-rule statistics
  written by the kernel), else ``classify_ctrie_wire_fused_plain`` /
  ``classify_ctrie_wire8_plain``, the same function composed of the plain
  K3 and the torch ops of kernels/torchpath.py;
- ``classify_ctrie``: the forward pass of a decoded batch through K3
  (verdict, statistics); ``classify_ctrie_res16``: the results-only pass
  of the delta format (kernels/wire_decode.py).

As on the trie path, the rule scan reports action and ruleId as stored.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..compiler import CompiledTables
from ..constants import MAX_TARGETS
from ..layout import (
    build_cpoptrie,
    hint_dense_rows,
    hint_trie_unchanged,
    joined_by_tidx,
    joined_tidx_patch_rows,
    pad_rows,
    row_bucket,
    seed_caches_forward,
)
from . import _build
from .walk import diff_rows, exact_diff_rows, staged_rows
from .torchpath import (
    STATS_COLS,
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
#: K3's fused wire-to-verdict entry, built from the same source
FUSED_KERNEL = _build.Kernel(
    "ctrie_wire_fused",
    "infw_ctrie_wire_fused",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 + [ctypes.c_void_p],
    source="ctrie_walk",
)
#: the wire widths of the fused entry with statistics (wire8 is width 2)
WIRE_WIDTHS = (3, 4, 6, 7)


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


def _host_layout(tables: CompiledTables):
    """The unpadded host arrays in CTrieTables order (root_lut, l0, nodes,
    targets, joined) and d_max, or None when the joined rows cannot hold
    the rules."""
    joined = joined_by_tidx(tables)
    if joined is None:
        return None
    l0, nodes, targets, d_max = build_cpoptrie(tables)
    return (np.asarray(tables.root_lut, np.int32), l0, nodes, targets, joined), d_max


def build_ctrie_tables(tables: CompiledTables, device=None, pad: bool = False) -> CTrieTables:
    """Host-side packing of CompiledTables into the ctrie layout (a full
    upload to ``device``, resolve_device), with the node, target, joined
    and root-LUT rows bucket-padded when ``pad``.  Raises ValueError when
    joined_by_tidx cannot pack the rule table."""
    device = resolve_device(device)
    host = _host_layout(tables)
    if host is None:
        raise ValueError("build_ctrie_tables: the rules do not fit the uint16 joined rows")
    (root_lut, l0, nodes, targets, joined), d_max = host
    if pad:
        root_lut, nodes, targets, joined = (
            pad_rows(a, row_bucket(a.shape[0])) for a in (root_lut, nodes, targets, joined))
    return ctrie_tables_from_arrays(l0, nodes, targets, joined, root_lut, d_max, device)


def patch_ctrie(ct: CTrieTables, old: CompiledTables, new: CompiledTables, device=None,
                hint=None):
    """Incremental update of ``ct``, a padded upload of ``old``, to ``new``
    (jaxpath.patch_ctrie).  A rules-only hint rewrites exactly the dirty
    targets' joined rows (position tidx + 1) and carries the old
    generation's host layouts to the new one; otherwise every array's rows
    are diffed against the old host layout.  Returns (CTrieTables, rows
    shipped), bit-identical to ``build_ctrie_tables(new, pad=True)``, or
    None when d_max, a row bucket or the DIR-16 root level's shape changes,
    a delta is too large or the rules stop fitting the joined rows (the
    caller uploads in full).  Changed arrays become new tensors
    (walk.staged_rows); ``device`` is where ``ct`` lives."""
    if hint_trie_unchanged(hint):
        seed_caches_forward(old, new, hint)
        pr = joined_tidx_patch_rows(new, hint_dense_rows(hint, new))
        if pr is None:
            return None
        pos, rows = pr
        if len(pos) == 0:
            return ct, 0
        if (int(pos.max()) >= ct.joined.shape[0] or rows.shape[1] != ct.joined.shape[1]
                or len(pos) > ct.joined.shape[0] // 4):
            return None
        return ct._replace(joined=staged_rows(ct.joined, pos, rows)), len(pos)
    o, n = _host_layout(old), _host_layout(new)
    if o is None or n is None or o[1] != n[1] or n[1] != ct.d_max:
        return None
    payload = {}
    for name, o_arr, n_arr in zip(CTrieTables._fields, o[0], n[0]):
        dev = getattr(ct, name)
        payload[name] = (exact_diff_rows(o_arr, n_arr) if name == "l0"
                         else diff_rows(dev.shape[0], o_arr, n_arr))
        if payload[name] is None:
            return None
    patched = {name: staged_rows(getattr(ct, name), *pr) for name, pr in payload.items()}
    return ct._replace(**patched), sum(len(pr[0]) for pr in payload.values())


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


def walk_depths(fields: torch.Tensor, words: torch.Tensor, ct: CTrieTables) -> torch.Tensor:
    """(B,) int32: the skip-node rows K3 reads for each packet (its skip
    steps, at most ``d_max``; 0 for a packet that leaves at the DIR-16
    root), from the plain walk, on the tensors' device."""
    rows = torch.zeros(fields.shape[0], dtype=torch.int64, device=fields.device)
    for s in range(0, fields.shape[0], PLAIN_CHUNK):
        e = s + PLAIN_CHUNK
        ctrie_walk_rows(ct, batch_from_fields(fields[s:e], words[s:e]), ct.d_max,
                        rows_read=rows[s:e])
    return rows.to(torch.int32)


def kernel_args(fields: torch.Tensor, words: torch.Tensor, ct: CTrieTables):
    """K3's operand checks for CUDA tensors: (out, the C entry point's
    arguments before the stream), ``out`` a new (B, 2) int32 tensor the
    kernel fills.  Raises ValueError on operands that are not a
    CTrieTables layout on one device."""
    B = fields.shape[0]
    if fields.shape != (B, 8) or words.shape != (B, 4):
        raise ValueError(
            f"ctrie_walk_classify: fields {tuple(fields.shape)} / words "
            f"{tuple(words.shape)}, expected (B, 8) / (B, 4)"
        )
    check_table(ct, fields.device, "ctrie_walk_classify")
    for t in (fields, words):
        if t.device != fields.device or t.dtype != torch.int32:
            raise ValueError("ctrie_walk_classify: operands must be on one device, "
                             "int32 (joined int16)")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("ctrie_walk_classify: operands must be contiguous and 16-byte aligned")
    out = torch.empty((B, 2), dtype=torch.int32, device=fields.device)
    ptrs, dims = table_args(ct)
    return out, (fields.data_ptr(), words.data_ptr(), *ptrs, out.data_ptr(), B, *dims)


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
    out, args = kernel_args(fields, words, ct)
    with torch.cuda.device(fields.device):
        KERNEL.launch(*args, torch.cuda.current_stream().cuda_stream)
    return out


def classify_ctrie(ct: CTrieTables, batch: DeviceBatch
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full forward pass through K3: (results int32, xdp int32, stats
    (MAX_TARGETS, 6) int32), as jaxpath.classify_ctrie."""
    fields, words = packet_fields(batch)
    return finalize(ctrie_walk_classify(fields, words, ct)[:, 0], batch)


def classify_ctrie_wire_fused_plain(ct: CTrieTables, wire: torch.Tensor) -> torch.Tensor:
    """The fused entry's function in plain PyTorch: unpack_wire, the plain
    K3, finalize and fuse_wire_outputs."""
    batch = unpack_wire(wire)
    fields, words = packet_fields(batch)
    res, _xdp, stats = finalize(ctrie_walk_classify_plain(fields, words, ct)[:, 0], batch)
    return fuse_wire_outputs(res & 0xFFFF, stats)


def classify_ctrie_wire8_plain(ct: CTrieTables, wire: torch.Tensor,
                               ifmap: torch.Tensor) -> torch.Tensor:
    """The wire8 entry's function in plain PyTorch: unpack_wire8, the plain
    K3, looked_up_results and _pack_res16."""
    batch = unpack_wire8(wire, ifmap)
    fields, words = packet_fields(batch)
    return _pack_res16(looked_up_results(ctrie_walk_classify_plain(fields, words, ct)[:, 0],
                                         batch))


def check_table(ct: CTrieTables, device: torch.device, who: str) -> None:
    """K3's table checks for CUDA operands on ``device``: a CTrieTables
    layout, int32 (joined int16), contiguous and 16-byte aligned.  Raises
    ValueError."""
    W = ct.joined.shape[-1]
    if (
        ct.l0.dim() != 2 or ct.l0.shape[1] != 2 or ct.l0.shape[0] % 65536
        or ct.nodes.dim() != 2 or ct.nodes.shape[1] != NODE_WORDS
        or ct.joined.dim() != 2 or W < 3 or (W - 3) % 5
        or ct.targets.dim() != 1 or ct.root_lut.dim() != 1 or ct.d_max < 0
    ):
        raise ValueError(f"{who}: operands are not a CTrieTables layout")
    for t in ct[:5]:
        want = torch.int16 if t is ct.joined else torch.int32
        if t.device != device or t.dtype != want:
            raise ValueError(f"{who}: operands must be on one device, int32 (joined int16)")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{who}: operands must be contiguous and 16-byte aligned")


def table_args(ct: CTrieTables) -> tuple:
    """The table operands of K3's C entry points: the five pointers, then
    the row counts, R and d_max."""
    return (
        (ct.root_lut.data_ptr(), ct.l0.data_ptr(), ct.nodes.data_ptr(), ct.targets.data_ptr(),
         ct.joined.data_ptr()),
        (ct.root_lut.shape[0], ct.l0.shape[0], ct.nodes.shape[0], ct.targets.shape[0],
         ct.joined.shape[0], (ct.joined.shape[1] - 3) // 5, ct.d_max),
    )


def check_wire(wire: torch.Tensor, widths, who: str) -> None:
    """A (B, W) int32 wire with W in ``widths``, contiguous (rows of W
    words).  Raises ValueError."""
    if wire.dim() != 2 or wire.shape[1] not in widths or wire.dtype != torch.int32:
        raise ValueError(f"{who}: wire {tuple(wire.shape)} {wire.dtype}, expected (B, W) int32 "
                         f"with W in {tuple(widths)}")
    if not wire.is_contiguous():
        raise ValueError(f"{who}: the wire must be contiguous")


def fused_args(ct: CTrieTables, wire: torch.Tensor, ifmap=None):
    """The fused entry's operand checks for CUDA tensors: (out, the C entry
    point's arguments before the grid cap and the stream), ``out`` a new
    int32 buffer of ceil(B/2) result words, then (with statistics, every
    width but wire8's) MAX_TARGETS * 6 statistics words."""
    wire8 = ifmap is not None
    who = "classify_ctrie_wire8" if wire8 else "classify_ctrie_wire_fused"
    check_wire(wire, (2,) if wire8 else WIRE_WIDTHS, who)
    check_table(ct, wire.device, who)
    if wire8:
        if (ifmap.dim() != 1 or ifmap.shape[0] < 1 or ifmap.dtype != torch.int32
                or ifmap.device != wire.device or not ifmap.is_contiguous()):
            raise ValueError(f"{who}: ifmap must be a non-empty 1-D int32 tensor on the wire's "
                             "device")
    B = wire.shape[0]
    n = (B + 1) // 2 + (0 if wire8 else MAX_TARGETS * STATS_COLS)
    out = torch.empty(n, dtype=torch.int32, device=wire.device)
    ptrs, dims = table_args(ct)
    return out, (
        wire.data_ptr(), ifmap.data_ptr() if wire8 else 0, *ptrs, out.data_ptr(),
        B, wire.shape[1], ifmap.shape[0] if wire8 else 0, *dims,
    )


def _launch_fused(ct: CTrieTables, wire: torch.Tensor, ifmap, grid: int) -> torch.Tensor:
    out, args = fused_args(ct, wire, ifmap)
    with torch.cuda.device(wire.device):
        FUSED_KERNEL.launch(*args, grid, torch.cuda.current_stream().cuda_stream)
    return out


def classify_ctrie_wire_fused(ct: CTrieTables, wire: torch.Tensor, *,
                              _grid: int = 0) -> torch.Tensor:
    """Packed wire (B, 3|4|6|7) int32 in, ONE int32 buffer out: ceil(B/2)
    words of u16-pair-packed results, then the (MAX_TARGETS, 6) stats
    (jaxpath.jitted_classify_ctrie_wire_fused).  A CPU tensor runs the
    plain version; a CUDA tensor is one memset and one launch of K3's fused
    entry (building it on first use), or raises.  ``_grid`` > 0 caps the
    kernel's grid (tests)."""
    if wire.device.type == "cpu":
        return classify_ctrie_wire_fused_plain(ct, wire)
    if wire.device.type != "cuda":
        raise ValueError(f"classify_ctrie_wire_fused: unsupported device {wire.device}")
    return _launch_fused(ct, wire, None, _grid)


def classify_ctrie_res16(ct: CTrieTables, batch: DeviceBatch) -> torch.Tensor:
    """The delta format's classify through K3: the results only, as
    ceil(B/2) int32 words of u16-pair-packed results (the host derives the
    statistics).  No depth truncation: the walk's per-lane /32 cap bounds
    an IPv4 descent."""
    fields, words = packet_fields(batch)
    return _pack_res16(looked_up_results(ctrie_walk_classify(fields, words, ct)[:, 0], batch))


def classify_ctrie_wire8(ct: CTrieTables, wire: torch.Tensor, ifmap: torch.Tensor, *,
                         _grid: int = 0) -> torch.Tensor:
    """wire8 (B, 2) int32 + its (16,) ifindex dictionary in, packed res16
    out (jaxpath.jitted_classify_ctrie_wire8_fused).  A CPU tensor runs the
    plain version; a CUDA tensor is at most one memset and one launch of
    K3's fused entry, or raises."""
    if wire.device.type == "cpu":
        return classify_ctrie_wire8_plain(ct, wire, ifmap)
    if wire.device.type != "cuda":
        raise ValueError(f"classify_ctrie_wire8: unsupported device {wire.device}")
    return _launch_fused(ct, wire, ifmap, _grid)
