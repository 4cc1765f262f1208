"""Trie classify path: device operands, kernel K2 and its plain version.

Counterpart of the JAX package's fused deep walk (``kernels/pallas_walk.py``)
and of its XLA trie walk (``jaxpath.trie_walk`` + ``gather_rule_rows`` +
``rule_scan``).  Tables above the dense limit are classified by walking
the poptrie (layout.build_poptrie): the DIR-16 root slot of (ifindex, top
16 address bits), then one 8-bit level per node row with a popcount-rank
child step, then the winning target's rule row scanned in order for the
first hit.

- ``build_trie_tables``: CompiledTables -> TrieTables on one device, with
  ``pad=True`` every row count bucketed (layout.row_bucket) so that a
  later edit can be patched.  TorchClassifier serves padded builds only,
  the overlay's included; ``pad=False`` is the reference's unpadded
  ``jaxpath.device_tables`` layout, which the port is held against;
- ``patch_trie_tables``: the incremental device update of a padded upload
  (jaxpath.patch_device_tables on K2's own layout): only the changed rows
  cross the link, and the result equals a fresh padded build bit for bit;
- ``trie_walk_classify``: the wrapper of the hand-written CUDA kernel
  ``csrc/trie_walk.cu`` (which replaces the Pallas ``_make_walk_kernel``;
  a persistent walk whose warps refill the lanes of finished packets).
  On a CUDA tensor it launches the kernel or raises; on a CPU tensor it
  runs ``trie_walk_classify_plain``;
- ``trie_walk_classify_plain``: the same function in plain PyTorch,
  chunked over packets so it also runs at 2^20 packets on the card;
- ``walk_depths``: the node rows each packet's walk reads (with one
  thread per packet a warp steps until its deepest packet is done: their
  spread within 32 packets is what K2's lane refilling saves);
- ``classify_walk`` / ``classify_walk_wire_fused``: the forward pass
  around the kernel (wire unpack, verdict, statistics, one-buffer output);
  ``classify_walk_res16`` / ``classify_wire8``: the results-only pass of
  the v4-compact wire formats (wire8 here, delta in kernels/wire_decode.py)
  at the IPv4 depth.

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
from ..layout import (
    build_poptrie,
    hint_dense_rows,
    hint_trie_unchanged,
    pad_rows,
    row_bucket,
    seed_caches_forward,
    v4_trie_depth,
)
from . import _build
from .torchpath import (
    DeviceBatch,
    _pack_res16,
    batch_from_fields,
    finalize,
    fuse_wire_outputs,
    gather_rule_rows,
    looked_up_results,
    packet_fields,
    resolve_device,
    rule_scan,
    trie_walk,
    unpack_wire,
    unpack_wire8,
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
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
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
    mask_len:   (T,) each entry's mask length, -1 for tombstones and
                padding (the overlay combine's LPM score; K2 does not read
                it);
    deep_rows:  the row counts of ``level_rows`` on the host.

    A padded build (``pad=True``) rounds each deep level, ``targets``,
    ``rules``, ``mask_len`` and ``root_lut`` up to layout.row_bucket rows;
    ``level_rows`` and ``deep_rows`` then hold the padded counts.  Padding
    rows are zero (mask_len -1) and unreachable: no child rank or target
    points there, and a zero node row stops a walk as leaving the level
    does, so every clip bound K2 takes from these shapes gives the result
    of the unpadded layout."""

    root_lut: torch.Tensor
    l0: torch.Tensor
    deep: torch.Tensor
    level_rows: torch.Tensor
    targets: torch.Tensor
    rules: torch.Tensor
    mask_len: torch.Tensor
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


def _host_layout(tables: CompiledTables, pad: bool):
    """The host arrays of the trie layout: (root_lut, l0, deep levels,
    targets, rules, mask_len), bucket-padded when ``pad``."""
    levels, targets = build_poptrie(tables)
    if len(levels) > MAX_LEVELS:
        raise ValueError(f"trie has {len(levels)} levels; the walk reads at most {MAX_LEVELS}")
    mask_len = np.array(tables.mask_len, np.int32)
    mask_len[tables.num_entries:] = -1
    root_lut = np.asarray(tables.root_lut, np.int32)
    deep = [np.asarray(d).view(np.int32) for d in levels[1:]]
    rules = np.asarray(tables.rules, np.int32)
    targets = np.asarray(targets, np.int32)
    if pad:
        deep = [pad_rows(d, row_bucket(d.shape[0])) for d in deep]
        targets = pad_rows(targets, row_bucket(targets.shape[0]))
        rules = pad_rows(rules, row_bucket(rules.shape[0]))
        mask_len = pad_rows(mask_len, row_bucket(mask_len.shape[0]), fill=-1)
        root_lut = pad_rows(root_lut, row_bucket(root_lut.shape[0]))
    return root_lut, np.asarray(levels[0], np.int32), deep, targets, rules, mask_len


def build_trie_tables(tables: CompiledTables, device=None, pad: bool = False) -> TrieTables:
    """Host-side packing of CompiledTables into the trie layout (a full
    upload to ``device``, resolve_device), bucket-padded when ``pad``.
    Raises ValueError for a trie deeper than MAX_LEVELS."""
    device = resolve_device(device)
    root_lut, l0, deep, targets, rules, mask_len = _host_layout(tables, pad)
    counts = np.array([d.shape[0] for d in deep], np.int64)
    level_rows = np.stack([np.cumsum(counts) - counts, counts], axis=1).astype(np.int32)

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return TrieTables(
        root_lut=put(root_lut),
        l0=put(l0),
        deep=put(np.concatenate(deep) if deep else np.zeros((0, ROW_WORDS), np.int32)),
        level_rows=put(level_rows.reshape(-1, 2)),
        targets=put(targets),
        rules=put(rules),
        mask_len=put(mask_len),
        deep_rows=tuple(int(c) for c in counts),
    )


def staged_rows(dev: torch.Tensor, pos: np.ndarray, rows: np.ndarray) -> torch.Tensor:
    """``dev`` with ``rows`` written at the unique row positions ``pos``,
    as a NEW tensor: the positions and rows cross to the device in one
    staged copy, then a device-side clone of ``dev`` takes them with
    ``index_copy_``.  The resident tensor is never written, so a batch
    launched against it reads the old rows whatever it was ordered
    after."""
    if len(pos) == 0:
        return dev
    out = dev.clone()
    write_rows([(out, pos, rows)])
    return out


def write_rows(entries) -> None:
    """Write each entry's ``rows`` at its unique row positions ``pos``
    into its tensor ``dev``, IN PLACE: every entry's positions and rows
    cross to the device in ONE staged copy (each segment 16-byte
    aligned), then one ``index_copy_`` per tensor on the current stream.
    ``entries`` is a sequence of (dev, pos, rows); empty ones are
    skipped."""
    segs, layout, off = [], [], 0
    for dev, pos, rows in entries:
        k = len(pos)
        if k == 0:
            continue
        np_dtype = {torch.int32: np.int32, torch.int16: np.int16}[dev.dtype]
        vals = np.ascontiguousarray(rows).view(np_dtype).reshape((k,) + tuple(dev.shape[1:]))
        parts = (np.asarray(pos, np.int32).view(np.uint8), vals.reshape(-1).view(np.uint8))
        offs = []
        for p in parts:
            offs.append(off)
            segs.append((off, p))
            off += -(-p.nbytes // 16) * 16
        layout.append((dev, k, offs, vals.shape))
    if not layout:
        return
    buf = np.zeros(off, np.uint8)
    for o, p in segs:
        buf[o: o + p.nbytes] = p
    staged = torch.from_numpy(buf).to(layout[0][0].device)
    for dev, k, (po, vo), shape in layout:
        idx = staged[po: po + 4 * k].view(torch.int32).long()
        n = int(np.prod(shape)) * dev.element_size()
        dev.index_copy_(0, idx, staged[vo: vo + n].view(dev.dtype).reshape(shape))


def diff_rows(n_dev: int, old: np.ndarray, new: np.ndarray, fill=0):
    """(positions, rows) that turn a padded upload of ``old`` (``n_dev``
    rows) into one of ``new`` (jaxpath._patch_diff_payload): the changed
    rows, the rows ``new`` appends, and the rows it drops reset to
    ``fill``.  None when the row bucket or the row shape changes, or when
    more than a quarter of the rows change (a full upload then wins)."""
    if (old.shape[1:] != new.shape[1:] or row_bucket(new.shape[0]) != n_dev
            or row_bucket(old.shape[0]) != n_dev):
        return None
    no, nn = old.shape[0], new.shape[0]
    common = min(no, nn)
    changed = np.nonzero((old[:common].reshape(common, -1)
                          != new[:common].reshape(common, -1)).any(axis=1))[0]
    pos, rows = [changed], [new[changed]]
    if nn > no:
        pos.append(np.arange(no, nn))
        rows.append(new[no:])
    elif no > nn:
        pos.append(np.arange(nn, no))
        rows.append(np.full((no - nn,) + new.shape[1:], fill, new.dtype))
    pos = np.concatenate(pos)
    if len(pos) > n_dev // 4:
        return None
    return pos, np.concatenate(rows)


def exact_diff_rows(old: np.ndarray, new: np.ndarray):
    """(positions, rows) for an unpadded array whose shape must not change
    (the DIR-16 root slots); None when it does or more than a quarter of
    its rows change."""
    if old.shape != new.shape:
        return None
    changed = np.nonzero((old != new).reshape(old.shape[0], -1).any(axis=1))[0]
    if len(changed) > max(old.shape[0] // 4, 1):
        return None
    return changed, new[changed]


def patch_trie_tables(tt: TrieTables, old: CompiledTables, new: CompiledTables,
                      device=None, hint=None):
    """Incremental update of ``tt``, a padded upload of ``old``, to ``new``
    (jaxpath.patch_device_tables with _patch_array_rows, _capped_scatter
    and txn_scatter, on K2's own layout).  Returns (TrieTables, rows
    shipped), bit-identical to ``build_trie_tables(new, pad=True)``, or
    None when the level count or the rule rows' bucket changes or their
    delta is too large (the caller uploads in full).

    With an IncrementalTables hint the rule and mask-length rows are the
    hinted ones (no host diff); a rules-only hint also proves the trie
    unchanged, so the node levels, targets and DIR-16 slots carry over by
    reference and the new generation inherits the old one's host layouts.
    Without a hint, or for a structural one, the trie arrays are diffed
    against the old generation's host layout; as in the reference, an
    array whose bucket or shape changed, or whose delta is too large, is
    uploaded whole (a node inserted early in a level renumbers the rows
    after it, so a structural edit often re-uploads the node levels and
    targets).  Each changed array ships its rows in one staged copy into a
    new tensor (staged_rows); an unchanged array is shared with ``tt``.
    ``device`` is where ``tt`` lives."""
    if len(old.trie_levels) != len(new.trie_levels) or tt.n_levels != len(new.trie_levels):
        return None
    rules_only = hint_trie_unchanged(hint)
    if rules_only:
        seed_caches_forward(old, new, hint)
    new_mask = np.array(new.mask_len, np.int32)
    new_mask[new.num_entries:] = -1
    if hint is not None:
        rows = hint_dense_rows(hint, new)
        n_rules = tt.rules.shape[0]
        if (row_bucket(new.rules.shape[0]) != n_rules or len(rows) > n_rules // 4
                or tuple(tt.rules.shape[1:]) != new.rules.shape[1:]):
            return None
        dense = {"rules": (rows, new.rules[rows]), "mask_len": (rows, new_mask[rows])}
    else:
        old_mask = np.array(old.mask_len, np.int32)
        old_mask[old.num_entries:] = -1
        dense = {"rules": diff_rows(tt.rules.shape[0], np.asarray(old.rules, np.int32),
                                    np.asarray(new.rules, np.int32)),
                 "mask_len": diff_rows(tt.mask_len.shape[0], old_mask, new_mask, fill=-1)}
        if dense["rules"] is None or dense["mask_len"] is None:
            return None
    out = {name: staged_rows(getattr(tt, name), *pr) for name, pr in dense.items()}
    total = sum(len(pr[0]) for pr in dense.values())
    dev = tt.rules.device

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def patch_or_upload(name, pr, whole):
        nonlocal total
        if pr is None:
            out[name] = put(whole)
            total += whole.shape[0]
        else:
            out[name] = staged_rows(getattr(tt, name), *pr)
            total += len(pr[0])

    o_lut = np.asarray(old.root_lut, np.int32)
    n_lut = np.asarray(new.root_lut, np.int32)
    patch_or_upload("root_lut", diff_rows(tt.root_lut.shape[0], o_lut, n_lut),
                    pad_rows(n_lut, row_bucket(n_lut.shape[0])))
    if not rules_only:
        _, o_l0, o_deep, o_targets, _, _ = _host_layout(old, pad=False)
        _, n_l0, n_deep, n_targets, _, _ = _host_layout(new, pad=False)
        patch_or_upload("l0", exact_diff_rows(o_l0, n_l0), n_l0)
        patch_or_upload("targets", diff_rows(tt.targets.shape[0], o_targets, n_targets),
                        pad_rows(n_targets, row_bucket(n_targets.shape[0])))
        deep = [diff_rows(n, o, w) for n, o, w in zip(tt.deep_rows, o_deep, n_deep)]
        if all(p is not None for p in deep):
            offsets = np.cumsum((0,) + tt.deep_rows[:-1])
            patch_or_upload("deep", (
                np.concatenate([np.zeros(0, np.int64)] + [p[0] + o for p, o in zip(deep, offsets)]),
                np.concatenate([np.zeros((0, ROW_WORDS), np.int32)] + [p[1] for p in deep]),
            ), None)
        else:  # the whole node array, and with it the level offsets
            padded = [pad_rows(d, row_bucket(d.shape[0])) for d in n_deep]
            counts = np.array([d.shape[0] for d in padded], np.int64)
            patch_or_upload("deep", None, np.concatenate(padded) if padded
                            else np.zeros((0, ROW_WORDS), np.int32))
            out["level_rows"] = put(np.stack([np.cumsum(counts) - counts, counts],
                                             axis=1).astype(np.int32).reshape(-1, 2))
            out["deep_rows"] = tuple(int(c) for c in counts)
    return tt._replace(**out), total


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


def walk_depths(fields: torch.Tensor, words: torch.Tensor, tt: TrieTables,
                n_levels: int) -> torch.Tensor:
    """(B,) int32: the deep node rows K2 reads for each packet at
    ``n_levels`` levels (0 for a packet that leaves at the DIR-16 root),
    from the plain walk, on the tensors' device."""
    _check_levels(tt, n_levels)
    levels = tt.levels(n_levels)
    rows = torch.zeros(fields.shape[0], dtype=torch.int64, device=fields.device)
    for s in range(0, fields.shape[0], PLAIN_CHUNK):
        e = s + PLAIN_CHUNK
        trie_walk(levels, tt.targets, tt.root_lut, batch_from_fields(fields[s:e], words[s:e]),
                  rows_read=rows[s:e])
    return rows.to(torch.int32)


def kernel_args(fields: torch.Tensor, words: torch.Tensor, tt: TrieTables, n_levels: int):
    """K2's operand checks for CUDA tensors: (out, the C entry point's
    arguments before the grid cap and the stream), ``out`` a new (B, 2)
    int32 tensor the kernel fills.  Raises ValueError on operands that are
    not a TrieTables layout on one device."""
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
    return out, (
        fields.data_ptr(), words.data_ptr(), tt.root_lut.data_ptr(), tt.l0.data_ptr(),
        tt.deep.data_ptr(), tt.level_rows.data_ptr(), tt.targets.data_ptr(),
        tt.rules.data_ptr(), out.data_ptr(),
        B, tt.root_lut.shape[0], tt.l0.shape[0], tt.targets.shape[0], T, R, n_levels,
    )


def trie_walk_classify(
    fields: torch.Tensor, words: torch.Tensor, tt: TrieTables, n_levels: int, *, _grid: int = 0
) -> torch.Tensor:
    """Kernel K2: (B, 8) int32 fields + (B, 4) int32 words -> (B, 2) int32
    [result, tidx or -1] after walking ``n_levels`` levels.  A CPU tensor
    runs the plain version; a CUDA tensor launches the CUDA kernel
    (building it on first use) or raises.  ``_grid`` > 0 caps the
    kernel's grid (tests only: every lane then refills many times)."""
    if fields.device.type == "cpu":
        return trie_walk_classify_plain(fields, words, tt, n_levels)
    if fields.device.type != "cuda":
        raise ValueError(f"trie_walk_classify: unsupported device {fields.device}")
    out, args = kernel_args(fields, words, tt, n_levels)
    with torch.cuda.device(fields.device):
        KERNEL.launch(*args, _grid, torch.cuda.current_stream().cuda_stream)
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


def classify_walk_res16(tt: TrieTables, batch: DeviceBatch) -> torch.Tensor:
    """The v4-compact formats' classify (wire8, delta): K2 at the IPv4
    depth (``layout.v4_trie_depth``, the chunk holds no IPv6 packet), the
    results only, as ceil(B/2) int32 words of u16-pair-packed results (the
    host derives the statistics)."""
    fields, words = packet_fields(batch)
    res = trie_walk_classify(fields, words, tt, v4_trie_depth(tt.n_levels))[:, 0]
    return _pack_res16(looked_up_results(res, batch))


def classify_wire8(tt: TrieTables, wire: torch.Tensor, ifmap: torch.Tensor) -> torch.Tensor:
    """wire8 (B, 2) int32 + its (16,) ifindex dictionary in, packed res16
    out (jaxpath.classify_wire8 with v4_only)."""
    return classify_walk_res16(tt, unpack_wire8(wire, ifmap))
