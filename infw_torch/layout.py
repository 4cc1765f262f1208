"""Host layout builders of the trie path (numpy only).

The port's own copies of the JAX package's host transforms from the
compiler's slot trie to what the walk reads, and of the depth-steering
helpers:

- ``build_poptrie``: the slot trie -> poptrie node rows (bitmap +
  popcount-rank, implicit child numbering) and the compact targets array;
- ``build_depth_lut`` / ``tune_depth_classes`` / ``depth_group_indices``:
  depth-class steering of IPv6 chunks (a packet whose root slot needs at
  most d deep levels is fully classified by a walk of 1 + d levels);
- ``v4_trie_depth``: the levels an IPv4-only chunk walks;
- ``check_wire_ruleids``: whether results fit the 16-bit wire result.

Every builder that scans a whole table is memoized on the CompiledTables
instance, which is never mutated after the build.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .compiler import CompiledTables, trie_level_strides

#: static deep-level class thresholds, used when a table's depth histogram
#: gives nothing to tune against
DEPTH_CLASS_THRESHOLDS = (0, 3, 7)
#: the most depth classes a tuned table steers into, the full depth included
MAX_DEPTH_CLASSES = 4


def _memo(tables: CompiledTables, name: str, build):
    cached = getattr(tables, name, None)
    if cached is None:
        cached = build()
        setattr(tables, name, cached)
    return cached


def build_poptrie(tables: CompiledTables) -> Tuple[List[np.ndarray], np.ndarray]:
    """Slot trie -> poptrie.  Returns (levels, targets):

    - levels[0]: the DIR-16 root level, (n_0 * 65536, 2) int32 slot rows
      [child + 1, target + 1]; the child is renumbered to the level-1 order
      below (0 = no child);
    - levels[l >= 1]: (n_l, 18) uint32 node rows [child_base, target_base,
      child_bitmap x8, target_bitmap x8].  Nodes are renumbered in the order
      their parent slots appear, so a node's children occupy
      [child_base, child_base + popcount(bitmap)) of the next level and the
      child of slot s is child_base + rank(s); target_base is the GLOBAL
      offset into ``targets`` of the node's first target;
    - targets: int32 target + 1 values of every deep level, concatenated,
      behind a leading 0 sentinel.
    """
    return _memo(tables, "_poptrie_cache", lambda: _build_poptrie(tables))


def _build_poptrie(tables: CompiledTables):
    slot_levels = tables.trie_levels
    strides = trie_level_strides(len(slot_levels))
    out_levels = []
    targets_parts = [np.zeros(1, np.int32)]  # index-0 sentinel
    t_off = 1  # global target index of the current level's first target
    perm = None  # new id -> old id for the current level (None: identity)
    for l, (tbl, stride) in enumerate(zip(slot_levels, strides)):
        slots = 1 << stride
        R = tbl.reshape(tbl.shape[0] // slots, slots, 2)
        if perm is not None:
            R = R[perm] if len(perm) else R[:0]  # unreachable nodes drop out
        n_nodes = R.shape[0]
        child = R[:, :, 0]
        tgt = R[:, :, 1]
        present = child != 0
        perm = child[present]  # next level's order: (node, slot) scan
        if l == 0:
            # the walk computes root * 65536 + nib0 in int32
            if n_nodes * 65536 > np.iinfo(np.int32).max:
                raise ValueError(
                    f"poptrie root level has {n_nodes} nodes; int32 "
                    "DIR-16 indexing supports at most 32767"
                )
            if len(slot_levels) > 1:
                n_next = slot_levels[1].shape[0] // (1 << strides[1])
                inv = np.zeros(max(n_next, 1), np.int32)
                inv[perm] = np.arange(1, len(perm) + 1, dtype=np.int32)
                remapped = np.where(present, inv[child], 0)
            else:
                remapped = np.zeros_like(child)
            lvl0 = np.stack([remapped, tgt], axis=2).reshape(-1, 2)
            out_levels.append(np.ascontiguousarray(lvl0, np.int32))
            continue
        tpres = tgt > 0
        # LSB-first bit packing: slot s -> word s >> 5, bit s & 31
        cb = np.packbits(present, axis=1, bitorder="little")
        cb = np.ascontiguousarray(cb).view("<u4").astype(np.uint32)
        tb = np.packbits(tpres, axis=1, bitorder="little")
        tb = np.ascontiguousarray(tb).view("<u4").astype(np.uint32)
        counts = present.sum(axis=1, dtype=np.int64)
        tcounts = tpres.sum(axis=1, dtype=np.int64)
        cbase = np.zeros(n_nodes, np.int64)
        tbase = np.zeros(n_nodes, np.int64)
        if n_nodes:
            np.cumsum(counts[:-1], out=cbase[1:])
            np.cumsum(tcounts[:-1], out=tbase[1:])
        rows = np.zeros((max(n_nodes, 1), 18), np.uint32)
        if n_nodes:
            rows[:n_nodes, 0] = cbase.astype(np.uint32)
            rows[:n_nodes, 1] = (tbase + t_off).astype(np.uint32)
            rows[:n_nodes, 2:10] = cb.reshape(n_nodes, -1)[:, :8]
            rows[:n_nodes, 10:18] = tb.reshape(n_nodes, -1)[:, :8]
        lvl_targets = tgt[tpres].astype(np.int32)
        t_off += len(lvl_targets)
        out_levels.append(rows)
        targets_parts.append(lvl_targets)
    return out_levels, np.concatenate(targets_parts)


def build_depth_lut(tables: CompiledTables) -> np.ndarray:
    """(n_0 * 65536,) int8: for each root slot, the number of trie levels
    BELOW the root reachable under it.  Packets whose (root, top 16 bits)
    slot maps to d are fully classified by trie_levels[:1 + d]."""
    return _memo(tables, "_depth_lut_cache", lambda: _build_depth_lut(tables))


def _build_depth_lut(tables: CompiledTables) -> np.ndarray:
    levels = tables.trie_levels
    strides = trie_level_strides(len(levels))
    depth_next = None  # per-node depth of the NEXT level
    for l in range(len(levels) - 1, 0, -1):
        child = levels[l].reshape(-1, 1 << strides[l], 2)[:, :, 0]
        if depth_next is None:
            d = np.ones(child.shape[0], np.int8)
        else:
            cd = np.where(child > 0, depth_next[np.clip(child, 0, len(depth_next) - 1)], 0)
            d = (1 + cd.max(axis=1, initial=0)).astype(np.int8)
        depth_next = d
    l0 = levels[0].reshape(-1, 2)
    if depth_next is None:
        return np.zeros(l0.shape[0], np.int8)
    return np.where(
        l0[:, 0] > 0, depth_next[np.clip(l0[:, 0], 0, len(depth_next) - 1)], 0
    ).astype(np.int8)


def depth_group_indices(root_lut_np, lut, classes, ifindex, ip_words, idx):
    """Depth-class binning of the packets at positions ``idx``: returns
    [(class_or_None, positions)] partitioning ``idx``, the last (full
    depth) class reported as None.  Out-of-range ifindexes bin to class 0
    (they resolve to the null root, whose subtree is empty)."""
    ifx = np.asarray(ifindex)[idx].astype(np.int64)
    ok = (ifx >= 0) & (ifx < len(root_lut_np))
    root = np.where(ok, root_lut_np[np.clip(ifx, 0, len(root_lut_np) - 1)], 0)
    nib0 = (np.asarray(ip_words)[idx, 0].astype(np.uint32) >> 16).astype(np.int64)
    e0 = root * 65536 + nib0
    in0 = ok & (e0 >= 0) & (e0 < len(lut))
    pd = np.where(in0, lut[np.clip(e0, 0, len(lut) - 1)], 0)
    out = []
    prev = -1
    for c in classes:
        sub = idx[np.nonzero((pd > prev) & (pd <= c))[0]]
        prev = c
        if len(sub):
            out.append((None if c == classes[-1] else int(c), sub))
    return out


def depth_classes(n_levels: int):
    """The static thresholds below the full deep depth, plus the full depth."""
    full = n_levels - 1
    return tuple(t for t in DEPTH_CLASS_THRESHOLDS if t < full) + (full,)


def depth_class_histogram(tables: CompiledTables) -> np.ndarray:
    """(full_depth + 1,) root-slot counts per deep-level requirement."""
    lut = build_depth_lut(tables)
    full = max(len(tables.trie_levels) - 1, 0)
    return np.bincount(np.asarray(lut, np.int64), minlength=full + 1)[: full + 1]


def tune_depth_classes(tables: CompiledTables):
    """Depth-class thresholds tuned to this table's depth histogram: depth
    0 always gets its own class, then up to ``MAX_DEPTH_CLASSES - 2`` thresholds
    at equal-mass quantiles of the remaining sub-full-depth slot mass, then
    the full depth.  Degenerate histograms take the static classes."""
    return _memo(tables, "_depth_classes_cache", lambda: _tune_depth_classes(tables))


def _tune_depth_classes(tables: CompiledTables):
    full = len(tables.trie_levels) - 1
    if full <= 0:
        return (max(full, 0),)
    below = depth_class_histogram(tables).astype(np.float64)[:full]
    mass = below[1:].sum()
    if mass <= 0:
        return depth_classes(len(tables.trie_levels))
    cum = np.cumsum(below[1:]) / mass  # cum[i] = mass at depth <= i + 1
    picks = {0}
    n_thresh = max(MAX_DEPTH_CLASSES - 2, 1)
    for k in range(1, n_thresh + 1):
        d = 1 + int(np.searchsorted(cum, k / (n_thresh + 1)))
        if 0 < d < full:
            picks.add(d)
    return tuple(sorted(picks)) + (full,)


def v4_trie_depth(n_levels: int) -> int:
    """The leading levels whose bit boundary is within the IPv4 packet-side
    cap (32 bits): an IPv4-only chunk walks only these (min(3, n_levels))."""
    depth, bit_end = 0, 0
    for s in trie_level_strides(n_levels):
        bit_end += s
        if bit_end > 32:
            break
        depth += 1
    return max(1, depth)


def check_wire_ruleids(tables: CompiledTables) -> None:
    """The wire result is (ruleId << 8 | action) in 16 bits, so ruleIds
    must fit 8 bits; raises ValueError for tables that need the u32
    result path."""
    max_rid = int(tables.rules[..., 0].max()) if tables.rules.size else 0
    if max_rid > 0xFF:
        raise ValueError(
            f"max ruleId {max_rid} > 255 does not fit the uint16 wire "
            "result; use the u32 (non-wire) classify path"
        )
