"""Host layouts of the trie and ctrie paths (numpy only).

The port's own copies of the JAX package's host transforms from the
compiler's slot trie to what the walks read, and of the depth-steering
helpers:

- ``build_poptrie``: the slot trie -> poptrie node rows (bitmap +
  popcount-rank, implicit child numbering) and the compact targets array;
- ``build_cpoptrie``: the poptrie -> the merged path-compressed node
  array of the ctrie path (skip nodes absorb single-child chains);
- ``pack_rules_u16`` / ``joined_by_tidx``: the (T, R, 7) rule rows packed
  into 5 uint16 per rule, and the per-target joined rows the ctrie path
  scans; ``packed_rules_flat``: the packed rows flattened, what the arena
  sizes its slabs by;
- ``build_depth_lut`` / ``tune_depth_classes`` / ``depth_group_indices``:
  depth-class steering of IPv6 chunks (a packet whose root slot needs at
  most d deep levels is fully classified by a walk of 1 + d levels);
- ``v4_trie_depth``: the levels an IPv4-only chunk walks;
- ``check_wire_ruleids``: whether results fit the 16-bit wire result;
- ``row_bucket`` / ``pad_rows``: the bucketed row counts of a padded
  upload, so a small edit keeps every device array's shape and can be
  patched (kernels/walk.py, kernels/cwalk.py);
- ``hint_trie_unchanged`` / ``seed_caches_forward`` /
  ``joined_tidx_patch_rows``: a rules-only edit's host side, which carries
  the structural caches of the old generation to the new one and patches
  the joined rows at the dirty targets instead of rebuilding them.

Every function that scans a whole table is memoized on the CompiledTables
instance, which is never mutated after the build.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .compiler import CompiledTables, trie_level_strides

#: static deep-level class thresholds, used when a table's depth histogram
#: gives nothing to tune against
DEPTH_CLASS_THRESHOLDS = (0, 3, 7)
#: the most depth classes a tuned table steers into, the full depth included
MAX_DEPTH_CLASSES = 4
#: the most chain bits one skip node absorbs: the skip plus the node's own
#: 8-bit stride stay within a 32-bit window of two address words
CPOP_MAX_SKIP = 24

_MISSING = object()


def _memo(tables: CompiledTables, name: str, build):
    cached = getattr(tables, name, _MISSING)
    if cached is _MISSING:
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


def _popcount32(x: np.ndarray) -> np.ndarray:
    """SWAR popcount of uint32 values -> int64."""
    x = x.astype(np.uint32)
    x = x - ((x >> 1) & np.uint32(0x55555555))
    x = (x & np.uint32(0x33333333)) + ((x >> 2) & np.uint32(0x33333333))
    x = (x + (x >> 4)) & np.uint32(0x0F0F0F0F)
    return ((x * np.uint32(0x01010101)) >> 24).astype(np.int64)


def _pc_rows(words: np.ndarray) -> np.ndarray:
    return _popcount32(words).sum(axis=1).astype(np.int64)


def _single_child_nib(rows: np.ndarray) -> np.ndarray:
    """Slot index of the single set child-bitmap bit per node (valid only
    where the child count is exactly 1)."""
    cbm = rows[:, 2:10].astype(np.uint32)
    w = np.argmax(cbm != 0, axis=1)
    wv = cbm[np.arange(len(rows)), w].astype(np.float64)
    # log2 is exact for single-bit values up to 2^31
    bit = np.zeros(len(rows), np.int64)
    pos = wv > 0
    bit[pos] = np.log2(wv[pos]).astype(np.int64)
    return w.astype(np.int64) * 32 + bit


def _crange_concat(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """The [s, s + c) ranges concatenated (int64)."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    ends = np.cumsum(counts)
    offs = np.repeat(starts - np.concatenate([[0], ends[:-1]]), counts)
    return offs + np.arange(total, dtype=np.int64)


def build_cpoptrie(tables: CompiledTables) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Poptrie levels -> the merged path-compressed node array.  Returns
    (l0, nodes, targets, d_max):

    - l0:      (n_0 * 65536, 2) int32 root slots [node id + 1, tidx + 1];
    - nodes:   (max(N, 1), 20) uint32 skip-node rows [child_base,
      target_base, skip_len <= CPOP_MAX_SKIP, skip_bits, child bitmap x8,
      target bitmap x8].  A chain of single-child, target-free nodes folds
      into its last node's skip fields; nodes are numbered breadth-first
      in (parent, slot) order, so a node's children are the contiguous
      [child_base, child_base + popcount) and the child of slot s is
      child_base + rank(s);
    - targets: (1 + n_targets,) int32 tidx + 1 per target position,
      position 0 the sentinel, each node's targets contiguous from
      target_base;
    - d_max:   the most skip nodes a walk visits (the breadth-first depth).
    """
    return _memo(tables, "_cpoptrie_cache", lambda: _build_cpoptrie(tables))


def _build_cpoptrie(tables: CompiledTables):
    levels, targets = build_poptrie(tables)
    deep = [np.asarray(lv, np.uint32) for lv in levels[1:]]
    L = len(deep)
    n_l = [d.shape[0] for d in deep]
    empty = np.zeros(0, np.int64)
    cc = [_pc_rows(d[:, 2:10]) if d.size else empty for d in deep]
    tc = [_pc_rows(d[:, 10:18]) if d.size else empty for d in deep]
    cb_base = [d[:, 0].astype(np.int64) if d.size else empty for d in deep]
    tb_base = [d[:, 1].astype(np.int64) if d.size else empty for d in deep]
    nib1 = [_single_child_nib(d) if d.size else empty for d in deep]

    # top-down: pending skip accumulation and the skip/emit decision
    pend_len = [np.zeros(n, np.int64) for n in n_l]
    pend_bits = [np.zeros(n, np.int64) for n in n_l]
    skipped = []
    for l in range(L):
        chain = (cc[l] == 1) & (tc[l] == 0) & (l + 1 < L)
        sk = chain & (pend_len[l] + 8 <= CPOP_MAX_SKIP)
        skipped.append(sk)
        if l + 1 < L and sk.any():
            idx = np.nonzero(sk)[0]
            ch = cb_base[l][idx]  # the single child's id at level l + 1
            ok = ch < n_l[l + 1]
            idx, ch = idx[ok], ch[ok]
            pend_len[l + 1][ch] = pend_len[l][idx] + 8
            pend_bits[l + 1][ch] = (pend_bits[l][idx] << 8) | nib1[l][idx]

    # bottom-up: resolve every node to the emitted node absorbing it
    res_lvl: list = [None] * L
    res_id: list = [None] * L
    for l in range(L - 1, -1, -1):
        lv = np.full(n_l[l], l, np.int64)
        ids = np.arange(n_l[l], dtype=np.int64)
        if l + 1 < L and n_l[l + 1]:
            ch = np.clip(cb_base[l], 0, n_l[l + 1] - 1)
            lv = np.where(skipped[l], res_lvl[l + 1][ch], lv)
            ids = np.where(skipped[l], res_id[l + 1][ch], ids)
        res_lvl[l], res_id[l] = lv, ids

    # breadth-first numbering: emitted nodes in (parent, slot) order, so
    # every node's children stay contiguous
    l0 = np.asarray(levels[0], np.int32)
    c0 = l0[:, 0].astype(np.int64)
    has0 = c0 > 0
    if L and has0.any() and n_l[0]:
        ch0 = np.clip(c0[has0] - 1, 0, n_l[0] - 1)
        f_lvl, f_id = res_lvl[0][ch0], res_id[0][ch0]
    else:
        f_lvl, f_id = empty, empty

    rows_out: list = []
    tgt_out: list = []
    total = 0
    t_total = 1  # targets[0] is the sentinel
    first_ids = None
    d_max = 0
    while len(f_lvl):
        d_max += 1
        n_f = len(f_lvl)
        gids = total + np.arange(n_f, dtype=np.int64)
        total += n_f
        if first_ids is None:
            first_ids = gids
        # per-node data, gathered by source level
        cc_f = np.empty(n_f, np.int64)
        tc_f = np.empty(n_f, np.int64)
        cb_f = np.empty(n_f, np.int64)
        tb_f = np.empty(n_f, np.int64)
        pl_f = np.empty(n_f, np.int64)
        pb_f = np.empty(n_f, np.int64)
        bm_f = np.zeros((n_f, 16), np.uint32)
        lvl_next = np.empty(n_f, np.int64)
        for l in np.unique(f_lvl):
            m = f_lvl == l
            sel = f_id[m]
            cc_f[m] = cc[l][sel]
            tc_f[m] = tc[l][sel]
            cb_f[m] = cb_base[l][sel]
            tb_f[m] = tb_base[l][sel]
            pl_f[m] = pend_len[l][sel]
            pb_f[m] = pend_bits[l][sel]
            bm_f[m] = deep[l][sel, 2:18]
            lvl_next[m] = l + 1
        # next frontier: the resolved children, whole contiguous ranges
        child_old = _crange_concat(cb_f, cc_f)
        child_lvl_src = np.repeat(lvl_next, cc_f)
        nf_lvl = np.empty(len(child_old), np.int64)
        nf_id = np.empty(len(child_old), np.int64)
        for l in np.unique(child_lvl_src):
            m = child_lvl_src == l
            if l >= L or n_l[l] == 0:
                # dead pointers below the last level resolve to self; their
                # bitmaps are zero, so the walk never descends
                nf_lvl[m] = l - 1
                nf_id[m] = 0
                continue
            sel = np.clip(child_old[m], 0, n_l[l] - 1)
            nf_lvl[m] = res_lvl[l][sel]
            nf_id[m] = res_id[l][sel]
        excl_c = np.concatenate([[0], np.cumsum(cc_f)[:-1]])
        excl_t = np.concatenate([[0], np.cumsum(tc_f)[:-1]])
        rows = np.zeros((n_f, 20), np.uint32)
        rows[:, 0] = (total + excl_c).astype(np.uint32)
        rows[:, 1] = (t_total + excl_t).astype(np.uint32)
        rows[:, 2] = pl_f.astype(np.uint32)
        rows[:, 3] = pb_f.astype(np.uint32)
        rows[:, 4:20] = bm_f
        rows_out.append(rows)
        # flat targets in node order (values are tidx + 1)
        tgt_out.append(targets[_crange_concat(tb_f, tc_f)].astype(np.int64))
        t_total += int(tc_f.sum())
        f_lvl, f_id = nf_lvl, nf_id

    nodes = np.concatenate(rows_out) if rows_out else np.zeros((1, 20), np.uint32)
    new_targets = np.concatenate([np.zeros(1, np.int64)] + tgt_out).astype(np.int32)
    l0_new = l0.copy()
    l0_new[:, 0] = 0
    if first_ids is not None:
        l0_new[np.nonzero(has0)[0], 0] = (first_ids + 1).astype(np.int32)
    return l0_new, nodes, new_targets, d_max


def pack_rules_u16(rules: np.ndarray) -> Optional[np.ndarray]:
    """(T, R, 7) int32 -> (T, R, 5) uint16 packed rule rows [ruleId |
    action << 8, proto | icmpType << 8, icmpCode, portStart, portEnd], or
    None when a field exceeds its packed width (ruleId, proto, ICMP fields
    and action 8 bits, ports 16)."""
    if rules.size == 0:
        return np.zeros(rules.shape[:2] + (5,), np.uint16)
    mx = rules.max(axis=(0, 1))
    if int(rules.min()) < 0 or (mx[[0, 1, 4, 5, 6]] > 0xFF).any() or (mx[[2, 3]] > 0xFFFF).any():
        return None
    out = np.empty(rules.shape[:2] + (5,), np.uint16)
    out[..., 0] = rules[..., 0] | (rules[..., 6] << 8)
    out[..., 1] = rules[..., 1] | (rules[..., 4] << 8)
    out[..., 2] = rules[..., 5]
    out[..., 3] = rules[..., 2]
    out[..., 4] = rules[..., 3]
    return out


def packed_rules_flat(tables: CompiledTables) -> np.ndarray:
    """(T, 5R) uint16 flattened packed rules, or the (T, 7R) int32 rows of
    a table pack_rules_u16 refuses (jaxpath._packed_rules_flat)."""
    def build():
        rules = pack_rules_u16(tables.rules)
        if rules is None:
            rules = tables.rules
        return np.ascontiguousarray(rules).reshape(rules.shape[0], -1)

    return _memo(tables, "_packed_rules_cache", build)


def joined_by_tidx(tables: CompiledTables) -> Optional[np.ndarray]:
    """(T + 1, 3 + 5R) uint16 joined rows indexed by tidx + 1, row 0 the
    no-match sentinel: [tidx + 1 low half, high half, mask_len, the
    target's packed rules].  None for rule tables pack_rules_u16 refuses
    (the ctrie path then does not serve the table)."""
    return _memo(tables, "_joined_tidx_cache", lambda: _joined_by_tidx(tables))


def _joined_by_tidx(tables: CompiledTables):
    packed = pack_rules_u16(tables.rules)
    if packed is None:
        return None
    T = packed.shape[0]
    rows = np.zeros((T + 1, 3 + 5 * packed.shape[1]), np.uint16)
    tvals = np.arange(1, T + 1, dtype=np.int64)
    rows[1:, 0] = (tvals & 0xFFFF).astype(np.uint16)
    rows[1:, 1] = (tvals >> 16).astype(np.uint16)
    rows[1:, 2] = np.minimum(np.maximum(tables.mask_len, 0), 0xFFFF).astype(np.uint16)
    rows[1:, 3:] = packed.reshape(T, -1)
    return rows


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


def row_bucket(n: int) -> int:
    """Bucketed device row count (jaxpath._row_bucket): a power of two (at
    least 8) up to 4096 rows, then whole 4096-row chunks, so a few appended
    rows keep the array's shape."""
    if n <= 0:
        return 8
    if n <= 4096:
        return max(8, 1 << (n - 1).bit_length())
    return -(-n // 4096) * 4096


def pad_rows(a: np.ndarray, n_rows: int, fill=0) -> np.ndarray:
    """``a`` with rows of ``fill`` appended up to ``n_rows`` (jaxpath._pad_rows)."""
    if a.shape[0] >= n_rows:
        return a
    out = np.zeros((n_rows,) + a.shape[1:], a.dtype)
    if fill:
        out[a.shape[0]:] = fill
    out[: a.shape[0]] = a
    return out


def hint_trie_unchanged(hint) -> bool:
    """True when an IncrementalTables dirty hint proves the edit rules-only
    (no trie slot row written): the condition for carrying the structural
    caches forward and for the joined-row fast path."""
    return hint is not None and all(len(h) == 0 for h in hint.get("levels", [np.zeros(1)]))


def hint_dense_rows(hint, tables: CompiledTables) -> np.ndarray:
    """The hint's dirty dense rows that exist in ``tables``, unique."""
    dirty = np.unique(np.asarray(hint.get("dense", ()), np.int64))
    return dirty[(dirty >= 0) & (dirty < tables.rules.shape[0])]


def joined_tidx_patch_rows(tables: CompiledTables, dirty: np.ndarray):
    """(positions, rows) of joined_by_tidx's rows at the dirty dense rows
    (jaxpath._joined_tidx_patch_rows): position tidx + 1, row [tidx + 1 low,
    high, mask_len, packed rules]; None when those rules do not pack into
    uint16."""
    dirty = dirty[(dirty >= 0) & (dirty < tables.rules.shape[0])]
    packed = pack_rules_u16(tables.rules[dirty])
    if packed is None:
        return None
    pos = dirty + 1
    rows = np.zeros((len(pos), 3 + 5 * packed.shape[1]), np.uint16)
    rows[:, 0] = (pos & 0xFFFF).astype(np.uint16)
    rows[:, 1] = (pos >> 16).astype(np.uint16)
    rows[:, 2] = np.minimum(np.maximum(np.asarray(tables.mask_len)[dirty], 0),
                            0xFFFF).astype(np.uint16)
    rows[:, 3:] = packed.reshape(len(pos), rows.shape[1] - 3)
    return pos, rows


def seed_caches_forward(old: CompiledTables, new: CompiledTables, hint) -> None:
    """Across a rules-only edit (the hint proves the trie untouched), give
    ``new`` the host layouts ``old`` has built: the poptrie, the cpoptrie
    and the depth-steering caches read the trie only, so they are shared;
    the per-target joined rows are copied and patched at the dirty rows
    (jaxpath._seed_caches_forward and seed_ctrie_caches_forward).  Runs
    before anything builds a layout of ``new``: a 1-key edit at 1M entries
    then costs no rebuild.  A cache ``new`` already has is kept; a joined
    patch that does not fit leaves the cache to be rebuilt."""
    if not hint_trie_unchanged(hint) or old.rules.shape != new.rules.shape:
        return
    for name in ("_poptrie_cache", "_cpoptrie_cache", "_depth_lut_cache",
                 "_depth_classes_cache"):
        if hasattr(old, name) and not hasattr(new, name):
            setattr(new, name, getattr(old, name))
    if not hasattr(old, "_joined_tidx_cache") or hasattr(new, "_joined_tidx_cache"):
        return
    jt = old._joined_tidx_cache
    dirty = hint_dense_rows(hint, new)
    if jt is None or len(dirty) == 0:
        # the reference carries an unpackable table's verdict forward too
        new._joined_tidx_cache = jt
        return
    pr = joined_tidx_patch_rows(new, dirty)
    if pr is not None and pr[1].shape[1] == jt.shape[1] and int(pr[0].max()) < jt.shape[0]:
        jn = jt.copy()
        jn[pr[0]] = pr[1]
        new._joined_tidx_cache = jn
