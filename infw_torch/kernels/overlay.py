"""The overlay combine: a main table on the trie or ctrie path and a small
side table of structurally new keys, classified together by longest prefix.

Counterpart of the JAX package's ``jaxpath.classify_with_overlay``,
``classify_wire_overlay``, ``classify_ctrie_with_overlay``, the wire8
overlay launches (``jitted_classify_wire8_fused(True)``,
``jitted_classify_ctrie_wire8_fused(d_max, True)``) and the delta ones
(``wire_decode.jitted_classify_delta[_ctrie]_fused`` with an overlay).  A
syncer routes CIDR adds on a large table to the overlay (at most 1024
entries), which uploads in kilobytes while the main table stays resident.

Both sides run on hand kernels:

- the main table on K2 (the trie path, at the caller's depth: the IPv4 or
  depth-class truncation applies to the main trie only) or K3 (the ctrie
  path);
- the overlay on K1 over ``dense.build_dense_tables(overlay)``, or, when
  K1's packing would not give the reference's results (ruleIds above 127,
  rules wider than 128, a field outside its packed width, an action other
  than Deny or Allow), on K2 over the overlay's own trie.

Each side's score is ``mask_len + 1`` of its longest-prefix entry, 0 when
nothing matches (``jaxpath._raw_result_and_score``, ``_ctrie_result_and_
score``), read from the kernels' second output column: K1 and K2 return the
entry's index, whose mask length is gathered from the side's own column
(K1's entry rows, ``TrieTables.mask_len``); K3 returns the joined position,
whose row holds the mask length.  The overlay's result wins only on a
strictly greater score (identities are disjoint, so scores never tie), then
the usual verdict, statistics and output packing follow.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..compiler import CompiledTables
from ..layout import pack_rules_u16, v4_trie_depth
from . import cwalk, dense, walk
from .torchpath import (
    DeviceBatch,
    _pack_res16,
    finalize,
    fuse_wire_outputs,
    looked_up_results,
    packet_fields,
    unpack_wire,
    unpack_wire8,
)
from .wire_decode import decode_delta

OverlayTables = Union[dense.DenseTables, walk.TrieTables]
MainTables = Union[walk.TrieTables, cwalk.CTrieTables]


def k1_holds(overlay: CompiledTables) -> bool:
    """Whether K1's packing gives the reference's results for this table:
    the dense packing takes it (at most 4096 entries, rules at most 128
    wide, ruleIds at most 127), every rule field fits its packed width, and
    every rule's action is Deny or Allow (the packing keeps one action
    bit, where the reference's scan reports the stored byte)."""
    if overlay.num_entries > dense.MAX_DENSE_TARGETS or overlay.rule_width > dense.MAX_RULE_WIDTH:
        return False
    rules = np.asarray(overlay.rules[: overlay.num_entries], np.int64)
    if pack_rules_u16(rules) is None:
        return False
    live = rules[..., 0] != 0
    return (not live.any() or int(rules[..., 0].max()) <= dense.MAX_RULE_ID) and bool(
        np.isin(rules[..., 6][live], (1, 2)).all())


def build_overlay_tables(overlay: CompiledTables, device) -> OverlayTables:
    """The overlay's device operands: K1's dense layout when k1_holds,
    else the bucket-padded trie layout K2 walks (the reference pads its
    overlay as it pads the main table)."""
    if k1_holds(overlay):
        return dense.build_dense_tables(overlay, device)
    return walk.build_trie_tables(overlay, device, pad=True)


def _score(tidx: torch.Tensor, mask_len: torch.Tensor) -> torch.Tensor:
    """mask_len[tidx] + 1 for an entry index, 0 for none (-1)."""
    n = mask_len.shape[0]
    ok = (tidx >= 0) & (tidx < n)
    return torch.where(ok, mask_len[tidx.clamp(0, n - 1).long()] + 1, 0)


def overlay_result_and_score(ov: OverlayTables, fields: torch.Tensor,
                             words: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The overlay side: (raw result, score) through K1, or K2 at full
    depth for an overlay K1 does not hold."""
    if isinstance(ov, dense.DenseTables):
        out = dense.dense_classify(fields, words, ov)
        return out[:, 0], _score(out[:, 1], ov.entries[:, 10])
    out = walk.trie_walk_classify(fields, words, ov, ov.n_levels)
    return out[:, 0], _score(out[:, 1], ov.mask_len)


def main_result_and_score(main: MainTables, fields: torch.Tensor, words: torch.Tensor,
                          n_levels: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The main side: (raw result, score) through K2 at ``n_levels``
    levels, or K3, whose second column is the joined position - 1; a row
    whose tidx + 1 halves read 0 (outside the table or a padding row)
    scores 0, as in the reference."""
    if isinstance(main, walk.TrieTables):
        out = walk.trie_walk_classify(fields, words, main, n_levels)
        return out[:, 0], _score(out[:, 1], main.mask_len)
    out = cwalk.ctrie_walk_classify(fields, words, main)
    return out[:, 0], joined_score(main.joined, out[:, 1])


def joined_score(joined: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The score of a ctrie walk's second column (joined position - 1, as
    K3 and K3b return it): the joined row's mask length + 1 when its tidx
    + 1 halves are non-zero, else 0 (no match, outside the rows, a zero
    row)."""
    sel = pos.long() + 1
    J = joined.shape[0]
    row = joined[sel.clamp(0, J - 1), :3].to(torch.int32) & 0xFFFF
    matched = (sel > 0) & (sel < J) & ((row[:, 0] | (row[:, 1] << 16)) > 0)
    return torch.where(matched, row[:, 2] + 1, 0)


def combined_results(main: MainTables, ov: OverlayTables, batch: DeviceBatch,
                     n_levels: Optional[int] = None) -> torch.Tensor:
    """(B,) int32 raw results of the longest-prefix winner across both
    tables: the overlay's where its score is strictly greater."""
    fields, words = packet_fields(batch)
    res_m, score_m = main_result_and_score(main, fields, words, n_levels)
    res_o, score_o = overlay_result_and_score(ov, fields, words)
    return torch.where(score_o > score_m, res_o, res_m)


def classify_overlay(main: MainTables, ov: OverlayTables, batch: DeviceBatch,
                     n_levels: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full forward pass with the overlay: (results int32, xdp int32,
    stats (MAX_TARGETS, 6) int32), as jaxpath.classify_with_overlay and
    classify_ctrie_with_overlay."""
    return finalize(combined_results(main, ov, batch, n_levels), batch)


def classify_overlay_wire_fused(main: MainTables, ov: OverlayTables, wire: torch.Tensor,
                                n_levels: Optional[int] = None) -> torch.Tensor:
    """Packed wire (B, 3|4|6|7) in, one int32 buffer out (u16-pair-packed
    results, then the statistics), as jitted_classify_wire_overlay_fused
    and jitted_classify_ctrie_wire_overlay_fused."""
    res, _xdp, stats = classify_overlay(main, ov, unpack_wire(wire), n_levels)
    return fuse_wire_outputs(res & 0xFFFF, stats)


def classify_overlay_res16(main: MainTables, ov: OverlayTables,
                           batch: DeviceBatch) -> torch.Tensor:
    """The v4-compact formats' overlay classify (wire8, delta): the main
    trie at the IPv4 depth (the ctrie needs no truncation), the results
    only, as ceil(B/2) int32 words of packed res16."""
    n_levels = v4_trie_depth(main.n_levels) if isinstance(main, walk.TrieTables) else None
    return _pack_res16(looked_up_results(combined_results(main, ov, batch, n_levels), batch))


def classify_overlay_wire8(main: MainTables, ov: OverlayTables, wire: torch.Tensor,
                           ifmap: torch.Tensor) -> torch.Tensor:
    """wire8 (B, 2) + its ifindex dictionary in, packed res16 out."""
    return classify_overlay_res16(main, ov, unpack_wire8(wire, ifmap))


def classify_overlay_delta(main: MainTables, ov: OverlayTables, payload: torch.Tensor,
                           dict_vals: torch.Tensor, ifmap: torch.Tensor, *, n: int,
                           dict_mode: int, fixed_w: int) -> torch.Tensor:
    """Delta decode (K4) + the overlay classify, packed res16 out, in
    sorted order."""
    batch = decode_delta(payload, dict_vals, ifmap, n=n, dict_mode=dict_mode, fixed_w=fixed_w)
    return classify_overlay_res16(main, ov, batch)
