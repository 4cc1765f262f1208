"""The dense-family arena's compare-all classify: kernel K6 and its plain
version, and the arena overlay combine.

Counterpart of the JAX package's ``jaxpath.arena_dense_result_and_score``,
``classify_arena_dense``, ``classify_arena_with_overlay`` and the dense and
overlay branches of ``jitted_classify_arena_wire_fused``, which are XLA
there, not Pallas.  Each packet carries a tenant id; the device page table
steers it to its tenant's slab of the pooled dense layout
(arena.DenseArena), whose S rows it compares against all at once.

- ``arena_dense_classify``: the wrapper of the hand-written CUDA kernel
  ``csrc/arena_dense.cu`` (K6's two-column entry, ``KERNEL``): (fields,
  words, tenant) -> (B, 2) int32 [raw result, score = mask_len + 1 of the
  winning row, 0 = none].  On a CUDA tensor it launches the kernel (a
  cooperative launch that groups the packets by slab page, stages each
  slab in shared memory and runs the LPM on the int8 tensor cores, then
  the rule scan's launch) or raises; on a CPU tensor it runs
  ``arena_dense_classify_plain``;
- ``arena_dense_classify_plain``: the same function in plain PyTorch (the
  (b, S, 5) gather-compare, the first maximum, the row's rule_scan),
  chunked so a step holds at most ``PLAIN_ROWS`` packet-row pairs;
- ``classify_arena_dense_wire_fused``: the whole device pass of a
  mixed-tenant classify, wire and tenant column in, the one read-back
  buffer out; on a CUDA tensor one memset and one call of K6's fused
  entry (``FUSED_KERNEL``: its two kernels), else
  ``classify_arena_dense_wire_fused_plain``;
- ``classify_arena_overlay_wire``: the arena with a dense overlay
  side-pool (``classify_arena_with_overlay``): the main side on K3b's
  two-column entry (a ctrie pool, the score the joined row's mask length
  + 1) or K6's (a dense pool), the overlay side on K6's two-column entry,
  the overlay's result where its score is strictly greater, then
  finalize and fuse_wire_outputs;
- ``page_buckets``, ``tile_starts``, ``chunk_operands`` and
  ``formulation``: what the kernel computes, step by step, in plain
  PyTorch (the page grouping, each staged chunk's planes, constants and
  groups, the integer product and the running maxima), for the tests and
  ``chip_smoke.py``; the port's classify never calls them.

As on the ctrie path, the rule scan reports action and ruleId as stored.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from ..constants import KIND_IPV4, MAX_TARGETS
from . import _build, arena_walk
from .cwalk import WIRE_WIDTHS, check_wire
from .overlay import joined_score
from .torchpath import (
    STATS_COLS,
    DeviceBatch,
    batch_from_fields,
    finalize,
    fuse_wire_outputs,
    looked_up_results,
    packet_fields,
    rule_scan,
    unpack_wire,
)

#: packet-row pairs per step of the plain version, which bounds its
#: (b, S, 5) temporaries
PLAIN_ROWS = 1 << 22

#: K6's two-column entry (the overlay combine's operand)
KERNEL = _build.Kernel(
    "arena_dense",
    "infw_arena_dense_walk",
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
)
#: K6's fused wire-to-verdict entry, built from the same source
FUSED_KERNEL = _build.Kernel(
    "arena_dense_fused",
    "infw_arena_dense_fused",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    source="arena_dense",
)

# The kernel's geometry (csrc/arena_dense.cu), which the formulation
# below follows.
#: slab rows staged at once; a later chunk wins only with a longer match
CHUNK = 1024
#: bits of a staged row's tie field: (mask_len + 1) << TIE_BITS | (CHUNK - 1 - row)
TIE_BITS = 10
#: packets of one tile (one page's packets, 16 warps x 32)
TILE_PACKETS = 512
#: staged row groups: (longer than /32) x (1..5 k-steps of 32 key bits)
N_GROUPS = 10
#: rows of a tensor-core n-tile: each group is padded to a multiple
N_TILE = 8
#: the score constant's scale (lpm_mma.cuh kBig, K1's LPM_BIG) and the
#: constant of a padding row
LPM_BIG = 1 << 21
LPM_NEVER = -(1 << 30)


def scratch_words(B: int, pages: int) -> int:
    """int32 words of the kernel's scratch: the bucket totals and cursors
    (P + 2 each, ``page_buckets``), the bucket starts (P + 3), the page
    tile starts (P + 2), the permutation (B), then from an even word each
    packet's (winning row, score) (B, 2)."""
    n = 4 * pages + 9 + B
    return n + n % 2 + 2 * B


def slab_rows(arena, pages: int) -> int:
    """S, the rows of one slab of a DenseArena of ``pages`` slabs."""
    return arena.mask_len.shape[0] // pages


def arena_dense_rows(arena, batch: DeviceBatch, tenant: torch.Tensor, pages: int):
    """The slab lookup (jaxpath.arena_dense_result_and_score): ((b, R, 5)
    int16 rule rows of the winning entry, zero where nothing matches; (b,)
    int32 score mask_len + 1, 0 = none; (b,) int64 pool row of the winner,
    meaningful where the score is non-zero).  Ties go to the lowest row,
    as argmax's first maximum; row indices clip to the pool."""
    S = slab_rows(arena, pages)
    N = arena.mask_len.shape[0]
    pg = arena_walk.arena_pages(arena.page_table, tenant)
    valid = pg >= 0
    base = pg.clamp(min=0) * S
    ridx = (base[:, None] + torch.arange(S, device=pg.device)[None, :]).clamp(0, N - 1)
    kw = arena.key_words[ridx]    # (b, S, 5)
    mw = arena.mask_words[ridx]
    ml = arena.mask_len[ridx]     # (b, S)
    pkt = torch.cat([batch.ifindex[:, None], batch.ip_words], dim=1).to(torch.int32)
    match = (((pkt[:, None, :] ^ kw) & mw) == 0).all(dim=-1)
    cap = torch.where(batch.kind == KIND_IPV4, 32, 128)
    ok = valid[:, None] & match & (ml >= 0) & (ml <= cap[:, None])
    score_all = torch.where(ok, ml + 1, 0)
    score = score_all.max(dim=1).values
    cols = torch.arange(S, device=pg.device)[None, :]
    loc = torch.where(score_all == score[:, None], cols, S).min(dim=1).values
    win = (base + loc).clamp(0, N - 1)
    rows = torch.where((score > 0)[:, None], arena.rules[win], 0)
    return rows.reshape(rows.shape[0], -1, 5), score.to(torch.int32), win


def arena_dense_classify_plain(fields: torch.Tensor, words: torch.Tensor, tenant: torch.Tensor,
                               arena, *, pages: int) -> torch.Tensor:
    """K6's function in plain PyTorch: (B, 8) fields + (B, 4) words + (B,)
    tenant -> (B, 2) int32 [result, score]."""
    out = torch.empty((fields.shape[0], 2), dtype=torch.int32, device=fields.device)
    chunk = max(1, PLAIN_ROWS // max(1, slab_rows(arena, pages)))
    for s in range(0, fields.shape[0], chunk):
        e = s + chunk
        batch = batch_from_fields(fields[s:e], words[s:e])
        rows, score, _win = arena_dense_rows(arena, batch, tenant[s:e], pages)
        out[s:e, 0] = rule_scan(rows, batch)
        out[s:e, 1] = score
    return out


def _check_pool(arena, pages: int, device: torch.device, who: str) -> None:
    N = arena.mask_len.shape[0] if arena.mask_len.dim() == 1 else 0
    W = arena.rules.shape[-1] if arena.rules.dim() == 2 else 0
    if (
        pages < 1 or N == 0 or N % pages
        or arena.key_words.shape != (N, 5) or arena.mask_words.shape != (N, 5)
        or arena.rules.dim() != 2 or arena.rules.shape[0] != N or W % 5
        or arena.page_table.dim() != 1 or arena.page_table.shape[0] == 0
    ):
        raise ValueError(f"{who}: operands are not a DenseArena layout")
    for t in arena:
        want = torch.int16 if t is arena.rules else torch.int32
        if t.device != device or t.dtype != want:
            raise ValueError(f"{who}: operands must be on one device, int32 (rules int16)")
        if not t.is_contiguous():
            raise ValueError(f"{who}: operands must be contiguous")


def _pool_args(arena, pages: int, B: int) -> tuple:
    """The pool operands of K6's C entry points: the five pointers and a
    new scratch tensor's, then MT, S, the pool's rows and R; and the
    scratch tensor."""
    N = arena.mask_len.shape[0]
    scratch = torch.empty(scratch_words(B, pages), dtype=torch.int32,
                          device=arena.mask_len.device)
    return (
        (arena.page_table.data_ptr(), arena.key_words.data_ptr(), arena.mask_words.data_ptr(),
         arena.mask_len.data_ptr(), arena.rules.data_ptr(), scratch.data_ptr()),
        (arena.page_table.shape[0], N // pages, N, arena.rules.shape[1] // 5),
        scratch,
    )


def kernel_args(fields: torch.Tensor, words: torch.Tensor, tenant: torch.Tensor, arena, *,
                pages: int):
    """K6's operand checks for CUDA tensors: (out, scratch, the two-column
    entry's arguments before the grid cap and the stream), ``out`` a new
    (B, 2) int32 tensor, ``scratch`` the kernel's new scratch tensor, to
    be held until the launch is enqueued."""
    who = "arena_dense_classify"
    B = fields.shape[0]
    if fields.shape != (B, 8) or words.shape != (B, 4) or tenant.shape != (B,):
        raise ValueError(
            f"{who}: fields {tuple(fields.shape)} / words {tuple(words.shape)} / tenant "
            f"{tuple(tenant.shape)}, expected (B, 8) / (B, 4) / (B,)")
    _check_pool(arena, pages, fields.device, who)
    for t in (fields, words, tenant):
        if t.device != fields.device or t.dtype != torch.int32:
            raise ValueError(f"{who}: operands must be on one device, int32 (rules int16)")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{who}: operands must be contiguous and 16-byte aligned")
    out = torch.empty((B, 2), dtype=torch.int32, device=fields.device)
    ptrs, dims, scratch = _pool_args(arena, pages, B)
    return out, scratch, (fields.data_ptr(), words.data_ptr(), tenant.data_ptr(), *ptrs,
                          out.data_ptr(), B, *dims)


def arena_dense_classify(fields: torch.Tensor, words: torch.Tensor, tenant: torch.Tensor,
                         arena, *, pages: int, _grid: int = 0) -> torch.Tensor:
    """Kernel K6 (two-column entry): (B, 8) int32 fields + (B, 4) int32
    words + (B,) int32 tenant over a DenseArena of ``pages`` slabs -> (B,
    2) int32 [result, score].  A CPU tensor runs the plain version; a CUDA
    tensor launches the CUDA kernel (building it on first use), or raises.
    ``_grid`` is a test seam: > 0 caps the grid of its cooperative launch,
    so that at a test's size one block works through the tiles of several
    pages and restages its slab; no caller in the port sets it."""
    if fields.device.type == "cpu":
        return arena_dense_classify_plain(fields, words, tenant, arena, pages=pages)
    if fields.device.type != "cuda":
        raise ValueError(f"arena_dense_classify: unsupported device {fields.device}")
    out, _scratch, args = kernel_args(fields, words, tenant, arena, pages=pages)
    with torch.cuda.device(fields.device):
        KERNEL.launch(*args, _grid, torch.cuda.current_stream().cuda_stream)
    return out


def classify_arena_dense(arena, batch: DeviceBatch, tenant: torch.Tensor, *,
                         pages: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full mixed-tenant forward pass through K6: (results int32, xdp
    int32, stats (MAX_TARGETS, 6) int32), as jaxpath.classify_arena_dense."""
    fields, words = packet_fields(batch)
    raw = arena_dense_classify(fields, words, tenant.to(torch.int32).contiguous(), arena,
                               pages=pages)
    return finalize(raw[:, 0], batch)


def classify_arena_dense_wire_fused_plain(arena, wire: torch.Tensor, tenant: torch.Tensor, *,
                                          pages: int) -> torch.Tensor:
    """The fused entry's function in plain PyTorch: unpack_wire, the plain
    K6, finalize and fuse_wire_outputs."""
    batch = unpack_wire(wire)
    fields, words = packet_fields(batch)
    raw = arena_dense_classify_plain(fields, words, tenant.to(torch.int32), arena, pages=pages)
    res, _xdp, stats = finalize(raw[:, 0], batch)
    return fuse_wire_outputs(res & 0xFFFF, stats)


def fused_args(arena, wire: torch.Tensor, tenant: torch.Tensor, *, pages: int):
    """The fused entry's operand checks for CUDA tensors: (out, scratch,
    the C entry point's arguments before the grid cap and the stream),
    ``out`` a new int32 buffer of ceil(B/2) result words, then MAX_TARGETS
    * 6 statistics words, ``scratch`` as for ``kernel_args``."""
    who = "classify_arena_dense_wire_fused"
    check_wire(wire, WIRE_WIDTHS, who)
    B = wire.shape[0]
    if (tenant.shape != (B,) or tenant.dtype != torch.int32 or tenant.device != wire.device
            or not tenant.is_contiguous()):
        raise ValueError(f"{who}: tenant {tuple(tenant.shape)} {tenant.dtype}, expected a "
                         f"contiguous ({B},) int32 tensor on the wire's device")
    _check_pool(arena, pages, wire.device, who)
    out = torch.empty((B + 1) // 2 + MAX_TARGETS * STATS_COLS, dtype=torch.int32,
                      device=wire.device)
    ptrs, dims, scratch = _pool_args(arena, pages, B)
    MT, S, N, R = dims
    return out, scratch, (wire.data_ptr(), tenant.data_ptr(), *ptrs, out.data_ptr(), B,
                          wire.shape[1], MT, S, N, R)


def classify_arena_dense_wire_fused(arena, wire: torch.Tensor, tenant: torch.Tensor, *,
                                    pages: int, _grid: int = 0) -> torch.Tensor:
    """Packed wire (B, 3|4|6|7) int32 + (B,) int32 tenant in, ONE int32
    buffer out: ceil(B/2) words of u16-pair-packed results, then the
    (MAX_TARGETS, 6) stats (jaxpath.jitted_classify_arena_wire_fused,
    dense family, no overlay).  A CPU tensor runs the plain version; a
    CUDA tensor is one memset and K6's fused entry (building it on first
    use), or raises.  ``_grid`` is a test seam, as for
    ``arena_dense_classify``."""
    if wire.device.type == "cpu":
        return classify_arena_dense_wire_fused_plain(arena, wire, tenant, pages=pages)
    if wire.device.type != "cuda":
        raise ValueError(f"classify_arena_dense_wire_fused: unsupported device {wire.device}")
    out, _scratch, args = fused_args(arena, wire, tenant, pages=pages)
    with torch.cuda.device(wire.device):
        FUSED_KERNEL.launch(*args, _grid, torch.cuda.current_stream().cuda_stream)
    return out


# -- what the kernel computes, in plain PyTorch -----------------------------------


class PageBuckets(NamedTuple):
    """K6's grouping of a batch (phases 1-3): bucket p < P is page p, P the
    clip page (a page-table entry past the pool, whose rows all clip to the
    last pool row), P + 1 "none" (an invalid or absent tenant, or a lane
    the caller leaves out), which never enters the product."""

    bucket: torch.Tensor   # (B,) int64
    start: torch.Tensor    # (P + 3,) int64: the first slot of each bucket, then B
    perm: torch.Tensor     # (B,) int64: packet indices by bucket (the kernel's order
    #                        within a bucket is arbitrary; here it is ascending)


def page_buckets(page_table: torch.Tensor, tenant: torch.Tensor, pages: int,
                 keep: torch.Tensor = None) -> PageBuckets:
    """The kernel's bucket of every packet and the page-ordered
    permutation (a counting sort); ``keep`` (B,) bool, when given, sends
    the other lanes to "none" (the fused entry's lanes finalize zeroes)."""
    pg = arena_walk.arena_pages(page_table, tenant)
    none = pg < 0 if keep is None else (pg < 0) | ~keep
    bucket = torch.where(none, pages + 1, pg.clamp(max=pages))
    counts = torch.bincount(bucket, minlength=pages + 2)
    start = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    return PageBuckets(bucket, start, torch.argsort(bucket, stable=True))


def tile_starts(start: torch.Tensor) -> torch.Tensor:
    """(P + 2,) int64: the first TILE_PACKETS-packet tile of each page 0..P
    (the clip page included), then the tile count."""
    counts = start[1:-1] - start[:-2]
    tiles = (counts + TILE_PACKETS - 1) // TILE_PACKETS
    return torch.cat([tiles.new_zeros(1), tiles.cumsum(0)])


class ChunkOperands(NamedTuple):
    """One staged chunk of a slab in the kernel's shared memory, rows in
    group order: group g (longer than /32 if g >= 5; k-steps g % 5 + 1)
    holds slots [gstart[g], gstart[g + 1]), padded to whole n-tiles."""

    planes: torch.Tensor  # (n, 160) int8: M0 - M1, zero past the group's k-steps
    const: torch.Tensor   # (n,) int32: key - LPM_BIG * rowsum(M1), LPM_NEVER for padding
    row: torch.Tensor     # (n,) int64: the chunk row of each slot, -1 for padding
    gstart: torch.Tensor  # (N_GROUPS + 1,) int64


def key_bits(words: torch.Tensor) -> torch.Tensor:
    """(n, 5) 32-bit words -> (n, 160) int64 0/1 bits, big-endian within
    each word (the order of the kernel's planes and A fragments)."""
    shift = torch.arange(31, -1, -1, device=words.device)
    w = words.to(torch.int64) & 0xFFFFFFFF
    return ((w[:, :, None] >> shift) & 1).reshape(w.shape[0], 160)


def chunk_operands(key_words: torch.Tensor, mask_words: torch.Tensor,
                   mask_len: torch.Tensor) -> ChunkOperands:
    """The staged operands of one chunk of at most CHUNK rows ((n, 5) key
    and mask words, (n,) mask_len): the live rows (mask_len 0..128) sorted
    into the N_GROUPS groups by (mask_len > 32, the k-steps their masks
    cover: the last non-zero mask word + 1, at least 1), each group padded
    to a multiple of N_TILE rows; a row's constant packs (mask_len + 1) <<
    TIE_BITS | (CHUNK - 1 - its chunk row), so that among equal lengths
    the lowest row has the largest key."""
    n = mask_len.shape[0]
    assert n <= CHUNK
    ml = mask_len.to(torch.int64)
    live = (ml >= 0) & (ml <= 128)
    covered = (mask_words != 0).to(torch.int64) * torch.arange(1, 6, device=ml.device)
    steps = covered.max(dim=1).values.clamp(min=1)
    group = torch.where(ml > 32, 5, 0) + steps - 1
    bits, mask = key_bits(key_words), key_bits(mask_words)
    m1 = mask & bits
    planes = (mask & (1 - bits)) - m1
    planes = torch.where(torch.arange(160, device=ml.device)[None, :] < 32 * steps[:, None],
                         planes, 0)
    key = ((ml + 1) << TIE_BITS) | (CHUNK - 1 - torch.arange(n, device=ml.device))
    const = key - LPM_BIG * m1.sum(dim=1)
    rows, gstart = [], [0]
    for g in range(N_GROUPS):
        idx = torch.nonzero(live & (group == g))[:, 0]
        pad = -len(idx) % N_TILE
        rows.append(torch.cat([idx, idx.new_full((pad,), -1)]))
        gstart.append(gstart[-1] + len(idx) + pad)
    row = torch.cat(rows)
    real = row >= 0
    return ChunkOperands(
        planes=torch.where(real[:, None], planes[row.clamp(min=0)], 0).to(torch.int8),
        const=torch.where(real, const[row.clamp(min=0)], LPM_NEVER).to(torch.int32),
        row=row, gstart=torch.tensor(gstart, dtype=torch.int64, device=ml.device))


def chunk_best(ops: ChunkOperands, fields: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """(b,) int32: each packet's maximum over one staged chunk, the
    kernel's tensor-core product written as an integer product of its 0/1
    key bits and the planes: score = const - LPM_BIG * (bits . plane);
    an IPv4 packet over the groups of mask_len <= 32 only.  Positive iff a
    row matches: then (mask_len + 1) << TIE_BITS | (CHUNK - 1 - row)."""
    bits = key_bits(torch.cat([fields[:, 1:2], words], dim=1))
    dot = torch.matmul(bits, ops.planes.to(torch.int64).t())
    score = ops.const.to(torch.int64)[None, :] - LPM_BIG * dot
    assert score.numel() == 0 or (score.min() >= -(1 << 31) and score.max() < 1 << 31)
    lowest = torch.iinfo(torch.int64).min
    n_short = int(ops.gstart[5])
    short = torch.cat([score[:, :n_short], score.new_full((score.shape[0], 1), lowest)], 1)
    whole = torch.cat([score, score.new_full((score.shape[0], 1), lowest)], 1)
    v4 = fields[:, 0] == KIND_IPV4
    return torch.where(v4, short.max(dim=1).values, whole.max(dim=1).values).to(torch.int32)


def formulation(fields: torch.Tensor, words: torch.Tensor, tenant: torch.Tensor, arena, *,
                pages: int, keep: torch.Tensor = None) -> torch.Tensor:
    """K6's function computed the way the kernel computes it: (B, 8)
    fields + (B, 4) words + (B,) tenant -> (B, 2) int32 [result, score]
    (``keep`` as for ``page_buckets``; a left-out lane reads (0, 0)).  The
    packets grouped by page, each page's slab staged chunk by chunk
    (``chunk_operands``), each chunk's maxima (``chunk_best``) combined so
    that a later chunk wins only with a longer match, then the winning
    row's rule scan."""
    S = slab_rows(arena, pages)
    N = arena.mask_len.shape[0]
    grouping = page_buckets(arena.page_table, tenant, pages, keep)
    out = torch.zeros((fields.shape[0], 2), dtype=torch.int32, device=fields.device)
    for p in range(pages + 1):
        lo, hi = int(grouping.start[p]), int(grouping.start[p + 1])
        if lo == hi:
            continue
        idx = grouping.perm[lo:hi]
        f, w = fields[idx], words[idx]
        best_len = torch.zeros(hi - lo, dtype=torch.int64, device=fields.device)
        best_row = torch.zeros(hi - lo, dtype=torch.int64, device=fields.device)
        for c0 in range(0, S, CHUNK):
            g = (p * S + c0 + torch.arange(min(CHUNK, S - c0), device=fields.device)).clamp(
                max=N - 1)
            v = chunk_best(chunk_operands(arena.key_words[g], arena.mask_words[g],
                                          arena.mask_len[g]), f, w).to(torch.int64)
            length = torch.where(v > 0, v >> TIE_BITS, 0)
            take = length > best_len
            best_len = torch.where(take, length, best_len)
            best_row = torch.where(take, c0 + CHUNK - 1 - (v & (CHUNK - 1)), best_row)
        win = (p * S + best_row).clamp(max=N - 1)
        rows = torch.where((best_len > 0)[:, None], arena.rules[win], 0)
        result = rule_scan(rows.reshape(rows.shape[0], -1, 5), batch_from_fields(f, w))
        out[idx, 0] = result
        out[idx, 1] = best_len.to(torch.int32)
    return out


def wire_formulation(arena, wire: torch.Tensor, tenant: torch.Tensor, *,
                     pages: int) -> torch.Tensor:
    """The fused entry's read-back buffer computed the way the kernel
    computes it: the lanes finalize zeroes go to "none", the rest through
    ``formulation``, then finalize and fuse_wire_outputs."""
    batch = unpack_wire(wire)
    fields, words = packet_fields(batch)
    keep = looked_up_results(torch.ones_like(batch.kind), batch) != 0
    raw = formulation(fields, words, tenant.to(torch.int32), arena, pages=pages, keep=keep)
    res, _xdp, stats = finalize(raw[:, 0], batch)
    return fuse_wire_outputs(res & 0xFFFF, stats)


# -- the overlay side-pool ----------------------------------------------------


def main_result_and_score(main, fields: torch.Tensor, words: torch.Tensor,
                          tenant: torch.Tensor, *, pages: int, d_max: int):
    """The main side of the arena overlay combine: (raw result, score).  A
    CtrieArena through K3b's two-column entry, whose second column is the
    joined position - 1: the joined row's mask length + 1 when its tidx + 1
    halves are non-zero, else 0 (jaxpath.arena_ctrie_result_and_score); a
    DenseArena through K6's."""
    if hasattr(main, "mask_len"):
        out = arena_dense_classify(fields, words, tenant, main, pages=pages)
        return out[:, 0], out[:, 1]
    out = arena_walk.arena_ctrie_walk_classify(fields, words, tenant, main, pages=pages,
                                               d_max=d_max)
    return out[:, 0], joined_score(main.joined, out[:, 1])


def classify_arena_with_overlay(main, overlay, batch: DeviceBatch, tenant: torch.Tensor, *,
                                pages: int, ov_pages: int, d_max: int = 0
                                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Arena classify with the per-tenant dense overlay side-pool
    (jaxpath.classify_arena_with_overlay): both sides tenant-steered, the
    overlay's result where its score is strictly greater, then finalize."""
    fields, words = packet_fields(batch)
    tenant = tenant.to(torch.int32).contiguous()
    raw_m, score_m = main_result_and_score(main, fields, words, tenant, pages=pages, d_max=d_max)
    ov = arena_dense_classify(fields, words, tenant, overlay, pages=ov_pages)
    return finalize(torch.where(ov[:, 1] > score_m, ov[:, 0], raw_m), batch)


def classify_arena_overlay_wire(main, overlay, wire: torch.Tensor, tenant: torch.Tensor, *,
                                pages: int, ov_pages: int, d_max: int = 0) -> torch.Tensor:
    """Packed wire + tenant column in, the one read-back buffer out, with
    the overlay side-pool (jaxpath.jitted_classify_arena_wire_fused with
    ``ov_pages``)."""
    res, _xdp, stats = classify_arena_with_overlay(main, overlay, unpack_wire(wire), tenant,
                                                   pages=pages, ov_pages=ov_pages, d_max=d_max)
    return fuse_wire_outputs(res & 0xFFFF, stats)
