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
  winning row, 0 = none].  On a CUDA tensor it launches the kernel or
  raises; on a CPU tensor it runs ``arena_dense_classify_plain``;
- ``arena_dense_classify_plain``: the same function in plain PyTorch (the
  (b, S, 5) gather-compare, the first maximum, the row's rule_scan),
  chunked so a step holds at most ``PLAIN_ROWS`` packet-row pairs;
- ``classify_arena_dense_wire_fused``: the whole device pass of a
  mixed-tenant classify, wire and tenant column in, the one read-back
  buffer out; on a CUDA tensor one memset and one launch of K6's fused
  entry (``FUSED_KERNEL``), else ``classify_arena_dense_wire_fused_plain``;
- ``classify_arena_overlay_wire``: the arena with a dense overlay
  side-pool (``classify_arena_with_overlay``): the main side on K3b's
  two-column entry (a ctrie pool, the score the joined row's mask length
  + 1) or K6's (a dense pool), the overlay side on K6's two-column entry,
  the overlay's result where its score is strictly greater, then
  finalize and fuse_wire_outputs.

As on the ctrie path, the rule scan reports action and ruleId as stored.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

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
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
)
#: K6's fused wire-to-verdict entry, built from the same source
FUSED_KERNEL = _build.Kernel(
    "arena_dense_fused",
    "infw_arena_dense_fused",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    source="arena_dense",
)


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


def _pool_args(arena, pages: int) -> tuple:
    """The pool operands of K6's C entry points: the five pointers, then
    MT, S, the pool's rows and R."""
    N = arena.mask_len.shape[0]
    return (
        (arena.page_table.data_ptr(), arena.key_words.data_ptr(), arena.mask_words.data_ptr(),
         arena.mask_len.data_ptr(), arena.rules.data_ptr()),
        (arena.page_table.shape[0], N // pages, N, arena.rules.shape[1] // 5),
    )


def kernel_args(fields: torch.Tensor, words: torch.Tensor, tenant: torch.Tensor, arena, *,
                pages: int):
    """K6's operand checks for CUDA tensors: (out, the two-column entry's
    arguments before the stream), ``out`` a new (B, 2) int32 tensor."""
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
    ptrs, dims = _pool_args(arena, pages)
    return out, (fields.data_ptr(), words.data_ptr(), tenant.data_ptr(), *ptrs, out.data_ptr(),
                 B, *dims)


def arena_dense_classify(fields: torch.Tensor, words: torch.Tensor, tenant: torch.Tensor,
                         arena, *, pages: int) -> torch.Tensor:
    """Kernel K6 (two-column entry): (B, 8) int32 fields + (B, 4) int32
    words + (B,) int32 tenant over a DenseArena of ``pages`` slabs -> (B,
    2) int32 [result, score].  A CPU tensor runs the plain version; a CUDA
    tensor launches the CUDA kernel (building it on first use) or
    raises."""
    if fields.device.type == "cpu":
        return arena_dense_classify_plain(fields, words, tenant, arena, pages=pages)
    if fields.device.type != "cuda":
        raise ValueError(f"arena_dense_classify: unsupported device {fields.device}")
    out, args = kernel_args(fields, words, tenant, arena, pages=pages)
    with torch.cuda.device(fields.device):
        KERNEL.launch(*args, torch.cuda.current_stream().cuda_stream)
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
    """The fused entry's operand checks for CUDA tensors: (out, the C entry
    point's arguments before the grid cap and the stream), ``out`` a new
    int32 buffer of ceil(B/2) result words, then MAX_TARGETS * 6
    statistics words."""
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
    ptrs, dims = _pool_args(arena, pages)
    MT, S, N, R = dims
    return out, (wire.data_ptr(), tenant.data_ptr(), *ptrs, out.data_ptr(), B, wire.shape[1],
                 MT, S, N, R)


def classify_arena_dense_wire_fused(arena, wire: torch.Tensor, tenant: torch.Tensor, *,
                                    pages: int, _grid: int = 0) -> torch.Tensor:
    """Packed wire (B, 3|4|6|7) int32 + (B,) int32 tenant in, ONE int32
    buffer out: ceil(B/2) words of u16-pair-packed results, then the
    (MAX_TARGETS, 6) stats (jaxpath.jitted_classify_arena_wire_fused,
    dense family, no overlay).  A CPU tensor runs the plain version; a
    CUDA tensor is one memset and one launch of K6's fused entry (building
    it on first use), or raises.  ``_grid`` > 0 caps the kernel's grid
    (tests)."""
    if wire.device.type == "cpu":
        return classify_arena_dense_wire_fused_plain(arena, wire, tenant, pages=pages)
    if wire.device.type != "cuda":
        raise ValueError(f"classify_arena_dense_wire_fused: unsupported device {wire.device}")
    out, args = fused_args(arena, wire, tenant, pages=pages)
    with torch.cuda.device(wire.device):
        FUSED_KERNEL.launch(*args, _grid, torch.cuda.current_stream().cuda_stream)
    return out


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
