"""The multi-tenant arena's paged ctrie walk: kernel K3b and its plain
version.

Counterpart of the JAX package's arena classify (``jaxpath._arena_pages``,
``_arena_ctrie_entry``, ``arena_ctrie_rows``, ``classify_arena_ctrie``,
``jitted_classify_arena_wire_fused`` for the ctrie family without an
overlay) and of its fused Pallas paged walk (``pallas_walk.
classify_arena_cwalk``).  Each packet carries a tenant id; the device page
table steers it to its tenant's slab of the pooled ctrie layout
(arena.CtrieArena, page-global indices), and from the slab's DIR-16 slot on
the walk is the ctrie path's.

- ``arena_ctrie_walk_classify``: the wrapper of the hand-written CUDA kernel
  ``csrc/arena_ctrie_walk.cu``.  On a CUDA tensor it launches the kernel or
  raises; on a CPU tensor it runs ``arena_ctrie_walk_classify_plain``;
- ``arena_ctrie_walk_classify_plain``: the same function in plain PyTorch
  (the tenant-steered entry, torchpath.ctrie_descend, the target resolve,
  the joined-row gather, rule_scan), chunked over packets;
- ``classify_arena_wire_fused``: the whole device pass of a mixed-tenant
  classify, wire and tenant column in, the one read-back buffer out; on a
  CUDA tensor one memset and one launch of K3b's fused entry
  (``infw_arena_wire_fused``, counted by ``FUSED_KERNEL``), else
  ``classify_arena_wire_fused_plain``, the same function composed of the
  plain K3b and the torch ops of kernels/torchpath.py;
- ``classify_arena_ctrie``: the forward pass of a decoded batch through
  K3b (verdict, statistics).

Only unspliced arenas: a spliced pool is not served (arena.SPLICE_ITEM).
As on the ctrie path, the rule scan reports action and ruleId as stored.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..constants import MAX_TARGETS
from . import _build
from .cwalk import NODE_WORDS, WIRE_WIDTHS, check_wire
from .torchpath import (
    STATS_COLS,
    DeviceBatch,
    _u32,
    batch_from_fields,
    ctrie_descend,
    finalize,
    fuse_wire_outputs,
    joined_rule_rows,
    packet_fields,
    rule_scan,
    unpack_wire,
)

#: packets per step of the plain version, which bounds its temporaries
PLAIN_CHUNK = 1 << 16

KERNEL = _build.Kernel(
    "arena_ctrie_walk",
    "infw_arena_ctrie_walk",
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 11 + [ctypes.c_void_p],
)
#: K3b's fused wire-to-verdict entry, built from the same source
FUSED_KERNEL = _build.Kernel(
    "arena_wire_fused",
    "infw_arena_wire_fused",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 13 + [ctypes.c_void_p],
    source="arena_ctrie_walk",
)


def arena_pages(page_table, tenant: torch.Tensor) -> torch.Tensor:
    """(B,) int64 page per packet from the page table; -1 for tenant ids
    outside it and for absent tenants (jaxpath._arena_pages)."""
    mt = page_table.shape[0]
    t = tenant.to(torch.int64)
    t_ok = (t >= 0) & (t < mt)
    pg = page_table[t.clamp(0, mt - 1)].to(torch.int64)
    return torch.where(t_ok, pg, -1)


def arena_ctrie_entry(arena, batch: DeviceBatch, tenant: torch.Tensor, pages: int):
    """Tenant-steered entry (jaxpath._arena_ctrie_entry, unspliced): tenant
    -> page -> the page's root LUT row (an ifindex outside the slab's LUT:
    the page's own null root) -> the DIR-16 slot.  Returns (node, alive,
    best0) in pool-global terms, int64; an invalid tenant's lane is dead
    with best0 0."""
    n_lut = arena.root_lut.shape[0]
    SL = n_lut // pages
    R0 = arena.l0.shape[0] // (pages * 65536)
    pg = arena_pages(arena.page_table, tenant)
    valid = pg >= 0
    pg0 = pg.clamp(min=0)
    ifx = batch.ifindex.to(torch.int64)
    if_ok = (ifx >= 0) & (ifx < SL)
    lidx = (pg0 * SL + ifx.clamp(0, SL - 1)).clamp(0, n_lut - 1)
    root = torch.where(if_ok, arena.root_lut[lidx].to(torch.int64), pg0 * R0)
    e0 = root * 65536 + (_u32(batch.ip_words[:, 0]) >> 16)
    n0 = arena.l0.shape[0]
    in0 = valid & (e0 >= 0) & (e0 < n0)
    rows0 = arena.l0[e0.clamp(0, n0 - 1)].to(torch.int64)
    best0 = torch.where(in0 & (rows0[:, 1] > 0), rows0[:, 1], 0)
    alive = in0 & (rows0[:, 0] > 0)
    node = torch.where(alive, rows0[:, 0] - 1, 0)
    return node, alive, best0


def arena_ctrie_walk_rows(arena, batch: DeviceBatch, tenant: torch.Tensor, pages: int,
                          d_max: int):
    """The paged walk (jaxpath.arena_ctrie_rows): entry, ctrie_descend over
    the node pool, the target resolve (the walk's target, else the root
    slot's), the joined-row gather.  Returns ((B, 3 + 5R) int16 joined rows,
    zero for packets without a match; (B,) int64 joined position, 0 =
    none)."""
    node, alive, best0 = arena_ctrie_entry(arena, batch, tenant, pages)
    win = ctrie_descend(arena.nodes, batch, node, alive, d_max)
    n_t = arena.targets.shape[0]
    in_w = (win >= 0) & (win < n_t)
    tval = torch.where(in_w, arena.targets[win.clamp(0, n_t - 1)].to(torch.int64), 0)
    sel = torch.where(tval > 0, tval, best0)
    P = arena.joined.shape[0]
    in_j = (sel > 0) & (sel < P)
    rows = torch.where(in_j[:, None], arena.joined[sel.clamp(0, P - 1)], 0)
    return rows, sel


def arena_ctrie_walk_classify_plain(fields: torch.Tensor, words: torch.Tensor,
                                    tenant: torch.Tensor, arena, *, pages: int,
                                    d_max: int) -> torch.Tensor:
    """K3b's function in plain PyTorch: (B, 8) fields + (B, 4) words + (B,)
    tenant -> (B, 2) int32 [result, joined position - 1]."""
    out = torch.empty((fields.shape[0], 2), dtype=torch.int32, device=fields.device)
    for s in range(0, fields.shape[0], PLAIN_CHUNK):
        e = s + PLAIN_CHUNK
        batch = batch_from_fields(fields[s:e], words[s:e])
        rows, sel = arena_ctrie_walk_rows(arena, batch, tenant[s:e], pages, d_max)
        out[s:e, 0] = rule_scan(joined_rule_rows(rows), batch)
        out[s:e, 1] = (sel - 1).to(torch.int32)
    return out


def _check_pool(arena, pages: int, d_max: int, device: torch.device, who: str) -> None:
    W = arena.joined.shape[-1] if arena.joined.dim() == 2 else 0
    if (
        pages < 1 or d_max < 0
        or arena.l0.dim() != 2 or arena.l0.shape[1] != 2 or arena.l0.shape[0] % (pages * 65536)
        or arena.l0.shape[0] == 0
        or arena.root_lut.dim() != 1 or arena.root_lut.shape[0] % pages or arena.root_lut.shape[0] == 0
        or arena.nodes.dim() != 2 or arena.nodes.shape[1] != NODE_WORDS
        or W < 3 or (W - 3) % 5
        or arena.targets.dim() != 1 or arena.page_table.dim() != 1
        or arena.page_table.shape[0] == 0
    ):
        raise ValueError(f"{who}: operands are not a CtrieArena layout")
    for t in (arena.page_table, arena.root_lut, arena.l0, arena.nodes, arena.targets,
              arena.joined):
        want = torch.int16 if t is arena.joined else torch.int32
        if t.device != device or t.dtype != want:
            raise ValueError(f"{who}: operands must be on one device, int32 (joined int16)")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{who}: operands must be contiguous and 16-byte aligned")


def _pool_args(arena, pages: int, d_max: int) -> tuple:
    """The pool operands of K3b's C entry points: the six pointers, then
    MT, SL, R0, the row counts, R and d_max."""
    return (
        (arena.page_table.data_ptr(), arena.root_lut.data_ptr(), arena.l0.data_ptr(),
         arena.nodes.data_ptr(), arena.targets.data_ptr(), arena.joined.data_ptr()),
        (arena.page_table.shape[0], arena.root_lut.shape[0] // pages,
         arena.l0.shape[0] // (pages * 65536), arena.root_lut.shape[0], arena.l0.shape[0],
         arena.nodes.shape[0], arena.targets.shape[0], arena.joined.shape[0],
         (arena.joined.shape[1] - 3) // 5, d_max),
    )


def _check_operands(fields, words, tenant, arena, pages: int, d_max: int) -> None:
    B = fields.shape[0]
    if fields.shape != (B, 8) or words.shape != (B, 4) or tenant.shape != (B,):
        raise ValueError(
            f"arena_ctrie_walk_classify: fields {tuple(fields.shape)} / words "
            f"{tuple(words.shape)} / tenant {tuple(tenant.shape)}, expected (B, 8) / (B, 4) / (B,)"
        )
    _check_pool(arena, pages, d_max, fields.device, "arena_ctrie_walk_classify")
    for t in (fields, words, tenant):
        if t.device != fields.device or t.dtype != torch.int32:
            raise ValueError("arena_ctrie_walk_classify: operands must be on one device, "
                             "int32 (joined int16)")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("arena_ctrie_walk_classify: operands must be contiguous and "
                             "16-byte aligned")


def kernel_args(fields: torch.Tensor, words: torch.Tensor, tenant: torch.Tensor, arena, *,
                pages: int, d_max: int):
    """K3b's operand checks for CUDA tensors: (out, the C entry point's
    arguments before the stream), ``out`` a new (B, 2) int32 tensor the
    kernel fills."""
    _check_operands(fields, words, tenant, arena, pages, d_max)
    B = fields.shape[0]
    out = torch.empty((B, 2), dtype=torch.int32, device=fields.device)
    ptrs, dims = _pool_args(arena, pages, d_max)
    return out, (fields.data_ptr(), words.data_ptr(), tenant.data_ptr(), *ptrs, out.data_ptr(),
                 B, *dims)


def arena_ctrie_walk_classify(fields: torch.Tensor, words: torch.Tensor, tenant: torch.Tensor,
                              arena, *, pages: int, d_max: int) -> torch.Tensor:
    """Kernel K3b: (B, 8) int32 fields + (B, 4) int32 words + (B,) int32
    tenant over a CtrieArena of ``pages`` slabs -> (B, 2) int32 [result,
    joined position - 1].  A CPU tensor runs the plain version; a CUDA
    tensor launches the CUDA kernel (building it on first use) or raises."""
    if fields.device.type == "cpu":
        return arena_ctrie_walk_classify_plain(fields, words, tenant, arena, pages=pages,
                                               d_max=d_max)
    if fields.device.type != "cuda":
        raise ValueError(f"arena_ctrie_walk_classify: unsupported device {fields.device}")
    out, args = kernel_args(fields, words, tenant, arena, pages=pages, d_max=d_max)
    with torch.cuda.device(fields.device):
        KERNEL.launch(*args, torch.cuda.current_stream().cuda_stream)
    return out


def classify_arena_ctrie(arena, batch: DeviceBatch, tenant: torch.Tensor, *, pages: int,
                         d_max: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full mixed-tenant forward pass through K3b: (results int32, xdp
    int32, stats (MAX_TARGETS, 6) int32), as jaxpath.classify_arena_ctrie."""
    fields, words = packet_fields(batch)
    tenant = tenant.to(torch.int32).contiguous()
    raw = arena_ctrie_walk_classify(fields, words, tenant, arena, pages=pages, d_max=d_max)
    return finalize(raw[:, 0], batch)


def classify_arena_wire_fused_plain(arena, wire: torch.Tensor, tenant: torch.Tensor, *,
                                    pages: int, d_max: int) -> torch.Tensor:
    """The fused entry's function in plain PyTorch: unpack_wire, the plain
    K3b, finalize and fuse_wire_outputs."""
    batch = unpack_wire(wire)
    fields, words = packet_fields(batch)
    raw = arena_ctrie_walk_classify_plain(fields, words, tenant.to(torch.int32), arena,
                                          pages=pages, d_max=d_max)
    res, _xdp, stats = finalize(raw[:, 0], batch)
    return fuse_wire_outputs(res & 0xFFFF, stats)


def fused_args(arena, wire: torch.Tensor, tenant: torch.Tensor, *, pages: int, d_max: int):
    """The fused entry's operand checks for CUDA tensors: (out, the C entry
    point's arguments before the grid cap and the stream), ``out`` a new
    int32 buffer of ceil(B/2) result words, then MAX_TARGETS * 6
    statistics words."""
    who = "classify_arena_wire_fused"
    check_wire(wire, WIRE_WIDTHS, who)
    B = wire.shape[0]
    if (tenant.shape != (B,) or tenant.dtype != torch.int32 or tenant.device != wire.device
            or not tenant.is_contiguous()):
        raise ValueError(f"{who}: tenant {tuple(tenant.shape)} {tenant.dtype}, expected a "
                         f"contiguous ({B},) int32 tensor on the wire's device")
    _check_pool(arena, pages, d_max, wire.device, who)
    out = torch.empty((B + 1) // 2 + MAX_TARGETS * STATS_COLS, dtype=torch.int32,
                      device=wire.device)
    ptrs, dims = _pool_args(arena, pages, d_max)
    return out, (wire.data_ptr(), tenant.data_ptr(), *ptrs, out.data_ptr(), B, wire.shape[1],
                 *dims)


def classify_arena_wire_fused(arena, wire: torch.Tensor, tenant: torch.Tensor, *, pages: int,
                              d_max: int, _grid: int = 0) -> torch.Tensor:
    """Packed wire (B, 3|4|6|7) int32 + (B,) int32 tenant in, ONE int32
    buffer out: ceil(B/2) words of u16-pair-packed results, then the
    (MAX_TARGETS, 6) stats (jaxpath.jitted_classify_arena_wire_fused, ctrie
    family, no overlay).  A CPU tensor runs the plain version; a CUDA
    tensor is one memset and one launch of K3b's fused entry (building it
    on first use), or raises.  ``_grid`` > 0 caps the kernel's grid
    (tests)."""
    if wire.device.type == "cpu":
        return classify_arena_wire_fused_plain(arena, wire, tenant, pages=pages, d_max=d_max)
    if wire.device.type != "cuda":
        raise ValueError(f"classify_arena_wire_fused: unsupported device {wire.device}")
    out, args = fused_args(arena, wire, tenant, pages=pages, d_max=d_max)
    with torch.cuda.device(wire.device):
        FUSED_KERNEL.launch(*args, _grid, torch.cuda.current_stream().cuda_stream)
    return out
