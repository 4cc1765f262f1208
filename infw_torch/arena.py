"""Multi-tenant paged arena of both families: geometry, slab baking, the
device pools and their host allocator.

Counterpart of the arena half of the JAX package's ``kernels/jaxpath.py``
(``ArenaSpec`` through ``ArenaAllocator``).  Thousands of tenant rulesets
live in ONE device pool of ``pages`` fixed-geometry slabs; a device page
table maps each tenant to its slab, and the paged classify (kernel K3b,
``kernels/arena_walk.py``, for the ctrie family; kernel K6,
``kernels/arena_dense.py``, for the dense family) steers each packet of a
mixed-tenant batch through it.  Activating or hot-swapping a tenant is a
one-element write of the page table.

- ``ArenaSpec`` / ``make_arena_spec`` / ``arena_spec_for``: the geometry,
  with the JAX package's bucketing, validation and error texts (splice
  fields included, so specs compare equal to the JAX package's as tuples);
- ``_dense_slab_arrays``, ``_ctrie_canonical_slab`` / ``_offset_ctrie_slab``
  / ``_unoffset_ctrie_slab`` / ``_ctrie_slab_arrays`` / ``slab_content_hash``:
  the host slab bake, byte-identical to jaxpath's;
- ``DenseArena`` / ``CtrieArena``: the pool tensors on one device;
- ``ArenaAllocator``: pages, content-addressed sharing with refcounts and
  copy-on-write, rules-only patches (a hinted edit of a private slab
  writes its dirty rows; of a shared slab, the clone-then-patch "cow"),
  stage / activate / release, destroy, compaction and the dedup sweep.
  Every device write is an in-place copy into the resident pool tensors
  (a whole slab is one contiguous row range per array, a patch one staged
  copy plus ``index_copy_`` at the dirty rows, a flip one element of
  ``page_table``), issued on the device's current stream after the host
  mirror is updated, under the allocator's lock.  A classify enqueued
  before a write runs on the pool as it stood; the slab write of a new
  page is issued before the flip that makes it reachable.

Spliced geometries are not served (NotImplementedError naming
``SPLICE_ITEM``).  The JAX package's Pallas byte planes, their refresh
hooks and its warmed scatter executables have no counterpart: K3b reads
the uint32 node pool in place.
"""
from __future__ import annotations

import contextlib
import hashlib
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from .compiler import CompiledTables
from .kernels.torchpath import resolve_device
from .kernels.walk import write_rows
from .layout import (
    build_cpoptrie,
    hint_dense_rows,
    hint_trie_unchanged,
    joined_by_tidx,
    joined_tidx_patch_rows,
    packed_rules_flat,
    pad_rows,
    seed_caches_forward,
)

#: where the spliced arena, which the port does not serve, is queued
SPLICE_ITEM = "ROADMAP.md item 21 (spliced arenas)"

#: the splice-tag value of a spliced l0 slot (jaxpath.SPLICE_TAG), which
#: bounds the splice geometry make_arena_spec accepts
SPLICE_TAG = np.int32(1 << 30)


class ArenaCapacityError(ValueError):
    """A tenant table does not fit the arena's slab geometry (entries,
    node rows, trie depth, rule width, lut span) or the pool is out of
    free pages.  Callers either re-size the arena (a new pool) or refuse
    the tenant — never silently truncate."""


def _row_bucket(n: int) -> int:
    """Small row counts round to the next power of two (at least 8), large
    ones to 4096-row chunks (jaxpath._row_bucket)."""
    if n <= 0:
        return 8
    if n <= 4096:
        return max(8, 1 << (n - 1).bit_length())
    return -(-n // 4096) * 4096


class ArenaSpec(NamedTuple):
    """Geometry of one paged arena.  All row counts are PER SLAB; device
    pools are ``pages`` slabs, flat along rows.  Constructed via
    make_arena_spec (which buckets and validates)."""

    family: str        # "dense" | "ctrie"
    pages: int
    max_tenants: int
    entries: int       # entry capacity per slab (T)
    rule_slots: int    # packed rules per entry (row width = rule_slots*5)
    lut_rows: int      # root_lut rows per slab (max ifindex + 1 bound)
    root_nodes: int    # DIR-16 root nodes per slab (R0)
    node_rows: int     # merged skip-node rows per slab (SN)
    target_rows: int   # flat target rows per slab (ST)
    d_max: int         # descent bound (pool-wide)
    # subtree-splice geometry: zero everywhere for a plain arena, the only
    # kind this port serves
    plane_slots: int = 0
    plane_node_rows: int = 0
    plane_target_rows: int = 0
    plane_joined_rows: int = 0
    splice_slots: int = 0

    @property
    def joined_rows(self) -> int:
        """Per-slab joined rows: tidx+1 indexing plus the slab's own zero
        sentinel row."""
        return self.entries + 1

    @property
    def l0_rows(self) -> int:
        return self.root_nodes * 65536

    @property
    def spliced(self) -> bool:
        return self.plane_slots > 0 and self.splice_slots > 0

    @property
    def splice_rows(self) -> int:
        """Device splice-table rows: the 1-row placeholder of a plain arena,
        else two banks of max_tenants * splice_slots."""
        if not self.spliced:
            return 1
        return 2 * self.max_tenants * self.splice_slots


def make_arena_spec(
    family: str,
    pages: int,
    max_tenants: int,
    entries: int,
    rule_slots: int,
    lut_rows: int = 8,
    root_nodes: int = 1,
    node_rows: int = 128,
    target_rows: int = 64,
    d_max: int = 6,
    plane_slots: int = 0,
    plane_node_rows: int = 0,
    plane_target_rows: int = 0,
    plane_joined_rows: int = 0,
    splice_slots: int = 0,
) -> ArenaSpec:
    """Normalize and validate an arena geometry as jaxpath.make_arena_spec
    does: row counts bucket (node rows to 128-row tiles), at least 4 pages,
    the DIR-16 pool within int32 indexing, all-or-nothing splice geometry
    (ctrie only).  The same ValueError texts."""
    if family not in ("dense", "ctrie"):
        raise ValueError(f"unknown arena family {family!r}")
    if pages < 4:
        raise ValueError(
            f"arena needs >= 4 pages (full-slab writes ride the capped "
            f"scatter budget of pool/4 rows); got {pages}"
        )
    if max_tenants < 1 or entries < 1 or rule_slots < 1:
        raise ValueError("max_tenants, entries and rule_slots must be >= 1")
    entries = _row_bucket(entries)
    lut_rows = _row_bucket(lut_rows)
    target_rows = _row_bucket(target_rows)
    node_rows = -(-max(node_rows, 128) // 128) * 128
    if family == "ctrie" and pages * root_nodes * 65536 > np.iinfo(np.int32).max:
        raise ValueError(
            f"arena l0 pool {pages}x{root_nodes} root nodes exceeds int32 "
            "DIR-16 indexing"
        )
    splicey = (plane_slots, plane_node_rows, plane_target_rows,
               plane_joined_rows, splice_slots)
    if any(v < 0 for v in splicey):
        raise ValueError("splice geometry fields must be >= 0")
    if any(splicey):
        if family != "ctrie":
            raise ValueError("subtree-splice compression is ctrie-only")
        if not all(splicey):
            raise ValueError(
                "splice geometry is all-or-nothing: plane_slots, "
                "plane_node_rows, plane_target_rows, plane_joined_rows "
                "and splice_slots must all be > 0"
            )
        r8 = lambda x: -(-int(x) // 8) * 8
        plane_node_rows = r8(plane_node_rows)
        plane_target_rows = r8(plane_target_rows)
        plane_joined_rows = r8(plane_joined_rows)
        total_nodes = pages * node_rows + plane_slots * plane_node_rows
        if total_nodes + 1 >= int(SPLICE_TAG):
            raise ValueError(
                f"node pool {total_nodes} rows collides with the splice "
                f"tag space (< {int(SPLICE_TAG)})"
            )
        if splice_slots >= int(SPLICE_TAG):
            raise ValueError("splice_slots exceeds the splice tag space")
    return ArenaSpec(
        family=family, pages=pages, max_tenants=max_tenants,
        entries=entries, rule_slots=rule_slots, lut_rows=lut_rows,
        root_nodes=root_nodes, node_rows=node_rows,
        target_rows=target_rows, d_max=d_max,
        plane_slots=plane_slots, plane_node_rows=plane_node_rows,
        plane_target_rows=plane_target_rows,
        plane_joined_rows=plane_joined_rows, splice_slots=splice_slots,
    )


def arena_spec_for(family: str, tables_iter, pages: int, max_tenants: int,
                   headroom: float = 1.0, d_max: Optional[int] = None,
                   **splice_kwargs) -> ArenaSpec:
    """Size an ArenaSpec from sample tenant tables: per-family maxima over
    the samples, scaled by ``headroom``, then make_arena_spec.  The samples
    must be u16-packable (the arena's resident rule layout)."""
    ent = rs = lut = r0 = nn = tt = dm = 1
    for t in tables_iter:
        rules = packed_rules_flat(t)
        if rules.dtype != np.uint16:
            raise ArenaCapacityError(
                "arena slabs hold u16-packed rules; a sample table has "
                "wide int32 values"
            )
        ent = max(ent, t.rules.shape[0])
        rs = max(rs, rules.shape[1] // 5)
        lut = max(lut, np.asarray(t.root_lut).shape[0])
        if family == "ctrie":
            l0, nodes, targets, d = build_cpoptrie(t)
            r0 = max(r0, l0.shape[0] // 65536)
            nn = max(nn, nodes.shape[0])
            tt = max(tt, targets.shape[0])
            dm = max(dm, d)
    h = lambda x: int(-(-x * headroom // 1))
    return make_arena_spec(
        family, pages, max_tenants,
        entries=h(ent), rule_slots=rs, lut_rows=h(lut), root_nodes=r0,
        node_rows=h(nn), target_rows=h(tt),
        d_max=d_max if d_max is not None else dm,
        **splice_kwargs,
    )


class DenseArena(NamedTuple):
    """Dense-family device pool: ``pages`` compare-all slabs of S =
    ``entries`` rows, flat along rows, plus the tenant -> page table.
    Unassigned rows carry the mask_len == -1 sentinel (inert as a single
    table's padding rows).  uint32 and uint16 columns travel as int32 and
    int16 bit patterns."""

    key_words: torch.Tensor   # (P*S, 5) int32 [ifindex, ip words 0-3]
    mask_words: torch.Tensor  # (P*S, 5) int32
    mask_len: torch.Tensor    # (P*S,) int32, -1 = padding
    rules: torch.Tensor       # (P*S, R*5) int16 (uint16 packed rule rows)
    page_table: torch.Tensor  # (max_tenants,) int32, -1 = absent


class CtrieArena(NamedTuple):
    """Ctrie-family device pool: per-slab compressed-poptrie layouts with
    PAGE-GLOBAL indices baked at slab-write time (node ids, target
    positions, joined positions, root ids), so the descent and the tail
    gathers run on the flat pools untouched.  Pool row 0 of ``targets`` and
    ``joined`` is page 0's zero sentinel and doubles as the global one.
    uint32 and uint16 columns travel as int32 and int16 bit patterns."""

    l0: torch.Tensor          # (P*R0*65536, 2) int32
    nodes: torch.Tensor       # (P*SN, 20) int32 (uint32 bit patterns)
    targets: torch.Tensor     # (P*ST,) int32 global joined positions
    joined: torch.Tensor      # (P*(S+1), 3+R*5) int16 (uint16 bit patterns)
    root_lut: torch.Tensor    # (P*SL,) int32 global root ids
    splice: torch.Tensor      # (1,) int32 placeholder (no splicing)
    page_table: torch.Tensor  # (max_tenants,) int32, -1 = absent


#: the device dtype each host mirror dtype travels as
_DEV_DTYPE = {np.dtype(np.int32): np.int32, np.dtype(np.uint32): np.int32,
              np.dtype(np.uint16): np.int16}


def _dev_view(a: np.ndarray) -> torch.Tensor:
    """A contiguous host array as a CPU tensor of its device dtype (a view)."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(_DEV_DTYPE[a.dtype]))


# -- slab baking (host) ------------------------------------------------------


def _dense_host_layout(tables: CompiledTables):
    """(key_words, mask_words, mask_len, rules) of one table, unpadded, in
    the dense device layout (jaxpath._host_device_layout(pad=False,
    with_trie=False)): the mask_len sentinel -1 past ``num_entries``, the
    flat packed rules (uint16 where they pack)."""
    mask_len = tables.mask_len.copy()
    mask_len[tables.num_entries:] = -1
    return (tables.key_words.astype(np.uint32, copy=False),
            tables.mask_words.astype(np.uint32, copy=False),
            mask_len, packed_rules_flat(tables))


def _dense_fits(spec: ArenaSpec, layout) -> bool:
    kw, _mw, _ml, rules = layout
    return (rules.dtype == np.uint16 and rules.shape[1] == spec.rule_slots * 5
            and kw.shape[0] <= spec.entries)


def _dense_slab_arrays(spec: ArenaSpec, tables: CompiledTables):
    """Full-slab host arrays for the dense family (page-independent: a
    dense slab holds no cross-row index).  Raises ArenaCapacityError when
    the table exceeds the slab geometry."""
    kw, mw, ml, rules = _dense_host_layout(tables)
    S = spec.entries
    if kw.shape[0] > S:
        raise ArenaCapacityError(
            f"tenant has {kw.shape[0]} entries > slab capacity {S}"
        )
    if rules.dtype != np.uint16:
        raise ArenaCapacityError("arena slabs hold u16-packed rules")
    if rules.shape[1] != spec.rule_slots * 5:
        raise ArenaCapacityError(
            f"rule row width {rules.shape[1]} != slab width "
            f"{spec.rule_slots * 5} (compile tenants with rule_width="
            f"{spec.rule_slots})"
        )
    return pad_rows(kw, S), pad_rows(mw, S), pad_rows(ml, S, fill=-1), pad_rows(rules, S)


def _ctrie_host_layout(tables: CompiledTables):
    """((l0, nodes, targets, joined, root_lut), d_max): the unpadded ctrie
    layout, or None for tables whose rules the uint16 joined rows cannot
    hold."""
    joined = joined_by_tidx(tables)
    if joined is None:
        return None
    l0, nodes, targets, d_max = build_cpoptrie(tables)
    return (l0, nodes, targets, joined, np.asarray(tables.root_lut, np.int32)), d_max


def _ctrie_canonical_slab(spec: ArenaSpec, tables: CompiledTables):
    """Page-independent ("canonical") full-slab host arrays: slab-local
    indices, zero padding — the form the content hash is computed over.
    Returns (arrays, n_nodes), ``n_nodes`` the real skip-node row count
    (node-row offsets apply to real rows only).  Raises ArenaCapacityError
    when a per-slab bound is exceeded."""
    host = _ctrie_host_layout(tables)
    if host is None:
        raise ArenaCapacityError(
            "tenant table is not ctrie-eligible (wide int32 rules)"
        )
    (l0, nodes, targets, joined, root_lut), d_max = host
    if d_max > spec.d_max:
        raise ArenaCapacityError(
            f"tenant trie depth d_max={d_max} > arena unroll bound "
            f"{spec.d_max}"
        )
    n0 = l0.shape[0] // 65536
    if n0 > spec.root_nodes:
        raise ArenaCapacityError(
            f"{n0} root nodes > slab bound {spec.root_nodes}"
        )
    if nodes.shape[0] > spec.node_rows:
        raise ArenaCapacityError(
            f"{nodes.shape[0]} skip nodes > slab bound {spec.node_rows}"
        )
    if targets.shape[0] > spec.target_rows:
        raise ArenaCapacityError(
            f"{targets.shape[0]} targets > slab bound {spec.target_rows}"
        )
    if joined.shape[0] > spec.joined_rows:
        raise ArenaCapacityError(
            f"{joined.shape[0]} joined rows > slab bound "
            f"{spec.joined_rows}"
        )
    if joined.shape[1] != 3 + spec.rule_slots * 5:
        raise ArenaCapacityError(
            f"joined row width {joined.shape[1]} != slab width "
            f"{3 + spec.rule_slots * 5}"
        )
    if root_lut.shape[0] > spec.lut_rows:
        raise ArenaCapacityError(
            f"root_lut spans {root_lut.shape[0]} ifindexes > slab bound "
            f"{spec.lut_rows}"
        )
    l0b = np.zeros((spec.l0_rows, 2), np.int32)
    l0b[: l0.shape[0]] = l0
    nodesb = np.zeros((spec.node_rows, 20), np.uint32)
    nodesb[: nodes.shape[0]] = nodes.astype(np.uint32)
    tgtb = np.zeros(spec.target_rows, np.int32)
    tgtb[: targets.shape[0]] = targets.astype(np.int32)
    joinb = np.zeros((spec.joined_rows, joined.shape[1]), np.uint16)
    joinb[: joined.shape[0]] = joined
    lutb = np.zeros(spec.lut_rows, np.int32)
    lutb[: root_lut.shape[0]] = root_lut.astype(np.int32)
    return (l0b, nodesb, tgtb, joinb, lutb), int(nodes.shape[0])


def _offset_ctrie_slab(spec: ArenaSpec, arrays, n_nodes: int, page: int):
    """Canonical slab arrays -> the page's resident form: node ids +=
    page*SN, target positions += page*ST, joined positions += page*SJ, root
    ids += page*R0 (zero entries stay zero; the first ``n_nodes`` node rows
    offset in uint32 arithmetic).  Never mutates the canonical arrays."""
    l0, nodes, targets, joined, root_lut = arrays
    if page == 0:
        return l0, nodes, targets, joined, root_lut
    nb = page * spec.node_rows
    tb = page * spec.target_rows
    jb = page * spec.joined_rows
    rb = page * spec.root_nodes
    l0o = np.zeros_like(l0)
    l0o[:, 0] = np.where(l0[:, 0] > 0, l0[:, 0] + nb, 0)
    l0o[:, 1] = np.where(l0[:, 1] > 0, l0[:, 1] + jb, 0)
    nodeso = nodes.copy()
    nodeso[:n_nodes, 0] += np.uint32(nb)
    nodeso[:n_nodes, 1] += np.uint32(tb)
    tgto = np.where(targets > 0, targets + jb, 0).astype(np.int32)
    luto = (root_lut.astype(np.int64) + rb).astype(np.int32)
    return l0o, nodeso, tgto, joined, luto


def _unoffset_ctrie_slab(spec: ArenaSpec, arrays, n_nodes: int, page: int):
    """Inverse of _offset_ctrie_slab: a page's resident slab rows back to
    the canonical form (what the content hash and compaction read from the
    host mirror)."""
    l0, nodes, targets, joined, root_lut = arrays
    if page == 0:
        return l0, nodes, targets, joined, root_lut
    nb = page * spec.node_rows
    tb = page * spec.target_rows
    jb = page * spec.joined_rows
    rb = page * spec.root_nodes
    l0c = np.zeros_like(l0)
    l0c[:, 0] = np.where(l0[:, 0] > 0, l0[:, 0] - nb, 0)
    l0c[:, 1] = np.where(l0[:, 1] > 0, l0[:, 1] - jb, 0)
    nodesc = nodes.copy()
    nodesc[:n_nodes, 0] -= np.uint32(nb)
    nodesc[:n_nodes, 1] -= np.uint32(tb)
    tgtc = np.where(targets > 0, targets - jb, 0).astype(np.int32)
    lutc = (root_lut.astype(np.int64) - rb).astype(np.int32)
    return l0c, nodesc, tgtc, joined, lutc


def _ctrie_slab_arrays(spec: ArenaSpec, page: int, tables: CompiledTables):
    """Full-slab host arrays with the page's GLOBAL offsets baked in."""
    arrays, n_nodes = _ctrie_canonical_slab(spec, tables)
    return _offset_ctrie_slab(spec, arrays, n_nodes, page)


def slab_content_hash(arrays, n_nodes: int = 0) -> bytes:
    """sha256 over the page-independent slab arrays' bytes (shape and dtype
    framed) plus the real node-row count: identical rulesets hash alike
    whichever page they land on."""
    h = hashlib.sha256()
    h.update(str(int(n_nodes)).encode())
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(repr((a.shape, a.dtype.str)).encode())
        h.update(a.tobytes())
    return h.digest()


# -- the allocator -----------------------------------------------------------

#: the slab arrays of each family, in slab order
_NAMES = {"dense": ("key_words", "mask_words", "mask_len", "rules"),
          "ctrie": ("l0", "nodes", "targets", "joined", "root_lut")}


class ArenaAllocator:
    """Host-side slab allocator over one pool of either family: page alloc
    and free, full-slab bakes, rules-only per-slab patches, page-table
    flips and compaction.

    Slabs are CONTENT-ADDRESSED and shared copy-on-write: a sha256 over the
    baked canonical slab maps identical rulesets to ONE physical page with
    refcounted page-table rows, and installing a ruleset whose content is
    already resident is a flip (no bake, no slab write).  An edit of a
    shared page bakes a private copy into a free page before the editing
    tenant's flip (a rules-only edit clones the donor's canonical arrays
    and patches the copy's dirty rows, no bake); the donor's refcount
    drops (free at zero) and every other sharer keeps serving it.  A
    rules-only edit of a private page writes its dirty rows in place.
    ``dedup_sweep`` re-hashes pages whose hash went stale (patch, clone,
    free-list claim-back) and re-merges re-converged content.

    All mutating entry points hold the internal lock; a caller that
    enqueues a classify under ``lock`` orders it wholly before or after
    any write.  ``node_gen`` counts structural slab writes, as the JAX
    allocator's does (nothing here reads it)."""

    def __init__(self, spec: ArenaSpec, device=None):
        if spec.spliced:
            raise NotImplementedError(f"a spliced arena is {SPLICE_ITEM}")
        self.spec = spec
        self._device = resolve_device(device)
        self.lock = threading.RLock()
        P = spec.pages
        if spec.family == "dense":
            S = P * spec.entries
            host = {
                "key_words": np.zeros((S, 5), np.uint32),
                "mask_words": np.zeros((S, 5), np.uint32),
                "mask_len": np.full(S, -1, np.int32),
                "rules": np.zeros((S, spec.rule_slots * 5), np.uint16),
            }
        else:
            host = {
                "l0": np.zeros((P * spec.l0_rows, 2), np.int32),
                "nodes": np.zeros((P * spec.node_rows, 20), np.uint32),
                "targets": np.zeros(P * spec.target_rows, np.int32),
                "joined": np.zeros((P * spec.joined_rows, 3 + spec.rule_slots * 5), np.uint16),
                "root_lut": np.zeros(P * spec.lut_rows, np.int32),
                "splice": np.full(spec.splice_rows, -1, np.int32),
            }
        host["page_table"] = np.full(spec.max_tenants, -1, np.int32)
        self._host = host
        # the device pool starts equal to the mirror: zeros, and -1 rows
        # in mask_len, the splice placeholder and the page table
        pool = DenseArena if spec.family == "dense" else CtrieArena
        self._dev = pool(**{
            k: torch.full(v.shape, -1 if k in ("mask_len", "splice", "page_table") else 0,
                          dtype=torch.int16 if v.dtype == np.uint16 else torch.int32,
                          device=self._device)
            for k, v in host.items()
        })
        self._free = list(range(P))
        self._tenant_page: dict = {}
        self._tenant_tables: dict = {}
        #: page -> page-table rows referencing it
        self._page_refs: dict = {}
        #: page -> stage() reservations not yet activated or released
        self._page_holds: dict = {}
        #: page -> real skip-node row count of the resident slab (persists
        #: across a free so a standby claim-back stays canonicalizable)
        self._page_nnodes: dict = {}
        #: content hash -> page and inverse, for pages whose hash is current
        self._hash_page: dict = {}
        self._page_hash: dict = {}
        self._hash_dirty: set = set()
        self.counters = {
            "assigns": 0, "patches": 0, "swaps": 0, "flips": 0,
            "destroys": 0, "compactions": 0, "slab_writes": 0,
            "shared_hits": 0, "cow_clones": 0, "dedup_merges": 0,
            "plane_writes": 0, "plane_hits": 0, "splice_unsplices": 0,
            "splice_merges": 0,
        }
        self.node_gen = 0

    # -- introspection -------------------------------------------------------

    @property
    def arena(self):
        """The device pool (written in place, in stream order)."""
        with self.lock:
            return self._dev

    @property
    def family(self) -> str:
        return self.spec.family

    @property
    def device(self) -> torch.device:
        return self._device

    def page_of(self, tenant: int):
        with self.lock:
            return self._tenant_page.get(tenant)

    def tables_of(self, tenant: int):
        with self.lock:
            return self._tenant_tables.get(tenant)

    def tenants(self):
        with self.lock:
            return sorted(self._tenant_page)

    def free_pages(self) -> int:
        with self.lock:
            return len(self._free)

    def page_refcount(self, page: int) -> int:
        with self.lock:
            return self._page_refs.get(page, 0)

    def page_holds(self, page: int) -> int:
        with self.lock:
            return self._page_holds.get(page, 0)

    def tenant_shares_page(self, tenant: int) -> bool:
        """True when another tenant's row or a stage hold references the
        tenant's page (an edit must then copy-on-write)."""
        with self.lock:
            page = self._tenant_page.get(tenant)
            return page is not None and self._is_shared(page)

    def distinct_slabs(self) -> int:
        """Live physical pages (referenced or held)."""
        with self.lock:
            return len(self._live_pages())

    def pool_bytes(self) -> int:
        """Device bytes of the pool tensors."""
        with self.lock:
            return sum(t.numel() * t.element_size() for t in self._dev)

    def host_nodes(self) -> Optional[np.ndarray]:
        """A copy of the host mirror of the merged skip-node pool (None for
        the dense family)."""
        with self.lock:
            arr = self._host.get("nodes")
            return None if arr is None else arr.copy()

    def counter_values(self) -> dict:
        """tenant_* counters: slab occupancy gauges plus monotonic
        mutation counts (jaxpath.ArenaAllocator.counter_values)."""
        with self.lock:
            out = {
                "tenant_active_slabs": len(self._tenant_page),
                "tenant_free_slabs": len(self._free),
                "tenant_distinct_slabs": len(self._live_pages()),
                "tenant_shared_pages": sum(1 for n in self._page_refs.values() if n > 1),
                "tenant_hash_index": len(self._hash_page),
                "tenant_hash_dirty": len(self._hash_dirty),
            }
            for k, v in self.counters.items():
                out[f"tenant_{k}_total"] = v
            return out

    def _live_pages(self) -> set:
        return set(self._page_refs) | {p for p, h in self._page_holds.items() if h > 0}

    # -- device writes -------------------------------------------------------

    def _slab_rows(self):
        s = self.spec
        if s.family == "dense":
            return (s.entries,) * 4
        return (s.l0_rows, s.node_rows, s.target_rows, s.joined_rows, s.lut_rows)

    def _on_device(self):
        """The pool's device as the current one, so its writes go on that
        device's current stream (the stream classify launches on)."""
        if self._device.type == "cuda":
            return torch.cuda.device(self._device)
        return contextlib.nullcontext()

    def _write_slab(self, page: int, slab_arrays, n_nodes: int = 0) -> None:
        """Bake one full slab into the pool: the host mirror first, then one
        synchronous copy per array into the slab's row range (whole slab
        rows, so a reused page carries no stale bytes)."""
        with self._on_device():
            for name, rows, arr in zip(_NAMES[self.spec.family], self._slab_rows(),
                                       slab_arrays):
                base = page * rows
                self._host[name][base: base + rows] = arr
                getattr(self._dev, name)[base: base + rows].copy_(
                    _dev_view(self._host[name][base: base + rows])
                )
        self._page_nnodes[page] = int(n_nodes)
        self.counters["slab_writes"] += 1
        self.node_gen += 1

    def _flip(self, tenant: int, page: int) -> None:
        """The page-table row flip: the mirror, then one element of the
        device page table."""
        self._host["page_table"][tenant] = page
        with self._on_device():
            self._dev.page_table[tenant: tenant + 1].fill_(page)
        self.counters["flips"] += 1

    # -- content addressing / CoW plumbing ------------------------------------

    def _is_shared(self, page: int) -> bool:
        return self._page_refs.get(page, 0) > 1 or self._page_holds.get(page, 0) > 0

    def _bake_canonical(self, tables: CompiledTables):
        """(canonical arrays, n_nodes, content hash), memoized on the tables
        object per spec."""
        cached = getattr(tables, "_arena_slab_cache", None)
        if cached is not None and cached[0] == self.spec:
            return cached[1], cached[2], cached[3]
        if self.spec.family == "dense":
            arrays, n_nodes = _dense_slab_arrays(self.spec, tables), 0
        else:
            arrays, n_nodes = _ctrie_canonical_slab(self.spec, tables)
        chash = slab_content_hash(arrays, n_nodes)
        tables._arena_slab_cache = (self.spec, arrays, n_nodes, chash)
        return arrays, n_nodes, chash

    def _offset(self, arrays, n_nodes: int, page: int):
        """Canonical arrays -> the page's resident form (the identity for
        the dense family)."""
        if self.spec.family == "dense":
            return arrays
        return _offset_ctrie_slab(self.spec, arrays, n_nodes, page)

    def _canonical_of_page(self, page: int):
        """Canonical arrays of one resident page from the host mirror (views
        for the dense family and page 0: callers that mutate must copy)."""
        arrays = tuple(
            self._host[name][page * r: (page + 1) * r]
            for name, r in zip(_NAMES[self.spec.family], self._slab_rows())
        )
        if self.spec.family == "dense":
            return arrays
        return _unoffset_ctrie_slab(self.spec, arrays, self._page_nnodes.get(page, 0), page)

    def _unindex(self, page: int) -> None:
        old = self._page_hash.pop(page, None)
        if old is not None and self._hash_page.get(old) == page:
            del self._hash_page[old]

    def _index_page(self, page: int, chash: bytes) -> bool:
        """Register a page's current content hash; when another live page
        owns the hash the page stays hash-dirty (dedup_sweep merges)."""
        self._unindex(page)
        self._hash_dirty.discard(page)
        cur = self._hash_page.get(chash)
        if cur is not None and cur != page:
            self._hash_dirty.add(page)
            return False
        self._hash_page[chash] = page
        self._page_hash[page] = chash
        return True

    def _mark_hash_dirty(self, page: int) -> None:
        """The page's content left its registered hash (an in-place patch):
        unindex it now, dedup_sweep re-hashes it, so a patch stays
        O(dirty rows)."""
        self._unindex(page)
        self._hash_dirty.add(page)

    def _incref(self, page: int) -> None:
        self._page_refs[page] = self._page_refs.get(page, 0) + 1

    def _decref(self, page: int) -> None:
        """Drop one page-table reference; the page frees at zero (with no
        holds)."""
        n = self._page_refs.get(page, 0) - 1
        if n > 0:
            self._page_refs[page] = n
            return
        self._page_refs.pop(page, None)
        if self._page_holds.get(page, 0) == 0:
            self._release_page(page)

    def _release_page(self, page: int) -> None:
        """Return a page to the free list, unindexed, but keep its bytes,
        mirror and n_nodes for a standby claim-back."""
        self._unindex(page)
        self._hash_dirty.discard(page)
        if page not in self._free:
            self._free.append(page)

    def _drop_hold(self, page: int) -> None:
        h = self._page_holds.get(page, 0)
        if h == 1:
            self._page_holds.pop(page, None)
        elif h > 1:
            self._page_holds[page] = h - 1

    # -- tenant lifecycle ----------------------------------------------------

    def _alloc_page(self) -> int:
        if not self._free:
            raise ArenaCapacityError(
                f"arena out of pages ({self.spec.pages} total, "
                f"{len(self._page_refs)} distinct slabs live for "
                f"{len(self._tenant_page)} tenants; an edit of a SHARED "
                "slab needs a free page to copy-on-write into — size the "
                "pool with spare pages beyond the distinct-content count)"
            )
        return self._free.pop(0)

    def _check_tenant(self, tenant: int) -> None:
        if not (0 <= tenant < self.spec.max_tenants):
            raise ArenaCapacityError(
                f"tenant id {tenant} outside [0, {self.spec.max_tenants})"
            )

    def _write_new_page(self, arrays, n_nodes: int) -> int:
        """Bake into a freshly allocated page; the page goes back to the
        free list if the write fails."""
        page = self._alloc_page()
        try:
            self._write_slab(page, self._offset(arrays, n_nodes, page), n_nodes=n_nodes)
        except Exception:
            self._free.insert(0, page)
            raise
        return page

    def load_tenant(self, tenant: int, tables: CompiledTables, hint=None) -> str:
        """Install or refresh one tenant's table; returns the path taken
        (jaxpath.ArenaAllocator._load_tenant_whole):

        - "patch": a rules-only ``hint`` (an IncrementalTables dirty hint
          whose trie levels are untouched) on the tenant's PRIVATE page:
          the dirty dense rows, or the dirty joined rows, written in place;
        - "share": the content is resident: a refcount and a flip, or
          nothing;
        - "cow": the tenant's page is shared, so the edit lands in a
          private copy in a free page, then the flip and the donor's
          decrement (a rules-only edit clones the donor's canonical arrays
          and patches the dirty rows, skipping the bake and the hash);
        - "rewrite": an in-place full bake of a private page;
        - "assign": a fresh page and a flip."""
        self._check_tenant(tenant)
        with self.lock:
            page = self._tenant_page.get(tenant)
            old = self._tenant_tables.get(tenant)
            shared = page is not None and self._is_shared(page)
            if page is not None and not shared and old is not None and hint is not None:
                if self._try_patch(page, old, tables, hint):
                    self._tenant_tables[tenant] = tables
                    self.counters["patches"] += 1
                    self._mark_hash_dirty(page)
                    return "patch"
            if shared and old is not None and hint_trie_unchanged(hint):
                # no hash probe: hashing would cost the bake the clone
                # avoids; re-convergence is dedup_sweep's
                can = self._clone_patched_canonical(page, old, tables, hint)
                if can is not None:
                    return self._cow_install(tenant, page, can[0], can[1], None, tables)
            arrays, n_nodes, chash = self._bake_canonical(tables)
            hit = self._hash_page.get(chash)
            if hit is not None:
                if hit == page:
                    self._tenant_tables[tenant] = tables
                    return "share"
                self._tenant_page[tenant] = hit
                self._incref(hit)
                self._tenant_tables[tenant] = tables
                self._flip(tenant, hit)
                if page is not None:
                    self._decref(page)
                self.counters["shared_hits"] += 1
                return "share"
            if page is None:
                new_page = self._write_new_page(arrays, n_nodes)
                self._index_page(new_page, chash)
                self._tenant_page[tenant] = new_page
                self._page_refs[new_page] = 1
                self._tenant_tables[tenant] = tables
                self._flip(tenant, new_page)
                self.counters["assigns"] += 1
                return "assign"
            if not shared:
                self._write_slab(page, self._offset(arrays, n_nodes, page), n_nodes=n_nodes)
                self._index_page(page, chash)
                self._tenant_tables[tenant] = tables
                self.counters["assigns"] += 1
                return "rewrite"
            return self._cow_install(tenant, page, arrays, n_nodes, chash, tables)

    def _dirty_rows(self, old: CompiledTables, new: CompiledTables, hint):
        """For a rules-only hint: the family's (array name, positions, rows)
        relative to the slab base, or None when the patch cannot express
        the edit (jaxpath._try_patch / _clone_patched_canonical): the dense
        group at the dirty rows, or the ctrie joined rows at the dirty
        targets, after carrying ``old``'s host caches forward to ``new``."""
        dirty = hint_dense_rows(hint, new)
        if self.spec.family == "dense":
            layout = _dense_host_layout(new)
            if not _dense_fits(self.spec, layout):
                return None
            rows = dirty[dirty < layout[0].shape[0]]
            return [(name, rows, src[rows]) for name, src in zip(_NAMES["dense"], layout)]
        seed_caches_forward(old, new, hint)
        pr = joined_tidx_patch_rows(new, dirty)
        if pr is None:
            return None
        pos, rows = pr
        if len(pos) and (int(pos.max()) >= self.spec.joined_rows
                         or rows.shape[1] != self._host["joined"].shape[1]):
            return None
        return [("joined", pos, rows)]

    def _try_patch(self, page: int, old: CompiledTables, new: CompiledTables, hint) -> bool:
        """The rules-only per-slab patch: the dirty rows written at the
        slab base, the mirror first, then one staged copy and an
        ``index_copy_`` per array into the live pool.  False: the caller
        bakes the slab instead."""
        if not hint_trie_unchanged(hint):
            return False
        patch = self._dirty_rows(old, new, hint)
        if patch is None:
            return False
        rows_per = dict(zip(_NAMES[self.spec.family], self._slab_rows()))
        entries = []
        for name, pos, vals in patch:
            gpos = page * rows_per[name] + pos
            self._host[name][gpos] = vals
            entries.append((getattr(self._dev, name), gpos, vals))
        with self._on_device():
            write_rows(entries)
        return True

    def _clone_patched_canonical(self, donor: int, old: CompiledTables,
                                 new: CompiledTables, hint):
        """The copy-on-write clone-then-patch: the donor page's canonical
        arrays copied (no recompile, no bake) with the rules-only dirty
        rows of ``new`` applied.  (arrays, n_nodes), or None when the patch
        cannot express the edit."""
        patch = self._dirty_rows(old, new, hint)
        if patch is None:
            return None
        arrays = [np.array(a, copy=True) for a in self._canonical_of_page(donor)]
        by_name = dict(zip(_NAMES[self.spec.family], arrays))
        for name, pos, vals in patch:
            by_name[name][pos] = vals
        return tuple(arrays), self._page_nnodes.get(donor, 0)

    def _cow_install(self, tenant, donor, arrays, n_nodes, chash, tables) -> str:
        """Write the private copy into a free page, flip the editing
        tenant's row, and only then decrement the donor: every other sharer
        serves the untouched donor slab throughout.  ``chash`` None (a
        clone-then-patch) leaves the new page hash-dirty for dedup_sweep."""
        new_page = self._write_new_page(arrays, n_nodes)
        if chash is not None:
            self._index_page(new_page, chash)
        else:
            self._hash_dirty.add(new_page)
        self._tenant_page[tenant] = new_page
        self._page_refs[new_page] = 1
        self._tenant_tables[tenant] = tables
        self._flip(tenant, new_page)
        self._decref(donor)
        self.counters["cow_clones"] += 1
        return "cow"

    def stage(self, tables: CompiledTables) -> int:
        """Content-addressed staging: on a hash hit, hold the resident page
        (no bake, no write); on a miss, bake into a free page and index it.
        Returns the staged page, reserved until activate or release."""
        with self.lock:
            arrays, n_nodes, chash = self._bake_canonical(tables)
            hit = self._hash_page.get(chash)
            if hit is not None:
                self._page_holds[hit] = self._page_holds.get(hit, 0) + 1
                self.counters["shared_hits"] += 1
                return hit
            page = self._write_new_page(arrays, n_nodes)
            self._index_page(page, chash)
            self._page_holds[page] = self._page_holds.get(page, 0) + 1
            return page

    def release(self, page: int) -> None:
        """Drop one stage reservation; the page frees when no references
        and no other holds remain."""
        with self.lock:
            if self._page_holds.get(page, 0) <= 0:
                return
            self._drop_hold(page)
            if self._page_refs.get(page, 0) == 0 and self._page_holds.get(page, 0) == 0:
                self._release_page(page)

    def activate(self, tenant: int, page: int,
                 tables: Optional[CompiledTables] = None) -> None:
        """Hot-swap: flip the tenant's row to a staged (or shared) page,
        take a reference on it and drop the previous page's.  A page on
        the free list (the ping-pong standby pattern) is claimed back: its
        bytes persisted, and it is marked for a dedup re-hash."""
        self._check_tenant(tenant)
        with self.lock:
            if page in self._free:
                self._free.remove(page)
                self._hash_dirty.add(page)
            self._drop_hold(page)
            old_page = self._tenant_page.get(tenant)
            self._tenant_page[tenant] = page
            if tables is not None:
                self._tenant_tables[tenant] = tables
            else:
                # the previous table no longer describes the slab now serving
                self._tenant_tables.pop(tenant, None)
            if old_page != page:
                self._incref(page)
            self._flip(tenant, page)
            if old_page is not None and old_page != page:
                self._decref(old_page)
            self.counters["swaps"] += 1

    def swap_tenant(self, tenant: int, tables: CompiledTables) -> None:
        """stage + activate in one call."""
        page = self.stage(tables)
        self.activate(tenant, page, tables)

    def destroy_tenant(self, tenant: int) -> None:
        """Flip the tenant's row to -1 and drop its reference: a page shared
        with other tenants survives, a private page frees."""
        self._check_tenant(tenant)
        with self.lock:
            page = self._tenant_page.pop(tenant, None)
            self._tenant_tables.pop(tenant, None)
            self._flip(tenant, -1)
            if page is not None:
                self._decref(page)
            self.counters["destroys"] += 1

    def compact(self) -> int:
        """Repack live slabs into the lowest-numbered free pages: each move
        rebakes the page from its canonical mirror, then flips every
        sharer's row; the source page is reclaimed after the last flip.
        Staged pages (live holds) stay put.  Returns tenant rows moved."""
        moved = 0
        with self.lock:
            while True:
                live = sorted(p for p in self._page_refs if self._page_holds.get(p, 0) == 0)
                src = tgt = None
                for p in reversed(live):
                    lower = [f for f in self._free if f < p]
                    if lower:
                        src, tgt = p, min(lower)
                        break
                if src is None:
                    break
                arrays = tuple(np.array(a, copy=True) for a in self._canonical_of_page(src))
                n_nodes = self._page_nnodes.get(src, 0)
                self._free.remove(tgt)
                self._write_slab(tgt, self._offset(arrays, n_nodes, tgt), n_nodes=n_nodes)
                self._page_refs[tgt] = self._page_refs.pop(src)
                chash = self._page_hash.pop(src, None)
                if chash is not None and self._hash_page.get(chash) == src:
                    self._hash_page[chash] = tgt
                    self._page_hash[tgt] = chash
                elif src in self._hash_dirty:
                    self._hash_dirty.discard(src)
                    self._hash_dirty.add(tgt)
                sharers = sorted(t for t, p in self._tenant_page.items() if p == src)
                for t in sharers:
                    self._tenant_page[t] = tgt
                    self._flip(t, tgt)
                    moved += 1
                if src not in self._free:
                    self._free.append(src)
            self._free.sort()
            if moved:
                self.counters["compactions"] += 1
        return moved

    def dedup_sweep(self, limit: Optional[int] = None) -> dict:
        """Re-hash pages whose content hash went stale, re-index them, and
        merge pages whose content re-converged with an indexed page: every
        tenant of the duplicate flips onto the indexed page, then the
        duplicate frees.  Staged pages re-index but never merge away.
        Returns {"hashed", "merged", "moved"} (``moved``: tenant ids whose
        page changed)."""
        hashed = 0
        moved: list = []
        with self.lock:
            dirty = sorted(self._hash_dirty)
            if limit is not None:
                dirty = dirty[: max(int(limit), 0)]
            for page in dirty:
                if self._page_refs.get(page, 0) == 0 and self._page_holds.get(page, 0) == 0:
                    self._hash_dirty.discard(page)
                    continue
                chash = slab_content_hash(self._canonical_of_page(page),
                                          self._page_nnodes.get(page, 0))
                hashed += 1
                cur = self._hash_page.get(chash)
                if cur is None or cur == page:
                    self._index_page(page, chash)
                    continue
                if self._page_holds.get(page, 0):
                    self._hash_dirty.discard(page)
                    continue
                sharers = sorted(t for t, p in self._tenant_page.items() if p == page)
                for t in sharers:
                    self._tenant_page[t] = cur
                    self._incref(cur)
                    self._flip(t, cur)
                    self._decref(page)
                    moved.append(t)
                self._hash_dirty.discard(page)
                if sharers:
                    self.counters["dedup_merges"] += 1
        return {"hashed": hashed, "merged": len(moved), "moved": moved}
