"""Single-GPU classifier backend: the dense, trie and ctrie paths.

The counterpart of the JAX package's TpuClassifier, stateless serving on
one device: compiled rule tables live on the card, each batch is packed
into the wire format on the host, copied in once, unpacked and classified
by kernel K1 (kernels/dense.py, tables of at most ``dense_limit`` entries),
kernel K2 (kernels/walk.py, the trie path) or kernel K3 (kernels/cwalk.py,
the compressed ctrie path), and read back once as one int32 buffer of
results and statistics.

- **path choice** (``load_tables``): dense up to ``dense_limit`` entries,
  trie above; a table whose ruleIds or rule width the dense packing cannot
  hold takes the trie path too.  ``compressed`` (else the
  ``INFW_COMPRESSED`` env, else off) upgrades the auto-selected trie path
  to the ctrie path; ``force_path`` pins a path and wins over
  ``compressed`` (``force_path="ctrie"`` is the per-instance form).  A
  ctrie table whose results do not fit the 16-bit wire or whose rules do
  not fit the uint16 joined rows falls back to the trie path.
- **depth steering** (trie path): an IPv4-only chunk walks the levels
  within /32; ``v6_depth_groups`` bins IPv6 positions into the table's
  depth classes, and a chunk of class d walks 1 + d levels.  The class
  travels with the generation of the tables it was computed on; a stale
  generation walks every level (never under-walk a newer table).  The
  ctrie path does not steer: K3 serves every chunk whole, so
  ``v6_depth_groups`` returns its steering-off form and depth tokens
  change nothing.
- **wide ruleIds** (above 255, trie path): the 16-bit wire result cannot
  carry them, so ``classify`` ships the whole batch and reads u32 results
  back, through the same kernel.
- **table swap**: the next tables are packed and uploaded outside the
  lock; the swap is one reference assignment under it, so batches in
  flight finish on the tables they were launched against.
- **asynchronous launch**: ``classify_async``/``classify_prepared``
  enqueue the copy and the kernels on the current CUDA stream and return
  a PendingClassify; the device-to-host read happens in ``.result()``.
- statistics accumulate on the host in int64 from each batch's (1024, 6)
  int32 sums, applied exactly once when a batch materializes.

The device is the first CUDA card unless the caller names another
(``device="cpu"`` runs the plain PyTorch version of every kernel, which is
what the CPU tests do).  There is no silent fallback to the CPU.
"""
from __future__ import annotations

import os
import threading
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from ..compiler import CompiledTables
from ..constants import KIND_IPV6
from ..kernels import cwalk, dense, torchpath, walk
from ..layout import (
    build_depth_lut,
    check_wire_ruleids,
    depth_group_indices,
    joined_by_tidx,
    tune_depth_classes,
    v4_trie_depth,
)
from ..packets import PacketBatch, narrow_wire
from .base import ClassifyOutput, PendingClassify, StatsAccumulator

#: where the parts this backend does not serve yet are queued
OVERLAY_ITEM = "ROADMAP.md item 5 (incremental patches and the overlay combine)"


class _Active(NamedTuple):
    path: str  # "dense" | "trie" | "ctrie"
    dev: Union[dense.DenseTables, walk.TrieTables, cwalk.CTrieTables]
    wide_rids: bool


class TorchClassifier:
    """Single-device classifier (dense, trie and ctrie paths)."""

    def __init__(self, device=None, dense_limit: int = dense.MAX_DENSE_TARGETS,
                 force_path: Optional[str] = None,
                 compressed: Optional[bool] = None) -> None:
        if force_path not in (None, "dense", "trie", "ctrie"):
            raise ValueError(
                f"unknown force_path {force_path!r} (expected 'dense', 'trie', 'ctrie' or None)"
            )
        self._device = torchpath.resolve_device(device)
        self._dense_limit = dense_limit
        self._force_path = force_path
        # the JAX package's precedence: the argument, else INFW_COMPRESSED,
        # else off
        if compressed is None:
            env = os.environ.get("INFW_COMPRESSED", "")
            compressed = bool(env) and env not in ("0", "false", "no")
        self._compressed = bool(compressed)
        self._lock = threading.Lock()
        self._stats = StatsAccumulator()
        self._tables: Optional[CompiledTables] = None
        self._active: Optional[_Active] = None
        # (root_lut, depth LUT, classes, generation) of the trie tables in
        # service (None on the other paths); the generation is assigned
        # under the install lock
        self._depth_steer = None
        self._depth_gen = 0
        self._closed = False

    @property
    def device(self) -> torch.device:
        return self._device

    # -- rule loading -------------------------------------------------------

    def load_tables(self, tables: CompiledTables,
                    overlay: Optional[CompiledTables] = None) -> None:
        """Swap in a newly compiled ruleset (a full upload).  An overlay
        with entries raises: ValueError where the JAX package refuses one
        too (dense path, wide ruleIds), NotImplementedError on the trie and
        ctrie paths."""
        if self._closed:
            raise RuntimeError("classifier is closed")
        path = self._force_path or (
            "dense" if tables.num_entries <= self._dense_limit else "trie"
        )
        if path == "trie" and self._compressed and self._force_path is None:
            path = "ctrie"  # the upgrade applies to the auto-selected trie path only
        if path == "ctrie":
            # results must fit the 16-bit wire and rules the uint16 joined
            # rows; otherwise the trie path serves the table
            try:
                check_wire_ruleids(tables)
            except ValueError:
                path = "trie"
            else:
                if joined_by_tidx(tables) is None:
                    path = "trie"
        if path == "dense":
            try:
                dev = dense.build_dense_tables(tables, self._device)
            except ValueError as e:
                if "ruleId" not in str(e):
                    raise
                # ruleIds or a rule width the dense packing cannot hold:
                # the trie path serves the table instead
                path = "trie"
        wide_rids = False
        if path == "trie":
            try:
                check_wire_ruleids(tables)
            except ValueError:
                wide_rids = True  # the u32 result path
        if overlay is not None and overlay.num_entries > 0:
            if path not in ("trie", "ctrie") or wide_rids:
                raise ValueError(
                    f"overlay not supported on path={path} (wide_rids={wide_rids}); "
                    "merge it into the main table"
                )
            raise NotImplementedError(f"the {path} path's overlay combine is {OVERLAY_ITEM}")
        steer = None
        if path == "ctrie":
            dev = cwalk.build_ctrie_tables(tables, self._device)
        elif path == "trie":
            dev = walk.build_trie_tables(tables, self._device)
            steer = (
                np.asarray(tables.root_lut, np.int64),
                build_depth_lut(tables),
                tune_depth_classes(tables),
            )
        with self._lock:
            self._tables = tables
            self._active = _Active(path, dev, wide_rids)
            self._depth_gen += 1
            self._depth_steer = None if steer is None else steer + (self._depth_gen,)

    # -- classify -----------------------------------------------------------

    def _snapshot(self) -> _Active:
        with self._lock:
            if self._active is None:
                raise RuntimeError("no rule tables loaded")
            return self._active

    def classify_async(
        self, batch: PacketBatch, apply_stats: bool = True
    ) -> PendingClassify:
        """Enqueue the host-to-device copy and the kernels; return a handle
        whose .result() reads back and applies the stats increment once.
        ``apply_stats=False`` leaves the accumulator to the caller.  On the
        trie path an IPv4-only batch walks the levels within /32, any
        other batch every level."""
        active = self._snapshot()
        if active.wide_rids:
            return self._classify_async_wide(active.dev, batch, apply_stats)
        # Packed wire: 16 B/packet for v4-only chunks, 28 B otherwise, one
        # word less when narrow_wire qualifies the chunk.
        kind = np.asarray(batch.kind)
        v4_only = not bool((kind == KIND_IPV6).any())
        wire_np = batch.pack_wire_v4() if batch.is_v4_compactable() else batch.pack_wire()
        n_levels = None
        if active.path == "trie":
            n = active.dev.n_levels
            n_levels = v4_trie_depth(n) if v4_only else n
        return self._launch(self._plan(active, wire_np, kind, n_levels), apply_stats)

    def classify(self, batch: PacketBatch, apply_stats: bool = True) -> ClassifyOutput:
        return self.classify_async(batch, apply_stats=apply_stats).result()

    def supports_packed(self) -> bool:
        """True when classify_async_packed can take this table generation
        (wide ruleIds need the full-batch path)."""
        with self._lock:
            return self._active is not None and not self._active.wide_rids

    def v6_depth_groups(self, ifindex: np.ndarray, ip_words: np.ndarray, idx: np.ndarray):
        """Split ``idx`` (positions of IPv6 packets) into depth-class groups
        [((class_or_None, generation), positions)] with the current
        generation's LUT; class d is fully classified by 1 + d levels, None
        is the full depth.  Returns [((None, 0), idx)] when steering is off
        (generation 0 never matches, so the walk stays full-depth)."""
        with self._lock:
            steer = self._depth_steer
        if steer is None or len(idx) == 0:
            return [((None, 0), idx)]
        root_lut, lut, classes, gen = steer
        return [
            ((d, gen), sub)
            for d, sub in depth_group_indices(root_lut, lut, classes, ifindex, ip_words, idx)
        ]

    def serving_shape_classes(self):
        """The depth classes of the current generation as (class_or_None,
        generation) pairs, full depth last; empty when steering is off."""
        with self._lock:
            steer = self._depth_steer
        if steer is None:
            return []
        classes, gen = steer[2], steer[3]
        return [(int(d), gen) for d in classes] + [(None, gen)]

    def classify_async_packed(
        self, wire_np: np.ndarray, v4_only: bool, apply_stats: bool = True, depth=None,
    ) -> PendingClassify:
        """classify_async for a pre-packed (B, 4|7) uint32 wire array
        (PacketBatch.pack_wire_subset); ``depth`` is a (class, generation)
        pair from v6_depth_groups.  Caller contract: supports_packed()."""
        return self.classify_prepared(
            self.prepare_packed(wire_np, v4_only, depth=depth), apply_stats=apply_stats
        )

    def prepare_packed(self, wire_np: np.ndarray, v4_only: bool, depth=None):
        """First half of classify_async_packed: choose the walk depth and
        the wire width and start the host-to-device copy; returns the plan
        for classify_prepared, which finishes on the tables snapshotted
        here."""
        active = self._snapshot()
        if active.wide_rids:
            raise RuntimeError("wide-ruleId tables need the full-batch path (supports_packed)")
        kind = (wire_np[:, 0] & 3).astype(np.int32)
        n_levels = None
        if active.path == "trie":
            n = active.dev.n_levels
            d = None
            if depth is not None:
                dclass, gen = depth
                with self._lock:
                    cur_gen = self._depth_steer[3] if self._depth_steer else -1
                if dclass is not None and gen == cur_gen:
                    d = int(dclass)
            n_levels = v4_trie_depth(n) if v4_only else (n if d is None else 1 + d)
        return self._plan(active, wire_np, kind, n_levels)

    def classify_prepared(self, plan, apply_stats: bool = True) -> PendingClassify:
        """Second half: launch the classify on a prepare_packed plan."""
        return self._launch(plan, apply_stats)

    def _plan(self, active: _Active, wire_np: np.ndarray, kind: np.ndarray, n_levels):
        if wire_np.shape[1] in (4, 7):
            narrow = narrow_wire(wire_np)
            if narrow is not None:
                wire_np = narrow
        wire = torch.from_numpy(np.ascontiguousarray(wire_np).view(np.int32)).to(self._device)
        return {"active": active, "wire": wire, "kind": kind, "n": wire_np.shape[0],
                "n_levels": n_levels}

    def _launch(self, plan, apply_stats: bool) -> PendingClassify:
        active, wire, n = plan["active"], plan["wire"], plan["n"]
        if active.path == "dense":
            fused = dense.classify_dense_wire_fused(active.dev, wire)
        elif active.path == "ctrie":
            fused = cwalk.classify_ctrie_wire_fused(active.dev, wire)
        else:
            fused = walk.classify_walk_wire_fused(active.dev, wire, plan["n_levels"])

        def materialize() -> ClassifyOutput:
            res16, stats = torchpath.split_wire_outputs(fused.cpu().numpy(), n)
            stats_delta = torchpath.merge_stats_host(stats)
            if apply_stats:
                self._stats.add(stats_delta)
            results, xdp = torchpath.host_finalize_wire(res16, plan["kind"])
            return ClassifyOutput(results=results, xdp=xdp, stats_delta=stats_delta)

        return PendingClassify(materialize)

    def _classify_async_wide(
        self, tt: walk.TrieTables, batch: PacketBatch, apply_stats: bool
    ) -> PendingClassify:
        """u32 results for tables whose ruleIds exceed the wire result's 8
        bits: the whole batch goes in, and results, verdicts and stats come
        back in one read."""
        res, xdp, stats = walk.classify_walk(
            tt, torchpath.device_batch(batch, self._device), tt.n_levels
        )
        fused = torch.cat([res, xdp, stats.reshape(-1)])
        b = len(batch)

        def materialize() -> ClassifyOutput:
            host = fused.cpu().numpy()
            stats_delta = torchpath.merge_stats_host(host[2 * b:].reshape(-1, torchpath.STATS_COLS))
            if apply_stats:
                self._stats.add(stats_delta)
            return ClassifyOutput(results=host[:b].view(np.uint32), xdp=host[b : 2 * b],
                                  stats_delta=stats_delta)

        return PendingClassify(materialize)

    # -- accessors / lifecycle ---------------------------------------------

    @property
    def stats(self) -> StatsAccumulator:
        return self._stats

    @property
    def tables(self) -> Optional[CompiledTables]:
        return self._tables

    @property
    def active_path(self) -> Optional[str]:
        with self._lock:
            return None if self._active is None else self._active.path

    def close(self) -> None:
        """Release the device tables."""
        with self._lock:
            self._active = None
            self._tables = None
            self._depth_steer = None
            self._closed = True
