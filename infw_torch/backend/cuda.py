"""Single-GPU classifier backend (the dense path).

The counterpart of the JAX package's TpuClassifier for tables of at most
MAX_DENSE_TARGETS entries: compiled rule tables live on the card, each
batch is packed into the wire format on the host, copied in once, unpacked
and classified by kernel K1 (kernels/dense.py), and read back once as one
int32 buffer of results and statistics.

- **table swap**: the next tables are packed and uploaded outside the lock;
  the swap is one reference assignment under it, so batches in flight
  finish on the tables they were launched against.
- **asynchronous launch**: classify_async() enqueues the copy and the
  kernels on the current CUDA stream and returns a PendingClassify; the
  device-to-host read happens in .result().
- statistics accumulate on the host in int64 from each batch's (1024, 6)
  int32 sums, applied exactly once when a batch materializes.

The device is the first CUDA card unless the caller names another
(``device="cpu"`` runs the plain PyTorch version of every kernel, which is
what the CPU tests do).  There is no silent fallback to the CPU.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from ..compiler import CompiledTables
from ..constants import KIND_IPV6
from ..kernels import dense, torchpath
from ..packets import PacketBatch, narrow_wire
from .base import ClassifyOutput, PendingClassify, StatsAccumulator

#: where the paths this backend does not serve yet are queued
TRIE_PATH_ITEM = "ROADMAP.md 'Slice 2: the trie path and K2'"


class TorchClassifier:
    """Single-device classifier on the dense path."""

    def __init__(self, device=None) -> None:
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "TorchClassifier: no CUDA device; pass device='cpu' to run "
                    "the plain PyTorch version on the CPU"
                )
            device = "cuda:0"
        self._device = torch.device(device)
        if self._device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"TorchClassifier: {self._device} requested but CUDA is unavailable")
        self._lock = threading.Lock()
        self._stats = StatsAccumulator()
        self._tables: Optional[CompiledTables] = None
        self._active: Optional[dense.DenseTables] = None
        self._closed = False

    @property
    def device(self) -> torch.device:
        return self._device

    def load_tables(self, tables: CompiledTables,
                    overlay: Optional[CompiledTables] = None) -> None:
        """Swap in a newly compiled ruleset (a full upload).  Raises
        NotImplementedError for tables only the trie path serves and
        ValueError for an overlay, which the dense path cannot combine."""
        if self._closed:
            raise RuntimeError("classifier is closed")
        if overlay is not None and overlay.num_entries > 0:
            raise ValueError(
                "overlay not supported on path=dense; merge it into the main table"
            )
        try:
            dt = dense.build_dense_tables(tables, self._device)
        except ValueError as e:
            # the dense packing's limits (entries, rule width, ruleId) are
            # checked there, once; what exceeds them is the trie path's
            raise NotImplementedError(f"{e}; the trie path is {TRIE_PATH_ITEM}") from e
        with self._lock:
            self._tables = tables
            self._active = dt

    def classify_async(
        self, batch: PacketBatch, apply_stats: bool = True
    ) -> PendingClassify:
        """Enqueue the host-to-device copy and the kernels; return a handle
        whose .result() reads back and applies the stats increment once.
        ``apply_stats=False`` leaves the accumulator to the caller."""
        with self._lock:
            if self._active is None:
                raise RuntimeError("no rule tables loaded")
            dt = self._active
        # Packed wire: 16 B/packet for v4-only chunks, 28 B otherwise, one
        # word less when narrow_wire qualifies the chunk.
        kind = np.asarray(batch.kind)
        v4_only = not bool((kind == KIND_IPV6).any())
        compact = v4_only and not bool(np.asarray(batch.ip_words)[:, 1:].any())
        wire_np = batch.pack_wire_v4() if compact else batch.pack_wire()
        narrow = narrow_wire(wire_np)
        if narrow is not None:
            wire_np = narrow
        n = wire_np.shape[0]
        wire = torch.from_numpy(np.ascontiguousarray(wire_np).view(np.int32)).to(self._device)
        fused = dense.classify_dense_wire_fused(dt, wire)

        def materialize() -> ClassifyOutput:
            res16, stats = torchpath.split_wire_outputs(fused.cpu().numpy(), n)
            stats_delta = torchpath.merge_stats_host(stats)
            if apply_stats:
                self._stats.add(stats_delta)
            results, xdp = torchpath.host_finalize_wire(res16, kind)
            return ClassifyOutput(results=results, xdp=xdp, stats_delta=stats_delta)

        return PendingClassify(materialize)

    def classify(self, batch: PacketBatch, apply_stats: bool = True) -> ClassifyOutput:
        return self.classify_async(batch, apply_stats=apply_stats).result()

    @property
    def stats(self) -> StatsAccumulator:
        return self._stats

    @property
    def tables(self) -> Optional[CompiledTables]:
        return self._tables

    @property
    def active_path(self) -> Optional[str]:
        return "dense" if self._active is not None else None

    def close(self) -> None:
        """Release the device tables."""
        with self._lock:
            self._active = None
            self._tables = None
            self._closed = True
