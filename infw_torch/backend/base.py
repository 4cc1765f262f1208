"""Classifier outputs, in-flight handles and the statistics accumulator.

The runtime contract of a dataplane backend, in the role of the loaded XDP
program and its maps (pkg/ebpf/ingress_node_firewall_loader.go:43-50):
rules are loaded, packets are classified, statistics accumulate until
reset.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..constants import MAX_TARGETS


@dataclass
class ClassifyOutput:
    """Per-batch outputs: packed u32 results, XDP verdicts, and the batch's
    statistics increment (MAX_TARGETS, 4) int64 [allow_pkts, allow_bytes,
    deny_pkts, deny_bytes]."""

    results: np.ndarray
    xdp: np.ndarray
    stats_delta: np.ndarray


class PendingClassify:
    """Handle to an in-flight classification: the device work is enqueued
    but the outputs are not yet on the host.  ``result()`` blocks until
    they are and applies the stats increment exactly once."""

    def __init__(self, materialize) -> None:
        self._materialize = materialize
        self._out: Optional[ClassifyOutput] = None

    def result(self) -> ClassifyOutput:
        if self._out is None:
            self._out = self._materialize()
            self._materialize = None  # drop device refs
        return self._out


class StatsAccumulator:
    """Host-side equivalent of the per-CPU statistics map
    (bpf/ingress_node_firewall_kernel.c:36-41): accumulates per-ruleId
    counters until the dataplane is reset."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._stats = np.zeros((MAX_TARGETS, 4), np.int64)

    def add(self, delta: np.ndarray) -> None:
        with self._lock:
            self._stats += delta

    def snapshot(self) -> np.ndarray:
        with self._lock:
            return self._stats.copy()

    def reset(self) -> None:
        with self._lock:
            self._stats[:] = 0
