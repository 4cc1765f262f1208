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


def stats_from_results(results: np.ndarray, pkt_len: np.ndarray) -> np.ndarray:
    """Per-batch statistics from host-resident verdicts, (MAX_TARGETS, 4)
    int64 [allow_pkts, allow_bytes, deny_pkts, deny_bytes], with the device
    accumulation's semantics (kernel.c:361-399: allow and deny only, ruleId
    < MAX_TARGETS).  The wire8 and delta formats never ship pkt_len, so
    their statistics come from here.  No is_ip term: the results of packets
    that are not IP are already zero."""
    action = results & 0xFF
    rid = (results >> 8).astype(np.int64)
    pl = np.asarray(pkt_len, np.int64)
    out = np.zeros((MAX_TARGETS, 4), np.int64)
    for col, act in ((0, 2), (2, 1)):  # ALLOW=2, DENY=1
        m = (action == act) & (rid < MAX_TARGETS)
        if m.any():
            r = rid[m]
            out[:, col] = np.bincount(r, minlength=MAX_TARGETS)[:MAX_TARGETS]
            out[:, col + 1] = np.bincount(
                r, weights=pl[m], minlength=MAX_TARGETS
            )[:MAX_TARGETS].astype(np.int64)
    return out


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
