"""Node-level statistics: poller + Prometheus exposition.

The counterpart of the reference's pkg/metrics
(pkg/metrics/statistics.go): a poller thread reads the
classifier's accumulated per-rule counters every poll period, sums rules
1..MAX_INGRESS_RULES-1 with overflow-checked additions (:112-167,170-181),
and publishes the four node gauges:

    ingressnodefirewall_node_packet_allow_total
    ingressnodefirewall_node_packet_allow_bytes
    ingressnodefirewall_node_packet_deny_total
    ingressnodefirewall_node_packet_deny_bytes

(:18-48).  ``Registry.render_text`` is the /metrics exposition the
daemon serves (the e2e suite parses this exact text format,
test/e2e/functional/tests/e2e.go:1143-1356).

The classifier's StatsAccumulator plays the per-CPU map: per-batch stat
deltas land there on the host, and this poller aggregates across rules —
the same split as kernel per-CPU counters vs userspace aggregation.  The
poller reads only that host accumulator, never a device tensor.
"""
from __future__ import annotations

import logging
import threading
import weakref
from typing import Dict, List, Optional

from .._threads import spawn
from ..failsaferules import MAX_INGRESS_RULES

log = logging.getLogger("infw_torch.obs.statistics")

METRIC_INF_NAMESPACE = "ingressnodefirewall"
METRIC_INF_SUBSYSTEM_NODE = "node"

_U64_MAX = (1 << 64) - 1

_METRICS = [
    ("packet_allow_total",
     "The number of packets which results in an allow IP packet result"),
    ("packet_allow_bytes",
     "The number of bytes for packets which results in an allow IP packet result"),
    ("packet_deny_total",
     "The number of packets which results in a deny IP packet result"),
    ("packet_deny_bytes",
     "The number of bytes for packets which results in an deny IP packet result"),
]


def add_uint64(a: int, b: int):
    """addUInt64 (statistics.go:170-181): returns (value, ok)."""
    c = (a + b) & _U64_MAX
    if a == 0 or b == 0:
        return c, True
    if c > a and c > b:
        return c, True
    return c, False


def _render_exposition(vals: Dict[str, int]) -> str:
    """Prometheus text format for the four node gauges — the ONE place
    the exposition format lives (shared by per-instance and registry
    renders)."""
    out = []
    for name, help_text in _METRICS:
        full = f"{METRIC_INF_NAMESPACE}_{METRIC_INF_SUBSYSTEM_NODE}_{name}"
        out.append(f"# HELP {full} {help_text}")
        out.append(f"# TYPE {full} gauge")
        out.append(f"{full} {vals[name]}")
    return "\n".join(out) + "\n"


class Registry:
    """The metrics.Registry analogue (statistics.go:79-86): Statistics
    collectors register into it and one exposition call renders them all
    (values summed per metric).  Collectors are held by WEAK reference —
    an instance that is registered and then dropped (crash-looped daemon
    constructions, test fixtures) disappears from the exposition with the
    instance instead of inflating sums forever; ``unregister`` remains the
    explicit path."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._refs: List["weakref.ref[Statistics]"] = []
        # counter providers: objects exposing counter_values() ->
        # {short_name: int}, rendered as TYPE counter under the node
        # namespace (the deny-event ring's lost/queued totals)
        self._counter_refs: List["weakref.ref"] = []
        # histogram providers: objects exposing render_histograms() ->
        # pre-rendered Prometheus histogram text (the serving-path span
        # tracer, obs.telemetry.SpanHistograms), weak like the rest
        self._hist_refs: List["weakref.ref"] = []

    def register(self, inst: "Statistics") -> None:
        """Idempotent (regOnce, statistics.go:79-86)."""
        with self._lock:
            self._prune_locked()
            if any(r() is inst for r in self._refs):
                return
            self._refs.append(weakref.ref(inst))

    def register_counters(self, provider) -> None:
        """Register a counter provider (weakly, like collectors)."""
        with self._lock:
            self._counter_refs = [
                r for r in self._counter_refs if r() is not None
            ]
            if any(r() is provider for r in self._counter_refs):
                return
            self._counter_refs.append(weakref.ref(provider))

    def register_histograms(self, provider) -> None:
        """Register a histogram provider (weakly, like collectors);
        idempotent per provider."""
        with self._lock:
            self._hist_refs = [r for r in self._hist_refs if r() is not None]
            if any(r() is provider for r in self._hist_refs):
                return
            self._hist_refs.append(weakref.ref(provider))

    def unregister(self, inst: "Statistics") -> None:
        with self._lock:
            self._refs = [
                r for r in self._refs if r() is not None and r() is not inst
            ]

    def _prune_locked(self) -> None:
        self._refs = [r for r in self._refs if r() is not None]

    def collectors(self) -> List["Statistics"]:
        with self._lock:
            self._prune_locked()
            return [inst for r in self._refs if (inst := r()) is not None]

    def render_text(self) -> str:
        """Combined exposition over every live registered collector —
        what a shared /metrics endpoint serves, matching the reference's
        single metrics.Registry fed by any number of collectors."""
        totals: Dict[str, int] = {name: 0 for name, _ in _METRICS}
        for inst in self.collectors():
            for name, v in inst.values().items():
                totals[name] += v
        out = _render_exposition(totals)
        with self._lock:
            providers = [
                p for r in self._counter_refs if (p := r()) is not None
            ]
        counters: Dict[str, int] = {}
        for p in providers:
            for name, v in p.counter_values().items():
                counters[name] = counters.get(name, 0) + v
        lines = []
        for name in sorted(counters):
            full = f"{METRIC_INF_NAMESPACE}_{METRIC_INF_SUBSYSTEM_NODE}_{name}"
            lines.append(f"# TYPE {full} counter")
            lines.append(f"{full} {counters[name]}")
        out = out + ("\n".join(lines) + "\n" if lines else "")
        with self._lock:
            hists = [h for r in self._hist_refs if (h := r()) is not None]
        for h in hists:
            try:
                out += h.render_histograms()
            except Exception:
                pass
        return out


class Statistics:
    """NewStatistics + Register + Start/StopPoll (statistics.go:61-110).

    Implements the syncer's StatsPoller protocol, so the sync boundary can
    pause polling around table rewrites (ebpfsyncer.go:81-88)."""

    def __init__(self, poll_period_s: float = 30.0) -> None:
        self.poll_period_s = float(poll_period_s)
        self._lock = threading.Lock()
        self._values: Dict[str, int] = {name: 0 for name, _ in _METRICS}
        self._stop: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None
        # Registration state has its own lock, held across BOTH the
        # attribute swap and the Registry membership mutation so the two
        # can never diverge (a register/unregister race could otherwise
        # leave a live member with self._registry already None).  It must
        # not be self._lock: render_text holds the registry lock while
        # calling values() (which takes self._lock) — sharing that lock
        # here would be an ABBA deadlock.
        self._reg_lock = threading.Lock()
        self._registry: Optional[Registry] = None

    # -- registration (regOnce, statistics.go:79-86) -------------------------

    def register(self, registry: Registry) -> None:
        """Register this collector into ``registry``; idempotent per
        registry (regOnce), and registering into another registry moves
        the collector."""
        with self._reg_lock:
            prev, self._registry = self._registry, registry
            if prev is not None and prev is not registry:
                prev.unregister(self)
            registry.register(self)

    def unregister(self) -> None:
        with self._reg_lock:
            prev, self._registry = self._registry, None
            if prev is not None:
                prev.unregister(self)

    # -- polling -------------------------------------------------------------

    def start_poll(self, classifier) -> None:
        with self._lock:
            if self._thread is not None:
                log.info("Metrics are already being polled")
                return
            stop = threading.Event()
            thread = spawn(self._poll_loop, args=(classifier, stop),
                           name="infw-metrics-poll", start=False)
            self._stop, self._thread = stop, thread
            thread.start()

    def stop_poll(self) -> None:
        with self._lock:
            thread, stop = self._thread, self._stop
            self._thread = self._stop = None
        if thread is not None:
            stop.set()
            thread.join()

    def _poll_loop(self, classifier, stop: threading.Event) -> None:
        log.info("Starting node metrics updater")
        while not stop.wait(self.poll_period_s):
            self.update_metrics(classifier)
        log.info("Stopped node metric updates")

    def update_metrics(self, classifier) -> None:
        """updateMetrics (statistics.go:112-167): sum rules
        1..MAX_INGRESS_RULES-1 with overflow checks; gauges are *set* to
        the running totals (counters monotonically grow in the map — here
        in the StatsAccumulator — until dataplane reset)."""
        snap = classifier.stats.snapshot()  # (MAX_TARGETS, 4) int64

        def checked_add(cur: int, inc: int, label: str) -> int:
            result, ok = add_uint64(inc, cur)
            if not ok:
                log.warning("Overflow occurred during addition of %s statistic", label)
                return cur
            return result

        allow_count = allow_bytes = deny_count = deny_bytes = 0
        for rule in range(1, min(MAX_INGRESS_RULES, snap.shape[0])):
            ap, ab, dp, db = (int(x) for x in snap[rule])
            allow_count = checked_add(allow_count, ap, "allow packet")
            allow_bytes = checked_add(allow_bytes, ab, "allow byte")
            deny_count = checked_add(deny_count, dp, "deny packet")
            deny_bytes = checked_add(deny_bytes, db, "deny byte")
        with self._lock:
            self._values["packet_allow_total"] = allow_count
            self._values["packet_allow_bytes"] = allow_bytes
            self._values["packet_deny_total"] = deny_count
            self._values["packet_deny_bytes"] = deny_bytes

    # -- exposition ----------------------------------------------------------

    def values(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._values)
