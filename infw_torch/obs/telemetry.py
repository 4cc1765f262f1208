"""The telemetry plane on the card: the decimated summarizer and the
serving-path tracing.

The counterpart of the JAX package's ``infw/obs/telemetry.py``.  The
per-packet deny-event stream collapses at replay scale, so the counting
runs on the card beside the verdicts (kernel K9, kernels/sketch.py) and
the host reads one small snapshot per N admissions (the decimated drain),
never per packet: the (D, W) count-min rows, the K-slot heavy-hitter
table and the per-tenant counters.

- ``TelemetryTier``: owner of the device SketchState (int32 tensors
  updated in place, so the resident step's CUDA graphs keep their
  addresses): the classic path's update launch (one K9 launch per
  admission, no read back), the exchange the resident step makes under
  this tier's lock, the optional bit-exact HostSketchModel mirror, and the
  drain (snapshot + in-place reset under one lock, ordered after every
  launch before it, so every count lands in exactly one window and every
  summary carries a gap-free ``seq``).
- ``summarize_snapshot``: per-tenant top-talker / deny-storm / SYN-rate
  summary records from one snapshot, pushed on the event ring; raw
  deny-event export decimates through a per-tenant ``TokenBucket``.
- ``SpanTracer`` / ``SpanHistograms``: per-stage serving-path span clocks
  (ingest -> pack -> h2d -> dispatch -> materialize -> drain) exported as
  Prometheus histograms on /metrics plus a sampled ``TraceSpanRecord`` on
  the ring for slow admissions.

Device order: every launch on the state (classic update, the resident
step's K9, the drain's copies and reset) runs under the tier's lock, and
a launch from a stream other than the previous one's first waits on that
launch's event (the flow tier's discipline).  Lock nesting: the flow
tier's lock may be held when this lock is taken, never the reverse.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..kernels import sketch as ksketch
from ..kernels.sketch import HostSketchModel, SketchSpec, SketchState
from ..kernels.torchpath import resolve_device
from .events import TelemetrySummaryRecord, TraceSpanRecord

__all__ = [
    "AdmissionTrace", "SketchOps", "SketchSnapshot", "SpanHistograms", "SpanTracer",
    "TelemetrySummaryRecord", "TelemetryTier", "TokenBucket", "TraceSpanRecord",
    "summarize_snapshot",
]


# --- token-bucket sampling ---------------------------------------------------------


class TokenBucket:
    """Deterministic token bucket (rate tokens/s, ``burst`` cap).
    ``take(n, now)`` grants min(n, available): the raw-event sampler's
    budget is a ceiling, never a target; time is injected so tests drive
    it deterministically."""

    def __init__(self, rate: float, burst: float) -> None:
        self.rate = float(rate)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._last: Optional[float] = None
        self._lock = threading.Lock()

    def take(self, n: int, now: Optional[float] = None) -> int:
        if now is None:
            now = time.monotonic()
        with self._lock:
            if self._last is not None and now > self._last:
                self._tokens = min(self.burst, self._tokens + (now - self._last) * self.rate)
            self._last = now
            grant = min(int(n), int(self._tokens))
            if grant > 0:
                self._tokens -= grant
            return max(grant, 0)


# --- the summarizer ------------------------------------------------------------------


class SketchSnapshot(NamedTuple):
    """One drained window's host copies."""

    seq: int
    admissions: int
    cms: np.ndarray
    keys: np.ndarray
    cnt: np.ndarray
    tcnt: np.ndarray


def _format_src(keys_row: np.ndarray) -> str:
    kind = (int(keys_row[5]) >> 8) & 3
    if kind == 1:
        return ".".join(str(b) for b in int(keys_row[1]).to_bytes(4, "big"))
    import ipaddress

    return str(ipaddress.IPv6Address(keys_row[1:5].astype(">u4").tobytes()))


def summarize_snapshot(snap: SketchSnapshot, *, top_n: int = 8,
                       deny_storm_frac: float = 0.5, syn_flood_frac: float = 0.5,
                       min_packets: int = 64) -> TelemetrySummaryRecord:
    """The drain window's summary record from one snapshot: the exact
    per-tenant counts (tcnt) drive the deny-storm / SYN-flood flags; the
    heavy-hitter table (sorted by estimated count, stable on slot order
    for deterministic ties) becomes the top-talker list."""
    from ..constants import ALLOW, DENY

    rec = TelemetrySummaryRecord(seq=snap.seq, admissions=snap.admissions)
    for t in np.nonzero(snap.tcnt[:, 0] > 0)[0]:
        pkts, allow, deny, syn = (int(x) for x in snap.tcnt[t])
        rec.tenants.append({
            "tenant": int(t), "packets": pkts, "allow": allow, "deny": deny, "syn": syn,
            "deny_storm": pkts >= min_packets and deny >= deny_storm_frac * pkts,
            "syn_flood": pkts >= min_packets and syn >= syn_flood_frac * pkts,
        })
    occ = np.nonzero(snap.cnt > 0)[0]
    order = occ[np.argsort(-snap.cnt[occ], kind="stable")][:top_n]
    for slot in order:
        row = snap.keys[slot]
        act = int(row[5]) & 0xFF
        rec.top.append({
            "tenant": int(row[0]),
            "src": _format_src(row),
            "verdict": {DENY: "deny", ALLOW: "allow"}.get(act, f"act{act}"),
            "count": int(snap.cnt[slot]),
            "slot": int(slot),
        })
    return rec


# --- the device tier -----------------------------------------------------------------


class SketchOps(NamedTuple):
    """What the resident step gets from the tier: the state, K9's winner
    scratch and the geometry."""

    state: SketchState
    winner: torch.Tensor
    spec: SketchSpec


class TelemetryTier:
    """Host-side owner of the device telemetry plane (see the module
    docstring)."""

    def __init__(self, spec: SketchSpec, device=None, track_model: bool = False,
                 drain_every: int = 256, sample_rate: float = 128.0,
                 sample_burst: float = 256.0, ring=None) -> None:
        self.spec = spec
        self._device = resolve_device(device)
        self._lock = threading.Lock()
        self._state = ksketch.zero_state(spec, self._device)
        self._winner = ksketch.empty_winner(spec, self._device)
        self.model = HostSketchModel(spec) if track_model else None
        #: pending model mirrors in device order: resident entries hold
        #: their dispatch's output handle; replay drains the head as
        #: results materialize
        self._mirror_q: list = []
        self.drain_every = int(drain_every)
        self._admissions = 0
        self._window_admissions = 0
        self._drain_seq = 0
        self._ring = ring
        self._sample_rate = float(sample_rate)
        self._sample_burst = float(sample_burst)
        self._buckets: Dict[int, TokenBucket] = {}
        self._zeros_cache: Dict[int, tuple] = {}
        # (event, stream) of the last launch on a card
        self._last = None
        self.counters = {
            "updates": 0, "drains": 0, "summaries": 0,
            "sampled_events": 0, "suppressed_events": 0,
        }
        #: summary knobs (summarize_snapshot)
        self.top_n = 8
        self.deny_storm_frac = 0.5
        self.syn_flood_frac = 0.5
        self.min_packets = 64

    # -- plumbing ------------------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self._device

    def attach_ring(self, ring) -> None:
        with self._lock:
            self._ring = ring

    def _put(self, a: np.ndarray) -> torch.Tensor:
        """A blocking copy to the device (every stream reads it)."""
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy()).to(self._device)

    def _zeros(self, b: int):
        """Under the lock: the zero tenant and flags columns of ``b`` lanes."""
        z = self._zeros_cache.get(b)
        if z is None:
            zero = np.zeros(b, np.int32)
            z = (self._put(zero), self._put(zero))
            self._zeros_cache[b] = z
        return z

    def _ordered(self):
        """Under the lock, before a launch: order it after the previous one
        when that ran on another stream.  Returns the stream to record on
        (None off the card)."""
        if self._device.type != "cuda":
            return None
        cur = torch.cuda.current_stream(self._device)
        if self._last is not None and self._last[1] != cur:
            cur.wait_event(self._last[0])
        return cur

    def _record(self, stream) -> None:
        if stream is not None:
            ev = torch.cuda.Event()
            ev.record(stream)
            self._last = (ev, stream)

    def _note(self, key: str, n: int = 1) -> None:
        self.counters[key] = self.counters.get(key, 0) + n

    # -- updates ---------------------------------------------------------------------

    def update(self, wire_np: np.ndarray, res: np.ndarray,
               tenant_np: Optional[np.ndarray] = None,
               tflags_np: Optional[np.ndarray] = None) -> None:
        """The multi-dispatch path's telemetry launch: one K9 launch per
        admission over (wire, served verdicts), no read back; called at
        materialize time, when the verdicts exist on the host."""
        b = wire_np.shape[0]
        wire = self._put(np.asarray(wire_np, np.uint32))
        res_dev = self._put(np.asarray(res, np.uint32))
        tenant = None if tenant_np is None else self._put(np.asarray(tenant_np, np.int32))
        tflags = None if tflags_np is None else self._put(np.asarray(tflags_np, np.int32))
        with self._lock:
            if tenant is None or tflags is None:
                zt, zf = self._zeros(b)
                tenant = zt if tenant is None else tenant
                tflags = zf if tflags is None else tflags
            stream = self._ordered()
            ksketch.sketch_update(self._state, wire, tenant, tflags, res_dev, self.spec,
                                  winner=self._winner)
            self._record(stream)
            self._admissions += 1
            self._window_admissions += 1
            self._note("updates")
            if self.model is not None:
                self._mirror_q.append(
                    (np.asarray(wire_np, np.uint32).copy(),
                     None if tenant_np is None else np.asarray(tenant_np, np.int32).copy(),
                     None if tflags_np is None else np.asarray(tflags_np, np.int32).copy(),
                     np.asarray(res, np.uint32).copy(), None))
                self._replay_ready_locked()
        self.maybe_drain()

    def resident_exchange(self, launch: Callable, wire_np, tenant_np, tflags_np, k: int = 0):
        """The resident step's turn on the state: ``launch(SketchOps)`` runs
        under this tier's lock (the caller holds the flow tier's), so the
        step's K9 lands in device order with every other update; it returns
        the dispatch's output handle.  ``k`` > 0 is a superbatch of ``k``
        admissions (``wire_np`` (k, b, W)).  With the model mirror each
        admission queues its wire and the handle (and row) its verdicts
        come from, replayed once it materializes."""
        steps = max(int(k), 1)
        with self._lock:
            stream = self._ordered()
            handle = launch(SketchOps(self._state, self._winner, self.spec))
            self._record(stream)
            self._admissions += steps
            self._window_admissions += steps
            self._note("updates", steps)
            if self.model is not None:
                wires = np.asarray(wire_np, np.uint32)
                for j in range(steps):
                    pick = (lambda a: None if a is None else np.asarray(
                        a[j] if k else a, np.int32).copy())
                    self._mirror_q.append(((wires[j] if k else wires).copy(), pick(tenant_np),
                                           pick(tflags_np), None, (handle, j if k else None)))
        return handle

    def _replay_ready_locked(self) -> None:
        """Drain the mirror queue's head in device order.  A resident
        entry's verdicts are in its dispatch's output (or its row of a
        superbatch's); reading it waits for the dispatch, which is already
        enqueued, and keeps classic entries behind it in order."""
        from ..kernels.resident import split_resident_outputs

        while self._mirror_q:
            wire, tenant, tflags, res, fused = self._mirror_q[0]
            if res is None:
                handle, row = fused
                arr = handle.host()
                res16, _hit, _h, _s, _c = split_resident_outputs(
                    arr if row is None else arr[row], wire.shape[0])
                res = res16.astype(np.uint32)
            self.model.update(wire, res, tenant, tflags)
            self._mirror_q.pop(0)

    def resident_note_materialized(self, epoch: int) -> None:
        """Materialize hook of a resident admission: replay the pending
        model mirrors (track_model only) and run the drain cadence check
        (the exchange only counts the window)."""
        if self.model is not None:
            with self._lock:
                self._replay_ready_locked()
        self.maybe_drain()

    # -- the decimated drain ---------------------------------------------------------

    def maybe_drain(self) -> List[TelemetrySummaryRecord]:
        """Drain when the cadence is due (one small read back per
        ``drain_every`` admissions, never per packet)."""
        with self._lock:
            due = self._window_admissions >= self.drain_every
        return self.drain() if due else []

    def drain(self, force: bool = True) -> List[TelemetrySummaryRecord]:
        """Snapshot and reset the state and emit the window's summary on the
        attached ring.  Snapshot and reset run under the lock, after every
        launch before them and before every launch after them, atomically
        with the admission counters: every admission's counts land in
        exactly one window, every window drains once, and ``seq`` has no
        gaps."""
        with self._lock:
            if not force and self._window_admissions < self.drain_every:
                return []
            if self.model is not None:
                self._replay_ready_locked()
            stream = self._ordered()
            host = ksketch.state_to_host(self._state)
            snap = SketchSnapshot(seq=self._drain_seq + 1, admissions=self._window_admissions,
                                  cms=host["cms"], keys=host["keys"], cnt=host["cnt"],
                                  tcnt=host["tcnt"])
            ksketch.sketch_clear(self._state)
            self._record(stream)
            if self.model is not None:
                self.model.clear()
            self._drain_seq += 1
            self._window_admissions = 0
            self._note("drains")
            # summarize and publish inside the lock: ring consumers see
            # records in seq order even when drains race
            rec = summarize_snapshot(snap, top_n=self.top_n,
                                     deny_storm_frac=self.deny_storm_frac,
                                     syn_flood_frac=self.syn_flood_frac,
                                     min_packets=self.min_packets)
            self._note("summaries")
            if self._ring is not None:
                self._ring.push(rec)
        return [rec]

    # -- raw-event sampling ----------------------------------------------------------

    def sample_allow(self, tenant: int, n: int, now: Optional[float] = None) -> int:
        """How many of ``n`` raw deny events ``tenant`` may export now (the
        per-tenant token bucket); suppressed counts go to /metrics, the
        totals are always exact in the summaries."""
        with self._lock:
            bucket = self._buckets.get(int(tenant))
            if bucket is None:
                bucket = TokenBucket(self._sample_rate, self._sample_burst)
                self._buckets[int(tenant)] = bucket
        grant = bucket.take(n, now)
        with self._lock:
            self._note("sampled_events", grant)
            self._note("suppressed_events", int(n) - grant)
        return grant

    # -- introspection ---------------------------------------------------------------

    def columns(self) -> Dict[str, np.ndarray]:
        """Host copies of the state (``keys`` as uint32), read in device
        order under the lock."""
        with self._lock:
            self._ordered()
            return ksketch.state_to_host(self._state)

    @property
    def drain_seq(self) -> int:
        with self._lock:
            return self._drain_seq

    def counter_values(self) -> Dict[str, int]:
        """telemetry_* counters for /metrics."""
        with self._lock:
            out = {f"telemetry_{k}_total": int(v) for k, v in self.counters.items()}
            out["telemetry_admissions_total"] = self._admissions
            out["telemetry_drain_seq"] = self._drain_seq
            out["telemetry_window_admissions"] = self._window_admissions
        return out


# --- serving-path tracing ------------------------------------------------------------

#: the span taxonomy, in serving order: ingest (file read), pack (parse,
#: wire pack, encode), h2d (prepare_packed: the plan and its copy in),
#: dispatch (the launch), materialize (read back + host finalize), drain
#: (verdicts out, events, statistics)
SPAN_STAGES = ("ingest", "pack", "h2d", "dispatch", "materialize", "drain")

#: log2 bucket upper bounds in microseconds: 1 us .. ~1.05 s, +Inf
SPAN_BUCKETS_US = tuple(float(1 << i) for i in range(21))


class SpanHistograms:
    """Fixed-bucket per-stage latency histograms in the Prometheus
    histogram exposition, registered weakly in the metrics registry
    (obs.statistics.Registry.register_histograms)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        nb = len(SPAN_BUCKETS_US) + 1
        self._counts = {s: np.zeros(nb, np.int64) for s in SPAN_STAGES}
        self._sums_us = {s: 0.0 for s in SPAN_STAGES}
        self._totals = {s: 0 for s in SPAN_STAGES}

    def observe(self, stage: str, us: float) -> None:
        if stage not in self._counts:
            return
        us = max(float(us), 0.0)
        i = int(np.searchsorted(SPAN_BUCKETS_US, us))
        with self._lock:
            self._counts[stage][i] += 1
            self._sums_us[stage] += us
            self._totals[stage] += 1

    def values(self) -> Dict[str, dict]:
        with self._lock:
            return {
                s: {"count": int(self._totals[s]), "sum_us": float(self._sums_us[s]),
                    "buckets": self._counts[s].copy()}
                for s in SPAN_STAGES
            }

    def render_histograms(self) -> str:
        """Prometheus histogram text: one series per stage under
        ingressnodefirewall_node_span_us{stage=...}."""
        name = "ingressnodefirewall_node_span_us"
        out = [
            f"# HELP {name} Serving-path span latency by stage (microseconds)",
            f"# TYPE {name} histogram",
        ]
        vals = self.values()
        for s in SPAN_STAGES:
            v = vals[s]
            cum = 0
            for le, c in zip(SPAN_BUCKETS_US, v["buckets"]):
                cum += int(c)
                out.append(f'{name}_bucket{{stage="{s}",le="{le:g}"}} {cum}')
            cum += int(v["buckets"][-1])
            out.append(f'{name}_bucket{{stage="{s}",le="+Inf"}} {cum}')
            out.append(f'{name}_sum{{stage="{s}"}} {v["sum_us"]:.0f}')
            out.append(f'{name}_count{{stage="{s}"}} {v["count"]}')
        return "\n".join(out) + "\n"


class AdmissionTrace:
    """Span clock of one admission: ``mark(stage)`` charges the time since
    the previous mark to ``stage``; ``add`` charges a measured interval."""

    __slots__ = ("spans_us", "_t_last", "t0", "n_packets")

    def __init__(self, n_packets: int = 0) -> None:
        self.t0 = time.perf_counter()
        self._t_last = self.t0
        self.spans_us: Dict[str, float] = {}
        self.n_packets = int(n_packets)

    def mark(self, stage: str) -> None:
        now = time.perf_counter()
        self.spans_us[stage] = self.spans_us.get(stage, 0.0) + (now - self._t_last) * 1e6
        self._t_last = now

    def add(self, stage: str, dt_s: float) -> None:
        self.spans_us[stage] = self.spans_us.get(stage, 0.0) + float(dt_s) * 1e6
        self._t_last = time.perf_counter()

    @property
    def total_us(self) -> float:
        return sum(self.spans_us.values())


class SpanTracer:
    """The serving-path tracer: histograms for the population,
    token-bucket-sampled TraceSpanRecords for slow admissions."""

    def __init__(self, ring=None, histograms: Optional[SpanHistograms] = None,
                 slow_us: float = 50_000.0, sample_rate: float = 4.0,
                 sample_burst: float = 16.0) -> None:
        self.histograms = histograms or SpanHistograms()
        self._ring = ring
        self.slow_us = float(slow_us)
        self._bucket = TokenBucket(sample_rate, sample_burst)
        self._lock = threading.Lock()
        self.counters = {"traces": 0, "slow_sampled": 0, "slow_suppressed": 0}

    def attach_ring(self, ring) -> None:
        with self._lock:
            self._ring = ring

    def begin(self, n_packets: int = 0) -> AdmissionTrace:
        return AdmissionTrace(n_packets)

    def finish(self, trace: AdmissionTrace, now: Optional[float] = None) -> None:
        for stage, us in trace.spans_us.items():
            self.histograms.observe(stage, us)
        total = trace.total_us
        with self._lock:
            self.counters["traces"] += 1
            ring = self._ring
        if total >= self.slow_us:
            if self._bucket.take(1, now):
                with self._lock:
                    self.counters["slow_sampled"] += 1
                if ring is not None:
                    ring.push(TraceSpanRecord(total_us=total, n_packets=trace.n_packets,
                                              spans_us=dict(trace.spans_us)))
            else:
                with self._lock:
                    self.counters["slow_suppressed"] += 1

    def counter_values(self) -> Dict[str, int]:
        with self._lock:
            return {f"trace_{k}_total": int(v) for k, v in self.counters.items()}
