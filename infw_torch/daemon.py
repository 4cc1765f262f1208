"""The per-node daemon: watch desired state, program the dataplane on the
card, classify ingest traffic, serve metrics, stream deny events.

The counterpart of the JAX package's ``infw.daemon`` for stateless serving,
and like it of the reference daemon binary (cmd/daemon/daemon.go): the env
contract NODE_NAME / NAMESPACE / POLL_PERIOD_SECONDS / ENABLE_LPM_LOOKUP_DBG
(:69-84), loopback-bound metrics and health endpoints (:57-58, ports
39301/39300), the NodeState controller and the statistics poller
(:96-130).

- Desired state arrives through an in-process store watch or a **state
  directory**: ``<state-dir>/nodestates/<node>.json`` holds the NodeState
  CR; deleting the file deletes the CR.
- Packet ingest is file replay: a frames file (``write_frames_file[_v2]``)
  dropped into ``<state-dir>/ingest/`` is classified, its verdicts land in
  ``<state-dir>/out/`` (a u32 sidecar per packet and a JSON summary), and
  its deny events go to ``events.log`` (replay-scale deny sets as 32-byte
  rows in ``deny-events.bin``).
- Rule edits arrive as edit files (``txn.write_edit_file``) dropped into
  ``<state-dir>/edits/``: they queue in a ``txn.TxnBatcher`` and flush as
  one folded patch transaction (``DataplaneSyncer.apply_edit_transaction``)
  when the oldest edit is older than ``--patch-staleness-us`` or
  ``--patch-max-ops`` edits wait.  The flush runs on its own thread, at
  most one at a time, between the ingest tick's admissions and on the
  file loop; counters go to /metrics (``patch_txn_*``), one
  ``patch-txn:`` line per flush to ``events.log``.
- The classifier is ``TorchClassifier``: on the first CUDA card by default
  (``--backend cuda``; no card raises at start, there is no fallback), or
  the plain PyTorch versions on the CPU when ``--backend cpu`` is asked
  for.  Its classify kernels (K1 dense, K2 trie, K3 ctrie, K4 delta
  decode) are launched and read back on the file-loop thread alone; a
  table load runs on the thread that syncs (the file loop for the state
  dir, the writer's for the in-process store) or on the edit-flush
  thread; the HTTP and statistics threads read only host counters.  A
  load swaps the generation under the classifier's lock, and a job holds
  the one it snapshotted: a flush landing between ``prepare_packed`` and
  ``classify_prepared`` leaves that job on the old tables.
- ``ENABLE_LPM_LOOKUP_DBG`` fills a bounded key buffer served at
  ``/debug/lookup-keys`` (the debug hash map, kernel.c:59-64,214-216).
- ``--tenants N`` (``INFW_TENANTS``) adds the multi-tenant arena: one
  preallocated ctrie pool of N tenant ids on the daemon's device
  (``syncer.TenantRegistry`` over ``TorchArenaClassifier``, kernel K3b),
  slab geometry from ``INFW_TENANT_SLAB_ENTRIES`` (1024) and
  ``INFW_TENANT_RULE_SLOTS`` (16).  A tenant is created, empty, when
  ``<state-dir>/tenants/<name>/edits/`` first appears on the file loop;
  each edit file there applies as one folded transaction of that tenant
  (the same codec as ``edits/``); a dedup sweep every 5 s re-merges slabs
  whose content re-converged; ``tenant_*`` counters go to /metrics and
  ``tenant-*`` lines to ``events.log``.

- ``--flow-table N`` (``INFW_FLOW_TABLE``; ways from ``INFW_FLOW_WAYS``,
  the freshness horizon from ``INFW_FLOW_MAX_AGE``) adds the stateful flow
  tier (infw_torch.flow, kernels K7 and K8) to every classifier the syncer
  builds and to the ``--tenants`` arena: established flows serve their
  cached verdict and only the misses are classified.  ``flow_*`` counters
  (``tenant_flow_*`` for the arena) go to /metrics, ``flow-evict:`` lines
  to ``events.log``, and the idle loop sweeps aged entries every 5 s.
  Frames files carry no TCP flags, so their packets probe with flags 0, as
  in the JAX daemon.

- ``--resident`` (``INFW_RESIDENT``; not with ``--backend cpu``, as in the
  JAX daemon) serves each job through the resident step
  (infw_torch/resident.py): one copy in, one CUDA graph of K7, the
  classify of every lane, the merge and K8, and one read back.  It implies
  a flow table (the default geometry without ``--flow-table``);
  ``resident_*`` and ``flow_*`` counters go to /metrics.

- ``--telemetry [WIDTH]`` (``INFW_TELEMETRY``; depth and top-K from
  ``INFW_TELEMETRY_DEPTH`` / ``INFW_TELEMETRY_TOPK``; not with ``--backend
  cpu``, as in the JAX daemon) adds the telemetry plane
  (infw_torch.obs.telemetry, kernel K9) to every classifier the syncer
  builds: count-min, heavy-hitter and per-tenant counters on the card,
  updated in the resident step or by one K9 launch per job.  The idle
  loop attaches the event ring and ``--telemetry-drain`` (admissions a
  drain, ``INFW_TELEMETRY_DRAIN``, 256) to each new tier and drains
  every 5 s when a window is open; ``telemetry-summary`` lines go to
  ``events.log``, ``telemetry_*`` counters to /metrics, and raw deny
  events pass a per-tenant token bucket (the rest count as
  ``telemetry_suppressed_events``).
- ``--trace`` (``INFW_TRACE``) times each job's serving stages, the JAX
  daemon's names: ``ingest`` (file read) and ``pack`` (frame parse) per
  file, then per job ``pack`` (gather and wire pack), ``h2d``
  (prepare_packed), ``dispatch`` (the launch), ``materialize`` (the read
  back) and ``drain`` (verdicts out, finalize); the histograms
  (``ingressnodefirewall_node_span_us``) and ``trace_*`` counters go to
  /metrics, and a job slower than ``--trace-slow-us``
  (``INFW_TRACE_SLOW_US``, 50000) leaves a sampled ``trace-span:`` line
  in ``events.log``.

- ``--mlscore [MODEL]`` (``INFW_MLSCORE``; not with ``--backend cpu``, as
  in the JAX daemon) adds the anomaly-scoring tier (infw_torch.mlscore,
  kernel K10) to every classifier the syncer builds: the built-in forest,
  or the versioned artifact MODEL (``.npz`` + ``.json`` manifest,
  ``mlscore.save_model``); ``--mlscore-mode shadow|enforce``
  (``INFW_MLSCORE_MODE``, shadow; enforce without ``--mlscore`` is a usage
  error).  The idle loop attaches the event ring to each new tier, drains
  every 5 s when a window is open (``anomaly-verdict`` lines in
  ``events.log``) and hot-swaps complete npz + manifest pairs dropped into
  ``<state-dir>/models/`` (consumed; bad pairs consumed and logged; the
  last swapped model is applied again to a rebuilt classifier);
  ``mlscore_*`` counters go to /metrics.

- ``--payload [default | N | ARTIFACT]`` (``INFW_PAYLOAD``; not with
  ``--backend cpu``, as in the JAX daemon) adds the payload tier
  (infw_torch.payload, kernel K11) to every classifier the syncer builds:
  32 seeded signature patterns (``default``), N of them, or the versioned
  artifact (``.npz`` + ``.json`` manifest, ``payload.save_patterns``);
  ``--payload-mode shadow|enforce`` (``INFW_PAYLOAD_MODE``, shadow; enforce
  without ``--payload`` is a usage error); ``--payload-plen 64|128``
  (``INFW_PAYLOAD_PLEN``; default 64 or the artifact's width).  The idle
  loop hot-swaps complete npz + manifest pairs dropped into
  ``<state-dir>/patterns/`` (consumed; bad pairs consumed and logged; the
  last swapped set is applied again to a rebuilt classifier);
  ``payload_*`` counters go to /metrics.  The frames files carry no
  payload bytes, so the tier matches nothing there: the daemon serves them
  on headers; the ingest ring carries the column.

- ``--ring PATH`` (``INFW_RING``) creates the ingest ring
  (infw_torch.ring) at PATH: ``max(8, 2 * pipeline_depth + 4)`` slots of
  ``max(max_tick_packets, 4096)`` packets, each with room for the TCP
  flags and, with ``--payload``, the payload column.  A producer
  (``python -m infw_torch.tools.loadgen --ring PATH``, or the JAX
  package's) writes packed-wire records in place; the file loop, before
  the frames files, serves the committed records through
  ``prepare_packed`` (flags to K7 and K8, the column to K11), up to
  ``pipeline_depth`` in flight, and releases each slot after its verdicts
  materialized.  ``--superbatch-k K`` (``INFW_SUPERBATCH_K``, 1) lets a
  ``--resident`` daemon stack up to K committed records of one shape into
  one superbatch.  On the card a daemon without ``--resident`` copies each
  popped record once into page-locked memory (``IngestRing.stage_pinned``)
  so its copies to the card are pinned.  ``ring_*`` gauges go to
  /metrics; with ``--trace`` each record's ring spans (ingest = the pop,
  h2d, dispatch, materialize, drain) join the span histograms.

The JAX daemon's scheduler, events socket and mesh options are not in the
port yet: ``main`` refuses each of their flags, naming its ROADMAP item.
"""
from __future__ import annotations

import argparse
import functools
import json
import logging
import mmap
import os
import signal
import struct
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import packets as packets_mod
from ._threads import CRASH_COUNTERS, spawn
from .backend.base import stats_from_results
from .arena import make_arena_spec
from .backend.cuda import WIRE_CODECS, TorchArenaClassifier, TorchClassifier
from .compiler import CompileError
from .constants import DENY, KIND_IPV6, KIND_OTHER
from .flow import FlowConfig
from .interfaces import InterfaceError, InterfaceRegistry, default_registry
from .kernels.torchpath import resolve_device
from .nodestate_controller import NodeStateReconciler
from .kernels.mxu_score import ScoreSpec, default_model
from .kernels.sketch import SketchSpec
from .obs.events import EventRing, EventsLogger, FlowEvictRecord, emit_deny_events
from .obs.pcap import FramesBuf, parse_frames_buf
from .obs.statistics import Registry as MetricsRegistry, Statistics
from .packets import PacketBatch, expand_wire_v4
from .schema import validate_nodestate_schema
from .spec import IngressNodeFirewallNodeState
from .store import InMemoryStore
from .syncer import DataplaneSyncer, SyncError, TenantRegistry
from .txn import DEFAULT_MAX_OPS, DEFAULT_STALENESS_US, TxnBatcher, TxnStats, read_edit_file

log = logging.getLogger("infw_torch.daemon")

DEFAULT_METRICS_PORT = 39301   # cmd/daemon/daemon.go:57
DEFAULT_HEALTH_PORT = 39300    # cmd/daemon/daemon.go:58
DEBUG_MAP_ENTRIES = 16384      # kernel.c:63 debug map max_entries
DEFAULT_INGEST_CHUNK = 1 << 16     # packets per in-flight sub-batch
DEFAULT_PIPELINE_DEPTH = 16        # in-flight classify jobs
DEFAULT_MAX_TICK_PACKETS = 4 << 20   # parse-ahead bound for one ingest tick
#: upcoming jobs packed, encoded and staged (prepare_packed) while earlier
#: jobs' classifies run
H2D_STAGE_DEPTH = 2
BACKENDS = ("cuda", "cpu")

_FRAMES_MAGIC = b"INFW1\n"
_FRAMES_MAGIC2 = b"INFW2\n"

#: the JAX daemon's options that the port does not take yet, and where each
#: is queued: (flag, env variable, ROADMAP item); the environment variable
#: asks for the option when it is set to anything but "", "0", "false" or
#: "no" (INFW_FUSED_DEEP the other way round: "0", "false" or "no" turn the
#: fused walk off, which is what --no-fused-deep asks for)
REFUSED_FLAGS = (
    ("--mesh", "INFW_MESH", "ROADMAP.md item 15 (multi-device)"),
    ("--deadline-us", "INFW_DEADLINE_US", "ROADMAP.md item 24b (the deadline scheduler)"),
    ("--max-batch", "INFW_MAX_BATCH", "ROADMAP.md item 24b (the deadline scheduler)"),
    ("--events-socket", "INFW_EVENTS_SOCKET", "ROADMAP.md item 24d (the events sidecar)"),
    ("--no-fused-deep", "INFW_FUSED_DEEP",
     "ROADMAP.md item 24e (the unfused deep walk)"),
    ("--no-h2d-overlap", "INFW_H2D_OVERLAP",
     "ROADMAP.md item 19 (pinned staging; the copy does not overlap yet)"),
)


# --- frames-file replay format ----------------------------------------------

def write_frames_file(path: str, frames: Sequence[bytes], ifindex) -> None:
    """v1 length-prefixed raw-frame container for ingest replay: per
    record a u32 ingress ifindex + u32 length + frame bytes."""
    if np.isscalar(ifindex):
        ifindex = [int(ifindex)] * len(frames)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_FRAMES_MAGIC)
        f.write(struct.pack("<I", len(frames)))
        for idx, frame in zip(ifindex, frames):
            f.write(struct.pack("<II", int(idx), len(frame)))
            f.write(frame)
    os.replace(tmp, path)


def write_frames_file_v2(path: str, fb: FramesBuf) -> None:
    """v2 columnar container: u32 count, then the ifindex and length
    arrays, then all frame bytes concatenated; three bulk writes (the
    replay-scale format)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_FRAMES_MAGIC2)
        f.write(struct.pack("<I", len(fb)))
        f.write(np.ascontiguousarray(fb.ifindex, "<u4").tobytes())
        f.write(np.ascontiguousarray(fb.lengths, "<u4").tobytes())
        f.write(np.ascontiguousarray(fb.buf).tobytes())
    os.replace(tmp, path)


def read_frames_file(path: str) -> Tuple[List[bytes], List[int]]:
    with open(path, "rb") as f:
        if f.read(len(_FRAMES_MAGIC)) != _FRAMES_MAGIC:
            raise ValueError(f"{path}: not an infw frames file")
        (count,) = struct.unpack("<I", f.read(4))
        frames, ifindexes = [], []
        for _ in range(count):
            idx, length = struct.unpack("<II", f.read(8))
            frames.append(f.read(length))
            ifindexes.append(idx)
    return frames, ifindexes


def read_frames_any(path: str) -> FramesBuf:
    """Read either frames-file version into a FramesBuf.  The v2 frame
    buffer is memory-mapped, not read: the parser faults pages straight
    from the page cache, and the map lives as long as the FramesBuf."""
    with open(path, "rb") as f:
        magic = f.read(len(_FRAMES_MAGIC2))
        if magic == _FRAMES_MAGIC2:
            (count,) = struct.unpack("<I", f.read(4))
            # bound the declared count by the file size before reading: a
            # corrupt header must not ask for gigabytes
            st_size = os.fstat(f.fileno()).st_size
            if 8 * count + f.tell() > st_size:
                raise ValueError(f"{path}: v2 header count {count} exceeds file size")
            ifindex = np.frombuffer(f.read(4 * count), "<u4")
            lengths = np.frombuffer(f.read(4 * count), "<u4")
            payload_off = f.tell()
            total = st_size - payload_off
            if len(lengths) != count or total != int(lengths.astype(np.int64).sum()):
                raise ValueError(f"{path}: truncated v2 frames file")
            if total:
                mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
                buf = np.frombuffer(mm, np.uint8, count=total, offset=payload_off)
            else:
                buf = np.zeros(0, np.uint8)
            return FramesBuf.from_lengths(buf, lengths, ifindex)
    if magic != _FRAMES_MAGIC:
        raise ValueError(f"{path}: not an infw frames file")
    frames, ifindexes = read_frames_file(path)
    return FramesBuf.from_frames(frames, ifindexes)


# --- debug lookup buffer (ENABLE_LPM_LOOKUP_DBG) -----------------------------

class DebugLookupBuffer:
    """Bounded record of the LPM lookup keys the dataplane constructed,
    (ifindex, ip_words) per classified packet, the debug hash map
    (kernel.c:59-64) kept on the host; the oldest keys are overwritten."""

    def __init__(self, capacity: int = DEBUG_MAP_ENTRIES) -> None:
        self._lock = threading.Lock()
        self._buf: deque = deque(maxlen=capacity)

    def record_batch(self, batch: PacketBatch) -> None:
        ifx = np.asarray(batch.ifindex)
        if len(ifx) == 0:
            return
        words = np.asarray(batch.ip_words)
        rows = np.column_stack([ifx.reshape(-1, 1), words.reshape(len(ifx), -1)])
        items = [(r[0], tuple(r[1:])) for r in rows.tolist()]
        with self._lock:
            self._buf.extend(items)

    def snapshot(self) -> List[Tuple[int, Tuple[int, int, int, int]]]:
        with self._lock:
            return list(self._buf)


# --- classifier factory ------------------------------------------------------

def backend_device(backend: str):
    """The device of a backend: "cuda" is the first CUDA card, resolved
    here, so a host without a card fails at start and never at the first
    NodeState; "cpu" runs the plain PyTorch versions, only when asked
    for."""
    if backend == "cuda":
        return resolve_device(None)
    if backend == "cpu":
        return "cpu"
    raise ValueError(f"unknown backend {backend!r} (expected one of {BACKENDS})")


def make_classifier_factory(backend: str, wire_codec: Optional[str] = None,
                            compressed: Optional[bool] = None,
                            flow_table: Optional[FlowConfig] = None,
                            resident: bool = False,
                            telemetry: Optional[SketchSpec] = None,
                            mlscore=None, mlscore_mode: Optional[str] = None,
                            payload=None, payload_mode: Optional[str] = None,
                            payload_plen: Optional[int] = None):
    """The syncer's classifier constructor: TorchClassifier on
    ``backend_device(backend)``.  ``wire_codec`` and ``compressed`` are
    TorchClassifier's (None keeps its INFW_WIRE_CODEC / INFW_COMPRESSED
    defaults); ``flow_table``, a FlowConfig built at launch, rides into
    every classifier generation (on both backends: "cpu" runs the tier on
    the plain versions of K7 and K8); ``resident`` turns the resident pool
    on, ``telemetry``, a SketchSpec, the telemetry plane and ``mlscore``, a
    (ScoreSpec, ScoreModel) pair, the scoring tier in ``mlscore_mode``,
    and ``payload``, a pattern list, AcModel or PayloadTier, the payload
    tier in ``payload_mode`` at ``payload_plen`` (``main`` refuses the four
    with the cpu backend, as the JAX daemon does; the class takes them, for
    the tests)."""
    device = backend_device(backend)
    kw = {}
    if wire_codec is not None:
        kw["wire_codec"] = wire_codec
    if compressed is not None:
        kw["compressed"] = compressed
    if flow_table is not None:
        kw["flow_table"] = flow_table
    if resident:
        kw["resident"] = True
    if telemetry is not None:
        kw["telemetry"] = telemetry
    if mlscore is not None:
        spec, model = mlscore
        kw.update(mlscore=spec, mlscore_model=model, mlscore_mode=mlscore_mode or "shadow")
    if payload is not None:
        kw.update(payload=payload, payload_mode=payload_mode or "shadow")
        if payload_plen is not None:
            kw["payload_plen"] = payload_plen
    return functools.partial(TorchClassifier, device=device, **kw)


class _ResidentCounters:
    """The resident pool's resident_* gauges on /metrics; the getter
    follows the classifier across table loads."""

    def __init__(self, clf_getter) -> None:
        self._get = clf_getter

    def counter_values(self) -> Dict[str, int]:
        clf = self._get()
        return {} if clf is None else clf.resident_counters()


class _TelemetryCounters:
    """The telemetry plane's telemetry_* counters on /metrics; the getter
    follows the classifier across table loads."""

    def __init__(self, clf_getter) -> None:
        self._get = clf_getter

    def counter_values(self) -> Dict[str, int]:
        clf = self._get()
        return {} if clf is None else clf.telemetry_counters()


class _MlScoreCounters:
    """The scoring tier's mlscore_* counters on /metrics; the getter follows
    the classifier across table loads."""

    def __init__(self, clf_getter) -> None:
        self._get = clf_getter

    def counter_values(self) -> Dict[str, int]:
        clf = self._get()
        return {} if clf is None else clf.mlscore_counters()


class _PayloadCounters:
    """The payload tier's payload_* counters on /metrics; the getter follows
    the classifier across table loads."""

    def __init__(self, clf_getter) -> None:
        self._get = clf_getter

    def counter_values(self) -> Dict[str, int]:
        clf = self._get()
        return {} if clf is None else clf.payload_counters()


class _FlowCounters:
    """The flow tier's flow_* counters and gauges on /metrics.  The getter
    follows the classifier across table loads; ``prefix`` keeps the tenant
    arena's tier apart (the registry sums same-named counters)."""

    def __init__(self, clf_getter, prefix: str = "") -> None:
        self._get = clf_getter
        self._prefix = prefix

    def counter_values(self) -> Dict[str, int]:
        clf = self._get()
        if clf is None:
            return {}
        return {f"{self._prefix}{k}": v for k, v in clf.flow_counters().items()}


class _WireStatsCounters:
    """The classifier's per-format host-to-device accounting (wire_stats)
    as /metrics counters, ingressnodefirewall_node_wire_<fmt>_{packets,
    bytes}_total.  The getter follows the syncer's current classifier
    across table loads."""

    def __init__(self, clf_getter) -> None:
        self._get = clf_getter

    def counter_values(self) -> Dict[str, int]:
        clf = self._get()
        if clf is None:
            return {}
        out: Dict[str, int] = {}
        for fmt, (pkts, nbytes) in sorted(clf.wire_stats().items()):
            out[f"wire_{fmt}_packets_total"] = int(pkts)
            out[f"wire_{fmt}_bytes_total"] = int(nbytes)
        return out


def _shape_class(chunk) -> tuple:
    """What a superbatch's records must share: the wire's shape, v4_only,
    whether flags ride along, and the payload column's shape."""
    return (chunk.wire.shape, chunk.v4_only, chunk.tcp_flags is None,
            None if chunk.payload is None else chunk.payload.shape)


# --- daemon ------------------------------------------------------------------

#: the stages process_ingest_once times (seconds, summed over calls):
#: read the file, parse the frames, group the packets into jobs, pack and
#: encode the wire and start its copy (prepare), launch the classify, wait
#: for its read back, and copy the verdicts out and finalize each file
#: (verdicts, summary, stats, events)
STAGES = ("read", "parse", "group", "pack", "launch", "wait", "finalize")


class Daemon:
    def __init__(
        self,
        state_dir: str,
        node_name: str,
        namespace: str = "ingress-node-firewall-system",
        backend: str = "cuda",
        poll_period_s: float = 30.0,
        debug_lookup: bool = False,
        registry: Optional[InterfaceRegistry] = None,
        metrics_port: int = DEFAULT_METRICS_PORT,
        health_port: int = DEFAULT_HEALTH_PORT,
        file_poll_interval_s: float = 0.2,
        ingest_chunk: int = DEFAULT_INGEST_CHUNK,
        pipeline_depth: int = DEFAULT_PIPELINE_DEPTH,
        max_tick_packets: int = DEFAULT_MAX_TICK_PACKETS,
        event_ring_size: int = 1 << 21,
        wire_codec: Optional[str] = None,
        compressed: Optional[bool] = None,
        patch_staleness_us: Optional[float] = None,
        patch_max_ops: Optional[int] = None,
        tenants: Optional[int] = None,
        flow_table: Optional[FlowConfig] = None,
        resident: bool = False,
        telemetry: Optional[SketchSpec] = None,
        telemetry_drain: int = 256,
        trace: bool = False,
        trace_slow_us: float = 50_000.0,
        mlscore=None,
        mlscore_mode: Optional[str] = None,
        payload=None,
        payload_mode: Optional[str] = None,
        payload_plen: Optional[int] = None,
        ring: Optional[str] = None,
        superbatch_k: Optional[int] = None,
    ) -> None:
        # resolve the device first: without a card the default backend
        # fails here, before any directory, thread or file is made
        factory = make_classifier_factory(backend, wire_codec=wire_codec,
                                          compressed=compressed, flow_table=flow_table,
                                          resident=resident, telemetry=telemetry,
                                          mlscore=mlscore, mlscore_mode=mlscore_mode,
                                          payload=payload, payload_mode=payload_mode,
                                          payload_plen=payload_plen)
        self.resident = bool(resident)
        # the telemetry plane (--telemetry): a validated SketchSpec or None;
        # the daemon owns the drain cadence, the summary records on the
        # event ring, the telemetry_* counters and the deny-event sampling
        self.telemetry = telemetry
        self.telemetry_drain = max(1, int(telemetry_drain))
        self._telemetry_attached: set = set()
        self._telemetry_drain_last = 0.0
        # anomaly scoring (--mlscore): a validated (ScoreSpec, ScoreModel) or
        # None; the daemon owns the anomaly-verdict records on the event
        # ring, the mlscore_* counters and the <state-dir>/models/ hot swap
        self.mlscore = mlscore
        self.mlscore_mode = mlscore_mode or "shadow"
        self._mlscore_attached: set = set()
        self._mlscore_drain_last = 0.0
        # the last hot-swapped model (its files consumed), applied again to a
        # rebuilt classifier so a rebuild never reverts to the launch model
        self._mlscore_swapped_model = None
        self.models_dir = os.path.join(state_dir, "models")
        # the payload tier (--payload): a pattern list (or AcModel /
        # PayloadTier) or None; the daemon owns the payload_* counters and
        # the <state-dir>/patterns/ hot swap
        self.payload = payload
        self.payload_mode = payload_mode or "shadow"
        self.payload_plen = payload_plen
        self._payload_attached: set = set()
        # the last hot-swapped set (its files consumed), applied again to a
        # rebuilt classifier: (patterns, plen, version)
        self._payload_swapped = None
        self.patterns_dir = os.path.join(state_dir, "patterns")
        # serving-path tracing (--trace): span histograms on /metrics and
        # sampled TraceSpanRecords for slow jobs
        self.tracer = None
        if trace:
            from .obs.telemetry import SpanTracer

            self.tracer = SpanTracer(slow_us=float(trace_slow_us))
        # the flow tier (--flow-table): a validated FlowConfig or None; the
        # daemon owns its eviction events and the idle-loop age sweep
        self.flow_table = flow_table
        self._flow_attached: set = set()
        self._flow_age_last = 0.0
        self.state_dir = state_dir
        self.node_name = node_name
        self.namespace = namespace
        self.backend = backend
        self.debug_lookup = debug_lookup
        self.file_poll_interval_s = file_poll_interval_s
        self.ingest_chunk = max(1, int(ingest_chunk))
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.max_tick_packets = max(1, int(max_tick_packets))
        self.stage_seconds = dict.fromkeys(STAGES, 0.0)
        self.registry = registry if registry is not None else default_registry
        # the ingest ring (--ring): a shared-memory file producers write
        # packed-wire records into in place (infw_torch.ring); the file
        # loop admits by ring cursor and releases each slot after the
        # dispatch that read it materialized.  With --superbatch-k K >= 2 a
        # resident daemon stacks up to K committed records of one shape
        # class into one superbatch dispatch (K = 1: each record alone)
        if superbatch_k is None:
            superbatch_k = int(os.environ.get("INFW_SUPERBATCH_K", "1") or 1)
        self.superbatch_k = max(1, int(superbatch_k))
        self.ingest_ring = None
        self._ring_inflight: deque = deque()
        if ring:
            from .kernels.wire_decode import PAYLOAD_PREFIX_WIDTHS
            from .ring import IngestRing

            # a payload tier grows each slot by the prefix column (n * (L +
            # 4) bytes)
            ring_pw = 0
            if payload is not None:
                ring_pw = int(payload_plen or PAYLOAD_PREFIX_WIDTHS[0])
            self.ingest_ring = IngestRing.create(
                ring, slots=max(8, 2 * self.pipeline_depth + 4),
                slot_packets=max(self.max_tick_packets, 4096), payload_width=ring_pw)
            if backend == "cuda" and not self.resident:
                # the copies that read a record onto the card read a
                # page-locked copy of it (a resident step's one host copy
                # is into the pool's own pinned input)
                self.ingest_ring.stage_pinned()
        # edit batching (txn): edit files queue here and flush as one
        # folded transaction on the staleness deadline or the batch
        # threshold, checked between ingest admissions and on the file loop
        self.patch_staleness_us = float(
            patch_staleness_us if patch_staleness_us is not None else DEFAULT_STALENESS_US)
        self.patch_max_ops = int(patch_max_ops or DEFAULT_MAX_OPS)
        self.txn_stats = TxnStats()
        self.txn_batcher = TxnBatcher(staleness_s=self.patch_staleness_us * 1e-6,
                                      max_ops=self.patch_max_ops)
        # at most one flush in flight, on its own thread (_maybe_flush_edits);
        # only the file-loop thread sets this
        self._edit_flush_thread: Optional[threading.Thread] = None

        self.nodestates_dir = os.path.join(state_dir, "nodestates")
        self.ingest_dir = os.path.join(state_dir, "ingest")
        self.edits_dir = os.path.join(state_dir, "edits")
        self.out_dir = os.path.join(state_dir, "out")
        self.events_path = os.path.join(state_dir, "events.log")
        # the multi-tenant arena (--tenants): tenants are created lazily
        # when <state-dir>/tenants/<name>/edits/ first appears, and their
        # edit files apply through the same folded-transaction codec
        self.tenants_max = max(0, int(tenants or 0))
        self.tenants_dir = os.path.join(state_dir, "tenants")
        self.tenant_registry = None
        dirs = [self.nodestates_dir, self.ingest_dir, self.edits_dir, self.out_dir]
        if self.tenants_max:
            dirs.append(self.tenants_dir)
        if self.mlscore is not None:
            dirs.append(self.models_dir)
        if self.payload is not None:
            dirs.append(self.patterns_dir)
        for d in dirs:
            os.makedirs(d, exist_ok=True)

        # a per-daemon metrics registry (statistics.go:79-86): /metrics
        # serves whatever is registered here
        self.metrics_registry = MetricsRegistry()
        self.stats = Statistics(poll_period_s=poll_period_s)
        self.stats.register(self.metrics_registry)
        self.syncer = DataplaneSyncer(
            classifier_factory=factory,
            registry=self.registry,
            stats_poller=self.stats,
            checkpoint_dir=os.path.join(state_dir, "checkpoint"),
        )
        self.store = InMemoryStore()
        self.reconciler = NodeStateReconciler(
            self.store, self.syncer, node_name=node_name, namespace=namespace
        )
        self.store.watch(IngressNodeFirewallNodeState.KIND, self._on_store_event)

        # the perf-ring analogue (kernel.c perf event array): once full,
        # incoming records are dropped and counted as lost samples
        self.ring = EventRing(capacity=max(64, int(event_ring_size)))
        self._event_file = open(self.events_path, "a", buffering=1)
        self.events_logger = EventsLogger(
            self.ring,
            self._write_event_line,
            # replay-scale batches drain as binary rows next to events.log;
            # the line sink gets one summary line each
            spill_path=os.path.join(state_dir, "deny-events.bin"),
            iface_names={i.index: i.name for i in self.registry.list()},
        )
        # deny-event loss/queue totals, background-thread crashes and the
        # per-format wire counters on /metrics (the registry holds
        # providers weakly, so the daemon keeps the strong references)
        self.metrics_registry.register_counters(self.ring)
        self.metrics_registry.register_counters(CRASH_COUNTERS)
        self._wire_counters = _WireStatsCounters(lambda: self.syncer.classifier)
        self.metrics_registry.register_counters(self._wire_counters)
        # patch-transaction counters and the staleness histogram
        # (ingressnodefirewall_node_patch_txn_*)
        self.metrics_registry.register_counters(self.txn_stats)
        if self.flow_table is not None or self.resident:
            # the resident pool implies a flow tier
            self._flow_counters = _FlowCounters(lambda: self.syncer.classifier)
            self.metrics_registry.register_counters(self._flow_counters)
        if self.resident:
            self._resident_counters = _ResidentCounters(lambda: self.syncer.classifier)
            self.metrics_registry.register_counters(self._resident_counters)
        if self.telemetry is not None:
            # updates, drains, summaries, sampled and suppressed raw events,
            # the drain seq
            self._telemetry_counters = _TelemetryCounters(lambda: self.syncer.classifier)
            self.metrics_registry.register_counters(self._telemetry_counters)
        if self.mlscore is not None:
            # updates, anomalies, enforced denies, model swaps, the drain seq
            self._mlscore_counters = _MlScoreCounters(lambda: self.syncer.classifier)
            self.metrics_registry.register_counters(self._mlscore_counters)
        if self.payload is not None:
            # admissions, scanned lanes, matches, enforced rewrites, pattern
            # swaps, the set's size and version
            self._payload_counters = _PayloadCounters(lambda: self.syncer.classifier)
            self.metrics_registry.register_counters(self._payload_counters)
        if self.tracer is not None:
            # span histograms (ingressnodefirewall_node_span_us) and trace_*
            # counters; slow-job TraceSpanRecords share the event ring
            self.tracer.attach_ring(self.ring)
            self.metrics_registry.register_histograms(self.tracer.histograms)
            self.metrics_registry.register_counters(self.tracer)
        if self.ingest_ring is not None:
            # ring_* cursor and backpressure gauges
            self.metrics_registry.register_counters(self.ingest_ring)
        if self.tenants_max:
            self.tenant_registry = self._build_tenant_registry(backend)
            # tenant_* counters (slabs, swaps, flips, clones, per-tenant
            # packets and verdicts) on /metrics
            self.metrics_registry.register_counters(self.tenant_registry)
        # tenant names whose create failed (a pool smaller than the
        # directories an operator made): logged once, then skipped
        self._tenant_create_failed: set = set()
        self._tenant_dedup_last = 0.0
        self.debug_buffer = DebugLookupBuffer()

        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._servers: List[ThreadingHTTPServer] = []
        self._known_state_files: Dict[str, float] = {}
        # files rejected deterministically (schema, compile), remembered by
        # mtime so they are logged once; kept apart from _known_state_files
        # so deleting a rejected file never counts as a CR deletion
        self._rejected_state_files: Dict[str, float] = {}
        self.metrics_port = metrics_port
        self.health_port = health_port

    # -- event sink ----------------------------------------------------------

    def _write_event_line(self, line: str) -> None:
        self._event_file.write(line + "\n")

    # -- store-driven reconcile ----------------------------------------------

    def _on_store_event(self, event: str, obj) -> None:
        try:
            if event == "DELETED":
                if (obj.metadata.name == self.node_name
                        and obj.metadata.namespace == self.namespace):
                    return  # the finalizer path already synced the delete
            self.reconciler.reconcile(obj.metadata.name, obj.metadata.namespace)
        except (SyncError, CompileError, InterfaceError) as e:
            log.error("reconcile failed: %s", e)

    # -- file-driven desired state -------------------------------------------

    def scan_nodestates_once(self) -> None:
        """State-dir protocol: <nodestates>/<node-name>.json holds the
        NodeState CR dict; deleting the file deletes the CR."""
        seen = {}
        for fn in os.listdir(self.nodestates_dir):
            if not fn.endswith(".json"):
                continue
            path = os.path.join(self.nodestates_dir, fn)
            try:
                mtime = os.path.getmtime(path)
            except FileNotFoundError:
                continue
            seen[fn] = mtime
            if self._known_state_files.get(fn) == mtime:
                continue
            if self._rejected_state_files.get(fn) == mtime:
                continue
            try:
                with open(path) as f:
                    doc = json.load(f)
                ns_obj = IngressNodeFirewallNodeState.from_dict(doc)
            except OSError as e:
                log.error("bad nodestate file %s: %s", fn, e)  # may be transient
                continue
            except (json.JSONDecodeError, TypeError, AttributeError, ValueError, KeyError) as e:
                log.error("bad nodestate file %s: %s", fn, e)
                self._rejected_state_files[fn] = mtime
                continue
            if not ns_obj.metadata.name:
                ns_obj.metadata.name = fn[: -len(".json")]
            if not ns_obj.metadata.namespace:
                ns_obj.metadata.namespace = self.namespace
            if ns_obj.metadata.name != self.node_name:
                continue
            schema_errs = validate_nodestate_schema(ns_obj)
            if schema_errs:
                # no API server in front of the file protocol: the schema
                # tier rejects here with CRD-style messages
                log.error("schema-invalid nodestate %s: %s", fn, "; ".join(schema_errs))
                self._rejected_state_files[fn] = mtime
                continue
            try:
                self.syncer.sync_interface_ingress_rules(
                    ns_obj.spec.interface_ingress_rules, False
                )
                self._known_state_files[fn] = mtime
            except CompileError as e:
                # deterministic: the same bytes can never compile
                log.error("sync failed for %s: %s", fn, e)
                self._rejected_state_files[fn] = mtime
            except (SyncError, InterfaceError) as e:
                # possibly transient: retried next tick
                log.error("sync failed for %s: %s", fn, e)
        for fn in list(self._rejected_state_files):
            if fn not in seen:
                del self._rejected_state_files[fn]
        for fn in list(self._known_state_files):
            if fn not in seen:
                del self._known_state_files[fn]
                try:
                    self.syncer.sync_interface_ingress_rules({}, True)
                except (SyncError, CompileError, InterfaceError) as e:
                    log.error("delete sync failed for %s: %s", fn, e)

    # -- rule-edit files -----------------------------------------------------

    def scan_edits_once(self) -> int:
        """Queue every edit file in <state-dir>/edits/ into the
        transaction batcher (txn edit-file protocol: one JSON document of
        single-key ops per file, written tmp + rename).  Files are
        consumed in sorted order; a bad file is removed and logged, never
        wedging the scan.  Returns the ops queued."""
        n = 0
        for fn in sorted(os.listdir(self.edits_dir)):
            path = os.path.join(self.edits_dir, fn)
            if fn.endswith(".tmp") or not os.path.isfile(path):
                continue
            if fn.endswith("-manifest.json"):
                continue  # an edit generator's schedule sidecar, not an edit file
            try:
                ops = read_edit_file(path)
            except (OSError, ValueError, KeyError, TypeError) as e:
                log.error("bad edit file %s: %s", fn, e)
                try:
                    os.remove(path)
                except OSError as re:
                    log.error("could not remove bad edit file %s: %s", fn, re)
                continue
            self.txn_batcher.queue_many(ops)
            n += len(ops)
            try:
                os.remove(path)
            except OSError as e:
                log.error("could not remove edit file %s: %s", fn, e)
        return n

    def _build_tenant_registry(self, backend: str):
        """The multi-tenant arena control plane (the JAX daemon's
        geometry): one preallocated unspliced ctrie pool of --tenants ids,
        two pages beyond them for staging, on the daemon's device."""
        entries = int(os.environ.get("INFW_TENANT_SLAB_ENTRIES") or 1024)
        slots = int(os.environ.get("INFW_TENANT_RULE_SLOTS") or 16)
        spec = make_arena_spec(
            "ctrie",
            pages=max(self.tenants_max + 2, 4),
            max_tenants=self.tenants_max,
            entries=entries,
            rule_slots=slots,
            lut_rows=64,
            root_nodes=4,
            node_rows=4 * entries,
            target_rows=8 * entries,
            d_max=18,
        )
        clf = TorchArenaClassifier(spec, device=backend_device(backend),
                                   flow_table=self.flow_table)
        if self.flow_table is not None:
            self._attach_flow_events(clf)
            # prefixed, so the arena's series never sum into the
            # single-tenant flow_* series
            self._tenant_flow_counters = _FlowCounters(lambda: clf, prefix="tenant_")
            self.metrics_registry.register_counters(self._tenant_flow_counters)
        return TenantRegistry(clf, rule_width=slots, event_ring=self.ring)

    def _attach_flow_events(self, clf) -> None:
        """Wire a classifier's flow tier to the event ring, once per tier:
        inserts that evict live flows surface as FlowEvictRecords."""
        tier = getattr(clf, "flow", None)
        if tier is None or id(tier) in self._flow_attached:
            return
        tier.on_evict = lambda ev, ins, ep: self.ring.push(
            FlowEvictRecord(evicted=int(ev), inserted=int(ins), epoch=int(ep)))
        self._flow_attached.add(id(tier))

    def _flow_maintenance(self) -> None:
        """Idle-loop flow upkeep: attach eviction events to each new
        classifier generation and sweep aged entries every 5 s (stale
        entries never serve anyway; the sweep frees their slots)."""
        if self.flow_table is None:
            return
        now = time.monotonic()
        for clf in (self.syncer.classifier,
                    self.tenant_registry.classifier if self.tenant_registry is not None else None):
            if clf is None:
                continue
            self._attach_flow_events(clf)
            if now - self._flow_age_last >= 5.0:
                clf.flow_age_tick()
        if now - self._flow_age_last >= 5.0:
            self._flow_age_last = now

    def scan_tenant_edits_once(self) -> int:
        """Apply every per-tenant edit file under
        <state-dir>/tenants/<name>/edits/ as ONE folded transaction per
        file through the tenant registry.  A tenant is created (empty) the
        first time its directory appears; bad files are consumed and
        logged.  Returns ops applied."""
        if self.tenant_registry is None:
            return 0
        n = 0
        try:
            names = sorted(os.listdir(self.tenants_dir))
        except OSError:
            return 0
        for name in names:
            edits = os.path.join(self.tenants_dir, name, "edits")
            if not os.path.isdir(edits):
                continue
            if name not in self.tenant_registry.tenant_ids_by_name():
                if name in self._tenant_create_failed:
                    continue
                try:
                    self.tenant_registry.create_tenant(name, {})
                except Exception as e:
                    log.error("could not create tenant %r (will not retry; its edit files "
                              "are left in place): %s", name, e)
                    self._tenant_create_failed.add(name)
                    continue
            for fn in sorted(os.listdir(edits)):
                path = os.path.join(edits, fn)
                if fn.endswith(".tmp") or not os.path.isfile(path):
                    continue
                try:
                    ops = read_edit_file(path)
                    self.tenant_registry.apply_edit_transaction(name, ops)
                    n += len(ops)
                except Exception as e:
                    log.error("bad tenant edit file %s/%s: %s", name, fn, e)
                try:
                    os.remove(path)
                except OSError as e:
                    log.error("could not remove tenant edit file %s: %s", fn, e)
        return n

    def _tenant_dedup_maintenance(self) -> None:
        """File-loop upkeep of the tenant arena: every 5 s, re-hash slabs
        whose content hash went stale (patches, clones) and re-merge pages
        whose content re-converged, at most 64 a pass; flips only, never a
        slab write."""
        if self.tenant_registry is None:
            return
        now = time.monotonic()
        if now - self._tenant_dedup_last < 5.0:
            return
        self._tenant_dedup_last = now
        rep = self.tenant_registry.classifier.dedup_sweep(limit=64)
        if rep.get("merged"):
            log.info("tenant dedup sweep: %d page(s) re-hashed, %d tenant row(s) re-merged",
                     rep["hashed"], rep["merged"])

    def _maybe_flush_edits(self, force: bool = False) -> bool:
        """Start a flush of the queued edits when the staleness policy
        trips (or ``force``): ONE folded transaction through the syncer,
        its counters into TxnStats and a PatchTxnRecord on the event ring.
        The flush runs on its own thread, at most one in flight (later
        edits keep coalescing toward the next transaction), so neither
        the ingest tick nor the file loop waits on it, not even on an
        escalated rebuild.  Until a sync has created the dataplane the
        edits stay queued.  Returns True when a flush was started."""
        batcher = self.txn_batcher
        if len(batcher) == 0:
            return False
        t = self._edit_flush_thread
        if t is not None and t.is_alive():
            return False
        reason = "manual" if force else batcher.should_flush()
        if reason is None:
            return False
        clf = self.syncer.classifier
        if clf is None or clf.tables is None:
            return False
        items = batcher.drain()
        if not items:
            return False

        def work() -> None:
            try:
                self.syncer.apply_edit_transaction(
                    [op for op, _ts in items], reason=reason,
                    enqueue_ts=[ts for _op, ts in items],
                    stats=self.txn_stats, ring=self.ring,
                )
            except Exception as e:
                # a bad transaction is dropped, never re-queued forever
                log.error("edit transaction flush failed (%d ops dropped): %s",
                          len(items), e)

        self._edit_flush_thread = spawn(work, name="infw-edit-flush")
        return True

    # -- ingest --------------------------------------------------------------

    def process_ingest_once(self) -> int:
        """Classify every frames file in the ingest dir; write verdict
        summaries to out/; emit deny events; consume the file.  Returns the
        number of files finalized.

        Cross-file batching: the pending files (bounded by
        ``max_tick_packets``) are parsed up front and their packets
        regrouped into family-homogeneous jobs of ``ingest_chunk`` rows
        that span file boundaries, IPv6 further split by the classifier's
        depth classes (v6_depth_groups).  Up to ``H2D_STAGE_DEPTH`` jobs are
        packed and staged ahead (prepare_packed) and up to
        ``pipeline_depth`` are in flight.

        Failure isolation: a failed merged job is re-dispatched as
        per-file jobs, so a fault attributable to one file's packets
        poisons only that file (left on disk for the next tick) while its
        job-mates complete; statistics are computed on the host per file
        from the verdicts and applied only after the file is consumed,
        exactly once across any retry."""
        clf = self.syncer.classifier
        if clf is None or clf.tables is None:
            return 0
        processed = 0
        chunk = self.ingest_chunk
        st = self.stage_seconds
        tracer = self.tracer

        def finalize(fctx) -> None:
            """Write verdicts, consume the file, then apply stats and emit
            events, strictly after the source file is removed: a failure
            anywhere earlier leaves the file for a clean retry with no
            double-counted statistics and no duplicate deny events."""
            nonlocal processed
            batch, fb, fn = fctx["batch"], fctx["frames"], fctx["fn"]
            results, xdp = fctx["results"], fctx["xdp"]
            if self.debug_lookup:
                self.debug_buffer.record_batch(batch)
            # per-packet verdicts go to a binary sidecar (little-endian u32
            # per packet, file order); the JSON stays a bounded summary
            results.astype("<u4").tofile(os.path.join(self.out_dir, fn + ".verdicts.bin"))
            summary = {
                "file": fn,
                "packets": len(batch),
                "pass": int((xdp == 2).sum()),
                "drop": int((xdp == 1).sum()),
                "results_file": fn + ".verdicts.bin",
            }
            jpath = os.path.join(self.out_dir, fn + ".verdicts.json")
            with open(jpath + ".tmp", "w") as f:
                json.dump(summary, f)
            os.replace(jpath + ".tmp", jpath)
            os.remove(fctx["path"])
            clf.stats.add(stats_from_results(results, np.asarray(batch.pkt_len)))
            self._emit_deny_sampled(clf, results, batch.ifindex, batch.pkt_len, fb, batch)
            processed += 1

        def seg_done(fctx) -> None:
            fctx["remaining"] -= 1
            if fctx["remaining"] == 0 and not fctx["failed"]:
                t0 = time.perf_counter()
                try:
                    finalize(fctx)
                except Exception as e:
                    log.error("ingest finalize failed for %s: %s", fctx["fn"], e)
                st["finalize"] += time.perf_counter() - t0

        # ---- phase 1: read and parse the pending files (bounded per tick) ----
        files = []
        total = 0
        for fn in sorted(os.listdir(self.ingest_dir)):
            path = os.path.join(self.ingest_dir, fn)
            if fn.endswith(".tmp") or not os.path.isfile(path):
                continue
            if files and total >= self.max_tick_packets:
                break  # the rest belongs to the next tick
            try:
                t0 = time.perf_counter()
                fb = read_frames_any(path)
                t1 = time.perf_counter()
                batch = parse_frames_buf(fb)
                t2 = time.perf_counter()
                st["read"] += t1 - t0
                st["parse"] += t2 - t1
                if tracer is not None:
                    # per file: ingest = the file read, pack = the frame
                    # parse (the wire pack is charged per job in prepare)
                    tracer.histograms.observe("ingest", (t1 - t0) * 1e6)
                    tracer.histograms.observe("pack", (t2 - t1) * 1e6)
            except (OSError, ValueError, struct.error, IndexError) as e:
                # a bad file is consumed, or it would wedge every tick
                log.error("bad ingest file %s: %s", fn, e)
                try:
                    os.remove(path)
                except OSError as re:
                    log.error("could not remove bad ingest file %s: %s", fn, re)
                continue
            n = len(batch)
            fctx = {
                "fn": fn, "path": path, "frames": fb, "batch": batch,
                "results": np.zeros(n, np.uint32),
                "xdp": np.full(n, 2, np.int32),
                "remaining": 0, "failed": False,
            }
            if n == 0:
                try:
                    finalize(fctx)  # no device work for an empty file
                except Exception as e:
                    log.error("ingest finalize failed for %s: %s", fn, e)
                continue
            files.append(fctx)
            total += n
        if not files:
            return processed

        # ---- phase 2: family- and depth-homogeneous jobs spanning files ----
        t_group = time.perf_counter()
        jobs: deque = deque()
        per_file_v6 = {}
        seen_depths = set()
        for fctx in files:
            b = fctx["batch"]
            g = np.nonzero(np.asarray(b.kind) == KIND_IPV6)[0]
            groups = clf.v6_depth_groups(b.ifindex, b.ip_words, g)
            per_file_v6[id(fctx)] = dict(groups)
            seen_depths.update(d for d, _ in groups)
        # d is the (class, generation) pair of v6_depth_groups; shallow
        # classes first, the full depth (class None) last
        group_keys = [(False, None)] + [(True, d) for d in sorted(
            seen_depths, key=lambda d: (d[0] is None, -1 if d[0] is None else d[0]))]
        for want_v6, depth in group_keys:
            cur, cur_n = [], 0
            for fctx in files:
                if want_v6:
                    g = per_file_v6[id(fctx)].get(depth)
                    if g is None:
                        continue
                else:
                    g = np.nonzero(np.asarray(fctx["batch"].kind) != KIND_IPV6)[0]
                pos = 0
                while pos < len(g):
                    take = g[pos: pos + (chunk - cur_n)]
                    cur.append((fctx, take))
                    fctx["remaining"] += 1
                    cur_n += len(take)
                    pos += len(take)
                    if cur_n >= chunk:
                        jobs.append({"segments": cur, "retry": False, "depth": depth})
                        cur, cur_n = [], 0
            if cur:
                jobs.append({"segments": cur, "retry": False, "depth": depth})
        st["group"] += time.perf_counter() - t_group

        packed_ok = clf.supports_packed()

        def _bucket(n: int) -> int:
            """Pad a job to a power-of-two row count (capped at the chunk):
            the JAX daemon's shape buckets, kept so both daemons ship the
            same wire.  Padding rows are KIND_OTHER (PASS, no stats) and
            are dropped before the verdicts are written."""
            if n >= chunk:
                return n
            return min(1 << max(6, (n - 1).bit_length()), chunk)

        def prepare(job):
            """The host half of a job: gather its segments, pack the wire,
            pad it, and (prepare_packed) choose the format, encode and
            start the copy.  None when every segment already failed."""
            nonlocal packed_ok
            t_prep0 = time.perf_counter()
            segs = [(f, idx) for f, idx in job["segments"] if not f["failed"]]
            job["segments"] = segs
            if not segs:
                return None
            n = sum(len(idx) for _f, idx in segs)
            if tracer is not None:
                job["trace"] = tracer.begin(n)
            if packed_ok:
                parts = [f["batch"].pack_wire_subset(np.ascontiguousarray(idx, np.int64))
                         for f, idx in segs]
                width = max(w.shape[1] for w, _v4 in parts)
                wire = np.concatenate(
                    [w if w.shape[1] == width else expand_wire_v4(w) for w, _v4 in parts]
                )
                pad = _bucket(n) - n
                if pad:
                    padrows = np.zeros((pad, width), np.uint32)
                    padrows[:, 0] = KIND_OTHER
                    wire = np.concatenate([wire, padrows])
                v4_only = all(v4 for _w, v4 in parts)
                try:
                    t_h2d0 = time.perf_counter()
                    plan = clf.prepare_packed(wire, v4_only, depth=job["depth"])
                    tr = job.get("trace")
                    if tr is not None:
                        tr.add("pack", t_h2d0 - t_prep0)
                        tr.add("h2d", time.perf_counter() - t_h2d0)
                    return ("plan", plan)
                except RuntimeError:
                    # a concurrent load can flip the table to wide ruleIds
                    # (the full-batch path); a closed classifier re-raises
                    if clf.supports_packed() or clf.active_path is None:
                        raise
                    packed_ok = False
                    log.warning("table flipped to wide ruleIds mid-tick; "
                                "classifying unpacked batches")
            merged = packets_mod.concat([f["batch"].take(idx) for f, idx in segs])
            return ("batch", merged.pad_to(_bucket(n)))

        def launch(prep):
            if prep[0] == "plan":
                return clf.classify_prepared(prep[1], apply_stats=False)
            return clf.classify_async(prep[1], apply_stats=False)

        def job_failed(job, err) -> None:
            """A merged job's fault cannot be attributed to one file: each
            segment is re-dispatched as its own single-file job.  A retry
            job's fault can: that file is poisoned for this tick."""
            if not job["retry"]:
                log.warning("ingest job failed (%s); retrying per file", err)
                for f, idx in job["segments"]:
                    jobs.append({"segments": [(f, idx)], "retry": True, "depth": job["depth"]})
                return
            for f, _idx in job["segments"]:
                if not f["failed"]:
                    f["failed"] = True
                    log.error("ingest classify failed for %s: %s", f["fn"], err)
                seg_done(f)

        def drain_one() -> None:
            job, pending = inflight.popleft()
            tr = job.get("trace")
            t0 = time.perf_counter()
            try:
                out = pending.result()
            except Exception as e:
                st["wait"] += time.perf_counter() - t0
                job_failed(job, e)
                return
            t1 = time.perf_counter()
            st["wait"] += t1 - t0
            if tr is not None:
                tr.add("materialize", t1 - t0)
            results, xdp = np.asarray(out.results), np.asarray(out.xdp)
            off = 0
            for f, idx in job["segments"]:
                k = len(idx)
                if not f["failed"]:
                    f["results"][idx] = results[off: off + k]
                    f["xdp"][idx] = xdp[off: off + k]
                off += k
            st["finalize"] += time.perf_counter() - t1
            for f, _idx in job["segments"]:
                seg_done(f)
            if tr is not None:
                tr.add("drain", time.perf_counter() - t1)
                tracer.finish(tr)

        inflight: deque = deque()
        staged: deque = deque()

        def stage_more() -> None:
            # keep the staging window full: the next jobs' pack, encode and
            # copy start while earlier classifies are still in flight
            while jobs and len(staged) < H2D_STAGE_DEPTH:
                job = jobs.popleft()
                t0 = time.perf_counter()
                try:
                    prep = prepare(job)
                except Exception as e:
                    job_failed(job, e)
                    continue
                finally:
                    st["pack"] += time.perf_counter() - t0
                if prep is not None:
                    staged.append((job, prep))

        while jobs or staged or inflight:
            # a tripped edit flush starts between admissions: jobs already
            # launched or staged keep the generation they snapshotted, the
            # next prepared job picks up the patched tables
            try:
                self._maybe_flush_edits()
            except Exception as e:
                log.error("edit flush error: %s", e)
            stage_more()
            while staged and len(inflight) < self.pipeline_depth:
                job, prep = staged.popleft()
                t0 = time.perf_counter()
                try:
                    pending = launch(prep)
                    tr = job.get("trace")
                    if tr is not None:
                        tr.add("dispatch", time.perf_counter() - t0)
                except Exception as e:
                    job_failed(job, e)
                    continue
                finally:
                    st["launch"] += time.perf_counter() - t0
                inflight.append((job, pending))
                stage_more()
            if inflight:
                drain_one()
        return processed

    # -- ring ingest ---------------------------------------------------------

    def process_ring_once(self, budget: Optional[int] = None) -> int:
        """Serve the committed ring records (the JAX daemon's
        process_ring_once): admission by ring cursor, each record one job
        of the packed dispatch (prepare_packed with its TCP flags and payload
        column), up to ``pipeline_depth`` in flight, each slot released only
        after the dispatch that read it materialized.  With ``superbatch_k``
        K >= 2, up to K committed records of one shape class (width,
        v4_only, flags present, the payload column's shape) go out as one
        superbatch dispatch; a record of another class carries to the next
        turn, and a superbatch the classifier declines is served record by
        record.  Returns the packets served."""
        ring = self.ingest_ring
        if ring is None:
            return 0
        clf = self.syncer.classifier
        if clf is None or not clf.supports_packed():
            # no tables yet: the records wait in the ring.  (Tables with
            # ruleIds past the wire's 8 bits would not take the packed
            # dispatch, but a NodeState's orders stay below 100.)
            return 0
        budget = self.max_tick_packets if budget is None else int(budget)
        processed = 0
        inflight = self._ring_inflight
        tracer = self.tracer
        super_k = self.superbatch_k
        can_super = super_k >= 2
        carry: list = []  # popped, not dispatched (a shape-class break)

        def dispatch_one(chunk, trace) -> bool:
            try:
                plan = clf.prepare_packed(chunk.wire, chunk.v4_only, tcp_flags=chunk.tcp_flags,
                                          payload=chunk.payload, payload_len=chunk.payload_len)
                if trace is not None:
                    trace.mark("h2d")
                pending = clf.classify_prepared(plan, apply_stats=True)
                if trace is not None:
                    trace.mark("dispatch")
            except Exception as e:
                log.error("ring ingest dispatch failed: %s", e)
                chunk.release()
                return False
            inflight.append((chunk, pending, trace))
            return True

        while processed < budget:
            t0 = time.perf_counter()
            chunk = carry.pop(0) if carry else ring.pop(timeout=0.0)
            if chunk is None:
                break
            trace = None
            if tracer is not None:
                # the ring path's spans: ingest = the cursor pop, h2d =
                # prepare_packed (the record arrives packed: the pack is the
                # producer's), dispatch = the launch, materialize = the read
                # back, drain = the slot's release
                trace = tracer.begin(chunk.wire.shape[0])
                trace.add("ingest", time.perf_counter() - t0)
            group = [chunk]
            if can_super and not carry:
                while len(group) < super_k:
                    try:
                        nxt = ring.pop(timeout=0.0)
                    except ValueError as e:
                        log.error("ring ingest pop failed: %s", e)
                        break
                    if nxt is None:
                        break
                    if _shape_class(nxt) != _shape_class(chunk):
                        carry.append(nxt)
                        break
                    group.append(nxt)
            if len(group) >= 2:
                # one stacked copy in (slots are not contiguous with each
                # other) and one superbatch dispatch for the group
                pends = None
                try:
                    plan = clf.prepare_packed_super(
                        np.stack([c.wire for c in group]), chunk.v4_only,
                        tcp_flags_stack=(None if chunk.tcp_flags is None
                                         else np.stack([c.tcp_flags for c in group])),
                        payload_stack=(None if chunk.payload is None
                                       else np.stack([c.payload for c in group])),
                        payload_len_stack=(None if chunk.payload is None
                                           else np.stack([c.payload_len for c in group])))
                    if plan is not None:
                        if trace is not None:
                            trace.mark("h2d")
                        pends = clf.classify_prepared_super(plan, apply_stats=True)
                        if trace is not None:
                            trace.mark("dispatch")
                except Exception as e:
                    log.error("ring superbatch dispatch failed: %s", e)
                    pends = None
                if pends is not None:
                    for j, (c, p) in enumerate(zip(group, pends)):
                        inflight.append((c, p, trace if j == 0 else None))
                        processed += c.wire.shape[0]
                    while len(inflight) > self.pipeline_depth:
                        self._ring_drain_one()
                    continue
                # declined: each gathered record through the single path
            for j, c in enumerate(group):
                if dispatch_one(c, trace if j == 0 else None):
                    processed += c.wire.shape[0]
            while len(inflight) > self.pipeline_depth:
                self._ring_drain_one()
        # a shape-class break popped one record past the budget: it is
        # dispatched now (releases stay in pop order)
        for c in carry:
            if dispatch_one(c, None):
                processed += c.wire.shape[0]
        while inflight:
            self._ring_drain_one()
        return processed

    def _ring_drain_one(self) -> None:
        chunk, pending, trace = self._ring_inflight.popleft()
        try:
            pending.result()
            if trace is not None:
                trace.mark("materialize")
        except Exception as e:
            log.error("ring ingest classify failed: %s", e)
        finally:
            chunk.release()
            if trace is not None:
                trace.mark("drain")
                self.tracer.finish(trace)

    def _telemetry_maintenance(self) -> None:
        """Idle-loop telemetry upkeep: attach the event ring and the drain
        cadence to each new classifier generation's tier, and drain every
        5 s when a window is open, so a quiet node still reports (the
        admission-count cadence only fires under load)."""
        if self.telemetry is None:
            return
        tier = getattr(self.syncer.classifier, "telemetry", None)
        if tier is None:
            return
        if id(tier) not in self._telemetry_attached:
            tier.attach_ring(self.ring)
            tier.drain_every = self.telemetry_drain
            self._telemetry_attached.add(id(tier))
        now = time.monotonic()
        if now - self._telemetry_drain_last >= 5.0:
            self._telemetry_drain_last = now
            if tier.counter_values()["telemetry_window_admissions"] > 0:
                tier.drain(force=True)

    def _mlscore_maintenance(self) -> None:
        """Idle-loop scoring upkeep (infw.daemon._mlscore_maintenance):
        attach the event ring to each new classifier generation's tier (and
        apply the last hot-swapped model to it), drain every 5 s when a
        window is open, and consume the complete npz + manifest pairs in
        <state-dir>/models/, each a hot swap through set_score_model (the
        flow generation bumps); a bad pair is consumed and logged."""
        if self.mlscore is None:
            return
        clf = self.syncer.classifier
        tier = getattr(clf, "mlscore", None)
        if tier is None:
            return
        if id(tier) not in self._mlscore_attached:
            tier.attach_ring(self.ring)
            self._mlscore_attached.add(id(tier))
            swapped = self._mlscore_swapped_model
            if swapped is not None and tier.model_version != swapped.version:
                try:
                    clf.set_score_model(swapped)
                    log.info("mlscore: re-applied hot-swapped model %s to new classifier "
                             "generation", swapped.version)
                except Exception as e:
                    log.error("mlscore: re-apply of swapped model failed: %s", e)
        now = time.monotonic()
        if now - self._mlscore_drain_last >= 5.0:
            self._mlscore_drain_last = now
            if tier.counter_values()["mlscore_window_admissions"] > 0:
                tier.drain(force=True)
        from .mlscore import load_model

        try:
            names = sorted(os.listdir(self.models_dir))
        except OSError:
            return
        for fn in names:
            if not fn.endswith(".npz"):
                continue
            path = os.path.join(self.models_dir, fn)
            if not os.path.exists(path + ".json"):
                continue  # the manifest has not landed yet
            try:
                model = load_model(path)
                clf.set_score_model(model)
                self._mlscore_swapped_model = model
                log.info("mlscore: hot-swapped model %s (version %s)", fn, tier.model_version)
            except Exception as e:
                log.error("mlscore: model artifact %s rejected: %s", fn, e)
            for q in (path, path + ".json"):
                try:
                    os.unlink(q)
                except OSError:
                    pass

    def _payload_maintenance(self) -> None:
        """Idle-loop payload upkeep (infw.daemon._payload_maintenance): apply
        the last hot-swapped set to a new classifier generation's tier, then
        consume the complete npz + manifest pairs in <state-dir>/patterns/,
        each a hot swap through set_payload_patterns (the flow generation
        bumps); a bad pair is consumed and logged."""
        if self.payload is None:
            return
        clf = self.syncer.classifier
        tier = getattr(clf, "payload", None)
        if tier is None:
            return
        if id(tier) not in self._payload_attached:
            self._payload_attached.add(id(tier))
            if self._payload_swapped is not None:
                pats, plen, label = self._payload_swapped
                try:
                    clf.set_payload_patterns(pats, plen=plen)
                    log.info("payload: re-applied hot-swapped pattern set %s to new "
                             "classifier generation", label)
                except Exception as e:
                    log.error("payload: re-apply of swapped pattern set failed: %s", e)
        from .payload import load_patterns

        try:
            names = sorted(os.listdir(self.patterns_dir))
        except OSError:
            return
        for fn in names:
            if not fn.endswith(".npz"):
                continue
            path = os.path.join(self.patterns_dir, fn)
            if not os.path.exists(path + ".json"):
                continue  # the manifest has not landed yet
            try:
                pats, pspec, label = load_patterns(path)
                clf.set_payload_patterns(pats, plen=pspec.plen)
                self._payload_swapped = (pats, pspec.plen, label)
                log.info("payload: hot-swapped pattern set %s (version %s, %d patterns)", fn,
                         label, len(pats))
            except Exception as e:
                log.error("payload: pattern artifact %s rejected: %s", fn, e)
            for q in (path, path + ".json"):
                try:
                    os.unlink(q)
                except OSError:
                    pass

    def _emit_deny_sampled(self, clf, results, ifindex, pkt_len, frames, batch) -> None:
        """Deny-event export with the telemetry tier's per-tenant token
        bucket in front: the exact totals travel in the sketch summaries,
        the bucket releases at most its budget of raw records, and the
        rest count as telemetry_suppressed_events (policy, not ring
        loss).  Without a telemetry tier every deny is emitted."""
        tel = getattr(clf, "telemetry", None)
        if tel is None:
            emit_deny_events(self.ring, results, ifindex, pkt_len, frames, batch=batch)
            return
        results = np.asarray(results)
        deny_idx = np.nonzero((results & 0xFF) == DENY)[0]
        if len(deny_idx) == 0:
            return
        grant = tel.sample_allow(0, len(deny_idx))
        if grant >= len(deny_idx):
            emit_deny_events(self.ring, results, ifindex, pkt_len, frames, batch=batch)
            return
        if grant == 0:
            return
        keep = deny_idx[:grant]
        emit_deny_events(self.ring, results[keep], np.asarray(ifindex)[keep],
                         np.asarray(pkt_len)[keep],
                         None if frames is None else [frames[int(i)] for i in keep])

    # -- HTTP endpoints ------------------------------------------------------

    def _make_handler(daemon_self):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, body: str, ctype="text/plain; charset=utf-8"):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/metrics":
                    self._send(200, daemon_self.metrics_registry.render_text())
                elif self.path in ("/healthz", "/readyz"):
                    self._send(200, "ok")
                elif self.path == "/debug/lookup-keys":
                    keys = daemon_self.debug_buffer.snapshot()
                    self._send(
                        200,
                        json.dumps([{"ifindex": k[0], "ip_words": list(k[1])} for k in keys]),
                        ctype="application/json",
                    )
                else:
                    self._send(404, "not found")

        return Handler

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        handler = self._make_handler()
        for port in {self.metrics_port, self.health_port}:
            srv = ThreadingHTTPServer(("127.0.0.1", port), handler)
            self._servers.append(srv)
            self._threads.append(spawn(srv.serve_forever, name="infw-daemon-http"))
        self.events_logger.start()
        self._threads.append(spawn(self._file_loop, name="infw-file-loop"))
        log.info("daemon started node=%s backend=%s metrics=127.0.0.1:%d",
                 self.node_name, self.backend, self.actual_metrics_port)

    def _file_loop(self) -> None:
        """The one thread that classifies: every classify launch and every
        read back happens here, and the state-dir syncs too."""
        while not self._stop.wait(self.file_poll_interval_s):
            # scan and ingest are isolated: a persistently bad nodestate
            # file must not starve packet classification
            try:
                self.scan_nodestates_once()
            except Exception as e:
                log.error("nodestate scan error: %s", e)
            try:
                self.scan_edits_once()
                self._maybe_flush_edits()
            except Exception as e:
                log.error("edit scan error: %s", e)
            try:
                self.scan_tenant_edits_once()
            except Exception as e:
                log.error("tenant edit scan error: %s", e)
            try:
                self._tenant_dedup_maintenance()
            except Exception as e:
                log.error("tenant dedup sweep error: %s", e)
            try:
                self.process_ring_once()
            except Exception as e:
                log.error("ring ingest error: %s", e)
            try:
                self.process_ingest_once()
            except Exception as e:
                log.error("ingest error: %s", e)
            try:
                self._flow_maintenance()
            except Exception as e:
                log.error("flow maintenance error: %s", e)
            try:
                self._telemetry_maintenance()
            except Exception as e:
                log.error("telemetry maintenance error: %s", e)
            try:
                self._mlscore_maintenance()
            except Exception as e:
                log.error("mlscore maintenance error: %s", e)
            try:
                self._payload_maintenance()
            except Exception as e:
                log.error("payload maintenance error: %s", e)

    def stop(self) -> None:
        """SIGTERM path: stop polling and serving, detach the dataplane but
        keep the checkpoint (ebpfsyncer.go:90-97), so a restart re-adopts
        the rules."""
        self._stop.set()
        for srv in self._servers:
            srv.shutdown()
            srv.server_close()
        for t in self._threads:
            t.join()
        self._threads = []
        if self._edit_flush_thread is not None:
            self._edit_flush_thread.join()
        self.events_logger.stop()
        self.stats.stop_poll()
        self.stats.unregister()
        self.syncer.shutdown()
        self._event_file.close()
        if self.ingest_ring is not None:
            while self._ring_inflight:
                self._ring_drain_one()
            self.ingest_ring.close()

    @property
    def actual_metrics_port(self) -> int:
        return self._servers[0].server_address[1] if self._servers else self.metrics_port


def _env_set(name: str) -> bool:
    return os.environ.get(name, "") not in ("", "0", "false", "no")


def _env_asks(env: str) -> bool:
    """Whether the environment asks for a refused option (REFUSED_FLAGS)."""
    if env in ("INFW_FUSED_DEEP", "INFW_H2D_OVERLAP"):  # "0" / "false" / "no" turn these off
        return os.environ.get(env, "") in ("0", "false", "no")
    return _env_set(env)


def main(argv: Optional[List[str]] = None) -> int:
    """CLI entry with the reference env contract
    (cmd/daemon/daemon.go:69-84): flags beat env, env beats defaults."""
    p = argparse.ArgumentParser(
        prog="infw_torch.daemon",
        description="The ingress node firewall daemon on a CUDA card (the "
                    "PyTorch port of infw.daemon, stateless serving).",
    )
    p.add_argument("--state-dir", required=True)
    p.add_argument("--node-name", default=os.environ.get("NODE_NAME", ""))
    p.add_argument("--namespace",
                   default=os.environ.get("NAMESPACE", "ingress-node-firewall-system"))
    p.add_argument("--backend", default=os.environ.get("INFW_BACKEND") or "cuda",
                   help="cuda (default): TorchClassifier on the first CUDA card, "
                        "raising at start without one; cpu: the plain PyTorch "
                        "versions on the CPU.  CLI beats INFW_BACKEND")
    p.add_argument("--poll-period-seconds", type=float,
                   default=float(os.environ.get("POLL_PERIOD_SECONDS", "30")))
    p.add_argument("--metrics-port", type=int, default=DEFAULT_METRICS_PORT)
    p.add_argument("--health-port", type=int, default=DEFAULT_HEALTH_PORT)
    p.add_argument("--ingest-chunk", type=int, default=DEFAULT_INGEST_CHUNK)
    p.add_argument("--pipeline-depth", type=int, default=DEFAULT_PIPELINE_DEPTH)
    p.add_argument("--max-tick-packets", type=int, default=DEFAULT_MAX_TICK_PACKETS)
    p.add_argument("--event-ring-size", type=int, default=1 << 21,
                   help="deny-event ring capacity, minimum 64 (overflow drops new "
                        "records and counts them as lost samples)")
    p.add_argument("--compressed", action="store_true", default=_env_set("INFW_COMPRESSED"),
                   help="serve trie-sized tables from the compressed ctrie layout "
                        "(kernel K3); tables it cannot hold take the trie path.  "
                        "CLI beats INFW_COMPRESSED")
    p.add_argument("--no-compressed", action="store_true",
                   help="the trie layout even when INFW_COMPRESSED is set")
    p.add_argument("--wire-codec", default=os.environ.get("INFW_WIRE_CODEC") or None,
                   help="host-to-device format of 4-word trie and ctrie chunks: "
                        "auto | wire8 | delta.  CLI beats INFW_WIRE_CODEC")
    p.add_argument("--patch-staleness-us", type=float,
                   default=os.environ.get("INFW_PATCH_STALENESS_US") or None,
                   help="bounded verdict staleness for batched rule edits "
                        "(infw_torch.txn): edits dropped into <state-dir>/edits/ "
                        "coalesce into ONE folded patch transaction and flush "
                        "when the oldest queued edit exceeds this budget (or "
                        "--patch-max-ops trips) — between classify admissions, "
                        "never stalling them.  Default 2000us.  CLI beats "
                        "INFW_PATCH_STALENESS_US")
    p.add_argument("--patch-max-ops", type=int,
                   default=os.environ.get("INFW_PATCH_MAX_OPS") or None,
                   help="batch-size flush threshold for queued rule edits "
                        "(default 1024): a queue this deep flushes regardless of "
                        "staleness.  CLI beats INFW_PATCH_MAX_OPS")
    p.add_argument("--tenants", type=int, default=os.environ.get("INFW_TENANTS") or None,
                   help="enable the multi-tenant paged arena with this many tenant ids: one "
                        "preallocated ctrie pool on the daemon's device, tenants created "
                        "lazily from <state-dir>/tenants/<name>/edits/ (the edit-file codec "
                        "of edits/), ruleset activation by page-table flip, tenant_* "
                        "counters on /metrics.  Slab geometry via INFW_TENANT_SLAB_ENTRIES "
                        "(default 1024) and INFW_TENANT_RULE_SLOTS (default 16).  CLI beats "
                        "INFW_TENANTS")
    p.add_argument("--flow-table", type=int, default=os.environ.get("INFW_FLOW_TABLE") or None,
                   help="enable the stateful flow tier with this many entries per flow slab "
                        "(a power of two): an exact-match verdict cache on the card probed "
                        "before the LPM and the rule scan (kernels K7 and K8); established "
                        "flows serve their cached verdict and only the misses are "
                        "classified; edits and tenant swaps invalidate by a generation "
                        "bump.  INFW_FLOW_WAYS sets the ways (default 4), "
                        "INFW_FLOW_MAX_AGE the freshness horizon in probes.  CLI beats "
                        "INFW_FLOW_TABLE")
    p.add_argument("--resident", action="store_true", default=_env_set("INFW_RESIDENT"),
                   help="serve each job through the resident step: one copy in, one CUDA "
                        "graph of the flow probe, the classify, the merge and the flow "
                        "insert, one read back (cuda backend); implies a flow table (the "
                        "default geometry without --flow-table); resident_* gauges on "
                        "/metrics.  CLI beats INFW_RESIDENT")
    p.add_argument("--telemetry", nargs="?", const="2048",
                   default=os.environ.get("INFW_TELEMETRY") or None,
                   help="the telemetry plane on the card (cuda backend): count-min and "
                        "heavy-hitter sketches and per-tenant counters updated in the "
                        "serving dispatch (kernel K9), per-tenant top-talker / deny-storm / "
                        "SYN-rate summaries in events.log at a decimated cadence, "
                        "telemetry_* counters on /metrics, token-bucket sampling of raw deny "
                        "events.  Optional value = count-min width (default 2048); "
                        "INFW_TELEMETRY_DEPTH and INFW_TELEMETRY_TOPK set depth and top-K.  "
                        "CLI beats INFW_TELEMETRY")
    p.add_argument("--telemetry-drain", type=int,
                   default=os.environ.get("INFW_TELEMETRY_DRAIN") or 256,
                   help="admissions per sketch drain (one small read back each; default "
                        "256).  CLI beats INFW_TELEMETRY_DRAIN")
    p.add_argument("--trace", action="store_true", default=_env_set("INFW_TRACE"),
                   help="serving-path tracing: per-stage span clocks (ingest -> pack -> "
                        "h2d -> dispatch -> materialize -> drain) as Prometheus histograms "
                        "on /metrics, with sampled trace-span lines for slow jobs in "
                        "events.log.  CLI beats INFW_TRACE")
    p.add_argument("--trace-slow-us", type=float,
                   default=os.environ.get("INFW_TRACE_SLOW_US") or 50_000.0,
                   help="slow-job threshold of the sampled trace-span lines (default "
                        "50000us).  CLI beats INFW_TRACE_SLOW_US")
    p.add_argument("--mlscore", nargs="?", const="default",
                   default=os.environ.get("INFW_MLSCORE") or None,
                   help="the anomaly-scoring tier on the card (cuda backend): per-source "
                        "features, a decision forest and an optional int8 MLP head scored in "
                        "the serving dispatch (kernel K10).  Optional value = a versioned "
                        "model artifact (.npz + .json manifest, infw_torch.mlscore.save_model); "
                        "the bare flag loads the built-in detection forest.  anomaly-verdict "
                        "records in events.log, mlscore_* counters on /metrics, and "
                        "<state-dir>/models/ hot-swaps artifacts (a swap behaves like a rule "
                        "patch).  CLI beats INFW_MLSCORE")
    p.add_argument("--mlscore-mode", choices=("shadow", "enforce"),
                   default=os.environ.get("INFW_MLSCORE_MODE") or "shadow",
                   help="anomaly mitigation: shadow (default) scores and records only; "
                        "enforce rewrites anomalous lanes to Deny (ruleId 0), never a "
                        "failsafe port and never a rule Deny.  CLI beats INFW_MLSCORE_MODE")
    p.add_argument("--payload", nargs="?", const="default",
                   default=os.environ.get("INFW_PAYLOAD") or None,
                   help="the payload tier on the card (cuda backend): Aho-Corasick matching "
                        "of each packet's payload prefix in the serving dispatch (kernel "
                        "K11).  Optional value = a versioned pattern-set artifact (.npz + "
                        ".json manifest, infw_torch.payload.save_patterns) or a count of "
                        "seeded signature patterns; the bare flag (or 'default') takes 32.  "
                        "payload_* counters on /metrics, and <state-dir>/patterns/ hot-swaps "
                        "artifacts (a swap behaves like a rule patch).  Frames files carry "
                        "no payload bytes, so they are served on headers.  CLI beats "
                        "INFW_PAYLOAD")
    p.add_argument("--payload-mode", choices=("shadow", "enforce"),
                   default=os.environ.get("INFW_PAYLOAD_MODE") or "shadow",
                   help="payload mitigation: shadow (default) matches and counts only; "
                        "enforce rewrites matched lanes to Deny (ruleId 0), never a failsafe "
                        "port and never a rule Deny.  CLI beats INFW_PAYLOAD_MODE")
    p.add_argument("--payload-plen", type=int,
                   default=int(os.environ.get("INFW_PAYLOAD_PLEN") or 0) or None,
                   help="the payload prefix width in bytes, 64 or 128 (occurrences crossing "
                        "it never match).  Default 64, or the artifact's width.  CLI beats "
                        "INFW_PAYLOAD_PLEN")
    p.add_argument("--ring", default=os.environ.get("INFW_RING") or None,
                   help="the ingest ring: path of a shared-memory ring file the daemon "
                        "CREATES and consumes (producers attach with python -m "
                        "infw_torch.tools.loadgen --ring PATH).  Producers write packed "
                        "wire records in place, with TCP flags and, with --payload, the "
                        "payload prefix column; the file loop admits by ring cursor, "
                        "ring_* gauges on /metrics.  CLI beats INFW_RING")
    p.add_argument("--superbatch-k", type=int, default=None,
                   help="stack up to K committed ring records of one shape into one "
                        "superbatch dispatch of the resident step (default "
                        "INFW_SUPERBATCH_K or 1 = each record alone)")
    for flag, env, item in REFUSED_FLAGS:
        p.add_argument(flag, nargs="?", const="1", default=None,
                       help=f"not in the port yet: {item} (also {env})")
    args = p.parse_args(argv)

    for flag, env, item in REFUSED_FLAGS:
        given = getattr(args, flag[2:].replace("-", "_"))
        if given is not None or _env_asks(env):
            p.error(f"{flag} ({env}) is not in the port yet: {item}")
    if not args.node_name:
        p.error("environment variable NODE_NAME or --node-name is required")
    if args.backend not in BACKENDS:
        p.error(f"invalid backend {args.backend!r} (expected one of {BACKENDS})")
    if args.resident and args.backend == "cpu":
        p.error("--resident requires the cuda backend (the cpu backend serves the "
                "multi-dispatch path)")
    if args.ring:
        ring_dir = os.path.dirname(os.path.abspath(args.ring)) or "."
        if not os.path.isdir(ring_dir):
            p.error(f"--ring directory does not exist: {ring_dir}")
    # argparse checks choices only on explicit flags, not env defaults: a
    # bad INFW_WIRE_CODEC must fail the launch, not the first sync
    if args.wire_codec is not None and args.wire_codec not in WIRE_CODECS:
        p.error(f"invalid wire codec {args.wire_codec!r} (expected one of {WIRE_CODECS})")
    # flag or env-derived (argparse converts a string default by type): a
    # non-positive value fails the launch, not the first flush
    if args.patch_staleness_us is not None and not args.patch_staleness_us > 0:
        p.error(f"--patch-staleness-us must be positive, got {args.patch_staleness_us}")
    if args.patch_max_ops is not None and args.patch_max_ops < 1:
        p.error(f"--patch-max-ops must be >= 1, got {args.patch_max_ops}")
    if args.tenants is not None and int(args.tenants) < 1:
        p.error(f"--tenants must be >= 1, got {args.tenants}")
    # a bad flow geometry (flag or env) fails the launch with a usage
    # error, as in the JAX daemon
    flow_cfg = None
    if args.flow_table is not None and str(args.flow_table) not in ("0", "", "false", "no"):
        if int(args.flow_table) < 1:
            p.error(f"--flow-table must be >= 1, got {args.flow_table}")
        try:
            flow_cfg = FlowConfig.make(
                entries=int(args.flow_table),
                ways=int(os.environ.get("INFW_FLOW_WAYS") or 4),
                max_age=int(os.environ.get("INFW_FLOW_MAX_AGE") or FlowConfig().max_age),
            )
        except ValueError as e:
            p.error(str(e))
    # a bad sketch width or drain cadence (flag or env) fails the launch,
    # never the sync loop (the JAX daemon's validation)
    telemetry_spec = None
    if args.telemetry is not None and str(args.telemetry) not in ("0", "", "false", "no"):
        if args.backend == "cpu":
            p.error("--telemetry requires the cuda backend (the cpu backend has no device "
                    "sketch plane)")
        raw = str(args.telemetry)
        if raw in ("1", "true", "yes"):
            raw = "2048"  # bare flag or truthy env: the default geometry
        try:
            if int(raw) < 8:
                raise ValueError(f"--telemetry width must be >= 8, got {raw}")
            telemetry_spec = SketchSpec.make(
                width=int(raw),
                depth=int(os.environ.get("INFW_TELEMETRY_DEPTH") or 4),
                topk=int(os.environ.get("INFW_TELEMETRY_TOPK") or 256),
            )
        except ValueError as e:
            p.error(str(e))
    if int(args.telemetry_drain) < 1:
        p.error(f"--telemetry-drain must be >= 1, got {args.telemetry_drain}")
    if not float(args.trace_slow_us) > 0:
        p.error(f"--trace-slow-us must be positive, got {args.trace_slow_us}")
    # a cpu backend, a bad INFW_MLSCORE_MODE, a bad artifact or enforce
    # without scoring fail the launch with a usage error (the JAX daemon's)
    mlscore_bundle = None
    if args.mlscore is not None and str(args.mlscore) not in ("0", "", "false", "no"):
        if args.backend == "cpu":
            p.error("--mlscore requires the cuda backend (the cpu backend has no scoring plane)")
        if args.mlscore_mode not in ("shadow", "enforce"):
            p.error(f"invalid INFW_MLSCORE_MODE {args.mlscore_mode!r} (expected shadow|enforce)")
        raw = str(args.mlscore)
        try:
            if raw in ("default", "1", "true", "yes"):
                spec = ScoreSpec.make()
                model = default_model(spec)
            else:
                from .mlscore import load_model

                model = load_model(raw)
                spec = model.spec
            mlscore_bundle = (spec, model)
        except (ValueError, OSError) as e:
            p.error(f"--mlscore: {e}")
    elif args.mlscore_mode == "enforce":
        p.error("--mlscore-mode enforce requires --mlscore")
    # the payload knobs: the same launch-time validation (the JAX daemon's)
    payload_patterns = None
    payload_plen = None
    if args.payload is not None and str(args.payload) not in ("0", "", "false", "no"):
        if args.backend == "cpu":
            p.error("--payload requires the cuda backend (the cpu backend has no payload "
                    "plane)")
        if args.payload_mode not in ("shadow", "enforce"):
            p.error(f"invalid INFW_PAYLOAD_MODE {args.payload_mode!r} (expected shadow|enforce)")
        from .kernels.wire_decode import PAYLOAD_PREFIX_WIDTHS

        if args.payload_plen is not None:
            if int(args.payload_plen) not in PAYLOAD_PREFIX_WIDTHS:
                p.error(f"--payload-plen must be one of {PAYLOAD_PREFIX_WIDTHS}, got "
                        f"{args.payload_plen}")
            payload_plen = int(args.payload_plen)
        raw = str(args.payload)
        try:
            if raw in ("default", "1", "true", "yes") or raw.isdigit():
                from .payload import signature_patterns

                payload_patterns = signature_patterns(
                    np.random.default_rng(0), int(raw) if raw.isdigit() else 32,
                    plen=payload_plen or PAYLOAD_PREFIX_WIDTHS[0])
            else:
                from .payload import load_patterns

                payload_patterns, pspec, _version = load_patterns(raw)
                if payload_plen is None:
                    payload_plen = int(pspec.plen)
        except (ValueError, OSError) as e:
            p.error(f"--payload: {e}")
    elif args.payload_mode == "enforce":
        p.error("--payload-mode enforce requires --payload")

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    daemon = Daemon(
        state_dir=args.state_dir,
        node_name=args.node_name,
        namespace=args.namespace,
        backend=args.backend,
        poll_period_s=args.poll_period_seconds,
        debug_lookup=os.environ.get("ENABLE_LPM_LOOKUP_DBG", "0") not in ("0", "", "false"),
        metrics_port=args.metrics_port,
        health_port=args.health_port,
        ingest_chunk=args.ingest_chunk,
        max_tick_packets=args.max_tick_packets,
        event_ring_size=args.event_ring_size,
        pipeline_depth=args.pipeline_depth,
        wire_codec=args.wire_codec,
        compressed=False if args.no_compressed else (True if args.compressed else None),
        patch_staleness_us=args.patch_staleness_us,
        patch_max_ops=args.patch_max_ops,
        tenants=int(args.tenants) if args.tenants else None,
        flow_table=flow_cfg,
        resident=args.resident,
        telemetry=telemetry_spec,
        telemetry_drain=int(args.telemetry_drain),
        trace=args.trace,
        trace_slow_us=float(args.trace_slow_us),
        mlscore=mlscore_bundle,
        mlscore_mode=args.mlscore_mode,
        payload=payload_patterns,
        payload_mode=args.payload_mode,
        payload_plen=payload_plen,
        ring=args.ring,
        superbatch_k=args.superbatch_k,
    )
    stop = threading.Event()

    def on_term(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, on_term)
    signal.signal(signal.SIGINT, on_term)
    daemon.start()
    try:
        while not stop.wait(0.5):
            pass
    finally:
        daemon.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
