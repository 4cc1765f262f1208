"""Single-GPU classifier backends: the dense, trie and ctrie paths
(TorchClassifier) and the multi-tenant arena of either family with its
dense overlay side-pool (TorchArenaClassifier, at the end of this module).

The counterpart of the JAX package's TpuClassifier, stateless serving on
one device: compiled rule tables live on the card, each batch is packed
into the wire format on the host, copied in once, unpacked and classified
by kernel K1 (kernels/dense.py, tables of at most ``dense_limit`` entries),
kernel K2 (kernels/walk.py, the trie path) or kernel K3 (kernels/cwalk.py,
the compressed ctrie path), and read back once as one int32 buffer of
results and statistics (results only for the wire8 and delta formats).

- **wire format** (``_plan``, the JAX package's ``_plan_wire``): a
  non-empty 4-word (IPv4-compact) chunk on the trie or ctrie path ships the
  delta stream (packets.encode_delta_wire: the chunk sorted by IP, varint or
  fixed-stride deltas, dictionary-coded metadata; decoded on the card by
  kernels/wire_decode.py with kernel K4) when ``wire_codec`` is "delta", or
  "auto" and its bucket-padded bytes come to less than 8 per packet;
  otherwise the 8-byte wire8 (packets.wire8) when it qualifies.  Both leave
  pkt_len on the host: statistics come from the returned verdicts
  (base.stats_from_results), and a delta chunk's verdicts are put back in
  chunk order on the host.  The dense path, 7-word chunks and empty chunks
  ship the narrow wire (packets.narrow_wire), or the full one when it does
  not qualify.  ``wire_codec`` is the argument, else ``INFW_WIRE_CODEC``,
  else "auto"; ``wire_stats()`` counts the packets and bytes each format
  shipped.

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
- **incremental patches** (``load_tables(tables, dirty_hint=...)``, the
  JAX package's Map.Update analogue): on the trie and ctrie paths, when
  the resident generation is on the same path, only the rows that changed
  cross the link (walk.patch_trie_tables, cwalk.patch_ctrie; the hint of
  IncrementalTables.peek_dirty() names them without a host diff), retried
  without the hint where the reference retries, else a full padded upload.
  A patch never writes a resident tensor: each changed array is a
  device-side clone that takes the staged rows with ``index_copy_``, and
  the unchanged ones are shared.  A batch that snapshotted the old
  generation (``prepare_packed`` holds it until ``classify_prepared``)
  may launch after the patch and still reads exactly the old tables, with
  the depth class it was steered by; writing in place would need every
  such launch ordered before the write, which no lock here can promise.
  The clone costs a device-to-device copy of each changed array (a read
  and a write of its bytes) and its size in memory until the old
  generation is released.  The clones and copies are enqueued on the
  loading thread's current stream (an edit flush loads from its own
  thread); the load records an event there, and a classify that
  snapshots the new generation on another stream waits on it first.
  ``_last_load`` records ("patch" | "full", rows).  The dense path always
  uploads in full, as the reference does.
- **overlay** (``load_tables(..., overlay=ov)``): a small side table of
  structurally new keys, combined with the main table by longest prefix
  on the trie and ctrie paths (kernels/overlay.py: the main side on K2 or
  K3, the overlay on K1).  An unchanged overlay object keeps its device
  copy.  The dense path and wide ruleIds refuse an overlay with
  ValueError, as the reference does.
- **asynchronous launch**: ``classify_async``/``classify_prepared``
  enqueue the copy and the kernels on the current CUDA stream and return
  a PendingClassify; the device-to-host read happens in ``.result()``.
- statistics accumulate on the host in int64 from each batch's (1024, 6)
  int32 sums, applied exactly once when a batch materializes.
- **flow tier** (``flow_table=``, else ``INFW_FLOW_TABLE``, else off; the
  JAX package's ``_launch_flow``): a 4- or 7-word chunk is probed first
  (kernel K7, flow.FlowTier), before the tables are snapshotted; the hits
  serve their cached verdict, the misses are compacted into a power-of-two
  bucket padded with KIND_OTHER rows and classified by the stateless path
  above (every wire format still applies to them), and their verdicts are
  inserted (kernel K8) when the batch materializes.  ``load_tables`` bumps
  the flow generation once, after the install: every patch, edit flush,
  rebuild and overlay change goes through it.
- **resident serving** (``resident=``, else ``INFW_RESIDENT``, else off;
  the JAX package's ``_plan_resident``): a flow tier is implied (a default
  ``FlowConfig.make()`` when none was given), and ``prepare_packed``
  dispatches a 4- or 7-word chunk, as it is (no narrowing, wire8 or delta),
  through the resident step (kernels/resident.py, infw_torch/resident.py):
  one copy in, K7, the path's classify of every lane, the merge and K8 in
  one CUDA graph, and one read back of the merged results, the hit bitmap
  and the flow counts, from which the host derives the statistics.  A
  generation the step cannot serve (wide ruleIds) counts a ``fallback`` and
  takes the multi-dispatch plan.  ``prepare_packed_super`` /
  ``classify_prepared_super`` run K stacked chunks as one superbatch.
- **telemetry plane** (``telemetry=``: True, a count-min width or a
  SketchSpec; else ``INFW_TELEMETRY``; else off; the JAX package's
  ``TelemetryTier`` hooks): count-min, heavy-hitter and per-tenant
  counters on the card (obs.telemetry.TelemetryTier, kernel K9).  A
  resident admission updates them as the step's fourth stage; any other
  ``prepare_packed`` plan (flow or stateless) launches K9 once when it
  materializes, over the served verdicts (the flow plan's miss
  sub-dispatch is not counted again).  The batch path without a flow tier
  (``classify`` of a PacketBatch) updates nothing, as in the reference.
  ``telemetry`` is the tier, ``telemetry_counters()`` its /metrics
  counters.  ``TorchArenaClassifier`` has no telemetry, as in the
  reference.
- **anomaly scoring** (``mlscore=``: True, a slot count or a ScoreSpec;
  else ``INFW_MLSCORE``; else off; ``mlscore_model=`` a ScoreModel,
  ``mlscore_mode=`` shadow | enforce, else ``INFW_MLSCORE_MODE``, else
  shadow; the JAX package's ``AnomalyTier`` hooks): per-source features,
  a decision forest and an optional int8 MLP head on the card
  (infw_torch.mlscore.AnomalyTier, kernel K10), with a per-tenant policy
  that in enforce mode rewrites anomalous lanes to Deny (ruleId 0), never
  a failsafe cell or a rule Deny.  A resident admission scores as a stage
  of its step, between the probe and the insert, so the flow table caches
  the enforced verdicts; a flow plan launches K10 once when it
  materializes, between the merge and the insert; a stateless plan once
  when it materializes, before the telemetry launch, and re-derives
  verdicts, XDP and statistics on the host when the policy rewrote a
  lane.  A model swap (``set_score_model``) or a policy flip bumps the
  flow generation.  ``mlscore`` is the tier, ``mlscore_counters()`` its
  /metrics counters.  ``TorchArenaClassifier`` scores nothing, as in the
  reference.
- **payload tier** (``payload=``: a PayloadTier, an AcModel, a pattern
  list, an artifact path, True or a pattern count; else ``INFW_PAYLOAD``;
  else off; ``payload_mode=`` shadow | enforce, else ``INFW_PAYLOAD_MODE``,
  else shadow; ``payload_plen=`` 64 or 128; the JAX package's
  ``PayloadTier`` hooks): Aho-Corasick matching of each packet's payload
  prefix on the card (infw_torch.payload.PayloadTier, kernel K11), which in
  enforce mode rewrites matched lanes to Deny (ruleId 0), never a failsafe
  cell or a rule Deny.  Only admissions that carry a payload column
  (``batch.payload``, ``prepare_packed(payload=, payload_len=)``,
  ``prepare_packed_super(payload_stack=, payload_len_stack=)``) are
  matched.  A resident admission matches as a stage of its step, after the
  score and before the insert; a flow plan launches K11 once when it
  materializes, after the score and before the insert, so the flow table
  caches the enforced verdicts; a stateless plan (and ``classify`` without
  a flow tier) once when it materializes, after the score and before the
  telemetry launch.  A pattern swap (``set_payload_patterns``) or a mode
  flip (``set_payload_mode``) bumps the flow generation.  ``payload`` is
  the tier, ``payload_counters()`` its /metrics counters.
  ``TorchArenaClassifier`` has no payload tier, as in the reference.

The device is the first CUDA card unless the caller names another
(``device="cpu"`` runs the plain PyTorch version of every kernel, which is
what the CPU tests do).  There is no silent fallback to the CPU.
"""
from __future__ import annotations

import contextlib
import os
import threading
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from .. import arena as arena_mod
from ..compiler import CompiledTables
from .. import flow as flow_mod
from .. import resident as resident_mod
from ..constants import ALLOW, DENY, KIND_IPV6
from ..kernels import arena_dense, arena_walk, cwalk, dense, torchpath, walk, wire_decode
from ..kernels import flow as kflow
from ..kernels import overlay as overlay_mod
from ..kernels.mxu_score import ScoreSpec
from ..kernels.resident import resident_fused_host, split_resident_step_outputs
from ..kernels.sketch import SketchSpec
from ..layout import (
    build_depth_lut,
    check_wire_ruleids,
    depth_group_indices,
    hint_trie_unchanged,
    joined_by_tidx,
    seed_caches_forward,
    tune_depth_classes,
    v4_trie_depth,
)
from ..mlscore import AnomalyTier
from ..kernels.acmatch import AcModel
from ..obs.telemetry import TelemetryTier
from ..payload import PayloadTier, clamp_payload
from ..packets import PacketBatch, encode_delta_wire, narrow_wire, wire8
from .base import ClassifyOutput, PendingClassify, StatsAccumulator, stats_from_results

#: where the parts this backend does not serve yet are queued
INVARIANTS_ITEM = "ROADMAP.md item 17 (verifiers for the port)"
#: host-to-device formats of a 4-word chunk on the trie and ctrie paths
WIRE_CODECS = ("auto", "wire8", "delta")


def _flow_config(flow_table, **geometry) -> "Optional[flow_mod.FlowConfig]":
    """A classifier's flow tier: ``flow_table`` (a FlowConfig, whose pages
    and max_tenants ``geometry`` overrides, or an entry count), else
    INFW_FLOW_TABLE (an entry count), else None."""
    if flow_table is None:
        env = os.environ.get("INFW_FLOW_TABLE", "")
        if env and env not in ("0", "false", "no"):
            flow_table = int(env)
    if flow_table is None or flow_table is False:
        return None
    if isinstance(flow_table, flow_mod.FlowConfig):
        return flow_table._replace(**geometry)
    return flow_mod.FlowConfig.make(entries=int(flow_table), **geometry)


def _miss_bucket(wire_np: np.ndarray, miss: np.ndarray):
    """The miss rows padded to flow_miss_bucket(m) with KIND_OTHER rows
    (PASS, counted nowhere) -> (wire, m)."""
    m = len(miss)
    miss_wire = wire_np[miss]
    bucket = flow_mod.flow_miss_bucket(m)
    if bucket > m:
        pad = np.zeros((bucket - m, miss_wire.shape[1]), np.uint32)
        pad[:, 0] = 3  # KIND_OTHER
        miss_wire = np.concatenate([miss_wire, pad])
    return miss_wire, m


def _miss_flags(tcp_flags, miss: np.ndarray, rows: int):
    if tcp_flags is None:
        return None
    out = np.zeros(rows, np.int32)
    out[: len(miss)] = np.asarray(tcp_flags, np.int32)[miss]
    return out


def _flow_materialize(tier, fused, ctx, wire_np: np.ndarray, kind: np.ndarray, tcp_flags,
                      classify_misses, tenant: Optional[np.ndarray] = None, score=None):
    """The flow plan's second half (tpu.py _launch_flow and
    _classify_flow_tenant): decode the probe's buffer, take the hit lanes'
    statistics from their verdicts and pkt_len, classify the compacted
    misses with ``classify_misses(miss_wire, miss_tenant)`` (the
    classifier's stateless dispatch; ``miss_tenant`` is None without a
    ``tenant`` column, else -1 on the padding rows), merge, score the merged
    verdicts with ``score(res16) -> res16'`` when given (the statistics
    re-derived when the policy rewrote a lane, and the rewritten verdicts
    are what the flow table caches), insert the misses' verdicts with their
    flags, and finalize -> ClassifyOutput (its statistics not yet
    applied)."""
    n = wire_np.shape[0]
    res16, hitmask, hits, stale = kflow.split_flow_probe_outputs(fused.cpu().numpy(), n)
    tier.stats.add(hits=hits, misses=n - hits, stale_rejects=stale)
    res16 = res16.copy()
    pkt_len = TorchClassifier._wire4_pkt_len(wire_np)
    stats_delta = stats_from_results(res16.astype(np.uint32), pkt_len)
    miss = np.nonzero(~hitmask)[0]
    if len(miss):
        miss_wire, m = _miss_bucket(wire_np, miss)
        miss_tenant = None
        if tenant is not None:
            miss_tenant = np.full(miss_wire.shape[0], -1, np.int32)
            miss_tenant[:m] = tenant[miss]
        out = classify_misses(miss_wire, miss_tenant)
        res16[miss] = (out.results[:m] & 0xFFFF).astype(np.uint16)
        stats_delta += out.stats_delta
    if score is not None:
        new16 = score(res16)
        if not np.array_equal(new16, res16):
            res16 = new16
            stats_delta = stats_from_results(res16.astype(np.uint32), pkt_len)
    if len(miss):
        verdicts = np.zeros(miss_wire.shape[0], np.uint32)
        verdicts[:m] = res16[miss]
        tier.insert(ctx, miss_wire, verdicts, tenant_np=miss_tenant,
                    tflags_np=_miss_flags(tcp_flags, miss, miss_wire.shape[0]))
    results, xdp = torchpath.host_finalize_wire(res16, kind)
    return ClassifyOutput(results=results, xdp=xdp, stats_delta=stats_delta)


def _payload_tier(payload, mode: Optional[str], plen: Optional[int],
                  device) -> Optional[PayloadTier]:
    """A classifier's payload tier (tpu.py's precedence): ``payload`` (a
    PayloadTier, used as it is; an AcModel; a pattern list; an artifact path;
    True or a count of seeded signature patterns), else INFW_PAYLOAD (an
    artifact path or a count), else None; the mode ``mode``, else
    INFW_PAYLOAD_MODE, else shadow; ``plen`` (else 64) the prefix width of a
    list or a count."""
    if payload is None:
        env = os.environ.get("INFW_PAYLOAD", "")
        if env and env not in ("0", "false", "no"):
            payload = env
    if mode is None:
        mode = os.environ.get("INFW_PAYLOAD_MODE") or "shadow"
    if payload is None or payload is False:
        return None
    from ..payload import load_patterns, signature_patterns

    plen = int(plen or 64)
    if isinstance(payload, PayloadTier):
        return payload
    if isinstance(payload, AcModel):
        return PayloadTier(payload, mode=mode, device=device)
    if isinstance(payload, (list, tuple)):
        return PayloadTier(payload, plen=plen, mode=mode, device=device)
    if isinstance(payload, str) and payload not in ("1", "true", "yes") and not payload.isdigit():
        pats, spec, _version = load_patterns(payload)
        return PayloadTier(pats, plen=spec.plen, mode=mode, spec=spec, device=device)
    count = 64 if payload is True or payload in ("1", "true", "yes") else int(payload)
    return PayloadTier(signature_patterns(np.random.default_rng(0), count, plen=plen), plen=plen,
                       mode=mode, device=device)


def _payload_columns(payload, payload_len):
    """An admission's payload column and its lengths (all of the row when
    None) as numpy, or (None, None) without a column."""
    if payload is None:
        return None, None
    pay = np.asarray(payload)
    plen = (np.asarray(payload_len, np.int32) if payload_len is not None
            else np.full(pay.shape[0], pay.shape[1], np.int32))
    return pay, plen


class _Active(NamedTuple):
    path: str  # "dense" | "trie" | "ctrie"
    dev: Union[dense.DenseTables, walk.TrieTables, cwalk.CTrieTables]
    wide_rids: bool
    ov: Optional[overlay_mod.OverlayTables] = None  # the overlay's device tables
    # (event, stream) recorded after the generation's uploads on a card
    ready: Optional[tuple] = None


class TorchClassifier:
    """Single-device classifier (dense, trie and ctrie paths)."""

    #: load_tables takes an overlay (see the module docstring), so the
    #: syncer routes structurally new keys on a trie-scale table to it
    supports_overlay = True

    def __init__(self, device=None, dense_limit: int = dense.MAX_DENSE_TARGETS,
                 force_path: Optional[str] = None,
                 compressed: Optional[bool] = None,
                 wire_codec: Optional[str] = None,
                 flow_table=None, flow_track_model: bool = False,
                 resident: Optional[bool] = None, telemetry=None,
                 telemetry_track_model: bool = False, mlscore=None, mlscore_model=None,
                 mlscore_mode: Optional[str] = None,
                 mlscore_track_model: bool = False, payload=None,
                 payload_mode: Optional[str] = None, payload_plen: Optional[int] = None,
                 payload_track: bool = False) -> None:
        if force_path not in (None, "dense", "trie", "ctrie"):
            raise ValueError(
                f"unknown force_path {force_path!r} (expected 'dense', 'trie', 'ctrie' or None)"
            )
        # the JAX package's precedence: the argument, else INFW_WIRE_CODEC,
        # else "auto"
        if wire_codec is None:
            wire_codec = os.environ.get("INFW_WIRE_CODEC") or "auto"
        if wire_codec not in WIRE_CODECS:
            raise ValueError(f"unknown wire codec {wire_codec!r} (expected one of {WIRE_CODECS})")
        self._wire_codec = wire_codec
        self._wire_counts = {}
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
        self._last_load = None  # ("patch" | "full", rows) of the last load
        self._ov_cache = None  # (overlay CompiledTables, its device tables)
        # (root_lut, depth LUT, classes, generation) of the trie tables in
        # service (None on the other paths); the generation is assigned
        # under the install lock
        self._depth_steer = None
        self._depth_gen = 0
        self._closed = False
        # the JAX package's precedence: the argument (a FlowConfig or an
        # entry count), else INFW_FLOW_TABLE (an entry count), else off
        self._flow = None
        cfg = _flow_config(flow_table)
        # the resident pool: the argument, else INFW_RESIDENT, else off; it
        # implies a flow tier (a default one when none was configured)
        if resident is None:
            env = os.environ.get("INFW_RESIDENT", "")
            resident = bool(env) and env not in ("0", "false", "no")
        self._resident = None
        if resident:
            if cfg is None:
                cfg = flow_mod.FlowConfig.make()
            self._resident = resident_mod.ResidentPool(self._device)
        if cfg is not None:
            self._flow = flow_mod.FlowTier(cfg, device=self._device,
                                           track_model=flow_track_model)
        # the telemetry plane: the argument (True, a count-min width or a
        # SketchSpec), else INFW_TELEMETRY ("1"/"true"/"yes" or a width),
        # else off
        if telemetry is None:
            env = os.environ.get("INFW_TELEMETRY", "")
            if env and env not in ("0", "false", "no"):
                telemetry = True if env in ("1", "true", "yes") else int(env)
        self._telemetry = None
        if telemetry is not None and telemetry is not False:
            if not isinstance(telemetry, SketchSpec):
                telemetry = (SketchSpec.make() if telemetry is True
                             else SketchSpec.make(width=int(telemetry)))
            self._telemetry = TelemetryTier(telemetry, device=self._device,
                                            track_model=telemetry_track_model)
        # anomaly scoring: the argument (True, a slot count or a ScoreSpec),
        # else INFW_MLSCORE, else off; the mode the argument, else
        # INFW_MLSCORE_MODE, else shadow
        if mlscore is None:
            env = os.environ.get("INFW_MLSCORE", "")
            if env and env not in ("0", "false", "no"):
                mlscore = True
        if mlscore_mode is None:
            mlscore_mode = os.environ.get("INFW_MLSCORE_MODE") or "shadow"
        self._mlscore = None
        if mlscore is not None and mlscore is not False:
            if not isinstance(mlscore, ScoreSpec):
                mlscore = (ScoreSpec.make() if mlscore is True
                           else ScoreSpec.make(slots=int(mlscore)))
            self._mlscore = AnomalyTier(mlscore, model=mlscore_model, device=self._device,
                                        mode=mlscore_mode, track_model=mlscore_track_model)
            # a model swap or a policy flip behaves like a rule patch
            self._mlscore.on_swap = self._on_score_model_swap
        self._payload = _payload_tier(payload, payload_mode, payload_plen, self._device)
        if self._payload is not None:
            if payload_track:
                self._payload.set_keep_masks(256)
            # a pattern swap behaves like a rule patch
            self._payload.on_swap = self._on_pattern_swap

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def flow(self) -> "Optional[flow_mod.FlowTier]":
        return self._flow

    def flow_counters(self) -> dict:
        return {} if self._flow is None else self._flow.counter_values()

    def flow_age_tick(self, horizon=None) -> int:
        return 0 if self._flow is None else self._flow.age(horizon)

    @property
    def resident(self) -> "Optional[resident_mod.ResidentPool]":
        """The ResidentPool when resident serving is on."""
        return self._resident

    def resident_counters(self) -> dict:
        """resident_* gauges for /metrics (empty when off)."""
        return {} if self._resident is None else self._resident.counter_values()

    @property
    def telemetry(self) -> "Optional[TelemetryTier]":
        """The TelemetryTier when the telemetry plane is on."""
        return self._telemetry

    def telemetry_counters(self) -> dict:
        """telemetry_* counters for /metrics (empty when off)."""
        return {} if self._telemetry is None else self._telemetry.counter_values()

    @property
    def mlscore(self) -> "Optional[AnomalyTier]":
        """The AnomalyTier when anomaly scoring is on."""
        return self._mlscore

    def mlscore_counters(self) -> dict:
        """mlscore_* counters for /metrics (empty when off)."""
        return {} if self._mlscore is None else self._mlscore.counter_values()

    def set_score_model(self, model, version=None) -> None:
        """Hot-swap the anomaly model (its value tensors rewritten in place,
        nothing captured again); the tier's on_swap then bumps the flow
        generation."""
        if self._mlscore is None:
            raise RuntimeError("mlscore tier is not enabled")
        self._mlscore.swap_model(model, version=version)

    def _on_score_model_swap(self) -> None:
        """Flow entries caching verdicts decided by the old model or policy
        go stale through the generation stamps every table edit uses."""
        if self._flow is not None:
            self._flow.bump_generation()

    @property
    def payload(self) -> "Optional[PayloadTier]":
        """The PayloadTier when the payload tier is on."""
        return self._payload

    def payload_counters(self) -> dict:
        """payload_* counters for /metrics (empty when off)."""
        return {} if self._payload is None else self._payload.counter_values()

    def set_payload_patterns(self, patterns_or_model, plen: Optional[int] = None) -> None:
        """Hot-swap the pattern set within the tier's AcSpec (the tables
        rewritten in place, nothing captured again); the tier's on_swap then
        bumps the flow generation."""
        if self._payload is None:
            raise RuntimeError("payload tier is not enabled")
        self._payload.swap_patterns(patterns_or_model, plen=plen)

    def set_payload_mode(self, mode: str) -> None:
        """Flip shadow / enforce (the mode tensor written in place); flow
        entries cached under the old mode go stale."""
        if self._payload is None:
            raise RuntimeError("payload tier is not enabled")
        self._payload.set_mode(mode)
        self._on_pattern_swap()

    def _on_pattern_swap(self) -> None:
        """Flow entries caching verdicts decided by the old pattern set or
        mode go stale through the generation stamps every table edit uses."""
        if self._flow is not None:
            self._flow.bump_generation()

    def mark_resident_warm(self) -> None:
        """Bring the device epoch to the host counter (the classic warm
        moved only the latter), then freeze the pool's allocation baseline:
        any allocation after this is the serving path's."""
        if self._resident is not None:
            if self._flow is not None:
                self._flow.resident_seed_epoch()
            self._resident.mark_warm()

    # -- rule loading -------------------------------------------------------

    def load_tables(self, tables: CompiledTables, dirty_hint=None,
                    overlay: Optional[CompiledTables] = None) -> None:
        """Swap in a ruleset (tpu.py load_tables).  On the trie and ctrie
        paths a generation that follows one on the same path is patched
        (see the module docstring); ``dirty_hint`` is
        IncrementalTables.peek_dirty() since the resident generation's
        load, the rows to ship without a host diff.  ``overlay`` is a small
        side table of keys disjoint from ``tables``, combined by longest
        prefix; an overlay with entries on the dense path or with wide
        ruleIds raises ValueError."""
        if self._closed:
            raise RuntimeError("classifier is closed")
        path = self._force_path or (
            "dense" if tables.num_entries <= self._dense_limit else "trie"
        )
        if path == "trie" and self._compressed and self._force_path is None:
            path = "ctrie"  # the upgrade applies to the auto-selected trie path only
        with self._lock:
            prev_tables, prev_active = self._tables, self._active
        if path == "ctrie":
            # a rules-only edit carries the old generation's host layouts
            # forward before the probes below build any of them
            if prev_tables is not None and dirty_hint is not None:
                seed_caches_forward(prev_tables, tables, dirty_hint)
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
        if overlay is not None and overlay.num_entries > 0 and (
                path not in ("trie", "ctrie") or wide_rids):
            raise ValueError(
                f"overlay not supported on path={path} (wide_rids={wide_rids}); "
                "merge it into the main table"
            )
        steer = None
        if path == "dense":
            last = ("full", tables.num_entries)
        else:
            same_path = prev_active is not None and prev_active.path == path
            build, patch = ((cwalk.build_ctrie_tables, cwalk.patch_ctrie) if path == "ctrie"
                            else (walk.build_trie_tables, walk.patch_trie_tables))
            patched = None
            if same_path:
                patched = patch(prev_active.dev, prev_tables, tables, self._device,
                                hint=dirty_hint)
                # a retry without the hint differs only where the hint took
                # a fast path: any hint on the trie path, a rules-only one
                # on the ctrie path (tpu.py:433-442, 475-480)
                retry = (hint_trie_unchanged(dirty_hint) if path == "ctrie"
                         else dirty_hint is not None)
                if patched is None and retry:
                    patched = patch(prev_active.dev, prev_tables, tables, self._device)
            if patched is not None:
                dev, rows = patched
                last = ("patch", rows)
            else:
                dev = build(tables, self._device, pad=True)
                last = ("full", tables.num_entries)
            if path == "trie":
                steer = (
                    np.asarray(tables.root_lut, np.int64),
                    build_depth_lut(tables),
                    tune_depth_classes(tables),
                )
        ov_dev = None
        if overlay is not None and overlay.num_entries > 0:
            with self._lock:
                cached = self._ov_cache
            if cached is not None and cached[0] is overlay:
                ov_dev = cached[1]  # the same overlay: keep its device copy
            else:
                ov_dev = overlay_mod.build_overlay_tables(overlay, self._device)
                with self._lock:
                    self._ov_cache = (overlay, ov_dev)
        ready = None
        if self._device.type == "cuda":
            stream = torch.cuda.current_stream(self._device)
            ready = (torch.cuda.Event(), stream)
            ready[0].record(stream)
        with self._lock:
            self._tables = tables
            self._active = _Active(path, dev, wide_rids, ov_dev, ready)
            self._last_load = last
            self._depth_gen += 1
            self._depth_steer = None if steer is None else steer + (self._depth_gen,)
        if self._flow is not None:
            # the invalidation chokepoint: every table mutation comes
            # through here, so no cached verdict outlives its tables
            self._flow.bump_generation(0)

    # -- classify -----------------------------------------------------------

    def _snapshot(self) -> _Active:
        with self._lock:
            active = self._active
        if active is None:
            raise RuntimeError("no rule tables loaded")
        if active.ready is not None:
            event, stream = active.ready
            current = torch.cuda.current_stream(self._device)
            if current != stream:
                # the generation was uploaded on another thread's stream:
                # order this classify's work after it
                current.wait_event(event)
        return active

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
        # Packed wire: 16 B/packet for v4-only chunks, 28 B otherwise, which
        # _plan turns into the delta or wire8 format (a 4-word chunk on the
        # trie and ctrie paths) or the narrow wire.
        kind = np.asarray(batch.kind)
        v4_only = not bool((kind == KIND_IPV6).any())
        wire_np = batch.pack_wire_v4() if batch.is_v4_compactable() else batch.pack_wire()
        pay_np = plen_np = None
        if self._payload is not None and len(batch):
            pay_np, plen_np = _payload_columns(batch.payload, batch.payload_len)
        if self._flow is not None:
            # the flow tier first: only the misses reach the stateless path
            return self.classify_prepared(
                self.prepare_packed(wire_np, v4_only, tcp_flags=batch.tcp_flags,
                                    payload=pay_np, payload_len=plen_np),
                apply_stats=apply_stats)
        n_levels = None
        if active.path == "trie":
            n = active.dev.n_levels
            n_levels = v4_trie_depth(n) if v4_only else n
        pending = self._launch(self._plan(active, wire_np, kind, n_levels), apply_stats)
        if pay_np is None:
            return pending
        # one follow-on K11 launch an admission (tpu.py classify_async)
        return PendingClassify(lambda: self._apply_payload_wire(
            pending.result(), pay_np, plen_np, wire_np, apply_stats))

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
        tcp_flags: Optional[np.ndarray] = None, payload: Optional[np.ndarray] = None,
        payload_len: Optional[np.ndarray] = None,
    ) -> PendingClassify:
        """classify_async for a pre-packed (B, 4|7) uint32 wire array
        (PacketBatch.pack_wire_subset); ``depth`` is a (class, generation)
        pair from v6_depth_groups; ``tcp_flags`` (B,) feeds the flow tier's
        TCP model (None: no flags); ``payload`` (B, L) uint8 and
        ``payload_len`` (B,) the payload tier's column.  Caller contract:
        supports_packed()."""
        return self.classify_prepared(
            self.prepare_packed(wire_np, v4_only, depth=depth, tcp_flags=tcp_flags,
                                payload=payload, payload_len=payload_len),
            apply_stats=apply_stats,
        )

    def prepare_packed(self, wire_np: np.ndarray, v4_only: bool, depth=None,
                       tcp_flags: Optional[np.ndarray] = None,
                       payload: Optional[np.ndarray] = None,
                       payload_len: Optional[np.ndarray] = None):
        """First half of classify_async_packed: choose the walk depth and
        the wire width and start the host-to-device copy; returns the plan
        for classify_prepared, which finishes on the tables snapshotted
        here.  With a flow tier a 4- or 7-word chunk is probed here instead
        (tpu.py prepare_packed), BEFORE the snapshot: the probe captures the
        flow generations, so a load_tables between the two captures can
        only make the stamped generation older than the tables that
        compute the misses (their inserts are stale on arrival, never
        served); the reverse order could cache old-table verdicts under
        the new generation.  With the resident pool a 4- or 7-word chunk is
        dispatched whole here (``_plan_resident``).  An empty chunk takes the
        stateless plan alone: nothing to probe, cache, score, match or sketch,
        so no tier's state or counter moves (the JAX package raises there, or
        on the dense path counts an empty payload admission)."""
        stateful = wire_np.shape[0] > 0
        if self._resident is not None and self._flow is not None and stateful:
            plan = self._plan_resident(wire_np, v4_only, depth, tcp_flags, payload, payload_len)
            if plan is not None:
                return plan
        flow_probe = None
        if self._flow is not None and wire_np.shape[1] in (4, 7) and stateful:
            with self._lock:
                probe_ok = self._active is not None and not self._active.wide_rids
            if probe_ok:
                flow_probe = self._flow.probe(wire_np, tflags_np=tcp_flags)
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
        if flow_probe is not None:
            fused, ctx = flow_probe
            plan = {"flow": True, "fused": fused, "ctx": ctx, "wire_np": wire_np,
                    "tcp_flags": tcp_flags, "active": active, "kind": kind,
                    "n_levels": n_levels}
        else:
            plan = self._plan(active, wire_np, kind, n_levels)
        if self._telemetry is not None and stateful:
            # the multi-dispatch telemetry launch runs at materialize time
            # over the admission's served verdicts; a flow plan's miss
            # sub-dispatch goes through _plan / _launch and never counts
            plan["telem_wire"] = wire_np
            plan["telem_flags"] = tcp_flags
        if self._mlscore is not None and wire_np.shape[1] in (4, 7) and stateful:
            # one K10 launch when the plan materializes, over the merged rule
            # verdicts: a flow plan's between its merge and its insert, a
            # stateless plan's before the telemetry launch; a flow plan's miss
            # sub-dispatch goes through _plan / _launch and is not scored
            plan["ml_wire"] = wire_np
            plan["ml_flags"] = tcp_flags
        if self._payload is not None and payload is not None and stateful:
            # one K11 launch when the plan materializes: a flow plan's after
            # its score and before its insert, a stateless plan's after the
            # score and before the telemetry launch
            plan["pay_np"], plan["plen_np"] = _payload_columns(payload, payload_len)
            plan["pay_wire"] = wire_np
        return plan

    def classify_prepared(self, plan, apply_stats: bool = True) -> PendingClassify:
        """Second half: launch the classify on a prepare_packed plan (a
        resident plan's score, match and sketch updates rode its step; a
        flow plan's score and match run inside its materialize; any other
        plan's are one K10, one K11 and one K9 launch when it
        materializes)."""
        if plan.get("resident"):
            return self._launch_resident(plan, apply_stats)
        if plan.get("flow"):
            pending = self._launch_flow(plan, apply_stats)
            run_ml = run_pay = False
        else:
            pending = self._launch(plan, apply_stats)
            run_ml = self._mlscore is not None and "ml_wire" in plan
            run_pay = self._payload is not None and "pay_np" in plan
        tel = self._telemetry
        run_tel = tel is not None and "telem_wire" in plan
        if not run_ml and not run_pay and not run_tel:
            return pending

        def materialize() -> ClassifyOutput:
            out = pending.result()
            if run_ml:
                out = self._apply_mlscore_wire(out, plan["ml_wire"], plan["ml_flags"],
                                               apply_stats)
            if run_pay:
                # score, then payload, then telemetry counts what was served
                out = self._apply_payload_wire(out, plan["pay_np"], plan["plen_np"],
                                               plan["pay_wire"], apply_stats)
            if run_tel:
                tel.update(plan["telem_wire"], out.results, tflags_np=plan["telem_flags"])
            return out

        return PendingClassify(materialize)

    def _apply_mlscore_wire(self, out: ClassifyOutput, wire_np: np.ndarray, tcp_flags,
                            apply_stats: bool) -> ClassifyOutput:
        """Score one stateless admission (tpu.py _apply_mlscore_wire) and, when
        the policy rewrote a lane, re-derive its verdicts, XDP and
        statistics on the host."""
        res16, _anom, _scores = self._mlscore.update(wire_np, out.results, tflags_np=tcp_flags)
        if np.array_equal(res16, (out.results & 0xFFFF).astype(np.uint16)):
            return out
        results, xdp = torchpath.host_finalize_wire(res16, (wire_np[:, 0] & 3).astype(np.int32))
        stats_delta = stats_from_results(results, self._wire4_pkt_len(wire_np))
        if apply_stats:
            # the launch applied the pre-policy statistics: swap them
            self._stats.add(stats_delta - out.stats_delta)
        return ClassifyOutput(results=results, xdp=xdp, stats_delta=stats_delta)

    def _apply_payload_wire(self, out: ClassifyOutput, pay_np, plen_np, wire_np: np.ndarray,
                            apply_stats: bool) -> ClassifyOutput:
        """Match one stateless admission (tpu.py _apply_payload_wire) and,
        when enforce rewrote a lane, re-derive its verdicts, XDP and
        statistics on the host."""
        res16 = (out.results & 0xFFFF).astype(np.uint16)
        new16 = self._payload_policy(wire_np, res16, pay_np, plen_np)
        if np.array_equal(new16, res16):
            return out
        results, xdp = torchpath.host_finalize_wire(new16, (wire_np[:, 0] & 3).astype(np.int32))
        stats_delta = stats_from_results(results, self._wire4_pkt_len(wire_np))
        if apply_stats:
            # the launch applied the pre-policy statistics: swap them
            self._stats.add(stats_delta - out.stats_delta)
        return ClassifyOutput(results=results, xdp=xdp, stats_delta=stats_delta)

    def _payload_policy(self, wire_np: np.ndarray, res16: np.ndarray, pay_np,
                        plen_np) -> np.ndarray:
        """One K11 launch and the enforce rewrite on the host -> res16'."""
        f = flow_mod.host_unpack_wire(wire_np)
        new16, _hit = self._payload.apply_wire(res16.astype(np.uint16), pay_np, plen_np,
                                               f["proto"], f["dst_port"])
        return np.asarray(new16, np.uint16)

    # -- resident serving ----------------------------------------------------

    def _resident_levels(self, ctx, v4_only: bool, depth) -> Optional[int]:
        """The trie path's level count for a resident step (tpu.py
        _plan_resident: an IPv4-only chunk walks the levels within /32, a
        current depth class d 1 + d, any other chunk every level)."""
        if ctx.tables.path != "trie":
            return None
        n = ctx.tables.dev.n_levels
        if v4_only:
            return v4_trie_depth(n)
        if depth is not None:
            dclass, gen = depth
            with self._lock:
                cur_gen = self._depth_steer[3] if self._depth_steer else -1
            if dclass is not None and gen == cur_gen:
                return 1 + int(dclass)
        return n

    def _payload_stage(self, payload, payload_len):
        """The resident step's payload operands -> (tier, pay, plen), the
        column clamped to the tier's width (tpu.py _clamp_payload), or None
        without a tier or a column."""
        pt = self._payload
        if pt is None or payload is None:
            return None
        return (pt,) + clamp_payload(payload, payload_len, pt.spec.plen)

    def _plan_resident(self, wire_np: np.ndarray, v4_only: bool, depth, tcp_flags,
                       payload=None, payload_len=None):
        """Dispatch one admission through the resident step (tpu.py
        _plan_resident); the plan only carries what its materialize needs.
        Returns None for a chunk the step does not take (a width other than
        4 or 7) or a generation it cannot serve (wide ruleIds: counted as a
        fallback), and the caller takes the multi-dispatch plan."""
        if wire_np.shape[1] not in (4, 7):
            return None
        tier, pool = self._flow, self._resident
        # the flow generations before the tables (resident_gens_snapshot)
        gens_snap = tier.resident_gens_snapshot()
        ctx = pool.context(self)
        if ctx is None:
            pool.note("fallbacks")
            return None
        n = wire_np.shape[0]
        pay = self._payload_stage(payload, payload_len)
        fused, epoch = pool.dispatch(tier, ctx, self._resident_levels(ctx, v4_only, depth),
                                     wire_np, tcp_flags, gens_snap, telemetry=self._telemetry,
                                     mlscore=self._mlscore, payload=pay)
        pool.note("dispatches")
        pool.note(f"slot{(epoch - 1) & 1}_dispatches")
        self._note_wire(f"wire{wire_np.shape[1]}", n, wire_np.nbytes)
        if pay is not None:
            self._note_wire("payload", n, pay[1].nbytes + pay[2].nbytes)
        return {"resident": True, "fused": fused, "n": n, "epoch": epoch,
                "mlscore": self._mlscore is not None, "payload": pay,
                "kind": (wire_np[:, 0] & 3).astype(np.int32),
                "pkt_len": self._wire4_pkt_len(wire_np)}

    def _resident_output(self, arr: np.ndarray, n: int, epoch: int, kind, pkt_len,
                         apply_stats: bool, score: bool = False,
                         payload=None) -> ClassifyOutput:
        """One admission's read-back (tpu.py _launch_resident's
        materialize): the flow counters, the model's replay up to this
        epoch, the score outcome (``score``: the read back carries the
        scoring extension; its verdicts are the policy's), the payload
        outcome (``payload``: the step's (tier, pay, plen); the read back
        ends with the matched and rewritten lanes' bitmaps), eviction
        events, the verdicts, and the statistics from the verdicts and the
        host's pkt_len column."""
        tier = self._flow
        (res16, _hit, hits, stale, (inserts, evictions, promotes), anom, scores, pay_hit,
         pay_rw) = split_resident_step_outputs(arr, n, score, payload is not None)
        tier.stats.add(hits=hits, misses=n - hits, stale_rejects=stale, inserts=inserts,
                       evictions=evictions, promotes=promotes)
        tier.resident_note_materialized(epoch)
        if self._telemetry is not None:
            self._telemetry.resident_note_materialized(epoch)
        if anom is not None and self._mlscore is not None:
            self._mlscore.resident_note_materialized(epoch, anom_np=anom, score_np=scores)
        if pay_hit is not None:
            self._note_payload_resident(payload, pay_hit, pay_rw)
        if evictions and tier.on_evict is not None:
            try:
                tier.on_evict(evictions, inserts, epoch)
            except Exception:
                pass
        results, xdp = torchpath.host_finalize_wire(res16, kind)
        stats_delta = stats_from_results(results, pkt_len)
        if apply_stats:
            self._stats.add(stats_delta)
        return ClassifyOutput(results=results, xdp=xdp, stats_delta=stats_delta)

    def _note_payload_resident(self, payload, pay_hit: np.ndarray, pay_rw: np.ndarray) -> None:
        """Count one resident admission's payload outcome (tpu.py
        _note_payload_resident); with tracking on, the full bitmap comes
        from one classic K11 launch over the same column."""
        pt, pay_np, plen_np = payload
        bitmap = pt.match(pay_np, plen_np) if pt.tracking else None
        pt.note(bitmap, pay_hit, pay_rw, pay_np=pay_np, plen_np=plen_np)

    def _launch_resident(self, plan, apply_stats: bool) -> PendingClassify:
        """The resident plan's second half: one read back when the batch
        materializes."""
        return PendingClassify(lambda: self._resident_output(
            resident_fused_host(plan["fused"]), plan["n"], plan["epoch"], plan["kind"],
            plan["pkt_len"], apply_stats, plan.get("mlscore", False), plan.get("payload")))

    def prepare_packed_super(self, wire_stack: np.ndarray, v4_only: bool,
                             tcp_flags_stack: Optional[np.ndarray] = None,
                             payload_stack: Optional[np.ndarray] = None,
                             payload_len_stack: Optional[np.ndarray] = None):
        """Dispatch ``k`` stacked admissions of one shape, (k, b, 4 | 7),
        as one superbatch (tpu.py prepare_packed_super): the flow columns
        and the device epoch carry from step to step on the card, and the
        (k, L) outputs come back in one read.  ``tcp_flags_stack`` is (k, b)
        or None, ``payload_stack`` (k, b, L) and ``payload_len_stack``
        (k, b) the payload columns or None.  Returns None when the resident
        path cannot serve (no pool, another shape, wide ruleIds: a counted
        fallback).  Empty admissions (b = 0) take the stateless plan each,
        as in prepare_packed."""
        if (self._resident is None or self._flow is None or wire_stack.ndim != 3
                or wire_stack.shape[2] not in (4, 7)):
            return None
        if wire_stack.shape[1] == 0:
            return {"rows": [self.prepare_packed(w, v4_only) for w in wire_stack]}
        tier, pool = self._flow, self._resident
        gens_snap = tier.resident_gens_snapshot()
        ctx = pool.context(self)
        if ctx is None:
            pool.note("fallbacks")
            return None
        k, n, w = wire_stack.shape
        pay = self._payload_stage(payload_stack, payload_len_stack)
        fused, epoch = pool.dispatch(tier, ctx, self._resident_levels(ctx, v4_only, None),
                                     wire_stack, tcp_flags_stack, gens_snap, k=k,
                                     telemetry=self._telemetry, mlscore=self._mlscore,
                                     payload=pay)
        pool.note("dispatches")
        pool.note("superbatch_dispatches")
        pool.note("superbatch_admissions", k)
        self._note_wire(f"wire{w}", k * n, wire_stack.nbytes)
        if pay is not None:
            self._note_wire("payload", k * n, pay[1].nbytes + pay[2].nbytes)
        return {"resident_super": True, "fused": fused, "k": k, "n": n, "epoch0": epoch - k,
                "mlscore": self._mlscore is not None, "payload": pay,
                "kinds": (wire_stack[:, :, 0] & 3).astype(np.int32),
                "pkt_lens": [self._wire4_pkt_len(wire_stack[j]) for j in range(k)]}

    def classify_prepared_super(self, plan, apply_stats: bool = True):
        """A superbatch plan's second half: one PendingClassify per
        admission, in dispatch order; reading them out of order is safe,
        the model replays in epoch order."""
        if "rows" in plan:
            return [self.classify_prepared(p, apply_stats) for p in plan["rows"]]

        def row(j: int) -> PendingClassify:
            pay = plan.get("payload")
            if pay is not None:
                pay = (pay[0], pay[1][j], pay[2][j])
            return PendingClassify(lambda: self._resident_output(
                resident_fused_host((plan["fused"], j)), plan["n"], plan["epoch0"] + 1 + j,
                plan["kinds"][j], plan["pkt_lens"][j], apply_stats, plan.get("mlscore", False),
                pay))

        return [row(j) for j in range(plan["k"])]

    def _launch_flow(self, plan, apply_stats: bool) -> PendingClassify:
        """Complete a flow plan when the batch materializes (tpu.py
        _launch_flow): the misses go through the stateless ``_plan`` and
        ``_launch`` on the snapshotted tables (_flow_materialize)."""

        def classify_misses(miss_wire, _tenant):
            kind = (miss_wire[:, 0] & 3).astype(np.int32)
            return self._launch(self._plan(plan["active"], miss_wire, kind, plan["n_levels"]),
                                apply_stats=False).result()

        steps = []
        if self._mlscore is not None and "ml_wire" in plan:
            steps.append(lambda res16: self._mlscore.update(
                plan["ml_wire"], res16.astype(np.uint32), tflags_np=plan["ml_flags"])[0])
        if self._payload is not None and "pay_np" in plan:
            steps.append(lambda res16: self._payload_policy(
                plan["pay_wire"], res16, plan["pay_np"], plan["plen_np"]))
        score = None
        if steps:
            def score(res16):  # the score, then the payload match
                for step in steps:
                    res16 = np.asarray(step(res16), np.uint16)
                return res16

        def materialize() -> ClassifyOutput:
            out = _flow_materialize(self._flow, plan["fused"], plan["ctx"], plan["wire_np"],
                                    plan["kind"], plan["tcp_flags"], classify_misses,
                                    score=score)
            if apply_stats:
                self._stats.add(out.stats_delta)
            return out

        return PendingClassify(materialize)

    def _put(self, a: np.ndarray) -> torch.Tensor:
        a = np.ascontiguousarray(a)
        if a.dtype != np.uint8:
            a = a.view(np.int32)
        return torch.from_numpy(a).to(self._device)

    def _plan(self, active: _Active, wire_np: np.ndarray, kind: np.ndarray, n_levels):
        """Format choice and the host-to-device copy (tpu.py _plan_wire): a
        non-empty 4-word chunk on the trie or ctrie path ships the delta
        stream (codec "delta", or "auto" when its bucket-padded bytes beat
        8 per packet), else wire8; everything else the narrow wire when it
        qualifies, else the full one."""
        n = wire_np.shape[0]
        plan = {"active": active, "kind": kind, "n": n, "n_levels": n_levels}
        if active.path in ("trie", "ctrie") and wire_np.shape[1] == 4 and n:
            codec = self._wire_codec
            if codec in ("auto", "delta"):
                enc = encode_delta_wire(wire_np, max_bytes_per_pkt=8.0 if codec == "auto" else None)
                if enc is not None:
                    # what crosses the link: the bucket-padded payload, the
                    # 256-slot dictionary and the ifmap
                    shipped = wire_decode.payload_bucket(len(enc.payload)) + 256 * 4 + enc.ifmap.nbytes
                    if codec == "delta" or shipped < 8 * n:
                        plan.update(
                            fmt="delta", enc=enc, pkt_len=self._wire4_pkt_len(wire_np),
                            payload=self._put(wire_decode.pad_payload(enc.payload)),
                            dictv=self._put(wire_decode.pad_dict(enc.dict_vals)),
                            ifmap=self._put(enc.ifmap),
                        )
                        self._note_wire("delta", n, shipped)
                        return plan
            w8 = wire8(wire_np)
            if w8 is not None:
                wire8_np, ifmap = w8
                plan.update(fmt="wire8", pkt_len=self._wire4_pkt_len(wire_np),
                            wire=self._put(wire8_np), ifmap=self._put(ifmap))
                self._note_wire("wire8", n, wire8_np.nbytes + ifmap.nbytes)
                return plan
        if wire_np.shape[1] in (4, 7):
            narrow = narrow_wire(wire_np)
            if narrow is not None:
                wire_np = narrow
        plan.update(fmt="wire", wire=self._put(wire_np))
        self._note_wire(f"wire{wire_np.shape[1]}", n, wire_np.nbytes)
        return plan

    def _launch(self, plan, apply_stats: bool) -> PendingClassify:
        if plan["fmt"] != "wire":
            return self._launch_res16(plan, apply_stats)
        active, wire, n = plan["active"], plan["wire"], plan["n"]
        if active.ov is not None:
            fused = overlay_mod.classify_overlay_wire_fused(active.dev, active.ov, wire,
                                                        plan["n_levels"])
        elif active.path == "dense":
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

    def _launch_res16(self, plan, apply_stats: bool) -> PendingClassify:
        """The wire8 and delta launches (tpu.py _launch_wire8,
        _launch_delta): one read back of the packed res16 results; the
        statistics come from the verdicts and the pkt_len column that never
        crossed the link.  A delta chunk is classified in sorted order and
        its results are put back in chunk order here."""
        active, n, kind = plan["active"], plan["n"], plan["kind"]
        if plan["fmt"] == "wire8":
            if active.ov is not None:
                fused = overlay_mod.classify_overlay_wire8(active.dev, active.ov, plan["wire"],
                                                       plan["ifmap"])
            else:
                entry = (cwalk.classify_ctrie_wire8 if active.path == "ctrie"
                         else walk.classify_wire8)
                fused = entry(active.dev, plan["wire"], plan["ifmap"])
            perm = None
        else:
            enc = plan["enc"]
            args = (plan["payload"], plan["dictv"], plan["ifmap"])
            kw = {"n": n, "dict_mode": enc.dict_mode, "fixed_w": enc.fixed_w}
            if active.ov is not None:
                fused = overlay_mod.classify_overlay_delta(active.dev, active.ov, *args, **kw)
            else:
                entry = (wire_decode.classify_delta_ctrie if active.path == "ctrie"
                         else wire_decode.classify_delta)
                fused = entry(active.dev, *args, **kw)
            perm = enc.perm

        def materialize() -> ClassifyOutput:
            res16 = torchpath.unpack_res16_host(fused.cpu().numpy(), n)
            if perm is not None:
                unsorted = np.empty(n, np.uint16)
                unsorted[perm] = res16
                res16 = unsorted
            results, xdp = torchpath.host_finalize_wire(res16, kind)
            stats_delta = stats_from_results(results, plan["pkt_len"])
            if apply_stats:
                self._stats.add(stats_delta)
            return ClassifyOutput(results=results, xdp=xdp, stats_delta=stats_delta)

        return PendingClassify(materialize)

    def _note_wire(self, fmt: str, n: int, nbytes: int) -> None:
        with self._lock:
            c = self._wire_counts.setdefault(fmt, [0, 0])
            c[0] += n
            c[1] += nbytes

    def wire_stats(self):
        """{format: (packets, host-to-device bytes)} since construction:
        "delta", "wire8", or "wire<width>" for the narrow (3, 6) and full
        (4, 7) wires."""
        with self._lock:
            return {k: tuple(v) for k, v in self._wire_counts.items()}

    @staticmethod
    def _wire4_pkt_len(wire4_np: np.ndarray) -> np.ndarray:
        """pkt_len from the 4-word wire (w1 >> 16 plus the w0 >> 27 high
        bits); it stays on the host for the wire8 and delta formats."""
        return (((wire4_np[:, 1] >> 16) & 0xFFFF) | ((wire4_np[:, 0] >> 27) << 16)).astype(np.int64)

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
            self._ov_cache = None
            self._closed = True


class TorchArenaClassifier:
    """Multi-tenant paged-arena classifier: many tenant rulesets resident
    in ONE device pool, batches of mixed-tenant traffic steered per packet
    by the device tenant -> page table, tenant activation and hot-swap as a
    page-table flip.  The counterpart of the JAX package's ArenaClassifier.
    A ctrie-family pool is served by kernel K3b (kernels/arena_walk.py), a
    dense-family pool by kernel K6 (kernels/arena_dense.py).

    Serves the packed-wire contract with a tenant column:
    ``classify_async_packed_tenant(wire_np, tenant_np)`` ships the narrow
    wire (packets.narrow_wire) when it qualifies, else the wire as given,
    plus the (B,) int32 tenant column; tenant ids outside [0,
    max_tenants) (of any integer width: they are mapped to -1 before the
    int32 cast, where the JAX package wraps them), absent and destroyed
    tenants classify to UNDEF and are counted nowhere.  One read back per
    batch: without an overlay tenant, one memset and one launch of the
    family's fused entry; with one, the longest-prefix combine of the main
    pool and the overlay side-pool (arena_dense.classify_arena_overlay_
    wire: K3b's or K6's two-column entry, K6's over the side-pool).

    On a ctrie pool a structural install runs stage -> activate (the slab
    write of a new page is issued before the flip that makes it
    reachable), with the allocator's in-place path as the fallback when no
    page is free, as the JAX classifier serving its fused walk does; a
    rules-only edit (a hint whose trie levels are untouched) of a tenant
    with a page, and every install on a dense pool, go to the allocator's
    ``load_tenant`` ("patch", "cow", "share", "rewrite", "assign").  A
    classify is enqueued under the allocators' locks, so it runs wholly
    before or after any slab write, patch or flip.

    ``overlay_spec`` (dense-family, else ValueError) adds the per-tenant
    overlay side-pool (``load_tenant_overlay``), which the tenant registry
    fills with the structurally new keys of a tenant on a shared page.

    ``flow_table`` (else INFW_FLOW_TABLE) adds the flow tier with one flow
    slab per arena page, steered by the tenant's page (tpu.py
    _classify_flow_tenant): a 4- or 7-word batch is probed first (K7), the
    misses fall through to the stateless dispatch above and are inserted
    (K8).  Every lifecycle change of a tenant re-steers its flow slab and
    bumps its generation; ``compact`` re-steers every tenant and bumps all.
    Tenant ids outside [0, max_tenants) become -1 before the int32 cast
    here too, so they are never eligible for the flow table.

    Not in this slice (NotImplementedError): invariant checks (item 17) and
    spliced geometries (arena.SPLICE_ITEM)."""

    def __init__(self, spec: "arena_mod.ArenaSpec", device=None, overlay_spec=None,
                 flow_table=None, check_invariants: Optional[bool] = None,
                 flow_track_model: bool = False) -> None:
        if check_invariants:
            raise NotImplementedError(f"arena invariant checks are {INVARIANTS_ITEM}")
        self._alloc = arena_mod.ArenaAllocator(spec, device)
        self._device = self._alloc.device
        if overlay_spec is not None and overlay_spec.family != "dense":
            raise ValueError("the overlay side-pool must be dense-family")
        self._ov_alloc = (arena_mod.ArenaAllocator(overlay_spec, self._device)
                          if overlay_spec is not None else None)
        self._lock = threading.Lock()
        self._stats = StatsAccumulator()
        self._wire_counts = {}
        # per-tenant verdict accounting {tid: [packets, allow, deny]}
        self._tenant_counts = {}
        self._closed = False
        self._flow = None
        cfg = _flow_config(flow_table, pages=spec.pages, max_tenants=spec.max_tenants)
        if cfg is not None:
            self._flow = flow_mod.FlowTier(cfg, device=self._device,
                                           track_model=flow_track_model)

    # -- tenant lifecycle ----------------------------------------------------

    @property
    def allocator(self) -> "arena_mod.ArenaAllocator":
        return self._alloc

    @property
    def overlay_allocator(self) -> "Optional[arena_mod.ArenaAllocator]":
        return self._ov_alloc

    @property
    def spec(self) -> "arena_mod.ArenaSpec":
        return self._alloc.spec

    @property
    def device(self) -> torch.device:
        return self._device

    def load_tenant(self, tenant: int, tables: CompiledTables, hint=None) -> str:
        """Install or replace one tenant's table and return the path taken.
        A dense pool, or a rules-only ``hint`` for a tenant with a page:
        the allocator's own install.  Otherwise stage, then activate
        ("assign" or "rewrite"); with no free page to stage into, the
        allocator's own install."""
        if self._closed:
            raise RuntimeError("classifier is closed")
        had_page = self._alloc.page_of(tenant) is not None
        if self._alloc.family == "dense" or (had_page and hint_trie_unchanged(hint)):
            path = self._alloc.load_tenant(tenant, tables, hint=hint)
        else:
            try:
                page = self._alloc.stage(tables)
            except arena_mod.ArenaCapacityError:
                path = self._alloc.load_tenant(tenant, tables, hint=hint)
            else:
                self._alloc.activate(tenant, page, tables)
                path = "rewrite" if had_page else "assign"
        self._flow_note(tenant)
        return path

    def load_tenant_overlay(self, tenant: int, overlay: Optional[CompiledTables]) -> None:
        """Install or clear one tenant's dense overlay side-slab (None or an
        empty table destroys it)."""
        if self._ov_alloc is None:
            raise RuntimeError("arena built without an overlay side-pool")
        if overlay is None or overlay.num_entries == 0:
            if self._ov_alloc.page_of(tenant) is not None:
                self._ov_alloc.destroy_tenant(tenant)
        else:
            self._ov_alloc.load_tenant(tenant, overlay)
        # an overlay change alters the tenant's verdicts as any edit does
        # (the JAX package bumps nothing here; ROADMAP.md section 3)
        if self._flow is not None:
            self._flow.bump_generation(tenant)

    def stage_tenant(self, tables: CompiledTables) -> int:
        return self._alloc.stage(tables)

    def activate_tenant(self, tenant: int, page: int,
                        tables: Optional[CompiledTables] = None) -> None:
        self._alloc.activate(tenant, page, tables)
        self._flow_note(tenant)

    def swap_tenant(self, tenant: int, tables: CompiledTables) -> None:
        self._alloc.swap_tenant(tenant, tables)
        self._flow_note(tenant)

    def destroy_tenant(self, tenant: int) -> None:
        self._alloc.destroy_tenant(tenant)
        if self._ov_alloc is not None and self._ov_alloc.page_of(tenant) is not None:
            self._ov_alloc.destroy_tenant(tenant)
        self._flow_note(tenant)

    def compact(self) -> int:
        moved = self._alloc.compact()
        if moved and self._flow is not None:
            # moved slabs re-steer every tenant's flow slab; the pool-wide
            # bump is the conservative invalidation
            for t in self._alloc.tenants():
                self._flow.set_page(t, self._alloc.page_of(t))
            self._flow.bump_all_generations()
        return moved

    def dedup_sweep(self, limit: Optional[int] = None) -> dict:
        rep = self._alloc.dedup_sweep(limit)
        for t in rep["moved"]:
            self._flow_note(t)
        return rep

    def _flow_note(self, tenant: int) -> None:
        """After a lifecycle change: re-steer the tenant's flow slab to its
        (possibly new) page and invalidate its cached verdicts."""
        if self._flow is None:
            return
        page = self._alloc.page_of(tenant)
        self._flow.set_page(tenant, -1 if page is None else page)
        self._flow.bump_generation(tenant)

    @property
    def flow(self) -> "Optional[flow_mod.FlowTier]":
        return self._flow

    def flow_counters(self) -> dict:
        return {} if self._flow is None else self._flow.counter_values()

    def flow_age_tick(self, horizon=None) -> int:
        return 0 if self._flow is None else self._flow.age(horizon)

    def tenant_ids(self):
        return self._alloc.tenants()

    # -- classify ------------------------------------------------------------

    def _tenant32(self, tenant_np) -> np.ndarray:
        """Tenant ids outside [0, max_tenants) become -1 before the int32
        cast, so they classify to UNDEF and are never eligible for the flow
        table (an id such as 2^32 + 1 must not wrap onto tenant 1)."""
        t64 = np.asarray(tenant_np, np.int64)
        t32 = np.where((t64 >= 0) & (t64 < self._alloc.spec.max_tenants), t64, -1)
        return t32.astype(np.int32)

    def classify_async_packed_tenant(self, wire_np: np.ndarray, tenant_np: np.ndarray,
                                     apply_stats: bool = True,
                                     tcp_flags: Optional[np.ndarray] = None) -> PendingClassify:
        """The mixed-tenant packed-wire dispatch: one batch, each packet
        steered to its tenant's slab in-kernel.  With a flow tier a 4- or
        7-word batch goes through it (``tcp_flags`` (B,) feeds its TCP
        model), otherwise straight to the stateless dispatch."""
        if self._flow is not None and wire_np.shape[1] in (4, 7):
            return self._classify_flow_tenant(wire_np, tenant_np, apply_stats, tcp_flags)
        return self._classify_stateless_tenant(wire_np, tenant_np, apply_stats)

    def _classify_flow_tenant(self, wire_np, tenant_np, apply_stats, tcp_flags):
        """tpu.py _classify_flow_tenant: probe, then at materialize the
        compacted misses through the stateless dispatch (tenant -1 on the
        padding rows), the merge, and the insert (_flow_materialize)."""
        if self._closed:
            raise RuntimeError("classifier is closed")
        kind = (wire_np[:, 0] & 3).astype(np.int32)
        t32 = self._tenant32(tenant_np)
        fused, ctx = self._flow.probe(wire_np, tenant_np=t32, tflags_np=tcp_flags)

        def classify_misses(miss_wire, miss_tenant):
            return self._classify_stateless_tenant(miss_wire, miss_tenant, apply_stats=False,
                                                   note_tenants=False).result()

        def materialize() -> ClassifyOutput:
            out = _flow_materialize(self._flow, fused, ctx, wire_np, kind, tcp_flags,
                                    classify_misses, tenant=t32)
            if apply_stats:
                self._stats.add(out.stats_delta)
            self._note_tenants(tenant_np, out.results)
            return out

        return PendingClassify(materialize)

    def _classify_stateless_tenant(self, wire_np: np.ndarray, tenant_np: np.ndarray,
                                   apply_stats: bool = True,
                                   note_tenants: bool = True) -> PendingClassify:
        """The stateless mixed-tenant dispatch (tpu.py
        _classify_stateless_tenant; also the flow tier's miss path): the
        host-to-device copy of the wire and of the tenant column, the
        device pass (the family's fused entry, or the overlay combine while
        the side-pool holds a tenant), and a handle whose .result() reads
        back once."""
        if self._closed:
            raise RuntimeError("classifier is closed")
        n = wire_np.shape[0]
        kind = (wire_np[:, 0] & 3).astype(np.int32)
        if wire_np.shape[1] in (4, 7):
            narrow = narrow_wire(wire_np)
            if narrow is not None:
                wire_np = narrow
        wire = torch.from_numpy(np.ascontiguousarray(wire_np).view(np.int32)).to(self._device)
        # _note_tenants counts ids outside [0, max_tenants) nowhere
        tenant = torch.from_numpy(self._tenant32(tenant_np)).to(self._device)
        self._note_wire(f"wire{wire_np.shape[1]}", n, wire_np.nbytes)
        spec = self._alloc.spec
        d_max = spec.d_max if spec.family == "ctrie" else 0
        ov = self._ov_alloc
        with self._alloc.lock, (ov.lock if ov is not None else contextlib.nullcontext()):
            if ov is not None and ov.tenants():
                fused = arena_dense.classify_arena_overlay_wire(
                    self._alloc.arena, ov.arena, wire, tenant, pages=spec.pages,
                    ov_pages=ov.spec.pages, d_max=d_max)
            elif spec.family == "dense":
                fused = arena_dense.classify_arena_dense_wire_fused(
                    self._alloc.arena, wire, tenant, pages=spec.pages)
            else:
                fused = arena_walk.classify_arena_wire_fused(
                    self._alloc.arena, wire, tenant, pages=spec.pages, d_max=d_max)

        def materialize() -> ClassifyOutput:
            res16, stats = torchpath.split_wire_outputs(fused.cpu().numpy(), n)
            stats_delta = torchpath.merge_stats_host(stats)
            if apply_stats:
                self._stats.add(stats_delta)
            results, xdp = torchpath.host_finalize_wire(res16, kind)
            if note_tenants:
                self._note_tenants(tenant_np, results)
            return ClassifyOutput(results=results, xdp=xdp, stats_delta=stats_delta)

        return PendingClassify(materialize)

    def classify_tenants(self, batch: PacketBatch, tenant_np: np.ndarray,
                         apply_stats: bool = True) -> ClassifyOutput:
        """Batch-object convenience over the packed-tenant dispatch."""
        return self.classify_async_packed_tenant(
            batch.pack_wire(), tenant_np, apply_stats=apply_stats
        ).result()

    def _note_wire(self, fmt: str, n: int, nbytes: int) -> None:
        with self._lock:
            c = self._wire_counts.setdefault(fmt, [0, 0])
            c[0] += n
            c[1] += nbytes

    def wire_stats(self):
        """{format: (packets, host-to-device wire bytes)} since
        construction."""
        with self._lock:
            return {k: tuple(v) for k, v in self._wire_counts.items()}

    def _note_tenants(self, tenant_np, results) -> None:
        """Per-tenant packets/allow/deny accounting, three bincounts over
        the batch."""
        t = np.asarray(tenant_np, np.int64)
        ok = (t >= 0) & (t < self._alloc.spec.max_tenants)
        t = t[ok]
        if len(t) == 0:
            return
        act = (np.asarray(results)[ok]) & 0xFF
        n = int(t.max()) + 1
        pkts = np.bincount(t, minlength=n)
        allow = np.bincount(t[act == ALLOW], minlength=n)
        deny = np.bincount(t[act == DENY], minlength=n)
        with self._lock:
            for tid in np.nonzero(pkts)[0]:
                c = self._tenant_counts.setdefault(int(tid), [0, 0, 0])
                c[0] += int(pkts[tid])
                c[1] += int(allow[tid])
                c[2] += int(deny[tid])

    def tenant_counters(self) -> dict:
        """The allocator's tenant_* counters plus per-tenant packet and
        verdict totals."""
        out = dict(self._alloc.counter_values())
        if self._ov_alloc is not None:
            for k, v in self._ov_alloc.counter_values().items():
                out[f"{k}_overlay"] = v
        with self._lock:
            for tid, (pk, al, dn) in sorted(self._tenant_counts.items()):
                out[f"tenant_{tid}_packets_total"] = pk
                out[f"tenant_{tid}_allow_total"] = al
                out[f"tenant_{tid}_deny_total"] = dn
        return out

    # -- accessors / lifecycle ----------------------------------------------

    @property
    def stats(self) -> StatsAccumulator:
        return self._stats

    def close(self) -> None:
        self._closed = True
