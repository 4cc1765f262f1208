"""Batched multi-edit patch transactions (the JAX package's ``infw.txn``).

N queued single-key edits of the running dataplane land as ONE folded
transaction per device generation:

- **net-effect folding** (:func:`fold_ops`): later ops on the same
  masked LPM identity supersede earlier ones; an add of a NEW identity
  followed by its delete annihilates to nothing; delete-then-readd of a
  live identity folds to an in-place rules upsert (content-identical to
  the sequential application).  The fold output is one (upserts,
  deletes, new-keys) triple the incremental compiler absorbs in a single
  ``IncrementalTables.apply``.
- **bounded-staleness batching** (:class:`TxnBatcher`): edits
  accumulate while classify batches are in flight and flush when (a)
  the oldest queued edit exceeds the staleness deadline
  (``--patch-staleness-us`` / ``INFW_PATCH_STALENESS_US``) or (b) the
  batch-size threshold trips.
- **one device generation per flush** (:class:`TxnApplier` /
  ``DataplaneSyncer.apply_edit_transaction``): the folded transaction
  routes exactly like the syncer's per-sync diff (overlay side table for
  structurally new CIDR adds, the merged dirty-row hint for the device
  patch, a columnar rebuild when the trie must renumber) and lands as
  ONE ``TorchClassifier.load_tables`` call: on the trie and ctrie paths
  each changed array becomes a device clone that takes the staged rows
  with ``index_copy_`` (``kernels.walk.staged_rows``), and the old
  generation serves until the swap.
- **observability** (:class:`TxnStats` + ``obs.events.PatchTxnRecord``):
  ops folded, dirty rows, flush reason, escalations and a per-op
  staleness histogram, on the daemon's /metrics registry and its event
  ring.

The fold, the routing, the counters and the edit-file codec are the JAX
package's, so both daemons consume the same edit files and report the
same counters.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import ChainMap
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .compiler import CompileError, IncrementalTables, LpmKey, compile_tables_from_content

#: single-key edit kinds a transaction folds
TXN_EDIT_KINDS = (
    "key_add", "cidr_add", "key_delete", "rules_edit", "order_change",
)

#: bounded-staleness defaults (daemon knobs override)
DEFAULT_STALENESS_US = 2000.0
DEFAULT_MAX_OPS = 1024


@dataclass
class EditOp:
    """One declarative single-key edit of the running dataplane (any
    object with ``kind``/``key``/``rules`` attributes folds)."""

    kind: str
    key: LpmKey
    rules: Optional[np.ndarray] = None

    def __post_init__(self) -> None:
        if self.kind not in TXN_EDIT_KINDS:
            raise ValueError(
                f"unknown edit kind {self.kind!r} "
                f"(expected one of {TXN_EDIT_KINDS})"
            )
        if self.kind != "key_delete" and self.rules is None:
            raise ValueError(f"{self.kind} requires a rules matrix")


@dataclass
class FoldedTxn:
    """Net effect of one op sequence: what actually ships.

    ``upserts`` hit identities already live in the main table or the
    overlay (routing decides which); ``new_keys`` are identities the
    dataplane has never seen, each carrying the kind of its FINAL add op
    (``cidr_add`` keys are overlay-eligible); ``deletes`` remove live
    identities.  ``n_ops`` - (ops that survived) = ops folded away."""

    upserts: Dict[LpmKey, np.ndarray] = field(default_factory=dict)
    new_keys: Dict[LpmKey, Tuple[np.ndarray, str]] = field(
        default_factory=dict
    )
    deletes: List[LpmKey] = field(default_factory=list)
    n_ops: int = 0

    @property
    def n_effects(self) -> int:
        return len(self.upserts) + len(self.new_keys) + len(self.deletes)

    @property
    def n_folded(self) -> int:
        return self.n_ops - self.n_effects


def live_idents(main_idents, overlay) -> ChainMap:
    """The masked identities live before a transaction, for fold_ops:
    the main table's (``IncrementalTables._ident_to_t``, read in place,
    not copied: a copy costs O(table) per flush) and the overlay's keys'."""
    return ChainMap(main_idents, dict.fromkeys(k.masked_identity() for k in overlay))


def fold_ops(ops: Sequence, existing_idents) -> FoldedTxn:
    """Host-side net-effect fold: one pass over ``ops`` keeping only the
    LAST effect per masked LPM identity (``existing_idents`` answers
    ``in``: a set, or ``live_idents``).

    Semantics (per identity, in op order — exactly what applying the ops
    one generation at a time would leave behind):

    - a later add/edit supersedes any earlier add/edit or delete
      (delete-then-readd folds to an upsert of the re-add's rules);
    - a delete supersedes earlier adds/edits; if the identity was NOT
      live before the transaction (``existing_idents``), the add+delete
      pair annihilates to nothing;
    - identities live before the transaction whose final effect is an
      add/edit land in ``upserts``; never-seen identities land in
      ``new_keys`` with their final add kind (``cidr_add`` = overlay
      eligible).
    """
    # per-ident running state: ("set", key, rules, kind) | ("del", key)
    state: Dict[tuple, tuple] = {}
    n = 0
    for op in ops:
        kind = op.kind
        if kind not in TXN_EDIT_KINDS:
            raise ValueError(f"cannot fold op kind {kind!r}")
        n += 1
        ident = op.key.masked_identity()
        if kind == "key_delete":
            state[ident] = ("del", op.key)
            continue
        state[ident] = ("set", op.key, np.asarray(op.rules), kind)
    out = FoldedTxn(n_ops=n)
    for ident, st in state.items():
        if st[0] == "del":
            if ident in existing_idents:
                out.deletes.append(st[1])
            # else: identity born and killed inside the transaction —
            # annihilated, nothing ships
            continue
        _tag, key, rules, kind = st
        if ident in existing_idents:
            out.upserts[key] = rules
        else:
            out.new_keys[key] = (rules, kind)
    return out


def route_folded(folded: FoldedTxn, overlay: Dict[LpmKey, np.ndarray],
                 overlay_ok: bool, overlay_cap: int):
    """Route a folded transaction against the live overlay dict (which
    is MUTATED in place), the routing shared by the syncer and the
    TxnApplier:

    - overlay-resident identities edit/delete inside the overlay;
    - main-table upserts/deletes pass through;
    - structurally-new ``cidr_add`` keys go to the overlay while
      ``overlay_ok`` holds and it has room; a capacity overflow
      mid-transaction spills the WHOLE overlay into the returned
      upserts (one structural merge) and stops overlay routing for the
      rest of the transaction.

    Returns ``(upserts, deletes, overlay_dirty)`` — deletes/upserts for
    the main table, and whether the overlay changed (caller invalidates
    its compiled-overlay memo)."""
    ov_by_ident = {k.masked_identity(): k for k in overlay}
    ups: Dict[LpmKey, np.ndarray] = {}
    dels: List[LpmKey] = []
    ov_dirty = False
    for key in folded.deletes:
        ov_key = ov_by_ident.get(key.masked_identity())
        if ov_key is not None:
            overlay.pop(ov_key, None)
            ov_dirty = True
        else:
            dels.append(key)
    for key, rules in folded.upserts.items():
        ov_key = ov_by_ident.get(key.masked_identity())
        if ov_key is not None:
            overlay.pop(ov_key, None)
            overlay[key] = rules
            ov_dirty = True
        else:
            ups[key] = rules
    for key, (rules, kind) in folded.new_keys.items():
        if kind == "cidr_add" and overlay_ok:
            if len(overlay) < overlay_cap:
                overlay[key] = rules
                ov_dirty = True
                continue
            ups.update(overlay)
            overlay.clear()
            ov_dirty = True
            overlay_ok = False
        ups[key] = rules
    return ups, dels, ov_dirty


def merge_rebuild_content(content, ups, dels, extra=None):
    """The columnar-rebuild escalation's content merge: live content
    minus the deleted masked identities, plus the upserts (plus an
    optional absorbed side dict, the overlay).  One recipe for the
    syncer's flush and the TxnApplier, so their escalations agree."""
    del_idents = {k.masked_identity() for k in dels}
    out = {
        k: v for k, v in dict(content).items()
        if k.masked_identity() not in del_idents
    }
    out.update(ups)
    if extra:
        out.update(extra)
    return out


# --- bounded-staleness batching ---------------------------------------------


class TxnBatcher:
    """Thread-safe edit queue with the flush policy: edits accumulate
    while classify batches are in flight; :meth:`should_flush` trips on
    (a) the oldest edit's age exceeding the staleness deadline or (b)
    the batch-size threshold.  ``drain()`` hands back (op, enqueue_ts)
    pairs so the flusher can account per-op staleness."""

    def __init__(self, staleness_s: float = DEFAULT_STALENESS_US * 1e-6,
                 max_ops: int = DEFAULT_MAX_OPS,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if staleness_s <= 0:
            raise ValueError(f"staleness must be positive, got {staleness_s}")
        if max_ops < 1:
            raise ValueError(f"max_ops must be >= 1, got {max_ops}")
        self.staleness_s = float(staleness_s)
        self.max_ops = int(max_ops)
        self._clock = clock
        self._lock = threading.Lock()
        self._q: List[Tuple[object, float]] = []

    def queue(self, op, now: Optional[float] = None) -> None:
        ts = self._clock() if now is None else float(now)
        with self._lock:
            self._q.append((op, ts))

    def queue_many(self, ops: Sequence, now: Optional[float] = None) -> None:
        ts = self._clock() if now is None else float(now)
        with self._lock:
            self._q.extend((op, ts) for op in ops)

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)

    def oldest_age(self, now: Optional[float] = None) -> float:
        now = self._clock() if now is None else float(now)
        with self._lock:
            return now - self._q[0][1] if self._q else 0.0

    def should_flush(self, now: Optional[float] = None) -> Optional[str]:
        """Flush reason ("batch" | "deadline") or None (keep coalescing).
        The batch threshold is checked first: an overfull queue should
        ship regardless of age."""
        now = self._clock() if now is None else float(now)
        with self._lock:
            if not self._q:
                return None
            if len(self._q) >= self.max_ops:
                return "batch"
            if now - self._q[0][1] >= self.staleness_s:
                return "deadline"
            return None

    def drain(self) -> List[Tuple[object, float]]:
        with self._lock:
            q, self._q = self._q, []
            return q


# --- observability -----------------------------------------------------------

#: per-op staleness histogram bucket bounds, microseconds (<= bound)
STALENESS_BUCKETS_US = (100, 1_000, 10_000, 100_000, 1_000_000)


class TxnStats:
    """Thread-safe transaction counters for the /metrics registry
    (counter-provider protocol): transactions, ops in/folded, device
    dirty rows, escalations, per-reason flush counts, and the per-op
    staleness histogram (enqueue -> flush-start age)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.txns_total = 0
        self.ops_total = 0
        self.folded_total = 0
        self.dirty_rows_total = 0
        self.escalations_total = 0
        self.reasons: Dict[str, int] = {}
        self.staleness_hist = [0] * (len(STALENESS_BUCKETS_US) + 1)

    def note_flush(self, n_ops: int, n_folded: int, dirty_rows: int,
                   reason: str, escalated: bool,
                   staleness_s: Sequence[float] = ()) -> None:
        with self._lock:
            self.txns_total += 1
            self.ops_total += int(n_ops)
            self.folded_total += int(n_folded)
            self.dirty_rows_total += int(dirty_rows)
            if escalated:
                self.escalations_total += 1
            self.reasons[reason] = self.reasons.get(reason, 0) + 1
            for s in staleness_s:
                us = s * 1e6
                for i, bound in enumerate(STALENESS_BUCKETS_US):
                    if us <= bound:
                        self.staleness_hist[i] += 1
                        break
                else:
                    self.staleness_hist[-1] += 1

    def counter_values(self) -> Dict[str, int]:
        """Prometheus counter sources, rendered by the metrics registry
        as ingressnodefirewall_node_patch_txn_*."""
        with self._lock:
            out = {
                "patch_txn_total": self.txns_total,
                "patch_txn_ops_total": self.ops_total,
                "patch_txn_ops_folded_total": self.folded_total,
                "patch_txn_dirty_rows_total": self.dirty_rows_total,
                "patch_txn_escalations_total": self.escalations_total,
            }
            for reason, c in sorted(self.reasons.items()):
                out[f"patch_txn_flush_{reason}_total"] = c
            for i, bound in enumerate(STALENESS_BUCKETS_US):
                out[f"patch_txn_staleness_us_bucket_le_{bound}"] = (
                    self.staleness_hist[i]
                )
            out["patch_txn_staleness_us_bucket_inf"] = self.staleness_hist[-1]
            return out

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {
                "txns": self.txns_total, "ops": self.ops_total,
                "folded": self.folded_total,
                "dirty_rows": self.dirty_rows_total,
                "escalations": self.escalations_total,
                "reasons": dict(self.reasons),
                "staleness_hist": list(self.staleness_hist),
            }


@dataclass
class TxnReport:
    """What one flushed transaction did (also the PatchTxnRecord
    payload)."""

    n_ops: int
    n_folded: int
    dirty_rows: int
    mode: str          # "patch" | "full"
    reason: str
    escalated: bool
    apply_s: float = 0.0
    worst_staleness_s: float = 0.0


def report_flush(report: TxnReport, t0: float, enqueue_ts, stats, ring) -> None:
    """Fill the report's worst staleness (each op's age at ``t0``, the
    flush start) and hand the flush to the counters and the event ring,
    when given."""
    staleness: List[float] = []
    if enqueue_ts:
        staleness = [max(0.0, t0 - ts) for ts in enqueue_ts]
        report.worst_staleness_s = max(staleness, default=0.0)
    if stats is not None:
        stats.note_flush(
            report.n_ops, report.n_folded, report.dirty_rows,
            report.reason, report.escalated, staleness_s=staleness,
        )
    if ring is not None:
        from .obs.events import PatchTxnRecord

        ring.push(PatchTxnRecord(
            ops=report.n_ops, folded=report.n_folded,
            dirty_rows=report.dirty_rows, reason=report.reason,
            escalated=report.escalated,
            staleness_us=report.worst_staleness_s * 1e6,
        ))


# --- the apply half ----------------------------------------------------------


class TxnApplier:
    """Owns the incremental compile state + a classifier and applies
    folded edit transactions as ONE device patch generation (the daemon's
    checkpointed path is ``DataplaneSyncer.apply_edit_transaction``, same
    fold + routing).

    Routing per flush, mirroring the syncer's per-sync diff:

    - overlay-resident identities edit/delete inside the overlay dict
      (the small side table re-uploads, the main tables stay);
    - main-table upserts/deletes ship as ONE ``IncrementalTables.apply``
      and ONE ``load_tables`` with the merged dirty-row hint;
    - structurally-new ``cidr_add`` keys route to the overlay while it
      has room (capacity overflow mid-transaction spills the WHOLE
      overlay into the main table — one structural merge);
    - a transaction the updater cannot absorb (trie depth exceeded)
      escalates to the columnar rebuild, the old generation serving
      until the swap.
    """

    def __init__(self, clf, updater: IncrementalTables,
                 overlay_cap: int = 1024, overlay_min_main: int = 4096,
                 stats: Optional[TxnStats] = None, ring=None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.clf = clf
        self.updater = updater
        self.overlay: Dict[LpmKey, np.ndarray] = {}
        self.overlay_cap = int(overlay_cap)
        self.overlay_min_main = int(overlay_min_main)
        self.stats = stats
        self.ring = ring
        self._clock = clock
        self._ov_memo = None
        self._lock = threading.Lock()

    def _compiled_overlay(self):
        if not self.overlay:
            self._ov_memo = None
            return None
        if self._ov_memo is None:
            self._ov_memo = compile_tables_from_content(
                dict(self.overlay), rule_width=self.updater.rule_width
            )
        return self._ov_memo

    def apply(self, ops: Sequence, reason: str = "manual",
              enqueue_ts: Optional[Sequence[float]] = None) -> TxnReport:
        """Fold + route + apply one transaction; returns the report
        (emitted to the stats sink / event ring when configured)."""
        with self._lock:
            t0 = self._clock()
            folded = fold_ops(ops, live_idents(self.updater._ident_to_t, self.overlay))
            # the syncer's post-delete size gate: a shrunken main table
            # may land on the dense path, which cannot honor an overlay
            # (folded.deletes over-counts by the overlay's own deletes —
            # conservative toward merging, never wrong)
            overlay_ok = (
                getattr(self.clf, "supports_overlay", False)
                and len(self.updater._ident_to_t) - len(folded.deletes)
                > self.overlay_min_main
            )
            ups, dels, ov_dirty = route_folded(
                folded, self.overlay, overlay_ok, self.overlay_cap
            )
            if ov_dirty:
                self._ov_memo = None
            escalated = self._apply_main(ups, dels)
            mode, dirty_rows = getattr(self.clf, "_last_load", ("full", 0))
            report = TxnReport(
                n_ops=folded.n_ops, n_folded=folded.n_folded,
                dirty_rows=int(dirty_rows), mode=mode, reason=reason,
                escalated=escalated, apply_s=self._clock() - t0,
            )
            report_flush(report, t0, enqueue_ts, self.stats, self.ring)
            return report

    def _apply_main(self, ups, dels) -> bool:
        """One batched updater apply + one device load; returns True
        when the transaction escalated to the columnar rebuild path
        (the old generation keeps serving until load_tables swaps)."""
        escalated = False
        try:
            if ups and not self.updater.fits(ups):
                raise CompileError("trie depth exceeded; rebuild")
            self.updater.apply(ups, dels)
            if self.updater.maybe_compact():
                escalated = True
        except CompileError:
            content = merge_rebuild_content(
                self.updater.content, ups, dels, extra=self.overlay
            )
            self.overlay = {}
            self._ov_memo = None
            self.updater = IncrementalTables.from_content(
                content, rule_width=self.updater.rule_width
            )
            escalated = True
        snap = self.updater.snapshot()
        hint = self.updater.peek_dirty()
        if getattr(self.clf, "supports_overlay", False):
            self.clf.load_tables(
                snap, dirty_hint=hint, overlay=self._compiled_overlay()
            )
        else:
            if self.overlay:
                raise RuntimeError("overlay routed to a non-overlay backend")
            self.clf.load_tables(snap, dirty_hint=hint)
        self.updater.clear_dirty()
        return escalated


# --- edit-file protocol ------------------------------------------------------
#
# One JSON document per file: {"ops": [{"kind", "prefix_len", "ifindex",
# "ip" (32 hex chars), "rules" ((R, 7) int rows, absent for deletes)}]}.
# tmp + rename discipline like every other file in the state-dir
# protocol; the daemon consumes files in sorted order.


def op_to_json(op) -> dict:
    doc = {
        "kind": op.kind,
        "prefix_len": int(op.key.prefix_len),
        "ifindex": int(op.key.ingress_ifindex),
        "ip": op.key.ip_data.hex(),
    }
    if op.rules is not None:
        doc["rules"] = np.asarray(op.rules, np.int32).tolist()
    return doc


def op_from_json(doc: dict) -> EditOp:
    key = LpmKey(
        int(doc["prefix_len"]), int(doc["ifindex"]),
        bytes.fromhex(doc["ip"]),
    )
    rules = doc.get("rules")
    return EditOp(
        kind=str(doc["kind"]), key=key,
        rules=None if rules is None else np.asarray(rules, np.int32),
    )


def write_edit_file(path: str, ops: Sequence) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"ops": [op_to_json(op) for op in ops]}, f)
    os.replace(tmp, path)


def read_edit_file(path: str) -> List[EditOp]:
    with open(path) as f:
        doc = json.load(f)
    return [op_from_json(d) for d in doc["ops"]]
