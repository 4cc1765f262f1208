"""The dataplane sync boundary.

The counterpart of the reference's ebpfsyncer (pkg/ebpfsyncer/ebpfsyncer.go):
the single point of contact between declarative desired state and the
running classifier.  One method, ``sync_interface_ingress_rules(rules,
is_delete)`` (ebpfsyncer.go:32-34), hides the backend (``TorchClassifier`` on
the card, or on the CPU when asked).

Lifecycle semantics kept from the reference:

- **mutex-serialized** (:72-73): concurrent syncs serialize.
- **lazy manager creation + restart re-adoption** (:100-104 ->
  loader.go:381-407): the classifier is created on first sync; if a
  checkpoint (compiled tables + attach manifest + journal + overlay
  sidecar) exists it is re-adopted, so a restart resumes enforcing without
  recompiling.  The checkpoint is the JAX package's format, file for file.
- **stats poller paused around sync** (:81-88) so metrics never read a
  table mid-rewrite.
- **is_delete => resetAll** (:90-97, :160-181): detach everything, close
  the classifier, remove the checkpoint.
- **detach-unmanaged -> attach-new -> load rules** order (:106-125).
- **idempotent, incremental rule load**: desired vs current key diff
  (loader.go:177-194,551-631); unchanged content causes no device reload,
  and a changed one patches the IncrementalTables per key.  Structurally
  new keys on a trie-scale table go to a small overlay when the classifier
  ``supports_overlay``.

- **batched edit transactions** (``apply_edit_transaction``, the
  infw_torch.txn fold): N queued single-key edits land as one folded
  ``IncrementalTables.apply`` and one ``load_tables``, with the sync
  path's overlay, journal and checkpoint discipline.

- **the multi-tenant control plane** (``TenantRegistry``, at the end of
  this module): named tenants over ``TorchArenaClassifier``, each with its
  own ``IncrementalTables``; create, incremental edits through the same
  fold (rules-only edits land as per-slab patches or copy-on-write
  clones), hot-swap by stage + flip, destroy, and the shared-page delta
  routed to the overlay side-pool.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Protocol, Set, Tuple

import numpy as np

from . import interfaces as interfaces_mod
from . import txn as txn_mod
from .compiler import (
    CompiledTables,
    CompileError,
    IncrementalTables,
    LpmKey,
    build_table_content,
    compile_tables_from_content,
    min_rule_width,
)
from .constants import MAX_RULES_PER_TARGET
from .interfaces import InterfaceRegistry
from .obs.events import TenantSwapRecord
from .spec import IngressNodeFirewallRules
from .txn import merge_rebuild_content

log = logging.getLogger("infw_torch.syncer")

#: where the parts of the reference syncer that the port leaves out are queued
ANALYSIS_ITEM = "ROADMAP.md item 17 (verifiers for the port)"


class SyncError(RuntimeError):
    pass


def _rules_equal(a: Optional[np.ndarray], b: Optional[np.ndarray]) -> bool:
    """Width-insensitive rule-matrix equality: the reference compares
    fixed-width (100) packed structs (loader.go:580 DeepEqual); our compiled
    widths shrink to the ruleset, so matrices are equal when they agree on
    the common prefix and are zero beyond it."""
    if a is None or b is None:
        return False
    if a.shape[0] < b.shape[0]:
        a, b = b, a
    w = b.shape[0]
    return np.array_equal(a[:w], b) and not a[w:].any()


class StatsPoller(Protocol):
    """The pause/resume surface of the metrics poller
    (pkg/metrics/statistics.go:88-110)."""

    def start_poll(self, classifier) -> None: ...
    def stop_poll(self) -> None: ...


class Syncer(Protocol):
    """EbpfSyncer interface (ebpfsyncer.go:32-34) — the mock boundary used
    by the node-state controller tests."""

    def sync_interface_ingress_rules(
        self,
        iface_ingress_rules: Dict[str, List[IngressNodeFirewallRules]],
        is_delete: bool,
    ) -> None: ...


class DataplaneSyncer:
    """Production syncer driving a classifier backend.

    ``classifier_factory`` plays the role of ``createNewManager``
    (ebpfsyncer.go:100 → NewIngNodeFwController).
    """

    def __init__(
        self,
        classifier_factory: Callable[[], object],
        registry: Optional[InterfaceRegistry] = None,
        stats_poller: Optional[StatsPoller] = None,
        checkpoint_dir: Optional[str] = None,
    ) -> None:
        self._factory = classifier_factory
        self._registry = registry if registry is not None else interfaces_mod.default_registry
        self._stats_poller = stats_poller
        self._checkpoint_dir = checkpoint_dir
        # the reference's opt-in pre-sync rule analysis is not in the port:
        # refuse it rather than serve without it
        if (os.environ.get("INFW_SYNC_ANALYSIS") or "off") != "off":
            raise NotImplementedError(f"pre-sync rule analysis is {ANALYSIS_ITEM}")

        self._lock = threading.Lock()
        self._classifier = None
        self._attached: Set[str] = set()
        self._content: Dict[LpmKey, np.ndarray] = {}
        # Incremental compile state: kept across syncs so a small rule edit
        # patches per-key (addOrUpdateRules/purgeKeys granularity,
        # loader.go:200-218,633) instead of recompiling the whole table.
        self._updater: Optional[IncrementalTables] = None
        # Incremental deltas applied to the updater but not yet persisted
        # to any checkpoint (journal or base); survives failed loads.
        self._pending_deltas: List[Tuple[Dict[LpmKey, np.ndarray], List[LpmKey]]] = []
        # Structural-add overlay (the CIDR-add Map.Update analogue,
        # loader.go:200-218): NEW keys route into this small side dict —
        # classified as a side table combined by longest prefix
        # (kernels/overlay.py) — so a 1-key CIDR add never
        # pays the main trie's poptrie re-transform.  Merged into the
        # main table when it outgrows OVERLAY_CAP.  Deletes of MAIN keys
        # remain structural (node repush + re-transform).
        self._overlay: Dict[LpmKey, np.ndarray] = {}
        self._overlay_compiled = None  # (rule_width, CompiledTables) memo

    #: overlay size bound, the JAX package's: it bounds the side table's
    #: memory; overflow merges into the main trie (paying one
    #: re-transform)
    OVERLAY_CAP = 1024
    #: only route to the overlay when the main table is trie-path scale
    #: (a dense-path main table rebuilds in milliseconds anyway)
    OVERLAY_MIN_MAIN = 4096

    # -- public surface ------------------------------------------------------

    def sync_interface_ingress_rules(
        self,
        iface_ingress_rules: Dict[str, List[IngressNodeFirewallRules]],
        is_delete: bool,
    ) -> None:
        """SyncInterfaceIngressRules (ebpfsyncer.go:70-126)."""
        with self._lock:
            log.info("syncing ingress firewall rules for %d interfaces (delete=%s)",
                     len(iface_ingress_rules), is_delete)
            if self._stats_poller is not None:
                self._stats_poller.stop_poll()
            try:
                self._create_manager_if_not_exists()
                if is_delete:
                    self._reset_all()
                    return
                # Build the desired table content BEFORE touching the attach
                # set: compilation is pure, so a CompileError (bad port
                # string, out-of-range order...) leaves the dataplane exactly
                # as it was — no interfaces detached, last-good rules intact.
                desired, width = self._build_desired_content(iface_ingress_rules)
                self._detach_unmanaged_interfaces(iface_ingress_rules)
                self._attach_new_interfaces(iface_ingress_rules)
                self._load_ingress_node_firewall_rules(desired, width)
                # The attach/detach set may change even when rule content
                # does not; the manifest must always reflect it or a restart
                # re-adopts stale attachments.
                self._save_manifest()
            finally:
                if self._stats_poller is not None and self._classifier is not None:
                    self._stats_poller.start_poll(self._classifier)

    def apply_edit_transaction(self, ops, reason: str = "manual",
                               enqueue_ts=None, stats=None, ring=None):
        """Apply one batched edit transaction (infw_torch.txn fold
        semantics) as ONE device generation, the update-storm counterpart
        of ``sync_interface_ingress_rules``: where a sync reconciles a full
        desired state, this folds N queued single-key edits
        (``txn.EditOp``) into their net effect and lands them with one
        ``IncrementalTables.apply`` and one ``load_tables`` (on the trie
        and ctrie paths the hinted patch: each changed array a device
        clone taking the staged rows), with the same overlay / journal /
        checkpoint discipline as the sync path.  The old generation
        serves until the swap; a transaction the updater cannot absorb
        escalates to the columnar rebuild.

        Requires a live dataplane (a prior sync created the classifier).
        A re-adopted checkpoint whose content the first sync found
        unchanged serves without incremental state; the first edit builds
        it from the tables in service (the JAX package's syncer refuses
        that edit instead, ROADMAP.md section 3).  ``enqueue_ts``/
        ``stats``/``ring`` feed the per-op staleness histogram, the
        TxnStats counters and the PatchTxnRecord event."""
        with self._lock:
            if self._classifier is None or self._classifier.tables is None:
                raise SyncError(
                    "no dataplane to edit (sync rules before queuing edits)"
                )
            t0 = time.monotonic()
            if self._updater is None:
                tables = self._classifier.tables
                self._updater = IncrementalTables.from_content(
                    tables.content, rule_width=tables.rule_width
                )
            if self._stats_poller is not None:
                self._stats_poller.stop_poll()
            try:
                report = self._apply_edit_txn_locked(ops, reason)
            finally:
                if self._stats_poller is not None and self._classifier is not None:
                    self._stats_poller.start_poll(self._classifier)
            report.apply_s = time.monotonic() - t0
            txn_mod.report_flush(report, t0, enqueue_ts, stats, ring)
            return report

    def _apply_edit_txn_locked(self, ops, reason):
        """The routing half, under the lock: fold, route (overlay vs
        main vs escalation, mirroring _load_ingress_node_firewall_rules),
        one updater apply, one device load, journal + checkpoint."""
        ov_idents_before = {k.masked_identity() for k in self._overlay}
        folded = txn_mod.fold_ops(
            ops, txn_mod.live_idents(self._updater._ident_to_t, self._overlay))
        # same post-delete size gate as the sync path: a shrunken main
        # table may land on the dense path, which cannot honor overlays
        # (folded.deletes over-counts by the overlay's own deletes —
        # conservative toward merging, never wrong)
        overlay_ok = (
            getattr(self._classifier, "supports_overlay", False)
            and len(self._updater._ident_to_t) - len(folded.deletes)
            > self.OVERLAY_MIN_MAIN
        )
        ups, deletes, ov_dirty = txn_mod.route_folded(
            folded, self._overlay, overlay_ok, self.OVERLAY_CAP
        )
        if ov_dirty:
            self._overlay_compiled = None
        escalated = False
        try:
            if ups and not self._updater.fits(ups):
                raise CompileError("trie depth exceeded; rebuild")
            self._updater.apply(ups, deletes)
            if self._updater.maybe_compact():
                log.info("txn flush: compacted table, tombstones reclaimed")
                escalated = True
        except CompileError:
            # columnar-rebuild escalation: a fresh updater absorbs the
            # overlay too; the OLD generation keeps serving until the
            # load below swaps
            content = merge_rebuild_content(
                self._updater.content, ups, deletes, extra=self._overlay
            )
            self._overlay = {}
            self._overlay_compiled = None
            self._updater = IncrementalTables.from_content(
                content, rule_width=self._updater.rule_width
            )
            escalated = True
        # journal records reflect the folded net effect regardless of
        # routing, so restart replay reconstructs everything (same
        # discipline as the sync path's desired diff)
        journal_ups = dict(ups)
        journal_ups.update(
            {k: r for k, (r, _kind) in folded.new_keys.items()}
        )
        journal_ups.update(
            {k: r for k, r in folded.upserts.items()
             if k.masked_identity() in ov_idents_before}
        )
        journal_dels = list(folded.deletes)
        if journal_ups or journal_dels:
            self._pending_deltas.append((journal_ups, journal_dels))
        tables = self._updater.snapshot()
        if os.environ.get("INFW_CHECK_INVARIANTS", "") not in (
            "", "0", "false", "no"
        ):
            self._check_overlay_contract()
        width = self._updater.rule_width
        if getattr(self._classifier, "supports_overlay", False):
            self._classifier.load_tables(
                tables, dirty_hint=self._updater.peek_dirty(),
                overlay=self._compile_overlay(width),
            )
        else:
            if self._overlay:
                raise SyncError("overlay routed to a non-overlay backend")
            self._classifier.load_tables(
                tables, dirty_hint=self._updater.peek_dirty()
            )
        self._updater.clear_dirty()
        self._save_overlay()
        self._content = dict(self._updater.content)
        self._content.update(self._overlay)
        if escalated or not self._journal_pending():
            self._save_checkpoint(tables)
        mode, dirty_rows = getattr(
            self._classifier, "_last_load", ("full", 0)
        )
        log.info(
            "edit txn (%s): %d op(s), %d folded, mode=%s, %d dirty "
            "row(s)%s", reason, folded.n_ops, folded.n_folded, mode,
            dirty_rows, ", escalated" if escalated else "",
        )
        return txn_mod.TxnReport(
            n_ops=folded.n_ops, n_folded=folded.n_folded,
            dirty_rows=int(dirty_rows), mode=mode, reason=reason,
            escalated=escalated,
        )

    @property
    def classifier(self):
        return self._classifier

    def attached_interfaces(self) -> Set[str]:
        with self._lock:
            return set(self._attached)

    def shutdown(self) -> None:
        """SIGTERM handler path (ebpfsyncer.go:90-97): full reset, keeping
        the checkpoint so a restart re-adopts (the kernel analogue: pinned
        links keep enforcing after daemon death)."""
        with self._lock:
            if self._classifier is None:
                return
            if self._stats_poller is not None:
                self._stats_poller.stop_poll()
            for name in list(self._attached):
                self._detach(name)
            self._classifier.close()
            self._classifier = None
            self._attached.clear()
            self._content = {}
            self._updater = None
            self._overlay = {}  # restored from the sidecar on restart
            self._overlay_compiled = None

    # -- lifecycle internals -------------------------------------------------

    def _create_manager_if_not_exists(self) -> None:
        """createNewManagerIfNotExists (ebpfsyncer.go:100-104 → loader
        NewIngNodeFwController), incl. pinned-state re-adoption
        (loader.go:99-104,381-407)."""
        if self._classifier is not None:
            return
        self._classifier = self._factory()
        ck = self._load_checkpoint()
        if ck is not None:
            tables, attached = ck
            self._load_overlay({k.masked_identity() for k in tables.content})
            self._overlay_compiled = None
            if self._overlay and getattr(
                self._classifier, "supports_overlay", False
            ) and tables.num_entries > self.OVERLAY_MIN_MAIN:
                self._classifier.load_tables(
                    tables,
                    overlay=self._compile_overlay(tables.rule_width),
                )
            else:
                # overlay unsupported by this backend: fold it into the
                # restored content through one compile
                if self._overlay:
                    merged = dict(tables.content)
                    merged.update(self._overlay)
                    self._overlay = {}
                    tables = compile_tables_from_content(
                        merged, rule_width=tables.rule_width
                    )
                self._classifier.load_tables(tables)
            self._content = dict(tables.content)
            self._content.update(self._overlay)
            for name in attached:
                if not self._registry.is_valid_interface_name_and_state(name):
                    log.warning("re-adopt: interface %s no longer valid", name)
                    continue
                try:
                    self._attach(name)
                except (SyncError, interfaces_mod.InterfaceError):
                    log.warning("re-adopt: interface %s no longer attachable", name)
            log.info("re-adopted checkpoint: %d entries, %d interfaces",
                     tables.num_entries, len(self._attached))

    def _reset_all(self) -> None:
        """resetAll (ebpfsyncer.go:160-181): detach + close + unpin."""
        for name in list(self._attached):
            self._detach(name)
        self._attached.clear()
        if self._classifier is not None:
            self._classifier.close()
        self._classifier = None
        self._content = {}
        self._updater = None
        self._overlay = {}
        self._overlay_compiled = None
        self._remove_checkpoint()
        p = self._overlay_path()
        if p is not None:
            try:
                os.remove(p)
            except FileNotFoundError:
                pass

    def _detach_unmanaged_interfaces(
        self, iface_ingress_rules: Dict[str, List[IngressNodeFirewallRules]]
    ) -> None:
        """detachUnmanagedInterfaces (ebpfsyncer.go:218-232): anything
        currently attached but absent from the desired set is detached."""
        for name in list(self._attached):
            if name not in iface_ingress_rules:
                log.info("detaching unmanaged interface %s", name)
                self._detach(name)

    def _attach_new_interfaces(
        self, iface_ingress_rules: Dict[str, List[IngressNodeFirewallRules]]
    ) -> None:
        """attachNewInterfaces (ebpfsyncer.go:183-215): invalid interfaces
        are skipped without error."""
        for name in iface_ingress_rules:
            if name in self._attached:
                continue
            if not self._registry.is_valid_interface_name_and_state(name):
                log.error("fail to attach ingress firewall prog to interface %s: invalid state", name)
                continue
            self._attach(name)

    def _build_desired_content(
        self, iface_ingress_rules: Dict[str, List[IngressNodeFirewallRules]]
    ) -> Tuple[Dict[LpmKey, np.ndarray], int]:
        """Pure compile step: CRD rules → packed map content.  Raises
        CompileError/InterfaceError without mutating any syncer state."""
        width = min(min_rule_width(iface_ingress_rules), MAX_RULES_PER_TARGET)
        raw = build_table_content(iface_ingress_rules, self._registry, width)
        # Collapse keys that alias after masking (last writer wins), exactly
        # like successive Map.Update calls on the kernel LPM trie — the diff
        # below and the test-content API must see what the device enforces.
        dedup = {}
        for k, v in raw.items():
            dedup[k.masked_identity()] = (k, v)
        return {k: v for k, v in dedup.values()}, width

    def _load_ingress_node_firewall_rules(
        self, desired: Dict[LpmKey, np.ndarray], width: int
    ) -> None:
        """loadIngressNodeFirewallRules → IngressNodeFwRulesLoader
        (loader.go:130-194): diff desired against current, reload the
        device tables only when the content changed, then pin."""
        stale = self._get_stale_keys(desired)
        current = {k.masked_identity(): v for k, v in self._content.items()}
        changed = bool(stale) or any(
            not _rules_equal(current.get(k.masked_identity()), v)
            for k, v in desired.items()
        )
        if not changed and self._classifier.tables is not None:
            log.info("rules unchanged; skipping device reload")
            return
        if (
            self._updater is not None
            and self._updater.rule_width == width
            and self._updater.fits(desired)
        ):
            # Per-key patch: purge stale identities, upsert changed/new
            # ones (addOrUpdateRules/purgeKeys granularity) — a one-CIDR
            # edit touches one dense row + one trie node.  Diff against the
            # UPDATER's content, not self._content: a failed load/checkpoint
            # leaves _content stale while the updater already mutated, and
            # the next sync must reconcile from what the updater holds.
            base = self._updater.content
            base_by_ident = {k.masked_identity(): v for k, v in base.items()}
            ov_by_ident = {k.masked_identity(): k for k in self._overlay}
            desired_idents = {k.masked_identity() for k in desired}
            deletes = [
                k for k in base
                if k.masked_identity() not in desired_idents
            ]
            ov_deletes = [
                k for k in self._overlay
                if k.masked_identity() not in desired_idents
            ]
            upserts = {}
            ov_upserts = {}
            new_keys = {}
            for k, v in desired.items():
                ident = k.masked_identity()
                if ident in base_by_ident:
                    if not _rules_equal(base_by_ident[ident], v):
                        upserts[k] = v
                elif ident in ov_by_ident:
                    if not _rules_equal(
                        self._overlay.get(ov_by_ident[ident]), v
                    ):
                        ov_upserts[k] = v
                else:
                    new_keys[k] = v
            # journal records reflect the DESIRED diff regardless of how
            # it was routed, so restart replay reconstructs everything
            journal_upserts = {**upserts, **ov_upserts, **new_keys}
            journal_deletes = deletes + ov_deletes
            if ov_deletes or ov_upserts:
                self._overlay_compiled = None
            for k in ov_deletes:
                self._overlay.pop(k, None)
            for k, v in ov_upserts.items():
                self._overlay.pop(ov_by_ident[k.masked_identity()], None)
                self._overlay[k] = v
            # gate on the POST-delete size: a delete-heavy sync can
            # shrink the main table onto the dense path, where the
            # classifier cannot honor an overlay (it raises rather than
            # silently dropping rules) — merge instead
            overlay_ok = (
                getattr(self._classifier, "supports_overlay", False)
                and len(base) - len(deletes) > self.OVERLAY_MIN_MAIN
            )
            if overlay_ok and (
                len(self._overlay) + len(new_keys) <= self.OVERLAY_CAP
            ):
                # structural ADD fast path: new keys go to the dense
                # side-table; the main trie's device form is untouched
                if new_keys:
                    self._overlay_compiled = None
                self._overlay.update(new_keys)
            else:
                # overflow (or no overlay support): merge everything into
                # the main table — the amortized structural slow path
                if self._overlay or new_keys:
                    upserts = {**upserts, **self._overlay, **new_keys}
                    self._overlay = {}
                    self._overlay_compiled = None
            self._updater.apply(upserts, deletes)
            log.info(
                "incremental table update: %d main upserts, %d main "
                "deletes, %d overlay adds/updates (%d overlay total)",
                len(upserts), len(deletes),
                len(ov_upserts) + len(new_keys), len(self._overlay),
            )
            # Deltas accumulate until a checkpoint (journal or base)
            # actually persists them: a failed device load leaves the
            # delta pending, so the NEXT successful sync still journals
            # it instead of silently dropping it from the checkpoint.
            if journal_upserts or journal_deletes:
                self._pending_deltas.append((journal_upserts, journal_deletes))
            incremental = True
            if self._updater.maybe_compact():
                log.info("compacted table: tombstones reclaimed")
                incremental = False  # checkpoint needs the full state
        else:
            self._updater = IncrementalTables.from_content(
                desired, rule_width=width
            )
            self._overlay = {}  # full rebuild absorbs everything
            self._overlay_compiled = None
            incremental = False
        tables = self._updater.snapshot()
        if os.environ.get("INFW_CHECK_INVARIANTS", "") not in (
            "", "0", "false", "no"
        ):
            self._check_overlay_contract()
        # Dirty rows accumulated since the last SUCCESSFUL load: the
        # device backend patches exactly those rows instead of diffing or
        # re-uploading the table.  Cleared only after load_tables returns
        # (a failed load keeps accumulating, so the next attempt's hint
        # still covers this generation's changes).
        if getattr(self._classifier, "supports_overlay", False):
            self._classifier.load_tables(
                tables, dirty_hint=self._updater.peek_dirty(),
                overlay=self._compile_overlay(width),
            )
        else:
            self._classifier.load_tables(
                tables, dirty_hint=self._updater.peek_dirty()
            )
        self._updater.clear_dirty()
        self._save_overlay()
        self._content = dict(desired)
        # Checkpointing follows the same O(delta) discipline as the device
        # path: an incremental sync appends small journal records (one per
        # pending delta); the full (compression-bound) base rewrite only
        # happens on rebuilds or when the journal grows past its cap.
        if incremental and self._journal_pending():
            return
        self._save_checkpoint(tables)

    def _check_overlay_contract(self) -> None:
        """Opt-in (INFW_CHECK_INVARIANTS=1) overlay accounting contract,
        checked at the sync boundary BEFORE the device load: the overlay
        must respect its capacity bound and stay identity-disjoint from
        the main table — the classify combine resolves ties by strict
        mask-len score, which is only collision-free while no LPM
        identity lives in both tables.  A violation here is a routing bug
        in _load_ingress_node_firewall_rules, surfaced at the mutation
        site instead of as a wrong-verdict mystery."""
        if len(self._overlay) > self.OVERLAY_CAP:
            raise SyncError(
                f"overlay holds {len(self._overlay)} keys — exceeds "
                f"OVERLAY_CAP={self.OVERLAY_CAP} (spill-to-merge routing "
                "failed)"
            )
        if self._updater is None or not self._overlay:
            return
        main = {k.masked_identity() for k in self._updater.content}
        dup = [
            k for k in self._overlay if k.masked_identity() in main
        ]
        if dup:
            raise SyncError(
                f"{len(dup)} overlay key(s) alias main-table identities "
                f"(first: {dup[0]}); the longest-prefix combine requires "
                "disjoint identities"
            )

    def _compile_overlay(self, width: int) -> Optional[CompiledTables]:
        """Small dense CompiledTables from the overlay dict, or None when
        empty.  Memoized until the overlay mutates — a rules-only edit to
        the MAIN table must not pay an overlay recompile + re-upload (the
        classifier also reuses its device copy for the same instance)."""
        if not self._overlay:
            self._overlay_compiled = None
            return None
        cached = getattr(self, "_overlay_compiled", None)
        if cached is not None and cached[0] == width:
            return cached[1]
        ct = compile_tables_from_content(
            dict(self._overlay), rule_width=width
        )
        self._overlay_compiled = (width, ct)
        return ct

    def _overlay_path(self) -> Optional[str]:
        if not self._checkpoint_dir:
            return None
        return os.path.join(self._checkpoint_dir, "overlay.json")

    def _save_overlay(self) -> None:
        """Sidecar checkpoint for the overlay: the journal carries its
        deltas too, but a journal-overflow base rewrite saves only the
        main updater's snapshot — this tiny file keeps overlay keys
        restorable across that."""
        path = self._overlay_path()
        if path is None:
            return
        if not self._overlay:
            try:
                os.remove(path)
            except FileNotFoundError:
                pass
            return
        os.makedirs(self._checkpoint_dir, exist_ok=True)
        rec = [
            [k.prefix_len, k.ingress_ifindex, k.ip_data.hex(),
             np.asarray(v, np.int32).tolist()]
            for k, v in self._overlay.items()
        ]
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, path)

    def _load_overlay(self, content_idents) -> None:
        """Restore the overlay sidecar, dropping entries the restored
        main content already covers (journal replay may have landed them
        in the main table)."""
        path = self._overlay_path()
        if path is None or not os.path.exists(path):
            return
        try:
            with open(path) as f:
                rec = json.load(f)
            self._overlay = {
                key: np.asarray(rows, np.int32)
                for p, i, h, rows in rec
                if (key := LpmKey(p, i, bytes.fromhex(h))).masked_identity()
                not in content_idents
            }
        except (ValueError, KeyError, TypeError) as e:
            log.warning("overlay sidecar unreadable (%s); dropping", e)
            self._overlay = {}

    def _get_stale_keys(self, desired: Dict[LpmKey, np.ndarray]) -> List[LpmKey]:
        """getStaleKeys (loader.go:551-631): current keys that are absent
        from — or whose rules differ from — the desired content."""
        want = {k.masked_identity(): v for k, v in desired.items()}
        return [
            k
            for k, v in self._content.items()
            if not _rules_equal(want.get(k.masked_identity()), v)
        ]

    # -- attach/detach ---------------------------------------------------------

    def _attach(self, name: str) -> None:
        self._registry.set_xdp(name, True)
        self._attached.add(name)

    def _detach(self, name: str) -> None:
        try:
            self._registry.set_xdp(name, False)
        except interfaces_mod.InterfaceError:
            pass  # interface vanished; treat as detached (loader.go:268-283)
        self._attached.discard(name)

    # -- checkpoint ("pinning") ---------------------------------------------

    def _ck_paths(self) -> Optional[Tuple[str, str]]:
        if not self._checkpoint_dir:
            return None
        return (
            os.path.join(self._checkpoint_dir, "tables.npz"),
            os.path.join(self._checkpoint_dir, "manifest.json"),
        )

    def _save_checkpoint(self, tables: CompiledTables) -> None:
        paths = self._ck_paths()
        if paths is None:
            return
        tables_path, _ = paths
        os.makedirs(self._checkpoint_dir, exist_ok=True)
        # Clear the journal BEFORE swapping the base: a crash in between
        # leaves old-base + empty-journal (consistent, merely stale —
        # the controller's next sync converges it), never new-base +
        # stale-journal, whose replay would resurrect deleted rules.
        self._clear_journal()
        # Atomic swap: never leave a torn checkpoint (the bpffs pin is
        # similarly all-or-nothing).
        tmp = tables_path + ".tmp.npz"
        tables.save(tmp)
        os.replace(tmp, tables_path)
        self._pending_deltas = []
        # manifest is written by the sync-level _save_manifest() call

    # -- delta-journal checkpointing ----------------------------------------
    #
    # A 1-key sync must not pay a full-table compression pass: the delta
    # is appended as journal/<seq>.json next to the base npz, and restart
    # replays base.content + journal (same last-writer-wins masked-identity
    # semantics as successive Map.Update calls) through one compile.  The
    # journal is capped (JOURNAL_MAX records) — overflow rewrites the base.

    JOURNAL_MAX = 64

    def _journal_dir(self) -> Optional[str]:
        if not self._checkpoint_dir:
            return None
        return os.path.join(self._checkpoint_dir, "journal")

    def _journal_files(self) -> List[str]:
        d = self._journal_dir()
        if d is None or not os.path.isdir(d):
            return []
        # tmp files are '<seq>.json.tmp' — excluded by the suffix check
        return sorted(f for f in os.listdir(d) if f.endswith(".json"))

    def _journal_pending(self) -> bool:
        """Append every pending delta as a journal record; returns False
        when the caller must do a full base save instead (no checkpoint
        dir, no base yet, or the journal would exceed its cap)."""
        d = self._journal_dir()
        paths = self._ck_paths()
        if d is None or paths is None or not os.path.exists(paths[0]):
            return False
        if not self._pending_deltas:
            return True  # nothing new to persist; checkpoint already current
        existing = self._journal_files()
        if len(existing) + len(self._pending_deltas) > self.JOURNAL_MAX:
            log.info("checkpoint journal full (%d records); compacting to base",
                     len(existing))
            return False
        os.makedirs(d, exist_ok=True)
        seq = int(existing[-1].split(".")[0]) + 1 if existing else 0
        for upserts, deletes in self._pending_deltas:
            rec = {
                "upserts": [
                    [k.prefix_len, k.ingress_ifindex, k.ip_data.hex(),
                     np.asarray(v, np.int32).tolist()]
                    for k, v in upserts.items()
                ],
                "deletes": [
                    [k.prefix_len, k.ingress_ifindex, k.ip_data.hex()]
                    for k in deletes
                ],
            }
            path = os.path.join(d, f"{seq:08d}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(rec, f)
            os.replace(tmp, path)
            seq += 1
        self._pending_deltas = []
        return True

    def _clear_journal(self) -> None:
        d = self._journal_dir()
        if d is None or not os.path.isdir(d):
            return
        for f in os.listdir(d):  # records AND orphaned tmp files
            try:
                os.remove(os.path.join(d, f))
            except FileNotFoundError:
                pass

    def _replay_journal(self, tables: CompiledTables) -> CompiledTables:
        """Apply journal records to the base checkpoint's content and
        recompile once.  A corrupt record stops replay at that point
        (prefix semantics — everything before it is still applied)."""
        files = self._journal_files()
        if not files:
            return tables
        content = dict(tables.content)
        by_ident = {k.masked_identity(): k for k in content}
        d = self._journal_dir()
        applied = 0
        for fn in files:
            try:
                with open(os.path.join(d, fn)) as f:
                    rec = json.load(f)
                ups = [
                    (LpmKey(p, i, bytes.fromhex(h)), np.asarray(rows, np.int32))
                    for p, i, h, rows in rec["upserts"]
                ]
                dels = [LpmKey(p, i, bytes.fromhex(h))
                        for p, i, h in rec["deletes"]]
            except (OSError, ValueError, KeyError, TypeError) as e:
                log.warning("corrupt journal record %s: %s; replay stops here",
                            fn, e)
                break
            for k in dels:
                old = by_ident.pop(k.masked_identity(), None)
                if old is not None:
                    content.pop(old, None)
            for k, rows in ups:
                ident = k.masked_identity()
                old = by_ident.get(ident)
                if old is not None and old != k:
                    content.pop(old, None)
                by_ident[ident] = k
                content[k] = rows
            applied += 1
        if applied == 0:
            return tables  # nothing usable: skip the pointless recompile
        log.info("checkpoint journal: replayed %d/%d records", applied, len(files))
        return compile_tables_from_content(content, rule_width=tables.rule_width)

    def _save_manifest(self) -> None:
        paths = self._ck_paths()
        if paths is None:
            return
        _, manifest_path = paths
        os.makedirs(self._checkpoint_dir, exist_ok=True)
        tmp = manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"attached": sorted(self._attached)}, f)
        os.replace(tmp, manifest_path)

    def _load_checkpoint(self) -> Optional[Tuple[CompiledTables, List[str]]]:
        paths = self._ck_paths()
        if paths is None:
            return None
        tables_path, manifest_path = paths
        if not (os.path.exists(tables_path) and os.path.exists(manifest_path)):
            return None
        try:
            tables = CompiledTables.load(tables_path)
            tables = self._replay_journal(tables)
            with open(manifest_path) as f:
                manifest = json.load(f)
            return tables, list(manifest.get("attached", []))
        except Exception as e:  # torn/corrupt checkpoint: start fresh
            log.warning("failed to load checkpoint: %s", e)
            return None

    def _remove_checkpoint(self) -> None:
        paths = self._ck_paths()
        if paths is None:
            return
        self._clear_journal()
        for p in paths:
            try:
                os.remove(p)
            except FileNotFoundError:
                pass


class TenantError(SyncError):
    """Tenant registry misuse: unknown name, duplicate create, or a table
    the arena geometry cannot hold."""


class TenantRegistry:
    """Multi-tenant control plane over an arena classifier
    (backend.cuda.TorchArenaClassifier; the JAX package's
    infw.syncer.TenantRegistry): names tenants, owns one IncrementalTables
    per tenant, and drives the tenant lifecycle:

    - ``create_tenant``: compile, slab install, page-table flip;
    - ``update_tenant`` / ``apply_edit_transaction``: per-tenant
      incremental edits through the same fold and dirty hint as the
      single-tenant path (infw_torch.txn.fold_ops), landing as per-slab
      patches, copy-on-write clones or slab rewrites;
    - ``swap_tenant``: full ruleset replacement as stage (a slab bake into
      a free page) + activate (the page-table row flip);
    - ``destroy_tenant``: the row flipped to -1 and the page released.

    Every transition emits a TenantSwapRecord on the event ring (when
    given one); the tenant_* counters surface through ``counter_values``
    for /metrics.  Lifecycle operations serialize on one coarse lock (the
    per-tenant IncrementalTables is not thread-safe); classify never takes
    it.  Each create publishes its name only after its load succeeded (the
    reference orders ``load_tenant`` before the store into ``_names``)."""

    def __init__(self, classifier, rule_width: int, event_ring=None) -> None:
        self._clf = classifier
        self._rule_width = rule_width
        self._ring = event_ring
        self._lock = threading.Lock()
        self._op_lock = threading.RLock()
        self._names: Dict[str, int] = {}
        self._updaters: Dict[int, IncrementalTables] = {}
        #: per-tenant shared-delta overlay content: small deltas of a
        #: tenant on a SHARED page ride the dense overlay side-pool
        #: instead of forcing a copy-on-write clone.  Only brand-new
        #: prefixes (and edits or deletes of overlay-resident ones) are
        #: eligible: the combine is strictly longest-prefix, so an overlay
        #: entry with a main-slab entry's prefix would lose the tie.
        self._overlays: Dict[int, Dict[LpmKey, np.ndarray]] = {}
        #: creates in flight: name -> reserved id
        self._creating: Dict[str, int] = {}
        self._next_id = 0
        self._max = classifier.spec.max_tenants

    # -- introspection -------------------------------------------------------

    @property
    def classifier(self):
        return self._clf

    def tenant_id(self, name: str) -> int:
        with self._lock:
            if name not in self._names:
                raise TenantError(f"unknown tenant {name!r}")
            return self._names[name]

    def tenant_names(self):
        with self._lock:
            return sorted(self._names)

    def tenant_ids_by_name(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._names)

    def counter_values(self) -> Dict[str, int]:
        out = {"tenant_registered": len(self._names)}
        getter = getattr(self._clf, "tenant_counters", None)
        if getter is not None:
            out.update(getter())
        return out

    def _emit(self, record) -> None:
        if self._ring is not None:
            try:
                self._ring.push(record)
            except Exception:
                pass

    def _alloc_id(self) -> int:
        busy = set(self._updaters) | set(self._creating.values())
        for _ in range(self._max):
            tid = self._next_id % self._max
            self._next_id += 1
            if tid not in busy:
                return tid
        raise TenantError(f"tenant registry full ({self._max} ids)")

    # -- lifecycle -----------------------------------------------------------

    def create_tenant(self, name: str, content: Dict[LpmKey, np.ndarray]) -> int:
        with self._op_lock:
            with self._lock:
                if name in self._names or name in self._creating:
                    raise TenantError(f"tenant {name!r} already exists")
                tid = self._alloc_id()
                self._creating[name] = tid
            try:
                upd = IncrementalTables.from_content(dict(content), rule_width=self._rule_width)
                snap = upd.snapshot()
                t0 = time.perf_counter()
                self._clf.load_tenant(tid, snap)
                dt = (time.perf_counter() - t0) * 1e6
                upd.start_dirty_tracking()
            except Exception:
                with self._lock:
                    self._creating.pop(name, None)
                raise
            with self._lock:
                self._creating.pop(name, None)
                self._names[name] = tid
                self._updaters[tid] = upd
            self._emit(TenantSwapRecord(
                tenant=name, tenant_id=tid, page=self._clf.allocator.page_of(tid) or 0,
                entries=snap.num_entries, kind="create", stage_us=dt,
            ))
            return tid

    def update_tenant(self, name: str, ups: Dict[LpmKey, np.ndarray], dels) -> str:
        """Incremental per-tenant edit: one updater apply and one hinted
        slab load.  A tenant on a SHARED page whose delta is
        overlay-eligible (only brand-new prefixes added, or overlay-resident
        ones edited or deleted) gets it on the overlay side-pool and the
        shared slab stays untouched ("overlay").  Otherwise the edit lands
        in the main slab (the allocator patches a private page or clones a
        shared one), with any deferred overlay content folded back first.
        Escalates to a rebuild as the single-tenant syncer does
        (CompileError)."""
        with self._op_lock:
            tid = self.tenant_id(name)
            with self._lock:
                upd = self._updaters[tid]
            if self._try_overlay_delta(tid, upd, ups, dels):
                return "overlay"
            merge_ov = self._overlays.get(tid)
            if merge_ov:
                # the deferred delta folds back before the edit that forced
                # the clone; keys this edit deletes stay deleted (apply()
                # runs deletes before upserts)
                del_idents = {k.masked_identity() for k in dels}
                ups = {
                    **{k: v for k, v in merge_ov.items()
                       if k.masked_identity() not in del_idents},
                    **dict(ups),
                }
            try:
                if ups and not upd.fits(ups):
                    raise CompileError("trie depth exceeded; rebuild")
                upd.apply(ups, list(dels))
                upd.maybe_compact()
            except CompileError:
                upd = IncrementalTables.from_content(
                    merge_rebuild_content(upd.content, ups, dels), rule_width=self._rule_width)
                with self._lock:
                    self._updaters[tid] = upd
            hint = upd.peek_dirty()
            snap = upd.snapshot()
            path = self._clf.load_tenant(tid, snap, hint=hint)
            upd.clear_dirty()
            if merge_ov:
                self._clear_overlay(tid)
            return path

    def _try_overlay_delta(self, tid: int, upd, ups, dels) -> bool:
        """Route a small delta of a shared-page tenant into the overlay
        side-pool.  Eligible iff the classifier has a side-pool, the
        tenant's page is shared, every delete names an overlay-resident
        identity and every upsert is overlay-resident or brand new.  The
        overlay dict commits only after the device load succeeded; a
        side-pool that cannot take it falls back to the clone."""
        ov_alloc = getattr(self._clf, "overlay_allocator", None)
        if ov_alloc is None:
            return False
        alloc = getattr(self._clf, "allocator", None)
        if alloc is None or not alloc.tenant_shares_page(tid):
            return False
        ov = self._overlays.get(tid, {})
        ov_idents = {k.masked_identity(): k for k in ov}
        base_idents = set(upd._ident_to_t)
        for k in dels:
            if k.masked_identity() not in ov_idents:
                return False
        for k in ups:
            ident = k.masked_identity()
            if ident in base_idents and ident not in ov_idents:
                return False
        new_ov = dict(ov)
        for k in dels:
            new_ov.pop(ov_idents[k.masked_identity()], None)
        for k, r in ups.items():
            old_k = ov_idents.get(k.masked_identity())
            if old_k is not None and old_k != k:
                new_ov.pop(old_k, None)
            new_ov[k] = np.asarray(r)
        try:
            if new_ov:
                ct = compile_tables_from_content(new_ov, rule_width=self._rule_width)
                self._clf.load_tenant_overlay(tid, ct)
            else:
                self._clf.load_tenant_overlay(tid, None)
        except Exception:
            # overlay slab bound exceeded or the side-pool full: the caller
            # folds everything into the main slab instead
            return False
        self._overlays[tid] = new_ov
        return True

    def _clear_overlay(self, tid: int) -> None:
        self._overlays.pop(tid, None)
        if getattr(self._clf, "overlay_allocator", None) is not None:
            try:
                self._clf.load_tenant_overlay(tid, None)
            except Exception:
                pass

    def apply_edit_transaction(self, name: str, ops) -> str:
        """Fold and apply a batched edit transaction for one tenant through
        the production fold (txn.fold_ops): N ops, one slab load.  The
        transaction's own overlay routing is off (the side-pool is driven
        by update_tenant), so every folded effect goes to update_tenant;
        "noop" when the ops fold to nothing."""
        with self._op_lock:
            tid = self.tenant_id(name)
            with self._lock:
                upd = self._updaters[tid]
            folded = txn_mod.fold_ops(ops, set(upd._ident_to_t))
            ups, dels, _dirty = txn_mod.route_folded(folded, {}, False, 0)
            if not ups and not dels:
                return "noop"
            return self.update_tenant(name, ups, dels)

    def swap_tenant(self, name: str, content: Dict[LpmKey, np.ndarray]) -> None:
        """Full ruleset replacement by page-table flip: bake the new slab
        into a free page (stage), then activate."""
        with self._op_lock:
            tid = self.tenant_id(name)
            upd = IncrementalTables.from_content(dict(content), rule_width=self._rule_width)
            snap = upd.snapshot()
            # the overlay delta belongs to the ruleset being replaced: clear
            # it before the flip, so a classify sees old main + delta or old
            # main alone, never the new main with a stale delta
            self._clear_overlay(tid)
            t0 = time.perf_counter()
            page = self._clf.stage_tenant(snap)
            t1 = time.perf_counter()
            self._clf.activate_tenant(tid, page, snap)
            t2 = time.perf_counter()
            upd.start_dirty_tracking()
            with self._lock:
                self._updaters[tid] = upd
            self._emit(TenantSwapRecord(
                tenant=name, tenant_id=tid, page=page, entries=snap.num_entries, kind="swap",
                stage_us=(t1 - t0) * 1e6, flip_us=(t2 - t1) * 1e6,
            ))

    def destroy_tenant(self, name: str) -> None:
        with self._op_lock:
            tid = self.tenant_id(name)
            self._clf.destroy_tenant(tid)
            self._overlays.pop(tid, None)  # destroy_tenant freed the side slab
            with self._lock:
                self._names.pop(name, None)
                self._updaters.pop(tid, None)
            self._emit(TenantSwapRecord(
                tenant=name, tenant_id=tid, page=-1, entries=0, kind="destroy",
            ))

    # -- dataplane passthrough ----------------------------------------------

    def classify_mixed(self, batch, tenant_names_or_ids, apply_stats: bool = True):
        """Mixed-tenant classify: per-packet tenant tags by name (str) or id
        (int), one batch, one dispatch.  Unknown names tag -1; ids of any
        integer width pass as int64, so the classifier maps those outside
        [0, max_tenants) to -1 (UNDEF) rather than wrapping them."""
        tags = np.asarray([
            self._names.get(t, -1) if isinstance(t, str) else int(t)
            for t in tenant_names_or_ids
        ], np.int64)
        return self._clf.classify_tenants(batch, tags, apply_stats=apply_stats)
