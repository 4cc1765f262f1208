"""The anomaly-scoring policy tier on the card: shadow and enforce
mitigation over kernel K10 (kernels/mxu_score.py).

The counterpart of the JAX package's ``infw/mlscore.py``.  ``AnomalyTier``
owns the device ScoreState, the model's value tensors and the per-tenant
[threshold, enforce] rows, all int32 / int8 tensors at fixed addresses
(rewritten in place, so the resident step's CUDA graphs keep them), and
drives scoring on every serving plan: the exchange the resident step makes
under this tier's lock (K10's resident entry as a stage of the step) and
one K10 launch per admission on the multi-dispatch plans.

Policy:

- **shadow** (default): scores and per-tenant counters only; verdicts are
  never touched; ``anomaly-verdict`` records ride the event ring at the
  decimated drain cadence;
- **enforce**: a lane over its tenant's threshold is rewritten to Deny
  (ruleId 0), never a failsafe cell and never an existing rule Deny.  On
  the flow plans the enforced verdict is what the flow table caches, and a
  model swap or a policy flip bumps the flow generation (``on_swap``), so
  cached enforced verdicts go stale as after a rule patch.

Models are versioned artifacts: ``save_model`` / ``load_model`` write and
read an npz of the value arrays and a JSON manifest (format tag, version,
geometry, the npz's sha256), the same files as the JAX package's, so an
artifact written by either package loads in the other.

Device order: every launch on the state (classic update, the resident
step's K10, the drain's copies and reset, a swap's or a policy flip's
copies) runs under the tier's lock, and a launch from another stream than
the previous one's first waits on that launch's event.  Lock nesting: the
flow tier's and the telemetry tier's locks may be held when this lock is
taken, never the reverse (flow -> telemetry -> mlscore).

The JAX tier's ``warm`` (the scheduler's pre-warm ladder) is ROADMAP.md
item 24b here.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import threading
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from .kernels import mxu_score as kms
from .kernels.mxu_score import (
    DEFAULT_THRESHOLD,
    HostScoreModel,
    ScoreModel,
    ScoreOps,
    ScoreSpec,
    default_model,
    validate_model,
    zero_tparams,
)
from .kernels.torchpath import resolve_device
from .obs.events import AnomalyVerdictRecord

__all__ = [
    "AnomalyTier", "AnomalyVerdictRecord", "MODEL_FORMAT", "ScoreSnapshot", "load_model",
    "save_model", "summarize_snapshot",
]

#: manifest format tag (the JAX package's)
MODEL_FORMAT = "infw-mlscore-v1"


# --- versioned model artifacts (npz + JSON manifest) ---------------------------------


def save_model(model: ScoreModel, path: str, version: Optional[str] = None) -> str:
    """Write ``path`` (.npz of the value arrays) and ``path + '.json'`` (the
    manifest: format, version, geometry, sha256 of the npz bytes); returns
    the manifest's path.  Both are written to a temporary name and renamed,
    so a scanner never sees a torn artifact."""
    validate_model(model)
    if not path.endswith(".npz"):
        path = path + ".npz"
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **model.arrays())
    os.replace(tmp, path)
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    manifest = {
        "format": MODEL_FORMAT,
        "version": str(version or model.version),
        "spec": dict(model.spec._asdict()),
        "sha256": digest,
    }
    mpath = path + ".json"
    with open(mpath + ".tmp", "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    os.replace(mpath + ".tmp", mpath)
    return mpath


def load_model(path: str) -> ScoreModel:
    """Load a versioned artifact.  The manifest is required and its
    checksum must match the npz bytes."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    mpath = path + ".json"
    if not os.path.exists(mpath):
        raise ValueError(f"score model manifest missing: {mpath}")
    with open(mpath) as f:
        manifest = json.load(f)
    if manifest.get("format") != MODEL_FORMAT:
        raise ValueError(f"score model format {manifest.get('format')!r} != {MODEL_FORMAT!r}")
    with open(path, "rb") as f:
        raw = f.read()
    digest = hashlib.sha256(raw).hexdigest()
    if digest != manifest.get("sha256"):
        raise ValueError(
            f"score model checksum mismatch for {path} (manifest "
            f"{manifest.get('sha256', '')[:12]}.., npz {digest[:12]}..)"
        )
    spec = ScoreSpec.make(**manifest["spec"])
    with np.load(io.BytesIO(raw)) as z:
        model = ScoreModel(spec=spec, version=str(manifest.get("version", "unversioned")),
                           **{k: z[k] for k in kms.MODEL_FIELDS})
    validate_model(model)
    return model


# --- drain records -----------------------------------------------------------------


def _format_src(keys_row: np.ndarray) -> str:
    kind = int(keys_row[5]) & 3
    if kind == 1:
        return ".".join(str(b) for b in int(keys_row[1]).to_bytes(4, "big"))
    import ipaddress

    return str(ipaddress.IPv6Address(keys_row[1:5].astype(">u4").tobytes()))


class ScoreSnapshot(NamedTuple):
    """One drained window's host copies."""

    seq: int
    admissions: int
    skeys: np.ndarray
    scols: np.ndarray
    tstat: np.ndarray
    tparams: np.ndarray


def summarize_snapshot(snap: ScoreSnapshot, top_n: int = 8) -> AnomalyVerdictRecord:
    """The window's record: the tstat row of each tenant that scored, and
    the sources with the most anomaly hits (stable sort on (-hits, slot))."""
    rec = AnomalyVerdictRecord(seq=snap.seq, admissions=snap.admissions)
    for t in np.nonzero(snap.tstat[:, 0] > 0)[0]:
        scored, anom, enforced, mx = (int(x) for x in snap.tstat[t])
        rec.tenants.append({
            "tenant": int(t), "scored": scored, "anom": anom,
            "enforced": enforced, "max_score": mx,
            "threshold": int(snap.tparams[t, 0]),
            "enforce": bool(snap.tparams[t, 1]),
        })
    hits = snap.scols[:, 6]
    occ = np.nonzero(hits > 0)[0]
    order = occ[np.argsort(-hits[occ], kind="stable")][:top_n]
    for slot in order:
        row = snap.skeys[slot]
        rec.top.append({
            "tenant": int(row[0]),
            "src": _format_src(row),
            "anom_hits": int(hits[slot]),
            "pkts": int(snap.scols[slot, 0]),
            "slot": int(slot),
        })
    return rec


# --- the device tier ----------------------------------------------------------------


class AnomalyTier:
    """Host-side owner of the device scoring plane (see the module
    docstring).  ``track_model`` keeps a bit-exact HostScoreModel that
    replays every admission in device order; it is shadow-only (it replays
    from the served verdicts, which enforcement rewrites)."""

    def __init__(self, spec: ScoreSpec, model: Optional[ScoreModel] = None, device=None,
                 mode: str = "shadow", threshold: int = DEFAULT_THRESHOLD,
                 track_model: bool = False, drain_every: int = 256, ring=None,
                 keep_masks: int = 0) -> None:
        if mode not in ("shadow", "enforce"):
            raise ValueError(f"mlscore mode must be shadow|enforce, got {mode!r}")
        if track_model and mode == "enforce":
            raise ValueError("mlscore track_model is shadow-only (the mirror replays from "
                             "served verdicts, which enforcement rewrites)")
        self.spec = spec
        self._device = resolve_device(device)
        self._lock = threading.Lock()
        host_model = model or default_model(spec)
        validate_model(host_model)
        if host_model.spec != spec:
            raise ValueError("mlscore model geometry != tier spec")
        self._state = kms.zero_state(spec, self._device)
        self._model_dev = kms.model_device(host_model, self._device)
        self._tparams_np = zero_tparams(spec, threshold=threshold, enforce=(mode == "enforce"))
        self._tparams_dev = torch.from_numpy(self._tparams_np.copy()).to(self._device)
        self._scratch = kms.empty_scratch(spec, self._device)
        self.model = HostScoreModel(spec, host_model, self._tparams_np) if track_model else None
        #: pending model mirrors in device order: resident entries hold
        #: their dispatch's output handle, replayed once it materializes
        self._mirror_q: list = []
        self.drain_every = int(drain_every)
        self._admissions = 0
        self._window_admissions = 0
        self._drain_seq = 0
        self._ring = ring
        self._zeros_cache: Dict[int, tuple] = {}
        # (event, stream) of the last launch on a card
        self._last = None
        #: test and bench facility: the last ``keep_masks`` admissions'
        #: (epoch, anom mask, scores) triples (0 = off)
        self._keep_masks = int(keep_masks)
        self._masks: list = []
        self.counters = {"updates": 0, "drains": 0, "records": 0, "anomalies": 0,
                         "enforced": 0, "model_swaps": 0}
        self.model_version = host_model.version
        #: control-plane hook run after a model swap or a policy change (the
        #: classifier bumps its flow generation here)
        self.on_swap: Optional[Callable[[], None]] = None
        self.top_n = 8

    # -- plumbing ------------------------------------------------------------------

    def attach_ring(self, ring) -> None:
        with self._lock:
            self._ring = ring

    def ops(self) -> ScoreOps:
        """The launch operands (under the lock: the state is the tier's)."""
        return ScoreOps(self._state, self._model_dev, self._tparams_dev, self._scratch, self.spec)

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy()).to(self._device)

    def _zeros(self, b: int):
        z = self._zeros_cache.get(b)
        if z is None:
            zero = np.zeros(b, np.int32)
            z = (self._put(zero), self._put(zero))
            self._zeros_cache[b] = z
        return z

    def _ordered(self):
        """Under the lock, before a launch or a copy: order it after the
        previous one when that ran on another stream.  Returns the stream
        to record on (None off the card)."""
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

    def reset_state(self) -> None:
        """Zero the state in place (model, policy and counters untouched)."""
        with self._lock:
            stream = self._ordered()
            kms.score_reset(self._state)
            self._record(stream)
            if self.model is not None:
                self.model.reset_state()
            self._mirror_q.clear()
            self._masks.clear()

    # -- policy --------------------------------------------------------------------

    def _policy_changed_locked(self) -> None:
        stream = self._ordered()
        self._tparams_dev.copy_(torch.from_numpy(self._tparams_np))
        self._record(stream)
        if self.model is not None:
            self.model.tparams = self._tparams_np.copy()

    def set_mode(self, mode: str, tenant: Optional[int] = None) -> None:
        """Flip shadow / enforce for one tenant (or all): the policy rows are
        rewritten in place; then ``on_swap`` (flow entries caching verdicts
        decided under the old policy go stale)."""
        if mode not in ("shadow", "enforce"):
            raise ValueError(f"mlscore mode must be shadow|enforce, got {mode!r}")
        with self._lock:
            if mode == "enforce" and self.model is not None:
                raise ValueError("mlscore track_model is shadow-only; detach the mirror before "
                                 "enforcing")
            rows = slice(None) if tenant is None else int(tenant)
            self._tparams_np[rows, 1] = 1 if mode == "enforce" else 0
            self._policy_changed_locked()
            hook = self.on_swap
        if hook is not None:
            hook()

    def set_threshold(self, threshold: int, tenant: Optional[int] = None) -> None:
        with self._lock:
            rows = slice(None) if tenant is None else int(tenant)
            self._tparams_np[rows, 0] = int(threshold)
            self._policy_changed_locked()
            hook = self.on_swap
        if hook is not None:
            hook()

    def tparams(self) -> np.ndarray:
        with self._lock:
            return self._tparams_np.copy()

    def swap_model(self, model: ScoreModel, version: Optional[str] = None) -> None:
        """Hot-swap the model's values: validate, rewrite the value tensors in
        place (no graph captured again), swap the mirror's model, then run
        ``on_swap``."""
        validate_model(model)
        if model.spec != self.spec:
            raise ValueError(f"score model geometry {model.spec} != tier spec {self.spec} "
                             "(geometry changes are a tier rebuild, not a hot swap)")
        with self._lock:
            stream = self._ordered()
            kms.model_copy_(self._model_dev, model)
            self._record(stream)
            self.model_version = str(version or model.version)
            if self.model is not None:
                self.model.swap(model)
            self._note("model_swaps")
            hook = self.on_swap
        if hook is not None:
            hook()

    # -- updates -------------------------------------------------------------------

    def update(self, wire_np: np.ndarray, res: np.ndarray,
               tenant_np: Optional[np.ndarray] = None,
               tflags_np: Optional[np.ndarray] = None):
        """The multi-dispatch plans' scoring launch: one K10 launch per
        admission over (wire, merged rule verdicts) and one read back.
        Returns (res16' uint16, anom bool, scores int32 saturated to int16,
        as the resident read back carries them; the anomaly decision was
        taken on the raw int32)."""
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
            out = kms.score_update(self.ops(), wire, tenant, tflags, res_dev)
            self._record(stream)
            self._admissions += 1
            self._window_admissions += 1
            epoch = self._admissions
            self._note("updates")
            if self.model is not None:
                self._mirror_q.append(
                    (np.asarray(wire_np, np.uint32).copy(),
                     None if tenant_np is None else np.asarray(tenant_np, np.int32).copy(),
                     None if tflags_np is None else np.asarray(tflags_np, np.int32).copy(),
                     np.asarray(res, np.uint32).copy(), None))
                self._replay_ready_locked()
        score, anom, res_out = kms.split_score_outputs(out.cpu().numpy(), b)
        score = np.clip(score, -32768, 32767).astype(np.int32)
        res16 = (res_out & 0xFFFF).astype(np.uint16)
        self._note_result(epoch, anom, score)
        self.maybe_drain()
        return res16, anom, score

    def resident_exchange(self, launch: Callable, wire_np, tenant_np, tflags_np, k: int = 0):
        """The resident step's turn on the state: ``launch(ScoreOps)`` runs
        under this tier's lock (the caller holds the flow tier's and, with
        the telemetry plane, the telemetry tier's), so the step's K10 lands
        in device order with every other update; it returns the dispatch's
        output handle.  ``k`` > 0 is a superbatch of ``k`` admissions
        (``wire_np`` (k, b, W)).  With the model mirror each admission
        queues its wire and the handle (and row) its verdicts come from."""
        steps = max(int(k), 1)
        with self._lock:
            stream = self._ordered()
            handle = launch(self.ops())
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

    def resident_exchange_super(self, launch: Callable, k: int, wire_np, tenant_np, tflags_np):
        """``resident_exchange`` for a superbatch of ``k`` admissions."""
        return self.resident_exchange(launch, wire_np, tenant_np, tflags_np, k=k)

    def _replay_ready_locked(self) -> None:
        """Drain the mirror queue's head in device order.  A resident entry's
        verdicts are in its dispatch's output (shadow-only: there they are
        the rule verdicts)."""
        from .kernels.resident import split_resident_score_outputs

        while self._mirror_q:
            wire, tenant, tflags, res, fused = self._mirror_q[0]
            if res is None:
                handle, row = fused
                arr = handle.host()
                res = split_resident_score_outputs(arr if row is None else arr[row],
                                                   wire.shape[0])[0].astype(np.uint32)
            self.model.update(wire, res, tenant, tflags)
            self._mirror_q.pop(0)

    def _note_result(self, epoch: int, anom_np: np.ndarray,
                     score_np: Optional[np.ndarray]) -> None:
        n_anom = int(anom_np.sum()) if anom_np is not None else 0
        with self._lock:
            if n_anom:
                self._note("anomalies", n_anom)
            if self._keep_masks and anom_np is not None:
                self._masks.append((epoch, anom_np.copy(),
                                    None if score_np is None else score_np.copy()))
                del self._masks[:-self._keep_masks]

    def resident_note_materialized(self, epoch: int, anom_np: Optional[np.ndarray] = None,
                                   score_np: Optional[np.ndarray] = None,
                                   enforced: int = 0) -> None:
        """Materialize hook of a resident admission: replay the pending model
        mirrors, note the admission's anomaly outcome and run the drain
        cadence check."""
        if self.model is not None:
            with self._lock:
                self._replay_ready_locked()
        if anom_np is not None:
            self._note_result(epoch, anom_np, score_np)
        if enforced:
            with self._lock:
                self._note("enforced", enforced)
        self.maybe_drain()

    def recent_masks(self) -> list:
        """The retained (epoch, anom mask, scores) triples, oldest first."""
        with self._lock:
            return list(self._masks)

    def set_keep_masks(self, n: int) -> None:
        """Resize the retained-decision window (0 disables and drops it)."""
        with self._lock:
            self._keep_masks = int(n)
            if not self._keep_masks:
                self._masks.clear()
            else:
                del self._masks[:-self._keep_masks]

    # -- the decimated drain ---------------------------------------------------------

    def maybe_drain(self) -> List[AnomalyVerdictRecord]:
        with self._lock:
            due = self._window_admissions >= self.drain_every
        return self.drain() if due else []

    def drain(self, force: bool = True) -> List[AnomalyVerdictRecord]:
        """Snapshot and reset the window state and emit the window's record
        on the attached ring, atomically with the admission counters under
        the lock (every admission in exactly one window, ``seq`` without
        gaps).  Only tstat and the per-row anomaly hits reset; the rates
        persist."""
        with self._lock:
            if not force and self._window_admissions < self.drain_every:
                return []
            if self.model is not None:
                self._replay_ready_locked()
            stream = self._ordered()
            host = kms.state_to_host(self._state)
            snap = ScoreSnapshot(seq=self._drain_seq + 1, admissions=self._window_admissions,
                                 skeys=host["skeys"], scols=host["scols"], tstat=host["tstat"],
                                 tparams=self._tparams_np.copy())
            kms.score_drain(self._state)
            self._record(stream)
            if self.model is not None:
                self.model.drain()
            self._drain_seq += 1
            self._window_admissions = 0
            self._note("drains")
            enforced = int(snap.tstat[:, 2].sum())
            if enforced:
                self._note("enforced", enforced)
            rec = summarize_snapshot(snap, top_n=self.top_n)
            self._note("records")
            if self._ring is not None:
                self._ring.push(rec)
        return [rec]

    # -- introspection -----------------------------------------------------------------

    def columns(self) -> Dict[str, np.ndarray]:
        """Host copies of the state (``skeys`` as uint32), read in device
        order under the lock."""
        with self._lock:
            self._ordered()
            return kms.state_to_host(self._state)

    def counter_values(self) -> Dict[str, int]:
        """mlscore_* counters for /metrics."""
        with self._lock:
            out = {f"mlscore_{k}_total": int(v) for k, v in self.counters.items()}
            out["mlscore_admissions_total"] = self._admissions
            out["mlscore_drain_seq"] = self._drain_seq
            out["mlscore_window_admissions"] = self._window_admissions
            out["mlscore_enforce_tenants"] = int((self._tparams_np[:, 1] != 0).sum())
        return out
