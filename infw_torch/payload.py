"""The payload-matching policy tier on the card: shadow and enforce
mitigation over kernel K11 (kernels/acmatch.py).

The counterpart of the JAX package's ``infw/payload.py``.  ``PayloadTier``
owns the compiled automaton's device tensors (``delta``, ``matchmap``), the
(1,) int32 mode tensor (0 shadow, 1 enforce) and the match counters, and
serves every plan: the exchange the resident step makes under this tier's
lock (K11's resident entry as the step's stage between K10 and K8) and one
K11 launch per admission on the multi-dispatch plans (``apply_wire``).

Policy, as the scoring tier's enforce mode: a matched lane is rewritten to
Deny (ruleId 0), never a failsafe cell and never an existing rule Deny; in
shadow mode the tier only counts.  On the flow plans the enforced verdict is
what the flow table caches, and a pattern swap or a mode flip bumps the flow
generation (the classifier's ``_on_pattern_swap``).

A CUDA graph of the resident step bakes the automaton's and the mode's
addresses, so ``swap_patterns`` copies the new tables into the same tensors
and ``set_mode`` writes the mode tensor, both in place.  Device order: every
launch that reads them (the classic match, the resident step's K11) and
every such write runs under the tier's lock, and one from another stream
than the previous one's first waits on that one's event.  Lock nesting: the
flow, telemetry and scoring tiers' locks may be held when this lock is
taken, never the reverse (flow -> telemetry -> mlscore -> payload).  A swap
that changes the AcSpec raises, as in the JAX package.

Pattern sets are versioned artifacts (``save_patterns`` / ``load_patterns``):
an npz of the concatenated pattern bytes and their lengths plus a JSON
manifest (format ``infw-acmatch-v1``, version, geometry, the npz's sha256),
the JAX package's files, so an artifact written by either package loads in
the other.  The seeded generators (``signature_patterns``,
``benign_payloads``, ``attack_payloads``) equal the JAX package's.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import threading
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .kernels import acmatch as kac
from .kernels.acmatch import (
    AcModel,
    AcSpec,
    PayloadOps,
    compile_patterns,
    host_payload_rewrite,
    validate_patterns,
)
from .kernels.torchpath import host_to_device, resolve_device

#: manifest format tag
PATTERN_FORMAT = "infw-acmatch-v1"


# --- versioned pattern-set artifacts -------------------------------------------------


def save_patterns(patterns: Sequence[bytes], path: str, plen: int = 64,
                  version: Optional[str] = None, spec: Optional[AcSpec] = None) -> str:
    """Write ``path`` (.npz: the concatenated pattern bytes and their
    lengths) and ``path + '.json'`` (the manifest); returns the manifest's
    path.  Both land by rename, so a scanner never sees a torn artifact."""
    patterns = [bytes(p) for p in patterns]
    validate_patterns(patterns, plen)
    if spec is None:
        spec = compile_patterns(patterns, plen=plen).spec
    if not path.endswith(".npz"):
        path = path + ".npz"
    blob = np.frombuffer(b"".join(patterns), np.uint8)
    lens = np.asarray([len(p) for p in patterns], np.int32)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, blob=blob, lens=lens)
    os.replace(tmp, path)
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    manifest = {
        "format": PATTERN_FORMAT,
        "version": str(version or "0"),
        "spec": dict(spec._asdict()),
        "patterns": len(patterns),
        "sha256": digest,
    }
    mpath = path + ".json"
    with open(mpath + ".tmp", "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    os.replace(mpath + ".tmp", mpath)
    return mpath


def load_patterns(path: str) -> Tuple[List[bytes], AcSpec, str]:
    """Read an artifact -> (patterns, spec, version).  The manifest is
    required and its checksum must match the npz's bytes."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    mpath = path + ".json"
    if not os.path.exists(mpath):
        raise ValueError(f"pattern-set manifest missing: {mpath}")
    with open(mpath) as f:
        manifest = json.load(f)
    if manifest.get("format") != PATTERN_FORMAT:
        raise ValueError(f"pattern-set format {manifest.get('format')!r} != {PATTERN_FORMAT!r}")
    with open(path, "rb") as f:
        raw = f.read()
    digest = hashlib.sha256(raw).hexdigest()
    if digest != manifest.get("sha256"):
        raise ValueError(
            f"pattern-set checksum mismatch for {path} (manifest "
            f"{manifest.get('sha256', '')[:12]}.., npz {digest[:12]}..)"
        )
    with np.load(io.BytesIO(raw)) as z:
        blob = bytes(np.asarray(z["blob"], np.uint8).tobytes())
        lens = np.asarray(z["lens"], np.int64)
    pats, off = [], 0
    for n in lens:
        pats.append(blob[off:off + int(n)])
        off += int(n)
    return pats, AcSpec(**manifest["spec"]), str(manifest.get("version", "0"))


# --- seeded pattern and traffic generators -------------------------------------------

_HTTP_METHODS = (b"GET", b"POST", b"HEAD", b"PUT")
_HTTP_PATHS = (b"/", b"/index.html", b"/api/v1/items", b"/static/app.js", b"/health",
               b"/favicon.ico")


def signature_patterns(rng, count: int, plen: int = 64) -> List[bytes]:
    """A seeded signature set: a few text tokens with overlapping suffixes
    (the failure links' case) and random byte signatures of mixed length."""
    base = [b"/etc/passwd", b"etc/passwd", b"passwd", b"<script>", b"script>", b"SELECT ",
            b"ELECT ", b"\x90\x90\x90\x90"]
    pats: List[bytes] = list(base[:min(count, len(base))])
    seen = set(pats)
    while len(pats) < count:
        n = int(rng.integers(2, min(17, plen + 1)))
        p = bytes(rng.integers(0, 256, size=n, dtype=np.uint8).tobytes())
        if p and p not in seen and len(p) <= plen:
            seen.add(p)
            pats.append(p)
    return pats[:count]


def benign_payloads(rng, n: int, plen: int = 64) -> Tuple[np.ndarray, np.ndarray]:
    """(pay (n, plen) uint8, lengths (n,) int32): HTTP request prefixes of
    varying length."""
    pay = np.zeros((n, plen), np.uint8)
    lens = np.zeros(n, np.int32)
    for i in range(n):
        m = _HTTP_METHODS[int(rng.integers(0, len(_HTTP_METHODS)))]
        p = _HTTP_PATHS[int(rng.integers(0, len(_HTTP_PATHS)))]
        line = (m + b" " + p + b" HTTP/1.1\r\nHost: example-"
                + str(int(rng.integers(0, 100))).encode() + b".net\r\n\r\n")
        k = min(len(line), plen)
        pay[i, :k] = np.frombuffer(line[:k], np.uint8)
        lens[i] = k
    return pay, lens


def attack_payloads(rng, n: int, patterns: Sequence[bytes],
                    plen: int = 64) -> Tuple[np.ndarray, np.ndarray]:
    """Benign rows with one pattern planted in each at a random offset,
    sometimes crossing the prefix boundary (those must not match)."""
    pay, lens = benign_payloads(rng, n, plen)
    pats = [bytes(p) for p in patterns]
    for i in range(n):
        p = pats[int(rng.integers(0, len(pats)))]
        lens[i] = plen
        if rng.random() < 0.15 and len(p) > 1:
            off = plen - int(rng.integers(1, len(p)))  # straddles the cut
        else:
            off = int(rng.integers(0, plen - len(p) + 1))
        end = min(off + len(p), plen)
        pay[i, off:end] = np.frombuffer(p[:end - off], np.uint8)
    return pay, lens


def clamp_payload(pay, plen, cap: int):
    """A payload column fixed to the tier's prefix width (tpu.py
    _clamp_payload): (..., L) uint8 zero-padded or truncated to (..., cap),
    the lengths (all L when None) clipped to at most cap."""
    pay = np.ascontiguousarray(pay, np.uint8)
    w = pay.shape[-1]
    if plen is None:
        plen = np.full(pay.shape[:-1], w, np.int32)
    if w != cap:
        fixed = np.zeros(pay.shape[:-1] + (cap,), np.uint8)
        k = min(cap, w)
        fixed[..., :k] = pay[..., :k]
        pay = fixed
    plen = np.ascontiguousarray(plen, np.int32)
    if plen.size and int(plen.max()) > cap:
        plen = np.minimum(plen, np.int32(cap))
    return pay, plen


# --- the serving tier ---------------------------------------------------------------


class PayloadTier:
    """The automaton's device tensors, the mode tensor and the counters (see
    the module docstring)."""

    def __init__(self, model_or_patterns, plen: int = 64, mode: str = "shadow",
                 spec: Optional[AcSpec] = None, keep_masks: int = 0, device=None) -> None:
        if isinstance(model_or_patterns, AcModel):
            model = model_or_patterns
        else:
            model = compile_patterns(model_or_patterns, plen=plen, spec=spec)
        if mode not in ("shadow", "enforce"):
            raise ValueError(f"payload mode {mode!r}")
        self._lock = threading.Lock()
        self._device = resolve_device(device)
        self.model = model
        self.spec = model.spec
        self.mode = mode
        self.version = 0
        self._dev = kac.model_device(model, self._device)
        self._pmode = torch.tensor([1 if mode == "enforce" else 0], dtype=torch.int32,
                                   device=self._device)
        self._last = None  # (event, stream) of the last launch or write on the card
        self._counters: Dict[str, int] = {
            "admissions": 0, "lanes": 0, "matched": 0, "enforced": 0, "swaps": 0,
        }
        self._keep = int(keep_masks)
        self._masks: deque = deque(maxlen=max(1, self._keep))
        #: the classifier's hook, run after a swap (the flow generation bump)
        self.on_swap: Optional[Callable[[], None]] = None

    # -- device order ----------------------------------------------------------

    def _ordered(self):
        """Under the lock, before a launch or a write: order it after the
        previous one when that ran on another stream.  Returns the stream to
        record on (None off the card)."""
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

    def ops(self) -> PayloadOps:
        """The automaton, the mode tensor and the spec (no payload column)."""
        return PayloadOps(self._dev, self._pmode, self.spec)

    def set_mode(self, mode: str) -> None:
        """Flip shadow / enforce: the mode tensor written in place."""
        if mode not in ("shadow", "enforce"):
            raise ValueError(f"payload mode {mode!r}")
        with self._lock:
            stream = self._ordered()
            self._pmode.fill_(1 if mode == "enforce" else 0)
            self._record(stream)
            self.mode = mode

    def set_keep_masks(self, n: int) -> None:
        with self._lock:
            self._keep = int(n)
            self._masks = deque(self._masks, maxlen=max(1, self._keep))

    @property
    def tracking(self) -> bool:
        """Whether retained-mask tracking is on: the resident plans then
        take the full bitmap from one classic launch an admission (their
        read back carries only the matched and rewritten bits)."""
        with self._lock:
            return self._keep > 0

    def recent_masks(self) -> list:
        """The retained [(pay, plen, bitmap, hit)] admissions (tracking
        only)."""
        with self._lock:
            return list(self._masks)

    # -- the resident step's turn ----------------------------------------------

    def resident_exchange(self, launch: Callable, pay: torch.Tensor, plen: torch.Tensor):
        """``launch(PayloadOps)`` under this tier's lock, with the
        admission's device payload column (the caller holds the flow tier's
        and any other tier's lock); returns what ``launch`` returns."""
        with self._lock:
            stream = self._ordered()
            handle = launch(PayloadOps(self._dev, self._pmode, self.spec, pay, plen))
            self._record(stream)
        return handle

    # -- the multi-dispatch follow-on ------------------------------------------

    def match(self, pay_np: np.ndarray, plen_np: np.ndarray) -> np.ndarray:
        """One K11 launch -> (B, PW) uint32 bitmaps (the column fixed to the
        spec's width first)."""
        pay_np, plen_np = clamp_payload(pay_np, plen_np, self.spec.plen)
        pay = host_to_device(pay_np, self._device)
        plen = host_to_device(plen_np, self._device)
        with self._lock:
            stream = self._ordered()
            out = kac.acmatch(self._dev, pay, plen, self.spec)
            self._record(stream)
        return out.cpu().numpy().view(np.uint32)

    def apply_wire(self, res16: np.ndarray, pay_np: np.ndarray, plen_np: np.ndarray,
                   proto: np.ndarray, dst_port: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """The multi-dispatch follow-on: the match, then the enforce-mode
        rewrite on the host -> (res16', hit).  Counts the admission."""
        bitmap = self.match(pay_np, plen_np)
        with self._lock:
            model, enforce = self.model, self.mode == "enforce"
        res_out = host_payload_rewrite(model, res16, bitmap, enforce, proto, dst_port)
        hit = (bitmap != 0).any(axis=1)
        self.note(bitmap, hit, res_out != np.asarray(res16, np.uint32), pay_np=pay_np,
                  plen_np=plen_np)
        return res_out, hit

    # -- counters ----------------------------------------------------------------

    def note(self, bitmap: Optional[np.ndarray], hit: np.ndarray, rewrote: np.ndarray,
             pay_np: Optional[np.ndarray] = None, plen_np: Optional[np.ndarray] = None) -> None:
        """Fold one admission into the counters (and the retained masks when
        tracking)."""
        with self._lock:
            self._counters["admissions"] += 1
            self._counters["lanes"] += int(np.asarray(hit).shape[0])
            self._counters["matched"] += int(np.count_nonzero(hit))
            self._counters["enforced"] += int(np.count_nonzero(rewrote))
            if self._keep and pay_np is not None and bitmap is not None:
                self._masks.append((np.array(pay_np, np.uint8, copy=True),
                                    np.array(plen_np, np.int32, copy=True),
                                    np.array(bitmap, np.uint32, copy=True),
                                    np.array(hit, bool, copy=True)))

    def counter_values(self) -> Dict[str, int]:
        """payload_* counters and gauges for /metrics."""
        with self._lock:
            return {
                "payload_admissions_total": self._counters["admissions"],
                "payload_lanes_total": self._counters["lanes"],
                "payload_matched_total": self._counters["matched"],
                "payload_enforced_total": self._counters["enforced"],
                "payload_pattern_swaps_total": self._counters["swaps"],
                "payload_patterns": len(self.model.patterns),
                "payload_patternset_version": self.version,
            }

    # -- hot swap ----------------------------------------------------------------

    def swap_patterns(self, patterns_or_model, plen: Optional[int] = None) -> None:
        """Replace the pattern set in the same AcSpec: the tables copied into
        the same tensors (no capture), then ``on_swap``.  A set that needs
        another geometry raises."""
        if isinstance(patterns_or_model, AcModel):
            model = patterns_or_model
        else:
            model = compile_patterns(patterns_or_model, plen=plen or self.spec.plen,
                                     spec=self.spec)
        if model.spec != self.spec:
            raise ValueError(f"pattern swap changes geometry {self.spec} -> {model.spec}; "
                             "a swap must stay in-bucket")
        with self._lock:
            stream = self._ordered()
            kac.model_copy_(self._dev, model)
            self._record(stream)
            self.model = model
            self.version += 1
            self._counters["swaps"] += 1
            self._masks.clear()  # matched by the old set
            hook = self.on_swap
        if hook is not None:
            hook()

    def reset_counters(self) -> None:
        with self._lock:
            for k in self._counters:
                self._counters[k] = 0
