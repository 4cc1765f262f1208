"""The resident serving pool: one device program per admission, one copy
in and one read back.

The counterpart of the JAX package's ``infw/resident.py``.  With a pool a
classifier serves a 4- or 7-word chunk through the resident step
(kernels/resident.py: K7, the path's classify of every lane, the merge,
K8 under ``lane_ok = ~hit``) in place of the multi-dispatch flow plan,
whose probe, miss classify and insert each read back.

``ResidentPool`` owns, per table generation, the context the step closes
over (``context``) and, on the card, the CUDA graphs that replay it:

- one ``torch.cuda.CUDAGraph`` per (table layout, bucket, wire width,
  flags or none, trie level count, superbatch K, telemetry on or off,
  anomaly scoring on or off, the payload tier's AcSpec or none, pipeline
  slot).  A graph
  reads the tables from static buffers of the context's layout, which each
  dispatch refills in stream order from its own generation's tensors (a
  copy of each tensor that changed since the last dispatch; a patch clones
  only the arrays it changed).  So a load whose tables keep the layout (the
  same tensor shapes and dtypes, equal host values: ``same_layout``; a
  padded build and a patch keep it while the row buckets hold) keeps every
  graph, and only a new layout retires them and captures again.  The
  static buffers hold a second copy of the tables on the card.  A chunk is
  padded with KIND_OTHER rows to a power-of-two bucket (at least 8), rows
  that no kernel counts, caches or inserts, so a daemon's tails reuse a
  few graphs;
- a graph owns its device input (wire, then flags, then the payload
  column's bytes and lengths), its fused output, its lane scratch, and a
  pinned host buffer for each direction (so the payload column rides the
  wire's one copy in).  A dispatch
  fills the pinned input, copies it in (``non_blocking``), replays the
  graph and copies the output back into the pinned output, then records an
  event: one H2D, one replay, one D2H.  The flow columns, the device
  epoch and the tier's generation and page operands are the tier's, at
  fixed addresses (``FlowTier.resident_dispatch``);
- the two slots (``PIPELINE_SLOTS``) alternate, so two admissions can be
  in flight with outputs of their own.  A dispatch on a slot whose last
  output was not read yet first waits for that output's event and keeps a
  host copy of it (the JAX package's back-to-back unread outputs).  A
  graph's lock is held from there until its replay is enqueued, so
  dispatches from several threads that land on one graph take turns.
  Reading an output takes only a leaf lock of its graph (``land_lock``),
  never the graph's: the flow and telemetry tiers read outputs under
  their own locks when they replay their host models, and a dispatch
  holds the graph's lock while it waits for theirs;
- a graph keeps the operands and tables its capture baked in (``baked``):
  the tiers' columns and zero columns, the static tables, the epoch, the
  scoring tier's state, model, policy rows and scratch, the payload tier's
  automaton and mode tensor, so no address it replays is freed and reused
  (a model swap, a pattern swap or a mode flip rewrites those tensors in
  place and captures nothing);
- capturing is not launching: the kernels' ``launches`` counts taken
  during a capture are taken back, and each replay adds them again.

On the CPU the step runs eagerly on the plain versions, without graphs or
pinned buffers.  Counters (``resident_*`` on /metrics, JAX's names):
``allocs`` (contexts, zero columns, device-epoch seeds and, on the card,
graph captures), ``reuses`` (context cache hits), ``dispatches``,
``fallbacks`` (admissions the path declined: wide ruleIds), the superbatch
counts and the per-slot dispatches.  ``mark_warm`` freezes the allocation
baseline; ``steady_allocs`` is what the serving path allocated since.

The JAX pool's injected stale-context defect (``_INJECT_RESIDENT_STALE_
BUG``) belongs to the verifiers, ROADMAP.md item 17.
"""
from __future__ import annotations

import threading
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from .constants import KIND_OTHER
from .kernels import all_kernels
from .kernels.resident import StepTables, resident_out_words, resident_step, resident_superbatch


class ResidentContext(NamedTuple):
    """A table generation's step operands and, on the card, the static
    tables and graphs of its layout (shared with the generations before it
    of the same layout)."""

    gen: int
    tables: StepTables  # n_levels is filled per dispatch on the trie path
    active: object      # the classifier's snapshot of this generation
    graphs: dict
    static: Optional["_StaticTables"] = None


def same_layout(a, b) -> bool:
    """Whether a graph captured on tables ``a`` serves tables ``b`` once
    b's card tensors are copied into a's buffers: the same structure, card
    tensors of the same shape, dtype and device, and equal host values
    (host tensors such as the dense path's groups, level counts, d_max),
    which a launch takes by value."""
    if type(a) is not type(b):
        return False
    if isinstance(a, torch.Tensor):
        if a.shape != b.shape or a.dtype != b.dtype or a.device != b.device:
            return False
        return a.is_cuda or torch.equal(a, b)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(same_layout(x, y) for x, y in zip(a, b))
    return a == b


def _leaves(t) -> tuple:
    if isinstance(t, tuple):
        return tuple(x for item in t for x in _leaves(item))
    return (t,)


def _map_tensors(t, fn):
    """``t`` with ``fn`` applied to each card tensor inside it."""
    if isinstance(t, tuple):
        items = [_map_tensors(x, fn) for x in t]
        return type(t)(*items) if hasattr(t, "_fields") else type(t)(items)
    return fn(t) if isinstance(t, torch.Tensor) and t.is_cuda else t


class _StaticTables:
    """One layout's step tables at fixed addresses: a buffer per card
    tensor, refilled by ``sync`` from the generation a dispatch serves."""

    def __init__(self, tables: StepTables) -> None:
        self.tables = _map_tensors(tables, torch.empty_like)
        self._src: Optional[tuple] = None  # the source leaves last copied

    def sync(self, tables: StepTables) -> StepTables:
        """Under the flow tier's lock, before a launch (so in stream order
        after every earlier replay that read the buffers): copy each card
        tensor of ``tables`` that is not the one copied last.  Returns the
        static tables."""
        src = _leaves(tables)
        last = self._src or (None,) * len(src)
        for s, d, prev in zip(src, _leaves(self.tables), last):
            if s is not prev and isinstance(s, torch.Tensor) and s.is_cuda:
                d.copy_(s)
        self._src = src
        return self.tables


class HostOutput:
    """A CPU dispatch's fused output (already computed)."""

    def __init__(self, out: torch.Tensor) -> None:
        self._out = out

    def host(self) -> np.ndarray:
        return self._out.numpy()


class _Graph:
    """One captured step (or superbatch) and its buffers (see the module
    docstring)."""

    def __init__(self, k: int, bucket: int, width: int, flags: bool, device,
                 score: bool = False, pay_width: int = 0) -> None:
        steps = max(k, 1)
        self.k, self.bucket, self.width, self.flags = k, bucket, width, flags
        self.score = score
        self.pay_width = pay_width  # the payload column's bytes a row, 0 without one
        self.pay_at = steps * bucket * (width + (1 if flags else 0))  # a multiple of 8 words
        self.in_words = self.pay_at + steps * bucket * (pay_width // 4 + 1 if pay_width else 0)
        self.out_words = steps * resident_out_words(bucket, score, pay_width > 0)
        self.stage = torch.empty(self.in_words, dtype=torch.int32, device=device)
        self.out = torch.empty(self.out_words, dtype=torch.int32, device=device)
        self.scratch = torch.empty(2 * bucket + 4, dtype=torch.int32, device=device)
        self.pinned_in = torch.empty(self.in_words, dtype=torch.int32, pin_memory=True)
        self.pinned_out = torch.empty(self.out_words, dtype=torch.int32, pin_memory=True)
        self.event = torch.cuda.Event()
        self.lock = threading.RLock()
        # guards only the read of the last dispatch's output; taken inside
        # ``lock`` and inside the tiers' locks, and takes no lock itself
        self.land_lock = threading.Lock()
        self.graph = None
        # the operands and tables the capture baked in: held as long as the
        # graph, so no address it replays is freed and reused
        self.baked = None
        self.deltas: Dict[object, int] = {}
        self.landing: Optional["_Landing"] = None  # the last dispatch's, until read

    def wire(self) -> torch.Tensor:
        n = max(self.k, 1) * self.bucket * self.width
        shape = (self.k, self.bucket, self.width) if self.k else (self.bucket, self.width)
        return self.stage[:n].view(shape)

    def tflags(self) -> Optional[torch.Tensor]:
        if not self.flags:
            return None
        n = max(self.k, 1) * self.bucket * self.width
        return self.stage[n: self.pay_at].view((self.k, self.bucket) if self.k
                                              else (self.bucket,))

    def _rows(self) -> tuple:
        return (self.k, self.bucket) if self.k else (self.bucket,)

    def pay(self) -> Optional[torch.Tensor]:
        """The payload column's bytes on the card, (…, bucket, pay_width)
        uint8, 16-byte aligned rows."""
        if not self.pay_width:
            return None
        n = max(self.k, 1) * self.bucket * self.pay_width // 4
        return self.stage[self.pay_at: self.pay_at + n].view(torch.uint8).view(
            self._rows() + (self.pay_width,))

    def plen(self) -> Optional[torch.Tensor]:
        if not self.pay_width:
            return None
        at = self.pay_at + max(self.k, 1) * self.bucket * self.pay_width // 4
        return self.stage[at: self.in_words].view(self._rows())

    def fused(self) -> torch.Tensor:
        return self.out.view(self.k, -1) if self.k else self.out

    def fill(self, wire_np: np.ndarray, tflags_np: Optional[np.ndarray], pay_np=None,
             plen_np=None) -> None:
        """The pinned input: the rows, KIND_OTHER rows up to the bucket,
        then the flags (0 on the padding rows), then the payload bytes and
        lengths (length 0 on the padding rows: they never match)."""
        steps = max(self.k, 1)
        host = self.pinned_in.numpy()
        nwire = steps * self.bucket * self.width
        rows = host[:nwire].reshape(steps, self.bucket, self.width)
        w = np.asarray(wire_np, np.uint32).reshape(steps, -1, self.width)
        n = w.shape[1]
        rows[:, :n] = w.view(np.int32)
        rows[:, n:] = 0
        rows[:, n:, 0] = KIND_OTHER
        if self.flags:
            fl = host[nwire: self.pay_at].reshape(steps, self.bucket)
            fl[:, :n] = np.asarray(tflags_np, np.int32).reshape(steps, n)
            fl[:, n:] = 0
        if self.pay_width:
            nb = steps * self.bucket * self.pay_width // 4
            pay = host[self.pay_at: self.pay_at + nb].view(np.uint8).reshape(
                steps, self.bucket, self.pay_width)
            pay[:, :n] = np.asarray(pay_np, np.uint8).reshape(steps, n, self.pay_width)
            pay[:, n:] = 0
            pl = host[self.pay_at + nb: self.in_words].reshape(steps, self.bucket)
            pl[:, :n] = np.asarray(plen_np, np.int32).reshape(steps, n)
            pl[:, n:] = 0

    def take_landing(self) -> None:
        """Keep a host copy of the last dispatch's output before the slot is
        reused."""
        if self.landing is not None:
            self.landing.host()
            self.landing = None


class _Landing:
    """A card dispatch's output: the pinned words once its event fired,
    copied out on first read (so the slot may be reused)."""

    def __init__(self, g: _Graph, n: int) -> None:
        self._g, self._n, self._arr = g, n, None

    def host(self) -> np.ndarray:
        g = self._g
        if self._arr is None and g is not None:
            # a dispatch that reuses the slot reads this output first, under
            # the same leaf lock, so the event is still this dispatch's
            with g.land_lock:
                if self._arr is None:
                    g.event.synchronize()
                    arr = _rebucket(g.pinned_out.numpy().reshape(max(g.k, 1), -1), self._n,
                                    g.bucket, g.score, g.pay_width > 0)
                    self._arr = np.array(arr if g.k else arr[0])
                    if g.landing is self:
                        g.landing = None
                    self._g = None
        return self._arr


def _rebucket(arr: np.ndarray, n: int, bucket: int, score: bool = False,
              payload: bool = False) -> np.ndarray:
    """(rows, resident_out_words(bucket)) fused outputs of a padded step ->
    the (rows, resident_out_words(n)) layout of ``n`` lanes: the padding
    lanes are KIND_OTHER rows (result 0, never hit, never anomalous, payload
    length 0), so the result and bitmap words of the first ``n`` lanes are
    kept and the counts moved, with ``score`` the anomaly bitmap and score
    words too, and with ``payload`` the matched and rewritten bitmaps."""
    if n == bucket:
        return arr
    nwb, nhb = (bucket + 1) // 2, -(-bucket // 32)
    nw, nh = (n + 1) // 2, -(-n // 32)
    words = resident_out_words(n, score, payload)
    out = np.zeros((arr.shape[0], words), np.int32)

    def halves(dst, src):  # packed 16-bit words
        out[:, dst: dst + nw] = arr[:, src: src + nw]
        if n & 1:
            out[:, dst + nw - 1] &= 0xFFFF  # the odd lane's pad half

    def bits(dst, src):  # bitmap words
        out[:, dst: dst + nh] = arr[:, src: src + nh]
        if n & 31:
            out[:, dst + nh - 1] &= np.int32((1 << (n & 31)) - 1)

    halves(0, 0)
    bits(nw, nwb)
    out[:, nw + nh: nw + nh + 6] = arr[:, nwb + nhb: nwb + nhb + 6]
    if score:
        bits(nw + nh + 6, nwb + nhb + 6)
        halves(nw + nh + 6 + nh, nwb + nhb + 6 + nhb)
    if payload:
        src = arr.shape[1] - 2 * nhb
        bits(words - 2 * nh, src)
        bits(words - nh, src + nhb)
    return out


def _bucket(n: int) -> int:
    return max(8, 1 << (max(int(n), 1) - 1).bit_length())


class ResidentPool:
    """The step contexts, graphs and counters of one classifier.

    ``context`` reads the classifier's generation together with its active
    tables under the classifier's lock, so a context never pairs a token
    with another generation's tables; the pool's own lock guards its cache
    and counters."""

    #: two admissions in flight, each with its own output
    PIPELINE_SLOTS = 2

    def __init__(self, device) -> None:
        self._lock = threading.Lock()
        self._device = torch.device(device)
        self._ctx: Optional[ResidentContext] = None
        self._slot = 0
        self.counters = {
            "allocs": 0, "reuses": 0, "dispatches": 0, "fallbacks": 0,
            "superbatch_dispatches": 0, "superbatch_admissions": 0,
            "slot0_dispatches": 0, "slot1_dispatches": 0,
        }
        #: allocs at mark_warm; steady_allocs() counts from it
        self.warm_allocs: Optional[int] = None

    # -- counters ------------------------------------------------------------------

    def note(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.counters[key] = self.counters.get(key, 0) + n

    def note_alloc(self) -> None:
        self.note("allocs")

    def mark_warm(self) -> None:
        """Freeze the allocation baseline: what is allocated after this
        was allocated by the serving path."""
        with self._lock:
            self.warm_allocs = self.counters["allocs"]

    def steady_allocs(self) -> int:
        with self._lock:
            if self.warm_allocs is None:
                return self.counters["allocs"]
            return self.counters["allocs"] - self.warm_allocs

    def counter_values(self) -> dict:
        """resident_* gauges for /metrics."""
        with self._lock:
            out = {f"resident_{k}_total": v for k, v in self.counters.items()}
            out["resident_pool_warm"] = int(self.warm_allocs is not None)
            out["resident_steady_allocs"] = (
                self.counters["allocs"] - self.warm_allocs if self.warm_allocs is not None else 0)
        return out

    def graphs(self) -> int:
        """Graphs of the current layout (0 on the CPU)."""
        with self._lock:
            return 0 if self._ctx is None else len(self._ctx.graphs)

    # -- the context ---------------------------------------------------------------

    def context(self, clf) -> Optional[ResidentContext]:
        """The current generation's context, or None when the step cannot
        serve it (no tables, wide ruleIds): the caller takes the
        multi-dispatch plan.  On the card a new generation of the old
        context's layout keeps its static tables and graphs; one of another
        layout retires them once their last replays have run."""
        from .layout import check_wire_ruleids

        with clf._lock:
            active = clf._active
            tables = clf._tables
            gen = clf._depth_gen
        if active is None or active.wide_rids:
            return None
        with self._lock:
            ctx = self._ctx
        if ctx is not None and ctx.gen == gen:
            self.note("reuses")
            return ctx
        if active.path == "dense":
            try:
                check_wire_ruleids(tables)
            except ValueError:
                return None
        step_tables = StepTables(active.path, active.dev, active.ov)
        static, graphs = None, {}
        if self._device.type == "cuda":
            if ctx is not None and same_layout(ctx.tables, step_tables):
                static, graphs = ctx.static, ctx.graphs
            else:
                static = _StaticTables(step_tables)
        new = ResidentContext(gen=gen, tables=step_tables, active=active, graphs=graphs,
                              static=static)
        with self._lock:
            cur = self._ctx
            if cur is not None and cur is not ctx and cur.gen == gen:
                new = None  # another thread installed this generation first
            else:
                old, self._ctx = cur, new
        if new is None:
            self.note("reuses")
            return cur
        if old is not None and old.graphs is not graphs:
            for g in list(old.graphs.values()):
                g.event.synchronize()
        self.note_alloc()
        return new

    # -- dispatch ------------------------------------------------------------------

    def dispatch(self, tier, ctx: ResidentContext, n_levels: Optional[int],
                 wire_np: np.ndarray, tflags_np: Optional[np.ndarray], gens_snap,
                 k: int = 0, telemetry=None, mlscore=None, payload=None):
        """Enqueue one step (``k`` = 0, ``wire_np`` (B, W)) or a superbatch
        of ``k`` steps (``wire_np`` (k, B, W)) through the flow tier ->
        (output handle, last epoch).  ``telemetry`` (a TelemetryTier or
        None) adds the sketch update to each step, ``mlscore`` (an
        AnomalyTier or None) the score update, ``payload`` (a PayloadTier,
        the (…, B, L) uint8 column at the tier's width and the (…, B) int32
        lengths, or None) the payload match."""
        tables = ctx.tables._replace(n_levels=n_levels)
        b, width = wire_np.shape[-2], wire_np.shape[-1]
        step = resident_superbatch if k else resident_step
        if self._device.type != "cuda":
            wire = torch.from_numpy(np.ascontiguousarray(wire_np, np.uint32).view(np.int32))
            tflags = (None if tflags_np is None
                      else torch.from_numpy(np.ascontiguousarray(tflags_np, np.int32)))

            def launch(ops):
                return HostOutput(step(ops, tables, wire))

            pay_ops = None
            if payload is not None:
                pay_ops = (payload[0], torch.from_numpy(np.ascontiguousarray(payload[1])),
                           torch.from_numpy(np.ascontiguousarray(payload[2], np.int32)))
            return tier.resident_dispatch(launch, b, wire_np=wire_np, tflags=tflags,
                                          tflags_np=tflags_np, gens_snap=gens_snap,
                                          alloc_note=self.note_alloc, k=k, telemetry=telemetry,
                                          mlscore=mlscore, payload=pay_ops)
        bucket = _bucket(b)
        pay_spec = None if payload is None else payload[0].spec
        with self._lock:
            slot, self._slot = self._slot, self._slot ^ 1
            key = (bucket, width, tflags_np is not None, n_levels, k, telemetry is not None,
                   mlscore is not None, pay_spec, slot)
            g = ctx.graphs.get(key)
            if g is None:
                g = _Graph(k, bucket, width, tflags_np is not None, self._device,
                           score=mlscore is not None,
                           pay_width=0 if pay_spec is None else pay_spec.plen)
                ctx.graphs[key] = g
        with g.lock:
            return self._dispatch_graph(tier, ctx, g, step, n_levels, b, wire_np, tflags_np,
                                        gens_snap, k, telemetry, mlscore, payload)

    def _dispatch_graph(self, tier, ctx: ResidentContext, g: _Graph, step, n_levels, b: int,
                        wire_np, tflags_np, gens_snap, k: int, telemetry, mlscore, payload):
        """dispatch's card half, under ``g``'s lock."""
        g.take_landing()
        g.event.synchronize()  # the pinned input's last copy has run
        g.fill(wire_np, tflags_np, *(payload[1:] if payload is not None else ()))
        if ctx.active.ready is not None:
            event, stream = ctx.active.ready
            current = torch.cuda.current_stream(self._device)
            if current != stream:
                current.wait_event(event)

        def launch(ops):
            tables = ctx.static.sync(ctx.tables)._replace(n_levels=n_levels)
            if g.graph is None:
                self._capture(g, ops, tables, step)
            g.stage.copy_(g.pinned_in, non_blocking=True)
            g.graph.replay()
            for kern, n in g.deltas.items():
                kern.launches += n  # a replay launches the captured kernels
            g.pinned_out.copy_(g.out, non_blocking=True)
            g.event.record()
            g.landing = _Landing(g, b)
            return g.landing

        return tier.resident_dispatch(launch, g.bucket, wire_np=wire_np, tflags=g.tflags(),
                                      tflags_np=tflags_np, gens_snap=gens_snap,
                                      alloc_note=self.note_alloc, k=k, telemetry=telemetry,
                                      mlscore=mlscore,
                                      payload=None if payload is None else (
                                          payload[0], g.pay(), g.plen()))

    def _capture(self, g: _Graph, ops, tables: StepTables, step) -> None:
        """Capture ``step`` on ``g``'s buffers and the tier's operands.  A
        first run on KIND_OTHER rows, with an epoch and an output of its
        own, builds and loads every kernel and fills their launch caches
        (inert rows touch no column; the score update, which advances its
        epoch and clamps on any rows, runs on a state of its own); then the
        capture, whose launch counts are taken back.  The payload stage's
        first run reads an all-zero column of length 0 (never a match)."""
        inert = torch.zeros_like(g.wire())
        inert[..., 0] = KIND_OTHER
        warm_ops = ops._replace(epoch_dev=torch.zeros_like(ops.epoch_dev))
        if ops.payload is not None:
            warm_ops = warm_ops._replace(payload=ops.payload._replace(
                pay=torch.zeros_like(ops.payload.pay), plen=torch.zeros_like(ops.payload.plen)))
        if ops.score is not None:
            st = ops.score.state
            warm_ops = warm_ops._replace(score=ops.score._replace(
                state=type(st)(*(torch.zeros_like(t) for t in st))))
        step(warm_ops, tables, inert, torch.empty_like(g.fused()), g.scratch)
        kernels = all_kernels()
        before = [k.launches for k in kernels]
        graph = torch.cuda.CUDAGraph()
        # thread_local: another thread's allocations (a table load) may run
        # while this one captures
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            step(ops, tables, g.wire(), g.fused(), g.scratch)
        g.baked = (ops, tables)
        g.deltas = {}
        for k, n0 in zip(kernels, before):
            if k.launches != n0:
                g.deltas[k] = k.launches - n0
                k.launches = n0  # captured, not launched
        g.graph = graph
        self.note_alloc()
