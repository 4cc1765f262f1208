"""The payload tier's automaton and match: kernel K11 (the Aho-Corasick walk),
its plain version and the host lowering.

Counterpart of the JAX package's ``infw/kernels/acmatch.py``.  There the
match (``_acmatch_core``) is XLA, no Pallas kernel: a ``lax.scan`` of L
steps, launched alone per admission on the multi-dispatch path
(``jitted_acmatch``) and as a stage of the resident step
(``jaxpath._resident_step_core``), with a one-hot int8 matmul standing in
for the gather on small automata (the TPU has no vector gather).  Here it is
a hand-written CUDA kernel (``csrc/payload_match.cu``) that walks a kernel
layout of the DFA (below) with one thread a lane and the hot rows in shared
memory; a spec with ``matmul`` set is served by the same walk
(``AcSpec.matmul`` stays in the spec: it is part of the geometry, of the
artifact manifest and of the swap check).

Host side, the JAX package's lowering byte for byte: ``compile_patterns``
builds the goto trie, the BFS failure links, and folds them into

- ``delta``    (S, 256) int32: the next state of (state, byte), failure
  chains walked at compile time;
- ``matchmap`` (S, PW) uint32: the patterns that end at each state, the
  outputs of its failure chain included (PW = padded patterns / 32).

``kernel_layout`` derives what K11 reads from those two, purely: the states
renumbered breadth-first from the root (pi(0) = 0, the reachable states by
depth then id, the unreachable after them by id), so the shallow rows that
take almost every step are one prefix of the table;

- ``next``  (S, 256) u16 (u32 above 32768 states), rows in the new order:
  the entry of (pi(s), b) is pi(clip(delta[s, b])) in bits 0-14 (0-30), and
  bit 15 (31) is set iff that target's matchmap row is non-zero, so XLA's
  clip is folded into the table and a step needs no matchmap read to know
  whether it reports;
- ``mrows`` (S, PW) u32: the matchmap rows in the new order;
- ``head``  (1,) int32: the number of reachable states, the rows worth
  staging: what changes between two pattern sets of one spec (a CUDA graph
  bakes the launch's arguments, so a swap changes only tensors).

Device side (``AcDev``: ``delta`` and ``matchmap`` in the JAX layout, which
the conversions, the swap check and the tests read, then the kernel layout;
all rewritten in place on a swap, so a CUDA graph keeps their addresses):

- ``acmatch`` (K11, classic entry): (B, L' >= L) uint8 payload prefixes and
  (B,) int32 valid lengths -> (B, PW) int32 match bitmaps;
- ``acmatch_resident`` (K11, resident entry, a stage of the resident step
  between K10 and K8): the merge ``where(hit, served, res16)`` from the
  probe's words, the walk, the policy (``payload_merge_plain``), the
  policy's verdicts written into both the probe's and the stateless words,
  and the matched-lane and rewritten-lane bitmaps into the step's output.

K11 runs on one of two plans that ``plan_for`` picks per call from B
(``PLANS``), a grid of at most one block an SM, lanes strided: plan "S"
takes up to 256 lanes a block, one a thread, and stages every reachable row
of ``next`` that fits into each block's shared memory; plan "L" spreads the
lanes over every SM, two a thread walked in step, and stages none, its
blocks' shared memory left to the L1 cache, which holds the hot rows
itself.

Semantics (``_acmatch_core``): position p of lane i is active iff p <
plen[i] (plen <= 0: no byte; plen > L: all L bytes; bytes past L in a wider
column are ignored); an active byte moves the state to ``delta[clip(state),
byte]`` and ORs ``matchmap[clip(state)]`` into the lane's bitmap; so an
occurrence that crosses min(plen, L) claims nothing.  On a CPU tensor the
wrappers run the plain versions; on a CUDA tensor they launch K11 or raise.
"""
from __future__ import annotations

import ctypes
from collections import deque
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..constants import DENY
from . import _build
from .flow import pack_bits32, unpack_bits32, unpack_res16
from .mxu_score import _failsafe_lane_mask, failsafe_lane_mask_np
from .torchpath import _pack_res16

#: the verdict an enforce rewrite installs: Deny with ruleId 0
PAYLOAD_DENY_RESULT = DENY

#: automata of at most this many padded states default to the matmul spec
#: (the JAX package's TPU choice; here the same walk serves both)
MATMUL_MAX_STATES = 128

#: words of the kernel layout's ``head``: the number of reachable states
HEAD_WORDS = 1
#: the most states whose ``next`` entries are 16-bit (a state id in 15 bits)
NEXT16_MAX_STATES = 1 << 15
#: the most threads (lanes walked at once) a block of K11 runs
MAX_THREADS = 1024
#: shared memory a plan S block keeps beside its staged rows: the classic
#: entry's slots, 4 reporting states of 4 bytes for each of up to MAX_THREADS
#: lanes
SLOT_BYTES = 4 * 4 * MAX_THREADS

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = _build.Kernel("payload_match", "infw_acmatch", [_P] * 6 + [_I] * 9 + [_P])
RESIDENT_KERNEL = _build.Kernel("payload_match_resident", "infw_acmatch_resident",
                                [_P] * 11 + [_I] * 10 + [_P], source="payload_match")
#: set-up and queries (launch nothing): 0 -> the opt-in shared memory a block
#: may use, after raising every K11 kernel's cap to it; 1 -> the SM clock, kHz
QUERY = _build.Kernel("payload_query", "infw_acmatch_query", [_I], source="payload_match")
#: the chain floor (a measurement, on no serving path): one warp's L
#: dependent shared-memory loads, timed in SM cycles on the card
CHAIN_KERNEL = _build.Kernel("payload_chain_floor", "infw_acmatch_chain_floor",
                             [_P, _I, _P], source="payload_match")


class AcSpec(NamedTuple):
    """The padded geometry of a compiled automaton (pow2 buckets), so pattern
    sets in the same buckets swap without a new capture."""

    states: int    # padded DFA states (pow2, >= 64)
    patterns: int  # padded pattern capacity (pow2, >= 32)
    plen: int      # payload prefix length matched (64 or 128)
    matmul: bool   # the JAX package's one-hot matmul transition path

    @property
    def pwords(self) -> int:
        return self.patterns // 32

    @classmethod
    def make(cls, states: int, patterns: int, plen: int = 64,
             matmul: Optional[bool] = None) -> "AcSpec":
        if plen not in (64, 128):
            raise ValueError(f"plen must be 64 or 128, got {plen}")
        s = 64
        while s < states:
            s *= 2
        p = 32
        while p < patterns:
            p *= 2
        if matmul is None:
            matmul = s <= MATMUL_MAX_STATES
        return cls(states=s, patterns=p, plen=plen, matmul=bool(matmul))


class AcModel(NamedTuple):
    """A compiled pattern set (host arrays)."""

    spec: AcSpec
    delta: np.ndarray     # (S, 256) int32
    matchmap: np.ndarray  # (S, PW) uint32
    patterns: Tuple[bytes, ...]


def validate_patterns(patterns: Sequence[bytes], plen: int) -> None:
    """Non-empty, distinct byte strings of at most ``plen`` bytes (a longer
    one could never end within the matched prefix)."""
    if not patterns:
        raise ValueError("empty pattern set")
    seen = set()
    for i, p in enumerate(patterns):
        if not isinstance(p, (bytes, bytearray)):
            raise ValueError(f"pattern {i} is not bytes: {type(p)!r}")
        if len(p) == 0:
            raise ValueError(f"pattern {i} is empty")
        if len(p) > plen:
            raise ValueError(
                f"pattern {i} ({len(p)} bytes) exceeds the {plen}-byte "
                "matched prefix and could never fire"
            )
        if bytes(p) in seen:
            raise ValueError(f"duplicate pattern at index {i}")
        seen.add(bytes(p))


def compile_patterns(patterns: Sequence[bytes], plen: int = 64,
                     matmul: Optional[bool] = None,
                     spec: Optional[AcSpec] = None) -> AcModel:
    """Trie -> BFS failure links -> the dense DFA with the links folded out.
    With ``spec`` the result is padded into that geometry (a swap into an
    existing tier), which must hold it."""
    patterns = tuple(bytes(p) for p in patterns)
    validate_patterns(patterns, plen)
    goto: List[dict] = [{}]
    out_state: List[int] = []
    for p in patterns:
        s = 0
        for c in p:
            nxt = goto[s].get(c)
            if nxt is None:
                goto.append({})
                nxt = len(goto) - 1
                goto[s][c] = nxt
            s = nxt
        out_state.append(s)
    n_states = len(goto)
    if spec is None:
        spec = AcSpec.make(n_states, len(patterns), plen, matmul)
    else:
        if n_states > spec.states:
            raise ValueError(
                f"pattern set needs {n_states} states, spec bucket is "
                f"{spec.states} (hot-swap would recompile; re-spec)"
            )
        if len(patterns) > spec.patterns:
            raise ValueError(f"{len(patterns)} patterns exceed the spec bucket {spec.patterns}")
        if plen != spec.plen:
            raise ValueError(f"plen {plen} != spec.plen {spec.plen}")
    S, PW = spec.states, spec.pwords
    delta = np.zeros((S, 256), np.int32)
    matchmap = np.zeros((S, PW), np.uint32)
    for j, s in enumerate(out_state):
        matchmap[s, j // 32] |= np.uint32(1 << (j % 32))
    # BFS: a visited state's delta row is already dense, so a missing goto
    # edge resolves through one read of its failure state's row
    fail = np.zeros(n_states, np.int32)
    queue = deque()
    for c, t in goto[0].items():
        delta[0, c] = t
        queue.append(t)
    while queue:
        s = queue.popleft()
        f = int(fail[s])  # a shallower state: its row is final
        matchmap[s] |= matchmap[f]  # the failure chain's outputs
        delta[s] = delta[f]
        for c, t in sorted(goto[s].items()):  # byte order, as a scan of 0..255
            fail[t] = delta[f, c]
            delta[s, c] = t
            queue.append(t)
    # padded states stay all-zero rows: unreachable, and inert
    return AcModel(spec=spec, delta=delta, matchmap=matchmap, patterns=patterns)


# --- the kernel layout ------------------------------------------------------------


class AcLayout(NamedTuple):
    """What K11 reads, derived from ``(delta, matchmap)`` by
    ``kernel_layout`` (host arrays; see the module docstring)."""

    perm: np.ndarray   # (S,) int64: pi, a state's id -> its kernel id
    depth: np.ndarray  # (S,) int32: BFS depth by kernel id, -1 unreachable
    next: np.ndarray   # (S, 256) uint16 (uint32 above NEXT16_MAX_STATES states)
    mrows: np.ndarray  # (S, PW) uint32
    head: np.ndarray   # (HEAD_WORDS,) int32: the reachable states


def bfs_depth(delta: np.ndarray) -> np.ndarray:
    """(S,) int32: each state's breadth-first depth from the root over the
    clipped ``delta`` edges, -1 where unreachable."""
    S = delta.shape[0]
    targets = np.clip(np.asarray(delta, np.int64), 0, S - 1)
    depth = np.full(S, -1, np.int32)
    depth[0] = 0
    frontier, d = np.zeros(1, np.int64), 0
    while frontier.size:
        reached = np.unique(targets[frontier])
        frontier = reached[depth[reached] < 0]
        d += 1
        depth[frontier] = d
    return depth


def kernel_layout(delta: np.ndarray, matchmap: np.ndarray) -> AcLayout:
    """K11's layout of a dense DFA: the states renumbered breadth-first
    (pi(0) = 0; reachable by depth then id; unreachable after, by id), the
    next-state table in the new order with the clip folded in and an output
    flag in each entry, the matchmap rows in the new order, and the header.
    Pure and deterministic."""
    S = delta.shape[0]
    depth = bfs_depth(delta)
    key = np.where(depth >= 0, depth, np.iinfo(np.int32).max)
    order = np.argsort(key, kind="stable")  # kernel id -> state id
    perm = np.empty(S, np.int64)
    perm[order] = np.arange(S)
    matchmap = np.asarray(matchmap, np.uint32)
    flag = matchmap.any(axis=1)
    targets = np.clip(np.asarray(delta, np.int64), 0, S - 1)[order]
    wide = S > NEXT16_MAX_STATES
    entry = perm[targets] | (flag[targets].astype(np.int64) << (31 if wide else 15))
    nxt = entry.astype(np.uint32 if wide else np.uint16)
    head = np.asarray([int((depth >= 0).sum())], np.int32)
    return AcLayout(perm, depth[order], np.ascontiguousarray(nxt),
                    np.ascontiguousarray(matchmap[order]), head)


class AcDev(NamedTuple):
    """A compiled automaton on a device: the JAX layout (int32;
    ``matchmap`` holds the u32 bit patterns), then K11's layout (``next``
    int16 or int32 holding the u16 / u32 entries, ``mrows`` the u32 bit
    patterns, ``head`` int32)."""

    delta: torch.Tensor     # (S, 256)
    matchmap: torch.Tensor  # (S, PW)
    next: Optional[torch.Tensor] = None   # (S, 256)
    mrows: Optional[torch.Tensor] = None  # (S, PW)
    head: Optional[torch.Tensor] = None   # (HEAD_WORDS,)


def _host_tensors(model: AcModel) -> tuple:
    lay = kernel_layout(model.delta, model.matchmap)
    nxt = lay.next.view(np.int16 if lay.next.dtype == np.uint16 else np.int32)
    arrays = (np.ascontiguousarray(model.delta, np.int32),
              np.ascontiguousarray(model.matchmap, np.uint32).view(np.int32),
              nxt, lay.mrows.view(np.int32), lay.head)
    return tuple(torch.from_numpy(a) for a in arrays)


def model_device(model: AcModel, device) -> AcDev:
    """The device operands of ``model`` (every spec, matmul included): new
    tensors on every device, so a later ``model_copy_`` never writes into
    ``model``'s arrays."""
    return AcDev(*(t.to(device, copy=True) for t in _host_tensors(model)))


def model_copy_(dev: AcDev, model: AcModel) -> None:
    """Rewrite ``dev`` in place with ``model``'s values and layout (same
    spec), on the current stream."""
    for t, src in zip(dev, _host_tensors(model)):
        t.copy_(src)


class PayloadOps(NamedTuple):
    """What the resident step's payload stage reads: the automaton, the (1,)
    int32 mode (0 shadow, 1 enforce), the spec, and the admission's (B, L')
    uint8 payload column and (B,) int32 lengths ((K, B, L') and (K, B) in a
    superbatch)."""

    dev: AcDev
    pmode: torch.Tensor
    spec: AcSpec
    pay: Optional[torch.Tensor] = None
    plen: Optional[torch.Tensor] = None


# --- the plain versions ------------------------------------------------------------


def acmatch_plain(dev: AcDev, pay: torch.Tensor, plen: torch.Tensor,
                  spec: AcSpec) -> torch.Tensor:
    """``_acmatch_core`` in plain PyTorch (on any device) -> (B, PW) int32
    bitmaps: L steps of ``delta.view(-1)[clip(state) * 256 + byte]``, each
    advancing only where ``pos < plen`` and OR-ing ``matchmap[clip(state)]``."""
    S, PW, L = spec.states, spec.pwords, spec.plen
    B = pay.shape[0]
    flat = dev.delta.reshape(-1)
    data = pay[:, :L].to(torch.int64)  # bytes 0..255
    n = plen.to(torch.int64)
    state = torch.zeros(B, dtype=torch.int64, device=pay.device)
    matches = torch.zeros((B, PW), dtype=torch.int32, device=pay.device)
    for p in range(L):
        active = n > p
        nxt = flat[state.clamp(0, S - 1) * 256 + data[:, p]].to(torch.int64)
        state = torch.where(active, nxt, state)
        m = dev.matchmap[state.clamp(0, S - 1)]
        matches |= torch.where(active[:, None], m, torch.zeros_like(m))
    return matches


def layout_walk_plain(dev: AcDev, pay: torch.Tensor, plen: torch.Tensor,
                      spec: AcSpec) -> Tuple[torch.Tensor, torch.Tensor]:
    """K11's walk over the kernel layout in plain PyTorch (on any device) ->
    ((B, PW) int32 bitmaps, (B,) bool any-bit): from kernel id 0, each
    active byte moves to the entry's state; a set flag ORs the landed
    state's ``mrows`` row (the classic entry) and sets the any-bit (the
    resident entry).  Equal to ``acmatch_plain`` wherever the layout is
    right."""
    PW, L = spec.pwords, spec.plen
    shift = 15 if entry_bytes(spec) == 2 else 31
    B = pay.shape[0]
    table = dev.next.reshape(-1).to(torch.int64) & ((1 << (shift + 1)) - 1)
    data = pay[:, :L].to(torch.int64)
    n = plen.to(torch.int64)
    state = torch.zeros(B, dtype=torch.int64, device=pay.device)
    matches = torch.zeros((B, PW), dtype=torch.int32, device=pay.device)
    hit = torch.zeros(B, dtype=torch.bool, device=pay.device)
    for p in range(L):
        active = n > p
        e = table[state * 256 + data[:, p]]
        state = torch.where(active, e & ((1 << shift) - 1), state)
        flag = active & ((e >> shift) != 0)
        m = dev.mrows[state]
        matches |= torch.where(flag[:, None], m, torch.zeros_like(m))
        hit |= flag
    return matches, hit


def payload_merge_plain(res: torch.Tensor, bitmap: torch.Tensor, pmode: torch.Tensor,
                        proto: torch.Tensor, dst_port: torch.Tensor):
    """``_payload_merge_core``: any match -> the Deny rewrite in enforce mode,
    never on a failsafe lane or an existing rule Deny -> (res' int64, hit,
    rewrite)."""
    res = res.to(torch.int64) & 0xFFFFFFFF
    hit = (bitmap != 0).any(dim=1)
    enf = pmode[0] != 0
    fs = _failsafe_lane_mask(proto, dst_port)
    rewrite = hit & enf & ~fs & ((res & 0xFF) != DENY)
    return torch.where(rewrite, torch.full_like(res, PAYLOAD_DENY_RESULT), res), hit, rewrite


def _wire_proto_port(wire: torch.Tensor):
    """proto and dst_port of a (B, 4 | 7) wire (the full layout's w0, w1)."""
    w0 = wire[:, 0].to(torch.int64) & 0xFFFFFFFF
    w1 = wire[:, 1].to(torch.int64) & 0xFFFFFFFF
    return (w0 >> 3) & 0xFF, w1 & 0xFFFF


def acmatch_resident_plain(ops: PayloadOps, wire, served, hit, res16, out) -> None:
    """The resident entry in plain PyTorch (on any device): the merge, the
    walk, the policy, and the words it writes (acmatch_resident)."""
    B = wire.shape[0]
    nw, nh = (B + 1) // 2, -(-B // 32)
    merged = torch.where(unpack_bits32(hit[:nh], B), unpack_res16(served[:nw], B),
                         unpack_res16(res16[:nw], B))
    bitmap = acmatch_plain(ops.dev, ops.pay, ops.plen, ops.spec)
    proto, dport = _wire_proto_port(wire)
    merged3, phit, rw = payload_merge_plain(merged, bitmap, ops.pmode, proto, dport)
    words = _pack_res16(merged3)
    served[:nw].copy_(words)
    res16[:nw].copy_(words)
    out[:nh].copy_(pack_bits32(phit))
    out[nh: 2 * nh].copy_(pack_bits32(rw))


# --- host references ---------------------------------------------------------------


def host_match_bitmap(model: AcModel, pay: np.ndarray, plen: np.ndarray) -> np.ndarray:
    """The construction-independent reference (oracle.payload_match_ref: a
    naive substring scan, not a walk of the compiled DFA)."""
    from ..oracle import payload_match_ref

    return payload_match_ref(model.patterns, pay, plen, model.spec.plen, model.spec.pwords)


def host_payload_rewrite(model: AcModel, res: np.ndarray, bitmap: np.ndarray, enforce: bool,
                         proto: np.ndarray, dst_port: np.ndarray) -> np.ndarray:
    """``_payload_merge_core`` in numpy, for the multi-dispatch follow-on."""
    res = np.asarray(res, np.uint32)
    if not enforce:
        return res
    hit = (np.asarray(bitmap) != 0).any(axis=1)
    fs = failsafe_lane_mask_np(proto, dst_port)
    rewrite = hit & ~fs & ((res & np.uint32(0xFF)).astype(np.int32) != DENY)
    return np.where(rewrite, np.uint32(PAYLOAD_DENY_RESULT), res)


# --- K11 -------------------------------------------------------------------------

#: K11's plans: (the C entry's code, lanes a block short of a full grid,
#: lanes a thread, whether blocks stage rows); measured on the card with
#: infw_torch/tools/payload_plans.py
PLANS = {"S": (0, 256, 1, True), "L": (1, 64, 2, False)}
#: plan_for's crossover: plan "S" up to this many lanes
STAGED_PLAN_MAX_LANES = 1 << 17


class LaunchPlan(NamedTuple):
    """One K11 launch's shape (every field by value in a captured graph;
    none depends on the pattern set): blocks, threads a block, and the rows
    a block's shared memory holds (a block stages min(rows, head[0]))."""

    name: str
    grid: int
    threads: int
    rows: int


def entry_bytes(spec: AcSpec) -> int:
    """Bytes of one ``next`` entry: 2, or 4 above NEXT16_MAX_STATES states."""
    return 2 if spec.states <= NEXT16_MAX_STATES else 4


def row_cap(spec: AcSpec, smem_limit: int) -> int:
    """The most ``next`` rows one block's shared memory holds beside the
    slots."""
    return min(spec.states, (smem_limit - SLOT_BYTES) // (256 * entry_bytes(spec)))


def plan_for(b: int) -> str:
    """K11's plan for a call of ``b`` lanes: "S" up to the measured
    crossover, else "L"."""
    return "S" if b <= STAGED_PLAN_MAX_LANES else "L"


def launch_plan(name: str, b: int, spec: AcSpec, smem_limit: int, sms: int,
                rows: Optional[int] = None) -> LaunchPlan:
    """The launch shape of plan ``name`` at ``b`` >= 1 lanes on a card of
    ``sms`` SMs whose blocks may opt in to ``smem_limit`` bytes: the fewest
    blocks (at most ``sms``) that keep a block at or under the plan's lanes,
    threads a multiple of 32 (a warp takes 32 consecutive lanes at a time
    from a multiple of 32), the rows the plan stages; ``rows`` overrides
    plan S's (tests: 1 puts almost every step on the global path)."""
    if name not in PLANS:
        raise ValueError(f"K11: plan {name!r}, expected one of {sorted(PLANS)}")
    _, per_block, lanes, staged = PLANS[name]
    grid = max(1, min(sms, -(-b // per_block)))
    threads = min(MAX_THREADS, (-(-b // (grid * lanes)) + 31) // 32 * 32)
    cap = row_cap(spec, smem_limit) if staged else 0
    if rows is None:
        rows = cap
    elif not 0 <= rows <= cap:
        raise ValueError(f"K11: rows {rows}, plan {name}'s blocks hold 0 to {cap}")
    return LaunchPlan(name, grid, threads, int(rows))


_CARD: dict = {}


def card_limits(device: torch.device) -> Tuple[int, int]:
    """(the opt-in shared memory a block may use, SMs) of ``device``, a
    CUDA device; the first call on a device also raises every K11 kernel's
    shared-memory cap there (outside any graph capture: each graph the port
    captures runs once eagerly first)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _CARD:
        with torch.cuda.device(index):
            got = QUERY.query(0)
        if got <= 0:
            raise RuntimeError(f"payload_match: the set-up on cuda:{index} failed with error "
                               f"{-got}")
        _CARD[index] = (got, torch.cuda.get_device_properties(index).multi_processor_count)
    return _CARD[index]


def _check(who: str, dev: AcDev, spec: AcSpec, pay, plen) -> None:
    d = pay.device
    S, PW = spec.states, spec.pwords
    if pay.dim() != 2 or pay.dtype != torch.uint8 or not pay.is_contiguous():
        raise ValueError(f"{who}: pay must be a contiguous (B, L) uint8 tensor")
    B = pay.shape[0]
    if pay.shape[1] < spec.plen:
        raise ValueError(f"{who}: pay has {pay.shape[1]} bytes a row, the spec matches "
                         f"{spec.plen}")
    if B >= 1 << 30:
        raise ValueError(f"{who}: {B} lanes, at most 2^30 - 1")
    if dev.next is None or dev.mrows is None or dev.head is None:
        raise ValueError(f"{who}: the automaton has no kernel layout (model_device builds it)")
    ntype = torch.int16 if entry_bytes(spec) == 2 else torch.int32
    for name, t, shape, dtype in (
            ("delta", dev.delta, (S, 256), torch.int32),
            ("matchmap", dev.matchmap, (S, PW), torch.int32),
            ("next", dev.next, (S, 256), ntype), ("mrows", dev.mrows, (S, PW), torch.int32),
            ("head", dev.head, (HEAD_WORDS,), torch.int32), ("plen", plen, (B,), torch.int32)):
        if t.device != d or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous {dtype} on {d}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{who}: {name} {tuple(t.shape)}, expected {shape}")
    if dev.next.data_ptr() % 16 or dev.mrows.data_ptr() % 16:
        raise ValueError(f"{who}: next and mrows must be 16-byte aligned")
    if S * 256 >= 1 << 31:
        raise ValueError(f"{who}: {S} states, at most 2^23 - 1 on the card")


def _plan(b: int, spec: AcSpec, device, plan: Optional[str],
          rows: Optional[int]) -> LaunchPlan:
    limit, sms = card_limits(device)
    return launch_plan(plan or plan_for(b), b, spec, limit, sms, rows)


def _shape_args(lp: LaunchPlan, spec: AcSpec, pay: torch.Tensor) -> tuple:
    return (spec.plen, pay.shape[1], spec.states, spec.pwords, PLANS[lp.name][0], lp.grid,
            lp.threads, lp.rows)


def _on(wire_like: torch.Tensor, fn) -> None:
    """``fn()`` with ``wire_like``'s device current."""
    idx = wire_like.device.index
    if idx is None or idx == torch.cuda.current_device():
        fn()
    else:
        with torch.cuda.device(wire_like.device):
            fn()


def acmatch(dev: AcDev, pay: torch.Tensor, plen: torch.Tensor, spec: AcSpec,
            plan: Optional[str] = None, rows: Optional[int] = None) -> torch.Tensor:
    """Kernel K11, classic entry -> (B, PW) int32 match bitmaps.  A CPU
    tensor runs ``acmatch_plain``; a CUDA tensor launches K11 (building it on
    first use) on ``plan`` (default ``plan_for``'s; ``rows`` caps the staged
    rows) or raises."""
    if pay.device.type == "cpu":
        return acmatch_plain(dev, pay, plen, spec)
    if pay.device.type != "cuda":
        raise ValueError(f"acmatch: unsupported device {pay.device}")
    _check("acmatch", dev, spec, pay, plen)
    B = pay.shape[0]
    out = torch.empty((B, spec.pwords), dtype=torch.int32, device=pay.device)
    if B:
        lp = _plan(B, spec, pay.device, plan, rows)
        _on(pay, lambda: KERNEL.launch(
            dev.next.data_ptr(), dev.mrows.data_ptr(), dev.head.data_ptr(), pay.data_ptr(),
            plen.data_ptr(), out.data_ptr(), B, *_shape_args(lp, spec, pay),
            torch.cuda.current_stream().cuda_stream))
    return out


def acmatch_resident(ops: PayloadOps, wire: torch.Tensor, served: torch.Tensor,
                     hit: torch.Tensor, res16: torch.Tensor, out: torch.Tensor,
                     plan: Optional[str] = None, rows: Optional[int] = None) -> None:
    """Kernel K11, resident entry (a stage of kernels/resident.py's step,
    between K10 and K8): ``served`` the probe's ceil(B/2) packed res16
    words, ``hit`` its ceil(B/32) bitmap words, ``res16`` the stateless
    words (K10's output where scoring is on); the lane's verdict is ``hit ?
    served : res16``.  Walks ``ops.pay`` / ``ops.plen``, applies the policy
    with ``ops.pmode``, writes the policy's verdicts into both ``served``
    and ``res16`` (the odd lane's pad half 0) and into ``out`` the matched
    and the rewritten lanes' bitmaps (ceil(B/32) words each).  A CPU tensor
    runs the plain version; a CUDA tensor launches K11 (``plan`` and
    ``rows`` as ``acmatch``'s) or raises."""
    B = wire.shape[0]
    nw, nh = (B + 1) // 2, -(-B // 32)
    if wire.device.type == "cpu":
        acmatch_resident_plain(ops, wire, served, hit, res16, out)
        return
    if wire.device.type != "cuda":
        raise ValueError(f"acmatch_resident: unsupported device {wire.device}")
    who = "acmatch_resident"
    _check(who, ops.dev, ops.spec, ops.pay, ops.plen)
    if wire.dim() != 2 or wire.shape[1] not in (4, 7) or wire.shape[0] != ops.pay.shape[0]:
        raise ValueError(f"{who}: wire {tuple(wire.shape)}, expected ({ops.pay.shape[0]}, 4 | 7)")
    for name, t, words in (("wire", wire, B * wire.shape[1]), ("pmode", ops.pmode, 1),
                           ("served", served, nw), ("hit", hit, nh), ("res16", res16, nw),
                           ("out", out, 2 * nh)):
        if (t.device != wire.device or t.dtype != torch.int32 or not t.is_contiguous()
                or t.numel() < words):
            raise ValueError(f"{who}: {name} must be contiguous int32 on {wire.device}, "
                             f"at least {words} words")
    if B == 0:
        return
    lp = _plan(B, ops.spec, wire.device, plan, rows)
    d = ops.dev
    _on(wire, lambda: RESIDENT_KERNEL.launch(
        d.next.data_ptr(), d.mrows.data_ptr(), d.head.data_ptr(), ops.pay.data_ptr(),
        ops.plen.data_ptr(), ops.pmode.data_ptr(), wire.data_ptr(), served.data_ptr(),
        hit.data_ptr(), res16.data_ptr(), out.data_ptr(), B, wire.shape[1],
        *_shape_args(lp, ops.spec, ops.pay), torch.cuda.current_stream().cuda_stream))


def chain_floor(steps: int, device) -> dict:
    """The chain floor on ``device`` (a CUDA device): one warp's ``steps``
    dependent shared-memory loads, a pure pointer chase and then the walk's
    own step (index from a byte, a 16-bit load, the state masked out), each
    timed by the SM's cycle counter -> {"chase_cycles", "step_cycles",
    "clock_khz"} (the cycles the slowest lane took; ``clock_khz`` the SM
    clock the card reports).  A measurement, on no serving path."""
    out = torch.zeros(4 * 32, dtype=torch.int64, device=device)
    _on(out, lambda: CHAIN_KERNEL.launch(out.data_ptr(), int(steps),
                                         torch.cuda.current_stream().cuda_stream))
    got = out.view(4, 32).cpu()
    return {"chase_cycles": int(got[0].max()), "step_cycles": int(got[2].max()),
            "clock_khz": QUERY.query(1)}
