"""The payload tier's automaton and match: kernel K11 (the Aho-Corasick walk),
its plain version and the host lowering.

Counterpart of the JAX package's ``infw/kernels/acmatch.py``.  There the
match (``_acmatch_core``) is XLA, no Pallas kernel: a ``lax.scan`` of L
steps, launched alone per admission on the multi-dispatch path
(``jitted_acmatch``) and as a stage of the resident step
(``jaxpath._resident_step_core``), with a one-hot int8 matmul standing in
for the gather on small automata (the TPU has no vector gather).  Here it is
a hand-written CUDA kernel (``csrc/payload_match.cu``) that walks the dense
DFA with one thread a lane; a spec with ``matmul`` set is served by the same
walk (``AcSpec.matmul`` stays in the spec: it is part of the geometry, of
the artifact manifest and of the swap check).

Host side, the JAX package's lowering byte for byte: ``compile_patterns``
builds the goto trie, the BFS failure links, and folds them into

- ``delta``    (S, 256) int32: the next state of (state, byte), failure
  chains walked at compile time;
- ``matchmap`` (S, PW) uint32: the patterns that end at each state, the
  outputs of its failure chain included (PW = padded patterns / 32).

Device side (``AcDev``, int32 tensors, ``matchmap`` as the u32 bit
patterns; rewritten in place on a swap, so a CUDA graph keeps their
addresses):

- ``acmatch`` (K11, classic entry): (B, L' >= L) uint8 payload prefixes and
  (B,) int32 valid lengths -> (B, PW) int32 match bitmaps;
- ``acmatch_resident`` (K11, resident entry, a stage of the resident step
  between K10 and K8): the merge ``where(hit, served, res16)`` from the
  probe's words, the walk, the policy (``payload_merge_plain``), the
  policy's verdicts written into both the probe's and the stateless words,
  and the matched-lane and rewritten-lane bitmaps into the step's output.

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

KERNEL = _build.Kernel(
    "payload_match", "infw_acmatch",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
RESIDENT_KERNEL = _build.Kernel(
    "payload_match_resident", "infw_acmatch_resident",
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p], source="payload_match")


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


class AcDev(NamedTuple):
    """A compiled automaton on a device (int32; ``matchmap`` holds the u32
    bit patterns)."""

    delta: torch.Tensor     # (S, 256)
    matchmap: torch.Tensor  # (S, PW)


def model_device(model: AcModel, device) -> AcDev:
    """The device operands of ``model`` (every spec, matmul included)."""
    return AcDev(torch.from_numpy(np.ascontiguousarray(model.delta, np.int32)).to(device),
                 torch.from_numpy(np.ascontiguousarray(model.matchmap, np.uint32)
                                  .view(np.int32)).to(device))


def model_copy_(dev: AcDev, model: AcModel) -> None:
    """Rewrite ``dev`` in place with ``model``'s values (same spec), on the
    current stream."""
    dev.delta.copy_(torch.from_numpy(np.ascontiguousarray(model.delta, np.int32)))
    dev.matchmap.copy_(torch.from_numpy(
        np.ascontiguousarray(model.matchmap, np.uint32).view(np.int32)))


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
    for name, t, shape in (("delta", dev.delta, (S, 256)), ("matchmap", dev.matchmap, (S, PW)),
                           ("plen", plen, (B,))):
        if t.device != d or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous int32 on {d}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{who}: {name} {tuple(t.shape)}, expected {shape}")
    if dev.matchmap.data_ptr() % 16:
        raise ValueError(f"{who}: matchmap must be 16-byte aligned")
    if S * 256 >= 1 << 31:
        raise ValueError(f"{who}: {S} states, at most 2^23 - 1 on the card")


def _on(wire_like: torch.Tensor, fn) -> None:
    """``fn()`` with ``wire_like``'s device current."""
    idx = wire_like.device.index
    if idx is None or idx == torch.cuda.current_device():
        fn()
    else:
        with torch.cuda.device(wire_like.device):
            fn()


def acmatch(dev: AcDev, pay: torch.Tensor, plen: torch.Tensor, spec: AcSpec) -> torch.Tensor:
    """Kernel K11, classic entry -> (B, PW) int32 match bitmaps.  A CPU
    tensor runs ``acmatch_plain``; a CUDA tensor launches K11 (building it on
    first use) or raises."""
    if pay.device.type == "cpu":
        return acmatch_plain(dev, pay, plen, spec)
    if pay.device.type != "cuda":
        raise ValueError(f"acmatch: unsupported device {pay.device}")
    _check("acmatch", dev, spec, pay, plen)
    B = pay.shape[0]
    out = torch.empty((B, spec.pwords), dtype=torch.int32, device=pay.device)
    if B:
        _on(pay, lambda: KERNEL.launch(
            dev.delta.data_ptr(), dev.matchmap.data_ptr(), pay.data_ptr(), plen.data_ptr(),
            out.data_ptr(), B, spec.plen, pay.shape[1], spec.states, spec.pwords,
            torch.cuda.current_stream().cuda_stream))
    return out


def acmatch_resident(ops: PayloadOps, wire: torch.Tensor, served: torch.Tensor,
                     hit: torch.Tensor, res16: torch.Tensor, out: torch.Tensor) -> None:
    """Kernel K11, resident entry (a stage of kernels/resident.py's step,
    between K10 and K8): ``served`` the probe's ceil(B/2) packed res16
    words, ``hit`` its ceil(B/32) bitmap words, ``res16`` the stateless
    words (K10's output where scoring is on); the lane's verdict is ``hit ?
    served : res16``.  Walks ``ops.pay`` / ``ops.plen``, applies the policy
    with ``ops.pmode``, writes the policy's verdicts into both ``served``
    and ``res16`` (the odd lane's pad half 0) and into ``out`` the matched
    and the rewritten lanes' bitmaps (ceil(B/32) words each).  A CPU tensor
    runs the plain version; a CUDA tensor launches K11 or raises."""
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
    _on(wire, lambda: RESIDENT_KERNEL.launch(
        ops.dev.delta.data_ptr(), ops.dev.matchmap.data_ptr(), ops.pay.data_ptr(),
        ops.plen.data_ptr(), ops.pmode.data_ptr(), wire.data_ptr(), served.data_ptr(),
        hit.data_ptr(), res16.data_ptr(), out.data_ptr(), B, wire.shape[1], ops.spec.plen,
        ops.pay.shape[1], ops.spec.states, ops.spec.pwords,
        torch.cuda.current_stream().cuda_stream))
