"""The anomaly-scoring tier's device state, model and update: kernel K10
(the score update), its plain version and the bit-exact host model.

Counterpart of the JAX package's ``infw/kernels/mxu_score.py``.  There the
update (``_score_update_core``) is XLA, no Pallas kernel: a standalone
launch per admission on the multi-dispatch path (``jitted_score_update``)
and one stage of the resident step (``jaxpath._resident_step_core``), with
the forest lowered to a one-hot int8 matmul (the TPU's stand-in for a
gather).  Here it is a hand-written CUDA kernel (``csrc/score_update.cu``):
the forest is a direct gather of one leaf per tree and the MLP head a
per-lane dot product with its weights in shared memory.

State (``ScoreState``, int32 tensors on one device, updated in place so a
CUDA graph of the resident step keeps their addresses):

- ``skeys`` (S, 6) u32 words / ``scols`` (S, 8): the per-source feature
  table, ways-way set-associative on (tenant, src ip, kind), columns
  [pkts, syns, denies, newports, lastport, lastepoch, anomhits, rsvd];
- ``cms`` (D, W): count-min rows over the same key; an add wraps in int32,
  then the whole array is clamped at ``sat``;
- ``tstat`` (T, 4): per-tenant window counters [scored, anomalous,
  enforced, max score];
- ``epoch`` (1,): the admission counter, advanced on the device.

The model's values (``ScoreModelDev``) and the per-tenant policy rows
``tparams`` (T, 2) [threshold, enforce] are tensors too, rewritten in place
on a swap, so no graph is captured again.

- ``score_update`` (K10, classic entry): (B, 4 | 7) wire, (B,) tenant,
  flags and u32 results in; returns the (3, B) int32 [score, anom, res']
  buffer (``split_score_outputs``);
- ``score_update_resident`` (K10, resident entry, a stage of the resident
  step between K7 and K8): computes the merge ``where(hit, served, res &
  0xFFFF)`` itself from the probe's words, the hit bitmap and the stateless
  res16 words, scores it and writes the policy's verdicts into both the
  probe's words and the stateless words (so K8's unchanged merge yields
  them on every lane and caches them for the misses), then the anomaly
  bitmap and the int16-saturated scores into the step's output;
- ``score_drain``: the window reset in place (tstat and the per-row
  anomaly-hit columns).

On a CPU tensor the wrappers run ``score_update_plain``, which mirrors
``_score_update_core`` statement for statement; on a CUDA tensor they
launch K10 or raise.  ``HostScoreModel`` mirrors every update in numpy.

K10 is one launch a call (csrc/score_update.cu), on one of two plans that
``plan_for`` picks per call (a pure function of B, the geometry and the
card's opt-in shared-memory limit, so one CUDA graph always captures one
plan): "S", one block with the state in shared memory, for B up to
``BLOCK_PLAN_MAX_LANES`` lanes where it fits; "L", a cooperative grid whose
blocks tally their lanes' adds, bids and seeds in shared memory where the
geometry fits, for the rest.  The per-slot scratch (``slot_scratch_words``:
bids, seeds, anomaly hits and a count) is the caller's (the tier keeps one,
so a graph bakes it), -1 / 0 on entry and again after every call; plan L
takes a per-lane spill only where a block's lanes outrun its registers.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import failsaferules
from ..constants import DENY, IPPROTO_TCP, IPPROTO_UDP, KIND_IPV4, KIND_IPV6, TCP_ACK, TCP_SYN
from . import _build
from .flow import unpack_bits32, unpack_res16
from .torchpath import _pack_res16, unpack_wire, wrap_int32

#: source key words: [tenant, ip0, ip1, ip2, ip3, kind]
SCORE_KEY_WORDS = 6

#: the fixed feature schema (index -> meaning), every feature int32:
#:   0 src_pkts, 1 src_syns, 2 src_denies, 3 src_newports (the source row,
#:   post-update, sat-clamped), 4 cms_est, 5 epoch_delta (65535 = first
#:   sight), 6 lane_syn, 7 lane_flags, 8 pkt_len, 9 kind, 10 dst_port,
#:   11 proto, 12 syn_frac_q8, 13 newport_frac_q8, 14 deny_frac_q8
#:   ((x * 256) // max(src_pkts, 1)), 15 lane_deny
SCORE_FEATURES = 16

#: epoch-delta sentinel for a source with no resident row
FIRST_SIGHT_DELTA = 65535

#: res16 written by an enforced rewrite: action Deny, ruleId 0
ANOMALY_DENY_RESULT = DENY

#: default per-tenant anomaly threshold (one >= 100 leaf fires alone)
DEFAULT_THRESHOLD = 100

_ARGS = [ctypes.c_void_p] * 23 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
KERNEL = _build.Kernel("score_update", "infw_score_update", _ARGS)
RESIDENT_KERNEL = _build.Kernel("score_update_resident", "infw_score_update_resident", _ARGS,
                                source="score_update")
#: the library's set-up entry (no kernel): raises K10's shared-memory caps on
#: the current device and returns the card's opt-in limit a block, in bytes
PREPARE = _build.Kernel("score_prepare", "infw_score_prepare", [ctypes.c_int],
                        source="score_update")

#: threads of a block on both plans, lanes whose carry a thread keeps in
#: registers, and plan L's lanes a block (csrc/score_update.cu kThreads,
#: kRegLanes, kGridLanes)
BLOCK_THREADS, REG_LANES, GRID_LANES = 1024, 2, 256
#: the crossover: plan S serves calls of at most this many lanes (measured
#: on an H100 by ``python -m infw_torch.tools.score_plans``; PERF.md)
BLOCK_PLAN_MAX_LANES = 1024
#: each plan's code in the C entry's ``plan`` argument
PLANS = {"L": 0, "S": 1}


def _pow2(n: int, floor: int = 8) -> int:
    return max(floor, 1 << (max(int(n), 1) - 1).bit_length())


class ScoreSpec(NamedTuple):
    """Geometry of one scoring tier.  Model values are runtime operands,
    so a swap never rebuilds anything; only geometry lives here."""

    trees: int = 4            # oblivious trees
    depth: int = 3            # levels per tree (leaves = 2**depth)
    slots: int = 512          # per-source feature rows (power of two)
    ways: int = 4             # set-associative probes per key
    cms_depth: int = 2        # count-min rows
    cms_width: int = 1024     # buckets per row (power of two)
    sat: int = 65535          # feature/counter saturation clamp
    hidden: int = 0           # int8 MLP head width (0 = forest only)
    max_tenants: int = 1

    @property
    def leaves(self) -> int:
        return 1 << self.depth

    @staticmethod
    def make(trees: int = 4, depth: int = 3, slots: int = 512,
             ways: int = 4, cms_depth: int = 2, cms_width: int = 1024,
             sat: int = 65535, hidden: int = 0,
             max_tenants: int = 1) -> "ScoreSpec":
        if not 1 <= trees <= 16:
            raise ValueError(f"score trees must be in [1, 16], got {trees}")
        if not 1 <= depth <= 6:
            raise ValueError(f"score depth must be in [1, 6], got {depth}")
        if not 1 <= ways <= 8:
            raise ValueError(f"score ways must be in [1, 8], got {ways}")
        if not 1 <= cms_depth <= 8:
            raise ValueError(f"score cms_depth must be in [1, 8], got {cms_depth}")
        if sat < 1:
            raise ValueError(f"score sat must be >= 1, got {sat}")
        if not 0 <= hidden <= 64:
            raise ValueError(f"score hidden must be in [0, 64], got {hidden}")
        if max_tenants < 1:
            raise ValueError("score max_tenants must be >= 1")
        return ScoreSpec(
            trees=int(trees), depth=int(depth), slots=_pow2(slots),
            ways=int(ways), cms_depth=int(cms_depth),
            cms_width=_pow2(cms_width), sat=int(sat), hidden=int(hidden),
            max_tenants=int(max_tenants),
        )


class ScoreState(NamedTuple):
    """The scoring tensors (numpy in the host model's mirror)."""

    skeys: object  # (S, 6) uint32 (int32 bit patterns on the device)
    scols: object  # (S, 8) int32
    cms: object    # (D, W) int32
    tstat: object  # (T, 4) int32 [scored, anom, enforced, maxscore]
    epoch: object  # (1,) int32 admission counter


class ScoreModelDev(NamedTuple):
    """The model's value tensors on one device (shapes fixed by the spec,
    rewritten in place on a swap)."""

    fidx: torch.Tensor    # (T, D) int32 feature index per tree level
    fthr: torch.Tensor    # (T, D) int32 threshold per tree level
    leaf: torch.Tensor    # (T * L,) int8 leaf values
    w1: torch.Tensor      # (F, H) int8
    b1: torch.Tensor      # (H,) int32
    w2: torch.Tensor      # (H,) int8
    b2: torch.Tensor      # (1,) int32
    qshift: torch.Tensor  # (2,) int32 [feature shift, hidden requant shift]


class ScoreModel(NamedTuple):
    """A model artifact: a ScoreSpec and the numpy value arrays (the npz and
    manifest of infw_torch.mlscore.save_model)."""

    spec: ScoreSpec
    fidx: np.ndarray
    fthr: np.ndarray
    leaf: np.ndarray
    w1: np.ndarray
    b1: np.ndarray
    w2: np.ndarray
    b2: np.ndarray
    qshift: np.ndarray
    version: str = "default"

    def arrays(self) -> dict:
        return {
            "fidx": self.fidx, "fthr": self.fthr, "leaf": self.leaf,
            "w1": self.w1, "b1": self.b1, "w2": self.w2, "b2": self.b2,
            "qshift": self.qshift,
        }


#: the value arrays, in ScoreModelDev's order
MODEL_FIELDS = ScoreModelDev._fields


def validate_model(model: ScoreModel) -> None:
    """Shape, dtype and range contract of a model against its spec (a
    malformed swap fails at the control plane, never inside a launch)."""
    s = model.spec
    want = {
        "fidx": ((s.trees, s.depth), np.int32),
        "fthr": ((s.trees, s.depth), np.int32),
        "leaf": ((s.trees * s.leaves,), np.int8),
        "w1": ((SCORE_FEATURES, s.hidden), np.int8),
        "b1": ((s.hidden,), np.int32),
        "w2": ((s.hidden,), np.int8),
        "b2": ((1,), np.int32),
        "qshift": ((2,), np.int32),
    }
    for name, (shape, dtype) in want.items():
        a = np.asarray(getattr(model, name))
        if a.shape != shape or a.dtype != dtype:
            raise ValueError(
                f"score model {name!r}: want shape {shape} dtype "
                f"{np.dtype(dtype).name}, got {a.shape} {a.dtype.name}"
            )
    if (model.fidx < 0).any() or (model.fidx >= SCORE_FEATURES).any():
        raise ValueError(f"score model fidx out of range [0, {SCORE_FEATURES})")
    if (model.qshift < 0).any() or (model.qshift > 31).any():
        raise ValueError("score model qshift out of range [0, 31]")


def zero_state_host(spec: ScoreSpec) -> ScoreState:
    return ScoreState(
        skeys=np.zeros((spec.slots, SCORE_KEY_WORDS), np.uint32),
        scols=np.zeros((spec.slots, 8), np.int32),
        cms=np.zeros((spec.cms_depth, spec.cms_width), np.int32),
        tstat=np.zeros((spec.max_tenants, 4), np.int32),
        epoch=np.zeros(1, np.int32),
    )


def zero_state(spec: ScoreSpec, device) -> ScoreState:
    """Zero int32 state tensors on ``device``."""
    z = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=device)  # noqa: E731
    return ScoreState(skeys=z(spec.slots, SCORE_KEY_WORDS), scols=z(spec.slots, 8),
                      cms=z(spec.cms_depth, spec.cms_width), tstat=z(spec.max_tenants, 4),
                      epoch=z(1))


def state_from_host(arrays: dict, device) -> ScoreState:
    """The five arrays (``skeys`` uint32) -> a ScoreState on ``device`` that
    shares no memory with them."""
    put = lambda a, dt: torch.from_numpy(np.array(a, dt).view(np.int32)).to(device)  # noqa: E731
    return ScoreState(skeys=put(arrays["skeys"], np.uint32), scols=put(arrays["scols"], np.int32),
                      cms=put(arrays["cms"], np.int32), tstat=put(arrays["tstat"], np.int32),
                      epoch=put(arrays["epoch"], np.int32))


def state_to_host(state: ScoreState) -> dict:
    """Host copies of the five tensors (``skeys`` as uint32)."""
    out = {k: getattr(state, k).cpu().numpy().copy() for k in ScoreState._fields}
    out["skeys"] = out["skeys"].view(np.uint32)
    return out


def zero_tparams(spec: ScoreSpec, threshold: int = DEFAULT_THRESHOLD,
                 enforce: bool = False) -> np.ndarray:
    """(T, 2) int32 per-tenant policy rows [threshold, enforce flag]."""
    t = np.zeros((spec.max_tenants, 2), np.int32)
    t[:, 0] = int(threshold)
    t[:, 1] = 1 if enforce else 0
    return t


def slot_scratch_words(spec: ScoreSpec) -> int:
    """K10's per-slot scratch: a bid, four seed words and an anomaly-hit word
    a slot, then a count of plan L's blocks done, to 16 bytes
    (csrc/score_update.cu Args)."""
    return 6 * spec.slots + 4


def empty_scratch(spec: ScoreSpec, device) -> torch.Tensor:
    """A per-slot scratch as K10 takes it: bids -1, seeds, hits and the
    count 0 (and so it leaves it after every call)."""
    t = torch.zeros(slot_scratch_words(spec), dtype=torch.int32, device=device)
    t[: spec.slots] = -1
    return t


def score_drain(state: ScoreState) -> None:
    """The window reset in place (mxu_score.jitted_score_drain): tstat and
    the per-row anomaly-hit and reserved columns zero; the rates persist."""
    state.tstat.zero_()
    state.scols[:, 6:8].zero_()


def score_reset(state: ScoreState) -> None:
    """Every state tensor zeroed in place."""
    for t in state:
        t.zero_()


# --- failsafe precedence -----------------------------------------------------------
#
# The port list of infw_torch.failsaferules (csrc/score_update.cu keeps the
# same ports as constants; a CPU test holds the two equal).

FAILSAFE_TCP = np.asarray(sorted({fs.port for fs in failsaferules.get_tcp()}), np.int32)
FAILSAFE_UDP = np.asarray(sorted({fs.port for fs in failsaferules.get_udp()}), np.int32)


def failsafe_lane_mask_np(proto: np.ndarray, dst_port: np.ndarray) -> np.ndarray:
    """(B,) bool: lanes whose (proto, dst_port) is a failsafe cell (enforce
    never rewrites these)."""
    proto = np.asarray(proto, np.int32)
    dst_port = np.asarray(dst_port, np.int32)
    tcp = (proto == IPPROTO_TCP) & np.isin(dst_port, FAILSAFE_TCP)
    udp = (proto == IPPROTO_UDP) & np.isin(dst_port, FAILSAFE_UDP)
    return tcp | udp


def _failsafe_lane_mask(proto: torch.Tensor, dst_port: torch.Tensor) -> torch.Tensor:
    tcp_ports = torch.from_numpy(FAILSAFE_TCP).to(dst_port.device)
    udp_ports = torch.from_numpy(FAILSAFE_UDP).to(dst_port.device)
    tcp = (proto == IPPROTO_TCP) & (dst_port[:, None] == tcp_ports[None, :]).any(dim=1)
    udp = (proto == IPPROTO_UDP) & (dst_port[:, None] == udp_ports[None, :]).any(dim=1)
    return tcp | udp


# --- model builders ----------------------------------------------------------------


def default_model(spec: Optional[ScoreSpec] = None) -> ScoreModel:
    """The shipped detection forest (no MLP head): one tree per attack
    family, leaf values sized so any single firing tree crosses
    DEFAULT_THRESHOLD.

    - tree 0 (SYN flood): syn_frac_q8 >= 192 AND src_pkts >= 24 AND the
      lane is a pure SYN -> 120;
    - tree 1 (port scan): newport_frac_q8 >= 128 AND src_pkts >= 24 -> 120
      (bit 2, cms_est >= 16, rides along);
    - tree 2 (rate/deny storm): cms_est >= 4096 alone scores 30, with
      deny_frac_q8 >= 192 -> 120;
    - the other trees are inert (unsatisfiable thresholds, zero leaves)."""
    spec = spec or ScoreSpec.make()
    T, D, L = spec.trees, spec.depth, spec.leaves
    NEVER = np.int32(2**31 - 1)
    fidx = np.zeros((T, D), np.int32)
    fthr = np.full((T, D), NEVER, np.int32)
    leaf = np.zeros((T, L), np.int8)

    def tree(t, levels, hits):
        for d, (f, th) in enumerate(levels):
            fidx[t, d] = f
            fthr[t, d] = th
        nbits = len(levels)
        for bits, val in hits.items():
            # the inert levels compare against NEVER (bit 0): set every
            # padded leaf whose low bits match
            for hi in range(1 << (D - nbits)):
                leaf[t, (hi << nbits) | bits] = val

    if T >= 1 and D >= 3:
        tree(0, [(12, 192), (0, 24), (6, 1)], {0b111: 120})
        if T >= 2:
            tree(1, [(13, 128), (0, 24), (4, 16)], {0b011: 120, 0b111: 120})
        if T >= 3:
            tree(2, [(4, 4096), (14, 192)], {0b01: 30, 0b11: 120})
    H = spec.hidden
    return ScoreModel(
        spec=spec, fidx=fidx, fthr=fthr, leaf=leaf.reshape(-1),
        w1=np.zeros((SCORE_FEATURES, H), np.int8),
        b1=np.zeros(H, np.int32), w2=np.zeros(H, np.int8),
        b2=np.zeros(1, np.int32), qshift=np.zeros(2, np.int32),
        version="default",
    )


def clamp_stress_model(spec: ScoreSpec) -> ScoreModel:
    """A head-ful model whose hidden activations exceed the int8 clamp on
    ordinary traffic: 3 * min(pkt_len, 127) reaches 381 for any packet over
    127 bytes, and the requantization clamps it to 127."""
    if spec.hidden < 1:
        raise ValueError("clamp_stress_model needs spec.hidden >= 1")
    m = default_model(spec)
    w1 = np.zeros((SCORE_FEATURES, spec.hidden), np.int8)
    w1[8, 0] = 3
    w2 = np.zeros(spec.hidden, np.int8)
    w2[0] = 1
    return m._replace(w1=w1, w2=w2, version="clamp-stress")


def model_device(model: ScoreModel, device) -> ScoreModelDev:
    """The value arrays as tensors on ``device`` (validated first)."""
    validate_model(model)
    put = lambda a: torch.from_numpy(np.array(a)).to(device)  # noqa: E731
    return ScoreModelDev(*(put(getattr(model, f)) for f in MODEL_FIELDS))


def model_copy_(dev: ScoreModelDev, model: ScoreModel) -> None:
    """Rewrite the value tensors in place from ``model`` (validated first):
    the addresses a graph baked stay."""
    validate_model(model)
    for f in MODEL_FIELDS:
        getattr(dev, f).copy_(torch.from_numpy(np.array(getattr(model, f))))


# --- shared key and hash forms ------------------------------------------------------


def _key_words_np(f, tenant: np.ndarray) -> np.ndarray:
    return np.stack([
        tenant.astype(np.uint32),
        f["ip_words"][:, 0].astype(np.uint32),
        f["ip_words"][:, 1].astype(np.uint32),
        f["ip_words"][:, 2].astype(np.uint32),
        f["ip_words"][:, 3].astype(np.uint32),
        f["kind"].astype(np.uint32) & np.uint32(3),
    ], axis=1)


def _hash_np(keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    h = np.full(keys.shape[0], 0x811C9DC5, np.uint32)
    for w in range(SCORE_KEY_WORDS):
        h = (h ^ keys[:, w].astype(np.uint32)) * np.uint32(0x01000193)
    return h, (h >> np.uint32(16)) | np.uint32(1)


def _key_words(batch, tenant: torch.Tensor) -> torch.Tensor:
    """(B, 6) int64 u32 key words (mxu_score._key_words_jax)."""
    cols = [tenant.long()] + [batch.ip_words[:, k].long() for k in range(4)]
    cols.append(batch.kind.long() & 3)
    return torch.stack(cols, dim=1) & 0xFFFFFFFF


def _hash(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """FNV-1a over the 6 key words -> (h1, h2 | 1), u32 in int64."""
    h = torch.full(keys.shape[:1], 0x811C9DC5, dtype=torch.int64, device=keys.device)
    for w in range(SCORE_KEY_WORDS):
        h = ((h ^ keys[:, w]) * 0x01000193) & 0xFFFFFFFF
    return h, (h >> 16) | 1


# --- the host model ---------------------------------------------------------------


class HostScoreModel:
    """Bit-exact numpy mirror of the score update: the same key and hash
    forms, the same scatter order (count-min add and clamp -> source-table
    probe and update -> feature gather -> forest -> MLP head -> policy) and
    the same dedup rules."""

    def __init__(self, spec: ScoreSpec, model: Optional[ScoreModel] = None,
                 tparams: Optional[np.ndarray] = None) -> None:
        self.spec = spec
        self.model = model or default_model(spec)
        validate_model(self.model)
        if self.model.spec != spec:
            raise ValueError("score model geometry != tier spec")
        self.tparams = (zero_tparams(spec) if tparams is None
                        else np.asarray(tparams, np.int32).copy())
        s = zero_state_host(spec)
        self.skeys, self.scols, self.cms, self.tstat, self.epoch = s

    def columns(self) -> dict:
        return {"skeys": self.skeys, "scols": self.scols, "cms": self.cms,
                "tstat": self.tstat, "epoch": self.epoch}

    def drain(self) -> None:
        """Window reset: tstat and the per-row anomaly-hit column clear."""
        self.tstat = np.zeros_like(self.tstat)
        self.scols[:, 6] = 0

    def swap(self, model: ScoreModel) -> None:
        validate_model(model)
        if model.spec != self.spec:
            raise ValueError("score model geometry != tier spec")
        self.model = model

    def reset_state(self) -> None:
        s = zero_state_host(self.spec)
        self.skeys, self.scols, self.cms, self.tstat, self.epoch = s

    def _features(self, f, tenant, tflags, res, elig):
        """The update and feature half: (features (B, F) int32, slot), the
        state mutated."""
        spec = self.spec
        b = tenant.shape[0]
        S, Wy = spec.slots, spec.ways
        D, W = spec.cms_depth, spec.cms_width
        sat = np.int32(spec.sat)
        e1 = np.int32(self.epoch[0] + 1)
        keyw = _key_words_np(f, tenant)
        h1, h2 = _hash_np(keyw)
        # 1. count-min add + clamp, then the post-update estimate
        rows = np.arange(D, dtype=np.uint32)[None, :]
        col = ((h1[:, None] + rows * h2[:, None]) & np.uint32(W - 1)).astype(np.int64)
        flat = rows.astype(np.int64) * W + col
        cms = self.cms.reshape(-1)
        np.add.at(cms, flat[elig].reshape(-1), 1)
        np.minimum(cms, sat, out=cms)
        self.cms = cms.reshape(D, W)
        est = np.minimum(np.min(self.cms.reshape(-1)[flat], axis=1).astype(np.int32), sat)
        # 2. source-table probe: match else first-empty else LRU victim
        wid = np.arange(Wy, dtype=np.uint32)[None, :]
        cand = ((h1[:, None] + wid * h2[:, None]) & np.uint32(S - 1)).astype(np.int64)
        ek = self.skeys[cand]
        ecols = self.scols[cand]
        occupied = ecols[:, :, 0] > 0
        match_w = np.all(ek == keyw[:, None, :], axis=2) & occupied
        widx = np.arange(Wy, dtype=np.int32)[None, :]
        m_first = np.min(np.where(match_w, widx, Wy), axis=1)
        matched = m_first < Wy
        mslot = np.sum(np.where(widx == m_first[:, None], cand, 0), axis=1)
        e_first = np.min(np.where(~occupied, widx, Wy), axis=1)
        lru = np.argmin(ecols[:, :, 5], axis=1).astype(np.int32)
        vway = np.where(e_first < Wy, e_first, lru)
        vslot = np.sum(np.where(widx == vway[:, None], cand, 0), axis=1)
        slot = np.where(matched, mslot, vslot)
        pre_lastport = self.scols[np.clip(slot, 0, S - 1), 4]
        pre_lastepoch = self.scols[np.clip(slot, 0, S - 1), 5]
        # the last eligible lane per slot wins the set-writes
        lane = np.arange(b, dtype=np.int64)
        idx_e = np.where(elig, slot, S)
        winner = np.full(S + 1, -1, np.int64)
        np.maximum.at(winner, idx_e, lane)
        win = elig & (winner[np.clip(slot, 0, S)] == lane)
        repl = win & ~matched
        is_tcp = f["proto"] == IPPROTO_TCP
        syn_lane = is_tcp & ((tflags & TCP_SYN) != 0) & ((tflags & TCP_ACK) == 0)
        deny_lane = (res & np.uint32(0xFF)).astype(np.int32) == DENY
        newport_lane = matched & (f["dst_port"] != pre_lastport)
        contrib = np.stack([
            np.ones(b, np.int32), syn_lane.astype(np.int32),
            deny_lane.astype(np.int32), newport_lane.astype(np.int32),
        ], axis=1)
        seeds = np.zeros((S + 1, 4), np.int32)
        np.add.at(seeds, idx_e, contrib)
        seeds = seeds[:S]
        repl_mask = np.zeros(S + 1, np.int32)
        np.maximum.at(repl_mask, np.where(repl, slot, S), 1)
        repl_mask = repl_mask[:S].astype(bool)
        base = np.where(repl_mask[:, None], 0, self.scols[:, 0:4])
        self.scols[:, 0:4] = np.minimum(base + seeds, sat)
        self.scols[repl_mask, 6] = 0
        self.scols[repl_mask, 7] = 0
        ws = slot[win]
        self.skeys[slot[repl]] = keyw[repl]
        self.scols[ws, 4] = f["dst_port"][win]
        touched = np.unique(idx_e[elig])
        self.scols[touched[touched < S], 5] = e1
        # 3. feature gather from the post-update rows
        g = np.clip(slot, 0, S - 1)
        pkts = self.scols[g, 0]
        syns = self.scols[g, 1]
        denies = self.scols[g, 2]
        newports = self.scols[g, 3]
        delta = np.where(matched, np.clip(e1 - pre_lastepoch, 0, FIRST_SIGHT_DELTA),
                         FIRST_SIGHT_DELTA).astype(np.int32)
        pk = np.maximum(pkts, 1)
        feats = np.stack([
            pkts, syns, denies, newports, est, delta,
            syn_lane.astype(np.int32),
            (tflags & 0xFF).astype(np.int32),
            f["pkt_len"].astype(np.int32),
            f["kind"].astype(np.int32),
            f["dst_port"].astype(np.int32),
            f["proto"].astype(np.int32),
            (syns * 256) // pk,
            (newports * 256) // pk,
            (denies * 256) // pk,
            deny_lane.astype(np.int32),
        ], axis=1).astype(np.int32)
        self.epoch = self.epoch + np.int32(1)
        return feats, slot

    def infer(self, feats: np.ndarray) -> np.ndarray:
        """Forest + MLP head over assembled features (no state)."""
        m = self.model
        spec = self.spec
        T, D, L = spec.trees, spec.depth, spec.leaves
        b = feats.shape[0]
        fsel = feats[:, np.clip(m.fidx, 0, SCORE_FEATURES - 1).reshape(-1)]
        bits = (fsel.reshape(b, T, D) >= m.fthr[None, :, :]).astype(np.int32)
        leaf_idx = np.sum(bits << np.arange(D, dtype=np.int32)[None, None, :], axis=2)
        oh = (leaf_idx[:, :, None] == np.arange(L, dtype=np.int32)[None, None, :]
              ).astype(np.int8).reshape(b, T * L)
        score = oh.astype(np.int32) @ m.leaf.astype(np.int32)
        if spec.hidden:
            in_shift = int(m.qshift[0])
            h_shift = int(m.qshift[1])
            xq = np.clip(feats >> in_shift, 0, 127).astype(np.int8)
            h = xq.astype(np.int32) @ m.w1.astype(np.int32) + m.b1
            hq = np.clip(h >> h_shift, 0, 127).astype(np.int8)
            score = score + (hq.astype(np.int32) @ m.w2.astype(np.int32) + m.b2[0])
        return score.astype(np.int32)

    def update(self, wire: np.ndarray, res: np.ndarray,
               tenant: Optional[np.ndarray] = None,
               tflags: Optional[np.ndarray] = None):
        """One admission: update the state, score every lane and apply the
        per-tenant policy.  Returns (scores int32, anom bool, res' uint32)."""
        from ..flow import host_unpack_wire

        spec = self.spec
        wire = np.asarray(wire, np.uint32)
        b = wire.shape[0]
        f = host_unpack_wire(wire)
        tenant = np.zeros(b, np.int32) if tenant is None else np.asarray(tenant, np.int32)
        tflags = np.zeros(b, np.int32) if tflags is None else np.asarray(tflags, np.int32)
        res = np.asarray(res).astype(np.uint32)
        is_ip = (f["kind"] == KIND_IPV4) | (f["kind"] == KIND_IPV6)
        t_ok = (tenant >= 0) & (tenant < spec.max_tenants)
        elig = is_ip & t_ok
        feats, slot = self._features(f, tenant, tflags, res, elig)
        score = self.infer(feats)
        tclip = np.clip(tenant, 0, spec.max_tenants - 1)
        thr = self.tparams[tclip, 0]
        enf = self.tparams[tclip, 1] != 0
        anom = elig & (score >= thr)
        fs = failsafe_lane_mask_np(f["proto"], f["dst_port"])
        act = (res & np.uint32(0xFF)).astype(np.int32)
        rewrite = anom & enf & ~fs & (act != DENY)
        res_out = np.where(rewrite, np.uint32(ANOMALY_DENY_RESULT), res)
        np.add.at(self.scols[:, 6], np.clip(slot, 0, spec.slots - 1)[anom], 1)
        np.minimum(self.scols[:, 6], np.int32(spec.sat), out=self.scols[:, 6])
        upd = np.stack([elig.astype(np.int32), anom.astype(np.int32),
                        rewrite.astype(np.int32)], axis=1)
        np.add.at(self.tstat[:, 0:3], tclip[elig], upd[elig])
        np.maximum.at(self.tstat[:, 3], tclip[elig], score[elig])
        return score, anom, res_out


# --- the plain version ---------------------------------------------------------------


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, K) @ (K, N) in int64 (exact for these widths; the caller wraps
    to int32, which is XLA's int32 accumulation): an elementwise product
    summed, so it runs on CUDA tensors too, which have no integer
    matmul."""
    return (x.long()[:, :, None] * w.long()[None, :, :]).sum(dim=1)


def score_infer_plain(feats: torch.Tensor, model: ScoreModelDev, spec: ScoreSpec) -> torch.Tensor:
    """Forest + MLP head (mxu_score._score_infer): ``feats`` (B, 16) int32
    -> (B,) int32 scores."""
    T, D, L = spec.trees, spec.depth, spec.leaves
    b = feats.shape[0]
    dev = feats.device
    fsel = feats[:, model.fidx.long().clamp(0, SCORE_FEATURES - 1).reshape(-1)].reshape(b, T, D)
    bits = (fsel >= model.fthr[None, :, :]).long()
    leaf_idx = (bits << torch.arange(D, dtype=torch.int64, device=dev)[None, None, :]).sum(dim=2)
    oh = leaf_idx[:, :, None] == torch.arange(L, dtype=torch.int64, device=dev)[None, None, :]
    score = _dot(oh.reshape(b, T * L), model.leaf[:, None])[:, 0]
    if spec.hidden:
        xq = (feats >> model.qshift[0]).clamp(0, 127)
        h = wrap_int32(_dot(xq, model.w1) + model.b1.long()[None, :])
        hq = (h >> model.qshift[1]).clamp(0, 127)
        score = score + _dot(hq, model.w2[:, None])[:, 0] + model.b2.long()[0]
    return wrap_int32(score)


def score_update_plain(sc: ScoreState, model: ScoreModelDev, tparams: torch.Tensor,
                       wire: torch.Tensor, tenant: torch.Tensor, tflags: torch.Tensor,
                       res: torch.Tensor, spec: ScoreSpec):
    """K10's function in plain PyTorch (mxu_score._score_update_core,
    statement for statement): ``wire`` (B, 4 | 7) int32, ``tenant``,
    ``tflags`` and ``res`` (B,) (u32 verdicts as int32 or int64).  Updates
    the five tensors of ``sc`` in place and returns (score (B,) int32, anom
    (B,) bool, res' (B,) int64 u32).  Every int32 sum of the reference is
    taken in int64 and wrapped, which is the same modulo 2^32."""
    S, Wy = spec.slots, spec.ways
    D, W = spec.cms_depth, spec.cms_width
    T = spec.max_tenants
    dev = wire.device
    sat = torch.tensor(spec.sat, dtype=torch.int32, device=dev)
    batch = unpack_wire(wire)
    B = wire.shape[0]
    res = res.long() & 0xFFFFFFFF
    tenant = tenant.long()
    tflags = tflags.long()
    e1 = wrap_int32(sc.epoch.long() + 1)[0]
    keyw = _key_words(batch, tenant)
    is_ip = (batch.kind == KIND_IPV4) | (batch.kind == KIND_IPV6)
    elig = is_ip & (tenant >= 0) & (tenant < T)
    h1, h2 = _hash(keyw)
    # 1. count-min add (wrapping in int32) + clamp, then the post-update estimate
    rows = torch.arange(D, dtype=torch.int64, device=dev)[None, :]
    flat = rows * W + ((h1[:, None] + rows * h2[:, None]) & (W - 1))
    cms = sc.cms.reshape(-1).long()
    idx = flat[elig].reshape(-1)
    cms.index_add_(0, idx, torch.ones_like(idx))
    cms = torch.minimum(wrap_int32(cms), sat)
    sc.cms.copy_(cms.reshape(D, W))
    est = torch.minimum(cms[flat].min(dim=1).values, sat)
    # 2. source-table probe on the rows before any write
    wid = torch.arange(Wy, dtype=torch.int64, device=dev)[None, :]
    cand = (h1[:, None] + wid * h2[:, None]) & (S - 1)
    ek = sc.skeys[cand]
    ecols = sc.scols[cand]
    occupied = ecols[:, :, 0] > 0
    match_w = torch.all(ek == wrap_int32(keyw)[:, None, :], dim=2) & occupied
    m_first = torch.where(match_w, wid, Wy).min(dim=1).values
    matched = m_first < Wy
    mslot = cand.gather(1, m_first.clamp(max=Wy - 1)[:, None])[:, 0]
    e_first = torch.where(~occupied, wid, Wy).min(dim=1).values
    lru = ecols[:, :, 5].argmin(dim=1)  # the first of ties
    vway = torch.where(e_first < Wy, e_first, lru)
    vslot = cand.gather(1, vway[:, None])[:, 0]
    slot = torch.where(matched, mslot, vslot)
    pre_lastport = sc.scols[slot, 4]
    pre_lastepoch = sc.scols[slot, 5]
    lane = torch.arange(B, dtype=torch.int64, device=dev)
    idx_e = torch.where(elig, slot, S)
    winner = torch.full((S + 1,), -1, dtype=torch.int64, device=dev)
    winner.scatter_reduce_(0, idx_e, lane, "amax")
    win = elig & (winner[slot] == lane)
    repl = win & ~matched
    syn_lane = ((batch.proto == IPPROTO_TCP) & ((tflags & TCP_SYN) != 0)
                & ((tflags & TCP_ACK) == 0))
    deny_lane = (res & 0xFF) == DENY
    newport_lane = matched & (batch.dst_port != pre_lastport)
    contrib = torch.stack([torch.ones_like(lane), syn_lane.long(), deny_lane.long(),
                           newport_lane.long()], dim=1)
    seeds = torch.zeros((S + 1, 4), dtype=torch.int64, device=dev)
    seeds.index_add_(0, idx_e, contrib)
    seeds = seeds[:S]
    repl_mask = torch.zeros(S + 1, dtype=torch.bool, device=dev)
    repl_mask[slot[repl]] = True
    repl_mask = repl_mask[:S]
    old = sc.scols
    base = torch.where(repl_mask[:, None], 0, old[:, 0:4].long())
    cols03 = torch.minimum(wrap_int32(base + seeds), sat)
    col6 = torch.where(repl_mask, 0, old[:, 6])
    col7 = torch.where(repl_mask, 0, old[:, 7])
    col4 = old[:, 4].clone()
    col4[slot[win]] = batch.dst_port[win].to(torch.int32)
    col5 = old[:, 5].clone()
    col5[slot[elig]] = e1
    sc.skeys[slot[repl]] = wrap_int32(keyw[repl])
    # 3. feature gather from the post-update rows
    pkts, syns, denies, newports = (cols03[slot, k].long() for k in range(4))
    delta = torch.where(matched,
                        wrap_int32(e1.long() - pre_lastepoch.long()).long().clamp(
                            0, FIRST_SIGHT_DELTA), FIRST_SIGHT_DELTA)
    pk = pkts.clamp(min=1)

    def frac(x):
        return torch.div(wrap_int32(x * 256).long(), pk, rounding_mode="floor")

    feats = wrap_int32(torch.stack([
        pkts, syns, denies, newports, est.long(), delta, syn_lane.long(), tflags & 0xFF,
        batch.pkt_len.long(), batch.kind.long(), batch.dst_port.long(), batch.proto.long(),
        frac(syns), frac(newports), frac(denies), deny_lane.long(),
    ], dim=1))
    score = score_infer_plain(feats, model, spec)
    # 4. policy: never a failsafe cell, never an existing rule Deny
    tclip = tenant.clamp(0, T - 1)
    thr = tparams[tclip, 0]
    enf = tparams[tclip, 1] != 0
    anom = elig & (score >= thr)
    fs = _failsafe_lane_mask(batch.proto, batch.dst_port)
    rewrite = anom & enf & ~fs & ((res & 0xFF) != DENY)
    res_out = torch.where(rewrite, ANOMALY_DENY_RESULT, res)
    col6 = col6.long().index_add_(0, slot[anom], torch.ones_like(slot[anom]))
    col6 = torch.minimum(wrap_int32(col6), sat)
    sc.scols.copy_(torch.stack([cols03[:, 0], cols03[:, 1], cols03[:, 2], cols03[:, 3],
                                col4, col5, col6, col7], dim=1))
    # 5. per-tenant window counters + max score
    upd = torch.stack([elig.long(), anom.long(), rewrite.long()], dim=1)
    tstat = sc.tstat.long()
    tstat[:, 0:3].index_add_(0, tclip[elig], upd[elig])
    tstat[:, 3].scatter_reduce_(0, tclip[elig], score[elig].long(), "amax")
    sc.tstat.copy_(wrap_int32(tstat))
    sc.epoch.copy_(wrap_int32(sc.epoch.long() + 1))
    return score, anom, res_out


# --- the kernel --------------------------------------------------------------------------


class ScoreOps(NamedTuple):
    """What a score launch takes from the tier: the state, the model's value
    tensors, the policy rows, K10's per-slot scratch and the geometry."""

    state: ScoreState
    model: ScoreModelDev
    tparams: torch.Tensor
    scratch: Optional[torch.Tensor]
    spec: ScoreSpec


def score_out_words(b: int) -> int:
    """Words of the classic entry's output: [score, anom, res'] x B."""
    return 3 * b


def split_score_outputs(arr: np.ndarray, b: int):
    """Host inverse of the classic entry's output -> (score int32, anom
    bool, res' uint32)."""
    arr = np.asarray(arr).reshape(3, b)
    return arr[0].copy(), arr[1] != 0, arr[2].view(np.uint32).copy()


def _r4(words: int) -> int:
    return (words + 3) // 4 * 4


def model_words(spec: ScoreSpec) -> int:
    """The model's shared copy in words (csrc/score_update.cu model_words):
    fidx and fthr (trees x depth) and b1 (hidden) as int32, then the int8
    leaves, w1 (16 x hidden) and w2 (hidden), each segment on 16 bytes."""
    td, h = spec.trees * spec.depth, spec.hidden
    return (2 * _r4(td) + _r4(h) + _r4((spec.trees * spec.leaves + 3) // 4) + 4 * h
            + _r4((h + 3) // 4))


def block_plan_bytes(b: int, spec: ScoreSpec) -> int:
    """Plan S's shared memory at ``b`` lanes (csrc/score_update.cu
    block_words): the model, the source columns and keys (14 S words), the
    count-min rows (D W), the tenant counters (4 T), the bids and seeds (5
    S), then a 16-byte carry a lane past the register lanes."""
    spill = max(0, b - REG_LANES * BLOCK_THREADS)
    return 4 * (model_words(spec) + 19 * spec.slots + spec.cms_depth * spec.cms_width
                + 4 * spec.max_tenants + 4 * spill)


def grid_plan_bytes(spec: ScoreSpec) -> int:
    """Plan L's shared memory where its tallies fit (csrc/score_update.cu
    grid_words): the model, the staged rows (14 S words), then the larger of
    phase A's tallies (5 S + D W) and phase C's (S + 4 T)."""
    a = 5 * spec.slots + spec.cms_depth * spec.cms_width
    return 4 * (model_words(spec) + 14 * spec.slots + max(a, spec.slots + 4 * spec.max_tenants))


def plan_for(b: int, spec: ScoreSpec, smem_limit: int) -> str:
    """K10's plan for a call of ``b`` lanes on a card whose blocks may opt in
    to ``smem_limit`` bytes of shared memory: "S" (one block, the state in
    shared memory) up to the crossover where it fits, else "L" (the
    cooperative grid)."""
    return ("S" if b <= BLOCK_PLAN_MAX_LANES and block_plan_bytes(b, spec) <= smem_limit
            else "L")


def spill_words(b: int, sms: int, grid: int = 0) -> int:
    """Plan L's per-lane spill at ``b`` lanes on a card of ``sms`` SMs (a
    grid cap ``grid`` > 0): 16 bytes a lane where a block may take more lanes
    than its threads carry in registers (at least one block an SM, or the
    cap, runs; each takes ceil(b / blocks) lanes rounded up to 32), else 0."""
    blocks = min(-(-b // GRID_LANES), sms, grid if grid > 0 else sms)
    per = -(-b // max(blocks, 1))
    return 4 * b if (per + 31) // 32 * 32 > REG_LANES * BLOCK_THREADS else 0


_SMEM_LIMIT: dict = {}


def smem_limit(device: torch.device) -> int:
    """The opt-in shared memory a block may use on ``device`` (a CUDA
    device, current), in bytes; the first call on a device also raises
    K10's shared-memory caps there (outside any graph capture: each graph the
    port captures runs once eagerly first)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SMEM_LIMIT:
        got = PREPARE.query(0)
        if got <= 0:
            raise RuntimeError(f"score_update: the set-up on cuda:{index} failed with error "
                               f"{-got}")
        _SMEM_LIMIT[index] = got
    return _SMEM_LIMIT[index]


def _check(who: str, ops: ScoreOps, wire, tenant, tflags) -> None:
    dev = wire.device
    spec = ops.spec
    if wire.dim() != 2 or wire.shape[1] not in (4, 7):
        raise ValueError(f"{who}: wire {tuple(wire.shape)}, expected (B, 4) or (B, 7)")
    B = wire.shape[0]
    if B >= 1 << 30:
        raise ValueError(f"{who}: {B} lanes, at most 2^30 - 1")
    st, m = ops.state, ops.model
    H, T, D = spec.hidden, spec.trees, spec.depth
    shapes = (
        ("skeys", st.skeys, (spec.slots, SCORE_KEY_WORDS), torch.int32),
        ("scols", st.scols, (spec.slots, 8), torch.int32),
        ("cms", st.cms, (spec.cms_depth, spec.cms_width), torch.int32),
        ("tstat", st.tstat, (spec.max_tenants, 4), torch.int32),
        ("epoch", st.epoch, (1,), torch.int32),
        ("fidx", m.fidx, (T, D), torch.int32), ("fthr", m.fthr, (T, D), torch.int32),
        ("leaf", m.leaf, (T * spec.leaves,), torch.int8),
        ("w1", m.w1, (SCORE_FEATURES, H), torch.int8), ("b1", m.b1, (H,), torch.int32),
        ("w2", m.w2, (H,), torch.int8), ("b2", m.b2, (1,), torch.int32),
        ("qshift", m.qshift, (2,), torch.int32),
        ("tparams", ops.tparams, (spec.max_tenants, 2), torch.int32),
        ("wire", wire, (B, wire.shape[1]), torch.int32),
        ("tenant", tenant, (B,), torch.int32), ("tflags", tflags, (B,), torch.int32),
    )
    for name, t, shape, dtype in shapes:
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous {dtype} on {dev}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{who}: {name} {tuple(t.shape)}, expected {shape}")
    scratch, words = ops.scratch, slot_scratch_words(spec)
    if scratch is not None and (scratch.device != dev or scratch.dtype != torch.int32
                                or scratch.dim() != 1 or not scratch.is_contiguous()
                                or scratch.shape[0] < words):
        raise ValueError(f"{who}: scratch must be a contiguous int32 vector of at least "
                         f"{words} words on {dev}")
    for name, t in (("skeys", st.skeys), ("scols", st.scols), ("cms", st.cms),
                    ("tstat", st.tstat), ("scratch", scratch)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{who}: {name} must be 16-byte aligned")
    if spec.slots & (spec.slots - 1) or spec.cms_width & (spec.cms_width - 1):
        raise ValueError(f"{who}: slots and cms_width must be powers of two")
    if spec.slots > 1 << 25:
        raise ValueError(f"{who}: at most 2^25 slots on the card, got {spec.slots}")


def _view(who: str, name: str, t, dev, words: int) -> None:
    if t.device != dev or t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{who}: {name} must be a contiguous int32 vector on {dev}")
    if t.shape[0] < words:
        raise ValueError(f"{who}: {name} has {t.shape[0]} words, needs {words}")


def kernel_args(ops: ScoreOps, wire, tenant, tflags, res, served, hit, scratch, spill, out,
                grid: int, plan: str) -> tuple:
    """The C entry's arguments but the stream (``served`` and ``hit`` None
    on the classic entry, ``spill`` None where plan L needs none)."""
    st, m, spec = ops.state, ops.model, ops.spec
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    return (ptr(wire), ptr(tenant), ptr(tflags), ptr(res), ptr(served), ptr(hit),
            ptr(st.skeys), ptr(st.scols), ptr(st.cms), ptr(st.tstat), ptr(st.epoch),
            ptr(m.fidx), ptr(m.fthr), ptr(m.leaf), ptr(m.w1), ptr(m.b1), ptr(m.w2), ptr(m.b2),
            ptr(m.qshift), ptr(ops.tparams), ptr(scratch), ptr(spill), ptr(out),
            wire.shape[0], wire.shape[1], spec.slots, spec.ways, spec.cms_depth,
            spec.cms_width, spec.max_tenants, spec.trees, spec.depth, spec.hidden, spec.sat,
            int(grid), PLANS[plan])


def _launch(kernel: "_build.Kernel", ops: ScoreOps, wire, tenant, tflags, res, served, hit,
            out, plan: Optional[str], grid: int) -> None:
    """Choose (or check a forced) plan, make what it needs and launch on
    ``wire``'s device, current."""
    B, dev, spec = wire.shape[0], wire.device, ops.spec
    limit = smem_limit(dev)
    if plan is None:
        plan = "L" if grid > 0 else plan_for(B, spec, limit)
    if plan not in PLANS:
        raise ValueError(f"{kernel.name}: plan {plan!r}, expected one of {sorted(PLANS)}")
    if plan == "S" and (grid > 0 or block_plan_bytes(B, spec) > limit):
        raise ValueError(f"{kernel.name}: plan S takes no grid cap and needs "
                         f"{block_plan_bytes(B, spec)} bytes of shared memory ({limit} on {dev})")
    scratch = ops.scratch if ops.scratch is not None else empty_scratch(spec, dev)
    spill = None
    if plan == "L":
        words = spill_words(B, torch.cuda.get_device_properties(dev).multi_processor_count, grid)
        if words:
            spill = torch.empty(words, dtype=torch.int32, device=dev)
    kernel.launch(*kernel_args(ops, wire, tenant, tflags, res, served, hit, scratch, spill, out,
                               grid, plan), torch.cuda.current_stream().cuda_stream)


def _launch_on(kernel: "_build.Kernel", ops: ScoreOps, wire, *rest) -> None:
    """_launch with ``wire``'s device current."""
    if wire.device.index is None or wire.device.index == torch.cuda.current_device():
        _launch(kernel, ops, wire, *rest)
    else:
        with torch.cuda.device(wire.device):
            _launch(kernel, ops, wire, *rest)


def score_update_out_plain(ops: ScoreOps, wire, tenant, tflags, res) -> torch.Tensor:
    """The classic entry's output from the plain version (on any device)."""
    score, anom, res_out = score_update_plain(ops.state, ops.model, ops.tparams, wire, tenant,
                                              tflags, res, ops.spec)
    return torch.cat([score, anom.to(torch.int32), wrap_int32(res_out)])


def score_update_resident_plain(ops: ScoreOps, wire, tenant, tflags, served, hit, res16,
                                out) -> None:
    """The resident entry in plain PyTorch (on any device): the merge, the
    plain update, and the words it writes (score_update_resident)."""
    from .flow import pack_bits32

    B = wire.shape[0]
    nw, nh = (B + 1) // 2, -(-B // 32)
    hit_m = unpack_bits32(hit[:nh], B)
    merged = torch.where(hit_m, unpack_res16(served[:nw], B), unpack_res16(res16[:nw], B))
    score, anom, res_out = score_update_plain(ops.state, ops.model, ops.tparams, wire, tenant,
                                              tflags, merged, ops.spec)
    words = _pack_res16(res_out)
    served[:nw].copy_(words)
    res16[:nw].copy_(words)
    out[:nh].copy_(pack_bits32(anom))
    out[nh: nh + nw].copy_(_pack_res16(score.clamp(-32768, 32767)))


def score_update(ops: ScoreOps, wire: torch.Tensor, tenant: torch.Tensor,
                 tflags: torch.Tensor, res: torch.Tensor, plan: Optional[str] = None,
                 grid: int = 0) -> torch.Tensor:
    """Kernel K10, classic entry: ``res`` (B,) int32 holding the u32
    verdicts.  Updates ``ops.state`` in place and returns the (3 B,) int32
    output [score, anom, res'] (``split_score_outputs``).  A CPU tensor runs
    score_update_plain; a CUDA tensor launches K10 (building it on first
    use) or raises.  ``plan`` "S" or "L" forces a plan, ``grid`` > 0 caps
    plan L's grid and selects plan L (tests); otherwise ``plan_for``
    chooses.  ``ops.scratch`` None: a fresh per-slot scratch (one fill)."""
    B = wire.shape[0]
    if wire.device.type == "cpu":
        return score_update_out_plain(ops, wire, tenant, tflags, res)
    if wire.device.type != "cuda":
        raise ValueError(f"score_update: unsupported device {wire.device}")
    _check("score_update", ops, wire, tenant, tflags)
    _view("score_update", "res", res, wire.device, B)
    out = torch.empty(score_out_words(B), dtype=torch.int32, device=wire.device)
    if B:
        _launch_on(KERNEL, ops, wire, tenant, tflags, res, None, None, out, plan, grid)
    return out


def score_update_resident(ops: ScoreOps, wire: torch.Tensor, tenant: torch.Tensor,
                          tflags: torch.Tensor, served: torch.Tensor, hit: torch.Tensor,
                          res16: torch.Tensor, out: torch.Tensor, plan: Optional[str] = None,
                          grid: int = 0) -> None:
    """Kernel K10, resident entry (a stage of kernels/resident.py's step,
    between K7 and K8): ``served`` the probe's ceil(B/2) packed res16 words,
    ``hit`` its ceil(B/32) bitmap words, ``res16`` the stateless classify's
    packed words; the lane's verdict is ``hit ? served : res16``.  Writes
    the policy's verdicts into both ``served`` and ``res16`` (the odd
    lane's pad half 0), and into ``out`` the anomaly bitmap (ceil(B/32)
    words) then the int16-saturated scores (ceil(B/2) words).  A CPU tensor
    runs the plain version; a CUDA tensor launches K10 or raises.  ``plan``
    and ``grid`` as ``score_update``."""
    B = wire.shape[0]
    nw, nh = (B + 1) // 2, -(-B // 32)
    if wire.device.type == "cpu":
        score_update_resident_plain(ops, wire, tenant, tflags, served, hit, res16, out)
        return
    if wire.device.type != "cuda":
        raise ValueError(f"score_update_resident: unsupported device {wire.device}")
    who = "score_update_resident"
    _check(who, ops, wire, tenant, tflags)
    for name, t, words in (("served", served, nw), ("hit", hit, nh), ("res16", res16, nw),
                           ("out", out, nh + nw)):
        _view(who, name, t, wire.device, words)
    if B == 0:
        return
    _launch_on(RESIDENT_KERNEL, ops, wire, tenant, tflags, res16, served, hit, out, plan, grid)
