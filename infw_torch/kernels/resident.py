"""The resident step: one admission's device work as one fixed sequence on
one stream, and the superbatch of K such steps.

Counterpart of the JAX package's ``jaxpath._resident_step_core``,
``jitted_resident_step``, ``jitted_resident_superbatch``,
``split_resident_outputs`` and ``resident_fused_host``.  There the step is
one XLA program whose flow columns and epoch are donated; here it is a
sequence of hand kernels that updates the flow columns and a (1,) int32
device epoch in place, and that a CUDA graph captures whole (the pool in
``infw_torch/resident.py`` replays it):

1. K7 through its resident entry (kernels/flow.py): the probe at the
   device epoch + 1, written into the first words of the fused output;
2. the path's fused wire entry over every lane, on the same table
   snapshot: K1 (``dense.classify_dense_wire_fused``), K2
   (``walk.classify_walk_wire_fused`` at the plan's level count), K3
   (``cwalk.classify_ctrie_wire_fused``), or the overlay combine
   (``overlay.classify_overlay_wire_fused``) when an overlay is live; its
   first ceil(B/2) words are the stateless results as 16-bit words, ``res
   & 0xFFFF`` (its statistics are not read: the host derives them from the
   merged verdicts and the pkt_len column, the wire8 contract);
3. K8 through its resident entry: the merge ``where(hit, served, res &
   0xFFFF)`` into the fused output's result words, the insert of the lanes
   that missed (``lane_ok = ~hit``, the same eligible lanes in the same
   order as the host's compaction of the misses), its counts into the
   fused output, and the device epoch advanced;
3a. with the anomaly-scoring tier on (``ops.score``, a
   kernels.mxu_score.ScoreOps), between 2 and 3, K10 through its resident
   entry: the merge computed from the probe's words, its hit bitmap and
   the stateless words, scored (``_score_update_core`` on ``merged``), the
   policy's verdicts ``merged2`` written into both the probe's and the
   stateless words, so K8's merge yields ``merged2`` on every lane and
   caches it for the misses, and K9 counts it;
3b. with the payload tier on (``ops.payload``, a kernels.acmatch.PayloadOps
   carrying the admission's payload column), after 3a and before 3, K11
   through its resident entry: the merge from the same words, the
   Aho-Corasick walk of each lane's prefix, the enforce rewrite
   (``_payload_merge_core`` on ``merged2``), the verdicts ``merged3``
   written into both word vectors as 3a does, and the matched and rewritten
   lanes' bitmaps into the last 2 ceil(B/32) words of the fused output;
4. with the telemetry plane on (``ops.sketch``, obs.telemetry.SketchOps),
   K9 through its resident entry (kernels/sketch.py): the sketch update
   over every lane with the merged verdicts K8 wrote (the served verdicts,
   ``_sketch_update_core`` on ``merged3``); the bucket's KIND_OTHER
   padding rows touch nothing (and their payload length is 0).

The fused output is JAX's word layout: ceil(B/2) words of u16-pair-packed
merged results, ceil(B/32) words of the hit bitmap, [hits, stale], then
[inserts, evictions, promotes, 0], and with scoring on the anomaly
bitmap (ceil(B/32) words) and the int16-saturated scores (ceil(B/2)
words), and with the payload tier the matched-lane then the rewritten-lane
bitmaps (ceil(B/32) words each, always the last words).  On CPU tensors
every entry runs its
plain version; on CUDA tensors the kernels (nothing here syncs with the
host, so the sequence captures into a graph).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from . import acmatch as kac
from . import cwalk, dense, overlay, walk
from . import flow as kflow
from . import mxu_score as kscore
from . import sketch as ksketch
from .torchpath import unpack_res16_host


class StepTables(NamedTuple):
    """The stateless half of a step: the path, its device tables, the
    overlay's (None without one) and the trie path's level count (None on
    the other paths)."""

    path: str  # "dense" | "trie" | "ctrie"
    dev: Union[dense.DenseTables, walk.TrieTables, cwalk.CTrieTables]
    ov: Optional[overlay.OverlayTables] = None
    n_levels: Optional[int] = None


def resident_out_words(b: int, score: bool = False, payload: bool = False) -> int:
    """Words of a step's fused output for ``b`` lanes (``score``: with the
    scoring extension, ``payload``: with the payload tail)."""
    nw, nh = (b + 1) // 2, -(-b // 32)
    return nw + nh + 6 + ((nh + nw) if score else 0) + (2 * nh if payload else 0)


def stateless_res16(tables: StepTables, wire: torch.Tensor) -> torch.Tensor:
    """The path's fused wire entry over every lane of ``wire`` (B, 4 | 7);
    the returned buffer's first ceil(B/2) words are the packed ``res &
    0xFFFF``."""
    if tables.ov is not None:
        return overlay.classify_overlay_wire_fused(tables.dev, tables.ov, wire, tables.n_levels)
    if tables.path == "dense":
        return dense.classify_dense_wire_fused(tables.dev, wire)
    if tables.path == "ctrie":
        return cwalk.classify_ctrie_wire_fused(tables.dev, wire)
    return walk.classify_walk_wire_fused(tables.dev, wire, tables.n_levels)


def resident_step(ops, tables: StepTables, wire: torch.Tensor,
                  out: Optional[torch.Tensor] = None,
                  scratch: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One admission (jaxpath._resident_step_core): ``ops`` is the flow
    tier's flow.ResidentOps (columns, generation and page operands, device
    epoch, tenant and flag columns, geometry, the telemetry plane's
    operands or None, the scoring tier's or None), ``wire`` the (B, 4 | 7)
    int32 wire.  Updates the columns and the device epoch in place; writes
    and returns the fused output (``out``, at least resident_out_words(B)
    words, allocated when None).  ``scratch`` is the kernels' (B, 2) lane
    scratch (allocated when None)."""
    B = wire.shape[0]
    nw, nh = (B + 1) // 2, -(-B // 32)
    words = resident_out_words(B, ops.score is not None, ops.payload is not None)
    if out is None:
        out = torch.empty(words, dtype=torch.int32, device=wire.device)
    geo = {"slab_entries": ops.slab_entries, "ways": ops.ways}
    kflow.flow_probe_resident(ops.flow, ops.gens, ops.pages, wire, ops.tenant, ops.tflags,
                              ops.epoch_dev, ops.max_age, out[: nw + nh + 2], scratch, **geo)
    res16 = stateless_res16(tables, wire)
    if ops.score is not None:
        kscore.score_update_resident(ops.score, wire, ops.tenant, ops.tflags, out[:nw],
                                     out[nw: nw + nh], res16[:nw], out[nw + nh + 6: words])
    if ops.payload is not None:
        kac.acmatch_resident(ops.payload, wire, out[:nw], out[nw: nw + nh], res16[:nw],
                             out[words - 2 * nh: words])
    kflow.flow_insert_resident(ops.flow, ops.gens, ops.pages, wire, ops.tenant, ops.tflags,
                               res16[:nw], out[nw: nw + nh], out[:nw],
                               out[nw + nh + 2: nw + nh + 6], ops.epoch_dev, scratch, **geo)
    if ops.sketch is not None:
        sk = ops.sketch
        ksketch.sketch_update_resident(sk.state, wire, ops.tenant, ops.tflags, out[:nw], sk.spec,
                                       winner=sk.winner)
    return out[:words]


def resident_superbatch(ops, tables: StepTables, wire: torch.Tensor,
                        out: Optional[torch.Tensor] = None,
                        scratch: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K admissions in one sequence (jaxpath.jitted_resident_superbatch):
    ``wire`` (K, B, W), ``ops.tenant`` and ``ops.tflags`` (K, B); step j
    serves the device epoch as step j - 1 left it.  Returns the (K, L)
    fused outputs (``out`` when given)."""
    K, B = wire.shape[0], wire.shape[1]
    L = resident_out_words(B, ops.score is not None, ops.payload is not None)
    if out is None:
        out = torch.empty((K, L), dtype=torch.int32, device=wire.device)
    for j in range(K):
        step_ops = ops._replace(tenant=ops.tenant[j], tflags=ops.tflags[j])
        if ops.payload is not None:
            step_ops = step_ops._replace(payload=ops.payload._replace(
                pay=ops.payload.pay[j], plen=ops.payload.plen[j]))
        resident_step(step_ops, tables, wire[j], out[j], scratch)
    return out


def split_resident_outputs(arr: np.ndarray, b: int):
    """Host inverse of a step's fused output -> (res16[b], hit mask (b,)
    bool, hits, stale, (inserts, evictions, promotes))."""
    nw, nh = (b + 1) // 2, -(-b // 32)
    res16 = unpack_res16_host(arr[:nw], b)
    hit = kflow.unpack_bits32_host(arr[nw: nw + nh], b)
    counts = tuple(int(x) for x in arr[nw + nh + 2: nw + nh + 5])
    return res16, hit, int(arr[nw + nh]), int(arr[nw + nh + 1]), counts


def split_resident_score_outputs(arr: np.ndarray, b: int):
    """Host inverse of a scoring step's fused output -> (res16[b], the
    policy's verdicts; hit mask; hits; stale; (inserts, evictions,
    promotes); anom mask (b,) bool; scores (b,) int32 from the int16
    read back)."""
    nw, nh = (b + 1) // 2, -(-b // 32)
    res16, hit, hits, stale, counts = split_resident_outputs(arr[: nw + nh + 6], b)
    base = nw + nh + 6
    anom = kflow.unpack_bits32_host(arr[base: base + nh], b)
    s16 = unpack_res16_host(np.ascontiguousarray(arr[base + nh: base + nh + nw]), b)
    scores = s16.astype(np.uint16).astype(np.int16).astype(np.int32)
    return res16, hit, hits, stale, counts, anom, scores


def split_resident_payload_outputs(arr: np.ndarray, b: int, score: bool = False):
    """Host inverse of a payload step's fused output: the split_resident_
    outputs (``score``: split_resident_score_outputs) tuple with the matched
    and rewritten lanes' masks (b,) bool appended.  The payload tail is the
    last 2 ceil(b/32) words whatever rides before it, so it anchors from
    the end."""
    arr = np.asarray(arr)
    nh = -(-b // 32)
    base, tail = arr[: arr.shape[0] - 2 * nh], arr[arr.shape[0] - 2 * nh:]
    head = split_resident_score_outputs(base, b) if score else split_resident_outputs(base, b)
    return head + (kflow.unpack_bits32_host(tail[:nh], b),
                   kflow.unpack_bits32_host(tail[nh:], b))


def split_resident_step_outputs(arr: np.ndarray, b: int, score: bool, payload: bool):
    """Any step's fused output -> (res16, hit, hits, stale, (inserts,
    evictions, promotes), anom, scores, pay_hit, pay_rw), the parts of a
    tier that is off None."""
    if payload:
        parts = split_resident_payload_outputs(arr, b, score)
        head, tail = parts[:-2], parts[-2:]
    else:
        head = (split_resident_score_outputs(arr, b) if score
                else split_resident_outputs(arr, b))
        tail = (None, None)
    if not score:
        head = head + (None, None)
    return head + tail


def resident_fused_host(fused) -> np.ndarray:
    """The host words of one admission: a dispatch handle (``.host()``) or
    a (handle, row) pair naming one row of a superbatch's (K, L) output.
    Blocks until the dispatch has landed."""
    if isinstance(fused, tuple):
        stack, row = fused
        return stack.host()[int(row)]
    return fused.host()
