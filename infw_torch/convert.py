"""Carry compiled table and arena state from the JAX package into the port.

``tables_from_jax_arrays`` takes the fields of the JAX package's
CompiledTables as plain values (numpy arrays, ints, and optionally the
content map) and returns the port's CompiledTables; ``arena_from_jax_arrays``
takes the seven arrays of a JAX arena pool and returns the port's
CtrieArena; ``flow_from_jax_arrays`` takes the four columns of a JAX flow
table with its generation and page vectors and returns the port's
FlowTable and those two vectors; ``sketch_state_from_jax`` takes the four
arrays of a JAX telemetry tier and returns the port's SketchState;
``score_state_from_jax`` and ``score_model_from_jax`` take a JAX scoring
tier's five arrays and a JAX ScoreModel and return the port's;
``ac_model_from_jax`` takes a JAX AcModel (the payload tier's compiled
automaton) and returns the port's.  None
imports anything from the JAX package: the caller
does ``{f: getattr(t, f) for f in FIELDS}`` (plus ``content``), or the same
over the pool's fields, on its side.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .arena import CtrieArena
from .kernels.flow import FlowTable
from .compiler import CompiledTables, LpmKey
from .kernels.torchpath import resolve_device

FIELDS = (
    "rule_width", "num_entries", "key_words", "mask_words", "mask_len", "rules",
    "trie_levels", "root_lut",
)


def tables_from_jax_arrays(d: Mapping) -> CompiledTables:
    """{rule_width, num_entries, key_words, mask_words, mask_len, rules,
    trie_levels, root_lut [, content]} -> CompiledTables.  ``content`` maps
    (prefix_len, ifindex, ip_data) keys — the JAX LpmKey is such a tuple —
    to (R, 7) rule rows."""
    missing = [f for f in FIELDS if f not in d]
    if missing:
        raise KeyError(f"tables_from_jax_arrays: missing fields {missing}")
    content = {
        LpmKey(int(k[0]), int(k[1]), bytes(k[2])): np.asarray(v, np.int32)
        for k, v in (d.get("content") or {}).items()
    }
    return CompiledTables(
        rule_width=int(d["rule_width"]),
        num_entries=int(d["num_entries"]),
        key_words=np.asarray(d["key_words"], np.uint32),
        mask_words=np.asarray(d["mask_words"], np.uint32),
        mask_len=np.asarray(d["mask_len"], np.int32),
        rules=np.asarray(d["rules"], np.int32),
        trie_levels=[np.asarray(t, np.int32) for t in d["trie_levels"]],
        root_lut=np.asarray(d["root_lut"], np.int32),
        content=content,
    )


def arena_from_jax_arrays(l0, nodes, targets, joined, root_lut, splice, page_table,
                          device=None) -> CtrieArena:
    """The seven pool arrays of a JAX ``CtrieArena`` (numpy, e.g. ``{f:
    np.asarray(getattr(alloc.arena, f)) for f in CtrieArena._fields}``) ->
    the port's CtrieArena on ``device`` (resolve_device), uint32 and uint16
    columns as int32 and int16 bit patterns."""
    device = resolve_device(device)

    def put(a, dtype, dev_dtype):
        a = np.require(np.asarray(a, dtype).view(dev_dtype), requirements="CW")
        return torch.from_numpy(a).to(device)

    return CtrieArena(
        l0=put(l0, np.int32, np.int32),
        nodes=put(nodes, np.uint32, np.int32),
        targets=put(targets, np.int32, np.int32),
        joined=put(joined, np.uint16, np.int16),
        root_lut=put(root_lut, np.int32, np.int32),
        splice=put(splice, np.int32, np.int32),
        page_table=put(page_table, np.int32, np.int32),
    )


def flow_from_jax_arrays(keys, vg, se, cnt, gens, page_table, device=None):
    """The columns of a JAX ``FlowTable`` (numpy: ``{f: np.asarray(getattr(
    flow, f)) for f in FlowTable._fields}``) and the tier's generation and
    page vectors -> (FlowTable, gens, page_table) on ``device``
    (resolve_device); the uint32 keys as int32 bit patterns, the insert's
    scratch cleared."""
    device = resolve_device(device)

    def put(a, dtype):
        a = np.require(np.asarray(a, dtype).view(np.int32), requirements="CW")
        return torch.from_numpy(a).to(device)

    keys_t = put(keys, np.uint32)
    flow = FlowTable(keys=keys_t, vg=put(vg, np.int32), se=put(se, np.int32),
                     cnt=put(cnt, np.int32),
                     winner=torch.full((keys_t.shape[0],), -1, dtype=torch.int32, device=device))
    return flow, put(gens, np.int32), put(page_table, np.int32)


def sketch_state_from_jax(cms, keys, cnt, tcnt, device=None):
    """The four arrays of a JAX telemetry ``SketchState`` (numpy: ``{f:
    np.asarray(getattr(tier._state, f)) for f in SketchState._fields}``) ->
    the port's SketchState on ``device`` (resolve_device): int32 tensors
    that share no memory with the arrays, the uint32 keys as int32 bit
    patterns."""
    from .kernels.sketch import SketchState

    device = resolve_device(device)

    def put(a, dtype):
        # a copy: the port updates the state in place, and on the CPU
        # from_numpy would share the caller's buffer
        return torch.from_numpy(np.array(a, dtype).view(np.int32)).to(device)

    return SketchState(cms=put(cms, np.int32), keys=put(keys, np.uint32),
                       cnt=put(cnt, np.int32), tcnt=put(tcnt, np.int32))


def score_state_from_jax(skeys, scols, cms, tstat, epoch, device=None):
    """The five arrays of a JAX scoring ``ScoreState`` (numpy) -> the port's
    ScoreState on ``device`` (resolve_device): int32 tensors that share no
    memory with the arrays, the uint32 keys as int32 bit patterns."""
    from .kernels.mxu_score import state_from_host

    return state_from_host({"skeys": skeys, "scols": scols, "cms": cms, "tstat": tstat,
                            "epoch": epoch}, resolve_device(device))


def score_model_from_jax(model):
    """A JAX ``ScoreModel`` (its spec a NamedTuple of the same fields, its
    value arrays numpy) -> the port's ScoreModel, validated."""
    from .kernels.mxu_score import MODEL_FIELDS, ScoreModel, ScoreSpec, validate_model

    spec = ScoreSpec.make(**dict(model.spec._asdict()))
    out = ScoreModel(spec, *(np.array(getattr(model, f)) for f in MODEL_FIELDS),
                     version=str(model.version))
    validate_model(out)
    return out


def ac_model_from_jax(model):
    """A JAX ``AcModel`` (its spec a NamedTuple of the same fields, its
    ``delta`` and ``matchmap`` numpy) -> the port's AcModel with copies of
    its arrays and its patterns."""
    from .kernels.acmatch import AcModel, AcSpec

    spec = AcSpec(**dict(model.spec._asdict()))
    delta = np.array(model.delta, np.int32)
    matchmap = np.array(model.matchmap, np.uint32)
    if delta.shape != (spec.states, 256) or matchmap.shape != (spec.states, spec.pwords):
        raise ValueError(f"automaton arrays {delta.shape} / {matchmap.shape} do not fit {spec}")
    return AcModel(spec, delta, matchmap, tuple(bytes(p) for p in model.patterns))
