"""Carry compiled table state from the JAX package into the port.

``tables_from_jax_arrays`` takes the fields of the JAX package's
CompiledTables as plain values (numpy arrays, ints, and optionally the
content map) and returns the port's CompiledTables.  It imports nothing
from the JAX package: the caller does ``{f: getattr(t, f) for f in
FIELDS}`` (plus ``content``) on its side.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np

from .compiler import CompiledTables, LpmKey

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
