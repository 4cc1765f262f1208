"""The port's trie half of the compiler, its host layouts, generators,
oracle and packing helpers against the JAX package, on the same seeded
content.  Everything is integers: every comparison is byte equality."""
import dataclasses

import numpy as np
import pytest

from infw import compiler as jax_compiler
from infw import oracle as jax_oracle
from infw import testing as jax_testing
from infw.kernels import jaxpath
from infw_torch import compiler, convert, layout, oracle, testing
from infw_torch.packets import PacketBatch

BATCH_FIELDS = (
    "kind", "l4_ok", "ifindex", "ip_words", "proto", "dst_port",
    "icmp_type", "icmp_code", "pkt_len",
)


def port_batch(batch):
    return PacketBatch(**{f: getattr(batch, f) for f in BATCH_FIELDS})


def _rows(rng, width=6):
    return jax_testing.random_rules(rng, width)


def _aliased_content(rng):
    """Aliased keys (equal masked identity: first position, last writer),
    a v4 /0 on each of three ifindexes, /128s, and mid-stride prefixes."""
    keys = [
        (40, 2, bytes([10, 1]) + bytes(14)),
        (40, 2, bytes([10, 9, 9, 9]) + bytes(12)),       # aliases the /8 above
        (32, 2, bytes([1, 2, 3, 4]) + bytes(12)),        # v4 /0
        (32, 2, bytes(16)),                              # aliases that /0
        (32, 3, bytes(16)),                              # /0 on ifindex 3
        (32, 4, bytes([7]) + bytes(15)),                 # /0 on ifindex 4
        (160, 2, bytes(range(16))),                      # /128
        (160, 4, bytes(range(16, 32))),
        (49, 3, bytes([172, 16, 0x80]) + bytes(13)),     # /17
        (55, 2, bytes([10, 1, 2, 0xFE]) + bytes(12)),    # /23
        (64, 2, bytes([10, 1, 2, 3]) + bytes(12)),       # /32
        (96, 3, bytes([0x20, 1, 0xd, 0xb8]) + bytes(12)),  # /64
        (88, 3, bytes([0x20, 1, 0xd, 0xb8, 0, 0, 0x12]) + bytes(9)),  # /56
    ]
    return {k: _rows(rng) for k in keys}


def _random_content(n, seed, v6_fraction=0.5):
    t = jax_testing.random_tables_fast(np.random.default_rng(seed), n, ifindexes=(2, 3, 4),
                                       width=8, group_size=6, v6_fraction=v6_fraction)
    return dict(t.content)


CASES = {
    # name: (content, rule_width, min_trie_levels)
    "aliased": (lambda: _aliased_content(np.random.default_rng(1)), 6, 1),
    "forced_15_levels": (lambda: dict(list(_aliased_content(np.random.default_rng(2)).items())[:6]),
                         6, 15),
    "single_level": (lambda: dict(list(_aliased_content(np.random.default_rng(3)).items())[:6]),
                     6, 1),
    "random_2500": (lambda: _random_content(2500, 4), 8, 1),
    "bulk_build_5000": (lambda: _random_content(5000, 5), 8, 1),
    "empty": (lambda: {}, 4, 1),
}


def _compile_both(case):
    make, width, min_levels = CASES[case]
    content = make()
    jt = jax_compiler.compile_tables_from_content(
        {jax_compiler.LpmKey(*k): v for k, v in content.items()}, rule_width=width,
        min_trie_levels=min_levels)
    pt = compiler.compile_tables_from_content(
        {compiler.LpmKey(*k): v for k, v in content.items()}, rule_width=width,
        min_trie_levels=min_levels)
    return jt, pt


@pytest.mark.parametrize("case", sorted(CASES))
def test_compiled_tables_match_jax(case):
    """trie_levels and root_lut byte-identical to the JAX compiler (and the
    dense arrays and content map as before)."""
    jt, pt = _compile_both(case)
    assert (pt.num_entries, pt.rule_width, pt.levels) == (jt.num_entries, jt.rule_width, jt.levels)
    for f in ("key_words", "mask_words", "mask_len", "rules", "root_lut"):
        a, b = getattr(pt, f), getattr(jt, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for a, b in zip(pt.trie_levels, jt.trie_levels):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert {tuple(k): np.asarray(v).tolist() for k, v in pt.content.items()} == {
        tuple(k): np.asarray(v).tolist() for k, v in jt.content.items()
    }
    if case == "forced_15_levels":
        assert pt.levels == 15
    if case == "aliased":
        assert pt.num_entries == len(CASES[case][0]()) - 2


@pytest.mark.parametrize("case", sorted(CASES))
def test_layouts_match_jax(case):
    """build_poptrie, build_depth_lut, the depth histogram and the tuned
    classes byte-identical to jaxpath, memoized on the tables."""
    jt, pt = _compile_both(case)
    jl, jtg = jaxpath.build_poptrie(jt)
    pl_, ptg = layout.build_poptrie(pt)
    assert len(pl_) == len(jl)
    for a, b in zip(pl_, jl):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert ptg.dtype == jtg.dtype and np.array_equal(ptg, jtg)
    assert layout.build_poptrie(pt)[1] is ptg
    lut = layout.build_depth_lut(pt)
    assert lut.dtype == np.int8 and np.array_equal(lut, jaxpath.build_depth_lut(jt))
    assert np.array_equal(layout.depth_class_histogram(pt), jaxpath.depth_class_histogram(jt))
    classes = layout.tune_depth_classes(pt)
    assert classes == jaxpath.tune_depth_classes(jt)
    assert layout.tune_depth_classes(pt) is classes
    assert layout.depth_classes(pt.levels) == jaxpath.depth_classes(jt.levels)


def test_depth_groups_and_v4_depth_match_jax():
    content = _random_content(2500, 6, v6_fraction=0.6)
    jt = jax_compiler.compile_tables_from_content(content, rule_width=8)
    pt = compiler.compile_tables_from_content(
        {compiler.LpmKey(*k): v for k, v in content.items()}, rule_width=8)
    batch = jax_testing.random_batch_fast(np.random.default_rng(7), jt, 2048)
    batch.ifindex[:5] = [-3, 10_000_000, 9, 2, 3]  # out of the LUT, unknown, known
    idx6 = np.nonzero(batch.kind == 2)[0]
    args = (batch.ifindex, batch.ip_words, idx6)
    for classes in (layout.tune_depth_classes(pt), (0, 3, 7, 14), (14,)):
        want = jaxpath.depth_group_indices(np.asarray(jt.root_lut, np.int64),
                                           jaxpath.build_depth_lut(jt), classes, *args)
        got = layout.depth_group_indices(np.asarray(pt.root_lut, np.int64),
                                         layout.build_depth_lut(pt), classes, *args)
        assert [d for d, _ in got] == [d for d, _ in want]
        for (_, a), (_, b) in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert sum(len(g) for _, g in got) == len(idx6)
    for n in range(1, 16):
        assert layout.v4_trie_depth(n) == jaxpath.v4_trie_depth(n)


def test_wire_ruleid_check_matches_jax():
    rng = np.random.default_rng(8)
    rules = jax_testing.random_rules_bulk(rng, 50, 9)
    wide = rules.copy()
    wide[3, 2, 0] = 300

    def outcome(check, tables):
        try:
            check(tables)
        except ValueError as e:
            return str(e)
        return None

    for r, refused in ((rules, False), (wide, True)):
        t = dataclasses.replace(compiler.compile_tables_from_content({}), rules=r)
        jtt = dataclasses.replace(jax_compiler.compile_tables_from_content({}), rules=r)
        got = outcome(layout.check_wire_ruleids, t)
        assert got == outcome(jaxpath.check_wire_ruleids, jtt)
        assert (got is not None) == refused


def test_generators_match_jax():
    """random_tables_fast and random_rules_bulk draw the same numbers."""
    jt = jax_testing.random_tables_fast(np.random.default_rng(9), 1500, ifindexes=(2, 3, 4),
                                        width=8)
    pt = testing.random_tables_fast(np.random.default_rng(9), 1500, ifindexes=(2, 3, 4),
                                    width=8)
    assert [tuple(k) for k in pt.content] == [tuple(k) for k in jt.content]
    for a, b in zip(pt.content.values(), jt.content.values()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(pt.trie_levels, jt.trie_levels):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        testing.random_rules_bulk(np.random.default_rng(1), 30, 12),
        jax_testing.random_rules_bulk(np.random.default_rng(1), 30, 12),
    )


def test_columns_build_matches_jax():
    cols = jax_testing.clean_columns_fast(np.random.default_rng(10), 3000, ifindexes=(2, 5))
    jt = jax_compiler.compile_tables_from_columns(cols, rule_width=4)
    pcols = compiler.TableColumns(cols.prefix_len, cols.ifindex, cols.ip, cols.rules)
    pt = compiler.compile_tables_from_columns(pcols, rule_width=4)
    for f in ("key_words", "mask_words", "mask_len", "rules", "root_lut"):
        np.testing.assert_array_equal(getattr(pt, f), getattr(jt, f), err_msg=f)
    for a, b in zip(pt.trie_levels, jt.trie_levels):
        np.testing.assert_array_equal(a, b)
    assert len(pt.content) == len(jt.content) == 3000
    assert all(np.array_equal(pt.content[k], jt.content[k]) for k in list(pt.content)[:50])


def test_convert_round_trips_trie_fields():
    jt = jax_testing.random_tables_fast(np.random.default_rng(11), 800, width=6)
    d = {f: getattr(jt, f) for f in convert.FIELDS}
    d["content"] = jt.content
    pt = convert.tables_from_jax_arrays(d)
    assert pt.levels == jt.levels
    for a, b in zip(pt.trie_levels, jt.trie_levels):
        assert a.dtype == np.int32 and np.array_equal(a, b)
    np.testing.assert_array_equal(pt.root_lut, jt.root_lut)
    assert layout.tune_depth_classes(pt) == jaxpath.tune_depth_classes(jt)
    with pytest.raises(KeyError, match="trie_levels"):
        convert.tables_from_jax_arrays({k: v for k, v in d.items() if k != "trie_levels"})


def test_indexed_oracle_matches_jax_oracle():
    """The oracle's (ifindex, mask_len) index gives the scalar scan's
    answers on a 3000-entry table, v4 /0 cross-family hits included."""
    content = _random_content(3000, 12, v6_fraction=0.4)
    content.update(_aliased_content(np.random.default_rng(13)))
    jt = jax_compiler.compile_tables_from_content(
        {jax_compiler.LpmKey(*k): v for k, v in content.items()}, rule_width=8)
    pt = compiler.compile_tables_from_content(
        {compiler.LpmKey(*k): v for k, v in content.items()}, rule_width=8)
    batch = jax_testing.random_batch_fast(np.random.default_rng(14), jt, 1500)
    ref = jax_oracle.classify(jt, batch)
    got = oracle.classify(pt, port_batch(batch))
    np.testing.assert_array_equal(got.results, ref.results)
    np.testing.assert_array_equal(got.xdp, ref.xdp)
    assert got.stats == ref.stats
    assert (got.results != 0).sum() > 300


def test_pack_wire_subset_matches_jax():
    jt = jax_testing.random_tables_fast(np.random.default_rng(15), 300, width=6)
    batch = jax_testing.random_batch_fast(np.random.default_rng(16), jt, 500)
    pb = port_batch(batch)
    v4 = np.nonzero((batch.kind != 2) & ~batch.ip_words[:, 1:].any(axis=1))[0]
    for idx in (np.arange(500), v4, np.nonzero(batch.kind == 2)[0][:7], v4[:0]):
        jw, jv4 = batch.pack_wire_subset(idx)
        pw, pv4 = pb.pack_wire_subset(idx)
        assert pv4 == jv4 and pw.dtype == jw.dtype
        np.testing.assert_array_equal(pw, jw)
