"""The port's incremental tables and device patches on the CPU against the
JAX package: IncrementalTables snapshots and dirty hints array for array,
LazyContent, the padded uploads, walk.patch_trie_tables and
cwalk.patch_ctrie against fresh padded builds, and TorchClassifier against
TpuClassifier(interpret=True, fused_deep=True) over the same sequence of
hinted loads.  Every comparison is exact (integers, tolerance 0)."""
import numpy as np
import pytest
import torch

from infw import compiler as jax_compiler
from infw import testing as jax_testing
from infw.backend.tpu import TpuClassifier
from infw.kernels import jaxpath
from infw_torch import compiler, layout, oracle, testing
from infw_torch.backend.cuda import TorchClassifier
from infw_torch.kernels import cwalk, torchpath, walk
from test_compiler import _random_content
from test_torch_walk import port_batch

ROUNDS = 6


def _port_content(content):
    return {compiler.LpmKey(*k): np.array(v) for k, v in content.items()}


def _snapshots_equal(p, j):
    assert (p.num_entries, p.rule_width) == (j.num_entries, j.rule_width)
    for f in ("key_words", "mask_words", "mask_len", "rules", "root_lut"):
        np.testing.assert_array_equal(getattr(p, f), getattr(j, f), err_msg=f)
    assert len(p.trie_levels) == len(j.trie_levels)
    for a, b in zip(p.trie_levels, j.trie_levels):
        np.testing.assert_array_equal(a, b)


def _hints_equal(p, j):
    if j is None:
        assert p is None
        return
    np.testing.assert_array_equal(p["dense"], j["dense"])
    assert len(p["levels"]) == len(j["levels"])
    for a, b in zip(p["levels"], j["levels"]):
        np.testing.assert_array_equal(a, b)


def _churn_round(rng, content, r):
    """Round ``r`` of the JAX churn tests (test_backends.py:488-527): even
    rounds delete 4 keys and add 5; odd rounds rewrite 3 live keys' rules
    (rules-only).  Returns (upserts, deletes), applied to ``content``."""
    keys = list(content)
    if r % 2 == 0:
        dels = [keys[int(i)] for i in rng.choice(len(keys), size=4, replace=False)]
        for k in dels:
            del content[k]
        adds = _random_content(rng, 5)
        content.update(adds)
        return adds, dels
    ups = {}
    for i in rng.choice(len(keys), size=3, replace=False):
        rows = np.array(content[keys[int(i)]])
        rows[1, 2] = int(rng.integers(1, 65000))
        rows[1, 6] = 3 - rows[1, 6]
        ups[keys[int(i)]] = rows
    content.update(ups)
    return ups, []


@pytest.mark.parametrize("seed", [70, 72])
def test_incremental_tables_match_jax(seed):
    """Snapshots and peek_dirty() equal the JAX package's after every
    churn round, then across a maybe_compact that rebuilds the tables."""
    rng = np.random.default_rng(seed)
    content = _random_content(rng, 80)
    jit = jax_compiler.IncrementalTables.from_content(content, rule_width=4)
    pit = compiler.IncrementalTables.from_content(_port_content(content), rule_width=4)
    assert pit.peek_dirty() is None and jit.peek_dirty() is None  # no device baseline yet
    _snapshots_equal(pit.snapshot(), jit.snapshot())
    jit.clear_dirty()
    pit.clear_dirty()
    for r in range(ROUNDS):
        ups, dels = _churn_round(rng, content, r)
        jit.apply(ups, deletes=dels)
        pit.apply(_port_content(ups), deletes=[compiler.LpmKey(*k) for k in dels])
        _snapshots_equal(pit.snapshot(), jit.snapshot())
        _hints_equal(pit.peek_dirty(), jit.peek_dirty())
        assert layout.hint_trie_unchanged(pit.peek_dirty()) == (r % 2 == 1)
        jit.clear_dirty()
        pit.clear_dirty()
    # shrink below half live, then the compaction rebuild
    keys = list(content)
    dels = keys[: len(keys) - 20]
    jit.apply({}, deletes=dels)
    pit.apply({}, deletes=[compiler.LpmKey(*k) for k in dels])
    assert pit.maybe_compact() is jit.maybe_compact() is True
    _snapshots_equal(pit.snapshot(), jit.snapshot())
    assert pit.peek_dirty() is None and jit.peek_dirty() is None  # invalid until cleared
    snap = pit.snapshot()
    assert len(snap.content) == 20
    ref = compiler.compile_tables_from_content(snap.content, rule_width=4)
    batch = testing.random_batch_fast(rng, ref, 300)
    np.testing.assert_array_equal(oracle.classify(snap, batch).results,
                                  oracle.classify(ref, batch).results)


def test_incremental_edits_validate_before_writing():
    """A bad key leaves the instance untouched; a mask past the trie depth
    asks for a rebuild; fits() says so first; a consumed snapshot ends the
    instance."""
    content = _port_content(_random_content(np.random.default_rng(3), 20))
    it = compiler.IncrementalTables.from_content(content, rule_width=4)
    before = it.snapshot()
    good = next(iter(content))
    with pytest.raises(compiler.CompileError, match="ifindex"):
        it.apply({good: np.zeros((4, 7), np.int32),
                  compiler.LpmKey(64, -1, bytes(16)): np.zeros((4, 7), np.int32)})
    _snapshots_equal(it.snapshot(), before)
    deep = {compiler.LpmKey(32 + 96, 2, bytes(16)): np.zeros((4, 7), np.int32)}
    assert not it.fits(deep) and it.fits(content)
    with pytest.raises(compiler.CompileError, match="rebuild"):
        it.apply(deep)
    it.snapshot(consume=True)
    with pytest.raises(compiler.CompileError, match="snapshot"):
        it.apply({})


def test_lazy_content():
    """LazyContent hands its columns over untouched, builds the same map
    as the eager build on first access, and stops vouching for its columns
    once built; compile_tables_from_columns and a columnar
    IncrementalTables keep their content lazy until read or edited."""
    cols = testing.clean_columns_fast(np.random.default_rng(4), 500, width=4)
    t = compiler.compile_tables_from_columns(cols, rule_width=4)
    assert isinstance(t.content, compiler.LazyContent)
    passed = compiler.columns_from_content(t.content)
    assert passed.ip is t.content._cols[2] and passed.rules is t.content._cols[3]
    assert len(t.content) == 500 and t.content._d is None
    eager = {compiler.LpmKey(int(cols.prefix_len[i]), int(cols.ifindex[i]),
                             cols.ip[i].tobytes()): cols.rules[i] for i in range(500)}
    assert list(t.content) == list(eager)
    assert all(np.array_equal(t.content[k], v) for k, v in eager.items())
    assert t.content.columns() is None
    it = compiler.IncrementalTables.from_columns(cols, rule_width=4)
    assert it._content is None and isinstance(it.snapshot().content, compiler.LazyContent)
    key = next(iter(eager))
    it.apply({key: np.zeros((4, 7), np.int32)})
    assert it._content is not None and not it.snapshot().content[key].any()


def _fresh_equal(patched, fresh):
    assert type(patched) is type(fresh)
    for f in fresh._fields:
        a, b = getattr(patched, f), getattr(fresh, f)
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f
        else:
            assert a == b, f


PATCHES = {
    "trie": (walk.build_trie_tables, walk.patch_trie_tables),
    "ctrie": (cwalk.build_ctrie_tables, cwalk.patch_ctrie),
}


@pytest.mark.parametrize("hinted", [True, False], ids=["hint", "diff"])
@pytest.mark.parametrize("layout_name", ["trie", "ctrie"])
def test_device_patches_equal_fresh_padded_builds(layout_name, hinted):
    """walk.patch_trie_tables / cwalk.patch_ctrie over the churn rounds,
    with and without the dirty hint: every round's resident tables equal a
    fresh padded build of the snapshot bit for bit, and rules-only rounds
    patch."""
    build, patch = PATCHES[layout_name]
    rng = np.random.default_rng(72)
    content = _port_content(_random_content(rng, 60))
    it = compiler.IncrementalTables.from_content(content, rule_width=4)
    prev = it.snapshot()
    dev = build(prev, "cpu", pad=True)
    it.clear_dirty()
    modes = []
    for r in range(ROUNDS):
        ups, dels = _churn_round(rng, content, r)
        it.apply(ups, deletes=dels)
        new = it.snapshot()
        out = patch(dev, prev, new, "cpu", hint=it.peek_dirty() if hinted else None)
        fresh = build(new, "cpu", pad=True)
        modes.append("full" if out is None else "patch")
        dev = fresh if out is None else out[0]
        _fresh_equal(dev, fresh)
        it.clear_dirty()
        prev = new
    assert modes[1::2] == ["patch"] * (ROUNDS // 2)  # rules-only rounds
    if layout_name == "trie":
        assert modes == ["patch"] * ROUNDS  # structural rounds re-upload arrays, not all


def test_rules_only_hint_shares_the_structure():
    """A rules-only hinted patch ships only the dirty rule rows and keeps
    the node levels, targets and DIR-16 slots by reference; the new
    generation inherits the old one's host layouts."""
    rng = np.random.default_rng(9)
    content = _port_content(_random_content(rng, 60))
    it = compiler.IncrementalTables.from_content(content, rule_width=4)
    old = it.snapshot()
    tt = walk.build_trie_tables(old, "cpu", pad=True)
    ct = cwalk.build_ctrie_tables(old, "cpu", pad=True)
    it.clear_dirty()
    ups, _ = _churn_round(rng, content, 1)
    it.apply(ups)
    new, hint = it.snapshot(), it.peek_dirty()
    ptt, n_trie = walk.patch_trie_tables(tt, old, new, "cpu", hint=hint)
    pct, n_ctrie = cwalk.patch_ctrie(ct, old, new, "cpu", hint=hint)
    assert n_trie == 2 * 3 and n_ctrie == 3  # rules + mask_len rows; joined rows
    for f in ("l0", "deep", "targets", "root_lut", "level_rows"):
        assert getattr(ptt, f) is getattr(tt, f), f
    for f in ("l0", "nodes", "targets", "root_lut"):
        assert getattr(pct, f) is getattr(ct, f), f
    assert new._poptrie_cache is old._poptrie_cache
    assert new._cpoptrie_cache is old._cpoptrie_cache
    np.testing.assert_array_equal(new._joined_tidx_cache, layout._joined_by_tidx(new))


@pytest.mark.parametrize("pad", [False, True], ids=["unpadded", "padded"])
def test_padded_uploads_match_jax_and_root_lut_padding(pad):
    """The padded layouts equal the JAX package's padded uploads where the
    layouts are shared, and classification is the same on padded and
    unpadded tables for ifindexes inside the root LUT's padding and past
    it (the walks mask an ifindex outside the LUT rather than clip it)."""
    rng = np.random.default_rng(11)
    jt = jax_testing.random_tables(np.random.default_rng(12), n_entries=60, width=4,
                                   v6_fraction=0.4, ifindexes=(2, 3))
    pt = testing.random_tables(np.random.default_rng(12), n_entries=60, width=4,
                               v6_fraction=0.4, ifindexes=(2, 3))
    jdev = jaxpath.device_tables(jt, pad=pad)
    cdev, d_max = jaxpath.device_ctrie(jt, pad=pad)
    tt = walk.build_trie_tables(pt, "cpu", pad=pad)
    ct = cwalk.build_ctrie_tables(pt, "cpu", pad=pad)
    np.testing.assert_array_equal(tt.root_lut.numpy(), np.asarray(jdev.root_lut))
    np.testing.assert_array_equal(tt.targets.numpy(), np.asarray(jdev.trie_targets))
    for lvl, (rows, n) in zip(jdev.trie_levels[1:], tt.level_rows.numpy()):
        np.testing.assert_array_equal(tt.deep[rows:rows + n].numpy().view(np.uint32),
                                      np.asarray(lvl))
    for f in ("l0", "nodes", "targets", "joined", "root_lut"):
        want = np.asarray(getattr(cdev, f))
        np.testing.assert_array_equal(getattr(ct, f).numpy().view(want.dtype), want, err_msg=f)
    assert len(tt.root_lut) == (8 if pad else 4)
    batch = jax_testing.random_batch_fast(rng, jt, 400)
    batch.ifindex[::4] = np.array([5, 7, 8, 4000])[np.arange(100) % 4]
    pb = port_batch(batch)
    want = np.asarray(jaxpath.jitted_classify(True)(jdev, jaxpath.device_batch(batch))[0])
    want_c = np.asarray(jaxpath.jitted_classify_ctrie(d_max)(cdev, jaxpath.device_batch(batch))[0])
    db = torchpath.device_batch(pb, "cpu")
    got = walk.classify_walk(tt, db, tt.n_levels)[0].numpy().view(np.uint32)
    got_c = cwalk.classify_ctrie(ct, db)[0].numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_array_equal(got, oracle.classify(pt, pb).results)


def _outputs_equal(got, want, label):
    for f in ("results", "xdp", "stats_delta"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f"{label} {f}")


@pytest.mark.parametrize("path", ["trie", "ctrie"])
def test_classifier_hinted_loads_match_tpu_classifier(path):
    """TorchClassifier and TpuClassifier(interpret=True, fused_deep=True)
    take the same load_tables(snapshot, dirty_hint=peek_dirty()) sequence:
    equal results, verdicts and statistics after every round, classified
    whole and steered as the daemon packs chunks, and the same _last_load
    mode on the rules-only rounds (the patch path)."""
    rng = np.random.default_rng(75)
    content = _random_content(rng, 60, ifindexes=(2, 3))
    jit = jax_compiler.IncrementalTables.from_content(content, rule_width=4)
    pit = compiler.IncrementalTables.from_content(_port_content(content), rule_width=4)
    jc = TpuClassifier(force_path=path, interpret=True, fused_deep=True)
    pc = TorchClassifier(device="cpu", force_path=path)
    jc.load_tables(jit.snapshot())
    pc.load_tables(pit.snapshot())
    assert pc._last_load == jc._last_load == ("full", 60)
    jit.clear_dirty()
    pit.clear_dirty()
    batch = jax_testing.random_batch_fast(rng, jit.snapshot(), 300)
    pb = port_batch(batch)
    for r in range(ROUNDS):
        ups, dels = _churn_round(rng, content, r)
        jit.apply(ups, deletes=dels)
        pit.apply(_port_content(ups), deletes=[compiler.LpmKey(*k) for k in dels])
        jc.load_tables(jit.snapshot(), dirty_hint=jit.peek_dirty())
        pc.load_tables(pit.snapshot(), dirty_hint=pit.peek_dirty())
        jit.clear_dirty()
        pit.clear_dirty()
        assert pc.active_path == jc.active_path == path
        if r % 2:
            assert pc._last_load[0] == jc._last_load[0] == "patch", r
        _outputs_equal(pc.classify(pb), jc.classify(batch), f"round {r}")
        idx = np.nonzero(pb.kind == 1)[0]
        wire, v4_only = pb.pack_wire_subset(idx)
        got = pc.classify_async_packed(wire, v4_only).result()
        want = jc.classify_async_packed(wire, v4_only).result()
        _outputs_equal(got, want, f"round {r} v4 chunk")
    np.testing.assert_array_equal(pc.stats.snapshot(), jc.stats.snapshot())
    jc.close()
