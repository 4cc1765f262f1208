"""The port's overlay combine on the CPU against the JAX package: the LPM
scores from the kernels' second output column against the reference's
``_raw_result_and_score`` / ``_ctrie_result_and_score``, and
TorchClassifier against TpuClassifier(interpret=True) with an overlay on
the trie and ctrie paths, under the narrow wire, wire8 and delta, on a
mixed batch, an IPv4-only chunk and IPv6 depth-class chunks; the
refusals; an overlay that K1's packing cannot hold; the overlay cache.
Every comparison is exact (integers, tolerance 0)."""
import numpy as np
import pytest
import torch

from infw import compiler as jax_compiler
from infw import testing as jax_testing
from infw.backend.tpu import TpuClassifier
from infw.kernels import jaxpath
from infw_torch import compiler, oracle, testing
from infw_torch.backend.cuda import TorchClassifier
from infw_torch.kernels import cwalk, dense, overlay, torchpath, walk
from test_torch_walk import port_batch


def _overlay_content(batch, main_content, n=12, seed=31):
    """Keys covering some of the batch's sources, longer than most main
    prefixes (v4 /28, v6 /64) and disjoint from the main table's masked
    identities, with catch-all or TCP rules of ruleIds 1..3."""
    rng = np.random.default_rng(seed)
    taken = {compiler.LpmKey(*k).masked_identity() for k in main_content}
    out = {}
    for i in rng.permutation(len(batch)):
        kind = int(batch.kind[i])
        if kind not in (1, 2):
            continue
        ip = np.asarray(batch.ip_words[i], np.uint32).astype(">u4").tobytes()
        plen = 32 + (28 if kind == 1 else 64)
        key = (plen, int(batch.ifindex[i]), ip if kind == 2 else ip[:4] + bytes(12))
        if compiler.LpmKey(*key).masked_identity() in taken:
            continue
        rows = np.zeros((4, 7), np.int32)
        rid = int(rng.integers(1, 4))
        rows[rid] = [rid, 0 if rid == 1 else 6, int(batch.dst_port[i]), 0, 0, 0,
                     int(rng.integers(1, 3))]
        out[key] = rows
        taken.add(compiler.LpmKey(*key).masked_identity())
        if len(out) == n:
            break
    return out


def _pair(content, width=4):
    jt = jax_compiler.compile_tables_from_content(
        {jax_compiler.LpmKey(*k): v for k, v in content.items()}, rule_width=width)
    pt = compiler.compile_tables_from_content(
        {compiler.LpmKey(*k): v for k, v in content.items()}, rule_width=width)
    return jt, pt


@pytest.fixture(scope="module")
def case():
    """A 600-entry main table (40% IPv6, ifindexes 2, 3, 9), a batch whose
    IPv4 rows carry zero high words, and a 12-key overlay over its
    sources."""
    jt0 = jax_testing.random_tables(np.random.default_rng(30), n_entries=600, width=4,
                                    v6_fraction=0.4, ifindexes=(2, 3, 9))
    main = {tuple(k): np.array(v) for k, v in jt0.content.items()}
    jt, pt = _pair(main)
    batch = jax_testing.random_batch_fast(np.random.default_rng(32), jt, 1500)
    batch.ip_words[np.asarray(batch.kind) != 2, 1:] = 0
    ov_content = _overlay_content(batch, main)
    jov, pov = _pair(ov_content)
    merged = compiler.compile_tables_from_content(
        {compiler.LpmKey(*k): v for k, v in {**main, **ov_content}.items()}, rule_width=4)
    return {"jt": jt, "pt": pt, "batch": batch, "pb": port_batch(batch), "jov": jov,
            "pov": pov, "merged": merged}


@pytest.mark.parametrize("path", ["trie", "ctrie"])
def test_scores_from_the_kernel_columns_match_jax(case, path):
    """The main side's (result, score) from K2's tidx column or K3's joined
    position, and the overlay side's from K1's tidx column, equal the
    reference's raw result and score."""
    db = torchpath.device_batch(case["pb"], "cpu")
    fields, words = torchpath.packet_fields(db)
    jb = jaxpath.device_batch(case["batch"])
    if path == "trie":
        main = walk.build_trie_tables(case["pt"], "cpu", pad=True)
        res, score = overlay.main_result_and_score(main, fields, words, main.n_levels)
        jres, jscore = jaxpath._raw_result_and_score(
            jaxpath.device_tables(case["jt"], pad=True), jb, use_trie=True)
    else:
        main = cwalk.build_ctrie_tables(case["pt"], "cpu", pad=True)
        res, score = overlay.main_result_and_score(main, fields, words, None)
        cdev, d_max = jaxpath.device_ctrie(case["jt"], pad=True)
        jres, jscore = jaxpath._ctrie_result_and_score(cdev, jb, d_max)
    np.testing.assert_array_equal(res.numpy().view(np.uint32), np.asarray(jres))
    np.testing.assert_array_equal(score.numpy(), np.asarray(jscore))
    assert (score > 0).any()
    ov = overlay.build_overlay_tables(case["pov"], "cpu")
    assert isinstance(ov, dense.DenseTables)
    res_o, score_o = overlay.overlay_result_and_score(ov, fields, words)
    jres_o, jscore_o = jaxpath._raw_result_and_score(
        jaxpath.device_tables(case["jov"], pad=True), jb, use_trie=False)
    np.testing.assert_array_equal(res_o.numpy().view(np.uint32), np.asarray(jres_o))
    np.testing.assert_array_equal(score_o.numpy(), np.asarray(jscore_o))
    assert (score_o > score).any()  # the overlay wins somewhere


def _outputs_equal(got, want, label):
    for f in ("results", "xdp", "stats_delta"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f"{label}: {f}")


@pytest.mark.parametrize("codec", ["wire8", "delta"])
@pytest.mark.parametrize("path", ["trie", "ctrie"])
def test_classifier_overlay_matches_tpu_classifier(case, path, codec):
    """With the overlay loaded: the mixed batch (the narrow wire), the
    IPv4-only chunk (wire8 or delta) and the IPv6 chunks steered by depth
    class give the JAX classifier's results, verdicts, statistics and
    wire_stats(), and the oracle's over both tables' content."""
    jc = TpuClassifier(force_path=path, wire_codec=codec, interpret=True)
    pc = TorchClassifier(device="cpu", force_path=path, wire_codec=codec)
    jc.load_tables(case["jt"], overlay=case["jov"])
    pc.load_tables(case["pt"], overlay=case["pov"])
    assert pc.active_path == jc.active_path == path
    batch, pb = case["batch"], case["pb"]
    got, want = pc.classify(pb), jc.classify(batch)
    _outputs_equal(got, want, "mixed batch")
    ref = oracle.classify(case["merged"], pb)
    np.testing.assert_array_equal(got.results, ref.results)
    np.testing.assert_array_equal(got.xdp, ref.xdp)
    v4 = np.nonzero(pb.kind == 1)[0]
    wire, v4_only = pb.pack_wire_subset(v4)
    assert wire.shape[1] == 4 and v4_only
    _outputs_equal(pc.classify_async_packed(wire, v4_only).result(),
                   jc.classify_async_packed(wire, v4_only).result(), "v4 chunk")
    idx6 = np.nonzero(pb.kind == 2)[0]
    steered = []
    for clf, b in ((pc, pb), (jc, batch)):
        # each side's own grouping (the port's ctrie path does not steer)
        groups = clf.v6_depth_groups(b.ifindex, b.ip_words, idx6)
        results = np.zeros(len(idx6), np.uint32)
        stats = np.zeros((1024, 4), np.int64)
        pos = {int(p): i for i, p in enumerate(idx6)}
        for depth, g in groups:
            wire, v4_only = pb.pack_wire_subset(g)
            out = clf.classify_async_packed(wire, v4_only, depth=depth).result()
            results[[pos[int(p)] for p in g]] = out.results
            stats += out.stats_delta
        steered.append((results, stats, [d for d, _ in groups]))
    np.testing.assert_array_equal(steered[0][0], steered[1][0])
    np.testing.assert_array_equal(steered[0][1], steered[1][1])
    if path == "trie":
        assert any(d[0] is not None for d in steered[0][2])  # a depth-class chunk
    assert pc.wire_stats() == jc.wire_stats()
    assert codec in pc.wire_stats()
    np.testing.assert_array_equal(pc.stats.snapshot(), jc.stats.snapshot())
    jc.close()


def test_overlay_refusals_match_jax(case):
    """An overlay with entries on the dense path, or beside a main table
    with ruleIds above 255, raises ValueError on both sides."""
    for kw, (jmain, pmain) in (
        ({}, _pair({(64, 2, bytes([10, 0, 0, i]) + bytes(12)): np.eye(4, 7, dtype=np.int32)
                    for i in range(3)})),
        ({"force_path": "trie"}, _pair({(64, 2, bytes([10, 0, 0, 1]) + bytes(12)):
                                        np.array([[0] * 7, [300, 0, 0, 0, 0, 0, 1]] + [[0] * 7] * 2,
                                                 np.int32)})),
    ):
        with pytest.raises(ValueError, match="overlay not supported"):
            TpuClassifier(interpret=True, **kw).load_tables(jmain, overlay=case["jov"])
        pc = TorchClassifier(device="cpu", **kw)
        with pytest.raises(ValueError, match="overlay not supported"):
            pc.load_tables(pmain, overlay=case["pov"])
        assert pc.active_path is None


@pytest.mark.parametrize("path", ["trie", "ctrie"])
def test_overlay_that_k1_cannot_hold_matches_jax(case, path):
    """An overlay with ruleIds above 127 and a stored action outside Deny
    and Allow: K1's packing would clip both, so the overlay runs on K2
    over its own trie, and the results equal the JAX classifier's."""
    rows = np.zeros((4, 7), np.int32)
    rows[1] = [200, 0, 0, 0, 0, 0, 1]
    odd = np.zeros((4, 7), np.int32)
    odd[2] = [90, 0, 0, 0, 0, 0, 3]
    keys = _overlay_content(case["batch"], {tuple(k): v for k, v in case["jt"].content.items()},
                            n=8, seed=33)
    content = {key: rows if i % 2 else odd for i, key in enumerate(keys)}
    jov, pov = _pair(content)
    assert not overlay.k1_holds(pov) and overlay.k1_holds(case["pov"])
    jc = TpuClassifier(force_path=path, interpret=True)
    pc = TorchClassifier(device="cpu", force_path=path)
    jc.load_tables(case["jt"], overlay=jov)
    pc.load_tables(case["pt"], overlay=pov)
    assert isinstance(pc._active.ov, walk.TrieTables)
    padded = walk.build_trie_tables(pov, "cpu", pad=True)  # the layout the reference serves
    for f in padded._fields:
        a, b = getattr(pc._active.ov, f), getattr(padded, f)
        assert torch.equal(a, b) if isinstance(b, torch.Tensor) else a == b, f
    got, want = pc.classify(case["pb"]), jc.classify(case["batch"])
    _outputs_equal(got, want, "K2 overlay")
    assert ((got.results >> 8) == 200).any() and ((got.results & 0xFF) == 3).any()
    jc.close()


@pytest.mark.parametrize("path", ["trie", "ctrie"])
def test_overlay_cache_and_hinted_reload(case, path):
    """The same overlay object keeps its device tables across loads (the
    reference's _ov_cache); an equal but new object is built again; a
    rules-only hinted reload with the overlay patches and still gives the
    oracle's results over both tables, and so does a hinted reload with
    no edit at all (an empty hint: the overlay arrives alone)."""
    pc = TorchClassifier(device="cpu", force_path=path)
    it = compiler.IncrementalTables.from_content(case["pt"].content, rule_width=4)
    pc.load_tables(it.snapshot())
    it.clear_dirty()
    pc.load_tables(it.snapshot(), dirty_hint=it.peek_dirty(), overlay=case["pov"])
    assert pc._last_load == ("patch", 0)
    first = pc._active.ov
    ref = oracle.classify(case["merged"], case["pb"])
    np.testing.assert_array_equal(pc.classify(case["pb"]).results, ref.results)
    key = next(iter(case["pt"].content))
    it.apply({key: np.array(case["pt"].content[key])})
    pc.load_tables(it.snapshot(), dirty_hint=it.peek_dirty(), overlay=case["pov"])
    assert pc._active.ov is first and pc._last_load[0] == "patch"
    np.testing.assert_array_equal(pc.classify(case["pb"]).results, ref.results)
    again = compiler.compile_tables_from_content(case["pov"].content, rule_width=4)
    pc.load_tables(it.snapshot(), overlay=again)
    assert pc._active.ov is not first
    pc.load_tables(it.snapshot())
    assert pc._active.ov is None
