"""The port's compressed ctrie path on the CPU (layouts, the plain walk that
is K3's specification, the wire path and TorchClassifier) against the JAX
package: jaxpath's host layouts byte for byte, the XLA compressed walk, the
Pallas K3 in interpret mode, TpuClassifier(force_path="ctrie") and the
oracles.  Every comparison is exact (integers, tolerance 0)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from infw import compiler as jax_compiler
from infw import oracle as jax_oracle
from infw import testing as jax_testing
from infw.backend.tpu import TpuClassifier
from infw.kernels import jaxpath, pallas_walk
from infw.packets import concat
from infw_torch import compiler, layout, oracle, testing
from infw_torch.backend.cuda import TorchClassifier
from infw_torch.kernels import cwalk, torchpath
from test_torch_walk import _compile_pair, _hand_packets, _hazard_content, port_batch


def _random_content(seed, n, width=4, v6_fraction=0.7):
    t = jax_testing.random_tables_fast(np.random.default_rng(seed), n, width=width,
                                       group_size=6, v6_fraction=v6_fraction)
    return {tuple(k): np.array(v) for k, v in t.content.items()}


def _clean_pair(seed=11, n=20_000):
    jt = jax_testing.clean_tables_scale(np.random.default_rng(seed), n)
    pt = testing.clean_tables_scale(np.random.default_rng(seed), n)
    return jt, pt


LAYOUT_CASES = {
    # skip nodes and 15 trie levels
    "random_fast": lambda: _compile_pair(_random_content(3, 2500), 4),
    "clean_20k": _clean_pair,
    "hazards": lambda: _compile_pair(_hazard_content(42, 3000)),
    "v4_only": lambda: _compile_pair(_random_content(5, 1500, v6_fraction=0.0), 4),
    "one_entry": lambda: _compile_pair(
        {(56, 2, bytes([10, 1, 2, 3]) + bytes(12)): np.eye(4, 7, dtype=np.int32)}, 4),
}


@pytest.mark.parametrize("case", sorted(LAYOUT_CASES))
def test_ctrie_layouts_match_jax(case):
    """build_cpoptrie, joined_by_tidx and pack_rules_u16 byte-identical to
    jaxpath's, memoized on the tables."""
    jt, pt = LAYOUT_CASES[case]()
    got, want = layout.build_cpoptrie(pt), jaxpath.build_cpoptrie(jt)
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got[3] == want[3]
    assert layout.build_cpoptrie(pt)[1] is got[1]
    joined = layout.joined_by_tidx(pt)
    assert joined.dtype == np.uint16 and np.array_equal(joined, jaxpath.joined_by_tidx(jt))
    assert layout.joined_by_tidx(pt) is joined
    packed = layout.pack_rules_u16(pt.rules)
    assert packed.dtype == np.uint16 and np.array_equal(packed, jaxpath.pack_rules_u16(jt.rules))
    if case in ("random_fast", "clean_20k"):
        assert int((got[1][:, 2] > 0).sum()) > 100 and got[3] < pt.levels  # real skip nodes
    if case == "random_fast":
        assert pt.levels == 15


def test_wide_rules_pack_to_none_on_both_sides():
    content = _random_content(6, 200)
    key = next(iter(content))
    content[key] = content[key].copy()
    content[key][1] = [300, 6, 80, 0, 0, 0, 2]
    jt, pt = _compile_pair(content, 4)
    assert layout.pack_rules_u16(pt.rules) is None and jaxpath.pack_rules_u16(jt.rules) is None
    assert layout.joined_by_tidx(pt) is None and jaxpath.joined_by_tidx(jt) is None
    assert layout.joined_by_tidx(pt) is None  # the memoized None
    with pytest.raises(ValueError, match="uint16 joined rows"):
        cwalk.build_ctrie_tables(pt, "cpu")
    ports = pt.rules.copy()
    ports[0, 1] = [1, 6, 70000, 0, 0, 0, 2]
    assert layout.pack_rules_u16(ports) is None
    assert jaxpath.pack_rules_u16(ports) is None


def test_extract_ip_bits_matches_jax():
    """Random and edge (pos, n): pos past 128 (word index clipped, word 4
    reads 0), n = 0, off = 0, n = 32, and n above 32."""
    rng = np.random.default_rng(7)
    B = 4096
    words = rng.integers(0, 1 << 32, (B, 4), dtype=np.uint64).astype(np.uint32)
    words[:8] = 0xFFFFFFFF
    pos = rng.integers(0, 200, B).astype(np.int32)
    n = rng.integers(0, 33, B).astype(np.int32)
    edges = [(0, 0), (32, 8), (64, 32), (96, 1), (120, 8), (124, 8), (128, 8), (130, 24),
             (159, 8), (160, 8), (250, 32), (31, 2), (17, 0), (0, 32), (5, 33), (7, 40)]
    for i, (p, m) in enumerate(edges):
        pos[i], n[i] = p, m
    want = np.asarray(jaxpath.extract_ip_bits(jnp.asarray(words), jnp.asarray(pos), jnp.asarray(n)))
    got = torchpath.extract_ip_bits(torch.from_numpy(words.view(np.int32)),
                                    torch.from_numpy(pos), torch.from_numpy(n))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert (got[:8][n[:8] > 0] > 0).any() and int(got[8]) == 0  # pos 160 reads zeros
    scalar = torchpath.extract_ip_bits(torch.from_numpy(words.view(np.int32)),
                                       torch.from_numpy(pos), 8)
    want8 = jaxpath.extract_ip_bits(jnp.asarray(words), jnp.asarray(pos), jnp.full(B, 8))
    np.testing.assert_array_equal(scalar.numpy(), np.asarray(want8).astype(np.int64))


@pytest.fixture(scope="module")
def case():
    """The hazard table (3000 entries x 8 rule slots) and a 2048-packet
    batch plus hand-made packets, with the XLA ctrie results computed
    once."""
    jt, pt = _compile_pair(_hazard_content(42, 3000))
    batch = concat([jax_testing.random_batch_fast(np.random.default_rng(43), jt, 2048),
                    _hand_packets()])
    cdev, d_max = jaxpath.device_ctrie(jt)
    ref = jaxpath.jitted_classify_ctrie(d_max)(cdev, jaxpath.device_batch(batch))
    res, xdp, stats = (np.asarray(a) for a in ref)
    ct = cwalk.build_ctrie_tables(pt, "cpu")
    port = cwalk.classify_ctrie(ct, torchpath.device_batch(port_batch(batch), "cpu"))
    return {
        "jt": jt, "pt": pt, "batch": batch, "pb": port_batch(batch), "ct": ct, "cdev": cdev,
        "d_max": d_max, "res": res, "xdp": xdp, "stats": stats,
        "port": tuple(a.numpy() for a in port),
    }


def _assert_same(port, res, xdp, stats=None):
    np.testing.assert_array_equal(port[0].view(np.uint32), res)
    np.testing.assert_array_equal(port[1], xdp)
    if stats is not None:
        np.testing.assert_array_equal(port[2], stats)


def test_classify_ctrie_matches_jax_xla_ctrie(case):
    """Every packet, results, XDP verdicts and statistics; the ctrie walk
    also gives the trie walk's verdicts."""
    assert case["ct"].d_max == case["d_max"]
    _assert_same(case["port"], case["res"], case["xdp"], case["stats"])
    trie = jaxpath.jitted_classify(True)(jaxpath.device_tables(case["jt"]),
                                         jaxpath.device_batch(case["batch"]))
    _assert_same(case["port"], *(np.asarray(a) for a in trie))


def test_classify_ctrie_matches_pallas_k3_interpret():
    """The Pallas K3 in interpret mode on full walk tables (no extraction),
    on a v6-heavy table with deep skip chains."""
    content = _random_content(9, 1500)
    jt, pt = _compile_pair(content, 4)
    batch = concat([jax_testing.random_batch_fast(np.random.default_rng(10), jt, 384),
                    _hand_packets()])
    wt, meta = pallas_walk.build_cwalk_tables_meta(jt, vmem_budget=256 << 20)
    ref = pallas_walk.jitted_classify_cwalk(meta["d_max"], True)(wt, jaxpath.device_batch(batch))
    ct = cwalk.build_ctrie_tables(pt, "cpu")
    assert ct.d_max == meta["d_max"]
    port = cwalk.classify_ctrie(ct, torchpath.device_batch(port_batch(batch), "cpu"))
    _assert_same([a.numpy() for a in port], *(np.asarray(a) for a in ref))


def test_classify_ctrie_matches_oracles(case):
    """infw.oracle on a prefix; the port's oracles on every packet, and the
    port's HashLpmOracle against infw's."""
    res, xdp = case["port"][0].view(np.uint32), case["port"][1]
    ref = jax_oracle.classify(case["jt"], case["batch"].slice(0, 600))
    np.testing.assert_array_equal(res[:600], ref.results)
    np.testing.assert_array_equal(xdp[:600], ref.xdp)
    full = oracle.classify(case["pt"], case["pb"])
    np.testing.assert_array_equal(res, full.results)
    np.testing.assert_array_equal(xdp, full.xdp)
    stats4 = torchpath.merge_stats_host(case["port"][2])
    assert {r: list(v) for r, v in enumerate(stats4.tolist()) if any(v)} == full.stats
    hashed = oracle.HashLpmOracle(case["pt"]).classify(case["pb"])
    jhashed = jax_oracle.HashLpmOracle(case["jt"]).classify(case["batch"])
    for a, b in ((hashed, full), (hashed, jhashed)):
        np.testing.assert_array_equal(a.results, b.results)
        np.testing.assert_array_equal(a.xdp, b.xdp)
        assert a.stats == b.stats


def test_hazards_are_exercised(case):
    """The batch reaches unclipped actions 0 and 3, the v4 /0 entries from
    IPv6 packets, the root slot's own targets and skip-node targets, and
    the hand packets' out-of-LUT ifindexes read no entry."""
    res = case["port"][0].view(np.uint32)
    act, rid = res & 0xFF, res >> 8
    assert ((act == 0) & (rid > 0)).sum() > 5 and (act == 3).sum() > 5
    fields, words = torchpath.packet_fields(torchpath.device_batch(case["pb"], "cpu"))
    out = cwalk.ctrie_walk_classify(fields, words, case["ct"])
    pb = case["pb"]
    looked_up = ((pb.kind == 1) | (pb.kind == 2)) & (pb.l4_ok != 0)
    np.testing.assert_array_equal(np.where(looked_up, out[:, 0].numpy(), 0), case["port"][0])
    tidx = out[:, 1].numpy()
    pt = case["pt"]
    v4_zero = np.nonzero(pt.mask_len[: pt.num_entries] == 0)[0]
    assert np.isin(tidx[case["batch"].kind == 2], v4_zero).sum() > 0
    assert (tidx[-6:-3] == -1).all()
    # entries found at the root slot (a walk of no skip nodes finds them)
    # and entries three or more skip nodes deep (a walk of two misses them)
    def walked(d_max):
        ct = case["ct"]._replace(d_max=d_max)
        return cwalk.ctrie_walk_classify_plain(fields, words, ct)[:, 1].numpy()

    assert ((walked(0) == tidx) & (tidx >= 0)).sum() > 50 and (walked(2) != tidx).sum() > 50
    mask = pt.mask_len[np.clip(tidx, 0, None)]
    assert ((tidx >= 0) & (mask <= 16)).sum() > 20 and ((tidx >= 0) & (mask > 40)).sum() > 20


def _wire(batch, width):
    from infw_torch.packets import narrow_wire

    full = batch.pack_wire_v4() if width in (3, 4) else batch.pack_wire()
    return full if width in (4, 7) else narrow_wire(full)


@pytest.mark.parametrize("width", [3, 4, 6, 7])
def test_wire_widths(case, width):
    """Every wire width through classify_ctrie_wire_fused: results, XDP and
    statistics as the JAX path's."""
    batch, pb = case["batch"], case["pb"]
    ok = (batch.ifindex >= 0) & (batch.ifindex < 1 << 16)
    if width in (3, 4):
        idx = np.nonzero(ok & (batch.kind != 2) & ~batch.ip_words[:, 1:].any(axis=1))[0]
    else:
        idx = np.nonzero(ok)[0]
    sub = pb.take(idx)
    wire_np = _wire(sub, width)
    assert wire_np.shape == (len(idx), width)
    fused = cwalk.classify_ctrie_wire_fused(case["ct"], torch.from_numpy(wire_np.view(np.int32)))
    res16, stats = torchpath.split_wire_outputs(fused.numpy(), len(idx))
    results, xdp = torchpath.host_finalize_wire(res16, sub.kind)
    np.testing.assert_array_equal(results, case["res"][idx] & 0xFFFF)
    np.testing.assert_array_equal(xdp, case["xdp"][idx])
    ref = oracle.classify(case["pt"], sub)
    assert {r: list(v) for r, v in enumerate(torchpath.merge_stats_host(stats).tolist())
            if any(v)} == ref.stats


def test_plain_walk_on_the_jax_padded_layout(case):
    """cwalk.ctrie_tables_from_arrays on jaxpath.device_ctrie's
    bucket-padded upload: the port's plain K3 gives the same results, so
    the padding rows are unreachable."""
    cdev, d_max = jaxpath.device_ctrie(case["jt"], pad=True)
    arrays = {f: np.asarray(getattr(cdev, f)) for f in ("l0", "nodes", "targets", "joined",
                                                         "root_lut")}
    assert arrays["nodes"].shape[0] > case["ct"].nodes.shape[0]
    assert arrays["joined"].shape[0] > case["ct"].joined.shape[0]
    ct = cwalk.ctrie_tables_from_arrays(**arrays, d_max=d_max, device="cpu")
    fields, words = torchpath.packet_fields(torchpath.device_batch(case["pb"], "cpu"))
    np.testing.assert_array_equal(
        cwalk.ctrie_walk_classify_plain(fields, words, ct).numpy(),
        cwalk.ctrie_walk_classify_plain(fields, words, case["ct"]).numpy())


@pytest.fixture(scope="module")
def tpu_ctrie(case):
    jclf = TpuClassifier(force_path="ctrie", interpret=True, fused_deep=True)
    jclf.load_tables(case["jt"])
    assert jclf.active_path == "ctrie"
    yield jclf
    jclf.close()


@pytest.mark.parametrize("knob", ["force_path", "compressed"])
def test_classifier_matches_tpu_classifier(case, tpu_ctrie, knob):
    """TorchClassifier on the ctrie path (force_path="ctrie", or
    compressed=True upgrading the auto-selected trie path) against
    TpuClassifier(force_path="ctrie", fused_deep=True): the whole batch,
    then the IPv4 chunk and each IPv6 depth group of the JAX side's
    steering, packed, with depth tokens (accepted, changing nothing)."""
    batch, pb = case["batch"], case["pb"]
    kw = {"force_path": "ctrie"} if knob == "force_path" else {"compressed": True,
                                                                "dense_limit": 1000}
    clf = TorchClassifier(device="cpu", **kw)
    clf.load_tables(case["pt"])
    assert clf.active_path == "ctrie" and clf.supports_packed()
    jout, out = tpu_ctrie.classify(batch, apply_stats=False), clf.classify(pb)
    for f in ("results", "xdp", "stats_delta"):
        np.testing.assert_array_equal(getattr(out, f), getattr(jout, f), err_msg=f)
    idx6 = np.nonzero(batch.kind == 2)[0]
    jgroups = tpu_ctrie.v6_depth_groups(batch.ifindex, batch.ip_words, idx6)
    assert len(jgroups) >= 2
    jobs = [((None, 0), np.nonzero(batch.kind != 2)[0])] + jgroups
    for depth, idx in jobs:
        jw, jv4 = batch.pack_wire_subset(idx)
        jo = tpu_ctrie.classify_async_packed(jw, jv4, apply_stats=False, depth=depth).result()
        wire, v4 = pb.pack_wire_subset(idx)
        for token in (depth, (0, 1), None):
            o = clf.classify_async_packed(wire, v4, apply_stats=False, depth=token).result()
            for f in ("results", "xdp", "stats_delta"):
                np.testing.assert_array_equal(getattr(o, f), getattr(jo, f), err_msg=f)
    assert clf.serving_shape_classes() == []
    np.testing.assert_array_equal(clf.stats.snapshot(), out.stats_delta)


def test_v6_depth_groups_on_ctrie_is_the_steering_off_form(case):
    clf = TorchClassifier(device="cpu", force_path="ctrie")
    clf.load_tables(case["pt"])
    idx6 = np.nonzero(case["batch"].kind == 2)[0]
    groups = clf.v6_depth_groups(case["pb"].ifindex, case["pb"].ip_words, idx6)
    assert len(groups) == 1 and groups[0][0] == (None, 0)
    np.testing.assert_array_equal(groups[0][1], idx6)


def test_precedence_and_fallbacks(case, monkeypatch):
    """force_path="trie" wins over compressed; the INFW_COMPRESSED env
    applies when the argument is absent; wide ruleIds fall back to the trie
    path on both sides; a ctrie overlay with entries is served, with the
    JAX classifier's results."""
    pt, jt = case["pt"], case["jt"]
    clf = TorchClassifier(device="cpu", force_path="trie", compressed=True)
    clf.load_tables(pt)
    assert clf.active_path == "trie"
    for env, path in (("1", "ctrie"), ("0", "trie"), ("", "trie")):
        monkeypatch.setenv("INFW_COMPRESSED", env)
        clf = TorchClassifier(device="cpu", dense_limit=1000)
        clf.load_tables(pt)
        assert clf.active_path == path, env
    clf = TorchClassifier(device="cpu", dense_limit=1000, compressed=False)
    clf.load_tables(pt)
    assert clf.active_path == "trie"
    monkeypatch.delenv("INFW_COMPRESSED")

    content = {tuple(k): np.array(v) for k, v in jt.content.items()}
    for key in list(content)[::3]:
        rows = content[key].copy()
        rows[:, 0] = np.where(rows[:, 0] > 0, rows[:, 0] + 300, 0)
        content[key] = rows
    wjt, wpt = _compile_pair(content, 8)
    jclf = TpuClassifier(force_path="ctrie", interpret=True)
    clf = TorchClassifier(device="cpu", force_path="ctrie")
    jclf.load_tables(wjt)
    clf.load_tables(wpt)
    assert clf.active_path == jclf.active_path == "trie"
    assert not clf.supports_packed() and not jclf.supports_packed()
    jout, out = jclf.classify(case["batch"]), clf.classify(case["pb"])
    for f in ("results", "xdp", "stats_delta"):
        np.testing.assert_array_equal(getattr(out, f), getattr(jout, f), err_msg=f)
    jclf.close()

    clf = TorchClassifier(device="cpu", force_path="ctrie")
    ov_content = {(64, 2, bytes([192, 0, 2, 1]) + bytes(12)): np.eye(8, 7, dtype=np.int32)}
    overlay = compiler.compile_tables_from_content(
        {compiler.LpmKey(*k): v for k, v in ov_content.items()}, rule_width=8)
    clf.load_tables(pt, overlay=overlay)
    assert clf.active_path == "ctrie"
    jclf = TpuClassifier(force_path="ctrie", interpret=True)
    jclf.load_tables(jt, overlay=jax_compiler.compile_tables_from_content(
        {jax_compiler.LpmKey(*k): v for k, v in ov_content.items()}, rule_width=8))
    jout, out = jclf.classify(case["batch"]), clf.classify(case["pb"])
    for f in ("results", "xdp", "stats_delta"):
        np.testing.assert_array_equal(getattr(out, f), getattr(jout, f), err_msg=f)
    jclf.close()
    clf.load_tables(pt, overlay=compiler.compile_tables_from_content({}, rule_width=8))
    assert clf.active_path == "ctrie"


def test_clean_columns_and_hash_oracle_match_jax():
    """clean_columns_fast draws the same columns; clean_tables_scale and the
    HashLpmOracle agree with the JAX package's on a seeded batch."""
    jc = jax_testing.clean_columns_fast(np.random.default_rng(12), 5000, ifindexes=(2, 5))
    pc = testing.clean_columns_fast(np.random.default_rng(12), 5000, ifindexes=(2, 5))
    for f in ("prefix_len", "ifindex", "ip", "rules"):
        a, b = getattr(pc, f), getattr(jc, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    jt, pt = _clean_pair(seed=13, n=5000)
    for f in ("key_words", "mask_words", "mask_len", "rules", "root_lut"):
        np.testing.assert_array_equal(getattr(pt, f), getattr(jt, f), err_msg=f)
    batch = jax_testing.random_batch_fast(np.random.default_rng(14), jt, 1500)
    got = oracle.HashLpmOracle(pt).classify(port_batch(batch))
    want = jax_oracle.HashLpmOracle(jt).classify(batch)
    np.testing.assert_array_equal(got.results, want.results)
    np.testing.assert_array_equal(got.xdp, want.xdp)
    assert got.stats == want.stats and (got.results != 0).sum() > 20


def test_build_ctrie_tables_takes_the_device_rule():
    """build_ctrie_tables follows the port's device rule."""
    pt = testing.clean_tables_scale(np.random.default_rng(15), 300)
    if torch.cuda.is_available():
        assert cwalk.build_ctrie_tables(pt).nodes.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            cwalk.build_ctrie_tables(pt)
    ct = cwalk.build_ctrie_tables(pt, "cpu")
    assert ct.nodes.dtype == torch.int32 and ct.joined.dtype == torch.int16
    assert ct.nodes.shape[1] == cwalk.NODE_WORDS and ct.d_max >= 1
