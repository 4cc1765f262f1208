"""The port's trie path on the CPU (K2's plain version, the walk, the wire
path and TorchClassifier) against the JAX package: the XLA trie classify in
its joined and two-gather table forms, the Pallas K2 in interpret mode on
full and on depth-extracted walk tables, TpuClassifier, and the oracles.
Every comparison is exact (integers, tolerance 0)."""
import dataclasses

import numpy as np
import pytest
import torch

from infw import compiler as jax_compiler
from infw import oracle as jax_oracle
from infw import testing as jax_testing
from infw.backend.tpu import TpuClassifier
from infw.kernels import jaxpath, pallas_walk
from infw.packets import concat, make_batch
from infw_torch import compiler, layout, oracle
from infw_torch.backend.cuda import TorchClassifier
from infw_torch.kernels import torchpath, walk
from infw_torch.packets import PacketBatch, narrow_wire

BATCH_FIELDS = (
    "kind", "l4_ok", "ifindex", "ip_words", "proto", "dst_port",
    "icmp_type", "icmp_code", "pkt_len",
)


def port_batch(batch):
    return PacketBatch(**{f: getattr(batch, f) for f in BATCH_FIELDS})


def _hazard_content(seed, n_entries):
    """random_tables_fast content plus the trie path's hazards: entries
    whose only rule is a catch-all with action 0 or 3 (the trie path
    reports actions unclipped), and v4 /0 entries on every ifindex (they
    match IPv6 packets too)."""
    rng = np.random.default_rng(seed)
    base = jax_testing.random_tables_fast(rng, n_entries, ifindexes=(2, 3, 4), width=8,
                                          group_size=6, v6_fraction=0.3)
    content = {tuple(k): np.array(v) for k, v in base.content.items()}
    for i, key in enumerate(list(content)[::20]):
        rows = np.zeros((8, 7), np.int32)
        rows[1 + i % 7] = [1 + i % 7, 0, 0, 0, 0, 0, 3 * (i % 2)]
        content[key] = rows
    for ifx in (2, 3, 4):
        rows = np.zeros((8, 7), np.int32)
        rows[5] = [5, 0, 0, 0, 0, 0, 1]
        content[(32, ifx, bytes([198, 51, 100, ifx]) + bytes(12))] = rows
    return content


def _compile_pair(content, width=8):
    jt = jax_compiler.compile_tables_from_content(
        {jax_compiler.LpmKey(*k): v for k, v in content.items()}, rule_width=width)
    pt = compiler.compile_tables_from_content(
        {compiler.LpmKey(*k): v for k, v in content.items()}, rule_width=width)
    return jt, pt


def _hand_packets():
    """Out-of-range, negative and unknown ifindexes; non-IP kinds with IPv6
    addresses (capped at /128)."""
    return make_batch(
        src=["2001:db8::1", "10.0.0.1", "2001:db8::2", "198.51.100.9", "::1", "fe80::7"],
        proto=[6, 17, 6, 0, 58, 6], dst_port=[80, 53, 443, 0, 0, 22],
        ifindex=[10_000_000, -3, 9999, 2, 3, 4], kind=[2, 1, 2, 3, 0, 2],
    )


@pytest.fixture(scope="module")
def case():
    """One 3000-entry table and a 2048-packet batch (plus hand-made
    packets), with the JAX package's XLA trie results computed once."""
    jt, pt = _compile_pair(_hazard_content(42, 3000))
    rng = np.random.default_rng(43)
    batch = concat([jax_testing.random_batch_fast(rng, jt, 2048), _hand_packets()])
    db = jaxpath.device_batch(batch)
    ref = jaxpath.jitted_classify(True)(jaxpath.device_tables(jt), db)
    res, xdp, stats = (np.asarray(a) for a in ref)
    tt = walk.build_trie_tables(pt, "cpu")
    port = walk.classify_walk(tt, torchpath.device_batch(port_batch(batch), "cpu"), tt.n_levels)
    return {
        "jt": jt, "pt": pt, "batch": batch, "pb": port_batch(batch), "tt": tt,
        "res": res, "xdp": xdp, "stats": stats,
        "port": tuple(a.numpy() for a in port),
    }


def _assert_same(port, res, xdp, stats=None):
    np.testing.assert_array_equal(port[0].view(np.uint32), res)
    np.testing.assert_array_equal(port[1], xdp)
    if stats is not None:
        np.testing.assert_array_equal(port[2], stats)


@pytest.mark.parametrize("form", ["joined", "two_gather"])
def test_walk_matches_jax_xla_trie(case, form, monkeypatch):
    """Both device forms of the JAX trie path: at this size the joined
    layout's duplication gate trips, so the default upload is the
    two-gather form (trie_walk, then gather_rule_rows); with the gate
    lifted, a fresh instance uploads the one-gather joined form."""
    jt = case["jt"]
    if form == "two_gather":
        assert jaxpath.build_joined(jt) is None
        ref = case["res"], case["xdp"], case["stats"]
    else:
        monkeypatch.setattr(jaxpath, "JOINED_DUP_LIMIT", 1e9)
        dt = jaxpath.device_tables(dataclasses.replace(jt))
        assert dt.joined.shape[0] > 1
        ref = [np.asarray(a) for a in jaxpath.jitted_classify(True)(
            dt, jaxpath.device_batch(case["batch"]))]
    _assert_same(case["port"], *ref)


def test_walk_matches_pallas_k2_interpret(case):
    """The Pallas K2 on full walk tables (interpret mode) on every packet."""
    wt = pallas_walk.build_walk_tables(case["jt"], vmem_budget=64 << 20)
    assert wt is not None
    ref = pallas_walk.jitted_classify_walk(True)(wt, jaxpath.device_batch(case["batch"]))
    _assert_same(case["port"], *(np.asarray(a) for a in ref))


def test_walk_matches_pallas_k2_on_the_extracted_deep_class(case):
    """K2 on depth-extracted walk tables serves only the full-depth class's
    packets; on those, the port's full walk gives the same verdicts."""
    jt, batch = case["jt"], case["batch"]
    classes = jaxpath.tune_depth_classes(jt)
    idx6 = np.nonzero(batch.kind == 2)[0]
    deep = [g for d, g in jaxpath.depth_group_indices(
        np.asarray(jt.root_lut, np.int64), jaxpath.build_depth_lut(jt), classes,
        batch.ifindex, batch.ip_words, idx6) if d is None][0]
    assert len(deep) > 50
    wt = pallas_walk.build_walk_tables(jt, min_depth=classes[-2], vmem_budget=64 << 20)
    res, xdp, _ = pallas_walk.jitted_classify_walk(True)(wt, jaxpath.device_batch(batch.take(deep)))
    tt = case["tt"]
    port = walk.classify_walk(tt, torchpath.device_batch(case["pb"].take(deep), "cpu"), tt.n_levels)
    _assert_same([a.numpy() for a in port], np.asarray(res), np.asarray(xdp))


def test_walk_matches_oracles(case):
    """infw.oracle on a prefix; the port's indexed oracle on every packet."""
    res, xdp = case["port"][0].view(np.uint32), case["port"][1]
    ref = jax_oracle.classify(case["jt"], case["batch"].slice(0, 600))
    np.testing.assert_array_equal(res[:600], ref.results)
    np.testing.assert_array_equal(xdp[:600], ref.xdp)
    full = oracle.classify(case["pt"], case["pb"])
    np.testing.assert_array_equal(res, full.results)
    np.testing.assert_array_equal(xdp, full.xdp)
    stats4 = torchpath.merge_stats_host(case["port"][2])
    assert {r: list(v) for r, v in enumerate(stats4.tolist()) if any(v)} == full.stats


def test_hazards_are_exercised(case):
    """The batch reaches unclipped actions 0 and 3 and the v4 /0 entries
    from IPv6 packets, so the comparisons above cover them."""
    res = case["port"][0].view(np.uint32)
    act, rid = res & 0xFF, res >> 8
    assert ((act == 0) & (rid > 0)).sum() > 5 and (act == 3).sum() > 5
    tidx = walk.trie_walk_classify(*torchpath.packet_fields(
        torchpath.device_batch(case["pb"], "cpu")), case["tt"], case["tt"].n_levels)[:, 1].numpy()
    v4_zero = np.nonzero(case["pt"].mask_len[: case["pt"].num_entries] == 0)[0]
    assert np.isin(tidx[case["batch"].kind == 2], v4_zero).sum() > 0
    assert (tidx[-6:-3] == -1).all()  # the out-of-LUT and unknown ifindexes


def _wire(batch, width):
    full = batch.pack_wire_v4() if width in (3, 4) else batch.pack_wire()
    return full if width in (4, 7) else narrow_wire(full)


@pytest.mark.parametrize("width", [3, 4, 6, 7])
def test_wire_widths(case, width):
    """Every wire width: an IPv4-only chunk on the 4- and 3-word wire walks
    the levels within /32, a mixed one on the 7- and 6-word wire walks all;
    results, statistics and verdicts as the JAX path's."""
    batch, pb, tt = case["batch"], case["pb"], case["tt"]
    ok = (batch.ifindex >= 0) & (batch.ifindex < 1 << 16)
    if width in (3, 4):
        idx = np.nonzero(ok & (batch.kind != 2) & ~batch.ip_words[:, 1:].any(axis=1))[0]
        n_levels = layout.v4_trie_depth(tt.n_levels)
    else:
        idx = np.nonzero(ok)[0]
        n_levels = tt.n_levels
    sub = pb.take(idx)
    wire_np = _wire(sub, width)
    assert wire_np.shape == (len(idx), width)
    fused = walk.classify_walk_wire_fused(tt, torch.from_numpy(wire_np.view(np.int32)), n_levels)
    res16, stats = torchpath.split_wire_outputs(fused.numpy(), len(idx))
    results, xdp = torchpath.host_finalize_wire(res16, sub.kind)
    np.testing.assert_array_equal(results, case["res"][idx] & 0xFFFF)
    np.testing.assert_array_equal(xdp, case["xdp"][idx])
    ref = oracle.classify(case["pt"], sub)
    assert {r: list(v) for r, v in enumerate(torchpath.merge_stats_host(stats).tolist())
            if any(v)} == ref.stats


def test_depth_class_truncation(case):
    """A chunk of depth class d walks 1 + d levels and an IPv4-only chunk
    the levels within /32, with the JAX full walk's verdicts; walking too
    few levels does change verdicts (the steering has teeth)."""
    batch, pb, tt, pt = case["batch"], case["pb"], case["tt"], case["pt"]
    idx6 = np.nonzero(batch.kind == 2)[0]
    groups = layout.depth_group_indices(
        np.asarray(pt.root_lut, np.int64), layout.build_depth_lut(pt),
        layout.tune_depth_classes(pt), batch.ifindex, batch.ip_words, idx6)
    jobs = [(layout.v4_trie_depth(tt.n_levels), np.nonzero(batch.kind != 2)[0])]
    jobs += [(tt.n_levels if d is None else 1 + d, g) for d, g in groups]
    assert len(jobs) >= 4
    for n_levels, idx in jobs:
        res, xdp, _ = walk.classify_walk(tt, torchpath.device_batch(pb.take(idx), "cpu"), n_levels)
        _assert_same((res.numpy(), xdp.numpy()), case["res"][idx], case["xdp"][idx])
    deep = groups[-1][1]
    res, _, _ = walk.classify_walk(tt, torchpath.device_batch(pb.take(deep), "cpu"), 1)
    assert (res.numpy().view(np.uint32) != case["res"][deep]).any()


def test_classifier_steering_and_stale_generation(case):
    """TorchClassifier's packed entry points: every depth group of the
    current generation as the JAX full walk; a token of an older
    generation walks every level instead of its class's depth."""
    batch, pb = case["batch"], case["pb"]
    clf = TorchClassifier(device="cpu", force_path="trie")
    clf.load_tables(case["pt"])
    idx6 = np.nonzero(batch.kind == 2)[0]
    groups = clf.v6_depth_groups(pb.ifindex, pb.ip_words, idx6)
    gen = groups[0][0][1]
    assert [d for d, _ in clf.serving_shape_classes()][:-1] == list(
        layout.tune_depth_classes(case["pt"]))
    for depth, idx in groups:
        wire, v4 = pb.pack_wire_subset(idx)
        out = clf.classify_async_packed(wire, v4, apply_stats=False, depth=depth).result()
        np.testing.assert_array_equal(out.results, case["res"][idx] & 0xFFFF)
    deep = groups[-1][1]
    wire, v4 = pb.pack_wire_subset(deep)
    under = clf.classify_async_packed(wire, v4, apply_stats=False, depth=(0, gen)).result()
    assert (under.results != case["res"][deep]).any()
    clf.load_tables(case["pt"])  # a new generation of the same tables
    stale = clf.classify_async_packed(wire, v4, apply_stats=False, depth=(0, gen)).result()
    np.testing.assert_array_equal(stale.results, case["res"][deep])
    plan = clf.prepare_packed(wire, v4, depth=(None, gen + 1))
    np.testing.assert_array_equal(clf.classify_prepared(plan).result().results, case["res"][deep])


def test_classifier_steered_loop_matches_tpu_fused(case):
    """The daemon's steering loop (family chunk, then v6 depth groups,
    each packed and classified with its (class, generation) token) against
    TpuClassifier(force_path="trie", fused_deep=True)."""
    batch, pb = case["batch"], case["pb"]
    jclf = TpuClassifier(force_path="trie", fused_deep=True)
    clf = TorchClassifier(device="cpu", force_path="trie")
    try:
        jclf.load_tables(case["jt"])
        clf.load_tables(case["pt"])
        assert clf.active_path == jclf.active_path == "trie"
        idx6 = np.nonzero(batch.kind == 2)[0]
        jgroups = jclf.v6_depth_groups(batch.ifindex, batch.ip_words, idx6)
        groups = clf.v6_depth_groups(pb.ifindex, pb.ip_words, idx6)
        assert [d for (d, _g), _ in groups] == [d for (d, _g), _ in jgroups]
        results = np.zeros(len(batch), np.uint32)
        stats = np.zeros((1024, 4), np.int64)
        jobs = [(None, np.nonzero(batch.kind != 2)[0])] + [(d, g) for d, g in groups]
        for (depth, idx), (jdepth, jidx) in zip(groups, jgroups):
            np.testing.assert_array_equal(idx, jidx)
            jw, jv4 = batch.pack_wire_subset(jidx)
            jout = jclf.classify_async_packed(jw, jv4, apply_stats=False, depth=jdepth).result()
            wire, v4 = pb.pack_wire_subset(idx)
            out = clf.classify_async_packed(wire, v4, apply_stats=False, depth=depth).result()
            for f in ("results", "xdp", "stats_delta"):
                np.testing.assert_array_equal(getattr(out, f), getattr(jout, f), err_msg=f)
        for depth, idx in jobs:
            wire, v4 = pb.pack_wire_subset(idx)
            out = clf.classify_async_packed(wire, v4, depth=depth).result()
            results[idx] = out.results
            stats += out.stats_delta
        np.testing.assert_array_equal(results, case["res"] & 0xFFFF)
        np.testing.assert_array_equal(stats, torchpath.merge_stats_host(case["stats"]))
        np.testing.assert_array_equal(clf.stats.snapshot(), stats)
    finally:
        jclf.close()


def test_auto_path_choice_at_4097_entries():
    """4097 entries: both classifiers pick the trie path on their own."""
    base = jax_testing.random_tables_fast(np.random.default_rng(7), 4097, width=6)
    jt, pt = _compile_pair({tuple(k): v for k, v in base.content.items()}, width=6)
    assert pt.num_entries == jt.num_entries == 4097
    batch = jax_testing.random_batch_fast(np.random.default_rng(8), jt, 1024)
    jclf, clf = TpuClassifier(), TorchClassifier(device="cpu")
    jclf.load_tables(jt)
    clf.load_tables(pt)
    assert clf.active_path == jclf.active_path == "trie"
    jout, out = jclf.classify(batch), clf.classify(port_batch(batch))
    for f in ("results", "xdp", "stats_delta"):
        np.testing.assert_array_equal(getattr(out, f), getattr(jout, f), err_msg=f)
    ref = oracle.classify(pt, port_batch(batch))
    np.testing.assert_array_equal(out.results, ref.results)
    jclf.close()


def test_wide_ruleids_take_the_u32_path(case):
    """ruleIds above 255 do not fit the wire result: both classifiers take
    the full-batch u32 path, packed classify is refused."""
    content = {tuple(k): np.array(v) for k, v in case["jt"].content.items()}
    for key in list(content)[::3]:
        rows = content[key].copy()
        rows[:, 0] = np.where(rows[:, 0] > 0, rows[:, 0] + 300, 0)
        content[key] = rows
    jt, pt = _compile_pair(content)
    batch = case["batch"]
    jclf, clf = TpuClassifier(), TorchClassifier(device="cpu")  # dense refuses the ruleIds
    jclf.load_tables(jt)
    clf.load_tables(pt)
    assert clf.active_path == "trie" and not clf.supports_packed() and not jclf.supports_packed()
    jout, out = jclf.classify(batch), clf.classify(case["pb"])
    for f in ("results", "xdp", "stats_delta"):
        np.testing.assert_array_equal(getattr(out, f), getattr(jout, f), err_msg=f)
    assert (out.results >> 8 > 255).sum() > 50
    with pytest.raises(RuntimeError, match="wide-ruleId"):
        clf.prepare_packed(*case["pb"].pack_wire_subset(np.arange(8)))
    jclf.close()
