"""The port's payload tier (kernels/acmatch.py, payload.py, the classifier's
plans, the resident step's payload stage and the daemon's --payload) on the
CPU against the JAX package's (infw.kernels.acmatch, infw.payload,
TpuClassifier(payload=...) in interpret mode, the JAX daemon), with
equality of integers and no tolerance: the compiled automaton byte for byte;
the plain match against ``jitted_acmatch`` on gather and matmul specs, the
naive reference and the link-walking automaton; the length edge cases; the
merge; the resident entry against the classic one; the classifiers on the
dense, trie and ctrie paths, the stateless, flow, resident and superbatch
plans, shadow and enforce, with scoring and telemetry off and on; a failsafe
lane and a rule Deny that enforce leaves alone; the in-place swap and mode
flip; the artifacts in both directions; both daemons; the flags."""
import os

import numpy as np
import pytest
import torch

import infw.daemon as jax_daemon
from infw import flow as jax_flow
from infw import payload as jpay
from infw import testing as jax_testing
from infw.backend import cpu_ref as jax_cpu_ref
from infw.backend.tpu import TpuClassifier
from infw.kernels import acmatch as jac
from infw.kernels import mxu_score as jms
from infw.kernels import sketch as jsk
from infw.kernels import wire_decode as jwd
from infw.kernels.jaxpath import TCP_ACK, TCP_SYN
from infw_torch import convert, daemon, oracle, packets
from infw_torch import payload as ppay
from infw_torch.backend.cuda import TorchClassifier
from infw_torch.constants import DENY
from infw_torch.kernels import acmatch as pac
from infw_torch.kernels import mxu_score as pms
from infw_torch.kernels import sketch as psk
from infw_torch.kernels import wire_decode as pwd
from infw_torch.kernels.resident import split_resident_payload_outputs

import test_torch_daemon as tdaemon
from test_torch_overlay import _pair

#: the scoring and telemetry geometries beside the payload tier
SCORE = dict(trees=4, depth=3, slots=32, ways=2, cms_depth=2, cms_width=64, sat=511, hidden=4)
TEL = dict(depth=3, width=128, topk=32, ways=2, max_tenants=2)


def _pats(count, plen=64, seed=None):
    rng = np.random.default_rng(count if seed is None else seed)
    return ppay.signature_patterns(rng, count, plen)


# --- the automaton ---------------------------------------------------------------------

SETS = {  # patterns, plen, matmul
    "one": (1, 64, None), "eight": (8, 64, None), "forty": (40, 64, None),
    "sixty_four_128": (64, 128, None), "two_hundred": (200, 64, None),
    "forty_gather_forced": (8, 64, False), "forty_matmul_forced": (40, 64, True),
}


@pytest.mark.parametrize("name", sorted(SETS))
def test_compile_patterns_is_byte_identical(name):
    count, plen, matmul = SETS[name]
    pats = _pats(count, plen)
    assert pats == jpay.signature_patterns(np.random.default_rng(count), count, plen)
    jm = jac.compile_patterns(pats, plen=plen, matmul=matmul)
    pm = pac.compile_patterns(pats, plen=plen, matmul=matmul)
    assert tuple(pm.spec) == tuple(jm.spec) and pm.spec.pwords == jm.spec.pwords
    assert pm.delta.dtype == jm.delta.dtype and pm.matchmap.dtype == jm.matchmap.dtype
    assert pm.delta.tobytes() == jm.delta.tobytes()
    assert pm.matchmap.tobytes() == jm.matchmap.tobytes()
    assert pm.patterns == jm.patterns
    # padded into a wider geometry (a swap target)
    big = jac.AcSpec.make(4 * jm.spec.states, 2 * jm.spec.patterns, plen)
    jb = jac.compile_patterns(pats, plen=plen, spec=big)
    pb = pac.compile_patterns(pats, plen=plen, spec=pac.AcSpec(*big))
    assert pb.delta.tobytes() == jb.delta.tobytes()
    assert pb.matchmap.tobytes() == jb.matchmap.tobytes()


def test_validation_and_spec_refusals_match_jax():
    for bad in ([], [b""], [b"ab", b"ab"], [b"x" * 65]):
        for mod in (jac, pac):
            with pytest.raises(ValueError):
                mod.compile_patterns(bad, plen=64)
    small = pac.AcSpec.make(64, 32, 64)
    with pytest.raises(ValueError, match="states"):
        pac.compile_patterns(_pats(64), spec=small)
    with pytest.raises(ValueError, match="plen"):
        pac.compile_patterns([b"abc"], plen=128, spec=small)
    with pytest.raises(ValueError):
        pac.AcSpec.make(64, 32, plen=96)
    for s, p in ((1, 1), (65, 33), (129, 1000)):
        assert tuple(pac.AcSpec.make(s, p)) == tuple(jac.AcSpec.make(s, p))


# --- the match ---------------------------------------------------------------------------

def _columns(rng, pats, plen, n=160, extra=0):
    """Attack and benign rows, plen edge cases, an optional wider column."""
    pay, lens = ppay.attack_payloads(rng, n, pats, plen)
    bpay, blens = ppay.benign_payloads(rng, n // 4, plen)
    pay, lens = np.concatenate([pay, bpay]), np.concatenate([lens, blens]).astype(np.int32)
    m = pay.shape[0]
    lens[:6] = 0
    lens[6:12] = (-1, -7, -2**31, -64, -65, -128)
    lens[12:18] = (plen + 1, 2 * plen, 2**31 - 1, 1000, plen, plen - 1)
    lens[18:30] = rng.integers(1, plen, 12)
    if extra:
        pay = np.concatenate([pay, rng.integers(0, 256, (m, extra), dtype=np.uint8)], axis=1)
    return np.ascontiguousarray(pay), lens


MATCH = {  # patterns, plen, matmul, extra column bytes
    "gather64": (40, 64, False, 0), "gather128": (64, 128, False, 0),
    "gather_wide": (40, 64, False, 24), "gather_pw8": (200, 64, False, 0),
    "matmul8": (8, 64, True, 0), "matmul_wide": (8, 64, True, 40),
    "matmul128": (8, 128, True, 0),
}


@pytest.mark.parametrize("name", sorted(MATCH))
def test_plain_match_equals_jitted_acmatch(name):
    """acmatch_plain against jitted_acmatch (the gather or the one-hot
    matmul path), payload_match_ref (both packages') and HostAcAutomaton, on
    attack and benign rows with plen 0, negative, past L and a column wider
    than L."""
    count, plen, matmul, extra = MATCH[name]
    pats = _pats(count, plen)
    jm = jac.compile_patterns(pats, plen=plen, matmul=matmul)
    pm = convert.ac_model_from_jax(jm)
    assert jm.spec.matmul == matmul and (not matmul or jm.spec.states <= 128)
    pay, lens = _columns(np.random.default_rng(count + plen), pats, plen, extra=extra)
    want = np.asarray(jac.jitted_acmatch(jm.spec)(*jac.model_device(jm), pay, lens))
    got = pac.acmatch(pac.model_device(pm, "cpu"), torch.from_numpy(pay), torch.from_numpy(lens),
                      pm.spec).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    assert (got != 0).any(axis=1).sum() > pay.shape[0] // 2
    assert not got[:12].any()  # plen <= 0 walks nothing
    ref = oracle.payload_match_ref(pats, pay, lens, plen, pm.spec.pwords)
    np.testing.assert_array_equal(ref, got)
    # the JAX reference slices pay[i, :plen], from the end for a negative
    # plen, which its kernel treats as 0: held on the other rows
    nonneg = lens >= 0
    np.testing.assert_array_equal(jax_cpu_ref.payload_match_ref(
        pats, pay[nonneg], lens[nonneg], plen, pm.spec.pwords), got[nonneg])
    np.testing.assert_array_equal(pac.host_match_bitmap(pm, pay, lens), got)
    ac = oracle.HostAcAutomaton(pats)
    for i in range(pay.shape[0]):
        n = int(min(max(int(lens[i]), 0), plen))
        bits = {j for j in range(len(pats)) if (int(got[i, j // 32]) >> (j % 32)) & 1}
        assert ac.matches(pay[i, :n].tobytes()) == bits, i


def test_truncation_claims_nothing_across_the_cut():
    """An occurrence that ends past min(plen, L) claims nothing; one that
    ends exactly there is claimed."""
    pats = [b"abcd", b"cd", b"zz"]
    m = pac.compile_patterns(pats)
    pay = np.zeros((6, 64), np.uint8)
    pay[:, 60:64] = np.frombuffer(b"abcd", np.uint8)
    lens = np.asarray([64, 63, 62, 61, 200, 0], np.int32)
    got = pac.acmatch(pac.model_device(m, "cpu"), torch.from_numpy(pay), torch.from_numpy(lens),
                      m.spec).numpy().view(np.uint32)[:, 0]
    np.testing.assert_array_equal(got, [3, 0, 0, 0, 3, 0])
    np.testing.assert_array_equal(
        oracle.payload_match_ref(pats, pay, lens, 64, 1)[:, 0], got)


def test_merge_and_resident_entry_equal_jax_and_the_classic_entry():
    """payload_merge_plain against _payload_merge_core in both modes (failsafe
    lanes, rule Denies, UNDEF and Allow verdicts), host_payload_rewrite
    against the JAX one, and the resident entry's words against the classic
    match + merge over the same lanes."""
    import jax.numpy as jnp

    pats = _pats(40)
    pm = pac.compile_patterns(pats)
    rng = np.random.default_rng(7)
    B = 77
    pay, lens = ppay.attack_payloads(rng, B, pats, 64)
    lens[::5] = 0
    proto = rng.choice([6, 17, 1, 132], B).astype(np.int32)
    dport = rng.choice([22, 68, 80, 443, 6443, 10250], B).astype(np.int32)
    res = (rng.integers(0, 3, B) | (rng.integers(0, 9, B) << 8)).astype(np.uint32)
    dev = pac.model_device(pm, "cpu")
    bitmap = pac.acmatch(dev, torch.from_numpy(pay), torch.from_numpy(lens), pm.spec)
    for enforce in (0, 1):
        pmode = torch.tensor([enforce], dtype=torch.int32)
        got = pac.payload_merge_plain(torch.from_numpy(res.astype(np.int64)), bitmap, pmode,
                                      torch.from_numpy(proto), torch.from_numpy(dport))
        want = jac._payload_merge_core(jnp.asarray(res), jnp.asarray(bitmap.numpy().view(np.uint32)),
                                       jnp.asarray([enforce], jnp.int32), jnp.asarray(proto),
                                       jnp.asarray(dport))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(g.numpy().dtype))
        assert got[1].any() and (not enforce or got[2].any())
        fs = pms.failsafe_lane_mask_np(proto, dport)
        assert not got[2].numpy()[fs | ((res & 0xFF) == DENY)].any()
        host = pac.host_payload_rewrite(pm, res, bitmap.numpy().view(np.uint32), bool(enforce),
                                        proto, dport)
        np.testing.assert_array_equal(host, jac.host_payload_rewrite(
            None, res, bitmap.numpy().view(np.uint32), bool(enforce), proto, dport))
        np.testing.assert_array_equal(host, got[0].numpy())
        # the resident entry: half the lanes served by the probe
        wire = np.zeros((B, 7), np.uint32)
        wire[:, 0] = 1 | (1 << 2) | (proto.astype(np.uint32) << 3)
        wire[:, 1] = dport.astype(np.uint32)
        hit = rng.random(B) < 0.5
        served = np.where(hit, res & 0xFFFF, 0)
        stateless = np.where(hit, 0, res & 0xFFFF)
        from infw_torch.kernels.flow import pack_bits32
        from infw_torch.kernels.torchpath import _pack_res16

        sw = _pack_res16(torch.from_numpy(served.astype(np.int64)))
        rw = _pack_res16(torch.from_numpy(stateless.astype(np.int64)))
        hw = pack_bits32(torch.from_numpy(hit))
        nh = -(-B // 32)
        tail = torch.full((2 * nh,), -9, dtype=torch.int32)
        ops = pac.PayloadOps(dev, pmode, pm.spec, torch.from_numpy(pay), torch.from_numpy(lens))
        pac.acmatch_resident(ops, torch.from_numpy(wire.view(np.int32)), sw, hw, rw, tail)
        want16 = _pack_res16(got[0]).numpy()
        np.testing.assert_array_equal(sw.numpy(), want16)
        np.testing.assert_array_equal(rw.numpy(), want16)
        np.testing.assert_array_equal(tail[:nh].numpy(), pack_bits32(got[1]).numpy())
        np.testing.assert_array_equal(tail[nh:].numpy(), pack_bits32(got[2]).numpy())


def test_helpers_generators_and_batch_columns_match_jax():
    assert pwd.PAYLOAD_PREFIX_WIDTHS == jwd.PAYLOAD_PREFIX_WIDTHS
    rng = np.random.default_rng(3)
    for n in (0, 1, 63, 64, 65, 128, 129, 400):
        assert pwd.payload_prefix_bucket(n) == jwd.payload_prefix_bucket(n)
    for w in (5, 64, 100, 128, 200):
        pay = rng.integers(0, 256, (9, w), dtype=np.uint8)
        lens = rng.integers(-5, 300, 9).astype(np.int32)
        for a, b in zip(pwd.pad_payload_prefix(pay, lens), jwd.pad_payload_prefix(pay, lens)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    pats = _pats(32)
    for fn in ("benign_payloads", "attack_payloads"):
        args = (20,) if fn == "benign_payloads" else (20, pats)
        for plen in (64, 128):
            a = getattr(ppay, fn)(np.random.default_rng(9), *args, plen=plen)
            b = getattr(jpay, fn)(np.random.default_rng(9), *args, plen=plen)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    batch = packets.make_batch(src=["10.0.0.1", "10.0.0.2", "10.0.0.3"], proto=[6, 17, 6],
                               ifindex=[2, 2, 2], dst_port=[80, 53, 22])
    batch.payload = rng.integers(0, 256, (3, 64), dtype=np.uint8)
    batch.payload_len = np.asarray([3, 64, 0], np.int32)
    np.testing.assert_array_equal(batch.slice(1, 3).payload, batch.payload[1:3])
    np.testing.assert_array_equal(batch.take(np.asarray([2, 0])).payload_len, [0, 3])
    padded = batch.pad_to(8)
    assert padded.payload.shape == (8, 64) and not padded.payload[3:].any()
    np.testing.assert_array_equal(padded.payload_len, [3, 64, 0, 0, 0, 0, 0, 0])
    assert batch.slice(0, 1).tcp_flags is None and padded.kind[3] == 3


# --- the classifiers ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def tabs():
    """The JAX tests' 48-entry table on both sides."""
    jt0 = jax_testing.random_tables(np.random.default_rng(3), n_entries=48, width=8)
    jt, pt = _pair({tuple(k): np.array(v) for k, v in jt0.content.items()})
    return {"j0": jt0, "jt": jt, "pt": pt}


def _traffic(tables, seed, pats, b=64, plen=64):
    """Packets with flags and a payload column: a third attack rows (a few
    on failsafe cells), the rest benign, lengths with the edge cases."""
    rng = np.random.default_rng(seed)
    batch = jax_testing.random_batch(rng, tables, b)
    batch.tcp_flags = np.where(rng.random(b) < 0.3, TCP_SYN, TCP_ACK).astype(np.int32)
    pay, lens = ppay.benign_payloads(rng, b, plen)
    att = rng.random(b) < 0.35
    apay, alens = ppay.attack_payloads(rng, int(att.sum()), pats, plen)
    pay[att], lens[att] = apay, alens
    lens[rng.random(b) < 0.05] = 0
    fs = np.nonzero(att)[0][:4]
    batch.proto[fs], batch.dst_port[fs] = 6, 22  # failsafe cells
    return batch, np.ascontiguousarray(pay), lens.astype(np.int32)


def _admit(clf, batch, pay, lens, k=0, how="packed"):
    if k:
        stack = np.stack([batch.pack_wire()] * k)
        flags = np.stack([np.asarray(batch.tcp_flags, np.int32)] * k)
        return [r.result() for r in clf.classify_prepared_super(
            clf.prepare_packed_super(stack, False, flags, payload_stack=np.stack([pay] * k),
                                     payload_len_stack=np.stack([lens] * k)),
            apply_stats=False)]
    if how == "batch":
        batch.payload, batch.payload_len = pay, lens
        try:
            return [clf.classify(batch, apply_stats=False)]
        finally:
            batch.payload = batch.payload_len = None
    w, v4 = batch.pack_wire_subset(np.arange(len(batch), dtype=np.int64))
    return [clf.classify_prepared(clf.prepare_packed(w, v4, tcp_flags=batch.tcp_flags,
                                                     payload=pay, payload_len=lens),
                                  apply_stats=False).result()]


PLANS = {  # path, flow table, resident, superbatch K, scoring, telemetry, how
    "stateless": ("trie", False, False, 0, False, False, "packed"),
    "stateless_batch": ("trie", False, False, 0, False, False, "batch"),
    "flow": ("trie", True, False, 0, False, False, "packed"),
    "resident": ("trie", True, True, 0, False, False, "packed"),
    "superbatch": ("trie", True, True, 4, False, False, "packed"),
    "dense_stateless_batch": ("dense", False, False, 0, False, False, "batch"),
    "dense_flow": ("dense", True, False, 0, False, False, "packed"),
    "dense_resident": ("dense", True, True, 0, False, False, "packed"),
    "ctrie_stateless": ("ctrie", False, False, 0, False, False, "packed"),
    "ctrie_resident": ("ctrie", True, True, 0, False, False, "packed"),
    "trie_flow_scored": ("trie", True, False, 0, True, True, "packed"),
    "dense_resident_scored": ("dense", True, True, 0, True, True, "packed"),
    "ctrie_superbatch_scored": ("ctrie", True, True, 4, True, True, "packed"),
    "dense_stateless_scored": ("dense", False, False, 0, True, True, "packed"),
}


@pytest.mark.parametrize("mode", ["shadow", "enforce"])
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_classifier_matches_tpu_classifier(tabs, plan, mode):
    """TorchClassifier(device="cpu", payload=...) against TpuClassifier(
    interpret=True, payload=...) on the same admissions: equal results, XDP,
    statistics, payload counters and retained masks, flow columns and
    counters, and with scoring and the telemetry plane on their tensors and
    counters.  In enforce mode matched lanes come back Deny (ruleId 0) but a
    failsafe lane or a rule Deny, and on the flow plans the second pass over
    the same packets serves the enforced verdicts from the cache."""
    path, use_flow, resident, k, scored, tel, how = PLANS[plan]
    fp = None if path == "dense" else path
    pats = _pats(40)
    jkw, pkw = {}, {}
    if use_flow:
        jkw.update(flow_table=jax_flow.FlowConfig.make(entries=1024), resident=resident)
        pkw.update(flow_table=1024, resident=resident)
    if scored:
        jspec, pspec = jms.ScoreSpec.make(**SCORE), pms.ScoreSpec.make(**SCORE)
        jkw.update(mlscore=jspec, mlscore_model=jms.clamp_stress_model(jspec))
        pkw.update(mlscore=pspec, mlscore_model=pms.clamp_stress_model(pspec))
    if tel:
        jkw["telemetry"] = jsk.SketchSpec.make(**TEL)
        pkw["telemetry"] = psk.SketchSpec.make(**TEL)
    jc = TpuClassifier(force_path=fp, interpret=True, payload=pats, payload_mode=mode,
                       payload_track=True, **jkw)
    pc = TorchClassifier(device="cpu", force_path=fp, payload=pats, payload_mode=mode,
                         payload_track=True, **pkw)
    jc.load_tables(tabs["jt"])
    pc.load_tables(tabs["pt"])
    assert pc.active_path == path and pc.payload.spec == tuple(jc.payload.spec)
    last = None
    for i in range(4):
        batch, pay, lens = _traffic(tabs["j0"], 500 + i % 2, pats)
        got, want = _admit(pc, batch, pay, lens, k, how), _admit(jc, batch, pay, lens, k, how)
        assert len(got) == len(want) == max(k, 1)
        for o2, o1 in zip(got, want):
            np.testing.assert_array_equal(o2.results, o1.results, err_msg=f"{plan} {mode} {i}")
            np.testing.assert_array_equal(o2.xdp, o1.xdp)
            np.testing.assert_array_equal(o2.stats_delta, o1.stats_delta)
        last = (batch, pay, lens, got[-1])
    assert pc.payload_counters() == jc.payload_counters()
    counts = pc.payload_counters()
    assert counts["payload_admissions_total"] == 4 * max(k, 1)
    assert counts["payload_matched_total"] > 0
    assert (counts["payload_enforced_total"] > 0) == (mode == "enforce")
    m1, m2 = jc.payload.recent_masks(), pc.payload.recent_masks()
    assert len(m1) == len(m2) == 4 * max(k, 1)
    for a, b in zip(m1, m2):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, np.asarray(x))
    assert pc.wire_stats() == jc.wire_stats()
    if use_flow:
        f1, f2 = jc.flow.flow_columns(), pc.flow.flow_columns()
        for f in f2:
            np.testing.assert_array_equal(f2[f], np.asarray(f1[f]), err_msg=f)
        assert pc.flow_counters() == jc.flow_counters()
        assert pc.flow_counters()["flow_hits_total"] > 0
    if scored:
        assert pc.mlscore_counters() == jc.mlscore_counters()
    if tel:
        t1, t2 = jc.telemetry.columns(), pc.telemetry.columns()
        for f in t2:
            np.testing.assert_array_equal(t2[f], np.asarray(t1[f]), err_msg=f)
        assert pc.telemetry_counters() == jc.telemetry_counters()
    batch, pay, lens, out = last
    matched = pac.host_match_bitmap(pc.payload.model, pay, lens).any(axis=1)
    fs = pms.failsafe_lane_mask_np(batch.proto, batch.dst_port)
    if mode == "enforce" and not scored:
        rules = TorchClassifier(device="cpu", force_path=fp)
        rules.load_tables(tabs["pt"])
        ref = rules.classify(batch, apply_stats=False).results
        rw = matched & ~fs & ((ref & 0xFF) != DENY)
        assert rw.any() and (out.results[rw] == DENY).all()
        keep = ~rw
        np.testing.assert_array_equal(out.results[keep], ref[keep])
        assert (matched & fs).any()
    for c in (jc, pc):
        c.close()


@pytest.mark.parametrize("plan", ["stateless", "flow", "resident"])
def test_enforce_leaves_failsafe_lanes_and_rule_denies_alone(tabs, plan):
    """Every lane matched in enforce mode: the failsafe lanes and the rule
    Denies keep their rule verdicts (a rule Deny keeps its ruleId), every
    other lane comes back Deny with ruleId 0, as in the JAX package."""
    pats = [b"GET ", b"HTTP/1.1"]
    kw = {"stateless": {}, "flow": {"flow_table": 1024},
          "resident": {"flow_table": 1024, "resident": True}}[plan]
    jkw = dict(kw)
    if "flow_table" in jkw:
        jkw["flow_table"] = jax_flow.FlowConfig.make(entries=1024)
    pc = TorchClassifier(device="cpu", force_path="trie", payload=pats, payload_mode="enforce",
                         **kw)
    jc = TpuClassifier(force_path="trie", payload=pats, payload_mode="enforce", interpret=True,
                       **jkw)
    rules = TorchClassifier(device="cpu", force_path="trie")
    for c, t in ((pc, tabs["pt"]), (jc, tabs["jt"]), (rules, tabs["pt"])):
        c.load_tables(t)
    rng = np.random.default_rng(21)
    batch = jax_testing.random_batch(rng, tabs["j0"], 96)
    batch.tcp_flags = np.full(96, TCP_ACK, np.int32)
    batch.proto[:6], batch.dst_port[:6] = (6, 6, 6, 17, 6, 6), (22, 2379, 6443, 68, 10250, 10259)
    pay = np.zeros((96, 64), np.uint8)
    line = b"GET / HTTP/1.1\r\n"
    pay[:, :len(line)] = np.frombuffer(line, np.uint8)
    lens = np.full(96, len(line), np.int32)
    ref = rules.classify(batch, apply_stats=False).results
    for _ in range(2):
        got, want = _admit(pc, batch, pay, lens)[0], _admit(jc, batch, pay, lens)[0]
        np.testing.assert_array_equal(got.results, want.results)
        np.testing.assert_array_equal(got.stats_delta, want.stats_delta)
        fs = pms.failsafe_lane_mask_np(batch.proto, batch.dst_port)
        deny = (ref & 0xFF) == DENY
        assert fs[:6].all() and deny.any() and (deny & ~fs).any()
        keep = fs | deny
        np.testing.assert_array_equal(got.results[keep], ref[keep])
        assert (got.results[~keep] == DENY).all()
    assert pc.payload_counters() == jc.payload_counters()
    # the flow plans' second pass serves the cached Deny: nothing to rewrite
    enforced = pc.payload_counters()["payload_enforced_total"]
    assert enforced == 2 * int((~keep).sum()) if plan == "stateless" else enforced >= int(
        (~keep).sum())
    for c in (pc, jc, rules):
        c.close()


def test_empty_chunk_moves_no_payload_counter(tabs):
    """An empty chunk on the stateless, flow and resident plans leaves the
    payload counters where they were (no tier moves on an empty chunk; the JAX
    dense stateless plan counts an empty admission, ROADMAP.md §3)."""
    pats = _pats(40)
    for kw in ({}, {"flow_table": 1024}, {"flow_table": 1024, "resident": True}):
        pc = TorchClassifier(device="cpu", force_path="trie", payload=pats,
                             payload_mode="enforce", **kw)
        pc.load_tables(tabs["pt"])
        batch, pay, lens = _traffic(tabs["j0"], 9, pats)
        _admit(pc, batch, pay, lens)
        before = pc.payload_counters()
        for width in (4, 7):
            out = pc.classify_prepared(pc.prepare_packed(
                np.zeros((0, width), np.uint32), width == 4, payload=np.zeros((0, 64), np.uint8),
                payload_len=np.zeros(0, np.int32))).result()
            assert out.results.shape == (0,)
        assert pc.payload_counters() == before
        pc.close()
    jc = TpuClassifier(payload=pats, payload_mode="enforce", interpret=True)
    jc.load_tables(tabs["jt"])
    w = np.zeros((0, 7), np.uint32)
    jc.classify_prepared(jc.prepare_packed(w, False, payload=np.zeros((0, 64), np.uint8),
                                           payload_len=np.zeros(0, np.int32))).result()
    assert jc.payload_counters()["payload_admissions_total"] == 1


def test_swap_and_mode_flip_write_in_place_and_bump_the_generation(tabs):
    """set_payload_patterns and set_payload_mode rewrite the automaton and
    the mode tensor in place (the addresses a graph baked), bump the flow
    generation, and the cached enforced denies stop being served; a swap that
    needs another geometry raises, as in the JAX package."""
    pats = _pats(40)
    pc = TorchClassifier(device="cpu", force_path="trie", flow_table=1024, resident=True,
                         payload=pats, payload_mode="enforce")
    pc.load_tables(tabs["pt"])
    tier = pc.payload
    ptrs = [t.data_ptr() for t in (*tier._dev, tier._pmode)]
    batch, pay, lens = _traffic(tabs["j0"], 11, pats)
    batch.tcp_flags = np.full(len(batch), TCP_ACK, np.int32)
    o1 = _admit(pc, batch, pay, lens)[0]
    o1b = _admit(pc, batch, pay, lens)[0]
    np.testing.assert_array_equal(o1.results, o1b.results)
    assert pc.flow_counters()["flow_hits_total"] > 0
    rules = TorchClassifier(device="cpu", force_path="trie")
    rules.load_tables(tabs["pt"])
    ref = rules.classify(batch, apply_stats=False).results
    assert (o1.results != ref).any()
    gen0 = int(pc.flow._gens_host[0])
    other = _pats(40, seed=99)
    pc.set_payload_patterns(other)
    assert int(pc.flow._gens_host[0]) == gen0 + 1
    assert tier.version == 1 and tier.counter_values()["payload_pattern_swaps_total"] == 1
    o2 = _admit(pc, batch, pay, lens)[0]
    want2 = pac.host_payload_rewrite(tier.model, ref, pac.host_match_bitmap(tier.model, pay, lens),
                                     True, batch.proto, batch.dst_port)
    np.testing.assert_array_equal(o2.results & 0xFFFF, want2 & 0xFFFF)
    pc.set_payload_mode("shadow")
    assert int(pc.flow._gens_host[0]) == gen0 + 2 and int(tier._pmode[0]) == 0
    o3 = _admit(pc, batch, pay, lens)[0]
    np.testing.assert_array_equal(o3.results, ref)
    assert ptrs == [t.data_ptr() for t in (*tier._dev, tier._pmode)]
    with pytest.raises(ValueError, match="states"):
        pc.set_payload_patterns(_pats(300))
    with pytest.raises(ValueError, match="geometry"):
        pc.set_payload_patterns(pac.compile_patterns(_pats(300)))
    with pytest.raises(ValueError):
        tier.set_mode("block")
    jc = TpuClassifier(payload=pats, interpret=True)
    with pytest.raises(ValueError, match="states"):
        jc.set_payload_patterns(_pats(300))
    with pytest.raises(ValueError, match="geometry"):
        jc.set_payload_patterns(jac.compile_patterns(_pats(300)))
    pc.close()
    off = TorchClassifier(device="cpu")
    assert off.payload is None and off.payload_counters() == {}
    with pytest.raises(RuntimeError):
        off.set_payload_mode("enforce")


def test_resident_payload_tail_and_rebucket(tabs):
    """The step's payload tail anchors from the end with and without the
    scoring extension, and the pool's re-bucketing keeps the first n lanes'
    bits."""
    from infw_torch.kernels.flow import pack_bits32
    from infw_torch.kernels.resident import resident_out_words
    from infw_torch.resident import _rebucket

    rng = np.random.default_rng(2)
    for score in (False, True):
        for b, bucket in ((5, 8), (33, 64), (64, 64)):
            nwb, nhb = (bucket + 1) // 2, -(-bucket // 32)
            L = resident_out_words(bucket, score, True)
            assert L == nwb + nhb + 6 + (nhb + nwb if score else 0) + 2 * nhb
            arr = rng.integers(-2**31, 2**31, (1, L)).astype(np.int32)
            lanes = np.arange(bucket) < b
            arr[0, L - 2 * nhb: L - nhb] = pack_bits32(torch.from_numpy(lanes)).numpy()
            out = _rebucket(arr, b, bucket, score, True)
            assert out.shape[1] == resident_out_words(b, score, True)
            full = split_resident_payload_outputs(arr[0], bucket, score)
            mine = split_resident_payload_outputs(out[0], b, score)
            np.testing.assert_array_equal(mine[-2], full[-2][:b])
            np.testing.assert_array_equal(mine[-1], full[-1][:b])
            assert mine[-2].all()


# --- artifacts ---------------------------------------------------------------------------

def test_artifacts_load_in_both_packages_and_corruption_is_refused(tmp_path):
    pats = _pats(40)
    for i, (save, load) in enumerate(((jpay.save_patterns, ppay.load_patterns),
                                      (ppay.save_patterns, jpay.load_patterns),
                                      (ppay.save_patterns, ppay.load_patterns))):
        path = str(tmp_path / f"p{i}.npz")
        m = save(pats, path, plen=128, version=f"v{i}")
        assert m == path + ".json"
        got, spec, ver = load(path)
        assert got == pats and ver == f"v{i}" and spec.plen == 128
        assert tuple(spec) == tuple(jac.compile_patterns(pats, plen=128).spec)
    a, b = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    jpay.save_patterns(pats, a, version="x")
    ppay.save_patterns(pats, b, version="x")
    assert open(a, "rb").read() == open(b, "rb").read()
    assert open(a + ".json").read() == open(b + ".json").read()
    with open(b, "ab") as f:
        f.write(b"junk")
    for load in (ppay.load_patterns, jpay.load_patterns):
        with pytest.raises(ValueError, match="checksum"):
            load(b)
    os.unlink(a + ".json")
    with pytest.raises(ValueError, match="manifest"):
        ppay.load_patterns(a)
    c = str(tmp_path / "c.npz")
    ppay.save_patterns(pats, c)
    doc = open(c + ".json").read().replace("infw-acmatch-v1", "other")
    open(c + ".json", "w").write(doc)
    with pytest.raises(ValueError, match="format"):
        ppay.load_patterns(c)
    # an artifact through the classifier's constructor
    d = str(tmp_path / "d.npz")
    ppay.save_patterns(pats, d, plen=128)
    clf = TorchClassifier(device="cpu", payload=d)
    assert clf.payload.spec.plen == 128 and list(clf.payload.model.patterns) == pats


def test_ac_model_from_jax_and_the_constructor_forms(monkeypatch):
    jm = jac.compile_patterns(_pats(70), plen=128)
    pm = convert.ac_model_from_jax(jm)
    assert tuple(pm.spec) == tuple(jm.spec)
    assert pm.delta.tobytes() == jm.delta.tobytes() and pm.matchmap.tobytes() == jm.matchmap.tobytes()
    assert pm.patterns == jm.patterns and pm.delta is not jm.delta
    with pytest.raises(ValueError):
        convert.ac_model_from_jax(jm._replace(delta=jm.delta[:10]))
    for e in ("INFW_PAYLOAD", "INFW_PAYLOAD_MODE"):
        monkeypatch.delenv(e, raising=False)
    assert TorchClassifier(device="cpu").payload is None
    forms = [(pm, None), (list(pm.patterns), 128), (True, None), (12, None), ("5", None)]
    for form, plen in forms:
        c = TorchClassifier(device="cpu", payload=form, payload_plen=plen)
        j = TpuClassifier(payload=form if not isinstance(form, pac.AcModel) else jm,
                          payload_plen=plen, interpret=True)
        assert tuple(c.payload.spec) == tuple(j.payload.spec)
        assert list(c.payload.model.patterns) == list(j.payload.model.patterns)
        assert c.payload.mode == "shadow"
    tier = ppay.PayloadTier(pm, device="cpu")
    assert TorchClassifier(device="cpu", payload=tier).payload is tier
    monkeypatch.setenv("INFW_PAYLOAD", "7")
    monkeypatch.setenv("INFW_PAYLOAD_MODE", "enforce")
    c = TorchClassifier(device="cpu")
    assert len(c.payload.model.patterns) == 7 and c.payload.mode == "enforce"
    assert int(c.payload._pmode[0]) == 1
    assert TorchClassifier(device="cpu", payload=False).payload is None


# --- K11's kernel layout -----------------------------------------------------------------

#: automata of the layout tests: patterns, plen, pattern seed (bench_payload's
#: set is seed 11; the ladder's chip_smoke.k11_model seeds, 100 + count)
LAYOUT_SETS = {
    "bench_payload": (64, 64, 11), "ladder64x64": (64, 64, 164),
    "ladder64x128": (64, 128, 164), "ladder256x64": (256, 64, 356),
    "ladder256x128": (256, 128, 356), "ladder1024x64": (1024, 64, 1124),
    "ladder1024x128": (1024, 128, 1124),
}


def _layout_columns(rng, pats, plen, n=400):
    """bench_payload's mix (10% planted signatures, benign HTTP prefixes)
    with the length edge cases in front."""
    k = n // 10
    pa, la = ppay.attack_payloads(rng, k, pats, plen)
    pb, lb = ppay.benign_payloads(rng, n - k, plen)
    perm = rng.permutation(n)
    pay = np.ascontiguousarray(np.concatenate([pa, pb])[perm])
    lens = np.concatenate([la, lb])[perm].astype(np.int32)
    lens[:8] = (0, -1, plen + 1, 2**31 - 1, -2**31, plen, plen - 1, 1)
    return pay, lens


def _check_layout(m, lay):
    """The layout's invariants against its (delta, matchmap)."""
    S = m.spec.states
    perm = lay.perm
    assert perm[0] == 0 and np.array_equal(np.sort(perm), np.arange(S))
    order = np.argsort(perm)  # kernel id -> state id
    reach = lay.depth >= 0
    n_reach = int(reach.sum())
    # reachable first, by depth (never decreasing) then id; the rest by id
    assert reach[:n_reach].all() and not reach[n_reach:].any()
    assert (np.diff(lay.depth[:n_reach]) >= 0).all()
    for d in np.unique(lay.depth[:n_reach]):
        ids = order[:n_reach][lay.depth[:n_reach] == d]
        assert (np.diff(ids) > 0).all()
    assert (np.diff(order[n_reach:]) > 0).all()
    np.testing.assert_array_equal(lay.depth, pac.bfs_depth(m.delta)[order])
    # every entry: the renumbered clipped target, the flag iff its row reports
    shift = 15 if lay.next.dtype == np.uint16 else 31
    e = lay.next.astype(np.int64)
    target = np.clip(m.delta.astype(np.int64), 0, S - 1)[order]
    np.testing.assert_array_equal(e & ((1 << shift) - 1), perm[target])
    np.testing.assert_array_equal((e >> shift) != 0, m.matchmap.any(axis=1)[target])
    np.testing.assert_array_equal(lay.mrows, m.matchmap[order])
    np.testing.assert_array_equal(lay.head, [n_reach])


@pytest.mark.parametrize("name", sorted(LAYOUT_SETS) + ["out_of_range_delta"])
def test_kernel_layout_walk_equals_plain_and_jitted_acmatch(name):
    """K11's layout (a BFS permutation with pi(0) = 0, the flag of each
    entry equal to "the target's matchmap row is non-zero") and a plain walk
    over it, bit for bit equal to acmatch_plain and the JAX package's
    jitted_acmatch: bench_payload's mix, the 64 / 256 / 1024-pattern ladder
    automata at 64 and 128 B, the length edge cases, and a delta seeded
    with negative and >= S entries (the clip folded into the table)."""
    count, plen, seed = LAYOUT_SETS.get(name, (64, 64, 11))
    pats = _pats(count, plen, seed=seed)
    jm = jac.compile_patterns(pats, plen=plen)
    rng = np.random.default_rng(count + plen)
    if name == "out_of_range_delta":
        delta = jm.delta.copy()
        at = rng.integers(0, delta.size, 4000)
        delta.flat[at] = rng.choice([-1, -7, -2**31, jm.spec.states, 10**6, 2**31 - 1], 4000)
        jm = jm._replace(delta=delta)
    pm = convert.ac_model_from_jax(jm)
    lay = pac.kernel_layout(pm.delta, pm.matchmap)
    assert lay.next.dtype == np.uint16
    _check_layout(pm, lay)
    pay, lens = _layout_columns(rng, pats, plen)
    dev = pac.model_device(pm, "cpu")
    assert np.array_equal(dev.next.numpy().view(np.uint16), lay.next)
    p, n = torch.from_numpy(pay), torch.from_numpy(lens)
    got, hit = pac.layout_walk_plain(dev, p, n, pm.spec)
    want = pac.acmatch_plain(dev, p, n, pm.spec)
    assert torch.equal(got, want) and torch.equal(hit, (want != 0).any(dim=1))
    jax_want = np.asarray(jac.jitted_acmatch(jm.spec)(*jac.model_device(jm), pay, lens))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), jax_want)
    assert hit[8:].any() and not hit[[0, 1, 4]].any()


def test_kernel_layout_above_32768_states_takes_32_bit_entries():
    """A spec of 65536 states: 32-bit entries, the flag in bit 31, and the
    walk over them equal to acmatch_plain."""
    pats = _pats(64, 64, seed=11)
    pm = pac.compile_patterns(pats, spec=pac.AcSpec.make(65536, 64, 64))
    lay = pac.kernel_layout(pm.delta, pm.matchmap)
    assert lay.next.dtype == np.uint32 and pac.entry_bytes(pm.spec) == 4
    _check_layout(pm, lay)
    dev = pac.model_device(pm, "cpu")
    assert dev.next.dtype == torch.int32
    pay, lens = _layout_columns(np.random.default_rng(5), pats, 64, n=120)
    p, n = torch.from_numpy(pay), torch.from_numpy(lens)
    got, hit = pac.layout_walk_plain(dev, p, n, pm.spec)
    assert torch.equal(got, pac.acmatch_plain(dev, p, n, pm.spec)) and hit.any()


def test_model_copy_rewrites_the_layout_in_place():
    """After model_copy_ to another set of one spec (another reachable
    count), every tensor equals a fresh model_device's and keeps its
    address, and the first set's host arrays are untouched (the CPU's
    tensors are copies, never views of them); the tier's swap does the
    same."""
    spec = pac.AcSpec.make(1024, 64, 64)
    a = pac.compile_patterns(_pats(64, seed=11), spec=spec)
    b = pac.compile_patterns(_pats(40, seed=3), spec=spec)
    kept = (a.delta.copy(), a.matchmap.copy())
    dev = pac.model_device(a, "cpu")
    ptrs = [t.data_ptr() for t in dev]
    pac.model_copy_(dev, b)
    fresh = pac.model_device(b, "cpu")
    assert [t.data_ptr() for t in dev] == ptrs
    assert all(torch.equal(x, y) for x, y in zip(dev, fresh))
    assert int(fresh.head[-1]) != int(pac.model_device(a, "cpu").head[-1])
    tier = ppay.PayloadTier(a, device="cpu")
    ptrs = [t.data_ptr() for t in tier.ops().dev]
    tier.swap_patterns(b)
    assert [t.data_ptr() for t in tier.ops().dev] == ptrs
    assert all(torch.equal(x, y) for x, y in zip(tier.ops().dev, fresh))
    assert np.array_equal(a.delta, kept[0]) and np.array_equal(a.matchmap, kept[1])


@pytest.mark.parametrize("b", [1, 31, 256, 257, 4096, 1 << 17, (1 << 17) + 1, 1 << 18])
def test_k11_launch_plans(b):
    """plan_for and launch_plan: plan S up to the crossover; at most one
    block an SM, a block's threads whole warps of at most MAX_THREADS that
    with the plan's lanes a thread cover every lane with the stride loop, at
    most the plan's lanes a block short of a full grid; plan S's blocks
    stage the rows their shared memory holds beside the slots, plan L's
    none, a forced count in between."""
    spec = pac.AcSpec.make(1024, 64, 64)
    limit, sms = 232448, 132
    assert pac.plan_for(b) == ("S" if b <= pac.STAGED_PLAN_MAX_LANES else "L")
    for name, (_, per_block, lanes, staged) in pac.PLANS.items():
        lp = pac.launch_plan(name, b, spec, limit, sms)
        assert 1 <= lp.grid <= sms and lp.threads % 32 == 0 and 32 <= lp.threads <= 1024
        assert lp.grid * lp.threads * lanes >= min(b, sms * pac.MAX_THREADS * lanes)
        assert lp.grid == sms or -(-b // lp.grid) <= per_block
        assert lp.rows == (pac.row_cap(spec, limit) if staged else 0)
        if staged:
            assert pac.launch_plan(name, b, spec, limit, sms, rows=1).rows == 1
        with pytest.raises(ValueError):
            pac.launch_plan(name, b, spec, limit, sms, rows=423 if staged else 1)
    assert pac.row_cap(spec, limit) == 422
    assert pac.row_cap(pac.AcSpec.make(64, 8), limit) == 64
    assert pac.row_cap(pac.AcSpec.make(65536, 64), limit) == 211
    with pytest.raises(ValueError):
        pac.launch_plan("X", b, spec, limit, sms)


def test_payload_plans_inputs_and_no_card(capsys):
    """The plan tool's inputs: bench_payload's automaton (seed 11) as the
    JAX package compiles it, its 10% attack mix with the length edge cases
    in front, and the resident entry's operands; without a card it exits 2
    and prints no result."""
    from infw_torch.tools import payload_plans

    model = payload_plans.bench_model()
    jm = jac.compile_patterns(jpay.signature_patterns(np.random.default_rng(11), 64, 64), plen=64)
    assert model.delta.tobytes() == jm.delta.tobytes() and tuple(model.spec) == tuple(jm.spec)
    pay, lens = payload_plans.attack_columns(model, 3000)
    assert pay.shape == (3000, 64) and pay.dtype == np.uint8 and lens.dtype == np.int32
    assert list(lens[:8]) == [0, -1, 65, 2**31 - 1, 64, 63, -2**31, 1]
    hit = (pac.host_match_bitmap(model, pay, lens) != 0).any(axis=1)
    assert 0.05 < hit[8:2048].mean() < 0.2
    wire, served, hitw, res16 = payload_plans.resident_operands(33, "cpu")
    assert wire.shape == (33, 7) and served.numel() == 17 == res16.numel() and hitw.numel() == 2
    if not torch.cuda.is_available():
        assert payload_plans.main(["--sizes", "256"]) == 2
        assert capsys.readouterr().out == ""


# --- the daemons -------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["shadow", "enforce"])
def test_daemons_agree_with_payload(tmp_path, mode):
    """Both daemons with --resident --payload default (32 seeded patterns),
    the same frames files (no payload bytes: served on headers): equal out
    files and equal payload_* lines on /metrics; then a pattern artifact
    dropped into patterns/ hot-swaps in both (consumed, the flow generation
    bumped), a corrupt one is consumed and refused, and a rebuilt classifier
    gets the swapped set back."""
    pats = jpay.signature_patterns(np.random.default_rng(0), 32, plen=64)
    assert pats == ppay.signature_patterns(np.random.default_rng(0), 32, plen=64)
    jreg, preg = tdaemon._registries()
    common = dict(node_name=tdaemon.NODE, poll_period_s=3600.0, metrics_port=0, health_port=0,
                  file_poll_interval_s=60.0, ingest_chunk=tdaemon.CHUNK, pipeline_depth=3,
                  resident=True, payload_mode=mode)
    jd = jax_daemon.Daemon(state_dir=str(tmp_path / "jax"), backend="tpu", registry=jreg,
                           payload=pats, **common)
    pd = daemon.Daemon(state_dir=str(tmp_path / "port"), backend="cpu", registry=preg,
                       payload=pats, **common)
    try:
        doc = tdaemon._nodestate(tdaemon.PATHS["dense"][0])
        for d in (jd, pd):
            assert os.path.isdir(d.patterns_dir)
            tdaemon._write_state(d, doc)
            d.scan_nodestates_once()
            d._payload_maintenance()
        fbs = tdaemon._frames(doc, 4, sizes=(120, 60, 30))
        for d in (jd, pd):
            tdaemon._drop(d, fbs)
        assert jd.process_ingest_once() == pd.process_ingest_once()
        assert tdaemon._out_files(pd) == tdaemon._out_files(jd)
        pclf, jclf = pd.syncer.classifier, jd.syncer.classifier

        def lines(d):
            pre = "ingressnodefirewall_node_payload_"
            return [ln for ln in d.metrics_registry.render_text().splitlines()
                    if ln.startswith(pre)]

        assert lines(pd) and lines(pd) == lines(jd)
        gen0 = int(pclf.flow._gens_host[0])
        new = jpay.signature_patterns(np.random.default_rng(5), 32, plen=64)
        for d, save in ((jd, jpay.save_patterns), (pd, ppay.save_patterns)):
            save(new, os.path.join(d.patterns_dir, "s2.npz"), version="hot-v2")
            d._payload_maintenance()
            assert list(d.syncer.classifier.payload.model.patterns) == new
            assert os.listdir(d.patterns_dir) == []
            p = os.path.join(d.patterns_dir, "bad.npz")
            save(_pats(5), p)
            with open(p, "ab") as f:
                f.write(b"junk")
            d._payload_maintenance()
            assert list(d.syncer.classifier.payload.model.patterns) == new
            assert os.listdir(d.patterns_dir) == []
        assert int(pclf.flow._gens_host[0]) == gen0 + 1
        for d in (jd, pd):
            tdaemon._drop(d, fbs, prefix="g")
        assert jd.process_ingest_once() == pd.process_ingest_once()
        assert tdaemon._out_files(pd) == tdaemon._out_files(jd)
        assert lines(pd) == lines(jd)
        assert any("payload_pattern_swaps_total 1" in ln for ln in lines(pd))
        assert pclf.payload_counters() == jclf.payload_counters()
        clf2 = pd.syncer._factory()
        pd.syncer._classifier = clf2
        assert list(clf2.payload.model.patterns) == pats
        pd._payload_maintenance()
        assert list(clf2.payload.model.patterns) == new
    finally:
        tdaemon._stop(jd, pd)


def test_daemon_payload_flag_validation(tmp_path, monkeypatch):
    """The JAX daemon's launch validation: the cpu backend, enforce without
    --payload, a plen outside (64, 128), a missing or corrupt artifact and a
    bad mode are usage errors (exit 2) in both daemons; the three flags are
    no longer refused, and valid ones reach the Daemon."""
    for _f, e, _i in daemon.REFUSED_FLAGS:
        monkeypatch.delenv(e, raising=False)
    for e in ("INFW_PAYLOAD", "INFW_PAYLOAD_MODE", "INFW_PAYLOAD_PLEN"):
        monkeypatch.delenv(e, raising=False)
    refused = {f for f, _e, _i in daemon.REFUSED_FLAGS}
    assert not refused & {"--payload", "--payload-mode", "--payload-plen"}
    assert not {e for _f, e, _i in daemon.REFUSED_FLAGS} & {
        "INFW_PAYLOAD", "INFW_PAYLOAD_MODE", "INFW_PAYLOAD_PLEN"}
    base = ["--state-dir", str(tmp_path), "--node-name", "n"]
    bad = str(tmp_path / "bad.npz")
    ppay.save_patterns(_pats(8), bad)
    with open(bad, "ab") as f:
        f.write(b"x")
    cases = [["--payload"], ["--payload-mode", "enforce"],
             ["--payload", "--payload-plen", "96"],
             ["--payload", str(tmp_path / "missing.npz")], ["--payload", bad],
             ["--payload", "--payload-mode", "blocky"]]
    for i, args in enumerate(cases):
        mine = (["--backend", "cpu"] if i == 0 else []) + args
        theirs = ["--backend", "cpu" if i == 0 else "tpu"] + args
        with pytest.raises(SystemExit) as e:
            daemon.main(base + mine)
        assert e.value.code == 2, mine
        with pytest.raises(SystemExit) as e:
            jax_daemon.main(base + theirs)
        assert e.value.code == 2, theirs
    seen = {}

    class Stub:
        def __init__(self, **kw):
            seen.update(kw)
            raise SystemExit(0)

    monkeypatch.setattr(daemon, "Daemon", Stub)
    with pytest.raises(SystemExit):
        daemon.main(base + ["--payload"])
    assert seen["payload"] == jpay.signature_patterns(np.random.default_rng(0), 32, plen=64)
    assert seen["payload_mode"] == "shadow" and seen["payload_plen"] is None
    with pytest.raises(SystemExit):
        daemon.main(base + ["--payload", "12", "--payload-plen", "128",
                            "--payload-mode", "enforce"])
    assert len(seen["payload"]) == 12 and seen["payload_plen"] == 128
    assert seen["payload_mode"] == "enforce"
    art = str(tmp_path / "good.npz")
    ppay.save_patterns(_pats(9), art, plen=128)
    with pytest.raises(SystemExit):
        daemon.main(base + ["--payload", art])
    assert seen["payload"] == _pats(9) and seen["payload_plen"] == 128
    monkeypatch.setenv("INFW_PAYLOAD", "default")
    monkeypatch.setenv("INFW_PAYLOAD_PLEN", "128")
    with pytest.raises(SystemExit):
        daemon.main(base)
    assert len(seen["payload"]) == 32 and seen["payload_plen"] == 128


def test_chip_smoke_k11_bound_counts_each_byte_once():
    """chip_smoke's K11 bytes bound: each lane's active payload bytes, its
    length and its bitmap words once, and each delta entry and matchmap row
    the run's walks read once (a replay of the walk in numpy)."""
    import chip_smoke

    m = pac.compile_patterns([b"ab", b"b", b"zz"])
    pay = np.zeros((4, 64), np.uint8)
    pay[:, :4] = np.frombuffer(b"abab", np.uint8)
    lens = np.asarray([0, 1, 4, -3], np.int32)
    entries, landed = chip_smoke.k11_walk_reads(m, pay, lens)
    # lane 1 reads (0, 'a'); lane 2 (0, 'a'), (a, 'b'), (ab, 'a'), (ab->a... ) 
    s_a = int(m.delta[0, ord("a")])
    s_ab = int(m.delta[s_a, ord("b")])
    s_aba = int(m.delta[s_ab, ord("a")])
    assert entries == {(0, ord("a")), (s_a, ord("b")), (s_ab, ord("a")), (s_aba, ord("b"))}
    assert landed == {s_a, s_ab, s_aba, int(m.delta[s_aba, ord("b")])}
    PW = m.spec.pwords
    want = (0 + 1 + 4 + 0) + 4 * 4 + 4 * PW * 4 + 4 * len(entries) + 4 * PW * len(landed)
    assert chip_smoke.k11_bound_bytes(m, pay, lens) == want
