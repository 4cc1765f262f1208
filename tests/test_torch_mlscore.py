"""The port's anomaly-scoring tier (kernels/mxu_score.py, mlscore.py, the
classifier's plans, the resident step's score stage and the daemon's
--mlscore) on the CPU against the JAX package's (infw.kernels.mxu_score,
infw.mlscore, TpuClassifier(mlscore=...) in interpret mode, the JAX
daemon), with equality of integers and no tolerance: the plain update and
both host models against ``jitted_score_update`` over chained admissions
in every geometry that runs here in seconds (forest only, the clamp-stress
head, a 64-wide head of random weights with wrapping biases, sat at
2^31 - 1, a start state above sat, four tenants with ids -1 and 4, shadow
and enforce with a threshold that fires, 4- and 7-word wires, one lane);
the inference alone; the classifiers on the stateless, flow and resident
plans and the superbatch in both modes, with an enforced hit and an
enforced miss pinned; the model swap; the drain; the records; the
artifacts in both directions; both daemons; the flags."""
import os
import re
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import infw.daemon as jax_daemon
from infw import flow as jax_flow
from infw import mlscore as jml
from infw import testing as jax_testing
from infw.backend.tpu import TpuClassifier
from infw.kernels import mxu_score as jms
from infw.kernels import sketch as jsk
from infw.kernels.jaxpath import TCP_ACK, TCP_SYN
from infw_torch import convert, daemon, flow, mlscore as pml, testing
from infw_torch.backend.cuda import TorchClassifier
from infw_torch.constants import DENY
from infw_torch.kernels import mxu_score as pms
from infw_torch.kernels import sketch as psk
from infw_torch.kernels.resident import resident_step, split_resident_score_outputs

import test_torch_daemon as tdaemon
from test_torch_overlay import _pair

FIELDS = ("skeys", "scols", "cms", "tstat", "epoch")
#: the JAX package's tests/test_mlscore.py spec
SMALL = dict(trees=4, depth=3, slots=32, ways=2, cms_depth=2, cms_width=64, sat=511, hidden=4)


def _specs(**kw):
    return jms.ScoreSpec.make(**kw), pms.ScoreSpec.make(**kw)


def _port_model(jmodel):
    return convert.score_model_from_jax(jmodel)


@pytest.fixture(scope="module")
def tabs():
    """The JAX tests' 48-entry table on both sides."""
    jt0 = jax_testing.random_tables(np.random.default_rng(3), n_entries=48, width=8)
    jt, pt = _pair({tuple(k): np.array(v) for k, v in jt0.content.items()})
    rules = TorchClassifier(device="cpu", force_path="trie")
    rules.load_tables(pt)
    return {"j0": jt0, "jt": jt, "pt": pt, "rules": rules}


def _rule_results(tabs, batch):
    """The rule verdicts of ``batch`` (a scoring-off classifier)."""
    return _admit(tabs["rules"], batch)[0].results


def _traffic(tables, seed, b=48, syn_frac=0.3):
    """The JAX tests' traffic helper (tests/test_mlscore.py _traffic)."""
    rng = np.random.default_rng(seed)
    batch = jax_testing.random_batch(rng, tables, b)
    batch.tcp_flags = np.where(rng.random(b) < syn_frac, TCP_SYN, TCP_ACK).astype(np.int32)
    res = (rng.integers(0, 3, b).astype(np.uint32)
           | (rng.integers(1, 9, b).astype(np.uint32) << 8))
    return batch, batch.pack_wire(), res


def _random_model(jspec, seed):
    rng = np.random.default_rng(seed)
    m = jms.default_model(jspec)
    H = jspec.hidden
    return m._replace(
        fidx=rng.integers(0, 16, m.fidx.shape).astype(np.int32),
        fthr=rng.integers(0, 300, m.fthr.shape).astype(np.int32),
        leaf=rng.integers(-128, 128, m.leaf.shape).astype(np.int8),
        w1=rng.integers(-128, 128, (16, H)).astype(np.int8),
        b1=rng.integers(-2**31, 2**31, H).astype(np.int32),
        w2=rng.integers(-128, 128, H).astype(np.int8),
        b2=rng.integers(-2**31, 2**31, 1).astype(np.int32),
        qshift=np.asarray([2, 5], np.int32), version="random")


# --- the update against jitted_score_update ----------------------------------------

CASES = {  # spec keywords, model, threshold, enforce, tenants, batch size, wire width
    "default": ({}, "default", 100, False, (0,), 64, 7),
    "stress8": (dict(SMALL, hidden=8), "stress", 100, True, (0,), 48, 7),
    "random64": (dict(slots=64, ways=3, hidden=64), "random", 0, True, (0,), 64, 7),
    "sat_max": (dict(sat=2**31 - 1, slots=16, ways=2, cms_width=64), "default", 100, False,
                (0,), 64, 7),
    "above_sat_start": (dict(SMALL, sat=40), "stress", 50, True, (0,), 64, 7),
    "tenants4": (dict(SMALL, max_tenants=4), "stress", -1000, True, (-1, 0, 1, 2, 3, 4), 64, 7),
    "enforce_fires": (dict(slots=32, ways=2), "default", 0, True, (0,), 64, 7),
    "wire4": (SMALL, "stress", 100, True, (0,), 64, 4),
    "one_lane": (SMALL, "stress", 100, False, (0,), 1, 7),
}


def _case_inputs(name, tables, spec_b, width, tenants, n=5):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    out = []
    for i in range(n):
        batch, wire, res = _traffic(tables, 100 + i % 2, b=max(spec_b, 48))
        if width == 4:
            keep = np.nonzero(batch.kind == 1)[0]
            batch, res = batch.take(keep), res[keep]
            wire = batch.pack_wire_subset(np.arange(len(batch), dtype=np.int64))[0]
            assert wire.shape[1] == 4
        idx = rng.integers(0, wire.shape[0], spec_b)
        ten = rng.choice(np.asarray(tenants, np.int32), spec_b)
        out.append((np.ascontiguousarray(wire[idx]), np.ascontiguousarray(res[idx]), ten,
                    np.asarray(batch.tcp_flags, np.int32)[idx]))
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_update_matches_jax_bit_for_bit(tabs, name):
    """Per admission: the JAX update, both host models and the port's plain
    update (through score_update on CPU tensors, started from the JAX state
    through convert.score_state_from_jax) leave the same five arrays and
    return the same scores, anomaly flags and verdicts."""
    kw, kind, thr, enforce, tenants, b, width = CASES[name]
    jspec, pspec = _specs(**kw)
    jmodel = {"default": jms.default_model, "stress": jms.clamp_stress_model,
              "random": lambda s: _random_model(s, 9)}[kind](jspec)
    pmodel = _port_model(jmodel)
    tp = jms.zero_tparams(jspec, threshold=thr, enforce=enforce)
    host = {f: np.asarray(a).copy() for f, a in zip(FIELDS, jms.zero_state_host(jspec))}
    if name == "above_sat_start":
        rng = np.random.default_rng(7)
        host["cms"][:] = rng.integers(0, 200, host["cms"].shape)
        host["cms"][0, :4] = 2**31 - 1
        host["scols"][:, :4] = rng.integers(0, 200, (jspec.slots, 4))
        host["scols"][:, 6] = rng.integers(0, 200, jspec.slots)
        host["scols"][:3, :4] = 2**31 - 1
    jst = jms.ScoreState(*(jnp.asarray(np.array(host[f])) for f in FIELDS))
    pst = convert.score_state_from_jax(**host, device="cpu")
    ops = pms.ScoreOps(pst, pms.model_device(pmodel, "cpu"), torch.from_numpy(tp.copy()), None,
                       pspec)
    jm, pm = jms.HostScoreModel(jspec, jmodel, tp), pms.HostScoreModel(pspec, pmodel, tp)
    for m in (jm, pm):
        for f in FIELDS:
            setattr(m, f, np.array(host[f]))
    fn = jms.jitted_score_update(jspec)
    fired = 0
    for wire, res, ten, flags in _case_inputs(name, tabs["j0"], b, width, tenants):
        jst, js, ja, jr = fn(jst, jms.model_device(jmodel), jnp.asarray(tp), jnp.asarray(wire),
                             jnp.asarray(ten), jnp.asarray(flags), jnp.asarray(res))
        out = pms.score_update(ops, torch.from_numpy(wire.view(np.int32)), torch.from_numpy(ten),
                               torch.from_numpy(flags), torch.from_numpy(res.view(np.int32)))
        got = pms.split_score_outputs(out.numpy(), b)
        want = (np.asarray(js), np.asarray(ja), np.asarray(jr))
        for side, (s, a, r) in (("plain", got), ("jax model", jm.update(wire, res, ten, flags)),
                                ("port model", pm.update(wire, res, ten, flags))):
            np.testing.assert_array_equal(s, want[0], err_msg=f"{name} score {side}")
            np.testing.assert_array_equal(a, want[1], err_msg=f"{name} anom {side}")
            np.testing.assert_array_equal(r, want[2], err_msg=f"{name} res {side}")
        fired += int(want[1].sum())
        ph = pms.state_to_host(pst)
        for f in FIELDS:
            w = np.asarray(getattr(jst, f))
            for side, arr in (("plain", ph[f]), ("port model", pm.columns()[f]),
                              ("jax model", jm.columns()[f])):
                np.testing.assert_array_equal(np.asarray(arr).view(w.dtype), w,
                                              err_msg=f"{name} {f} {side}")
    if name in ("stress8", "random64", "tenants4", "enforce_fires", "above_sat_start"):
        assert fired > 0, name
    if name == "above_sat_start":
        assert int(ph["cms"].max()) <= 40 and int(ph["scols"][:, :4].max()) <= 40
    if name == "tenants4":
        assert (ph["tstat"][:, 0] > 0).sum() == 4


def test_infer_matches_the_host_models():
    """The plain inference against both HostScoreModel.infer on feature rows
    of every range (negative, huge, at the thresholds), the forest alone and
    with a 64-wide head whose sums and biases wrap."""
    rng = np.random.default_rng(11)
    for kw, seed in ((dict(), None), (dict(hidden=64, trees=16, depth=6), 3),
                     (dict(hidden=1, trees=1, depth=1), 4)):
        jspec, pspec = _specs(**kw)
        jmodel = jms.default_model(jspec) if seed is None else _random_model(jspec, seed)
        feats = rng.integers(-2**31, 2**31, (256, 16)).astype(np.int32)
        feats[:128] = rng.integers(-5, 400, (128, 16))
        want = jms.HostScoreModel(jspec, jmodel).infer(feats)
        got = pms.score_infer_plain(torch.from_numpy(feats),
                                    pms.model_device(_port_model(jmodel), "cpu"), pspec)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            pms.HostScoreModel(pspec, _port_model(jmodel)).infer(feats), want)


def test_failsafe_cells_match_the_kernel_source_and_jax():
    """The failsafe ports: the port's list, the JAX package's and the
    constants compiled into K10 and K11 (csrc/failsafe.cuh, which
    score_update.cu and payload_match.cu include) are the same cells."""
    csrc = os.path.join(os.path.dirname(pms.__file__), "csrc")
    src = open(os.path.join(csrc, "failsafe.cuh")).read()
    for user in ("score_update.cu", "payload_match.cu"):
        assert '#include "failsafe.cuh"' in open(os.path.join(csrc, user)).read()

    def ports(name):
        body = re.search(name + r"\[\] = \{([^}]*)\}", src).group(1)
        return sorted(int(x) for x in body.split(","))

    assert ports("kFailsafeTcp") == sorted(pms.FAILSAFE_TCP.tolist()) == sorted(
        jms._FS_TCP.tolist())
    assert ports("kFailsafeUdp") == sorted(pms.FAILSAFE_UDP.tolist()) == sorted(
        jms._FS_UDP.tolist())
    proto = np.asarray([6, 6, 17, 17, 1], np.int32)
    port = np.asarray([22, 80, 68, 22, 22], np.int32)
    np.testing.assert_array_equal(pms.failsafe_lane_mask_np(proto, port),
                                  jms.failsafe_lane_mask_np(proto, port))


def test_spec_model_and_wrapper_validation():
    """ScoreSpec.make's and validate_model's contract (the JAX package's),
    the builders' outputs equal JAX's, and the wrappers refuse what the
    kernel does not take."""
    assert pms.ScoreSpec.make(slots=100).slots == 128
    assert pms.ScoreSpec.make(cms_width=100).cms_width == 128
    for kw in (dict(trees=0), dict(trees=17), dict(depth=0), dict(depth=7), dict(ways=0),
               dict(ways=9), dict(cms_depth=0), dict(sat=0), dict(hidden=-1), dict(hidden=65),
               dict(max_tenants=0)):
        with pytest.raises(ValueError):
            pms.ScoreSpec.make(**kw)
        with pytest.raises(ValueError):
            jms.ScoreSpec.make(**kw)
    jspec, pspec = _specs(**SMALL)
    for jb, pb in ((jms.default_model, pms.default_model),
                   (jms.clamp_stress_model, pms.clamp_stress_model)):
        jm, pm = jb(jspec), pb(pspec)
        for f in pms.MODEL_FIELDS:
            np.testing.assert_array_equal(getattr(jm, f), getattr(pm, f))
        assert jm.version == pm.version
    m = pms.default_model(pspec)
    with pytest.raises(ValueError, match="fidx"):
        pms.validate_model(m._replace(fidx=m.fidx.astype(np.int64)))
    with pytest.raises(ValueError, match="qshift"):
        pms.validate_model(m._replace(qshift=np.asarray([40, 0], np.int32)))
    with pytest.raises(ValueError):
        pms.clamp_stress_model(pms.ScoreSpec.make(hidden=0))
    ops = pms.ScoreOps(pms.zero_state(pspec, "cpu"), pms.model_device(m, "cpu"),
                       torch.from_numpy(pms.zero_tparams(pspec)), None, pspec)
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        pms.score_update(ops, torch.zeros((4, 7), dtype=torch.int32, device="meta"), z, z, z)


def test_resident_entry_equals_the_classic_entry(tabs):
    """The resident entry over packed words (the merge of the probe's
    served words and the stateless words by the hit bitmap) equals the
    classic entry over the merged verdicts: the same state, both words
    rewritten with the policy's verdicts, the anomaly bitmap and the
    int16-saturated scores, at an odd batch size."""
    from infw_torch.kernels.flow import pack_bits32, unpack_bits32
    from infw_torch.kernels.torchpath import _pack_res16

    jspec, pspec = _specs(**SMALL)
    model = pms.clamp_stress_model(pspec)
    tp = torch.from_numpy(pms.zero_tparams(pspec, threshold=60, enforce=True))
    a = pms.ScoreOps(pms.zero_state(pspec, "cpu"), pms.model_device(model, "cpu"), tp, None, pspec)
    b = a._replace(state=pms.zero_state(pspec, "cpu"))
    rng = np.random.default_rng(4)
    for i in range(3):
        _batch, wire, res = _traffic(tabs["j0"], 40 + i, b=101)
        res16 = torch.from_numpy((res & 0xFFFF).astype(np.int64))
        hit = torch.from_numpy(rng.random(101) < 0.4)
        served = torch.from_numpy(rng.integers(0, 1 << 16, 101))
        merged = torch.where(hit, served, res16)
        args = (torch.from_numpy(wire.view(np.int32)), torch.zeros(101, dtype=torch.int32),
                torch.zeros(101, dtype=torch.int32))
        s, an, r = pms.split_score_outputs(
            pms.score_update(a, *args, merged.to(torch.int32)).numpy(), 101)
        w_served, w_res, out = _pack_res16(served), _pack_res16(res16), torch.zeros(55,
                                                                                     dtype=torch.int32)
        pms.score_update_resident(b, *args, w_served, pack_bits32(hit), w_res, out)
        assert torch.equal(w_served, w_res)
        assert torch.equal(w_served, _pack_res16(torch.from_numpy(r.astype(np.int64))))
        np.testing.assert_array_equal(unpack_bits32(out[:4], 101).numpy(), an)
        s16 = pms.unpack_res16(out[4:], 101).numpy().astype(np.uint16).view(np.int16)
        np.testing.assert_array_equal(s16, np.clip(s, -32768, 32767))
        for f in FIELDS:
            assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f
    assert int(a.state.tstat[0, 2]) > 0


# --- the classifiers ----------------------------------------------------------------

PLANS = {  # path, flow table, resident, superbatch K, telemetry on
    "stateless": ("trie", False, False, 0, False),
    "flow": ("trie", True, False, 0, False),
    "resident": ("trie", True, True, 0, False),
    "superbatch": ("trie", True, True, 4, False),
    "dense_stateless": ("dense", False, False, 0, False),
    "dense_resident": ("dense", True, True, 0, False),
    "ctrie_stateless": ("ctrie", False, False, 0, False),
    "ctrie_resident": ("ctrie", True, True, 0, False),
    "trie_flow_telemetry": ("trie", True, False, 0, True),
    "dense_resident_telemetry": ("dense", True, True, 0, True),
    "ctrie_superbatch_telemetry": ("ctrie", True, True, 4, True),
    "dense_stateless_telemetry": ("dense", False, False, 0, True),
}
#: the telemetry plane's geometry beside scoring (test_torch_telemetry.py SPEC)
TEL_SPEC = dict(depth=3, width=128, topk=32, ways=2, max_tenants=2)


def _admit(clf, batch, k=0):
    if k:
        stack = np.stack([batch.pack_wire()] * k)
        flags = np.stack([np.asarray(batch.tcp_flags, np.int32)] * k)
        return [r.result() for r in clf.classify_prepared_super(
            clf.prepare_packed_super(stack, False, flags), apply_stats=False)]
    w, v4 = batch.pack_wire_subset(np.arange(len(batch), dtype=np.int64))
    return [clf.classify_prepared(clf.prepare_packed(w, v4, tcp_flags=batch.tcp_flags),
                                  apply_stats=False).result()]


@pytest.mark.parametrize("mode", ["shadow", "enforce"])
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_classifier_matches_tpu_classifier(tabs, plan, mode):
    """TorchClassifier(device="cpu", mlscore=...) against TpuClassifier(
    mlscore=..., interpret=True) on the same admissions (the twin of
    test_mlscore.py's cross-path gate): equal results, XDP, statistics,
    score tensors, recent masks, counters and flow columns.  In enforce mode
    (everything anomalous) the second pass over the same packets serves
    hits: an enforced hit comes back Deny with ruleId 0 and an enforced miss
    was cached as Deny.  On the dense, trie and ctrie paths, and with the
    telemetry plane on beside scoring (equal sketch tensors and counters)."""
    path, use_flow, resident, k, tel = PLANS[plan]
    fp = None if path == "dense" else path
    jspec, pspec = _specs(**SMALL)
    jkw = {"flow_table": jax_flow.FlowConfig.make(entries=1024), "resident": resident} \
        if use_flow else {}
    pkw = {"flow_table": 1024, "resident": resident} if use_flow else {}
    if tel:
        jkw["telemetry"] = jsk.SketchSpec.make(**TEL_SPEC)
        pkw["telemetry"] = psk.SketchSpec.make(**TEL_SPEC)
    jc = TpuClassifier(force_path=fp, interpret=True, mlscore=jspec,
                       mlscore_model=jms.clamp_stress_model(jspec), mlscore_mode=mode, **jkw)
    pc = TorchClassifier(device="cpu", force_path=fp, mlscore=pspec,
                         mlscore_model=pms.clamp_stress_model(pspec), mlscore_mode=mode, **pkw)
    jc.load_tables(tabs["jt"])
    pc.load_tables(tabs["pt"])
    assert pc.active_path == path
    for c in (jc, pc):
        c.mlscore.set_keep_masks(16)
        if mode == "enforce":
            c.mlscore.set_threshold(-1000)
    outs = []
    for i in range(4):
        batch, _w, _r = _traffic(tabs["j0"], 200 + i % 2, b=64)
        got, want = _admit(pc, batch, k), _admit(jc, batch, k)
        for o2, o1 in zip(got, want):
            np.testing.assert_array_equal(o2.results, o1.results, err_msg=f"{plan} {mode} {i}")
            np.testing.assert_array_equal(o2.xdp, o1.xdp)
            np.testing.assert_array_equal(o2.stats_delta, o1.stats_delta)
        outs.append((batch, got[-1]))
    c1, c2 = jc.mlscore.columns(), pc.mlscore.columns()
    for f in FIELDS:
        np.testing.assert_array_equal(c2[f], np.asarray(c1[f]).view(c2[f].dtype), err_msg=f)
    m1, m2 = jc.mlscore.recent_masks(), pc.mlscore.recent_masks()
    assert len(m1) == len(m2) == 4 * max(k, 1)
    for (e1, a1, s1), (e2, a2, s2) in zip(m1, m2):
        assert e1 == e2
        np.testing.assert_array_equal(a2, a1)
        np.testing.assert_array_equal(s2, np.clip(s1, -32768, 32767))
    assert pc.mlscore_counters() == jc.mlscore_counters()
    if tel:
        t1, t2 = jc.telemetry.columns(), pc.telemetry.columns()
        for f in t2:
            np.testing.assert_array_equal(t2[f], np.asarray(t1[f]), err_msg=f)
        assert t2["tcnt"][0, 0] > 0
        assert pc.telemetry_counters() == jc.telemetry_counters()
    if use_flow:
        f1, f2 = jc.flow.flow_columns(), pc.flow.flow_columns()
        for f in f2:
            np.testing.assert_array_equal(f2[f], np.asarray(f1[f]), err_msg=f)
    if mode == "enforce":
        batch, out = outs[-1]
        fs = pms.failsafe_lane_mask_np(batch.proto, batch.dst_port)
        ref = _rule_results(tabs, batch)
        elig = np.isin(batch.kind, (1, 2)) & ~fs & ((ref & 0xFF) != DENY)
        assert elig.any() and (out.results[elig] == DENY).all()
        if use_flow:
            # the second pass's hits: enforced verdicts served from the cache
            flows = pc.flow.flow_columns()
            cached = flows["vg"][flows["se"][:, 0] > 0, 0]
            assert (cached == DENY).any() and pc.flow_counters()["flow_hits_total"] > 0
        assert pc.mlscore_counters()["mlscore_enforced_total"] == 0  # counted at drain
        rec = pc.mlscore.drain()[0]
        assert rec.lines() == jc.mlscore.drain()[0].lines()
        assert any(t["enforced"] > 0 for t in rec.tenants)
    for c in (jc, pc):
        c.close()


EMPTY_PLANS = {"flow": (False, 0), "resident": (True, 0), "superbatch": (True, 3)}


def _tier_snapshot(clf) -> dict:
    """Every counter and state tensor an admission can move: the flow,
    resident, telemetry and scoring counters, the flow columns and epoch,
    the sketch and score tensors, the classifier's statistics."""
    out = {}
    for name in ("flow_counters", "resident_counters", "telemetry_counters",
                 "mlscore_counters"):
        out.update({f"{name}.{k}": v for k, v in getattr(clf, name)().items()})
    for pre, cols in (("score", clf.mlscore.columns()), ("sketch", clf.telemetry.columns()),
                      ("flow", clf.flow.flow_columns())):
        out.update({f"{pre}.{k}": np.asarray(v).copy() for k, v in cols.items()})
    out["flow.epoch"] = int(clf.flow.epoch)
    out["stats"] = np.asarray(clf.stats.snapshot()).copy()
    return out


@pytest.mark.parametrize("width", [4, 7])
@pytest.mark.parametrize("plan", sorted(EMPTY_PLANS))
def test_empty_chunk_moves_no_tier(tabs, plan, width):
    """An empty (0, 4) or (0, 7) chunk through the flow, resident and
    superbatch plans with scoring and the telemetry plane on, after a
    non-empty admission: empty results and XDP, zero statistics, and no
    counter or state tensor moved against the state before the call (the
    JAX package raises on an empty chunk, so it cannot be the reference);
    the next admission then equals a classifier that never saw the empty
    chunk."""
    resident, k = EMPTY_PLANS[plan]
    _jspec, pspec = _specs(**SMALL)

    def make():
        c = TorchClassifier(device="cpu", force_path="trie", flow_table=1024, resident=resident,
                            mlscore=pspec, mlscore_model=pms.clamp_stress_model(pspec),
                            mlscore_mode="enforce", telemetry=psk.SketchSpec.make(**TEL_SPEC))
        c.load_tables(tabs["pt"])
        c.mlscore.set_threshold(60)
        return c

    pc, ref = make(), make()
    batch, _w, _r = _traffic(tabs["j0"], 300, b=64)
    for c in (pc, ref):
        _admit(c, batch)
    before = _tier_snapshot(pc)
    empty = np.zeros((0, width), np.uint32)
    if k:
        outs = [r.result() for r in pc.classify_prepared_super(
            pc.prepare_packed_super(np.stack([empty] * k), width == 4, np.zeros((k, 0), np.int32)))]
    else:
        outs = [pc.classify_prepared(pc.prepare_packed(empty, width == 4,
                                                       tcp_flags=np.zeros(0, np.int32))).result()]
    assert len(outs) == max(k, 1)
    for o in outs:
        assert o.results.shape == (0,) and o.xdp.shape == (0,)
        assert not np.asarray(o.stats_delta).any()
    after = _tier_snapshot(pc)
    assert sorted(after) == sorted(before)
    moved = [key for key in before if not np.array_equal(before[key], after[key])]
    assert moved == []
    nxt, _w, _r = _traffic(tabs["j0"], 301, b=64)
    for o1, o2 in zip(_admit(pc, nxt), _admit(ref, nxt)):
        np.testing.assert_array_equal(o1.results, o2.results)
    for f in FIELDS:
        np.testing.assert_array_equal(pc.mlscore.columns()[f], ref.mlscore.columns()[f])
    for c in (pc, ref):
        c.close()


def test_model_swap_invalidates_cached_enforced_verdicts(tabs):
    """A model swap and a policy flip each bump the flow generation, and the
    cached enforced denies are not served after them; the value tensors,
    policy rows and state keep their addresses through swap, flip, drain and
    reset (what a CUDA graph baked)."""
    _jspec, pspec = _specs(**SMALL)
    pc = TorchClassifier(device="cpu", force_path="trie", flow_table=1024, resident=True,
                         mlscore=pspec, mlscore_model=pms.clamp_stress_model(pspec),
                         mlscore_mode="enforce")
    pc.load_tables(tabs["pt"])
    tier = pc.mlscore
    tier.set_threshold(-1000)
    batch, _w, _r = _traffic(tabs["j0"], 41, b=64)
    batch.tcp_flags = np.full(64, TCP_ACK, np.int32)
    ptrs = [t.data_ptr() for t in (*tier._state, *tier._model_dev, tier._tparams_dev,
                                   tier._scratch)]
    o1 = _admit(pc, batch)[0]
    fs = pms.failsafe_lane_mask_np(batch.proto, batch.dst_port)
    elig = np.isin(batch.kind, (1, 2)) & ~fs
    assert ((o1.results & 0xFF) == DENY)[elig].all()
    gen0 = int(pc.flow._gens_host[0])
    tier.set_threshold(10**6)
    pc.set_score_model(pms.default_model(pspec), version="calm")
    assert int(pc.flow._gens_host[0]) == gen0 + 2
    assert tier.model_version == "calm" and tier.counter_values()["mlscore_model_swaps_total"] == 1
    o2 = _admit(pc, batch)[0]
    np.testing.assert_array_equal(o2.results, _rule_results(tabs, batch))
    tier.drain()
    tier.reset_state()
    tier.set_mode("shadow")
    assert int(pc.flow._gens_host[0]) == gen0 + 3
    assert ptrs == [t.data_ptr() for t in (*tier._state, *tier._model_dev, tier._tparams_dev,
                                           tier._scratch)]
    assert int(tier._state.epoch[0]) == 0 and int(tier._tparams_dev[0, 1]) == 0
    pc.close()


@pytest.mark.parametrize("mode", ["shadow", "enforce"])
def test_resident_step_with_scoring(tabs, mode):
    """The resident step's score stage: the step's verdicts, anomaly bitmap
    and scores equal the classic update over the merged verdicts of the
    same step without scoring, and leave the same state; the flow table
    caches the policy's verdicts (enforce, everything anomalous: Deny on the
    eligible misses, one admission on a fresh table; shadow: three chained
    admissions, whose caches stay equal to the scoring-off step's)."""
    from infw_torch.kernels.resident import split_resident_outputs

    _jspec, pspec = _specs(**SMALL)
    pc = TorchClassifier(device="cpu", force_path="trie", resident=True, flow_table=512)
    pc.load_tables(tabs["pt"])
    ctx = pc.resident.context(pc)
    tables = ctx.tables._replace(n_levels=ctx.tables.dev.n_levels)
    model = pms.clamp_stress_model(pspec)
    enforce = mode == "enforce"
    tier = pml.AnomalyTier(pspec, model, device="cpu", mode=mode, threshold=-1000)
    ref = pms.ScoreOps(pms.zero_state(pspec, "cpu"), pms.model_device(model, "cpu"),
                       torch.from_numpy(pms.zero_tparams(pspec, -1000, enforce)), None, pspec)
    fa, fb = (flow.FlowTier(flow.FlowConfig.make(entries=512), device="cpu") for _ in range(2))
    for j in range(1 if enforce else 3):
        batch, wire_np, _r = _traffic(tabs["j0"], 60 + j % 2, b=64)
        wire = torch.from_numpy(wire_np.view(np.int32))
        fl = torch.from_numpy(np.asarray(batch.tcp_flags, np.int32))
        h, _ = fa.resident_dispatch(lambda ops: resident_step(ops, tables, wire), 64,
                                    wire_np=wire_np, tflags=fl, mlscore=tier)
        h_off, _ = fb.resident_dispatch(lambda ops: resident_step(ops, tables, wire), 64,
                                        wire_np=wire_np, tflags=fl)
        res16, _hit, _h, _s, _c, anom, scores = split_resident_score_outputs(h.numpy(), 64)
        merged = split_resident_outputs(h_off.numpy(), 64)[0]
        s, a, r = pms.split_score_outputs(pms.score_update(
            ref, wire, torch.zeros(64, dtype=torch.int32), fl,
            torch.from_numpy(merged.astype(np.int32))).numpy(), 64)
        np.testing.assert_array_equal(res16, r)
        np.testing.assert_array_equal(anom, a)
        np.testing.assert_array_equal(scores, np.clip(s, -32768, 32767))
        assert a.any() and (enforce or np.array_equal(r, merged))
    for f in FIELDS:
        assert torch.equal(getattr(tier._state, f), getattr(ref.state, f)), f
    cols, off = fa.flow_columns(), fb.flow_columns()
    if enforce:
        live = cols["se"][:, 0] > 0
        assert (cols["vg"][live, 0] == DENY).sum() > (off["vg"][live, 0] == DENY).sum()
    else:
        for k in cols:
            np.testing.assert_array_equal(cols[k], off[k], err_msg=k)


# --- the tier: drain, records, artifacts, switches ------------------------------------------


class _Ring:
    def __init__(self):
        self.recs = []

    def push(self, r):
        self.recs.append(r)


def test_drain_exactly_once_matches_jax(tabs):
    """Both tiers over the same admissions with the drain cadence at 2:
    the same records (seq, admissions, tenants, sources, lines) in the same
    order on their rings, the window reset (tstat, anomaly hits) and the
    rates kept, the tracked mirrors equal to the state."""
    jspec, pspec = _specs(**SMALL)
    jt = jml.AnomalyTier(jspec, model=jms.clamp_stress_model(jspec), threshold=-(10**6),
                         track_model=True, drain_every=2)
    pt = pml.AnomalyTier(pspec, model=pms.clamp_stress_model(pspec), device="cpu",
                         threshold=-(10**6), track_model=True, drain_every=2)
    rings = (_Ring(), _Ring())
    jt.attach_ring(rings[0])
    pt.attach_ring(rings[1])
    for i in range(5):
        batch, wire, res = _traffic(tabs["j0"], 31 + i, b=32)
        a, b = jt.update(wire, res, tflags_np=batch.tcp_flags), pt.update(
            wire, res, tflags_np=batch.tcp_flags)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    recs = [pt.drain(force=True)[0], jt.drain(force=True)[0]]
    assert [r.seq for r in rings[1].recs] == [1, 2, 3] == [r.seq for r in rings[0].recs]
    for r1, r0 in zip(rings[1].recs, rings[0].recs):
        assert r1.lines() == r0.lines() and r1.top == r0.top and r1.tenants == r0.tenants
    assert recs[0].admissions == 1 and recs[0].lines()[0].startswith("anomaly-verdict seq=3")
    assert any("anomalous-src" in ln for r in rings[1].recs for ln in r.lines())
    cols = pt.columns()
    assert cols["tstat"].sum() == 0 and cols["scols"][:, 6].sum() == 0
    assert cols["scols"][:, 0].sum() > 0
    for f in FIELDS:
        np.testing.assert_array_equal(cols[f], pt.model.columns()[f], err_msg=f)
        np.testing.assert_array_equal(cols[f], np.asarray(jt.columns()[f]).view(cols[f].dtype))
    assert pt.counter_values() == jt.counter_values()
    assert pt.drain(force=False) == []


def test_summarize_snapshot_matches_jax():
    """summarize_snapshot on a hand-made snapshot (IPv4 and IPv6 sources,
    ties in the hit column, tenants with and without traffic) equals the
    JAX package's."""
    skeys = np.zeros((8, 6), np.uint32)
    scols = np.zeros((8, 8), np.int32)
    skeys[3] = [0, 0x01020304, 0, 0, 0, 1]
    skeys[5] = [1, 0x20010DB8, 0, 0, 7, 2]
    skeys[6] = [0, 0x05060708, 0, 0, 0, 1]
    scols[3, 0], scols[3, 6] = 40, 9
    scols[5, 0], scols[5, 6] = 10, 17
    scols[6, 0], scols[6, 6] = 11, 9
    tstat = np.asarray([[64, 26, 3, 240], [0, 0, 0, 0], [5, 0, 0, -4]], np.int32)
    tp = jms.zero_tparams(jms.ScoreSpec.make(max_tenants=3), threshold=77, enforce=True)
    for top_n in (8, 2):
        j = jml.summarize_snapshot(jml.ScoreSnapshot(4, 12, skeys, scols, tstat, tp), top_n)
        p = pml.summarize_snapshot(pml.ScoreSnapshot(4, 12, skeys, scols, tstat, tp), top_n)
        assert p.lines() == j.lines() and p.top == j.top and p.tenants == j.tenants
    assert p.top[0]["src"] == "2001:db8::7"


def test_artifacts_load_in_both_packages(tmp_path):
    """An artifact written by either package loads in the other with equal
    arrays, version and geometry; a corrupt npz and a missing manifest are
    refused by both."""
    jspec, pspec = _specs(**SMALL)
    jm = jms.clamp_stress_model(jspec)
    pm = pms.clamp_stress_model(pspec)
    jml.save_model(jm, str(tmp_path / "j.npz"), version="v7")
    pml.save_model(pm, str(tmp_path / "p"), version="v8")
    assert open(tmp_path / "j.npz", "rb").read() == open(tmp_path / "p.npz", "rb").read()
    for loaded, want, version in ((pml.load_model(str(tmp_path / "j.npz")), pm, "v7"),
                                  (jml.load_model(str(tmp_path / "p.npz")), jm, "v8")):
        assert loaded.version == version and tuple(loaded.spec) == tuple(want.spec)
        for f in pms.MODEL_FIELDS:
            np.testing.assert_array_equal(getattr(loaded, f), getattr(want, f))
    with open(tmp_path / "p.npz", "ab") as f:
        f.write(b"x")
    for load in (pml.load_model, jml.load_model):
        with pytest.raises(ValueError, match="checksum"):
            load(str(tmp_path / "p.npz"))
    os.unlink(tmp_path / "j.npz.json")
    for load in (pml.load_model, jml.load_model):
        with pytest.raises(ValueError, match="manifest"):
            load(str(tmp_path / "j.npz"))


def test_tier_policy_knobs_and_switches(monkeypatch):
    """The tier's guards (the JAX package's), and mlscore= True / a slot
    count / a ScoreSpec / False, INFW_MLSCORE and INFW_MLSCORE_MODE; the
    plain batch path without a flow tier scores nothing."""
    _jspec, pspec = _specs(**SMALL)
    tier = pml.AnomalyTier(pspec, device="cpu")
    tier.set_threshold(5, tenant=0)
    tier.set_mode("enforce", tenant=0)
    assert tier.tparams()[0].tolist() == [5, 1]
    assert tier._tparams_dev.tolist() == [[5, 1]]
    with pytest.raises(ValueError):
        pml.AnomalyTier(pspec, device="cpu", mode="enforce", track_model=True)
    with pytest.raises(ValueError):
        pml.AnomalyTier(pspec, device="cpu", track_model=True).set_mode("enforce")
    with pytest.raises(ValueError):
        pml.AnomalyTier(pspec, device="cpu", mode="blocky")
    with pytest.raises(ValueError, match="geometry"):
        tier.swap_model(pms.default_model(pms.ScoreSpec.make(slots=64, hidden=4)))
    for e in ("INFW_MLSCORE", "INFW_MLSCORE_MODE"):
        monkeypatch.delenv(e, raising=False)
    assert TorchClassifier(device="cpu").mlscore is None
    assert TorchClassifier(device="cpu", mlscore=True).mlscore.spec == pms.ScoreSpec.make()
    assert TorchClassifier(device="cpu", mlscore=100).mlscore.spec.slots == 128
    assert TorchClassifier(device="cpu", mlscore=False).mlscore_counters() == {}
    with pytest.raises(RuntimeError):
        TorchClassifier(device="cpu").set_score_model(pms.default_model())
    monkeypatch.setenv("INFW_MLSCORE", "1")
    monkeypatch.setenv("INFW_MLSCORE_MODE", "enforce")
    c = TorchClassifier(device="cpu")
    assert c.mlscore.spec == pms.ScoreSpec.make() and c.mlscore.tparams()[0, 1] == 1
    tables = testing.random_tables_fast(np.random.default_rng(1), 50, width=4)
    c.load_tables(tables)
    c.classify(testing.random_batch_fast(np.random.default_rng(2), tables, 32))
    assert c.mlscore_counters()["mlscore_updates_total"] == 0


# --- the daemons ---------------------------------------------------------------------


def _fire_all(spec, m):
    """``m`` with an inert tree's leaf at 120 (every lane anomalous)."""
    leaf = m.leaf.copy()
    leaf[(spec.trees - 1) * spec.leaves] = 120
    return m._replace(leaf=leaf, version="fire-all")


@pytest.mark.parametrize("mode", ["shadow", "enforce"])
def test_daemons_agree_with_mlscore(tmp_path, mode):
    """Both daemons with --mlscore (enforce: a model whose inert tree fires
    on every lane), the same frames files: equal out files, events
    (anomaly-verdict lines included) and mlscore_* /metrics lines; then a
    model artifact dropped into models/ hot-swaps in both (the flow
    generation bumps, the files are consumed), a corrupt one is consumed
    and logged, and a rebuilt classifier gets the swapped model back."""
    jspec, pspec = _specs()
    jmodel = jms.default_model(jspec)
    if mode == "enforce":
        jmodel = _fire_all(jspec, jmodel)
    pmodel = _port_model(jmodel)
    jreg, preg = tdaemon._registries()
    common = dict(node_name=tdaemon.NODE, poll_period_s=3600.0, metrics_port=0, health_port=0,
                  file_poll_interval_s=60.0, ingest_chunk=tdaemon.CHUNK, pipeline_depth=3,
                  mlscore_mode=mode)
    jd = jax_daemon.Daemon(state_dir=str(tmp_path / "jax"), backend="tpu", registry=jreg,
                           mlscore=(jspec, jmodel), **common)
    pd = daemon.Daemon(state_dir=str(tmp_path / "port"), backend="cpu", registry=preg,
                       mlscore=(pspec, pmodel), **common)
    try:
        doc = tdaemon._nodestate(tdaemon.PATHS["dense"][0])
        for d in (jd, pd):
            assert os.path.isdir(d.models_dir)
            tdaemon._write_state(d, doc)
            d.scan_nodestates_once()
            d._mlscore_maintenance()
        fbs = tdaemon._frames(doc, 4, sizes=(120, 60, 30))
        for d in (jd, pd):
            tdaemon._drop(d, fbs)
        assert jd.process_ingest_once() == pd.process_ingest_once()
        for d in (jd, pd):
            d.syncer.classifier.mlscore.drain()
        assert tdaemon._out_files(pd) == tdaemon._out_files(jd)
        pev, jev = tdaemon._events(pd), tdaemon._events(jd)
        assert pev[0].splitlines() == jev[0].splitlines() and pev[1] == jev[1]
        assert "anomaly-verdict seq=1" in pev[0]
        pclf, jclf = pd.syncer.classifier, jd.syncer.classifier
        assert pclf.mlscore_counters() == jclf.mlscore_counters()
        if mode == "enforce":
            assert pclf.mlscore_counters()["mlscore_enforced_total"] > 0
        ptext, jtext = pd.metrics_registry.render_text(), jd.metrics_registry.render_text()
        ml = "ingressnodefirewall_node_mlscore_"
        plines = [ln for ln in ptext.splitlines() if ln.startswith(ml)]
        assert plines and plines == [ln for ln in jtext.splitlines() if ln.startswith(ml)]
        # the models/ hot swap, a corrupt artifact, a rebuilt classifier
        for d, save, m in ((jd, jml.save_model, jmodel), (pd, pml.save_model, pmodel)):
            save(m._replace(version="hot-v2"), os.path.join(d.models_dir, "m2.npz"))
            d._mlscore_maintenance()
            assert d.syncer.classifier.mlscore.model_version == "hot-v2"
            assert os.listdir(d.models_dir) == []
            p = os.path.join(d.models_dir, "bad.npz")
            save(m._replace(version="bad"), p)
            with open(p, "ab") as f:
                f.write(b"junk")
            d._mlscore_maintenance()
            assert d.syncer.classifier.mlscore.model_version == "hot-v2"
            assert os.listdir(d.models_dir) == []
        assert pclf.mlscore_counters() == jclf.mlscore_counters()
        assert pclf.mlscore_counters()["mlscore_model_swaps_total"] == 1
        clf2 = pd.syncer._factory()
        pd.syncer._classifier = clf2
        assert clf2.mlscore.model_version == pmodel.version
        pd._mlscore_maintenance()
        assert clf2.mlscore.model_version == "hot-v2"
    finally:
        tdaemon._stop(jd, pd)


def test_daemon_mlscore_flag_validation(tmp_path, monkeypatch):
    """The JAX daemon's launch validation (tests/test_mlscore.py): the cpu
    backend, enforce without --mlscore, a missing or corrupt artifact, a bad
    mode (flag or INFW_MLSCORE_MODE) are usage errors (exit 2) in both
    daemons; the two flags are no longer refused, and valid ones reach the
    Daemon."""
    for _f, e, _i in daemon.REFUSED_FLAGS:
        monkeypatch.delenv(e, raising=False)
    for e in ("INFW_MLSCORE", "INFW_MLSCORE_MODE"):
        monkeypatch.delenv(e, raising=False)
    refused = {f for f, _e, _i in daemon.REFUSED_FLAGS}
    assert not refused & {"--mlscore", "--mlscore-mode"}
    base = ["--state-dir", str(tmp_path), "--node-name", "n"]
    spec = pms.ScoreSpec.make()
    bad_art = str(tmp_path / "bad.npz")
    pml.save_model(pms.default_model(spec), bad_art)
    with open(bad_art, "ab") as f:
        f.write(b"x")
    cases = [(["--backend", "cpu", "--mlscore"], ["--backend", "cpu", "--mlscore"]),
             (["--mlscore-mode", "enforce"], ["--backend", "tpu", "--mlscore-mode", "enforce"]),
             (["--mlscore", str(tmp_path / "missing.npz")],
              ["--backend", "tpu", "--mlscore", str(tmp_path / "missing.npz")]),
             (["--mlscore", bad_art], ["--backend", "tpu", "--mlscore", bad_art]),
             (["--mlscore", "--mlscore-mode", "blocky"],
              ["--backend", "tpu", "--mlscore", "--mlscore-mode", "blocky"])]
    for mine, theirs in cases:
        with pytest.raises(SystemExit) as e:
            daemon.main(base + (["--backend", "cuda"] if "--backend" not in mine else []) + mine)
        assert e.value.code == 2, mine
        with pytest.raises(SystemExit) as e:
            jax_daemon.main(base + theirs)
        assert e.value.code == 2, theirs
    monkeypatch.setenv("INFW_MLSCORE_MODE", "blocky")
    with pytest.raises(SystemExit) as e:
        daemon.main(base + ["--mlscore"])
    assert e.value.code == 2
    monkeypatch.delenv("INFW_MLSCORE_MODE")
    seen = {}

    class Stub:
        def __init__(self, **kw):
            seen.update(kw)
            raise SystemExit(0)

    monkeypatch.setattr(daemon, "Daemon", Stub)
    good = str(tmp_path / "good.npz")
    pml.save_model(pms.clamp_stress_model(pms.ScoreSpec.make(hidden=8)), good, version="g1")
    with pytest.raises(SystemExit):
        daemon.main(base + ["--mlscore", good, "--mlscore-mode", "enforce"])
    assert seen["mlscore"][0] == pms.ScoreSpec.make(hidden=8)
    assert seen["mlscore"][1].version == "g1" and seen["mlscore_mode"] == "enforce"
    monkeypatch.setenv("INFW_MLSCORE", "1")
    with pytest.raises(SystemExit):
        daemon.main(base)
    assert seen["mlscore"][0] == spec and seen["mlscore_mode"] == "shadow"


# --- K10's plan choice (kernels/mxu_score.py plan_for), on the CPU -------------------------


def test_plan_chooser_takes_the_block_within_its_limits():
    """K10's host-side plan choice, with the card's shared-memory limit
    passed in: plan S within the limit and the crossover, plan L past
    either (the oversized geometry, many tenants, a limit just below the
    state, a spill past the limit); the bytes as csrc/score_update.cu lays
    them out (model, 19 S + D W + 4 T words, the carries past the register
    lanes; plan L's staged rows and tallies), plan L's spill and the slot
    scratch."""
    spec = pms.ScoreSpec.make()
    h100 = 232_448  # an H100's opt-in shared memory a block
    cross, reg = pms.BLOCK_PLAN_MAX_LANES, pms.REG_LANES * pms.BLOCK_THREADS
    # fidx and fthr 4 x 3 (12 words each), no b1, 32 leaf bytes (8 words), no head
    assert pms.model_words(spec) == 12 + 12 + 8
    state = 4 * (32 + 19 * 512 + 2 * 1024 + 4)
    assert pms.block_plan_bytes(1, spec) == pms.block_plan_bytes(reg, spec) == state
    assert pms.block_plan_bytes(reg + 3, spec) == state + 48
    assert pms.grid_plan_bytes(spec) == 4 * (32 + 14 * 512 + 5 * 512 + 2 * 1024)
    assert pms.grid_plan_bytes(pms.ScoreSpec.make(max_tenants=2000)) == 4 * (32 + 15 * 512 + 8000)
    head = pms.ScoreSpec.make(trees=16, depth=6, hidden=64)
    assert pms.model_words(head) == 96 + 96 + 64 + 256 + 256 + 16
    odd = pms.ScoreSpec(trees=3, depth=1, slots=8, ways=1, cms_depth=1, cms_width=8, sat=5,
                        hidden=5, max_tenants=1)
    assert pms.model_words(odd) == 4 + 4 + 8 + 4 + 20 + 4
    for b in (1, 31, 256, cross - 1, cross):
        assert pms.plan_for(b, spec, h100) == "S", b
    for b in (cross + 1, 4097, 65536, 1 << 18):
        assert pms.plan_for(b, spec, h100) == "L", b
    assert pms.plan_for(256, spec, state) == "S"
    assert pms.plan_for(256, spec, state - 1) == "L"
    big = pms.ScoreSpec.make(slots=65536, cms_width=65536, max_tenants=100)
    assert pms.block_plan_bytes(1, big) == 4 * (32 + 19 * 65536 + 2 * 65536 + 400) > h100
    assert pms.grid_plan_bytes(big) == 4 * (32 + 19 * 65536 + 2 * 65536) > h100
    assert [pms.plan_for(b, big, h100) for b in (1, 256, 1 << 18)] == ["L"] * 3
    assert pms.plan_for(256, pms.ScoreSpec.make(max_tenants=20_000), h100) == "L"
    assert pms.plan_for(256, pms.ScoreSpec.make(max_tenants=64), h100) == "S"
    b = reg + 1
    lim = pms.block_plan_bytes(b, spec)
    assert pms.plan_for(b, spec, lim) == ("S" if b <= cross else "L")
    assert pms.plan_for(b, spec, lim - 1) == "L"
    # plan L's spill: only where a block may take more lanes than its registers carry
    assert pms.spill_words(1 << 18, 132) == 0
    assert pms.spill_words(1 << 20, 132) == 4 << 20
    assert pms.spill_words(12_000, 132, 3) == 4 * 12_000
    assert pms.spill_words(reg, 132, 1) == 0
    assert pms.spill_words(reg + 1, 132, 1) == 4 * (reg + 1)
    assert pms.slot_scratch_words(spec) == 6 * 512 + 4
    scratch = pms.empty_scratch(spec, "cpu").numpy()
    assert (scratch[:512] == -1).all() and not scratch[512:].any()


# --- chip_smoke.py's checks, on the CPU ------------------------------------------------------


def test_chip_smoke_k10_bound_counts_each_byte_once():
    """K10's bytes bound: a lane's wire, tenant, flags and verdict read once
    and its score, flag and verdict written once; the state read and
    written once; the model and policy rows read once."""
    import chip_smoke

    spec = pms.ScoreSpec.make()
    state = (spec.slots * 14 + spec.cms_depth * spec.cms_width + spec.max_tenants * 4 + 1) * 4
    model = (2 * spec.trees * spec.depth * 4 + spec.trees * spec.leaves + 16 * spec.hidden
             + 5 * spec.hidden + 4 + 8 + spec.max_tenants * 8)
    assert chip_smoke.k10_bytes(spec, 4096, 7) == 4096 * (7 + 3 + 3) * 4 + 2 * state + model
    assert chip_smoke.k10_bytes(spec, 1, 4) == (4 + 3 + 3) * 4 + 2 * state + model
