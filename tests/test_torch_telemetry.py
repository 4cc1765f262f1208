"""The port's telemetry plane (kernels/sketch.py, obs/telemetry.py, the
classifier's, the resident step's and the daemon's --telemetry and
--trace) on the CPU against the JAX package's (infw.kernels.sketch,
infw.obs.telemetry, TpuClassifier(telemetry=...) in interpret mode, the
JAX daemon), with equality of integers and no tolerance: the plain sketch
update, K9's phases replayed in numpy (``sketch.formulation``) and both
host models against ``jitted_sketch_update`` on seeded batches with
duplicate keys, one key, slot collisions where a matched max and a
replacement meet, saturation, an int32 wrap, every way and depth count,
tenants out of range, non-IP kinds and both wire widths; the summaries,
token buckets, sampling and drain cadence; the classifiers on every path,
classic, flow, resident and superbatch; both daemons; the flags."""
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import infw.daemon as jax_daemon
from infw import flow as jax_flow
from infw import testing as jax_testing
from infw.backend.tpu import TpuClassifier
from infw.kernels import sketch as jsk
from infw.obs import telemetry as jtel
from infw_torch import convert, daemon, flow, testing
from infw_torch.backend.cuda import TorchClassifier
from infw_torch.kernels import sketch as psk
from infw_torch.kernels.resident import resident_step
from infw_torch.kernels.torchpath import _pack_res16
from infw_torch.obs import telemetry as ptel

import test_torch_daemon as tdaemon
from test_torch_overlay import _pair

FIELDS = ("cms", "keys", "cnt", "tcnt")


@pytest.fixture(scope="module")
def tables():
    return testing.random_tables_fast(np.random.default_rng(5), 300, width=4, v6_fraction=0.4)


# --- the update against jitted_sketch_update -----------------------------------------

class _Pool:
    """``size`` packets over ``tables``, each with its own verdict and
    tenant; ``draw(n)`` gives n lanes of them (so keys repeat within and
    across batches) with random flags."""

    def __init__(self, rng, tables, size=48, width=7, tenants=(0, 1), kinds=None):
        self.rng = rng
        b = testing.random_batch_fast(rng, tables, size)
        if kinds is not None:
            b.kind[:] = rng.choice(kinds, size)
        self.wire = b.pack_wire() if width == 7 else b.pack_wire_v4()
        self.res = (rng.integers(0, 4, size).astype(np.uint32)
                    | (rng.integers(0, 6, size).astype(np.uint32) << 8))
        self.tenant = rng.integers(tenants[0], tenants[1], size).astype(np.int32)

    def draw(self, n):
        idx = self.rng.integers(0, len(self.wire), n)
        return [self.wire[idx], self.res[idx], self.tenant[idx],
                self.rng.integers(0, 32, n).astype(np.int32)]


def _inputs(rng, tables, n, **kw):
    return _Pool(rng, tables, **kw).draw(n)


def _buckets(spec, wire, res, tenant):
    from infw_torch.flow import host_unpack_wire

    keyw = psk._key_words_np(host_unpack_wire(wire), tenant, res)
    h1, h2 = psk._hash_np(keyw)
    return [[d * spec.width + ((int(h1[i]) + d * int(h2[i])) & 0xFFFFFFFF & (spec.width - 1))
             for d in range(spec.depth)] for i in range(len(wire))]


def _case(name, tables):
    """(spec keywords, start state or None, batches) of a named case."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    kw = dict(depth=4, width=64, topk=32, ways=4, max_tenants=2)
    start = None
    pool = _Pool(rng, tables)
    if name == "seeded":
        batches = [pool.draw(256) for _ in range(3)]
    elif name == "duplicate_keys":
        batches = []
        for _ in range(3):
            x = pool.draw(128)
            for a in x:
                a[:64] = np.repeat(a[:8], 8, axis=0)
            batches.append(x)
    elif name == "one_key":
        kw.update(ways=2)
        x = _inputs(rng, tables, 96, tenants=(0, 1))
        x[0][x[0][:, 0] & 3 == 1] = x[0][(x[0][:, 0] & 3 == 1).argmax()]
        for a in x:
            a[:] = a[:1]
        batches = [x, [a.copy() for a in x]]
    elif name == "slot_collisions":
        kw.update(topk=8, ways=1, width=16)
        batches = [pool.draw(64) for _ in range(5)]
    elif name == "sat3":
        kw.update(sat=3, width=16, topk=8)
        batches = [pool.draw(128) for _ in range(3)]
    elif name == "wrap":
        kw.update(depth=2, width=32)
        x = pool.draw(64)
        lane = int(np.nonzero((x[0][:, 0] & 3) == 1)[0][0])
        x[2][:] = 0
        for a in x:
            a[:5] = a[lane]
        start = {"cms": np.zeros((2, 32), np.int32), "keys": np.zeros((32, 6), np.uint32),
                 "cnt": np.zeros(32, np.int32), "tcnt": np.zeros((2, 4), np.int32)}
        start["cms"].reshape(-1)[_buckets(psk.SketchSpec.make(**kw), x[0][:1], x[1][:1],
                                          x[2][:1])[0]] = 2**31 - 2
        batches = [x, pool.draw(64)]
    elif name.startswith("ways") or name.startswith("depth"):
        k = "ways" if name.startswith("ways") else "depth"
        kw.update({k: int(name[len(k):]), "topk": 16})
        batches = [pool.draw(128) for _ in range(3)]
    elif name == "tenants":
        kw.update(max_tenants=3)
        pool = _Pool(rng, tables, tenants=(-5, 7))
        batches = [pool.draw(128) for _ in range(2)]
    elif name == "above_sat_start":
        # a state carried across whose count-min cells sit above sat, most of
        # them untouched by the lanes: the whole array comes out clamped
        kw.update(sat=6)
        start = {"cms": rng.integers(0, 20, (4, 64)).astype(np.int32),
                 "keys": np.zeros((32, 6), np.uint32), "cnt": np.zeros(32, np.int32),
                 "tcnt": np.zeros((2, 4), np.int32)}
        x = pool.draw(24)
        batches = [x, [a.copy() for a in x], pool.draw(24)]
    elif name == "non_ip":
        pool = _Pool(rng, tables, kinds=[0, 1, 2, 3])
        batches = [pool.draw(128) for _ in range(2)]
    elif name == "wire4":
        b = testing.random_batch_fast(rng, tables, 256)
        idx = np.nonzero(b.kind == 1)[0][:48]
        wire, is_v4 = b.pack_wire_subset(idx)
        assert wire.shape[1] == 4 and is_v4
        pool.wire = wire
        pool.res, pool.tenant = pool.res[: len(idx)], pool.tenant[: len(idx)]
        batches = [pool.draw(128) for _ in range(2)]
    else:
        raise KeyError(name)
    return kw, start, batches


CASES = (["seeded", "duplicate_keys", "one_key", "slot_collisions", "sat3", "wrap", "tenants",
          "non_ip", "wire4", "above_sat_start"] + [f"ways{k}" for k in range(1, 9)]
         + [f"depth{k}" for k in range(1, 9)])


@pytest.mark.parametrize("name", CASES)
def test_update_matches_jax_bit_for_bit(tables, name):
    """Per batch: the JAX update, both host models, the port's plain update
    on CPU tensors (started from the JAX state through
    convert.sketch_state_from_jax) and K9's phases replayed in numpy, plan S
    and plan L over three blocks, leave the same four arrays."""
    kw, start, batches = _case(name, tables)
    jspec, pspec = jsk.SketchSpec.make(**kw), psk.SketchSpec.make(**kw)
    host = start or {f: np.asarray(a) for f, a in zip(FIELDS, jsk.zero_state_host(jspec))}
    jst = jsk.SketchState(*(jnp.asarray(np.array(host[f])) for f in FIELDS))
    pst = convert.sketch_state_from_jax(**{f: host[f] for f in FIELDS}, device="cpu")
    form = {f: np.array(host[f]) for f in FIELDS}
    form_l = {f: np.array(host[f]) for f in FIELDS}
    jm, pm = jsk.HostSketchModel(jspec), psk.HostSketchModel(pspec)
    for m in (jm, pm):
        m.cms, m.keys, m.cnt, m.tcnt = (np.array(host[f]) for f in FIELDS)
    stats = {"matched": 0, "winners": 0, "max_and_win": 0}
    for wire, res, tenant, tflags in batches:
        jst = jsk.jitted_sketch_update(jspec)(jst, jnp.asarray(wire), jnp.asarray(tenant),
                                              jnp.asarray(tflags), jnp.asarray(res))
        psk.sketch_update(pst, torch.from_numpy(wire.view(np.int32)), torch.from_numpy(tenant),
                          torch.from_numpy(tflags), torch.from_numpy(res.view(np.int32)), pspec)
        jm.update(wire, res, tenant, tflags)
        pm.update(wire, res, tenant, tflags)
        for k, v in psk.formulation(form, wire, res, tenant, tflags, pspec).items():
            stats[k] += v
        psk.formulation(form_l, wire, res, tenant, tflags, pspec, plan="L", blocks=3)
        got = psk.state_to_host(pst)
        for f in FIELDS:
            want = np.asarray(getattr(jst, f))
            for side, arr in (("plain", got[f]), ("port model", pm.columns()[f]),
                              ("jax model", jm.columns()[f]), ("formulation", form[f]),
                              ("formulation, plan L", form_l[f])):
                np.testing.assert_array_equal(np.asarray(arr).view(want.dtype), want,
                                              err_msg=f"{name} {f} {side}")
    assert stats["matched"] > 0 and stats["winners"] > 0
    if name == "slot_collisions":
        assert stats["max_and_win"] > 0
    if name == "sat3":
        assert int(form["cms"].max()) == 3
    if name == "wrap":
        assert int(form["cms"].min()) < 0
    if name == "above_sat_start":
        touched = {c for wire, res, tenant, _f in batches
                   for i, row in enumerate(_buckets(pspec, wire, res, tenant))
                   if (wire[i, 0] & 3) in (1, 2) and 0 <= tenant[i] < pspec.max_tenants
                   for c in row}
        above = [c for c in np.nonzero(start["cms"].reshape(-1) > pspec.sat)[0]
                 if c not in touched]
        assert above and int(form["cms"].max()) == pspec.sat
        assert (form["cms"].reshape(-1)[above] == pspec.sat).all()


def test_resident_entry_reads_packed_verdicts(tables):
    """The resident entry on packed u16 words equals the classic entry on
    the same verdicts, at an odd batch size."""
    spec = psk.SketchSpec.make(width=64, topk=16)
    wire, res, tenant, tflags = _inputs(np.random.default_rng(3), tables, 101)
    res &= 0xFFFF
    a, b = psk.zero_state(spec, "cpu"), psk.zero_state(spec, "cpu")
    args = (torch.from_numpy(wire.view(np.int32)), torch.from_numpy(tenant * 0),
            torch.from_numpy(tflags))
    psk.sketch_update(a, *args, torch.from_numpy(res.view(np.int32)), spec)
    psk.sketch_update_resident(b, *args, _pack_res16(torch.from_numpy(res.astype(np.int64))),
                               spec)
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert int(a.tcnt[0, 0]) > 0


def test_spec_and_wrappers_refuse_bad_input():
    with pytest.raises(ValueError):
        psk.SketchSpec.make(depth=9)
    with pytest.raises(ValueError):
        psk.SketchSpec.make(ways=0)
    with pytest.raises(ValueError):
        psk.SketchSpec.make(sat=0)
    spec = psk.SketchSpec.make(width=10, topk=5)
    assert (spec.width, spec.topk) == (16, 8) == (jsk.SketchSpec.make(width=10).width, 8)
    st = psk.zero_state(spec, "meta")
    wire = torch.zeros((4, 7), dtype=torch.int32, device="meta")
    z = torch.zeros(4, dtype=torch.int32, device="meta")
    for entry in (psk.sketch_update, psk.sketch_update_resident):
        with pytest.raises(ValueError, match="unsupported device"):
            entry(st, wire, z, z, z, spec)


def test_plan_chooser_takes_the_block_within_its_limits():
    """K9's host-side plan choice, with the card's shared-memory limit
    passed in: plan S within the limit and the crossover, plan L past
    either (the oversized geometry, many tenants, a limit below the state,
    a spill past the limit); the bytes as csrc/sketch_update.cu lays them
    out, and plan L's scratch."""
    spec = psk.SketchSpec.make()
    h100 = 232_448  # an H100's opt-in shared memory a block
    cross, reg = psk.BLOCK_PLAN_MAX_LANES, psk.REG_LANES * psk.BLOCK_THREADS
    state = 4 * (4 * 2048 + 11 * 256 + 4)
    assert psk.block_plan_bytes(1, spec) == psk.block_plan_bytes(reg, spec) == state
    assert psk.block_plan_bytes(reg + 3, spec) == state + 48
    assert psk.grid_scratch_words(1000, spec) == 772 + 4000  # 3 K + 1 words, then the carries
    assert psk.grid_scratch_words(1, psk.SketchSpec(topk=2)) == 8 + 4
    for b in (1, 31, 256, cross - 1, cross):
        assert psk.plan_for(b, spec, h100) == "S", b
    for b in (cross + 1, 65536, 1 << 18):
        assert psk.plan_for(b, spec, h100) == "L", b
    assert psk.plan_for(256, spec, state) == "S"
    assert psk.plan_for(256, spec, state - 1) == "L"
    big = psk.SketchSpec.make(depth=8, width=65536)
    assert psk.block_plan_bytes(1, big) > h100
    assert [psk.plan_for(b, big, h100) for b in (1, 256, 1 << 18)] == ["L"] * 3
    many = psk.SketchSpec.make(max_tenants=20_000)
    assert psk.plan_for(256, many, h100) == "L"
    assert psk.plan_for(256, psk.SketchSpec.make(max_tenants=2), h100) == "S"
    b = reg + 1
    lim = psk.block_plan_bytes(b, spec)
    assert psk.plan_for(b, spec, lim) == ("S" if b <= cross else "L")
    assert psk.plan_for(b, spec, lim - 1) == "L"
    odd = psk.SketchSpec(depth=1, width=2, topk=2, ways=1, sat=5, max_tenants=1)
    assert psk.block_plan_bytes(1, odd) == 4 * 28  # 2 + 22 + 4 words, on 16 bytes


# --- summaries, sampling, the drain ---------------------------------------------------

def test_summarize_snapshot_matches_jax(tables):
    spec_kw = dict(width=64, topk=16, max_tenants=3)
    jt, pt = (jtel.TelemetryTier(jsk.SketchSpec.make(**spec_kw)),
              ptel.TelemetryTier(psk.SketchSpec.make(**spec_kw), device="cpu"))
    rng = np.random.default_rng(9)
    for _ in range(3):
        wire, res, tenant, tflags = _inputs(rng, tables, 200, tenants=(0, 3))
        res[:150] = 1  # a deny storm
        tflags[:] = 2  # pure SYNs where TCP
        for t in (jt, pt):
            t.update(wire, res, tenant, tflags)
    for t in (jt, pt):
        t.min_packets = 16
    jr, pr = jt.drain(), pt.drain()
    assert [r.lines() for r in jr] == [r.lines() for r in pr]
    assert pr[0].tenants and pr[0].top and any(t["deny_storm"] for t in pr[0].tenants)
    snap = ptel.SketchSnapshot(seq=4, admissions=2, cms=np.zeros((1, 8), np.int32),
                               keys=np.zeros((8, 6), np.uint32),
                               cnt=np.array([0, 3, 3, 1, 0, 0, 9, 0], np.int32),
                               tcnt=np.array([[100, 10, 90, 70]], np.int32))
    snap.keys[:, 5] = [0, 0x101, 0x202, 0x102, 0, 0, 0x201, 0]
    snap.keys[6, 1:5] = [0x20010DB8, 0, 0, 1]
    jsnap = jtel.SketchSnapshot(*snap)
    assert ptel.summarize_snapshot(snap, top_n=3).lines() == jtel.summarize_snapshot(
        jsnap, top_n=3).lines()


def test_token_bucket_and_sample_allow_match_jax():
    jb, pb = jtel.TokenBucket(10.0, 5.0), ptel.TokenBucket(10.0, 5.0)
    for n, now in ((3, 0.0), (4, 0.1), (9, 0.2), (2, 0.2), (20, 5.0), (1, 4.0)):
        assert pb.take(n, now) == jb.take(n, now)
    jt = jtel.TelemetryTier(jsk.SketchSpec.make(width=8, topk=8), sample_rate=2.0,
                            sample_burst=4.0)
    pt = ptel.TelemetryTier(psk.SketchSpec.make(width=8, topk=8), device="cpu",
                            sample_rate=2.0, sample_burst=4.0)
    for tenant, n, now in ((0, 3, 0.0), (0, 3, 0.1), (1, 9, 0.1), (0, 5, 3.0)):
        assert pt.sample_allow(tenant, n, now) == jt.sample_allow(tenant, n, now)
    assert pt.counter_values() == jt.counter_values()
    assert pt.counter_values()["telemetry_suppressed_events_total"] > 0


def test_drain_cadence_and_seq_match_jax(tables):
    """drain_every = 3 over 8 updates: summaries at the 3rd and 6th
    (seq 1 and 2), a forced drain of the open window (seq 3), a forced
    drain of an empty window still counts; the ring receives the records
    in seq order; the counters equal the JAX tier's."""
    from infw.obs.events import EventRing as JRing
    from infw_torch.obs.events import EventRing as PRing

    jring, pring = JRing(64), PRing(64)
    jt = jtel.TelemetryTier(jsk.SketchSpec.make(width=32, topk=8), drain_every=3, ring=jring)
    pt = ptel.TelemetryTier(psk.SketchSpec.make(width=32, topk=8), device="cpu",
                            drain_every=3, ring=pring, track_model=True)
    rng = np.random.default_rng(11)
    for _ in range(8):
        wire, res, _t, tflags = _inputs(rng, tables, 64)
        for t in (jt, pt):
            t.update(wire, res, None, tflags)
    assert pt.drain_seq == jt.drain_seq == 2
    jt.drain(), pt.drain()
    jt.drain(), pt.drain()
    assert pt.counter_values() == jt.counter_values()
    assert pt.counter_values()["telemetry_drain_seq"] == 4
    jl = [line for r in jring.pop_all() for line in r.lines()]
    pl = [line for r in pring.pop_all() for line in r.lines()]
    assert pl == jl and [l.split()[1] for l in pl if l.startswith("telemetry-summary")] == [
        "seq=1", "seq=2", "seq=3", "seq=4"]
    cols = pt.columns()
    assert all(not cols[f].any() for f in FIELDS)
    assert all(not np.asarray(v).any() for v in pt.model.columns().values())


# --- the classifiers ------------------------------------------------------------------

SPEC = dict(depth=3, width=128, topk=32, ways=2, max_tenants=2)
B = 64


@pytest.fixture(scope="module")
def tabs():
    """A 300-entry table (40% IPv6) on both sides and a 6-chunk 64-packet
    flow trace over it with flags."""
    jt0 = jax_testing.random_tables(np.random.default_rng(30), n_entries=300, width=4,
                                    v6_fraction=0.4, ifindexes=(2, 3))
    jt, pt = _pair({tuple(k): np.array(v) for k, v in jt0.content.items()})
    trace, _ = testing.flow_trace_batch(np.random.default_rng(17), pt, 6 * B, 0.7,
                                        chunk_packets=B)
    return {"jt": jt, "pt": pt, "trace": trace}


def _run(clf, trace, super_k=0):
    """The trace's chunks through prepare_packed / classify_prepared (or
    the superbatch), returning the outputs."""
    outs = []
    if super_k:
        stack = np.stack([trace.slice(B * j, B * (j + 1)).pack_wire() for j in range(super_k)])
        flags = np.asarray(trace.tcp_flags, np.int32)[: super_k * B].reshape(super_k, B)
        rows = clf.classify_prepared_super(clf.prepare_packed_super(stack, False, flags))
        return [r.result() for r in rows]
    for j in range(len(trace) // B):
        c = trace.slice(B * j, B * (j + 1))
        w, v4 = c.pack_wire_subset(np.arange(B))
        outs.append(clf.classify_prepared(clf.prepare_packed(w, v4, tcp_flags=c.tcp_flags)
                                          ).result())
    return outs


MODES = {  # path, flow table, resident, superbatch K
    "dense_classic": ("dense", False, False, 0),
    "trie_classic": ("trie", False, False, 0),
    "ctrie_classic": ("ctrie", False, False, 0),
    "trie_flow": ("trie", True, False, 0),
    "dense_resident": ("dense", True, True, 0),
    "trie_resident": ("trie", True, True, 0),
    "ctrie_resident": ("ctrie", True, True, 0),
    "dense_superbatch": ("dense", True, True, 4),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_classifier_matches_tpu_classifier(tabs, mode):
    """TorchClassifier(device="cpu", telemetry=spec) against
    TpuClassifier(telemetry=spec, interpret=True) over the same chunks:
    equal sketch tensors and counters, each equal to its tracked
    HostSketchModel; the verdicts equal telemetry off."""
    path, use_flow, resident, k = MODES[mode]
    fp = None if path == "dense" else path
    kw = {}
    if use_flow:
        kw = {"flow_table": 512, "resident": resident}
    jkw = {}
    if use_flow:
        jkw = {"flow_table": jax_flow.FlowConfig.make(entries=512), "resident": resident}
    jc = TpuClassifier(interpret=True, force_path=fp, telemetry=jsk.SketchSpec.make(**SPEC),
                       telemetry_track_model=True, **jkw)
    pc = TorchClassifier(device="cpu", force_path=fp, telemetry=psk.SketchSpec.make(**SPEC),
                         telemetry_track_model=True, **kw)
    off = TorchClassifier(device="cpu", force_path=fp, **kw)
    for c, t in ((jc, tabs["jt"]), (pc, tabs["pt"]), (off, tabs["pt"])):
        c.load_tables(t)
    assert pc.active_path == path
    trace = tabs["trace"]
    got, ref = _run(pc, trace, k), _run(off, trace, k)
    _run(jc, trace, k)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.results, b.results)
        np.testing.assert_array_equal(a.xdp, b.xdp)
    pcols, jcols = pc.telemetry.columns(), jc.telemetry.columns()
    jc.telemetry.resident_note_materialized(0)
    for f in FIELDS:
        np.testing.assert_array_equal(pcols[f], np.asarray(jcols[f]), err_msg=f)
        np.testing.assert_array_equal(pcols[f], pc.telemetry.model.columns()[f], err_msg=f)
    assert pcols["tcnt"][0, 0] > 0
    assert pc.telemetry_counters() == jc.telemetry_counters()
    assert pc.telemetry_counters()["telemetry_updates_total"] == (k or len(trace) // B)


def test_resident_step_with_sketch_equals_the_classic_update(tabs):
    """The resident step's fourth stage: the sketch after a step equals a
    classic update over the step's merged verdicts, and the step's fused
    words and flow columns equal the step without the sketch."""
    from infw_torch.kernels.resident import StepTables, resident_out_words, split_resident_outputs

    pc = TorchClassifier(device="cpu", force_path="trie", resident=True, flow_table=512)
    pc.load_tables(tabs["pt"])
    ctx = pc.resident.context(pc)
    spec = psk.SketchSpec.make(**SPEC)
    tier_a = ptel.TelemetryTier(spec, device="cpu")
    fa, fb = (flow.FlowTier(flow.FlowConfig.make(entries=512), device="cpu") for _ in range(2))
    trace = tabs["trace"]
    ref = psk.zero_state(spec, "cpu")
    for j in range(3):
        c = trace.slice(B * j, B * (j + 1))
        wire_np = c.pack_wire()
        wire = torch.from_numpy(wire_np.view(np.int32))
        tables = StepTables(ctx.tables.path, ctx.tables.dev, None, ctx.tables.dev.n_levels)
        outs = []
        for tier, tel in ((fa, tier_a), (fb, None)):
            h, _ = tier.resident_dispatch(
                lambda ops: resident_step(ops, tables, wire), B, wire_np=wire_np,
                tflags=torch.from_numpy(np.asarray(c.tcp_flags, np.int32)), telemetry=tel)
            outs.append(h.numpy() if isinstance(h, torch.Tensor) else np.asarray(h))
        np.testing.assert_array_equal(outs[0], outs[1])
        assert outs[0].shape[0] == resident_out_words(B)
        res16 = split_resident_outputs(outs[0], B)[0]
        psk.sketch_update(ref, wire, torch.zeros(B, dtype=torch.int32),
                          torch.from_numpy(np.asarray(c.tcp_flags, np.int32)),
                          torch.from_numpy(res16.astype(np.int32)), spec)
    for f in FIELDS:
        assert torch.equal(getattr(tier_a._state, f), getattr(ref, f)), f
    for k, v in fa.flow_columns().items():
        np.testing.assert_array_equal(v, fb.flow_columns()[k])


def test_telemetry_switches(monkeypatch):
    """telemetry= True / a width / a SketchSpec / False, INFW_TELEMETRY, and
    no telemetry on the plain batch path without a flow tier (the
    reference's classify_async)."""
    monkeypatch.delenv("INFW_TELEMETRY", raising=False)
    assert TorchClassifier(device="cpu").telemetry is None
    assert TorchClassifier(device="cpu", telemetry=True).telemetry.spec == psk.SketchSpec.make()
    assert TorchClassifier(device="cpu", telemetry=100).telemetry.spec.width == 128
    assert TorchClassifier(device="cpu", telemetry=False).telemetry is None
    monkeypatch.setenv("INFW_TELEMETRY", "512")
    c = TorchClassifier(device="cpu")
    assert c.telemetry.spec.width == 512 and c.telemetry.device == torch.device("cpu")
    tables = testing.random_tables_fast(np.random.default_rng(1), 50, width=4)
    c.load_tables(tables)
    c.classify(testing.random_batch_fast(np.random.default_rng(2), tables, 32))
    assert c.telemetry_counters()["telemetry_updates_total"] == 0
    monkeypatch.setenv("INFW_TELEMETRY", "1")
    assert TorchClassifier(device="cpu").telemetry.spec.width == 2048
    assert TorchClassifier(device="cpu", telemetry=False).telemetry_counters() == {}


# --- the daemons --------------------------------------------------------------------

def test_daemons_agree_with_telemetry_and_trace(tmp_path):
    """Both daemons with --telemetry (drain every 2 jobs) and --trace, the
    same frames files (dense path, fewer denies than the sampling burst, so
    the wall clock grants every deny event in both):
    equal out files, events (telemetry-summary lines included) and
    telemetry_* counters, and the same span histogram series."""
    spec = dict(depth=3, width=256, topk=16)
    jreg, preg = tdaemon._registries()
    common = dict(node_name=tdaemon.NODE, poll_period_s=3600.0, metrics_port=0, health_port=0,
                  file_poll_interval_s=60.0, ingest_chunk=tdaemon.CHUNK, pipeline_depth=3,
                  telemetry_drain=2, trace=True, trace_slow_us=1e12)
    jd = jax_daemon.Daemon(state_dir=str(tmp_path / "jax"), backend="tpu", registry=jreg,
                           telemetry=jsk.SketchSpec.make(**spec), **common)
    pd = daemon.Daemon(state_dir=str(tmp_path / "port"), backend="cpu", registry=preg,
                       telemetry=psk.SketchSpec.make(**spec), **common)
    try:
        doc = tdaemon._nodestate(tdaemon.PATHS["dense"][0])
        for d in (jd, pd):
            tdaemon._write_state(d, doc)
            d.scan_nodestates_once()
            d._telemetry_maintenance()
        fbs = tdaemon._frames(doc, 4, sizes=(120, 60, 30))
        for rnd in range(2):
            for d in (jd, pd):
                tdaemon._drop(d, fbs, prefix=f"r{rnd}")
            assert jd.process_ingest_once() == pd.process_ingest_once()
        for d in (jd, pd):
            d.syncer.classifier.telemetry.drain()
        assert tdaemon._out_files(pd) == tdaemon._out_files(jd)
        pev, jev = tdaemon._events(pd), tdaemon._events(jd)
        assert pev[0].splitlines() == jev[0].splitlines() and pev[1] == jev[1]
        assert "telemetry-summary seq=1" in pev[0]
        pclf, jclf = pd.syncer.classifier, jd.syncer.classifier
        assert pclf.telemetry_counters() == jclf.telemetry_counters()
        assert pclf.telemetry_counters()["telemetry_drains_total"] >= 3
        ptext, jtext = pd.metrics_registry.render_text(), jd.metrics_registry.render_text()

        def series(text, prefix):
            return sorted({line.split(" ")[0] for line in text.splitlines()
                           if line.startswith(prefix)})

        hist = "ingressnodefirewall_node_span_us_count"
        assert series(ptext, hist) == series(jtext, hist) and len(series(ptext, hist)) == 6
        tel = "ingressnodefirewall_node_telemetry_"
        assert [l for l in ptext.splitlines() if l.startswith(tel)] == [
            l for l in jtext.splitlines() if l.startswith(tel)]
        for stage in ("ingest", "pack", "h2d", "dispatch", "materialize", "drain"):
            assert pd.tracer.histograms.values()[stage]["count"] > 0, stage
        assert pd.tracer.counter_values() == {"trace_traces_total": jd.tracer.counter_values()[
            "trace_traces_total"], "trace_slow_sampled_total": 0, "trace_slow_suppressed_total": 0}
    finally:
        tdaemon._stop(jd, pd)


def test_daemon_telemetry_flag_validation(tmp_path, monkeypatch):
    """The JAX daemon's launch validation (tests/test_telemetry.py): the
    cpu backend, a width below 8, a non-integer width, a drain below 1 and
    a non-positive slow threshold are usage errors in both daemons; the
    four flags are no longer refused, and valid ones reach the Daemon."""
    for _f, e, _i in daemon.REFUSED_FLAGS:
        monkeypatch.delenv(e, raising=False)
    for e in ("INFW_TELEMETRY", "INFW_TELEMETRY_DRAIN", "INFW_TRACE", "INFW_TRACE_SLOW_US"):
        monkeypatch.delenv(e, raising=False)
    refused = {f for f, _e, _i in daemon.REFUSED_FLAGS}
    assert not refused & {"--telemetry", "--telemetry-drain", "--trace", "--trace-slow-us"}
    base = ["--state-dir", str(tmp_path), "--node-name", "n"]
    for bad, jbad in ((["--backend", "cpu", "--telemetry", "2048"], None),
                      (["--telemetry", "4"], None), (["--telemetry", "junk"], None),
                      (["--telemetry-drain", "0"], None), (["--trace-slow-us", "-1"], None)):
        with pytest.raises(SystemExit) as e:
            daemon.main(base + (["--backend", "cuda"] if "--backend" not in bad else []) + bad)
        assert e.value.code == 2, bad
        with pytest.raises(SystemExit) as e:
            jax_daemon.main(base + ["--backend", "tpu" if "--backend" not in bad else "cpu"]
                            + [a for a in bad if a not in ("--backend", "cpu")])
        assert e.value.code == 2, bad
    seen = {}

    class Stub:
        def __init__(self, **kw):
            seen.update(kw)
            raise SystemExit(0)

    monkeypatch.setattr(daemon, "Daemon", Stub)
    monkeypatch.setenv("INFW_TELEMETRY_DEPTH", "2")
    with pytest.raises(SystemExit):
        daemon.main(base + ["--telemetry", "--telemetry-drain", "7", "--trace",
                            "--trace-slow-us", "100"])
    assert seen["telemetry"] == psk.SketchSpec.make(width=2048, depth=2)
    assert (seen["telemetry_drain"], seen["trace"], seen["trace_slow_us"]) == (7, True, 100.0)
    monkeypatch.delenv("INFW_TELEMETRY_DEPTH")
    monkeypatch.setenv("INFW_TELEMETRY", "512")
    monkeypatch.setenv("INFW_TRACE", "1")
    with pytest.raises(SystemExit):
        daemon.main(base)
    assert seen["telemetry"].width == 512 and seen["trace"] is True


def test_attack_trace_matches_jax(tabs):
    """attack_trace_batch is byte-identical to the JAX generator in every
    mode."""
    for mode in testing.ATTACK_MODES:
        pb, pm = testing.attack_trace_batch(np.random.default_rng(3), tabs["pt"], 512, mode,
                                            chunk_packets=64)
        jb, jm = jax_testing.attack_trace_batch(np.random.default_rng(3), tabs["jt"], 512, mode,
                                                chunk_packets=64)
        for f in ("kind", "l4_ok", "ifindex", "ip_words", "proto", "dst_port", "icmp_type",
                  "icmp_code", "pkt_len", "tcp_flags"):
            np.testing.assert_array_equal(np.asarray(getattr(pb, f)), np.asarray(getattr(jb, f)),
                                          err_msg=f"{mode} {f}")
        assert (pm["start"], pm["n_attack"]) == (jm["start"], jm["n_attack"]) and pm["n_attack"]
        np.testing.assert_array_equal(pm["attack_mask"], jm["attack_mask"])
        for (pa, pk), (ja, jk) in zip(pm["attackers"], jm["attackers"]):
            np.testing.assert_array_equal(pa, ja)
            assert pk == jk
    with pytest.raises(ValueError):
        testing.attack_trace_batch(np.random.default_rng(0), tabs["pt"], 8, "nope")


# --- chip_smoke.py's checks, on the CPU -----------------------------------------------

def test_chip_smoke_restricted_oracles_equal_the_full_oracle():
    """ColumnOracle (from a table's content columns) and oracle_for (from a
    content map) keep only the entries a batch's packets can match; their
    answers equal the full HashLpmOracle's on that batch, on nested
    random prefixes, clean /24 + /48 columns and clustered IPv4 addresses
    near 0.0.0.0 (the codec phase's fixed-stride chunks)."""
    import chip_smoke
    from infw_torch import oracle

    nested = testing.random_tables_fast(np.random.default_rng(1899), 20_000, width=4,
                                        ifindexes=(2, 3, 4))
    clean = testing.clean_tables_fast(np.random.default_rng(2024), 20_000)
    for tables in (nested, clean):
        full = oracle.HashLpmOracle(tables)
        b = testing.random_batch_fast(np.random.default_rng(3), tables, 2048)
        c = b.take(np.nonzero(b.kind == 1)[0])
        c.ip_words[:, 0] = np.cumsum(np.random.default_rng(1).integers(0, 200, len(c))).astype(
            np.uint32)
        restricted = [chip_smoke.ColumnOracle(tables)] if tables is clean else []
        for sub in (b, c):
            want = full.classify(sub)
            for o in restricted + [chip_smoke.oracle_for(dict(tables.content), sub)]:
                got = o.classify(sub)
                np.testing.assert_array_equal(got.results, want.results)
                np.testing.assert_array_equal(got.xdp, want.xdp)
                assert got.stats == want.stats
        assert (full.classify(b).results != 0).sum() > 0


def test_chip_smoke_k9_bound_counts_each_byte_once():
    """K9's bytes bound: a lane's 7-word wire, tenant, flags and verdict,
    and the state read and written once."""
    import chip_smoke

    spec = psk.SketchSpec.make()
    state = (spec.depth * spec.width + spec.topk * 7 + spec.max_tenants * 4) * 4
    assert chip_smoke.k9_bytes(spec, 4096, 7) == 4096 * 40 + 2 * state
    assert chip_smoke.k9_bytes(spec, 1, 4) == 28 + 2 * state
