"""The port's stateful flow tier (infw_torch.flow, kernels/flow.py) on the
CPU against the JAX package's (infw.flow, the XLA flow programs of
kernels/jaxpath.py), with no tolerance: the plain versions of K7 and K8
against jitted_flow_probe and jitted_flow_insert from the same carried-
across columns; FlowTier against the JAX FlowTier and both host models
over a seeded stream of probes, inserts, bumps, page moves, age sweeps and
resets; TorchClassifier and TorchArenaClassifier with a flow table against
TpuClassifier and ArenaClassifier with one (results, verdicts, statistics,
flow counters, columns and wire_stats), and against the stateless port;
invalidation by a hinted load and an edit flush; the two daemons under a
flow table; and flow_trace_batch byte for byte."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import infw._threads as jax_threads
import infw.daemon as jax_daemon
from infw import flow as jax_flow
from infw import packets as jax_packets
from infw import testing as jax_testing
from infw.backend.tpu import ArenaClassifier, TpuClassifier
from infw.kernels import jaxpath
from infw.obs import events as jax_events
from infw_torch import _threads, arena, convert, flow, testing, txn
from infw_torch.backend.cuda import TorchArenaClassifier, TorchClassifier
from infw_torch.compiler import IncrementalTables
from infw_torch.constants import TCP_ACK, TCP_FIN, TCP_RST
from infw_torch.kernels import flow as kflow
from infw_torch.obs import events

import test_torch_daemon as tdaemon


def _jax_batch(pb):
    return jax_packets.PacketBatch(**{f: np.array(getattr(pb, f)) for f in (
        "kind", "l4_ok", "ifindex", "ip_words", "proto", "dst_port", "icmp_type", "icmp_code",
        "pkt_len", "tcp_flags")})


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def _columns_equal(port: dict, want: dict, label=""):
    for k in kflow.COLUMNS:
        np.testing.assert_array_equal(np.asarray(port[k]).view(np.int32),
                                      np.asarray(want[k]).view(np.int32), err_msg=f"{label} {k}")


def _port_cols(ft: kflow.FlowTable) -> dict:
    return {k: getattr(ft, k).numpy() for k in kflow.COLUMNS}


# --- (a) the plain K7 and K8 against the XLA programs ---------------------------


@pytest.mark.parametrize("width", [4, 7])
@pytest.mark.parametrize("name", testing.FLOW_KERNEL_CASES)
def test_plain_k7_k8_match_jax(name, width):
    """From the same columns, carried across by convert.flow_from_jax_arrays:
    the probe's fused buffer, then the insert's counts, and every column
    after each, equal jitted_flow_probe's and jitted_flow_insert's."""
    c = testing.flow_kernel_case(name, width)
    S, W = c["entries"], c["ways"]
    jt = jaxpath.FlowTable(**{k: jnp.asarray(c[k]) for k in kflow.COLUMNS})
    pt, gens, page_table = convert.flow_from_jax_arrays(
        *(c[k] for k in kflow.COLUMNS), c["gens"], c["page_table"], device="cpu")
    wire, tenant, tflags, epoch = c["probe"]
    jfused, jt = jaxpath.jitted_flow_probe(S, W)(
        jt, jnp.asarray(c["gens"]), jnp.asarray(c["page_table"]), jnp.asarray(wire),
        jnp.asarray(tenant), jnp.asarray(tflags), jnp.int32(epoch), jnp.int32(c["max_age"]))
    before = kflow.PROBE_KERNEL.launches
    fused = kflow.flow_probe(pt, gens, page_table, _i32(wire), _i32(tenant), _i32(tflags), epoch,
                             c["max_age"], slab_entries=S, ways=W)
    assert kflow.PROBE_KERNEL.launches == before  # a CPU tensor: the plain version
    np.testing.assert_array_equal(fused.numpy(), np.asarray(jfused))
    _columns_equal(_port_cols(pt), jt._asdict(), "probe")
    res16, hit, hits, stale = kflow.split_flow_probe_outputs(fused.numpy(), len(wire))
    jres = jaxpath.split_flow_probe_outputs(np.asarray(jfused), len(wire))
    np.testing.assert_array_equal(res16, jres[0])
    np.testing.assert_array_equal(hit, jres[1])
    assert (hits, stale) == jres[2:]
    wire, tenant, tflags, verdict, epoch = c["insert"]
    jt, jcounts = jaxpath.jitted_flow_insert(S, W)(
        jt, jnp.asarray(c["gens"]), jnp.asarray(c["page_table"]), jnp.asarray(wire),
        jnp.asarray(tenant), jnp.asarray(tflags), jnp.asarray(verdict), jnp.int32(epoch))
    counts = kflow.flow_insert(pt, gens, page_table, _i32(wire), _i32(tenant), _i32(tflags),
                               _i32(verdict), epoch, slab_entries=S, ways=W)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    _columns_equal(_port_cols(pt), jt._asdict(), "insert")
    assert bool((pt.winner == -1).all())
    if name == "stale_generation":
        assert stale > 0
    if name == "syn_then_ack_promote":
        assert int(counts[2]) > 0
    if name == "full_slab_tied_epochs":
        assert int(counts[1]) == pt.capacity  # every way evicted, first of the ties
    if name in ("fin_rst_same_slot", "teardown_then_hit"):
        assert hits > 0
    if name == "hot_slot":
        assert hits > 300  # hundreds of lanes of one flow hit its slot
    if name == "warp_mixed_slots":
        assert hits > len(wire) // 2
    if name == "lanes_beyond_grid":
        assert len(wire) > 132 * 2048  # an H100's resident threads


def test_fin_and_rst_on_one_slot_leave_it_empty():
    """Max, then min: a FIN lane and an RST lane hitting one slot in one
    batch leave state 0 (the other order would leave FIN), and a later
    lane of the batch that RST tears down still hits (reads see the old
    columns)."""
    c = testing.flow_kernel_case("fin_rst_same_slot", 7)
    pt, gens, page_table = convert.flow_from_jax_arrays(
        *(c[k] for k in kflow.COLUMNS), c["gens"], c["page_table"], device="cpu")
    wire, tenant, tflags, epoch = c["probe"]
    model = flow.HostFlowModel(flow.FlowConfig.make(entries=c["entries"], ways=c["ways"],
                                                    max_age=c["max_age"]))
    for k in kflow.COLUMNS:
        getattr(model, k)[:] = c[k]
    model.gens[:] = c["gens"]
    fused = kflow.flow_probe(pt, gens, page_table, _i32(wire), _i32(tenant), _i32(tflags), epoch,
                             c["max_age"], slab_entries=c["entries"], ways=c["ways"])
    res16, hit, _h, _s = model.probe(wire, tenant, tflags, epoch)
    _res, khit, _h2, _s2 = kflow.split_flow_probe_outputs(fused.numpy(), len(wire))
    np.testing.assert_array_equal(khit, hit)
    # lanes 4..7 carry RST on the flow that lanes 0..3 FIN: all eight hit
    assert hit[:8].all()
    key = flow.host_flow_key_words(flow.host_unpack_wire(wire[:1]), tenant[:1])
    slots = flow.host_flow_slots(key, np.zeros(1, np.int32), slab_entries=c["entries"],
                                 ways=c["ways"])[0]
    mine = [s for s in slots if np.array_equal(pt.keys[s].numpy().view(np.uint32), key[0])]
    assert len(mine) == 1 and int(pt.se[mine[0], 0]) == 0
    _columns_equal(_port_cols(pt), model.columns(), "model")


# --- (b) FlowTier against the JAX tier and the host models -----------------------


def _tier_stream(rng, width, n_ops, tenants):
    tables = testing.random_tables_fast(np.random.default_rng(5), 200, width=4,
                                        v6_fraction=0.0 if width == 4 else 0.5)
    batch, _ = testing.flow_trace_batch(rng, tables, 64 * n_ops, 0.7, chunk_packets=64)
    if width == 4:
        batch.ip_words[:, 1:] = 0
        batch.kind[:] = 1
    flags = batch.tcp_flags.copy()
    flags[rng.random(len(batch)) < 0.05] = TCP_RST
    flags[rng.random(len(batch)) < 0.05] = TCP_FIN | TCP_ACK
    batch.tcp_flags = flags
    tenant = rng.integers(-1, tenants + 1, len(batch)).astype(np.int32)
    return batch, tenant


@pytest.mark.parametrize("width", [4, 7])
@pytest.mark.parametrize("geometry", ["single", "paged"])
def test_flow_tier_matches_jax_tier_and_models(geometry, width):
    """A seeded stream of probe+insert, bump_generation, bump_all, set_page,
    age and reset on the port's FlowTier(track_model=True) and the JAX
    FlowTier(track_model=True): equal probe buffers, insert counts, stats
    and columns after every operation, and each equal to its host model."""
    rng = np.random.default_rng(11 + width)
    if geometry == "single":
        kw, tenants = dict(entries=64, ways=4, max_age=6), 1
    else:
        kw, tenants = dict(entries=32, pages=3, ways=2, max_tenants=4, max_age=9), 4
    pt = flow.FlowTier(flow.FlowConfig.make(**kw), device="cpu", track_model=True)
    jt = jax_flow.FlowTier(jax_flow.FlowConfig.make(**kw), track_model=True)
    assert tuple(pt.config) == tuple(jt.config)
    if geometry == "paged":
        for t, p in ((0, 0), (1, 2), (2, 1)):
            pt.set_page(t, p)
            jt.set_page(t, p)
    batch, tenant = _tier_stream(rng, width, 24, tenants)
    ops = rng.choice(["traffic"] * 6 + ["bump", "bump_all", "page", "age", "reset"], 24)
    ops[0] = "traffic"
    hits = 0
    for step, op in enumerate(ops):
        sub = batch.slice(64 * step, 64 * step + 64)
        ten = tenant[64 * step: 64 * step + 64] if geometry == "paged" else None
        if op == "traffic":
            wire = sub.pack_wire_v4() if width == 4 else sub.pack_wire()
            pf, pctx = pt.probe(wire, ten, sub.tcp_flags)
            jf, jctx = jt.probe(wire, ten, sub.tcp_flags)
            np.testing.assert_array_equal(pf.numpy(), np.asarray(jf), err_msg=str(step))
            hits += kflow.split_flow_probe_outputs(pf.numpy(), len(wire))[2]
            verdict = rng.integers(0, 1 << 16, len(sub)).astype(np.uint32)
            assert pt.insert(pctx, wire, verdict, ten, sub.tcp_flags) == \
                jt.insert(jctx, wire, verdict, ten, sub.tcp_flags)
        elif op == "bump":
            t = int(rng.integers(-1, tenants + 1))
            pt.bump_generation(t)
            jt.bump_generation(t)
        elif op == "bump_all":
            pt.bump_all_generations()
            jt.bump_all_generations()
        elif op == "page":
            t, p = int(rng.integers(0, tenants)), int(rng.integers(-1, kw.get("pages", 1)))
            pt.set_page(t, p)
            jt.set_page(t, p)
        elif op == "age":
            h = int(rng.integers(1, 5))
            assert pt.age(h) == jt.age(h)
        else:
            pt.reset()
            jt.reset()
        pcols, jcols = pt.flow_columns(), jt.flow_columns()
        assert pcols["keys"].dtype == np.uint32
        _columns_equal(pcols, jcols, f"{step} {op}")
        _columns_equal(pcols, pt.model.columns(), f"{step} {op} model")
        _columns_equal(jcols, jt.model.columns(), f"{step} {op} jax model")
        assert pt.stats.values() == jt.stats.values()
        assert pt.counter_values() == jt.counter_values()
        assert pt.epoch == jt.epoch
    assert hits > 0


def test_flow_config_and_helpers_match_jax():
    for kw in ({}, {"entries": 1000}, {"entries": 1}, {"ways": 8, "pages": 3}):
        assert tuple(flow.FlowConfig.make(**kw)) == tuple(jax_flow.FlowConfig.make(**kw))
    for kw in ({"entries": 0}, {"ways": 9}, {"ways": 0}, {"max_age": 0}, {"max_tenants": 0}):
        with pytest.raises(ValueError) as want:
            jax_flow.FlowConfig.make(**kw)
        with pytest.raises(ValueError) as got:
            flow.FlowConfig.make(**kw)
        assert str(got.value) == str(want.value)
    for m in (0, 1, 7, 8, 9, 1000, 4096, 4097):
        assert flow.flow_miss_bucket(m) == jax_flow.flow_miss_bucket(m)
    rng = np.random.default_rng(4)
    wire7 = rng.integers(0, 1 << 32, (300, 7), dtype=np.uint64).astype(np.uint32)
    for w in (7, 6, 4, 3):
        a, b = flow.host_unpack_wire(wire7[:, :w]), jax_flow.host_unpack_wire(wire7[:, :w])
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype
    mask = rng.random(77) < 0.5
    np.testing.assert_array_equal(kflow.pack_bits32(torch.from_numpy(mask)).numpy(),
                                  np.asarray(jaxpath._pack_bits32(jnp.asarray(mask))))
    rec = events.FlowEvictRecord(evicted=3, inserted=9, epoch=41)
    assert rec.lines() == jax_events.FlowEvictRecord(evicted=3, inserted=9, epoch=41).lines()


# --- (c) TorchClassifier against TpuClassifier ------------------------------------

PATHS = {"dense": 200, "trie": 5000, "ctrie": 5000}


def _outputs_equal(got, want, label=""):
    for f in ("results", "xdp", "stats_delta"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)),
                                      err_msg=f"{label} {f}")


@pytest.mark.parametrize("path", sorted(PATHS))
def test_classifier_matches_tpu_classifier(path):
    """TorchClassifier(device="cpu", flow_table=...) against
    TpuClassifier(flow_table=..., interpret=True) over flow_trace_batch
    chunks, mixed (7-word) and IPv4-only (4-word, so on the trie and ctrie
    paths the miss chunk ships wire8 or delta), through classify and
    classify_async_packed with flags: equal outputs, flow counters,
    columns and wire_stats, and the stateless port's outputs."""
    n = PATHS[path]
    jtab = jax_testing.random_tables_fast(np.random.default_rng(3), n, width=4, v6_fraction=0.5,
                                          ifindexes=(2, 3))
    ptab = testing.random_tables_fast(np.random.default_rng(3), n, width=4, v6_fraction=0.5,
                                      ifindexes=(2, 3))
    jc = TpuClassifier(force_path=path, flow_table=256, interpret=True,
                       fused_deep=path == "ctrie")
    pc = TorchClassifier(device="cpu", force_path=path, flow_table=256)
    st = TorchClassifier(device="cpu", force_path=path)
    for c in (jc, pc, st):
        c.load_tables(jtab if c is jc else ptab)
    assert pc.flow.config == flow.FlowConfig.make(entries=256)
    batch, _ = testing.flow_trace_batch(np.random.default_rng(9), ptab, 4 * 384, 0.8,
                                        chunk_packets=384)
    for k in range(4):
        sub = batch.slice(384 * k, 384 * k + 384)
        if k % 2:
            idx = np.nonzero(sub.kind == 1)[0]
            sub = sub.take(idx)
            wire, v4 = sub.pack_wire_subset(np.arange(len(sub)))
            assert wire.shape[1] == 4 and v4
            got = pc.classify_async_packed(wire, v4, tcp_flags=sub.tcp_flags).result()
            want = jc.classify_async_packed(wire, v4, tcp_flags=sub.tcp_flags).result()
        else:
            got, want = pc.classify(sub), jc.classify(_jax_batch(sub))
        _outputs_equal(got, want, f"chunk {k}")
        _outputs_equal(got, st.classify(sub), f"chunk {k} stateless")
        assert pc.flow_counters() == jc.flow_counters(), k
    _columns_equal(pc.flow.flow_columns(), jc.flow.flow_columns())
    assert pc.wire_stats() == jc.wire_stats()
    np.testing.assert_array_equal(pc.stats.snapshot(), jc.stats.snapshot())
    c = pc.flow_counters()
    assert c["flow_hits_total"] > 0 and c["flow_inserts_total"] > 0
    if path != "dense":
        assert set(pc.wire_stats()) & {"wire8", "delta"}
    assert pc.flow_age_tick(1) == jc.flow_age_tick(1)
    assert pc.flow_counters() == jc.flow_counters()


def test_env_turns_the_tier_on(monkeypatch):
    monkeypatch.setenv("INFW_FLOW_TABLE", "100")
    assert TorchClassifier(device="cpu").flow.config.entries == 128
    monkeypatch.setenv("INFW_FLOW_TABLE", "0")
    assert TorchClassifier(device="cpu").flow is None
    assert TorchClassifier(device="cpu", flow_table=False).flow is None


# --- (d) invalidation ----------------------------------------------------------


def _hit_twice(clf, batch):
    clf.classify(batch)
    out = clf.classify(batch)
    assert clf.flow_counters()["flow_hits_total"] > 0
    return out


def test_hinted_load_and_edit_flush_never_serve_a_pre_edit_verdict():
    """A rules-only patch (load_tables with the dirty hint) and a folded edit
    flush (txn.TxnApplier) each bump the generation: the next classify
    serves the new tables' verdicts (equal to a fresh stateless
    classifier's), counts stale rejects, and re-caches."""
    rng = np.random.default_rng(21)
    tables = testing.random_tables_fast(rng, 5000, width=4, ifindexes=(2, 3))
    it = IncrementalTables.from_content(dict(tables.content), rule_width=4)
    clf = TorchClassifier(device="cpu", flow_table=1 << 12, force_path="trie")
    clf.load_tables(it.snapshot())
    it.clear_dirty()
    batch, _ = testing.flow_trace_batch(rng, tables, 512, 0.0)
    batch.tcp_flags[:] = 0
    before = _hit_twice(clf, batch)
    # flip the action of every rule of 300 keys
    hit_rows = {}
    content = dict(tables.content)
    keys = list(content)
    for i in np.random.default_rng(0).choice(len(keys), 300, replace=False):
        key, rows = keys[i], content[keys[i]]
        rows = np.asarray(rows).copy()
        live = rows[:, 0] != 0
        rows[live, 6] = np.where(rows[live, 6] == 1, 2, 1)
        hit_rows[key] = rows
    it.apply(hit_rows)
    clf.load_tables(it.snapshot(), dirty_hint=it.peek_dirty())
    assert clf._last_load[0] == "patch"
    it.clear_dirty()
    stale0 = clf.flow_counters()["flow_stale_rejects_total"]
    after = clf.classify(batch)
    fresh = TorchClassifier(device="cpu", force_path="trie")
    fresh.load_tables(it.snapshot())
    _outputs_equal(after, fresh.classify(batch), "patched")
    assert not np.array_equal(after.results, before.results)
    assert clf.flow_counters()["flow_stale_rejects_total"] > stale0
    _outputs_equal(_hit_twice(clf, batch), after, "re-cached")
    # an edit flush: a folded transaction through the applier
    applier = txn.TxnApplier(clf, it)
    ops = testing.generate_edit_ops(np.random.default_rng(3), 200, it.snapshot(), 4)
    inv0 = clf.flow_counters()["flow_invalidations_total"]
    applier.apply(ops)
    assert clf.flow_counters()["flow_invalidations_total"] > inv0
    want = TorchClassifier(device="cpu", force_path="trie")
    want.load_tables(clf.tables, overlay=applier._compiled_overlay())
    _outputs_equal(clf.classify(batch), want.classify(batch), "flushed")


# --- (e) TorchArenaClassifier against ArenaClassifier -----------------------------

ARENA_TENANTS, ARENA_PAGES, ARENA_MAX = 4, 6, 8


def _arena_tables(mod, family):
    n = 24 if family == "ctrie" else 40
    return {t: mod.random_tables(np.random.default_rng(300 + t), n_entries=n, width=4,
                                 v6_fraction=0.4) for t in range(ARENA_TENANTS + 2)}


@pytest.mark.parametrize("family", ["ctrie", "dense"])
def test_arena_classifier_matches_jax_with_flow(family):
    """TorchArenaClassifier(flow_table=64) against ArenaClassifier(
    flow_table=64) through loads, a swap, a stage + activate, a destroy and
    a compaction: equal outputs, tenant and flow counters and columns after
    each, every output equal to the stateless port arena's; tenant ids -1
    and >= max_tenants are ineligible and UNDEF."""
    jtabs, ptabs = _arena_tables(jax_testing, family), _arena_tables(testing, family)
    kw = {"pages": ARENA_PAGES, "max_tenants": ARENA_MAX}
    js = jaxpath.arena_spec_for(family, list(jtabs.values()), **kw)
    ps = arena.arena_spec_for(family, list(ptabs.values()), **kw)
    assert tuple(ps) == tuple(js)
    jc = ArenaClassifier(js, interpret=True, fused_deep=family == "ctrie", flow_table=64)
    pc = TorchArenaClassifier(ps, device="cpu", flow_table=64)
    st = TorchArenaClassifier(ps, device="cpu")
    for t in range(ARENA_TENANTS):
        assert pc.load_tenant(t, ptabs[t]) == jc.load_tenant(t, jtabs[t])
        st.load_tenant(t, ptabs[t])
    rng = np.random.default_rng(8)
    parts, tags = [], []
    for t in range(ARENA_TENANTS):
        b, _ = testing.flow_trace_batch(rng, ptabs[t], 96, 0.0)
        parts.append(b)
        tags.append(np.full(96, t, np.int32))
    from infw_torch.packets import concat
    pool = concat(parts)
    ptag = np.concatenate(tags)
    ptag[:6], ptag[-6:] = -1, ARENA_MAX + 3
    flows = pool.pack_wire()

    def chunk(k):
        idx = np.random.default_rng(k).integers(0, len(pool), 256)
        return flows[idx], ptag[idx], pool.tcp_flags[idx]

    def both(step, k):
        wire, ten, fl = chunk(k)
        got = pc.classify_async_packed_tenant(wire, ten, tcp_flags=fl).result()
        want = jc.classify_async_packed_tenant(wire, ten, tcp_flags=fl).result()
        _outputs_equal(got, want, step)
        _outputs_equal(got, st.classify_async_packed_tenant(wire, ten).result(), f"{step} st")
        assert not got.results[(ten < 0) | (ten >= ARENA_MAX)].any()
        assert pc.flow_counters() == jc.flow_counters(), step
        assert pc.tenant_counters() == jc.tenant_counters(), step
        _columns_equal(pc.flow.flow_columns(), jc.flow.flow_columns(), step)

    for k in range(3):
        both("loaded", k)
    assert pc.flow_counters()["flow_hits_total"] > 0
    for c in (pc, st):
        c.swap_tenant(2, ptabs[4])
    jc.swap_tenant(2, jtabs[4])
    both("swapped", 3)
    page = pc.stage_tenant(ptabs[5])
    assert page == jc.stage_tenant(jtabs[5]) == st.stage_tenant(ptabs[5])
    for c, tabs in ((pc, ptabs), (jc, jtabs), (st, ptabs)):
        c.activate_tenant(3, page, tabs[5])
    both("activated", 4)
    for c in (pc, jc, st):
        c.destroy_tenant(1)
    both("destroyed", 5)
    assert pc.compact() == jc.compact() == st.compact()
    both("compacted", 6)
    both("again", 6)
    assert pc.flow_counters()["flow_invalidations_total"] >= 5


def test_arena_flow_tenant_ids_never_wrap():
    """An id outside int32 (2^32 + 1) becomes -1 before the cast on the
    flow path too: its lanes are ineligible, UNDEF and uncounted.  The JAX
    arena casts it to tenant 1 and serves tenant 1's verdict (a deliberate
    difference, ROADMAP.md section 3)."""
    jtabs, ptabs = _arena_tables(jax_testing, "ctrie"), _arena_tables(testing, "ctrie")
    kw = {"pages": ARENA_PAGES, "max_tenants": ARENA_MAX}
    js = jaxpath.arena_spec_for("ctrie", list(jtabs.values()), **kw)
    ps = arena.arena_spec_for("ctrie", list(ptabs.values()), **kw)
    jc = ArenaClassifier(js, interpret=True, fused_deep=True, flow_table=64)
    pc = TorchArenaClassifier(ps, device="cpu", flow_table=64)
    for t in range(2):
        pc.load_tenant(t, ptabs[t])
        jc.load_tenant(t, jtabs[t])
    b, _ = testing.flow_trace_batch(np.random.default_rng(2), ptabs[1], 128, 0.0)
    wire = b.pack_wire()
    ten = np.full(128, (1 << 32) + 1, np.int64)
    got = pc.classify_async_packed_tenant(wire, ten).result()
    assert not got.results.any() and not got.stats_delta.any()
    assert pc.flow_counters()["flow_inserts_total"] == 0
    assert not any(k.startswith("tenant_1_") for k in pc.tenant_counters())
    want = jc.classify_async_packed_tenant(wire, ten).result()
    right = pc.classify_async_packed_tenant(wire, np.ones(128, np.int64)).result()
    np.testing.assert_array_equal(np.asarray(want.results), right.results)
    assert right.results.any()


def test_arena_overlay_change_invalidates_the_tenant():
    """Installing a tenant's overlay bumps its generation, so no verdict
    cached before it is served after it (the JAX arena bumps nothing
    there; ROADMAP.md section 3)."""
    ptabs = _arena_tables(testing, "dense")
    ps = arena.arena_spec_for("dense", list(ptabs.values()), pages=4, max_tenants=4)
    ov_spec = arena.make_arena_spec("dense", 4, 4, 64, 4)
    pc = TorchArenaClassifier(ps, device="cpu", overlay_spec=ov_spec, flow_table=64)
    pc.load_tenant(0, ptabs[0])
    b, _ = testing.flow_trace_batch(np.random.default_rng(5), ptabs[0], 128, 0.0)
    wire, ten = b.pack_wire(), np.zeros(128, np.int32)
    pc.classify_async_packed_tenant(wire, ten).result()
    inv = pc.flow_counters()["flow_invalidations_total"]
    pc.load_tenant_overlay(0, ptabs[1])
    assert pc.flow_counters()["flow_invalidations_total"] == inv + 1
    got = pc.classify_async_packed_tenant(wire, ten).result()
    st = TorchArenaClassifier(ps, device="cpu", overlay_spec=ov_spec)
    st.load_tenant(0, ptabs[0])
    st.load_tenant_overlay(0, ptabs[1])
    _outputs_equal(got, st.classify_async_packed_tenant(wire, ten).result())


# --- (f) the two daemons --------------------------------------------------------


@pytest.mark.parametrize("path", ["dense", "trie", "ctrie", "ctrie_unpinned"])
def test_daemons_agree_under_a_flow_table(tmp_path, monkeypatch, path):
    """Both daemons with a 256-entry flow table (so inserts evict), the
    same frames files of a 90%-established flow trace dropped twice: equal out files, statistics, events
    (flow-evict lines included) and /metrics (flow_* included), and the
    out files of the second pass equal the first's.  On the ctrie path the
    JAX daemon splits IPv6 jobs by depth class and the port does not (a
    deliberate difference, ROADMAP.md section 3), which reorders the jobs:
    with the JAX classifier's v6_depth_groups pinned to one group (in this
    test only) everything is equal; unpinned, the out files and statistics
    are, and the flow counters differ only in how the packets split between
    hits and misses (the JAX jobs' padding rows are probed too) and what the
    inserts evicted."""
    unpinned = path == "ctrie_unpinned"
    path = path.split("_")[0]
    if path == "ctrie" and not unpinned:
        monkeypatch.setattr(TpuClassifier, "v6_depth_groups",
                            lambda self, ifindex, ip_words, idx: [((None, 0), idx)])
    n_cidrs, compressed = tdaemon.PATHS[path]
    jreg, preg = tdaemon._registries()
    common = dict(node_name=tdaemon.NODE, poll_period_s=3600.0, metrics_port=0, health_port=0,
                  file_poll_interval_s=60.0, ingest_chunk=tdaemon.CHUNK, pipeline_depth=3,
                  compressed=compressed)
    jd = jax_daemon.Daemon(state_dir=str(tmp_path / "jax"), backend="tpu", registry=jreg,
                           flow_table=jax_flow.FlowConfig.make(entries=256), **common)
    pd = tdaemon.daemon.Daemon(state_dir=str(tmp_path / "port"), backend="cpu", registry=preg,
                               flow_table=flow.FlowConfig.make(entries=256), **common)
    try:
        doc = tdaemon._nodestate(n_cidrs)
        for d in (jd, pd):
            tdaemon._write_state(d, doc)
            d.scan_nodestates_once()
        jclf, pclf = jd.syncer.classifier, pd.syncer.classifier
        assert pclf.flow is not None and jclf.flow is not None
        trace, _ = testing.flow_trace_batch(np.random.default_rng(2), tdaemon._compile(doc),
                                            sum(tdaemon.FILE_SIZES), 0.9,
                                            chunk_packets=tdaemon.CHUNK)
        fbs, start = [], 0
        for n in tdaemon.FILE_SIZES:
            sub = trace.slice(start, start + n)
            fb = tdaemon.pcap.build_frames_bulk(sub.kind, sub.ip_words, sub.proto, sub.dst_port,
                                                sub.icmp_type, sub.icmp_code, l4_ok=sub.l4_ok)
            fb.ifindex = np.asarray(sub.ifindex, np.uint32)
            fbs.append(fb)
            start += n
        outs = []
        for rnd in range(2):
            for d in (jd, pd):
                tdaemon._drop(d, fbs)
                d._flow_maintenance()
            assert jd.process_ingest_once() == pd.process_ingest_once()
            jout, pout = tdaemon._out_files(jd), tdaemon._out_files(pd)
            assert pout == jout, rnd
            outs.append(pout)
        assert outs[0] == outs[1]
        if unpinned:
            np.testing.assert_array_equal(pclf.stats.snapshot(), jclf.stats.snapshot())
            pc, jc = pclf.flow_counters(), jclf.flow_counters()
            # every packet is probed once a pass, with its job's padding
            # rows; the JAX daemon's depth-class jobs have more of those
            probed = 2 * sum(tdaemon.FILE_SIZES)
            assert probed <= pc["flow_hits_total"] + pc["flow_misses_total"] <= \
                jc["flow_hits_total"] + jc["flow_misses_total"]
            for k in ("flow_invalidations_total", "flow_capacity", "flow_aged_total"):
                assert pc[k] == jc[k], k
            assert pc["flow_hits_total"] > 0 and jc["flow_hits_total"] > 0
            return
        assert pclf.flow_counters() == jclf.flow_counters()
        assert pclf.flow_counters()["flow_hits_total"] > 0
        assert pclf.flow_counters()["flow_evictions_total"] > 0
        np.testing.assert_array_equal(pclf.stats.snapshot(), jclf.stats.snapshot())
        jev, pev = tdaemon._events(jd), tdaemon._events(pd)
        assert pev == jev and "flow-evict:" in pev[0]
        ptext = tdaemon._metrics(pd, pclf, _threads.reset_crash_counters)
        jtext = tdaemon._metrics(jd, jclf, jax_threads.reset_crash_counters)
        assert ptext == jtext and "flow_hits_total" in ptext
    finally:
        tdaemon._stop(jd, pd)


# --- (g) the trace generator -----------------------------------------------------


@pytest.mark.parametrize("established", [0.0, 0.5, 0.9, 0.99])
def test_flow_trace_batch_is_byte_identical(established):
    jt = jax_testing.random_tables_fast(np.random.default_rng(1), 300, width=4)
    pt = testing.random_tables_fast(np.random.default_rng(1), 300, width=4)
    jb, jm = jax_testing.flow_trace_batch(np.random.default_rng(7700), jt, 5000, established)
    pb, pm = testing.flow_trace_batch(np.random.default_rng(7700), pt, 5000, established)
    assert pm == jm
    for f in ("kind", "l4_ok", "ifindex", "ip_words", "proto", "dst_port", "icmp_type",
              "icmp_code", "pkt_len", "tcp_flags"):
        a, b = getattr(pb, f), getattr(jb, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    with pytest.raises(ValueError):
        testing.flow_trace_batch(np.random.default_rng(0), pt, 10, 1.0)


# --- chip_smoke.py's flow checks, on the CPU -------------------------------------


@pytest.mark.parametrize("width,ways", [(4, 1), (7, 4), (7, 8)])
def test_chip_smoke_flow_bound_counts_only_what_the_function_moves(width, ways):
    """chip_smoke.py's flow_bytes against a count taken from the columns:
    each lane reads its wire, tenant, flags (the insert also its verdict),
    page and generation and W candidate rows (the probe keys, se and vg;
    the insert keys and se); the probe writes a 2-byte result, the bitmap
    and two counts, reads and writes each hit lane's cnt row and writes
    its se row; the insert writes each winner's four rows and four
    counts.  No kernel scratch is counted."""
    import chip_smoke

    ft = kflow.empty_flow_table(64, "cpu")
    row = {k: getattr(ft, k).shape[1] * getattr(ft, k).element_size() for k in kflow.COLUMNS}
    B, hits, inserts = 4096, 1234, 321
    lane = width * 4 + 4 + 4 + 4 + 4  # wire, tenant, flags, page, generation
    probe = (B * (lane + ways * (row["keys"] + row["se"] + row["vg"]) + 2) + (B // 32) * 4
             + 2 * 4 + hits * (2 * row["cnt"] + row["se"]))
    insert = (B * (lane + 4 + ways * (row["keys"] + row["se"]))
              + inserts * sum(row.values()) + 4 * 4)
    assert chip_smoke.flow_bytes("probe", width, B, ways, hits=hits) == probe
    assert chip_smoke.flow_bytes("insert", width, B, ways, inserts=inserts) == insert


def test_chip_smoke_holds_the_arena_flow_kernels_against_their_plain_versions(monkeypatch):
    """chip_smoke.py's flow_kernels_held replays every K7 and K8 call of an
    arena flow classify by the plain versions with the same arguments,
    counts the calls, fails on a kernel that disagrees in a column, and
    puts the module's functions back on the way out."""
    import chip_smoke

    ptabs = _arena_tables(testing, "dense")
    ps = arena.arena_spec_for("dense", list(ptabs.values()), pages=ARENA_PAGES,
                              max_tenants=ARENA_MAX)
    pc = TorchArenaClassifier(ps, device="cpu", flow_table=64)
    for t in range(2):
        pc.load_tenant(t, ptabs[t])
    b, _ = testing.flow_trace_batch(np.random.default_rng(3), ptabs[1], 256, 0.5,
                                    chunk_packets=128)
    wire = b.pack_wire()
    ten = np.where(np.arange(256) % 7 == 0, -1, np.arange(256) % 2).astype(np.int32)
    probe, insert = kflow.flow_probe, kflow.flow_insert
    held = {}
    for _ in range(2):
        with chip_smoke.flow_kernels_held(kflow, "arena", held):
            pc.classify_async_packed_tenant(wire, ten, tcp_flags=b.tcp_flags).result()
    assert held == {"flow_probe": 2, "flow_insert": 2}
    assert (kflow.flow_probe, kflow.flow_insert) == (probe, insert)

    def bent(table, *args, **kw):  # a kernel whose cnt column drifts
        out = insert(table, *args, **kw)
        table.cnt[0, 0] += 1
        return out

    monkeypatch.setattr(kflow, "flow_insert", bent)
    with pytest.raises(SystemExit, match="flow_insert call 0 disagrees"):
        with chip_smoke.flow_kernels_held(kflow, "arena", {}):
            pc.classify_async_packed_tenant(wire, ten, tcp_flags=b.tcp_flags).result()
    assert kflow.flow_insert is bent
