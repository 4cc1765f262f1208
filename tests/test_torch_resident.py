"""The port's resident serving (kernels/resident.py, infw_torch/resident.py,
FlowTier.resident_*, the classifier's and the daemon's --resident) on the
CPU against the JAX package's (jaxpath.jitted_resident_step and
jitted_resident_superbatch, infw/resident.py, TpuClassifier(resident=True)
in interpret mode), bit for bit, with no tolerance: the step's fused words,
the four flow columns and the epoch over two passes on the dense, trie and
ctrie paths, IPv4-only and with an overlay; the classifiers chunk by chunk
(results, verdicts, statistics, flow and resident_* counters); the
superbatch; back-to-back unread outputs and the model's replay in epoch
order; a patch between dispatches; wide ruleIds; and both daemons.

One flow geometry (512 entries, 4 ways) and 64-packet chunks throughout,
as the JAX package's resident tests use, so its jit caches are shared."""
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import infw._threads as jax_threads
import infw.daemon as jax_daemon
from infw import flow as jax_flow
from infw import testing as jax_testing
from infw.backend.tpu import TpuClassifier
from infw.kernels import jaxpath
from infw_torch import _threads, daemon, flow, oracle, testing
from infw_torch.backend.cuda import TorchClassifier
from infw_torch.compiler import IncrementalTables
from infw_torch.constants import IPPROTO_TCP
from infw_torch.kernels import flow as kflow
from infw_torch.kernels.resident import resident_out_words, resident_step, split_resident_outputs
from infw_torch.layout import v4_trie_depth

import test_torch_daemon as tdaemon
from test_torch_flow import _columns_equal, _jax_batch, _outputs_equal
from test_torch_overlay import _overlay_content, _pair

ENTRIES = 512
B = 64


def _classifiers(path, jtab, ptab, jov=None, pov=None, **pkw):
    """(JAX, port) resident classifiers with the module's flow geometry."""
    fp = None if path == "dense" else path
    jc = TpuClassifier(interpret=True, force_path=fp, resident=True,
                       flow_table=jax_flow.FlowConfig.make(entries=ENTRIES))
    pc = TorchClassifier(device="cpu", force_path=fp, resident=True,
                         flow_table=flow.FlowConfig.make(entries=ENTRIES), **pkw)
    jc.load_tables(jtab, overlay=jov)
    pc.load_tables(ptab, overlay=pov)
    assert pc.active_path == path == jc._active[0]
    return jc, pc


@pytest.fixture(scope="module")
def tabs():
    """A 300-entry table (40% IPv6) on both sides, a 64-packet flow trace
    over it (flags, 70% established) and an 8-key overlay over its
    sources."""
    jt0 = jax_testing.random_tables(np.random.default_rng(30), n_entries=300, width=4,
                                    v6_fraction=0.4, ifindexes=(2, 3))
    main = {tuple(k): np.array(v) for k, v in jt0.content.items()}
    jt, pt = _pair(main)
    trace, _ = testing.flow_trace_batch(np.random.default_rng(17), pt, 4 * B, 0.7,
                                        chunk_packets=B)
    jov, pov = _pair(_overlay_content(trace, main, n=8))
    return {"jt": jt, "pt": pt, "trace": trace, "jov": jov, "pov": pov}


# --- the step against jitted_resident_step ----------------------------------------

VARIANTS = {  # path, IPv4-only (4-word wire), overlay
    "dense": ("dense", False, False),
    "trie": ("trie", False, False),
    "trie_v4": ("trie", True, False),
    "ctrie": ("ctrie", False, False),
    "trie_overlay": ("trie", False, True),
    "ctrie_overlay": ("ctrie", False, True),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_step_matches_jax_resident_step(tabs, variant):
    """resident_step against jaxpath.jitted_resident_step on the same table
    snapshot, from empty columns and epoch 5, over two passes of one chunk
    (populate, then serve from the cache): equal fused words, columns and
    epoch after each pass."""
    path, v4, ov = VARIANTS[variant]
    jc, pc = _classifiers(path, tabs["jt"], tabs["pt"], *((tabs["jov"], tabs["pov"]) if ov
                                                           else ()))
    jctx, pctx = jc._resident.context(jc), pc._resident.context(pc)
    sub = tabs["trace"]
    if v4:
        sub = sub.take(np.nonzero(sub.kind == 1)[0][:B])
        wire = sub.pack_wire_v4()
    else:
        sub = sub.slice(0, B)
        wire = sub.pack_wire()
    assert wire.shape == (B, 4 if v4 else 7)
    tflags = np.asarray(sub.tcp_flags, np.int32)
    tenant = np.zeros(B, np.int32)
    fn = jaxpath.jitted_resident_step(ENTRIES, 4, path, v4, None, jctx.d_max, ov)
    targs = (jctx.tdev, jctx.ov_dev) if ov else (jctx.tdev,)
    jflow = jaxpath.FlowTable(keys=jnp.zeros((ENTRIES, 8), jnp.uint32),
                              vg=jnp.zeros((ENTRIES, 2), jnp.int32),
                              se=jnp.zeros((ENTRIES, 2), jnp.int32),
                              cnt=jnp.zeros((ENTRIES, 3), jnp.int32))
    jepoch = jnp.int32(5)
    zero = jnp.zeros(1, jnp.int32)
    pflow = kflow.empty_flow_table(ENTRIES, "cpu")
    pepoch = torch.tensor([5], dtype=torch.int32)
    pzero = torch.zeros(1, dtype=torch.int32)
    ops = flow.ResidentOps(pflow, pzero, pzero.clone(), pepoch, torch.from_numpy(tenant),
                           torch.from_numpy(tflags), flow.FlowConfig().max_age, ENTRIES, 4)
    n_levels = None
    if path == "trie":
        n = pctx.tables.dev.n_levels
        n_levels = v4_trie_depth(n) if v4 else n
    tables = pctx.tables._replace(n_levels=n_levels)
    for p in range(2):
        jflow, jepoch, jfused = fn(jflow, zero, zero, jepoch, *targs, jnp.asarray(wire),
                                   jnp.asarray(tenant), jnp.asarray(tflags),
                                   jnp.int32(flow.FlowConfig().max_age))
        pfused = resident_step(ops, tables, torch.from_numpy(wire.view(np.int32)))
        want = np.asarray(jfused).view(np.int32)
        assert pfused.shape[0] == resident_out_words(B) == want.shape[0]
        np.testing.assert_array_equal(pfused.numpy(), want, err_msg=f"{variant} pass {p}")
        _columns_equal({k: getattr(pflow, k).numpy() for k in kflow.COLUMNS},
                       {k: np.asarray(getattr(jflow, k)) for k in kflow.COLUMNS},
                       f"{variant} pass {p}")
        assert int(pepoch[0]) == int(jepoch) == 6 + p
        assert torch.equal(pflow.winner, torch.full((ENTRIES,), -1, dtype=torch.int32))
    _res, hit, hits, _stale, counts = split_resident_outputs(pfused.numpy(), B)
    assert hits == int(hit.sum()) > 0 and counts[0] < B  # the second pass served


def test_resident_entries_match_their_parts():
    """K7's resident entry equals flow_probe_plain at the device epoch + 1
    without writing the epoch; K8's equals the merge plus flow_insert_plain
    with lane_ok = ~hit, and advances the epoch; a case from every name of
    testing.FLOW_KERNEL_CASES, the 4- and 7-word wires."""
    for name in testing.FLOW_KERNEL_CASES:
        if name == "lanes_beyond_grid":
            continue  # 300K lanes: the card tests run it
        for width in (4, 7):
            case = testing.flow_kernel_case(name, width, seed=5)
            put = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())  # noqa: E731
            cols = {k: put(case[k]) for k in kflow.COLUMNS}
            C = cols["se"].shape[0]
            mk = lambda: kflow.FlowTable(**{k: v.clone() for k, v in cols.items()},  # noqa: E731
                                         winner=torch.full((C,), -1, dtype=torch.int32))
            got, want = mk(), mk()
            gens, pages = put(case["gens"]), put(case["page_table"])
            wire, tenant, tflags, epoch = case["probe"]
            verdict = case["insert"][3]
            w, t, f = put(wire.astype(np.uint32)), put(tenant), put(tflags)
            geo = {"slab_entries": case["entries"], "ways": case["ways"]}
            Bn = wire.shape[0]
            nw, nh = (Bn + 1) // 2, -(-Bn // 32)
            epoch_dev = torch.tensor([flow.wrap_epoch(epoch - 1)], dtype=torch.int32)
            out = torch.full((resident_out_words(Bn),), -7, dtype=torch.int32)
            kflow.flow_probe_resident(got, gens, pages, w, t, f, epoch_dev, case["max_age"],
                                      out, **geo)
            ref = kflow.flow_probe_plain(want, gens, pages, w, t, f, epoch, case["max_age"], **geo)
            assert torch.equal(out[: nw + nh + 2], ref) and int(epoch_dev[0]) == flow.wrap_epoch(
                epoch - 1)
            v16 = put(np.asarray(verdict, np.uint32) & 0xFFFF)
            packed = kflow._pack_res16(v16)
            kflow.flow_insert_resident(got, gens, pages, w, t, f, packed, out[nw: nw + nh],
                                       out[:nw], out[nw + nh + 2:], epoch_dev, **geo)
            hit = kflow.unpack_bits32(ref[nw: nw + nh], Bn)
            served = kflow.unpack_res16(ref[:nw], Bn)
            c = kflow.flow_insert_plain(want, gens, pages, w, t, f, v16, epoch, lane_ok=~hit,
                                        **geo)
            label = f"{name} w{width}"
            assert torch.equal(out[:nw], kflow._pack_res16(torch.where(hit, served, v16.long()))), label
            assert torch.equal(out[nw + nh + 2:], c), label
            assert int(epoch_dev[0]) == flow.wrap_epoch(epoch), label
            for k in kflow.FlowTable._fields:
                assert torch.equal(getattr(got, k), getattr(want, k)), (label, k)


def test_host_model_lane_ok_matches_jax():
    """HostFlowModel.insert's lane_ok against the JAX model's, from the same
    columns."""
    case = testing.flow_kernel_case("duplicate_keys", 7, seed=2)
    cfg = flow.FlowConfig.make(entries=case["entries"], pages=case["pages"], ways=case["ways"])
    pm, jm = flow.HostFlowModel(cfg), jax_flow.HostFlowModel(jax_flow.FlowConfig.make(
        entries=case["entries"], pages=case["pages"], ways=case["ways"]))
    for m in (pm, jm):
        for k in ("keys", "vg", "se", "cnt", "gens", "page_table"):
            getattr(m, k)[:] = case[k]
    wire, tenant, tflags, verdict, epoch = case["insert"]
    lane_ok = np.random.default_rng(1).random(wire.shape[0]) < 0.5
    assert (pm.insert(wire, tenant, tflags, verdict, epoch, lane_ok=lane_ok)
            == jm.insert(wire, tenant, tflags, verdict, epoch, lane_ok=lane_ok))
    _columns_equal(pm.columns(), jm.columns())


# --- the classifiers ----------------------------------------------------------------


@pytest.mark.parametrize("path", ["dense", "trie", "ctrie"])
def test_classifier_matches_tpu_classifier(tabs, path):
    """TorchClassifier(resident=True, device="cpu") against
    TpuClassifier(resident=True, interpret=True), chunk by chunk: four
    64-packet flow-trace chunks through classify (7-word), then an IPv4-only
    chunk through classify_async_packed (4-word, flags): equal results,
    verdicts, statistics, flow and resident_* counters, columns, epochs and
    wire_stats."""
    jc, pc = _classifiers(path, tabs["jt"], tabs["pt"])
    trace = tabs["trace"]
    for k in range(4):
        sub = trace.slice(B * k, B * (k + 1))
        _outputs_equal(pc.classify(sub), jc.classify(_jax_batch(sub)), f"chunk {k}")
        assert pc.flow_counters() == jc.flow_counters(), k
    v4 = trace.take(np.nonzero(trace.kind == 1)[0][:B])
    wire, is_v4 = v4.pack_wire_subset(np.arange(B))
    assert wire.shape == (B, 4) and is_v4
    got = pc.classify_async_packed(wire, True, tcp_flags=v4.tcp_flags).result()
    want = jc.classify_async_packed(wire, True, tcp_flags=v4.tcp_flags).result()
    _outputs_equal(got, want, "v4 chunk")
    assert pc.flow_counters() == jc.flow_counters()
    assert pc.flow_counters()["flow_hits_total"] > 0
    _columns_equal(pc.flow.flow_columns(), jc.flow.flow_columns())
    assert pc.flow.epoch == jc.flow._epoch == int(pc.flow._epoch_dev[0]) == int(
        np.asarray(jc.flow._epoch_dev)) == 5
    pr, jr = pc.resident_counters(), jc.resident_counters()
    if path == "dense":
        # the JAX pool builds an XLA twin of a dense table per generation
        # (one more allocation); the port's step serves K1's own tables
        assert jr["resident_allocs_total"] == pr["resident_allocs_total"] + 1
        pr = {k: v for k, v in pr.items() if "allocs" not in k}
        jr = {k: v for k, v in jr.items() if "allocs" not in k}
    assert pr == jr and pr["resident_dispatches_total"] == 5
    assert pc.wire_stats() == jc.wire_stats()
    np.testing.assert_array_equal(pc.stats.snapshot(), jc.stats.snapshot())


def test_superbatch_matches_jax_and_single_dispatches(tabs):
    """prepare_packed_super with K = 4 (the dense path): each row equals the
    JAX superbatch's, and the columns, counters and epoch equal it; then
    the port's trie-path superbatch equals four single resident dispatches
    (outputs, columns, epochs)."""
    jc, pc = _classifiers("dense", tabs["jt"], tabs["pt"])
    trace = tabs["trace"]
    stack = np.stack([trace.slice(B * j, B * (j + 1)).pack_wire() for j in range(4)])
    flags = np.asarray(trace.tcp_flags, np.int32).reshape(4, B)
    for rnd in range(2):
        jp, pp = jc.prepare_packed_super(stack, False, flags), pc.prepare_packed_super(stack, False,
                                                                                      flags)
        jout, pout = jc.classify_prepared_super(jp), pc.classify_prepared_super(pp)
        for j in (2, 0, 3, 1):  # read out of order
            _outputs_equal(pout[j].result(), jout[j].result(), f"round {rnd} row {j}")
    _columns_equal(pc.flow.flow_columns(), jc.flow.flow_columns())
    assert pc.flow_counters() == jc.flow_counters()
    assert pc.flow.epoch == jc.flow._epoch == 8
    pr, jr = pc.resident_counters(), jc.resident_counters()
    assert pr["resident_superbatch_admissions_total"] == jr[
        "resident_superbatch_admissions_total"] == 8
    assert pr["resident_superbatch_dispatches_total"] == jr[
        "resident_superbatch_dispatches_total"] == 2

    sup = TorchClassifier(device="cpu", force_path="trie", resident=True, flow_table=ENTRIES)
    one = TorchClassifier(device="cpu", force_path="trie", resident=True, flow_table=ENTRIES)
    for c in (sup, one):
        c.load_tables(tabs["pt"])
    for rnd in range(2):
        rows = sup.classify_prepared_super(sup.prepare_packed_super(stack, False, flags))
        for j in range(4):
            want = one.classify_prepared(one.prepare_packed(stack[j], False,
                                                            tcp_flags=flags[j])).result()
            _outputs_equal(rows[j].result(), want, f"trie round {rnd} row {j}")
    _columns_equal(sup.flow.flow_columns(), one.flow.flow_columns())
    assert sup.flow.epoch == one.flow.epoch == int(sup.flow._epoch_dev[0]) == 8
    assert sup.flow_counters() == one.flow_counters()


def test_back_to_back_unread_outputs_and_the_model(tabs):
    """Six plans dispatched back to back, read in the order 3, 0, 5, 1, 4,
    2: each equals the oracle, and the tracked host model, replayed in
    epoch order under lane_ok, ends equal to the device columns and to a
    multi-dispatch flow classifier's model and columns."""
    pc = TorchClassifier(device="cpu", force_path="trie", resident=True, flow_table=ENTRIES,
                         flow_track_model=True)
    multi = TorchClassifier(device="cpu", force_path="trie", flow_table=ENTRIES,
                            flow_track_model=True)
    for c in (pc, multi):
        c.load_tables(tabs["pt"])
    trace = tabs["trace"]
    chunks = [trace.slice(32 * j, 32 * (j + 1)) for j in range(6)]
    plans = [pc.prepare_packed(c.pack_wire(), False, tcp_flags=c.tcp_flags) for c in chunks]
    assert len(pc.flow._mirror_q) == 6
    for i in (3, 0, 5, 1, 4, 2):
        out = pc.classify_prepared(plans[i], apply_stats=False).result()
        want = oracle.classify(tabs["pt"], chunks[i])
        np.testing.assert_array_equal(out.results, want.results, err_msg=f"plan {i}")
        np.testing.assert_array_equal(out.xdp, want.xdp)
        # reading plan i replays every dispatch up to its epoch
        assert all(ep > i + 1 for ep, *_ in pc.flow._mirror_q)
    for c in chunks:
        multi.classify_prepared(multi.prepare_packed(c.pack_wire(), False,
                                                     tcp_flags=c.tcp_flags)).result()
    cols = pc.flow.flow_columns()
    _columns_equal(cols, pc.flow.model.columns(), "model")
    _columns_equal(cols, multi.flow.flow_columns(), "multi-dispatch")
    _columns_equal(cols, multi.flow.model.columns(), "multi-dispatch model")
    assert pc.flow_counters() == multi.flow_counters()


def test_a_patch_between_dispatches_serves_the_new_tables(tabs):
    """A hinted load between dispatches: the next dispatch serves the new
    tables (a new context; the cached verdicts are stale by generation)."""
    pc = TorchClassifier(device="cpu", force_path="trie", resident=True, flow_table=ENTRIES)
    pc.load_tables(tabs["pt"])
    batch = tabs["trace"].slice(0, B)
    for _ in range(2):
        pc.classify(batch)
    assert pc.flow_counters()["flow_hits_total"] > 0
    inc = IncrementalTables.from_content(dict(tabs["pt"].content), rule_width=4)
    inc.apply({}, list(tabs["pt"].content)[::2])
    snap = inc.snapshot()
    pc.load_tables(snap, dirty_hint=inc.peek_dirty())
    out = pc.classify(batch)
    want = oracle.classify(snap, batch)
    assert not np.array_equal(want.results, oracle.classify(tabs["pt"], batch).results)
    np.testing.assert_array_equal(out.results, want.results)
    np.testing.assert_array_equal(out.xdp, want.xdp)
    assert pc.flow_counters()["flow_stale_rejects_total"] > 0
    assert pc.resident_counters()["resident_allocs_total"] >= 2  # one context per generation


def test_wide_ruleids_fall_back(tabs):
    """Wide ruleIds: classify serves the full-batch path on both packages
    with equal results; prepare_packed counts a resident fallback and
    raises, on both, and the resident_* counters are equal."""
    content = dict(tabs["pt"].content)
    k = next(iter(content))
    rows = np.zeros((4, 7), np.int32)
    rows[1] = [70001, IPPROTO_TCP, 443, 0, 0, 0, 1]
    content[k] = rows
    jtab, ptab = _pair({tuple(key): np.array(v) for key, v in content.items()})
    jc, pc = _classifiers("trie", jtab, ptab)
    batch = testing.random_batch_fast(np.random.default_rng(3), ptab, B)
    _outputs_equal(pc.classify(batch), jc.classify(_jax_batch_plain(batch)))
    np.testing.assert_array_equal(pc.classify(batch).results, oracle.classify(ptab, batch).results)
    wire = batch.pack_wire()
    for c in (pc, jc):
        with pytest.raises(RuntimeError, match="wide-ruleId"):
            c.prepare_packed(wire, False)
    assert pc.resident_counters() == jc.resident_counters()
    assert pc.resident_counters()["resident_fallbacks_total"] == 1


def _jax_batch_plain(pb):
    from infw import packets as jax_packets

    return jax_packets.PacketBatch(**{f: np.array(getattr(pb, f)) for f in (
        "kind", "l4_ok", "ifindex", "ip_words", "proto", "dst_port", "icmp_type", "icmp_code",
        "pkt_len")})


def test_resident_without_a_card_and_its_switches(monkeypatch):
    """resident=True implies a default flow tier and needs a card unless
    the CPU is named; INFW_RESIDENT turns it on and "0" off."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TorchClassifier(resident=True)
    c = TorchClassifier(device="cpu", resident=True)
    assert c.flow.config == flow.FlowConfig.make() and c.resident is not None
    monkeypatch.setenv("INFW_RESIDENT", "1")
    assert TorchClassifier(device="cpu").resident is not None
    monkeypatch.setenv("INFW_RESIDENT", "0")
    assert TorchClassifier(device="cpu").resident is None
    assert TorchClassifier(device="cpu").resident_counters() == {}


def test_mark_warm_seeds_the_epoch_and_counts_no_steady_allocation(tabs):
    """A classic probe moves the host epoch only; mark_resident_warm
    re-seeds the device epoch, and the warmed dispatches allocate nothing
    (steady_allocs 0), as the JAX pool's gate asserts."""
    pc = TorchClassifier(device="cpu", force_path="trie", resident=True, flow_table=ENTRIES)
    pc.load_tables(tabs["pt"])
    sub = tabs["trace"].slice(0, B)
    pc.classify(sub)
    pc.flow.warm([B])  # classic probes and inserts of inert rows
    assert pc.flow.epoch != pc.flow._epoch_dev_val
    pc.mark_resident_warm()
    assert int(pc.flow._epoch_dev[0]) == pc.flow.epoch
    for _ in range(3):
        pc.classify(sub)
    assert pc.resident.steady_allocs() == 0
    assert pc.resident_counters()["resident_pool_warm"] == 1


# --- the daemons ----------------------------------------------------------------------


class _SweepClock:
    """A daemon module's ``time`` with ``monotonic()`` fixed at ``now``: the
    flow-age sweep timer reads it, every other name is the real module's."""

    def __init__(self, now: float) -> None:
        self.now = now

    def monotonic(self) -> float:
        return self.now

    def __getattr__(self, name):
        return getattr(time, name)


def test_daemons_agree_under_resident(tmp_path):
    """Both daemons with resident serving and a 256-entry flow table (dense
    path), the same frames files of a 90%-established trace dropped twice:
    equal out files, statistics, events and /metrics (flow_* and
    resident_* included)."""
    jreg, preg = tdaemon._registries()
    common = dict(node_name=tdaemon.NODE, poll_period_s=3600.0, metrics_port=0, health_port=0,
                  file_poll_interval_s=60.0, ingest_chunk=tdaemon.CHUNK, pipeline_depth=3,
                  resident=True)
    jd = jax_daemon.Daemon(state_dir=str(tmp_path / "jax"), backend="tpu", registry=jreg,
                           flow_table=jax_flow.FlowConfig.make(entries=256), **common)
    pd = daemon.Daemon(state_dir=str(tmp_path / "port"), backend="cpu", registry=preg,
                       flow_table=flow.FlowConfig.make(entries=256), **common)
    try:
        doc = tdaemon._nodestate(tdaemon.PATHS["dense"][0])
        for d in (jd, pd):
            tdaemon._write_state(d, doc)
            d.scan_nodestates_once()
        jclf, pclf = jd.syncer.classifier, pd.syncer.classifier
        assert pclf.resident is not None and jclf.resident is not None
        sizes = (700, 90)
        trace, _ = testing.flow_trace_batch(np.random.default_rng(2), tdaemon._compile(doc),
                                            sum(sizes), 0.9, chunk_packets=tdaemon.CHUNK)
        fbs, start = [], 0
        for n in sizes:
            sub = trace.slice(start, start + n)
            fb = tdaemon.pcap.build_frames_bulk(sub.kind, sub.ip_words, sub.proto, sub.dst_port,
                                                sub.icmp_type, sub.icmp_code, l4_ok=sub.l4_ok)
            fb.ifindex = np.asarray(sub.ifindex, np.uint32)
            fbs.append(fb)
            start += n
        for rnd in range(2):
            for d, mod in ((jd, jax_daemon), (pd, daemon)):
                tdaemon._drop(d, fbs)
                # both daemons sweep on the same ticks: each module's clock
                # reads one fake through the maintenance call, 10 s apart
                with pytest.MonkeyPatch.context() as mp:
                    mp.setattr(mod, "time", _SweepClock(1000.0 + 10.0 * rnd))
                    d._flow_maintenance()
            assert jd.process_ingest_once() == pd.process_ingest_once()
            assert tdaemon._out_files(pd) == tdaemon._out_files(jd), rnd
        assert pclf.flow_counters() == jclf.flow_counters()
        assert pclf.flow_counters()["flow_hits_total"] > 0
        assert pclf.flow_counters()["flow_age_sweeps_total"] == 2  # one a round
        pr = pclf.resident_counters()
        assert pr["resident_dispatches_total"] > 0 and pr["resident_fallbacks_total"] == 0
        np.testing.assert_array_equal(pclf.stats.snapshot(), jclf.stats.snapshot())
        assert tdaemon._events(pd) == tdaemon._events(jd)
        ptext = tdaemon._metrics(pd, pclf, _threads.reset_crash_counters)
        jtext = tdaemon._metrics(jd, jclf, jax_threads.reset_crash_counters)
        # the JAX pool counts one more allocation per dense generation (its
        # XLA twin of the table)
        strip = lambda t: "\n".join(l for l in t.splitlines() if "resident_allocs" not in l  # noqa: E731
                                    and "resident_steady" not in l)
        assert strip(ptext) == strip(jtext)
        assert "resident_dispatches_total" in ptext and "flow_hits_total" in ptext
    finally:
        tdaemon._stop(jd, pd)


def test_daemon_resident_flags(tmp_path, monkeypatch):
    """--resident (or INFW_RESIDENT) reaches the daemon; with --backend cpu
    it is a usage error, as in the JAX daemon; --superbatch-k, which the
    ingest ring reads, is no longer refused and reaches the daemon."""
    for _f, e, _i in daemon.REFUSED_FLAGS:
        monkeypatch.delenv(e, raising=False)
    monkeypatch.delenv("INFW_RESIDENT", raising=False)
    argv = ["--state-dir", str(tmp_path / "s"), "--node-name", tdaemon.NODE]
    with pytest.raises(SystemExit) as e:
        daemon.main(argv + ["--backend", "cpu", "--resident"])
    assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        jax_daemon.main(argv + ["--backend", "cpu", "--resident"])
    assert e.value.code == 2
    seen = {}

    class Stub:
        def __init__(self, **kw):
            seen.update(kw)
            raise SystemExit(0)

    monkeypatch.setattr(daemon, "Daemon", Stub)
    for extra, env in ((["--resident"], None), ([], "1")):
        if env:
            monkeypatch.setenv("INFW_RESIDENT", env)
        with pytest.raises(SystemExit) as e:
            daemon.main(argv + ["--backend", "cuda"] + extra)
        assert e.value.code == 0 and seen["resident"] is True
    flags = {f: item for f, _e, item in daemon.REFUSED_FLAGS}
    assert "--resident" not in flags and "--superbatch-k" not in flags
    monkeypatch.delenv("INFW_RESIDENT", raising=False)
    with pytest.raises(SystemExit) as e:
        daemon.main(argv + ["--backend", "cuda", "--resident", "--superbatch-k", "4"])
    assert e.value.code == 0 and seen["superbatch_k"] == 4
    assert not (tmp_path / "s").exists()
