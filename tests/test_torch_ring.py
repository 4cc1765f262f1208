"""The ingest ring (infw_torch.ring), the daemon's ring ingest and the ring
producer (infw_torch.tools.loadgen) against the JAX package's.

- Records move both ways between the two rings (a JAX ring read by the
  port's consumer and the reverse) with equal wire, flags, payload,
  lengths and v4_only, and the two packages' ring files are equal byte for
  byte after the same pushes.
- One producer and one consumer: an uncommitted slot is not popped, a full
  ring blocks and times out, releases go in pop order, a corrupt record is
  skipped without freeing earlier slots, and the counters keep the JAX
  ring's keys and values; the pinned staging copy gives equal views.
- The port's daemon with ``ring=`` on the CPU against the JAX daemon
  (``backend="tpu"`` on the CPU) over the same records, K = 1 on the flow
  tier's multi-dispatch plan and K = 4 on the resident superbatch with a
  shape-class break: equal packets served, statistics, events, and flow_*,
  payload_* and ring_* lines on /metrics.
- ``--ring`` and ``--superbatch-k`` reach the daemon; the other refused
  flags name their own sub-items.
- The port's producer writes the same ring bytes as ``tools/loadgen.py``
  for the same arguments.
"""
import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

import infw.daemon as jax_daemon
from infw import ring as jring
from infw.flow import FlowConfig as JaxFlowConfig
from infw_torch import daemon, testing
from infw_torch import payload as ppay
from infw_torch import ring as pring
from infw_torch.flow import FlowConfig
from infw_torch.tools import loadgen

import test_torch_daemon as tdaemon

REPO = Path(__file__).resolve().parents[1]
RECORD = 64  # packets a record in the daemon tests
PATTERNS = ppay.signature_patterns(np.random.default_rng(11), 16, plen=64)


def _record(rng, n: int, width: int, flags: bool, plen: int):
    """A seeded record: wire (n, width), flags or None, payload or None."""
    wire = rng.integers(0, 1 << 32, (n, width), dtype=np.uint64).astype(np.uint32)
    fl = rng.integers(0, 64, n).astype(np.int32) if flags else None
    pay = rng.integers(0, 256, (n, plen), dtype=np.uint8) if plen else None
    lens = rng.integers(-2, plen + 3, n).astype(np.int32) if plen else None
    return wire, fl, pay, lens


# --- the format, both ways -----------------------------------------------------------------

@pytest.mark.parametrize("plen", [0, 64, 128])
@pytest.mark.parametrize("flags", [False, True])
@pytest.mark.parametrize("width", [4, 7])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_records_cross_between_the_two_rings(tmp_path, writer, width, flags, plen):
    """A record pushed by one package's producer pops, equal, from the
    other's consumer; the two packages' files are equal byte for byte."""
    rng = np.random.default_rng(width * 10 + plen + flags)
    recs = [_record(rng, n, width, flags, plen) for n in (1, 37, 200)]
    make = {"jax": jring.IngestRing, "port": pring.IngestRing}
    reader = "port" if writer == "jax" else "jax"
    files = {}
    for side in ("jax", "port"):
        path = str(tmp_path / f"{side}.ring")
        make[side if side == reader else writer].create(path, slots=4, slot_packets=256,
                                                         payload_width=plen)
        files[side] = path
    for side in ("jax", "port"):
        prod = make[writer].attach(files[side])
        for i, (w, fl, pay, lens) in enumerate(recs):
            prod.push(w, v4_only=bool(i & 1), tcp_flags=fl, payload=pay, payload_len=lens)
        prod.close()
    assert open(files["jax"], "rb").read() == open(files["port"], "rb").read()
    cons = make[reader].attach(files[reader])
    for i, (w, fl, pay, lens) in enumerate(recs):
        c = cons.pop(timeout=1.0)
        assert c is not None and c.seq == i and c.v4_only == bool(i & 1)
        assert np.array_equal(c.wire, w) and c.wire.dtype == np.uint32
        assert (c.tcp_flags is None) == (fl is None)
        if fl is not None:
            assert np.array_equal(c.tcp_flags, fl)
        assert (c.payload is None) == (pay is None)
        if pay is not None:
            assert np.array_equal(c.payload, pay) and np.array_equal(c.payload_len, lens)
        c.release()
    assert cons.pop() is None and cons.tail == cons.head == len(recs)
    cons.close()


def test_slot_bytes_and_capacity_match_jax():
    for args in [(4096,), (4096, 4, False), (1000, 7, True, 64), (4096, 7, True, 128)]:
        assert pring.slot_bytes_for(*args) == jring.slot_bytes_for(*args)
    assert pring.ring_path("/s") == jring.ring_path("/s")
    assert (pring.FLAG_V4_ONLY, pring.FLAG_TCP_FLAGS, pring.FLAG_PAYLOAD) == (
        jring.FLAG_V4_ONLY, jring.FLAG_TCP_FLAGS, jring.FLAG_PAYLOAD)


# --- one producer, one consumer ------------------------------------------------------------

@pytest.mark.parametrize("pkg", [jring, pring], ids=["jax", "port"])
def test_uncommitted_slot_is_not_popped(tmp_path, pkg):
    ring = pkg.IngestRing.create(str(tmp_path / "r"), slots=4, slot_packets=16)
    wv, fv, token = ring.reserve(8, 7, with_flags=True)
    wv[:] = 5
    fv[:] = 2
    assert ring.pop() is None and len(ring) == 0
    ring.commit(token, v4_only=True)
    c = ring.pop()
    assert c is not None and c.v4_only and (c.wire == 5).all() and (c.tcp_flags == 2).all()
    c.release()
    ring.close()


def test_full_ring_blocks_times_out_and_counts_like_jax(tmp_path):
    """Both rings: two records fill a two-slot ring, a third push times
    out, the producer's blocked time and waits count, the watermarks
    merge, and the counters carry the JAX ring's keys."""
    got = {}
    for name, pkg in (("jax", jring), ("port", pring)):
        ring = pkg.IngestRing.create(str(tmp_path / name), slots=2, slot_packets=8)
        w = np.zeros((4, 7), np.uint32)
        ring.push(w)
        ring.push(w)
        with pytest.raises(TimeoutError):
            ring.push(w, timeout=0.05)
        cv = ring.counter_values()
        assert cv["ring_blocked_us_total"] > 0 and cv["ring_blocked_waits_total"] > 0
        assert cv["ring_depth"] == cv["ring_depth_hwm"] == 2
        chunk = ring.pop(timeout=1.0)
        chunk.release()
        ring.push(w, timeout=1.0)  # the released slot takes the record
        cv = ring.counter_values()
        got[name] = {k: v for k, v in cv.items() if not k.startswith("ring_blocked")}
        ring.close()
    assert got["port"] == got["jax"]
    assert got["port"] == {"ring_pushed_total": 3, "ring_popped_total": 1, "ring_depth": 2,
                           "ring_depth_hwm": 2, "ring_slots": 2}


@pytest.mark.parametrize("pkg", [jring, pring], ids=["jax", "port"])
def test_releases_go_in_pop_order(tmp_path, pkg):
    ring = pkg.IngestRing.create(str(tmp_path / "r"), slots=4, slot_packets=8)
    for _ in range(3):
        ring.push(np.ones((2, 4), np.uint32))
    a, b = ring.pop(), ring.pop()
    with pytest.raises(RuntimeError, match="out-of-order"):
        b.release()
    a.release()
    assert ring.tail == 1
    b.release()  # the refused release gave the chunk up: nothing moves
    assert ring.tail == 1 and len(ring) == 2
    ring.close()


@pytest.mark.parametrize("pkg", [jring, pring], ids=["jax", "port"])
def test_corrupt_record_is_skipped_without_freeing_earlier_slots(tmp_path, pkg):
    ring = pkg.IngestRing.create(str(tmp_path / "r"), slots=4, slot_packets=8)
    for _ in range(3):
        ring.push(np.ones((2, 7), np.uint32))
    first = ring.pop()
    off = ring._slot_off(1)
    np.frombuffer(ring._mm, np.uint32, 1, off + 12)[0] = 5  # width 5
    with pytest.raises(ValueError, match="corrupt ring record at seq 1"):
        ring.pop()
    assert ring.tail == 0  # the skipped slot waits for seq 0's release
    third = ring.pop()
    assert third.seq == 2
    first.release()
    assert ring.tail == 2  # 0 released, the skipped 1 drained
    third.release()
    assert ring.tail == 3
    ring.close()


def test_pinned_staging_gives_equal_views_of_a_copy(tmp_path):
    """stage_pinned: each popped record is a copy in its slot's buffer
    (grown to the largest record, reused after), equal to the slot."""
    ring = pring.IngestRing.create(str(tmp_path / "r"), slots=2, slot_packets=64,
                                   payload_width=64)
    made = []

    def alloc(nbytes):
        made.append(nbytes)
        return np.zeros(nbytes, np.uint8)

    ring.stage_pinned(alloc=alloc)
    assert ring.pinned
    rng = np.random.default_rng(5)
    for n in (10, 64, 20, 64):
        w, fl, pay, lens = _record(rng, n, 7, True, 64)
        ring.push(w, tcp_flags=fl, payload=pay, payload_len=lens)
        c = ring.pop()
        assert np.array_equal(c.wire, w) and np.array_equal(c.tcp_flags, fl)
        assert np.array_equal(c.payload, pay) and np.array_equal(c.payload_len, lens)
        mapped = np.frombuffer(ring._mm, np.uint8)
        assert not np.shares_memory(c.wire, mapped) and not np.shares_memory(c.payload, mapped)
        c.release()
    # slot 0 takes 10 rows, then grows for 20; slot 1 takes 64, then reuses
    assert made == [10 * 100, 64 * 100, 20 * 100]
    ring.close()


# --- the daemons ---------------------------------------------------------------------------

def _ring_daemons(tmp_path, k: int, mode: str):
    """The JAX daemon and the port's, each with its own ring, the payload
    tier (16 patterns) and a flow tier: multi-dispatch at K = 1, resident
    at K > 1."""
    jreg, preg = tdaemon._registries()
    common = dict(node_name=tdaemon.NODE, poll_period_s=3600.0, metrics_port=0, health_port=0,
                  file_poll_interval_s=60.0, ingest_chunk=tdaemon.CHUNK, pipeline_depth=3,
                  payload=PATTERNS, payload_mode=mode, superbatch_k=k, max_tick_packets=256)
    if k > 1:
        jkw = pkw = {"resident": True}
    else:
        jkw = {"flow_table": JaxFlowConfig.make(entries=1024)}
        pkw = {"flow_table": FlowConfig.make(entries=1024)}
    jd = jax_daemon.Daemon(state_dir=str(tmp_path / "jax"), backend="tpu", registry=jreg,
                           ring=str(tmp_path / "jax.ring"), **jkw, **common)
    pd = daemon.Daemon(state_dir=str(tmp_path / "port"), backend="cpu", registry=preg,
                       ring=str(tmp_path / "port.ring"), **pkw, **common)
    return jd, pd


def _ring_records(tables, seed: int):
    """flow_trace_batch records of RECORD packets (SYN, ACK, FIN and some
    RST flags), a 10% signature mix in the payload column, and one 4-word
    record of another size among them (a shape-class break)."""
    rng = np.random.default_rng(seed)
    batch, _meta = testing.flow_trace_batch(rng, tables, 8 * RECORD, 0.6, chunk_packets=RECORD)
    flags = np.asarray(batch.tcp_flags).copy()
    flags[::37] |= 0x04  # RST
    k = len(batch) // 10
    pay_a, len_a = ppay.attack_payloads(rng, k, PATTERNS, plen=64)
    pay_b, len_b = ppay.benign_payloads(rng, len(batch) - k, plen=64)
    perm = rng.permutation(len(batch))
    pay = np.concatenate([pay_a, pay_b])[perm]
    plen = np.concatenate([len_a, len_b])[perm].astype(np.int32)
    recs = []
    for lo in range(0, len(batch), RECORD):
        idx = np.arange(lo, lo + RECORD)
        w, v4 = batch.pack_wire_subset(idx)
        recs.append((w, v4, flags[idx], pay[idx], plen[idx]))
    v4i = np.nonzero(np.asarray(batch.kind) == 1)[0][:40]
    w4, v4 = batch.pack_wire_subset(v4i)
    assert w4.shape == (40, 4) and v4
    recs.insert(3, (w4, v4, flags[v4i], pay[v4i], plen[v4i]))
    return recs


def _lines(d, prefix: str) -> list:
    pre = f"ingressnodefirewall_node_{prefix}"
    return [ln for ln in d.metrics_registry.render_text().splitlines() if ln.startswith(pre)]


@pytest.mark.parametrize("k,mode", [(1, "shadow"), (1, "enforce"), (4, "enforce")])
def test_ring_daemons_agree(tmp_path, k, mode):
    """The same records pushed into each daemon's ring (JAX records into
    the JAX ring, the port's producer into the port's) and drained tick by
    tick under a 256-packet budget: equal packets a tick, statistics,
    events, flow_*, payload_* and ring_* on /metrics; every slot released;
    at K = 4 the superbatches and the break counted alike."""
    jd, pd = _ring_daemons(tmp_path, k, mode)
    try:
        doc = tdaemon._nodestate(tdaemon.PATHS["dense"][0])
        for d in (jd, pd):
            tdaemon._write_state(d, doc)
            d.scan_nodestates_once()
            assert d.ingest_ring.slots == 10 and d.superbatch_k == k
        recs = _ring_records(tdaemon._compile(doc), seed=3 + k)
        prods = (jring.IngestRing.attach(jd.ingest_ring.path),
                 pring.IngestRing.attach(pd.ingest_ring.path))
        for prod in prods:
            for w, v4, fl, pay, plen in recs:
                prod.push(w, v4_only=v4, tcp_flags=fl, payload=pay, payload_len=plen)
        served = [(jd.process_ring_once(), pd.process_ring_once()) for _ in range(3)]
        assert [a for a, _b in served] == [b for _a, b in served]
        assert sum(b for _a, b in served) == sum(len(r[0]) for r in recs)
        jc, pc = jd.syncer.classifier, pd.syncer.classifier
        assert np.array_equal(np.asarray(jc.stats.snapshot()), np.asarray(pc.stats.snapshot()))
        assert pc.payload_counters()["payload_admissions_total"] == len(recs)
        assert pc.payload_counters()["payload_matched_total"] > 0
        assert pc.flow_counters()["flow_promotes_total"] > 0
        if k > 1:
            rj, rp = jc.resident_counters(), pc.resident_counters()
            for key in ("resident_dispatches_total", "resident_superbatch_dispatches_total",
                        "resident_superbatch_admissions_total"):
                assert rp[key] == rj[key], key
            assert rp["resident_superbatch_dispatches_total"] >= 2
        for pre in ("flow_", "payload_", "ring_"):
            assert _lines(pd, pre) and _lines(pd, pre) == _lines(jd, pre), pre
        assert tdaemon._events(pd) == tdaemon._events(jd)
        for d in (jd, pd):
            assert d.ingest_ring.tail == d.ingest_ring.head == len(recs)
            assert not d._ring_inflight
        for prod in prods:
            prod.close()
    finally:
        tdaemon._stop(jd, pd)


def test_ring_waits_for_tables_and_traces_its_spans(tmp_path):
    """Records pushed before the first NodeState wait in the ring; with
    --trace each record's ring spans (ingest, h2d, dispatch, materialize,
    drain) land in the span histograms."""
    _jreg, preg = tdaemon._registries()
    d = daemon.Daemon(state_dir=str(tmp_path / "port"), node_name=tdaemon.NODE, backend="cpu",
                      registry=preg, poll_period_s=3600.0, metrics_port=0, health_port=0,
                      file_poll_interval_s=60.0, pipeline_depth=2, max_tick_packets=64,
                      flow_table=FlowConfig.make(entries=256), trace=True,
                      ring=str(tmp_path / "r.ring"))
    try:
        assert not d.ingest_ring.pinned  # the cpu backend copies nothing to a card
        doc = tdaemon._nodestate(tdaemon.PATHS["dense"][0])
        recs = _ring_records(tdaemon._compile(doc), seed=9)
        prod = pring.IngestRing.attach(d.ingest_ring.path)
        for w, v4, fl, _pay, _plen in recs[:4]:
            prod.push(w, v4_only=v4, tcp_flags=fl)
        assert d.process_ring_once() == 0 and len(d.ingest_ring) == 4
        tdaemon._write_state(d, doc)
        d.scan_nodestates_once()
        assert d.process_ring_once() == RECORD  # the budget: 64 packets
        assert d.process_ring_once(budget=10 ** 9) == 2 * RECORD + 40
        spans = d.tracer.histograms.values()
        for stage in ("ingest", "h2d", "dispatch", "materialize", "drain"):
            assert spans[stage]["count"] == 4, stage
        prod.close()
    finally:
        d.stop()


# --- the flags -----------------------------------------------------------------------------

class _Stub:
    seen: dict = {}

    def __init__(self, **kw):
        _Stub.seen = kw
        raise SystemExit(0)


@pytest.mark.parametrize("via", ["flag", "env"])
def test_ring_and_superbatch_flags_reach_the_daemon(tmp_path, monkeypatch, via):
    for _f, e, _i in daemon.REFUSED_FLAGS:
        monkeypatch.delenv(e, raising=False)
    for e in ("INFW_RING", "INFW_SUPERBATCH_K"):
        monkeypatch.delenv(e, raising=False)
    refused = {f for f, _e, _i in daemon.REFUSED_FLAGS}
    assert not refused & {"--ring", "--superbatch-k"}
    monkeypatch.setattr(daemon, "Daemon", _Stub)
    argv = ["--state-dir", str(tmp_path / "s"), "--node-name", tdaemon.NODE, "--backend", "cpu"]
    ring = str(tmp_path / "in.ring")
    if via == "flag":
        argv += ["--ring", ring, "--superbatch-k", "4"]
    else:
        monkeypatch.setenv("INFW_RING", ring)
    with pytest.raises(SystemExit) as e:
        daemon.main(argv)
    assert e.value.code == 0 and _Stub.seen["ring"] == ring
    assert _Stub.seen["superbatch_k"] == (4 if via == "flag" else None)
    with pytest.raises(SystemExit) as e:
        daemon.main(argv + ["--ring", str(tmp_path / "missing" / "in.ring")])
    assert e.value.code == 2


def test_superbatch_k_environment_default(tmp_path, monkeypatch):
    """INFW_SUPERBATCH_K sets K when the argument is absent (1 without it),
    as in the JAX daemon; no ring is created without --ring."""
    _jreg, preg = tdaemon._registries()
    kw = dict(node_name=tdaemon.NODE, backend="cpu", registry=preg, metrics_port=0,
              health_port=0, file_poll_interval_s=60.0)
    monkeypatch.delenv("INFW_SUPERBATCH_K", raising=False)
    d = daemon.Daemon(state_dir=str(tmp_path / "a"), **kw)
    assert d.superbatch_k == 1 and d.ingest_ring is None and d.process_ring_once() == 0
    d.stop()
    monkeypatch.setenv("INFW_SUPERBATCH_K", "3")
    d = daemon.Daemon(state_dir=str(tmp_path / "b"), **kw)
    assert d.superbatch_k == 3
    d.stop()


@pytest.mark.parametrize("flag,sub", [("--deadline-us", "24b"), ("--max-batch", "24b"),
                                      ("--events-socket", "24d"), ("--no-fused-deep", "24e")])
def test_remaining_refused_flags_name_their_sub_item(tmp_path, capsys, monkeypatch, flag, sub):
    for _f, e, _i in daemon.REFUSED_FLAGS:
        monkeypatch.delenv(e, raising=False)
    with pytest.raises(SystemExit) as e:
        daemon.main(["--state-dir", str(tmp_path / "s"), "--node-name", tdaemon.NODE,
                     "--backend", "cpu", flag])
    assert e.value.code == 2
    assert f"ROADMAP.md item {sub} " in capsys.readouterr().err


# --- the producer --------------------------------------------------------------------------

def _jax_loadgen():
    """tools/loadgen.py, imported by path (it imports tools/_common)."""
    sys.path.insert(0, str(REPO / "tools"))
    try:
        spec = importlib.util.spec_from_file_location("jax_loadgen", REPO / "tools" / "loadgen.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(REPO / "tools"))
    return mod


@pytest.mark.parametrize("extra", [
    [],
    ["--established-fraction", "0.9", "--attack", "synflood", "--payload", "attack-mix"],
    ["--burst", "32", "--attack", "denystorm", "--payload", "http", "--payload-plen", "128",
     "--v6-fraction", "0.5"],
    ["--attack", "portscan", "--payload", "attack-mix", "--payload-seed", "11",
     "--payload-patterns", "64"],
], ids=["plain", "synflood-attack-mix", "burst-denystorm-http128", "portscan-seed11"])
def test_loadgen_writes_the_jax_producers_bytes(tmp_path, capsys, extra):
    """The same arguments write the same ring file through either producer,
    and print the same schedule summary (and, on a dry run, nothing
    else)."""
    jlg = _jax_loadgen()
    plen = 128 if "128" in extra else 64
    args = ["--rate", "1e9", "--n", "1500", "--file-packets", "256", "--seed", "5"] + extra
    files = {}
    for name, main, pkg in (("jax", jlg.main, jring), ("port", loadgen.main, pring)):
        path = str(tmp_path / f"{name}.ring")
        pkg.IngestRing.create(path, slots=8, slot_packets=256,
                              payload_width=plen if "--payload" in extra else 0).close()
        assert main(args + ["--ring", path]) == 0
        out = capsys.readouterr().out.splitlines()
        files[name] = (open(path, "rb").read(), json.loads(out[0]))
        done = json.loads(out[1])
        assert done["ring_pushed_total"] == 6 and not done["ring_backpressured"]
    assert files["port"][0] == files["jax"][0]
    assert files["port"][1] == files["jax"][1]
    assert loadgen.main(args + ["--ring", str(tmp_path / "none"), "--dry-run"]) == 0
    assert json.loads(capsys.readouterr().out) == files["port"][1]


def test_loadgen_helpers_match_the_jax_producers():
    jlg = _jax_loadgen()
    mask = np.random.default_rng(3).random(1000) < 0.3
    enc = loadgen.encode_attack_labels(mask, 256)
    assert enc == jlg.encode_attack_labels(mask, 256)
    assert np.array_equal(loadgen.decode_attack_labels(enc, 1000, 256), mask)
    for n_src in (1, 3):
        assert np.array_equal(loadgen.attack_lane_src_ids(mask, n_src),
                              jlg.attack_lane_src_ids(mask, n_src))
    for seed in (0, 1):
        a = testing.poisson_arrivals(np.random.default_rng(seed), 5e4, 999)
        b = jlg.testing.poisson_arrivals(np.random.default_rng(seed), 5e4, 999)
        assert np.array_equal(a, b)
        a = testing.burst_arrivals(np.random.default_rng(seed), 5e4, 999, burst=16)
        b = jlg.testing.burst_arrivals(np.random.default_rng(seed), 5e4, 999, burst=16)
        assert np.array_equal(a, b)
    with pytest.raises(SystemExit):
        loadgen.main(["--ring", "x", "--rate", "1", "--n", "10", "--payload", "http",
                      "--payload-plen", "96"])
    assert os.path.basename(pring.ring_path("/s")) == "ingest.ring"


def test_chip_smoke_ring_phase_runs_on_the_cpu(monkeypatch):
    """chip_smoke.py's "daemon ring" phase end to end on the CPU at a small
    size (its card-only checks skipped): both configurations' verdicts,
    statistics, payload and flow counters equal the classic entry's, the
    4-word record breaks the superbatch, FIN entries and RST teardowns
    show, every slot is released."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(str(REPO))
    from infw_torch import compiler, spec
    from infw_torch.interfaces import Interface, InterfaceRegistry

    for name, value in (("DEV", "cpu"), ("RING_RECORD", 256), ("RING_RECORDS", 6),
                        ("RST_ROWS", 128), ("RING_TICK_PACKETS", 512), ("RING_DEPTH", 2),
                        ("FLOW_SLAB", 1 << 12)):
        monkeypatch.setattr(cs, name, value)
    registry = InterfaceRegistry()
    for name, index in cs.DAEMON_IFACES.items():
        registry.add(Interface(name=name, index=index))
    doc = testing.random_nodestate(np.random.default_rng(41), cs.DAEMON_NODE, cs.DAEMON_IFACES,
                                   600, width=8)
    tables = compiler.compile_tables(
        spec.IngressNodeFirewallNodeState.from_dict(doc).spec.interface_ingress_rules, registry)
    monkeypatch.setattr(cs, "FLOW_STASH", {"daemon_doc": doc, "daemon_registry": registry,
                                           "daemon_tables": tables})
    out = cs.ring_phase("[cpu]")
    for name in ("a", "b"):
        r = out[name]
        assert r["records"] == 3 * 7 + 1 and r["ring"]["ring_popped_total"] == r["records"]
        assert r["fin_entries"] > 0 and r["rst_torn"] > 0
        assert r["payload"]["payload_admissions_total"] == r["records"]
    assert out["b"]["resident"]["resident_superbatch_dispatches_total"] > 0
