"""The port's daemon (infw_torch.daemon) against the JAX package's
(infw.daemon, ``backend="tpu"`` on the CPU), each in its own state dir: the
same NodeState CR and the same frames files through ``scan_nodestates_once``
and ``process_ingest_once`` must give the same verdict sidecars, summaries,
statistics, deny-event lines and spill rows and /metrics text, on the dense,
trie and ctrie paths under the wire8 and delta codecs.  The same edit files
dropped into both daemons' ``edits/`` (every edit kind, folding, overlay
routing and its spill, a bad file, a generator's manifest, edits queued
before the first NodeState, a restart that replays the journal, an
escalated rebuild) leave the same verdicts, statistics, events and /metrics.
Also: checkpoints move between the two daemons in both directions, failures
stay isolated with statistics counted exactly once, deleting the state file
resets the dataplane, the default backend needs a card, the edit batching
flags reach the batcher, and every refused flag names its ROADMAP item."""
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import infw._threads as jax_threads
import infw.daemon as jax_daemon
import infw.syncer as jax_syncer
import infw.txn as jax_txn
from infw.compiler import CompiledTables as JaxTables
from infw.interfaces import Interface as JaxInterface
from infw.interfaces import InterfaceRegistry as JaxRegistry
from infw.obs import events as jax_events
from infw.obs import pcap as jax_pcap
from infw_torch import _threads, compiler, daemon, spec, syncer, testing, txn
from infw_torch.backend.base import PendingClassify
from infw_torch.compiler import CompiledTables, LazyContent
from infw_torch.interfaces import Interface, InterfaceRegistry
from infw_torch.obs import events, pcap

REPO = Path(__file__).resolve().parents[1]
NODE = "worker-0"
IFACES = {"dummy0": 10, "dummy1": 11, "dummy2": 12}
#: files of one tick: more packets than ingest_chunk in the first, so jobs
#: span files and files span jobs; the first holds more than
#: BATCH_EMIT_THRESHOLD denies, so its events take the binary spill
FILE_SIZES = (4000, 700, 90)
CHUNK = 256
PATHS = {"dense": (60, False), "trie": (4400, False), "ctrie": (4400, True)}


def _registries():
    jreg, preg = JaxRegistry(), InterfaceRegistry()
    for name, index in IFACES.items():
        jreg.add(JaxInterface(name=name, index=index))
        preg.add(Interface(name=name, index=index))
    return jreg, preg


def _daemons(tmp_path, **kw):
    """The JAX daemon and the port's, each in its own state dir, with no
    threads started (ticks are driven by hand)."""
    jreg, preg = _registries()
    common = dict(node_name=NODE, poll_period_s=3600.0, metrics_port=0, health_port=0,
                  file_poll_interval_s=60.0, ingest_chunk=CHUNK, pipeline_depth=3, **kw)
    jd = jax_daemon.Daemon(state_dir=str(tmp_path / "jax"), backend="tpu", registry=jreg,
                           **common)
    pd = daemon.Daemon(state_dir=str(tmp_path / "port"), backend="cpu", registry=preg, **common)
    return jd, pd


def _nodestate(n_cidrs: int, seed: int = 1) -> dict:
    return testing.random_nodestate(np.random.default_rng(seed), NODE, IFACES, n_cidrs,
                                    deny_share=0.8)


def _write_state(d, doc) -> None:
    p = os.path.join(d.nodestates_dir, f"{NODE}.json")
    with open(p + ".tmp", "w") as f:
        json.dump(doc, f)
    os.replace(p + ".tmp", p)


def _compile(doc):
    _, preg = _registries()
    ns = spec.IngressNodeFirewallNodeState.from_dict(doc)
    return compiler.compile_tables(ns.spec.interface_ingress_rules, preg)


def _frames(doc, seed: int, sizes=FILE_SIZES, tables=None):
    """FramesBufs of random_batch_fast packets over the NodeState's own
    tables, or ``tables`` (IPv4, IPv6, ICMP, malformed and other
    ethertypes), one per file size."""
    if tables is None:
        tables = _compile(doc)
    b = testing.random_batch_fast(np.random.default_rng(seed), tables, sum(sizes), hit_fraction=0.95)
    out, start = [], 0
    for n in sizes:
        sub = b.slice(start, start + n)
        fb = pcap.build_frames_bulk(sub.kind, sub.ip_words, sub.proto, sub.dst_port,
                                    sub.icmp_type, sub.icmp_code, l4_ok=sub.l4_ok)
        fb.ifindex = np.asarray(sub.ifindex, np.uint32)
        out.append(fb)
        start += n
    return out


def _drop(d, fbs, prefix="f") -> None:
    for i, fb in enumerate(fbs):
        daemon.write_frames_file_v2(os.path.join(d.ingest_dir, f"{prefix}{i}.frames"), fb)


def _out_files(d):
    return {fn: open(os.path.join(d.out_dir, fn), "rb").read()
            for fn in sorted(os.listdir(d.out_dir))}


def _metrics(d, clf, crash_reset) -> str:
    crash_reset()
    d.stats.update_metrics(clf)
    return d.metrics_registry.render_text()


def _events(d) -> tuple:
    d.events_logger.drain_once()
    d._event_file.flush()
    text = open(d.events_path).read().replace(d.state_dir, "<state-dir>")
    spill = os.path.join(d.state_dir, "deny-events.bin")
    return text, open(spill, "rb").read() if os.path.exists(spill) else None


def _stop(*ds) -> None:
    for d in ds:
        d.stop()


@pytest.mark.parametrize("codec", ["wire8", "delta"])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_daemons_agree_bit_for_bit(tmp_path, path, codec):
    n_cidrs, compressed = PATHS[path]
    jd, pd = _daemons(tmp_path, wire_codec=codec, compressed=compressed)
    try:
        doc = _nodestate(n_cidrs)
        for d in (jd, pd):
            _write_state(d, doc)
            d.scan_nodestates_once()
        jclf, pclf = jd.syncer.classifier, pd.syncer.classifier
        assert pclf.active_path == path
        assert jclf.tables.num_entries == pclf.tables.num_entries
        fbs = _frames(doc, seed=2)
        for d in (jd, pd):
            _drop(d, fbs)
        assert jd.process_ingest_once() == pd.process_ingest_once() == len(FILE_SIZES)
        assert not os.listdir(pd.ingest_dir)
        jout, pout = _out_files(jd), _out_files(pd)
        assert sorted(pout) == sorted(jout) and len(pout) == 2 * len(FILE_SIZES)
        for fn in jout:
            assert pout[fn] == jout[fn], fn
        np.testing.assert_array_equal(pclf.stats.snapshot(), jclf.stats.snapshot())
        jev, pev = _events(jd), _events(pd)
        assert pev == jev
        # the first file's denies took the binary spill: its rows are the
        # reference's SPILL_DTYPE (32 bytes; its summary line says 28)
        rows = np.frombuffer(pev[1], events.BatchDenyRecord.SPILL_DTYPE)
        assert events.BatchDenyRecord.SPILL_DTYPE.itemsize == 32
        assert len(rows) > events.BATCH_EMIT_THRESHOLD and ((rows["result"] & 0xFF) == 1).all()
        ptext = _metrics(pd, pclf, _threads.reset_crash_counters)
        jtext = _metrics(jd, jclf, jax_threads.reset_crash_counters)
        pws, jws = pclf.wire_stats(), jclf.wire_stats()
        if path == "ctrie":
            # the one deliberate difference: on the ctrie path the JAX
            # classifier still hands out IPv6 depth classes, so its daemon
            # splits IPv6 jobs by class and pads each; the port's K3 walks
            # every chunk whole and does not split them.  The wire counters
            # then count different padding; every other line is equal.
            assert sorted(pws) == sorted(jws)
            n = sum(FILE_SIZES)
            assert n <= sum(p for p, _b in pws.values()) <= sum(p for p, _b in jws.values())
            ptext, jtext = ("".join(l for l in t.splitlines(keepends=True)
                                    if "_node_wire_" not in l) for t in (ptext, jtext))
        else:
            assert pws == jws
        assert ptext == jtext
        if path != "dense":
            assert codec in pws
    finally:
        _stop(jd, pd)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_moves_between_daemons(tmp_path, writer):
    """A checkpoint written by one daemon is re-adopted by the other (no
    recompile: the desired content is unchanged) and serves the same
    verdicts."""
    jd, pd = _daemons(tmp_path)
    src, dst = (jd, pd) if writer == "jax" else (pd, jd)
    try:
        doc = _nodestate(600, seed=3)
        _write_state(src, doc)
        src.scan_nodestates_once()
        ck = os.path.join(src.state_dir, "checkpoint")
        assert sorted(os.listdir(ck)) == ["manifest.json", "tables.npz"]
        shutil.rmtree(os.path.join(dst.state_dir, "checkpoint"), ignore_errors=True)
        shutil.copytree(ck, os.path.join(dst.state_dir, "checkpoint"))
        _write_state(dst, doc)
        dst.scan_nodestates_once()
        # re-adopted: the tables are the checkpoint's (their content still
        # the stored columns) and no incremental state was built
        assert dst.syncer._updater is None
        assert type(dst.syncer.classifier.tables.content).__name__ == "LazyContent"
        assert dst.syncer.attached_interfaces() == set(IFACES)
        fbs = _frames(doc, seed=4, sizes=(900, 300))
        for d in (jd, pd):
            _drop(d, fbs)
            assert d.process_ingest_once() == 2
        assert _out_files(pd) == _out_files(jd)
    finally:
        _stop(jd, pd)


def test_checkpoint_files_load_in_both_packages(tmp_path):
    """CompiledTables.save of each package loads in the other, array for
    array, the content as the same columns."""
    doc = _nodestate(4400, seed=5)
    _, preg = _registries()
    ns = spec.IngressNodeFirewallNodeState.from_dict(doc)
    tables = compiler.compile_tables(ns.spec.interface_ingress_rules, preg)
    tables.save(str(tmp_path / "port.npz"))
    jt = JaxTables.load(str(tmp_path / "port.npz"))
    jt.save(str(tmp_path / "jax.npz"))
    back = CompiledTables.load(str(tmp_path / "jax.npz"))
    for t in (jt, back):
        for f in ("key_words", "mask_words", "mask_len", "rules", "root_lut"):
            np.testing.assert_array_equal(getattr(t, f), getattr(tables, f))
        assert t.rule_width == tables.rule_width and t.num_entries == tables.num_entries
        assert len(t.trie_levels) == len(tables.trie_levels)
        for a, b in zip(t.trie_levels, tables.trie_levels):
            np.testing.assert_array_equal(a, b)
    assert isinstance(back.content, LazyContent)
    assert {k: v.tolist() for k, v in back.content.items()} == {
        k: v.tolist() for k, v in tables.content.items()}


@pytest.mark.parametrize("mode", ["deferred", "sync"])
def test_ingest_failure_isolated_and_stats_exactly_once(tmp_path, mode):
    """The reference's failure semantics (tests/test_daemon.py) on the
    port's packed path: a transient fault of a merged job heals within the
    tick through per-file retries; a persistent fault attributable to one
    file's packets leaves only that file on disk; a bad file is consumed;
    statistics land exactly once across every retry."""
    from infw.constants import IPPROTO_TCP

    _, preg = _registries()
    d = daemon.Daemon(state_dir=str(tmp_path / "state"), node_name=NODE, backend="cpu",
                      poll_period_s=3600.0, registry=preg, metrics_port=0, health_port=0,
                      file_poll_interval_s=60.0)
    try:
        _write_state(d, {"metadata": {"name": NODE}, "spec": {"interfaceIngressRules": {
            "dummy0": [{"sourceCIDRs": ["10.0.0.0/8"], "rules": [{
                "order": 1, "protocolConfig": {"protocol": "TCP", "tcp": {"ports": 80}},
                "action": "Deny"}]}]}}})
        d.scan_nodestates_once()
        clf = d.syncer.classifier
        assert clf.supports_packed()
        deny = lambda src: pcap.build_frame(src, "203.0.113.1", IPPROTO_TCP, 999, 80)
        mark_w0 = (10 << 24) | (1 << 16) | (2 << 8) | 9  # 10.1.2.9
        orig_prepare, orig_launch = clf.prepare_packed, clf.classify_prepared
        fail = {"pred": lambda plan: True}

        def prepare(wire, v4_only, depth=None):
            plan = orig_prepare(wire, v4_only, depth=depth)
            plan["marked"] = bool((wire[:, 3] == mark_w0).any())
            return plan

        def launch(plan, apply_stats=True):
            if fail["pred"](plan):
                if mode == "sync":
                    raise RuntimeError("device fell over at launch")

                def explode():
                    raise RuntimeError("device fell over")

                return PendingClassify(explode)
            return orig_launch(plan, apply_stats=apply_stats)

        clf.prepare_packed, clf.classify_prepared = prepare, launch

        # a transient fault: exactly one launch (the merged job) fails
        left = {"n": 1}

        def once(plan):
            left["n"] -= 1
            return left["n"] == 0

        fail["pred"] = once
        with open(os.path.join(d.ingest_dir, "0bad.frames"), "wb") as f:
            f.write(b"not a frames file")
        daemon.write_frames_file(os.path.join(d.ingest_dir, "aaa.frames"), [deny("10.1.2.3")] * 3, 10)
        daemon.write_frames_file(os.path.join(d.ingest_dir, "bbb.frames"), [deny("10.1.2.3")] * 2, 10)
        assert d.process_ingest_once() == 2
        assert os.listdir(d.ingest_dir) == []  # the bad file is consumed too
        assert not os.path.exists(os.path.join(d.out_dir, "0bad.frames.verdicts.json"))
        assert clf.stats.snapshot()[1, 2] == 5

        # a persistent fault of aaa2's packets: only aaa2 stays on disk
        fail["pred"] = lambda plan: plan["marked"]
        daemon.write_frames_file(os.path.join(d.ingest_dir, "aaa2.frames"), [deny("10.1.2.9")] * 3, 10)
        daemon.write_frames_file(os.path.join(d.ingest_dir, "bbb2.frames"), [deny("10.1.2.3")] * 2, 10)
        assert d.process_ingest_once() == 1
        assert os.listdir(d.ingest_dir) == ["aaa2.frames"]
        assert not os.path.exists(os.path.join(d.out_dir, "aaa2.frames.verdicts.json"))
        assert clf.stats.snapshot()[1, 2] == 7

        fail["pred"] = lambda plan: False
        assert d.process_ingest_once() == 1
        assert os.listdir(d.ingest_dir) == []
        assert clf.stats.snapshot()[1, 2] == 10
        d.events_logger.drain_once()
        d._event_file.flush()
        assert open(d.events_path).read().count("ruleId 1 action Drop len 54 if dummy0") == 10
    finally:
        d.stop()


def test_deleting_the_state_file_resets_the_dataplane(tmp_path):
    _, preg = _registries()
    d = daemon.Daemon(state_dir=str(tmp_path / "state"), node_name=NODE, backend="cpu",
                      poll_period_s=3600.0, registry=preg, metrics_port=0, health_port=0)
    try:
        _write_state(d, _nodestate(40))
        d.scan_nodestates_once()
        assert d.syncer.classifier is not None and d.syncer.classifier.tables is not None
        assert d.syncer.attached_interfaces() == set(IFACES)
        ck = os.path.join(d.state_dir, "checkpoint")
        assert os.path.exists(os.path.join(ck, "tables.npz"))
        os.remove(os.path.join(d.nodestates_dir, f"{NODE}.json"))
        d.scan_nodestates_once()
        assert d.syncer.classifier is None
        assert d.syncer.attached_interfaces() == set()
        assert not os.path.exists(os.path.join(ck, "tables.npz"))
        assert preg.get_interfaces_with_xdp_attached() == []
        # a rejected file is logged once and its deletion is no CR deletion
        bad = _nodestate(40)
        bad["spec"]["interfaceIngressRules"]["dummy0"][0]["rules"][0]["order"] = 0
        _write_state(d, bad)
        d.scan_nodestates_once()
        assert d.syncer.classifier is None and d._rejected_state_files
    finally:
        d.stop()


def test_threads_serve_metrics_health_and_debug_keys(tmp_path, monkeypatch):
    """The started daemon: the file loop syncs the state file and consumes
    a frames file on an interface with ifindex above 65535; the HTTP
    threads serve /metrics (the deny counter from the host statistics),
    /healthz and /debug/lookup-keys; stop() joins every thread."""
    import threading
    import time
    import urllib.request

    from infw.constants import IPPROTO_TCP

    preg = InterfaceRegistry()
    preg.add(Interface(name="big0", index=70000))
    d = daemon.Daemon(state_dir=str(tmp_path / "state"), node_name=NODE, backend="cpu",
                      poll_period_s=0.05, registry=preg, metrics_port=0, health_port=0,
                      file_poll_interval_s=0.02, debug_lookup=True)
    before = threading.active_count()
    d.start()
    try:
        _write_state(d, {"metadata": {"name": NODE}, "spec": {"interfaceIngressRules": {
            "big0": [{"sourceCIDRs": ["10.0.0.0/8"], "rules": [{
                "order": 1, "protocolConfig": {"protocol": "TCP", "tcp": {"ports": 80}},
                "action": "Deny"}]}]}}})
        frames = [pcap.build_frame("10.1.2.3", "203.0.113.1", IPPROTO_TCP, 999, 80)] * 3
        deadline = time.monotonic() + 30
        while d.syncer.classifier is None or d.syncer.classifier.tables is None:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        daemon.write_frames_file(os.path.join(d.ingest_dir, "t.frames"), frames, 70000)
        vp = os.path.join(d.out_dir, "t.frames.verdicts.json")
        url = f"http://127.0.0.1:{d.actual_metrics_port}"
        while True:
            assert time.monotonic() < deadline
            if os.path.exists(vp):
                body = urllib.request.urlopen(url + "/metrics", timeout=5).read().decode()
                if "ingressnodefirewall_node_packet_deny_total 3\n" in body:
                    break
            time.sleep(0.02)
        assert json.load(open(vp))["drop"] == 3
        assert urllib.request.urlopen(url + "/healthz", timeout=5).read() == b"ok"
        keys = json.loads(urllib.request.urlopen(url + "/debug/lookup-keys", timeout=5).read())
        assert keys[0] == {"ifindex": 70000, "ip_words": [(10 << 24) | (1 << 16) | (2 << 8) | 3, 0, 0, 0]}
        while "if big0" not in open(d.events_path).read():
            assert time.monotonic() < deadline
            time.sleep(0.02)
        assert "ruleId 1 action Drop len 54 if big0" in open(d.events_path).read()
    finally:
        d.stop()
    # the HTTP handler threads of the last requests may still be closing
    deadline = time.monotonic() + 5
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before


def test_deny_events_match_the_reference_byte_for_byte():
    """Per-event records (frame capture, full line decode) and a
    replay-scale BatchDenyRecord (32-byte spill rows, summary line), with
    ifindexes at and above 2^31 carried as int32 as the parser gives them."""
    rng = np.random.default_rng(6)
    n = 3000
    b = testing.random_batch_fast(rng, testing.random_tables_fast(rng, 500), n)
    b.ifindex[:8] = np.asarray([70000, -2**31, -1, 2**31 - 1, 65535, 65536, 0, 12], np.int32)
    fb = pcap.build_frames_bulk(b.kind, b.ip_words, b.proto, b.dst_port, b.icmp_type,
                                b.icmp_code, l4_ok=b.l4_ok)
    results = rng.integers(0, 1 << 16, n).astype(np.uint32)
    results[rng.random(n) < 0.5] &= ~np.uint32(0xFF)
    results[: 64] = (results[:64] & ~np.uint32(0xFF)) | 1
    for sel in (slice(0, 200), slice(0, n)):  # below and above BATCH_EMIT_THRESHOLD
        got = []
        for ev, tmp in ((events, "p"), (jax_events, "j")):
            ring = ev.EventRing(capacity=1 << 16)
            ev.emit_deny_events(ring, results[sel], b.ifindex[sel], b.pkt_len[sel],
                                [fb[i] for i in range(n)][sel], batch=b.take(np.arange(n)[sel]))
            lines = []
            spill = Path(os.environ.get("TMPDIR", "/tmp")) / f"infw-spill-{os.getpid()}-{tmp}.bin"
            spill.unlink(missing_ok=True)
            logger = ev.EventsLogger(ring, lines.append, iface_names={70000: "big0", 12: "eth"},
                                     spill_path=str(spill))
            logger.drain_once()
            rows = spill.read_bytes() if spill.exists() else b""
            spill.unlink(missing_ok=True)
            got.append(([l.replace(str(spill), "<spill>") for l in lines], rows,
                        ring.counter_values()))
        assert got[0] == got[1]
        assert got[0][0]  # some events


def test_frames_parse_and_build_match_the_reference(tmp_path):
    rng = np.random.default_rng(7)
    b = testing.random_batch_fast(rng, testing.random_tables_fast(rng, 300), 2000)
    args = (b.kind, b.ip_words, b.proto, b.dst_port, b.icmp_type, b.icmp_code)
    fb, jfb = pcap.build_frames_bulk(*args, l4_ok=b.l4_ok), jax_pcap.build_frames_bulk(*args, l4_ok=b.l4_ok)
    assert fb.buf.tobytes() == jfb.buf.tobytes()
    fb.ifindex = jfb.ifindex = np.asarray(b.ifindex, np.uint32)
    daemon.write_frames_file_v2(str(tmp_path / "p"), fb)
    jax_daemon.write_frames_file_v2(str(tmp_path / "j"), jfb)
    assert (tmp_path / "p").read_bytes() == (tmp_path / "j").read_bytes()
    got = pcap.parse_frames_buf(daemon.read_frames_any(str(tmp_path / "p")))
    ref = jax_pcap.parse_frames_buf(jax_daemon.read_frames_any(str(tmp_path / "j")))
    for f in ("kind", "l4_ok", "ifindex", "ip_words", "proto", "dst_port", "icmp_type",
              "icmp_code", "pkt_len"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)
    frames = [fb[i] for i in range(50)] + [b"", b"short", fb[0][:20], fb[1][:40]]
    daemon.write_frames_file(str(tmp_path / "v1"), frames, 7)
    one = pcap.parse_frames_buf(daemon.read_frames_any(str(tmp_path / "v1")))
    for i, fr in enumerate(frames):
        assert pcap.parse_frame(fr) == jax_pcap.parse_frame(fr)
        assert one.kind[i] == jax_pcap.parse_frame(fr)[0]
    assert pcap.build_frame("2001:db8::1", "2001:db8::2", 58, icmp_type=128) == \
        jax_pcap.build_frame("2001:db8::1", "2001:db8::2", 58, icmp_type=128)


def test_default_backend_needs_a_card(tmp_path):
    """Daemon() with the default backend resolves the card at
    construction: without one it raises before making its state dir."""
    state = tmp_path / "state"
    if torch.cuda.is_available():
        d = daemon.Daemon(state_dir=str(state), node_name=NODE, metrics_port=0, health_port=0)
        assert d.syncer._factory.keywords["device"].type == "cuda"
        d.stop()
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        daemon.Daemon(state_dir=str(state), node_name=NODE)
    assert not state.exists()
    env = dict(os.environ, NODE_NAME=NODE)
    env.pop("INFW_BACKEND", None)
    proc = subprocess.run([sys.executable, "-m", "infw_torch.daemon", "--state-dir", str(state)],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "CUDA" in proc.stderr


def test_help_runs():
    proc = subprocess.run([sys.executable, "-m", "infw_torch.daemon", "--help"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "--wire-codec" in proc.stdout
    assert "item 15" in proc.stdout  # --mesh says where it is queued


@pytest.mark.parametrize("flag,env,item", daemon.REFUSED_FLAGS,
                         ids=[f for f, _e, _i in daemon.REFUSED_FLAGS])
def test_refused_flags_name_their_roadmap_item(tmp_path, capsys, monkeypatch, flag, env, item):
    for _f, e, _i in daemon.REFUSED_FLAGS:
        monkeypatch.delenv(e, raising=False)
    argv = ["--state-dir", str(tmp_path / "s"), "--node-name", NODE, "--backend", "cpu"]
    with pytest.raises(SystemExit) as e:
        daemon.main(argv + [flag])
    assert e.value.code == 2
    assert item in capsys.readouterr().err and "ROADMAP.md item" in item
    # the environment variable asks for the same option
    # (these two name an option that "0" turns off)
    monkeypatch.setenv(env, "0" if env in ("INFW_FUSED_DEEP", "INFW_H2D_OVERLAP") else "1")
    with pytest.raises(SystemExit):
        daemon.main(argv)
    assert item in capsys.readouterr().err
    assert not (tmp_path / "s").exists()


@pytest.mark.parametrize("via", ["flag", "env"])
def test_flow_table_starts_a_daemon_with_a_tier(tmp_path, monkeypatch, via):
    """--flow-table N (or INFW_FLOW_TABLE, with INFW_FLOW_WAYS and
    INFW_FLOW_MAX_AGE) reaches the daemon as a FlowConfig; a bad geometry
    fails the launch with a usage error."""
    for _f, e, _i in daemon.REFUSED_FLAGS:
        monkeypatch.delenv(e, raising=False)
    seen = {}

    class Stub:
        def __init__(self, **kw):
            seen.update(kw)
            raise SystemExit(0)

    monkeypatch.setattr(daemon, "Daemon", Stub)
    argv = ["--state-dir", str(tmp_path / "s"), "--node-name", NODE, "--backend", "cpu"]
    monkeypatch.setenv("INFW_FLOW_WAYS", "2")
    monkeypatch.setenv("INFW_FLOW_MAX_AGE", "77")
    if via == "flag":
        argv += ["--flow-table", "1000"]
    else:
        monkeypatch.setenv("INFW_FLOW_TABLE", "1000")
    with pytest.raises(SystemExit) as e:
        daemon.main(argv)
    assert e.value.code == 0
    assert seen["flow_table"] == daemon.FlowConfig(entries=1024, ways=2, max_age=77)
    monkeypatch.setenv("INFW_FLOW_WAYS", "9")
    with pytest.raises(SystemExit) as e:
        daemon.main(argv)
    assert e.value.code == 2
    assert "--flow-table" not in [f for f, _e, _i in daemon.REFUSED_FLAGS]


def test_overlay_routing_follows_the_reference(tmp_path):
    """TorchClassifier supports_overlay, so a structurally new key on a
    trie-scale table goes to the overlay as in the JAX syncer; the verdicts
    then still equal the JAX daemon's."""
    jd, pd = _daemons(tmp_path)
    try:
        doc = _nodestate(4400, seed=8)
        for d in (jd, pd):
            _write_state(d, doc)
            d.scan_nodestates_once()
        doc2 = json.loads(json.dumps(doc))
        doc2["spec"]["interfaceIngressRules"]["dummy0"][0]["sourceCIDRs"] += [
            "198.51.100.7/32", "2001:db8:77::/48"]
        for d in (jd, pd):
            _write_state(d, doc2)
            os.utime(os.path.join(d.nodestates_dir, f"{NODE}.json"), (1, 1))
            d.scan_nodestates_once()
        assert sorted(pd.syncer._overlay) == sorted(jd.syncer._overlay) and len(pd.syncer._overlay) == 2
        assert pd.syncer.classifier._active.ov is not None
        assert os.path.exists(os.path.join(pd.state_dir, "checkpoint", "overlay.json"))
        fbs = _frames(doc2, seed=9, sizes=(600,))
        for d in (jd, pd):
            _drop(d, fbs)
            assert d.process_ingest_once() == 1
        assert _out_files(pd) == _out_files(jd)
    finally:
        _stop(jd, pd)


def test_pad_to_and_expand_wire_v4_match_the_reference():
    """The bucket padding of the daemon's jobs: KIND_OTHER rows that PASS
    and count nowhere, the same rows as the JAX package's pad_to; and the
    4-word wire widened to 7 words as its expand_wire_v4 does."""
    from infw import packets as jax_packets
    from infw_torch import packets, oracle

    rng = np.random.default_rng(10)
    tables = testing.random_tables_fast(rng, 200)
    b = testing.random_batch_fast(rng, tables, 100)
    jb = jax_packets.PacketBatch(**{f: getattr(b, f).copy() for f in packets._FIELDS})
    padded = b.pad_to(128)
    assert b.pad_to(100) is b and b.pad_to(50) is b
    for f in packets._FIELDS:
        np.testing.assert_array_equal(getattr(padded, f), getattr(jb.pad_to(128), f), err_msg=f)
    out = oracle.classify(tables, padded)
    np.testing.assert_array_equal(out.results[:100], oracle.classify(tables, b).results)
    assert (out.results[100:] == 0).all() and (out.xdp[100:] == 2).all()
    assert out.stats == oracle.classify(tables, b).stats
    v4 = b.take(np.nonzero(b.kind == 1)[0])
    w = v4.pack_wire_v4()
    np.testing.assert_array_equal(packets.expand_wire_v4(w), jax_packets.expand_wire_v4(w))
    np.testing.assert_array_equal(packets.expand_wire_v4(w), v4.pack_wire())


# --- edit files -----------------------------------------------------------

#: v4-only NodeStates (an IPv6 key_add then exceeds the trie depth and
#: escalates): the dense path, and above 4096 entries the trie and ctrie
EDIT_PATHS = {"dense": (60, False), "trie": (6600, False), "ctrie": (6600, True)}
_STALENESS_LINE = re.compile(r"worst staleness \d+us")
_DIRTY_LINE = re.compile(r"-> \d+ dirty row\(s\)")


def _v4_nodestate(n_cidrs: int, seed: int) -> dict:
    doc = _nodestate(n_cidrs, seed)
    for blocks in doc["spec"]["interfaceIngressRules"].values():
        for block in blocks:
            block["sourceCIDRs"] = [c for c in block["sourceCIDRs"] if ":" not in c]
        blocks[:] = [b for b in blocks if b["sourceCIDRs"]]
    return doc


def _edit_both(jd, pd, name: str, ops) -> None:
    """The same ops as an edit file in each daemon's edits/, written by
    each package's codec (the bytes must be equal)."""
    jax_txn.write_edit_file(os.path.join(jd.edits_dir, name),
                            [jax_txn.op_from_json(txn.op_to_json(op)) for op in ops])
    txn.write_edit_file(os.path.join(pd.edits_dir, name), ops)
    assert (open(os.path.join(jd.edits_dir, name), "rb").read()
            == open(os.path.join(pd.edits_dir, name), "rb").read())


def _flush(d, n_ops: int) -> None:
    """Scan, force a flush and join it; the dirty-row counter grows by
    exactly the rows the flush's load reports."""
    before = d.txn_stats.snapshot()["dirty_rows"]
    assert d.scan_edits_once() == n_ops
    assert d._maybe_flush_edits(force=True)
    d._edit_flush_thread.join(timeout=300)
    assert not d._edit_flush_thread.is_alive()
    assert d.txn_stats.snapshot()["dirty_rows"] - before == d.syncer.classifier._last_load[1]


def _txn_view(text: str, trie: bool) -> tuple:
    """/metrics or events.log text with the timing-dependent values (the
    staleness histogram's buckets, the worst staleness) masked, and on the
    trie path the dirty-row counts (K2's own arrays, ROADMAP.md section 3);
    returns (masked text, the histogram's total)."""
    total, out = 0, []
    for line in text.splitlines(keepends=True):
        if "_patch_txn_staleness_us_bucket_" in line and not line.startswith("#"):
            name, value = line.split()
            total += int(value)
            line = f"{name} <n>\n"
        elif trie and "_patch_txn_dirty_rows_total " in line:
            line = line.split()[0] + " <rows>\n"
        line = _STALENESS_LINE.sub("worst staleness <us>", line)
        if trie:
            line = _DIRTY_LINE.sub("-> <rows> dirty row(s)", line)
        out.append(line)
    return "".join(out), total


def _agree(jd, pd, path: str, doc, seed: int, tables=None) -> None:
    """One frames file through both daemons; out files, statistics, the
    events (deny and patch-txn lines, spill rows) and /metrics equal, the
    timing-dependent values compared by their totals."""
    fbs = _frames(doc, seed=seed, sizes=(2500,), tables=tables)
    for d in (jd, pd):
        for fn in os.listdir(d.out_dir):
            os.remove(os.path.join(d.out_dir, fn))
        _drop(d, fbs, prefix=f"s{seed}-")
        assert d.process_ingest_once() == 1
    assert _out_files(pd) == _out_files(jd)
    jclf, pclf = jd.syncer.classifier, pd.syncer.classifier
    np.testing.assert_array_equal(pclf.stats.snapshot(), jclf.stats.snapshot())
    (jev, jspill), (pev, pspill) = _events(jd), _events(pd)
    assert pspill == jspill
    assert _txn_view(pev, path == "trie") == _txn_view(jev, path == "trie")
    ptext = _metrics(pd, pclf, _threads.reset_crash_counters)
    jtext = _metrics(jd, jclf, jax_threads.reset_crash_counters)
    if path == "ctrie":  # the depth-class padding difference, as above
        ptext, jtext = ("".join(l for l in t.splitlines(keepends=True) if "_node_wire_" not in l)
                        for t in (ptext, jtext))
    assert _txn_view(ptext, path == "trie") == _txn_view(jtext, path == "trie")


def _replayed_content(syncer_cls, ck_dir) -> dict:
    """What a restart re-adopts: the checkpoint's base, its journal
    replayed, and the overlay sidecar, by masked identity."""
    s = syncer_cls(classifier_factory=lambda: None, checkpoint_dir=ck_dir)
    tables, _attached = s._load_checkpoint()
    s._load_overlay({k.masked_identity() for k in tables.content})
    out = {k.masked_identity(): np.asarray(v).tolist() for k, v in tables.content.items()}
    out.update({k.masked_identity(): np.asarray(v).tolist() for k, v in s._overlay.items()})
    return out


@pytest.mark.parametrize("path", sorted(EDIT_PATHS))
def test_daemons_apply_the_same_edit_files(tmp_path, monkeypatch, path):
    n_cidrs, compressed = EDIT_PATHS[path]
    # a small overlay cap, so a burst of new CIDRs spills into the main table
    for cls in (jax_syncer.DataplaneSyncer, syncer.DataplaneSyncer):
        monkeypatch.setattr(cls, "OVERLAY_CAP", 8)
    jd, pd = _daemons(tmp_path, compressed=compressed)
    try:
        doc = _v4_nodestate(n_cidrs, seed=11)
        keys = list(_compile(doc).content)
        width = 8
        rng = np.random.default_rng(12)
        rules = lambda: testing.random_rules(rng, width)
        ifx = sorted(IFACES.values())
        fresh = [compiler.LpmKey(56, ifx[i % 3], bytes([198, 51, i, 0]) + bytes(12))
                 for i in range(40)]

        # 1. edits queued before the first NodeState, beside a bad file, a
        # generator's manifest sidecar and a file still being written
        _edit_both(jd, pd, "a0.json", [txn.EditOp("rules_edit", keys[i], rules())
                                       for i in range(3)])
        for d in (jd, pd):
            for name, body in (("a1-bad.json", "{not json"), ("churn-manifest.json", "{}"),
                               ("a2.json.tmp", "{}")):
                with open(os.path.join(d.edits_dir, name), "w") as f:
                    f.write(body)
            assert d.scan_edits_once() == 3
            assert not d._maybe_flush_edits(force=True)  # no dataplane yet: kept queued
            assert sorted(os.listdir(d.edits_dir)) == ["a2.json.tmp", "churn-manifest.json"]
            _write_state(d, doc)
            d.scan_nodestates_once()
            assert d._maybe_flush_edits(force=True)
            d._edit_flush_thread.join(timeout=300)
        assert pd.syncer.classifier.active_path == path
        _agree(jd, pd, path, doc, seed=13)

        # 2. every kind, and the fold: an add then a delete of a new key
        # annihilates, a delete then a re-add of a live key is an upsert,
        # the last of two edits of one key wins
        ops = [txn.EditOp("key_add", fresh[0], rules()),
               txn.EditOp("cidr_add", fresh[1], rules()),
               txn.EditOp("cidr_add", fresh[2], rules()),
               txn.EditOp("key_delete", keys[3]),
               txn.EditOp("rules_edit", keys[4], rules()),
               txn.EditOp("order_change", keys[5], rules()),
               txn.EditOp("cidr_add", fresh[3], rules()),
               txn.EditOp("key_delete", fresh[3]),
               txn.EditOp("key_delete", keys[6]),
               txn.EditOp("key_add", keys[6], rules()),
               txn.EditOp("rules_edit", keys[7], rules()),
               txn.EditOp("rules_edit", keys[7], rules())]
        _edit_both(jd, pd, "b0.json", ops)
        for d in (jd, pd):
            _flush(d, len(ops))
        assert sorted(pd.syncer._overlay) == sorted(jd.syncer._overlay)
        assert len(pd.syncer._overlay) == (0 if path == "dense" else 2)
        assert pd.txn_stats.snapshot()["folded"] == 4
        live = compiler.compile_tables_from_content(dict(pd.syncer._content), rule_width=width)
        _agree(jd, pd, path, doc, seed=14, tables=live)

        # 3. ten more new CIDRs in two files, one transaction: the overlay
        # (cap 8) spills into the main table
        _edit_both(jd, pd, "c0.json", [txn.EditOp("cidr_add", k, rules()) for k in fresh[4:9]])
        _edit_both(jd, pd, "c1.json", [txn.EditOp("cidr_add", k, rules()) for k in fresh[9:14]])
        for d in (jd, pd):
            _flush(d, 10)
            assert d.syncer._overlay == {}  # the two it held spilled with the rest
        live = compiler.compile_tables_from_content(dict(pd.syncer._content), rule_width=width)
        _agree(jd, pd, path, doc, seed=15, tables=live)

        # 4. a restart: both journals hold the same records, and what each
        # re-adopts (base + journal + overlay sidecar) is the edited content
        cks = [os.path.join(d.state_dir, "checkpoint") for d in (jd, pd)]
        journals = [sorted(os.listdir(os.path.join(ck, "journal"))) for ck in cks]
        assert journals[0] == journals[1] and len(journals[0]) == 3
        for fn in journals[0]:
            assert (open(os.path.join(cks[0], "journal", fn), "rb").read()
                    == open(os.path.join(cks[1], "journal", fn), "rb").read())
        want = {k.masked_identity(): np.asarray(v).tolist() for k, v in pd.syncer._content.items()}
        assert _replayed_content(syncer.DataplaneSyncer, cks[1]) == want
        assert _replayed_content(jax_syncer.DataplaneSyncer, cks[0]) == want
        _stop(jd, pd)
        jd, pd = _daemons(tmp_path, compressed=compressed)
        for d in (jd, pd):
            d.scan_nodestates_once()  # re-adopts, then converges to the NodeState
        _agree(jd, pd, path, doc, seed=16)

        # 5. an IPv6 key beyond the v4-only trie's depth: the flush escalates
        # to a rebuild, the old generation serving until the swap
        v6 = compiler.LpmKey(32 + 64, ifx[0], bytes(range(16)))
        _edit_both(jd, pd, "d0.json", [txn.EditOp("key_add", v6, rules()),
                                       txn.EditOp("rules_edit", keys[8], rules())])
        for d in (jd, pd):
            _flush(d, 2)
            assert d.txn_stats.snapshot()["escalations"] == 1
        live = compiler.compile_tables_from_content(dict(pd.syncer._content), rule_width=width)
        _agree(jd, pd, path, doc, seed=17, tables=live)
    finally:
        _stop(jd, pd)


def test_edit_file_repro_of_the_ignored_edits(tmp_path):
    """The seeded repro of the port's daemon ignoring edit files: 64 keys
    deleted by an edit file on the trie path, then 3000 frames; every
    verdict equals the JAX daemon's and edits/ is empty after the scan."""
    jd, pd = _daemons(tmp_path)
    try:
        doc = _nodestate(4400, seed=3)
        for d in (jd, pd):
            _write_state(d, doc)
            d.scan_nodestates_once()
        assert pd.syncer.classifier.active_path == "trie"
        ops = [txn.EditOp("key_delete", k) for k in list(jd.syncer.classifier.tables.content)[:64]]
        _edit_both(jd, pd, "e0.json", ops)
        for d in (jd, pd):
            _flush(d, 64)
            assert os.listdir(d.edits_dir) == []
        fbs = _frames(doc, seed=4, sizes=(3000,))
        for d in (jd, pd):
            _drop(d, fbs)
            assert d.process_ingest_once() == 1
        jres, pres = (np.fromfile(os.path.join(d.out_dir, "f0.frames.verdicts.bin"), "<u4")
                      for d in (jd, pd))
        assert len(pres) == 3000 and int((jres != pres).sum()) == 0
        assert _out_files(pd) == _out_files(jd)
    finally:
        _stop(jd, pd)


def test_flush_lands_between_ingest_admissions(tmp_path):
    """A tripped flush starts inside the ingest tick (between admissions):
    jobs launched before it keep their generation, later ones read the
    patched tables; the file's verdicts are each packet's old or new
    oracle verdict, and a file after the flush reads the new one only."""
    from infw_torch import oracle

    _, preg = _registries()
    d = daemon.Daemon(state_dir=str(tmp_path / "state"), node_name=NODE, backend="cpu",
                      poll_period_s=3600.0, registry=preg, metrics_port=0, health_port=0,
                      file_poll_interval_s=60.0, ingest_chunk=CHUNK, pipeline_depth=2,
                      patch_max_ops=4)
    try:
        doc = _nodestate(4400, seed=21)
        _write_state(d, doc)
        d.scan_nodestates_once()
        old = _compile(doc)
        keys = list(d.syncer.classifier.tables.content)
        rng = np.random.default_rng(22)
        ops = [txn.EditOp("rules_edit", k, testing.random_rules(rng, 8)) for k in keys[:200:50]]
        txn.write_edit_file(os.path.join(d.edits_dir, "e.json"), ops)
        assert d.scan_edits_once() == 4 and d.txn_batcher.should_flush() == "batch"
        new_content = dict(old.content)
        new_content.update({op.key: op.rules for op in ops})
        new = compiler.compile_tables_from_content(new_content, rule_width=8)
        fbs = _frames(doc, seed=23, sizes=(3000,), tables=new)
        _drop(d, fbs)
        assert d.process_ingest_once() == 1  # the flush started in this tick
        d._edit_flush_thread.join(timeout=300)
        assert d.txn_stats.snapshot()["reasons"] == {"batch": 1}
        got = np.fromfile(os.path.join(d.out_dir, "f0.frames.verdicts.bin"), "<u4")
        batch = pcap.parse_frames_buf(fbs[0])
        ro, rn = oracle.classify(old, batch).results, oracle.classify(new, batch).results
        assert ((got == ro) | (got == rn)).all() and not np.array_equal(ro, rn)
        _drop(d, fbs, prefix="g")
        assert d.process_ingest_once() == 1
        np.testing.assert_array_equal(
            np.fromfile(os.path.join(d.out_dir, "g0.frames.verdicts.bin"), "<u4"), rn)
    finally:
        d.stop()


def test_patch_flags_reach_the_batcher(tmp_path, monkeypatch):
    """--patch-staleness-us / --patch-max-ops (and their environment
    variables) reach the daemon's TxnBatcher; a non-positive value fails
    the launch."""
    made = []

    class Started(Exception):
        pass

    def start(self):
        made.append(self)
        raise Started

    monkeypatch.setattr(daemon.Daemon, "start", start)
    monkeypatch.setattr(daemon.signal, "signal", lambda *a: None)
    for _f, e, _i in daemon.REFUSED_FLAGS:
        monkeypatch.delenv(e, raising=False)
    base = ["--node-name", NODE, "--backend", "cpu", "--metrics-port", "0", "--health-port", "0"]
    cases = ((["--patch-staleness-us", "500", "--patch-max-ops", "64"], {}, 500e-6, 64),
             ([], {"INFW_PATCH_STALENESS_US": "750", "INFW_PATCH_MAX_OPS": "9"}, 750e-6, 9),
             ([], {}, txn.DEFAULT_STALENESS_US * 1e-6, txn.DEFAULT_MAX_OPS))
    for i, (flags, env, staleness_s, max_ops) in enumerate(cases):
        for k in ("INFW_PATCH_STALENESS_US", "INFW_PATCH_MAX_OPS"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        with pytest.raises(Started):
            daemon.main(["--state-dir", str(tmp_path / f"s{i}")] + base + flags)
        d = made.pop()
        try:
            assert d.txn_batcher.staleness_s == pytest.approx(staleness_s)
            assert d.txn_batcher.max_ops == max_ops
            assert os.path.isdir(d.edits_dir)
        finally:
            d.stop()
    for bad in (["--patch-staleness-us", "0"], ["--patch-max-ops", "0"]):
        with pytest.raises(SystemExit) as e:
            daemon.main(["--state-dir", str(tmp_path / "bad")] + base + bad)
        assert e.value.code == 2
    assert not (tmp_path / "bad").exists()


@pytest.mark.parametrize("compressed", [False, True], ids=["trie", "ctrie"])
def test_edits_after_readoption(tmp_path, compressed):
    """A restart re-adopts the checkpoint, and the first sync finds the
    NodeState unchanged, so no incremental state exists.  The port builds it
    on the first edit and applies the file; the JAX daemon drops the whole
    transaction with an error (a fault of the reference, ROADMAP.md section
    3).  The port's verdicts then equal the oracle of the edited content,
    the JAX daemon's that of the unedited one."""
    from infw_torch import oracle

    jd, pd = _daemons(tmp_path, compressed=compressed)
    try:
        doc = _nodestate(4400, seed=25)
        for d in (jd, pd):
            _write_state(d, doc)
            d.scan_nodestates_once()
        _stop(jd, pd)
        jd, pd = _daemons(tmp_path, compressed=compressed)
        for d in (jd, pd):
            d.scan_nodestates_once()
            assert d.syncer._updater is None  # re-adopted, content unchanged
        old = _compile(doc)
        keys = list(old.content)
        rng = np.random.default_rng(26)
        ops = ([txn.EditOp("rules_edit", k, testing.random_rules(rng, 8)) for k in keys[:40]]
               + [txn.EditOp("key_delete", k) for k in keys[40:80]]
               + [txn.EditOp("cidr_add", compiler.LpmKey(56, 10, bytes([198, 51, i, 0]) + bytes(12)),
                             testing.random_rules(rng, 8)) for i in range(5)])
        _edit_both(jd, pd, "e.json", ops)
        for d in (jd, pd):
            assert d.scan_edits_once() == len(ops)
            assert d._maybe_flush_edits(force=True)
            d._edit_flush_thread.join(timeout=300)
        assert jd.txn_stats.snapshot()["txns"] == 0  # dropped with a logged error
        assert pd.txn_stats.snapshot()["txns"] == 1 and len(pd.syncer._overlay) == 5
        new = compiler.compile_tables_from_content(dict(pd.syncer._content), rule_width=8)
        fbs = _frames(doc, seed=27, sizes=(2000,), tables=new)
        for d in (jd, pd):
            _drop(d, fbs)
            assert d.process_ingest_once() == 1
        batch = pcap.parse_frames_buf(fbs[0])
        got = {id(d): np.fromfile(os.path.join(d.out_dir, "f0.frames.verdicts.bin"), "<u4")
               for d in (jd, pd)}
        np.testing.assert_array_equal(got[id(pd)], oracle.classify(new, batch).results)
        np.testing.assert_array_equal(got[id(jd)], oracle.classify(old, batch).results)
    finally:
        _stop(jd, pd)
