"""The port's edit transactions (infw_torch.txn) on the CPU against the JAX
package's (infw.txn): the fold and the overlay routing on the statecheck
model checker's op sequences and on the fold's edge cases, the batcher's
flush policy under an injected clock, the counters, the edit-file codec
both ways with its error classes, and TxnApplier on TorchClassifier(
device="cpu") against TxnApplier on TpuClassifier(interpret=True) on the
dense, trie and ctrie paths, including an escalated rebuild: after every
flush the reports, verdicts, statistics and counters are equal, and the
port's resident tables equal a cold padded build.  Also: a flush landing
between prepare_packed and classify_prepared leaves that job on the old
generation, bit for bit, and the port's edit-stream generator draws the
JAX package's tools/churngen.py stream.  Every comparison is exact."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from infw import compiler as jax_compiler
from infw import txn as jax_txn
from infw.analysis import statecheck
from infw.backend.tpu import TpuClassifier
from infw.obs import events as jax_events
from infw_torch import compiler, oracle, testing, txn
from infw_torch.backend.cuda import TorchClassifier
from infw_torch.kernels import cwalk, dense, walk
from infw_torch.obs import events

REPO = Path(__file__).resolve().parents[1]
WIDTH = 8


def _pkey(k):
    return compiler.LpmKey(*k)


def _jkey(k):
    return jax_compiler.LpmKey(*k)


def _port_ops(ops):
    return [txn.EditOp(op.kind, _pkey(op.key), None if op.rules is None else np.asarray(op.rules))
            for op in ops]


def _jax_ops(ops):
    return [jax_txn.EditOp(op.kind, _jkey(op.key), None if op.rules is None else np.asarray(op.rules))
            for op in ops]


def _folded_view(f):
    return (f.n_ops, f.n_folded,
            {tuple(k): np.asarray(v).tolist() for k, v in f.upserts.items()},
            {tuple(k): (np.asarray(r).tolist(), kind) for k, (r, kind) in f.new_keys.items()},
            [tuple(k) for k in f.deletes])


def _dict_view(d):
    return [(tuple(k), np.asarray(v).tolist()) for k, v in d.items()]


def _transactions(config: str, seed: int):
    """statecheck.generate_ops' sequence for ``config``, cut into
    transactions at its flush boundaries, only the single-key edit kinds."""
    cfg = statecheck.CONFIGS[config]
    rng = np.random.default_rng(seed)
    base = statecheck.make_content(cfg, rng)
    ops = statecheck.generate_ops(rng, cfg, base, 160)
    txns, cur = [], []
    for op in ops:
        if op.kind == statecheck.TXN_FLUSH:
            txns.append(cur)
            cur = []
        elif op.kind in txn.TXN_EDIT_KINDS:
            cur.append(op)
    txns.append(cur)
    return base, [t for t in txns if t]


@pytest.mark.parametrize("config", ["txn", "txn-overlay", "txn-ctrie"])
def test_fold_and_route_match_the_reference(config):
    """Both packages fold the model checker's op sequences to the same net
    effect and route it against the same overlay (a cap of 3, so it spills)
    to the same main-table upserts, deletes and overlay."""
    base, txns = _transactions(config, seed=31)
    live = {k.masked_identity(): k for k in base}
    p_ov, j_ov = {}, {}
    spills = 0
    for t in txns:
        existing = set(live)
        pf = txn.fold_ops(_port_ops(t), existing)
        jf = jax_txn.fold_ops(_jax_ops(t), existing)
        assert _folded_view(pf) == _folded_view(jf)
        ov_before = len(p_ov)
        p_route = txn.route_folded(pf, p_ov, True, 3)
        j_route = jax_txn.route_folded(jf, j_ov, True, 3)
        assert (_dict_view(p_route[0]), [tuple(k) for k in p_route[1]], p_route[2]) == \
            (_dict_view(j_route[0]), [tuple(k) for k in j_route[1]], j_route[2])
        assert _dict_view(p_ov) == _dict_view(j_ov)
        adds = sum(k == "cidr_add" for _r, k in pf.new_keys.values())
        spills += ov_before + adds > 3
        for k in pf.deletes:
            live.pop(k.masked_identity(), None)
        for k in list(pf.upserts) + list(pf.new_keys):
            live[k.masked_identity()] = k
    assert len(txns) > 5 and spills > 0


def test_fold_edge_cases_match_the_reference():
    """Delete then re-add of a live key is an upsert of the re-add's rules;
    add then delete of a new key annihilates; a later edit supersedes an
    earlier one; a cidr_add burst past the overlay cap spills the whole
    overlay into the main table and routes the rest there too."""
    rng = np.random.default_rng(5)
    live = [compiler.LpmKey(56, 2, bytes([10, i, 0, 0]) + bytes(12)) for i in range(4)]
    new = [compiler.LpmKey(56, 3, bytes([192, 0, i, 0]) + bytes(12)) for i in range(8)]
    r = lambda: testing.random_rules(rng, WIDTH)
    ops = [txn.EditOp("key_delete", live[0]), txn.EditOp("key_add", live[0], r()),
           txn.EditOp("key_add", new[0], r()), txn.EditOp("key_delete", new[0]),
           txn.EditOp("rules_edit", live[1], r()), txn.EditOp("order_change", live[1], r()),
           txn.EditOp("key_delete", live[2])]
    ops += [txn.EditOp("cidr_add", k, r()) for k in new[1:]]
    existing = {k.masked_identity() for k in live}
    pf = txn.fold_ops(ops, existing)
    jf = jax_txn.fold_ops(_jax_ops(ops), existing)
    assert _folded_view(pf) == _folded_view(jf)
    assert pf.n_ops == 14 and pf.n_folded == 4
    assert set(pf.upserts) == {live[0], live[1]} and pf.deletes == [live[2]]
    np.testing.assert_array_equal(pf.upserts[live[0]], ops[1].rules)
    np.testing.assert_array_equal(pf.upserts[live[1]], ops[5].rules)
    assert new[0] not in pf.new_keys
    p_ov = {live[3]: r()}  # an overlay-resident key
    j_ov = {_jkey(k): v for k, v in p_ov.items()}
    pr = txn.route_folded(pf, p_ov, True, 4)
    jr = jax_txn.route_folded(jf, j_ov, True, 4)
    assert (_dict_view(pr[0]), [tuple(k) for k in pr[1]], pr[2]) == \
        (_dict_view(jr[0]), [tuple(k) for k in jr[1]], jr[2])
    assert p_ov == {} and j_ov == {}  # spilled at the fourth new key
    assert set(pr[0]) == {live[0], live[1], live[3]} | set(new[1:])
    with pytest.raises(ValueError, match="cannot fold"):
        txn.fold_ops([statecheck.EditOp(kind="full_replace")], set())
    for bad in (("nope", live[0], r()), ("key_add", live[0], None)):
        with pytest.raises(ValueError):
            txn.EditOp(*bad)
        with pytest.raises(ValueError):
            jax_txn.EditOp(bad[0], _jkey(bad[1]), bad[2])


def test_batcher_flush_policy_matches_the_reference():
    """should_flush under an injected clock: nothing queued, under the
    deadline, past it, the batch threshold before the deadline; drain
    hands back the enqueue times; bad settings raise alike."""
    now = {"t": 100.0}
    clock = lambda: now["t"]
    batchers = [m.TxnBatcher(staleness_s=0.002, max_ops=5, clock=clock) for m in (txn, jax_txn)]
    trace = [[] for _ in batchers]
    steps = [("check", 0), ("queue", 2), ("tick", 0.001), ("check", 0), ("tick", 0.0011),
             ("check", 0), ("drain", 0), ("queue", 4), ("check", 0), ("queue", 1), ("check", 0),
             ("drain", 0), ("queue_at", 99.0), ("check", 0), ("drain", 0)]
    for step, arg in steps:
        if step == "tick":
            now["t"] += arg
            continue
        for b, out in zip(batchers, trace):
            if step == "check":
                out.append((b.should_flush(), len(b), round(b.oldest_age(), 9)))
            elif step == "queue":
                b.queue_many([f"op{i}" for i in range(arg)])
            elif step == "queue_at":
                b.queue("late", now=arg)
            else:
                out.append(b.drain())
    assert trace[0] == trace[1]
    assert [t[0] for t in trace[0] if isinstance(t, tuple)] == [None, None, "deadline", None,
                                                               "batch", "deadline"]
    for m in (txn, jax_txn):
        for kw in ({"staleness_s": 0}, {"max_ops": 0}):
            with pytest.raises(ValueError):
                m.TxnBatcher(**kw)


def test_txn_stats_counters_match_the_reference():
    """counter_values and snapshot after the same flushes, staleness on
    and around every bucket bound."""
    stats = [txn.TxnStats(), jax_txn.TxnStats()]
    flushes = [(64, 3, 120, "batch", False, [0.0, 1e-4, 1.0001e-4, 0.005]),
               (1, 0, 0, "deadline", True, [0.01, 0.1, 0.5, 1.0, 2.0]),
               (7, 7, 0, "manual", False, []),
               (2, 1, 9, "batch", False, [1e-3, 1.5e-3])]
    for s in stats:
        for f in flushes:
            s.note_flush(*f[:5], staleness_s=f[5])
    assert stats[0].counter_values() == stats[1].counter_values()
    assert stats[0].snapshot() == stats[1].snapshot()
    assert stats[0].counter_values()["patch_txn_flush_batch_total"] == 2
    assert sum(stats[0].snapshot()["staleness_hist"]) == 11


def test_edit_file_codec_both_ways(tmp_path):
    """A file the JAX package writes reads back in the port and the port
    writes it again byte for byte, and the other way round; a bad file
    raises the same error class in both readers."""
    rng = np.random.default_rng(7)
    table = testing.random_tables_fast(rng, 300, width=WIDTH)
    ops = testing.generate_edit_ops(rng, 120, table, WIDTH)
    assert {op.kind for op in ops} == {"rules_edit", "cidr_add", "key_delete", "key_add"}
    txn.write_edit_file(str(tmp_path / "p.json"), ops)
    jax_txn.write_edit_file(str(tmp_path / "j.json"), _jax_ops(ops))
    assert (tmp_path / "p.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    back = txn.read_edit_file(str(tmp_path / "j.json"))
    txn.write_edit_file(str(tmp_path / "p2.json"), back)
    assert (tmp_path / "p2.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    jback = jax_txn.read_edit_file(str(tmp_path / "p.json"))
    jax_txn.write_edit_file(str(tmp_path / "j2.json"), jback)
    assert (tmp_path / "j2.json").read_bytes() == (tmp_path / "p.json").read_bytes()
    for a, b in zip(back, ops):
        assert (a.kind, a.key) == (b.kind, b.key)
        assert (a.rules is None) == (b.rules is None)
        if a.rules is not None:
            assert a.rules.dtype == np.int32
            np.testing.assert_array_equal(a.rules, b.rules)
    good = txn.op_to_json(ops[0])
    bad = {
        "not json": "{ops:",
        "no ops": json.dumps({"edits": []}),
        "ops not a list": json.dumps({"ops": 5}),
        "op not a dict": json.dumps({"ops": [5]}),
        "missing field": json.dumps({"ops": [{k: v for k, v in good.items() if k != "ip"}]}),
        "bad hex": json.dumps({"ops": [dict(good, ip="zz")]}),
        "unknown kind": json.dumps({"ops": [dict(good, kind="flush")]}),
        "no rules": json.dumps({"ops": [{k: v for k, v in dict(good, kind="cidr_add").items()
                                         if k != "rules"}]}),
        "bad prefix": json.dumps({"ops": [dict(good, prefix_len="x")]}),
    }
    for label, body in bad.items():
        path = tmp_path / "bad.json"
        path.write_text(body)
        errs = []
        for reader in (txn.read_edit_file, jax_txn.read_edit_file):
            with pytest.raises(Exception) as e:
                reader(str(path))
            errs.append(type(e.value))
        assert errs[0] is errs[1], label
        assert issubclass(errs[0], (ValueError, KeyError, TypeError)), label


def test_edit_stream_generator_keeps_the_churngen_mix():
    """testing.generate_edit_ops draws tools/churngen.py's OP_MIX: replayed
    on the live key set, every rules edit and delete hits a live identity,
    every re-add (key_add) a deleted one and every cidr_add a new /24; the
    kinds come in the mix's shares, where churngen's own stream, whose
    cidr_add serial sits in the byte the /24 masks away, holds almost none.
    Up to its first cidr_add, churngen draws the same stream."""
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import churngen
    finally:
        sys.path.remove(str(REPO / "tools"))
    from infw import testing as jax_testing

    assert testing.EDIT_OP_MIX == churngen.OP_MIX
    n = 4000
    pt = testing.random_tables_fast(np.random.default_rng(3), 400, width=WIDTH)
    got = testing.generate_edit_ops(np.random.default_rng(4), n, pt, WIDTH)
    live = {k.masked_identity() for k in pt.content}
    deleted = set()
    for op in got:
        ident = op.key.masked_identity()
        if op.kind in ("rules_edit", "key_delete"):
            assert ident in live
        elif op.kind == "key_add":
            assert ident in deleted and ident not in live
        else:
            assert op.kind == "cidr_add" and ident not in live and ident not in deleted
            assert op.key.prefix_len == 56 and op.key.ingress_ifindex == 2
        if op.kind == "key_delete":
            live.discard(ident)
            deleted.add(ident)
        else:
            live.add(ident)
            deleted.discard(ident)
    share = {k: sum(op.kind == k for op in got) / n for k in ("rules_edit", "cidr_add", "key_delete",
                                                              "key_add")}
    for (kind, p), key in zip(testing.EDIT_OP_MIX, ("rules_edit", "cidr_add", "key_delete",
                                                   "key_add")):
        assert abs(share[key] - p) < 0.03, (kind, share)
    jt = jax_testing.random_tables_fast(np.random.default_rng(3), 400, width=WIDTH)
    want = churngen.generate_ops(np.random.default_rng(4), n, jt, WIDTH)
    assert sum(op.kind == "cidr_add" for op in want) < 0.01 * n
    first = next(i for i, op in enumerate(got) if op.kind == "cidr_add")
    assert [json.dumps(txn.op_to_json(op)) for op in got[:first]] == \
        [json.dumps(jax_txn.op_to_json(op)) for op in want[:first]]


def _v4_content(seed: int, n: int):
    t = testing.random_tables_fast(np.random.default_rng(seed), n, ifindexes=(2, 3), width=WIDTH,
                                   v6_fraction=0.0)
    return dict(t.content)


def _resident_equals_cold_build(clf, snap, path):
    if path == "dense":
        fresh = dense.build_dense_tables(snap, "cpu")
    elif path == "trie":
        fresh = walk.build_trie_tables(snap, "cpu", pad=True)
    else:
        fresh = cwalk.build_ctrie_tables(snap, "cpu", pad=True)
    dev = clf._active.dev
    for f in fresh._fields:
        a, b = getattr(dev, f), getattr(fresh, f)
        assert (torch.equal(a, b) if isinstance(b, torch.Tensor) else a == b), f


#: (path, entries, overlay_min_main): the trie and ctrie appliers route new
#: CIDRs to the overlay from 100 main entries on, so small tables keep it live
APPLIER_PATHS = {"dense": (300, 4096), "trie": (400, 100), "ctrie": (400, 100)}


@pytest.mark.parametrize("path", sorted(APPLIER_PATHS))
def test_txn_applier_matches_the_reference(path):
    """Four transactions of the generator's op mix, one 40-key cidr_add
    burst past an overlay cap of 16, then an IPv6 key_add beyond the
    v4-only trie's depth (an escalated rebuild): after each flush the two
    appliers' reports agree (dirty rows on the dense and ctrie paths: on
    the trie path each counts its own arrays), the counters and the event
    lines agree up to those rows, the verdicts and statistics are equal and
    match the oracle of the merged content, and the port's resident tables
    equal a cold padded build of its snapshot."""
    n, min_main = APPLIER_PATHS[path]
    content = _v4_content(41, n)
    rng = np.random.default_rng(42)
    pit = compiler.IncrementalTables.from_content(content, rule_width=WIDTH)
    jit = jax_compiler.IncrementalTables.from_content(
        {_jkey(k): v for k, v in content.items()}, rule_width=WIDTH)
    pc = TorchClassifier(device="cpu", force_path=path)
    jc = TpuClassifier(force_path=path, interpret=True, fused_deep=True)
    pc.load_tables(pit.snapshot())
    jc.load_tables(jit.snapshot())
    pit.clear_dirty()
    jit.clear_dirty()
    rings = [events.EventRing(1 << 10), jax_events.EventRing(1 << 10)]
    # one injected clock: every op waited 500 us when its flush started
    clock = lambda: 10.0
    pa = txn.TxnApplier(pc, pit, overlay_cap=16, overlay_min_main=min_main,
                        stats=txn.TxnStats(), ring=rings[0], clock=clock)
    ja = jax_txn.TxnApplier(jc, jit, overlay_cap=16, overlay_min_main=min_main,
                            stats=jax_txn.TxnStats(), ring=rings[1], clock=clock)
    table = compiler.compile_tables_from_content(content, rule_width=WIDTH)
    txns = [testing.generate_edit_ops(rng, 24, table, WIDTH) for _ in range(4)]
    burst = [txn.EditOp("cidr_add", compiler.LpmKey(56, 2 + i % 2, bytes([203, 0, i, 0]) + bytes(12)),
                        testing.random_rules(rng, WIDTH)) for i in range(40)]
    v6 = txn.EditOp("key_add", compiler.LpmKey(32 + 64, 2, bytes(range(16))),
                    testing.random_rules(rng, WIDTH))
    txns += [burst, [v6, txn.EditOp("rules_edit", next(iter(content)), testing.random_rules(rng, WIDTH))]]
    overlays = []
    for i, ops in enumerate(txns):
        pr = pa.apply(ops, reason="batch", enqueue_ts=[10.0 - 5e-4] * len(ops))
        jr = ja.apply(_jax_ops(ops), reason="batch", enqueue_ts=[10.0 - 5e-4] * len(ops))
        assert (pr.n_ops, pr.n_folded, pr.mode, pr.reason, pr.escalated) == \
            (jr.n_ops, jr.n_folded, jr.mode, jr.reason, jr.escalated), i
        if path != "trie":
            assert pr.dirty_rows == jr.dirty_rows, i
        assert pr.escalated == (i == len(txns) - 1), i
        assert _dict_view(pa.overlay) == _dict_view(ja.overlay), i
        overlays.append(len(pa.overlay))
        snap = pa.updater.snapshot()
        assert pc.active_path == jc.active_path == path
        _resident_equals_cold_build(pc, snap, path)
        merged = dict(pa.updater.content)
        merged.update(pa.overlay)
        mt = compiler.compile_tables_from_content(merged, rule_width=WIDTH)
        batch = testing.random_batch_fast(np.random.default_rng(100 + i), mt, 600)
        got, want = pc.classify(batch), jc.classify(batch)
        for f in ("results", "xdp", "stats_delta"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f"{i} {f}")
        np.testing.assert_array_equal(got.results, oracle.classify(mt, batch).results)
    np.testing.assert_array_equal(pc.stats.snapshot(), jc.stats.snapshot())
    if path == "dense":
        assert max(overlays) == 0
    else:
        assert max(overlays) > 0 and overlays[4] == 0  # the burst spilled it
    pv, jv = pa.stats.counter_values(), ja.stats.counter_values()
    if path == "trie":
        pv.pop("patch_txn_dirty_rows_total"), jv.pop("patch_txn_dirty_rows_total")
    assert pv == jv and pv["patch_txn_escalations_total"] == 1
    assert pv["patch_txn_staleness_us_bucket_le_1000"] == sum(len(t) for t in txns)
    lines = [[l for rec in r.pop_all() for l in rec.lines()] for r in rings]
    if path == "trie":
        lines = [[l.split(" -> ")[0] + l.split(" dirty row(s)")[1] for l in ls] for ls in lines]
    assert lines[0] == lines[1] and len(lines[0]) == len(txns)
    jc.close()


@pytest.mark.parametrize("path", ["trie", "ctrie"])
def test_flush_between_prepare_and_classify_reads_the_old_generation(path):
    """A job prepared (its generation snapshotted, its wire staged) before
    a flush and launched after it classifies on the old tables, bit for
    bit; the next job reads the new ones."""
    content = _v4_content(51, 300)
    it = compiler.IncrementalTables.from_content(content, rule_width=WIDTH)
    clf = TorchClassifier(device="cpu", force_path=path)
    clf.load_tables(it.snapshot())
    it.clear_dirty()
    old = TorchClassifier(device="cpu", force_path=path)
    old.load_tables(compiler.compile_tables_from_content(content, rule_width=WIDTH))
    rng = np.random.default_rng(52)
    table = compiler.compile_tables_from_content(content, rule_width=WIDTH)
    batch = testing.random_batch_fast(rng, table, 800, hit_fraction=0.95)
    wire, v4_only = batch.pack_wire_subset(np.arange(len(batch)))
    plan = clf.prepare_packed(wire, v4_only)
    ops = [txn.EditOp("rules_edit", k, testing.random_rules(rng, WIDTH)) for k in list(content)[:150]]
    ops += [txn.EditOp("key_delete", k) for k in list(content)[150:200]]
    applier = txn.TxnApplier(clf, it)
    report = applier.apply(ops)
    assert report.mode in ("patch", "full")
    got = clf.classify_prepared(plan).result()
    want = old.classify_async_packed(wire, v4_only).result()
    for f in ("results", "xdp", "stats_delta"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    after = clf.classify_async_packed(wire, v4_only).result()
    new = compiler.compile_tables_from_content(dict(applier.updater.content), rule_width=WIDTH)
    np.testing.assert_array_equal(after.results, oracle.classify(new, batch).results)
    assert not np.array_equal(after.results, got.results)
