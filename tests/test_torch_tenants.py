"""The port's tenant control plane on the CPU against the JAX package:
TenantRegistry over TorchArenaClassifier against infw.syncer.TenantRegistry
over ArenaClassifier (the same op sequences give the same paths, ids,
counters, classify_mixed results and TenantSwapRecord fields but the
timings), the shared-delta routing to the overlay side-pool, and both
daemons under ``--tenants`` applying the same ``tenants/<name>/edits/``
files.  Integers, tolerance 0."""
import os

import numpy as np
import pytest

import infw.daemon as jax_daemon
import infw.txn as jax_txn
from infw import compiler as jax_compiler
from infw import testing as jax_testing
from infw.backend.tpu import ArenaClassifier
from infw.kernels import jaxpath
from infw.obs import events as jax_events
from infw.syncer import TenantError as JaxTenantError
from infw.syncer import TenantRegistry as JaxRegistry
from infw_torch import arena, compiler, daemon, oracle, syncer, testing, txn
from infw_torch.backend.cuda import TorchArenaClassifier
from infw_torch.obs import events

from test_torch_arena import _jax_batch


def _content(mod, seed, n=14, v6=0.4):
    return dict(mod.random_tables(np.random.default_rng(seed), n_entries=n, width=4,
                                  v6_fraction=v6).content)


def _registries(family="ctrie", pages=8, max_tenants=6, overlay=False, ring=True):
    """Both registries over arenas of one geometry (sized from sample
    tenants with headroom), each with its event ring."""
    samples = [jax_compiler.compile_tables_from_content(_content(jax_testing, s), rule_width=4)
               for s in (10, 11)]
    js = jaxpath.arena_spec_for(family, samples, pages=pages, max_tenants=max_tenants,
                                headroom=3.0)
    ps = arena.ArenaSpec(*js)
    ov = jaxpath.make_arena_spec("dense", pages, max_tenants, 16, 4) if overlay else None
    jc = ArenaClassifier(js, overlay_spec=ov, interpret=True, fused_deep=family == "ctrie")
    pc = TorchArenaClassifier(ps, device="cpu",
                              overlay_spec=arena.ArenaSpec(*ov) if overlay else None)
    jring = jax_events.EventRing(capacity=256) if ring else None
    pring = events.EventRing(capacity=256) if ring else None
    return (JaxRegistry(jc, rule_width=4, event_ring=jring),
            syncer.TenantRegistry(pc, rule_width=4, event_ring=pring), jring, pring)


def _records(ring, cls):
    return [{k: v for k, v in vars(r).items() if k not in ("stage_us", "flip_us")}
            for r in ring.pop_all() if isinstance(r, cls)]


def _ops(mod_txn, content, seed, n):
    """A seeded rules-only edit transaction over ``content``: ``n`` rules
    edits of live keys (the same key twice folds to the last)."""
    rng = np.random.default_rng(seed)
    keys = sorted(content, key=lambda k: (k.ingress_ifindex, k.ip_data, k.prefix_len))
    ops = []
    for i in range(n):
        k = keys[int(rng.integers(len(keys)))]
        r = np.asarray(content[k]).copy()
        r[1] = [1 + i % 200, 6, int(rng.integers(65536)), 0, 0, 0, 1 + i % 2]
        ops.append(mod_txn.EditOp(kind="key_add", key=k, rules=r))
    return ops


def _same_out(jreg, preg, batch, tags):
    got = preg.classify_mixed(batch, tags, apply_stats=False)
    want = jreg.classify_mixed(_jax_batch(batch), tags, apply_stats=False)
    for f in ("results", "xdp", "stats_delta"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    return got


@pytest.mark.parametrize("family", ["ctrie", "dense"])
def test_registry_matches_jax_over_the_same_ops(family):
    """create (two tenants on one content: one shared page), rules-only
    transactions ("patch" on a private page, "cow" on the shared one), a
    structural one, a no-op one, swap, destroy and a create that reuses the
    freed id, with duplicate and unknown names refused alike: equal paths,
    ids, counter_values(), TenantSwapRecord fields (timings aside) and
    classify_mixed results, which also equal each tenant's oracle."""
    jreg, preg, jring, pring = _registries(family)
    base, other = _content(jax_testing, 10), _content(jax_testing, 11)
    pbase, pother = _content(testing, 10), _content(testing, 11)
    for name, jc, pc in (("a", base, pbase), ("b", base, pbase), ("c", other, pother)):
        assert preg.create_tenant(name, pc) == jreg.create_tenant(name, jc)
    assert preg.classifier.allocator.page_of(0) == preg.classifier.allocator.page_of(1)
    for bad in (lambda r: r.create_tenant("a", {}), lambda r: r.tenant_id("nope"),
                lambda r: r.apply_edit_transaction("nope", [])):
        with pytest.raises(JaxTenantError) as want:
            bad(jreg)
        with pytest.raises(syncer.TenantError) as got:
            bad(preg)
        assert str(got.value) == str(want.value)
    steps = [("c", 1, 4), ("b", 2, 3), ("a", 3, 5), ("a", 4, 1)]
    paths = []
    for name, seed, n in steps:
        jc_ = jreg._updaters[jreg.tenant_id(name)].content
        pc_ = preg._updaters[preg.tenant_id(name)].content
        want = jreg.apply_edit_transaction(name, _ops(jax_txn, jc_, seed, n))
        got = preg.apply_edit_transaction(name, _ops(txn, pc_, seed, n))
        assert got == want, (name, got, want)
        paths.append(got)
    assert paths[:2] == ["patch", "cow"]
    # a structural transaction (a new key) and one that folds to nothing
    (k, r), = _content(jax_testing, 90, n=1, v6=0.0).items()
    (pk, pr), = _content(testing, 90, n=1, v6=0.0).items()
    assert (preg.apply_edit_transaction("c", [txn.EditOp(kind="cidr_add", key=pk, rules=pr)])
            == jreg.apply_edit_transaction("c", [jax_txn.EditOp(kind="cidr_add", key=k, rules=r)]))
    (k2, r2), = _content(jax_testing, 93, n=1, v6=0.0).items()
    (pk2, pr2), = _content(testing, 93, n=1, v6=0.0).items()
    assert preg.apply_edit_transaction("c", [txn.EditOp(kind="cidr_add", key=pk2, rules=pr2),
                                             txn.EditOp(kind="key_delete", key=pk2)]) == \
        jreg.apply_edit_transaction("c", [jax_txn.EditOp(kind="cidr_add", key=k2, rules=r2),
                                          jax_txn.EditOp(kind="key_delete", key=k2)]) == "noop"
    preg.swap_tenant("a", pother)
    jreg.swap_tenant("a", other)
    preg.destroy_tenant("b")
    jreg.destroy_tenant("b")
    assert preg.create_tenant("d", pbase) == jreg.create_tenant("d", base)
    assert preg.tenant_names() == jreg.tenant_names()
    assert preg.tenant_ids_by_name() == jreg.tenant_ids_by_name()
    assert _records(pring, events.TenantSwapRecord) == _records(jring,
                                                                jax_events.TenantSwapRecord)
    # classify: every tenant, an unknown name, raw ids (a destroyed one, past
    # the table, negative)
    parts, tags = [], []
    for name in preg.tenant_names():
        tab = preg._updaters[preg.tenant_id(name)].snapshot()
        b = testing.random_batch_fast(np.random.default_rng(len(parts)), tab, 60)
        parts.append(b)
        tags += [name] * 60
        out = _same_out(jreg, preg, b, [name] * 60)
        np.testing.assert_array_equal(out.results, oracle.classify(tab, b).results)
    from infw_torch.packets import concat
    batch = concat(parts + [parts[0].slice(0, 12)])
    tags += ["nope", 1, 2, 5, 6, -1, 99, "nope", 0, 0, 1, 1]
    _same_out(jreg, preg, batch, tags)
    assert preg.counter_values() == jreg.counter_values()


def test_classify_mixed_keeps_the_port_id_rule():
    """Ids outside int32 map to -1 before the cast (UNDEF, uncounted), where
    the JAX registry cannot take them; in-range lanes equal its results."""
    jreg, preg, _jr, _pr = _registries(ring=False)
    preg.create_tenant("a", _content(testing, 10))
    jreg.create_tenant("a", _content(jax_testing, 10))
    tab = preg._updaters[0].snapshot()
    b = testing.random_batch_fast(np.random.default_rng(2), tab, 40)
    tags = [0, 2**32, -(2**32), 2**40 + 0] * 10
    got = preg.classify_mixed(b, tags)
    ok = np.array([t == 0 for t in tags])
    np.testing.assert_array_equal(got.results[ok], oracle.classify(tab, b).results[ok])
    assert not got.results[~ok].any()
    want = jreg.classify_mixed(_jax_batch(b), ["a"] * 40)
    np.testing.assert_array_equal(got.results[ok], want.results[ok])


def test_overlay_delta_routing_matches_jax():
    """test_arena_cow.py's routing pin on both registries: brand-new
    prefixes of a shared-page tenant ride the overlay (no clone), a delete
    of an overlay key too, a base-key edit forces the clone and folds the
    overlay back without resurrecting a key the same edit deletes; the
    paths, refcounts, clone counts, overlay pages and verdicts equal."""
    jreg, preg, _jr, _pr = _registries(pages=6, max_tenants=6, overlay=True, ring=False)
    jbase, pbase = _content(jax_testing, 90, n=12), _content(testing, 90, n=12)
    for r, c in ((jreg, jbase), (preg, pbase)):
        r.create_tenant("a", c)
        r.create_tenant("b", c)
    (jk, jr), = _content(jax_testing, 91, n=1, v6=0.0).items()
    (pk, pr), = _content(testing, 91, n=1, v6=0.0).items()
    jk0 = sorted(jbase, key=lambda k: (k.ingress_ifindex, k.ip_data))[0]
    pk0 = sorted(pbase, key=lambda k: (k.ingress_ifindex, k.ip_data))[0]
    jr0, pr0 = np.asarray(jbase[jk0]).copy(), np.asarray(pbase[pk0]).copy()
    jr0[1] = pr0[1] = [1, 6, 22, 0, 0, 0, 1]
    steps = [
        (({jk: np.asarray(jr)}, []), ({pk: np.asarray(pr)}, [])),
        (({}, [jk]), ({}, [pk])),
        (({jk: np.asarray(jr)}, []), ({pk: np.asarray(pr)}, [])),
        (({jk0: jr0}, []), ({pk0: pr0}, [])),
        (({jk: np.asarray(jr)}, []), ({pk: np.asarray(pr)}, [])),
        (({jk0: jr0}, [jk]), ({pk0: pr0}, [pk])),
    ]
    merged = dict(pbase)
    for (jups, jdels), (pups, pdels) in steps:
        want = jreg.update_tenant("b", jups, jdels)
        got = preg.update_tenant("b", pups, pdels)
        assert got == want
        ja, pa = jreg.classifier.allocator, preg.classifier.allocator
        assert pa.page_refcount(pa.page_of(1)) == ja.page_refcount(ja.page_of(1))
        assert pa.counters == ja.counters
        assert (preg.classifier.overlay_allocator.tenants()
                == jreg.classifier.overlay_allocator.tenants())
        for k in pdels:
            merged.pop(k, None)
        merged.update(pups)
        tab = compiler.compile_tables_from_content(merged, rule_width=4)
        b = testing.random_batch_fast(np.random.default_rng(len(merged)), tab, 80)
        out = _same_out(jreg, preg, b, ["b"] * 80)
        np.testing.assert_array_equal(out.results, oracle.classify(tab, b).results)
    assert pk.masked_identity() not in preg._updaters[1]._ident_to_t
    assert preg.counter_values() == jreg.counter_values()


def test_registry_refuses_edits_during_create():
    """An edit racing a create gets a clean "unknown" (the name publishes
    only after its load), a second create "exists", as the JAX registry
    says."""
    _jreg, preg, _jr, _pr = _registries(ring=False)
    preg._creating["x"] = 0
    with pytest.raises(syncer.TenantError, match="unknown"):
        preg.update_tenant("x", {}, [])
    with pytest.raises(syncer.TenantError, match="exists"):
        preg.create_tenant("x", {})
    del preg._creating["x"]
    assert preg.create_tenant("x", _content(testing, 10)) == 0


# --- the daemons under --tenants ------------------------------------------------------


def _tenant_files(mod_txn, mod, d, round_):
    """Round 0: tenant dirs a, b (a's content), c with one creating file
    each and a bad file in c; round 1: a rules-only file for a and b, a
    structural one for c, and a new tenant dir e with an empty edits/."""
    base, other = _content(mod, 10), _content(mod, 11)
    files = {}
    if round_ == 0:
        files = {("a", "e0.json"): [mod_txn.EditOp(kind="key_add", key=k, rules=r)
                                    for k, r in base.items()],
                 ("b", "e0.json"): [mod_txn.EditOp(kind="key_add", key=k, rules=r)
                                    for k, r in base.items()],
                 ("c", "e0.json"): [mod_txn.EditOp(kind="key_add", key=k, rules=r)
                                    for k, r in other.items()]}
    else:
        files = {(n, "e1.json"): _ops(mod_txn, base, 5, 3) for n in ("a", "b")}
        (k, r), = _content(mod, 92, n=1, v6=0.0).items()
        files[("c", "e1.json")] = [mod_txn.EditOp(kind="cidr_add", key=k, rules=r)]
        os.makedirs(os.path.join(d.tenants_dir, "e", "edits"), exist_ok=True)
    for (name, fn), ops in files.items():
        edits = os.path.join(d.tenants_dir, name, "edits")
        os.makedirs(edits, exist_ok=True)
        mod_txn.write_edit_file(os.path.join(edits, fn), ops)
    if round_ == 0:
        with open(os.path.join(d.tenants_dir, "c", "edits", "bad.json"), "w") as f:
            f.write("{not json")


def _tenant_lines(d):
    text = d.metrics_registry.render_text()
    return sorted(l for l in text.splitlines() if "tenant_" in l and not l.startswith("#"))


def _tenant_events(d):
    d.events_logger.drain_once()
    d._event_file.flush()
    import re
    return [re.sub(r"stage \d+us \+ flip \d+us", "", l)
            for l in open(d.events_path).read().splitlines() if l.startswith("tenant-")]


def test_daemons_agree_under_tenants(tmp_path, monkeypatch):
    """Both daemons with --tenants 4 over the same tenants/<name>/edits/
    files (a bad file among them, a tenant past the pool's ids left in
    place), a rules-only round (patch and cow), a structural edit and the
    dedup sweep: the same names, consumed files, classify_mixed results,
    tenant_* lines on /metrics and tenant-* lines in events.log."""
    monkeypatch.setenv("INFW_TENANT_SLAB_ENTRIES", "64")
    monkeypatch.setenv("INFW_TENANT_RULE_SLOTS", "4")
    monkeypatch.setenv("INFW_FUSED_DEEP", "1")  # the JAX arena's fused walk, as K3b serves
    common = dict(node_name="n", poll_period_s=3600.0, metrics_port=0, health_port=0,
                  file_poll_interval_s=60.0, tenants=4)
    jd = jax_daemon.Daemon(state_dir=str(tmp_path / "jax"), backend="tpu", **common)
    pd = daemon.Daemon(state_dir=str(tmp_path / "port"), backend="cpu", **common)
    try:
        assert pd.tenant_registry.classifier.spec == arena.ArenaSpec(
            *jd.tenant_registry.classifier.spec)
        for rnd in (0, 1):
            _tenant_files(jax_txn, jax_testing, jd, rnd)
            _tenant_files(txn, testing, pd, rnd)
            if rnd == 1:
                for d in (jd, pd):  # a fifth tenant dir: past the 4 ids
                    os.makedirs(os.path.join(d.tenants_dir, "f", "edits"))
                    with open(os.path.join(d.tenants_dir, "f", "edits", "x.json"), "w") as f:
                        f.write("[]")
            assert pd.scan_tenant_edits_once() == jd.scan_tenant_edits_once()
            for name in ("a", "b", "c", "e", "f"):
                lj = os.path.join(jd.tenants_dir, name, "edits")
                lp = os.path.join(pd.tenants_dir, name, "edits")
                if os.path.isdir(lj):
                    assert sorted(os.listdir(lp)) == sorted(os.listdir(lj)), name
            assert pd.tenant_registry.tenant_ids_by_name() == \
                jd.tenant_registry.tenant_ids_by_name()
            assert pd._tenant_create_failed == jd._tenant_create_failed
            for d in (jd, pd):
                d._tenant_dedup_last = -1e9
                d._tenant_dedup_maintenance()
            parts, tags = [], []
            for name, tid in sorted(pd.tenant_registry.tenant_ids_by_name().items()):
                tab = pd.tenant_registry._updaters[tid].snapshot()
                parts.append(testing.random_batch_fast(np.random.default_rng(tid), tab, 50))
                tags += [name] * 50
            from infw_torch.packets import concat
            batch = concat(parts)
            got = pd.tenant_registry.classify_mixed(batch, tags)
            want = jd.tenant_registry.classify_mixed(_jax_batch(batch), tags)
            np.testing.assert_array_equal(got.results, want.results)
            assert _tenant_lines(pd) == _tenant_lines(jd)
            assert _tenant_events(pd) == _tenant_events(jd)
        c = pd.tenant_registry.counter_values()
        assert c["tenant_patches_total"] >= 1 and c["tenant_cow_clones_total"] >= 1
        assert pd._tenant_create_failed == {"f"}
    finally:
        jd.stop()
        pd.stop()


def test_tenants_flag_and_env(tmp_path, monkeypatch, capsys):
    """--tenants 0 (and INFW_TENANTS=0) exits with a usage error before
    anything starts; without the flag no registry and no tenants/ dir;
    INFW_TENANTS sets the count."""
    argv = ["--state-dir", str(tmp_path / "s"), "--node-name", "n", "--backend", "cpu"]
    monkeypatch.delenv("INFW_TENANTS", raising=False)
    with pytest.raises(SystemExit) as e:
        daemon.main(argv + ["--tenants", "0"])
    assert e.value.code == 2 and "--tenants must be >= 1" in capsys.readouterr().err
    monkeypatch.setenv("INFW_TENANTS", "0")
    with pytest.raises(SystemExit) as e:
        daemon.main(argv)
    assert e.value.code == 2
    assert not (tmp_path / "s").exists()
    d = daemon.Daemon(state_dir=str(tmp_path / "t"), node_name="n", backend="cpu",
                      metrics_port=0, health_port=0)
    try:
        assert d.tenant_registry is None and not os.path.exists(d.tenants_dir)
        assert d.scan_tenant_edits_once() == 0
    finally:
        d.stop()
