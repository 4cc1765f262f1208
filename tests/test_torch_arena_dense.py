"""The port's dense-family arena on the CPU against the JAX package: the
slab bake byte for byte (``_dense_slab_arrays``), the allocator's host
mirrors and bookkeeping after every lifecycle step, the plain K6 against
``jaxpath.arena_dense_result_and_score`` / ``classify_arena_dense`` /
``jitted_classify_arena_wire_fused("dense", ...)`` and the per-tenant
oracles (invalid, absent and destroyed tenants, the /32 cap against /0 and
/128 entries, ties between rows), the overlay side-pool combine against
``classify_arena_with_overlay`` and ``ArenaClassifier(overlay_spec=...)``,
and TorchArenaClassifier on a dense spec against ArenaClassifier.  Every
comparison is exact (integers, tolerance 0)."""
import jax
import numpy as np
import pytest
import torch

from infw import compiler as jax_compiler
from infw import testing as jax_testing
from infw.backend.tpu import ArenaClassifier
from infw.kernels import jaxpath
from infw_torch import arena, compiler, oracle, packets, testing
from infw_torch.backend.cuda import TorchArenaClassifier
from infw_torch.kernels import arena_dense, torchpath
from infw_torch.packets import narrow_wire

from test_torch_arena import (MAX_TENANTS, N_TENANTS, PAGES, _assert_same_state, _extra,
                              _jax_batch, _lifecycle, _mixed, _outputs_equal, _raises_alike,
                              _tables, _tenants)


def _dense_specs(jtabs, ptabs, **kw):
    kw = {"pages": PAGES, "max_tenants": MAX_TENANTS, **kw}
    js = jaxpath.arena_spec_for("dense", list(jtabs.values()), **kw)
    ps = arena.arena_spec_for("dense", list(ptabs.values()), **kw)
    assert tuple(ps) == tuple(js) and ps.family == "dense"
    return js, ps


def _pool(alloc):
    """A JAX allocator's pool as the port's DenseArena on the CPU."""
    host = {f: np.asarray(getattr(alloc.arena, f)) for f in jaxpath.DenseArena._fields}
    view = {np.dtype(np.uint32): np.int32, np.dtype(np.uint16): np.int16,
            np.dtype(np.int32): np.int32}
    return arena.DenseArena(**{f: torch.from_numpy(np.array(a).view(view[a.dtype]))
                               for f, a in host.items()})


# --- slabs --------------------------------------------------------------------


@pytest.mark.parametrize("case", ["random", "v6", "empty", "width8"])
def test_dense_slabs_byte_identical_to_jax(case):
    """_dense_slab_arrays and the content hash over it, array for array and
    dtype for dtype, for random, IPv6-only, empty and 8-slot tables."""
    kw = {"random": {}, "v6": {"v6": 1.0}, "empty": {"entries": 0}, "width8": {"width": 8}}[case]
    jt, pt = _tables(jax_testing, 31, **kw), _tables(testing, 31, **kw)
    js = jaxpath.make_arena_spec("dense", 4, 2, 40, kw.get("width", 4))
    ps = arena.ArenaSpec(*js)
    want = jaxpath._dense_slab_arrays(js, jt)
    got = arena._dense_slab_arrays(ps, pt)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)
    assert arena.slab_content_hash(got) == jaxpath.slab_content_hash(want)


@pytest.mark.parametrize("bound", ["entries", "width", "wide_rules"])
def test_dense_slab_capacity_errors_match_jax(bound):
    jt, pt = _tables(jax_testing, 32), _tables(testing, 32)
    js = jaxpath.make_arena_spec("dense", 4, 2, 32, 4)
    if bound == "entries":
        js = js._replace(entries=8)
    elif bound == "width":
        js = js._replace(rule_slots=3)
    else:
        for t in (jt, pt):
            t.rules[0, 0, 2] = 70000  # a port past 16 bits: int32 rules
    _raises_alike(lambda: jaxpath._dense_slab_arrays(js, jt),
                  lambda: arena._dense_slab_arrays(arena.ArenaSpec(*js), pt), capacity=True)


# --- the allocator ---------------------------------------------------------------


def test_dense_allocator_lifecycle_matches_jax_step_by_step():
    """The ctrie lifecycle of test_torch_arena on a dense pool: assign,
    share, rewrite, cow, stage, claim-back, swap, release, destroy,
    compaction and the dedup sweep, the host pools, page tables, refcounts,
    hash index and counters equal after every step, the device pool equal
    to its mirror."""
    jtabs, ptabs = _tenants(jax_testing, 4), _tenants(testing, 4)
    jx, px = _extra(jax_testing), _extra(testing)
    js, ps = _dense_specs({**jtabs, **jx}, {**ptabs, **px})
    ja, pa = jaxpath.ArenaAllocator(js), arena.ArenaAllocator(ps, "cpu")
    assert isinstance(pa.arena, arena.DenseArena) and pa.host_nodes() is None
    _assert_same_state(ja, pa, "init")
    jm, pm = {}, {}
    paths = []
    for label, op in _lifecycle():
        want = op(ja, (jtabs, jx), jm)
        got = op(pa, (ptabs, px), pm)
        assert got == want, (label, got, want)
        _assert_same_state(ja, pa, label)
        paths.append(got)
    assert paths[:8] == ["assign"] * 4 + ["share", "share", "rewrite", "cow"]
    assert pa.pool_bytes() == ja.pool_bytes()
    assert ja.counters["compactions"] == 1 and ja.counters["destroys"] == 3


def test_dense_allocator_capacity_errors_match_jax():
    jtabs, ptabs = _tenants(jax_testing, 6), _tenants(testing, 6)
    js, ps = _dense_specs(jtabs, ptabs, pages=4, max_tenants=4)
    ja, pa = jaxpath.ArenaAllocator(js), arena.ArenaAllocator(ps, "cpu")
    _raises_alike(lambda: ja.load_tenant(4, jtabs[0]), lambda: pa.load_tenant(4, ptabs[0]),
                  capacity=True)
    for t in range(4):
        assert pa.load_tenant(t, ptabs[t]) == ja.load_tenant(t, jtabs[t])
    _raises_alike(lambda: ja.stage(jtabs[5]), lambda: pa.stage(ptabs[5]), capacity=True)
    big_j = _tables(jax_testing, 77, entries=3 * js.entries)
    big_p = _tables(testing, 77, entries=3 * js.entries)
    _raises_alike(lambda: ja.load_tenant(0, big_j), lambda: pa.load_tenant(0, big_p),
                  capacity=True)
    _assert_same_state(ja, pa, "after the refusals")


# --- K6's plain version ----------------------------------------------------------


def _dense_pair(destroy=3):
    jtabs, ptabs = _tenants(jax_testing), _tenants(testing)
    js, ps = _dense_specs(jtabs, ptabs)
    ja, pa = jaxpath.ArenaAllocator(js), arena.ArenaAllocator(ps, "cpu")
    for t in jtabs:
        assert pa.load_tenant(t, ptabs[t]) == ja.load_tenant(t, jtabs[t])
    ja.destroy_tenant(destroy)
    pa.destroy_tenant(destroy)
    return ja, pa, jtabs, ptabs


def _per_tenant_oracle(tabs, batch, tenant, destroyed):
    want = np.zeros(len(batch), np.uint32)
    for t, tab in tabs.items():
        idx = np.nonzero(tenant == t)[0]
        if t != destroyed and len(idx):
            want[idx] = oracle.classify(tab, batch.take(idx)).results
    return want


def test_plain_k6_matches_xla_and_oracles():
    """The plain K6 (arena_dense_classify on the CPU) against the XLA
    arena_dense_result_and_score column for column, classify_arena_dense's
    results, verdicts and statistics, and the per-tenant oracles; tenant
    ids -1 and MAX_TENANTS and the destroyed tenant 3 are UNDEF."""
    ja, pa, jtabs, ptabs = _dense_pair()
    pb, tenant = _mixed(testing, ptabs, per=150, seed=21)
    jb = jaxpath.device_batch(_jax_batch(pb))
    raw, score = jaxpath.arena_dense_result_and_score(ja.arena, jb, jax.device_put(tenant),
                                                      pages=PAGES)
    fields, words = torchpath.packet_fields(torchpath.device_batch(pb, "cpu"))
    got = arena_dense.arena_dense_classify(fields, words, torch.from_numpy(tenant), pa.arena,
                                           pages=PAGES)
    np.testing.assert_array_equal(got[:, 0].numpy(), np.asarray(raw).view(np.int32))
    np.testing.assert_array_equal(got[:, 1].numpy(), np.asarray(score))
    assert (got[:, 1] > 0).sum() > len(pb) // 4
    want = jaxpath.classify_arena_dense(ja.arena, jb, jax.device_put(tenant), pages=PAGES)
    res, xdp, stats = arena_dense.classify_arena_dense(
        pa.arena, torchpath.device_batch(pb, "cpu"), torch.from_numpy(tenant), pages=PAGES)
    for g, w in zip((res, xdp, stats), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).view(g.numpy().dtype))
    oracle_res = _per_tenant_oracle(ptabs, pb, tenant, destroyed=3)
    np.testing.assert_array_equal(res.numpy().view(np.uint32), oracle_res)
    off = (tenant < 0) | (tenant >= MAX_TENANTS) | (tenant == 3)
    assert off.any() and not res.numpy()[off].any()


@pytest.mark.parametrize("width", [7, 6, 4, 3])
def test_fused_k6_wire_matches_jax(width):
    """classify_arena_dense_wire_fused (the plain version on the CPU)
    against jitted_classify_arena_wire_fused("dense", pages) word for word,
    at every wire width."""
    ja, pa, _jt, ptabs = _dense_pair()
    pb, tenant = _mixed(testing, ptabs, per=90, seed=40 + width)
    if width in (4, 3):
        idx = np.nonzero((pb.kind != 2) & ~pb.ip_words[:, 1:].any(axis=1))[0]
        pb, tenant = pb.take(idx), tenant[idx]
        wire = pb.pack_wire_v4()
    else:
        wire = pb.pack_wire()
    if width in (6, 3):
        wire = narrow_wire(wire)
    assert wire.shape[1] == width
    fn = jaxpath.jitted_classify_arena_wire_fused("dense", PAGES, 0)
    want = np.asarray(fn(ja.arena, jax.device_put(wire), jax.device_put(tenant)))
    got = arena_dense.classify_arena_dense_wire_fused(
        pa.arena, torch.from_numpy(wire.view(np.int32)), torch.from_numpy(tenant), pages=PAGES)
    np.testing.assert_array_equal(got.numpy(), want.view(np.int32))
    assert got[: (len(pb) + 1) // 2].any() and got[-6144:].any()


def _cap_content(mod, width=4):
    """One ifindex's /0, /8, /32 IPv4 entries and ::/0, /64, /128 IPv6
    entries, each with a catch-all rule of its own ruleId."""
    out = {}
    for rid, cidr in enumerate(("0.0.0.0/0", "10.0.0.0/8", "10.0.0.1/32", "::/0",
                                "2001:db8::/64", "2001:db8::1/128"), start=1):
        rules = np.zeros((width, 7), np.int32)
        rules[0] = [rid, 0, 0, 0, 0, 0, 2 if rid % 2 else 1]
        out[mod.build_key(2, cidr)] = rules
    return out


def test_plain_k6_caps_and_cross_family_matches_xla():
    """The /32 cap for IPv4 against /0, /32 and /128 entries: an IPv4
    packet never takes a /128 row, a v4 /0 also matches IPv6 packets (and
    kinds OTHER and MALFORMED, capped at 128), held against the XLA lookup
    and the oracle."""
    jt = jax_compiler.compile_tables_from_content(_cap_content(jax_compiler), rule_width=4)
    pt = compiler.compile_tables_from_content(_cap_content(compiler), rule_width=4)
    js = jaxpath.arena_spec_for("dense", [jt], pages=4, max_tenants=2)
    ja, pa = jaxpath.ArenaAllocator(js), arena.ArenaAllocator(arena.ArenaSpec(*js), "cpu")
    ja.load_tenant(0, jt)
    pa.load_tenant(0, pt)
    srcs = ["10.0.0.1", "10.0.0.2", "11.0.0.1", "2001:db8::1", "2001:db8::2", "2001:db9::1"]
    pb = packets.make_batch(src=srcs * 3, proto=[6] * 18, ifindex=[2] * 18, dst_port=[80] * 18,
                            kind=[1, 1, 1, 2, 2, 2] + [3] * 6 + [0] * 6)
    tenant = np.zeros(18, np.int32)
    jb = jaxpath.device_batch(_jax_batch(pb))
    raw, score = jaxpath.arena_dense_result_and_score(ja.arena, jb, jax.device_put(tenant),
                                                      pages=js.pages)
    fields, words = torchpath.packet_fields(torchpath.device_batch(pb, "cpu"))
    got = arena_dense.arena_dense_classify_plain(fields, words, torch.from_numpy(tenant), pa.arena,
                                                 pages=js.pages)
    np.testing.assert_array_equal(got[:, 0].numpy(), np.asarray(raw).view(np.int32))
    np.testing.assert_array_equal(got[:, 1].numpy(), np.asarray(score))
    # 10.0.0.1 takes its /32 (score 33), never a /128 row; 2001:db8::1 its /128
    assert got[0, 1] == 33 and got[3, 1] == 129 and got[2, 1] == 1
    np.testing.assert_array_equal(
        torchpath.finalize(got[:, 0], torchpath.device_batch(pb, "cpu"))[0].numpy().view(np.uint32),
        oracle.classify(pt, pb).results)


def test_plain_k6_takes_the_first_of_tied_rows():
    """Rows that tie on the score (the same key and mask length twice in a
    slab, written straight into the pool) resolve to the lowest row, as
    XLA's argmax does; each tie row carries its own ruleId."""
    jt = jax_testing.random_tables(np.random.default_rng(5), n_entries=12, width=4,
                                   v6_fraction=0.5)
    js = jaxpath.arena_spec_for("dense", [jt], pages=4, max_tenants=2)
    ja = jaxpath.ArenaAllocator(js)
    ja.load_tenant(0, jt)
    pool = _pool(ja)
    S = js.entries
    # rows 12..23 of the page copy rows 0..11 with ruleId 0x33: every
    # matching row then ties with a later copy, which must never win
    page = ja.page_of(0) * S
    src, dst = page + np.arange(12), page + 12 + np.arange(12)
    for f in ("key_words", "mask_words", "mask_len"):
        getattr(pool, f)[dst] = getattr(pool, f)[src]
    rules = pool.rules.numpy().view(np.uint16).copy()
    rules[dst] = rules[src]
    rules[dst, 0] = (rules[dst, 0] & 0xFF00) | 0x33
    pool = pool._replace(rules=torch.from_numpy(rules.view(np.int16)))
    jarena = ja.arena._replace(**{f: jax.device_put(getattr(pool, f).numpy().view(
        np.asarray(getattr(ja.arena, f)).dtype)) for f in jaxpath.DenseArena._fields[:4]})
    pb = testing.random_batch_fast(np.random.default_rng(6), jt, 400)
    tenant = np.zeros(400, np.int32)
    raw, score = jaxpath.arena_dense_result_and_score(
        jarena, jaxpath.device_batch(_jax_batch(pb)), jax.device_put(tenant), pages=js.pages)
    fields, words = torchpath.packet_fields(torchpath.device_batch(pb, "cpu"))
    got = arena_dense.arena_dense_classify_plain(fields, words, torch.from_numpy(tenant), pool,
                                                 pages=js.pages)
    np.testing.assert_array_equal(got[:, 0].numpy(), np.asarray(raw).view(np.int32))
    np.testing.assert_array_equal(got[:, 1].numpy(), np.asarray(score))
    assert ((got[:, 0] >> 8) & 0xFF).ne(0x33).all() and (got[:, 1] > 0).any()


def test_k6_wrapper_runs_the_plain_version_on_the_cpu():
    _ja, pa, _jt, ptabs = _dense_pair()
    pb, tenant = _mixed(testing, ptabs, per=40, seed=3)
    fields, words = torchpath.packet_fields(torchpath.device_batch(pb, "cpu"))
    tt = torch.from_numpy(tenant)
    assert torch.equal(arena_dense.arena_dense_classify(fields, words, tt, pa.arena, pages=PAGES),
                       arena_dense.arena_dense_classify_plain(fields, words, tt, pa.arena,
                                                              pages=PAGES))
    with pytest.raises(ValueError, match="unsupported device"):
        arena_dense.arena_dense_classify(fields.to("meta"), words.to("meta"), tt.to("meta"),
                                         pa.arena, pages=PAGES)
    empty = arena_dense.arena_dense_classify(fields[:0], words[:0], tt[:0], pa.arena, pages=PAGES)
    assert empty.shape == (0, 2)


# --- the overlay side-pool ---------------------------------------------------------


def _overlay_content(mod, tab, seed):
    """New, mostly longer prefixes that none of ``tab``'s identities hold."""
    ov = mod.random_tables(np.random.default_rng(seed), n_entries=10, width=4, v6_fraction=0.3)
    taken = {k.masked_identity() for k in tab.content}
    return {k: v for k, v in ov.content.items() if k.masked_identity() not in taken}


@pytest.mark.parametrize("family", ["ctrie", "dense"])
def test_overlay_combine_matches_jax(family):
    """classify_arena_with_overlay on both main families with a dense
    side-pool: the plain combine against the XLA one, then
    TorchArenaClassifier(overlay_spec=...) against ArenaClassifier on a
    mixed batch before, with and after the overlays (tenant 0 and 2 get
    one, tenant 4 is destroyed with its overlay), against the oracles of
    the merged content, with the overlay's counters under their
    ``_overlay`` names."""
    jtabs, ptabs = _tenants(jax_testing), _tenants(testing)
    kw = {"pages": PAGES, "max_tenants": MAX_TENANTS}
    js = jaxpath.arena_spec_for(family, list(jtabs.values()), **kw)
    ps = arena.arena_spec_for(family, list(ptabs.values()), **kw)
    ov_js = jaxpath.make_arena_spec("dense", 6, MAX_TENANTS, 16, 4)
    ov_ps = arena.ArenaSpec(*ov_js)
    jc = ArenaClassifier(js, overlay_spec=ov_js, interpret=True, fused_deep=True)
    pc = TorchArenaClassifier(ps, device="cpu", overlay_spec=ov_ps)
    assert pc.overlay_allocator.spec == ov_ps
    for t in jtabs:
        assert pc.load_tenant(t, ptabs[t]) == jc.load_tenant(t, jtabs[t])
    merged = dict(ptabs)
    jov, pov = {}, {}
    for t in (0, 2, 4):
        jc_content = _overlay_content(jax_testing, jtabs[t], 500 + t)
        pc_content = _overlay_content(testing, ptabs[t], 500 + t)
        assert len(pc_content) == len(jc_content) > 3
        jov[t] = jax_compiler.compile_tables_from_content(jc_content, rule_width=4)
        pov[t] = compiler.compile_tables_from_content(pc_content, rule_width=4)
        merged[t] = compiler.compile_tables_from_content({**ptabs[t].content, **pc_content},
                                                         rule_width=4)
    pb, tenant = _mixed(testing, merged, per=80, seed=33)
    wire = narrow_wire(pb.pack_wire())

    def both(step, tables_of):
        got = pc.classify_async_packed_tenant(wire, tenant).result()
        want = jc.classify_async_packed_tenant(wire, tenant).result()
        _outputs_equal(got, want)
        assert pc.tenant_counters() == jc.tenant_counters(), step
        np.testing.assert_array_equal(got.results,
                                      _per_tenant_oracle(tables_of, pb, tenant, destroyed=None))
        return got

    base = both("no overlay", ptabs)
    for t in (0, 2, 4):
        jc.load_tenant_overlay(t, jov[t])
        pc.load_tenant_overlay(t, pov[t])
    over = both("overlays", merged)
    assert not np.array_equal(over.results, base.results)
    assert pc.tenant_counters()["tenant_active_slabs_overlay"] == 3
    # the plain combine on the pools as they stand, against the XLA one
    jb = jaxpath.device_batch(_jax_batch(pb))
    want = jaxpath.classify_arena_with_overlay(
        jc.allocator.arena, jc.overlay_allocator.arena, jb, jax.device_put(tenant), pages=PAGES,
        ov_pages=6, d_max=js.d_max if family == "ctrie" else 0)
    got = arena_dense.classify_arena_with_overlay(
        pc.allocator.arena, pc.overlay_allocator.arena, torchpath.device_batch(pb, "cpu"),
        torch.from_numpy(tenant), pages=PAGES, ov_pages=6,
        d_max=ps.d_max if family == "ctrie" else 0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).view(g.numpy().dtype))
    jc.load_tenant_overlay(2, None)
    pc.load_tenant_overlay(2, compiler.compile_tables_from_content({}, rule_width=4))
    jc.destroy_tenant(4)
    pc.destroy_tenant(4)
    assert pc.overlay_allocator.tenants() == jc.overlay_allocator.tenants() == [0]
    after = {**merged, 2: ptabs[2]}
    del after[4]
    both("cleared", after)


def test_overlay_spec_must_be_dense_and_present():
    ptabs = _tenants(testing, 2)
    ps = arena.arena_spec_for("ctrie", ptabs.values(), pages=4, max_tenants=4)
    js = jaxpath.ArenaSpec(*ps)
    with pytest.raises(ValueError) as want:
        ArenaClassifier(js, overlay_spec=js, interpret=True, fused_deep=False)
    with pytest.raises(ValueError) as got:
        TorchArenaClassifier(ps, device="cpu", overlay_spec=ps)
    assert str(got.value) == str(want.value)
    with pytest.raises(RuntimeError, match="without an overlay side-pool"):
        TorchArenaClassifier(ps, device="cpu").load_tenant_overlay(0, ptabs[0])


# --- the classifier ---------------------------------------------------------------


@pytest.mark.parametrize("width", [7, 6, 4])
def test_dense_classifier_matches_jax_arena_classifier(width):
    """TorchArenaClassifier(dense spec) against ArenaClassifier(dense spec):
    the same load paths (a dense pool installs through the allocator in
    both), results, verdicts, statistics, wire_stats() and
    tenant_counters() through a share, a rewrite, a swap, a destroy, a
    compaction and a dedup sweep."""
    jtabs, ptabs = _tenants(jax_testing), _tenants(testing)
    jx, px = _extra(jax_testing), _extra(testing)
    js, ps = _dense_specs({**jtabs, **jx}, {**ptabs, **px})
    jc = ArenaClassifier(js, interpret=True, fused_deep=False)
    pc = TorchArenaClassifier(ps, device="cpu")
    for t in jtabs:
        assert pc.load_tenant(t, ptabs[t]) == jc.load_tenant(t, jtabs[t])
    assert pc.load_tenant(5, px["t0_again"]) == jc.load_tenant(5, jx["t0_again"]) == "share"
    assert pc.load_tenant(0, px["x"]) == jc.load_tenant(0, jx["x"]) == "cow"
    assert pc.load_tenant(1, px["y"]) == jc.load_tenant(1, jx["y"]) == "rewrite"
    pb, tenant = _mixed(testing, {t: ptabs[t] for t in range(N_TENANTS)}, per=60, seed=61)
    if width == 4:
        idx = np.nonzero((pb.kind == 1))[0]
        pb, tenant = pb.take(idx), tenant[idx]
        wire = pb.pack_wire_v4()
    else:
        wire = pb.pack_wire()
        if width == 6:
            wire = narrow_wire(wire)

    def both(step):
        got = pc.classify_async_packed_tenant(wire, tenant).result()
        want = jc.classify_async_packed_tenant(wire, tenant).result()
        _outputs_equal(got, want)
        assert pc.wire_stats() == jc.wire_stats(), step
        assert pc.tenant_counters() == jc.tenant_counters(), step
        assert pc.tenant_ids() == jc.tenant_ids(), step
        return got

    out = both("loaded")
    idx2 = np.nonzero(tenant == 2)[0]
    np.testing.assert_array_equal(out.results[idx2],
                                  oracle.classify(ptabs[2], pb.take(idx2)).results)
    pc.swap_tenant(2, px["z"])
    jc.swap_tenant(2, jx["z"])
    both("swapped")
    pc.destroy_tenant(3)
    jc.destroy_tenant(3)
    assert pc.compact() == jc.compact()
    both("compacted")
    assert pc.dedup_sweep() == jc.dedup_sweep()
    out = both("swept")
    assert not out.results[tenant == 3].any()
    np.testing.assert_array_equal(
        pc.classify_tenants(pb, tenant, apply_stats=False).results,
        jc.classify_tenants(_jax_batch(pb), tenant, apply_stats=False).results)
