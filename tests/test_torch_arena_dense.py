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
from infw_torch.kernels import arena_dense, dense, torchpath
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


# --- K6's formulation: what the kernel computes, step by step ----------------------


def _slab_rows(tab, width=4):
    """A compiled table's dense rows (key, mask, mask_len, u16 rules),
    unpadded."""
    spec = arena.make_arena_spec("dense", 4, 1, max(tab.num_entries, 1), width)
    k, m, ml, r = arena._dense_slab_arrays(spec, tab)
    n = tab.num_entries
    return k[:n], m[:n], ml[:n], r[:n]


def _custom_pool(rows_of_page, S, pages, page_table, rng):
    """Host pool arrays of ``pages`` slabs of S rows: page p holds the rows
    ``rows_of_page[p]`` (key, mask, mask_len, rules) in their order at
    sorted random positions, padding rows between them."""
    width = next(iter(rows_of_page.values()))[3].shape[1]
    N = pages * S
    kw, mw = np.zeros((N, 5), np.uint32), np.zeros((N, 5), np.uint32)
    ml, rules = np.full(N, -1, np.int32), np.zeros((N, width), np.uint16)
    for p, (k, m, length, r) in rows_of_page.items():
        n = len(length)
        pos = np.sort(rng.choice(S, n, replace=False))
        at = p * S + pos
        kw[at], mw[at], ml[at], rules[at] = k, m, length, r
    return {"key_words": kw, "mask_words": mw, "mask_len": ml, "rules": rules,
            "page_table": np.asarray(page_table, np.int32)}


def _both_pools(host):
    """The same pool as the port's DenseArena (CPU) and JAX's."""
    view = {np.dtype(np.uint32): np.int32, np.dtype(np.uint16): np.int16,
            np.dtype(np.int32): np.int32}
    port = arena.DenseArena(**{f: torch.from_numpy(a.view(view[a.dtype]))
                               for f, a in host.items()})
    return port, jaxpath.DenseArena(**{f: jax.device_put(a) for f, a in host.items()})


def _held_three_ways(host, pages, pb, tenant):
    """formulation == arena_dense_classify_plain == XLA's
    arena_dense_result_and_score, column for column; returns the result."""
    pool, jpool = _both_pools(host)
    fields, words = torchpath.packet_fields(torchpath.device_batch(pb, "cpu"))
    tt = torch.from_numpy(tenant)
    got = arena_dense.formulation(fields, words, tt, pool, pages=pages)
    plain = arena_dense.arena_dense_classify_plain(fields, words, tt, pool, pages=pages)
    raw, score = jaxpath.arena_dense_result_and_score(
        jpool, jaxpath.device_batch(_jax_batch(pb)), jax.device_put(tenant), pages=pages)
    assert torch.equal(got, plain)
    np.testing.assert_array_equal(got[:, 0].numpy(), np.asarray(raw).view(np.int32))
    np.testing.assert_array_equal(got[:, 1].numpy(), np.asarray(score))
    return got


def test_page_buckets_sort_by_page_with_a_none_bucket():
    """The grouping: pages 0..P-1, the clip page P (a page-table entry past
    the pool), "none" P + 1 (tenant ids -1 and >= MT, absent and
    destroyed tenants, lanes left out), two deduped tenants on one page
    sharing its bucket; starts, the stable permutation and the tile
    starts against a numpy recount."""
    rng = np.random.default_rng(3)
    P, MT, B = 6, 9, 3000
    page_table = torch.tensor([0, 2, 2, -1, 5, 1, 7, 3, -1], dtype=torch.int32)  # 7: past P
    tenant = torch.from_numpy(rng.integers(-2, MT + 2, B).astype(np.int32))
    keep = torch.from_numpy(rng.random(B) < 0.9)
    for k in (None, keep):
        got = arena_dense.page_buckets(page_table, tenant, P, k)
        t = tenant.numpy().astype(np.int64)
        pg = np.where((t >= 0) & (t < MT), page_table.numpy()[np.clip(t, 0, MT - 1)], -1)
        want = np.where(pg < 0, P + 1, np.minimum(pg, P))
        if k is not None:
            want = np.where(keep.numpy(), want, P + 1)
        np.testing.assert_array_equal(got.bucket.numpy(), want)
        counts = np.bincount(want, minlength=P + 2)
        np.testing.assert_array_equal(got.start.numpy(), np.concatenate([[0], np.cumsum(counts)]))
        np.testing.assert_array_equal(got.perm.numpy(), np.argsort(want, kind="stable"))
        shared = (t == 1) | (t == 2)
        if k is not None:
            shared &= keep.numpy()
        assert counts[2] == shared.sum()
        assert counts[P] > 0 and counts[P + 1] > 0 and counts[4] == 0
        tiles = arena_dense.tile_starts(got.start).numpy()
        per = -(-counts[:P + 1] // arena_dense.TILE_PACKETS)
        np.testing.assert_array_equal(tiles, np.concatenate([[0], np.cumsum(per)]))


@pytest.mark.parametrize("n_rows", [1, 40, 1024])
def test_chunk_operands_planes_constants_and_groups(n_rows):
    """A staged chunk: every live row (mask_len 0..128) in exactly one
    slot, in the group of its /32 cap and k-steps, its plane K1's host
    plane (dense.lpm_planes) cut to those k-steps, its constant (mask_len
    + 1) << 10 | (1023 - row) - 2^21 rowsum(M1); groups padded to 8 rows
    of zero planes and the never-matching constant."""
    rng = np.random.default_rng(n_rows)
    tab = testing.random_tables_fast(rng, n_rows, width=4, v6_fraction=0.4)
    k, m, ml, _r = _slab_rows(tab)
    ml = ml.copy()
    ml[::7] = -1          # padding rows among the live ones
    ml[3::11] = 129       # never within any cap
    kt, mt = torch.from_numpy(k.view(np.int32)), torch.from_numpy(m.view(np.int32))
    ops = arena_dense.chunk_operands(kt, mt, torch.from_numpy(ml))
    live = (ml >= 0) & (ml <= 128)
    row = ops.row.numpy()
    assert sorted(row[row >= 0]) == list(np.nonzero(live)[0])
    gstart = ops.gstart.numpy()
    assert (np.diff(gstart) % 8 == 0).all() and gstart[-1] == len(row)
    planes, m1 = dense.lpm_planes(k, m)
    for g in range(arena_dense.N_GROUPS):
        sl = slice(gstart[g], gstart[g + 1])
        rows = row[sl]
        pad = rows < 0
        assert (ops.planes[sl][torch.from_numpy(pad)] == 0).all()
        assert (ops.const[sl].numpy()[pad] == arena_dense.LPM_NEVER).all()
        rows = rows[~pad]
        steps = g % 5 + 1
        assert ((ml[rows] > 32) == (g >= 5)).all()
        covered = np.where((m[rows] != 0).any(axis=1),
                           5 - np.argmax((m[rows] != 0)[:, ::-1], axis=1), 1)
        assert (covered == steps).all()
        got = ops.planes[sl].numpy()[~pad]
        np.testing.assert_array_equal(got[:, :32 * steps], planes[rows, :32 * steps])
        assert not got[:, 32 * steps:].any() and not planes[rows, 32 * steps:].any()
        key = ((ml[rows].astype(np.int64) + 1) << 10) | (1023 - rows)
        np.testing.assert_array_equal(ops.const[sl].numpy()[~pad],
                                      key - arena_dense.LPM_BIG * m1[rows].astype(np.int64))


def test_packed_key_stays_in_int32_for_any_slab():
    """The key is chunk-local, so the largest slab the spec allows (S up
    to int32 pool indexing at the minimum 4 pages) has the same bounds as
    one chunk: at 160 mismatches, and at a full match of 160 mask bits, on
    rows 0 and 1023 of a chunk, every score stays within int32 and a match
    is positive."""
    s_max = ((2 ** 31 - 1) // 4) // 4096 * 4096
    assert arena.make_arena_spec("dense", 4, 1, s_max, 1).entries == s_max
    assert s_max > arena_dense.CHUNK and (4 * s_max) < 2 ** 31
    n = arena_dense.CHUNK
    ones = torch.full((n, 5), -1, dtype=torch.int32)
    ml = torch.full((n,), 128, dtype=torch.int32)
    ops = arena_dense.chunk_operands(ones, ones, ml)  # rowsum(M1) = 160 everywhere
    fields = torch.zeros((2, 8), dtype=torch.int32)
    fields[:, 0] = 2  # IPv6: every group
    fields[0, 1], fields[1, 1] = -1, 0
    words = torch.tensor([[-1] * 4, [0] * 4], dtype=torch.int32)
    best = arena_dense.chunk_best(ops, fields, words)  # asserts the int32 range
    assert int(best[0]) == (129 << 10) | 1023 and int(best[1]) < 0
    assert int(ops.const.min()) >= -(2 ** 31) and arena_dense.LPM_BIG * 160 + int(
        best[0]) < 2 ** 31


def _special_rows(ifindex=2):
    """Rows past /32 whose keys match an IPv4 packet's (a /64 and a /128
    of 10.0.0.1 over zero high words), a v4 /0 and a v6 ::/0 (which match
    every packet on the ifindex), each with a catch-all rule of its own."""
    k = np.zeros((4, 5), np.uint32)
    m = np.zeros((4, 5), np.uint32)
    k[:, 0], m[:, 0] = ifindex, 0xFFFFFFFF
    k[0:2, 1] = 0x0A000001
    m[0, 1:3] = 0xFFFFFFFF
    m[1, 1:5] = 0xFFFFFFFF
    ml = np.array([64, 128, 0, 0], np.int32)
    r = np.zeros((4, 20), np.uint16)
    r[:, 0] = np.array([61, 62, 63, 64]) | (np.array([1, 2, 1, 2]) << 8)
    return k, m, ml, r


def _stack(*parts):
    return tuple(np.concatenate([p[i] for p in parts]) for i in range(4))


@pytest.mark.parametrize("case", ["mixed", "ties", "caps", "S8", "S5000", "S65544"])
def test_formulation_matches_plain_and_xla(case):
    """The formulation (the kernel's page grouping, staged chunks and
    integer product) against the plain K6 and XLA's
    arena_dense_result_and_score, bit for bit: a mixed batch over pages
    with padding rows interleaved, two deduped tenants on one page, tenant
    ids -1 and >= MT, an absent (destroyed) tenant and one whose page is
    past the pool; ties between equal-length rows (the lowest wins, within
    a chunk and across chunks); rows past /32 that match IPv4 packets and
    /0 rows; slabs of 8, 1024 (one chunk), 5000 and 65544 rows."""
    rng = np.random.default_rng(len(case))
    S = {"S8": 8, "S5000": 5000, "S65544": 65544}.get(case, 1024)
    pages = 4 if case == "S65544" else 6
    n_entries = {"S8": 6, "ties": 400, "S5000": 2000, "S65544": 900}.get(case, 700)
    per = {"S65544": 8, "S5000": 60}.get(case, 150)
    tabs = [testing.random_tables_fast(np.random.default_rng(50 + t), n_entries, width=4,
                                       v6_fraction=0.4, ifindexes=(2, 3)) for t in range(3)]
    rows = {p: _slab_rows(tabs[p]) for p in range(3)}
    if case in ("ties", "S5000", "S65544"):
        # every row of page 0 again, later, with ruleId 0x33: ties
        k, m, ml, r = rows[0]
        r2 = r.copy()
        r2[:, 0] = (r2[:, 0] & 0xFF00) | 0x33
        rows[0] = _stack(rows[0], (k, m, ml, r2))
    if case == "caps":
        for p in range(3):
            rows[p] = _stack(rows[p], _special_rows())
    if case == "S8":
        rows = {p: tuple(a[:S] for a in rows[p]) for p in rows}
    # tenants: 0 -> page 0, 1 and 4 -> page 1 (deduped), 2 -> page 2,
    # 3 destroyed (-1), 5 -> page 9 (past the pool: rows clip to the last)
    page_table = [0, 1, 2, -1, 1, 9]
    host = _custom_pool(rows, S, pages, page_table, rng)
    # the pool's last row, which every row of page 9 clips to: a v4 /0
    k, m, ml, r = _special_rows()
    for f, v in zip(("key_words", "mask_words", "mask_len", "rules"), (k, m, ml, r)):
        host[f][-1] = v[2]
    parts, tags = [], []
    for t, p in enumerate(page_table):
        tab = tabs[p] if 0 <= p < 3 else tabs[0]
        parts.append(testing.random_batch_fast(np.random.default_rng(70 + t), tab, per))
        tags.append(np.full(per, t, np.int32))
    if case == "caps":
        srcs = ["10.0.0.1", "10.0.0.2", "a00:1::", "2001:db8::1"] * 2
        parts.append(packets.make_batch(src=srcs, proto=[6] * 8, ifindex=[2] * 8,
                                        dst_port=[80] * 8, kind=[1, 1, 2, 2, 1, 1, 2, 2]))
        tags.append(np.array([0, 0, 0, 0, 1, 1, 4, 4], np.int32))
    pb = packets.concat(parts)
    tenant = np.concatenate(tags)
    tenant[:5], tenant[-5:] = -1, len(page_table) + 3
    got = _held_three_ways(host, pages, pb, tenant)
    matched = got[:, 1] > 0
    assert int(matched.sum()) > len(pb) // 4
    assert not got[torch.from_numpy((tenant < 0) | (tenant == 3) | (tenant >= 6))].any()
    if case in ("ties", "S5000", "S65544"):
        assert ((got[:, 0] >> 8) & 0xFF).ne(0x33).all()
    if case == "caps":
        v4 = torch.from_numpy(pb.kind == 1)
        assert (got[v4, 1] <= 33).all() and (got[~v4, 1] == 129).any()
        assert (got[v4 & matched, 1] == 1).any()  # the /0 rows


@pytest.mark.parametrize("width", [7, 6, 4, 3])
def test_wire_formulation_matches_fused_plain_and_jax(width):
    """The fused entry's formulation (finalize's zeroed lanes in the
    "none" bucket) against classify_arena_dense_wire_fused's plain version
    and jitted_classify_arena_wire_fused("dense"), word for word."""
    ja, pa, _jt, ptabs = _dense_pair()
    pb, tenant = _mixed(testing, ptabs, per=90, seed=80 + width)
    if width in (4, 3):
        idx = np.nonzero((pb.kind != 2) & ~pb.ip_words[:, 1:].any(axis=1))[0]
        pb, tenant = pb.take(idx), tenant[idx]
        wire = pb.pack_wire_v4()
    else:
        wire = pb.pack_wire()
    if width in (6, 3):
        wire = narrow_wire(wire)
    tw = torch.from_numpy(wire.view(np.int32))
    tt = torch.from_numpy(tenant)
    got = arena_dense.wire_formulation(pa.arena, tw, tt, pages=PAGES)
    assert torch.equal(got, arena_dense.classify_arena_dense_wire_fused_plain(pa.arena, tw, tt,
                                                                              pages=PAGES))
    fn = jaxpath.jitted_classify_arena_wire_fused("dense", PAGES, 0)
    want = np.asarray(fn(ja.arena, jax.device_put(wire), jax.device_put(tenant)))
    np.testing.assert_array_equal(got.numpy(), want.view(np.int32))


def test_chip_smoke_dense_bound_counts_the_k_steps_compares_need():
    """chip_smoke.py's K6 bound against a row-by-row count: for each lane
    finalize keeps whose tenant holds a page, every live row of its slab
    (an IPv4 lane's only up to /32) costs its k-steps (the key words its
    mask covers, at least 1) x 2 x 32 int8 operations."""
    import chip_smoke

    _ja, pa, _jt, ptabs = _dense_pair()
    pb, tenant = _mixed(testing, ptabs, per=60, seed=77)
    wire = torch.from_numpy(narrow_wire(pb.pack_wire()).view(np.int32))
    tt = torch.from_numpy(tenant)
    _ms, _by, _nbytes, ops, compares, ksteps = chip_smoke.dense_bound(
        arena_dense, torchpath, pa.arena, wire, tt, PAGES)
    fields, _words, keep = chip_smoke.looked_up_operands(torchpath, wire)
    S = arena_dense.slab_rows(pa.arena, PAGES)
    pt, ml = pa.arena.page_table.numpy(), pa.arena.mask_len.numpy()
    mw = pa.arena.mask_words.numpy()
    want_c = want_k = 0
    for i, t in enumerate(tenant):
        if not keep[i] or not 0 <= t < len(pt) or pt[t] < 0:
            continue
        cap = 32 if int(fields[i, 0]) == arena_dense.KIND_IPV4 else 128
        for r in range(pt[t] * S, pt[t] * S + S):
            if 0 <= ml[r] <= cap:
                want_c += 1
                want_k += max(1, int(np.nonzero(mw[r])[0].max(initial=-1)) + 1)
    assert want_c > 0 and (compares, ksteps) == (want_c, want_k)
    assert ops == 64 * want_k
