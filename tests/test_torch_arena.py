"""The port's multi-tenant ctrie arena on the CPU (geometry, slab baking,
the allocator, the plain paged walk that is K3b's specification, the wire
path and TorchArenaClassifier) against the JAX package: make_arena_spec /
arena_spec_for, the slab bake and content hash byte for byte, the
allocator's host mirrors after every lifecycle step, the XLA arena walk,
the Pallas paged walk in interpret mode, ArenaClassifier(interpret=True,
fused_deep=True) and the per-tenant oracles.  Every comparison is exact
(integers, tolerance 0)."""
import numpy as np
import pytest
import torch

import jax

from infw import packets as jax_packets
from infw import testing as jax_testing
from infw.backend.tpu import ArenaClassifier
from infw.kernels import jaxpath, pallas_walk
from infw_torch import arena, convert, oracle, testing
from infw_torch.backend.cuda import TorchArenaClassifier
from infw_torch.kernels import arena_walk, torchpath
from infw_torch.packets import concat, narrow_wire

N_TENANTS, PAGES, MAX_TENANTS = 5, 8, 16


def _tables(mod, seed, entries=24, v6=0.4, width=4):
    return mod.random_tables(np.random.default_rng(seed), n_entries=entries, width=width,
                             v6_fraction=v6)


def _tenants(mod, n=N_TENANTS, seed0=100):
    """tests/test_arena.py's tenant tables: 24 entries, 40% IPv6, 4 rule
    slots, seeds 100 + t."""
    return {t: _tables(mod, seed0 + t) for t in range(n)}


def _specs(jtabs, ptabs, **kw):
    kw = {"pages": PAGES, "max_tenants": MAX_TENANTS, **kw}
    js = jaxpath.arena_spec_for("ctrie", list(jtabs.values()), **kw)
    ps = arena.arena_spec_for("ctrie", list(ptabs.values()), **kw)
    assert tuple(ps) == tuple(js)
    return js, ps


def _raises_alike(fn_jax, fn_port, capacity=False):
    """Both raise (ArenaCapacityError of their own package when
    ``capacity``, else ValueError) with the same message."""
    with pytest.raises(jaxpath.ArenaCapacityError if capacity else ValueError) as want:
        fn_jax()
    with pytest.raises(arena.ArenaCapacityError if capacity else ValueError) as got:
        fn_port()
    assert str(got.value) == str(want.value)
    return got.value


# --- geometry ---------------------------------------------------------------

SPEC_CASES = {
    "ctrie_small": (("ctrie", 4, 8, 17, 4), {"node_rows": 130}),
    "ctrie_defaults": (("ctrie", 6, 3, 1, 1), {}),
    "ctrie_large": (("ctrie", 514, 513, 64, 4), {"lut_rows": 4, "root_nodes": 3,
                                                 "node_rows": 500, "target_rows": 100,
                                                 "d_max": 9}),
    "ctrie_4096": (("ctrie", 4, 8, 5000, 4), {"target_rows": 9000, "lut_rows": 4097}),
    "dense": (("dense", 4, 2, 100, 3), {}),
    "spliced": (("ctrie", 8, 4, 24, 4), {"plane_slots": 3, "plane_node_rows": 9,
                                         "plane_target_rows": 5, "plane_joined_rows": 17,
                                         "splice_slots": 2}),
}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_make_arena_spec_matches_jax(case):
    args, kw = SPEC_CASES[case]
    js, ps = jaxpath.make_arena_spec(*args, **kw), arena.make_arena_spec(*args, **kw)
    assert tuple(ps) == tuple(js) and ps._fields == js._fields
    for prop in ("joined_rows", "l0_rows", "spliced", "splice_rows"):
        assert getattr(ps, prop) == getattr(js, prop), prop


SPEC_ERRORS = {
    "family": (("trie", 4, 4, 16, 4), {}),
    "pages": (("dense", 2, 4, 16, 4), {}),
    "tenants": (("ctrie", 4, 0, 16, 4), {}),
    "int32_l0": (("ctrie", 40000, 4, 16, 4), {"root_nodes": 1}),
    "negative_splice": (("ctrie", 4, 4, 16, 4), {"plane_slots": -1}),
    "splice_dense": (("dense", 4, 4, 16, 4), {"plane_slots": 1}),
    "splice_partial": (("ctrie", 4, 4, 16, 4), {"plane_slots": 1, "splice_slots": 1}),
    "splice_tag_nodes": (("ctrie", 4, 4, 16, 4), {"plane_slots": 1 << 29, "plane_node_rows": 8,
                                                  "plane_target_rows": 8,
                                                  "plane_joined_rows": 8, "splice_slots": 1}),
    "splice_tag_slots": (("ctrie", 4, 4, 16, 4), {"plane_slots": 1, "plane_node_rows": 8,
                                                  "plane_target_rows": 8,
                                                  "plane_joined_rows": 8,
                                                  "splice_slots": 1 << 30}),
}


@pytest.mark.parametrize("case", sorted(SPEC_ERRORS))
def test_make_arena_spec_errors_match_jax(case):
    args, kw = SPEC_ERRORS[case]
    _raises_alike(lambda: jaxpath.make_arena_spec(*args, **kw),
                  lambda: arena.make_arena_spec(*args, **kw))


@pytest.mark.parametrize("family,kw", [
    ("ctrie", {}), ("ctrie", {"headroom": 1.7}), ("ctrie", {"d_max": 9}),
    ("dense", {"headroom": 2.0}),
])
def test_arena_spec_for_matches_jax(family, kw):
    jtabs, ptabs = _tenants(jax_testing), _tenants(testing)
    js = jaxpath.arena_spec_for(family, jtabs.values(), pages=PAGES, max_tenants=9, **kw)
    ps = arena.arena_spec_for(family, ptabs.values(), pages=PAGES, max_tenants=9, **kw)
    assert tuple(ps) == tuple(js)
    assert ps.root_nodes > 1 if family == "ctrie" else ps.root_nodes == 1


def test_arena_spec_for_refuses_wide_rules_like_jax():
    def wide(mod):
        t = _tables(mod, 7)
        content = dict(t.content)
        key = next(iter(content))
        rows = np.array(content[key])
        rows[1] = [300, 6, 80, 0, 0, 0, 2]
        content[key] = rows
        return mod_compile(mod)(content, rule_width=4)

    def mod_compile(mod):
        return (jax_compiler if mod is jax_testing else port_compiler).compile_tables_from_content

    from infw import compiler as jax_compiler
    from infw_torch import compiler as port_compiler

    jt, pt = wide(jax_testing), wide(testing)
    _raises_alike(lambda: jaxpath.arena_spec_for("ctrie", [jt], pages=4, max_tenants=2),
                  lambda: arena.arena_spec_for("ctrie", [pt], pages=4, max_tenants=2),
                  capacity=True)
    # and the slab bake refuses it too
    spec = arena.make_arena_spec("ctrie", 4, 2, 64, 4, lut_rows=8, root_nodes=4)
    jspec = jaxpath.make_arena_spec("ctrie", 4, 2, 64, 4, lut_rows=8, root_nodes=4)
    _raises_alike(lambda: jaxpath._ctrie_canonical_slab(jspec, jt),
                  lambda: arena._ctrie_canonical_slab(spec, pt), capacity=True)


# --- slab baking --------------------------------------------------------------


@pytest.mark.parametrize("page", [0, 1, 5, 7])
def test_slabs_byte_identical_to_jax(page):
    """Canonical slabs, their offset and un-offset forms and the content
    hash equal jaxpath's for every tenant table, at page 0 and beyond."""
    jtabs, ptabs = _tenants(jax_testing), _tenants(testing)
    js, ps = _specs(jtabs, ptabs)
    for t in jtabs:
        (jarr, jn), (parr, pn) = (jaxpath._ctrie_canonical_slab(js, jtabs[t]),
                                  arena._ctrie_canonical_slab(ps, ptabs[t]))
        assert jn == pn
        for a, b in zip(parr, jarr):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert arena.slab_content_hash(parr, pn) == jaxpath.slab_content_hash(jarr, jn)
        poff = arena._offset_ctrie_slab(ps, parr, pn, page)
        joff = jaxpath._offset_ctrie_slab(js, jarr, jn, page)
        for a, b in zip(poff, joff):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        for a, b in zip(arena._ctrie_slab_arrays(ps, page, ptabs[t]), joff):
            assert np.array_equal(a, b)
        back = arena._unoffset_ctrie_slab(ps, poff, pn, page)
        jback = jaxpath._unoffset_ctrie_slab(js, joff, jn, page)
        for a, b, c in zip(back, jback, parr):
            assert a.dtype == b.dtype and np.array_equal(a, b) and np.array_equal(a, c)
        if page:
            assert not np.array_equal(poff[0], parr[0])  # the offsets moved something
    hashes = {arena.slab_content_hash(*arena._ctrie_canonical_slab(ps, ptabs[t])) for t in ptabs}
    assert len(hashes) == len(ptabs)


SLAB_BOUNDS = {
    "entries": {"entries": 8},
    "d_max": {"d_max": 1},
    "lut": {"lut_rows": 2},
    "root_nodes": {"root_nodes": 1},
    "targets": {"target_rows": 8},
    "rule_width": {"rule_slots": 2},
}


@pytest.mark.parametrize("bound", sorted(SLAB_BOUNDS))
def test_slab_capacity_errors_match_jax(bound):
    jt, pt = _tables(jax_testing, 100), _tables(testing, 100)
    js = jaxpath.arena_spec_for("ctrie", [jt], pages=4, max_tenants=2)._replace(
        **SLAB_BOUNDS[bound])
    ps = arena.ArenaSpec(*js)
    _raises_alike(lambda: jaxpath._ctrie_canonical_slab(js, jt),
                  lambda: arena._ctrie_canonical_slab(ps, pt), capacity=True)


# --- the allocator, step by step ----------------------------------------------


def _assert_same_state(ja, pa, step):
    """Host mirrors byte for byte, the port's device pool equal to its
    mirror, and every piece of bookkeeping, after one lifecycle step."""
    for name, want in ja._host.items():
        got = pa._host[name]
        assert got.dtype == want.dtype and np.array_equal(got, want), (step, name)
        dev = getattr(pa.arena, name).numpy().view(got.dtype)
        assert np.array_equal(dev, got), (step, name, "device")
    for t in range(MAX_TENANTS):
        assert pa.page_of(t) == ja.page_of(t), (step, t)
    for p in range(PAGES):
        assert pa.page_refcount(p) == ja.page_refcount(p), (step, p)
        assert pa.page_holds(p) == ja.page_holds(p), (step, p)
    assert pa._free == ja._free, step
    assert pa.free_pages() == ja.free_pages() and pa.tenants() == ja.tenants(), step
    assert pa.counter_values() == ja.counter_values(), step
    assert pa.distinct_slabs() == ja.distinct_slabs(), step
    assert pa.node_gen == ja.node_gen, step
    assert pa._page_nnodes == ja._page_nnodes, step
    assert set(pa._hash_page.items()) == set(ja._hash_page.items()), step
    assert pa._hash_dirty == ja._hash_dirty, step
    for t in range(MAX_TENANTS):
        assert [pa.tenant_shares_page(t)] == [ja.tenant_shares_page(t)], (step, t)


def _lifecycle():
    """One op sequence as (label, op(allocator, (tenant tables, extra
    tables), memo)): assign, share, rewrite, cow, stage + activate with a
    ping-pong claim-back, release, destroy, compact, dedup_sweep.  ``memo``
    keeps each side's staged and replaced pages."""
    ops = [(f"assign {t}", lambda a, tabs, m, t=t: a.load_tenant(t, tabs[0][t]))
           for t in range(4)]
    ops += [
        # a fifth tenant whose content is tenant 0's, compiled anew: a hash hit
        ("share", lambda a, tabs, m: a.load_tenant(4, tabs[1]["t0_again"])),
        ("no-op reload", lambda a, tabs, m: a.load_tenant(4, tabs[1]["t0_again"])),
        ("rewrite", lambda a, tabs, m: a.load_tenant(1, tabs[1]["x"])),
        ("cow", lambda a, tabs, m: a.load_tenant(4, tabs[1]["y"])),
        ("share onto a live page", lambda a, tabs, m: a.load_tenant(5, tabs[1]["y"])),
        ("stage", lambda a, tabs, m: m.setdefault("staged", a.stage(tabs[1]["z"]))),
        ("stage a resident table", lambda a, tabs, m: a.stage(tabs[0][2])),
        ("release the resident hold", lambda a, tabs, m: a.release(a.page_of(2))),
        ("activate", lambda a, tabs, m: (m.setdefault("old", a.page_of(2)),
                                         a.activate(2, m["staged"], tabs[1]["z"]))[1]),
        ("ping-pong claim-back", lambda a, tabs, m: a.activate(2, m["old"])),
        ("ping-pong again", lambda a, tabs, m: a.activate(2, m["staged"], tabs[1]["z"])),
        ("swap_tenant", lambda a, tabs, m: a.swap_tenant(3, tabs[1]["w"])),
        ("stage then release", lambda a, tabs, m: a.release(a.stage(tabs[1]["v"]))),
        ("destroy a private tenant", lambda a, tabs, m: a.destroy_tenant(1)),
        ("destroy a sharer", lambda a, tabs, m: a.destroy_tenant(5)),
        ("destroy an absent tenant", lambda a, tabs, m: a.destroy_tenant(9)),
        ("compact", lambda a, tabs, m: a.compact()),
        ("dedup_sweep", lambda a, tabs, m: a.dedup_sweep()),
        ("dedup_sweep again", lambda a, tabs, m: a.dedup_sweep(limit=1)),
        ("reload after compaction", lambda a, tabs, m: a.load_tenant(1, tabs[0][1])),
    ]
    return ops


def _extra(mod):
    return {"t0_again": _tables(mod, 100), "x": _tables(mod, 201), "y": _tables(mod, 202),
            "z": _tables(mod, 203), "w": _tables(mod, 204), "v": _tables(mod, 205)}


def test_allocator_lifecycle_matches_jax_step_by_step():
    jtabs, ptabs = _tenants(jax_testing, 4), _tenants(testing, 4)
    jx, px = _extra(jax_testing), _extra(testing)
    js, ps = _specs({**jtabs, **jx}, {**ptabs, **px})
    ja, pa = jaxpath.ArenaAllocator(js), arena.ArenaAllocator(ps, "cpu")
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
    assert pm["staged"] != pm["old"]
    assert ja.counters["cow_clones"] == 1 and ja.counters["compactions"] == 1
    assert ja.counters["swaps"] == 4 and ja.counters["destroys"] == 3


def test_allocator_capacity_errors_match_jax():
    jtabs, ptabs = _tenants(jax_testing, 6), _tenants(testing, 6)
    js, ps = _specs(jtabs, ptabs, pages=4, max_tenants=4)
    ja, pa = jaxpath.ArenaAllocator(js), arena.ArenaAllocator(ps, "cpu")
    _raises_alike(lambda: ja.load_tenant(4, jtabs[0]), lambda: pa.load_tenant(4, ptabs[0]),
                  capacity=True)
    _raises_alike(lambda: ja.activate(-1, 0), lambda: pa.activate(-1, 0),
                  capacity=True)
    for t in range(4):
        assert pa.load_tenant(t, ptabs[t]) == ja.load_tenant(t, jtabs[t])
    _raises_alike(lambda: ja.stage(jtabs[5]), lambda: pa.stage(ptabs[5]),
                  capacity=True)
    # a structural edit of a shared page with no free page to copy into
    assert pa.load_tenant(0, ptabs[1]) == ja.load_tenant(0, jtabs[1]) == "share"
    assert pa.free_pages() == ja.free_pages() == 1
    assert pa.stage(ptabs[4]) == ja.stage(jtabs[4])
    _raises_alike(lambda: ja.load_tenant(0, jtabs[5]), lambda: pa.load_tenant(0, ptabs[5]),
                  capacity=True)
    _assert_same_state(ja, pa, "after the refusals")


# --- classify ----------------------------------------------------------------


def _mixed(mod, tabs, per=120, seed=7):
    """A mixed-tenant batch: ``per`` packets of each tenant (v4, v6, kinds 0
    and 3, ifindex 9 outside the slab LUTs), plus packets tagged with the
    tenant ids -1 and MAX_TENANTS."""
    parts, tags = [], []
    for t, tab in sorted(tabs.items()):
        parts.append(mod.random_batch_fast(np.random.default_rng(seed + t), tab, per))
        tags.append(np.full(per, t, np.int32))
    tags[0][:8], tags[-1][-8:] = -1, MAX_TENANTS
    cat = jax_packets.concat if mod is jax_testing else concat
    return cat(parts), np.concatenate(tags)


def _arena_pair(destroy=3):
    """The same arena on both sides: the tenants loaded, then one
    destroyed.  Returns (jax allocator, port allocator, tables each side)."""
    jtabs, ptabs = _tenants(jax_testing), _tenants(testing)
    js, ps = _specs(jtabs, ptabs)
    ja, pa = jaxpath.ArenaAllocator(js), arena.ArenaAllocator(ps, "cpu")
    for t in jtabs:
        assert pa.load_tenant(t, ptabs[t]) == ja.load_tenant(t, jtabs[t])
    ja.destroy_tenant(destroy)
    pa.destroy_tenant(destroy)
    return ja, pa, jtabs, ptabs


def _oracle_results(tabs, batch, tenant, destroyed):
    """Per-tenant oracle results; UNDEF (0) for absent tenants."""
    want = np.zeros(len(batch), np.uint32)
    for t, tab in tabs.items():
        idx = np.nonzero(tenant == t)[0]
        if t != destroyed and len(idx):
            want[idx] = oracle.classify(tab, batch.take(idx)).results
    return want


def test_plain_k3b_matches_xla_pallas_and_oracles():
    """The plain K3b over the JAX allocator's own pool (carried across by
    convert.arena_from_jax_arrays) against the XLA arena walk stage by
    stage, the Pallas paged walk in interpret mode, and the per-tenant
    oracles; the port's own pool gives the same."""
    ja, pa, jtabs, ptabs = _arena_pair()
    spec = pa.spec
    jb, jtenant = _mixed(jax_testing, jtabs)
    pb, tenant = _mixed(testing, ptabs)
    assert np.array_equal(jtenant, tenant) and np.array_equal(jb.ip_words, pb.ip_words)
    # ifindexes outside the LUT, negative and past 16 bits, on v4 packets
    pb.ifindex[20:24] = [9, -1, 70000, 1 << 30]
    jb.ifindex[20:24] = pb.ifindex[20:24]
    assert (np.asarray(pb.ifindex) >= spec.lut_rows).sum() > 20
    carried = convert.arena_from_jax_arrays(
        **{f: np.asarray(getattr(ja.arena, f)) for f in jaxpath.CtrieArena._fields}, device="cpu")
    for f in arena.CtrieArena._fields:
        assert torch.equal(getattr(carried, f), getattr(pa.arena, f)), f
    jdev = jaxpath.device_batch(jb)
    pdev = torchpath.device_batch(pb, "cpu")
    tt = torch.from_numpy(tenant)

    # stage by stage against the XLA walk
    node, alive, best0 = jaxpath._arena_ctrie_entry(ja.arena, jdev, jax.device_put(tenant),
                                                    pages=spec.pages)
    pnode, palive, pbest0 = arena_walk.arena_ctrie_entry(carried, pdev, tt, spec.pages)
    assert np.array_equal(pnode.numpy(), np.asarray(node))
    assert np.array_equal(palive.numpy(), np.asarray(alive))
    assert np.array_equal(pbest0.numpy(), np.asarray(best0))
    rows = jaxpath.arena_ctrie_rows(ja.arena, jdev, jax.device_put(tenant), pages=spec.pages,
                                    d_max=spec.d_max)
    prows, sel = arena_walk.arena_ctrie_walk_rows(carried, pdev, tt, spec.pages, spec.d_max)
    assert np.array_equal(prows.numpy().view(np.uint16), np.asarray(rows))
    jres, jxdp, jstats = jaxpath.classify_arena_ctrie(ja.arena, jdev, jax.device_put(tenant),
                                                      pages=spec.pages, d_max=spec.d_max)
    fields, words = torchpath.packet_fields(pdev)
    raw = arena_walk.arena_ctrie_walk_classify(fields, words, tt, carried, pages=spec.pages,
                                               d_max=spec.d_max)
    assert torch.equal(raw[:, 1], (sel - 1).to(torch.int32))
    res, xdp, stats = arena_walk.classify_arena_ctrie(carried, pdev, tt, pages=spec.pages,
                                                      d_max=spec.d_max)
    assert np.array_equal(res.numpy(), np.asarray(jres).view(np.int32))
    assert np.array_equal(xdp.numpy(), np.asarray(jxdp))
    assert np.array_equal(stats.numpy(), np.asarray(jstats))

    # the Pallas paged walk in interpret mode
    planes = pallas_walk.build_arena_cwalk_planes(ja.host_nodes())
    pres, pxdp, pstats = pallas_walk.classify_arena_cwalk(
        ja.arena, planes, jdev, jax.device_put(tenant), pages=spec.pages, d_max=spec.d_max,
        interpret=True)
    assert np.array_equal(res.numpy(), np.asarray(pres).view(np.int32))
    assert np.array_equal(xdp.numpy(), np.asarray(pxdp))
    assert np.array_equal(stats.numpy(), np.asarray(pstats))

    # the port's own pool, and the per-tenant oracles (UNDEF off the table)
    own = arena_walk.classify_arena_ctrie(pa.arena, pdev, tt, pages=spec.pages, d_max=spec.d_max)
    assert all(torch.equal(a, b) for a, b in zip(own, (res, xdp, stats)))
    is_ip = (pb.kind == 1) | (pb.kind == 2)
    ok = (pb.ifindex >= 0) & (pb.ifindex < 1 << 16)
    want = _oracle_results(ptabs, pb.take(np.nonzero(ok)[0]), tenant[ok], destroyed=3)
    assert np.array_equal(res.numpy()[ok].view(np.uint32), want)
    off = (tenant < 0) | (tenant >= MAX_TENANTS) | (tenant == 3)
    assert off.sum() == 136 and not res.numpy()[off].any()
    assert (res.numpy()[is_ip & ~off] != 0).sum() > 40
    assert int((raw[:, 1] >= 0).sum()) > 300


@pytest.mark.parametrize("width", [7, 6, 4, 3])
def test_fused_wire_matches_jax(width):
    """classify_arena_wire_fused (res16 + stats in one buffer) equals
    jaxpath.jitted_classify_arena_wire_fused("ctrie", ...) for each wire
    width, on the carried pool and on the port's own."""
    ja, pa, jtabs, ptabs = _arena_pair(destroy=1)
    spec = pa.spec
    pb, tenant = _mixed(testing, ptabs, per=60, seed=31)
    if width in (4, 3):
        idx = np.nonzero(pb.kind == 1)[0]
        pb, tenant = pb.take(idx), tenant[idx]
        wire = pb.pack_wire_v4()
    else:
        wire = pb.pack_wire()
    if width in (6, 3):
        wire = narrow_wire(wire)
    assert wire.shape[1] == width
    fn = jaxpath.jitted_classify_arena_wire_fused("ctrie", spec.pages, spec.d_max)
    want = np.asarray(fn(ja.arena, jax.device_put(wire), jax.device_put(tenant))).view(np.int32)
    wt = torch.from_numpy(wire.view(np.int32))
    for pool in (convert.arena_from_jax_arrays(
            **{f: np.asarray(getattr(ja.arena, f)) for f in jaxpath.CtrieArena._fields},
            device="cpu"), pa.arena):
        got = arena_walk.classify_arena_wire_fused(pool, wt, torch.from_numpy(tenant),
                                                   pages=spec.pages, d_max=spec.d_max)
        assert np.array_equal(got.numpy(), want)


def test_k3b_wrapper_runs_the_plain_version_on_the_cpu():
    _ja, pa, _jt, ptabs = _arena_pair()
    pb, tenant = _mixed(testing, ptabs, per=30)
    fields, words = torchpath.packet_fields(torchpath.device_batch(pb, "cpu"))
    before = arena_walk.KERNEL.launches
    spec = pa.spec
    got = arena_walk.arena_ctrie_walk_classify(fields, words, torch.from_numpy(tenant), pa.arena,
                                               pages=spec.pages, d_max=spec.d_max)
    want = arena_walk.arena_ctrie_walk_classify_plain(fields, words, torch.from_numpy(tenant),
                                                      pa.arena, pages=spec.pages,
                                                      d_max=spec.d_max)
    assert torch.equal(got, want) and arena_walk.KERNEL.launches == before
    assert got.shape == (len(pb), 2) and got.dtype == torch.int32
    empty = arena_walk.arena_ctrie_walk_classify(fields[:0], words[:0], torch.from_numpy(tenant[:0]),
                                                 pa.arena, pages=spec.pages, d_max=spec.d_max)
    assert empty.shape == (0, 2)


# --- the classifier ------------------------------------------------------------


def _outputs_equal(got, want):
    for f in ("results", "xdp", "stats_delta"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


@pytest.mark.parametrize("width", [7, 4, 6])
def test_classifier_matches_jax_arena_classifier(width):
    """TorchArenaClassifier(device="cpu") against ArenaClassifier(
    interpret=True, fused_deep=True) through the same lifecycle: equal load
    paths, results, verdicts, statistics, wire_stats() and
    tenant_counters(), before and after a swap, a destroy, a compaction and
    a dedup sweep."""
    jtabs, ptabs = _tenants(jax_testing), _tenants(testing)
    jx, px = _extra(jax_testing), _extra(testing)
    js, ps = _specs({**jtabs, **jx}, {**ptabs, **px})
    jc = ArenaClassifier(js, interpret=True, fused_deep=True)
    pc = TorchArenaClassifier(ps, device="cpu")
    assert pc.spec == ps and pc.device.type == "cpu"
    for t in jtabs:
        assert pc.load_tenant(t, ptabs[t]) == jc.load_tenant(t, jtabs[t])
    assert pc.load_tenant(0, px["x"]) == jc.load_tenant(0, jx["x"]) == "rewrite"
    pb, tenant = _mixed(testing, ptabs, per=50, seed=60)
    if width == 4:
        idx = np.nonzero(pb.kind == 1)[0]
        pb, tenant = pb.take(idx), tenant[idx]
        wire = pb.pack_wire_v4()
    else:
        wire = pb.pack_wire()
        if width == 6:
            wire = narrow_wire(wire)
    assert wire.shape[1] == width

    def both(step):
        got = pc.classify_async_packed_tenant(wire, tenant).result()
        want = jc.classify_async_packed_tenant(wire, tenant).result()
        _outputs_equal(got, want)
        assert pc.wire_stats() == jc.wire_stats(), step
        assert pc.tenant_counters() == jc.tenant_counters(), step
        assert pc.tenant_ids() == jc.tenant_ids(), step
        np.testing.assert_array_equal(pc.stats.snapshot(), jc.stats.snapshot())
        return got

    first = both("loaded")
    pc.swap_tenant(2, px["y"])
    jc.swap_tenant(2, jx["y"])
    swapped = both("swapped")
    idx2 = np.nonzero(tenant == 2)[0]
    assert not np.array_equal(first.results[idx2], swapped.results[idx2])
    want2 = oracle.classify(px["y"], pb.take(idx2))
    np.testing.assert_array_equal(swapped.results[idx2], want2.results)
    page = pc.stage_tenant(px["z"])
    assert page == jc.stage_tenant(jx["z"])
    pc.activate_tenant(4, page, px["z"])
    jc.activate_tenant(4, page, jx["z"])
    pc.destroy_tenant(1)
    jc.destroy_tenant(1)
    assert pc.compact() == jc.compact()
    both("compacted")
    assert pc.dedup_sweep() == jc.dedup_sweep()
    out = both("swept")
    assert not out.results[tenant == 1].any()
    batch_out = pc.classify_tenants(pb, tenant, apply_stats=False)
    np.testing.assert_array_equal(batch_out.results,
                                  jc.classify_tenants(_jax_batch(pb), tenant,
                                                      apply_stats=False).results)
    pc.close()
    with pytest.raises(RuntimeError, match="closed"):
        pc.classify_async_packed_tenant(wire, tenant)


def test_out_of_range_tenant_ids_are_undef_and_uncounted():
    """Tenant ids outside int32 (2^32 + 1, -2^32 + 1) are outside [0,
    max_tenants): every lane UNDEF, no tenant counted, as the per-tenant
    oracle and the reference's own docstring say.  The JAX classifier wraps
    such an id onto tenant 1 (a fault of the reference, kept as it is), so
    it is compared only on the in-range lanes."""
    jtabs, ptabs = _tenants(jax_testing), _tenants(testing)
    js, ps = _specs(jtabs, ptabs)
    jc = ArenaClassifier(js, interpret=True, fused_deep=True)
    pc = TorchArenaClassifier(ps, device="cpu")
    for t in jtabs:
        jc.load_tenant(t, jtabs[t])
        pc.load_tenant(t, ptabs[t])
    pb = testing.random_batch_fast(np.random.default_rng(3), ptabs[1], 64)
    wire = pb.pack_wire()
    for bad in (2**32 + 1, -(2**32) + 1):
        tenant = np.full(64, bad, np.int64)
        got = pc.classify_async_packed_tenant(wire, tenant).result()
        assert not got.results.any()
        np.testing.assert_array_equal(got.xdp, np.where(pb.kind == 0, 1, 2))
        assert not got.stats_delta.any()
        assert not any(k.startswith("tenant_1_") for k in pc.tenant_counters())
    # a mixed column: in-range lanes equal to the JAX classifier and to
    # tenant 1's oracle, the others UNDEF
    tenant = np.where(np.arange(64) % 2 == 0, 1, 2**32 + 1).astype(np.int64)
    got = pc.classify_async_packed_tenant(wire, tenant).result()
    want = jc.classify_async_packed_tenant(wire, tenant).result()
    ok = tenant == 1
    np.testing.assert_array_equal(got.results[ok], want.results[ok])
    np.testing.assert_array_equal(got.results[ok], oracle.classify(ptabs[1], pb).results[ok])
    assert not got.results[~ok].any()
    assert pc.tenant_counters()["tenant_1_packets_total"] == int(ok.sum())


def _jax_batch(pb):
    return jax_packets.PacketBatch(**{f: np.array(getattr(pb, f)) for f in (
        "kind", "l4_ok", "ifindex", "ip_words", "proto", "dst_port", "icmp_type", "icmp_code",
        "pkt_len")})


def test_classifier_empty_and_absent_tenants():
    """A batch of only absent tenants, and an empty batch: UNDEF verdicts,
    zero statistics, as the JAX classifier gives."""
    ptabs = _tenants(testing, 2)
    ps = arena.arena_spec_for("ctrie", ptabs.values(), pages=4, max_tenants=4)
    pc = TorchArenaClassifier(ps, device="cpu")
    pc.load_tenant(0, ptabs[0])
    pb = testing.random_batch_fast(np.random.default_rng(3), ptabs[0], 64)
    out = pc.classify_async_packed_tenant(pb.pack_wire(), np.full(64, 2, np.int32)).result()
    assert not out.results.any() and not out.stats_delta.any()
    np.testing.assert_array_equal(out.xdp, np.where(pb.kind == 0, 1, 2))
    empty = pc.classify_async_packed_tenant(pb.pack_wire()[:0], np.zeros(0, np.int32)).result()
    assert empty.results.shape == (0,) and not empty.stats_delta.any()
    assert pc.tenant_counters()["tenant_2_packets_total"] == 64


# --- what this slice leaves out ------------------------------------------------


def _spec(**kw):
    return arena.arena_spec_for("ctrie", _tenants(testing, 2).values(), pages=4, max_tenants=4,
                                **kw)


REFUSALS = {
    "check_invariants": lambda: TorchArenaClassifier(_spec(), "cpu", check_invariants=True),
    "spliced": lambda: arena.ArenaAllocator(_spec(
        plane_slots=2, plane_node_rows=8, plane_target_rows=8, plane_joined_rows=8,
        splice_slots=2), "cpu"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_left_out_parts_raise_not_implemented(case):
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md item \d+"):
        REFUSALS[case]()


def test_flow_table_builds_a_tier():
    """flow_table=1024 gives one 1024-entry flow slab per arena page, the
    tenant count of the spec, and flow_* counters."""
    clf = TorchArenaClassifier(_spec(), "cpu", flow_table=1024)
    cfg = clf.flow.config
    assert (cfg.entries, cfg.pages, cfg.max_tenants) == (1024, 4, 4)
    assert clf.flow_counters()["flow_capacity"] == 4 * 1024
    assert TorchArenaClassifier(_spec(), "cpu").flow is None


def test_default_device_is_cuda_or_raises():
    spec = _spec()
    if torch.cuda.is_available():
        assert TorchArenaClassifier(spec).device.type == "cuda"
        assert arena.ArenaAllocator(spec).arena.l0.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TorchArenaClassifier(spec)
        with pytest.raises(RuntimeError, match="CUDA"):
            arena.ArenaAllocator(spec)
        with pytest.raises(RuntimeError, match="CUDA"):
            convert.arena_from_jax_arrays(
                **{f: getattr(arena.ArenaAllocator(spec, "cpu").arena, f).numpy()
                   for f in arena.CtrieArena._fields})


def test_clean_tables_fast_matches_jax():
    jt = jax_testing.clean_tables_fast(np.random.default_rng(4242), 3000, width=4)
    pt = testing.clean_tables_fast(np.random.default_rng(4242), 3000, width=4)
    for f in ("key_words", "mask_words", "mask_len", "rules", "root_lut"):
        assert np.array_equal(getattr(pt, f), getattr(jt, f)), f
    assert len(pt.trie_levels) == len(jt.trie_levels)
    for a, b in zip(pt.trie_levels, jt.trie_levels):
        assert np.array_equal(a, b)
    assert {tuple(k): v.tolist() for k, v in pt.content.items()} == {
        tuple(k): np.asarray(v).tolist() for k, v in jt.content.items()}


def test_pool_bytes_and_introspection_match_jax():
    ja, pa, _jt, _pt = _arena_pair()
    assert pa.pool_bytes() == ja.pool_bytes()
    assert np.array_equal(pa.host_nodes(), ja.host_nodes())
    for t in range(N_TENANTS):
        assert (pa.tables_of(t) is None) == (ja.tables_of(t) is None)
    assert pa.family == ja.family == "ctrie"
