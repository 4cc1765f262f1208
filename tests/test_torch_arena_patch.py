"""Rules-only arena patches on the CPU against the JAX package, on both
families: a hinted edit of a private slab ("patch": the dirty dense rows,
or the dirty joined rows, written in place), of a shared slab ("cow": the
donor's canonical arrays cloned and patched, no bake), their fallbacks to
a bake, the hash-dirty pages the dedup sweep re-merges, and the same
through TorchArenaClassifier against ArenaClassifier.  After every step
the host mirrors, page tables, refcounts, hash index and counters equal the
JAX allocator's, the device pool equals its mirror, the patched slab
equals a cold bake of the edited table, and classify equals the XLA
arena classify and the per-tenant oracles.  Integers, tolerance 0."""
import jax
import numpy as np
import pytest
import torch

from infw import compiler as jax_compiler
from infw import testing as jax_testing
from infw.backend.tpu import ArenaClassifier
from infw.kernels import jaxpath
from infw_torch import arena, compiler, oracle, testing
from infw_torch.backend.cuda import TorchArenaClassifier
from infw_torch.kernels import arena_dense, arena_walk

from test_torch_arena import _assert_same_state

FAMILIES = ["dense", "ctrie"]


class _Side:
    """One package's updaters, allocator and classify."""

    def __init__(self, mod, comp, alloc, family):
        self.mod, self.comp, self.alloc, self.family = mod, comp, alloc, family
        self.upd = {}

    def updater(self, t, content):
        self.upd[t] = self.comp.IncrementalTables.from_content(dict(content), rule_width=4)
        return self.upd[t].snapshot()

    def edit(self, t, ups, dels=()):
        """One IncrementalTables generation: (snapshot, hint)."""
        u = self.upd[t]
        u.start_dirty_tracking()
        u.apply(ups, list(dels))
        hint, snap = u.peek_dirty(), u.snapshot()
        u.clear_dirty()
        return snap, hint


def _base(mod, seed=40, n=18):
    return mod.random_tables(np.random.default_rng(seed), n_entries=n, width=4, v6_fraction=0.4)


def _pair(family, n_tenants=3, pages=8):
    """Both allocators with tenants 0 and 1 on ONE shared page (two
    updaters over the same content) and tenant 2 on its own."""
    sides = []
    for mod, comp, make in ((jax_testing, jax_compiler, lambda s: jaxpath.ArenaAllocator(s)),
                            (testing, compiler, lambda s: arena.ArenaAllocator(s, "cpu"))):
        base, other = _base(mod), _base(mod, seed=41)
        side = _Side(mod, comp, None, family)
        snaps = [side.updater(0, base.content), side.updater(1, base.content),
                 side.updater(2, other.content)]
        spec = (jaxpath if mod is jax_testing else arena).arena_spec_for(
            family, snaps, pages=pages, max_tenants=n_tenants + 2)
        side.alloc = make(spec)
        side.paths = [side.alloc.load_tenant(t, s) for t, s in enumerate(snaps)]
        sides.append(side)
    j, p = sides
    assert tuple(p.alloc.spec) == tuple(j.alloc.spec)
    assert p.paths == j.paths == ["assign", "share", "assign"]
    _assert_same_state(j.alloc, p.alloc, "shared pair")
    return j, p


def _rules_edit(comp, upd, i, row):
    """{key: rules}: the i-th key (in key order) with rule slot 1 replaced."""
    k = sorted(upd.content, key=lambda k: (k.ingress_ifindex, k.ip_data, k.prefix_len))[i]
    r = np.asarray(upd.content[k]).copy()
    r[1] = row
    return {k: r}


def _classify_equal(j, p, t, tables, n=64, seed=3):
    """The tenant's packets through the XLA arena classify and the port's
    plain fused entry: equal read-back buffers, and the results the
    oracle's."""
    spec = p.alloc.spec
    b = testing.random_batch_fast(np.random.default_rng(seed), tables, n)
    wire = b.pack_wire()
    tenant = np.full(n, t, np.int32)
    d_max = spec.d_max if spec.family == "ctrie" else 0
    want = np.asarray(jaxpath.jitted_classify_arena_wire_fused(spec.family, spec.pages, d_max)(
        j.alloc.arena, jax.device_put(wire), jax.device_put(tenant)))
    tw, tt = torch.from_numpy(wire.view(np.int32)), torch.from_numpy(tenant)
    if spec.family == "dense":
        got = arena_dense.classify_arena_dense_wire_fused(p.alloc.arena, tw, tt, pages=spec.pages)
    else:
        got = arena_walk.classify_arena_wire_fused(p.alloc.arena, tw, tt, pages=spec.pages,
                                                   d_max=spec.d_max)
    np.testing.assert_array_equal(got.numpy(), want.view(np.int32))
    res16 = got.numpy()[: (n + 1) // 2].view(np.uint16)[:n]
    is_ip = ((b.kind == 1) | (b.kind == 2)) & (b.l4_ok != 0)
    np.testing.assert_array_equal(np.where(is_ip, res16, 0),
                                  oracle.classify(tables, b).results & 0xFFFF)


def _equals_cold_bake(alloc, t, tables):
    """The tenant's resident slab equals a cold bake of ``tables`` on a
    fresh allocator (canonical form, byte for byte)."""
    cold = arena.ArenaAllocator(alloc.spec, "cpu")
    cold.load_tenant(0, tables)
    for a, b in zip(alloc._canonical_of_page(alloc.page_of(t)),
                    cold._canonical_of_page(cold.page_of(0))):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("family", FAMILIES)
def test_rules_only_patch_of_a_private_slab(family):
    """A rules-only edit of tenant 2 (private): "patch", the dirty rows only,
    the page hash-dirty; the slab then equals a cold bake, classify equals
    the XLA arena classify and the oracle; an edit that folds to no dirty
    row is a "patch" too."""
    j, p = _pair(family)
    edits = {}
    for side in (j, p):
        ups = _rules_edit(side.comp, side.upd[2], 3, [1, 17, 53, 0, 0, 0, 1])
        edits[id(side)] = side.edit(2, ups)
    (js, jh), (ps, ph) = edits[id(j)], edits[id(p)]
    assert jh["levels"] and all(len(x) == 0 for x in ph["levels"])
    assert p.alloc.load_tenant(2, ps, hint=ph) == j.alloc.load_tenant(2, js, hint=jh) == "patch"
    _assert_same_state(j.alloc, p.alloc, "patch")
    assert p.alloc.page_of(2) in p.alloc._hash_dirty
    _equals_cold_bake(p.alloc, 2, ps)
    _classify_equal(j, p, 2, ps)
    # no dirty row at all
    js2, jh2 = j.edit(2, {})
    ps2, ph2 = p.edit(2, {})
    assert p.alloc.load_tenant(2, ps2, hint=ph2) == j.alloc.load_tenant(2, js2, hint=jh2)
    _assert_same_state(j.alloc, p.alloc, "empty patch")


@pytest.mark.parametrize("family", FAMILIES)
def test_cow_clone_then_patch_of_a_shared_slab(family):
    """A rules-only edit of tenant 1, which shares tenant 0's page: "cow",
    the clone in a free page, hash-dirty, the donor's refcount back to 1;
    tenant 0 classifies as before.  The same edit on tenant 0 then patches
    its now private page, both slabs hold the same bytes, and the dedup
    sweep merges them back onto one page, as the JAX allocator does."""
    j, p = _pair(family)
    row = [1, 6, 443, 0, 0, 0, 2]
    ed = {id(s): s.edit(1, _rules_edit(s.comp, s.upd[1], 0, row)) for s in (j, p)}
    assert (p.alloc.load_tenant(1, ed[id(p)][0], hint=ed[id(p)][1])
            == j.alloc.load_tenant(1, ed[id(j)][0], hint=ed[id(j)][1]) == "cow")
    _assert_same_state(j.alloc, p.alloc, "cow")
    assert p.alloc.page_of(0) != p.alloc.page_of(1)
    assert p.alloc.page_refcount(p.alloc.page_of(0)) == 1
    assert p.alloc.counters["cow_clones"] == 1 and p.alloc.page_of(1) in p.alloc._hash_dirty
    _equals_cold_bake(p.alloc, 1, ed[id(p)][0])
    _classify_equal(j, p, 1, ed[id(p)][0])
    _classify_equal(j, p, 0, p.upd[0].snapshot())
    ed0 = {id(s): s.edit(0, _rules_edit(s.comp, s.upd[0], 0, row)) for s in (j, p)}
    assert (p.alloc.load_tenant(0, ed0[id(p)][0], hint=ed0[id(p)][1])
            == j.alloc.load_tenant(0, ed0[id(j)][0], hint=ed0[id(j)][1]) == "patch")
    _assert_same_state(j.alloc, p.alloc, "patch the donor")
    assert p.alloc.dedup_sweep() == j.alloc.dedup_sweep()
    _assert_same_state(j.alloc, p.alloc, "dedup")
    assert p.alloc.page_of(0) == p.alloc.page_of(1) and p.alloc.counters["dedup_merges"] == 1
    _classify_equal(j, p, 1, ed[id(p)][0])


@pytest.mark.parametrize("family", FAMILIES)
def test_hinted_edits_that_cannot_patch_fall_back_like_jax(family):
    """A structural edit with a hint (a new key: trie levels written), a
    hint on a tenant without tables (after activate without tables), and
    a table past the slab width bake as the JAX allocator does ("rewrite",
    "cow" or the capacity error), state equal after each."""
    j, p = _pair(family)
    # a new key on tenant 2 (private): a bake, not a patch
    new = {}
    for s in (j, p):
        (k, r), = _base(s.mod, seed=77, n=1).content.items()
        new[id(s)] = s.edit(2, {k: np.asarray(r)})
    want = j.alloc.load_tenant(2, new[id(j)][0], hint=new[id(j)][1])
    assert p.alloc.load_tenant(2, new[id(p)][0], hint=new[id(p)][1]) == want
    assert want == ("rewrite" if family == "dense" or not jaxpath.hint_trie_unchanged(
        new[id(j)][1]) else "patch")
    _assert_same_state(j.alloc, p.alloc, "structural with a hint")
    # a new key on tenant 1 (shared): a full-bake cow
    for s in (j, p):
        (k, r), = _base(s.mod, seed=78, n=1).content.items()
        new[id(s)] = s.edit(1, {k: np.asarray(r)})
    assert (p.alloc.load_tenant(1, new[id(p)][0], hint=new[id(p)][1])
            == j.alloc.load_tenant(1, new[id(j)][0], hint=new[id(j)][1]))
    _assert_same_state(j.alloc, p.alloc, "structural cow")
    # activate without tables forgets them: the next hinted edit bakes
    for s in (j, p):
        s.alloc.activate(2, s.alloc.page_of(2))
    ed = {id(s): s.edit(2, _rules_edit(s.comp, s.upd[2], 1, [2, 0, 0, 0, 0, 0, 1]))
          for s in (j, p)}
    assert (p.alloc.load_tenant(2, ed[id(p)][0], hint=ed[id(p)][1])
            == j.alloc.load_tenant(2, ed[id(j)][0], hint=ed[id(j)][1]))
    _assert_same_state(j.alloc, p.alloc, "no old tables")
    _classify_equal(j, p, 2, ed[id(p)][0])


@pytest.mark.parametrize("family", FAMILIES)
def test_random_edit_stream_matches_jax(family):
    """A seeded stream of 30 edits over four tenants (two starting on one
    shared page): rules-only edits, new keys, deletes and no-ops, each
    applied as one hinted load on both sides; the paths, the state and the
    per-tenant classify equal after every step."""
    sides = []
    for mod, comp, make in ((jax_testing, jax_compiler, lambda s: jaxpath.ArenaAllocator(s)),
                            (testing, compiler, lambda s: arena.ArenaAllocator(s, "cpu"))):
        side = _Side(mod, comp, None, family)
        tabs = [_base(mod, 60 + (t % 3), n=14) for t in range(4)]
        snaps = [side.updater(t, tabs[t].content) for t in range(4)]
        extra = _base(mod, 99, n=40)
        spec = (jaxpath if mod is jax_testing else arena).arena_spec_for(
            family, snaps + [extra], pages=10, max_tenants=6, headroom=1.5)
        side.alloc = make(spec)
        side.paths = [side.alloc.load_tenant(t, s) for t, s in enumerate(snaps)]
        side.pool = list(extra.content.items())
        sides.append(side)
    j, p = sides
    assert j.paths == p.paths and "share" in p.paths
    rng = np.random.default_rng(7)
    seen = set()
    for step in range(30):
        t = int(rng.integers(4))
        kind = ("rules", "rules", "add", "delete", "noop")[int(rng.integers(5))]
        i = int(rng.integers(1000))
        out = []
        for s in (j, p):
            u = s.upd[t]
            keys = sorted(u.content, key=lambda k: (k.ingress_ifindex, k.ip_data, k.prefix_len))
            if kind == "rules" and keys:
                ups, dels = _rules_edit(s.comp, u, i % len(keys),
                                        [1 + i % 200, 6, i % 65536, 0, 0, 0, 1 + i % 2]), ()
            elif kind == "add":
                k, r = s.pool[i % len(s.pool)]
                ups = {k: np.asarray(r)}
                if k.masked_identity() in u._ident_to_t or not u.fits(ups):
                    ups = {}  # a live key, or deeper than the trie: skipped
                dels = ()
            elif kind == "delete" and len(keys) > 2:
                ups, dels = {}, (keys[i % len(keys)],)
            else:
                ups, dels = {}, ()
            snap, hint = s.edit(t, ups, dels)
            out.append((s.alloc.load_tenant(t, snap, hint=hint), snap))
        assert out[0][0] == out[1][0], (step, kind, out[0][0], out[1][0])
        seen.add(out[1][0])
        _assert_same_state(j.alloc, p.alloc, (step, kind))
        _classify_equal(j, p, t, out[1][1], n=48, seed=step)
    assert {"patch", "cow"} <= seen


@pytest.mark.parametrize("family", FAMILIES)
def test_classifier_hinted_loads_match_jax(family):
    """TorchArenaClassifier.load_tenant(hint=...) against ArenaClassifier
    (the fused walk on for the ctrie family, as the port serves K3b): the
    rules-only edits go to the allocator ("patch", "cow") in both, a
    structural one stages and flips ("rewrite") on a ctrie pool and bakes
    through the allocator on a dense one; classify and counters equal."""
    jx = {"interpret": True, "fused_deep": family == "ctrie"}
    sides = []
    for mod, comp, make in ((jax_testing, jax_compiler,
                             lambda s: ArenaClassifier(s, **jx)),
                            (testing, compiler, lambda s: TorchArenaClassifier(s, device="cpu"))):
        side = _Side(mod, comp, None, family)
        base = _base(mod)
        snaps = [side.updater(0, base.content), side.updater(1, base.content)]
        spec = (jaxpath if mod is jax_testing else arena).arena_spec_for(
            family, snaps, pages=6, max_tenants=4, headroom=2.0)
        side.alloc = make(spec)
        side.paths = [side.alloc.load_tenant(t, s) for t, s in enumerate(snaps)]
        sides.append(side)
    j, p = sides
    assert j.paths == p.paths
    row = [4, 17, 53, 0, 0, 0, 1]
    steps = [(1, "rules"), (0, "rules"), (0, "rules"), (1, "add")]
    for t, kind in steps:
        ed = {}
        for s in (j, p):
            if kind == "rules":
                ed[id(s)] = s.edit(t, _rules_edit(s.comp, s.upd[t], 2, row))
            else:
                (k, r), = _base(s.mod, seed=88, n=1).content.items()
                ed[id(s)] = s.edit(t, {k: np.asarray(r)})
        want = j.alloc.load_tenant(t, ed[id(j)][0], hint=ed[id(j)][1])
        assert p.alloc.load_tenant(t, ed[id(p)][0], hint=ed[id(p)][1]) == want, (t, kind)
        b = testing.random_batch_fast(np.random.default_rng(t), ed[id(p)][0], 64)
        tenant = np.full(64, t, np.int32)
        got = p.alloc.classify_async_packed_tenant(b.pack_wire(), tenant).result()
        ref = j.alloc.classify_async_packed_tenant(b.pack_wire(), tenant).result()
        np.testing.assert_array_equal(got.results, ref.results)
        np.testing.assert_array_equal(got.results, oracle.classify(ed[id(p)][0], b).results)
        assert p.alloc.tenant_counters() == j.alloc.tenant_counters(), (t, kind)
    assert p.alloc.allocator.counters["patches"] >= 1
    assert p.alloc.allocator.counters["cow_clones"] == 1
