"""The fused wire-to-verdict entries of K3 and K3b on the CPU (their plain
versions, which the card's kernels are held against) against the JAX
package's fused functions on the same wire: jaxpath.
jitted_classify_ctrie_wire_fused at every wire width,
jitted_classify_ctrie_wire8_fused(d_max, False) and
jitted_classify_arena_wire_fused("ctrie", ...), all on XLA.  Every word of
the read-back buffer (the u16 results, then all 6144 statistics words) is
compared exactly: integers, tolerance 0."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from infw.kernels import jaxpath
from infw_torch import testing
from infw_torch.constants import MAX_TARGETS
from infw_torch.kernels import arena_walk, cwalk, torchpath
from infw_torch.packets import narrow_wire, wire8
from test_torch_arena import MAX_TENANTS, _arena_pair, _mixed
from test_torch_walk import _compile_pair, _hazard_content

STATS_WORDS = MAX_TARGETS * torchpath.STATS_COLS
#: 2 is wire8 (results only)
CTRIE_WIDTHS = (3, 4, 6, 7, 2)
#: one packet, an odd count, 2^11 + 1
SIZES = (1, 777, 2049)
# (width, B) cases: every width, each size on a narrow and a full width.
# Each new wire shape is one XLA compile of the reference (about 3.5 s on
# the CPU), so the cases do not take every product.
CTRIE_CASES = ((3, 777), (4, 2049), (6, 2049), (7, 777), (7, 1), (2, 2049), (2, 1))
ARENA_CASES = ((3, 2049), (4, 777), (6, 777), (7, 2049), (7, 1))
#: rows forced to the lanes finalize zeroes: malformed, other ethertype,
#: and an IP packet whose L4 parse failed
ZERO_ROWS = {1: ("kind", 0), 2: ("kind", 3), 3: ("l4_ok", 0), 4: ("l4_ok", 0)}
#: full-wire-only packet lengths: 2^16 and the 21-bit maximum
LONG_LENGTHS = (1 << 16, (1 << 21) - 1)


def _zeroed(pb):
    """The rows of ZERO_ROWS set on a copy of ``pb``; returns it and their
    indices."""
    pb = pb.take(np.arange(len(pb)))
    rows = np.array([i for i in sorted(ZERO_ROWS) if i < len(pb)], np.int64)
    for i in rows:
        field, value = ZERO_ROWS[i]
        getattr(pb, field)[i] = value
    return pb, rows


def _pack(pb, width):
    """(wire uint32, ifmap or None) of ``pb`` at ``width`` (2 = wire8)."""
    full = pb.pack_wire_v4() if width in (2, 3, 4) else pb.pack_wire()
    if width in (3, 6):
        full = narrow_wire(full)
    if width == 2:
        return wire8(full)
    assert full is not None and full.shape[1] == width
    return full, None


def _port(fn, *args, **kw):
    return fn(*(torch.from_numpy(np.ascontiguousarray(a).view(np.int32)) for a in args),
              **kw).numpy()


@pytest.fixture(scope="module")
def ctrie():
    """The hazard table (3000 entries x 8 rule slots, v4 /0 entries, rules
    with actions 0 and 3) on both sides, and 2049-packet v4-compact and
    mixed batches."""
    jt, pt = _compile_pair(_hazard_content(42, 3000))
    cdev, d_max = jaxpath.device_ctrie(jt)
    rng = np.random.default_rng(44)
    mixed = testing.random_batch_fast(rng, pt, 4 * max(SIZES))
    v4 = mixed.take(np.nonzero((mixed.kind != 2) & ~mixed.ip_words[:, 1:].any(axis=1))[0])
    assert len(v4) >= max(SIZES)
    return {"ct": cwalk.build_ctrie_tables(pt, "cpu"), "cdev": cdev, "d_max": d_max,
            "mixed": mixed.slice(0, max(SIZES)), "v4": v4.slice(0, max(SIZES))}


def _ctrie_reference(c, wire, ifmap):
    if ifmap is None:
        fn = jaxpath.jitted_classify_ctrie_wire_fused(c["d_max"])
        return np.asarray(fn(c["cdev"], jnp.asarray(wire))).view(np.int32)
    fn = jaxpath.jitted_classify_ctrie_wire8_fused(c["d_max"], False)
    return np.asarray(fn(c["cdev"], jnp.asarray(wire), jnp.asarray(ifmap))).view(np.int32)


def _ctrie_port(c, wire, ifmap):
    if ifmap is None:
        return _port(lambda w: cwalk.classify_ctrie_wire_fused(c["ct"], w), wire)
    return _port(lambda w, m: cwalk.classify_ctrie_wire8(c["ct"], w, m), wire, ifmap)


def _counted(res16):
    """Lanes whose result counts in the statistics: ALLOW or DENY."""
    return np.isin(res16 & 0xFF, (1, 2))


@pytest.mark.parametrize("width,B", CTRIE_CASES)
def test_ctrie_fused_matches_jax(ctrie, width, B):
    """classify_ctrie_wire_fused / classify_ctrie_wire8 on the CPU equal the
    JAX package's fused functions word for word; the lanes finalize zeroes
    are zero and count nowhere; on the full wire, two counted packets of
    lengths 2^16 and 2^21 - 1 add their high bits."""
    pb, zero = _zeroed((ctrie["v4"] if width in (2, 3, 4) else ctrie["mixed"]).slice(0, B))
    nw = (B + 1) // 2
    long_rows = []
    if width in (4, 7) and B > 1:
        res16 = torchpath.unpack_res16_host(_ctrie_port(ctrie, *_pack(pb, width))[:nw], B)
        long_rows = np.nonzero(_counted(res16))[0][:len(LONG_LENGTHS)]
        pb.pkt_len[long_rows] = LONG_LENGTHS
    wire, ifmap = _pack(pb, width)
    want = _ctrie_reference(ctrie, wire, ifmap)
    got = _ctrie_port(ctrie, wire, ifmap)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert got.shape == (nw + (0 if width == 2 else STATS_WORDS),)
    res16 = torchpath.unpack_res16_host(got[:nw], B)
    if B > 1:
        assert len(zero) == len(ZERO_ROWS) and not res16[zero].any()
        assert (res16 != 0).sum() > B // 8
    if width != 2 and B > 1:
        stats = got[nw:].reshape(MAX_TARGETS, -1)
        assert stats[:, [0, 3]].sum() == _counted(res16).sum()  # every counted lane once
    if len(long_rows):
        hi = got[nw:].reshape(MAX_TARGETS, -1)[:, [1, 4]].sum()
        assert len(long_rows) == 2 and hi >= sum(n >> 8 for n in LONG_LENGTHS)


@pytest.mark.parametrize("width", CTRIE_WIDTHS)
def test_ctrie_fused_empty_batch(ctrie, width):
    """B = 0 (the port only: the reference raises on a 0-packet chunk): no
    results, all statistics zero."""
    ifmap = np.full(16, -1, np.int32) if width == 2 else None
    got = _ctrie_port(ctrie, np.zeros((0, width), np.uint32), ifmap)
    assert got.dtype == np.int32
    assert np.array_equal(got, np.zeros(0 if width == 2 else STATS_WORDS, np.int32))


def test_ctrie_stats_wrap_modulo_2_32():
    """A 1-entry table (a v4 /0 on ifindex 2 whose catch-all rule ALLOWs)
    and 525,312 packets of the 21-bit maximum length: the allow_hi column,
    8191 x 525,312 > 2^32, wraps as the reference's int32 sum does."""
    rows = np.zeros((4, 7), np.int32)
    rows[0] = [7, 0, 0, 0, 0, 0, 2]
    jt, pt = _compile_pair({(32, 2, bytes(16)): rows}, 4)
    n = 525_312
    pb = testing.random_batch_fast(np.random.default_rng(5), pt, 16).take(np.zeros(n, np.int64))
    pb.kind[:], pb.l4_ok[:], pb.ifindex[:], pb.pkt_len[:] = 1, 1, 2, (1 << 21) - 1
    pb.ip_words[:, 1:] = 0
    wire = pb.pack_wire_v4()
    cdev, d_max = jaxpath.device_ctrie(jt)
    want = np.asarray(jaxpath.jitted_classify_ctrie_wire_fused(d_max)(
        cdev, jnp.asarray(wire))).view(np.int32)
    got = _port(lambda w: cwalk.classify_ctrie_wire_fused(cwalk.build_ctrie_tables(pt, "cpu"), w),
                wire)
    assert np.array_equal(got, want)
    stats = got[(n + 1) // 2:].reshape(MAX_TARGETS, -1).view(np.uint32)
    assert stats[7, 0] == n and stats[7, 2] == 255 * n
    assert 8191 * n > 1 << 32 and stats[7, 1] == (8191 * n) % (1 << 32)


@pytest.fixture(scope="module")
def arena_case():
    """tests/test_torch_arena.py's arena on both sides (5 tenants, tenant 3
    destroyed) and a mixed batch: v4, v6, kinds 0 and 3, ifindex 9 outside
    the slab LUTs, tenant ids -1, MAX_TENANTS and the destroyed tenant's."""
    ja, pa, _jt, ptabs = _arena_pair()
    pb, tenant = _mixed(testing, ptabs, per=1000, seed=17)
    order = np.random.default_rng(3).permutation(len(pb))  # tenants and kinds interleaved
    return {"ja": ja, "pa": pa, "pb": pb.take(order), "tenant": tenant[order]}


@pytest.mark.parametrize("width,B", ARENA_CASES)
def test_arena_fused_matches_jax(arena_case, width, B):
    """classify_arena_wire_fused on the CPU equals jaxpath.
    jitted_classify_arena_wire_fused("ctrie", ...) word for word, with the
    invalid and destroyed tenants' lanes zero."""
    pb, tenant = arena_case["pb"], arena_case["tenant"]
    if width in (3, 4):
        idx = np.nonzero((pb.kind != 2) & ~pb.ip_words[:, 1:].any(axis=1))[0]
        pb, tenant = pb.take(idx), tenant[idx]
    pb, zero = _zeroed(pb.slice(0, B))
    tenant = np.ascontiguousarray(tenant[:B])
    wire, _ = _pack(pb, width)
    spec = arena_case["pa"].spec
    fn = jaxpath.jitted_classify_arena_wire_fused("ctrie", spec.pages, spec.d_max)
    want = np.asarray(fn(arena_case["ja"].arena, jnp.asarray(wire),
                         jnp.asarray(tenant))).view(np.int32)
    got = arena_walk.classify_arena_wire_fused(
        arena_case["pa"].arena, torch.from_numpy(wire.view(np.int32)), torch.from_numpy(tenant),
        pages=spec.pages, d_max=spec.d_max).numpy()
    assert np.array_equal(got, want)
    nw = (B + 1) // 2
    res16 = torchpath.unpack_res16_host(got[:nw], B)
    if B > 1:
        off = (tenant < 0) | (tenant >= MAX_TENANTS) | (tenant == 3)
        assert off.any() and not res16[off].any()
        assert len(zero) == len(ZERO_ROWS) and not res16[zero].any()
        assert (res16 != 0).sum() > B // 40 and got[nw:].any()


def test_arena_fused_empty_batch(arena_case):
    spec = arena_case["pa"].spec
    got = arena_walk.classify_arena_wire_fused(
        arena_case["pa"].arena, torch.zeros((0, 7), dtype=torch.int32),
        torch.zeros(0, dtype=torch.int32), pages=spec.pages, d_max=spec.d_max)
    assert got.dtype == torch.int32 and torch.equal(got, torch.zeros(STATS_WORDS,
                                                                      dtype=torch.int32))


def test_fused_wrappers_run_the_plain_versions_on_the_cpu(ctrie, arena_case):
    """On CPU tensors the fused wrappers are their plain versions and
    launch nothing."""
    before = (cwalk.FUSED_KERNEL.launches, arena_walk.FUSED_KERNEL.launches,
              cwalk.KERNEL.launches, arena_walk.KERNEL.launches)
    wire, ifmap = _pack(ctrie["v4"].slice(0, 300), 2)
    w8, m8 = torch.from_numpy(wire.view(np.int32)), torch.from_numpy(ifmap)
    assert torch.equal(cwalk.classify_ctrie_wire8(ctrie["ct"], w8, m8),
                       cwalk.classify_ctrie_wire8_plain(ctrie["ct"], w8, m8))
    w7 = torch.from_numpy(ctrie["mixed"].slice(0, 300).pack_wire().view(np.int32))
    assert torch.equal(cwalk.classify_ctrie_wire_fused(ctrie["ct"], w7),
                       cwalk.classify_ctrie_wire_fused_plain(ctrie["ct"], w7))
    spec = arena_case["pa"].spec
    wa = torch.from_numpy(arena_case["pb"].slice(0, 300).pack_wire().view(np.int32))
    ta = torch.from_numpy(np.ascontiguousarray(arena_case["tenant"][:300]))
    kw = {"pages": spec.pages, "d_max": spec.d_max}
    assert torch.equal(arena_walk.classify_arena_wire_fused(arena_case["pa"].arena, wa, ta, **kw),
                       arena_walk.classify_arena_wire_fused_plain(arena_case["pa"].arena, wa, ta,
                                                                  **kw))
    assert (cwalk.FUSED_KERNEL.launches, arena_walk.FUSED_KERNEL.launches,
            cwalk.KERNEL.launches, arena_walk.KERNEL.launches) == before
