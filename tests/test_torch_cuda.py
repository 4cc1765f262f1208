"""Kernels K1, K2, K3, K4, K3b, K5, K6, K7, K8, K9, K10 and K11 on the card against
their plain PyTorch versions, at small sizes, K3's and K3b's fused wire-to-verdict
entries, the wire codecs through the classifier, the multi-tenant arena
classifier, patched tables and the overlay combine.

Needs a CUDA card and nvcc; skips elsewhere.  Run on the card with

    python -m pytest -m cuda tests/test_torch_cuda.py

Whether a card exists is decided inside the fixture, so every pytest
worker collects the same tests.
"""
import numpy as np
import pytest
import torch

from infw_torch import arena, compiler, oracle, testing
from infw_torch.backend.cuda import TorchArenaClassifier, TorchClassifier
from infw_torch.kernels import (all_kernels, arena_dense, arena_walk, cwalk, dense, gather,
                                torchpath, walk, wire_decode)
from infw_torch.packets import concat, narrow_wire, wire8

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernel has no CPU mode)")
    return torch.device("cuda:0")


@pytest.mark.parametrize("n_entries,width,n_packets", [
    (1, 2, 1), (40, 12, 300), (129, 8, 1000), (700, 100, 5000),
])
def test_k1_matches_plain(cuda, n_entries, width, n_packets):
    rng = np.random.default_rng(n_entries)
    tables = testing.random_tables(rng, n_entries, ifindexes=(2, 3), width=width)
    batch = testing.random_batch_fast(rng, tables, n_packets)
    dt = dense.build_dense_tables(tables, cuda)
    fields, words = torchpath.packet_fields(torchpath.device_batch(batch, cuda))
    before = dense.KERNEL.launches
    got = dense.dense_classify(fields, words, dt)
    torch.cuda.synchronize()
    assert dense.KERNEL.launches == before + 1
    want = dense.dense_classify_plain(fields, words, dt)
    assert torch.equal(got, want)
    cpu = dense.dense_classify(fields.cpu(), words.cpu(), dense.build_dense_tables(tables, "cpu"))
    assert torch.equal(got.cpu(), cpu)


def _k1_against_plain(dt, batch, device):
    fields, words = torchpath.packet_fields(torchpath.device_batch(batch, device))
    before = dense.KERNEL.launches
    got = dense.dense_classify(fields, words, dt)
    torch.cuda.synchronize()
    assert dense.KERNEL.launches == before + 1
    want = dense.dense_classify_plain(fields, words, dt)
    assert torch.equal(got, want)
    return got


@pytest.mark.parametrize("rule_width", [0, 4, 100, 128])
@pytest.mark.parametrize("n_entries", [128, 1000, 4096])
def test_k1_tensor_cores_match_plain(cuda, n_entries, rule_width):
    """K1 at batch sizes that are no multiple of its packet tile, at the
    smallest, the headline and the largest table, and at rule widths 0
    (LPM only) through 128."""
    rng = np.random.default_rng(n_entries + rule_width)
    tables = testing.random_tables_fast(rng, n_entries, ifindexes=(2, 3, 4),
                                        width=max(rule_width, 2), v6_fraction=0.4)
    dt = dense.build_dense_tables(tables, cuda)
    dt = dt._replace(rules=dt.rules[:, :rule_width].contiguous())
    for n_packets in (1, 17, 1000, (1 << 16) + 5):
        got = _k1_against_plain(dt, testing.random_batch_fast(rng, tables, n_packets), cuda)
    assert (got[:, 1] >= 0).sum() > n_packets // 4


def test_k1_cap_zero_full_and_duplicate_rows(cuda):
    """The IPv4 /32 cap for every kind, /0 and /128 entries, and two rows
    with identical key, mask and length (the first index wins)."""
    rows = np.zeros((4, 7), np.int32)
    rows[1] = [1, 0, 0, 0, 0, 0, 2]
    addr = bytes([203, 0, 113, 9])
    content = {
        compiler.LpmKey(32, 2, bytes(16)): rows,
        compiler.LpmKey(32 + 24, 2, addr + bytes(12)): rows,
        compiler.LpmKey(32 + 32, 2, addr + bytes(12)): rows,
        compiler.LpmKey(32 + 48, 2, addr + bytes([0, 0]) + bytes(10)): rows,
        compiler.LpmKey(32 + 128, 2, bytes.fromhex("20010db8000000000000000000000001")): rows,
    }
    tables = compiler.compile_tables_from_content(content, rule_width=4)
    batch = testing.random_batch_fast(np.random.default_rng(4), tables, 3000)
    batch.ip_words[::3] = [0xCB007109, 0, 0, 0]
    batch.ifindex[::2] = 2
    out = _k1_against_plain(dense.build_dense_tables(tables, cuda), batch, cuda)
    assert set(tables.mask_len[out[:, 1][out[:, 1] >= 0].cpu().numpy()]) >= {0, 32, 48}

    rng = np.random.default_rng(17)
    dup = testing.random_tables(rng, 30, ifindexes=(2,), width=4)
    for name in ("key_words", "mask_words", "mask_len", "rules"):
        arr = getattr(dup, name)
        arr[7] = arr[3]
        arr[20] = arr[3]
    batch = testing.random_batch_fast(rng, dup, 2000)
    batch.ifindex[::2] = 2
    batch.ip_words[::2] = dup.key_words[3, 1:5]
    out = _k1_against_plain(dense.build_dense_tables(dup, cuda), batch, cuda)
    assert (out[:, 1] == 3).any() and not np.isin(out[:, 1].cpu().numpy(), [7, 20]).any()


def test_k1_many_ifindexes_folded_and_generic_groups(cuda):
    """Forty ifindexes: the common ones fold, the rest and a rare ifindex
    of four entries stay in the generic groups, where the ifindex word is
    multiplied, so a packet on an unfolded ifindex must win over the
    folded groups' maxima."""
    rng = np.random.default_rng(40)
    tables = testing.random_tables_fast(rng, 1500, ifindexes=tuple(range(2, 42)), width=4,
                                        v6_fraction=0.5)
    tables.key_words[:4, 0] = 77  # a rare ifindex of four entries
    dt = dense.build_dense_tables(tables, cuda)
    groups = dt.groups.numpy()
    folded_ifx = groups[(groups[:, 1] & dense.FOLDED) != 0, 2]
    assert len(folded_ifx) and 77 not in folded_ifx
    assert ((groups[:, 1] & dense.FOLDED) == 0).any()
    batch = testing.random_batch_fast(rng, tables, 3000)
    batch.ifindex[:100] = 77
    batch.ip_words[:100] = tables.key_words[np.arange(100) % 4, 1:5]
    batch.kind[:100] = np.where(tables.mask_len[np.arange(100) % 4] > 32, 2, 1)
    out = _k1_against_plain(dt, batch, cuda)[:, 1].cpu().numpy()
    assert np.isin(out[:100], [0, 1, 2, 3]).all()
    won = batch.ifindex[out >= 0]
    assert np.isin(won, folded_ifx).any() and (~np.isin(won, folded_ifx)).sum() > 100


def test_k1_empty_table_and_empty_batch(cuda):
    tables = compiler.compile_tables_from_content({}, rule_width=4)
    dt = dense.build_dense_tables(tables, cuda)
    batch = testing.random_batch_fast(np.random.default_rng(1), tables, 300)
    fields, words = torchpath.packet_fields(torchpath.device_batch(batch, cuda))
    out = dense.dense_classify(fields, words, dt)
    assert torch.equal(out, dense.dense_classify_plain(fields, words, dt))
    assert (out[:, 1] == -1).all()
    empty = dense.dense_classify(fields[:0], words[:0], dt)
    assert empty.shape == (0, 2)


def test_k1_rejects_bad_operands(cuda):
    tables = testing.random_tables(np.random.default_rng(2), 10, width=4)
    dt = dense.build_dense_tables(tables, cuda)
    fields = torch.zeros((8, 8), dtype=torch.int32, device=cuda)
    words = torch.zeros((8, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        dense.dense_classify(fields.long(), words, dt)
    with pytest.raises(ValueError):
        dense.dense_classify(fields[:, :7], words, dt)
    with pytest.raises(ValueError):
        dense.dense_classify(fields, words.t().contiguous().t(), dt)


def test_classifier_on_card_matches_oracle(cuda):
    rng = np.random.default_rng(6)
    tables = testing.random_tables(rng, 60, ifindexes=(2, 3, 4), width=20)
    batch = testing.random_batch_fast(rng, tables, 2000)
    clf = TorchClassifier()
    clf.load_tables(tables)
    before = dense.KERNEL.launches
    out = clf.classify(batch)
    assert dense.KERNEL.launches == before + 1
    ref = oracle.classify(tables, batch)
    np.testing.assert_array_equal(out.results, ref.results)
    np.testing.assert_array_equal(out.xdp, ref.xdp)
    assert testing.stats_dict_from_array(out.stats_delta) == ref.stats


def _k2_k3_against_plain(fields, words, tt, ct, grid=0):
    """K2 at every level count and K3 on the card, each one launch, equal
    to their plain versions; ``grid`` > 0 caps K2's grid."""
    for n_levels in range(1, tt.n_levels + 1):
        before = walk.KERNEL.launches
        got = walk.trie_walk_classify(fields, words, tt, n_levels, _grid=grid)
        torch.cuda.synchronize()
        assert walk.KERNEL.launches == before + 1
        assert torch.equal(got, walk.trie_walk_classify_plain(fields, words, tt, n_levels)), n_levels
    before = cwalk.KERNEL.launches
    got = cwalk.ctrie_walk_classify(fields, words, ct)
    torch.cuda.synchronize()
    assert cwalk.KERNEL.launches == before + 1
    assert torch.equal(got, cwalk.ctrie_walk_classify_plain(fields, words, ct))


@pytest.mark.parametrize("pattern", testing.DEPTH_PATTERNS)
def test_k2_k3_match_plain_on_depth_adversarial_batches(cuda, pattern):
    """K2 (the lane-refilling walk) and K3 where a warp's lanes diverge
    most: a /128 chain per ifindex (every level below the root holds a
    target) under all-deep, alternating, one-deep-per-32 and root-only
    batches."""
    tables, batch, deep = testing.depth_adversarial(np.random.default_rng(1), 20_000, pattern)
    tt = walk.build_trie_tables(tables, cuda, pad=True)
    ct = cwalk.build_ctrie_tables(tables, cuda, pad=True)
    fields, words = torchpath.packet_fields(torchpath.device_batch(batch, cuda))
    assert torch.equal(cwalk.walk_depths(fields, words, ct).cpu(),
                       torch.from_numpy(np.where(deep, testing.DEEP_ROWS, 0).astype(np.int32)))
    _k2_k3_against_plain(fields, words, tt, ct)


@pytest.mark.parametrize("B", [0, 1, 31, 33, 257, (1 << 16) + 5])
def test_k2_k3_ragged_batches(cuda, B):
    """Batches that fill no warp, a warp and one lane, and many warps
    unevenly; K2's last 32-packet chunk is short."""
    rng = np.random.default_rng(B)
    tables = testing.random_tables_fast(rng, 5000, ifindexes=(2, 3, 4), width=8, v6_fraction=0.6)
    batch = testing.random_batch_fast(rng, tables, max(B, 1)).slice(0, B)
    tt = walk.build_trie_tables(tables, cuda, pad=True)
    ct = cwalk.build_ctrie_tables(tables, cuda, pad=True)
    fields, words = torchpath.packet_fields(torchpath.device_batch(batch, cuda))
    _k2_k3_against_plain(fields, words, tt, ct)


@pytest.mark.parametrize("grid", [1, 2, 7])
@pytest.mark.parametrize("pattern", ["alternating", "one_deep_per_32", "random"])
def test_k2_k3_forced_small_grid(cuda, grid, pattern):
    """K2 on a grid of 1, 2 or 7 blocks over 50,000 packets: every lane
    refills tens of times, across depth changes, and the warps' chunk
    sequences differ in length (K3 alongside, on its own grid)."""
    rng = np.random.default_rng(grid)
    if pattern == "random":
        tables = testing.random_tables_fast(rng, 5000, ifindexes=(2, 3, 4), width=8,
                                            v6_fraction=0.6)
        batch = testing.random_batch_fast(rng, tables, 50_000)
    else:
        tables, batch, _ = testing.depth_adversarial(rng, 50_000, pattern)
    tt = walk.build_trie_tables(tables, cuda, pad=True)
    ct = cwalk.build_ctrie_tables(tables, cuda, pad=True)
    fields, words = torchpath.packet_fields(torchpath.device_batch(batch, cuda))
    _k2_k3_against_plain(fields, words, tt, ct, grid=grid)


@pytest.mark.parametrize("n_entries,width,n_packets", [(1, 2, 1), (300, 8, 3000), (5000, 12, 20000)])
def test_k2_matches_plain_at_every_level_count(cuda, n_entries, width, n_packets):
    rng = np.random.default_rng(n_entries)
    tables = testing.random_tables_fast(rng, n_entries, ifindexes=(2, 3, 4), width=width,
                                        v6_fraction=0.5)
    batch = testing.random_batch_fast(rng, tables, n_packets)
    tt = walk.build_trie_tables(tables, cuda)
    cpu_tt = walk.build_trie_tables(tables, "cpu")
    fields, words = torchpath.packet_fields(torchpath.device_batch(batch, cuda))
    for n_levels in range(1, tt.n_levels + 1):
        before = walk.KERNEL.launches
        got = walk.trie_walk_classify(fields, words, tt, n_levels)
        torch.cuda.synchronize()
        assert walk.KERNEL.launches == before + 1
        want = walk.trie_walk_classify_plain(fields, words, tt, n_levels)
        assert torch.equal(got, want), n_levels
        cpu = walk.trie_walk_classify(fields.cpu(), words.cpu(), cpu_tt, n_levels)
        assert torch.equal(got.cpu(), cpu), n_levels


def test_k2_rejects_bad_operands(cuda):
    tables = testing.random_tables_fast(np.random.default_rng(3), 50, width=4)
    tt = walk.build_trie_tables(tables, cuda)
    fields = torch.zeros((8, 8), dtype=torch.int32, device=cuda)
    words = torch.zeros((8, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        walk.trie_walk_classify(fields.long(), words, tt, tt.n_levels)
    with pytest.raises(ValueError):
        walk.trie_walk_classify(fields, words, tt, tt.n_levels + 1)
    with pytest.raises(ValueError):
        walk.trie_walk_classify(fields, words, tt, 0)
    assert walk.trie_walk_classify(fields[:0], words[:0], tt, 1).shape == (0, 2)


def test_trie_classifier_on_card_matches_oracle(cuda):
    rng = np.random.default_rng(8)
    tables = testing.random_tables_fast(rng, 4200, ifindexes=(2, 3, 4), width=10)
    batch = testing.random_batch_fast(rng, tables, 3000)
    clf = TorchClassifier()
    clf.load_tables(tables)
    assert clf.active_path == "trie"
    before = walk.KERNEL.launches
    out = clf.classify(batch)
    assert walk.KERNEL.launches == before + 1
    ref = oracle.classify(tables, batch)
    np.testing.assert_array_equal(out.results, ref.results)
    np.testing.assert_array_equal(out.xdp, ref.xdp)
    assert testing.stats_dict_from_array(out.stats_delta) == ref.stats


@pytest.mark.parametrize("table", ["random_fast", "clean_scale"])
def test_k3_matches_plain(cuda, table):
    """K3 on a table with deep /128 skip chains and on the clean /24 + /48
    distribution, every packet, against the plain walk on the card and on
    the CPU."""
    rng = np.random.default_rng(31)
    if table == "random_fast":
        tables = testing.random_tables_fast(rng, 5000, ifindexes=(2, 3, 4), width=8,
                                            v6_fraction=0.6)
    else:
        tables = testing.clean_tables_scale(rng, 30_000)
    batch = testing.random_batch_fast(rng, tables, 20_000)
    ct = cwalk.build_ctrie_tables(tables, cuda)
    fields, words = torchpath.packet_fields(torchpath.device_batch(batch, cuda))
    before = cwalk.KERNEL.launches
    got = cwalk.ctrie_walk_classify(fields, words, ct)
    torch.cuda.synchronize()
    assert cwalk.KERNEL.launches == before + 1
    assert torch.equal(got, cwalk.ctrie_walk_classify_plain(fields, words, ct))
    cpu = cwalk.ctrie_walk_classify(fields.cpu(), words.cpu(), cwalk.build_ctrie_tables(tables, "cpu"))
    assert torch.equal(got.cpu(), cpu)
    assert int((got[:, 1] >= 0).sum()) > 1000


def test_k3_rejects_bad_operands(cuda):
    tables = testing.random_tables_fast(np.random.default_rng(3), 50, width=4)
    ct = cwalk.build_ctrie_tables(tables, cuda)
    fields = torch.zeros((8, 8), dtype=torch.int32, device=cuda)
    words = torch.zeros((8, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        cwalk.ctrie_walk_classify(fields.long(), words, ct)
    with pytest.raises(ValueError):
        cwalk.ctrie_walk_classify(fields, words, ct._replace(joined=ct.joined.int()))
    with pytest.raises(ValueError):
        cwalk.ctrie_walk_classify(fields, words[:, :3], ct)
    assert cwalk.ctrie_walk_classify(fields[:0], words[:0], ct).shape == (0, 2)


def test_ctrie_classifier_on_card_matches_trie_path_and_oracle(cuda):
    rng = np.random.default_rng(9)
    tables = testing.random_tables_fast(rng, 4200, ifindexes=(2, 3, 4), width=10)
    batch = testing.random_batch_fast(rng, tables, 3000)
    clf, trie = TorchClassifier(compressed=True), TorchClassifier(force_path="trie")
    clf.load_tables(tables)
    trie.load_tables(tables)
    assert clf.active_path == "ctrie" and trie.active_path == "trie"
    k3, k3f, k2 = cwalk.KERNEL.launches, cwalk.FUSED_KERNEL.launches, walk.KERNEL.launches
    out = clf.classify(batch)
    assert cwalk.FUSED_KERNEL.launches == k3f + 1
    assert cwalk.KERNEL.launches == k3 and walk.KERNEL.launches == k2
    ref = trie.classify(batch)
    for f in ("results", "xdp", "stats_delta"):
        np.testing.assert_array_equal(getattr(out, f), getattr(ref, f), err_msg=f)
    want = oracle.classify(tables, batch)
    np.testing.assert_array_equal(out.results, want.results)
    assert testing.stats_dict_from_array(out.stats_delta) == want.stats


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("fixed_w", [1, 2, 4])
@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 5000, (1 << 20) + 7, (1 << 24) + 7])
def test_k4_matches_plain(cuda, fixed_w, n, offset):
    """K4 against its plain version, from an aligned and an odd byte offset,
    on random bytes (the width-4 sums wrap past 2^32), and on the CPU; at
    2^24 + 7 values every block of the grid scans more than one chunk."""
    rng = np.random.default_rng(fixed_w * 7 + n)
    buf = torch.from_numpy(rng.integers(0, 256, n * fixed_w + 5).astype(np.uint8)).to(cuda)
    c = buf[offset:]
    assert c.data_ptr() % 2 == offset
    before = wire_decode.KERNEL.launches
    got = wire_decode.decode_scan(c, n, fixed_w)
    torch.cuda.synchronize()
    assert wire_decode.KERNEL.launches == before + 1
    assert torch.equal(got, wire_decode.decode_scan_plain(c, n, fixed_w))
    assert torch.equal(got.cpu(), wire_decode.decode_scan(c.cpu(), n, fixed_w))


def test_k4_on_two_streams_at_once(cuda):
    """Cooperative launches of K4 queued on two streams together: every
    call's result exact."""
    rng = np.random.default_rng(77)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    inputs = [
        torch.from_numpy(rng.integers(0, 256, n * w + 1).astype(np.uint8)).to(cuda)[1:]
        for n, w in (((1 << 20) + 3, 4), ((1 << 22) + 9, 1))
    ]
    widths = (4, 1)
    sizes = ((1 << 20) + 3, (1 << 22) + 9)
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(8):
        for k in range(2):
            with torch.cuda.stream(streams[k]):
                outs[k].append(wire_decode.decode_scan(inputs[k], sizes[k], widths[k]))
    torch.cuda.synchronize()
    for k in range(2):
        want = wire_decode.decode_scan_plain(inputs[k], sizes[k], widths[k])
        for got in outs[k]:
            assert torch.equal(got, want)


def test_k4_rejects_bad_operands(cuda):
    c = torch.zeros(64, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        wire_decode.decode_scan(c.to(torch.int32), 4, 1)
    with pytest.raises(ValueError):
        wire_decode.decode_scan(c, 4, 3)
    with pytest.raises(ValueError):
        wire_decode.decode_scan(c, 17, 4)
    with pytest.raises(ValueError):
        wire_decode.decode_scan(c[::2], 8, 1)
    assert wire_decode.decode_scan(c, 0, 2).shape == (0,)


@pytest.mark.parametrize("path", ["trie", "ctrie"])
@pytest.mark.parametrize("codec", ["auto", "wire8", "delta"])
def test_codec_classifier_on_card_matches_cpu_and_oracle(cuda, path, codec):
    """The IPv4-compact chunk through each codec on the card: the same
    results, verdicts, statistics and wire_stats() as on the CPU, and the
    oracle's; the delta chunks launch K4, the wire8 chunks do not."""
    rng = np.random.default_rng(10)
    tables = testing.random_tables_fast(rng, 4200, ifindexes=(2, 3, 4), width=10)
    batch = testing.random_batch_fast(rng, tables, 6000)
    v4 = np.nonzero(batch.kind == 1)[0]
    wire, v4_only = batch.pack_wire_subset(v4)
    assert wire.shape[1] == 4
    clf = TorchClassifier(force_path=path, wire_codec=codec)
    cpu = TorchClassifier(device="cpu", force_path=path, wire_codec=codec)
    clf.load_tables(tables)
    cpu.load_tables(tables)
    before = wire_decode.KERNEL.launches
    out = clf.classify_async_packed(wire, v4_only).result()
    launched = wire_decode.KERNEL.launches - before
    ref = cpu.classify_async_packed(wire, v4_only).result()
    for f in ("results", "xdp", "stats_delta"):
        np.testing.assert_array_equal(getattr(out, f), getattr(ref, f), err_msg=f)
    assert clf.wire_stats() == cpu.wire_stats()
    assert launched == (1 if "delta" in clf.wire_stats() else 0)
    want = oracle.classify(tables, batch.take(v4))
    np.testing.assert_array_equal(out.results, want.results)
    assert testing.stats_dict_from_array(out.stats_delta) == want.stats


def _arena_tenants(n, entries, seed0=100):
    return [testing.random_tables_fast(np.random.default_rng(seed0 + t), entries, width=4,
                                       ifindexes=(2, 3), v6_fraction=0.4)
            for t in range(n)]


@pytest.mark.parametrize("n_tenants,entries,per", [(3, 24, 200), (40, 64, 500)])
def test_k3b_matches_plain(cuda, n_tenants, entries, per):
    """K3b against its plain version on the card and on the CPU, on a
    mixed-tenant batch with invalid tenant ids (-1, max_tenants, a destroyed
    tenant), ifindexes outside the slab LUTs and lanes that die in the
    descent."""
    tabs = _arena_tenants(n_tenants, entries)
    spec = arena.arena_spec_for("ctrie", tabs, pages=n_tenants + 2, max_tenants=n_tenants + 1)
    allocs = {d: arena.ArenaAllocator(spec, d) for d in (cuda, "cpu")}
    for a in allocs.values():
        for t, tab in enumerate(tabs):
            a.load_tenant(t, tab)
        a.destroy_tenant(1)
    parts = [testing.random_batch_fast(np.random.default_rng(7 + t), tab, per)
             for t, tab in enumerate(tabs)]
    batch = concat(parts)
    tenant = np.repeat(np.arange(n_tenants, dtype=np.int32), per)
    tenant[:16], tenant[-16:] = -1, n_tenants + 1
    batch.ifindex[16:32] = [9, -1, 70000, 1 << 30] * 4
    fields, words = torchpath.packet_fields(torchpath.device_batch(batch, cuda))
    tt = torch.from_numpy(tenant).to(cuda)
    before = arena_walk.KERNEL.launches
    got = arena_walk.arena_ctrie_walk_classify(fields, words, tt, allocs[cuda].arena,
                                               pages=spec.pages, d_max=spec.d_max)
    torch.cuda.synchronize()
    assert arena_walk.KERNEL.launches == before + 1
    want = arena_walk.arena_ctrie_walk_classify_plain(fields, words, tt, allocs[cuda].arena,
                                                      pages=spec.pages, d_max=spec.d_max)
    assert torch.equal(got, want)
    cpu = arena_walk.arena_ctrie_walk_classify(fields.cpu(), words.cpu(), tt.cpu(),
                                               allocs["cpu"].arena, pages=spec.pages,
                                               d_max=spec.d_max)
    assert torch.equal(got.cpu(), cpu)
    off = (tenant < 0) | (tenant > n_tenants - 1) | (tenant == 1)
    assert (got[torch.from_numpy(off).to(cuda)] == torch.tensor([0, -1], device=cuda)).all()
    assert int((got[:, 1] >= 0).sum()) > per // 4


def test_k3b_rejects_bad_operands(cuda):
    tabs = _arena_tenants(2, 24)
    spec = arena.arena_spec_for("ctrie", tabs, pages=4, max_tenants=4)
    al = arena.ArenaAllocator(spec, cuda)
    fields = torch.zeros((8, 8), dtype=torch.int32, device=cuda)
    words = torch.zeros((8, 4), dtype=torch.int32, device=cuda)
    tenant = torch.zeros(8, dtype=torch.int32, device=cuda)
    kw = {"pages": spec.pages, "d_max": spec.d_max}
    with pytest.raises(ValueError):
        arena_walk.arena_ctrie_walk_classify(fields, words, tenant.long(), al.arena, **kw)
    with pytest.raises(ValueError):
        arena_walk.arena_ctrie_walk_classify(fields, words, tenant[:7], al.arena, **kw)
    with pytest.raises(ValueError):
        arena_walk.arena_ctrie_walk_classify(fields, words, tenant, al.arena, pages=3,
                                             d_max=spec.d_max)
    with pytest.raises(ValueError):
        arena_walk.arena_ctrie_walk_classify(fields, words, tenant,
                                             al.arena._replace(joined=al.arena.joined.int()), **kw)
    assert arena_walk.arena_ctrie_walk_classify(fields[:0], words[:0], tenant[:0], al.arena,
                                                **kw).shape == (0, 2)


def test_arena_classifier_on_card_matches_oracle_after_swap(cuda):
    """TorchArenaClassifier() on the card: K3b's fused entry once per mixed
    classify and no other kernel, the
    per-tenant oracles before and after a swap (the swapped tenant's
    packets then give the new table's verdicts), UNDEF for absent tenants,
    and the same outputs as on the CPU."""
    from infw_torch.packets import concat

    tabs = _arena_tenants(6, 48)
    new = testing.random_tables_fast(np.random.default_rng(999), 48, width=4)
    spec = arena.arena_spec_for("ctrie", tabs + [new], pages=9, max_tenants=8)
    clf, cpu = TorchArenaClassifier(spec), TorchArenaClassifier(spec, device="cpu")
    assert clf.device.type == "cuda"
    for c in (clf, cpu):
        for t, tab in enumerate(tabs):
            c.load_tenant(t, tab)
    parts = [testing.random_batch_fast(np.random.default_rng(50 + t), tab, 400)
             for t, tab in enumerate(tabs)]
    batch = concat(parts)
    tenant = np.repeat(np.arange(6, dtype=np.int32), 400)
    tenant[:20] = 7  # absent
    wire = batch.pack_wire()

    def check(tables_of):
        before = _launch_counts()
        out = clf.classify_async_packed_tenant(wire, tenant).result()
        assert _launch_deltas(before) == {"arena_wire_fused": 1}
        ref = cpu.classify_async_packed_tenant(wire, tenant).result()
        for f in ("results", "xdp", "stats_delta"):
            np.testing.assert_array_equal(getattr(out, f), getattr(ref, f), err_msg=f)
        for t in range(6):
            idx = np.nonzero(tenant == t)[0]
            want = oracle.classify(tables_of(t), batch.take(idx))
            np.testing.assert_array_equal(out.results[idx], want.results)
            np.testing.assert_array_equal(out.xdp[idx], want.xdp)
        assert not out.results[:20].any()
        return out

    before = check(lambda t: tabs[t])
    for c in (clf, cpu):
        c.swap_tenant(2, new)
    after = check(lambda t: new if t == 2 else tabs[t])
    idx2 = tenant == 2
    assert not np.array_equal(before.results[idx2], after.results[idx2])
    assert clf.tenant_counters() == cpu.tenant_counters()


#: K5's tables: the tool's (4096, 128), one row, narrow rows, a width past
#: one warp's load, and (65536, 8), above the rows whose sums it stages
K5_SHAPES = ((4096, 128), (1, 4), (4096, 4), (5000, 256), (65536, 8))


def _k5_operands(n: int, w: int, b: int, device):
    """Indices outside [0, N) with the int32 edges among them, and table
    words near 2^32 so that every row sum wraps."""
    rng = np.random.default_rng(n * 31 + w + b)
    table = torch.from_numpy((2**32 - rng.integers(1, 2**26, (n, w))).astype(np.uint32)
                             .view(np.int32)).to(device)
    idx = rng.integers(-n, 2 * n, b).astype(np.int64)
    idx[: min(b, 3)] = [2**31 - 1, -(2**31), n][: min(b, 3)]
    return torch.from_numpy(idx.astype(np.int32)).to(device), table


@pytest.mark.parametrize("b", [1, 3, 1023, 1025, (1 << 20) + 3])
@pytest.mark.parametrize("n,w", K5_SHAPES)
def test_k5_matches_plain(cuda, n, w, b):
    """K5 against its plain version, exact, on both branches (row sums
    staged in shared memory, and read through L2 above the cap), at the
    co-resident grid and under forced grids of 1 and 3 blocks (each thread
    then serves many groups of four indices); one launch a call."""
    idx, table = _k5_operands(n, w, b, cuda)
    assert (n > gather.STAGED_MAX_ROWS) == ((n, w) == (65536, 8))
    want = gather.gather_rowsum_plain(idx, table)
    for grid in (0, 1, 3):
        before = gather.KERNEL.launches
        got = gather.gather_rowsum(idx, table, _grid=grid)
        torch.cuda.synchronize()
        assert gather.KERNEL.launches == before + 1
        assert torch.equal(got, want), grid
    assert torch.equal(got.cpu(), gather.gather_rowsum(idx.cpu(), table.cpu()))


def test_k5_rejects_bad_operands(cuda):
    """On a CUDA tensor K5 launches or raises; an empty batch launches
    nothing."""
    idx, table = _k5_operands(4096, 128, 64, cuda)
    before = gather.KERNEL.launches
    assert gather.gather_rowsum(idx[:0], table).shape == (0,)
    assert gather.KERNEL.launches == before
    with pytest.raises(ValueError, match="int32"):
        gather.gather_rowsum(idx.long(), table)
    with pytest.raises(ValueError, match="multiple of 4"):
        gather.gather_rowsum(idx, table[:, :6].contiguous())
    with pytest.raises(ValueError, match="aligned"):
        gather.gather_rowsum(idx[1:], table)
    with pytest.raises(ValueError, match="contiguous"):
        gather.gather_rowsum(idx, table[:, :64])
    with pytest.raises(ValueError, match="N >= 1"):
        gather.gather_rowsum(idx, table[:0])
    assert gather.KERNEL.launches == before


def _k5_ops(n: int, w: int) -> dict:
    """(kernels a call, memsets a call) of one K5 call at B = 2^20 over an
    (n, w) table (``_ops_per_call``)."""
    idx, table = _k5_operands(n, w, 1 << 20, "cuda:0")
    kernels, memsets = _ops_per_call(lambda: gather.gather_rowsum(idx, table))
    return {"kernels": kernels, "memsets": memsets}


#: _k5_ops in a fresh process (see _K7_K8_OPS_CHILD)
_K5_OPS_CHILD = r"""
import json, sys
sys.path.insert(0, "tests")
import test_torch_cuda
print(json.dumps(test_torch_cuda._k5_ops(int(sys.argv[1]), int(sys.argv[2]))))
"""


@pytest.mark.parametrize("n,w", [(4096, 128), (65536, 8)])
def test_k5_is_one_kernel_a_call(cuda, n, w):
    """Each K5 call is one cooperative kernel on the card and no memset
    (the profiler, in a process of its own), on both branches."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    proc = subprocess.run([sys.executable, "-c", _K5_OPS_CHILD, str(n), str(w)],
                          cwd=Path(__file__).resolve().parents[1], capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    kernels = got["kernels"]
    assert len(kernels) == 1 and "gather_rowsum_kernel" in next(iter(kernels)), kernels
    assert next(iter(kernels.values())) == pytest.approx(1.0), kernels
    assert got["memsets"] == 0, got


def _churn(rng, content, r):
    """Even rounds: 4 deletes and 5 new /24-/32 keys; odd rounds: 3
    rules-only rewrites."""
    keys = list(content)
    if r % 2 == 0:
        dels = [keys[int(i)] for i in rng.choice(len(keys), size=4, replace=False)]
        for k in dels:
            del content[k]
        adds = {}
        while len(adds) < 5:
            m = int(rng.integers(24, 33))
            ip = (int(rng.integers(0, 2**32)) & (0xFFFFFFFF << (32 - m))).to_bytes(4, "big")
            key = compiler.LpmKey(32 + m, 2, ip + bytes(12))
            if key not in content:
                rows = np.zeros((4, 7), np.int32)
                rows[1] = [1, 6, int(rng.integers(1, 65000)), 0, 0, 0, int(rng.integers(1, 3))]
                adds[key] = rows
        content.update(adds)
        return adds, dels
    ups = {}
    for i in rng.choice(len(keys), size=3, replace=False):
        rows = np.array(content[keys[int(i)]])
        rows[1, 6] = 3 - rows[1, 6]
        ups[keys[int(i)]] = rows
    content.update(ups)
    return ups, []


@pytest.mark.parametrize("layout_name", ["trie", "ctrie"])
def test_patched_tables_on_card_equal_fresh_padded_builds(cuda, layout_name):
    """walk.patch_trie_tables / cwalk.patch_ctrie on the card, hinted:
    every round equal to a fresh padded build on the card, and K2 / K3 on
    the patched tables equal to the plain version."""
    build, patch = {"trie": (walk.build_trie_tables, walk.patch_trie_tables),
                    "ctrie": (cwalk.build_ctrie_tables, cwalk.patch_ctrie)}[layout_name]
    rng = np.random.default_rng(61)
    content = dict(testing.random_tables_fast(rng, 3000, width=4).content)
    it = compiler.IncrementalTables.from_content(content, rule_width=4)
    prev = it.snapshot()
    dev = build(prev, cuda, pad=True)
    it.clear_dirty()
    patched = 0
    for r in range(4):
        ups, dels = _churn(rng, content, r)
        it.apply(ups, deletes=dels)
        new = it.snapshot()
        out = patch(dev, prev, new, cuda, hint=it.peek_dirty())
        fresh = build(new, cuda, pad=True)
        dev = fresh if out is None else out[0]
        patched += out is not None
        for f in fresh._fields:
            a, b = getattr(dev, f), getattr(fresh, f)
            assert (torch.equal(a, b) if isinstance(b, torch.Tensor) else a == b), f
        it.clear_dirty()
        prev = new
    assert patched >= 2
    batch = testing.random_batch_fast(rng, prev, 3000)
    fields, words = torchpath.packet_fields(torchpath.device_batch(batch, cuda))
    if layout_name == "trie":
        got = walk.trie_walk_classify(fields, words, dev, dev.n_levels)
        want = walk.trie_walk_classify_plain(fields, words, dev, dev.n_levels)
    else:
        got = cwalk.ctrie_walk_classify(fields, words, dev)
        want = cwalk.ctrie_walk_classify_plain(fields, words, dev)
    assert torch.equal(got, want)


@pytest.mark.parametrize("codec", ["wire8", "delta"])
@pytest.mark.parametrize("path", ["trie", "ctrie"])
def test_overlay_classify_on_card_matches_cpu(cuda, path, codec):
    """TorchClassifier with an overlay on the card: K1 for the overlay and
    K2 or K3 for the main table once per classify, results equal to the
    port on the CPU and to the oracle over both tables."""
    rng = np.random.default_rng(62)
    main = dict(testing.random_tables_fast(rng, 3000, width=4, ifindexes=(2, 3)).content)
    ov_content = {}
    while len(ov_content) < 40:
        ip = int(rng.integers(0, 2**32)).to_bytes(4, "big")
        key = compiler.LpmKey(32 + 30, int(rng.choice([2, 3])), ip + bytes(12))
        if key.masked_identity() not in {k.masked_identity() for k in main}:
            rows = np.zeros((4, 7), np.int32)
            rows[2] = [2, 0, 0, 0, 0, 0, 1]
            ov_content[key] = rows
    tables = compiler.compile_tables_from_content(main, rule_width=4)
    ov = compiler.compile_tables_from_content(ov_content, rule_width=4)
    merged = compiler.compile_tables_from_content({**main, **ov_content}, rule_width=4)
    batch = testing.random_batch_fast(rng, merged, 4000)
    batch.ip_words[batch.kind != 2, 1:] = 0
    clf = TorchClassifier(force_path=path, wire_codec=codec)
    cpu = TorchClassifier(device="cpu", force_path=path, wire_codec=codec)
    for c in (clf, cpu):
        c.load_tables(tables, overlay=ov)
    main_k = walk.KERNEL if path == "trie" else cwalk.KERNEL
    v4 = np.nonzero(batch.kind == 1)[0]
    for label, run in (("mixed", lambda c: c.classify(batch)),
                       ("v4 chunk", lambda c: c.classify_async_packed(
                           *batch.pack_wire_subset(v4)).result())):
        k1, km = dense.KERNEL.launches, main_k.launches
        out = run(clf)
        assert dense.KERNEL.launches == k1 + 1 and main_k.launches == km + 1, label
        ref = run(cpu)
        for f in ("results", "xdp", "stats_delta"):
            np.testing.assert_array_equal(getattr(out, f), getattr(ref, f), err_msg=f"{label} {f}")
    out = clf.classify(batch)
    want = oracle.classify(merged, batch)
    np.testing.assert_array_equal(out.results, want.results)
    assert (out.results >> 8 == 2).any()


# --- K3's and K3b's fused wire-to-verdict entries ----------------------------

FUSED_SIZES = [0, 1, 31, 33, 257, 4097, (1 << 16) + 5]
LONG_LENGTHS = ((1 << 21) - 1, 1 << 16)


def _launch_counts():
    return {k.name: k.launches for k in all_kernels()}


def _launch_deltas(before):
    """{kernel name: launches since ``before``}, the kernels launched only."""
    return {k.name: k.launches - before[k.name] for k in all_kernels()
            if k.launches != before[k.name]}


def _fused_wires(batch, device):
    """{width: (wire, ifmap or None)} on ``device``, every fused width: the
    full formats with every 97th packet 2^21 - 1 and the next 2^16 bytes
    long, the v4-compact ones (4, 3, wire8 2) on the IPv4-compactable
    packets (kinds 0 and 3 among them), the narrow ones on the packets
    whose ifindex fits 16 bits."""
    ok = (batch.ifindex >= 0) & (batch.ifindex < 1 << 16)
    v4 = batch.take(np.nonzero(ok & (batch.kind != 2) & ~batch.ip_words[:, 1:].any(axis=1))[0])
    mixed = batch.take(np.nonzero(ok)[0])
    long = batch.take(np.arange(len(batch)))
    long_v4 = v4.take(np.arange(len(v4)))
    for b in (long, long_v4):
        for k, n in enumerate(LONG_LENGTHS):
            b.pkt_len[k::97] = n
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)
    w8, ifmap = wire8(v4.pack_wire_v4())
    return {7: (put(long.pack_wire()), None), 4: (put(long_v4.pack_wire_v4()), None),
            6: (put(narrow_wire(mixed.pack_wire())), None),
            3: (put(narrow_wire(v4.pack_wire_v4())), None), 2: (put(w8), put(ifmap))}


@pytest.fixture(scope="module")
def fused_case():
    """A 5000-entry ctrie table (60% IPv6) with 200,000 packets, and a
    6-tenant arena (tenant 1 destroyed) with 210,000 packets of its tenants
    plus ids -1, 6 (absent) and 7 (past max_tenants); each batch packed at
    every fused width, on the card and on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernel has no CPU mode)")
    rng = np.random.default_rng(77)
    tables = testing.random_tables_fast(rng, 5000, ifindexes=(2, 3, 4), width=8, v6_fraction=0.6)
    batch = testing.random_batch_fast(rng, tables, 200_000)
    tabs = _arena_tenants(6, 64)
    spec = arena.arena_spec_for("ctrie", tabs, pages=8, max_tenants=7)
    pools = {}
    for d in ("cuda", "cpu"):
        al = arena.ArenaAllocator(spec, d)
        for t, tab in enumerate(tabs):
            al.load_tenant(t, tab)
        al.destroy_tenant(1)
        pools[d] = al.arena
    parts = [testing.random_batch_fast(np.random.default_rng(300 + t), tab, 35_000)
             for t, tab in enumerate(tabs)]
    order = rng.permutation(6 * 35_000)
    tb = concat(parts).take(order)
    tenant = np.repeat(np.arange(6, dtype=np.int32), 35_000)[order]
    tenant[::50], tenant[1::50], tenant[2::50] = -1, 6, 7
    return {
        "ct": {d: cwalk.build_ctrie_tables(tables, d, pad=True) for d in ("cuda", "cpu")},
        "wires": {d: _fused_wires(batch, d) for d in ("cuda", "cpu")},
        "pool": pools, "kw": {"pages": spec.pages, "d_max": spec.d_max},
        "arena_wires": {d: _fused_wires(tb, d) for d in ("cuda", "cpu")},
        "tenant": tenant, "arena_rows": _fused_rows(tb),
    }


def _fused_rows(batch):
    """The batch rows behind each width's wire (_fused_wires' selection)."""
    ok = (batch.ifindex >= 0) & (batch.ifindex < 1 << 16)
    v4 = np.nonzero(ok & (batch.kind != 2) & ~batch.ip_words[:, 1:].any(axis=1))[0]
    return {7: np.arange(len(batch)), 4: v4, 6: np.nonzero(ok)[0], 3: v4}


def _ctrie_fused(case, width, B, device="cuda", grid=0):
    wire, ifmap = case["wires"][device][width]
    ct = case["ct"][device]
    if ifmap is None:
        return (lambda: cwalk.classify_ctrie_wire_fused(ct, wire[:B], _grid=grid),
                lambda: cwalk.classify_ctrie_wire_fused_plain(ct, wire[:B]))
    return (lambda: cwalk.classify_ctrie_wire8(ct, wire[:B], ifmap, _grid=grid),
            lambda: cwalk.classify_ctrie_wire8_plain(ct, wire[:B], ifmap))


def _arena_fused(case, width, B, device="cuda", grid=0):
    wire, _ = case["arena_wires"][device][width]
    tenant = torch.from_numpy(case["tenant"][case["arena_rows"][width]][:B].copy()).to(device)
    pool, kw = case["pool"][device], case["kw"]
    return (lambda: arena_walk.classify_arena_wire_fused(pool, wire[:B], tenant, _grid=grid,
                                                         **kw),
            lambda: arena_walk.classify_arena_wire_fused_plain(pool, wire[:B], tenant, **kw))


def _one_launch_equal(kernel, pair, cpu_pair=None):
    """The fused entry once on the card: one count of ``kernel`` and no
    other, its buffer equal to the plain version's on the card (and to the
    CPU's when given)."""
    run, plain = pair
    before = _launch_counts()
    got = run()
    torch.cuda.synchronize()
    assert _launch_deltas(before) == {kernel.name: 1}
    assert torch.equal(got, plain())
    if cpu_pair is not None:
        assert torch.equal(got.cpu(), cpu_pair[0]())
    return got


@pytest.mark.parametrize("B", FUSED_SIZES)
def test_k3_fused_matches_plain(fused_case, B):
    """K3's fused entry at every width and wire8 on ragged batches: the
    whole read-back buffer equal to the plain version's, on the card and
    on the CPU, one launch and no other kernel."""
    for width in (7, 6, 4, 3, 2):
        got = _one_launch_equal(cwalk.FUSED_KERNEL, _ctrie_fused(fused_case, width, B),
                                _ctrie_fused(fused_case, width, B, "cpu"))
        n = (B + 1) // 2 + (0 if width == 2 else 6144)
        assert got.shape == (n,), width
        if B > 1000:
            assert int((got[:(B + 1) // 2] != 0).sum()) > B // 8, width
            if width != 2:
                assert int(got[-6144:].view(-1, 6)[:, [1, 4]].sum()) > 0, width


@pytest.mark.parametrize("B", FUSED_SIZES)
def test_k3b_fused_matches_plain(fused_case, B):
    """K3b's fused entry at every width on ragged mixed-tenant batches
    (invalid, absent and destroyed tenants among them): equal to the plain
    version on the card and on the CPU, one launch and no other kernel."""
    for width in cwalk.WIRE_WIDTHS:
        got = _one_launch_equal(arena_walk.FUSED_KERNEL, _arena_fused(fused_case, width, B),
                                _arena_fused(fused_case, width, B, "cpu"))
        assert got.shape == ((B + 1) // 2 + 6144,), width
        if B > 1000:
            assert int((got[:(B + 1) // 2] != 0).sum()) > B // 8 and got[-6144:].any(), width


@pytest.mark.parametrize("grid", [1, 2, 7])
def test_fused_forced_small_grid(fused_case, grid):
    """Both fused entries on a grid of 1, 2 or 7 blocks over the whole
    batch: each thread takes hundreds of packets and each block's
    statistics table sums them all before its one flush."""
    for width in (7, 3, 2):
        _one_launch_equal(cwalk.FUSED_KERNEL, _ctrie_fused(fused_case, width, None, grid=grid))
    for width in (6, 4):
        _one_launch_equal(arena_walk.FUSED_KERNEL,
                          _arena_fused(fused_case, width, None, grid=grid))


def test_fused_stats_wrap(cuda):
    """525,312 ALLOW packets of 2^21 - 1 bytes on a 1-entry table (a v4 /0
    on ifindex 2) and on an arena holding it: the allow_hi column passes
    2^32 and wraps, equal to the plain versions."""
    rows = np.zeros((4, 7), np.int32)
    rows[0] = [7, 0, 0, 0, 0, 0, 2]
    tables = compiler.compile_tables_from_content(
        {compiler.LpmKey(32, 2, bytes(16)): rows}, rule_width=4)
    n = 525_312
    pb = testing.random_batch_fast(np.random.default_rng(5), tables, 16).take(np.zeros(n, np.int64))
    pb.kind[:], pb.l4_ok[:], pb.ifindex[:], pb.pkt_len[:] = 1, 1, 2, (1 << 21) - 1
    pb.ip_words[:, 1:] = 0
    wire = torch.from_numpy(pb.pack_wire_v4().view(np.int32)).to(cuda)
    ct = cwalk.build_ctrie_tables(tables, cuda, pad=True)
    got = _one_launch_equal(cwalk.FUSED_KERNEL, (
        lambda: cwalk.classify_ctrie_wire_fused(ct, wire),
        lambda: cwalk.classify_ctrie_wire_fused_plain(ct, wire)))
    stats = got[(n + 1) // 2:].view(-1, 6).cpu().numpy().view(np.uint32)
    assert stats[7, 0] == n and stats[7, 1] == (8191 * n) % (1 << 32) and 8191 * n > 1 << 32
    spec = arena.arena_spec_for("ctrie", [tables], pages=4, max_tenants=2)
    al = arena.ArenaAllocator(spec, cuda)
    al.load_tenant(0, tables)
    tenant = torch.zeros(n, dtype=torch.int32, device=cuda)
    kw = {"pages": spec.pages, "d_max": spec.d_max}
    got_b = _one_launch_equal(arena_walk.FUSED_KERNEL, (
        lambda: arena_walk.classify_arena_wire_fused(al.arena, wire, tenant, **kw),
        lambda: arena_walk.classify_arena_wire_fused_plain(al.arena, wire, tenant, **kw)))
    assert torch.equal(got_b, got)


def _device_ops(fn):
    """torch.profiler over one call after a warm one: (kernels, memsets)
    the card ran, traced again (up to three times) when the trace holds
    fewer kernels than the runtime's launch records."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        dev = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        api = sum(e.name.startswith(("cudaLaunch", "cuLaunch")) for e in prof.events()
                  if e.device_type == DeviceType.CPU)
        kernels = [n for n in dev if not n.startswith(("Memset", "Memcpy"))]
        if len(kernels) >= api:
            return kernels, [n for n in dev if n.startswith("Memset")]
    raise AssertionError("the profiler lost kernel events three times")


def test_fused_passes_are_one_memset_and_one_kernel(fused_case):
    """On the card each fused entry runs no torch op on the batch: the
    profiler sees one kernel (the fused K3 or K3b) and at most one memset
    per pass."""
    for name, (run, _plain) in (
            ("ctrie_wire_fused", _ctrie_fused(fused_case, 6, 4097)),
            ("ctrie_wire_fused", _ctrie_fused(fused_case, 2, 4097)),
            ("arena_wire_fused", _arena_fused(fused_case, 7, 4097))):
        kernels, memsets = _device_ops(run)
        assert len(kernels) == 1 and name in kernels[0], (name, kernels)
        assert len(memsets) <= 1, (name, memsets)


def test_fused_rejects_bad_operands(fused_case):
    ct = fused_case["ct"]["cuda"]
    wire, _ = fused_case["wires"]["cuda"][7]
    w8, ifmap = fused_case["wires"]["cuda"][2]
    for bad in (wire[:8, :5].contiguous(), wire[:8].long(), wire[:8, ::2], w8[:8]):
        with pytest.raises(ValueError):
            cwalk.classify_ctrie_wire_fused(ct, bad)
    with pytest.raises(ValueError):
        cwalk.classify_ctrie_wire8(ct, w8[:8], ifmap[:0])
    with pytest.raises(ValueError):
        cwalk.classify_ctrie_wire8(ct, wire[:8], ifmap)
    with pytest.raises(ValueError):
        cwalk.classify_ctrie_wire_fused(ct._replace(joined=ct.joined.int()), wire[:8])
    pool, kw = fused_case["pool"]["cuda"], fused_case["kw"]
    tenant = torch.zeros(8, dtype=torch.int32, device="cuda")
    for bad_wire, bad_tenant in ((wire[:8], tenant.long()), (wire[:8], tenant[:7]),
                                 (w8[:8], tenant), (wire[:8], tenant.cpu())):
        with pytest.raises(ValueError):
            arena_walk.classify_arena_wire_fused(pool, bad_wire, bad_tenant, **kw)


@pytest.mark.parametrize("n_cidrs,kernel", [(60, "dense_classify"), (4400, "trie_walk")])
def test_daemon_serves_on_the_card(cuda, tmp_path, n_cidrs, kernel):
    """Daemon() (the default backend: the first card) over one NodeState
    and one frames file: its verdicts equal the oracle's and the launch
    counts show the path's kernel."""
    import json
    import os

    from infw_torch import daemon, spec
    from infw_torch.interfaces import Interface, InterfaceRegistry
    from infw_torch.obs import pcap

    ifaces = {"eth0": 2, "eth1": 3}
    reg = InterfaceRegistry()
    for name, index in ifaces.items():
        reg.add(Interface(name=name, index=index))
    d = daemon.Daemon(state_dir=str(tmp_path / "state"), node_name="n", registry=reg,
                      metrics_port=0, health_port=0, file_poll_interval_s=60.0)
    try:
        assert d.syncer._factory.keywords["device"].type == "cuda"
        doc = testing.random_nodestate(np.random.default_rng(n_cidrs), "n", ifaces, n_cidrs)
        with open(os.path.join(d.nodestates_dir, "n.json"), "w") as f:
            json.dump(doc, f)
        d.scan_nodestates_once()
        clf = d.syncer.classifier
        assert clf.device.type == "cuda"
        ns = spec.IngressNodeFirewallNodeState.from_dict(doc)
        tables = compiler.compile_tables(ns.spec.interface_ingress_rules, reg)
        b = testing.random_batch_fast(np.random.default_rng(1), tables, 5000)
        fb = pcap.build_frames_bulk(b.kind, b.ip_words, b.proto, b.dst_port, b.icmp_type,
                                    b.icmp_code, l4_ok=b.l4_ok)
        fb.ifindex = np.asarray(b.ifindex, np.uint32)
        daemon.write_frames_file_v2(os.path.join(d.ingest_dir, "t.frames"), fb)
        for k in all_kernels():
            k.launches = 0
        assert d.process_ingest_once() == 1
        launches = {k.name: k.launches for k in all_kernels()}
        assert launches[kernel] > 0, launches
        got = np.fromfile(os.path.join(d.out_dir, "t.frames.verdicts.bin"), "<u4")
        parsed = pcap.parse_frames_buf(fb)
        np.testing.assert_array_equal(got, oracle.classify(tables, parsed).results)
    finally:
        d.stop()


@pytest.mark.parametrize("path", ["trie", "ctrie"])
def test_flush_on_a_side_stream_orders_the_next_classify(cuda, path):
    """An edit transaction loaded on another stream (as a flush thread
    could): a job prepared before it still reads the old generation, and a
    classify on the default stream after it waits for the new generation's
    copies (the load's event) and reads the edited tables."""
    from infw_torch import txn

    rng = np.random.default_rng(61)
    table = testing.random_tables_fast(rng, 6000, ifindexes=(2, 3), width=8)
    content = dict(table.content)
    it = compiler.IncrementalTables.from_content(content, rule_width=8)
    clf = TorchClassifier(force_path=path)
    clf.load_tables(it.snapshot())
    it.clear_dirty()
    batch = testing.random_batch_fast(rng, table, 20000, hit_fraction=0.95)
    wire, v4_only = batch.pack_wire_subset(np.arange(len(batch)))
    plan = clf.prepare_packed(wire, v4_only)
    ops = [txn.EditOp("rules_edit", k, testing.random_rules(rng, 8)) for k in list(content)[:1000]]
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        report = txn.TxnApplier(clf, it).apply(ops)
    assert clf._active.ready[1] == side
    got_old = clf.classify_prepared(plan).result()
    got_new = clf.classify_async_packed(wire, v4_only).result()
    new = dict(content)
    new.update({op.key: op.rules for op in ops})
    edited = compiler.compile_tables_from_content(new, rule_width=8)
    np.testing.assert_array_equal(got_old.results, oracle.HashLpmOracle(table).classify(batch).results)
    np.testing.assert_array_equal(got_new.results,
                                  oracle.HashLpmOracle(edited).classify(batch).results)
    assert report.mode == "patch" and not np.array_equal(got_old.results, got_new.results)


def test_daemon_applies_edit_files_on_the_card(cuda, tmp_path):
    """An edit file in the card daemon's edits/ (the generator's full mix):
    one flush, and the next frames file's verdicts equal the oracle of the
    edited content, K1 over the overlay launched beside K2."""
    import json
    import os

    from infw_torch import daemon, txn
    from infw_torch.interfaces import Interface, InterfaceRegistry
    from infw_torch.obs import pcap

    ifaces = {"eth0": 2, "eth1": 3}
    reg = InterfaceRegistry()
    for name, index in ifaces.items():
        reg.add(Interface(name=name, index=index))
    d = daemon.Daemon(state_dir=str(tmp_path / "state"), node_name="n", registry=reg,
                      metrics_port=0, health_port=0, file_poll_interval_s=60.0)
    try:
        doc = testing.random_nodestate(np.random.default_rng(62), "n", ifaces, 4400)
        with open(os.path.join(d.nodestates_dir, "n.json"), "w") as f:
            json.dump(doc, f)
        d.scan_nodestates_once()
        ops = testing.generate_edit_ops(np.random.default_rng(63), 256, d.syncer.classifier.tables,
                                        8)
        txn.write_edit_file(os.path.join(d.edits_dir, "e.json"), ops)
        assert d.scan_edits_once() == 256 and d._maybe_flush_edits(force=True)
        d._edit_flush_thread.join(timeout=300)
        assert d.txn_stats.snapshot()["ops"] == 256 and os.listdir(d.edits_dir) == []
        assert d.syncer._overlay  # the new CIDRs
        edited = compiler.compile_tables_from_content(dict(d.syncer._content), rule_width=8)
        b = testing.random_batch_fast(np.random.default_rng(64), edited, 8000)
        fb = pcap.build_frames_bulk(b.kind, b.ip_words, b.proto, b.dst_port, b.icmp_type,
                                    b.icmp_code, l4_ok=b.l4_ok)
        fb.ifindex = np.asarray(b.ifindex, np.uint32)
        daemon.write_frames_file_v2(os.path.join(d.ingest_dir, "t.frames"), fb)
        for k in all_kernels():
            k.launches = 0
        assert d.process_ingest_once() == 1
        launches = {k.name: k.launches for k in all_kernels()}
        assert launches["trie_walk"] > 0 and launches["dense_classify"] > 0, launches
        got = np.fromfile(os.path.join(d.out_dir, "t.frames.verdicts.bin"), "<u4")
        np.testing.assert_array_equal(got, oracle.classify(edited, pcap.parse_frames_buf(fb)).results)
    finally:
        d.stop()


# --- K6: the dense-family arena, its overlay side-pool and the tenants --------


def _dense_arena(device, n_tenants, entries, destroy=1, seed0=100):
    """A dense arena of ``n_tenants`` random tables (one destroyed) on
    ``device``, two pages to spare."""
    tabs = _arena_tenants(n_tenants, entries, seed0)
    spec = arena.arena_spec_for("dense", tabs, pages=n_tenants + 2, max_tenants=n_tenants + 1)
    al = arena.ArenaAllocator(spec, device)
    for t, tab in enumerate(tabs):
        al.load_tenant(t, tab)
    al.destroy_tenant(destroy)
    return tabs, spec, al


def _mixed_tenants(tabs, per, seed=7):
    batch = concat([testing.random_batch_fast(np.random.default_rng(seed + t), tab, per)
                    for t, tab in enumerate(tabs)])
    tenant = np.repeat(np.arange(len(tabs), dtype=np.int32), per)
    tenant[:16], tenant[-16:] = -1, len(tabs) + 1
    return batch, tenant


@pytest.mark.parametrize("n_tenants,entries,per", [(3, 24, 200), (40, 64, 500), (5, 1024, 3000)])
def test_k6_matches_plain(cuda, n_tenants, entries, per):
    """K6's two-column entry against its plain version on the card and on
    the CPU, on a mixed-tenant batch with invalid tenant ids (-1,
    max_tenants, a destroyed tenant), at slabs of 32, 64 and 1024 rows."""
    tabs, spec, al = _dense_arena(cuda, n_tenants, entries)
    _, _, cpu = _dense_arena("cpu", n_tenants, entries)
    batch, tenant = _mixed_tenants(tabs, per)
    fields, words = torchpath.packet_fields(torchpath.device_batch(batch, cuda))
    tt = torch.from_numpy(tenant).to(cuda)
    before = _launch_counts()
    got = arena_dense.arena_dense_classify(fields, words, tt, al.arena, pages=spec.pages)
    torch.cuda.synchronize()
    assert _launch_deltas(before) == {"arena_dense": 1}
    assert torch.equal(got, arena_dense.arena_dense_classify_plain(fields, words, tt, al.arena,
                                                                    pages=spec.pages))
    assert torch.equal(got.cpu(), arena_dense.arena_dense_classify(
        fields.cpu(), words.cpu(), tt.cpu(), cpu.arena, pages=spec.pages))
    off = (tenant < 0) | (tenant > n_tenants - 1) | (tenant == 1)
    assert not got[torch.from_numpy(off).to(cuda)].any()
    assert int((got[:, 1] > 0).sum()) > per // 4


@pytest.mark.parametrize("B", FUSED_SIZES)
def test_k6_fused_matches_plain(cuda, B):
    """K6's fused entry at every wire width on ragged mixed-tenant batches:
    the whole read-back buffer equal to the plain version's on the card and
    on the CPU, one launch and no other kernel; and on a grid of 1 and 7
    blocks."""
    tabs, spec, al = _dense_arena(cuda, 6, 64)
    _, _, cpu = _dense_arena("cpu", 6, 64)
    batch, tenant = _mixed_tenants(tabs, 12_000, seed=300)
    order = np.random.default_rng(1).permutation(len(batch))
    batch, tenant = batch.take(order), tenant[order]
    wires = {d: _fused_wires(batch, d) for d in (cuda, "cpu")}
    rows = _fused_rows(batch)
    for width in cwalk.WIRE_WIDTHS:
        pair = {}
        for d, pool in ((cuda, al.arena), ("cpu", cpu.arena)):
            wire = wires[d][width][0][:B]
            t = torch.from_numpy(tenant[rows[width]][:B].copy()).to(d)
            pair[d] = (lambda w=wire, t=t, p=pool: arena_dense.classify_arena_dense_wire_fused(
                           p, w, t, pages=spec.pages),
                       lambda w=wire, t=t, p=pool: arena_dense.classify_arena_dense_wire_fused_plain(
                           p, w, t, pages=spec.pages))
        got = _one_launch_equal(arena_dense.FUSED_KERNEL, pair[cuda], pair["cpu"])
        n = len(rows[width][:B])
        assert got.shape == ((n + 1) // 2 + 6144,), width
        if n > 1000:
            assert int((got[:(n + 1) // 2] != 0).sum()) > n // 8 and got[-6144:].any(), width
    wire, t = wires[cuda][6][0], torch.from_numpy(tenant[rows[6]].copy()).to(cuda)
    for grid in (1, 7):
        _one_launch_equal(arena_dense.FUSED_KERNEL, (
            lambda: arena_dense.classify_arena_dense_wire_fused(al.arena, wire, t,
                                                                pages=spec.pages, _grid=grid),
            lambda: arena_dense.classify_arena_dense_wire_fused_plain(al.arena, wire, t,
                                                                      pages=spec.pages)))


def _k6_against_plain(pool, pages, batch, tenant, device, grid=0):
    """Both K6 entries on the card against their plain versions, bit for
    bit, one launch each: the two-column entry on the batch, the fused
    entry at wire widths 7, 6, 4 and 3 (the v4-compact ones on the
    batch's IPv4-compactable packets).  Returns the two-column output."""
    fields, words = torchpath.packet_fields(torchpath.device_batch(batch, device))
    tt = torch.from_numpy(tenant).to(device)
    before = _launch_counts()
    got = arena_dense.arena_dense_classify(fields, words, tt, pool, pages=pages, _grid=grid)
    torch.cuda.synchronize()
    assert _launch_deltas(before) == {"arena_dense": 1}
    assert torch.equal(got, arena_dense.arena_dense_classify_plain(fields, words, tt, pool,
                                                                    pages=pages))
    wires, rows = _fused_wires(batch, device), _fused_rows(batch)
    for width in cwalk.WIRE_WIDTHS:
        wire = wires[width][0]
        t = torch.from_numpy(tenant[rows[width]].copy()).to(device)
        _one_launch_equal(arena_dense.FUSED_KERNEL, (
            lambda w=wire, t=t: arena_dense.classify_arena_dense_wire_fused(pool, w, t,
                                                                            pages=pages,
                                                                            _grid=grid),
            lambda w=wire, t=t: arena_dense.classify_arena_dense_wire_fused_plain(pool, w, t,
                                                                                  pages=pages)))
    return got


def _k6_case(case, device):
    """(pool, pages, batch, tenant) of one skewed K6 batch."""
    if case == "side_pool":  # the overlay side-pool: 1024-row slabs, 32 live rows
        tabs = [testing.random_tables_fast(np.random.default_rng(900 + t), 32, width=4,
                                           ifindexes=(2, 3), v6_fraction=0.4) for t in range(8)]
        spec = arena.make_arena_spec("dense", 10, 8, 1024, 4)
        al = arena.ArenaAllocator(spec, device)
        for t, tab in enumerate(tabs):
            al.load_tenant(t, tab)
        batch, tenant = _mixed_tenants(tabs, 700, seed=31)
        return al.arena, spec.pages, batch, tenant
    n_tenants, entries = {"one_per_tenant": (40, 1000), "S4096": (3, 3000),
                          "S8192": (2, 5000)}.get(case, (6, 1000))
    tabs, spec, al = _dense_arena(device, n_tenants, entries)
    if case == "one_tenant":  # every packet on tenant 2
        batch = testing.random_batch_fast(np.random.default_rng(41), tabs[2], 20_000)
        tenant = np.full(len(batch), 2, np.int32)
    elif case == "one_per_tenant":  # one packet per tenant, and ids -1 and past the table
        batch, tenant = _mixed_tenants(tabs, 1, seed=42)
        tenant = np.concatenate([tenant, [-1, n_tenants + 7]]).astype(np.int32)
        batch = concat([batch, batch.take(np.arange(2))])
    elif case == "v4_v6_tile":  # IPv4 and IPv6 packets alternating within each tile
        b = testing.random_batch_fast(np.random.default_rng(43), tabs[0], 4000)
        v4, v6 = np.nonzero(b.kind == 1)[0], np.nonzero(b.kind == 2)[0]
        n = min(len(v4), len(v6))
        batch = b.take(np.stack([v4[:n], v6[:n]], axis=1).reshape(-1))
        tenant = np.zeros(len(batch), np.int32)
    else:  # a mixed batch shuffled; the large slabs span 4 and 8 staging chunks
        batch, tenant = _mixed_tenants(tabs, 3000, seed=44)
        order = np.random.default_rng(45).permutation(len(batch))
        batch, tenant = batch.take(order), tenant[order]
    return al.arena, spec.pages, batch, tenant


@pytest.mark.parametrize("case", ["one_tenant", "one_per_tenant", "shuffled", "v4_v6_tile",
                                  "side_pool", "S4096", "S8192"])
def test_k6_entries_on_skewed_batches(cuda, case):
    """Both K6 entries against their plain versions, bit for bit, on every
    packet of one tenant, one packet per tenant, a shuffled mixed batch,
    IPv4 and IPv6 packets in one tile, the overlay side-pool's 32 live
    rows in 1024-row slabs, and slabs of 4096 and 8192 rows (4 and 8
    staging chunks); each also on its first 1 and 17 packets and under a
    grid of 3 blocks."""
    pool, pages, batch, tenant = _k6_case(case, cuda)
    assert pool.mask_len.shape[0] // pages == {"S4096": 4096, "S8192": 8192}.get(case, 1024)
    got = _k6_against_plain(pool, pages, batch, tenant, cuda)
    assert int((got[:, 1] > 0).sum()) > (0 if case == "one_per_tenant" else len(batch) // 4)
    for B in (1, 17):
        _k6_against_plain(pool, pages, batch.take(np.arange(B)), tenant[:B].copy(), cuda)
    _k6_against_plain(pool, pages, batch, tenant, cuda, grid=3)


def test_k6_sees_a_rules_only_patch_on_the_next_classify(cuda):
    """A rules-only patch writes the live pool in place between two
    classifies: the next launch of each K6 entry stages the new rows (K6
    caches nothing between calls), equal to the plain versions."""
    tabs = _arena_tenants(3, 200)
    spec = arena.arena_spec_for("dense", tabs, pages=5, max_tenants=4)
    al = arena.ArenaAllocator(spec, cuda)
    upds = {t: compiler.IncrementalTables.from_content(dict(tab.content), rule_width=4)
            for t, tab in enumerate(tabs)}
    for t, u in upds.items():
        al.load_tenant(t, u.snapshot())
    batch, tenant = _mixed_tenants(tabs, 2000, seed=50)
    before = _k6_against_plain(al.arena, spec.pages, batch, tenant, cuda)
    upd = upds[1]
    upd.start_dirty_tracking()
    edits = {}
    for k in sorted(upd.content, key=lambda k: (k.ingress_ifindex, k.ip_data))[:50]:
        r = np.asarray(upd.content[k]).copy()
        r[0] = [99, 0, 0, 0, 0, 0, 1]
        edits[k] = r
    upd.apply(edits, [])
    assert al.load_tenant(1, upd.snapshot(), hint=upd.peek_dirty()) == "patch"
    after = _k6_against_plain(al.arena, spec.pages, batch, tenant, cuda)
    changed = (after != before).any(dim=1).cpu().numpy()
    assert changed.any() and (tenant[changed] == 1).all()
    assert ((after[:, 0] >> 8) & 0xFF == 99).any()


def test_k6_passes_are_two_kernels(cuda):
    """On the card each K6 entry is two kernels, the cooperative one (the
    grouping, the staging and the product) and the rule scan's, the fused
    entry with at most one memset: the profiler sees nothing else (traced
    as chip_smoke.py traces, after a warm-up step, over 3 calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    pool, pages, batch, tenant = _k6_case("shuffled", cuda)
    fields, words = torchpath.packet_fields(torchpath.device_batch(batch, cuda))
    tt = torch.from_numpy(tenant).to(cuda)
    wire = torch.from_numpy(narrow_wire(batch.pack_wire()).view(np.int32)).to(cuda)
    short = lambda n: next((k for k in ("arena_dense_kernel", "rule_scan_kernel") if k in n), n)
    for run, memsets_max in (
            (lambda: arena_dense.arena_dense_classify(fields, words, tt, pool, pages=pages), 0),
            (lambda: arena_dense.classify_arena_dense_wire_fused(pool, wire, tt, pages=pages), 1)):
        run()
        torch.cuda.synchronize()
        for _ in range(5):  # traced again when the trace lost a kernel event
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
                run()
                torch.cuda.synchronize()
                prof.step()
                for _ in range(3):
                    run()
                torch.cuda.synchronize()
                prof.step()
            dev = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation and not e.name.startswith("ProfilerStep")]
            kernels = [short(n) for n in dev if not n.startswith(("Memset", "Memcpy"))]
            if len(kernels) >= 6:
                break
        assert sorted(kernels) == ["arena_dense_kernel"] * 3 + ["rule_scan_kernel"] * 3, kernels
        assert len([n for n in dev if n.startswith("Memset")]) <= 3 * memsets_max, dev


def test_k6_rejects_bad_operands(cuda):
    tabs, spec, al = _dense_arena(cuda, 2, 24)
    fields = torch.zeros((8, 8), dtype=torch.int32, device=cuda)
    words = torch.zeros((8, 4), dtype=torch.int32, device=cuda)
    tenant = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        arena_dense.arena_dense_classify(fields, words, tenant.long(), al.arena, pages=spec.pages)
    with pytest.raises(ValueError):
        arena_dense.arena_dense_classify(fields, words, tenant[:7], al.arena, pages=spec.pages)
    with pytest.raises(ValueError):
        arena_dense.arena_dense_classify(fields, words, tenant, al.arena, pages=spec.pages + 1)
    with pytest.raises(ValueError):
        arena_dense.arena_dense_classify(fields, words, tenant,
                                         al.arena._replace(rules=al.arena.rules.int()),
                                         pages=spec.pages)
    assert arena_dense.arena_dense_classify(fields[:0], words[:0], tenant[:0], al.arena,
                                            pages=spec.pages).shape == (0, 2)


def _oracle_check(out, batch, tenant, tables_of):
    for t in np.unique(tenant):
        idx = np.nonzero(tenant == t)[0]
        tab = tables_of(int(t))
        if tab is None:
            assert not out.results[idx].any()
            continue
        np.testing.assert_array_equal(out.results[idx], oracle.classify(tab, batch.take(idx)).results)


def test_dense_arena_and_overlay_classifiers_on_card(cuda):
    """TorchArenaClassifier on the card with a dense spec (K6's fused entry
    once per mixed classify, rules-only patches and a clone) and with a
    ctrie spec plus a dense overlay side-pool (K3b's and K6's two-column
    entries once each per classify): the same outputs and counters as on
    the CPU and the per-tenant oracles of the merged content."""
    tabs = _arena_tenants(4, 48)
    dspec = arena.arena_spec_for("dense", tabs, pages=8, max_tenants=6)
    clf, cpu = TorchArenaClassifier(dspec), TorchArenaClassifier(dspec, device="cpu")
    # tenant 3 holds tenant 0's content, from its own updater: one shared page
    upds = {t: compiler.IncrementalTables.from_content(dict(tabs[t % 3].content), rule_width=4)
            for t in range(4)}
    snaps = {t: u.snapshot() for t, u in upds.items()}
    for c in (clf, cpu):
        assert [c.load_tenant(t, snaps[t]) for t in range(4)] == ["assign"] * 3 + ["share"]
    batch, tenant = _mixed_tenants(tabs[:3] + [tabs[0]], 500, seed=40)
    wire = batch.pack_wire()

    def both(launched, tables_of):
        before = _launch_counts()
        out = clf.classify_async_packed_tenant(wire, tenant).result()
        assert _launch_deltas(before) == launched
        ref = cpu.classify_async_packed_tenant(wire, tenant).result()
        for f in ("results", "xdp", "stats_delta"):
            np.testing.assert_array_equal(getattr(out, f), getattr(ref, f), err_msg=f)
        _oracle_check(out, batch, tenant, tables_of)
        assert clf.tenant_counters() == cpu.tenant_counters()

    both({"arena_dense_fused": 1}, snaps.get)
    # a rules-only edit of a private page (patch) and of the shared one (cow)
    new = {}
    for t, want in ((1, "patch"), (3, "cow")):
        upd = upds[t]
        upd.start_dirty_tracking()
        k = sorted(upd.content, key=lambda k: (k.ingress_ifindex, k.ip_data))[0]
        r = np.asarray(upd.content[k]).copy()
        r[0] = [9, 0, 0, 0, 0, 0, 1]
        upd.apply({k: r}, [])
        hint, new[t] = upd.peek_dirty(), upd.snapshot()
        assert [c.load_tenant(t, new[t], hint=hint) for c in (clf, cpu)] == [want] * 2
    both({"arena_dense_fused": 1}, lambda t: new.get(t, snaps.get(t)))
    # the patched pool equals a cold bake of the same content
    cold = arena.ArenaAllocator(dspec, cuda)
    cold.load_tenant(1, new[1])
    p, q = clf.allocator.page_of(1), cold.page_of(1)
    S = dspec.entries
    for f in arena.DenseArena._fields[:4]:
        assert torch.equal(getattr(clf.allocator.arena, f)[p * S:(p + 1) * S],
                           getattr(cold.arena, f)[q * S:(q + 1) * S]), f

    cspec = arena.arena_spec_for("ctrie", tabs, pages=8, max_tenants=6)
    ov_spec = arena.make_arena_spec("dense", 8, 6, 1024, 4)
    clf = TorchArenaClassifier(cspec, overlay_spec=ov_spec)
    cpu = TorchArenaClassifier(cspec, device="cpu", overlay_spec=ov_spec)
    merged = {}
    for t, tab in enumerate(tabs):
        ov = testing.random_tables_fast(np.random.default_rng(900 + t), 40, width=4,
                                        ifindexes=(2, 3), v6_fraction=0.4)
        content = {k: v for k, v in ov.content.items()
                   if k.masked_identity() not in {kk.masked_identity() for kk in tab.content}}
        ovt = compiler.compile_tables_from_content(content, rule_width=4)
        for c in (clf, cpu):
            c.load_tenant(t, tab)
            if t % 2 == 0:
                c.load_tenant_overlay(t, ovt)
        merged[t] = (compiler.compile_tables_from_content({**tab.content, **content},
                                                          rule_width=4) if t % 2 == 0 else tab)
    batch = concat([testing.random_batch_fast(np.random.default_rng(60 + t), merged[t], 500)
                    for t in range(4)])
    tenant = np.repeat(np.arange(4, dtype=np.int32), 500)
    tenant[:16] = 5
    wire = batch.pack_wire()
    both({"arena_ctrie_walk": 1, "arena_dense": 1},
         lambda t: merged.get(t) if t < 4 else None)


def _flow_case_on(case, device):
    from infw_torch.kernels import flow as kflow

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy()).to(device)  # noqa: E731
    cols = kflow.FlowTable(*(t(case[k]) for k in kflow.COLUMNS),
                           winner=torch.full((case["se"].shape[0],), -1, dtype=torch.int32,
                                             device=device))
    probe = tuple(t(a) for a in case["probe"][:3]) + (case["probe"][3],)
    insert = tuple(t(a) for a in case["insert"][:4]) + (case["insert"][4],)
    return cols, t(case["gens"]), t(case["page_table"]), probe, insert


@pytest.mark.parametrize("width", [4, 7])
@pytest.mark.parametrize("name", testing.FLOW_KERNEL_CASES)
def test_k7_k8_match_plain(cuda, name, width):
    """K7 and K8 against their plain versions on the card, on every case
    of the CPU tests: equal fused buffers, counts and columns, and the
    insert's scratch back at -1."""
    from infw_torch.kernels import flow as kflow

    case = testing.flow_kernel_case(name, width)
    geo = {"slab_entries": case["entries"], "ways": case["ways"]}
    got, gens, pt, probe, insert = _flow_case_on(case, cuda)
    want = kflow.clone_flow_table(got)
    p0, i0 = kflow.PROBE_KERNEL.launches, kflow.INSERT_KERNEL.launches
    fused = kflow.flow_probe(got, gens, pt, *probe, case["max_age"], **geo)
    torch.cuda.synchronize()
    assert kflow.PROBE_KERNEL.launches == p0 + 1
    assert torch.equal(fused, kflow.flow_probe_plain(want, gens, pt, *probe, case["max_age"], **geo))
    for k in kflow.COLUMNS:
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    counts = kflow.flow_insert(got, gens, pt, *insert, **geo)
    torch.cuda.synchronize()
    assert kflow.INSERT_KERNEL.launches == i0 + 1
    assert torch.equal(counts, kflow.flow_insert_plain(want, gens, pt, *insert, **geo))
    for k in kflow.COLUMNS:
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    assert bool((got.winner == -1).all())


@pytest.mark.parametrize("b", [0, 1, 31, 33, 4096, (1 << 16) + 5])
def test_k7_k8_ragged_batches_match_plain(cuda, b):
    """K7 and K8 over a flow trace, chunk after chunk, at ragged batch
    sizes: every chunk's probe buffer, counts and the columns equal the
    plain versions' on the card."""
    from infw_torch.kernels import flow as kflow

    rng = np.random.default_rng(b)
    tables = testing.random_tables_fast(rng, 300, width=4)
    batch, _meta = testing.flow_trace_batch(rng, tables, max(3 * b, 1), 0.6, chunk_packets=max(b, 1))
    S, W, C = 1 << 10, 4, 1 << 10
    got = kflow.empty_flow_table(C, cuda)
    want = kflow.clone_flow_table(got)
    gens = torch.zeros(1, dtype=torch.int32, device=cuda)
    pt = torch.zeros(1, dtype=torch.int32, device=cuda)
    for k in range(3):
        sub = batch.slice(k * b, (k + 1) * b)
        wire = torch.from_numpy(sub.pack_wire().view(np.int32)).to(cuda)
        ten = torch.zeros(len(sub), dtype=torch.int32, device=cuda)
        fl = torch.from_numpy(sub.tcp_flags.astype(np.int32)).to(cuda)
        fused = kflow.flow_probe(got, gens, pt, wire, ten, fl, k + 1, 1 << 20, slab_entries=S, ways=W)
        assert torch.equal(fused, kflow.flow_probe_plain(want, gens, pt, wire, ten, fl, k + 1,
                                                         1 << 20, slab_entries=S, ways=W))
        verdict = torch.from_numpy(rng.integers(0, 1 << 16, len(sub)).astype(np.int32)).to(cuda)
        counts = kflow.flow_insert(got, gens, pt, wire, ten, fl, verdict, k + 1, slab_entries=S,
                                   ways=W)
        assert torch.equal(counts, kflow.flow_insert_plain(want, gens, pt, wire, ten, fl, verdict,
                                                           k + 1, slab_entries=S, ways=W))
        for c in kflow.COLUMNS:
            assert torch.equal(getattr(got, c), getattr(want, c)), (k, c)
    torch.cuda.synchronize()


@pytest.mark.parametrize("grid", [1, 2, 7])
@pytest.mark.parametrize("name", ["hot_slot", "warp_mixed_slots", "lanes_beyond_grid",
                                  "duplicate_keys"])
def test_k7_k8_forced_grid_match_plain(cuda, name, grid):
    """K7 and K8 under a forced grid of 1, 2 and 7 blocks (the private
    ``_grid`` keyword): each thread takes many lanes, all but its first
    two through the lane scratch, and the fused buffer, the counts and
    the columns still equal the plain versions', the scratch back at -1."""
    from infw_torch.kernels import flow as kflow

    case = testing.flow_kernel_case(name, 7)
    geo = {"slab_entries": case["entries"], "ways": case["ways"]}
    got, gens, pt, probe, insert = _flow_case_on(case, cuda)
    want = kflow.clone_flow_table(got)
    fused = kflow.flow_probe(got, gens, pt, *probe, case["max_age"], **geo, _grid=grid)
    assert torch.equal(fused, kflow.flow_probe_plain(want, gens, pt, *probe, case["max_age"], **geo))
    counts = kflow.flow_insert(got, gens, pt, *insert, **geo, _grid=grid)
    assert torch.equal(counts, kflow.flow_insert_plain(want, gens, pt, *insert, **geo))
    for k in kflow.COLUMNS:
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    assert bool((got.winner == -1).all())


def _ops_per_call(fn, reps: int = 10):
    """torch.profiler over ``reps`` calls after a warm one, with 20 ms of
    margin on each side of them in the recorded window: ({kernel name:
    launches a call}, memsets a call), traced again (up to five times)
    when the trace holds fewer kernels than the runtime's launch records."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            time.sleep(0.02)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.02)
            prof.step()
        dev = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation and not e.name.startswith("ProfilerStep")]
        api = sum(e.name.startswith(("cudaLaunch", "cuLaunch")) for e in prof.events()
                  if e.device_type == DeviceType.CPU)
        kernels = [n for n in dev if not n.startswith(("Memset", "Memcpy"))]
        if len(kernels) >= api:
            counts = {}
            for n in kernels:
                counts[n] = counts.get(n, 0) + 1 / reps
            return counts, sum(n.startswith("Memset") for n in dev) / reps
    raise AssertionError("the profiler lost kernel events five times")


def _k7_k8_ops(b: int, device="cuda:0") -> dict:
    """{kernel name: (kernels a call, memsets a call)} of one K7 and one K8
    call at ``b`` lanes (``_ops_per_call``)."""
    from infw_torch.kernels import flow as kflow

    rng = np.random.default_rng(b)
    tables = testing.random_tables_fast(rng, 300, width=4)
    batch, _meta = testing.flow_trace_batch(rng, tables, max(b, 1), 0.9, chunk_packets=4096)
    batch = batch.slice(0, b)
    fl = kflow.empty_flow_table(1 << 14, device)
    one = torch.zeros(1, dtype=torch.int32, device=device)
    wire = torch.from_numpy(batch.pack_wire().view(np.int32)).to(device)
    ten = torch.zeros(b, dtype=torch.int32, device=device)
    fl_ = torch.from_numpy(batch.tcp_flags.astype(np.int32)).to(device)
    geo = {"slab_entries": 1 << 14, "ways": 4}
    out = {}
    for name, run in (
            ("probe_kernel", lambda: kflow.flow_probe(fl, one, one, wire, ten, fl_, 5, 100, **geo)),
            ("insert_kernel", lambda: kflow.flow_insert(fl, one, one, wire, ten, fl_, ten, 5,
                                                        **geo))):
        out[name] = _ops_per_call(run)
    out["winner_clear"] = bool((fl.winner == -1).all())
    return out


#: _k7_k8_ops in a fresh process: a profiler trace taken in a process whose
#: earlier profiler sessions traced other work can lose kernel events
_K7_K8_OPS_CHILD = r"""
import json, sys
sys.path.insert(0, "tests")
import test_torch_cuda
print(json.dumps(test_torch_cuda._k7_k8_ops(int(sys.argv[1]))))
"""


@pytest.mark.parametrize("b", [0, 4096, 1 << 18])
def test_k7_k8_are_one_kernel_a_call(cuda, b):
    """Each K7 and K8 call is one cooperative kernel on the card and no
    memset (the profiler, in a process of its own), also for an empty
    batch."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    proc = subprocess.run([sys.executable, "-c", _K7_K8_OPS_CHILD, str(b)],
                          cwd=Path(__file__).resolve().parents[1], capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("probe_kernel", "insert_kernel"):
        kernels, memsets = got[name]
        assert len(kernels) == 1 and name in next(iter(kernels)), (name, kernels)
        assert next(iter(kernels.values())) == pytest.approx(1.0), (name, kernels)
        assert memsets == 0, (name, memsets)
    assert got["winner_clear"]


def test_flow_wrappers_raise_on_wrong_operands(cuda):
    """On a CUDA tensor K7 and K8 launch or raise: an int64 wire, a wire
    width the kernels do not take, a non-power-of-two slab; and after a
    good call, which leaves that table's checks done, another table with
    a column of the wrong shape or type, or misaligned, still raises."""
    from infw_torch.kernels import flow as kflow

    fl = kflow.empty_flow_table(64, cuda)
    z = torch.zeros(8, dtype=torch.int32, device=cuda)
    one = torch.zeros(1, dtype=torch.int32, device=cuda)
    geo = {"slab_entries": 64, "ways": 4}
    good = torch.zeros((8, 7), dtype=torch.int32, device=cuda)
    for wire, g in ((torch.zeros((8, 7), dtype=torch.int64, device=cuda), geo),
                    (torch.zeros((8, 6), dtype=torch.int32, device=cuda), geo),
                    (good, {"slab_entries": 48, "ways": 4}),
                    (good, {"slab_entries": 64, "ways": 9})):
        with pytest.raises(ValueError):
            kflow.flow_probe(fl, one, one, wire, z, z, 1, 10, **g)
        with pytest.raises(ValueError):
            kflow.flow_insert(fl, one, one, wire, z, z, z, 1, **g)
    kflow.flow_probe(fl, one, one, good, z, z, 1, 10, **geo)
    kflow.flow_insert(fl, one, one, good, z, z, z, 1, **geo)
    C = fl.capacity
    odd = torch.zeros(C * 8 + 1, dtype=torch.int32, device=cuda)[1:].view(C, 8)
    copy = kflow.clone_flow_table(fl)
    for bad in (copy._replace(se=torch.zeros((C, 3), dtype=torch.int32, device=cuda)),
                copy._replace(cnt=copy.cnt.long()),
                copy._replace(keys=odd),
                copy._replace(winner=torch.full((C + 1,), -1, dtype=torch.int32, device=cuda)),
                kflow.empty_flow_table(C, "cpu")):
        with pytest.raises(ValueError):
            kflow.flow_probe(bad, one, one, good, z, z, 2, 10, **geo)
        with pytest.raises(ValueError):
            kflow.flow_insert(bad, one, one, good, z, z, z, 2, **geo)
    with pytest.raises(ValueError):  # a per-call operand on the checked table
        kflow.flow_probe(fl, one, one, good, z[:7], z, 2, 10, **geo)
    with pytest.raises(ValueError):
        kflow.flow_insert(fl, one.long(), one, good, z, z, z, 2, **geo)
    kflow.flow_probe(fl, one, one, good, z, z, 2, 10, **geo)
    torch.cuda.synchronize()
    assert bool((fl.winner == -1).all())


def test_flow_classifier_on_the_card_matches_the_cpu(cuda):
    """TorchClassifier(flow_table=...) on the card against the same
    classifier on the CPU over a flow trace: equal outputs, flow counters
    and columns; every chunk launches K7 once and K8 once."""
    from infw_torch.kernels import flow as kflow

    rng = np.random.default_rng(14)
    tables = testing.random_tables_fast(rng, 5000, width=4, v6_fraction=0.5)
    batch, _ = testing.flow_trace_batch(rng, tables, 4 * 1024, 0.9)
    gpu = TorchClassifier(device=cuda, flow_table=512)
    cpu = TorchClassifier(device="cpu", flow_table=512)
    for c in (gpu, cpu):
        c.load_tables(tables)
    p0, i0 = kflow.PROBE_KERNEL.launches, kflow.INSERT_KERNEL.launches
    for k in range(4):
        sub = batch.slice(1024 * k, 1024 * k + 1024)
        got, want = gpu.classify(sub), cpu.classify(sub)
        for f in ("results", "xdp", "stats_delta"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert (kflow.PROBE_KERNEL.launches - p0, kflow.INSERT_KERNEL.launches - i0) == (4, 4)
    assert gpu.flow_counters() == cpu.flow_counters()
    assert gpu.flow_counters()["flow_hits_total"] > 0
    gc, cc = gpu.flow.flow_columns(), cpu.flow.flow_columns()
    for k in kflow.COLUMNS:
        np.testing.assert_array_equal(gc[k], cc[k])


# --- the resident step (kernels/resident.py, infw_torch/resident.py) ----------------


def _resident_entries_against_plain(cuda, case, grid=0):
    """K7's and K8's resident entries on the card against their plain
    versions on clones of the same card tensors; returns the launches."""
    from infw_torch.kernels import flow as kflow

    geo = {"slab_entries": case["entries"], "ways": case["ways"]}
    got, gens, pt, probe, insert = _flow_case_on(case, cuda)
    want = kflow.clone_flow_table(got)
    wire, ten, fl, epoch = probe
    B = wire.shape[0]
    nw, nh = (B + 1) // 2, -(-B // 32)
    e_got = torch.tensor([epoch - 1], dtype=torch.int64).to(torch.int32).to(cuda)
    e_want = e_got.clone()
    out_got = torch.full((nw + nh + 6,), -7, dtype=torch.int32, device=cuda)
    out_want = out_got.clone()
    v16 = kflow._pack_res16(insert[3] & 0xFFFF)
    p0 = kflow.PROBE_RESIDENT_KERNEL.launches
    i0 = kflow.INSERT_RESIDENT_KERNEL.launches
    kflow.flow_probe_resident(got, gens, pt, wire, ten, fl, e_got, case["max_age"], out_got,
                              **geo, _grid=grid)
    kflow.flow_probe_resident_plain(want, gens, pt, wire, ten, fl, e_want, case["max_age"],
                                    out_want, **geo)
    torch.cuda.synchronize()
    assert torch.equal(out_got, out_want) and torch.equal(e_got, e_want)
    for out, f, e in ((out_got, got, e_got), (out_want, want, e_want)):
        (kflow.flow_insert_resident(f, gens, pt, wire, ten, fl, v16, out[nw: nw + nh], out[:nw],
                                    out[nw + nh + 2:], e, **geo, _grid=grid) if f is got else
         kflow.flow_insert_resident_plain(f, gens, pt, wire, ten, fl, v16, out[nw: nw + nh],
                                          out[:nw], out[nw + nh + 2:], e, **geo))
    torch.cuda.synchronize()
    assert torch.equal(out_got, out_want)
    assert int(e_got[0]) == int(e_want[0]) == int(np.int64(epoch).astype(np.int32))
    for k in kflow.COLUMNS:
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    assert bool((got.winner == -1).all())
    return (kflow.PROBE_RESIDENT_KERNEL.launches - p0, kflow.INSERT_RESIDENT_KERNEL.launches - i0)


@pytest.mark.parametrize("width", [4, 7])
@pytest.mark.parametrize("name", testing.FLOW_KERNEL_CASES)
def test_k7_k8_resident_entries_match_plain(cuda, name, width):
    """K7 at the device epoch and K8 under the hit mask with the merge (the
    resident entries) against their plain versions, on every case and
    every way count of the CPU tests: equal output words, epochs and
    columns; one launch each."""
    assert _resident_entries_against_plain(cuda, testing.flow_kernel_case(name, width)) == (1, 1)


@pytest.mark.parametrize("grid", [1, 2, 7])
@pytest.mark.parametrize("name", ["hot_slot", "warp_mixed_slots", "lanes_beyond_grid",
                                  "duplicate_keys", "ways_3"])
def test_k7_k8_resident_forced_grid_match_plain(cuda, name, grid):
    """The resident entries under a forced grid of 1, 2 and 7 blocks: most
    lanes go through the scratch, and a winner from the scratch decodes
    its packed verdict again."""
    _resident_entries_against_plain(cuda, testing.flow_kernel_case(name, 7), grid)


def _resident_pair(cuda, path, tables, overlay=None, **kw):
    gpu = TorchClassifier(device=cuda, force_path=path, resident=True, flow_table=512, **kw)
    cpu = TorchClassifier(device="cpu", force_path=path, resident=True, flow_table=512, **kw)
    for c in (gpu, cpu):
        c.load_tables(tables, overlay=overlay)
    return gpu, cpu


def _same_outputs(got, want, label=""):
    for f in ("results", "xdp", "stats_delta"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f"{label} {f}")


@pytest.mark.parametrize("path", ["dense", "trie", "ctrie", "trie_overlay"])
def test_resident_graph_replay_matches_the_cpu_and_the_eager_step(cuda, path):
    """The resident classifier on the card (one graph replay an admission)
    against the same classifier on the CPU over a flow trace, at ragged
    sizes padded to buckets and on both slots: equal outputs, counters,
    columns and epochs; then one more admission's graph against the eager
    step sequence on clones of the columns."""
    from infw_torch import flow as flow_mod
    from infw_torch.kernels import flow as kflow
    from infw_torch.kernels.resident import resident_step

    rng = np.random.default_rng(16)
    base = path.split("_")[0]
    n = 300 if base == "dense" else 5000
    tables = testing.random_tables_fast(rng, n, width=4, v6_fraction=0.5)
    ov = None
    if path.endswith("overlay"):
        ov_tables = testing.random_tables_fast(np.random.default_rng(17), 16, width=4)
        taken = {k.masked_identity() for k in tables.content}
        ov = compiler.compile_tables_from_content(
            {k: v for k, v in ov_tables.content.items() if k.masked_identity() not in taken},
            rule_width=4)
    gpu, cpu = _resident_pair(cuda, None if base == "dense" else base, tables, ov)
    assert gpu.active_path == base
    batch, _ = testing.flow_trace_batch(rng, tables, 4 * 1024, 0.9, chunk_packets=1024)
    start = 0
    for k, size in enumerate((1024, 61, 1000, 1024, 8, 1)):
        sub = batch.slice(start, start + size)
        start += size
        _same_outputs(gpu.classify(sub), cpu.classify(sub), f"{path} chunk {k}")
    assert gpu.flow_counters() == cpu.flow_counters()
    assert gpu.flow_counters()["flow_hits_total"] > 0
    gc, cc = gpu.flow.flow_columns(), cpu.flow.flow_columns()
    for c in kflow.COLUMNS:
        np.testing.assert_array_equal(gc[c], cc[c])
    assert int(gpu.flow._epoch_dev[0]) == gpu.flow.epoch == cpu.flow.epoch == 6
    rc = gpu.resident_counters()
    assert rc["resident_dispatches_total"] == 6 and rc["resident_slot1_dispatches_total"] == 3

    # the graph against the eager sequence
    sub = batch.slice(0, 1024)
    wire_np = sub.pack_wire()
    ctx = gpu.resident.context(gpu)
    tables_step = ctx.tables._replace(
        n_levels=None if base != "trie" else ctx.tables.dev.n_levels)
    tier = gpu.flow
    eager_flow = kflow.clone_flow_table(tier._flow)
    eager_epoch = tier._epoch_dev.clone()
    gens_op, pages_op = tier._res_ops
    fl = torch.from_numpy(sub.tcp_flags.astype(np.int32)).to(cuda)
    ops = flow_mod.ResidentOps(eager_flow, gens_op.clone(), pages_op.clone(), eager_epoch,
                               torch.zeros(1024, dtype=torch.int32, device=cuda), fl,
                               tier.config.max_age, tier.config.entries, tier.config.ways)
    eager = resident_step(ops, tables_step, torch.from_numpy(wire_np.view(np.int32)).to(cuda))
    plan = gpu.prepare_packed(wire_np, False, tcp_flags=sub.tcp_flags)
    from infw_torch.kernels.resident import resident_fused_host

    np.testing.assert_array_equal(resident_fused_host(plan["fused"]), eager.cpu().numpy())
    for c in kflow.COLUMNS:
        assert torch.equal(getattr(tier._flow, c), getattr(eager_flow, c)), c
    assert torch.equal(tier._epoch_dev, eager_epoch)


def test_resident_two_slots_with_unread_outputs(cuda):
    """Six admissions dispatched back to back, none read, then read in the
    order 3, 0, 5, 1, 4, 2: the third and later dispatches on a slot keep
    the unread output of the one before, so every result equals the
    oracle's, and the tracked model equals the columns."""
    rng = np.random.default_rng(23)
    tables = testing.random_tables_fast(rng, 5000, width=4, v6_fraction=0.5)
    clf = TorchClassifier(device=cuda, force_path="trie", resident=True, flow_table=512,
                          flow_track_model=True)
    clf.load_tables(tables)
    batch, _ = testing.flow_trace_batch(rng, tables, 6 * 128, 0.8, chunk_packets=128)
    chunks = [batch.slice(128 * j, 128 * (j + 1)) for j in range(6)]
    plans = [clf.prepare_packed(c.pack_wire(), False, tcp_flags=c.tcp_flags) for c in chunks]
    for i in (3, 0, 5, 1, 4, 2):
        out = clf.classify_prepared(plans[i], apply_stats=False).result()
        want = oracle.classify(tables, chunks[i])
        np.testing.assert_array_equal(out.results, want.results, err_msg=f"plan {i}")
    cols = clf.flow.flow_columns()
    model = clf.flow.model.columns()
    for k in cols:
        np.testing.assert_array_equal(cols[k], np.asarray(model[k]).view(cols[k].dtype))


def test_resident_warm_state_captures_nothing(cuda):
    """After one admission per shape and slot and mark_resident_warm, 200
    more at those shapes capture no graph and allocate nothing."""
    rng = np.random.default_rng(24)
    tables = testing.random_tables_fast(rng, 5000, width=4, v6_fraction=0.5)
    clf = TorchClassifier(device=cuda, force_path="trie", resident=True, flow_table=512)
    clf.load_tables(tables)
    batch, _ = testing.flow_trace_batch(rng, tables, 4096, 0.9, chunk_packets=128)
    v4 = batch.take(np.nonzero(batch.kind == 1)[0][:128])
    shapes = [(batch.slice(0, 128).pack_wire(), False), (v4.pack_wire_v4(), True)]
    for wire, is_v4 in shapes:
        for _ in range(2):  # both slots
            clf.classify_prepared(clf.prepare_packed(wire, is_v4)).result()
    clf.flow.warm([128])  # classic probes move the host epoch only
    clf.mark_resident_warm()
    graphs = clf.resident.graphs()
    assert graphs == 4
    for j in range(100):
        for wire, is_v4 in shapes:
            clf.classify_prepared(clf.prepare_packed(wire, is_v4)).result()
    assert clf.resident.steady_allocs() == 0 and clf.resident.graphs() == graphs


#: one resident admission profiled in a fresh process (a trace of graph
#: replays taken in a process whose earlier profiler sessions traced other
#: work loses events): the resident entries' and K3's launch counts over
#: four admissions, and the copies the trace saw, with eight spin kernels
#: on each side of the admissions to show the trace whole
_COPIES_CHILD = r"""
import json
import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from infw_torch import testing
from infw_torch.backend.cuda import TorchClassifier
from infw_torch.kernels import cwalk, flow as kflow

rng = np.random.default_rng(25)
tables = testing.random_tables_fast(rng, 5000, width=4, v6_fraction=0.5)
clf = TorchClassifier(device="cuda:0", force_path="ctrie", resident=True, flow_table=512)
clf.load_tables(tables)
batch, _ = testing.flow_trace_batch(rng, tables, 4096, 0.9, chunk_packets=1024)
wire = batch.slice(0, 1024).pack_wire()
for _ in range(3):
    clf.classify_prepared(clf.prepare_packed(wire, False)).result()
kernels = (kflow.PROBE_RESIDENT_KERNEL, kflow.INSERT_RESIDENT_KERNEL, cwalk.FUSED_KERNEL)
before = [k.launches for k in kernels]
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    for _ in range(8):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    for _ in range(4):
        clf.classify_prepared(clf.prepare_packed(wire, False)).result()
    for _ in range(8):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()
names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
print(json.dumps({"launches": [k.launches - b for k, b in zip(kernels, before)],
                  "spins": sum("spin_kernel" in n for n in names),
                  "h2d": sum("HtoD" in n for n in names),
                  "d2h": sum("DtoH" in n for n in names), "names": sorted(set(names))}))
"""


def test_resident_admission_is_one_copy_in_one_graph_one_copy_out(cuda):
    """An admission launches K7's and K8's resident entries and K3 once
    each (the counts a replay adds), and the profiler sees one
    host-to-device and one device-to-host copy an admission."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    proc = subprocess.run([sys.executable, "-c", _COPIES_CHILD],
                          cwd=Path(__file__).resolve().parents[1], capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["launches"] == [4, 4, 4], got
    assert got["spins"] == 16, got  # the trace is whole
    assert (got["h2d"], got["d2h"]) == (4, 4), got


def test_resident_superbatch_matches_the_cpu(cuda):
    """prepare_packed_super (K = 4) on the card against the CPU's: equal
    rows, columns and epochs."""
    rng = np.random.default_rng(26)
    tables = testing.random_tables_fast(rng, 5000, width=4, v6_fraction=0.5)
    gpu, cpu = _resident_pair(cuda, "trie", tables)
    batch, _ = testing.flow_trace_batch(rng, tables, 8 * 256, 0.9, chunk_packets=256)
    for rnd in range(2):
        stack = np.stack([batch.slice(256 * (4 * rnd + j), 256 * (4 * rnd + j + 1)).pack_wire()
                          for j in range(4)])
        flags = np.asarray(batch.tcp_flags[1024 * rnd: 1024 * (rnd + 1)], np.int32).reshape(4, 256)
        got = gpu.classify_prepared_super(gpu.prepare_packed_super(stack, False, flags))
        want = cpu.classify_prepared_super(cpu.prepare_packed_super(stack, False, flags))
        for j in (3, 1, 0, 2):
            _same_outputs(got[j].result(), want[j].result(), f"round {rnd} row {j}")
    gc, cc = gpu.flow.flow_columns(), cpu.flow.flow_columns()
    for k in gc:
        np.testing.assert_array_equal(gc[k], cc[k])
    assert int(gpu.flow._epoch_dev[0]) == gpu.flow.epoch == 8


def test_resident_patch_between_dispatches_on_the_card(cuda):
    """Loads between dispatches: a rules-only edit keeps the layout, so
    its generation keeps every graph (one context, no capture), and a
    structural one that changes a tensor's shape captures again; after
    each load the next admission serves the new tables."""
    from infw_torch.resident import same_layout

    rng = np.random.default_rng(27)
    tables = testing.random_tables_fast(rng, 5000, width=4, v6_fraction=0.5)
    clf = TorchClassifier(device=cuda, force_path="trie", resident=True, flow_table=512)
    inc = compiler.IncrementalTables.from_content(dict(tables.content), rule_width=4)
    clf.load_tables(inc.snapshot())
    batch = testing.random_batch_fast(rng, tables, 512)
    for _ in range(2):
        clf.classify(batch)
    graphs = clf.resident.graphs()
    keys = list(tables.content)
    inc.apply({k: testing.random_rules(rng, 4) for k in keys[:64]}, [])
    for rules_only in (True, False):
        if not rules_only:
            inc.apply({}, keys[::2])
        old = clf.resident.context(clf).tables
        allocs = clf.resident_counters()["resident_allocs_total"]
        snap = inc.snapshot()
        clf.load_tables(snap, dirty_hint=inc.peek_dirty())
        kept = same_layout(old, clf.resident.context(clf).tables)
        assert kept or not rules_only
        for _ in range(2):
            out = clf.classify(batch)
            np.testing.assert_array_equal(out.results, oracle.classify(snap, batch).results)
        captures = clf.resident_counters()["resident_allocs_total"] - allocs - 1
        assert (captures, clf.resident.graphs()) == ((0, graphs) if kept else (graphs, graphs))


def test_resident_dispatches_from_two_streams(cuda):
    """Admissions alternate between two streams, with classic probes (which
    re-seed the device epoch) and a rules-only load between them, read
    after all were dispatched: the results, columns and epochs equal the
    same admissions on the CPU."""
    rng = np.random.default_rng(28)
    tables = testing.random_tables_fast(rng, 5000, width=4, v6_fraction=0.5)
    gpu, cpu = _resident_pair(cuda, "trie", tables)
    batch, _ = testing.flow_trace_batch(rng, tables, 8 * 128, 0.8, chunk_packets=128)
    chunks = [batch.slice(128 * j, 128 * (j + 1)) for j in range(8)]
    inc = compiler.IncrementalTables.from_content(dict(tables.content), rule_width=4)
    inc.apply({k: testing.random_rules(rng, 4) for k in list(tables.content)[:32]}, [])
    snap = inc.snapshot()
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    pending = []
    for j, c in enumerate(chunks):
        if j == 4:
            for clf in (gpu, cpu):
                clf.load_tables(snap, dirty_hint=inc.peek_dirty())
        if j % 3 == 2:
            for clf in (gpu, cpu):
                clf.flow.warm([8])
        with torch.cuda.stream(streams[j % 2]):
            got = gpu.classify_prepared(gpu.prepare_packed(c.pack_wire(), False,
                                                           tcp_flags=c.tcp_flags))
        want = cpu.classify_prepared(cpu.prepare_packed(c.pack_wire(), False,
                                                         tcp_flags=c.tcp_flags)).result()
        pending.append((got, want))
    for j, (got, want) in enumerate(pending):
        _same_outputs(got.result(), want, f"chunk {j}")
    gc, cc = gpu.flow.flow_columns(), cpu.flow.flow_columns()
    for k in gc:
        np.testing.assert_array_equal(gc[k], cc[k])
    assert int(gpu.flow._epoch_dev[0]) == gpu.flow.epoch == cpu.flow.epoch


def test_resident_dispatches_from_threads_on_their_streams(cuda):
    """Three threads, each on a stream of its own, dispatch admissions at
    once and read them back: every result equals the oracle's, every
    dispatch is counted, and the tracked host models (replayed in epoch
    order) equal the flow columns and, with the telemetry plane on, the
    sketch tensors."""
    import threading

    from infw_torch.kernels.sketch import SketchSpec

    rng = np.random.default_rng(29)
    tables = testing.random_tables_fast(rng, 5000, width=4, v6_fraction=0.5)
    from infw_torch.kernels.mxu_score import ScoreSpec

    clf = TorchClassifier(device=cuda, force_path="trie", resident=True, flow_table=512,
                          flow_track_model=True, telemetry=SketchSpec.make(width=256, topk=64),
                          telemetry_track_model=True,
                          mlscore=ScoreSpec.make(slots=64, ways=2, hidden=4),
                          mlscore_track_model=True)
    clf.load_tables(tables)
    batch, _ = testing.flow_trace_batch(rng, tables, 24 * 128, 0.8, chunk_packets=128)
    chunks = [batch.slice(128 * j, 128 * (j + 1)) for j in range(24)]
    errors = []

    def worker(t):
        try:
            with torch.cuda.stream(torch.cuda.Stream(cuda)):
                for c in chunks[t::3]:
                    plan = clf.prepare_packed(c.pack_wire(), False, tcp_flags=c.tcp_flags)
                    out = clf.classify_prepared(plan, apply_stats=False).result()
                    np.testing.assert_array_equal(out.results,
                                                  oracle.classify(tables, c).results)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors[0]
    assert clf.resident_counters()["resident_dispatches_total"] == 24
    torch.cuda.synchronize()
    cols = clf.flow.flow_columns()
    model = clf.flow.model.columns()
    for k in cols:
        np.testing.assert_array_equal(cols[k], np.asarray(model[k]).view(cols[k].dtype))
    tel = clf.telemetry
    tel.resident_note_materialized(0)
    assert tel.counter_values()["telemetry_updates_total"] == 24
    sk, sm = tel.columns(), tel.model.columns()
    for k in sk:
        np.testing.assert_array_equal(sk[k], sm[k], err_msg=k)
    assert sk["tcnt"][0, 0] > 0
    ml = clf.mlscore
    ml.resident_note_materialized(0)
    assert ml.counter_values()["mlscore_updates_total"] == 24
    sc, scm = ml.columns(), ml.model.columns()
    for k in sc:
        np.testing.assert_array_equal(sc[k], scm[k], err_msg=k)
    assert sc["tstat"][0, 0] > 0 and int(sc["epoch"][0]) == 24


# --- K9, the telemetry plane's sketch update -------------------------------------------


def _k9_case(rng, tables, b, width, spec_kw, pool=64):
    """(spec, wire, tenant, tflags, res) of ``b`` lanes drawn from ``pool``
    packets (so keys repeat), on the CPU."""
    from infw_torch.kernels.sketch import SketchSpec

    spec = SketchSpec.make(**spec_kw)
    p = testing.random_batch_fast(rng, tables, max(pool, 8))
    if width == 4:
        p = p.take(np.nonzero(p.kind == 1)[0])
        wire = p.pack_wire_subset(np.arange(len(p)))[0]
    else:
        wire = p.pack_wire()
    n = wire.shape[0]
    res = rng.integers(0, 4, n).astype(np.uint32) | (rng.integers(0, 5, n).astype(np.uint32) << 8)
    tenant = rng.integers(-1, spec.max_tenants + 1, n).astype(np.int32)
    idx = rng.integers(0, n, b)
    flags = rng.integers(0, 32, b).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32))  # noqa: E731
    return spec, t(wire[idx]), t(tenant[idx]), t(flags), t(res[idx])


def _k9_against_plain(cuda, spec, batches, grid=0, resident=False, plan=None, start=None):
    """K9 on the card against the plain version on the CPU over several
    batches from the same (non-zero) state (``start``, {field: tensor},
    else zeros): equal state after each, the winner scratch back at -1,
    one launch a call; ``plan`` forces K9's plan."""
    from infw_torch.kernels import sketch as ksk
    from infw_torch.kernels.torchpath import _pack_res16

    dev_state, cpu_state = ksk.zero_state(spec, cuda), ksk.zero_state(spec, "cpu")
    for f, t in (start or {}).items():
        getattr(dev_state, f).copy_(t)
        getattr(cpu_state, f).copy_(t)
    winner = ksk.empty_winner(spec, cuda)
    kern = ksk.RESIDENT_KERNEL if resident else ksk.KERNEL
    for wire, tenant, flags, res in batches:
        if resident:
            res_in = _pack_res16(res.long() & 0xFFFF)
            res = res & 0xFFFF
        else:
            res_in = res
        before = kern.launches
        entry = ksk.sketch_update_resident if resident else ksk.sketch_update
        entry(dev_state, wire.to(cuda), tenant.to(cuda), flags.to(cuda), res_in.to(cuda), spec,
              winner=winner, _grid=grid, _plan=plan)
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        ksk.sketch_update_plain(cpu_state, wire, tenant, flags, res, spec)
        for f in ksk.SketchState._fields:
            assert torch.equal(getattr(dev_state, f).cpu(), getattr(cpu_state, f)), f
        assert bool((winner == -1).all())
    return cpu_state


@pytest.mark.parametrize("b", [1, 31, 256, 4096, 65536])
@pytest.mark.parametrize("width", [4, 7])
def test_k9_matches_plain(cuda, b, width):
    rng = np.random.default_rng(b + width)
    tables = testing.random_tables_fast(rng, 500, width=4, v6_fraction=0.4)
    batches = [_k9_case(rng, tables, b, width, dict(width=256, topk=64, max_tenants=2))
               for _ in range(3)]
    st = _k9_against_plain(cuda, batches[0][0], [x[1:] for x in batches])
    assert int(st.tcnt[:, 0].sum()) > 0


@pytest.mark.parametrize("geom", ["ways1", "ways2", "ways3", "ways5", "ways8", "depth1",
                                  "depth8", "sat3", "topk8", "tenants5"])
def test_k9_geometries_match_plain(cuda, geom):
    rng = np.random.default_rng(len(geom) * 7 + ord(geom[-1]))
    tables = testing.random_tables_fast(rng, 500, width=4, v6_fraction=0.4)
    kw = dict(width=64, topk=32, max_tenants=2)
    if geom.startswith("ways"):
        kw["ways"] = int(geom[4:])
    elif geom.startswith("depth"):
        kw["depth"] = int(geom[5:])
    elif geom == "sat3":
        kw.update(sat=3, width=16)
    elif geom == "topk8":
        kw.update(topk=8, ways=1)
    else:
        kw["max_tenants"] = 5
    batches = [_k9_case(rng, tables, 2000, 7, kw, pool=128) for _ in range(3)]
    st = _k9_against_plain(cuda, batches[0][0], [x[1:] for x in batches])
    if geom == "sat3":
        assert int(st.cms.max()) == 3


@pytest.mark.parametrize("grid", [1, 3])
def test_k9_forced_grid_matches_plain(cuda, grid):
    """Many lanes a thread: every phase's grid-stride loop and the warp
    aggregation over lanes past the first round."""
    rng = np.random.default_rng(grid)
    tables = testing.random_tables_fast(rng, 500, width=4, v6_fraction=0.4)
    batches = [_k9_case(rng, tables, 20_001, 7, dict(width=128, topk=32)) for _ in range(2)]
    _k9_against_plain(cuda, batches[0][0], [x[1:] for x in batches], grid=grid)


def test_k9_resident_entry_matches_plain(cuda):
    rng = np.random.default_rng(99)
    tables = testing.random_tables_fast(rng, 500, width=4, v6_fraction=0.4)
    batches = [_k9_case(rng, tables, 4097, 7, dict(width=256, topk=64)) for _ in range(3)]
    _k9_against_plain(cuda, batches[0][0], [x[1:] for x in batches], resident=True)


def test_k9_hot_keys_and_a_wrapping_counter(cuda):
    """One key on every lane (one bucket a row, one slot, one tenant row:
    the warp aggregation's whole-warp groups), then a counter at 2^31 - 2
    that the adds wrap past, against the plain version."""
    from infw_torch.kernels import sketch as ksk

    rng = np.random.default_rng(5)
    tables = testing.random_tables_fast(rng, 100, width=4)
    spec, wire, tenant, flags, res = _k9_case(rng, tables, 70_000, 7, dict(width=64, topk=16),
                                              pool=1)
    tenant[:] = 0
    wire[:] = wire[0]
    wire[:, 0] = (wire[:, 0] & ~3) | 1
    res[:] = res[0]
    dev = ksk.zero_state(spec, cuda)
    cpu = ksk.zero_state(spec, "cpu")
    for st in (dev, cpu):
        st.cms.fill_(2**31 - 2)
    ksk.sketch_update(dev, wire.to(cuda), tenant.to(cuda), flags.to(cuda), res.to(cuda), spec)
    ksk.sketch_update_plain(cpu, wire, tenant, flags, res, spec)
    torch.cuda.synchronize()
    for f in ksk.SketchState._fields:
        assert torch.equal(getattr(dev, f).cpu(), getattr(cpu, f)), f
    assert int(cpu.cms.min()) < 0 and int(cpu.tcnt[0, 0]) == 70_000


@pytest.mark.parametrize("resident", [False, True])
@pytest.mark.parametrize("plan", ["S", "L"])
@pytest.mark.parametrize("b", [1, 31, 1024, 4096, 4097, 12_000])
def test_k9_plans_match_plain(cuda, plan, resident, b):
    """Each plan forced, on both entries, at sizes within a thread's
    register lanes and past them (plan S's shared spill, plan L's lane
    scratch at a small grid)."""
    rng = np.random.default_rng(b * 4 + (plan == "S") * 2 + resident)
    tables = testing.random_tables_fast(rng, 500, width=4, v6_fraction=0.4)
    batches = [_k9_case(rng, tables, b, 7, dict(width=256, topk=64, max_tenants=2))
               for _ in range(3)]
    _k9_against_plain(cuda, batches[0][0], [x[1:] for x in batches], resident=resident,
                      plan=plan)


@pytest.mark.parametrize("delta", [-1, 0, 1])
@pytest.mark.parametrize("resident", [False, True])
def test_k9_both_sides_of_the_crossover_match_plain(cuda, delta, resident):
    """The default geometry at the crossover and one lane either side,
    each call on the plan ``plan_for`` chooses (S at and below, L above)."""
    from infw_torch.kernels import sketch as ksk

    b = ksk.BLOCK_PLAN_MAX_LANES + delta
    spec = ksk.SketchSpec.make(max_tenants=2)
    assert ksk.plan_for(b, spec, ksk.smem_limit(cuda)) == ("L" if delta > 0 else "S")
    rng = np.random.default_rng(b + resident)
    tables = testing.random_tables_fast(rng, 2000, width=4, v6_fraction=0.4)
    batches = [_k9_case(rng, tables, b, 7, spec._asdict(), pool=4096) for _ in range(2)]
    _k9_against_plain(cuda, spec, [x[1:] for x in batches], resident=resident)


@pytest.mark.parametrize("grid", [0, 1, 3])
@pytest.mark.parametrize("b", [256, 70_000])
def test_k9_oversized_geometry_matches_plain(cuda, b, grid):
    """Depth 8 x width 65536: neither the block's state nor plan L's tally
    or stage fits in shared memory, so every call is plan L on global
    atomics and an unstaged decide, under the co-resident grid and forced
    grids of 1 and 3 blocks."""
    from infw_torch.kernels import sketch as ksk

    spec = ksk.SketchSpec.make(depth=8, width=65536, max_tenants=2)
    assert ksk.plan_for(b, spec, ksk.smem_limit(cuda)) == "L"
    rng = np.random.default_rng(b + grid)
    tables = testing.random_tables_fast(rng, 500, width=4, v6_fraction=0.4)
    batches = [_k9_case(rng, tables, b, 7, spec._asdict(), pool=256) for _ in range(2)]
    _k9_against_plain(cuda, spec, [x[1:] for x in batches], grid=grid)


@pytest.mark.parametrize("resident", [False, True])
@pytest.mark.parametrize("plan", ["S", "L"])
def test_k9_above_sat_start_is_clamped_whole(cuda, plan, resident):
    """A start state whose count-min cells sit above sat, most of them
    untouched by the lanes (a state carried across from the JAX package):
    every cell comes out min(c, sat), on both plans and entries."""
    from infw_torch.kernels import sketch as ksk

    rng = np.random.default_rng(17 + resident)
    tables = testing.random_tables_fast(rng, 500, width=4, v6_fraction=0.4)
    kw = dict(width=2048, topk=64, sat=40, max_tenants=2)
    batches = [_k9_case(rng, tables, 300, 7, kw) for _ in range(2)]
    spec = batches[0][0]
    start = {"cms": torch.from_numpy(rng.integers(0, 200, (4, 2048)).astype(np.int32))}
    got = _k9_against_plain(cuda, spec, [x[1:] for x in batches], resident=resident, plan=plan,
                            start=start)
    assert int(got.cms.max()) == 40 and int((start["cms"] > 40).sum()) > 4 * 300


@pytest.mark.parametrize("grid", [1, 3])
@pytest.mark.parametrize("resident", [False, True])
def test_k9_plan_l_forced_grid_matches_plain(cuda, grid, resident):
    """Plan L at the default geometry (tally and stage in shared memory)
    under forced grids: most lanes past a thread's register lanes, each
    block's tally and slice of the clamp."""
    from infw_torch.kernels import sketch as ksk

    rng = np.random.default_rng(grid * 2 + resident)
    tables = testing.random_tables_fast(rng, 500, width=4, v6_fraction=0.4)
    spec = ksk.SketchSpec.make(max_tenants=2, sat=30)
    batches = [_k9_case(rng, tables, 40_000, 7, spec._asdict(), pool=512) for _ in range(2)]
    got = _k9_against_plain(cuda, spec, [x[1:] for x in batches], grid=grid, resident=resident)
    assert int(got.cms.max()) == 30


def _k9_ops(b: int, plan: str) -> dict:
    """torch.profiler over K9 calls of ``b`` lanes at the default geometry
    (``plan`` forced, "" for plan_for's): {"kernels": {name: per call},
    "memsets": per call}."""
    from infw_torch.kernels import sketch as ksk

    cuda = torch.device("cuda:0")
    rng = np.random.default_rng(b)
    tables = testing.random_tables_fast(rng, 500, width=4, v6_fraction=0.4)
    spec, wire, tenant, flags, res = _k9_case(rng, tables, b, 7, {}, pool=512)
    st, winner = ksk.zero_state(spec, cuda), ksk.empty_winner(spec, cuda)
    args = [x.to(cuda) for x in (wire, tenant, flags, res)]
    kernels, memsets = {}, 0
    for _ in range(3):
        names, fills = _device_ops(lambda: ksk.sketch_update(st, *args, spec, winner=winner,
                                                             _plan=plan or None))
        for n in names:
            kernels[n] = kernels.get(n, 0) + 1 / 3
        memsets += len(fills) / 3
    return {"kernels": kernels, "memsets": memsets}


#: _k9_ops in a fresh process (see _K7_K8_OPS_CHILD)
_K9_OPS_CHILD = r"""
import json, sys
sys.path.insert(0, "tests")
import test_torch_cuda
print(json.dumps(test_torch_cuda._k9_ops(int(sys.argv[1]), sys.argv[2])))
"""


def test_k9_profiler_names_the_plan(cuda):
    """Each K9 call is one kernel and no memset (the profiler, in a process
    of its own), and the kernel names its plan: block_kernel up to the
    crossover, grid_kernel past it or when plan L is forced."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    from infw_torch.kernels import sketch as ksk

    cross = ksk.BLOCK_PLAN_MAX_LANES
    for b, plan, want in ((256, "", "block_kernel"), (cross, "", "block_kernel"),
                          (cross + 1, "", "grid_kernel"), (256, "L", "grid_kernel")):
        proc = subprocess.run([sys.executable, "-c", _K9_OPS_CHILD, str(b), plan],
                              cwd=Path(__file__).resolve().parents[1], capture_output=True,
                              text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        kernels = got["kernels"]
        assert len(kernels) == 1 and want in next(iter(kernels)), (b, plan, kernels)
        assert next(iter(kernels.values())) == pytest.approx(1.0), kernels
        assert got["memsets"] == 0, got


def test_k9_wrapper_refuses_a_plan_that_does_not_fit(cuda):
    """Plan S forced where the state does not fit, or with a grid cap,
    raises before any launch; an unknown plan raises."""
    from infw_torch.kernels import sketch as ksk

    big = ksk.SketchSpec.make(depth=8, width=65536)
    st, winner = ksk.zero_state(big, cuda), ksk.empty_winner(big, cuda)
    z = torch.zeros(8, dtype=torch.int32, device=cuda)
    wire = torch.zeros((8, 7), dtype=torch.int32, device=cuda)
    before = ksk.KERNEL.launches
    for kw in (dict(_plan="S"), dict(_plan="X")):
        with pytest.raises(ValueError):
            ksk.sketch_update(st, wire, z, z, z, big, winner=winner, **kw)
    small = ksk.SketchSpec.make(width=64, topk=16)
    with pytest.raises(ValueError):
        ksk.sketch_update(ksk.zero_state(small, cuda), wire, z, z, z, small,
                          winner=ksk.empty_winner(small, cuda), _plan="S", _grid=2)
    assert ksk.KERNEL.launches == before


@pytest.mark.parametrize("path", ["dense", "trie"])
def test_resident_graph_with_sketch_matches_the_cpu_and_the_eager_step(cuda, path):
    """The resident classifier with the telemetry plane on the card against
    the same on the CPU over a flow trace at ragged sizes: equal outputs,
    flow columns and sketch tensors, each equal to the tracked model; one
    more admission's graph against the eager step (K9 as step 4) on clones
    of the columns and the sketch."""
    from infw_torch import flow as flow_mod
    from infw_torch.kernels import flow as kflow
    from infw_torch.kernels import sketch as ksk
    from infw_torch.kernels.resident import resident_fused_host, resident_step
    from infw_torch.obs.telemetry import SketchOps

    rng = np.random.default_rng(31)
    tables = testing.random_tables_fast(rng, 300 if path == "dense" else 5000, width=4,
                                        v6_fraction=0.5)
    spec = ksk.SketchSpec.make(width=512, topk=64)
    fp = None if path == "dense" else path
    gpu = TorchClassifier(device=cuda, force_path=fp, resident=True, flow_table=4096,
                          telemetry=spec, telemetry_track_model=True)
    cpu = TorchClassifier(device="cpu", force_path=fp, resident=True, flow_table=4096,
                          telemetry=spec)
    for c in (gpu, cpu):
        c.load_tables(tables)
    batch, _ = testing.flow_trace_batch(rng, tables, 4 * 1024, 0.9, chunk_packets=1024)
    start = 0
    for k, size in enumerate((1024, 61, 1000, 1024, 8, 1)):
        sub = batch.slice(start, start + size)
        start += size
        _same_outputs(gpu.classify(sub), cpu.classify(sub), f"{path} chunk {k}")
    gt, ct = gpu.telemetry.columns(), cpu.telemetry.columns()
    gpu.telemetry.resident_note_materialized(0)
    for f in gt:
        np.testing.assert_array_equal(gt[f], ct[f], err_msg=f)
        np.testing.assert_array_equal(gt[f], gpu.telemetry.model.columns()[f], err_msg=f)
    assert gt["tcnt"][0, 0] > 0 and gpu.telemetry_counters() == cpu.telemetry_counters()

    sub = batch.slice(0, 1024)
    wire_np = sub.pack_wire()
    ctx = gpu.resident.context(gpu)
    tables_step = ctx.tables._replace(
        n_levels=None if path != "trie" else ctx.tables.dev.n_levels)
    tier, tel = gpu.flow, gpu.telemetry
    eager_flow = kflow.clone_flow_table(tier._flow)
    eager_epoch = tier._epoch_dev.clone()
    eager_sk = ksk.SketchState(*(t.clone() for t in tel._state))
    gens_op, pages_op = tier._res_ops
    fl = torch.from_numpy(sub.tcp_flags.astype(np.int32)).to(cuda)
    ops = flow_mod.ResidentOps(eager_flow, gens_op.clone(), pages_op.clone(), eager_epoch,
                               torch.zeros(1024, dtype=torch.int32, device=cuda), fl,
                               tier.config.max_age, tier.config.entries, tier.config.ways,
                               SketchOps(eager_sk, ksk.empty_winner(spec, cuda), spec))
    before = ksk.RESIDENT_KERNEL.launches
    eager = resident_step(ops, tables_step, torch.from_numpy(wire_np.view(np.int32)).to(cuda))
    assert ksk.RESIDENT_KERNEL.launches == before + 1
    plan = gpu.prepare_packed(wire_np, False, tcp_flags=sub.tcp_flags)
    np.testing.assert_array_equal(resident_fused_host(plan["fused"]), eager.cpu().numpy())
    assert ksk.RESIDENT_KERNEL.launches == before + 2
    for c in kflow.COLUMNS:
        assert torch.equal(getattr(tier._flow, c), getattr(eager_flow, c)), c
    for f in ksk.SketchState._fields:
        assert torch.equal(getattr(tel._state, f), getattr(eager_sk, f)), f


# --- K10, the anomaly-scoring tier's score update ------------------------------------------


def _k10_model(kind, spec, rng):
    from infw_torch.kernels import mxu_score as kms

    if kind == "default":
        return kms.default_model(spec)
    if kind == "stress":
        return kms.clamp_stress_model(spec)
    return testing.random_score_model(rng, spec)


def _k10_batches(rng, tables, b, width, spec, n=3, tenants=(0, 1), pool=96):
    """``n`` (wire, tenant, tflags, res) admissions of ``b`` lanes drawn from
    ``pool`` packets (so sources repeat), on the CPU."""
    p, _w, res = testing.score_traffic(rng, tables, pool)
    if width == 4:
        keep = np.nonzero(p.kind == 1)[0]
        p, res = p.take(keep), res[keep]
        wire = p.pack_wire_subset(np.arange(len(p)))[0]
    else:
        wire = p.pack_wire()
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32))  # noqa: E731
    out = []
    for _ in range(n):
        idx = rng.integers(0, wire.shape[0], b)
        ten = rng.choice(np.asarray(tenants, np.int32), b)
        out.append((t(wire[idx]), t(ten), t(np.asarray(p.tcp_flags, np.int32)[idx]),
                    t(res[idx])))
    return out


def _k10_against_plain(cuda, spec, model, tparams, batches, resident=False, start=None,
                       plan=None, grid=0):
    """K10 on the card against the plain version on the CPU over chained
    admissions from one state (``start``, host arrays, else zeros): equal
    state, scores, anomaly flags and verdicts after each, one launch a call,
    the per-slot scratch back at -1 / 0 (the resident entry: equal probe,
    stateless and output words, from random hit bitmaps and served words);
    ``plan`` and ``grid`` force K10's plan and cap plan L's grid.  Returns
    the CPU state."""
    from infw_torch.kernels import mxu_score as kms
    from infw_torch.kernels.flow import pack_bits32
    from infw_torch.kernels.torchpath import _pack_res16

    host = start or {k: np.asarray(v) for k, v in zip(kms.ScoreState._fields,
                                                      kms.zero_state_host(spec))}
    ops = {}
    for dev in (cuda, torch.device("cpu")):
        ops[dev.type] = kms.ScoreOps(kms.state_from_host(host, dev), kms.model_device(model, dev),
                                     torch.from_numpy(tparams.copy()).to(dev),
                                     kms.empty_scratch(spec, dev), spec)
    idle = kms.empty_scratch(spec, "cpu")
    force = dict(plan=plan, grid=grid)
    rng = np.random.default_rng(len(batches))
    kern = kms.RESIDENT_KERNEL if resident else kms.KERNEL
    for j, (wire, tenant, flags, res) in enumerate(batches):
        B = wire.shape[0]
        before = kern.launches
        if resident:
            nw, nh = (B + 1) // 2, -(-B // 32)
            hit = torch.from_numpy(rng.random(B) < 0.5)
            served = torch.from_numpy(rng.integers(0, 1 << 16, B))
            words = {}
            for dev in ("cuda", "cpu"):
                bufs = (_pack_res16(served).to(dev), pack_bits32(hit).to(dev),
                        _pack_res16(res.long() & 0xFFFF).to(dev),
                        torch.full((nh + nw,), -7, dtype=torch.int32, device=dev))
                d = cuda if dev == "cuda" else "cpu"
                kms.score_update_resident(ops[dev], wire.to(d), tenant.to(d), flags.to(d), *bufs,
                                          **(force if dev == "cuda" else {}))
                words[dev] = bufs
            torch.cuda.synchronize()
            for name, g, c in zip(("served", "hit", "res16", "out"), words["cuda"], words["cpu"]):
                assert torch.equal(g.cpu(), c), (j, name)
        else:
            got = kms.score_update(ops["cuda"], wire.to(cuda), tenant.to(cuda), flags.to(cuda),
                                   res.to(cuda), **force)
            want = kms.score_update(ops["cpu"], wire, tenant, flags, res)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want), j
        assert kern.launches == before + 1
        for f in kms.ScoreState._fields:
            assert torch.equal(getattr(ops["cuda"].state, f).cpu(),
                               getattr(ops["cpu"].state, f)), (j, f)
        assert torch.equal(ops["cuda"].scratch.cpu(), idle), j
    return ops["cpu"].state


K10_CONFIGS = {  # spec keywords, model, threshold, enforce, tenants
    "default": ({}, "default", 100, False, (0,)),
    "stress8": (dict(hidden=8), "stress", 100, True, (0,)),
    "random64": (dict(hidden=64, slots=64, ways=3), "random", 0, True, (0,)),
    "sat_max": (dict(sat=2**31 - 1, slots=16, ways=2, cms_width=64), "default", 100, False,
                (0,)),
    "tenants4": (dict(max_tenants=4, slots=64), "stress4", -1000, True, (-1, 0, 1, 2, 3, 4)),
    "enforce_fires": (dict(slots=32, ways=2), "default", 0, True, (0,)),
    "tenants100": (dict(max_tenants=100, slots=64), "stress4", -1000, True, tuple(range(-1, 102))),
}


@pytest.mark.parametrize("resident", [False, True])
@pytest.mark.parametrize("b", [1, 256, 4096])
@pytest.mark.parametrize("config", sorted(K10_CONFIGS))
def test_k10_matches_plain(cuda, config, b, resident):
    from infw_torch.kernels import mxu_score as kms

    kw, kind, thr, enforce, tenants = K10_CONFIGS[config]
    if kind == "stress4":
        kw, kind = dict(kw, hidden=4), "stress"
    spec = kms.ScoreSpec.make(**kw)
    rng = np.random.default_rng(len(config) * 1000 + b)
    tables = testing.random_tables_fast(rng, 500, width=4, v6_fraction=0.4)
    model = _k10_model(kind, spec, rng)
    tparams = kms.zero_tparams(spec, threshold=thr, enforce=enforce)
    batches = _k10_batches(rng, tables, b, 7 if b != 256 else 4, spec, n=4, tenants=tenants)
    st = _k10_against_plain(cuda, spec, model, tparams, batches, resident=resident)
    assert int(st.epoch[0]) == 4


def test_k10_large_batch_and_above_sat_start(cuda):
    """K10 at 2^18 lanes on the default spec, and from a start state whose
    count-min cells and source columns sit above sat (every cell clamped,
    the adds wrapping first), on both entries."""
    from infw_torch.kernels import mxu_score as kms

    rng = np.random.default_rng(18)
    tables = testing.random_tables_fast(rng, 2000, width=4, v6_fraction=0.4)
    spec = kms.ScoreSpec.make()
    tp = kms.zero_tparams(spec)
    _k10_against_plain(cuda, spec, kms.default_model(spec), tp,
                       _k10_batches(rng, tables, 1 << 18, 7, spec, n=2, pool=4096))
    sat = kms.ScoreSpec.make(sat=40, slots=32, ways=2, cms_width=64, hidden=8)
    start = {k: np.asarray(v).copy() for k, v in zip(kms.ScoreState._fields,
                                                    kms.zero_state_host(sat))}
    start["cms"][:] = rng.integers(0, 200, start["cms"].shape)
    start["cms"][0, :4] = 2**31 - 1
    start["scols"][:, :4] = rng.integers(0, 200, (32, 4))
    start["scols"][:, 6] = rng.integers(0, 200, 32)
    start["scols"][:3, :4] = 2**31 - 1
    for resident in (False, True):
        st = _k10_against_plain(cuda, sat, kms.clamp_stress_model(sat),
                                kms.zero_tparams(sat, threshold=50, enforce=True),
                                _k10_batches(rng, tables, 300, 7, sat, n=2), resident=resident,
                                start=start)
        assert int(st.cms.max()) <= 40 and int(st.scols[:, :4].max()) <= 40


def test_k10_wrapper_refuses_bad_operands(cuda):
    from infw_torch.kernels import mxu_score as kms

    spec = kms.ScoreSpec.make()
    ops = kms.ScoreOps(kms.zero_state(spec, cuda), kms.model_device(kms.default_model(spec), cuda),
                       torch.from_numpy(kms.zero_tparams(spec)).to(cuda), None, spec)
    z = torch.zeros(8, dtype=torch.int32, device=cuda)
    before = kms.KERNEL.launches
    with pytest.raises(ValueError):
        kms.score_update(ops, torch.zeros((8, 5), dtype=torch.int32, device=cuda), z, z, z)
    with pytest.raises(ValueError):
        kms.score_update(ops._replace(tparams=ops.tparams.cpu()),
                         torch.zeros((8, 7), dtype=torch.int32, device=cuda), z, z, z)
    assert kms.KERNEL.launches == before


#: K10's plans as the card tests force them: (plan, plan L's grid cap)
K10_PLANS = [("S", 0), ("L", 0), ("L", 1), ("L", 3)]


@pytest.mark.parametrize("resident", [False, True])
@pytest.mark.parametrize("plan,grid", K10_PLANS)
@pytest.mark.parametrize("b", [1, 31, 1024, 4096, 4097, 12_000])
def test_k10_plans_match_plain(cuda, plan, grid, resident, b):
    """Each plan forced, on both entries, at sizes within a thread's
    register lanes and past them (plan S's shared spill; plan L's spill
    under forced grids of 1 and 3 blocks), on a head of 4 in enforce with a
    threshold that fires and tenant ids -1 to 2 of 2."""
    from infw_torch.kernels import mxu_score as kms

    spec = kms.ScoreSpec.make(slots=64, ways=3, hidden=4, max_tenants=2)
    rng = np.random.default_rng(b * 8 + len(plan) * 4 + grid + resident)
    tables = testing.random_tables_fast(rng, 500, width=4, v6_fraction=0.4)
    batches = _k10_batches(rng, tables, b, 7, spec, n=3, tenants=(-1, 0, 1, 2), pool=400)
    st = _k10_against_plain(cuda, spec, kms.clamp_stress_model(spec),
                            kms.zero_tparams(spec, threshold=60, enforce=True), batches,
                            resident=resident, plan=plan, grid=grid)
    assert int(st.epoch[0]) == 3


@pytest.mark.parametrize("resident", [False, True])
@pytest.mark.parametrize("plan,grid", K10_PLANS)
def test_k10_hot_key_and_a_wrapping_cell(cuda, plan, grid, resident):
    """Every lane one key, one tenant, one slot (the same-address adds,
    bids, seeds, anomaly and tenant adds), from a state whose count-min
    cells sit at 2^31 - 2, so the adds wrap past 2^31 - 1 before the clamp,
    on each plan and both entries."""
    from infw_torch.kernels import mxu_score as kms

    spec = kms.ScoreSpec.make(sat=2**31 - 1, hidden=4)
    rng = np.random.default_rng(77 + resident)
    tables = testing.random_tables_fast(rng, 500, width=4, v6_fraction=0.0)
    p, _w, res = testing.score_traffic(rng, tables, 64)
    first = int(np.nonzero(p.kind == 1)[0][0])
    wire = np.repeat(p.pack_wire()[first: first + 1], 5000, axis=0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32))  # noqa: E731
    batch = (t(wire), t(np.zeros(5000, np.int32)), t(np.full(5000, 0x02, np.int32)),
             t(np.full(5000, res[first], np.uint32)))
    start = {k: np.asarray(v).copy() for k, v in zip(kms.ScoreState._fields,
                                                    kms.zero_state_host(spec))}
    start["cms"][:] = 2**31 - 2
    got = _k10_against_plain(cuda, spec, kms.clamp_stress_model(spec),
                             kms.zero_tparams(spec, threshold=0, enforce=True), [batch, batch],
                             resident=resident, start=start, plan=plan, grid=grid)
    assert int(got.cms.min()) < 0 and int(got.tstat[0, 0]) == 10_000
    assert int((got.scols[:, 0] > 0).sum()) == 1


@pytest.mark.parametrize("resident", [False, True])
@pytest.mark.parametrize("grid", [0, 1, 3])
@pytest.mark.parametrize("b", [256, 70_000])
def test_k10_oversized_geometry_matches_plain(cuda, b, grid, resident):
    """65536 slots, count-min rows of 65536 and 100 tenants: neither the
    block's state nor plan L's tallies fit in shared memory, so every call
    is plan L on global atomics, under the co-resident grid and forced
    grids of 1 and 3 blocks."""
    from infw_torch.kernels import mxu_score as kms

    spec = kms.ScoreSpec.make(slots=65536, cms_width=65536, max_tenants=100, hidden=4)
    limit = kms.smem_limit(cuda)
    assert kms.grid_plan_bytes(spec) > limit and kms.block_plan_bytes(1, spec) > limit
    assert kms.plan_for(b, spec, limit) == "L"
    rng = np.random.default_rng(b + grid + resident)
    tables = testing.random_tables_fast(rng, 500, width=4, v6_fraction=0.4)
    batches = _k10_batches(rng, tables, b, 7, spec, n=2, tenants=tuple(range(-1, 102)),
                           pool=2000)
    _k10_against_plain(cuda, spec, kms.clamp_stress_model(spec),
                       kms.zero_tparams(spec, threshold=-1000, enforce=True), batches,
                       resident=resident, grid=grid)


@pytest.mark.parametrize("delta", [-1, 0, 1])
@pytest.mark.parametrize("resident", [False, True])
def test_k10_both_sides_of_the_crossover_match_plain(cuda, delta, resident):
    """The default geometry at the crossover and one lane either side, each
    call on the plan ``plan_for`` chooses (S at and below, L above)."""
    from infw_torch.kernels import mxu_score as kms

    b = kms.BLOCK_PLAN_MAX_LANES + delta
    spec = kms.ScoreSpec.make()
    assert kms.plan_for(b, spec, kms.smem_limit(cuda)) == ("L" if delta > 0 else "S")
    rng = np.random.default_rng(b + resident)
    tables = testing.random_tables_fast(rng, 2000, width=4, v6_fraction=0.4)
    _k10_against_plain(cuda, spec, kms.default_model(spec), kms.zero_tparams(spec, threshold=0),
                       _k10_batches(rng, tables, b, 7, spec, n=2, pool=4096),
                       resident=resident)


@pytest.mark.parametrize("resident", [False, True])
@pytest.mark.parametrize("plan", ["S", "L"])
def test_k10_graph_replay_matches_the_eager_call(cuda, plan, resident):
    """K10 captured in a CUDA graph on each plan (plan L's cooperative
    launch, plan S's opt-in shared memory): two replays leave the state,
    the outputs and the scratch equal to two eager calls from the same
    state."""
    from infw_torch.kernels import mxu_score as kms
    from infw_torch.kernels.flow import pack_bits32
    from infw_torch.kernels.torchpath import _pack_res16

    spec = kms.ScoreSpec.make(hidden=4)
    rng = np.random.default_rng(61 + resident)
    tables = testing.random_tables_fast(rng, 500, width=4, v6_fraction=0.4)
    wire, tenant, flags, res = (x.to(cuda) for x in _k10_batches(rng, tables, 2048, 7, spec,
                                                                  n=1)[0])
    model = kms.model_device(kms.clamp_stress_model(spec), cuda)
    tp = torch.from_numpy(kms.zero_tparams(spec, threshold=60, enforce=True)).to(cuda)
    B = wire.shape[0]
    served0 = _pack_res16(torch.from_numpy(rng.integers(0, 1 << 16, B)).to(cuda))
    hit = pack_bits32(torch.from_numpy(rng.random(B) < 0.5).to(cuda))

    def make():
        ops = kms.ScoreOps(kms.zero_state(spec, cuda), model, tp, kms.empty_scratch(spec, cuda),
                           spec)
        if not resident:
            return ops, None
        bufs = (served0.clone(), hit, _pack_res16(res.long() & 0xFFFF),
                torch.zeros(B // 32 + B // 2, dtype=torch.int32, device=cuda))
        return ops, bufs

    def call(ops, bufs):
        if resident:
            kms.score_update_resident(ops, wire, tenant, flags, *bufs, plan=plan)
            return bufs[3]
        return kms.score_update(ops, wire, tenant, flags, res, plan=plan)

    call(*make())  # builds, sets up the shared-memory caps, warms the allocator
    g_ops, g_bufs = make()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_out = call(g_ops, g_bufs)
    e_ops, e_bufs = make()
    for _ in range(2):
        graph.replay()
        if resident:  # the verdict words the next admission reads come in fresh
            g_bufs[0].copy_(served0)
            e_bufs[0].copy_(served0)
        e_out = call(e_ops, e_bufs)
    torch.cuda.synchronize()
    assert torch.equal(g_out, e_out)
    for f in kms.ScoreState._fields:
        assert torch.equal(getattr(g_ops.state, f), getattr(e_ops.state, f)), f
    assert torch.equal(g_ops.scratch, e_ops.scratch)
    assert int(g_ops.state.epoch[0]) == 2


def _k10_ops(b: int, plan: str) -> dict:
    """torch.profiler over K10 calls of ``b`` lanes at the default geometry
    (``plan`` forced, "" for plan_for's) on both entries: {entry: {"kernels":
    {name: per call}, "memsets": per call}}."""
    from infw_torch.kernels import mxu_score as kms
    from infw_torch.kernels.flow import pack_bits32
    from infw_torch.kernels.torchpath import _pack_res16

    cuda = torch.device("cuda:0")
    rng = np.random.default_rng(b)
    tables = testing.random_tables_fast(rng, 500, width=4, v6_fraction=0.4)
    spec = kms.ScoreSpec.make()
    wire, tenant, flags, res = (x.to(cuda) for x in _k10_batches(rng, tables, b, 7, spec, n=1,
                                                                  pool=512)[0])
    ops = kms.ScoreOps(kms.zero_state(spec, cuda), kms.model_device(kms.default_model(spec), cuda),
                       torch.from_numpy(kms.zero_tparams(spec)).to(cuda),
                       kms.empty_scratch(spec, cuda), spec)
    nw, nh = (b + 1) // 2, -(-b // 32)
    words = (_pack_res16(res.long() & 0xFFFF), pack_bits32(torch.zeros(b, dtype=torch.bool,
                                                                       device=cuda)),
             _pack_res16(res.long() & 0xFFFF), torch.empty(nw + nh, dtype=torch.int32,
                                                           device=cuda))
    force = plan or None
    runs = {"classic": lambda: kms.score_update(ops, wire, tenant, flags, res, plan=force),
            "resident": lambda: kms.score_update_resident(ops, wire, tenant, flags, *words,
                                                          plan=force)}
    out = {}
    for entry, fn in runs.items():
        kernels, memsets = {}, 0
        for _ in range(3):
            names, fills = _device_ops(fn)
            for n in names:
                kernels[n] = kernels.get(n, 0) + 1 / 3
            memsets += len(fills) / 3
        out[entry] = {"kernels": kernels, "memsets": memsets}
    return out


#: _k10_ops in a fresh process (see _K7_K8_OPS_CHILD)
_K10_OPS_CHILD = r"""
import json, sys
sys.path.insert(0, "tests")
import test_torch_cuda
print(json.dumps(test_torch_cuda._k10_ops(int(sys.argv[1]), sys.argv[2])))
"""


def test_k10_is_one_kernel_a_call_named_by_its_plan(cuda):
    """Each K10 call, on both entries, is one kernel and no memset (the
    profiler, in a process of its own), and the kernel names its plan:
    block_kernel up to the crossover, grid_kernel past it or when plan L
    is forced."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    from infw_torch.kernels import mxu_score as kms

    cross = kms.BLOCK_PLAN_MAX_LANES
    for b, plan, want in ((256, "", "block_kernel"), (cross, "", "block_kernel"),
                          (cross + 1, "", "grid_kernel"), (256, "L", "grid_kernel"),
                          (1 << 18, "", "grid_kernel")):
        proc = subprocess.run([sys.executable, "-c", _K10_OPS_CHILD, str(b), plan],
                              cwd=Path(__file__).resolve().parents[1], capture_output=True,
                              text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        for entry, got in json.loads(proc.stdout.strip().splitlines()[-1]).items():
            kernels = got["kernels"]
            assert len(kernels) == 1 and want in next(iter(kernels)), (b, plan, entry, kernels)
            assert next(iter(kernels.values())) == pytest.approx(1.0), (entry, kernels)
            assert got["memsets"] == 0, (entry, got)


def test_k10_wrapper_refuses_a_plan_that_does_not_fit(cuda):
    """Plan S forced where the state does not fit, or with a grid cap,
    raises before any launch; an unknown plan raises."""
    from infw_torch.kernels import mxu_score as kms

    def ops_for(spec):
        return kms.ScoreOps(kms.zero_state(spec, cuda),
                            kms.model_device(kms.default_model(spec), cuda),
                            torch.from_numpy(kms.zero_tparams(spec)).to(cuda),
                            kms.empty_scratch(spec, cuda), spec)

    big = kms.ScoreSpec.make(slots=65536, cms_width=65536)
    z = torch.zeros(8, dtype=torch.int32, device=cuda)
    wire = torch.zeros((8, 7), dtype=torch.int32, device=cuda)
    before = kms.KERNEL.launches
    for kw in (dict(plan="S"), dict(plan="X")):
        with pytest.raises(ValueError):
            kms.score_update(ops_for(big), wire, z, z, z, **kw)
    with pytest.raises(ValueError):
        kms.score_update(ops_for(kms.ScoreSpec.make()), wire, z, z, z, plan="S", grid=2)
    assert kms.KERNEL.launches == before


@pytest.mark.parametrize("path", ["dense", "trie"])
def test_resident_graph_with_scoring_matches_the_cpu_and_the_eager_step(cuda, path):
    """The resident classifier with anomaly scoring in enforce mode (a
    threshold that fires) on the card against the same on the CPU over a
    flow trace at ragged sizes: equal outputs, flow columns, score tensors
    and recent masks; one more admission's graph against the eager step (K10
    as a stage between the probe and the insert) on clones of the columns
    and the score state."""
    from infw_torch import flow as flow_mod
    from infw_torch.kernels import flow as kflow
    from infw_torch.kernels import mxu_score as kms
    from infw_torch.kernels.resident import resident_fused_host, resident_step

    rng = np.random.default_rng(37)
    tables = testing.random_tables_fast(rng, 300 if path == "dense" else 5000, width=4,
                                        v6_fraction=0.5)
    spec = kms.ScoreSpec.make(slots=128, ways=2, hidden=4)
    fp = None if path == "dense" else path
    kw = dict(force_path=fp, resident=True, flow_table=4096, mlscore=spec,
              mlscore_model=kms.clamp_stress_model(spec), mlscore_mode="enforce")
    gpu, cpu = TorchClassifier(device=cuda, **kw), TorchClassifier(device="cpu", **kw)
    for c in (gpu, cpu):
        c.load_tables(tables)
        c.mlscore.set_threshold(60)
        c.mlscore.set_keep_masks(16)
    batch, _ = testing.flow_trace_batch(rng, tables, 4 * 1024, 0.9, chunk_packets=1024)
    start = 0
    for k, size in enumerate((1024, 61, 1000, 1024, 8, 1)):
        sub = batch.slice(start, start + size)
        start += size
        _same_outputs(gpu.classify(sub), cpu.classify(sub), f"{path} chunk {k}")
    gs, cs = gpu.mlscore.columns(), cpu.mlscore.columns()
    for f in gs:
        np.testing.assert_array_equal(gs[f], cs[f], err_msg=f)
    for (e1, a1, s1), (e2, a2, s2) in zip(gpu.mlscore.recent_masks(), cpu.mlscore.recent_masks()):
        assert e1 == e2 and np.array_equal(a1, a2) and np.array_equal(s1, s2)
    assert gs["tstat"][0, 2] > 0 and gpu.mlscore_counters() == cpu.mlscore_counters()
    gf, cf = gpu.flow.flow_columns(), cpu.flow.flow_columns()
    for k in gf:
        np.testing.assert_array_equal(gf[k], cf[k], err_msg=k)

    sub = batch.slice(0, 1024)
    wire_np = sub.pack_wire()
    ctx = gpu.resident.context(gpu)
    tables_step = ctx.tables._replace(
        n_levels=None if path != "trie" else ctx.tables.dev.n_levels)
    tier, ml = gpu.flow, gpu.mlscore
    eager_flow = kflow.clone_flow_table(tier._flow)
    eager_epoch = tier._epoch_dev.clone()
    eager_sc = ml.ops()._replace(state=kms.ScoreState(*(t.clone() for t in ml._state)))
    gens_op, pages_op = tier._res_ops
    fl = torch.from_numpy(sub.tcp_flags.astype(np.int32)).to(cuda)
    ops = flow_mod.ResidentOps(eager_flow, gens_op.clone(), pages_op.clone(), eager_epoch,
                               torch.zeros(1024, dtype=torch.int32, device=cuda), fl,
                               tier.config.max_age, tier.config.entries, tier.config.ways,
                               score=eager_sc)
    before = kms.RESIDENT_KERNEL.launches
    eager = resident_step(ops, tables_step, torch.from_numpy(wire_np.view(np.int32)).to(cuda))
    assert kms.RESIDENT_KERNEL.launches == before + 1
    plan = gpu.prepare_packed(wire_np, False, tcp_flags=sub.tcp_flags)
    np.testing.assert_array_equal(resident_fused_host(plan["fused"]), eager.cpu().numpy())
    assert kms.RESIDENT_KERNEL.launches == before + 2
    for c in kflow.COLUMNS:
        assert torch.equal(getattr(tier._flow, c), getattr(eager_flow, c)), c
    for f in kms.ScoreState._fields:
        assert torch.equal(getattr(ml._state, f), getattr(eager_sc.state, f)), f


def test_score_swap_flip_drain_and_reset_write_in_place(cuda):
    """On a warmed resident classifier with scoring: a model swap, a mode
    flip, a threshold change, a drain and a reset rewrite the tensors the
    graphs baked in place (same addresses), capture nothing and allocate
    nothing; each later admission equals the CPU classifier's after the same
    steps."""
    from infw_torch.kernels import mxu_score as kms

    rng = np.random.default_rng(41)
    tables = testing.random_tables_fast(rng, 5000, width=4, v6_fraction=0.5)
    spec = kms.ScoreSpec.make(slots=128, ways=2, hidden=4)
    kw = dict(force_path="trie", resident=True, flow_table=4096, mlscore=spec,
              mlscore_model=kms.clamp_stress_model(spec))
    gpu, cpu = TorchClassifier(device=cuda, **kw), TorchClassifier(device="cpu", **kw)
    for c in (gpu, cpu):
        c.load_tables(tables)
    batch, _ = testing.flow_trace_batch(rng, tables, 6 * 256, 0.8, chunk_packets=256)
    chunks = [batch.slice(256 * j, 256 * (j + 1)) for j in range(6)]
    for sub in chunks[:2]:
        _same_outputs(gpu.classify(sub), cpu.classify(sub), "warm")
    gpu.mark_resident_warm()
    ml = gpu.mlscore
    ptrs = [t.data_ptr() for t in (*ml._state, *ml._model_dev, ml._tparams_dev, ml._scratch)]
    graphs = gpu.resident.graphs()
    gen0 = int(gpu.flow._gens_host[0])
    steps = [
        lambda c: c.set_score_model(testing.random_score_model(np.random.default_rng(5), spec)),
        lambda c: c.mlscore.set_mode("enforce"),
        lambda c: c.mlscore.set_threshold(-1000),
        lambda c: c.mlscore.drain(),
        lambda c: c.mlscore.reset_state(),
        lambda c: c.mlscore.set_mode("shadow"),
    ]
    for j, step in enumerate(steps):
        for c in (gpu, cpu):
            step(c)
        sub = chunks[j % len(chunks)]
        _same_outputs(gpu.classify(sub), cpu.classify(sub), f"step {j}")
        gs, cs = gpu.mlscore.columns(), cpu.mlscore.columns()
        for f in gs:
            np.testing.assert_array_equal(gs[f], cs[f], err_msg=f"step {j} {f}")
    assert ptrs == [t.data_ptr() for t in (*ml._state, *ml._model_dev, ml._tparams_dev,
                                           ml._scratch)]
    assert gpu.resident.graphs() == graphs and gpu.resident.steady_allocs() == 0
    # the swap, two mode flips and the threshold each bump the generation
    assert int(gpu.flow._gens_host[0]) == int(cpu.flow._gens_host[0]) == gen0 + 4


# --- K11: the payload tier's Aho-Corasick walk ------------------------------------------

#: automata of the card grid: pattern count, matmul flag -> (S, PW)
K11_SETS = {"s64_pw1_matmul": (8, True), "s1024_pw2": (64, False),
            "s16384_pw32": (1024, False), "pw64": (2048, False)}


def _k11_model(name, plen):
    from infw_torch import payload as ppay
    from infw_torch.kernels import acmatch as kac

    key = (name, plen)
    if key not in _K11_MODELS:
        count, matmul = K11_SETS[name]
        pats = ppay.signature_patterns(np.random.default_rng(count), count, plen)
        _K11_MODELS[key] = kac.compile_patterns(pats, plen=plen, matmul=matmul or None)
    return _K11_MODELS[key]


_K11_MODELS = {}


def _k11_columns(rng, model, b, kind, stride=None):
    """(pay (b, stride) uint8, plen (b,) int32): "synflood" rows (no payload
    or a few junk bytes) or an "attack" mix (10% planted signatures, benign
    HTTP lines, the length edge cases)."""
    from infw_torch import payload as ppay

    L = model.spec.plen
    stride = stride or L
    pay = np.zeros((b, stride), np.uint8)
    if kind == "synflood":
        lens = np.where(rng.random(b) < 0.8, 0, rng.integers(1, 9, b)).astype(np.int32)
        pay[:, :8] = rng.integers(0, 256, (b, 8), dtype=np.uint8)
    else:
        n_b = min(b, 2048)  # the generators loop in Python: tile a block
        bp, bl = ppay.benign_payloads(rng, n_b, L)
        ap, al = ppay.attack_payloads(rng, n_b, model.patterns, L)
        att = rng.random(n_b) < 0.1
        bp[att], bl[att] = ap[att], al[att]
        reps = -(-b // n_b)
        pay[:, :L] = np.tile(bp, (reps, 1))[:b]
        lens = np.tile(bl, reps)[:b].astype(np.int32)
        edge = np.asarray([0, -1, L + 1, 2**31 - 1, L, L - 1, -2**31, 1], np.int32)
        lens[: min(b, 8)] = edge[: min(b, 8)]
    if stride > L:
        pay[:, L:] = rng.integers(0, 256, (b, stride - L), dtype=np.uint8)
    return pay, lens


def _k11_resident_operands(rng, b, device):
    from infw_torch.kernels.flow import pack_bits32
    from infw_torch.kernels.torchpath import _pack_res16

    proto = rng.choice([6, 17, 1], b).astype(np.uint32)
    dport = rng.choice([22, 68, 80, 443, 2379, 10250], b).astype(np.uint32)
    wire = np.zeros((b, 7), np.uint32)
    wire[:, 0] = 1 | (1 << 2) | (proto << 3)
    wire[:, 1] = dport
    res = rng.integers(0, 3, b) | (rng.integers(0, 9, b) << 8)
    hit = rng.random(b) < 0.4
    served = _pack_res16(torch.from_numpy(np.where(hit, res, 7)))
    stateless = _pack_res16(torch.from_numpy(np.where(hit, 5, res)))
    return (torch.from_numpy(wire.view(np.int32)).to(device), served.to(device),
            pack_bits32(torch.from_numpy(hit)).to(device), stateless.to(device))


@pytest.mark.parametrize("kind", ["synflood", "attack"])
@pytest.mark.parametrize("b", [1, 31, 33, 256, 4096, 1 << 18])
@pytest.mark.parametrize("plen", [64, 128])
@pytest.mark.parametrize("name", sorted(K11_SETS))
def test_k11_matches_plain(cuda, name, plen, b, kind):
    """K11's classic entry (bitmaps) and resident entry (the merge, the
    enforce rewrite, both word vectors and the tail) against their plain
    versions on the card's tensors, one launch each."""
    from infw_torch.kernels import acmatch as kac

    model = _k11_model(name, plen)
    rng = np.random.default_rng(b + plen)
    pay_np, lens_np = _k11_columns(rng, model, b, kind)
    dev = kac.model_device(model, cuda)
    pay, lens = torch.from_numpy(pay_np).to(cuda), torch.from_numpy(lens_np).to(cuda)
    before = kac.KERNEL.launches
    got = kac.acmatch(dev, pay, lens, model.spec)
    torch.cuda.synchronize()
    assert kac.KERNEL.launches == before + 1
    want = kac.acmatch_plain(dev, pay, lens, model.spec)
    assert torch.equal(got, want)
    if kind == "attack" and b > 8:  # the first 8 rows carry the length edge cases
        assert (got != 0).any()
    nh = -(-b // 32)
    wire, served, hit, res16 = _k11_resident_operands(rng, b, cuda)
    for mode in (0, 1):
        ops = kac.PayloadOps(dev, torch.tensor([mode], dtype=torch.int32, device=cuda),
                             model.spec, pay, lens)
        outs = []
        for fn in (kac.acmatch_resident, kac.acmatch_resident_plain):
            s, r = served.clone(), res16.clone()
            tail = torch.full((2 * nh,), -1, dtype=torch.int32, device=cuda)
            fn(ops, wire, s, hit, r, tail)
            outs.append((s, r, tail))
        for x, y in zip(*outs):
            assert torch.equal(x, y), (name, plen, b, kind, mode)
    assert kac.RESIDENT_KERNEL.launches >= 2


@pytest.mark.parametrize("stride", [72, 200])
def test_k11_unaligned_and_wide_columns_match_plain(cuda, stride):
    """A column wider than L whose rows are not 16-byte aligned (the byte
    load path) or wider still: the bytes past L are ignored."""
    from infw_torch.kernels import acmatch as kac

    model = _k11_model("s1024_pw2", 64)
    rng = np.random.default_rng(stride)
    pay_np, lens_np = _k11_columns(rng, model, 999, "attack", stride=stride)
    dev = kac.model_device(model, cuda)
    pay, lens = torch.from_numpy(pay_np).to(cuda), torch.from_numpy(lens_np).to(cuda)
    got = kac.acmatch(dev, pay, lens, model.spec)
    assert torch.equal(got, kac.acmatch_plain(dev, pay, lens, model.spec))
    assert torch.equal(got, kac.acmatch(dev, pay[:, :64].contiguous(), lens, model.spec))


def test_k11_wrapper_refuses_bad_operands(cuda):
    from infw_torch.kernels import acmatch as kac

    model = _k11_model("s1024_pw2", 64)
    dev = kac.model_device(model, cuda)
    pay = torch.zeros((8, 64), dtype=torch.uint8, device=cuda)
    lens = torch.zeros(8, dtype=torch.int32, device=cuda)
    before = kac.KERNEL.launches
    bad = [(dev, pay[:, :32].contiguous(), lens), (dev, pay.to(torch.int32), lens),
           (dev, pay, lens.cpu()), (dev, pay, lens[:4]), (dev, pay, lens.to(torch.int64)),
           (kac.AcDev(dev.delta[:10], dev.matchmap), pay, lens)]
    for d, p, n in bad:
        with pytest.raises(ValueError):
            kac.acmatch(d, p, n, model.spec)
    assert kac.KERNEL.launches == before
    assert kac.acmatch(dev, pay[:0], lens[:0], model.spec).shape == (0, model.spec.pwords)
    assert kac.KERNEL.launches == before


def _k11_both_entries(kac, dev, model, pay, lens, rng, cuda, **kw):
    """K11's classic and resident entries (enforce mode) with ``kw`` (a
    forced plan or row count) against their plain versions."""
    b = pay.shape[0]
    got = kac.acmatch(dev, pay, lens, model.spec, **kw)
    assert torch.equal(got, kac.acmatch_plain(dev, pay, lens, model.spec)), kw
    nh = -(-b // 32)
    wire, served, hit, res16 = _k11_resident_operands(rng, b, cuda)
    ops = kac.PayloadOps(dev, torch.ones(1, dtype=torch.int32, device=cuda), model.spec, pay, lens)
    outs = []
    for fn, extra in ((kac.acmatch_resident, kw), (kac.acmatch_resident_plain, {})):
        s, r = served.clone(), res16.clone()
        tail = torch.full((2 * nh,), -1, dtype=torch.int32, device=cuda)
        fn(ops, wire, s, hit, r, tail, **extra)
        outs.append((s, r, tail))
    for x, y in zip(*outs):
        assert torch.equal(x, y), kw
    return got


@pytest.mark.parametrize("b", [1, 31, 33, 256, 4096, 1 << 17, (1 << 17) + 1, 1 << 18])
@pytest.mark.parametrize("plan", ["S", "L"])
@pytest.mark.parametrize("name", ["s1024_pw2", "pw64"])
def test_k11_forced_plans_match_plain(cuda, name, plan, b):
    """Each of K11's plans forced at each size, both entries, against the
    plain versions (plan S stages the reachable rows, plan L none)."""
    from infw_torch.kernels import acmatch as kac

    model = _k11_model(name, 64)
    rng = np.random.default_rng(b + 7)
    pay_np, lens_np = _k11_columns(rng, model, b, "attack")
    dev = kac.model_device(model, cuda)
    pay, lens = torch.from_numpy(pay_np).to(cuda), torch.from_numpy(lens_np).to(cuda)
    before = kac.KERNEL.launches
    _k11_both_entries(kac, dev, model, pay, lens, rng, cuda, plan=plan)
    assert kac.KERNEL.launches == before + 1


@pytest.mark.parametrize("b", [33, 4096, 1 << 18])
@pytest.mark.parametrize("name", ["s64_pw1_matmul", "s1024_pw2", "s16384_pw32"])
def test_k11_staging_forced_to_one_row(cuda, name, b):
    """Staging cut to the root's row (and to none): almost every step then
    takes the global path, and both entries still equal the plain ones."""
    from infw_torch.kernels import acmatch as kac

    model = _k11_model(name, 128)
    rng = np.random.default_rng(b)
    pay_np, lens_np = _k11_columns(rng, model, b, "attack")
    dev = kac.model_device(model, cuda)
    pay, lens = torch.from_numpy(pay_np).to(cuda), torch.from_numpy(lens_np).to(cuda)
    for rows in (1, 0):
        _k11_both_entries(kac, dev, model, pay, lens, rng, cuda, plan="S", rows=rows)
    with pytest.raises(ValueError):
        kac.acmatch(dev, pay, lens, model.spec, rows=model.spec.states + 1)


@pytest.mark.parametrize("plan", ["S", "L"])
def test_k11_out_of_range_delta_matches_plain(cuda, plan):
    """A delta seeded with negative and >= S entries: the layout folds XLA's
    clip into the table, so both entries equal the plain versions (which
    clip at every read)."""
    from infw_torch.kernels import acmatch as kac

    model = _k11_model("s1024_pw2", 64)
    rng = np.random.default_rng(11)
    delta = model.delta.copy()
    at = rng.integers(0, delta.size, 20000)
    delta.flat[at] = rng.choice([-1, -9, -2**31, model.spec.states, 10**6, 2**31 - 1], 20000)
    bad = model._replace(delta=delta)
    dev = kac.model_device(bad, cuda)
    pay_np, lens_np = _k11_columns(rng, bad, 4096, "attack")
    pay, lens = torch.from_numpy(pay_np).to(cuda), torch.from_numpy(lens_np).to(cuda)
    _k11_both_entries(kac, dev, bad, pay, lens, rng, cuda, plan=plan)


@pytest.mark.parametrize("name", ["s1024_pw2", "pw64"])
def test_k11_one_walk_and_lanes_past_their_slots(cuda, name):
    """PW 2 and PW 64 (above the 32 words held in registers) in one launch
    of one walk a lane, on the attack mix and on rows that land on more
    reporting states than a lane's slots (pattern after pattern, and one
    pattern repeated), which take the slow path."""
    from infw_torch.kernels import acmatch as kac

    model = _k11_model(name, 128)
    rng = np.random.default_rng(5)
    b = 3000
    pay_np, lens_np = _k11_columns(rng, model, b, "attack")
    short = [p for p in model.patterns if len(p) <= 4][:8] or list(model.patterns[:8])
    for i in range(0, b, 3):
        row = b"".join(short[(i + k) % len(short)] for k in range(32))[:128]
        if i % 2:
            row = (short[0] * 64)[:128]
        pay_np[i, :len(row)] = np.frombuffer(row, np.uint8)
        lens_np[i] = len(row)
    dev = kac.model_device(model, cuda)
    pay, lens = torch.from_numpy(pay_np).to(cuda), torch.from_numpy(lens_np).to(cuda)
    before = kac.KERNEL.launches
    got = _k11_both_entries(kac, dev, model, pay, lens, rng, cuda)
    assert kac.KERNEL.launches == before + 1
    bits = kac.layout_walk_plain(dev, pay, lens, model.spec)[0]
    assert torch.equal(got, bits)
    reported = np.unpackbits(got.cpu().numpy().view(np.uint8), axis=1).sum(axis=1)
    assert reported[::3].max() > 4  # some lane reported more patterns than it has slots


def test_k11_captured_resident_graph_replays_across_a_swap(cuda):
    """The resident entry captured in a CUDA graph, then replayed after
    PayloadTier.swap_patterns to a set with another reachable-state count
    (the header and tables rewritten in place, no capture): every replay
    equals the plain entry over the set in force."""
    from infw_torch import payload as ppay
    from infw_torch.kernels import acmatch as kac

    spec = kac.AcSpec.make(1024, 64, 64)
    sets = [ppay.signature_patterns(np.random.default_rng(s), n, 64)
            for s, n in ((0, 64), (9, 40))]
    tier = ppay.PayloadTier(kac.compile_patterns(sets[0], spec=spec), device=cuda)
    heads = []
    rng = np.random.default_rng(3)
    b = 2048
    pay_np, lens_np = _k11_columns(rng, tier.model, b, "attack")
    ap, al = ppay.attack_payloads(rng, b // 4, sets[1], 64)
    pay_np[1::4], lens_np[1::4] = ap[: len(pay_np[1::4])], al[: len(pay_np[1::4])]
    pay, lens = torch.from_numpy(pay_np).to(cuda), torch.from_numpy(lens_np).to(cuda)
    wire, served, hit, res16 = _k11_resident_operands(rng, b, cuda)
    ops = tier.ops()._replace(pay=pay, plen=lens)
    nh = -(-b // 32)
    bufs = [served.clone(), res16.clone(), torch.zeros(2 * nh, dtype=torch.int32, device=cuda)]
    kac.acmatch_resident(ops, wire, bufs[0], hit, bufs[1], bufs[2])  # eager first: the set-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        kac.acmatch_resident(ops, wire, bufs[0], hit, bufs[1], bufs[2])
    launches = kac.RESIDENT_KERNEL.launches
    for k, pats in enumerate([None, sets[1], sets[0]]):
        if pats is not None:
            tier.swap_patterns(pats)
        heads.append(int(tier.ops().dev.head[0]))
        bufs[0].copy_(served)
        bufs[1].copy_(res16)
        graph.replay()
        want = [served.clone(), res16.clone(), torch.zeros(2 * nh, dtype=torch.int32,
                                                           device=cuda)]
        kac.acmatch_resident_plain(ops, wire, want[0], hit, want[1], want[2])
        torch.cuda.synchronize()
        for x, y in zip(bufs, want):
            assert torch.equal(x, y), k
    assert heads[0] != heads[1] and heads[0] == heads[2]
    assert kac.RESIDENT_KERNEL.launches == launches  # replays launch through the graph


def _with_payload(rng, batch, pats, plen=64):
    from infw_torch import payload as ppay

    n = len(batch)
    pay, lens = ppay.benign_payloads(rng, n, plen)
    att = rng.random(n) < 0.3
    ap, al = ppay.attack_payloads(rng, int(att.sum()), pats, plen)
    pay[att], lens[att] = ap, al
    batch.payload, batch.payload_len = pay, lens.astype(np.int32)
    return batch


@pytest.mark.parametrize("path", ["dense", "trie", "ctrie"])
def test_resident_graph_with_payload_matches_the_cpu_and_the_eager_step(cuda, path):
    """The resident classifier with the payload tier in enforce mode (and
    scoring beside it on the trie path) on the card against the same on the
    CPU over a flow trace with payload columns at ragged sizes: equal
    outputs, counters and flow columns; one more admission's graph against
    the eager step (K11 as the stage between the score and the insert) on
    clones of the columns."""
    from infw_torch import flow as flow_mod
    from infw_torch import payload as ppay
    from infw_torch.kernels import acmatch as kac
    from infw_torch.kernels import flow as kflow
    from infw_torch.kernels.resident import resident_fused_host, resident_step

    rng = np.random.default_rng(43)
    tables = testing.random_tables_fast(rng, 300 if path == "dense" else 5000, width=4,
                                        v6_fraction=0.5)
    pats = ppay.signature_patterns(np.random.default_rng(0), 64)
    fp = None if path == "dense" else path
    kw = dict(force_path=fp, resident=True, flow_table=4096, payload=pats,
              payload_mode="enforce", payload_track=True)
    gpu, cpu = TorchClassifier(device=cuda, **kw), TorchClassifier(device="cpu", **kw)
    for c in (gpu, cpu):
        c.load_tables(tables)
    batch, _ = testing.flow_trace_batch(rng, tables, 4 * 1024, 0.9, chunk_packets=1024)
    batch = _with_payload(rng, batch, pats)
    start = 0
    for k, size in enumerate((1024, 61, 1000, 1024, 8, 1)):
        sub = batch.slice(start, start + size)
        start += size
        _same_outputs(gpu.classify(sub), cpu.classify(sub), f"{path} chunk {k}")
    assert gpu.payload_counters() == cpu.payload_counters()
    assert gpu.payload_counters()["payload_enforced_total"] > 0
    for (a, b) in zip(gpu.payload.recent_masks(), cpu.payload.recent_masks()):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    gf, cf = gpu.flow.flow_columns(), cpu.flow.flow_columns()
    for k in gf:
        np.testing.assert_array_equal(gf[k], cf[k], err_msg=k)

    sub = batch.slice(0, 1024)
    wire_np = sub.pack_wire()
    ctx = gpu.resident.context(gpu)
    tables_step = ctx.tables._replace(
        n_levels=None if path != "trie" else ctx.tables.dev.n_levels)
    tier = gpu.flow
    eager_flow = kflow.clone_flow_table(tier._flow)
    eager_epoch = tier._epoch_dev.clone()
    gens_op, pages_op = tier._res_ops
    fl = torch.from_numpy(sub.tcp_flags.astype(np.int32)).to(cuda)
    pops = gpu.payload.ops()._replace(pay=torch.from_numpy(sub.payload).to(cuda),
                                      plen=torch.from_numpy(sub.payload_len).to(cuda))
    ops = flow_mod.ResidentOps(eager_flow, gens_op.clone(), pages_op.clone(), eager_epoch,
                               torch.zeros(1024, dtype=torch.int32, device=cuda), fl,
                               tier.config.max_age, tier.config.entries, tier.config.ways,
                               payload=pops)
    before = kac.RESIDENT_KERNEL.launches
    eager = resident_step(ops, tables_step, torch.from_numpy(wire_np.view(np.int32)).to(cuda))
    assert kac.RESIDENT_KERNEL.launches == before + 1
    plan = gpu.prepare_packed(wire_np, False, tcp_flags=sub.tcp_flags, payload=sub.payload,
                              payload_len=sub.payload_len)
    np.testing.assert_array_equal(resident_fused_host(plan["fused"]), eager.cpu().numpy())
    assert kac.RESIDENT_KERNEL.launches == before + 2
    for c in kflow.COLUMNS:
        assert torch.equal(getattr(tier._flow, c), getattr(eager_flow, c)), c


def test_payload_swap_and_flip_write_in_place_and_capture_nothing(cuda):
    """On a warmed resident classifier with the payload tier (and a
    superbatch): a pattern swap and mode flips rewrite the automaton and the
    mode tensor in place (same addresses), capture nothing and allocate
    nothing; each later admission equals the CPU classifier's after the same
    steps, and the flow generation bumps each time."""
    from infw_torch import payload as ppay

    rng = np.random.default_rng(47)
    tables = testing.random_tables_fast(rng, 5000, width=4, v6_fraction=0.5)
    pats = ppay.signature_patterns(np.random.default_rng(0), 64)
    other = ppay.signature_patterns(np.random.default_rng(9), 64)
    kw = dict(force_path="trie", resident=True, flow_table=4096, payload=pats)
    gpu, cpu = TorchClassifier(device=cuda, **kw), TorchClassifier(device="cpu", **kw)
    for c in (gpu, cpu):
        c.load_tables(tables)
    batch, _ = testing.flow_trace_batch(rng, tables, 6 * 256, 0.8, chunk_packets=256)
    batch = _with_payload(rng, batch, pats + other)
    chunks = [batch.slice(256 * j, 256 * (j + 1)) for j in range(6)]

    def superbatch(c, j):
        subs = [chunks[(j + i) % 6] for i in range(2)]
        plan = c.prepare_packed_super(np.stack([s.pack_wire() for s in subs]), False,
                                      np.stack([s.tcp_flags for s in subs]),
                                      payload_stack=np.stack([s.payload for s in subs]),
                                      payload_len_stack=np.stack([s.payload_len for s in subs]))
        return [r.result() for r in c.classify_prepared_super(plan)]

    for sub in chunks[:2]:
        _same_outputs(gpu.classify(sub), cpu.classify(sub), "warm")
    for o1, o2 in zip(superbatch(gpu, 0), superbatch(cpu, 0)):
        _same_outputs(o1, o2, "warm super")
    gpu.mark_resident_warm()
    pt = gpu.payload
    ptrs = [t.data_ptr() for t in (*pt._dev, pt._pmode)]
    graphs = gpu.resident.graphs()
    gen0 = int(gpu.flow._gens_host[0])
    steps = [lambda c: c.set_payload_mode("enforce"), lambda c: c.set_payload_patterns(other),
             lambda c: c.set_payload_mode("shadow"), lambda c: c.set_payload_mode("enforce")]
    for j, step in enumerate(steps):
        for c in (gpu, cpu):
            step(c)
        sub = chunks[j % len(chunks)]
        _same_outputs(gpu.classify(sub), cpu.classify(sub), f"step {j}")
        for o1, o2 in zip(superbatch(gpu, j), superbatch(cpu, j)):
            _same_outputs(o1, o2, f"step {j} super")
    assert ptrs == [t.data_ptr() for t in (*pt._dev, pt._pmode)]
    assert gpu.resident.graphs() == graphs and gpu.resident.steady_allocs() == 0
    assert int(gpu.flow._gens_host[0]) == int(cpu.flow._gens_host[0]) == gen0 + 4
    assert gpu.payload_counters() == cpu.payload_counters()
    assert gpu.payload_counters()["payload_enforced_total"] > 0


# --- the ingest ring ---------------------------------------------------------------------


def _ring_stream(tables, n_records: int, record: int, seed: int, pats):
    """flow_trace_batch records with SYN / ACK / FIN / RST flags and a 10%
    signature mix in a 64-byte payload column: [(wire, v4, flags, pay,
    plen)]."""
    from infw_torch import payload as ppay

    rng = np.random.default_rng(seed)
    n = n_records * record
    batch, _meta = testing.flow_trace_batch(rng, tables, n, 0.8, chunk_packets=record)
    flags = np.asarray(batch.tcp_flags).copy()
    flags[::29] |= 0x04
    k = n // 10
    pay_a, len_a = ppay.attack_payloads(rng, k, pats, plen=64)
    pay_b, len_b = ppay.benign_payloads(rng, n - k, plen=64)
    perm = rng.permutation(n)
    pay = np.concatenate([pay_a, pay_b])[perm]
    plen = np.concatenate([len_a, len_b])[perm].astype(np.int32)
    out = []
    for lo in range(0, n, record):
        idx = np.arange(lo, lo + record)
        w, v4 = batch.pack_wire_subset(idx)
        out.append((w, v4, flags[idx], pay[idx], plen[idx]))
    return out


def test_ring_staged_slot_views_are_pinned(cuda, tmp_path):
    """stage_pinned on the card: a popped record's views are page-locked, a
    tensor over them copies to the card without blocking and equals the
    record, and the staged buffer is reused by the slot's next record."""
    from infw_torch.ring import IngestRing

    ring = IngestRing.create(str(tmp_path / "r.ring"), slots=2, slot_packets=512,
                             payload_width=64)
    ring.stage_pinned()
    rng = np.random.default_rng(1)
    bufs = []
    for n in (512, 100, 512):
        w = rng.integers(0, 1 << 32, (n, 7), dtype=np.uint64).astype(np.uint32)
        fl = rng.integers(0, 32, n).astype(np.int32)
        pay = rng.integers(0, 256, (n, 64), dtype=np.uint8)
        plen = rng.integers(0, 65, n).astype(np.int32)
        ring.push(w, tcp_flags=fl, payload=pay, payload_len=plen)
        c = ring.pop()
        views = (c.wire, c.tcp_flags, c.payload, c.payload_len)
        assert all(torch.from_numpy(v).is_pinned() for v in views)
        dev = torch.from_numpy(c.wire.view(np.int32)).to(cuda, non_blocking=True)
        dpay = torch.from_numpy(c.payload).to(cuda, non_blocking=True)
        torch.cuda.synchronize()
        assert np.array_equal(dev.cpu().numpy().view(np.uint32), w)
        assert np.array_equal(dpay.cpu().numpy(), pay)
        bufs.append(c.wire.__array_interface__["data"][0])
        c.release()
    assert bufs[2] == bufs[0]  # slot 0's buffer, reused
    ring.close()


@pytest.mark.parametrize("resident", [False, True], ids=["multi", "resident"])
def test_ring_fed_daemon_equals_the_classic_classify(cuda, tmp_path, resident):
    """Daemon(ring=...) on the card (flow tier, payload tier in enforce;
    the resident one at --superbatch-k 4) over records pushed before the
    tick: each record's verdicts, the statistics, the payload and the flow
    counters equal the same records through classify_async_packed on a
    classic classifier in the daemon's order of pops and read backs; K11
    launched on the card; every slot released."""
    import json
    import os

    from infw_torch import daemon, spec
    from infw_torch import payload as ppay
    from infw_torch.flow import FlowConfig
    from infw_torch.interfaces import Interface, InterfaceRegistry
    from infw_torch.ring import IngestRing

    ifaces = {"eth0": 2, "eth1": 3}
    reg = InterfaceRegistry()
    for name, index in ifaces.items():
        reg.add(Interface(name=name, index=index))
    pats = ppay.signature_patterns(np.random.default_rng(11), 64, plen=64)
    extra = {"resident": True, "superbatch_k": 4} if resident else {}
    d = daemon.Daemon(state_dir=str(tmp_path / "state"), node_name="n", registry=reg,
                      metrics_port=0, health_port=0, file_poll_interval_s=60.0,
                      pipeline_depth=3, max_tick_packets=4096, ring=str(tmp_path / "in.ring"),
                      flow_table=FlowConfig.make(entries=1 << 14), payload=pats,
                      payload_mode="enforce", **extra)
    try:
        assert d.ingest_ring.pinned != resident
        assert d.ingest_ring.slots == 10  # room for the 9 records pushed before the tick
        doc = testing.random_nodestate(np.random.default_rng(5), "n", ifaces, 3000)
        with open(os.path.join(d.nodestates_dir, "n.json"), "w") as f:
            json.dump(doc, f)
        d.scan_nodestates_once()
        ns = spec.IngressNodeFirewallNodeState.from_dict(doc)
        tables = compiler.compile_tables(ns.spec.interface_ingress_rules, reg)
        recs = _ring_stream(tables, 9, 1024, 3, pats)
        # the daemon's pops and drains in order: the multi-dispatch plan
        # inserts a record's misses (with enforced verdicts) when it
        # materializes, so a record probed before the last one's insert
        # can miss where a sequential classify hits
        served, events = {}, []
        drain, pop = d._ring_drain_one, d.ingest_ring.pop

        def drain_one():
            chunk, pending, _t = d._ring_inflight[0]
            drain()
            served[chunk.seq] = pending.result()
            events.append(("drain", chunk.seq))

        def pop_logged(timeout=0.0):
            chunk = pop(timeout)
            if chunk is not None:
                events.append(("pop", chunk.seq))
            return chunk

        d._ring_drain_one, d.ingest_ring.pop = drain_one, pop_logged
        prod = IngestRing.attach(d.ingest_ring.path)
        for w, v4, fl, pay, plen in recs:
            prod.push(w, v4_only=v4, tcp_flags=fl, payload=pay, payload_len=plen)
        prod.close()
        for k in all_kernels():
            k.launches = 0
        assert d.process_ring_once(budget=10 ** 9) == 9 * 1024
        launches = {k.name: k.launches for k in all_kernels() if k.launches}
        clf = d.syncer.classifier
        ref = TorchClassifier(device=cuda, flow_table=FlowConfig.make(entries=1 << 14),
                              payload=pats, payload_mode="enforce")
        ref.load_tables(tables)
        # a resident step inserts before the next step probes: the records'
        # order is the daemon's
        replay = ([(e, seq) for seq in range(9) for e in ("pop", "drain")] if resident
                  else events)
        pend = {}
        for ev, seq in replay:
            if ev == "pop":
                w, v4, fl, pay, plen = recs[seq]
                pend[seq] = ref.classify_async_packed(w, v4, tcp_flags=fl, payload=pay,
                                                      payload_len=plen)
                continue
            o = pend.pop(seq).result()
            np.testing.assert_array_equal(served[seq].results, o.results)
            np.testing.assert_array_equal(served[seq].xdp, o.xdp)
        np.testing.assert_array_equal(np.asarray(clf.stats.snapshot()),
                                      np.asarray(ref.stats.snapshot()))
        assert clf.payload_counters() == ref.payload_counters()
        assert clf.flow_counters() == ref.flow_counters()
        if resident:
            assert clf.resident_counters()["resident_superbatch_dispatches_total"] >= 2
            assert launches.get("payload_match_resident", 0) >= 9, launches
        else:
            assert launches.get("payload_match", 0) == 9, launches
            assert launches.get("flow_probe", 0) == 9, launches
        assert d.ingest_ring.tail == d.ingest_ring.head == 9 and not d._ring_inflight
        ref.close()
    finally:
        d.stop()
