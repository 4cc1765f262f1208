"""Kernels K1, K2 and K3 on the card against their plain PyTorch versions,
at small sizes.

Needs a CUDA card and nvcc; skips elsewhere.  Run on the card with

    python -m pytest -m cuda tests/test_torch_cuda.py

Whether a card exists is decided inside the fixture, so every pytest
worker collects the same tests.
"""
import numpy as np
import pytest
import torch

from infw_torch import compiler, oracle, testing
from infw_torch.backend.cuda import TorchClassifier
from infw_torch.kernels import cwalk, dense, torchpath, walk

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
    k3, k2 = cwalk.KERNEL.launches, walk.KERNEL.launches
    out = clf.classify(batch)
    assert cwalk.KERNEL.launches == k3 + 1 and walk.KERNEL.launches == k2
    ref = trie.classify(batch)
    for f in ("results", "xdp", "stats_delta"):
        np.testing.assert_array_equal(getattr(out, f), getattr(ref, f), err_msg=f)
    want = oracle.classify(tables, batch)
    np.testing.assert_array_equal(out.results, want.results)
    assert testing.stats_dict_from_array(out.stats_delta) == want.stats
