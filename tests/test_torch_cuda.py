"""Kernels K1 and K2 on the card against their plain PyTorch versions, at
small sizes.

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
from infw_torch.kernels import dense, torchpath, walk

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
    cpu = dense.dense_classify(fields.cpu(), words.cpu(), dense.build_dense_tables(tables))
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
    cpu_tt = walk.build_trie_tables(tables)
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
