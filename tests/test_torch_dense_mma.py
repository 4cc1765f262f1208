"""K1's tensor-core formulation of the LPM, on the CPU.

The CUDA kernel computes the LPM as an int8 product of each packet's 160
key bits against per-entry planes, then one score constant per entry and a
maximum (``infw_torch/kernels/csrc/dense_classify.cu``).  Here the host
operands are held against the JAX package's TPU packing
(``pallas_dense.build_pallas_tables(tables, "int8")``), and the same
arithmetic, written as an int32 ``torch.matmul``, against
``dense_classify_plain``.  All values are integers: every comparison is
exact.
"""
import numpy as np
import pytest
import torch

from infw import testing as jax_testing
from infw.kernels import pallas_dense
from infw_torch import convert, testing
from infw_torch.compiler import LpmKey, compile_tables_from_content
from infw_torch.constants import KIND_IPV4
from infw_torch.kernels import dense, torchpath
from infw_torch.packets import make_batch


def to_port(tables):
    d = {f: getattr(tables, f) for f in convert.FIELDS}
    d["content"] = tables.content
    return convert.tables_from_jax_arrays(d)


def key_bits(fields: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """(B, 160) int32 0/1 key bits, big-endian within each word."""
    key = torch.cat([fields[:, 1:2], words], dim=1).long() & 0xFFFFFFFF
    shift = torch.arange(31, -1, -1)
    return ((key[:, :, None] >> shift) & 1).reshape(key.shape[0], 160).int()


def formulation(dt: dense.DenseTables, fields: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain torch: (B, 2) [result, tidx]."""
    order = dt.order.long()
    live = order >= 0
    info = torch.from_numpy(dense.row_info(dt.groups.numpy()))
    folded = (info & dense.FOLDED) != 0
    # each row multiplies only its k-steps (32-bit key words); a folded
    # group compares the packet's ifindex with its own instead of word 0
    first = 32 * folded.int()
    col = torch.arange(160)[None, :]
    used = (col >= first[:, None]) & (col < (first + 32 * (info & 7))[:, None])
    planes = torch.where(live[:, None] & used, dt.planes[order.clamp(min=0)].int(), 0)
    const = torch.where(live, dt.lpm_const[order.clamp(min=0)], dense.LPM_NEVER)
    score = const[None, :] - dense.LPM_BIG * torch.matmul(key_bits(fields, words), planes.t())
    assert score.dtype == torch.int32
    lowest = torch.iinfo(torch.int32).min
    gifx = torch.from_numpy(np.repeat(dt.groups.numpy()[:, 2], dt.groups.numpy()[:, 0]))
    score = torch.where(~folded[None, :] | (fields[:, 1:2] == gifx[None, :]), score, lowest)
    pad = score.new_full((score.shape[0], 1), lowest)
    short = torch.cat([torch.where((info & dense.LONGER) == 0, score, lowest), pad], 1)
    whole = torch.cat([score, pad], 1)
    best = torch.where(fields[:, 0] == KIND_IPV4, short.max(1).values, whole.max(1).values)
    tidx = torch.where(best > 0, 4095 - (best & 4095), -1)
    slots = torch.where((tidx >= 0)[:, None, None], dt.rules[tidx.clamp(min=0).long()], 0)
    result = torchpath.rule_scan(dense._unpack_rule_slots(slots),
                                 torchpath.batch_from_fields(fields, words))
    return torch.stack([result, tidx], dim=1).int()


def assert_formulation_matches(tables, batch) -> torch.Tensor:
    dt = dense.build_dense_tables(tables, "cpu")
    fields, words = torchpath.packet_fields(torchpath.device_batch(batch, "cpu"))
    want = dense.dense_classify_plain(fields, words, dt)
    got = formulation(dt, fields, words)
    assert torch.equal(got, want)
    return want


@pytest.mark.parametrize("n_entries", [1, 128, 1000, 4096])
def test_planes_and_constants_equal_the_tpu_packing(n_entries):
    rng = np.random.default_rng(n_entries)
    jt = jax_testing.random_tables_fast(rng, n_entries, width=4, v6_fraction=0.4)
    assert jt.num_entries == n_entries
    pt = pallas_dense.build_pallas_tables(jt, "int8")
    dt = dense.build_dense_tables(to_port(jt), "cpu")
    mdt, m1sum = np.asarray(pt.mdt), np.asarray(pt.m1sum)[0]
    np.testing.assert_array_equal(dt.planes.numpy(), mdt.T)
    entries = dt.entries.numpy().view(np.uint32)
    planes, rowsum = dense.lpm_planes(entries[:, 0:5], entries[:, 5:10])
    np.testing.assert_array_equal(planes, mdt.T)
    np.testing.assert_array_equal(rowsum, m1sum)
    mlen = np.asarray(pt.mask_len)[0]
    # every entry that can match is walked once
    order = dt.order.numpy()
    live = order >= 0
    walked = np.sort(order[live])
    np.testing.assert_array_equal(walked, np.nonzero((mlen >= 0) & (mlen <= 128))[0])
    size, info, gifx = dt.groups.numpy().T
    assert len(order) == size.sum() and (size % dense.N_TILE == 0).all()
    assert len(size) <= dense.MAX_GROUPS
    info, gifx = np.repeat(info, size)[live], np.repeat(gifx, size)[live]
    rows = order[live]
    folded = (info & dense.FOLDED) != 0
    # a folded entry's constant leaves out its ifindex word's M1 bits
    m1_ifx = (mdt.T[:, :32] == -1).sum(axis=1)
    want = dense.lpm_constants(m1sum - np.where(np.isin(np.arange(len(mlen)), rows[folded]),
                                                 m1_ifx, 0), mlen)
    np.testing.assert_array_equal(dt.lpm_const.numpy(), want)
    # the short half first; no row skips a k-step whose planes are not zero;
    # a folded group holds one fully masked ifindex
    assert ((mlen[rows] > 32) == ((info & dense.LONGER) != 0)).all()
    first = np.where(folded, 32, 0)
    end = first + 32 * (info & 7)
    col = np.arange(160)[None, :]
    used = (col < end[:, None]) & ((col >= first[:, None]) | folded[:, None])
    assert not (mdt.T[rows] * ~used).any()
    kw = dt.entries.numpy().view(np.uint32)[:, 0:10]
    assert (kw[rows[folded], 5] == 0xFFFFFFFF).all()
    assert (kw[rows[folded], 0] == gifx[folded].view(np.uint32)).all()
    if n_entries >= 128:
        assert folded.all()  # random_tables_fast: two ifindexes, both folded


def test_score_constants_order_length_then_first_index():
    m1sum = np.array([3, 0, 0, 7, 0], np.int32)
    mlen = np.array([0, 128, 32, -1, 129], np.int32)
    c = dense.lpm_constants(m1sum, mlen).astype(np.int64)
    assert c[0] == (1 << 12 | 4095) - 3 * dense.LPM_BIG
    assert c[1] == (129 << 12 | 4094)
    assert c[2] == (33 << 12 | 4093)
    assert c[3] == c[4] == dense.LPM_NEVER
    # the lowest score of a real entry and of a never-matching one fit int32
    assert c[0] - 160 * dense.LPM_BIG > -(2**31)
    assert dense.LPM_NEVER - 160 * dense.LPM_BIG > -(2**31)
    assert (129 << 12 | 4095) < dense.LPM_BIG


@pytest.mark.parametrize("seed,n_entries,width,n_packets", [
    (0, 40, 12, 300), (5, 40, 12, 300), (3, 10, 8, 77), (11, 12, 6, 120),
])
def test_formulation_matches_plain_on_the_differential_tables(seed, n_entries, width, n_packets):
    rng = np.random.default_rng(seed)
    jt = jax_testing.random_tables(rng, n_entries=n_entries, width=width)
    if seed == 11:
        jt.mask_len[::3] = -1  # tombstoned rows keep their slot as padding
    tables = to_port(jt)
    batch = testing.random_batch_fast(rng, tables, n_packets)
    out = assert_formulation_matches(tables, batch)
    assert (out[:, 1] >= 0).sum() > n_packets // 4


@pytest.mark.parametrize("n_entries", [128, 1000])
def test_formulation_matches_plain_at_table_sizes(n_entries):
    rng = np.random.default_rng(100 + n_entries)
    tables = testing.random_tables_fast(rng, n_entries, ifindexes=(2, 3, 4), width=8,
                                        v6_fraction=0.5)
    assert_formulation_matches(tables, testing.random_batch_fast(rng, tables, 2000))


def test_formulation_many_ifindexes_stays_within_the_group_table():
    """Forty ifindexes: the most common fold while the table has room, an
    ifindex with fewer than N_TILE entries never folds, and the rest stay
    in the generic groups, where the ifindex word is multiplied."""
    rng = np.random.default_rng(40)
    tables = testing.random_tables_fast(rng, 1500, ifindexes=tuple(range(2, 42)), width=4,
                                        v6_fraction=0.5)
    tables.key_words[:4, 0] = 77  # a rare ifindex of four entries
    dt = dense.build_dense_tables(tables, "cpu")
    info = dt.groups.numpy()[:, 1]
    folded_ifx = set(dt.groups.numpy()[(info & dense.FOLDED) != 0, 2].tolist())
    assert len(dt.groups) <= dense.MAX_GROUPS and 0 < len(folded_ifx) < 41
    assert 77 not in folded_ifx and ((info & dense.FOLDED) == 0).any()
    batch = testing.random_batch_fast(rng, tables, 3000)
    batch.ifindex[:100] = 77
    assert_formulation_matches(tables, batch)


def test_formulation_and_plain_without_rule_slots():
    """Zero rule slots: the LPM alone, every verdict 0 (the split that
    chip_smoke.py times)."""
    rng = np.random.default_rng(8)
    tables = testing.random_tables_fast(rng, 200, width=4, v6_fraction=0.5)
    dt = dense.build_dense_tables(tables, "cpu")
    dt0 = dt._replace(rules=dt.rules[:, :0].contiguous())
    fields, words = torchpath.packet_fields(torchpath.device_batch(
        testing.random_batch_fast(rng, tables, 500), "cpu"))
    out = dense.dense_classify(fields, words, dt0)
    assert torch.equal(out, formulation(dt0, fields, words))
    assert (out[:, 0] == 0).all()
    assert torch.equal(out[:, 1], dense.dense_classify(fields, words, dt)[:, 1])


def test_odd_rule_width_is_padded_to_even():
    rng = np.random.default_rng(12)
    tables = testing.random_tables_fast(rng, 50, width=5)
    dt = dense.build_dense_tables(tables, "cpu")
    assert dt.rules.shape[1] == 6 and not dt.rules[:, 5].any()
    assert_formulation_matches(tables, testing.random_batch_fast(rng, tables, 400))


def _rows(rid: int, action: int = 1) -> np.ndarray:
    rows = np.zeros((4, 7), np.int32)
    rows[1] = [rid, 0, 0, 0, 0, 0, action]  # catch-all
    return rows


def test_formulation_ipv4_cap_zero_and_full_lengths():
    addr = bytes([203, 0, 113, 9])
    v6 = bytes.fromhex("20010db8000000000000000000000001")
    content = {
        LpmKey(32, 2, bytes(16)): _rows(1),                     # /0, ifindex only
        LpmKey(32 + 24, 2, addr + bytes(12)): _rows(2),          # /24
        LpmKey(32 + 32, 2, addr + bytes(12)): _rows(3),          # /32
        LpmKey(32 + 48, 2, addr + bytes([0, 0]) + bytes(10)): _rows(4),  # /48
        LpmKey(32 + 128, 2, v6): _rows(5),                      # /128
        LpmKey(32, 3, bytes(16)): _rows(6),                      # /0 on ifindex 3
    }
    tables = compile_tables_from_content(content, rule_width=4)
    batch = make_batch(
        src=["203.0.113.9", "203.0.113.9", "203.0.113.9", "cb00:7109::1", "2001:db8::1",
             "2001:db8::2", "10.0.0.1", "10.0.0.1"],
        proto=[6] * 8, ifindex=[2, 2, 2, 2, 2, 2, 3, 4], kind=[1, 3, 0, 2, 2, 2, 1, 1],
    )
    batch.ip_words[:3] = [0xCB007109, 0, 0, 0]
    out = assert_formulation_matches(tables, batch)
    mlen = tables.mask_len[out[:, 1].numpy()]
    # v4 -> the /32; KIND_OTHER and KIND_MALFORMED -> the /48; v6 /48, /128,
    # /0; ifindex 3 -> its /0; ifindex 4 -> nothing
    assert mlen[:6].tolist() == [32, 48, 48, 48, 128, 0]
    assert mlen[6] == 0 and out[7, 1] == -1


def test_formulation_duplicate_rows_first_index_wins():
    """Two rows with identical key, mask and length: the first one wins."""
    rng = np.random.default_rng(17)
    tables = testing.random_tables(rng, 30, ifindexes=(2,), width=4)
    for name in ("key_words", "mask_words", "mask_len", "rules"):
        arr = getattr(tables, name)
        arr[7] = arr[3]
        arr[20] = arr[3]
    batch = testing.random_batch_fast(rng, tables, 600)
    out = assert_formulation_matches(tables, batch)
    assert not np.isin(out[:, 1].numpy(), [7, 20]).any()
    hits = testing.random_batch_fast(np.random.default_rng(3), tables, 600)
    hits.ifindex[:] = 2
    hits.ip_words[:] = tables.key_words[3, 1:5]
    hits.kind[:] = 2 if tables.mask_len[3] > 32 else 1
    out = assert_formulation_matches(tables, hits)
    assert (tables.mask_len[out[:, 1].numpy()] >= tables.mask_len[3]).all()
    assert not np.isin(out[:, 1].numpy(), [7, 20]).any()


def test_formulation_padding_rows_and_empty_table():
    tables = compile_tables_from_content({}, rule_width=4)
    dt = dense.build_dense_tables(tables, "cpu")
    assert dt.order.shape == (0,) and dt.groups.shape == (0, 3)
    out = assert_formulation_matches(tables, testing.random_batch_fast(
        np.random.default_rng(1), tables, 50))
    assert (out[:, 1] == -1).all()


def test_group_table_check():
    """The wrapper's check of the host group table the kernel takes by
    value: sizes that cover ``order`` in whole groups, k-steps 1..5."""
    rng = np.random.default_rng(9)
    dt = dense.build_dense_tables(testing.random_tables_fast(rng, 300, v6_fraction=0.5), "cpu")
    Tk = dt.order.shape[0]
    assert dense._groups_fit(dt.groups, Tk)
    assert not dense._groups_fit(dt.groups, Tk + dense.N_TILE)
    for bad in (dt.groups.long(), dt.groups[:, :1].contiguous()):
        assert not dense._groups_fit(bad, Tk)
    for col, value in ((0, 4), (1, 6), (1, 0), (1, 32 | 2), (1, dense.FOLDED | 5)):
        broken = dt.groups.clone()
        broken[0, col] = value
        assert not dense._groups_fit(broken, int(broken[:, 0].sum()))
