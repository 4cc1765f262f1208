"""The port's dense kernel K1 (plain PyTorch version on the CPU) against the
JAX package's Pallas dense kernel in interpret mode.

All outputs are integers: every comparison is exact equality.  Inputs come
from numpy seeds through the JAX package's generators and are carried to
the port with infw_torch.convert.
"""
import jax
import numpy as np
import pytest
import torch

from infw import oracle as jax_oracle
from infw import testing as jax_testing
from infw.compiler import LpmKey, compile_tables_from_content
from infw.constants import KIND_OTHER
from infw.kernels import jaxpath, pallas_dense
from infw.packets import make_batch
from infw_torch import convert
from infw_torch import compiler as port_compiler
from infw_torch.kernels import dense, torchpath
from infw_torch.packets import PacketBatch

BATCH_FIELDS = (
    "kind", "l4_ok", "ifindex", "ip_words", "proto", "dst_port",
    "icmp_type", "icmp_code", "pkt_len",
)
_pallas_scan = jax.jit(pallas_dense._pallas_scan, static_argnums=(3, 4))


def to_port(tables):
    d = {f: getattr(tables, f) for f in convert.FIELDS}
    d["content"] = tables.content
    return convert.tables_from_jax_arrays(d)


def port_batch(batch):
    return PacketBatch(**{f: getattr(batch, f) for f in BATCH_FIELDS})


def kernel_operands(batch, block_b):
    """The Pallas kernel's (fields, words), padded with KIND_OTHER rows to
    the block as classify_pallas pads them."""
    fields = np.stack(
        [batch.kind, batch.ifindex, batch.proto, batch.dst_port, batch.icmp_type,
         batch.icmp_code, batch.l4_ok, batch.pkt_len], axis=1,
    ).astype(np.int32)
    words = np.asarray(batch.ip_words, np.uint32).view(np.int32)
    pad = -len(batch) % block_b
    if pad or not len(batch):
        pad = pad or block_b
        pf = np.zeros((pad, 8), np.int32)
        pf[:, 0] = KIND_OTHER
        fields = np.concatenate([fields, pf])
        words = np.concatenate([words, np.zeros((pad, 4), np.int32)])
    return fields, words


def assert_dense_matches(tables, batch, block_b=pallas_dense.BLOCK_B, check_oracle=True):
    """(results, xdp, stats) and the kernel's (result, tidx) of the port
    equal the Pallas path's; optionally also the oracle's verdicts."""
    pt = pallas_dense.build_pallas_tables(tables)
    jres, jxdp, jstats = pallas_dense.jitted_classify_pallas(True, block_b)(
        pt, jaxpath.device_batch(batch)
    )
    dt = dense.build_dense_tables(to_port(tables), "cpu")
    res, xdp, stats = dense.classify_dense(dt, torchpath.device_batch(port_batch(batch), "cpu"))
    np.testing.assert_array_equal(res.numpy().view(np.uint32), np.asarray(jres))
    np.testing.assert_array_equal(xdp.numpy(), np.asarray(jxdp))
    np.testing.assert_array_equal(stats.numpy(), np.asarray(jstats))

    fields, words = kernel_operands(batch, block_b)
    want = np.asarray(_pallas_scan(fields, words, pt, True, block_b))[: len(batch)]
    got = dense.dense_classify(torch.from_numpy(fields), torch.from_numpy(words), dt)
    np.testing.assert_array_equal(got.numpy()[: len(batch)], want)  # result and tidx
    if check_oracle:
        ref = jax_oracle.classify(tables, batch)
        np.testing.assert_array_equal(res.numpy().view(np.uint32), ref.results)
        np.testing.assert_array_equal(xdp.numpy(), ref.xdp)
    return got.numpy()[: len(batch)]


@pytest.mark.parametrize("seed", [0, 5])
def test_dense_random_differential(seed):
    rng = np.random.default_rng(seed)
    tables = jax_testing.random_tables(rng, n_entries=40, width=12)
    batch = jax_testing.random_batch(rng, tables, n_packets=300)
    out = assert_dense_matches(tables, batch)
    assert (out[:, 1] >= 0).sum() > 50  # the batch really exercises LPM hits


def test_dense_non_block_multiple_batch():
    rng = np.random.default_rng(3)
    tables = jax_testing.random_tables(rng, n_entries=10, width=8)
    batch = jax_testing.random_batch(rng, tables, n_packets=77)
    assert_dense_matches(tables, batch)


def test_dense_empty_table():
    tables = compile_tables_from_content({}, rule_width=4)
    batch = jax_testing.random_batch(np.random.default_rng(7), tables, n_packets=50)
    out = assert_dense_matches(tables, batch)
    assert (out[:, 1] == -1).all()


def test_dense_full_rule_width():
    # All 100 rule slots populated (the reference's MAX_RULES_PER_TARGET).
    rows = np.zeros((100, 7), np.int32)
    for order in range(1, 100):
        rows[order] = [order, 6, order * 100, 0, 0, 0, 1 + order % 2]
    tables = compile_tables_from_content({LpmKey(32, 2, bytes(16)): rows}, rule_width=100)
    batch = make_batch(
        src=["1.1.1.1"] * 4, proto=[6] * 4, dst_port=[100, 5000, 9900, 77], ifindex=[2] * 4,
    )
    out = assert_dense_matches(tables, batch)
    assert [int(r) >> 8 for r in out[:, 0]] == [1, 50, 99, 0]


def test_dense_out_of_range_content_is_byte_masked():
    """Direct table content may carry values the CR path never produces:
    actions outside {1, 2} are clipped, protocol and ICMP fields masked to
    a byte and ports to 16 bits, exactly as the TPU packing does."""
    rows = np.zeros((8, 7), np.int32)
    rows[1] = [1, 6 + 256, 70000, 0, 0, 0, 0]          # proto 262 -> 6, port -> 4464, act 0 -> 1
    rows[2] = [2, 17, 1000, 2000 + 65536, 0, 0, 7]     # act 7 -> 2, end -> 2000
    rows[3] = [3, 1, 0, 0, 300, 2 + 512, -1]           # icmp 300 -> 44, code -> 2, act -1 -> 1
    rows[4] = [4, 58 + 256 * 3, 0, 0, 128, 0, 3]       # proto -> 58
    rows[5] = [5, 0, 0, 0, 0, 0, 2]                    # catch-all
    tables = compile_tables_from_content({LpmKey(40, 2, bytes([10]) + bytes(15)): rows},
                                         rule_width=8)
    batch = make_batch(
        src=["10.0.0.1", "10.0.0.2", "10.0.0.3", "10.0.0.4", "10.1.0.5", "10.1.0.6"],
        proto=[6, 17, 1, 1, 58, 47],
        dst_port=[4464, 1500, 0, 0, 0, 0],
        icmp_type=[0, 0, 44, 300, 128, 0],
        icmp_code=[0, 0, 2, 2, 0, 0],
        ifindex=[2] * 6,
        kind=[1, 1, 1, 1, 2, 1],
    )
    out = assert_dense_matches(tables, batch, check_oracle=False)
    assert [int(r) for r in out[:, 0]] == [
        (1 << 8) | 1, (2 << 8) | 2, (3 << 8) | 1, (5 << 8) | 2, (4 << 8) | 2, (5 << 8) | 2,
    ]


def test_dense_cross_family_zero_prefix():
    """A v4 /0 entry has an all-zero mask beyond the ifindex, so it also
    matches IPv6 packets on that interface (the reference's LPM key space
    has no family bit)."""
    rows = np.zeros((4, 7), np.int32)
    rows[1] = [1, 0, 0, 0, 0, 0, 1]  # catch-all deny
    content = {LpmKey(32, 2, bytes([192, 0, 2, 1]) + bytes(12)): rows}
    tables = compile_tables_from_content(content, rule_width=4)
    batch = make_batch(
        src=["2001:db8::1", "198.51.100.7", "2001:db8::2"], proto=[6, 17, 6],
        ifindex=[2, 2, 3],
    )
    out = assert_dense_matches(tables, batch)
    assert out[:, 1].tolist() == [0, 0, -1]


def test_dense_ipv4_prefix_cap_and_non_ip_kinds():
    """IPv4 packets cannot match entries longer than /32; every other kind
    (IPv6, KIND_OTHER, KIND_MALFORMED) is capped at /128, and the kernel's
    tidx must agree for those packets too even though finalize drops
    their verdicts."""
    rows = np.zeros((4, 7), np.int32)
    rows[1] = [1, 0, 0, 0, 0, 0, 2]
    addr = bytes([203, 0, 113, 9])
    content = {
        LpmKey(32 + 24, 2, addr + bytes(12)): rows,                  # /24
        LpmKey(32 + 32, 2, addr + bytes(12)): rows * 1,              # /32
        LpmKey(32 + 48, 2, addr + bytes([0, 0]) + bytes(10)): rows,  # /48
    }
    tables = compile_tables_from_content(content, rule_width=4)
    src = ["203.0.113.9", "203.0.113.9", "203.0.113.9", "cb00:7109::1"]
    batch = make_batch(src=src, proto=[6] * 4, ifindex=[2] * 4, kind=[1, 3, 0, 2])
    batch.ip_words[:3] = [0xCB007109, 0, 0, 0]
    out = assert_dense_matches(tables, batch)
    # v4 -> the /32; KIND_OTHER and KIND_MALFORMED (cap 128) -> the /48;
    # the v6 packet cb00:7109:: shares the /48's 48 bits
    assert out[:, 1].tolist() == [1, 2, 2, 2]


def test_dense_tombstoned_rows_never_match():
    rng = np.random.default_rng(11)
    tables = jax_testing.random_tables(rng, n_entries=12, width=6)
    tables.mask_len[::3] = -1  # deleted rows keep their slot as padding
    batch = jax_testing.random_batch(rng, tables, n_packets=120)
    out = assert_dense_matches(tables, batch, check_oracle=False)
    assert not np.isin(out[:, 1], np.arange(0, 12, 3)).any()


def _oversized(t):
    t.mask_len.resize(5000, refcheck=False)  # simulate huge T
    object.__setattr__(t, "num_entries", 5000)
    return t


def _wide_rule_ids(lpm_key):
    rows = np.zeros((4, 7), np.int32)
    rows[1] = [200, 6, 80, 0, 0, 0, 1]
    return {lpm_key(40, 2, bytes(16)): rows}, 4


def _wide_width(lpm_key):
    rows = np.zeros((130, 7), np.int32)
    rows[1] = [1, 6, 80, 0, 0, 0, 1]
    return {lpm_key(40, 2, bytes(16)): rows}, 130


@pytest.mark.parametrize("case", ["entries", "rule_id", "rule_width"])
def test_dense_eligibility_errors(case):
    """The port's packing refuses exactly what the TPU packing refuses."""
    if case == "entries":
        rng = np.random.default_rng(0)
        jt = _oversized(jax_testing.random_tables(rng, n_entries=20, width=4))
        pt = _oversized(to_port(jax_testing.random_tables(np.random.default_rng(0), 20, width=4)))
        match = "targets"
    else:
        make = _wide_rule_ids if case == "rule_id" else _wide_width
        content, width = make(LpmKey)
        jt = compile_tables_from_content(content, rule_width=width)
        pcontent, _ = make(port_compiler.LpmKey)
        pt = port_compiler.compile_tables_from_content(pcontent, rule_width=width)
        match = "ruleId"
    with pytest.raises(ValueError, match=match):
        pallas_dense.build_pallas_tables(jt)
    with pytest.raises(ValueError, match=match):
        dense.build_dense_tables(pt, "cpu")
