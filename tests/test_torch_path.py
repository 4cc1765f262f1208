"""The port's wire and verdict layer (infw_torch.kernels.torchpath and the
wire packers of infw_torch.packets) against the JAX package's jaxpath and
packets functions.  Integers throughout: exact equality."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infw import packets as jax_packets
from infw import testing as jax_testing
from infw.kernels import jaxpath
from infw_torch import packets as port_packets
from infw_torch.kernels import torchpath

BATCH_FIELDS = (
    "kind", "l4_ok", "ifindex", "ip_words", "proto", "dst_port",
    "icmp_type", "icmp_code", "pkt_len",
)


def port_batch(batch):
    return port_packets.PacketBatch(**{f: getattr(batch, f) for f in BATCH_FIELDS})


def as_np(t):
    a = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return a.view(np.uint32) if a.dtype in (np.int32, np.uint32) else a


def jax_device_batch(db: torchpath.DeviceBatch):
    """The same columns as a JAX DeviceBatch (ip_words as uint32)."""
    cols = {f: jnp.asarray(getattr(db, f).numpy()) for f in BATCH_FIELDS}
    cols["ip_words"] = jnp.asarray(db.ip_words.numpy().view(np.uint32))
    return jaxpath.DeviceBatch(**cols)


def wire_batch(seed, v4_only, narrow):
    rng = np.random.default_rng(seed)
    tables = jax_testing.random_tables(rng, n_entries=20, width=8)
    b = jax_testing.random_batch(rng, tables, n_packets=257)
    if v4_only:
        b = b.take(np.nonzero(b.kind != 2)[0])
        b.ip_words[:, 1:] = 0
    # full-width formats carry 21-bit lengths and 32-bit ifindexes; the
    # narrow ones need both below 2^16
    hi = 1 << 16 if narrow else 1 << 21
    b.pkt_len[:] = rng.integers(0, hi, len(b))
    if not narrow:
        b.ifindex[::7] = rng.integers(1 << 16, 1 << 20, len(b.ifindex[::7]))
    b.icmp_type[:] = rng.integers(0, 256, len(b))
    return b


@pytest.mark.parametrize("width", [7, 4, 6, 3])
def test_unpack_wire_widths(width):
    b = wire_batch(width, v4_only=width in (3, 4), narrow=width in (3, 6))
    pb = port_batch(b)
    jw = b.pack_wire_v4() if width in (3, 4) else b.pack_wire()
    pw = pb.pack_wire_v4() if width in (3, 4) else pb.pack_wire()
    if width in (3, 6):
        jw, pw = jax_packets.narrow_wire(jw), port_packets.narrow_wire(pw)
    assert pw.shape[1] == width
    np.testing.assert_array_equal(pw, jw)  # the host packers agree bit for bit
    want = jaxpath.unpack_wire(jnp.asarray(jw))
    got = torchpath.unpack_wire(torch.from_numpy(pw.view(np.int32)))
    for f in BATCH_FIELDS:
        np.testing.assert_array_equal(as_np(getattr(got, f)), as_np(getattr(want, f)), err_msg=f)


def test_narrow_wire_refuses_wide_chunks():
    b = wire_batch(1, v4_only=False, narrow=False)
    pb = port_batch(b)
    assert port_packets.narrow_wire(pb.pack_wire()) is None
    assert jax_packets.narrow_wire(b.pack_wire()) is None


def random_verdict_batch(rng, n, pkt_len_max=1 << 21):
    kind = rng.choice([0, 1, 2, 3], size=n, p=[0.05, 0.5, 0.4, 0.05]).astype(np.int32)
    cols = dict(
        kind=kind,
        l4_ok=(rng.random(n) > 0.1).astype(np.int32),
        ifindex=rng.integers(0, 10, n).astype(np.int32),
        ip_words=rng.integers(0, 1 << 32, (n, 4), dtype=np.uint64).astype(np.uint32),
        proto=rng.choice([1, 6, 17, 58, 132, 0, 47], n).astype(np.int32),
        dst_port=rng.integers(0, 1 << 16, n).astype(np.int32),
        icmp_type=rng.integers(0, 256, n).astype(np.int32),
        icmp_code=rng.integers(0, 3, n).astype(np.int32),
        pkt_len=rng.integers(0, pkt_len_max, n).astype(np.int32),
    )
    return torchpath.device_batch(port_packets.PacketBatch(**cols), "cpu")


def random_results(rng, n):
    rid = rng.choice([0, 1, 5, 99, 127, 1023, 1024, 5000, (1 << 24) - 1], n)
    act = rng.integers(0, 4, n)
    return ((rid.astype(np.uint64) << 8) | act.astype(np.uint64)).astype(np.uint32)


def test_finalize_and_result_stats():
    rng = np.random.default_rng(4)
    db = random_verdict_batch(rng, 3000)
    res = random_results(rng, 3000)
    jr, jx, js = jaxpath.finalize(jnp.asarray(res), jax_device_batch(db))
    tr, tx, ts = torchpath.finalize(torch.from_numpy(res.view(np.int32)), db)
    np.testing.assert_array_equal(as_np(tr), np.asarray(jr))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts.dtype == torch.int32 and ts.shape == (1024, 6)


def test_result_stats_wraps_int32():
    """Enough maximum-length allow packets on one rule that the hi-byte
    column passes 2^31: the int32 segment sum wraps, and so must the port."""
    n = 300_000
    rng = np.random.default_rng(9)
    db = random_verdict_batch(rng, n)
    db = db._replace(
        kind=torch.ones(n, dtype=torch.int32),
        pkt_len=torch.full((n,), (1 << 21) - 1, dtype=torch.int32),
    )
    res = np.full(n, (5 << 8) | 2, np.uint32)
    want = np.asarray(jaxpath.result_stats(jnp.asarray(res), jax_device_batch(db)))
    got = torchpath.result_stats(torch.from_numpy(res.view(np.int32)), db).numpy()
    assert n * 8191 > 2**31 and want[5, 1] < 0  # the reference wrapped
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [0, 1, 2, 999])
def test_fuse_and_split_wire_outputs(n):
    rng = np.random.default_rng(n)
    res16 = rng.integers(0, 1 << 16, n).astype(np.uint16)
    res16[: min(n, 3)] = 0xFFFF  # the top bit must survive the int32 view
    stats = rng.integers(-(1 << 31), 1 << 31, (1024, 6), dtype=np.int64).astype(np.int32)
    want = np.asarray(jaxpath.fuse_wire_outputs(jnp.asarray(res16), jnp.asarray(stats)))
    got = torchpath.fuse_wire_outputs(
        torch.from_numpy(res16.astype(np.int32)), torch.from_numpy(stats)
    ).numpy()
    np.testing.assert_array_equal(got, want)
    jr, js = jaxpath.split_wire_outputs(want, n)
    tr, ts = torchpath.split_wire_outputs(got, n)
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tr, res16)
    np.testing.assert_array_equal(torchpath.merge_stats_host(ts), jaxpath.merge_stats_host(js))
    kind = rng.integers(0, 4, n).astype(np.int32)
    for a, b in zip(torchpath.host_finalize_wire(tr, kind), jaxpath.host_finalize_wire(jr, kind)):
        np.testing.assert_array_equal(a, b)


def test_rule_scan():
    rng = np.random.default_rng(12)
    n, R = 400, 12
    rows = np.stack([jax_testing.random_rules(rng, R) for _ in range(n)])
    rows[::9] = 0  # packets without an LPM match
    db = random_verdict_batch(rng, n)
    # steer some packets onto rule boundaries so every branch is hit
    pick = rows[np.arange(n), rng.integers(1, R, n)]
    db = db._replace(
        proto=torch.from_numpy(np.where(pick[:, 1] != 0, pick[:, 1], 47).astype(np.int32)),
        dst_port=torch.from_numpy((pick[:, 2] + rng.integers(-1, 2, n)).clip(0).astype(np.int32)),
        icmp_type=torch.from_numpy(pick[:, 4].astype(np.int32)),
        icmp_code=torch.from_numpy(pick[:, 5].astype(np.int32)),
    )
    want = np.asarray(jaxpath.rule_scan(jnp.asarray(rows), jax_device_batch(db)))
    got = torchpath.rule_scan(torch.from_numpy(rows), db)
    np.testing.assert_array_equal(as_np(got), want)
    assert (want != 0).sum() > n // 4
