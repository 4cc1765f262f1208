"""The port's wire codecs on the CPU against the JAX package: the host codec
(wire8, varint_encode, encode_delta_wire, decode_delta_host) byte for byte,
the device decode (decode_delta, the varint scatter, K4's plain version
against the Pallas scan in interpret mode), unpack_wire8, the host-derived
statistics, and TorchClassifier's codec paths against TpuClassifier,
wire_stats() included.  Every comparison is exact (integers, tolerance 0);
corpora come from numpy seeds."""
import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from infw import packets as jax_packets
from infw import testing as jax_testing
from infw.backend.tpu import TpuClassifier
from infw.daemon import stats_from_results as jax_stats_from_results
from infw.kernels import jaxpath
from infw.kernels import wire_decode as jax_wire_decode
from infw_torch import oracle, packets
from infw_torch.backend.base import stats_from_results
from infw_torch.backend.cuda import TorchClassifier
from infw_torch.kernels import torchpath, wire_decode
from test_torch_walk import _compile_pair, _hazard_content, port_batch

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

TCP_META = 1 | (1 << 2) | (6 << 3)  # kind IPv4, l4_ok, TCP


def _rows(n, ip, meta=TCP_META, ifx=2, w1=80):
    w = np.zeros((n, 4), np.uint32)
    w[:, 0], w[:, 1], w[:, 2], w[:, 3] = meta, w1, ifx, ip
    return w


def _clustered(seed, n, hi, start=0):
    """IPs whose sorted deltas (the first one absolute) stay below ``hi``,
    shuffled; one meta value (dict_mode 0)."""
    rng = np.random.default_rng(seed)
    ip = (start + np.cumsum(rng.integers(0, hi, n))).astype(np.uint32)
    return _rows(n, rng.permutation(ip))


def _mixed_meta(seed, n, n_meta, ifindexes=(2, 3, 9), spread=2**32):
    """n_meta distinct (kind, l4_ok, proto, ifindex) values, the ICMPs
    among them (the l4 word carries type/code), pkt_len over 16 bits on
    some rows (w0's high stash), IPs over ``spread``."""
    rng = np.random.default_rng(seed)
    protos = np.array([6, 17, 132, 1, 58, 47, 0, 2, 41, 50])
    combos = [(k, l, p, f) for p in protos for f in ifindexes for k in (1, 0, 3) for l in (1, 0)]
    pick = np.asarray(combos)[rng.permutation(len(combos))[:n_meta]]
    row = pick[rng.integers(0, n_meta, n)]
    plen = rng.integers(60, 1 << 21, n).astype(np.uint32)
    w = np.zeros((n, 4), np.uint32)
    w[:, 0] = (row[:, 0] | (row[:, 1] << 2) | (row[:, 2] << 3)
               | (rng.integers(0, 256, n) << 11) | (rng.integers(0, 256, n) << 19)
               | ((plen >> 16) << 27)).astype(np.uint32)
    w[:, 1] = (rng.integers(0, 65536, n) | ((plen & 0xFFFF) << 16)).astype(np.uint32)
    w[:, 2] = row[:, 3]
    w[:, 3] = rng.integers(0, spread, n, dtype=np.uint64).astype(np.uint32)
    return w


def _table_chunk():
    """The v4-compact chunk of a seeded random_batch_fast batch."""
    rng = np.random.default_rng(17)
    t = jax_testing.random_tables_fast(rng, 3000, width=4, v6_fraction=0.0, ifindexes=(2, 3, 9))
    b = jax_testing.random_batch_fast(rng, t, 3000)
    v4 = b.take(np.nonzero(b.kind != 2)[0])
    v4.ip_words[:, 1:] = 0
    return v4.pack_wire_v4()


def _fixed4():
    """Every sorted delta (the first too) needs 4 varint bytes: the 4-byte
    stride costs no more."""
    rng = np.random.default_rng(5)
    ip = (np.uint64(1 << 22) + np.cumsum(rng.integers(1 << 21, 1 << 25, 101))).astype(np.uint32)
    return _rows(101, rng.permutation(ip))


CORPORA = {
    "table_chunk": _table_chunk,
    "varint_dict2": lambda: _mixed_meta(1, 5001, 150),
    "varint_dict1_odd": lambda: _mixed_meta(2, 777, 9),
    "fixed1_dict0": lambda: _clustered(3, 3000, 200),
    "fixed2_dict0": lambda: _clustered(4, 3001, 60000),
    "fixed2_dict1": lambda: np.concatenate([_mixed_meta(6, 999, 12)[:, :3],
                                            _clustered(6, 999, 60000)[:, 3:]], axis=1),
    "fixed4": _fixed4,
    "one_packet": lambda: _rows(1, [0x0A000001]),
    "max_delta": lambda: _rows(2, [0xFFFFFFFF, 0]),
    "duplicate_ips": lambda: _rows(50, [7] * 50),
    "sixteen_ifindexes": lambda: _rows(64, np.arange(64) * 977, ifx=np.arange(64) % 16 + 2),
    "fifteen_ifindexes": lambda: _rows(64, np.arange(64) * 977, ifx=np.arange(64) % 15 + 2),
    "meta_over_256": lambda: _mixed_meta(7, 4000, 300, ifindexes=tuple(range(2, 17))),
    "uncompressible": lambda: _mixed_meta(8, 60, 60),
}


@pytest.fixture(scope="module")
def encoded():
    """Each corpus's wire and both packages' encodings (None where the
    chunk does not qualify)."""
    out = {}
    for name, make in CORPORA.items():
        w = np.ascontiguousarray(make(), np.uint32)
        out[name] = (w, jax_packets.encode_delta_wire(w), packets.encode_delta_wire(w))
    return out


def _assert_same_encoding(got, want):
    assert (got is None) == (want is None)
    if got is None:
        return
    for f in ("payload", "dict_vals", "ifmap", "perm"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in ("n", "dict_mode", "fixed_w", "crc"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_encoders_match_jax(encoded, name):
    """wire8, encode_delta_wire unconstrained and under the auto gate's
    8 B/packet and 4 B/packet budgets, field by field."""
    w, jenc, penc = encoded[name]
    _assert_same_encoding(penc, jenc)
    for budget in (8.0, 4.0):
        _assert_same_encoding(packets.encode_delta_wire(w, budget),
                              jax_packets.encode_delta_wire(w, budget))
    j8, p8 = jax_packets.wire8(w), packets.wire8(w)
    assert (j8 is None) == (p8 is None)
    if p8 is not None:
        for a, b in zip(p8, j8):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    np.testing.assert_array_equal(packets.narrow_wire(w), jax_packets.narrow_wire(w))


def test_corpora_cover_every_plan(encoded):
    """The corpora reach every fixed stride, every dictionary mode, both
    refusals and the auto gate's refusal."""
    plans = {(e.fixed_w, e.dict_mode) for _, _, e in encoded.values() if e is not None}
    assert {w for w, _ in plans} == {0, 1, 2, 4} and {d for _, d in plans} == {0, 1, 2}
    assert encoded["sixteen_ifindexes"][2] is None and packets.wire8(encoded["sixteen_ifindexes"][0]) is None
    assert encoded["fifteen_ifindexes"][2] is not None
    assert encoded["meta_over_256"][2] is None and packets.wire8(encoded["meta_over_256"][0]) is not None
    w = encoded["uncompressible"][0]
    assert packets.encode_delta_wire(w) is not None and packets.encode_delta_wire(w, 4.0) is None
    assert encoded["varint_dict1_odd"][2].n % 2 == 1
    assert packets.encode_delta_wire(np.zeros((0, 4), np.uint32)) is None
    assert packets.encode_delta_wire(np.zeros((4, 7), np.uint32)) is None
    assert packets.wire8(np.zeros((4, 7), np.uint32)) is None


@pytest.mark.parametrize("vals", [
    [0], [127], [128], [0xFFFFFFFF], [1 << 7, 1 << 14, 1 << 21, 1 << 28, (1 << 28) - 1, 5],
    list(range(0, 1 << 32, 99991 * 4099)),
])
def test_varint_encode_matches_jax(vals):
    v = np.asarray(vals, np.uint64)
    np.testing.assert_array_equal(packets.varint_encode(v), jax_packets.varint_encode(v))


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_decode_delta_host_matches_jax(encoded, name):
    _w, jenc, penc = encoded[name]
    if penc is None:
        return
    got, want = packets.decode_delta_host(penc), jax_packets.decode_delta_host(jenc)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    np.testing.assert_array_equal(got[7], np.sort(_w[:, 3]))


def _corruptions(enc, rng):
    """The fail-closed cases of tests/test_wire_codec.py: bit flips, cuts,
    an extension, and (crc fixed up) a dangling continuation, a split
    value, a run over 5 bytes, an out-of-range dictionary index and a
    delta sum past 2^32."""
    crc = jax_packets._delta_crc
    off_b, off_c = jax_packets.delta_section_offsets(enc.n, enc.dict_mode)
    out = []
    for i in rng.choice(len(enc.payload), size=24, replace=False):
        e = copy.deepcopy(enc)
        e.payload[int(i)] ^= 1 << int(rng.integers(8))
        out.append(e)
    for cut in (1, 3, len(enc.payload) // 2):
        e = copy.deepcopy(enc)
        e.payload = e.payload[:-cut]
        out.append(e)
    e = copy.deepcopy(enc)
    e.payload = np.concatenate([e.payload, np.zeros(4, np.uint8)])
    out.append(e)

    def fixed(edit):
        e = copy.deepcopy(enc)
        edit(e)
        e.crc = crc(e.payload, e.dict_vals, e.ifmap)
        out.append(e)

    fixed(lambda e: e.payload.__setitem__(-1, e.payload[-1] | 0x80))
    cont = np.nonzero(enc.payload[off_c:] & 0x80)[0]
    fixed(lambda e: e.payload.__setitem__(off_c + cont[0], e.payload[off_c + cont[0]] & 0x7F))

    def long_run(e):
        e.payload = np.concatenate([e.payload[:off_c], np.full(6, 0xFF, np.uint8),
                                    np.zeros(1, np.uint8), e.payload[off_c:]])

    fixed(long_run)

    def bad_index(e):
        e.payload[0] = 0xFF
        e.dict_vals = e.dict_vals[:4]

    fixed(bad_index)
    big = jax_packets.varint_encode(np.array([0xFFFFFFFF, 2], np.uint64))
    wrap = jax_packets.DeltaWire(
        payload=np.concatenate([np.zeros(jax_packets.delta_section_offsets(2, 0)[1], np.uint8), big]),
        dict_vals=np.array([TCP_META], np.uint32), ifmap=np.full(16, -1, np.int32),
        perm=np.arange(2, dtype=np.int64), n=2, dict_mode=0, fixed_w=0, crc=0)
    wrap.crc = crc(wrap.payload, wrap.dict_vals, wrap.ifmap)
    out.append(wrap)
    return out


def test_decode_delta_host_fails_closed_like_jax(encoded):
    enc = encoded["varint_dict2"][1]
    assert enc.fixed_w == 0 and enc.dict_mode == 2
    cases = _corruptions(enc, np.random.default_rng(43))
    for e in cases:
        with pytest.raises(jax_packets.DeltaDecodeError) as jerr:
            jax_packets.decode_delta_host(e)
        pe = packets.DeltaWire(**{f: copy.deepcopy(getattr(e, f)) for f in (
            "payload", "dict_vals", "ifmap", "perm", "n", "dict_mode", "fixed_w", "crc")})
        with pytest.raises(packets.DeltaDecodeError) as perr:
            packets.decode_delta_host(pe)
        assert str(perr.value) == str(jerr.value)
    assert issubclass(packets.DeltaDecodeError, ValueError) and len(cases) > 30


def test_payload_bucket_and_padding_match_jax():
    for n in list(range(0, 600, 7)) + [1023, 1024, 1025, 4097, 99999, (1 << 20) + 3]:
        assert wire_decode.payload_bucket(n) == jax_wire_decode.payload_bucket(n), n
    p = np.arange(300, dtype=np.uint8)
    np.testing.assert_array_equal(wire_decode.pad_payload(p), jax_wire_decode.pad_payload(p))
    d = np.array([5, 9, 0x7FFF], np.uint32)
    np.testing.assert_array_equal(wire_decode.pad_dict(d), jax_wire_decode.pad_dict(d))


def _port_decode(enc):
    return wire_decode.decode_delta(
        torch.from_numpy(wire_decode.pad_payload(enc.payload)),
        torch.from_numpy(wire_decode.pad_dict(enc.dict_vals).view(np.int32)),
        torch.from_numpy(enc.ifmap), n=enc.n, dict_mode=enc.dict_mode, fixed_w=enc.fixed_w)


def _jax_decode(enc, use_pallas):
    return jax_wire_decode.decode_delta(
        jnp.asarray(jax_wire_decode.pad_payload(enc.payload)),
        jnp.asarray(jax_wire_decode.pad_dict(enc.dict_vals)), jnp.asarray(enc.ifmap),
        n=enc.n, dict_mode=enc.dict_mode, fixed_w=enc.fixed_w, use_pallas=use_pallas,
        interpret=True)


@pytest.mark.parametrize("name", ["table_chunk", "varint_dict1_odd", "fixed1_dict0",
                                  "fixed2_dict1", "fixed4", "max_delta"])
def test_decode_delta_matches_jax(encoded, name):
    """decode_delta on the CPU against the XLA decode and, for the
    fixed-stride plans, the Pallas scan in interpret mode."""
    enc = encoded[name][2]
    got = _port_decode(enc)
    for use_pallas in (False, True) if enc.fixed_w else (False,):
        want = _jax_decode(encoded[name][1], use_pallas)
        for f in torchpath.DeviceBatch._fields:
            a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
            assert a.dtype == np.int32 and a.shape == b.shape, f
            np.testing.assert_array_equal(a.view(b.dtype) if b.dtype == np.uint32 else a, b,
                                          err_msg=f"{f} pallas={use_pallas}")


@pytest.mark.parametrize("seed,length,n", [(1, 3000, 600), (2, 3000, 2000), (3, 257, 257),
                                           (4, 50, 1), (5, 4096, 3000)])
def test_varint_scatter_matches_jax_on_any_bytes(seed, length, n):
    """Random bytes (runs of continuation bytes over 5, values past 32 bits,
    fewer or more values than n): the index add drops values >= n, clamps
    the shift at 4 and wraps, as the XLA scatter-add with mode="drop"."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 256, length).astype(np.uint8)
    c[rng.random(length) < 0.3] |= 0x80
    got = wire_decode._decode_varint_deltas(torch.from_numpy(c), n).numpy()
    want = np.asarray(jax_wire_decode._decode_varint_deltas(jnp.asarray(c), n))
    np.testing.assert_array_equal(got.view(np.uint32), want)


@pytest.mark.parametrize("fixed_w", [1, 2, 4])
@pytest.mark.parametrize("n", [1, 1024, 1025, 2500])
def test_decode_scan_plain_matches_pallas_interpret(fixed_w, n):
    """K4's plain version (and its wrapper on a CPU tensor, from an odd
    byte offset) against pallas_decode_fixed in interpret mode; at width 4
    the sums wrap past 2^32."""
    rng = np.random.default_rng(fixed_w * 10000 + n)
    buf = rng.integers(0, 256, n * fixed_w + 3).astype(np.uint8)
    c = torch.from_numpy(buf)[1:]
    got = wire_decode.decode_scan_plain(c, n, fixed_w)
    assert got.dtype == torch.int32 and got.shape == (n,)
    assert torch.equal(wire_decode.decode_scan(c, n, fixed_w), got)
    want = np.asarray(jax_wire_decode.pallas_decode_fixed(jnp.asarray(buf[1:]), n, fixed_w,
                                                          interpret=True))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    if fixed_w == 4 and n > 1:
        assert int(wire_decode._decode_fixed_deltas(c, n, fixed_w).sum()) >= 2**32


def test_decode_scan_rejects_bad_operands():
    c = torch.zeros(16, dtype=torch.uint8)
    for bad in ((c.to(torch.int32), 4, 1), (c, 4, 3), (c, 17, 1), (c, 5, 4), (c.view(2, 8), 2, 1)):
        with pytest.raises(ValueError):
            wire_decode.decode_scan(*bad)
    assert wire_decode.decode_scan(c, 0, 4).shape == (0,)


def test_unpack_wire8_matches_jax():
    rng = np.random.default_rng(11)
    wire = rng.integers(0, 2**32, (4000, 2), dtype=np.uint64).astype(np.uint32)
    wire[::3, 0] = (wire[::3, 0] & ~np.uint32(0xFF << 3)) | (np.uint32(1) << 3)   # ICMP
    wire[1::3, 0] = (wire[1::3, 0] & ~np.uint32(0xFF << 3)) | (np.uint32(58) << 3)  # ICMPv6
    ifmap = np.full(16, -1, np.int32)
    ifmap[:11] = rng.integers(0, 70000, 11)
    got = torchpath.unpack_wire8(torch.from_numpy(wire.view(np.int32)), torch.from_numpy(ifmap))
    want = jaxpath.unpack_wire8(jnp.asarray(wire), jnp.asarray(ifmap))
    for f in torchpath.DeviceBatch._fields:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(a.view(b.dtype) if b.dtype == np.uint32 else a, b, err_msg=f)


def test_stats_from_results_matches_jax():
    rng = np.random.default_rng(12)
    results = (rng.integers(0, 1300, 20000).astype(np.uint32) << 8) | rng.integers(0, 4, 20000)
    pkt_len = rng.integers(0, 1 << 21, 20000)
    got = stats_from_results(results.astype(np.uint32), pkt_len)
    want = jax_stats_from_results(results.astype(np.uint32), pkt_len)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert got[:, 0].sum() > 3000 and got[:, 2].sum() > 3000


# --- TorchClassifier against TpuClassifier -----------------------------------


@pytest.fixture(scope="module")
def tables():
    """The hazard table (actions 0 and 3, v4 /0 entries) and a mixed batch
    whose IPv4 rows honour the compact wire's contract (zero high words),
    with out-of-LUT ifindexes on a slice."""
    jt, pt = _compile_pair(_hazard_content(61, 2500))
    batch = jax_testing.random_batch_fast(np.random.default_rng(62), jt, 4000)
    batch.ifindex[::97] = 4000
    batch.ip_words[batch.kind != 2, 1:] = 0
    batch.pkt_len[::7] = 70000  # over 16 bits: the narrow wire cannot take these rows
    return jt, pt, batch


def _chunks(batch):
    """(name, batch, positions) of the packed chunks: the IPv4 chunk (the
    varint plan), two clustered chunks near 0.0.0.0 (the 1- and 2-byte
    fixed strides; the table's v4 /0 entries match them), one of three
    packets (too small for the auto gate), the IPv6 chunk (7 words) and an
    empty one."""
    rng = np.random.default_rng(63)
    v4 = np.nonzero(batch.kind == 1)[0]
    out = [("v4", batch, np.nonzero(batch.kind != 2)[0])]
    for name, hi in (("fixed 1", 200), ("fixed 2", 60000)):
        sub = batch.take(v4[:600])
        sub.ip_words[:, 0] = rng.permutation(np.cumsum(rng.integers(0, hi, 600))).astype(np.uint32)
        out.append((name, sub, np.arange(600)))
    out += [("three", batch, v4[:3]), ("v6", batch, np.nonzero(batch.kind == 2)[0]),
            ("empty", batch, v4[:0])]
    return out


@pytest.mark.parametrize("path", ["trie", "ctrie"])
@pytest.mark.parametrize("codec", ["auto", "wire8", "delta"])
def test_classifier_codecs_match_tpu_classifier(tables, path, codec):
    """Results, XDP verdicts, statistics and wire_stats() of every chunk, and
    of classify on an IPv4-compact batch, against TpuClassifier with the same
    codec; each chunk against the port's oracle too, and the accumulated
    statistics against the sum of the increments."""
    jt, pt, batch = tables
    jclf = TpuClassifier(force_path=path, wire_codec=codec, interpret=True, fused_deep=True)
    jclf.load_tables(jt)
    clf = TorchClassifier(device="cpu", force_path=path, wire_codec=codec)
    clf.load_tables(pt)
    assert clf.active_path == jclf.active_path == path
    total = np.zeros((1024, 4), np.int64)
    for name, jb, idx in _chunks(batch):
        pb = port_batch(jb)
        jw, jv4 = jb.pack_wire_subset(idx)
        wire, v4 = pb.pack_wire_subset(idx)
        if name.startswith("fixed"):
            enc = packets.encode_delta_wire(wire)
            assert enc.fixed_w == int(name[-1]) and enc.dict_mode > 0, name
        o = clf.classify_async_packed(wire, v4).result()
        if name == "empty":  # the JAX package's XLA walk cannot take a 0-packet wire
            assert o.results.shape == o.xdp.shape == (0,) and not o.stats_delta.any()
            continue
        jo = jclf.classify_async_packed(jw, jv4, apply_stats=False).result()
        for f in ("results", "xdp", "stats_delta"):
            np.testing.assert_array_equal(getattr(o, f), getattr(jo, f), err_msg=f"{name} {f}")
        ref = oracle.classify(pt, pb.take(idx))
        np.testing.assert_array_equal(o.results, ref.results, err_msg=name)
        np.testing.assert_array_equal(o.xdp, ref.xdp, err_msg=name)
        assert {r: list(v) for r, v in enumerate(o.stats_delta.tolist()) if any(v)} == ref.stats
        total += o.stats_delta
    sub = batch.take(np.nonzero(batch.kind != 2)[0])  # the "v4" chunk, through classify
    jo, o = jclf.classify(sub, apply_stats=False), clf.classify(port_batch(sub))
    for f in ("results", "xdp", "stats_delta"):
        np.testing.assert_array_equal(getattr(o, f), getattr(jo, f), err_msg=f"classify {f}")
    np.testing.assert_array_equal(clf.stats.snapshot(), total + o.stats_delta)
    stats = clf.wire_stats()
    assert stats.pop("wire3") == (0, 0)  # the empty chunk
    assert stats == jclf.wire_stats()
    assert stats["wire7"][0] == (batch.kind == 2).sum()
    n4 = (batch.kind != 2).sum() + 2 * 600 + 3 + len(sub)
    assert sum(stats.get(k, (0, 0))[0] for k in ("delta", "wire8")) == n4
    if codec == "wire8":
        assert "delta" not in stats and stats["wire8"][1] == 8 * n4 + 64 * 5
    elif codec == "delta":
        assert "wire8" not in stats
    else:
        assert stats["delta"][0] > 0 and stats["wire8"][0] > 0
    jclf.close()


def test_wire_codec_knob_precedence(monkeypatch):
    """The argument beats INFW_WIRE_CODEC beats "auto"; an unknown codec
    raises, from either source."""
    monkeypatch.delenv("INFW_WIRE_CODEC", raising=False)
    assert TorchClassifier(device="cpu")._wire_codec == "auto"
    monkeypatch.setenv("INFW_WIRE_CODEC", "wire8")
    assert TorchClassifier(device="cpu")._wire_codec == "wire8"
    assert TorchClassifier(device="cpu", wire_codec="delta")._wire_codec == "delta"
    monkeypatch.setenv("INFW_WIRE_CODEC", "")
    assert TorchClassifier(device="cpu")._wire_codec == "auto"
    with pytest.raises(ValueError, match="wire codec"):
        TorchClassifier(device="cpu", wire_codec="zstd")
    monkeypatch.setenv("INFW_WIRE_CODEC", "zstd")
    with pytest.raises(ValueError, match="wire codec"):
        TorchClassifier(device="cpu")


def test_dense_path_keeps_the_narrow_wire():
    """The codecs apply to the trie and ctrie paths only."""
    from infw_torch import testing

    rng = np.random.default_rng(64)
    small = testing.random_tables(rng, 300, width=6)
    batch = testing.random_batch_fast(rng, small, 3000)
    sub = batch.take(np.nonzero(batch.kind == 1)[0])
    clf = TorchClassifier(device="cpu", wire_codec="delta")
    clf.load_tables(small)
    assert clf.active_path == "dense"
    out = clf.classify(sub)
    assert clf.wire_stats() == {"wire3": (len(sub), 12 * len(sub))}
    ref = oracle.classify(small, sub)
    np.testing.assert_array_equal(out.results, ref.results)
    assert (out.results != 0).sum() > 100
