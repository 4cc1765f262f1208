"""The trie and ctrie walks on the port's depth-adversarial tables and
batches (infw_torch.testing.depth_adversarial: a /128 chain per ifindex;
every packet at full depth, deep and root-only packets alternating lane by
lane, one deep packet per 32, every packet leaving at the root), on the CPU
against the JAX package: K2's and K3's plain versions against the XLA trie
and ctrie paths and the Pallas K2 and K3 in interpret mode, and
TorchClassifier(force_path="trie"|"ctrie") against TpuClassifier, bit for
bit; and ``walk_depths`` against a per-packet numpy replay of the kernels'
loops and against each construction's known depth.  Every comparison is
exact (integers, tolerance 0)."""
import numpy as np
import pytest

from infw import compiler as jax_compiler
from infw.backend.tpu import TpuClassifier
from infw.kernels import jaxpath, pallas_walk
from infw.packets import PacketBatch as JaxPacketBatch
from infw_torch import testing
from infw_torch.backend.cuda import TorchClassifier
from infw_torch.kernels import cwalk, torchpath, walk
from test_torch_walk import BATCH_FIELDS

PATTERNS = testing.DEPTH_PATTERNS
N_PACKETS = 320


@pytest.fixture(scope="module", params=PATTERNS)
def case(request):
    """One pattern's port tables, batch and deep mask (the same table for
    every pattern: seed 0 draws it first), the JAX tables and batch, the
    port's padded K2 and K3 layouts and the batch's fields and words."""
    pt, pb, deep = testing.depth_adversarial(np.random.default_rng(0), N_PACKETS, request.param)
    jt = jax_compiler.compile_tables_from_content(
        {jax_compiler.LpmKey(*k): v for k, v in pt.content.items()}, rule_width=pt.rule_width)
    fields, words = torchpath.packet_fields(torchpath.device_batch(pb, "cpu"))
    return {
        "pattern": request.param, "pt": pt, "pb": pb, "deep": deep, "jt": jt,
        "jb": JaxPacketBatch(**{f: getattr(pb, f) for f in BATCH_FIELDS}),
        "tt": walk.build_trie_tables(pt, "cpu", pad=True),
        "ct": cwalk.build_ctrie_tables(pt, "cpu", pad=True),
        "fields": fields, "words": words,
    }


def _popc(x: int) -> int:
    return bin(x & 0xFFFFFFFF).count("1")


def _i32(x: int) -> int:
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= 1 << 31 else x


def _entry(root_lut, l0, ifx: int, w0: int):
    """(alive, node) after the DIR-16 root slot, as both kernels enter."""
    root = int(root_lut[ifx]) if 0 <= ifx < len(root_lut) else 0
    e0 = root * 65536 + (w0 >> 16)
    if not 0 <= e0 < len(l0):
        return False, 0
    return int(l0[e0, 0]) > 0, int(l0[e0, 0]) - 1


def replay_k2_rows(fields, words, tt, n_levels) -> np.ndarray:
    """K2's level loop replayed packet by packet in numpy: the deep node
    rows each walk reads."""
    f, w = fields.numpy(), words.numpy().view(np.uint32)
    lut, l0 = tt.root_lut.numpy(), tt.l0.numpy()
    deep, level_rows = tt.deep.numpy().view(np.uint32), tt.level_rows.numpy()
    rows = np.zeros(len(f), np.int32)
    for p in range(len(f)):
        alive, node = _entry(lut, l0, int(f[p, 1]), int(w[p, 0]))
        level = 1
        while level < n_levels and alive:
            first, count = (int(v) for v in level_rows[level - 1])
            if not 0 <= node < count:
                break
            row = [int(v) for v in deep[first + node]]
            rows[p] += 1
            bit_start = 16 + 8 * (level - 1)
            nib = (int(w[p, bit_start // 32]) >> (24 - bit_start % 32)) & 0xFF
            wd, bit = nib >> 5, nib & 31
            cw = row[2 + wd]
            alive = (cw >> bit) & 1 == 1
            node = _i32(row[0] + sum(_popc(x) for x in row[2:2 + wd]) + _popc(cw & ((1 << bit) - 1)))
            level += 1
    return rows


def _bits(w, pos: int, n: int) -> int:
    """The n bits at bit offset pos of the 128-bit address, 0 past it."""
    addr = int.from_bytes(b"".join(int(x).to_bytes(4, "big") for x in w), "big")
    return ((addr << 32) >> (160 - pos - n)) & ((1 << n) - 1) if n else 0


def replay_k3_steps(fields, words, ct) -> np.ndarray:
    """K3's skip-node loop replayed packet by packet in numpy: the node
    rows (skip steps) each walk reads."""
    f, w = fields.numpy(), words.numpy().view(np.uint32)
    lut, l0, nodes = ct.root_lut.numpy(), ct.l0.numpy(), ct.nodes.numpy().view(np.uint32)
    steps = np.zeros(len(f), np.int32)
    for p in range(len(f)):
        alive, node = _entry(lut, l0, int(f[p, 1]), int(w[p, 0]))
        pos = 16
        for _ in range(ct.d_max):
            if not alive or not 0 <= node < len(nodes):
                break
            row = [int(v) for v in nodes[node]]
            steps[p] += 1
            skip = row[2]
            if skip > 0 and _bits(w[p], pos, skip) != row[3]:
                break
            pos += skip
            nib = _bits(w[p], pos, 8)
            pos += 8
            wd, bit = nib >> 5, nib & 31
            cw = row[4 + wd]
            alive = (cw >> bit) & 1 == 1
            node = _i32(row[0] + sum(_popc(x) for x in row[4:4 + wd]) + _popc(cw & ((1 << bit) - 1)))
    return steps


def _assert_same(got, res, xdp, stats=None):
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32), res)
    np.testing.assert_array_equal(got[1].numpy(), xdp)
    if stats is not None:
        np.testing.assert_array_equal(got[2].numpy(), stats)


@pytest.mark.parametrize("n_levels", [1, 3, 8, 15])
def test_k2_depths_match_replay_and_construction(case, n_levels):
    tt = case["tt"]
    assert tt.n_levels == 15
    got = walk.walk_depths(case["fields"], case["words"], tt, n_levels).numpy()
    np.testing.assert_array_equal(got, replay_k2_rows(case["fields"], case["words"], tt, n_levels))
    np.testing.assert_array_equal(got, np.where(case["deep"], min(n_levels - 1,
                                                                  testing.DEEP_ROWS), 0))


def test_k3_depths_match_replay_and_construction(case):
    ct = case["ct"]
    assert ct.d_max >= testing.DEEP_ROWS
    got = cwalk.walk_depths(case["fields"], case["words"], ct).numpy()
    np.testing.assert_array_equal(got, replay_k3_steps(case["fields"], case["words"], ct))
    np.testing.assert_array_equal(got, np.where(case["deep"], testing.DEEP_ROWS, 0))


def test_depth_patterns_hold_their_shape(case):
    """The warp-level shape each pattern stands for: deep packets at the
    positions it names, both walks matching at the root and beyond."""
    deep, pattern = case["deep"], case["pattern"]
    pos = np.arange(N_PACKETS)
    want = {"full_depth": pos >= 0, "alternating": pos % 2 == 0,
            "one_deep_per_32": pos % 32 == 0, "root_only": pos < 0}[pattern]
    np.testing.assert_array_equal(deep, want)
    tidx = walk.trie_walk_classify(case["fields"], case["words"], case["tt"], 15)[:, 1].numpy()
    assert (tidx[deep] >= 0).all()
    if pattern != "full_depth":
        assert (tidx[~deep] >= 0).any() and (tidx[~deep] < 0).any()


def test_k2_plain_matches_jax_xla_trie(case):
    ref = jaxpath.jitted_classify(True)(jaxpath.device_tables(case["jt"]),
                                        jaxpath.device_batch(case["jb"]))
    got = walk.classify_walk(case["tt"], torchpath.device_batch(case["pb"], "cpu"), 15)
    _assert_same(got, *(np.asarray(a) for a in ref))


def test_k2_plain_matches_pallas_k2_interpret(case):
    wt = pallas_walk.build_walk_tables(case["jt"], vmem_budget=64 << 20)
    assert wt is not None
    ref = pallas_walk.jitted_classify_walk(True)(wt, jaxpath.device_batch(case["jb"]))
    got = walk.classify_walk(case["tt"], torchpath.device_batch(case["pb"], "cpu"), 15)
    _assert_same(got, *(np.asarray(a) for a in ref))


def test_k3_plain_matches_jax_xla_ctrie(case):
    cdev, d_max = jaxpath.device_ctrie(case["jt"])
    assert d_max == case["ct"].d_max
    ref = jaxpath.jitted_classify_ctrie(d_max)(cdev, jaxpath.device_batch(case["jb"]))
    got = cwalk.classify_ctrie(case["ct"], torchpath.device_batch(case["pb"], "cpu"))
    _assert_same(got, *(np.asarray(a) for a in ref))


def test_k3_plain_matches_pallas_k3_interpret(case):
    wt, meta = pallas_walk.build_cwalk_tables_meta(case["jt"], vmem_budget=256 << 20)
    assert meta["d_max"] == case["ct"].d_max
    ref = pallas_walk.jitted_classify_cwalk(meta["d_max"], True)(
        wt, jaxpath.device_batch(case["jb"]))
    got = cwalk.classify_ctrie(case["ct"], torchpath.device_batch(case["pb"], "cpu"))
    _assert_same(got, *(np.asarray(a) for a in ref))


@pytest.mark.parametrize("path", ["trie", "ctrie"])
def test_classifier_matches_tpu_classifier(case, path):
    """TorchClassifier(device="cpu", force_path=path) against
    TpuClassifier(force_path=path, interpret=True, fused_deep=True):
    results, XDP verdicts and statistics."""
    jclf = TpuClassifier(force_path=path, interpret=True, fused_deep=True)
    try:
        jclf.load_tables(case["jt"])
        clf = TorchClassifier(device="cpu", force_path=path)
        clf.load_tables(case["pt"])
        assert clf.active_path == jclf.active_path == path
        jout, out = jclf.classify(case["jb"], apply_stats=False), clf.classify(case["pb"])
        for f in ("results", "xdp", "stats_delta"):
            np.testing.assert_array_equal(getattr(out, f), getattr(jout, f), err_msg=f)
    finally:
        jclf.close()
