"""K5 (the gather microbenchmark's row gather + uint32 row sum) on the CPU:
its plain version against the Pallas kernel body of the JAX package's
``tools/profile_gather.py`` run through ``pl.pallas_call(...,
interpret=True)`` (and, at the card tests' other table shapes, which the
tool's BlockSpec does not take, against the body's two lines), the
wrapper's CPU dispatch, and the port tool's steps against the JAX tool's.  The tool defines its kernel inside ``main()``, so
the two lines of its body are restated here.  Exact (integers)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from infw_torch.kernels import gather
from infw_torch.tools import profile_gather

N2, W, B, BB = 4096, 128, 4096, 1024


def _kern(idx_ref, tbl_ref, out_ref):
    # tools/profile_gather.py:86-88
    rows = jnp.take(tbl_ref[:], idx_ref[:], axis=0)
    out_ref[:] = jnp.sum(rows.astype(jnp.uint32), axis=1, keepdims=True)


def _pallas_rowsum(idx: np.ndarray, table: np.ndarray) -> np.ndarray:
    """The JAX tool's pallas_call (:92-101) in interpret mode, on its
    clipped indices: (B,) uint32."""
    out = pl.pallas_call(
        _kern,
        out_shape=jax.ShapeDtypeStruct((len(idx), 1), jnp.uint32),
        grid=(len(idx) // BB,),
        in_specs=[pl.BlockSpec((BB,), lambda i: (i,)),
                  pl.BlockSpec((N2, W), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((BB, 1), lambda i: (i, 0)),
        interpret=True,
    )(jnp.clip(jnp.asarray(idx), 0, N2 - 1), jnp.asarray(table))
    return np.asarray(out)[:, 0]


@pytest.fixture(scope="module")
def operands():
    """Indices with a slice outside [0, 4095], and table words near 2^32 so
    every row sum wraps."""
    rng = np.random.default_rng(5)
    idx = rng.integers(0, N2, B).astype(np.int32)
    idx[::7] = rng.integers(-(2**31), 2**31 - 1, len(idx[::7]), dtype=np.int64).astype(np.int32)
    idx[:4] = [-1, N2, 2**31 - 1, -(2**31)]
    table = (2**32 - rng.integers(1, 2**20, (N2, W))).astype(np.uint32)
    return idx, table


def test_plain_matches_the_pallas_kernel(operands):
    idx, table = operands
    want = _pallas_rowsum(idx, table)
    got = gather.gather_rowsum_plain(torch.from_numpy(idx), torch.from_numpy(table.view(np.int32)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert (table[np.clip(idx, 0, N2 - 1)].astype(np.uint64).sum(axis=1) >= 2**32).all()


#: the card tests' tables: the tool's (4096, 128), one row, narrow rows,
#: a width past one warp's load, and rows above the kernel's staging cap
SHAPES = ((N2, W), (1, 4), (4096, 4), (5000, 256), (65536, 8))


def _kern_body_rowsum(idx: np.ndarray, table: np.ndarray) -> np.ndarray:
    """The two lines of the JAX tool's ``kern`` body on its clipped
    indices, outside ``pallas_call`` (whose BlockSpec fixes (4096, 128)):
    (B,) uint32."""
    rows = jnp.take(jnp.asarray(table), jnp.clip(jnp.asarray(idx), 0, table.shape[0] - 1), axis=0)
    return np.asarray(jnp.sum(rows.astype(jnp.uint32), axis=1))


@pytest.mark.parametrize("b", [1, 3, 1025])
@pytest.mark.parametrize("n,w", SHAPES)
def test_plain_matches_the_jax_kernel_at_the_card_shapes(n, w, b):
    """The plain version against the JAX tool's kernel at the card tests'
    shapes: through the Pallas body in interpret mode at (4096, 128) (the
    indices padded to whole 1024-index blocks), through its two lines at
    the others.  Indices outside [0, N) with the int32 edges among them,
    and table words near 2^32 so that row sums wrap."""
    rng = np.random.default_rng(n * 7 + w + b)
    idx = rng.integers(-n, 2 * n, b).astype(np.int64)
    idx[: min(b, 3)] = [2**31 - 1, -(2**31), n][: min(b, 3)]
    idx = idx.astype(np.int32)
    table = (2**32 - rng.integers(1, 2**26, (n, w))).astype(np.uint32)
    if (n, w) == (N2, W):
        padded = np.zeros(-(-b // BB) * BB, np.int32)
        padded[:b] = idx
        want = _pallas_rowsum(padded, table)[:b]
    else:
        want = _kern_body_rowsum(idx, table)
    got = gather.gather_rowsum_plain(torch.from_numpy(idx), torch.from_numpy(table.view(np.int32)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert (table[np.clip(idx, 0, n - 1)].astype(np.uint64).sum(axis=1) >= 2**32).all()


def test_wrapper_runs_the_plain_version_on_the_cpu(operands):
    idx, table = operands
    t_idx, t_tab = torch.from_numpy(idx), torch.from_numpy(table.view(np.int32))
    before = gather.KERNEL.launches
    got = gather.gather_rowsum(t_idx, t_tab)
    assert gather.KERNEL.launches == before  # no kernel on the CPU
    assert torch.equal(got, gather.gather_rowsum_plain(t_idx, t_tab))
    assert gather.gather_rowsum(t_idx[:0], t_tab).shape == (0,)
    assert torch.equal(gather.gather_rowsum(t_idx, t_tab, _grid=1), got)
    assert torch.equal(gather.gather_rowsum(t_idx[:1025], t_tab), got[:1025])
    with pytest.raises(ValueError, match="unsupported device"):
        gather.gather_rowsum(t_idx.to("meta"), t_tab.to("meta"))


def test_tool_steps_match_the_jax_tools_steps(operands):
    """One step of the port tool's K5 chain and of its index_select ladder
    equal the JAX tool's Pallas step ``(idx + s) % N`` on the same
    operands."""
    idx, table = operands
    want = (jnp.asarray(idx) + jnp.asarray(_pallas_rowsum(idx, table)).astype(jnp.int32)) % N2
    t_idx, t_tab = torch.from_numpy(idx), torch.from_numpy(table.view(np.int32))
    np.testing.assert_array_equal(profile_gather.k5_step(t_tab)(t_idx).numpy(), np.asarray(want))
    np.testing.assert_array_equal(profile_gather.library_step(t_tab)(t_idx).numpy(),
                                  np.asarray(want))


def test_tool_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would run")
    with pytest.raises(RuntimeError, match="CUDA"):
        profile_gather.main([])
    with pytest.raises(SystemExit, match="CUDA device"):
        profile_gather.main([], device="cpu")
