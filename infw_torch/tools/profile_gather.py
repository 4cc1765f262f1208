"""Gather microbenchmark on the card: the cost per row of gathering table
rows and summing them, against the row width, plus kernel K5.

    python -m infw_torch.tools.profile_gather [--batch B] [--min-span S]

The counterpart of the JAX package's ``tools/profile_gather.py``:

- the library ladder: ``index_select`` of a (65536, W) uint32 table by
  2^20 indices and a row sum, for W = 8, 32, 64, 128, 256;
- kernel K5 (kernels/gather.py): the row gather + uint32 row sum from a
  (4096, 128) table, which the JAX tool runs as a Pallas kernel holding the
  table in VMEM.  The port's K5 sums each table row once and gathers the
  sums (one cooperative launch), so its line times the function K5
  computes; the ladder is what times a row gather per row width.

Both are timed by the JAX tool's chained two-point slope: ``k`` dependent
steps ``idx = step(idx ^ i)`` with ``step(idx) = (idx + rowsum(idx)) %
N``, timed on CUDA events at k1 and k2 (k2 tripled until the two times
differ by ``--min-span`` seconds), the best of three attempts each; the
slope (t2 - t1) / (k2 - k1) is the time of one step.  Results print to
stderr, one line per case, as the JAX tool prints them.  Needs a CUDA
card; the indices and tables are made from a seed.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..kernels import gather
from ..kernels.torchpath import resolve_device

LADDER_ROWS = 65536
LADDER_WIDTHS = (8, 32, 64, 128, 256)
K5_ROWS, K5_WIDTH = 4096, 128


def slope(step, idx0: torch.Tensor, label: str, min_span: float = 0.5,
          k1: int = 3, k2: int = 23) -> float:
    """Seconds per step of the chain ``idx = step(idx ^ i)``, i = 0..k-1,
    by the two-point slope on CUDA events; prints a line to stderr."""
    def run(k: int) -> float:
        best = float("inf")
        for attempt in range(3):
            idx = idx0 ^ (attempt + 1)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(k):
                idx = step(idx ^ i)
            stop.record()
            torch.cuda.synchronize()
            best = min(best, start.elapsed_time(stop) / 1e3)
        return best

    run(1)  # warm: builds and loads whatever the step launches
    b1 = run(k1)
    while True:
        b2 = run(k2)
        if b2 - b1 >= min_span or k2 >= 2000:
            break
        k2 *= 3
        b1 = run(k1)
    dt = (b2 - b1) / (k2 - k1)
    n = idx0.shape[0]
    print(f"{label}: {dt / n * 1e9:6.2f} ns/row ({n * 1e-6 / dt:6.1f} M rows/s)",
          file=sys.stderr, flush=True)
    return dt


def library_step(table: torch.Tensor):
    """One ladder step: index_select of the clipped indices, a row sum."""
    n = table.shape[0]

    def step(idx: torch.Tensor) -> torch.Tensor:
        s = table.index_select(0, idx.clamp(0, n - 1)).sum(dim=1, dtype=torch.int32)
        return (idx + s) % n

    return step


def k5_step(table: torch.Tensor):
    """One K5 step: the kernel's uint32 row sums added to the indices."""
    n = table.shape[0]
    return lambda idx: (idx + gather.gather_rowsum(idx, table)) % n


def main(argv=None, device=None) -> dict:
    """Run the ladder and K5; returns {label: seconds per step}."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=1 << 20, help="indices per step")
    p.add_argument("--min-span", type=float, default=0.5,
                   help="seconds the two timed chains must differ by")
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)
    device = resolve_device(device)
    if device.type != "cuda":
        raise SystemExit("profile_gather times the card: it needs a CUDA device")
    rng = np.random.default_rng(args.seed)
    out = {}

    def rand_table(n: int, w: int) -> torch.Tensor:
        vals = rng.integers(0, 2**32, (n, w), dtype=np.int64).astype(np.uint32)
        return torch.from_numpy(vals.view(np.int32)).to(device)

    idx0 = torch.from_numpy(rng.integers(0, LADDER_ROWS, args.batch).astype(np.int32)).to(device)
    for w in LADDER_WIDTHS:
        label = f"index_select + sum N={LADDER_ROWS} W={w} ({w * 4}B)"
        out[label] = slope(library_step(rand_table(LADDER_ROWS, w)), idx0, label, args.min_span)
    print("=== K5 gather_rowsum (hand-written CUDA) ===", file=sys.stderr, flush=True)
    idx5 = torch.from_numpy(rng.integers(0, K5_ROWS, args.batch).astype(np.int32)).to(device)
    label = f"K5 gather_rowsum N={K5_ROWS} row={K5_WIDTH * 4}B (each row summed once)"
    out[label] = slope(k5_step(rand_table(K5_ROWS, K5_WIDTH)), idx5, label, args.min_span)
    return out


if __name__ == "__main__":
    main()
