"""Row gather + row sum: kernel K5 and its plain version.

Counterpart of the Pallas kernel of the JAX package's gather
microbenchmark (``tools/profile_gather.py``, ``kern`` launched by
``pstep``): for each int32 index, clipped to [0, N - 1], the uint32 sum
(wrapping) of that row of an (N, W) uint32 table.  The port's profiling
tool (``infw_torch/tools/profile_gather.py``) times it.

- ``gather_rowsum``: the wrapper of the hand-written CUDA kernel
  ``csrc/gather_rowsum.cu``, one cooperative launch that sums each table
  row once into an (N,) scratch, then gathers the sums (staged in shared
  memory up to ``STAGED_MAX_ROWS`` rows, read through L2 above).  On a
  CUDA tensor it launches the kernel or raises; on a CPU tensor it runs
  ``gather_rowsum_plain``;
- ``gather_rowsum_plain``: the same function in plain PyTorch, chunked
  over indices so it also runs at 2^20 indices on the card.

uint32 values travel as int32 tensors holding the bit patterns.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .torchpath import wrap_int32

#: indices per step of the plain version, which bounds its temporaries
PLAIN_CHUNK = 1 << 16
#: the most table rows whose sums the kernel stages in shared memory
#: (``kStageCapBytes`` in csrc/gather_rowsum.cu over 4 bytes a sum)
STAGED_MAX_ROWS = 200 * 1024 // 4

KERNEL = _build.Kernel(
    "gather_rowsum",
    "infw_gather_rowsum",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
)


def gather_rowsum_plain(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """K5's function in plain PyTorch: (B,) int32 indices + (N, W) int32
    table (uint32 bit patterns) -> (B,) int32, the uint32 row sums."""
    n = table.shape[0]
    out = torch.empty(idx.shape[0], dtype=torch.int32, device=idx.device)
    for s in range(0, idx.shape[0], PLAIN_CHUNK):
        rows = table[idx[s:s + PLAIN_CHUNK].long().clamp(0, n - 1)].to(torch.int64) & 0xFFFFFFFF
        out[s:s + PLAIN_CHUNK] = wrap_int32(rows.sum(dim=1))
    return out


def gather_rowsum(idx: torch.Tensor, table: torch.Tensor, *, _grid: int = 0) -> torch.Tensor:
    """Kernel K5: (B,) int32 indices + (N, W) int32 table -> (B,) int32
    uint32 row sums.  A CPU tensor runs the plain version; a CUDA tensor
    launches the CUDA kernel (building it on first use) or raises.  An
    empty batch launches nothing.  ``_grid`` > 0 caps the kernel's grid
    (tests)."""
    if idx.device.type == "cpu":
        return gather_rowsum_plain(idx, table)
    if idx.device.type != "cuda":
        raise ValueError(f"gather_rowsum: unsupported device {idx.device}")
    if idx.dim() != 1 or table.dim() != 2 or table.shape[0] < 1 or table.shape[1] % 4:
        raise ValueError(f"gather_rowsum: idx {tuple(idx.shape)} / table {tuple(table.shape)}, "
                         "expected (B,) / (N >= 1, W) with W a multiple of 4")
    b, n = idx.shape[0], table.shape[0]
    if max(b, n, table.shape[1]) >= 2**31:
        raise ValueError("gather_rowsum: B, N and W must be below 2^31")
    for t in (idx, table):
        if t.device != idx.device or t.dtype != torch.int32:
            raise ValueError("gather_rowsum: operands must be int32 on one device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("gather_rowsum: operands must be contiguous and 16-byte aligned")
    if b == 0:
        return torch.empty(0, dtype=torch.int32, device=idx.device)
    # one allocation: the output, then (16-byte aligned) the row-sum scratch
    b4 = (b + 3) // 4 * 4
    buf = torch.empty(b4 + (n + 3) // 4 * 4, dtype=torch.int32, device=idx.device)
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL.launch(idx.data_ptr(), table.data_ptr(), buf.data_ptr() + 4 * b4, buf.data_ptr(),
                      b, n, table.shape[1], int(_grid), stream)
    return buf[:b]
