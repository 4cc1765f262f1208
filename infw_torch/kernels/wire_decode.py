"""On-device decode of the delta+varint wire: kernel K4 and its plain version.

Counterpart of the JAX package's ``kernels/wire_decode.py``.  The host ships
only the compressed byte stream of packets.encode_delta_wire (sections A/B/C,
see the layout note in packets.py) and the device expands it into a
DeviceBatch, in the stream's SORTED order with pkt_len zero: packet order
and lengths never cross the link; the host applies the inverse permutation
to the returned verdicts and computes the byte statistics from its own
pkt_len column (backend.base.stats_from_results).

- ``payload_bucket`` / ``pad_payload`` / ``pad_dict``: the shapes shipped
  (the auto codec's byte count depends on the bucket, so the format choice
  matches the JAX package's);
- ``decode_scan``: the wrapper of the hand-written CUDA kernel
  ``csrc/wire_decode.cu``, which replaces the Pallas ``_decode_scan_kernel``:
  the 1/2/4-byte little-endian combine of section C into deltas and their
  inclusive prefix sum modulo 2^32.  On a CUDA tensor it launches the kernel
  or raises; on a CPU tensor it runs ``decode_scan_plain``.  Every delta
  chunk launches it once: the fixed-stride plan on section C, the varint
  plan on the little-endian bytes of the deltas ``_decode_varint_deltas``
  decodes (its prefix sum is the same function at width 4);
- ``decode_delta``: stream -> DeviceBatch;
- ``classify_delta`` (trie, K2 at the IPv4 depth) and
  ``classify_delta_ctrie`` (K3): decode + classify, the packed res16
  results only.

The JAX package's ``decode_pallas`` switch (run the plain scan in place of
the Pallas kernel) has no counterpart: on the card K4 serves every decode.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..constants import IPPROTO_ICMP, IPPROTO_ICMPV6
from ..packets import delta_section_offsets
from . import _build
from .cwalk import CTrieTables, classify_ctrie_res16
from .torchpath import DeviceBatch
from .walk import TrieTables, classify_walk_res16

#: device payload buffers are padded to bucketed sizes, at least 256 bytes
_PAYLOAD_BUCKET_MIN = 256
#: values per block of K4 (256 threads x 4), the Pallas kernel's 8 x 128
SCAN_BLOCK = 1024

KERNEL = _build.Kernel(
    "wire_decode",
    "infw_decode_scan",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
)


def payload_bucket(n: int) -> int:
    """Bucketed payload size: a power of two with three mantissa bits (the
    next multiple of 2^(e-3) for 2^e <= n), so padding costs at most
    12.5%."""
    if n <= _PAYLOAD_BUCKET_MIN:
        return _PAYLOAD_BUCKET_MIN
    step = 1 << max(n.bit_length() - 1 - 3, 0)
    return -(-n // step) * step


def pad_payload(payload: np.ndarray) -> np.ndarray:
    """Zero-pad the payload to its bucket.  Trailing zero bytes are inert:
    the fixed sections are bounded by n, and in the varint section each pad
    byte decodes as a value whose index is >= n, which the decode drops."""
    n = payload.shape[0]
    cap = payload_bucket(n)
    if n == cap:
        return payload
    out = np.zeros(cap, np.uint8)
    out[:n] = payload
    return out


def pad_dict(dict_vals: np.ndarray) -> np.ndarray:
    """The meta15 dictionary padded to its full 256 slots."""
    out = np.zeros(256, np.uint32)
    out[: dict_vals.shape[0]] = dict_vals
    return out


def _decode_varint_deltas(c: torch.Tensor, n: int) -> torch.Tensor:
    """Parallel LEB128 decode: (L,) uint8 section-C bytes (zero-padded) ->
    (n,) int32 deltas (uint32 bit patterns).  Continuation bits mark value
    boundaries: a cumulative count of terminators gives each byte its value
    index v, the start of value v (one past the terminator of value v - 1,
    scattered to slot v) its 7-bit shift, and an index add re-assembles the
    values.  As the reference's uint32 scatter-add with ``mode="drop"``:
    bytes whose value index is >= n (the zero padding) go to a discarded
    slot, the shift position is clamped to 4, and each contribution and sum
    wraps modulo 2^32.  (The reference's running max of segment starts,
    ``lax.cummax``, gives the same starts; torch.cummax scans a 1-D tensor
    in one CUDA block.)"""
    L = c.shape[0]
    b = c.to(torch.int64)
    term = ((b >> 7) & 1) == 0
    t = term.to(torch.int64)
    vidx = torch.cumsum(t, 0) - t
    idx = torch.arange(L, dtype=torch.int64, device=c.device)
    # start[v] for v in [0, L]; terminators have distinct value indexes, the
    # other bytes all write to the discarded slot L + 1
    start = torch.zeros(L + 2, dtype=torch.int64, device=c.device)
    start.scatter_(0, torch.where(term, vidx + 1, L + 1), idx + 1)
    pos = torch.clamp(idx - start[vidx], max=4)
    contrib = ((b & 0x7F) << (7 * pos)) & 0xFFFFFFFF
    out = torch.zeros(n + 1, dtype=torch.int64, device=c.device)
    out.index_add_(0, vidx.clamp(max=n), contrib)
    out = out[:n] & 0xFFFFFFFF
    return torch.where(out >= 2**31, out - 2**32, out).to(torch.int32)


def _decode_fixed_deltas(c: torch.Tensor, n: int, fixed_w: int) -> torch.Tensor:
    """(L,) uint8 fixed-stride section C -> (n,) int64 deltas in [0, 2^32)
    (little-endian byte combine)."""
    raw = c[: n * fixed_w].reshape(n, fixed_w).to(torch.int64)
    out = raw[:, 0]
    for k in range(1, fixed_w):
        out = out | (raw[:, k] << (8 * k))
    return out


def decode_scan_plain(c: torch.Tensor, n: int, fixed_w: int) -> torch.Tensor:
    """K4's function in plain PyTorch: the first n * fixed_w bytes of ``c``
    combined little-endian into n deltas, their inclusive prefix sum modulo
    2^32, as (n,) int32 bit patterns."""
    ip = torch.cumsum(_decode_fixed_deltas(c, n, fixed_w), 0) & 0xFFFFFFFF
    return torch.where(ip >= 2**31, ip - 2**32, ip).to(torch.int32)


def decode_scan(c: torch.Tensor, n: int, fixed_w: int) -> torch.Tensor:
    """Kernel K4: (L,) uint8 bytes, L >= n * fixed_w, fixed_w in {1, 2, 4}
    -> (n,) int32, the inclusive prefix sum modulo 2^32 of the n
    little-endian deltas.  ``c`` may start at any byte offset.  A CPU tensor
    runs the plain version; a CUDA tensor launches the CUDA kernel (building
    it on first use) or raises."""
    if fixed_w not in (1, 2, 4):
        raise ValueError(f"decode_scan: fixed_w {fixed_w} not in (1, 2, 4)")
    if c.dim() != 1 or c.dtype != torch.uint8 or n < 0 or c.shape[0] < n * fixed_w:
        raise ValueError(
            f"decode_scan: need a 1-D uint8 tensor of at least n * fixed_w = {n * fixed_w} "
            f"bytes, got {c.dtype} {tuple(c.shape)}"
        )
    if c.device.type == "cpu":
        return decode_scan_plain(c, n, fixed_w)
    if c.device.type != "cuda":
        raise ValueError(f"decode_scan: unsupported device {c.device}")
    if not c.is_contiguous():
        raise ValueError("decode_scan: the byte tensor must be contiguous")
    if n >= 2**31 // fixed_w:
        raise ValueError(f"decode_scan: n {n} too large for 32-bit byte offsets")
    out = torch.empty(n, dtype=torch.int32, device=c.device)
    if n == 0:
        return out
    block_tot = torch.empty(-(-n // SCAN_BLOCK), dtype=torch.int32, device=c.device)
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL.launch(c.data_ptr(), out.data_ptr(), block_tot.data_ptr(), n, fixed_w, stream)
    return out


def decode_delta(payload: torch.Tensor, dict_vals: torch.Tensor, ifmap: torch.Tensor, *,
                 n: int, dict_mode: int, fixed_w: int) -> DeviceBatch:
    """Compressed stream -> DeviceBatch on the payload's device, in sorted
    order, pkt_len zero.  ``payload`` is the (P,) uint8 bucket-padded
    stream, ``dict_vals`` the (256,) int32 padded dictionary, ``ifmap`` the
    (16,) int32 ifindex dictionary.  Dictionary reads clamp their index,
    as the reference's ``take(..., mode="clip")``."""
    off_b, off_c = delta_section_offsets(n, dict_mode)
    dev = payload.device
    if dict_mode == 0:
        dict_idx = torch.zeros(n, dtype=torch.int64, device=dev)
    elif dict_mode == 1:
        i = torch.arange(n, dtype=torch.int64, device=dev)
        half = payload[(i >> 1).clamp(max=payload.shape[0] - 1)].to(torch.int64)
        dict_idx = torch.where((i & 1) == 0, half & 0xF, half >> 4)
    else:
        dict_idx = payload[:n].to(torch.int64)
    meta = dict_vals[dict_idx.clamp(0, dict_vals.shape[0] - 1)]
    l4b = payload[off_b : off_b + 2 * n].reshape(n, 2).to(torch.int32)
    l4 = l4b[:, 0] | (l4b[:, 1] << 8)
    c = payload[off_c:]
    if fixed_w:
        ip = decode_scan(c, n, fixed_w)
    else:
        ip = decode_scan(_decode_varint_deltas(c, n).view(torch.uint8), n, 4)
    proto = (meta >> 3) & 0xFF
    is_icmp = (proto == IPPROTO_ICMP) | (proto == IPPROTO_ICMPV6)
    ifd = ((meta >> 11) & 0xF).long()
    zero = torch.zeros_like(proto)
    return DeviceBatch(
        kind=meta & 3,
        l4_ok=(meta >> 2) & 1,
        ifindex=ifmap[ifd.clamp(0, ifmap.shape[0] - 1)],
        ip_words=torch.cat([ip[:, None], ip.new_zeros((n, 3))], dim=1),
        proto=proto,
        dst_port=torch.where(is_icmp, zero, l4),
        icmp_type=torch.where(is_icmp, l4 >> 8, zero),
        icmp_code=torch.where(is_icmp, l4 & 0xFF, zero),
        pkt_len=zero,
    )


def classify_delta(tt: TrieTables, payload: torch.Tensor, dict_vals: torch.Tensor,
                   ifmap: torch.Tensor, *, n: int, dict_mode: int, fixed_w: int) -> torch.Tensor:
    """Decode + trie classify (K2 at the IPv4 depth: a delta chunk holds no
    IPv6 packet), packed res16 out, in sorted order."""
    batch = decode_delta(payload, dict_vals, ifmap, n=n, dict_mode=dict_mode, fixed_w=fixed_w)
    return classify_walk_res16(tt, batch)


def classify_delta_ctrie(ct: CTrieTables, payload: torch.Tensor, dict_vals: torch.Tensor,
                         ifmap: torch.Tensor, *, n: int, dict_mode: int,
                         fixed_w: int) -> torch.Tensor:
    """Decode + ctrie classify (K3), packed res16 out, in sorted order."""
    batch = decode_delta(payload, dict_vals, ifmap, n=n, dict_mode=dict_mode, fixed_w=fixed_w)
    return classify_ctrie_res16(ct, batch)
