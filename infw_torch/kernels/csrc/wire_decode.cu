// K4 on Hopper: fixed-stride delta decode of the compressed wire.  The n
// deltas of section C, fixed_w (1, 2 or 4) little-endian bytes each, are
// combined into u32 values and replaced by their inclusive prefix sum
// modulo 2^32: the sorted IPv4 source words of a delta chunk.
//
// Replaces the TPU kernel infw/kernels/wire_decode.py:_decode_scan_kernel
// (launched by pallas_decode_fixed).  Same function, bit for bit.  The
// port also runs it on the varint plan's decoded deltas (fixed_w = 4 over
// their little-endian bytes), so every delta chunk launches it once.
//
// What the TPU kernel does and why this one differs: the Pallas grid walks
// 1024-value blocks IN ORDER on one core and carries the running total from
// one block to the next in an SMEM scalar.  Blocks of a CUDA grid run in
// parallel in no order, so nothing carries between them; this is a
// reduce-then-scan in three launches on the caller's stream:
//   1. scan_blocks: each block of 256 threads takes 1024 values (4 per
//      thread, the Pallas block of 8 x 128), stages its bytes in shared
//      memory with coalesced loads, combines them, scans within the thread,
//      then across the block (__shfl_up_sync within warps, warp totals
//      through shared memory), and writes the block-local inclusive scan
//      and the block total;
//   2. scan_totals: one block turns the block totals into exclusive
//      prefixes in place, looping with a carry over 1024 totals at a time;
//   3. add_offsets: every value of block b > 0 gets block b's prefix.
// Steps 2 and 3 run only when there is more than one block.  uint32
// arithmetic wraps by itself, as the encoder's 32-bit domain needs.
//
// What bounds it on this card: bytes.  It must read n * fixed_w bytes and
// write 4n; at n = 2^20 that is 5-8 MB, about 2 us at 3.35 TB/s, so the
// three launches' latency dominates.  A single-pass scan with decoupled
// look-back would need one launch; that is later work.
//
// Section C starts at n_a + 2n bytes into the payload, in general not
// 4-byte aligned: the kernel reads bytes and never casts `c` to a wider
// type.  `out` and `block_tot` come from torch.empty (256-byte aligned).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kBlock = kThreads * kPerThread;  // values per block
constexpr int kWarps = kThreads / 32;

// Inclusive scan of `v` over the block's threads (in thread order); sets
// `total` to the block's sum.  Every thread of the block must call it.
__device__ __forceinline__ uint32_t block_scan(uint32_t v, uint32_t* warp_sums,
                                               uint32_t& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    uint32_t s = lane < kWarps ? warp_sums[lane] : 0u;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const uint32_t u = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += u;
    }
    if (lane < kWarps) warp_sums[lane] = s;  // inclusive prefix of warp sums
  }
  __syncthreads();
  total = warp_sums[kWarps - 1];
  const uint32_t before = warp ? warp_sums[warp - 1] : 0u;
  __syncthreads();  // warp_sums is free again for the caller's next scan
  return v + before;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
scan_blocks(const uint8_t* __restrict__ c, uint32_t* __restrict__ out,
            uint32_t* __restrict__ block_tot, int n) {
  __shared__ uint8_t bytes[kBlock * W];
  __shared__ uint32_t warp_sums[kWarps];
  const int base = blockIdx.x * kBlock;
  const int nb = min(kBlock, n - base) * W;  // this block's bytes
  const uint8_t* src = c + (size_t)base * W;
  for (int j = threadIdx.x; j < kBlock * W; j += kThreads) bytes[j] = j < nb ? src[j] : 0;
  __syncthreads();

  uint32_t x[kPerThread];
  uint32_t run = 0;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const uint8_t* p = bytes + (threadIdx.x * kPerThread + k) * W;
    uint32_t d = p[0];
#pragma unroll
    for (int b = 1; b < W; ++b) d |= (uint32_t)p[b] << (8 * b);
    run += d;
    x[k] = run;
  }
  uint32_t total;
  const uint32_t before = block_scan(run, warp_sums, total) - run;
  const int i0 = base + threadIdx.x * kPerThread;
  if (i0 + kPerThread <= n) {
    *reinterpret_cast<uint4*>(out + i0) =
        make_uint4(x[0] + before, x[1] + before, x[2] + before, x[3] + before);
  } else {
    for (int k = 0; k < kPerThread && i0 + k < n; ++k) out[i0 + k] = x[k] + before;
  }
  if (threadIdx.x == 0) block_tot[blockIdx.x] = total;
}

// block_tot[0..m) -> its exclusive prefix sums, in place, by one block.
__global__ void __launch_bounds__(kThreads)
scan_totals(uint32_t* __restrict__ block_tot, int m) {
  __shared__ uint32_t warp_sums[kWarps];
  uint32_t carry = 0;
  for (int start = 0; start < m; start += kBlock) {
    const int i0 = start + threadIdx.x * kPerThread;
    uint32_t x[kPerThread];
    uint32_t run = 0;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      x[k] = run;  // exclusive within the thread
      run += i0 + k < m ? block_tot[i0 + k] : 0u;
    }
    uint32_t total;
    const uint32_t before = block_scan(run, warp_sums, total) - run;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k)
      if (i0 + k < m) block_tot[i0 + k] = carry + before + x[k];
    carry += total;
  }
}

__global__ void __launch_bounds__(kThreads)
add_offsets(uint32_t* __restrict__ out, const uint32_t* __restrict__ block_excl, int n) {
  const int b = blockIdx.x + 1;  // block 0's prefix is 0
  const uint32_t off = block_excl[b];
  const int base = b * kBlock;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = base + k * kThreads + threadIdx.x;
    if (i < n) out[i] += off;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); allocates nothing.
// c: at least n * fixed_w bytes, any alignment; out: n u32; block_tot:
// ceil(n / 1024) u32 of scratch; 0 < n and n * fixed_w < 2^31 (the Python
// wrapper checks them).
extern "C" int infw_decode_scan(const void* c, void* out, void* block_tot, int n, int fixed_w,
                                void* stream) {
  if (n > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    const int blocks = (n + kBlock - 1) / kBlock;
    const uint8_t* cb = (const uint8_t*)c;
    uint32_t* o = (uint32_t*)out;
    uint32_t* t = (uint32_t*)block_tot;
    switch (fixed_w) {
      case 1: scan_blocks<1><<<blocks, kThreads, 0, s>>>(cb, o, t, n); break;
      case 2: scan_blocks<2><<<blocks, kThreads, 0, s>>>(cb, o, t, n); break;
      case 4: scan_blocks<4><<<blocks, kThreads, 0, s>>>(cb, o, t, n); break;
      default: return (int)cudaErrorInvalidValue;
    }
    if (blocks > 1) {
      scan_totals<<<1, kThreads, 0, s>>>(t, blocks);
      add_offsets<<<blocks - 1, kThreads, 0, s>>>(o, t, n);
    }
  }
  return (int)cudaGetLastError();
}
