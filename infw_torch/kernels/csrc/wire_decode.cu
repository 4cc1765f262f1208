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
// parallel in no order, so the carry needs a grid-wide step.  This kernel
// is ONE cooperative launch of G co-resident blocks (G = the occupancy
// maximum x the SM count, queried once per device and width, capped by the
// number of 4096-value chunks):
//   1. block b takes a contiguous span of chunks; for each chunk it stages
//      the bytes in shared memory with coalesced byte loads, combines them
//      (4 values per thread of 1024), scans within the thread, then across the
//      block (__shfl_up_sync within warps, warp totals through shared
//      memory), and adds the running total of its earlier chunks; it stores
//      every chunk but the last (which stays in registers) and writes the
//      span's total to totals[b];
//   2. cooperative_groups::this_grid().sync();
//   3. block b sums totals[0..b) (at most G values, a few per thread, in a
//      fixed order), adds that prefix to its stored chunks (re-read from L2)
//      and to the chunk in registers, and stores.
// At the main path's n = 2^20 every block holds one chunk, so every value is
// read once and written once.  No flag words, no scratch that must be reset
// between calls (totals[b] is written before the barrier that precedes every
// read), deterministic.  uint32 arithmetic wraps by itself, as the encoder's
// 32-bit domain needs.
//
// What bounds it on this card: bytes.  It must read n * fixed_w bytes and
// write 4n; at n = 2^20 that is 5-8 MB, 1.6-2.5 us at 3.35 TB/s; the grid
// barrier and the launch are the rest.  Blocks of 1024 threads keep the grid
// small (2^20 values in 256 blocks): every block arrives at the barrier
// through one counter, so its cost grows with the block count.
//
// Section C starts at n_a + 2n bytes into the payload, in general not
// 4-byte aligned: the kernel reads `c` byte by byte and never through a
// wider type.  `out` and `totals` come from one torch.empty (out 256-byte
// aligned, totals right after it).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kPerThread = 4;
constexpr int kChunk = kThreads * kPerThread;  // values per chunk
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGrid = 1024;  // the totals scratch the wrapper allocates
constexpr int kMaxDevices = 64;

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
decode_scan_kernel(const uint8_t* __restrict__ c, uint32_t* __restrict__ out,
                   uint32_t* totals, long long n, long long span) {
  __shared__ __align__(16) uint8_t bytes[kChunk * W];
  __shared__ uint32_t warp_sums[kWarps];
  const long long first = (long long)blockIdx.x * span;
  const long long end = min(n, first + span);
  const long long last = end - 1 - (end - 1 - first) % kChunk;  // the last chunk's base

  // 1. local scans; the last chunk stays in x
  uint32_t x[kPerThread];
  uint32_t carry = 0;  // this block's earlier chunks
  for (long long base = first; base < end; base += kChunk) {
    const int nb = (int)min((long long)kChunk, end - base) * W;
    const uint8_t* src = c + base * W;
    __syncthreads();  // the previous chunk's bytes are consumed
    for (int j = threadIdx.x; j < kChunk * W; j += kThreads) bytes[j] = j < nb ? src[j] : 0;
    __syncthreads();
    // this thread's kPerThread * W bytes: W aligned words of shared memory,
    // read as one vector
    uint32_t wd[W];
    if constexpr (W == 4) {
      const uint4 v = reinterpret_cast<const uint4*>(bytes)[threadIdx.x];
      wd[0] = v.x; wd[1] = v.y; wd[2] = v.z; wd[3] = v.w;
    } else if constexpr (W == 2) {
      const uint2 v = reinterpret_cast<const uint2*>(bytes)[threadIdx.x];
      wd[0] = v.x; wd[1] = v.y;
    } else {
      wd[0] = reinterpret_cast<const uint32_t*>(bytes)[threadIdx.x];
    }
    uint32_t run = 0;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      uint32_t d;
      if constexpr (W == 4) d = wd[k];
      else if constexpr (W == 2) d = (wd[k >> 1] >> (16 * (k & 1))) & 0xFFFFu;
      else d = (wd[0] >> (8 * k)) & 0xFFu;
      run += d;
      x[k] = run;
    }
    uint32_t total;
    const uint32_t before = block_scan(run, warp_sums, total) - run + carry;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) x[k] += before;
    carry += total;
    if (base != last) {  // stored now, re-read after the barrier
      const long long i0 = base + threadIdx.x * kPerThread;  // a full chunk
      *reinterpret_cast<uint4*>(out + i0) = make_uint4(x[0], x[1], x[2], x[3]);
    }
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;

  // 2. every span's total is written
  cg::this_grid().sync();

  // 3. this block's prefix: totals[0..b), summed in a fixed order
  uint32_t s = 0;
  for (int j = threadIdx.x; j < (int)blockIdx.x; j += kThreads) s += __ldcg(totals + j);
  uint32_t prefix;
  block_scan(s, warp_sums, prefix);
  for (long long base = first; base < last; base += kChunk) {
    uint4* p = reinterpret_cast<uint4*>(out + base + threadIdx.x * kPerThread);
    uint4 v = *p;
    v.x += prefix; v.y += prefix; v.z += prefix; v.w += prefix;
    *p = v;
  }
  const long long i0 = last + threadIdx.x * kPerThread;
  if (i0 + kPerThread <= end) {
    *reinterpret_cast<uint4*>(out + i0) =
        make_uint4(x[0] + prefix, x[1] + prefix, x[2] + prefix, x[3] + prefix);
  } else {
    for (int k = 0; k < kPerThread && i0 + k < end; ++k) out[i0 + k] = x[k] + prefix;
  }
}

// Co-resident blocks of decode_scan_kernel<W> on `device`: the occupancy
// maximum per SM times the SM count, queried once.
template <int W>
int max_grid(int device, cudaError_t* err) {
  static int cached[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) {
    *err = cudaErrorInvalidDevice;
    return 0;
  }
  if (cached[device] == 0) {
    int sms = 0, per_sm = 0;
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (*err == cudaSuccess)
      *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_scan_kernel<W>,
                                                           kThreads, 0);
    if (*err != cudaSuccess) return 0;
    cached[device] = sms * per_sm < kMaxGrid ? sms * per_sm : kMaxGrid;
  }
  return cached[device];
}

template <int W>
cudaError_t launch(const uint8_t* c, uint32_t* out, uint32_t* totals, long long n,
                   cudaStream_t stream) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const int g_max = max_grid<W>(device, &err);
  if (err != cudaSuccess) return err;
  if (g_max <= 0) return cudaErrorCooperativeLaunchTooLarge;
  const long long chunks = (n + kChunk - 1) / kChunk;
  const long long per_block = (chunks + g_max - 1) / g_max;
  long long span = per_block * kChunk;
  int grid = (int)((n + span - 1) / span);
  void* args[] = {(void*)&c, (void*)&out, (void*)&totals, (void*)&n, (void*)&span};
  return cudaLaunchCooperativeKernel((const void*)decode_scan_kernel<W>, dim3(grid),
                                     dim3(kThreads), args, 0, stream);
}

}  // namespace

// One cooperative launch on `stream`; returns its error (or
// cudaGetLastError()), e.g. cudaErrorCooperativeLaunchTooLarge when the grid
// cannot be co-resident.  Allocates nothing.  c: at least n * fixed_w bytes,
// any alignment; out: n u32 followed by min(ceil(n / 4096), 1024) u32 of
// scratch; 0 < n and n * fixed_w < 2^31 (the Python wrapper checks them).
extern "C" int infw_decode_scan(const void* c, void* out, int n, int fixed_w, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const uint8_t* cb = (const uint8_t*)c;
  uint32_t* o = (uint32_t*)out;
  uint32_t* totals = o + n;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  switch (fixed_w) {
    case 1: err = launch<1>(cb, o, totals, n, s); break;
    case 2: err = launch<2>(cb, o, totals, n, s); break;
    case 4: err = launch<4>(cb, o, totals, n, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}
