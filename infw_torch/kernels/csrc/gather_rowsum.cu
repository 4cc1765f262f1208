// K5 on Hopper: row gather + row sum, one warp per index.
//
// Replaces the TPU kernel in tools/profile_gather.py (`kern`, launched by
// `pstep` through pl.pallas_call): for each index, clipped to the table's
// rows, the sum of that table row's uint32 words with uint32 wrap.  The
// Pallas kernel holds the whole (4096, 128) u32 table in VMEM, takes 1024
// indices per grid step and gathers their rows with jnp.take.
//
// What differs here and why: the 2 MiB table does not fit a block's shared
// memory (227 KB), but it sits in the 50 MB L2 after the first touches, so
// every row read is a direct load that hits L2.  One warp serves one index:
// each lane loads 16 bytes (a uint4) of the row per step, so a 512-byte row
// is one coalesced warp-wide load, and a shuffle tree sums the 32 partial
// sums.  Row reads wrap in uint32 arithmetic, as the Pallas sum does.
//
// What bounds it on this card: the bytes it must move from device memory,
// each index and output once and the table once (10.5 MB at B = 2^20),
// about 3.1 us at 3.35 TB/s; the 512 MiB of row reads come from L2 and are
// not in that bound, so in practice L2 bandwidth and the warp's load
// latency bound it.
//
// Layouts:
//   idx    (B,) i32
//   table  (N, W) u32, W a multiple of 4, 16-byte aligned rows
//   out    (B,) u32
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps, one index each
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
gather_rowsum_kernel(const int* __restrict__ idx, const uint4* __restrict__ table,
                     uint32_t* __restrict__ out, int B, int N, int W4) {
  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= B) return;
  const int r = min(max(__ldg(idx + i), 0), N - 1);  // clipped, as the caller's jnp.clip
  const uint4* row = table + (size_t)r * W4;
  uint32_t s = 0;
  for (int c = lane; c < W4; c += 32) {
    const uint4 v = __ldg(row + c);
    s += v.x + v.y + v.z + v.w;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xFFFFFFFFu, s, off);
  if (lane == 0) out[i] = s;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); allocates nothing.
// N >= 1, W a multiple of 4, every pointer 16-byte aligned (the Python
// wrapper checks).
extern "C" int infw_gather_rowsum(const void* idx, const void* table, void* out, int B, int N,
                                  int W, void* stream) {
  if (B > 0) {
    const long long grid = ((long long)B + kWarps - 1) / kWarps;
    gather_rowsum_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)idx, (const uint4*)table, (uint32_t*)out, B, N, W / 4);
  }
  return (int)cudaGetLastError();
}
