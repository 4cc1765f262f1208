// K5 on Hopper: row gather + row sum, each table row summed once.
//
// Replaces the TPU kernel in tools/profile_gather.py (`kern`, launched by
// `pstep` through pl.pallas_call): for each index, clipped to the table's
// rows, the sum of that table row's uint32 words with uint32 wrap.  The
// Pallas kernel holds the whole (4096, 128) u32 table in VMEM, takes 1024
// indices per grid step and gathers their rows with jnp.take.
//
// What bounds it on this card: bytes.  The function must read each index
// once and the table once and write each sum once: at B = 2^20 over a
// (4096, 128) table that is 4 + 2 + 4 MiB, 10.5 MB, 3.1 us at 3.35 TB/s.
// The row-sum scratch and its staging below are this design's, not the
// function's, and are not counted.
//
// Why the earlier design (one warp per index, each warp reading its whole
// 512-byte row) could not reach that bound: 2^20 indices read 512 MiB of
// rows to write 4 MiB of sums.  Those reads hit L2, and at 0.106 ms they
// ran at about 5.1 TB/s, the L2 read rate: no tuning of that design gets
// near 10.5 MB.
//
// What this design does about it: a row's sum depends on the row alone,
// and a uint32 sum that wraps is associative and commutative, so summing
// each row once gives the same bits.  One cooperative launch, two phases
// and one grid barrier:
//   1. row sums: warps take rows grid-stride; a row of W/4 16-byte pieces
//      takes L lanes (the least power of two >= W/4, at most 32, so a warp
//      sums 32/L narrow rows at once), each lane loads a uint4 per step, a
//      shuffle tree reduces the L lanes and the first writes the row's sum
//      into the (N,) scratch.  The table is read once.  Before this phase
//      each thread issues the 16-byte load of its first four indices, so
//      that load's latency overlaps the row sums and the barrier;
//   2. cooperative_groups::this_grid().sync();
//   3. gather: each block that has indices to serve copies the N row sums
//      into dynamic shared memory with cp.async (16-byte pieces, through
//      L2, where phase 1's stores are), then each thread serves four
//      consecutive indices a step (one 16-byte load, a clip of each index,
//      four shared-memory reads, one 16-byte store); the first B % 4
//      threads serve the ragged tail one index each.
// Above kStageCapBytes of row sums (N > 51,200) phase 3 stages nothing and
// reads each sum from the scratch through L2 (__ldcg: written in this
// launch, so not through the non-coherent read-only path).  The launcher
// picks the branch from N, as a template flag; both are exact.
//
// Grid: blocks of 1024 threads, since every block that serves indices
// stages N * 4 bytes of L2; wire_io::persistent_grid gives the co-resident
// count (one or two blocks an SM at N = 4096), capped by the work (one
// thread per four indices, L lanes per row) and, for tests, by max_grid.
//
// Layouts:
//   idx    (B,) i32, 16-byte aligned
//   table  (N, W) u32, W a multiple of 4, 16-byte aligned rows
//   sums   (round_up(N, 4),) u32 scratch, 16-byte aligned
//   out    (B,) u32, 16-byte aligned
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wire_io.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;
constexpr int kStageCapBytes = 200 * 1024;  // row sums a block stages at most
constexpr int kTierBytes = 8 * 1024;        // occupancy is queried per 8 KiB of staging
constexpr int kTiers = kStageCapBytes / kTierBytes + 1;

struct Args {
  const int* idx;
  const uint4* table;
  uint32_t* sums;
  uint32_t* out;
  long long B;
  int N;
  int W4;     // 16-byte pieces a row
  int lanes;  // lanes a row in phase 1: a power of two, at most 32
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               ::"r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src));
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads, 2) gather_rowsum_kernel(Args a) {
  extern __shared__ uint4 staged[];  // kStaged: the row sums, whole 16-byte pieces
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * kThreads;
  const long long groups = a.B >> 2;
  const int4* idx4 = reinterpret_cast<const int4*>(a.idx);
  int4 first = make_int4(0, 0, 0, 0);
  if (tid < groups) first = __ldcs(idx4 + tid);

  // 1. row sums, each row once
  const int lane = threadIdx.x & 31;
  const int per_warp = 32 / a.lanes;
  const int sub = lane / a.lanes;
  const int sl = lane & (a.lanes - 1);
  const long long step = (nthreads >> 5) * per_warp;
  for (long long r0 = (tid >> 5) * per_warp; r0 < a.N; r0 += step) {  // warp-uniform
    const long long r = r0 + sub;
    uint32_t s = 0;
    if (r < a.N) {
      const uint4* row = a.table + r * a.W4;
      for (int c = sl; c < a.W4; c += a.lanes) {
        const uint4 v = __ldg(row + c);
        s += v.x + v.y + v.z + v.w;
      }
    }
    for (int off = a.lanes >> 1; off > 0; off >>= 1) s += __shfl_xor_sync(0xFFFFFFFFu, s, off);
    if (sl == 0 && r < a.N) a.sums[r] = s;
  }

  cg::this_grid().sync();

  // 3. gather; a block with no index to serve stops here
  const long long tail = a.B & 3;
  if ((long long)blockIdx.x * kThreads >= (groups > tail ? groups : tail)) return;
  if constexpr (kStaged) {
    const int pieces = (int)(((long long)a.N + 3) >> 2);
    const uint4* src = reinterpret_cast<const uint4*>(a.sums);
    for (int p = threadIdx.x; p < pieces; p += kThreads) cp_async16(staged + p, src + p);
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
    __syncthreads();
  }
  const int last = a.N - 1;
  auto sum_of = [&](int i) -> uint32_t {
    const int r = min(max(i, 0), last);  // clipped, as the caller's jnp.clip
    if constexpr (kStaged) return reinterpret_cast<const uint32_t*>(staged)[r];
    else return __ldcg(a.sums + r);
  };
  uint4* out4 = reinterpret_cast<uint4*>(a.out);
  for (long long g = tid; g < groups; g += nthreads) {
    const int4 v = g == tid ? first : __ldcs(idx4 + g);
    __stcs(out4 + g, make_uint4(sum_of(v.x), sum_of(v.y), sum_of(v.z), sum_of(v.w)));
  }
  if (tid < tail) {
    const long long i = (groups << 2) + tid;
    a.out[i] = sum_of(__ldcs(a.idx + i));
  }
}

// One cooperative launch of gather_rowsum_kernel<kStaged> on `stream`.
template <bool kStaged>
cudaError_t launch(const Args& a, int max_grid, cudaStream_t stream) {
  static int cached[kStaged ? kTiers : 1][wire_io::kMaxDevices];
  static bool smem_set[wire_io::kMaxDevices];
  const size_t smem = kStaged ? (size_t)(((long long)a.N + 3) >> 2) * 16 : 0;
  const int tier = (int)((smem + kTierBytes - 1) / kTierBytes);
  cudaError_t err;
  if (kStaged) {
    int device = 0;
    err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    if (device < 0 || device >= wire_io::kMaxDevices) return cudaErrorInvalidDevice;
    if (!smem_set[device]) {
      err = cudaFuncSetAttribute(gather_rowsum_kernel<kStaged>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kStageCapBytes);
      if (err != cudaSuccess) return err;
      smem_set[device] = true;
    }
  }
  const long long rows = (long long)a.N * a.lanes, quads = (a.B + 3) >> 2;
  int grid = 0;
  // occupancy at the tier's upper bound, at least the launch's shared
  // memory, so the grid is always co-resident
  err = wire_io::persistent_grid(gather_rowsum_kernel<kStaged>, kThreads, cached[tier],
                                 rows > quads ? rows : quads, max_grid, &grid,
                                 (size_t)tier * kTierBytes);
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&a};
  return cudaLaunchCooperativeKernel((const void*)gather_rowsum_kernel<kStaged>, dim3(grid),
                                     dim3(kThreads), args, smem, stream);
}

}  // namespace

// One cooperative launch on `stream` (none for B = 0); returns its error,
// else cudaGetLastError() (e.g. cudaErrorCooperativeLaunchTooLarge).
// Allocates nothing.  N >= 1, W a multiple of 4, every pointer 16-byte
// aligned, `sums` round_up(N, 4) u32 of scratch (the Python wrapper checks
// and allocates).  max_grid > 0 caps the grid (tests); 0 takes the
// co-resident grid.
extern "C" int infw_gather_rowsum(const void* idx, const void* table, void* sums, void* out,
                                  int B, int N, int W, int max_grid, void* stream) {
  cudaError_t err = cudaSuccess;
  if (B > 0) {
    if (N < 1 || W < 0 || W % 4) return (int)cudaErrorInvalidValue;
    Args a{(const int*)idx, (const uint4*)table, (uint32_t*)sums, (uint32_t*)out, B, N, W / 4, 1};
    while (a.lanes < a.W4 && a.lanes < 32) a.lanes <<= 1;
    const cudaStream_t s = (cudaStream_t)stream;
    err = (((long long)N + 3) >> 2) * 16 <= kStageCapBytes ? launch<true>(a, max_grid, s)
                                                            : launch<false>(a, max_grid, s);
  }
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}
