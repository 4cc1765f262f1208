// K6 on Hopper: the dense-family arena's compare-all LPM and rule scan,
// one warp per packet: each packet compares against the S rows of ITS
// tenant's slab (tenant -> page table -> slab rows), takes the first
// longest match and scans that row's packed rules.
//
// Replaces no Pallas kernel: in the JAX package this is XLA,
// infw/kernels/jaxpath.py:arena_dense_result_and_score (:3755), under
// classify_arena_dense (:3784), the overlay side of
// classify_arena_with_overlay (:3907) and the dense branches of
// jitted_classify_arena_wire_fused (:3943-3957): a (B, S, 5) gather of key
// and mask words, the masked compare, argmax over the score mask_len + 1,
// the winning row's rules gathered and rule_scan.  Same function, bit for
// bit: for each packet (result, score) with score = mask_len + 1 of the
// first (lowest-row) entry of the tenant's slab whose masked key equals
// the packet's (ifindex, source IP) key and whose mask_len is in [0, cap]
// (cap 32 for IPv4, 128 for every other kind), 0 when none, and result =
// (ruleId << 8) | action of that row's first hitting rule as stored (0
// when no row matches).  A tenant outside [0, MT) or whose page-table row
// is negative scores 0 on every row (UNDEF).  Row indices clip to the
// pool as XLA's take does.
//
// What bounds it on this card: the rows it reads.  Every packet reads its
// slab's mask_len column (4 bytes a row) and the key and mask words of the
// rows whose mask length is within the cap and could still win (40 bytes a
// row): 44 KiB a packet at S = 1024, from L2 when the pool fits there (a
// 512-tenant pool of 1024 rows is 23 MiB of them).  The device-memory
// bound, each pool byte read once, is far lower: the simple design here
// reads the slab once per packet.  Design: one warp per packet, its 32
// lanes striding the slab's rows (coalesced 128-byte reads of mask_len,
// 640-byte reads of the key and mask rows), a row skipped when its mask
// length cannot beat the lane's best; a warp reduction of (score, lowest
// row); then one lane scans the row's rules (ctrie_walk.cuh scan_rules).
// A later design would sort packets by tenant and stage each slab through
// shared memory once per block.
//
// Two entry points over the same lookup:
// - infw_arena_dense_walk: (fields, words, tenant) -> (B, 2) [result,
//   score], the overlay combine's operand (both sides of an arena overlay);
// - infw_arena_dense_fused: the whole device pass of a mixed-tenant
//   classify in one launch, wire and tenant column to the read-back buffer
//   (jaxpath.jitted_classify_arena_wire_fused("dense") without an
//   overlay), as K3b's fused entry: the wire decoded in registers (wire_io
//   .cuh), the lookup skipped for lanes finalize zeroes, the u16 result
//   written in place, the statistics summed per block in shared memory over
//   a persistent grid; one memset and one kernel per pass.
//
// Layouts (infw_torch/arena.py:DenseArena; P pages of S rows, N = P * S):
//   fields     (B, 8) i32: kind, ifindex, proto, dport, icmpType, icmpCode,
//                          l4_ok, pkt_len
//   words      (B, 4) u32: source-IP words, big-endian
//   tenant     (B,) i32:   tenant id per packet
//   page_table (MT,) i32:  tenant -> page, -1 = absent
//   key_words  (N, 5) u32: [ifindex, ip words 0-3] of each entry's key
//   mask_words (N, 5) u32: the entry's 160-bit mask
//   mask_len   (N,) i32:   prefix length, -1 = padding
//   rules      (N, 5R) u16: packed rule rows (ctrie_walk.cuh's layout)
//   out        (B, 2) i32: result, score (infw_arena_dense_walk); the fused
//                          entry's wire and read-back buffer: wire_io.cuh
#include <cuda_runtime.h>
#include <stdint.h>

#include "ctrie_walk.cuh"
#include "wire_io.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps, one packet each at a time
constexpr int kWarps = kThreads / 32;

struct Pool {
  const int* page_table;
  const uint32_t* key_words;
  const uint32_t* mask_words;
  const int* mask_len;
  const uint16_t* rules;
  int MT, S, n_rows, R;
};

// The warp's lookup for one packet (every lane holds the same operands and
// gets the same answer): (result, score).  Warp-uniform control flow.
__device__ __forceinline__ int2 lookup(const Pool pool, int t, int kind, uint32_t ifx,
                                       const uint4& w, int proto, int dport, int itype,
                                       int icode, int lane) {
  const int pg = (t >= 0 && t < pool.MT) ? __ldg(pool.page_table + t) : -1;
  if (pg < 0) return make_int2(0, 0);  // invalid tenant: no row matches
  const long long base = (long long)pg * pool.S;
  const long long last = (long long)pool.n_rows - 1;
  const int cap = kind == wire_io::kKindIPv4 ? 32 : 128;
  int best = 0;          // this lane's best score
  int best_row = pool.S; // its lowest row with that score
  for (int r = lane; r < pool.S; r += 32) {
    long long g = base + r;
    g = g < 0 ? 0 : (g > last ? last : g);
    const int ml = __ldg(pool.mask_len + g);
    // padding (-1), over the packet's cap, or no better than this lane's
    // best (rows rise, so an equal score later never wins)
    if (ml < 0 || ml > cap || ml + 1 <= best) continue;
    const uint32_t* k = pool.key_words + g * 5;
    const uint32_t* m = pool.mask_words + g * 5;
    const bool hit = ((ifx ^ __ldg(k)) & __ldg(m)) == 0u &&
                     ((w.x ^ __ldg(k + 1)) & __ldg(m + 1)) == 0u &&
                     ((w.y ^ __ldg(k + 2)) & __ldg(m + 2)) == 0u &&
                     ((w.z ^ __ldg(k + 3)) & __ldg(m + 3)) == 0u &&
                     ((w.w ^ __ldg(k + 4)) & __ldg(m + 4)) == 0u;
    if (hit) {
      best = ml + 1;
      best_row = r;
    }
  }
  // the warp's (highest score, lowest row): the argmax's first maximum
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int ob = __shfl_xor_sync(0xffffffffu, best, d);
    const int orow = __shfl_xor_sync(0xffffffffu, best_row, d);
    if (ob > best || (ob == best && orow < best_row)) {
      best = ob;
      best_row = orow;
    }
  }
  if (best == 0) return make_int2(0, 0);  // zeroed rule rows scan to 0
  long long g = base + best_row;
  g = g < 0 ? 0 : (g > last ? last : g);
  const int result = ctrie::scan_rules(pool.rules + g * 5 * pool.R, pool.R, kind, proto, dport,
                                       itype, icode);
  return make_int2(result, best);
}

__global__ void __launch_bounds__(kThreads)
arena_dense_walk_kernel(const int4* __restrict__ fields, const uint4* __restrict__ words,
                        const int* __restrict__ tenant, Pool pool, int2* __restrict__ out,
                        int B) {
  const long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= B) return;  // warp-uniform
  const int4 f0 = fields[2 * i];
  const int4 f1 = fields[2 * i + 1];
  const uint4 w = words[i];
  const int2 r = lookup(pool, __ldg(tenant + i), f0.x, (uint32_t)f0.y, w, f0.z, f0.w, f1.x,
                        f1.y, lane);
  if (lane == 0) out[i] = r;
}

// The fused pass over a (B, W) wire and its tenant column: warp k of the
// grid takes packets k, k + warps, ...
template <int W>
__global__ void __launch_bounds__(kThreads)
arena_dense_fused_kernel(const uint32_t* __restrict__ wire, const int* __restrict__ tenant,
                         Pool pool, uint32_t* __restrict__ out, int B) {
  __shared__ uint32_t tab[wire_io::kBlockCells];
  uint32_t* stats = out + (B + 1) / 2;
  wire_io::zero_stats(tab);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long i = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); i < B; i += stride) {
    const wire_io::Packet p = wire_io::decode<W>(wire, i, nullptr, 0);
    int result = 0;
    if (wire_io::looked_up(p)) {  // warp-uniform: every lane decoded row i
      result = lookup(pool, __ldg(tenant + i), p.kind, (uint32_t)p.ifindex, p.w, p.proto,
                      p.dport, p.itype, p.icode, lane).x;
    }
    if (lane == 0) {
      wire_io::put_res16(out, i, result);
      wire_io::add_stats(tab, stats, result, p.pkt_len);
    }
  }
  wire_io::flush_stats(tab, stats);
}

template <int W>
cudaError_t launch_fused(const uint32_t* wire, const int* tenant, const Pool& pool,
                         uint32_t* out, int B, int max_grid, cudaStream_t stream) {
  static int cached[wire_io::kMaxDevices];
  int grid = 0;
  // one warp per packet: the work in threads is 32 B
  const cudaError_t err = wire_io::persistent_grid(arena_dense_fused_kernel<W>, kThreads, cached,
                                                   32LL * B, max_grid, &grid);
  if (err != cudaSuccess) return err;
  arena_dense_fused_kernel<W><<<grid, kThreads, 0, stream>>>(wire, tenant, pool, out, B);
  return cudaGetLastError();
}

Pool make_pool(const void* page_table, const void* key_words, const void* mask_words,
               const void* mask_len, const void* rules, int MT, int S, int n_rows, int R) {
  return Pool{(const int*)page_table, (const uint32_t*)key_words, (const uint32_t*)mask_words,
              (const int*)mask_len, (const uint16_t*)rules, MT, S, n_rows, R};
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); allocates nothing.
// fields, words and out 16-byte aligned; S >= 1 rows a slab, n_rows the
// pool's rows (the Python wrapper checks).
extern "C" int infw_arena_dense_walk(const void* fields, const void* words, const void* tenant,
                                     const void* page_table, const void* key_words,
                                     const void* mask_words, const void* mask_len,
                                     const void* rules, void* out, int B, int MT, int S,
                                     int n_rows, int R, void* stream) {
  if (B > 0) {
    const Pool pool =
        make_pool(page_table, key_words, mask_words, mask_len, rules, MT, S, n_rows, R);
    const long long grid = (32LL * B + kThreads - 1) / kThreads;
    arena_dense_walk_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int4*)fields, (const uint4*)words, (const int*)tenant, pool, (int2*)out, B);
  }
  return (int)cudaGetLastError();
}

// The fused pass on `stream`: one memset of `out`'s statistics and last
// result word, then one launch (none for B = 0); returns the first error,
// else cudaGetLastError().  Allocates nothing.  `out` holds
// wire_io::out_words(B, true) words; `width` is 7, 6, 4 or 3.  max_grid >
// 0 caps the grid (tests); 0 takes the resident blocks.
extern "C" int infw_arena_dense_fused(const void* wire, const void* tenant,
                                      const void* page_table, const void* key_words,
                                      const void* mask_words, const void* mask_len,
                                      const void* rules, void* out, int B, int width, int MT,
                                      int S, int n_rows, int R, int max_grid, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  uint32_t* o = (uint32_t*)out;
  if (width != 3 && width != 4 && width != 6 && width != 7) return (int)cudaErrorInvalidValue;
  const Pool pool = make_pool(page_table, key_words, mask_words, mask_len, rules, MT, S, n_rows, R);
  cudaError_t err = wire_io::clear_out(o, B, true, s);
  if (err == cudaSuccess && B > 0) {
    const uint32_t* wp = (const uint32_t*)wire;
    const int* tp = (const int*)tenant;
    switch (width) {
      case 3: err = launch_fused<3>(wp, tp, pool, o, B, max_grid, s); break;
      case 4: err = launch_fused<4>(wp, tp, pool, o, B, max_grid, s); break;
      case 6: err = launch_fused<6>(wp, tp, pool, o, B, max_grid, s); break;
      default: err = launch_fused<7>(wp, tp, pool, o, B, max_grid, s); break;
    }
  }
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}
