// The LPM on the int8 tensor cores, shared by K1 (dense_classify.cu, one
// table for every packet) and K6 (arena_dense.cu, each packet against its
// tenant's slab): the packet's A fragments built from its five key words,
// the B fragments read by ldmatrix from planes staged in shared memory, the
// mma.sync.m16n8k32 s8 x s8 -> s32 product and the score epilogue.
//
// The formulation (the TPU kernel's own): the 160-bit key (ifindex ||
// source IP, big-endian bits) as 0/1 bytes against each row's plane
// M0 - M1 in {-1, 0, 1} (M0 = mask & ~prefix, M1 = mask & prefix), so that
// bits . plane_t + rowsum(M1)_t is the count of in-mask mismatching bits,
// never negative, and zero iff row t matches.  A row's constant
//   c_t = key_t - kBig * rowsum(M1)_t,  0 < key_t < kBig,
// makes score_t = c_t - kBig * (bits . plane_t) equal key_t for a match and
// negative otherwise; key_t packs the score (mask_len + 1) above a tie
// field that is larger for lower rows, so the maximum is the first longest
// match.  With at most 160 mismatches, kBig * 160 + key_t < 2^31.
//
// Layouts in shared memory: plane rows of kRowBytes (160 bytes of M0 - M1,
// padded so that the eight rows of an ldmatrix land in distinct banks), the
// constants as int32 beside them.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lpm {

constexpr int kKeyBytes = 160;
constexpr int kRowBytes = 176;  // staged plane row, padded
constexpr int kMTiles = 2;      // 16-packet tiles per warp
constexpr int kWarpPackets = kMTiles * 16;
constexpr int kBig = 1 << 21;
constexpr int kNever = -(1 << 30);  // the constant of a row that never matches

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 0/1 bytes from bits [4 * q, 4 * q + 4) of r (byte j = bit 4q + j).
__device__ __forceinline__ uint32_t spread_nibble(uint32_t r, int q) {
  return (((r >> (4 * q)) & 0xFu) * 0x00204081u) & 0x01010101u;
}

// Rows g (h = 0) and g + 8 (h = 1) of a 16-packet tile's A fragments over
// the five k-steps, from that packet's key words (lane quad position q).
__device__ __forceinline__ void key_fragments(uint32_t (&a)[5][4], int h, const uint32_t (&key)[5],
                                              int q) {
#pragma unroll
  for (int ks = 0; ks < 5; ++ks) {
    const uint32_t r = __brev(key[ks]);  // bit k of r = big-endian bit k
    a[ks][h] = spread_nibble(r, q);          // k = 4q .. 4q + 3
    a[ks][2 + h] = spread_nibble(r, 4 + q);  // k = 16 + 4q ..
  }
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}

// The ldmatrix row address of this lane: plane row (lane & 7) of an
// n-tile, 16-byte column (lane >> 3) of a 64-byte k-step pair.
__device__ __forceinline__ uint32_t lane_address(const uint8_t* planes, int lane) {
  return smem_addr(planes) + (lane & 7) * kRowBytes + (lane >> 3) * 16;
}

// NT n-tiles of 8 staged rows from `row` against the warp's kMTiles packet
// tiles over k-steps K0 .. K0 + NKS - 1: NT x kMTiles independent products
// per k-step keep the tensor pipe busy across the mma latency; then
// score = c - kBig * dot and a running max per packet row.
template <int K0, int NKS, int NT>
__device__ __forceinline__ void walk_tiles(const uint32_t (&a)[kMTiles][5][4], uint32_t lane_addr,
                                           const int* sm_const, int row, int q,
                                           int (&mx)[kMTiles][2]) {
  uint32_t b[NT][NKS > 0 ? NKS : 1][2];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const uint32_t addr = lane_addr + (row + 8 * n) * kRowBytes + 32 * K0;
#pragma unroll
    for (int ks = 0; ks < NKS; ks += 2) {
      if (ks + 1 < NKS) {
        uint32_t r[4];
        ldmatrix_x4(r, addr + 32 * ks);
        b[n][ks][0] = r[0]; b[n][ks][1] = r[1]; b[n][ks + 1][0] = r[2]; b[n][ks + 1][1] = r[3];
      } else {
        uint32_t r[2];
        ldmatrix_x2(r, addr + 32 * ks);
        b[n][ks][0] = r[0]; b[n][ks][1] = r[1];
      }
    }
  }
  int d[NT][kMTiles][4] = {};
#pragma unroll
  for (int ks = 0; ks < NKS; ++ks)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int m = 0; m < kMTiles; ++m) mma_s8(d[n][m], a[m][K0 + ks], b[n][ks][0], b[n][ks][1]);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    // d[n][m][0], [1]: row g, entries 2q, 2q + 1; [2], [3]: row g + 8
    const int2 c = *reinterpret_cast<const int2*>(sm_const + row + 8 * n + 2 * q);
#pragma unroll
    for (int m = 0; m < kMTiles; ++m) {
      mx[m][0] = __vimax3_s32(mx[m][0], c.x - kBig * d[n][m][0], c.y - kBig * d[n][m][1]);
      mx[m][1] = __vimax3_s32(mx[m][1], c.x - kBig * d[n][m][2], c.y - kBig * d[n][m][3]);
    }
  }
}

// Staged rows [lo, hi) (a multiple of 8 apart), two n-tiles at a time.
template <int K0, int NKS>
__device__ __forceinline__ void walk_rows(const uint32_t (&a)[kMTiles][5][4], uint32_t lane_addr,
                                          const int* sm_const, int lo, int hi, int q,
                                          int (&mx)[kMTiles][2]) {
  int row = lo;
  for (; row + 16 <= hi; row += 16) walk_tiles<K0, NKS, 2>(a, lane_addr, sm_const, row, q, mx);
  if (row < hi) walk_tiles<K0, NKS, 1>(a, lane_addr, sm_const, row, q, mx);
}

// The maximum over a lane quad (the four lanes that hold one packet row).
__device__ __forceinline__ int quad_max(int v) {
  v = max(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return max(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

}  // namespace lpm
