// K6 on Hopper: the dense-family arena's compare-all LPM and rule scan.
// Each packet compares against the S rows of ITS tenant's slab (tenant ->
// page table -> slab rows), takes the first longest match and scans that
// row's packed rules.
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
// What bounds it on this card: operations.  B packets x the live rows of
// their slabs, 160 key bits each: 2^20 x ~920 x 160 multiply-adds at 512
// tenants x S = 1024 rows, the same product K1 computes for one table.  A
// warp per packet reading its slab from L2 (the design before this one)
// moves the slab once per packet, ~40 KB each, at the card's L2 rate.  So
// this design groups the packets by slab and turns each group into K1's
// product: one cooperative launch of one block per SM (512 threads, 219 KB
// of shared memory), phases 0-4 four grid barriers apart, then phase 5 in
// a launch of its own:
//   0. zero the bucket counters (scratch, allocated by the wrapper);
//   1. bucket each packet: its page (tenant -> page_table), the clip page
//      P for a page past the pool (every row index clips to the last row),
//      or "none" (P + 1): an invalid or absent tenant, and in the fused
//      entry a lane finalize zeroes; counted per block in shared memory
//      (warp-aggregated), then one global atomic per block and bucket;
//   2. block 0 scans the counts: each bucket's first slot, and each page's
//      first 512-packet tile;
//   3. scatter: each block reserves its range of every bucket with one
//      atomic, then each packet takes a slot of the page-ordered
//      permutation (warp-aggregated shared-memory atomics); a "none"
//      packet never enters the LPM (no winning row);
//   4. the LPM: the grid splits the tiles into contiguous ranges; a block
//      works through its tiles and restages a slab only when the page
//      changes (or, for S above kChunk rows, per chunk).  Staging copies
//      the slab's rows into shared memory with cp.async in two passes: the
//      first copies every row's mask words and mask_len (24 bytes) at once
//      and sorts the live rows (mask_len 0..128) into ten groups, (longer
//      than /32) x (k-steps: the key words their masks cover); the second
//      streams the rows (key, mask, mask_len: 44 bytes) double-buffered 256
//      at a time and builds in their group slots K1's operands: the int8
//      plane M0 - M1
//      (176-byte rows) and the constant c = key - kBig * rowsum(M1), key =
//      (mask_len + 1) << 10 | (1023 - the row within its chunk).  Each
//      group is padded to 8 rows with never-matching ones.  Then each warp
//      runs lpm_mma.cuh's product (mma.sync m16n8k32 s8, ldmatrix) over
//      its 32 packets: the groups of mask_len <= 32 into one running
//      maximum, the longer ones into another (an IPv4 packet takes only the
//      first), only the k-steps a group needs; across chunks a later
//      chunk wins only with a strictly longer match, so ties go to the
//      lowest row for any S and the key never outgrows kBig.  Each packet's
//      (winning pool row, score) goes to scratch at its own index;
//   5. the ordered rule scan of the winning row (ctrie_walk.cuh
//      scan_rules, rules from L2), one thread per packet in batch order at
//      full occupancy, and the output: the u16 result and the per-block
//      shared-memory statistics (fused), or (result, score) (two-column).
//      In the LPM's block the scan ran 1.10-1.17x slower: one fat block per
//      SM hides too little of its dependent loads (as K1 found).
// Scratch written in the launch is read through L2 (__ldcg): L1 is not
// coherent across SMs.  Nothing is cached between calls: arena patches
// write the pool in place, so every launch stages what the pool holds then.
//
// Two entry points over the same two kernels, two launches each (plus, in
// the fused entry, one memset of the statistics):
// - infw_arena_dense_walk: (fields, words, tenant) -> (B, 2) [result,
//   score], the overlay combine's operand (both sides of an arena overlay);
// - infw_arena_dense_fused: the whole device pass of a mixed-tenant
//   classify, wire and tenant column to the read-back buffer
//   (jaxpath.jitted_classify_arena_wire_fused("dense") without an
//   overlay), as K3b's fused entry: the wire decoded in registers (wire_io
//   .cuh), the u16 result written in place, the statistics summed per block.
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
//   scratch    i32:        total, cursor (P + 2 each), start (P + 3),
//                          tile_start (P + 2), perm (B), then from an even
//                          word (B, 2) (winning row or -1, score)
//   out        (B, 2) i32: result, score (infw_arena_dense_walk); the fused
//                          entry's wire and read-back buffer: wire_io.cuh
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "ctrie_walk.cuh"
#include "lpm_mma.cuh"
#include "wire_io.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace lpm;

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kTilePackets = kWarps * kWarpPackets;  // 512 packets of one page
constexpr int kChunk = 1024;                         // slab rows staged at once
constexpr int kTieBits = 10;                         // key = (mask_len + 1) << 10 | tie
constexpr int kGroups = 10;                          // (longer than /32) x (1..5 k-steps)
constexpr int kPlaneRows = kChunk + kGroups * 7 + 2; // each group padded to 8 rows
constexpr int kSubRows = 256;                        // rows of one pass-2 copy stage
constexpr int kRawWords = 11;                        // key, mask words and mask_len of a row
constexpr int kMaskWords = 6;                        // a row's mask words and mask_len (pass 1)
constexpr int kDead = 0xFFFF;                        // slot code of a row left out
constexpr int kPerThread = 4;                        // packets per thread and step, phases 1, 3
static_assert(kChunk == 1 << kTieBits, "the tie field holds a row of the chunk");
static_assert(kPlaneRows % 8 == 0, "whole n-tiles");

// Dynamic shared memory, in bytes from its base: the planes (whose space
// holds the bucket counts in phases 1-3), the constants, the copy stages,
// the slot codes and the group table.
constexpr int kPlanesAt = 0;
constexpr int kConstAt = kPlaneRows * kRowBytes;
constexpr int kRawAt = kConstAt + kPlaneRows * 4;
constexpr int kRawBytes = kChunk * kMaskWords * 4;  // pass 1's rows, or pass 2's two stages
static_assert(2 * kSubRows * kRawWords * 4 <= kRawBytes, "two pass-2 stages in the copy area");
constexpr int kSlotAt = kRawAt + kRawBytes;
constexpr int kMiscAt = kSlotAt + kChunk * 2;
constexpr int kMiscInts = 64;  // group counts and starts; the scan's warp sums
constexpr int kSmemBytes = kMiscAt + kMiscInts * 4;
constexpr int kHistBins = kConstAt / 4;  // buckets counted in shared memory
static_assert(kSmemBytes <= 232448, "above the 227 KB a block may have");
static_assert(kConstAt % 16 == 0 && kRawAt % 16 == 0, "alignment");

struct Pool {
  const int* page_table;
  const uint32_t* key_words;
  const uint32_t* mask_words;
  const int* mask_len;
  const uint16_t* rules;
  int MT, S, n_rows, R, P;
};

// Every operand of one launch (by value).  W > 0: a (B, W) wire, the fused
// entry; W == 0: (fields, words), the two-column entry.
struct Args {
  const uint32_t* wire;
  const int4* fields;
  const uint4* words;
  const int* tenant;
  Pool pool;
  int* total;       // (P + 2) packets per bucket
  int* cursor;      // (P + 2) slots reserved so far per bucket
  int* start;       // (P + 3) first slot per bucket, then B
  int* tile_start;  // (P + 2) first tile per page 0..P, then the tile count
  int* perm;        // (B) packet indices in bucket order
  int2* win;        // (B) (winning pool row or -1, score) per packet
  void* out;
  int B;
};

// The packet's classify operands.
template <int W>
__device__ __forceinline__ wire_io::Packet load_packet(const Args& a, long long i) {
  if constexpr (W > 0) {
    return wire_io::decode<W>(a.wire, i, nullptr, 0);
  } else {
    const int4 f0 = a.fields[2 * i], f1 = a.fields[2 * i + 1];
    wire_io::Packet p;
    p.w = a.words[i];
    p.kind = f0.x;
    p.ifindex = f0.y;
    p.proto = f0.z;
    p.dport = f0.w;
    p.itype = f1.x;
    p.icode = f1.y;
    p.l4_ok = f1.z;
    p.pkt_len = (uint32_t)f1.w;
    return p;
  }
}

// The output of a packet: the u16 result and its statistics (fused), or
// (result, score).
template <int W>
__device__ __forceinline__ void put_output(const Args& a, uint32_t* tab, long long i, int result,
                                           int score, uint32_t pkt_len) {
  if constexpr (W > 0) {
    uint32_t* out = (uint32_t*)a.out;
    wire_io::put_res16(out, i, result);
    wire_io::add_stats(tab, out + (a.B + 1) / 2, result, pkt_len);
  } else {
    ((int2*)a.out)[i] = make_int2(result, score);
  }
}

// Buckets of kPerThread packets from `first` (kThreads apart): page, the
// clip page P, or P + 1 ("none"); -1 past `end`.
template <int W>
__device__ __forceinline__ void buckets(const Args& a, long long first, long long end,
                                        int (&bk)[kPerThread]) {
  const Pool& pool = a.pool;
  int t[kPerThread];
  bool keep[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long i = first + (long long)k * kThreads;
    t[k] = i < end ? __ldg(a.tenant + i) : -1;
    keep[k] = i < end;
    if constexpr (W > 0) {
      // finalize zeroes every lane but IPv4 / IPv6 with an L4 header
      if (i < end) {
        wire_io::Packet p;
        const uint32_t w0 = __ldg(a.wire + (size_t)i * W);
        p.kind = (int)(w0 & 3u);
        p.l4_ok = (int)((w0 >> 2) & 1u);
        if (!wire_io::looked_up(p)) t[k] = -1;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int pg = (t[k] >= 0 && t[k] < pool.MT) ? __ldg(pool.page_table + t[k]) : -1;
    bk[k] = !keep[k] ? -1 : pg < 0 ? pool.P + 1 : min(pg, pool.P);
  }
}

// The lanes of this warp that hold the same bucket as this one.
__device__ __forceinline__ unsigned peers_of(int bk) { return __match_any_sync(0xffffffffu, bk); }

// A block barrier reached by converged warps only: the lanes of a warp
// leave divergent code (a lane past the tile, a lane without a match, a
// shorter copy loop) at different times, and bar.sync, ldmatrix and mma
// are warp-aligned instructions.
__device__ __forceinline__ void block_sync() {
  __syncwarp();
  __syncthreads();
}

// Phase 1: this block's packets [lo, hi) counted per bucket, into the
// shared-memory `hist` (then added to the global totals) or, when the
// buckets do not fit there, straight into the totals.
template <int W>
__device__ void count_buckets(const Args& a, long long lo, long long hi, int* hist, int nb,
                              bool in_smem) {
  const int lane = threadIdx.x & 31;
  if (in_smem) {
    for (int k = threadIdx.x; k < nb; k += kThreads) hist[k] = 0;
    block_sync();
  }
  for (long long base = lo; base < hi; base += (long long)kThreads * kPerThread) {
    int bk[kPerThread];
    buckets<W>(a, base + threadIdx.x, hi, bk);
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const unsigned peers = peers_of(bk[k]);
      if (bk[k] >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(in_smem ? hist + bk[k] : a.total + bk[k], __popc(peers));
    }
  }
  if (in_smem) {
    block_sync();
    for (int k = threadIdx.x; k < nb; k += kThreads)
      if (hist[k]) atomicAdd(a.total + k, hist[k]);
  }
}

// Phase 2 (one block): exclusive scans of the bucket totals (start) and of
// the pages' tile counts (tile_start, pages 0..P).
__device__ void scan_buckets(const Args& a, int* misc) {
  const int P = a.pool.P, nb = P + 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry_s = 0, carry_t = 0;
  for (int base = 0; base < nb; base += kThreads) {
    const int k = base + threadIdx.x;
    const int c = k < nb ? __ldcg(a.total + k) : 0;
    const int t = k <= P ? (c + kTilePackets - 1) / kTilePackets : 0;
    int xs = c, xt = t;  // inclusive within the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int ys = __shfl_up_sync(0xffffffffu, xs, d);
      const int yt = __shfl_up_sync(0xffffffffu, xt, d);
      if (lane >= d) {
        xs += ys;
        xt += yt;
      }
    }
    if (lane == 31) {
      misc[warp] = xs;
      misc[kWarps + warp] = xt;
    }
    block_sync();
    int ws = 0, wt = 0, ts = 0, tt = 0;  // warps before this one; the whole block
    for (int j = 0; j < kWarps; ++j) {
      ws += j < warp ? misc[j] : 0;
      wt += j < warp ? misc[kWarps + j] : 0;
      ts += misc[j];
      tt += misc[kWarps + j];
    }
    if (k < nb) a.start[k] = carry_s + ws + xs - c;
    if (k <= P) a.tile_start[k] = carry_t + wt + xt - t;
    carry_s += ts;
    carry_t += tt;
    block_sync();  // misc is read before the next round writes it
  }
  if (threadIdx.x == 0) {
    a.start[nb] = carry_s;
    a.tile_start[P + 1] = carry_t;
  }
}

// Phase 3: the block's packets [lo, hi) into their slots of `perm`; a
// "none" packet gets no winning row.
template <int W>
__device__ void scatter_buckets(const Args& a, long long lo, long long hi, int* hist, int nb,
                                bool in_smem) {
  const int lane = threadIdx.x & 31;
  const int none = a.pool.P + 1;
  if (in_smem) {  // this block's range of every bucket it holds
    for (int k = threadIdx.x; k < nb; k += kThreads)
      if (hist[k]) hist[k] = __ldcg(a.start + k) + atomicAdd(a.cursor + k, hist[k]);
    block_sync();
  }
  for (long long base = lo; base < hi; base += (long long)kThreads * kPerThread) {
    int bk[kPerThread];
    buckets<W>(a, base + threadIdx.x, hi, bk);
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const unsigned peers = peers_of(bk[k]);
      const int leader = __ffs(peers) - 1;
      int slot = 0;
      if (bk[k] >= 0 && lane == leader) {
        slot = in_smem ? atomicAdd(hist + bk[k], __popc(peers))
                       : __ldcg(a.start + bk[k]) + atomicAdd(a.cursor + bk[k], __popc(peers));
      }
      slot = __shfl_sync(0xffffffffu, slot, leader) + __popc(peers & ((1u << lane) - 1u));
      if (bk[k] >= 0) {
        const long long i = base + threadIdx.x + (long long)k * kThreads;
        a.perm[slot] = (int)i;
        if (bk[k] == none) a.win[i] = make_int2(-1, 0);
      }
    }
  }
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src));
}

// The copies of words [K0, 11) (key 0-4, mask 5-9, mask_len 10) of rows
// [r0, r0 + n) of the chunk at pool row g0, each row index clipped to the
// pool, to `raw`, 11 - K0 words a row; one commit group.
template <int K0>
__device__ __forceinline__ void copy_rows(const Pool& pool, long long g0, int r0, int n,
                                           uint32_t* raw) {
  constexpr int kWords = kRawWords - K0;
  const long long last = (long long)pool.n_rows - 1;
  for (int idx = threadIdx.x; idx < n * kWords; idx += kThreads) {
    const int r = idx / kWords, k = idx % kWords + K0;
    long long g = g0 + r0 + r;
    g = g > last ? last : g;
    const void* src = k < 5 ? (const void*)(pool.key_words + g * 5 + k)
                    : k < 10 ? (const void*)(pool.mask_words + g * 5 + (k - 5))
                             : (const void*)(pool.mask_len + g);
    cp_async4(raw + r * kWords + (k - K0), src);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Pass 2's rows [0, rows) of the chunk at pool row g0 through two copy
// stages, kSubRows rows at a time, the next stage's copies in flight while
// `body(r0, n, stage)` reads this one (11 words a row).  Every thread of
// the block calls it.
template <typename Body>
__device__ __forceinline__ void stream_rows(const Pool& pool, long long g0, int rows,
                                            uint32_t* raw, Body body) {
  const int n_stages = (rows + kSubRows - 1) / kSubRows;
  copy_rows<0>(pool, g0, 0, min(kSubRows, rows), raw);
  for (int s = 0; s < n_stages; ++s) {
    const int r0 = s * kSubRows;
    if (s + 1 < n_stages) {
      copy_rows<0>(pool, g0, r0 + kSubRows, min(kSubRows, rows - r0 - kSubRows),
                    raw + ((s + 1) & 1) * kSubRows * kRawWords);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    block_sync();
    body(r0, min(kSubRows, rows - r0), raw + (s & 1) * kSubRows * kRawWords);
    block_sync();  // this stage is free for the copies two stages on
  }
}

// The group of a live row (mask_len 0..128) from its mask words: longer
// than /32, and the k-steps its mask covers (the last non-zero mask word,
// at least word 0).
__device__ __forceinline__ int group_of(const uint32_t* m, int ml) {
  const int nks = m[4] ? 5 : m[3] ? 4 : m[2] ? 3 : m[1] ? 2 : 1;
  return (ml > 32 ? 5 : 0) + nks - 1;
}

// Stage rows [0, rows) of the chunk at pool row g0: the planes and
// constants of its live rows in group order, each group padded to whole
// n-tiles; gcount / gstart (misc) hold the groups.  Every thread calls it;
// it ends with a barrier.
__device__ void stage_chunk(const Pool& pool, long long g0, int rows, uint8_t* smem) {
  uint8_t* planes = smem + kPlanesAt;
  int* consts = reinterpret_cast<int*>(smem + kConstAt);
  uint32_t* raw = reinterpret_cast<uint32_t*>(smem + kRawAt);
  uint16_t* slot = reinterpret_cast<uint16_t*>(smem + kSlotAt);
  int* gcount = reinterpret_cast<int*>(smem + kMiscAt);
  int* gstart = gcount + 16;
  if (threadIdx.x < kGroups) gcount[threadIdx.x] = 0;
  // pass 1: every row's mask words and mask_len in one copy, then each
  // live row's group and its rank there
  copy_rows<5>(pool, g0, 0, rows, raw);
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  block_sync();
  for (int r = threadIdx.x; r < (rows + 31) / 32 * 32; r += kThreads) {  // whole warps
    const uint32_t* row = raw + r * kMaskWords;
    const int ml = r < rows ? (int)row[5] : -1;
    const int g = ml >= 0 && ml <= 128 ? group_of(row, ml) : -1;
    const unsigned peers = peers_of(g);
    const int lane = threadIdx.x & 31, leader = __ffs(peers) - 1;
    int rank = 0;
    if (g >= 0 && lane == leader) rank = atomicAdd(gcount + g, __popc(peers));
    rank = __shfl_sync(0xffffffffu, rank, leader) + __popc(peers & ((1u << lane) - 1u));
    if (r < rows) slot[r] = g >= 0 ? (uint16_t)(g << 11 | rank) : (uint16_t)kDead;
  }
  block_sync();  // the counts are in, and the copy area is free for pass 2
  if (threadIdx.x == 0) {
    int at = 0;
    for (int g = 0; g < kGroups; ++g) {
      gstart[g] = at;
      at += (gcount[g] + 7) & ~7;
    }
    gstart[kGroups] = at;
  }
  block_sync();
  // the padding rows: zero planes, never-matching constants
  for (int idx = threadIdx.x; idx < kGroups * 8; idx += kThreads) {
    const int g = idx >> 3, s = gstart[g] + gcount[g] + (idx & 7);
    if (s < gstart[g + 1]) {
      uint4* p = reinterpret_cast<uint4*>(planes + s * kRowBytes);
#pragma unroll
      for (int k = 0; k < kKeyBytes / 16; ++k) p[k] = make_uint4(0u, 0u, 0u, 0u);
      consts[s] = kNever;
    }
  }
  // pass 2: each live row's plane words (the k-steps of its group) and its
  // constant at its slot
  stream_rows(pool, g0, rows, raw, [&](int r0, int n, const uint32_t* stage) {
    for (int idx = threadIdx.x; idx < n * 6; idx += kThreads) {
      const int r = idx / 6, k = idx % 6;
      const int code = slot[r0 + r];
      if (code == kDead) continue;
      const int g = code >> 11, s = gstart[g] + (code & 2047);
      const uint32_t* row = stage + r * kRawWords;
      if (k < 5) {
        if (k >= g % 5 + 1) continue;  // a k-step past the group's: never read
        const uint32_t rk = __brev(row[k]), rm = __brev(row[5 + k]);
        uint32_t v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t m = spread_nibble(rm, j), b = spread_nibble(rk, j);
          v[j] = (m & ~b) | ((m & b) * 0xFFu);  // +1 for M0, -1 for M1
        }
        uint4* p = reinterpret_cast<uint4*>(planes + s * kRowBytes + 32 * k);
        p[0] = make_uint4(v[0], v[1], v[2], v[3]);
        p[1] = make_uint4(v[4], v[5], v[6], v[7]);
      } else {
        int m1 = 0;
#pragma unroll
        for (int w = 0; w < 5; ++w) m1 += __popc(row[w] & row[5 + w]);
        const int key = ((int)row[10] + 1) << kTieBits | (kChunk - 1 - (r0 + r));
        consts[s] = key - kBig * m1;
      }
    }
  });
}

// The staged groups of one kind (short: mask_len <= 32, or longer) into
// the warp's running maxima.
__device__ __forceinline__ void walk_groups(const uint32_t (&a)[kMTiles][5][4], uint32_t lane_addr,
                                            const int* consts, const int* gstart, int first,
                                            int q, int (&mx)[kMTiles][2]) {
#pragma unroll 1
  for (int ks = 1; ks <= 5; ++ks) {
    const int lo = gstart[first + ks - 1], hi = gstart[first + ks];
    if (lo == hi) continue;
    switch (ks) {
      case 1: walk_rows<0, 1>(a, lane_addr, consts, lo, hi, q, mx); break;
      case 2: walk_rows<0, 2>(a, lane_addr, consts, lo, hi, q, mx); break;
      case 3: walk_rows<0, 3>(a, lane_addr, consts, lo, hi, q, mx); break;
      case 4: walk_rows<0, 4>(a, lane_addr, consts, lo, hi, q, mx); break;
      default: walk_rows<0, 5>(a, lane_addr, consts, lo, hi, q, mx); break;
    }
  }
}

// Phase 4, one tile: packets perm[s, s + n) of page p (base = p * S).
template <int W>
__device__ void classify_tile(const Args& a, int p, int s, int n, int& staged, uint8_t* smem) {
  const Pool& pool = a.pool;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int* consts = reinterpret_cast<const int*>(smem + kConstAt);
  const int* gstart = reinterpret_cast<const int*>(smem + kMiscAt) + 16;
  const uint32_t lane_addr = lane_address(smem + kPlanesAt, lane);
  const long long base = (long long)p * pool.S;
  const int first = warp * kWarpPackets;
  const bool active = first < n;  // warp-uniform

  // A fragments: rows g and g + 8 of each 16-packet tile
  uint32_t a_frag[kMTiles][5][4];
  bool v4[kMTiles][2];
  int best_len[kMTiles][2], best_row[kMTiles][2];
#pragma unroll
  for (int m = 0; m < kMTiles; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = first + m * 16 + g + 8 * h;
      // packets past the tile are KIND_OTHER with a zero key
      uint32_t key[5] = {0u, 0u, 0u, 0u, 0u};
      v4[m][h] = false;
      if (active && j < n) {
        const wire_io::Packet pk = load_packet<W>(a, __ldcg(a.perm + s + j));
        v4[m][h] = pk.kind == wire_io::kKindIPv4;
        key[0] = (uint32_t)pk.ifindex;
        key[1] = pk.w.x; key[2] = pk.w.y; key[3] = pk.w.z; key[4] = pk.w.w;
      }
      key_fragments(a_frag[m], h, key, q);
      best_len[m][h] = 0;
      best_row[m][h] = 0;
    }
  }
  __syncwarp();

  for (int c0 = 0; c0 < pool.S; c0 += kChunk) {
    const int rows = min(kChunk, pool.S - c0);
    if (staged != p || pool.S > kChunk) {
      block_sync();  // every warp is done with the staged rows
      stage_chunk(pool, base + c0, rows, smem);
      staged = p;
    }
    if (!active) continue;
    __syncwarp();  // converged for ldmatrix and mma
    int ms[kMTiles][2], ml[kMTiles][2];
#pragma unroll
    for (int m = 0; m < kMTiles; ++m) ms[m][0] = ms[m][1] = ml[m][0] = ml[m][1] = INT_MIN;
    walk_groups(a_frag, lane_addr, consts, gstart, 0, q, ms);
    walk_groups(a_frag, lane_addr, consts, gstart, 5, q, ml);
    // the chunk's best per packet row (an IPv4 packet over mask_len <= 32);
    // a later chunk takes over only with a longer match
#pragma unroll
    for (int m = 0; m < kMTiles; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int sh = quad_max(ms[m][h]);  // every lane shuffles, whatever its packet
        const int lg = quad_max(ml[m][h]);
        const int v = v4[m][h] ? sh : max(sh, lg);
        const int len = v > 0 ? v >> kTieBits : 0;
        if (len > best_len[m][h]) {
          best_len[m][h] = len;
          best_row[m][h] = c0 + kChunk - 1 - (v & (kChunk - 1));
        }
      }
    }
  }
  if (!active) return;

  // lane L takes packet first + L: its row g = L & 7 of m-tile L >> 4, half
  // (L >> 3) & 1, held by lane 4g
  int len = 0, row = 0;
#pragma unroll
  for (int m = 0; m < kMTiles; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = __shfl_sync(0xffffffffu, best_len[m][h], 4 * (lane & 7));
      const int y = __shfl_sync(0xffffffffu, best_row[m][h], 4 * (lane & 7));
      if (m == (lane >> 4) && h == ((lane >> 3) & 1)) {
        len = x;
        row = y;
      }
    }
  }
  const int j = first + lane;
  if (j < n) {
    long long gr = base + row;
    gr = gr > pool.n_rows - 1 ? pool.n_rows - 1 : gr;
    a.win[__ldcg(a.perm + s + j)] = make_int2(len > 0 ? (int)gr : -1, len);
  }
}

// Phase 5, a launch of its own at full occupancy: the ordered rule scan
// of each packet's winning row, one thread per packet in batch order over
// a persistent grid, and the output; the fused entry's statistics summed
// per block in shared memory.
constexpr int kScanThreads = 256;

template <int W>
__global__ void __launch_bounds__(kScanThreads) rule_scan_kernel(const Args a) {
  __shared__ uint32_t tab[W > 0 ? wire_io::kBlockCells : 1];
  if constexpr (W > 0) {
    wire_io::zero_stats(tab);
    __syncthreads();
  }
  const Pool& pool = a.pool;
  for (long long i = (long long)blockIdx.x * kScanThreads + threadIdx.x; i < a.B;
       i += (long long)gridDim.x * kScanThreads) {
    const int2 w = a.win[i];
    const wire_io::Packet pk = load_packet<W>(a, i);
    const int result = w.x >= 0 ? ctrie::scan_rules(pool.rules + (long long)w.x * 5 * pool.R,
                                                    pool.R, pk.kind, pk.proto, pk.dport,
                                                    pk.itype, pk.icode)
                                : 0;
    put_output<W>(a, tab, i, result, w.y, pk.pkt_len);
  }
  if constexpr (W > 0) wire_io::flush_stats(tab, (uint32_t*)a.out + (a.B + 1) / 2);
}

template <int W>
__global__ void __launch_bounds__(kThreads, 1) arena_dense_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  cg::grid_group grid = cg::this_grid();
  const Pool& pool = a.pool;
  const int nb = pool.P + 2;
  const bool in_smem = nb <= kHistBins;
  int* hist = reinterpret_cast<int*>(smem + kPlanesAt);

  // 0. the bucket counters
  for (long long k = (long long)blockIdx.x * kThreads + threadIdx.x; k < 2LL * nb;
       k += (long long)gridDim.x * kThreads)
    (k < nb ? a.total : a.cursor)[k % nb] = 0;
  grid.sync();
  // 1. counts: block b takes packets [B b / G, B (b + 1) / G)
  const long long lo = (long long)a.B * blockIdx.x / gridDim.x;
  const long long hi = (long long)a.B * (blockIdx.x + 1) / gridDim.x;
  count_buckets<W>(a, lo, hi, hist, nb, in_smem);
  grid.sync();
  // 2. the scans
  if (blockIdx.x == 0) scan_buckets(a, reinterpret_cast<int*>(smem + kMiscAt));
  grid.sync();
  // 3. the permutation
  scatter_buckets<W>(a, lo, hi, hist, nb, in_smem);
  grid.sync();
  // 4. the LPM over this block's tiles, a page's tiles consecutive
  const int n_tiles = __ldcg(a.tile_start + pool.P + 1);
  const int t0 = (int)((long long)n_tiles * blockIdx.x / gridDim.x);
  const int t1 = (int)((long long)n_tiles * (blockIdx.x + 1) / gridDim.x);
  int p = 0;
  if (t0 < t1) {  // the page of tile t0: the last page whose first tile is <= t0
    int lo_p = 0, hi_p = pool.P;
    while (lo_p < hi_p) {
      const int mid = (lo_p + hi_p + 1) >> 1;
      if (__ldcg(a.tile_start + mid) <= t0) lo_p = mid; else hi_p = mid - 1;
    }
    p = lo_p;
  }
  int staged = -1;
  for (int t = t0; t < t1; ++t) {
    while (__ldcg(a.tile_start + p + 1) <= t) ++p;
    const int s = __ldcg(a.start + p) + (t - __ldcg(a.tile_start + p)) * kTilePackets;
    const int n = min(kTilePackets, __ldcg(a.start + p + 1) - s);
    classify_tile<W>(a, p, s, n, staged, smem);
  }
}

// One cooperative launch of arena_dense_kernel<W> on `stream`: one block
// per SM at most (its shared memory), at most one per packet and, when
// max_grid > 0, at most max_grid; then rule_scan_kernel<W> on the resident
// grid.
template <int W>
cudaError_t launch(const Args& a, int max_grid, cudaStream_t stream) {
  static int cached[wire_io::kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= wire_io::kMaxDevices) return cudaErrorInvalidDevice;
  const size_t smem = kSmemBytes;
  if (cached[device] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(arena_dense_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, arena_dense_kernel<W>, kThreads,
                                                          smem);
    if (err != cudaSuccess) return err;
    if (sms * per_sm <= 0) return cudaErrorCooperativeLaunchTooLarge;
    cached[device] = sms * per_sm;
  }
  long long grid = cached[device];
  if (grid > a.B) grid = a.B;
  if (max_grid > 0 && grid > max_grid) grid = max_grid;
  void* args[] = {(void*)&a};
  err = cudaLaunchCooperativeKernel((const void*)arena_dense_kernel<W>, dim3((unsigned)grid),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  static int scan_cached[wire_io::kMaxDevices];
  int scan_grid = 0;
  err = wire_io::persistent_grid(rule_scan_kernel<W>, kScanThreads, scan_cached, a.B, 0,
                                 &scan_grid);
  if (err != cudaSuccess) return err;
  rule_scan_kernel<W><<<scan_grid, kScanThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

Args make_args(const void* tenant, const void* page_table, const void* key_words,
               const void* mask_words, const void* mask_len, const void* rules, void* scratch,
               void* out, int B, int MT, int S, int n_rows, int R) {
  Args a{};
  a.tenant = (const int*)tenant;
  const int P = n_rows / S;
  a.pool = Pool{(const int*)page_table, (const uint32_t*)key_words, (const uint32_t*)mask_words,
                (const int*)mask_len, (const uint16_t*)rules, MT, S, n_rows, R, P};
  int* w = (int*)scratch;
  a.total = w;
  a.cursor = a.total + (P + 2);
  a.start = a.cursor + (P + 2);
  a.tile_start = a.start + (P + 3);
  a.perm = a.tile_start + (P + 2);
  const long long win_at = 4LL * P + 9 + B;  // rounded up to an even word
  a.win = reinterpret_cast<int2*>(w + win_at + (win_at & 1));
  a.out = out;
  a.B = B;
  return a;
}

}  // namespace

// Two launches on `stream` (none for B = 0); returns the first error, else
// cudaGetLastError().  Allocates nothing: `scratch` holds n + n % 2 + 2B
// int32 words, n = 4P + 9 + B (P = n_rows / S).  fields, words and out 16-byte aligned;
// S >= 1 rows a slab, n_rows a multiple of S (the Python wrapper checks).
// max_grid > 0 caps the grid (tests); 0 takes one block per SM.
extern "C" int infw_arena_dense_walk(const void* fields, const void* words, const void* tenant,
                                     const void* page_table, const void* key_words,
                                     const void* mask_words, const void* mask_len,
                                     const void* rules, void* scratch, void* out, int B, int MT,
                                     int S, int n_rows, int R, int max_grid, void* stream) {
  cudaError_t err = cudaSuccess;
  if (B > 0) {
    Args a = make_args(tenant, page_table, key_words, mask_words, mask_len, rules, scratch, out,
                       B, MT, S, n_rows, R);
    a.fields = (const int4*)fields;
    a.words = (const uint4*)words;
    err = launch<0>(a, max_grid, (cudaStream_t)stream);
  }
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

// The fused pass on `stream`: one memset of `out`'s statistics and last
// result word, then the two launches (none for B = 0); returns the
// first error, else cudaGetLastError().  Allocates nothing.  `out` holds
// wire_io::out_words(B, true) words; `width` is 7, 6, 4 or 3; scratch and
// max_grid as for infw_arena_dense_walk.
extern "C" int infw_arena_dense_fused(const void* wire, const void* tenant,
                                      const void* page_table, const void* key_words,
                                      const void* mask_words, const void* mask_len,
                                      const void* rules, void* scratch, void* out, int B,
                                      int width, int MT, int S, int n_rows, int R, int max_grid,
                                      void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (width != 3 && width != 4 && width != 6 && width != 7) return (int)cudaErrorInvalidValue;
  cudaError_t err = wire_io::clear_out((uint32_t*)out, B, true, s);
  if (err == cudaSuccess && B > 0) {
    Args a = make_args(tenant, page_table, key_words, mask_words, mask_len, rules, scratch, out,
                       B, MT, S, n_rows, R);
    a.wire = (const uint32_t*)wire;
    switch (width) {
      case 3: err = launch<3>(a, max_grid, s); break;
      case 4: err = launch<4>(a, max_grid, s); break;
      case 6: err = launch<6>(a, max_grid, s); break;
      default: err = launch<7>(a, max_grid, s); break;
    }
  }
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}
