// K1 on Hopper: dense-path longest-prefix match on the int8 tensor cores +
// ordered first-match rule scan.
//
// Replaces the TPU kernel infw/kernels/pallas_dense.py:_classify_kernel
// (launched by _pallas_scan).  Same function, bit for bit: for each packet
// (result, tidx) with result = (ruleId << 8) | action of the first hitting
// rule of the longest-prefix entry (0 when none) and tidx the entry index
// (-1 when no entry matches).
//
// The LPM is the TPU kernel's own formulation: the 160-bit key (ifindex ||
// source IP, big-endian bits) as 0/1 bytes against each entry's plane
// M0 - M1 in {-1, 0, 1} (M0 = mask & ~prefix, M1 = mask & prefix), so that
// bits . plane_t + rowsum(M1)_t is the count of in-mask mismatching bits,
// never negative, and zero iff entry t matches.  The host folds the score,
// the first-index tie rule and the padding into one int32 per entry,
//   c_t = key_t - BIG * rowsum(M1)_t,  key_t = (mask_len + 1) << 12 | (4095 - t),
// BIG = 2^21 > every key_t, so score_t = c_t - BIG * (bits . plane_t) is
// key_t for a match and negative otherwise; the winner is the maximum, a
// match iff it is positive, and tidx = 4095 - (max & 4095).
//
// The host also orders the entries the kernel walks (`order`) in groups
// (`groups`: a size, a multiple of 8 rows, the group's k-steps and flags);
// a group keeps its own maximum, merged into the packet's at its end:
//   - the IPv4 cap (/32): an IPv4 packet takes only the groups of mask_len
//     <= 32, every other kind all of them.  Entries that never match
//     (padding rows, mask_len outside 0..128) are left out;
//   - the k-steps: a k-step is one key word, and an entry's mask covers
//     words 0..w only (the ifindex and the prefix's words), so every plane
//     word past w is zero and its mma is skipped.  A /24 needs 2 of the 5;
//   - the ifindex: a common ifindex's entries form "folded" groups that
//     leave word 0 out of the product (and out of c_t's rowsum) and count
//     only for packets on that ifindex, one compare per packet and group.
//     A /24 then needs 1 k-step.
//
// What bounds it on this card: operations.  At most B x T x 160
// multiply-adds (2^20 x 1000 x 160 at the headline shape; the groups leave
// 27% of it).  Design (the tensor-core helpers live in lpm_mma.cuh, which
// K6's arena_dense.cu shares):
//   - mma.sync.m16n8k32 s8 x s8 -> s32 (0..5 k-steps per 16 x 8 tile); each
//     warp keeps the A fragments of kMTiles 16-packet tiles in registers,
//     built once per packet tile from the five key words (__brev, then each
//     nibble spread to four 0/1 bytes with one multiply and one mask), and
//     reuses them across every entry, two n-tiles at a time;
//   - the planes of up to kStageRows entries (in `order`) are staged in
//     shared memory with cp.async, rows of 176 bytes so that ldmatrix reads
//     the B fragments without bank conflicts; a table that fits (all but
//     the largest dense tables) is staged once per block and the blocks are
//     persistent over packet tiles;
//   - the epilogue is one multiply-add per accumulator element and one
//     three-way max (Hopper's DPX __vimax3_s32) per two; the running maxima
//     stay in registers and are reduced across each quad with shuffles.
// The ordered first-match scan of the matched row runs in a second launch
// at full occupancy, reading the row (8 bytes a slot, two per 16-byte load)
// straight from global memory, where the whole table stays L2-resident, and
// stopping at the first hit.  Inside the LPM kernel, one fat block per SM
// cannot hide the L2 latency of the scan's dependent loads, and a warp runs
// as long as its slowest packet (one with no hitting rule reads all R
// slots); many small blocks can.
//
// Packed layouts (built by infw_torch/kernels/dense.py:build_dense_tables):
//   planes    (Tp, 160) s8: M0 - M1 of entry t, big-endian bit order
//   lpm_const (Tp,) i32:    c_t
//   order     (Tk,) i32:    entry index per kernel row, -1 = a padding row
//   groups    (G, 3) i32 on the host, G <= 64, a kernel argument: per group
//                           of `order` its rows (a multiple of 8), its info
//                           (k-steps | 8 if its entries are longer than /32
//                           | 16 if folded: k-steps from word 1) and, if
//                           folded, its ifindex
//   rules     (Tp, R) uint2, R even: x = ridAct | proto << 8 | icmpType << 16 |
//                                icmpCode << 24, ridAct = ruleId << 1 | (action - 1)
//                            y = portStart | portEnd << 16
//   fields    (B, 8) i32:   kind, ifindex, proto, dport, icmpType, icmpCode,
//                           l4_ok, pkt_len  (the TPU kernel's operand)
//   words     (B, 4) u32:   source-IP words, big-endian
//   out       (B, 2) i32:   result, tidx
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "lpm_mma.cuh"

namespace {

using namespace lpm;

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kTilePackets = kWarps * kWarpPackets;    // packets per block pass
constexpr int kStageRows = 1280;                       // entries staged at once: 227 KB
constexpr int kScanThreads = 256;                      // packets per scan block
constexpr int kMaxGroups = 64;
constexpr int kLonger = 8;    // group info: entries longer than /32
constexpr int kFolded = 16;   // group info: one ifindex, its word out of the product

// The groups of the kernel's entry order, passed by value.
struct GroupTable {
  int n;
  int size[kMaxGroups];     // rows, a multiple of 8
  int info[kMaxGroups];     // k-steps | kLonger | kFolded
  int ifindex[kMaxGroups];  // a folded group's ifindex
};
constexpr int kKindIPv4 = 1;
constexpr int kProtoICMP = 1;
constexpr int kProtoTCP = 6;
constexpr int kProtoUDP = 17;
constexpr int kProtoICMPv6 = 58;
constexpr int kProtoSCTP = 132;

// Dynamic shared memory: the staged planes, their constants, then each
// warp's best scores.
constexpr size_t smem_bytes(int rows) {
  return (size_t)rows * (kRowBytes + 4) + kWarps * kWarpPackets * 4;
}
static_assert(smem_bytes(kStageRows) <= 232448, "above the 227 KB a block may have");

// Stage kernel rows [row0, row0 + rows) of `order`: planes by cp.async (16
// bytes at a time), constants by plain loads; padding rows are zero planes
// with the never-matching constant.  Every thread of the block calls it.
__device__ void stage_rows(const int8_t* __restrict__ planes, const int* __restrict__ lpm_const,
                           const int* __restrict__ order, int row0, int rows, uint8_t* sm_planes,
                           int* sm_const) {
  constexpr int kParts = kKeyBytes / 16;
  for (int i = threadIdx.x; i < rows * kParts; i += kThreads) {
    const int row = i / kParts, part = i % kParts;
    const int src = order[row0 + row];
    uint8_t* dst = sm_planes + row * kRowBytes + part * 16;
    if (src >= 0) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)),
                   "l"(planes + (size_t)src * kKeyBytes + part * 16));
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  for (int row = threadIdx.x; row < rows; row += kThreads) {
    const int src = order[row0 + row];
    sm_const[row] = src >= 0 ? lpm_const[src] : kNever;
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
  __syncthreads();
}

// The packet fields the ordered scan reads.
struct ScanKey {
  int proto, dport, itype, icode, fam;
};

__device__ __forceinline__ ScanKey scan_key(const int4* __restrict__ fields, size_t i) {
  const int4 f0 = fields[2 * i], f1 = fields[2 * i + 1];
  return {f0.z, f0.w, f1.x, f1.y, f0.x == kKindIPv4 ? kProtoICMP : kProtoICMPv6};
}

// One rule slot against the packet (kernel.c:222-258): the verdict
// (ruleId << 8) | action if it hits, else 0.  An empty slot (ruleId 0)
// never hits.
__device__ __forceinline__ int slot_hit(uint2 v, const ScanKey& k) {
  const uint32_t rid_act = v.x & 0xFFu;
  const int rid = (int)(rid_act >> 1);
  const int rproto = (int)((v.x >> 8) & 0xFFu);
  bool hit = rproto == 0;  // catch-all
  if (!hit && rproto == k.proto) {
    const int it = (int)((v.x >> 16) & 0xFFu);
    const int ic = (int)(v.x >> 24);
    const int ps = (int)(v.y & 0xFFFFu);
    const int pe = (int)(v.y >> 16);
    const bool transport = rproto == kProtoTCP || rproto == kProtoUDP || rproto == kProtoSCTP;
    // single port when portEnd == 0, else the half-open [start, end)
    const bool port_hit = pe == 0 ? k.dport == ps : (k.dport >= ps && k.dport < pe);
    hit = (transport && port_hit) || (rproto == k.fam && it == k.itype && ic == k.icode);
  }
  return hit && rid != 0 ? (rid << 8) | (int)((rid_act & 1u) + 1u) : 0;
}

// The LPM: out[i] = (0, tidx) for every packet.
__global__ void __launch_bounds__(kThreads, 1)
lpm_kernel(const int4* __restrict__ fields, const uint4* __restrict__ words,
           const int8_t* __restrict__ planes, const int* __restrict__ lpm_const,
           const int* __restrict__ order, const GroupTable groups, int2* __restrict__ out,
           int B, int Tk) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int stage = min(Tk, kStageRows);
  uint8_t* sm_planes = smem;
  int* sm_const = reinterpret_cast<int*>(smem + (size_t)stage * kRowBytes);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  int* sm_best = sm_const + stage + warp * kWarpPackets;
  const bool resident = Tk <= kStageRows;
  const uint32_t lane_addr = lane_address(sm_planes, lane);

  if (resident) stage_rows(planes, lpm_const, order, 0, Tk, sm_planes, sm_const);

  const int n_tiles = (B + kTilePackets - 1) / kTilePackets;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int warp_base = tile * kTilePackets + warp * kWarpPackets;

    // A fragments: rows g and g + 8 of each 16-packet tile, 5 k-steps
    uint32_t a[kMTiles][5][4];
    uint32_t ifx[kMTiles][2];
    bool v4[kMTiles][2];
#pragma unroll
    for (int m = 0; m < kMTiles; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = warp_base + m * 16 + g + 8 * h;
        // packets past the batch end are KIND_OTHER with a zero key
        uint32_t key[5] = {0u, 0u, 0u, 0u, 0u};
        v4[m][h] = false;
        if (i < B) {
          const int4 f0 = fields[2 * (size_t)i];
          const uint4 w = words[i];
          v4[m][h] = f0.x == kKindIPv4;
          key[0] = (uint32_t)f0.y;
          key[1] = w.x; key[2] = w.y; key[3] = w.z; key[4] = w.w;
        }
        ifx[m][h] = key[0];
        key_fragments(a[m], h, key, q);
      }
    }

    int mx_short[kMTiles][2], mx_long[kMTiles][2];
#pragma unroll
    for (int m = 0; m < kMTiles; ++m) {
      mx_short[m][0] = mx_short[m][1] = INT_MIN;
      mx_long[m][0] = mx_long[m][1] = INT_MIN;
    }
    for (int row0 = 0; row0 < Tk; row0 += kStageRows) {
      const int rows = min(kStageRows, Tk - row0);
      if (!resident) {
        __syncthreads();  // the previous rows are consumed
        stage_rows(planes, lpm_const, order, row0, rows, sm_planes, sm_const);
      }
      // each group's rows within this stage, into the group's own maximum
      int start = 0;
      for (int gi = 0; gi < groups.n; ++gi) {
        const int size = groups.size[gi], info = groups.info[gi];
        const int lo = max(start, row0) - row0, hi = min(start + size, row0 + rows) - row0;
        start += size;
        if (lo >= hi) continue;
        int mx[kMTiles][2];
#pragma unroll
        for (int m = 0; m < kMTiles; ++m) mx[m][0] = mx[m][1] = INT_MIN;
        const bool folded = info & kFolded;
        switch ((info & 7) | (folded ? 8 : 0)) {  // k-steps, from word 0 or 1
          case 1: walk_rows<0, 1>(a, lane_addr, sm_const, lo, hi, q, mx); break;
          case 2: walk_rows<0, 2>(a, lane_addr, sm_const, lo, hi, q, mx); break;
          case 3: walk_rows<0, 3>(a, lane_addr, sm_const, lo, hi, q, mx); break;
          case 4: walk_rows<0, 4>(a, lane_addr, sm_const, lo, hi, q, mx); break;
          case 5: walk_rows<0, 5>(a, lane_addr, sm_const, lo, hi, q, mx); break;
          case 8: walk_rows<1, 0>(a, lane_addr, sm_const, lo, hi, q, mx); break;
          case 9: walk_rows<1, 1>(a, lane_addr, sm_const, lo, hi, q, mx); break;
          case 10: walk_rows<1, 2>(a, lane_addr, sm_const, lo, hi, q, mx); break;
          case 11: walk_rows<1, 3>(a, lane_addr, sm_const, lo, hi, q, mx); break;
          default: walk_rows<1, 4>(a, lane_addr, sm_const, lo, hi, q, mx); break;
        }
        // a folded group counts only for packets on its ifindex
        const uint32_t gifx = (uint32_t)groups.ifindex[gi];
        const bool longer = info & kLonger;
#pragma unroll
        for (int m = 0; m < kMTiles; ++m) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int v = !folded || ifx[m][h] == gifx ? mx[m][h] : INT_MIN;
            if (longer) mx_long[m][h] = max(mx_long[m][h], v);
            else mx_short[m][h] = max(mx_short[m][h], v);
          }
        }
      }
    }

    // best score per packet row: an IPv4 packet over the groups of /32 or shorter
#pragma unroll
    for (int m = 0; m < kMTiles; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int s = quad_max(mx_short[m][h]);
        const int all = max(s, quad_max(mx_long[m][h]));
        if (q == 0) sm_best[m * 16 + g + 8 * h] = v4[m][h] ? s : all;
      }
    }
    __syncwarp();

    // tidx per packet; the scan kernel fills in the result
    for (int p = lane; p < kWarpPackets; p += 32) {
      const int i = warp_base + p, best = sm_best[p];
      if (i < B) out[i] = make_int2(0, best > 0 ? 4095 - (best & 4095) : -1);
    }
    __syncwarp();  // sm_best is free for the next tile
  }
}

// The ordered first-match scan (kernel.c:222-258) of each packet's matched
// row, one thread per packet at full occupancy: out[i].y (tidx) in,
// out[i].x (the verdict, 0 from lpm_kernel) out.  Reads two slots per
// 16-byte load (R is even) and stops at the first hit.
__global__ void __launch_bounds__(kScanThreads)
rule_scan_kernel(const int4* __restrict__ fields, const uint2* __restrict__ rules,
                 int2* __restrict__ out, int B, int R) {
  const int i = blockIdx.x * kScanThreads + threadIdx.x;
  if (i >= B) return;
  const int tidx = out[i].y;
  if (tidx < 0) return;
  const ScanKey key = scan_key(fields, i);
  const uint4* row = reinterpret_cast<const uint4*>(rules + (size_t)tidx * R);
  int result = 0;
  for (int r = 0; r < R / 2 && !result; ++r) {
    const uint4 v = __ldg(row + r);
    result = slot_hit(make_uint2(v.x, v.y), key);
    if (!result) result = slot_hit(make_uint2(v.z, v.w), key);
  }
  if (result) out[i].x = result;
}

int g_sm_count[64];

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); allocates nothing.
// Two launches: lpm_kernel, then (if R > 0) rule_scan_kernel.  Every device
// pointer 16-byte aligned, R even; `groups` is a HOST table of n_groups <=
// kMaxGroups rows [entries (a multiple of 8), info, ifindex] summing to Tk,
// passed to the kernel by value (the Python wrapper checks all of it).  The
// LPM's grid is persistent: one block per SM at most.
extern "C" int infw_dense_classify(const void* fields, const void* words, const void* planes,
                                   const void* lpm_const, const void* order, const void* rules,
                                   const void* groups, void* out, int B, int Tk, int n_groups,
                                   int R, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (n_groups < 0 || n_groups > kMaxGroups) return (int)cudaErrorInvalidValue;
  GroupTable table{};
  table.n = n_groups;
  for (int gi = 0; gi < n_groups; ++gi) {
    table.size[gi] = ((const int*)groups)[3 * gi];
    table.info[gi] = ((const int*)groups)[3 * gi + 1];
    table.ifindex[gi] = ((const int*)groups)[3 * gi + 2];
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (g_sm_count[device] == 0) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(lpm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem_bytes(kStageRows));
    if (err != cudaSuccess) return (int)err;
    g_sm_count[device] = sms;
  }
  const int n_tiles = (B + kTilePackets - 1) / kTilePackets;
  const int grid = n_tiles < g_sm_count[device] ? n_tiles : g_sm_count[device];
  const size_t smem = smem_bytes(Tk < kStageRows ? Tk : kStageRows);
  const cudaStream_t s = (cudaStream_t)stream;
  lpm_kernel<<<grid, kThreads, smem, s>>>((const int4*)fields, (const uint4*)words,
                                          (const int8_t*)planes, (const int*)lpm_const,
                                          (const int*)order, table, (int2*)out, B, Tk);
  err = cudaGetLastError();
  if (err != cudaSuccess || R == 0) return (int)err;
  rule_scan_kernel<<<(B + kScanThreads - 1) / kScanThreads, kScanThreads, 0, s>>>(
      (const int4*)fields, (const uint2*)rules, (int2*)out, B, R);
  return (int)cudaGetLastError();
}
