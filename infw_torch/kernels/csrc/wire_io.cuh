// The prologue and epilogue of a wire-to-verdict kernel, shared by the
// fused entries of K3 (ctrie_walk.cu) and K3b (arena_ctrie_walk.cu): the
// packed host-to-device wire decoded in registers, the packed u16 result
// written straight into the host's read-back buffer, and the per-rule
// statistics summed per block in shared memory, then added to that buffer
// with one global atomic per non-zero cell.  Together they are the same
// bit for bit as torchpath.unpack_wire / unpack_wire8 + looked_up_results
// + result_stats + fuse_wire_outputs / _pack_res16 (the JAX package's
// jaxpath.unpack_wire, finalize and fuse_wire_outputs).
//
// Layouts:
//   wire   (B, W) u32: W = 7 full, 4 v4-compact, 6 / 3 their narrow forms
//                      (ifindex folded into w0, dst_port overlaid with the
//                      ICMP fields), W = 2 wire8 (4-bit ifindex dictionary
//                      index, ip word 0; no pkt_len)
//   out    u32:        ceil(B / 2) words of u16 results (element i is the
//                      u16 at byte 2i, little-endian), then, when the
//                      entry writes statistics, (kMaxTargets, 6) u32
//                      [allow, allow_hi, allow_lo, deny, deny_hi, deny_lo]
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wire_io {

constexpr int kKindIPv4 = 1;
constexpr int kKindIPv6 = 2;
constexpr int kProtoICMP = 1;
constexpr int kProtoICMPv6 = 58;
constexpr int kDeny = 1;   // XDP_DROP
constexpr int kAllow = 2;  // XDP_PASS
constexpr int kMaxTargets = 1024;
constexpr int kStatsCols = 6;
// Rows a block sums in shared memory: every ruleId a uint16 joined row can
// hold (8 bits); rows 256-1023 go straight to the global sums.
constexpr int kBlockRows = 256;
constexpr int kBlockCells = kBlockRows * kStatsCols;

// One packet's classify operands, decoded from its wire row.
struct Packet {
  uint4 w;  // source-IP words, big-endian
  int kind, l4_ok, ifindex, proto, dport, itype, icode;
  uint32_t pkt_len;
};

// Row i of a (B, W) wire (unpack_wire, unpack_wire8); `ifmap` (n_ifmap
// >= 1 entries) is read only by wire8, its index clipped to the map.
template <int W>
__device__ __forceinline__ Packet decode(const uint32_t* __restrict__ wire, long long i,
                                         const int* __restrict__ ifmap, int n_ifmap) {
  static_assert(W == 2 || W == 3 || W == 4 || W == 6 || W == 7, "wire width");
  const uint32_t* r = wire + (size_t)i * W;
  const uint32_t w0 = __ldg(r);
  const uint32_t w1 = __ldg(r + 1);
  Packet p;
  p.kind = (int)(w0 & 3u);
  p.l4_ok = (int)((w0 >> 2) & 1u);
  p.proto = (int)((w0 >> 3) & 0xFFu);
  if constexpr (W == 7 || W == 4) {  // full layout: the ICMP fields in w0
    p.ifindex = (int)__ldg(r + 2);
    p.dport = (int)(w1 & 0xFFFFu);
    p.itype = (int)((w0 >> 11) & 0xFFu);
    p.icode = (int)((w0 >> 19) & 0xFFu);
    p.pkt_len = (w1 >> 16) | (((w0 >> 27) & 0x1Fu) << 16);
  } else {  // narrow and wire8: one l4 word, ports or the ICMP fields
    uint32_t l4w;
    if constexpr (W == 2) {
      l4w = (w0 >> 15) & 0xFFFFu;
      const int ifd = min((int)((w0 >> 11) & 0xFu), n_ifmap - 1);
      p.ifindex = __ldg(ifmap + ifd);
      p.pkt_len = 0u;
    } else {
      l4w = w1 & 0xFFFFu;
      p.ifindex = (int)((w0 >> 11) & 0xFFFFu);
      p.pkt_len = w1 >> 16;
    }
    const bool icmp = p.proto == kProtoICMP || p.proto == kProtoICMPv6;
    p.dport = icmp ? 0 : (int)l4w;
    p.itype = icmp ? (int)(l4w >> 8) : 0;
    p.icode = icmp ? (int)(l4w & 0xFFu) : 0;
  }
  if constexpr (W == 7 || W == 6) {
    const int o = W == 7 ? 3 : 2;
    p.w = make_uint4(__ldg(r + o), __ldg(r + o + 1), __ldg(r + o + 2), __ldg(r + o + 3));
  } else if constexpr (W == 2) {
    p.w = make_uint4(w1, 0u, 0u, 0u);
  } else {
    p.w = make_uint4(__ldg(r + (W == 4 ? 3 : 2)), 0u, 0u, 0u);
  }
  return p;
}

// Whether finalize keeps the packet's result (looked_up_results): IPv4 or
// IPv6 with a parsed L4 header.  Every other lane's result is 0, which
// counts nowhere, so its walk can be skipped.
__device__ __forceinline__ bool looked_up(const Packet& p) {
  return (p.kind == kKindIPv4 || p.kind == kKindIPv6) && p.l4_ok != 0;
}

// The result's u16 into the read-back buffer.
__device__ __forceinline__ void put_res16(uint32_t* out, long long i, int result) {
  reinterpret_cast<uint16_t*>(out)[i] = (uint16_t)result;
}

// result_stats' per-packet rule: a looked-up result whose action is ALLOW
// or DENY counts once, with the length's (len >> 8, len & 0xFF) columns,
// in row ruleId (< kMaxTargets).  u32 sums wrap modulo 2^32, which is the
// int64 sum reduced to int32, in any order.  Rows below kBlockRows go to
// the block's table `tab`, the rest to the global `stats`.
__device__ __forceinline__ void add_count(uint32_t* cell, uint32_t hi, uint32_t lo) {
  atomicAdd(cell, 1u);
  if (hi) atomicAdd(cell + 1, hi);
  if (lo) atomicAdd(cell + 2, lo);
}

__device__ __forceinline__ void add_stats(uint32_t* tab, uint32_t* __restrict__ stats,
                                          int result, uint32_t pkt_len) {
  const int action = result & 0xFF;
  if (action != kAllow && action != kDeny) return;
  const uint32_t rid = ((uint32_t)result >> 8) & 0xFFFFFFu;
  const uint32_t cell = rid * kStatsCols + (action == kAllow ? 0 : 3);
  const uint32_t hi = (pkt_len >> 8) & 0xFFFFFFu;
  const uint32_t lo = pkt_len & 0xFFu;
  if (rid < (uint32_t)kBlockRows) {
    add_count(tab + cell, hi, lo);  // shared memory
  } else if (rid < (uint32_t)kMaxTargets) {
    add_count(stats + cell, hi, lo);
  }
}

// The block's table to zero before its first packet (then __syncthreads).
__device__ __forceinline__ void zero_stats(uint32_t* tab) {
  for (int k = threadIdx.x; k < kBlockCells; k += blockDim.x) tab[k] = 0u;
}

// After the block's last packet (then no other access to `tab`): its
// non-zero cells added to the global sums.
__device__ __forceinline__ void flush_stats(const uint32_t* tab, uint32_t* __restrict__ stats) {
  __syncthreads();
  for (int k = threadIdx.x; k < kBlockCells; k += blockDim.x) {
    const uint32_t v = tab[k];
    if (v) atomicAdd(stats + k, v);
  }
}

// Words of the read-back buffer: ceil(B / 2) of results, then the
// statistics when `with_stats`.
inline long long out_words(long long B, bool with_stats) {
  return (B + 1) / 2 + (with_stats ? (long long)kMaxTargets * kStatsCols : 0);
}

// The one memset of a fused pass, on `stream`: the statistics and the
// last result word (the pad half of an odd B).  The kernel writes every
// other word.
inline cudaError_t clear_out(uint32_t* out, long long B, bool with_stats, cudaStream_t stream) {
  const long long nw = (B + 1) / 2;
  const long long first = (B & 1) ? nw - 1 : nw;
  const long long n = out_words(B, with_stats) - first;
  if (n <= 0) return cudaSuccess;
  return cudaMemsetAsync(out + first, 0, (size_t)n * sizeof(uint32_t), stream);
}

constexpr int kMaxDevices = 64;

// The persistent grid of `kernel` (`threads` a block) over `work` > 0
// items: the resident blocks (the occupancy maximum per SM times the SM
// count, queried once per device into `cached`), at most one block per
// `threads` items and, when `max_grid` > 0, at most `max_grid` (a test
// forces a small grid so that each thread takes many packets).  The
// occupancy is taken at `smem` bytes of dynamic shared memory a block; a
// kernel launched with several sizes keeps a `cached` per size it queries.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int threads, int* cached, long long work,
                            int max_grid, int* grid, size_t smem = 0) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached[device] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    if (sms * per_sm <= 0) return cudaErrorLaunchOutOfResources;
    cached[device] = sms * per_sm;
  }
  long long g = (work + threads - 1) / threads;
  if (g > cached[device]) g = cached[device];
  if (max_grid > 0 && g > max_grid) g = max_grid;
  *grid = (int)g;
  return cudaSuccess;
}

}  // namespace wire_io
