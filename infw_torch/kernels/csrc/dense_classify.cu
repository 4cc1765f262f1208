// K1 on Hopper: dense-path longest-prefix match + ordered first-match rule
// scan, one thread per packet.
//
// Replaces the TPU kernel infw/kernels/pallas_dense.py:_classify_kernel
// (launched by _pallas_scan).  Same function, bit for bit: for each packet
// (result, tidx) with result = (ruleId << 8) | action of the first hitting
// rule of the longest-prefix entry (0 when none) and tidx the entry index
// (-1 when no entry matches).
//
// What the TPU kernel does and why this one differs: the TPU has no vector
// gather, so it unpacks the 160-bit key to bits and counts in-mask
// mismatches with an int8 matmul against every entry, then fetches the
// matched rule row with a one-hot matmul.  Here an entry matches iff
// ((key_w ^ pkt_w) & mask_w) == 0 for all five 32-bit words — the same
// zero-mismatch condition — and the matched row is read directly.
//
// What bounds it on this card: the compare-all LPM does B x Tp entry tests
// (2^20 x 1024 at the headline shape), so the kernel is bound by integer
// ALU and shared-memory issue, far above the ~0.02 ms it takes to stream
// its 56 bytes per packet.  Design: the (key, mask, mask_len) rows are
// staged 128 entries at a time into shared memory, where every thread of a
// warp reads the same entry (a broadcast, no bank conflicts) as three
// 16-byte loads; the winner is kept in registers (strictly greater score
// replaces, which reproduces "first index wins").  The matched target's
// rule slots (8 bytes each) are read straight from global memory, where the
// whole table stays L2-resident, and the scan stops at the first hit.  A
// tensor-core form of the LPM (int8 mma over the bit expansion) is a later
// step.
//
// Packed layouts (built by infw_torch/kernels/dense.py:build_dense_tables):
//   entries (Tp, 12) u32: key0..key4, mask0..mask4, mask_len (-1 = never
//                         matches; pads Tp to a multiple of 128), 0
//   rules   (Tp, R) uint2: x = ridAct | proto << 8 | icmpType << 16 |
//                              icmpCode << 24, ridAct = ruleId << 1 | (action - 1)
//                          y = portStart | portEnd << 16
//   fields  (B, 8) i32:    kind, ifindex, proto, dport, icmpType, icmpCode,
//                          l4_ok, pkt_len  (the TPU kernel's operand)
//   words   (B, 4) u32:    source-IP words, big-endian
//   out     (B, 2) i32:    result, tidx
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // packets per block
constexpr int kTile = 128;     // entries staged in shared memory per pass
constexpr int kKindIPv4 = 1;
constexpr int kProtoICMP = 1;
constexpr int kProtoTCP = 6;
constexpr int kProtoUDP = 17;
constexpr int kProtoICMPv6 = 58;
constexpr int kProtoSCTP = 132;

__global__ void __launch_bounds__(kThreads)
dense_classify_kernel(const int4* __restrict__ fields,
                      const uint4* __restrict__ words,
                      const uint4* __restrict__ entries,
                      const uint2* __restrict__ rules,
                      int2* __restrict__ out, int B, int Tp, int R) {
  __shared__ uint4 tile[kTile * 3];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < B;
  // Threads past the batch end still stage tiles; they act as KIND_OTHER
  // packets and store nothing.
  int4 f0 = make_int4(3, 0, 0, 0);
  int4 f1 = make_int4(0, 0, 0, 0);
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  if (live) {
    f0 = fields[2 * i];
    f1 = fields[2 * i + 1];
    w = words[i];
  }
  const int kind = f0.x;
  const uint32_t ifx = (uint32_t)f0.y;
  const int proto = f0.z;
  const int dport = f0.w;
  const int itype = f1.x;
  const int icode = f1.y;
  // Packet-side key cap (kernel.c:207,293): /32 for IPv4, /128 otherwise.
  const int cap = kind == kKindIPv4 ? 32 : 128;

  int best = 0;  // mask_len + 1 of the longest match so far, 0 = none
  int tidx = -1;
  for (int base = 0; base < Tp; base += kTile) {
    __syncthreads();
    for (int j = threadIdx.x; j < kTile * 3; j += kThreads)
      tile[j] = entries[(size_t)base * 3 + j];
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < kTile; ++t) {
      const uint4 a = tile[3 * t];      // key0..key3
      const uint4 b = tile[3 * t + 1];  // key4, mask0..mask2
      const uint4 c = tile[3 * t + 2];  // mask3, mask4, mask_len, 0
      const uint32_t diff = ((ifx ^ a.x) & b.y) | ((w.x ^ a.y) & b.z) |
                            ((w.y ^ a.z) & b.w) | ((w.z ^ a.w) & c.x) |
                            ((w.w ^ b.x) & c.y);
      const int mlen = (int)c.z;
      if (diff == 0u && mlen >= 0 && mlen <= cap && mlen + 1 > best) {
        best = mlen + 1;
        tidx = base + t;
      }
    }
  }

  // Ordered first-match scan (kernel.c:222-258).
  int result = 0;
  if (tidx >= 0) {
    const uint2* row = rules + (size_t)tidx * R;
    const int fam = kind == kKindIPv4 ? kProtoICMP : kProtoICMPv6;
    for (int r = 0; r < R; ++r) {
      const uint2 v = __ldg(row + r);
      const uint32_t rid_act = v.x & 0xFFu;
      const int rid = (int)(rid_act >> 1);
      if (rid == 0) continue;  // empty slot
      const int rproto = (int)((v.x >> 8) & 0xFFu);
      bool hit = rproto == 0;  // catch-all
      if (!hit && rproto == proto) {
        const int it = (int)((v.x >> 16) & 0xFFu);
        const int ic = (int)(v.x >> 24);
        const int ps = (int)(v.y & 0xFFFFu);
        const int pe = (int)(v.y >> 16);
        const bool transport =
            rproto == kProtoTCP || rproto == kProtoUDP || rproto == kProtoSCTP;
        // single port when portEnd == 0, else the half-open [start, end)
        const bool port_hit = pe == 0 ? dport == ps : (dport >= ps && dport < pe);
        hit = (transport && port_hit) ||
              (rproto == fam && it == itype && ic == icode);
      }
      if (hit) {
        result = (rid << 8) | (int)((rid_act & 1u) + 1u);
        break;
      }
    }
  }
  if (live) out[i] = make_int2(result, tidx);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); allocates nothing.
// Tp must be a multiple of 128 and every pointer 16-byte aligned (the
// Python wrapper checks both).
extern "C" int infw_dense_classify(const void* fields, const void* words,
                                   const void* entries, const void* rules,
                                   void* out, int B, int Tp, int R,
                                   void* stream) {
  if (B > 0) {
    const int grid = (B + kThreads - 1) / kThreads;
    dense_classify_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int4*)fields, (const uint4*)words, (const uint4*)entries,
        (const uint2*)rules, (int2*)out, B, Tp, R);
  }
  return (int)cudaGetLastError();
}
