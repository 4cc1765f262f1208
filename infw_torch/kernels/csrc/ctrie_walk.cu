// K3 on Hopper: ctrie-path longest-prefix match (compressed skip-node walk)
// + ordered first-match scan of the target's joined row, one thread per
// packet.
//
// Replaces the TPU kernel infw/kernels/pallas_walk.py:_make_cwalk_kernel
// (launched by _cwalk_scan), together with the XLA stages around it: the
// DIR-16 root stage (_root_stage, as in jaxpath.ctrie_walk_rows), the
// target resolve, the joined-row gather and rule_scan over the uint16
// packed rows.  Same function, bit for bit, as jaxpath.ctrie_walk_rows +
// joined_rule_rows + rule_scan: for each packet (result, tidx) with tidx
// the longest-prefix entry (-1 when none) and result = (ruleId << 8) |
// action of its first hitting rule, as stored (0 when no rule hits).
//
// What the TPU kernel does and why this one differs: the TPU has no vector
// gather, so the Pallas kernel holds the whole merged node array in VMEM
// as int8 byte planes and fetches each step's 80-byte row with a one-hot
// MXU matmul over every node, runs exactly d_max steps for every lane, and
// emits only the winning target position (the rules tail stays in XLA);
// a VMEM budget plus a deep-tail extraction decide whether it serves.
// Here every read is a direct load from tables in device memory: each
// thread chases its own chain (root LUT, DIR-16 slot, one 80-byte node row
// per step as five 16-byte loads, the target, the joined row).  The
// per-lane bit window is a funnel of two address words, the rank __popc.
// A lane that dies stops (a target needs a live lane, so no result
// changes).  No budget and no extraction: every ctrie table is served.
//
// What bounds it on this card: the chain of dependent loads per packet
// (steps walked + 4), i.e. memory latency, hidden only by the number of
// packets in flight.  At the 10M-entry tier the node rows (~0.4 GB) and
// joined rows (~0.5 GB) do not fit the 50 MB L2, so the chain goes to HBM;
// the bytes it must move are 56 per packet plus the table rows the
// batch's walks touch, each once.
// Design: one thread per packet, 256 per block.
//
// Layouts (built by infw_torch/kernels/cwalk.py:build_ctrie_tables):
//   fields   (B, 8) i32:  kind, ifindex, proto, dport, icmpType, icmpCode,
//                         l4_ok, pkt_len (K1's operand)
//   words    (B, 4) u32:  source-IP words, big-endian
//   root_lut (L,) i32:    ifindex -> level-0 root
//   l0       (n0 * 65536) int2: [node id + 1, tidx + 1] per root slot
//   nodes    (N, 20) u32: [child_base, target_base, skip_len, skip_bits,
//                         child bitmap x8, target bitmap x8]; slot s is bit
//                         s & 31 of bitmap word s >> 5
//   targets  (P,) i32:    tidx + 1 per target position, targets[0] = 0
//   joined   (J, 3 + 5R) u16: [tidx + 1 lo, hi, mask_len, then per rule
//                         ruleId | action << 8, proto | icmpType << 8,
//                         icmpCode, portStart, portEnd], row 0 zero
//   out      (B, 2) i32:  result, tidx
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // packets per block
constexpr int kKindIPv4 = 1;
constexpr int kProtoICMP = 1;
constexpr int kProtoTCP = 6;
constexpr int kProtoUDP = 17;
constexpr int kProtoICMPv6 = 58;
constexpr int kProtoSCTP = 132;

// Logical shifts as XLA defines them: a shift by 32 or more gives 0 (in C
// it is undefined, so every variable shift goes through these).
__device__ __forceinline__ uint32_t shr(uint32_t x, uint32_t s) { return s >= 32u ? 0u : x >> s; }
__device__ __forceinline__ uint32_t shl(uint32_t x, uint32_t s) { return s >= 32u ? 0u : x << s; }

__device__ __forceinline__ uint32_t word_at(const uint4& w, int k) {
  return k == 0 ? w.x : k == 1 ? w.y : k == 2 ? w.z : k == 3 ? w.w : 0u;
}

// The n bits at bit offset pos of the 128-bit address (jaxpath.extract_ip_bits):
// the word index is clipped to [0, 4] and word 4 reads 0; off == 0 takes
// nothing of the next word and n == 0 reads 0.
__device__ __forceinline__ uint32_t extract_bits(const uint4& w, int pos, uint32_t n) {
  const int wi = min(max(pos >> 5, 0), 4);
  const uint32_t lo = word_at(w, wi);
  const uint32_t hi = word_at(w, wi + 1);
  const uint32_t off = (uint32_t)pos & 31u;
  const uint32_t hi_part = off == 0u ? 0u : shr(hi, 32u - off);
  const uint32_t top32 = shl(lo, off) | hi_part;
  return n == 0u ? 0u : shr(top32, 32u - n);
}

__global__ void __launch_bounds__(kThreads)
ctrie_walk_kernel(const int4* __restrict__ fields, const uint4* __restrict__ words,
                  const int* __restrict__ root_lut, const int2* __restrict__ l0,
                  const uint4* __restrict__ nodes, const int* __restrict__ targets,
                  const uint16_t* __restrict__ joined, int2* __restrict__ out, int B,
                  int lut_size, int l0_rows, int n_nodes, int n_targets, int n_joined, int R,
                  int d_max) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= B) return;
  const int4 f0 = fields[2 * i];
  const int4 f1 = fields[2 * i + 1];
  const uint4 w = words[i];
  const int kind = f0.x;
  const int ifx = f0.y;
  const int proto = f0.z;
  const int dport = f0.w;
  const int itype = f1.x;
  const int icode = f1.y;

  // Root stage: the DIR-16 slot of (ifindex, top 16 address bits).  An
  // ifindex outside the LUT reads root 0, the null root.
  const int root = (ifx >= 0 && ifx < lut_size) ? __ldg(root_lut + ifx) : 0;
  const long long e0 = (long long)root * 65536 + (w.x >> 16);
  int best0 = 0;       // the root slot's tidx + 1, 0 = none
  bool alive = false;  // still descending
  int node = 0;
  if (e0 >= 0 && e0 < l0_rows) {
    const int2 r0 = __ldg(l0 + e0);
    if (r0.y > 0) best0 = r0.y;
    alive = r0.x > 0;
    node = r0.x - 1;
  }

  // Up to d_max skip-node steps.  A target counts only if its prefix ends
  // within the kind's cap, tested after the stride (pos <= cap): 32 bits
  // for IPv4, 128 for every other kind.
  const int cap = kind == kKindIPv4 ? 32 : 128;
  int pos = 16;
  uint32_t win = 0;  // flat target position; 0 reads the 0 sentinel
  for (int step = 0; step < d_max && alive; ++step) {
    if (node < 0 || node >= n_nodes) break;  // out of the array: stop (never read)
    const uint4* row = nodes + (size_t)node * 5;
    const uint4 q0 = __ldg(row);      // child_base, target_base, skip_len, skip_bits
    const uint4 c0 = __ldg(row + 1);  // child bitmap words 0-3
    const uint4 c1 = __ldg(row + 2);  // child bitmap words 4-7
    const uint4 t0 = __ldg(row + 3);  // target bitmap words 0-3
    const uint4 t1 = __ldg(row + 4);  // target bitmap words 4-7
    const int skip_len = (int)q0.z;
    if (skip_len > 0 && extract_bits(w, pos, (uint32_t)skip_len) != q0.w) break;  // chain missed
    pos += skip_len;
    const uint32_t nib = extract_bits(w, pos, 8u);
    pos += 8;
    const int wd = (int)(nib >> 5);
    const uint32_t bit = nib & 31u;
    const uint32_t below = (1u << bit) - 1u;
    const uint32_t cb[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
    const uint32_t tb[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
    uint32_t prefix = 0, tprefix = 0, cw = 0, tw = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      prefix += j < wd ? (uint32_t)__popc(cb[j]) : 0u;
      tprefix += j < wd ? (uint32_t)__popc(tb[j]) : 0u;
      cw = j == wd ? cb[j] : cw;
      tw = j == wd ? tb[j] : tw;
    }
    if (((tw >> bit) & 1u) && pos <= cap) win = q0.y + tprefix + (uint32_t)__popc(tw & below);
    alive = (cw >> bit) & 1u;
    node = (int)(q0.x + prefix + (uint32_t)__popc(cw & below));
  }

  // Target resolve: the walk's target, else the root slot's.
  int sel = best0;
  const int wi = (int)win;
  if (wi >= 0 && wi < n_targets) {
    const int tv = __ldg(targets + wi);
    if (tv > 0) sel = tv;
  }

  // Ordered first-match scan (kernel.c:222-258) of the joined row's rules.
  int result = 0;
  if (sel > 0 && sel < n_joined) {
    const uint16_t* rules = joined + (size_t)sel * (3 + 5 * R) + 3;
    const int fam = kind == kKindIPv4 ? kProtoICMP : kProtoICMPv6;
    for (int r = 0; r < R; ++r) {
      const uint16_t* s = rules + 5 * r;
      const int s0 = __ldg(s);
      const int rid = s0 & 0xFF;
      if (rid == 0) continue;  // empty slot
      const int s1 = __ldg(s + 1);
      const int rproto = s1 & 0xFF;
      bool hit = rproto == 0;  // catch-all
      if (!hit && rproto == proto) {
        const int ps = __ldg(s + 3);
        const int pe = __ldg(s + 4);
        const bool transport =
            rproto == kProtoTCP || rproto == kProtoUDP || rproto == kProtoSCTP;
        // single port when portEnd == 0, else the half-open [start, end)
        const bool port_hit = pe == 0 ? dport == ps : (dport >= ps && dport < pe);
        hit = (transport && port_hit) ||
              (rproto == fam && (s1 >> 8) == itype && (int)__ldg(s + 2) == icode);
      }
      if (hit) {
        result = (rid << 8) | (s0 >> 8);
        break;
      }
    }
  }
  out[i] = make_int2(result, sel - 1);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); allocates nothing.
// Every pointer 16-byte aligned (the Python wrapper checks).
extern "C" int infw_ctrie_walk(const void* fields, const void* words, const void* root_lut,
                               const void* l0, const void* nodes, const void* targets,
                               const void* joined, void* out, int B, int lut_size, int l0_rows,
                               int n_nodes, int n_targets, int n_joined, int R, int d_max,
                               void* stream) {
  if (B > 0) {
    const int grid = (B + kThreads - 1) / kThreads;
    ctrie_walk_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int4*)fields, (const uint4*)words, (const int*)root_lut, (const int2*)l0,
        (const uint4*)nodes, (const int*)targets, (const uint16_t*)joined, (int2*)out, B,
        lut_size, l0_rows, n_nodes, n_targets, n_joined, R, d_max);
  }
  return (int)cudaGetLastError();
}
