// K2 on Hopper: trie-path longest-prefix match (poptrie walk) + ordered
// first-match rule scan, one thread per packet.
//
// Replaces the TPU kernel infw/kernels/pallas_walk.py:_make_walk_kernel
// (launched by _walk_scan), together with the XLA stages around it: the
// DIR-16 root stage (_root_stage, = level 0 of jaxpath.trie_walk), the
// level walk and target resolve of jaxpath.trie_walk, and
// gather_rule_rows + rule_scan.  Same function, bit for bit: for each
// packet (result, tidx) with tidx the longest-prefix entry (-1 when none)
// and result = (ruleId << 8) | action of its first hitting rule, both
// masked as stored (24 and 8 bits; 0 when no rule hits).
//
// What the TPU kernel does and why this one differs: the TPU has no vector
// gather, so the Pallas kernel holds each level's node rows in VMEM as
// int8 byte planes and fetches a packet's row with a one-hot MXU matmul,
// and a VMEM budget plus a deep-tail extraction decide whether it can
// serve a table at all.  Here every read is a direct load: each thread
// chases its own chain of dependent loads (root LUT, DIR-16 slot, one
// 72-byte node row per level, the target, the rule row) through the
// tables, which stay in device memory and, at 100K entries (~40 MB), mostly
// in the 50 MB L2.  The popcount rank is __popc.  There is no budget and
// no extraction: every trie table is served, at any depth.
//
// What bounds it on this card: the chain of dependent loads per packet
// (levels walked + 3), i.e. memory latency, hidden only by the number of
// packets in flight; the bytes it must move are 56 per packet plus the
// table rows the batch's walks touch, each once.  Design: one thread per
// packet, 256 per block, so 2^20 packets give 4096 blocks to cover the
// 132 SMs many times over; a lane that leaves the trie stops walking.
//
// Layouts (built by infw_torch/kernels/walk.py:build_trie_tables):
//   fields     (B, 8) i32:  kind, ifindex, proto, dport, icmpType, icmpCode,
//                           l4_ok, pkt_len (K1's operand)
//   words      (B, 4) u32:  source-IP words, big-endian
//   root_lut   (L,) i32:    ifindex -> level-0 node
//   l0         (n0 * 65536) int2: [child + 1, target + 1] per root slot
//   deep       (N, 18) u32: node rows [child_base, target_base, child
//                           bitmap x8, target bitmap x8], levels 1..
//                           concatenated; slot s is bit s & 31 of word s >> 5
//   level_rows (n - 1) int2: [first row, row count] of each deep level
//   targets    (P,) i32:    target + 1, targets[0] = 0
//   rules      (T, R, 7) i32: ruleId, proto, portStart, portEnd, icmpType,
//                           icmpCode, action
//   out        (B, 2) i32:  result, tidx
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // packets per block
constexpr int kRowWords = 18;
constexpr int kRuleCols = 7;
constexpr int kKindIPv4 = 1;
constexpr int kProtoICMP = 1;
constexpr int kProtoTCP = 6;
constexpr int kProtoUDP = 17;
constexpr int kProtoICMPv6 = 58;
constexpr int kProtoSCTP = 132;

__global__ void __launch_bounds__(kThreads)
trie_walk_kernel(const int4* __restrict__ fields, const uint4* __restrict__ words,
                 const int* __restrict__ root_lut, const int2* __restrict__ l0,
                 const uint32_t* __restrict__ deep, const int2* __restrict__ level_rows,
                 const int* __restrict__ targets, const int* __restrict__ rules,
                 int2* __restrict__ out, int B, int lut_size, int l0_rows,
                 int n_targets, int T, int R, int n_levels) {
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

  // Level 0: the DIR-16 root slot of (ifindex, top 16 address bits).  An
  // ifindex outside the LUT reads root 0, the null node.
  const int root = (ifx >= 0 && ifx < lut_size) ? __ldg(root_lut + ifx) : 0;
  const long long e0 = (long long)root * 65536 + (w.x >> 16);
  int best0 = -1;      // the root slot's target, -1 = none
  bool alive = false;  // still descending
  int node = 0;
  if (e0 >= 0 && e0 < l0_rows) {
    const int2 r0 = __ldg(l0 + e0);
    if (r0.y > 0) best0 = r0.y - 1;
    alive = r0.x > 0;
    node = r0.x - 1;
  }

  // Levels 1..n_levels-1: one node row each.  Targets at a level cover
  // prefixes ending at its bit boundary or above the previous one; IPv4
  // packets accept none beyond /32 (kernel.c:207), every other kind /128.
  const int cap = kind == kKindIPv4 ? 32 : 128;
  uint32_t win = 0;  // index into targets; 0 reads the 0 sentinel
  for (int l = 1; l < n_levels && alive; ++l) {
    const int2 lr = __ldg(level_rows + (l - 1));
    if (node < 0 || node >= lr.y) break;  // out of the level: stop (never read)
    const int bit_start = 16 + 8 * (l - 1);
    const uint32_t word = bit_start < 32 ? w.x : bit_start < 64 ? w.y : bit_start < 96 ? w.z : w.w;
    const uint32_t nib = (word >> (24 - (bit_start & 31))) & 0xFFu;
    const uint32_t* row = deep + (size_t)(lr.x + node) * kRowWords;
    const int wd = (int)(nib >> 5);
    const uint32_t bit = nib & 31u;
    const uint32_t below = (1u << bit) - 1u;
    uint32_t prefix = 0, tprefix = 0;
    for (int j = 0; j < wd; ++j) {
      prefix += __popc(__ldg(row + 2 + j));
      tprefix += __popc(__ldg(row + 10 + j));
    }
    const uint32_t cw = __ldg(row + 2 + wd);
    const uint32_t tw = __ldg(row + 10 + wd);
    if (((tw >> bit) & 1u) && bit_start + 8 <= cap)
      win = __ldg(row + 1) + tprefix + __popc(tw & below);
    alive = (cw >> bit) & 1u;
    node = (int)(__ldg(row) + prefix + __popc(cw & below));
  }

  // Target resolve: the deepest level's target, else the root slot's.
  int tidx = best0;
  const int wi = (int)win;
  if (wi >= 0 && wi < n_targets) {
    const int tv = __ldg(targets + wi);
    if (tv > 0) tidx = tv - 1;
  }

  // Ordered first-match scan (kernel.c:222-258) of the target's rule row.
  int result = 0;
  if (tidx >= 0 && tidx < T) {
    const int* row = rules + (size_t)tidx * R * kRuleCols;
    const int fam = kind == kKindIPv4 ? kProtoICMP : kProtoICMPv6;
    for (int r = 0; r < R; ++r) {
      const int* s = row + r * kRuleCols;
      const int rid = __ldg(s);
      if (rid == 0) continue;  // empty slot
      const int rproto = __ldg(s + 1);
      bool hit = rproto == 0;  // catch-all
      if (!hit && rproto == proto) {
        const int ps = __ldg(s + 2);
        const int pe = __ldg(s + 3);
        const bool transport =
            rproto == kProtoTCP || rproto == kProtoUDP || rproto == kProtoSCTP;
        // single port when portEnd == 0, else the half-open [start, end)
        const bool port_hit = pe == 0 ? dport == ps : (dport >= ps && dport < pe);
        hit = (transport && port_hit) ||
              (rproto == fam && __ldg(s + 4) == itype && __ldg(s + 5) == icode);
      }
      if (hit) {
        result = (int)((((uint32_t)rid & 0xFFFFFFu) << 8) | ((uint32_t)__ldg(s + 6) & 0xFFu));
        break;
      }
    }
  }
  out[i] = make_int2(result, tidx);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); allocates nothing.
// 1 <= n_levels <= 1 + the rows of level_rows, and every pointer 16-byte
// aligned (the Python wrapper checks both).
extern "C" int infw_trie_walk(const void* fields, const void* words, const void* root_lut,
                              const void* l0, const void* deep, const void* level_rows,
                              const void* targets, const void* rules, void* out, int B,
                              int lut_size, int l0_rows, int n_targets, int T, int R,
                              int n_levels, void* stream) {
  if (B > 0) {
    const int grid = (B + kThreads - 1) / kThreads;
    trie_walk_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int4*)fields, (const uint4*)words, (const int*)root_lut, (const int2*)l0,
        (const uint32_t*)deep, (const int2*)level_rows, (const int*)targets,
        (const int*)rules, (int2*)out, B, lut_size, l0_rows, n_targets, T, R, n_levels);
  }
  return (int)cudaGetLastError();
}
