// The compressed skip-node walk's arithmetic, shared by K3 (ctrie_walk.cu,
// one table) and K3b (arena_ctrie_walk.cu, the multi-tenant pool): one
// skip-node step, the target resolve and the ordered joined-row scan, and
// descend_scan, the per-packet walk over them (scan_rules, the row scan,
// also serves K6's dense slabs).  Each kernel runs its own
// entry stage (the DIR-16 root slot).  Together they are the same bit for
// bit as jaxpath._ctrie_descend + the target resolve + joined_rule_rows +
// rule_scan over the uint16 packed rows.
//
// Layouts:
//   words    (B, 4) u32:  source-IP words, big-endian
//   nodes    (N, 20) u32: [child_base, target_base, skip_len, skip_bits,
//                         child bitmap x8, target bitmap x8]; slot s is bit
//                         s & 31 of bitmap word s >> 5
//   targets  (P,) i32:    joined position per target position, 0 = none
//   joined   (J, 3 + 5R) u16: [tidx + 1 lo, hi, mask_len, then per rule
//                         ruleId | action << 8, proto | icmpType << 8,
//                         icmpCode, portStart, portEnd], row 0 zero
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ctrie {

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

// One skip-node step from `node` at bit position `pos`: reads the node's
// 80-byte row as five 16-byte loads, checks its absorbed chain bits,
// consumes the 8-bit stride and rank-indexes the children with unrolled
// selects.  A target counts only if its prefix ends within `cap` (32 bits
// for IPv4, 128 for every other kind), tested after the stride; it sets
// `win`, the flat target position.  Returns whether the walk goes on (the
// child bit); a node outside the array (never read) or a missed chain
// stops it, leaving `node`, `pos` and `win` as they were.
__device__ __forceinline__ bool step(const uint4& w, int cap, int& node, int& pos, uint32_t& win,
                                     const uint4* __restrict__ nodes, int n_nodes) {
  if (node < 0 || node >= n_nodes) return false;  // out of the array: stop (never read)
  const uint4* row = nodes + (size_t)node * 5;
  const uint4 q0 = __ldg(row);      // child_base, target_base, skip_len, skip_bits
  const uint4 c0 = __ldg(row + 1);  // child bitmap words 0-3
  const uint4 c1 = __ldg(row + 2);  // child bitmap words 4-7
  const uint4 t0 = __ldg(row + 3);  // target bitmap words 0-3
  const uint4 t1 = __ldg(row + 4);  // target bitmap words 4-7
  const int skip_len = (int)q0.z;
  if (skip_len > 0 && extract_bits(w, pos, (uint32_t)skip_len) != q0.w) return false;  // missed
  const int p = pos + skip_len;
  const uint32_t nib = extract_bits(w, p, 8u);
  pos = p + 8;
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
  node = (int)(q0.x + prefix + (uint32_t)__popc(cw & below));
  return (cw >> bit) & 1u;
}

// Target resolve: the walk's target (targets[win], when in range and
// non-zero), else the root slot's `best0`.  Returns sel, the joined
// position, 0 = none.
__device__ __forceinline__ int resolve(uint32_t win, int best0, const int* __restrict__ targets,
                                       int n_targets) {
  const int wi = (int)win;
  if (wi >= 0 && wi < n_targets) {
    const int tv = __ldg(targets + wi);
    if (tv > 0) return tv;
  }
  return best0;
}

// The ordered first-match scan (kernel.c:222-258) of one packed rule row
// (R rules of five u16): (ruleId << 8) | action of the first hitting rule
// as stored, 0 when none.  K6 (arena_dense.cu) scans its slab rows with it.
__device__ __forceinline__ int scan_rules(const uint16_t* __restrict__ rules, int R, int kind,
                                          int proto, int dport, int itype, int icode) {
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
      const bool transport = rproto == kProtoTCP || rproto == kProtoUDP || rproto == kProtoSCTP;
      // single port when portEnd == 0, else the half-open [start, end)
      const bool port_hit = pe == 0 ? dport == ps : (dport >= ps && dport < pe);
      hit = (transport && port_hit) ||
            (rproto == fam && (s1 >> 8) == itype && (int)__ldg(s + 2) == icode);
    }
    if (hit) return (rid << 8) | (s0 >> 8);
  }
  return 0;
}

// The scan of joined row `sel`: 0 when sel is 0 or past the rows.
__device__ __forceinline__ int scan(int sel, int kind, int proto, int dport, int itype, int icode,
                                    const uint16_t* __restrict__ joined, int n_joined, int R) {
  if (sel <= 0 || sel >= n_joined) return 0;
  return scan_rules(joined + (size_t)sel * (3 + 5 * R) + 3, R, kind, proto, dport, itype, icode);
}

// One packet's walk from a resolved entry (alive, node = the first
// skip node, best0 = the root slot's joined position or 0): up to d_max
// steps, the target resolve and the scan.  Returns (result, sel - 1).
__device__ __forceinline__ int2 descend_scan(
    const uint4& w, int kind, int proto, int dport, int itype, int icode, bool alive, int node,
    int best0, const uint4* __restrict__ nodes, const int* __restrict__ targets,
    const uint16_t* __restrict__ joined, int n_nodes, int n_targets, int n_joined, int R,
    int d_max) {
  const int cap = kind == kKindIPv4 ? 32 : 128;
  int pos = 16;
  uint32_t win = 0;  // flat target position; 0 reads the 0 sentinel
  for (int s = 0; s < d_max && alive; ++s) alive = step(w, cap, node, pos, win, nodes, n_nodes);
  const int sel = resolve(win, best0, targets, n_targets);
  return make_int2(scan(sel, kind, proto, dport, itype, icode, joined, n_joined, R), sel - 1);
}

}  // namespace ctrie
