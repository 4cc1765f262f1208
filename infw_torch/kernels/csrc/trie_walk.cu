// K2 on Hopper: trie-path longest-prefix match (poptrie walk) + ordered
// first-match rule scan, as a persistent lane-refilling walk.
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
// table rows the batch's walks touch, each once.
// Design: with one thread per packet (the first design) a warp steps until
// the deepest of its 32 packets is done: on the 100K table the mean walk
// reads under two node rows and the warp's deepest about ten, and the
// same kernel on the batch sorted by depth ran 21% faster.  So the kernel
// is persistent and refills the lanes whose packets are done (the loop
// below).  A node row (72 bytes, 8-byte aligned) is read as nine 8-byte
// loads issued together and ranked with unrolled selects; the level
// offsets sit in shared memory.  Output stores are 8 bytes per packet,
// scattered.
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

constexpr int kThreads = 256;  // threads per block
constexpr int kRowWords = 18;
constexpr int kMaxDeep = 14;  // deep levels of a /128 trie (16 + 8 x 14 bits)
constexpr int kRuleCols = 7;
constexpr int kKindIPv4 = 1;
constexpr int kProtoICMP = 1;
constexpr int kProtoTCP = 6;
constexpr int kProtoUDP = 17;
constexpr int kProtoICMPv6 = 58;
constexpr int kProtoSCTP = 132;

// The lane-refilling loop (the "while-while" traversal with persistent
// threads that replace finished lanes: Aila and Laine, HPG 2009).  A grid
// of resident blocks stays on the card, each warp owns a sequence of
// packets, and each lane holds one packet's walk state.  A warp's sequence
// is every W-th 32-packet chunk of the batch (W the warps of the grid), so
// packets that arrive sorted or clustered by depth still spread over all
// warps.  The warp loops in rounds: every lane without a packet takes the
// next one of the sequence (ranked by a ballot over the lanes that need
// one, so a round's entries read consecutive packets of a chunk); then the
// walking lanes take one node row at a time while at least kMinWalking of
// them still walk, or while the sequence is used up; then every lane whose
// walk ended retires its packet (target resolve, rule scan, store).
// Refilling a lane as soon as its packet ends would run the entry and the
// retire code, which the whole warp waits through, once per step (that
// design was no faster than one thread per packet); ending a round at
// kMinWalking runs them once for about half a warp of packets.  No global
// atomics, no scratch to reset, no grid barrier, no co-residency
// requirement; every lane runs the loop to its end (a ballot over exited
// lanes is undefined).

// Below this many walking lanes a round ends and the finished lanes are
// refilled (while the sequence has packets).
constexpr int kMinWalking = 16;

// The loop, for every thread of the block.  enter(i) loads packet i's
// entry state and returns whether its walk goes on; step() takes one
// dependent step of a walking lane and returns whether the walk goes on;
// retire(i) resolves, scans and stores packet i.  Each lane's state lives
// in the caller's variables, which enter() must reset whole.
template <typename Enter, typename Step, typename Retire>
__device__ __forceinline__ void refill_walk(int B, Enter enter, Step step, Retire retire) {
  const unsigned lane = threadIdx.x & 31u;
  const unsigned before = (1u << lane) - 1u;
  const long long warps = (long long)gridDim.x * (blockDim.x >> 5);
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  // The warp's sequence: chunks warp, warp + warps, ...; the batch's last
  // chunk may be short.
  const long long chunks = ((long long)B + 31) >> 5;
  const long long mine = warp < chunks ? (chunks - warp + warps - 1) / warps : 0;
  long long end = mine * 32;  // the sequence's length
  if (mine > 0) {
    const long long last = B - (warp + (mine - 1) * warps) * 32;
    end -= 32 - (last < 32 ? last : 32);
  }
  long long next = 0;    // the sequence's next unclaimed position (uniform)
  int i = -1;            // this lane's packet, -1 = none
  bool walking = false;  // its walk goes on
  for (;;) {
    const unsigned need = __ballot_sync(0xFFFFFFFFu, i < 0);
    if (i < 0) {
      const long long s = next + __popc(need & before);
      if (s < end) {
        i = (int)((warp + (s >> 5) * warps) * 32 + (s & 31));
        walking = enter(i);
      }
    }
    next += __popc(need);
    if (!__any_sync(0xFFFFFFFFu, i >= 0)) break;
    // While the sequence has packets, every lane holds one, so a lane
    // that does not walk is done and a round that ends retires at least
    // one.
    for (;;) {
      const int n = __popc(__ballot_sync(0xFFFFFFFFu, walking));
      if (n == 0 || (n < kMinWalking && next < end)) break;
      if (walking) walking = step();
    }
    if (i >= 0 && !walking) {
      retire(i);
      i = -1;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
trie_walk_kernel(const int4* __restrict__ fields, const uint4* __restrict__ words,
                 const int* __restrict__ root_lut, const int2* __restrict__ l0,
                 const uint32_t* __restrict__ deep, const int2* __restrict__ level_rows,
                 const int* __restrict__ targets, const int* __restrict__ rules,
                 int2* __restrict__ out, int B, int lut_size, int l0_rows,
                 int n_targets, int T, int R, int n_levels) {
  __shared__ int2 s_rows[kMaxDeep];  // [first row, row count] of each deep level
  for (int k = threadIdx.x; k < n_levels - 1; k += kThreads) s_rows[k] = __ldg(level_rows + k);
  __syncthreads();

  // this lane's walk state, reset whole by enter()
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  int kind = 0, proto = 0, dport = 0, itype = 0, icode = 0, cap = 0;
  int best0 = -1;      // the root slot's target, -1 = none
  bool alive = false;  // still descending
  int node = 0, level = 1;
  uint32_t win = 0;  // index into targets; 0 reads the 0 sentinel

  refill_walk(
      B,
      [&](int i) -> bool {
        const int4 f0 = fields[2 * i];
        const int4 f1 = fields[2 * i + 1];
        w = words[i];
        kind = f0.x;
        proto = f0.z;
        dport = f0.w;
        itype = f1.x;
        icode = f1.y;
        // Targets at a level cover prefixes ending at its bit boundary or
        // above the previous one; IPv4 packets accept none beyond /32
        // (kernel.c:207), every other kind /128.
        cap = kind == kKindIPv4 ? 32 : 128;
        // Level 0: the DIR-16 root slot of (ifindex, top 16 address bits).
        // An ifindex outside the LUT reads root 0, the null node.
        const int ifx = f0.y;
        const int root = (ifx >= 0 && ifx < lut_size) ? __ldg(root_lut + ifx) : 0;
        const long long e0 = (long long)root * 65536 + (w.x >> 16);
        best0 = -1;
        alive = false;
        node = 0;
        if (e0 >= 0 && e0 < l0_rows) {
          const int2 r0 = __ldg(l0 + e0);
          if (r0.y > 0) best0 = r0.y - 1;
          alive = r0.x > 0;
          node = r0.x - 1;
        }
        level = 1;
        win = 0;
        return alive && level < n_levels;
      },
      // Levels 1..n_levels-1: one node row each.
      [&]() -> bool {
        const int2 lr = s_rows[level - 1];
        if (node < 0 || node >= lr.y) return false;  // out of the level: stop (never read)
        const int bit_start = 16 + 8 * (level - 1);
        const uint32_t word =
            bit_start < 32 ? w.x : bit_start < 64 ? w.y : bit_start < 96 ? w.z : w.w;
        const uint32_t nib = (word >> (24 - (bit_start & 31))) & 0xFFu;
        const uint2* row = reinterpret_cast<const uint2*>(deep + (size_t)(lr.x + node) * kRowWords);
        uint2 q[9];  // child_base, target_base; child bitmap x8; target bitmap x8
#pragma unroll
        for (int k = 0; k < 9; ++k) q[k] = __ldg(row + k);
        const uint32_t cb[8] = {q[1].x, q[1].y, q[2].x, q[2].y, q[3].x, q[3].y, q[4].x, q[4].y};
        const uint32_t tb[8] = {q[5].x, q[5].y, q[6].x, q[6].y, q[7].x, q[7].y, q[8].x, q[8].y};
        const int wd = (int)(nib >> 5);
        const uint32_t bit = nib & 31u;
        const uint32_t below = (1u << bit) - 1u;
        uint32_t prefix = 0, tprefix = 0, cw = 0, tw = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          prefix += j < wd ? (uint32_t)__popc(cb[j]) : 0u;
          tprefix += j < wd ? (uint32_t)__popc(tb[j]) : 0u;
          cw = j == wd ? cb[j] : cw;
          tw = j == wd ? tb[j] : tw;
        }
        if (((tw >> bit) & 1u) && bit_start + 8 <= cap)
          win = q[0].y + tprefix + (uint32_t)__popc(tw & below);
        alive = (cw >> bit) & 1u;
        node = (int)(q[0].x + prefix + (uint32_t)__popc(cw & below));
        ++level;
        return alive && level < n_levels;
      },
      [&](int i) {
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
      });
}

constexpr int kMaxDevices = 64;

// The persistent grid over `B` > 0 packets: the resident blocks (the
// occupancy maximum per SM times the SM count, queried once per device),
// at most one block per kThreads packets and, when `max_grid` > 0, at
// most `max_grid` (a test forces a small grid so that every lane refills
// many times).
cudaError_t grid_for(int B, int max_grid, int* grid) {
  static int cached[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached[device] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, trie_walk_kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    if (sms * per_sm <= 0) return cudaErrorLaunchOutOfResources;
    cached[device] = sms * per_sm;
  }
  int g = (B + kThreads - 1) / kThreads;
  if (g > cached[device]) g = cached[device];
  if (max_grid > 0 && g > max_grid) g = max_grid;
  *grid = g;
  return cudaSuccess;
}

}  // namespace

// Launches on `stream` and returns its error, else cudaGetLastError();
// allocates nothing.  1 <= n_levels <= 1 + the rows of level_rows <= 15,
// and every pointer 16-byte aligned (the Python wrapper checks both).
// max_grid > 0 caps the grid (tests); 0 takes the resident blocks.
extern "C" int infw_trie_walk(const void* fields, const void* words, const void* root_lut,
                              const void* l0, const void* deep, const void* level_rows,
                              const void* targets, const void* rules, void* out, int B,
                              int lut_size, int l0_rows, int n_targets, int T, int R,
                              int n_levels, int max_grid, void* stream) {
  if (n_levels < 1 || n_levels > kMaxDeep + 1) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    int grid = 0;
    const cudaError_t err = grid_for(B, max_grid, &grid);
    if (err != cudaSuccess) return (int)err;
    trie_walk_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int4*)fields, (const uint4*)words, (const int*)root_lut, (const int2*)l0,
        (const uint32_t*)deep, (const int2*)level_rows, (const int*)targets,
        (const int*)rules, (int2*)out, B, lut_size, l0_rows, n_targets, T, R, n_levels);
  }
  return (int)cudaGetLastError();
}
