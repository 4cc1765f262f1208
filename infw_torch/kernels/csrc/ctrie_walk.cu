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
// Design: one thread per packet, 256 per block.  A warp steps until the
// deepest of its 32 packets is done, but K3's walks are shallow and even
// (on the 100K table one skip step per packet on average, four for the
// warp's deepest): the same kernel on the batch sorted by depth is at
// best 10% faster, and the lane-refilling schedule K2 runs
// (trie_walk.cu) costs more than that, so it is not used here.
//
// Two entry points over the same walk:
// - infw_ctrie_walk: (fields, words) -> (B, 2) [result, tidx], for the
//   callers that need the tidx or a decoded batch (the overlay combine,
//   the delta path, the depth tooling);
// - infw_ctrie_wire_fused: the whole device pass of a classify in one
//   launch, wire to verdict (jaxpath.jitted_classify_ctrie_wire_fused and
//   jitted_classify_ctrie_wire8_fused; pallas_walk.
//   jitted_classify_cwalk_wire_fused).  Around the walk, the composed pass
//   ran some 40 torch ops that moved more bytes than the walk: the wire
//   unpacked into nine int32 columns, restacked into fields, a (B, 6)
//   int64 stats operand and its index_add_, the int64 res16 packing.
//   Here each thread decodes its wire row in registers, skips the walk of
//   a lane finalize zeroes (not IP, or no L4 header), writes its u16
//   result straight into the read-back buffer and adds its statistics to
//   the block's shared-memory table (wire_io.cuh); the grid is persistent,
//   so each block zeroes and flushes its table once.  One memset (the
//   statistics and the last result word) and one kernel per pass; the
//   bytes it must move are the wire (8-28 per packet) and 2 of result,
//   plus the table rows the walks touch and the 24 KiB of statistics.
//
// Layouts (built by infw_torch/kernels/cwalk.py:build_ctrie_tables; nodes,
// targets and joined as in ctrie_walk.cuh, where the descent, the target
// resolve and the scan live, shared with K3b):
//   fields   (B, 8) i32:  kind, ifindex, proto, dport, icmpType, icmpCode,
//                         l4_ok, pkt_len (K1's operand)
//   words    (B, 4) u32:  source-IP words, big-endian
//   root_lut (L,) i32:    ifindex -> level-0 root
//   l0       (n0 * 65536) int2: [node id + 1, tidx + 1] per root slot
//   targets  (P,) i32:    tidx + 1 per target position, targets[0] = 0
//   out      (B, 2) i32:  result, tidx (infw_ctrie_walk); the fused
//                         entry's wire and read-back buffer: wire_io.cuh
#include <cuda_runtime.h>
#include <stdint.h>

#include "ctrie_walk.cuh"
#include "wire_io.cuh"

namespace {

constexpr int kThreads = 256;  // packets per block

// The root stage: the DIR-16 slot of (ifindex, top 16 address bits).  An
// ifindex outside the LUT reads root 0, the null root.  Sets `alive`
// (still descending), `node` (the first skip node) and `best0` (the root
// slot's tidx + 1, 0 = none).
__device__ __forceinline__ void root_entry(int ifx, const uint4& w, const int* __restrict__ root_lut,
                                           const int2* __restrict__ l0, int lut_size, int l0_rows,
                                           bool& alive, int& node, int& best0) {
  const int root = (ifx >= 0 && ifx < lut_size) ? __ldg(root_lut + ifx) : 0;
  const long long e0 = (long long)root * 65536 + (w.x >> 16);
  best0 = 0;
  alive = false;
  node = 0;
  if (e0 >= 0 && e0 < l0_rows) {
    const int2 r0 = __ldg(l0 + e0);
    if (r0.y > 0) best0 = r0.y;
    alive = r0.x > 0;
    node = r0.x - 1;
  }
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
  bool alive;
  int node, best0;
  root_entry(f0.y, w, root_lut, l0, lut_size, l0_rows, alive, node, best0);

  // The skip-node descent, target resolve and ordered joined-row scan.
  out[i] = ctrie::descend_scan(w, f0.x, f0.z, f0.w, f1.x, f1.y, alive, node, best0, nodes,
                               targets, joined, n_nodes, n_targets, n_joined, R, d_max);
}

// The fused pass over a (B, W) wire: each thread takes every
// (gridDim.x * kThreads)-th packet.  kStats: the statistics too (every
// width but wire8).
template <int W, bool kStats>
__global__ void __launch_bounds__(kThreads)
ctrie_wire_fused_kernel(const uint32_t* __restrict__ wire, const int* __restrict__ ifmap,
                        int n_ifmap, const int* __restrict__ root_lut,
                        const int2* __restrict__ l0, const uint4* __restrict__ nodes,
                        const int* __restrict__ targets, const uint16_t* __restrict__ joined,
                        uint32_t* __restrict__ out, int B, int lut_size, int l0_rows,
                        int n_nodes, int n_targets, int n_joined, int R, int d_max) {
  __shared__ uint32_t tab[kStats ? wire_io::kBlockCells : 1];
  uint32_t* stats = out + (B + 1) / 2;
  if (kStats) {
    wire_io::zero_stats(tab);
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < B; i += stride) {
    const wire_io::Packet p = wire_io::decode<W>(wire, i, ifmap, n_ifmap);
    int result = 0;
    if (wire_io::looked_up(p)) {
      bool alive;
      int node, best0;
      root_entry(p.ifindex, p.w, root_lut, l0, lut_size, l0_rows, alive, node, best0);
      result = ctrie::descend_scan(p.w, p.kind, p.proto, p.dport, p.itype, p.icode, alive,
                                   node, best0, nodes, targets, joined, n_nodes, n_targets,
                                   n_joined, R, d_max).x;
    }
    wire_io::put_res16(out, i, result);
    if (kStats) wire_io::add_stats(tab, stats, result, p.pkt_len);
  }
  if (kStats) wire_io::flush_stats(tab, stats);
}

template <int W, bool kStats>
cudaError_t launch_fused(const uint32_t* wire, const int* ifmap, int n_ifmap,
                         const int* root_lut, const int2* l0, const uint4* nodes,
                         const int* targets, const uint16_t* joined, uint32_t* out, int B,
                         int lut_size, int l0_rows, int n_nodes, int n_targets, int n_joined,
                         int R, int d_max, int max_grid, cudaStream_t stream) {
  static int cached[wire_io::kMaxDevices];
  int grid = 0;
  const cudaError_t err = wire_io::persistent_grid(ctrie_wire_fused_kernel<W, kStats>, kThreads,
                                                   cached, B, max_grid, &grid);
  if (err != cudaSuccess) return err;
  ctrie_wire_fused_kernel<W, kStats><<<grid, kThreads, 0, stream>>>(
      wire, ifmap, n_ifmap, root_lut, l0, nodes, targets, joined, out, B, lut_size, l0_rows,
      n_nodes, n_targets, n_joined, R, d_max);
  return cudaGetLastError();
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

// The fused pass on `stream`: one memset of `out`'s statistics and last
// result word, then one launch (none for B = 0); returns the first error,
// else cudaGetLastError().  Allocates nothing.  `out` holds
// wire_io::out_words(B, width != 2) words; `width` is 7, 6, 4 or 3 (with
// statistics) or 2 (wire8: results only, `ifmap` its n_ifmap >= 1
// entries; ignored otherwise).  max_grid > 0 caps the grid (tests); 0
// takes the resident blocks.  Table pointers 16-byte aligned, wire and
// out 4-byte aligned (the Python wrapper checks).
extern "C" int infw_ctrie_wire_fused(const void* wire, const void* ifmap, const void* root_lut,
                                     const void* l0, const void* nodes, const void* targets,
                                     const void* joined, void* out, int B, int width,
                                     int n_ifmap, int lut_size, int l0_rows, int n_nodes,
                                     int n_targets, int n_joined, int R, int d_max,
                                     int max_grid, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  uint32_t* o = (uint32_t*)out;
  if (width != 2 && width != 3 && width != 4 && width != 6 && width != 7)
    return (int)cudaErrorInvalidValue;
  if (width == 2 && n_ifmap < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = wire_io::clear_out(o, B, width != 2, s);
  if (err == cudaSuccess && B > 0) {
#define INFW_CTRIE_FUSED(W, S)                                                                  \
  launch_fused<W, S>((const uint32_t*)wire, (const int*)ifmap, n_ifmap, (const int*)root_lut,  \
                     (const int2*)l0, (const uint4*)nodes, (const int*)targets,                \
                     (const uint16_t*)joined, o, B, lut_size, l0_rows, n_nodes, n_targets,     \
                     n_joined, R, d_max, max_grid, s)
    switch (width) {
      case 2: err = INFW_CTRIE_FUSED(2, false); break;
      case 3: err = INFW_CTRIE_FUSED(3, true); break;
      case 4: err = INFW_CTRIE_FUSED(4, true); break;
      case 6: err = INFW_CTRIE_FUSED(6, true); break;
      default: err = INFW_CTRIE_FUSED(7, true); break;
    }
#undef INFW_CTRIE_FUSED
  }
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}
