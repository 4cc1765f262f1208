// K3b on Hopper: the multi-tenant arena's paged ctrie walk, one thread per
// packet: the tenant-steered entry (tenant -> page table -> the page's
// root LUT row -> its DIR-16 slot), then K3's skip-node descent, target
// resolve and ordered uint16 joined-row scan (ctrie_walk.cuh) over the
// pooled slabs.
//
// Replaces the TPU kernel infw/kernels/pallas_walk.py:_make_cwalk_kernel
// as classify_arena_cwalk (:1156) and jitted_classify_arena_cwalk_wire_fused
// (:1215) launch it through _cwalk_scan (:1010-1034) over the pool planes of
// build_arena_cwalk_planes (:1137), together with the XLA stages around it:
// the entry jaxpath._arena_pages + _arena_ctrie_entry (unspliced), the
// target resolve, the joined-row gather (arena_ctrie_rows) and rule_scan.
// Same function, bit for bit: for each packet (result, sel - 1) with sel
// the pool-global joined position of the longest-prefix entry in the
// packet's tenant's slab (0 = none) and result = (ruleId << 8) | action of
// its first hitting rule, as stored (0 when no rule hits).
//
// What the TPU kernel does and why this one differs: the Pallas walk holds
// the whole pool's node array in VMEM as int8 byte planes (a secondary
// layout the JAX classifier refreshes after every slab write) and fetches
// each row by a one-hot MXU matmul; the tenant entry stays in XLA.  Here
// every read is a direct load from the resident pool tensors, the same
// uint32 rows the allocator writes, so there are no planes to refresh and
// no VMEM budget: each thread chases its own chain (tenant, page-table
// row, LUT row, DIR-16 slot, one 80-byte node row per step, the target,
// the joined row).  Slab bakes make every index page-global, so the
// descent and the scan are K3's code unchanged.
//
// Entry semantics (where it differs from K3's root stage): a tenant
// outside [0, MT) or whose page-table row is negative is invalid: its lane
// reads no slab and gets sel = 0 (UNDEF).  An ifindex outside the slab's
// SL-row LUT resolves to the page's own null root pg * R0, not root 0; the
// LUT row read is pg * SL + clip(ifindex, 0, SL - 1), clipped to the pool
// as XLA's take does.  The l0 index root * 65536 + top16 is computed in 64
// bits and checked against the pool (make_arena_spec keeps the pool within
// int32, where JAX computes it).
//
// What bounds it on this card: the chain of dependent loads per packet
// (steps walked + 6), i.e. memory latency.  Design: one thread per packet,
// 256 per block.
//
// Two entry points over the same walk:
// - infw_arena_ctrie_walk: (fields, words, tenant) -> (B, 2) [result,
//   sel - 1]; it must move 56 bytes per packet plus the pool rows the
//   batch's walks touch, each once;
// - infw_arena_wire_fused: the whole device pass of a mixed-tenant
//   classify in one launch, wire and tenant column to the read-back
//   buffer (jaxpath.jitted_classify_arena_wire_fused("ctrie") without an
//   overlay; pallas_walk.jitted_classify_arena_cwalk_wire_fused).  As K3's
//   fused entry (ctrie_walk.cu, wire_io.cuh): the wire decoded in
//   registers, the walk skipped for lanes finalize zeroes, the u16 result
//   written in place, the statistics summed per block in shared memory
//   over a persistent grid; one memset and one kernel per pass, moving the
//   wire (12-28 bytes per packet), the tenant (4) and the result (2), plus
//   the pool rows touched and the 24 KiB of statistics.
//
// Layouts (infw_torch/arena.py:CtrieArena; nodes, targets and joined as in
// ctrie_walk.cuh, all indices pool-global):
//   fields     (B, 8) i32: kind, ifindex, proto, dport, icmpType, icmpCode,
//                          l4_ok, pkt_len
//   words      (B, 4) u32: source-IP words, big-endian
//   tenant     (B,) i32:   tenant id per packet
//   page_table (MT,) i32:  tenant -> page, -1 = absent
//   root_lut   (P * SL,) i32: per page, ifindex -> global root id
//   l0         (P * R0 * 65536) int2: [global node id + 1, joined
//                          position] per root slot
//   out        (B, 2) i32: result, sel - 1 (infw_arena_ctrie_walk); the
//                          fused entry's wire and read-back buffer:
//                          wire_io.cuh
#include <cuda_runtime.h>
#include <stdint.h>

#include "ctrie_walk.cuh"
#include "wire_io.cuh"

namespace {

constexpr int kThreads = 256;  // packets per block

// The tenant-steered entry: tenant -> page (_arena_pages: -1 for ids
// outside the table) -> the page's LUT row, else its own null root -> its
// DIR-16 slot.  An invalid tenant's lane is dead with best0 0.  Sets
// `alive`, `node` (the first skip node) and `best0` (the root slot's
// joined position, 0 = none).
__device__ __forceinline__ void tenant_entry(int t, int ifx, const uint4& w,
                                             const int* __restrict__ page_table,
                                             const int* __restrict__ root_lut,
                                             const int2* __restrict__ l0, int MT, int SL, int R0,
                                             int lut_rows, int l0_rows, bool& alive, int& node,
                                             int& best0) {
  const int pg = (t >= 0 && t < MT) ? __ldg(page_table + t) : -1;
  const bool valid = pg >= 0;
  const long long pg0 = valid ? pg : 0;
  long long root;
  if (ifx >= 0 && ifx < SL) {
    long long lidx = pg0 * SL + ifx;
    lidx = lidx < lut_rows ? lidx : (long long)lut_rows - 1;
    root = __ldg(root_lut + lidx);
  } else {
    root = pg0 * R0;
  }
  const long long e0 = root * 65536 + (w.x >> 16);
  best0 = 0;
  alive = false;
  node = 0;
  if (valid && e0 >= 0 && e0 < l0_rows) {
    const int2 r0 = __ldg(l0 + e0);
    if (r0.y > 0) best0 = r0.y;
    alive = r0.x > 0;
    node = r0.x - 1;
  }
}

__global__ void __launch_bounds__(kThreads)
arena_ctrie_walk_kernel(const int4* __restrict__ fields, const uint4* __restrict__ words,
                        const int* __restrict__ tenant, const int* __restrict__ page_table,
                        const int* __restrict__ root_lut, const int2* __restrict__ l0,
                        const uint4* __restrict__ nodes, const int* __restrict__ targets,
                        const uint16_t* __restrict__ joined, int2* __restrict__ out, int B,
                        int MT, int SL, int R0, int lut_rows, int l0_rows, int n_nodes,
                        int n_targets, int n_joined, int R, int d_max) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= B) return;
  const int4 f0 = fields[2 * i];
  const int4 f1 = fields[2 * i + 1];
  const uint4 w = words[i];
  bool alive;
  int node, best0;
  tenant_entry(tenant[i], f0.y, w, page_table, root_lut, l0, MT, SL, R0, lut_rows, l0_rows,
               alive, node, best0);

  // K3's descent, target resolve and ordered joined-row scan on the pool.
  out[i] = ctrie::descend_scan(w, f0.x, f0.z, f0.w, f1.x, f1.y, alive, node, best0, nodes,
                               targets, joined, n_nodes, n_targets, n_joined, R, d_max);
}

// The fused pass over a (B, W) wire and its tenant column: each thread
// takes every (gridDim.x * kThreads)-th packet.
template <int W>
__global__ void __launch_bounds__(kThreads)
arena_wire_fused_kernel(const uint32_t* __restrict__ wire, const int* __restrict__ tenant,
                        const int* __restrict__ page_table, const int* __restrict__ root_lut,
                        const int2* __restrict__ l0, const uint4* __restrict__ nodes,
                        const int* __restrict__ targets, const uint16_t* __restrict__ joined,
                        uint32_t* __restrict__ out, int B, int MT, int SL, int R0, int lut_rows,
                        int l0_rows, int n_nodes, int n_targets, int n_joined, int R,
                        int d_max) {
  __shared__ uint32_t tab[wire_io::kBlockCells];
  uint32_t* stats = out + (B + 1) / 2;
  wire_io::zero_stats(tab);
  __syncthreads();
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < B; i += stride) {
    const wire_io::Packet p = wire_io::decode<W>(wire, i, nullptr, 0);
    int result = 0;
    if (wire_io::looked_up(p)) {
      bool alive;
      int node, best0;
      tenant_entry(__ldg(tenant + i), p.ifindex, p.w, page_table, root_lut, l0, MT, SL, R0,
                   lut_rows, l0_rows, alive, node, best0);
      result = ctrie::descend_scan(p.w, p.kind, p.proto, p.dport, p.itype, p.icode, alive,
                                   node, best0, nodes, targets, joined, n_nodes, n_targets,
                                   n_joined, R, d_max).x;
    }
    wire_io::put_res16(out, i, result);
    wire_io::add_stats(tab, stats, result, p.pkt_len);
  }
  wire_io::flush_stats(tab, stats);
}

template <int W>
cudaError_t launch_fused(const uint32_t* wire, const int* tenant, const int* page_table,
                         const int* root_lut, const int2* l0, const uint4* nodes,
                         const int* targets, const uint16_t* joined, uint32_t* out, int B,
                         int MT, int SL, int R0, int lut_rows, int l0_rows, int n_nodes,
                         int n_targets, int n_joined, int R, int d_max, int max_grid,
                         cudaStream_t stream) {
  static int cached[wire_io::kMaxDevices];
  int grid = 0;
  const cudaError_t err = wire_io::persistent_grid(arena_wire_fused_kernel<W>, kThreads, cached,
                                                   B, max_grid, &grid);
  if (err != cudaSuccess) return err;
  arena_wire_fused_kernel<W><<<grid, kThreads, 0, stream>>>(
      wire, tenant, page_table, root_lut, l0, nodes, targets, joined, out, B, MT, SL, R0,
      lut_rows, l0_rows, n_nodes, n_targets, n_joined, R, d_max);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); allocates nothing.
// Every pointer 16-byte aligned (the Python wrapper checks).
extern "C" int infw_arena_ctrie_walk(const void* fields, const void* words, const void* tenant,
                                     const void* page_table, const void* root_lut,
                                     const void* l0, const void* nodes, const void* targets,
                                     const void* joined, void* out, int B, int MT, int SL,
                                     int R0, int lut_rows, int l0_rows, int n_nodes,
                                     int n_targets, int n_joined, int R, int d_max,
                                     void* stream) {
  if (B > 0) {
    const int grid = (B + kThreads - 1) / kThreads;
    arena_ctrie_walk_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int4*)fields, (const uint4*)words, (const int*)tenant, (const int*)page_table,
        (const int*)root_lut, (const int2*)l0, (const uint4*)nodes, (const int*)targets,
        (const uint16_t*)joined, (int2*)out, B, MT, SL, R0, lut_rows, l0_rows, n_nodes,
        n_targets, n_joined, R, d_max);
  }
  return (int)cudaGetLastError();
}

// The fused pass on `stream`: one memset of `out`'s statistics and last
// result word, then one launch (none for B = 0); returns the first error,
// else cudaGetLastError().  Allocates nothing.  `out` holds
// wire_io::out_words(B, true) words; `width` is 7, 6, 4 or 3.  max_grid >
// 0 caps the grid (tests); 0 takes the resident blocks.  Pool pointers
// 16-byte aligned, wire, tenant and out 4-byte aligned (the Python
// wrapper checks).
extern "C" int infw_arena_wire_fused(const void* wire, const void* tenant,
                                     const void* page_table, const void* root_lut,
                                     const void* l0, const void* nodes, const void* targets,
                                     const void* joined, void* out, int B, int width, int MT,
                                     int SL, int R0, int lut_rows, int l0_rows, int n_nodes,
                                     int n_targets, int n_joined, int R, int d_max,
                                     int max_grid, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  uint32_t* o = (uint32_t*)out;
  if (width != 3 && width != 4 && width != 6 && width != 7) return (int)cudaErrorInvalidValue;
  cudaError_t err = wire_io::clear_out(o, B, true, s);
  if (err == cudaSuccess && B > 0) {
#define INFW_ARENA_FUSED(W)                                                                  \
  launch_fused<W>((const uint32_t*)wire, (const int*)tenant, (const int*)page_table,        \
                  (const int*)root_lut, (const int2*)l0, (const uint4*)nodes,               \
                  (const int*)targets, (const uint16_t*)joined, o, B, MT, SL, R0, lut_rows, \
                  l0_rows, n_nodes, n_targets, n_joined, R, d_max, max_grid, s)
    switch (width) {
      case 3: err = INFW_ARENA_FUSED(3); break;
      case 4: err = INFW_ARENA_FUSED(4); break;
      case 6: err = INFW_ARENA_FUSED(6); break;
      default: err = INFW_ARENA_FUSED(7); break;
    }
#undef INFW_ARENA_FUSED
  }
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}
