// K7 and K8 on Hopper: the flow tier's fused probe and batch insert.
//
// Replaces no TPU kernel: in the JAX package both are XLA programs
// (kernels/jaxpath.py _flow_probe_core, launched by jitted_flow_probe, and
// _flow_insert_core, launched by jitted_flow_insert; kernels/__init__.py
// lists them as classify-wire/flow-probe and patch/flow-insert).  Written
// as torch ops each would be a few dozen launches of gathers and scatters
// per chunk, more than the verdict cache saves over the stateless classify.
//
// The table is W-way set associative: C = pages * S rows (S a power of
// two), a lane's W candidate rows are page * S + ((h1 + w * h2) & (S - 1))
// with (h1, h2 | 1) the FNV-1a hash of its 8 key words.  Columns (int32,
// row-major): keys (C, 8) u32 words, vg (C, 2) [verdict, generation], se
// (C, 2) [state, epoch], cnt (C, 3) [packets, sum(len >> 8), sum(len &
// 0xFF)].
//
// Read before write.  XLA gathers every lane's candidate rows from the OLD
// columns before any scatter, applies the probe's max (FIN, epoch) before
// its min (RST), lets the last eligible lane of a slot write the insert's
// row and sums the counters over every eligible lane on it.  Each entry is
// ONE cooperative launch of a grid that fits on the card at once; grid
// barriers stand where launch boundaries stood (an earlier design ran three
// kernels and a memset a call):
//   probe:  1. decide: every lane reads its candidate rows (nothing is
//              written to the columns), writes its u16 result and, per
//              warp, its word of the hit bitmap; the two count words are
//              zeroed | 2. add + max: each hit lane adds its counters and
//              sets the epoch max(old, epoch_now) and, for a FIN, the state
//              max(old, FIN): every hit lane on a slot computes the same
//              maxima from the old row, so a lane that kept the row stores
//              them (no atomic) and a lane from the scratch applies them by
//              atomicMax; the blocks' hit and stale counts are added |
//              3. min: the RST hit lanes store FLOW_EMPTY (a hit's state is
//              live, so the min with 0 is 0; the epoch's min with INT_MAX
//              keeps it).
//   insert: 1. decide: every lane reads its candidate se and keys rows and
//              chooses its way; an eligible lane bids for its slot by
//              atomicMax of its index into the table's winner scratch; the
//              counts are zeroed | 2. write: the winners write their rows
//              and zero their counters; the blocks' counts are added |
//              3. seed: every eligible lane adds [1, len >> 8, len & 0xFF]
//              (pkt_len from what the decide kept) and puts the scratch
//              back to -1 (no O(C) clear).
// A launch for B = 0 zeroes the counts, so no call needs a memset.
//
// The resident entries (infw_flow_probe_resident, infw_flow_insert_
// resident; the resident step of kernels/resident.py, jaxpath.
// _resident_step_core) are the same kernels with three operands more.
// Both serve the epoch *epoch_dev + 1, read in the launch, so that a CUDA
// graph replays them with the epoch of their turn.  The insert takes the
// whole batch: the stateless classify's verdicts as packed res16 words and
// K7's hit bitmap; a lane whose hit bit is 0 writes its verdict into K7's
// res16 words (the merge) and is eligible as on the classic entry, a hit
// lane is not (lane_ok = ~hit).  Its last phase stores the served epoch
// to *epoch_dev, after every thread of both launches has read it.
//
// What bounds it on this card.  At the main path's sizes (a 4096-lane
// ladder chunk, 2^16-lane daemon jobs), latency: a grid barrier costs
// about what a launch does, and one launch with two barriers replaces
// three launches and a memset; the blocks are as small as
// 32 threads so that 4096 lanes reach 128 SMs; a lane's loads form a chain
// (wire, tenant and flags; page and generation; then the rows), and the
// rows come in three rounds, each way's loads issued together: every way's
// se, the keys of the ways that could match, the verdict of the way that
// matched (templated on the way count rounded up to 1, 2, 4 or 8).  At
// 2^18 lanes, L2 sectors and atomics: the table stays in L2, and loading
// every way's se, keys and vg at once (12 sectors a lane, not about 6)
// made the decide slower there and no faster at 4096.  Lanes of a warp
// combining their counter adds (__match_any_sync, __reduce_add_sync) made
// every size slower: in a flow trace a warp's lanes seldom share a slot,
// so each lane adds its own (tools/flow_variants.py times both).
// A thread takes lanes i = gtid + r * T (T the grid's threads); its first
// kRegLanes lanes stay in registers across the barriers, later ones keep
// (slot, packed flags) in the (B, 2) scratch, read back through L2.
// Scratch and winners written in the launch are read through L2 (__ldcg):
// L1 is not coherent across SMs.  Warps reconverge (__syncwarp) before
// each grid barrier, and every warp intrinsic runs with all 32 lanes.
//
// Layouts: wire (B, 4 | 7) u32 (the full layouts, wire_io.cuh); tenant,
// tflags, verdict (B,) i32; gens (n_gens,), page_table (n_pages,) i32;
// scratch (B, 2) i32, 8-byte aligned; probe out (B + 1) / 2 words of u16
// results, ceil(B / 32) bitmap words (LSB first), [hits, stale]; insert
// counts (4,) i32 [inserts, evictions, promotes, 0].
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "wire_io.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kMinThreads = 32;   // a block at small B: one warp
constexpr int kMaxThreads = 256;  // a block at large B
constexpr int kBlockSizes = 4;    // 32, 64, 128, 256
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kRegLanes = 2;      // a thread's lanes kept in registers
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kFlowEmpty = 0;
constexpr int kFlowNew = 1;
constexpr int kFlowEst = 2;
constexpr int kFlowFin = 3;
constexpr int kTcp = 6;
constexpr int kTcpFin = 0x01, kTcpSyn = 0x02, kTcpRst = 0x04, kTcpAck = 0x10;
constexpr uint32_t kFnvBasis = 0x811C9DC5u, kFnvPrime = 0x01000193u;
constexpr uint32_t kLenMask = 0xFFFFFFu;  // pkt_len is 21 bits on the wire

struct Args {
  const uint32_t* wire;
  const int* tenant;
  const int* tflags;
  const int* verdict;  // the insert's: (B,) i32, or packed u16 on the resident entry
  uint32_t* keys;
  int2* vg;
  int2* se;
  int* cnt;
  int* winner;  // the insert's, (C,) -1 between calls
  const int* gens;
  const int* page_table;
  uint32_t* out;  // the probe's fused buffer, or the insert's 4 counts
  int2* lanes;    // (B, 2) scratch: the lanes past a thread's registers
  // the resident entries: the device epoch (the launch serves *epoch_dev
  // + 1; null: epoch_now), and the insert's hit bitmap (a lane whose bit
  // is set is not eligible) and merged res16 words (null on the classic
  // entries)
  int* epoch_dev;
  const uint32_t* hit_bits;
  uint32_t* merged;
  int B, n_gens, n_pages, S, ways, epoch_now, max_age;
};

// The epoch a launch serves: the host's scalar, or the device epoch + 1
// (int32 wrap, as XLA's add); read by every thread before the first grid
// barrier.
__device__ __forceinline__ int served_epoch(const Args& a) {
  return a.epoch_dev ? (int)((uint32_t)__ldcg(a.epoch_dev) + 1u) : a.epoch_now;
}

// One lane's wire row decoded: its key words, flags, length, page and
// generation.
struct Lane {
  uint32_t key[8];
  uint32_t pkt_len;
  int tflags;
  int page;  // -1: tenant out of range or unmapped
  int gen;   // gens[clip(tenant, 0, n_gens - 1)]
  bool ip_l4;
  bool tcp;
};

template <int WW>
__device__ __forceinline__ Lane lane_of(const Args& a, int i) {
  // the wire row, the tenant and the flags are independent loads; the
  // page and the generation follow the tenant
  const wire_io::Packet p = wire_io::decode<WW>(a.wire, i, nullptr, 1);
  const int t = __ldg(a.tenant + i);
  Lane L;
  L.tflags = __ldg(a.tflags + i);
  // the clips keep every gather in range (jaxpath._arena_pages, the gens
  // take, _flow_slots' clip of page -1 to 0)
  L.page = (t >= 0 && t < a.n_pages) ? __ldg(a.page_table + t) : -1;
  L.gen = __ldg(a.gens + min(max(t, 0), a.n_gens - 1));
  L.key[0] = (uint32_t)t;
  L.key[1] = (uint32_t)p.ifindex;
  L.key[2] = p.w.x;
  L.key[3] = p.w.y;
  L.key[4] = p.w.z;
  L.key[5] = p.w.w;
  L.key[6] = ((uint32_t)p.proto & 0xFFu) | (((uint32_t)p.dport & 0xFFFFu) << 8) |
             (((uint32_t)p.kind & 3u) << 24) | (((uint32_t)p.l4_ok & 1u) << 26);
  L.key[7] = ((uint32_t)p.itype & 0xFFu) | (((uint32_t)p.icode & 0xFFu) << 8);
  L.ip_l4 = wire_io::looked_up(p);
  L.tcp = p.proto == kTcp;
  L.pkt_len = p.pkt_len;
  return L;
}

// Candidate w of a lane on an eligible page.
struct Probe {
  int base;
  uint32_t h1, h2;
  __device__ __forceinline__ int slot(int w, int S) const {
    return base + (int)((h1 + (uint32_t)w * h2) & (uint32_t)(S - 1));
  }
};

__device__ __forceinline__ Probe probe_of(const Lane& L, int S) {
  uint32_t h = kFnvBasis;
#pragma unroll
  for (int w = 0; w < 8; ++w) h = (h ^ L.key[w]) * kFnvPrime;
  return Probe{L.page * S, h, (h >> 16) | 1u};
}

__device__ __forceinline__ bool key_eq(const uint4& a, const uint4& b, const Lane& L) {
  return a.x == L.key[0] && a.y == L.key[1] && a.z == L.key[2] && a.w == L.key[3] &&
         b.x == L.key[4] && b.y == L.key[5] && b.z == L.key[6] && b.w == L.key[7];
}

// (int32)(now - then) with the wrap XLA's int32 subtraction has; signed
// overflow is undefined in C++, so the difference is taken unsigned.
__device__ __forceinline__ int epoch_diff(int now, int then) {
  return (int)((uint32_t)now - (uint32_t)then);
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// A lane's [1, len >> 8, len & 0xFF] added to its slot's counters (u32
// sums wrap as XLA's int32 scatter-add does, in any order).
__device__ __forceinline__ void add_counters(int* cnt, int slot, uint32_t len) {
  int* c = cnt + (size_t)slot * 3;
  atomicAdd(c, 1);
  const uint32_t hi = (len >> 8) & kLenMask, lo = len & 0xFFu;
  if (hi) atomicAdd(c + 1, (int)hi);
  if (lo) atomicAdd(c + 2, (int)lo);
}

// Per-warp counts into shared memory at the end of a phase (lane 0 holds
// them), then, after the grid barrier's block barrier, summed by thread 0.
template <int N>
__device__ __forceinline__ void warp_counts_out(unsigned (*sm)[N], const unsigned* c) {
  if (lane_id() == 0)
    for (int k = 0; k < N; ++k) sm[threadIdx.x >> 5][k] = c[k];
}

template <int N>
__device__ __forceinline__ void block_counts_add(unsigned (*sm)[N], uint32_t* dst) {
  if (threadIdx.x != 0) return;
  for (int k = 0; k < N; ++k) {
    unsigned s = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += sm[w][k];
    if (s) atomicAdd(dst + k, s);
  }
}

// --- K7 ------------------------------------------------------------------------

// A probe lane across the barriers.
struct ProbeKept {
  int slot;      // the hit slot, -1 for a miss or past B
  uint32_t info; // pkt_len (24 bits) | fin << 24 | rst << 25
  int2 old;      // the hit row's [state, epoch] as the decide read it
};

template <int WW, int MW>
__device__ __forceinline__ ProbeKept probe_decide(const Args& a, int i, int epoch_now,
                                                  long long nw, long long nh, unsigned* counts) {
  ProbeKept k{-1, 0u, make_int2(0, 0)};
  bool hit = false, stale = false;
  if (i < a.B) {
    const Lane L = lane_of<WW>(a, i);
    int res = 0;
    if (L.ip_l4 && L.page >= 0) {
      const Probe P = probe_of(L, a.S);
      // every way's [state, epoch] at once, then the keys of the ways that
      // could serve (live and fresh), then the verdicts of the ways whose
      // key matches: three rounds of loads, each way's independent
      int2 e[MW], g[MW];
      uint4 ka[MW], kb[MW];
      bool m[MW];
#pragma unroll
      for (int w = 0; w < MW; ++w)
        if (w < a.ways) e[w] = a.se[P.slot(w, a.S)];
#pragma unroll
      for (int w = 0; w < MW; ++w) {
        m[w] = w < a.ways && e[w].x >= kFlowEst &&
               epoch_diff(epoch_now, e[w].y) <= a.max_age;
        if (m[w]) {
          const uint4* r = reinterpret_cast<const uint4*>(a.keys + (size_t)P.slot(w, a.S) * 8);
          ka[w] = r[0];
          kb[w] = r[1];
        }
      }
#pragma unroll
      for (int w = 0; w < MW; ++w) {
        m[w] = m[w] && key_eq(ka[w], kb[w], L);
        if (m[w]) g[w] = a.vg[P.slot(w, a.S)];
      }
#pragma unroll
      for (int w = 0; w < MW; ++w) {
        if (!m[w] || hit) continue;
        if (g[w].y == L.gen) {
          hit = true;
          k.slot = P.slot(w, a.S);
          k.old = e[w];
          res = g[w].x;
        } else {
          stale = true;  // matches, live and fresh, but of another generation
        }
      }
      stale = stale && !hit;
    }
    wire_io::put_res16(a.out, i, hit ? res : 0);
    const uint32_t fin = (L.tcp && (L.tflags & kTcpFin)) ? 1u : 0u;
    const uint32_t rst = (L.tcp && (L.tflags & kTcpRst)) ? 1u : 0u;
    k.info = (L.pkt_len & kLenMask) | (fin << 24) | (rst << 25);
  }
  // the bitmap word of this warp's 32 lanes (i of lane 0 is a multiple of
  // 32) and its counts
  const unsigned hb = __ballot_sync(kFull, hit);
  const unsigned sb = __ballot_sync(kFull, stale);
  if (lane_id() == 0) {
    const long long word = (long long)i >> 5;
    if (word < nh) a.out[nw + word] = hb;
    counts[0] += __popc(hb);
    counts[1] += __popc(sb);
  }
  return k;
}

// Phase 2 for one hit lane: its counters, the epoch max and, for a FIN,
// the state max.  Every hit lane on a slot computes the same maxima from
// the old row, so a lane in registers stores them; a lane from the scratch
// (which kept no row) applies them by atomicMax, which leaves the same.
__device__ __forceinline__ void probe_add_max(const Args& a, const ProbeKept& k, int epoch_now,
                                              bool in_regs) {
  if (k.slot < 0) return;
  add_counters(a.cnt, k.slot, k.info & kLenMask);
  const bool fin = (k.info >> 24) & 1u;
  int* row = reinterpret_cast<int*>(a.se + k.slot);
  if (!in_regs) {
    if (fin) atomicMax(row, kFlowFin);
    atomicMax(row + 1, epoch_now);
  } else if (fin) {
    a.se[k.slot] = make_int2(max(k.old.x, kFlowFin), max(k.old.y, epoch_now));
  } else {
    row[1] = max(k.old.y, epoch_now);
  }
}

__device__ __forceinline__ ProbeKept probe_from_scratch(const Args& a, int i) {
  ProbeKept k{-1, 0u, make_int2(0, 0)};
  if (i < a.B) {
    const int2 l = __ldcg(a.lanes + i);
    k.slot = l.x;
    k.info = (uint32_t)l.y;
  }
  return k;
}

template <int WW, int MW>
__global__ void __launch_bounds__(kMaxThreads) probe_kernel(const Args a) {
  __shared__ unsigned warp_counts[kMaxWarps][2];
  cg::grid_group grid = cg::this_grid();
  const int T = gridDim.x * blockDim.x;
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int rounds = (int)(((long long)a.B + T - 1) / T);
  const long long nw = ((long long)a.B + 1) / 2, nh = ((long long)a.B + 31) / 32;
  const int epoch_now = served_epoch(a);

  // 1. decide; the counts zeroed, and the pad half of an odd B's last word
  if (gtid == 0) {
    a.out[nw + nh] = 0u;
    a.out[nw + nh + 1] = 0u;
    if (a.B & 1) wire_io::put_res16(a.out, a.B, 0);
  }
  unsigned counts[2] = {0u, 0u};
  ProbeKept reg[kRegLanes];
#pragma unroll
  for (int r = 0; r < kRegLanes; ++r)
    if (r < rounds) reg[r] = probe_decide<WW, MW>(a, r * T + gtid, epoch_now, nw, nh, counts);
  for (int r = kRegLanes; r < rounds; ++r) {
    const int i = r * T + gtid;
    const ProbeKept k = probe_decide<WW, MW>(a, i, epoch_now, nw, nh, counts);
    if (i < a.B) a.lanes[i] = make_int2(k.slot, (int)k.info);
  }
  warp_counts_out<2>(warp_counts, counts);
  __syncwarp();
  grid.sync();

  // 2. add + max
  block_counts_add<2>(warp_counts, a.out + nw + nh);
#pragma unroll
  for (int r = 0; r < kRegLanes; ++r)
    if (r < rounds) probe_add_max(a, reg[r], epoch_now, true);
  for (int r = kRegLanes; r < rounds; ++r)
    probe_add_max(a, probe_from_scratch(a, r * T + gtid), epoch_now, false);
  __syncwarp();
  grid.sync();

  // 3. min: RST on a hit (a live state) leaves FLOW_EMPTY; the epoch's min
  // with INT_MAX keeps it
#pragma unroll
  for (int r = 0; r < kRegLanes; ++r)
    if (r < rounds && reg[r].slot >= 0 && ((reg[r].info >> 25) & 1u))
      reinterpret_cast<int*>(a.se + reg[r].slot)[0] = kFlowEmpty;
  for (int r = kRegLanes; r < rounds; ++r) {
    const ProbeKept k = probe_from_scratch(a, r * T + gtid);
    if (k.slot >= 0 && ((k.info >> 25) & 1u))
      reinterpret_cast<int*>(a.se + k.slot)[0] = kFlowEmpty;
  }
}

// --- K8 ------------------------------------------------------------------------

// An insert lane across the barriers.
struct InsertKept {
  int slot;       // the chosen slot of an eligible lane, else -1
  uint32_t info;  // pkt_len (24 bits) | matched << 24 | (old state > 0) << 25 |
                  // (old state == FLOW_NEW) << 26 | new state << 27 (2 bits)
};

// What a winner writes besides its state; kept in registers for the
// register lanes, decoded again for a winner from the scratch.
struct InsertRow {
  uint32_t key[8];
  int gen;
  int verdict;
};

// A lane's verdict: (B,) i32 on the classic entry, packed u16 (the
// stateless classify's res16 words) on the resident one.
__device__ __forceinline__ int lane_verdict(const Args& a, int i) {
  return a.hit_bits ? (int)__ldg(reinterpret_cast<const uint16_t*>(a.verdict) + i)
                    : __ldg(a.verdict + i);
}

// On the resident entry a hit (K7 served it, its bit set) is not
// eligible, and reads nothing more.  Lanes are never hits on the classic
// entry.
__device__ __forceinline__ bool lane_hit(const Args& a, int i) {
  return a.hit_bits && ((__ldg(a.hit_bits + (i >> 5)) >> (i & 31)) & 1u);
}

template <int WW, int MW>
__device__ __forceinline__ InsertKept insert_decide(const Args& a, int i, InsertRow& row) {
  InsertKept k{-1, 0u};
  if (i < a.B && !lane_hit(a, i)) {
    const int verdict = lane_verdict(a, i);
    // the resident merge: a miss's verdict replaces K7's 0 in the merged
    // res16 words
    if (a.hit_bits) wire_io::put_res16(a.merged, i, verdict);
    const Lane L = lane_of<WW>(a, i);
    const int f = L.tflags;
    const bool rst = L.tcp && (f & kTcpRst);
    if (L.ip_l4 && L.page >= 0 && !rst) {
      const Probe P = probe_of(L, a.S);
      // every way's [state, epoch] at once, then the keys of the live ways
      int2 e[MW];
      uint4 ka[MW], kb[MW];
#pragma unroll
      for (int w = 0; w < MW; ++w)
        if (w < a.ways) e[w] = a.se[P.slot(w, a.S)];
#pragma unroll
      for (int w = 0; w < MW; ++w) {
        if (w < a.ways && e[w].x > 0) {
          const uint4* r = reinterpret_cast<const uint4*>(a.keys + (size_t)P.slot(w, a.S) * 8);
          ka[w] = r[0];
          kb[w] = r[1];
        }
      }
      // the way holding the key (any live state), else the first empty,
      // else the oldest epoch (the first of equal epochs)
      int m_first = -1, e_first = -1, oldest = 0, oldest_ep = INT_MAX;
      int m_state = 0, o_state = 0;
#pragma unroll
      for (int w = 0; w < MW; ++w) {
        if (w >= a.ways) continue;
        if (w == 0 || e[w].y < oldest_ep) {
          oldest = w;
          oldest_ep = e[w].y;
          o_state = e[w].x;
        }
        if (e[w].x == 0) {
          if (e_first < 0) e_first = w;
        } else if (m_first < 0 && e[w].x > 0 && key_eq(ka[w], kb[w], L)) {
          m_first = w;
          m_state = e[w].x;
        }
      }
      const int way = m_first >= 0 ? m_first : (e_first >= 0 ? e_first : oldest);
      const int old_state = m_first >= 0 ? m_state : (e_first >= 0 ? 0 : o_state);
      const bool fin = L.tcp && (f & kTcpFin);
      const bool syn_only = L.tcp && (f & kTcpSyn) && !(f & kTcpAck);
      const uint32_t state = fin ? kFlowFin : (syn_only ? kFlowNew : kFlowEst);
      k.slot = P.slot(way, a.S);
      k.info = (L.pkt_len & kLenMask) | ((m_first >= 0 ? 1u : 0u) << 24) |
               ((old_state > 0 ? 1u : 0u) << 25) | ((old_state == kFlowNew ? 1u : 0u) << 26) |
               (state << 27);
#pragma unroll
      for (int w = 0; w < 8; ++w) row.key[w] = L.key[w];
      row.gen = L.gen;
      row.verdict = verdict;
    }
  }
  // the last eligible lane of a slot in batch order wins it
  if (k.slot >= 0) atomicMax(a.winner + k.slot, i);
  return k;
}

// Phase 2 for one lane: a winner writes its row and zeroes its counters.
template <int WW>
__device__ __forceinline__ void insert_write(const Args& a, int i, const InsertKept& k,
                                             const InsertRow* row, int epoch_now,
                                             unsigned* counts) {
  bool win = false;
  if (k.slot >= 0 && __ldcg(a.winner + k.slot) == i) {
    win = true;
    InsertRow r;
    if (row) {
      r = *row;
    } else {
      const Lane L = lane_of<WW>(a, i);
#pragma unroll
      for (int w = 0; w < 8; ++w) r.key[w] = L.key[w];
      r.gen = L.gen;
      r.verdict = lane_verdict(a, i);
    }
    const size_t s = (size_t)k.slot;
    uint4* kr = reinterpret_cast<uint4*>(a.keys + s * 8);
    kr[0] = make_uint4(r.key[0], r.key[1], r.key[2], r.key[3]);
    kr[1] = make_uint4(r.key[4], r.key[5], r.key[6], r.key[7]);
    a.vg[s] = make_int2(r.verdict & 0xFFFF, r.gen);
    a.se[s] = make_int2((int)(k.info >> 27), epoch_now);
    a.cnt[s * 3] = 0;
    a.cnt[s * 3 + 1] = 0;
    a.cnt[s * 3 + 2] = 0;
  }
  const bool matched = (k.info >> 24) & 1u;
  const bool evict = win && !matched && ((k.info >> 25) & 1u);
  const bool promote = win && matched && ((k.info >> 26) & 1u) && (k.info >> 27) == kFlowEst;
  const unsigned wb = __ballot_sync(kFull, win);
  const unsigned eb = __ballot_sync(kFull, evict);
  const unsigned pb = __ballot_sync(kFull, promote);
  if (lane_id() == 0) {
    counts[0] += __popc(wb);
    counts[1] += __popc(eb);
    counts[2] += __popc(pb);
  }
}

// Phase 3 for one eligible lane: its counter seed, and the scratch back to
// -1.
__device__ __forceinline__ void insert_seed(const Args& a, const InsertKept& k) {
  if (k.slot < 0) return;
  add_counters(a.cnt, k.slot, k.info & kLenMask);
  a.winner[k.slot] = -1;
}

__device__ __forceinline__ InsertKept insert_from_scratch(const Args& a, int i) {
  InsertKept k{-1, 0u};
  if (i < a.B) {
    const int2 l = __ldcg(a.lanes + i);
    k.slot = l.x;
    k.info = (uint32_t)l.y;
  }
  return k;
}

template <int WW, int MW>
__global__ void __launch_bounds__(kMaxThreads) insert_kernel(const Args a) {
  __shared__ unsigned warp_counts[kMaxWarps][3];
  cg::grid_group grid = cg::this_grid();
  const int T = gridDim.x * blockDim.x;
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int rounds = (int)(((long long)a.B + T - 1) / T);
  const int epoch_now = served_epoch(a);

  // 1. decide; the counts zeroed
  if (gtid == 0)
    for (int k = 0; k < 4; ++k) a.out[k] = 0u;
  InsertKept reg[kRegLanes];
  InsertRow rows[kRegLanes];
#pragma unroll
  for (int r = 0; r < kRegLanes; ++r)
    if (r < rounds) reg[r] = insert_decide<WW, MW>(a, r * T + gtid, rows[r]);
  for (int r = kRegLanes; r < rounds; ++r) {
    const int i = r * T + gtid;
    InsertRow unused;
    const InsertKept k = insert_decide<WW, MW>(a, i, unused);
    if (i < a.B) a.lanes[i] = make_int2(k.slot, (int)k.info);
  }
  __syncwarp();
  grid.sync();

  // 2. write
  unsigned counts[3] = {0u, 0u, 0u};
#pragma unroll
  for (int r = 0; r < kRegLanes; ++r)
    if (r < rounds) insert_write<WW>(a, r * T + gtid, reg[r], &rows[r], epoch_now, counts);
  for (int r = kRegLanes; r < rounds; ++r) {
    const int i = r * T + gtid;
    insert_write<WW>(a, i, insert_from_scratch(a, i), nullptr, epoch_now, counts);
  }
  warp_counts_out<3>(warp_counts, counts);
  __syncwarp();
  grid.sync();

  // 3. seed and scratch clear; on the resident entry the device epoch
  // advances to the one this launch served (every thread read it before
  // the first barrier, and K7 before this launch)
  block_counts_add<3>(warp_counts, a.out);
  if (gtid == 0 && a.epoch_dev) *a.epoch_dev = epoch_now;
#pragma unroll
  for (int r = 0; r < kRegLanes; ++r)
    if (r < rounds) insert_seed(a, reg[r]);
  for (int r = kRegLanes; r < rounds; ++r) insert_seed(a, insert_from_scratch(a, r * T + gtid));
}

// --- launch ----------------------------------------------------------------------

// The block: the smallest of 32, 64, 128 and 256 threads with which one
// block per SM covers B (so 4096 lanes take 128 SMs), 256 above.  The
// grid: at most one block per `threads` lanes, at most the co-resident
// blocks (the occupancy query, once per device and block size), and at
// most max_grid when that is > 0 (tests force many lanes a thread).
template <int WW, int MW, bool kProbe>
cudaError_t launch(const Args& a, int max_grid, cudaStream_t stream) {
  static int sms_of[wire_io::kMaxDevices];
  static int per_sm_of[wire_io::kMaxDevices][kBlockSizes];
  const void* kernel = kProbe ? (const void*)probe_kernel<WW, MW> : (const void*)insert_kernel<WW, MW>;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= wire_io::kMaxDevices) return cudaErrorInvalidDevice;
  if (sms_of[device] == 0) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    sms_of[device] = sms;
  }
  const int sms = sms_of[device];
  int threads = kMinThreads, size = 0;
  while (threads < kMaxThreads && (long long)threads * sms < a.B) {
    threads *= 2;
    ++size;
  }
  if (per_sm_of[device][size] == 0) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
    if (err != cudaSuccess) return err;
    if (per_sm <= 0) return cudaErrorCooperativeLaunchTooLarge;
    per_sm_of[device][size] = per_sm;
  }
  long long grid = ((long long)a.B + threads - 1) / threads;
  if (grid > (long long)sms * per_sm_of[device][size]) grid = (long long)sms * per_sm_of[device][size];
  if (max_grid > 0 && grid > max_grid) grid = max_grid;
  if (grid < 1) grid = 1;
  void* args[] = {(void*)&a};
  return cudaLaunchCooperativeKernel(kernel, dim3((unsigned)grid), dim3(threads), args, 0,
                                     stream);
}

template <bool kProbe, int WW>
cudaError_t launch_ways(const Args& a, int max_grid, cudaStream_t stream) {
  if (a.ways <= 1) return launch<WW, 1, kProbe>(a, max_grid, stream);
  if (a.ways <= 2) return launch<WW, 2, kProbe>(a, max_grid, stream);
  if (a.ways <= 4) return launch<WW, 4, kProbe>(a, max_grid, stream);
  return launch<WW, 8, kProbe>(a, max_grid, stream);
}

template <bool kProbe>
int dispatch(const Args& a, int wire_w, int max_grid, void* stream) {
  cudaError_t err;
  if (a.B < 0 || a.ways < 1 || a.ways > 8 || a.S < 1 || a.n_gens < 1) {
    err = cudaErrorInvalidValue;
  } else if (wire_w == 4) {
    err = launch_ways<kProbe, 4>(a, max_grid, (cudaStream_t)stream);
  } else if (wire_w == 7) {
    err = launch_ways<kProbe, 7>(a, max_grid, (cudaStream_t)stream);
  } else {
    err = cudaErrorInvalidValue;
  }
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace

// K7: one cooperative launch on `stream` (also for B = 0); returns its
// error, else cudaGetLastError().  Allocates nothing.  wire_w is 4 or 7;
// C = n_pages_total * S rows; `lanes` is (B, 2) i32 scratch; `out` has
// (B + 1) / 2 + ceil(B / 32) + 2 words (the wrapper checks shapes, types
// and alignment); max_grid > 0 caps the grid (tests), 0 takes what fits.
extern "C" int infw_flow_probe(const void* wire, const void* tenant, const void* tflags,
                               void* keys, void* vg, void* se, void* cnt, const void* gens,
                               const void* page_table, void* out, void* lanes, int B, int wire_w,
                               int n_gens, int n_pages, int C, int S, int ways, int epoch_now,
                               int max_age, int max_grid, void* stream) {
  (void)C;
  Args a{};
  a.wire = (const uint32_t*)wire;
  a.tenant = (const int*)tenant;
  a.tflags = (const int*)tflags;
  a.keys = (uint32_t*)keys;
  a.vg = (int2*)vg;
  a.se = (int2*)se;
  a.cnt = (int*)cnt;
  a.gens = (const int*)gens;
  a.page_table = (const int*)page_table;
  a.out = (uint32_t*)out;
  a.lanes = (int2*)lanes;
  a.B = B;
  a.n_gens = n_gens;
  a.n_pages = n_pages;
  a.S = S;
  a.ways = ways;
  a.epoch_now = epoch_now;
  a.max_age = max_age;
  return dispatch<true>(a, wire_w, max_grid, stream);
}

// K8: one cooperative launch on `stream` (also for B = 0); returns its
// error, else cudaGetLastError().  Allocates nothing.  `winner` (C,) must
// be -1 on entry and is -1 again when the launch ends; `counts` (4,) i32
// receives [inserts, evictions, promotes, 0]; `lanes` and max_grid as K7's.
extern "C" int infw_flow_insert(const void* wire, const void* tenant, const void* tflags,
                                const void* verdict, void* keys, void* vg, void* se, void* cnt,
                                void* winner, const void* gens, const void* page_table,
                                void* counts, void* lanes, int B, int wire_w, int n_gens,
                                int n_pages, int C, int S, int ways, int epoch_now, int max_grid,
                                void* stream) {
  (void)C;
  Args a{};
  a.wire = (const uint32_t*)wire;
  a.tenant = (const int*)tenant;
  a.tflags = (const int*)tflags;
  a.verdict = (const int*)verdict;
  a.keys = (uint32_t*)keys;
  a.vg = (int2*)vg;
  a.se = (int2*)se;
  a.cnt = (int*)cnt;
  a.winner = (int*)winner;
  a.gens = (const int*)gens;
  a.page_table = (const int*)page_table;
  a.out = (uint32_t*)counts;
  a.lanes = (int2*)lanes;
  a.B = B;
  a.n_gens = n_gens;
  a.n_pages = n_pages;
  a.S = S;
  a.ways = ways;
  a.epoch_now = epoch_now;
  return dispatch<false>(a, wire_w, max_grid, stream);
}

// K7's resident entry: infw_flow_probe serving the device epoch, e =
// *epoch_dev + 1, read in the launch (so a CUDA graph replays it with the
// epoch of its turn); *epoch_dev is not written.
extern "C" int infw_flow_probe_resident(const void* wire, const void* tenant, const void* tflags,
                                        void* keys, void* vg, void* se, void* cnt,
                                        const void* gens, const void* page_table, void* out,
                                        void* lanes, void* epoch_dev, int B, int wire_w,
                                        int n_gens, int n_pages, int C, int S, int ways,
                                        int max_age, int max_grid, void* stream) {
  (void)C;
  if (!epoch_dev) return (int)cudaErrorInvalidValue;
  Args a{};
  a.wire = (const uint32_t*)wire;
  a.tenant = (const int*)tenant;
  a.tflags = (const int*)tflags;
  a.keys = (uint32_t*)keys;
  a.vg = (int2*)vg;
  a.se = (int2*)se;
  a.cnt = (int*)cnt;
  a.gens = (const int*)gens;
  a.page_table = (const int*)page_table;
  a.out = (uint32_t*)out;
  a.lanes = (int2*)lanes;
  a.epoch_dev = (int*)epoch_dev;
  a.B = B;
  a.n_gens = n_gens;
  a.n_pages = n_pages;
  a.S = S;
  a.ways = ways;
  a.max_age = max_age;
  return dispatch<true>(a, wire_w, max_grid, stream);
}

// K8's resident entry (jaxpath._flow_insert_core with lane_ok = ~hit,
// and the resident step's merge): `verdict16` holds the stateless
// classify's packed res16 words of the full batch, `hit_bits` K7's hit
// bitmap of it.  A lane whose hit bit is 0 writes its verdict into
// `merged` (K7's res16 words, which hold the hits' cached verdicts) and
// is eligible as on infw_flow_insert; a hit lane is not.  Eligible lanes
// keep batch order, so the last-lane winner is the one the host's
// compaction of the misses gives.  Serves *epoch_dev + 1 and, after its
// last grid barrier, stores it to *epoch_dev.  `counts` receives
// [inserts, evictions, promotes, 0] (any 4-byte aligned place, such as
// the resident step's fused output).
extern "C" int infw_flow_insert_resident(const void* wire, const void* tenant, const void* tflags,
                                         const void* verdict16, const void* hit_bits,
                                         void* merged, void* keys, void* vg, void* se, void* cnt,
                                         void* winner, const void* gens, const void* page_table,
                                         void* counts, void* lanes, void* epoch_dev, int B,
                                         int wire_w, int n_gens, int n_pages, int C, int S,
                                         int ways, int max_grid, void* stream) {
  (void)C;
  if (!epoch_dev || !hit_bits || !merged || !verdict16) return (int)cudaErrorInvalidValue;
  Args a{};
  a.wire = (const uint32_t*)wire;
  a.tenant = (const int*)tenant;
  a.tflags = (const int*)tflags;
  a.verdict = (const int*)verdict16;
  a.keys = (uint32_t*)keys;
  a.vg = (int2*)vg;
  a.se = (int2*)se;
  a.cnt = (int*)cnt;
  a.winner = (int*)winner;
  a.gens = (const int*)gens;
  a.page_table = (const int*)page_table;
  a.out = (uint32_t*)counts;
  a.lanes = (int2*)lanes;
  a.epoch_dev = (int*)epoch_dev;
  a.hit_bits = (const uint32_t*)hit_bits;
  a.merged = (uint32_t*)merged;
  a.B = B;
  a.n_gens = n_gens;
  a.n_pages = n_pages;
  a.S = S;
  a.ways = ways;
  return dispatch<false>(a, wire_w, max_grid, stream);
}
