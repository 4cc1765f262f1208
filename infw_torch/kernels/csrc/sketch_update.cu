// K9 on Hopper: the telemetry plane's sketch update.
//
// Replaces no TPU kernel: in the JAX package the update is XLA
// (kernels/sketch.py _sketch_update_core, launched alone by
// jitted_sketch_update on the multi-dispatch path and composed into
// jaxpath._resident_step_core on the resident one).  As torch ops it would
// be a few dozen launches of gathers and scatters an admission.
//
// The function, per lane of a (B, 4 | 7) wire with its tenant, TCP flags
// and verdict: the key [tenant, ip0..ip3, (kind & 3) << 8 | (verdict &
// 0xFF)] and its FNV-1a hash (h1, h2 = (h1 >> 16) | 1).  A lane is eligible
// when its kind is IPv4 or IPv6 and its tenant in [0, T); nothing else
// touches the state.
//   1. count-min: each eligible lane adds 1 to cms[d][(h1 + d h2) & (W-1)]
//      for d < D, wrapping in int32; then the WHOLE array is clamped,
//      min(c, sat), and every lane's estimate is the min over its D
//      buckets of the clamped counts (duplicate keys see the settled sums);
//   2. heavy hitters, on a K-slot table of `ways` candidates
//      (h1 + w h2) & (K-1): the probe reads keys and cnt before any write;
//      the lowest occupied (cnt > 0) way holding the key matches; a
//      matched lane raises cnt[slot] to its estimate (max); an unmatched
//      lane whose estimate beats the first empty way (0) or else the
//      first way of least count wants that slot, and the largest wanting
//      lane index wins it, writing its key and estimate after the maxima
//      (a winner's store overrides a max on the same slot);
//   3. tenant counters: [1, allow, deny, pure SYN] added to tcnt[tenant].
//
// Two plans, the host choosing one per call (kernels/sketch.py plan_for, a
// pure function of B, the geometry and the card's opt-in shared-memory
// limit, so that one CUDA graph always captures one plan).  In both, a
// lane's probe runs in its first phase, with its key words still in
// registers: the heavy-hitter table it reads is the snapshot from before
// any write either way, and only the estimate waits for the settled sums.
//
// Plan S (block_kernel): B up to the measured crossover and the state in
// one block's shared memory.  ONE ordinary launch of one 1024-thread
// block: cms, keys, cnt and tcnt staged with 16-byte loads, each slot's key
// hash | each lane's adds as shared atomics and its probe | barrier, each
// lane's estimate min_d(min(cms, sat)), a matched lane's max and a wanting
// lane's bid into the block's per-slot maxima and bids (shared atomicMax;
// a bid is the lane index above the estimate, 64 bits, so the largest lane
// wins and brings its estimate) | barrier, each slot settled by a thread: a
// winner's key and estimate, else the matched max | barrier, the four
// arrays written back with cms as min(c, sat): the whole-array clamp, each
// cell once.  No grid barrier, no global atomic on the state, no lane
// scratch.
//
// Plan L (grid_kernel): larger B, or a state too big for shared memory.
// One cooperative launch of 1024-thread blocks (one a 256 lanes, at most
// one an SM), each taking a contiguous run of lanes; where D W + 4 T + 8 K
// words fit in shared memory:
//   P1  each block zeroes a shared tally of cms and tcnt and stages keys,
//       cnt and each slot's key hash; its lanes add into the tally and
//       probe the staged table; then one atomicAdd a block for each
//       non-zero cell (the adds commute mod 2^32: the same result bit for
//       bit); the grid clears the scratch's bids, maxima and count |
//   grid barrier
//   P2  each block stages min(cms, sat) and writes back its own slice of
//       the clamped cells: the whole-array clamp, each cell once over the
//       grid (a stage read racing another block's clamp sees c or sat, and
//       the min with sat makes both the same); the estimates; the matched
//       maxima and the bids into the block's, then one atomicMax a block
//       for each slot touched into the scratch's;
//   P3  the last block done (the count: a fence, then an atomicAdd) settles
//       each slot as plan S does.
// Where the words do not fit, the same phases on global memory: atomics for
// the adds, the maxima and the bids, the probe reading global keys and cnt.
// Words written in the launch (cms, the scratch) are read through L2
// (__ldcg): L1 is not coherent across SMs.  Neither plan writes the global
// winner scratch (-1 on entry and exit).
//
// Per lane, in both plans: a thread's first kRegLanes lanes keep their
// carry (h1, the probe's slot code and floor) in registers across the
// barrier; lanes past those keep it in a spill, shared memory on plan S,
// the wrapper's scratch on plan L.  A thread loads its first lane while the
// state stages.
//
// What bounds it: bytes.  A lane reads its wire row, tenant, flags and
// verdict; the state (D W + 7 K + 4 T words, 40 KiB + 16 T at the
// defaults) is read and written once.  What the designs pay instead: the
// shared-memory gathers and atomics a lane makes (random banks), and the
// latency of each phase's global round trips and barriers.
//
// Layouts: wire (B, 4 | 7) u32 (wire_io.cuh full layouts); tenant, tflags
// (B,) i32; res (B,) i32 u32 verdicts, or on the resident entry ceil(B/2)
// words of packed u16 verdicts; cms (D, W), keys (K, 6), cnt (K,), tcnt
// (T, 4) i32; winner (K,) i32, -1 on entry and exit (neither plan writes
// it); spill, plan L's scratch, ceil((3 K + 1) / 4) + B int4, 16-byte
// aligned.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "wire_io.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;    // both plans; plan L runs one block an SM
constexpr int kRegLanes = 4;      // lanes a thread keeps in registers
constexpr int kGridLanes = 256;   // plan L: a block a 256 lanes, up to one an SM
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kTcp = 6;
constexpr int kTcpSyn = 0x02, kTcpAck = 0x10;
constexpr uint32_t kFnvBasis = 0x811C9DC5u, kFnvPrime = 0x01000193u;
constexpr int kKeyWords = 6;
constexpr int kPlanGrid = 0, kPlanBlock = 1;
constexpr int kNone = -1;  // a lane's slot code: none; >= 0 matched; <= -2 wanting

struct Args {
  const uint32_t* wire;
  const int* tenant;
  const int* tflags;
  const void* res;  // (B,) i32, or packed u16 words on the resident entry
  int* cms;
  uint32_t* keys;
  int* cnt;
  int* tcnt;
  int4* spill;  // plan L's scratch: bids, maxima and a count, then lane i's carry
  int B, D, W, K, ways, T, sat;
  int vec;  // cms, keys, cnt and tcnt are 16-byte aligned, D W and K multiples of 4
};

struct Lane {
  uint32_t key[kKeyWords];
  uint32_t h1;
  int act;
  bool elig;
  bool syn;
};

__device__ __forceinline__ uint32_t fnv(const uint32_t* k) {
  uint32_t h = kFnvBasis;
#pragma unroll
  for (int w = 0; w < kKeyWords; ++w) h = (h ^ k[w]) * kFnvPrime;
  return h;
}

template <int WW, bool kRes16>
__device__ __forceinline__ Lane lane_of(const Args& a, int i) {
  const wire_io::Packet p = wire_io::decode<WW>(a.wire, i, nullptr, 1);
  const int t = __ldg(a.tenant + i);
  const int fl = __ldg(a.tflags + i);
  const uint32_t r =
      kRes16 ? (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(a.res) + i)
             : (uint32_t)__ldg(reinterpret_cast<const int*>(a.res) + i);
  Lane L;
  L.act = (int)(r & 0xFFu);
  L.key[0] = (uint32_t)t;
  L.key[1] = p.w.x;
  L.key[2] = p.w.y;
  L.key[3] = p.w.z;
  L.key[4] = p.w.w;
  L.key[5] = (r & 0xFFu) | (((uint32_t)p.kind & 3u) << 8);
  L.elig = (p.kind == wire_io::kKindIPv4 || p.kind == wire_io::kKindIPv6) && t >= 0 && t < a.T;
  L.syn = p.proto == kTcp && (fl & kTcpSyn) != 0 && (fl & kTcpAck) == 0;
  L.h1 = fnv(L.key);
  return L;
}

// Lane i, or a zero lane (not eligible) at or past `end`.
template <int WW, bool kRes16>
__device__ __forceinline__ Lane lane_at(const Args& a, int i, int end) {
  Lane L = {};
  if (i < end) L = lane_of<WW, kRes16>(a, i);
  return L;
}

__device__ __forceinline__ int bucket(const Args& a, uint32_t h1, int d) {
  const uint32_t h2 = (h1 >> 16) | 1u;
  return d * a.W + (int)((h1 + (uint32_t)d * h2) & (uint32_t)(a.W - 1));
}

// Where a phase finds element i of an array (`stride` words an element):
// a plain array in shared or global memory, or global memory written in
// this launch, read through L2.
struct Flat {
  int* p;
  int stride;
  __device__ __forceinline__ int* at(int i) const { return p + (size_t)i * stride; }
  __device__ __forceinline__ int load(int i) const { return p[(size_t)i * stride]; }
};

struct ViaL2 {
  int* p;
  int stride;
  __device__ __forceinline__ int load(int i) const { return __ldcg(p + (size_t)i * stride); }
};

// One lane's adds into `cms` (cells) and `tcnt` (rows of 4).  Every lane of
// the warp calls it (`e` false for a lane past B or not eligible).  The
// count-min adds go one atomic a lane (an atomic serializes only the lanes
// on one address); when the warp's eligible lanes share one tenant row (one
// tenant, the common case) their counters are summed first and one lane
// adds them.
template <class Cells, class Rows>
__device__ __forceinline__ void add_lane(const Args& a, const Lane& L, bool e, int lane_id,
                                         const Cells& cms, const Rows& tcnt) {
  if (e) {
    for (int d = 0; d < a.D; ++d) atomicAdd(cms.at(bucket(a, L.h1, d)), 1);
  }
  const unsigned em = __ballot_sync(kFull, e);
  if (em == 0) return;
  const int lead = __ffs(em) - 1;
  const int row = (int)L.key[0];
  const int r0 = __shfl_sync(kFull, row, lead);
  if (__all_sync(kFull, !e || row == r0)) {
    const unsigned allow = __reduce_add_sync(kFull, (e && L.act == wire_io::kAllow) ? 1u : 0u);
    const unsigned deny = __reduce_add_sync(kFull, (e && L.act == wire_io::kDeny) ? 1u : 0u);
    const unsigned syn = __reduce_add_sync(kFull, (e && L.syn) ? 1u : 0u);
    if (lane_id == lead) {
      int* c = tcnt.at(r0);
      atomicAdd(c, __popc(em));
      if (allow) atomicAdd(c + 1, (int)allow);
      if (deny) atomicAdd(c + 2, (int)deny);
      if (syn) atomicAdd(c + 3, (int)syn);
    }
  } else if (e) {
    int* c = tcnt.at(row);
    atomicAdd(c, 1);
    if (L.act == wire_io::kAllow) atomicAdd(c + 1, 1);
    if (L.act == wire_io::kDeny) atomicAdd(c + 2, 1);
    if (L.syn) atomicAdd(c + 3, 1);
  }
}

// The heavy-hitter table a probe reads, the snapshot from before any write:
// shared memory (`kh1` the FNV of each slot's key), or global (kh1 null).
struct Table {
  const uint32_t* keys;
  const int* cnt;
  const uint32_t* kh1;
};

// One eligible lane's probe: (code, floor) with code the lowest occupied
// way's slot holding the key, else -2 - the slot the lane would want (the
// first empty way, floor 0; else the first way of least count, floor that
// count).  A way's key words are compared only where its hash equals h1.
template <bool kStaged>
__device__ __forceinline__ int2 probe(const Args& a, const Lane& L, const Table& t) {
  const uint32_t h2 = (L.h1 >> 16) | 1u;
  int vmin_cnt = 0, eslot = -1, vslot = -1;
  for (int w = 0; w < a.ways; ++w) {
    const int slot = (int)((L.h1 + (uint32_t)w * h2) & (uint32_t)(a.K - 1));
    const int c = kStaged ? t.cnt[slot] : __ldg(a.cnt + slot);
    if (w == 0 || c < vmin_cnt) {  // argmin: the first of ties
      vmin_cnt = c;
      vslot = slot;
    }
    if (c > 0) {
      if (!kStaged || t.kh1[slot] == L.h1) {
        const uint32_t* k = (kStaged ? t.keys : a.keys) + (size_t)slot * kKeyWords;
        bool eq = true;
#pragma unroll
        for (int j = 0; j < kKeyWords; ++j) eq = eq && (kStaged ? k[j] : __ldg(k + j)) == L.key[j];
        if (eq) return make_int2(slot, 0);
      }
    } else if (eslot < 0) {
      eslot = slot;
    }
  }
  return eslot >= 0 ? make_int2(-2 - eslot, 0) : make_int2(-2 - vslot, vmin_cnt);
}

// P1 for lane L (every lane of the warp calls it, L zero past B): the
// adds, then the probe.  Returns its carry (h1, code, floor).
template <bool kStaged, class Cells, class Rows>
__device__ __forceinline__ int4 take_lane(const Args& a, const Lane& L, int lane_id,
                                          const Cells& cms, const Rows& tcnt, const Table& t) {
  add_lane(a, L, L.elig, lane_id, cms, tcnt);
  if (!L.elig) return make_int4(0, kNone, 0, 0);
  const int2 p = probe<kStaged>(a, L, t);
  return make_int4((int)L.h1, p.x, p.y, 0);
}

// A wanting lane's bid: its lane index above its estimate, so the largest
// lane index wins a slot and carries its estimate along; 0 is no bid.
__device__ __forceinline__ unsigned long long bid_of(int i, int est) {
  return ((unsigned long long)(unsigned)(i + 1) << 32) | (unsigned)est;
}

// P2 for lane i: its estimate min_d(min(cms, sat)) over the settled sums;
// a matched lane's max into `mmax`, a wanting lane's bid into `bids` where
// the estimate beats the floor (atomicMax, shared or global).
template <class Cells>
__device__ __forceinline__ void bid_lane(const Args& a, int i, int4 c, const Cells& cms,
                                         unsigned long long* bids, int* mmax) {
  if (c.y == kNone) return;
  int est = INT_MAX;
  for (int d = 0; d < a.D; ++d) est = min(est, min(cms.load(bucket(a, (uint32_t)c.x, d)), a.sat));
  if (c.y >= 0) {
    atomicMax(mmax + c.y, est);
  } else if (est > c.z) {
    atomicMax(bids + (-2 - c.y), bid_of(i, est));
  }
}

// Slot k once every bid and max is in: a winner stores its key (its key
// words read again: at most K lanes) and its estimate, overriding the
// matched maxima; else the matched lanes' max (INT_MIN: none) raises cnt.
template <int WW, bool kRes16>
__device__ __forceinline__ void settle_slot(const Args& a, int k, unsigned long long bid, int m,
                                            int* cnt, uint32_t* keys) {
  if (bid != 0) {
    const Lane L = lane_of<WW, kRes16>(a, (int)(bid >> 32) - 1);
#pragma unroll
    for (int j = 0; j < kKeyWords; ++j) keys[(size_t)k * kKeyWords + j] = L.key[j];
    cnt[k] = (int)(unsigned)bid;
  } else if (m != INT_MIN) {
    cnt[k] = max(cnt[k], m);
  }
}

// Four words from `p` at group q, one 16-byte load (p 16-byte aligned).
__device__ __forceinline__ int4 load4(const int* p, int q) {
  return __ldcg(reinterpret_cast<const int4*>(p) + q);
}

__device__ __forceinline__ void store4(int* p, int q, int4 v) {
  reinterpret_cast<int4*>(p)[q] = v;
}

__device__ __forceinline__ int4 min4(int4 v, int s) {
  return make_int4(min(v.x, s), min(v.y, s), min(v.z, s), min(v.w, s));
}

// n words between global and shared memory, by the block: 16 bytes a
// thread where `vec` (both pointers 16-byte aligned, n a multiple of 4).
__device__ __forceinline__ void copy_in(int* dst, const int* src, int n, bool vec) {
  if (vec) {
    for (int q = threadIdx.x; q < n / 4; q += blockDim.x)
      reinterpret_cast<int4*>(dst)[q] = load4(src, q);
  } else {
    for (int k = threadIdx.x; k < n; k += blockDim.x) dst[k] = __ldcg(src + k);
  }
}

// The same back, each word min(word, sat).
__device__ __forceinline__ void copy_out(int* dst, const int* src, int n, bool vec, int sat) {
  if (vec) {
    for (int q = threadIdx.x; q < n / 4; q += blockDim.x)
      store4(dst, q, min4(reinterpret_cast<const int4*>(src)[q], sat));
  } else {
    for (int k = threadIdx.x; k < n; k += blockDim.x) dst[k] = min(src[k], sat);
  }
}

// The FNV of each of the K staged keys, by the block.
__device__ __forceinline__ void hash_keys(uint32_t* kh1, const uint32_t* keys, int K) {
  for (int k = threadIdx.x; k < K; k += blockDim.x) kh1[k] = fnv(keys + (size_t)k * kKeyWords);
}

// Plan S's shared memory: the bids (K 8-byte words), cms, cnt, the slots'
// key hashes, the matched maxima, tcnt and keys (words; each segment
// 16-byte aligned where D W and K are multiples of 4), then from a 16-byte
// boundary a 16-byte carry for each lane past the register lanes.
// kernels/sketch.py block_plan_bytes is the same count.
__host__ __device__ __forceinline__ long long state_words(int D, int W, int K, int T) {
  return ((long long)D * W + 11LL * K + 4LL * T + 3) / 4 * 4;
}

__host__ __device__ __forceinline__ long long block_words(int B, int D, int W, int K, int T) {
  const long long spill = (long long)B - (long long)kRegLanes * kThreads;
  return state_words(D, W, K, T) + 4 * (spill > 0 ? spill : 0);
}

// Plan L's shared memory (staged): P1 the tallies of cms and tcnt, then
// keys, cnt and the key hashes; P2 the block's bids (K 8-byte words), its
// matched maxima and the clamped cms, over the same words.
__host__ __device__ __forceinline__ long long grid_words(int D, int W, int K, int T) {
  return (long long)D * W + 4LL * T + 8LL * K;
}

template <int WW, bool kRes16>
__global__ void __launch_bounds__(kThreads, 1) block_kernel(const Args a) {
  extern __shared__ int4 smem[];
  const int DW = a.D * a.W, K = a.K;
  unsigned long long* s_bid = reinterpret_cast<unsigned long long*>(smem);
  int* s_cms = reinterpret_cast<int*>(s_bid + K);
  int* s_cnt = s_cms + DW;
  uint32_t* s_kh1 = reinterpret_cast<uint32_t*>(s_cnt + K);
  int* s_max = reinterpret_cast<int*>(s_kh1 + K);
  int* s_tcnt = s_max + K;
  uint32_t* s_keys = reinterpret_cast<uint32_t*>(s_tcnt + 4 * a.T);
  int4* s_spill =
      reinterpret_cast<int4*>(reinterpret_cast<int*>(smem) + state_words(a.D, a.W, K, a.T));
  const int tid = (int)threadIdx.x;
  const int lane_id = tid & 31;
  const int rounds = (a.B + kThreads - 1) / kThreads;
  const int base = kRegLanes * kThreads;
  const bool vec = a.vec != 0;

  // the first lane's operands load while the state stages
  const Lane first = lane_at<WW, kRes16>(a, tid, a.B);
  // stage (cms raw: the adds wrap before the clamp), the key hashes
  copy_in(s_cms, a.cms, DW, vec);
  copy_in(s_cnt, a.cnt, K, vec);
  copy_in(s_tcnt, a.tcnt, 4 * a.T, vec);
  copy_in(reinterpret_cast<int*>(s_keys), reinterpret_cast<const int*>(a.keys), kKeyWords * K,
          vec);
  for (int k = tid; k < K; k += kThreads) {
    s_bid[k] = 0;
    s_max[k] = INT_MIN;
  }
  __syncthreads();
  hash_keys(s_kh1, s_keys, K);
  __syncthreads();

  // 1. the adds and the probes
  const Flat cms{s_cms, 1}, tcnt{s_tcnt, 4};
  const Table t{s_keys, s_cnt, s_kh1};
  int4 c[kRegLanes];
#pragma unroll
  for (int r = 0; r < kRegLanes; ++r) {
    c[r] = make_int4(0, kNone, 0, 0);
    if (r < rounds)
      c[r] = take_lane<true>(a, r == 0 ? first : lane_at<WW, kRes16>(a, r * kThreads + tid, a.B),
                             lane_id, cms, tcnt, t);
  }
  for (int r = kRegLanes; r < rounds; ++r) {
    const int i = r * kThreads + tid;
    const int4 x = take_lane<true>(a, lane_at<WW, kRes16>(a, i, a.B), lane_id, cms, tcnt, t);
    if (i < a.B) s_spill[i - base] = x;
  }
  __syncthreads();

  // 2. estimates, the matched maxima and the bids
#pragma unroll
  for (int r = 0; r < kRegLanes; ++r) bid_lane(a, r * kThreads + tid, c[r], cms, s_bid, s_max);
  for (int i = base + tid; i < a.B; i += kThreads)
    bid_lane(a, i, s_spill[i - base], cms, s_bid, s_max);
  __syncthreads();

  // 3. each slot settled
  for (int k = tid; k < K; k += kThreads)
    settle_slot<WW, kRes16>(a, k, s_bid[k], s_max[k], s_cnt, s_keys);
  __syncthreads();

  // 4. write back, cms clamped
  copy_out(a.cms, s_cms, DW, vec, a.sat);
  copy_out(a.cnt, s_cnt, K, vec, INT_MAX);
  copy_out(a.tcnt, s_tcnt, 4 * a.T, vec, INT_MAX);
  copy_out(reinterpret_cast<int*>(a.keys), reinterpret_cast<const int*>(s_keys),
           kKeyWords * K, vec, INT_MAX);
}

// Plan L's scratch: the bids (K 8-byte words), the matched maxima (K
// words), the count of blocks done, to 16 bytes; then lane i's carry.
// kernels/sketch.py grid_scratch_words is the same count.
__host__ __device__ __forceinline__ long long grid_scratch_head(int K) {
  return (3LL * K + 1 + 3) / 4;  // in 16-byte units
}

template <int WW, bool kRes16, bool kStaged>
__global__ void __launch_bounds__(kThreads, 1) grid_kernel(const Args a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ int4 smem[];
  const int n = (int)(gridDim.x * kThreads);
  const int tid = (int)threadIdx.x;
  const int gtid = (int)blockIdx.x * kThreads + tid;
  const int lane_id = tid & 31;
  // this block's lanes: [lo, lo + per), round r's lane lo + r kThreads + tid
  const int per = (int)(((long long)a.B + gridDim.x - 1) / gridDim.x);
  const int lo = (int)blockIdx.x * per;
  const int end = min(a.B, lo + per);
  const int rounds = (per + kThreads - 1) / kThreads;
  const int DW = a.D * a.W, K = a.K;
  const bool vec = a.vec != 0;
  int* sm = reinterpret_cast<int*>(smem);
  unsigned long long* g_bid = reinterpret_cast<unsigned long long*>(a.spill);
  int* g_max = reinterpret_cast<int*>(g_bid + K);
  int* done = g_max + K;
  int4* spill = a.spill + grid_scratch_head(K);

  // the first lane's operands load while the state stages; the scratch's
  // bids, maxima and count cleared before the barrier
  const Lane first = lane_at<WW, kRes16>(a, lo + tid, end);
  for (int k = gtid; k < K; k += n) {
    g_bid[k] = 0;
    g_max[k] = INT_MIN;
  }
  if (gtid == 0) *done = 0;

  // P1: the adds (each block's tallies) and the probes
  int4 c[kRegLanes];
  {
    int* t_cms = kStaged ? sm : a.cms;
    int* t_tcnt = kStaged ? sm + DW : a.tcnt;
    Table t{nullptr, nullptr, nullptr};
    if constexpr (kStaged) {
      uint32_t* s_keys = reinterpret_cast<uint32_t*>(t_tcnt + 4 * a.T);
      int* s_cnt = reinterpret_cast<int*>(s_keys + kKeyWords * K);
      uint32_t* s_kh1 = reinterpret_cast<uint32_t*>(s_cnt + K);
      for (int k = tid; k < DW + 4 * a.T; k += kThreads) t_cms[k] = 0;
      copy_in(reinterpret_cast<int*>(s_keys), reinterpret_cast<const int*>(a.keys),
              kKeyWords * K, vec);
      copy_in(s_cnt, a.cnt, K, vec);
      __syncthreads();
      hash_keys(s_kh1, s_keys, K);
      __syncthreads();
      t = Table{s_keys, s_cnt, s_kh1};
    }
    const Flat cms{t_cms, 1}, tcnt{t_tcnt, 4};
#pragma unroll
    for (int r = 0; r < kRegLanes; ++r) {
      c[r] = make_int4(0, kNone, 0, 0);
      if (r < rounds)
        c[r] = take_lane<kStaged>(
            a, r == 0 ? first : lane_at<WW, kRes16>(a, lo + r * kThreads + tid, end), lane_id,
            cms, tcnt, t);
    }
    for (int r = kRegLanes; r < rounds; ++r) {
      const int i = lo + r * kThreads + tid;
      const int4 x = take_lane<kStaged>(a, lane_at<WW, kRes16>(a, i, end), lane_id, cms, tcnt, t);
      if (i < end) spill[i] = x;
    }
    if constexpr (kStaged) {  // the block's tallies, one atomic a non-zero cell
      __syncthreads();
      for (int k = tid; k < DW + 4 * a.T; k += kThreads) {
        const int v = t_cms[k];
        if (v != 0) atomicAdd(k < DW ? a.cms + k : a.tcnt + (k - DW), v);
      }
    }
  }
  grid.sync();

  // P2: the clamp (and the stage), the estimates, the matched maxima and
  // the bids
  if constexpr (kStaged) {
    unsigned long long* s_bid = reinterpret_cast<unsigned long long*>(smem);
    int* s_max = reinterpret_cast<int*>(s_bid + K);
    int* s_cms = s_max + K;
    // this block's slice of the clamp: units [u0, u1) of 4 cells (or 1)
    const int units = vec ? DW / 4 : DW;
    const int span = (units + (int)gridDim.x - 1) / (int)gridDim.x;
    const int u0 = (int)blockIdx.x * span, u1 = u0 + span;
    if (vec) {
      for (int q = tid; q < units; q += kThreads) {
        const int4 v = load4(a.cms, q);
        const int4 m = min4(v, a.sat);
        reinterpret_cast<int4*>(s_cms)[q] = m;
        if (q >= u0 && q < u1 && (v.x > a.sat || v.y > a.sat || v.z > a.sat || v.w > a.sat))
          store4(a.cms, q, m);
      }
    } else {
      for (int k = tid; k < units; k += kThreads) {
        const int v = __ldcg(a.cms + k);
        s_cms[k] = min(v, a.sat);
        if (k >= u0 && k < u1 && v > a.sat) a.cms[k] = a.sat;
      }
    }
    for (int k = tid; k < K; k += kThreads) {
      s_bid[k] = 0;
      s_max[k] = INT_MIN;
    }
    __syncthreads();
    const Flat cms{s_cms, 1};
#pragma unroll
    for (int r = 0; r < kRegLanes; ++r) bid_lane(a, lo + r * kThreads + tid, c[r], cms, s_bid, s_max);
    for (int i = lo + kRegLanes * kThreads + tid; i < end; i += kThreads)
      bid_lane(a, i, __ldcg(spill + i), cms, s_bid, s_max);
    __syncthreads();
    for (int k = tid; k < K; k += kThreads) {  // the block's, one atomic a slot
      if (s_bid[k] != 0) atomicMax(g_bid + k, s_bid[k]);
      if (s_max[k] != INT_MIN) atomicMax(g_max + k, s_max[k]);
    }
  } else {
    for (int k = gtid; k < DW; k += n) {
      if (__ldcg(a.cms + k) > a.sat) a.cms[k] = a.sat;
    }
    const ViaL2 cms{a.cms, 1};
#pragma unroll
    for (int r = 0; r < kRegLanes; ++r) bid_lane(a, lo + r * kThreads + tid, c[r], cms, g_bid, g_max);
    for (int i = lo + kRegLanes * kThreads + tid; i < end; i += kThreads)
      bid_lane(a, i, __ldcg(spill + i), cms, g_bid, g_max);
  }

  // P3: the last block done settles each slot
  __syncthreads();
  int last = 0;
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(done, 1) == (int)gridDim.x - 1;
  }
  if (__syncthreads_or(last)) {
    __threadfence();
    for (int k = tid; k < K; k += kThreads)
      settle_slot<WW, kRes16>(a, k, __ldcg(g_bid + k), __ldcg(g_max + k), a.cnt, a.keys);
  }
}

constexpr int kKernels = 12;  // plan S: 4; plan L: 8

void kernel_list(const void* out[kKernels]) {
  int j = 0;
  out[j++] = (const void*)block_kernel<4, false>;
  out[j++] = (const void*)block_kernel<4, true>;
  out[j++] = (const void*)block_kernel<7, false>;
  out[j++] = (const void*)block_kernel<7, true>;
  out[j++] = (const void*)grid_kernel<4, false, false>;
  out[j++] = (const void*)grid_kernel<4, false, true>;
  out[j++] = (const void*)grid_kernel<4, true, false>;
  out[j++] = (const void*)grid_kernel<4, true, true>;
  out[j++] = (const void*)grid_kernel<7, false, false>;
  out[j++] = (const void*)grid_kernel<7, false, true>;
  out[j++] = (const void*)grid_kernel<7, true, false>;
  out[j++] = (const void*)grid_kernel<7, true, true>;
}

struct Device {
  int ready;
  int sms;
  int smem_optin;
  int grid_smem[kKernels];  // the dynamic shared memory each grid_per_sm was queried at
  int grid_per_sm[kKernels];
};

Device devices[wire_io::kMaxDevices];

// Once per device, outside any graph capture (the wrapper calls it through
// infw_sketch_prepare before its first launch): the SM count, the opt-in
// shared-memory limit of a block, and every kernel's dynamic shared-memory
// cap raised to it.
cudaError_t prepare(int* device_out) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= wire_io::kMaxDevices) return cudaErrorInvalidDevice;
  *device_out = device;
  Device& d = devices[device];
  if (d.ready) return cudaSuccess;
  int sms = 0, optin = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const void* fns[kKernels];
  kernel_list(fns);
  for (int j = 0; j < kKernels; ++j) {
    err = cudaFuncSetAttribute(fns[j], cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
  }
  d.sms = sms;
  d.smem_optin = optin;
  d.ready = 1;
  return cudaSuccess;
}

template <int WW, bool kRes16>
cudaError_t launch_block(const Args& a, const Device& d, cudaStream_t stream) {
  const long long bytes = 4 * block_words(a.B, a.D, a.W, a.K, a.T);
  if (bytes > d.smem_optin) return cudaErrorInvalidValue;
  block_kernel<WW, kRes16><<<1, kThreads, (size_t)bytes, stream>>>(a);
  return cudaSuccess;
}

// Plan L's grid: one block a kGridLanes lanes (and at least one a 16384
// cells of an unstaged clamp), at most the co-resident blocks, at most
// max_grid > 0.
template <int WW, bool kRes16, bool kStaged>
cudaError_t launch_grid(Args a, Device& d, int slot, int bytes, int max_grid,
                        cudaStream_t stream) {
  const void* kernel = (const void*)grid_kernel<WW, kRes16, kStaged>;
  if (d.grid_per_sm[slot] == 0 || d.grid_smem[slot] != bytes) {
    int per_sm = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, bytes);
    if (err != cudaSuccess) return err;
    if (per_sm <= 0) return cudaErrorCooperativeLaunchTooLarge;
    d.grid_per_sm[slot] = per_sm;
    d.grid_smem[slot] = bytes;
  }
  const long long cells = (long long)a.D * a.W;
  long long grid = ((long long)a.B + kGridLanes - 1) / kGridLanes;
  if (!kStaged && grid < (cells + 16 * kThreads - 1) / (16 * kThreads))
    grid = (cells + 16 * kThreads - 1) / (16 * kThreads);
  const long long cap = (long long)d.sms * d.grid_per_sm[slot];
  if (grid > cap) grid = cap;
  if (max_grid > 0 && grid > max_grid) grid = max_grid;
  if (grid < 1) grid = 1;
  void* args[] = {(void*)&a};
  return cudaLaunchCooperativeKernel(kernel, dim3((unsigned)grid), dim3(kThreads), args,
                                     (size_t)bytes, stream);
}

template <int WW, bool kRes16>
cudaError_t launch(Args& a, int plan, int max_grid, cudaStream_t stream) {
  int device = 0;
  cudaError_t err = prepare(&device);
  if (err != cudaSuccess) return err;
  Device& d = devices[device];
  if (plan == kPlanBlock) return launch_block<WW, kRes16>(a, d, stream);
  if (plan != kPlanGrid) return cudaErrorInvalidValue;
  if (a.spill == nullptr) return cudaErrorInvalidValue;
  const long long words = grid_words(a.D, a.W, a.K, a.T);
  const bool staged = 4 * words <= d.smem_optin;
  const long long bytes = staged ? 4 * words : 0;
  const int slot = 4 * (WW == 7) + 2 * kRes16 + staged;
  return staged ? launch_grid<WW, kRes16, true>(a, d, slot, (int)bytes, max_grid, stream)
                : launch_grid<WW, kRes16, false>(a, d, slot, (int)bytes, max_grid, stream);
}

// `winner` is the first design's per-slot scratch, kept in the entries'
// signatures: neither plan reads or writes it.
template <bool kRes16>
int dispatch(const void* wire, const void* tenant, const void* tflags, const void* res,
             void* cms, void* keys, void* cnt, void* tcnt, void* /*winner*/, void* spill, int B,
             int wire_w, int D, int W, int K, int ways, int T, int sat, int max_grid, int plan,
             void* stream) {
  Args a{};
  a.wire = (const uint32_t*)wire;
  a.tenant = (const int*)tenant;
  a.tflags = (const int*)tflags;
  a.res = res;
  a.cms = (int*)cms;
  a.keys = (uint32_t*)keys;
  a.cnt = (int*)cnt;
  a.tcnt = (int*)tcnt;
  a.spill = (int4*)spill;
  a.B = B;
  a.D = D;
  a.W = W;
  a.K = K;
  a.ways = ways;
  a.T = T;
  a.sat = sat;
  a.vec = (((uintptr_t)cms | (uintptr_t)keys | (uintptr_t)cnt | (uintptr_t)tcnt) & 15u) == 0 &&
          (D * W) % 4 == 0 && K % 4 == 0;
  cudaError_t err;
  if (B < 1 || D < 1 || D > 8 || ways < 1 || ways > 8 || T < 1 || sat < 1 || W < 1 ||
      (W & (W - 1)) || K < 1 || (K & (K - 1)) || ((uintptr_t)spill & 15u)) {
    err = cudaErrorInvalidValue;
  } else if (wire_w == 4) {
    err = launch<4, kRes16>(a, plan, max_grid, (cudaStream_t)stream);
  } else if (wire_w == 7) {
    err = launch<7, kRes16>(a, plan, max_grid, (cudaStream_t)stream);
  } else {
    err = cudaErrorInvalidValue;
  }
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace

// Once per device, before the first launch and outside any graph capture:
// raises every K9 kernel's dynamic shared-memory cap to the card's opt-in
// limit and returns that limit in bytes (the host's plan choice reads it),
// or minus a CUDA error.
extern "C" int infw_sketch_prepare(int reserved) {
  if (reserved != 0) return -(int)cudaErrorInvalidValue;
  int device = 0;
  const cudaError_t err = prepare(&device);
  if (err != cudaSuccess) return -(int)err;
  return devices[device].smem_optin;
}

// K9, classic entry: `res` (B,) i32 u32 verdicts.  One launch on `stream`
// (B >= 1): plan 1 (S) one block, plan 0 (L) the cooperative grid;
// returns its error, else cudaGetLastError().  Allocates nothing; `winner`
// (K,) is -1 on entry and again when the launch ends; `spill`
// (ceil((3 K + 1) / 4) + B int4, 16-byte aligned) is plan L's scratch
// (null on plan S);
// max_grid > 0 caps plan L's grid (tests), 0 takes what fits.
extern "C" int infw_sketch_update(const void* wire, const void* tenant, const void* tflags,
                                  const void* res, void* cms, void* keys, void* cnt, void* tcnt,
                                  void* winner, void* spill, int B, int wire_w, int D, int W,
                                  int K, int ways, int T, int sat, int max_grid, int plan,
                                  void* stream) {
  return dispatch<false>(wire, tenant, tflags, res, cms, keys, cnt, tcnt, winner, spill, B,
                         wire_w, D, W, K, ways, T, sat, max_grid, plan, stream);
}

// K9, resident entry: `res` holds ceil(B/2) words of packed u16 verdicts
// (the merged results K8 wrote into the resident step's output).
extern "C" int infw_sketch_update_resident(const void* wire, const void* tenant,
                                           const void* tflags, const void* res, void* cms,
                                           void* keys, void* cnt, void* tcnt, void* winner,
                                           void* spill, int B, int wire_w, int D, int W, int K,
                                           int ways, int T, int sat, int max_grid, int plan,
                                           void* stream) {
  return dispatch<true>(wire, tenant, tflags, res, cms, keys, cnt, tcnt, winner, spill, B,
                        wire_w, D, W, K, ways, T, sat, max_grid, plan, stream);
}
