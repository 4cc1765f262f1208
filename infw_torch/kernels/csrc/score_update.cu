// K10 on Hopper: the anomaly-scoring tier's update.
//
// Replaces no TPU kernel: in the JAX package the update is XLA
// (infw/kernels/mxu_score.py _score_update_core, launched alone by
// jitted_score_update on the multi-dispatch path and composed into
// jaxpath._resident_step_core on the resident one).  Bit for bit the same
// as kernels/mxu_score.py score_update_plain.
//
// The function, per lane of a (B, 4 | 7) wire with its tenant, TCP flags
// and verdict: the key [tenant, ip0-3, kind & 3] and its FNV-1a hash (h1,
// h2 = (h1 >> 16) | 1).  A lane is eligible when its kind is IPv4 or IPv6
// and its tenant in [0, T).  The reference reads the state at three fixed
// points, and each is a barrier here:
//   A. on the rows before any write: an eligible lane adds 1 to its D
//      count-min cells (int32, wrapping); every lane probes the source
//      table (the first occupied way holding the key, else the first empty
//      way, else the first way of least lastepoch) and reads the row's
//      lastport and lastepoch; an eligible lane bids for its slot (2 i +
//      matched: the largest lane wins and brings its matched flag) and adds
//      its seeds [1, pure SYN, rule deny, new port];
//   B. per slot: columns 0-3 become min((replaced ? 0 : old) + seeds, sat)
//      on every slot, a replaced slot (a winner that did not match) zeroes
//      columns 6 and 7; per cell the clamp min(c, sat) of the whole array;
//   C. per lane, on the rows as written: the 16 features (the estimate from
//      the clamped cells, the epoch delta from the probe's lastepoch), the
//      forest (one leaf a tree) and the int8 head, the per-tenant policy;
//      the winner writes its slot's lastport, the epoch and (replaced) its
//      key; the anomalous lanes add into column 6, the eligible lanes into
//      their tenant's window counters [scored, anomalous, enforced, max];
//   D. column 6 clamped on every slot, the epoch advanced; e1 (the epoch
//      + 1) is read by every lane before the advance.
//
// Two plans, the host choosing one per call (kernels/mxu_score.py plan_for,
// a pure function of B, the geometry and the card's opt-in shared-memory
// limit, so one CUDA graph always captures one plan).  Each is ONE launch,
// no memset, no reset launch.
//
// Plan S (block_kernel): one 1024-thread block with the state (source
// columns and keys, count-min rows, tenant counters), the slot bids and
// seeds and the model in shared memory; the phases are __syncthreads()
// apart, every add a shared atomic; the columns, count-min rows and tenant
// counters written back once (the keys are written by the winners).
//
// Plan L (grid_kernel): a cooperative grid of 1024-thread blocks (one a 256
// lanes, at most the co-resident blocks), each taking a run of lanes that
// starts on a multiple of 32.  Where the geometry fits, each block stages
// the source rows for its probes and tallies its lanes' count-min adds,
// bids and seeds in shared memory, then pushes one global atomic a block
// for each non-zero cell and bid slot (the adds commute mod 2^32, the bids
// are maxima: the same result bit for bit); likewise its anomaly hits and
// tenant counters in phase C.  One grid barrier, after A: phase B's writes
// wait for the end instead, so phase C reads the rows as they were and
// settles its slot's columns 0-3 itself (from the bid and seeds, complete
// after the barrier), and takes min(c, sat) of each count-min cell it
// reads while the grid clamps the cells (a read racing the clamp sees c or
// sat, the same after the min).  The anomaly hits go to a per-slot tally;
// the last block done (a ticket counter) writes each slot's columns 0-3, 6
// (min(hits + (replaced ? 0 : old), sat)) and 7, puts the scratch back and
// advances the epoch.  Words written in the launch are read through L2
// (__ldcg): L1 is not coherent across SMs.  The bids, seeds and hits live
// in the caller's per-slot scratch, -1 / 0 on entry and again at the end.
// Where the tallies do not fit, the same phases on global atomics.
//
// A thread keeps its first kRegLanes lanes' carry (slot and flag bits, the
// probe's lastepoch, the verdict, the hash) in registers across the
// barriers, so phase C's loads wait on none of its own; lanes
// past those spill to shared memory on plan S and to the caller's spill
// (16 bytes a lane) on plan L.  On the resident entry lanes 2j and 2j + 1
// sit in neighbouring threads of one warp: a shuffle brings the odd lane's
// verdict and score to the even one, which writes the pair's words.
//
// What bounds it: bytes.  A lane reads its wire row, tenant, flags and
// verdict and writes its outputs; the state (14 S + D W + 4 T words, 42 KiB
// at the defaults) is read and written once.  What the designs pay
// instead: the shared atomics on hot slots and cells (a synflood's sources
// put most lanes on two slots), and each phase's global round trips and
// barriers.
//
// Entries: infw_score_update (classic: `res` the (B,) u32 verdicts, `out`
// [score, anom, res'] x B) and infw_score_update_resident (`res` the
// stateless res16 words, `served` the probe's res16 words, `hit` its
// bitmap; the lane's verdict is hit ? served : res; `out` the anomaly
// bitmap then the int16 scores).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "failsafe.cuh"
#include "wire_io.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;   // both plans; plan L runs one block an SM
constexpr int kRegLanes = 2;     // lanes whose carry a thread keeps in registers
constexpr int kGridLanes = 256;  // plan L: a block a 256 lanes, up to the co-resident blocks
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kFeatures = 16;
constexpr int kFirstSight = 65535;
constexpr int kProtoTCP = failsafe_cells::kProtoTCP;
constexpr int kTcpSyn = 0x02;
constexpr int kTcpAck = 0x10;
constexpr int kDeny = 1;
constexpr int kKeyWords = 6;
constexpr uint32_t kFnvBasis = 0x811C9DC5u, kFnvPrime = 0x01000193u;
constexpr int kPlanGrid = 0, kPlanBlock = 1;
// a lane's flag bits
constexpr int kElig = 1, kMatched = 2, kSynLane = 4, kDenyLane = 8, kNewport = 16;
constexpr int kNoLane = -1;  // a carry's first word: no lane (past B or past the block's run)
constexpr int kBitsShift = 5;  // a carry's first word: slot << kBitsShift | flag bits

struct Args {
  const uint32_t* wire;
  const int* tenant;
  const int* tflags;
  uint32_t* res;     // classic: (B,) u32 verdicts; resident: stateless res16 words
  uint32_t* served;  // resident: the probe's res16 words
  const uint32_t* hit;
  uint32_t* skeys;
  int* scols;
  int* cms;
  int* tstat;
  int* epoch;
  const int* fidx;
  const int* fthr;
  const int8_t* leaf;
  const int8_t* w1;
  const int* b1;
  const int8_t* w2;
  const int* b2;
  const int* qshift;
  const int* tparams;
  int* winner;  // the per-slot scratch: S bids (-1: none), 4 S seeds, S hits, a count
  int* seeds;
  int* hits;  // plan L: each slot's anomaly hits
  int* done;  // plan L: the blocks done
  int4* spill;  // plan L: lane i's carry where a block's lanes outrun its registers
  int* out;
  int B, S, ways, D, W, T, trees, depth, hidden, sat;
  int per;  // plan L: lanes a block (a multiple of 32)
};

__host__ __device__ __forceinline__ long long r4(long long words) { return (words + 3) / 4 * 4; }

// The model's shared copy, in words: fidx and fthr (trees x depth), b1
// (hidden) as int32, then the int8 leaves (trees << depth), w1 (16 x
// hidden) and w2 (hidden); each segment on 16 bytes.  kernels/mxu_score.py
// model_words is the same count.
__host__ __device__ __forceinline__ long long model_words(int trees, int depth, int hidden) {
  const long long td = (long long)trees * depth;
  return 2 * r4(td) + r4(hidden) + r4((((long long)trees << depth) + 3) / 4) + 4LL * hidden +
         r4((hidden + 3) / 4);
}

// Plan S's shared memory: the model, the source columns (8 S) and keys (6
// S), the count-min rows (D W), the tenant counters (4 T), the bids (S) and
// seeds (4 S), then a 16-byte carry for each lane past the register lanes.
// kernels/mxu_score.py block_plan_bytes is the same count.
__host__ __device__ __forceinline__ long long block_words(int B, int S, int D, int W, int T,
                                                          int trees, int depth, int hidden) {
  const long long spill = (long long)B - (long long)kRegLanes * kThreads;
  return model_words(trees, depth, hidden) + 19LL * S + (long long)D * W + 4LL * T +
         4 * (spill > 0 ? spill : 0);
}

// Plan L's shared memory where its tallies fit: the model, the staged rows
// (14 S: columns, then keys), then phase A's count-min tally (D W), bids (S)
// and seeds (4 S), over which phase C lays its hit tally (S) and tenant
// tally (4 T).  kernels/mxu_score.py grid_plan_bytes is the same count.
__host__ __device__ __forceinline__ long long grid_words(int S, int D, int W, int T, int trees,
                                                         int depth, int hidden) {
  const long long a = 5LL * S + (long long)D * W, c = (long long)S + 4LL * T;
  return model_words(trees, depth, hidden) + 14LL * S + (a > c ? a : c);
}

__device__ __forceinline__ uint32_t fnv(const uint32_t key[kKeyWords]) {
  uint32_t h = kFnvBasis;
#pragma unroll
  for (int w = 0; w < kKeyWords; ++w) h = (h ^ key[w]) * kFnvPrime;
  return h;
}

__device__ __forceinline__ int bucket(const Args& a, uint32_t h1, int d) {
  const uint32_t h2 = (h1 >> 16) | 1u;
  return d * a.W + (int)((h1 + (uint32_t)d * h2) & (uint32_t)(a.W - 1));
}

__device__ __forceinline__ int min_sat(int v, int sat) { return v < sat ? v : sat; }

// XLA's floor division of an int32 by a positive int32.
__device__ __forceinline__ int floor_div(int x, int d) {
  int q = x / d;
  if ((x % d) != 0 && x < 0) --q;
  return q;
}

__device__ __forceinline__ uint32_t sat16(int v) {
  return (uint32_t)(v < -32768 ? -32768 : (v > 32767 ? 32767 : v)) & 0xFFFFu;
}

// The lane's verdict: the classic entry's u32, or the resident merge.  The
// resident words are read through L2: the warp writes them in phase C.
template <bool kRes>
__device__ __forceinline__ uint32_t verdict(const Args& a, int i) {
  if (!kRes) return __ldg(reinterpret_cast<const unsigned*>(a.res) + i);
  const bool hit = (__ldg(a.hit + (i >> 5)) >> (i & 31)) & 1u;
  const uint32_t w = hit ? __ldcg(a.served + (i >> 1)) : __ldcg(a.res + (i >> 1));
  return (w >> ((uint32_t)(i & 1) * 16u)) & 0xFFFFu;
}

// One lane's phase-A operands.
struct Lane {
  uint32_t key[kKeyWords];
  uint32_t h1;
  uint32_t r;
  int dport;
  bool valid, elig, syn, deny;
};

// Lane i, or no lane (valid false) at or past `end`.
template <int WW, bool kRes>
__device__ __forceinline__ Lane lane_at(const Args& a, int i, int end) {
  Lane L = {};
  if (i >= end) return L;
  const wire_io::Packet p = wire_io::decode<WW>(a.wire, i, nullptr, 1);
  const int t = __ldg(a.tenant + i);
  const int fl = __ldg(a.tflags + i);
  L.valid = true;
  L.key[0] = (uint32_t)t;
  L.key[1] = p.w.x;
  L.key[2] = p.w.y;
  L.key[3] = p.w.z;
  L.key[4] = p.w.w;
  L.key[5] = (uint32_t)p.kind & 3u;
  L.h1 = fnv(L.key);
  L.r = verdict<kRes>(a, i);
  L.dport = p.dport;
  L.elig = (p.kind == wire_io::kKindIPv4 || p.kind == wire_io::kKindIPv6) && t >= 0 && t < a.T;
  L.syn = p.proto == kProtoTCP && (fl & kTcpSyn) != 0 && (fl & kTcpAck) == 0;
  L.deny = (int)(L.r & 0xFFu) == kDeny;
  return L;
}

// The source table as phase A's probe reads it: staged in shared memory,
// or global memory through L2.
template <bool kGlobal>
struct Rows {
  const int* cols;
  const uint32_t* keys;
  __device__ __forceinline__ int col(int s, int k) const {
    return kGlobal ? __ldcg(cols + (size_t)s * 8 + k) : cols[(size_t)s * 8 + k];
  }
  __device__ __forceinline__ uint32_t key(int s, int q) const {
    return kGlobal ? __ldcg(keys + (size_t)s * kKeyWords + q) : keys[(size_t)s * kKeyWords + q];
  }
};

// Phase A for lane i: the count-min adds into `cms`, the probe of the rows
// before any write, the bid into `win` and the seeds into `seeds` (shared
// or global; atomics).  Returns the lane's carry: slot << kBitsShift | flag
// bits (kNoLane for no lane), the probe's lastepoch, the verdict, h1.
template <class R>
__device__ __forceinline__ int4 take_lane(const Args& a, const Lane& L, int i, const R& rows,
                                          int* cms, int* win, int* seeds) {
  if (!L.valid) return make_int4(kNoLane, 0, 0, 0);
  if (L.elig) {
    for (int d = 0; d < a.D; ++d) atomicAdd(cms + bucket(a, L.h1, d), 1);
  }
  const uint32_t h2 = (L.h1 >> 16) | 1u;
  int mslot = -1, eslot = -1, lslot = 0, lval = 0;
  for (int w = 0; w < a.ways; ++w) {
    const int c = (int)((L.h1 + (uint32_t)w * h2) & (uint32_t)(a.S - 1));
    const bool occ = rows.col(c, 0) > 0;
    if (mslot < 0 && occ) {
      bool eq = true;
#pragma unroll
      for (int q = 0; q < kKeyWords; ++q) eq = eq && rows.key(c, q) == L.key[q];
      if (eq) mslot = c;
    }
    if (eslot < 0 && !occ) eslot = c;
    const int le = rows.col(c, 5);
    if (w == 0 || le < lval) {  // argmin: the first of ties
      lval = le;
      lslot = c;
    }
  }
  const bool matched = mslot >= 0;
  const int slot = matched ? mslot : (eslot >= 0 ? eslot : lslot);
  const int pre_lastport = rows.col(slot, 4);
  const int pre_lastepoch = rows.col(slot, 5);
  const bool newport = matched && L.dport != pre_lastport;
  const int bits = (L.elig ? kElig : 0) | (matched ? kMatched : 0) | (L.syn ? kSynLane : 0) |
                   (L.deny ? kDenyLane : 0) | (newport ? kNewport : 0);
  if (L.elig) {
    atomicMax(win + slot, 2 * i + (matched ? 1 : 0));
    int* sd = seeds + (size_t)slot * 4;
    atomicAdd(sd, 1);
    if (L.syn) atomicAdd(sd + 1, 1);
    if (L.deny) atomicAdd(sd + 2, 1);
    if (newport) atomicAdd(sd + 3, 1);
  }
  return make_int4(slot << kBitsShift | bits, pre_lastepoch, (int)L.r, (int)L.h1);
}

// Phase A over a run of lanes: round r's lane is lo + r kThreads + tid; the
// first kRegLanes rounds' carries into `c`, the rest into `spill` at
// spill_at(i).  `first` is round 0's lane, loaded ahead.
template <int WW, bool kRes, class R, class SpillAt>
__device__ __forceinline__ void lanes_a(const Args& a, int lo, int end, int rounds,
                                        const Lane& first, const R& rows, int* cms, int* win,
                                        int* seeds, int4 c[kRegLanes], SpillAt spill_at) {
  const int tid = (int)threadIdx.x;
#pragma unroll
  for (int r = 0; r < kRegLanes; ++r) {
    c[r] = make_int4(kNoLane, 0, 0, 0);
    if (r < rounds) {
      const int i = lo + r * kThreads + tid;
      c[r] = take_lane(a, r == 0 ? first : lane_at<WW, kRes>(a, i, end), i, rows, cms, win, seeds);
    }
  }
  for (int r = kRegLanes; r < rounds; ++r) {
    const int i = lo + r * kThreads + tid;
    const int4 x = take_lane(a, lane_at<WW, kRes>(a, i, end), i, rows, cms, win, seeds);
    if (i < end) *spill_at(i) = x;
  }
}

// Slot j's columns 0-3 after the seeds (`bid` the largest eligible lane's 2
// i + matched, -1 none): min((replaced ? 0 : old) + seeds, sat), the add
// wrapping in int32.
__device__ __forceinline__ int4 settle_cols(int4 old, int bid, int4 sd, int sat) {
  const bool repl = bid >= 0 && (bid & 1) == 0;
  const int4 b = repl ? make_int4(0, 0, 0, 0) : old;
  return make_int4(min_sat((int)((uint32_t)b.x + (uint32_t)sd.x), sat),
                   min_sat((int)((uint32_t)b.y + (uint32_t)sd.y), sat),
                   min_sat((int)((uint32_t)b.z + (uint32_t)sd.z), sat),
                   min_sat((int)((uint32_t)b.w + (uint32_t)sd.w), sat));
}

// The model in shared memory (model_words), the feature index clipped.
struct Model {
  const int* fidx;
  const int* fthr;
  const int* b1;
  const int8_t* leaf;
  const int8_t* w1;
  const int8_t* w2;
  int sh0, sh1, b2;
};

__device__ __forceinline__ Model stage_model(const Args& a, int* sm) {
  const int td = a.trees * a.depth, leaves = a.trees << a.depth, H = a.hidden;
  int* fidx = sm;
  int* fthr = fidx + r4(td);
  int* b1 = fthr + r4(td);
  int8_t* leaf = reinterpret_cast<int8_t*>(b1 + r4(H));
  int8_t* w1 = leaf + 4 * r4((leaves + 3) / 4);
  int8_t* w2 = w1 + 16 * H;
  for (int k = threadIdx.x; k < td; k += blockDim.x) {
    const int f = __ldg(a.fidx + k);
    fidx[k] = f < 0 ? 0 : (f > kFeatures - 1 ? kFeatures - 1 : f);
    fthr[k] = __ldg(a.fthr + k);
  }
  for (int k = threadIdx.x; k < leaves; k += blockDim.x) leaf[k] = a.leaf[k];
  for (int k = threadIdx.x; k < kFeatures * H; k += blockDim.x) w1[k] = a.w1[k];
  for (int k = threadIdx.x; k < H; k += blockDim.x) {
    b1[k] = __ldg(a.b1 + k);
    w2[k] = a.w2[k];
  }
  Model m{fidx, fthr, b1, leaf, w1, w2, 0, 0, 0};
  if (H) {
    m.sh0 = __ldg(a.qshift);
    m.sh1 = __ldg(a.qshift + 1);
    m.b2 = __ldg(a.b2);
  }
  return m;
}

// The forest (one leaf a tree) and the int8 head: int32 sums that wrap.
__device__ __forceinline__ int infer(const Args& a, const Model& m, const int feats[kFeatures]) {
  const int L = 1 << a.depth;
  uint32_t score = 0u;
  for (int t = 0; t < a.trees; ++t) {
    int idx = 0;
    for (int d = 0; d < a.depth; ++d)
      idx |= (feats[m.fidx[t * a.depth + d]] >= m.fthr[t * a.depth + d] ? 1 : 0) << d;
    score += (uint32_t)(int)m.leaf[t * L + idx];
  }
  if (a.hidden) {
    int xq[kFeatures];
#pragma unroll
    for (int f = 0; f < kFeatures; ++f) {
      const int v = feats[f] >> m.sh0;
      xq[f] = v < 0 ? 0 : (v > 127 ? 127 : v);
    }
    uint32_t acc = 0u;
    for (int j = 0; j < a.hidden; ++j) {
      uint32_t h = (uint32_t)m.b1[j];
#pragma unroll
      for (int f = 0; f < kFeatures; ++f) h += (uint32_t)(xq[f] * (int)m.w1[f * a.hidden + j]);
      int hq = (int)h >> m.sh1;
      hq = hq < 0 ? 0 : (hq > 127 ? 127 : hq);
      acc += (uint32_t)(hq * (int)m.w2[j]);
    }
    score += acc + (uint32_t)m.b2;
  }
  return (int)score;
}

// Every lane of the warp calls it: the anomalous lanes' adds into column 6
// (`c6` + slot x stride; shared or global), one atomic a warp where they
// share a slot.
__device__ __forceinline__ void add_hits(int* c6, int stride, bool anom, int slot, int lane_id) {
  const unsigned am = __ballot_sync(kFull, anom);
  if (am == 0) return;
  const int lead = __ffs(am) - 1;
  const int s0 = __shfl_sync(kFull, slot, lead);
  if (__all_sync(kFull, !anom || slot == s0)) {
    if (lane_id == lead) atomicAdd(c6 + (size_t)s0 * stride, __popc(am));
  } else if (anom) {
    atomicAdd(c6 + (size_t)slot * stride, 1);
  }
}

// Every lane of the warp calls it: an eligible lane's [1, anom, rewrite]
// and its score's max into row `tc` of `t` (rows of 4; shared or global),
// one lane's atomics where the warp's eligible lanes share a row.
__device__ __forceinline__ void add_tenant(int* t, bool e, int tc, bool anom, bool rewrite, int sc,
                                           int lane_id) {
  const unsigned em = __ballot_sync(kFull, e);
  if (em == 0) return;
  const int lead = __ffs(em) - 1;
  const int r0 = __shfl_sync(kFull, tc, lead);
  if (__all_sync(kFull, !e || tc == r0)) {
    const int na = __popc(__ballot_sync(kFull, e && anom));
    const int nr = __popc(__ballot_sync(kFull, e && rewrite));
    const int mx = __reduce_max_sync(kFull, e ? sc : INT_MIN);
    if (lane_id == lead) {
      int* row = t + (size_t)r0 * 4;
      atomicAdd(row, __popc(em));
      if (na) atomicAdd(row + 1, na);
      if (nr) atomicAdd(row + 2, nr);
      atomicMax(row + 3, mx);
    }
  } else if (e) {
    int* row = t + (size_t)tc * 4;
    atomicAdd(row, 1);
    if (anom) atomicAdd(row + 1, 1);
    if (rewrite) atomicAdd(row + 2, 1);
    atomicMax(row + 3, sc);
  }
}

// Phase C for lane i with carry `c` (every lane of the warp calls it; lane
// i's warp lane is i mod 32).  Plan S (kL false): `rows` the columns as
// phase B wrote them, `cms` clamped.  Plan L: `rows` the columns as they
// were (staged, or global through L2; kRowsL2), settled here from the bid
// and seeds; the count-min cells and bids are global words written in the
// launch, read through L2.  The winner writes its slot's columns 4 and 5
// into `cols`; `c6` + slot x stride the anomaly hits; `tt` the tenant rows.
template <int WW, bool kRes, bool kL, bool kRowsL2>
__device__ __forceinline__ void lane_c(const Args& a, const Model& m, int i, int4 c, int e1,
                                       const int* cms, const int* rows, int* cols,
                                       const int* win, int* c6, int c6_stride, int* tt,
                                       int lane_id) {
  const bool valid = c.x != kNoLane;
  const int slot = valid ? c.x >> kBitsShift : 0;
  const int bits = valid ? c.x & ((1 << kBitsShift) - 1) : 0;
  const bool elig = (bits & kElig) != 0;
  int sc = 0, tc = 0;
  bool anom = false, rewrite = false;
  uint32_t res_out = 0u;
  if (valid) {
    // the fields of the full layouts' first two words, as wire_io::decode
    // reads them (the source words only for a winner's key); the hash came
    // in the carry, so every load below is independent of the others
    const uint32_t* wr = a.wire + (size_t)i * WW;
    const uint32_t w0 = __ldg(wr), w1 = __ldg(wr + 1);
    const int kind = (int)(w0 & 3u), proto = (int)((w0 >> 3) & 0xFFu), dport = (int)(w1 & 0xFFFFu);
    const uint32_t pkt_len = (w1 >> 16) | (((w0 >> 27) & 0x1Fu) << 16);
    const int ten = __ldg(a.tenant + i);
    const int fl = __ldg(a.tflags + i);
    const uint32_t h1 = (uint32_t)c.w;
    const int4* rp = reinterpret_cast<const int4*>(rows + (size_t)slot * 8);
    int4 row = kRowsL2 ? __ldcg(rp) : *rp;
    const int bid = kL ? __ldcg(win + slot) : win[slot];
    if (kL) {
      const int4 sd = bid >= 0 ? __ldcg(reinterpret_cast<const int4*>(a.seeds) + slot)
                               : make_int4(0, 0, 0, 0);
      row = settle_cols(row, bid, sd, a.sat);
    }
    int est = a.sat;
    for (int d = 0; d < a.D; ++d) {
      const int k = bucket(a, h1, d);
      const int v = kL ? __ldcg(cms + k) : cms[k];  // plan L: a raw cell, est starts at sat
      est = v < est ? v : est;
    }
    int delta = kFirstSight;
    if (bits & kMatched) {
      const int dv = (int)((uint32_t)e1 - (uint32_t)c.y);
      delta = dv < 0 ? 0 : (dv > kFirstSight ? kFirstSight : dv);
    }
    const int pkts = row.x, syns = row.y, denies = row.z, newports = row.w;
    const int pk = pkts > 1 ? pkts : 1;
    const uint32_t r = (uint32_t)c.z;
    int feats[kFeatures];
    feats[0] = pkts;
    feats[1] = syns;
    feats[2] = denies;
    feats[3] = newports;
    feats[4] = est;
    feats[5] = delta;
    feats[6] = (bits & kSynLane) ? 1 : 0;
    feats[7] = fl & 0xFF;
    feats[8] = (int)pkt_len;
    feats[9] = kind;
    feats[10] = dport;
    feats[11] = proto;
    feats[12] = floor_div((int)((uint32_t)syns * 256u), pk);
    feats[13] = floor_div((int)((uint32_t)newports * 256u), pk);
    feats[14] = floor_div((int)((uint32_t)denies * 256u), pk);
    feats[15] = (bits & kDenyLane) ? 1 : 0;
    sc = infer(a, m, feats);
    // the policy: never a failsafe cell, never an existing rule deny
    tc = ten < 0 ? 0 : (ten > a.T - 1 ? a.T - 1 : ten);
    anom = elig && sc >= __ldg(a.tparams + tc * 2);
    const bool enf = __ldg(a.tparams + tc * 2 + 1) != 0;
    rewrite = anom && enf && !failsafe_cells::failsafe(proto, dport) && (int)(r & 0xFFu) != kDeny;
    res_out = rewrite ? (uint32_t)kDeny : r;
    // the winner writes its slot's lastport, the epoch and (replaced) its key
    if (elig && bid == 2 * i + ((bits & kMatched) ? 1 : 0)) {
      cols[(size_t)slot * 8 + 4] = dport;
      cols[(size_t)slot * 8 + 5] = e1;
      if (!(bits & kMatched)) {
        const uint4 ip = wire_io::decode<WW>(a.wire, i, nullptr, 1).w;
        const uint32_t key[kKeyWords] = {(uint32_t)ten, ip.x, ip.y, ip.z, ip.w, (uint32_t)kind};
#pragma unroll
        for (int q = 0; q < kKeyWords; ++q) a.skeys[(size_t)slot * kKeyWords + q] = key[q];
      }
    }
  }
  add_hits(c6, c6_stride, anom, slot, lane_id);
  add_tenant(tt, valid && elig, tc, anom, rewrite, sc, lane_id);
  if constexpr (kRes) {
    const uint32_t w16 = valid ? (res_out & 0xFFFFu) : 0u;
    const uint32_t s16 = valid ? sat16(sc) : 0u;
    const uint32_t w_hi = __shfl_down_sync(kFull, w16, 1);
    const uint32_t s_hi = __shfl_down_sync(kFull, s16, 1);
    const unsigned am = __ballot_sync(kFull, anom);
    uint32_t* out = reinterpret_cast<uint32_t*>(a.out);
    if (valid && (i & 1) == 0) {
      const uint32_t word = w16 | (w_hi << 16);
      a.served[i >> 1] = word;
      a.res[i >> 1] = word;
      out[(a.B + 31) / 32 + (i >> 1)] = s16 | (s_hi << 16);
    }
    if (valid && lane_id == 0) out[i >> 5] = am;
  } else if (valid) {
    a.out[i] = sc;
    a.out[a.B + i] = anom ? 1 : 0;
    a.out[2LL * a.B + i] = (int)res_out;
  }
}

// Phase C over a run of lanes, as lanes_a.
template <int WW, bool kRes, bool kL, bool kRowsL2, class SpillAt>
__device__ __forceinline__ void lanes_c(const Args& a, const Model& m, int lo, int end, int rounds,
                                        const int4 c[kRegLanes], SpillAt spill_at, int e1,
                                        const int* cms, const int* rows, int* cols,
                                        const int* win, int* c6, int c6_stride, int* tt) {
  const int tid = (int)threadIdx.x, lane_id = tid & 31;
#pragma unroll
  for (int r = 0; r < kRegLanes; ++r) {
    if (r < rounds)
      lane_c<WW, kRes, kL, kRowsL2>(a, m, lo + r * kThreads + tid, c[r], e1, cms, rows, cols,
                                    win, c6, c6_stride, tt, lane_id);
  }
  for (int r = kRegLanes; r < rounds; ++r) {
    const int i = lo + r * kThreads + tid;
    const int4 x = i < end ? *spill_at(i) : make_int4(kNoLane, 0, 0, 0);
    lane_c<WW, kRes, kL, kRowsL2>(a, m, i, x, e1, cms, rows, cols, win, c6, c6_stride, tt,
                                  lane_id);
  }
}

// n words between global and shared memory, by the block, 16 bytes a
// thread (both pointers 16-byte aligned, n a multiple of 4).
__device__ __forceinline__ void copy_in(int* dst, const int* src, long long n) {
  for (long long q = threadIdx.x; q < n / 4; q += blockDim.x)
    reinterpret_cast<int4*>(dst)[q] = __ldcg(reinterpret_cast<const int4*>(src) + q);
}

__device__ __forceinline__ void copy_out(int* dst, const int* src, long long n) {
  for (long long q = threadIdx.x; q < n / 4; q += blockDim.x)
    reinterpret_cast<int4*>(dst)[q] = reinterpret_cast<const int4*>(src)[q];
}

template <int WW, bool kRes>
__global__ void __launch_bounds__(kThreads, 1) block_kernel(const Args a) {
  extern __shared__ int4 smem[];
  int* sm = reinterpret_cast<int*>(smem);
  const int S = a.S, DW = a.D * a.W, T4 = 4 * a.T;
  const int tid = (int)threadIdx.x;
  const int rounds = (a.B + kThreads - 1) / kThreads;
  const int base = kRegLanes * kThreads;
  int* s_cols = sm + model_words(a.trees, a.depth, a.hidden);
  uint32_t* s_keys = reinterpret_cast<uint32_t*>(s_cols + 8 * S);
  int* s_cms = reinterpret_cast<int*>(s_keys + kKeyWords * S);
  int* s_tstat = s_cms + DW;
  int* s_win = s_tstat + T4;
  int* s_seed = s_win + S;
  int4* s_spill = reinterpret_cast<int4*>(s_seed + 4 * S);
  auto spill_at = [&](int i) { return s_spill + (i - base); };

  // the first lane's operands and e1 load while the state stages
  const int e1 = (int)((uint32_t)__ldcg(a.epoch) + 1u);
  const Lane first = lane_at<WW, kRes>(a, tid, a.B);
  const Model m = stage_model(a, sm);
  copy_in(s_cols, a.scols, 8LL * S);
  copy_in(reinterpret_cast<int*>(s_keys), reinterpret_cast<const int*>(a.skeys),
          (long long)kKeyWords * S);
  copy_in(s_cms, a.cms, DW);
  copy_in(s_tstat, a.tstat, T4);
  for (int k = tid; k < S; k += kThreads) {
    s_win[k] = -1;
    reinterpret_cast<int4*>(s_seed)[k] = make_int4(0, 0, 0, 0);
  }
  __syncthreads();

  // A. the adds, the probes on the rows before any write, the bids and seeds
  int4 c[kRegLanes];
  lanes_a<WW, kRes>(a, 0, a.B, rounds, first, Rows<false>{s_cols, s_keys}, s_cms, s_win, s_seed,
                    c, spill_at);
  __syncthreads();

  // B. each slot's columns 0-3 (and 6-7 replaced), the count-min clamp
  for (int j = tid; j < S; j += kThreads) {
    int4* row = reinterpret_cast<int4*>(s_cols + 8 * j);
    const int bid = s_win[j];
    row[0] = settle_cols(row[0], bid, reinterpret_cast<const int4*>(s_seed)[j], a.sat);
    if (bid >= 0 && (bid & 1) == 0) {
      s_cols[8 * j + 6] = 0;
      s_cols[8 * j + 7] = 0;
    }
  }
  for (int k = tid; k < DW; k += kThreads) s_cms[k] = min_sat(s_cms[k], a.sat);
  __syncthreads();

  // C. features, inference, policy, the winners' writes, the adds
  lanes_c<WW, kRes, false, false>(a, m, 0, a.B, rounds, c, spill_at, e1, s_cms, s_cols, s_cols,
                                  s_win, s_cols + 6, 8, s_tstat);
  __syncthreads();

  // D. write back (column 6 clamped), the epoch
  for (int q = tid; q < 2 * S; q += kThreads) {
    int4 v = reinterpret_cast<const int4*>(s_cols)[q];
    if (q & 1) v.z = min_sat(v.z, a.sat);
    reinterpret_cast<int4*>(a.scols)[q] = v;
  }
  copy_out(a.cms, s_cms, DW);
  copy_out(a.tstat, s_tstat, T4);
  if (tid == 0) a.epoch[0] = e1;
}

template <int WW, bool kRes, bool kStaged>
__global__ void __launch_bounds__(kThreads, 1) grid_kernel(const Args a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ int4 smem[];
  int* sm = reinterpret_cast<int*>(smem);
  const int S = a.S, DW = a.D * a.W, T4 = 4 * a.T;
  const int tid = (int)threadIdx.x;
  // this block's lanes: [lo, end), round r's lane lo + r kThreads + tid
  const int lo = (int)min((long long)blockIdx.x * a.per, (long long)a.B);
  const int end = min(a.B, lo + a.per);
  const int rounds = (a.per + kThreads - 1) / kThreads;
  // staged: the rows (columns, keys), then the tallies
  int* s_cols = sm + model_words(a.trees, a.depth, a.hidden);
  uint32_t* s_keys = reinterpret_cast<uint32_t*>(s_cols + 8 * S);
  int* u = reinterpret_cast<int*>(s_keys + kKeyWords * S);
  auto spill_at = [&](int i) { return a.spill + i; };

  const int e1 = (int)((uint32_t)__ldcg(a.epoch) + 1u);
  const Lane first = lane_at<WW, kRes>(a, lo + tid, end);
  const Model m = stage_model(a, sm);

  // A. the adds (each block's tallies), the probes, the bids and seeds
  int4 c[kRegLanes];
  if constexpr (kStaged) {
    int* t_cms = u;
    int* t_win = t_cms + DW;
    int* t_seed = t_win + S;
    for (int q = tid; q < DW / 4; q += kThreads)
      reinterpret_cast<int4*>(t_cms)[q] = make_int4(0, 0, 0, 0);
    for (int k = tid; k < S; k += kThreads) {
      t_win[k] = -1;
      reinterpret_cast<int4*>(t_seed)[k] = make_int4(0, 0, 0, 0);
    }
    copy_in(s_cols, a.scols, 8LL * S);
    copy_in(reinterpret_cast<int*>(s_keys), reinterpret_cast<const int*>(a.skeys),
            (long long)kKeyWords * S);
    __syncthreads();
    lanes_a<WW, kRes>(a, lo, end, rounds, first, Rows<false>{s_cols, s_keys}, t_cms, t_win,
                      t_seed, c, spill_at);
    __syncthreads();
    // the block's tallies, one global atomic a non-zero cell and bid slot
    for (int k = tid; k < DW; k += kThreads) {
      const int v = t_cms[k];
      if (v != 0) atomicAdd(a.cms + k, v);
    }
    for (int j = tid; j < S; j += kThreads) {
      const int bid = t_win[j];
      if (bid < 0) continue;
      atomicMax(a.winner + j, bid);
      const int4 sd = reinterpret_cast<const int4*>(t_seed)[j];
      int* g = a.seeds + 4 * (size_t)j;
      atomicAdd(g, sd.x);
      if (sd.y) atomicAdd(g + 1, sd.y);
      if (sd.z) atomicAdd(g + 2, sd.z);
      if (sd.w) atomicAdd(g + 3, sd.w);
    }
  } else {
    __syncthreads();
    lanes_a<WW, kRes>(a, lo, end, rounds, first, Rows<true>{a.scols, a.skeys}, a.cms, a.winner,
                      a.seeds, c, spill_at);
  }
  grid.sync();

  // C. the count-min clamp (this block's slice), then per lane: its slot's
  // columns 0-3 settled, the features, inference, policy, the winners'
  // writes, the adds (each block's tallies where they fit)
  {  // on the threads with no lane in the first round where there are any
    const int span = (DW + (int)gridDim.x - 1) / (int)gridDim.x;
    const int k1 = min(DW, ((int)blockIdx.x + 1) * span);
    const int busy = min(kThreads, end - lo), t0 = busy < kThreads ? busy : 0;
    for (int k = (int)blockIdx.x * span + tid - t0; tid >= t0 && k < k1; k += kThreads - t0)
      if (__ldcg(a.cms + k) > a.sat) a.cms[k] = a.sat;
  }
  if constexpr (kStaged) {
    int* t_hits = u;
    int* t_tt = u + S;
    for (int j = tid; j < S; j += kThreads) t_hits[j] = 0;
    for (int k = tid; k < T4; k += kThreads) t_tt[k] = (k & 3) == 3 ? INT_MIN : 0;
    __syncthreads();
    lanes_c<WW, kRes, true, false>(a, m, lo, end, rounds, c, spill_at, e1, a.cms, s_cols,
                                   a.scols, a.winner, t_hits, 1, t_tt);
    __syncthreads();
    for (int j = tid; j < S; j += kThreads) {
      const int v = t_hits[j];
      if (v != 0) atomicAdd(a.hits + j, v);
    }
    for (int t = tid; t < a.T; t += kThreads) {  // a tenant with no scored lane here adds nothing
      const int* st = t_tt + 4 * t;
      if (st[0] == 0) continue;
      int* g = a.tstat + 4 * (size_t)t;
      atomicAdd(g, st[0]);
      if (st[1]) atomicAdd(g + 1, st[1]);
      if (st[2]) atomicAdd(g + 2, st[2]);
      atomicMax(g + 3, st[3]);
    }
  } else {
    lanes_c<WW, kRes, true, true>(a, m, lo, end, rounds, c, spill_at, e1, a.cms, a.scols,
                                  a.scols, a.winner, a.hits, 1, a.tstat);
  }

  // D. the last block done writes each slot's columns 0-3, 6 and 7, puts
  // the scratch back and advances the epoch
  __syncthreads();
  int last = 0;
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(a.done, 1) == (int)gridDim.x - 1;
  }
  if (__syncthreads_or(last)) {
    __threadfence();
#pragma unroll 4
    for (int j = tid; j < S; j += kThreads) {
      int4* rp = reinterpret_cast<int4*>(a.scols) + 2 * (size_t)j;
      const int bid = __ldcg(a.winner + j);
      const int4 old = __ldcg(rp);
      const int4 hi = __ldcg(rp + 1);  // columns 4-7
      const int4 sd =
          bid >= 0 ? __ldcg(reinterpret_cast<const int4*>(a.seeds) + j) : make_int4(0, 0, 0, 0);
      const int h = bid >= 0 ? __ldcg(a.hits + j) : 0;
      const bool repl = bid >= 0 && (bid & 1) == 0;
      const int4 v = settle_cols(old, bid, sd, a.sat);
      if (v.x != old.x || v.y != old.y || v.z != old.z || v.w != old.w) *rp = v;
      const int c6 = min_sat((int)((uint32_t)(repl ? 0 : hi.z) + (uint32_t)h), a.sat);
      if (c6 != hi.z) a.scols[8 * (size_t)j + 6] = c6;
      if (repl && hi.w != 0) a.scols[8 * (size_t)j + 7] = 0;
      if (bid >= 0) {
        a.winner[j] = -1;
        reinterpret_cast<int4*>(a.seeds)[j] = make_int4(0, 0, 0, 0);
        a.hits[j] = 0;
      }
    }
    if (tid == 0) {
      a.epoch[0] = e1;
      *a.done = 0;
    }
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
// infw_score_prepare before its first launch): the SM count, the opt-in
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

template <int WW, bool kRes>
cudaError_t launch_block(const Args& a, const Device& d, cudaStream_t stream) {
  const long long bytes =
      4 * block_words(a.B, a.S, a.D, a.W, a.T, a.trees, a.depth, a.hidden);
  if (bytes > d.smem_optin) return cudaErrorInvalidValue;
  block_kernel<WW, kRes><<<1, kThreads, (size_t)bytes, stream>>>(a);
  return cudaSuccess;
}

// Plan L's grid: one block a kGridLanes lanes (and, unstaged, at least one a
// 16384 count-min cells of the clamp), at most the co-resident blocks, at
// most max_grid > 0; each block takes ceil(B / grid) lanes rounded up to 32.
template <int WW, bool kRes, bool kStaged>
cudaError_t launch_grid(Args a, Device& d, int slot, int bytes, int max_grid,
                        cudaStream_t stream) {
  const void* kernel = (const void*)grid_kernel<WW, kRes, kStaged>;
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
  a.per = (int)((((long long)a.B + grid - 1) / grid + 31) / 32 * 32);
  if (a.per > kRegLanes * kThreads && a.spill == nullptr) return cudaErrorInvalidValue;
  void* args[] = {(void*)&a};
  return cudaLaunchCooperativeKernel(kernel, dim3((unsigned)grid), dim3(kThreads), args,
                                     (size_t)bytes, stream);
}

template <int WW, bool kRes>
cudaError_t launch(Args& a, int plan, int max_grid, cudaStream_t stream) {
  int device = 0;
  cudaError_t err = prepare(&device);
  if (err != cudaSuccess) return err;
  Device& d = devices[device];
  if (plan == kPlanBlock)
    return max_grid > 0 ? cudaErrorInvalidValue : launch_block<WW, kRes>(a, d, stream);
  if (plan != kPlanGrid) return cudaErrorInvalidValue;
  const long long bytes = 4 * grid_words(a.S, a.D, a.W, a.T, a.trees, a.depth, a.hidden);
  const bool staged = bytes <= d.smem_optin;
  const int b = staged ? (int)bytes : 4 * (int)model_words(a.trees, a.depth, a.hidden);
  const int slot = 4 * (WW == 7) + 2 * kRes + staged;
  return staged ? launch_grid<WW, kRes, true>(a, d, slot, b, max_grid, stream)
                : launch_grid<WW, kRes, false>(a, d, slot, b, max_grid, stream);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

template <bool kRes>
int dispatch(const void* wire, const void* tenant, const void* tflags, void* res, void* served,
             const void* hit, void* skeys, void* scols, void* cms, void* tstat, void* epoch,
             const void* fidx, const void* fthr, const void* leaf, const void* w1, const void* b1,
             const void* w2, const void* b2, const void* qshift, const void* tparams,
             void* scratch, void* spill, void* out, int B, int width, int S, int ways, int D, int W,
             int T, int trees, int depth, int hidden, int sat, int max_grid, int plan,
             cudaStream_t stream) {
  Args a{};
  a.wire = (const uint32_t*)wire;
  a.tenant = (const int*)tenant;
  a.tflags = (const int*)tflags;
  a.res = (uint32_t*)res;
  a.served = (uint32_t*)served;
  a.hit = (const uint32_t*)hit;
  a.skeys = (uint32_t*)skeys;
  a.scols = (int*)scols;
  a.cms = (int*)cms;
  a.tstat = (int*)tstat;
  a.epoch = (int*)epoch;
  a.fidx = (const int*)fidx;
  a.fthr = (const int*)fthr;
  a.leaf = (const int8_t*)leaf;
  a.w1 = (const int8_t*)w1;
  a.b1 = (const int*)b1;
  a.w2 = (const int8_t*)w2;
  a.b2 = (const int*)b2;
  a.qshift = (const int*)qshift;
  a.tparams = (const int*)tparams;
  a.winner = (int*)scratch;
  a.seeds = (int*)scratch + S;
  a.hits = (int*)scratch + 5LL * S;
  a.done = (int*)scratch + 6LL * S;
  a.spill = (int4*)spill;
  a.out = (int*)out;
  a.B = B;
  a.S = S;
  a.ways = ways;
  a.D = D;
  a.W = W;
  a.T = T;
  a.trees = trees;
  a.depth = depth;
  a.hidden = hidden;
  a.sat = sat;
  cudaError_t err;
  if (B < 1 || B >= (1 << 30) || S < 8 || S > (1 << 25) || (S & (S - 1)) || W < 8 ||
      (W & (W - 1)) || D < 1 || D > 8 || ways < 1 || ways > 8 || T < 1 || sat < 1 || trees < 1 ||
      trees > 16 || depth < 1 || depth > 6 || hidden < 0 || hidden > 64 || !aligned16(skeys) ||
      !aligned16(scols) || !aligned16(cms) || !aligned16(tstat) || !aligned16(scratch) ||
      !aligned16(spill)) {
    err = cudaErrorInvalidValue;
  } else if (width == 4) {
    err = launch<4, kRes>(a, plan, max_grid, stream);
  } else if (width == 7) {
    err = launch<7, kRes>(a, plan, max_grid, stream);
  } else {
    err = cudaErrorInvalidValue;
  }
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace

#define SCORE_PARAMS                                                                          \
  const void *wire, const void *tenant, const void *tflags, void *res, void *served,          \
      const void *hit, void *skeys, void *scols, void *cms, void *tstat, void *epoch,         \
      const void *fidx, const void *fthr, const void *leaf, const void *w1, const void *b1,   \
      const void *w2, const void *b2, const void *qshift, const void *tparams, void *scratch, \
      void *spill, void *out, int B, int width, int S, int ways, int D, int W, int T,         \
      int trees, int depth, int hidden, int sat, int max_grid, int plan, cudaStream_t stream
#define SCORE_ARGS                                                                           \
  wire, tenant, tflags, res, served, hit, skeys, scols, cms, tstat, epoch, fidx, fthr, leaf, \
      w1, b1, w2, b2, qshift, tparams, scratch, spill, out, B, width, S, ways, D, W, T,      \
      trees, depth, hidden, sat, max_grid, plan, stream

// Once per device, before the first launch and outside any graph capture:
// raises every K10 kernel's dynamic shared-memory cap to the card's opt-in
// limit and returns that limit in bytes (the host's plan choice reads it),
// or minus a CUDA error.
extern "C" int infw_score_prepare(int reserved) {
  if (reserved != 0) return -(int)cudaErrorInvalidValue;
  int device = 0;
  const cudaError_t err = prepare(&device);
  if (err != cudaSuccess) return -(int)err;
  return devices[device].smem_optin;
}

// K10, classic entry: one launch on `stream` (B >= 1): plan 1 (S) one
// block, plan 0 (L) the cooperative grid; returns its error, else
// cudaGetLastError().  Allocates nothing.  `scratch` (6 S + 4 words,
// 16-byte aligned: S bids, 4 S seeds, S hits, a count) is -1 / 0 on entry and
// again when the launch ends (plan S does not touch it); `spill` (16 bytes
// a lane, or null) is plan L's carry where a block's lanes outrun its
// registers; max_grid > 0 caps plan L's grid (tests), 0 takes what fits.
extern "C" int infw_score_update(SCORE_PARAMS) { return dispatch<false>(SCORE_ARGS); }

// K10, resident entry: the verdicts merged from the probe's words, the hit
// bitmap and the stateless words, the policy's verdicts written into both
// word vectors, `out` the anomaly bitmap then the int16 scores.
extern "C" int infw_score_update_resident(SCORE_PARAMS) { return dispatch<true>(SCORE_ARGS); }
