// Kernel K10: the anomaly-scoring tier's update (the JAX package's
// infw/kernels/mxu_score.py _score_update_core, an XLA program there) as
// one C call of five launches on one stream.  Bit for bit the same as
// kernels/mxu_score.py score_update_plain:
//
//   reset_kernel   the per-slot scratch: winner -1, seeds 0;
//   lanes_a_kernel per lane: key [tenant, ip0-3, kind & 3] and its FNV-1a
//                  hashes; an eligible lane (IPv4 / IPv6, tenant in
//                  [0, T)) adds 1 to its D count-min cells (int32 atomics,
//                  which wrap as XLA's scatter-add does); the probe of the
//                  source table as every write leaves it untouched until
//                  the next launch (the first occupied way holding the
//                  key, else the first empty way, else the first way of
//                  least lastepoch), with the row's lastport and lastepoch;
//                  an eligible lane bids for its slot (atomicMax of the
//                  lane index: the largest lane wins) and adds its seeds
//                  [1, pure SYN, rule deny, new port];
//   slots_kernel   per slot: columns 0-3 become min((replaced ? 0 : old) +
//                  seeds, sat) on every slot, a bid slot takes the winner's
//                  dst_port and epoch + 1, a replaced slot (the winner did
//                  not match) the winner's key and zeroes in columns 6, 7;
//                  and per count-min cell the clamp at sat;
//   lanes_b_kernel per lane: the 16 features from the rows as written
//                  (the estimate from the clamped count-min cells, the
//                  epoch delta from the probe's lastepoch), the forest (one
//                  leaf gathered per tree) and the MLP head (w1 in shared
//                  memory), the policy, the anomaly adds into column 6 and
//                  the tenant counters (tallied per block in shared memory
//                  for up to 64 tenants, then one global atomic a cell:
//                  every lane of a tenant hits the same row, and same-address
//                  global atomics serialize; sums wrap as XLA's do);
//   finish_kernel  per slot the clamp of column 6, the epoch advanced, and
//                  on the resident entry the packed words: the verdicts
//                  into the probe's and the stateless res16 words, the
//                  anomaly bitmap and the int16-saturated scores.
//
// Each launch reads what the one before wrote only after it has finished,
// so the three snapshots of the reference (the probe on the rows before
// any write, the estimate after every lane's add, the features after the
// per-slot writes) hold without a grid barrier.  Nothing syncs with the
// host, so a CUDA graph captures the call.
//
// Entries: infw_score_update (classic: `res` the (B,) u32 verdicts, `out`
// [score, anom, res'] x B) and infw_score_update_resident (`res` the
// stateless res16 words, `served` the probe's res16 words, `hit` its
// bitmap; the lane's verdict is hit ? served : res; `out` the anomaly
// bitmap then the int16 scores).
#include <climits>

#include <cuda_runtime.h>
#include <stdint.h>

#include "wire_io.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 2048;
constexpr int kFeatures = 16;
constexpr int kFirstSight = 65535;
constexpr int kProtoTCP = 6;
constexpr int kProtoUDP = 17;
constexpr int kTcpSyn = 0x02;
constexpr int kTcpAck = 0x10;
constexpr int kDeny = 1;
constexpr int kMaxTrees = 16;
constexpr int kMaxDepth = 6;
constexpr int kMaxLeaves = kMaxTrees << kMaxDepth;
constexpr int kMaxHidden = 64;
// tenants whose window counters a block tallies in shared memory before one
// global atomic a cell (more tenants: one global atomic a lane and cell)
constexpr int kBlockTenants = 64;
// lane flag bits
constexpr int kElig = 1, kMatched = 2, kSynLane = 4, kDenyLane = 8, kNewport = 16;

// The failsafe cells (infw_torch/failsaferules.py; a CPU test holds these
// equal to kernels/mxu_score.py FAILSAFE_TCP / FAILSAFE_UDP).
__constant__ int kFailsafeTcp[] = {22, 2379, 2380, 6443, 10250, 10257, 10259};
__constant__ int kFailsafeUdp[] = {68};

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
  int* winner;  // slot scratch: S words
  int* seeds;   // slot scratch: 4 S words
  int* lane_slot;
  int* lane_bits;
  int* lane_val;  // the probe's lastepoch, then the score
  int* lane_out;  // resident: res' & 0xFFFF | anom << 16
  int* out;
  int B, width, S, ways, D, W, T, trees, depth, hidden, sat;
  int resident;
};

__device__ __forceinline__ wire_io::Packet lane_packet(const Args& a, long long i) {
  return a.width == 7 ? wire_io::decode<7>(a.wire, i, nullptr, 1)
                      : wire_io::decode<4>(a.wire, i, nullptr, 1);
}

__device__ __forceinline__ void lane_key(const Args& a, long long i, const wire_io::Packet& p,
                                         uint32_t key[6]) {
  key[0] = (uint32_t)a.tenant[i];
  key[1] = p.w.x;
  key[2] = p.w.y;
  key[3] = p.w.z;
  key[4] = p.w.w;
  key[5] = (uint32_t)p.kind & 3u;
}

__device__ __forceinline__ uint32_t fnv(const uint32_t key[6]) {
  uint32_t h = 0x811C9DC5u;
#pragma unroll
  for (int w = 0; w < 6; ++w) h = (h ^ key[w]) * 0x01000193u;
  return h;
}

// The lane's verdict: the classic entry's u32, or the resident merge.
__device__ __forceinline__ uint32_t lane_res(const Args& a, long long i) {
  if (!a.resident) return a.res[i];
  const bool hit = (a.hit[i >> 5] >> (i & 31)) & 1u;
  const uint32_t w = hit ? a.served[i >> 1] : a.res[i >> 1];
  return (w >> ((uint32_t)(i & 1) * 16u)) & 0xFFFFu;
}

__device__ __forceinline__ int min_sat(int v, int sat) { return v < sat ? v : sat; }

// XLA's floor division of an int32 by a positive int32.
__device__ __forceinline__ int floor_div(int x, int d) {
  int q = x / d;
  if ((x % d) != 0 && x < 0) --q;
  return q;
}

__device__ __forceinline__ bool failsafe(int proto, int dport) {
  if (proto == kProtoTCP) {
#pragma unroll
    for (int k = 0; k < (int)(sizeof(kFailsafeTcp) / sizeof(int)); ++k)
      if (dport == kFailsafeTcp[k]) return true;
  } else if (proto == kProtoUDP) {
#pragma unroll
    for (int k = 0; k < (int)(sizeof(kFailsafeUdp) / sizeof(int)); ++k)
      if (dport == kFailsafeUdp[k]) return true;
  }
  return false;
}

__global__ void reset_kernel(Args a) {
  for (long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x; s < a.S;
       s += (long long)gridDim.x * blockDim.x) {
    a.winner[s] = -1;
    reinterpret_cast<int4*>(a.seeds)[s] = make_int4(0, 0, 0, 0);
  }
}

__global__ void lanes_a_kernel(Args a) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < a.B;
       i += (long long)gridDim.x * blockDim.x) {
    const wire_io::Packet p = lane_packet(a, i);
    uint32_t key[6];
    lane_key(a, i, p, key);
    const uint32_t h1 = fnv(key);
    const uint32_t h2 = (h1 >> 16) | 1u;
    const int ten = a.tenant[i];
    const bool elig = (p.kind == wire_io::kKindIPv4 || p.kind == wire_io::kKindIPv6) &&
                      ten >= 0 && ten < a.T;
    const uint32_t r = lane_res(a, i);
    if (elig) {
      for (int d = 0; d < a.D; ++d) {
        const uint32_t col = (h1 + (uint32_t)d * h2) & (uint32_t)(a.W - 1);
        atomicAdd(&a.cms[d * a.W + (int)col], 1);
      }
    }
    int mslot = -1, eslot = -1, lslot = 0, lval = 0;
    for (int w = 0; w < a.ways; ++w) {
      const int c = (int)((h1 + (uint32_t)w * h2) & (uint32_t)(a.S - 1));
      const int* row = a.scols + (size_t)c * 8;
      const bool occ = row[0] > 0;
      if (mslot < 0 && occ) {
        const uint32_t* k = a.skeys + (size_t)c * 6;
        bool eq = true;
#pragma unroll
        for (int q = 0; q < 6; ++q) eq = eq && k[q] == key[q];
        if (eq) mslot = c;
      }
      if (eslot < 0 && !occ) eslot = c;
      const int le = row[5];
      if (w == 0 || le < lval) {
        lval = le;
        lslot = c;
      }
    }
    const bool matched = mslot >= 0;
    const int slot = matched ? mslot : (eslot >= 0 ? eslot : lslot);
    const int pre_lastport = a.scols[(size_t)slot * 8 + 4];
    const int pre_lastepoch = a.scols[(size_t)slot * 8 + 5];
    const int fl = a.tflags[i];
    const bool syn = p.proto == kProtoTCP && (fl & kTcpSyn) != 0 && (fl & kTcpAck) == 0;
    const bool deny = (int)(r & 0xFFu) == kDeny;
    const bool newport = matched && p.dport != pre_lastport;
    a.lane_slot[i] = slot;
    a.lane_bits[i] = (elig ? kElig : 0) | (matched ? kMatched : 0) | (syn ? kSynLane : 0) |
                     (deny ? kDenyLane : 0) | (newport ? kNewport : 0);
    a.lane_val[i] = pre_lastepoch;
    if (elig) {
      atomicMax(&a.winner[slot], (int)i);
      int* sd = a.seeds + (size_t)slot * 4;
      atomicAdd(sd, 1);
      if (syn) atomicAdd(sd + 1, 1);
      if (deny) atomicAdd(sd + 2, 1);
      if (newport) atomicAdd(sd + 3, 1);
    }
  }
}

__global__ void slots_kernel(Args a) {
  const int e1 = (int)((uint32_t)a.epoch[0] + 1u);
  const long long cells = (long long)a.D * a.W;
  const long long n = cells > a.S ? cells : a.S;
  for (long long j = blockIdx.x * (long long)blockDim.x + threadIdx.x; j < n;
       j += (long long)gridDim.x * blockDim.x) {
    if (j < a.S) {
      int* row = a.scols + (size_t)j * 8;
      const int w = a.winner[j];
      const bool repl = w >= 0 && (a.lane_bits[w] & kMatched) == 0;
      const int4 sd = reinterpret_cast<const int4*>(a.seeds)[j];
      const int add[4] = {sd.x, sd.y, sd.z, sd.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        row[k] = min_sat((int)((uint32_t)(repl ? 0 : row[k]) + (uint32_t)add[k]), a.sat);
      if (w >= 0) {
        const wire_io::Packet p = lane_packet(a, w);
        row[4] = p.dport;
        row[5] = e1;
        if (repl) {
          row[6] = 0;
          row[7] = 0;
          uint32_t key[6];
          lane_key(a, w, p, key);
#pragma unroll
          for (int q = 0; q < 6; ++q) a.skeys[(size_t)j * 6 + q] = key[q];
        }
      }
    }
    if (j < cells) a.cms[j] = min_sat(a.cms[j], a.sat);
  }
}

__global__ void lanes_b_kernel(Args a) {
  __shared__ int8_t s_leaf[kMaxLeaves];
  __shared__ int8_t s_w1[kFeatures * kMaxHidden];
  __shared__ int s_fidx[kMaxTrees * kMaxDepth];
  __shared__ int s_fthr[kMaxTrees * kMaxDepth];
  __shared__ int s_b1[kMaxHidden];
  __shared__ int8_t s_w2[kMaxHidden];
  __shared__ int s_tstat[kBlockTenants * 4];
  const bool tally = a.T <= kBlockTenants;
  const int L = 1 << a.depth;
  const int TD = a.trees * a.depth;
  for (int k = threadIdx.x; k < a.trees * L; k += blockDim.x) s_leaf[k] = a.leaf[k];
  for (int k = threadIdx.x; k < kFeatures * a.hidden; k += blockDim.x) s_w1[k] = a.w1[k];
  for (int k = threadIdx.x; k < TD; k += blockDim.x) {
    const int f = a.fidx[k];
    s_fidx[k] = f < 0 ? 0 : (f > kFeatures - 1 ? kFeatures - 1 : f);
    s_fthr[k] = a.fthr[k];
  }
  for (int k = threadIdx.x; k < a.hidden; k += blockDim.x) {
    s_b1[k] = a.b1[k];
    s_w2[k] = a.w2[k];
  }
  for (int k = threadIdx.x; tally && k < a.T * 4; k += blockDim.x)
    s_tstat[k] = (k & 3) == 3 ? INT_MIN : 0;
  __syncthreads();
  const int e1 = (int)((uint32_t)a.epoch[0] + 1u);
  const int sh0 = a.hidden ? a.qshift[0] : 0;
  const int sh1 = a.hidden ? a.qshift[1] : 0;
  const int b2 = a.hidden ? a.b2[0] : 0;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < a.B;
       i += (long long)gridDim.x * blockDim.x) {
    const wire_io::Packet p = lane_packet(a, i);
    const int slot = a.lane_slot[i];
    const int bits = a.lane_bits[i];
    const int* row = a.scols + (size_t)slot * 8;
    const int pkts = row[0], syns = row[1], denies = row[2], newports = row[3];
    uint32_t key[6];
    lane_key(a, i, p, key);
    const uint32_t h1 = fnv(key);
    const uint32_t h2 = (h1 >> 16) | 1u;
    int est = a.sat;
    for (int d = 0; d < a.D; ++d) {
      const uint32_t col = (h1 + (uint32_t)d * h2) & (uint32_t)(a.W - 1);
      const int v = a.cms[d * a.W + (int)col];
      est = v < est ? v : est;
    }
    int delta = kFirstSight;
    if (bits & kMatched) {
      const int dv = (int)((uint32_t)e1 - (uint32_t)a.lane_val[i]);
      delta = dv < 0 ? 0 : (dv > kFirstSight ? kFirstSight : dv);
    }
    const int pk = pkts > 1 ? pkts : 1;
    const uint32_t r = lane_res(a, i);
    int feats[kFeatures];
    feats[0] = pkts;
    feats[1] = syns;
    feats[2] = denies;
    feats[3] = newports;
    feats[4] = est;
    feats[5] = delta;
    feats[6] = (bits & kSynLane) ? 1 : 0;
    feats[7] = a.tflags[i] & 0xFF;
    feats[8] = (int)p.pkt_len;
    feats[9] = p.kind;
    feats[10] = p.dport;
    feats[11] = p.proto;
    feats[12] = floor_div((int)((uint32_t)syns * 256u), pk);
    feats[13] = floor_div((int)((uint32_t)newports * 256u), pk);
    feats[14] = floor_div((int)((uint32_t)denies * 256u), pk);
    feats[15] = (bits & kDenyLane) ? 1 : 0;
    // the forest: one leaf per tree
    uint32_t score = 0u;
    for (int t = 0; t < a.trees; ++t) {
      int idx = 0;
      for (int d = 0; d < a.depth; ++d)
        idx |= (feats[s_fidx[t * a.depth + d]] >= s_fthr[t * a.depth + d] ? 1 : 0) << d;
      score += (uint32_t)(int)s_leaf[t * L + idx];
    }
    // the MLP head: int8 activations, int32 sums that wrap
    if (a.hidden) {
      int xq[kFeatures];
#pragma unroll
      for (int f = 0; f < kFeatures; ++f) {
        const int v = feats[f] >> sh0;
        xq[f] = v < 0 ? 0 : (v > 127 ? 127 : v);
      }
      uint32_t acc = 0u;
      for (int j = 0; j < a.hidden; ++j) {
        uint32_t h = (uint32_t)s_b1[j];
#pragma unroll
        for (int f = 0; f < kFeatures; ++f)
          h += (uint32_t)(xq[f] * (int)s_w1[f * a.hidden + j]);
        int hq = (int)h >> sh1;
        hq = hq < 0 ? 0 : (hq > 127 ? 127 : hq);
        acc += (uint32_t)(hq * (int)s_w2[j]);
      }
      score += acc + (uint32_t)b2;
    }
    const int sc = (int)score;
    // the policy
    const int ten = a.tenant[i];
    const int tc = ten < 0 ? 0 : (ten > a.T - 1 ? a.T - 1 : ten);
    const bool elig = bits & kElig;
    const bool anom = elig && sc >= a.tparams[tc * 2];
    const bool enf = a.tparams[tc * 2 + 1] != 0;
    const bool rewrite = anom && enf && !failsafe(p.proto, p.dport) && (int)(r & 0xFFu) != kDeny;
    const uint32_t res_out = rewrite ? (uint32_t)kDeny : r;
    if (anom) atomicAdd(&a.scols[(size_t)slot * 8 + 6], 1);
    if (elig) {
      int* ts = tally ? s_tstat + tc * 4 : a.tstat + tc * 4;
      atomicAdd(ts, 1);
      if (anom) atomicAdd(ts + 1, 1);
      if (rewrite) atomicAdd(ts + 2, 1);
      atomicMax(ts + 3, sc);
    }
    if (a.resident) {
      a.lane_val[i] = sc;
      a.lane_out[i] = (int)(res_out & 0xFFFFu) | (anom ? 0x10000 : 0);
    } else {
      a.out[i] = sc;
      a.out[a.B + i] = anom ? 1 : 0;
      a.out[2LL * a.B + i] = (int)res_out;
    }
  }
  if (!tally) return;
  __syncthreads();
  // the block's tallies: a tenant with no scored lane here adds nothing
  for (int t = threadIdx.x; t < a.T; t += blockDim.x) {
    const int* st = s_tstat + t * 4;
    if (st[0] == 0) continue;
    int* ts = a.tstat + t * 4;
    atomicAdd(ts, st[0]);
    if (st[1]) atomicAdd(ts + 1, st[1]);
    if (st[2]) atomicAdd(ts + 2, st[2]);
    atomicMax(ts + 3, st[3]);
  }
}

__device__ __forceinline__ uint32_t sat16(int v) {
  return (uint32_t)(v < -32768 ? -32768 : (v > 32767 ? 32767 : v)) & 0xFFFFu;
}

__global__ void finish_kernel(Args a) {
  const long long nw = (a.B + 1) / 2, nh = (a.B + 31) / 32;
  long long n = a.S;
  if (a.resident) n = nw > n ? nw : n;
  const long long start = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (start == 0) a.epoch[0] = (int)((uint32_t)a.epoch[0] + 1u);
  for (long long j = start; j < n; j += (long long)gridDim.x * blockDim.x) {
    if (j < a.S) {
      int* c6 = a.scols + (size_t)j * 8 + 6;
      *c6 = min_sat(*c6, a.sat);
    }
    if (!a.resident) continue;
    if (j < nw) {
      const long long lo = 2 * j, hi = 2 * j + 1;
      uint32_t word = (uint32_t)a.lane_out[lo] & 0xFFFFu;
      uint32_t s16 = sat16(a.lane_val[lo]);
      if (hi < a.B) {
        word |= ((uint32_t)a.lane_out[hi] & 0xFFFFu) << 16;
        s16 |= sat16(a.lane_val[hi]) << 16;
      }
      a.served[j] = word;
      a.res[j] = word;
      reinterpret_cast<uint32_t*>(a.out)[nh + j] = s16;
    }
    if (j < nh) {
      uint32_t m = 0u;
      for (int k = 0; k < 32; ++k) {
        const long long lane = 32 * j + k;
        if (lane < a.B && (a.lane_out[lane] & 0x10000)) m |= 1u << k;
      }
      reinterpret_cast<uint32_t*>(a.out)[j] = m;
    }
  }
}

int blocks_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return (int)(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

int launch_all(Args a, cudaStream_t stream) {
  const long long cells = (long long)a.D * a.W;
  const long long nw = (a.B + 1) / 2;
  long long fin = a.S;
  if (a.resident && nw > fin) fin = nw;
  reset_kernel<<<blocks_for(a.S), kThreads, 0, stream>>>(a);
  lanes_a_kernel<<<blocks_for(a.B), kThreads, 0, stream>>>(a);
  slots_kernel<<<blocks_for(cells > a.S ? cells : a.S), kThreads, 0, stream>>>(a);
  lanes_b_kernel<<<blocks_for(a.B), kThreads, 0, stream>>>(a);
  finish_kernel<<<blocks_for(fin), kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

Args make_args(const void* wire, const void* tenant, const void* tflags, void* res, void* served,
               const void* hit, void* skeys, void* scols, void* cms, void* tstat, void* epoch,
               const void* fidx, const void* fthr, const void* leaf, const void* w1,
               const void* b1, const void* w2, const void* b2, const void* qshift,
               const void* tparams, void* scratch, void* lanes, void* out, int B, int width,
               int S, int ways, int D, int W, int T, int trees, int depth, int hidden, int sat,
               int resident) {
  Args a;
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
  a.lane_slot = (int*)lanes;
  a.lane_bits = (int*)lanes + B;
  a.lane_val = (int*)lanes + 2LL * B;
  a.lane_out = (int*)lanes + 3LL * B;
  a.out = (int*)out;
  a.B = B;
  a.width = width;
  a.S = S;
  a.ways = ways;
  a.D = D;
  a.W = W;
  a.T = T;
  a.trees = trees;
  a.depth = depth;
  a.hidden = hidden;
  a.sat = sat;
  a.resident = resident;
  return a;
}

}  // namespace

#define SCORE_PARAMS                                                                          \
  const void *wire, const void *tenant, const void *tflags, void *res, void *served,          \
      const void *hit, void *skeys, void *scols, void *cms, void *tstat, void *epoch,         \
      const void *fidx, const void *fthr, const void *leaf, const void *w1, const void *b1,   \
      const void *w2, const void *b2, const void *qshift, const void *tparams, void *scratch, \
      void *lanes, void *out, int B, int width, int S, int ways, int D, int W, int T,         \
      int trees, int depth, int hidden, int sat, cudaStream_t stream
#define SCORE_ARGS                                                                           \
  wire, tenant, tflags, res, served, hit, skeys, scols, cms, tstat, epoch, fidx, fthr, leaf, \
      w1, b1, w2, b2, qshift, tparams, scratch, lanes, out, B, width, S, ways, D, W, T,      \
      trees, depth, hidden, sat

extern "C" int infw_score_update(SCORE_PARAMS) {
  if (B <= 0) return 0;
  return launch_all(make_args(SCORE_ARGS, 0), stream);
}

extern "C" int infw_score_update_resident(SCORE_PARAMS) {
  if (B <= 0) return 0;
  return launch_all(make_args(SCORE_ARGS, 1), stream);
}
