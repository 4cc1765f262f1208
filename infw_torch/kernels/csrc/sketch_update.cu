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
// Layout: one cooperative launch (wire_io-style persistent grid), phases
// grid barriers apart:
//   P1  every eligible lane adds into cms and tcnt (atomics; lanes of a warp
//       on the same bucket or tenant combine first: __match_any_sync, one
//       atomic a group, so the synflood trace's hot keys cost one atomic a
//       warp and not one a lane; the sums commute mod 2^32, so the result
//       is the same bit for bit) |
//   P2  the clamp (grid-stride over D W) and, in the same phase, each
//       lane's estimate as min_d(min(cms, sat)): a read racing the clamp
//       sees c or sat, and the min with sat makes both the same; the probe
//       decide; a wanting lane bids atomicMax(winner[slot], lane); each
//       lane's (estimate, matched slot, wanted slot) goes to the (B, 4)
//       lane scratch |
//   P3  matched lanes atomicMax(cnt) where the slot has no winner; winners
//       store keys and cnt |
//   P4  the wanting lanes put winner[slot] back to -1 (no O(K) clear, and
//       a CUDA graph replays with the scratch as it found it).
// Words written in the launch (cms, winner, scratch) are read through L2
// (__ldcg): L1 is not coherent across SMs.
//
// What bounds it: bytes.  A lane reads its wire row, tenant, flags and
// verdict; the state (D W + 7 K + 4 T words, 48 KiB at the defaults)
// stays in L2, so at the main path's sizes (a 4096-lane chunk, 2^16-lane
// daemon jobs) the launch and its three grid barriers dominate.
//
// Layouts: wire (B, 4 | 7) u32 (wire_io.cuh full layouts); tenant, tflags
// (B,) i32; res (B,) i32 u32 verdicts, or on the resident entry ceil(B/2)
// words of packed u16 verdicts; cms (D, W), keys (K, 6), cnt (K,), tcnt
// (T, 4) i32; winner (K,) i32, -1 on entry and exit; lanes (B, 4) i32,
// 16-byte aligned.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "wire_io.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kMinThreads = 32;
constexpr int kMaxThreads = 256;
constexpr int kBlockSizes = 4;  // 32, 64, 128, 256
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kTcp = 6;
constexpr int kTcpSyn = 0x02, kTcpAck = 0x10;
constexpr uint32_t kFnvBasis = 0x811C9DC5u, kFnvPrime = 0x01000193u;
constexpr int kKeyWords = 6;

struct Args {
  const uint32_t* wire;
  const int* tenant;
  const int* tflags;
  const void* res;  // (B,) i32, or packed u16 words on the resident entry
  int* cms;
  uint32_t* keys;
  int* cnt;
  int* tcnt;
  int* winner;
  int4* lanes;
  int B, D, W, K, ways, T, sat;
};

struct Lane {
  uint32_t key[kKeyWords];
  uint32_t h1, h2;
  int act;
  bool elig;
  bool syn;
};

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
  uint32_t h = kFnvBasis;
#pragma unroll
  for (int w = 0; w < kKeyWords; ++w) h = (h ^ L.key[w]) * kFnvPrime;
  L.h1 = h;
  L.h2 = (h >> 16) | 1u;
  return L;
}

// P1 for one lane (every lane of the warp calls it, `live` false past B).
template <int WW, bool kRes16>
__device__ __forceinline__ void add_lane(const Args& a, int i, bool live, int lane_id) {
  Lane L;
  L.elig = false;
  if (live) L = lane_of<WW, kRes16>(a, i);
  const bool e = live && L.elig;
  for (int d = 0; d < a.D; ++d) {
    const int idx = e ? d * a.W + (int)((L.h1 + (uint32_t)d * L.h2) & (uint32_t)(a.W - 1)) : -1;
    const unsigned peers = __match_any_sync(kFull, idx);
    if (idx >= 0 && __ffs(peers) - 1 == lane_id) atomicAdd(a.cms + idx, __popc(peers));
  }
  const int row = e ? __ldg(a.tenant + i) : -1;
  const unsigned peers = __match_any_sync(kFull, row);
  const unsigned allow = __reduce_add_sync(peers, (e && L.act == wire_io::kAllow) ? 1u : 0u);
  const unsigned deny = __reduce_add_sync(peers, (e && L.act == wire_io::kDeny) ? 1u : 0u);
  const unsigned syn = __reduce_add_sync(peers, (e && L.syn) ? 1u : 0u);
  if (row >= 0 && __ffs(peers) - 1 == lane_id) {
    int* c = a.tcnt + 4 * row;
    atomicAdd(c, __popc(peers));
    if (allow) atomicAdd(c + 1, (int)allow);
    if (deny) atomicAdd(c + 2, (int)deny);
    if (syn) atomicAdd(c + 3, (int)syn);
  }
}

// P2 for one lane: estimate, decide, bid.  Returns its scratch row.
template <int WW, bool kRes16>
__device__ __forceinline__ int4 decide_lane(const Args& a, int i) {
  const Lane L = lane_of<WW, kRes16>(a, i);
  if (!L.elig) return make_int4(0, -1, -1, 0);
  int est = INT_MAX;
  for (int d = 0; d < a.D; ++d) {
    const int idx = d * a.W + (int)((L.h1 + (uint32_t)d * L.h2) & (uint32_t)(a.W - 1));
    est = min(est, min(__ldcg(a.cms + idx), a.sat));
  }
  int m_first = -1, e_first = -1, vmin = 0, vmin_cnt = 0, mslot = -1, eslot = -1, vslot = -1;
  for (int w = 0; w < a.ways; ++w) {
    const int slot = (int)((L.h1 + (uint32_t)w * L.h2) & (uint32_t)(a.K - 1));
    const int c = __ldg(a.cnt + slot);
    if (w == 0 || c < vmin_cnt) {  // argmin: the first of ties
      vmin = w;
      vmin_cnt = c;
      vslot = slot;
    }
    if (c > 0) {
      if (m_first < 0) {
        const uint32_t* k = a.keys + (size_t)slot * kKeyWords;
        bool eq = true;
#pragma unroll
        for (int j = 0; j < kKeyWords; ++j) eq = eq && __ldg(k + j) == L.key[j];
        if (eq) {
          m_first = w;
          mslot = slot;
        }
      }
    } else if (e_first < 0) {
      e_first = w;
      eslot = slot;
    }
  }
  (void)vmin;
  if (m_first >= 0) return make_int4(est, mslot, -1, 0);
  const int want_slot = e_first >= 0 ? eslot : vslot;
  const int vcnt = e_first >= 0 ? 0 : vmin_cnt;
  if (est > vcnt) {
    atomicMax(a.winner + want_slot, i);
    return make_int4(est, -1, want_slot, 0);
  }
  return make_int4(est, -1, -1, 0);
}

template <int WW, bool kRes16>
__global__ void __launch_bounds__(kMaxThreads) sketch_kernel(const Args a) {
  cg::grid_group grid = cg::this_grid();
  const int T = (int)(gridDim.x * blockDim.x);
  const int gtid = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  const int lane_id = (int)(threadIdx.x & 31);
  const int rounds = (a.B + T - 1) / T;

  // P1: the adds (every lane of a warp takes part in the warp intrinsics)
  for (int r = 0; r < rounds; ++r) {
    const int i = r * T + gtid;
    add_lane<WW, kRes16>(a, i, i < a.B, lane_id);
  }
  __syncwarp();
  grid.sync();

  // P2: the clamp, the estimates, the decide and the bids
  const int cells = a.D * a.W;
  for (int k = gtid; k < cells; k += T) {
    if (__ldcg(a.cms + k) > a.sat) a.cms[k] = a.sat;
  }
  for (int i = gtid; i < a.B; i += T) a.lanes[i] = decide_lane<WW, kRes16>(a, i);
  __syncwarp();
  grid.sync();

  // P3: the matched maxima where no lane wins the slot, the winners' rows
  for (int i = gtid; i < a.B; i += T) {
    const int4 s = __ldcg(a.lanes + i);
    if (s.y >= 0 && __ldcg(a.winner + s.y) < 0) atomicMax(a.cnt + s.y, s.x);
    if (s.z >= 0 && __ldcg(a.winner + s.z) == i) {
      const Lane L = lane_of<WW, kRes16>(a, i);
      uint32_t* k = a.keys + (size_t)s.z * kKeyWords;
#pragma unroll
      for (int j = 0; j < kKeyWords; ++j) k[j] = L.key[j];
      a.cnt[s.z] = s.x;
    }
  }
  __syncwarp();
  grid.sync();

  // P4: the winner scratch back to -1
  for (int i = gtid; i < a.B; i += T) {
    const int4 s = __ldcg(a.lanes + i);
    if (s.z >= 0) a.winner[s.z] = -1;
  }
}

// The block: the smallest of 32, 64, 128 and 256 threads with which one
// block per SM covers B, 256 above; the grid at most one block per
// `threads` lanes, at most the co-resident blocks, at most max_grid > 0.
template <int WW, bool kRes16>
cudaError_t launch(const Args& a, int max_grid, cudaStream_t stream) {
  static int sms_of[wire_io::kMaxDevices];
  static int per_sm_of[wire_io::kMaxDevices][kBlockSizes];
  const void* kernel = (const void*)sketch_kernel<WW, kRes16>;
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

template <bool kRes16>
int dispatch(const void* wire, const void* tenant, const void* tflags, const void* res,
             void* cms, void* keys, void* cnt, void* tcnt, void* winner, void* lanes, int B,
             int wire_w, int D, int W, int K, int ways, int T, int sat, int max_grid,
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
  a.winner = (int*)winner;
  a.lanes = (int4*)lanes;
  a.B = B;
  a.D = D;
  a.W = W;
  a.K = K;
  a.ways = ways;
  a.T = T;
  a.sat = sat;
  cudaError_t err;
  if (B < 1 || D < 1 || D > 8 || ways < 1 || ways > 8 || T < 1 || sat < 1 || W < 1 ||
      (W & (W - 1)) || K < 1 || (K & (K - 1))) {
    err = cudaErrorInvalidValue;
  } else if (wire_w == 4) {
    err = launch<4, kRes16>(a, max_grid, (cudaStream_t)stream);
  } else if (wire_w == 7) {
    err = launch<7, kRes16>(a, max_grid, (cudaStream_t)stream);
  } else {
    err = cudaErrorInvalidValue;
  }
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace

// K9, classic entry: `res` (B,) i32 u32 verdicts.  One cooperative launch
// on `stream` (B >= 1); returns its error, else cudaGetLastError().
// Allocates nothing; `winner` (K,) is -1 on entry and again when the
// launch ends; `lanes` (B, 4) i32 scratch, 16-byte aligned; max_grid > 0
// caps the grid (tests), 0 takes what fits; `reserved` must be 0.
extern "C" int infw_sketch_update(const void* wire, const void* tenant, const void* tflags,
                                  const void* res, void* cms, void* keys, void* cnt, void* tcnt,
                                  void* winner, void* lanes, int B, int wire_w, int D, int W,
                                  int K, int ways, int T, int sat, int max_grid, int reserved,
                                  void* stream) {
  if (reserved != 0) return (int)cudaErrorInvalidValue;
  return dispatch<false>(wire, tenant, tflags, res, cms, keys, cnt, tcnt, winner, lanes, B,
                         wire_w, D, W, K, ways, T, sat, max_grid, stream);
}

// K9, resident entry: `res` holds ceil(B/2) words of packed u16 verdicts
// (the merged results K8 wrote into the resident step's output).
extern "C" int infw_sketch_update_resident(const void* wire, const void* tenant,
                                           const void* tflags, const void* res, void* cms,
                                           void* keys, void* cnt, void* tcnt, void* winner,
                                           void* lanes, int B, int wire_w, int D, int W, int K,
                                           int ways, int T, int sat, int max_grid,
                                           int reserved, void* stream) {
  if (reserved != 0) return (int)cudaErrorInvalidValue;
  return dispatch<true>(wire, tenant, tflags, res, cms, keys, cnt, tcnt, winner, lanes, B,
                        wire_w, D, W, K, ways, T, sat, max_grid, stream);
}
