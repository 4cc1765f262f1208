// Kernel K11: the payload tier's Aho-Corasick walk (kernels/acmatch.py), for
// sm_90a.  It replaces the JAX package's XLA program `_acmatch_core`
// (infw/kernels/acmatch.py), a scan of L steps, and its merge
// `_payload_merge_core`.
//
// Operands, K11's layout of the dense DFA (acmatch.kernel_layout, built on
// the host from `delta` and `matchmap`):
//   next  (S, 256) u16 (u32 above 32768 states): the states renumbered
//         breadth-first from the root, so the shallow rows are a prefix of
//         the table; the entry of (state, byte) is the next state (XLA's clip
//         folded in) in bits 0-14 (0-30) and bit 15 (31) set iff that state
//         reports a pattern (its matchmap row is non-zero)
//   mrows (S, PW) u32: the matchmap rows in the same order
//   head  (1,) int32: the reachable states, the rows worth staging: what
//         differs between two pattern sets of one spec, read here and never
//         passed by value, since a CUDA graph bakes the arguments
//   pay   (B, stride) u8: each lane's payload prefix, stride >= L
//   plen  (B,) int32: each lane's valid bytes; position p is active iff p <
//         plen (so plen <= 0 walks nothing, plen > L walks all L bytes)
//
// What bounds it: not bytes (a lane moves at most 128 payload bytes and its
// bitmap) but the chain of L dependent table reads each lane walks: read
// from L2, a step takes about 200 ns (NVIDIA H100 80GB HBM3, 700.00 W).
// Almost every step of real traffic lands on a shallow state, so:
//   - plan S's blocks stage the first min(rows, head[0]) rows of `next`, the
//     reachable rows the launch's shared memory holds (about 420 rows of
//     512 B in the card's opt-in 227 KB), by cp.async in 16-byte pieces, each
//     block once (the grid is at most one block an SM, its lanes strided);
//     the first lane's payload is loaded while the copy is in flight;
//   - a plan S step is one load whose address is selected between the staged
//     table (shared memory) and the global one (deeper states, through L1),
//     with no branch: a step with two loads, or a branch, waits on both
//     paths (measured on the card: several times a step's time);
//   - a lane's payload bytes do not depend on the chain: its 16-byte vectors
//     (byte loads where rows are not 16-byte aligned) are loaded one ahead
//     of the walk; the steps past the lane's end in its last vector are
//     walked and selected away;
//   - no matchmap read sits in the chain: a step whose flag is set stores the
//     landed state into one of the thread's kSlots shared-memory slots (the
//     classic entry; 0.2-1% of steps on signature traffic), whose rows are
//     OR-ed after the walk; a lane with more reporting states than slots is
//     walked again, OR-ing as it goes;
//   - plan L, for large batches, stages nothing: its blocks' shared memory
//     is left to the L1 cache, which holds the hot rows as well as staging
//     does there, without the copy; its step reads through the read-only
//     path, and each thread walks two lanes in step, two independent chains,
//     so an SM at its 32 warps holds twice the loads in flight (the walk is
//     bound there by the loads in flight: measured on the card, its time
//     falls with every warp an SM adds up to the 32 that fit).
//
// Classic entry (infw_acmatch): out (B, PW) u32 bitmaps, one walk a lane
// whatever PW: up to 32 words in registers, above that OR-ed into the lane's
// own row of `out`, which no other thread writes, 16 bytes at a time.
//
// Resident entry (infw_acmatch_resident), the resident step's stage between
// K10 and K8: the lane's verdict `hit ? served : res16` (the probe's packed
// u16 words, its hit bitmap, the stateless words), the walk whose "any" is
// the OR of the flags (no matchmap read at all), then the policy: rewrite =
// any && enforce && !failsafe(proto, dst_port) && (verdict & 0xFF) != Deny,
// the rewritten verdict Deny (ruleId 0).  The verdict goes into both u16-pair
// words (K8's merge then caches it), and the matched and rewritten lanes'
// bitmaps into `tail` (ceil(B/32) words each).  Lanes 2j and 2j + 1 share a
// word and 32 lanes a bitmap word, so a warp takes 32 consecutive lanes from
// a multiple of 32 for each lane a thread walks, on every round of the stride
// loop (the block's threads are a multiple of 32, the round's bound
// warp-uniform): the pair is joined with a shuffle, the bitmaps with
// ballots, the whole warp converged.
#include <cuda_runtime.h>
#include <stdint.h>

#include "failsafe.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxVec = 8;      // 16-byte payload vectors a lane: L <= 128
constexpr uint32_t kSlots = 4;  // reporting states a lane keeps for after its walk
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kDeny = 1;  // action Deny, ruleId 0

template <typename E>
struct Entry;
template <>
struct Entry<uint16_t> {
  static constexpr uint32_t kShift = 15, kMask = 0x7FFFu;
};
template <>
struct Entry<uint32_t> {
  static constexpr uint32_t kShift = 31, kMask = 0x7FFFFFFFu;
};

struct Args {
  const void* next;
  const uint32_t* mrows;
  const int* head;
  const uint8_t* pay;
  const int* plen;
  int B, L, stride, PW, rows;
  bool vec;  // 16-byte payload loads (rows 16-byte aligned)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Start staging the first min(rows, head[0]) rows of `next` into `table`
// (cp.async, 16-byte pieces); returns that count (a state below it is read
// from shared memory).  stage_end() waits for the copy and the block.
template <typename E>
__device__ __forceinline__ uint32_t stage_begin(const Args& a, E* table) {
  int r = __ldg(a.head);
  r = r < 0 ? 0 : (r > a.rows ? a.rows : r);
  const int pieces = r * 256 * (int)sizeof(E) / 16;
  const uint4* src = static_cast<const uint4*>(a.next);
  uint4* dst = reinterpret_cast<uint4*>(table);
  for (int p = threadIdx.x; p < pieces; p += blockDim.x)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst + p)),
                 "l"(src + p)
                 : "memory");
  asm volatile("cp.async.commit_group;" ::: "memory");
  return (uint32_t)r;
}

__device__ __forceinline__ void stage_end() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
}

// The lane's active byte count: min(max(plen, 0), L).
__device__ __forceinline__ int active_bytes(const Args& a, long long i) {
  const int n = __ldg(a.plen + i);
  return n <= 0 ? 0 : (n < a.L ? n : a.L);
}

// 16 payload bytes at `p`: one vector load, or 16 byte loads.
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ p, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w[k] = (uint32_t)__ldg(p + 4 * k) | ((uint32_t)__ldg(p + 4 * k + 1) << 8) |
           ((uint32_t)__ldg(p + 4 * k + 2) << 16) | ((uint32_t)__ldg(p + 4 * k + 3) << 24);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int c) {
  return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
}

// One step's entry.  Staged: a staged state's from shared memory, a deeper
// one's from the global table, through one generic load whose address is
// selected (no branch, and no second load whose scoreboard the step would
// wait on).  Not staged: the global table through the read-only path.
template <typename E, bool kStaged>
__device__ __forceinline__ uint32_t entry(const E* table, const E* gnext, uint32_t state,
                                          uint32_t staged, uint32_t byte) {
  const uint32_t idx = (state << 8) | byte;
  if constexpr (kStaged) return (uint32_t) * ((state < staged ? table : gnext) + idx);
  return (uint32_t)__ldg(gnext + idx);
}

// K lanes' walk inputs: each lane's active byte count, its payload row and
// the 16-byte vector being walked (the next one is loaded one vector ahead,
// so the chain never waits on the payload past the first).
template <int K>
struct Lanes {
  int n[K];
  const uint8_t* row[K];
  uint4 cur[K];
};

template <int K>
__device__ __forceinline__ void open_lane(const Args& a, Lanes<K>& ln, int l, long long i,
                                          bool live) {
  ln.n[l] = live ? active_bytes(a, i) : 0;
  ln.row[l] = a.pay + (size_t)(live ? i : 0) * (size_t)a.stride;
  ln.cur[l] = ln.n[l] > 0 ? load16(ln.row[l], a.vec) : make_uint4(0u, 0u, 0u, 0u);
}

// Walk K lanes in step; `visit(l, state, flag)` after every step of lane l
// (flag 0 on the masked steps past the lane's end: a 16-byte vector is
// walked whole, its steps past n selected away, so a step has no branch).
template <typename E, bool kStaged, int K, typename Visit>
__device__ __forceinline__ void walk(const Args& a, Lanes<K>& ln, const E* table,
                                     uint32_t staged, Visit visit) {
  const E* gnext = static_cast<const E*>(a.next);
  uint32_t state[K];
  int nmax = 0;
#pragma unroll
  for (int l = 0; l < K; ++l) {
    state[l] = 0;
    nmax = ln.n[l] > nmax ? ln.n[l] : nmax;
  }
#pragma unroll
  for (int k = 0; k < kMaxVec; ++k) {
    if (16 * k >= nmax) break;
    uint4 nxt[K];
#pragma unroll
    for (int l = 0; l < K; ++l)
      nxt[l] = k + 1 < kMaxVec && 16 * (k + 1) < ln.n[l]
                   ? load16(ln.row[l] + 16 * (k + 1), a.vec)
                   : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int l = 0; l < K; ++l) {
        const uint32_t byte = (word(ln.cur[l], j >> 2) >> ((j & 3) * 8)) & 0xFFu;
        const uint32_t e = entry<E, kStaged>(table, gnext, state[l], staged, byte);
        const bool act = 16 * k + j < ln.n[l];
        state[l] = act ? (e & Entry<E>::kMask) : state[l];
        visit(l, state[l], act ? (e >> Entry<E>::kShift) : 0u);
      }
    }
#pragma unroll
    for (int l = 0; l < K; ++l) ln.cur[l] = nxt[l];
  }
}

// Block-level start: stage (plan S), and each lane's first vector loaded
// while the copy is in flight.
template <typename E, bool kStaged, int K>
__device__ __forceinline__ uint32_t begin(const Args& a, E* table, Lanes<K>& ln, long long base) {
  const uint32_t staged = kStaged ? stage_begin<E>(a, table) : 0u;
#pragma unroll
  for (int l = 0; l < K; ++l) {
    const long long i = base + 32 * l + (threadIdx.x & 31);
    open_lane(a, ln, l, i, i < a.B);
  }
  if constexpr (kStaged) stage_end();
  return staged;
}

// OR `state`'s CW-word matchmap row into acc (16-byte loads from 4 words up:
// the rows are 16-byte aligned when PW is a multiple of 4).
template <int CW>
__device__ __forceinline__ void row_or(const uint32_t* __restrict__ r, uint32_t* acc) {
  if constexpr (CW >= 4) {
#pragma unroll
    for (int k = 0; k < CW; k += 4) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(r + k));
      acc[k] |= v.x;
      acc[k + 1] |= v.y;
      acc[k + 2] |= v.z;
      acc[k + 3] |= v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < CW; ++k) acc[k] |= __ldg(r + k);
  }
}

// OR `state`'s PW-word matchmap row into the lane's row `o` of `out` (PW a
// multiple of 4, or below 4).
__device__ __forceinline__ void row_or_out(const Args& a, uint32_t s, uint32_t* o) {
  const uint32_t* r = a.mrows + (size_t)s * a.PW;
  if ((a.PW & 3) == 0) {
    for (int k = 0; k < a.PW; k += 4) {
      const uint4 m = __ldg(reinterpret_cast<const uint4*>(r + k));
      uint4 x = *reinterpret_cast<uint4*>(o + k);
      x.x |= m.x;
      x.y |= m.y;
      x.z |= m.z;
      x.w |= m.w;
      *reinterpret_cast<uint4*>(o + k) = x;
    }
  } else {
    for (int k = 0; k < a.PW; ++k) o[k] |= __ldg(r + k);
  }
}

// A lane that landed on more reporting states than it has slots: its row of
// `out` zeroed, then walked again one byte at a time, each reporting state's
// row OR-ed in as it lands.  Not inlined: rare, and kept out of the fast
// walk's registers.
template <typename E, bool kStaged>
__device__ __noinline__ void match_slow(const Args& a, const E* table, uint32_t staged,
                                        long long i, uint32_t* o) {
  for (int k = 0; k < a.PW; ++k) o[k] = 0u;
  const int n = active_bytes(a, i);
  const uint8_t* row = a.pay + (size_t)i * (size_t)a.stride;
  uint32_t state = 0;
  for (int p = 0; p < n; ++p) {
    const uint32_t e = entry<E, kStaged>(table, static_cast<const E*>(a.next), state, staged,
                                         __ldg(row + p));
    state = e & Entry<E>::kMask;
    if (e >> Entry<E>::kShift) row_or_out(a, state, o);
  }
}

// The classic entry.  A warp takes 32 K consecutive lanes a round (lane l of
// a thread is 32 l lanes past the first).  The walk keeps no matchmap read
// in its chain: a step whose flag is set stores the landed state into one of
// the lane's kSlots slots in shared memory (a predicated store the step never
// waits on); after the walk the slots' rows are OR-ed: CW = PW words in
// registers (PW <= 32), or CW = 0, PW > 32 words in 16-byte pieces straight
// into the lane's row of `out`.
template <typename E, int CW, bool kStaged>
__global__ void __launch_bounds__(kMaxThreads) match_kernel(Args a, uint32_t* __restrict__ out) {
  constexpr int K = kStaged ? 1 : 2;  // lanes a thread: plan S 1, plan L 2
  extern __shared__ uint4 smem4[];
  E* table = reinterpret_cast<E*>(smem4);
  uint32_t* slots = reinterpret_cast<uint32_t*>(table + (size_t)a.rows * 256) + threadIdx.x;
  const long long step = (long long)gridDim.x * blockDim.x * K;
  long long base = ((long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31u)) * K;
  Lanes<K> ln;
  const uint32_t staged = begin<E, kStaged, K>(a, table, ln, base);
  for (bool first = true; base < a.B; base += step, first = false) {
    if (!first) {
#pragma unroll
      for (int l = 0; l < K; ++l) {
        const long long i = base + 32 * l + (threadIdx.x & 31);
        open_lane(a, ln, l, i, i < a.B);
      }
    }
    uint32_t cnt[K];
#pragma unroll
    for (int l = 0; l < K; ++l) cnt[l] = 0;
    walk<E, kStaged, K>(a, ln, table, staged, [&](int l, uint32_t s, uint32_t f) {
      if (f) {
        if (cnt[l] < kSlots) slots[(l * kSlots + cnt[l]) * blockDim.x] = s;
        ++cnt[l];
      }
    });
#pragma unroll
    for (int l = 0; l < K; ++l) {
      const long long i = base + 32 * l + (threadIdx.x & 31);
      if (i >= a.B) continue;
      uint32_t* o = out + (size_t)i * a.PW;
      const uint32_t* sl = slots + l * kSlots * blockDim.x;
      if (cnt[l] > kSlots) {
        match_slow<E, kStaged>(a, table, staged, i, o);
      } else if constexpr (CW > 0) {
        uint32_t acc[CW];
#pragma unroll
        for (int k = 0; k < CW; ++k) acc[k] = 0u;
        for (uint32_t c = 0; c < cnt[l]; ++c)
          row_or<CW>(a.mrows + (size_t)sl[c * blockDim.x] * CW, acc);
#pragma unroll
        for (int k = 0; k < CW; ++k) o[k] = acc[k];
      } else {
        for (int k = 0; k < a.PW; k += 4) {
          uint4 x = make_uint4(0u, 0u, 0u, 0u);
          for (uint32_t c = 0; c < cnt[l]; ++c) {
            const uint4 m = __ldg(
                reinterpret_cast<const uint4*>(a.mrows + (size_t)sl[c * blockDim.x] * a.PW + k));
            x.x |= m.x;
            x.y |= m.y;
            x.z |= m.z;
            x.w |= m.w;
          }
          *reinterpret_cast<uint4*>(o + k) = x;
        }
      }
    }
  }
}

struct ResArgs {
  const int* pmode;
  const uint32_t* wire;
  uint32_t* served;
  const uint32_t* hit;
  uint32_t* res16;
  uint32_t* tail;
  int W;
};

// The resident entry.  A warp takes 32 K consecutive lanes a round, each
// group of 32 from a multiple of 32 (the rounds' bound is warp-uniform), so
// every shuffle and ballot sees one group's 32 lanes with the warp converged.
template <typename E, bool kStaged>
__global__ void __launch_bounds__(kMaxThreads) resident_kernel(Args a, ResArgs r) {
  constexpr int K = kStaged ? 1 : 2;  // lanes a thread: plan S 1, plan L 2
  extern __shared__ uint4 smem4[];
  E* table = reinterpret_cast<E*>(smem4);
  const long long step = (long long)gridDim.x * blockDim.x * K;
  const long long nh = ((long long)a.B + 31) >> 5;
  long long base = ((long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31u)) * K;
  Lanes<K> ln;
  const uint32_t staged = begin<E, kStaged, K>(a, table, ln, base);
  for (bool first = true; base < a.B; base += step, first = false) {
    uint32_t verdict[K], any[K];
#pragma unroll
    for (int l = 0; l < K; ++l) {
      const long long i = base + 32 * l + (threadIdx.x & 31);
      const bool live = i < a.B;
      if (!first) open_lane(a, ln, l, i, live);
      verdict[l] = 0u;
      any[l] = 0u;
      if (live) {
        const bool fhit = (__ldcg(r.hit + (i >> 5)) >> (i & 31)) & 1u;
        const uint32_t w = fhit ? __ldcg(r.served + (i >> 1)) : __ldcg(r.res16 + (i >> 1));
        verdict[l] = (w >> ((uint32_t)(i & 1) * 16u)) & 0xFFFFu;
      }
    }
    walk<E, kStaged, K>(a, ln, table, staged, [&](int l, uint32_t, uint32_t f) { any[l] |= f; });
    const bool enforce = __ldcg(r.pmode) != 0;
#pragma unroll
    for (int l = 0; l < K; ++l) {
      const long long i = base + 32 * l + (threadIdx.x & 31);
      const bool live = i < a.B;
      const bool matched = live && any[l] != 0u;
      bool rewrite = false;
      if (matched && enforce) {
        const uint32_t* row = r.wire + (size_t)i * r.W;
        const int proto = (int)((__ldg(row) >> 3) & 0xFFu);
        const int dport = (int)(__ldg(row + 1) & 0xFFFFu);
        rewrite = !failsafe_cells::failsafe(proto, dport) && (verdict[l] & 0xFFu) != kDeny;
      }
      const uint32_t v = rewrite ? kDeny : verdict[l];
      // every read of the lane pair's words is done before the shuffle
      const uint32_t odd = __shfl_down_sync(kFull, v, 1);
      const unsigned hbits = __ballot_sync(kFull, matched);
      const unsigned rbits = __ballot_sync(kFull, rewrite);
      if (live && (i & 1) == 0) {
        const uint32_t wd = v | ((i + 1 < a.B ? odd : 0u) << 16);
        r.served[i >> 1] = wd;
        r.res16[i >> 1] = wd;
      }
      if (live && (threadIdx.x & 31) == 0) {
        r.tail[i >> 5] = hbits;
        r.tail[nh + (i >> 5)] = rbits;
      }
    }
  }
}

// The chain floor: one warp, `steps` dependent shared-memory loads a lane,
// first a pure pointer chase (s = chase[s]), then the walk's own step (the
// index from the state and a byte, a 16-bit load, the state masked out),
// each timed by the SM's cycle counter; out[0..31] the chase's cycles,
// out[32..63] its end states, out[64..95] the step's cycles, out[96..127]
// its end states (kept so that no load is dropped).
__global__ void chain_floor_kernel(int steps, long long* out) {
  __shared__ uint16_t chase[4096];
  __shared__ uint16_t rows[64 * 256];
  const int t = threadIdx.x;
  for (int k = t; k < 4096; k += 32) chase[k] = (uint16_t)((k * 1021 + 1) & 4095);
  for (int k = t; k < 64 * 256; k += 32) rows[k] = (uint16_t)(((k * 2654435761u) >> 7) & 63u);
  __syncwarp();
  uint32_t s = (uint32_t)(t * 131) & 4095u;
  long long t0 = clock64();
  for (int p = 0; p < steps; ++p) s = chase[s];
  long long t1 = clock64();
  out[t] = t1 - t0;
  out[32 + t] = s;
  uint32_t bytes = 0x9E3779B9u * (uint32_t)(t + 1), state = (uint32_t)t & 63u;
  t0 = clock64();
  for (int p = 0; p < steps; ++p) {
    state = rows[(state << 8) | ((bytes >> ((p & 3) * 8)) & 0xFFu)] & 0x7FFFu;
    bytes += state;
  }
  t1 = clock64();
  out[64 + t] = t1 - t0;
  out[96 + t] = state;
}

// Every kernel the host may launch with dynamic shared memory.
template <typename E, bool kStaged>
void kernel_list(const void** fns) {
  fns[0] = (const void*)match_kernel<E, 0, kStaged>;
  fns[1] = (const void*)match_kernel<E, 1, kStaged>;
  fns[2] = (const void*)match_kernel<E, 2, kStaged>;
  fns[3] = (const void*)match_kernel<E, 4, kStaged>;
  fns[4] = (const void*)match_kernel<E, 8, kStaged>;
  fns[5] = (const void*)match_kernel<E, 16, kStaged>;
  fns[6] = (const void*)match_kernel<E, 32, kStaged>;
  fns[7] = (const void*)resident_kernel<E, kStaged>;
}
constexpr int kPerList = 8;

struct Device {
  int ready;
  int smem_optin;
};
Device devices[kMaxDevices];

// Once per device, outside any graph capture: every kernel's dynamic
// shared-memory cap raised to the card's opt-in limit.
cudaError_t prepare(int* device_out) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  *device_out = device;
  Device& d = devices[device];
  if (d.ready) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const void* fns[4 * kPerList];
  kernel_list<uint16_t, true>(fns);
  kernel_list<uint16_t, false>(fns + kPerList);
  kernel_list<uint32_t, true>(fns + 2 * kPerList);
  kernel_list<uint32_t, false>(fns + 3 * kPerList);
  for (int j = 0; j < 4 * kPerList; ++j) {
    err = cudaFuncSetAttribute(fns[j], cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
  }
  d.smem_optin = optin;
  d.ready = 1;
  return cudaSuccess;
}

// Dynamic shared memory of a launch: the staged rows, then (the classic
// entry) each lane's slots.
size_t smem_bytes(int rows, size_t entry, int threads, int lanes, bool slots) {
  return (size_t)rows * 256 * entry + (slots ? (size_t)kSlots * 4 * threads * lanes : 0);
}

// The launch shape's checks: plan 0 (S) or 1 (L, which stages nothing), a
// grid, whole warps of at most kMaxThreads, rows the card's blocks hold, L
// within the vectors.
cudaError_t check_shape(const Args& a, int plan, int grid, int threads, size_t entry, int S,
                        bool slots) {
  int device = 0;
  const cudaError_t err = prepare(&device);
  if (err != cudaSuccess) return err;
  if ((plan != 0 && plan != 1) || (plan == 1 && a.rows != 0) || grid < 1 || threads < 32 ||
      threads > kMaxThreads || (threads & 31) || a.rows < 0 || a.rows > S || a.L < 1 ||
      a.L > 16 * kMaxVec || (a.L & 15) || a.stride < a.L ||
      smem_bytes(a.rows, entry, threads, plan == 0 ? 1 : 2, slots) >
          (size_t)devices[device].smem_optin)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <typename E, int CW>
cudaError_t launch_match(const Args& a, uint32_t* out, int plan, int grid, int threads,
                         cudaStream_t stream) {
  const size_t bytes = smem_bytes(a.rows, sizeof(E), threads, plan == 0 ? 1 : 2, true);
  if (plan == 0)
    match_kernel<E, CW, true><<<grid, threads, bytes, stream>>>(a, out);
  else
    match_kernel<E, CW, false><<<grid, threads, bytes, stream>>>(a, out);
  return cudaGetLastError();
}

template <typename E>
cudaError_t dispatch_match(const Args& a, uint32_t* out, int plan, int grid, int threads,
                           cudaStream_t stream) {
  switch (a.PW) {
    case 1: return launch_match<E, 1>(a, out, plan, grid, threads, stream);
    case 2: return launch_match<E, 2>(a, out, plan, grid, threads, stream);
    case 4: return launch_match<E, 4>(a, out, plan, grid, threads, stream);
    case 8: return launch_match<E, 8>(a, out, plan, grid, threads, stream);
    case 16: return launch_match<E, 16>(a, out, plan, grid, threads, stream);
    case 32: return launch_match<E, 32>(a, out, plan, grid, threads, stream);
    default:  // a power of two above 32
      if (a.PW < 64 || (a.PW & 3)) return cudaErrorInvalidValue;
      return launch_match<E, 0>(a, out, plan, grid, threads, stream);
  }
}

template <typename E>
cudaError_t launch_resident(const Args& a, const ResArgs& r, int plan, int grid, int threads,
                            cudaStream_t stream) {
  const size_t bytes = smem_bytes(a.rows, sizeof(E), threads, 1, false);
  if (plan == 0)
    resident_kernel<E, true><<<grid, threads, bytes, stream>>>(a, r);
  else
    resident_kernel<E, false><<<grid, threads, bytes, stream>>>(a, r);
  return cudaGetLastError();
}

bool vectorizable(const uint8_t* pay, int stride) {
  return (stride & 15) == 0 && (reinterpret_cast<uintptr_t>(pay) & 15) == 0;
}

}  // namespace

// Set-up and queries, launching nothing: what 0 -> the opt-in shared memory
// a block may use, in bytes, after raising every K11 kernel's cap to it
// (once per device, before the first launch, outside any graph capture);
// what 1 -> the SM clock the card reports, in kHz; minus a CUDA error.
extern "C" int infw_acmatch_query(int what) {
  int device = 0;
  cudaError_t err = prepare(&device);
  if (err != cudaSuccess) return -(int)err;
  if (what == 0) return devices[device].smem_optin;
  if (what != 1) return -(int)cudaErrorInvalidValue;
  int khz = 0;
  err = cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, device);
  return err != cudaSuccess ? -(int)err : khz;
}

// K11, classic entry: one launch on `stream` (B >= 1) of plan `plan` (0 S,
// 1 L), `grid` blocks of `threads`, plan S's blocks each staging min(rows,
// head[0]) rows; returns its error, else cudaGetLastError().  Allocates
// nothing.
extern "C" int infw_acmatch(const void* next, const uint32_t* mrows, const int* head,
                            const uint8_t* pay, const int* plen, uint32_t* out, int B, int L,
                            int stride, int S, int PW, int plan, int grid, int threads, int rows,
                            cudaStream_t stream) {
  if (B <= 0) return 0;
  const Args a{next, mrows, head, pay, plen, B, L, stride, PW, rows, vectorizable(pay, stride)};
  const bool wide = S > 32768;
  cudaError_t err = check_shape(a, plan, grid, threads, wide ? 4 : 2, S, true);
  if (err != cudaSuccess) return (int)err;
  err = wide ? dispatch_match<uint32_t>(a, out, plan, grid, threads, stream)
             : dispatch_match<uint16_t>(a, out, plan, grid, threads, stream);
  return (int)err;
}

// K11, resident entry: as the classic entry's launch, then the merge, the
// policy and the words it writes (see the top of this file).
extern "C" int infw_acmatch_resident(const void* next, const uint32_t* mrows, const int* head,
                                     const uint8_t* pay, const int* plen, const int* pmode,
                                     const uint32_t* wire, uint32_t* served, const uint32_t* hit,
                                     uint32_t* res16, uint32_t* tail, int B, int W, int L,
                                     int stride, int S, int PW, int plan, int grid, int threads,
                                     int rows, cudaStream_t stream) {
  if (B <= 0) return 0;
  const Args a{next, mrows, head, pay, plen, B, L, stride, PW, rows, vectorizable(pay, stride)};
  const ResArgs r{pmode, wire, served, hit, res16, tail, W};
  const bool wide = S > 32768;
  cudaError_t err = check_shape(a, plan, grid, threads, wide ? 4 : 2, S, false);
  if (err != cudaSuccess) return (int)err;
  err = wide ? launch_resident<uint32_t>(a, r, plan, grid, threads, stream)
             : launch_resident<uint16_t>(a, r, plan, grid, threads, stream);
  return (int)err;
}

// The chain floor (a measurement on no serving path): one warp; `out` 128
// int64 words on the device (see chain_floor_kernel).
extern "C" int infw_acmatch_chain_floor(long long* out, int steps, cudaStream_t stream) {
  if (steps < 1) return (int)cudaErrorInvalidValue;
  chain_floor_kernel<<<1, 32, 0, stream>>>(steps, out);
  return (int)cudaGetLastError();
}
