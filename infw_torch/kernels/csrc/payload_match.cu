// Kernel K11: the payload tier's Aho-Corasick walk over the dense DFA
// (kernels/acmatch.py), for sm_90a.  It replaces the JAX package's XLA
// program `_acmatch_core` (infw/kernels/acmatch.py), a scan of L steps, and
// its merge `_payload_merge_core`.
//
// Operands:
//   delta    (S, 256) int32: the next state of (state, byte)
//   matchmap (S, PW)  u32:   the patterns reported on landing in a state
//   pay      (B, stride) u8: each lane's payload prefix, stride >= L
//   plen     (B,) int32:     each lane's valid bytes; position p is active iff
//                            p < plen (so plen <= 0 walks nothing, plen > L
//                            walks all L bytes)
//
// One thread walks one lane: the lane's active bytes come in 16-byte vectors
// (byte loads where the rows are not 16-byte aligned), each active byte is
// one dependent load of `delta` (read through the read-only path; the rows a
// walk visits are few and hot), and the landed state's matchmap words are
// OR-ed into registers.  The state is clipped to [0, S) after every load,
// which is XLA's `take(..., mode="clip")` on the state.
//
// Classic entry (infw_acmatch): out (B, PW) u32 bitmaps.  A block's y index
// is a chunk of at most 32 matchmap words; each chunk walks the DFA again,
// so any power-of-two PW is served.
//
// Resident entry (infw_acmatch_resident), the resident step's stage between
// K10 and K8: the lane's verdict `hit ? served : res16` (the probe's packed
// u16 words, its hit bitmap, the stateless words), the walk OR-ing every
// matchmap word into one "any" register, then the policy: rewrite = any &&
// enforce && !failsafe(proto, dst_port) && (verdict & 0xFF) != Deny, the
// rewritten verdict Deny (ruleId 0).  The verdict goes into both u16-pair
// words (K8's merge then caches it), and the matched and rewritten lanes'
// bitmaps into `tail` (ceil(B/32) words each).  Lanes 2j and 2j + 1 share a
// word and 32 lanes a bitmap word, so a warp takes 32 lanes from a multiple
// of 32: the pair is joined with a shuffle, the bitmaps with ballots.
#include <cuda_runtime.h>
#include <stdint.h>

#include "failsafe.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunkWords = 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kDeny = 1;  // action Deny, ruleId 0

struct Args {
  const int* delta;
  const uint32_t* mmap;
  const uint8_t* pay;
  const int* plen;
  int B, L, stride, S, PW;
};

// The lane's active byte count: min(max(plen, 0), L).
__device__ __forceinline__ int active_bytes(const Args& a, long long i) {
  const int n = __ldg(a.plen + i);
  return n <= 0 ? 0 : (n < a.L ? n : a.L);
}

// 16 payload bytes at `p` (row offset `base`): one vector load or 16 byte
// loads.
template <bool kVec>
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ p) {
  if constexpr (kVec) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = (uint32_t)__ldg(p + 4 * k) | ((uint32_t)__ldg(p + 4 * k + 1) << 8) |
             ((uint32_t)__ldg(p + 4 * k + 2) << 16) | ((uint32_t)__ldg(p + 4 * k + 3) << 24);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__device__ __forceinline__ int step(const Args& a, int state, uint32_t byte) {
  const int nxt = __ldg(a.delta + (size_t)state * 256u + byte);
  return nxt < 0 ? 0 : (nxt >= a.S ? a.S - 1 : nxt);
}

// OR `CW` matchmap words of `state`'s row from word `w0` into acc (CW words;
// CW a power of two, 16-byte loads from 4 words up: the rows are 16-byte
// aligned when PW is a multiple of 4).
template <int CW>
__device__ __forceinline__ void row_or(const Args& a, int state, int w0, uint32_t* acc) {
  const uint32_t* r = a.mmap + (size_t)state * a.PW + w0;
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

// Every matchmap word of `state`'s row OR-ed into one word.
__device__ __forceinline__ uint32_t row_any(const Args& a, int state) {
  const uint32_t* r = a.mmap + (size_t)state * a.PW;
  uint32_t any = 0;
  if ((a.PW & 3) == 0) {
    for (int k = 0; k < a.PW; k += 4) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(r + k));
      any |= v.x | v.y | v.z | v.w;
    }
  } else {
    for (int k = 0; k < a.PW; ++k) any |= __ldg(r + k);
  }
  return any;
}

// Walk lane i's first n bytes; `visit(state)` after every active byte.
template <bool kVec, typename Visit>
__device__ __forceinline__ void walk(const Args& a, long long i, int n, Visit visit) {
  const uint8_t* row = a.pay + (size_t)i * (size_t)a.stride;
  int state = 0;
  for (int base = 0; base < n; base += 16) {
    const uint4 v = load16<kVec>(row + base);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    const int m = n - base;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (k < m) {
        state = step(a, state, (w[k >> 2] >> ((k & 3) * 8)) & 0xFFu);
        visit(state);
      }
    }
  }
}

template <int CW, bool kVec>
__global__ void __launch_bounds__(kThreads) match_kernel(Args a, uint32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.B) return;
  const int n = active_bytes(a, i);
  const int chunks = a.PW / CW;
  for (int c = blockIdx.y; c < chunks; c += gridDim.y) {
    uint32_t acc[CW];
#pragma unroll
    for (int k = 0; k < CW; ++k) acc[k] = 0u;
    walk<kVec>(a, i, n, [&](int s) { row_or<CW>(a, s, c * CW, acc); });
    uint32_t* o = out + (size_t)i * a.PW + (size_t)c * CW;
#pragma unroll
    for (int k = 0; k < CW; ++k) o[k] = acc[k];
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

template <bool kVec>
__global__ void __launch_bounds__(kThreads) resident_kernel(Args a, ResArgs r) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < a.B;
  uint32_t verdict = 0u;
  bool matched = false, rewrite = false;
  if (live) {
    const bool fhit = (__ldcg(r.hit + (i >> 5)) >> (i & 31)) & 1u;
    const uint32_t w = fhit ? __ldcg(r.served + (i >> 1)) : __ldcg(r.res16 + (i >> 1));
    verdict = (w >> ((uint32_t)(i & 1) * 16u)) & 0xFFFFu;
    uint32_t any = 0u;
    walk<kVec>(a, i, active_bytes(a, i), [&](int s) { any |= row_any(a, s); });
    matched = any != 0u;
    if (matched && __ldcg(r.pmode) != 0) {
      const uint32_t* row = r.wire + (size_t)i * r.W;
      const int proto = (int)((__ldg(row) >> 3) & 0xFFu);
      const int dport = (int)(__ldg(row + 1) & 0xFFFFu);
      rewrite = !failsafe_cells::failsafe(proto, dport) && (verdict & 0xFFu) != kDeny;
    }
    if (rewrite) verdict = kDeny;
  }
  // every read of the lane pair's words is done before the shuffle
  const uint32_t odd = __shfl_down_sync(kFull, verdict, 1);
  const unsigned hbits = __ballot_sync(kFull, matched);
  const unsigned rbits = __ballot_sync(kFull, rewrite);
  if (live && (i & 1) == 0) {
    const uint32_t word = verdict | ((i + 1 < a.B ? odd : 0u) << 16);
    r.served[i >> 1] = word;
    r.res16[i >> 1] = word;
  }
  if (live && (threadIdx.x & 31) == 0) {
    const long long nh = ((long long)a.B + 31) >> 5;
    r.tail[i >> 5] = hbits;
    r.tail[nh + (i >> 5)] = rbits;
  }
}

template <int CW>
cudaError_t launch_match(const Args& a, uint32_t* out, bool vec, cudaStream_t stream) {
  const int chunks = a.PW / CW;
  const dim3 grid((unsigned)((a.B + kThreads - 1) / kThreads),
                  (unsigned)(chunks < 65535 ? chunks : 65535));
  if (vec)
    match_kernel<CW, true><<<grid, kThreads, 0, stream>>>(a, out);
  else
    match_kernel<CW, false><<<grid, kThreads, 0, stream>>>(a, out);
  return cudaGetLastError();
}

bool vectorizable(const Args& a) {
  return (a.stride & 15) == 0 && (reinterpret_cast<uintptr_t>(a.pay) & 15) == 0;
}

}  // namespace

extern "C" int infw_acmatch(const int* delta, const uint32_t* mmap, const uint8_t* pay,
                            const int* plen, uint32_t* out, int B, int L, int stride, int S,
                            int PW, cudaStream_t stream) {
  if (B <= 0) return 0;
  const Args a{delta, mmap, pay, plen, B, L, stride, S, PW};
  const bool vec = vectorizable(a);
  switch (PW < kChunkWords ? PW : kChunkWords) {
    case 1: return (int)launch_match<1>(a, out, vec, stream);
    case 2: return (int)launch_match<2>(a, out, vec, stream);
    case 4: return (int)launch_match<4>(a, out, vec, stream);
    case 8: return (int)launch_match<8>(a, out, vec, stream);
    case 16: return (int)launch_match<16>(a, out, vec, stream);
    case 32: return (int)launch_match<32>(a, out, vec, stream);
    default: return (int)cudaErrorInvalidValue;  // PW is a power of two
  }
}

extern "C" int infw_acmatch_resident(const int* delta, const uint32_t* mmap, const uint8_t* pay,
                                     const int* plen, const int* pmode, const uint32_t* wire,
                                     uint32_t* served, const uint32_t* hit, uint32_t* res16,
                                     uint32_t* tail, int B, int W, int L, int stride, int S,
                                     int PW, cudaStream_t stream) {
  if (B <= 0) return 0;
  const Args a{delta, mmap, pay, plen, B, L, stride, S, PW};
  const ResArgs r{pmode, wire, served, hit, res16, tail, W};
  const unsigned grid = (unsigned)((B + kThreads - 1) / kThreads);
  if (vectorizable(a))
    resident_kernel<true><<<grid, kThreads, 0, stream>>>(a, r);
  else
    resident_kernel<false><<<grid, kThreads, 0, stream>>>(a, r);
  return (int)cudaGetLastError();
}
