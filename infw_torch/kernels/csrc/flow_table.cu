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
// columns before any scatter.  One launch cannot promise that (a lane may
// see another lane's update), so each entry is split into launches on one
// stream, each a full barrier for the next:
//   probe:  decide (reads only) -> add + max -> min
//   insert: decide (reads only; the per-slot winner by atomicMax into the
//           scratch) -> the winners write their rows and zero their
//           counters -> every eligible lane adds its counter seed and
//           clears the scratch it touched
// The probe's max-then-min order is XLA's: a FIN lane and an RST lane on
// one slot leave state 0.  The insert's counters are the sums over ALL the
// eligible lanes that chose the slot, which is what the winners' zero plus
// everyone's add computes.  The winner scratch (C int32) belongs to the
// table and is -1 between calls: the last launch restores each slot an
// eligible lane touched, so no launch clears O(C) words (one memset of the
// 4 count words is all).
//
// What bounds it on this card: bytes.  Per lane the wire (16 or 28 B), the
// tenant and flags (8 B), W candidate rows of 48 B read (keys 32, se 8, vg
// 8), the 2 B result and a bit of bitmap; a hit lane's cnt and se
// read-modify-writes; for the insert the winners' 60 B rows and the
// scratch.  Each candidate row is a random 32-byte sector, so the reads
// are sector-bound, not bandwidth-bound, at the sizes here: a chunk of
// 4096 lanes is a few hundred KB and the launches' own latency dominates.
// The design is one thread per lane and the simplest correct split.
//
// Layouts: wire (B, 4 | 7) u32 (the full layouts, wire_io.cuh); tenant,
// tflags, verdict (B,) i32; gens (n_gens,), page_table (n_pages,) i32;
// scratch (B, 2) i32 per call; probe out (B + 1) / 2 words of u16 results,
// ceil(B / 32) bitmap words (LSB first), [hits, stale].
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "wire_io.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kFlowEst = 2;
constexpr int kFlowNew = 1;
constexpr int kFlowFin = 3;
constexpr int kTcp = 6;
constexpr int kTcpFin = 0x01, kTcpSyn = 0x02, kTcpRst = 0x04, kTcpAck = 0x10;
constexpr uint32_t kFnvBasis = 0x811C9DC5u, kFnvPrime = 0x01000193u;

struct Lane {
  uint32_t key[8];
  int kind_ip_l4;  // IPv4 or IPv6 with l4_ok
  int tcp;
  int tenant;
  uint32_t pkt_len;
  int page;        // -1: tenant out of range or unmapped
  int gen;         // gens[clip(tenant, 0, n_gens - 1)]
  long long base;  // max(page, 0) * S
  uint32_t h1, h2;
};

template <int WW>
__device__ __forceinline__ Lane lane_of(const uint32_t* __restrict__ wire,
                                        const int* __restrict__ tenant, long long i,
                                        const int* __restrict__ gens, int n_gens,
                                        const int* __restrict__ page_table, int n_pages, int S) {
  const wire_io::Packet p = wire_io::decode<WW>(wire, i, nullptr, 1);
  Lane L;
  const int t = __ldg(tenant + i);
  L.tenant = t;
  L.key[0] = (uint32_t)t;
  L.key[1] = (uint32_t)p.ifindex;
  L.key[2] = p.w.x;
  L.key[3] = p.w.y;
  L.key[4] = p.w.z;
  L.key[5] = p.w.w;
  L.key[6] = ((uint32_t)p.proto & 0xFFu) | (((uint32_t)p.dport & 0xFFFFu) << 8) |
             (((uint32_t)p.kind & 3u) << 24) | (((uint32_t)p.l4_ok & 1u) << 26);
  L.key[7] = ((uint32_t)p.itype & 0xFFu) | (((uint32_t)p.icode & 0xFFu) << 8);
  L.kind_ip_l4 = wire_io::looked_up(p);
  L.tcp = p.proto == kTcp;
  L.pkt_len = p.pkt_len;
  // the clips keep every gather in range (jaxpath._arena_pages, the gens
  // take, _flow_slots' clip of page -1 to 0)
  L.page = (t >= 0 && t < n_pages) ? __ldg(page_table + t) : -1;
  L.gen = __ldg(gens + min(max(t, 0), n_gens - 1));
  L.base = (long long)max(L.page, 0) * S;
  uint32_t h = kFnvBasis;
#pragma unroll
  for (int w = 0; w < 8; ++w) h = (h ^ L.key[w]) * kFnvPrime;
  L.h1 = h;
  L.h2 = (h >> 16) | 1u;
  return L;
}

__device__ __forceinline__ long long slot_of(const Lane& L, int w, int S) {
  return L.base + (long long)((L.h1 + (uint32_t)w * L.h2) & (uint32_t)(S - 1));
}

__device__ __forceinline__ bool key_eq(const uint32_t* __restrict__ keys, long long s,
                                       const Lane& L) {
  const uint4* r = reinterpret_cast<const uint4*>(keys + s * 8);
  const uint4 a = r[0], b = r[1];
  return a.x == L.key[0] && a.y == L.key[1] && a.z == L.key[2] && a.w == L.key[3] &&
         b.x == L.key[4] && b.y == L.key[5] && b.z == L.key[6] && b.w == L.key[7];
}

// (int32)(now - then) with the wrap XLA's int32 subtraction has; signed
// overflow is undefined in C++, so the difference is taken unsigned.
__device__ __forceinline__ int epoch_diff(int now, int then) {
  return (int)((uint32_t)now - (uint32_t)then);
}

// --- K7 ------------------------------------------------------------------------

template <int WW>
__global__ void __launch_bounds__(kThreads)
probe_decide(const uint32_t* __restrict__ wire, const int* __restrict__ tenant,
             const int* __restrict__ tflags, const uint32_t* __restrict__ keys,
             const int2* __restrict__ vg, const int2* __restrict__ se,
             const int* __restrict__ gens, int n_gens, const int* __restrict__ page_table,
             int n_pages, int B, int S, int ways, int epoch_now, int max_age,
             uint32_t* __restrict__ out, int2* __restrict__ lanes) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  bool hit = false, stale = false;
  if (i < B) {
    const Lane L = lane_of<WW>(wire, tenant, i, gens, n_gens, page_table, n_pages, S);
    const bool elig = L.kind_ip_l4 && L.page >= 0;
    long long slot = -1;
    int res = 0;
    if (elig) {
      for (int w = 0; w < ways; ++w) {
        const long long s = slot_of(L, w, S);
        const int2 e = se[s];
        if (e.x < kFlowEst || epoch_diff(epoch_now, e.y) > max_age) continue;
        if (!key_eq(keys, s, L)) continue;
        const int2 g = vg[s];
        if (g.y == L.gen) {
          hit = true;
          slot = s;
          res = g.x;
          break;
        }
        stale = true;  // matches, live and fresh, but of another generation
      }
    }
    if (hit) stale = false;
    wire_io::put_res16(out, i, hit ? res : 0);
    const int f = __ldg(tflags + i);
    const uint32_t fin = (L.tcp && (f & kTcpFin)) ? 1u : 0u;
    const uint32_t rst = (L.tcp && (f & kTcpRst)) ? 1u : 0u;
    lanes[i] = make_int2((int)slot, (int)((L.pkt_len & 0xFFFFFFu) | (fin << 24) | (rst << 25)));
  }
  // the bitmap word and the counts of this warp's 32 lanes
  const unsigned hb = __ballot_sync(0xFFFFFFFFu, hit);
  const unsigned sb = __ballot_sync(0xFFFFFFFFu, stale);
  if ((threadIdx.x & 31) == 0) {
    const long long word = i >> 5;
    const long long nw = ((long long)B + 1) / 2, nh = ((long long)B + 31) / 32;
    if (word < nh) out[nw + word] = hb;
    if (hb) atomicAdd(out + nw + nh, (uint32_t)__popc(hb));
    if (sb) atomicAdd(out + nw + nh + 1, (uint32_t)__popc(sb));
  }
}

__global__ void __launch_bounds__(kThreads)
probe_add_max(const int2* __restrict__ lanes, int B, int epoch_now, int* __restrict__ se,
              int* __restrict__ cnt) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= B) return;
  const int2 l = lanes[i];
  if (l.x < 0) return;
  const long long s = l.x;
  const uint32_t len = (uint32_t)l.y & 0xFFFFFFu;
  atomicAdd(cnt + s * 3, 1);
  atomicAdd(cnt + s * 3 + 1, (int)((len >> 8) & 0xFFFFFFu));
  atomicAdd(cnt + s * 3 + 2, (int)(len & 0xFFu));
  atomicMax(se + s * 2, ((uint32_t)l.y >> 24) & 1u ? kFlowFin : -1);
  atomicMax(se + s * 2 + 1, epoch_now);
}

__global__ void __launch_bounds__(kThreads)
probe_min(const int2* __restrict__ lanes, int B, int* __restrict__ se) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= B) return;
  const int2 l = lanes[i];
  if (l.x < 0 || !(((uint32_t)l.y >> 25) & 1u)) return;
  atomicMin(se + (long long)l.x * 2, 0);  // FLOW_EMPTY; the epoch's min with INT_MAX keeps it
}

// --- K8 ------------------------------------------------------------------------

template <int WW>
__global__ void __launch_bounds__(kThreads)
insert_decide(const uint32_t* __restrict__ wire, const int* __restrict__ tenant,
              const int* __restrict__ tflags, const uint32_t* __restrict__ keys,
              const int2* __restrict__ se, const int* __restrict__ gens, int n_gens,
              const int* __restrict__ page_table, int n_pages, int B, int S, int ways,
              int* __restrict__ winner, int2* __restrict__ lanes) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= B) return;
  const Lane L = lane_of<WW>(wire, tenant, i, gens, n_gens, page_table, n_pages, S);
  const int f = __ldg(tflags + i);
  const bool rst = L.tcp && (f & kTcpRst);
  const bool elig = L.kind_ip_l4 && L.page >= 0 && !rst;
  int m_first = -1, e_first = -1, oldest = 0, oldest_ep = INT_MAX;
  int m_state = 0, e_state = 0, o_state = 0;
  for (int w = 0; w < ways; ++w) {
    const long long s = slot_of(L, w, S);
    const int2 e = se[s];
    if (w == 0 || e.y < oldest_ep) {  // argmin: the first of equal epochs
      oldest = w;
      oldest_ep = e.y;
      o_state = e.x;
    }
    if (e.x == 0) {
      if (e_first < 0) {
        e_first = w;
        e_state = e.x;
      }
    } else if (m_first < 0 && e.x > 0 && key_eq(keys, s, L)) {
      m_first = w;
      m_state = e.x;
    }
  }
  const int way = m_first >= 0 ? m_first : (e_first >= 0 ? e_first : oldest);
  const int old_state = m_first >= 0 ? m_state : (e_first >= 0 ? e_state : o_state);
  const long long slot = slot_of(L, way, S);
  if (elig) atomicMax(winner + slot, (int)i);
  lanes[i] = make_int2(elig ? (int)slot : -1, (m_first >= 0 ? 1 : 0) | (old_state << 1));
}

template <int WW>
__global__ void __launch_bounds__(kThreads)
insert_write(const uint32_t* __restrict__ wire, const int* __restrict__ tenant,
             const int* __restrict__ tflags, const int* __restrict__ verdict,
             const int* __restrict__ gens, int n_gens, const int* __restrict__ page_table,
             int n_pages, int B, int S, int epoch_now, const int* __restrict__ winner,
             const int2* __restrict__ lanes, uint32_t* __restrict__ keys, int2* __restrict__ vg,
             int2* __restrict__ se, int* __restrict__ cnt, int* __restrict__ counts) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  bool win = false, evict = false, promote = false;
  if (i < B) {
    const int2 l = lanes[i];
    if (l.x >= 0 && winner[l.x] == (int)i) {
      win = true;
      const long long s = l.x;
      const Lane L = lane_of<WW>(wire, tenant, i, gens, n_gens, page_table, n_pages, S);
      const int f = __ldg(tflags + i);
      const bool fin = L.tcp && (f & kTcpFin);
      const bool syn_only = L.tcp && (f & kTcpSyn) && !(f & kTcpAck);
      const int state = fin ? kFlowFin : (syn_only ? kFlowNew : kFlowEst);
      const bool matched = l.y & 1;
      const int old_state = l.y >> 1;
      evict = !matched && old_state > 0;
      promote = matched && old_state == kFlowNew && state == kFlowEst;
      uint4* r = reinterpret_cast<uint4*>(keys + s * 8);
      r[0] = make_uint4(L.key[0], L.key[1], L.key[2], L.key[3]);
      r[1] = make_uint4(L.key[4], L.key[5], L.key[6], L.key[7]);
      vg[s] = make_int2(__ldg(verdict + i) & 0xFFFF, L.gen);
      se[s] = make_int2(state, epoch_now);
      cnt[s * 3] = 0;
      cnt[s * 3 + 1] = 0;
      cnt[s * 3 + 2] = 0;
    }
  }
  const unsigned wb = __ballot_sync(0xFFFFFFFFu, win);
  const unsigned eb = __ballot_sync(0xFFFFFFFFu, evict);
  const unsigned pb = __ballot_sync(0xFFFFFFFFu, promote);
  if ((threadIdx.x & 31) == 0) {
    if (wb) atomicAdd(counts, __popc(wb));
    if (eb) atomicAdd(counts + 1, __popc(eb));
    if (pb) atomicAdd(counts + 2, __popc(pb));
  }
}

template <int WW>
__global__ void __launch_bounds__(kThreads)
insert_seed(const uint32_t* __restrict__ wire, const int2* __restrict__ lanes, int B,
            int* __restrict__ cnt, int* __restrict__ winner) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= B) return;
  const int2 l = lanes[i];
  if (l.x < 0) return;
  const long long s = l.x;
  const uint32_t len = wire_io::decode<WW>(wire, i, nullptr, 1).pkt_len;
  atomicAdd(cnt + s * 3, 1);
  atomicAdd(cnt + s * 3 + 1, (int)((len >> 8) & 0xFFFFFFu));
  atomicAdd(cnt + s * 3 + 2, (int)(len & 0xFFu));
  winner[s] = -1;  // the scratch back to its between-calls state
}

unsigned blocks(int B) { return (unsigned)(((long long)B + kThreads - 1) / kThreads); }

template <int WW>
cudaError_t probe(const void* wire, const void* tenant, const void* tflags, void* keys, void* vg,
                  void* se, void* cnt, const void* gens, const void* page_table, void* out,
                  void* lanes, int B, int n_gens, int n_pages, int S, int ways, int epoch_now,
                  int max_age, cudaStream_t st) {
  probe_decide<WW><<<blocks(B), kThreads, 0, st>>>(
      (const uint32_t*)wire, (const int*)tenant, (const int*)tflags, (const uint32_t*)keys,
      (const int2*)vg, (const int2*)se, (const int*)gens, n_gens, (const int*)page_table,
      n_pages, B, S, ways, epoch_now, max_age, (uint32_t*)out, (int2*)lanes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  probe_add_max<<<blocks(B), kThreads, 0, st>>>((const int2*)lanes, B, epoch_now, (int*)se,
                                                (int*)cnt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  probe_min<<<blocks(B), kThreads, 0, st>>>((const int2*)lanes, B, (int*)se);
  return cudaGetLastError();
}

template <int WW>
cudaError_t insert(const void* wire, const void* tenant, const void* tflags, const void* verdict,
                   void* keys, void* vg, void* se, void* cnt, void* winner, const void* gens,
                   const void* page_table, void* counts, void* lanes, int B, int n_gens,
                   int n_pages, int S, int ways, int epoch_now, cudaStream_t st) {
  insert_decide<WW><<<blocks(B), kThreads, 0, st>>>(
      (const uint32_t*)wire, (const int*)tenant, (const int*)tflags, (const uint32_t*)keys,
      (const int2*)se, (const int*)gens, n_gens, (const int*)page_table, n_pages, B, S, ways,
      (int*)winner, (int2*)lanes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  insert_write<WW><<<blocks(B), kThreads, 0, st>>>(
      (const uint32_t*)wire, (const int*)tenant, (const int*)tflags, (const int*)verdict,
      (const int*)gens, n_gens, (const int*)page_table, n_pages, B, S, epoch_now,
      (const int*)winner, (const int2*)lanes, (uint32_t*)keys, (int2*)vg, (int2*)se, (int*)cnt,
      (int*)counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  insert_seed<WW><<<blocks(B), kThreads, 0, st>>>((const uint32_t*)wire, (const int2*)lanes, B,
                                                  (int*)cnt, (int*)winner);
  return cudaGetLastError();
}

}  // namespace

// K7.  Launches on `stream` and returns cudaGetLastError(); allocates
// nothing.  wire_w is 4 or 7; C = n_pages_total * S rows; `lanes` is (B, 2)
// i32 scratch; `out` has (B + 1) / 2 + ceil(B / 32) + 2 words (the wrapper
// checks shapes, types and alignment).
extern "C" int infw_flow_probe(const void* wire, const void* tenant, const void* tflags,
                               void* keys, void* vg, void* se, void* cnt, const void* gens,
                               const void* page_table, void* out, void* lanes, int B, int wire_w,
                               int n_gens, int n_pages, int C, int S, int ways, int epoch_now,
                               int max_age, void* stream) {
  (void)C;
  cudaStream_t st = (cudaStream_t)stream;
  // the one memset: the pad half of an odd B's last result word, the
  // bitmap and the two counts (every other word is written by a lane)
  const long long nw = ((long long)B + 1) / 2;
  const long long first = (B & 1) ? nw - 1 : nw;
  const long long total = nw + ((long long)B + 31) / 32 + 2;
  cudaError_t err = cudaMemsetAsync((uint32_t*)out + first, 0,
                                    (size_t)(total - first) * sizeof(uint32_t), st);
  if (err != cudaSuccess || B == 0) return (int)(err != cudaSuccess ? err : cudaGetLastError());
  if (wire_w == 4)
    err = probe<4>(wire, tenant, tflags, keys, vg, se, cnt, gens, page_table, out, lanes, B,
                   n_gens, n_pages, S, ways, epoch_now, max_age, st);
  else if (wire_w == 7)
    err = probe<7>(wire, tenant, tflags, keys, vg, se, cnt, gens, page_table, out, lanes, B,
                   n_gens, n_pages, S, ways, epoch_now, max_age, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

// K8.  Launches on `stream` and returns cudaGetLastError(); allocates
// nothing.  `winner` (C,) must be -1 on entry and is -1 again after the
// last launch; `counts` (4,) i32 receives [inserts, evictions, promotes, 0].
extern "C" int infw_flow_insert(const void* wire, const void* tenant, const void* tflags,
                                const void* verdict, void* keys, void* vg, void* se, void* cnt,
                                void* winner, const void* gens, const void* page_table,
                                void* counts, void* lanes, int B, int wire_w, int n_gens,
                                int n_pages, int C, int S, int ways, int epoch_now,
                                void* stream) {
  (void)C;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(counts, 0, 4 * sizeof(int), st);
  if (err != cudaSuccess || B == 0) return (int)(err != cudaSuccess ? err : cudaGetLastError());
  if (wire_w == 4)
    err = insert<4>(wire, tenant, tflags, verdict, keys, vg, se, cnt, winner, gens, page_table,
                    counts, lanes, B, n_gens, n_pages, S, ways, epoch_now, st);
  else if (wire_w == 7)
    err = insert<7>(wire, tenant, tflags, verdict, keys, vg, se, cnt, winner, gens, page_table,
                    counts, lanes, B, n_gens, n_pages, S, ways, epoch_now, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
