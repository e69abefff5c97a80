// hash_probe: the edge table's batched walk, insert and remove on the card.
//
// Three entries, one per edge-table operation:
//
// - lookup (hash_probe_launch): for each lane i, the outcome of the bounded
//   walk over slots (base[i] + p) & (C - 1), p < max_probes, exactly as the
//   sequential loop of repro.core.edge_table.lookup: found iff a LIVE slot
//   holding the key comes before the first EMPTY slot; slot is that hit,
//   else the first non-LIVE slot seen, else -1.
// - insert (hash_insert_launch): each key's hash (base, the uint32 mix of
//   repro.core.edge_table._hash), the lookup, then the claim rounds of
//   repro.core.edge_table.insert's round_body, all in one cooperative
//   launch.  In round r every pending lane reads state[(base + r) & (C-1)]
//   as round r - 1 left it; lanes on a non-LIVE slot contend and the lowest
//   lane index wins the slot and writes src, dst and LIVE; every pending
//   lane that did not win advances one slot.  failed = want & ~placed.
// - remove (hash_remove_launch): the hash, the lookup, the lowest lane
//   claiming each hit slot, then its TOMB write, in one cooperative launch.
//
// Replaces the TPU kernel probe_sweep (src/repro/kernels/hash_probe/
// kernel.py:73), which reads the WHOLE table per batch in panels and reduces
// three per-lane offset minima (first hit, first EMPTY, first non-LIVE):
// the trade pays only where gathers are slow.  The walk here computes the
// same three minima over the lane's own probe window only.  The TPU side
// left the claim rounds to XLA; the port ran them as torch ops with one
// host read per round.  Here they run inside the kernel.
//
// Bound: latency.  A walk is a chain of dependent loads, and a round is a
// grid-wide barrier between the claims and the decisions.  What the design
// does about it:
// - The walk reads 16 state bytes in one 16-byte load (one chunk), takes the
//   chunk's first EMPTY and first non-LIVE offsets from the bytes, and
//   issues the src and dst loads of every LIVE slot before that EMPTY
//   together (16 bytes per 4 slots).  A chain of p dependent loads becomes
//   about p / 16.  Offsets before the lane's start and past min(max_probes,
//   C) are masked; a window longer than C revisits nothing new, so the walk
//   stops at C slots, with the chunk at the start read again for the
//   offsets that wrap.  C below 16 or a column not 16-byte aligned takes
//   the slot-at-a-time walk.
// - Every pending lane advances exactly one slot per round, so a lane's
//   probe offset in round r is r and the kernel keeps one pending byte per
//   lane (the failed output), not a probe counter.
// - Claims: a slot that some lane contends in a round gets a winner, which
//   makes it LIVE, so no slot is contended in two rounds of one insert.
//   Claims live in two C-sized int32 buffers from the wrapper, used in
//   turn: in round r the losers reset the other buffer's word at their next
//   slot while round r's words are still being read, so no round needs a
//   reset phase and no buffer needs a C-sized fill.
// - The rounds stop once a device-side count of pending lanes reaches 0 (a
//   round with no pending lane changes nothing; JAX runs max_probes rounds
//   and gets the same table).  Each thread reads the count after the grid
//   barrier, so every thread leaves at the same round.
// - The hash is computed in the kernel (in uint32, where torch needs about
//   twenty int64 ops), once in the lookup and again in each round.
// - Lanes are grid-strided over a cooperative grid no larger than the
//   co-resident one, so one launch serves 8192 lanes and 2^23.
// - Reads of words other blocks write within the launch (state in the
//   rounds, claims, counts) go through L2 (__ldcg); byte stores of state
//   from neighbouring winners do not disturb each other.
//
// Tenant rows.  Every entry takes T tables of C slots each, [T, C] in one
// allocation, and T x B op lanes; lane i belongs to row i / B and probes
// row * C + ((h + p) & (C - 1)), so each row keeps exactly its solo layout
// and a key never meets another row's slots.  Slots the kernels return are
// row-local.  The claim buffers are [2, T, C], indexed by the same row
// offsets, so a claim never aliases across rows; the pending count and the
// round loop are shared (a row with no pending lane changes nothing in a
// round).  T = 1 is the single-table call.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr uint8_t kEmpty = 0;
constexpr uint8_t kLive = 1;
constexpr uint8_t kTomb = 2;
constexpr int kThreads = 256;
constexpr int kNoClaim = 0x7FFFFFFF;

struct Walk {
  bool found;
  int slot;  // the hit when found, else the first non-LIVE slot, else -1
};

// The walk one slot at a time: C below 16 or unaligned columns.
__device__ Walk walk_slots(const int* src, const int* dst,
                           const uint8_t* state, unsigned mask, int window,
                           unsigned start, int ku, int kv) {
  int free_slot = -1;
  for (int p = 0; p < window; ++p) {
    const unsigned pos = (start + (unsigned)p) & mask;
    const uint8_t st = state[pos];
    if (st == kLive) {
      if (src[pos] == ku && dst[pos] == kv) return {true, (int)pos};
    } else {
      if (free_slot < 0) free_slot = (int)pos;
      if (st == kEmpty) break;
    }
  }
  return {false, free_slot};
}

// The walk 16 slots at a time.  Chunk k holds offsets 16 k - lead + j.
__device__ Walk walk_chunks(const int* src, const int* dst,
                            const uint8_t* state, unsigned mask, int window,
                            unsigned start, int ku, int kv) {
  const int lead = (int)(start & 15u);
  const unsigned first_chunk = start - (unsigned)lead;
  int free_slot = -1;
  for (int k = 0; 16 * k - lead < window; ++k) {
    const unsigned a = (first_chunk + 16u * (unsigned)k) & mask;
    const uint4 bytes = *reinterpret_cast<const uint4*>(state + a);
    const unsigned words[4] = {bytes.x, bytes.y, bytes.z, bytes.w};
    const int off0 = 16 * k - lead;
    unsigned valid = 0xFFFFu;
    if (off0 < 0) valid &= (0xFFFFu << (-off0)) & 0xFFFFu;
    if (off0 + 16 > window) valid &= (1u << (window - off0)) - 1u;
    unsigned empty_m = 0, live_m = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const unsigned b = (words[j >> 2] >> (8 * (j & 3))) & 0xFFu;
      empty_m |= (unsigned)(b == kEmpty) << j;
      live_m |= (unsigned)(b == kLive) << j;
    }
    empty_m &= valid;
    live_m &= valid;
    const unsigned free_m = valid & ~live_m;
    // LIVE slots before the chunk's first EMPTY: the walk compares them
    const unsigned before_empty =
        empty_m ? (1u << (__ffs(empty_m) - 1)) - 1u : 0xFFFFu;
    const unsigned cand = live_m & before_empty;
    if (cand) {
      int4 s[4], d[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if ((cand >> (4 * q)) & 0xFu) {
          s[q] = *reinterpret_cast<const int4*>(src + a + 4 * q);
          d[q] = *reinterpret_cast<const int4*>(dst + a + 4 * q);
        }
      }
      unsigned hit_m = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int sq[4] = {s[q].x, s[q].y, s[q].z, s[q].w};
        const int dq[4] = {d[q].x, d[q].y, d[q].z, d[q].w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int j = 4 * q + t;
          if (((cand >> j) & 1u) && sq[t] == ku && dq[t] == kv)
            hit_m |= 1u << j;
        }
      }
      if (hit_m) return {true, (int)(a + (unsigned)(__ffs(hit_m) - 1))};
    }
    if (free_slot < 0 && free_m)
      free_slot = (int)(a + (unsigned)(__ffs(free_m) - 1));
    if (empty_m) break;
  }
  return {false, free_slot};
}

__device__ __forceinline__ Walk walk(const int* src, const int* dst,
                                     const uint8_t* state, unsigned mask,
                                     int window, int vec, unsigned start,
                                     int ku, int kv) {
  return vec ? walk_chunks(src, dst, state, mask, window, start, ku, kv)
             : walk_slots(src, dst, state, mask, window, start, ku, kv);
}

// repro.core.edge_table._hash: the uint32 mix of (u, v) into [0, C).
__device__ __forceinline__ unsigned slot_of(int ku, int kv, unsigned mask) {
  const unsigned a = (unsigned)ku, b = (unsigned)kv;
  unsigned h = (a * 0x9E3779B1u) ^ (b + 0x85EBCA77u + (a << 6) + (a >> 2));
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  h ^= h >> 12;
  return h & mask;
}

// Adds each thread's n to *target: a warp sum, then one atomic per warp.
// Every thread of the block calls it.
__device__ __forceinline__ void warp_add(int* target, int n) {
  n = __reduce_add_sync(0xFFFFFFFFu, n);
  if ((threadIdx.x & 31) == 0 && n) atomicAdd(target, n);
}

__global__ void __launch_bounds__(kThreads)
probe_walk(const int* __restrict__ src, const int* __restrict__ dst,
           const uint8_t* __restrict__ state, const int* __restrict__ base,
           const int* __restrict__ u, const int* __restrict__ v,
           uint8_t* __restrict__ found, int* __restrict__ slot, int n,
           int b, unsigned mask, int window, int vec) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long off = (long long)(i / b) * ((long long)mask + 1);
  const Walk w = walk(src + off, dst + off, state + off, mask, window, vec,
                      (unsigned)base[i], u[i], v[i]);
  found[i] = w.found;
  slot[i] = w.slot;
}

// counts: int32[max_probes + 2], zeroed.  counts[r] is the number of lanes
// pending at the start of round r; counts[max_probes + 1] gets the number
// of rounds run.  n = T x B lanes, lane i in row i / b; total = T x C.
__global__ void __launch_bounds__(kThreads)
insert_rounds(int* src, int* dst, uint8_t* state, const int* u,
              const int* v, const uint8_t* enable, uint8_t* placed,
              uint8_t* failed, int* claims, int* counts, int n, int b,
              unsigned mask, long long cap, long long total, int window,
              int max_probes, int vec) {
  cg::grid_group grid = cg::this_grid();
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  int pending = 0;
  for (int i = first; i < n; i += stride) {
    bool want = false;
    if (enable[i]) {
      const long long off = (long long)(i / b) * cap;
      const unsigned start = slot_of(u[i], v[i], mask);
      want = !walk(src + off, dst + off, state + off, mask, window, vec,
                   start, u[i], v[i])
                  .found;
      if (want) {
        claims[off + start] = kNoClaim;
        ++pending;
      }
    }
    placed[i] = 0;
    failed[i] = want;  // the pending flag; what stays set has failed
  }
  warp_add(&counts[0], pending);
  grid.sync();
  int r = 0;
  for (; r < max_probes && __ldcg(&counts[r]) > 0; ++r) {
    int* cur = claims + (r & 1) * total;
    int* next = claims + ((r + 1) & 1) * total;
    for (int i = first; i < n; i += stride) {
      if (!failed[i]) continue;
      const long long off = (long long)(i / b) * cap;
      const unsigned pos = (slot_of(u[i], v[i], mask) + (unsigned)r) & mask;
      if (__ldcg(state + off + pos) != kLive) atomicMin(cur + off + pos, i);
    }
    grid.sync();
    pending = 0;
    for (int i = first; i < n; i += stride) {
      if (!failed[i]) continue;
      const int ku = u[i], kv = v[i];
      const long long off = (long long)(i / b) * cap;
      const unsigned pos = (slot_of(ku, kv, mask) + (unsigned)r) & mask;
      // only a lane that contended at pos this round can own its word
      if (__ldcg(cur + off + pos) == i) {
        src[off + pos] = ku;
        dst[off + pos] = kv;
        state[off + pos] = kLive;
        placed[i] = 1;
        failed[i] = 0;
      } else {
        ++pending;
        next[off + ((pos + 1u) & mask)] = kNoClaim;
      }
    }
    warp_add(&counts[r + 1], pending);
    grid.sync();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) counts[max_probes + 1] = r;
}

// slots: int32[T x B] scratch (each lane's hit slot in its row, or -1);
// claims: int32[T x C].
__global__ void __launch_bounds__(kThreads)
remove_first(const int* src, const int* dst, uint8_t* state, const int* u,
             const int* v, const uint8_t* enable, uint8_t* removed,
             int* slots, int* claims, int n, int b, unsigned mask,
             int window, int vec) {
  cg::grid_group grid = cg::this_grid();
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const long long cap = (long long)mask + 1;
  for (int i = first; i < n; i += stride) {
    int s = -1;
    if (enable[i]) {
      const int ku = u[i], kv = v[i];
      const long long off = (long long)(i / b) * cap;
      const Walk w = walk(src + off, dst + off, state + off, mask, window,
                          vec, slot_of(ku, kv, mask), ku, kv);
      if (w.found) {
        s = w.slot;
        claims[off + s] = kNoClaim;
      }
    }
    slots[i] = s;
  }
  grid.sync();
  for (int i = first; i < n; i += stride)
    if (slots[i] >= 0)
      atomicMin(claims + (long long)(i / b) * cap + slots[i], i);
  grid.sync();
  for (int i = first; i < n; i += stride) {
    const int s = slots[i];
    const long long at = (long long)(i / b) * cap + s;
    const bool won = s >= 0 && __ldcg(claims + at) == i;
    if (won) state[at] = kTomb;
    removed[i] = won;
  }
}

// The cooperative grid: one block per 256 lanes, at most the co-resident
// blocks of the card; the lanes beyond that are grid-strided.
template <typename Kernel>
cudaError_t coop_grid(Kernel kernel, int b, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return err;
  const long long want = ((long long)b + kThreads - 1) / kThreads;
  long long most = (long long)per_sm * sms;
  if (most < 1) most = 1;
  *grid = (int)(want < most ? (want > 0 ? want : 1) : most);
  return cudaSuccess;
}

int window_of(long long cap, int max_probes) {
  return (int)(max_probes < cap ? max_probes : cap);
}

int chunked(const void* src, const void* dst, const void* state,
            long long cap) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  return cap >= 16 && aligned(src) && aligned(dst) && aligned(state);
}

cudaError_t launched(cudaError_t err) {
  cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

}  // namespace

// src/dst int32[T, C], state int8[T, C], base/u/v int32[T, B] -> found
// uint8[T, B] (a torch.bool buffer), slot int32[T, B] (row-local).  C is a
// power of two.
extern "C" int hash_probe_launch(const void* src, const void* dst,
                                 const void* state, const void* base,
                                 const void* u, const void* v, void* found,
                                 void* slot, int t, int b, long long cap,
                                 int max_probes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = t * b;
  if (n > 0)
    probe_walk<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        static_cast<const int*>(src), static_cast<const int*>(dst),
        static_cast<const uint8_t*>(state), static_cast<const int*>(base),
        static_cast<const int*>(u), static_cast<const int*>(v),
        static_cast<uint8_t*>(found), static_cast<int*>(slot), n, b,
        (unsigned)(cap - 1), window_of(cap, max_probes),
        chunked(src, dst, state, cap));
  return (int)cudaGetLastError();
}

// Writes into src/dst/state [T, C].  u/v int32[T, B], enable uint8[T, B]
// (deduplicated within each row), placed and failed uint8[T, B] out;
// claims int32[2 T C] and counts int32[max_probes + 2] (zeroed) scratch.
extern "C" int hash_insert_launch(void* src, void* dst, void* state,
                                  const void* u, const void* v,
                                  const void* enable,
                                  void* placed, void* failed, void* claims,
                                  void* counts, int t, int b, long long cap,
                                  int max_probes, void* stream) {
  int n = t * b;
  if (n <= 0) return (int)cudaGetLastError();
  int grid = 0;
  cudaError_t err = coop_grid(insert_rounds, n, &grid);
  if (err != cudaSuccess) return (int)err;
  int* p_src = static_cast<int*>(src);
  int* p_dst = static_cast<int*>(dst);
  uint8_t* p_state = static_cast<uint8_t*>(state);
  const int* p_u = static_cast<const int*>(u);
  const int* p_v = static_cast<const int*>(v);
  const uint8_t* p_en = static_cast<const uint8_t*>(enable);
  uint8_t* p_placed = static_cast<uint8_t*>(placed);
  uint8_t* p_failed = static_cast<uint8_t*>(failed);
  int* p_claims = static_cast<int*>(claims);
  int* p_counts = static_cast<int*>(counts);
  unsigned mask = (unsigned)(cap - 1);
  long long total = (long long)t * cap;
  int window = window_of(cap, max_probes);
  int vec = chunked(src, dst, state, cap);
  void* args[] = {&p_src,    &p_dst,    &p_state,  &p_u,      &p_v,
                  &p_en,     &p_placed, &p_failed, &p_claims, &p_counts,
                  &n,        &b,        &mask,     &cap,      &total,
                  &window,   &max_probes, &vec};
  return (int)launched(cudaLaunchCooperativeKernel(
      (const void*)insert_rounds, dim3(grid), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream)));
}

// Writes TOMB into state [T, C].  removed uint8[T, B] out; slots
// int32[T, B] and claims int32[T, C] scratch.
extern "C" int hash_remove_launch(const void* src, const void* dst,
                                  void* state, const void* u, const void* v,
                                  const void* enable, void* removed,
                                  void* slots, void* claims, int t, int b,
                                  long long cap, int max_probes,
                                  void* stream) {
  int n = t * b;
  if (n <= 0) return (int)cudaGetLastError();
  int grid = 0;
  cudaError_t err = coop_grid(remove_first, n, &grid);
  if (err != cudaSuccess) return (int)err;
  const int* p_src = static_cast<const int*>(src);
  const int* p_dst = static_cast<const int*>(dst);
  uint8_t* p_state = static_cast<uint8_t*>(state);
  const int* p_u = static_cast<const int*>(u);
  const int* p_v = static_cast<const int*>(v);
  const uint8_t* p_en = static_cast<const uint8_t*>(enable);
  uint8_t* p_removed = static_cast<uint8_t*>(removed);
  int* p_slots = static_cast<int*>(slots);
  int* p_claims = static_cast<int*>(claims);
  unsigned mask = (unsigned)(cap - 1);
  int window = window_of(cap, max_probes);
  int vec = chunked(src, dst, state, cap);
  void* args[] = {&p_src,     &p_dst,     &p_state, &p_u,      &p_v,
                  &p_en,      &p_removed, &p_slots, &p_claims, &n,
                  &b,         &mask,      &window,  &vec};
  return (int)launched(cudaLaunchCooperativeKernel(
      (const void*)remove_first, dim3(grid), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream)));
}
