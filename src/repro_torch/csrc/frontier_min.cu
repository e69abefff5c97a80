// frontier_min: one round of frontier expansion in the min-semiring.
//
// Gather form (every reachability round of the port):
//
//   out[f, v] = min{ val[f, src[e]] : live[e], dst[e] == v,
//                    0 <= src[e] < n_src, 0 <= dst[e] < nv },
//
// SENTINEL (0xFFFFFFFF) where nothing lands.  Values are uint32 held in
// 32-bit words.  Direct form (the counterpart of the TPU kernel's own
// signature): out[f, v] = min(msg[f, e] : dst[e] == v), messages given per
// edge as uint32 values carried in int64.
//
// Replaces the TPU kernel segment_min_u32
// (src/repro/kernels/frontier_expand/kernel.py:54), which sweeps the vertex
// space in one-hot panels because the TPU lacks a fast scatter, and reads
// messages that XLA built per edge before the call.  Hopper has atomics on
// device memory, so the natural form is a scatter: one thread per edge.
//
// Bound: bytes.  The gather form reads src, dst (4 B each) and live (1 B)
// once per edge slot, val once per vertex and writes out once per vertex:
// 9 E + 8 F NV bytes over 3.35 TB/s (E = 2^23, NV = 2^20: 0.025 ms).  What
// the design does about it:
// - The message is gathered inside the kernel (val[src[e]], a vertex-sized
//   array that stays in the 50 MB L2), so no E-sized message array is ever
//   written or read: the unfused round built an int64 [F, E] array in
//   torch first, 64 MB at F = 1 and 2.1 GB at F = 32.
// - Values are 32-bit words and the atomic is the 32-bit one.
// - Each thread loads kUnroll edges' src, dst and live before it uses any,
//   then gathers all kUnroll values, then reads all kUnroll output words,
//   so each dependent step has several loads in flight per thread.
// - Before an atomic the thread reads the output word (from L2, where the
//   atomics resolve) and skips the atomic when it cannot lower it.  Min and
//   OR are monotone: a stale read is never below the current word, so it
//   costs an atomic, never a wrong answer.  A SENTINEL message reads
//   nothing.
// - Reachable batches (F frontiers, messages only 0 or SENTINEL) run in OR
//   mode: the frontiers are packed 32 to a word, bit q of word w being
//   frontier 32 w + q, and min over 0 / SENTINEL is OR over reached bits.
//   One atomicOr per edge and word replaces F serial atomicMins, and the
//   F = 32 round reads 4 B of val per vertex instead of 128.
// - Pair mode runs the two directions of a fused FW/BW round in one launch:
//   row 0 along src -> dst, row 1 along dst -> src, one read of the edges.
// Min and OR do not depend on the order the atomics land in, so every
// result is exact.  On the card the gather form stays above its DRAM bound
// where many edges carry a message (a label round): each such edge costs
// three random 4-byte accesses to L2 (the gather, the read, the atomic),
// one 32-byte sector each, and the read waits before its atomic can issue.
// The direct form keeps the port's first design: one thread per edge, F
// serial 64-bit atomicMins.
//
// Tenant rows (the gather form).  src, dst and live are [T, E] and hold
// row-local vertex ids, val is [T, F, n_src] and out [T, F, nv]: edge e of
// row t reads val[t, f, src[t, e]] and writes out[t, f, dst[t, e]].  The
// kernel adds the row offsets itself, one division per edge, so values
// never cross rows and nobody builds offset copies of the edges.  T = 1 is
// the single-graph call.
//
// Fixpoint form (every sweep of core/reach.py and scc.trim on the card).
// Replaces the lax.while_loop that the JAX package runs each sweep in
// (src/repro/core/reach.py:41 _fixpoint; scc.py:56 trim through it).  One
// persistent cooperative launch runs all rounds, each an edge pass, a grid
// barrier, the vertex pass (each word's update, which resets its gather
// word and notes a change; hop forms one more barrier and the pointer-
// doubling hop), a barrier, then every thread reads whether any lane
// changed.  The round count and the cap are JAX's exactly; tenant lanes
// freeze after their first unchanged round.  The scc form runs a whole
// static SCC (trim and both sweeps, round after outer round) in one launch
// the same way (see scc_rounds).
//
// Bound: bytes.  Its first design streamed the whole table (9 B a slot,
// 75.5 MB at update_1m, more than the 50 MB L2) from device memory every
// round at 2-3 blocks an SM: 74-120 us a round's edge pass, and 23-68 us
// a vertex pass over 2^20 words (PERF.md, section 6).  What this design
// does:
// - The first round reads the table once and lists, per row, the edges
//   that can carry a message in a later round (live, ids in range, both
//   ends inside the mask; trim: both ends unassigned) as (src, dst) pairs,
//   8 B an edge, one atomic a block and tile on the row's count; later
//   rounds read only the list (2^21 edges, 16.8 MB at update_1m, which
//   stays in L2 beside the vertex arrays).
// - After the first round a source sends only if its word changed in the
//   previous round (``last``, the round mod 256; a stale match only sends
//   a message again).  The states are monotone, so an unchanged source's
//   message reached its targets in the round after it last changed and
//   each is at or below it since: every state and round count is exact.
// - Trim keeps in- and out-degrees over the edges whose ends are both
//   unassigned: counted in the first round, an edge uncounted in the round
//   after one of its ends was peeled (its un byte 2 for that one round),
//   so a round's atomics are those of the edges that just died.
// - The vertex pass visits only words a message reached (trim and the hop
//   forms all); each block takes a contiguous span of words, so a thread
//   flushes one or two lanes' change flags.
// - Tenant rows are walked in tiles of one row, so a frozen lane's edges
//   are skipped unread and row offsets are added once a tile.
// - No read before an atomic: the atomics are fire-and-forget reductions,
//   and every form ran as fast or faster without the read (PERF.md).
// The grid is the co-resident one, held to four blocks an SM
// (__launch_bounds__); the barriers cost ~1 us each.  nvcc -Xptxas -v
// (sm_90a): every fixpoint_rounds instance 64 registers, spill stores
// and loads of 28 B (reach), 24 (or), 4 (trim), none (pair, label,
// prio); scc_rounds 80 registers, 48 B stores and 112 B loads (min
// labels), 56 and 176 (priorities).  Buffers the launch
// rewrites are read through L2 (__ldcg), never the read-only path, which
// may keep last round's words.  The launch's bound reads the table (9 B
// a slot), the mask and the state once and writes the state once; the
// rounds times a round's table and state bytes, the bound its first
// design was held to, stands beside it (chip_smoke's rows).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kSent32 = 0xFFFFFFFFu;
constexpr unsigned long long kSentinel = 0xFFFFFFFFull;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // edges per thread per pass, loaded together

enum Mode { kMin = 0, kPair = 1, kOr = 2 };

int blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  const long long cap = 132LL * 32;  // enough resident blocks for 132 SMs
  return (int)(b < cap ? (b > 0 ? b : 1) : cap);
}

// ------------------------------------------------------------ gather ---

template <int kMode>
__device__ __forceinline__ unsigned identity() {
  return kMode == kOr ? 0u : kSent32;
}

// whether writing v into a word that holds cur changes it
template <int kMode>
__device__ __forceinline__ bool lowers(unsigned v, unsigned cur) {
  return kMode == kOr ? (v & ~cur) != 0u : v < cur;
}

// One pass over the edge slots, grid-strided: out[row, f, to] <- min (OR)
// msg(row, f, from) along every live edge whose ids fall in range.  ``msg``
// gives each edge's message (the identity drops it) and ``msg.lane(row)``
// whether row takes part at all.
template <int kMode, class Msg>
__device__ __forceinline__ void gather_edges(
    const int* __restrict__ src, const int* __restrict__ dst,
    const uint8_t* __restrict__ live, const Msg& msg, unsigned* out,
    long long e, long long total, int f, int n_src, int nv) {
  const long long tile = (long long)kThreads * kUnroll;
  for (long long base = blockIdx.x * tile + threadIdx.x; base < total;
       base += (long long)gridDim.x * tile) {
    int s[kUnroll], d[kUnroll];
    bool ok[kUnroll];
    long long row[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = base + (long long)k * kThreads;
      const bool in = i < total;
      // one row (T = 1) skips the 64-bit division
      row[k] = in && total != e ? i / e : 0;
      s[k] = in ? src[i] : -1;
      d[k] = in ? dst[i] : -1;
      // unsigned compares drop -1 padding and junk slots in one test
      ok[k] = in && msg.lane(row[k]) && live[i] &&
              (unsigned)s[k] < (unsigned)n_src && (unsigned)d[k] < (unsigned)nv;
    }
    // each step is issued for all kUnroll edges before the next one waits
    // on it: gather the values, read the words they would lower, then
    // issue the atomics that change something
    for (int r = 0; r < f; ++r) {
      unsigned v[kUnroll], cur[kUnroll];
      unsigned* o[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        // pair mode (n_src == nv): row 1 runs along dst -> src
        const bool back = kMode == kPair && r == 1;
        const int from = back ? d[k] : s[k], to = back ? s[k] : d[k];
        v[k] = ok[k] ? msg(row[k], r, from) : identity<kMode>();
        o[k] = out + (row[k] * f + r) * nv + to;
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k)
        cur[k] = v[k] != identity<kMode>() ? __ldcg(o[k]) : v[k];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (!lowers<kMode>(v[k], cur[k])) continue;
        if (kMode == kOr)
          atomicOr(o[k], v[k]);
        else
          atomicMin(o[k], v[k]);
      }
    }
  }
}

// The gather form's messages: val[row, f, src], read once, never written.
struct ValMsg {
  const unsigned* __restrict__ val;
  int f, n_src;
  __device__ bool lane(long long) const { return true; }
  __device__ unsigned operator()(long long row, int r, int from) const {
    return __ldg(val + (row * f + r) * n_src + from);
  }
};

template <int kMode>
__global__ void __launch_bounds__(kThreads)
    gather_rows(const int* __restrict__ src, const int* __restrict__ dst,
                const uint8_t* __restrict__ live,
                const unsigned* __restrict__ val, unsigned* out, long long e,
                long long total, int f, int n_src, int nv) {
  gather_edges<kMode>(src, dst, live, ValMsg{val, f, n_src}, out, e, total,
                      f, n_src, nv);
}

// ---------------------------------------------------------- fixpoint ---

enum Form { kReach = 0, kPairForm = 1, kLabel = 2, kPrio = 3, kOrForm = 4,
            kTrim = 5, kScc = 6 };
constexpr int kInt32Max = 0x7FFFFFFF;
constexpr unsigned kPrioInv = 0x0E8B2F51u;  // 0x9E3779B1^-1 mod 2^32
constexpr int kMaxLanes = 32 * 1024;  // one byte of shared memory a lane
constexpr int kTile = kThreads * kUnroll;  // edges a block takes at once
constexpr int kFixBlocks = 4;  // blocks an SM the fixpoint forms are held to

struct FixArgs {
  const int* src;
  const int* dst;
  const uint8_t* live;
  const uint8_t* mask;  // allowed / active, [T, nv]; null for trim
  void* state;          // [T, f, nv]: bytes (reach, pair, trim) or words
  int* ccid;            // trim: [T, nv]
  const int* vid;       // trim: [nv]
  unsigned* out;        // [T, f, nv] scratch: the round's gather
  unsigned* hop;        // [T, nv] scratch: a round's labels before the hop
  int* flags;           // [4 T + 2] scratch, see fixpoint_body
  int* rounds;          // [T] out
  unsigned long long* tally;  // [7] or null: rounds run, by form
  unsigned long long* stamps;  // null, or part stamps (see Stamps)
  int2* list;           // [T, e] scratch: each row's listed edges (src, dst)
  int* count;           // [T] scratch: the edges listed in each row
  unsigned char* last;  // [T, f, nv] scratch: the round each word last
                        // changed in, mod 256
  long long e, total;   // edges a row, T * e
  int t, f, nv, shortcut, max_iters;
  int n_stamps;         // records the stamps buffer holds
  int compact;          // 1: the first round reads the slots and lists the
                        // edges; 0: it reads the list a sweep before made
  int reverse;          // walk the listed edges dst -> src
};

// Part stamps, for measurement only: every main-path launch passes null
// and takes none of these branches.  Each grid barrier of a launch is one
// record of four words: its kind, the first and the last block's arrival
// and the time block 0 left it (%globaltimer, ns).  Words 0-3 of the
// buffer hold the grid, the records written, the launch's first and its
// last stamp.  The caller fills the arrival words with ~0 and 0.
enum Part { kInit = 1, kEdgePass = 2, kVertexPass = 3, kHopPass = 4,
            kSccPass = 5, kCompactPass = 6 };

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

struct Stamps {
  unsigned long long* buf;
  int cap, k = 0;
  __device__ Stamps(unsigned long long* b, int c) : buf(b), cap(c) {
    if (buf != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
      buf[0] = gridDim.x;
      buf[2] = global_ns();
    }
  }
  // a grid barrier of the given kind, stamped when a buffer was given
  __device__ void sync(cg::grid_group& grid, int kind) {
    unsigned long long* rec = buf != nullptr && k < cap ? buf + 4 + 4 * k
                                                        : nullptr;
    if (rec != nullptr) {
      __syncthreads();
      if (threadIdx.x == 0) {
        const unsigned long long t = global_ns();
        atomicMin(rec + 1, t);
        atomicMax(rec + 2, t);
      }
    }
    grid.sync();
    if (rec != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
      rec[0] = (unsigned long long)kind;
      rec[3] = global_ns();
      buf[1] = (unsigned long long)(k + 1);
    }
    ++k;
  }
  __device__ void finish() {
    if (buf != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
      buf[3] = global_ns();
  }
};

template <int kForm>
__host__ __device__ constexpr int mode_of() {
  return kForm == kPairForm ? kPair : (kForm == kOrForm ? kOr : kMin);
}

// i / d for the vertex passes' word indices: 32-bit where both fit
__device__ __forceinline__ long long quot(long long i, long long d,
                                          bool small) {
  return small ? (long long)((unsigned)i / (unsigned)d) : i / d;
}

// The contiguous span of a vertex pass's n words that this block takes:
// a thread's words then fall in one or two lanes, so it flushes one or
// two change notes (grid-strided, every thread touched many lanes, and
// their flags took ~10^6 atomics a round over 256 lanes).
__device__ __forceinline__ void block_span(long long n, long long& lo,
                                           long long& hi) {
  const long long per = (n + gridDim.x - 1) / gridDim.x;
  lo = min(n, blockIdx.x * per);
  hi = min(n, lo + per);
}

// What word w of the state sends along an edge: 0 when reached (reach,
// pair), else the word.  The state is rewritten inside the launch, so it
// is read through L2 (__ldcg): the read-only path could hand back last
// round's words.
template <int kForm>
__device__ __forceinline__ unsigned message(const FixArgs& a, long long w) {
  if (kForm == kReach || kForm == kPairForm)
    return __ldcg(static_cast<const unsigned char*>(a.state) + w)
               ? 0u : kSent32;
  return __ldcg(static_cast<const unsigned*>(a.state) + w);
}

// One round's edge pass, tile by tile, a tile being kTile edges of one
// row, so a row that stopped is skipped unread and the row offsets are
// added once a tile.  kSlots: the sweep's first round, over the table's
// slots: every live slot whose ids fall in range carries its source's
// message to a target inside the mask, and the slots that can carry one
// in a later round go to the row's list (both ends inside the mask: only
// a vertex inside it ever changes, and a message to one outside it is
// dropped; trim: both ends unassigned).  Else over the list, where a
// source sends only if it changed in the previous round (every source in
// a sweep's first round): the states are monotone, so an unchanged
// source's message reached its targets in the round after it last
// changed, and each is at or below it since.  Min and OR do not depend on
// the order the atomics land in, so the list's order changes nothing.
template <int kForm, bool kSlots>
__device__ __forceinline__ void edge_pass(const FixArgs& a,
                                          const unsigned char* act, int it) {
  constexpr int kMode = mode_of<kForm>();
  constexpr int kWarps = kThreads / 32;
  __shared__ int s_list[kWarps + 1];  // each warp's place, the tile's base
  const int nv = a.nv;
  const long long per_row = (a.e + kTile - 1) / kTile;
  long long tiles = a.t * per_row;
  if (!kSlots && a.t == 1) tiles = (__ldcg(a.count) + kTile - 1) / kTile;
  const unsigned char prev = (unsigned char)(it - 1);
  const unsigned lane_lt = (1u << (threadIdx.x & 31)) - 1u;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    // block-uniform: every thread of the block takes the same branch
    const long long row = a.t == 1 ? 0 : tile / per_row;
    if (!act[row]) continue;
    const long long k0 = (tile - row * per_row) * kTile;
    const long long n_row = kSlots ? a.e : __ldcg(a.count + row);
    if (k0 >= n_row) continue;
    const long long base = row * a.e;
    int s[kUnroll], d[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long j = k0 + k * kThreads + threadIdx.x;
      const bool in = j < n_row;
      if (kSlots) {
        s[k] = in ? a.src[base + j] : -1;
        d[k] = in ? a.dst[base + j] : -1;
        // unsigned compares drop -1 padding and junk slots in one test
        ok[k] = in && a.live[base + j] && (unsigned)s[k] < (unsigned)nv &&
                (unsigned)d[k] < (unsigned)nv;
      } else {
        const int2 ed = in ? __ldcg(a.list + base + j) : make_int2(0, 0);
        s[k] = a.reverse ? ed.y : ed.x;
        d[k] = a.reverse ? ed.x : ed.y;
        ok[k] = in;
      }
    }
    // the row's mask (trim: the unassigned set); the scc form rewrites
    // it between sweeps, so it too is read through L2
    const uint8_t* m = (kForm == kTrim ? static_cast<const uint8_t*>(a.state)
                                       : a.mask) + row * nv;
    bool ms[kUnroll] = {}, md[kUnroll] = {};
    if (kSlots) {
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        ms[k] = ok[k] && __ldcg(m + s[k]);
        md[k] = ok[k] && __ldcg(m + d[k]);
      }
      // list the kept edges: one atomic a block and tile (one a warp
      // serialised ~2.6 10^5 atomics on update_1m's one counter)
      const int warp = threadIdx.x >> 5;
      unsigned b[kUnroll];
      int kept = 0;
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        b[k] = __ballot_sync(0xFFFFFFFFu, ms[k] && md[k]);
        kept += __popc(b[k]);
      }
      if ((threadIdx.x & 31) == 0) s_list[warp] = kept;
      __syncthreads();
      if (threadIdx.x == 0) {
        int sum = 0;
        for (int w = 0; w < kWarps; ++w) {
          const int c = s_list[w];
          s_list[w] = sum;
          sum += c;
        }
        s_list[kWarps] = sum > 0 ? atomicAdd(a.count + row, sum) : 0;
      }
      __syncthreads();
      int at = s_list[kWarps] + s_list[warp];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (ms[k] && md[k])
          a.list[base + at + __popc(b[k] & lane_lt)] = make_int2(s[k], d[k]);
        at += __popc(b[k]);
      }
      __syncthreads();  // s_list is rewritten for the next tile
    }
    if (kForm == kTrim) {
      // degrees over the edges whose ends are both unassigned: counted in
      // the first round, then each edge uncounted in the round after one
      // of its ends was peeled (un 2), so a round's atomics are those of
      // the edges that just died, not one a live edge
      unsigned* in_deg = a.out + row * nv;
      unsigned* out_deg = a.hop + row * nv;
      if (kSlots) {
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          if (!(ms[k] && md[k])) continue;
          atomicAdd(in_deg + d[k], 1u);
          atomicAdd(out_deg + s[k], 1u);
        }
      } else {
        unsigned char us[kUnroll], ud[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          us[k] = ok[k] ? __ldcg(m + s[k]) : 0;
          ud[k] = ok[k] ? __ldcg(m + d[k]) : 0;
        }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          if (!us[k] || !ud[k] || (us[k] != 2 && ud[k] != 2)) continue;
          if (ud[k] == 1) atomicSub(in_deg + d[k], 1u);
          if (us[k] == 1) atomicSub(out_deg + s[k], 1u);
        }
      }
      continue;
    }
    // each step is issued for all kUnroll edges before the next one waits
    // on it: the sources' change rounds, their messages, the words they
    // would lower, then the atomics that change something
    for (int r = 0; r < a.f; ++r) {
      // pair: row 1 runs along dst -> src
      const bool back = kForm == kPairForm && r == 1;
      const long long off = (row * a.f + r) * nv;
      bool send[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (kSlots)  // labels and priorities send only from inside the mask
          send[k] = kForm == kLabel || kForm == kPrio ? ms[k] && md[k]
                                                      : (back ? ms[k] : md[k]);
        else
          send[k] = ok[k] && (it == 0 ||
                              __ldcg(a.last + off + (back ? d[k] : s[k])) ==
                                  prev);
      }
      unsigned v[kUnroll];
      unsigned* o[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        v[k] = send[k] ? message<kForm>(a, off + (back ? d[k] : s[k]))
                       : identity<kMode>();
        o[k] = a.out + off + (back ? s[k] : d[k]);
      }
      // no read before the atomic (PERF.md: faster or equal in every form)
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (v[k] == identity<kMode>()) continue;
        if (kMode == kOr)
          atomicOr(o[k], v[k]);
        else
          atomicMin(o[k], v[k]);
      }
    }
  }
}

// Which lanes a thread changed, flushed one atomic per lane it touched;
// a block whose changes all fall in one lane flushes once.
struct Changes {
  long long row = -1;
  bool pending = false, any = false;
  __device__ void note(long long r, bool changed, int* lane_flag) {
    if (r != row) {
      if (pending) atomicOr(lane_flag + row, 1);
      row = r;
      pending = false;
    }
    pending |= changed;
    any |= changed;
  }
  __device__ void flush(int* lane_flag, int* any_flag, long long* s_row) {
    if (threadIdx.x == 0) *s_row = -1;
    __syncthreads();
    if (pending) *s_row = row;
    __syncthreads();
    const long long rep = *s_row;
    if (__syncthreads_and(!pending || row == rep)) {
      if (threadIdx.x == 0 && rep >= 0) atomicOr(lane_flag + rep, 1);
    } else if (pending) {
      atomicOr(lane_flag + row, 1);
    }
    if (__syncthreads_or(any) && threadIdx.x == 0) atomicOr(any_flag, 1);
  }
};

// The round's update of word i (lane row, vertex v) from the gathered
// word ``inc``; hop forms leave the update in a.hop and finish it in
// hop_update after a grid barrier.  Notes whether the state changed, and
// stamps a changed word with the round in a.last.
template <int kForm>
__device__ __forceinline__ void update(const FixArgs& a, long long i,
                                       long long row, long long mv,
                                       unsigned inc, bool hop, int it,
                                       Changes& ch, int* lane_flag) {
  if (kForm == kReach || kForm == kPairForm) {
    auto* st = static_cast<unsigned char*>(a.state);
    const unsigned char old = __ldcg(st + i);
    const unsigned char nxt = old | (inc == 0u && __ldcg(a.mask + mv));
    if (nxt != old) {
      st[i] = nxt;
      a.last[i] = (unsigned char)it;
    }
    ch.note(row, nxt != old, lane_flag);
  } else if (kForm == kOrForm) {
    auto* st = static_cast<unsigned*>(a.state);
    const unsigned old = __ldcg(st + i);
    const unsigned nxt = old | (__ldcg(a.mask + mv) ? inc : 0u);
    if (nxt != old) {
      st[i] = nxt;
      a.last[i] = (unsigned char)it;
    }
    ch.note(row, nxt != old, lane_flag);
  } else if (kForm == kTrim) {
    // un: 1 unassigned, 2 peeled in the previous round (its edges were
    // uncounted in this round's edge pass), 0 assigned
    auto* un = static_cast<unsigned char*>(a.state);
    const unsigned char u = __ldcg(un + i);
    bool peel = false;
    if (u == 2) {
      un[i] = 0;
    } else if (u == 1) {
      peel = __ldcg(a.out + i) == 0u || __ldcg(a.hop + i) == 0u;
      if (peel) {
        un[i] = 2;
        a.ccid[i] = __ldg(a.vid + (mv - row * a.nv));
      }
    }
    ch.note(row, peel, lane_flag);
  } else if (kForm == kLabel) {
    auto* st = static_cast<int*>(a.state);
    const int old = __ldcg(st + i);
    int in = (int)inc;
    if (in < 0) in = kInt32Max;  // a uint32 >= 2^31 clamps to INT32_MAX
    const int nxt = __ldcg(a.mask + mv) ? min(old, in) : old;
    if (hop) {
      a.hop[i] = (unsigned)nxt;
      return;
    }
    if (nxt != old) {
      st[i] = nxt;
      a.last[i] = (unsigned char)it;
    }
    ch.note(row, nxt != old, lane_flag);
  } else {  // kPrio
    const unsigned old = __ldcg(static_cast<unsigned*>(a.state) + i);
    a.hop[i] = __ldcg(a.mask + mv) ? min(old, inc) : old;
  }
}

// The pointer-doubling hop: lab[v] <- min(lab[v], lab[w]) through the
// vertex w a label names (label: the label itself; prio: its preimage).
template <int kForm>
__device__ __forceinline__ void hop_update(const FixArgs& a, long long i,
                                           long long row, long long mv,
                                           int it, Changes& ch,
                                           int* lane_flag) {
  const unsigned nxt = __ldcg(a.hop + i);
  const bool on = __ldcg(a.mask + mv);
  long long w;
  bool jump;
  if (kForm == kLabel) {
    w = (int)nxt;
    jump = on && (int)nxt < kInt32Max;
  } else {
    w = (int)(nxt * kPrioInv);
    jump = on && nxt != kSent32;
  }
  w = w < 0 ? 0 : (w > a.nv - 1 ? a.nv - 1 : w);
  unsigned fin = nxt;
  if (jump) {
    const unsigned h = __ldcg(a.hop + row * a.nv + w);
    fin = kForm == kLabel ? (unsigned)min((int)nxt, (int)h) : min(nxt, h);
  }
  auto* st = static_cast<unsigned*>(a.state);
  const unsigned old = __ldcg(st + i);
  if (fin != old) {
    st[i] = fin;
    a.last[i] = (unsigned char)it;
  }
  ch.note(row, fin != old, lane_flag);
}

// Every round of one fixpoint, JAX's ``while changed & (it < max_iters)``,
// run by the whole cooperative grid.  A round: the edge pass into out
// (grid barrier), each vertex word's update, which resets its out word
// for the next round and notes a change (a barrier; hop forms one more
// before the hop), then every thread reads whether any lane changed.  The
// first round's edge pass lists the edges (with a.compact; else a list
// is given), later rounds read only the list.  Returns the rounds run
// (the most any lane ran) and adds them to tally[kForm].
//
// flags: L[2][T] (lane ran in the round of that parity), C[2][T] (lane
// changed in it), G[2] (some lane changed).  Lane t runs round r when it
// ran round r - 1 and changed there: L[q] & C[q] with q the parity of
// r - 1, both untouched during round r (round -1 is ``lane_on``, all ones
// when it is null).  Round r writes L[p] and zeroes C[p] and G[p] (p = r &
// 1) before its first barrier; they were last read in round r - 1.  A lane
// that stopped is frozen: its edges and words are skipped, so it writes
// nothing more.  After the last barrier only G is read, and a following
// call writes G only after its own first barrier, so the scc form can call
// this again at once.
template <int kForm>
__device__ __forceinline__ int fixpoint_body(const FixArgs& a,
                                             unsigned char* act,
                                             long long* s_row,
                                             const int* lane_on,
                                             Stamps& st) {
  cg::grid_group grid = cg::this_grid();
  const long long first = blockIdx.x * (long long)kThreads + threadIdx.x;
  const long long step = (long long)gridDim.x * kThreads;
  const int t = a.t;
  const long long fnv = (long long)a.f * a.nv;
  const long long n = t * fnv;
  const bool small = n <= 0xFFFFFFFFLL;
  const bool hop = kForm == kPrio || (kForm == kLabel && a.shortcut);
  const unsigned ident = mode_of<kForm>() == kOr || kForm == kTrim
                             ? 0u : kSent32;
  int* lanes_ran = a.flags;
  int* lanes_changed = a.flags + 2 * t;
  int* any_changed = a.flags + 4 * t;
  long long lo, hi;
  block_span(n, lo, hi);
  for (long long i = first; i < n; i += step) {
    a.out[i] = ident;
    if (kForm == kTrim) a.hop[i] = 0u;  // trim: in- and out-degrees
  }
  for (long long i = first; i < t; i += step) {
    const int on = lane_on == nullptr ? 1 : __ldcg(lane_on + i);
    lanes_ran[t + i] = on;
    lanes_changed[t + i] = on;
    a.rounds[i] = 0;
    if (a.compact) a.count[i] = 0;
  }
  st.sync(grid, kInit);
  int it = 0;
  while (it < a.max_iters) {
    const int p = it & 1, q = p ^ 1;
    for (int i = threadIdx.x; i < t; i += kThreads)
      act[i] = __ldcg(lanes_ran + q * t + i) &&
               __ldcg(lanes_changed + q * t + i);
    __syncthreads();
    for (long long i = first; i < t; i += step) {
      lanes_ran[p * t + i] = act[i];
      lanes_changed[p * t + i] = 0;
      a.rounds[i] += act[i];
    }
    if (first == 0) any_changed[p] = 0;
    const bool slots = it == 0 && a.compact;
    if (slots)
      edge_pass<kForm, true>(a, act, it);
    else
      edge_pass<kForm, false>(a, act, it);
    st.sync(grid, slots ? kCompactPass : kEdgePass);
    Changes ch;
    int* lane_flag = lanes_changed + p * t;
    for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
      const long long row = t == 1 ? 0 : quot(i, fnv, small);
      if (!act[row]) continue;
      const unsigned inc = kForm == kTrim ? 0u : __ldcg(a.out + i);
      // nothing arrived: the word keeps its value (trim and the hop forms
      // still visit it; trim's degrees stay from round to round)
      if (inc == ident && !hop && kForm != kTrim) continue;
      if (inc != ident) a.out[i] = ident;
      const long long mv =
          a.f == 1 ? i : row * a.nv + (i - quot(i, a.nv, small) * a.nv);
      update<kForm>(a, i, row, mv, inc, hop, it, ch, lane_flag);
    }
    if (hop) {
      st.sync(grid, kVertexPass);
      for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
        const long long row = t == 1 ? 0 : quot(i, fnv, small);
        if (!act[row]) continue;
        const long long mv =
            a.f == 1 ? i : row * a.nv + (i - quot(i, a.nv, small) * a.nv);
        hop_update<kForm>(a, i, row, mv, it, ch, lane_flag);
      }
    }
    ch.flush(lane_flag, any_changed + p, s_row);
    st.sync(grid, hop ? kHopPass : kVertexPass);
    ++it;
    if (!__ldcg(any_changed + p)) break;
  }
  // trim: the last round's peels are assigned (each thread its own span's
  // words, which the scc form's next pass reads from the same thread)
  if (kForm == kTrim)
    for (long long i = lo + threadIdx.x; i < hi; i += kThreads)
      if (__ldcg(static_cast<unsigned char*>(a.state) + i) == 2)
        static_cast<unsigned char*>(a.state)[i] = 0;
  if (first == 0 && a.tally != nullptr)
    atomicAdd(a.tally + kForm, (unsigned long long)it);
  return it;
}

template <int kForm>
__global__ void __launch_bounds__(kThreads, kFixBlocks) fixpoint_rounds(
    FixArgs a) {
  extern __shared__ unsigned char act[];
  __shared__ long long s_row;
  Stamps st(a.stamps, a.n_stamps);
  fixpoint_body<kForm>(a, act, &s_row, nullptr, st);
  st.finish();
}

// ------------------------------------------------------- static SCC ---
//
// The scc form: the whole of scc_static in one cooperative launch.
// Replaces the lax.while_loop of the JAX package's static SCC
// (src/repro/core/scc.py:90-134), whose outer loop the port's host ran
// with one read of ``unassigned.any()`` a round.  Each outer round, while
// a lane has unassigned vertices and fewer than max_outer rounds have run:
//   1. trim's fixpoint (peeled vertices become singleton SCCs), its first
//      round listing the edges with both ends unassigned;
//   2. the forward and backward sweeps from the unassigned vertices: min
//      labels, or, with shortcut, hashed priorities with pointer doubling;
//      the forward sweep's first round lists the edges with both ends
//      still unassigned after trim, and the backward sweep walks that list
//      reversed;
//   3. done = unassigned & fwd == bwd (with shortcut: equal witnesses
//      below nv, the label the least member id of each witness group, an
//      atomicMin into min_id, read first: a giant component has one
//      witness); ccid = label where done; unassigned &= ~done.
// A grid barrier separates the phases, and each sweep is fixpoint_body
// above, so its rounds, its cap and its tally are those of its own form.
// A lane takes part in an outer round only while it has unassigned
// vertices at its start, so each lane runs its solo rounds.  Held to
// three blocks an SM (__launch_bounds__): chaining the three sweeps in one
// kernel took 108-114 registers a thread unbounded, two blocks an SM.
struct SccArgs {
  FixArgs fix;          // src, dst, live, vid, out, hop, flags, tally,
                        // list, count, last
  const uint8_t* active;  // [T, nv]
  unsigned char* un;    // [T, nv] scratch: the unassigned set
  int* ccid;            // [T, nv] out
  unsigned* fwd;        // [T, nv] scratch
  unsigned* bwd;        // [T, nv] scratch
  int* min_id;          // [T, nv] scratch (shortcut)
  int* left;            // [2 T + 2] scratch: lanes with unassigned
                        // vertices at a round's start, by parity, then
                        // whether any lane has
  int* inner;           // [T] scratch: the sweeps' per-lane rounds
  int* outer;           // [T] out: outer rounds each lane ran
  int max_outer;
};

constexpr unsigned kPrioMul = 0x9E3779B1u;

template <bool kShortcut>
__global__ void __launch_bounds__(kThreads, 3) scc_rounds(SccArgs s) {
  extern __shared__ unsigned char act[];
  __shared__ long long s_row;
  cg::grid_group grid = cg::this_grid();
  Stamps st(s.fix.stamps, s.fix.n_stamps);
  const long long first = blockIdx.x * (long long)kThreads + threadIdx.x;
  const long long step = (long long)gridDim.x * kThreads;
  const int t = s.fix.t, nv = s.fix.nv;
  const long long n = (long long)t * nv;
  const bool small = n <= 0xFFFFFFFFLL;
  long long lo, hi;
  block_span(n, lo, hi);  // as fixpoint_body's: trim's last writes
  int* any_left = s.left + 2 * t;
  for (long long i = first; i < 2 * t; i += step) s.left[i] = 0;
  for (long long i = first; i < t; i += step) s.outer[i] = 0;
  if (first == 0) any_left[0] = any_left[1] = 0;
  st.sync(grid, kInit);
  {
    Changes ch;
    for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
      const unsigned char on = s.active[i];
      s.un[i] = on;
      s.ccid[i] = kInt32Max;
      ch.note(t == 1 ? 0 : quot(i, nv, small), on, s.left);
    }
    ch.flush(s.left, any_left, &s_row);
  }
  st.sync(grid, kSccPass);
  FixArgs trim = s.fix;
  trim.state = s.un;
  trim.ccid = s.ccid;
  trim.mask = nullptr;
  trim.rounds = s.inner;
  trim.compact = 1;
  trim.reverse = 0;
  FixArgs fw = trim;
  fw.mask = s.un;
  fw.state = s.fwd;
  fw.ccid = nullptr;
  fw.shortcut = 0;  // the label sweeps of scc_static have no hop
  FixArgs bw = fw;
  bw.state = s.bwd;
  bw.compact = 0;  // the forward sweep's list, reversed
  bw.reverse = 1;
  constexpr int kSweep = kShortcut ? kPrio : kLabel;
  int it = 0;
  while (it < s.max_outer) {
    const int p = it & 1, q = p ^ 1;
    if (!__ldcg(any_left + p)) break;
    const int* on = s.left + p * t;
    for (long long i = first; i < t; i += step) {
      s.outer[i] += __ldcg(on + i);
      s.left[q * t + i] = 0;
    }
    if (first == 0) any_left[q] = 0;
    fixpoint_body<kTrim>(trim, act, &s_row, on, st);
    // the sweeps' seeds: every unassigned vertex its own id (priority)
    for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
      const long long row = t == 1 ? 0 : quot(i, nv, small);
      if (!__ldcg(on + row)) continue;
      const unsigned v = (unsigned)(i - row * nv);
      const bool un = __ldcg(s.un + i);
      const unsigned seed = kShortcut ? (un ? v * kPrioMul : kSent32)
                                      : (un ? v : (unsigned)kInt32Max);
      s.fwd[i] = seed;
      s.bwd[i] = seed;
      if (kShortcut) s.min_id[i] = kInt32Max;
    }
    st.sync(grid, kSccPass);
    // a sweep capped at 0 rounds lists nothing: the backward one then
    // runs none either
    fixpoint_body<kSweep>(fw, act, &s_row, on, st);
    fixpoint_body<kSweep>(bw, act, &s_row, on, st);
    Changes ch;
    int* next = s.left + q * t;
    if (kShortcut) {
      // witnesses: the vertex whose priority a label is, nv for none;
      // a done vertex leaves its witness in hop for the second pass
      for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
        const long long row = t == 1 ? 0 : quot(i, nv, small);
        if (!__ldcg(on + row)) continue;
        unsigned w = kSent32;
        if (__ldcg(s.un + i)) {
          const unsigned f = __ldcg(s.fwd + i), b = __ldcg(s.bwd + i);
          const int wf = f != kSent32 ? (int)(f * kPrioInv) : nv;
          const int wb = b != kSent32 ? (int)(b * kPrioInv) : nv;
          if (wf == wb && (unsigned)wf < (unsigned)nv) {
            w = (unsigned)wf;
            const int id = (int)(i - row * nv);
            int* m = s.min_id + row * nv + wf;
            if (__ldcg(m) > id) atomicMin(m, id);
          }
        }
        s.fix.hop[i] = w;
      }
      st.sync(grid, kSccPass);
      for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
        const long long row = t == 1 ? 0 : quot(i, nv, small);
        if (!__ldcg(on + row)) continue;
        const unsigned w = __ldcg(s.fix.hop + i);
        if (w != kSent32) {
          s.ccid[i] = __ldcg(s.min_id + row * nv + w);
          s.un[i] = 0;
        }
        ch.note(row, w == kSent32 && __ldcg(s.un + i), next);
      }
    } else {
      for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
        const long long row = t == 1 ? 0 : quot(i, nv, small);
        if (!__ldcg(on + row)) continue;
        bool still = __ldcg(s.un + i);
        if (still) {
          const unsigned f = __ldcg(s.fwd + i);
          if (f == __ldcg(s.bwd + i)) {
            s.ccid[i] = (int)f;
            s.un[i] = 0;
            still = false;
          }
        }
        ch.note(row, still, next);
      }
    }
    ch.flush(next, any_left + q, &s_row);
    st.sync(grid, kSccPass);
    ++it;
  }
  if (first == 0 && s.fix.tally != nullptr)
    atomicAdd(s.fix.tally + kScc, (unsigned long long)it);
  st.finish();
}

cudaError_t launched(cudaError_t err) {
  cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// A cooperative grid for ``kernel``: enough blocks for the larger of the
// edge passes and the vertex words, at most the blocks the card holds at
// once (the occupancy of this kernel at T bytes of shared memory on every
// SM).
template <class Kernel, class Args>
cudaError_t launch_coop(Kernel kernel, Args a, long long total,
                        long long words, int t, cudaStream_t stream) {
  const size_t smem = (size_t)t;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  long long work = (total + kUnroll - 1) / kUnroll;
  if (words > work) work = words;
  const long long want = (work + kThreads - 1) / kThreads;
  const long long most = (long long)per_sm * sms;
  const int grid = (int)(want < most ? (want > 0 ? want : 1) : most);
  void* args[] = {&a};
  return launched(cudaLaunchCooperativeKernel(
      (const void*)kernel, dim3(grid), dim3(kThreads), args, smem, stream));
}

template <int kForm>
cudaError_t launch_fixpoint(FixArgs a, cudaStream_t stream) {
  return launch_coop(fixpoint_rounds<kForm>, a, a.total,
                     (long long)a.t * a.f * a.nv, a.t, stream);
}

// ------------------------------------------------------------ direct ---

__global__ void fill_sentinel(unsigned long long* __restrict__ out,
                              long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = kSentinel;
}

__global__ void scatter_min(const int* __restrict__ dst,
                            const unsigned long long* __restrict__ msg,
                            unsigned long long* __restrict__ out, long long e,
                            int f, int nv) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < e;
       i += (long long)gridDim.x * blockDim.x) {
    const int d = dst[i];
    if (d < 0 || d >= nv) continue;
    for (int r = 0; r < f; ++r) {
      // neighbouring threads read neighbouring edges of one frontier row
      const unsigned long long m = msg[(long long)r * e + i];
      if (m < kSentinel) atomicMin(out + (long long)r * nv + d, m);
    }
  }
}

}  // namespace

// Gather form.  src, dst int32[T, E], live uint8[T, E] (0 or 1), val
// int32 words [T, F, n_src] (pair mode: [T, 2, nv] with n_src == nv; OR
// mode: packed bits), out int32 words [T, F, nv].  Returns the first CUDA
// error of the fill and the launch.
extern "C" int frontier_gather_launch(const void* src, const void* dst,
                                      const void* live, const void* val,
                                      void* out, int t, long long e, int f,
                                      int n_src, int nv, int mode,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_out = (long long)t * f * nv;
  const long long total = (long long)t * e;
  if (n_out == 0) return (int)cudaGetLastError();
  // SENTINEL is all ones, the OR identity all zeros
  cudaError_t rc = cudaMemsetAsync(out, mode == kOr ? 0 : 0xFF,
                                   n_out * sizeof(unsigned), s);
  if (rc != cudaSuccess) return (int)rc;
  if (total > 0 && n_src > 0) {
    const int blocks = blocks_for((total + kUnroll - 1) / kUnroll);
    auto* sp = static_cast<const int*>(src);
    auto* dp = static_cast<const int*>(dst);
    auto* lp = static_cast<const uint8_t*>(live);
    auto* vp = static_cast<const unsigned*>(val);
    auto* op = static_cast<unsigned*>(out);
    if (mode == kPair)
      gather_rows<kPair><<<blocks, kThreads, 0, s>>>(sp, dp, lp, vp, op, e,
                                                     total, f, n_src, nv);
    else if (mode == kOr)
      gather_rows<kOr><<<blocks, kThreads, 0, s>>>(sp, dp, lp, vp, op, e,
                                                   total, f, n_src, nv);
    else
      gather_rows<kMin><<<blocks, kThreads, 0, s>>>(sp, dp, lp, vp, op, e,
                                                    total, f, n_src, nv);
  }
  return (int)cudaGetLastError();
}

// Direct form: dst int32[E], msg int64[F, E] (values in [0, 2^32)), out
// int64[F, NV].  Returns cudaGetLastError() after both launches.
extern "C" int frontier_min_launch(const void* dst, const void* msg, void* out,
                                   long long e, int f, int nv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_out = (long long)f * nv;
  auto* o = static_cast<unsigned long long*>(out);
  if (n_out > 0)
    fill_sentinel<<<blocks_for(n_out), kThreads, 0, s>>>(o, n_out);
  if (e > 0 && n_out > 0)
    scatter_min<<<blocks_for(e), kThreads, 0, s>>>(
        static_cast<const int*>(dst),
        static_cast<const unsigned long long*>(msg), o, e, f, nv);
  return (int)cudaGetLastError();
}

// Fixpoint form: every round of one SMSCC sweep (``form``, the order of
// ref.FORMS) until a round changes nothing or max_iters rounds have run,
// in place on ``state`` ([T, f, nv]: uint8 for reach / pair / trim, int32
// words for label / prio / or) and trim's ccid [T, nv].  src, dst int32
// [T, e] and live uint8 [T, e] as in the gather form; mask uint8 [T, nv]
// (null for trim); vid int32 [nv] (trim, scc).  Scratch: out int32 [T f
// nv], hop int32 [T nv] (label with shortcut, prio, scc), flags int32
// [4 T + 2], list int32 [T, e, 2] (the listed edges), count int32 [T],
// last uint8 [T f nv].  Writes rounds int32 [T], each lane's rounds, and
// adds the rounds run to tally[form] (uint64 [7]) unless it is null.
//
// The scc form (form 6, f = 1): the static SCC of the subgraph each lane's
// mask (``active``) induces, at most max_outer outer rounds, each sweep
// capped at max_iters rounds; ``state`` is uint8 [T, nv] scratch (the
// unassigned set), ``ccid`` int32 [T, nv] the labels it writes, ``rounds``
// each lane's outer rounds, ``work`` int32 [3 T nv + 3 T + 2] scratch;
// shortcut picks the priority sweeps.  tally[6] counts the outer rounds,
// the sweeps' rounds go to their own forms.
//
// For measurement only: ``stamps`` (null on the main path) takes n_stamps
// part records (see Stamps); word 0 is the launch's grid.
//
// Returns the first CUDA error of the launch.
extern "C" int frontier_fixpoint_launch(
    const void* src, const void* dst, const void* live, const void* mask,
    void* state, void* ccid, const void* vid, void* out, void* hop,
    void* flags, void* rounds, void* tally, void* work, void* list,
    void* count, void* last, void* stamps, int t, long long e, int f,
    int nv, int form, int shortcut, int max_iters, int max_outer,
    int n_stamps, void* stream) {
  if (t < 1 || t > kMaxLanes || list == nullptr || count == nullptr ||
      last == nullptr)
    return (int)cudaErrorInvalidValue;
  FixArgs a{static_cast<const int*>(src), static_cast<const int*>(dst),
            static_cast<const uint8_t*>(live),
            static_cast<const uint8_t*>(mask), state,
            static_cast<int*>(ccid), static_cast<const int*>(vid),
            static_cast<unsigned*>(out), static_cast<unsigned*>(hop),
            static_cast<int*>(flags), static_cast<int*>(rounds),
            static_cast<unsigned long long*>(tally),
            static_cast<unsigned long long*>(stamps),
            static_cast<int2*>(list), static_cast<int*>(count),
            static_cast<unsigned char*>(last), e, (long long)t * e, t, f,
            nv, shortcut, max_iters, stamps == nullptr ? 0 : n_stamps, 1,
            0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (form == kScc) {
    if (f != 1 || work == nullptr) return (int)cudaErrorInvalidValue;
    const long long n = (long long)t * nv;
    auto* w = static_cast<int*>(work);
    SccArgs sa{a, static_cast<const uint8_t*>(mask),
               static_cast<unsigned char*>(state), static_cast<int*>(ccid),
               reinterpret_cast<unsigned*>(w),
               reinterpret_cast<unsigned*>(w + n), w + 2 * n, w + 3 * n,
               w + 3 * n + 2 * t + 2, static_cast<int*>(rounds), max_outer};
    sa.fix.rounds = nullptr;
    return shortcut
               ? (int)launch_coop(scc_rounds<true>, sa, a.total, n, t, s)
               : (int)launch_coop(scc_rounds<false>, sa, a.total, n, t, s);
  }
  switch (form) {
    case kReach: return (int)launch_fixpoint<kReach>(a, s);
    case kPairForm: return (int)launch_fixpoint<kPairForm>(a, s);
    case kLabel: return (int)launch_fixpoint<kLabel>(a, s);
    case kPrio: return (int)launch_fixpoint<kPrio>(a, s);
    case kOrForm: return (int)launch_fixpoint<kOrForm>(a, s);
    case kTrim: return (int)launch_fixpoint<kTrim>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
