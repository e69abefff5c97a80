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
// (src/repro/core/reach.py:41 _fixpoint; scc.py:56 trim through it): the
// port's per-round loop read each round's changed flag back to the host,
// ~0.9 ms of host time a round beside ~0.1 ms of device time.  One
// persistent cooperative launch runs all rounds: the gather above with
// each edge's message read from the sweep's own state, a grid barrier,
// each vertex word's update (which resets its gather word for the next
// round and notes a change, one atomic a block), a barrier (one more
// before the pointer-doubling hop of the label and priority forms), and
// every thread reads whether any lane changed.  The round count and the
// cap are JAX's exactly; tenant lanes freeze after their first unchanged
// round.  The scc form runs a whole static SCC (trim and both sweeps, round
// after outer round) in one launch the same way (see scc_rounds).
// Bound: bytes, a round's as for the gather form, times the
// rounds; the barriers add a few microseconds a round.  Buffers the launch
// rewrites are read through L2 (__ldcg), never the read-only path, which
// may keep last round's words.
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
  int* flags;           // [4 T + 2] scratch, see fixpoint_rounds
  int* rounds;          // [T] out
  unsigned long long* tally;  // [7] or null: rounds run, by form
  long long e, total;   // edges a row, T * e
  int t, f, nv, shortcut, max_iters;
};

template <int kForm>
__host__ __device__ constexpr int mode_of() {
  return kForm == kPairForm ? kPair : (kForm == kOrForm ? kOr : kMin);
}

// A round's messages, read from the state the previous round left.  The
// state is rewritten inside the launch, so it is read through L2 (__ldcg):
// the read-only path could hand back last round's words.
template <int kForm>
struct FixMsg {
  const void* state;
  const uint8_t* mask;
  const unsigned char* act;  // shared: which lanes run this round
  int f, nv;
  __device__ bool lane(long long row) const { return act[row]; }
  __device__ unsigned operator()(long long row, int r, int from) const {
    const long long at = (row * f + r) * nv + from;
    if (kForm == kReach || kForm == kPairForm)
      return __ldcg(static_cast<const unsigned char*>(state) + at)
                 ? 0u : kSent32;
    if (kForm == kOrForm)
      return __ldcg(static_cast<const unsigned*>(state) + at);
    // label, prio: only vertices inside the mask send (the scc form
    // rewrites its mask between sweeps, so it too is read through L2)
    return __ldcg(mask + row * nv + from)
               ? __ldcg(static_cast<const unsigned*>(state) + at) : kSent32;
  }
};

// trim's gather: flag 1 on the head and 2 on the tail of every live edge
// whose ends are both unassigned (in- and out-degree above zero)
__device__ __forceinline__ void trim_edges(const FixArgs& a,
                                           const unsigned char* act) {
  const auto* un = static_cast<const unsigned char*>(a.state);
  const long long step = (long long)gridDim.x * kThreads;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
       i < a.total; i += step) {
    const long long row = a.t == 1 ? 0 : i / a.e;
    if (!act[row] || !a.live[i]) continue;
    const int s = a.src[i], d = a.dst[i];
    if ((unsigned)s >= (unsigned)a.nv || (unsigned)d >= (unsigned)a.nv)
      continue;
    const long long base = row * a.nv;
    if (!__ldcg(un + base + s) || !__ldcg(un + base + d)) continue;
    if (!(__ldcg(a.out + base + d) & 1u)) atomicOr(a.out + base + d, 1u);
    if (!(__ldcg(a.out + base + s) & 2u)) atomicOr(a.out + base + s, 2u);
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
// hop_update after a grid barrier.  Notes whether the state changed.
template <int kForm>
__device__ __forceinline__ void update(const FixArgs& a, long long i,
                                       long long row, long long mv,
                                       unsigned inc, bool hop, Changes& ch,
                                       int* lane_flag) {
  if (kForm == kReach || kForm == kPairForm) {
    auto* st = static_cast<unsigned char*>(a.state);
    const unsigned char old = __ldcg(st + i);
    const unsigned char nxt = old | (inc == 0u && __ldcg(a.mask + mv));
    if (nxt != old) st[i] = nxt;
    ch.note(row, nxt != old, lane_flag);
  } else if (kForm == kOrForm) {
    auto* st = static_cast<unsigned*>(a.state);
    const unsigned old = __ldcg(st + i);
    const unsigned nxt = old | (__ldcg(a.mask + mv) ? inc : 0u);
    if (nxt != old) st[i] = nxt;
    ch.note(row, nxt != old, lane_flag);
  } else if (kForm == kTrim) {
    auto* un = static_cast<unsigned char*>(a.state);
    const bool peel = __ldcg(un + i) && inc != 3u;
    if (peel) {
      un[i] = 0;
      a.ccid[i] = __ldg(a.vid + (mv - row * a.nv));
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
    if (nxt != old) st[i] = nxt;
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
                                           Changes& ch, int* lane_flag) {
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
  if (fin != old) st[i] = fin;
  ch.note(row, fin != old, lane_flag);
}

// Every round of one fixpoint, JAX's ``while changed & (it < max_iters)``,
// run by the whole cooperative grid.  A round: the edge gather into out
// (grid barrier), each vertex word's update, which resets its out word
// for the next round and notes a change (a barrier; hop forms one more
// before the hop), then every thread reads whether any lane changed.
// Returns the rounds run (the most any lane ran) and adds them to
// tally[kForm].
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
                                             const int* lane_on) {
  cg::grid_group grid = cg::this_grid();
  const long long first = blockIdx.x * (long long)kThreads + threadIdx.x;
  const long long step = (long long)gridDim.x * kThreads;
  const int t = a.t;
  const long long fnv = (long long)a.f * a.nv;
  const long long n = t * fnv;
  const bool flat = t == 1 && a.f == 1;
  const bool hop = kForm == kPrio || (kForm == kLabel && a.shortcut);
  const unsigned ident = mode_of<kForm>() == kOr || kForm == kTrim
                             ? 0u : kSent32;
  int* lanes_ran = a.flags;
  int* lanes_changed = a.flags + 2 * t;
  int* any_changed = a.flags + 4 * t;
  for (long long i = first; i < n; i += step) a.out[i] = ident;
  for (long long i = first; i < t; i += step) {
    const int on = lane_on == nullptr ? 1 : __ldcg(lane_on + i);
    lanes_ran[t + i] = on;
    lanes_changed[t + i] = on;
    a.rounds[i] = 0;
  }
  grid.sync();
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
    if (kForm == kTrim)
      trim_edges(a, act);
    else
      gather_edges<mode_of<kForm>()>(a.src, a.dst, a.live,
                                     FixMsg<kForm>{a.state, a.mask, act, a.f, a.nv}, a.out, a.e,
                                     a.total, a.f, a.nv, a.nv);
    grid.sync();
    Changes ch;
    int* lane_flag = lanes_changed + p * t;
    for (long long i = first; i < n; i += step) {
      const long long row = t == 1 ? 0 : i / fnv;
      if (!act[row]) continue;
      const long long mv = row * a.nv + (flat ? i : i % a.nv);
      const unsigned inc = __ldcg(a.out + i);
      a.out[i] = ident;
      update<kForm>(a, i, row, mv, inc, hop, ch, lane_flag);
    }
    if (hop) {
      grid.sync();
      for (long long i = first; i < n; i += step) {
        const long long row = t == 1 ? 0 : i / fnv;
        if (!act[row]) continue;
        hop_update<kForm>(a, i, row, row * a.nv + (flat ? i : i % a.nv),
                          ch, lane_flag);
      }
    }
    ch.flush(lane_flag, any_changed + p, s_row);
    grid.sync();
    ++it;
    if (!__ldcg(any_changed + p)) break;
  }
  if (first == 0 && a.tally != nullptr)
    atomicAdd(a.tally + kForm, (unsigned long long)it);
  return it;
}

template <int kForm>
__global__ void __launch_bounds__(kThreads) fixpoint_rounds(FixArgs a) {
  extern __shared__ unsigned char act[];
  __shared__ long long s_row;
  fixpoint_body<kForm>(a, act, &s_row, nullptr);
}

// ------------------------------------------------------- static SCC ---
//
// The scc form: the whole of scc_static in one cooperative launch.
// Replaces the lax.while_loop of the JAX package's static SCC
// (src/repro/core/scc.py:90-134), whose outer loop the port's host ran
// with one read of ``unassigned.any()`` a round.  Each outer round, while
// a lane has unassigned vertices and fewer than max_outer rounds have run:
//   1. trim's fixpoint (peeled vertices become singleton SCCs);
//   2. the forward and backward sweeps from the unassigned vertices: min
//      labels, or, with shortcut, hashed priorities with pointer doubling;
//   3. done = unassigned & fwd == bwd (with shortcut: equal witnesses
//      below nv, the label the least member id of each witness group, an
//      atomicMin into min_id); ccid = label where done; unassigned &= ~done.
// A grid barrier separates the phases, and each sweep is fixpoint_body
// above, so its rounds, its cap and its tally are those of its own form.
// A lane takes part in an outer round only while it has unassigned
// vertices at its start, so each lane runs its solo rounds.  Bound:
// bytes, the sum over the sweeps' rounds of one round's bytes.  Chaining
// the three sweeps in one kernel took 108-114 registers a thread, two
// blocks an SM; held to three blocks an SM (__launch_bounds__) the grid is
// half as large again, and update_1m's fixpoint time a step fell from
// 0.0162 s to 0.0137 s on an H100 (PERF.md, the kernel table).
struct SccArgs {
  FixArgs fix;          // src, dst, live, vid, out, hop, flags, tally
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
  const long long first = blockIdx.x * (long long)kThreads + threadIdx.x;
  const long long step = (long long)gridDim.x * kThreads;
  const int t = s.fix.t, nv = s.fix.nv;
  const long long n = (long long)t * nv;
  int* any_left = s.left + 2 * t;
  for (long long i = first; i < 2 * t; i += step) s.left[i] = 0;
  for (long long i = first; i < t; i += step) s.outer[i] = 0;
  if (first == 0) any_left[0] = any_left[1] = 0;
  grid.sync();
  {
    Changes ch;
    for (long long i = first; i < n; i += step) {
      const unsigned char on = s.active[i];
      s.un[i] = on;
      s.ccid[i] = kInt32Max;
      ch.note(t == 1 ? 0 : i / nv, on, s.left);
    }
    ch.flush(s.left, any_left, &s_row);
  }
  grid.sync();
  FixArgs trim = s.fix;
  trim.state = s.un;
  trim.ccid = s.ccid;
  trim.mask = nullptr;
  trim.rounds = s.inner;
  FixArgs fw = trim;
  fw.mask = s.un;
  fw.state = s.fwd;
  fw.ccid = nullptr;
  fw.shortcut = 0;  // the label sweeps of scc_static have no hop
  FixArgs bw = fw;
  bw.src = s.fix.dst;
  bw.dst = s.fix.src;
  bw.state = s.bwd;
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
    fixpoint_body<kTrim>(trim, act, &s_row, on);
    // the sweeps' seeds: every unassigned vertex its own id (priority)
    for (long long i = first; i < n; i += step) {
      const long long row = t == 1 ? 0 : i / nv;
      if (!__ldcg(on + row)) continue;
      const unsigned v = (unsigned)(t == 1 ? i : i % nv);
      const bool un = __ldcg(s.un + i);
      const unsigned seed = kShortcut ? (un ? v * kPrioMul : kSent32)
                                      : (un ? v : (unsigned)kInt32Max);
      s.fwd[i] = seed;
      s.bwd[i] = seed;
      if (kShortcut) s.min_id[i] = kInt32Max;
    }
    grid.sync();
    fixpoint_body<kSweep>(fw, act, &s_row, on);
    fixpoint_body<kSweep>(bw, act, &s_row, on);
    Changes ch;
    int* next = s.left + q * t;
    if (kShortcut) {
      // witnesses: the vertex whose priority a label is, nv for none;
      // a done vertex leaves its witness in hop for the second pass
      for (long long i = first; i < n; i += step) {
        const long long row = t == 1 ? 0 : i / nv;
        if (!__ldcg(on + row)) continue;
        unsigned w = kSent32;
        if (__ldcg(s.un + i)) {
          const unsigned f = __ldcg(s.fwd + i), b = __ldcg(s.bwd + i);
          const int wf = f != kSent32 ? (int)(f * kPrioInv) : nv;
          const int wb = b != kSent32 ? (int)(b * kPrioInv) : nv;
          if (wf == wb && (unsigned)wf < (unsigned)nv) {
            w = (unsigned)wf;
            atomicMin(s.min_id + row * nv + wf, (int)(i - row * nv));
          }
        }
        s.fix.hop[i] = w;
      }
      grid.sync();
      for (long long i = first; i < n; i += step) {
        const long long row = t == 1 ? 0 : i / nv;
        if (!__ldcg(on + row)) continue;
        const unsigned w = __ldcg(s.fix.hop + i);
        if (w != kSent32) {
          s.ccid[i] = __ldcg(s.min_id + row * nv + w);
          s.un[i] = 0;
        }
        ch.note(row, w == kSent32 && __ldcg(s.un + i), next);
      }
    } else {
      for (long long i = first; i < n; i += step) {
        const long long row = t == 1 ? 0 : i / nv;
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
    grid.sync();
    ++it;
  }
  if (first == 0 && s.fix.tally != nullptr)
    atomicAdd(s.fix.tally + kScc, (unsigned long long)it);
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
// [4 T + 2].  Writes rounds int32 [T], each lane's rounds, and adds the
// rounds run to tally[form] (uint64 [7]) unless it is null.
//
// The scc form (form 6, f = 1): the static SCC of the subgraph each lane's
// mask (``active``) induces, at most max_outer outer rounds, each sweep
// capped at max_iters rounds; ``state`` is uint8 [T, nv] scratch (the
// unassigned set), ``ccid`` int32 [T, nv] the labels it writes, ``rounds``
// each lane's outer rounds, ``work`` int32 [3 T nv + 3 T + 2] scratch;
// shortcut picks the priority sweeps.  tally[6] counts the outer rounds,
// the sweeps' rounds go to their own forms.
//
// Returns the first CUDA error of the launch.
extern "C" int frontier_fixpoint_launch(
    const void* src, const void* dst, const void* live, const void* mask,
    void* state, void* ccid, const void* vid, void* out, void* hop,
    void* flags, void* rounds, void* tally, void* work, int t, long long e,
    int f, int nv, int form, int shortcut, int max_iters, int max_outer,
    void* stream) {
  if (t < 1 || t > kMaxLanes) return (int)cudaErrorInvalidValue;
  FixArgs a{static_cast<const int*>(src), static_cast<const int*>(dst),
            static_cast<const uint8_t*>(live),
            static_cast<const uint8_t*>(mask), state,
            static_cast<int*>(ccid), static_cast<const int*>(vid),
            static_cast<unsigned*>(out), static_cast<unsigned*>(hop),
            static_cast<int*>(flags), static_cast<int*>(rounds),
            static_cast<unsigned long long*>(tally), e, (long long)t * e, t,
            f, nv, shortcut, max_iters};
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
