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
#include <cuda_runtime.h>
#include <stdint.h>

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

template <int kMode>
__global__ void __launch_bounds__(kThreads)
    gather_rows(const int* __restrict__ src, const int* __restrict__ dst,
                const uint8_t* __restrict__ live,
                const unsigned* __restrict__ val, unsigned* out, long long e,
                long long total, int f, int n_src, int nv) {
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
      ok[k] = in && live[i] && (unsigned)s[k] < (unsigned)n_src &&
              (unsigned)d[k] < (unsigned)nv;
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
        v[k] = ok[k] ? __ldg(val + (row[k] * f + r) * n_src + from)
                     : identity<kMode>();
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
