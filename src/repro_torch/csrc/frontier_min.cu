// frontier_min: one round of frontier expansion in the min-semiring.
//
//   out[f, v] = min(msg[f, e] : dst[e] == v),  SENTINEL where nothing lands.
//
// Replaces the TPU kernel segment_min_u32
// (src/repro/kernels/frontier_expand/kernel.py), which sweeps the vertex
// space in one-hot panels because the TPU lacks a fast scatter.  Hopper has
// atomics on device memory, so the natural form is a scatter: one thread per
// edge e walks the F frontiers, skips SENTINEL messages and dst outside
// [0, nv), and does atomicMin into out[f, dst[e]].  Min is commutative and
// idempotent, so the result is bit-exact whatever order the atomics land in.
//
// Messages are uint32 values carried in int64 (torch has no uint32
// arithmetic), so the atomic is the 64-bit unsigned atomicMin; this doubles
// the message bytes against a uint32 layout.
//
// Bound: bytes, those of the uint32 function replaced: 4 B of dst per edge,
// 4 B per message (F per edge), 4 B per output word written, against
// 3.35 TB/s.  The int64 carrier makes the kernel move 8 B per message and per
// output word, a cost it pays above that bound.  No operation count comes
// close.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned long long kSentinel = 0xFFFFFFFFull;
constexpr int kThreads = 256;

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

int blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  const long long cap = 132LL * 32;  // enough resident blocks for 132 SMs
  return (int)(b < cap ? (b > 0 ? b : 1) : cap);
}

}  // namespace

// dst int32[E], msg int64[F, E] (values in [0, 2^32)), out int64[F, NV].
// Returns cudaGetLastError() after both launches.
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
