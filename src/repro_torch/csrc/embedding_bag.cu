// embedding_bag: out[b] = sum_l w[b,l] * table[ids[b,l]] over f32 rows, an
// id outside [0, V) adding nothing; mean mode divides by the number of ids
// >= 0 (at least 1).
//
// Replaces the TPU kernel embedding_bag_counts (src/repro/kernels/
// embedding_bag/kernel.py:45) with the mean mode of its wrapper (ops.py).
// The TPU kernel sweeps the whole vocabulary in panels and multiplies one-
// hot counts by each panel on the MXU, because the TPU gathers rows slowly;
// it reads all V x D of the table for every bag tile.  Hopper gathers rows
// well, so here each bag reads only the rows its ids name.  An id in
// [V, Vp) hit a zero padded row there and an id >= Vp matched no column:
// both add nothing, as here.
//
// Bound: bytes, B*L*4 of ids (and as much of weights) + nnz*D*4 of rows
// gathered + B*D*4 of out, over 3.35 TB/s: 5.6 MB and 0.0017 ms at MIND's
// shape (512 bags of 50 ids, D = 64).  So little data means the kernel is
// bound by latency (a launch, the ids' round trip, the rows' round trip),
// and the design puts every row of a bag in flight at once:
// - one block of kThreads threads per bag; the bag's ids and weights are
//   staged in shared memory once (ids outside [0, V) become -1 there), and
//   the count of ids >= 0 comes from the same barrier
//   (__syncthreads_count);
// - a row is cut into chunks of 16 bytes (float4) when D is a multiple of 4
//   and the table's base is 16-byte aligned, else of 4 bytes (float); the
//   block's threads are laid out as groups of one thread per chunk, so at
//   D = 64 sixteen lanes load a 256-byte row and the block gathers 8 rows
//   side by side;
// - each thread issues all of its kRows row loads before its first FMA, so
//   a bag of up to 64 ids at D = 64 has every row in flight in one pass
//   (a throwaway A/B on the card at MIND's shape put 128 x 8 level with
//   64 x 16 and ahead of 128 x 4, 256 x 4, 256 x 8 and 512 x 2);
// - the groups' partial sums meet in shared memory and are added in group
//   order, so a result repeats bit for bit from run to run (no atomics).
// A D wider than a block's chunks is walked in column tiles.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // one block per bag
constexpr int kRows = 8;  // row loads in flight per thread

__device__ __forceinline__ float4 zero(float4) {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ float zero(float) { return 0.f; }

__device__ __forceinline__ float4 fma_row(float w, float4 r, float4 acc) {
  return make_float4(fmaf(w, r.x, acc.x), fmaf(w, r.y, acc.y),
                     fmaf(w, r.z, acc.z), fmaf(w, r.w, acc.w));
}
__device__ __forceinline__ float fma_row(float w, float r, float acc) {
  return fmaf(w, r, acc);
}

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float add(float a, float b) { return a + b; }

__device__ __forceinline__ float4 scale(float4 a, float den) {
  return make_float4(a.x / den, a.y / den, a.z / den, a.w / den);
}
__device__ __forceinline__ float scale(float a, float den) { return a / den; }

// Chunk = float4 or float; a row is n_chunks chunks.
template <typename Chunk>
__global__ void __launch_bounds__(kThreads)
    embedding_bag_fwd(const int* __restrict__ ids,
                      const float* __restrict__ weights,
                      const Chunk* __restrict__ table, Chunk* __restrict__ out,
                      int bag_len, int n_rows, int n_chunks, int mean) {
  __shared__ int s_id[kThreads];
  __shared__ float s_w[kThreads];
  __shared__ Chunk s_part[kThreads];
  const int t = threadIdx.x;
  const long long bag = blockIdx.x;
  const int* bid = ids + bag * bag_len;
  const float* bw = weights ? weights + bag * bag_len : nullptr;
  int count = 0;  // ids >= 0, those >= V included, as the reference counts
  for (int c0 = 0; c0 < n_chunks; c0 += kThreads) {
    const int width = min(kThreads, n_chunks - c0);  // chunks in this tile
    const int groups = kThreads / width;  // rows gathered side by side
    const int g = t / width;
    const Chunk* col = table + c0 + t % width;
    Chunk acc = zero(Chunk());
    for (int l0 = 0; l0 < bag_len; l0 += kThreads) {
      const int n = min(kThreads, bag_len - l0);
      int id = t < n ? bid[l0 + t] : -1;
      const float w = (bw && t < n) ? bw[l0 + t] : 1.f;
      const bool counted = id >= 0;
      s_id[t] = id < n_rows ? id : -1;
      s_w[t] = w;
      const int c = __syncthreads_count(counted);  // also publishes s_id
      if (c0 == 0) count += c;
      if (g < groups) {
        for (int j = g; j < n; j += groups * kRows) {
          Chunk r[kRows];
          float wk[kRows];
#pragma unroll
          for (int k = 0; k < kRows; ++k) {
            const int l = j + k * groups;
            const int rid = l < n ? s_id[l] : -1;
            wk[k] = rid >= 0 ? s_w[l] : 0.f;
            r[k] = rid >= 0 ? __ldg(col + (long long)rid * n_chunks)
                            : zero(Chunk());
          }
#pragma unroll
          for (int k = 0; k < kRows; ++k) acc = fma_row(wk[k], r[k], acc);
        }
      }
      __syncthreads();  // s_id and s_w are read before the next stage
    }
    s_part[t] = acc;
    __syncthreads();
    if (t < width) {
      Chunk sum = s_part[t];
      for (int k = 1; k < groups; ++k) sum = add(sum, s_part[k * width + t]);
      if (mean) sum = scale(sum, (float)max(count, 1));
      out[bag * n_chunks + c0 + t] = sum;
    }
    __syncthreads();  // s_part is rewritten by the next column tile
  }
}

}  // namespace

// ids int32[B, L], weights f32[B, L] or null (all 1), table f32[V, D] ->
// out f32[B, D]; mean != 0 divides each bag by max(#ids >= 0, 1).  vec != 0
// reads 16-byte chunks and needs D % 4 == 0 and a 16-byte-aligned table
// (the wrapper decides).
extern "C" int embedding_bag_launch(const void* ids, const void* weights,
                                    const void* table, void* out, int n_bags,
                                    int bag_len, int n_rows, int dim,
                                    int mean, int vec, void* stream) {
  if (n_bags > 0 && dim > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto* ip = static_cast<const int*>(ids);
    auto* wp = static_cast<const float*>(weights);
    if (vec)
      embedding_bag_fwd<float4><<<n_bags, kThreads, 0, s>>>(
          ip, wp, static_cast<const float4*>(table), static_cast<float4*>(out),
          bag_len, n_rows, dim / 4, mean);
    else
      embedding_bag_fwd<float><<<n_bags, kThreads, 0, s>>>(
          ip, wp, static_cast<const float*>(table), static_cast<float*>(out),
          bag_len, n_rows, dim, mean);
  }
  return (int)cudaGetLastError();
}
