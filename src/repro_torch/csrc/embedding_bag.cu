// embedding_bag: out[b] = sum_l w[b,l] * table[ids[b,l]] over f32 rows, an
// id outside [0, V) adding nothing; mean mode divides by the number of ids
// >= 0 (at least 1).
//
// Replaces the TPU kernel embedding_bag_counts (src/repro/kernels/
// embedding_bag/kernel.py:45) with the mean mode of its wrapper (ops.py).
// The TPU kernel sweeps the whole vocabulary in panels and multiplies one-
// hot counts by each panel on the MXU, because the TPU gathers rows slowly;
// it reads all V x D of the table for every bag tile.  Hopper gathers rows
// well, so here one warp owns one bag and reads only the rows its ids name:
// the lanes load 32 ids and weights at once, pass them round with shuffles,
// and stride over D, so neighbouring lanes read one row contiguously (64 f32
// = 256 B at MIND's width).  An id in [V, Vp) hit a zero padded row there
// and an id >= Vp matched no column: both add nothing, as here.
//
// Bound: bytes, B*L*8 (ids, weights) + nnz*D*4 (the rows gathered) + B*D*4
// (out) over the memory rate; at B = 512 bags a warp's row reads are a chain
// of dependent-latency loads, so expect it latency-bound well above that.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // bags per block
constexpr int kCols = 4;   // columns per lane per pass: D <= 128 in one pass
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
    embedding_bag_fwd(const int* __restrict__ ids,
                      const float* __restrict__ weights,
                      const float* __restrict__ table, float* __restrict__ out,
                      int n_bags, int bag_len, int n_rows, int dim, int mean) {
  const int lane = threadIdx.x % 32;
  const int bag = blockIdx.x * kWarps + threadIdx.x / 32;
  if (bag >= n_bags) return;  // whole warps leave together
  const int* bid = ids + (long long)bag * bag_len;
  const float* bw = weights ? weights + (long long)bag * bag_len : nullptr;
  for (int d0 = 0; d0 < dim; d0 += 32 * kCols) {
    float acc[kCols] = {};
    int count = 0;  // ids >= 0, those >= V included, as the reference counts
    for (int l0 = 0; l0 < bag_len; l0 += 32) {
      const int l = l0 + lane;
      const int my_id = l < bag_len ? bid[l] : -1;
      const float my_w = (bw && l < bag_len) ? bw[l] : 1.f;
      count += __popc(__ballot_sync(kFull, my_id >= 0));
#pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        const int id = __shfl_sync(kFull, my_id, j);
        const float w = __shfl_sync(kFull, my_w, j);
        if (id < 0 || id >= n_rows) continue;
        const float* row = table + (long long)id * dim;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int d = d0 + lane + 32 * c;
          if (d < dim) acc[c] = fmaf(w, __ldg(row + d), acc[c]);
        }
      }
    }
    const float den = mean ? (float)max(count, 1) : 1.f;
    float* ob = out + (long long)bag * dim;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = d0 + lane + 32 * c;
      if (d < dim) ob[d] = mean ? acc[c] / den : acc[c];
    }
  }
}

}  // namespace

// ids int32[B, L], weights f32[B, L] or null (all 1), table f32[V, D] ->
// out f32[B, D]; mean != 0 divides each bag by max(#ids >= 0, 1).
extern "C" int embedding_bag_launch(const void* ids, const void* weights,
                                    const void* table, void* out, int n_bags,
                                    int bag_len, int n_rows, int dim,
                                    int mean, void* stream) {
  if (n_bags > 0 && dim > 0) {
    const int blocks = (n_bags + kWarps - 1) / kWarps;
    embedding_bag_fwd<<<blocks, kWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(ids), static_cast<const float*>(weights),
        static_cast<const float*>(table), static_cast<float*>(out), n_bags,
        bag_len, n_rows, dim, mean);
  }
  return (int)cudaGetLastError();
}
