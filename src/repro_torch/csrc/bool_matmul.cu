// bool_matmul: boolean-semiring product C = (A . B) > 0 over {0,1} bytes.
//
// Replaces the TPU kernel bool_matmul_f32 (src/repro/kernels/reach_blockmm/
// kernel.py), which runs the product on the MXU in float32 and saturates.
// Here the product runs in the kernel's own body on byte tiles: each block
// stages a 64x32 tile of A and a 32x64 tile of B in shared memory and every
// thread ORs the AND-products of a 4x4 patch of C.  A torch.bool tensor
// stores one byte 0 or 1 per element, so its storage is read as is.
//
// Bound: max(3 R^2 bytes over the memory rate, 2 R^3 boolean operations over
// the card's int8 tensor-core peak, which this first version does not use
// yet).  Bytes decide at R <= 512, the dense tier's shape; operations above.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(kThreads)
    bool_mm(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
            uint8_t* __restrict__ c, int m, int n, int k) {
  __shared__ uint8_t as[kBK][kBM];  // A tile, transposed: as[kk][row]
  __shared__ uint8_t bs[kBK][kBN];
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  uint8_t acc[4][4] = {};
  for (int k0 = 0; k0 < k; k0 += kBK) {
    for (int i = t; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, cc = i % kBK;
      const int gr = row0 + r, gc = k0 + cc;
      as[cc][r] = (gr < m && gc < k) ? a[(long long)gr * k + gc] : 0;
    }
    for (int i = t; i < kBK * kBN; i += kThreads) {
      const int r = i / kBN, cc = i % kBN;
      const int gr = k0 + r, gc = col0 + cc;
      bs[r][cc] = (gr < k && gc < n) ? b[(long long)gr * n + gc] : 0;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      uint8_t av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] |= av[i] & bv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cc = col0 + tx * 4 + j;
      if (cc < n) c[(long long)r * n + cc] = acc[i][j] != 0;
    }
  }
}

}  // namespace

// a uint8[M, K], b uint8[K, N] holding 0/1 -> c uint8[M, N] holding 0/1.
extern "C" int bool_matmul_launch(const void* a, const void* b, void* c,
                                  int m, int n, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m > 0 && n > 0) {
    dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
    bool_mm<<<grid, kThreads, 0, s>>>(static_cast<const uint8_t*>(a),
                                      static_cast<const uint8_t*>(b),
                                      static_cast<uint8_t*>(c), m, n, k);
  }
  return (int)cudaGetLastError();
}
