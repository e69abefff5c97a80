// bool_matmul: boolean-semiring product C = (A . B) > 0 over {0,1} bytes,
// on the int8 tensor cores.
//
// Replaces the TPU kernel bool_matmul_f32 (src/repro/kernels/reach_blockmm/
// kernel.py), which runs the product on the MXU in float32 and saturates.
// A torch.bool tensor stores one byte, 0 or 1, per element, so its storage
// is already the s8 operand of mma.sync m16n8k32 (s8 x s8 -> s32).  The
// count sits in s32 and is at most K < 2^31, so count > 0 is exactly the
// TPU kernel's acc > 0, with no rounding anywhere.
//
// Each block owns a 64 x 32 tile of C (R = 512 gives 128 blocks), four warps
// of 16 rows x 32 columns each.  A and B tiles of 128 along K are staged by
// 16-byte cp.async into two buffers, so tile k+1 is in flight while tile k
// is multiplied; where K or N is not a multiple of 16 (rows not 16-byte
// aligned) they are staged by byte loads, zero past the edges.  The B
// operand must be K-contiguous per column, and 8-bit types have no
// transposing fragment load (ldmatrix.trans) and no MN-major wgmma B, so
// each staged B tile is transposed in shared memory by 4x4 byte blocks
// (__byte_perm) before the fragments are read.  C leaves as bytes through
// shared memory, 16 bytes a store.
//
// Bound: max(3 R^2 bytes over the memory rate, 2 R^3 operations over the
// int8 tensor-core peak).  mma.sync serves as well as wgmma here: at R <=
// 1024 the work is 0.27-2.1 GOP, so neither tensor-core rate binds; latency
// (a few K steps per block) and occupancy do.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 32;
constexpr int kBK = 128;
constexpr int kThreads = 128;      // 4 warps, 16 rows of C each
constexpr int kNT = kBN / 8;       // mma n-tiles per warp
constexpr int kAPitch = kBK + 16;  // bytes per A row: 16-byte aligned rows,
                                   // conflict-free fragment loads
constexpr int kBPitch = kBN + 16;  // bytes per row of the staged B tile
constexpr int kTPitch = kBK + 16;  // bytes per column of the transposed B
constexpr int kCPitch = kBN + 16;  // bytes per row of the staged C tile

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ void st32(uint8_t* p, uint32_t x) {
  *reinterpret_cast<uint32_t*>(p) = x;
}

// 16 bytes global -> shared, the bytes past src_bytes (0 or 16) zero
__device__ __forceinline__ void cp_async16(uint8_t* dst, const uint8_t* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A rows [row0, row0 + kBM) x K [k0, k0 + kBK) and B K [k0, k0 + kBK) x
// columns [col0, col0 + kBN) into shared memory, zero outside A and B
template <bool kVec>
__device__ __forceinline__ void stage(uint8_t* as, uint8_t* bs,
                                      const uint8_t* a, const uint8_t* b,
                                      int m, int n, int k, int row0, int col0,
                                      int k0) {
  const int t = threadIdx.x;
  if (kVec) {  // k and n are multiples of 16: a chunk is wholly in or out
    for (int i = t; i < kBM * kBK / 16; i += kThreads) {
      const int r = i / (kBK / 16), cc = i % (kBK / 16) * 16;
      const int gr = row0 + r, gk = k0 + cc;
      const bool in = gr < m && gk < k;
      cp_async16(as + r * kAPitch + cc, in ? a + (long long)gr * k + gk : a,
                 in ? 16 : 0);
    }
    for (int i = t; i < kBK * kBN / 16; i += kThreads) {
      const int r = i / (kBN / 16), cc = i % (kBN / 16) * 16;
      const int gk = k0 + r, gc = col0 + cc;
      const bool in = gk < k && gc < n;
      cp_async16(bs + r * kBPitch + cc, in ? b + (long long)gk * n + gc : b,
                 in ? 16 : 0);
    }
  } else {
    for (int i = t; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, cc = i % kBK;
      const int gr = row0 + r, gk = k0 + cc;
      as[r * kAPitch + cc] =
          (gr < m && gk < k) ? a[(long long)gr * k + gk] : 0;
    }
    for (int i = t; i < kBK * kBN; i += kThreads) {
      const int r = i / kBN, cc = i % kBN;
      const int gk = k0 + r, gc = col0 + cc;
      bs[r * kBPitch + cc] =
          (gk < k && gc < n) ? b[(long long)gk * n + gc] : 0;
    }
  }
}

// bs [kBK][kBN] -> bt [kBN][kBK], by 4x4 byte blocks: four row words in,
// four column words out
__device__ __forceinline__ void transpose(const uint8_t* bs, uint8_t* bt) {
  for (int i = threadIdx.x; i < (kBK / 4) * (kBN / 4); i += kThreads) {
    const int nb = i % (kBN / 4), kb = i / (kBN / 4);
    const uint8_t* src = bs + 4 * kb * kBPitch + 4 * nb;
    const uint32_t w0 = ld32(src), w1 = ld32(src + kBPitch),
                   w2 = ld32(src + 2 * kBPitch), w3 = ld32(src + 3 * kBPitch);
    const uint32_t t0 = __byte_perm(w0, w1, 0x5140);  // w0.0 w1.0 w0.1 w1.1
    const uint32_t t1 = __byte_perm(w2, w3, 0x5140);  // w2.0 w3.0 w2.1 w3.1
    const uint32_t t2 = __byte_perm(w0, w1, 0x7362);  // w0.2 w1.2 w0.3 w1.3
    const uint32_t t3 = __byte_perm(w2, w3, 0x7362);  // w2.2 w3.2 w2.3 w3.3
    uint8_t* dst = bt + 4 * nb * kTPitch + 4 * kb;
    st32(dst, __byte_perm(t0, t1, 0x5410));  // column 0: w0.0 .. w3.0
    st32(dst + kTPitch, __byte_perm(t0, t1, 0x7632));
    st32(dst + 2 * kTPitch, __byte_perm(t2, t3, 0x5410));
    st32(dst + 3 * kTPitch, __byte_perm(t2, t3, 0x7632));
  }
}

// d += a (16 x 32 s8, row-major) . b (32 x 8 s8, column-major), in s32
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    bool_mm(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
            uint8_t* __restrict__ c, int m, int n, int k) {
  __shared__ __align__(16) uint8_t as[2][kBM * kAPitch];
  __shared__ __align__(16) uint8_t bs[2][kBK * kBPitch];
  __shared__ __align__(16) uint8_t bt[kBN * kTPitch];  // then the C tile
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int g = lane / 4, q = lane % 4;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  const int nk = (k + kBK - 1) / kBK;

  // mma fragments (PTX ISA, m16n8k32 .s8): a0 row g, K 4q..4q+3; a1 row
  // g + 8; a2, a3 the same at K + 16; b0 column g, K 4q..4q+3; b1 at K + 16;
  // d0, d1 row g, columns 2q, 2q + 1; d2, d3 row g + 8
  int acc[kNT][4] = {};
  if (nk > 0) stage<kVec>(as[0], bs[0], a, b, m, n, k, row0, col0, 0);
  cp_commit();
  for (int it = 0; it < nk; ++it) {
    if (it + 1 < nk) {
      stage<kVec>(as[(it + 1) & 1], bs[(it + 1) & 1], a, b, m, n, k, row0,
                  col0, (it + 1) * kBK);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // every thread's copies of tile it have landed
    transpose(bs[it & 1], bt);
    __syncthreads();
    const uint8_t* ap = as[it & 1] + (16 * warp + g) * kAPitch + 4 * q;
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      const uint32_t a0 = ld32(ap + 32 * ks),
                     a1 = ld32(ap + 8 * kAPitch + 32 * ks),
                     a2 = ld32(ap + 32 * ks + 16),
                     a3 = ld32(ap + 8 * kAPitch + 32 * ks + 16);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const uint8_t* bp = bt + (8 * nt + g) * kTPitch + 32 * ks + 4 * q;
        mma_s8(acc[nt], a0, a1, a2, a3, ld32(bp), ld32(bp + 16));
      }
    }
    __syncthreads();  // done with bt and this stage before they are reused
  }

  uint8_t* cs = bt;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int col = 8 * nt + 2 * q;
    *reinterpret_cast<uint16_t*>(cs + (16 * warp + g) * kCPitch + col) =
        (acc[nt][0] > 0) | (acc[nt][1] > 0) << 8;
    *reinterpret_cast<uint16_t*>(cs + (16 * warp + g + 8) * kCPitch + col) =
        (acc[nt][2] > 0) | (acc[nt][3] > 0) << 8;
  }
  __syncthreads();
  for (int i = t; i < kBM * kBN / 16; i += kThreads) {  // 16-byte chunks
    const int r = i / (kBN / 16), cc = i % (kBN / 16) * 16;
    const int gr = row0 + r, gc = col0 + cc;
    if (gr >= m || gc >= n) continue;
    uint8_t* dst = c + (long long)gr * n + gc;
    const uint8_t* src = cs + r * kCPitch + cc;
    if (kVec)
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    else
      for (int j = 0; j < 16 && gc + j < n; ++j) dst[j] = src[j];
  }
}

}  // namespace

// a uint8[M, K], b uint8[K, N] holding 0/1 -> c uint8[M, N] holding 0/1.
extern "C" int bool_matmul_launch(const void* a, const void* b, void* c,
                                  int m, int n, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m > 0 && n > 0) {
    const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
    const bool vec = k % 16 == 0 && n % 16 == 0 &&
                     ((uintptr_t)a | (uintptr_t)b | (uintptr_t)c) % 16 == 0;
    const auto* pa = static_cast<const uint8_t*>(a);
    const auto* pb = static_cast<const uint8_t*>(b);
    auto* pc = static_cast<uint8_t*>(c);
    if (vec)
      bool_mm<true><<<grid, kThreads, 0, s>>>(pa, pb, pc, m, n, k);
    else
      bool_mm<false><<<grid, kThreads, 0, s>>>(pa, pb, pc, m, n, k);
  }
  return (int)cudaGetLastError();
}
