// flash_attention: blocked online-softmax attention, causal / sliding-window,
// grouped-query, m / l / acc in f32.  bf16 calls run on the tensor cores
// (wgmma, K/V tiles by TMA); f32 calls run on f32 FMAs.
//
// Replaces the TPU kernel flash_one_head (src/repro/kernels/flash_attention/
// kernel.py:81) and what its wrapper (ops.py) does around it.  There the
// grid walks (q tile, kv tile) in order on one core and carries m, l, acc in
// VMEM scratch across the kv axis; here one block owns one (batch, head,
// q tile) and a loop inside the block walks the kv tiles.  The wrapper's
// GQA repeat becomes an index (kv head = h / (H / Hkv)), its padding to
// tile multiples and the key-padding mask become bounds (TMA zero fill, a
// mask on the tiles that cross S), and kv tiles wholly outside the causal /
// window band are skipped (the TPU kernel runs and discards them; skipping
// is exact, since such a tile leaves m, l and acc unchanged).
//
// Arithmetic follows the TPU kernel: s = (q . k) * scale in f32, masked
// entries -1e30, the "safe max" keeps rows that have seen no visible key
// finite, l sums the f32 p, and out = acc / (l or 1).
//
// Bound: max(bytes of q, k, v and out over the memory rate, 4 D flops per
// visible (q, k) pair over the bf16 tensor-core peak): operations, at the
// LM's prefill shapes.
//
// bf16, flash_wgmma: a block of two consumer warpgroups owns 128 query rows
// (64 each); one thread starts TMA copies (cp.async.bulk.tensor, mbarrier
// completion) of the q tile once and of 128-key K and V tiles into a ring
// of two stages, so tile j+1 is in flight while tile j is multiplied.
// S = Q.K^T is wgmma m64n128k16 with both operands K-major in shared memory;
// O += P.V is wgmma with P in registers (the f32 score fragment converted
// in place to bf16 A-operand fragments) and V as an MN-major B operand
// (the transpose bit).  The tensor maps read q, k, v through their strides
// (a [B,S,H,D] buffer viewed as [B,H,S,D] needs no copy; the wrapper copies
// a tensor whose strides or base TMA cannot describe).  D is padded to 16
// (D = 8, 16) or 128 (D = 120, 128) by TMA's zero fill past the real
// width: the padded columns add nothing to Q.K^T and the output columns
// past D are not stored.  The mask is applied only on tiles that cross the
// band edge or S.  Causal q tiles run longest first.
//
// P.V takes p as two bf16 terms, p = hi + lo (lo = bf16(p - hi)), so p
// enters the product to ~2^-17 of its value, near the TPU kernel's f32 p
// against bf16 v; l keeps the f32 p.  One bf16 term (what a TPU does with
// an f32 dot operand at its default precision) would halve the P.V work,
// but it misses the bf16 kernel's check against the f32 answer several
// times over where an output is a near-cancelling sum of a few large p v
// (chip_smoke.py's p_one_bf16_term_margin).  exp is the hardware's ex2 of
// the score in log2 units (the scale and log2 e folded into one multiply).
//
// What stands between this kernel and the fastest known Hopper attention:
// the second P.V product, no warp specialisation (one thread of the first
// warpgroup starts the copies and its warpgroup waits on the ring's free
// slots), no overlap of one tile's softmax with the next tile's Q.K^T
// inside a warpgroup (the registers are spent: 235 a thread), no
// setmaxnreg, no clusters.  Ordering the two warpgroups' Q.K^T by named
// barriers (ping-pong) made it slower on the H100.
//
// f32, flash_fma: 256 threads, each holding a 4x4 patch of a 64x64 score
// tile and 4 rows x D/16 columns of the accumulator, run f32 FMAs on
// shared-memory tiles (K and V share one buffer), p kept in f32: the f32
// path stays exact to 2e-5, which TF32 tensor cores would not be; f32
// attention serves the f32 smoke configs, not the LM's main path.
#include <cuda.h>  // CUtensorMap and its enums; no libcuda symbol is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// element strides of the batch, head and sequence dims (head dim is dense)
struct Strides {
  long long b, h, s;
};

// ------------------------------------------------------- f32: FMA kernel ---

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;  // 16 x 16; ty owns 4 rows, tx 4 key columns

// a reduction over the 16 lanes that share a row (a half warp)
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

template <int D>
constexpr int fma_smem_bytes() {
  return ((kBQ + kBK) * (D + 1) + kBQ * (kBK + 1)) * (int)sizeof(float);
}

// rows [r0, r0 + kBQ) of one head into a padded tile, zero past s_len
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long stride, int r0,
                                          int s_len) {
  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    dst[r * (D + 1) + d] = (r0 + r < s_len) ? src[(r0 + r) * stride + d] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fma(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, Strides sq,
              Strides sk, Strides sv, Strides so, int s_len, int h_per_kv,
              int causal, int window, float scale) {
  static_assert(kBQ == kBK, "load_tile serves q and kv tiles alike");
  constexpr int kSD = D + 1;          // padded row stride: no bank conflicts
  constexpr int kSP = kBK + 1;
  constexpr int kDC = (D + 15) / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;              // [kBQ][kSD]
  float* kvs = qs + kBQ * kSD;   // [kBK][kSD]: K, then V of the same tile
  float* ps = kvs + kBK * kSD;   // [kBQ][kSP]: p of the tile

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / h_per_kv;
  const float* kb = k + b * sk.b + hk * sk.h;
  const float* vb = v + b * sv.b + hk * sv.h;
  load_tile<D>(qs, q + b * sq.b + h * sq.h, sq.s, q0, s_len);

  float m[4], l[4], acc[4][kDC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDC; ++c) acc[i][c] = 0.f;
  }

  // the kv tiles that hold a visible key for at least one row of this tile
  const int k_hi = causal ? min(s_len, q0 + kBQ) : s_len;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) / kBK * kBK : 0;
  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // the q tile is in, the last tile's V reads are done
    load_tile<D>(kvs, kb, sk.s, k0, s_len);
    __syncthreads();

    float s[4][4] = {};
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * kSD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kvs[(tx + 16 * j) * kSD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
      bool vis[4];
      float mc = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        vis[j] = c < s_len && (!causal || r >= c) &&
                 (window <= 0 || r - c < window);
        s[i][j] = vis[j] ? s[i][j] * scale : kNegInf;
        mc = fmaxf(mc, s[i][j]);
      }
      const float mn = fmaxf(m[i], row_max16(mc));
      const float safe = mn <= kNegInf ? 0.f : mn;
      const float alpha = m[i] <= kNegInf ? 0.f : expf(m[i] - safe);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = vis[j] ? expf(s[i][j] - safe) : 0.f;
        ps[(ty * 4 + i) * kSP + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + row_sum16(rs);
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < kDC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // every score read of K is done, p is written
    load_tile<D>(kvs, vb, sv.s, k0, s_len);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * kSP + kk];
#pragma unroll
      for (int c = 0; c < kDC; ++c) {
        const int col = tx + 16 * c;
        if (col < D) {
          const float vv = kvs[kk * kSD + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
        }
      }
    }
  }

  float* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= s_len) continue;
    const float den = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < kDC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) ob[r * so.s + col] = acc[i][c] / den;
    }
  }
}

template <int D>
int launch_fma(const void* q, const void* k, const void* v, void* o,
               Strides sq, Strides sk, Strides sv, Strides so, int b, int h,
               int hkv, int s_len, int causal, int window,
               cudaStream_t stream) {
  // above 48 KB a block's dynamic shared memory must be allowed first, or
  // the launch is refused (set once per instantiation)
  static bool allowed = false;
  if (!allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        fma_smem_bytes<D>());
    if (e != cudaSuccess) return (int)e;
    allowed = true;
  }
  const float scale = (float)(1.0 / sqrt((double)D));
  const dim3 grid((s_len + kBQ - 1) / kBQ, h, b);
  flash_fma<D><<<grid, kThreads, fma_smem_bytes<D>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sq, sk, sv, so,
      s_len, h / hkv, causal, window, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------ bf16: wgmma + TMA kernel ---

constexpr int kRows = 128;    // q rows per block: 2 consumer warpgroups x 64
constexpr int kKeys = 128;    // keys per kv tile
constexpr int kStages = 2;    // kv tiles in flight
constexpr int kTcThreads = 256;

// A [128, DP] bf16 tile in shared memory, as TMA writes it and wgmma reads
// it: DP is cut into chunks of kCols columns, one swizzle span (kSpan bytes)
// each; a chunk is [128 rows][kSpan bytes], swizzled in atoms of 8 rows.
template <int DP>
struct Tile {
  static constexpr int kSpan = DP * 2 < 128 ? DP * 2 : 128;  // 32 or 128
  static constexpr int kCols = kSpan / 2;
  static constexpr int kChunks = DP / kCols;
  static constexpr int kChunkBytes = 128 * kSpan;
  static constexpr int kBytes = kChunks * kChunkBytes;  // = 128 * DP * 2
  static constexpr uint64_t kLayout = kSpan == 128 ? 1 : 3;  // B128 / B32
  // 1024 B of slack to align the tiles to the swizzle atom, the q tile,
  // kStages (K, V) pairs, then the barriers
  static constexpr int kSmem = 1024 + kBytes * (1 + 2 * kStages) + 64;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// until the phase of the given parity has completed; a wait of more than
// 2^35 cycles (~17 s) traps, so a lost copy faults instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 35)) __trap();
}

// one box (kCols x 128 rows) of a 4-d map (d, s, head, batch)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d0, int s0, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d0), "r"(s0), "r"(h), "r"(b),
      "r"(bar)
      : "memory");
}

// rows [s0, s0 + 128) of one head, every chunk, onto barrier bar
template <int DP>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int s0, int h, int b) {
#pragma unroll
  for (int c = 0; c < Tile<DP>::kChunks; ++c)
    tma_load(dst + c * Tile<DP>::kChunkBytes, map, bar, c * Tile<DP>::kCols,
             s0, h, b);
}

// wgmma shared-memory matrix descriptor: start address, leading byte
// offset (the stride between kCols-wide column chunks of an MN-major
// operand; unused for K-major swizzled ones), stride byte offset (between
// 8-row atoms), swizzle mode
template <int DP>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo) {
  constexpr uint32_t sbo = 8 * Tile<DP>::kSpan;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         Tile<DP>::kLayout << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps reads of wgmma results after the wait that makes them valid
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// keeps register A operands alive until the wait after their wgmma
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// d[64] (+)= A (smem, K-major) . B (smem, K-major), m64n128k16
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64] += A (registers) . B (smem, MN-major), m64n128k16
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[8] += A (registers) . B (smem, MN-major), m64n16k16
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  wgmma_rs_n128(d, a, db);
}
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4],
                                         uint64_t db) {
  wgmma_rs_n16(d, a, db);
}

// 2^x, the hardware's approximation
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Fragment layout of an m64nN f32 accumulator (scores and output alike):
// thread lane of warp w in its warpgroup holds element i at row
// 16 w + lane / 4 (+ 8 if i & 2) and column 8 (i / 4) + 2 (lane % 4) + (i & 1).
template <int DP>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_wgmma(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                __nv_bfloat16* __restrict__ o, Strides so, int s_len, int d,
                int h_per_kv, int n_heads, int causal, int window,
                float scale) {
  using T = Tile<DP>;
  constexpr int kO = DP / 2;  // output accumulator floats per thread
  constexpr int kKSteps = DP / 16, kStepsPerChunk = T::kCols / 16;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t kv_s = q_s + T::kBytes;  // stage st: K, then V
  const uint32_t bars = kv_s + 2 * kStages * T::kBytes;
  const uint32_t q_full = bars, full0 = bars + 8, empty0 = full0 + 8 * kStages;

  const int tid = threadIdx.x, wg = tid / 128, wtid = tid % 128;
  const int lane = tid % 32, g = lane / 4, c4 = lane % 4;
  // causal q tiles take longest last in the row: hand them out first
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kRows;
  const int b = blockIdx.x / n_heads, h = blockIdx.x % n_heads;
  const int hk = h / h_per_kv;

  // the kv tiles that hold a visible key for at least one row of the block
  const int k_hi = causal ? min(s_len, q0 + kRows) : s_len;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) / kKeys * kKeys : 0;
  const int n_tiles = (k_hi - k_lo + kKeys - 1) / kKeys;

  if (tid == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(q_full, T::kBytes);
    tma_tile<DP>(q_s, &qmap, q_full, q0, h, b);
    mbar_expect_tx(full0, 2 * T::kBytes);
    tma_tile<DP>(kv_s, &kmap, full0, k_lo, hk, b);
    tma_tile<DP>(kv_s + T::kBytes, &vmap, full0, k_lo, hk, b);
  }

  // this warpgroup's 64 rows, and this thread's two of them
  const int rlo = q0 + 64 * wg, rhi = rlo + 63;
  const int r0 = rlo + 16 * (wtid / 32) + g, r1 = r0 + 8;
  const uint32_t q_wg = q_s + 64 * wg * T::kSpan;
  // scores are scaled into log2 units, so p = exp(s scale - m) is one ex2
  const float scale2 = scale * 1.4426950408889634f;
  float acc[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) acc[i] = 0.f;
  // m: the rows' running max in log2 units; l: this thread's part of the
  // rows' sums of p
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  mbar_wait(q_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = k_lo + j * kKeys, st = j % kStages;
    if (tid == 0 && j + 1 < n_tiles) {
      // tile j + 1 goes where tile j + 1 - kStages was: wait until both
      // warpgroups are done with it
      const int nst = (j + 1) % kStages;
      if (j + 1 >= kStages)
        mbar_wait(empty0 + 8 * nst, ((j + 1 - kStages) / kStages) & 1);
      const uint32_t dst = kv_s + nst * 2 * T::kBytes;
      mbar_expect_tx(full0 + 8 * nst, 2 * T::kBytes);
      tma_tile<DP>(dst, &kmap, full0 + 8 * nst, k0 + kKeys, hk, b);
      tma_tile<DP>(dst + T::kBytes, &vmap, full0 + 8 * nst, k0 + kKeys, hk,
                    b);
    }
    __syncwarp();
    mbar_wait(full0 + 8 * st, (j / kStages) & 1);
    const uint32_t k_s = kv_s + st * 2 * T::kBytes, v_s = k_s + T::kBytes;

    // the band against this warpgroup's rows: none, all, or some visible
    const int kl = k0 + kKeys - 1;
    const bool none =
        (causal && k0 > rhi) || (window > 0 && rlo - kl >= window);
    if (!none) {
      const bool all = kl < s_len && (!causal || kl <= rlo) &&
                       (window <= 0 || rhi - k0 < window);
      float s[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        const uint32_t off = (kk / kStepsPerChunk) * T::kChunkBytes +
                             (kk % kStepsPerChunk) * 32;
        wgmma_ss_n128(s, smem_desc<DP>(q_wg + off, 16),
                      smem_desc<DP>(k_s + off, 16), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        float x = s[i] * scale2;
        if (!all) {
          const int col = k0 + 8 * (i / 4) + 2 * c4 + (i & 1);
          const int row = (i & 2) ? r1 : r0;
          const bool vis = col < s_len && (!causal || row >= col) &&
                           (window <= 0 || row - col < window);
          x = vis ? x : kNegInf;
        }
        s[i] = x;
        if (i & 2)
          mx1 = fmaxf(mx1, x);
        else
          mx0 = fmaxf(mx0, x);
      }
      // the four lanes of a quad share a row
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float sf0 = mn0 <= kNegInf ? 0.f : mn0;
      const float sf1 = mn1 <= kNegInf ? 0.f : mn1;
      const float al0 = m0 <= kNegInf ? 0.f : ex2(m0 - sf0);
      const float al1 = m1 <= kNegInf ? 0.f : ex2(m1 - sf1);
      m0 = mn0;
      m1 = mn1;
      // p = 2^(s - safe max); a masked s (-1e30) gives exactly 0.  The
      // score fragment of keys [16 kk, 16 kk + 16) is the A fragment of
      // the kk-th k-step of P.V: a0 (row r0, keys 2c4..), a1 (r1, same
      // keys), a2 (r0, keys + 8), a3 (r1, keys + 8).  p goes in as two
      // bf16 terms, p = hi + lo, so P.V sees p to 2^-17 of its value
      uint32_t ph[8][4], pl[8][4];
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int i = 8 * kk + 2 * jj;
          const float sf = (jj & 1) ? sf1 : sf0;
          const float p0 = ex2(s[i] - sf), p1 = ex2(s[i + 1] - sf);
          if (jj & 1)
            ps1 += p0 + p1;
          else
            ps0 += p0 + p1;
          const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
          const float2 back = __bfloat1622float2(hi);
          ph[kk][jj] = *reinterpret_cast<const uint32_t*>(&hi);
          pl[kk][jj] = pack_bf16(p0 - back.x, p1 - back.y);
        }
      l0 = l0 * al0 + ps0;
      l1 = l1 * al1 + ps1;
#pragma unroll
      for (int i = 0; i < kO; ++i) acc[i] *= (i & 2) ? al1 : al0;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint64_t dv =
            smem_desc<DP>(v_s + kk * 16 * T::kSpan, T::kChunkBytes);
        wgmma_rs(acc, ph[kk], dv);
        wgmma_rs(acc, pl[kk], dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(ph);
      fence_regs(pl);
    }
    if (wtid == 0) mbar_arrive(empty0 + 8 * st);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(kFull, l0, off);
    l1 += __shfl_xor_sync(kFull, l1, off);
  }
  const float den0 = l0 == 0.f ? 1.f : l0, den1 = l1 == 0.f ? 1.f : l1;
  __nv_bfloat16* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int jc = 0; jc < kO / 4; ++jc) {
    const int col = 8 * jc + 2 * c4;  // d is even: col < d means col + 1 < d
    if (col >= d) continue;
    if (r0 < s_len)
      *reinterpret_cast<__nv_bfloat162*>(ob + r0 * so.s + col) =
          __floats2bfloat162_rn(acc[4 * jc] / den0, acc[4 * jc + 1] / den0);
    if (r1 < s_len)
      *reinterpret_cast<__nv_bfloat162*>(ob + r1 * so.s + col) =
          __floats2bfloat162_rn(acc[4 * jc + 2] / den1,
                                acc[4 * jc + 3] / den1);
  }
}

// cuTensorMapEncodeTiled, from libcuda.so.1 (loaded by the CUDA runtime)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// a map over a [batch, heads, s_len, d] bf16 tensor with element strides st
// (d dense), read in boxes of kCols x 128 rows, zero past d and s_len
template <int DP>
bool make_map(CUtensorMap* map, const void* p, Strides st, int batch,
              int heads, int s_len, int d) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s_len,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)Tile<DP>::kCols, 128, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(p), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                Tile<DP>::kSpan == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                       : CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kErrTensorMap = -1;  // a tensor map could not be encoded

template <int DP>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 Strides sq, Strides sk, Strides sv, Strides so, int b, int h,
                 int hkv, int s_len, int d, int causal, int window,
                 cudaStream_t stream) {
  static bool allowed = false;
  if (!allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_wgmma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Tile<DP>::kSmem);
    if (e != cudaSuccess) return (int)e;
    allowed = true;
  }
  CUtensorMap qm, km, vm;
  if (!make_map<DP>(&qm, q, sq, b, h, s_len, d) ||
      !make_map<DP>(&km, k, sk, b, hkv, s_len, d) ||
      !make_map<DP>(&vm, v, sv, b, hkv, s_len, d))
    return kErrTensorMap;
  const float scale = (float)(1.0 / sqrt((double)d));
  const dim3 grid(b * h, (s_len + kRows - 1) / kRows);
  flash_wgmma<DP><<<grid, kTcThreads, Tile<DP>::kSmem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), so, s_len, d, h / hkv, h,
      causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B,H,S,D], k/v [B,Hkv,S,D], o [B,H,S,D], each given by its element
// strides of the first three dims (the last dim is dense); bf16 != 0 means
// __nv_bfloat16 (the wgmma kernel: base addresses and strides must be
// multiples of 16 bytes, as TMA reads them), else float (the FMA kernel).
// D in {8, 16, 120, 128}.  Returns a CUDA error code, or -1 if a tensor
// map could not be encoded.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, long long qsb,
    long long qsh, long long qss, long long ksb, long long ksh,
    long long kss, long long vsb, long long vsh, long long vss,
    long long osb, long long osh, long long oss, int b, int h, int hkv,
    int s_len, int d, int bf16, int causal, int window, void* stream) {
  if (b == 0 || h == 0 || s_len == 0) return (int)cudaGetLastError();
  const Strides sq{qsb, qsh, qss}, sk{ksb, ksh, kss}, sv{vsb, vsh, vss},
      so{osb, osh, oss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (d == 8 || d == 16)
      return launch_wgmma<16>(q, k, v, o, sq, sk, sv, so, b, h, hkv, s_len,
                              d, causal, window, st);
    if (d == 120 || d == 128)
      return launch_wgmma<128>(q, k, v, o, sq, sk, sv, so, b, h, hkv, s_len,
                               d, causal, window, st);
    return (int)cudaErrorInvalidValue;
  }
  switch (d) {
    case 8:
      return launch_fma<8>(q, k, v, o, sq, sk, sv, so, b, h, hkv, s_len,
                           causal, window, st);
    case 16:
      return launch_fma<16>(q, k, v, o, sq, sk, sv, so, b, h, hkv, s_len,
                            causal, window, st);
    case 120:
      return launch_fma<120>(q, k, v, o, sq, sk, sv, so, b, h, hkv, s_len,
                             causal, window, st);
    case 128:
      return launch_fma<128>(q, k, v, o, sq, sk, sv, so, b, h, hkv, s_len,
                             causal, window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
