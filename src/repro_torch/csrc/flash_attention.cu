// flash_attention: blocked online-softmax attention, causal / sliding-window,
// grouped-query, f32 or bf16 in and out, m / l / acc in f32.
//
// Replaces the TPU kernel flash_one_head (src/repro/kernels/flash_attention/
// kernel.py:81) and what its wrapper (ops.py) does around it.  There the
// grid walks (q tile, kv tile) in order on one core and carries m, l, acc in
// VMEM scratch across the kv axis; here one block owns one (batch, head,
// 64-row q tile) and a loop inside the block walks the kv tiles.  The
// wrapper's GQA repeat becomes an index (kv head = h / (H / Hkv)), its
// padding to tile multiples and the key-padding mask become bounds checks,
// and kv tiles wholly outside the causal / window band are skipped (the TPU
// kernel runs and discards them; skipping is exact, since such a tile
// leaves m, l and acc unchanged).
//
// Arithmetic follows the TPU kernel step for step: s = (q . k) * scale in
// f32, masked entries -1e30, the "safe max" keeps rows that have seen no
// visible key finite, p = exp(s - m) in f32 (not rounded to bf16), and
// out = acc / (l or 1).
//
// Bound: max(bytes of q, k, v and out over the memory rate, 4 D flops per
// visible (q, k) pair over the bf16 tensor-core peak).  This first version
// uses no tensor cores: 256 threads, each holding a 4x4 patch of the score
// tile and 4 rows x D/16 columns of the accumulator, run f32 FMAs on
// shared-memory tiles (K and V share one buffer), so it is bound by
// shared-memory loads and f32 FMA issue, far above the tensor-core bound.
// The mma / wgmma redesign comes later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;  // 16 x 16; ty owns 4 rows, tx 4 key columns
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// element strides of the batch, head and sequence dims (head dim is dense)
struct Strides {
  long long b, h, s;
};

// a reduction over the 16 lanes that share a row (a half warp)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

template <int D>
constexpr int smem_bytes() {
  return ((kBQ + kBK) * (D + 1) + kBQ * (kBK + 1)) * (int)sizeof(float);
}

// rows [r0, r0 + kBQ) of one head into a padded f32 tile, zero past s_len
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long stride, int r0,
                                          int s_len) {
  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    dst[r * (D + 1) + d] =
        (r0 + r < s_len) ? to_f32(src[(r0 + r) * stride + d]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, Strides sq,
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
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;
  load_tile<T, D>(qs, q + b * sq.b + h * sq.h, sq.s, q0, s_len);

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
    load_tile<T, D>(kvs, kb, sk.s, k0, s_len);
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
      const float mn = fmaxf(m[i], row_max(mc));
      const float safe = mn <= kNegInf ? 0.f : mn;
      const float alpha = m[i] <= kNegInf ? 0.f : expf(m[i] - safe);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = vis[j] ? expf(s[i][j] - safe) : 0.f;
        ps[(ty * 4 + i) * kSP + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < kDC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // every score read of K is done, p is written
    load_tile<T, D>(kvs, vb, sv.s, k0, s_len);
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

  T* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= s_len) continue;
    const float den = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < kDC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) store(ob + r * so.s + col, acc[i][c] / den);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, Strides sq,
           Strides sk, Strides sv, Strides so, int b, int h, int hkv,
           int s_len, int causal, int window, cudaStream_t stream) {
  // above 48 KB a block's dynamic shared memory must be allowed first, or
  // the launch is refused (set once per instantiation)
  static bool allowed = false;
  if (!allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes<D>());
    if (e != cudaSuccess) return (int)e;
    allowed = true;
  }
  const float scale = (float)(1.0 / sqrt((double)D));
  const dim3 grid((s_len + kBQ - 1) / kBQ, h, b);
  flash_fwd<T, D><<<grid, kThreads, smem_bytes<D>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, sv, so, s_len,
      h / hkv, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v, void* o,
             Strides sq, Strides sk, Strides sv, Strides so, int b, int h,
             int hkv, int s_len, int causal, int window, cudaStream_t st) {
  switch (d) {
    case 8:
      return launch<T, 8>(q, k, v, o, sq, sk, sv, so, b, h, hkv, s_len,
                          causal, window, st);
    case 16:
      return launch<T, 16>(q, k, v, o, sq, sk, sv, so, b, h, hkv, s_len,
                           causal, window, st);
    case 120:
      return launch<T, 120>(q, k, v, o, sq, sk, sv, so, b, h, hkv, s_len,
                            causal, window, st);
    case 128:
      return launch<T, 128>(q, k, v, o, sq, sk, sv, so, b, h, hkv, s_len,
                            causal, window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,H,S,D], k/v [B,Hkv,S,D], o [B,H,S,D], each given by its element
// strides of the first three dims (the last dim is dense); bf16 != 0 means
// __nv_bfloat16, else float.  D in {8, 16, 120, 128}.
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
  return bf16 ? dispatch<__nv_bfloat16>(d, q, k, v, o, sq, sk, sv, so, b, h,
                                        hkv, s_len, causal, window, st)
              : dispatch<float>(d, q, k, v, o, sq, sk, sv, so, b, h, hkv,
                                s_len, causal, window, st);
}
