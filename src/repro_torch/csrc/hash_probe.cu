// hash_probe: batched bounded open-addressing walk over the edge table.
//
// For each query lane i, walk slots (base[i] + p) & (C - 1) for
// p < max_probes, exactly as the sequential loop of
// repro.core.edge_table.lookup does: stop at a LIVE slot holding the key
// (found, slot = that slot) or at an EMPTY slot (chain end); remember the
// first non-LIVE slot seen as the insertion point.  slot is the hit when
// found, else the insertion point, else -1.  TOMB slots continue the chain;
// max_probes may exceed C (the walk then revisits slots, as the loop does).
//
// Replaces the TPU kernel probe_sweep (src/repro/kernels/hash_probe/
// kernel.py), which reads the WHOLE table per batch in panels and reduces
// per-lane offset minima -- a trade that only pays where gathers are slow.
// Here one thread per lane reads only the O(probe length) slots it visits.
//
// Bound: latency.  A lane's slots are dependent random reads (9 B per slot
// visited: src 4 + dst 4 + state 1) plus 12 B of key and base in and 5 B
// out; the byte bound of those reads is far below the time of one chain of
// dependent device-memory loads, so the kernel is bound by load latency.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int8_t kEmpty = 0;
constexpr int8_t kLive = 1;
constexpr int kThreads = 256;

__global__ void probe_walk(const int* __restrict__ src,
                           const int* __restrict__ dst,
                           const int8_t* __restrict__ state,
                           const int* __restrict__ base,
                           const int* __restrict__ u,
                           const int* __restrict__ v,
                           uint8_t* __restrict__ found,
                           int* __restrict__ slot, int b, unsigned int mask,
                           int max_probes) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b) return;
  const int ku = u[i], kv = v[i];
  const unsigned int start = (unsigned int)base[i];
  int hit = -1, free_slot = -1;
  for (int p = 0; p < max_probes; ++p) {
    const unsigned int pos = (start + (unsigned int)p) & mask;
    const int8_t st = state[pos];
    if (st == kLive) {
      if (src[pos] == ku && dst[pos] == kv) {
        hit = (int)pos;
        break;
      }
    } else {
      if (free_slot < 0) free_slot = (int)pos;
      if (st == kEmpty) break;
    }
  }
  found[i] = hit >= 0;
  slot[i] = hit >= 0 ? hit : free_slot;
}

}  // namespace

// src/dst int32[C], state int8[C], base/u/v int32[B] -> found uint8[B] (a
// torch.bool buffer), slot int32[B].  C is a power of two.
extern "C" int hash_probe_launch(const void* src, const void* dst,
                                 const void* state, const void* base,
                                 const void* u, const void* v, void* found,
                                 void* slot, int b, long long cap,
                                 int max_probes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b > 0)
    probe_walk<<<(b + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        static_cast<const int*>(src), static_cast<const int*>(dst),
        static_cast<const int8_t*>(state), static_cast<const int*>(base),
        static_cast<const int*>(u), static_cast<const int*>(v),
        static_cast<uint8_t*>(found), static_cast<int*>(slot), b,
        (unsigned int)(cap - 1), max_probes);
  return (int)cudaGetLastError();
}
