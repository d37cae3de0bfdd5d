// K7: the per-constraint totals of the full-output audit step.
//
// Replaces the tail of gatekeeper_tpu/parallel/sharding.py:1066-1086
// (`FusedAuditKernel.prepare.run_fused`): JAX scatters the compiled
// programs' counts [Cc, N] onto a [C, N] int32 `viol` at the compiled
// constraint rows and reduces sum((where(match, viol, 0) > 0) & valid)
// over N. This kernel computes the same [C] int32 totals without `viol`:
//
//   totals[c] = #{n < n_valid : match[c, n] && counts[crow[c], n] > 0}
//
// where crow [C] maps a constraint row to its counts row; a row outside
// [0, Cc) (-1: an interpreter-routed constraint) totals 0.
//
// Bound: bytes. Each match row (N bytes) and the counts row it maps to
// (4N bytes) are read once, [C] int32 written; at C 500 x N 100k that is
// what JAX's form reads, without the 200 MB `viol` it writes and reads
// again. One block per constraint row walks its two rows with 16-byte
// counts loads (int4) beside 4-byte match loads (uchar4), neighbouring
// threads on neighbouring addresses; the ragged head and tail and rows
// whose two pointers cannot be aligned together take scalar loads. A warp
// shuffle and one shared-memory pass reduce the block's sum.

#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ int hit(unsigned char m, int v) {
  return (m != 0) & (v > 0);
}

__global__ void totals_kernel(const unsigned char* __restrict__ match,
                              const int* __restrict__ counts, int cc,
                              const int* __restrict__ crow, long long n,
                              long long n_valid, int* __restrict__ totals) {
  const int c = blockIdx.x;
  const int r = crow[c];
  if (r < 0 || r >= cc) {
    if (threadIdx.x == 0) totals[c] = 0;
    return;
  }
  const unsigned char* m = match + (long long)c * n;
  const int* v = counts + (long long)r * n;
  // elements before the counts row reaches a 16-byte boundary
  long long head = (long long)(((16 - ((uintptr_t)v & 15)) & 15) >> 2);
  if (head > n_valid) head = n_valid;
  long long nv = 0;
  if ((((uintptr_t)(m + head)) & 3) == 0) nv = (n_valid - head) >> 2;
  int acc = 0;
  for (long long i = threadIdx.x; i < head; i += blockDim.x)
    acc += hit(m[i], v[i]);
  const uchar4* m4 = reinterpret_cast<const uchar4*>(m + head);
  const int4* v4 = reinterpret_cast<const int4*>(v + head);
  for (long long i = threadIdx.x; i < nv; i += blockDim.x) {
    const uchar4 a = m4[i];
    const int4 b = v4[i];
    acc += hit(a.x, b.x) + hit(a.y, b.y) + hit(a.z, b.z) + hit(a.w, b.w);
  }
  for (long long i = head + (nv << 2) + threadIdx.x; i < n_valid;
       i += blockDim.x)
    acc += hit(m[i], v[i]);
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  __shared__ int warp_sum[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sum[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < (int)(blockDim.x >> 5) ? warp_sum[lane] : 0;
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) totals[c] = acc;
  }
}

extern "C" int gk_full_totals(const void* match, const void* counts, int cc,
                              const void* crow, int c, long long n,
                              long long n_valid, void* totals, void* stream) {
  if (c <= 0) return 0;
  totals_kernel<<<c, 256, 0, (cudaStream_t)stream>>>(
      (const unsigned char*)match, (const int*)counts, cc, (const int*)crow,
      n, n_valid, (int*)totals);
  return (int)cudaGetLastError();
}
