// K2: the fused slab gather.
//
// Replaces the `two_level` row gathers of gatekeeper_tpu/parallel/
// sharding.py:771-806: out[n, l, :] = tab[clamp(ids[n, l], 0, V - 1), :],
// or, for ids at or above v_base (a review batch's ephemeral vocabulary),
// ov[clamp(ids[n, l] - v_base, 0, B - 1), :]. The clamps are JAX's: an
// out-of-range index in CUDA would read garbage where XLA clamps.
//
// Bound: bytes. The output [N, L, T] is written once and is far larger
// than the rows it reads (V x T tables, each row read by many tokens and
// served from L2). Threads walk the flattened output with the column
// fastest, so a warp reads one table row's columns contiguously and writes
// contiguous output; the kernel moves bytes of width 1 (bool) or 4
// (int32/float32) without looking at their type.

#include <cstdint>
#include <cuda_runtime.h>

template <typename T>
__global__ void slab_kernel(const T* __restrict__ tab, int V,
                            const T* __restrict__ ov, int B,
                            const int32_t* __restrict__ ids, int v_base,
                            T* __restrict__ out, long long n_tok, int cols) {
  const long long total = n_tok * cols;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long t = i / cols;
    const int c = (int)(i - t * cols);
    const int id = ids[t];
    T v;
    const int loc = id - v_base;
    if (ov != nullptr && loc >= 0) {
      v = ov[(long long)min(loc, B - 1) * cols + c];
    } else {
      v = tab[(long long)min(max(id, 0), V - 1) * cols + c];
    }
    out[i] = v;
  }
}

extern "C" int gk_slab_gather(const void* tab, int V, const void* ov, int B,
                              const int32_t* ids, int v_base, void* out,
                              long long n_tok, int cols, int elem_bytes,
                              void* stream) {
  const long long total = n_tok * cols;
  const int block = 256;
  long long want = (total + block - 1) / block;
  int grid = (int)(want < 132LL * 64 ? want : 132LL * 64);
  if (grid < 1) grid = 1;
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 1) {
    slab_kernel<uint8_t><<<grid, block, 0, s>>>(
        (const uint8_t*)tab, V, (const uint8_t*)ov, B, ids, v_base,
        (uint8_t*)out, n_tok, cols);
  } else if (elem_bytes == 4) {
    slab_kernel<uint32_t><<<grid, block, 0, s>>>(
        (const uint32_t*)tab, V, (const uint32_t*)ov, B, ids, v_base,
        (uint32_t*)out, n_tok, cols);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
