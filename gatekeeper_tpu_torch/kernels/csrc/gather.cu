// K6: EGatherElem, each token's value of its own array element.
//
// Replaces gatekeeper_tpu/engine/exprs.py:564-597 `EGatherElem._emit`, the
// inverse of EGroup (K3) that element-projected joins compile to (a
// volumes x volumeMounts join: the mount's name and readOnly flag, read on
// different tokens, gathered back onto every token of the mount):
//   out[n, l] = v[n, idx] if 0 <= idx < G, else `dflt`,
// with idx = idx0[n, l] on g0, and on g01 idx0 * g1 + idx1 when both are
// set, else -1. JAX's arithmetic is kept as it is: an idx1 >= g1 runs on
// into the next element's slot, and an idx past G takes the default.
//
// Bound: bytes. The index arrays are read once and the output written
// once; v [N, G] is small (G <= 64 x 64) and each row is read by the L
// tokens of its review from L1/L2. One thread per token, neighbouring
// threads on neighbouring tokens; the kernel moves elements of width 1
// (bool) or 4 (int32/float32) without looking at their type.

#include <cstdint>
#include <cuda_runtime.h>

template <typename T>
__global__ void gather_elem_kernel(const T* __restrict__ v, int G,
                                   const int32_t* __restrict__ idx0,
                                   const int32_t* __restrict__ idx1, int mode,
                                   int g1, T dflt, T* __restrict__ out,
                                   long long n_tok, int L) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_tok; i += stride) {
    int idx;
    if (mode == 0) {
      idx = idx0[i];
    } else {
      const int i0 = idx0[i], i1 = idx1[i];
      idx = (i0 >= 0 && i1 >= 0) ? i0 * g1 + i1 : -1;
    }
    const long long n = i / L;
    out[i] = (idx >= 0 && idx < G) ? v[n * G + idx] : dflt;
  }
}

extern "C" int gk_gather_elem(const void* v, int G, const int32_t* idx0,
                              const int32_t* idx1, int mode, int g1,
                              unsigned int dflt_bits, void* out,
                              long long n_tok, int L, int elem_bytes,
                              void* stream) {
  const int block = 256;
  long long want = (n_tok + block - 1) / block;
  int grid = (int)(want < 132LL * 64 ? want : 132LL * 64);
  if (grid < 1) grid = 1;
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 1) {
    gather_elem_kernel<uint8_t><<<grid, block, 0, s>>>(
        (const uint8_t*)v, G, idx0, idx1, mode, g1, (uint8_t)dflt_bits,
        (uint8_t*)out, n_tok, L);
  } else if (elem_bytes == 4) {
    gather_elem_kernel<uint32_t><<<grid, block, 0, s>>>(
        (const uint32_t*)v, G, idx0, idx1, mode, g1, (uint32_t)dflt_bits,
        (uint32_t*)out, n_tok, L);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
