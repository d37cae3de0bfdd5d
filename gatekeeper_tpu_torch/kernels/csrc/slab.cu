// K2: the fused slab gather, as a write-bound tile gather.
//
// Replaces the `two_level` row gathers of gatekeeper_tpu/parallel/
// sharding.py:771-806: out[n, l, :] = tab[clamp(ids[n, l], 0, V - 1), :],
// or, for ids at or above v_base (a review batch's ephemeral vocabulary),
// ov[min(ids[n, l] - v_base, B - 1), :]. The clamps are JAX's: an
// out-of-range index in CUDA would read garbage where XLA clamps.
//
// Bound: bytes written. The output [N, L, T] is written once and is far
// larger than what it reads: the ids once, and the rows of a [V, T] table
// (4.4 MB at V = 100k, T = 44 bool) that stays in the 50 MB L2.
//
// What held the first design back (its SASS, PERF.md): one thread per
// output element, each dividing its 64-bit flat index by the runtime
// column count. The compiler guards a 64-bit division subroutine with a
// test of the high words and, at these sizes, runs an inline 32-bit
// division instead, its reciprocal (I2F, MUFU.RCP, F2I on the quarter-rate
// pipe) recomputed for every element; with the id reload, the clamps and
// 64-bit addressing, about 50 instructions per output byte, stored one
// byte at a time. At [32768, 128, 44] bool that was instruction-bound,
// 6.6x its bound on the H100.
//
// This design: the flattened tokens are cut into tiles of `tile` tokens
// (a multiple of 16), so a tile's output is one contiguous span of
// tile * T * elem bytes that starts 16-byte aligned. A persistent grid
// walks the tiles. Per tile, each token's id is read once, clamped, and
// turned into a row address; the rows are copied into shared memory in
// `Word`s (the widest of 16/8/4/2/1 bytes that divides the row width and
// both tables' base addresses), with the thread's (token, word) position
// stepped without any division; then the span goes out as 16-byte
// streaming stores, its last few bytes singly. The wrapper picks tile and
// word width (ops.slab_plan).

#include <cstdint>
#include <cuda_runtime.h>

template <typename Word>
__global__ void __launch_bounds__(256)
slab_kernel(const unsigned char* __restrict__ tab, int V,
            const unsigned char* __restrict__ ov, int B,
            const int32_t* __restrict__ ids, int v_base,
            unsigned char* __restrict__ out, long long n_tok,
            int row_bytes, int tile, long long n_tiles) {
  extern __shared__ __align__(16) unsigned char sh[];
  const int tile_bytes = tile * row_bytes;
  unsigned char* stage = sh;
  const unsigned char** src =
      (const unsigned char**)(sh + ((tile_bytes + 15) & ~15));
  const int W = row_bytes / (int)sizeof(Word);  // words per row
  // this thread's (token, word) within a tile and its step: the only
  // divisions, once per thread
  const int tok0 = threadIdx.x / W, word0 = threadIdx.x % W;
  const int dtok = blockDim.x / W, dword = blockDim.x % W;

  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long first = t * tile;
    const int n_here = (int)min((long long)tile, n_tok - first);
    // 1. one id per token: clamp it and pick base or overlay row once
    for (int i = threadIdx.x; i < n_here; i += blockDim.x) {
      const int id = __ldcs(ids + first + i);
      const int loc = id - v_base;
      src[i] = (ov != nullptr && loc >= 0)
                   ? ov + (size_t)min(loc, B - 1) * row_bytes
                   : tab + (size_t)min(max(id, 0), V - 1) * row_bytes;
    }
    __syncthreads();
    // 2. rows into shared memory, word k of the tile at byte k * sizeof(Word)
    const int n_words = n_here * W;
    int tok = tok0, word = word0;
#pragma unroll 4
    for (int k = threadIdx.x; k < n_words; k += blockDim.x) {
      ((Word*)stage)[k] = __ldg((const Word*)src[tok] + word);
      tok += dtok;
      word += dword;
      if (word >= W) {
        word -= W;
        ++tok;
      }
    }
    __syncthreads();
    // 3. the span out: 16-byte streaming stores, then the ragged tail
    const int n_bytes = n_here * row_bytes;
    unsigned char* dst = out + (size_t)first * row_bytes;
    const int n_vec = n_bytes >> 4;
    for (int v = threadIdx.x; v < n_vec; v += blockDim.x)
      __stcs((uint4*)dst + v, ((const uint4*)stage)[v]);
    for (int b = (n_vec << 4) + threadIdx.x; b < n_bytes; b += blockDim.x)
      dst[b] = stage[b];
    __syncthreads();  // the next tile reuses stage and src
  }
}

template <typename Word>
static int launch(const void* tab, int V, const void* ov, int B,
                  const int32_t* ids, int v_base, void* out, long long n_tok,
                  int row_bytes, int tile, long long n_tiles, int grid,
                  int smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        slab_kernel<Word>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  slab_kernel<Word><<<grid, 256, smem, s>>>(
      (const unsigned char*)tab, V, (const unsigned char*)ov, B, ids, v_base,
      (unsigned char*)out, n_tok, row_bytes, tile, n_tiles);
  return (int)cudaGetLastError();
}

// word_bytes, tile, grid and smem come from the wrapper's plan
// (ops.slab_plan); the checks here refuse a plan the kernel cannot run.
extern "C" int gk_slab_gather(const void* tab, int V, const void* ov, int B,
                              const int32_t* ids, int v_base, void* out,
                              long long n_tok, int row_bytes, int word_bytes,
                              int tile, int grid, int smem, void* stream) {
  const uintptr_t align = (uintptr_t)tab | (uintptr_t)(ov ? ov : tab) |
                          (uintptr_t)row_bytes;
  if (((uintptr_t)out & 15) || (align & (word_bytes - 1)) ||
      tile <= 0 || (tile & 15) || grid <= 0 || V <= 0 || row_bytes <= 0 ||
      (ov != nullptr && B <= 0) ||
      (long long)smem < ((long long)tile * row_bytes + 15) / 16 * 16 + 8LL * tile)
    return (int)cudaErrorInvalidValue;
  const long long n_tiles = (n_tok + tile - 1) / tile;
  cudaStream_t s = (cudaStream_t)stream;
  switch (word_bytes) {
    case 16: return launch<uint4>(tab, V, ov, B, ids, v_base, out, n_tok,
                                  row_bytes, tile, n_tiles, grid, smem, s);
    case 8: return launch<uint2>(tab, V, ov, B, ids, v_base, out, n_tok,
                                 row_bytes, tile, n_tiles, grid, smem, s);
    case 4: return launch<uint32_t>(tab, V, ov, B, ids, v_base, out, n_tok,
                                    row_bytes, tile, n_tiles, grid, smem, s);
    case 2: return launch<uint16_t>(tab, V, ov, B, ids, v_base, out, n_tok,
                                    row_bytes, tile, n_tiles, grid, smem, s);
    case 1: return launch<uint8_t>(tab, V, ov, B, ids, v_base, out, n_tok,
                                   row_bytes, tile, n_tiles, grid, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
