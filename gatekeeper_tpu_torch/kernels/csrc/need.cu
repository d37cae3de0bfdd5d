// K4: the need tail of one chunk.
//
// Replaces gatekeeper_tpu/parallel/sharding.py:852-872 (the tail of
// `_need_chunk_fn`) and the word packing of `run_all` (:677-708):
//   need[c, n] = match_u[spec_map[c], n] & (viol[c, n] | !compiled[c] |
//                row_fb[n]) & (n < n_valid)
//   compiled / interpreter pair counts, row-any, the ascending compaction
//   of hot rows (jnp.nonzero(size=r_cap, fill_value=-1)), the [C, R] gather
//   of their need columns and np.packbits (big-endian bit order) c-major,
//   the bytes assembled into little-endian int32 words.
// Output row (int32): [w4 packed words | R hot ids | n_hot | sc | si];
// `decode_need` (sharding.py:1120) is the specification of the bits.
//
// Bound: bytes. Pass 1 reads the [C, N] violation matrix and the gathered
// match rows once (one thread per review, coalesced across c rows) and
// never writes need itself, only a row-any byte per review; pass 2 compacts
// those N bytes in one block with a block-wide scan (order preserved); pass
// 3 recomputes the need bit of each (c, hot row) pair, one thread per bit,
// and a warp ballot plus a bit and byte reversal turns 32 bits into one
// little-endian word of big-endian bytes.

#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ bool need_bit(const uint8_t* match_u,
                                         const int32_t* spec_map,
                                         const uint8_t* viol,
                                         const uint8_t* compiled,
                                         const uint8_t* row_fb, int N, int c,
                                         int n) {
  if (!match_u[(size_t)spec_map[c] * N + n]) return false;
  return viol[(size_t)c * N + n] || !compiled[c] || row_fb[n];
}

__global__ void need_rows_kernel(const uint8_t* __restrict__ match_u,
                                 const int32_t* __restrict__ spec_map,
                                 const uint8_t* __restrict__ viol,
                                 const uint8_t* __restrict__ compiled,
                                 const uint8_t* __restrict__ row_fb, int C,
                                 int N, int n_valid,
                                 uint8_t* __restrict__ rowany,
                                 int32_t* __restrict__ stats) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  int sc = 0, si = 0;
  if (n < N) {
    bool any = false;
    if (n < n_valid) {
      const bool fb = row_fb[n];
      for (int c = 0; c < C; ++c) {
        if (!match_u[(size_t)spec_map[c] * N + n]) continue;
        const bool comp = compiled[c];
        const bool fallback = !comp || fb;
        any |= fallback || viol[(size_t)c * N + n];
        sc += comp && !fb;
        si += fallback;
      }
    }
    rowany[n] = any;
  }
  for (int off = 16; off > 0; off >>= 1) {
    sc += __shfl_down_sync(0xffffffffu, sc, off);
    si += __shfl_down_sync(0xffffffffu, si, off);
  }
  if ((threadIdx.x & 31) == 0 && (sc || si)) {
    atomicAdd(&stats[0], sc);
    atomicAdd(&stats[1], si);
  }
}

// One block: hot[0:min(total, R)] = ascending indices with rowany set,
// hot[total:R] = -1, *n_hot = total.
__global__ void compact_kernel(const uint8_t* __restrict__ rowany, int N,
                               int R, int32_t* __restrict__ hot,
                               int32_t* __restrict__ n_hot) {
  __shared__ int warp_tot[32];
  __shared__ int block_tot;
  const int t = threadIdx.x, T = blockDim.x;
  const int lane = t & 31, w = t >> 5;
  const int per = (N + T - 1) / T;
  const int lo = min(N, t * per), hi = min(N, lo + per);
  int cnt = 0;
  for (int i = lo; i < hi; ++i) cnt += rowany[i];
  // inclusive warp scan, then scan of the warp totals
  int inc = cnt;
  for (int off = 1; off < 32; off <<= 1) {
    int v = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += v;
  }
  if (lane == 31) warp_tot[w] = inc;
  __syncthreads();
  if (w == 0) {
    const int nw = T >> 5;
    int v = lane < nw ? warp_tot[lane] : 0;
    int s = v;
    for (int off = 1; off < 32; off <<= 1) {
      int u = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += u;
    }
    if (lane < nw) warp_tot[lane] = s - v;  // exclusive warp offsets
    if (lane == nw - 1) block_tot = s;
  }
  __syncthreads();
  int pos = warp_tot[w] + inc - cnt;
  for (int i = lo; i < hi; ++i) {
    if (rowany[i]) {
      if (pos < R) hot[pos] = i;
      ++pos;
    }
  }
  const int total = block_tot;
  for (int j = total + t; j < R; j += T) hot[j] = -1;
  if (t == 0) *n_hot = total;
}

__global__ void pack_kernel(const uint8_t* __restrict__ match_u,
                            const int32_t* __restrict__ spec_map,
                            const uint8_t* __restrict__ viol,
                            const uint8_t* __restrict__ compiled,
                            const uint8_t* __restrict__ row_fb, int N,
                            int n_valid, const int32_t* __restrict__ hot,
                            int R, long long total_bits,
                            int32_t* __restrict__ words) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  bool bit = false;
  if (i < total_bits) {
    const int c = (int)(i / R);
    const int h = hot[i - (long long)c * R];
    bit = h >= 0 && h < n_valid &&
          need_bit(match_u, spec_map, viol, compiled, row_fb, N, c, h);
  }
  // lane k holds bit i0 + k; packbits wants bit i0 + 8m + k at bit 7 - k
  // of byte m: __brev puts lane k at bit 31 - k (byte 3 - m, bit 7 - k),
  // and the byte permutation puts byte 3 - m back at byte m
  const unsigned b = __ballot_sync(0xffffffffu, bit);
  if ((threadIdx.x & 31) == 0 && i < total_bits)
    words[i >> 5] = (int32_t)__byte_perm(__brev(b), 0, 0x0123);
}

extern "C" int gk_need_tail(const uint8_t* match_u, const int32_t* spec_map,
                            const uint8_t* viol, const uint8_t* compiled,
                            const uint8_t* row_fb, int C, int N, int n_valid,
                            int R, uint8_t* rowany, int32_t* out, int w4,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int32_t* words = out;
  int32_t* hot = out + w4;
  int32_t* n_hot = hot + R;
  int32_t* stats = n_hot + 1;  // [compiled pairs, interpreter pairs]
  need_rows_kernel<<<(N + 255) / 256, 256, 0, s>>>(
      match_u, spec_map, viol, compiled, row_fb, C, N, n_valid, rowany,
      stats);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  compact_kernel<<<1, 1024, 0, s>>>(rowany, N, R, hot, n_hot);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long total_bits = (long long)C * R;
  const long long threads = (total_bits + 31) / 32 * 32;
  const int block = 256;
  const long long grid = (threads + block - 1) / block;
  pack_kernel<<<(unsigned)grid, block, 0, s>>>(
      match_u, spec_map, viol, compiled, row_fb, N, n_valid, hot, R,
      total_bits, words);
  return (int)cudaGetLastError();
}
