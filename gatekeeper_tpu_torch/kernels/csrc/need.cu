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
// `decode_need` (sharding.py:1120) is the specification of the bits. The
// wrapper zeroes the row together with the row-any scratch words that
// follow it (one allocation, one fill), so pass 1 and pass 3 may OR into
// them.
//
// Bound: bytes, the [C, N] violation matrix read once. The design keeps
// many independent 16-byte loads in flight, where a thread per review that
// walked C constraints with two dependent 1-byte loads each kept one
// sector per warp in flight and was latency-bound:
//  pass 1 (need_rows_kernel) a 2-D grid of review tiles x constraint
//    slices (ops.need_plan) fills the card several times over; a thread
//    covers 16 consecutive reviews with 16-byte loads of each viol row and
//    of its gathered match row (few distinct rows: L1/L2 hits), four
//    constraints at a time, all bytes handled as 4-byte SWAR words of 0/1
//    bytes. Row-any goes out as bit words (atomicOr: order-free, so
//    deterministic), the pair counts as popc sums (one atomicAdd per block);
//  pass 2 (compact_kernel) one block scans the N/32 bit words (popc and a
//    block-wide scan) and writes the hot ids in ascending order by walking
//    the bits, -1 up to R, and n_hot;
//  pass 3 (pack_kernel) a block stages a chunk of the hot ids in shared
//    memory and takes whole c rows of it; a warp computes 32 need bits of
//    one row (three independent 1-byte loads a bit, four tasks at a time)
//    and ORs their ballot into the one or two packed words they fall in.

#include <cstdint>
#include <cuda_runtime.h>

#define NEED_THREADS 256   // pass 1 and pass 3 blocks (ops.NEED_THREADS)
#define NEED_RPT 16        // reviews per pass-1 thread
#define NEED_TILE (NEED_THREADS * NEED_RPT)
#define NEED_MAX_CS 256    // constraints per pass-1 slice, at most
#define COMPACT_THREADS 1024

// 16 bytes of one [*, N] bool row at reviews n0..n0+15 as four 4-byte
// words (byte k of word q is review n0 + 4q + k); bytes past N read 0
template <bool VEC>
__device__ __forceinline__ void load16(const uint8_t* __restrict__ row, int n0,
                                       int N, uint32_t w[4]) {
  if (VEC && n0 + 16 <= N) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + n0));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) w[q] = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k)
    if (n0 + k < N) w[k >> 2] |= (uint32_t)__ldg(row + n0 + k) << (8 * (k & 3));
}

// one constraint over a thread's 16 reviews: m, v its match and viol
// words, fb the row fallbacks, vm the valid bytes (0x01 each)
__device__ __forceinline__ void accumulate(const uint32_t m[4],
                                           const uint32_t v[4], bool comp,
                                           const uint32_t fb[4],
                                           const uint32_t vm[4],
                                           uint32_t any[4], int& sc, int& si) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t mv = m[q] & vm[q];
    const uint32_t fsel = comp ? fb[q] : 0x01010101u;  // the fallback bytes
    any[q] |= mv & (v[q] | fsel);
    si += __popc(mv & fsel);   // matched and interpreter-routed
    sc += __popc(mv & ~fsel);  // matched, compiled, no row fallback
  }
}

template <bool VEC>
__global__ void __launch_bounds__(NEED_THREADS)
need_rows_kernel(const uint8_t* __restrict__ match_u,
                 const int32_t* __restrict__ spec_map,
                 const uint8_t* __restrict__ viol,
                 const uint8_t* __restrict__ compiled,
                 const uint8_t* __restrict__ row_fb, int C, int N,
                 int n_valid, int cs, uint32_t* __restrict__ rowwords,
                 int32_t* __restrict__ stats) {
  __shared__ int s_spec[NEED_MAX_CS];
  __shared__ bool s_comp[NEED_MAX_CS];
  const int c_lo = blockIdx.y * cs;
  const int c_hi = min(C, c_lo + cs);
  for (int i = threadIdx.x; i < c_hi - c_lo; i += NEED_THREADS) {
    s_spec[i] = spec_map[c_lo + i];
    s_comp[i] = compiled[c_lo + i];
  }
  const int n0 = blockIdx.x * NEED_TILE + threadIdx.x * NEED_RPT;
  const int nv = min(n_valid, N);
  uint32_t fb[4], vm[4], any[4] = {0u, 0u, 0u, 0u};
  load16<VEC>(row_fb, n0, N, fb);
  const int cnt = min(max(nv - n0, 0), 16);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int b = min(max(cnt - 4 * q, 0), 4);
    vm[q] = b == 4 ? 0x01010101u : (0x01010101u & ((1u << (8 * b)) - 1u));
  }
  __syncthreads();
  int sc = 0, si = 0;
  if (cnt > 0) {
    int c = c_lo;
    for (; c + 4 <= c_hi; c += 4) {
      uint32_t m[4][4], v[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        load16<VEC>(match_u + (size_t)s_spec[c - c_lo + k] * N, n0, N, m[k]);
        load16<VEC>(viol + (size_t)(c + k) * N, n0, N, v[k]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        accumulate(m[k], v[k], s_comp[c - c_lo + k], fb, vm, any, sc, si);
    }
    for (; c < c_hi; ++c) {
      uint32_t m[4], v[4];
      load16<VEC>(match_u + (size_t)s_spec[c - c_lo] * N, n0, N, m);
      load16<VEC>(viol + (size_t)c * N, n0, N, v);
      accumulate(m, v, s_comp[c - c_lo], fb, vm, any, sc, si);
    }
  }
  // 16 row-any bits (bit k = review n0 + k): the low bit of each byte
  // gathered by a multiply, then two lanes share one 32-bit word
  uint32_t bits = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    bits |= (((any[q] * 0x01020408u) >> 24) & 0xFu) << (4 * q);
  const int lane = threadIdx.x & 31;
  uint32_t word = bits << (16 * (lane & 1));
  word |= __shfl_xor_sync(0xffffffffu, word, 1);
  if (!(lane & 1) && word) atomicOr(&rowwords[n0 >> 5], word);
  // pair counts: warp sums, then block sums, then one atomicAdd per block
  // (every block adds into the same two words)
  __shared__ int s_cnt[2][NEED_THREADS / 32];
  for (int off = 16; off > 0; off >>= 1) {
    sc += __shfl_down_sync(0xffffffffu, sc, off);
    si += __shfl_down_sync(0xffffffffu, si, off);
  }
  if (lane == 0) {
    s_cnt[0][threadIdx.x >> 5] = sc;
    s_cnt[1][threadIdx.x >> 5] = si;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    sc = lane < NEED_THREADS / 32 ? s_cnt[0][lane] : 0;
    si = lane < NEED_THREADS / 32 ? s_cnt[1][lane] : 0;
    for (int off = 16; off > 0; off >>= 1) {
      sc += __shfl_down_sync(0xffffffffu, sc, off);
      si += __shfl_down_sync(0xffffffffu, si, off);
    }
    if (lane == 0 && (sc || si)) {
      atomicAdd(&stats[0], sc);
      atomicAdd(&stats[1], si);
    }
  }
}

// One block: hot[0:min(total, R)] = ascending review ids whose row-any bit
// is set, hot[total:R] = -1, *n_hot = total.
__global__ void __launch_bounds__(COMPACT_THREADS)
compact_kernel(const uint32_t* __restrict__ rowwords, int W, int R,
               int32_t* __restrict__ hot, int32_t* __restrict__ n_hot) {
  __shared__ int warp_tot[32];
  __shared__ int block_tot;
  const int t = threadIdx.x;
  const int lane = t & 31, w = t >> 5;
  const int per = (W + COMPACT_THREADS - 1) / COMPACT_THREADS;
  const int lo = min(W, t * per), hi = min(W, lo + per);
  int cnt = 0;
  for (int i = lo; i < hi; ++i) cnt += __popc(rowwords[i]);
  // inclusive warp scan, then scan of the warp totals
  int inc = cnt;
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += v;
  }
  if (lane == 31) warp_tot[w] = inc;
  __syncthreads();
  if (w == 0) {
    const int v = warp_tot[lane];  // COMPACT_THREADS / 32 == 32 warps
    int s = v;
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += u;
    }
    warp_tot[lane] = s - v;  // exclusive warp offsets
    if (lane == 31) block_tot = s;
  }
  __syncthreads();
  int pos = warp_tot[w] + inc - cnt;
  for (int i = lo; i < hi && pos < R; ++i) {
    uint32_t x = rowwords[i];
    while (x && pos < R) {
      hot[pos++] = i * 32 + (__ffs(x) - 1);
      x &= x - 1;
    }
  }
  const int total = block_tot;
  for (int j = total + t; j < R; j += COMPACT_THREADS) hot[j] = -1;
  if (t == 0) *n_hot = total;
}

// packbits order: linear bit p of a word (global bit 32w + p) goes to bit
// 7 - p % 8 of byte p / 8; __brev puts p at 31 - p (byte 3 - p / 8, bit
// 7 - p % 8) and the byte permutation puts byte 3 - m back at byte m
__device__ __forceinline__ uint32_t packed(uint32_t linear) {
  return __byte_perm(__brev(linear), 0, 0x0123);
}

// grid (ceil(C / cr), ceil(R / jc)): block (x, y) takes need rows
// [x*cr, x*cr + cr) at hot slots [y*jc, y*jc + jc); a warp task is 32
// slots of one row. Dynamic shared memory: jc hot ids, then cr spec rows
// and cr compiled flags.
__global__ void __launch_bounds__(NEED_THREADS)
pack_kernel(const uint8_t* __restrict__ match_u,
            const int32_t* __restrict__ spec_map,
            const uint8_t* __restrict__ viol,
            const uint8_t* __restrict__ compiled,
            const uint8_t* __restrict__ row_fb, int C, int N, int n_valid,
            const int32_t* __restrict__ hot, int R, int jc, int cr,
            uint32_t* __restrict__ words) {
  extern __shared__ int32_t sh[];
  int32_t* s_hot = sh;
  int32_t* s_spec = s_hot + jc;
  uint8_t* s_comp = reinterpret_cast<uint8_t*>(s_spec + cr);
  const int j_lo = blockIdx.y * jc, j_hi = min(R, j_lo + jc);
  const int c_lo = blockIdx.x * cr, c_hi = min(C, c_lo + cr);
  for (int j = j_lo + threadIdx.x; j < j_hi; j += NEED_THREADS) {
    const int h = hot[j];
    s_hot[j - j_lo] = (h >= 0 && h < n_valid) ? h : -1;
  }
  for (int i = threadIdx.x; i < c_hi - c_lo; i += NEED_THREADS) {
    s_spec[i] = spec_map[c_lo + i];
    s_comp[i] = compiled[c_lo + i];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5, nwarps = NEED_THREADS / 32;
  const int nt = (j_hi - j_lo + 31) / 32;  // tasks per row
  const int total = (c_hi - c_lo) * nt;
  for (int t0 = warp; t0 < total; t0 += 4 * nwarps) {
    int ci[4], js[4];
    bool m[4], v[4], f[4], live[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // warp-uniform task indices
      const int task = t0 + k * nwarps;
      ci[k] = task < total ? task / nt : 0;
      js[k] = j_lo + (task - ci[k] * nt) * 32;
      const int j = js[k] + lane;
      const int h = (task < total && j < j_hi) ? s_hot[j - j_lo] : -1;
      live[k] = h >= 0;
      m[k] = v[k] = f[k] = false;
      if (live[k]) {
        m[k] = match_u[(size_t)s_spec[ci[k]] * N + h];
        v[k] = viol[(size_t)(c_lo + ci[k]) * N + h];
        f[k] = row_fb[h];
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (t0 + k * nwarps >= total) break;
      const bool bit =
          live[k] && m[k] && (v[k] || !s_comp[ci[k]] || f[k]);
      const uint32_t b = __ballot_sync(0xffffffffu, bit);
      if (lane == 0 && b) {
        const long long i0 = (long long)(c_lo + ci[k]) * R + js[k];
        const int s = (int)(i0 & 31);
        atomicOr(&words[i0 >> 5], packed(b << s));
        if (s && (b >> (32 - s))) atomicOr(&words[(i0 >> 5) + 1], packed(b >> (32 - s)));
      }
    }
  }
}

// plan: cs, g1x, g1y (pass 1), jc, cr, g3x, g3y, smem3 (pass 3), vec
extern "C" int gk_need_tail(const uint8_t* match_u, const int32_t* spec_map,
                            const uint8_t* viol, const uint8_t* compiled,
                            const uint8_t* row_fb, int C, int N, int n_valid,
                            int R, int32_t* out, int w4, int cs, int g1x,
                            int g1y, int jc, int cr, int g3x, int g3y,
                            int smem3, int vec, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  uint32_t* words = reinterpret_cast<uint32_t*>(out);
  int32_t* hot = out + w4;
  int32_t* n_hot = hot + R;
  int32_t* stats = n_hot + 1;  // [compiled pairs, interpreter pairs]
  uint32_t* rowwords = reinterpret_cast<uint32_t*>(stats + 2);
  if (cs < 1 || cs > NEED_MAX_CS) return (int)cudaErrorInvalidValue;
  dim3 g1(g1x, g1y);
  if (vec)
    need_rows_kernel<true><<<g1, NEED_THREADS, 0, s>>>(
        match_u, spec_map, viol, compiled, row_fb, C, N, n_valid, cs,
        rowwords, stats);
  else
    need_rows_kernel<false><<<g1, NEED_THREADS, 0, s>>>(
        match_u, spec_map, viol, compiled, row_fb, C, N, n_valid, cs,
        rowwords, stats);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  compact_kernel<<<1, COMPACT_THREADS, 0, s>>>(rowwords, (N + 31) / 32, R,
                                                hot, n_hot);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  pack_kernel<<<dim3(g3x, g3y), NEED_THREADS, smem3, s>>>(
      match_u, spec_map, viol, compiled, row_fb, C, N, n_valid, hot, R, jc,
      cr, words);
  return (int)cudaGetLastError();
}
