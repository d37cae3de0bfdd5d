// K5: the vocab-delta upload into the resident padded tables.
//
// Replaces gatekeeper_tpu/parallel/sharding.py:389-424
// `FusedAuditKernel._flush_deltas`: when the vocabulary grows inside its
// padded bucket, each device table receives only its new rows [fill, vlen)
// (zero-padded to a multiple of 512 rows), all tables in one call. The host
// packs every delta into one pinned staging buffer behind a segment table
// (ops.delta_plan, ops.pack_deltas) and ships it to the card with one
// host-to-device copy; the entry point below checks the table and launches
// this kernel, which writes each segment to its table. Casts happen on the
// host.
//
// Segment: the destination address, the staging offset and the byte count.
// The host cuts every delta at multiples of SEG_BYTES in the destination's
// address space and places it in the staging at an offset congruent to its
// destination modulo 16, so the aligned 16-byte vectors of a segment line
// up at both ends and a segment spans at most THREADS * VEC of them. The
// staging ends on a 16-byte boundary: the vectors holding a segment's first
// and last bytes lie inside the staging.
//
// Bound: bytes (each delta byte read once and written once), but the
// recorded flush (651,264 bytes) is below one launch floor of work, so what
// the design fights is latency:
//   * one block per segment, so the recorded flush spreads over every SM;
//   * each thread issues the loads of all its VEC vectors (one, in 4 KiB
//     blocks: the fastest of the block shapes tried on the recorded flush)
//     before its first store: one round trip to memory per block;
//   * the headers of the first PARAM_SEGS segments ride in the kernel
//     parameters, so a block's first data load depends on no load of its
//     own (segments past PARAM_SEGS read theirs from the staging's head);
//   * 32-bit arithmetic inside a segment.
// Vectors that hold a segment's first or last bytes (a destination off
// 16-byte alignment, a ragged end) are stored byte by byte, only the
// segment's own bytes; every other vector is one 16-byte store.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

constexpr int THREADS = 256;  // ops.DELTA_THREADS
constexpr int VEC = 1;  // 16-byte vectors per thread (ops.DELTA_VEC)
constexpr int SEG_BYTES = THREADS * VEC * 16;  // 4 KiB (ops.DELTA_SEG)
constexpr int PARAM_SEGS = 248;

struct Segment {
  unsigned long long dst;  // destination address
  unsigned int src;        // offset into the staging
  unsigned int n;          // bytes
};

struct Params {
  const uint8_t* base;  // the staging (its segment table first)
  int n_param;          // segments whose headers ride below
  Segment segs[PARAM_SEGS];
};
static_assert(sizeof(Segment) == 16, "ops.SEG_DTYPE");
static_assert(sizeof(Params) <= 4096, "kernel parameters");

__device__ __forceinline__ uint8_t byte_of(const uint4& v, unsigned i) {
  const unsigned w = i < 8 ? (i < 4 ? v.x : v.y) : (i < 12 ? v.z : v.w);
  return (uint8_t)(w >> ((i & 3) * 8));
}

__global__ void __launch_bounds__(THREADS)
    delta_kernel(const __grid_constant__ Params p) {
  const unsigned b = blockIdx.x;
  const Segment s = b < (unsigned)p.n_param
                        ? p.segs[b]
                        : reinterpret_cast<const Segment*>(p.base)[b];
  const unsigned lead = (unsigned)(s.dst & 15);
  const unsigned end = lead + s.n;  // bytes from the first aligned vector
  const unsigned nv = (end + 15) >> 4;
  const uint4* src = reinterpret_cast<const uint4*>(p.base + (s.src - lead));
  uint4* dst = reinterpret_cast<uint4*>(s.dst - lead);
  uint4 v[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const unsigned k = threadIdx.x + j * THREADS;
    if (k < nv) v[j] = src[k];
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const unsigned k = threadIdx.x + j * THREADS;
    if (k >= nv) continue;
    const unsigned lo = k << 4;
    const unsigned a = lo < lead ? lead - lo : 0;
    const unsigned e = end - lo < 16 ? end - lo : 16;
    if (a == 0 && e == 16) {
      dst[k] = v[j];
    } else {
      uint8_t* d = reinterpret_cast<uint8_t*>(dst + k);
      for (unsigned i = a; i < e; ++i) d[i] = byte_of(v[j], i);
    }
  }
}

// `table`: the staging's segment table as the host packed it (the first
// PARAM_SEGS entries go into the launch's parameters); `dev`: the staging
// on the card, `total` bytes, already copied there on `stream`. Every
// segment is checked first: a segment the kernel would move wrongly (more
// bytes than a block, source and destination not congruent modulo 16, a
// vector outside the staging) launches nothing and returns -1.
extern "C" int gk_flush_deltas(const void* table, const void* dev,
                               long long total, int n_segs, void* stream) {
  if (n_segs <= 0) return 0;
  const Segment* segs = static_cast<const Segment*>(table);
  const unsigned long long head = 16ull * (unsigned long long)n_segs;
  for (int i = 0; i < n_segs; ++i) {
    const Segment& s = segs[i];
    const unsigned long long lead = s.dst & 15;
    if (s.n == 0 || lead + s.n > (unsigned long long)SEG_BYTES ||
        (s.src & 15) != lead || s.src < head + lead ||
        (((unsigned long long)s.src + s.n + 15) & ~15ull) >
            (unsigned long long)total)
      return -1;
  }
  Params p{};
  p.base = static_cast<const uint8_t*>(dev);
  p.n_param = n_segs < PARAM_SEGS ? n_segs : PARAM_SEGS;
  std::memcpy(p.segs, segs, sizeof(Segment) * p.n_param);
  delta_kernel<<<n_segs, THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
