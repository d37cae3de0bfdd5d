// K5: the vocab-delta upload into the resident padded tables.
//
// Replaces gatekeeper_tpu/parallel/sharding.py:389-424
// `FusedAuditKernel._flush_deltas`: when the vocabulary grows inside its
// padded bucket, each device table receives only its new rows [fill, vlen)
// (zero-padded to a multiple of 512 rows), all tables in one call. The host
// packs every table's delta into one staging buffer behind a segment table
// and ships it with one host->device copy; this kernel then writes each
// segment to its table at `fill` rows in. Casts happen on the host.
//
// Segment i (three int64 at the start of the staging buffer): the absolute
// destination address, the source offset into the staging buffer, and the
// byte count. The host cuts a delta into segments of at most 64 KiB and
// places each so that source and destination agree modulo 16.
//
// Bound: bytes. Each delta byte is read once and written once. One block
// per segment walks it with a block-stride loop: byte moves up to the
// first 16-byte boundary, 16-byte vector moves in the middle (neighbouring
// threads on neighbouring addresses), byte moves for the tail. A segment
// whose ends disagree modulo 16 moves bytes only.

#include <cstdint>
#include <cuda_runtime.h>

struct Segment {
  long long dst;
  long long src;
  long long n;
};

__global__ void delta_kernel(const Segment* __restrict__ segs,
                             const uint8_t* __restrict__ base) {
  const Segment s = segs[blockIdx.x];
  uint8_t* d = reinterpret_cast<uint8_t*>(s.dst);
  const uint8_t* src = base + s.src;
  const long long n = s.n;
  const long long step = blockDim.x;
  if (((s.dst - (long long)(uintptr_t)src) & 15) != 0) {
    for (long long i = threadIdx.x; i < n; i += step) d[i] = src[i];
    return;
  }
  long long head = (16 - (s.dst & 15)) & 15;
  if (head > n) head = n;
  for (long long i = threadIdx.x; i < head; i += step) d[i] = src[i];
  const long long nv = (n - head) >> 4;
  uint4* dv = reinterpret_cast<uint4*>(d + head);
  const uint4* sv = reinterpret_cast<const uint4*>(src + head);
  for (long long i = threadIdx.x; i < nv; i += step) dv[i] = sv[i];
  for (long long i = head + (nv << 4) + threadIdx.x; i < n; i += step)
    d[i] = src[i];
}

extern "C" int gk_flush_deltas(const void* staging, int n_segs, void* stream) {
  if (n_segs <= 0) return 0;
  delta_kernel<<<n_segs, 256, 0, (cudaStream_t)stream>>>(
      (const Segment*)staging, (const uint8_t*)staging);
  return (int)cudaGetLastError();
}
