// K3: EGroup, the regroup of per-token values onto an array axis, as a
// latency-hiding segment reduce.
//
// Replaces gatekeeper_tpu/engine/exprs.py:510-556 `EGroup._emit` (and
// `EGroupPresent` :600, which is an EGroup with how="any"): for each review
// row n, tokens l with mask[n, l] and a slot index 0 <= idx < G put val[n, l]
// into out[n, idx]; collisions resolve by any / sum / max, and max fills
// slots with `init` exactly as JAX's where(onehot, val, init).max(axis=1)
// does (init joins the max whenever fewer than L tokens hit the slot).
// idx is idx0 (g0), idx1 (g1) or idx0 * g1 + idx1 (g01). The JAX version
// contracts an [N, L, G] one-hot only because scatters serialize on a TPU;
// here no one-hot exists.
//
// Bound: bytes. The mask is read whole, ids and values only where a token
// is live, each slot written once. On the main path the mask is sparse
// (0.3% live at [32768, 128] -> [32768, 64]), so the bound is ~2 us and a
// launch's fixed cost is a large part of it.
//
// What held the first design back (PERF.md): one warp per row in 4,096
// short blocks, each lane walking its tokens one at a time: a 1-byte mask
// load, then the id and value loads waiting behind it, ceil(L / 32) chains
// of dependent loads per row, and for how="any" a shared-memory round trip
// with two __syncwarp to produce 64 bytes. Latency-bound: 11.2 us against
// a 1.9 us bound at [32768, 128] -> 64 slots on the H100.
//
// This design: a group of `lanes` lanes (a power of two) owns a row, so a
// warp takes 32 / lanes rows at once (8 at L = 128), and each lane takes
// two 16-token chunks a step: both 16-byte mask loads go out first, then,
// for each 4-token quarter with a live token, the int4 loads of idx0/idx1
// and the value (4 bytes for bool values), issued together before any is
// used. How the live tokens land is a template parameter, so an
// instantiation carries only its own registers: how="any" with G <= 64
// keeps the row's slots as bits of a 64-bit word per lane, ORs them across
// the group with shuffles and stores the G bytes as 16-byte vectors (bytes
// when G is not a multiple of 16); above 64 slots, and for sum and max, the
// group keeps its row's slots in shared memory and scatters into them with
// shared atomics (max over an order-preserving int map of floats, and a hit
// count per slot for init). At most 40 registers (6 blocks of 256 threads
// an SM), so the main path's 4,096 warps of rows run in one wave of a grid
// sized to the card. Rows that are not 16-byte aligned (L % 16 != 0, or a
// view that starts off alignment) take the same kernel with scalar loads;
// the wrapper chooses (ops.egroup_plan).

#include <cstdint>
#include <cuda_runtime.h>

enum { HOW_ANY = 0, HOW_SUM = 1, HOW_MAX = 2 };
enum { VAL_U8 = 0, VAL_I32 = 1, VAL_F32 = 2 };

struct GroupArgs {
  const int32_t* idx0;
  const int32_t* idx1;
  const uint8_t* mask;
  const void* val;
  int val_kind, N, L, G, g1, mode, acc_f32, init_i;
  float init_f;
  void* out;
  int lanes;  // lanes per row: a power of two, 1..32
};

// order-preserving float <-> int map for atomicMax on floats
__device__ __forceinline__ int f2ord(float f) {
  int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float ord2f(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// what a kernel instantiation does with a live token: how="any" with
// G <= 64 (slot bits in a register), any above 64 slots, sum and max (slots
// in shared memory)
enum { K_BITS = 0, K_ANY = 1, K_SUM = 2, K_MAX = 3 };

// one live token: its slot index from idx0/idx1, its value bits (a byte,
// int32 or float32 bits) into the row's slots
template <int KIND>
__device__ __forceinline__ void take(const GroupArgs& p, int i0, int i1,
                                     uint32_t vb, uint64_t& bits,
                                     int32_t* slots, int32_t* cnt) {
  int idx;
  if (p.mode == 0) {
    idx = i0;
  } else if (p.mode == 1) {
    idx = i1;
  } else {
    idx = (i0 >= 0 && i1 >= 0) ? i0 * p.g1 + i1 : -1;
  }
  if (idx < 0 || idx >= p.G) return;
  const bool f32 = p.val_kind == VAL_F32;
  const float vf = f32 ? __int_as_float((int)vb) : (float)(int)vb;
  if (KIND == K_BITS || KIND == K_ANY) {
    if (f32 ? vf != 0.f : vb != 0) {
      if (KIND == K_BITS)
        bits |= 1ull << idx;
      else
        slots[idx] = 1;
    }
    return;
  }
  const int vi = f32 ? (vf != 0.f) : (int)vb;
  if (KIND == K_SUM) {
    if (p.acc_f32)
      atomicAdd((float*)&slots[idx], vf);
    else
      atomicAdd(&slots[idx], vi);
  } else {
    atomicMax(&slots[idx], p.acc_f32 ? f2ord(vf) : vi);
    atomicAdd(&cnt[idx], 1);
  }
}

// four tokens from `off` (16-byte aligned for the ids, 4 for bool values)
// whose mask bytes are mq: every load at once, then the live ones
template <int KIND>
__device__ __forceinline__ void quarter_vec(const GroupArgs& p, size_t off,
                                            uint32_t mq, uint64_t& bits,
                                            int32_t* slots, int32_t* cnt) {
  int4 a = make_int4(0, 0, 0, 0), b = a;
  uint4 v = make_uint4(0, 0, 0, 0);
  if (p.mode != 1) a = __ldg((const int4*)(p.idx0 + off));
  if (p.mode != 0) b = __ldg((const int4*)(p.idx1 + off));
  if (p.val_kind == VAL_U8) {
    const uint32_t w = __ldg((const uint32_t*)((const uint8_t*)p.val + off));
    v = make_uint4(w & 0xff, (w >> 8) & 0xff, (w >> 16) & 0xff, w >> 24);
  } else {
    v = __ldg((const uint4*)((const uint32_t*)p.val + off));
  }
  if (mq & 0xff) take<KIND>(p, a.x, b.x, v.x, bits, slots, cnt);
  if (mq & 0xff00) take<KIND>(p, a.y, b.y, v.y, bits, slots, cnt);
  if (mq & 0xff0000) take<KIND>(p, a.z, b.z, v.z, bits, slots, cnt);
  if (mq & 0xff000000) take<KIND>(p, a.w, b.w, v.w, bits, slots, cnt);
}

// the same for any alignment: the first n (<= 4) tokens, one load each
template <int KIND>
__device__ __forceinline__ void quarter_scalar(const GroupArgs& p, size_t off,
                                               int n, uint32_t mq,
                                               uint64_t& bits, int32_t* slots,
                                               int32_t* cnt) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (t >= n || !((mq >> (8 * t)) & 0xff)) continue;
    const int i0 = p.mode != 1 ? __ldg(p.idx0 + off + t) : 0;
    const int i1 = p.mode != 0 ? __ldg(p.idx1 + off + t) : 0;
    const uint32_t vb = p.val_kind == VAL_U8
                            ? (uint32_t)__ldg((const uint8_t*)p.val + off + t)
                            : __ldg((const uint32_t*)p.val + off + t);
    take<KIND>(p, i0, i1, vb, bits, slots, cnt);
  }
}

// a 16-token chunk's mask bytes, four to a word
template <bool VEC>
__device__ __forceinline__ void load_mask(const GroupArgs& p, size_t off,
                                          int n, uint32_t* m) {
  if (VEC) {
    const uint4 w = __ldg((const uint4*)(p.mask + off));
    m[0] = w.x, m[1] = w.y, m[2] = w.z, m[3] = w.w;
    return;
  }
  m[0] = m[1] = m[2] = m[3] = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (j < n) m[j >> 2] |= (uint32_t)__ldg(p.mask + off + j) << (8 * (j & 3));
}

template <bool VEC, int KIND>
__global__ void __launch_bounds__(256, 6)
egroup_kernel(const GroupArgs p) {
  extern __shared__ int32_t sh[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rpw = 32 / p.lanes;  // rows per warp
  const int grp = lane / p.lanes, sub = lane & (p.lanes - 1);
  const int G = p.G;
  const int planes = KIND == K_MAX ? 2 : 1;
  int32_t* slots = sh + (size_t)(warp * rpw + grp) * planes * G;
  int32_t* cnt = slots + G;
  int32_t empty = 0;
  if (KIND == K_MAX)
    empty = p.acc_f32 ? f2ord(__int_as_float(0xff800000)) : INT32_MIN;
  const long long step = (long long)gridDim.x * (blockDim.x >> 5) * rpw;
  const int n_chunks = (p.L + 15) >> 4;

  // warp-uniform loop over groups of rpw rows
  for (long long base =
           ((long long)blockIdx.x * (blockDim.x >> 5) + warp) * rpw;
       base < p.N; base += step) {
    const long long n = base + grp;
    const bool row_live = n < p.N;
    if (KIND != K_BITS) {
      if (row_live)
        for (int s = sub; s < G; s += p.lanes) {
          slots[s] = empty;
          if (KIND == K_MAX) cnt[s] = 0;
        }
      __syncwarp();
    }
    uint64_t bits = 0;
    if (row_live) {
      const size_t row = (size_t)n * p.L;
      // two chunks a step: both masks load before either is read
      for (int ch = sub; ch < n_chunks; ch += 2 * p.lanes) {
        const int ch2 = ch + p.lanes;
        uint32_t m[8] = {};
        load_mask<VEC>(p, row + ch * 16, min(16, p.L - ch * 16), m);
        if (ch2 < n_chunks)
          load_mask<VEC>(p, row + ch2 * 16, min(16, p.L - ch2 * 16), m + 4);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (!m[q]) continue;
          const int c = q < 4 ? ch : ch2;
          const int tok = c * 16 + (q & 3) * 4;
          if (VEC)
            quarter_vec<KIND>(p, row + tok, m[q], bits, slots, cnt);
          else
            quarter_scalar<KIND>(p, row + tok, min(4, p.L - tok), m[q], bits,
                                 slots, cnt);
        }
      }
    }

    if (KIND == K_BITS) {
      // OR the row's slot bits over its group of lanes
      uint32_t lo = (uint32_t)bits, hi = (uint32_t)(bits >> 32);
      for (int o = p.lanes >> 1; o; o >>= 1) {
        lo |= __shfl_xor_sync(0xffffffffu, lo, o);
        hi |= __shfl_xor_sync(0xffffffffu, hi, o);
      }
      bits = ((uint64_t)hi << 32) | lo;
      if (row_live) {
        uint8_t* orow = (uint8_t*)p.out + (size_t)n * G;
        if ((G & 15) == 0) {
          // each 16-slot vector: four bits spread to four bytes per word
          for (int s = sub; s < (G >> 4); s += p.lanes) {
            const uint32_t b16 = (uint32_t)(bits >> (16 * s)) & 0xffffu;
            uint4 w;
            w.x = ((b16 & 0xf) * 0x00204081u) & 0x01010101u;
            w.y = (((b16 >> 4) & 0xf) * 0x00204081u) & 0x01010101u;
            w.z = (((b16 >> 8) & 0xf) * 0x00204081u) & 0x01010101u;
            w.w = (((b16 >> 12) & 0xf) * 0x00204081u) & 0x01010101u;
            ((uint4*)orow)[s] = w;
          }
        } else {
          for (int s = sub; s < G; s += p.lanes) orow[s] = (bits >> s) & 1;
        }
      }
    } else {
      __syncwarp();
      if (row_live) {
        const size_t orow = (size_t)n * G;
        for (int s = sub; s < G; s += p.lanes) {
          if (KIND == K_ANY) {
            ((uint8_t*)p.out)[orow + s] = slots[s] != 0;
          } else if (KIND == K_SUM) {
            ((int32_t*)p.out)[orow + s] = slots[s];  // int32 or float32 bits
          } else if (p.acc_f32) {
            float m = cnt[s] ? ord2f(slots[s]) : p.init_f;
            if (cnt[s] < p.L) m = fmaxf(m, p.init_f);
            ((float*)p.out)[orow + s] = m;
          } else {
            int m = cnt[s] ? slots[s] : p.init_i;
            if (cnt[s] < p.L) m = max(m, p.init_i);
            ((int32_t*)p.out)[orow + s] = m;
          }
        }
      }
      __syncwarp();  // the next rows re-initialise these slots
    }
  }
}

template <bool VEC, int KIND>
static int launch(const GroupArgs& a, int warps, int grid, int smem,
                  cudaStream_t s) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        egroup_kernel<VEC, KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  egroup_kernel<VEC, KIND><<<grid, warps * 32, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <bool VEC>
static int launch_kind(const GroupArgs& a, int kind, int warps, int grid,
                       int smem, cudaStream_t s) {
  switch (kind) {
    case K_BITS: return launch<VEC, K_BITS>(a, warps, grid, smem, s);
    case K_ANY: return launch<VEC, K_ANY>(a, warps, grid, smem, s);
    case K_SUM: return launch<VEC, K_SUM>(a, warps, grid, smem, s);
    default: return launch<VEC, K_MAX>(a, warps, grid, smem, s);
  }
}

// vec, lanes, warps, grid and smem come from the wrapper's plan
// (ops.egroup_plan); the checks here refuse a plan the kernel cannot run.
extern "C" int gk_egroup(const int32_t* idx0, const int32_t* idx1,
                         const uint8_t* mask, const void* val, int val_kind,
                         int N, int L, int G, int g1, int mode, int how,
                         int acc_f32, int init_i, float init_f, void* out,
                         int vec, int lanes, int warps, int grid, int smem,
                         void* stream) {
  const GroupArgs a = {idx0, idx1, mask, val, val_kind, N, L, G, g1, mode,
                       acc_f32, init_i, init_f, out, lanes};
  const int kind = how == HOW_ANY ? (G <= 64 ? K_BITS : K_ANY)
                                  : (how == HOW_SUM ? K_SUM : K_MAX);
  const long long planes = kind == K_BITS ? 0 : (kind == K_MAX ? 2 : 1);
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) || warps < 1 ||
      warps > 8 || grid < 1 || G < 1 || L < 1 || how < 0 || how > 2 ||
      (long long)smem < (long long)warps * (32 / lanes) * planes * G * 4)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)out & 15) return (int)cudaErrorMisalignedAddress;
  if (vec) {
    uintptr_t any = (uintptr_t)mask | (uintptr_t)val | (uintptr_t)(L & 15);
    if (mode != 1) any |= (uintptr_t)idx0;
    if (mode != 0) any |= (uintptr_t)idx1;
    if (any & 15) return (int)cudaErrorMisalignedAddress;
  }
  cudaStream_t s = (cudaStream_t)stream;
  return vec ? launch_kind<true>(a, kind, warps, grid, smem, s)
             : launch_kind<false>(a, kind, warps, grid, smem, s);
}
