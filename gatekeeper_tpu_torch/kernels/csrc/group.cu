// K3: EGroup, the regroup of per-token values onto an array axis.
//
// Replaces gatekeeper_tpu/engine/exprs.py:510-556 `EGroup._emit` (and
// `EGroupPresent` :600, which is an EGroup with how="any"): for each review
// row n, tokens l with mask[n, l] and a slot index 0 <= idx < G put val[n, l]
// into out[n, idx]; collisions resolve by any / sum / max, and max fills
// slots with `init` exactly as JAX's where(onehot, val, init).max(axis=1)
// does (init joins the max whenever fewer than L tokens hit the slot).
// idx is idx0 (g0), idx1 (g1) or idx0 * g1 + idx1 (g01).
//
// Bound: bytes. Each token of the row is read once and each slot written
// once. The JAX version contracts an [N, L, G] one-hot only because
// scatters serialize on a TPU; here one warp owns one row, keeps its G
// slots in shared memory, and its lanes scatter into them with shared
// atomics, so the one-hot never exists.

#include <cstdint>
#include <cuda_runtime.h>

enum { HOW_ANY = 0, HOW_SUM = 1, HOW_MAX = 2 };
enum { VAL_U8 = 0, VAL_I32 = 1, VAL_F32 = 2 };

// order-preserving float <-> int map for atomicMax on floats
__device__ __forceinline__ int f2ord(float f) {
  int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float ord2f(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

__global__ void egroup_kernel(const int32_t* __restrict__ idx0,
                              const int32_t* __restrict__ idx1,
                              const uint8_t* __restrict__ mask,
                              const void* __restrict__ val, int val_kind,
                              int N, int L, int G, int g1, int mode, int how,
                              int acc_f32, int init_i, float init_f,
                              void* __restrict__ out) {
  extern __shared__ int32_t sh[];
  const int warps = blockDim.x / 32;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  int32_t* slots = sh + (size_t)w * 2 * G;
  int32_t* cnt = slots + G;
  const int n = blockIdx.x * warps + w;
  if (n >= N) return;  // the whole warp leaves together

  int32_t empty = 0;
  if (how == HOW_MAX) empty = acc_f32 ? f2ord(__int_as_float(0xff800000)) : INT32_MIN;
  for (int s = lane; s < G; s += 32) {
    slots[s] = empty;
    cnt[s] = 0;
  }
  __syncwarp();

  const size_t row = (size_t)n * L;
  for (int l = lane; l < L; l += 32) {
    const size_t o = row + l;
    if (!mask[o]) continue;
    int idx;
    if (mode == 0) {
      idx = idx0[o];
    } else if (mode == 1) {
      idx = idx1[o];
    } else {
      const int i0 = idx0[o], i1 = idx1[o];
      idx = (i0 >= 0 && i1 >= 0) ? i0 * g1 + i1 : -1;
    }
    if (idx < 0 || idx >= G) continue;
    int vi = 0;
    float vf = 0.f;
    if (val_kind == VAL_U8) {
      vi = ((const uint8_t*)val)[o];
      vf = (float)vi;
    } else if (val_kind == VAL_I32) {
      vi = ((const int32_t*)val)[o];
      vf = (float)vi;
    } else {
      vf = ((const float*)val)[o];
      vi = vf != 0.f;
    }
    if (how == HOW_ANY) {
      if (val_kind == VAL_F32 ? vf != 0.f : vi != 0) slots[idx] = 1;
    } else if (how == HOW_SUM) {
      if (acc_f32) atomicAdd((float*)&slots[idx], vf);
      else atomicAdd(&slots[idx], vi);
    } else {
      atomicMax(&slots[idx], acc_f32 ? f2ord(vf) : vi);
      atomicAdd(&cnt[idx], 1);
    }
  }
  __syncwarp();

  const size_t orow = (size_t)n * G;
  for (int s = lane; s < G; s += 32) {
    if (how == HOW_ANY) {
      ((uint8_t*)out)[orow + s] = slots[s] != 0;
    } else if (how == HOW_SUM) {
      ((int32_t*)out)[orow + s] = slots[s];  // int32 or float32 bits
    } else if (acc_f32) {
      float m = cnt[s] ? ord2f(slots[s]) : init_f;
      if (cnt[s] < L) m = fmaxf(m, init_f);
      ((float*)out)[orow + s] = m;
    } else {
      int m = cnt[s] ? slots[s] : init_i;
      if (cnt[s] < L) m = max(m, init_i);
      ((int32_t*)out)[orow + s] = m;
    }
  }
}

extern "C" int gk_egroup(const int32_t* idx0, const int32_t* idx1,
                         const uint8_t* mask, const void* val, int val_kind,
                         int N, int L, int G, int g1, int mode, int how,
                         int acc_f32, int init_i, float init_f, void* out,
                         void* stream) {
  // two int32 planes of G slots per warp; at most 32 KB per block
  int warps = 8;
  while (warps > 1 && (size_t)warps * 2 * G * sizeof(int32_t) > 32 * 1024)
    warps /= 2;
  size_t shm = (size_t)warps * 2 * G * sizeof(int32_t);
  if (shm > 48 * 1024) return (int)cudaErrorInvalidValue;
  int grid = (N + warps - 1) / warps;
  egroup_kernel<<<grid, warps * 32, shm, (cudaStream_t)stream>>>(
      idx0, idx1, mask, val, val_kind, N, L, G, g1, mode, how, acc_f32,
      init_i, init_f, out);
  return (int)cudaGetLastError();
}
