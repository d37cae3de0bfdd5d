// K1: the constraint x review match matrix.
//
// Replaces gatekeeper_tpu/engine/matchkernel.py:106 `match_matrix` (with
// `_isin` :37, `_selector_match` :44 and `_labelselector_4case` :91):
// matching_constraints for every (distinct match spec u, review n) pair,
// out[u, n] = kind_ok & ns_ok & excl_ok & scope_ok & nssel_ok & label_ok.
//
// Bound: bytes, each review feature that some spec reads read once and the
// [U, N] output written once; the spec side is tiny. The XLA version builds
// [C, N, P, ML] and [C, N, E, ML] intermediates in device memory; here
// nothing but the inputs and the output touches device memory, and:
//  - one block per review tile runs every spec: the review features are
//    read once into registers (before the spec staging, so the two
//    overlap) and all U spec rows are staged in shared memory once per
//    block in one flat copy (ops.match_plan opts in past 48 KB);
//  - `flags` (one int per spec, built on the host once per staged spec
//    set, ops._match_spec) fold the spec's bool arrays and say whether
//    each selector is live: a selector with no matchLabels pair and no
//    label-reading expression, or an invalid one, has one answer for every
//    review (F_*_CONST), so its label walk is skipped. The bucketed specs
//    always carry such padded rows, and the walk over ML label slots of
//    both objects was most of the old kernel's bytes;
//  - `reads` says which review arrays some spec reads; the rest stay
//    unread;
//  - without a live selector a thread takes 4 consecutive reviews (int4
//    and 4-byte feature loads where aligned, 4-byte output stores); with
//    one, a thread takes one review and the tile's label rows are staged
//    in shared memory with coalesced loads (row stride 2*ML + 1 words, so
//    the per-thread walks hit distinct banks);
//  - with many specs, sg groups of a block's threads split them, so that
//    a block stages fewer label rows and the card holds more threads.

#include <cstdint>
#include <cuda_runtime.h>

// the spec half: built once per staged spec set (ops._match_spec)
struct MatchSpec {
  const int32_t* kind_rows; const int32_t* ns_ids; const int32_t* excl_ids;
  const int32_t* lab_ml; const int32_t* lab_expr; const int32_t* lab_vals;
  const int32_t* nssel_ml; const int32_t* nssel_expr;
  const int32_t* nssel_vals; const int32_t* flags;
  int U; int K; int M; int M2; int P; int E; int V; int P2; int E2; int V2;
  int reads;
};

// the review half and the plan (ops.match_plan), per call
struct MatchReview {
  const int32_t* group_id; const int32_t* kind_id;
  const int32_t* ns_name_id; const uint8_t* kind_defined;
  const uint8_t* is_ns; const uint8_t* has_namespace;
  const uint8_t* obj_present; const uint8_t* old_present;
  const int32_t* obj_labels; const int32_t* old_labels;
  const uint8_t* nssel_defined; const int32_t* nssel_labels;
  const uint8_t* nssel_empty; uint8_t* out;
  int ML; int ML2; int N;
  int rpt; int sg; int threads; int grid; int smem; int vec;
};

// matchspec.py codes
#define WILDCARD (-2)
#define OP_IN 1
#define OP_NOT_IN 2
#define OP_EXISTS 3
#define OP_NOT_EXISTS 4
#define OP_ALWAYS_VIOLATED 5

// per-spec flags (ops._match_spec)
#define F_NS_HAS 1
#define F_EXCL_HAS 2
#define F_SCOPE_NS 4      // scope accepts a review with a namespace
#define F_SCOPE_CL 8      // scope accepts one without
#define F_NSSEL_HAS 16
#define F_NSSEL_EMPTY 32  // nssel_matches_empty
#define F_NSSEL_LIVE 64
#define F_NSSEL_CONST 128 // a dead namespaceSelector's answer
#define F_LAB_LIVE 256
#define F_LAB_CONST 512   // a dead labelSelector's answer

// review arrays some spec reads
#define R_NS 1      // ns_name_id, kind_defined, is_ns, has_namespace
#define R_NSSEL 2   // nssel_defined, nssel_empty
#define R_OBJ 4     // obj/old labels and presence (staged)
#define R_NSLAB 8   // nssel_labels (staged)

// review flag bits held in registers
#define V_KIND_DEFINED 1
#define V_IS_NS 2
#define V_HAS_NS 4
#define V_OBJ_P 8
#define V_OLD_P 16
#define V_NSSEL_DEFINED 32
#define V_NSSEL_EMPTY 64

__device__ __forceinline__ bool isin(int needle, const int32_t* hay, int m) {
  for (int i = 0; i < m; ++i)
    if (hay[i] != -1 && hay[i] == needle) return true;
  return false;
}

// a live LabelSelector vs one review's label pairs (lab: [nl, 2], -1
// padded; shared memory). Out of line: inlined at its five call sites it
// made the 4-review kernel some 30,000 SASS instructions, past what the
// instruction caches hold, and the kernel two to three times slower; a
// label-major walk (each slot read once, four entries tested from
// registers) was slower still.
__device__ __noinline__ bool selector_match(const int32_t* ml, int P,
                                            const int32_t* ex, int E,
                                            const int32_t* vals, int V,
                                            const int32_t* lab, int nl) {
  for (int p = 0; p < P; ++p) {
    const int k = ml[2 * p], v = ml[2 * p + 1];
    if (k == -1) continue;
    bool ok = false;
    for (int j = 0; j < nl; ++j)
      if (lab[2 * j] == k && lab[2 * j + 1] == v) { ok = true; break; }
    if (!ok) return false;
  }
  for (int e = 0; e < E; ++e) {
    const int key = ex[3 * e], op = ex[3 * e + 1], nv = ex[3 * e + 2];
    if (op == OP_ALWAYS_VIOLATED) return false;
    if (op < OP_IN || op > OP_NOT_EXISTS) continue;  // never violated
    bool has = false;
    int hits = 0;
    int lv = INT32_MIN;
    for (int j = 0; j < nl; ++j) {
      if (lab[2 * j] == key) {
        has = true;
        ++hits;
        lv = max(lv, lab[2 * j + 1]);
      }
    }
    // max over where(key_hit, lab_v, -1): a label slot that misses adds -1
    if (hits < nl) lv = max(lv, -1);
    bool violated;
    if (op == OP_IN) violated = !has || (nv > 0 && !isin(lv, vals + e * V, V));
    else if (op == OP_NOT_IN) violated = has && nv > 0 && isin(lv, vals + e * V, V);
    else if (op == OP_EXISTS) violated = !has;
    else violated = has;
    if (violated) return false;
  }
  return true;
}

// any_labelselector_match: OR over object/oldObject by which is present
__device__ __forceinline__ bool selector_4case(
    const int32_t* ml, int P, const int32_t* ex, int E, const int32_t* vals,
    int V, const int32_t* obj, const int32_t* old, int nl, int vf) {
  const bool obj_p = vf & V_OBJ_P, old_p = vf & V_OLD_P;
  if (obj_p && old_p)
    return selector_match(ml, P, ex, E, vals, V, obj, nl) ||
           selector_match(ml, P, ex, E, vals, V, old, nl);
  if (old_p) return selector_match(ml, P, ex, E, vals, V, old, nl);
  return selector_match(ml, P, ex, E, vals, V, obj, nl);
}

// staged spec arrays, array-major ([U, ...] each, as in device memory)
struct Spec {
  const int32_t *kind, *ns, *excl, *lml, *lex, *lv, *nml, *nex, *nv, *flags;
};

// the spec arrays in staging order (flags last)
__device__ __forceinline__ const int32_t* spec_src(const MatchSpec& a, int i) {
  switch (i) {
    case 0: return a.kind_rows;
    case 1: return a.ns_ids;
    case 2: return a.excl_ids;
    case 3: return a.lab_ml;
    case 4: return a.lab_expr;
    case 5: return a.lab_vals;
    case 6: return a.nssel_ml;
    case 7: return a.nssel_expr;
    case 8: return a.nssel_vals;
    default: return a.flags;
  }
}

// `rows` label rows of `w` words (contiguous in device memory) into
// shared memory at a row stride of w + 1 words, eight loads in flight
__device__ __forceinline__ void stage_rows(int32_t* dst, const int32_t* src,
                                           int rows, int w) {
  const int count = rows * w;
  for (int i = threadIdx.x; i < count; i += 8 * blockDim.x) {
    int v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int j = i + k * blockDim.x;
      v[k] = j < count ? src[j] : 0;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int j = i + k * blockDim.x;
      if (j < count) dst[j + j / w] = v[k];
    }
  }
}

__device__ __forceinline__ bool match_one(const MatchSpec& a, const Spec& s,
                                          int ml, int ml2, int u, int rg,
                                          int rk, int ns_name, int vf,
                                          const int32_t* obj,
                                          const int32_t* old,
                                          const int32_t* nslab) {
  const int f = s.flags[u];
  const int32_t* kr = s.kind + u * 2 * a.K;
  bool ok = false;
  for (int r = 0; r < a.K; ++r) {
    const int g = kr[2 * r], k = kr[2 * r + 1];
    const bool row_valid = (g != -1 && g > -3) || g == WILDCARD;
    const bool g_ok = g == WILDCARD || (rg >= 0 && g == rg);
    const bool k_ok = k == WILDCARD || (rk >= 0 && k == rk);
    if (row_valid && g_ok && k_ok) { ok = true; break; }
  }
  if (!ok) return false;
  const bool has_ns = vf & V_HAS_NS;
  const bool is_ns = vf & V_IS_NS;
  // the hoisted `not is_ns(input.review.kind)` clause
  const bool always = (vf & V_KIND_DEFINED) && !is_ns && !has_ns;
  const bool ns_defined = ns_name >= 0;
  if ((f & F_NS_HAS) &&
      !(always || (ns_defined && isin(ns_name, s.ns + u * a.M, a.M))))
    return false;
  if ((f & F_EXCL_HAS) &&
      !(always || (ns_defined && !isin(ns_name, s.excl + u * a.M2, a.M2))))
    return false;
  if (!(f & (has_ns ? F_SCOPE_NS : F_SCOPE_CL))) return false;
  if ((f & F_NSSEL_HAS) && !always) {
    bool ev;
    if (is_ns) {
      ev = (f & F_NSSEL_LIVE)
               ? selector_4case(s.nml + u * 2 * a.P2, a.P2, s.nex + u * 3 * a.E2,
                                a.E2, s.nv + u * a.E2 * a.V2, a.V2, obj, old,
                                ml, vf)
               : (f & F_NSSEL_CONST) != 0;
    } else {
      const bool plain =
          (f & F_NSSEL_LIVE)
              ? selector_match(s.nml + u * 2 * a.P2, a.P2, s.nex + u * 3 * a.E2,
                               a.E2, s.nv + u * a.E2 * a.V2, a.V2, nslab, ml2)
              : (f & F_NSSEL_CONST) != 0;
      // the second namespace candidate with empty labels
      const bool with_empty =
          plain || ((vf & V_NSSEL_EMPTY) && (f & F_NSSEL_EMPTY));
      ev = (vf & V_NSSEL_DEFINED) && with_empty;
    }
    if (!ev) return false;
  }
  if (f & F_LAB_LIVE)
    return selector_4case(s.lml + u * 2 * a.P, a.P, s.lex + u * 3 * a.E, a.E,
                          s.lv + u * a.E * a.V, a.V, obj, old, ml, vf);
  return (f & F_LAB_CONST) != 0;
}

template <typename T>
__device__ __forceinline__ void load_rpt(const T* src, int n0, int N, bool vec,
                                         int (&dst)[4], int rpt) {
  if (rpt == 4 && vec && n0 + 4 <= N) {
    if (sizeof(T) == 4) {
      const int4 v = *reinterpret_cast<const int4*>(src + n0);
      dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
    } else {
      const uint32_t v = *reinterpret_cast<const uint32_t*>(src + n0);
#pragma unroll
      for (int r = 0; r < 4; ++r) dst[r] = (v >> (8 * r)) & 0xFF;
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
    dst[r] = (r < rpt && n0 + r < N) ? (int)src[n0 + r] : 0;
}

// RPT reviews per thread: 4 without staged labels, 1 with them. A block
// of `threads` = tr x sg threads takes tr * RPT reviews; thread (r, g)
// runs specs g, g + sg, ... against reviews of slot r.
template <int RPT>
__global__ void __launch_bounds__(128) match_kernel(MatchSpec q,
                                                    MatchReview a) {
  extern __shared__ int32_t sh[];
  const int tr = blockDim.x / a.sg;
  const int slot = threadIdx.x % tr, grp = threadIdx.x / tr;
  const int n0 = (blockIdx.x * tr + slot) * RPT;
  // 1. this thread's review features into registers
  int rg[4], rk[4], nsn[4], vf[4] = {0, 0, 0, 0};
  load_rpt(a.group_id, n0, a.N, a.vec, rg, RPT);
  load_rpt(a.kind_id, n0, a.N, a.vec, rk, RPT);
  if (q.reads & R_NS) {
    int kd[4], isn[4], hn[4];
    load_rpt(a.ns_name_id, n0, a.N, a.vec, nsn, RPT);
    load_rpt(a.kind_defined, n0, a.N, a.vec, kd, RPT);
    load_rpt(a.is_ns, n0, a.N, a.vec, isn, RPT);
    load_rpt(a.has_namespace, n0, a.N, a.vec, hn, RPT);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      vf[r] |= (kd[r] ? V_KIND_DEFINED : 0) | (isn[r] ? V_IS_NS : 0) |
               (hn[r] ? V_HAS_NS : 0);
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) nsn[r] = -1;
  }
  if (q.reads & R_OBJ) {
    int op[4], dp[4];
    load_rpt(a.obj_present, n0, a.N, a.vec, op, RPT);
    load_rpt(a.old_present, n0, a.N, a.vec, dp, RPT);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      vf[r] |= (op[r] ? V_OBJ_P : 0) | (dp[r] ? V_OLD_P : 0);
  }
  if (q.reads & R_NSSEL) {
    int nd[4], ne[4];
    load_rpt(a.nssel_defined, n0, a.N, a.vec, nd, RPT);
    load_rpt(a.nssel_empty, n0, a.N, a.vec, ne, RPT);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      vf[r] |= (nd[r] ? V_NSSEL_DEFINED : 0) | (ne[r] ? V_NSSEL_EMPTY : 0);
  }
  // 2. every spec row: the ten arrays back to back, as one flat copy with
  // four loads in flight per thread (one round trip for small spec sets)
  const int U = q.U;
  int off[11];
  off[0] = 0;
  off[1] = U * 2 * q.K;
  off[2] = off[1] + U * q.M;
  off[3] = off[2] + U * q.M2;
  off[4] = off[3] + U * 2 * q.P;
  off[5] = off[4] + U * 3 * q.E;
  off[6] = off[5] + U * q.E * q.V;
  off[7] = off[6] + U * 2 * q.P2;
  off[8] = off[7] + U * 3 * q.E2;
  off[9] = off[8] + U * q.E2 * q.V2;
  off[10] = off[9] + U;
  const int total = off[10];
  for (int i = threadIdx.x; i < total; i += 4 * blockDim.x) {
    int v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = i + k * blockDim.x;
      v[k] = 0;
      if (j < total) {
        // the segment of j, by constant indices only (off stays in
        // registers)
        int seg = 0, base = 0;
#pragma unroll
        for (int t = 1; t < 10; ++t)
          if (j >= off[t]) { seg = t; base = off[t]; }
        v[k] = spec_src(q, seg)[j - base];
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = i + k * blockDim.x;
      if (j < total) sh[j] = v[k];
    }
  }
  const Spec s = {sh + off[0], sh + off[1], sh + off[2], sh + off[3],
                  sh + off[4], sh + off[5], sh + off[6], sh + off[7],
                  sh + off[8], sh + off[9]};
  int32_t* p = sh + total;
  // 3. the tile's label rows, where a live selector reads them
  const int tile0 = blockIdx.x * tr * RPT;
  const int rows = max(0, min(a.N - tile0, tr * RPT));
  const int32_t *obj = nullptr, *old = nullptr, *nslab = nullptr;
  if (q.reads & R_OBJ) {
    const int w = 2 * a.ML;
    int32_t* s_obj = p;
    int32_t* s_old = s_obj + tr * RPT * (w + 1);
    p = s_old + tr * RPT * (w + 1);
    stage_rows(s_obj, a.obj_labels + (size_t)tile0 * w, rows, w);
    stage_rows(s_old, a.old_labels + (size_t)tile0 * w, rows, w);
    obj = s_obj + (slot * RPT) * (w + 1);
    old = s_old + (slot * RPT) * (w + 1);
  }
  if (q.reads & R_NSLAB) {
    const int w = 2 * a.ML2;
    stage_rows(p, a.nssel_labels + (size_t)tile0 * w, rows, w);
    nslab = p + (slot * RPT) * (w + 1);
  }
  __syncthreads();
  // 4. this thread's specs against its reviews
  // not unrolled: one copy of match_one's inlined code per review
#pragma unroll 1
  for (int u = grp; u < U; u += a.sg) {
    uint8_t* row = a.out + (size_t)u * a.N;
    if (RPT == 4) {
      uint32_t word = 0;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (n0 + r < a.N && match_one(q, s, a.ML, a.ML2, u, rg[r], rk[r],
                                      nsn[r], vf[r], obj, old, nslab))
          word |= 1u << (8 * r);
      if (n0 + 4 <= a.N && (((size_t)u * a.N + n0) & 3) == 0) {
        *reinterpret_cast<uint32_t*>(row + n0) = word;
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (n0 + r < a.N) row[n0 + r] = (word >> (8 * r)) & 1;
      }
    } else if (n0 < a.N) {
      row[n0] = match_one(q, s, a.ML, a.ML2, u, rg[0], rk[0], nsn[0], vf[0],
                          obj, old, nslab);
    }
  }
}

extern "C" int gk_match_matrix(const MatchSpec* spec,
                               const MatchReview* review, void* stream) {
  const MatchReview& a = *review;
  if (a.threads < 32 || a.threads > 128 || (a.rpt != 1 && a.rpt != 4) ||
      a.sg < 1 || a.threads % a.sg)
    return (int)cudaErrorInvalidValue;
  void (*kernel)(MatchSpec, MatchReview) =
      a.rpt == 4 ? match_kernel<4> : match_kernel<1>;
  if (a.smem > 48 * 1024) {  // opt in past the default
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<a.grid, a.threads, a.smem, (cudaStream_t)stream>>>(*spec, a);
  return (int)cudaGetLastError();
}
