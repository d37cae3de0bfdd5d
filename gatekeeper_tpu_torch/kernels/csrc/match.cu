// K1: the constraint x review match matrix.
//
// Replaces gatekeeper_tpu/engine/matchkernel.py:106 `match_matrix` (with
// `_isin` :37, `_selector_match` :44 and `_labelselector_4case` :91):
// matching_constraints for every (distinct match spec u, review n) pair,
// out[u, n] = kind_ok & ns_ok & excl_ok & scope_ok & nssel_ok & label_ok.
//
// Bound: bytes. Each thread reads its review's feature row once (a few
// scalars and three [ML, 2] label rows) and writes one byte; the spec side
// is tiny and shared by every thread of a block. The XLA version builds
// [C, N, P, ML] and [C, N, E, ML] intermediates in device memory; here each
// thread walks kind rows, namespace ids, matchLabels, and matchExpressions
// x labels x values in registers, so nothing but the inputs and the output
// touches device memory.
//
// Layout: grid (ceil(N / 256), U); block 256 threads, one per review; the
// block's spec row u is staged in shared memory once.

#include <cstdint>
#include <cuda_runtime.h>

struct MatchArgs {
  const int32_t* kind_rows; int K;
  const uint8_t* ns_has; const int32_t* ns_ids; int M;
  const uint8_t* excl_has; const int32_t* excl_ids; int M2;
  const int32_t* scope;
  const uint8_t* lab_invalid; const int32_t* lab_ml; int P;
  const int32_t* lab_expr; int E; const int32_t* lab_vals; int V;
  const uint8_t* nssel_has; const uint8_t* nssel_matches_empty;
  const uint8_t* nssel_invalid; const int32_t* nssel_ml; int P2;
  const int32_t* nssel_expr; int E2; const int32_t* nssel_vals; int V2;
  const int32_t* group_id; const int32_t* kind_id;
  const uint8_t* kind_defined; const uint8_t* is_ns;
  const uint8_t* has_namespace; const int32_t* ns_name_id;
  const uint8_t* obj_present; const uint8_t* old_present;
  const int32_t* obj_labels; const int32_t* old_labels; int ML;
  const uint8_t* nssel_defined; const int32_t* nssel_labels; int ML2;
  const uint8_t* nssel_empty;
  uint8_t* out; int U; int N;
};

// matchspec.py codes
#define WILDCARD (-2)
#define OP_IN 1
#define OP_NOT_IN 2
#define OP_EXISTS 3
#define OP_NOT_EXISTS 4
#define OP_ALWAYS_VIOLATED 5
#define SCOPE_ABSENT 0
#define SCOPE_STAR 1
#define SCOPE_NAMESPACED 2
#define SCOPE_CLUSTER 3

__device__ __forceinline__ bool isin(int needle, const int32_t* hay, int m) {
  for (int i = 0; i < m; ++i)
    if (hay[i] != -1 && hay[i] == needle) return true;
  return false;
}

// LabelSelector vs one review's label pairs (lab: [ml, 2], -1 padded).
__device__ bool selector_match(bool invalid, const int32_t* ml, int P,
                               const int32_t* ex, int E, const int32_t* vals,
                               int V, const int32_t* lab, int nl) {
  if (invalid) return false;
  for (int p = 0; p < P; ++p) {
    int k = ml[2 * p], v = ml[2 * p + 1];
    if (k == -1) continue;
    bool ok = false;
    for (int j = 0; j < nl; ++j)
      if (lab[2 * j] == k && lab[2 * j + 1] == v) { ok = true; break; }
    if (!ok) return false;
  }
  for (int e = 0; e < E; ++e) {
    int key = ex[3 * e], op = ex[3 * e + 1], nv = ex[3 * e + 2];
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
    bool in_vals = isin(lv, vals + (size_t)e * V, V);
    bool violated = false;
    if (op == OP_IN) violated = !has || (nv > 0 && !in_vals);
    else if (op == OP_NOT_IN) violated = has && nv > 0 && in_vals;
    else if (op == OP_EXISTS) violated = !has;
    else if (op == OP_NOT_EXISTS) violated = has;
    else if (op == OP_ALWAYS_VIOLATED) violated = true;
    if (violated) return false;
  }
  return true;
}

// any_labelselector_match: OR over object/oldObject by which is present.
__device__ bool selector_4case(bool invalid, const int32_t* ml, int P,
                               const int32_t* ex, int E, const int32_t* vals,
                               int V, const MatchArgs& a, int n) {
  bool obj_p = a.obj_present[n], old_p = a.old_present[n];
  const int32_t* obj = a.obj_labels + (size_t)n * a.ML * 2;
  const int32_t* old = a.old_labels + (size_t)n * a.ML * 2;
  if (obj_p && old_p)
    return selector_match(invalid, ml, P, ex, E, vals, V, obj, a.ML) ||
           selector_match(invalid, ml, P, ex, E, vals, V, old, a.ML);
  if (old_p && !obj_p)
    return selector_match(invalid, ml, P, ex, E, vals, V, old, a.ML);
  return selector_match(invalid, ml, P, ex, E, vals, V, obj, a.ML);
}

__device__ void stage(int32_t* dst, const int32_t* src, int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
}

__global__ void match_kernel(MatchArgs a) {
  extern __shared__ int32_t sh[];
  const int u = blockIdx.y;
  int32_t* s_kind = sh;
  int32_t* s_ns = s_kind + 2 * a.K;
  int32_t* s_excl = s_ns + a.M;
  int32_t* s_lml = s_excl + a.M2;
  int32_t* s_lex = s_lml + 2 * a.P;
  int32_t* s_lv = s_lex + 3 * a.E;
  int32_t* s_nml = s_lv + a.E * a.V;
  int32_t* s_nex = s_nml + 2 * a.P2;
  int32_t* s_nv = s_nex + 3 * a.E2;
  stage(s_kind, a.kind_rows + (size_t)u * 2 * a.K, 2 * a.K);
  stage(s_ns, a.ns_ids + (size_t)u * a.M, a.M);
  stage(s_excl, a.excl_ids + (size_t)u * a.M2, a.M2);
  stage(s_lml, a.lab_ml + (size_t)u * 2 * a.P, 2 * a.P);
  stage(s_lex, a.lab_expr + (size_t)u * 3 * a.E, 3 * a.E);
  stage(s_lv, a.lab_vals + (size_t)u * a.E * a.V, a.E * a.V);
  stage(s_nml, a.nssel_ml + (size_t)u * 2 * a.P2, 2 * a.P2);
  stage(s_nex, a.nssel_expr + (size_t)u * 3 * a.E2, 3 * a.E2);
  stage(s_nv, a.nssel_vals + (size_t)u * a.E2 * a.V2, a.E2 * a.V2);
  __syncthreads();

  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= a.N) return;

  // kind selector: any valid row whose group and kind accept the review
  const int rg = a.group_id[n], rk = a.kind_id[n];
  bool kind_ok = false;
  for (int r = 0; r < a.K && !kind_ok; ++r) {
    int g = s_kind[2 * r], k = s_kind[2 * r + 1];
    bool row_valid = (g != -1 && g > -3) || g == WILDCARD;
    bool g_ok = g == WILDCARD || (rg >= 0 && g == rg);
    bool k_ok = k == WILDCARD || (rk >= 0 && k == rk);
    kind_ok = row_valid && g_ok && k_ok;
  }
  bool ok = kind_ok;

  const bool has_ns = a.has_namespace[n];
  const bool is_ns = a.is_ns[n];
  // the hoisted `not is_ns(input.review.kind)` clause
  const bool always = a.kind_defined[n] && !is_ns && !has_ns;
  const int ns_name = a.ns_name_id[n];
  const bool ns_defined = ns_name >= 0;

  if (ok && a.ns_has[u])
    ok = always || (ns_defined && isin(ns_name, s_ns, a.M));
  if (ok && a.excl_has[u])
    ok = always || (ns_defined && !isin(ns_name, s_excl, a.M2));
  if (ok) {
    int sc = a.scope[u];
    ok = sc == SCOPE_ABSENT || sc == SCOPE_STAR ||
         (sc == SCOPE_NAMESPACED && has_ns) ||
         (sc == SCOPE_CLUSTER && !has_ns);
  }
  if (ok && a.nssel_has[u] && !always) {
    bool inv = a.nssel_invalid[u];
    bool ev;
    if (is_ns) {
      ev = selector_4case(inv, s_nml, a.P2, s_nex, a.E2, s_nv, a.V2, a, n);
    } else {
      bool plain = selector_match(inv, s_nml, a.P2, s_nex, a.E2, s_nv, a.V2,
                                  a.nssel_labels + (size_t)n * a.ML2 * 2,
                                  a.ML2);
      // the second namespace candidate with empty labels
      bool with_empty =
          plain || (a.nssel_empty[n] && a.nssel_matches_empty[u]);
      ev = a.nssel_defined[n] && with_empty;
    }
    ok = ev;
  }
  if (ok)
    ok = selector_4case(a.lab_invalid[u], s_lml, a.P, s_lex, a.E, s_lv, a.V,
                        a, n);
  a.out[(size_t)u * a.N + n] = ok ? 1 : 0;
}

extern "C" int gk_match_matrix(const MatchArgs* args, void* stream) {
  const MatchArgs& a = *args;
  size_t shm = sizeof(int32_t) *
               (size_t)(2 * a.K + a.M + a.M2 + 2 * a.P + 3 * a.E + a.E * a.V +
                        2 * a.P2 + 3 * a.E2 + a.E2 * a.V2);
  if (shm > 48 * 1024) return (int)cudaErrorInvalidValue;
  dim3 block(256);
  dim3 grid((a.N + 255) / 256, a.U);
  match_kernel<<<grid, block, shm, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
