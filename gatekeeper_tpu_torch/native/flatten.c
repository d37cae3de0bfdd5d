/* Copied from gatekeeper_tpu/native/flatten.c; no line below differs.
 * It walks the port's Vocab and OverlayVocab (gatekeeper_tpu_torch/
 * flatten/vocab.py), whose _ids, _strs, _quantity, base and base_len
 * fields are the same as the JAX package's. Built with gcc by
 * gatekeeper_tpu_torch/native/__init__.py; parity with the port's Python
 * encoder is pinned by tests/test_torch_native_flatten.py. */

/* Native JSON->token flattener: the C counterpart of
 * gatekeeper_tpu/flatten/encoder.flatten_leaves + the vid/vnum logic of
 * encode_token_table.
 *
 * This is the host-side "JSON -> tensor flattening" native component
 * SURVEY §2 reserves for C++ (the reference has no native code at all —
 * its hot loop is Go; ours is the encode of 100k+ objects per corpus
 * change, which in pure Python costs tens of seconds).
 *
 * Design: walk the already-parsed Python object tree with the CPython
 * API and intern directly into the caller's Vocab dict/list — one
 * source of truth, no side hash table to keep consistent. Semantics are
 * replicated exactly from encoder.py/vocab.py:
 *   - esc_seg: '%' -> %25, '.' -> %2E, a lone "#" key -> %23
 *   - dict insertion order preserved (PyDict_Next); bool checked before
 *     int (Python bool is an int subtype)
 *   - array index lifting: first two levels -> idx0/idx1, deeper
 *     levels saturate
 *   - K_STR vnum = k8s quantity parse (resource.ParseQuantity subset,
 *     vocab._QUANTITY_RE); K_NUM vnum = float(v); K_BOOL 1/0
 *   - val_id normalization: integral floats intern as ints; numbers as
 *     "j:" + json.dumps(v); bool "j:true"/"j:false"; null "j:null"
 * Differential parity with the Python encoder is pinned by
 * tests/test_native_flatten.py.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>
#include <stdlib.h>
#include <math.h>

/* token value kinds (encoder.py) */
#define K_NULL 0
#define K_BOOL 1
#define K_NUM 2
#define K_STR 3
#define K_EMPTY_OBJ 4
#define K_EMPTY_ARR 5

typedef struct {
    int32_t *spath, *idx0, *idx1, *kind, *vid;
    float *vnum;
    Py_ssize_t len, cap;
    int32_t *row_off; /* [n_rows+1] offsets into the flat arrays */
    Py_ssize_t rows_len, rows_cap;
    int depth;        /* recursion guard (C stack overflow would
                         segfault where Python raises RecursionError) */
    char *path;       /* growing "a.b.#.c" buffer */
    Py_ssize_t path_len, path_cap;
    PyObject *ids;    /* intern-target _ids dict (borrowed) */
    PyObject *strs;   /* intern-target _strs list (borrowed) */
    PyObject *quant;  /* intern-target _quantity list (borrowed) */
    PyObject *base_ids; /* overlay mode: read-only base vocab dict
                           consulted before the local dict (chain
                           lookup, no O(|vocab|) copy per batch —
                           ADVICE r4); NULL for a plain Vocab */
    Py_ssize_t base_len; /* overlay id offset: local ids start here */
    PyObject *py_qty; /* vocab.parse_quantity callable (borrowed) —
                         fallback for inputs the C parser cannot
                         replicate bit-exactly (non-ASCII whitespace,
                         very long mantissas) */
} Enc;

static int enc_grow(Enc *e) {
    Py_ssize_t cap = e->cap ? e->cap * 2 : 4096;
    void *p;
#define GROW(f, t) p = realloc(e->f, cap * sizeof(t)); if (!p) return -1; e->f = (t *)p;
    GROW(spath, int32_t) GROW(idx0, int32_t) GROW(idx1, int32_t)
    GROW(kind, int32_t) GROW(vid, int32_t) GROW(vnum, float)
#undef GROW
    e->cap = cap;
    return 0;
}

static int path_reserve(Enc *e, Py_ssize_t extra) {
    if (e->path_len + extra + 1 <= e->path_cap) return 0;
    Py_ssize_t cap = e->path_cap ? e->path_cap : 256;
    while (cap < e->path_len + extra + 1) cap *= 2;
    char *p = realloc(e->path, cap);
    if (!p) return -1;
    e->path = p;
    e->path_cap = cap;
    return 0;
}

/* k8s quantity parse mirroring vocab._QUANTITY_RE + _SUFFIX; -> 1 when
 * s parses (sets *out), 0 when it doesn't, -1 when the C parser cannot
 * decide bit-exactly (caller falls back to the Python parser):
 * non-ASCII bytes (str.strip() is Unicode-aware) or mantissas past the
 * fixed buffer. */
static int parse_quantity(const char *s, Py_ssize_t n, double *out) {
    for (Py_ssize_t j = 0; j < n; j++)
        if ((unsigned char)s[j] >= 0x80) return -1;
    /* python str.strip() whitespace (ASCII subset; >=0x80 fell back
     * above): space, \t-\r, and \x1c-\x1f */
#define IS_WS(c) ((c) == ' ' || ((c) >= '\t' && (c) <= '\r') \
                  || ((c) >= 0x1c && (c) <= 0x1f))
    while (n && IS_WS((unsigned char)s[0])) { s++; n--; }
    while (n && IS_WS((unsigned char)s[n-1])) n--;
#undef IS_WS
    if (!n) return 0;
    Py_ssize_t i = 0;
    if (s[i] == '+' || s[i] == '-') i++;
    Py_ssize_t dstart = i;
    while (i < n && s[i] >= '0' && s[i] <= '9') i++;
    if (i == dstart) return 0; /* at least one digit required */
    if (i < n && s[i] == '.') {
        i++;
        Py_ssize_t f = i;
        while (i < n && s[i] >= '0' && s[i] <= '9') i++;
        if (i == f) return 0; /* "1." not allowed by the regex */
    }
    if (i < n && (s[i] == 'e' || s[i] == 'E')) {
        Py_ssize_t esave = i;
        i++;
        if (i < n && (s[i] == '+' || s[i] == '-')) i++;
        Py_ssize_t d = i;
        while (i < n && s[i] >= '0' && s[i] <= '9') i++;
        if (i == d) { i = esave; } /* bare "e" is part of the suffix? no:
            regex requires digits after e; backtrack to treat as suffix
            (which will then fail unless it matches a unit) */
    }
    double mult = 1.0;
    Py_ssize_t rem = n - i;
    const char *suf = s + i;
    if (rem == 0) mult = 1.0;
    else if (rem == 1) {
        switch (suf[0]) {
            case 'm': mult = 1e-3; break;
            case 'k': mult = 1e3; break;
            case 'M': mult = 1e6; break;
            case 'G': mult = 1e9; break;
            case 'T': mult = 1e12; break;
            case 'P': mult = 1e15; break;
            case 'E': mult = 1e18; break;
            default: return 0;
        }
    } else if (rem == 2 && suf[1] == 'i') {
        switch (suf[0]) {
            case 'K': mult = 1024.0; break;
            case 'M': mult = 1048576.0; break;
            case 'G': mult = 1073741824.0; break;
            case 'T': mult = 1099511627776.0; break;
            case 'P': mult = 1125899906842624.0; break;
            case 'E': mult = 1152921504606846976.0; break;
            default: return 0;
        }
    } else return 0;
    char buf[64];
    if (i >= (Py_ssize_t)sizeof(buf)) return -1; /* python fallback */
    memcpy(buf, s, i);
    buf[i] = 0;
    char *end = NULL;
    double v = PyOS_string_to_double(buf, &end, NULL);
    if (end == NULL || *end != 0) { PyErr_Clear(); return 0; }
    *out = v * mult;
    return 1;
}

/* parse_quantity with the Python fallback for undecidable inputs;
 * -> 1 parsed (sets *out), 0 not a quantity, -1 python error. */
static int quantity_full(Enc *e, const char *s, Py_ssize_t n, double *out) {
    int rc = parse_quantity(s, n, out);
    if (rc >= 0) return rc;
    PyObject *arg = PyUnicode_DecodeUTF8(s, n, NULL);
    if (!arg) return -1;
    PyObject *res = PyObject_CallFunctionObjArgs(e->py_qty, arg, NULL);
    Py_DECREF(arg);
    if (!res) return -1;
    if (res == Py_None) { Py_DECREF(res); return 0; }
    double v = PyFloat_AsDouble(res);
    Py_DECREF(res);
    if (v == -1.0 && PyErr_Occurred()) return -1;
    *out = v;
    return 1;
}

/* vocab.intern("..."): dict lookup, else append (computing the quantity
 * memo like Vocab.intern does). Overlay mode consults the base dict
 * first (entries below the base_len snapshot only) and assigns local
 * ids from base_len up. Returns id or -1 on error. */
static int32_t intern(Enc *e, PyObject *key) {
    if (e->base_ids) {
        PyObject *bhit = PyDict_GetItemWithError(e->base_ids, key);
        if (bhit) {
            long v = PyLong_AsLong(bhit);
            if (v >= 0 && v < e->base_len) return (int32_t)v;
        } else if (PyErr_Occurred()) {
            return -1;
        }
    }
    PyObject *hit = PyDict_GetItemWithError(e->ids, key);
    if (hit) return (int32_t)PyLong_AsLong(hit);
    if (PyErr_Occurred()) return -1;
    Py_ssize_t id = e->base_len + PyList_GET_SIZE(e->strs);
    PyObject *idobj = PyLong_FromSsize_t(id);
    if (!idobj) return -1;
    if (PyDict_SetItem(e->ids, key, idobj) < 0) { Py_DECREF(idobj); return -1; }
    Py_DECREF(idobj);
    if (PyList_Append(e->strs, key) < 0) return -1;
    /* Vocab.intern also appends parse_quantity(s) to _quantity */
    Py_ssize_t n;
    const char *s = PyUnicode_AsUTF8AndSize(key, &n);
    if (!s) return -1;
    double q;
    PyObject *qobj;
    int qrc = quantity_full(e, s, n, &q);
    if (qrc < 0) return -1;
    if (qrc) qobj = PyFloat_FromDouble(q);
    else { qobj = Py_None; Py_INCREF(Py_None); }
    if (!qobj) return -1;
    int rc = PyList_Append(e->quant, qobj);
    Py_DECREF(qobj);
    if (rc < 0) return -1;
    return (int32_t)id;
}

static int32_t intern_prefixed(Enc *e, const char *prefix,
                               const char *s, Py_ssize_t n) {
    Py_ssize_t pl = (Py_ssize_t)strlen(prefix);
    char stack[512];
    char *buf = (pl + n + 1 <= (Py_ssize_t)sizeof(stack))
        ? stack : malloc(pl + n + 1);
    if (!buf) return -1;
    memcpy(buf, prefix, pl);
    memcpy(buf + pl, s, n);
    buf[pl + n] = 0;
    PyObject *k = PyUnicode_DecodeUTF8(buf, pl + n, NULL);
    if (buf != stack) free(buf);
    if (!k) return -1;
    int32_t id = intern(e, k);
    Py_DECREF(k);
    return id;
}

/* Emit one token: the PATH interns before the VALUE (id-assignment
 * order must match the Python encoder exactly — ids are load-bearing).
 * vpre == NULL -> vid -1 (empty obj/arr tokens). */
static int emit(Enc *e, int32_t i0, int32_t i1, int32_t kind,
                const char *vpre, const char *vs, Py_ssize_t vn,
                float vnum) {
    if (e->len >= e->cap && enc_grow(e) < 0) { PyErr_NoMemory(); return -1; }
    int32_t pid = intern_prefixed(e, "p:", e->path, e->path_len);
    if (pid < 0 && PyErr_Occurred()) return -1;
    int32_t vid = -1;
    if (vpre) {
        vid = intern_prefixed(e, vpre, vs, vn);
        if (vid < 0 && PyErr_Occurred()) return -1;
    }
    e->spath[e->len] = pid;
    e->idx0[e->len] = i0;
    e->idx1[e->len] = i1;
    e->kind[e->len] = kind;
    e->vid[e->len] = vid;
    e->vnum[e->len] = vnum;
    e->len++;
    return 0;
}

/* esc_seg: append the escaped key to the path buffer */
static int push_seg(Enc *e, PyObject *key, Py_ssize_t *save_len) {
    *save_len = e->path_len;
    PyObject *kstr = key;
    PyObject *tmp = NULL;
    if (!PyUnicode_Check(key)) {
        tmp = PyObject_Str(key);
        if (!tmp) return -1;
        kstr = tmp;
    }
    Py_ssize_t n;
    const char *s = PyUnicode_AsUTF8AndSize(kstr, &n);
    if (!s) { Py_XDECREF(tmp); return -1; }
    int needs = 0;
    for (Py_ssize_t i = 0; i < n; i++)
        if (s[i] == '%' || s[i] == '.') { needs = 1; break; }
    int lone_hash = (n == 1 && s[0] == '#');
    if (path_reserve(e, n * 3 + 2) < 0) { Py_XDECREF(tmp); PyErr_NoMemory(); return -1; }
    if (e->path_len) e->path[e->path_len++] = '.';
    if (lone_hash) {
        memcpy(e->path + e->path_len, "%23", 3);
        e->path_len += 3;
    } else if (needs) {
        for (Py_ssize_t i = 0; i < n; i++) {
            if (s[i] == '%') { memcpy(e->path + e->path_len, "%25", 3); e->path_len += 3; }
            else if (s[i] == '.') { memcpy(e->path + e->path_len, "%2E", 3); e->path_len += 3; }
            else e->path[e->path_len++] = s[i];
        }
    } else {
        memcpy(e->path + e->path_len, s, n);
        e->path_len += n;
    }
    Py_XDECREF(tmp);
    return 0;
}

static int rec(Enc *e, PyObject *v, int32_t i0, int32_t i1);

static int rec_dict(Enc *e, PyObject *v, int32_t i0, int32_t i1) {
    if (PyDict_GET_SIZE(v) == 0)
        return emit(e, i0, i1, K_EMPTY_OBJ, NULL, NULL, 0, 0.0f);
    PyObject *key, *val;
    Py_ssize_t pos = 0;
    while (PyDict_Next(v, &pos, &key, &val)) {
        Py_ssize_t save;
        if (push_seg(e, key, &save) < 0) return -1;
        if (rec(e, val, i0, i1) < 0) return -1;
        e->path_len = save;
    }
    return 0;
}

static int rec_list(Enc *e, PyObject *v, int32_t i0, int32_t i1) {
    Py_ssize_t n = PyList_GET_SIZE(v);
    if (n == 0)
        return emit(e, i0, i1, K_EMPTY_ARR, NULL, NULL, 0, 0.0f);
    Py_ssize_t save = e->path_len;
    if (path_reserve(e, 2) < 0) { PyErr_NoMemory(); return -1; }
    if (e->path_len) e->path[e->path_len++] = '.';
    e->path[e->path_len++] = '#';
    for (Py_ssize_t i = 0; i < n; i++) {
        int32_t n0 = i0, n1 = i1;
        if (i0 < 0) n0 = (int32_t)i;
        else if (i1 < 0) n1 = (int32_t)i;
        /* >2 array levels: indices saturate */
        if (rec(e, PyList_GET_ITEM(v, i), n0, n1) < 0) return -1;
    }
    e->path_len = save;
    return 0;
}

#define MAX_DEPTH 512

static int rec(Enc *e, PyObject *v, int32_t i0, int32_t i1) {
    if (PyDict_Check(v) || PyList_Check(v)) {
        if (++e->depth > MAX_DEPTH) {
            e->depth--;
            PyErr_SetString(PyExc_RecursionError,
                            "object nesting too deep for native flatten");
            return -1;
        }
        int rc = PyDict_Check(v) ? rec_dict(e, v, i0, i1)
                                 : rec_list(e, v, i0, i1);
        e->depth--;
        return rc;
    }
    if (PyBool_Check(v)) {
        int truth = (v == Py_True);
        return emit(e, i0, i1, K_BOOL, "j:", truth ? "true" : "false",
                    truth ? 4 : 5, truth ? 1.0f : 0.0f);
    }
    if (PyLong_Check(v)) {
        double d = PyLong_AsDouble(v);
        if (d == -1.0 && PyErr_Occurred()) return -1;
        PyObject *s = PyObject_Str(v);
        if (!s) return -1;
        Py_ssize_t n;
        const char *cs = PyUnicode_AsUTF8AndSize(s, &n);
        if (!cs) { Py_DECREF(s); return -1; }
        int rc = emit(e, i0, i1, K_NUM, "j:", cs, n, (float)d);
        Py_DECREF(s);
        return rc;
    }
    if (PyFloat_Check(v)) {
        double d = PyFloat_AS_DOUBLE(v);
        char *repr;
        PyObject *s = NULL;
        /* val_id: integral floats normalize to ints */
        if (isfinite(d) && d == floor(d)) {
            PyObject *asint = PyLong_FromDouble(d);
            if (!asint) return -1;
            s = PyObject_Str(asint);
            Py_DECREF(asint);
        } else if (isnan(d)) {
            s = PyUnicode_FromString("NaN");        /* json.dumps */
        } else if (isinf(d)) {
            s = PyUnicode_FromString(d > 0 ? "Infinity" : "-Infinity");
        } else {
            repr = PyOS_double_to_string(d, 'r', 0, 0, NULL);
            if (!repr) return -1;
            s = PyUnicode_FromString(repr);
            PyMem_Free(repr);
        }
        if (!s) return -1;
        Py_ssize_t n;
        const char *cs = PyUnicode_AsUTF8AndSize(s, &n);
        if (!cs) { Py_DECREF(s); return -1; }
        int rc = emit(e, i0, i1, K_NUM, "j:", cs, n, (float)d);
        Py_DECREF(s);
        return rc;
    }
    if (PyUnicode_Check(v)) {
        Py_ssize_t n;
        const char *cs = PyUnicode_AsUTF8AndSize(v, &n);
        if (!cs) return -1;
        /* K_STR vnum: quantity parse (encode_token_table) */
        double q;
        int qrc = quantity_full(e, cs, n, &q);
        if (qrc < 0) return -1;
        float vnum = qrc ? (float)q : 0.0f;
        return emit(e, i0, i1, K_STR, "s:", cs, n, vnum);
    }
    if (v == Py_None)
        return emit(e, i0, i1, K_NULL, "j:", "null", 4, 0.0f);
    /* non-JSON scalar (shouldn't happen for K8s objects): skip like the
     * Python generator (no branch matches -> nothing yielded) */
    return 0;
}

static PyObject *encode_rows(PyObject *self, PyObject *args) {
    PyObject *objs, *ids, *strs, *quant, *py_qty;
    PyObject *base_ids = Py_None;
    Py_ssize_t base_len = 0;
    if (!PyArg_ParseTuple(args, "OOOOO|On", &objs, &ids, &strs, &quant,
                          &py_qty, &base_ids, &base_len))
        return NULL;
    if (!PyList_Check(objs) || !PyDict_Check(ids) || !PyList_Check(strs)
        || !PyList_Check(quant) || !PyCallable_Check(py_qty)
        || (base_ids != Py_None && !PyDict_Check(base_ids))) {
        PyErr_SetString(
            PyExc_TypeError,
            "encode_rows(list, dict, list, list, parse_quantity"
            "[, base_ids_dict, base_len])");
        return NULL;
    }
    Enc e;
    memset(&e, 0, sizeof(e));
    e.ids = ids; e.strs = strs; e.quant = quant; e.py_qty = py_qty;
    e.base_ids = (base_ids == Py_None) ? NULL : base_ids;
    e.base_len = base_len;
    Py_ssize_t n_rows = PyList_GET_SIZE(objs);
    e.row_off = malloc((n_rows + 1) * sizeof(int32_t));
    if (!e.row_off || path_reserve(&e, 64) < 0 || enc_grow(&e) < 0) {
        PyErr_NoMemory();
        goto fail;
    }
    for (Py_ssize_t r = 0; r < n_rows; r++) {
        e.row_off[r] = (int32_t)e.len;
        e.path_len = 0;
        if (rec(&e, PyList_GET_ITEM(objs, r), -1, -1) < 0) goto fail;
    }
    e.row_off[n_rows] = (int32_t)e.len;

    PyObject *out = Py_BuildValue(
        "(y#y#y#y#y#y#y#)",
        (char *)e.spath, e.len * sizeof(int32_t),
        (char *)e.idx0, e.len * sizeof(int32_t),
        (char *)e.idx1, e.len * sizeof(int32_t),
        (char *)e.kind, e.len * sizeof(int32_t),
        (char *)e.vid, e.len * sizeof(int32_t),
        (char *)e.vnum, e.len * sizeof(float),
        (char *)e.row_off, (n_rows + 1) * sizeof(int32_t));
    free(e.spath); free(e.idx0); free(e.idx1); free(e.kind);
    free(e.vid); free(e.vnum); free(e.row_off); free(e.path);
    return out;
fail:
    free(e.spath); free(e.idx0); free(e.idx1); free(e.kind);
    free(e.vid); free(e.vnum); free(e.row_off); free(e.path);
    return NULL;
}

static PyMethodDef methods[] = {
    {"encode_rows", encode_rows, METH_VARARGS,
     "encode_rows(objs, vocab_ids, vocab_strs, vocab_quantity, parse_quantity) -> "
     "(spath, idx0, idx1, kind, vid, vnum, row_offsets) raw buffers"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_flatten_native", NULL, -1, methods,
};

PyMODINIT_FUNC PyInit__flatten_native(void) {
    return PyModule_Create(&module);
}
