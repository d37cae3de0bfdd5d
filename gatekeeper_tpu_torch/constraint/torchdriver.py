"""TorchDriver: the fused violation path on one CUDA device.

The torch counterpart of gatekeeper_tpu/constraint/tpudriver.py
(TpuDriver), slimmed to the fused violation path: an audit sweep
(`Client.audit`) and an admission micro-batch (`Client.review_many` ->
`query_many`) both encode their reviews into token tensors, stage the
policy and the corpus on the device, run one fused need dispatch
(parallel/fused.py: match kernel ∧ compiled template programs ∧ need tail)
and decode the sparse (review, constraint) pairs that need host work. Those
pairs render from the programs' compiled branch plans (engine/render.py)
where the plans prove an exact render, and on the interpreter otherwise.

Templates the symbolic compiler cannot compile, and rows whose array
fanout exceeds the device bucket cap (G_CAP), route to the interpreter, so
results equal the interpreter driver's (RegoDriver) in content and order.

Every micro-batch goes to the device: PyTorch compiles nothing, so there
is no cold kernel to serve around. Not carried over from TpuDriver (see
ROADMAP.md): the static analyzer's routing and feature liveness, fault
injection, external data, integrity canaries, cost attribution, metrics,
partitioned dispatch, the derived-key prune index and inventory row
features (a program that needs them raises NotImplementedError).
"""

from __future__ import annotations

import json
import re
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..engine.exprs import EvalCtx
from ..engine.matchkernel import features_to_np, matchspec_to_np
from ..engine.patterns import PatternRegistry
from ..engine.programs import Program, compile_program
from ..engine.render import RenderSet
from ..engine.symbolic import CompilerEnv, CompileUnsupported
from ..engine.tables import StrTables
from ..flatten.encoder import _bucket, batch_review_features, encode_token_table
from ..flatten.vocab import OverlayVocab, Vocab
from ..parallel.fused import FusedKernel, decode_need
from ..rego import ast as A
from ..rego.interp import RegoError, Undefined, _call_function
from ..rego.values import freeze, thaw
from . import hooks as H
from .driver import _HOOK_RE, RegoDriver, _autoreject_result, _cname
from .types import Response, Result

_TEMPLATE_PREFIX_RE = re.compile(r'^templates\["([^"]+)"\]\["([^"]+)"\]$')

# Array-axis fanout cap for device evaluation: rows with more elements on
# a lifted array axis route to the interpreter (EGroup drops idx >= g).
G_CAP = 64

# Resource-axis chunk of a device dispatch.
N_CHUNK = 32768

# Hot-row window of the whole-corpus dispatch; a chunk with more hot rows
# is re-dispatched alone with a larger window.
R_CAP = 1024


def _params_key(params: Any) -> str:
    return json.dumps(params, sort_keys=True, default=str)


@dataclass
class _Corpus:
    """Encoded review corpus: the persistent audit corpus (cached until
    data changes) or an ephemeral review batch (data_gen -1)."""

    data_gen: int
    reviews: List[Any]
    tok: Dict[str, np.ndarray]
    fb: Dict[str, np.ndarray]
    g: int  # first-level array fanout bucket (idx0)
    g1: int  # second-level fanout bucket (idx1)
    row_fallback: np.ndarray  # [N] bool: route row to interpreter
    staged: Any = None  # parallel.fused.StackedCorpus, staged lazily
    # ephemeral vocab overlay (review batches): the batch's novel strings
    # and their pattern/table rows, never interned globally
    vocab: Any = None
    v_base: int = 0
    ov_member: Optional[np.ndarray] = None  # [B_pad, P] bool
    ov_capture: Optional[np.ndarray] = None  # [B_pad, P] int32
    ov_tabs: Optional[Dict[str, np.ndarray]] = None  # name -> [B_pad]


@dataclass
class _ConstraintSet:
    """Compiled constraint-side state, cached until constraints change."""

    constraint_gen: int
    constraints: List[Dict[str, Any]]
    ms: Dict[str, np.ndarray]
    programs: List[Optional[Program]]  # index-aligned; None => interpreter
    policy: Any = None  # parallel.fused.StagedPolicy, staged lazily


class TorchDriver(RegoDriver):
    """Fused-path driver on one CUDA device (or, when the caller asks,
    on the CPU through the kernels' plain versions)."""

    def __init__(self, device: Any = None):
        super().__init__()
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchDriver: no CUDA device is available; pass "
                "device='cpu' to run on the CPU"
            )
        self.device = dev
        self.vocab = Vocab()
        self.patterns = PatternRegistry(self.vocab)
        self.tables = StrTables(self.vocab)
        self.kernel = FusedKernel(self.patterns, self.tables, dev)
        # (target, kind) -> rewritten template modules
        self._kind_modules: Dict[Tuple[str, str], List[A.Module]] = {}
        # (target, kind, params_key) -> Program | None (None = interpreter)
        self._programs: Dict[Tuple[str, str, str], Optional[Program]] = {}
        self._data_gen = 0
        self._constraint_gen = 0
        self._corpus: Dict[str, _Corpus] = {}
        self._cset: Dict[str, _ConstraintSet] = {}
        # rendered-pair cache of the audit corpus, per target, valid for
        # one (data, constraint) generation: violating pairs that persist
        # across sweeps skip the re-render
        self._render_cache: Dict[
            str, Tuple[Tuple[int, int], "OrderedDict[Tuple[int, int], List[Result]]"]
        ] = {}
        self.render_cache_max = 65536
        self._render_errors = 0  # compiled-render failures sent to interp
        self._hot_redispatches = 0  # chunks rerun for hot-row overflow
        # last query's pair routing, render split and phase seconds
        self.stats: Dict[str, Any] = {}

    # -- module/data bookkeeping (cache invalidation) ------------------------

    def put_modules(self, prefix: str, modules: Sequence[A.Module]) -> None:
        super().put_modules(prefix, modules)
        m = _TEMPLATE_PREFIX_RE.match(prefix)
        if m:
            with self._mutex:
                self._kind_modules[(m.group(1), m.group(2))] = list(modules)
                self._drop_programs(m.group(1), m.group(2))

    def delete_modules(self, prefix: str) -> int:
        n = super().delete_modules(prefix)
        m = _TEMPLATE_PREFIX_RE.match(prefix)
        if m:
            with self._mutex:
                self._kind_modules.pop((m.group(1), m.group(2)), None)
                self._drop_programs(m.group(1), m.group(2))
        return n

    def _drop_programs(self, target: str, kind: str) -> None:
        for key in [k for k in self._programs if k[:2] == (target, kind)]:
            del self._programs[key]
        self._cset.pop(target, None)
        self._constraint_gen += 1

    def put_data(self, path: str, data: Any) -> None:
        super().put_data(path, data)
        self._note_data_change(path)

    def delete_data(self, path: str) -> bool:
        existed = super().delete_data(path)
        self._note_data_change(path)
        return existed

    def _note_data_change(self, path: str) -> None:
        with self._mutex:
            p = path.lstrip("/")
            if p.startswith("external") or not p:
                self._data_gen += 1
            if p.startswith("constraints") or not p:
                self._constraint_gen += 1

    # -- program compilation -------------------------------------------------

    def _make_oracle(self, target: str, kind: str, params: Any):
        """Interpreter-backed helper-function oracle for the symbolic
        compiler (pure template helpers -> per-vocab lookup tables)."""
        node = self.interp._pkg_node(["templates", target, kind], create=False)
        if node is None:
            return lambda fn_name, value: (None, False)
        ctx = self.interp.make_context({"parameters": params}, {})

        def oracle_fn(fn_name: str, value: Any, extra=None):
            if extra is not None:
                sym_idx, consts = extra
                call_args = [freeze(c) for c in consts]
                call_args[sym_idx] = freeze(value)
            else:
                call_args = [freeze(value)]
            try:
                v = _call_function(ctx, None, node, fn_name, call_args)
            except RegoError:
                return None, False
            if v is Undefined:
                return None, False
            return thaw(v), True

        return oracle_fn

    def _program_for(
        self, target: str, constraint: Dict[str, Any]
    ) -> Optional[Program]:
        kind = constraint.get("kind")
        if not isinstance(kind, str):
            return None
        mods = self._kind_modules.get((target, kind))
        if mods is None:
            return None
        params = H.constraint_parameters(constraint)
        key = (target, kind, _params_key(params))
        if key in self._programs:
            return self._programs[key]
        env = CompilerEnv(
            self.vocab,
            self.patterns,
            self.tables,
            oracle_fn=self._make_oracle(target, kind, params),
            oracle_ns=f"{kind}|{key[2]}",
            oracle_ns_shared=f"{target}|{kind}",
            template_kind=kind,
        )
        try:
            prog = compile_program(env, mods, params)
        except CompileUnsupported:
            prog = None  # outside the compilable subset: interpreter
        if prog is not None and prog.row_features:
            raise NotImplementedError(
                f"template {kind}: its compiled program reads inventory row "
                f"features {list(prog.row_features)}, which "
                "gatekeeper_tpu_torch does not support yet"
            )
        self._programs[key] = prog
        return prog

    def _constraint_set(self, target: str) -> Optional[_ConstraintSet]:
        cs = self._cset.get(target)
        if cs is not None and cs.constraint_gen == self._constraint_gen:
            return cs
        constraints = self._constraints(target)
        if not constraints:
            self._cset.pop(target, None)
            return None
        ms = self._handler(target).compile_match_specs(constraints, self.vocab)
        programs = [self._program_for(target, c) for c in constraints]
        live = {
            (target, c.get("kind"), _params_key(H.constraint_parameters(c)))
            for c in constraints
        }
        for key in [k for k in self._programs if k[0] == target and k not in live]:
            del self._programs[key]
        cs = _ConstraintSet(
            constraint_gen=self._constraint_gen,
            constraints=constraints,
            ms=matchspec_to_np(ms),
            programs=programs,
        )
        self._cset[target] = cs
        return cs

    # -- corpus encoding -----------------------------------------------------

    def _encode_reviews(
        self, target: str, reviews: List[Any], ns_cache: Dict[str, Any],
        vocab: Any = None,
    ):
        """-> (tok, fb, (g, g1), row_fallback). `vocab` overrides the
        intern target (review batches pass an OverlayVocab)."""
        if vocab is None:
            vocab = self.vocab
        handler = self._handler(target)
        table = encode_token_table(reviews, vocab)
        feats = [
            handler.encode_review_features(r, ns_cache, vocab) for r in reviews
        ]
        fb = batch_review_features(feats)
        tok = {
            "spath": table.spath,
            "idx0": table.idx0,
            "idx1": table.idx1,
            "kind": table.kind,
            "vid": table.vid,
            "vnum": table.vnum,
        }
        max_i0 = int(np.asarray(table.idx0).max(initial=-1))
        max_i1 = int(np.asarray(table.idx1).max(initial=-1))
        g = _bucket(max(max_i0 + 1, 1), lo=8)
        g1 = _bucket(max(max_i1 + 1, 1), lo=4)
        row_fallback = np.asarray(table.overflow).copy()
        if fb.label_overflow is not None:
            row_fallback |= fb.label_overflow
        if g > G_CAP:
            g = G_CAP
            row_fallback |= (table.idx0 >= G_CAP).any(axis=1)
        if g1 > G_CAP:
            g1 = G_CAP
            row_fallback |= (table.idx1 >= G_CAP).any(axis=1)
        return tok, features_to_np(fb), (g, g1), row_fallback

    def _audit_corpus(self, target: str) -> Optional[_Corpus]:
        corpus = self._corpus.get(target)
        if corpus is not None and corpus.data_gen == self._data_gen:
            return corpus
        external = self.storage.get(["external", target], {})
        reviews = list(self._handler(target).iter_cached_reviews(external))
        if not reviews:
            self._corpus.pop(target, None)
            return None
        tok, fb, (g, g1), row_fallback = self._encode_reviews(
            target, reviews, self._ns_cache(target)
        )
        corpus = _Corpus(
            data_gen=self._data_gen, reviews=reviews, tok=tok, fb=fb, g=g,
            g1=g1, row_fallback=row_fallback,
        )
        self.patterns.sync()
        self.tables.sync()
        self._corpus[target] = corpus
        return corpus

    def _ephemeral_corpus(
        self, target: str, reviews: List[Any], ns_cache: Dict[str, Any]
    ) -> _Corpus:
        """Encode a review batch against an OverlayVocab and build its
        pattern/table overlay blocks: the base vocab, patterns and tables
        never change, so admission restages no table."""
        self.patterns.sync()
        self.tables.sync()
        overlay = OverlayVocab(self.vocab)
        tok, fb, (g, g1), row_fallback = self._encode_reviews(
            target, reviews, ns_cache, vocab=overlay
        )
        v_base = overlay.base_len
        # fill table and pattern rows for overlay entries to a fixed point
        # (transforms and captured segments intern new overlay strings)
        tab_parts: List[Dict[str, np.ndarray]] = []
        mem_parts: List[np.ndarray] = []
        cap_parts: List[np.ndarray] = []
        cur = v_base
        while cur < len(overlay):
            end = len(overlay)
            tab_parts.append(self.tables.fill_overlay(overlay, cur, end))
            m, c = self.patterns.classify_overlay(overlay, cur, end)
            mem_parts.append(m)
            cap_parts.append(c)
            cur = end
        b = len(overlay) - v_base
        b_pad = _bucket(max(b, 1), lo=128)
        p = self.patterns.n_patterns
        ov_member = np.zeros((b_pad, p), bool)
        ov_capture = np.full((b_pad, p), -1, np.int32)
        if b:
            ov_member[:b] = np.concatenate(mem_parts, axis=0)
            ov_capture[:b] = np.concatenate(cap_parts, axis=0)
        ov_tabs: Dict[str, np.ndarray] = {}
        if tab_parts and tab_parts[0]:
            for name in tab_parts[0]:
                col = np.concatenate([t[name] for t in tab_parts])
                padded = np.zeros((b_pad,), col.dtype)
                padded[:b] = col
                ov_tabs[name] = padded
        return _Corpus(
            data_gen=-1, reviews=reviews, tok=tok, fb=fb, g=g, g1=g1,
            row_fallback=row_fallback, vocab=overlay, v_base=v_base,
            ov_member=ov_member, ov_capture=ov_capture, ov_tabs=ov_tabs,
        )

    # -- device dispatch -----------------------------------------------------

    def _stage_corpus(self, corpus: _Corpus, policy):
        """Slice/pad the encoded corpus into uniform chunks and ship them
        to the device once (StackedCorpus)."""
        if corpus.staged is not None:
            return corpus.staged
        n = len(corpus.reviews)
        chunk = min(N_CHUNK, _bucket(n, lo=64))
        chunks = []
        for start in range(0, n, chunk):
            end = min(start + chunk, n)
            pad = chunk - (end - start)
            fb_c = {k: _pad_rows(v[start:end], pad) for k, v in corpus.fb.items()}
            tok_c = {
                k: _pad_rows(v[start:end], pad, fill=0 if k == "vnum" else -1)
                for k, v in corpus.tok.items()
            }
            chunks.append(
                (fb_c, tok_c, corpus.row_fallback[start:end], end - start)
            )
        ov = None
        if corpus.ov_member is not None:
            ov = {
                "member": corpus.ov_member,
                "capture": corpus.ov_capture,
                "tabs": corpus.ov_tabs,
            }
        corpus.staged = self.kernel.stage_corpus_stacked(
            chunks, policy, ov=ov, v_base=corpus.v_base
        )
        return corpus.staged

    def _need_pairs(
        self, cs: _ConstraintSet, corpus: _Corpus, phases: Dict[str, float]
    ) -> Tuple[List[Tuple[int, int]], int, int]:
        """Sparse evaluation: -> (review-major (n, c) pairs needing host
        work, compiled_pairs, interp_pairs); adds stage/dispatch/decode
        seconds to `phases`."""
        t0 = time.perf_counter()
        if cs.policy is None:
            cs.policy = self.kernel.stage_policy(cs.programs, cs.ms)
        policy = cs.policy
        stacked = self._stage_corpus(corpus, policy)
        t1 = time.perf_counter()
        packed, hot, n_hot, sc, si = self.kernel.dispatch_need_all(
            policy, stacked, (corpus.g, corpus.g1), r_cap=R_CAP
        )
        t2 = time.perf_counter()
        pairs: List[Tuple[int, int]] = []
        for ci in range(stacked.k):
            start = ci * stacked.chunk
            if int(n_hot[ci]) > hot.shape[1]:
                # more hot rows than the compaction window: rerun alone
                p_c, h_c, _nh, _sc, _si = self._redispatch_chunk(
                    policy, corpus, stacked, ci, int(n_hot[ci])
                )
                n_loc, c_is = decode_need(p_c, h_c, policy.c_pad)
            else:
                n_loc, c_is = decode_need(packed[ci], hot[ci], policy.c_pad)
            pairs.extend(zip((start + n_loc).tolist(), c_is.tolist()))
        t3 = time.perf_counter()
        phases["stage"] = t1 - t0
        phases["dispatch"] = t2 - t1
        phases["decode"] = t3 - t2
        return pairs, int(sc.sum()), int(si.sum())

    def _redispatch_chunk(self, policy, corpus: _Corpus, stacked, ci: int,
                          n_hot: int):
        """Overflow path: rerun one chunk with a window that fits its hot
        rows (the window doubles until the rerun's own n_hot fits)."""
        self._hot_redispatches += 1
        r_cap = 1 << (n_hot - 1).bit_length()
        batch = stacked.chunk_view(ci)
        while True:
            out = self.kernel.dispatch_need(
                policy, batch, (corpus.g, corpus.g1), r_cap=r_cap,
                ov_in=stacked.ov_dev, v_base=stacked.v_base,
            )
            if out[2] <= min(r_cap, stacked.chunk):
                return out
            r_cap = min(2 * r_cap, stacked.chunk)

    # -- hook overrides ------------------------------------------------------

    def _violation(
        self, target: str, input: Dict[str, Any], trace: Optional[List[str]]
    ) -> List[Result]:
        return self._query_batch(target, [input], trace)[0]

    def query_many(
        self, path: str, inputs: Sequence[Any], tracing: bool = False
    ) -> List[Response]:
        """Batched violation hook: the whole batch is one fused dispatch
        (the admission micro-batch path). Other hooks and traced queries
        take the serial default."""
        m = _HOOK_RE.match(path)
        if m is None or m.group(2) != "violation" or tracing:
            return super().query_many(path, inputs, tracing)
        target = m.group(1)
        with self._mutex:
            split = self._query_batch(target, list(inputs), None)
        return [Response(target=target, results=r) for r in split]

    def _query_batch(
        self, target: str, inputs: List[Any], trace: Optional[List[str]]
    ) -> List[List[Result]]:
        """Autoreject results, then the fused evaluation, per review."""
        handler = self._handler(target)
        constraints = self._constraints(target)
        if not constraints:
            return [[] for _ in inputs]
        ns_cache = self._ns_cache(target)
        reviews = [H.hook_get_default(i or {}, "review", {}) for i in inputs]
        rej_constraints = [
            c for c in constraints if handler.constraint_needs_context(c)
        ]
        out: List[List[Result]] = []
        for review in reviews:
            auto: List[Result] = []
            if rej_constraints and handler.review_autorejects(review, ns_cache):
                auto = [_autoreject_result(c, review) for c in rej_constraints]
                if trace is not None:
                    trace.extend(f"autoreject: {_cname(c)}" for c in rej_constraints)
            out.append(auto)
        split = self._eval_reviews_split(target, reviews, trace, corpus=None)
        return [a + r for a, r in zip(out, split)]

    def _audit(self, target: str, trace: Optional[List[str]]) -> List[Result]:
        t0 = time.perf_counter()
        with self._mutex:
            corpus = self._audit_corpus(target)
        if corpus is None:
            self.stats = {}
            return []
        split = self._eval_reviews_split(
            target, corpus.reviews, trace, corpus,
            encode_s=time.perf_counter() - t0,
        )
        return [r for sub in split for r in sub]

    def _eval_reviews_split(
        self,
        target: str,
        reviews: List[Any],
        trace: Optional[List[str]],
        corpus: Optional[_Corpus],
        encode_s: float = 0.0,
    ) -> List[List[Result]]:
        """Fused evaluation on the device, then rendering of the sparse
        pairs that need host work; results grouped per review in the
        interpreter driver's (review-major) order. `encode_s`: seconds
        the caller spent encoding `corpus` (the cached audit corpus)."""
        t_start = time.perf_counter()
        with self._mutex:
            cs = self._constraint_set(target)
            if cs is None:
                self.stats = {}
                return [[] for _ in reviews]
            ns_cache = self._ns_cache(target)
            t_policy = time.perf_counter()
            if corpus is None:
                corpus = self._ephemeral_corpus(target, reviews, ns_cache)
            self.patterns.sync()
            self.tables.sync()
            phases: Dict[str, float] = {
                "policy": t_policy - t_start,
                "encode": encode_s + time.perf_counter() - t_policy,
            }
            pairs, stat_c, stat_i = self._need_pairs(cs, corpus, phases)
            t_render = time.perf_counter()
            render_cache = None
            if corpus.data_gen >= 0 and trace is None:
                gens = (self._data_gen, self._constraint_gen)
                cached = self._render_cache.get(target)
                if cached is None or cached[0] != gens:
                    cached = (gens, OrderedDict())
                    self._render_cache[target] = cached
                render_cache = cached[1]
            # look every pair up BEFORE rendering: inserting this sweep's
            # renders evicts the oldest entries, which a sweep larger than
            # the cache would otherwise miss again further down its list
            hits: Dict[Tuple[int, int], List[Result]] = {}
            if render_cache is not None:
                hits = {p: render_cache[p] for p in pairs if p in render_cache}
            host_rendered: Dict[Tuple[int, int], List[Result]] = {}
            if trace is None:
                host_rendered = self._host_render_pairs(
                    cs, corpus, [p for p in pairs if p not in hits], reviews
                )
            inventory = None
            per_review: List[List[Result]] = [[] for _ in reviews]
            n_results = n_host = n_interp = n_cache_hits = 0
            frozen: Dict[int, Any] = {}
            for n_i, c_i in pairs:
                out = hits.get((n_i, c_i))
                if out is not None:
                    n_cache_hits += 1
                else:
                    out = host_rendered.get((n_i, c_i))
                    if out is not None:
                        n_host += 1
                    else:
                        fr = frozen.get(n_i)
                        if fr is None:
                            fr = frozen[n_i] = freeze(reviews[n_i])
                        if inventory is None:
                            # frozen only when the interpreter renders
                            inventory = self._inventory(target)
                        out = self._eval_template(
                            target, cs.constraints[c_i], reviews[n_i],
                            inventory, trace, frozen_review=fr,
                        )
                        n_interp += 1
                    if render_cache is not None:
                        if len(render_cache) >= self.render_cache_max:
                            render_cache.popitem(last=False)
                        render_cache[(n_i, c_i)] = out
                per_review[n_i].extend(out)
                n_results += len(out)
            phases["render"] = time.perf_counter() - t_render
            self.stats = {
                "compiled_pairs": stat_c,
                "interp_pairs": stat_i,
                "n_reviews": len(reviews),
                "n_constraints": len(cs.constraints),
                "n_results": n_results,
                "host_rendered_pairs": n_host,
                "interp_rendered_pairs": n_interp,
                "render_cache_hits": n_cache_hits,
                "render_errors": self._render_errors,
                "hot_redispatches": self._hot_redispatches,
                "phase_seconds": phases,
            }
            if trace is not None:
                trace.append(
                    f"torch dispatch: {stat_c} compiled pairs, "
                    f"{stat_i} interpreter pairs"
                )
            return per_review

    # -- compiled message rendering ------------------------------------------

    def _host_render_pairs(
        self,
        cs: _ConstraintSet,
        corpus: _Corpus,
        pairs: List[Tuple[int, int]],
        reviews: List[Any],
    ) -> Dict[Tuple[int, int], List[Result]]:
        """Render violating pairs of exact programs from their compiled
        branch plans (engine/render.py), evaluated with torch on the CPU
        over the violating rows only. Rows/pairs the plans cannot prove
        exact are omitted (the caller renders them on the interpreter).
        Violation objects render once per (program, row) and fan out to
        every constraint sharing the program."""
        out: Dict[Tuple[int, int], List[Result]] = {}
        by_prog: Dict[int, Tuple[Program, List[Tuple[int, int]]]] = {}
        for n_i, c_i in pairs:
            p = cs.programs[c_i]
            if p is None or not p.branches or corpus.row_fallback[n_i]:
                continue
            by_prog.setdefault(id(p), (p, []))[1].append((n_i, c_i))
        if not by_prog:
            return out
        cpu = torch.device("cpu")

        def t(a):
            # host render keeps the host arrays' types (as the JAX
            # package's numpy render does), float64 tables included
            return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))

        member = t(self.patterns.member)
        capture = t(self.patterns.capture)
        tabs = {k: t(v) for k, v in self.tables.arrays().items()}
        ov = {}
        if corpus.ov_member is not None:
            ov = {
                "v_base": corpus.v_base,
                "member": t(corpus.ov_member),
                "capture": t(corpus.ov_capture),
                "tabs": {k: t(v) for k, v in corpus.ov_tabs.items()},
            }
        corpus_vocab = corpus.vocab if corpus.vocab is not None else self.vocab
        for prog, plist in by_prog.values():
            rows = sorted({n for n, _ in plist})
            pos = {n: i for i, n in enumerate(rows)}
            idx = np.asarray(rows, np.int64)
            ctx = EvalCtx(
                tok={k: t(v[idx]).to(cpu) for k, v in corpus.tok.items()},
                pat_member=member,
                pat_capture=capture,
                str_tables=tabs,
                consts={k: t(v) for k, v in prog.consts.items()},
                g0=corpus.g,
                g1=corpus.g1,
                v_base=ov.get("v_base"),
                ov_member=ov.get("member"),
                ov_capture=ov.get("capture"),
                ov_tabs=ov.get("tabs"),
            )
            try:
                rset = RenderSet(prog, ctx, corpus_vocab)
                row_objs = {n: rset.render_row(pos[n], reviews[n]) for n in rows}
            except Exception:
                # a plan evaluation failure degrades to the interpreter,
                # never fails the sweep; counted in stats
                self._render_errors += 1
                continue
            for n_i, c_i in plist:
                objs = row_objs.get(n_i)
                if objs is not None:
                    out[(n_i, c_i)] = _results_from_objs(
                        objs, cs.constraints[c_i], reviews[n_i]
                    )
        return out


def _results_from_objs(
    objs: List[Any], constraint: Dict[str, Any], review: Any
) -> List[Result]:
    """Frozen violation objects -> Result list, shaped exactly as the
    hook's (RegoDriver._eval_template): msg-less violations drop, details
    default {}."""
    enforcement = H.enforcement_action(constraint)
    out: List[Result] = []
    for v in objs:
        tv = thaw(v)
        if not isinstance(tv, dict) or "msg" not in tv:
            continue
        out.append(
            Result(
                msg=tv["msg"],
                metadata={"details": H.hook_get_default(tv, "details", {})},
                constraint=constraint,
                review=review,
                enforcement_action=enforcement,
            )
        )
    return out


def _pad_rows(a: np.ndarray, pad: int, fill=None) -> np.ndarray:
    if pad <= 0:
        return a
    if fill is None:
        fill = False if a.dtype == bool else -1
    return np.concatenate([a, np.full((pad,) + a.shape[1:], fill, a.dtype)])
