# Copied from gatekeeper_tpu/rego/interp.py; only imports and the edits noted in this header differ.
# Edit: source paths in comments point into the upstream Gatekeeper repo (gatekeeper/...).
"""Topdown-style Rego interpreter.

This is the framework's semantics oracle and CPU fallback evaluator. It
mirrors the behavior of the vendored OPA topdown evaluator
(gatekeeper/vendor/github.com/open-policy-agent/opa/topdown/eval.go)
for the dialect used by Gatekeeper's policy library:

- generator-based body evaluation with backtracking,
- virtual documents (complete / partial-set / partial-object rules) mounted
  into the `data` tree alongside base documents,
- multi-clause functions with literal-pattern formals,
- negation as failure, comprehensions, `with` modifiers,
- memoized rule and function evaluation per query context.

Undefined propagates silently (an expression referencing a missing field
simply fails); builtin errors also make expressions undefined, matching
OPA's non-strict default.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple

from . import ast as A
from .builtins import BUILTINS, BuiltinError
from .parser import parse_module
from .rewrite import rewrite_module
from .safety import all_vars, module_known, reorder_body
from .values import (
    Obj,
    freeze,
    is_truthy,
    rego_cmp,
    sort_key,
    thaw,
    type_name,
)

Env = Dict[str, Any]


class RegoError(Exception):
    """Evaluation error (conflict, recursion, unsafe var)."""


class _UndefinedType:
    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "<undefined>"

    def __bool__(self):
        return False


Undefined = _UndefinedType()


class PkgNode:
    """A node in the package tree: child packages + rules mounted here."""

    __slots__ = ("children", "rules")

    def __init__(self):
        self.children: Dict[str, "PkgNode"] = {}
        self.rules: Dict[str, List[A.Rule]] = {}


class DataCursor:
    """Navigation handle over the merged base-data / virtual-document tree."""

    __slots__ = ("base", "pkg", "path")

    def __init__(self, base: Any, pkg: Optional[PkgNode], path: Tuple[str, ...]):
        self.base = base  # frozen value or Undefined
        self.pkg = pkg  # PkgNode or None
        self.path = path


class Context:
    """Per-query evaluation context: documents + caches.

    `with` modifiers create derived contexts with fresh caches.
    """

    __slots__ = ("interp", "input", "data_root", "cache", "fn_cache", "stack")

    def __init__(self, interp: "Interpreter", input_doc: Any, data_root: Any):
        self.interp = interp
        self.input = input_doc
        self.data_root = data_root
        self.cache: Dict[Any, Any] = {}
        self.fn_cache: Dict[Any, Any] = {}
        self.stack: set = set()


class Interpreter:
    def __init__(self):
        self.pkg_root = PkgNode()
        self.modules: Dict[str, A.Module] = {}
        # safety-reorder caches (keyed by body identity + initially-bound vars)
        self._reorder_cache: Dict[Any, List[A.Expr]] = {}
        self._body_vars_cache: Dict[int, frozenset] = {}
        self._known_cache: Dict[int, frozenset] = {}

    # -- module management --------------------------------------------------

    def add_module(self, name: str, src_or_module) -> A.Module:
        mod = (
            src_or_module
            if isinstance(src_or_module, A.Module)
            else parse_module(src_or_module)
        )
        if name in self.modules:
            self.remove_module(name)
        rewrite_module(mod)
        self.modules[name] = mod
        node = self._pkg_node(mod.package, create=True)
        for rule in mod.rules:
            rule._module = mod  # type: ignore[attr-defined]
            node.rules.setdefault(rule.head.name, []).append(rule)
        self._reorder_cache.clear()
        self._known_cache.clear()
        self._body_vars_cache.clear()
        return mod

    def remove_module(self, name: str) -> None:
        mod = self.modules.pop(name, None)
        if mod is None:
            return
        node = self._pkg_node(mod.package, create=False)
        if node is None:
            return
        for rule in mod.rules:
            lst = node.rules.get(rule.head.name)
            if lst and rule in lst:
                lst.remove(rule)
                if not lst:
                    del node.rules[rule.head.name]
        self._reorder_cache.clear()
        self._known_cache.clear()
        self._body_vars_cache.clear()

    def _pkg_node(self, path: List[str], create: bool) -> Optional[PkgNode]:
        node = self.pkg_root
        for seg in path:
            nxt = node.children.get(seg)
            if nxt is None:
                if not create:
                    return None
                nxt = PkgNode()
                node.children[seg] = nxt
            node = nxt
        return node

    # -- public query API ---------------------------------------------------

    def make_context(self, input_doc: Any = None, data_doc: Any = None) -> Context:
        return Context(self, freeze(input_doc), freeze(data_doc or {}))

    def eval_rule_extent(
        self, pkg_path: List[str], rule_name: str, ctx: Context
    ) -> Any:
        """Evaluate a rule's full extent; Undefined if no solutions."""
        node = self._pkg_node(list(pkg_path), create=False)
        if node is None or rule_name not in node.rules:
            return Undefined
        mod = node.rules[rule_name][0]._module  # type: ignore[attr-defined]
        return _eval_rule(ctx, mod, node, rule_name)

    def query_violations(
        self, pkg_path: List[str], input_doc: Any, data_doc: Any = None
    ) -> List[Any]:
        """Evaluate the `violation` partial set of a template package.

        Returns thawed violation objects ({"msg": ..., "details": ...}).
        """
        ctx = self.make_context(input_doc, data_doc)
        extent = self.eval_rule_extent(pkg_path, "violation", ctx)
        if extent is Undefined:
            return []
        return [thaw(v) for v in sorted(extent, key=sort_key)]

    def run_tests(self, data_doc: Any = None) -> Dict[str, Any]:
        """Run OPA-style unit tests: every rule named test_* must be true.

        Mirrors `opa test` as used by the reference's library test harness
        (gatekeeper/library/pod-security-policy/test.sh). Returns a map
        of test name -> True (pass) / False (fail/undefined) / Exception.
        """
        results: Dict[str, Any] = {}
        for mod in self.modules.values():
            seen = set()
            for rule in mod.rules:
                name = rule.head.name
                if not name.startswith("test_") or name in seen:
                    continue
                seen.add(name)
                ctx = self.make_context(None, data_doc)
                node = self._pkg_node(mod.package, create=False)
                try:
                    v = _eval_rule(ctx, mod, node, name)
                    results[f"{mod.package_path}.{name}"] = v is not Undefined and v is not False
                except Exception as e:  # pragma: no cover - diagnostics
                    results[f"{mod.package_path}.{name}"] = e
        return results


# ===========================================================================
# Evaluation machinery (module-level functions; ctx carries all state)


def _bind(env: Env, name: str, value: Any) -> Env:
    e2 = dict(env)
    e2[name] = value
    return e2


def _module_node(ctx: Context, mod: A.Module) -> PkgNode:
    node = ctx.interp._pkg_node(mod.package, create=False)
    assert node is not None
    return node


def _rule_key(mod: A.Module, name: str) -> Tuple:
    return (mod.package_path, name)


def _strict_eq(a: Any, b: Any) -> bool:
    return rego_cmp(a, b) == 0 and isinstance(a, bool) == isinstance(b, bool)


def _eval_rule(ctx: Context, mod: A.Module, node: PkgNode, name: str) -> Any:
    """Evaluate the extent of rule `name` in package node; memoized."""
    key = _rule_key(mod, name)
    if key in ctx.cache:
        return ctx.cache[key]
    if key in ctx.stack:
        raise RegoError(f"recursive rule reference: {'.'.join(key[0])}.{name}")
    rules = node.rules.get(name, [])
    ctx.stack.add(key)
    try:
        kinds = {r.head.kind for r in rules if not r.is_default}
        defaults = [r for r in rules if r.is_default]
        normal = [r for r in rules if not r.is_default]
        if "func" in kinds:
            raise RegoError(f"rule {name} is a function; cannot use as document")
        if kinds <= {"complete"}:
            # all body solutions are enumerated: conflicting outputs raise,
            # matching OPA's "complete rules must not produce multiple
            # outputs" error rather than silently taking the first
            results: List[Any] = []
            for rule in normal:
                rmod = rule._module  # type: ignore[attr-defined]
                for env in _eval_body(ctx, rmod, rule.body, {}):
                    for v, _ in _eval_term(ctx, rmod, rule.head.value, env):
                        if not any(_strict_eq(v, r) for r in results):
                            results.append(v)
            if len(results) > 1:
                raise RegoError(f"complete rule {name}: conflicting values")
            if results:
                value = results[0]
            elif defaults:
                value = _eval_default(ctx, defaults[0])
            else:
                value = Undefined
        elif kinds == {"set"}:
            items = []
            for rule in normal:
                rmod = rule._module  # type: ignore[attr-defined]
                for env in _eval_body(ctx, rmod, rule.body, {}):
                    for v, _ in _eval_term(ctx, rmod, rule.head.key, env):
                        items.append(v)
            value = frozenset(items)
        elif kinds == {"object"}:
            out: Dict[Any, Any] = {}
            for rule in normal:
                rmod = rule._module  # type: ignore[attr-defined]
                for env in _eval_body(ctx, rmod, rule.body, {}):
                    for k, env2 in _eval_term(ctx, rmod, rule.head.key, env):
                        for v, _ in _eval_term(ctx, rmod, rule.head.value, env2):
                            if k in out and not _strict_eq(out[k], v):
                                raise RegoError(
                                    f"partial object {name}: conflicting values"
                                )
                            out[k] = v
            value = Obj(out)
        else:
            raise RegoError(f"rule {name}: mixed rule kinds {kinds}")
        ctx.cache[key] = value
        return value
    finally:
        ctx.stack.discard(key)


def _eval_default(ctx: Context, rule: A.Rule) -> Any:
    rmod = rule._module  # type: ignore[attr-defined]
    for v, _ in _eval_term(ctx, rmod, rule.head.value, {}):
        return v
    return Undefined


def _call_function(
    ctx: Context, mod: A.Module, node: PkgNode, name: str, args: List[Any]
) -> Any:
    """Call a user function; returns value or Undefined."""
    fkey = (id(node), name, tuple(args))
    if fkey in ctx.fn_cache:
        return ctx.fn_cache[fkey]
    rules = node.rules.get(name, [])
    outputs: List[Any] = []
    for rule in rules:
        if rule.head.kind != "func":
            raise RegoError(f"{name} is not a function")
        formals = rule.head.args or []
        if len(formals) != len(args):
            continue
        rmod = rule._module  # type: ignore[attr-defined]
        env: Optional[Env] = {}
        for formal, actual in zip(formals, args):
            env = _match_formal(ctx, rmod, formal, actual, env)
            if env is None:
                break
        if env is None:
            continue
        for benv in _eval_body(ctx, rmod, rule.body, env):
            for v, _ in _eval_term(ctx, rmod, rule.head.value, benv):
                if not any(_strict_eq(v, o) for o in outputs):
                    outputs.append(v)
    if len(outputs) > 1:
        raise RegoError(f"function {name}: conflicting outputs")
    result = outputs[0] if outputs else Undefined
    ctx.fn_cache[fkey] = result
    return result


def _match_formal(
    ctx: Context, mod: A.Module, formal: A.Term, actual: Any, env: Env
) -> Optional[Env]:
    """Unify a function formal parameter against an actual value."""
    if isinstance(formal, A.Wildcard):
        return env
    if isinstance(formal, A.Var):
        if formal.name in env:
            return env if _strict_eq(env[formal.name], actual) else None
        return _bind(env, formal.name, actual)
    if isinstance(formal, A.Scalar):
        return env if _strict_eq(freeze(formal.value), actual) else None
    if isinstance(formal, A.ArrayTerm):
        if type_name(actual) != "array" or len(actual) != len(formal.items):
            return None
        for f, a in zip(formal.items, actual):
            env = _match_formal(ctx, mod, f, a, env)
            if env is None:
                return None
        return env
    # fall back: evaluate the formal as a term and compare
    for v, env2 in _eval_term(ctx, mod, formal, env):
        if _strict_eq(v, actual):
            return env2
    return None


# -- body / expr evaluation -------------------------------------------------


def _known_names(ctx: Context, mod: A.Module) -> frozenset:
    interp = ctx.interp
    key = id(mod)
    known = interp._known_cache.get(key)
    if known is None:
        node = _module_node(ctx, mod)
        known = frozenset(module_known(mod, set(node.rules)))
        interp._known_cache[key] = known
    return known


def _eval_body(
    ctx: Context, mod: A.Module, body: A.Body, env: Env
) -> Iterator[Env]:
    """Evaluate a body with OPA-style safety reordering (memoized)."""
    if not body:
        yield env
        return
    interp = ctx.interp
    known = _known_names(ctx, mod)
    bvars = interp._body_vars_cache.get(id(body))
    if bvars is None:
        referenced: set = set()
        for e in body:
            referenced |= all_vars(e, known)
        bvars = frozenset(referenced)
        interp._body_vars_cache[id(body)] = bvars
    bound0 = frozenset(k for k in env if k in bvars)
    ckey = (id(body), bound0)
    ordered = interp._reorder_cache.get(ckey)
    if ordered is None:
        ordered = reorder_body(body, set(bound0), set(known))
        interp._reorder_cache[ckey] = ordered
    yield from _eval_body_seq(ctx, mod, ordered, 0, env)


def _eval_body_seq(
    ctx: Context, mod: A.Module, body: List[A.Expr], i: int, env: Env
) -> Iterator[Env]:
    if i == len(body):
        yield env
        return
    for env2 in _eval_expr(ctx, mod, body[i], env):
        yield from _eval_body_seq(ctx, mod, body, i + 1, env2)


def _eval_expr(ctx: Context, mod: A.Module, expr: A.Expr, env: Env) -> Iterator[Env]:
    if isinstance(expr, A.TermExpr):
        for v, env2 in _eval_term(ctx, mod, expr.term, env):
            if is_truthy(v):
                yield env2
        return
    if isinstance(expr, A.Assign):
        # `:=` declares locals and may shadow rule names and even input/data
        # (the reference's src_test.rego files do `input := {...}`)
        for v, env2 in _eval_term(ctx, mod, expr.value, env):
            env3 = _bind_pattern(ctx, mod, expr.target, v, env2, declare=True)
            if env3 is not None:
                yield env3
        return
    if isinstance(expr, A.Unify):
        yield from _unify(ctx, mod, expr.lhs, expr.rhs, env)
        return
    if isinstance(expr, A.NotExpr):
        for _ in _eval_expr(ctx, mod, expr.expr, env):
            return  # at least one solution -> `not` fails
        yield env
        return
    if isinstance(expr, A.SomeDecl):
        env2 = dict(env)
        for n in expr.names:
            env2.pop(n, None)
        yield env2
        return
    if isinstance(expr, A.WithExpr):
        yield from _eval_with(ctx, mod, expr, env)
        return
    raise RegoError(f"unsupported expression {type(expr).__name__}")


def _eval_with(
    ctx: Context, mod: A.Module, expr: A.WithExpr, env: Env
) -> Iterator[Env]:
    new_input = ctx.input
    new_data = ctx.data_root
    for m in expr.mods:
        # resolve the modifier value in the *current* context
        vals = list(_eval_term(ctx, mod, m.value, env))
        if not vals:
            return  # undefined modifier value -> expression undefined
        value = vals[0][0]
        path = _term_ref_path(m.target)
        if path is None:
            raise RegoError("with: unsupported target")
        if path[0] == "input":
            new_input = value if len(path) == 1 else _set_path(new_input, path[1:], value)
        elif path[0] == "data":
            new_data = value if len(path) == 1 else _set_path(new_data, path[1:], value)
        else:
            raise RegoError("with: target must be input or data")
    sub = Context(ctx.interp, new_input, new_data)
    # share the recursion stack so cycles through `with` are still detected
    sub.stack = ctx.stack
    # bindings made under `with` propagate out (OPA behavior)
    yield from _eval_expr(sub, mod, expr.expr, env)


def _term_ref_path(t: A.Term) -> Optional[List[str]]:
    if isinstance(t, A.Var):
        return [t.name]
    if isinstance(t, A.Ref) and isinstance(t.head, A.Var):
        path = [t.head.name]
        for op in t.ops:
            if isinstance(op, A.Scalar) and isinstance(op.value, str):
                path.append(op.value)
            else:
                return None
        return path
    return None


def _set_path(root: Any, path: List[str], value: Any) -> Any:
    if not path:
        return value
    base = root if isinstance(root, Obj) else Obj({})
    k = path[0]
    child = base[k] if k in base else Obj({})
    return base.set(k, _set_path(child, path[1:], value))


def _bind_pattern(
    ctx: Context,
    mod: A.Module,
    pattern: A.Term,
    value: Any,
    env: Env,
    declare: bool = False,
) -> Optional[Env]:
    if isinstance(pattern, A.Wildcard):
        return env
    if isinstance(pattern, A.Var):
        node = _module_node(ctx, mod)
        if pattern.name in env:
            return env if _strict_eq(env[pattern.name], value) else None
        if not declare and (
            pattern.name in node.rules or pattern.name in ("input", "data")
        ):
            # name refers to a rule/document: compare, don't bind
            for v, env2 in _eval_term(ctx, mod, pattern, env):
                if _strict_eq(v, value):
                    return env2
            return None
        return _bind(env, pattern.name, value)
    if isinstance(pattern, A.ArrayTerm):
        if type_name(value) != "array" or len(value) != len(pattern.items):
            return None
        for p, v in zip(pattern.items, value):
            env2 = _bind_pattern(ctx, mod, p, v, env, declare=declare)
            if env2 is None:
                return None
            env = env2
        return env
    if isinstance(pattern, A.ObjectTerm):
        if type_name(value) != "object":
            return None
        for kt, vt in pattern.items:
            kvals = list(_eval_term(ctx, mod, kt, env))
            if len(kvals) != 1:
                return None
            k = kvals[0][0]
            if k not in value:
                return None
            env2 = _bind_pattern(ctx, mod, vt, value[k], env, declare=declare)
            if env2 is None:
                return None
            env = env2
        return env
    if isinstance(pattern, A.Scalar):
        return env if _strict_eq(freeze(pattern.value), value) else None
    # general term: evaluate and compare
    for v, env2 in _eval_term(ctx, mod, pattern, env):
        if _strict_eq(v, value):
            return env2
    return None


def _is_pattern(node: PkgNode, term: A.Term, env: Env) -> bool:
    """True if term contains unbound variables (bindable positions)."""
    if isinstance(term, A.Wildcard):
        return True
    if isinstance(term, A.Var):
        return (
            term.name not in env
            and term.name not in ("input", "data")
            and term.name not in node.rules
        )
    if isinstance(term, A.ArrayTerm):
        return any(_is_pattern(node, t, env) for t in term.items)
    if isinstance(term, A.ObjectTerm):
        return any(_is_pattern(node, v, env) for _, v in term.items)
    return False


def _unify(
    ctx: Context, mod: A.Module, lhs: A.Term, rhs: A.Term, env: Env
) -> Iterator[Env]:
    node = _module_node(ctx, mod)
    lhs_pat = _is_pattern(node, lhs, env)
    rhs_pat = _is_pattern(node, rhs, env)
    if lhs_pat and rhs_pat:
        if isinstance(lhs, A.Wildcard) and isinstance(rhs, A.Wildcard):
            yield env
            return
        raise RegoError("unification with unbound variables on both sides")
    if lhs_pat:
        for v, env2 in _eval_term(ctx, mod, rhs, env):
            env3 = _bind_pattern(ctx, mod, lhs, v, env2)
            if env3 is not None:
                yield env3
        return
    if rhs_pat:
        for v, env2 in _eval_term(ctx, mod, lhs, env):
            env3 = _bind_pattern(ctx, mod, rhs, v, env2)
            if env3 is not None:
                yield env3
        return
    for lv, env2 in _eval_term(ctx, mod, lhs, env):
        for rv, env3 in _eval_term(ctx, mod, rhs, env2):
            if _strict_eq(lv, rv):
                yield env3


# -- term evaluation --------------------------------------------------------


def _eval_terms(
    ctx: Context, mod: A.Module, terms: List[A.Term], env: Env
) -> Iterator[Tuple[List[Any], Env]]:
    if not terms:
        yield [], env
        return
    for v, env2 in _eval_term(ctx, mod, terms[0], env):
        for vs, env3 in _eval_terms(ctx, mod, terms[1:], env2):
            yield [v] + vs, env3


def _eval_term(
    ctx: Context, mod: A.Module, term: A.Term, env: Env
) -> Iterator[Tuple[Any, Env]]:
    if isinstance(term, A.Scalar):
        yield freeze(term.value), env
        return
    if isinstance(term, A.Var):
        yield from _resolve_var(ctx, mod, term.name, env)
        return
    if isinstance(term, A.Wildcard):
        raise RegoError("wildcard in value position")
    if isinstance(term, A.Ref):
        yield from _eval_ref(ctx, mod, term, env)
        return
    if isinstance(term, A.Call):
        yield from _eval_call(ctx, mod, term, env)
        return
    if isinstance(term, A.BinOp):
        yield from _eval_binop(ctx, mod, term, env)
        return
    if isinstance(term, A.UnaryMinus):
        for v, env2 in _eval_term(ctx, mod, term.operand, env):
            if type_name(v) == "number" and not isinstance(v, bool):
                yield -v, env2
        return
    if isinstance(term, A.ArrayTerm):
        for vs, env2 in _eval_terms(ctx, mod, term.items, env):
            yield tuple(vs), env2
        return
    if isinstance(term, A.SetTerm):
        for vs, env2 in _eval_terms(ctx, mod, term.items, env):
            yield frozenset(vs), env2
        return
    if isinstance(term, A.ObjectTerm):
        keys = [k for k, _ in term.items]
        vals = [v for _, v in term.items]
        for kvs, env2 in _eval_terms(ctx, mod, keys, env):
            for vvs, env3 in _eval_terms(ctx, mod, vals, env2):
                yield Obj(dict(zip(kvs, vvs))), env3
        return
    if isinstance(term, A.Comprehension):
        yield _eval_comprehension(ctx, mod, term, env), env
        return
    raise RegoError(f"unsupported term {type(term).__name__}")


def _resolve_var(
    ctx: Context, mod: A.Module, name: str, env: Env
) -> Iterator[Tuple[Any, Env]]:
    if name in env:
        yield env[name], env
        return
    if name == "input":
        if ctx.input is not None:
            yield ctx.input, env
        return
    if name == "data":
        yield DataCursor(ctx.data_root, ctx.interp.pkg_root, ()), env
        return
    node = _module_node(ctx, mod)
    if name in node.rules:
        rules = node.rules[name]
        if rules and rules[0].head.kind == "func":
            raise RegoError(f"function {name} used as value")
        v = _eval_rule(ctx, mod, node, name)
        if v is not Undefined:
            yield v, env
        return
    # imports: `import data.x.y` binds y (or its alias)
    for imp in mod.imports:
        bound = imp.alias or imp.path[-1]
        if bound == name and imp.path and imp.path[0] == "data":
            cur: Any = DataCursor(ctx.data_root, ctx.interp.pkg_root, ())
            ok = True
            for seg in imp.path[1:]:
                cur = _index_value(ctx, cur, seg)
                if cur is Undefined:
                    ok = False
                    break
            if ok:
                yield cur, env
            return
    raise RegoError(f"unsafe variable: {name} (module {mod.package_path})")


def _eval_ref(
    ctx: Context, mod: A.Module, ref: A.Ref, env: Env
) -> Iterator[Tuple[Any, Env]]:
    if isinstance(ref.head, A.Var):
        bases = _resolve_var(ctx, mod, ref.head.name, env)
    else:
        bases = _eval_term(ctx, mod, ref.head, env)
    for base, env1 in bases:
        yield from _walk_ops(ctx, mod, base, ref.ops, 0, env1)


def _walk_ops(
    ctx: Context, mod: A.Module, val: Any, ops: List[A.Term], i: int, env: Env
) -> Iterator[Tuple[Any, Env]]:
    if i == len(ops):
        if isinstance(val, DataCursor):
            val = _materialize_cursor(ctx, val)
            if val is Undefined:
                return
        yield val, env
        return
    op = ops[i]
    node = _module_node(ctx, mod)
    if _is_pattern(node, op, env):
        # unbound operand: enumerate the collection, unifying the pattern
        # against each key (for sets, against each member — this covers
        # `general_violation[{"msg": msg, "field": "containers"}]`-style
        # partial-set lookups in the reference library)
        for k, item in _enumerate_value(ctx, val):
            env2 = _bind_pattern(ctx, mod, op, k, env)
            if env2 is not None:
                yield from _walk_ops(ctx, mod, item, ops, i + 1, env2)
        return
    for k, env1 in _eval_term(ctx, mod, op, env):
        item = _index_value(ctx, val, k)
        if item is not Undefined:
            yield from _walk_ops(ctx, mod, item, ops, i + 1, env1)


def _index_value(ctx: Context, val: Any, key: Any) -> Any:
    if isinstance(val, DataCursor):
        if not isinstance(key, str):
            return (
                _index_raw(val.base, key) if val.base is not Undefined else Undefined
            )
        if val.pkg is not None:
            rules = val.pkg.rules.get(key)
            if rules:
                mod = rules[0]._module  # type: ignore[attr-defined]
                node = ctx.interp._pkg_node(mod.package, create=False)
                return _eval_rule(ctx, mod, node, key)
            child = val.pkg.children.get(key)
            base_child = (
                _index_raw(val.base, key) if val.base is not Undefined else Undefined
            )
            if child is not None:
                return DataCursor(base_child, child, val.path + (key,))
            return base_child
        return _index_raw(val.base, key) if val.base is not Undefined else Undefined
    return _index_raw(val, key)


def _index_raw(val: Any, key: Any) -> Any:
    if val is Undefined:
        return Undefined
    t = type_name(val)
    if t == "object":
        return val[key] if key in val else Undefined
    if t == "array":
        if isinstance(key, bool) or not isinstance(key, (int, float)):
            return Undefined
        idx = int(key)
        if idx != key or idx < 0 or idx >= len(val):
            return Undefined
        return val[idx]
    if t == "set":
        return key if key in val else Undefined
    return Undefined


def _enumerate_value(ctx: Context, val: Any) -> Iterator[Tuple[Any, Any]]:
    if isinstance(val, DataCursor):
        seen = set()
        if val.pkg is not None:
            for name, rules in list(val.pkg.rules.items()):
                mod = rules[0]._module  # type: ignore[attr-defined]
                node = ctx.interp._pkg_node(mod.package, create=False)
                v = _eval_rule(ctx, mod, node, name)
                if v is not Undefined:
                    seen.add(name)
                    yield name, v
            for name, child in val.pkg.children.items():
                base_child = (
                    _index_raw(val.base, name)
                    if val.base is not Undefined
                    else Undefined
                )
                seen.add(name)
                yield name, DataCursor(base_child, child, val.path + (name,))
        if val.base is not Undefined and type_name(val.base) == "object":
            for k in sorted(val.base.keys(), key=sort_key):
                if k not in seen:
                    yield k, val.base[k]
        return
    if val is Undefined:
        return
    t = type_name(val)
    if t == "object":
        for k in sorted(val.keys(), key=sort_key):
            yield k, val[k]
    elif t == "array":
        for idx, item in enumerate(val):
            yield idx, item
    elif t == "set":
        for item in sorted(val, key=sort_key):
            yield item, item
    # scalars: nothing to enumerate -> undefined


def _materialize_cursor(ctx: Context, cur: DataCursor) -> Any:
    out: Dict[Any, Any] = {}
    for k, v in _enumerate_value(ctx, cur):
        if isinstance(v, DataCursor):
            v = _materialize_cursor(ctx, v)
            if v is Undefined:
                continue
        out[k] = v
    if out:
        return Obj(out)
    if cur.base is not Undefined:
        return cur.base
    return Obj({})


def _resolve_fn_node(
    ctx: Context, mod: A.Module, name: str
) -> Tuple[Optional[PkgNode], str]:
    """Resolve a call name to its package node + local rule name.

    Bare names resolve in the calling module; dotted `data.…` names resolve
    through the package tree (cross-package function calls, used by
    ConstraintTemplate libs after rewriting)."""
    node = _module_node(ctx, mod)
    if (
        name in node.rules
        and node.rules[name]
        and node.rules[name][0].head.kind == "func"
    ):
        return node, name
    if name.startswith("data."):
        parts = name.split(".")[1:]
        fn_node = ctx.interp._pkg_node(parts[:-1], create=False)
        local = parts[-1]
        if (
            fn_node is not None
            and local in fn_node.rules
            and fn_node.rules[local]
            and fn_node.rules[local][0].head.kind == "func"
        ):
            return fn_node, local
    return None, name


def _eval_call(
    ctx: Context, mod: A.Module, call: A.Call, env: Env
) -> Iterator[Tuple[Any, Env]]:
    name = call.name
    fn_node, local_name = _resolve_fn_node(ctx, mod, name)
    for args, env2 in _eval_terms(ctx, mod, call.args, env):
        if fn_node is not None:
            v = _call_function(ctx, mod, fn_node, local_name, args)
            if v is not Undefined:
                yield v, env2
            continue
        if name in BUILTINS:
            arity, fn = BUILTINS[name]
            if arity != len(args):
                raise RegoError(
                    f"builtin {name}: want {arity} args, got {len(args)}"
                )
            try:
                v = fn(*args)
            except BuiltinError:
                continue  # undefined
            yield v, env2
            continue
        raise RegoError(f"unknown function {name}")


def _eval_binop(
    ctx: Context, mod: A.Module, term: A.BinOp, env: Env
) -> Iterator[Tuple[Any, Env]]:
    op = term.op
    for lv, env2 in _eval_term(ctx, mod, term.lhs, env):
        for rv, env3 in _eval_term(ctx, mod, term.rhs, env2):
            if op == "==":
                yield _strict_eq(lv, rv), env3
            elif op == "!=":
                yield not _strict_eq(lv, rv), env3
            elif op in ("<", "<=", ">", ">="):
                c = rego_cmp(lv, rv)
                yield {"<": c < 0, "<=": c <= 0, ">": c > 0, ">=": c >= 0}[op], env3
            elif op in ("+", "-", "*", "/", "%", "&", "|"):
                tl, tr = type_name(lv), type_name(rv)
                if tl == "set" and tr == "set":
                    if op == "-":
                        yield lv - rv, env3
                    elif op == "&":
                        yield lv & rv, env3
                    elif op == "|":
                        yield lv | rv, env3
                    # other ops on sets: undefined
                    continue
                if (
                    tl == "number"
                    and tr == "number"
                    and not isinstance(lv, bool)
                    and not isinstance(rv, bool)
                ):
                    if op == "+":
                        yield lv + rv, env3
                    elif op == "-":
                        yield lv - rv, env3
                    elif op == "*":
                        yield lv * rv, env3
                    elif op == "/":
                        if rv == 0:
                            continue  # undefined (division by zero)
                        if isinstance(lv, int) and isinstance(rv, int) and lv % rv == 0:
                            yield lv // rv, env3
                        else:
                            yield lv / rv, env3
                    elif op == "%":
                        if rv == 0 or not (
                            isinstance(lv, int) and isinstance(rv, int)
                        ):
                            continue  # modulo on floats / by zero: undefined
                        yield lv % rv, env3
                # mismatched operand types: undefined
                continue
            else:
                raise RegoError(f"unknown operator {op}")


def _eval_comprehension(
    ctx: Context, mod: A.Module, term: A.Comprehension, env: Env
) -> Any:
    if term.kind == "array":
        items = []
        for env2 in _eval_body(ctx, mod, term.body, env):
            for v, _ in _eval_term(ctx, mod, term.head, env2):
                items.append(v)
        return tuple(items)
    if term.kind == "set":
        items = []
        for env2 in _eval_body(ctx, mod, term.body, env):
            for v, _ in _eval_term(ctx, mod, term.head, env2):
                items.append(v)
        return frozenset(items)
    if term.kind == "object":
        out: Dict[Any, Any] = {}
        for env2 in _eval_body(ctx, mod, term.body, env):
            for k, env3 in _eval_term(ctx, mod, term.key, env2):
                for v, _ in _eval_term(ctx, mod, term.head, env3):
                    if k in out and not _strict_eq(out[k], v):
                        raise RegoError("object comprehension: conflicting keys")
                    out[k] = v
        return Obj(out)
    raise RegoError(f"unknown comprehension kind {term.kind}")
