# Copied from gatekeeper_tpu/constraint/driver.py; only imports and the edits noted in this header differ.
# Edit: Driver.query_many_subset takes the `partition` keyword that
# Client.review_many_subset passes (the source's signature lacks it).
# Edit: RegoDriver._violation takes an `inventory` to evaluate against in
# place of the frozen one (TorchDriver's golden canaries pass an empty one
# for a policy that reads no inventory).
"""Evaluation engine drivers.

`Driver` is the engine plugin boundary — the same seven-method surface as
the reference's drivers.Driver interface
(vendor/.../frameworks/constraint/pkg/client/drivers/interface.go:21-39):
init / put_module(s) / delete_module(s) / put_data / delete_data / query /
dump. Everything above (Client, controllers, webhook, audit) is engine-
agnostic; swapping `RegoDriver` for the TPU driver changes nothing upstream.

`RegoDriver` is the CPU engine (reference counterpart:
drivers/local/local.go). Differences by design, not omission:
  * The constraint-matching + hook glue the reference evaluates as
    interpreted Rego (client/regolib/src.go, pkg/target's library) runs
    natively here via constraint.match — the interpreter only evaluates
    ConstraintTemplate `violation` rules.
  * Modules arrive as parsed, package-rewritten ASTs rather than source
    strings (the Client owns the compile pipeline), so there is no
    whole-universe recompile on template change (local.go:168-207's hot
    spot); module sets are mounted/unmounted incrementally.

Queries understood: `hooks["<target>"].violation` (admission Review path,
client/regolib/src.go:23-42) and `hooks["<target>"].audit` (cached-state
cross-join, :45-62).
"""

from __future__ import annotations

import json
import re
import threading
import time
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..rego import ast as A
from ..rego.interp import Interpreter
from . import hooks as H
from .handler import TargetHandler, default_handler
from .datastore import DataStore
from .templates import CONSTRAINT_GROUP
from .types import Response, Result

_HOOK_RE = re.compile(r'^hooks\["([^"]+)"\]\.(violation|audit)$')

# the autoreject message is also the marker the partition merge uses to
# keep autoreject results ahead of evaluation results (parallel/
# partition.py mirrors the monolithic emit order exactly)
AUTOREJECT_MSG = "Namespace is not cached in OPA."


def constraint_key(constraint: Dict[str, Any]) -> str:
    """The stable identity of a constraint — `<kind>/<name>` — used by
    the partition plane to address constraint subsets. `_constraints`'
    (kind, name) sort order makes the sorted key list the global result
    order partitioned dispatch merges back into."""
    meta = constraint.get("metadata") or {}
    return f"{constraint.get('kind', '?')}/{meta.get('name', '?')}"


def _match_token(handler: TargetHandler, constraint: Dict[str, Any]) -> str:
    """Canonical signature of a constraint's match block. Two constraints
    with equal tokens match exactly the same reviews (matches_constraint
    is a pure function of the match IR), so the token is both the
    partition planner's locality group and the mask screen's dedup key."""
    try:
        return json.dumps(
            handler.match_ir(constraint), sort_keys=True, default=str
        )
    except Exception:
        return f"!opaque:{constraint_key(constraint)}"


def _autoreject_result(constraint: Dict[str, Any], review: Any) -> Result:
    """The autoreject Result shape (client/regolib/src.go:7-21) — the ONE
    definition shared by every evaluation path (serial interpreter,
    adaptive small-batch, fused device batch): driver parity demands the
    shape can never diverge between routes."""
    return Result(
        msg=AUTOREJECT_MSG,
        metadata={"details": {}},
        constraint=constraint,
        review=review,
        enforcement_action=H.enforcement_action(constraint),
    )


class Driver(ABC):
    """Engine plugin interface (drivers/interface.go:21-39)."""

    @abstractmethod
    def init(self) -> None: ...

    @abstractmethod
    def put_module(self, name: str, module: A.Module) -> None: ...

    @abstractmethod
    def put_modules(self, prefix: str, modules: Sequence[A.Module]) -> None: ...

    @abstractmethod
    def delete_module(self, name: str) -> bool: ...

    @abstractmethod
    def delete_modules(self, prefix: str) -> int: ...

    @abstractmethod
    def put_data(self, path: str, data: Any) -> None: ...

    @abstractmethod
    def delete_data(self, path: str) -> bool: ...

    @abstractmethod
    def query(
        self, path: str, input: Any = None, tracing: bool = False
    ) -> Response: ...

    def query_many(
        self, path: str, inputs: Sequence[Any], tracing: bool = False
    ) -> List[Response]:
        """Batched query: engines without a batch path evaluate serially;
        the TPU driver overrides this with one fused dispatch (the
        micro-batching webhook's entry point)."""
        return [self.query(path, i, tracing) for i in inputs]

    def query_host(
        self, path: str, input: Any = None, subset=None
    ) -> Response:
        """Host-only query: the degraded rung of the admission ladder
        (docs/robustness.md). Engines whose `query` already runs on the
        host inherit this; the TPU driver overrides it to pin the
        evaluation to the interpreter so a faulted device is never paid
        a second doomed attempt. `subset` (constraint keys, see
        `constraint_key`) scopes the evaluation to one partition's
        constraints — the fault-domain degraded rung evaluates ONLY the
        failed partition's subset on the host."""
        return self.query(path, input)

    def query_many_subset(
        self, path: str, inputs: Sequence[Any], subset, device: int = 0,
        partition=None,
    ) -> List[Response]:
        """Partition-scoped batched query (docs/robustness.md §Fault
        domains): evaluate only `subset`'s constraints for every input.
        Engines without a device path evaluate the subset serially on
        the host; the TPU driver overrides with a fused sub-program
        dispatch placed on logical `device`."""
        return [self.query_host(path, i, subset=subset) for i in inputs]

    @abstractmethod
    def dump(self) -> str: ...


def _module_prefix(prefix: str, idx: int) -> str:
    return f"{prefix}_idx_{idx}"


class RegoDriver(Driver):
    """CPU reference engine: interpreter-evaluated templates + native hooks."""

    def __init__(self):
        self.storage = DataStore()
        self.interp = Interpreter()
        self._module_names: Dict[str, List[str]] = {}  # prefix -> names
        # serializes module/data mutation against queries — the coarse
        # equivalent of the reference driver's modulesMux RWMutex
        # (drivers/local/local.go:63)
        self._mutex = threading.RLock()
        # frozen-inventory cache: freezing the external tree is O(corpus)
        # and would otherwise happen once per evaluated violation
        self._data_version = 0
        self._frozen_inv: Dict[str, Tuple[int, Any]] = {}
        # target name -> TargetHandler: the Client registers its
        # handlers here so the engine resolves match semantics through
        # the target boundary; unregistered names lazily resolve to the
        # K8s default (every pre-multi-target call site assumed it)
        self._target_handlers: Dict[str, TargetHandler] = {}

    def register_target(self, handler: TargetHandler) -> None:
        with self._mutex:
            self._target_handlers[handler.get_name()] = handler

    def _handler(self, target: str) -> TargetHandler:
        h = self._target_handlers.get(target)
        if h is None:
            h = self._target_handlers[target] = default_handler()
        return h

    def init(self) -> None:
        """No hook-library installation needed — hooks are native."""

    # -- module management --------------------------------------------------

    def put_module(self, name: str, module: A.Module) -> None:
        with self._mutex:
            self.interp.add_module(name, module)
            self._module_names.setdefault(name, [name])

    def put_modules(self, prefix: str, modules: Sequence[A.Module]) -> None:
        with self._mutex:
            self._delete_modules_locked(prefix)
            names = []
            for i, mod in enumerate(modules):
                name = _module_prefix(prefix, i)
                self.interp.add_module(name, mod)
                names.append(name)
            self._module_names[prefix] = names

    def delete_module(self, name: str) -> bool:
        with self._mutex:
            names = self._module_names.pop(name, None)
            if not names:
                return False
            for n in names:
                self.interp.remove_module(n)
            return True

    def delete_modules(self, prefix: str) -> int:
        with self._mutex:
            return self._delete_modules_locked(prefix)

    def _delete_modules_locked(self, prefix: str) -> int:
        names = self._module_names.pop(prefix, None)
        if not names:
            return 0
        for n in names:
            self.interp.remove_module(n)
        return len(names)

    # -- data management ----------------------------------------------------

    def put_data(self, path: str, data: Any) -> None:
        with self._mutex:
            self.storage.put(path, data)
            self._data_version += 1

    def delete_data(self, path: str) -> bool:
        with self._mutex:
            existed = self.storage.delete(path)
            self._data_version += 1
            return existed

    # -- query ---------------------------------------------------------------

    def query(
        self, path: str, input: Any = None, tracing: bool = False
    ) -> Response:
        m = _HOOK_RE.match(path)
        if not m:
            raise ValueError(f"unsupported query path: {path!r}")
        target, hook = m.group(1), m.group(2)
        trace_lines: Optional[List[str]] = [] if tracing else None
        t0 = time.perf_counter()
        with self._mutex:
            if hook == "violation":
                results = self._violation(target, input or {}, trace_lines)
            else:
                results = self._audit(target, trace_lines)
        resp = Response(target=target, results=results)
        if tracing:
            elapsed_ms = (time.perf_counter() - t0) * 1e3
            trace_lines.append(f"eval done: {len(results)} results in {elapsed_ms:.2f}ms")
            resp.trace = "\n".join(trace_lines)
            resp.input = json.dumps(input, default=str, sort_keys=True)
        return resp

    # -- hook implementations ------------------------------------------------

    def _constraints(self, target: str) -> List[Dict[str, Any]]:
        """All constraints, ordered (kind, name) — matching OPA's sorted-set
        iteration over data.constraints.<target>.cluster[group][kind][name]."""
        tree = self.storage.get(
            ["constraints", target, "cluster", CONSTRAINT_GROUP], {}
        )
        out: List[Dict[str, Any]] = []
        if not isinstance(tree, dict):
            return out
        for kind in sorted(tree):
            by_name = tree[kind]
            if not isinstance(by_name, dict):
                continue
            for name in sorted(by_name):
                c = by_name[name]
                if isinstance(c, dict):
                    out.append(c)
        return out

    def constraint_keys(self, target: str) -> List[str]:
        """Sorted `<kind>/<name>` identities of every constraint — the
        global order partitioned dispatch merges back into, and the
        corpus a PartitionPlan splits (parallel/partition.py)."""
        with self._mutex:
            return [constraint_key(c) for c in self._constraints(target)]

    def constraint_generation(self) -> int:
        """Monotonic constraint-churn signal: the partition plane
        rebuilds its plan when this moves. The base driver bumps its
        data version on every write (over-eager but sound); the TPU
        driver narrows it to actual constraint/template churn."""
        return self._data_version

    def constraint_locality(self, target: str) -> Dict[str, str]:
        """Match-locality token per constraint key. Constraints sharing
        a token are satisfied by exactly the same reviews, so the
        partition planner (parallel/partition.py build_plan) co-locates
        them: a batch whose reviews hit one locality group then touches
        one partition instead of all K."""
        with self._mutex:
            handler = self._handler(target)
            return {
                constraint_key(c): _match_token(handler, c)
                for c in self._constraints(target)
            }

    def constraint_costs(self, target: str) -> Dict[str, float]:
        """Relative per-constraint evaluation weight for the partition
        planner's load balancing. The interpreter has no compiled
        programs to size, so every constraint weighs the same; the TPU
        driver overrides this with the compiled program's static cost."""
        with self._mutex:
            return {
                constraint_key(c): 1.0 for c in self._constraints(target)
            }

    def _ns_cache(self, target: str) -> Dict[str, Any]:
        """The target's review-context cache (K8s: synced Namespaces);
        resolution is the handler's, the storage accessor ours."""
        return self._handler(target).review_context_cache(self.storage.get)

    def _inventory(self, target: str) -> Any:
        """inventory rule (client/regolib/src.go:66-71), pre-frozen and
        cached per data version (interp.make_context re-freezes in O(1)
        via the values.freeze Obj fast path)."""
        cached = self._frozen_inv.get(target)
        if cached is not None and cached[0] == self._data_version:
            return cached[1]
        from ..rego.values import freeze

        inv = self.storage.get(["external", target], None)
        frozen = freeze(inv if inv is not None else {})
        self._frozen_inv[target] = (self._data_version, frozen)
        return frozen

    def query_host(
        self, path: str, input: Any = None, subset=None
    ) -> Response:
        """Interpreter evaluation (this engine's query IS host-side),
        optionally scoped to a constraint subset (the fault-domain
        degraded rung: only the failed partition's constraints are
        re-evaluated on the host, docs/robustness.md §Fault domains)."""
        if subset is None:
            return self.query(path, input)
        m = _HOOK_RE.match(path)
        if m is None or m.group(2) != "violation":
            raise ValueError(f"unsupported subset query path: {path!r}")
        target = m.group(1)
        sub = frozenset(subset)
        with self._mutex:
            constraints = [
                c for c in self._constraints(target)
                if constraint_key(c) in sub
            ]
            results = RegoDriver._violation(
                self, target, input or {}, None, constraints=constraints
            )
        return Response(target=target, results=results)

    def partition_match_mask(
        self, path: str, inputs: Sequence[Any], subsets: Sequence[Any]
    ) -> List[List[bool]]:
        """Per-(partition, input) match screen: mask[p][i] is True iff
        input i could produce ANY result from subset p's constraints —
        a real match, or an autoreject against a needs-context
        constraint in the subset. The partitioned batcher uses it to
        skip partitions no request in the batch touches (a faulted
        partition whose constraints match nothing in the batch costs
        the batch NOTHING — the blast-radius contract) and to scope the
        degraded host rung to affected requests only."""
        m = _HOOK_RE.match(path)
        if m is None or m.group(2) != "violation":
            raise ValueError(f"unsupported mask query path: {path!r}")
        target = m.group(1)
        with self._mutex:
            handler = self._handler(target)
            constraints = self._constraints(target)
            ns_cache = self._ns_cache(target)
            # dedupe by match-block signature: a corpus stamped from a
            # few templates shares match blocks across hundreds of
            # constraints, so the screen costs O(distinct-blocks x batch)
            # instead of O(constraints x batch)
            key_toks: Dict[str, set] = {}
            rep: Dict[str, Dict[str, Any]] = {}
            for c in constraints:
                tok = _match_token(handler, c)
                key_toks.setdefault(constraint_key(c), set()).add(tok)
                rep.setdefault(tok, c)
            reviews = [
                H.hook_get_default(i or {}, "review", {}) for i in inputs
            ]
            autorej = [
                bool(constraints)
                and handler.review_autorejects(r, ns_cache)
                for r in reviews
            ]
            tok_hits = {
                tok: [
                    handler.matches_constraint(c, r, ns_cache)
                    for r in reviews
                ]
                for tok, c in rep.items()
            }
            tok_needs = {
                tok: handler.constraint_needs_context(c)
                for tok, c in rep.items()
            }
            masks: List[List[bool]] = []
            for subset in subsets:
                toks = {
                    t for k in subset for t in key_toks.get(k, ())
                }
                needs_ctx = any(tok_needs[t] for t in toks)
                hits = [tok_hits[t] for t in toks]
                masks.append([
                    (ar and needs_ctx) or any(h[i] for h in hits)
                    for i, ar in enumerate(autorej)
                ])
            return masks

    def _violation(
        self, target: str, input: Dict[str, Any],
        trace: Optional[List[str]],
        constraints: Optional[List[Dict[str, Any]]] = None,
        inventory: Any = None,
    ) -> List[Result]:
        review = H.hook_get_default(input, "review", {})
        handler = self._handler(target)
        if constraints is None:
            constraints = self._constraints(target)
        ns_cache = self._ns_cache(target)
        if inventory is None:
            inventory = self._inventory(target)
        results: List[Result] = []
        # autoreject factors (match.needs_ns_selector docstring): the
        # constraint half is handler.constraint_needs_context, the
        # review half handler.review_autorejects
        if constraints and handler.review_autorejects(review, ns_cache):
            for constraint in constraints:
                if handler.constraint_needs_context(constraint):
                    results.append(_autoreject_result(constraint, review))
                    if trace is not None:
                        trace.append(f"autoreject: {_cname(constraint)}")
        for constraint in constraints:
            if not handler.matches_constraint(constraint, review, ns_cache):
                if trace is not None:
                    trace.append(f"no match: {_cname(constraint)}")
                continue
            results.extend(
                self._eval_template(
                    target, constraint, review, inventory, trace
                )
            )
        return results

    def _audit(self, target: str, trace: Optional[List[str]]) -> List[Result]:
        handler = self._handler(target)
        constraints = self._constraints(target)
        if not constraints:
            return []
        ns_cache = self._ns_cache(target)
        inventory = self._inventory(target)
        external = self.storage.get(["external", target], {})
        results: List[Result] = []
        for review in handler.iter_cached_reviews(external):
            for constraint in constraints:
                if not handler.matches_constraint(
                    constraint, review, ns_cache
                ):
                    continue
                results.extend(
                    self._eval_template(
                        target, constraint, review, inventory, trace
                    )
                )
        return results

    def _eval_template(
        self,
        target: str,
        constraint: Dict[str, Any],
        review: Any,
        inventory: Any,
        trace: Optional[List[str]],
        frozen_review: Any = None,
    ) -> List[Result]:
        """`frozen_review`: callers rendering MANY constraints against
        one review pre-freeze it once (values.freeze re-freezes frozen
        Objs in O(1)); freeze was ~30% of per-pair render time."""
        kind = constraint.get("kind")
        if not isinstance(kind, str):
            return []
        input_doc = {
            "review": review if frozen_review is None else frozen_review,
            "parameters": H.constraint_parameters(constraint),
        }
        violations = self.interp.query_violations(
            ["templates", target, kind], input_doc, {"inventory": inventory}
        )
        enforcement = H.enforcement_action(constraint)
        out: List[Result] = []
        for v in violations:
            if not isinstance(v, dict) or "msg" not in v:
                # the hook rule body references r.msg; violations without a
                # msg field are undefined there and silently dropped
                continue
            out.append(
                Result(
                    msg=v["msg"],
                    metadata={"details": H.hook_get_default(v, "details", {})},
                    constraint=constraint,
                    review=review,
                    enforcement_action=enforcement,
                )
            )
        if trace is not None:
            trace.append(f"eval {_cname(constraint)}: {len(out)} violation(s)")
        return out

    # -- dump ----------------------------------------------------------------

    def dump(self) -> str:
        return json.dumps(
            {
                "data": json.loads(self.storage.dump_json()),
                "modules": sorted(
                    n for names in self._module_names.values() for n in names
                ),
            },
            indent=2,
            sort_keys=True,
            default=str,
        )


def _cname(constraint: Dict[str, Any]) -> str:
    meta = constraint.get("metadata") or {}
    return f"{constraint.get('kind', '?')}/{meta.get('name', '?')}"
