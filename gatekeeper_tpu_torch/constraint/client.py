# Copied from gatekeeper_tpu/constraint/client.py; only imports and the edits noted in this header differ.
# Edit: review_host's docstring: the port's webhook answers a failed fused
# batch with the fail policy, so review_host is an oracle, not a rung.
"""The constraint-framework Client: engine-agnostic policy orchestration.

Equivalent of vendor/.../frameworks/constraint/pkg/client/client.go:70-838.
Holds the template/constraint registries, owns the template compile
pipeline, and fans Review/Audit/AddData calls out to target handlers and
the Driver. This is the plugin boundary the controllers, webhook, and
audit manager program against.
"""

from __future__ import annotations

import copy
import re
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from ..rego import ast as A
from . import regocompile
from .driver import Driver
from .errors import (
    InvalidConstraintError,
    InvalidTemplateError,
    MissingConstraintError,
    MissingTemplateError,
    UnrecognizedConstraintError,
)
from .templates import (
    CONSTRAINT_GROUP,
    CRD,
    ConstraintTemplate,
    create_crd,
    validate_constraint_against_crd,
)
from .types import Response, Responses

_TARGET_NAME_RE = re.compile(r"^[a-zA-Z][a-zA-Z0-9.]*$")


@dataclass
class _TemplateEntry:
    template: ConstraintTemplate
    crd: CRD
    targets: List[str]


class Backend:
    """Driver container; hands out a single Client (client/backend.go:28-60)."""

    def __init__(self, driver: Driver):
        self.driver = driver
        self._has_client = False

    def new_client(
        self,
        *targets,
        allowed_data_fields: Sequence[str] = ("inventory",),
    ) -> "Client":
        if self._has_client:
            raise RuntimeError("Backend has already instantiated a client")
        self._has_client = True
        return Client(self, list(targets), allowed_data_fields)


class Client:
    def __init__(
        self,
        backend: Backend,
        targets: List[Any],
        allowed_data_fields: Sequence[str] = ("inventory",),
    ):
        if not targets:
            raise ValueError("No targets registered")
        self._backend = backend
        self._driver = backend.driver
        self._lock = threading.RLock()
        self.targets: Dict[str, Any] = {}
        for t in targets:
            name = t.get_name()
            if not name or not _TARGET_NAME_RE.match(name):
                raise ValueError(f"Invalid target name: {name!r}")
            self.targets[name] = t
            # the driver resolves match semantics (oracle, tensor
            # compile, feature encoding, audit listing) through the
            # handler — register each so multi-target engines route
            # per-target instead of assuming K8s (docs/targets.md)
            register = getattr(self._driver, "register_target", None)
            if register is not None:
                register(t)
        self.allowed_data_fields = list(allowed_data_fields)
        # template name -> entry; (group, kind) -> {subpath: constraint}
        self._templates: Dict[str, _TemplateEntry] = {}
        self._constraints: Dict[Tuple[str, str], Dict[str, dict]] = {}
        # externaldata.ExternalDataSystem (set_external_data): the batch
        # plane external_data lookups resolve through
        self.external_data = None
        self._driver.init()

    def set_external_data(self, system) -> None:
        """Wire the external-data system through the whole evaluation
        stack: the client (batch epochs), the driver (prefetch + the
        extdata row-feature screen), and the interpreter builtin's
        process binding."""
        from ..externaldata import set_system

        self.external_data = system
        hook = getattr(self._driver, "set_external_data", None)
        if hook is not None:
            hook(system)
        set_system(system)

    def _extdata_begin(self) -> None:
        if self.external_data is not None:
            self.external_data.begin_batch()

    # -- template pipeline (client.go:240-470) ------------------------------

    def _create_artifacts(
        self, templ: Union[dict, ConstraintTemplate]
    ) -> Tuple[ConstraintTemplate, CRD, str, List[A.Module], str]:
        ct = (
            templ
            if isinstance(templ, ConstraintTemplate)
            else ConstraintTemplate.from_dict(templ)
        )
        ct.validate_names()
        if len(ct.targets) != 1:
            raise InvalidTemplateError(
                f"expected exactly 1 item in targets, got {len(ct.targets)}"
            )
        spec = ct.targets[0]
        handler = self.targets.get(spec.target)
        if handler is None:
            raise InvalidTemplateError(
                f"target {spec.target!r} not recognized (known: "
                f"{sorted(self.targets)})"
            )
        crd = create_crd(ct, handler.match_schema())
        modules = regocompile.compile_template_modules(
            ct.kind, spec.target, spec.rego, spec.libs, self.allowed_data_fields
        )
        prefix = f'templates["{spec.target}"]["{ct.kind}"]'
        return ct, crd, spec.target, modules, prefix

    def create_crd(self, templ: Union[dict, ConstraintTemplate]) -> CRD:
        """Validates the full template (including Rego) and returns its CRD
        (client.go:351-359)."""
        _, crd, _, _, _ = self._create_artifacts(templ)
        return crd

    def add_template(self, templ: Union[dict, ConstraintTemplate]) -> Responses:
        resp = Responses()
        ct, crd, target, modules, prefix = self._create_artifacts(templ)
        # static vectorizability analysis at admission time: INVALID
        # templates (unsafe vars, broken entrypoints) are rejected HERE
        # with their diagnostics instead of surfacing as an evaluation
        # surprise later; every accepted template carries its report
        from ..analysis import analyze_modules

        report = analyze_modules(ct.kind, modules)
        if report.verdict == "INVALID":
            raise InvalidTemplateError(
                "template failed static analysis:\n" + report.render()
            )
        ct.vectorizability = report
        with self._lock:
            cached = self._templates.get(ct.name)
            if cached is not None and _template_equal(cached.template, ct):
                resp.handled[target] = True
                return resp
            if cached is not None and cached.crd.kind != crd.kind:
                # case-variant kind rename (name==lowercase(kind) still
                # holds): the retired kind's modules and constraints must
                # not stay evaluatable
                self._unmount_kind(cached.targets, cached.crd.kind)
                self._constraints.pop((CONSTRAINT_GROUP, cached.crd.kind), None)
                cached = None
            if cached is not None and cached.targets != [target]:
                # re-targeted template update: unmount the old target's
                # modules and constraint data (or they stay evaluatable),
                # then re-home the cached constraints under the new target
                self._unmount_kind(cached.targets, cached.crd.kind)
                for subpath, c in self._constraints.get(
                    (CONSTRAINT_GROUP, cached.crd.kind), {}
                ).items():
                    self._driver.put_data(f"/constraints/{target}/{subpath}", c)
            self._driver.put_modules(prefix, modules)
            # re-attach the admission-time analyzer report: put_modules
            # just dropped the driver's cached analysis for this kind
            # (warm-swap invalidation), and without this hand-back the
            # /readyz verdict and fallback routing provenance stayed
            # blank until the next dispatch lazily re-analyzed
            attach = getattr(self._driver, "attach_report", None)
            if attach is not None:
                attach(target, ct.kind, ct.vectorizability)
            self._templates[ct.name] = _TemplateEntry(
                template=ct, crd=crd, targets=[target]
            )
            gk = (CONSTRAINT_GROUP, ct.kind)
            self._constraints.setdefault(gk, {})
            resp.handled[target] = True
        return resp

    def _unmount_kind(self, targets, kind: str) -> None:
        """Delete a constraint kind's template modules and constraint-data
        subtree from the driver for every given target. Caller holds
        self._lock."""
        for target in targets:
            self._driver.delete_modules(f'templates["{target}"]["{kind}"]')
            self._driver.delete_data(
                f"/constraints/{target}/cluster/{CONSTRAINT_GROUP}/{kind}"
            )

    def remove_template(self, templ: Union[dict, ConstraintTemplate]) -> Responses:
        resp = Responses()
        ct = (
            templ
            if isinstance(templ, ConstraintTemplate)
            else ConstraintTemplate.from_dict(templ)
        )
        with self._lock:
            entry = self._templates.get(ct.name)
            if entry is None:
                return resp
            target = entry.targets[0]
            self._unmount_kind(entry.targets, entry.crd.kind)
            # the subtree delete covers every constraint of this kind
            self._constraints.pop((CONSTRAINT_GROUP, entry.crd.kind), None)
            del self._templates[ct.name]
            resp.handled[target] = True
        return resp

    def get_template(self, name_or_templ) -> ConstraintTemplate:
        name = (
            name_or_templ
            if isinstance(name_or_templ, str)
            else (
                name_or_templ.name
                if isinstance(name_or_templ, ConstraintTemplate)
                else ConstraintTemplate.from_dict(name_or_templ).name
            )
        )
        with self._lock:
            entry = self._templates.get(name)
            if entry is None:
                raise MissingTemplateError(name)
            return entry.template

    # -- constraints (client.go:473-670) ------------------------------------

    def _get_template_entry(self, constraint: dict) -> _TemplateEntry:
        kind = constraint.get("kind")
        if not kind:
            raise UnrecognizedConstraintError(
                f"Constraint {_cstr_name(constraint)} has no kind"
            )
        group = constraint.get("apiVersion", "").partition("/")[0]
        if group != CONSTRAINT_GROUP:
            raise UnrecognizedConstraintError(
                f"Constraint {_cstr_name(constraint)} has the wrong group: "
                f"{group!r}"
            )
        entry = self._templates.get(kind.lower())
        if entry is None or entry.crd.kind != kind:
            raise UnrecognizedConstraintError(kind)
        return entry

    def add_constraint(self, constraint: dict) -> Responses:
        resp = Responses()
        with self._lock:
            entry = self._get_template_entry(constraint)
            subpath = _constraint_subpath(constraint)
            gk = (CONSTRAINT_GROUP, constraint["kind"])
            cached = self._constraints.get(gk, {}).get(subpath)
            if cached is not None and _constraint_equal(cached, constraint):
                for t in entry.targets:
                    resp.handled[t] = True
                return resp
            self._validate_constraint_locked(constraint, entry)
            for t in entry.targets:
                self._driver.put_data(
                    f"/constraints/{t}/{subpath}", constraint
                )
                resp.handled[t] = True
            self._constraints.setdefault(gk, {})[subpath] = copy.deepcopy(
                constraint
            )
        return resp

    def remove_constraint(self, constraint: dict) -> Responses:
        with self._lock:
            return self._remove_constraint_locked(constraint)

    def _remove_constraint_locked(self, constraint: dict) -> Responses:
        resp = Responses()
        entry = self._get_template_entry(constraint)
        subpath = _constraint_subpath(constraint)
        for t in entry.targets:
            self._driver.delete_data(f"/constraints/{t}/{subpath}")
            resp.handled[t] = True
        gk = (CONSTRAINT_GROUP, constraint["kind"])
        self._constraints.get(gk, {}).pop(subpath, None)
        return resp

    def get_constraint(self, constraint: dict) -> dict:
        with self._lock:
            subpath = _constraint_subpath(constraint)
            gk = (CONSTRAINT_GROUP, constraint.get("kind", ""))
            cached = self._constraints.get(gk, {}).get(subpath)
            if cached is None:
                raise MissingConstraintError(subpath)
            return copy.deepcopy(cached)

    def _validate_constraint_locked(
        self, constraint: dict, entry: _TemplateEntry
    ) -> None:
        validate_constraint_against_crd(constraint, entry.crd)
        for t in entry.targets:
            self.targets[t].validate_constraint(constraint)

    def validate_constraint(self, constraint: dict) -> None:
        with self._lock:
            entry = self._get_template_entry(constraint)
            self._validate_constraint_locked(constraint, entry)

    # -- data (client.go:91-140) --------------------------------------------

    def add_data(self, data: Any) -> Responses:
        resp = Responses()
        for name, handler in self.targets.items():
            handled, path, processed = handler.process_data(data)
            if not handled:
                continue
            self._driver.put_data(f"/external/{name}/{path}", processed)
            resp.handled[name] = True
        return resp

    def remove_data(self, data: Any) -> Responses:
        resp = Responses()
        for name, handler in self.targets.items():
            handled, path, _ = handler.process_data(data)
            if not handled:
                continue
            self._driver.delete_data(f"/external/{name}/{path}")
            resp.handled[name] = True
        return resp

    # -- review / audit (client.go:764-836) ---------------------------------

    def review(self, obj: Any, tracing: bool = False) -> Responses:
        self._extdata_begin()
        responses = Responses()
        for name, handler in self.targets.items():
            handled, review = handler.handle_review(obj)
            if not handled:
                continue
            resp = self._driver.query(
                f'hooks["{name}"].violation', {"review": review}, tracing
            )
            for r in resp.results:
                handler.handle_violation(r)
            resp.target = name
            responses.by_target[name] = resp
        return responses

    def review_many(
        self, objs: Sequence[Any], tracing: bool = False
    ) -> List[Responses]:
        """Batched review: one driver dispatch for the whole batch (the
        micro-batching webhook's entry point; the reference client has no
        equivalent — its webhook evaluates one request per goroutine,
        pkg/webhook/policy.go:141)."""
        self._extdata_begin()
        out: List[Responses] = [Responses() for _ in objs]
        for name, handler in self.targets.items():
            idxs: List[int] = []
            inputs: List[Any] = []
            for i, obj in enumerate(objs):
                handled, review = handler.handle_review(obj)
                if not handled:
                    continue
                idxs.append(i)
                inputs.append({"review": review})
            if not inputs:
                continue
            if self.external_data is not None:
                # batch plane: one deduped prefetch per target BEFORE
                # dispatch, whichever engine (and whichever rung) will
                # evaluate — repeat keys across the batch then answer
                # from the response cache
                self._prefetch_external_for(
                    [i["review"] for i in inputs]
                )
            resps = self._driver.query_many(
                f'hooks["{name}"].violation', inputs, tracing
            )
            for i, resp in zip(idxs, resps):
                for r in resp.results:
                    handler.handle_violation(r)
                resp.target = name
                out[i].by_target[name] = resp
        return out

    def review_many_subset(
        self, objs: Sequence[Any], subset, device: int = 0,
        partition=None,
    ) -> List[Responses]:
        """Partition-scoped batched review (docs/robustness.md §Fault
        domains): one driver dispatch evaluating ONLY `subset`'s
        constraints (keys per `driver.constraint_key`), attributed to
        logical `device`. The partitioned MicroBatcher fans a batch out
        over a PartitionPlan's subsets and merges the per-partition
        results back into the monolithic order. `partition` labels the
        cost-attribution rows (defaults to the device id)."""
        out: List[Responses] = [Responses() for _ in objs]
        for name, handler in self.targets.items():
            idxs: List[int] = []
            inputs: List[Any] = []
            for i, obj in enumerate(objs):
                handled, review = handler.handle_review(obj)
                if not handled:
                    continue
                idxs.append(i)
                inputs.append({"review": review})
            if not inputs:
                continue
            resps = self._driver.query_many_subset(
                f'hooks["{name}"].violation', inputs, subset,
                device=device, partition=partition,
            )
            for i, resp in zip(idxs, resps):
                for r in resp.results:
                    handler.handle_violation(r)
                resp.target = name
                out[i].by_target[name] = resp
        return out

    def partition_match_mask(
        self, objs: Sequence[Any], subsets: Sequence[Any]
    ) -> List[List[bool]]:
        """Per-(partition, request) match screen: True iff the request
        could produce any result from that subset's constraints. The
        partitioned batcher skips partitions nothing in the batch
        touches and scopes the degraded host rung to affected requests
        only (the blast-radius contract)."""
        masks = [[False] * len(objs) for _ in subsets]
        for name, handler in self.targets.items():
            idxs: List[int] = []
            inputs: List[Any] = []
            for i, obj in enumerate(objs):
                handled, review = handler.handle_review(obj)
                if not handled:
                    continue
                idxs.append(i)
                inputs.append({"review": review})
            if not inputs:
                continue
            target_masks = self._driver.partition_match_mask(
                f'hooks["{name}"].violation', inputs, subsets
            )
            for p, tmask in enumerate(target_masks):
                for j, i in enumerate(idxs):
                    masks[p][i] = masks[p][i] or tmask[j]
        return masks

    def prepare_subset(self, subset, device: int = 0) -> bool:
        """Stage one partition's sub-program for every target (the
        quarantine re-home restage step; FaultError from the
        device-labeled restage point propagates so the dispatcher can
        back off)."""
        prep = getattr(self._driver, "prepare_subset", None)
        if prep is None:
            return True
        ok = True
        for name in self.targets:
            # False = lost a race with newer churn (not a failure); the
            # dispatcher leaves the token unstaged and retries
            if prep(f'hooks["{name}"].violation', subset, device=device) is False:
                ok = False
        return ok

    def prefetch_external(self, objs: Sequence[Any]) -> None:
        """Batch-plane external-data prefetch for a review batch that
        will evaluate per-request (the host-interpreter rung): opens a
        fetch epoch and dedupes/fetches the batch's keys once per
        provider, so the per-request evaluations that follow serve from
        the response cache. Best-effort; no-op without a wired
        system."""
        if self.external_data is None:
            return
        self.external_data.begin_batch()
        for name, handler in self.targets.items():
            reviews = []
            for obj in objs:
                handled, review = handler.handle_review(obj)
                if handled:
                    reviews.append(review)
            if reviews:
                self._prefetch_external_for(reviews)

    def _prefetch_external_for(self, reviews: Sequence[Any]) -> None:
        """Engine-agnostic batch prefetch: extract + dedupe the batch's
        external-data keys from the ingested templates' recorded call
        sites, then at most one outbound fetch per provider. Works for
        any driver exposing the interpreter (the TPU driver ALSO
        prefetches on its own dispatch path — idempotent, the second
        pass finds no misses)."""
        system = self.external_data
        interp = getattr(self._driver, "interp", None)
        if system is None or interp is None:
            return
        try:
            from ..externaldata.extract import batch_wants

            with self._lock:
                entries = list(self._templates.values())
            wants_total: Dict[str, set] = {}
            # extraction evaluates against the driver-mounted modules:
            # hold the driver's mutation mutex (reads race module churn
            # otherwise), but NEVER during the outbound fetch below
            mutex = self._driver._mutex if hasattr(
                self._driver, "_mutex"
            ) else threading.RLock()
            with mutex:
                for e in entries:
                    rep = getattr(e.template, "vectorizability", None)
                    calls = getattr(rep, "external_calls", None)
                    if not calls:
                        continue
                    w = batch_wants(interp, calls, reviews)
                    if w:
                        for p, ks in w.items():
                            wants_total.setdefault(p, set()).update(ks)
            if wants_total:
                system.prefetch(wants_total)
        except Exception:
            pass

    def review_host(self, obj: Any, subset=None) -> Responses:
        """Host-interpreter review: same results as `review` by the
        driver-parity contract, but pinned to the host interpreter —
        the oracle a fused answer is checked against. `subset` scopes
        the evaluation to some constraints (keys as `constraint_key`)."""
        responses = Responses()
        for name, handler in self.targets.items():
            handled, review = handler.handle_review(obj)
            if not handled:
                continue
            resp = self._driver.query_host(
                f'hooks["{name}"].violation', {"review": review},
                subset=subset,
            )
            for r in resp.results:
                handler.handle_violation(r)
            resp.target = name
            responses.by_target[name] = resp
        return responses

    def warm_review_path(self, objs: Sequence[Any]) -> bool:
        """Synchronously compile the driver's fused review path for
        `objs`' batch shapes (serve-while-compiling, VERDICT r4 #4) —
        the review_many conversion without the evaluation. Drivers with
        no compile step (the interpreter) are trivially warm."""
        warm = getattr(self._driver, "warm_review_path", None)
        if warm is None:
            return True
        ok = True
        for name, handler in self.targets.items():
            reviews = []
            for obj in objs:
                handled, review = handler.handle_review(obj)
                if handled:
                    reviews.append(review)
            if reviews:
                ok = warm(name, reviews) and ok
        return ok

    def audit(self, tracing: bool = False) -> Responses:
        self._extdata_begin()
        responses = Responses()
        for name, handler in self.targets.items():
            resp = self._driver.query(f'hooks["{name}"].audit', None, tracing)
            for r in resp.results:
                handler.handle_violation(r)
            resp.target = name
            responses.by_target[name] = resp
        return responses

    # -- maintenance (client.go:725-748, 837) -------------------------------

    def reset(self) -> None:
        with self._lock:
            for name in self.targets:
                self._driver.delete_data(f"/external/{name}")
                self._driver.delete_data(f"/constraints/{name}")
            for name, entry in self._templates.items():
                for t in entry.targets:
                    self._driver.delete_modules(
                        f'templates["{t}"]["{entry.crd.kind}"]'
                    )
            self._templates = {}
            self._constraints = {}

    def dump(self) -> str:
        return self._driver.dump()

    # -- introspection -------------------------------------------------------

    def known_templates(self) -> List[str]:
        with self._lock:
            return sorted(self._templates)

    def template_report(self, name_or_kind: str):
        """Vectorizability report for an ingested template (by template
        name or constraint kind); None when unknown."""
        with self._lock:
            entry = self._templates.get(name_or_kind) or self._templates.get(
                name_or_kind.lower()
            )
            if entry is None:
                return None
            return entry.template.vectorizability

    def template_reports(self) -> Dict[str, Any]:
        """{template name -> VectorizabilityReport} for every ingested
        template (webhook/status introspection surface)."""
        with self._lock:
            return {
                name: e.template.vectorizability
                for name, e in self._templates.items()
            }

    def known_constraint_kinds(self) -> List[str]:
        with self._lock:
            return sorted(e.crd.kind for e in self._templates.values())


def _cstr_name(constraint: dict) -> str:
    return ((constraint.get("metadata") or {}).get("name")) or "?"


def _constraint_subpath(constraint: dict) -> str:
    """createConstraintSubPath (client.go:473-486):
    cluster/<group>/<kind>/<name>."""
    name = _cstr_name(constraint)
    if name == "?":
        raise InvalidConstraintError("Constraint has no name")
    group = constraint.get("apiVersion", "").partition("/")[0]
    kind = constraint.get("kind")
    if not group:
        raise InvalidConstraintError(
            f"Empty group for the constraint named {name}"
        )
    if not kind:
        raise InvalidConstraintError(
            f"Empty kind for the constraint named {name}"
        )
    return f"cluster/{group}/{kind}/{name}"


def _strip_status(obj: dict) -> dict:
    out = copy.deepcopy(obj)
    out.pop("status", None)
    return out


def _template_equal(a: ConstraintTemplate, b: ConstraintTemplate) -> bool:
    """SemanticEqual (templates): spec comparison, status ignored.

    Raw specs are compared when both templates carry them; directly
    constructed ConstraintTemplate objects (empty raw) fall back to their
    substantive fields so updates are never silently dropped.
    """
    spec_a = _strip_status(a.raw).get("spec")
    spec_b = _strip_status(b.raw).get("spec")
    if spec_a is not None and spec_b is not None:
        return spec_a == spec_b
    return (
        a.kind == b.kind
        and a.parameters_schema == b.parameters_schema
        and [(t.target, t.rego, tuple(t.libs)) for t in a.targets]
        == [(t.target, t.rego, tuple(t.libs)) for t in b.targets]
    )


def _constraint_equal(a: dict, b: dict) -> bool:
    """constraints.SemanticEqual: spec + enforcement comparison, status
    ignored."""
    sa, sb = _strip_status(a), _strip_status(b)
    return sa.get("spec") == sb.get("spec") and sa.get("metadata", {}).get(
        "deletionTimestamp"
    ) == sb.get("metadata", {}).get("deletionTimestamp")
