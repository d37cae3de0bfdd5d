# Copied from gatekeeper_tpu/mutation/mutators.py; unchanged.
"""The three mutator kinds and their application semantics.

Models Gatekeeper's mutation CRDs (mutations.gatekeeper.sh):

  * `Assign` — set a value at a location outside `metadata`; honors
    `spec.applyTo` GVK filters, `spec.match` (the SAME match schema as
    constraints — screened by the vectorized match kernel),
    `spec.parameters.pathTests` (MustExist / MustNotExist guards), and
    `spec.parameters.assignIf` (`in` / `notIn` tests on the current
    value).
  * `AssignMetadata` — set `metadata.labels.<key>` or
    `metadata.annotations.<key>`, NEVER overwriting an existing value
    (the reference's add-if-absent semantics make it trivially
    idempotent).
  * `ModifySet` — merge or prune scalar members of a list at the
    location; merge appends missing values in declaration order, prune
    removes matching members.

Application is side-effect free: `apply(obj, review)` returns
(new_obj, changed) and never mutates its input — the fixpoint engine in
`system.py` depends on that to detect convergence.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .path import Node, ObjectNode, PathError, parse_path

MUTATION_GROUP = "mutations.gatekeeper.sh"
MUTATOR_KINDS = ("Assign", "AssignMetadata", "ModifySet")

# fields under metadata that AssignMetadata may target
_METADATA_MAPS = ("labels", "annotations")


class MutatorError(ValueError):
    """Invalid mutator spec (ingestion-time rejection)."""


class MutationApplyError(RuntimeError):
    """A mutator hit an incompatibly-typed node while applying — the
    object is left unmodified and the request must NOT be admitted
    half-mutated."""


class ConvergenceError(RuntimeError):
    """The mutator set failed to reach a fixpoint within the iteration
    cap; the object is never admitted in this state."""


def _meta_name(obj: Dict[str, Any]) -> str:
    return ((obj.get("metadata") or {}).get("name")) or "?"


class Mutator:
    """Common base: identity, match spec, applyTo filter, location."""

    kind: str = "?"

    def __init__(self, obj: Dict[str, Any]):
        if not isinstance(obj, dict):
            raise MutatorError("mutator is not an object")
        self.name = _meta_name(obj)
        if self.name == "?":
            raise MutatorError(f"{self.kind} has no metadata.name")
        self.obj = copy.deepcopy(obj)
        spec = obj.get("spec")
        if not isinstance(spec, dict):
            raise MutatorError(f"{self.kind} {self.name} has no spec")
        self.match: Dict[str, Any] = (
            spec.get("match") if isinstance(spec.get("match"), dict) else {}
        )
        location = spec.get("location")
        if not isinstance(location, str):
            raise MutatorError(
                f"{self.kind} {self.name} has no spec.location"
            )
        try:
            self.path: Tuple[Node, ...] = parse_path(location)
        except PathError as e:
            raise MutatorError(f"{self.kind} {self.name}: {e}") from e
        self.location = location
        self.apply_to = self._parse_apply_to(spec)
        self.params: Dict[str, Any] = (
            spec.get("parameters")
            if isinstance(spec.get("parameters"), dict)
            else {}
        )

    # -- identity ------------------------------------------------------------

    @property
    def id(self) -> str:
        return f"{self.kind}/{self.name}"

    def sort_key(self) -> Tuple[str, str]:
        """Total order independent of ingestion order (the reference
        sorts by mutator id the same way, mutation/system.go)."""
        return (self.kind, self.name)

    # -- applicability -------------------------------------------------------

    def _parse_apply_to(self, spec: Dict[str, Any]):
        raw = spec.get("applyTo")
        if raw is None:
            return None  # AssignMetadata: applies to every GVK
        if not isinstance(raw, list) or not raw:
            raise MutatorError(
                f"{self.kind} {self.name}: applyTo must be a non-empty list"
            )
        out = []
        for entry in raw:
            if not isinstance(entry, dict):
                raise MutatorError(
                    f"{self.kind} {self.name}: applyTo entries must be objects"
                )
            out.append(
                (
                    list(entry.get("groups") or []),
                    list(entry.get("versions") or []),
                    list(entry.get("kinds") or []),
                )
            )
        return out

    def applies_to(self, group: str, version: str, kind: str) -> bool:
        if self.apply_to is None:
            return True
        for groups, versions, kinds in self.apply_to:
            if (
                ("*" in groups or group in groups)
                and ("*" in versions or version in versions)
                and ("*" in kinds or kind in kinds)
            ):
                return True
        return False

    # -- application ---------------------------------------------------------

    def apply(self, obj: Any, review: Dict[str, Any]) -> Tuple[Any, bool]:
        """-> (new object, changed). Never mutates `obj` in place."""
        raise NotImplementedError


# ---------------------------------------------------------------------------
# traversal


def _walk_existing(obj: Any, nodes: Sequence[Node]) -> List[Any]:
    """Values reachable at `nodes` in `obj` (globs fan out); [] when the
    path does not resolve. Type mismatches resolve to nothing — this is
    the read side (pathTests / assignIf), which must not raise."""
    frontier = [obj]
    for n in nodes:
        nxt: List[Any] = []
        for cur in frontier:
            if not isinstance(cur, dict) or n.name not in cur:
                continue
            val = cur[n.name]
            if isinstance(n, ObjectNode):
                nxt.append(val)
            else:
                if not isinstance(val, list):
                    continue
                for el in val:
                    if not isinstance(el, dict) or n.key_field not in el:
                        continue
                    if n.glob or el[n.key_field] == n.key_value:
                        nxt.append(el)
        frontier = nxt
        if not frontier:
            break
    return frontier


def _set_path(
    obj: Any, nodes: Sequence[Node], setter, who: str, create: bool = True
) -> Tuple[Any, bool]:
    """Copy-on-write traversal: returns (new_obj, changed).

    `setter(container, key) -> bool` runs at every terminal container
    (parent dict) the path resolves to, mutating the (already copied)
    container in place and reporting whether it changed anything.
    Missing intermediate objects and keyed list elements are created
    when `create`; globs never create. A node that exists with an
    incompatible type raises MutationApplyError — mutating through it
    would corrupt the object.
    """
    if not isinstance(obj, dict):
        raise MutationApplyError(f"{who}: object root is not a map")

    def rec(cur: Dict[str, Any], i: int) -> Tuple[Dict[str, Any], bool]:
        node = nodes[i]
        last = i == len(nodes) - 1
        out = dict(cur)
        if isinstance(node, ObjectNode):
            if last:
                changed = setter(out, node.name)
                return (out, True) if changed else (cur, False)
            child = cur.get(node.name)
            if child is None and node.name not in cur:
                if not create:
                    return cur, False
                child = {}
            if not isinstance(child, dict):
                raise MutationApplyError(
                    f"{who}: {node.name} exists but is not an object"
                )
            new_child, changed = rec(child, i + 1)
            if not changed:
                return cur, False
            out[node.name] = new_child
            return out, True
        # ListNode
        child = cur.get(node.name)
        if child is None and node.name not in cur:
            if not create or node.glob:
                return cur, False
            child = []
        if not isinstance(child, list):
            raise MutationApplyError(
                f"{who}: {node.name} exists but is not a list"
            )
        new_list = list(child)
        changed_any = False
        matched = False
        for j, el in enumerate(new_list):
            if not isinstance(el, dict) or node.key_field not in el:
                continue
            if node.glob or el[node.key_field] == node.key_value:
                matched = True
                if last:
                    el2 = dict(el)
                    if setter(el2, None):
                        new_list[j] = el2
                        changed_any = True
                else:
                    el2, ch = rec(el, i + 1)
                    if ch:
                        new_list[j] = el2
                        changed_any = True
        if not matched and not node.glob and create:
            # keyed element missing: create it (Gatekeeper adds the
            # element with its key field set, then mutates into it)
            el: Dict[str, Any] = {node.key_field: node.key_value}
            if last:
                setter(el, None)
            else:
                el, _ = rec(el, i + 1)
            new_list.append(el)
            changed_any = True
        if not changed_any:
            return cur, False
        out[node.name] = new_list
        return out, True

    return rec(obj, 0)


# ---------------------------------------------------------------------------
# pathTests / assignIf


def _check_path_tests(mut: Mutator, obj: Any) -> bool:
    tests = mut.params.get("pathTests")
    if not isinstance(tests, list):
        return True
    for t in tests:
        if not isinstance(t, dict):
            continue
        sub = t.get("subPath")
        cond = t.get("condition")
        if not isinstance(sub, str):
            continue
        try:
            nodes = parse_path(sub)
        except PathError:
            return False
        exists = bool(_walk_existing(obj, nodes))
        if cond == "MustExist" and not exists:
            return False
        if cond == "MustNotExist" and exists:
            return False
    return True


_ABSENT = object()


def _assign_if_ok(assign_if: Any, current: Any) -> bool:
    """`assignIf: {in: [...], notIn: [...]}` against the current value
    at the location (absent compares equal only to an explicit null in
    `in`; absent trivially passes `notIn`)."""
    if not isinstance(assign_if, dict):
        return True
    inn = assign_if.get("in")
    if isinstance(inn, list):
        if current is _ABSENT:
            if None not in inn:
                return False
        elif not any(current == v for v in inn):
            return False
    not_in = assign_if.get("notIn")
    if isinstance(not_in, list) and current is not _ABSENT:
        if any(current == v for v in not_in):
            return False
    return True


# ---------------------------------------------------------------------------
# the three kinds


class AssignMutator(Mutator):
    kind = "Assign"

    def __init__(self, obj: Dict[str, Any]):
        super().__init__(obj)
        if self.apply_to is None:
            raise MutatorError(
                f"Assign {self.name}: spec.applyTo is required"
            )
        if isinstance(self.path[0], ObjectNode) and (
            self.path[0].name == "metadata"
        ):
            raise MutatorError(
                f"Assign {self.name}: cannot mutate metadata "
                "(use AssignMetadata)"
            )
        assign = self.params.get("assign")
        if not isinstance(assign, dict) or "value" not in assign:
            raise MutatorError(
                f"Assign {self.name}: spec.parameters.assign.value is required"
            )
        self.value = assign["value"]
        self.assign_if = self.params.get("assignIf")

    def apply(self, obj: Any, review: Dict[str, Any]) -> Tuple[Any, bool]:
        if not _check_path_tests(self, obj):
            return obj, False

        value = self.value

        def setter(container: Dict[str, Any], key: Optional[str]) -> bool:
            if key is None:
                # terminal inside a keyed list element: value must be an
                # object merged over the element? The reference forbids
                # list-terminal Assign without a field; treat the whole
                # element as the slot via its key field — unsupported.
                raise MutationApplyError(
                    f"Assign {self.name}: location terminates inside a "
                    "list element; address a field of the element"
                )
            current = container[key] if key in container else _ABSENT
            if not _assign_if_ok(self.assign_if, current):
                return False
            if current is not _ABSENT and container[key] == value:
                return False
            container[key] = copy.deepcopy(value)
            return True

        return _set_path(obj, self.path, setter, self.id)


class AssignMetadataMutator(Mutator):
    kind = "AssignMetadata"

    def __init__(self, obj: Dict[str, Any]):
        super().__init__(obj)
        ok = (
            len(self.path) == 3
            and all(isinstance(n, ObjectNode) for n in self.path)
            and self.path[0].name == "metadata"
            and self.path[1].name in _METADATA_MAPS
        )
        if not ok:
            raise MutatorError(
                f"AssignMetadata {self.name}: location must be "
                "metadata.labels.<key> or metadata.annotations.<key>"
            )
        assign = self.params.get("assign")
        if not isinstance(assign, dict) or not isinstance(
            assign.get("value"), str
        ):
            raise MutatorError(
                f"AssignMetadata {self.name}: spec.parameters.assign.value "
                "must be a string"
            )
        self.value = assign["value"]

    def apply(self, obj: Any, review: Dict[str, Any]) -> Tuple[Any, bool]:
        def setter(container: Dict[str, Any], key: Optional[str]) -> bool:
            if key in container:
                return False  # never overwrite (reference semantics)
            container[key] = self.value
            return True

        return _set_path(obj, self.path, setter, self.id)


class ModifySetMutator(Mutator):
    kind = "ModifySet"

    def __init__(self, obj: Dict[str, Any]):
        super().__init__(obj)
        if self.apply_to is None:
            raise MutatorError(
                f"ModifySet {self.name}: spec.applyTo is required"
            )
        op = self.params.get("operation", "merge")
        if op not in ("merge", "prune"):
            raise MutatorError(
                f"ModifySet {self.name}: operation must be merge|prune, "
                f"got {op!r}"
            )
        self.operation = op
        values = self.params.get("values")
        from_list = values.get("fromList") if isinstance(values, dict) else None
        if not isinstance(from_list, list) or not from_list:
            raise MutatorError(
                f"ModifySet {self.name}: spec.parameters.values.fromList "
                "must be a non-empty list"
            )
        self.values = from_list

    def apply(self, obj: Any, review: Dict[str, Any]) -> Tuple[Any, bool]:
        if not _check_path_tests(self, obj):
            return obj, False

        def setter(container: Dict[str, Any], key: Optional[str]) -> bool:
            if key is None:
                raise MutationApplyError(
                    f"ModifySet {self.name}: location terminates inside a "
                    "list element; address a field of the element"
                )
            cur = container.get(key)
            if cur is None and key not in container:
                if self.operation == "prune":
                    return False
                cur = []
            if not isinstance(cur, list):
                raise MutationApplyError(
                    f"ModifySet {self.name}: {key} exists but is not a list"
                )
            if self.operation == "merge":
                missing = [v for v in self.values if v not in cur]
                if not missing:
                    return False
                container[key] = list(cur) + [
                    copy.deepcopy(v) for v in missing
                ]
                return True
            kept = [v for v in cur if v not in self.values]
            if len(kept) == len(cur):
                return False
            container[key] = kept
            return True

        # prune must not create the list it would prune from
        return _set_path(
            obj, self.path, setter, self.id,
            create=self.operation == "merge",
        )


_KIND_CLASSES = {
    "Assign": AssignMutator,
    "AssignMetadata": AssignMetadataMutator,
    "ModifySet": ModifySetMutator,
}


def mutator_from_obj(obj: Dict[str, Any]) -> Mutator:
    """Build a typed mutator from its CR dict (raises MutatorError)."""
    if not isinstance(obj, dict):
        raise MutatorError("mutator is not an object")
    kind = obj.get("kind")
    cls = _KIND_CLASSES.get(kind)
    if cls is None:
        raise MutatorError(
            f"unknown mutator kind {kind!r} (known: {MUTATOR_KINDS})"
        )
    group = (obj.get("apiVersion") or "").partition("/")[0]
    if group != MUTATION_GROUP:
        raise MutatorError(
            f"{kind} {_meta_name(obj)} has the wrong group: {group!r}"
        )
    return cls(obj)
