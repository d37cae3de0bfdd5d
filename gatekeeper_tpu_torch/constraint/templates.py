# Copied from gatekeeper_tpu/constraint/templates.py; only imports and the edits noted in this header differ.
"""ConstraintTemplate model, CRD construction, and constraint validation.

Covers the reference's template compile pipeline entry
(vendor/.../frameworks/constraint/pkg/client/client.go:240-351 +
crd_helpers.go:40-140): name==lowercase(kind) check, single-target
validation, CRD schema assembly (match schema + enforcementAction +
template-declared parameters schema), and CR validation against that schema.

The apiextensions validation machinery is replaced with a small JSON-Schema
subset validator sufficient for the schemas the library templates declare
(type/properties/items/enum/maxLength — v1beta1 CRD validation is
non-structural and permissive about unknown fields, which this mirrors).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .errors import InvalidConstraintError, InvalidTemplateError

CONSTRAINT_GROUP = "constraints.gatekeeper.sh"
CONSTRAINT_API_VERSION = f"{CONSTRAINT_GROUP}/v1beta1"
TEMPLATE_GROUP = "templates.gatekeeper.sh"
SUPPORTED_TEMPLATE_VERSIONS = ("v1alpha1", "v1beta1")


@dataclass
class TargetSpec:
    target: str
    rego: str
    libs: List[str] = field(default_factory=list)


@dataclass
class ConstraintTemplate:
    """Parsed ConstraintTemplate (apis/templates v1alpha1/v1beta1)."""

    name: str
    kind: str
    targets: List[TargetSpec]
    parameters_schema: Optional[Dict[str, Any]] = None
    api_version: str = f"{TEMPLATE_GROUP}/v1beta1"
    labels: Dict[str, str] = field(default_factory=dict)
    raw: Dict[str, Any] = field(default_factory=dict)
    # static vectorizability analysis (analysis.VectorizabilityReport),
    # attached by the Client's compile pipeline at admission time
    vectorizability: Optional[Any] = None

    @classmethod
    def from_dict(cls, obj: Dict[str, Any]) -> "ConstraintTemplate":
        if not isinstance(obj, dict):
            raise InvalidTemplateError("template must be an object")
        api_version = obj.get("apiVersion", "")
        group, _, version = api_version.partition("/")
        if group != TEMPLATE_GROUP or version not in SUPPORTED_TEMPLATE_VERSIONS:
            raise InvalidTemplateError(
                f"unsupported template apiVersion: {api_version!r}"
            )
        if obj.get("kind") != "ConstraintTemplate":
            raise InvalidTemplateError(f"not a ConstraintTemplate: {obj.get('kind')!r}")
        metadata = obj.get("metadata") or {}
        name = metadata.get("name", "")
        spec = obj.get("spec") or {}
        crd_spec = ((spec.get("crd") or {}).get("spec")) or {}
        names = crd_spec.get("names") or {}
        kind = names.get("kind", "")
        validation = crd_spec.get("validation") or {}
        params_schema = validation.get("openAPIV3Schema")
        targets_raw = spec.get("targets")
        if targets_raw is None:
            raise InvalidTemplateError(
                'Field "targets" not specified in ConstraintTemplate spec'
            )
        if not isinstance(targets_raw, list) or len(targets_raw) == 0:
            raise InvalidTemplateError(
                "No targets specified. ConstraintTemplate must specify one target"
            )
        if len(targets_raw) > 1:
            raise InvalidTemplateError(
                "Multi-target templates are not currently supported"
            )
        targets = [
            TargetSpec(
                target=t.get("target", ""),
                rego=t.get("rego", ""),
                libs=list(t.get("libs") or []),
            )
            for t in targets_raw
        ]
        return cls(
            name=name,
            kind=kind,
            targets=targets,
            parameters_schema=params_schema,
            api_version=api_version,
            labels=dict(metadata.get("labels") or {}),
            raw=obj,
        )

    def validate_names(self) -> None:
        """client.go:245: template name must equal lowercase of CRD kind."""
        if self.name != self.kind.lower():
            raise InvalidTemplateError(
                f"Template's name {self.name} is not equal to the lowercase "
                f"of CRD's Kind: {self.kind.lower()}"
            )


@dataclass
class CRD:
    """CRD-lite for a constraint kind (crd_helpers.go:85-140)."""

    kind: str
    group: str = CONSTRAINT_GROUP
    plural: str = ""
    schema: Optional[Dict[str, Any]] = None

    @property
    def name(self) -> str:
        return f"{self.plural}.{self.group}"

    def to_dict(self) -> Dict[str, Any]:
        return {
            "apiVersion": "apiextensions.k8s.io/v1beta1",
            "kind": "CustomResourceDefinition",
            "metadata": {"name": self.name},
            "spec": {
                "group": self.group,
                "names": {
                    "kind": self.kind,
                    "listKind": self.kind + "List",
                    "plural": self.plural,
                    "singular": self.plural,
                    "categories": ["constraint"],
                },
                "scope": "Cluster",
                "version": "v1beta1",
                "versions": [
                    {"name": "v1beta1", "served": True, "storage": True},
                    {"name": "v1alpha1", "served": True, "storage": False},
                ],
                "validation": {"openAPIV3Schema": self.schema},
                "subresources": {"status": {}},
            },
        }


def create_crd(
    templ: ConstraintTemplate, match_schema: Dict[str, Any]
) -> CRD:
    """createSchema + createCRD (crd_helpers.go:40-140)."""
    spec_props: Dict[str, Any] = {
        "match": match_schema,
        "enforcementAction": {"type": "string"},
    }
    if templ.parameters_schema is not None:
        spec_props["parameters"] = templ.parameters_schema
    schema = {
        "properties": {
            "metadata": {
                "properties": {
                    "name": {"type": "string", "maxLength": 63},
                }
            },
            "spec": {"properties": spec_props},
        }
    }
    return CRD(kind=templ.kind, plural=templ.kind.lower(), schema=schema)


def validate_constraint_against_crd(
    constraint: Dict[str, Any], crd: CRD
) -> None:
    """validateCR (crd_helpers.go: validateCR): group/kind agreement + schema."""
    api_version = constraint.get("apiVersion", "")
    group, _, _version = api_version.partition("/")
    if group != crd.group:
        raise InvalidConstraintError(
            f"Constraint group {group!r} does not match CRD group {crd.group!r}"
        )
    if constraint.get("kind") != crd.kind:
        raise InvalidConstraintError(
            f"Constraint kind {constraint.get('kind')!r} does not match CRD "
            f"kind {crd.kind!r}"
        )
    name = ((constraint.get("metadata") or {}).get("name")) or ""
    if name == "":
        raise InvalidConstraintError("Constraint has no name")
    errors = validate_json_schema(constraint, crd.schema, path="")
    if errors:
        raise InvalidConstraintError("; ".join(errors))


_TYPE_CHECKS = {
    "string": lambda v: isinstance(v, str),
    "integer": lambda v: isinstance(v, int) and not isinstance(v, bool),
    "number": lambda v: isinstance(v, (int, float)) and not isinstance(v, bool),
    "boolean": lambda v: isinstance(v, bool),
    "array": lambda v: isinstance(v, list),
    "object": lambda v: isinstance(v, dict),
    "null": lambda v: v is None,
}


def validate_json_schema(
    value: Any, schema: Optional[Dict[str, Any]], path: str = ""
) -> List[str]:
    """Validate `value` against a JSON-Schema subset; returns error strings.

    Permissive like v1beta1 CRD validation: unknown keys pass unless
    additionalProperties is explicitly false; absent fields only fail when
    listed in `required`; null values are skipped unless a type says
    otherwise (OpenAPI v3 has no union types here).
    """
    errs: List[str] = []
    if not isinstance(schema, dict):
        return errs
    loc = path or "<root>"
    typ = schema.get("type")
    if typ is not None and value is not None:
        check = _TYPE_CHECKS.get(typ)
        if check and not check(value):
            errs.append(f"{loc}: expected {typ}, got {type(value).__name__}")
            return errs
    enum = schema.get("enum")
    if isinstance(enum, list) and enum and value is not None and value not in enum:
        errs.append(f"{loc}: {value!r} not in enum {enum!r}")
    if isinstance(value, str):
        max_len = schema.get("maxLength")
        if isinstance(max_len, int) and len(value) > max_len:
            errs.append(f"{loc}: length {len(value)} exceeds maxLength {max_len}")
        pattern = schema.get("pattern")
        if isinstance(pattern, str):
            import re

            if not re.search(pattern, value):
                errs.append(f"{loc}: does not match pattern {pattern!r}")
    if isinstance(value, dict):
        required = schema.get("required")
        if isinstance(required, list):
            for req in required:
                if req not in value:
                    errs.append(f"{loc}: missing required field {req!r}")
        props = schema.get("properties")
        if isinstance(props, dict):
            for k, sub in props.items():
                if k in value:
                    errs.extend(
                        validate_json_schema(value[k], sub, f"{path}.{k}" if path else k)
                    )
        addl = schema.get("additionalProperties")
        if addl is False and isinstance(props, dict):
            for k in value:
                if k not in props:
                    errs.append(f"{loc}: unknown field {k!r}")
        elif isinstance(addl, dict):
            known = props or {}
            for k, v in value.items():
                if k not in known:
                    errs.extend(
                        validate_json_schema(v, addl, f"{path}.{k}" if path else k)
                    )
    if isinstance(value, list):
        items = schema.get("items")
        if isinstance(items, dict):
            for i, v in enumerate(value):
                errs.extend(validate_json_schema(v, items, f"{loc}[{i}]"))
        min_items = schema.get("minItems")
        if isinstance(min_items, int) and len(value) < min_items:
            errs.append(f"{loc}: fewer than minItems {min_items}")
    return errs
