# Copied from gatekeeper_tpu/mutation/lint.py; unchanged.
"""Offline mutator diagnostics with stable GK-M0xx codes.

Shared by the analysis CLI's `mutators` mode and available to CI: parse
mutator YAML documents, report per-mutator spec errors and
cross-mutator schema conflicts. Codes are stable contract (like the
analyzer's GK-Vxxx set — docs/mutation.md documents them):

  GK-M001  location path parse error
  GK-M002  missing / non-string spec.location
  GK-M003  AssignMetadata location outside metadata.labels/annotations
  GK-M004  Assign location inside metadata
  GK-M005  invalid parameters (assign.value / values.fromList / operation)
  GK-M006  cross-mutator schema conflict (object-vs-list / key field)
  GK-M007  unknown mutator kind or bad applyTo
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

from .mutators import MutatorError, mutator_from_obj
from .system import _schema_conflicts


@dataclass
class MutatorLint:
    """One mutator's lint outcome."""

    id: str
    source: str = ""
    codes: List[str] = field(default_factory=list)
    messages: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.codes

    def add(self, code: str, message: str) -> None:
        if code not in self.codes:
            self.codes.append(code)
        self.messages.append(f"{code}: {message}")

    def to_dict(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "source": self.source,
            "codes": list(self.codes),
            "messages": list(self.messages),
            "ok": self.ok,
        }

    def render(self) -> str:
        if self.ok:
            return f"{self.id}: OK"
        return f"{self.id}: " + "; ".join(self.messages)


def _classify_error(err: MutatorError) -> str:
    msg = str(err)
    if "invalid location" in msg:
        return "GK-M001"
    if "spec.location" in msg:
        return "GK-M002"
    if "metadata.labels" in msg or "metadata.annotations" in msg:
        return "GK-M003"
    if "cannot mutate metadata" in msg:
        return "GK-M004"
    if (
        "assign.value" in msg
        or "values.fromList" in msg
        or "operation must be" in msg
    ):
        return "GK-M005"
    if "unknown mutator kind" in msg or "applyTo" in msg or "group" in msg:
        return "GK-M007"
    return "GK-M005"


def lint_mutators(
    docs: List[Tuple[str, Dict[str, Any]]],
) -> List[MutatorLint]:
    """[(source, mutator dict)] -> per-mutator lint results, including
    cross-mutator conflict diagnostics over the VALID subset."""
    out: List[MutatorLint] = []
    valid = []
    for source, doc in docs:
        kind = doc.get("kind", "?") if isinstance(doc, dict) else "?"
        name = (
            ((doc.get("metadata") or {}).get("name") or "?")
            if isinstance(doc, dict)
            else "?"
        )
        lint = MutatorLint(id=f"{kind}/{name}", source=source)
        try:
            mut = mutator_from_obj(doc)
        except MutatorError as e:
            lint.add(_classify_error(e), str(e))
            out.append(lint)
            continue
        valid.append((mut, lint))
        out.append(lint)
    conflicts = _schema_conflicts([m for m, _ in valid])
    for mut, lint in valid:
        others = conflicts.get(mut.id)
        if others:
            lint.add(
                "GK-M006",
                f"location schema conflicts with {', '.join(others)}",
            )
    return out


def is_mutator_doc(doc: Any) -> bool:
    from .mutators import MUTATION_GROUP, MUTATOR_KINDS

    return (
        isinstance(doc, dict)
        and doc.get("kind") in MUTATOR_KINDS
        and str(doc.get("apiVersion", "")).startswith(MUTATION_GROUP)
    )
