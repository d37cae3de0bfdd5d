# Copied from gatekeeper_tpu/constraint/types.py; only imports and the edits noted in this header differ.
"""Wire types between drivers and callers.

Shape-compatible with the reference's
vendor/.../frameworks/constraint/pkg/types/validation.go:11-63.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class Result:
    # messages reported by the violation rule
    msg: str = ""
    # arbitrary supplemental details from the violation rule
    metadata: Dict[str, Any] = field(default_factory=dict)
    # the constraint (full unstructured object) that was violated
    constraint: Optional[Dict[str, Any]] = None
    # the review object evaluated
    review: Any = None
    # the violating resource, extracted from the review by the target handler
    resource: Any = None
    # "deny" | "dryrun" (unrecognized values pass through)
    enforcement_action: str = "deny"

    def to_dict(self) -> Dict[str, Any]:
        return {
            "msg": self.msg,
            "metadata": self.metadata,
            "constraint": self.constraint,
            "review": self.review,
            "resource": self.resource,
            "enforcementAction": self.enforcement_action,
        }


@dataclass
class Response:
    trace: Optional[str] = None
    input: Optional[str] = None
    target: str = ""
    results: List[Result] = field(default_factory=list)

    def sorted_results(self) -> List[Result]:
        return sorted(self.results, key=lambda r: r.msg)


@dataclass
class Responses:
    by_target: Dict[str, Response] = field(default_factory=dict)
    handled: Dict[str, bool] = field(default_factory=dict)

    def results(self) -> List[Result]:
        out: List[Result] = []
        for target in sorted(self.by_target):
            out.extend(self.by_target[target].results)
        return out

    def traces(self) -> str:
        lines = []
        for target in sorted(self.by_target):
            resp = self.by_target[target]
            if resp.trace is None:
                continue
            lines.append(resp.trace)
            lines.append(f"target: {target}")
        return "\n\n".join(lines)
