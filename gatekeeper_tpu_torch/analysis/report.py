# Copied from gatekeeper_tpu/analysis/report.py; no line below differs.
"""Vectorizability report model: verdict lattice + stable diagnostics.

The analyzer (`analysis/analyzer.py`) classifies every ConstraintTemplate
ahead of compilation into a four-point verdict lattice ordered by how
much of the template's evaluation stays on-device:

    VECTORIZED > PARTIAL_ROWS > INTERPRETER > INVALID

  * VECTORIZED    — every construct is inside the symbolic compiler's
                    exact subset: the compiled program's counts (and,
                    where branch plans exist, renders) are exact.
  * PARTIAL_ROWS  — compiles, but only as a *screen*: some conditions
                    (inventory joins, builtins/comprehensions outside
                    the exact subset) over-approximate and the flagged
                    rows re-check on the interpreter.
  * INTERPRETER   — the template cannot compile even as a screen (the
                    construct aborts every retry of
                    `engine.programs.compile_program`); the driver must
                    route it wholesale to the interpreter.
  * INVALID       — the template is broken in a way no engine can
                    evaluate soundly (unsafe variables, bad entrypoint);
                    admission should reject it with the diagnostics.

Diagnostics carry stable `GK-Vxxx` codes so metrics, CI baselines, and
operator tooling can key on them across releases (docs/analysis.md has a
minimal Rego repro for each).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

# -- verdict lattice --------------------------------------------------------

VECTORIZED = "VECTORIZED"
PARTIAL_ROWS = "PARTIAL_ROWS"
INTERPRETER = "INTERPRETER"
INVALID = "INVALID"

# descending order: index = badness (meet = max index)
VERDICT_ORDER: Tuple[str, ...] = (
    VECTORIZED,
    PARTIAL_ROWS,
    INTERPRETER,
    INVALID,
)


def verdict_meet(a: str, b: str) -> str:
    """Lattice meet: the worse of two verdicts."""
    return VERDICT_ORDER[
        max(VERDICT_ORDER.index(a), VERDICT_ORDER.index(b))
    ]


# -- diagnostic codes -------------------------------------------------------

# code -> (slug, verdict the diagnostic caps the template at)
CODES: Dict[str, Tuple[str, str]] = {
    "GK-V001": ("unsupported-builtin", PARTIAL_ROWS),
    "GK-V002": ("unbounded-comprehension", PARTIAL_ROWS),
    "GK-V003": ("cross-join-over-cap", INTERPRETER),
    "GK-V004": ("dynamic-ref-head", INTERPRETER),
    "GK-V005": ("unsafe-var", INVALID),
    "GK-V006": ("inventory-dependent", PARTIAL_ROWS),
    "GK-V007": ("unsupported-construct", INTERPRETER),
    "GK-V008": ("invalid-entrypoint", INVALID),
    # external_data(provider, keys): compiles as a screen whose per-row
    # bits come from the batch-prefetched response cache — fully
    # cache-hit rows stay fused, cold-miss/error rows re-check on the
    # interpreter (docs/externaldata.md)
    "GK-V009": ("external-data", PARTIAL_ROWS),
}

# compiler-disagreement sentinel: the analyzer predicted compilable but
# `CompileUnsupported` was raised anyway. Never produced by the analyzer
# itself — the driver emits it when the consistency assertion fires.
CODE_MISMATCH = "GK-V999"


@dataclass(frozen=True)
class Diagnostic:
    """One finding, anchored to a rule/line when known."""

    code: str
    message: str
    rule: str = ""
    line: int = 0
    severity: str = ""  # verdict cap; filled from CODES when empty

    def cap(self) -> str:
        if self.severity:
            return self.severity
        return CODES.get(self.code, ("", PARTIAL_ROWS))[1]

    @property
    def slug(self) -> str:
        return CODES.get(self.code, ("unknown", ""))[0]

    def to_dict(self) -> Dict[str, Any]:
        return {
            "code": self.code,
            "slug": self.slug,
            "message": self.message,
            "rule": self.rule,
            "line": self.line,
        }

    def render(self) -> str:
        loc = f" rule={self.rule}" if self.rule else ""
        ln = f":{self.line}" if self.line else ""
        return f"{self.code} {self.slug}{loc}{ln}: {self.message}"


@dataclass
class ExternalDataCall:
    """One recorded external_data call site (GK-V009). Drives the batch
    plane: `extractable` calls (literal provider + input-derived keys
    expression) prefetch per micro-batch; `error_gated` calls (the rule
    body provably requires a non-empty response.errors) additionally
    let the fused screen skip rows whose keys are all clean cache hits.

    `keys_term`/`module` are live AST handles for the extraction
    micro-evaluation (externaldata/extract.py) — deliberately excluded
    from to_dict()."""

    provider: Optional[str] = None
    rule: str = ""
    line: int = 0
    extractable: bool = False
    error_gated: bool = False
    respvar: Optional[str] = None
    keys_term: Any = None
    module: Any = None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "provider": self.provider,
            "rule": self.rule,
            "line": self.line,
            "extractable": self.extractable,
            "error_gated": self.error_gated,
        }


@dataclass
class VectorizabilityReport:
    """Per-template analysis outcome (one report per constraint kind)."""

    kind: str
    verdict: str = VECTORIZED
    diagnostics: List[Diagnostic] = field(default_factory=list)
    # external_data call sites (GK-V009); empty for ordinary templates
    external_calls: List[ExternalDataCall] = field(default_factory=list)

    def add(
        self,
        code: str,
        message: str,
        rule: str = "",
        line: int = 0,
        severity: str = "",
    ) -> None:
        d = Diagnostic(
            code=code, message=message, rule=rule, line=line,
            severity=severity,
        )
        self.diagnostics.append(d)
        self.verdict = verdict_meet(self.verdict, d.cap())

    @property
    def compilable(self) -> bool:
        """May the driver attempt `compile_program` at all?"""
        return self.verdict in (VECTORIZED, PARTIAL_ROWS)

    @property
    def codes(self) -> List[str]:
        return sorted({d.code for d in self.diagnostics})

    def extdata_mode(self) -> Optional[str]:
        """The fused-screen mode for the template's external calls:
        None  — no external_data calls, or some call is unextractable
                (no prefetch possible; coarse all-rows screen);
        "all" — every call is extractable: the batch plane prefetches,
                but the screen routes every matching row (a violation
                may fire on response *values*, so key cleanliness
                proves nothing);
        "err" — extractable AND every call is provably error-gated:
                rows whose keys are all clean cache hits can never
                violate through the external path, so the screen skips
                them — the fully-cache-hit batch stays fused."""
        if not self.external_calls:
            return None
        if not all(
            c.extractable and c.provider for c in self.external_calls
        ):
            return None
        if all(c.error_gated for c in self.external_calls):
            return "err"
        return "all"

    def external_providers(self) -> List[str]:
        return sorted(
            {c.provider for c in self.external_calls if c.provider}
        )

    def primary_code(self) -> Optional[str]:
        """The diagnostic code that set the verdict (worst cap, first
        occurrence) — the machine-readable 'why' for routing metrics."""
        worst: Optional[Diagnostic] = None
        for d in self.diagnostics:
            if worst is None or (
                VERDICT_ORDER.index(d.cap())
                > VERDICT_ORDER.index(worst.cap())
            ):
                worst = d
        return worst.code if worst is not None else None

    def to_dict(self) -> Dict[str, Any]:
        out = {
            "kind": self.kind,
            "verdict": self.verdict,
            "codes": self.codes,
            "diagnostics": [d.to_dict() for d in self.diagnostics],
        }
        if self.external_calls:
            out["external_data"] = {
                "mode": self.extdata_mode(),
                "providers": self.external_providers(),
                "calls": [c.to_dict() for c in self.external_calls],
            }
        return out

    def render(self) -> str:
        lines = [f"{self.kind}: {self.verdict}"]
        for d in self.diagnostics:
            lines.append(f"  {d.render()}")
        return "\n".join(lines)
