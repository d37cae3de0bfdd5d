# Copied from gatekeeper_tpu/analysis/__init__.py; only these edits differ.
# Edit: the docstring names the port's CLI and what this package leaves
# out: the JAX jit lint (`jitlint.py`).
"""Static vectorizability analysis for ConstraintTemplate Rego.

Public surface:

  * `analyze_template(dict)` / `analyze_modules(kind, modules)` — run
    the analyzer; returns a `VectorizabilityReport`.
  * `VectorizabilityReport` / `Diagnostic` — the structured outcome:
    a verdict from the lattice `VECTORIZED | PARTIAL_ROWS |
    INTERPRETER | INVALID` plus stable `GK-Vxxx` diagnostics.
  * `python -m gatekeeper_tpu_torch.analysis <paths...>` — offline
    template linting + CI baseline enforcement (see `cli.py`), with the
    mutator, provider, corpus, IR and canary-derivability planes
    (`canarygate.py`) and the one-shot `all` gate.

The analyzer is consulted by `constraint/client.py` at template
admission (INVALID templates are rejected with the diagnostics) and by
`constraint/torchdriver.py` ahead of compilation (INTERPRETER templates
route without a try/except around `compile_program`).

A second, program-level plane lives in `ir.py`: abstract interpretation
and feature liveness over the compiled program IR, with stable
`GK-P01x` codes, and the driver-side liveness masking consumed by
`constraint/torchdriver.py`.

The corpus plane lives in `corpus.py`: whole-corpus diagnostics over
templates, constraints, mutators and providers, and the provably-dead
constraint keys the partition planner prunes (`CorpusPlane`).

Not part of this package: the JAX jit lint (`jitlint.py`).
"""

from .analyzer import Analyzer, analyze_modules, analyze_template  # noqa: F401
from .ir import (  # noqa: F401
    Certificate,
    IR_CODES,
    IrDiagnostic,
    IrLint,
    IrReport,
    corpus_liveness,
    ir_from_docs,
    ir_from_programs,
    program_liveness,
)
from .report import (  # noqa: F401
    CODE_MISMATCH,
    CODES,
    Diagnostic,
    INTERPRETER,
    INVALID,
    PARTIAL_ROWS,
    VECTORIZED,
    VectorizabilityReport,
    verdict_meet,
)
