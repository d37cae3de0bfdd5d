# Copied from gatekeeper_tpu/analysis/cli.py; only these edits differ.
# Edit: the program name is `python -m gatekeeper_tpu_torch.analysis`
# (usage lines and argparse `prog`), and the docstring drops the line on
# when the contract was normalized. Every plane runs the port's modules
# (analyzer, report, corpus, ir, mutation/lint, externaldata/lint and the
# canary gate); nothing here touches the device.
"""Offline template + mutator + provider + corpus linting CLI.

    python -m gatekeeper_tpu_torch.analysis deploy/ [more paths...]
        [--json] [--baseline FILE] [--write-baseline FILE] [--strict]
    python -m gatekeeper_tpu_torch.analysis mutators deploy/ [more paths...]
        [--json] [--baseline FILE] [--write-baseline FILE]
    python -m gatekeeper_tpu_torch.analysis providers deploy/ [more paths...]
        [--json] [--baseline FILE] [--write-baseline FILE]
    python -m gatekeeper_tpu_torch.analysis corpus deploy/ [more paths...]
        [--json] [--baseline FILE] [--write-baseline FILE]
    python -m gatekeeper_tpu_torch.analysis ir deploy/ [more paths...]
        [--json] [--baseline FILE] [--write-baseline FILE]
    python -m gatekeeper_tpu_torch.analysis canary deploy/ [more paths...]
        [--json] [--baseline FILE] [--write-baseline FILE]
    python -m gatekeeper_tpu_torch.analysis all [deploy/policies]

Default mode scans the given files/directories for ConstraintTemplate
YAML documents (directories recurse over *.yaml / *.yml; explicit
*.rego file args are analyzed as a bare template entry module), runs
the static vectorizability analyzer on each, and prints one report per
template.

`mutators` mode scans for Assign/AssignMetadata/ModifySet documents,
reports location-path parse errors and cross-mutator schema conflicts
with stable GK-M0xx codes (docs/mutation.md), and compares against a
baseline manifest ({"mutators": {id: [codes]}}) so CI pins the shipped
example mutators clean.

`providers` mode scans for externaldata.gatekeeper.sh Provider
documents and reports spec problems with stable GK-P0xx codes
(docs/externaldata.md): unreachable URL schemes, missing timeouts,
fail-open providers with no cache to fall back on. Baseline manifest:
{"providers": {id: [codes]}}.

`corpus` mode runs the whole-corpus cross-plane pass (GK-C0xx,
docs/analysis.md §Corpus analysis) over every template, constraint,
mutator and Provider found under the given paths together: missing
providers, orphan constraints, parameter/schema mismatches, dead and
shadowed matches, mutate↔validate admission fights. Baseline
manifest: {"corpus": {subject: [codes]}}.

`ir` mode compiles every template and constraint into the fused
program IR and runs the program-level static analysis (GK-P01x,
docs/analysis.md §IR analysis): feature liveness (which token columns
any compiled program can observe), abstract interpretation over the
burned-in constraint parameters (always/never-firing rules, dead
parameters, no-op checks, unreachable branches), and the fused-path
taxonomy for anything routed to the interpreter. Baseline manifest:
{"ir": {subject: [codes]}}.

`canary` mode runs the verdict-integrity derivability gate (GK-I0xx,
docs/robustness.md §Verdict integrity): every ConstraintTemplate must
derive at least one synthetic canary review the host interpreter
convicts — otherwise its golden digests all pin the empty verdict and
device corruption suppressing its violations is undetectable.
External-data templates run against pinned stub provider responses,
never skipped. Baseline manifest: {"canary": {kind: [codes]}}.

`all` mode is the one-shot repo gate: templates + mutators +
providers + corpus + ir + canary over one directory (default
`deploy/policies`), each compared against its conventional checked-in
baseline when present (`analysis-baseline.json`,
`mutators-baseline.json`, `providers-baseline.json`,
`corpus-baseline.json`, `ir-baseline.json`, `canary-baseline.json` in
that directory), folded into a single exit code.

Shared contract across all subcommands:
  * `--baseline FILE` compares against a checked-in manifest; new
    subjects (absent from the manifest) are allowed; a subject gaining
    a code (or, for templates, a worse verdict) fails.
  * Without a baseline, ANY diagnostic fails (pure lint mode).
  * `--write-baseline FILE` (re)generates the manifest (sorted,
    trailing newline) regardless of pass/fail.
  * Exit status: 0 clean / baseline-clean; 1 failures; 2 usage or
    nothing found to lint (`all` only exits 2 when NO plane found
    anything).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, Iterable, List, Tuple

from .analyzer import analyze_modules, analyze_template
from .report import VERDICT_ORDER, VectorizabilityReport


def _iter_template_docs(path: str) -> Iterable[Tuple[str, Dict[str, Any]]]:
    import yaml

    with open(path) as f:
        try:
            docs = list(yaml.safe_load_all(f))
        except yaml.YAMLError as e:
            raise SystemExit(f"error: {path}: YAML parse error: {e}")
    for doc in docs:
        if isinstance(doc, dict) and doc.get("kind") == "ConstraintTemplate":
            yield path, doc


def collect_templates(
    paths: List[str],
) -> List[Tuple[str, Any]]:
    """-> [(source path, template dict | rego source str)]."""
    out: List[Tuple[str, Any]] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, files in os.walk(p):
                for fn in sorted(files):
                    if fn.endswith((".yaml", ".yml")):
                        out.extend(
                            _iter_template_docs(os.path.join(root, fn))
                        )
        elif p.endswith((".yaml", ".yml")):
            out.extend(_iter_template_docs(p))
        elif p.endswith(".rego"):
            with open(p) as f:
                out.append((p, f.read()))
        else:
            raise SystemExit(f"error: unsupported path {p!r}")
    return out


def _analyze_one(source: str, obj: Any) -> VectorizabilityReport:
    if isinstance(obj, str):  # bare .rego module
        from ..constraint.errors import InvalidTemplateError
        from ..constraint.regocompile import parse_template_module
        from .report import INVALID

        kind = os.path.splitext(os.path.basename(source))[0]
        try:
            module = parse_template_module(obj)
        except InvalidTemplateError as e:
            rep = VectorizabilityReport(kind=kind)
            rep.add("GK-V008", str(e), severity=INVALID)
            return rep
        return analyze_modules(kind, [module])
    return analyze_template(obj)


def _worse(a: str, b: str) -> bool:
    return VERDICT_ORDER.index(a) > VERDICT_ORDER.index(b)


# ---------------------------------------------------------------------------
# shared baseline/report plumbing (one contract for every code-lint mode)


def _load_code_baseline(path: str, key: str) -> Dict[str, List[str]]:
    with open(path) as f:
        return (json.load(f) or {}).get(key, {})


def _compare_code_baseline(lints, baseline: Dict[str, List[str]]
                           ) -> List[str]:
    """New-code regressions vs a manifest; new subjects are allowed."""
    failures: List[str] = []
    for lint in lints:
        want = baseline.get(lint.id)
        if want is None:
            continue  # new subject: allowed
        new_codes = sorted(set(lint.codes) - set(want))
        if new_codes:
            failures.append(
                f"{lint.id}: new diagnostics vs baseline: "
                f"{', '.join(new_codes)}"
            )
    return failures


def _lint_failures(lints) -> List[str]:
    """No-baseline mode: any diagnostic is a failure."""
    return [lint.render() for lint in lints if not lint.ok]


def _write_code_baseline(path: str, key: str, lints) -> None:
    manifest = {key: {lint.id: sorted(lint.codes) for lint in lints}}
    with open(path, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
        f.write("\n")


def _emit_code_lints(args, key: str, noun: str, lints,
                     failures: List[str]) -> None:
    if args.json:
        print(
            json.dumps(
                {
                    key: [lint.to_dict() for lint in lints],
                    "failures": failures,
                },
                indent=2,
            )
        )
        return
    for lint in lints:
        print(f"[{lint.source}] {lint.render()}")
    if failures:
        print("\nFAIL:", file=sys.stderr)
        for f_ in failures:
            print(f"  {f_}", file=sys.stderr)
    else:
        n_ok = sum(1 for lint in lints if lint.ok)
        print(
            f"\nOK: {len(lints)} {noun}(s): clean={n_ok} "
            f"flagged={len(lints) - n_ok}"
        )


def _run_code_lints(args, key: str, noun: str, lints) -> int:
    """The shared tail of every code-lint subcommand: baseline compare
    (or pure lint), optional manifest write, report, exit code."""
    if args.baseline:
        failures = _compare_code_baseline(
            lints, _load_code_baseline(args.baseline, key)
        )
    else:
        failures = _lint_failures(lints)
    if args.write_baseline:
        _write_code_baseline(args.write_baseline, key, lints)
    _emit_code_lints(args, key, noun, lints, failures)
    return 1 if failures else 0


def _iter_mutator_docs(path: str):
    import yaml

    from ..mutation.lint import is_mutator_doc

    with open(path) as f:
        try:
            docs = list(yaml.safe_load_all(f))
        except yaml.YAMLError as e:
            raise SystemExit(f"error: {path}: YAML parse error: {e}")
    for doc in docs:
        if is_mutator_doc(doc):
            yield path, doc


def collect_mutators(paths: List[str]) -> List[Tuple[str, Dict[str, Any]]]:
    out: List[Tuple[str, Dict[str, Any]]] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, files in os.walk(p):
                for fn in sorted(files):
                    if fn.endswith((".yaml", ".yml")):
                        out.extend(
                            _iter_mutator_docs(os.path.join(root, fn))
                        )
        elif p.endswith((".yaml", ".yml")):
            out.extend(_iter_mutator_docs(p))
        else:
            raise SystemExit(f"error: unsupported path {p!r}")
    return out


def run_mutators(argv: List[str]) -> int:
    """`mutators` mode: GK-M0xx lint + baseline enforcement."""
    from ..mutation.lint import lint_mutators

    ap = argparse.ArgumentParser(
        prog="python -m gatekeeper_tpu_torch.analysis mutators",
        description="Offline mutator linter (path grammar + conflicts)",
    )
    ap.add_argument("paths", nargs="+", help="mutator YAML files or dirs")
    ap.add_argument("--json", action="store_true", help="JSON output")
    ap.add_argument("--baseline", help="code manifest to compare against")
    ap.add_argument(
        "--write-baseline", help="write the current codes to FILE"
    )
    args = ap.parse_args(argv)

    entries = collect_mutators(args.paths)
    if not entries:
        print("no mutators found", file=sys.stderr)
        return 2

    return _run_code_lints(args, "mutators", "mutator",
                           lint_mutators(entries))


def _iter_provider_docs(path: str):
    import yaml

    from ..externaldata import is_provider_doc

    with open(path) as f:
        try:
            docs = list(yaml.safe_load_all(f))
        except yaml.YAMLError as e:
            raise SystemExit(f"error: {path}: YAML parse error: {e}")
    for doc in docs:
        if is_provider_doc(doc):
            yield path, doc


def collect_providers(paths: List[str]) -> List[Tuple[str, Dict[str, Any]]]:
    out: List[Tuple[str, Dict[str, Any]]] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, files in os.walk(p):
                for fn in sorted(files):
                    if fn.endswith((".yaml", ".yml")):
                        out.extend(
                            _iter_provider_docs(os.path.join(root, fn))
                        )
        elif p.endswith((".yaml", ".yml")):
            out.extend(_iter_provider_docs(p))
        else:
            raise SystemExit(f"error: unsupported path {p!r}")
    return out


def run_providers(argv: List[str]) -> int:
    """`providers` mode: GK-P0xx lint + baseline enforcement
    (mirrors the `mutators` mode contract)."""
    from ..externaldata.lint import lint_providers

    ap = argparse.ArgumentParser(
        prog="python -m gatekeeper_tpu_torch.analysis providers",
        description=(
            "Offline external-data Provider linter (spec + failure "
            "posture)"
        ),
    )
    ap.add_argument("paths", nargs="+", help="provider YAML files or dirs")
    ap.add_argument("--json", action="store_true", help="JSON output")
    ap.add_argument("--baseline", help="code manifest to compare against")
    ap.add_argument(
        "--write-baseline", help="write the current codes to FILE"
    )
    args = ap.parse_args(argv)

    entries = collect_providers(args.paths)
    if not entries:
        print("no Providers found", file=sys.stderr)
        return 2

    return _run_code_lints(args, "providers", "provider",
                           lint_providers(entries))


def _iter_constraint_docs(path: str):
    import yaml

    from ..constraint.templates import CONSTRAINT_GROUP

    with open(path) as f:
        try:
            docs = list(yaml.safe_load_all(f))
        except yaml.YAMLError as e:
            raise SystemExit(f"error: {path}: YAML parse error: {e}")
    for doc in docs:
        if isinstance(doc, dict) and str(
            doc.get("apiVersion", "")
        ).partition("/")[0] == CONSTRAINT_GROUP:
            yield path, doc


def collect_constraints(paths: List[str]) -> List[Tuple[str, Dict[str, Any]]]:
    out: List[Tuple[str, Dict[str, Any]]] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, files in os.walk(p):
                for fn in sorted(files):
                    if fn.endswith((".yaml", ".yml")):
                        out.extend(
                            _iter_constraint_docs(os.path.join(root, fn))
                        )
        elif p.endswith((".yaml", ".yml")):
            out.extend(_iter_constraint_docs(p))
        else:
            raise SystemExit(f"error: unsupported path {p!r}")
    return out


def run_corpus(argv: List[str]) -> int:
    """`corpus` mode: whole-corpus GK-C0xx pass + baseline
    enforcement (docs/analysis.md §Corpus analysis)."""
    from .corpus import corpus_from_docs

    ap = argparse.ArgumentParser(
        prog="python -m gatekeeper_tpu_torch.analysis corpus",
        description=(
            "Whole-corpus cross-plane linter (templates + constraints "
            "+ mutators + Providers together)"
        ),
    )
    ap.add_argument("paths", nargs="+", help="policy YAML files or dirs")
    ap.add_argument("--json", action="store_true", help="JSON output")
    ap.add_argument("--baseline", help="code manifest to compare against")
    ap.add_argument(
        "--write-baseline", help="write the current codes to FILE"
    )
    args = ap.parse_args(argv)

    template_docs = [
        (src, doc)
        for src, doc in collect_templates(args.paths)
        if isinstance(doc, dict)  # bare .rego has no corpus identity
    ]
    constraint_docs = collect_constraints(args.paths)
    mutator_docs = collect_mutators(args.paths)
    provider_docs = collect_providers(args.paths)
    if not (template_docs or constraint_docs or mutator_docs
            or provider_docs):
        print("no policy documents found", file=sys.stderr)
        return 2

    report = corpus_from_docs(
        template_docs, constraint_docs, mutator_docs, provider_docs
    )
    # per-subject lints ride the shared baseline tail; the corpus-level
    # rollup (dead/prunable/shadowed) prints alongside
    flagged = [lint for lint in report.lints]
    rc = _run_code_lints(args, "corpus", "subject", flagged)
    if not args.json:
        print(
            f"corpus: dead={len(report.dead_keys)} "
            f"prunable={len(report.prunable_keys)} "
            f"shadowed={len(report.shadowed)}"
        )
    return rc


def run_ir(argv: List[str]) -> int:
    """`ir` mode: compile every template + constraint found under the
    given paths into the fused program IR and run the program-level
    static analysis (GK-P01x, docs/analysis.md §IR analysis): abstract
    interpretation over burned-in parameters, feature liveness, and
    the fused-path taxonomy."""
    from .ir import ir_from_docs

    ap = argparse.ArgumentParser(
        prog="python -m gatekeeper_tpu_torch.analysis ir",
        description=(
            "Program-IR static analysis (liveness + abstract "
            "interpretation over compiled templates/constraints)"
        ),
    )
    ap.add_argument("paths", nargs="+", help="policy YAML files or dirs")
    ap.add_argument("--json", action="store_true", help="JSON output")
    ap.add_argument("--baseline", help="code manifest to compare against")
    ap.add_argument(
        "--write-baseline", help="write the current codes to FILE"
    )
    args = ap.parse_args(argv)

    template_docs = [
        doc
        for _src, doc in collect_templates(args.paths)
        if isinstance(doc, dict)  # bare .rego has no IR identity
    ]
    constraint_docs = [doc for _src, doc in collect_constraints(args.paths)]
    if not template_docs:
        print("no ConstraintTemplates found", file=sys.stderr)
        return 2

    report = ir_from_docs(template_docs + constraint_docs)
    rc = _run_code_lints(args, "ir", "subject", report.lints)
    if not args.json:
        live = report.liveness or {}
        print(
            f"ir: programs={live.get('programs', 0)} "
            f"maskable={live.get('maskable', 0)} "
            f"keep_all={live.get('keep_all')} "
            f"live_patterns={live.get('live_patterns')}"
            f"/{live.get('patterns_total')} "
            f"certificates={len(report.certificates)}"
        )
    return rc


def run_canary(argv: List[str]) -> int:
    """`canary` mode: the verdict-integrity derivability gate
    (GK-I0xx, docs/robustness.md §Verdict integrity). Every template
    must derive at least one synthetic canary the host interpreter
    convicts; external-data templates get pinned stub provider
    responses — they are never silently skipped."""
    from .canarygate import canary_lints

    ap = argparse.ArgumentParser(
        prog="python -m gatekeeper_tpu_torch.analysis canary",
        description=(
            "Verdict-integrity canary derivability gate (every "
            "template must convict a synthetic canary review)"
        ),
    )
    ap.add_argument("paths", nargs="+", help="policy YAML files or dirs")
    ap.add_argument("--json", action="store_true", help="JSON output")
    ap.add_argument("--baseline", help="code manifest to compare against")
    ap.add_argument(
        "--write-baseline", help="write the current codes to FILE"
    )
    args = ap.parse_args(argv)

    template_docs = [
        (src, doc)
        for src, doc in collect_templates(args.paths)
        if isinstance(doc, dict)  # bare .rego carries no constraints
    ]
    if not template_docs:
        print("no ConstraintTemplates found", file=sys.stderr)
        return 2

    lints = canary_lints(
        template_docs,
        collect_constraints(args.paths),
        collect_providers(args.paths),
    )
    return _run_code_lints(args, "canary", "template", lints)


def run_all(argv: List[str]) -> int:
    """`all` mode: the one-shot repo gate. Runs templates + mutators +
    providers + corpus over one directory against their conventional
    baselines (when present) and folds the exit codes: any plane's
    failure fails the gate; a plane with nothing to lint is skipped
    (exit 2 only when NOTHING was found at all)."""
    ap = argparse.ArgumentParser(
        prog="python -m gatekeeper_tpu_torch.analysis all",
        description="Run every analysis plane against a policy tree",
    )
    ap.add_argument(
        "path", nargs="?", default="deploy/policies",
        help="policy tree (default deploy/policies)",
    )
    ap.add_argument("--json", action="store_true", help="JSON output")
    args = ap.parse_args(argv)
    if not os.path.isdir(args.path):
        print(f"error: not a directory: {args.path!r}", file=sys.stderr)
        return 2

    planes = [
        ("templates", run, "analysis-baseline.json"),
        ("mutators", run_mutators, "mutators-baseline.json"),
        ("providers", run_providers, "providers-baseline.json"),
        ("corpus", run_corpus, "corpus-baseline.json"),
        ("ir", run_ir, "ir-baseline.json"),
        ("canary", run_canary, "canary-baseline.json"),
    ]
    results: Dict[str, int] = {}
    for name, fn, baseline_name in planes:
        sub_argv = [args.path]
        baseline = os.path.join(args.path, baseline_name)
        if os.path.exists(baseline):
            sub_argv += ["--baseline", baseline]
        if args.json:
            sub_argv.append("--json")
        print(f"== {name} ==")
        results[name] = fn(sub_argv)

    ran = {n: rc for n, rc in results.items() if rc != 2}
    print("\n== gate ==")
    for name, _fn, _b in planes:
        rc = results[name]
        state = "SKIP (nothing found)" if rc == 2 else (
            "OK" if rc == 0 else "FAIL"
        )
        print(f"  {name}: {state}")
    if not ran:
        print("nothing to lint", file=sys.stderr)
        return 2
    return 1 if any(rc == 1 for rc in ran.values()) else 0


def run(argv: List[str]) -> int:
    if argv and argv[0] == "mutators":
        return run_mutators(argv[1:])
    if argv and argv[0] == "providers":
        return run_providers(argv[1:])
    if argv and argv[0] == "corpus":
        return run_corpus(argv[1:])
    if argv and argv[0] == "ir":
        return run_ir(argv[1:])
    if argv and argv[0] == "canary":
        return run_canary(argv[1:])
    if argv and argv[0] == "all":
        return run_all(argv[1:])
    ap = argparse.ArgumentParser(
        prog="python -m gatekeeper_tpu_torch.analysis",
        description="Static vectorizability linter for ConstraintTemplates",
    )
    ap.add_argument("paths", nargs="+", help="template YAML files or dirs")
    ap.add_argument("--json", action="store_true", help="JSON output")
    ap.add_argument("--baseline", help="verdict manifest to compare against")
    ap.add_argument(
        "--write-baseline", help="write the current verdicts to FILE"
    )
    ap.add_argument(
        "--strict",
        action="store_true",
        help="fail on any verdict below VECTORIZED",
    )
    args = ap.parse_args(argv)

    entries = collect_templates(args.paths)
    if not entries:
        print("no ConstraintTemplates found", file=sys.stderr)
        return 2

    reports: List[Tuple[str, VectorizabilityReport]] = [
        (src, _analyze_one(src, obj)) for src, obj in entries
    ]

    failures: List[str] = []
    for _src, rep in reports:
        if rep.verdict == "INVALID":
            failures.append(f"{rep.kind}: INVALID")
        elif args.strict and rep.verdict != "VECTORIZED":
            failures.append(f"{rep.kind}: {rep.verdict} (strict)")

    baseline: Dict[str, str] = {}
    if args.baseline:
        with open(args.baseline) as f:
            baseline = (json.load(f) or {}).get("templates", {})
        for _src, rep in reports:
            want = baseline.get(rep.kind)
            if want is not None and _worse(rep.verdict, want):
                failures.append(
                    f"{rep.kind}: regressed {want} -> {rep.verdict}"
                )

    if args.write_baseline:
        manifest = {
            "templates": {
                rep.kind: rep.verdict for _src, rep in reports
            }
        }
        with open(args.write_baseline, "w") as f:
            json.dump(manifest, f, indent=2, sort_keys=True)
            f.write("\n")

    if args.json:
        print(
            json.dumps(
                {
                    "reports": [
                        dict(rep.to_dict(), source=src)
                        for src, rep in reports
                    ],
                    "failures": failures,
                },
                indent=2,
            )
        )
    else:
        for src, rep in reports:
            print(f"[{src}] {rep.render()}")
        if failures:
            print("\nFAIL:", file=sys.stderr)
            for f_ in failures:
                print(f"  {f_}", file=sys.stderr)
        else:
            counts: Dict[str, int] = {}
            for _src, rep in reports:
                counts[rep.verdict] = counts.get(rep.verdict, 0) + 1
            summary = ", ".join(
                f"{v}={counts[v]}" for v in VERDICT_ORDER if v in counts
            )
            print(f"\nOK: {len(reports)} template(s): {summary}")
    return 1 if failures else 0


def main() -> None:
    raise SystemExit(run(sys.argv[1:]))
