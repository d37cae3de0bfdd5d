"""The port's offline analysis CLI (`python -m gatekeeper_tpu_torch.analysis`)
against the JAX package's, in-process on the same inputs.

Each case of tests/test_analysis_cli.py is a case of a parametrised test
here: its steps run through both CLIs on the same files, and the port's
exit code, output and any manifest it writes must equal the reference's,
besides the reference test's own expectations. The checked-in manifests
under deploy/policies are read, never written.
"""

import json
import os

import pytest

from gatekeeper_tpu.analysis import cli as jcli
from gatekeeper_tpu_torch.analysis import cli as tcli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPLOY = os.path.join(REPO, "deploy", "policies")
BASELINE = os.path.join(DEPLOY, "analysis-baseline.json")
MUTATORS_BASELINE = os.path.join(DEPLOY, "mutators-baseline.json")
CORPUS_BASELINE = os.path.join(DEPLOY, "corpus-baseline.json")
AGENT_DIR = os.path.join(DEPLOY, "agent")
AGENT_BASELINE = os.path.join(DEPLOY, "agent-baseline.json")

INVALID_TEMPLATE = """apiVersion: templates.gatekeeper.sh/v1beta1
kind: ConstraintTemplate
metadata:
  name: badtemplate
spec:
  crd:
    spec:
      names:
        kind: BadTemplate
  targets:
    - target: admission.k8s.gatekeeper.sh
      rego: |
        package badtemplate
        violation[{"msg": msg}] {
            msg := sprintf("%v", [never_bound])
        }
"""

INV_JOIN = """apiVersion: templates.gatekeeper.sh/v1beta1
kind: ConstraintTemplate
metadata:
  name: invjoin
spec:
  crd:
    spec:
      names:
        kind: InvJoin
  targets:
    - target: admission.k8s.gatekeeper.sh
      rego: |
        package invjoin
        violation[{"msg": msg}] {
            other := data.inventory.namespace[ns][_][_][name]
            other.spec.x == input.review.object.spec.x
            msg := "dup"
        }
"""

BAD_MUTATOR = """apiVersion: mutations.gatekeeper.sh/v1alpha1
kind: Assign
metadata:
  name: broken-path
spec:
  applyTo:
    - groups: [""]
      versions: ["v1"]
      kinds: ["Pod"]
  location: "spec..containers[name *].image"
  parameters:
    assign:
      value: x
"""

CONFLICTING_PAIR = """apiVersion: mutations.gatekeeper.sh/v1alpha1
kind: Assign
metadata:
  name: obj-view
spec:
  applyTo:
    - groups: [""]
      versions: ["v1"]
      kinds: ["Pod"]
  location: spec.foo.bar
  parameters:
    assign:
      value: x
---
apiVersion: mutations.gatekeeper.sh/v1alpha1
kind: Assign
metadata:
  name: list-view
spec:
  applyTo:
    - groups: [""]
      versions: ["v1"]
      kinds: ["Pod"]
  location: "spec.foo[name: x].bar"
  parameters:
    assign:
      value: x
"""

DEAD_CONSTRAINT = """apiVersion: templates.gatekeeper.sh/v1beta1
kind: ConstraintTemplate
metadata:
  name: corpusclitest
spec:
  crd:
    spec:
      names:
        kind: CorpusCliTest
  targets:
    - target: admission.k8s.gatekeeper.sh
      rego: |
        package corpusclitest
        violation[{"msg": msg}] {
          input.review.object.spec.hostNetwork
          msg := "no hostNetwork"
        }
---
apiVersion: constraints.gatekeeper.sh/v1beta1
kind: CorpusCliTest
metadata:
  name: dead-row
spec:
  match:
    scope: Namespaced
    namespaces: ["ns-a"]
    excludedNamespaces: ["ns-a"]
"""

SYS_EXIT = "SystemExit"


def _json_codes(key, field="id"):
    def check(out):
        payload = json.loads(out)
        return {s[field]: s["codes"] for s in payload[key]}
    return check


# name -> (files under TMP, steps). A step is (argv, expected exit code,
# strings the stdout must hold, strings the stderr must hold, an optional
# check of the stdout). "{TMP}" is the case's directory, "{OUT}" a file
# the step writes (one per package, compared after the step).
CASES = {
    "shipped_templates_hold_the_baseline": ({}, [
        ([DEPLOY, "--baseline", BASELINE], 0, ["OK:"], [], None)]),
    "regression_fails": (
        {"policies/t.yaml": INV_JOIN,
         "baseline.json": json.dumps({"templates": {"InvJoin": "VECTORIZED"}})},
        [(["{TMP}/policies", "--baseline", "{TMP}/baseline.json"], 1, [],
          ["regressed VECTORIZED -> PARTIAL_ROWS"], None)]),
    "invalid_template_fails": ({"bad.yaml": INVALID_TEMPLATE}, [
        (["{TMP}"], 1, ["GK-V005"], ["INVALID"], None)]),
    "write_baseline_round_trips": ({}, [
        ([DEPLOY, "--write-baseline", "{OUT}"], 0, [], [],
         None)]),
    "json_output": ({}, [
        ([DEPLOY, "--json"], 0, [], [],
         lambda out: {r["kind"]: r["verdict"] for r in
                      json.loads(out)["reports"]}["GTNoLatestTag"]
         == "VECTORIZED")]),
    "no_templates_found": ({}, [(["{TMP}"], 2, [], [], None)]),
    "mutators_shipped_examples_hold_the_baseline": ({}, [
        (["mutators", DEPLOY, "--baseline", MUTATORS_BASELINE], 0, ["OK:"],
         [], None)]),
    "mutators_path_error_reported": ({"bad.yaml": BAD_MUTATOR}, [
        (["mutators", "{TMP}"], 1, ["GK-M001"], [], None)]),
    "mutators_conflict_reported_json": ({"pair.yaml": CONFLICTING_PAIR}, [
        (["mutators", "{TMP}", "--json"], 1, [], [],
         lambda out: (lambda c: c["Assign/obj-view"] == ["GK-M006"]
                      and c["Assign/list-view"] == ["GK-M006"])(
             _json_codes("mutators")(out)))]),
    "mutators_baseline_pins_regressions": (
        {"pair.yaml": CONFLICTING_PAIR,
         "clean.json": json.dumps({"mutators": {
             "Assign/obj-view": [], "Assign/list-view": []}})},
        [(["mutators", "{TMP}", "--baseline", "{TMP}/clean.json"], 1, [],
          ["GK-M006"], None),
         (["mutators", "{TMP}", "--write-baseline", "{TMP}/pinned.json"],
          1, [], [], None),
         (["mutators", "{TMP}", "--baseline", "{TMP}/pinned.json"], 0, [],
          [], None)]),
    "mutators_none_found": ({}, [(["mutators", "{TMP}"], 2, [], [], None)]),
    "unsupported_path_rejected": ({"notes.txt": "hi"}, [
        (["{TMP}/notes.txt"], SYS_EXIT, [], [], None)]),
    "agent_library_holds_the_baseline": ({}, [
        ([AGENT_DIR, "--baseline", AGENT_BASELINE], 0, ["OK:"], [], None)]),
    "corpus_shipped_policies_hold_the_baseline": ({}, [
        (["corpus", DEPLOY, "--baseline", CORPUS_BASELINE], 0, ["OK:"], [],
         None)]),
    "corpus_dead_constraint_flagged_then_baselined": (
        {"corpus.yaml": DEAD_CONSTRAINT},
        [(["corpus", "{TMP}"], 1, ["GK-C006"], [], None),
         (["corpus", "{TMP}", "--write-baseline", "{TMP}/pinned.json"], 1,
          [], [], None),
         (["corpus", "{TMP}", "--baseline", "{TMP}/pinned.json"], 0, [], [],
          None)]),
    "corpus_json_output": ({"corpus.yaml": DEAD_CONSTRAINT}, [
        (["corpus", "{TMP}", "--json"], 1, [], [],
         lambda out: (lambda c: c["constraint:CorpusCliTest/dead-row"]
                      == ["GK-C006"] and c["template:CorpusCliTest"] == [])(
             _json_codes("corpus")(out)))]),
    "corpus_none_found": ({}, [(["corpus", "{TMP}"], 2, [], [], None)]),
    "all_gate_over_shipped_policies": ({}, [
        (["all", DEPLOY], 0,
         [f"== {p} ==" for p in ("templates", "mutators", "providers",
                                 "corpus", "ir")] + ["== gate =="], [],
         None)]),
    "all_gate_fails_on_any_plane": ({"corpus.yaml": DEAD_CONSTRAINT}, [
        (["all", "{TMP}"], 1, ["GK-C006"], [], None)]),
    "all_gate_empty_dir": ({}, [(["all", "{TMP}"], 2, [], [], None)]),
}


def _run(cli, argv, capsys):
    try:
        rc = cli.run(argv)
    except SystemExit:
        rc = SYS_EXIT
    got = capsys.readouterr()
    return rc, got.out, got.err


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_case_matches_jax(case, tmp_path, capsys):
    """One case of tests/test_analysis_cli.py through both CLIs: the
    reference test's expectations hold for the port, and exit code,
    stdout, stderr and any written manifest equal the reference's."""
    files, steps = CASES[case]
    for rel, text in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
    for argv, want_rc, out_has, err_has, check in steps:
        results = {}
        for tag, cli in (("jax", jcli), ("torch", tcli)):
            out_file = tmp_path / f"out-{tag}.json"
            args = [a.replace("{TMP}", str(tmp_path))
                     .replace("{OUT}", str(out_file)) for a in argv]
            results[tag] = _run(cli, args, capsys)
            if out_file.exists():
                results[tag] += (out_file.read_text(),)
        rc, out, err = results["torch"][:3]
        assert rc == want_rc, (argv, out, err)
        for s in out_has:
            assert s in out, (s, out)
        for s in err_has:
            assert s in err, (s, err)
        if check is not None:
            assert check(out), out
        assert results["torch"] == results["jax"], argv
    if case == "write_baseline_round_trips":
        with open(BASELINE) as g:
            assert json.loads(results["torch"][3]) == json.load(g)


def _current_templates(path):
    return {
        rep.kind: rep.verdict
        for rep in (tcli._analyze_one(src, obj)
                    for src, obj in tcli.collect_templates([path]))
    }


def _current_mutators():
    from gatekeeper_tpu_torch.mutation.lint import lint_mutators

    return {l.id: sorted(l.codes)
            for l in lint_mutators(tcli.collect_mutators([DEPLOY]))}


def _current_corpus():
    from gatekeeper_tpu_torch.analysis.corpus import corpus_from_docs

    report = corpus_from_docs(
        [(s, o) for s, o in tcli.collect_templates([DEPLOY])
         if isinstance(o, dict)],
        tcli.collect_constraints([DEPLOY]),
        tcli.collect_mutators([DEPLOY]),
        tcli.collect_providers([DEPLOY]),
    )
    return {l.id: sorted(l.codes) for l in report.lints}


MANIFESTS = {
    "baseline_manifest_is_current": (
        BASELINE, "templates", lambda: _current_templates(DEPLOY)),
    "mutators_baseline_manifest_is_current": (
        MUTATORS_BASELINE, "mutators", _current_mutators),
    "agent_baseline_manifest_is_current": (
        AGENT_BASELINE, "templates", lambda: _current_templates(AGENT_DIR)),
    "corpus_baseline_manifest_is_current": (
        CORPUS_BASELINE, "corpus", _current_corpus),
}


@pytest.mark.parametrize("case", sorted(MANIFESTS))
def test_checked_in_manifest_is_current_for_the_port(case):
    """The checked-in manifests equal what the port's planes say today."""
    path, key, current = MANIFESTS[case]
    with open(path) as f:
        recorded = json.load(f)[key]
    assert current() == recorded
    if case == "agent_baseline_manifest_is_current":
        for kind in ("AgentShellAllowlist", "AgentNetworkDomains",
                     "AgentRequireSignedSkills", "AgentArgShape"):
            assert recorded.get(kind) == "VECTORIZED", kind
        assert recorded.get("AgentVerifiedSkills") == "PARTIAL_ROWS"


def test_reference_library_ports_pinned_vectorized():
    """The four ported reference-library policies compile to the fused
    path in the port as recorded in the main baseline."""
    current = _current_templates(DEPLOY)
    for kind in ("K8sRequiredLabels", "K8sAllowedRepos", "K8sBlockNodePort",
                 "K8sPSPPrivileged"):
        assert current.get(kind) == "VECTORIZED", kind


@pytest.mark.parametrize(
    "plane", ["templates", "mutators", "providers", "corpus", "ir", "canary",
              "all"])
def test_json_and_exit_code_equal_jax_on_deploy_policies(plane, capsys):
    """Both CLIs' `--json` output and exit code on deploy/policies: equal
    lint codes per template, mutator, provider and subject."""
    argv = ([] if plane == "templates" else [plane]) + [DEPLOY, "--json"]
    assert _run(tcli, argv, capsys) == _run(jcli, argv, capsys)
