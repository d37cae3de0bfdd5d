"""Verdict-first routing on the port, on the CPU, against the JAX package:

  * the port's `analyze_template` equals `gatekeeper_tpu.analysis`'s
    (verdict, diagnostic codes, external calls) on the analyzer's golden
    templates, the in-repo templates, the host-filesystem join and the
    two uniqueness joins;
  * the port's Client rejects an unsafe-variable template (GK-V005) with
    InvalidTemplateError, as the JAX Client does, and reports the same
    verdicts for the templates it accepts;
  * after the same add_template/add_constraint sequence, TorchDriver's
    routing (which constraints interpret), fallback codes and
    analyzer_mismatches equal TpuDriver's, including for a template the
    compiler refuses though the analyzer called it compilable.
"""

import dataclasses

import pytest

import chip_smoke
from test_analysis import (
    CLEAN,
    G_V001,
    G_V007,
    GOLDEN_PARAMS,
    GOLDENS,
    _constraint_for,
    make_template,
)
from gatekeeper_tpu import analysis as janalysis
from gatekeeper_tpu.constraint import (
    Backend as JBackend,
    InvalidTemplateError as JInvalidTemplateError,
    K8sValidationTarget as JTarget,
)
from gatekeeper_tpu.constraint import tpudriver as jtpudriver
from gatekeeper_tpu.constraint.tpudriver import TpuDriver
from gatekeeper_tpu_torch import analysis as tanalysis
from gatekeeper_tpu_torch.constraint import (
    Backend as TBackend,
    InvalidTemplateError as TInvalidTemplateError,
    K8sValidationTarget as TTarget,
)
from gatekeeper_tpu_torch.constraint import torchdriver as ttorchdriver
from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver
from gatekeeper_tpu_torch.metrics import MetricsRegistry

TARGET = chip_smoke.TARGET


def _fixtures():
    out = [(kind, make_template(kind, rego)) for kind, rego, _, _ in GOLDENS]
    for doc in chip_smoke.template_docs():
        out.append((doc["spec"]["crd"]["spec"]["names"]["kind"], doc))
    out.append(("K8sPSPHostFilesystem", chip_smoke.hostfs_template()))
    for doc in chip_smoke.uniqueness_templates():
        out.append((doc["spec"]["crd"]["spec"]["names"]["kind"], doc))
    return out


FIXTURES = _fixtures()


def _summary(rep):
    return (
        rep.kind,
        rep.verdict,
        rep.codes,
        [(d.code, d.severity, d.message) for d in rep.diagnostics],
        [dataclasses.asdict(c) for c in rep.external_calls],
        rep.render(),
    )


@pytest.mark.parametrize("kind,doc", FIXTURES, ids=[k for k, _ in FIXTURES])
def test_analyze_template_equals_reference(kind, doc):
    got = tanalysis.analyze_template(doc)
    want = janalysis.analyze_template(doc)
    assert _summary(got) == _summary(want)
    assert got.compilable == want.compilable
    assert got.primary_code() == want.primary_code()


def test_fixtures_cover_every_verdict():
    verdicts = {tanalysis.analyze_template(d).verdict for _, d in FIXTURES}
    assert verdicts == {
        tanalysis.VECTORIZED, tanalysis.PARTIAL_ROWS,
        tanalysis.INTERPRETER, tanalysis.INVALID,
    }


@pytest.mark.parametrize("driver", ["torch", "interp"])
def test_client_rejects_unsafe_variable_template(driver):
    """ROADMAP C2: the port's Client mounted templates without the
    admission-time analysis and accepted GK-V005, which the JAX Client
    rejects."""
    from gatekeeper_tpu_torch.constraint import RegoDriver

    drv = TorchDriver(device="cpu") if driver == "torch" else RegoDriver()
    client = TBackend(drv).new_client(TTarget())
    doc = make_template("K8sUnsafe", GOLDENS[5][1])
    with pytest.raises(TInvalidTemplateError) as got:
        client.add_template(doc)
    j_client = JBackend(TpuDriver(use_jax=False)).new_client(JTarget())
    with pytest.raises(JInvalidTemplateError) as want:
        j_client.add_template(doc)
    assert "GK-V005" in str(got.value)
    assert str(got.value) == str(want.value)
    assert client.known_templates() == []


def test_template_reports_equal_reference():
    t_client = TBackend(TorchDriver(device="cpu")).new_client(TTarget())
    j_client = JBackend(TpuDriver(use_jax=False)).new_client(JTarget())
    for kind, doc in FIXTURES:
        if janalysis.analyze_template(doc).verdict == janalysis.INVALID:
            continue
        t_client.add_template(doc)
        j_client.add_template(doc)
    got = {k: _summary(r) for k, r in t_client.template_reports().items()}
    want = {k: _summary(r) for k, r in j_client.template_reports().items()}
    assert got == want
    assert None not in got.values()
    assert t_client.template_report("k8swithmod").verdict == "INTERPRETER"


def _routing(client, drv):
    """Which constraints interpret, why, and the mismatch count, after
    the golden templates and one constraint each."""
    for kind, rego, verdict, _ in GOLDENS:
        if verdict == janalysis.INVALID:
            continue
        client.add_template(make_template(kind, rego))
        client.add_constraint(_constraint_for(kind, GOLDEN_PARAMS.get(kind)))
    cs = drv._constraint_set(TARGET)
    return (
        [(c["kind"], p is None) for c, p in zip(cs.constraints, cs.programs)],
        cs.fallback_codes,
        drv.analyzer_mismatches,
    )


def test_fallback_codes_equal_reference():
    t_drv, j_drv = TorchDriver(device="cpu"), TpuDriver()
    got = _routing(TBackend(t_drv).new_client(TTarget()), t_drv)
    want = _routing(JBackend(j_drv).new_client(JTarget()), j_drv)
    assert got == want
    assert got[1] == {
        "K8sDeepJoin": "GK-V003", "K8sDynRef": "GK-V004",
        "K8sWithMod": "GK-V007",
    }
    assert got[2] == 0
    # an INTERPRETER verdict routes before any compile
    assert t_drv.program_compiles == j_drv.program_compiles


def _mismatch(client, drv, module, monkeypatch):
    """A template the analyzer calls VECTORIZED whose compile is made to
    give up: a counted mismatch, and the template interprets."""
    real = module.compile_program

    def refuse(env, mods, params):
        if env.template_kind == "K8sCleanDeny":
            raise module.CompileUnsupported("refused for the test")
        return real(env, mods, params)

    monkeypatch.setattr(module, "compile_program", refuse)
    client.add_template(make_template("K8sCleanDeny", CLEAN))
    client.add_template(make_template("K8sJsonMarshal", G_V001))
    client.add_template(make_template("K8sWithMod", G_V007))
    for kind in ("K8sCleanDeny", "K8sJsonMarshal", "K8sWithMod"):
        client.add_constraint(_constraint_for(kind, GOLDEN_PARAMS.get(kind)))
    client.add_data(chip_smoke.make_pod(3))
    client.audit()
    return (
        drv.analyzer_mismatches,
        drv.stats["fallback_codes"],
        drv.stats["analyzer_mismatches"],
        sorted(chip_smoke.result_key(r) for r in client.audit().results()),
    )


def test_analyzer_mismatch_equals_reference(monkeypatch):
    t_drv, j_drv = TorchDriver(device="cpu"), TpuDriver()
    got = _mismatch(TBackend(t_drv).new_client(TTarget()), t_drv,
                    ttorchdriver, monkeypatch)
    want = _mismatch(JBackend(j_drv).new_client(JTarget()), j_drv,
                     jtpudriver, monkeypatch)
    assert got == want
    assert got[0] == 1
    assert got[1] == {"K8sCleanDeny": "GK-V999", "K8sWithMod": "GK-V007"}


def test_verdict_and_fallback_metrics():
    metrics = MetricsRegistry()
    drv = TorchDriver(device="cpu", metrics=metrics)
    client = TBackend(drv).new_client(TTarget())
    client.add_template(make_template("K8sWithMod", G_V007))
    client.add_constraint(_constraint_for("K8sWithMod"))
    drv._constraint_set(TARGET)
    snap = metrics.snapshot()
    assert snap["gauges"][
        'template_vectorization{kind="K8sWithMod",verdict="INTERPRETER"}'
    ] == 1
    assert snap["counters"][
        'template_fallback_total{code="GK-V007",kind="K8sWithMod"}'
    ] == 1
