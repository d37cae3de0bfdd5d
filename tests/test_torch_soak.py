"""The port's soak modules (gatekeeper_tpu_torch/soak/{scenario,loadgen,
report}.py) against the JAX package's, as tests/test_soak.py drives them
(its scenario, open-loop and report cases), on both packages: every
built-in scenario, every rejected scenario and its error, the open-loop
schedule per seed, and the report's windows, phases, leak verdicts,
checks, schema lint and SUMMARY line on the same seeded samples, exactly.
The harness (SoakHarness, run_soak) is not ported yet (ROADMAP A10)."""

import copy
import time

import numpy as np
import pytest

import gatekeeper_tpu.soak as rsoak
import gatekeeper_tpu_torch.soak as tsoak
from gatekeeper_tpu.soak import loadgen as rload
from gatekeeper_tpu.soak import report as rrep
from gatekeeper_tpu.soak import scenario as rscn
from gatekeeper_tpu_torch.soak import loadgen as tload
from gatekeeper_tpu_torch.soak import report as trep
from gatekeeper_tpu_torch.soak import scenario as tscn

PKGS = {"jax": (rscn, rload, rrep), "torch": (tscn, tload, trep)}

BUILT_IN = (
    ("default_scenario", ()),
    ("smoke_scenario", ()),
    ("sdc_smoke_scenario", ()),
    ("multi_tenant_overload_scenario", ("deadline",)),
    ("multi_tenant_overload_scenario", ("fifo",)),
    ("multi_tenant_smoke_scenario", ("deadline",)),
    ("multi_tenant_smoke_scenario", ("fifo",)),
    ("high_rate_scenario", ()),
    ("high_rate_smoke_scenario", ()),
)


def test_package_exports_equal_minus_the_harness():
    names = set(rsoak.__dict__) - {"harness", "SoakHarness", "run_soak"}
    public = {n for n in names if not n.startswith("_")}
    assert public == {n for n in tsoak.__dict__ if not n.startswith("_")}
    assert tsoak.ACTIONS == rsoak.ACTIONS
    assert tscn.PLANES == rscn.PLANES
    assert trep.SOAK_SCHEMA_FIELDS == rrep.SOAK_SCHEMA_FIELDS
    for name in ("KILL_SHED_BOUND", "LIVE_OFFLINE_TOL", "LIVE_MIN_SAMPLES",
                 "INGEST_SUSTAIN_FRAC", "DECODE_SPAN_FRAC"):
        assert getattr(trep, name) == getattr(rrep, name)
    for name in ("UNSERVED", "CONN_ERROR", "CLIENT_TIMEOUT"):
        assert getattr(tload, name) == getattr(rload, name)


# -- scenario ----------------------------------------------------------------


@pytest.mark.parametrize("name,args", BUILT_IN)
def test_built_in_scenarios_equal(name, args):
    ref = getattr(rscn, name)(*args)
    got = getattr(tscn, name)(*args)
    assert got.to_dict() == ref.to_dict()
    again = tscn.Scenario.from_dict(got.to_dict())
    assert again.to_dict() == got.to_dict()
    assert got.slo_target().to_dict() == ref.slo_target().to_dict()
    assert [e.to_dict() for e in got.events] == [
        e.to_dict() for e in ref.events]


def test_smoke_scenario_keeps_its_device_floor_knob():
    """min_device_batch is kept and round-trips as in the reference (a
    harness reads it; nothing here lowers anything)."""
    assert tscn.sdc_smoke_scenario().min_device_batch == 1
    assert tscn.default_scenario().to_dict()["min_device_batch"] == 2
    assert tscn.smoke_scenario().min_device_batch is None


def _base(**kw):
    d = {"duration_s": 10, "rps": 5}
    d.update(kw)
    return d


REJECTED = [
    _base(events=[{"at": 1, "action": "explode"}]),
    _base(events=[{"at": 11, "action": "disarm_faults"}]),
    _base(replicas=1, events=[{"at": 1, "action": "kill_replica",
                               "replica": 3}]),
    _base(nope=1),
    _base(duration_s=0),
    _base(rps=-1),
    _base(deadline_s=0),
    _base(window_s=11),
    _base(window_s=0),
    _base(replicas=0),
    _base(planes={"validation": 1.0, "video": 1.0}),
    _base(planes={"validation": 0.0}),
    _base(sched_policy="lifo"),
    _base(transport="udp"),
    _base(transport="framed", tls=True),
    _base(tenants={"noisy_fraction": 1.5}),
    _base(tenants={"noisy_fraction": 0.0}),
    _base(slo={"objectiv": 0.99}),
    _base(events=[{"at": 1, "action": "quarantine_device"}]),
    _base(partitions=2, events=[{"at": 1, "action": "heal_device",
                                 "device": 2}]),
    _base(partitions=2, events=[{"at": 1, "action": "selftest_device",
                                 "device": -1}]),
    _base(events=["phase"]),
    _base(events=[{"at": "soon", "action": "phase", "name": "x"}]),
    _base(events=[{"at": -1, "action": "phase", "name": "x"}]),
    _base(events=[{"at": 1, "action": "phase"}]),
    _base(events=[{"at": 1, "action": "arm_fault", "mode": "error"}]),
]


def _load_outcome(mod, doc):
    try:
        return ("ok", mod.Scenario.from_dict(copy.deepcopy(doc)).to_dict())
    except Exception as e:  # the same type and message, or the test fails
        return ("raise", type(e).__name__, str(e))


@pytest.mark.parametrize("doc", REJECTED, ids=range(len(REJECTED)))
def test_rejected_scenarios_raise_the_same_error(doc):
    got = _load_outcome(tscn, doc)
    assert got[0] == "raise", got
    assert got == _load_outcome(rscn, doc)


def test_accepted_edge_scenarios_equal():
    docs = [
        _base(window_s=10, partitions=2, events=[
            {"at": 10, "action": "quarantine_device", "device": 1},
            {"at": 0, "action": "phase", "name": "steady"}]),
        _base(transport="framed", tenants={"noisy_fraction": 0.5},
              sched_policy="deadline", slo={"objective": 0.95}),
        _base(replicas=2, events=[{"at": 2, "action": "kill_replica",
                                   "replica": 1}]),
    ]
    for doc in docs:
        got = _load_outcome(tscn, doc)
        assert got[0] == "ok" and got == _load_outcome(rscn, doc)


def test_load_scenario_file(tmp_path):
    import json

    path = tmp_path / "scn.json"
    path.write_text(json.dumps(rscn.smoke_scenario().to_dict()))
    assert tscn.load_scenario(str(path)).to_dict() == rscn.load_scenario(
        str(path)).to_dict()


# -- open loop ---------------------------------------------------------------


def _zero_clock():
    """time.monotonic() shifted so that its first reading (run_open_loop's
    t0) is exactly 0.0: each sample's t_rel is then the sum of its seeded
    gaps, the same floats in both packages."""
    base = []

    def clock():
        now = time.monotonic()
        if not base:
            base.append(now)
        return now - base[0]

    return clock


@pytest.mark.parametrize("seed", [0, 5, 99])
def test_open_loop_schedule_equal_per_seed(seed):
    planes = {"validation": 0.7, "mutation": 0.15, "agent": 0.15}

    def immediate(_plane):
        return 200, "ok"

    runs = {}
    for name, (_scn, load, _rep) in PKGS.items():
        res = load.run_open_loop(
            immediate, rps=400, duration_s=0.25, deadline_s=1.0,
            planes=planes, seed=seed, clock=_zero_clock())
        runs[name] = (res.generated, res.target_rps, res.duration_s,
                      [(s.t_rel, s.plane, s.status, s.outcome)
                       for s in res.samples])
    assert runs["torch"] == runs["jax"]
    generated, _, _, samples = runs["torch"]
    assert generated == len(samples) > 50
    assert {p for _, p, _, _ in samples} == set(planes)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_open_loop_holds_rate_against_slow_system(pkg):
    """A slow submit must not slow the arrival rate: misses are counted,
    never back-pressured away (tests/test_soak.py, on each package)."""
    load = PKGS[pkg][1]

    def slow(_plane):
        time.sleep(0.05)
        return 200, "ok"

    res = load.run_open_loop(slow, rps=100, duration_s=1.0, deadline_s=0.01,
                             seed=7, max_workers=2, drain_s=0.5)
    assert res.generated > 60
    assert len(res.samples) == res.generated
    assert res.slo_attainment() < 0.8
    assert any(s.outcome == "unserved" for s in res.samples)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_open_loop_latency_includes_queue_wait(pkg):
    load = PKGS[pkg][1]

    def slow(_plane):
        time.sleep(0.03)
        return 200, "ok"

    res = load.run_open_loop(slow, rps=60, duration_s=0.6, deadline_s=1.0,
                             seed=3, max_workers=1, drain_s=3.0)
    served = [s for s in res.samples if s.outcome == "ok"]
    assert served and max(s.latency_s for s in served) > 0.08


def test_open_loop_submit_exception_is_conn_error_in_both():
    def boom(_plane):
        raise OSError("refused")

    out = {}
    for name, (_scn, load, _rep) in PKGS.items():
        res = load.run_open_loop(boom, rps=80, duration_s=0.3, deadline_s=0.5,
                                 seed=11, clock=_zero_clock())
        assert res.samples and res.slo_attainment() == 0.0
        out[name] = [(s.t_rel, s.status, s.outcome) for s in res.samples]
    assert out["torch"] == out["jax"]
    assert {o for _, _, o in out["torch"]} == {"conn_error"}


def test_open_loop_stop_event_ends_the_schedule():
    import threading

    for _scn, load, _rep in PKGS.values():
        stop = threading.Event()
        stop.set()
        res = load.run_open_loop(lambda p: (200, "ok"), rps=100,
                                 duration_s=5.0, deadline_s=0.5,
                                 stop_event=stop)
        assert res.generated == 0 and res.samples == []
        assert res.achieved_rps == 0.0 and res.slo_attainment() == 0.0


# -- report ------------------------------------------------------------------


def _samples(mod, scn: dict, seed: int):
    """One seeded sample list over the scenario's whole length: arrival
    offsets, planes, latencies around the deadline and every outcome the
    generator makes (200s, 5xx, shed 429s, transport errors, client
    timeouts, unserved arrivals)."""
    rng = np.random.default_rng(seed)
    dur, rps = float(scn["duration_s"]), float(scn["rps"])
    n = int(min(4000, dur * rps))
    t_rel = np.sort(rng.random(n) * dur * 1.02)
    lat = rng.lognormal(np.log(scn["deadline_s"] * 0.6), 0.6, n)
    pick = rng.random(n)
    planes = list(scn["planes"])
    out = []
    for i in range(n):
        if pick[i] < 0.84:
            status, outcome = 200, ("ok" if pick[i] < 0.7 else "denied")
        elif pick[i] < 0.9:
            status, outcome = 503, "ok"
        elif pick[i] < 0.93:
            status, outcome = 429, "ok"
        elif pick[i] < 0.95:
            status, outcome = 0, "conn_error"
        elif pick[i] < 0.97:
            status, outcome = 0, "client_timeout"
        else:
            status, outcome = 0, "unserved"
        out.append(mod.Sample(
            t_rel=float(t_rel[i]), plane=planes[i % len(planes)],
            latency_s=float(lat[i]), status=status, outcome=outcome))
    return out


def _window_stats(scn: dict, seed: int):
    """Seeded server-side per-window rows with every column the checks
    and the leak report read."""
    rng = np.random.default_rng(1000 + seed)
    n = max(1, int(round(scn["duration_s"] / scn["window_s"])))
    rows = []
    rss = 100_000.0
    for i in range(n):
        rss += float(rng.integers(-50, 400))
        q, y = (int(x) for x in rng.integers(20, 80, size=2))
        rows.append({
            "shed": int(rng.integers(0, 4)),
            "breaker_transitions": int(rng.integers(0, 2)),
            "fetches": int(rng.integers(0, 9)),
            "degraded_dispatches": int(rng.integers(0, 2)),
            "program_swaps": int(rng.integers(0, 3)),
            "program_carryforwards": int(rng.integers(0, 3)),
            "program_compiles": int(rng.integers(0, 3)),
            "corpus_recomputes": int(rng.integers(0, 2)),
            "sched_predicted_miss": int(rng.integers(0, 5)),
            "sched_tenant_capped": int(rng.integers(0, 5)),
            "sched_queue_full": int(rng.integers(0, 3)),
            "tenant_classes": {
                "quiet": {"requests": q, "ok": q - int(rng.integers(0, 3)),
                          "shed": int(rng.integers(0, 2))},
                "noisy": {"requests": y, "ok": y - int(rng.integers(0, 30)),
                          "shed": int(rng.integers(0, 9))},
            },
            "canary_mismatches": int(rng.integers(0, 2)),
            "shadow_divergences": int(rng.integers(0, 2)),
            "quarantined_devices": (0 if i == n - 1
                                    else int(rng.integers(0, 2))),
            "ingest_frames": int(rng.integers(0, 500)),
            "ingest_decode_ms_mean": round(float(rng.random()) * 0.02, 5),
            "rss_kb": rss,
            "cache_entries": int(rng.integers(10, 60)),
            "trace_ring": 4096,
            "metrics_series": 200 + i,
            "render_cache": int(rng.integers(0, 100)),
            "decision_ring": 1024,
        })
    return rows


def _scenario_docs():
    return [getattr(rscn, name)(*args).to_dict() for name, args in BUILT_IN]


def _split():
    return {"dispatch": 1.25, "encode": 0.5, "render": 0.25}


@pytest.mark.parametrize("k", range(len(BUILT_IN)))
def test_report_pieces_equal_on_seeded_samples(k):
    scn = _scenario_docs()[k]
    phase_at = {float(e["at"]): e.get("name", "")
                for e in scn["events"] if e.get("action") == "phase"}
    stats = _window_stats(scn, k)
    out = {}
    for name, (_scn, load, rep) in PKGS.items():
        samples = _samples(load, scn, k)
        windows = rep.bin_windows(samples, scn["duration_s"],
                                  scn["window_s"], scn["deadline_s"],
                                  phase_at=phase_at)
        for i, w in enumerate(windows):
            w.update(stats[i])
        phases = rep.aggregate_phases(windows)
        leak = rep.leak_report(windows)
        leak_all = rep.leak_report(windows, steady_phases=(
            "steady", "overload", "firehose"), tolerances={"rss_kb": 0.01})
        target = rep._slo_target(scn)
        transitions = [{"t": 4.2, "from": "closed", "to": "open"}]
        checks = rep.build_checks(phases, leak, transitions, windows,
                                  target=target, scenario=scn)
        out[name] = (windows, phases, leak, leak_all, target.to_dict(),
                     checks)
    assert out["torch"] == out["jax"]
    phases = out["torch"][1]
    assert sum(p["requests"] for p in phases) > 0


@pytest.mark.parametrize("k", range(len(BUILT_IN)))
def test_build_report_schema_and_summary_equal(k):
    scn = _scenario_docs()[k]
    stats = _window_stats(scn, k)
    capacity = [{"constraints": 10, "max_rps_at_slo": 120},
                {"constraints": 100, "max_rps_at_slo": 80}]
    live = {"attainment_slow": 0.81, "requests_slow": 400,
            "device_seconds_per_row_ewma": 0.002, "saturation": 0.4,
            "breaches": 1}
    out = {}
    for name, (_scn, load, rep) in PKGS.items():
        samples = _samples(load, scn, k)
        res = load.OpenLoopLoad(
            target_rps=scn["rps"], duration_s=scn["duration_s"],
            deadline_s=scn["deadline_s"], generated=len(samples),
            samples=samples)
        plain = rep.build_report(scn, res, [], [], _split())
        full = rep.build_report(
            scn, res, stats, [{"t": 1.0, "to": "open"}], _split(),
            capacity=capacity, faults_log=[{"at": 4.1, "point": "x"}],
            live_slo=live,
            extra={"sched": {"policy": scn["sched_policy"]},
                   "flight_records": [{"captured": 2}, {"captured": 1}]})
        lines = [rep.summarize_soak(plain), rep.summarize_soak(full),
                 rep.summarize_soak({"scenario": 5})]
        parsed = []
        for line in lines:
            try:
                parsed.append(rep.parse_summary_line(line))
            except ValueError as e:
                parsed.append(("raise", str(e)))
        out[name] = (plain, full, rep.check_soak_schema(plain),
                     rep.check_soak_schema(full), lines, parsed,
                     res.achieved_rps, res.slo_attainment())
    assert out["torch"] == out["jax"]
    plain, full, lint_plain, lint_full, lines, parsed, _, _ = out["torch"]
    assert lint_plain == [] and lint_full == []
    assert parsed[0]["mode"] == "soak"
    assert parsed[0]["scenario"] == scn["name"]
    assert "live_vs_offline_attainment" in full["checks"]


def test_schema_lint_of_broken_documents_equal():
    good = trep.build_report(
        rscn.smoke_scenario().to_dict(),
        tload.OpenLoopLoad(target_rps=30, duration_s=12.5, deadline_s=0.5),
        [], [], {})
    broken = [{}, {"slo": {}, "shed": {}}, dict(good, windows=[{"t0_s": 0}])]
    for field in ("slo", "shed", "leak", "checks"):
        broken.append({k: v for k, v in good.items() if k != field})
    for doc in broken:
        assert trep.check_soak_schema(doc) == rrep.check_soak_schema(doc)
        assert trep.check_soak_schema(doc)
    for line in ("not a summary", 'SUMMARY: {"mode": "webhook"}',
                 'SUMMARY: {"mode": "soak"}'):
        with pytest.raises(ValueError) as t_err:
            trep.parse_summary_line(line)
        with pytest.raises(ValueError) as r_err:
            rrep.parse_summary_line(line)
        assert str(t_err.value) == str(r_err.value)


@pytest.mark.parametrize("seed", range(4))
def test_monotonic_growth_equal_on_seeded_series(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        n = int(rng.integers(1, 12))
        steps = rng.normal(float(rng.normal(0, 5)), 4.0, n)
        vals = list(100.0 + np.cumsum(steps))
        if rng.random() < 0.2:
            vals[int(rng.integers(0, n))] = None
        tol = float(rng.random()) * 0.2
        assert trep.monotonic_growth(vals, tol_frac=tol) == \
            rrep.monotonic_growth(vals, tol_frac=tol)
    assert trep.monotonic_growth([100, 120, 140, 160, 180, 200, 220])
    assert not trep.monotonic_growth([100, 200, 256, 256, 256, 256, 256])
