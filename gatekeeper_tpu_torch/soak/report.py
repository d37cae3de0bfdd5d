# Copied from gatekeeper_tpu/soak/report.py; no line below differs.
"""Soak reporting: windows, phases, leak evidence, acceptance checks.

The reporter turns two streams into one JSON artifact:

  * the generator's per-request samples (scheduled time, latency,
    status) binned into fixed windows with per-window p50/p99 and SLO
    attainment (fraction answered 200 within the deadline — misses,
    client timeouts, connection errors and unserved arrivals all count
    against it);
  * the harness sampler's per-window server-side observations (shed
    counts, breaker transitions, outbound fetches, cert generation,
    and the leak series: RSS, cache entries, trace-ring size, metrics
    series count, render-cache size).

Phases (scenario `phase` events) aggregate windows; the acceptance
checks read the conventional phase names — `fault` must degrade and
`recovery` must restore the SLO with breaker transitions logged,
`churn` must stay 5xx-free, `kill` must keep shed bounded — and the
leak checker flags any sampled series that grows monotonically across
the steady windows.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence

from .loadgen import OpenLoopLoad, Sample

# top-level fields every soak JSON must carry (the CI schema gate)
SOAK_SCHEMA_FIELDS = (
    "scenario", "windows", "phases", "slo", "shed",
    "breaker_transitions", "leak", "device_time_split", "checks",
)

# fraction of kill-phase requests allowed to fail before "bounded shed"
# flips false (a graceful drain should shed ~zero; 2% leaves room for
# the LB-flip race on a loaded box)
KILL_SHED_BOUND = 0.02

# live-vs-offline attainment agreement tolerance: the streaming engine
# and the offline binner watch the same traffic through different
# clocks (server-side windows vs client-side schedule), so exact
# equality is not expected — divergence past this is a measurement bug
LIVE_OFFLINE_TOL = 0.05

# minimum live slow-window sample count before live-vs-offline
# agreement is judged (a near-empty window proves nothing)
LIVE_MIN_SAMPLES = 50

# wire-speed ingest plane (docs/ingest.md §Soak): a framed run's
# within-deadline goodput must hold at least this fraction of the
# OFFERED open-loop rate. The firehose scenario deliberately offers
# more than one host serves (that's what "wire-speed front door" has
# to survive), so the floor judges graceful saturation — sustained
# goodput, not collapse — rather than full attainment; the smoke runs
# clear it with room
INGEST_SUSTAIN_FRAC = 0.05

# ...and the zero-copy scanner's mean per-frame decode cost must stay
# a marginal slice of the deadline budget (decode must never become
# the bottleneck the transport removed)
DECODE_SPAN_FRAC = 0.05


def _slo_target(scenario_dict: Dict[str, Any]):
    """The run's SloTarget (obs/slo.py): the scenario's deadline
    contract + any `slo` overrides — the SAME object the live
    per-replica engines judged against, so the offline checks cannot
    drift from the live plane."""
    from ..obs.slo import SloTarget

    try:
        return SloTarget.from_dict(
            (scenario_dict or {}).get("slo"),
            deadline_s=(scenario_dict or {}).get("deadline_s"),
        )
    except (ValueError, TypeError):
        return SloTarget()


def _pct(sorted_vals: Sequence[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[idx]


def bin_windows(
    samples: List[Sample],
    duration_s: float,
    window_s: float,
    deadline_s: float,
    phase_at: Optional[Dict[float, str]] = None,
) -> List[Dict[str, Any]]:
    """Samples -> per-window rows. `phase_at` maps event times to phase
    labels; a window takes the label active at its start."""
    n_windows = max(1, int(round(duration_s / window_s)))
    rows: List[Dict[str, Any]] = []
    marks = sorted((phase_at or {}).items())

    def phase_for(t: float) -> str:
        label = ""
        for at, name in marks:
            if at <= t + 1e-9:
                label = name
        return label

    buckets: List[List[Sample]] = [[] for _ in range(n_windows)]
    for s in samples:
        idx = int(s.t_rel / window_s)
        if 0 <= idx < n_windows:
            buckets[idx].append(s)
        elif idx >= n_windows:
            buckets[-1].append(s)
    for i, bucket in enumerate(buckets):
        lats = sorted(s.latency_s for s in bucket)
        ok = sum(1 for s in bucket if s.ok_within(deadline_s))
        err5xx = sum(1 for s in bucket if s.status >= 500)
        conn = sum(
            1 for s in bucket
            if s.outcome in ("conn_error", "client_timeout", "unserved")
        )
        # server-side transport failures only: a refused/reset
        # connection is the server's fault; a client_timeout/unserved
        # arrival is the load generator (or a starved CI box) giving
        # up and must not be judged as a serving error
        conn_hard = sum(1 for s in bucket if s.outcome == "conn_error")
        rows.append({
            "t0_s": round(i * window_s, 3),
            "t1_s": round((i + 1) * window_s, 3),
            "phase": phase_for(i * window_s),
            "requests": len(bucket),
            "rps": round(len(bucket) / window_s, 2),
            "p50_ms": round(_pct(lats, 0.50) * 1e3, 2),
            "p99_ms": round(_pct(lats, 0.99) * 1e3, 2),
            "slo_attainment": round(ok / len(bucket), 4) if bucket else None,
            "slo_misses": len(bucket) - ok,
            "http_5xx": err5xx,
            "transport_errors": conn,
            "conn_errors": conn_hard,
            "client_unserved": conn - conn_hard,
        })
    return rows


def aggregate_phases(windows: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    order: List[str] = []
    by_phase: Dict[str, List[Dict[str, Any]]] = {}
    for w in windows:
        p = w.get("phase") or ""
        if p not in by_phase:
            by_phase[p] = []
            order.append(p)
        by_phase[p].append(w)
    out = []
    for p in order:
        ws = by_phase[p]
        total = sum(w["requests"] for w in ws)
        ok = sum(
            w["requests"] - w["slo_misses"] for w in ws
        )
        out.append({
            "phase": p,
            "windows": len(ws),
            "requests": total,
            "slo_attainment": round(ok / total, 4) if total else None,
            "worst_p99_ms": max((w["p99_ms"] for w in ws), default=0.0),
            "best_p99_ms": min(
                (w["p99_ms"] for w in ws if w["requests"]), default=0.0
            ),
            "http_5xx": sum(w["http_5xx"] for w in ws),
            "transport_errors": sum(w["transport_errors"] for w in ws),
            # old window docs lack the split: fall back to the lumped
            # count so the strict judgement is preserved for them
            "conn_errors": sum(
                w.get("conn_errors", w.get("transport_errors", 0))
                for w in ws
            ),
            "client_unserved": sum(
                w.get("client_unserved", 0) or 0 for w in ws
            ),
            # verdict-integrity plane (docs/robustness.md §Verdict
            # integrity): canary/shadow evidence for the sdc check
            "canary_mismatches": sum(
                w.get("canary_mismatches", 0) or 0 for w in ws
            ),
            "shadow_divergences": sum(
                w.get("shadow_divergences", 0) or 0 for w in ws
            ),
            "shed": sum(w.get("shed", 0) for w in ws),
            "breaker_transitions": sum(
                w.get("breaker_transitions", 0) for w in ws
            ),
            "fetches": sum(w.get("fetches", 0) for w in ws),
            # compile plane (docs/compile.md): degraded dispatches in
            # the phase (ingest_zero_degraded's evidence) + the swap/
            # carry-forward/compile activity the churn drove
            "degraded_dispatches": sum(
                w.get("degraded_dispatches", 0) or 0 for w in ws
            ),
            "program_swaps": sum(
                w.get("program_swaps", 0) or 0 for w in ws
            ),
            "program_carryforwards": sum(
                w.get("program_carryforwards", 0) or 0 for w in ws
            ),
            "program_compiles": sum(
                w.get("program_compiles", 0) or 0 for w in ws
            ),
            # corpus static analysis: debounced background recomputes
            # completed in the phase (ingest_corpus_recompute evidence)
            "corpus_recomputes": sum(
                w.get("corpus_recomputes", 0) or 0 for w in ws
            ),
            # admission scheduler (gatekeeper_tpu/sched): the typed
            # shed split for the phase — predictive sheds are the ones
            # that provably could not make their deadline
            "sched_predicted_miss": sum(
                w.get("sched_predicted_miss", 0) or 0 for w in ws
            ),
            "sched_tenant_capped": sum(
                w.get("sched_tenant_capped", 0) or 0 for w in ws
            ),
            "sched_queue_full": sum(
                w.get("sched_queue_full", 0) or 0 for w in ws
            ),
            "tenant_classes": _phase_tenant_classes(ws),
        })
    return out


def _phase_tenant_classes(
    ws: List[Dict[str, Any]],
) -> Optional[Dict[str, Any]]:
    """Aggregate the sampler's per-window tenant-class deltas over a
    phase; attainment is server-side (decision-log judged), which is
    what the multi-tenant checks read."""
    rows = [w.get("tenant_classes") for w in ws]
    rows = [r for r in rows if r]
    if not rows:
        return None
    out: Dict[str, Any] = {}
    for cls in ("quiet", "noisy"):
        req = sum(r[cls]["requests"] for r in rows if cls in r)
        ok = sum(r[cls]["ok"] for r in rows if cls in r)
        shed = sum(r[cls]["shed"] for r in rows if cls in r)
        out[cls] = {
            "requests": req,
            "ok": ok,
            "shed": shed,
            "attainment": round(ok / req, 4) if req else None,
        }
    return out


def monotonic_growth(
    values: Sequence[float],
    tol_frac: float = 0.10,
    min_windows: int = 6,
) -> bool:
    """True when a sampled series looks like a leak: enough windows,
    (almost) never decreasing, and net growth beyond tolerance. A
    series that plateaus — cache fills to its bound, RSS settles after
    warmup — must NOT flag, which is why the nondecreasing-step ratio
    matters and not just first-vs-last."""
    vals = [float(v) for v in values if v is not None]
    if len(vals) < min_windows:
        return False
    first = vals[0]
    last = vals[-1]
    if last <= first * (1 + tol_frac) + 1e-9:
        return False
    steps = list(zip(vals, vals[1:]))
    increases = sum(1 for a, b in steps if b > a + 1e-9)
    decreases = sum(1 for a, b in steps if b < a - 1e-9)
    # a leak grows in most windows and essentially never shrinks; the
    # "essentially" absorbs one GC/eviction blip
    return increases >= len(steps) * 0.5 and decreases <= 1


def leak_report(
    window_stats: List[Dict[str, Any]],
    steady_phases: Sequence[str] = ("steady",),
    tolerances: Optional[Dict[str, float]] = None,
) -> Dict[str, Any]:
    """Per-series leak verdicts over the STEADY windows (churn/fault
    windows legitimately grow caches; judging them would cry wolf).
    Falls back to all windows when no steady phase was labeled."""
    tol = {
        "rss_kb": 0.25,  # allocator slack + lazy JAX buffers
        "cache_entries": 0.10,
        "trace_ring": 0.10,
        "metrics_series": 0.10,
        "render_cache": 0.10,
        "decision_ring": 0.10,  # bounded by construction; proven here
    }
    tol.update(tolerances or {})
    steady = [
        w for w in window_stats if (w.get("phase") or "") in steady_phases
    ]
    # a leak verdict needs enough STEADY evidence: churn/fault windows
    # legitimately grow every cache, so judging them would cry wolf.
    # With too few steady windows the curves are still reported, but
    # nothing flags — insufficient evidence is not evidence of a leak.
    sufficient = len(steady) >= 4
    judged = steady if sufficient else window_stats
    series: Dict[str, Any] = {}
    flagged = []
    for name, t in tol.items():
        vals = [w.get(name) for w in judged if w.get(name) is not None]
        growing = sufficient and monotonic_growth(vals, tol_frac=t)
        series[name] = {
            "samples": vals,
            "tolerance_frac": t,
            "monotonic_growth": growing,
        }
        if growing:
            flagged.append(name)
    return {
        "steady_windows": len(steady),
        "sufficient_steady_windows": sufficient,
        "series": series,
        "flagged": flagged,
        "flat": not flagged,
    }


def build_checks(
    phases: List[Dict[str, Any]],
    leak: Dict[str, Any],
    transitions: List[Dict[str, Any]],
    windows: List[Dict[str, Any]],
    target=None,
    scenario: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    # degrade/recover thresholds come from the shared SloTarget
    # (scenario-overridable), not hardcoded here — the live engine and
    # this reporter judge the same objective
    if target is None:
        target = _slo_target({})
    by_name = {p["phase"]: p for p in phases}
    checks: Dict[str, Any] = {}
    fault = by_name.get("fault")
    recovery = by_name.get("recovery")
    if fault and recovery:
        degraded = (
            (fault["slo_attainment"] or 0.0) < target.degraded_below
        )
        recovered = (
            (recovery["slo_attainment"] or 0.0) >= target.recovered_at
        )
        trans_in_fault = fault.get("breaker_transitions", 0) > 0 or any(
            t for t in transitions
        )
        checks["fault_window_degrades_and_recovers"] = bool(
            degraded and recovered and trans_in_fault
        )
    churn = by_name.get("churn")
    if churn:
        # judged on SERVER-side failure only: 5xx and refused/reset
        # connections. Lumping in client_timeout/unserved (the load
        # generator or a starved CI box giving up) made this check
        # flake on loaded runners for errors the server never made —
        # those now ride the separate client_unserved column.
        checks["churn_zero_5xx"] = (
            churn["http_5xx"] == 0
            and churn.get("conn_errors", churn["transport_errors"]) == 0
        )
    ingest = by_name.get("ingest")
    if ingest:
        # the zero-downtime warm-swap contract (docs/compile.md): a
        # template ingest wave serves every request — fused or host
        # rung — with zero degraded dispatches and zero 5xx while the
        # new sub-programs compile on the shadow slot and swap live
        checks["ingest_zero_degraded"] = (
            ingest.get("degraded_dispatches", 0) == 0
            and ingest["http_5xx"] == 0
        )
        # corpus static analysis (docs/analysis.md §Corpus analysis):
        # the wave's churn must trigger a corpus recompute — in the
        # background and DEBOUNCED (a handful of recomputes for a
        # hundreds-of-templates wave, never one per add) — while the
        # request path stays untouched (the latency/5xx side of that
        # claim is pinned by ingest_zero_degraded above)
        n_rec = ingest.get("corpus_recomputes", 0) or 0
        checks["ingest_corpus_recompute"] = (
            0 < n_rec <= 2 * ingest["windows"] + 2
        )
    # verdict-integrity plane (docs/robustness.md §Verdict integrity):
    # the sdc phase's injected bit-flip must be DETECTED (canary
    # mismatches recorded), the device must land in corruption
    # quarantine (a window closed with quarantined_devices > 0), and
    # by the end of the run the golden self-test must have healed it
    # (the final window shows an empty quarantine set)
    sdc = by_name.get("sdc")
    if sdc is not None:
        detected = (sdc.get("canary_mismatches", 0) or 0) > 0
        tripped = any(
            (w.get("quarantined_devices", 0) or 0) > 0 for w in windows
        )
        healed = bool(windows) and (
            (windows[-1].get("quarantined_devices", 0) or 0) == 0
        )
        checks["sdc_detected_and_quarantined"] = {
            "canary_mismatches": sdc.get("canary_mismatches", 0) or 0,
            "shadow_divergences": sdc.get("shadow_divergences", 0) or 0,
            "quarantined": tripped,
            "healed": healed,
            "holds": bool(detected and tripped and healed),
        }
    kill = by_name.get("kill")
    if kill and kill["requests"]:
        failed = (
            kill["http_5xx"] + kill["transport_errors"] + kill["shed"]
        )
        checks["replica_kill_shed_bounded"] = (
            failed / kill["requests"] <= KILL_SHED_BOUND
        )
    # multi-tenant overload (docs/operations.md §Admission scheduling):
    # judged over the `overload` phase's decision-log tenant split.
    # With the deadline policy the quiet tenant must hold the SLO
    # objective while the noisy one absorbs the shed (fair-share caps
    # + predictive shedding); the SAME scenario under fifo is the
    # baseline where both classes degrade together — the contrast the
    # acceptance criteria demand.
    overload = by_name.get("overload")
    tcls = (overload or {}).get("tenant_classes")
    if tcls and (tcls["quiet"]["requests"] or 0) >= 20:
        policy = str((scenario or {}).get("sched_policy") or "fifo")
        quiet_att = tcls["quiet"]["attainment"] or 0.0
        noisy_att = tcls["noisy"]["attainment"] or 0.0
        if policy == "deadline":
            checks["quiet_tenant_attainment_holds"] = {
                "quiet_attainment": quiet_att,
                "noisy_attainment": noisy_att,
                "noisy_shed": tcls["noisy"]["shed"],
                "objective": target.objective,
                "holds": bool(
                    quiet_att >= target.objective
                    and tcls["noisy"]["shed"] > 0
                ),
            }
        else:
            checks["fifo_baseline_degrades"] = {
                "quiet_attainment": quiet_att,
                "noisy_attainment": noisy_att,
                "objective": target.objective,
                "degrades": bool(quiet_att < target.objective),
            }
    # wire-speed ingest plane (docs/ingest.md §Soak): framed runs are
    # judged on sustained goodput and decode cost over the WHOLE run
    # (every window rides the stream transport, so no phase gate)
    if (scenario or {}).get("transport") == "framed":
        duration = float((scenario or {}).get("duration_s") or 0.0)
        offered = float((scenario or {}).get("rps") or 0.0)
        deadline_ms = (
            float((scenario or {}).get("deadline_s") or 0.0) * 1000.0
        )
        ok_total = sum(
            (w["requests"] - w["slo_misses"]) for w in windows
        )
        frames = sum(w.get("ingest_frames", 0) or 0 for w in windows)
        goodput = round(ok_total / duration, 2) if duration else 0.0
        floor = round(INGEST_SUSTAIN_FRAC * offered, 2)
        checks["ingest_rps_sustained"] = {
            "offered_rps": offered,
            "rps_sustained": goodput,
            "floor_rps": floor,
            "frames": frames,
            "holds": bool(frames > 0 and goodput >= floor),
        }
        # frame-weighted mean of the sampler's per-window decode cost
        dec_pairs = [
            (w["ingest_decode_ms_mean"], w.get("ingest_frames", 0) or 0)
            for w in windows
            if w.get("ingest_decode_ms_mean") is not None
        ]
        wsum = sum(n for _, n in dec_pairs)
        mean_ms = (
            round(sum(m * n for m, n in dec_pairs) / wsum, 4)
            if wsum else None
        )
        bound_ms = round(DECODE_SPAN_FRAC * deadline_ms, 2)
        checks["decode_span_bounded"] = {
            "decode_ms_mean": mean_ms,
            "bound_ms": bound_ms,
            "deadline_ms": deadline_ms,
            "holds": bool(mean_ms is not None and mean_ms <= bound_ms),
        }
    checks["leak_flat"] = bool(leak.get("flat"))
    steady_windows = [
        w for w in windows if (w.get("phase") or "") == "steady"
    ]
    checks["steady_seconds"] = round(
        sum(w["t1_s"] - w["t0_s"] for w in steady_windows), 1
    )
    return checks


def build_report(
    scenario_dict: Dict[str, Any],
    load: OpenLoopLoad,
    window_stats: List[Dict[str, Any]],
    transitions: List[Dict[str, Any]],
    device_time_split: Dict[str, float],
    capacity: Optional[List[Dict[str, Any]]] = None,
    faults_log: Optional[List[Dict[str, Any]]] = None,
    live_slo: Optional[Dict[str, Any]] = None,
    extra: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Merge generator samples + sampler rows into the soak artifact.
    `window_stats` rows carry server-side per-window observations and
    are matched to sample windows by index. `live_slo` is the harness's
    end-of-run rollup of the streaming engines (obs/slo.py) — when
    present it rides in `slo.live` and is cross-checked against the
    offline numbers (`live_vs_offline_attainment`,
    `capacity_live_within_model`)."""
    phase_at = {
        float(e["at"]): e.get("name", "")
        for e in scenario_dict.get("events", [])
        if e.get("action") == "phase"
    }
    windows = bin_windows(
        load.samples,
        scenario_dict["duration_s"],
        scenario_dict["window_s"],
        scenario_dict["deadline_s"],
        phase_at=phase_at,
    )
    for i, w in enumerate(windows):
        if i < len(window_stats):
            w.update(window_stats[i])
    phases = aggregate_phases(windows)
    leak = leak_report(windows)
    target = _slo_target(scenario_dict)
    checks = build_checks(
        phases, leak, transitions, windows, target=target,
        scenario=scenario_dict,
    )
    total = len(load.samples)
    ok = sum(
        1 for s in load.samples
        if s.ok_within(scenario_dict["deadline_s"])
    )
    shed_total = sum(w.get("shed", 0) for w in windows)
    report = {
        "scenario": scenario_dict,
        "open_loop": {
            "target_rps": load.target_rps,
            "achieved_rps": load.achieved_rps,
            "generated": load.generated,
            "observed": total,
        },
        "slo": {
            "deadline_s": scenario_dict["deadline_s"],
            "target": target.to_dict(),
            "attainment": round(ok / total, 4) if total else None,
            "misses": total - ok,
            "worst_window_p99_ms": max(
                (w["p99_ms"] for w in windows if w["requests"]),
                default=0.0,
            ),
        },
        "shed": {
            "total": shed_total,
            "rate": round(shed_total / total, 4) if total else 0.0,
        },
        "windows": windows,
        "phases": phases,
        "breaker_transitions": transitions,
        "faults": faults_log or [],
        "device_time_split": device_time_split,
        "leak": leak,
        "checks": checks,
    }
    if capacity is not None:
        report["capacity_model"] = capacity
    if live_slo is not None:
        report["slo"]["live"] = live_slo
        # live-vs-offline agreement: the streaming engine's
        # slow-window attainment must match what the offline binner
        # computed from the generator's samples, within tolerance
        live_att = live_slo.get("attainment_slow")
        off_att = report["slo"]["attainment"]
        if (
            live_att is not None
            and off_att is not None
            and (live_slo.get("requests_slow") or 0) >= LIVE_MIN_SAMPLES
        ):
            checks["live_vs_offline_attainment"] = {
                "live": round(live_att, 4),
                "offline": off_att,
                "tolerance": LIVE_OFFLINE_TOL,
                "agree": abs(live_att - off_att) <= LIVE_OFFLINE_TOL,
            }
        # headroom sanity vs the offline capacity model: the live
        # estimate (1 / cost EWMA) is engine-side and the model probes
        # through the full handler stack, so this is an order-of-
        # magnitude cross-check, not an equality
        cost = live_slo.get("device_seconds_per_row_ewma")
        if capacity and cost:
            model_max = max(
                (
                    row.get("max_rps_at_slo") or 0
                    for row in capacity
                ),
                default=0,
            )
            if model_max > 0:
                live_cap = 1.0 / cost
                ratio = live_cap / model_max
                checks["capacity_live_within_model"] = {
                    "live_capacity_rps": round(live_cap, 1),
                    "model_max_rps": model_max,
                    "within": 0.1 <= ratio <= 100.0,
                }
    if extra:
        report.update(extra)
    return report


def check_soak_schema(doc: Dict[str, Any]) -> List[str]:
    """Missing-field list (empty = valid). The CI gate runs this over
    both a live smoke run and the checked-in SOAK_r01.json so the
    artifact format cannot silently drift from the reader."""
    problems = []
    for f in SOAK_SCHEMA_FIELDS:
        if f not in doc:
            problems.append(f"missing field: {f}")
    slo = doc.get("slo") or {}
    for f in ("deadline_s", "attainment", "misses", "worst_window_p99_ms"):
        if f not in slo:
            problems.append(f"missing slo.{f}")
    shed = doc.get("shed") or {}
    for f in ("total", "rate"):
        if f not in shed:
            problems.append(f"missing shed.{f}")
    leak = doc.get("leak") or {}
    for f in ("series", "flagged", "flat"):
        if f not in leak:
            problems.append(f"missing leak.{f}")
    for w in doc.get("windows") or []:
        for f in ("t0_s", "phase", "requests", "p99_ms", "slo_attainment"):
            if f not in w:
                problems.append(f"window missing {f}")
                break
        break  # shape-check the first row; rows are built by one loop
    return problems


def summarize_soak(res: Dict[str, Any]) -> str:
    """The compact driver-parseable line (the bench SUMMARY contract,
    gatekeeper_tpu/summary.py): headline SLO/shed/leak numbers that
    survive a truncated capture."""
    from ..summary import format_summary

    head: Dict[str, Any] = {}
    try:
        scn = res.get("scenario") or {}
        head["scenario"] = scn.get("name")
        head["duration_s"] = scn.get("duration_s")
        ol = res.get("open_loop") or {}
        head["target_rps"] = ol.get("target_rps")
        head["achieved_rps"] = ol.get("achieved_rps")
        slo = res.get("slo") or {}
        head["slo_attainment"] = slo.get("attainment")
        head["worst_window_p99_ms"] = slo.get("worst_window_p99_ms")
        head["shed_rate"] = (res.get("shed") or {}).get("rate")
        head["breaker_transitions"] = len(
            res.get("breaker_transitions") or []
        )
        # trip-triggered postmortems captured across replicas (full
        # per-replica detail in the artifact's flight_records section)
        head["flight_records"] = sum(
            int(fr.get("captured") or 0)
            for fr in (res.get("flight_records") or [])
        )
        head["leak_flagged"] = (res.get("leak") or {}).get("flagged")
        # admission scheduler headline (optional: only runs with the
        # sched plane wired carry it — older artifacts stay valid)
        sched = res.get("sched") or {}
        if sched:
            head["sched_policy"] = sched.get("policy")
            head["predicted_miss_shed"] = sum(
                p.get("sched_predicted_miss", 0) or 0
                for p in (res.get("phases") or [])
            )
        # live SLO headline (optional: only runs with streaming
        # engines attached carry it — older artifacts stay valid)
        live = (res.get("slo") or {}).get("live") or {}
        if live:
            head["saturation"] = live.get("saturation")
            head["live_attainment"] = live.get("attainment_slow")
            head["slo_breaches"] = live.get("breaches")
        head["checks"] = res.get("checks")
    except Exception as e:  # the summary must never kill the artifact
        head["error"] = str(e)
    return format_summary("soak", head)


def parse_summary_line(line: str) -> Dict[str, Any]:
    """Round-trip reader for the soak SUMMARY line — now the soak
    instance of the shared per-mode schema contract
    (gatekeeper_tpu/summary.py enforces EVERY bench lane the same
    way). Raises on anything that is not a valid soak summary."""
    from ..summary import parse_summary_line as _parse

    return _parse(line, mode="soak")
