# Copied from gatekeeper_tpu/soak/__init__.py; only these edits differ.
# Edit: the harness (`soak/harness.py`: `SoakHarness`, `run_soak`) is not
# ported yet (ROADMAP A10), so neither is imported or named here; the
# docstring says what the package holds until then. The three modules
# below are copies with no line changed; `report` reads this package's
# `summary` and `obs.slo.SloTarget`, `scenario` its `sched.POLICIES`.
# A scenario's `min_device_batch` is kept and validated as the
# reference's; only a harness reads it, and the port sends every
# micro-batch to the device (webhook/server.py), so there it has nothing
# to lower.
"""Soak plane: open-loop sustained-load harness (docs/operations.md).

Every other bench phase in this repo is a short CLOSED-loop burst: N
threads each wait for their previous response before sending the next
request, so an overloaded system quietly slows its own arrival rate and
the measured p99 flatters it (coordinated omission). The soak plane is
the opposite instrument — an OPEN-loop generator schedules Poisson
arrivals at a fixed target rps whether or not the system keeps up, and
a request that misses its deadline is COUNTED AGAINST THE SLO instead
of back-pressured away. Around that generator:

  * `scenario`   — the declarative timeline (at t=20s add constraints,
    at t=45s arm a fault, at t=90s rotate certs / kill a replica);
  * `loadgen`    — the Poisson arrival scheduler + worker pool;
  * `report`     — per-window SLO attainment, shed rate, breaker
    transition log, device-time split, capacity model, and leak
    evidence (RSS / cache / trace-ring / metrics-series curves).

The caller brings the system under test: `run_open_loop(submit, ...)`
drives any thread-safe `submit(plane) -> (status, outcome)`, and
`build_report` turns its samples, per-window server-side observations
and a device-time split into the soak artifact that `check_soak_schema`
gates and `summarize_soak` condenses into one SUMMARY line.
"""

from .loadgen import OpenLoopLoad, run_open_loop  # noqa: F401
from .report import (  # noqa: F401
    SOAK_SCHEMA_FIELDS,
    build_report,
    check_soak_schema,
    monotonic_growth,
    parse_summary_line,
    summarize_soak,
)
from .scenario import (  # noqa: F401
    ACTIONS,
    Scenario,
    ScenarioEvent,
    default_scenario,
    high_rate_scenario,
    high_rate_smoke_scenario,
    load_scenario,
    multi_tenant_overload_scenario,
    multi_tenant_smoke_scenario,
    sdc_smoke_scenario,
    smoke_scenario,
)
