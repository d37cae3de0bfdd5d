# Copied from gatekeeper_tpu/soak/scenario.py; no line below differs.
"""Declarative soak scenarios: a timeline of events over sustained load.

A scenario is a plain dict (checked by `Scenario.from_dict`) so runs
are reproducible from a JSON file checked in next to their evidence
artifact. The shape:

    {
      "name": "soak-default",
      "duration_s": 150,          # open-loop load window
      "rps": 60,                  # fixed Poisson arrival rate
      "deadline_s": 0.25,         # the SLO: answered within deadline
      "window_s": 5,              # reporting window size
      "seed": 1234,               # arrival/plane RNG seed
      "replicas": 2,              # real WebhookServer replicas
      "tls": true,                # HTTPS + fleet Secret cert store
      "constraints": 30,          # initial constraint count
      "external_keys": 12,        # external-data key universe
      "planes": {"validation": 0.7, "mutation": 0.15, "agent": 0.15},
      "breaker": {"failure_threshold": 3, "recovery_seconds": 5},
      "capacity": {"constraint_counts": [10, 100],
                   "rps_levels": [25, 50, 100, 200],
                   "probe_s": 3},
      "events": [
        {"at": 0,  "action": "phase", "name": "steady"},
        {"at": 62, "action": "add_constraints", "count": 50},
        {"at": 86, "action": "arm_fault",
         "point": "driver.device_dispatch", "mode": "error"},
        {"at": 100, "action": "disarm_faults"},
        {"at": 115, "action": "rotate_certs"},
        {"at": 121, "action": "kill_replica", "replica": 0},
      ]
    }

`phase` events label every subsequent reporting window until the next
`phase` event — the reporter aggregates SLO attainment, shed and 5xx
rates per phase, which is how the acceptance checks (fault window
recovers, churn stays 5xx-free, replica kill sheds bounded) find their
windows.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

PLANES = ("validation", "mutation", "agent")

# action -> required extra keys (beyond "at"/"action")
ACTIONS: Dict[str, tuple] = {
    "phase": ("name",),          # label windows from here on
    "add_constraints": (),       # count (default 25): constraint churn
    "add_template": (),          # new template kind + one constraint
    "add_provider": (),          # register another stub-backed provider
    "add_mutator": (),           # add an AssignMetadata mutator
    # locality-skewed churn (pruned dispatch): add two namespace-
    # affine constraint groups (count per group; hot_ns/cold_ns name
    # the namespaces) and skew subsequent traffic toward the hot one
    # (skew, default 0.9) — the guided planner co-locates each group,
    # so sampler windows show partitions_touched well under the plan's
    # k while the cold group's partitions sit mask-skipped
    "locality_churn": (),
    # incremental compile plane (docs/compile.md): a burst of new
    # templates + constraints lands at once; every new partition
    # shadow-stages and warm-swaps while in-flight batches keep the
    # old programs — the ingest_zero_degraded check asserts the phase
    # recorded zero degraded dispatches and zero 5xx
    "ingest_wave": (),           # count (default 500): template burst
    "arm_fault": ("point",),     # mode/count/after/delay ride along
    "disarm_faults": (),         # reset the whole fault registry
    "rotate_certs": (),          # force a cert rotation (tls only)
    "kill_replica": (),          # replica (default 0): LB-out + drain
    # device fault domains (needs partitions > 0): operator-style
    # quarantine of one logical device (its partitions re-home onto
    # healthy devices) and the matching heal
    "quarantine_device": (),     # device (default 1)
    "heal_device": (),           # device (default 1)
    # verdict-integrity plane (docs/robustness.md §Verdict integrity):
    # run the golden self-test against one device — the ONLY path that
    # heals a corruption quarantine (the sdc scenario fires it after
    # disarming the bit-flip)
    "selftest_device": (),       # device (default 1)
}


@dataclass
class ScenarioEvent:
    at_s: float
    action: str
    params: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ScenarioEvent":
        if not isinstance(d, dict):
            raise ValueError(f"event must be an object, got {d!r}")
        action = d.get("action")
        if action not in ACTIONS:
            raise ValueError(
                f"unknown scenario action {action!r} "
                f"(want one of {sorted(ACTIONS)})"
            )
        try:
            at_s = float(d.get("at", 0.0))
        except (TypeError, ValueError):
            raise ValueError(f"event 'at' must be a number: {d!r}")
        if at_s < 0:
            raise ValueError(f"event 'at' must be >= 0: {d!r}")
        params = {k: v for k, v in d.items() if k not in ("at", "action")}
        for req in ACTIONS[action]:
            if req not in params:
                raise ValueError(
                    f"scenario action {action!r} requires {req!r}: {d!r}"
                )
        return cls(at_s=at_s, action=action, params=params)

    def to_dict(self) -> Dict[str, Any]:
        return {"at": self.at_s, "action": self.action, **self.params}


@dataclass
class Scenario:
    name: str = "soak"
    duration_s: float = 60.0
    rps: float = 50.0
    deadline_s: float = 0.25
    window_s: float = 5.0
    seed: int = 1234
    replicas: int = 1
    tls: bool = False
    constraints: int = 20
    external_keys: int = 12
    violating_fraction: float = 0.1
    # micro-batch window for the replicas' batchers
    window_ms: float = 2.0
    # override the driver's adaptive small-batch floor for the run
    # (GATEKEEPER_TPU_MIN_DEVICE_BATCH equivalent): at realistic soak
    # arrival rates micro-batches are small, and without lowering the
    # floor every batch would take the interpreter route — device
    # faults would never fire and the device-time split would be empty.
    # None keeps the deployment default.
    min_device_batch: Optional[int] = None
    # device fault domains (docs/robustness.md §Fault domains): split
    # each replica's validation plane into this many constraint-subset
    # partitions with per-device breakers + quarantine; 0 keeps the
    # monolithic dispatch + single plane breaker
    partitions: int = 0
    planes: Dict[str, float] = field(
        default_factory=lambda: {
            "validation": 0.7, "mutation": 0.15, "agent": 0.15
        }
    )
    breaker: Dict[str, float] = field(
        default_factory=lambda: {
            "failure_threshold": 3, "recovery_seconds": 5.0
        }
    )
    capacity: Optional[Dict[str, Any]] = None
    # SloTarget overrides for the live SLO engine + offline reporter
    # (obs/slo.py — objective, burn windows/thresholds, the degrade/
    # recover phase thresholds). deadline_s defaults to the scenario's
    # own deadline contract; unknown keys are rejected at load time.
    slo: Optional[Dict[str, Any]] = None
    # admission scheduling policy for every replica's batcher planes
    # (docs/operations.md §Admission scheduling): "deadline" = EDF
    # batch formation + per-tenant fair-share quotas + predictive
    # shedding; "fifo" = the bit-compatible legacy queue (the
    # multi-tenant overload baseline runs use it for the contrast)
    sched_policy: str = "fifo"
    # two-tenant traffic mix (the multi_tenant_overload scenario):
    # {"noisy_fraction": 0.75, "quiet_ns": "...", "noisy_ns": "..."} —
    # `noisy_fraction` of validation/mutation requests land on the
    # noisy namespace, the rest on the quiet one; the sampler reads
    # each class's attainment/shed split from the decision log
    tenants: Optional[Dict[str, Any]] = None
    # front-door transport (docs/ingest.md): "http" drives the legacy
    # webhook endpoints over urllib; "framed" opens each replica's
    # stream listener and submits over multiplexed length-prefixed
    # frames with the deadline stamped in the frame header — the
    # wire-speed ingest plane's soak path (high_rate_scenario)
    transport: str = "http"
    events: List[ScenarioEvent] = field(default_factory=list)

    def slo_target(self):
        """The one SloTarget both the live per-replica engines and the
        offline reporter judge this run against."""
        from ..obs.slo import SloTarget

        return SloTarget.from_dict(
            self.slo, deadline_s=self.deadline_s
        )

    def validate(self) -> None:
        if self.duration_s <= 0:
            raise ValueError("duration_s must be > 0")
        if self.rps <= 0:
            raise ValueError("rps must be > 0")
        if self.deadline_s <= 0:
            raise ValueError("deadline_s must be > 0")
        if not (0 < self.window_s <= self.duration_s):
            raise ValueError("window_s must be in (0, duration_s]")
        if self.replicas < 1:
            raise ValueError("replicas must be >= 1")
        for plane in self.planes:
            if plane not in PLANES:
                raise ValueError(
                    f"unknown plane {plane!r} (want {PLANES})"
                )
        if sum(self.planes.values()) <= 0:
            raise ValueError("plane weights must sum to > 0")
        from ..sched import POLICIES

        if self.sched_policy not in POLICIES:
            raise ValueError(
                f"sched_policy must be one of {POLICIES}, "
                f"got {self.sched_policy!r}"
            )
        if self.transport not in ("http", "framed"):
            raise ValueError(
                f"transport must be 'http' or 'framed', "
                f"got {self.transport!r}"
            )
        if self.transport == "framed" and self.tls:
            raise ValueError(
                "transport='framed' is plaintext-only (the stream "
                "listener terminates no TLS); drop tls or use http"
            )
        if self.tenants is not None:
            frac = float(self.tenants.get("noisy_fraction", 0.75))
            if not (0.0 < frac < 1.0):
                raise ValueError(
                    "tenants.noisy_fraction must be in (0, 1)"
                )
        # a typoed slo override must fail the load, not the analysis
        self.slo_target()
        for ev in self.events:
            if ev.at_s > self.duration_s:
                raise ValueError(
                    f"event at t={ev.at_s}s is past duration_s="
                    f"{self.duration_s}s: {ev.to_dict()}"
                )
            if ev.action == "kill_replica":
                idx = int(ev.params.get("replica", 0))
                if not (0 <= idx < self.replicas):
                    raise ValueError(
                        f"kill_replica index {idx} out of range for "
                        f"{self.replicas} replicas"
                    )
            if ev.action in (
                "quarantine_device", "heal_device", "selftest_device"
            ):
                if self.partitions < 1:
                    raise ValueError(
                        f"{ev.action} requires partitions >= 1"
                    )
                dev = int(ev.params.get("device", 1))
                if not (0 <= dev < self.partitions):
                    raise ValueError(
                        f"{ev.action} device {dev} out of range for "
                        f"{self.partitions} partitions"
                    )

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Scenario":
        known = {
            "name", "duration_s", "rps", "deadline_s", "window_s",
            "seed", "replicas", "tls", "constraints", "external_keys",
            "violating_fraction", "window_ms", "min_device_batch",
            "partitions", "planes", "breaker", "capacity", "slo",
            "sched_policy", "tenants", "transport", "events",
        }
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown scenario keys: {sorted(unknown)}"
            )
        kwargs = {k: v for k, v in d.items() if k != "events"}
        events = [ScenarioEvent.from_dict(e) for e in d.get("events", [])]
        scn = cls(**kwargs, events=sorted(events, key=lambda e: e.at_s))
        scn.validate()
        return scn

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "duration_s": self.duration_s,
            "rps": self.rps,
            "deadline_s": self.deadline_s,
            "window_s": self.window_s,
            "seed": self.seed,
            "replicas": self.replicas,
            "tls": self.tls,
            "constraints": self.constraints,
            "external_keys": self.external_keys,
            "violating_fraction": self.violating_fraction,
            "window_ms": self.window_ms,
            "min_device_batch": self.min_device_batch,
            "partitions": self.partitions,
            "planes": dict(self.planes),
            "breaker": dict(self.breaker),
            "capacity": self.capacity,
            "slo": self.slo,
            "sched_policy": self.sched_policy,
            "tenants": dict(self.tenants) if self.tenants else None,
            "transport": self.transport,
            "events": [e.to_dict() for e in self.events],
        }


def load_scenario(path: str) -> Scenario:
    with open(path) as f:
        return Scenario.from_dict(json.load(f))


def smoke_scenario() -> Scenario:
    """The ~10 s tier-1 smoke: one replica, plain HTTP, a constraint-
    churn blip and one fault window with a fast-recovery breaker —
    enough to exercise every moving part of the harness without
    minutes of wall clock."""
    return Scenario.from_dict({
        "name": "soak-smoke",
        "duration_s": 12.5,
        "rps": 30.0,
        "deadline_s": 0.5,
        "window_s": 1.0,
        "seed": 99,
        "replicas": 1,
        "tls": False,
        "constraints": 8,
        "external_keys": 5,
        "breaker": {"failure_threshold": 3, "recovery_seconds": 1.0},
        "events": [
            {"at": 0.0, "action": "phase", "name": "steady"},
            {"at": 2.0, "action": "phase", "name": "churn"},
            {"at": 2.2, "action": "add_constraints", "count": 5},
            {"at": 3.0, "action": "add_provider"},
            {"at": 4.0, "action": "phase", "name": "fault"},
            # batch_dispatch error trips the breaker at interpreter-
            # route batch sizes too; the host-rung hang (> deadline)
            # makes the SLO dip measurable in a 2 s window
            {"at": 4.1, "action": "arm_fault",
             "point": "webhook.batch_dispatch", "mode": "error"},
            {"at": 4.1, "action": "arm_fault",
             "point": "webhook.host_review", "mode": "hang",
             "delay": 0.6},
            {"at": 6.0, "action": "disarm_faults"},
            # the backlog the hang built drains during the tail of the
            # fault phase; recovery is judged from t=7 so it measures
            # the recovered system, not the queue flush
            {"at": 7.0, "action": "phase", "name": "recovery"},
            # a small template ingest wave: the compile plane must
            # serve every request through it (ingest_zero_degraded)
            {"at": 9.0, "action": "phase", "name": "ingest"},
            {"at": 9.2, "action": "ingest_wave", "count": 6},
        ],
    })


def sdc_smoke_scenario() -> Scenario:
    """The ~9 s verdict-integrity smoke (docs/robustness.md §Verdict
    integrity): partitioned serving with a device bit-flip armed
    mid-steady-state via the `integrity.canary[device=1]` fault point.
    The canary tier must detect the corruption, trip the device into
    quarantine with reason `corruption` (its partitions re-home while
    healthy devices keep serving fused), and after the flip is
    disarmed the golden self-test — the ONLY corruption heal path —
    returns the device to the pool. The report judges it all through
    `sdc_detected_and_quarantined` over the canary_mismatches /
    quarantined_devices window columns."""
    return Scenario.from_dict({
        "name": "soak-sdc-smoke",
        "duration_s": 9.0,
        "rps": 30.0,
        "deadline_s": 0.5,
        "window_s": 1.0,
        "seed": 77,
        "replicas": 1,
        "tls": False,
        "constraints": 8,
        "external_keys": 5,
        "partitions": 2,
        # keep micro-batches on the device path so canary rows
        # actually ride the dispatches the bit-flip corrupts
        "min_device_batch": 1,
        "breaker": {"failure_threshold": 3, "recovery_seconds": 1.0},
        "events": [
            {"at": 0.0, "action": "phase", "name": "steady"},
            {"at": 3.0, "action": "phase", "name": "sdc"},
            {"at": 3.1, "action": "arm_fault",
             "point": "integrity.canary[device=1]", "mode": "error"},
            {"at": 6.0, "action": "disarm_faults"},
            {"at": 6.2, "action": "selftest_device", "device": 1},
            {"at": 6.5, "action": "phase", "name": "recovery"},
        ],
    })


def multi_tenant_overload_scenario(
    sched_policy: str = "deadline",
) -> Scenario:
    """The scheduler acceptance run (docs/operations.md §Admission
    scheduling): two tenant classes — a noisy namespace carrying 3/4 of
    arrivals and a quiet one carrying the rest — driven at roughly 2×
    the single-replica capacity so the plane saturates. With
    `sched_policy="deadline"` the fair-share quotas cap the noisy
    tenant at its share and predictive shedding drops only provably
    doomed requests, so the quiet tenant's attainment holds at the SLO
    objective (`quiet_tenant_attainment_holds`); the same scenario
    with `"fifo"` is the baseline where both classes degrade together
    (`fifo_baseline_degrades` — the contrast the report asserts)."""
    return Scenario.from_dict({
        "name": f"soak-multi-tenant-{sched_policy}",
        "duration_s": 60.0,
        "rps": 400.0,  # ~2x the capacity model's single-replica knee
        "deadline_s": 0.25,
        "window_s": 5.0,
        "seed": 4242,
        "replicas": 1,
        "tls": False,
        "constraints": 30,
        "external_keys": 12,
        "window_ms": 10.0,
        "min_device_batch": 2,
        # scheduling is a validation/mutation-plane story here; agent
        # traffic would add a second tenant-identity axis to the split
        "planes": {"validation": 0.85, "mutation": 0.15},
        "sched_policy": sched_policy,
        "tenants": {
            "noisy_fraction": 0.75,
            "quiet_ns": "ns-quiet",
            "noisy_ns": "ns-noisy",
        },
        "events": [
            {"at": 0.0, "action": "phase", "name": "overload"},
        ],
    })


def multi_tenant_smoke_scenario(
    sched_policy: str = "deadline",
) -> Scenario:
    """Tier-1 smoke of the multi-tenant overload machinery (~8 s, one
    replica): small corpus, overdriven arrivals, the same two-tenant
    mix — enough to exercise the scheduler seams, the per-class
    sampler columns, and the report checks without asserting the full
    run's attainment numbers."""
    return Scenario.from_dict({
        "name": f"soak-multi-tenant-smoke-{sched_policy}",
        "duration_s": 8.0,
        "rps": 120.0,
        "deadline_s": 0.3,
        "window_s": 1.0,
        "seed": 77,
        "replicas": 1,
        "tls": False,
        "constraints": 8,
        "external_keys": 5,
        "planes": {"validation": 0.85, "mutation": 0.15},
        "sched_policy": sched_policy,
        "tenants": {
            "noisy_fraction": 0.75,
            "quiet_ns": "ns-quiet",
            "noisy_ns": "ns-noisy",
        },
        "events": [
            {"at": 0.0, "action": "phase", "name": "overload"},
        ],
    })


def high_rate_scenario() -> Scenario:
    """The wire-speed ingest acceptance run (docs/ingest.md §Soak):
    one replica driven open-loop at 5000 rps/replica over the framed
    stream transport — an offered rate far past what conn-per-request
    HTTP/1 can even accept on one host. The arrival schedule never
    slows for the system (coordinated-omission honest), so the run
    measures what the framed front door SUSTAINS under a firehose: the
    report's `ingest_rps_sustained` check asserts within-deadline
    goodput holds a floor fraction of the offered rate, and
    `decode_span_bounded` asserts the zero-copy scanner's share of
    each request's deadline budget stays marginal (decode must never
    become the bottleneck the transport just removed)."""
    return Scenario.from_dict({
        "name": "soak-high-rate",
        "duration_s": 60.0,
        "rps": 5000.0,
        "deadline_s": 0.25,
        "window_s": 5.0,
        "seed": 1311,
        "replicas": 1,
        "tls": False,
        "constraints": 20,
        "external_keys": 5,
        "window_ms": 2.0,
        "transport": "framed",
        "events": [
            {"at": 0.0, "action": "phase", "name": "firehose"},
        ],
    })


def high_rate_smoke_scenario() -> Scenario:
    """Tier-1 smoke of the framed-transport soak path (~8 s, one
    replica, an arrival rate the CI box actually serves): exercises
    the harness's StreamClient submit pool, the per-window ingest
    sampler columns, and both ingest report checks without asserting
    the full firehose run's numbers."""
    return Scenario.from_dict({
        "name": "soak-high-rate-smoke",
        "duration_s": 8.0,
        "rps": 80.0,
        "deadline_s": 0.5,
        "window_s": 1.0,
        "seed": 1311,
        "replicas": 1,
        "tls": False,
        "constraints": 8,
        "external_keys": 5,
        "transport": "framed",
        "events": [
            {"at": 0.0, "action": "phase", "name": "firehose"},
        ],
    })


def default_scenario() -> Scenario:
    """The full evidence run behind SOAK_r01.json: two TLS replicas
    sharing a fleet cert Secret and cache/breaker gossip, >= 60 s of
    steady open-loop load for the leak curves, then churn
    (constraints + template + provider + mutator adds, capped by a
    locality-skewed window: two namespace-affine constraint groups
    with 90/10 traffic skew — the pruned-dispatch evidence), a fault
    window
    (device faults trip the breaker while the host rung stalls — the
    SLO must degrade and then recover post-disarm), a sick-chip window
    (ONE device of the 4-partition plan faulted: only its constraint
    subset degrades, then the operator quarantine/heal path re-homes
    it), a live cert rotation, a 500-template ingest wave that the
    incremental compile plane must absorb with zero degraded
    dispatches, and a graceful replica kill that replica B absorbs."""
    return Scenario.from_dict({
        "name": "soak-default",
        "duration_s": 150.0,
        "rps": 60.0,
        "deadline_s": 0.25,
        "window_s": 5.0,
        "seed": 1234,
        "replicas": 2,
        "tls": True,
        "constraints": 30,
        "external_keys": 12,
        # realistic arrival rates make small micro-batches: lower the
        # device floor so the run exercises the REAL fused path (and
        # device faults actually fire; see Scenario.min_device_batch)
        "window_ms": 10.0,
        "min_device_batch": 2,
        # device fault domains: 4 constraint-subset partitions, each
        # with its own per-device breaker (§Fault domains)
        "partitions": 4,
        "breaker": {"failure_threshold": 3, "recovery_seconds": 5.0},
        "capacity": {
            "constraint_counts": [10, 100],
            "rps_levels": [25, 50, 100, 200, 400],
            "probe_s": 3.0,
        },
        "events": [
            {"at": 0.0, "action": "phase", "name": "steady"},
            {"at": 60.0, "action": "phase", "name": "churn"},
            {"at": 62.0, "action": "add_constraints", "count": 50},
            {"at": 66.0, "action": "add_template"},
            {"at": 70.0, "action": "add_provider"},
            {"at": 74.0, "action": "add_mutator"},
            # locality-skewed churn: two namespace-affine constraint
            # groups join the corpus and 90% of subsequent traffic
            # lands on the hot namespace — the guided plan co-locates
            # each group, so this phase's sampler windows record
            # partitions_touched falling under the plan's k (the
            # pruned-dispatch evidence window)
            {"at": 76.0, "action": "phase", "name": "locality_skew"},
            {"at": 76.5, "action": "locality_churn", "count": 10,
             "skew": 0.9},
            {"at": 85.0, "action": "phase", "name": "fault"},
            {"at": 86.0, "action": "arm_fault",
             "point": "driver.device_dispatch", "mode": "error"},
            {"at": 86.0, "action": "arm_fault",
             "point": "webhook.host_review", "mode": "hang",
             "delay": 0.35},
            {"at": 100.0, "action": "disarm_faults"},
            # recovery judged after the hang-built backlog drains
            {"at": 103.0, "action": "phase", "name": "recovery"},
            # sick chip: ONE device faulted — its partition's subset
            # degrades to host (blast radius = 1/partitions), the
            # breaker trips it into quarantine, and after the disarm
            # the operator quarantine/heal path exercises re-homing
            {"at": 108.0, "action": "phase", "name": "sick_chip"},
            {"at": 108.5, "action": "arm_fault",
             "point": "driver.device_dispatch[device=1]",
             "mode": "error"},
            {"at": 114.0, "action": "disarm_faults"},
            {"at": 114.5, "action": "quarantine_device", "device": 1},
            {"at": 117.0, "action": "heal_device", "device": 1},
            {"at": 118.0, "action": "rotate_certs"},
            # 500-template ingest wave against the 4-partition plan:
            # every changed partition shadow-compiles off the serving
            # path and warm-swaps — the ingest_zero_degraded check
            # demands zero degraded dispatches and zero 5xx here
            {"at": 119.0, "action": "phase", "name": "ingest"},
            {"at": 119.5, "action": "ingest_wave", "count": 500},
            {"at": 135.0, "action": "phase", "name": "kill"},
            {"at": 136.0, "action": "kill_replica", "replica": 0},
        ],
    })
