# Copied from gatekeeper_tpu/parallel/partition.py; only these edits differ.
# Edit: a partition the dispatcher cannot serve fused is answered with the
# fail policy, not on the host interpreter: the dispatch route "host"
# is "unavailable" here, and the docstrings of the module, ensure_staged
# and _spawn_restage say so. The webhook stages with wait=True (a restage
# compiles no kernel in the port).
"""Device fault domains: partitioned program dispatch.

One monolithic fused program made every device fault a whole-plane
event: the single per-plane breaker tripped and EVERY request degraded
to the host interpreter (docs/robustness.md §Fault domains). This
module splits the staged constraint corpus into K independently
compilable/dispatchable sub-programs — partitions — each homed on a
logical device and guarded by its own per-(device, plane)
`CircuitBreaker`, so one sick chip sheds exactly its constraint subset
and nothing else:

  * `PartitionPlan` — a deterministic split of the constraint corpus
    (the driver's sorted `<kind>/<name>` identities, round-robin over K
    partitions) with a device assignment per partition. The plan
    rebuilds on constraint churn and on device-health changes, and
    `to_dict()` is surfaced in `/readyz` and the partition metrics.
  * `PartitionDispatcher` — the quarantine manager: lazily creates the
    per-device breakers, re-homes a quarantined device's partitions
    onto healthy devices (restage with exponential backoff through the
    `driver.restage[device=N]` fault point), runs half-open probes
    against quarantined devices on the breaker's own recovery
    schedule; only when every device is dead does the whole batch get
    the endpoint's fail policy.
  * `merge_partition_results` — the parity-preserving merge: combined
    per-partition verdicts are bit-identical to the monolithic dispatch
    (autorejects first, then evaluation results, both in the global
    constraint order; pinned by the partition parity battery in
    tests/test_partition.py).

Devices here are *logical* fault domains (ids into the plan's device
slots). On provisioned multi-chip hardware (ROADMAP item 3) the slots
map to real chips; on a single-device host they still buy deterministic
fault isolation because every device-attributed code path — dispatch,
restage, probe — flows through the device-labeled fault points in
`faults/injection.py`. The partition boundary this creates is the same
one per-batch constraint pruning (ROADMAP item 1) dispatches over.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..faults import CLOSED, CircuitBreaker

__all__ = [
    "Partition",
    "PartitionPlan",
    "PartitionDispatcher",
    "build_plan",
    "merge_partition_results",
]


@dataclass(frozen=True)
class Partition:
    """One fault domain's constraint subset + device placement."""

    index: int
    home_device: int  # the deterministic assignment
    device: int  # where it actually runs (≠ home while re-homed)
    keys: Tuple[str, ...]  # constraint identities, global-sorted
    subset: frozenset  # frozenset(keys) — the driver-facing form

    def to_dict(self) -> Dict[str, Any]:
        return {
            "index": self.index,
            "home_device": self.home_device,
            "device": self.device,
            "constraints": len(self.keys),
        }


@dataclass
class PartitionPlan:
    """A deterministic constraint-corpus split with device placement."""

    generation: int
    constraint_gen: Any
    partitions: List[Partition]
    # constraint key -> global index: the merge order (the driver's
    # sorted (kind, name) iteration order — exactly what the monolith
    # emits in)
    order: Dict[str, int]
    devices: Tuple[int, ...]
    all_dead: bool = False
    # constraint keys the corpus analyzer proved dead (and free of the
    # ns-selector autoreject path) — excluded from every dispatch row;
    # verdict-safe by the corpus parity battery (docs/analysis.md)
    excluded_static: Tuple[str, ...] = ()

    def to_dict(self) -> Dict[str, Any]:
        return {
            "generation": self.generation,
            "constraints": len(self.order),
            "devices": list(self.devices),
            "all_dead": self.all_dead,
            "excluded_static": list(self.excluded_static),
            "partitions": [p.to_dict() for p in self.partitions],
        }


def _guided_split(
    keys: Sequence[str],
    k_eff: int,
    costs: Dict[str, float],
    locality: Dict[str, str],
    order: Dict[str, int],
) -> List[Tuple[str, ...]]:
    """Cost/locality-guided corpus split. Keys sharing a locality token
    (constraints whose match blocks are identical — they fire on exactly
    the same reviews) are co-located so a batch with namespace/kind
    affinity touches 1-2 hot partitions instead of all K; groups are
    packed into K bins by greedy LPT on cost (measured device seconds
    when available, static compile cost otherwise). Deterministic: ties
    break on global key order, so same inputs always give the same plan.
    """
    grouped: Dict[str, List[str]] = {}
    for key in keys:
        # a key without a locality token is its own group (no false
        # co-location); "!key:" cannot collide with JSON match tokens
        grouped.setdefault(
            locality.get(key, f"!key:{key}"), []
        ).append(key)

    def g_cost(gkeys: List[str]) -> float:
        return max(sum(costs.get(k2, 1.0) for k2 in gkeys), 1e-9)

    def g_first(gkeys: List[str]) -> int:
        return min(order[k2] for k2 in gkeys)

    groups: List[List[str]] = sorted(
        grouped.values(), key=g_first
    )
    # fewer locality groups than partitions: split the costliest
    # multi-key group (alternating keys, preserving internal balance)
    # until every partition slot has a group — degenerates to ~round-
    # robin when the whole corpus shares one match block
    while len(groups) < k_eff:
        cand = max(
            (g for g in groups if len(g) > 1),
            key=lambda g: (g_cost(g), -g_first(g)),
            default=None,
        )
        if cand is None:
            break
        groups.remove(cand)
        groups.extend([cand[0::2], cand[1::2]])
    # greedy LPT: heaviest group first onto the lightest bin
    bins: List[List[str]] = [[] for _ in range(k_eff)]
    loads = [0.0] * k_eff
    for g in sorted(groups, key=lambda g: (-g_cost(g), g_first(g))):
        i = min(range(k_eff), key=lambda j: (loads[j], j))
        bins[i].extend(g)
        loads[i] += g_cost(g)
    bins = [b for b in bins if b]
    bins.sort(key=lambda b: min(order[k2] for k2 in b))
    return [
        tuple(sorted(b, key=lambda k2: order[k2])) for b in bins
    ]


def build_plan(
    keys: Sequence[str],
    k: int,
    devices: Sequence[int],
    healthy: frozenset,
    constraint_gen: Any = None,
    generation: int = 0,
    costs: Optional[Dict[str, float]] = None,
    locality: Optional[Dict[str, str]] = None,
) -> PartitionPlan:
    """Deterministic plan. Without planner inputs, partition p takes
    every k-th key of the sorted identity list (`keys[p::k]` — balanced
    within one constraint and rebalanced by construction on churn).
    With `costs`/`locality` (the dispatcher supplies both from the
    driver + CostAttributor), the split is cost/locality-guided instead
    (_guided_split) so mask-gated pruning can skip cold partitions.
    Either way a partition homes on `devices[p % len(devices)]`; a
    partition whose home device is not healthy re-homes onto the
    healthy device chosen round-robin by partition index — same inputs,
    same plan, always."""
    keys = list(keys)
    order = {key: i for i, key in enumerate(keys)}
    k_eff = min(max(1, int(k)), len(keys)) if keys else 0
    healthy_list = sorted(d for d in devices if d in healthy)
    if (costs is None and locality is None) or not k_eff:
        key_sets = [tuple(keys[p::k_eff]) for p in range(k_eff)]
    else:
        key_sets = _guided_split(
            keys, k_eff, costs or {}, locality or {}, order
        )
    partitions: List[Partition] = []
    for p, pkeys in enumerate(key_sets):
        home = devices[p % len(devices)]
        if home in healthy:
            device = home
        elif healthy_list:
            device = healthy_list[p % len(healthy_list)]
        else:
            device = home  # all dead: flagged below, never dispatched
        partitions.append(
            Partition(
                index=p,
                home_device=home,
                device=device,
                keys=pkeys,
                subset=frozenset(pkeys),
            )
        )
    return PartitionPlan(
        generation=generation,
        constraint_gen=constraint_gen,
        partitions=partitions,
        order=order,
        devices=tuple(devices),
        all_dead=not healthy_list,
    )


def _blend_costs(
    keys: Sequence[str],
    static: Optional[Dict[str, float]],
    measured: Optional[Dict[str, float]],
) -> Optional[Dict[str, float]]:
    """Planner cost blend: measured per-constraint device seconds (the
    CostAttributor's table) win where available; constraints without a
    measurement fall back to static compile cost, rescaled so the two
    populations are comparable (static mean matched to measured mean).
    None when neither source has anything — build_plan then stays
    round-robin."""
    if not static and not measured:
        return None
    static = static or {}
    pos = {
        k: v for k, v in (measured or {}).items() if v > 0.0
    }
    if not pos:
        return dict(static) or None
    m_mean = sum(pos.values()) / len(pos)
    s_vals = [static.get(k, 1.0) for k in pos]
    s_mean = (sum(s_vals) / len(s_vals)) or 1.0
    scale = m_mean / s_mean
    return {
        key: pos[key] if key in pos else static.get(key, 1.0) * scale
        for key in keys
    }


def merge_partition_results(
    result_lists: Sequence[Sequence[Any]], order: Dict[str, int]
) -> List[Any]:
    """Merge one request's per-partition Result lists back into the
    monolithic emit order: autoreject results first, then evaluation
    results, each group in global constraint order; within one
    (request, constraint) pair the partition's own result order is
    preserved (stable sort). The partition parity battery pins
    merged == monolith across constraint/partition counts."""
    from ..constraint.driver import AUTOREJECT_MSG, constraint_key

    merged = [r for results in result_lists for r in results]
    fallback = len(order)

    def sort_key(r):
        c = getattr(r, "constraint", None) or {}
        return (
            0 if getattr(r, "msg", None) == AUTOREJECT_MSG else 1,
            order.get(constraint_key(c), fallback),
        )

    merged.sort(key=sort_key)
    return merged


class PartitionDispatcher:
    """Plan + per-device breakers + quarantine lifecycle for one
    admission plane (the MicroBatcher's `partitioner`).

    Thread-safety: the plan/breaker registry is lock-protected;
    breaker transition listeners only write plain flags (never take
    this lock — the breaker calls listeners under ITS lock, and plan
    builds read breaker state under ours, so a listener acquiring our
    lock would be an AB-BA deadlock). Device health is derived from
    breaker state at plan-build time instead of being pushed from the
    listener for exactly that reason.
    """

    def __init__(
        self,
        client,
        target: str,
        k: int,
        devices: Optional[Sequence[int]] = None,
        plane: str = "validation",
        metrics=None,
        tracer=None,
        failure_threshold: int = 3,
        recovery_seconds: float = 30.0,
        restage_backoff_s: float = 0.5,
        restage_backoff_max_s: float = 30.0,
        clock=time.monotonic,
        # called once per lazily created device breaker (the soak
        # harness subscribes its transition ledger here)
        breaker_listener=None,
        probe_batch: int = 8,
        # obs.FlightRecorder: per-device breaker OPENs and operator
        # quarantines trip a postmortem capture (docs/observability.md)
        recorder=None,
        # obs.CostAttributor: measured per-constraint device seconds
        # feed the cost/locality planner (and /debug/partitions shares)
        attributor=None,
        # replica name stamped on /debug/partitions, like /debug/costs
        replica: Optional[str] = None,
        # analysis.corpus.CorpusPlane: provably-dead constraint keys are
        # excluded from dispatch rows (generation-matched; a stale or
        # absent corpus report prunes nothing)
        corpus=None,
    ):
        self.client = client
        self.target = target
        self.k = max(1, int(k))
        if devices is None:
            devices = range(self.k)
        elif isinstance(devices, int):
            devices = range(devices)
        self.devices: Tuple[int, ...] = tuple(int(d) for d in devices)
        if not self.devices:
            raise ValueError("partition dispatch needs >= 1 device")
        self.plane = plane
        self.metrics = metrics
        self.tracer = tracer
        self.failure_threshold = failure_threshold
        self.recovery_seconds = recovery_seconds
        self.restage_backoff_s = restage_backoff_s
        self.restage_backoff_max_s = restage_backoff_max_s
        self.probe_batch = probe_batch
        self._clock = clock
        self._breaker_listener = breaker_listener
        self.recorder = recorder
        self.attributor = attributor
        self.replica = replica
        self.corpus = corpus
        self._lock = threading.RLock()
        self._touched: List[int] = []  # per-batch partitions touched
        self._plan_costs: Dict[str, Dict[str, float]] = {}
        self._breakers: Dict[int, CircuitBreaker] = {}
        self._manual_quarantine: set = set()
        # why each manually-quarantined device is out ("manual" |
        # "corruption"); corruption entries only clear through heal()
        self._quarantine_reasons: Dict[int, str] = {}
        self._plan: Optional[PartitionPlan] = None
        self._plan_key: Any = None
        self._plan_gen = 0
        # staged tokens: (subset, device, signature) when the driver
        # exposes content signatures (docs/compile.md — churn that
        # changes a partition's signature invalidates exactly that
        # token), else the legacy (plan_gen, partition idx, device)
        self._staged: set = set()
        self._staged_parts: set = set()  # partition indexes ever staged
        self._staging: set = set()  # (subset, device) restages in flight
        self._retry_at: Dict[int, float] = {}  # device -> next restage
        self._backoff: Dict[int, float] = {}
        self._executor: Optional[ThreadPoolExecutor] = None
        self._closed = False
        self.fleet = None
        # accounting (snapshot/readyz/bench)
        self.rehomes = 0
        self.probes = 0
        self.restage_failures = 0
        self.dispatches: Dict[str, int] = {
            "fused": 0, "unavailable": 0, "failed": 0, "skipped": 0,
        }

    # -- breakers --------------------------------------------------------------

    def breaker(self, device: int) -> CircuitBreaker:
        """The per-(device, plane) breaker, created lazily — named
        `device:<plane>:<device_id>`, the same key it registers under
        in the fleet plane so a chip sick on one replica pre-opens the
        SAME device's breaker on peers."""
        created = None
        with self._lock:
            b = self._breakers.get(device)
            if b is None:
                b = created = CircuitBreaker(
                    failure_threshold=self.failure_threshold,
                    recovery_seconds=self.recovery_seconds,
                    plane=self.plane,
                    device=device,
                    metrics=self.metrics,
                    tracer=self.tracer,
                    clock=self._clock,
                    recorder=self.recorder,
                )
                self._breakers[device] = b
        if created is not None:
            if self._breaker_listener is not None:
                try:
                    self._breaker_listener(created)
                except Exception:
                    pass
            if self.fleet is not None:
                try:
                    self.fleet.register_breaker(created.name, created)
                except Exception:
                    pass
        return b

    def set_fleet(self, fleet) -> None:
        """Gossip per-device breaker state: register every breaker —
        existing and future — under its `device:<plane>:<device_id>`
        key (docs/fleet.md; the ROADMAP item 2 follow-up)."""
        self.fleet = fleet
        with self._lock:
            existing = list(self._breakers.values())
        for b in existing:
            try:
                fleet.register_breaker(b.name, b)
            except Exception:
                pass

    def _device_healthy(self, device: int) -> bool:
        if device in self._manual_quarantine:
            return False
        b = self._breakers.get(device)
        # HALF_OPEN stays quarantined: the device rejoins the pool only
        # after its probe (run_probes) actually closes the breaker
        return b is None or b.state == CLOSED

    def quarantine(self, device: int, reason: str = "manual") -> None:
        """Operator/scenario/integrity quarantine: take the device out
        of the pool immediately (its partitions re-home on the next
        plan build) without touching its breaker. `reason` separates
        the semantics (docs/robustness.md §Verdict integrity):
        "manual" is an operator decision, "corruption" is the
        verdict-integrity plane's SDC verdict — both use the same
        mechanics, but a corruption quarantine heals ONLY through a
        clean golden self-test (IntegrityPlane.selftest), never a
        probe/timer."""
        with self._lock:
            self._manual_quarantine.add(int(device))
            self._quarantine_reasons[int(device)] = str(reason)
        self._export_quarantine()
        if self.metrics is not None:
            self.metrics.record(
                "device_quarantine_total", 1,
                plane=self.plane, reason=str(reason),
            )
        if self.recorder is not None:
            try:
                self.recorder.trigger(
                    "device_quarantine", plane=self.plane,
                    device=int(device), manual=True,
                    reason=str(reason),
                )
            except Exception:
                pass

    def heal(self, device: int) -> None:
        """Lift an operator/integrity quarantine (a breaker-driven
        quarantine heals through its own probe cycle instead)."""
        with self._lock:
            self._manual_quarantine.discard(int(device))
            self._quarantine_reasons.pop(int(device), None)
        self._export_quarantine()

    def _export_quarantine(self) -> None:
        if self.metrics is None:
            return
        for d in self.devices:
            self.metrics.gauge(
                "device_quarantine_state",
                0 if self._device_healthy(d) else 1,
                plane=self.plane, device=str(d),
            )

    # -- the plan --------------------------------------------------------------

    def plan(self) -> Optional[PartitionPlan]:
        """The current plan, rebuilt deterministically whenever the
        constraint corpus churns or device health changes (quarantine
        re-homes, heal restores homes). None when the driver has no
        partitionable constraint corpus."""
        driver = getattr(self.client, "_driver", None)
        keys_fn = getattr(driver, "constraint_keys", None)
        if keys_fn is None:
            return None
        gen_fn = getattr(driver, "constraint_generation", None)
        gen = gen_fn() if gen_fn is not None else None
        healthy = frozenset(
            d for d in self.devices if self._device_healthy(d)
        )
        excluded: frozenset = frozenset()
        if self.corpus is not None and gen is not None:
            try:
                # generation-matched ask: a stale report answers empty
                # (and kicks a debounced background recompute) — never
                # blocks the planner, never prunes on stale proofs
                excluded = frozenset(
                    self.corpus.prunable_keys(self.target, gen)
                )
            except Exception:
                excluded = frozenset()
        key = (gen, healthy, frozenset(self._manual_quarantine), excluded)
        with self._lock:
            if self._plan is not None and self._plan_key == key:
                return self._plan
        keys = keys_fn(self.target)
        if excluded:
            keys = [c for c in keys if c not in excluded]
        if not keys:
            with self._lock:
                self._plan, self._plan_key = None, key
            return None
        static, locality = self._planner_inputs(driver)
        measured = self._measured_costs()
        blended = _blend_costs(keys, static, measured)
        with self._lock:
            self._plan_gen += 1
            plan = build_plan(
                keys, self.k, self.devices, healthy,
                constraint_gen=gen, generation=self._plan_gen,
                costs=blended, locality=locality,
            )
            plan.excluded_static = tuple(sorted(excluded))
            self._plan_costs = {
                "static": dict(static or {}),
                "measured": dict(measured),
            }
            prev = self._plan
            if prev is not None:
                moved = sum(
                    1
                    for p, q in zip(plan.partitions, prev.partitions)
                    if p.device != q.device
                )
                if moved:
                    self.rehomes += moved
                    if self.metrics is not None:
                        self.metrics.record(
                            "device_partition_rehomes_total", moved,
                            plane=self.plane,
                        )
            self._plan, self._plan_key = plan, key
            # prune staged tokens the new plan obsoletes: signature
            # tokens survive re-planning while their (subset, device)
            # placement persists; legacy tokens die with their plan gen
            live = {(p.subset, p.device) for p in plan.partitions}
            self._staged = {
                t for t in self._staged
                if (
                    (isinstance(t[0], frozenset) and (t[0], t[1]) in live)
                    or (
                        not isinstance(t[0], frozenset)
                        and t[0] == self._plan_gen
                    )
                )
            }
            # churn replay: partitions that HAVE served fused and whose
            # sub-program content changed restage proactively in the
            # background, so the swap usually lands before the next
            # batch even asks (never-staged partitions stay lazy — the
            # first dispatch stages them synchronously, preserving the
            # cold-start contract)
            prestage = (
                [p for p in plan.partitions if p.index in self._staged_parts]
                if prev is not None
                else []
            )
        for p in prestage:
            if not self._subset_ready(p):
                self._spawn_restage(p)
        if self.metrics is not None:
            self.metrics.gauge(
                "device_partition_count", len(plan.partitions),
                plane=self.plane,
            )
        self._export_quarantine()
        return plan

    def _planner_inputs(self, driver):
        """Static costs + locality tokens from the driver's planner
        surface (None-safe: a driver without the surface plans round-
        robin exactly as before)."""
        static = locality = None
        fn = getattr(driver, "constraint_costs", None)
        if fn is not None:
            try:
                static = fn(self.target)
            except Exception:
                static = None
        fn = getattr(driver, "constraint_locality", None)
        if fn is not None:
            try:
                locality = fn(self.target)
            except Exception:
                locality = None
        return static, locality

    def _measured_costs(self) -> Dict[str, float]:
        """Measured per-constraint device seconds from the attributor,
        keyed `<kind>/<name>` — the plan's empirical load signal."""
        if self.attributor is None:
            return {}
        try:
            doc = self.attributor.table(None)
            return {
                f"{r.get('kind', '?')}/{r.get('name', '?')}":
                    float(r.get("seconds", 0.0))
                for r in doc.get("rows", ())
            }
        except Exception:
            return {}

    # -- restage (quarantine re-home) ------------------------------------------

    def _stage_token(self, part: Partition):
        """The staged-set membership token. Content-signature form when
        the driver exposes one (a signature change is exactly an
        obsolete staging); legacy plan-generation form otherwise."""
        driver = getattr(self.client, "_driver", None)
        sig_fn = getattr(driver, "subset_signature", None)
        if sig_fn is not None:
            try:
                return (
                    part.subset, part.device,
                    sig_fn(self.target, part.subset),
                )
            except Exception:
                pass
        return (self._plan_gen, part.index, part.device)

    def _subset_ready(self, part: Partition) -> bool:
        """Can `part` serve a fused dispatch without staging work? A
        driver without the surface (or without a device kernel) has
        nothing to stage — always ready."""
        driver = getattr(self.client, "_driver", None)
        fn = getattr(driver, "subset_ready", None)
        if fn is None:
            return True
        try:
            return bool(fn(self.target, part.subset))
        except Exception:
            return True

    def ensure_staged(self, part: Partition, wait: bool = True) -> bool:
        """Stage `part`'s sub-program on its current device before a
        fused dispatch. A restage failure (the `driver.restage[device=N]`
        fault point, or a real staging error) backs off exponentially;
        until a retry succeeds the requests the partition's mask selects
        get the endpoint's fail policy.

        `wait=False` (the admission hot path): a partition that has
        ALREADY served fused but whose sub-program content churned
        restages in the BACKGROUND and this call returns False while the
        shadow sub-program compiles and swaps (docs/compile.md). A
        never-staged partition still stages synchronously even with
        wait=False: cold start must produce fused dispatches, not a
        host stampede."""
        now = self._clock()
        # token computed OUTSIDE the dispatcher lock: the signature read
        # takes the driver mutex, which a concurrent dispatch may hold
        # for a while — never stack this lock under that wait
        token = self._stage_token(part)
        with self._lock:
            if token in self._staged:
                return True
            if now < self._retry_at.get(part.device, 0.0):
                return False
            staged_before = part.index in self._staged_parts
        if not wait and staged_before and not self._subset_ready(part):
            self._spawn_restage(part)
            return False
        return self._stage_sync(part, now)

    def _stage_sync(self, part: Partition, now: float) -> bool:
        prep = getattr(self.client, "prepare_subset", None)
        try:
            ok = True
            if prep is not None:
                ok = prep(part.subset, device=part.device)
        except Exception:
            self._note_restage_failure(part, now)
            return False
        if ok is False:
            # lost a race with newer churn: not a failure (no backoff),
            # but not staged either — the next pass sees the new content
            return False
        token = self._stage_token(part)
        with self._lock:
            self._staged.add(token)
            self._staged_parts.add(part.index)
            self._retry_at.pop(part.device, None)
            self._backoff.pop(part.device, None)
        return True

    def _note_restage_failure(self, part: Partition, now: float) -> None:
        with self._lock:
            back = self._backoff.get(
                part.device, self.restage_backoff_s
            )
            self._retry_at[part.device] = now + back
            self._backoff[part.device] = min(
                back * 2, self.restage_backoff_max_s
            )
            self.restage_failures += 1
            backlog = len(self._staging)
        if self.metrics is not None:
            self.metrics.record(
                "device_partition_restage_failures_total", 1,
                plane=self.plane, device=str(part.device),
            )
        # restage-failure bursts are the compile_storm trigger signal
        note = getattr(self.recorder, "note_restage_failure", None)
        if note is not None:
            try:
                note(self.plane, backlog=backlog)
            except Exception:
                pass

    def _spawn_restage(self, part: Partition) -> None:
        """Background restage of a churned, previously-fused partition.
        NON-daemon thread: these threads finish on their own — staging
        is bounded by one compile."""
        key = (part.subset, part.device)
        with self._lock:
            if self._closed or key in self._staging:
                return
            self._staging.add(key)

        def run():
            try:
                self._stage_sync(part, self._clock())
            except Exception:
                pass
            finally:
                with self._lock:
                    self._staging.discard(key)

        threading.Thread(
            target=run, name=f"gk-restage-{self.plane}", daemon=False
        ).start()

    # -- probes ----------------------------------------------------------------

    def run_probes(self, reviews: Sequence[Any]) -> None:
        """Half-open probes against quarantined devices, on the
        breaker's own recovery schedule (its `recovery_seconds` clock —
        re-homed partitions carry no traffic to a quarantined device,
        so without this nothing would ever close its breaker). The
        probe re-dispatches the device's HOME partition subset against
        a slice of the live batch; its results are discarded — the
        batch was already answered — and only the breaker verdict
        (CLOSED on success, re-OPEN on failure) matters."""
        plan = self._plan
        if plan is None or not reviews:
            return
        for device in self.devices:
            with self._lock:
                b = self._breakers.get(device)
                manual = device in self._manual_quarantine
            if b is None or manual:
                continue
            if b.state == CLOSED or not b.allow():
                continue
            part = next(
                (p for p in plan.partitions if p.home_device == device),
                None,
            )
            if part is None:
                # no partition to probe with: count the probe slot as a
                # success so an unused device never wedges half-open
                b.record_success()
                continue
            self.probes += 1
            try:
                self.client.review_many_subset(
                    list(reviews[: self.probe_batch]), part.subset,
                    device=device,
                )
            except Exception:
                b.record_failure()
                self._note_probe(device, "failure")
                continue
            b.record_success()
            self._note_probe(device, "success")

    def _note_probe(self, device: int, result: str) -> None:
        if self.metrics is not None:
            self.metrics.record(
                "device_quarantine_probes_total", 1,
                plane=self.plane, device=str(device), result=result,
            )

    # -- dispatch accounting ---------------------------------------------------

    def note_dispatch(self, route: str, device: Optional[int] = None) -> None:
        with self._lock:
            self.dispatches[route] = self.dispatches.get(route, 0) + 1
        if self.metrics is not None:
            self.metrics.record(
                "device_partition_dispatch_total", 1,
                plane=self.plane, route=route,
                device="" if device is None else str(device),
            )

    def note_batch_touched(self, touched: int, planned: int) -> None:
        """Pruning telemetry: of `planned` partitions in the live plan,
        this batch dispatched work to `touched` (the rest were mask-
        skipped — no device call, no restage touch)."""
        with self._lock:
            self._touched.append(int(touched))
            if len(self._touched) > 4096:
                del self._touched[: len(self._touched) // 2]
        if self.metrics is not None:
            self.metrics.gauge(
                "device_partitions_touched", touched, plane=self.plane,
            )
            self.metrics.gauge(
                "device_partitions_planned", planned, plane=self.plane,
            )

    def touched_stats(self) -> Dict[str, Any]:
        """p50/max of per-batch partitions touched (bench SUMMARY's
        partitions_touched_p50/_max; window = last ~4k batches)."""
        with self._lock:
            data = sorted(self._touched)
        if not data:
            return {"batches": 0, "p50": None, "max": None}
        return {
            "batches": len(data),
            "p50": data[len(data) // 2],
            "max": data[-1],
        }

    @property
    def executor(self) -> Optional[ThreadPoolExecutor]:
        """Shared pool for concurrent partition dispatches (the driver
        serializes its own critical sections; concurrency buys overlap
        of encode/render work and, on real multi-device hardware,
        device execution)."""
        with self._lock:
            if self._closed:
                return None
            if self._executor is None:
                self._executor = ThreadPoolExecutor(
                    max_workers=min(8, self.k),
                    thread_name_prefix=f"gk-part-{self.plane}",
                )
            return self._executor

    def close(self) -> None:
        with self._lock:
            self._closed = True
            ex, self._executor = self._executor, None
        if ex is not None:
            ex.shutdown(wait=False)

    # -- introspection ---------------------------------------------------------

    def postmortem(self) -> Dict[str, Any]:
        """The flight-recorder source view: `snapshot()` PLUS each
        partition's constraint keys and, explicitly, the keys belonging
        to quarantined devices' HOME partitions — the "which constraints
        did the sick chip take with it" answer a postmortem needs
        without a live plan to interrogate."""
        snap = self.snapshot()
        with self._lock:
            plan = self._plan
        if plan is not None:
            snap["partition_keys"] = {
                str(p.index): list(p.keys) for p in plan.partitions
            }
            quarantined = set(snap.get("quarantined", ()))
            snap["quarantined_constraint_keys"] = sorted({
                k
                for p in plan.partitions
                if p.home_device in quarantined
                for k in p.keys
            })
        return snap

    def plan_table(self) -> Dict[str, Any]:
        """/debug/partitions: live plan composition — per-partition
        constraint keys, static/measured cost share, home + current
        device — replica-tagged like /debug/costs. Refreshes the plan
        first so the table reflects current churn/health."""
        try:
            plan = self.plan()
        except Exception:
            with self._lock:
                plan = self._plan
        with self._lock:
            static = dict(self._plan_costs.get("static", {}))
            measured = dict(self._plan_costs.get("measured", {}))
        s_total = sum(static.values())
        m_total = sum(v for v in measured.values() if v > 0.0)
        # corpus-analysis flags: statically-excluded keys never appear
        # in a partition row (that's the point), so they are listed at
        # the table level; shadowed keys ride their row — both answer
        # the postmortem question "why didn't this constraint fire"
        shadowed: Dict[str, str] = {}
        if self.corpus is not None:
            try:
                shadowed = dict(self.corpus.shadowed_keys())
            except Exception:
                shadowed = {}
        doc: Dict[str, Any] = {
            "plane": self.plane,
            "k": self.k,
            "generation": plan.generation if plan is not None else None,
            "all_dead": plan.all_dead if plan is not None else None,
            "excluded_static": (
                list(plan.excluded_static) if plan is not None else []
            ),
            "partitions_touched": self.touched_stats(),
            "partitions": [],
        }
        # IR liveness plane (docs/analysis.md §IR analysis): how many
        # provably-dead token slots the feature-liveness mask has
        # dropped from batch encodes on this replica
        driver = getattr(self.client, "_driver", None)
        live_fn = getattr(driver, "liveness_stats", None)
        if live_fn is not None:
            try:
                doc["liveness"] = live_fn()
            except Exception:
                pass
        if self.replica:
            doc["replica"] = self.replica
        if plan is not None:
            for p in plan.partitions:
                s = sum(static.get(k, 0.0) for k in p.keys)
                m = sum(measured.get(k, 0.0) for k in p.keys)
                row = {
                    "index": p.index,
                    "home_device": p.home_device,
                    "device": p.device,
                    "constraints": len(p.keys),
                    "keys": list(p.keys),
                    "static_cost_share":
                        (s / s_total) if s_total > 0 else None,
                    "measured_cost_share":
                        (m / m_total) if m_total > 0 else None,
                }
                row_shadowed = {
                    k: shadowed[k] for k in p.keys if k in shadowed
                }
                if row_shadowed:
                    row["shadowed"] = row_shadowed
                doc["partitions"].append(row)
        return doc

    def programs_table(self) -> Dict[str, Any]:
        """/debug/programs: the compile plane's live view — per
        partition the sub-program content signature, staged/ready
        state and in-flight restage, plus the driver's compile-plane
        counters and program-store stats (hit/miss/rejected, swap
        generation) — replica-tagged like /debug/partitions. Also the
        flight recorder's `programs` source, so a compile_storm
        postmortem carries the store state table."""
        try:
            plan = self.plan()
        except Exception:
            with self._lock:
                plan = self._plan
        driver = getattr(self.client, "_driver", None)
        doc: Dict[str, Any] = {
            "plane": self.plane,
            "partitions": [],
        }
        if self.replica:
            doc["replica"] = self.replica
        stats_fn = getattr(driver, "compile_plane_stats", None)
        if stats_fn is not None:
            try:
                doc["compile_plane"] = stats_fn()
            except Exception:
                pass
        store = getattr(driver, "program_store", None)
        if store is not None:
            try:
                doc["store_table"] = store.table()
            except Exception:
                pass
        sig_fn = getattr(driver, "subset_signature", None)
        ready_fn = getattr(driver, "subset_ready", None)
        with self._lock:
            staged = set(self._staged)
            staging = set(self._staging)
            staged_parts = set(self._staged_parts)
            doc["restage_failures"] = self.restage_failures
            doc["staging_in_flight"] = len(staging)
        if plan is not None:
            for p in plan.partitions:
                sig = ready = None
                if sig_fn is not None:
                    try:
                        sig = sig_fn(self.target, p.subset)
                    except Exception:
                        sig = None
                if ready_fn is not None:
                    try:
                        ready = bool(ready_fn(self.target, p.subset))
                    except Exception:
                        ready = None
                doc["partitions"].append({
                    "index": p.index,
                    "device": p.device,
                    "constraints": len(p.keys),
                    "signature": sig,
                    "ready": ready,
                    "staged": any(
                        (
                            isinstance(t[0], frozenset)
                            and t[0] == p.subset
                            and t[1] == p.device
                        )
                        or (
                            not isinstance(t[0], frozenset)
                            and t[1] == p.index
                            and t[2] == p.device
                        )
                        for t in staged
                    ),
                    "staging_in_flight": (p.subset, p.device) in staging,
                    "ever_staged": p.index in staged_parts,
                })
        return doc

    def snapshot(self) -> Dict[str, Any]:
        """Readyz/debug view: the plan, quarantine state, per-device
        breaker snapshots (keyed by breaker NAME), and dispatch/rehome/
        probe accounting."""
        with self._lock:
            plan = self._plan
            return {
                "plane": self.plane,
                "k": self.k,
                "devices": list(self.devices),
                "plan": plan.to_dict() if plan is not None else None,
                "quarantined": sorted(
                    d for d in self.devices if not self._device_healthy(d)
                ),
                "manual_quarantine": sorted(self._manual_quarantine),
                "quarantine_reasons": {
                    str(d): r
                    for d, r in self._quarantine_reasons.items()
                },
                "breakers": {
                    b.name: b.snapshot()
                    for b in self._breakers.values()
                },
                "dispatches": dict(self.dispatches),
                "partitions_touched": self.touched_stats(),
                "rehomes": self.rehomes,
                "probes": self.probes,
                "restage_failures": self.restage_failures,
                "staging_in_flight": len(self._staging),
            }
