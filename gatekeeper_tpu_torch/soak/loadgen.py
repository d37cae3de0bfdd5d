# Copied from gatekeeper_tpu/soak/loadgen.py; no line below differs.
"""Open-loop Poisson load generation.

The defining property — and the reason this exists next to the
closed-loop `replay()` in bench_webhook.py — is that the arrival
process NEVER waits for the system under test. A scheduler thread draws
exponential inter-arrival gaps at the target rate and hands each
arrival to a worker pool; if every worker is busy the arrival queues,
and its measured latency INCLUDES that wait, because latency is counted
from the scheduled arrival instant, not from when a worker got around
to it. A request that misses its deadline (or errors, or is still
queued when the drain window closes) is counted against the SLO —
overload shows up as failed attainment, never as a conveniently
slowed-down arrival rate (coordinated omission).

Determinism: arrivals and plane choices come from one seeded
`random.Random`, so a scenario replays the same schedule every run.
"""

from __future__ import annotations

import queue
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

# outcome statuses beyond an HTTP code: the generator's own verdicts
UNSERVED = "unserved"      # still queued when the drain window closed
CONN_ERROR = "conn_error"  # transport-level failure (refused/reset)
CLIENT_TIMEOUT = "client_timeout"


@dataclass
class Sample:
    t_rel: float        # scheduled arrival, seconds from load start
    plane: str
    latency_s: float    # scheduled arrival -> response (open-loop)
    status: int         # HTTP status; 0 for generator verdicts
    outcome: str        # "ok"/"denied"/CONN_ERROR/CLIENT_TIMEOUT/UNSERVED

    def ok_within(self, deadline_s: float) -> bool:
        return (
            self.outcome in ("ok", "denied")
            and self.status == 200
            and self.latency_s <= deadline_s
        )


@dataclass
class OpenLoopLoad:
    """The result of one open-loop run."""

    target_rps: float
    duration_s: float
    deadline_s: float
    generated: int = 0
    samples: List[Sample] = field(default_factory=list)

    @property
    def achieved_rps(self) -> float:
        if self.duration_s <= 0:
            return 0.0
        return round(self.generated / self.duration_s, 2)

    def slo_attainment(self) -> float:
        if not self.samples:
            return 0.0
        ok = sum(1 for s in self.samples if s.ok_within(self.deadline_s))
        return ok / len(self.samples)


def _weighted_choice(rng: random.Random, weights: Dict[str, float]) -> str:
    total = sum(weights.values())
    x = rng.random() * total
    for name, w in weights.items():
        x -= w
        if x <= 0:
            return name
    return next(iter(weights))


def run_open_loop(
    submit: Callable[[str], Tuple[int, str]],
    rps: float,
    duration_s: float,
    deadline_s: float,
    planes: Optional[Dict[str, float]] = None,
    seed: int = 0,
    max_workers: Optional[int] = None,
    drain_s: Optional[float] = None,
    stop_event: Optional[threading.Event] = None,
    clock: Callable[[], float] = time.monotonic,
) -> OpenLoopLoad:
    """Drive `submit(plane) -> (status, outcome)` with Poisson arrivals
    at `rps` for `duration_s`. Returns every sample; the caller bins
    them into windows. `submit` must be thread-safe and should enforce
    its own transport timeout (a hung submit occupies a worker, which
    is exactly the backlog an open loop is supposed to surface).

    Worker sizing: enough concurrency that a healthy system never
    queues at the generator (2 x rps x deadline, clamped) — anything
    beyond that IS system slowness and belongs in the latency numbers.
    """
    planes = planes or {"validation": 1.0}
    if max_workers is None:
        max_workers = max(8, min(256, int(rps * deadline_s * 2) + 4))
    if drain_s is None:
        drain_s = max(2.0, deadline_s * 2)
    rng = random.Random(seed)
    load = OpenLoopLoad(
        target_rps=rps, duration_s=duration_s, deadline_s=deadline_s
    )
    samples = load.samples
    samples_lock = threading.Lock()
    work: "queue.Queue" = queue.Queue()
    t0 = clock()
    t_end = t0 + duration_s
    stop_workers = threading.Event()

    def worker() -> None:
        while not stop_workers.is_set():
            try:
                item = work.get(timeout=0.1)
            except queue.Empty:
                continue
            if item is None:
                return
            t_sched, plane = item
            try:
                status, outcome = submit(plane)
            except Exception:
                status, outcome = 0, CONN_ERROR
            latency = clock() - t_sched
            with samples_lock:
                samples.append(
                    Sample(
                        t_rel=t_sched - t0,
                        plane=plane,
                        latency_s=latency,
                        status=status,
                        outcome=outcome,
                    )
                )

    threads = [
        threading.Thread(target=worker, name=f"gk-soak-w{i}", daemon=True)
        for i in range(max_workers)
    ]
    for th in threads:
        th.start()

    # the scheduler: cumulative arrival times so timing error never
    # drifts the rate; when we're behind schedule the backlog fires as
    # a burst (open loop: the system's slowness must not slow arrivals)
    next_t = t0
    while True:
        if stop_event is not None and stop_event.is_set():
            break
        next_t += rng.expovariate(rps)
        if next_t >= t_end:
            break
        delay = next_t - clock()
        if delay > 0:
            time.sleep(delay)
        work.put((next_t, _weighted_choice(rng, planes)))
        load.generated += 1

    # drain: give in-flight/queued work a bounded window to finish;
    # whatever is still queued afterwards is an UNSERVED SLO miss, not
    # a silently-dropped data point
    drain_deadline = clock() + drain_s
    while clock() < drain_deadline:
        with samples_lock:
            done = len(samples)
        if done >= load.generated:
            break
        time.sleep(0.02)
    stop_workers.set()
    for th in threads:
        th.join(timeout=1.0)
    leftovers: List[Tuple[float, str]] = []
    while True:
        try:
            item = work.get_nowait()
        except queue.Empty:
            break
        if item is not None:
            leftovers.append(item)
    now = clock()
    with samples_lock:
        for t_sched, plane in leftovers:
            samples.append(
                Sample(
                    t_rel=t_sched - t0,
                    plane=plane,
                    latency_s=now - t_sched,
                    status=0,
                    outcome=UNSERVED,
                )
            )
        # rebind to a sorted COPY: a worker stuck in a hung submit past
        # the join timeout appends (harmlessly) to the orphaned list,
        # never to the result the reporter is reading
        load.samples = sorted(samples, key=lambda s: s.t_rel)
    return load
