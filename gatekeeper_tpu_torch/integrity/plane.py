# Copied from gatekeeper_tpu/integrity/plane.py; only these edits differ.
# Edit: the docstrings name TorchDriver and call review_host an oracle.
# Edit: the shadow oracle evaluates the sampled admissions in a process of
# its own (integrity/oracle.py: the policy at the sample's constraint
# generation, the review, the verdict rows back), off the serving
# process's GIL and the driver's serving mutex, where the reference
# evaluates on the worker thread. The constraints whose template may read
# the synced inventory are evaluated on the worker thread (review_host
# with a subset) and their verdicts joined with the child's before the
# digest; a driver that reports no constraint generation keeps the whole
# evaluation on the worker thread. A sample whose generation moved before
# its policy was sent is counted in shadow_skipped_stale. The sampling,
# the comparison and the quarantine are the reference's. Each
# evaluation's wall interval is kept (`shadow_intervals`; the snapshot
# sums them, and the worker thread's share apart).
"""The verdict-integrity plane (docs/robustness.md §Verdict integrity).

Three detection tiers feed the existing quarantine machinery:

  1. **Canary rows** — the driver packs K synthetic reviews with
     interpreter-pinned golden digests into the padding slots every
     fused dispatch already wastes, and reports the device's canary
     verdicts here (`check_canaries`). A digest mismatch is silent-
     data-corruption evidence against that device, never a policy
     outcome — canary results are stripped before any merge.
  2. **Sampled shadow oracle** — a deterministic CRC(trace_id)
     fraction of live admissions (`note_live`) re-evaluates
     asynchronously post-response on the host interpreter; a
     fused-vs-oracle divergence emits a typed `verdict_divergence`
     decision record plus ONE FlightRecorder capture per burst
     (the recorder's debounce coalesces).
  3. **SDC quarantine + golden self-test** — a per-device mismatch
     ledger (distinct from breaker failure counts) trips
     `PartitionDispatcher.quarantine(device, reason="corruption")`
     at `quarantine_threshold` consecutive mismatching batches; the
     plan rebuild re-homes the device's partitions exactly as a
     breaker trip would. The device heals ONLY after `selftest`
     replays the golden batch clean — corruption quarantine never
     self-heals on a timer the way breaker HALF_OPEN does, because a
     corrupting device that "recovers" silently is the failure mode
     this plane exists to catch.

Fault points `integrity.canary` / `integrity.shadow` /
`integrity.selftest` (plus their device-labeled forms) let the chaos
suite force a bit-flip at each tier without real broken hardware.

Thread-safety: the plane's lock is a leaf — it never calls back into
the driver or dispatcher while held. Quarantine/heal calls happen off
the plane lock, and the driver reports canary results only AFTER
releasing its serving mutex.
"""

from __future__ import annotations

import json
import os
import threading
import time
import zlib
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

from ..constraint.driver import constraint_key
from ..faults.injection import FaultError, device_point, fire
from .canary import DEFAULT_K, result_digest, synth_reviews

__all__ = ["IntegrityPlane", "shadow_sampled"]


class _Stale(Exception):
    """The policy moved past a sample's generation before it was sent."""


def shadow_sampled(trace_id: Optional[str], sample_n: int) -> bool:
    """Deterministic shadow-oracle sampling decision: CRC32 of the
    trace id, 1-in-`sample_n`. The same hash family the decision log
    uses for keep sampling — every replica makes the SAME decision for
    the same trace, so a fleet's shadow coverage is disjoint-free and
    a divergence report is reproducible by replaying the trace id."""
    if not trace_id or sample_n <= 0:
        return False
    return zlib.crc32(str(trace_id).encode()) % sample_n == 0


class IntegrityPlane:
    """Process-wide verdict-integrity state: golden canary sets, the
    per-device mismatch ledger, the shadow-oracle queue/worker, and
    self-test healing. One instance per Runner, wired into the driver
    (`set_integrity`), the micro-batchers, and the PartitionDispatcher.
    """

    def __init__(
        self,
        metrics: Optional[Any] = None,
        decisions: Optional[Any] = None,
        recorder: Optional[Any] = None,
        store: Optional[Any] = None,
        canaries_per_dispatch: int = DEFAULT_K,
        shadow_sample_n: int = 8,
        quarantine_threshold: int = 2,
        selftest_interval_s: float = 30.0,
        shadow_queue_max: int = 256,
    ):
        self.metrics = metrics
        self.decisions = decisions
        self.recorder = recorder
        self.store = store  # compile.ProgramStore (golden sidecars) or None
        self.k = max(1, int(canaries_per_dispatch))
        self.shadow_sample_n = max(0, int(shadow_sample_n))
        self.quarantine_threshold = max(1, int(quarantine_threshold))
        self.selftest_interval_s = float(selftest_interval_s)
        self._lock = threading.RLock()
        self._tl = threading.local()  # .suppress — no canaries in selftest
        # (target, sigkey) -> {"reviews": [...], "digests": [...]}
        self._golden: Dict[Any, Dict[str, Any]] = {}
        # per-device ledger: consecutive mismatching batches + totals
        self._consecutive: Dict[int, int] = {}
        self._mismatches: Dict[int, int] = {}
        self._quarantined: Dict[int, Dict[str, Any]] = {}
        self.canary_rows = 0
        self.canary_batches = 0
        self.canary_mismatch_batches = 0
        self.shadow_sampled_n = 0
        self.shadow_divergences = 0
        self.shadow_skipped_stale = 0
        self.shadow_dropped = 0
        self.selftest_pass = 0
        self.selftest_fail = 0
        self._selftest_last: Dict[int, float] = {}
        self._shadow_q: deque = deque(maxlen=max(1, int(shadow_queue_max)))
        self._shadow_event = threading.Event()
        self._oracle_proc = None
        # at _split_gen: the constraint kinds that may read the inventory,
        # their constraints' keys, and whether any constraint is left over
        self._split_gen: Any = object()
        self._split: Any = None
        # wall intervals (perf_counter) of the oracle's evaluations
        self.shadow_intervals: deque = deque(maxlen=8192)
        self.shadow_eval_seconds = 0.0
        self.shadow_thread_seconds = 0.0
        self.shadow_evaluated = 0
        self._worker: Optional[threading.Thread] = None
        self._closed = False
        self._driver = None
        self._client = None
        self._dispatcher = None

    # -- wiring --------------------------------------------------------------

    def bind_driver(self, driver) -> None:
        """Called by TorchDriver.set_integrity: the driver reference
        serves constraint-generation staleness checks and self-test
        dispatch routing."""
        self._driver = driver

    def attach_client(self, client) -> None:
        """The shadow oracle re-evaluates through Client.review_host
        (the host interpreter, an oracle here: no admission answer is
        served from it)."""
        self._client = client

    def attach_dispatcher(self, dispatcher) -> None:
        """The PartitionDispatcher whose quarantine the mismatch
        ledger trips (None = monolithic deployment: detection still
        runs, quarantine state is plane-local only)."""
        self._dispatcher = dispatcher

    def close(self) -> None:
        self._closed = True
        self._shadow_event.set()
        with self._lock:
            proc, self._oracle_proc = self._oracle_proc, None
        if proc is not None:
            proc.close()

    # -- tier 1: canary rows -------------------------------------------------

    @property
    def _suppressed(self) -> bool:
        return bool(getattr(self._tl, "suppress", False))

    def canaries_for(
        self,
        target: str,
        sigkey: str,
        constraints: Sequence[Dict[str, Any]],
        interp,
        slots: int,
    ) -> List[Dict[str, Any]]:
        """The canary reviews the driver should pack into this
        dispatch's padding slots (at most min(k, slots); empty during
        a self-test replay so the golden batch itself is never
        re-canaried). First call per (target, signature) derives the
        golden set: synthesized reviews evaluated through `interp` —
        the driver's host-interpreter closure over the SAME constraint
        set the fused dispatch serves — and pinned as per-review
        digests (persisted as a ProgramStore sidecar when a store is
        wired)."""
        if self._suppressed or slots <= 0 or not constraints:
            return []
        entry = self._golden_entry(target, sigkey, constraints, interp)
        if entry is None:
            return []
        return entry["reviews"][: min(self.k, int(slots))]

    def _golden_entry(
        self, target, sigkey, constraints, interp
    ) -> Optional[Dict[str, Any]]:
        key = (target, sigkey)
        with self._lock:
            entry = self._golden.get(key)
        if entry is not None:
            return entry
        entry = self._sidecar_load(target, sigkey)
        if entry is None:
            try:
                reviews = synth_reviews(constraints, self.k)
                digests = [result_digest(interp(r)) for r in reviews]
            except Exception:
                return None  # derivation must never fail a dispatch
            entry = {"reviews": reviews, "digests": digests}
            self._sidecar_save(target, sigkey, entry)
        with self._lock:
            self._golden.setdefault(key, entry)
            return self._golden[key]

    def golden_for(
        self, target: str, sigkey: str, constraints, interp
    ) -> Optional[Dict[str, Any]]:
        """Public golden-set accessor (the warm-swap gate and the
        analysis canary gate use it): {"reviews", "digests"}."""
        return self._golden_entry(target, sigkey, constraints, interp)

    def check_canaries(
        self,
        target: str,
        sigkey: str,
        device: int,
        canary_results: Sequence[Sequence[Any]],
        subset=None,
        plane: str = "validate",
    ) -> bool:
        """Compare one dispatch's canary verdicts against the golden
        digests. Returns True when clean. A mismatch (or an armed
        `integrity.canary` fault — the injectable bit-flip) increments
        the device's ledger; `quarantine_threshold` CONSECUTIVE
        mismatching batches trip corruption quarantine. Called by the
        driver AFTER its serving mutex is released."""
        if not canary_results:
            return True
        with self._lock:
            entry = self._golden.get((target, sigkey))
        if entry is None:
            return True
        device = int(device)
        corrupted = False
        try:
            fire("integrity.canary")
            fire(device_point("integrity.canary", device))
        except FaultError:
            corrupted = True
        got = [result_digest(rs) for rs in canary_results]
        expect = entry["digests"][: len(got)]
        mismatch = corrupted or got != expect
        if self.metrics is not None:
            self.metrics.record(
                "integrity_canary_rows_total", len(got), device=device
            )
        trip = False
        with self._lock:
            self.canary_rows += len(got)
            self.canary_batches += 1
            if mismatch:
                self.canary_mismatch_batches += 1
                self._mismatches[device] = (
                    self._mismatches.get(device, 0) + 1
                )
                n = self._consecutive.get(device, 0) + 1
                self._consecutive[device] = n
                if (
                    n >= self.quarantine_threshold
                    and device not in self._quarantined
                ):
                    self._quarantined[device] = {
                        "reason": "corruption",
                        "target": target,
                        "signature": sigkey,
                        "subset": (
                            sorted(subset) if subset is not None else None
                        ),
                        "plane": plane,
                        "since": time.monotonic(),
                    }
                    trip = True
            else:
                self._consecutive[device] = 0
        if mismatch and self.metrics is not None:
            self.metrics.record(
                "integrity_canary_mismatch_total", 1, device=device
            )
        if trip:
            disp = self._dispatcher
            if disp is not None:
                try:
                    disp.quarantine(device, reason="corruption")
                except TypeError:
                    disp.quarantine(device)
        return not mismatch

    # -- tier 2: sampled shadow oracle ---------------------------------------

    def note_live(
        self,
        trace_id: Optional[str],
        obj: Any,
        results: Sequence[Any],
        plane: str = "validate",
        **facts,
    ) -> bool:
        """Post-response hook from the micro-batchers: maybe enqueue
        this admission for asynchronous host-oracle re-evaluation.
        Returns True when sampled. Only the live verdict DIGEST is
        retained up front — the repro bundle (full review) rides along
        for the flight record, never re-serialized on the hot path."""
        if self._closed or self._client is None:
            return False
        if not shadow_sampled(trace_id, self.shadow_sample_n):
            return False
        if self.metrics is not None:
            self.metrics.record(
                "integrity_shadow_sampled_total", 1, plane=plane
            )
        gen = getattr(self._driver, "_constraint_gen", None)
        with self._lock:
            self.shadow_sampled_n += 1
            if len(self._shadow_q) == self._shadow_q.maxlen:
                self.shadow_dropped += 1
        self._shadow_q.append(
            (trace_id, obj, result_digest(results), plane, gen, facts)
        )
        self._ensure_worker()
        self._shadow_event.set()
        return True

    def _ensure_worker(self) -> None:
        if self._worker is not None and self._worker.is_alive():
            return
        with self._lock:
            if self._worker is not None and self._worker.is_alive():
                return
            self._worker = threading.Thread(
                target=self._worker_loop,
                name="integrity-shadow",
                daemon=True,
            )
            self._worker.start()

    def _worker_loop(self) -> None:
        while not self._closed:
            self._shadow_event.wait(timeout=1.0)
            self._shadow_event.clear()
            while True:
                try:
                    item = self._shadow_q.popleft()
                except IndexError:
                    break
                try:
                    self._shadow_eval(*item)
                except Exception:
                    pass  # the oracle must never take the plane down
            self._maybe_selftests()

    def drain_shadow(self, timeout_s: float = 5.0) -> None:
        """Synchronously work the shadow queue dry (tests/bench): runs
        evaluations inline on the caller's thread so assertions don't
        race the worker."""
        deadline = time.monotonic() + timeout_s
        while self._shadow_q and time.monotonic() < deadline:
            try:
                item = self._shadow_q.popleft()
            except IndexError:
                break
            try:
                self._shadow_eval(*item)
            except Exception:
                pass

    def _shadow_eval(
        self, trace_id, obj, live_digest, plane, gen, facts
    ) -> None:
        client = self._client
        if client is None:
            return
        now_gen = getattr(self._driver, "_constraint_gen", None)
        if gen is not None and now_gen != gen:
            # the corpus churned since the live verdict: the oracle
            # would evaluate a DIFFERENT policy — a mismatch here is
            # churn, not corruption
            with self._lock:
                self.shadow_skipped_stale += 1
            return
        corrupted = False
        try:
            fire("integrity.shadow")
        except FaultError:
            corrupted = True
        intervals, on_thread = [], []
        if gen is None:
            results = self._host_results(client, obj, None, on_thread)
        else:
            inv_kinds, inv_keys, rest = self._inventory_split(gen)
            results = []
            if rest:
                try:
                    rows, t0, t1 = self._oracle().evaluate(
                        gen, lambda: self._policy_at(gen, inv_kinds), obj
                    )
                except _Stale:
                    with self._lock:
                        self.shadow_skipped_stale += 1
                    return
                intervals.append((t0, t1))
                results.extend(rows)
            if inv_keys:
                results.extend(
                    self._host_results(client, obj, inv_keys, on_thread)
                )
        oracle_digest = result_digest(results)
        with self._lock:
            for t0, t1 in intervals + on_thread:
                self.shadow_intervals.append((t0, t1))
                self.shadow_eval_seconds += t1 - t0
            self.shadow_thread_seconds += sum(b - a for a, b in on_thread)
            self.shadow_evaluated += 1
        if not corrupted and oracle_digest == live_digest:
            return
        with self._lock:
            self.shadow_divergences += 1
        if self.metrics is not None:
            self.metrics.record(
                "integrity_shadow_divergence_total", 1, plane=plane
            )
        if self.decisions is not None:
            try:
                self.decisions.record_decision(
                    plane,
                    "verdict_divergence",
                    code=500,
                    trace_id=trace_id,
                    message="fused verdict diverged from host oracle",
                    live_digest=live_digest,
                    oracle_digest=oracle_digest,
                    **facts,
                )
            except Exception:
                pass
        if self.recorder is not None:
            try:
                # debounce in the recorder coalesces a burst of
                # divergences into ONE record carrying the repro bundle
                self.recorder.trigger(
                    "verdict_divergence",
                    trace_id=trace_id,
                    plane=plane,
                    review=obj,
                    live_digest=live_digest,
                    oracle_digest=oracle_digest,
                    **facts,
                )
            except Exception:
                pass

    def _host_results(self, client, obj, subset, intervals) -> List[Any]:
        """Verdicts of `subset`'s constraints (all when None) on this
        thread's interpreter."""
        t0 = time.perf_counter()
        resps = client.review_host(obj, subset=subset)
        intervals.append((t0, time.perf_counter()))
        return [
            r for resp in getattr(resps, "by_target", {}).values()
            for r in resp.results
        ]

    def _inventory_split(self, gen):
        """-> (kinds, keys, rest) at constraint generation `gen`: the
        constraint kinds whose template may read the synced inventory
        (the oracle process holds none, so this thread evaluates them),
        their constraints' keys, and whether any other constraint is left
        for the process. A driver that cannot tell puts every kind here."""
        if self._split_gen != gen:
            drv, client = self._driver, self._client
            reads = getattr(drv, "_reads_inventory", None)
            kinds, keys, rest, seen = set(), set(), False, {}
            for t in getattr(client, "targets", {}):
                for c in drv._constraints(t):
                    kind = c.get("kind")
                    if (t, kind) not in seen:
                        seen[t, kind] = reads is None or reads(t, [c])
                    if seen[t, kind]:
                        kinds.add(kind)
                        keys.add(constraint_key(c))
                    else:
                        rest = True
            self._split = (frozenset(kinds), frozenset(keys), rest)
            self._split_gen = gen
        return self._split
    def _oracle(self):
        """The oracle process, started on first use and again if it died."""
        with self._lock:
            proc = self._oracle_proc
            if proc is not None and not proc.alive:
                proc.close()
                self._oracle_proc = None
            if self._oracle_proc is None:
                from .oracle import OracleProcess

                self._oracle_proc = OracleProcess()
            return self._oracle_proc

    def _policy_at(self, gen, leave_out=frozenset()):
        """The attached client's policy without the constraint kinds in
        `leave_out`, if it is still the one at constraint generation
        `gen` once copied."""
        from .oracle import policy_snapshot

        policy = policy_snapshot(self._client, leave_out)
        if getattr(self._driver, "_constraint_gen", None) != gen:
            raise _Stale()
        return policy

    # -- tier 3: golden self-test + heal -------------------------------------

    def _maybe_selftests(self) -> None:
        if self.selftest_interval_s <= 0:
            return
        now = time.monotonic()
        with self._lock:
            due = [
                d
                for d in self._quarantined
                if now - self._selftest_last.get(d, 0.0)
                >= self.selftest_interval_s
            ]
        for device in due:
            self._selftest_last[device] = now
            try:
                self.selftest(device)
            except Exception:
                pass

    def selftest(self, device: int) -> bool:
        """Replay the golden batch against the suspect device and heal
        on a clean run. The `integrity.selftest` fault point (plain and
        device-labeled) injects a still-corrupting device; a corruption
        quarantine can ONLY clear through this path — there is no
        timer-driven half-open for SDC."""
        device = int(device)
        with self._lock:
            info = self._quarantined.get(device)
        ok = True
        try:
            fire("integrity.selftest")
            fire(device_point("integrity.selftest", device))
        except FaultError:
            ok = False
        if ok and info is not None:
            ok = self._replay_golden(device, info)
        if self.metrics is not None:
            self.metrics.record(
                "integrity_selftest_total",
                1,
                result="pass" if ok else "fail",
            )
        with self._lock:
            if ok:
                self.selftest_pass += 1
                self._quarantined.pop(device, None)
                self._consecutive[device] = 0
            else:
                self.selftest_fail += 1
        if ok:
            disp = self._dispatcher
            if disp is not None:
                try:
                    disp.heal(device)
                except Exception:
                    pass
        return ok

    def _replay_golden(self, device: int, info: Dict[str, Any]) -> bool:
        drv = self._driver
        target = info.get("target")
        with self._lock:
            entry = self._golden.get((target, info.get("signature")))
        if drv is None or entry is None:
            return True  # nothing to replay against — the fault point
            # above remains the injectable corruption signal
        path = f'hooks["{target}"].violation'
        inputs = [{"review": r} for r in entry["reviews"]]
        self._tl.suppress = True  # golden batch must not re-canary
        try:
            subset = info.get("subset")
            if subset:
                resps = drv.query_many_subset(
                    path, inputs, subset, device=device
                )
            else:
                resps = drv.query_many(path, inputs)
            got = [result_digest(r.results) for r in resps]
            return got == entry["digests"][: len(got)]
        except Exception:
            return False
        finally:
            self._tl.suppress = False

    # -- golden sidecars (compile.ProgramStore) ------------------------------

    def _sidecar_path(self, target: str, sigkey: str) -> Optional[str]:
        store = self.store
        root = getattr(store, "artifacts_dir", None)
        if not root:
            return None
        h = zlib.crc32(f"{target}|{sigkey}".encode())
        return os.path.join(root, f"canary-{h:08x}.json")

    def _sidecar_load(self, target, sigkey) -> Optional[Dict[str, Any]]:
        path = self._sidecar_path(target, sigkey)
        if path is None or not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                doc = json.load(f)
            reviews = doc.get("reviews")
            digests = doc.get("digests")
            if (
                isinstance(reviews, list)
                and isinstance(digests, list)
                and len(reviews) == len(digests)
            ):
                return {"reviews": reviews, "digests": digests}
        except Exception:
            pass
        return None

    def _sidecar_save(self, target, sigkey, entry) -> None:
        path = self._sidecar_path(target, sigkey)
        if path is None:
            return
        try:
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(
                    {
                        "target": target,
                        "signature": sigkey,
                        "reviews": entry["reviews"],
                        "digests": entry["digests"],
                    },
                    f,
                )
            os.replace(tmp, path)
        except Exception:
            pass

    # -- observability -------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """/debug/integrity + /readyz stats.integrity payload."""
        now = time.monotonic()
        with self._lock:
            per_device = {
                str(d): {
                    "mismatches": self._mismatches.get(d, 0),
                    "consecutive": self._consecutive.get(d, 0),
                }
                for d in set(self._mismatches) | set(self._consecutive)
                if self._mismatches.get(d, 0)
                or self._consecutive.get(d, 0)
            }
            quarantined = {
                str(d): {
                    "reason": info.get("reason"),
                    "target": info.get("target"),
                    "signature": info.get("signature"),
                    "plane": info.get("plane"),
                    "for_s": round(now - info.get("since", now), 3),
                }
                for d, info in self._quarantined.items()
            }
            return {
                "canary": {
                    "golden_sets": len(self._golden),
                    "per_dispatch": self.k,
                    "rows": self.canary_rows,
                    "batches": self.canary_batches,
                    "mismatch_batches": self.canary_mismatch_batches,
                    "per_device": per_device,
                },
                "shadow": {
                    "evaluated": self.shadow_evaluated,
                    "eval_seconds": self.shadow_eval_seconds,
                    "thread_seconds": self.shadow_thread_seconds,
                    "sample_n": self.shadow_sample_n,
                    "sampled": self.shadow_sampled_n,
                    "divergences": self.shadow_divergences,
                    "skipped_stale": self.shadow_skipped_stale,
                    "dropped": self.shadow_dropped,
                    "queue": len(self._shadow_q),
                },
                "selftest": {
                    "pass": self.selftest_pass,
                    "fail": self.selftest_fail,
                    "interval_s": self.selftest_interval_s,
                },
                "quarantined": quarantined,
                "quarantine_threshold": self.quarantine_threshold,
            }
