# Copied from gatekeeper_tpu/faults/injection.py; only the docstring
# differs. Edit: it names the port's ladder: a failed fused batch gets
# the fail policy verdict, never a host oracle.
"""Deterministic fault-injection registry.

The admission plane concentrates all risk in one device dispatch: a
failure envelope that is only ever exercised in production is not a
failure envelope, it is a surprise. This registry gives every
interesting failure surface a NAMED fault point threaded into the
production code path itself (`fire("driver.device_dispatch")` sits
inside `TorchDriver._need_pairs`, not in a test double), so tests and
chaos runs drive the REAL degradation ladder — fused batch → fail-policy
verdict — end to end.

Semantics (arm / trigger / fire):
  * `arm(point, mode, ...)` registers a fault spec for a point;
  * every pass through the point is a HIT; the spec triggers only
    after `after` hits have been skipped (deterministic ordering, no
    randomness — chaos runs must be replayable);
  * a triggered spec FIRES at most `count` times (-1 = forever):
    mode "error" raises `FaultError`, mode "hang" sleeps `delay_s`
    then continues (a stall, not a crash), mode "clock_jump" never
    raises — callers that do deadline arithmetic consult `skew()` to
    learn the injected clock offset.

Activation: tier-1 stays clean because nothing is armed by default and
`fire()` is a single boolean check when the registry is empty.
Deployments opt in with
`GATEKEEPER_TPU_FAULTS="point=mode[:key=value...],..."`, e.g.

    GATEKEEPER_TPU_FAULTS="driver.device_dispatch=error:count=5,\
bridge.process=hang:delay=0.25"

The fault-point catalog lives in docs/robustness.md.
"""

from __future__ import annotations

import os
import re
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

MODES = ("error", "hang", "clock_jump")

# point=mode[:modifiers]; the point may itself contain '=' inside a
# device label ("driver.device_dispatch[device=1]=error"), so the split
# anchors on the first '=' that is followed by a KNOWN mode, not on the
# first '=' in the entry
_ENTRY_RE = re.compile(
    r"^(?P<point>.+?)=(?P<mode>" + "|".join(MODES) + r")(?::(?P<rest>.*))?$"
)


def device_point(point: str, device) -> str:
    """Device-labeled fault point name (docs/robustness.md §Fault
    domains): `device_point("driver.device_dispatch", 1)` ->
    `"driver.device_dispatch[device=1]"`. The label is part of the
    point NAME, so arm/hit/fire accounting — and the env-string grammar
    — stays exact per device with zero new registry machinery."""
    return f"{point}[device={device}]"


class FaultError(RuntimeError):
    """The injected failure. Deliberately a plain RuntimeError subclass:
    production code must survive it via the SAME handling it gives real
    faults, never by special-casing injection."""

    def __init__(self, point: str, message: str = ""):
        super().__init__(message or f"injected fault at {point}")
        self.point = point


@dataclass
class FaultSpec:
    """One armed fault point."""

    point: str
    mode: str = "error"
    count: int = -1  # fires at most `count` times; -1 = forever
    after: int = 0  # skip the first `after` hits before triggering
    delay_s: float = 0.05  # hang sleep / clock_jump offset (seconds)
    message: str = ""
    hits: int = field(default=0)  # passes through the point
    fired: int = field(default=0)  # times the fault actually fired


class FaultRegistry:
    """Thread-safe arm/trigger/fire registry (module-global `FAULTS` is
    the instance every production fault point consults)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._specs: Dict[str, FaultSpec] = {}
        # fast-path flag: fire() must cost one attribute read when
        # nothing is armed (the tier-1 / steady-state case)
        self._active = False

    # -- arming --------------------------------------------------------------

    def arm(
        self,
        point: str,
        mode: str = "error",
        count: int = -1,
        after: int = 0,
        delay_s: float = 0.05,
        message: str = "",
    ) -> FaultSpec:
        if mode not in MODES:
            raise ValueError(f"unknown fault mode {mode!r} (want {MODES})")
        spec = FaultSpec(
            point=point, mode=mode, count=count, after=after,
            delay_s=delay_s, message=message,
        )
        with self._lock:
            self._specs[point] = spec
            self._active = True
        return spec

    def disarm(self, point: Optional[str] = None) -> None:
        """Disarm one point (or every point when None). Hit/fire counts
        die with the spec — read them via `spec()` before disarming."""
        with self._lock:
            if point is None:
                self._specs.clear()
            else:
                self._specs.pop(point, None)
            self._active = bool(self._specs)

    def reset(self) -> None:
        self.disarm(None)

    # -- introspection -------------------------------------------------------

    def spec(self, point: str) -> Optional[FaultSpec]:
        with self._lock:
            return self._specs.get(point)

    def hits(self, point: str) -> int:
        with self._lock:
            s = self._specs.get(point)
            return s.hits if s is not None else 0

    def fired(self, point: str) -> int:
        with self._lock:
            s = self._specs.get(point)
            return s.fired if s is not None else 0

    def active(self) -> bool:
        return self._active

    def snapshot(self) -> Dict[str, Dict]:
        """Armed-point inventory with hit/fire counts — the soak
        reporter logs this at each disarm so the evidence artifact
        carries WHICH faults fired and how often, not just that an SLO
        dip happened around the right timestamp."""
        with self._lock:
            return {
                point: {
                    "mode": s.mode,
                    "count": s.count,
                    "after": s.after,
                    "delay_s": s.delay_s,
                    "hits": s.hits,
                    "fired": s.fired,
                }
                for point, s in self._specs.items()
            }

    # -- the fault point ----------------------------------------------------

    def fire(self, point: str) -> None:
        """Called at a production fault point. No-op unless the point is
        armed and its trigger condition holds; then raises (error),
        stalls (hang), or no-ops (clock_jump — see `skew`)."""
        if not self._active:
            return
        with self._lock:
            spec = self._specs.get(point)
            if spec is None:
                return
            spec.hits += 1
            if spec.hits <= spec.after:
                return
            if spec.count >= 0 and spec.fired >= spec.count:
                return
            spec.fired += 1
            mode, delay_s, message = spec.mode, spec.delay_s, spec.message
        if mode == "hang":
            # a stall, not a crash: the caller proceeds afterwards (the
            # deadline/timeout machinery is what must save the request)
            time.sleep(delay_s)
            return
        if mode == "error":
            raise FaultError(point, message)
        # clock_jump: consulted via skew(), never raises at the point

    def skew(self, point: str) -> float:
        """Injected clock offset (seconds) for an armed clock_jump at
        `point`; 0.0 otherwise. Honors the same after/count trigger
        semantics as fire(), so a chaos run can place the jump at a
        deterministic consultation (e.g. AFTER a deadline was computed
        but before it is checked — a real NTP step lands between two
        reads of the clock, not at process start)."""
        if not self._active:
            return 0.0
        with self._lock:
            spec = self._specs.get(point)
            if spec is None or spec.mode != "clock_jump":
                return 0.0
            spec.hits += 1
            if spec.hits <= spec.after:
                return 0.0
            if spec.count >= 0 and spec.fired >= spec.count:
                return 0.0
            spec.fired += 1
            return spec.delay_s


# the registry every production fault point consults
FAULTS = FaultRegistry()


def fire(point: str) -> None:
    FAULTS.fire(point)


def skew(point: str) -> float:
    return FAULTS.skew(point)


def configure_from_env(registry: Optional[FaultRegistry] = None,
                       env: Optional[str] = None) -> int:
    """Parse GATEKEEPER_TPU_FAULTS into armed specs. Grammar (commas
    separate entries, colons separate modifiers):

        point=mode[:count=N][:after=N][:delay=S][:message=...]

    Returns the number of points armed. Unparseable entries are
    skipped — a typo in a chaos knob must not take the pod down."""
    registry = registry if registry is not None else FAULTS
    raw = env if env is not None else os.environ.get(
        "GATEKEEPER_TPU_FAULTS", ""
    )
    armed = 0
    for entry in raw.split(","):
        entry = entry.strip()
        if not entry or "=" not in entry:
            continue
        m = _ENTRY_RE.match(entry)
        if m is None:
            continue
        point, mode = m.group("point"), m.group("mode")
        rest = m.group("rest") or ""
        kwargs = {}
        ok = True
        for part in rest.split(":") if rest else ():
            key, _, val = part.partition("=")
            try:
                if key == "count":
                    kwargs["count"] = int(val)
                elif key == "after":
                    kwargs["after"] = int(val)
                elif key == "delay":
                    kwargs["delay_s"] = float(val)
                elif key == "message":
                    kwargs["message"] = val
                else:
                    ok = False
            except ValueError:
                ok = False
        if not ok:
            continue
        registry.arm(point.strip(), mode=mode, **kwargs)
        armed += 1
    return armed


# env-armed faults activate at import so every plane (driver, webhook,
# bridge, audit) sees the same registry without explicit wiring
configure_from_env()
