# Copied from gatekeeper_tpu/metrics/registry.py; only this edit differs.
# Edit: the module logger is named gatekeeper_tpu_torch.metrics.
"""In-process metrics: counters, gauges, distributions with optional
histogram buckets; Prometheus text format exposition (with OpenMetrics
trace-id exemplars) over stdlib HTTP. Per-family series cardinality is
capped (`max_series_per_family`) so an unbounded label — pathological
constraint churn under `constraint_device_seconds_total{kind,name}` —
drops new series (counted in `metrics_dropped_series_total`) instead
of growing the registry without bound."""

from __future__ import annotations

import bisect
import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Sequence, Tuple

_log = logging.getLogger("gatekeeper_tpu_torch.metrics")

# per-family live-series cap (env-overridable): the registry's defense
# against label-cardinality leaks — the soak leak sampler watches
# series_count(), this cap is what makes that curve provably bounded
DEFAULT_MAX_SERIES_PER_FAMILY = int(
    os.environ.get("GATEKEEPER_TPU_METRICS_MAX_SERIES", "512")
)

# the drop accounting must never itself be droppable (it is one series
# per capped family — bounded by the family-name universe, not labels)
_DROP_FAMILY = "metrics_dropped_series_total"

# Default latency buckets for *_seconds distributions (14 finite bounds
# + +Inf at exposition). Spans 100µs..30s: the fused admission path p50
# sits in the low milliseconds while a cold XLA compile is tens of
# seconds — the p99 cliff BENCH_r05 surfaced needs resolution at BOTH
# ends or the histogram quantiles saturate exactly where they matter.
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


def _tag_key(tags: Dict[str, Any]) -> Tuple:
    return tuple(sorted((k, str(v)) for k, v in tags.items()))


@dataclass
class _Dist:
    count: int = 0
    total: float = 0.0
    minimum: float = float("inf")
    maximum: float = float("-inf")
    # histogram bounds (ascending) and per-bound NON-cumulative counts;
    # cumulation happens at exposition. None = plain summary.
    bounds: Optional[Tuple[float, ...]] = None
    bucket_counts: Optional[List[int]] = None
    # last (trace_id, value, wall ts) exemplar per bucket — the
    # OpenMetrics hook connecting a latency bucket to the trace that
    # landed in it (docs/observability.md §Exemplars)
    exemplars: Optional[List[Optional[Tuple[str, float, float]]]] = None

    def add(self, v: float, exemplar: Optional[str] = None) -> None:
        self.count += 1
        self.total += v
        self.minimum = min(self.minimum, v)
        self.maximum = max(self.maximum, v)
        if self.bounds is not None:
            # index of the first bound >= v (le semantics); v above the
            # last bound lands in the trailing +Inf slot
            idx = bisect.bisect_left(self.bounds, v)
            self.bucket_counts[idx] += 1
            if exemplar is not None:
                if self.exemplars is None:
                    self.exemplars = [None] * len(self.bucket_counts)
                self.exemplars[idx] = (str(exemplar), v, time.time())


class MetricsRegistry:
    """Record-style API mirroring pkg/metrics/record.go: one call site
    per measurement, tags as keyword args.

    Distributions whose name ends in `_seconds` get
    DEFAULT_LATENCY_BUCKETS automatically and expose as Prometheus
    histograms (`_bucket`/`_sum`/`_count` plus `_min`/`_max` gauges);
    override per metric with `set_buckets` (before the first sample) or
    pass `buckets=()` to keep a bucketless summary."""

    def __init__(self, max_series_per_family: Optional[int] = None):
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, Tuple], float] = {}
        self._gauges: Dict[Tuple[str, Tuple], float] = {}
        self._dists: Dict[Tuple[str, Tuple], _Dist] = {}
        self._bucket_conf: Dict[str, Tuple[float, ...]] = {}
        self._help: Dict[str, str] = {}
        # cardinality guard state: live series per family, dropped
        # series attempts per family, families already warned about
        self.max_series_per_family = (
            DEFAULT_MAX_SERIES_PER_FAMILY
            if max_series_per_family is None
            else int(max_series_per_family)
        )
        self._family_counts: Dict[str, int] = {}
        self._dropped: Dict[str, int] = {}
        self._warned: set = set()

    def _admit_locked(self, store: Dict, key: Tuple[str, Tuple]) -> bool:
        """Cardinality guard (caller holds the lock): an EXISTING
        series always updates; a NEW series is admitted only while its
        family is under the cap. The caller accounts a refusal via
        `_note_dropped` AFTER releasing the lock."""
        if key in store:
            return True
        name = key[0]
        if (
            name != _DROP_FAMILY
            and self._family_counts.get(name, 0)
            >= self.max_series_per_family
        ):
            return False
        self._family_counts[name] = self._family_counts.get(name, 0) + 1
        return True

    def _note_dropped(self, name: str) -> None:
        """Account one capped insert: the per-family drop counter —
        one bounded series per capped family, exempt from the cap
        itself — plus a once-per-family warning log."""
        warn = False
        with self._lock:
            self._dropped[name] = self._dropped.get(name, 0) + 1
            if name not in self._warned:
                self._warned.add(name)
                warn = True
        self.record("metrics_dropped_series_total", 1, family=name)
        if warn:
            _log.warning(
                "metric family %r hit the %d-series cardinality cap; "
                "dropping new label sets (see "
                "metrics_dropped_series_total)",
                name, self.max_series_per_family,
            )

    # -- configuration -------------------------------------------------------

    def set_buckets(self, name: str, bounds: Sequence[float]) -> None:
        """Histogram bounds for `name` (ascending; +Inf is implicit).
        An empty sequence forces plain summary exposition. Applies to
        samples recorded AFTER the call — configure at wiring time."""
        self._bucket_conf[name] = tuple(sorted(set(float(b) for b in bounds)))

    def describe(self, name: str, text: str) -> None:
        """# HELP text for `name` (one line; defaults to the name)."""
        self._help[name] = " ".join(str(text).split())

    def _bounds_for(self, name: str) -> Optional[Tuple[float, ...]]:
        conf = self._bucket_conf.get(name)
        if conf is not None:
            return conf or None
        if name.endswith("_seconds"):
            return DEFAULT_LATENCY_BUCKETS
        return None

    # -- write ---------------------------------------------------------------

    def record(self, name: str, value: float = 1, /, **tags) -> None:
        """Add to a counter. `name`/`value` are positional-only so a
        LABEL may itself be called `name` (the cost-attribution series
        tags constraints by kind + name)."""
        key = (name, _tag_key(tags))
        with self._lock:
            admitted = self._admit_locked(self._counters, key)
            if admitted:
                self._counters[key] = self._counters.get(key, 0) + value
        if not admitted:
            self._note_dropped(name)

    def gauge(self, name: str, value: float, /, **tags) -> None:
        key = (name, _tag_key(tags))
        with self._lock:
            admitted = self._admit_locked(self._gauges, key)
            if admitted:
                self._gauges[key] = value
        if not admitted:
            self._note_dropped(name)

    def observe(
        self, name: str, value: float, /, exemplar: Optional[str] = None,
        **tags,
    ) -> None:
        """Add a sample to a distribution (latency histograms).
        `exemplar` attaches a trace id to the sample's bucket, exposed
        in OpenMetrics exemplar syntax — the hop from a p99 bucket to
        the exact trace that landed in it."""
        key = (name, _tag_key(tags))
        with self._lock:
            d = self._dists.get(key)
            if d is None:
                if not self._admit_locked(self._dists, key):
                    d = None
                else:
                    bounds = self._bounds_for(name)
                    d = self._dists[key] = _Dist(
                        bounds=bounds,
                        bucket_counts=(
                            [0] * (len(bounds) + 1)
                            if bounds is not None
                            else None
                        ),
                    )
            if d is not None:
                d.add(value, exemplar=exemplar)
        if d is None:
            self._note_dropped(name)

    def timed(self, name: str, **tags):
        """Context manager: records elapsed seconds into `name`, tagged
        `status=ok|error` by whether the block raised (unless the
        caller already supplied a status tag) — error latency must be
        separable from success latency or timeouts hide inside p99."""
        reg = self

        class _Timer:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, exc_type, *exc):
                out = tags
                if "status" not in tags:
                    out = dict(tags)
                    out["status"] = "error" if exc_type else "ok"
                reg.observe(name, time.perf_counter() - self.t0, **out)
                return False

        return _Timer()

    # -- read ----------------------------------------------------------------

    def series_count(self) -> int:
        """Total live series (counter + gauge + distribution label
        combinations). Label cardinality is the classic slow metrics
        leak; the soak sampler watches this number per window so an
        unbounded tag (a per-request id, a timestamp label) flags
        instead of OOMing a three-day-old pod."""
        with self._lock:
            return (
                len(self._counters) + len(self._gauges) + len(self._dists)
            )

    def dropped_series(self) -> Dict[str, int]:
        """{family -> new-series inserts dropped by the cardinality
        cap}. Non-empty means a label set outgrew
        `max_series_per_family` — the soak sampler records the total so
        a capped (bounded) registry is distinguishable from a leak."""
        with self._lock:
            return dict(self._dropped)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "counters": {
                    self._fmt(k): v for k, v in self._counters.items()
                },
                "gauges": {self._fmt(k): v for k, v in self._gauges.items()},
                "distributions": {
                    self._fmt(k): {
                        "count": d.count,
                        "sum": d.total,
                        "min": d.minimum if d.count else None,
                        "max": d.maximum if d.count else None,
                        "avg": d.total / d.count if d.count else None,
                        **(
                            {
                                "buckets": [
                                    [b, c]
                                    for b, c in zip(
                                        list(d.bounds) + ["+Inf"],
                                        _cumulate(d.bucket_counts),
                                    )
                                ]
                            }
                            if d.bounds is not None
                            else {}
                        ),
                    }
                    for k, d in self._dists.items()
                },
            }

    @staticmethod
    def _escape(v: str) -> str:
        """Prometheus exposition label-value escaping: backslash, double
        quote, and newline must be escaped or scrapers reject the page."""
        return (
            v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
        )

    @classmethod
    def _fmt(cls, key: Tuple[str, Tuple]) -> str:
        name, tags = key
        if not tags:
            return name
        inner = ",".join(f'{k}="{cls._escape(v)}"' for k, v in tags)
        return f"{name}{{{inner}}}"

    @staticmethod
    def _suffixed(base: str, suffix: str, extra_label: str = "") -> str:
        """Attach a series suffix to the metric NAME (before the label
        braces), optionally injecting one extra label (le for
        buckets)."""
        if "{" in base:
            stem, rest = base.split("{", 1)
            if extra_label:
                rest = f"{extra_label},{rest}"
            return f"{stem}{suffix}{{{rest}"
        if extra_label:
            return f"{base}{suffix}{{{extra_label}}}"
        return f"{base}{suffix}"

    def prometheus_text(self, prefix: str = "gatekeeper_") -> str:
        """Prometheus exposition format (prometheus_exporter.go's output
        namespace is "gatekeeper"). Every family gets `# HELP` and
        `# TYPE`; bucketed distributions expose as histograms,
        bucketless ones as summaries, and both carry `_min`/`_max`
        gauge companions (docs/metrics.md's distribution contract)."""
        lines = []
        typed = set()

        def _head(name: str, kind: str) -> None:
            if name not in typed:
                typed.add(name)
                help_text = self._help.get(
                    name, name.replace("_", " ")
                )
                lines.append(f"# HELP {prefix}{name} {help_text}")
                lines.append(f"# TYPE {prefix}{name} {kind}")

        def _fnum(v: float) -> str:
            return repr(v) if isinstance(v, float) else str(v)

        with self._lock:
            for (name, tags), v in sorted(self._counters.items()):
                _head(name, "counter")
                lines.append(f"{prefix}{self._fmt((name, tags))} {v}")
            for (name, tags), v in sorted(self._gauges.items()):
                _head(name, "gauge")
                lines.append(f"{prefix}{self._fmt((name, tags))} {v}")
            for (name, tags), d in sorted(self._dists.items()):
                kind = "histogram" if d.bounds is not None else "summary"
                _head(name, kind)
                base = self._fmt((name, tags))
                if d.bounds is not None:
                    cum = _cumulate(d.bucket_counts)

                    def _ex(idx: int) -> str:
                        # OpenMetrics exemplar: `# {trace_id="…"} v ts`
                        # appended to the bucket the sample landed in
                        if d.exemplars is None or d.exemplars[idx] is None:
                            return ""
                        tid, val, ts = d.exemplars[idx]
                        return (
                            f' # {{trace_id="{self._escape(tid)}"}}'
                            f" {_fnum(float(val))} {_fnum(float(ts))}"
                        )

                    for i, (bound, c) in enumerate(zip(d.bounds, cum)):
                        series = self._suffixed(
                            base, "_bucket",
                            f'le="{_fnum(float(bound))}"',
                        )
                        lines.append(f"{prefix}{series} {c}{_ex(i)}")
                    inf = self._suffixed(base, "_bucket", 'le="+Inf"')
                    lines.append(
                        f"{prefix}{inf} {d.count}{_ex(len(d.bounds))}"
                    )
                lines.append(
                    f"{prefix}{self._suffixed(base, '_count')} {d.count}"
                )
                lines.append(
                    f"{prefix}{self._suffixed(base, '_sum')} {d.total}"
                )
                if d.count:
                    # min/max companions (no native Prometheus slot in
                    # either histogram or summary): typed as gauges
                    for suffix, val in (
                        ("_min", d.minimum), ("_max", d.maximum)
                    ):
                        _head(f"{name}{suffix}", "gauge")
                        lines.append(
                            f"{prefix}{self._suffixed(base, suffix)} {val}"
                        )
        return "\n".join(lines) + "\n"


def _cumulate(counts: List[int]) -> List[int]:
    out, acc = [], 0
    for c in counts:
        acc += c
        out.append(acc)
    return out


def serve_metrics(
    registry: MetricsRegistry,
    port: int = 0,
    bind_addr: str = "127.0.0.1",
    tracer=None,
    attributor=None,
    recorder=None,
    decisions=None,
    partitions=None,
    slo=None,
    sched=None,
) -> ThreadingHTTPServer:
    """Serve /metrics (Prometheus text) on a background thread; returns
    the server (server_address[1] carries the bound port). The reference
    serves the same on --prometheus-port 8888; in-cluster runs bind
    0.0.0.0 so Prometheus can scrape the pod IP (run.py wires this).
    With a tracer, /debug/traces serves the trace ring (?trace_id= /
    ?limit= / ?format=otlp — docs/observability.md); an attributor adds
    /debug/costs (the top-K cost table), a flight recorder adds
    /debug/flightrecords, a decision log adds /debug/decisions, an SLO
    engine adds /debug/slo (live attainment/burn/saturation,
    docs/observability.md §SLO & saturation), a sched callable
    (returning per-plane scheduler snapshots) adds /debug/sched
    (admission scheduling: policy/overload/shed split + per-tenant
    quota table, docs/operations.md §Admission scheduling), and a
    partition dispatcher adds /debug/partitions (the live cost/locality
    plan composition) and /debug/programs (the compile plane: per-
    partition sub-program signatures + program-store stats,
    docs/compile.md) — the same debug surface the health plane
    serves."""

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802
            route = self.path.split("?")[0]
            if route == "/metrics":
                payload = registry.prometheus_text().encode()
                ctype = "text/plain; version=0.0.4"
            elif tracer is not None and route == "/debug/traces":
                payload = export_traces(tracer, self.path).encode()
                ctype = "application/json"
            elif attributor is not None and route == "/debug/costs":
                payload = json.dumps(
                    attributor.table(_debug_costs_k(self.path))
                ).encode()
                ctype = "application/json"
            elif recorder is not None and route == "/debug/flightrecords":
                payload = recorder.export_json().encode()
                ctype = "application/json"
            elif decisions is not None and route == "/debug/decisions":
                payload = export_decisions(decisions, self.path).encode()
                ctype = (
                    "application/x-ndjson"
                    if "format=ndjson" in self.path
                    else "application/json"
                )
            elif slo is not None and route == "/debug/slo":
                from ..obs.slo import export_slo

                payload = export_slo(slo, self.path).encode()
                ctype = "application/json"
            elif sched is not None and route == "/debug/sched":
                from ..sched import export_sched

                payload = export_sched(
                    sched() if callable(sched) else sched, self.path
                ).encode()
                ctype = "application/json"
            elif partitions is not None and route == "/debug/partitions":
                payload = json.dumps(partitions.plan_table()).encode()
                ctype = "application/json"
            elif partitions is not None and route == "/debug/programs":
                payload = json.dumps(
                    partitions.programs_table()
                ).encode()
                ctype = "application/json"
            else:
                payload = b'{"error": "not found"}'
                self.send_response(404)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def log_message(self, *args):
            pass

    httpd = ThreadingHTTPServer((bind_addr, port), _Handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd


def _traces_n(path: str) -> int:
    """?n=/?limit= from a /debug/traces request path (default 50,
    clamped). `limit` is the documented name; `n` stays accepted."""
    from urllib.parse import parse_qs, urlparse

    q = parse_qs(urlparse(path).query)
    raw = (q.get("limit") or q.get("n") or ["50"])[0]
    try:
        n = int(raw)
    except (ValueError, TypeError):
        n = 50
    return max(1, min(n, 1000))


def _debug_costs_k(path: str) -> Optional[int]:
    """?k= for /debug/costs (default 10; k=0 returns every row)."""
    from urllib.parse import parse_qs, urlparse

    try:
        k = int(parse_qs(urlparse(path).query).get("k", ["10"])[0])
    except (ValueError, TypeError):
        k = 10
    return None if k <= 0 else min(k, 10_000)


def export_decisions(decisions, path: str) -> str:
    """The one /debug/decisions renderer both HTTP planes (health +
    metrics) share: ?trace_id= / ?verdict= / ?plane= filter,
    ?limit=/?n= bounds the count, ?format=ndjson switches to
    one-record-per-line export (docs/observability.md §Decision log)."""
    from urllib.parse import parse_qs, urlparse

    q = parse_qs(urlparse(path).query)

    def _one(name):
        return (q.get(name) or [None])[0] or None

    query = {
        "trace_id": _one("trace_id"),
        "verdict": _one("verdict"),
        "plane": _one("plane"),
        "limit": _traces_n(path),
    }
    if (_one("format") or "").lower() == "ndjson":
        return decisions.export_ndjson(**query)
    return decisions.export_json(**query)


def export_traces(tracer, path: str) -> str:
    """The one /debug/traces renderer both HTTP planes (health +
    metrics) share: ?trace_id= narrows to one trace, ?limit=/?n=
    bounds the count, ?format=otlp switches to OTLP-JSON span export."""
    from urllib.parse import parse_qs, urlparse

    q = parse_qs(urlparse(path).query)
    trace_id = (q.get("trace_id") or [None])[0] or None
    n = _traces_n(path)
    fmt = (q.get("format") or [""])[0].lower()
    if fmt == "otlp":
        return tracer.export_otlp(n=n, trace_id=trace_id)
    return tracer.export_json(n=n, trace_id=trace_id)
