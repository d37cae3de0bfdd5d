# Copied from gatekeeper_tpu/obs/attribution.py; only these edits differ.
# Edit: the docstring names the partition boundary, not the change that
# added it. TorchDriver feeds note_dispatch its measured
# phase_seconds["dispatch"], the reference's device-execute window.
"""Per-constraint device-time cost attribution.

ROADMAP item 1 says the fused path collapses as constraints grow, but
until now nothing in the system could say WHICH constraints cost what —
`driver_phase_seconds` stops at whole-batch granularity. This module is
the instrument the pruning/partitioning work aims with:

  * the driver measures per-dispatch device-execute time at the
    `query_many_subset` / `_eval_reviews_split` seam (the partition
    boundary makes per-subset timing exact, not guessed);
  * a static cost model apportions that measured time across the
    constraints the dispatch evaluated: each constraint's weight is
    analyzer/compiler-derived — program expression rows × row-feature
    width (`TpuDriver._static_cost`), so a heavyweight inventory-join
    template is charged more of the window than a one-clause label
    check sharing its partition;
  * the attributor accumulates `{(kind, name, partition) -> seconds}`
    and emits `constraint_device_seconds_total{kind,name,partition}`
    (the metrics-registry cardinality guard bounds pathological
    constraint churn), plus the sorted top-K table `/debug/costs`
    serves with share-of-plane fractions.

The invariant the bench pins (`bench_webhook.py --attribution`):
attributed seconds sum to the measured device-execute total — the
model changes WHO is charged, never HOW MUCH.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["CostAttributor"]

# the monolithic (non-partitioned) dispatch's partition label
MONO_PARTITION = "mono"


class CostAttributor:
    """Accumulates apportioned device-execute seconds per constraint.

    Thread-safe; `note_dispatch` is called on the driver's dispatch
    path under its serving mutex, so the work here is one weighted
    split plus dict adds — no I/O, no metric emission beyond the
    registry's own lock."""

    def __init__(self, metrics=None, replica: Optional[str] = None):
        self.metrics = metrics
        self.replica = replica
        self._lock = threading.Lock()
        # (kind, name, partition) -> attributed seconds
        self._costs: Dict[Tuple[str, str, str], float] = {}
        self.total_seconds = 0.0
        self.dispatches = 0

    def reset(self) -> None:
        """Zero the accumulation (bench rungs measure deltas; the
        Prometheus counters stay monotonic — only the table resets)."""
        with self._lock:
            self._costs = {}
            self.total_seconds = 0.0
            self.dispatches = 0

    def note_dispatch(
        self,
        entries: Sequence[Tuple[str, str, float]],
        device_seconds: float,
        partition: Optional[Any] = None,
    ) -> None:
        """Apportion one dispatch's measured device-execute window over
        `entries` = [(kind, name, static_weight)]. Zero-weight sets
        split evenly — a window someone paid must be charged to
        someone, or the sums check drifts."""
        if not entries or device_seconds <= 0.0:
            return
        part = MONO_PARTITION if partition is None else str(partition)
        total_w = sum(max(0.0, w) for _, _, w in entries)
        n = len(entries)
        with self._lock:
            self.dispatches += 1
            self.total_seconds += device_seconds
            for kind, name, w in entries:
                share = (
                    (max(0.0, w) / total_w)
                    if total_w > 0
                    else (1.0 / n)
                )
                dt = device_seconds * share
                key = (kind, name, part)
                self._costs[key] = self._costs.get(key, 0.0) + dt
        if self.metrics is not None:
            # replica identity rides the series when set (constant per
            # registry — fleet replicas own one registry each, so this
            # adds identification, not cardinality)
            extra = (
                {"replica": self.replica}
                if self.replica is not None
                else {}
            )
            for kind, name, w in entries:
                share = (
                    (max(0.0, w) / total_w) if total_w > 0 else (1.0 / n)
                )
                self.metrics.record(
                    "constraint_device_seconds_total",
                    device_seconds * share,
                    kind=kind, name=name, partition=part, **extra,
                )

    # -- read ----------------------------------------------------------------

    def table(self, k: Optional[int] = 10) -> Dict[str, Any]:
        """The `/debug/costs` document: constraints aggregated across
        partitions, sorted costliest-first, with share-of-plane
        fractions; `k=None` returns every row."""
        with self._lock:
            total = self.total_seconds
            by_constraint: Dict[Tuple[str, str], Dict[str, Any]] = {}
            for (kind, name, part), secs in self._costs.items():
                row = by_constraint.setdefault(
                    (kind, name),
                    {"kind": kind, "name": name, "seconds": 0.0,
                     "partitions": {}},
                )
                row["seconds"] += secs
                row["partitions"][part] = (
                    row["partitions"].get(part, 0.0) + secs
                )
            dispatches = self.dispatches
        rows = sorted(
            by_constraint.values(),
            key=lambda r: (-r["seconds"], r["kind"], r["name"]),
        )
        if k is not None:
            dropped = max(0, len(rows) - k)
            rows = rows[:k]
        else:
            dropped = 0
        out_rows: List[Dict[str, Any]] = []
        for r in rows:
            out_rows.append({
                "kind": r["kind"],
                "name": r["name"],
                "seconds": round(r["seconds"], 6),
                "share": round(r["seconds"] / total, 4) if total else 0.0,
                "partitions": {
                    p: round(s, 6)
                    for p, s in sorted(r["partitions"].items())
                },
            })
        doc: Dict[str, Any] = {
            "total_device_seconds": round(total, 6),
            "dispatches": dispatches,
            "constraints": len(by_constraint),
            "rows_omitted": dropped,
            "rows": out_rows,
        }
        if self.replica is not None:
            doc["replica"] = self.replica
        return doc

    def top(self, k: int = 10) -> List[Dict[str, Any]]:
        """Top-K costliest constraints (the bench SUMMARY's target
        list for ROADMAP item 1's pruning work)."""
        return self.table(k)["rows"]

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "total_device_seconds": round(self.total_seconds, 6),
                "dispatches": self.dispatches,
                "series": len(self._costs),
            }
