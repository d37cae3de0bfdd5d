"""What freezing the heap after every audit sweep keeps for good, on the
CPU: the smoke's `runner` phase at a small size (a Runner on TorchDriver
"cpu" against the apiserver stand-in), then SWEEPS sweeps, each after
N_CHURN pods out and N_CHURN in through the stand-in. Prints, per sweep,
its seconds, the process's RSS and gc.get_freeze_count(); at the end, the
objects one full collection finds once the heap is unfrozen: the cyclic
garbage that the freezes kept.

    python3 tools/freeze_leak.py each   # AuditManager.freeze_after_sweep
    python3 tools/freeze_leak.py once   # frozen after ingestion only
"""

import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as c  # noqa: E402

N_PODS, N_CHURN, SWEEPS = 2000, 100, 20


def rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1024
    return 0.0


def main(mode: str) -> None:
    from gatekeeper_tpu_torch.kernels import ops

    _, state = c.phase_runner(
        c.Recorder(ops), None, n_pods=N_PODS, n_constraints=40,
        n_requests=64, callers=16, n_sample=4, n_status=5, n_churn=50,
        device="cpu")
    runner, api = state["runner"], state["api"]
    drv = runner.client._driver
    runner.audit.freeze_after_sweep = mode == "each"
    prev = [c.churn_pod(i) for i in range(50)]  # the phase's own churn
    rows = []
    try:
        for r in range(SWEEPS):
            g0 = drv._data_gen
            new = [c.churn_pod(10_000 + r * N_CHURN + i)
                   for i in range(N_CHURN)]
            for p in prev:
                api.remove(p)
            for p in new:
                api.put(p)
            want = g0 + len(prev) + len(new)
            c._wait_for(lambda: drv._data_gen >= want, 120, "the churn")
            prev = new
            t = time.perf_counter()
            runner.audit.audit()
            rows.append({"sweep": r, "s": time.perf_counter() - t,
                         "rss_mb": rss_mb(),
                         "frozen": gc.get_freeze_count()})
            print(json.dumps(rows[-1]), flush=True)
        gc.unfreeze()
        print(json.dumps({
            "mode": mode, "pods": N_PODS, "churn": N_CHURN, "sweeps": SWEEPS,
            "unfrozen_collect_found": gc.collect(),
            "rss_mb_first": rows[0]["rss_mb"], "rss_mb_last": rows[-1]["rss_mb"],
            "frozen_first": rows[0]["frozen"], "frozen_last": rows[-1]["frozen"],
        }), flush=True)
    finally:
        c._stop_runner(state)


if __name__ == "__main__":
    if len(sys.argv) != 2 or sys.argv[1] not in ("each", "once"):
        sys.exit(__doc__)
    main(sys.argv[1])
