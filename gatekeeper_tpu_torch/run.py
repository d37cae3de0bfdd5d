# Copied from gatekeeper_tpu/run.py; only these edits differ.
# Edit: the client's driver is TorchDriver; build_runner takes `device`
# (None = "cuda", which raises without a card; tests pass "cpu"), and no
# flag sets it. main's start-up log names the device.
"""Process entry point: `python -m gatekeeper_tpu_torch.run` — the main.go
analog (reference main.go:80-308).

Builds the in-cluster KubeCluster EventSource (service-account config),
the CUDA driver (TorchDriver) behind the constraint-framework Client, and
the Runner
with the selected operations; flags mirror the reference's surface:

  --operation            webhook|audit|status (repeatable; default all)
  --port                 webhook HTTPS port (policy.go:73)
  --health-addr-port     readyz/healthz port (main.go:87)
  --prometheus-port      /metrics exposition port (exporter.go:26)
  --audit-interval       seconds between sweeps (audit/manager.go:48)
  --audit-from-cache     sweep the synced cache instead of listing
  --audit-chunk-size     discovery-sweep review batch size (manager.go:50)
  --constraint-violations-limit  per-constraint cap (manager.go:49)
  --log-denies           structured deny logs (policy.go:73)
  --emit-admission-events / --emit-audit-events
  --exempt-namespace     ns-label webhook exemption (repeatable)
  --cert-dir             local TLS artifact cache dir ("" = private
                         temp dir; with --cert-secret this is ONLY a
                         cache — the Secret is the store)
  --cert-secret          name of the Secret backing the SHARED fleet
                         cert store (docs/fleet.md; "" = pod-local
                         certs, single-replica only)
  --fleet-namespace      namespace holding the cert Secret + FleetState
                         CRs (the gossip plane for cache/breaker state)
  --vwh-name             ValidatingWebhookConfiguration to keep
                         injected with the rotating CA bundle
  --enable-pprof         torch.profiler endpoint on the health server
  --fail-policy          open|closed — what a shed/expired/unevaluable
                         request gets (docs/robustness.md)
  --max-queue            admission queue bound (0 = unbounded)
  --sched-policy         fifo|deadline — admission scheduling policy
                         (docs/operations.md §Admission scheduling);
                         "deadline" enables EDF batch formation,
                         per-tenant fair-share quotas, and predictive
                         shedding; "fifo" is the bit-compatible legacy
                         queue and the rollback path
  --drain-grace          seconds /readyz reports not-ready before the
                         webhook listener closes on SIGTERM (graceful
                         drain, docs/robustness.md)
  --no-integrity         disable the verdict-integrity plane (canary
                         rows, sampled shadow oracle, SDC quarantine —
                         docs/robustness.md §Verdict integrity); on by
                         default, this is the rollback path
  --kube-url/--kube-token/--kube-ca  out-of-cluster apiserver access
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="gatekeeper-tpu")
    p.add_argument("--operation", action="append", default=None,
                   choices=["webhook", "audit", "status"])
    p.add_argument("--port", type=int, default=8443)
    p.add_argument("--health-addr-port", type=int, default=9090)
    # Prometheus exposition (exporter.go:26 / --prometheus-port 8888 in
    # the reference); 0 disables
    p.add_argument("--prometheus-port", type=int, default=8888)
    p.add_argument("--audit-interval", type=float, default=60.0)
    p.add_argument("--audit-from-cache", action="store_true")
    p.add_argument("--audit-chunk-size", type=int, default=512)
    # --log-level (main.go:81-83; this logger's levels)
    p.add_argument(
        "--log-level", default="info",
        choices=["debug", "info", "error"],
    )
    p.add_argument("--constraint-violations-limit", type=int, default=20)
    p.add_argument("--log-denies", action="store_true")
    p.add_argument("--emit-admission-events", action="store_true")
    p.add_argument("--emit-audit-events", action="store_true")
    p.add_argument("--exempt-namespace", action="append", default=[])
    p.add_argument("--cert-dir", default="")
    # the fleet plane (docs/fleet.md): Secret-backed shared certs ON by
    # default — HA replicas must serve one CA; opt out with ""
    p.add_argument(
        "--cert-secret", default="gatekeeper-webhook-server-cert"
    )
    p.add_argument("--fleet-namespace", default="gatekeeper-system")
    p.add_argument("--vwh-name", default="")
    p.add_argument("--enable-pprof", action="store_true")
    # overload/degradation envelope (docs/robustness.md): the response
    # a shed/expired/unevaluable request gets, and the admission queue
    # bound (0 = unbounded). Chaos faults arm via GATEKEEPER_TPU_FAULTS.
    p.add_argument("--fail-policy", default="open",
                   choices=["open", "closed"])
    p.add_argument("--max-queue", type=int, default=2048)
    # SLO-aware admission scheduling (docs/operations.md §Admission
    # scheduling): deadline = EDF batch formation + fair-share quotas
    # + predictive shedding; fifo = legacy queue (rollback path)
    p.add_argument("--sched-policy", default="fifo",
                   choices=["fifo", "deadline"])
    p.add_argument(
        "--partitions", type=int, default=0,
        help="split the constraint corpus into N device fault domains "
        "(per-device breakers + quarantine; 0 = monolithic dispatch)",
    )
    # wire-speed ingest plane (docs/ingest.md): framed streaming
    # listener next to the legacy HTTP port. "off" is the rollback
    # path — the HTTP front door is identical either way.
    p.add_argument("--ingest", default="off",
                   choices=["off", "on", "json"],
                   help="framed-stream listener: on = zero-copy "
                   "decode, json = framed transport with plain "
                   "json.loads decode, off = legacy HTTP only")
    p.add_argument("--ingest-port", type=int, default=0,
                   help="stream listener port (0 = ephemeral)")
    # graceful drain: seconds /readyz reports not-ready while the
    # webhook listener still accepts (SIGTERM flips readiness first,
    # the LB routes away, THEN the listener closes and in-flight
    # requests complete — docs/robustness.md)
    p.add_argument("--drain-grace", type=float, default=1.0)
    # verdict-integrity plane (docs/robustness.md §Verdict integrity):
    # on by default; the flag exists so an operator can bisect a
    # regression back to the plane without a rebuild
    p.add_argument("--no-integrity", dest="integrity",
                   action="store_false", default=True)
    # agent-action admission (docs/targets.md): registers the
    # AgentActionTarget so agent templates ingest and the webhook
    # serves POST /v1/agent/review
    p.add_argument("--agent-review", action="store_true")
    p.add_argument("--kube-url", default=None)
    p.add_argument("--kube-token", default=None)
    p.add_argument("--kube-ca", default=None)
    p.add_argument("--kube-insecure", action="store_true")
    p.add_argument("--pod-name", default=None)
    return p


def build_runner(args, log=None, webhook_tls: bool = True, device=None):
    """(cluster, runner) from parsed flags — factored out of main so
    tests can drive the REAL entry wiring against a mock apiserver.
    `device` is TorchDriver's: None means "cuda" (raises without a
    card); tests pass "cpu"."""
    import os

    from .constraint import Backend, K8sValidationTarget
    from .constraint.torchdriver import TorchDriver
    from .control import KubeCluster, Runner
    from .logs import StructuredLogger

    if log is None:
        log = StructuredLogger(level=getattr(args, "log_level", "info"))
    cluster = KubeCluster(
        base_url=args.kube_url,
        token=args.kube_token,
        ca_file=args.kube_ca,
        verify=not args.kube_insecure,
        logger=log,
    )
    targets = [K8sValidationTarget()]
    if getattr(args, "agent_review", False):
        from .agentaction import AgentActionTarget

        targets.append(AgentActionTarget())
    client = Backend(TorchDriver(device=device)).new_client(*targets)
    operations = tuple(args.operation) if args.operation else (
        "webhook", "audit", "status"
    )
    runner = Runner(
        cluster,
        client,
        "admission.k8s.gatekeeper.sh",
        operations=operations,
        pod_name=args.pod_name
        or os.environ.get("POD_NAME", "gatekeeper-tpu"),
        audit_interval=args.audit_interval,
        webhook_port=args.port,
        readyz_port=args.health_addr_port,
        exempt_namespaces=args.exempt_namespace,
        webhook_tls=webhook_tls,
        emit_admission_events=args.emit_admission_events,
        emit_audit_events=args.emit_audit_events,
        audit_from_cache=args.audit_from_cache,
        audit_chunk_size=args.audit_chunk_size,
        enable_profiler=args.enable_pprof,
        log_denies=args.log_denies,
        logger=log,
        vwh_name=args.vwh_name or None,
        cert_dir=args.cert_dir or None,  # "" = process-private temp dir
        cert_secret=getattr(args, "cert_secret", "") or None,
        fleet_namespace=getattr(
            args, "fleet_namespace", "gatekeeper-system"
        ),
        fail_policy=getattr(args, "fail_policy", "open"),
        max_queue=(
            getattr(args, "max_queue", 2048) or None
        ),  # 0 -> unbounded
        partitions=getattr(args, "partitions", 0),
        sched_policy=getattr(args, "sched_policy", "fifo"),
        ingest=getattr(args, "ingest", "off"),
        ingest_port=getattr(args, "ingest_port", 0),
        integrity=getattr(args, "integrity", True),
        drain_grace_s=getattr(args, "drain_grace", 0.0),
        bind_addr="0.0.0.0",  # kubelet probes and the apiserver dial
        # the pod IP, not loopback
    )
    return cluster, runner


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from .logs import StructuredLogger

    log = StructuredLogger(level=args.log_level)
    cluster, runner = build_runner(args, log=log)
    log.info(
        "starting gatekeeper-tpu",
        operations=sorted(runner.operations),
        device=str(runner.client._driver.device),
        webhook_port=args.port,
        health_port=args.health_addr_port,
    )
    runner.start()

    # try/finally from here: the runner owns NON-daemon threads (the
    # warm compiler), so an exception that skips runner.stop() would
    # leave the process hanging instead of crashing-and-restarting
    metrics_httpd = None
    try:
        if args.prometheus_port:
            from .metrics import serve_metrics

            metrics_httpd = serve_metrics(
                runner.metrics,
                port=args.prometheus_port,
                bind_addr="0.0.0.0",
                # the debug surface rides the metrics plane too (the
                # health server serves the same routes; either port
                # works for an operator with port-forward access)
                tracer=runner.tracer,
                attributor=runner.attributor,
                recorder=runner.recorder,
                decisions=runner.decisions,
                partitions=getattr(
                    runner.webhook, "partitioner", None
                ),
                slo=runner.slo,
                sched=getattr(
                    runner.webhook, "sched_snapshot", None
                ),
            )
            log.info(
                "metrics serving", prometheus_port=args.prometheus_port
            )

        stop = threading.Event()

        def _sig(signum, frame):
            log.info("signal received, draining", signum=signum)
            stop.set()

        signal.signal(signal.SIGTERM, _sig)
        signal.signal(signal.SIGINT, _sig)
        stop.wait()
    finally:
        if metrics_httpd is not None:
            metrics_httpd.shutdown()
        runner.stop()
        cluster.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
