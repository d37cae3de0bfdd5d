"""One-device fused dispatch of the violation path and the fault-domain
partition plane over it (port of gatekeeper_tpu/parallel)."""
