"""One-device fused dispatch of the violation path (port of
gatekeeper_tpu/parallel)."""
