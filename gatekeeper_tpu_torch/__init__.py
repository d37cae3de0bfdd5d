"""gatekeeper_tpu_torch — the PyTorch/CUDA port of gatekeeper_tpu.

The fused violation path (audit sweep and admission micro-batch) and the
audit controller over it run on one NVIDIA GPU: the match matrix, the slab
gathers, EGroup, the need tail, the vocab-delta upload into the resident
tables and the element gather of two-array joins are hand-written CUDA
kernels (kernels/), the compiled template programs are eager torch ops,
and the host modules (Rego interpreter, encoder, constraint client, the
audit manager and the logging, tracing, fault-point and event-fabric
pieces it reads) are copies of the JAX package's. Entry points:
`constraint.Client` over `constraint.TorchDriver`, which runs on the card
unless the caller passes device="cpu", and `audit.AuditManager` over such
a client. Nothing here imports JAX or gatekeeper_tpu.
"""

__version__ = "0.1.0"
