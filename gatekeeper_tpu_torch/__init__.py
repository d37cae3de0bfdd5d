"""gatekeeper_tpu_torch — the PyTorch/CUDA port of gatekeeper_tpu.

The fused violation path (audit sweep and admission micro-batch) runs on
one NVIDIA GPU: the match matrix, the slab gathers, EGroup and the need
tail are hand-written CUDA kernels (kernels/), the compiled template
programs are eager torch ops, and the host modules (Rego interpreter,
encoder, constraint client) are copies of the JAX package's. Entry point:
`constraint.Client` over `constraint.TorchDriver`, which runs on the card
unless the caller passes device="cpu". Nothing here imports JAX or
gatekeeper_tpu.
"""

__version__ = "0.1.0"
