"""gatekeeper_tpu_torch — the PyTorch/CUDA port of gatekeeper_tpu.

The fused violation path (audit sweep and admission micro-batch), the
audit controller and the validating admission webhook over it run on one
NVIDIA GPU: the match matrix, the slab gathers, EGroup, the need tail, the
vocab-delta upload into the resident tables and the element gather of
two-array joins are hand-written CUDA kernels (kernels/), the compiled
template programs are eager torch ops, reviews are encoded by a C token
flattener built with gcc (native/), and the host modules (Rego
interpreter, encoder, constraint client, the audit manager, the webhook
server and micro-batcher, and the logging, tracing, metrics, fault-point,
circuit-breaker and event-fabric pieces they read) are copies of the JAX
package's. Entry points: `constraint.Client` over `constraint.TorchDriver`,
which runs on the card unless the caller passes device="cpu";
`audit.AuditManager` over such a client; `webhook.WebhookServer`,
which serves AdmissionReviews over HTTP(S) through `webhook.MicroBatcher`
into one `Client.review_many` per micro-batch; and the process itself,
`python -m gatekeeper_tpu_torch.run` (`control.Runner` over a
`control.KubeCluster`: watches, controllers, readiness, status, audit,
webhook, external-data providers). Nothing here imports JAX or
gatekeeper_tpu.
"""

__version__ = "0.1.0"
