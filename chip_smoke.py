#!/usr/bin/env python3
"""Smoke run of gatekeeper_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py

Phases, one line each on stdout, in this order:

  card     the card's name and power limit (nvidia-smi);
  build    nvcc builds every kernel of the path from csrc/ into
           build/gatekeeper_tpu_torch/ (one nvcc per source, in parallel),
           then gcc builds the C token flattener (native/flatten.c) and g++
           the webhook's native HTTP front (native/bridge_frontend.cpp),
           all into the compile-artifact store's lib dir
           (build/gatekeeper_tpu_torch/store/), which attests them;
  store    the libraries build made, attested into a fresh store root
           under build/ beside four forged artifacts (another machine's
           fingerprint, a payload whose sha256 differs from its
           attestation, a schema-0 attestation, a bare file at the root)
           under real libraries' names; a child process with that root,
           an empty load directory and no nvcc on its PATH adopts and
           launches K1-K7 once each from the adopted files against their
           plain versions, bit for bit, starts no nvcc, maps every
           libgk_ library from the store's lib dir with the attested
           content, and counts each forgery under its reason (the cold
           build_all seconds beside the adopt seconds);
  native   the C token flattener against the Python encoder: equal token
           tables and vocab contents and order on 1,000 pods, 1,000
           make_mixed objects and one review batch of 256 against an
           OverlayVocab over a 25,000-pod corpus's vocab (the function's
           defaults 2,000 and 100,000; cut for time); the encode seconds
           of both on that corpus;
  parity   250 pods x 50 constraints on TorchDriver("cuda") (the
           function's default 1,000; cut for time): 2 review batches of 64
           (the default 4; cut for time) identical to the port's own interpreter driver (RegoDriver);
  subset   partition-scoped review over the same clients
           (Client.review_many_subset, the constraints split into 3
           subsets): 2 batches of 64 (the default 4; cut for time), each
           subset's results equal to the
           interpreter driver's, merged in constraint order equal to the
           whole review_many; K1-K4 must launch;
  audit_parity  the audit controller on the same clients, one
           host-filesystem join constraint added (the function's default
           adds 4; cut for time, as in audit_churn, inventory_parity and
           inventory): AuditManager sweeps from the cache before and after
           a 2% churn (whole result lists and reports equal to an
           AuditManager's over the interpreter driver; sweep 2 must take
           the vocab-delta upload), and one direct-list sweep over a
           FakeCluster holding the churned state, reports equal;
  webhook_parity  two WebhookServers on 127.0.0.1 over the parity clients
           (a dryrun and a warn constraint added), one over TorchDriver, one
           over the interpreter driver: 128 AdmissionReviews (the
           function's default 512; cut for time; violating and
           compliant pods, an excluded namespace, DELETEs with an oldObject,
           Gatekeeper's service account, /v1/admitlabel requests) from 64
           threads over HTTP get equal response bodies by uid; every batch
           takes the fused route and K1-K4 launch;
  ingest_parity  the same two clients behind WebhookServer(ingest=True,
           sched_policy="deadline") with a DecisionLog and an SloEngine:
           the 128 AdmissionReviews as framed requests with FLAG_DEADLINE
           budgets over 8 StreamClient connections from 64 threads, plus 16
           bodies with duplicate keys (the decode fallback). Bodies equal
           by uid across the two drivers and, on TorchDriver, to the same
           requests over HTTP and to webhook_parity's fifo verdicts; the
           zerocopy/fallback/legacy decode counts exact; every batch fused
           and K1-K4 launch;
  bridge_parity  a BridgeStack (the C++ front, deadline_ms 10,000) over the
           TorchDriver parity client takes the 128 requests over HTTP from
           64 threads: bodies equal to the interpreter's by uid, no
           fail-open answer, every batch fused, K1-K4 launch;
  full     the north-star deployment (100,000 pods x 500 constraints): one
           audit sweep (4 chunks of 32,768 rows) and 2 admission
           micro-batches of 256 reviews (the function's default 8; cut
           for time) through Client.review_many, with
           the time of each phase (encode, stage, dispatch, decode,
           render); the launch counter of every kernel of that path (K1-K4)
           must be > 0 over that run, and a sample of its reviews must
           match the interpreter;
  analysis the static analyzer over the full client's templates (and,
           after inventory, the mixed client's): verdict counts, fallback
           codes, analyzer_mismatches == 0, and any template whose route
           differs from the one the compiler alone gives it;
  liveness 2 of the full phase's review batches of 256 with the IR
           liveness mask on and off: equal results; the token slots dropped, K2's
           [N, L, T] and the encode and dispatch seconds of both;
  profile  device-busy against wall seconds (torch.profiler, CUDA
           activity) for a second, warm-corpus audit sweep and one more
           review batch, after the counted run;
  webhook  the full phase's client behind WebhookServer(window_ms=2.0):
           512 AdmissionReviews of new pods from 256 threads over HTTP
           keep-alive (the function's default adds 1,024 from 16 threads
           and 4,096 requests; cut for time, as in ingest and
           partitions); per load the request
           latency p50/p99/max, requests per second, batches and their mean
           occupancy, and the driver's phase seconds summed over the
           batches. No batch may fail or leave the fused route, the breaker
           stays closed, K1-K4 launch, and 32 sampled responses equal the
           interpreter's answer (the function's default 64; _oracle: a
           RegoDriver client with the
           same policy and no synced objects);
  ingest   the same client under sched_policy="deadline" with a
           DecisionLog, an SloEngine and a Tracer: 512 framed requests
           of new pods from 256 callers over 16 connections
           (WebhookServer(ingest=True), 10,000 ms budgets), then 512
           over HTTP from 256 clients through the C++ front at
           deadline_ms 10,000 (the function's defaults add 1,024 framed
           from 16 callers and 1,024 through the front at its 2,000 ms
           default, counting their fail-open answers). Per load the webhook
           phase's figures plus encode split by encoder, sheds by reason,
           the scheduler's predicted against measured batch seconds and the
           SloEngine's autoscaler(). No batch may fail or leave the fused
           route, no answer at 10,000 ms may fail open, no framed body may
           take the decode fallback, the breaker stays closed, K1-K4
           launch, and 32 sampled responses equal the interpreter's;
  partitions  the same client behind WebhookServer(partitions=4,
           integrity=IntegrityPlane(), attributor=CostAttributor()):
           256 requests from 256 callers, every answer equal to the
           monolithic dispatch's and 64 to the interpreter's, no canary
           mismatch, K1-K4 launched by every partition; per partition the
           launches and the attributed against the measured dispatch
           seconds; what canaries add to a dispatch; then a one-constraint
           churn (exactly one program compiles) and the fault point
           driver.device_dispatch[device=1] (three failed dispatches, the
           breaker opens, partition 1 re-homes, later answers fused);
  audit_churn  the audit controller at full width across cluster churn:
           the full phase's client, its last constraint swapped for a join
           constraint (the function's default swaps 20; cut for time);
           sweep 1 takes a full table upload, then 1,000 pods
           go and 1,000 new ones come with strings never interned, and
           sweep 2 must take the vocab-delta upload. Every kernel (K1-K6)
           must launch over the two sweeps, K5 in sweep 2; a sample of rows
           is held against the interpreter;
  inventory_parity  250 mixed-GVK rows (make_mixed: pods, Services,
           Ingresses, Namespaces) x 50 constraints plus the two uniqueness
           joins (UNIQUE_INGRESS_HOST_REGO, UNIQUE_SERVICE_SELECTOR_REGO):
           whole audit() and review_many() result lists (1 review batch
           of 64; cut for time from the default 4) equal to the
           interpreter driver's;
  inventory  BASELINE config #5 at full width (100,000 mixed-GVK rows x
           500 constraints, the two joins among them): one cold audit sweep
           and 4 review batches of 256 (the function's default 8; cut for
           time), some reusing a host or selector the
           inventory holds. The uniqueness violations must equal a plain
           grouping of the corpus, every uniqueness render must go through
           the prune index, and K1-K4 must launch;
  full_output  the full-output audit step (FusedKernel.run: match, counts,
           totals; unchunked) over the inventory client: K7 equal to its
           plain version, counts to the per-program evaluator, match to K1's
           plain version, each compiled constraint without row features
           totalling its need pairs of the sweep (K4); entry()'s step once;
           the step's device time split into K1, K7 and program bodies;
  runner   the process wiring at full width (BASELINE config #5):
           build_runner(build_parser().parse_args(...)) against ApiServer,
           an apiserver stand-in in its own process (paged lists, watch
           streams, status writes) holding the 500 constraints, a Config
           syncing Pods and the 100,000 pods of make_pod with images drawn
           from a 5,000-image catalogue; --audit-from-cache, TLS,
           webhook, audit, status, --agent-review (the agent target
           registered, /v1/agent/review mounted) and --ingest on (the
           framed listener), and the process defaults otherwise
           (the integrity plane on, its shadow oracle in a process of its
           own sampling 1 in 8 admissions; the Secret-backed cert store,
           whose CA every HTTPS client here trusts, and the fleet plane
           over the stand-in's Secret and FleetState kinds). Boot to
           Ready and to the first sweep, whose violations equal the full
           phase's; 20
           ConstraintPodStatus CRs and audit statuses against the full
           phase's Client.audit; 1,000 pods out and 1,000 in through the
           stand-in and a sweep on the vocab-delta upload (K5), its host
           time sampled by function; 1,024 AdmissionReviews over HTTPS
           (the function's default 4,096; cut for time)
           from 256 callers (no failed, degraded or fail-policy answer,
           none past the 10 s request timeout, no shadow divergence, 64
           against the interpreter), with the oracle's sampled, evaluated,
           dropped and stale counts, its evaluation seconds, the batches'
           dispatch seconds with and without an evaluation beside them
           and the full collections during the load; the Runner's
           /debug/flightrecords holds no record after the load;
  mutation the same Runner serving /v1/mutate: 48 mutators
           (mutation_docs: 16 Assign, 16 AssignMetadata, 16 ModifySet,
           half with a labelSelector, a quarter with namespaces or
           excludedNamespaces) applied through the stand-in and ingested
           by the Runner's watches, one pair quarantined for a schema
           conflict; 2,048 Pod CREATEs over HTTPS from 256 callers, every
           patch equal to the port's host path (screen_host, apply,
           json_patch), the screen matrices of the first 4 batches equal
           screen_host row by row, no fail-open answer, one K1 launch per
           batch, K1 bit for bit against its plain version on the
           screen's inputs (live label and namespace selectors) with its
           device time and bound on that shape;
  extdata  the same Runner: a localhost provider flagging 1% of the
           catalogue, a Provider CR and an error-gated image-verification
           template and constraint through the stand-in, at the provider's
           default maxKeysPerRequest (512). One sweep fetches its keys in
           ceil(keys / 512) requests and its violations equal the pods
           with a flagged image; two HTTPS loads of 512 from 256 callers make
           at most one fetch per micro-batch, the second (cached keys)
           none; a cache-hit batch of 256 renders no pair of that kind on
           the interpreter; past the TTL that batch refetches (ceil(keys /
           512) requests) and the rows of images flagged meanwhile route back and violate;
  agent    the same Runner's agent-action plane: a skill-registry
           Provider on a localhost provider knowing 512 digests (1 in 16
           flagged), the three agent templates of tests/test_agentaction.py
           (shell allowlist, signed skills, verified skills through
           external data) and 30 constraints over tool globs *, ns.* and
           exact names, agents, excludedAgents, capability and skill
           selectors, created through the stand-in after Ready while 256
           AdmissionReviews over HTTPS from 64 callers run: the K8s set is
           neither rebuilt nor cooled and no admission fails or times out;
           then 2,048 HTTPS /v1/agent/review requests (the soak harness's
           record shape over 64 agents, 8 tool namespaces, 1 in 4 skills
           unsigned) and 512 framed 'A' frames over 16 connections, from
           256 callers each, one fused dispatch per agent batch; and 512
           requests from 256 callers through a WebhookServer over the same
           client with an agent MutationSystem holding the default-timeout
           Assign: every patch equal to the host path's, one K1 screen
           per mutation batch. 64 answers against the interpreter, no
           fail-open answer, none past the 10 s timeout, /readyz 200 at
           every poll of the phase (C6), K1-K4 launch, K1 bit for bit
           against its plain version on the agent batches' inputs with
           its device time and bound on that shape;
  fleet    two replicas on the card over one stand-in: A, the Runner of
           the three phases above, and B, python -m
           gatekeeper_tpu_torch.run as a child (its own CUDA context) at
           the same config, --operation webhook without the agent target
           (its trackers for the agent phase's constraint kinds report
           their expectations cancelled, C8), the process defaults
           otherwise, GATEKEEPER_TPU_FLIGHT_DIR and GATEKEEPER_TPU_FAULTS
           arming driver.device_dispatch=error past 120 dispatches for the
           breaker's threshold. B boots while A idles; one Secret and one
           CA verified on both, cert_generation equal; A rotates and B,
           the same process, presents the new certificate; 256 requests
           with images never fetched go through A, then through B with no
           provider request from B and A's answers; 1,024 over 512 new
           images from 256 callers split over both (the keys fetched
           fleet-wide over the distinct keys printed; 64 answers against
           the interpreter); B's armed fault trips its breaker, A's adopts
           it (HALF_OPEN), A's next batch is one probe that closes it, no
           answer from A fails or fails open; B's flight recorder keeps
           exactly one coalesced breaker_open record (trace tail, armed
           fault points, cost table) on /debug/flightrecords and on disk; each /readyz answers 200
           (A's after the extdata and agent kinds came after its Ready,
           C6) and lists the other as its peer with no publish failure;
           K1-K4 launch for A,
           B's log names the device, B exits 0 on SIGTERM. It prints the
           byte size of a FleetState publish at its 512-entry cap;
  process  python -m gatekeeper_tpu_torch.run as a child against a
           stand-in with 1,000 pods x 50 constraints, in the process
           defaults (discovery audit, --audit-chunk-size 512, the
           Secret-backed cert store, the fleet plane): /readyz 200,
           /metrics with the audit series, one HTTPS AdmissionReview
           verified by the Secret's CA and equal to the interpreter's,
           the device named in its log, exit 0 within the drain grace +
           30 s of SIGTERM. Its stand-in serves no FleetState kind: the
           fleet plane's publishes fail and are counted
           (fleet_state_publish_failures_total > 0), serving goes on;
  kernels  each kernel against its plain torch version on inputs the main
           paths gave it (exact equality: every output is
           bool or int, K5's buffers compared byte for byte), with the
           kernel's device time (torch.profiler), the wrapper's wall time
           per call, the plain version's and, where PyTorch's own calls
           compute the same function, theirs; and the least time the card
           needs for the bytes and operations this input needs;
  variants each kernel against its plain version on seeded random inputs
           that reach the code paths the in-repo policy does not (K1's
           namespace, scope and selector clauses over many spec rows,
           EGroup sum/max, int32/float32 values, g1/g01 axes, overlay
           slabs, a hot-row window smaller than the hot rows, K6 on g0 and
           with idx1 past g1, K5 at unaligned fills across segments, K7 at
           ragged widths with -1 rows and a short n_valid; K2 and K3 at the
           edge widths of their launch plans and on views that start off
           16-byte alignment; K4 at the N, n_valid, R and slice edges of
           its plan and bit layout; K1 at U = 1 and the largest U its plan
           takes, 4 and 16 label slots, dead and live selectors mixed; K5
           at fills of every residue modulo 16, a zero-row delta, one
           delta of many segments, an empty table list, consecutive
           flushes of growing size, two large flushes issued back to back
           with no synchronize between them, and a segment table it must
           refuse).

A timeline line gives the seconds at the end of each phase. The line
before the last is the kernel table as one JSON object; the last line is
{"ok": true, "device": {...}}. Any failing phase raises, and the
script exits nonzero without that line; so does a machine without CUDA.

    python3 chip_smoke.py --full [--tree DIR]

runs card, build and the full phase alone, from DIR's chip_smoke.py and
package (another checkout of this repo) if given. Parent against change in
one call, from the root of this checkout, with the parent unpacked into
build/parent (git archive):

    for t in build/parent . . build/parent; do
        python3 chip_smoke.py --full --tree $t; done

    python3 chip_smoke.py --runner

runs card, build and the runner phase alone on the process defaults
(its first sweep held against itself, no full phase);

    python3 chip_smoke.py --fleet

runs them, then the extdata, agent, fleet and process phases.

    python3 chip_smoke.py --probe [--tree DIR]

builds K1-K5 alone (from DIR, another checkout of this repo, if given),
prints their ptxas report and a SASS summary, and times them at the main
path's shapes on seeded inputs beside their plain versions and bounds,
per __global__ function, with an empty kernel's device time (the launch
floor) from the same profiler window; the SASS listing goes beside the
built kernels (build/gatekeeper_tpu_torch/probe_sass_*.txt). K5 is timed
on a flush in the recorded shape (DELTA_PROBE_TABLES) and on one 8 MiB
delta: the kernel's device time, the staging copy's, and the wrapper's
host ms per call, with the flushes issued back to back and again with a
synchronize before each (so each copy reads a staging the host has just
written, as a flush on the path does); then the copy of a staging-sized
pinned buffer as it lies and right after the host rewrote it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
TARGET = "admission.k8s.gatekeeper.sh"
POLICIES = os.path.join(ROOT, "deploy", "policies")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
# H100 SXM peak outside the tensor cores (67 TFLOP/s float32, NVIDIA data
# sheet); the integer and boolean work of these kernels runs on the same
# pipes, so no faster
SCALAR_OPS_PER_S = 67e12

# constraint parameters per in-repo template, cycled like bench.build_client
PARAMS = {
    "K8sRequiredLabels": [
        {"labels": [{"key": "app"}]},
        {"labels": [{"key": "app"}, {"key": "owner"}]},
    ],
    "K8sAllowedRepos": [
        {"repos": ["nginx", "gcr.io/prod"]},
        {"repos": ["nginx", "gcr.io/prod", "quay.io/infra"]},
    ],
    "K8sBlockNodePort": [None],
    "K8sPSPPrivileged": [None],
    "GTRequiredAnnotations": [
        {"annotations": ["seccomp.security.alpha.kubernetes.io/pod"]},
    ],
    "GTDeniedImageRegistries": [
        {"registries": ["docker.io/"]},
        {"registries": ["docker.io/", "index.docker.io/"]},
    ],
    "GTNoLatestTag": [None],
    "GTMemoryLimitCeiling": [{"maxMemory": "8Gi"}, {"maxMemory": "16Gi"}],
}

# (python module path, TPU kernel it replaces) per kernel wrapper
KERNELS = {
    "match_matrix": ("gatekeeper_tpu_torch/kernels/csrc/match.cu",
                     "gatekeeper_tpu/engine/matchkernel.py:106"),
    "slab_gather": ("gatekeeper_tpu_torch/kernels/csrc/slab.cu",
                    "gatekeeper_tpu/parallel/sharding.py:771"),
    "egroup": ("gatekeeper_tpu_torch/kernels/csrc/group.cu",
               "gatekeeper_tpu/engine/exprs.py:510"),
    "need_tail": ("gatekeeper_tpu_torch/kernels/csrc/need.cu",
                  "gatekeeper_tpu/parallel/sharding.py:852"),
    "flush_deltas": ("gatekeeper_tpu_torch/kernels/csrc/delta.cu",
                     "gatekeeper_tpu/parallel/sharding.py:389"),
    "gather_elem": ("gatekeeper_tpu_torch/kernels/csrc/gather.cu",
                    "gatekeeper_tpu/engine/exprs.py:564"),
    "full_totals": ("gatekeeper_tpu_torch/kernels/csrc/totals.cu",
                    "gatekeeper_tpu/parallel/sharding.py:1066"),
}


# the __global__ functions each wrapper launches
KERNEL_FUNCS = {
    "match_matrix": ("match_kernel",),
    "slab_gather": ("slab_kernel",),
    "egroup": ("egroup_kernel",),
    "need_tail": ("need_rows_kernel", "compact_kernel", "pack_kernel"),
    "flush_deltas": ("delta_kernel",),
    "gather_elem": ("gather_elem_kernel",),
    "full_totals": ("totals_kernel",),
}

# the kernels each counted path must launch
PATH_KERNELS = {
    "subset": ("match_matrix", "slab_gather", "egroup", "need_tail"),
    "full": ("match_matrix", "slab_gather", "egroup", "need_tail"),
    "audit_churn": ("match_matrix", "slab_gather", "egroup", "need_tail",
                    "flush_deltas", "gather_elem"),
    "inventory": ("match_matrix", "slab_gather", "egroup", "need_tail"),
    "full_output": ("match_matrix", "slab_gather", "egroup", "full_totals"),
    "webhook_parity": ("match_matrix", "slab_gather", "egroup", "need_tail"),
    "webhook": ("match_matrix", "slab_gather", "egroup", "need_tail"),
    "ingest_parity": ("match_matrix", "slab_gather", "egroup", "need_tail"),
    "bridge_parity": ("match_matrix", "slab_gather", "egroup", "need_tail"),
    "ingest": ("match_matrix", "slab_gather", "egroup", "need_tail"),
    "liveness": ("match_matrix", "slab_gather", "egroup", "need_tail"),
    "partitions": ("match_matrix", "slab_gather", "egroup", "need_tail"),
    "runner": ("match_matrix", "slab_gather", "egroup", "need_tail",
               "flush_deltas"),
    "extdata": ("match_matrix", "slab_gather", "egroup", "need_tail"),
    "mutation": ("match_matrix",),
    "fleet": ("match_matrix", "slab_gather", "egroup", "need_tail"),
    "agent": ("match_matrix", "slab_gather", "need_tail", "flush_deltas"),
}

# A two-array join in the shape of gatekeeper-library's
# pod-security-policy/host-filesystem: volumes x containers' volumeMounts
# x allowedHostPaths. The symbolic compiler projects the second array
# (SElemProj) and reads each mount's name and readOnly flag through
# EGatherElem on the g01 axis.
HOSTFS_REGO = """package k8spsphostfilesystem

violation[{"msg": msg, "details": {}}] {
    volume := input_hostpath_volumes[_]
    allowedPaths := get_allowed_paths(input)
    input_hostpath_violation(allowedPaths, volume)
    msg := sprintf("HostPath volume %v is not allowed, pod: %v. Allowed path: %v", [volume, input.review.object.metadata.name, allowedPaths])
}

input_hostpath_violation(allowedPaths, _) {
    allowedPaths == []
}
input_hostpath_violation(allowedPaths, volume) {
    not input_hostpath_allowed(allowedPaths, volume)
}

get_allowed_paths(arg) = out {
    not arg.parameters
    out = []
}
get_allowed_paths(arg) = out {
    not arg.parameters.allowedHostPaths
    out = []
}
get_allowed_paths(arg) = out {
    out = arg.parameters.allowedHostPaths
}

input_hostpath_allowed(allowedPaths, volume) {
    allowedHostPath := allowedPaths[_]
    path_matches(allowedHostPath.pathPrefix, volume.hostPath.path)
    not allowedHostPath.readOnly == true
}

input_hostpath_allowed(allowedPaths, volume) {
    allowedHostPath := allowedPaths[_]
    path_matches(allowedHostPath.pathPrefix, volume.hostPath.path)
    allowedHostPath.readOnly
    not writeable_input_volume_mounts(volume.name)
}

writeable_input_volume_mounts(volume_name) {
    container := input_containers[_]
    mount := container.volumeMounts[_]
    mount.name == volume_name
    not mount.readOnly
}

path_matches(prefix, path) {
    a := path_array(prefix)
    b := path_array(path)
    prefix_matches(a, b)
}

path_array(p) = out {
    p != "/"
    out := split(trim(p, "/"), "/")
}

path_array("/") = []

prefix_matches(a, b) {
    count(a) <= count(b)
    not any_not_equal_upto(a, b, count(a))
}

any_not_equal_upto(a, b, n) {
    a[i] != b[i]
    i < n
}

input_hostpath_volumes[v] {
    v := input.review.object.spec.volumes[_]
    has_field(v, "hostPath")
}

has_field(object, field) = true {
    object[field]
}

input_containers[c] {
    c := input.review.object.spec.containers[_]
}
input_containers[c] {
    c := input.review.object.spec.initContainers[_]
}
input_containers[c] {
    c := input.review.object.spec.ephemeralContainers[_]
}
"""

# allowedHostPaths per join constraint, cycled: every one admits the
# corpus's read-only /var/log/app mounts, so the join does its work on
# every hostPath pod and flags only the churned pods' paths
JOIN_PARAMS = [
    [{"pathPrefix": "/var/log", "readOnly": True}],
    [{"pathPrefix": "/var"}],
    [{"pathPrefix": "/var/log/app", "readOnly": True}, {"pathPrefix": "/tmp"}],
    [{"pathPrefix": "/srv", "readOnly": True},
     {"pathPrefix": "/var/log", "readOnly": True}],
    [{"pathPrefix": "/"}],
]


# Inventory joins in the shape of gatekeeper-library's public
# general/uniqueingresshost and general/uniqueserviceselector templates:
# an Ingress host, or a Service's flattened selector, shared with another
# synced object of the namespace inventory violates. The compiler screens
# both; uniqueingresshost gets an "invdup" row feature and a path-form
# prune plan (spec.rules[_].host), uniqueserviceselector a fn-form one
# (flatten_selector).
UNIQUE_INGRESS_HOST_REGO = """package k8suniqueingresshost

identical(obj, review) {
  obj.metadata.namespace == review.object.metadata.namespace
  obj.metadata.name == review.object.metadata.name
}

violation[{"msg": msg}] {
  input.review.kind.kind == "Ingress"
  re_match("^(extensions|networking.k8s.io)$", input.review.kind.group)
  host := input.review.object.spec.rules[_].host
  other := data.inventory.namespace[_][otherapiversion]["Ingress"][name]
  re_match("^(extensions|networking.k8s.io)/.+$", otherapiversion)
  other.spec.rules[_].host == host
  not identical(other, input.review)
  msg := sprintf("ingress host conflicts with an existing ingress <%v>", [host])
}
"""

UNIQUE_SERVICE_SELECTOR_REGO = """package k8suniqueserviceselector

make_apiversion(kind) = apiVersion {
  g := kind.group
  v := kind.version
  g != ""
  apiVersion = sprintf("%v/%v", [g, v])
}

make_apiversion(kind) = apiVersion {
  kind.group == ""
  apiVersion = kind.version
}

identical(obj, review) {
  obj.metadata.namespace == review.namespace
  obj.metadata.name == review.name
  obj.kind == review.kind.kind
  obj.apiVersion == make_apiversion(review.kind)
}

flatten_selector(obj) = flattened {
  selectors := [s | s = concat(":", [key, val]); val = obj.spec.selector[key]]
  flattened := concat(",", sort(selectors))
}

violation[{"msg": msg}] {
  input.review.kind.kind == "Service"
  input.review.kind.version == "v1"
  input.review.kind.group == ""
  input_selector := flatten_selector(input.review.object)
  other := data.inventory.namespace[namespace][_][_][name]
  not identical(other, input.review)
  other_selector := flatten_selector(other)
  input_selector == other_selector
  msg := sprintf("same selector as service <%v> in namespace <%v>", [name, namespace])
}
"""

# kind -> (Rego, the groups and kind its constraint matches)
UNIQUENESS = {
    "K8sUniqueIngressHost": (
        UNIQUE_INGRESS_HOST_REGO, (("extensions", "networking.k8s.io"), "Ingress"),
    ),
    "K8sUniqueServiceSelector": (
        UNIQUE_SERVICE_SELECTOR_REGO, (("",), "Service"),
    ),
}


def uniqueness_templates():
    return [
        {
            "apiVersion": "templates.gatekeeper.sh/v1beta1",
            "kind": "ConstraintTemplate",
            "metadata": {"name": kind.lower()},
            "spec": {
                "crd": {"spec": {"names": {"kind": kind}}},
                "targets": [{"target": TARGET, "rego": rego}],
            },
        }
        for kind, (rego, _) in UNIQUENESS.items()
    ]


def uniqueness_constraints():
    """One constraint per uniqueness template: such policies are deployed
    once per cluster."""
    return [
        {
            "apiVersion": "constraints.gatekeeper.sh/v1beta1",
            "kind": kind,
            "metadata": {"name": f"unique-{kind[9:].lower()}"},
            "spec": {"match": {"kinds": [
                {"apiGroups": list(groups), "kinds": [k]}
            ]}},
        }
        for kind, (_, (groups, k)) in UNIQUENESS.items()
    ]


def template_docs():
    """The 8 in-repo ConstraintTemplates (deploy/policies)."""
    import yaml

    out = []
    for name in ("reference-library.yaml", "templates.yaml"):
        with open(os.path.join(POLICIES, name)) as f:
            out.extend(
                d for d in yaml.safe_load_all(f)
                if d and d.get("kind") == "ConstraintTemplate"
            )
    return out


def constraint_docs(n: int):
    """n constraints cycled over the templates, parameters varied."""
    kinds = [t["spec"]["crd"]["spec"]["names"]["kind"] for t in template_docs()]
    out = []
    for i in range(n):
        kind = kinds[i % len(kinds)]
        variants = PARAMS[kind]
        params = variants[(i // len(kinds)) % len(variants)]
        spec = {"match": {"kinds": [{"apiGroups": [""], "kinds": ["Pod"]}]}}
        if params is not None:
            spec["parameters"] = params
        out.append({
            "apiVersion": "constraints.gatekeeper.sh/v1beta1",
            "kind": kind,
            "metadata": {"name": f"c{i}"},
            "spec": spec,
        })
    return out


def make_pod(i: int, max_containers: int = 16, name: str = None):
    """A synthetic Pod in the shape of bench.make_pod: 1..max_containers
    containers, labels, seccomp/apparmor annotations, hostPath volumes on
    a third of pods; about 1% violate some template."""
    labels = {"app": f"svc{i % 17}", "owner": f"team{i % 5}"}
    if i % 499 == 0:
        labels.pop("owner")
    if i % 37 == 0:
        labels.update({f"k{j}": f"v{j}" for j in range(i % 9)})
    image = "nginx:1.25" if i % 503 else "docker.io/evil:latest"
    n_ctr = 1 + (i % max_containers)
    containers = []
    for c in range(n_ctr):
        ctr = {
            "name": f"c{c}",
            "image": image if c == 0 else "nginx:1.25",
            "resources": {"limits": {
                "cpu": "1", "memory": "12Gi" if i % 509 == 0 else "2Gi",
            }},
        }
        if c == 0 and i % 521 == 0:
            ctr["securityContext"] = {"privileged": True}
        containers.append(ctr)
    ann = {
        "seccomp.security.alpha.kubernetes.io/pod": "runtime/default",
    }
    if i % 541 == 0:
        ann = {}
    for c in range(n_ctr):
        ann[f"container.apparmor.security.beta.kubernetes.io/c{c}"] = (
            "runtime/default"
        )
    meta = {
        "name": name or f"p{i}",
        "namespace": f"ns{i % 23}",
        "labels": labels,
        "annotations": ann,
    }
    spec = {"containers": containers}
    if i % 3 == 0:
        spec["volumes"] = [
            {"name": "data", "hostPath": {"path": "/var/log/app"}},
            {"name": "cache", "emptyDir": {}},
        ]
        containers[0]["volumeMounts"] = [
            {"name": "data", "mountPath": "/data", "readOnly": True},
        ]
    return {"apiVersion": "v1", "kind": "Pod", "metadata": meta, "spec": spec}


def review_batch(seed: int, size: int):
    """An admission micro-batch: fresh pods carrying strings the audit
    corpus never interned (names, labels, images), so the review path
    runs its vocabulary overlay."""
    from gatekeeper_tpu_torch.constraint import AugmentedUnstructured

    out = []
    for j in range(size):
        i = 1_000_000 + seed * size + j
        pod = make_pod(i, name=f"admit-{seed}-{j}")
        pod["metadata"]["labels"]["release"] = f"r{seed}-{j}"
        if j % 5 == 0:
            pod["spec"]["containers"][0]["image"] = f"docker.io/novel{seed}x{j}"
        out.append(AugmentedUnstructured(pod))
    return out


def make_mixed(i: int):
    """A mixed-GVK corpus row in the shape of bench.make_mixed: about 1%
    Services, 2% Ingresses (networking.k8s.io/v1beta1), 1% Namespaces,
    and pods of 1-16 containers (make_pod) for the rest. Join keys are
    mostly unique: the Service of every 30th block of 100 rows repeats the
    previous block's selector, and the Ingresses of every 25th block
    repeat the previous block's hosts. (bench.make_mixed shifts the key by
    30 or 50 blocks, which lands on another shifted row, so its corpus
    holds no duplicate at all.)"""
    r, blk = i % 100, i // 100
    if r == 17:
        sel_id = i - 100 if blk % 30 == 1 else i
        return {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {"name": f"svc{i}", "namespace": f"ns{i % 23}"},
            "spec": {"selector": {"app": f"app{sel_id}"}},
        }
    if r in (18, 57):
        host_id = i - 100 if blk % 25 == 1 else i
        return {
            "apiVersion": "networking.k8s.io/v1beta1",
            "kind": "Ingress",
            "metadata": {"name": f"ing{i}", "namespace": f"ns{i % 23}"},
            "spec": {"rules": [{"host": f"h{host_id}.example.com"}]},
        }
    if r == 19:
        return {
            "apiVersion": "v1",
            "kind": "Namespace",
            "metadata": {"name": f"extra-ns{i}", "labels": {"env": "x"}},
        }
    return make_pod(i)


def mixed_review_batch(seed: int, size: int, n_corpus: int):
    """An admission micro-batch over a make_mixed corpus of n_corpus rows:
    new pods, and every 8th review a new Service or Ingress, half of them
    reusing a selector or host that the corpus holds, so the join screen
    of the review path fires."""
    from gatekeeper_tpu_torch.constraint import AugmentedUnstructured

    out = []
    for j in range(size):
        i = 1_000_000 + seed * size + j
        if j % 8 == 0:
            held = (j // 8) % 2 == 0
            src = (j * 997 + seed * 131) % max(n_corpus // 100, 1) * 100
            if (j // 16) % 2 == 0:
                obj = make_mixed(src + 17 if held else i - i % 100 + 17)
            else:
                obj = make_mixed(src + 18 if held else i - i % 100 + 18)
            obj["metadata"]["name"] = f"admit-{seed}-{j}"
        else:
            obj = make_pod(i, name=f"admit-{seed}-{j}")
            obj["metadata"]["labels"]["release"] = f"r{seed}-{j}"
        out.append(AugmentedUnstructured(obj))
    return out


def uniqueness_keys(o):
    """-> (uniqueness kind, the object's join keys: Ingress hosts or the
    Service's flattened selector), or (None, ())."""
    if o["kind"] == "Ingress":
        rules = o["spec"].get("rules") or []
        if isinstance(rules, dict):  # Rego's rules[_] takes the values
            rules = list(rules.values())
        return "K8sUniqueIngressHost", {r.get("host") for r in rules}
    if o["kind"] == "Service":
        sel = o["spec"].get("selector") or {}
        return "K8sUniqueServiceSelector", {
            ",".join(sorted(f"{k}:{v}" for k, v in sel.items()))
        }
    return None, ()


def uniqueness_index(objs):
    """{uniqueness kind: {join key: the (namespace, name) of its holders}}."""
    index = {kind: {} for kind in UNIQUENESS}
    for o in objs:
        kind, keys = uniqueness_keys(o)
        for k in keys:
            index[kind].setdefault(k, set()).add(
                (o["metadata"].get("namespace"), o["metadata"]["name"]))
    return index


def uniqueness_groups(objs):
    """Plain-Python grouping of a corpus: {uniqueness kind: the (namespace,
    name) of every object in a host or flattened-selector group of two or
    more members}."""
    return {
        kind: set().union(*[m for m in g.values() if len(m) >= 2])
        for kind, g in uniqueness_index(objs).items()
    }


def hostfs_template():
    return {
        "apiVersion": "templates.gatekeeper.sh/v1beta1",
        "kind": "ConstraintTemplate",
        "metadata": {"name": "k8spsphostfilesystem"},
        "spec": {
            "crd": {"spec": {"names": {"kind": "K8sPSPHostFilesystem"}}},
            "targets": [{"target": TARGET, "rego": HOSTFS_REGO}],
        },
    }


def join_constraint_docs(n: int, actions=("deny",)):
    """n host-filesystem constraints over Pods, allowedHostPaths cycled
    through JOIN_PARAMS and enforcement actions through `actions`."""
    out = []
    for i in range(n):
        spec = {
            "match": {"kinds": [{"apiGroups": [""], "kinds": ["Pod"]}]},
            "parameters": {"allowedHostPaths": JOIN_PARAMS[i % len(JOIN_PARAMS)]},
        }
        action = actions[i % len(actions)]
        if action != "deny":
            spec["enforcementAction"] = action
        out.append({
            "apiVersion": "constraints.gatekeeper.sh/v1beta1",
            "kind": "K8sPSPHostFilesystem",
            "metadata": {"name": f"hostfs{i}"},
            "spec": spec,
        })
    return out


def churn_pod(j: int):
    """A pod the sync controller adds between sweeps: a new name, image
    tag, label and, on every third pod, a hostPath the corpus never held,
    mounted writable on every other one of those."""
    pod = make_pod(2_000_000 + j, name=f"churn-{j}")
    pod["metadata"]["labels"]["rollout"] = f"r{j}"
    pod["spec"]["containers"][0]["image"] = f"nginx:1.{j}-churn"
    if j % 3 == 0:
        pod["spec"]["volumes"] = [
            {"name": "scratch", "hostPath": {"path": f"/srv/churn{j}/data"}},
        ]
        pod["spec"]["containers"][0]["volumeMounts"] = [
            {"name": "scratch", "mountPath": "/scratch",
             "readOnly": j % 2 == 0},
        ]
    return pod


def report_key(report):
    """An AuditReport as plain data: totals, totals by enforcement
    action, and each constraint's status with its capped, truncated
    violations, in the manager's order."""
    return {
        "timestamp": report.timestamp,
        "total": report.total_violations,
        "by_action": dict(report.by_enforcement_action),
        "statuses": [
            (key, st.constraint_kind, st.constraint_name, st.audit_timestamp,
             st.total_violations,
             [(v.message, v.enforcement_action, v.kind, v.name, v.namespace)
              for v in st.violations])
            for key, st in report.statuses.items()
        ],
    }


def build_client(driver, n_pods: int, n_constraints: int):
    from gatekeeper_tpu_torch.constraint import Backend, K8sValidationTarget

    client = Backend(driver).new_client(K8sValidationTarget())
    for t in template_docs():
        client.add_template(t)
    for c in constraint_docs(n_constraints):
        client.add_constraint(c)
    for i in range(n_pods):
        client.add_data(make_pod(i))
    return client


def result_key(r):
    obj = r.review.get("object") if isinstance(r.review, dict) else None
    name = (obj or {}).get("metadata", {}).get("name")
    return (
        r.constraint["kind"], r.constraint["metadata"]["name"], name, r.msg,
        json.dumps(r.metadata, sort_keys=True, default=str),
        r.enforcement_action,
    )


def _keys(results):
    return [result_key(r) for r in results]


# -- timing -------------------------------------------------------------------


def _time_ms(fn, reps: int = 10) -> float:
    """Wall ms per call of back-to-back calls, between CUDA events: the
    host's cost of issuing the call whenever that exceeds the device's."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_time_us(evt) -> float:
    t = getattr(evt, "self_device_time_total", None)
    return float(t if t is not None else evt.self_cuda_time_total)


HEAD_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel


def _window_head():
    """Open a profiler window with throwaway launches: torch.profiler on
    the H100 drops the first kernel records of a window (up to about ten
    seen, and 34 in some windows after a long unprofiled phase), and these
    absorb the loss. Their time is left out of every sum (HEAD_KERNEL)."""
    import torch

    for _ in range(256):
        torch.cuda._sleep(100)
    torch.cuda.synchronize()


def _kernel_name(evt) -> str:
    """The kernel's bare name: no return type, namespace, template or
    parameter list ("at::cuda::(anonymous namespace)::spin_kernel(long)"
    gives "spin_kernel")."""
    key = (evt.key or "").replace("(anonymous namespace)", "")
    parts = key.split("<")[0].split("(")[0].split()
    return parts[-1].split("::")[-1] if parts else ""


def _device_ms(fn, kernels=None, reps: int = 10) -> float:
    """Device ms per call (torch.profiler, CUDA activity): the summed
    execution time of the kernels named in `kernels` (each launched once
    per call; a profile missing one of their records is taken again), or
    of all device activity when `kernels` is None (then two profiles must
    record the same kernels, each a whole number of times per call, and
    the larger sum is taken: a lost record only lowers a sum). Host issue
    time does not enter it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    whole = []  # (kernel names, us) of the profiles with whole counts
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _window_head()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = 0.0
        seen = {}
        for e in prof.key_averages():
            name = _kernel_name(e)
            # host-side records (cudaLaunchKernel, ...) carry no device time
            if name == HEAD_KERNEL or _device_time_us(e) <= 0.0:
                continue
            seen[name] = seen.get(name, 0) + e.count
            if kernels is None or name in kernels:
                us += _device_time_us(e)
        if kernels is not None:
            short = [k for k in kernels if 0 < seen.get(k, 0) < reps]
            if us > 0.0 and not short:
                return us / 1e3 / reps
        elif us > 0.0 and all(n % reps == 0 for n in seen.values()):
            whole.append((frozenset(seen), us))
            same = [u for names, u in whole if names == whole[-1][0]]
            if len(same) >= 2:
                return max(same) / 1e3 / reps
    raise AssertionError(
        f"profiler recorded {seen} for {kernels} over {reps} calls")


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# -- phases -------------------------------------------------------------------


def phase_card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def phase_card():
    out = phase_card_line()
    print(out, flush=True)
    return out


def phase_build():
    from gatekeeper_tpu_torch.kernels import build

    from gatekeeper_tpu_torch import native

    t0 = time.perf_counter()
    logs = build.build_all()
    dt = time.perf_counter() - t0
    # ptxas register / shared-memory report of what was compiled
    with open(build.BUILD_DIR / "ptxas.txt", "w") as f:
        for name, log in logs.items():
            f.write(f"== {name}.cu\n{log}\n")
    t1 = time.perf_counter()
    native.load_flatten_native()  # gcc: the C token flattener
    t2 = time.perf_counter()
    native.build_frontend()  # g++: the webhook's native HTTP front
    store = build.process_store()
    print(json.dumps({"phase": "build", "seconds": dt,
                      "built": sorted(logs),
                      "native_seconds": t2 - t1,
                      "frontend_seconds": time.perf_counter() - t2,
                      "store": store.stats() if store is not None else None}),
          flush=True)
    return dt


# -- store: the compile-artifact store gates every kernel library -----------

# K1-K7's libraries (kernels/build.py sources) by the wrapper each serves
STORE_KERNELS = {os.path.basename(src)[: -len(".cu")]: name
                 for name, (src, _) in KERNELS.items()}

# the child of phase_store: adopts from the store at
# GATEKEEPER_TPU_COMPILE_CACHE_DIR with no nvcc on its PATH, then launches
# each kernel once against its plain version
STORE_CHILD = r"""
import json, os, shutil, subprocess, sys, time
sys.path.insert(0, os.environ["SMOKE_ROOT"])
starts = []
_popen = subprocess.Popen


class Guard(_popen):
    def __init__(self, args, *a, **kw):
        argv = [args] if isinstance(args, (str, bytes)) else list(args)
        if argv and os.path.basename(str(argv[0])) == "nvcc":
            starts.append(argv)
            raise RuntimeError("store child: nvcc started")
        super().__init__(args, *a, **kw)


subprocess.Popen = Guard
import torch
import chip_smoke as c
from gatekeeper_tpu_torch.kernels import build, ops

t0 = time.perf_counter()
store = build.process_store()
adopt_s = time.perf_counter() - t0
first = {}
for name, args, kw in c._random_variants("cuda"):
    first.setdefault(name, (args, kw))
ops.reset_launches()
checked = {}
for name in c.STORE_KERNELS.values():
    args, kw = first[name]
    got = c._flat(getattr(ops, name)(*c._fresh(name, args), **kw))
    want = c._flat(c._plain(name)(*c._fresh(name, args), **kw))
    torch.cuda.synchronize()
    if got.dtype != want.dtype or not torch.equal(got, want):
        raise AssertionError(f"store child: {name} differs from its plain version")
    checked[name] = list(got.shape)
maps = open("/proc/self/maps").read().split()
loaded = sorted({p for p in maps if "libgk_" in p})
print(json.dumps({
    "adopt_s": adopt_s, "stats": store.stats(), "table": store.table(),
    "libs": {k: v[1] for k, v in build._libs.items()},
    "loaded": loaded, "launches": dict(ops.LAUNCHES), "checked": checked,
    "nvcc_starts": len(starts), "nvcc_on_path": shutil.which("nvcc"),
}))
"""


def _forge(art: str, payload: bytes, meta: dict) -> str:
    """One forged artifact in the store layout: payload and attestation
    under the sha256 the attestation claims."""
    import hashlib

    sha = meta.get("sha256") or hashlib.sha256(payload).hexdigest()
    with open(os.path.join(art, f"{sha}.bin"), "wb") as f:
        f.write(payload)
    with open(os.path.join(art, f"{sha}.meta.json"), "w") as f:
        json.dump(dict({"sha256": sha}, **meta), f)
    return sha


def phase_store(cold_build_s: float):
    """The compile-artifact store on the card. The libraries `build` made
    are attested into a fresh store root under build/; four forged
    artifacts join them, one per reject reason (another machine's
    fingerprint, a payload whose sha256 differs from its attestation, a
    schema-0 attestation, a bare file at the root) under the file names
    of real kernel libraries. A child process with that root, an empty
    load directory and no nvcc on its PATH adopts, then launches K1-K7
    once each from the adopted files against their plain versions, bit
    for bit: it must start no nvcc, load every libgk_ library from the
    store's lib dir with the attested content, and count each forgery
    under its reason. -> the child's launches."""
    import hashlib
    import shutil

    from gatekeeper_tpu_torch.compile import ProgramStore
    from gatekeeper_tpu_torch.kernels import build

    t0 = time.perf_counter()
    main_store = build.process_store()
    if main_store is None:
        raise AssertionError("store: the process has no store (is "
                             "GATEKEEPER_TPU_NO_COMPILE_CACHE set?)")
    root = str(build.BUILD_DIR / f"store-smoke-{os.getpid()}")
    shutil.rmtree(root, ignore_errors=True)
    fresh = ProgramStore(root)
    if fresh.fp_digest != main_store.fp_digest:
        raise AssertionError("store: two fingerprints on one machine")
    names = {src: build._filename(src) for src in STORE_KERNELS}
    payloads = {}
    for src, filename in names.items():
        path = main_store.lookup(filename)
        if path is None:
            raise AssertionError(f"store: build left {filename} unattested")
        shutil.copy(path, os.path.join(fresh.lib_dir, filename))
        with open(path, "rb") as f:
            payloads[src] = f.read()
    t_a = time.perf_counter()
    attested = fresh.attest()
    attest_s = time.perf_counter() - t_a
    if attested != len(names):
        raise AssertionError(f"store: attested {attested} of {len(names)}")
    shutil.rmtree(os.path.join(root, "by-fingerprint"))  # empty load dir
    art = fresh.artifacts_dir
    forged = {
        "fingerprint_mismatch": _forge(art, payloads["match"] + b"\0", {
            "schema": 1, "filename": names["match"],
            "fingerprint": "f" * 64}),
        "corrupt": _forge(art, b"forged slab library", {
            "schema": 1, "filename": names["slab"],
            "sha256": hashlib.sha256(payloads["slab"]).hexdigest()[::-1],
            "fingerprint": fresh.fp_digest}),
        "schema": _forge(art, payloads["group"] + b"\0", {
            "schema": 0, "filename": names["group"],
            "fingerprint": fresh.fp_digest}),
    }
    with open(os.path.join(root, names["need"]), "wb") as f:
        f.write(b"a legacy library of unknown origin")
    path_dirs = [d for d in os.environ.get("PATH", "").split(os.pathsep)
                 if d and not os.path.exists(os.path.join(d, "nvcc"))]
    env = dict(os.environ, GATEKEEPER_TPU_COMPILE_CACHE_DIR=root,
               PATH=os.pathsep.join(path_dirs), SMOKE_ROOT=ROOT,
               PYTHONPATH=ROOT)
    env.pop("GATEKEEPER_TPU_NO_COMPILE_CACHE", None)
    t_c = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", STORE_CHILD], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    child_s = time.perf_counter() - t_c
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
        raise AssertionError(f"store: the child exited {proc.returncode}")
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    stats, lib_dir = doc["stats"], doc["stats"]["lib_dir"]
    want_rejected = {r: 1 for r in ("fingerprint_mismatch", "corrupt",
                                    "schema", "unattested")}
    problems = []
    if doc["nvcc_starts"] or doc["nvcc_on_path"]:
        problems.append("nvcc started or on the PATH")
    if stats["rejected"] != want_rejected:
        problems.append(f"rejected {stats['rejected']}")
    if stats["hits"] != len(names) or stats["misses"] or stats["saves"]:
        problems.append(f"hits/misses/saves {stats}")
    for src, filename in names.items():
        loaded = doc["libs"].get(src)
        if loaded != os.path.join(lib_dir, filename):
            problems.append(f"{src} loaded from {loaded}")
            continue
        with open(loaded, "rb") as f:
            if f.read() != payloads[src]:
                problems.append(f"{src}: the loaded file is not the attested one")
    if any(not p.startswith(lib_dir + os.sep) for p in doc["loaded"]) or \
            len(doc["loaded"]) != len(names):
        problems.append(f"mapped libraries {doc['loaded']}")
    if any(n != 1 for n in doc["launches"].values()):
        problems.append(f"launches {doc['launches']}")
    rows = {r["reason"] for r in doc["table"] if r["status"] == "rejected"}
    if rows != set(want_rejected) or any(
            sha[:12] == r["artifact"] and r["status"] == "adopted"
            for sha in forged.values() for r in doc["table"]):
        problems.append(f"table {doc['table']}")
    out = {"phase": "store", "cold_build_all_s": cold_build_s,
           "attest_s": attest_s, "adopt_s": doc["adopt_s"],
           "child_s": child_s, "nvcc_starts": doc["nvcc_starts"],
           "adopted": stats["hits"], "rejected": stats["rejected"],
           "fingerprint": stats["fingerprint_components"],
           "launches": doc["launches"], "checked": doc["checked"],
           "seconds": time.perf_counter() - t0}
    print(json.dumps(out), flush=True)
    print(phase_card_line(), flush=True)
    if problems:
        raise AssertionError(f"store: {problems}")
    shutil.rmtree(root, ignore_errors=True)
    return {w: doc["launches"][w] for w in STORE_KERNELS.values()}


def phase_parity(device: str, n_pods: int = 1000, n_constraints: int = 50,
                 n_batches: int = 4, batch: int = 64):
    """Review batches on TorchDriver against the interpreter driver. The
    audit of the same corpus is compared in phase_audit_parity, whole
    result lists included. -> (port client, reference client, driver)."""
    from gatekeeper_tpu_torch.constraint import RegoDriver
    from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver

    t0 = time.perf_counter()
    drv = TorchDriver(device)
    port = build_client(drv, n_pods, n_constraints)
    ref = build_client(RegoDriver(), n_pods, n_constraints)
    n_review = 0
    for b in range(n_batches):
        objs = review_batch(900 + b, batch)
        g = [_keys(r.by_target[TARGET].results) for r in port.review_many(objs)]
        w = [_keys(r.by_target[TARGET].results) for r in ref.review_many(objs)]
        if g != w:
            raise AssertionError(f"parity: review batch {b} differs")
        n_review += sum(len(x) for x in g)
    print(json.dumps({
        "phase": "parity", "pods": n_pods, "constraints": n_constraints,
        "review_results": n_review,
        "compiled_pairs": drv.stats["compiled_pairs"],
        "interp_pairs": drv.stats["interp_pairs"],
        "seconds": time.perf_counter() - t0,
    }), flush=True)
    return port, ref, drv


def merge_subset_results(result_lists, order):
    """One review's per-subset results in the whole set's emit order:
    autoreject results first, then the rest, each in constraint order
    (`order`: constraint key -> index), a subset's own order kept within
    one constraint (gatekeeper_tpu/parallel/partition.py
    merge_partition_results)."""
    from gatekeeper_tpu_torch.constraint.driver import (
        AUTOREJECT_MSG, constraint_key,
    )

    merged = [r for results in result_lists for r in results]
    merged.sort(key=lambda r: (0 if r.msg == AUTOREJECT_MSG else 1,
                               order.get(constraint_key(r.constraint),
                                         len(order))))
    return merged


def phase_subset(port, ref, drv, n_batches: int = 4, batch: int = 64,
                 k: int = 3):
    """Partition-scoped review (Client.review_many_subset) over the parity
    clients: the constraint keys split into k subsets (keys[p::k]); each
    subset's results equal the interpreter driver's for that subset, and
    merged in constraint order they equal the port's whole review_many.
    K1-K4 must launch over the subset reviews. -> their launch counts."""
    from gatekeeper_tpu_torch.kernels import ops

    t0 = time.perf_counter()
    keys = drv.constraint_keys(TARGET)
    order = {key: i for i, key in enumerate(keys)}
    subsets = [frozenset(keys[p::k]) for p in range(k)]

    def results(resps):
        return [r.by_target[TARGET].results if TARGET in r.by_target else []
                for r in resps]

    ops.reset_launches()
    parts_by_batch = []
    for b in range(n_batches):
        objs = review_batch(950 + b, batch)
        parts_by_batch.append(
            (objs, [results(port.review_many_subset(objs, s)) for s in subsets]))
    launches = dict(ops.LAUNCHES)
    n_results = 0
    for b, (objs, parts) in enumerate(parts_by_batch):
        for s, got in zip(subsets, parts):
            want = results(ref.review_many_subset(objs, s))
            if [_keys(x) for x in got] != [_keys(x) for x in want]:
                raise AssertionError(f"subset: batch {b} differs from interp")
        whole = results(port.review_many(objs))
        merged = [merge_subset_results([p[i] for p in parts], order)
                  for i in range(len(objs))]
        if [_keys(x) for x in merged] != [_keys(x) for x in whole]:
            raise AssertionError(f"subset: batch {b} merged differs")
        n_results += sum(len(x) for x in whole)
    if drv.device.type == "cuda":
        missing = [n for n in PATH_KERNELS["subset"] if launches[n] <= 0]
        if missing:
            raise AssertionError(f"subset: kernels never launched: {missing}")
    print(json.dumps({
        "phase": "subset", "subsets": [len(s) for s in subsets],
        "batches": n_batches, "results": n_results, "launches": launches,
        "seconds": time.perf_counter() - t0,
    }), flush=True)
    return launches


def _keep_audit(client):
    """Wrap client.audit so that its latest response stays readable (the
    manager keeps only the capped report); `del client.audit` undoes it.
    -> the dict holding the response under "resp"."""
    kept = {}
    audit = client.audit

    def audit_kept(*a, **kw):
        kept["resp"] = audit(*a, **kw)
        return kept["resp"]

    client.audit = audit_kept
    return kept


class Recorder:
    """Keeps the inputs of kernel calls on the main path (a few per
    kernel, distinct by their kind) for the kernel phase."""

    def __init__(self, ops):
        self.ops = ops
        self.calls = {name: {} for name in KERNELS}
        self.originals = {name: getattr(ops, name) for name in KERNELS}

    def install(self):
        for name, fn in self.originals.items():
            setattr(self.ops, name, self._wrap(name, fn))

    def remove(self):
        for name, fn in self.originals.items():
            setattr(self.ops, name, fn)

    def _wrap(self, name, fn):
        def rec(*args, **kw):
            key = _variant(name, args, kw)
            if key not in self.calls[name]:
                kept = args
                if name == "flush_deltas":
                    # K5 writes its buffers in place: keep them as the
                    # call found them
                    kept = ([b.clone() for b in args[0]],) + tuple(args[1:])
                self.calls[name][key] = (kept, kw)
            return fn(*args, **kw)

        return rec


def _variant(name, args, kw):
    if name == "flush_deltas":
        return (len(args[0]), sum(int(d.shape[0]) for d in args[2]))
    if name == "gather_elem":
        return (args[3], str(args[0].dtype), args[6])
    if name == "slab_gather":
        tab, ids = args[0], args[1]
        ov = args[2] if len(args) > 2 else kw.get("ov")
        return (str(tab.dtype), tuple(tab.shape[1:]), ov is not None)
    if name == "egroup":
        return (args[4], args[7], str(args[3].dtype))
    if name == "need_tail":
        return (tuple(args[2].shape), args[6])
    if name == "full_totals":
        return (tuple(args[0].shape), args[1] is not None)
    return tuple(args[1]["group_id"].shape)


def phase_full(device: str, n_pods: int = 100_000, n_constraints: int = 500,
               n_batches: int = 8, batch: int = 256):
    import torch
    from gatekeeper_tpu_torch.constraint import RegoDriver
    from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver
    from gatekeeper_tpu_torch.kernels import ops

    t0 = time.perf_counter()
    drv = TorchDriver(device)
    client = build_client(drv, n_pods, n_constraints)
    ingest_s = time.perf_counter() - t0
    rec = Recorder(ops)
    rec.install()
    ops.reset_launches()
    try:
        t1 = time.perf_counter()
        results = client.audit().by_target[TARGET].results
        audit_s = time.perf_counter() - t1
        audit_stats = dict(drv.stats, upload=_upload(drv.stats))
        audit_launches = dict(ops.LAUNCHES)
        batch_stats = []
        batch_objs = []
        review_results = []
        for b in range(n_batches):
            objs = review_batch(b, batch)
            t2 = time.perf_counter()
            resps = client.review_many(objs)
            st = dict(drv.stats)
            st["seconds"] = time.perf_counter() - t2
            batch_stats.append(st)
            batch_objs.append(objs)
            review_results.append(
                [_keys(r.by_target[TARGET].results) for r in resps]
            )
        launches = dict(ops.LAUNCHES)
    finally:
        rec.remove()
    if torch.device(device).type == "cuda":
        missing = [k for k in PATH_KERNELS["full"] if launches[k] <= 0]
        if missing:
            raise AssertionError(f"full: kernels never launched: {missing}")
    # correctness by the repo's own means: a sample of reviews (every
    # violating pod among the first 2,000 rows, a few clean ones, one
    # review batch) equals the interpreter driver's answer
    ref = build_client(RegoDriver(), 0, n_constraints)
    by_pod = {}
    for r in results:
        by_pod.setdefault(r.review["object"]["metadata"]["name"], []).append(r)
    bad = sorted(
        int(k[1:]) for k in by_pod if k.startswith("p") and int(k[1:]) < 2000
    )
    sample = bad[:12] + [i for i in range(1, 40) if f"p{i}" not in by_pod][:4]
    from gatekeeper_tpu_torch.constraint import AugmentedUnstructured

    for i in sample:
        obj = make_pod(i)
        want = _keys(ref.review(AugmentedUnstructured(obj)).by_target[TARGET].results)
        got = sorted(_keys(by_pod.get(f"p{i}", [])))
        if sorted(want) != got:
            raise AssertionError(f"full: audit of p{i} differs from interp")
    want_b = [
        _keys(r.by_target[TARGET].results)
        for r in ref.review_many(batch_objs[0][:32])
    ]
    if want_b != review_results[0][:32]:
        raise AssertionError("full: review batch 0 differs from interp")
    n_viol_pods = len(by_pod)
    print(json.dumps({
        "phase": "full", "pods": n_pods, "constraints": n_constraints,
        "ingest_seconds": ingest_s, "audit_seconds": audit_s,
        "audit_results": len(results), "violating_pods": n_viol_pods,
        "audit_stats": audit_stats, "audit_launches": audit_launches,
        "batches": [
            {"seconds": s["seconds"], "results": s["n_results"],
             "compiled_pairs": s["compiled_pairs"],
             "phase_seconds": s["phase_seconds"]}
            for s in batch_stats
        ],
        "launches": launches, "sample_checked": len(sample),
    }, default=float), flush=True)
    per_constraint = {}
    for r in results:
        k = f"{r.constraint['kind']}/{r.constraint['metadata']['name']}"
        per_constraint[k] = per_constraint.get(k, 0) + 1
    return rec, launches, client, drv, per_constraint


def _audit_managers(clients, cluster=None, now=None):
    """One AuditManager per client, all reading the same clock."""
    from gatekeeper_tpu_torch.audit import AuditManager, InMemorySink

    kw = {"audit_interval": 3600, "msg_size": 96}
    if now is not None:
        kw["now"] = now
    if cluster is not None:
        kw.update(audit_from_cache=False, cluster=cluster)
    return [
        AuditManager(c, TARGET, sink=InMemorySink(), **kw) for c in clients
    ]


def phase_audit_parity(port, ref, drv, n_pods: int = 1000, n_join: int = 4,
                       churn: float = 0.02):
    """AuditManager over the parity phase's TorchDriver client against
    AuditManager over its interpreter client, after adding n_join
    host-filesystem join constraints: from-cache sweeps before and after a
    churn of `churn` of the pods (whole result lists and reports equal;
    the managers share a fixed clock, so timestamps agree too), then one
    direct-list sweep over a FakeCluster holding the churned state."""
    from gatekeeper_tpu_torch.control import FakeCluster

    t0 = time.perf_counter()
    clients = [port, ref]
    joins = join_constraint_docs(n_join, actions=("deny", "dryrun", "warn"))
    for c in clients:
        c.add_template(hostfs_template())
        for j in joins:
            c.add_constraint(j)
    fixed = lambda: 1_760_000_000.0  # noqa: E731
    mgrs = _audit_managers(clients, now=fixed)
    kept = [_keep_audit(c) for c in clients]
    out = {"phase": "audit_parity", "join_constraints": n_join}
    uploads = []
    try:
        for sweep in ("sweep1", "sweep2"):
            if sweep == "sweep2":
                n_churn = int(n_pods * churn)
                gone = list(range(0, n_pods, n_pods // n_churn))[:n_churn]
                for c in clients:
                    for i in gone:
                        c.remove_data(make_pod(i))
                    for j in range(n_churn):
                        c.add_data(churn_pod(j))
            got, want = (report_key(m.audit()) for m in mgrs)
            uploads.append(_upload(drv.stats))
            res = [_keys(k["resp"].by_target[TARGET].results) for k in kept]
            if res[0] != res[1]:
                raise AssertionError(f"audit parity: {sweep} results differ")
            if got != want:
                raise AssertionError(f"audit parity: {sweep} reports differ")
            out[sweep] = {"results": len(res[0]), "total": got["total"],
                          "by_action": got["by_action"],
                          "statuses": len(got["statuses"]),
                          "upload": uploads[-1]}
    finally:
        for c in clients:
            del c.audit
    if uploads[1]["full_uploads"] or not uploads[1]["delta_flushes"]:
        raise AssertionError(f"audit parity: sweep 2 upload {uploads[1]}")
    cluster = FakeCluster()
    for ns in range(23):
        cluster.apply({"apiVersion": "v1", "kind": "Namespace",
                       "metadata": {"name": f"ns{ns}"}})
    gone_set = set(gone)
    for i in range(n_pods):
        if i not in gone_set:
            cluster.apply(make_pod(i))
    for j in range(n_churn):
        cluster.apply(churn_pod(j))
    got, want = (
        report_key(m.audit())
        for m in _audit_managers(clients, cluster=cluster, now=fixed)
    )
    if got != want:
        raise AssertionError("audit parity: direct-list reports differ")
    out.update(pods=n_pods, churned=n_churn,
               direct={"total": got["total"], "by_action": got["by_action"]},
               seconds=time.perf_counter() - t0)
    print(json.dumps(out), flush=True)


def _keep_k8s_stats(drv):
    """-> a dict that holds `drv.stats` as each K8s audit query left it:
    a Runner with the agent target audits both targets in turn, so
    `drv.stats` ends on the agent target's."""
    kept = {}
    audit = drv._audit

    def kept_audit(target, trace):
        out = audit(target, trace)
        if target == TARGET:
            kept.clear()
            kept.update(drv.stats)
        return out

    drv._audit = kept_audit
    return kept


def _upload(stats):
    """A query's upload counters, the names of wholly uploaded tables
    reduced to their number."""
    up = dict(stats["upload"])
    up["full_tables"] = len(up["full_tables"])
    return up


def _vocab_fill(drv):
    """(rows filled, rows of capacity) of the resident vocab tables."""
    ent = next(iter(drv.kernel._resident.values()))
    return ent.fill, int(ent.buf.shape[0])


def phase_audit_churn(client, drv, rec, n_constraints: int = 500,
                      n_join: int = 20, n_churn: int = 1000):
    """The audit controller at full width across cluster churn: the full
    phase's client, its last n_join constraints swapped for join
    constraints (a policy change: sweep 1 uploads the tables whole), then
    n_churn pods removed and n_churn new ones added (sweep 2 re-encodes
    the corpus and must ship only the new vocab rows). Counts every
    kernel's launches over both sweeps."""
    import torch
    from gatekeeper_tpu_torch.audit import AuditManager, InMemorySink
    from gatekeeper_tpu_torch.constraint import AugmentedUnstructured, RegoDriver
    from gatekeeper_tpu_torch.kernels import ops

    n_pods = len(drv._corpus[TARGET].reviews)
    gone = list(range(0, n_pods, n_pods // n_churn))[:n_churn]
    swapped = constraint_docs(n_constraints)[-n_join:]
    joins = join_constraint_docs(n_join)
    kept = {}
    audit = client.audit

    def audit_kept(*a, **kw):
        kept["resp"] = audit(*a, **kw)
        return kept["resp"]

    client.audit = audit_kept  # the manager's sweep results, kept whole
    mgr = AuditManager(client, TARGET, sink=InMemorySink(), audit_interval=3600)
    sweeps = []
    rec.install()
    ops.reset_launches()
    try:
        for sweep in ("sweep1", "sweep2"):
            t0 = time.perf_counter()
            if sweep == "sweep1":
                for c in swapped:
                    client.remove_constraint(c)
                client.add_template(hostfs_template())
                for c in joins:
                    client.add_constraint(c)
            else:
                for i in gone:
                    client.remove_data(make_pod(i))
                for j in range(n_churn):
                    client.add_data(churn_pod(j))
            t1 = time.perf_counter()
            report = mgr.audit()
            if drv.device.type == "cuda":
                torch.cuda.synchronize()
            fill, cap = _vocab_fill(drv)
            sweeps.append({
                "sweep": sweep, "change_seconds": t1 - t0,
                "wall_seconds": time.perf_counter() - t1,
                "violations": report.total_violations,
                "by_action": report.by_enforcement_action,
                "phase_seconds": drv.stats["phase_seconds"],
                "upload": _upload(drv.stats),
                "vocab_rows": fill, "vocab_capacity": cap,
                "launches": dict(ops.LAUNCHES),
            })
        launches = dict(ops.LAUNCHES)
    finally:
        rec.remove()
        del client.audit
    up1, up2 = sweeps[0]["upload"], sweeps[1]["upload"]
    if not up1["full_uploads"]:
        raise AssertionError(f"audit churn: sweep 1 took no full upload {up1}")
    if up2["full_uploads"] or not up2["delta_flushes"]:
        raise AssertionError(f"audit churn: sweep 2 was no delta upload {up2}")
    if drv.device.type == "cuda":
        missing = [k for k in PATH_KERNELS["audit_churn"] if launches[k] <= 0]
        if missing:
            raise AssertionError(
                f"audit churn: kernels never launched: {missing}")
        k5 = [sw["launches"]["flush_deltas"] for sw in sweeps]
        if k5[1] <= k5[0]:
            raise AssertionError("audit churn: sweep 2 launched no K5")
    # correctness by the repo's own means: sampled pods of sweep 2 (new
    # pods with and without hostPaths, corpus pods that violate, clean
    # ones) equal the interpreter driver's answer
    ref = build_client(RegoDriver(), 0, n_constraints)
    for c in swapped:
        ref.remove_constraint(c)
    ref.add_template(hostfs_template())
    for c in joins:
        ref.add_constraint(c)
    by_pod = {}
    for r in kept["resp"].by_target[TARGET].results:
        by_pod.setdefault(r.review["object"]["metadata"]["name"], []).append(r)
    sample = [churn_pod(j) for j in range(12)]
    bad = sorted(k for k in by_pod if k.startswith("p"))[:6]
    sample += [make_pod(int(k[1:])) for k in bad]
    sample += [make_pod(i) for i in range(1, 40)
               if i not in set(gone) and f"p{i}" not in by_pod][:4]
    for obj in sample:
        name = obj["metadata"]["name"]
        want = _keys(ref.review(AugmentedUnstructured(obj)).by_target[TARGET].results)
        if sorted(want) != sorted(_keys(by_pod.get(name, []))):
            raise AssertionError(f"audit churn: {name} differs from interp")
    n_join_viol = sum(
        1 for rs in by_pod.values() for r in rs
        if r.constraint["kind"] == "K8sPSPHostFilesystem"
    )
    print(json.dumps({
        "phase": "audit_churn", "pods": n_pods,
        "constraints": n_constraints, "join_constraints": n_join,
        "churned": n_churn, "sweeps": sweeps,
        "join_violations_sweep2": n_join_viol,
        "sample_checked": len(sample), "launches": launches,
    }, default=float), flush=True)
    return launches


def build_mixed_client(driver, n_rows: int, n_constraints: int):
    """BASELINE config #5 as the repo defines it: n_rows make_mixed rows
    under n_constraints constraints, the last two the uniqueness joins
    (deployed once per cluster) and the rest the in-repo templates."""
    from gatekeeper_tpu_torch.constraint import Backend, K8sValidationTarget

    client = Backend(driver).new_client(K8sValidationTarget())
    for t in template_docs() + uniqueness_templates():
        client.add_template(t)
    for c in constraint_docs(n_constraints - 2) + uniqueness_constraints():
        client.add_constraint(c)
    for i in range(n_rows):
        client.add_data(make_mixed(i))
    return client


def _obj_key(r):
    obj = r.review["object"] if isinstance(r.review, dict) else {}
    meta = obj.get("metadata", {})
    return meta.get("namespace"), meta.get("name")


def _flagged(results):
    """{uniqueness kind: the (namespace, name) of every object a result
    of that kind names}."""
    out = {kind: set() for kind in UNIQUENESS}
    for r in results:
        if r.constraint["kind"] in out:
            out[r.constraint["kind"]].add(_obj_key(r))
    return out


class RenderWatch:
    """Counts the interpreter renders of uniqueness constraints that got
    the whole inventory (none may: each goes through the prune index)."""

    def __init__(self, drv):
        self.drv = drv
        self.full = 0
        self.pruned = 0
        self.inside = False
        self.orig = (drv._render_pruned, drv._eval_template)

    def install(self):
        render_pruned, eval_template = self.orig

        def pruned(*a, **kw):
            self.inside = True
            try:
                self.pruned += 1
                return render_pruned(*a, **kw)
            finally:
                self.inside = False

        def evaluate(target, constraint, *a, **kw):
            if constraint.get("kind") in UNIQUENESS and not self.inside:
                self.full += 1
            return eval_template(target, constraint, *a, **kw)

        self.drv._render_pruned = pruned
        self.drv._eval_template = evaluate

    def remove(self):
        del self.drv._render_pruned
        del self.drv._eval_template


def phase_inventory_parity(device: str, n_rows: int = 2000,
                           n_constraints: int = 50, n_batches: int = 4,
                           batch: int = 64):
    """make_mixed rows under n_constraints in-repo constraints plus the
    two uniqueness joins, on TorchDriver and on the interpreter driver:
    whole audit() and review_many() result lists must be equal."""
    from gatekeeper_tpu_torch.constraint import RegoDriver
    from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver

    t0 = time.perf_counter()
    drv = TorchDriver(device)
    port = build_mixed_client(drv, n_rows, n_constraints + 2)
    ref = build_mixed_client(RegoDriver(), n_rows, n_constraints + 2)
    got = _keys(port.audit().by_target[TARGET].results)
    audit_stats = dict(drv.stats)
    want = _keys(ref.audit().by_target[TARGET].results)
    if got != want:
        raise AssertionError("inventory parity: audit results differ")
    n_review = 0
    pruned = audit_stats["pruned_renders"]
    for b in range(n_batches):
        objs = mixed_review_batch(900 + b, batch, n_rows)
        g = [_keys(r.by_target[TARGET].results) for r in port.review_many(objs)]
        pruned += drv.stats["pruned_renders"]
        w = [_keys(r.by_target[TARGET].results) for r in ref.review_many(objs)]
        if g != w:
            raise AssertionError(f"inventory parity: review batch {b} differs")
        n_review += sum(len(x) for x in g)
    n_unique = sum(1 for k in got if k[0] in UNIQUENESS)
    if not n_unique or not pruned:
        raise AssertionError(
            f"inventory parity: {n_unique} uniqueness results, "
            f"{pruned} pruned renders")
    print(json.dumps({
        "phase": "inventory_parity", "rows": n_rows,
        "constraints": n_constraints + 2, "audit_results": len(got),
        "uniqueness_results": n_unique, "review_results": n_review,
        "pruned_renders": pruned,
        "row_features": {k: int(v.sum()) for k, v in
                         (drv._corpus[TARGET].row_feats or {}).items()},
        "seconds": time.perf_counter() - t0,
    }), flush=True)


def phase_inventory(device: str, rec, n_rows: int = 100_000,
                    n_constraints: int = 500, n_batches: int = 8,
                    batch: int = 256):
    """BASELINE config #5 at full width: one cold audit sweep of n_rows
    mixed-GVK rows under n_constraints constraints (the two uniqueness
    joins included), then n_batches review batches of `batch` mixed
    reviews, some reusing a host or selector the inventory holds. The
    uniqueness violations must equal a plain-Python grouping of the
    corpus, and every uniqueness render must go through the prune index.
    -> (client, driver, the sweep's need pairs, launches)."""
    import torch
    from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver
    from gatekeeper_tpu_torch.kernels import ops

    t0 = time.perf_counter()
    drv = TorchDriver(device)
    client = build_mixed_client(drv, n_rows, n_constraints)
    ingest_s = time.perf_counter() - t0
    sweep = {}
    need_pairs = drv._need_pairs

    def keep_pairs(target, cs, corpus, phases):
        out = need_pairs(target, cs, corpus, phases)
        if corpus.data_gen >= 0 and "pairs" not in sweep:
            sweep["pairs"] = list(out[0])
        return out

    drv._need_pairs = keep_pairs
    watch = RenderWatch(drv)
    watch.install()
    rec.install()
    ops.reset_launches()
    try:
        t1 = time.perf_counter()
        results = client.audit().by_target[TARGET].results
        if drv.device.type == "cuda":
            torch.cuda.synchronize()
        audit_s = time.perf_counter() - t1
        audit_stats = dict(drv.stats, upload=_upload(drv.stats))
        batches = []
        review_flagged = {kind: set() for kind in UNIQUENESS}
        reviewed = []
        for b in range(n_batches):
            objs = mixed_review_batch(b, batch, n_rows)
            t2 = time.perf_counter()
            resps = client.review_many(objs)
            st = dict(drv.stats)
            batches.append({
                "seconds": time.perf_counter() - t2,
                "results": st["n_results"],
                "pruned_renders": st["pruned_renders"],
                "interp_rendered_pairs": st["interp_rendered_pairs"],
                "phase_seconds": st["phase_seconds"],
            })
            for o, r in zip(objs, resps):
                reviewed.append(o.object)
                for kind, keys in _flagged(r.by_target[TARGET].results).items():
                    review_flagged[kind] |= keys
        launches = dict(ops.LAUNCHES)
    finally:
        rec.remove()
        watch.remove()
        del drv._need_pairs
    if drv.device.type == "cuda":
        missing = [k for k in PATH_KERNELS["inventory"] if launches[k] <= 0]
        if missing:
            raise AssertionError(f"inventory: kernels never launched: {missing}")
    corpus_objs = [make_mixed(i) for i in range(n_rows)]
    want = uniqueness_groups(corpus_objs)
    got = _flagged(results)
    for kind in UNIQUENESS:
        if got[kind] != want[kind] or not want[kind]:
            raise AssertionError(
                f"inventory: {kind} flags {len(got[kind])} objects, the "
                f"grouping {len(want[kind])}")
    # each reviewed Service/Ingress violates iff another object of the
    # corpus holds one of its keys
    index = uniqueness_index(corpus_objs)
    want_rev = {kind: set() for kind in UNIQUENESS}
    for o in reviewed:
        kind, keys = uniqueness_keys(o)
        me = (o["metadata"].get("namespace"), o["metadata"]["name"])
        if kind and any(index[kind].get(k, set()) - {me} for k in keys):
            want_rev[kind].add(me)
    if review_flagged != want_rev or not any(want_rev.values()):
        raise AssertionError(
            f"inventory: review batches flag "
            f"{ {k: len(v) for k, v in review_flagged.items()} }, the corpus "
            f"keys { {k: len(v) for k, v in want_rev.items()} }")
    pruned = audit_stats["pruned_renders"] + sum(b["pruned_renders"] for b in batches)
    if not pruned or watch.full:
        raise AssertionError(
            f"inventory: {pruned} pruned renders, {watch.full} uniqueness "
            "renders against the whole inventory")
    corpus = drv._corpus[TARGET]
    print(json.dumps({
        "phase": "inventory", "rows": n_rows, "constraints": n_constraints,
        "kinds": {k: sum(1 for o in corpus_objs if o["kind"] == k)
                  for k in ("Pod", "Service", "Ingress", "Namespace")},
        "ingest_seconds": ingest_s, "audit_seconds": audit_s,
        "audit_results": len(results),
        "uniqueness_flagged": {k: len(v) for k, v in got.items()},
        "fallback_rows": int(corpus.row_fallback.sum()),
        "invdup_bits": {k: int(v.sum()) for k, v in (corpus.row_feats or {}).items()},
        "audit_stats": audit_stats, "batches": batches,
        "review_flagged": {k: len(v) for k, v in review_flagged.items()},
        "render_split": {
            "host_rendered": audit_stats["host_rendered_pairs"],
            "interp_rendered": audit_stats["interp_rendered_pairs"],
            "pruned": audit_stats["pruned_renders"],
            "pruned_all_batches": pruned,
            "uniqueness_full_inventory": watch.full,
        },
        "need_pairs": len(sweep["pairs"]), "launches": launches,
    }, default=float), flush=True)
    return client, drv, sweep["pairs"], launches


def phase_full_output(client, drv, rec, sweep_pairs):
    """The full-output audit step (FusedKernel.run, match x programs x
    totals, unchunked) over the inventory phase's client at full width.
    K7 must equal its plain version, counts the per-program evaluator,
    match K1's plain version, and each compiled constraint without row
    features total its need pairs of the sweep. entry()'s step runs once.
    -> launches."""
    import numpy as np
    import torch
    from gatekeeper_tpu_torch.engine.programs import ProgramEvaluator
    from gatekeeper_tpu_torch.entry import entry
    from gatekeeper_tpu_torch.kernels import ops

    on_card = drv.device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    cs = drv._cset[TARGET]
    corpus = drv._corpus[TARGET]
    fn, args, (c, n, _key) = drv.kernel.prepare(
        cs.programs, cs.ms, corpus.fb, corpus.tok, corpus.g
    )
    sync()
    prepare_s = time.perf_counter() - t0
    rec.install()
    ops.reset_launches()
    try:
        t1 = time.perf_counter()
        match, counts, totals = fn(*args)
        sync()
        run_s = time.perf_counter() - t1
        launches = dict(ops.LAUNCHES)
    finally:
        rec.remove()
    missing = [k for k in PATH_KERNELS["full_output"] if launches[k] <= 0]
    if on_card and missing:
        raise AssertionError(f"full output: kernels never launched: {missing}")
    ms_u, spec_map, fb_dev, tok_dev, _tabs, crow = args
    plain_totals = ops.full_totals_plain(match, counts, crow, n)
    if not torch.equal(totals, plain_totals):
        raise AssertionError("full output: K7 differs from full_totals_plain")
    plain_match = ops.match_matrix_plain(ms_u, fb_dev)[spec_map.long()]
    if not torch.equal(match, plain_match):
        raise AssertionError("full output: match differs from K1's plain version")
    # counts against the per-program evaluator, once per distinct program
    ev = ProgramEvaluator(drv.patterns, drv.tables)
    crow_h = crow.cpu().numpy()
    uniq = {}
    for ci, p in enumerate(cs.programs):
        if p is not None:
            uniq.setdefault(id(p), (p, []))[1].append(int(crow_h[ci]))
    for p, rows in uniq.values():
        want = ev.eval([p], tok_dev, corpus.g)[0]
        if not torch.equal(counts[rows], want.expand(len(rows), n)):
            raise AssertionError("full output: counts differ from eval()")
    # totals against the sweep's need pairs (K4's output)
    totals_h = totals.cpu().numpy()
    fb_rows = np.nonzero(corpus.row_fallback)[0]
    per_c = np.zeros(c, np.int64)
    for n_i, c_i in sweep_pairs:
        if not corpus.row_fallback[n_i]:
            per_c[c_i] += 1
    if fb_rows.size:
        mv = (match[:, fb_rows].cpu().numpy()
              & (counts.cpu().numpy()[np.maximum(crow_h, 0)][:, fb_rows] > 0))
        per_c += np.where(crow_h >= 0, mv.sum(1), 0)
    tied = [ci for ci, p in enumerate(cs.programs)
            if p is not None and not p.row_features]
    bad = [ci for ci in tied if per_c[ci] != totals_h[ci]]
    if bad or not totals_h[tied].any():
        raise AssertionError(
            f"full output: totals differ from the sweep's need pairs at {bad[:5]}")
    # the harness step, once
    efn, eargs = entry(drv.device)
    e_match, e_counts, e_totals = efn(*eargs)
    if not torch.equal(e_totals, ops.full_totals_plain(e_match, e_counts, eargs[-1],
                                                       e_match.shape[1])):
        raise AssertionError("full output: entry() totals differ")
    # device time of one step, split
    split = _split_device_ms(lambda: fn(*args), launches) if on_card else None
    print(json.dumps({
        "phase": "full_output", "constraints": c, "rows": n,
        "compiled_rows": int(counts.shape[0]),
        "tokens": list(tok_dev["spath"].shape),
        "prepare_seconds": prepare_s, "run_seconds": run_s,
        "device_ms": split, "totals_sum": int(totals_h.sum()),
        "tied_constraints": len(tied), "fallback_rows": int(fb_rows.size),
        "entry_shapes": [list(e_match.shape), list(e_counts.shape)],
        "launches": launches,
    }, default=float), flush=True)
    return launches


def _split_device_ms(fn, launches, reps: int = 3):
    """Device ms per call of fn by kernel family (torch.profiler): all
    device work, K1, K7, K2, K3 and K6, and the program bodies (all but
    K1 and K7). A profile that misses a record of the families' launches
    is taken again, up to three times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fam = {"match_kernel": ("k1", "match_matrix"),
           "totals_kernel": ("k7", "full_totals"),
           "slab_kernel": ("k2", "slab_gather"),
           "egroup_kernel": ("k3", "egroup"),
           "gather_elem_kernel": ("k6", "gather_elem")}
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _window_head()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = {"total": 0.0, "k1": 0.0, "k7": 0.0, "k2": 0.0, "k3": 0.0,
               "k6": 0.0}
        seen = {}
        for e in prof.key_averages():
            name = _kernel_name(e)
            if name == HEAD_KERNEL:
                continue
            ms = _device_time_us(e) / 1e3 / reps
            out["total"] += ms
            if name in fam:
                out[fam[name][0]] += ms
                seen[fam[name][1]] = seen.get(fam[name][1], 0) + e.count
        want = {k: reps * n for k, n in launches.items()
                if n and k in {f[1] for f in fam.values()}}
        if all(seen.get(k, 0) == n for k, n in want.items()):
            out["program_bodies"] = out["total"] - out["k1"] - out["k7"]
            return out
    raise AssertionError(f"profile recorded {seen}, the step launches {want}")


def _match_needs(ms, fb, n: int):
    """-> (bytes, operations) K1 needs for this staged spec set: the spec
    arrays and the output whole, and a review feature array only where
    some spec row reads it (namespace ids and the `always` flags only
    under namespaces/excludedNamespaces/namespaceSelector, label arrays
    only under a selector with a live entry). Operations count live
    entries only: valid kind rows, -1-free namespace ids, matchLabels
    pairs and matchExpressions that are set."""
    import numpy as np

    from gatekeeper_tpu_torch.engine.matchspec import (
        OP_EXISTS, OP_IN, OP_NOT_EXISTS, OP_NOT_IN, SCOPE_CLUSTER,
        SCOPE_NAMESPACED, WILDCARD,
    )

    h = {k: v.cpu().numpy() for k, v in ms.items()}
    u = h["kind_rows"].shape[0]
    ml = fb["obj_labels"].shape[1]
    ml2 = fb["nssel_labels"].shape[1]
    label_ops = (OP_IN, OP_NOT_IN, OP_EXISTS, OP_NOT_EXISTS)

    def live(pre, r):
        """(matchLabels pairs, label-reading expressions) set in row r of
        a selector that is not invalid."""
        if h[pre + "_invalid"][r]:
            return 0, 0
        p_ = int((h[pre + "_ml"][r, :, 0] != -1).sum())
        e_ = int(np.isin(h[pre + "_expr"][r, :, 1], label_ops).sum())
        return p_, e_

    def sel_ops(p_, e_, width, vals):
        return 2 * p_ * width + e_ * (2 * width + vals)

    read = {"group_id", "kind_id"}
    ops = 0
    for r in range(u):
        g = h["kind_rows"][r, :, 0]
        k_live = int((((g != -1) & (g > -3)) | (g == WILDCARD)).sum())
        row = 6 * k_live + 16
        for has, ids in (("ns_has", "ns_ids"), ("excl_has", "excl_ids")):
            if h[has][r]:
                read |= {"ns_name_id", "kind_defined", "is_ns",
                         "has_namespace"}
                row += 2 * int((h[ids][r] != -1).sum())
        if h["scope"][r] in (SCOPE_NAMESPACED, SCOPE_CLUSTER):
            read.add("has_namespace")
        if h["nssel_has"][r]:
            read |= {"kind_defined", "is_ns", "has_namespace",
                     "nssel_defined", "nssel_empty"}
            p_, e_ = live("nssel", r)
            if p_ or e_:
                read |= {"nssel_labels", "obj_labels", "old_labels",
                         "obj_present", "old_present"}
                v_ = h["nssel_expr_vals"].shape[2]
                # the plain candidate, or the object/oldObject 4-case
                row += sel_ops(p_, e_, ml2, v_) + 2 * sel_ops(p_, e_, ml, v_)
        p_, e_ = live("lab", r)
        if p_ or e_:
            read |= {"obj_labels", "old_labels", "obj_present", "old_present"}
            row += 2 * sel_ops(p_, e_, ml, h["lab_expr_vals"].shape[2])
        ops += n * row
    b = _nbytes(*ms.values(), *(fb[k] for k in sorted(read))) + u * n
    return b, ops


def _bound(name, args, out):
    """-> (bound ms, "bytes" | "operations", bytes ms, operations ms).

    Bytes: what the function must move for this input — inputs read once,
    the output written once, data-dependent parts only as far as this
    run's data needs them — over the card's memory rate. Operations: the
    integer/boolean operations it does on this input (comparisons,
    selects, moves; counted per live element) over the card's peak rate
    outside the tensor cores. The bound is the larger of the two."""
    import torch
    from gatekeeper_tpu_torch.kernels import ops as ops_mod

    if name == "match_matrix":
        ms, fb = args
        b, ops = _match_needs(ms, fb, out.shape[1])
    elif name == "slab_gather":
        tab, ids = args[0], args[1]
        # base rows below v_base and overlay rows above it alike: each
        # distinct row of width T is read once
        rows = torch.unique(ids).numel()
        b = _nbytes(ids, out) + rows * tab.shape[1] * tab.element_size()
        ops = 3 * out.numel()  # clamp, select, move per element
    elif name == "egroup":
        idx0, idx1, mask, val, axis = args[:5]
        idx = {"g0": (idx0,), "g1": (idx1,), "g01": (idx0, idx1)}[axis]
        # the mask whole; ids and values only where a token is live
        n_live = int(mask.sum())
        b = _nbytes(mask, out) + n_live * (
            sum(t.element_size() for t in idx) + val.element_size()
        )
        ops = 2 * mask.numel() + 6 * n_live + 3 * out.numel()
    elif name == "flush_deltas":
        # each delta byte read once from the staging copy, written once
        delta = sum(
            int(d.shape[0]) * buf[0].numel() * buf.element_size()
            for buf, d in zip(args[0], args[2])
        )
        b = 2 * delta
        ops = 2 * delta // 16  # one 16-byte load and store per vector
    elif name == "full_totals":
        match, counts, crow, n_valid = args
        live = torch.unique(crow[(crow >= 0) & (crow < (
            0 if counts is None else counts.shape[0]))])
        # each match row whole (N bytes), the distinct counts rows that
        # some live constraint reads (4 bytes per valid column), crow and
        # the totals
        b = (match.numel() + int(live.numel()) * n_valid * 4
             + _nbytes(crow, out))
        # a compare, an and and an add per valid element of a live row
        ops = 3 * int(((crow >= 0) & (crow < (
            0 if counts is None else counts.shape[0]))).sum()) * n_valid
    elif name == "gather_elem":
        v, idx0, idx1, axis = args[:4]
        g0, g1 = args[4], args[5]
        idx, g = ops_mod.elem_index(idx0, idx1, axis, g0, g1)
        live = (idx >= 0) & (idx < g)
        rows = torch.arange(idx.shape[0], device=idx.device)[:, None] * g
        gathered = torch.unique((rows + idx)[live]).numel()
        b = (_nbytes(idx0, out) + (_nbytes(idx1) if axis == "g01" else 0)
             + gathered * v.element_size())
        ops = 4 * out.numel()  # index, bounds test, select, move
    else:
        match_u, spec_map, viol, compiled, row_fb, n_valid = args[:6]
        r_cap = args[6]
        matched = match_u[spec_map.long(), :n_valid]
        n_matched = int(matched.sum())
        b = (
            _nbytes(match_u, spec_map, compiled, row_fb, out)
            + n_matched  # viol bytes read where a pair matched
        )
        # need per pair, counts per matched pair, compaction per row,
        # one need bit per (constraint, hot row)
        ops = (2 * viol.numel() + 4 * n_matched + 4 * viol.shape[1]
               + 6 * viol.shape[0] * r_cap)
    bytes_ms = b / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / SCALAR_OPS_PER_S * 1e3
    if ops_ms > bytes_ms:
        return ops_ms, "operations", bytes_ms, ops_ms
    return bytes_ms, "bytes", bytes_ms, ops_ms


def _library_call(name, args):
    """PyTorch's own calls computing the same function, where they exist:
    -> (callable, label) or None."""
    import torch
    from gatekeeper_tpu_torch.kernels import ops

    if name == "flush_deltas":
        bufs, fills, deltas = args
        scratch = [b.clone() for b in bufs]
        dev = [torch.as_tensor(d).to(b.dtype).to(b.device)
               for b, d in zip(bufs, deltas)]

        def per_table():
            for buf, fill, d in zip(scratch, fills, dev):
                buf[fill:fill + d.shape[0]].copy_(d)

        return per_table, f"copy_ per table ({len(bufs)} calls)"
    if name == "gather_elem":
        v, idx0, idx1, axis, g0, g1, default = args
        idx, g = ops.elem_index(idx0, idx1, axis, g0, g1)
        safe = torch.clamp(idx, 0, g - 1).long()
        live = (idx >= 0) & (idx < g)
        return (
            lambda: torch.where(live, torch.gather(v, 1, safe), default),
            "torch.gather + torch.where (two calls; index untimed)",
        )
    if name == "full_totals":
        match, counts, crow, n_valid = args
        if counts is None:
            return None
        rows = torch.nonzero(crow >= 0).flatten()
        src = counts[crow[rows].long()]

        def composed():
            viol = torch.zeros(match.shape, dtype=torch.int32, device=match.device)
            viol.index_copy_(0, rows, src)
            return torch.sum((torch.where(match, viol, 0) > 0)[:, :n_valid], 1)

        return composed, ("torch composition, not one call: zeros + "
                          "index_copy_ + where + gt + sum (the gather of "
                          "counts untimed)")
    if name == "egroup":
        idx0, idx1, mask, val, axis, g0, g1, how, init = args
        idx, g = ops._egroup_index(idx0, idx1, axis, g0, g1)
        live = mask & (idx >= 0) & (idx < g)
        n = idx.shape[0]
        # every dead token lands in one spare slot past the last row
        flat = torch.where(
            live, torch.arange(n, device=idx.device)[:, None] * g + idx, n * g
        ).reshape(-1).long()
        if how == "any":
            src, reduce, fill = (val != 0).to(torch.int32), "amax", 0
        else:
            src = val.to(torch.float32 if val.dtype == torch.float32 else torch.int32)
            reduce, fill = ("amax", init) if how == "max" else ("sum", 0)
        buf = torch.full((n * g + 1,), fill, dtype=src.dtype, device=idx.device)
        src = src.reshape(-1)
        return (lambda: buf.scatter_reduce_(0, flat, src, reduce)), (
            f"scatter_reduce_ ({reduce}) over the flat row*G+idx index (one "
            "call; index, values and output buffer prepared untimed)")
    if name == "slab_gather":
        tab, ids = args[0], args[1]
        ov = args[2] if len(args) > 2 else None
        if ov is None and int(ids.min()) >= 0 and int(ids.max()) < tab.shape[0]:
            flat = ids.reshape(-1).long()
            return lambda: torch.index_select(tab, 0, flat), "index_select"
    return None


def _profiled(fn):
    """Run fn under the CUDA-activity profiler: -> (result, wall seconds,
    device-busy seconds or None when the profiler saw no device time,
    top kernels by device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _window_head()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [
        (e.key, _device_time_us(e), e.count)
        for e in prof.key_averages() if _kernel_name(e) != HEAD_KERNEL
    ]
    busy = sum(r[1] for r in rows) / 1e6
    top = sorted(rows, key=lambda r: -r[1])[:6]
    return out, wall, (busy if busy > 0 else None), [
        {"kernel": k[:60], "device_ms": us / 1e3, "count": n} for k, us, n in top
    ]


def phase_profile(client, drv):
    """Device-busy time against wall time for a second (warm-corpus)
    audit sweep and one more review batch, after the counted run."""
    _, wall_a, busy_a, top_a = _profiled(client.audit)
    audit_phases = dict(drv.stats["phase_seconds"])
    objs = review_batch(99, 256)
    _, wall_b, busy_b, top_b = _profiled(lambda: client.review_many(objs))
    print(json.dumps({
        "phase": "profile",
        "audit_warm": {"wall_s": wall_a, "device_busy_s": busy_a,
                       "phase_seconds": audit_phases, "top": top_a},
        "review_batch": {"wall_s": wall_b, "device_busy_s": busy_b,
                         "phase_seconds": drv.stats["phase_seconds"],
                         "top": top_b},
    }), flush=True)


# -- the native flattener and the admission webhook ---------------------------

TOKEN_FIELDS = ("spath", "idx0", "idx1", "kind", "vid", "vnum", "n_tokens",
                "overflow")


def _gk_reviews(objs):
    """The review dicts TorchDriver encodes (the K8s target's gkReview of
    each object), as the driver's encode phase receives them."""
    from gatekeeper_tpu_torch.constraint import (
        AugmentedUnstructured, K8sValidationTarget,
    )

    handler = K8sValidationTarget()
    return [
        handler.handle_review(
            o if isinstance(o, AugmentedUnstructured) else AugmentedUnstructured(o)
        )[1]
        for o in objs
    ]


def _same_encoding(what, objs, v_c, v_py):
    """Encode objs natively into v_c and in Python into v_py: the token
    tables and the vocab contents and order must be equal."""
    import numpy as np
    from gatekeeper_tpu_torch.flatten.encoder import encode_token_table

    got = encode_token_table(objs, v_c)
    want = encode_token_table(objs, v_py, native=False)
    for f in TOKEN_FIELDS:
        if not np.array_equal(getattr(got, f), getattr(want, f)):
            raise AssertionError(f"native: {what}: {f} differs from Python")
    if (v_c._strs != v_py._strs or v_c._ids != v_py._ids
            or v_c._quantity != v_py._quantity):
        raise AssertionError(f"native: {what}: vocab differs from Python")


def phase_native(n_check: int = 2000, n_corpus: int = 100_000,
                 batch: int = 256):
    """The C token flattener against the Python encoder: equal token
    tables and vocab on n_check pods, n_check make_mixed objects and one
    review batch of `batch` against an OverlayVocab over the n_corpus-pod
    corpus's vocab; the encode seconds of both on that corpus."""
    from gatekeeper_tpu_torch.flatten.encoder import encode_token_table
    from gatekeeper_tpu_torch.flatten.vocab import OverlayVocab, Vocab

    t0 = time.perf_counter()
    _same_encoding("pods", _gk_reviews(make_pod(i) for i in range(n_check)),
                   Vocab(), Vocab())
    _same_encoding("mixed", _gk_reviews(make_mixed(i) for i in range(n_check)),
                   Vocab(), Vocab())
    corpus = _gk_reviews(make_pod(i) for i in range(n_corpus))
    seconds = {}
    vocabs = {}
    for enc in ("python", "native"):
        vocabs[enc] = Vocab()
        t1 = time.perf_counter()
        encode_token_table(corpus, vocabs[enc], native=(enc == "native"))
        seconds[enc] = time.perf_counter() - t1
    if vocabs["native"]._strs != vocabs["python"]._strs:
        raise AssertionError("native: corpus vocab differs from Python")
    ov_c, ov_py = OverlayVocab(vocabs["native"]), OverlayVocab(vocabs["python"])
    _same_encoding("overlay batch", _gk_reviews(review_batch(7, batch)),
                   ov_c, ov_py)
    if not ov_c._strs:
        raise AssertionError("native: the overlay batch interned nothing")
    print(json.dumps({
        "phase": "native",
        "checked": {"pods": n_check, "mixed": n_check, "overlay_batch": batch},
        "overlay_strings": len(ov_c._strs),
        "corpus_pods": n_corpus, "corpus_vocab": len(vocabs["native"]),
        "token_table_seconds": seconds,
        "speedup": seconds["python"] / seconds["native"],
        "seconds": time.perf_counter() - t0,
    }), flush=True)


def admission_request(obj, uid, operation="CREATE", username="smoke-user",
                      old_object=None):
    """An AdmissionRequest for `obj` (for a DELETE, for `old_object`)."""
    src = obj if obj is not None else old_object
    group, _, version = src.get("apiVersion", "v1").rpartition("/")
    meta = src.get("metadata") or {}
    req = {
        "uid": uid,
        "kind": {"group": group, "version": version, "kind": src["kind"]},
        "operation": operation,
        "name": meta.get("name", ""),
        "namespace": meta.get("namespace", ""),
        "userInfo": {"username": username},
        "object": obj,
    }
    if old_object is not None:
        req["oldObject"] = old_object
    return req


def _envelope(req) -> bytes:
    return json.dumps({"apiVersion": "admission.k8s.io/v1",
                       "kind": "AdmissionReview", "request": req}).encode()


def _drive_http(port: int, posts, threads: int, timeout: float = 300.0,
                ssl_ctx=None):
    """POST each (path, body) of `posts` from `threads` threads, each over
    one keep-alive connection (HTTPS with `ssl_ctx`), all started together.
    -> (response bodies in order, latency seconds in order, wall seconds)."""
    import http.client
    import threading

    bodies = [None] * len(posts)
    lat = [0.0] * len(posts)
    errors = []
    start = threading.Barrier(threads + 1)

    def worker(k):
        if ssl_ctx is not None:
            conn = http.client.HTTPSConnection(
                "127.0.0.1", port, timeout=timeout, context=ssl_ctx)
        else:
            conn = http.client.HTTPConnection(
                "127.0.0.1", port, timeout=timeout)
        try:
            start.wait()
            for i in range(k, len(posts), threads):
                path, body = posts[i]
                t = time.perf_counter()
                conn.request("POST", path, body,
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                data = resp.read()
                lat[i] = time.perf_counter() - t
                if resp.status != 200:
                    raise AssertionError(
                        f"HTTP {resp.status} for request {i}: {data[:300]!r}")
                bodies[i] = json.loads(data)
        except Exception as e:  # reported below, after every thread ends
            errors.append(e)
        finally:
            conn.close()

    workers = [threading.Thread(target=worker, args=(k,), daemon=True)
               for k in range(threads)]
    for w in workers:
        w.start()
    start.wait()
    t0 = time.perf_counter()
    for w in workers:
        w.join(timeout)
    wall = time.perf_counter() - t0
    if any(w.is_alive() for w in workers):
        raise AssertionError(f"HTTP load: a client thread outlived {timeout} s")
    if errors:
        raise AssertionError(
            f"HTTP load: {len(errors)} client errors, first: {errors[0]!r}")
    return bodies, lat, wall


def _quantile(xs, q):
    s = sorted(xs)
    return s[min(len(s) - 1, int(round(q * (len(s) - 1))))]


def _response_fields(body):
    r = body["response"]
    status = r.get("status") or {}
    return (r.get("allowed"), status.get("code"), status.get("message"),
            r.get("warnings"))


def _fused_failure(client, requests):
    """The fused path's own exception for requests the webhook answered on
    the host rung: client.review_many on them, called directly."""
    import traceback

    from gatekeeper_tpu_torch.constraint import K8sValidationTarget

    handler = K8sValidationTarget()
    reviews = [handler.augment_request(r) for r in requests[:256]]
    try:
        client.review_many(reviews)
    except Exception:
        return traceback.format_exc()
    return "client.review_many on these requests raised nothing"


def _check_served(what, server, metrics, client, requests):
    """Every batch of `server` took the fused (`batched`) route: none
    failed, none was degraded, the breaker is closed. Otherwise print the
    fused path's own exception and fail."""
    from gatekeeper_tpu_torch.faults import CLOSED

    b = server.batcher
    degraded = sum(v for k, v in metrics.snapshot()["counters"].items()
                   if k.startswith("webhook_degraded_dispatch_total"))
    if b.batch_failures or degraded or b.breaker.state != CLOSED:
        print(_fused_failure(client, requests), file=sys.stderr, flush=True)
        raise AssertionError(
            f"{what}: {b.batch_failures} failed and {degraded} degraded "
            f"batches, breaker {b.breaker.state}")


def _parity_posts(n: int, excluded: str):
    """Admission traffic for webhook_parity: new pods (violating and
    compliant), pods in an excluded namespace, DELETEs with an oldObject,
    Gatekeeper's service account, namespace-label requests."""
    from gatekeeper_tpu_torch.webhook import IGNORE_LABEL
    from gatekeeper_tpu_torch.webhook.policy import SERVICE_ACCOUNT

    violators = (499, 503, 509, 521, 541)
    posts = []
    for j in range(n):
        uid = f"par-{j}"
        if j % 32 == 5:
            ns = {"apiVersion": "v1", "kind": "Namespace",
                  "metadata": {"name": ("kube-system", f"lbl{j}")[j % 2],
                               "labels": {IGNORE_LABEL: "1"}}}
            posts.append(("/v1/admitlabel",
                          _envelope(admission_request(ns, uid))))
            continue
        i = 2_000_000 + j if j % 3 else violators[j % 5] * (j + 1)
        obj = make_pod(i, name=f"par-{j}")
        if j % 32 == 9:
            obj["metadata"]["namespace"] = excluded
        if j % 32 == 13:
            req = admission_request(None, uid, operation="DELETE",
                                    old_object=obj)
        elif j % 64 == 17:
            req = admission_request(obj, uid, username=SERVICE_ACCOUNT)
        else:
            req = admission_request(obj, uid)
        posts.append(("/v1/admit", _envelope(req)))
    return posts


def phase_webhook_parity(port, ref, drv, n: int = 512, threads: int = 64):
    """Two WebhookServers on 127.0.0.1 over the parity clients, one over
    TorchDriver, one over the interpreter driver, with a dryrun and a
    warn constraint added to both: n AdmissionReviews from `threads`
    threads over HTTP must get equal response bodies by uid, and every
    batch of both must take the fused (`batched`) route. -> (the kernel
    launches of the TorchDriver server's run, its response fields by
    uid)."""
    from gatekeeper_tpu_torch.control import Excluder
    from gatekeeper_tpu_torch.kernels import ops
    from gatekeeper_tpu_torch.metrics import MetricsRegistry
    from gatekeeper_tpu_torch.webhook import WebhookServer

    t0 = time.perf_counter()
    pod_match = {"kinds": [{"apiGroups": [""], "kinds": ["Pod"]}]}
    extra = [
        {"apiVersion": "constraints.gatekeeper.sh/v1beta1",
         "kind": "GTNoLatestTag", "metadata": {"name": "latest-dryrun"},
         "spec": {"enforcementAction": "dryrun", "match": pod_match}},
        {"apiVersion": "constraints.gatekeeper.sh/v1beta1",
         "kind": "K8sRequiredLabels", "metadata": {"name": "tier-warn"},
         "spec": {"enforcementAction": "warn", "match": pod_match,
                  "parameters": {"labels": [{"key": "tier"}]}}},
    ]
    for c in (port, ref):
        for doc in extra:
            c.add_constraint(doc)
    posts = _parity_posts(n, excluded="ns7")
    requests = [json.loads(b)["request"] for _, b in posts]
    out = {}
    launches = {}
    for name, client in (("torch", port), ("interp", ref)):
        excluder = Excluder()
        excluder.add([{"processes": ["webhook"], "excludedNamespaces": ["ns7"]}])
        metrics = MetricsRegistry()
        server = WebhookServer(client, TARGET, window_ms=2.0, metrics=metrics,
                               excluder=excluder,
                               exempt_namespaces=["kube-system"])
        server.start()
        try:
            ops.reset_launches()
            bodies, lat, wall = _drive_http(server.port, posts, threads)
            launches[name] = dict(ops.LAUNCHES)
        finally:
            server.stop()
        _check_served(f"webhook_parity ({name})", server, metrics, client,
                      requests)
        out[name] = {
            "by_uid": {b["response"]["uid"]: _response_fields(b) for b in bodies},
            "batches": server.batcher.batches_dispatched,
            "requests_batched": server.batcher.requests_batched,
            "wall_s": wall, "p50_s": _quantile(lat, 0.5),
            "p99_s": _quantile(lat, 0.99),
        }
    got, want = out["torch"]["by_uid"], out["interp"]["by_uid"]
    if len(got) != len(posts) or got != want:
        bad = sorted(u for u in want if got.get(u) != want[u])[:5]
        raise AssertionError(f"webhook_parity: bodies differ for {bad}")
    if drv.device.type == "cuda":
        missing = [k for k in PATH_KERNELS["webhook_parity"]
                   if launches["torch"][k] <= 0]
        if missing:
            raise AssertionError(
                f"webhook_parity: kernels never launched: {missing}")
    codes = {}
    for _, code, _, _ in got.values():
        codes[str(code or 200)] = codes.get(str(code or 200), 0) + 1
    print(json.dumps({
        "phase": "webhook_parity", "requests": len(posts), "threads": threads,
        "codes": codes, "launches": launches["torch"],
        **{name: {k: v for k, v in o.items() if k != "by_uid"}
           for name, o in out.items()},
        "seconds": time.perf_counter() - t0,
    }), flush=True)
    return launches["torch"], got


def webhook_posts(seed: int, n: int):
    """n AdmissionReviews of new pods from the review_batch generator
    (strings the corpus never interned), with unique uids.
    -> (posts, requests)."""
    posts, requests = [], []
    for b in range(0, n, 256):
        for j, aug in enumerate(review_batch(1000 * seed + b // 256,
                                             min(256, n - b))):
            req = admission_request(aug.object, f"wh-{seed}-{b + j}")
            requests.append(req)
            posts.append(("/v1/admit", _envelope(req)))
    return posts, requests


def _expected_response(oracle, request):
    """What the webhook must answer for `request`: the deny results of the
    interpreter (`oracle`, from _oracle), as ValidationHandler renders
    them."""
    from gatekeeper_tpu_torch.constraint import K8sValidationTarget

    review = K8sValidationTarget().augment_request(request)
    return _response_of(oracle.review_host(review).by_target[TARGET].results)


def _oracle(client):
    """An interpreter client (RegoDriver) with `client`'s templates and
    constraints and no synced objects. It answers as client.review_host
    for a policy that reads no inventory, which this one checks (no
    template's analyzer report has an inventory ref, GK-V006, or a
    dynamic one, GK-V004), and keeps client.review_host from freezing the
    serving driver's whole inventory (100,000 pods) in the serving
    process."""
    from gatekeeper_tpu_torch.agentaction import AgentActionTarget
    from gatekeeper_tpu_torch.constraint import (
        Backend,
        K8sValidationTarget,
        RegoDriver,
    )

    oracle = Backend(RegoDriver()).new_client(K8sValidationTarget(),
                                              AgentActionTarget())
    with client._lock:
        templates = [e.template for e in client._templates.values()]
        constraints = [c for by_name in client._constraints.values()
                       for c in by_name.values()]
    for t in templates:
        if {"GK-V006", "GK-V004"} & set(t.vectorizability.codes):
            raise AssertionError(
                f"oracle: template {t.kind} may read the inventory")
        oracle.add_template(t)
    for c in constraints:
        oracle.add_constraint(c)
    return oracle


def _response_of(results):
    """The webhook's response fields for a result list."""
    msgs = [f"[denied by {r.constraint['metadata']['name']}] {r.msg}"
            for r in results if r.enforcement_action == "deny"]
    if msgs:
        return (False, 403, "\n".join(msgs), None)
    return (True, None, None, None)


def phase_webhook(client, drv, loads=((4096, 256), (1024, 16)),
                  n_sample: int = 64):
    """The full phase's client (100,000 pods x 500 constraints) behind
    WebhookServer(window_ms=2.0): for each (requests, threads) of `loads`,
    new pods POSTed over keep-alive connections; request latency
    p50/p99/max, requests per second, batches and their mean occupancy,
    and the driver's phase seconds summed over the batches. Every batch
    must take the fused (`batched`) route, K1-K4 must launch, and
    n_sample responses must equal the interpreter's answer
    (_oracle). -> the kernel launches of the phase."""
    from gatekeeper_tpu_torch.kernels import ops
    from gatekeeper_tpu_torch.metrics import MetricsRegistry
    from gatekeeper_tpu_torch.webhook import WebhookServer

    t0 = time.perf_counter()
    phases = {}
    review_many = client.review_many

    def summed(*a, **kw):  # the batcher's one worker thread calls this
        out = review_many(*a, **kw)
        for k, v in drv.stats.get("phase_seconds", {}).items():
            phases[k] = phases.get(k, 0.0) + v
        return out

    metrics = MetricsRegistry()
    server = WebhookServer(client, TARGET, window_ms=2.0, metrics=metrics)
    client.review_many = summed
    server.start()
    rows, sample = [], []
    try:
        ops.reset_launches()
        for seed, (n, threads) in enumerate(loads):
            posts, requests = webhook_posts(seed, n)
            b0 = server.batcher.batches_dispatched
            r0 = server.batcher.requests_batched
            l0 = dict(ops.LAUNCHES)
            phases.clear()
            bodies, lat, wall = _drive_http(server.port, posts, threads)
            batches = server.batcher.batches_dispatched - b0
            served = server.batcher.requests_batched - r0
            if served != n:
                raise AssertionError(
                    f"webhook: {served} of {n} requests took the batched route")
            rows.append({
                "requests": n, "threads": threads, "wall_s": wall,
                "rps": n / wall, "p50_s": _quantile(lat, 0.5),
                "p99_s": _quantile(lat, 0.99), "max_s": max(lat),
                "batches": batches, "mean_occupancy": served / batches,
                "denied": sum(not b["response"]["allowed"] for b in bodies),
                "phase_seconds": dict(phases),
                "launches": {k: v - l0[k] for k, v in ops.LAUNCHES.items()},
            })
            step = max(1, n * len(loads) // n_sample)
            sample += [(requests[i], bodies[i]) for i in range(0, n, step)]
        launches = dict(ops.LAUNCHES)
    finally:
        server.stop()
        del client.review_many
    _check_served("webhook", server, metrics, client, [r for r, _ in sample])
    if drv.device.type == "cuda":
        missing = [k for k in PATH_KERNELS["webhook"] if launches[k] <= 0]
        if missing:
            raise AssertionError(f"webhook: kernels never launched: {missing}")
    t1 = time.perf_counter()
    oracle = _oracle(client)
    for req, body in sample[:n_sample]:
        if _response_fields(body) != _expected_response(oracle, req):
            raise AssertionError(
                f"webhook: response to {req['uid']} differs from the interpreter")
    print(json.dumps({
        "phase": "webhook", "loads": rows, "launches": launches,
        "sample_checked": min(len(sample), n_sample),
        "sample_seconds": time.perf_counter() - t1,
        "breaker": server.batcher.breaker.state,
        "seconds": time.perf_counter() - t0,
    }), flush=True)
    return launches


def _socket_path(name: str) -> str:
    """A Unix socket path for the native front's backend, under the build
    directory (inside the checkout); relative to the working directory
    when the absolute path would pass the 108-byte sun_path limit."""
    from gatekeeper_tpu_torch.native import NATIVE_DIR

    NATIVE_DIR.mkdir(parents=True, exist_ok=True)
    path = str(NATIVE_DIR / f"{name}-{os.getpid()}.sock")
    return path if len(path) < 100 else os.path.relpath(path)


def _drive_framed(port: int, frames, callers: int, conns: int,
                  timeout: float = 300.0):
    """Send each (plane, body, budget_ms) of `frames` from `callers`
    threads over `conns` StreamClient connections (caller k uses
    connection k % conns), all started together.
    -> (response bodies in order, latency seconds in order, wall seconds)."""
    import threading

    from gatekeeper_tpu_torch.ingest import StreamClient

    clients = [StreamClient("127.0.0.1", port) for _ in range(conns)]
    bodies = [None] * len(frames)
    lat = [0.0] * len(frames)
    errors = []
    start = threading.Barrier(callers + 1)

    def worker(k):
        c = clients[k % conns]
        try:
            start.wait()
            for i in range(k, len(frames), callers):
                plane, body, budget_ms = frames[i]
                t = time.perf_counter()
                status, data = c.request(body, plane, budget_ms=budget_ms,
                                         timeout=timeout)
                lat[i] = time.perf_counter() - t
                if status != 200:
                    raise AssertionError(
                        f"frame status {status} for request {i}: "
                        f"{data[:300]!r}")
                bodies[i] = json.loads(data)
        except Exception as e:  # reported below, after every thread ends
            errors.append(e)

    workers = [threading.Thread(target=worker, args=(k,), daemon=True)
               for k in range(callers)]
    try:
        for w in workers:
            w.start()
        start.wait()
        t0 = time.perf_counter()
        for w in workers:
            w.join(timeout)
        wall = time.perf_counter() - t0
    finally:
        for c in clients:
            c.close()
    if any(w.is_alive() for w in workers):
        raise AssertionError(f"framed load: a caller outlived {timeout} s")
    if errors:
        raise AssertionError(
            f"framed load: {len(errors)} caller errors, first: {errors[0]!r}")
    return bodies, lat, wall


def _dup_key_posts(n: int):
    """n AdmissionReviews whose request repeats its uid key: the zero-copy
    scanner declines duplicate keys, so each takes the decode fallback."""
    posts = []
    for j in range(n):
        uid = f"dup-{j}"
        body = _envelope(admission_request(
            make_pod(3_000_000 + j, name=uid), uid))
        key = json.dumps(uid).encode()
        body = body.replace(b'"uid": ' + key,
                            b'"uid": ' + key + b', "uid": ' + key, 1)
        posts.append(("/v1/admit", body))
    return posts


def _framed(posts, budgets):
    from gatekeeper_tpu_torch.ingest import PLANE_LABEL, PLANE_VALIDATE

    planes = {"/v1/admit": PLANE_VALIDATE, "/v1/admitlabel": PLANE_LABEL}
    return [(planes[path], body, budget)
            for (path, body), budget in zip(posts, budgets)]


def _shed_uids(bodies):
    """uids answered with the fail-policy envelope of a request the
    admission scheduler shed (the reasons of policy.SHED_REASONS)."""
    from gatekeeper_tpu_torch.webhook.policy import SHED_REASONS

    heads = tuple(f"admission evaluation unavailable ({r})"
                  for r in SHED_REASONS)
    return {b["response"]["uid"] for b in bodies
            if ((b["response"].get("status") or {}).get("message")
                or "").startswith(heads)}


def _fail_open(body) -> bool:
    """The native front's own answer: its backend missed --deadline-ms."""
    return any("failing open" in w
               for w in body["response"].get("warnings") or ())


def phase_ingest_parity(port, ref, drv, fifo_fields, n: int = 512,
                        conns: int = 8, callers: int = 64):
    """The parity clients behind WebhookServer(ingest=True,
    sched_policy="deadline") with a DecisionLog and an SloEngine, one over
    TorchDriver, one over the interpreter driver: webhook_parity's 512
    AdmissionReviews as framed requests with FLAG_DEADLINE budgets over
    `conns` StreamClient connections from `callers` threads, plus 16 bodies
    with duplicate keys (the decode fallback). Bodies must be equal by uid
    across the two drivers, and on TorchDriver equal to the same requests
    over HTTP to the same server and, field by field, to webhook_parity's
    fifo run; every TorchDriver batch takes the fused route and K1-K4
    launch. A request the scheduler sheds (its estimate of the card's
    load is the SloEngine's, which may call the plane overloaded) is
    answered with the fail-policy envelope: such uids, as many as the
    batcher counted shed, are left out of the comparisons and reported.
    -> (the framed run's kernel launches, the interpreter's bodies by
    uid)."""
    from gatekeeper_tpu_torch.control import Excluder
    from gatekeeper_tpu_torch.kernels import ops
    from gatekeeper_tpu_torch.metrics import MetricsRegistry
    from gatekeeper_tpu_torch.obs import DecisionLog, SloEngine, Tracer
    from gatekeeper_tpu_torch.webhook import WebhookServer

    t0 = time.perf_counter()
    posts = _parity_posts(n, excluded="ns7") + _dup_key_posts(16)
    requests = [json.loads(b)["request"] for _, b in posts]
    # budgets of 10-17 s, so EDF reorders; none is near a miss
    frames = _framed(posts, [10_000 + 1000 * (j % 8)
                             for j in range(len(posts))])
    n_label = sum(p == "/v1/admitlabel" for p, _ in posts)
    out, launches, by_uid, shed = {}, {}, {}, set()
    for name, client in (("torch", port), ("interp", ref)):
        excluder = Excluder()
        excluder.add([{"processes": ["webhook"], "excludedNamespaces": ["ns7"]}])
        metrics = MetricsRegistry()
        slo = SloEngine(metrics=metrics)
        server = WebhookServer(
            client, TARGET, window_ms=2.0, metrics=metrics, excluder=excluder,
            exempt_namespaces=["kube-system"], tracer=Tracer(),
            ingest=True, sched_policy="deadline", slo=slo,
            decision_log=DecisionLog(metrics=metrics, slo=slo),
        )
        server.start()
        try:
            ops.reset_launches()
            bodies, lat, wall = _drive_framed(server.ingest.port, frames,
                                              callers, conns)
            launches[name] = dict(ops.LAUNCHES)
            decode = server.ingest.stats()["decode"]
            http_bodies = None
            if name == "torch":
                http_bodies, _, _ = _drive_http(server.port, posts, callers)
        finally:
            server.stop()
        _check_served(f"ingest_parity ({name})", server, metrics, client,
                      requests)
        want_decode = {"zerocopy": len(posts) - n_label - 16,
                       "fallback": 16, "legacy": n_label}
        if {k: decode[k] for k in want_decode} != want_decode:
            raise AssertionError(
                f"ingest_parity ({name}): decode routes {decode}, "
                f"want {want_decode}")
        by_uid[name] = {b["response"]["uid"]: b for b in bodies}
        shed_here = _shed_uids(bodies)
        n_shed = len(shed_here)
        if http_bodies is not None:
            http_shed = _shed_uids(http_bodies)
            n_shed += len(http_shed)
            shed_here |= http_shed
            kept = {b["response"]["uid"]: b for b in http_bodies
                    if b["response"]["uid"] not in shed_here}
            if kept != {u: b for u, b in by_uid[name].items()
                        if u not in shed_here}:
                raise AssertionError(
                    "ingest_parity: framed and HTTP bodies differ")
        if n_shed != server.batcher.shed_count:
            raise AssertionError(
                f"ingest_parity ({name}): {n_shed} shed answers, the "
                f"batcher shed {server.batcher.shed_count}")
        shed |= shed_here
        snap = server.sched_snapshot()["validation"]
        out[name] = {
            "shed": n_shed,
            "batches": server.batcher.batches_dispatched,
            "requests_batched": server.batcher.requests_batched,
            "driver_route": server.batcher._driver_route(),
            "wall_s": wall, "p50_s": _quantile(lat, 0.5),
            "p99_s": _quantile(lat, 0.99), "decode": decode,
            "sched": {k: snap[k] for k in ("policy", "cuts", "admitted",
                                           "sheds", "cost_per_row_s")},
            "autoscaler": slo.autoscaler(),
        }
    if out["torch"]["driver_route"] != "fused":
        raise AssertionError("ingest_parity: TorchDriver batches not fused")
    if len(by_uid["torch"]) != len(posts):
        raise AssertionError("ingest_parity: responses missing")
    got, want = ({u: b for u, b in by_uid[k].items() if u not in shed}
                 for k in ("torch", "interp"))
    if got != want:
        bad = sorted(u for u in want if got.get(u) != want[u])[:5]
        raise AssertionError(f"ingest_parity: bodies differ for {bad}")
    fifo = {u: _response_fields(b) for u, b in got.items() if u in fifo_fields}
    if fifo != {u: f for u, f in fifo_fields.items() if u not in shed}:
        raise AssertionError(
            "ingest_parity: deadline-policy verdicts differ from the fifo run")
    if drv.device.type == "cuda":
        missing = [k for k in PATH_KERNELS["ingest_parity"]
                   if launches["torch"][k] <= 0]
        if missing:
            raise AssertionError(
                f"ingest_parity: kernels never launched: {missing}")
    print(json.dumps({
        "phase": "ingest_parity", "requests": len(posts), "callers": callers,
        "connections": conns, "launches": launches["torch"], **out,
        "seconds": time.perf_counter() - t0,
    }), flush=True)
    return launches["torch"], by_uid["interp"]


def phase_bridge_parity(port, drv, interp_bodies, n: int = 512,
                        threads: int = 64):
    """A BridgeStack over the TorchDriver parity client: webhook_parity's
    512 AdmissionReviews over HTTP to the C++ front (deadline_ms 10,000)
    from `threads` threads. Bodies must equal the interpreter's by uid
    (the bridge's envelope carries no traceId), no answer may be the
    front's fail-open, every batch takes the fused route and K1-K4
    launch. -> the kernel launches of the run."""
    from gatekeeper_tpu_torch.control import Excluder
    from gatekeeper_tpu_torch.kernels import ops
    from gatekeeper_tpu_torch.metrics import MetricsRegistry
    from gatekeeper_tpu_torch.webhook.bridge import BridgeStack

    t0 = time.perf_counter()
    posts = _parity_posts(n, excluded="ns7")
    requests = [json.loads(b)["request"] for _, b in posts]
    excluder = Excluder()
    excluder.add([{"processes": ["webhook"], "excludedNamespaces": ["ns7"]}])
    metrics = MetricsRegistry()
    stack = BridgeStack(port, TARGET, _socket_path("bridge-parity"),
                        deadline_ms=10_000, window_ms=2.0, metrics=metrics,
                        excluder=excluder, exempt_namespaces=["kube-system"])
    stack.start()
    try:
        ops.reset_launches()
        bodies, lat, wall = _drive_http(stack.port, posts, threads)
        launches = dict(ops.LAUNCHES)
    finally:
        stack.stop()
    _check_served("bridge_parity", stack, metrics, port, requests)
    fail_open = sum(_fail_open(b) for b in bodies)
    if fail_open:
        raise AssertionError(f"bridge_parity: {fail_open} fail-open answers")
    got = {b["response"]["uid"]: b for b in bodies}
    if len(got) != len(posts):
        raise AssertionError("bridge_parity: responses missing")
    shed = _shed_uids(interp_bodies.values())  # ingest_parity's, if any
    got = {u: b for u, b in got.items() if u not in shed}
    want = {u: {k: v for k, v in b.items() if k != "traceId"}
            for u, b in interp_bodies.items() if u in got}
    if got != want:
        bad = sorted(u for u in want if got.get(u) != want[u])[:5]
        raise AssertionError(f"bridge_parity: bodies differ for {bad}")
    if drv.device.type == "cuda":
        missing = [k for k in PATH_KERNELS["bridge_parity"]
                   if launches[k] <= 0]
        if missing:
            raise AssertionError(
                f"bridge_parity: kernels never launched: {missing}")
    print(json.dumps({
        "phase": "bridge_parity", "requests": len(posts), "threads": threads,
        "launches": launches, "batches": stack.batcher.batches_dispatched,
        "requests_batched": stack.batcher.requests_batched,
        "served_by_backend": stack.backend.requests_served,
        "wall_s": wall, "p50_s": _quantile(lat, 0.5),
        "p99_s": _quantile(lat, 0.99), "fail_open": fail_open,
        "seconds": time.perf_counter() - t0,
    }), flush=True)
    return launches


def phase_ingest(client, drv, framed=((4096, 256, 16), (1024, 16, 16)),
                 bridged=((4096, 256, 10_000), (1024, 256, 2_000)),
                 n_sample: int = 64):
    """The full phase's client (100,000 pods x 500 constraints) served as
    in the webhook phase (window_ms=2.0) under sched_policy="deadline",
    with a DecisionLog, an SloEngine and a Tracer (the decision facts feed
    the SLO's cost EWMA through the traced requests). Loads: for each
    (requests, callers, connections) of `framed`, new pods as framed
    requests with 10,000 ms FLAG_DEADLINE budgets to WebhookServer
    (ingest=True); then for each (requests, clients, deadline_ms) of
    `bridged`, new pods over HTTP keep-alive to the C++ front of a
    BridgeStack with that deadline (the last, at the reference's 2,000 ms
    default, only counts its fail-open answers). Per load: request
    p50/p99/max, requests per second, batches and their mean occupancy,
    the driver's phase seconds summed over the batches with encode split
    by encoder (Python for batches holding zero-copy objects, C
    otherwise), sheds by reason, the scheduler's predicted batch seconds
    against the measured ones, and SloEngine.autoscaler(). Fails on a
    failed or off-route batch, a fail-open answer at 10,000 ms, a decode
    fallback, an open breaker, K1-K4 not launched, or one of n_sample
    responses that differs from the interpreter's (_oracle). -> the kernel
    launches of the phase."""
    from gatekeeper_tpu_torch.flatten.encoder import _carries_preflat
    from gatekeeper_tpu_torch.kernels import ops
    from gatekeeper_tpu_torch.metrics import MetricsRegistry
    from gatekeeper_tpu_torch.obs import DecisionLog, SloEngine, Tracer
    from gatekeeper_tpu_torch.webhook import WebhookServer
    from gatekeeper_tpu_torch.webhook.bridge import BridgeStack

    t0 = time.perf_counter()
    acc = {"phases": {}, "walls": [], "preds": []}
    review_many = client.review_many

    def measured(reviews, *a, **kw):  # called on one batcher thread at a time
        t = time.perf_counter()
        out = review_many(reviews, *a, **kw)
        acc["walls"].append((len(reviews), time.perf_counter() - t))
        lazy = any(_carries_preflat(r.admission_request.get(k))
                   for r in reviews for k in ("object", "oldObject"))
        route = "python" if lazy else "native"
        for k, v in drv.stats.get("phase_seconds", {}).items():
            k = f"encode_{route}" if k == "encode" else k
            acc["phases"][k] = acc["phases"].get(k, 0.0) + v
        return out

    def record_cuts(sched):
        cut = sched.cut

        def recorded(pending, max_batch, now=None):
            batch, rest = cut(pending, max_batch, now=now)
            if batch:
                acc["preds"].append(
                    (len(batch), sched.last_cut["predicted_seconds"]))
            return batch, rest

        sched.cut = recorded

    metrics = MetricsRegistry()
    slo = SloEngine(metrics=metrics)
    dlog = DecisionLog(metrics=metrics, slo=slo)
    tracer = Tracer()
    rows, sample, fallbacks = [], [], 0
    # n_sample responses, spread over the loads that must all be answered
    per_load = -(-n_sample // (len(framed) + sum(
        d >= 10_000 for _, _, d in bridged)))
    client.review_many = measured

    def run_load(kind, batcher, drive, n, seed, backend=None,
                 fail_open_ok=False):
        posts, requests = webhook_posts(100 + seed, n)
        for k in acc:
            acc[k] = {} if k == "phases" else []
        b0, r0, s0 = (batcher.batches_dispatched, batcher.requests_batched,
                      batcher.shed_count)
        served0 = backend.requests_served if backend is not None else 0
        l0 = dict(ops.LAUNCHES)
        bodies, lat, wall = drive(posts)
        if backend is not None:
            # every request the front answered early still reaches the
            # backend: wait for it, so the counts below are whole
            t_end = time.perf_counter() + 300
            while (backend.requests_served - served0 < n
                   and time.perf_counter() < t_end):
                time.sleep(0.05)
        batches = batcher.batches_dispatched - b0
        served = batcher.requests_batched - r0
        shed = batcher.shed_count - s0
        fail_open = sum(_fail_open(b) for b in bodies)
        if fail_open and not fail_open_ok:
            raise AssertionError(f"ingest: {fail_open} fail-open answers "
                                 f"from the front ({kind} load of {n})")
        if served + shed != n:
            raise AssertionError(
                f"ingest: {served} served and {shed} shed of {n} requests")
        walls = [w for _, w in acc["walls"]]
        preds = [p for _, p in acc["preds"]]
        rows.append({
            "load": kind, "requests": n, "wall_s": wall, "rps": n / wall,
            "p50_s": _quantile(lat, 0.5), "p99_s": _quantile(lat, 0.99),
            "max_s": max(lat), "batches": batches,
            "mean_occupancy": served / batches if batches else 0.0,
            "shed": shed, "fail_open": fail_open,
            "phase_seconds": dict(acc["phases"]),
            "predicted_batch_s": {"sum": sum(preds), "count": len(preds),
                                  "mean": sum(preds) / max(len(preds), 1)},
            "measured_batch_s": {"sum": sum(walls), "count": len(walls),
                                 "mean": sum(walls) / max(len(walls), 1)},
            "measured_dispatch_s": acc["phases"].get("dispatch", 0.0),
            "sched": batcher.sched.snapshot()["sheds"],
            "autoscaler": slo.autoscaler(),
            "launches": {k: v - l0[k] for k, v in ops.LAUNCHES.items()},
        })
        if not fail_open_ok:
            step = max(1, n // per_load)
            sample.extend((requests[i], bodies[i])
                          for i in range(0, n, step)[:per_load])
        return rows[-1]

    try:
        ops.reset_launches()
        server = WebhookServer(
            client, TARGET, window_ms=2.0, metrics=metrics, tracer=tracer,
            ingest=True, sched_policy="deadline", slo=slo, decision_log=dlog,
        )
        record_cuts(server.batcher.sched)
        server.start()
        try:
            for seed, (n, callers, conns) in enumerate(framed):
                row = run_load(
                    "framed", server.batcher,
                    lambda posts: _drive_framed(
                        server.ingest.port, _framed(posts, [10_000] * n),
                        callers, conns),
                    n, seed)
                row.update(callers=callers, connections=conns)
            fallbacks = server.ingest.stats()["decode"]["fallback"]
            decode = server.ingest.stats()["decode"]
        finally:
            server.stop()
        _check_served("ingest (framed)", server, metrics, client,
                      [r for r, _ in sample])
        for seed, (n, threads, deadline_ms) in enumerate(bridged):
            bmetrics = MetricsRegistry()
            bridge = BridgeStack(
                client, TARGET, _socket_path(f"ingest-{seed}"),
                deadline_ms=deadline_ms, window_ms=2.0, metrics=bmetrics,
                tracer=tracer, sched_policy="deadline", slo=slo,
                decision_log=dlog,
            )
            record_cuts(bridge.batcher.sched)
            bridge.start()
            try:
                row = run_load(
                    "bridge", bridge.batcher,
                    lambda posts: _drive_http(bridge.port, posts, threads),
                    n, 10 + seed, backend=bridge.backend,
                    fail_open_ok=deadline_ms < 10_000)
                row.update(clients=threads, deadline_ms=deadline_ms)
            finally:
                bridge.stop()
            _check_served(f"ingest (bridge, {deadline_ms} ms)", bridge,
                          bmetrics, client, [r for r, _ in sample])
        launches = dict(ops.LAUNCHES)
    finally:
        del client.review_many
    if fallbacks:
        raise AssertionError(f"ingest: {fallbacks} decode fallbacks")
    if drv.device.type == "cuda":
        missing = [k for k in PATH_KERNELS["ingest"] if launches[k] <= 0]
        if missing:
            raise AssertionError(f"ingest: kernels never launched: {missing}")
    t1 = time.perf_counter()
    oracle = _oracle(client)
    checked = 0
    for req, body in sample[:n_sample]:
        fields = _response_fields(body)
        if fields != _expected_response(oracle, req):
            if fields[0] and "evaluation unavailable" in (fields[2] or "") \
                    and any(r["shed"] for r in rows):
                continue  # a shed request's fail-policy answer
            raise AssertionError(
                f"ingest: response to {req['uid']} differs from the interpreter")
        checked += 1
    print(json.dumps({
        "phase": "ingest", "loads": rows, "decode": decode,
        "launches": launches, "sample_checked": checked,
        "sample_seconds": time.perf_counter() - t1,
        "decisions": dlog.snapshot(),
        "seconds": time.perf_counter() - t0,
    }), flush=True)
    return launches


# -- driver planes: analysis, liveness, partitions -----------------------------


def _pr8_route(drv, kind, constraint):
    """Whether the symbolic compiler compiles `constraint`'s program when
    asked without the analyzer's verdict (the route every template took
    before verdict-first routing): True for compiled, False for the
    interpreter. Compiles against throwaway registries."""
    from gatekeeper_tpu_torch.constraint import hooks
    from gatekeeper_tpu_torch.constraint.torchdriver import _params_key
    from gatekeeper_tpu_torch.engine.patterns import PatternRegistry
    from gatekeeper_tpu_torch.engine.programs import compile_program
    from gatekeeper_tpu_torch.engine.symbolic import (
        CompilerEnv,
        CompileUnsupported,
    )
    from gatekeeper_tpu_torch.engine.tables import StrTables
    from gatekeeper_tpu_torch.flatten.vocab import Vocab

    params = hooks.constraint_parameters(constraint)
    vocab = Vocab()
    env = CompilerEnv(
        vocab, PatternRegistry(vocab), StrTables(vocab),
        oracle_fn=drv._make_oracle(TARGET, kind, params),
        oracle_ns=f"{kind}|{_params_key(params)}",
        oracle_ns_shared=f"{TARGET}|{kind}", template_kind=kind,
    )
    try:
        compile_program(env, drv._kind_modules[(TARGET, kind)], params)
    except CompileUnsupported:
        return False
    return True


def phase_analysis(corpus: str, client, drv):
    """The static analyzer over a corpus's templates: the verdict of each
    (analyze_template on its document, and the driver's own report of the
    mounted modules, which must agree), the fallback codes of the routed
    set, analyzer_mismatches == 0, and every template whose route differs
    from the route the compiler alone gives it (before verdict-first
    routing, a template went to the interpreter only when its compile
    raised)."""
    from gatekeeper_tpu_torch.analysis import analyze_template

    t0 = time.perf_counter()
    docs = template_docs() + (
        uniqueness_templates() if corpus == "inventory" else []
    )
    verdicts = {}
    for doc in docs:
        kind = doc["spec"]["crd"]["spec"]["names"]["kind"]
        rep = analyze_template(doc)
        if drv.template_report(TARGET, kind).verdict != rep.verdict:
            raise AssertionError(
                f"analysis: {kind}: the driver's verdict differs from "
                "analyze_template's")
        verdicts[kind] = rep.verdict
    cs = drv._constraint_set(TARGET)
    changed = []
    seen = set()
    for c, prog in zip(cs.constraints, cs.programs):
        key = (c["kind"], json.dumps(c["spec"].get("parameters"),
                                     sort_keys=True))
        if key in seen:
            continue
        seen.add(key)
        if prog is None and _pr8_route(drv, c["kind"], c):
            changed.append(c["kind"])
    counts = {}
    for v in verdicts.values():
        counts[v] = counts.get(v, 0) + 1
    if drv.analyzer_mismatches:
        raise AssertionError(
            f"analysis: {drv.analyzer_mismatches} analyzer mismatches")
    print(json.dumps({
        "phase": "analysis", "corpus": corpus, "templates": len(verdicts),
        "verdict_counts": counts, "verdicts": verdicts,
        "fallback_codes": cs.fallback_codes,
        "interpreted_constraints": sum(p is None for p in cs.programs),
        "analyzer_mismatches": drv.analyzer_mismatches,
        "route_changed": sorted(set(changed)),
        "seconds": time.perf_counter() - t0,
    }), flush=True)


def _k2_shapes():
    """Wrap ops.slab_gather to note the [N, L, T] of every K2 call:
    -> (shapes list, undo)."""
    from gatekeeper_tpu_torch.kernels import ops

    shapes = []
    real = ops.slab_gather

    def noted(tab, ids, *a, **kw):
        shapes.append((int(ids.shape[0]), int(ids.shape[1]),
                       int(tab.shape[1])))
        return real(tab, ids, *a, **kw)

    ops.slab_gather = noted

    def undo():
        ops.slab_gather = real

    return shapes, undo


def phase_liveness(client, drv, rec, n_batches: int = 8, batch: int = 256):
    """The full phase's 8 pod review batches of 256 x 500 constraints, each
    with the IR liveness mask on and then off (drv.liveness_enabled): the
    results must be equal. Per setting, the token slots the mask dropped,
    the [N, L, T] of K2's calls (the mask narrows the token axis L; T is
    the policy's slab columns), and the encode and dispatch seconds summed
    over the batches. -> the kernel launches of the masked runs."""
    from gatekeeper_tpu_torch.kernels import ops

    t0 = time.perf_counter()
    out = {}
    launches = {}
    rec.install()
    try:
        for on in (True, False):
            drv.liveness_enabled = on
            shapes, undo = _k2_shapes()
            l0 = dict(ops.LAUNCHES)
            enc = disp = 0.0
            skipped = 0
            results = []
            try:
                for b in range(n_batches):
                    resps = client.review_many(review_batch(b, batch))
                    ph = drv.stats["phase_seconds"]
                    enc += ph["encode"]
                    disp += ph["dispatch"]
                    skipped += drv.stats["columns_skipped_static"]
                    results.append([_keys(r.by_target[TARGET].results)
                                    for r in resps])
            finally:
                undo()
            delta = {k: v - l0[k] for k, v in ops.LAUNCHES.items()}
            if on:
                launches = delta
            ls = sorted({s[1] for s in shapes})
            out["on" if on else "off"] = {
                "columns_skipped_static": skipped,
                "k2_calls": len(shapes),
                "k2_L": ls, "k2_T_max": max(s[2] for s in shapes),
                "k2_N": sorted({s[0] for s in shapes}),
                "encode_s": enc, "dispatch_s": disp,
                "results": results,
            }
    finally:
        drv.liveness_enabled = True
        rec.remove()
    if out["on"].pop("results") != out["off"].pop("results"):
        raise AssertionError("liveness: results with the mask differ")
    if out["on"]["columns_skipped_static"] <= 0:
        raise AssertionError("liveness: the mask dropped no token slot")
    if drv.device.type == "cuda":
        missing = [k for k in PATH_KERNELS["liveness"] if launches[k] <= 0]
        if missing:
            raise AssertionError(f"liveness: kernels never launched: {missing}")
    print(json.dumps({
        "phase": "liveness", "batches": n_batches, "batch": batch,
        "liveness_stats": drv.liveness_stats(), **out,
        "launches": launches, "seconds": time.perf_counter() - t0,
    }), flush=True)
    return launches


def _unavailable(body) -> bool:
    """The fail-policy envelope (fail open) of a request the fused path
    did not evaluate."""
    status = body["response"].get("status") or {}
    return body["response"]["allowed"] is True and (
        status.get("message") or ""
    ).startswith("admission evaluation unavailable")


def _canary_cost(client, drv, integ, part, n: int = 100, reps: int = 5):
    """What canaries add to one partition dispatch: `n` reviews (a
    128-row bucket, 28 free slots) through review_many_subset, with the
    integrity plane and without, in turns; medians of the wall and of the
    `encode`, `dispatch` and `render` phases, and the canary rows."""
    objs = review_batch(99, n)
    out = {"with": [], "without": []}
    rows0 = integ.snapshot()["canary"]["rows"]
    for _ in range(reps):
        for label, plane in (("without", None), ("with", integ)):
            drv.set_integrity(plane)
            t = time.perf_counter()
            client.review_many_subset(objs, part.subset, device=part.device,
                                      partition=part.index)
            ph = drv.stats["phase_seconds"]
            out[label].append((time.perf_counter() - t, ph["encode"],
                               ph["dispatch"], ph["render"]))
    drv.set_integrity(integ)
    med = {
        label: dict(zip(("wall_s", "encode_s", "dispatch_s", "render_s"),
                        (sorted(col)[len(col) // 2] for col in zip(*runs))))
        for label, runs in out.items()
    }
    med["canary_rows"] = integ.snapshot()["canary"]["rows"] - rows0
    return med


def phase_partitions(client, drv, rec, n: int = 4096, callers: int = 256,
                     k: int = 4, fault_rounds: int = 6,
                     fault_batch: int = 64, n_sample: int = 64):
    """The full phase's client behind WebhookServer(window_ms=2.0,
    partitions=k, integrity=IntegrityPlane(), attributor=CostAttributor()):
    n AdmissionReviews of new pods from `callers` threads over HTTP. Every
    response must equal the monolithic fused answer to the same request
    (Client.review_many), n_sample of them _expected_response (the
    interpreter, about 0.4 s a review over 500 constraints), and no canary
    may mismatch. Printed: K1-K4 launches per partition, requests per
    second, p50/p99, the attributed against the measured dispatch seconds
    per partition. Then, on the same server: one partition's constraint
    churned (new parameters: exactly one program compiles, the other
    partitions carry their sets forward; the first 512 requests again),
    and the fault point driver.device_dispatch[device=1] armed for
    `fault_rounds` rounds of `fault_batch` of the same requests: requests
    whose partition-1 dispatch failed get
    the fail-policy envelope, three failures open device 1's breaker,
    partition 1 re-homes and every later answer is fused and equal to
    the interpreter's. -> the kernel launches of the main load."""
    import copy

    from gatekeeper_tpu_torch.faults import FAULTS, OPEN
    from gatekeeper_tpu_torch.integrity import IntegrityPlane
    from gatekeeper_tpu_torch.kernels import ops
    from gatekeeper_tpu_torch.metrics import MetricsRegistry
    from gatekeeper_tpu_torch.obs import CostAttributor
    from gatekeeper_tpu_torch.webhook import WebhookServer

    t0 = time.perf_counter()
    import traceback

    integ, att, metrics = IntegrityPlane(), CostAttributor(), MetricsRegistry()
    per_part = {}
    measured = {}
    errors = []  # the first few exceptions of dispatches and restages
    real, real_prepare = drv.query_many_subset, drv.prepare_subset

    def noted(fn, *a, **kw):
        try:
            return fn(*a, **kw)
        except Exception:
            if len(errors) < 4:
                errors.append(traceback.format_exc(limit=6))
            raise

    def prepare(path, subset, device=0):
        return noted(real_prepare, path, subset, device=device)

    def counted(path, inputs, subset, device=0, partition=None):
        # under the driver's (reentrant) mutex, so the launch counts
        # between the two reads are this dispatch's alone
        with drv._mutex:
            l0 = dict(ops.LAUNCHES)
            resps = noted(real, path, inputs, subset, device=device,
                          partition=partition)
            label = str(partition if partition is not None else device)
            row = per_part.setdefault(label, {})
            for name, v in ops.LAUNCHES.items():
                row[name] = row.get(name, 0) + v - l0[name]
            measured[label] = (measured.get(label, 0.0)
                               + drv.stats["phase_seconds"]["dispatch"])
        return resps

    posts, requests = webhook_posts(7, n)
    server = WebhookServer(client, TARGET, window_ms=2.0, partitions=k,
                           integrity=integ, attributor=att, metrics=metrics)
    drv.query_many_subset = counted
    drv.prepare_subset = prepare
    rec.install()
    server.start()
    part = server.partitioner
    fault = churn = None
    try:
        ops.reset_launches()
        bodies, lat, wall = _drive_http(server.port, posts, callers)
        launches = dict(ops.LAUNCHES)
        load = {
            "requests": n, "callers": callers, "wall_s": wall,
            "rps": n / wall, "p50_s": _quantile(lat, 0.5),
            "p99_s": _quantile(lat, 0.99), "max_s": max(lat),
            "batches": server.batcher.batches_dispatched,
            "served_fused": server.batcher.requests_batched,
            "denied": sum(not b["response"]["allowed"] for b in bodies),
            "unavailable_why": sorted({
                b["response"]["status"]["message"]
                for b in bodies if _unavailable(b)})[:4],
        }
        attributed = {}
        for row in att.table(None)["rows"]:
            for p, s in row["partitions"].items():
                attributed[p] = attributed.get(p, 0.0) + s
        load_measured = dict(measured)
        load_per_part = copy.deepcopy(per_part)
        load_snap = part.snapshot()
        plan = part.plan()
        canary = integ.snapshot()["canary"]
        canary_cost = _canary_cost(client, drv, integ, plan.partitions[0])
        # -- one partition churned: exactly one new program compiles --------
        att.reset()  # the replan weighs static costs, as the first plan did
        victim = next(
            c for c in drv._constraints(TARGET)
            if c["kind"] == "K8sRequiredLabels"
            and f"K8sRequiredLabels/{c['metadata']['name']}"
            in plan.partitions[2 % k].subset
        )
        churned = copy.deepcopy(victim)
        churned["spec"]["parameters"] = {"labels": [{"key": "smoke-tier"}]}
        compiles0 = drv.program_compiles
        carry0, swaps0 = drv.subset_carryforwards, drv.subset_swaps
        client.add_constraint(churned)
        c_posts = posts[:512]
        c_bodies, _, _ = _drive_http(server.port, c_posts, 64)
        new_plan = part.plan()
        churn = {
            "constraint": f"K8sRequiredLabels/{victim['metadata']['name']}",
            "partition": 2 % k,
            "program_compiles": drv.program_compiles - compiles0,
            "subset_carryforwards": drv.subset_carryforwards - carry0,
            "subset_swaps": drv.subset_swaps - swaps0,
            "plan_unchanged": [p.keys for p in new_plan.partitions]
            == [p.keys for p in plan.partitions],
            "unavailable": sum(_unavailable(b) for b in c_bodies),
            "unavailable_why": sorted({
                b["response"]["status"]["message"]
                for b in c_bodies if _unavailable(b)})[:4],
        }
        if churn["program_compiles"] != 1 or churn["unavailable"]:
            raise AssertionError(f"partitions: churn {churn}")
        client.add_constraint(victim)  # the corpus as the later phases know it
        c_bodies2, _, _ = _drive_http(server.port, c_posts, 64)
        # -- device 1 fails: only its partition's requests fail open --------
        snap0 = part.snapshot()["dispatches"]
        FAULTS.arm("driver.device_dispatch[device=1]", "error")
        f_bodies = []
        try:
            for r in range(fault_rounds):
                lo = (r * fault_batch) % n
                fb, _, _ = _drive_http(
                    server.port, posts[lo:lo + fault_batch], fault_batch)
                f_bodies += [(lo + i, b) for i, b in enumerate(fb)]
            fired = FAULTS.fired("driver.device_dispatch[device=1]")
        finally:
            FAULTS.reset()
        snap = part.snapshot()
        f_plan = part.plan()
        fault = {
            "rounds": fault_rounds, "requests": len(f_bodies),
            "fired": fired,
            "unavailable": sum(_unavailable(b) for _, b in f_bodies),
            "unavailable_why": sorted({
                b["response"]["status"]["message"]
                for _, b in f_bodies if _unavailable(b)})[:4],
            "breaker_1": part.breaker(1).state,
            "partition_1_device": f_plan.partitions[1].device,
            "rehomes": part.rehomes,
            "dispatches": {key: v - snap0.get(key, 0)
                           for key, v in snap["dispatches"].items()},
        }
        if (fired != 3 or fault["breaker_1"] != OPEN
                or fault["partition_1_device"] == 1
                or fault["dispatches"]["unavailable"] != 3):
            raise AssertionError(f"partitions: device fault {fault}")
        final_canary = integ.snapshot()["canary"]
    finally:
        server.stop()
        rec.remove()
        del drv.query_many_subset, drv.prepare_subset
        drv.set_integrity(None)
        for e in errors:
            print(e, file=sys.stderr, flush=True)
        drv.set_attributor(None)
    if drv.device.type == "cuda":
        for label, row in load_per_part.items():
            missing = [kk for kk in PATH_KERNELS["partitions"] if row[kk] <= 0]
            if missing:
                raise AssertionError(
                    f"partitions: partition {label} never launched {missing}")
    if load["served_fused"] != n or load_snap["dispatches"]["unavailable"]:
        raise AssertionError(f"partitions: not every request fused: {load}")
    if canary["mismatch_batches"] or final_canary["mismatch_batches"]:
        raise AssertionError(f"partitions: canary mismatches {final_canary}")
    # every answer against one monolithic fused dispatch per 256 of the
    # same requests, and a sample against the interpreter
    from gatekeeper_tpu_torch.constraint import K8sValidationTarget

    t1 = time.perf_counter()
    handler = K8sValidationTarget()
    for lo in range(0, n, 256):
        resps = client.review_many([handler.augment_request(r)
                                    for r in requests[lo:lo + 256]])
        for i, resp in enumerate(resps, start=lo):
            if _response_fields(bodies[i]) != _response_of(
                    resp.by_target[TARGET].results):
                raise AssertionError(
                    f"partitions: {requests[i]['uid']} differs from the "
                    "monolithic dispatch")
    mono_s = time.perf_counter() - t1
    step = max(1, n // n_sample)
    oracle = _oracle(client)
    for req, body in list(zip(requests, bodies))[::step][:n_sample]:
        if _response_fields(body) != _expected_response(oracle, req):
            raise AssertionError(
                f"partitions: response to {req['uid']} differs from "
                "the interpreter")
    for i, body in enumerate(c_bodies2):
        if _response_fields(body) != _response_fields(bodies[i]):
            raise AssertionError(
                f"partitions: after the churn, {requests[i]['uid']} differs")
    failed_open = 0
    for i, body in f_bodies:
        if _unavailable(body):
            failed_open += 1
        elif _response_fields(body) != _response_fields(bodies[i]):
            raise AssertionError(
                f"partitions: under the fault, {requests[i]['uid']} differs")
    print(json.dumps({
        "phase": "partitions", "k": k, "load": load,
        "plan": [len(p.keys) for p in plan.partitions],
        "launches_per_partition": load_per_part,
        "dispatch_s_measured": load_measured,
        "dispatch_s_attributed": attributed,
        "canary": canary, "canary_cost": canary_cost,
        "dispatches": load_snap["dispatches"],
        "churn": churn, "fault": fault, "fault_failed_open": failed_open,
        "checked_against_monolith": n, "monolith_check_s": mono_s,
        "checked_against_interpreter": min(n, n_sample),
        "interpreter_check_s": time.perf_counter() - t1 - mono_s,
        "launches": launches, "seconds": time.perf_counter() - t0,
    }, default=float), flush=True)
    return launches


def _match_battery(seed: int, u: int, n: int, width: int = 4,
                   cover: bool = True):
    """Seeded encoded match specs and review features over a tiny id
    space, so ids, selectors and labels collide often: -1 pads, wildcard
    kind rows, all five matchExpressions ops, namespaces, excluded
    namespaces, every scope code, namespaceSelector with the empty-labels
    candidate, and the object/oldObject 4-case (checked when `cover`).
    About half of each spec's parts are left unset so that matches stay
    common. -> (ms, fb) as numpy arrays."""
    import numpy as np

    r = np.random.default_rng(seed)

    def ids(shape, lo=-1, hi=4):
        return r.integers(lo, hi, size=shape).astype(np.int32)

    def flags(shape, p=0.5):
        return r.random(shape) < p

    def unset(a, p=0.5):
        a[r.random(a.shape[0]) < p] = -1  # blank whole spec rows
        return a

    def labels(rows):
        lab = ids((rows, width, 2), 0, 3)
        lab[r.random((rows, width)) < 0.4] = -1
        return lab

    def exprs():
        e = np.stack(
            [ids((u, 2), 0, 3), ids((u, 2), -1, 6), ids((u, 2), 0, 2)],
            axis=-1,
        )
        return unset(e, 0.6)

    kind = ids((u, 2, 2), -3, 2)
    kind[r.random((u, 2, 2)) < 0.4] = -2  # wildcard group/kind
    ms = {
        "kind_rows": kind,
        "ns_has": flags(u, 0.3), "ns_ids": ids((u, 3)),
        "excl_has": flags(u, 0.3), "excl_ids": ids((u, 3)),
        "scope": ids(u, 0, 5),
        "lab_invalid": flags(u, 0.05), "lab_ml": unset(ids((u, 2, 2), 0, 3)),
        "lab_expr": exprs(), "lab_expr_vals": ids((u, 2, 3)),
        "nssel_has": flags(u, 0.3), "nssel_matches_empty": flags(u),
        "nssel_invalid": flags(u, 0.05),
        "nssel_ml": unset(ids((u, 2, 2), 0, 3)),
        "nssel_expr": exprs(), "nssel_expr_vals": ids((u, 2, 3)),
    }
    fb = {
        "group_id": ids(n, -1, 2), "kind_id": ids(n, -1, 2),
        "kind_defined": flags(n, 0.8), "is_ns": flags(n, 0.3),
        "has_namespace": flags(n), "ns_name_id": ids(n),
        "obj_present": flags(n, 0.7), "old_present": flags(n, 0.5),
        "obj_labels": labels(n), "old_labels": labels(n),
        "nssel_defined": flags(n, 0.7), "nssel_labels": labels(n),
        "nssel_empty": flags(n, 0.3),
    }
    ops = set(ms["lab_expr"][..., 1].ravel()) | set(
        ms["nssel_expr"][..., 1].ravel()
    )
    if not cover:
        return ms, fb
    if not {1, 2, 3, 4, 5} <= ops:
        raise AssertionError(f"match battery {seed} misses an op: {ops}")
    if len(set(zip(fb["obj_present"], fb["old_present"]))) != 4:
        raise AssertionError(f"match battery {seed} misses a 4-case")
    return ms, fb


def _random_variants(device, seed: int = 7):
    """Seeded random inputs for kernel code paths the in-repo policy does
    not reach on the main path (K1's namespace, excluded-namespace,
    scope, namespaceSelector and labelSelector clauses over many spec
    rows; EGroup max/sum, int32/float32 values, g1/g01 axes; overlay
    slabs of every type; a hot-row window smaller than the hot rows; the
    K2, K3, K4 and K1 plan edges): -> [(name, args, kwargs)]."""
    import numpy as np
    import torch

    r = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    out = []
    # the last, one spec row over few reviews, is an edge case only
    for bseed, u, n, width in ((0, 48, 4096, 4), (1, 48, 32768, 4),
                               (2, 24, 20000, 16), (3, 1, 1000, 4)):
        ms, fb = _match_battery(seed * 100 + bseed, u, n, width, u > 1)
        out.append(("match_matrix",
                    ({k: t(v) for k, v in ms.items()},
                     {k: t(v) for k, v in fb.items()}), {}))
    n, l, g0, g1 = 4096, 96, 16, 8
    idx0 = t(r.integers(-1, g0 + 2, (n, l)).astype(np.int32))
    idx1 = t(r.integers(-1, g1 + 2, (n, l)).astype(np.int32))
    mask = t(r.random((n, l)) < 0.6)
    vals = {
        "bool": t(r.random((n, l)) < 0.5),
        "int32": t(r.integers(-3, 900, (n, l)).astype(np.int32)),
        "float32": t(r.integers(-3, 900, (n, l)).astype(np.float32)),
    }
    for how in ("any", "sum", "max"):
        for vname, val in vals.items():
            for axis in ("g0", "g1", "g01"):
                init = -(10.0**30) if vname == "float32" and how == "max" else -1
                out.append(("egroup", (idx0, idx1, mask, val, axis, g0, g1,
                                       how, init), {}))
    v, cols, b = 5000, 24, 300
    ids = t(r.integers(0, v + b + 10, (2048, 64)).astype(np.int32))
    for dt in (np.bool_, np.int32, np.float32):
        tab = r.random((v, cols)) < 0.5 if dt == np.bool_ else r.integers(
            -9, 99, (v, cols)).astype(dt)
        ov = r.random((b, cols)) < 0.5 if dt == np.bool_ else r.integers(
            -9, 99, (b, cols)).astype(dt)
        out.append(("slab_gather", (t(tab), ids, None, 0), {}))
        out.append(("slab_gather", (t(tab), ids, t(ov), v - 40), {}))
    out += _slab_edge_variants(r, t)
    out += _egroup_edge_variants(r, t)
    c, n2, u = 300, 20000, 7
    match_u = r.random((u, n2)) < 0.7
    spec_map = r.integers(1, u, c).astype(np.int32)
    spec_map[5] = 0  # one interpreter-only constraint ...
    match_u[0] = r.random(n2) < 0.01  # ... whose spec matches few rows
    compiled = np.arange(c) != 5
    match_u, spec_map, compiled = t(match_u), t(spec_map), t(compiled)
    viol = t(r.random((c, n2)) < 0.002)
    row_fb = t(r.random(n2) < 0.001)
    for r_cap in (64, 1024, 8192):
        out.append(("need_tail", (match_u, spec_map, viol, compiled, row_fb,
                                  n2 - 77, r_cap), {}))
    out += _need_edge_variants(r, t)
    out += _match_edge_variants(r, t)
    # K6: g0 and g01 (idx1 >= g1 runs into the next element, idx -1 and
    # idx >= G take the default) over every value type
    n, l, g0, g1 = 4096, 96, 16, 8
    idx0 = t(r.integers(-1, g0 + 2, (n, l)).astype(np.int32))
    idx1 = t(r.integers(-1, g1 + 3, (n, l)).astype(np.int32))
    for axis, g in (("g0", g0), ("g01", g0 * g1)):
        for v, default in (
            (t(r.random((n, g)) < 0.5), False),
            (t(r.integers(-3, 900, (n, g)).astype(np.int32)), -1),
            (t(r.integers(-3, 900, (n, g)).astype(np.float32)), -(10.0**30)),
        ):
            out.append(("gather_elem",
                        (v, idx0, idx1, axis, g0, g1, default), {}))
    # K5: tables of every type at fills that leave the destination
    # unaligned, deltas from 1 row to past one 64 KiB segment, some of
    # them cast on the host
    bufs, fills, deltas = [], [], []
    for k, (dt, width, fill, rows) in enumerate((
        (np.bool_, 1, 4093, 512), (np.int32, 1, 777, 1024),
        (np.float32, 1, 0, 512), (np.bool_, 23, 1001, 4096),
        (np.int32, 7, 5, 1536), (np.float32, 3, 4095, 512),
        (np.bool_, 1, 12000, 1),
    )):
        shape = (16384,) if width == 1 else (16384, width)
        bufs.append(t(np.zeros(shape, dt)))
        fills.append(fill)
        dshape = (rows,) + shape[1:]
        src = r.integers(-50, 50, dshape)
        deltas.append(src.astype(np.float64 if k % 2 else dt))
    out.append(("flush_deltas", (bufs, fills, deltas), {}))
    out += _delta_edge_variants(r, t)
    # K7: ragged widths (rows of match and counts then cannot share their
    # alignment), -1 and out-of-range count rows, n_valid cut short, no
    # compiled row at all
    for c, n, cc, cut in ((500, 4099, 37, 5), (64, 100_000, 64, 0),
                          (33, 4101, 7, 4101), (9, 77, 0, 3)):
        match = t(r.random((c, n)) < 0.5)
        counts = t(r.integers(-2, 3, (cc, n)).astype(np.int32)) if cc else None
        crow = r.integers(-1, cc + 2, c).astype(np.int32) if cc else np.full(
            c, -1, np.int32)
        out.append(("full_totals", (match, counts, t(crow), n - cut), {}))
    return out


def _need_edge_variants(r, t):
    """K4 at the edges of its plan and bit layout: N = 1, 15, 17, 31, 33
    and 32768 (tails of the 16-review loads and of the 32-bit row-any
    words), n_valid = 0, 1, N - 1 and N, R = 1 and R = N (hot slots in
    several 4096-slot chunks; R not a multiple of 32, so packed words
    straddle need rows), C_pad not a multiple of the constraint slice nor
    of the 4-constraint unroll, n_hot > R; and all constraints
    interpreter-only, all rows fallbacks, views off 16-byte alignment
    (byte loads), few hot rows."""
    out = []
    for n in (1, 15, 17, 31, 33, 32768):
        c = 503 if n == 32768 else 37
        for n_valid in sorted({0, 1, n - 1, n}):
            for r_cap in sorted({1, n}):
                out.append(("need_tail", _need_case(
                    r, t, c, n, match=0.8, viol=0.3, fb=0.05, interp=0.1,
                    n_valid=n_valid, r_cap=r_cap), {}))
    for c, n, r_cap, kw in (
        (1001, 33, 7, {}), (61, 4099, 33, {}), (2999, 32768, 1024, {}),
        (37, 1000, 1000, {"interp": 1.0}), (37, 1000, 64, {"fb": 1.0}),
        (503, 32768, 8193, {"viol": 0.00002, "match": 0.7, "fb": 0.0,
                            "interp": 0.0}),
    ):
        out.append(("need_tail", _need_case(r, t, c, n, r_cap=r_cap, **kw),
                    {}))
    args = _need_case(r, lambda a: a, 503, 32768, match=0.8, viol=0.3,
                      fb=0.05, n_valid=32700)
    out.append(("need_tail", (
        _offset_view(t, args[0], 1), t(args[1]), _offset_view(t, args[2], 3),
        t(args[3]), _offset_view(t, args[4], 5)) + args[5:], {}))
    return out


def match_max_u(per_spec_words: int, ml: int, ml2: int, reads: int) -> int:
    """The largest spec count K1's plan takes for specs of
    `per_spec_words` words each (flags included) over reviews of ml / ml2
    label slots, with the review arrays `reads` names."""
    from gatekeeper_tpu_torch.kernels import ops

    def fits(u):
        try:
            ops.match_plan(1, u, u * per_spec_words, ml, ml2, reads, 132)
        except ValueError:
            return False
        return True

    lo, hi = 1, ops.SMEM_BLOCK_MAX // 4 // per_spec_words + 1
    while lo + 1 < hi:  # fits(lo), not fits(hi)
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    return lo


def _match_edge_variants(r, t):
    """K1 at U = 1 and at the largest U its plan allows, ML = 4 and 16,
    over seeded batteries whose rows mix dead and live selectors; the
    kinds-only spec set (every selector dead: 4 reviews a thread) at N not
    a multiple of 4, with drawn scopes, and on feature views off
    alignment."""
    import numpy as np

    from gatekeeper_tpu_torch.kernels import ops

    out = []

    def cuda(ms, fb):
        return ({k: t(a) for k, a in ms.items()},
                {k: t(a) for k, a in fb.items()})

    for ml in (4, 16):
        probe, _ = _match_battery(900 + ml, 2, 4, ml, False)
        per = sum(a[0].size for k, a in probe.items()
                  if k in ops._MS_STAGED) + 1
        reads = ops.R_OBJ | ops.R_NSLAB | ops.R_NS | ops.R_NSSEL
        u_max = match_max_u(per, ml, ml, reads)
        for u, n in ((1, 4099), (u_max, 2053)):
            ms, fb = _match_battery(910 + ml + u, u, n, ml, False)
            flags, got = ops.match_flags(ms)
            if u > 1 and not (flags & ops.F_LAB_LIVE).any():
                raise AssertionError("match edge: no live selector")
            if u == u_max and got == reads:
                with_one_more = (u + 1) * per
                try:
                    ops.match_plan(n, u + 1, with_one_more, ml, ml, got, 132)
                except ValueError:
                    pass
                else:
                    raise AssertionError(f"match edge: U {u} is not the largest")
            out.append(("match_matrix", cuda(ms, fb), {}))
    for n, scopes in ((4099, False), (4097, True)):
        out.append(("match_matrix", cuda(*_kinds_only_specs(
            r, 3, n, 8, scopes)), {}))
    ms, fb = _kinds_only_specs(r, 5, 4096, 4, True)
    dev_fb = {k: _offset_view(t, a, 1) for k, a in fb.items()}
    out.append(("match_matrix", ({k: t(a) for k, a in ms.items()}, dev_fb),
                {}))
    return out


def _offset_view(t, a, offset: int):
    """`a` on the device as a contiguous view `offset` elements into a
    larger buffer: its start is then not 16-byte aligned."""
    import numpy as np

    flat = np.zeros(a.size + offset, a.dtype)
    flat[offset:] = a.reshape(-1)
    return t(flat)[offset:].view(a.shape)


def _slab_edge_variants(r, t):
    """K2 at the widths its launch plan treats apart (rows of 1, 3, 16, 17,
    44 and 45 elements of 1 or 4 bytes: copy words of 1 to 16 bytes, tiles
    of 16 to 256 tokens), a token count that is not a multiple of any
    tile, ids below 0, at V - 1, at v_base - 1, at v_base and past the
    overlay, and table, overlay and ids views that start off alignment."""
    import numpy as np

    out = []
    v, b, v_base = 700, 50, 650  # ids at or past v_base read the overlay
    edge = np.array([-7, -1, 0, v - 1, v_base - 1, v_base, v_base + b - 1,
                     v_base + b, v_base + b + 9, v + 3], np.int32)
    for cols in (1, 3, 16, 17, 44, 45):
        for dt in (np.bool_, np.int32, np.float32):
            def table(rows):
                if dt == np.bool_:
                    return r.random((rows, cols)) < 0.5
                return r.integers(-99, 99, (rows, cols)).astype(dt)

            ids = r.integers(-3, v + 5, (37, 29)).astype(np.int32)
            ids.reshape(-1)[: edge.size] = edge
            tab, ov = table(v), table(b)
            out.append(("slab_gather", (t(tab), t(ids), t(ov), v_base), {}))
            out.append(("slab_gather", (t(tab), t(ids), None, 0), {}))
            # views one element into their buffers
            out.append(("slab_gather", (_offset_view(t, tab, 1),
                                        _offset_view(t, ids, 1),
                                        _offset_view(t, ov, 1), v_base), {}))
    return out


# EGroup slot counts with the axis that gives each: (G, axis, g0, g1)
EGROUP_EDGE_G = ((1, "g0", 1, 3), (31, "g1", 5, 31), (32, "g01", 8, 4),
                 (33, "g0", 33, 2), (64, "g01", 16, 4), (65, "g1", 3, 65),
                 (1024, "g01", 32, 32))


def _egroup_edge_variants(r, t):
    """K3 at every G of EGROUP_EDGE_G (bits in registers up to 64 slots,
    shared memory above) x L in 1, 17, 128, 130 (vector loads at 128,
    scalar loads elsewhere) x any/sum/max x bool/int32/float32 values, on
    257 rows (not a multiple of a block's rows) with a row whose mask is
    all false and a row where every token hits slot 0; and at L = 128 a
    mask, an idx0 and a value view that start off alignment (scalar
    loads)."""
    import numpy as np

    out = []
    n = 257
    for g, axis, g0, g1 in EGROUP_EDGE_G:
        for l in (1, 17, 128, 130):
            idx0 = r.integers(-1, g0 + 2, (n, l)).astype(np.int32)
            idx1 = r.integers(-1, g1 + 2, (n, l)).astype(np.int32)
            mask = r.random((n, l)) < 0.6
            mask[3] = False
            idx0[5], idx1[5], mask[5] = 0, 0, True
            vals = {
                "bool": r.random((n, l)) < 0.5,
                "int32": r.integers(-3, 900, (n, l)).astype(np.int32),
                "float32": r.integers(-3, 900, (n, l)).astype(np.float32),
            }
            for how in ("any", "sum", "max"):
                for vname, val in vals.items():
                    init = (-(10.0**30) if vname == "float32" and how == "max"
                            else -1)
                    out.append(("egroup", (t(idx0), t(idx1), t(mask), t(val),
                                           axis, g0, g1, how, init), {}))
                    if l == 128 and vname != "bool":
                        out.append(("egroup", (
                            _offset_view(t, idx0, 1), t(idx1),
                            _offset_view(t, mask, 3), _offset_view(t, val, 1),
                            axis, g0, g1, how, init), {}))
    return out


def _delta_edge_variants(r, t):
    """K5 at the edges of its plan: bool tables at fills of every residue
    modulo 16, a zero-row delta among them, one delta longer than many
    segments (past the headers that fit the kernel parameters), and an
    empty table list."""
    import numpy as np

    bufs, fills, deltas = [], [], []
    for k in range(16):
        bufs.append(t(r.random(20_000) < 0.5))
        fills.append(16 * int(r.integers(0, 600)) + k)
        deltas.append(r.random(512 * (1 + k % 3) if k != 7 else 0) < 0.5)
    out = [("flush_deltas", (bufs, fills, deltas), {})]
    long_buf = t(r.integers(-9, 9, (300_000, 11)).astype(np.int32))
    out.append(("flush_deltas", (
        [long_buf], [3], [r.integers(-99, 99, (150_016, 11)).astype(np.int32)],
    ), {}))
    out.append(("flush_deltas", ([], [], []), {}))
    return out


def _delta_staging_checks():
    """K5's staging on the card, each flush against its plain version:
    consecutive flushes of growing size, then two large flushes issued back
    to back with no synchronize between them (the second must not rewrite
    a pinned block whose copy is still in flight); and a segment table
    that the entry point must refuse (one segment a byte longer than a
    block), launching nothing. -> {case: flushes checked}."""
    import ctypes

    import numpy as np
    import torch
    from gatekeeper_tpu_torch.kernels import ops
    from gatekeeper_tpu_torch.kernels.build import library

    r = np.random.default_rng(17)

    def case(rows, width, fill):
        buf = torch.from_numpy(
            r.integers(-9, 9, (fill + rows + 100, width)).astype(np.int32)
        ).cuda()
        return buf, fill, r.integers(-99, 99, (rows, width)).astype(np.int32)

    checked = {}
    for rows in (512, 4096, 65_536, 1_048_576):
        buf, fill, d = case(rows, 5, int(r.integers(0, 999)))
        want = ops.flush_deltas_plain([buf.clone()], [fill], [d])[0]
        got = ops.flush_deltas([buf], [fill], [d])[0]
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"variants: K5 growth at {rows} rows differs")
        checked["growth"] = checked.get("growth", 0) + 1
    # back to back: 24 MiB each, so the first copy is in flight while the
    # second flush packs
    a, b = case(393_216, 16, 1001), case(393_216, 16, 77)
    want_a = ops.flush_deltas_plain([a[0].clone()], [a[1]], [a[2]])[0]
    want_b = ops.flush_deltas_plain([b[0].clone()], [b[1]], [b[2]])[0]
    torch.cuda.synchronize()
    got_a = ops.flush_deltas([a[0]], [a[1]], [a[2]])[0]
    got_b = ops.flush_deltas([b[0]], [b[1]], [b[2]])[0]
    torch.cuda.synchronize()
    if not (torch.equal(got_a, want_a) and torch.equal(got_b, want_b)):
        raise AssertionError("variants: K5 back-to-back flushes differ")
    checked["back_to_back"] = 2
    buf = torch.zeros((4 * ops.DELTA_SEG,), dtype=torch.uint8, device="cuda")
    table = np.zeros((1,), ops.SEG_DTYPE)
    table[0] = (buf.data_ptr(), 16, ops.DELTA_SEG + 1)
    staging = torch.zeros((2 * ops.DELTA_SEG,), dtype=torch.uint8,
                          device="cuda")
    rc = library("delta").gk_flush_deltas(
        table.ctypes.data_as(ctypes.c_void_p), staging.data_ptr(),
        staging.numel(), 1, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if rc != -1 or buf.any():
        raise AssertionError(f"variants: K5 took a segment past its block "
                             f"(rc {rc})")
    checked["refused"] = 1
    return checked


def phase_variants():
    """Each kernel against its plain version on the random variants."""
    import torch
    from gatekeeper_tpu_torch.kernels import ops

    checked = {}
    match_rate = []
    for i, (name, args, kw) in enumerate(_random_variants("cuda")):
        got = _flat(getattr(ops, name)(*_fresh(name, args), **kw))
        want = _flat(_plain(name)(*_fresh(name, args), **kw))
        torch.cuda.synchronize()
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"variants: {name} #{i} differs")
        if name == "match_matrix":
            match_rate.append(float(want.float().mean()))
        checked[name] = checked.get(name, 0) + 1
    # the battery is only a check if both answers are common
    if not all(0.02 < m < 0.98 for m in match_rate[:3]):
        raise AssertionError(f"variants: match rates {match_rate}")
    print(json.dumps({"phase": "variants", "checked": checked,
                      "delta_staging": _delta_staging_checks(),
                      "match_rates": match_rate}), flush=True)


def _plain(name):
    """The plain torch version beside a kernel's wrapper."""
    from gatekeeper_tpu_torch.kernels import ops

    return getattr(ops, name + "_plain")


def _fresh(name, args):
    """A kernel's arguments for one more call: K5 gets its own copy of
    the buffers it writes."""
    if name == "flush_deltas":
        return ([b.clone() for b in args[0]],) + tuple(args[1:])
    return args


def _flat(out):
    """K5 returns its buffers: compare them as one flat byte tensor."""
    import torch

    if isinstance(out, list):
        if not out:
            return torch.zeros((0,), dtype=torch.uint8)
        return torch.cat([b.reshape(-1).view(torch.uint8) for b in out])
    return out


def _size(name, args, out):
    """The size a kernel's timed variant is picked by: its [C, N] input
    for K7, its output otherwise."""
    return args[0].numel() if name == "full_totals" else out.numel()


# -- the process entry: an apiserver stand-in, the Runner, external data ------

IMAGE_CATALOGUE = 5000
RUNNER_SEED = 20261017
EXT_KIND = "K8sExternalImages"
EXT_PROVIDER = "image-signatures"
# error-gated image verification (tests/test_externaldata.py's idiom): the
# analyzer proves it error-gated, so it compiles to the "err" screen
EXT_REGO = """package k8sexternalimages

violation[{"msg": msg}] {
  images := [img | img := input.review.object.spec.containers[_].image]
  response := external_data({"provider": "image-signatures", "keys": images})
  count(response.errors) > 0
  msg := sprintf("image verification failed: %v", [response.errors])
}
"""

# (group, version, kind, plural, namespaced) the stand-in serves before any
# constraint kind is registered
API_KINDS = (
    ("", "v1", "Pod", "pods", True),
    ("", "v1", "Namespace", "namespaces", False),
    ("", "v1", "Secret", "secrets", True),
    ("", "v1", "Event", "events", True),
    ("templates.gatekeeper.sh", "v1beta1", "ConstraintTemplate",
     "constrainttemplates", False),
    ("config.gatekeeper.sh", "v1alpha1", "Config", "configs", True),
    ("externaldata.gatekeeper.sh", "v1alpha1", "Provider", "providers", False),
    ("status.gatekeeper.sh", "v1beta1", "ConstraintPodStatus",
     "constraintpodstatuses", True),
    ("status.gatekeeper.sh", "v1beta1", "ConstraintTemplatePodStatus",
     "constrainttemplatepodstatuses", True),
    ("status.gatekeeper.sh", "v1beta1", "ProviderPodStatus",
     "providerpodstatuses", True),
    ("admissionregistration.k8s.io", "v1", "ValidatingWebhookConfiguration",
     "validatingwebhookconfigurations", False),
    ("mutations.gatekeeper.sh", "v1alpha1", "Assign", "assign", False),
    ("mutations.gatekeeper.sh", "v1alpha1", "AssignMetadata",
     "assignmetadata", False),
    ("mutations.gatekeeper.sh", "v1alpha1", "ModifySet", "modifyset", False),
    ("status.gatekeeper.sh", "v1beta1", "MutatorPodStatus",
     "mutatorpodstatuses", True),
)


# the fleet plane's gossip kind: the runner phase registers it (the phases
# after it run two replicas over it); the process phase's stand-in leaves
# it out, so that replica takes the reference's degrade path
FLEETSTATE_KIND = ("fleet.gatekeeper.sh", "v1alpha1", "FleetState",
                   "fleetstates", True)


def catalogue_image(k: int) -> str:
    """Image k of the catalogue: a repo the in-repo templates allow
    (nginx...), a pinned tag, never docker.io or :latest, so swapping
    make_pod's nginx:1.25 for it changes no in-repo verdict."""
    return f"nginx/img{k:04d}:v{k % 9 + 1}"


def catalogue_pod(i: int, draws):
    """make_pod(i) with every nginx:1.25 image replaced by catalogue image
    draws[c] (container c)."""
    pod = make_pod(i)
    for c, ctr in enumerate(pod["spec"]["containers"]):
        if ctr["image"] == "nginx:1.25":
            ctr["image"] = catalogue_image(int(draws[c]))
    return pod


def _gvk_key(obj):
    group, _, version = obj.get("apiVersion", "v1").rpartition("/")
    return (group, version, obj["kind"])


class ApiServer:
    """A compact stand-in for the Kubernetes API server on 127.0.0.1
    (stdlib HTTP), for the control plane's KubeCluster: discovery
    (/api/v1, /apis, /apis/<group>/<version>), paged lists (limit and
    continue), JSON-line watch streams from a resourceVersion with
    bookmarks, GET of one object, and the create (POST, 409 when it
    exists), replace (PUT, 409 on a stale resourceVersion) and DELETE
    writes the status plane and Events use. Every write gets the next
    resourceVersion and an event in its kind's log."""

    def __init__(self, kinds=API_KINDS):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import parse_qs, urlparse

        self._lock = threading.Lock()
        self.rv = 0
        self.paths = {}   # (group, version, plural) -> (kind, namespaced)
        self.store = {}   # (group, version, kind) -> {(ns, name): obj}
        self.log = {}     # (group, version, kind) -> [(rv, type, obj)]
        self.requests = {}
        self.closed = threading.Event()
        for k in kinds:
            self.register(*k)
        api = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def send_json(self, code, doc):
                payload = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def body(self):
                n = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(n) or b"{}")

            def do_GET(self):  # noqa: N802
                u = urlparse(self.path)
                api.handle_get(self, u.path, parse_qs(u.query))

            def do_POST(self):  # noqa: N802
                api.handle_write(self, "POST", urlparse(self.path).path)

            def do_PUT(self):  # noqa: N802
                api.handle_write(self, "PUT", urlparse(self.path).path)

            def do_DELETE(self):  # noqa: N802
                api.handle_delete(self, urlparse(self.path).path)

        class Server(ThreadingHTTPServer):
            daemon_threads = True
            request_queue_size = 256

        self.httpd = Server(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def close(self):
        self.closed.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(timeout=10)

    def register(self, group, version, kind, plural, namespaced):
        with self._lock:
            self.paths[(group, version, plural)] = (kind, namespaced)
            self.store.setdefault((group, version, kind), {})
            self.log.setdefault((group, version, kind), [])

    # -- the store ------------------------------------------------------------

    def _commit(self, key, etype, obj):
        """Under the lock: the next resourceVersion, stamped on a copy of
        obj's metadata, and the event in the kind's log."""
        self.rv += 1
        obj = dict(obj, metadata=dict(obj.get("metadata") or {},
                                      resourceVersion=str(self.rv)))
        self.log[key].append((self.rv, etype, obj))
        return obj

    def put(self, obj):
        key = _gvk_key(obj)
        meta = obj.get("metadata") or {}
        okey = (meta.get("namespace") or "", meta["name"])
        with self._lock:
            objs = self.store[key]
            stamped = self._commit(
                key, "MODIFIED" if okey in objs else "ADDED", obj)
            objs[okey] = stamped
        return stamped

    def remove(self, obj):
        key = _gvk_key(obj)
        meta = obj.get("metadata") or {}
        okey = (meta.get("namespace") or "", meta["name"])
        with self._lock:
            gone = self.store[key].pop(okey, None)
            if gone is not None:
                self._commit(key, "DELETED", gone)
        return gone is not None

    def objects(self, group, version, kind):
        with self._lock:
            return list(self.store[(group, version, kind)].values())

    def _resolve(self, path):
        """-> ((group, version, kind), namespaced, ns, name) or None."""
        parts = [p for p in path.split("/") if p]
        if len(parts) >= 2 and parts[0] == "api":
            group, rest = "", parts[1:]
        elif len(parts) >= 3 and parts[0] == "apis":
            group, rest = parts[1], parts[2:]
        else:
            return None
        version, rest = rest[0], rest[1:]
        ns = ""
        if len(rest) >= 3 and rest[0] == "namespaces":
            ns, rest = rest[1], rest[2:]
        if not rest:
            return None
        hit = self.paths.get((group, version, rest[0]))
        if hit is None:
            return None
        kind, namespaced = hit
        return ((group, version, kind), namespaced, ns,
                rest[1] if len(rest) > 1 else "")

    # -- HTTP -----------------------------------------------------------------

    def _count(self, what):
        with self._lock:
            self.requests[what] = self.requests.get(what, 0) + 1

    def handle_get(self, h, path, q):
        parts = [p for p in path.split("/") if p]
        if parts == ["apis"]:
            with self._lock:
                groups = sorted({(g, v) for g, v, _ in self.paths if g})
            return h.send_json(200, {"groups": [
                {"name": g, "preferredVersion": {"groupVersion": f"{g}/{v}"}}
                for g, v in groups]})
        if parts == ["api", "v1"] or (len(parts) == 3 and parts[0] == "apis"):
            group, version = ("", "v1") if parts[0] == "api" else parts[1:]
            with self._lock:
                res = [{"name": plural, "kind": kind, "namespaced": nsd,
                        "verbs": ["get", "list", "watch", "create", "update",
                                  "delete"]}
                       for (g, v, plural), (kind, nsd) in self.paths.items()
                       if (g, v) == (group, version)]
            if not res:
                return h.send_json(404, {"message": "no such groupVersion"})
            return h.send_json(200, {"resources": res})
        hit = self._resolve(path)
        if hit is None:
            return h.send_json(404, {"message": f"unknown path {path}"})
        key, _nsd, ns, name = hit
        if name:
            with self._lock:
                obj = self.store[key].get((ns, name))
            if obj is None:
                return h.send_json(404, {"message": "not found"})
            return h.send_json(200, obj)
        if q.get("watch"):
            self._count(f"watch {key[2]}")
            return self._watch(h, key, q)
        self._count(f"list {key[2]}")
        limit = int(q.get("limit", ["0"])[0] or 0)
        start = int(q.get("continue", ["0"])[0] or 0)
        with self._lock:
            items = [o for (ons, _), o in self.store[key].items()
                     if not ns or ons == ns]
            meta = {"resourceVersion": str(self.rv)}
        end = start + limit if limit else len(items)
        if end < len(items):
            meta["continue"] = str(end)
        h.send_json(200, {"items": items[start:end], "metadata": meta})

    def _watch(self, h, key, q):
        import bisect

        since = int(q.get("resourceVersion", ["0"])[0] or 0)
        bookmarks = q.get("allowWatchBookmarks", [""])[0] == "true"
        deadline = time.monotonic() + min(
            float(q.get("timeoutSeconds", ["30"])[0]), 30.0)
        h.send_response(200)
        h.send_header("Content-Type", "application/json")
        h.send_header("Connection", "close")
        h.end_headers()
        log = self.log[key]
        with self._lock:
            i = bisect.bisect_right([e[0] for e in log], since)
        next_mark = time.monotonic() + 1.0
        try:
            while time.monotonic() < deadline and not self.closed.is_set():
                with self._lock:
                    fresh, head = log[i:], self.rv
                i += len(fresh)
                out = b"".join(
                    json.dumps({"type": t, "object": o}).encode() + b"\n"
                    for _, t, o in fresh)
                if bookmarks and time.monotonic() >= next_mark:
                    next_mark = time.monotonic() + 1.0
                    out += json.dumps({"type": "BOOKMARK", "object": {
                        "kind": key[2],
                        "metadata": {"resourceVersion": str(head)}}}
                    ).encode() + b"\n"
                if out:
                    h.wfile.write(out)
                    h.wfile.flush()
                time.sleep(0.05)
        except OSError:
            pass
        h.close_connection = True

    def handle_write(self, h, method, path):
        hit = self._resolve(path)
        if hit is None:
            return h.send_json(404, {"message": "unknown path"})
        key, nsd, ns, name = hit
        obj = h.body()
        meta = obj.get("metadata") or {}
        okey = ((ns or meta.get("namespace") or "") if nsd else "",
                name or meta.get("name", ""))
        obj["apiVersion"] = f"{key[0]}/{key[1]}" if key[0] else key[1]
        obj["kind"] = key[2]
        with self._lock:
            cur = self.store[key].get(okey)
            if method == "POST" and cur is not None:
                conflict = "already exists"
            elif method == "PUT" and cur is not None and (
                    meta.get("resourceVersion")
                    != cur["metadata"]["resourceVersion"]):
                conflict = "stale resourceVersion"
            else:
                conflict = None
                stamped = self._commit(
                    key, "ADDED" if cur is None else "MODIFIED", obj)
                self.store[key][okey] = stamped
        if conflict:
            return h.send_json(409, {"message": conflict})
        h.send_json(201 if method == "POST" else 200, stamped)

    def handle_delete(self, h, path):
        hit = self._resolve(path)
        if hit is None:
            return h.send_json(404, {"message": "unknown path"})
        key, _nsd, ns, name = hit
        with self._lock:
            gone = self.store[key].pop((ns, name), None)
            if gone is not None:
                self._commit(key, "DELETED", gone)
        if gone is None:
            return h.send_json(404, {"message": "not found"})
        h.send_json(200, {"status": "Success"})


def _register_constraint_kinds(api, kinds):
    for kind in kinds:
        api.register("constraints.gatekeeper.sh", "v1beta1", kind,
                     kind.lower() + "s", False)


def sync_pods_config():
    return {
        "apiVersion": "config.gatekeeper.sh/v1alpha1",
        "kind": "Config",
        "metadata": {"name": "config", "namespace": "gatekeeper-system"},
        "spec": {"sync": {"syncOnly": [
            {"group": "", "version": "v1", "kind": "Pod"}]}},
    }


def seed_api(api, n_pods: int, n_constraints: int, draws=None):
    """The smoke's policy (template_docs, constraint_docs(n_constraints)),
    a Config that syncs Pods, the 23 namespaces make_pod uses and n_pods
    pods (catalogue_pod with `draws`, else make_pod)."""
    templates = template_docs()
    _register_constraint_kinds(
        api, [t["spec"]["crd"]["spec"]["names"]["kind"] for t in templates])
    for t in templates:
        api.put(t)
    for c in constraint_docs(n_constraints):
        api.put(c)
    api.put(sync_pods_config())
    for k in range(23):
        api.put({"apiVersion": "v1", "kind": "Namespace",
                 "metadata": {"name": f"ns{k}"}})
    for i in range(n_pods):
        api.put(catalogue_pod(i, draws[i]) if draws is not None
                else make_pod(i))


def _api_child(conn, n_pods: int, n_constraints: int, catalogue: bool):
    """The ApiServer's process: seed it (catalogue pods drawn with
    RUNNER_SEED when `catalogue`), send its URL, then serve the parent's
    commands over `conn` until "close"."""
    import numpy as np

    api = ApiServer()
    draws = (np.random.default_rng(RUNNER_SEED).integers(
        0, IMAGE_CATALOGUE, size=(n_pods, 16)) if catalogue else None)
    seed_api(api, n_pods, n_constraints, draws)
    conn.send(api.url)
    while True:
        op, args = conn.recv()
        if op == "close":
            api.close()
            conn.send(None)
            return
        try:
            if op == "pods_with_image":
                out = sum(any(c["image"] in args[0]
                              for c in p["spec"]["containers"])
                          for p in api.objects("", "v1", "Pod"))
            elif op == "images":
                out = sorted({c["image"] for p in api.objects("", "v1", "Pod")
                              for c in p["spec"]["containers"]})
            elif op == "requests":
                out = dict(api.requests)
            else:
                out = getattr(api, op)(*args)
            conn.send(("ok", out))
        except Exception as e:  # the parent raises it
            conn.send(("error", repr(e)))


class ApiProcess:
    """An ApiServer in a process of its own, as a real apiserver is: its
    store, JSON encoding and HTTP threads stay out of the serving
    process's interpreter and heap. Seeded by seed_api; put, remove,
    objects and register run there over a pipe; pods_with_image(images)
    and images() answer from its pods."""

    def __init__(self, n_pods: int, n_constraints: int,
                 catalogue: bool = False):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self._proc = ctx.Process(
            target=_api_child, args=(child, n_pods, n_constraints, catalogue),
            daemon=True)
        self._proc.start()
        self._url = None

    @property
    def url(self) -> str:
        """The server's URL, once the process has seeded it."""
        if self._url is None:
            deadline = time.monotonic() + 600
            while not self._conn.poll(1.0):
                if not self._proc.is_alive() or time.monotonic() > deadline:
                    self._proc.kill()
                    raise AssertionError(
                        f"apiserver: no URL (exit {self._proc.exitcode})")
            self._url = self._conn.recv()
        return self._url

    def _call(self, op, *args):
        self.url  # seeded first
        self._conn.send((op, args))
        status, out = self._conn.recv()
        if status != "ok":
            raise AssertionError(f"apiserver: {op}: {out}")
        return out

    def put(self, obj):
        return self._call("put", obj)

    def remove(self, obj):
        return self._call("remove", obj)

    def objects(self, group, version, kind):
        return self._call("objects", group, version, kind)

    def register(self, *kind):
        return self._call("register", *kind)

    def pods_with_image(self, images) -> int:
        return self._call("pods_with_image", set(images))

    def images(self):
        return self._call("images")

    def requests(self):
        return self._call("requests")

    def close(self):
        if self._proc.is_alive():
            try:
                self._conn.send(("close", ()))
                self._conn.poll(30) and self._conn.recv()
            except OSError:
                pass
            self._proc.join(timeout=30)
        if self._proc.is_alive():
            self._proc.kill()
            self._proc.join(timeout=10)


def _secret_ca(api) -> bytes:
    """ca.crt of the fleet's one cert Secret on the stand-in."""
    import base64

    secrets = api.objects("", "v1", "Secret")
    if len(secrets) != 1 or set(secrets[0].get("data") or {}) != {
            "ca.crt", "tls.crt", "tls.key"}:
        raise AssertionError(
            f"stand-in: want one Secret with the ca.crt/tls.crt/tls.key "
            f"triple, got {[(s['metadata'], sorted(s.get('data') or {})) for s in secrets]}")
    return base64.b64decode(secrets[0]["data"]["ca.crt"])


def _https_context(api):
    """A client TLS context that trusts the CA of the Secret-backed cert
    store, the one CA every replica serves."""
    import ssl

    return ssl.create_default_context(cadata=_secret_ca(api).decode())


def _wait_for(pred, timeout: float, what: str, step: float = 0.1):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(step)
    if not pred():
        raise AssertionError(f"timed out after {timeout} s waiting for {what}")


def phase_runner(rec, full_counts, n_pods: int = 100_000,
                 n_constraints: int = 500, n_requests: int = 4096,
                 callers: int = 256, n_sample: int = 64, n_status: int = 20,
                 n_churn: int = 1000, api=None, device=None):
    """The process wiring at full width: an ApiServer holding the smoke's
    policy, a Config that syncs Pods and n_pods pods whose images come
    from the 5,000-image catalogue; build_runner(build_parser()
    .parse_args(...)) with --audit-from-cache, TLS in a temp --cert-dir,
    webhook, audit and status, and the process defaults otherwise: the
    verdict-integrity plane on, its shadow oracle sampling 1 in 8
    admissions. Boot to Ready
    and to the first sweep; the sweep's violations must equal the full
    phase's Client.audit results on the same pods (`full_counts`, per
    constraint; the catalogue changes no verdict; None skips the check),
    in total and for n_status sampled constraints, whose
    ConstraintPodStatus CRs the ApiServer holds; n_churn pods out and
    n_churn in through the ApiServer and a second sweep on the
    vocab-delta upload (K5), where a StackSampler attributes the sweep's
    host time; then HTTPS load (n_requests from `callers`), no failed,
    degraded or fail-policy answer, none past the 10 s request timeout,
    no shadow divergence, n_sample answers against the interpreter; the
    load's full collections, the shadow oracle's evaluations and the
    batches' dispatch seconds with and without an evaluation beside
    them (ServingOverlap). `api`: an ApiProcess already seeded with these
    pods and constraints (main starts it early, so its seeding overlaps
    earlier phases); `device` goes to build_runner (None: the card; a CPU
    rehearsal passes "cpu"). -> (launches, state for phase_extdata)."""
    import tempfile

    from gatekeeper_tpu_torch import run as runmod
    from gatekeeper_tpu_torch.kernels import ops
    from gatekeeper_tpu_torch.logs import StructuredLogger

    t0 = time.perf_counter()
    if api is None:
        api = ApiProcess(n_pods, n_constraints, catalogue=True)
    api.url  # seeded
    seed_s = time.perf_counter() - t0
    # the fleet plane's gossip kind (the cert Secret is served from the
    # start): the Runner boots on the process defaults, the Secret-backed
    # cert store and the fleet plane
    api.register(*FLEETSTATE_KIND)
    _step("runner", "apiserver seeded", t0)
    work = tempfile.mkdtemp(prefix="gk-smoke-runner-")
    args = runmod.build_parser().parse_args([
        "--kube-url", api.url, "--port", "0", "--health-addr-port", "0",
        "--audit-from-cache", "--audit-interval", "3600",
        "--cert-dir", os.path.join(work, "certs"), "--log-level", "error",
        "--agent-review", "--ingest", "on",
    ])
    rec.install()
    ops.reset_launches()
    t_boot = time.perf_counter()
    # the Runner's log goes to a file: a failing phase prints its tail
    log_file = open(os.path.join(work, "runner.log"), "w")
    cluster, runner = runmod.build_runner(
        args, log=StructuredLogger(level="error", stream=log_file),
        device=device)
    state = {"api": api, "cluster": cluster, "runner": runner,
             "log": log_file}
    try:
        client, drv = runner.client, runner.client._driver
        k8s_stats = state["k8s_stats"] = _keep_k8s_stats(drv)
        runner.start()
        if not runner.wait_ready(900):
            raise AssertionError(
                f"runner: not Ready: {runner.tracker.stats()}")
        ready_s = time.perf_counter() - t_boot
        _step("runner", "ready", t_boot)
        if not runner.wait_ready(900, warm=True):
            raise AssertionError("runner: the first audit sweep never ran")
        warm_s = time.perf_counter() - t_boot
        _step("runner", "first sweep", t_boot)
        sweep = {"seconds": runner.audit.audit_duration_seconds,
                 "phase_seconds": dict(k8s_stats.get("phase_seconds", {})),
                 "upload": _upload(k8s_stats)}
        report = runner.audit.sink.latest
        if full_counts is None:  # a probe: no full phase ran before
            full_counts = {k: st.total_violations
                           for k, st in report.statuses.items()}
        if report.total_violations != sum(full_counts.values()):
            raise AssertionError(
                f"runner: sweep found {report.total_violations} violations, "
                f"the full phase {sum(full_counts.values())}")
        # status: the Runner's ConstraintPodStatus CRs, and its audit
        # statuses against the full phase's Client.audit
        per = full_counts
        keys = sorted(report.statuses)
        sample_keys = keys[:: max(1, len(keys) // n_status)][:n_status]
        crs = {(o.get("status") or {}).get("constraintUID"): o["status"]
               for o in api.objects("status.gatekeeper.sh", "v1beta1",
                                    "ConstraintPodStatus")}
        for k in sample_keys:
            st = crs.get(k)
            if st is None or st["enforced"] is not True or st["errors"]:
                raise AssertionError(f"runner: status CR of {k}: {st}")
            if report.statuses[k].total_violations != per.get(k, 0):
                raise AssertionError(
                    f"runner: {k} audited {report.statuses[k].total_violations}"
                    f" violations, Client.audit {per.get(k, 0)}")
        _step("runner", "statuses checked", t_boot)
        # churn through the apiserver, then a sweep on the delta upload
        g0 = drv._data_gen
        for i in range(n_churn):
            api.remove(make_pod(i))
            api.put(churn_pod(i))
        _wait_for(lambda: drv._data_gen >= g0 + 2 * n_churn, 300,
                  "the churn to sync")
        t_c = time.perf_counter()
        _step("runner", "churn synced", t_boot)
        import threading

        sampler = StackSampler(threading.get_ident())
        try:
            churn_report = runner.audit.audit()
        finally:
            churn_profile = sampler.close()
        churn = {"seconds": time.perf_counter() - t_c,
                 "host_profile": churn_profile,
                 "phase_seconds": dict(k8s_stats.get("phase_seconds", {})),
                 "upload": _upload(k8s_stats),
                 "violations": churn_report.total_violations}
        print(json.dumps({"phase": "runner", "step": "churn swept",
                          "churn": churn}, default=float), flush=True)
        if not churn["upload"].get("delta_flushes"):
            raise AssertionError(
                f"runner: the churn sweep took no delta upload: "
                f"{churn['upload']}")
        # HTTPS admission from `callers` clients
        import gc

        plane = runner.integrity
        posts, requests = webhook_posts(7, n_requests)
        b0 = runner.webhook.batcher.batches_dispatched
        shadow0 = plane.snapshot()["shadow"]
        overlap = ServingOverlap(runner.webhook.batcher, plane)
        pauses = GcPauses()
        try:
            bodies, lat, wall = _drive_http(
                runner.webhook.port, posts, callers,
                ssl_ctx=_https_context(api))
        finally:
            gc_https = pauses.close()
            serving = overlap.close()
        batches = runner.webhook.batcher.batches_dispatched - b0
        _step("runner", "https load", t_boot)

        # let the oracle work through what the load sampled
        def settled(sh):
            return sh["evaluated"] + sh["skipped_stale"] + \
                sh["dropped"] >= sh["sampled"]

        deadline = time.monotonic() + 120
        while not settled(plane.snapshot()["shadow"]) and \
                time.monotonic() < deadline:
            time.sleep(0.1)
        shadow = {k: v - shadow0.get(k, 0)
                  if isinstance(v, (int, float)) and k != "sample_n" else v
                  for k, v in plane.snapshot()["shadow"].items()}
        https = {"requests": n_requests, "callers": callers,
                 "gc_threshold": list(gc.get_threshold()),
                 "gc_frozen": gc.get_freeze_count(),
                 "wall_s": wall, "rps": n_requests / wall,
                 "p50_s": _quantile(lat, 0.5),
                 "p99_s": _quantile(lat, 0.99), "max_s": max(lat),
                 **_first_request_split(lat, callers),
                 "batches": batches, "gc_collections": gc_https,
                 "shadow": shadow, "serving": serving}
        print(json.dumps({"phase": "runner", "step": "https load",
                          "https": https}, default=float), flush=True)
        state["https_p99_s"] = https["p99_s"]
        _check_served("runner", runner.webhook, runner.metrics, client,
                      requests)
        unavailable = sum(_unavailable(b) for b in bodies)
        late = sum(t > runner.webhook.request_timeout for t in lat)
        if unavailable or late or shadow.get("divergences"):
            raise AssertionError(
                f"runner: {unavailable} of {n_requests} answers were "
                f"the fail policy's, {late} came past the request "
                f"timeout, {shadow.get('divergences')} shadow divergences")
        oracle = _oracle(client)
        step = max(1, n_requests // n_sample)
        t_s = time.perf_counter()
        for i in range(0, n_requests, step):
            if _response_fields(bodies[i]) != _expected_response(
                    oracle, requests[i]):
                raise AssertionError(
                    f"runner: response to {requests[i]['uid']} differs from "
                    "the interpreter")
        sample_s = time.perf_counter() - t_s
        launches = dict(ops.LAUNCHES)
        # the flight recorder: a clean load trips nothing (no shed
        # burst, no SLO breach, no breaker)
        runner.recorder.flush()
        time.sleep(runner.recorder.debounce_s + 0.1)
        status, text = _http_get(
            f"http://127.0.0.1:{runner.readyz_port}/debug/flightrecords")
        flight = json.loads(text) if status == 200 else None
        if flight is None or flight["records"] or flight["suppressed"]:
            raise AssertionError(
                f"runner: /debug/flightrecords after a clean load: "
                f"{status} {text[:2000]}")
    except BaseException:
        _stop_runner(state)
        _print_tail(os.path.join(work, "runner.log"))
        raise
    finally:
        rec.remove()
    missing = [k for k in PATH_KERNELS["runner"] if launches[k] <= 0]
    if missing and drv.device.type == "cuda":
        raise AssertionError(f"runner: kernels never launched: {missing}")
    print(json.dumps({
        "phase": "runner", "pods": n_pods, "constraints": n_constraints,
        "images": IMAGE_CATALOGUE, "seed_seconds": seed_s,
        "boot_to_ready_s": ready_s, "boot_to_first_sweep_s": warm_s,
        "first_sweep": sweep, "violations": report.total_violations,
        "status_checked": len(sample_keys),
        "https": dict(https, sample_checked=len(range(0, n_requests, step)),
                      sample_seconds=sample_s),
        "churn": churn, "launches": launches,
        "flightrecords": {k: v for k, v in flight.items() if k != "records"},
        "apiserver_requests": api.requests(),
        "seconds": time.perf_counter() - t0,
    }, default=float), flush=True)
    return launches, state



# -- mutation: /v1/mutate on the Runner (config #5) --------------------------

POD_APPLY_TO = [{"groups": [""], "versions": ["v1"], "kinds": ["Pod"]}]

# (location, value, pathTests/assignIf parameters) of the 16 Assign
# mutators; the last two are the pair whose locations disagree in schema
ASSIGN_SPECS = (
    ("spec.containers[name: *].imagePullPolicy", "Always", None),
    ("spec.containers[name: *].securityContext.allowPrivilegeEscalation",
     False, None),
    ("spec.containers[name: *].securityContext.readOnlyRootFilesystem",
     True, None),
    ("spec.containers[name: *].securityContext.runAsNonRoot", True, None),
    ("spec.containers[name: *].securityContext.capabilities.drop", ["ALL"],
     None),
    ("spec.securityContext.seccompProfile.type", "RuntimeDefault", None),
    ("spec.securityContext.fsGroup", 2000, None),
    ("spec.priorityClassName", "standard", {"pathTests": [
        {"subPath": "spec.priorityClassName", "condition": "MustNotExist"}]}),
    ("spec.containers[name: c0].terminationMessagePolicy",
     "FallbackToLogsOnError", None),
    ("spec.dnsPolicy", "ClusterFirst", {"assignIf": {"notIn": ["Default"]}}),
    ("spec.enableServiceLinks", False, None),
    ("spec.automountServiceAccountToken", False, None),
    ("spec.terminationGracePeriodSeconds", 30, {"assignIf": {"in": [None]}}),
    ("spec.securityContext.runAsUser", 1000, {"pathTests": [
        {"subPath": "spec.volumes", "condition": "MustExist"}]}),
    ("spec.tolerations.key", "dedicated", None),
    ("spec.tolerations[key: dedicated].effect", "NoSchedule", None),
)
META_KEYS = ("owner", "cost-center", "team", "contact", "tier", "env",
             "data-class", "budget")


def _mutation_match(i: int):
    """Half of the mutators carry a labelSelector over labels make_pod
    emits (matchLabels; matchExpressions In, NotIn, Exists), a quarter
    namespaces or excludedNamespaces."""
    match = {}
    if i % 2 == 0:
        sel = [
            {"matchLabels": {"app": f"svc{i % 17}"}},
            {"matchExpressions": [{"key": "app", "operator": "In",
                                   "values": [f"svc{i % 17}",
                                              f"svc{(i + 5) % 17}"]}]},
            {"matchExpressions": [{"key": "owner", "operator": "NotIn",
                                   "values": [f"team{i % 5}"]}]},
            {"matchExpressions": [{"key": f"k{i % 4}",
                                   "operator": "Exists"}]},
        ][(i // 2) % 4]
        match["labelSelector"] = sel
    if i % 4 == 1:
        key = "namespaces" if i % 8 == 1 else "excludedNamespaces"
        match[key] = [f"ns{(i + j) % 23}" for j in range(6)]
    if i % 3 == 0:
        match["kinds"] = [{"apiGroups": [""], "kinds": ["Pod"]}]
    return match


def mutation_docs():
    """48 mutators modeled on docs/mutation.md: 16 Assign (container and
    pod securityContext fields, imagePullPolicy; some with pathTests or
    assignIf), 16 AssignMetadata (owner, cost-center and other labels and
    annotations), 16 ModifySet (container args); two of the Assign
    mutators disagree in schema (spec.tolerations as an object and as a
    keyed list), so both are quarantined."""
    docs = []
    for i, (loc, value, params) in enumerate(ASSIGN_SPECS):
        docs.append({"apiVersion": "mutations.gatekeeper.sh/v1alpha1",
                     "kind": "Assign", "metadata": {"name": f"assign-{i:02d}"},
                     "spec": {"applyTo": POD_APPLY_TO, "location": loc,
                              "match": _mutation_match(i),
                              "parameters": {"assign": {"value": value},
                                             **(params or {})}}})
    for i in range(16):
        field = "labels" if i < 8 else "annotations"
        docs.append({"apiVersion": "mutations.gatekeeper.sh/v1alpha1",
                     "kind": "AssignMetadata",
                     "metadata": {"name": f"meta-{i:02d}"},
                     "spec": {"location": f"metadata.{field}."
                                          f"{META_KEYS[i % 8]}",
                              "match": _mutation_match(i + 16),
                              "parameters": {"assign": {
                                  "value": f"{META_KEYS[i % 8]}-{i}"}}}})
    for i in range(16):
        prune = i >= 14  # values no merge adds
        docs.append({"apiVersion": "mutations.gatekeeper.sh/v1alpha1",
                     "kind": "ModifySet",
                     "metadata": {"name": f"args-{i:02d}"},
                     "spec": {"applyTo": POD_APPLY_TO,
                              "location": "spec.containers[name: *].args",
                              "match": _mutation_match(i + 32),
                              "parameters": {
                                  "operation": "prune" if prune else "merge",
                                  "values": {"fromList": [
                                      f"--debug-{i}" if prune
                                      else f"--flag-{i}=on"]}}}})
    return docs


def phase_mutation(rec, state, n_requests: int = 2048, callers: int = 256,
                   n_check_batches: int = 4):
    """/v1/mutate on the runner phase's Runner at config #5: the 48
    mutators of mutation_docs() applied through the ApiServer and
    ingested by the Runner's watches (the conflicting pair quarantined,
    its MutatorPodStatus errors); n_requests Pod CREATEs of make_pod over
    HTTPS from `callers` clients. Every patch must equal the port's host
    path (screen_host, apply, json_patch) on the same review, the screen
    matrices of the first n_check_batches batches equal screen_host row
    by row, no answer fail open or come past the request timeout, one K1
    launch per batch, and K1 held bit for bit against its plain version
    on each recorded screen input (live label and namespace selectors),
    with its device time, the plain version's and its bound.
    -> (launches, the K1 figures of the screen's shape)."""
    import base64

    import torch
    from gatekeeper_tpu_torch.kernels import ops
    from gatekeeper_tpu_torch.mutation import json_patch

    t0 = time.perf_counter()
    api, runner = state["api"], state["runner"]
    system = runner.mutation_system
    docs = mutation_docs()
    for d in docs:
        api.put(d)
    _wait_for(lambda: system.count() == len(docs), 120,
              "the mutators to ingest")
    conflicts = system.conflicts()
    quarantined = sorted(conflicts)
    want_q = ["Assign/assign-14", "Assign/assign-15"]
    statuses = {o["status"]["mutatorUID"]: o["status"] for o in api.objects(
        "status.gatekeeper.sh", "v1beta1", "MutatorPodStatus")}
    # the status of the mutator whose ingest brought the conflict names
    # it (the reference's MutatorController publishes the ingested one)
    if quarantined != want_q or not any(
            statuses.get(k, {}).get("enforced") is False and
            statuses[k]["errors"][0]["code"] == "schema_conflict"
            for k in want_q) or any(m.id in want_q for m in system.ordered()):
        raise AssertionError(f"mutation: quarantine {conflicts}, statuses "
                             f"{[statuses.get(k) for k in want_q]}")
    active = system.ordered()
    # the screen's inputs and matrices of the first batches
    screens = []
    inner = system.screen

    def recorded(reviews, *a, **kw):
        muts, mat = inner(reviews, *a, **kw)
        if len(screens) < n_check_batches:
            screens.append((list(reviews), [m.id for m in muts], mat.copy()))
        return muts, mat

    system.screen = recorded
    k1_inputs = []  # the first batches' and the widest batch's
    k1 = ops.match_matrix

    def k1_kept(ms, fb):
        n = fb["group_id"].shape[0]
        if len(k1_inputs) <= n_check_batches or \
                n > k1_inputs[-1][1]["group_id"].shape[0]:
            kept = (ms, {k: v.clone() for k, v in fb.items()})
            if len(k1_inputs) > n_check_batches:
                k1_inputs[-1] = kept
            else:
                k1_inputs.append(kept)
        return k1(ms, fb)

    reqs = []
    for j in range(n_requests):
        pod = make_pod(5_000_000 + j, name=f"mut-{j}")
        reqs.append(admission_request(pod, f"mut-{j}"))
    posts = [("/v1/mutate", _envelope(r)) for r in reqs]
    mb = runner.webhook.mutate_batcher
    b0, f0 = mb.batches_dispatched, mb.batch_failures
    d0 = system.screen_dispatches
    ops.reset_launches()
    ops.match_matrix = k1_kept
    try:
        bodies, lat, wall = _drive_http(
            runner.webhook.port, posts, callers,
            ssl_ctx=_https_context(state["api"]))
    finally:
        ops.match_matrix = k1
        del system.screen
    launches = dict(ops.LAUNCHES)
    batches = mb.batches_dispatched - b0
    screen_n = system.screen_dispatches - d0
    # every answer against the host path on the same review
    t_c = time.perf_counter()
    mutated = fail_open = 0
    for req, body in zip(reqs, bodies):
        resp = body["response"]
        if _unavailable(body) or not resp["allowed"]:
            fail_open += 1
            continue
        review = dict(req)
        ns_obj = runner._get_namespace(req["namespace"])
        if ns_obj is not None:
            review["_unstable"] = {"namespace": ns_obj}
        muts, mat = system.screen_host([review])
        chosen = [m for j, m in enumerate(muts) if mat[j, 0]]
        want = []
        if chosen:
            after, _ = system.apply(req["object"], review, chosen)
            want = json_patch(req["object"], after)
        got = json.loads(base64.b64decode(resp["patch"])) \
            if "patch" in resp else []
        if got != want:
            raise AssertionError(
                f"mutation: the patch of {req['uid']} differs from the "
                f"host path: {got} != {want}")
        mutated += bool(got)
    rows_checked = 0
    for reviews, ids, mat in screens:
        muts_h, mat_h = system.screen_host(reviews)
        if ids != [m.id for m in muts_h] or not (mat == mat_h).all():
            raise AssertionError("mutation: a screen matrix differs from "
                                 "screen_host")
        rows_checked += mat.shape[0]
    check_s = time.perf_counter() - t_c
    # K1 on the screen's own inputs: bit for bit against its plain version
    k1_row = None
    for ms, fb in k1_inputs:
        out_k, out_p = ops.match_matrix(ms, fb), ops.match_matrix_plain(ms, fb)
        if out_k.dtype != out_p.dtype or not torch.equal(out_k, out_p):
            raise AssertionError("mutation: K1 differs from its plain version")
    if k1_inputs and k1_inputs[0][0]["kind_rows"].is_cuda:
        ms, fb = max(k1_inputs, key=lambda a: a[1]["group_id"].shape[0])
        out = ops.match_matrix(ms, fb)
        bound_ms, bound_by, bytes_ms, ops_ms = _bound(
            "match_matrix", (ms, fb), out)
        k1_row = {"shape": list(out.shape), "launches": launches.get(
            "match_matrix", 0), "max_abs_err": 0.0,
            "ms": _device_ms(lambda: ops.match_matrix(ms, fb),
                             KERNEL_FUNCS["match_matrix"]),
            "host_ms": _time_ms(lambda: ops.match_matrix(ms, fb)),
            "plain_ms": _device_ms(lambda: ops.match_matrix_plain(ms, fb),
                                   reps=3),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes_ms": bytes_ms, "operations_ms": ops_ms,
            "library_ms": None, "inputs_checked": len(k1_inputs),
            "selector_reads": int(ops.match_flags(
                {k: v.cpu().numpy() for k, v in ms.items()})[1])}
    live = sum("labelSelector" in (m.match or {}) for m in active)
    out = {
        "phase": "mutation", "mutators": len(docs), "active": len(active),
        "with_label_selector": live, "quarantined": quarantined,
        "quarantine_statuses": [statuses.get(k) for k in want_q],
        "requests": n_requests, "callers": callers, "wall_s": wall,
        "rps": n_requests / wall, "p50_s": _quantile(lat, 0.5),
        "p99_s": _quantile(lat, 0.99), "max_s": max(lat),
        **_first_request_split(lat, callers),
        "batches": batches, "occupancy": n_requests / max(1, batches),
        "screen_dispatches": screen_n, "mutated": mutated,
        "fail_open": fail_open, "batch_failures": mb.batch_failures - f0,
        "screen_rows_checked": rows_checked, "check_seconds": check_s,
        "launches": launches, "k1": k1_row,
        "seconds": time.perf_counter() - t0,
    }
    print(json.dumps(out, default=float), flush=True)
    late = sum(t > runner.webhook.request_timeout for t in lat)
    if fail_open or late or mb.batch_failures - f0 or not mutated:
        raise AssertionError(f"mutation: {fail_open} answers fail open or "
                             f"errors, {late} past the timeout, "
                             f"{mb.batch_failures - f0} failed batches")
    if live < 8 or len(screens) < n_check_batches:
        raise AssertionError("mutation: too few live selectors or screens")
    on_card = runner.client._driver.device.type == "cuda"
    if on_card and (launches.get("match_matrix", 0) != screen_n
                    or k1_row is None):
        raise AssertionError(
            f"mutation: {launches.get('match_matrix')} K1 launches for "
            f"{screen_n} screens")
    return launches, k1_row


class GcPauses:
    """Wall seconds of each CPython collection while installed, by
    generation: the stalls a request waits through beside its batch
    (count, sum_s and max_s are the full, generation-2 ones)."""

    def __init__(self):
        import gc

        self._gc = gc
        self.pauses = {0: [], 1: [], 2: []}
        self._t = None
        gc.callbacks.append(self._cb)

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.pauses[info["generation"]].append(
                time.perf_counter() - self._t)
            self._t = None

    def close(self):
        self._gc.callbacks.remove(self._cb)
        full = self.pauses[2]
        return {"count": len(full), "sum_s": sum(full),
                "max_s": max(full, default=0.0),
                "young": {str(g): {"count": len(p), "sum_s": sum(p)}
                          for g, p in self.pauses.items() if g < 2}}


class StackSampler:
    """Samples one thread's Python stack every `interval` seconds from a
    thread of its own while installed: where a stretch of host time went,
    as shares of the samples by function (inclusive: anywhere on the
    stack; leaf: the innermost frame)."""

    def __init__(self, thread_id: int, interval: float = 0.005):
        import threading

        self.tid, self.interval = thread_id, interval
        self.samples = 0
        self.inclusive, self.leaf = {}, {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    @staticmethod
    def _name(code) -> str:
        path = code.co_filename
        short = path.split("gatekeeper_tpu_torch" + os.sep, 1)[-1] \
            if "gatekeeper_tpu_torch" in path else os.path.basename(path)
        return f"{short}:{code.co_name}"

    def _run(self):
        while not self._stop.wait(self.interval):
            frame = sys._current_frames().get(self.tid)
            if frame is None:
                continue
            self.samples += 1
            self.leaf[self._name(frame.f_code)] = \
                self.leaf.get(self._name(frame.f_code), 0) + 1
            seen = set()
            while frame is not None:
                name = self._name(frame.f_code)
                if name not in seen:
                    seen.add(name)
                    self.inclusive[name] = self.inclusive.get(name, 0) + 1
                frame = frame.f_back

    def close(self, top: int = 14) -> dict:
        self._stop.set()
        self._thread.join(timeout=5)
        n = max(1, self.samples)

        def head(d):
            return [[k, round(v / n, 4)] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"samples": self.samples, "interval_s": self.interval,
                "inclusive": head(self.inclusive), "leaf": head(self.leaf)}


class ServingOverlap:
    """Wall intervals (perf_counter, one clock for the processes of a
    host) of a webhook batcher's dispatches while installed, and of the
    integrity plane's shadow-oracle evaluations beside them
    (`plane.shadow_intervals`): how long a batch takes from dispatch to
    resolve when an oracle evaluation overlaps it, against when none
    does."""

    def __init__(self, batcher, plane=None):
        self.batcher, self.plane = batcher, plane
        self.batches = []
        inner = batcher._dispatch

        def timed_dispatch(batch):
            t = time.perf_counter()
            try:
                return inner(batch)
            finally:
                self.batches.append((t, time.perf_counter(), len(batch)))

        batcher._dispatch = timed_dispatch

    def close(self) -> dict:
        self.batcher.__dict__.pop("_dispatch", None)
        t0 = min((b[0] for b in self.batches), default=0.0)
        evals = sorted(iv for iv in list(getattr(
            self.plane, "shadow_intervals", ())) if iv[1] >= t0)

        def stats(xs):
            xs = sorted(xs)
            return {"n": len(xs), "sum_s": sum(xs),
                    "p50_s": _quantile(xs, 0.5) if xs else None,
                    "p99_s": _quantile(xs, 0.99) if xs else None,
                    "max_s": max(xs, default=None)}

        over, clear = [], []
        for t0, t1, _ in self.batches:
            hit = any(e0 < t1 and e1 > t0 for e0, e1 in evals)
            (over if hit else clear).append(t1 - t0)
        return {"oracle_evals": stats([e1 - e0 for e0, e1 in evals]),
                "dispatch_overlapping": stats(over),
                "dispatch_clear": stats(clear)}


def _first_request_split(lat, callers: int) -> dict:
    """p50/p99 of each connection's first request (which carries its TLS
    handshake and waits for the listener to accept it) and of the rest;
    _drive_http's worker k sends requests k, k + callers, ..."""
    first, rest = lat[:callers], lat[callers:]
    out = {"first_p50_s": _quantile(first, 0.5),
           "first_p99_s": _quantile(first, 0.99)}
    if rest:
        out.update(later_p50_s=_quantile(rest, 0.5),
                   later_p99_s=_quantile(rest, 0.99))
    return out


def _step(phase: str, step: str, since: float) -> None:
    """A progress line: a long phase that fails still shows how far it
    came and when."""
    print(json.dumps({"phase": phase, "step": step,
                      "seconds": time.perf_counter() - since}), flush=True)


def _print_tail(path: str, n: int = 20) -> None:
    try:
        with open(path) as f:
            lines = f.readlines()
    except OSError:
        return
    sys.stderr.write("".join(lines[-n:]))


def _stop_runner(state):
    runner = state.get("runner")
    if runner is not None:
        runner.stop()
    for stub in ("stub", "agent_stub"):
        if state.get(stub) is not None:
            state[stub].close()
    if state.get("cluster") is not None:
        state["cluster"].stop()
    if state.get("api") is not None:
        state["api"].close()
    if state.get("log") is not None:
        state["log"].close()


class StubProvider:
    """A localhost external-data provider (stdlib HTTP) speaking the
    ProviderRequest/ProviderResponse protocol: keys in `flagged` get an
    error entry, others a value; `requests` keeps each fetch's keys."""

    def __init__(self, flagged):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.flagged = set(flagged)
        self.requests = []
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):  # noqa: N802
                n = int(self.headers.get("Content-Length", 0))
                keys = (json.loads(self.rfile.read(n)).get("request") or {}
                        ).get("keys") or []
                stub.requests.append(list(keys))
                items = [{"key": k, "error": "signature not found"}
                         if k in stub.flagged else {"key": k, "value": "ok"}
                         for k in keys]
                payload = json.dumps({
                    "apiVersion": "externaldata.gatekeeper.sh/v1alpha1",
                    "kind": "ProviderResponse",
                    "response": {"items": items, "systemError": ""},
                }).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}/verify"
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(timeout=10)


class FetchLog:
    """Wraps an ExternalDataSystem's fetcher: the thread and key count of
    every outbound fetch, so a count can leave out the integrity plane's
    shadow oracle, which re-checks sampled answers on its own thread."""

    def __init__(self, system):
        self.inner = system.fetcher
        self.calls = []
        system.fetcher = self

    def fetch(self, provider, keys):
        import threading

        self.calls.append((threading.current_thread().name, len(keys)))
        return self.inner.fetch(provider, keys)

    def since(self, n0: int):
        """Fetches after the first n0, the shadow oracle's left out."""
        return [k for name, k in self.calls[n0:] if name != "integrity-shadow"]


def phase_extdata(rec, state, n_requests: int = 1024, callers: int = 256,
                  batch: int = 256, flag_share: float = 0.01):
    """External data on the runner phase's Runner: a localhost StubProvider
    that flags flag_share of the 5,000 catalogue images; a Provider CR and
    an error-gated image-verification template and constraint applied
    through the ApiServer (ProviderController, TemplateController), at the
    provider's default maxKeysPerRequest (512). One sweep fetches its keys
    in ceil(keys / 512) requests, its violations equal the pods with a
    flagged image; two loads of n_requests AdmissionReviews over HTTPS
    from `callers` clients, micro-batched by the webhook, make at most one
    fetch per batch, the second (only images the sweep fetched) none; a
    review_many of `batch` clean pods renders no pair of the
    external-data kind on the interpreter; the provider then flags some of
    its images: inside the TTL the batch still passes without a fetch,
    past it the batch refetches (ceil(keys / 512) requests) and its rows
    with those images route back to the interpreter and violate. The
    provider and the fetch log stay in `state` for the fleet phase
    (_stop_runner closes the provider). -> launches."""
    import numpy as np

    from gatekeeper_tpu_torch.kernels import ops

    t0 = time.perf_counter()
    api, runner = state["api"], state["runner"]
    client, drv = runner.client, runner.client._driver
    k8s_stats = state["k8s_stats"]
    rng = np.random.default_rng(RUNNER_SEED + 1)
    flagged = {catalogue_image(int(k)) for k in rng.choice(
        IMAGE_CATALOGUE, int(IMAGE_CATALOGUE * flag_share), replace=False)}
    stub = state["stub"] = StubProvider(flagged)
    fetches = state["fetches"] = FetchLog(runner.external_data)
    rec.install()
    try:
        ops.reset_launches()
        _register_constraint_kinds(api, [EXT_KIND])
        api.put({"apiVersion": "externaldata.gatekeeper.sh/v1alpha1",
                 "kind": "Provider", "metadata": {"name": EXT_PROVIDER},
                 "spec": {"url": stub.url, "timeout": 30,
                          "failurePolicy": "Fail", "cacheTTLSeconds": 600,
                          "negativeCacheTTLSeconds": 600}})
        api.put({"apiVersion": "templates.gatekeeper.sh/v1beta1",
                 "kind": "ConstraintTemplate",
                 "metadata": {"name": EXT_KIND.lower()},
                 "spec": {"crd": {"spec": {"names": {"kind": EXT_KIND}}},
                          "targets": [{"target": TARGET, "rego": EXT_REGO}]}})
        api.put({"apiVersion": "constraints.gatekeeper.sh/v1beta1",
                 "kind": EXT_KIND, "metadata": {"name": "verify-images"},
                 "spec": {"match": {"kinds": [
                     {"apiGroups": [""], "kinds": ["Pod"]}]}}})
        _wait_for(lambda: runner.external_data.get(EXT_PROVIDER) is not None
                  and any(c.get("kind") == EXT_KIND
                          for c in drv._constraints(TARGET)),
                  120, "the provider and constraint to ingest")
        want = api.pods_with_image(flagged)
        key = f"{EXT_KIND}/verify-images"
        feature = f"extdata:{EXT_KIND}:err"

        def sweep():
            f0 = len(fetches.calls)
            t = time.perf_counter()
            rep = runner.audit.audit()
            made = fetches.since(f0)
            return {"seconds": time.perf_counter() - t,
                    "phase_seconds": dict(k8s_stats.get("phase_seconds", {})),
                    "fetches": len(made), "keys": sum(made),
                    "violations": rep.statuses[key].total_violations
                    if key in rep.statuses else 0,
                    "interp_rendered_pairs": k8s_stats["interp_rendered_pairs"]}

        first = sweep()
        # the screen's bits from the live cache (no fetch: keys cached)
        f0 = len(fetches.calls)
        flagged_rows = int(np.asarray(drv._extdata_row_bits(
            TARGET, drv._corpus[TARGET], feature)).sum())
        if fetches.since(f0):
            raise AssertionError("extdata: the bits of a warm sweep fetched")
        # the provider's default maxKeysPerRequest: one epoch's keys go
        # out in ceil(keys / max_keys) requests
        max_keys = runner.external_data.get(EXT_PROVIDER).max_keys
        per_sweep = -(-first["keys"] // max_keys)
        first["max_keys"] = max_keys
        state["extdata_sweep_keys"] = first["keys"]
        if first["fetches"] != per_sweep or first["violations"] != want:
            raise AssertionError(
                f"extdata: sweep made {first['fetches']} fetches and "
                f"{first['violations']} violations, want {per_sweep} and "
                f"{want}")
        # micro-batches over HTTPS, two loads from `callers` clients:
        # the first also carries images the provider never saw, the
        # second only images the sweep fetched
        seen = api.images()
        ctx = _https_context(api)
        rounds = []
        for b in range(2):
            posts, reqs = [], []
            for j in range(n_requests):
                pod = make_pod(3_000_000 + b * n_requests + j,
                               name=f"ext-{b}-{j}")
                for c, ctr in enumerate(pod["spec"]["containers"]):
                    ctr["image"] = seen[int(rng.integers(len(seen)))]
                if b == 0 and j % 8 == 0:
                    pod["spec"]["containers"][0]["image"] = (
                        f"nginx/novel{b}x{j}:v1")
                req = admission_request(pod, f"ext-{b}-{j}")
                reqs.append(req)
                posts.append(("/v1/admit", _envelope(req)))
            f0 = len(fetches.calls)
            b0 = runner.webhook.batcher.batches_dispatched
            bodies, lat, wall = _drive_http(runner.webhook.port, posts,
                                            callers, ssl_ctx=ctx)
            made = len(fetches.since(f0))
            batches = runner.webhook.batcher.batches_dispatched - b0
            if any(_unavailable(body) for body in bodies):
                raise AssertionError(
                    f"extdata: load {b}: fail-policy answers")
            denied = sum(not body["response"]["allowed"] for body in bodies)
            want_denied = sum(
                any(c["image"] in flagged
                    for c in r["object"]["spec"]["containers"])
                for r in reqs)
            rounds.append({"requests": n_requests, "callers": callers,
                           "batches": batches, "fetches": made,
                           "denied": denied, "p50_s": _quantile(lat, 0.5),
                           "p99_s": _quantile(lat, 0.99), "wall_s": wall})
            if made > batches or (b == 1 and made):
                raise AssertionError(f"extdata: load {b}: {rounds[-1]}")
            if denied < want_denied:
                raise AssertionError(
                    f"extdata: load {b} denied {denied} of {want_denied} "
                    "requests with a flagged image")
        _check_served("extdata", runner.webhook, runner.metrics, client, [])
        # a fully cache-hit batch: no interpreter pair of the kind
        clean = sorted(set(seen) - flagged)
        objs = []
        from gatekeeper_tpu_torch.constraint import AugmentedUnstructured

        for j in range(batch):
            pod = make_pod(4_000_000 + j, name=f"clean-{j}")
            for c, ctr in enumerate(pod["spec"]["containers"]):
                ctr["image"] = clean[(j * 16 + c) % len(clean)]
            objs.append(AugmentedUnstructured(pod))
        by_kind = {}
        render = drv._eval_template
        import threading

        me = threading.get_ident()

        def counted(target, constraint, *a, **kw):
            # this batch's renders only: the integrity plane's shadow
            # oracle re-checks earlier requests on its own thread
            if threading.get_ident() == me:
                kind = constraint["kind"]
                by_kind[kind] = by_kind.get(kind, 0) + 1
            return render(target, constraint, *a, **kw)

        f0 = len(fetches.calls)
        drv._eval_template = counted
        try:
            out = client.review_many(objs)
        finally:
            del drv._eval_template
        cache_hit = {"fetches": len(fetches.since(f0)),
                     "interp_pairs_by_kind": by_kind,
                     "ext_results": sum(
                         r.constraint["kind"] == EXT_KIND
                         for o in out for r in o.by_target[TARGET].results)}
        if cache_hit["fetches"] or by_kind.get(EXT_KIND) or \
                cache_hit["ext_results"]:
            raise AssertionError(f"extdata: cache-hit batch: {cache_hit}")
        # TTL: the provider flags images the batch above carried clean;
        # inside the TTL the cache keeps answering clean, past it the
        # batch refetches, and only row bits computed from the live cache
        # (never cached on the corpus or the card) send those rows to the
        # interpreter's re-check
        carried = sorted({ctr["image"] for o in objs
                          for ctr in o.object["spec"]["containers"]})
        more = set(carried[::7])
        stub.flagged |= more

        def ext_denied(out):
            return sum(any(r.constraint["kind"] == EXT_KIND
                           for r in o.by_target[TARGET].results) for o in out)

        f0 = len(fetches.calls)
        inside = ext_denied(client.review_many(objs))
        inside_fetches = len(fetches.since(f0))
        cache = runner.external_data.cache
        clock = cache._clock
        cache._clock = lambda: clock() + 3600.0
        try:
            f0 = len(fetches.calls)
            after = ext_denied(client.review_many(objs))
            after_fetches = fetches.since(f0)
        finally:
            cache._clock = clock
        want2 = sum(any(ctr["image"] in more
                        for ctr in o.object["spec"]["containers"])
                    for o in objs)
        ttl = {"newly_flagged_images": len(more), "inside_ttl": inside,
               "inside_fetches": inside_fetches, "past_ttl": after,
               "past_fetches": len(after_fetches),
               "past_keys": sum(after_fetches), "want": want2}
        if inside or inside_fetches or after != want2 or not want2 or \
                len(after_fetches) != -(-sum(after_fetches) // max_keys):
            raise AssertionError(f"extdata: TTL: {ttl}")
        launches = dict(ops.LAUNCHES)
    finally:
        rec.remove()
    missing = [k for k in PATH_KERNELS["extdata"] if launches[k] <= 0]
    if missing and drv.device.type == "cuda":
        raise AssertionError(f"extdata: kernels never launched: {missing}")
    print(json.dumps({
        "phase": "extdata", "images": IMAGE_CATALOGUE,
        "flagged_images": len(flagged), "pods_flagged": want,
        "first_sweep": first, "screen_flagged_rows": flagged_rows,
        "micro_batches": rounds, "cache_hit_batch": cache_hit,
        "ttl": ttl,
        "shadow_fetches": sum(name == "integrity-shadow"
                              for name, _ in fetches.calls),
        "provider_requests": len(stub.requests),
        "launches": launches, "seconds": time.perf_counter() - t0,
    }, default=float), flush=True)
    return launches


# -- agent: /v1/agent/review on the Runner (config #5 beside it) -------------

AGENT_TARGET = "agent.action.gatekeeper.sh"
AGENT_PROVIDER = "skill-registry"
AGENT_SEED = 20261018
AGENT_SHELL_REGO = """package agentshellallowlist
allowed_cmd(c) { c == input.parameters.allowed[_] }
violation[{"msg": msg}] {
  cmd := input.review.object.spec.arguments.command
  not allowed_cmd(cmd)
  msg := sprintf("shell command <%v> is outside the allowlist", [cmd])
}
"""
AGENT_SIGNED_REGO = """package agentrequiresignedskills
violation[{"msg": msg}] {
  not input.review.object.spec.skill.signed
  msg := sprintf("tool <%v> was invoked from an unsigned skill", [input.review.object.spec.tool])
}
"""
AGENT_VERIFIED_REGO = """package agentverifiedskills
violation[{"msg": msg}] {
  response := external_data({"provider": "skill-registry", "keys": [input.review.object.spec.skill.digest]})
  count(response.errors) > 0
  msg := sprintf("skill signature verification failed: %v", [response.errors])
}
"""
# the three agent templates of tests/test_agentaction.py, by kind
AGENT_TEMPLATES = (("AgentShellAllowlist", AGENT_SHELL_REGO),
                   ("AgentRequireSignedSkills", AGENT_SIGNED_REGO),
                   ("AgentVerifiedSkills", AGENT_VERIFIED_REGO))
AGENT_NAMESPACES = ("shell", "net", "fs", "git", "db", "browser", "mail",
                    "cloud")
AGENT_LEAVES = ("exec", "run", "fetch", "read", "write")
AGENT_CAPS = ("exec", "net", "fs", "read", "write")
AGENT_ALLOWED = ("ls", "cat", "git", "echo")
AGENT_COMMANDS = AGENT_ALLOWED + ("rm", "curl")
N_AGENTS = 64
N_DIGESTS = 512


def skill_digest(k: int) -> str:
    return f"sha256:{k:064x}"


def agent_template_docs():
    return [{"apiVersion": "templates.gatekeeper.sh/v1beta1",
             "kind": "ConstraintTemplate", "metadata": {"name": kind.lower()},
             "spec": {"crd": {"spec": {"names": {"kind": kind}}},
                      "targets": [{"target": AGENT_TARGET, "rego": rego}]}}
            for kind, rego in AGENT_TEMPLATES]


def _agent_match(i: int):
    """Constraint i's match block: tool globs `*`, `ns.*` and exact
    names, agents and excludedAgents, capability and skill selectors."""
    ns = AGENT_NAMESPACES[i % len(AGENT_NAMESPACES)]
    nxt = AGENT_NAMESPACES[(i + 1) % len(AGENT_NAMESPACES)]
    m = {"tools": (["*"], [f"{ns}.*"],
                   [f"{ns}.{AGENT_LEAVES[i % len(AGENT_LEAVES)]}",
                    f"{nxt}.*"])[i % 3]}
    if i % 4 == 1:
        m["agents"] = [f"agent-{j}" for j in range(i % 4, N_AGENTS, 4)]
    if i % 4 == 2:
        m["excludedAgents"] = [f"agent-{j}" for j in range(0, N_AGENTS, 8)]
    if i % 5 == 3:
        m["capabilities"] = {"matchExpressions": [
            {"key": "exec", "operator": "Exists"}]}
    if i % 5 == 4:
        m["skills"] = {"matchLabels": {"publisher": "acme"}}
    if i % 5 == 0 and i:
        m["skills"] = {"matchExpressions": [
            {"key": "publisher", "operator": "NotIn",
             "values": ["first-party"]}]}
    return m


def agent_constraint_docs(per_template: int = 10):
    out = []
    for t, (kind, _) in enumerate(AGENT_TEMPLATES):
        for i in range(per_template):
            spec = {"match": _agent_match(t * per_template + i)}
            if kind == "AgentShellAllowlist":
                spec["parameters"] = {"allowed": list(
                    AGENT_ALLOWED[: 2 + i % 3])}
            out.append({"apiVersion": "constraints.gatekeeper.sh/v1beta1",
                        "kind": kind,
                        "metadata": {"name": f"{kind.lower()}-{i}"},
                        "spec": spec})
    return out


def agent_records(seed: int, n: int, tag: str):
    """n tool-call records in the soak harness's shape
    (gatekeeper_tpu/soak/harness.py `_body`, plane "agent") over 64
    agents, 8 tool namespaces and 512 registry digests, 1 in 4 skills
    unsigned."""
    import numpy as np

    r = np.random.default_rng(seed)
    out = []
    for i in range(n):
        caps = [c for c in AGENT_CAPS if r.random() < 0.4] or ["exec"]
        out.append({
            "uid": f"{tag}-{i}", "id": f"{tag}-{i}",
            "agent": f"agent-{int(r.integers(N_AGENTS))}",
            "session": f"s-{int(r.integers(11))}",
            "tool": f"{AGENT_NAMESPACES[int(r.integers(8))]}."
                    f"{AGENT_LEAVES[int(r.integers(5))]}",
            "arguments": {"command": AGENT_COMMANDS[
                int(r.integers(len(AGENT_COMMANDS)))]},
            "capabilities": caps,
            "skill": {"name": f"skill-{int(r.integers(32))}",
                      "publisher": ("acme", "first-party", "community")[
                          int(r.integers(3))],
                      "signed": bool(i % 4),
                      "digest": skill_digest(int(r.integers(N_DIGESTS)))},
        })
    return out


def _agent_envelope(record) -> bytes:
    return json.dumps({"apiVersion": "agentaction.gatekeeper.sh/v1",
                       "kind": "AgentActionReview",
                       "request": record}).encode()


def default_timeout_assign():
    """The Assign of tests/test_agentaction.py: a 30 s timeout on every
    shell.exec call that sets none."""
    return {
        "apiVersion": "mutations.gatekeeper.sh/v1alpha1",
        "kind": "Assign", "metadata": {"name": "default-timeout"},
        "spec": {
            "applyTo": [{"groups": ["shell"], "versions": ["v1"],
                         "kinds": ["exec"]}],
            "match": {"tools": ["shell.*"]},
            "location": "spec.arguments.timeoutSeconds",
            "parameters": {
                "pathTests": [{"subPath": "spec.arguments.timeoutSeconds",
                               "condition": "MustNotExist"}],
                "assign": {"value": 30},
            },
        },
    }


class ReadyzWatch:
    """Polls a replica's /readyz every `step` seconds until closed: keeps
    each HTTP status other than 200, and counts polls that got no answer
    within 10 s."""

    def __init__(self, port: int, step: float = 0.5):
        import threading

        self.port, self.step = port, step
        self.polls, self.bad, self.unanswered = 0, [], 0
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while not self._stop.wait(self.step):
            status, _ = _http_get(f"http://127.0.0.1:{self.port}/readyz")
            self.polls += 1
            if status is None:
                self.unanswered += 1
            elif status != 200:
                self.bad.append(status)

    def close(self):
        self._stop.set()
        self._t.join(timeout=30)
        return {"polls": self.polls, "not_200": self.bad,
                "unanswered": self.unanswered}


def _expected_agent_response(oracle, record):
    """The interpreter's answer for a tool-call record, as
    AgentReviewHandler renders it."""
    from gatekeeper_tpu_torch.agentaction import AgentAction

    res = oracle.review_host(AgentAction.from_record(record))
    return _response_of(res.by_target[AGENT_TARGET].results)


def _load_stats(lat, wall, n, batches, bodies):
    return {"requests": n, "wall_s": wall, "rps": n / wall,
            "p50_s": _quantile(lat, 0.5), "p99_s": _quantile(lat, 0.99),
            "max_s": max(lat), "batches": batches,
            "occupancy": n / max(1, batches),
            "fail_open": sum(_unavailable(b) for b in bodies),
            "denied": sum(not b["response"]["allowed"] for b in bodies)}


def phase_agent(rec, state, n_http: int = 2048, n_framed: int = 512,
                n_mutate: int = 512, callers: int = 256, conns: int = 16,
                n_sample: int = 64, n_admit: int = 256):
    """The agent-action plane on the runner phase's Runner (built with
    --agent-review and --ingest on, config #5 beside it). Through the
    ApiServer after Ready: a `skill-registry` Provider on a localhost
    StubProvider that knows 512 digests (1 in 16 flagged), the three agent
    templates and 30 constraints over the whole match schema, while
    n_admit /v1/admit requests from 64 callers run: the new kind must
    neither rebuild nor cool the K8s set, nor fail an admission; /readyz
    answers 200 throughout the phase (C6). Then n_http HTTPS
    /v1/agent/review requests and n_framed framed 'A' frames (ingest
    port, `conns` connections) from `callers` callers, one fused dispatch
    per agent batch; and n_mutate requests from `callers` through a
    WebhookServer over the same client with an agent MutationSystem
    holding the default-timeout Assign: one K1 screen per mutation batch,
    every patch equal to the host path's. n_sample answers against the
    interpreter, no fail-open answer, none past the request timeout; K1
    held bit for bit against its plain version on the agent batches'
    inputs. Each load's own launches: K1 and K4 once per fused dispatch
    (and K1 once per mutation screen), K2 the same number of times in
    every dispatch, K5 once per vocabulary delta flush.
    -> ({"agent": the three agent loads' launches, "agent_admit": the
    policy step's, /v1/admit beside the new policy}, the K1 figures of
    the agent review's shape)."""
    import base64
    import threading

    import torch
    from gatekeeper_tpu_torch.agentaction import AgentActionTarget
    from gatekeeper_tpu_torch.ingest import PLANE_AGENT
    from gatekeeper_tpu_torch.kernels import ops
    from gatekeeper_tpu_torch.mutation import MutationSystem, json_patch
    from gatekeeper_tpu_torch.mutation.patch import apply_patch
    from gatekeeper_tpu_torch.webhook import WebhookServer

    t0 = time.perf_counter()
    api, runner = state["api"], state["runner"]
    client, drv = runner.client, runner.client._driver
    if AGENT_TARGET not in client.targets or runner.webhook.agent_handler \
            is None or runner.webhook.ingest is None:
        raise AssertionError("agent: the Runner has no agent plane or "
                             "ingest listener")
    import numpy as np

    rng = np.random.default_rng(AGENT_SEED)
    flagged = {skill_digest(int(k)) for k in rng.choice(
        N_DIGESTS, N_DIGESTS // 16, replace=False)}
    stub = state["agent_stub"] = StubProvider(flagged)
    watch = ReadyzWatch(runner.readyz_port)
    out = {"phase": "agent", "templates": len(AGENT_TEMPLATES)}
    # fused need dispatches per target
    dispatches = {}
    need_pairs = drv._need_pairs

    def counted(target, *a, **kw):
        dispatches[target] = dispatches.get(target, 0) + 1
        return need_pairs(target, *a, **kw)

    drv._need_pairs = counted
    rec.install()
    try:
        ops.reset_launches()
        # (1) the agent policy on a Ready, serving Runner
        k8s_set = drv._cset.get(TARGET)
        programs0 = set(drv._programs)
        compiles0 = drv.program_compiles
        admit_posts, _ = webhook_posts(13, n_admit)
        admit = {}
        # the stand-in's pipe serves one thread: this one
        ctx = _https_context(api)

        def admit_load():
            try:
                admit["out"] = _drive_http(runner.webhook.port, admit_posts,
                                           64, ssl_ctx=ctx)
            except BaseException as e:  # raised below
                admit["error"] = e

        ab0 = runner.webhook.batcher.batches_dispatched
        loader = threading.Thread(target=admit_load, daemon=True)
        loader.start()
        t_c = time.perf_counter()
        _register_constraint_kinds(api, [k for k, _ in AGENT_TEMPLATES])
        api.put({"apiVersion": "externaldata.gatekeeper.sh/v1alpha1",
                 "kind": "Provider", "metadata": {"name": AGENT_PROVIDER},
                 "spec": {"url": stub.url, "timeout": 30,
                          "failurePolicy": "Fail", "cacheTTLSeconds": 600,
                          "negativeCacheTTLSeconds": 600}})
        for d in agent_template_docs():
            api.put(d)
        docs = agent_constraint_docs()
        for d in docs:
            api.put(d)
        _wait_for(lambda: len(drv._constraints(AGENT_TARGET)) == len(docs)
                  and runner.external_data.get(AGENT_PROVIDER) is not None,
                  120, "the agent policy to ingest")
        ingest_s = time.perf_counter() - t_c
        _wait_for(lambda: drv.review_path_warm(AGENT_TARGET), 120,
                  "the agent review path to warm")
        warm_s = time.perf_counter() - t_c
        loader.join(timeout=300)
        if "error" in admit or "out" not in admit:
            raise AssertionError(f"agent: the admit load: {admit}")
        a_bodies, a_lat, a_wall = admit["out"]
        new_keys = set(drv._programs) - programs0
        policy = {
            "launches": dict(ops.LAUNCHES),
            "constraints": len(docs), "ingest_s": ingest_s,
            "agent_warm_s": warm_s,
            "program_compiles": drv.program_compiles - compiles0,
            "programs_added_by_target": {
                t: sum(k[0] == t for k in new_keys)
                for t in (TARGET, AGENT_TARGET)},
            "k8s_set_kept": drv._cset.get(TARGET) is k8s_set,
            "k8s_warm": drv.review_path_warm(TARGET),
            "admit": {**_load_stats(
                a_lat, a_wall, n_admit,
                runner.webhook.batcher.batches_dispatched - ab0, a_bodies),
                      "late": sum(t > runner.webhook.request_timeout
                                  for t in a_lat)},
        }
        out["policy"] = policy
        print(json.dumps(dict(out, step="policy"), default=float),
              flush=True)
        if not policy["k8s_set_kept"] or not policy["k8s_warm"] or \
                policy["programs_added_by_target"][TARGET] or \
                policy["admit"]["fail_open"] or policy["admit"]["late"]:
            raise AssertionError(f"agent: the new policy: {policy}")
        _step("agent", "policy", t0)

        oracle = _oracle(client)
        sampled = []  # (record, answer)
        k1 = ops.match_matrix
        k1_inputs = []

        def k1_kept(ms, fb):
            n = fb["group_id"].shape[0]
            if not k1_inputs or n > k1_inputs[-1][1]["group_id"].shape[0]:
                kept = (ms, {k: v.clone() for k, v in fb.items()})
                k1_inputs[:] = [kept]
            return k1(ms, fb)

        # (2) HTTPS /v1/agent/review on the Runner
        ab = runner.webhook.agent_batcher
        recs = agent_records(AGENT_SEED + 1, n_http, "https")
        posts = [("/v1/agent/review", _agent_envelope(r)) for r in recs]
        b0, f0 = ab.batches_dispatched, ab.batch_failures
        d0 = dispatches.get(AGENT_TARGET, 0)
        l0 = dict(ops.LAUNCHES)
        u0 = drv.kernel.uploads["delta_flushes"]
        ops.match_matrix = k1_kept
        try:
            bodies, lat, wall = _drive_http(runner.webhook.port, posts,
                                            callers, ssl_ctx=ctx)
        finally:
            ops.match_matrix = k1
        https = _load_stats(lat, wall, n_http, ab.batches_dispatched - b0,
                            bodies)
        https.update(**_first_request_split(lat, callers),
                     dispatches=dispatches.get(AGENT_TARGET, 0) - d0,
                     launches={k: v - l0[k] for k, v in ops.LAUNCHES.items()},
                     delta_flushes=drv.kernel.uploads["delta_flushes"] - u0,
                     late=sum(t > runner.webhook.request_timeout
                              for t in lat))
        step = max(1, n_http // (n_sample // 2))
        sampled += [(recs[i], bodies[i]) for i in range(0, n_http, step)]
        out["https"] = https
        _step("agent", "https load", t0)

        # (3) framed 'A' frames through the ingest port
        recs_f = agent_records(AGENT_SEED + 2, n_framed, "framed")
        frames = [(PLANE_AGENT, _agent_envelope(r), 10_000) for r in recs_f]
        b0 = ab.batches_dispatched
        d0 = dispatches.get(AGENT_TARGET, 0)
        l0 = dict(ops.LAUNCHES)
        u0 = drv.kernel.uploads["delta_flushes"]
        bodies_f, lat, wall = _drive_framed(runner.webhook.ingest.port,
                                            frames, callers, conns)
        framed = _load_stats(lat, wall, n_framed,
                             ab.batches_dispatched - b0, bodies_f)
        framed.update(dispatches=dispatches.get(AGENT_TARGET, 0) - d0,
                      launches={k: v - l0[k]
                                for k, v in ops.LAUNCHES.items()},
                      delta_flushes=drv.kernel.uploads["delta_flushes"] - u0,
                      late=sum(t > runner.webhook.request_timeout
                               for t in lat), conns=conns)
        step = max(1, n_framed // (n_sample // 4))
        sampled += [(recs_f[i], bodies_f[i])
                    for i in range(0, n_framed, step)]
        out["framed"] = framed
        _step("agent", "framed load", t0)

        # (4) the agent mutation plane over the same client
        msys = MutationSystem(target_handler=AgentActionTarget(),
                              device=drv.device)
        msys.upsert(default_timeout_assign())
        server = WebhookServer(client, TARGET, agent_review=True,
                               agent_mutation_system=msys)
        server.start()
        recs_m = agent_records(AGENT_SEED + 3, n_mutate, "mutate")
        posts = [("/v1/agent/review", _agent_envelope(r)) for r in recs_m]
        d0 = dispatches.get(AGENT_TARGET, 0)
        l0 = dict(ops.LAUNCHES)
        u0 = drv.kernel.uploads["delta_flushes"]
        try:
            bodies_m, lat, wall = _drive_http(server.port, posts, callers)
            mb, vb = server.agent_mutate_batcher, server.agent_batcher
            mutation = _load_stats(lat, wall, n_mutate,
                                   vb.batches_dispatched, bodies_m)
            mutation.update(
                mutate_batches=mb.batches_dispatched,
                screen_dispatches=msys.screen_dispatches,
                batch_failures=mb.batch_failures + vb.batch_failures,
                dispatches=dispatches.get(AGENT_TARGET, 0) - d0,
                launches={k: v - l0[k] for k, v in ops.LAUNCHES.items()},
                delta_flushes=drv.kernel.uploads["delta_flushes"] - u0,
                late=sum(t > server.request_timeout for t in lat))
        finally:
            server.stop()
        # every patch against the host path on the same review
        target = AgentActionTarget()
        patched, mutated_recs = 0, []
        for r, body in zip(recs_m, bodies_m):
            review = target.review_of(r)
            muts, mat = msys.screen_host([review])
            chosen = [m for j, m in enumerate(muts) if mat[j, 0]]
            want = []
            if chosen:
                after, _ = msys.apply(review["object"], review, chosen)
                want = json_patch(review["object"], after)
            resp = body["response"]
            got = json.loads(base64.b64decode(resp["patch"])) \
                if resp.get("patch") else []
            if got != want:
                raise AssertionError(
                    f"agent: the patch of {r['uid']} differs from the host "
                    f"path: {got} != {want}")
            patched += bool(got)
            obj = apply_patch(review["object"], got) if got else None
            mutated_recs.append(dict(
                r, arguments=obj["spec"]["arguments"]) if obj else r)
        mutation["patched"] = patched
        step = max(1, n_mutate // (n_sample // 4))
        sampled += [(mutated_recs[i], bodies_m[i])
                    for i in range(0, n_mutate, step)]
        out["mutation"] = mutation
        _step("agent", "mutation load", t0)
    finally:
        drv._need_pairs = need_pairs
        rec.remove()
        out["readyz"] = watch.close()
    # answers against the interpreter
    t_s = time.perf_counter()
    for r, body in sampled:
        if _response_fields(body) != _expected_agent_response(oracle, r):
            raise AssertionError(
                f"agent: the answer to {r['uid']} differs from the "
                f"interpreter: {_response_fields(body)}")
    out["sample_checked"] = len(sampled)
    out["sample_seconds"] = time.perf_counter() - t_s
    loads = ("https", "framed", "mutation")
    launches = {"agent": {k: sum(out[p]["launches"][k] for p in loads)
                          for k in ops.LAUNCHES},
                "agent_admit": policy["launches"]}
    # K1 on the agent batches' own inputs: bit for bit against its plain
    # version
    k1_row = None
    if k1_inputs:
        ms, fb = k1_inputs[0]
        o_k, o_p = ops.match_matrix(ms, fb), ops.match_matrix_plain(ms, fb)
        if o_k.dtype != o_p.dtype or not torch.equal(o_k, o_p):
            raise AssertionError("agent: K1 differs from its plain version")
        if ms["kind_rows"].is_cuda:
            bound_ms, bound_by, bytes_ms, ops_ms = _bound(
                "match_matrix", (ms, fb), o_k)
            k1_row = {
                "shape": list(o_k.shape),
                "launches": launches["agent"]["match_matrix"],
                "max_abs_err": 0.0,
                "ms": _device_ms(lambda: ops.match_matrix(ms, fb),
                                 KERNEL_FUNCS["match_matrix"]),
                "host_ms": _time_ms(lambda: ops.match_matrix(ms, fb)),
                "plain_ms": _device_ms(
                    lambda: ops.match_matrix_plain(ms, fb), reps=3),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bytes_ms": bytes_ms, "operations_ms": ops_ms,
                "library_ms": None}
    out.update(launches=launches, k1=k1_row, provider_requests=len(
        stub.requests), seconds=time.perf_counter() - t0)
    print(json.dumps(out, default=float), flush=True)
    late = sum(out[k]["late"] for k in ("https", "framed", "mutation"))
    fail_open = sum(out[k]["fail_open"] for k in ("https", "framed",
                                                  "mutation"))
    if late or fail_open or out["mutation"]["batch_failures"] or \
            ab.batch_failures - f0 or out["readyz"]["not_200"]:
        raise AssertionError(
            f"agent: {fail_open} fail-open answers, {late} past the "
            f"timeout, /readyz {out['readyz']}")
    for k in ("https", "framed"):
        if out[k]["dispatches"] != out[k]["batches"]:
            raise AssertionError(
                f"agent: {k}: {out[k]['dispatches']} fused dispatches for "
                f"{out[k]['batches']} batches")
    mutation = out["mutation"]
    if mutation["screen_dispatches"] != mutation["mutate_batches"] or \
            mutation["dispatches"] != mutation["batches"] or \
            not mutation["patched"]:
        raise AssertionError(f"agent: mutation: {mutation}")
    if drv.device.type == "cuda":
        # each load's own launches against its dispatches, screens and
        # vocabulary delta flushes
        wrong = {}
        for p in loads:
            load, n = out[p], out[p]["launches"]
            d = load["dispatches"]
            k2_each = n["slab_gather"] // max(1, d)
            want = {"match_matrix": d + load.get("screen_dispatches", 0),
                    "slab_gather": d * max(1, k2_each), "need_tail": d,
                    "flush_deltas": load["delta_flushes"]}
            got = {k: n[k] for k in want}
            if got != want:
                wrong[p] = {"launched": got, "expected": want}
        # the agent policy's vocabulary reaches the device in a delta
        # flush (K5) at the first dispatch after it compiled: the warm
        # thread's staging or an /v1/admit batch beside the new policy,
        # or else an agent load's, as the host's timing falls
        flushed = launches["agent"]["flush_deltas"] + \
            out["policy"]["launches"]["flush_deltas"]
        missing = [k for k in PATH_KERNELS["agent"]
                   if (flushed if k == "flush_deltas"
                       else launches["agent"][k]) <= 0]
        if wrong or missing or k1_row is None:
            raise AssertionError(
                f"agent: the agent loads' launches: {wrong}; never "
                f"launched by them: {missing}")
    return launches, k1_row


# -- fleet: a second replica on the same card --------------------------------

FLEET_POD = "gatekeeper-tpu-b"


def _review_path_warm(doc) -> bool:
    """/readyz stats.driver.review_path_warm: every reviewed target warm."""
    warm = ((doc or {}).get("stats") or {}).get("driver", {}).get(
        "review_path_warm") or {}
    return bool(warm) and all(warm.values())


def _readyz(port: int):
    """(status, document) of a replica's /readyz."""
    status, text = _http_get(f"http://127.0.0.1:{port}/readyz")
    try:
        return status, json.loads(text)
    except ValueError:
        return status, {}


def _metric(text: str, name: str, **tags) -> float:
    """The sum of the gatekeeper_<name> samples of a /metrics text whose
    labels include `tags`."""
    total = 0.0
    for ln in text.splitlines():
        head, _, value = ln.partition(" ")
        series, _, labels = head.partition("{")
        if series == "gatekeeper_" + name and all(
                f'{k}="{v}"' in labels for k, v in tags.items()):
            total += float(value.split()[0])
    return total


def _leaf_der(api) -> bytes:
    """DER of the server certificate in the fleet's cert Secret (the
    first block of its tls.crt chain)."""
    import base64
    import ssl

    (secret,) = api.objects("", "v1", "Secret")
    chain = base64.b64decode(secret["data"]["tls.crt"]).decode()
    end = "-----END CERTIFICATE-----"
    return ssl.PEM_cert_to_DER_cert(chain.split(end)[0] + end + "\n")


def _served_cert(port: int, ctx) -> bytes:
    """DER of the certificate a fresh TLS handshake with 127.0.0.1:port
    presents, verified against `ctx`."""
    import socket

    with socket.create_connection(("127.0.0.1", port), timeout=10) as sock:
        with ctx.wrap_socket(sock, server_hostname="127.0.0.1") as tls:
            return tls.getpeercert(binary_form=True)


def _force_rotation(rot) -> None:
    """Rotate as a replica whose certificate entered the 90-day lookahead
    does (tests/test_fleet.py's forced rotation): the expiry check reads a
    clock 335 days on, while the new pair is stamped on the real clock
    (the `cryptography` generator stamps the rotator's clock, the
    `openssl` one real time, so either way the pair is valid now). The
    rotator's clock is restored."""
    import datetime

    real, generate = rot._now, rot.generate_pair
    future = real() + datetime.timedelta(days=365 - 30)

    def generate_now():
        rot._now = real
        return generate()

    rot._now, rot.generate_pair = (lambda: future), generate_now
    try:
        rot.ensure()
    finally:
        rot._now = real
        del rot.generate_pair


def _fleet_posts(tag: str, n: int, pool, rng, base: int):
    """n AdmissionReviews of new pods (make_pod's shapes) whose container
    images are drawn from `pool`. -> (posts, requests, distinct images)."""
    posts, reqs, images = [], [], set()
    for j in range(n):
        pod = make_pod(base + j, name=f"fleet-{tag}-{j}")
        for ctr in pod["spec"]["containers"]:
            ctr["image"] = pool[int(rng.integers(len(pool)))]
            images.add(ctr["image"])
        req = admission_request(pod, f"fleet-{tag}-{j}")
        reqs.append(req)
        posts.append(("/v1/admit", _envelope(req)))
    return posts, reqs, images


def _load_doc(bodies, lat, wall) -> dict:
    return {"requests": len(bodies), "rps": len(bodies) / wall,
            "p50_s": _quantile(lat, 0.5), "p99_s": _quantile(lat, 0.99),
            "max_s": max(lat), "fail_policy": sum(map(_unavailable, bodies))}


def _drive_both(loads):
    """_drive_http(port, posts, callers, ssl_ctx=ctx) for every (port,
    posts, callers, ctx) of `loads` at once. -> their results in order."""
    import threading

    out, errors = [None] * len(loads), []

    def run(i, port, posts, callers, ctx):
        try:
            out[i] = _drive_http(port, posts, callers, ssl_ctx=ctx)
        except Exception as e:  # raised below, after both loads end
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i, *load))
               for i, load in enumerate(loads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def phase_fleet(rec, state, n_first: int = 256, n_mixed: int = 1024,
                n_new: int = 512, callers: int = 256, n_sample: int = 64,
                fault_after: int = 120, drain_grace: float = 1.0,
                entry=("-m", "gatekeeper_tpu_torch.run"), device="cuda"):
    """Two replicas on one card against one stand-in. Replica A is the
    Runner of the runner, mutation and extdata phases (`state`), with its
    provider; replica B is `python -m gatekeeper_tpu_torch.run` as a child
    process (a CUDA context of its own, like a second pod) on the same
    stand-in at the same config (500 constraints, the synced pods),
    --operation webhook without the agent target (the agent templates
    fail to ingest there and cancel their kinds' readiness expectations,
    C8) and the process defaults otherwise (the Secret-backed cert store,
    the fleet plane, the integrity plane), with GATEKEEPER_TPU_FLIGHT_DIR
    and GATEKEEPER_TPU_FAULTS arming driver.device_dispatch=error past
    `fault_after` dispatches for the breaker's failure threshold. B boots
    while A idles, to Ready and then to a warm review path (its warm
    thread compiles the policy after Ready, /readyz stats.driver
    review_path_warm); then, in order: (1) one Secret with the triple, TLS
    handshakes to A and B verified by its CA, equal CA bundles and
    cert_generation; (2) A rotates (its expiry check moved into the
    lookahead) and B, the same process, adopts it and presents the new
    server certificate to a new handshake; (3) n_first requests with
    images never fetched go through A, then through B once B merged A's
    entries, with no provider request from B and answers equal to A's;
    n_mixed requests over n_new new images from `callers` split over both
    replicas at once, the keys fetched fleet-wide over the distinct keys
    printed (cold-fetch amplification), n_sample answers against the
    interpreter; (4) sequential requests to B reach the armed fault, B's
    device:validation breaker opens (B answers the fail policy), A's
    breaker adopts it (HALF_OPEN), A's next batch is a single probe that
    succeeds and closes it, and no answer from A fails or fails open;
    B's flight recorder keeps exactly one breaker_open record
    (_fleet_flight_record), still the only one on disk when B ends;
    (5) each /readyz lists the other replica as its peer, component/fleet
    ready, no publish failure; (6) K1-K4 launched for A's batches, B's log
    names the device, B's /metrics counted fused batches and no degraded
    one before the fault, and SIGTERM ends B with exit 0 within the drain
    grace + 30 s. Also prints the byte size of a FleetState publish at the
    max_published_entries cap and how many of the extdata sweep's keys a
    peer can adopt under it. A's response cache is wiped first: the
    extdata phase's TTL check stamped its refetched entries an hour ahead,
    and under the cap (newest first) they would crowd out this phase's
    fetches. `entry` and `device` let a CPU rehearsal start a wrapper that
    builds the driver on the CPU. -> launches."""
    import http.client
    import signal
    import ssl
    import tempfile

    import numpy as np

    from gatekeeper_tpu_torch.faults import CLOSED, HALF_OPEN, OPEN
    from gatekeeper_tpu_torch.kernels import ops

    t0 = time.perf_counter()
    api, runner = state["api"], state["runner"]
    stub, fetches = state["stub"], state["fetches"]
    plane, system = runner.fleet, runner.external_data
    breaker, rot = runner.webhook.batcher.breaker, runner.webhook.rotator
    a_port = runner.webhook.port
    rng = np.random.default_rng(RUNNER_SEED + 2)
    at_cap = plane.state_obj()
    sweep_keys = state.get("extdata_sweep_keys", 0)
    cap = {"max_published_entries": plane.max_published_entries,
           "cache_entries": len(system.cache),
           "published_entries": len(at_cap["spec"]["cache"]),
           "publish_bytes": len(json.dumps(at_cap).encode()),
           "sweep_keys": sweep_keys,
           "adoptable_of_sweep": min(sweep_keys,
                                     plane.max_published_entries)}
    system.cache.wipe()
    work = tempfile.mkdtemp(prefix="gk-smoke-fleet-")
    ports = {k: _free_port() for k in ("webhook", "health", "metrics")}
    threshold = breaker.failure_threshold
    faults = (f"driver.device_dispatch=error:after={fault_after}"
              f":count={threshold}")
    cmd = [sys.executable, *entry, "--kube-url", api.url,
           "--port", str(ports["webhook"]),
           "--health-addr-port", str(ports["health"]),
           "--prometheus-port", str(ports["metrics"]),
           "--cert-dir", os.path.join(work, "certs"),
           "--operation", "webhook", "--pod-name", FLEET_POD,
           "--drain-grace", str(drain_grace)]
    flight_dir = os.path.join(work, "flight")
    env = dict(os.environ, PYTHONPATH=ROOT, GATEKEEPER_TPU_FAULTS=faults,
               GATEKEEPER_TPU_FLIGHT_DIR=flight_dir)
    log_path = os.path.join(work, "b.log")
    out = {"phase": "fleet", "a": runner.pod_name, "b": FLEET_POD,
           "b_faults": faults, "publish_cap": cap}
    a_bodies = []
    rec.install()
    ops.reset_launches()
    t_boot = time.perf_counter()
    with open(log_path, "w") as log:
        child = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log,
                                 stderr=subprocess.STDOUT)
    try:
        _wait_for(lambda: child.poll() is not None
                  or _readyz(ports["health"])[0] == 200, 900,
                  "replica B's /readyz", step=0.5)
        if child.poll() is not None:
            raise AssertionError(f"fleet: replica B exited {child.returncode}")
        out["b_boot_to_ready_s"] = time.perf_counter() - t_boot
        # B serves no agent target: the agent templates the agent phase
        # created fail to ingest there, and their constraint kinds'
        # expectations are cancelled (C8), so B became Ready
        trackers = _readyz(ports["health"])[1]["stats"]
        out["b_agent_trackers"] = {
            kind: trackers.get(f"constraint/{kind}")
            for kind, _ in AGENT_TEMPLATES}
        if any((t or {}).get("expected") != 0 or not (t or {}).get(
                "cancelled") for t in out["b_agent_trackers"].values()):
            raise AssertionError(
                f"fleet: B's agent kinds: {out['b_agent_trackers']}")
        _step("fleet", "B ready", t0)
        # Ready does not wait for the policy compile (the reference's
        # semantics); B's warm thread compiles it, and the loads start
        # once /readyz says the review path is warm
        _wait_for(lambda: _review_path_warm(_readyz(ports["health"])[1]),
                  300, "replica B's review path to warm", step=0.2)
        out["b_boot_to_warm_s"] = time.perf_counter() - t_boot
        _step("fleet", "B warm", t0)

        # (1) one CA
        ctx = _https_context(api)
        with open(os.path.join(work, "certs", "ca.crt"), "rb") as f:
            b_ca = f.read()
        leaf = _leaf_der(api)
        served = [_served_cert(p, ctx) for p in (a_port, ports["webhook"])]
        fl_b = _readyz(ports["health"])[1]["stats"]["fleet"]
        out["one_ca"] = {"generation_a": rot.cert_generation,
                         "generation_b": fl_b["cert_generation"],
                         "ca_bytes": len(b_ca)}
        if not (rot.ca_bundle() == b_ca == _secret_ca(api)) or \
                served != [leaf, leaf] or \
                fl_b["cert_generation"] != rot.cert_generation:
            raise AssertionError(f"fleet: not one CA: {out['one_ca']}")

        # (2) rotation on A, adopted by B without a restart
        adopted0 = fl_b["cert_rotations_adopted"]
        t_w = time.perf_counter()
        _force_rotation(rot)
        t_written = time.perf_counter()
        new_ctx = _https_context(api)
        new_leaf = _leaf_der(api)

        def b_serves_new():
            try:
                return _served_cert(ports["webhook"], new_ctx) == new_leaf
            except (ssl.SSLError, OSError):
                return False

        _wait_for(b_serves_new, 60, "replica B to serve the rotated pair",
                  step=0.01)
        handshake_s = time.perf_counter() - t_written
        fl_b = _readyz(ports["health"])[1]["stats"]["fleet"]
        out["rotation"] = {
            "ensure_s": t_written - t_w, "write_to_b_handshake_s": handshake_s,
            "generation_a": rot.cert_generation,
            "generation_b": fl_b["cert_generation"],
            "b_rotations_adopted": fl_b["cert_rotations_adopted"],
            "b_pid": child.pid, "b_alive": child.poll() is None}
        if fl_b["cert_rotations_adopted"] < adopted0 + 1 or \
                fl_b["cert_generation"] != rot.cert_generation or \
                child.poll() is not None or new_leaf == leaf or \
                _served_cert(a_port, new_ctx) != new_leaf:
            raise AssertionError(f"fleet: rotation: {out['rotation']}")
        _step("fleet", "rotated", t0)

        # (3) cache gossip
        posts, reqs, keys = _fleet_posts(
            "a", n_first, [f"nginx/fleet-a{k:03d}:v1" for k in range(n_first)],
            rng, 6_000_000)
        merged0 = _readyz(ports["health"])[1]["stats"]["fleet"]["cache_merged"]
        s0 = len(stub.requests)
        bodies_a, lat, wall = _drive_http(a_port, posts, callers,
                                          ssl_ctx=new_ctx)
        a_bodies += bodies_a
        first = {"keys": len(keys), "a": _load_doc(bodies_a, lat, wall),
                 "a_fetches": len(stub.requests) - s0}
        t_g = time.perf_counter()
        _wait_for(lambda: _readyz(ports["health"])[1]["stats"]["fleet"][
            "cache_merged"] >= merged0 + len(keys), 60,
            "replica B to merge A's entries", step=0.02)
        first["b_merge_wait_s"] = time.perf_counter() - t_g
        s1, f1 = len(stub.requests), len(fetches.calls)
        bodies_b, lat, wall = _drive_http(ports["webhook"], posts, callers,
                                          ssl_ctx=new_ctx)
        first["b"] = _load_doc(bodies_b, lat, wall)
        first["b_provider_requests"] = (len(stub.requests) - s1) - (
            len(fetches.calls) - f1)
        out["first"] = first
        if first["b_provider_requests"] or first["a"]["fail_policy"] or \
                first["b"]["fail_policy"] or any(
                    _response_fields(x) != _response_fields(y)
                    for x, y in zip(bodies_a, bodies_b)):
            raise AssertionError(f"fleet: cache gossip: {first}")
        posts, reqs, keys = _fleet_posts(
            "m", n_mixed, [f"nginx/fleet-m{k:03d}:v1" for k in range(n_new)],
            rng, 7_000_000)
        s2 = len(stub.requests)
        (ba, la, wa), (bb, lb, wb) = _drive_both([
            (a_port, posts[0::2], callers // 2, new_ctx),
            (ports["webhook"], posts[1::2], callers // 2, new_ctx)])
        a_bodies += ba
        fetched = [k for r in stub.requests[s2:] for k in r]
        mixed = {"keys": len(keys), "keys_fetched": len(fetched),
                 "amplification": len(fetched) / len(keys),
                 "provider_requests": len(stub.requests) - s2,
                 "a": _load_doc(ba, la, wa), "b": _load_doc(bb, lb, wb)}
        out["mixed"] = mixed
        if mixed["a"]["fail_policy"] or mixed["b"]["fail_policy"] or \
                set(fetched) != keys:
            raise AssertionError(f"fleet: mixed load: {mixed}")
        oracle = _oracle(runner.client)
        step = max(1, n_mixed // n_sample)
        answered = [None] * n_mixed
        answered[0::2], answered[1::2] = ba, bb
        for i in range(0, n_mixed, step):
            if _response_fields(answered[i]) != _expected_response(
                    oracle, reqs[i]):
                raise AssertionError(
                    f"fleet: answer to {reqs[i]['uid']} differs from the "
                    "interpreter")
        mixed["sample_checked"] = len(range(0, n_mixed, step))
        _step("fleet", "cache gossip", t0)

        # (4) breaker gossip: B reaches its armed fault and trips
        text = _http_get(f"http://127.0.0.1:{ports['metrics']}/metrics")[1]
        pre = {"b_batches": _metric(text, "webhook_batches_total"),
               "b_degraded": _metric(text, "webhook_degraded_dispatch_total")}
        if pre["b_batches"] <= 0 or pre["b_degraded"]:
            raise AssertionError(f"fleet: B before the fault: {pre}")
        conn = http.client.HTTPSConnection("127.0.0.1", ports["webhook"],
                                           timeout=60, context=new_ctx)
        failed, sent, t_trip, trip_lat = 0, 0, None, []
        try:
            while sent < fault_after + 4 * threshold and t_trip is None:
                req = admission_request(
                    make_pod(8_000_000 + sent, name=f"fleet-trip-{sent}"),
                    f"fleet-trip-{sent}")
                t_q = time.perf_counter()
                conn.request("POST", "/v1/admit", _envelope(req),
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                body = json.loads(resp.read())
                trip_lat.append(time.perf_counter() - t_q)
                sent += 1
                if _unavailable(body):
                    failed += 1
                    if failed == threshold:
                        t_trip = time.perf_counter()
                elif failed:
                    raise AssertionError(
                        "fleet: B answered a fused batch between failures")
        finally:
            conn.close()
        if t_trip is None:
            raise AssertionError(f"fleet: B's fault never fired ({sent} sent)")
        b_state = _readyz(ports["health"])[1]["stats"]["webhook"]["breaker"]
        _wait_for(lambda: breaker.state == HALF_OPEN, 30,
                  "A's breaker to adopt B's trip", step=0.002)
        adopt_s = time.perf_counter() - t_trip
        probe, lat, _wall = _drive_http(a_port, posts[:1], 1, ssl_ctx=new_ctx)
        a_bodies += probe
        trip = dict(pre, sent_to_trip=sent, b_failed=failed,
                    b_breaker=b_state["state"], trip_to_adoption_s=adopt_s,
                    a_breaker_after_probe=breaker.state, probe_s=lat[0],
                    a_adoptions=plane.breaker_adoptions,
                    b_trip_p50_s=_quantile(trip_lat, 0.5),
                    b_trip_p99_s=_quantile(trip_lat, 0.99),
                    b_trip_max_s=max(trip_lat))
        out["breaker"] = trip
        if b_state["state"] != OPEN or breaker.state != CLOSED or \
                plane.breaker_adoptions < 1 or \
                any(map(_unavailable, a_bodies)):
            raise AssertionError(f"fleet: breaker gossip: {trip}")
        # not required: A's CLOSED lets B's open breaker probe early
        t_r = time.perf_counter()
        _wait_for(lambda: _readyz(ports["health"])[1]["stats"]["webhook"][
            "breaker"]["state"] != OPEN, 40, "B's breaker to leave OPEN")
        trip["b_left_open_s"] = time.perf_counter() - t_r
        _step("fleet", "breaker gossip", t0)
        out["flight"] = _fleet_flight_record(ports, flight_dir, t_trip)

        # (5) /readyz on both
        (st_a, doc_a), (st_b, doc_b) = (_readyz(runner.readyz_port),
                                        _readyz(ports["health"]))
        fa, fb = doc_a["stats"]["fleet"], doc_b["stats"]["fleet"]
        out["readyz"] = {"a": fa, "b": fb,
                         "a_component": doc_a["stats"]["component/fleet"],
                         "b_component": doc_b["stats"]["component/fleet"]}
        # A stays Ready although extdata's and agent's constraint kinds
        # were created after Ready (C6, ROADMAP §C)
        out["readyz"].update(a_status=st_a, b_status=st_b)
        for doc, fl, peer in ((doc_a, fa, FLEET_POD),
                              (doc_b, fb, runner.pod_name)):
            comp = doc["stats"]["component/fleet"]
            if fl["peers"] != [peer] or fl["publish_failures"] or \
                    comp["expected"] != comp["observed"] or st_b != 200 \
                    or st_a != 200:
                raise AssertionError(f"fleet: /readyz: {out['readyz']}")
        launches = dict(ops.LAUNCHES)

        # (6) B ends on SIGTERM
        t_term = time.perf_counter()
        child.send_signal(signal.SIGTERM)
        rc = child.wait(timeout=drain_grace + 30)
        out["b_sigterm"] = {"exit": rc, "seconds": time.perf_counter() - t_term}
        if rc != 0:
            raise AssertionError(f"fleet: SIGTERM gave B exit {rc}")
        # still one record: nothing after the trip captured again
        on_disk = sorted(os.listdir(flight_dir))
        if on_disk != [f"flightrecord-{out['flight']['id']}.json"]:
            raise AssertionError(f"fleet: B's flight records: {on_disk}")
    except BaseException:
        _print_tail(log_path, 40)
        raise
    finally:
        rec.remove()
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)
    with open(log_path) as f:
        start = [ln for ln in f.read().splitlines()
                 if '"starting gatekeeper-tpu"' in ln]
    if not start or f'"device": "{device}' not in start[0]:
        raise AssertionError(f"fleet: B's log names no device: {start}")
    missing = [k for k in PATH_KERNELS["fleet"] if launches[k] <= 0]
    if missing and runner.client._driver.device.type == "cuda":
        raise AssertionError(f"fleet: kernels never launched for A: {missing}")
    out.update(b_start_log=json.loads(start[0]), launches=launches,
               runner_load_p99_s=state.get("https_p99_s"),
               seconds=time.perf_counter() - t0)
    print(json.dumps(out, default=float), flush=True)
    return launches


def _fleet_flight_record(ports, flight_dir, t_trip):
    """Replica B's breaker trip as its flight recorder kept it: exactly one
    coalesced breaker_open record on /debug/flightrecords, holding the
    trace tail, the fault registry's armed points and the cost table,
    and the same record on disk. -> its figures: the seconds from the
    trigger to the capture's start (the recorder's debounce) and to the
    file on disk (its mtime, at the file system's clock granularity),
    and from the trip to the record on /debug/flightrecords (polled)."""
    url = f"http://127.0.0.1:{ports['health']}/debug/flightrecords"

    def doc():
        status, text = _http_get(url)
        return json.loads(text) if status == 200 else {}

    _wait_for(lambda: doc().get("captured", 0) >= 1, 30,
              "replica B's flight record", step=0.05)
    first_seen = time.perf_counter() - t_trip
    time.sleep(1.0)  # a second trigger would have coalesced or landed
    fr = doc()
    records = fr.get("records") or []
    if len(records) != 1 or fr.get("captured") != 1:
        raise AssertionError(f"fleet: B's flight records: {fr}")
    rec = records[0]
    triggers = rec["triggers"]
    ctx = triggers[0]["context"]
    path = os.path.join(flight_dir, f"flightrecord-{rec['id']}.json")
    problems = []
    if rec["trigger"] != "breaker_open" or ctx.get("to_state") != "open":
        problems.append(f"trigger {rec['trigger']} {ctx}")
    if not rec.get("trace_tail"):
        problems.append("no trace tail")
    if "driver.device_dispatch" not in (rec.get("faults") or {}):
        problems.append(f"faults {rec.get('faults')}")
    if "costs" not in rec:
        problems.append("no cost table")
    if (rec.get("state") or {}).get("webhook", {}).get(
            "breaker", {}).get("state") is None:
        problems.append(f"state {sorted(rec.get('state') or {})}")
    if not os.path.exists(path):
        problems.append(f"{path} missing")
    if problems:
        raise AssertionError(f"fleet: B's flight record: {problems}")
    with open(path) as f:
        if json.load(f)["id"] != rec["id"]:
            raise AssertionError("fleet: B's record on disk differs")
    return {"id": rec["id"], "trigger": rec["trigger"],
            "triggers": [t["reason"] for t in triggers],
            "breaker": ctx.get("breaker"),
            "trigger_to_capture_s": rec["ts"] - triggers[0]["ts"],
            "trigger_to_on_disk_s": os.path.getmtime(path)
            - triggers[0]["ts"],
            "seen_after_trip_s": first_seen,
            "trace_tail": len(rec["trace_tail"]),
            "faults": sorted(rec["faults"]),
            "cost_rows": len((rec.get("costs") or {}).get("rows") or []),
            "state": sorted(rec["state"]), "bytes": os.path.getsize(path)}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http_get(url: str, timeout: float = 10.0):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()
    except OSError:
        return None, ""


def phase_process(n_pods: int = 1000, n_constraints: int = 50,
                  drain_grace: float = 1.0,
                  entry=("-m", "gatekeeper_tpu_torch.run"), device="cuda"):
    """`python -m gatekeeper_tpu_torch.run` as a child process against an
    ApiServer with n_pods pods x n_constraints constraints, in the
    process defaults (discovery-mode audit, --audit-chunk-size 512, the
    Secret-backed cert store, the fleet plane): its /readyz answers 200,
    its /metrics serves the audit series, one HTTPS AdmissionReview
    verified by the Secret's CA equals the interpreter's answer, its log
    names the CUDA device, and SIGTERM ends it with exit 0 within the
    drain grace plus 30 s. The stand-in serves no FleetState kind, so the
    fleet plane takes the reference's degrade path: its publishes fail and
    are counted (fleet_state_publish_failures_total on /metrics,
    publish_failures on /readyz), and serving goes on. `entry` and
    `device` let a CPU rehearsal start a wrapper that builds the driver on
    the CPU."""
    import signal
    import tempfile

    from gatekeeper_tpu_torch.constraint import RegoDriver

    t0 = time.perf_counter()
    api = ApiProcess(n_pods, n_constraints)
    ports = {k: _free_port() for k in ("webhook", "health", "metrics")}
    work = tempfile.mkdtemp(prefix="gk-smoke-process-")
    log_path = os.path.join(work, "run.log")
    cmd = [sys.executable, *entry,
           "--kube-url", api.url, "--port", str(ports["webhook"]),
           "--health-addr-port", str(ports["health"]),
           "--prometheus-port", str(ports["metrics"]),
           "--cert-dir", os.path.join(work, "certs"),
           "--audit-chunk-size", "512", "--drain-grace", str(drain_grace),
           "--pod-name", "smoke-process"]
    env = dict(os.environ, PYTHONPATH=ROOT)
    with open(log_path, "w") as log:
        child = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log,
                                 stderr=subprocess.STDOUT)
    try:
        health = f"http://127.0.0.1:{ports['health']}"
        _wait_for(lambda: child.poll() is not None
                  or _http_get(f"{health}/readyz")[0] == 200, 600,
                  "the child's /readyz", step=0.5)
        if child.poll() is not None:
            raise AssertionError(f"process: exited {child.returncode}")
        ready_s = time.perf_counter() - t0
        metrics = f"http://127.0.0.1:{ports['metrics']}/metrics"
        _wait_for(lambda: "gatekeeper_audit_last_run_time" in
                  _http_get(metrics)[1], 600, "the child's first audit",
                  step=0.5)
        text = _http_get(metrics)[1]
        series = sorted({ln.split("{")[0].split(" ")[0]
                         for ln in text.splitlines()
                         if ln.startswith("gatekeeper_audit")
                         or ln.startswith("gatekeeper_violations")})
        violations = [ln for ln in text.splitlines()
                      if ln.startswith("gatekeeper_violations")]
        # the degrade path: no FleetState kind, publishes fail, counted
        degrade = {
            "publish_failures_total": _metric(
                text, "fleet_state_publish_failures_total"),
            "readyz": _readyz(ports["health"])[1]["stats"]["fleet"]}
        if not degrade["publish_failures_total"] or \
                not degrade["readyz"]["publish_failures"]:
            raise AssertionError(f"process: fleet degrade path: {degrade}")
        # one HTTPS AdmissionReview, verified by the Secret's CA
        ctx = _https_context(api)
        pod = make_pod(503, name="process-admit")
        req = admission_request(pod, "process-1")
        (body,), _lat, _wall = _drive_http(
            ports["webhook"], [("/v1/admit", _envelope(req))], 1,
            ssl_ctx=ctx)
        oracle = build_client(RegoDriver(), 0, n_constraints)
        if _response_fields(body) != _expected_response(oracle, req):
            raise AssertionError(
                f"process: answer {body} differs from the interpreter")
        t_term = time.perf_counter()
        child.send_signal(signal.SIGTERM)
        rc = child.wait(timeout=drain_grace + 30)
        term_s = time.perf_counter() - t_term
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)
        api.close()
    with open(log_path) as f:
        log_text = f.read()
    device_lines = [ln for ln in log_text.splitlines()
                    if '"starting gatekeeper-tpu"' in ln]
    if rc != 0:
        raise AssertionError(f"process: SIGTERM gave exit {rc}:\n"
                             f"{log_text[-3000:]}")
    if not device_lines or f'"device": "{device}' not in device_lines[0]:
        raise AssertionError(
            f"process: the log names no CUDA device: {device_lines}")
    print(json.dumps({
        "phase": "process", "pods": n_pods, "constraints": n_constraints,
        "ready_s": ready_s, "audit_series": series,
        "violations": violations, "allowed": body["response"]["allowed"],
        "fleet_degrade": degrade, "sigterm_exit": rc, "sigterm_s": term_s,
        "start_log": json.loads(device_lines[0]),
        "seconds": time.perf_counter() - t0,
    }), flush=True)


def phase_kernels(rec, launches, extra=None):
    """-> the kernel table rows. `launches`: {path: {kernel: count}};
    `extra`: {kernel: fields added to its row} (K1's figures on the
    mutation screen's shape, measured by phase_mutation)."""
    import torch
    from gatekeeper_tpu_torch.kernels import ops

    rows = []
    for name, (src, replaces) in KERNELS.items():
        calls = rec.calls[name]
        if not calls:
            raise AssertionError(f"kernels: no recorded input for {name}")
        worst = 0.0
        entry = None
        for key, (args, kw) in calls.items():
            kern = getattr(ops, name)
            out_k = _flat(kern(*_fresh(name, args), **kw))
            out_p = _flat(_plain(name)(*_fresh(name, args), **kw))
            torch.cuda.synchronize()
            if out_k.shape != out_p.shape or out_k.dtype != out_p.dtype:
                raise AssertionError(
                    f"kernels: {name}{key} shape/dtype {out_k.shape} "
                    f"{out_k.dtype} vs {out_p.shape} {out_p.dtype}"
                )
            err = (out_k.double() - out_p.double()).abs().max().item() if out_k.numel() else 0.0
            if err != 0.0:
                raise AssertionError(f"kernels: {name}{key} differs by {err}")
            worst = max(worst, err)
            # time the variant with the largest input (the main cost)
            if entry is None or (
                _size(name, args, out_k) > _size(name, entry[0], entry[2])
            ):
                entry = (args, kw, out_k, key)
        args, kw, out_k, key = entry
        kern = getattr(ops, name)
        # K5 writes in place; writing the same delta again is idempotent,
        # so the timed calls reuse one copy of the buffers each
        args_k, args_p = _fresh(name, args), _fresh(name, args)

        def call_kernel():
            return kern(*args_k, **kw)

        def call_plain():
            return _plain(name)(*args_p, **kw)

        lib, lib_label = _library_call(name, args) or (None, None)
        bound_ms, bound_by, bytes_ms, ops_ms = _bound(name, args, out_k)
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": sum(n.get(name, 0) for n in launches.values()),
            "launches_by_path": {p: n.get(name, 0) for p, n in launches.items()},
            "max_abs_err": worst,
            # device time of the kernel's own launches, and the wall time
            # per wrapper call (host issue included)
            "ms": _device_ms(call_kernel, KERNEL_FUNCS[name]),
            "host_ms": _time_ms(call_kernel),
            # every device op of one plain / library call
            # all device work of one wrapper call (K5: the staging
            # copy to the device as well)
            "wrapper_device_ms": _device_ms(call_kernel),
            "plain_ms": _device_ms(call_plain, reps=3),
            "plain_wall_ms": _time_ms(call_plain, reps=3),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes_ms": bytes_ms, "operations_ms": ops_ms,
            "library_ms": _device_ms(lib) if lib is not None else None,
            "library_wall_ms": _time_ms(lib) if lib is not None else None,
            "library_call": lib_label,
            "timed_shape": [list(out_k.shape), str(out_k.dtype), str(key)],
            "variants_checked": len(calls),
        })
        rows[-1].update((extra or {}).get(name, {}))
        if name == "need_tail":  # the timed input's n_hot and pair counts
            rows[-1]["n_hot_sc_si"] = out_k[-3:].tolist()
        if name == "flush_deltas":  # the staging's host-to-device copy
            rows[-1]["copy_ms"] = _device_ms(call_kernel, ("HtoD",))
            rows[-1]["delta_bytes"] = sum(d.nbytes for d in args[2])
            tables = {}
            for buf, d in zip(args[0], args[2]):
                key = f"{buf.dtype} {list(buf.shape[1:])} x {d.shape[0]} rows"
                tables[key] = tables.get(key, 0) + 1
            rows[-1]["tables"] = tables
    return rows


# -- probe: K1-K5 alone (python3 chip_smoke.py --probe [--tree DIR]) ---------

PROBE_SOURCES = ("slab", "group", "need", "match", "delta")


def _sass_summary(lib):
    """cuobjdump -sass of one built library -> ({function: {"instructions":
    n, "calls": [call targets], "conversions": n}}, the raw listing).
    "conversions" counts I2F, F2I and MUFU instructions, the quarter-rate
    ops of a division by a runtime divisor."""
    import re

    from gatekeeper_tpu_torch.kernels import build

    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = out.setdefault(m.group(1), {"instructions": 0, "calls": [],
                                             "conversions": 0})
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*)",
                      line)
        if fn is None or not m:
            continue
        op, rest = m.group(2), m.group(3)
        fn["instructions"] += 1
        if op.startswith("CALL"):
            target = rest.split(";")[0].strip()
            if target not in fn["calls"]:
                fn["calls"].append(target)
        if op.split(".")[0] in ("I2F", "F2I", "MUFU"):
            fn["conversions"] += 1
    return out, text


def _kinds_only_specs(r, u: int, n: int, ml: int, scopes: bool = False):
    """A spec set in the shape the in-repo policies compile to (kinds
    only: every other selector part padded with -1 / False, as
    compile_match_specs pads, so every selector is dead) over reviews
    with `ml` label slots; `scopes` draws each row's scope code. -> (ms,
    fb) as numpy arrays."""
    import numpy as np

    def pad(*shape):
        return np.full(shape, -1, np.int32)

    kind = r.integers(0, 6, (u, 2, 2)).astype(np.int32)
    kind[:, 1] = -1  # a second, padded kind row
    ms = {
        "kind_rows": kind, "ns_has": np.zeros(u, bool), "ns_ids": pad(u, 1),
        "excl_has": np.zeros(u, bool), "excl_ids": pad(u, 1),
        "scope": (r.integers(0, 4, u) if scopes else np.zeros(u)).astype(np.int32),
        "lab_invalid": np.zeros(u, bool), "lab_ml": pad(u, 1, 2),
        "lab_expr": pad(u, 1, 3), "lab_expr_vals": pad(u, 1, 1),
        "nssel_has": np.zeros(u, bool), "nssel_matches_empty": np.zeros(u, bool),
        "nssel_invalid": np.zeros(u, bool), "nssel_ml": pad(u, 1, 2),
        "nssel_expr": pad(u, 1, 3), "nssel_expr_vals": pad(u, 1, 1),
    }
    lab = r.integers(0, 40, (n, ml, 2)).astype(np.int32)
    lab[r.random((n, ml)) < 0.5] = -1
    fb = {
        "group_id": r.integers(-1, 6, n).astype(np.int32),
        "kind_id": r.integers(-1, 6, n).astype(np.int32),
        "kind_defined": r.random(n) < 0.9, "is_ns": r.random(n) < 0.01,
        "has_namespace": r.random(n) < 0.95,
        "ns_name_id": r.integers(-1, 50, n).astype(np.int32),
        "obj_present": np.ones(n, bool), "old_present": np.zeros(n, bool),
        "obj_labels": lab, "old_labels": np.full((n, ml, 2), -1, np.int32),
        "nssel_defined": r.random(n) < 0.9,
        "nssel_labels": np.full((n, ml, 2), -1, np.int32),
        "nssel_empty": np.zeros(n, bool),
    }
    return ms, fb


def _need_case(r, t, c, n, u=5, match=0.99, viol=0.1, fb=0.001,
               interp=0.02, n_valid=None, r_cap=1024):
    """K4 arguments on seeded inputs: `match` of the pairs matched (a
    spec row per constraint from u rows), `viol` of them violating, `fb`
    of the rows routed to the interpreter, `interp` of the constraints
    interpreter-only."""
    import numpy as np

    match_u = r.random((u, n)) < match
    spec_map = r.integers(0, u, c).astype(np.int32)
    compiled = r.random(c) >= interp
    return (t(match_u), t(spec_map), t(r.random((c, n)) < viol),
            t(compiled), t(r.random(n) < fb),
            n if n_valid is None else n_valid, r_cap)


def _probe_cases(device):
    """K1-K4 at the main path's timed shapes, on seeded synthetic inputs:
    K2 [32768, 128] tokens of a [100160, 44] bool table (with and without
    a 256-row overlay); K3 onto g01 = 16 x 4 slots, at the main path's
    live-token share (0.27%), at 12% and at half; K4 at C 500 x N 32768,
    R 1024 at the main path's shares (every pair matched and compiled,
    about 1% of the rows hot: the recorded input's n_hot and pair counts,
    PERF.md), with 99% matched and every row hot (n_hot > R), and dense;
    K1 on the kinds-only spec set at [3, 100000] and on a label-heavy
    battery at [64, 100000] with 16 label slots (namespaces, excluded
    namespaces, matchLabels, all five expression ops, namespaceSelector,
    object and oldObject)."""
    import numpy as np
    import torch

    r = np.random.default_rng(4)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    n, l, v, cols = 32768, 128, 100_160, 44
    tab = t(r.random((v, cols)) < 0.5)
    ov = t(r.random((256, cols)) < 0.5)
    ids = t(r.integers(0, v, (n, l)).astype(np.int32))
    ids_ov = t(r.integers(0, v + 256, (n, l)).astype(np.int32))
    g0, g1 = 16, 4
    idx0 = t(r.integers(-1, g0, (n, l)).astype(np.int32))
    idx1 = t(r.integers(-1, g1, (n, l)).astype(np.int32))
    sparse = t(r.random((n, l)) < 0.0027)
    mid = t(r.random((n, l)) < 0.12)
    dense = t(r.random((n, l)) < 0.5)
    ints = t(r.integers(-3, 900, (n, l)).astype(np.int32))
    cases = [
        ("k2 [32768,128,44] bool", "slab_gather", (tab, ids, None, 0)),
        ("k2 [32768,128,44] bool overlay", "slab_gather",
         (tab, ids_ov, ov, v)),
        ("k3 [32768,64] g01 any, 0.27% live", "egroup",
         (idx0, idx1, sparse, sparse, "g01", g0, g1, "any", -1)),
        ("k3 [32768,64] g01 any, 12% live", "egroup",
         (idx0, idx1, mid, mid, "g01", g0, g1, "any", -1)),
        ("k3 [32768,64] g01 max int32, 50% live", "egroup",
         (idx0, idx1, dense, ints, "g01", g0, g1, "max", -1)),
        ("k4 [500,32768] R 1024, main shares", "need_tail",
         _need_case(r, t, 500, n, match=1.0, viol=0.00002, fb=0.0,
                    interp=0.0)),
        ("k4 [500,32768] R 1024, every row hot", "need_tail",
         _need_case(r, t, 500, n, n_valid=n - 77)),
        ("k4 [500,32768] R 1024, dense", "need_tail",
         _need_case(r, t, 500, n, match=1.0, viol=0.5, fb=0.05)),
    ]
    ms, fb = _kinds_only_specs(r, 3, 100_000, 8)
    cases.append(("k1 [3,100000] kinds only", "match_matrix",
                  ({k: t(a) for k, a in ms.items()},
                   {k: t(a) for k, a in fb.items()})))
    ms, fb = _match_battery(44, 64, 100_000, 16)
    cases.append(("k1 [64,100000] label battery, ML 16", "match_matrix",
                  ({k: t(a) for k, a in ms.items()},
                   {k: t(a) for k, a in fb.items()})))
    return cases


# K5's probe flush with the recorded audit_churn flush's table count and
# bytes (PERF.md §6 row B7): 66 tables of bool, int32 and float32 whose
# deltas sum to 651,264 bytes. The split is synthetic: 512-row deltas of
# 1,272 bytes a vocab row over 61 string tables [V] and five slab tables
# [V, T] (the kernels phase prints the recorded split). (dtype, columns,
# count); columns 0 is [V].
DELTA_PROBE_TABLES = (
    ("bool", 0, 20), ("int32", 0, 30), ("float32", 0, 11),
    ("bool", 44, 1), ("int32", 100, 1), ("bool", 44, 1), ("int32", 100, 1),
    ("float32", 50, 1),
)


def _delta_probe_cases(device):
    """K5 on seeded flushes: the recorded shape above (capacity 131,072
    rows, fills drawn at random, so most destinations start off 16-byte
    alignment) and one 8 MiB delta of an int32 [V, 32] table. ->
    [(label, bufs, fills, deltas)], deltas as host numpy arrays of the
    buffers' types, as the fused dispatch passes them."""
    import numpy as np
    import torch

    r = np.random.default_rng(5)
    cap, rows = 131_072, 512
    bufs, fills, deltas = [], [], []
    for dt, width, count in DELTA_PROBE_TABLES:
        shape = (cap,) if width == 0 else (cap, width)
        for _ in range(count):
            bufs.append(torch.zeros(shape, dtype=getattr(torch, dt), device=device))
            fills.append(int(r.integers(100_000, cap - rows)))
            deltas.append(r.integers(-50, 50, (rows,) + shape[1:]).astype(dt))
    big = torch.zeros((262_144, 32), dtype=torch.int32, device=device)
    big_delta = r.integers(-50, 50, (65_536, 32)).astype(np.int32)
    return [
        ("k5 recorded shape, 66 tables, 651,264 B", bufs, fills, deltas),
        ("k5 one 8 MiB delta, int32 [V, 32]", [big], [1001], [big_delta]),
    ]


def _probe_delta(empty, root):
    """K5's probe rows: kernel ms (delta_kernel), copy ms (the one
    host-to-device copy of the staging), the launch floor in the same
    window, and the wrapper's host ms per call, with the flushes issued
    back to back ("copy_ms") and with a synchronize before each
    ("copy_ms_synced": the host packs, then the copy reads the bytes it
    has just written, as on the path, where one flush comes alone)."""
    import torch
    from gatekeeper_tpu_torch.kernels import ops

    flush = ops.flush_deltas
    for label, bufs, fills, deltas in _delta_probe_cases("cuda"):
        want = _flat(ops.flush_deltas_plain([b.clone() for b in bufs], fills,
                                            deltas))
        nbytes = sum(d.nbytes for d in deltas)
        got = _flat(flush([b.clone() for b in bufs], fills, deltas))
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"probe: {label} differs")

        def both():
            flush(bufs, fills, deltas)
            empty()

        def synced():
            torch.cuda.synchronize()
            both()

        names = ("delta_kernel", "empty_kernel", "HtoD")
        split = _device_split(both, names)
        split_synced = _device_split(synced, names)
        host_ms = _time_ms(lambda: flush(bufs, fills, deltas), reps=20)
        row = {
            "probe": label, "root": root, "bytes": nbytes,
            "kernel_ms": split["delta_kernel"], "copy_ms": split["HtoD"],
            "copy_ms_synced": split_synced["HtoD"],
            "kernel_ms_synced": split_synced["delta_kernel"],
            "floor_ms": split["empty_kernel"], "host_ms": host_ms,
            "bound_ms": 2 * nbytes / HBM_BYTES_PER_S * 1e3,
            "plain_ms": _device_ms(
                lambda: ops.flush_deltas_plain(bufs, fills, deltas), reps=3),
        }
        if hasattr(ops, "delta_plan"):
            row["host_split_ms"] = _delta_host_split(ops, bufs, fills, deltas)
        print(json.dumps(row), flush=True)


def _probe_staging_copy(nbytes: int = 655_664, buffers: int = 4):
    """The host-to-device copy of a staging-sized pinned buffer (torch
    only, no kernel of the port), per buffer: copied as it lies, and copied
    right after the host rewrote it, as every flush does."""
    import numpy as np
    import torch

    src = np.random.default_rng(6).integers(0, 255, nbytes).astype(np.uint8)
    dev = torch.empty((nbytes,), dtype=torch.uint8, device="cuda")
    out, kept = [], []
    for _ in range(buffers):
        host = torch.empty((nbytes,), dtype=torch.uint8, pin_memory=True)
        kept.append(host)  # each buffer a new allocation
        view = host.numpy()
        view[:] = src

        def copy():
            dev.copy_(host, non_blocking=True)

        def rewrite_then_copy():
            view[:] = src
            dev.copy_(host, non_blocking=True)

        out.append({"copy_ms": _device_ms(copy, ("HtoD",), reps=20),
                    "rewrite_then_copy_ms": _device_ms(rewrite_then_copy,
                                                       ("HtoD",), reps=20)})
    print(json.dumps({"probe": f"staging copy, {nbytes:,} B pinned",
                      "buffers": out}), flush=True)


def _delta_host_split(ops, bufs, fills, deltas, reps: int = 50):
    """Host ms per call of the K5 wrapper's stages (host clock, no device
    work): the per-table checks and casts (_host_delta), the plan
    (delta_plan) and the packing (pack_deltas)."""
    import numpy as np

    def ms(fn):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3

    def tables():
        return [ops._host_delta(d, b, f) for b, f, d in zip(bufs, fills, deltas)]

    ds = tables()
    dsts = [b.data_ptr() + f * d.strides[0] for b, f, d in zip(bufs, fills, ds)]
    sizes = [d.nbytes for d in ds]
    plan = ops.delta_plan(dsts, sizes)
    staging = np.empty((plan["total"],), np.uint8)
    return {"tables": ms(tables),
            "plan": ms(lambda: ops.delta_plan(dsts, sizes)),
            "pack": ms(lambda: ops.pack_deltas(staging, plan, ds))}


def _empty_kernel():
    """The empty kernel of this checkout's csrc/empty.cu, built apart from
    the probed tree: -> fn() launching it once (one block of 32 threads)."""
    import ctypes

    import torch
    from gatekeeper_tpu_torch.kernels import build

    src = os.path.join(ROOT, "gatekeeper_tpu_torch", "kernels", "csrc",
                       "empty.cu")
    out = os.path.join(str(build.BUILD_DIR), "probe_empty.so")
    os.makedirs(str(build.BUILD_DIR), exist_ok=True)
    subprocess.run([build.nvcc(), "-gencode", build.ARCH, "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", out, src],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(out)
    lib.gk_empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.gk_empty.restype = ctypes.c_int

    def launch():
        rc = lib.gk_empty(1, 32, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"empty kernel: cudaError {rc}")

    return launch


def _device_split(fn, kernels, reps: int = 20):
    """Device ms per call of each named kernel (torch.profiler), each
    launched once per call of fn; a profile missing records is taken
    again, up to three times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _window_head()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        got, seen = {}, {}
        for e in prof.key_averages():
            name = _kernel_name(e)
            seen[name] = seen.get(name, 0) + e.count
            if name in kernels:
                got[name] = got.get(name, 0.0) + _device_time_us(e) / 1e3 / reps
        if all(seen.get(k, 0) == reps for k in kernels):
            return got
    raise AssertionError(f"profiler recorded {seen} for {kernels} over {reps}")


def phase_probe(tree=None):
    """Build K1-K5 from `tree` (a checkout of this repo; default this one),
    report ptxas registers and spills, the SASS instruction count and
    subroutine calls of each kernel, and time each kernel at the main
    path's shapes beside its plain version and its bound: per __global__
    function, with an empty kernel's device time (the launch floor)
    measured in the same profiler window. The full SASS listing goes to
    probe_sass_<tag>.txt in the kernels' build directory."""
    import torch

    root = os.path.abspath(tree or ROOT)
    sys.path.insert(0, root)
    from gatekeeper_tpu_torch.kernels import build, ops

    if not build.__file__.startswith(root):
        raise AssertionError(f"probe: kernels imported from {build.__file__}")
    tag = "tree" if tree else "this"
    for name in PROBE_SOURCES:  # compile anew, for the ptxas report
        build._target(name).unlink(missing_ok=True)
    logs = build.build_all(PROBE_SOURCES)
    sass = {}
    with open(build.BUILD_DIR / f"probe_sass_{tag}.txt", "w") as f:
        for name in PROBE_SOURCES:
            summary, text = _sass_summary(build._target(name))
            sass[name] = summary
            f.write(f"== {name}.cu\n{logs.get(name, '')}\n{text}\n")
    print(json.dumps({"probe": "build", "root": root, "ptxas": {
        k: [ln.strip() for ln in v.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling" in ln]
        for k, v in logs.items()},
        "sass": sass}), flush=True)
    empty = _empty_kernel()
    for label, name, args in _probe_cases("cuda"):
        kern = getattr(ops, name)
        got = kern(*args)
        want = _plain(name)(*args)
        torch.cuda.synchronize()
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"probe: {label} differs from the plain version")
        bound_ms, bound_by, _, _ = _bound(name, args, got)

        def both():
            kern(*args)
            empty()

        split = _device_split(both, KERNEL_FUNCS[name] + ("empty_kernel",))
        floor = split.pop("empty_kernel")
        row = {
            "probe": label, "root": root,
            "ms": sum(split.values()), "split_ms": split, "floor_ms": floor,
            "host_ms": _time_ms(lambda: kern(*args), reps=20),
            "plain_ms": _device_ms(lambda: _plain(name)(*args), reps=3),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        if name == "need_tail":
            row["n_hot_sc_si"] = got[-3:].tolist()
        print(json.dumps(row), flush=True)
    _probe_delta(empty, root)
    _probe_staging_copy()


def phase_full_alone(tree=None):
    """Card, build and full from `tree` (a checkout of this repo; default
    this one): its chip_smoke.py runs them against its own package."""
    import importlib.util

    root = os.path.abspath(tree or ROOT)
    print(json.dumps({"phase": "tree", "root": root}), flush=True)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_tree", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.phase_card()
    smoke.phase_build()
    smoke.phase_full("cuda")


class Timeline:
    """Seconds since the smoke started at the end of each phase: the line
    that says which phase's depth to cut when the smoke nears its time
    limit."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.marks = {}

    def __call__(self, phase: str) -> None:
        self.marks[phase] = round(time.perf_counter() - self.t0, 1)

    def print(self) -> None:
        print(json.dumps({"phase": "timeline", "ended_at_s": self.marks,
                          "seconds": time.perf_counter() - self.t0}),
              flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if "--probe" in sys.argv:
        tree = sys.argv[sys.argv.index("--tree") + 1] if "--tree" in sys.argv else None
        phase_card()
        phase_probe(tree)
        return 0
    if "--full" in sys.argv:
        phase_full_alone(sys.argv[sys.argv.index("--tree") + 1]
                         if "--tree" in sys.argv else None)
        return 0
    if "--runner" in sys.argv or "--fleet" in sys.argv:
        # the runner phase alone on the process defaults (its first
        # sweep's violations are not held against a full phase); with
        # --fleet, then extdata, agent, fleet and process on it
        sys.path.insert(0, ROOT)
        phase_card()
        api = ApiProcess(100_000, 500, catalogue=True)
        phase_build()
        from gatekeeper_tpu_torch.kernels import ops

        mark = Timeline()
        rec = Recorder(ops)
        _, state = phase_runner(rec, None, api=api)
        mark("runner")
        try:
            if "--fleet" in sys.argv:
                phase_extdata(rec, state, n_requests=512)
                mark("extdata")
                phase_agent(rec, state)
                mark("agent")
                phase_fleet(rec, state)
                mark("fleet")
        finally:
            _stop_runner(state)
        if "--fleet" in sys.argv:
            phase_process()
            mark("process")
        mark.print()
        return 0
    if not os.path.isdir(os.path.join(ROOT, "gatekeeper_tpu_torch")):
        print("chip_smoke: gatekeeper_tpu_torch not found beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    mark = Timeline()
    phase_card()
    # the runner phase's apiserver stand-in seeds its 100,000 pods in a
    # process of its own while the phases before it run
    runner_api = ApiProcess(100_000, 500, catalogue=True)
    cold_build_s = phase_build()
    launches_store = phase_store(cold_build_s)
    mark("store")
    phase_native(n_check=1000, n_corpus=25_000)
    mark("native")
    port, ref, drv = phase_parity("cuda", n_pods=250, n_batches=2)
    launches_subset = phase_subset(port, ref, drv, n_batches=2)
    mark("subset")
    # the depth of native (1,000 checked objects and a 25,000-pod corpus,
    # not 2,000 and 100,000), the parity clients (250 pods and 2 review
    # batches, not 1,000 and 4), the three parity phases over HTTP (128
    # requests, not 512),
    # audit_parity and audit_churn (one join constraint each, not 4), full
    # (2 review batches, not 8), webhook and ingest (half the requests, 32
    # sampled answers, not 64), partitions (half the requests),
    # inventory_parity (250 rows and 1 review batch, not
    # 2,000 and 4), inventory (2 review batches, not 8), runner (1,024
    # requests, not 4,096) and extdata (loads of 512, not 1,024) is cut,
    # widths and callers kept, so that the fleet phase fits the smoke's
    # time limit
    phase_audit_parity(port, ref, drv, n_pods=250, n_join=1)
    mark("audit_parity")
    launches_wh_parity, fifo_fields = phase_webhook_parity(port, ref, drv,
                                                           n=128)
    launches_ing_parity, interp_bodies = phase_ingest_parity(
        port, ref, drv, fifo_fields, n=128)
    launches_br_parity = phase_bridge_parity(port, drv, interp_bodies, n=128)
    mark("bridge_parity")
    del port, ref, drv
    rec, launches_full, client, drv, full_counts = phase_full("cuda",
                                                              n_batches=2)
    phase_analysis("full", client, drv)
    mark("full")
    # the depth of these phases is cut (fewer batches, requests and join
    # constraints, no second load; widths and callers kept) so that the
    # process phases below fit the smoke's time limit
    launches_live = phase_liveness(client, drv, rec, n_batches=2)
    phase_profile(client, drv)
    mark("profile")
    launches_webhook = phase_webhook(client, drv, loads=((512, 256),),
                                     n_sample=32)
    launches_ingest = phase_ingest(client, drv, framed=((512, 256, 16),),
                                   bridged=((512, 256, 10_000),), n_sample=32)
    mark("ingest")
    launches_part = phase_partitions(client, drv, rec, n=256)
    mark("partitions")
    launches_churn = phase_audit_churn(client, drv, rec, n_join=1)
    mark("audit_churn")
    del client, drv  # the pod-only cluster; the mixed one comes next
    torch.cuda.empty_cache()
    phase_inventory_parity("cuda", n_rows=250, n_batches=1)
    mark("inventory_parity")
    client, drv, pairs, launches_inv = phase_inventory("cuda", rec,
                                                       n_batches=2)
    phase_analysis("inventory", client, drv)
    mark("inventory")
    launches_out = phase_full_output(client, drv, rec, pairs)
    mark("full_output")
    del client, drv
    torch.cuda.empty_cache()
    launches_runner, state = phase_runner(rec, full_counts, n_requests=1024,
                                          api=runner_api)
    mark("runner")
    try:
        launches_mut, k1_mutation = phase_mutation(rec, state)
        mark("mutation")
        launches_ext = phase_extdata(rec, state, n_requests=512)
        mark("extdata")
        launches_agent, k1_agent = phase_agent(rec, state)
        mark("agent")
        launches_fleet = phase_fleet(rec, state)
        mark("fleet")
    finally:
        _stop_runner(state)
    del state
    torch.cuda.empty_cache()
    phase_process()
    mark("process")
    rows = phase_kernels(
        rec, {"subset": launches_subset, "webhook_parity": launches_wh_parity,
              "ingest_parity": launches_ing_parity,
              "bridge_parity": launches_br_parity,
              "full": launches_full, "liveness": launches_live,
              "webhook": launches_webhook,
              "ingest": launches_ingest, "partitions": launches_part,
              "audit_churn": launches_churn,
              "inventory": launches_inv, "full_output": launches_out,
              "runner": launches_runner, "mutation": launches_mut,
              "extdata": launches_ext, **launches_agent,
              "fleet": launches_fleet},
        extra={name: dict(
            {"store_launches": launches_store[name]},
            **({"mutation_screen": k1_mutation, "agent_review": k1_agent}
               if name == "match_matrix" else {}))
            for name in KERNELS},
    )
    mark("kernels")
    phase_variants()
    mark("variants")
    mark.print()
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
