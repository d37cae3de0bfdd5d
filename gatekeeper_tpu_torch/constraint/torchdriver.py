"""TorchDriver: the fused violation path on one CUDA device.

The torch counterpart of gatekeeper_tpu/constraint/tpudriver.py
(TpuDriver), slimmed to the fused violation path: an audit sweep
(`Client.audit`) and an admission micro-batch (`Client.review_many` ->
`query_many`) both encode their reviews into token tensors, stage the
policy and the corpus on the device, run one fused need dispatch
(parallel/fused.py: match kernel ∧ compiled template programs ∧ need tail)
and decode the sparse (review, constraint) pairs that need host work. Those
pairs render from the programs' compiled branch plans (engine/render.py)
where the plans prove an exact render, and on the interpreter otherwise.

Templates the symbolic compiler cannot compile, and rows whose array
fanout exceeds the device bucket cap (G_CAP), route to the interpreter, so
results equal the interpreter driver's (RegoDriver) in content and order.

Inventory-join templates (gatekeeper-library's uniqueingresshost and
uniqueserviceselector shapes) compile to screens. Their "invdup:" row
features, per-row bits that a join key is duplicated in the inventory,
are computed on the host from inventory value counts and staged as
[K, chunk] planes beside the corpus; flagged pairs render on the
interpreter against the derived-key prune index's candidates, not the
whole inventory (`stats["pruned_renders"]`).

Routing is verdict-first: the static analyzer (analysis/analyzer.py)
decides per template whether compilation is attempted; INTERPRETER and
INVALID templates route with their diagnostic code (`stats
["fallback_codes"]`), and a template the analyzer calls compilable that the
compiler refuses is a counted consistency failure (`analyzer_mismatches`,
code GK-V999), not a routing mechanism. A review batch encodes under
its constraint set's IR feature-liveness mask (analysis/ir.py): token
columns no compiled program can read are dropped before padding
(`columns_skipped_static`); the audit corpus encodes keep-all.

Every micro-batch goes to the device: PyTorch compiles nothing, so there
is no cold kernel to serve around and no small-batch interpreter route.
Every fused need dispatch passes the fault point `driver.device_dispatch`,
as the reference's does; a failure there is raised to the caller (the
webhook answers the batch with its fail policy), never answered on the
host. A partition-scoped review (`query_many_subset`) is one fused
dispatch of a constraint set cut to the subset, behind the fault point
`driver.device_dispatch[device=N]`; its set carries forward across a
constraint generation whose content signature for the subset is
unchanged, and `prepare_subset` stages a changed one as a shadow and
swaps it in. With an integrity plane (`set_integrity`) every fused review
dispatch packs canary reviews into its padding slots and strips them
before any result is returned, and a shadow swaps only after replaying
the golden canaries; with a cost attributor (`set_attributor`) each
dispatch's measured `phase_seconds["dispatch"]` is apportioned over its
constraints by static cost. The host oracle (`query_host`, the shadow
oracle's path) lets fused dispatches queued on the serving mutex go first
(for at most ORACLE_YIELD_S). Reviews encode with the C token flattener
(native/flatten.c, built with gcc on first use; a failed build raises)
unless the caller passes encoder="python": the setting for a host with no
C compiler, such as a serving image without gcc, which then encodes
several times slower (PERF.md §5).

External data (`set_external_data`): a template whose analyzer report
records `external_data` calls compiles with an "extdata:<kind>:<err|all>"
row feature. Each batch and each sweep opens one fetch epoch and
prefetches its deduped keys (one outbound fetch per provider); the
feature's per-row bits are computed from the live response cache on every
dispatch and staged volatile, never cached on the corpus, so a TTL expiry
routes the rows back to the interpreter's re-check.

Metrics: with a MetricsRegistry (`metrics=`, or `set_metrics` when the
Runner builds its registry after the driver) the driver records the
reference's series at the counterpart of each reference site, with its
names and tag keys: the verdict gauges and fallback, mismatch and
compile-plane counters; `batch_occupancy_percent` and
`padding_waste_rows_total` per corpus staging (`path` audit or webhook);
`driver_pairs_total` (`route`, `path`), `driver_render_total` (`route`)
and `driver_phase_seconds` (`phase`, `path`) per evaluation;
`driver_render_cache_evictions_total`, `driver_hot_redispatch_total`
and `driver_render_errors_total`. `driver_phase_seconds` takes its
`phase` values from `stats["phase_seconds"]`: `policy`, `encode`,
`stage`, `row_features`, `dispatch`, `decode` and `render`. Of the
reference's three, `flatten_encode` stands as `encode` (the constraint
set's `policy` before it), `device_dispatch` as `dispatch` (the staging,
row features and decode around it have phases of their own) and
`render` as `render`. Not emitted, as no site here counts them:
`driver_cold_batches_total` (no batch is served around a cold kernel)
and `program_cache_total` / `program_compile_seconds` (jit
specializations; PyTorch compiles none, parallel/fused.py).
The compile-artifact store (`program_store`, compile/) is the process's
(kernels/build.py `process_store`) on a CUDA driver and None on the CPU,
as the reference's is None without JAX: it gates the kernel and native
libraries, its fingerprint enters each subset signature, the integrity
plane keeps its golden sets beside it, and `attest()` runs after a warm
and after a subset swap, where the reference's does. The warm path is the reference's minus
the interpreter: `warm_review_path` compiles and stages the policy, and
encodes the audit corpus a policy with row features overlays, ahead of
the first batch (a batch that comes first waits for it on the serving
mutex, never goes to the interpreter), and `review_path_warm` says
whether it has for the current constraints.

Constraint churn is counted per target as well as in all
(`constraint_generation`): a target's compiled set, its warm state, its
monolithic canaries' golden key, its render cache and its IR report are
valid for its own generation (`_target_generation`), so creating the
agent target's constraints on a serving process leaves the K8s set
compiled, staged and warm. The partition plane's subset sets follow
their target's generation too; its plans follow the generation of all
targets (`constraint_generation`), as in the reference.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import threading
import time
from collections import OrderedDict
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..analysis import CODE_MISMATCH, VectorizabilityReport, analyze_modules
from ..engine.exprs import EvalCtx
from ..engine.matchkernel import features_to_np, matchspec_to_np
from ..engine.patterns import PatternRegistry, _match
from ..engine.programs import Program, compile_program
from ..engine.render import RenderSet
from ..engine.symbolic import CompilerEnv, CompileUnsupported
from ..engine.tables import StrTables
from ..flatten.encoder import (
    _bucket,
    batch_review_features,
    encode_token_table,
    mask_token_table,
    unesc_seg,
)
from ..faults import FaultError, device_point, fire
from ..flatten.vocab import OverlayVocab, Vocab
from ..kernels.build import process_store
from ..parallel.fused import FusedKernel, decode_need
from ..rego import ast as A
from ..rego.interp import RegoError, Undefined, _call_function
from ..rego.values import freeze, thaw
from . import hooks as H
from .driver import (
    _HOOK_RE,
    RegoDriver,
    _autoreject_result,
    _cname,
    constraint_key,
)
from .types import Response, Result

_TEMPLATE_PREFIX_RE = re.compile(r'^templates\["([^"]+)"\]\["([^"]+)"\]$')

# Array-axis fanout cap for device evaluation: rows with more elements on
# a lifted array axis route to the interpreter (EGroup drops idx >= g).
G_CAP = 64

# Resource-axis chunk of a device dispatch.
N_CHUNK = 32768

# Hot-row window of the whole-corpus dispatch; a chunk with more hot rows
# is re-dispatched alone with a larger window.
R_CAP = 1024

# Longest the host oracle (query_host) waits for queued fused dispatches
# before it takes the serving mutex anyway.
ORACLE_YIELD_S = 1.0


def _params_key(params: Any) -> str:
    return json.dumps(params, sort_keys=True, default=str)


@dataclass
class _Corpus:
    """Encoded review corpus: the persistent audit corpus (cached until
    data changes) or an ephemeral review batch (data_gen -1)."""

    data_gen: int
    reviews: List[Any]
    tok: Dict[str, np.ndarray]
    fb: Dict[str, np.ndarray]
    g: int  # first-level array fanout bucket (idx0)
    g1: int  # second-level fanout bucket (idx1)
    row_fallback: np.ndarray  # [N] bool: route row to interpreter
    staged: Any = None  # parallel.fused.StackedCorpus, staged lazily
    # per-row screen features (invdup join bits), host copies
    row_feats: Optional[Dict[str, np.ndarray]] = None
    # per-pattern join-key value counts: pid -> (counts, has_fallback)
    value_counts: Optional[Dict[int, Any]] = None
    # ephemeral vocab overlay (review batches): the batch's novel strings
    # and their pattern/table rows, never interned globally
    vocab: Any = None
    v_base: int = 0
    ov_member: Optional[np.ndarray] = None  # [B_pad, P] bool
    ov_capture: Optional[np.ndarray] = None  # [B_pad, P] int32
    ov_tabs: Optional[Dict[str, np.ndarray]] = None  # name -> [B_pad]
    # token slots the IR feature-liveness mask dropped before padding
    # (analysis/ir.py); 0 when encoded keep-all
    skipped_static: int = 0
    # external-data keys per "extdata:" feature: (a list aligned with
    # reviews of {provider -> keys}, None = unextractable row; their
    # union over every row and call)
    ext_keys: Optional[Dict[str, Any]] = None


@dataclass
class _ConstraintSet:
    """Compiled constraint-side state, cached until constraints change."""

    # its target's constraint generation (_target_generation)
    constraint_gen: int
    constraints: List[Dict[str, Any]]
    ms: Dict[str, np.ndarray]
    programs: List[Optional[Program]]  # index-aligned; None => interpreter
    policy: Any = None  # parallel.fused.StagedPolicy, staged lazily
    # kind -> analyzer diagnostic code for interpreter-routed templates
    # (CODE_MISMATCH when the analyzer predicted compilable but the
    # compiler disagreed)
    fallback_codes: Optional[Dict[str, str]] = None
    # content signature of a subset set's constraints and template IR: a
    # constraint-generation bump that leaves it unchanged carries the set
    # (and its staged policy) forward
    signature: Optional[str] = None
    # IR feature liveness over the set's programs, computed once: False =
    # not yet, None = keep-all (some program failed the pad-equivalence
    # proof), frozenset = live pattern indices
    live_pids: Any = False
    # the whole set only: the slab column map its subsets stage through,
    # computed once when the whole set's own policy is not staged
    cols: Any = None


class TorchDriver(RegoDriver):
    """Fused-path driver on one CUDA device (or, when the caller asks,
    on the CPU through the kernels' plain versions)."""

    def __init__(
        self, device: Any = None, encoder: str = "native", metrics=None,
    ):
        super().__init__()
        if encoder not in ("native", "python"):
            raise ValueError(
                f"TorchDriver: encoder must be 'native' or 'python', got "
                f"{encoder!r}"
            )
        # "python" is the caller's explicit request for the Python encoder,
        # for a host that cannot build the C flattener
        self.encoder = encoder
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchDriver: no CUDA device is available; pass "
                "device='cpu' to run on the CPU"
            )
        self.device = dev
        self.vocab = Vocab()
        self.patterns = PatternRegistry(self.vocab)
        self.tables = StrTables(self.vocab)
        self.kernel = FusedKernel(self.patterns, self.tables, dev)
        # (target, kind) -> rewritten template modules
        self._kind_modules: Dict[Tuple[str, str], List[A.Module]] = {}
        # (target, kind, params_key) -> Program | None (None = interpreter)
        self._programs: Dict[Tuple[str, str, str], Optional[Program]] = {}
        self._data_gen = 0
        self._constraint_gen = 0
        # target -> its constraint generation (_target_generation)
        self._target_gens: Dict[str, int] = {}
        self._corpus: Dict[str, _Corpus] = {}
        self._cset: Dict[str, _ConstraintSet] = {}
        # target -> the constraint generation warm_review_path compiled
        self._review_warm: Dict[str, int] = {}
        # partition-scoped sets per (target, subset of constraint keys),
        # oldest dropped first past _cset_sub_max
        self._cset_sub: "OrderedDict[Tuple[str, frozenset], _ConstraintSet]" = (
            OrderedDict()
        )
        self._cset_sub_max = 64
        # rendered-pair cache of the audit corpus, per target, valid for
        # one (data, constraint) generation: violating pairs that persist
        # across sweeps skip the re-render
        self._render_cache: Dict[
            str, Tuple[Tuple[int, int], "OrderedDict[Tuple[int, int], List[Result]]"]
        ] = {}
        self.render_cache_max = 65536
        self._render_errors = 0  # compiled-render failures sent to interp
        self._render_cache_evictions = 0  # oldest rendered pairs dropped
        self._hot_redispatches = 0  # chunks rerun for hot-row overflow
        # derived-key prune render caches (inventory joins): key index per
        # data generation, and the helper oracles that build keys
        self._prune_indexes: Dict[Tuple, Tuple[int, Any]] = {}
        self._prune_oracles: Dict[Tuple, Any] = {}
        self._prune_build_s = 0.0  # seconds spent building key indexes
        # last query's pair routing, render split and phase seconds
        self.stats: Dict[str, Any] = {}
        # optional MetricsRegistry: per-template verdict gauges, fallback
        # and analyzer-mismatch counters, compile-plane and liveness
        # counters land here when wired
        self.metrics = metrics
        # (target, kind) -> VectorizabilityReport, computed once per
        # mounted module set (the admission-time analyzer, re-run here so
        # the driver owns its routing decision even for modules mounted
        # without going through Client.add_template)
        self._analysis: Dict[Tuple[str, str], VectorizabilityReport] = {}
        # analyzer-says-compilable but CompileUnsupported raised
        self.analyzer_mismatches = 0
        # (target, kind) -> diagnostic code for interpreter-routed
        # templates (machine-readable fallback reason)
        self._fallback_codes: Dict[Tuple[str, str], str] = {}
        # obs.CostAttributor (set_attributor): every fused dispatch's
        # measured seconds apportioned per constraint by static cost
        self.attributor = None
        # integrity.IntegrityPlane (set_integrity): canary rows in each
        # dispatch's padding slots and the golden swap gate; None = off
        self.integrity = None
        # incremental compile plane: template IR hashes and per-subset
        # content signatures; churn restages only the subsets whose
        # signature changed, and staged shadow sets swap in atomically
        self._ir_hashes: Dict[Tuple[str, str], str] = {}
        self._sig_cache: Dict[Tuple[str, frozenset], Tuple[int, str]] = {}
        self._swap_gen = 0
        self.program_compiles = 0  # compile_program invocations
        # compile.ProgramStore: the process's store on the card (None when
        # GATEKEEPER_TPU_NO_COMPILE_CACHE=1), None on the CPU
        self.program_store = (
            process_store() if dev.type == "cuda" else None
        )
        self.subset_swaps = 0  # shadow sets swapped live
        self.subset_carryforwards = 0  # generation bumps a signature served
        # IR feature liveness (analysis/ir.py): review batches encode under
        # their constraint set's mask, dropping token columns no compiled
        # program reads before padding. The audit corpus always encodes
        # keep-all (it is cached per data generation, across constraint
        # churn). The environment switch turns it off for parity audits.
        self.liveness_enabled = (
            os.environ.get("GATEKEEPER_TPU_NO_STATIC_LIVENESS", "") == ""
        )
        self.columns_skipped_static = 0  # cumulative dead slots dropped
        self.liveness_batches = 0  # batches encoded under a live mask
        # target -> (constraint_gen, IrReport), computed lazily
        self._ir_reports: Dict[str, Tuple[int, Any]] = {}
        # externaldata.ExternalDataSystem (set_external_data): batch
        # prefetch and the extdata row-feature screens; None = no plane
        self.external_data = None
        # fused dispatches waiting for the serving mutex (_serving)
        self._fused_waiting = 0
        self._waiting_lock = threading.Lock()

    # -- module/data bookkeeping (cache invalidation) ------------------------

    def put_modules(self, prefix: str, modules: Sequence[A.Module]) -> None:
        super().put_modules(prefix, modules)
        m = _TEMPLATE_PREFIX_RE.match(prefix)
        if m:
            with self._mutex:
                self._kind_modules[(m.group(1), m.group(2))] = list(modules)
                self._drop_programs(m.group(1), m.group(2))

    def delete_modules(self, prefix: str) -> int:
        n = super().delete_modules(prefix)
        m = _TEMPLATE_PREFIX_RE.match(prefix)
        if m:
            with self._mutex:
                self._kind_modules.pop((m.group(1), m.group(2)), None)
                self._drop_programs(m.group(1), m.group(2))
        return n

    def _drop_programs(self, target: str, kind: str) -> None:
        for cache in (self._programs, self._prune_oracles, self._prune_indexes):
            for key in [k for k in cache if k[:2] == (target, kind)]:
                del cache[key]
        self._analysis.pop((target, kind), None)
        self._fallback_codes.pop((target, kind), None)
        self._ir_hashes.pop((target, kind), None)
        self._ir_reports.pop(target, None)
        self._cset.pop(target, None)
        self._note_constraint_change(target)

    def put_data(self, path: str, data: Any) -> None:
        super().put_data(path, data)
        self._note_data_change(path)

    def delete_data(self, path: str) -> bool:
        existed = super().delete_data(path)
        self._note_data_change(path)
        return existed

    def _inventory(self, target: str) -> Any:
        """The frozen inventory, cached per external-data generation. The
        base driver keys it on its data version, which every write moves,
        so each constraint change would freeze the whole inventory again
        on the next interpreter call: seconds at 100,000 objects, spent
        under the serving mutex by the golden canaries of the restage
        that follows a churn."""
        cached = self._frozen_inv.get(target)
        if cached is not None and cached[0] == self._data_gen:
            return cached[1]
        inv = self.storage.get(["external", target], None)
        frozen = freeze(inv if inv is not None else {})
        self._frozen_inv[target] = (self._data_gen, frozen)
        return frozen

    def _note_data_change(self, path: str) -> None:
        with self._mutex:
            p = path.lstrip("/")
            if p.startswith("external") or not p:
                self._data_gen += 1
            if p.startswith("constraints") or not p:
                # "constraints/<target>/...": that target's churn; the
                # root or "constraints" itself: every target's
                parts = p.split("/")
                self._note_constraint_change(
                    parts[1] if len(parts) > 1 and parts[1] else None
                )

    def _note_constraint_change(self, target: Optional[str]) -> None:
        """Count one constraint or template change of `target` (None:
        of every target). Caller holds the mutex."""
        self._constraint_gen += 1
        targets = list(self._target_gens) if target is None else [target]
        for t in targets:
            self._target_gens[t] = self._target_gens.get(t, 0) + 1

    def _target_generation(self, target: str) -> int:
        """The constraint generation of `target` alone: it moves with the
        changes of that target's constraints and templates, and with
        changes of every target's, not with another target's. State
        cached for a target was keyed by this, which enters the target
        in `_target_gens`, so a change of every target reaches it."""
        return self._target_gens.setdefault(target, 0)

    # -- program compilation -------------------------------------------------

    def _make_oracle(self, target: str, kind: str, params: Any):
        """Interpreter-backed helper-function oracle for the symbolic
        compiler (pure template helpers -> per-vocab lookup tables)."""
        node = self.interp._pkg_node(["templates", target, kind], create=False)
        if node is None:
            return lambda fn_name, value: (None, False)
        ctx = self.interp.make_context({"parameters": params}, {})

        def oracle_fn(fn_name: str, value: Any, extra=None):
            if extra is not None:
                sym_idx, consts = extra
                call_args = [freeze(c) for c in consts]
                call_args[sym_idx] = freeze(value)
            else:
                call_args = [freeze(value)]
            try:
                v = _call_function(ctx, None, node, fn_name, call_args)
            except RegoError:
                return None, False
            if v is Undefined:
                return None, False
            return thaw(v), True

        return oracle_fn

    # -- planes wired in by the serving process --------------------------------

    def set_external_data(self, system) -> None:
        """Wire the process's ExternalDataSystem (Runner/tests): the
        driver prefetches each batch's deduped keys through it and
        fills the extdata row-feature screens from its cache."""
        self.external_data = system

    def set_metrics(self, metrics) -> None:
        """Late metrics wiring (the Runner builds its registry after the
        driver): the registry goes to the compile-artifact store too when
        it has none, and every verdict already analysed is exported."""
        self.metrics = metrics
        if (
            self.program_store is not None
            and self.program_store.metrics is None
        ):
            self.program_store.metrics = metrics
        for (_t, kind), rep in list(self._analysis.items()):
            self._export_verdict(kind, rep)

    def set_attributor(self, attributor) -> None:
        """Wire an obs.CostAttributor: from here on every fused dispatch's
        measured `phase_seconds["dispatch"]` is apportioned per
        constraint."""
        self.attributor = attributor

    def set_integrity(self, plane) -> None:
        """Wire an integrity.IntegrityPlane: from here on every fused
        review dispatch packs canary rows into its padding slots and
        reports their verdict digests, and prepare_subset gates swaps on
        a golden-batch replay."""
        self.integrity = plane
        if plane is not None:
            plane.bind_driver(self)

    def _interp_closure(self, target: str, constraints):
        """Host-interpreter ground truth for the canary golden sets: ONE
        review against exactly the constraint set the fused dispatch
        serves. Called under the serving mutex (reentrant) the first time
        a signature needs its golden set. A set whose templates read no
        inventory evaluates against an empty one: freezing the synced
        objects takes seconds per 100,000 under the mutex, and the frozen
        tree's millions of objects lengthen every later collection."""
        constraints = list(constraints)
        inventory = (
            None if self._reads_inventory(target, constraints)
            else freeze({})
        )

        def interp(review):
            with self._mutex:
                return RegoDriver._violation(
                    self, target, {"review": review}, None,
                    constraints=constraints, inventory=inventory,
                )
        return interp

    def _inventory_for(self, target: str, constraints) -> Any:
        """The frozen inventory for an interpreter evaluation of
        `constraints`, or an empty one when none of their templates may
        read it (_reads_inventory): freezing the synced objects takes
        seconds per 100,000 under the serving mutex, and the frozen
        tree's millions of objects lengthen every later collection."""
        if self._reads_inventory(target, constraints):
            return self._inventory(target)
        return freeze({})

    def _reads_inventory(self, target: str, constraints) -> bool:
        """Whether a template of `constraints` may read data.inventory:
        its analyzer report has an inventory ref (GK-V006) or a dynamic
        ref (GK-V004), or routes it to the interpreter, or is missing."""
        with self._mutex:
            for kind in {c.get("kind") for c in constraints}:
                rep = self.template_report(target, kind)
                if rep is None or not rep.compilable or {
                    "GK-V006", "GK-V004"
                } & set(rep.codes):
                    return True
        return False

    def _canary_pack(
        self, target: str, sigkey: str, constraints, n: int
    ) -> List[Any]:
        """Up to K canary reviews for a dispatch of `n` live reviews, as
        many as the padding slots of its chunk bucket (the _stage_corpus
        formula), so packing them never grows the staged shape. The
        caller strips their results before any merge and reports them
        through _canary_check after releasing the serving mutex."""
        integ = self.integrity
        if integ is None:
            return []
        if self._reads_external_data(target, constraints):
            # a canary's synthetic keys must never reach a real provider
            # (nor add a second fetch to the batch's epoch): the set's
            # dispatches carry no canaries
            return []
        chunk = min(N_CHUNK, _bucket(n, lo=64))
        slots = chunk * -(-n // chunk) - n
        if slots <= 0:
            return []
        try:
            return list(integ.canaries_for(
                target, sigkey, constraints,
                self._interp_closure(target, constraints), slots,
            ))
        except Exception:
            return []  # integrity accounting must never fail a dispatch

    def _reads_external_data(self, target: str, constraints) -> bool:
        """True when some constraint's template calls external_data (its
        analyzer report records the call sites)."""
        for kind in {c.get("kind") for c in constraints}:
            rep = self.template_report(target, kind) if kind else None
            if rep is not None and rep.external_calls:
                return True
        return False

    def _canary_check(
        self, target: str, sigkey: str, device, canary_split, subset=None,
    ) -> None:
        """Digest-compare the stripped canary verdicts against the golden
        set (off the serving mutex: the plane may trip quarantine)."""
        integ = self.integrity
        if integ is None or not canary_split:
            return
        try:
            integ.check_canaries(
                target, sigkey, device, canary_split, subset=subset
            )
        except Exception:
            pass  # integrity accounting must never fail a dispatch

    @staticmethod
    def _static_cost(program) -> float:
        """Static cost weight of one constraint: the compiled program's
        expression rows (its signature length plus its constant payload)
        times its row-feature width. Interpreter-routed constraints
        (program None) weigh a flat 1: they cost host time per matching
        pair, but must still appear in the table."""
        if program is None:
            return 1.0
        rows = max(1, len(program.signature))
        consts = sum(int(np.size(v)) for v in program.consts.values())
        width = 1 + len(program.row_features)
        return float((rows + consts) * width)

    def _attribute_dispatch(self, cs, seconds: float, partition) -> None:
        """Feed one measured dispatch window to the attributor,
        apportioned over `cs`'s constraints by static weight. Called
        under the serving mutex: the attributor does dict math only."""
        if self.attributor is None or seconds <= 0.0:
            return
        try:
            entries = []
            for c, prog in zip(cs.constraints, cs.programs):
                meta = c.get("metadata") or {}
                entries.append((
                    str(c.get("kind", "")),
                    str(meta.get("name", "")),
                    self._static_cost(prog),
                ))
            self.attributor.note_dispatch(
                entries, seconds, partition=partition
            )
        except Exception:
            pass  # accounting must never fail a dispatch

    # -- verdict-first routing (the static analyzer) ---------------------------

    def attach_report(
        self, target: str, kind: str, report: VectorizabilityReport
    ) -> None:
        """Re-attach the admission-time analyzer report after a module
        swap: put_modules just dropped this kind's analysis, and
        Client.add_template hands its report straight back so the
        verdict and its fallback code survive until the next dispatch."""
        if report is None:
            return
        with self._mutex:
            self._analysis[(target, kind)] = report
            if not report.compilable:
                self._fallback_codes[(target, kind)] = (
                    report.primary_code() or "GK-V007"
                )
        self._export_verdict(kind, report)

    def template_report(
        self, target: str, kind: str
    ) -> Optional[VectorizabilityReport]:
        """The analyzer's verdict for a mounted template (None when the
        kind has no modules mounted). Computed once per module set."""
        key = (target, kind)
        rep = self._analysis.get(key)
        if rep is None:
            mods = self._kind_modules.get(key)
            if mods is None:
                return None
            rep = analyze_modules(kind, mods)
            self._analysis[key] = rep
            self._export_verdict(kind, rep)
        return rep

    def _export_verdict(self, kind: str, rep: VectorizabilityReport) -> None:
        if self.metrics is None:
            return
        self.metrics.gauge(
            "template_vectorization", 1, kind=kind, verdict=rep.verdict
        )
        for code in rep.codes:
            n = sum(1 for d in rep.diagnostics if d.code == code)
            self.metrics.gauge(
                "template_analysis_diagnostics", n, kind=kind, code=code
            )

    def _note_fallback(self, kind: str, code: str) -> None:
        self._count("template_fallback_total", kind=kind, code=code)

    def _count(self, name: str, value: float = 1, **tags) -> None:
        if self.metrics is not None:
            self.metrics.record(name, value, **tags)

    def _program_for(
        self, target: str, constraint: Dict[str, Any]
    ) -> Optional[Program]:
        kind = constraint.get("kind")
        if not isinstance(kind, str):
            return None
        mods = self._kind_modules.get((target, kind))
        if mods is None:
            return None
        params = H.constraint_parameters(constraint)
        key = (target, kind, _params_key(params))
        if key in self._programs:
            return self._programs[key]
        # verdict-first routing: INTERPRETER/INVALID templates route with
        # their diagnostic code before any compile
        report = self.template_report(target, kind)
        if report is not None and not report.compilable:
            code = report.primary_code() or "GK-V007"
            self._fallback_codes[(target, kind)] = code
            self._note_fallback(kind, code)
            self._programs[key] = None
            return None
        extdata_feature = None
        if report is not None:
            mode = getattr(report, "extdata_mode", lambda: None)()
            if mode is not None:
                # feature encoding consumed by _extdata_row_bits:
                # extdata:<kind>:<err|all>
                extdata_feature = f"extdata:{kind}:{mode}"
        env = CompilerEnv(
            self.vocab,
            self.patterns,
            self.tables,
            oracle_fn=self._make_oracle(target, kind, params),
            oracle_ns=f"{kind}|{key[2]}",
            oracle_ns_shared=f"{target}|{kind}",
            template_kind=kind,
            extdata_feature=extdata_feature,
        )
        self.program_compiles += 1
        self._count("program_store_compiles_total", kind=kind)
        if self.program_store is not None:
            self.program_store.note_miss()
        try:
            prog = compile_program(env, mods, params)
        except CompileUnsupported as e:
            # the analyzer promised compilability: a disagreement is a
            # counted consistency failure, and the template interprets
            self.analyzer_mismatches += 1
            self._fallback_codes[(target, kind)] = CODE_MISMATCH
            self._note_fallback(kind, CODE_MISMATCH)
            self._count("analyzer_compile_mismatch_total", kind=kind)
            logging.getLogger("gatekeeper_tpu_torch.analysis").warning(
                "analyzer/compiler disagreement: %s predicted compilable "
                "but compilation gave up: %s", kind, e,
            )
            prog = None
        self._programs[key] = prog
        return prog

    def _constraint_set(self, target: str) -> Optional[_ConstraintSet]:
        gen = self._target_generation(target)
        cs = self._cset.get(target)
        if cs is not None and cs.constraint_gen == gen:
            return cs
        constraints = self._constraints(target)
        if not constraints:
            self._cset.pop(target, None)
            return None
        ms = self._handler(target).compile_match_specs(constraints, self.vocab)
        programs = [self._program_for(target, c) for c in constraints]
        live = {
            (target, c.get("kind"), _params_key(H.constraint_parameters(c)))
            for c in constraints
        }
        for key in [k for k in self._programs if k[0] == target and k not in live]:
            del self._programs[key]
        cs = _ConstraintSet(
            constraint_gen=gen,
            constraints=constraints,
            ms=matchspec_to_np(ms),
            programs=programs,
            fallback_codes=self._set_fallback_codes(
                target, constraints, programs
            ),
        )
        self._cset[target] = cs
        return cs

    def _set_fallback_codes(self, target, constraints, programs):
        """kind -> diagnostic code of every interpreter-routed template in
        a constraint set."""
        return {
            c["kind"]: self._fallback_codes.get((target, c["kind"])) or "GK-V007"
            for c, p in zip(constraints, programs)
            if p is None and isinstance(c.get("kind"), str)
        }

    def warm_review_path(self, target: str, reviews: Sequence[Any]) -> bool:
        """The first admission batch's one-time host work, done ahead of
        it under the serving mutex: compile `target`'s constraint set (the
        symbolic compile of each template's program) and stage its policy
        on the device, then encode `reviews` as a batch is encoded,
        without a dispatch; for a set with row features that encodes the
        audit corpus whose vocab every batch overlays (the reference's
        warm path pays it too). The Runner's warm thread calls it through
        Client.warm_review_path once the state is ingested and after each
        constraint change. No kernel compiles per batch shape."""
        with self._mutex:
            gen = self._target_generation(target)
            cs = self._constraint_set(target)
            reviews = list(reviews)
            if cs is not None:
                self._staged_policy(target, cs)
                if reviews:
                    self._ephemeral_corpus(
                        target, cs, reviews, self._ns_cache(target)
                    )
            self._review_warm[target] = gen
        # content-address and attest whatever the warm built into the
        # store's lib dir, so identical machines can adopt it
        if self.program_store is not None:
            self.program_store.attest()
        return True

    def review_path_warm(self, target: str) -> bool:
        """True when warm_review_path compiled `target`'s set for its
        current constraint generation."""
        return self._review_warm.get(target) == self._target_generation(
            target
        )

    def constraint_generation(self) -> int:
        """Constraint/template churn only (the base driver's data version
        moves on every write): the partition plane rebuilds its plan when
        this moves."""
        return self._constraint_gen

    def constraint_costs(self, target: str) -> Dict[str, float]:
        """Static-cost planner weights (see _static_cost) per constraint
        key, compiling through the shared `_programs` cache."""
        with self._mutex:
            return {
                constraint_key(c): self._static_cost(
                    self._program_for(target, c)
                )
                for c in self._constraints(target)
            }

    # -- incremental compile plane -------------------------------------------

    def _ir_hash(self, target: str, kind: str) -> str:
        """Content hash of a template's rewritten IR modules (AST nodes
        are dataclasses, so repr() is a stable structural rendering);
        memoized until put/delete_modules drops the kind."""
        key = (target, kind)
        h = self._ir_hashes.get(key)
        if h is None:
            mods = self._kind_modules.get(key)
            h = (
                hashlib.sha256(repr(mods).encode()).hexdigest()[:16]
                if mods is not None else ""
            )
            self._ir_hashes[key] = h
        return h

    def _subset_signature(self, target: str, subset: frozenset) -> str:
        """Content signature of one partition's sub-program: per member
        constraint, (key, template IR hash, constraint payload), plus the
        program store's machine fingerprint ("" without a store). Two
        constraint generations with equal
        signatures stage identical sub-programs, which licenses the
        carry-forward. Memoized per constraint generation (caller holds
        the mutex)."""
        key = (target, subset)
        gen = self._target_generation(target)
        hit = self._sig_cache.get(key)
        if hit is not None and hit[0] == gen:
            return hit[1]
        parts = []
        for c in self._constraints(target):
            ck = constraint_key(c)
            if ck not in subset:
                continue
            kind = c.get("kind")
            parts.append((
                ck,
                self._ir_hash(target, kind if isinstance(kind, str) else ""),
                json.dumps(c, sort_keys=True, default=str),
            ))
        parts.sort()
        fp = (
            self.program_store.fp_digest
            if self.program_store is not None
            else ""
        )
        sig = hashlib.sha256(json.dumps([fp, parts]).encode()).hexdigest()[:16]
        if len(self._sig_cache) >= 4 * self._cset_sub_max:
            self._sig_cache.pop(next(iter(self._sig_cache)), None)
        self._sig_cache[key] = (gen, sig)
        return sig

    def subset_signature(self, target: str, subset) -> str:
        """Public (dispatcher-facing) form of `_subset_signature`."""
        with self._mutex:
            return self._subset_signature(target, frozenset(subset))

    def subset_ready(self, target: str, subset) -> bool:
        """True when `subset`'s sub-program can serve a fused dispatch
        without compiling or staging: its set is cached with a staged
        policy and its content signature matches the current
        constraints."""
        with self._mutex:
            fs = frozenset(subset)
            cs = self._cset_sub.get((target, fs))
            if cs is None or cs.policy is None:
                return False
            if cs.constraint_gen == self._target_generation(target):
                return True
            return (
                cs.signature is not None
                and cs.signature == self._subset_signature(target, fs)
            )

    def swap_generation(self) -> int:
        """Monotonic count of sub-program swaps (prepare_subset landing a
        shadow set live)."""
        return self._swap_gen

    def compile_plane_stats(self) -> Dict[str, Any]:
        """Compile-plane counters + program-store view, the driver side
        of /debug/programs and the compile_storm flight record."""
        with self._mutex:
            out: Dict[str, Any] = {
                "constraint_generation": self._constraint_gen,
                "swap_generation": self._swap_gen,
                "program_compiles": self.program_compiles,
                "subset_swaps": self.subset_swaps,
                "subset_carryforwards": self.subset_carryforwards,
                "analyzer_mismatches": self.analyzer_mismatches,
            }
        store = self.program_store
        if store is not None:
            out["store"] = store.stats()
        return out

    def _carry_forward(
        self, target: str, subset: frozenset, cs: _ConstraintSet
    ) -> bool:
        """Serve `subset`'s cached set across a constraint-generation bump
        when its signature is unchanged (caller holds the mutex)."""
        sig = self._subset_signature(target, subset)
        if cs.signature is None or cs.signature != sig:
            return False
        cs.constraint_gen = self._target_generation(target)
        self.subset_carryforwards += 1
        self._count("program_carryforward_total", target=target)
        return True

    def _subset_cset(
        self, target: str, subset: frozenset
    ) -> Optional[_ConstraintSet]:
        """The constraint set of `subset`'s constraints only, with its own
        match specs and (lazily staged) device policy; None when the
        subset names no constraint. Cached per (target, subset); a
        generation bump whose content signature is unchanged carries the
        cached set forward instead of rebuilding it."""
        key = (target, subset)
        cs = self._cset_sub.get(key)
        if cs is not None and cs.constraint_gen == self._target_generation(
            target
        ):
            return cs
        if cs is not None and self._carry_forward(target, subset, cs):
            return cs
        cs = self._build_subset_cset(target, subset)
        if cs is None:
            self._cset_sub.pop(key, None)
            return None
        self._cset_sub.pop(key, None)
        while len(self._cset_sub) >= self._cset_sub_max:
            self._cset_sub.popitem(last=False)
        self._cset_sub[key] = cs
        return cs

    def _build_subset_cset(
        self, target: str, subset: frozenset
    ) -> Optional[_ConstraintSet]:
        """Build (but do not cache) a subset constraint set, in
        `_constraints`' order. Programs come from the shared `_programs`
        cache and, unlike `_constraint_set`, none is evicted here: the
        whole set may still use it."""
        # the whole set first: its column map is the one the subset stages
        # through (_staged_policy), and every pattern its programs register
        # must exist before a review batch takes its overlay snapshot
        full = self._constraint_set(target)
        constraints = [
            c for c in (full.constraints if full is not None else [])
            if constraint_key(c) in subset
        ]
        if not constraints:
            return None
        ms = self._handler(target).compile_match_specs(constraints, self.vocab)
        programs = [self._program_for(target, c) for c in constraints]
        return _ConstraintSet(
            constraint_gen=self._target_generation(target),
            constraints=constraints,
            ms=matchspec_to_np(ms),
            programs=programs,
            fallback_codes=self._set_fallback_codes(
                target, constraints, programs
            ),
            signature=self._subset_signature(target, subset),
        )

    def _policy_cols(self, target: str, cs: _ConstraintSet):
        """The slab column map `cs` stages through: the whole set's, for a
        subset set (None for the whole set itself). The resident
        `<kind>!T` tables are keyed by their columns
        (FusedKernel._tables_device), so sets with columns of their own,
        used in turn, would upload those tables whole on every switch."""
        full = self._constraint_set(target)
        if full is None or full is cs:
            return None
        if full.policy is not None:
            return full.policy.cols
        if full.cols is None:
            full.cols = self.kernel.policy_columns(full.programs)
        return full.cols

    def _staged_policy(self, target: str, cs: _ConstraintSet):
        """`cs`'s device policy, staged once per set, and again when the
        whole set's column map moved under a subset set carried forward
        across churn."""
        cols = self._policy_cols(target, cs)
        if cs.policy is None or (
            cols is not None and cs.policy.cols is not cols
            and cs.policy.cols != cols
        ):
            cs.policy = self.kernel.stage_policy(cs.programs, cs.ms, cols=cols)
        return cs.policy

    # -- corpus encoding -----------------------------------------------------

    def _encode_reviews(
        self, target: str, reviews: List[Any], ns_cache: Dict[str, Any],
        vocab: Any = None, keep_fn: Optional[Callable[[int], bool]] = None,
    ):
        """-> (tok, fb, (g, g1), row_fallback, skipped). `vocab` overrides
        the intern target (review batches pass an OverlayVocab).

        `keep_fn` (spath vocab id -> bool) is the IR feature-liveness
        mask: provably dead token columns are dropped and the survivors
        compacted BEFORE the L/G bucketing below, so padding shrinks with
        the live set. Overflow is decided by the unfiltered encode (a
        truncated row already lost arbitrary live tokens and keeps
        routing to the interpreter); `skipped` counts the dropped slots."""
        if vocab is None:
            vocab = self.vocab
        handler = self._handler(target)
        table = encode_token_table(
            reviews, vocab, native=(self.encoder == "native")
        )
        skipped = 0
        if keep_fn is not None:
            table, skipped = mask_token_table(table, keep_fn)
            if skipped:
                self.columns_skipped_static += skipped
                self.liveness_batches += 1
                self._count(
                    "columns_skipped_static_total", skipped, target=target
                )
        feats = [
            handler.encode_review_features(r, ns_cache, vocab) for r in reviews
        ]
        fb = batch_review_features(feats)
        tok = {
            "spath": table.spath,
            "idx0": table.idx0,
            "idx1": table.idx1,
            "kind": table.kind,
            "vid": table.vid,
            "vnum": table.vnum,
        }
        max_i0 = int(np.asarray(table.idx0).max(initial=-1))
        max_i1 = int(np.asarray(table.idx1).max(initial=-1))
        g = _bucket(max(max_i0 + 1, 1), lo=8)
        g1 = _bucket(max(max_i1 + 1, 1), lo=4)
        row_fallback = np.asarray(table.overflow).copy()
        if fb.label_overflow is not None:
            row_fallback |= fb.label_overflow
        if g > G_CAP:
            g = G_CAP
            row_fallback |= (table.idx0 >= G_CAP).any(axis=1)
        if g1 > G_CAP:
            g1 = G_CAP
            row_fallback |= (table.idx1 >= G_CAP).any(axis=1)
        return tok, features_to_np(fb), (g, g1), row_fallback, skipped

    def _audit_corpus(self, target: str) -> Optional[_Corpus]:
        corpus = self._corpus.get(target)
        if corpus is not None and corpus.data_gen == self._data_gen:
            return corpus
        external = self.storage.get(["external", target], {})
        reviews = list(self._handler(target).iter_cached_reviews(external))
        if not reviews:
            self._corpus.pop(target, None)
            return None
        tok, fb, (g, g1), row_fallback, _ = self._encode_reviews(
            target, reviews, self._ns_cache(target)
        )
        corpus = _Corpus(
            data_gen=self._data_gen, reviews=reviews, tok=tok, fb=fb, g=g,
            g1=g1, row_fallback=row_fallback,
        )
        self.patterns.sync()
        self.tables.sync()
        self._corpus[target] = corpus
        return corpus

    def _ephemeral_corpus(
        self, target: str, cs: _ConstraintSet, reviews: List[Any],
        ns_cache: Dict[str, Any],
    ) -> _Corpus:
        """Encode a review batch against an OverlayVocab and build its
        pattern/table overlay blocks: the base vocab, patterns and tables
        never change, so admission restages no table. The base must be at
        its fixed point before the overlay snapshot, so a policy with
        inventory row features encodes the audit corpus (their counts
        source, cached per data generation) first."""
        if any(p is not None and p.row_features for p in cs.programs):
            self._audit_corpus(target)
        self.patterns.sync()
        self.tables.sync()
        overlay = OverlayVocab(self.vocab)
        tok, fb, (g, g1), row_fallback, skipped = self._encode_reviews(
            target, reviews, ns_cache, vocab=overlay,
            keep_fn=self._liveness_keep_fn(cs, overlay),
        )
        v_base = overlay.base_len
        # fill table and pattern rows for overlay entries to a fixed point
        # (transforms and captured segments intern new overlay strings)
        tab_parts: List[Dict[str, np.ndarray]] = []
        mem_parts: List[np.ndarray] = []
        cap_parts: List[np.ndarray] = []
        cur = v_base
        while cur < len(overlay):
            end = len(overlay)
            tab_parts.append(self.tables.fill_overlay(overlay, cur, end))
            m, c = self.patterns.classify_overlay(overlay, cur, end)
            mem_parts.append(m)
            cap_parts.append(c)
            cur = end
        b = len(overlay) - v_base
        b_pad = _bucket(max(b, 1), lo=128)
        p = self.patterns.n_patterns
        ov_member = np.zeros((b_pad, p), bool)
        ov_capture = np.full((b_pad, p), -1, np.int32)
        if b:
            ov_member[:b] = np.concatenate(mem_parts, axis=0)
            ov_capture[:b] = np.concatenate(cap_parts, axis=0)
        ov_tabs: Dict[str, np.ndarray] = {}
        if tab_parts and tab_parts[0]:
            for name in tab_parts[0]:
                col = np.concatenate([t[name] for t in tab_parts])
                padded = np.zeros((b_pad,), col.dtype)
                padded[:b] = col
                ov_tabs[name] = padded
        return _Corpus(
            data_gen=-1, reviews=reviews, tok=tok, fb=fb, g=g, g1=g1,
            row_fallback=row_fallback, vocab=overlay, v_base=v_base,
            ov_member=ov_member, ov_capture=ov_capture, ov_tabs=ov_tabs,
            skipped_static=skipped,
        )

    # -- IR static-analysis plane (analysis/ir.py) ---------------------------

    def _cs_live_pids(self, cs: _ConstraintSet) -> Optional[frozenset]:
        """Live pattern indices over the set's compiled programs, computed
        once per set. None means keep-all: some program failed the
        pad-equivalence proof, or the analysis itself failed (refuse,
        never guess)."""
        if cs.live_pids is False:
            from ..analysis.ir import corpus_liveness

            try:
                cs.live_pids = corpus_liveness(cs.programs)
            except Exception:
                cs.live_pids = None
        return cs.live_pids

    def _liveness_keep_fn(
        self, cs: _ConstraintSet, vocab: Any
    ) -> Optional[Callable[[int], bool]]:
        """Token keep-predicate for a batch only this set's programs will
        read: spath vocab id -> does the path match ANY live pattern. None
        disables filtering (liveness off, or the set is not provably
        maskable). A subset set gets its own, tighter mask: each subset
        dispatch encodes its own batch."""
        if not self.liveness_enabled:
            return None
        live = self._cs_live_pids(cs)
        if live is None:
            return None
        pat_segs = [self.patterns.segs(p) for p in sorted(live)]
        memo: Dict[int, bool] = {}

        def keep(pid: int) -> bool:
            hit = memo.get(pid)
            if hit is None:
                s = vocab.string(pid)
                if isinstance(s, str) and s.startswith("p:"):
                    segs = s[2:].split(".")
                    hit = any(_match(ps, segs)[0] for ps in pat_segs)
                else:
                    hit = True  # not a path entry: refuse to drop
                memo[pid] = hit
            return hit

        return keep

    def liveness_stats(self) -> Dict[str, Any]:
        """Liveness-plane counters."""
        return {
            "enabled": self.liveness_enabled,
            "columns_skipped_static": self.columns_skipped_static,
            "liveness_batches": self.liveness_batches,
        }

    def ir_report(self, target: str):
        """IR static-analysis report (analysis/ir.py IrReport) over the
        target's current compiled constraint set: GK-P0xx diagnostics,
        fused-path taxonomy, liveness summary and specialization
        certificates; computed once per constraint generation."""
        ent = self._ir_reports.get(target)
        if ent is not None and ent[0] == self._target_generation(target):
            return ent[1]
        from ..analysis.ir import ir_from_programs

        with self._mutex:
            cs = self._constraint_set(target)
            if cs is None:
                return None
            gen = self._target_generation(target)
            items = [
                (
                    f"constraint:{c.get('kind')}/"
                    f"{(c.get('metadata') or {}).get('name', '')}",
                    c.get("kind"),
                    prog,
                    H.constraint_parameters(c),
                )
                for c, prog in zip(cs.constraints, cs.programs)
            ]
            rep = ir_from_programs(items, fallback_codes=cs.fallback_codes)
            rep.liveness["patterns_total"] = self.patterns.n_patterns
            self._ir_reports[target] = (gen, rep)
        return rep

    def attach_ir_report(self, target: str, report: Any) -> None:
        """Re-attach an already computed IR report after a module swap
        (the attach_report contract)."""
        if report is None:
            return
        with self._mutex:
            self._ir_reports[target] = (
                self._target_generation(target), report
            )

    # -- device dispatch -----------------------------------------------------

    def _stage_corpus(self, corpus: _Corpus, policy):
        """Slice/pad the encoded corpus into uniform chunks and ship them
        to the device once (StackedCorpus)."""
        if corpus.staged is not None:
            return corpus.staged
        n = len(corpus.reviews)
        chunk = min(N_CHUNK, _bucket(n, lo=64))
        if self.metrics is not None:
            # what the bucketed chunk shape costs in padded rows
            padded = chunk * -(-n // chunk)
            path = "audit" if corpus.data_gen >= 0 else "webhook"
            self.metrics.observe(
                "batch_occupancy_percent", 100.0 * n / padded, path=path
            )
            self.metrics.record(
                "padding_waste_rows_total", padded - n, path=path
            )
        chunks = []
        for start in range(0, n, chunk):
            end = min(start + chunk, n)
            pad = chunk - (end - start)
            fb_c = {k: _pad_rows(v[start:end], pad) for k, v in corpus.fb.items()}
            tok_c = {
                k: _pad_rows(v[start:end], pad, fill=0 if k == "vnum" else -1)
                for k, v in corpus.tok.items()
            }
            chunks.append(
                (fb_c, tok_c, corpus.row_fallback[start:end], end - start)
            )
        ov = None
        if corpus.ov_member is not None:
            ov = {
                "member": corpus.ov_member,
                "capture": corpus.ov_capture,
                "tabs": corpus.ov_tabs,
            }
        corpus.staged = self.kernel.stage_corpus_stacked(
            chunks, policy, ov=ov, v_base=corpus.v_base
        )
        return corpus.staged

    def _need_pairs(
        self, target: str, cs: _ConstraintSet, corpus: _Corpus,
        phases: Dict[str, float],
    ) -> Tuple[List[Tuple[int, int]], int, int]:
        """Sparse evaluation: -> (review-major (n, c) pairs needing host
        work, compiled_pairs, interp_pairs); adds stage/row_features/
        dispatch/decode seconds to `phases`."""
        t0 = time.perf_counter()
        policy = self._staged_policy(target, cs)
        stacked = self._stage_corpus(corpus, policy)
        t_feats = time.perf_counter()
        needed = sorted(
            {f for p in cs.programs if p is not None for f in p.row_features}
        )
        if needed:
            feats = self._row_feature_bits(target, corpus, needed)
            self.kernel.stage_row_feats(
                stacked, feats,
                volatile=[n for n in needed if n.startswith("extdata:")],
            )
        t1 = time.perf_counter()
        # named fault point: "error" fails the fused dispatch of a sweep
        # or a batch (a batch's requests then get the fail policy), "hang"
        # stalls it
        fire("driver.device_dispatch")
        packed, hot, n_hot, sc, si = self.kernel.dispatch_need_all(
            policy, stacked, (corpus.g, corpus.g1), r_cap=R_CAP
        )
        t2 = time.perf_counter()
        pairs: List[Tuple[int, int]] = []
        for ci in range(stacked.k):
            start = ci * stacked.chunk
            if int(n_hot[ci]) > hot.shape[1]:
                # more hot rows than the compaction window: rerun alone
                p_c, h_c, _nh, _sc, _si = self._redispatch_chunk(
                    policy, corpus, stacked, ci, int(n_hot[ci])
                )
                n_loc, c_is = decode_need(p_c, h_c, policy.c_pad)
            else:
                n_loc, c_is = decode_need(packed[ci], hot[ci], policy.c_pad)
            pairs.extend(zip((start + n_loc).tolist(), c_is.tolist()))
        t3 = time.perf_counter()
        phases["stage"] = t_feats - t0
        phases["row_features"] = t1 - t_feats
        phases["dispatch"] = t2 - t1
        phases["decode"] = t3 - t2
        return pairs, int(sc.sum()), int(si.sum())

    def _redispatch_chunk(self, policy, corpus: _Corpus, stacked, ci: int,
                          n_hot: int):
        """Overflow path: rerun one chunk with a window that fits its hot
        rows (the window doubles until the rerun's own n_hot fits). The
        chunk's row feature planes ride along, so the rerun flags the
        rows the sweep counted."""
        self._hot_redispatches += 1
        self._count("driver_hot_redispatch_total")
        r_cap = 1 << (n_hot - 1).bit_length()
        batch = stacked.chunk_view(ci)
        while True:
            out = self.kernel.dispatch_need(
                policy, batch, (corpus.g, corpus.g1), r_cap=r_cap,
                ov_in=stacked.ov_dev, v_base=stacked.v_base,
            )
            if out[2] <= min(r_cap, stacked.chunk):
                return out
            r_cap = min(2 * r_cap, stacked.chunk)

    # -- inventory row features (invdup join bits) ---------------------------

    def _row_feature_bits(
        self, target: str, corpus: _Corpus, names: List[str]
    ) -> Dict[str, np.ndarray]:
        """Per-row screen refinement bits for inventory join templates
        (host numpy; gatekeeper_tpu/constraint/tpudriver.py:1403).

        "invdup:<leaf>:<mirror>:<se>:<guards>" (encoded by the symbolic
        compiler's clause compile) is a sound over-approximation of the
        join's truth:
          * a row's candidate values are its tokens at the LEAF pattern;
            partners are counted at the MIRROR pattern (the partner-side
            path; the leaf's own for self-joins);
          * persistent audit corpus (its reviews ARE the inventory): a
            value carried by >= 2 distinct rows at the mirror pattern can
            conflict. The threshold 2 holds only when <se> is 1 (a proven
            `not identical(obj, input.review)` guard excludes the row's
            self-partner), no inventory row is a fallback row (whose keys
            the counts cannot see), and the row carries every <guards>
            identity field (rows missing one stay routed); otherwise 1;
          * ephemeral review batch: the row holds a leaf value present
            anywhere in the synced inventory (the audit corpus) at the
            mirror pattern; if some inventory row is a fallback row, every
            row routes. The interpreter re-checks exclusions.
        Bits are cached on the corpus; fallback rows always stay routed.
        """
        if corpus.row_feats is None:
            corpus.row_feats = {}
        # alias guard: base vocab ids assigned after an ephemeral corpus's
        # overlay snapshot collide with its overlay ids, so no id
        # comparison below is sound; route every row
        if corpus.vocab is not None and len(self.vocab) > corpus.v_base:
            ones = np.ones(len(corpus.reviews), bool)
            return {name: ones for name in names}
        out: Dict[str, np.ndarray] = {}
        for name in names:
            if name.startswith("extdata:"):
                # never cached in row_feats: the bits track the LIVE
                # response cache (TTL expiry between sweeps must route
                # rows back to the interpreter re-check)
                out[name] = self._extdata_row_bits(target, corpus, name)
                continue
            cached = corpus.row_feats.get(name)
            if cached is not None:
                out[name] = cached
                continue
            parts = name.split(":")
            leaf_pid, mirror_pid = int(parts[1]), int(parts[2])
            self_excl = parts[3] == "1"
            gpids = [int(x) for x in parts[4].split("+") if x]
            if corpus.data_gen >= 0:
                counts, inv_fb = self._pattern_value_counts(corpus, mirror_pid)
                thresh = 2 if (self_excl and not inv_fb) else 1
            else:
                inv = self._audit_corpus(target)
                if inv is None:
                    counts, inv_fb = None, False
                else:
                    counts, inv_fb = self._pattern_value_counts(inv, mirror_pid)
                thresh = 1
            sel, vids = self._pattern_tokens(corpus, leaf_pid)
            if counts is None:
                feat = np.zeros(len(corpus.reviews), bool)
            elif inv_fb and corpus.data_gen < 0:
                feat = np.ones(len(corpus.reviews), bool)
            else:
                dup = counts >= thresh
                safe = np.minimum(np.maximum(vids, 0), dup.shape[0] - 1)
                hit = sel & (vids >= 0) & (vids < dup.shape[0]) & dup[safe]
                feat = hit.any(axis=1)
                if corpus.data_gen >= 0 and thresh >= 2 and gpids:
                    has_all = np.ones(len(corpus.reviews), bool)
                    for gp in gpids:
                        gsel, gvids = self._pattern_tokens(corpus, gp)
                        has_all &= (gsel & (gvids >= 0)).any(axis=1)
                    feat |= ~has_all
            feat |= np.asarray(corpus.row_fallback, bool)
            corpus.row_feats[name] = feat
            out[name] = feat
        return out

    # -- external data (docs/externaldata.md) --------------------------------

    def _extdata_row_bits(
        self, target: str, corpus: _Corpus, name: str
    ) -> np.ndarray:
        """Per-row screen bits for an "extdata:<kind>:<mode>" feature.

        Key extraction (analyzer-recorded input-derived keys
        expressions, evaluated per review) is cached on the corpus; the
        batch's deduped union feeds ONE system.prefetch per dispatch —
        that call IS the one-outbound-fetch-per-(provider, batch)
        contract for the fused path. Bits:
          * mode "err" (provably error-gated templates): True iff some
            key of the row is NOT a clean cache hit — clean rows can
            never produce an error entry, so they stay fused;
          * mode "all": all-ones (the feature exists to drive
            prefetch; violations may depend on response values, so
            every matching row re-checks).
        """
        n = len(corpus.reviews)
        ones = np.ones(n, bool)
        system = self.external_data
        parts = name.split(":")
        kind = parts[1] if len(parts) > 1 else ""
        mode = parts[2] if len(parts) > 2 else "all"
        if system is None or not kind:
            return ones
        report = self.template_report(target, kind)
        calls = getattr(report, "external_calls", None) if report else None
        if not calls:
            return ones
        per_row, union = self._extdata_keys(corpus, name, calls)
        if union:
            system.prefetch(union)
        if mode != "err":
            return ones
        bits = np.zeros(n, bool)
        for i, wants in enumerate(per_row):
            if wants is None:
                bits[i] = True  # unextractable row: route it (sound)
                continue
            for p, ks in wants.items():
                if any(not system.probe_clean(p, k) for k in ks):
                    bits[i] = True
                    break
        bits |= np.asarray(corpus.row_fallback, bool)
        return bits

    def _extdata_keys(self, corpus: _Corpus, name: str, calls):
        """The keys of an "extdata:" feature's calls, extracted once per
        corpus and cached on it: per row {provider -> keys}, None for a
        row some call cannot extract, and the union over every row and
        call (batch_wants' answer). The sweep's prefetch and the row
        screen share the one interpreter pass over the corpus."""
        if corpus.ext_keys is None:
            corpus.ext_keys = {}
        cached = corpus.ext_keys.get(name)
        if cached is not None:
            return cached
        from ..externaldata.extract import extract_keys

        per_row: List[Optional[Dict[str, set]]] = []
        union: Dict[str, set] = {}
        for review in corpus.reviews:
            wants: Optional[Dict[str, set]] = {}
            for call in calls:
                keys = (
                    extract_keys(self.interp, call, review)
                    if call.extractable and call.provider else None
                )
                if keys is None:
                    wants = None
                    continue
                if keys:
                    union.setdefault(call.provider, set()).update(keys)
                if wants is not None:
                    wants.setdefault(call.provider, set()).update(keys)
            per_row.append(wants)
        corpus.ext_keys[name] = (per_row, union)
        return per_row, union

    def _prefetch_external(
        self, target: str, reviews: Sequence[Any], corpus=None,
    ):
        """Batch-plane prefetch for every external-data template in the
        constraint set: extract + dedupe the batch's keys, then at most
        one outbound fetch per provider. Best-effort — resolution
        answers failures per the provider's failurePolicy. With the
        sweep's `corpus`, a template the analyzer gives a screen mode
        extracts through _extdata_keys, whose cache the row screen then
        reads, instead of a second pass."""
        system = self.external_data
        if system is None:
            return
        try:
            from ..externaldata.extract import batch_wants

            wants_total: Dict[str, set] = {}
            with self._mutex:
                for (t, kind) in list(self._kind_modules):
                    if t != target:
                        continue
                    rep = self.template_report(t, kind)
                    calls = getattr(rep, "external_calls", None)
                    if not calls:
                        continue
                    mode = rep.extdata_mode()
                    if corpus is not None and mode is not None:
                        _, w = self._extdata_keys(
                            corpus, f"extdata:{kind}:{mode}", calls)
                    else:
                        w = batch_wants(self.interp, calls, reviews)
                    if w:
                        for p, ks in w.items():
                            wants_total.setdefault(p, set()).update(ks)
            if wants_total:
                # OUTSIDE the serving mutex: a slow provider must stall
                # only this batch, never the whole admission plane
                system.prefetch(wants_total)
        except Exception:
            pass

    def _pattern_tokens(self, corpus: _Corpus, pid: int):
        """-> ([N, L] bool: token path matches pattern `pid`, [N, L] vids);
        overlay path ids of an ephemeral batch read the batch's blocks."""
        member = np.asarray(self.patterns.member)
        spath = corpus.tok["spath"]
        vids = corpus.tok["vid"]
        width = member.shape[1]
        safe = np.minimum(np.maximum(spath, 0), max(width - 1, 0))
        sel = (spath >= 0) & (spath < width) & member[pid][safe]
        if corpus.ov_member is not None:
            loc = spath - corpus.v_base
            b = corpus.ov_member.shape[0]
            safe_loc = np.clip(loc, 0, max(b - 1, 0))
            ov = (loc >= 0) & (loc < b) & corpus.ov_member[safe_loc, pid]
            sel = np.where(loc >= 0, ov, sel)
        return sel, vids

    def _pattern_value_counts(self, corpus: _Corpus, pid: int):
        """-> ([V] distinct-row counts per value id at tokens matching
        pattern `pid`, any fallback row), cached on the corpus (review
        batches reuse the audit corpus's counts)."""
        if corpus.value_counts is None:
            corpus.value_counts = {}
        cached = corpus.value_counts.get(pid)
        if cached is not None:
            return cached
        sel, vids = self._pattern_tokens(corpus, pid)
        rows, cols = np.nonzero(sel & (vids >= 0))
        tv = vids[rows, cols]
        if tv.size == 0:
            counts = np.zeros((len(self.vocab),), np.int64)
        else:
            pairs = np.unique(rows.astype(np.int64) * (tv.max() + 1) + tv)
            counts = np.bincount(pairs % (tv.max() + 1), minlength=len(self.vocab))
        result = (counts, bool(np.asarray(corpus.row_fallback).any()))
        corpus.value_counts[pid] = result
        return result

    # -- hook overrides ------------------------------------------------------

    def _violation(
        self, target: str, input: Dict[str, Any], trace: Optional[List[str]]
    ) -> List[Result]:
        return self._query_batch(target, [input], trace)[0]

    def query_many(
        self, path: str, inputs: Sequence[Any], tracing: bool = False
    ) -> List[Response]:
        """Batched violation hook: the whole batch is one fused dispatch
        (the admission micro-batch path). Other hooks and traced queries
        take the serial default."""
        m = _HOOK_RE.match(path)
        if m is None or m.group(2) != "violation" or tracing:
            return super().query_many(path, inputs, tracing)
        target = m.group(1)
        inputs = list(inputs)
        if self.external_data is not None:
            # batch plane: open a fresh fetch epoch and prefetch the
            # batch's deduped keys (one outbound fetch per provider)
            # BEFORE the dispatch — the fused screen and the interpreter
            # renders then serve from the response cache
            self.external_data.begin_batch()
            self._prefetch_external(
                target,
                [H.hook_get_default(i or {}, "review", {}) for i in inputs],
            )
        with self._serving():
            # the monolithic dispatch's canaries: golden keyed per
            # generation of the target, attributed to logical device 0
            sigkey = f"gen{self._target_generation(target)}"
            canaries = self._canary_pack(
                target, sigkey, self._constraints(target), len(inputs)
            )
            split = self._query_batch(
                target, inputs + [{"review": r} for r in canaries], None
            )
        self._canary_check(target, sigkey, 0, split[len(inputs):])
        return [Response(target=target, results=r) for r in split[:len(inputs)]]

    @contextmanager
    def _serving(self):
        """The serving mutex for a fused dispatch, counted while it waits
        so that query_host, the host oracle, yields to it."""
        with self._waiting_lock:
            self._fused_waiting += 1
        try:
            self._mutex.acquire()
        finally:
            with self._waiting_lock:
                self._fused_waiting -= 1
        try:
            yield
        finally:
            self._mutex.release()

    def query_host(
        self, path: str, input: Any = None, subset=None
    ) -> Response:
        """Evaluate on the host INTERPRETER, never touching the device
        (tpudriver.py:1796-1828): the oracle a fused answer is checked
        against (`Client.review_host`, the integrity plane's shadow
        oracle). `subset` scopes a violation query to some constraints.
        The base driver's query_host answers a query without `subset`
        through `query`, which here is the fused path."""
        m = _HOOK_RE.match(path)
        if m is None:
            raise ValueError(f"unsupported query path: {path!r}")
        target, hook = m.group(1), m.group(2)
        # an oracle evaluation takes the serving mutex for 0.1-0.3 s over
        # hundreds of constraints: let queued fused dispatches go first
        # (for at most ORACLE_YIELD_S), or back-to-back oracle calls hold
        # admission batches past their timeout
        deadline = time.monotonic() + ORACLE_YIELD_S
        while self._fused_waiting and time.monotonic() < deadline:
            time.sleep(0.001)
        with self._mutex:
            if hook == "violation":
                constraints = self._constraints(target)
                if subset is not None:
                    sub = frozenset(subset)
                    constraints = [
                        c for c in constraints if constraint_key(c) in sub
                    ]
                results = RegoDriver._violation(
                    self, target, input or {}, None, constraints=constraints,
                    inventory=self._inventory_for(target, constraints),
                )
            else:
                results = RegoDriver._audit(self, target, None)
        return Response(target=target, results=results)

    def query_many_subset(
        self, path: str, inputs: Sequence[Any], subset, device: int = 0,
        partition=None,
    ) -> List[Response]:
        """Partition-scoped batched violation hook: only `subset`'s
        constraints (keys per `constraint_key`) for every input, as one
        fused dispatch attributed to logical `device`, like query_many.
        The fault point `driver.device_dispatch[device=N]` gates the whole
        partition dispatch. Canary reviews ride in the batch's padding
        slots and are stripped before the results return; the dispatch's
        seconds are attributed under `partition` (default: `device`).
        Merged across a plan's subsets in `constraint_keys` order
        (`parallel.partition.merge_partition_results`), the results equal
        query_many's."""
        m = _HOOK_RE.match(path)
        if m is None or m.group(2) != "violation":
            raise ValueError(f"unsupported partition query path: {path!r}")
        target = m.group(1)
        fire(device_point("driver.device_dispatch", device))
        inputs = list(inputs)
        with self._serving():
            cs = self._subset_cset(target, frozenset(subset))
            if cs is None:
                return [Response(target=target, results=[]) for _ in inputs]
            sigkey = cs.signature or f"gen{self._target_generation(target)}"
            canaries = self._canary_pack(
                target, sigkey, cs.constraints, len(inputs)
            )
            split = self._query_batch(
                target, inputs + [{"review": r} for r in canaries], None,
                cset=cs,
                partition=(partition if partition is not None else device),
            )
        self._canary_check(
            target, sigkey, device, split[len(inputs):],
            subset=frozenset(subset),
        )
        return [Response(target=target, results=r) for r in split[:len(inputs)]]

    def prepare_subset(self, path: str, subset, device: int = 0) -> bool:
        """Stage one partition's sub-program onto its logical device: the
        restage step of a re-home, behind the fault point
        `driver.restage[device=N]`. A signature-unchanged subset carries
        its staged set across the generation bump. A changed one is built
        and staged as a SHADOW set while the old set stays live; with an
        integrity plane it must then replay the golden canaries
        (`_golden_gate`); the fault point `compile.swap` sits between
        stage and swap, and a failure there leaves the old set serving.
        Returns False (not an error) when the gate rejects the shadow or
        the constraints churned again mid-stage. The shadow's policy is
        staged under the serving mutex, unlike the reference's: it
        compiles nothing here, and staging reads the pattern and string
        registries, which a concurrent compile under the mutex grows."""
        m = _HOOK_RE.match(path)
        if m is None or m.group(2) != "violation":
            raise ValueError(f"unsupported partition query path: {path!r}")
        target = m.group(1)
        fs = frozenset(subset)
        fire(device_point("driver.restage", device))
        with self._mutex:
            gen = self._target_generation(target)
            cs = self._cset_sub.get((target, fs))
            if (
                cs is not None and cs.constraint_gen != gen
                and not self._carry_forward(target, fs, cs)
            ):
                cs = None
            if cs is not None:
                self._staged_policy(target, cs)
                return True
            shadow = self._build_subset_cset(target, fs)
            if shadow is None:
                self._cset_sub.pop((target, fs), None)
                return True
            self._staged_policy(target, shadow)
        if self.integrity is not None and not self._golden_gate(target, shadow):
            self._count(
                "program_swap_rejected_total", reason="golden_mismatch",
                target=target,
            )
            return False
        fire("compile.swap")
        with self._mutex:
            if self._target_generation(target) != gen:
                return False
            self._cset_sub.pop((target, fs), None)
            while len(self._cset_sub) >= self._cset_sub_max:
                self._cset_sub.popitem(last=False)
            self._cset_sub[(target, fs)] = shadow
            self._swap_gen += 1
            self.subset_swaps += 1
            self._count("program_swap_total", target=target)
        if self.program_store is not None:
            self.program_store.attest()
        return True

    def _golden_gate(self, target: str, shadow: _ConstraintSet) -> bool:
        """Swap gate: replay the golden canary batch through the STAGED
        (not yet live) set and compare digests with the interpreter-pinned
        golden set. The fault point `integrity.selftest` injects a
        corrupting shadow. The port compiles no kernel, so the replay
        always runs on the device."""
        from ..integrity.canary import result_digest

        sigkey = shadow.signature or f"gen{self._target_generation(target)}"
        try:
            entry = self.integrity.golden_for(
                target, sigkey, shadow.constraints,
                self._interp_closure(target, shadow.constraints),
            )
        except Exception:
            entry = None
        if entry is None or not entry.get("reviews"):
            return True
        try:
            fire("integrity.selftest")
        except FaultError:
            return False
        try:
            with self._mutex:
                split = self._query_batch(
                    target, [{"review": r} for r in entry["reviews"]], None,
                    cset=shadow,
                )
        except Exception:
            return False
        got = [result_digest(rs) for rs in split]
        return got == entry["digests"][: len(got)]

    def _query_batch(
        self, target: str, inputs: List[Any], trace: Optional[List[str]],
        cset: Optional[_ConstraintSet] = None, partition=None,
    ) -> List[List[Result]]:
        """Autoreject results, then the fused evaluation, per review, over
        `cset` (default: every constraint of the target); `partition`
        labels the dispatch's attributed seconds."""
        handler = self._handler(target)
        constraints = (
            cset.constraints if cset is not None else self._constraints(target)
        )
        if not constraints:
            return [[] for _ in inputs]
        ns_cache = self._ns_cache(target)
        reviews = [H.hook_get_default(i or {}, "review", {}) for i in inputs]
        rej_constraints = [
            c for c in constraints if handler.constraint_needs_context(c)
        ]
        out: List[List[Result]] = []
        for review in reviews:
            auto: List[Result] = []
            if rej_constraints and handler.review_autorejects(review, ns_cache):
                auto = [_autoreject_result(c, review) for c in rej_constraints]
                if trace is not None:
                    trace.extend(f"autoreject: {_cname(c)}" for c in rej_constraints)
            out.append(auto)
        split = self._eval_reviews_split(
            target, reviews, trace, corpus=None, cset=cset,
            partition=partition,
        )
        return [a + r for a, r in zip(out, split)]

    def _audit(self, target: str, trace: Optional[List[str]]) -> List[Result]:
        t0 = time.perf_counter()
        with self._mutex:
            corpus = self._audit_corpus(target)
        if corpus is None:
            self.stats = {}
            return []
        encode_s = time.perf_counter() - t0
        if self.external_data is not None:
            # each sweep is one batch epoch: the corpus's deduped keys
            # fetch once; flagged rows then render from the cache
            self.external_data.begin_batch()
            self._prefetch_external(target, corpus.reviews, corpus=corpus)
        split = self._eval_reviews_split(
            target, corpus.reviews, trace, corpus, encode_s=encode_s,
        )
        return [r for sub in split for r in sub]

    def _eval_reviews_split(
        self,
        target: str,
        reviews: List[Any],
        trace: Optional[List[str]],
        corpus: Optional[_Corpus],
        encode_s: float = 0.0,
        cset: Optional[_ConstraintSet] = None,
        partition=None,
    ) -> List[List[Result]]:
        """Fused evaluation on the device, then rendering of the sparse
        pairs that need host work; results grouped per review in the
        interpreter driver's (review-major) order. `encode_s`: seconds
        the caller spent encoding `corpus` (the cached audit corpus);
        `cset`: the constraint set (default: the target's whole set);
        `partition`: the label of the attributed dispatch seconds."""
        t_start = time.perf_counter()
        with self._mutex:
            cs = cset if cset is not None else self._constraint_set(target)
            if cs is None:
                self.stats = {}
                return [[] for _ in reviews]
            ns_cache = self._ns_cache(target)
            t_policy = time.perf_counter()
            if corpus is None:
                corpus = self._ephemeral_corpus(target, cs, reviews, ns_cache)
            self.patterns.sync()
            self.tables.sync()
            phases: Dict[str, float] = {
                "policy": t_policy - t_start,
                "encode": encode_s + time.perf_counter() - t_policy,
            }
            up0 = dict(self.kernel.uploads)
            pairs, stat_c, stat_i = self._need_pairs(target, cs, corpus, phases)
            upload = {k: v - up0[k] for k, v in self.kernel.uploads.items()}
            upload["full_tables"] = (
                list(self.kernel.last_full_tables)
                if upload["full_uploads"] else []
            )
            t_render = time.perf_counter()
            prune_s0 = self._prune_build_s
            render_cache = None
            if corpus.data_gen >= 0 and trace is None:
                gens = (self._data_gen, self._target_generation(target))
                cached = self._render_cache.get(target)
                if cached is None or cached[0] != gens:
                    cached = (gens, OrderedDict())
                    self._render_cache[target] = cached
                render_cache = cached[1]
            # look every pair up BEFORE rendering: inserting this sweep's
            # renders evicts the oldest entries, which a sweep larger than
            # the cache would otherwise miss again further down its list
            hits: Dict[Tuple[int, int], List[Result]] = {}
            if render_cache is not None:
                hits = {p: render_cache[p] for p in pairs if p in render_cache}
            host_rendered: Dict[Tuple[int, int], List[Result]] = {}
            if trace is None:
                host_rendered = self._host_render_pairs(
                    cs, corpus, [p for p in pairs if p not in hits], reviews
                )
            inventory = None
            per_review: List[List[Result]] = [[] for _ in reviews]
            n_results = n_host = n_interp = n_pruned = n_cache_hits = 0
            frozen: Dict[int, Any] = {}
            for n_i, c_i in pairs:
                out = hits.get((n_i, c_i))
                if out is not None:
                    n_cache_hits += 1
                else:
                    out = host_rendered.get((n_i, c_i))
                    if out is not None:
                        n_host += 1
                    else:
                        fr = frozen.get(n_i)
                        if fr is None:
                            fr = frozen[n_i] = freeze(reviews[n_i])
                        prog = cs.programs[c_i]
                        if prog is not None and prog.prune is not None:
                            # the join's candidates only, not the whole
                            # inventory
                            out = self._render_pruned(
                                target, cs.constraints[c_i], reviews[n_i],
                                prog.prune, trace, fr,
                            )
                            n_pruned += 1
                        else:
                            if inventory is None:
                                # frozen only when the interpreter renders,
                                # and only for a set that may read it
                                inventory = self._inventory_for(
                                    target, cs.constraints)
                            out = self._eval_template(
                                target, cs.constraints[c_i], reviews[n_i],
                                inventory, trace, frozen_review=fr,
                            )
                        n_interp += 1
                    if render_cache is not None:
                        if len(render_cache) >= self.render_cache_max:
                            render_cache.popitem(last=False)
                            self._render_cache_evictions += 1
                            self._count("driver_render_cache_evictions_total")
                        render_cache[(n_i, c_i)] = out
                per_review[n_i].extend(out)
                n_results += len(out)
            phases["render"] = time.perf_counter() - t_render
            self._attribute_dispatch(cs, phases["dispatch"], partition)
            self.stats = {
                "compiled_pairs": stat_c,
                "interp_pairs": stat_i,
                "n_reviews": len(reviews),
                "n_constraints": len(cs.constraints),
                "n_results": n_results,
                "host_rendered_pairs": n_host,
                "interp_rendered_pairs": n_interp,
                # of those, rendered against the prune index's candidates
                "pruned_renders": n_pruned,
                # render seconds spent building prune indexes (once per
                # data generation)
                "prune_index_seconds": self._prune_build_s - prune_s0,
                "render_cache_hits": n_cache_hits,
                "render_errors": self._render_errors,
                "render_cache_evictions": self._render_cache_evictions,
                "hot_redispatches": self._hot_redispatches,
                # dead token slots the IR liveness mask dropped from this
                # batch's encode (0 for the keep-all audit corpus)
                "columns_skipped_static": corpus.skipped_static,
                "phase_seconds": phases,
                # device table uploads of this query: whole padded tables
                # vs new vocab rows (parallel/fused.py _tables_device)
                "upload": upload,
                # the diagnostic code of every interpreter-routed
                # template in this query's constraint set
                "fallback_codes": dict(cs.fallback_codes or {}),
                "analyzer_mismatches": self.analyzer_mismatches,
            }
            if self.metrics is not None:
                path = "audit" if corpus.data_gen >= 0 else "webhook"
                m = self.metrics
                m.record("driver_pairs_total", stat_c, route="compiled",
                         path=path)
                m.record("driver_pairs_total", stat_i, route="interp",
                         path=path)
                m.record("driver_render_total", n_host, route="host")
                m.record("driver_render_total", n_interp - n_pruned,
                         route="interp")
                m.record("driver_render_total", n_pruned, route="pruned")
                for phase, dt in phases.items():
                    m.observe("driver_phase_seconds", dt, phase=phase,
                              path=path)
            if trace is not None:
                trace.append(
                    f"torch dispatch: {stat_c} compiled pairs, "
                    f"{stat_i} interpreter pairs"
                )
            return per_review

    # -- derived-key prune rendering (tpudriver.py:2476-2632) -----------------

    def _prune_oracle(self, target: str, kind: str, params: Any):
        key = (target, kind, _params_key(params))
        cached = self._prune_oracles.get(key)
        if cached is None:
            cached = self._prune_oracles[key] = self._make_oracle(
                target, kind, params
            )
        return cached

    @staticmethod
    def _collect_path_values(node: Any, segs: Tuple[str, ...]) -> List[Any]:
        """Every SCALAR value reachable from `node` along `segs`, whose
        wildcard segments ("#" array level, "*" object key, "?" either)
        iterate every child of a dict or a list alike. Used for both sides
        of a path-form prune plan; a superset is sound, since the
        interpreter re-checks every candidate."""
        frontier = [node]
        for seg in segs:
            nxt: List[Any] = []
            wild = seg in ("#", "*", "?")
            for n in frontier:
                if wild:
                    if isinstance(n, dict):
                        nxt.extend(n.values())
                    elif isinstance(n, list):
                        nxt.extend(n)
                elif isinstance(n, dict):
                    key = unesc_seg(seg)
                    if key in n:
                        nxt.append(n[key])
            frontier = nxt
            if not frontier:
                break
        return [
            v for v in frontier
            if isinstance(v, (str, int, float, bool)) or v is None
        ]

    @staticmethod
    def _plan_key(plan: Dict[str, Any]) -> Tuple:
        if "fn" in plan:
            return ("fn", plan["fn"], plan["tree"])
        return ("path", plan["path"], plan["review_pattern"], plan["tree"])

    def _prune_index(
        self, target: str, kind: str, params: Any, plan: Dict[str, Any]
    ):
        """{frozen key -> [(path segs, obj)]} over the inventory tree,
        built once per data generation. fn-form plans key each object by
        the join's pure Rego helper (uniqueserviceselector's
        flatten_selector); path-form plans by the values at the join's
        relative path (uniqueingresshost's spec.rules[_].host), one entry
        under each of an object's keys."""
        ikey = (target, kind, _params_key(params)) + self._plan_key(plan)
        cached = self._prune_indexes.get(ikey)
        if cached is not None and cached[0] == self._data_gen:
            return cached[1]
        t0 = time.perf_counter()
        fn = plan.get("fn")
        oracle = self._prune_oracle(target, kind, params) if fn else None
        depth = 4 if plan["tree"] == "namespace" else 3
        tree = self.storage.get(["external", target, plan["tree"]], {})
        index: Dict[Any, List[Tuple[Tuple[str, ...], Any]]] = {}

        def rec(node, segs):
            if len(segs) == depth:
                if oracle is not None:
                    k, defined = oracle(fn, node)
                    if defined:
                        index.setdefault(freeze(k), []).append((segs, node))
                    return
                seen = set()
                for k in self._collect_path_values(node, plan["path"]):
                    fk = freeze(k)
                    if fk not in seen:
                        seen.add(fk)
                        index.setdefault(fk, []).append((segs, node))
                return
            if isinstance(node, dict):
                for key2, child in node.items():
                    rec(child, segs + (key2,))

        if isinstance(tree, dict):
            rec(tree, ())
        self._prune_indexes[ikey] = (self._data_gen, index)
        self._prune_build_s += time.perf_counter() - t0
        return index

    def _render_pruned(
        self,
        target: str,
        constraint: Dict[str, Any],
        review: Any,
        plan: Dict[str, Any],
        trace: Optional[List[str]],
        frozen_review: Any,
    ) -> List[Result]:
        """Interpreter render against the inventory cut to the prune
        index's candidates for this review's key(s). Sound because the
        compiler proved that the violating clause implies a shared key:
        F(candidate) == F(review subdocument) for fn-form plans, path
        values of the candidate and of the review intersect for path-form
        ones; and no other clause reads the inventory."""
        kind = constraint.get("kind")
        params = H.constraint_parameters(constraint)
        candidates: List[Tuple[Tuple[str, ...], Any]] = []
        if "fn" in plan:
            cur: Any = review
            for seg in plan["review_prefix"]:
                if not isinstance(cur, dict) or seg not in cur:
                    cur = None
                    break
                cur = cur[seg]
            if cur is not None:
                k, defined = self._prune_oracle(target, kind, params)(
                    plan["fn"], cur
                )
                if defined:
                    index = self._prune_index(target, kind, params, plan)
                    candidates = index.get(freeze(k), [])
        else:
            # the union over the review's key values, deduped by inventory
            # path so that a candidate sharing two keys appears once
            keys = {
                freeze(k)
                for k in self._collect_path_values(review, plan["review_pattern"])
            }
            if keys:
                index = self._prune_index(target, kind, params, plan)
                seen_segs = set()
                for fk in keys:
                    for segs, obj in index.get(fk, []):
                        if segs not in seen_segs:
                            seen_segs.add(segs)
                            candidates.append((segs, obj))
        pruned_tree: Dict[str, Any] = {}
        for segs, obj in candidates:
            node = pruned_tree
            for seg in segs[:-1]:
                node = node.setdefault(seg, {})
            node[segs[-1]] = obj
        return self._eval_template(
            target, constraint, review, freeze({plan["tree"]: pruned_tree}),
            trace, frozen_review=frozen_review,
        )

    # -- compiled message rendering ------------------------------------------

    def _host_render_pairs(
        self,
        cs: _ConstraintSet,
        corpus: _Corpus,
        pairs: List[Tuple[int, int]],
        reviews: List[Any],
    ) -> Dict[Tuple[int, int], List[Result]]:
        """Render violating pairs of exact programs from their compiled
        branch plans (engine/render.py), evaluated with torch on the CPU
        over the violating rows only. Rows/pairs the plans cannot prove
        exact are omitted (the caller renders them on the interpreter).
        Violation objects render once per (program, row) and fan out to
        every constraint sharing the program."""
        out: Dict[Tuple[int, int], List[Result]] = {}
        by_prog: Dict[int, Tuple[Program, List[Tuple[int, int]]]] = {}
        for n_i, c_i in pairs:
            p = cs.programs[c_i]
            if p is None or not p.branches or corpus.row_fallback[n_i]:
                continue
            by_prog.setdefault(id(p), (p, []))[1].append((n_i, c_i))
        if not by_prog:
            return out
        cpu = torch.device("cpu")

        def t(a):
            # host render keeps the host arrays' types (as the JAX
            # package's numpy render does), float64 tables included
            return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))

        member = t(self.patterns.member)
        capture = t(self.patterns.capture)
        tabs = {k: t(v) for k, v in self.tables.arrays().items()}
        ov = {}
        if corpus.ov_member is not None:
            ov = {
                "v_base": corpus.v_base,
                "member": t(corpus.ov_member),
                "capture": t(corpus.ov_capture),
                "tabs": {k: t(v) for k, v in corpus.ov_tabs.items()},
            }
        corpus_vocab = corpus.vocab if corpus.vocab is not None else self.vocab
        for prog, plist in by_prog.values():
            rows = sorted({n for n, _ in plist})
            pos = {n: i for i, n in enumerate(rows)}
            idx = np.asarray(rows, np.int64)
            ctx = EvalCtx(
                tok={k: t(v[idx]).to(cpu) for k, v in corpus.tok.items()},
                pat_member=member,
                pat_capture=capture,
                str_tables=tabs,
                consts={k: t(v) for k, v in prog.consts.items()},
                g0=corpus.g,
                g1=corpus.g1,
                v_base=ov.get("v_base"),
                ov_member=ov.get("member"),
                ov_capture=ov.get("capture"),
                ov_tabs=ov.get("tabs"),
            )
            try:
                rset = RenderSet(prog, ctx, corpus_vocab)
                row_objs = {n: rset.render_row(pos[n], reviews[n]) for n in rows}
            except Exception:
                # a plan evaluation failure degrades to the interpreter,
                # never fails the sweep; counted in stats
                self._render_errors += 1
                self._count("driver_render_errors_total")
                continue
            for n_i, c_i in plist:
                objs = row_objs.get(n_i)
                if objs is not None:
                    out[(n_i, c_i)] = _results_from_objs(
                        objs, cs.constraints[c_i], reviews[n_i]
                    )
        return out


def _results_from_objs(
    objs: List[Any], constraint: Dict[str, Any], review: Any
) -> List[Result]:
    """Frozen violation objects -> Result list, shaped exactly as the
    hook's (RegoDriver._eval_template): msg-less violations drop, details
    default {}."""
    enforcement = H.enforcement_action(constraint)
    out: List[Result] = []
    for v in objs:
        tv = thaw(v)
        if not isinstance(tv, dict) or "msg" not in tv:
            continue
        out.append(
            Result(
                msg=tv["msg"],
                metadata={"details": H.hook_get_default(tv, "details", {})},
                constraint=constraint,
                review=review,
                enforcement_action=enforcement,
            )
        )
    return out


def _pad_rows(a: np.ndarray, pad: int, fill=None) -> np.ndarray:
    if pad <= 0:
        return a
    if fill is None:
        fill = False if a.dtype == bool else -1
    return np.concatenate([a, np.full((pad,) + a.shape[1:], fill, a.dtype)])
