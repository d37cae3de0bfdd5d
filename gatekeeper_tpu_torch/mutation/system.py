# Copied from gatekeeper_tpu/mutation/system.py; only these edits differ.
# Edit: the screen runs the port's match matrix: `engine.matchkernel.
# match_matrix` (K1, kernels/csrc/match.cu, on CUDA tensors; its plain torch
# version on CPU tensors) over `matchspec_to_tensors` / `features_to_tensors`
# on the system's device (`device`, None meaning "cuda"; the Runner passes
# its driver's), with the spec tensors cached per generation on that device.
# Label-overflow rows still re-check on the host oracle, as in the reference.
"""Mutator registry + schema-conflict detection + batch screening +
fixpoint application.

`MutationSystem` is the mutation plane's Client-equivalent: controllers
upsert/remove mutator CRs into it, the webhook screens and applies
through it. Key properties:

  * **Ingestion-order independence** — mutators apply in (kind, name)
    sort order, so two pods that ingested the same set in different
    orders produce byte-identical mutations.
  * **Schema conflicts** — two mutators whose location paths imply
    different node types for the same tree position (object vs list,
    or lists keyed by different fields) are BOTH quarantined: neither
    applies until the conflict clears (the reference's
    schema.ErrConflictingSchema semantics).
  * **Kernel-screened batches** — `screen(reviews)` computes the full
    [n_mutators, n_reviews] applicability matrix with ONE
    `engine.matchkernel.match_matrix` device dispatch (mutator Match
    specs reuse the constraint match schema end-to-end:
    `constraint/match.py` semantics → `flatten/encoder.py` features →
    the K1 kernel on the card). Rows whose label features overflowed the batch
    bucket re-check on the host oracle, so truncation can't flip a
    verdict.
  * **Fixpoint with a hard cap** — `apply` re-runs the applicable
    mutator list until a full pass changes nothing; past
    MAX_ITERATIONS it raises ConvergenceError. A non-converged object
    is NEVER admitted (the webhook turns the error into a 500).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..flatten.encoder import batch_review_features
from ..flatten.vocab import Vocab
from .mutators import ConvergenceError, Mutator, mutator_from_obj
from .path import ListNode

# fixpoint cap: the reference uses 3 System.Mutate iterations over an
# already-sorted list; a deeper cap keeps legitimately-chained mutators
# (A enables B's pathTest...) converging while still bounding cycles
MAX_ITERATIONS = 16


def _schema_conflicts(muts: Sequence[Mutator]) -> Dict[str, List[str]]:
    """{mutator id -> sorted conflicting ids}. Two mutators conflict
    when their location trees disagree on a node's type: one addresses
    `x.y` as an object (intermediate ObjectNode) where the other
    addresses it as a list (`x.y[k: v]`), or both address it as a list
    but keyed by different fields. Terminal nodes are type-Unknown and
    conflict with nothing."""
    # position key: tuple of (name, kind-tag) steps from the root
    implied: Dict[Tuple, Dict[str, List[str]]] = {}
    for m in muts:
        key: Tuple = ()
        for i, node in enumerate(m.path):
            last = i == len(m.path) - 1
            key = key + (node.name,)
            if isinstance(node, ListNode):
                ty = f"list[{node.key_field}]"
            elif last:
                ty = None  # terminal object node: type unknown
            else:
                ty = "object"
            if ty is not None:
                implied.setdefault(key, {}).setdefault(ty, []).append(m.id)
            key = key + (ty or "*",)
    out: Dict[str, List[str]] = {}
    for _pos, by_type in implied.items():
        if len(by_type) < 2:
            continue
        all_ids = sorted({i for ids in by_type.values() for i in ids})
        for ty, ids in by_type.items():
            for mid in ids:
                others = [o for o in all_ids if o != mid]
                if others:
                    cur = out.setdefault(mid, [])
                    for o in others:
                        if o not in cur:
                            cur.append(o)
    return {k: sorted(v) for k, v in out.items()}


def _review_gvk(review: Dict[str, Any]) -> Tuple[str, str, str]:
    k = review.get("kind") if isinstance(review, dict) else None
    if not isinstance(k, dict):
        return ("", "", "")
    return (
        k.get("group") or "",
        k.get("version") or "",
        k.get("kind") or "",
    )


class MutationSystem:
    def __init__(self, metrics=None, logger=None, target_handler=None,
                 device=None):
        import torch

        from ..constraint.handler import default_handler
        from ..logs import null_logger

        # the screen's device: the card unless the caller asks for another
        self.device = torch.device("cuda" if device is None else device)
        self.metrics = metrics
        self.log = logger if logger is not None else null_logger()
        # the target whose review/match vocabulary mutator Match specs
        # speak: K8s by default; an AgentActionTarget makes this system
        # rewrite tool-call arguments instead of pods (docs/targets.md)
        self.target_handler = (
            target_handler if target_handler is not None else default_handler()
        )
        self._lock = threading.Lock()
        self._mutators: Dict[str, Mutator] = {}  # id -> mutator
        self._conflicts: Dict[str, List[str]] = {}
        self._generation = 0
        # screening caches, rebuilt lazily per generation
        self._vocab = Vocab()
        self._spec_cache: Optional[Tuple[int, List[Mutator], dict]] = None
        self.screen_dispatches = 0

    # -- registry ------------------------------------------------------------

    def upsert(self, obj: Dict[str, Any]) -> Mutator:
        """Ingest (or replace) a mutator CR; raises MutatorError on an
        invalid spec. Recomputes the conflict set."""
        mut = mutator_from_obj(obj)
        with self._lock:
            self._mutators[mut.id] = mut
            self._rebuild_locked()
        return mut

    def remove(self, obj_or_id) -> None:
        if isinstance(obj_or_id, str):
            mid = obj_or_id
        else:
            kind = (obj_or_id or {}).get("kind", "?")
            name = ((obj_or_id or {}).get("metadata") or {}).get("name", "?")
            mid = f"{kind}/{name}"
        with self._lock:
            if self._mutators.pop(mid, None) is not None:
                self._rebuild_locked()

    def wipe(self) -> None:
        """Drop every mutator (Config wipe/replay: the watch replay
        re-upserts the live set)."""
        with self._lock:
            if self._mutators:
                self._mutators = {}
                self._rebuild_locked()

    def _rebuild_locked(self) -> None:
        self._generation += 1
        self._spec_cache = None
        self._conflicts = _schema_conflicts(
            sorted(self._mutators.values(), key=Mutator.sort_key)
        )

    def ordered(self) -> List[Mutator]:
        """Active (non-conflicted) mutators in application order."""
        with self._lock:
            return [
                m
                for m in sorted(
                    self._mutators.values(), key=Mutator.sort_key
                )
                if m.id not in self._conflicts
            ]

    def conflicts(self) -> Dict[str, List[str]]:
        with self._lock:
            return {k: list(v) for k, v in self._conflicts.items()}

    def count(self) -> int:
        with self._lock:
            return len(self._mutators)

    @property
    def generation(self) -> int:
        with self._lock:
            return self._generation

    # -- screening -----------------------------------------------------------

    def _specs(self) -> Tuple[List[Mutator], Optional[dict]]:
        """(ordered mutators, device-ready match tensors) for the
        current generation; tensors cached until the set changes."""
        from ..engine.matchkernel import matchspec_to_tensors

        with self._lock:
            gen = self._generation
            if self._spec_cache is not None and self._spec_cache[0] == gen:
                _, muts, ms = self._spec_cache
                return muts, ms
            muts = [
                m
                for m in sorted(
                    self._mutators.values(), key=Mutator.sort_key
                )
                if m.id not in self._conflicts
            ]
            if not muts:
                self._spec_cache = (gen, [], None)
                return [], None
            specs = self.target_handler.compile_match_specs(
                [{"spec": {"match": m.match}} for m in muts], self._vocab
            )
            ms = matchspec_to_tensors(specs, self.device)
            self._spec_cache = (gen, muts, ms)
            return muts, ms

    def screen(
        self,
        reviews: Sequence[Dict[str, Any]],
        ns_cache: Optional[Dict[str, Any]] = None,
    ) -> Tuple[List[Mutator], np.ndarray]:
        """One device dispatch for the whole batch: returns the ordered
        mutator snapshot and the [n_mutators, n_reviews] bool matrix of
        (match ∧ applyTo) applicability."""
        from ..engine.matchkernel import features_to_tensors, match_matrix
        from ..flatten.vocab import OverlayVocab

        ns_cache = ns_cache or {}
        muts, ms = self._specs()
        if not muts or not reviews:
            return muts, np.zeros((len(muts), len(reviews)), bool)
        # ephemeral overlay: every batch carries fresh names/labels;
        # interning them into the persistent vocab would grow it (and
        # re-key the spec tensors' id space) forever. Novel strings get
        # local ids >= base_len, which can never equal a compiled spec
        # id — exactly the "never matches" semantics they need.
        overlay = OverlayVocab(self._vocab)
        feats = [
            self.target_handler.encode_review_features(r, ns_cache, overlay)
            for r in reviews
        ]
        fb = batch_review_features(feats)
        mat = match_matrix(
            ms, features_to_tensors(fb, self.device)
        ).cpu().numpy().astype(bool)
        self.screen_dispatches += 1
        if self.metrics is not None:
            self.metrics.record("mutation_screen_dispatch_total", 1)
        # truncated label rows can falsely miss: re-verdict on the oracle
        overflow = getattr(fb, "label_overflow", None)
        if overflow is not None and overflow.any():
            for i in np.flatnonzero(overflow):
                mat[:, i] = self._screen_host_one(muts, reviews[i], ns_cache)
        self._and_apply_to(muts, reviews, mat)
        return muts, mat

    def screen_host(
        self,
        reviews: Sequence[Dict[str, Any]],
        ns_cache: Optional[Dict[str, Any]] = None,
    ) -> Tuple[List[Mutator], np.ndarray]:
        """Pure-host fallback screen (oracle semantics, no device)."""
        ns_cache = ns_cache or {}
        muts = self.ordered()
        mat = np.zeros((len(muts), len(reviews)), bool)
        for i, r in enumerate(reviews):
            mat[:, i] = self._screen_host_one(muts, r, ns_cache)
        self._and_apply_to(muts, reviews, mat)
        return muts, mat

    def _screen_host_one(
        self,
        muts: Sequence[Mutator],
        review: Dict[str, Any],
        ns_cache: Dict[str, Any],
    ) -> np.ndarray:
        return np.array(
            [
                self.target_handler.matches_constraint(
                    {"spec": {"match": m.match}}, review, ns_cache
                )
                for m in muts
            ],
            bool,
        )

    @staticmethod
    def _and_apply_to(muts, reviews, mat: np.ndarray) -> None:
        """AND the host-side applyTo GVK filter into the match matrix
        (exact small-set membership — not worth a device round trip)."""
        gvks = [_review_gvk(r) for r in reviews]
        for j, m in enumerate(muts):
            if m.apply_to is None:
                continue
            for i, (g, v, k) in enumerate(gvks):
                if mat[j, i] and not m.applies_to(g, v, k):
                    mat[j, i] = False

    # -- application ---------------------------------------------------------

    def apply(
        self,
        obj: Dict[str, Any],
        review: Dict[str, Any],
        muts: Optional[Sequence[Mutator]] = None,
    ) -> Tuple[Dict[str, Any], int]:
        """Fixpoint application of `muts` (already screened; defaults
        to every active mutator) -> (mutated object, iterations). The
        input object is never modified. Raises ConvergenceError past
        MAX_ITERATIONS — callers must NOT admit the object then."""
        if muts is None:
            muts = self.ordered()
        cur = obj
        for iteration in range(1, MAX_ITERATIONS + 1):
            changed_ids: List[str] = []
            for m in muts:
                cur, changed = m.apply(cur, review)
                if changed:
                    changed_ids.append(m.id)
            if not changed_ids:
                return cur, iteration
        raise ConvergenceError(
            f"mutation did not converge after {MAX_ITERATIONS} iterations; "
            f"still changing: {sorted(set(changed_ids))}"
        )

    # -- introspection -------------------------------------------------------

    def report_gauges(self) -> None:
        """Publish the registry-shape gauges (mutators per kind/status,
        conflict count) — called by the mutator controller after every
        ingest/remove so dashboards track the live set."""
        if self.metrics is None:
            return
        with self._lock:
            by_kind: Dict[Tuple[str, str], int] = {}
            for m in self._mutators.values():
                status = (
                    "conflict" if m.id in self._conflicts else "active"
                )
                by_kind[(m.kind, status)] = (
                    by_kind.get((m.kind, status), 0) + 1
                )
            n_conf = len(self._conflicts)
        from .mutators import MUTATOR_KINDS

        for kind in MUTATOR_KINDS:
            for status in ("active", "conflict"):
                self.metrics.gauge(
                    "mutators",
                    by_kind.get((kind, status), 0),
                    kind=kind,
                    status=status,
                )
        self.metrics.gauge("mutator_conflicts", n_conf)
