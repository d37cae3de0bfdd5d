"""Compiled template programs: build and evaluate (torch).

Port of gatekeeper_tpu/engine/programs.py. `Program` and `compile_program`
are the JAX package's, unchanged. A `Program` is the compiled form of one
(template, constraint-params) pair: an Expr DAG returning per-resource
violation counts plus the constraint's constant arrays. `ProgramEvaluator`
evaluates programs eagerly with torch on the device the token tensors lie
on (the counterpart of `eval_np`/`eval_jax`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..rego import ast as A
from .exprs import EvalCtx, Expr
from .patterns import PatternRegistry
from .symbolic import Compiler, CompilerEnv, CompileUnsupported
from .tables import StrTables
from ..interop import to_tensor


@dataclass
class Program:
    expr: Expr
    consts: Dict[str, np.ndarray]
    signature: Tuple
    g_max: int = 8  # array-axis fanout the program was evaluated with
    # screen programs over-approximate (inventory-join conditions are
    # dropped, symbolic.InventoryDependent); exact results come from the
    # interpreter re-check of flagged pairs
    screen: bool = False
    # per-row feature names this program consumes ("invdup:<pattern>"
    # join-key duplication bits the dispatch layer computes per corpus)
    row_features: Tuple[str, ...] = ()
    # compiled-render metadata (exact programs only, engine/render.py):
    # grouped violation branches (un-flagged cond + head render plan) and
    # row-level safety flags; flagged rows render via the interpreter
    branches: Optional[Tuple] = None
    flags: Tuple = ()
    # derived-key join prune plan ({fn, review_prefix, tree}): flagged
    # pairs render against the key index's candidate objects instead of
    # the whole inventory (uniqueserviceselector at 100k scale)
    prune: Optional[Dict[str, Any]] = None


def compile_program(
    env: CompilerEnv, modules: Sequence[A.Module], params: Any
) -> Program:
    try:
        comp = Compiler(env, modules, params)
        expr = comp.compile_violation_counts()
    except CompileUnsupported:
        try:
            # element projection may have aborted (a second-array join
            # whose conditions could not reduce existentially): retry
            # exact with projection off — conflicted iterations take the
            # flag-guarded object branch instead
            comp = Compiler(env, modules, params, elem_projection=False)
            expr = comp.compile_violation_counts()
        except CompileUnsupported:
            # retry as a screen: uncompilable calls/comprehensions become
            # opaque and conditions on them drop — a sound
            # over-approximation whose flagged pairs the driver re-checks
            # via the interpreter. This keeps inventory joins
            # (uniqueingresshost/-serviceselector) and intra-object joins
            # (seccomp/apparmor annotation matching) on the device path
            # for the dense non-matching bulk.
            comp = Compiler(env, modules, params, screen_mode=True)
            expr = comp.compile_violation_counts()
            comp.uses_inventory = True
            comp.opaque = True  # retried conditions over-approximate
    env.patterns.sync()
    env.tables.sync()
    sig = tuple(
        x if not isinstance(x, list) else tuple(x) for x in comp.signature
    )
    if comp.uses_inventory:
        sig = sig + (("inventory-screen",),)
    return Program(
        expr=expr,
        consts=comp.pool.values,
        signature=sig,
        screen=comp.uses_inventory,
        row_features=tuple(comp.row_features),
        # render branches stay valid when only safety FLAGS fired (the
        # render path routes flagged rows to the interpreter itself);
        # genuine opacity (dropped conditions) disables them entirely
        branches=tuple(comp.out_branches) if not comp.opaque else None,
        flags=tuple(comp.out_flags),
        prune=comp.prune_plan,
    )


class ProgramEvaluator:
    """Evaluates programs over token tensors on their own device, with
    the JAX device path's 32-bit types (the counterpart of eval_jax)."""

    def __init__(self, patterns: PatternRegistry, tables: StrTables):
        self.patterns = patterns
        self.tables = tables
        self._tables: Optional[Tuple[Tuple, Dict[str, torch.Tensor]]] = None

    def _table_tensors(self, device) -> Dict[str, torch.Tensor]:
        self.patterns.sync()
        self.tables.sync()
        key = (self.patterns.generation, self.tables.generation, str(device))
        if self._tables is None or self._tables[0] != key:
            arrs = {
                "pat_member": self.patterns.member,
                "pat_capture": self.patterns.capture,
                **self.tables.arrays(),
            }
            self._tables = (key, {
                k: to_tensor(v, device) for k, v in arrs.items()
            })
        return self._tables[1]

    def eval(
        self,
        programs: Sequence[Program],
        tok: Dict[str, torch.Tensor],
        g: Any = 8,
        overlay: Optional[Dict[str, Any]] = None,
    ) -> torch.Tensor:
        """-> [n_programs, N] int32 violation counts. `overlay` (review
        batches): {"v_base", "member", "capture", "tabs"} vocab-overlay
        blocks (tensors) for ids >= v_base."""
        device = tok["spath"].device
        n = tok["spath"].shape[0]
        if not programs:
            return torch.zeros((0, n), dtype=torch.int32, device=device)
        tabs = self._table_tensors(device)
        str_tabs = {
            k: v for k, v in tabs.items()
            if k not in ("pat_member", "pat_capture")
        }
        ov = overlay or {}
        g0, g1 = (g if isinstance(g, tuple) else (g, g))
        outs = []
        for p in programs:
            ctx = EvalCtx(
                tok=tok,
                pat_member=tabs["pat_member"],
                pat_capture=tabs["pat_capture"],
                str_tables=str_tabs,
                consts={
                    k: to_tensor(v, device) for k, v in p.consts.items()
                },
                g0=g0,
                g1=g1,
                v_base=ov.get("v_base"),
                ov_member=ov.get("member"),
                ov_capture=ov.get("capture"),
                ov_tabs=ov.get("tabs"),
            )
            outs.append(p.expr.emit(ctx).to(torch.int32))
        return torch.stack(outs, 0)
