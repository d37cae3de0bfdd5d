"""Fused violation dispatch on one device: match kernel ∧ template programs
∧ need tail, per corpus chunk, with one device->host copy per sweep.

Port of gatekeeper_tpu/parallel/sharding.py (FusedAuditKernel) for one
CUDA device. It keeps the JAX code's staged-operand design and its outputs,
tuple for tuple and bit for bit:

  * `stage_policy` dedups match-spec rows (the match kernel runs over the U
    distinct rows, a [C] gather rebuilds the full matrix) and const sets
    within each program group;
  * `stage_corpus_stacked` ships the encoded corpus once as [K, chunk, ...];
  * `dispatch_need_all` runs every chunk and returns the packed need bits,
    hot rows, hot counts and pair statistics of all chunks in one int32
    buffer fetched with one copy; `dispatch_need` reruns one chunk with a
    larger hot-row window; `decode_need` turns bits into (n, c) pairs.

What differs from the JAX version, and why:

  * No jit and no vmap. The program bodies run eagerly as torch ops on the
    device; a group's distinct const sets run one after another (there are
    few after dedup). The four fixed-shape stages run as hand-written CUDA
    kernels (kernels/ops.py): the match matrix, the slab gathers, EGroup
    and the need tail.
  * Only the table columns the policy's programs read are staged as fused
    [V, T] slab tables. XLA dropped unread slabs by dead-code elimination;
    eager torch eliminates nothing, and a full `pat_capture` slab at 32,768
    rows x L tokens x T columns x 4 bytes reaches gigabytes.
  * Device tables stay resident, padded on the vocab axis to `pad_len`
    rows, as in the JAX version: vocab growth inside the bucket ships only
    the new rows of every table in one host->device copy and one launch of
    K5 (`ops.flush_deltas`); a table's first upload, a bucket overflow, or
    a change of its columns uploads it whole. A resident table is keyed by
    its column identities, not only by its shape and dtype (the JAX test),
    since the port stages only the policy's columns and a policy that
    swaps one column for another of the same width must not reuse it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..engine.exprs import ECapture, EStrTable, ESelPattern, EvalCtx, Expr
from ..engine.programs import Program
from ..engine.patterns import PatternRegistry
from ..engine.tables import StrTables
from ..interop import to_tensor
from ..kernels import ops

_VID_KINDS = ("vid_bool", "vid_i32", "vid_f32")
_KIND_DTYPE = {"vid_bool": np.bool_, "vid_i32": np.int32, "vid_f32": np.float32}
_NARROW = {np.dtype(np.int64): np.int32, np.dtype(np.float64): np.float32}

# delta-upload granularity on the vocab axis: deltas pad to a multiple
# of this many rows (gatekeeper_tpu/parallel/sharding.py _DELTA_ROWS)
DELTA_ROWS = 512


def pad_len(n: int) -> int:
    """Padded vocab-axis capacity: the next power of two (at least 4096)
    that leaves room for one full delta chunk."""
    p = 4096
    while p < n + DELTA_ROWS:
        p *= 2
    return p


@dataclass
class _Resident:
    """A device table padded on its vocab axis (axis 0)."""

    buf: torch.Tensor
    fill: int  # vocab rows written
    ident: Tuple  # (trailing shape, dtype, column identities)


def _g01(g) -> Tuple[int, int]:
    """Fanout argument: an int (g0 == g1 == g) or (g0, g1)."""
    if isinstance(g, tuple):
        return int(g[0]), int(g[1])
    return int(g), int(g)


def _table_kind(t: np.ndarray) -> str:
    if t.dtype == np.bool_:
        return "vid_bool"
    if np.issubdtype(t.dtype, np.integer):
        return "vid_i32"
    return "vid_f32"


def _walk(expr: Expr, seen: set):
    """Every node of an expression DAG once."""
    stack = [expr]
    while stack:
        node = stack.pop()
        if id(node) in seen:
            continue
        seen.add(id(node))
        yield node
        for v in vars(node).values():
            if isinstance(v, Expr):
                stack.append(v)
            elif isinstance(v, (list, tuple)):
                stack.extend(x for x in v if isinstance(x, Expr))


def read_columns(exprs: Sequence[Expr], str_kinds: Dict[str, str]):
    """-> {slab kind: sorted identifiers} of the table columns the
    programs read: pattern indices for pat_member/pat_capture, table
    names per value kind (every EStrTable, so overlay columns exist for
    lookups by non-vid ids too)."""
    cols: Dict[str, set] = {k: set() for k in ("pat_member", "pat_capture") + _VID_KINDS}
    seen: set = set()
    for e in exprs:
        for node in _walk(e, seen):
            if isinstance(node, ESelPattern):
                cols["pat_member"].add(node.pattern_idx)
            elif isinstance(node, ECapture):
                cols["pat_capture"].add(node.pattern_idx)
            elif isinstance(node, EStrTable) and node.table in str_kinds:
                cols[str_kinds[node.table]].add(node.table)
    return {k: sorted(v) for k, v in cols.items() if v}


@dataclass
class StagedPolicy:
    """Constraint-side tensors resident on the device, staged once per
    constraint-set change (see the JAX StagedPolicy)."""

    ms_dev: Dict[str, torch.Tensor]  # [U, ...] distinct match-spec rows
    spec_map: torch.Tensor  # [C] int32: constraint row -> spec row
    group_exprs: List[Any]
    group_rows: List[List[int]]
    group_cmaps: List[List[int]]  # per group: row -> distinct const set
    group_consts: List[List[Dict[str, torch.Tensor]]]  # per group, per set
    compiled_mask: torch.Tensor  # [C] bool
    c_pad: int  # constraint rows (the JAX name; one device pads nothing)
    # slab kind -> column identifiers staged, in slab column order
    cols: Dict[str, List[Any]] = field(default_factory=dict)
    slab_cols: Dict[str, Dict[Any, int]] = field(default_factory=dict)


@dataclass
class StagedBatch:
    """One chunk's resource-side tensors (a view into a StackedCorpus)."""

    fb_dev: Dict[str, torch.Tensor]
    tok_dev: Dict[str, torch.Tensor]
    row_fb: torch.Tensor  # [N_pad] bool
    n_valid: int
    # per-row feature planes ([N_pad] bool each) that ERowFeature reads
    row: Dict[str, torch.Tensor] = field(default_factory=dict)


@dataclass
class StackedCorpus:
    """The whole corpus on the device as [K, chunk, ...] tensors."""

    fb_dev: Dict[str, torch.Tensor]
    tok_dev: Dict[str, torch.Tensor]
    row_fb: torch.Tensor  # [K, chunk] bool
    n_valids: List[int]
    k: int
    chunk: int
    # ephemeral vocab overlay (review batches): "member"/"capture" and the
    # per-kind value slabs, [B, T] in the policy's slab column order
    ov_dev: Optional[Dict[str, torch.Tensor]] = None
    v_base: int = 0
    # per-row feature planes, [K, chunk] bool each (stage_row_feats)
    row_dev: Dict[str, torch.Tensor] = field(default_factory=dict)

    def chunk_view(self, ci: int) -> StagedBatch:
        return StagedBatch(
            fb_dev={k: v[ci] for k, v in self.fb_dev.items()},
            tok_dev={k: v[ci] for k, v in self.tok_dev.items()},
            row_fb=self.row_fb[ci],
            n_valid=self.n_valids[ci],
            row={k: v[ci] for k, v in self.row_dev.items()},
        )


def _program_groups(programs: Sequence[Optional[Program]]) -> List[Dict[str, Any]]:
    """Compiled programs grouped by signature and const shapes, in first-
    seen order: {"expr", "rows" (constraint rows), "consts" (distinct
    const sets), "cmap" (row -> const set)}."""
    groups: Dict[Tuple, Dict[str, Any]] = {}
    for ci, p in enumerate(programs):
        if p is None:
            continue
        gkey = (
            p.signature,
            tuple(sorted((k, v.shape) for k, v in p.consts.items())),
        )
        grp = groups.setdefault(
            gkey,
            {"expr": p.expr, "rows": [], "consts": [], "cmap": [], "cuniq": {}},
        )
        grp["rows"].append(ci)
        csig = b"|".join(
            k.encode() + b"=" + np.asarray(p.consts[k]).tobytes()
            for k in sorted(p.consts)
        )
        cj = grp["cuniq"].get(csig)
        if cj is None:
            cj = grp["cuniq"][csig] = len(grp["consts"])
            grp["consts"].append(p.consts)
        grp["cmap"].append(cj)
    return list(groups.values())


class FusedKernel:
    """One-device fused need dispatch (see the module docstring)."""

    def __init__(self, patterns: PatternRegistry, tables: StrTables, device):
        self.patterns = patterns
        self.tables = tables
        self.device = torch.device(device)
        self._table_cache: Optional[Tuple[Tuple, Dict[str, torch.Tensor]]] = None
        self._resident: Dict[str, _Resident] = {}
        # cumulative upload counters: whole padded tables, and delta rows
        # shipped through flush_deltas (one K5 launch per flush on CUDA)
        self.uploads: Dict[str, int] = {
            "full_uploads": 0, "full_bytes": 0, "delta_tables": 0,
            "delta_rows": 0, "delta_bytes": 0, "delta_flushes": 0,
        }
        self.last_full_tables: List[str] = []  # of the latest restage
        self.policy_stages = 0  # stage_policy calls

    # -- policy ---------------------------------------------------------------

    def _columns(self, group_list: List[Dict[str, Any]]):
        """The slab columns the groups' programs read (read_columns)."""
        self.patterns.sync()
        self.tables.sync()
        str_kinds = {
            name: _table_kind(np.asarray(t))
            for name, t in self.tables.arrays().items()
        }
        return read_columns([g["expr"] for g in group_list], str_kinds)

    def policy_columns(self, programs: Sequence[Optional[Program]]):
        """The slab column map stage_policy would give `programs`, staging
        nothing: a subset's policy stages through it (stage_policy's
        `cols`)."""
        return self._columns(_program_groups(programs))

    def stage_policy(
        self, programs: Sequence[Optional[Program]], ms: Dict[str, np.ndarray],
        cols: Optional[Dict[str, List[Any]]] = None,
    ) -> StagedPolicy:
        """Stage the constraint-side tensors. `cols`, when given, is the
        slab column map to stage through (a superset of what `programs`
        read, e.g. the whole set's for one of its subsets); raises if a
        program reads a column outside it."""
        self.policy_stages += 1
        c = next(iter(ms.values())).shape[0]
        ms_np = {k: np.asarray(v) for k, v in ms.items()}
        # content-dedup the match-spec rows: the match kernel runs over
        # the U distinct rows; spec_map gathers them back per constraint
        uniq: Dict[bytes, int] = {}
        reps: List[int] = []
        spec_map = np.empty((c,), np.int32)
        ms_keys = sorted(ms_np)
        for i in range(c):
            sig = b"|".join(ms_np[k][i].tobytes() for k in ms_keys)
            j = uniq.get(sig)
            if j is None:
                j = uniq[sig] = len(reps)
                reps.append(i)
            spec_map[i] = j
        rep_idx = np.asarray(reps, np.int64)
        ms_dev = {k: to_tensor(v[rep_idx], self.device) for k, v in ms_np.items()}

        compiled_mask = np.asarray([p is not None for p in programs], bool)
        group_list = _program_groups(programs)
        own = self._columns(group_list)
        if cols is None:
            cols = own
        else:
            outside = {
                k: sorted(set(v) - set(cols.get(k, ()))) for k, v in own.items()
            }
            outside = {k: v for k, v in outside.items() if v}
            if outside:
                raise ValueError(
                    f"stage_policy: programs read slab columns {outside} "
                    "outside the given column map")
        return StagedPolicy(
            ms_dev=ms_dev,
            spec_map=to_tensor(spec_map, self.device),
            group_exprs=[grp["expr"] for grp in group_list],
            group_rows=[list(grp["rows"]) for grp in group_list],
            group_cmaps=[list(grp["cmap"]) for grp in group_list],
            group_consts=[
                [
                    {k: to_tensor(v, self.device) for k, v in cd.items()}
                    for cd in grp["consts"]
                ]
                for grp in group_list
            ],
            compiled_mask=to_tensor(compiled_mask, self.device),
            c_pad=c,
            cols=cols,
            slab_cols={
                kind: {ident: i for i, ident in enumerate(idents)}
                for kind, idents in cols.items()
            },
        )

    def _tables_device(self, policy: StagedPolicy) -> Dict[str, torch.Tensor]:
        """String tables [V] plus the fused transposed slab tables
        `<kind>!T` [V, T] holding only the policy's columns; the full
        pattern tables stay on the host, since every pattern node on the
        device reads its slab column. Every table is resident and padded
        on its vocab axis (`_stage_table`); after a pattern/table
        generation change, all tables' new rows go to the device in one
        flush_deltas call."""
        self.patterns.sync()
        self.tables.sync()
        key = (
            self.patterns.generation,
            self.tables.generation,
            tuple((k, tuple(v)) for k, v in sorted(policy.cols.items())),
        )
        if self._table_cache is not None and self._table_cache[0] == key:
            return self._table_cache[1]
        self._table_cache = None
        self.last_full_tables = []
        str_arrs = {k: np.asarray(v) for k, v in self.tables.arrays().items()}
        # name -> (host array, vocab axis first; column identities)
        host: Dict[str, Tuple[np.ndarray, Tuple]] = {
            name: (t, ()) for name, t in str_arrs.items()
        }
        for kind, src in (("pat_member", self.patterns.member),
                          ("pat_capture", self.patterns.capture)):
            idx = policy.cols.get(kind)
            if idx:
                host[kind + "!T"] = (np.asarray(src)[idx].T, tuple(idx))
        for kind in _VID_KINDS:
            names = policy.cols.get(kind)
            if names:
                host[kind + "!T"] = (
                    np.stack(
                        [str_arrs[n].astype(_KIND_DTYPE[kind]) for n in names],
                        axis=1,
                    ),
                    tuple(names),
                )
        pending: List[Tuple[str, np.ndarray]] = []
        for name, (a, cols) in host.items():
            self._stage_table(name, a, cols, pending)
        for stale in set(self._resident) - set(host):
            del self._resident[stale]
        if pending:
            # every table's new rows in one call: one host->device copy
            # and one K5 launch on CUDA
            ops.flush_deltas(
                [self._resident[n].buf for n, _ in pending],
                [self._resident[n].fill for n, _ in pending],
                [d for _, d in pending],
            )
            up = self.uploads
            up["delta_flushes"] += 1
            up["delta_tables"] += len(pending)
            up["delta_rows"] += sum(d.shape[0] for _, d in pending)
            up["delta_bytes"] += sum(
                d.shape[0] * self._resident[n].buf[0].numel()
                * self._resident[n].buf.element_size()
                for n, d in pending
            )
            for n, d in pending:
                self._resident[n].fill = host[n][0].shape[0]
        tabs = {name: self._resident[name].buf for name in host}
        self._table_cache = (key, tabs)
        return tabs

    def _stage_table(self, name: str, a: np.ndarray, cols: Tuple,
                     pending: List[Tuple[str, np.ndarray]]) -> None:
        """Keep table `name` resident: unchanged, extended by a delta of
        its rows [fill, vlen) zero-padded to a multiple of DELTA_ROWS
        (queued in `pending`), or uploaded whole and padded to
        pad_len(vlen) on a first upload, a column or type change, or a
        bucket overflow. Casts happen here, on the host."""
        a = np.asarray(a)
        if a.dtype in _NARROW:
            a = a.astype(_NARROW[a.dtype])
        vlen = a.shape[0]
        ident = (a.shape[1:], a.dtype.str, cols)
        ent = self._resident.get(name)
        if ent is not None and ent.ident == ident and ent.fill <= vlen:
            if ent.fill == vlen:
                return
            dl = vlen - ent.fill
            dpad = -(-dl // DELTA_ROWS) * DELTA_ROWS
            if ent.fill + dpad <= ent.buf.shape[0]:
                delta = np.zeros((dpad,) + a.shape[1:], a.dtype)
                delta[:dl] = a[ent.fill:]
                pending.append((name, delta))
                return
        cap = pad_len(vlen)
        padded = np.zeros((cap,) + a.shape[1:], a.dtype)
        padded[:vlen] = a
        self._resident.pop(name, None)  # release the old buffer first
        buf = to_tensor(padded, self.device)
        self._resident[name] = _Resident(buf, vlen, ident)
        self.uploads["full_uploads"] += 1
        self.uploads["full_bytes"] += padded.nbytes
        self.last_full_tables.append(name)

    # -- corpus ---------------------------------------------------------------

    def stage_corpus_stacked(
        self,
        chunks: Sequence[Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray],
                               np.ndarray, int]],
        policy: StagedPolicy,
        ov: Optional[Dict[str, Any]] = None,
        v_base: int = 0,
    ) -> StackedCorpus:
        """Stack per-chunk (fb, tok, row_fb, n_valid) on a leading chunk
        axis and ship once. `ov` (review batches): {"member": [B, P] bool,
        "capture": [B, P] i32, "tabs": {name: [B]}}, cut to the policy's
        slab columns here so one column map serves base and overlay."""
        k = len(chunks)
        fb_dev = {
            key: to_tensor(np.stack([c[0][key] for c in chunks]), self.device)
            for key in chunks[0][0]
        }
        tok_dev = {
            key: to_tensor(np.stack([c[1][key] for c in chunks]), self.device)
            for key in chunks[0][1]
        }
        chunk = tok_dev["spath"].shape[1]
        row_fb = np.zeros((k, chunk), bool)
        for i, c in enumerate(chunks):
            row_fb[i, : len(c[2])] = c[2]
        ov_dev = None
        if ov is not None:
            ov_host: Dict[str, np.ndarray] = {}
            for kind in ("pat_member", "pat_capture"):
                idx = policy.cols.get(kind)
                if idx:
                    src = ov["member" if kind == "pat_member" else "capture"]
                    ov_host[kind] = np.asarray(src)[:, idx]
            b_pad = ov["member"].shape[0]
            tabs = ov.get("tabs") or {}
            for kind in _VID_KINDS:
                names = policy.cols.get(kind)
                if not names:
                    continue
                dt = _KIND_DTYPE[kind]
                slab = np.zeros((b_pad, len(names)), dt)
                for col, name in enumerate(names):
                    t = tabs.get(name)
                    if t is not None:
                        slab[:, col] = t.astype(dt)
                ov_host[kind] = slab
            ov_dev = {k2: to_tensor(v, self.device) for k2, v in ov_host.items()}
        return StackedCorpus(
            fb_dev=fb_dev,
            tok_dev=tok_dev,
            row_fb=to_tensor(row_fb, self.device),
            n_valids=[c[3] for c in chunks],
            k=k,
            chunk=chunk,
            ov_dev=ov_dev,
            v_base=v_base,
        )

    def stage_row_feats(
        self, corpus: StackedCorpus, feats: Dict[str, np.ndarray],
        volatile: Sequence[str] = (),
    ) -> None:
        """Ship per-row feature bits ([N] bool each) to the device as
        [K, chunk] planes beside the stacked corpus. Names already staged
        are skipped (invdup bits are constant per corpus) unless listed in
        `volatile`."""
        for name, arr in feats.items():
            if name in corpus.row_dev and name not in volatile:
                continue
            plane = np.zeros((corpus.k, corpus.chunk), bool)
            flat = np.asarray(arr, bool)
            for ci in range(corpus.k):
                start = ci * corpus.chunk
                end = min(start + corpus.chunk, flat.shape[0])
                if end > start:
                    plane[ci, : end - start] = flat[start:end]
            corpus.row_dev[name] = to_tensor(plane, self.device)

    # -- dispatch -------------------------------------------------------------

    def _slabs(
        self, policy: StagedPolicy, tabs: Dict[str, torch.Tensor],
        tok: Dict[str, torch.Tensor], ov: Optional[Dict[str, torch.Tensor]],
        v_base: int,
    ) -> Dict[str, torch.Tensor]:
        """The [N, L, T] slab of every staged table kind (K2), shared by
        every program group and const set."""
        slabs: Dict[str, torch.Tensor] = {}
        safe_sp = torch.clamp(tok["spath"], min=0)
        safe_vid = torch.clamp(tok["vid"], min=0)
        for kind in ("pat_member", "pat_capture") + _VID_KINDS:
            t = tabs.get(kind + "!T")
            if t is None:
                continue
            ids = safe_sp if kind.startswith("pat_") else safe_vid
            slabs[kind] = ops.slab_gather(
                t, ids, ov.get(kind) if ov else None, v_base
            )
        return slabs

    def _group_counts(
        self, policy: StagedPolicy, tabs: Dict[str, torch.Tensor],
        tok: Dict[str, torch.Tensor], g,
        ov: Optional[Dict[str, torch.Tensor]] = None, v_base: int = 0,
        row: Optional[Dict[str, torch.Tensor]] = None,
    ):
        """The program bodies (eager torch ops): yields, per signature
        group, (constraint rows [R] long, int32 counts [R, N]). A group's
        body runs once per distinct const set; the sets' [Ku, N] outputs
        are gathered out to the group's rows."""
        g0, g1 = _g01(g)
        has_ov = bool(ov)
        slabs = self._slabs(policy, tabs, tok, ov if has_ov else None, v_base)
        str_tabs = {k: v for k, v in tabs.items() if not k.endswith("!T")}
        ov_cols = None
        if has_ov:
            ov_cols = {
                name: (kind, col)
                for kind, cols in policy.slab_cols.items()
                if kind in _VID_KINDS
                for name, col in cols.items()
            }
        n = tok["spath"].shape[0]
        for expr, grows, cmap, lanes in zip(
            policy.group_exprs, policy.group_rows, policy.group_cmaps,
            policy.group_consts,
        ):

            def eval_one(consts):
                ctx = EvalCtx(
                    tok=tok,
                    pat_member=None,
                    pat_capture=None,
                    str_tables=str_tabs,
                    consts=consts,
                    g0=g0,
                    g1=g1,
                    slabs=slabs,
                    slab_cols=policy.slab_cols,
                    row=row,
                    v_base=v_base if has_ov else None,
                    ov_slabs=ov if has_ov else None,
                    ov_cols=ov_cols,
                )
                return expr.emit(ctx).to(torch.int32)

            rows_t = torch.as_tensor(grows, dtype=torch.long, device=self.device)
            if lanes:
                out_u = torch.stack([eval_one(consts) for consts in lanes])
                cmap_t = torch.as_tensor(cmap, dtype=torch.long, device=self.device)
                yield rows_t, out_u[cmap_t]
            else:
                # const-free program: every row of the group is the same
                yield rows_t, eval_one({}).expand(len(grows), n)

    def _need_chunk(
        self, policy: StagedPolicy, tabs: Dict[str, torch.Tensor],
        batch: StagedBatch, g, r_cap: int,
        ov: Optional[Dict[str, torch.Tensor]], v_base: int,
    ) -> torch.Tensor:
        """One chunk's int32 need row (ops.need_layout); ERowFeature reads
        the chunk's own feature planes."""
        tok = batch.tok_dev
        match_u = ops.match_matrix(policy.ms_dev, batch.fb_dev)  # [U+1, N]
        n = tok["spath"].shape[0]
        viol = torch.zeros((policy.c_pad, n), dtype=torch.bool, device=self.device)
        for rows_t, counts in self._group_counts(
            policy, tabs, tok, g, ov, v_base, batch.row
        ):
            viol[rows_t] = counts > 0
        return ops.need_tail(
            match_u, policy.spec_map, viol, policy.compiled_mask,
            batch.row_fb, batch.n_valid, r_cap,
        )

    def dispatch_need_all(
        self, policy: StagedPolicy, corpus: StackedCorpus, g, r_cap: int = 1024,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Whole-corpus sweep: every chunk's need row, then ONE copy to the
        host. -> packed [K, C_pad*R/8] uint8, hot [K, R] int32, n_hot,
        compiled/interp pair stats [K]. Chunks whose n_hot exceeds r_cap
        are re-dispatched by the caller (dispatch_need)."""
        r_cap = min(r_cap, corpus.chunk)
        tabs = self._tables_device(policy)
        rows = [
            self._need_chunk(
                policy, tabs, corpus.chunk_view(ci), g, r_cap,
                corpus.ov_dev, corpus.v_base,
            )
            for ci in range(corpus.k)
        ]
        buf = torch.stack(rows).cpu().numpy()  # one transfer per sweep
        return unpack_need(buf, policy.c_pad, r_cap)

    def dispatch_need(
        self, policy: StagedPolicy, batch: StagedBatch, g, r_cap: int = 4096,
        ov_in: Optional[Dict[str, torch.Tensor]] = None, v_base: int = 0,
    ) -> Tuple[np.ndarray, np.ndarray, int, int, int]:
        """One chunk with its own hot-row window: -> (packed, hot, n_hot,
        compiled_pairs, interp_pairs). The chunk's row feature planes ride
        on `batch` (StackedCorpus.chunk_view)."""
        n_pad = batch.tok_dev["spath"].shape[0]
        r_cap = min(r_cap, n_pad)
        tabs = self._tables_device(policy)
        row = self._need_chunk(policy, tabs, batch, g, r_cap, ov_in, v_base)
        packed, hot, n_hot, sc, si = unpack_need(
            row[None, :].cpu().numpy(), policy.c_pad, r_cap
        )
        return packed[0], hot[0], int(n_hot[0]), int(sc[0]), int(si[0])

    # -- full output (the harness step) ----------------------------------------

    def prepare(
        self,
        programs: Sequence[Optional[Program]],
        ms: Dict[str, np.ndarray],
        fb: Dict[str, np.ndarray],
        tok: Dict[str, np.ndarray],
        g,
    ):
        """-> (fn, args, (c, n, key)): `fn(*args)` gives (match [C, N]
        bool, counts [Cc, N] int32 or None, totals [C] int32) on the
        device, unchunked, for the C constraints of `ms` (index-aligned
        with `programs`; None routes a constraint to the interpreter: no
        counts row, total 0) over the N reviews of `fb`/`tok`. Counts
        rows follow the compiled programs in constraint order. No row
        feature is supplied, so ERowFeature reads True (the coarse
        screen), as in the JAX step."""
        c = next(iter(ms.values())).shape[0]
        n = next(iter(fb.values())).shape[0]
        policy = self.stage_policy(programs, ms)
        crow = np.full((c,), -1, np.int32)
        compiled = [i for i, p in enumerate(programs) if p is not None]
        crow[compiled] = np.arange(len(compiled), dtype=np.int32)
        fb_dev = {k: to_tensor(v, self.device) for k, v in fb.items()}
        tok_dev = {k: to_tensor(v, self.device) for k, v in tok.items()}
        tabs = self._tables_device(policy)
        crow_dev = to_tensor(crow, self.device)
        n_compiled = len(compiled)
        key = (
            tuple(tuple(r) for r in policy.group_rows), tuple(compiled), g, n,
        )

        def run_fused(ms_in, spec_map, fb_in, tok_in, tabs_in, crow_in):
            match = ops.match_matrix(ms_in, fb_in)[spec_map.long()]  # [C, N]
            counts = None
            if n_compiled:
                counts = torch.zeros(
                    (n_compiled, n), dtype=torch.int32, device=self.device
                )
                for rows_t, out in self._group_counts(
                    policy, tabs_in, tok_in, g
                ):
                    counts[crow_in[rows_t].long()] = out
            totals = ops.full_totals(match, counts, crow_in, n)
            return match, counts, totals

        args = (policy.ms_dev, policy.spec_map, fb_dev, tok_dev, tabs, crow_dev)
        return run_fused, args, (c, n, key)

    def run(
        self,
        programs: Sequence[Optional[Program]],
        ms: Dict[str, np.ndarray],
        fb: Dict[str, np.ndarray],
        tok: Dict[str, np.ndarray],
        g,
    ) -> Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]:
        """-> host (match [C, N] bool, counts [Cc, N] int32 | None,
        totals [C] int32): the compiled-path violation totals per
        constraint (see prepare)."""
        fn, args, (c, n, _key) = self.prepare(programs, ms, fb, tok, g)
        match, counts, totals = fn(*args)
        return (
            match.cpu().numpy()[:c, :n],
            None if counts is None else counts.cpu().numpy()[:, :n],
            totals.cpu().numpy()[:c],
        )


def unpack_need(buf: np.ndarray, c_pad: int, r: int):
    """[K, width] int32 need rows -> (packed uint8 [K, p8], hot [K, r],
    n_hot [K], compiled pairs [K], interp pairs [K])."""
    p8, w4, _ = ops.need_layout(c_pad, r)
    packed = (
        np.ascontiguousarray(buf[:, :w4])
        .astype("<u4")
        .view(np.uint8)
        .reshape(buf.shape[0], -1)[:, :p8]
    )
    hot = buf[:, w4:w4 + r]
    return packed, hot, buf[:, w4 + r], buf[:, w4 + r + 1], buf[:, w4 + r + 2]


def decode_need(
    packed: np.ndarray, hot: np.ndarray, c_pad: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Packed hot-row need bits -> (n_idx, c_idx) arrays sorted
    review-major (matching the interpreter driver's emit order)."""
    hot = np.asarray(hot)
    r = hot.shape[0]
    bits = np.unpackbits(np.asarray(packed))[: c_pad * r]
    c_is, j_is = np.nonzero(bits.reshape(c_pad, r))
    n_loc = hot[j_is]
    order = np.lexsort((c_is, n_loc))
    return n_loc[order], c_is[order]

