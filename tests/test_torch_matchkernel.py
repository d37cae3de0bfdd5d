"""The port's match matrix (gatekeeper_tpu_torch, plain torch version on
the CPU) against the JAX package's jitted match_matrix, bit for bit.

Both sides get identical encoded inputs: the structured battery of
test_constraint_match.py and the constraint/review fuzz of
test_match_kernel.py are compiled once with the JAX package's encoders and
handed to both as numpy arrays; a seeded raw-tensor battery then covers
what compiled specs rarely reach: -1 pads, -2 wildcards and -3 invalid kind
rows, all five matchExpression ops (ALWAYS_VIOLATED included), every
scope code and all four object/oldObject presence cases.
"""

import random

import numpy as np
import pytest

from gatekeeper_tpu.engine.matchkernel import match_matrix as jax_match
from gatekeeper_tpu.engine.matchkernel import matchspec_to_np
from gatekeeper_tpu.engine.matchspec import compile_match_specs
from gatekeeper_tpu.flatten import Vocab, batch_review_features, encode_review_features
from gatekeeper_tpu.constraint.tpudriver import _features_np
from gatekeeper_tpu_torch import interop
from gatekeeper_tpu_torch.engine import matchkernel as tmk
from gatekeeper_tpu_torch.engine.matchkernel import match_matrix as torch_match
from gatekeeper_tpu_torch.engine.matchspec import compile_match_specs as t_compile
from gatekeeper_tpu_torch.flatten import (
    Vocab as TVocab,
    batch_review_features as t_batch,
    encode_review_features as t_encode,
)

from test_constraint_match import CONSTRAINTS, NS_CACHE, REVIEWS
from test_match_kernel import _random_constraint, _random_review


def _both(ms: dict, fb: dict):
    want = np.asarray(jax_match(ms, fb))
    got = torch_match(
        interop.matchspec(ms, "cpu"), interop.features(fb, "cpu")
    ).numpy()
    return got, want


def _encoded(constraints, reviews):
    vocab = Vocab()
    ms = matchspec_to_np(compile_match_specs(constraints, vocab))
    feats = [encode_review_features(r, NS_CACHE, vocab) for r in reviews]
    return ms, _features_np(batch_review_features(feats))


def test_structured_battery_equal():
    got, want = _both(*_encoded(CONSTRAINTS, list(REVIEWS.values())))
    assert got.dtype == np.bool_ and got.shape == want.shape
    assert np.array_equal(got, want)
    assert want.any() and not want.all()


def test_port_encoding_equal():
    """The port's own copies of the spec compiler and review encoder,
    through matchspec_to_tensors/features_to_tensors, give the same
    matrix as the JAX package end to end."""
    constraints, reviews = CONSTRAINTS, list(REVIEWS.values())
    want = np.asarray(jax_match(*_encoded(constraints, reviews)))
    vocab = TVocab()
    ms = tmk.matchspec_to_tensors(t_compile(constraints, vocab), "cpu")
    fb = t_batch([t_encode(r, NS_CACHE, vocab) for r in reviews])
    got = torch_match(ms, tmk.features_to_tensors(fb, "cpu")).numpy()
    assert np.array_equal(got, want)


def test_constraint_fuzz_equal():
    rng = random.Random(20260729)
    constraints = [_random_constraint(rng, i) for i in range(120)]
    reviews = [_random_review(rng) for _ in range(80)]
    got, want = _both(*_encoded(constraints, reviews))
    assert np.array_equal(got, want)


def _raw_battery(seed: int, u: int = 48, n: int = 96):
    """Random encoded specs/features over a tiny id space, so ids,
    selectors and labels collide often; about half of each spec's parts
    are left unset (all -1 pads / False) so that matches stay common."""
    r = np.random.default_rng(seed)

    def ids(shape, lo=-1, hi=4):
        return r.integers(lo, hi, size=shape).astype(np.int32)

    def flags(shape, p=0.5):
        return r.random(shape) < p

    def unset(a, p=0.5):
        # blank whole spec rows with -1
        a[r.random(a.shape[0]) < p] = -1
        return a

    def labels(rows, ml):
        lab = ids((rows, ml, 2), 0, 3)
        lab[r.random((rows, ml)) < 0.4] = -1
        return lab

    def exprs():
        e = np.stack(
            [ids((u, 2), 0, 3), ids((u, 2), -1, 6), ids((u, 2), 0, 2)], axis=-1
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
        "obj_labels": labels(n, 4), "old_labels": labels(n, 4),
        "nssel_defined": flags(n, 0.7), "nssel_labels": labels(n, 4),
        "nssel_empty": flags(n, 0.3),
    }
    return ms, fb


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_raw_tensor_battery_equal(seed):
    ms, fb = _raw_battery(seed)
    # the battery must reach every op code and presence case it claims
    ops = set(ms["lab_expr"][..., 1].ravel()) | set(ms["nssel_expr"][..., 1].ravel())
    assert {1, 2, 3, 4, 5} <= ops
    cases = set(zip(fb["obj_present"], fb["old_present"]))
    assert len(cases) == 4
    got, want = _both(ms, fb)
    assert 0.02 < want.mean() < 0.98
    assert np.array_equal(got, want)


def test_empty_spec_set():
    ms, fb = _raw_battery(7, u=0)
    got, want = _both(ms, fb)
    assert got.shape == want.shape == (0, 96)
