"""EGatherElem (B4, the port's K6) against the JAX package, on the CPU.

  * the node's emit: the port's plain version against JAX's `_emit` under
    jax.numpy on seeded inputs, for the g0 and g01 axes and bool, int32
    and float32 element values, with idx -1 and idx1 >= g1 (JAX's flat
    index runs on into the next element there, and the port keeps that);
  * a two-array join in the shape of gatekeeper-library's
    pod-security-policy/host-filesystem (chip_smoke.HOSTFS_REGO): the
    compiler emits EGatherElem for it, and audit() over TorchDriver("cpu")
    equals the interpreter driver's;
  * the JAX package's compiled form of that template: where the template's
    `path_array` helper decides, JAX's TpuDriver flags every hostPath
    volume (it tableizes the array-valued helper into a numeric table that
    is undefined everywhere); the port refuses that tableization and
    matches the interpreter. Where no allowed prefix is involved, all
    three drivers agree.
"""

import copy
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gatekeeper_tpu.constraint import (
    AugmentedUnstructured as JAug,
    Backend as JBackend,
    K8sValidationTarget as JTarget,
    RegoDriver as JRegoDriver,
)
from gatekeeper_tpu.constraint.tpudriver import TpuDriver
from gatekeeper_tpu.engine import exprs as jx
from gatekeeper_tpu_torch.constraint import (
    Backend as TBackend,
    K8sValidationTarget as TTarget,
    RegoDriver as TRegoDriver,
)
from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver
from gatekeeper_tpu_torch.engine import exprs as tx
from gatekeeper_tpu_torch.kernels import ops

TARGET = chip_smoke.TARGET
NEG_INF = -(10.0**30)  # engine/symbolic.py's float max-init


# -- the node -------------------------------------------------------------------


def _leaf(mod, value, space):
    """An Expr of the given space that emits a fixed array."""

    class Leaf(mod.Expr):
        def _emit(self, ctx):
            return value

    node = Leaf()
    node.space = space
    return node


def _ctx(mod, tok, g0, g1, **kw):
    return mod.EvalCtx(
        tok=tok, pat_member=None, pat_capture=None, str_tables={},
        consts={}, g0=g0, g1=g1, **kw,
    )


def _elem_values(r, n, g, dtype):
    if dtype == np.bool_:
        return r.random((n, g)) < 0.5
    return r.integers(-3, 900, size=(n, g)).astype(dtype)


DEFAULTS = {np.bool_: False, np.int32: -1, np.float32: NEG_INF}


@pytest.mark.parametrize("dtype", [np.bool_, np.int32, np.float32])
@pytest.mark.parametrize("axis", ["g0", "g01"])
def test_gather_elem_equals_jax_node(axis, dtype):
    r = np.random.default_rng(11)
    n, l, g0, g1 = 64, 40, 8, 4
    # -1 pads, idx0 past g0, and idx1 past g1 (which aliases into the
    # next element on g01)
    idx0 = r.integers(-1, g0 + 2, size=(n, l)).astype(np.int32)
    idx1 = r.integers(-1, g1 + 3, size=(n, l)).astype(np.int32)
    g = g0 if axis == "g0" else g0 * g1
    v = _elem_values(r, n, g, dtype)
    default = DEFAULTS[dtype]
    jnode = jx.EGatherElem(_leaf(jx, jnp.asarray(v), (axis,)), default)
    tnode = tx.EGatherElem(_leaf(tx, torch.from_numpy(v), (axis,)), default)
    want = np.asarray(jnode.emit(_ctx(
        jx, {"idx0": jnp.asarray(idx0), "idx1": jnp.asarray(idx1)}, g0, g1,
        np=jnp,
    )))
    got = tnode.emit(_ctx(
        tx, {"idx0": torch.from_numpy(idx0), "idx1": torch.from_numpy(idx1)},
        g0, g1,
    )).numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert np.array_equal(got, want)
    # the inputs reach every branch: defaults, in-range gathers and, on
    # g01, a flat index carried into the next element by idx1 >= g1
    flat = np.where((idx0 >= 0) & (idx1 >= 0), idx0 * g1 + idx1, -1)
    idx = idx0 if axis == "g0" else flat
    assert ((idx < 0) | (idx >= g)).any() and ((idx >= 0) & (idx < g)).any()
    if axis == "g01":
        assert ((idx1 >= g1) & (flat < g) & (idx0 >= 0)).any()


def test_gather_elem_types_and_axes():
    v = torch.zeros((2, 4), dtype=torch.bool)
    idx = torch.zeros((2, 3), dtype=torch.int32)
    out = ops.gather_elem_plain(v, idx, idx, "g0", 4, 1, -1)
    assert out.dtype == torch.int32  # as torch.where/JAX promote
    with pytest.raises(ValueError, match="axis"):
        ops.elem_index(idx, idx, "g1", 4, 1)


# -- the join template ----------------------------------------------------------


def _hf_pod(name, volumes, containers, init=None):
    spec = {"volumes": volumes, "containers": containers}
    if init:
        spec["initContainers"] = init
    return {
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {"name": name, "namespace": "default"},
        "spec": spec,
    }


VOLS = [
    [],
    [{"name": "v1", "hostPath": {"path": "/foo"}}],
    [{"name": "v1", "hostPath": {"path": "/foo/bar"}},
     {"name": "v2", "emptyDir": {}}],
    [{"name": "v1", "hostPath": {"path": "/fool"}}],
    [{"name": "v1", "hostPath": {"path": "/var/log/x"}},
     {"name": "v2", "hostPath": {"path": "/foo"}}],
]
CTRS = [
    [{"name": "c", "image": "x"}],
    [{"name": "c", "image": "x",
      "volumeMounts": [{"name": "v1", "mountPath": "/m"}]}],
    [{"name": "c", "image": "x",
      "volumeMounts": [{"name": "v1", "mountPath": "/m", "readOnly": True}]}],
    [{"name": "c", "image": "x",
      "volumeMounts": [{"name": "v2", "mountPath": "/m"}]},
     {"name": "d", "image": "y",
      "volumeMounts": [{"name": "v1", "mountPath": "/m", "readOnly": True},
                       {"name": "v1", "mountPath": "/m2"}]}],
]


def _corpus():
    """The volume x mount shapes above, an initContainer mount, and a
    seeded sample of the smoke corpus and of churned pods."""
    pods = [
        _hf_pod(f"hf{i}", vs, cs)
        for i, (vs, cs) in enumerate(itertools.product(VOLS, CTRS))
    ]
    pods.append(_hf_pod(
        "hfinit", [{"name": "v1", "hostPath": {"path": "/foo"}}],
        [{"name": "c", "image": "x"}],
        init=[{"name": "ic", "image": "x",
               "volumeMounts": [{"name": "v1", "mountPath": "/m"}]}],
    ))
    r = np.random.default_rng(3)
    pods += [chip_smoke.make_pod(int(i), max_containers=4)
             for i in r.choice(3000, size=40, replace=False)]
    pods += [chip_smoke.churn_pod(int(j)) for j in r.choice(60, 12, replace=False)]
    return pods


PARAMS = [
    None,
    [],
    [{"pathPrefix": "/foo"}],
    [{"pathPrefix": "/foo", "readOnly": True}, {"pathPrefix": "/var/log"}],
] + chip_smoke.JOIN_PARAMS


def _client(backend, target, driver, params, template=None):
    client = backend(driver).new_client(target())
    client.add_template(template or chip_smoke.hostfs_template())
    (c,) = chip_smoke.join_constraint_docs(1)
    if params is None:
        del c["spec"]["parameters"]
    else:
        c["spec"]["parameters"] = {"allowedHostPaths": params}
    client.add_constraint(c)
    for p in _corpus():
        client.add_data(copy.deepcopy(p))
    return client


def _audit(client):
    return [chip_smoke.result_key(r)
            for r in client.audit().by_target[TARGET].results]


def _walk(expr, mod):
    seen, stack = set(), [expr]
    while stack:
        e = stack.pop()
        if id(e) in seen:
            continue
        seen.add(id(e))
        yield e
        for v in vars(e).values():
            if isinstance(v, mod.Expr):
                stack.append(v)
            elif isinstance(v, (list, tuple)):
                stack.extend(x for x in v if isinstance(x, mod.Expr))


def test_join_template_compiles_to_gather_elem():
    """Both compilers turn the host-filesystem join into a compiled
    program (no pair on the interpreter) that reads the mounts through
    EGatherElem on the g01 axis."""
    params = chip_smoke.JOIN_PARAMS[0]
    j_drv, t_drv = TpuDriver(), TorchDriver(device="cpu")
    _audit(_client(JBackend, JTarget, j_drv, params))
    _audit(_client(TBackend, TTarget, t_drv, params))
    for drv, mod in ((j_drv, jx), (t_drv, tx)):
        (prog,) = [p for p in drv._programs.values() if p is not None]
        spaces = {e.elem.space for e in _walk(prog.expr, mod)
                  if isinstance(e, mod.EGatherElem)}
        assert spaces == {("g01",)}
        assert drv.stats["interp_pairs"] == 0


@pytest.mark.parametrize("params", PARAMS, ids=lambda p: str(p)[:40])
def test_join_audit_equals_interpreter(params):
    """audit() over TorchDriver("cpu") equals the interpreter driver's,
    result for result, for every allowedHostPaths shape."""
    t_drv = TorchDriver(device="cpu")
    got = _audit(_client(TBackend, TTarget, t_drv, params))
    want = _audit(_client(TBackend, TTarget, TRegoDriver(), params))
    jwant = _audit(_client(JBackend, JTarget, JRegoDriver(), params))
    assert got == want == jwant
    assert len(want) > 0 or params == [{"pathPrefix": "/"}]
    assert t_drv.stats["interp_pairs"] == 0
    assert t_drv.stats["render_errors"] == 0


@pytest.mark.parametrize("params", [None, [], [{"pathPrefix": "/zzz"}]],
                         ids=str)
def test_join_audit_three_drivers_agree_without_prefix_match(params):
    """Where no allowed prefix matches a pod's path, the interpreter, the
    JAX TpuDriver and TorchDriver("cpu") give identical results."""
    got = _audit(_client(TBackend, TTarget, TorchDriver(device="cpu"), params))
    tpu = _audit(_client(JBackend, JTarget, TpuDriver(), params))
    rego = _audit(_client(JBackend, JTarget, JRegoDriver(), params))
    assert len(rego) > 10
    assert got == tpu == rego


@pytest.mark.parametrize("params", chip_smoke.JOIN_PARAMS,
                         ids=lambda p: str(p)[:40])
def test_jax_join_treats_every_path_as_unmatched(params):
    """Pins the JAX package's defect on this template exactly: its
    TpuDriver answers as the interpreter does for the same template with
    `path_matches` never true (the tableized `path_array` is undefined at
    every path), while the port answers as the interpreter does."""
    never = chip_smoke.hostfs_template()
    rego = never["spec"]["targets"][0]["rego"]
    never["spec"]["targets"][0]["rego"] = rego.replace(
        "path_matches(prefix, path) {\n",
        "path_matches(prefix, path) {\n    false\n",
    )
    tpu = _audit(_client(JBackend, JTarget, TpuDriver(), params))
    unmatched = _audit(_client(JBackend, JTarget, JRegoDriver(), params, never))
    rego_res = _audit(_client(JBackend, JTarget, JRegoDriver(), params))
    port = _audit(_client(TBackend, TTarget, TorchDriver(device="cpu"), params))
    assert tpu == unmatched
    assert port == rego_res
    assert tpu != rego_res  # every JOIN_PARAMS entry admits some volume


def test_single_review_of_join_equals_interpreter():
    pod = _hf_pod("solo", VOLS[4], CTRS[3])
    params = [{"pathPrefix": "/foo", "readOnly": True}]
    got = _client(TBackend, TTarget, TorchDriver(device="cpu"), params)
    want = _client(JBackend, JTarget, JRegoDriver(), params)
    from gatekeeper_tpu_torch.constraint import AugmentedUnstructured as TAug

    g = got.review_many([TAug(copy.deepcopy(pod))])[0]
    w = want.review(JAug(pod))
    assert [chip_smoke.result_key(r) for r in g.by_target[TARGET].results] == [
        chip_smoke.result_key(r) for r in w.by_target[TARGET].results
    ]
