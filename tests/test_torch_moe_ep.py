"""Expert parallelism in repro_torch: two gloo ranks on a ``("model",)``
axis against the port's own one-rank ``moe_apply`` on the same full tree
(fp32 compute, loss ``sum(y * w) + aux``).

* EP through the all-to-all on each of the ``a2a``, ``ring`` and ``psum``
  transports, a top-1 case with a shared expert and the replicated-psum
  fallback (a batch of 3 the axis does not divide): ``y``, the loss, the drop fraction, the gradient of ``x``, of the router
  and of this rank's block of each expert stack all **bitwise** the
  one-rank values.  The placement moves, the arithmetic does not: each
  expert's GEMMs keep their (B*C, d) shapes, a token's ``top_k <= 2``
  contributions sum into zeros in an order that cannot change the bits,
  and each rank-partial cotangent meets only zeros in the sum over ranks.
  TP in the expert splits each expert's contraction over ``f`` into two
  partial sums added by the all-reduce, which the one-rank GEMM sums in
  another order: there ``y`` is within 2e-6 and the gradients within
  rtol 1e-5 / atol 1e-6 (the largest differences seen on this CPU:
  2.4e-7 in ``y`` and in ``x``'s gradient, 1.4e-6 in the router's; the
  expert blocks' gradients bitwise).
* The EP communicator's record: 2 all-to-alls a forward and 2 a backward
  on ``a2a``, ``2 (p-1)`` sends on ``ring``, the matrix all-reduces on
  ``psum``; none on the fallback and under TP.
* Against the reference's own 2-device EP run on the ``a2a`` transport
  (``tests/conftest.py::run_distributed``, one subprocess beside the
  ranks) from the reference's parameters: within rtol 1e-5 / atol 1e-6.
  The reference's EP is not bitwise its one-device replica on this jaxlib
  (``test_distributed.py::test_moe_ep_bitwise_matches_dense_replica``
  fails by up to 1.19e-7), so bitwise is not asked of it.
"""

import os
import subprocess
import sys
import tempfile

import jax
import numpy as np
import pytest

import torch_moe_jobs as jobs
from conftest import SRC
from torch_dist_util import run_ranks
from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.models import moe as jax_moe

EP = dict(num_experts=4, top_k=2, expert_ff=32, capacity_factor=2.0,
          parallelism="ep")
CASES = {   # name: (MoEConfig kwargs, B, S, d, transport)
    "a2a": (EP, 4, 8, 16, "a2a"),
    "ring": (EP, 4, 8, 16, "ring"),
    "psum": (EP, 4, 8, 16, "psum"),
    "top1_shared": (dict(EP, top_k=1, shared_expert_ff=24), 4, 8, 16, "a2a"),
    "fallback": (EP, 3, 8, 16, "a2a"),
    "tp": (dict(EP, parallelism="tp"), 4, 8, 16, "a2a"),
}
REF = dict(kw=dict(num_experts=4, top_k=2, expert_ff=32,
                   capacity_factor=1.25, parallelism="ep"), b=4, s=16, d=16)

JAX_SCRIPT = r"""
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.configs.base import MoEConfig
from repro.models import moe as moe_mod
from repro.runtime.train_step import TrainStepConfig, make_ctx

ref = {ref!r}
cfg = MoEConfig(**ref["kw"])
inputs = dict(np.load({inputs!r}))
x, w = jnp.asarray(inputs["x"]), jnp.asarray(inputs["w"])
p = moe_mod.moe_init(jax.random.key(5), cfg, ref["d"])
mesh = compat.make_mesh((2,), ("model",))
ctx = make_ctx(mesh, TrainStepConfig(moe_transport="a2a"))
pspecs = {{"router": {{"w": P()}}, "w_gate": P("model"), "w_up": P("model"),
          "w_down": P("model")}}


def loss(pp, xx):
    y, aux, drop = moe_mod.moe_apply(pp, xx, cfg, "silu", ctx=ctx,
                                     compute_dtype=jnp.float32)
    return jnp.sum(y * w) + aux, (y, drop)


def sharded(pp, xx):
    (l, (y, drop)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(pp, xx)
    return l, y, drop, gp, gx


fn = jax.jit(compat.shard_map(
    sharded, mesh=mesh, in_specs=(pspecs, P()),
    out_specs=(P(), P(), P(), pspecs, P()), check_vma=False))
l, y, drop, gp, gx = fn(p, x)
out = {{"loss": np.asarray(l), "y": np.asarray(y), "drop": np.asarray(drop),
        "gx": np.asarray(gx), "router": np.asarray(gp["router"]["w"])}}
for k in ("w_gate", "w_up", "w_down"):
    out[k] = np.asarray(gp[k])
np.savez({path!r}, **out)
print("EP_REF_OK")
"""


@pytest.fixture(scope="module")
def run():
    cfg = JaxMoEConfig(**REF["kw"])
    params = jax.tree.map(np.asarray, jax_moe.moe_init(
        jax.random.key(5), cfg, REF["d"]))
    rs = np.random.RandomState(11)
    inputs = {"x": rs.randn(REF["b"], REF["s"], REF["d"]).astype(np.float32),
              "w": rs.randn(REF["b"], REF["s"], REF["d"]).astype(np.float32)}
    with tempfile.TemporaryDirectory() as tmp:
        ipath = os.path.join(tmp, "inputs.npz")
        np.savez(ipath, **inputs)
        path = os.path.join(tmp, "ref.npz")
        env = dict(os.environ)
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
        env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
        proc = subprocess.Popen(
            [sys.executable, "-c", JAX_SCRIPT.format(
                ref=REF, inputs=ipath, path=path)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            ranks = run_ranks(jobs.ep_job, 2, CASES, params,
                              dict(inputs, kw=REF["kw"]))
        finally:
            stdout, stderr = proc.communicate(timeout=560)
        assert "EP_REF_OK" in stdout, stderr[-4000:]
        with np.load(path) as f:
            ref = dict(f)
    return {"ranks": ranks, "ref": ref}


def _blocks(full, rank, kw):
    """This rank's block of each expert-stack gradient."""
    out = {}
    if kw.get("parallelism") == "ep":
        el = kw["num_experts"] // 2
        for n in ("w_gate", "w_up", "w_down"):
            out[n] = full[n][rank * el:(rank + 1) * el]
    else:
        fl = kw["expert_ff"] // 2
        for n, dim in (("w_gate", 2), ("w_up", 2), ("w_down", 1)):
            out[n] = np.take(full[n], np.arange(rank * fl, (rank + 1) * fl),
                             axis=dim)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_ep_equals_the_one_rank_moe(run, case):
    kw = CASES[case][0]
    exact = case != "tp"
    check = (np.testing.assert_array_equal if exact else
             lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-5,
                                                     atol=1e-6))
    for r, out in enumerate(run["ranks"]):
        one, ep = out[case]["one"], out[case]["ep"]
        if exact:
            np.testing.assert_array_equal(ep["y"], one["y"])
            assert ep["loss"] == one["loss"]
        else:
            np.testing.assert_allclose(ep["y"], one["y"], rtol=0, atol=2e-6)
            np.testing.assert_allclose(ep["loss"], one["loss"], rtol=1e-6)
        assert ep["drop"] == one["drop"]
        check(ep["gx"], one["gx"])
        check(ep["grads"]["router"]["w"], one["grads"]["router"]["w"])
        for n, blk in _blocks(one["grads"], r, kw).items():
            check(ep["grads"][n], blk)
        if "shared" in one["grads"]:
            for n in ("w_gate", "w_up", "w_down"):
                check(ep["grads"]["shared"][n]["w"],
                      one["grads"]["shared"][n]["w"])


@pytest.mark.parametrize("case", list(CASES))
def test_ep_traffic_is_the_codes(run, case):
    transport, b = CASES[case][4], CASES[case][1]
    kw = CASES[case][0]
    routed = kw["parallelism"] == "ep" and b % 2 == 0
    for out in run["ranks"]:
        rec = out[case]["record"]
        calls = 4 if routed else 0        # dispatch + combine, both ways
        if transport == "a2a":
            assert rec["all_to_alls"] == calls
        elif transport == "ring":
            assert rec["sends"] == calls      # p - 1 = 1 hop a call
        else:
            assert rec["all_reduces"] == calls
        others = {k: v for k, v in rec.items() if k != "staging_s" and
                  k not in ("all_to_alls", "all_to_all_bytes", "sends",
                            "send_bytes", "all_reduces", "all_reduce_bytes")}
        assert not any(others.values()), others


def test_ep_follows_the_reference_two_device_run(run):
    ref = run["ref"]
    for r, out in enumerate(run["ranks"]):
        ep = out["reference"]["ep"]
        tol = dict(rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ep["y"], ref["y"], **tol)
        np.testing.assert_allclose(ep["loss"], float(ref["loss"]), **tol)
        assert ep["drop"] == float(ref["drop"])
        np.testing.assert_allclose(ep["gx"], ref["gx"], **tol)
        np.testing.assert_allclose(ep["grads"]["router"]["w"], ref["router"],
                                   **tol)
        for n, blk in _blocks(ref, r, REF["kw"]).items():
            np.testing.assert_allclose(ep["grads"][n], blk, **tol)
