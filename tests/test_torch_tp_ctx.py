"""repro_torch.models.parallel's model-axis collectives on 4 gloo ranks.

A (2, 2) ``("data", "model")`` mesh: rank ``r`` sits at data ``r // 2``,
model ``r % 2``, and its model group is the two ranks of its data row.
Each collective's forward and gradient against its closed form, with
inputs that differ by rank:

* ``psum``: the group's sum forward, the rank's own cotangent backward
  (the reference's identity-backward ``_psum_id_bwd``);
* ``fan_out``: the identity forward, the group's sum of cotangents
  backward (``_psum_grad``);
* ``gather_replicated``: the group's blocks in model order forward, this
  rank's rows of the cotangent backward (``_gather_id_bwd``);
* ``sum_grads_over_model``: the identity on every leaf, the group's sum of
  each leaf's cotangent backward;
* ``pmax``, ``model_index``, ``model_size`` and what the model ring
  recorded (5 all-reduces: psum, fan_out's backward, the two leaves'
  backward, pmax; 1 all-gather).  ``ParallelCtx()`` is the identity.
"""

import numpy as np
import pytest
import torch

import torch_tp_jobs as jobs
from torch_dist_util import run_ranks
from repro_torch.models.parallel import SINGLE, sum_grads_over_model


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(jobs.ctx_job, 4)


def _group(r):
    return [2 * (r // 2), 2 * (r // 2) + 1]


BASE = np.arange(6, dtype=np.float32).reshape(2, 3)


def _c(r):
    return (r + 1.0) * np.ones((2, 3), np.float32) + BASE


@pytest.mark.parametrize("r", range(4))
def test_psum_and_fan_out(ranks, r):
    out = ranks[r]
    assert out["model_index"] == r % 2 and out["model_size"] == 2
    assert out["model_ranks"] == _group(r)
    y, g = out["psum"]
    np.testing.assert_array_equal(y, sum(BASE + 10 * q for q in _group(r)))
    np.testing.assert_array_equal(g, _c(r))
    y, g = out["fan_out"]
    np.testing.assert_array_equal(y, BASE + 10 * r)
    np.testing.assert_array_equal(g, sum(_c(q) for q in _group(r)))


@pytest.mark.parametrize("r", range(4))
def test_gather_sum_grads_and_pmax(ranks, r):
    out = ranks[r]
    y, g = out["gather"]
    np.testing.assert_array_equal(
        y, np.concatenate([BASE + 10 * q for q in _group(r)]))
    i = r % 2
    cg = np.arange(12, dtype=np.float32).reshape(4, 3) * (r + 1)
    np.testing.assert_array_equal(g, cg[2 * i:2 * i + 2])
    y, g = out["sum_grads"]
    np.testing.assert_array_equal(y, BASE * (r + 1))
    np.testing.assert_array_equal(g, 3 * sum(_c(q) for q in _group(r)))
    grp = _group(r)
    np.testing.assert_array_equal(out["pmax"], [max(grp), -min(grp)])
    rec = out["record"]
    assert (rec["all_reduces"], rec["all_gathers"]) == (5, 1)


def test_single_context_is_the_identity():
    x = torch.randn(3, 4, requires_grad=True)
    for fn in (SINGLE.psum, SINGLE.fan_out, SINGLE.pmax,
               SINGLE.gather_replicated):
        assert fn(x) is x
    tree = {"w": x}
    assert sum_grads_over_model(tree, SINGLE) is tree
    assert (SINGLE.model_size(), SINGLE.model_index()) == (1, 0)
