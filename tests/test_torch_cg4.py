"""repro_torch's CG family on 4 gloo ranks (mesh ``(2, 2)``) against the
JAX reference's ``shard_map`` run on 4 fake devices (one subprocess): the
six solver x precond combinations at 16 unrolled iterations, ``x`` and
``history`` within 1e-4 relative on the psum and on the ring_hier
transport.  At 4 ranks the two transports add the four partial dots in
different orders (gloo's all-reduce and the hierarchical ring), so they
are held to the same tolerance, as the reference holds its own two
(``tests/test_solvers.py``).  Split from ``test_torch_cg.py`` to keep each
file's subprocess under a minute.
"""

import os
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from conftest import run_distributed
from torch_dist_util import run_ranks
import torch_stencil_jobs as jobs

CG_RTOL = 1e-4


@pytest.fixture(scope="module")
def runs():
    """The reference's run (a JAX subprocess, in a thread) and the port's
    4 ranks, side by side."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cg.npz")
        script = jobs.CG_REF_SCRIPT.format(tests=os.path.dirname(__file__),
                                           path=path, worlds=(4,))
        with ThreadPoolExecutor(1) as pool:
            ref = pool.submit(run_distributed, script, n_devices=4)
            ranks = run_ranks(jobs.solver_job, 4)
            assert "CG_REF_OK" in ref.result()
        with np.load(path) as f:
            return dict(f), ranks


# largest relative differences seen on the CPU (x, history), torch 2.13,
# jax 0.9.0: psum 2.5e-7 and 9.2e-9, ring_hier 3.0e-7 and 1.8e-8
@pytest.mark.parametrize("transport", ["psum", "ring_hier"])
def test_solver_family_matches_the_reference_on_four_ranks(runs,
                                                           transport):
    jobs.check_family(*runs, 4, CG_RTOL, transport)
