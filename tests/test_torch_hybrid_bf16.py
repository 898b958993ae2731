"""hymba-1.5b's bf16 prefill against its fp32 prefill, in both packages.

At full width on the card the port's bf16 prefill is 7.1 % (relative L2)
from its fp32 prefill, against 1.2 % for llama (``PERF.md`` §7).  This
holds the port's bf16-to-fp32 error to at most 1.25x the reference's on
the same bridged weights and tokens (reduced hymba-1.5b: 2 layers, a
global and a windowed one, S = 64 past the window of 32), on both
attention routes of ``build_prefill``: the bf16 error is the family's own,
not the port's.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from repro.configs import reduced_config as jax_reduced_config
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticTokens as JaxSyntheticTokens
from repro.models import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.models import build_model
from repro_torch.runtime.serve_step import build_prefill

ARCH, B, S = "hymba-1.5b", 2, 64
RATIO = 1.25


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def logits():
    jparams = jax_build_model(jax_reduced_config(ARCH)).init(
        jax.random.PRNGKey(0))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      "cpu")
    out = {}
    for dtype in ("float32", "bfloat16"):
        jmodel = jax_build_model(jax_reduced_config(ARCH).with_(dtype=dtype))
        model = build_model(reduced_config(ARCH).with_(dtype=dtype))
        kw = dict(vocab_size=model.cfg.vocab_size, seq_len=S, global_batch=B,
                  seed=1)
        jbatch = JaxSyntheticTokens(JaxDataConfig(**kw),
                                    jmodel.cfg).batch_at(0)
        batch = SyntheticTokens(DataConfig(**kw), model.cfg).batch_at(0)
        np.testing.assert_array_equal(np.asarray(jbatch["tokens"]),
                                      batch["tokens"].numpy())
        out[("reference", dtype)] = np.asarray(
            jax.jit(lambda p: jmodel.forward(p, jbatch))(jparams),
            np.float32)
        for impl in ("kernel", "blockwise"):
            out[(impl, dtype)] = build_prefill(
                model, ShapeConfig("prefill", S, B, "prefill"),
                attn_impl=impl, device="cpu")(params, batch).float().numpy()
    return out


@pytest.mark.parametrize("impl", ["kernel", "blockwise"])
def test_bf16_prefill_error_is_the_references(logits, impl):
    ref_err = _rel(logits[("reference", "bfloat16")],
                   logits[("reference", "float32")])
    err = _rel(logits[(impl, "bfloat16")], logits[(impl, "float32")])
    assert ref_err > 0
    assert err <= RATIO * ref_err, (impl, err, ref_err)
    # and the fp32 prefills agree, as tests/test_torch_families_serve.py
    # holds them
    np.testing.assert_allclose(logits[(impl, "float32")],
                               logits[("reference", "float32")], rtol=1e-5,
                               atol=1e-5)


if __name__ == "__main__":
    # prints each route's bf16-to-fp32 relative L2 error beside the
    # reference's: PYTHONPATH=src python tests/test_torch_hybrid_bf16.py
    out = logits.__wrapped__()
    for name in ("reference", "kernel", "blockwise"):
        print(name, _rel(out[(name, "bfloat16")], out[(name, "float32")]))
