"""The families the port once refused build and train; what both packages
still refuse stays refused.

The vision-stub arch (llava-next-34b) prepends its patch embeddings to the
token embeddings and shortens the text; the encoder-decoder / audio-stub
arch (whisper-base) encodes its frames.  Both build at reduced and full
size with the reference's parameter count, and the train CLI trains them.

Refused in both packages, at build time:

* gathered-weight serving of every family but dense and MoE (the SSM,
  hybrid, encoder-decoder and stub archs): ``_require_decoder_only``;
* the paged engine of the same archs: ``plan_kv_arena``;
* ``fsdp`` on an encoder-decoder: the reference's ``Model.loss_fn``
  refuses the block resolver, the port's ``FsdpPlan`` the model, and so the
  train CLI's ``--dp-mode fsdp``.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro.runtime import serve_step as jax_serve_step
from repro.serve import plan_kv_arena as jax_plan_kv_arena
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.topology import RankMesh
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.runtime.serve_step import build_decode_step, build_prefill
from repro_torch.runtime.train_step import TrainStep, TrainStepConfig
from repro_torch.serve import plan_kv_arena

UNPAGED = ("falcon-mamba-7b", "hymba-1.5b", "whisper-base", "llava-next-34b")


@pytest.mark.parametrize("arch,what", [
    ("llava-next-34b", "vision stub"), ("whisper-base", "encoder-decoder")])
@pytest.mark.parametrize("reduced", [True, False])
def test_build_model_refuses_unported_families(arch, what, reduced):
    """Since the remaining families were ported: the model builds, its
    parameter tree has the reference's element count, and an
    encoder-decoder dispatches to ``models.encdec``."""
    cfg = reduced_config(arch) if reduced else get_config(arch)
    jcfg = jax_reduced_config(arch) if reduced else jax_get_config(arch)
    model = build_model(cfg)
    assert model.param_count() == jax_build_model(jcfg).param_count()
    assert model.is_encdec == (what == "encoder-decoder")
    tree = model.abstract_params()
    assert ("enc_blocks" in tree) == (what == "encoder-decoder")


@pytest.mark.parametrize("arch,what", [
    ("llava-next-34b", "vision stub"), ("whisper-base", "encoder-decoder")])
def test_train_cli_refuses_unported_families(arch, what, capsys):
    """Since the remaining families were ported: the train CLI trains the
    arch one step to its end, with the stub's inputs."""
    threads = torch.get_num_threads()
    try:
        launch_train.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--steps", "1", "--seq", "32", "--batch", "2"])
    finally:
        torch.set_num_threads(threads)      # the CLI sizes the thread pool
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "[train] step     0" in out


@pytest.mark.parametrize("arch", UNPAGED)
def test_gathered_serving_stays_refused_in_both_packages(arch):
    model = build_model(reduced_config(arch))
    shape = ShapeConfig("serve", 16, 2, "decode")
    for build in (build_prefill, build_decode_step):
        with pytest.raises(NotImplementedError, match="decoder-only"):
            build(model, shape, weight_mode="gathered", device="cpu")
    with pytest.raises(NotImplementedError, match="decoder-only"):
        jax_serve_step._require_decoder_only(jax_reduced_config(arch),
                                             "decode")


@pytest.mark.parametrize("arch", UNPAGED)
def test_paged_engine_stays_refused_in_both_packages(arch):
    kw = dict(page_tokens=8, page_bytes=4096, max_seqs=2, max_seq_len=32)
    with pytest.raises(NotImplementedError, match="decoder-only"):
        plan_kv_arena(build_model(reduced_config(arch)).cfg, **kw)
    with pytest.raises(NotImplementedError, match="decoder-only"):
        jax_plan_kv_arena(jax_build_model(jax_reduced_config(arch)).cfg,
                          **kw)


def test_fsdp_on_an_encoder_decoder_stays_refused_in_both_packages():
    model = build_model(reduced_config("whisper-base"))
    with pytest.raises(NotImplementedError, match="decoder-only"):
        TrainStep(model, RankMesh(("data",), (1,)),
                  TrainStepConfig(dp_mode="fsdp"), device=torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="decoder-only"):
        launch_train.main(["--arch", "whisper-base", "--reduced", "--device",
                           "cpu", "--steps", "1", "--seq", "16", "--batch",
                           "2", "--dp-mode", "fsdp"])
    jmodel = jax_build_model(jax_reduced_config("whisper-base"))
    params = jmodel.abstract_params()
    batch = {k: jax.ShapeDtypeStruct(v, d) for k, v, d in (
        ("frames", (2, 16, 64), jnp.float32), ("tokens", (2, 8), jnp.int32),
        ("labels", (2, 8), jnp.int32))}
    with pytest.raises(NotImplementedError, match="decoder-only"):
        jax.eval_shape(lambda p, b: jmodel.loss_fn(
            p, b, block_resolver=lambda kind, i, raw: raw), params, batch)
