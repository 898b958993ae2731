"""Families the port does not model yet are refused, never run as
something else.

The reference's vision-stub arch (llava-next-34b) draws patch embeddings,
prepends them to the token embeddings and shortens the text
(``repro.data.synthetic``, ``repro.models.transformer.forward``); the
port has no stub inputs yet, so it must refuse the arch rather than train a
text-only model under its name.  Encoder-decoder and audio-stub archs
(whisper-base) are refused the same way.
"""

import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model


@pytest.mark.parametrize("arch,what", [
    ("llava-next-34b", "vision stub"), ("whisper-base", "encoder-decoder")])
@pytest.mark.parametrize("reduced", [True, False])
def test_build_model_refuses_unported_families(arch, what, reduced):
    cfg = reduced_config(arch) if reduced else get_config(arch)
    with pytest.raises(NotImplementedError,
                       match=f"{what}.*remaining-families slice"):
        build_model(cfg)


@pytest.mark.parametrize("arch,what", [
    ("llava-next-34b", "vision stub"), ("whisper-base", "encoder-decoder")])
def test_train_cli_refuses_unported_families(arch, what):
    threads = torch.get_num_threads()
    try:
        with pytest.raises(NotImplementedError, match=what):
            launch_train.main(["--arch", arch, "--reduced", "--device", "cpu",
                               "--steps", "1", "--seq", "32", "--batch", "2"])
    finally:
        torch.set_num_threads(threads)      # the CLI sizes the thread pool
