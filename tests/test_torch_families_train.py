"""Every one of the ten archs trains in repro_torch in reduced form, held
against the JAX reference on the CPU.

* Loss and gradients at fp32 compute from bridged parameters, on the
  reference's synthetic batch for the arch (the stub inputs included):
  the loss within rtol 1e-5 and every gradient leaf within rtol / atol
  1e-4, the method and bounds of ``test_torch_train.py``.  A pure-SSM
  stack's unused ``ln2`` gets a zero gradient on both sides.
* The train CLI runs each new family two steps (falcon-mamba-7b
  replicated and hymba-1.5b in zero1, both with the arena on,
  llava-next-34b in fsdp with its patch embeddings, whisper-base in zero1
  with the arena and its frames), and whisper-base resumes from its
  checkpoint.
* The bridge and the checkpoint take the new trees: a round trip of each
  new family's reference parameters is bitwise, and the port's step
  directory of them is byte-identical to ``repro.checkpoint.save``'s.
"""

import filecmp
import os

import jax
import numpy as np
import pytest
import torch

import repro.checkpoint as ref_ckpt
from repro.configs import list_archs as jax_list_archs
from repro.configs import reduced_config as jax_reduced_config
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticTokens as JaxSyntheticTokens
from repro.models import build_model as jax_build_model
from repro_torch import bridge
from repro_torch import tree as tree_util
from repro_torch.checkpoint import restore, save
from repro_torch.configs import list_archs, reduced_config
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model

ARCHS = list_archs()
NEW = ("falcon-mamba-7b", "hymba-1.5b", "llava-next-34b", "whisper-base")


def test_every_arch_is_covered():
    assert len(ARCHS) == 10 and ARCHS == sorted(jax_list_archs())


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference_at_fp32(arch):
    jmodel = jax_build_model(jax_reduced_config(arch))
    jparams = jmodel.init(jax.random.PRNGKey(1))
    model = build_model(reduced_config(arch))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      "cpu")
    kw = dict(vocab_size=jmodel.cfg.vocab_size, seq_len=32, global_batch=2)
    jbatch = JaxSyntheticTokens(JaxDataConfig(**kw), jmodel.cfg).batch_at(0)
    batch = SyntheticTokens(DataConfig(**kw), model.cfg).batch_at(0)
    assert sorted(batch) == sorted(jbatch)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jbatch)))(jparams)
    leaves, treedef = tree_util.flatten(params)
    leaves = [p.requires_grad_(True) for p in leaves]
    loss = model.loss_fn(treedef.unflatten(leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(grads)
    unused = [i for i, g in enumerate(grads) if g is None]
    if model.cfg.family == "ssm":      # ln2 of every block, and only it
        assert len(unused) == model.cfg.num_layers
    else:
        assert unused == []
    for i, (g, jg) in enumerate(zip(grads, jleaves)):
        g = torch.zeros_like(leaves[i]) if g is None else g
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-4, err_msg=f"leaf {i}")


@pytest.mark.parametrize("arch,extra", [
    ("falcon-mamba-7b", ["--use-arena"]),
    ("hymba-1.5b", ["--use-arena", "--dp-mode", "zero1"]),
    ("llava-next-34b", ["--dp-mode", "fsdp"]),
    ("whisper-base", ["--dp-mode", "zero1", "--use-arena"])])
def test_train_cli_trains_each_new_family(arch, extra, capsys):
    threads = torch.get_num_threads()
    try:
        launch_train.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--steps", "2", "--seq", "32", "--batch", "2",
                           *extra])
    finally:
        torch.set_num_threads(threads)      # the CLI sizes the thread pool
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "[train] step     1" in out
    losses = [float(line.split("loss ")[1].split()[0])
              for line in out.splitlines() if line.startswith("[train]")]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_train_cli_resumes_whisper_from_its_checkpoint(tmp_path, capsys):
    threads = torch.get_num_threads()
    argv = ["--arch", "whisper-base", "--reduced", "--device", "cpu",
            "--seq", "16", "--batch", "2", "--ckpt-dir", str(tmp_path)]
    try:
        launch_train.main(argv + ["--steps", "1"])
        launch_train.main(argv + ["--steps", "2"])
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert "[trainer] resumed from step 1" in out
    assert sorted(os.listdir(tmp_path)) == ["step_00000001",
                                            "step_00000002"]


@pytest.mark.parametrize("arch", NEW)
def test_bridge_and_checkpoint_take_the_new_trees(arch, tmp_path):
    jparams = jax.tree.map(np.asarray, jax_build_model(
        jax_reduced_config(arch)).init(jax.random.PRNGKey(3)))
    params = bridge.params_from_numpy(jparams, "cpu")
    back = bridge.params_to_numpy(params)
    flat, ref_flat = (jax.tree_util.tree_flatten_with_path(t)[0]
                      for t in (back, jparams))
    assert [p for p, _ in flat] == [p for p, _ in ref_flat]
    for (_, a), (_, b) in zip(flat, ref_flat):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    tree = {"params": jparams, "step": np.asarray(3, np.int32)}
    ref_dir = ref_ckpt.save(tree, 3, str(tmp_path / "ref"))
    port_dir = save({"params": params, "step": 3}, 3, str(tmp_path / "port"))
    names = sorted(os.listdir(ref_dir))
    assert names == sorted(os.listdir(port_dir))
    for n in names:
        assert filecmp.cmp(os.path.join(ref_dir, n),
                           os.path.join(port_dir, n), shallow=False), n
    like = {"params": tree_util.tree_map(torch.zeros_like, params),
            "step": 0}
    got = restore(like, 3, str(tmp_path / "ref"))
    for a, b in zip(tree_util.leaves(got["params"]),
                    tree_util.leaves(params)):
        assert torch.equal(a, b)
