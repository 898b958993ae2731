"""repro_torch checkpoints: the reference's on-disk format, held against
``repro.checkpoint``.

* Format (mirroring ``tests/test_substrate.py``'s checkpoint tests): round
  trip into a ``meta``-device template, corruption caught by the sha256,
  an uncommitted directory ignored, keep-N GC with async saves, the async
  thread's error raised at the next ``wait()``, the host copy taken before
  the thread starts.
* Byte identity: the same numpy tree (fp32, an int32 scalar ``step``,
  int8, bf16, lists inside dicts, a tuple) through ``repro.checkpoint.save``
  and the port's ``save`` gives byte-identical step directories, every file
  and ``meta.msgpack`` included; so does the port's tensor tree of the same
  values (its ``step`` a Python ``int``).  The port's msgpack codec equals
  ``msgpack.packb`` and decodes what it encodes.
* The reference's restore reads the port's files, and the port's restore
  reads the reference's, bf16 included bit for bit on the port's side (the
  reference's own restore cannot cast a bf16 file: ROADMAP Queue 3).
* ``restore(strict=False)`` carries a port train state across a
  ``use_arena`` toggle and a wire-codec toggle (as ``tests/test_mem.py``
  and ``tests/test_quant_wire.py`` do for the reference), and the Trainer
  retries by path, loudly.
* The arena a step returns holds what the reference's holds with two
  microbatches: the reduced mean after an all-reduce.
"""

import filecmp
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.checkpoint as ref_ckpt
from repro_torch import tree as tree_util
from repro_torch.checkpoint import (CheckpointManager, latest_step, restore,
                                    save)
from repro_torch.checkpoint import _msgpack
from repro_torch.checkpoint.ckpt import flatten_with_path, read_meta
from repro_torch.comm import CommConfig
from repro_torch.configs import reduced_config
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.models import build_model
from repro_torch.runtime.train_loop import Trainer, TrainerConfig
from repro_torch.runtime.train_step import (TrainStep, TrainStepConfig,
                                            data_mesh, init_train_state,
                                            shard_batch)

CPU = torch.device("cpu")


def _state(rng):
    return {"params": {"w": torch.from_numpy(
        rng.randn(8, 8).astype(np.float32))}, "step": 7}


def _meta_like(tree):
    return tree_util.tree_map(
        lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta")
        if isinstance(x, torch.Tensor) else x, tree)


def test_checkpoint_roundtrip(tmp_path, rng):
    st_ = _state(rng)
    save(st_, 7, str(tmp_path))
    assert latest_step(str(tmp_path)) == 7
    back = restore(_meta_like(st_), 7, str(tmp_path))
    assert torch.equal(back["params"]["w"], st_["params"]["w"])
    assert back["params"]["w"].device == CPU
    assert back["step"] == 7 and isinstance(back["step"], int)


def test_checkpoint_detects_corruption(tmp_path, rng):
    st_ = _state(rng)
    d = save(st_, 1, str(tmp_path))
    target = os.path.join(d, "arr_00000.npy")
    raw = bytearray(open(target, "rb").read())
    raw[-1] ^= 0xFF
    open(target, "wb").write(raw)
    with pytest.raises(IOError, match="checksum"):
        restore(_meta_like(st_), 1, str(tmp_path))


def test_checkpoint_uncommitted_ignored(tmp_path, rng):
    save(_state(rng), 5, str(tmp_path))
    os.makedirs(tmp_path / "step_00000009")
    assert latest_step(str(tmp_path)) == 5


def test_checkpoint_manager_gc_and_async(tmp_path, rng):
    mgr = CheckpointManager(str(tmp_path), keep_n=2, async_save=True)
    st_ = _state(rng)
    for s in [1, 2, 3, 4]:
        mgr.save(st_, s)
    mgr.wait()
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path)
                   if n.startswith("step_"))
    assert steps == [3, 4]
    back, step = mgr.restore_latest(_meta_like(st_))
    assert step == 4 and torch.equal(back["params"]["w"], st_["params"]["w"])


def test_async_save_copies_before_the_thread_and_raises_at_wait(tmp_path):
    """The host copy is taken in ``save``: an in-place update right after
    it does not reach the file.  An error of the thread is raised by the
    next ``wait()``, once."""
    mgr = CheckpointManager(str(tmp_path / "ok"), async_save=True)
    arena = torch.arange(6, dtype=torch.float32)
    mgr.save({"arena": arena, "step": 1}, 1)
    arena.add_(100.0)                     # the next step's in-place write
    mgr.wait()
    back = restore({"arena": torch.zeros(6), "step": 0}, 1,
                   str(tmp_path / "ok"))
    assert torch.equal(back["arena"], torch.arange(6, dtype=torch.float32))

    blocked = tmp_path / "file"
    blocked.write_text("not a directory")
    bad = CheckpointManager(str(blocked), async_save=True)
    bad.save({"x": torch.ones(2)}, 1)
    with pytest.raises(OSError):
        bad.wait()
    bad.wait()                            # raised once


def test_missing_leaf_with_abstract_template_raises(tmp_path):
    save({"a": torch.ones(3)}, 1, str(tmp_path))
    like = {"a": torch.empty(3, device="meta"),
            "b": torch.empty(2, device="meta")}
    with pytest.raises(ValueError, match="strict=False"):
        restore(like, 1, str(tmp_path))
    with pytest.raises(ValueError, match="abstract"):
        restore(like, 1, str(tmp_path), strict=False)
    kept = restore({"a": torch.zeros(3), "b": torch.full((2,), 5.0)}, 1,
                   str(tmp_path), strict=False)
    assert torch.equal(kept["a"], torch.ones(3))
    assert torch.equal(kept["b"], torch.full((2,), 5.0))
    with pytest.raises(ValueError, match="shape mismatch"):
        restore({"a": torch.zeros(4)}, 1, str(tmp_path))


# ---------------------------------------------------------------------------
# byte identity with the reference
# ---------------------------------------------------------------------------


def _numpy_tree():
    rng = np.random.RandomState(3)
    return {
        "params": {"w": rng.randn(5, 7).astype(np.float32),
                   "blocks": [{"q": rng.randn(3).astype(np.float32)},
                              {"q": rng.randn(3).astype(np.float32)}]},
        "opt": {"mu": [rng.randn(11).astype(np.float32),
                       rng.randn(2).astype(np.float32)],
                "nu": [rng.rand(11).astype(np.float32),
                       rng.rand(2).astype(np.float32)]},
        "arena": rng.randint(-127, 128, 40).astype(np.int8),
        "half": (rng.randn(3, 4) * 100).astype(ml_dtypes.bfloat16),
        "pair": (np.arange(3, dtype=np.float32), np.zeros((0,), np.float32)),
        "step": np.asarray(12, np.int32),
    }


def _torch_tree(tree):
    def conv(a):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())

    out = tree_util.tree_map(conv, {k: v for k, v in tree.items()
                                    if k != "step"})
    out["step"] = int(tree["step"])
    return out


def _same_dirs(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for n in names:
        assert filecmp.cmp(os.path.join(a, n), os.path.join(b, n),
                           shallow=False), n
    return names


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_step_directory_is_byte_identical_to_the_reference(tmp_path, kind):
    tree = _numpy_tree()
    ref_dir = ref_ckpt.save(tree, 12, str(tmp_path / "ref"))
    mine = tree if kind == "numpy" else _torch_tree(tree)
    port_dir = save(mine, 12, str(tmp_path / "port"))
    names = _same_dirs(ref_dir, port_dir)
    assert "meta.msgpack" in names and "COMMITTED" in names
    meta = read_meta(str(tmp_path / "port"), 12)
    paths = [rec["path"] for rec in meta["leaves"]]
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    assert paths == [jax.tree_util.keystr(p) for p, _ in flat]
    assert meta["treedef"] == str(treedef)
    assert [rec["dtype"] for rec in meta["leaves"]].count("bfloat16") == 1
    step_rec = meta["leaves"][paths.index("['step']")]
    assert step_rec["dtype"] == "int32" and step_rec["shape"] == []


def test_flatten_with_path_matches_jax():
    tree = {"b": [1, (2,), {"z": 3, "a": None}], "a": {"x'y": 4},
            "c": (5, 6), "d": [], "e": {}}
    flat, treedef = flatten_with_path(tree)
    jflat, jdef = jax.tree_util.tree_flatten_with_path(tree)
    assert [p for p, _ in flat] == [jax.tree_util.keystr(p) for p, _ in jflat]
    assert [v for _, v in flat] == [v for _, v in jflat]
    assert treedef == str(jdef)


def test_each_package_restores_the_others_files(tmp_path):
    tree = _numpy_tree()
    save(_torch_tree(tree), 12, str(tmp_path / "port"))
    ref_ckpt.save(tree, 12, str(tmp_path / "ref"))
    no_bf16 = {k: v for k, v in tree.items() if k != "half"}
    # the reference reads the port's files (its restore cannot cast a bf16
    # file, ROADMAP Queue 3: that leaf is left out of its template)
    got = ref_ckpt.restore(jax.eval_shape(lambda: jax.tree.map(
        jnp.asarray, no_bf16)), 12, str(tmp_path / "port"), strict=False)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(no_bf16)):
        np.testing.assert_array_equal(np.asarray(a), b)
    # the port reads the reference's, bf16 bit for bit
    like = _meta_like(_torch_tree(tree))
    back = restore(like, 12, str(tmp_path / "ref"))
    want = _torch_tree(tree)
    for a, b in zip(tree_util.leaves(back), tree_util.leaves(want)):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(
                a.view(torch.uint8) if a.numel() else a,
                b.view(torch.uint8) if b.numel() else b)
        else:
            assert a == b
    # a numpy template gets numpy arrays back, bf16 included
    nback = restore(tree, 12, str(tmp_path / "port"))
    assert nback["half"].dtype == tree["half"].dtype
    np.testing.assert_array_equal(nback["half"].view(np.int16),
                                  tree["half"].view(np.int16))


MSGPACK_VALUES = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
                  2**64 - 1, -1, -32, -33, -128, -129, -2**15 - 1, -2**31,
                  -2**31 - 1, -2**63, 1.5, -0.0, float("inf"), True, False,
                  None, "", "a" * 31, "a" * 32, "b" * 255, "c" * 256,
                  "d" * 70000, "é['x']", list(range(15)), list(range(16)),
                  list(range(70000)), (1, "two"), {},
                  {str(i): i for i in range(16)}]


@pytest.mark.parametrize("value", MSGPACK_VALUES,
                         ids=[f"v{i}" for i in range(len(MSGPACK_VALUES))])
def test_msgpack_codec_equals_msgpack(value):
    raw = _msgpack.packb(value)
    assert raw == msgpack.packb(value)
    want = msgpack.unpackb(raw)
    assert _msgpack.unpackb(raw) == want


_meta_values = st.recursive(
    st.none() | st.booleans() | st.integers(-2**63, 2**64 - 1)
    | st.floats(allow_nan=False) | st.text(max_size=40),
    lambda kids: st.lists(kids, max_size=20)
    | st.dictionaries(st.text(max_size=10), kids, max_size=20),
    max_leaves=40)


@settings(max_examples=200, deadline=None)
@given(_meta_values)
def test_msgpack_codec_property(value):
    raw = _msgpack.packb(value)
    assert raw == msgpack.packb(value)
    assert _msgpack.unpackb(raw) == value


def test_msgpack_codec_refuses_what_meta_never_holds():
    with pytest.raises(TypeError):
        _msgpack.packb(b"bytes")
    with pytest.raises(TypeError):
        _msgpack.packb({1: 2})
    with pytest.raises(ValueError):
        _msgpack.unpackb(msgpack.packb(b"x"))
    with pytest.raises(ValueError):
        _msgpack.unpackb(msgpack.packb([1, 2])[:-1])


# ---------------------------------------------------------------------------
# strict=False across use_arena and wire-codec toggles (one rank, CPU)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    return build_model(reduced_config("llama3.2-1b"))


def _cfg(use_arena, codec=None, transport="ring_hier", microbatches=1):
    return TrainStepConfig(
        dp_mode="replicated",
        comm=CommConfig(transport=transport, bucket_bytes=1 << 20,
                        page_bytes=1 << 12, wire_codec=codec),
        use_arena=use_arena, microbatches=microbatches)


def _batch(vocab):
    return SyntheticTokens(DataConfig(vocab_size=vocab, seq_len=32,
                                      global_batch=4)).batch_at(0)


def _fresh(model, cfg, seed):
    step = TrainStep(model, data_mesh(1), cfg, device=CPU)
    gen = torch.Generator().manual_seed(seed)
    return step, init_train_state(model, step, generator=gen)


def _train(step, state, batch, n):
    for _ in range(n):
        state, metrics = step(state, batch)
    return state, float(metrics["loss"])


@pytest.mark.parametrize("src,dst", [((True, None), (False, None)),
                                     ((False, None), (True, None)),
                                     ((True, "int8"), (False, None)),
                                     ((False, None), (True, "int8"))],
                         ids=["arena_to_none", "none_to_arena",
                              "int8_arena_to_none", "none_to_int8_arena"])
def test_restore_by_path_across_toggles(tmp_path, model, src, dst):
    batch = _batch(model.cfg.vocab_size)
    step_a, state = _fresh(model, _cfg(*src, transport="ring"), 1)
    state, _ = _train(step_a, state, batch, 2)
    save(state, 2, str(tmp_path))
    step_b, like = _fresh(model, _cfg(*dst, transport="ring"), 2)
    with pytest.raises(ValueError, match="strict=False"):
        restore(like, 2, str(tmp_path))
    restored = restore(like, 2, str(tmp_path), strict=False)
    assert restored["step"] == 2
    if dst[1] is not None:                # a fresh "ef" starts at zero
        assert torch.count_nonzero(restored["ef"]) == 0
    for a, b in zip(tree_util.leaves(restored["params"]),
                    tree_util.leaves(state["params"])):
        assert torch.equal(a, b)
    _, ref_loss = _train(step_a, state, batch, 1)
    _, got_loss = _train(step_b, restored, batch, 1)
    bound = 1e-5 if src[1] is None and dst[1] is None else 5e-5
    assert abs(ref_loss - got_loss) < bound, (ref_loss, got_loss)


def test_same_codec_restores_ef_strictly_and_bitwise(tmp_path, model):
    batch = _batch(model.cfg.vocab_size)
    step, state = _fresh(model, _cfg(True, "int8", "ring"), 1)
    state, _ = _train(step, state, batch, 2)
    assert torch.count_nonzero(state["ef"]) > 0
    save(state, 2, str(tmp_path))
    restored = restore(tree_util.tree_map(
        lambda x: torch.zeros_like(x) if isinstance(x, torch.Tensor) else 0,
        state), 2, str(tmp_path))
    assert torch.equal(restored["ef"], state["ef"])
    assert torch.equal(restored["arena"], state["arena"])
    _, ref_loss = _train(step, state, batch, 1)
    _, got_loss = _train(step, restored, batch, 1)
    assert ref_loss == got_loss


def test_reshaped_arena_leaf_still_raises(tmp_path, model):
    _, state = _fresh(model, _cfg(True, "int8", "ring"), 1)
    save(state, 1, str(tmp_path))
    _, like = _fresh(model, _cfg(True, None, "ring"), 2)
    with pytest.raises(ValueError, match="arena"):
        restore(like, 1, str(tmp_path), strict=False)


def test_trainer_retries_by_path_and_says_so(tmp_path, model):
    data = SyntheticTokens(DataConfig(vocab_size=model.cfg.vocab_size,
                                      seq_len=32, global_batch=4))
    ck = str(tmp_path / "ck")
    Trainer(model, data_mesh(1), _cfg(True), data,
            TrainerConfig(steps=2, ckpt_dir=ck, log_every=100),
            device=CPU, log=lambda m: None).run()
    said = []
    tr = Trainer(model, data_mesh(1), _cfg(False), data,
                 TrainerConfig(steps=3, ckpt_dir=ck, log_every=100),
                 device=CPU, log=said.append)
    assert tr.start_step == 2 and "arena" not in tr.state
    assert any("path matching" in m for m in said)
    assert any("resumed from step 2" in m for m in said)
    assert [h["step"] for h in tr.run()["history"]] == [2]


def test_arena_holds_the_reduced_mean_with_microbatches(model):
    """With two microbatches the arena a replicated step returns holds the
    reduced mean of the gradients (what the reference's returns), and the
    step's result is the one without the arena."""
    batch = shard_batch(_batch(model.cfg.vocab_size), 0, 1)
    step, state = _fresh(model, _cfg(True, microbatches=2), 1)
    plain, pstate = _fresh(model, _cfg(False, microbatches=2), 1)
    ptr = state["arena"].data_ptr()
    params = state["params"]
    loss, (grads, buf) = step.comm.reduce_scheduled(
        step._grad_fn, params, batch, step.schedule, op="all_reduce",
        arena=step.arena, arena_buf=state["arena"])
    assert buf.data_ptr() == ptr
    buckets, _ = step.comm.bucketer.bucketize(grads)
    segments = step.arena.unpack(buf)
    assert len(segments) == len(buckets)
    for seg, bucket in zip(segments, buckets):
        assert torch.equal(seg, bucket)
    new, m = step(state, batch)
    new_p, mp = plain(pstate, batch)
    assert float(m["loss"]) == float(mp["loss"])
    for a, b in zip(tree_util.leaves(new["params"]),
                    tree_util.leaves(new_p["params"])):
        assert torch.equal(a, b)
