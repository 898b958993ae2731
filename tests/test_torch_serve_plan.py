"""repro_torch serving plan: configs, arena placement, KV arena plan and the
page allocator, field for field against the JAX reference."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import configs as jax_configs
from repro.mem.layout import plan_arena as jax_plan_arena
from repro.serve.kv import plan_kv_arena as jax_plan_kv_arena
from repro_torch import configs
from repro_torch.mem.layout import plan_arena
from repro_torch.serve.kv import (KVPageAllocator, PageTable,
                                  plan_kv_arena)

PLAN_FIELDS = ("n_kv_pages", "page_stride", "payload_elems", "v_offset",
               "total_elems", "total_bytes", "max_blocks", "blocks_per_rank",
               "n_arena_pages", "padding_fraction")


def _mesh(mp):
    # the reference's plan reads only the mesh's axis sizes
    return SimpleNamespace(axis_names=("data", "model"),
                           devices=np.zeros((1, mp)))


def test_config_registry_is_the_reference_copy():
    assert configs.list_archs() == jax_configs.list_archs()
    for arch in configs.list_archs():
        for get in ("get_config", "reduced_config"):
            mine = dataclasses.asdict(getattr(configs, get)(arch))
            theirs = dataclasses.asdict(getattr(jax_configs, get)(arch))
            assert mine == theirs, (arch, get)


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("page_tokens", [8, 16])
@pytest.mark.parametrize("page_bytes", [4096, 2 * 2**20])
@pytest.mark.parametrize("mp", [1, 2])
def test_kv_plan_matches_jax(reduced, page_tokens, page_bytes, mp):
    get = "reduced_config" if reduced else "get_config"
    kw = dict(page_tokens=page_tokens, page_bytes=page_bytes, max_seqs=4,
              max_seq_len=200)
    mine = plan_kv_arena(getattr(configs, get)("llama3.2-1b"),
                         model_parallel=mp, **kw)
    theirs = jax_plan_kv_arena(getattr(jax_configs, get)("llama3.2-1b"),
                               _mesh(mp), **kw)
    for f in PLAN_FIELDS:
        assert getattr(mine, f) == getattr(theirs, f), f
    assert mine.describe() == theirs.describe()
    for pid in (0, 1, mine.n_kv_pages - 1):
        assert mine.page_offset(pid) == theirs.page_offset(pid)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_kv_plan_cache_dtype_and_zeros(cache_dtype):
    cfg = configs.reduced_config("llama3.2-1b")
    plan = plan_kv_arena(cfg, page_tokens=8, page_bytes=4096, max_seqs=2,
                         max_seq_len=24, cache_dtype=getattr(torch, cache_dtype))
    theirs = jax_plan_kv_arena(jax_configs.reduced_config("llama3.2-1b"),
                               page_tokens=8, page_bytes=4096, max_seqs=2,
                               max_seq_len=24,
                               cache_dtype=getattr(jnp, cache_dtype))
    assert plan.describe() == theirs.describe()
    z = plan.zeros("cpu")
    assert z.shape == (plan.total_elems,) and z.dtype == getattr(torch,
                                                                 cache_dtype)
    assert not z.any()


@pytest.mark.parametrize("channels", [None, [0, 0, 1, 1, 0], [2, 0, 2, 1, 0]])
def test_arena_layout_matches_jax(channels):
    sizes = [1000, 5000, 1, 70000, 4096]
    for page_bytes, pad in ((4096, 1), (2 * 2**20, 256)):
        mine = plan_arena(sizes, page_bytes=page_bytes, dtype=torch.float32,
                          channel_of=channels, pad_multiple=pad)
        theirs = jax_plan_arena(sizes, page_bytes=page_bytes,
                                dtype=jnp.float32, channel_of=channels,
                                pad_multiple=pad)
        assert mine.describe() == theirs.describe()


def test_plan_rejects_non_pageable_and_bad_args():
    for arch in ("falcon-mamba-7b", "whisper-base", "mixtral-8x7b"):
        with pytest.raises(NotImplementedError):
            plan_kv_arena(configs.reduced_config(arch), page_tokens=8)
    cfg = configs.reduced_config("llama3.2-1b")
    for kw in ({"page_tokens": 0}, {"max_seqs": 0}, {"model_parallel": 0}):
        with pytest.raises(ValueError):
            plan_kv_arena(cfg, **kw)
    with pytest.raises(ValueError):
        plan_arena([4], page_bytes=6, dtype=torch.float32)


def test_allocator_lifo_double_free_and_exhaustion():
    a = KVPageAllocator(6)
    assert a.n_free == 6 and a.n_allocated == 0
    got = a.alloc(4)
    assert got == [0, 1, 2, 3]
    with pytest.raises(MemoryError):
        a.alloc(3)
    a.free(got[:2])
    assert a.n_free == 4 and a.n_allocated == 2
    with pytest.raises(ValueError):          # double free
        a.free(got[:1])
    with pytest.raises(ValueError):          # foreign id
        a.free([17])
    # LIFO: the most recently freed page comes back first
    a2 = KVPageAllocator(3)
    p = a2.alloc(3)
    a2.free([p[1]])
    assert a2.alloc(1) == [p[1]]
    with pytest.raises(ValueError):
        KVPageAllocator(0)


def test_page_table_maps_and_clears():
    t = PageTable(2, 3, 2)
    t.map_block(1, 2, [5, 6])
    assert t.table[1, 2].tolist() == [5, 6]
    with pytest.raises(ValueError):          # already mapped
        t.map_block(1, 2, [7, 8])
    with pytest.raises(ValueError):          # one page per layer
        t.map_block(0, 0, [1])
    assert t.clear_slot(1) == [5, 6]
    assert (t.table == -1).all()


@pytest.mark.parametrize("mp", [1, 2, 4])
def test_serve_predictions_match_jax(mp):
    from repro.serve.engine import (
        predicted_collectives_per_token as jax_collectives,
        predicted_wire_bytes_per_token as jax_wire_bytes)
    from repro_torch.serve.engine import (predicted_collectives_per_token,
                                          predicted_wire_bytes_per_token)

    kw = dict(page_tokens=16, page_bytes=4096, max_seqs=4, max_seq_len=200)
    plan = plan_kv_arena(configs.get_config("llama3.2-1b"),
                         model_parallel=mp, **kw)
    jplan = jax_plan_kv_arena(jax_configs.get_config("llama3.2-1b"),
                              _mesh(mp), **kw)
    assert predicted_collectives_per_token(plan) == jax_collectives(jplan)
    assert predicted_wire_bytes_per_token(
        plan, configs.get_config("llama3.2-1b"), 4) == jax_wire_bytes(
        jplan, jax_configs.get_config("llama3.2-1b"), 4)
