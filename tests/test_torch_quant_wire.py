"""repro_torch int8 wire plans against the JAX reference, field for field.

The quantized arena layout (int8 payload laid out like the fp32 arena plus
a trailing page-quantized scale segment) for the reference's layout
parametrisation and for the full-width llama3.2-1b bucket plan, the
``Communicator``/``CommPlan`` plumbing under ``wire_codec="int8"``
(``describe()`` with the codec's price at the reference's memory rate) and
the config refusals that apply to the replicated port.  Plans are plain
arithmetic, so they must be equal.
"""

import types

import jax
import numpy as np
import pytest
import torch

from repro.comm import CommConfig as JaxCommConfig
from repro.comm import Communicator as JaxCommunicator
from repro.comm.plan import HBM_BANDWIDTH as JAX_HBM_BANDWIDTH
from repro.configs import get_config as jax_get_config
from repro.mem import plan_quant_arena as jax_plan_quant_arena
from repro.models import build_model as jax_build_model
from repro_torch.comm import CommConfig, Communicator
from repro_torch.comm.plan import HBM_BANDWIDTH
from repro_torch.configs import get_config
from repro_torch.core.topology import RankMesh
from repro_torch.mem.arena import QuantCommArena
from repro_torch.mem.layout import (SCALE_BYTES, QuantArenaLayout,
                                    plan_quant_arena)
from repro_torch.models import build_model
from repro_torch.runtime.train_step import abstract_params

Q_SIZES = (4096, 512, 8192, 1024, 1536)


def _comms(world, **kw):
    fake_mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                      devices=np.empty((world, 1)))
    return (JaxCommunicator(fake_mesh, JaxCommConfig(**kw)),
            Communicator(RankMesh(("data", "model"), (world, 1)),
                         CommConfig(**kw), connect=False))


def _same_plan(plan, jplan):
    """``describe()`` equal field for field, the codec's price compared at
    the reference's memory rate (the port's default is the H100's)."""
    d, jd = plan.describe(), jplan.describe()
    if plan.wire_codec is not None:
        assert d.pop("codec") == plan.codec_tradeoff()
        assert jd.pop("codec") == jplan.codec_tradeoff()
        assert plan.codec_tradeoff(hbm_bandwidth=JAX_HBM_BANDWIDTH) == \
            jplan.codec_tradeoff()
    assert d == jd


@pytest.mark.parametrize("page_bytes,block", [(512, 128), (4096, 512),
                                              (4096, 1024), (2 * 2**20, 512)])
def test_quant_layout_equals_reference(page_bytes, block):
    lay = plan_quant_arena(Q_SIZES, page_bytes=page_bytes, block=block)
    jlay = jax_plan_quant_arena(Q_SIZES, page_bytes=page_bytes, block=block)
    assert isinstance(lay, QuantArenaLayout) and lay.dtype == torch.int8
    assert lay.describe() == jlay.describe()
    for s in lay.segments:
        assert lay.scale_byte_range(s.offset, s.padded) == \
            jlay.scale_byte_range(s.offset, s.padded)
    # the invariants the arena relies on: page-aligned scales right after
    # the payload, whole codec blocks per segment, disjoint scale ranges
    assert lay.scale_offset == lay.payload_elems
    assert lay.scale_offset % lay.quantum == 0
    assert lay.total_elems >= lay.scale_offset + lay.n_scales * SCALE_BYTES
    ranges = sorted(lay.scale_byte_range(s.offset, s.padded)
                    for s in lay.segments)
    for (_, hi), (lo, _) in zip(ranges, ranges[1:]):
        assert hi <= lo
    assert all(s.offset % block == 0 and s.padded % block == 0
               for s in lay.segments)


@pytest.mark.parametrize("world", [1, 2])
def test_full_width_llama_int8_plan_equals_reference(world):
    """The chip's train_int8 (1 rank) and train_ring_int8 (2 ranks) plans of
    llama3.2-1b at full width: bucket plan, quantized arena and CommPlan."""
    kw = dict(transport="ring_hier", chunks=2, channels=0,
              bucket_bytes=32 * 2**20, page_bytes=2 * 2**20,
              wire_codec="int8", data_axes=("data",))
    jcomm, comm = _comms(world, **kw)
    cfg, jcfg = get_config("llama3.2-1b"), jax_get_config("llama3.2-1b")
    tree = abstract_params(build_model(cfg))
    jtree = jax_build_model(jcfg).abstract_params()
    plan, jplan = comm.plan(tree), jcomm.plan(jtree)
    assert plan.bucket_plan.bucket_sizes == jplan.bucket_plan.bucket_sizes
    assert isinstance(plan.arena_layout, QuantArenaLayout)
    assert max(s.size for s in plan.arena_layout.segments) == 262_668_288
    _same_plan(plan, jplan)
    assert comm.arena_layout(tree).describe() == \
        jcomm.arena_layout(jtree).describe()
    arena = comm.arena(tree)
    assert isinstance(arena, QuantCommArena) and arena.impl == "kernel"


def test_communicator_quant_plumbing_equals_reference():
    tree = {f"g{i}": torch.empty((65536,), device="meta") for i in range(4)}
    jtree = {f"g{i}": jax.ShapeDtypeStruct((65536,), np.float32)
             for i in range(4)}
    for transport in ("ring", "psum"):
        kw = dict(transport=transport, data_axes=("data",),
                  wire_codec="int8", channels=2, bucket_bytes=1 << 20,
                  page_bytes=4096)
        jcomm, comm = _comms(2, **kw)
        assert comm.codec == "int8"
        assert comm.bucketer.pad_multiple == jcomm.bucketer.pad_multiple
        assert comm.bucketer.pad_multiple % 512 == 0
        plan, jplan = comm.plan(tree), jcomm.plan(jtree)
        _same_plan(plan, jplan)
        if transport == "ring":
            assert plan.wire_bytes_per_elem == pytest.approx(1 + 4 / 512)
            assert plan.codec_tradeoff()["applied"]
        else:          # psum reduces dequantized fp32 spans: honest fp32
            assert plan.wire_bytes_per_elem == 4.0
        assert isinstance(plan.arena_layout, QuantArenaLayout)
    assert HBM_BANDWIDTH == 3.35e12


def test_quant_config_refusals():
    mesh = RankMesh(("data",), (2,))
    with pytest.raises(ValueError, match="exclusive"):
        Communicator(mesh, CommConfig(transport="ring", data_axes=("data",),
                                      wire_codec="int8",
                                      wire_dtype="bfloat16"), connect=False)
    with pytest.raises(ValueError, match="wire_codec"):
        Communicator(mesh, CommConfig(transport="ring", data_axes=("data",),
                                      wire_codec="fp4"), connect=False)
