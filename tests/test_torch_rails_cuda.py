"""The rail executor on the card: each rail's calls on the rail's own CUDA
stream, ordered after the caller's work and joined back into it.

Marked ``cuda``; without a card the test skips (the streams exist only
there; ``tests/test_torch_rails.py`` runs the threads on the CPU).  On the
card::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_rails_cuda.py
"""

from __future__ import annotations

import pytest
import torch

from repro_torch.comm.rails import RailExecutor, new_rail_stream


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the rails' streams exist only there")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_rails_launch_on_their_streams_after_and_before_the_caller(
        cuda_device):
    from repro_torch.kernels.reduce_add import ops

    streams = [new_rail_stream(), new_rail_stream()]
    caller = torch.cuda.current_stream(cuda_device)
    assert all(s is not None and s != caller for s in streams)
    ex = RailExecutor(streams)
    n = 1 << 22
    a = torch.randn(n, device=cuda_device)
    # queued on the caller's stream: a rail must see its result
    b = torch.randn(n, device=cuda_device).mul_(2.0)
    seen = []

    def add(rail, x, y):
        def fn():
            seen.append((rail, torch.cuda.current_stream(cuda_device)))
            return ops.add_accum(x, y)
        return fn

    before = ops.LAUNCHES
    out = ex.run([(0, add(0, a, b)), (1, add(1, b, a)), (0, add(0, a, a))],
                 cuda_device)
    assert ops.LAUNCHES == before + 3
    assert [s for _, s in seen] == [streams[r] for r, _ in seen]
    # read on the caller's stream after the join, without a synchronize
    torch.testing.assert_close(out[0], a + b, rtol=0, atol=0)
    torch.testing.assert_close(out[1], b + a, rtol=0, atol=0)
    torch.testing.assert_close(out[2], a + a, rtol=0, atol=0)
    with pytest.raises(ValueError, match="stream on"):
        RailExecutor([None]).run([(0, lambda: None)], cuda_device)
