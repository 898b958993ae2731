"""Host meshes for the launchers.

Port of ``repro.launch.mesh.make_host_mesh``: the ranks of one run laid out
as ``("data", "model")``, the model axis as large as ``model_parallel``
allows, halved until it divides the rank count.
"""

from __future__ import annotations

from repro_torch.core.topology import RankMesh


def make_host_mesh(n_ranks: int, model_parallel: int = 2) -> RankMesh:
    """``(n / model, model)`` over ``("data", "model")``, where ``model`` is
    ``model_parallel`` halved until it divides ``n_ranks``."""
    if n_ranks < 1:
        raise ValueError(f"a mesh needs at least one rank, got {n_ranks}")
    model = model_parallel
    while model > 1 and n_ranks % model:
        model //= 2
    model = max(model, 1)
    return RankMesh(("data", "model"), (n_ranks // model, model))
