"""Meshes for the launchers (port of ``repro.launch.mesh``).

:func:`make_host_mesh` lays the ranks of one run out as ``("data",
"model")``, the model axis as large as ``model_parallel`` allows, halved
until it divides the rank count.  :func:`make_production_mesh` is the
reference's production mesh: 16 x 16 ranks a pod, with a pod axis of 2
prepended for ``multi_pod``; a launcher whose world is not
:func:`required_devices` refuses it (no mesh is shrunk to fit).
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


def make_production_mesh(*, multi_pod: bool = False) -> RankMesh:
    """16 x 16 ranks a pod over ``("data", "model")``; the multi-pod mesh
    prepends a ``"pod"`` axis of 2."""
    if multi_pod:
        return RankMesh(("pod", "data", "model"), (2, 16, 16))
    return RankMesh(("data", "model"), (16, 16))


def required_devices(multi_pod: bool) -> int:
    return 512 if multi_pod else 256


def require_production_world(world: int, multi_pod: bool) -> RankMesh:
    """The production mesh when ``world`` ranks fill it; otherwise raises
    ``SystemExit`` naming :func:`required_devices`."""
    need = required_devices(multi_pod)
    if world != need:
        raise SystemExit(
            f"--production-mesh{' --multi-pod' if multi_pod else ''} needs "
            f"required_devices({multi_pod}) = {need} ranks; this launch has "
            f"{world} (no mesh is shrunk to fit)")
    return make_production_mesh(multi_pod=multi_pod)
