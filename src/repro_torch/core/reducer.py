"""GradientReducer — DEPRECATED shim over :class:`repro_torch.comm.Communicator`.

Port of ``repro.core.reducer``.  The string-policy reducer has been
replaced by the unified ``repro_torch.comm`` subsystem: named transports in
a registry (:mod:`repro_torch.comm.registry`), channel striping and bucket
layout fused into a :class:`repro_torch.comm.CommPlan`, and one
:class:`~repro_torch.comm.Communicator` shared by gradient reduction and
halo exchange.  Policy names map onto transports:

===========================  ============================================
``baidu_original``           ``ring`` (chunks=1, unidirectional, fp32
                             wire, the plain local add)
``fused_ring``               ``ring``
``fused_ring_hierarchical``  ``ring_hier``  (default)
``fused_ring_compressed``    ``ring_hier`` + ``wire_codec='int8'``
``native_psum``              ``psum`` (fuse=False, per-tensor)
``native_psum_fused``        ``psum``
===========================  ============================================

The reference's ``local_op`` values ``"jnp"`` and ``"pallas"`` are the
port's ``"plain"`` and ``"kernel"`` (:data:`LOCAL_OP_OF_REFERENCE`), so
``baidu_original`` forces the plain add as the reference forces its jnp
add, and :class:`ReduceConfig` defaults to ``"kernel"``, the port's
:class:`~repro_torch.comm.CommConfig` default.

The port has no SPMD level: :meth:`GradientReducer.reduce` all-reduces this
rank's local tree (:meth:`~repro_torch.comm.Communicator.all_reduce_tree`),
and ``specs`` is accepted and unused.  New code should build a
``Communicator`` directly::

    from repro_torch.comm import CommConfig, Communicator
    comm = Communicator(mesh, CommConfig(transport="ring_hier", channels=2))
    reduced, _ = comm.all_reduce_tree(grads)
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, replace

from repro_torch.core.ring import RingConfig
from repro_torch.core.topology import RankMesh

# NOTE: repro_torch.comm is imported lazily inside the shim:
# repro_torch.comm.api imports repro_torch.core submodules, and
# repro_torch.comm re-exports this module's table, so importing it here at
# module level would close an import cycle.

POLICIES = ("baidu_original", "fused_ring", "fused_ring_hierarchical",
            "fused_ring_compressed", "native_psum", "native_psum_fused")

# the reference's local_op values and the port's names for the same two
# implementations (the plain add, the hand-written kernel)
LOCAL_OP_OF_REFERENCE = {"jnp": "plain", "pallas": "kernel"}

# former ReduceConfig.policy -> (transport, CommConfig field overrides);
# repro_torch.comm re-exports it for old importers
POLICY_TO_TRANSPORT: dict[str, tuple[str, dict]] = {
    "baidu_original": ("ring", {"chunks": 1, "bidirectional": False,
                                "wire_dtype": None, "local_op": "plain"}),
    "fused_ring": ("ring", {}),
    "fused_ring_hierarchical": ("ring_hier", {}),
    "fused_ring_compressed": ("ring_hier", {"wire_codec": "int8"}),
    "native_psum": ("psum", {"fuse": False}),
    "native_psum_fused": ("psum", {}),
}


def comm_config_from_policy(policy: str, **fields):
    """Map a legacy ``ReduceConfig.policy`` name onto a
    :class:`repro_torch.comm.CommConfig`.

    ``fields`` are CommConfig overrides taken from the legacy config; the
    policy's own forced overrides (e.g. ``baidu_original`` =>
    unidirectional single-chunk) win over them, and fields CommConfig does
    not have are dropped.
    """
    from repro_torch.comm.api import CommConfig

    try:
        transport, forced = POLICY_TO_TRANSPORT[policy]
    except KeyError:
        raise ValueError(
            f"unknown policy {policy!r}; one of "
            f"{tuple(POLICY_TO_TRANSPORT)}") from None
    base = CommConfig(transport=transport)
    merged = {**fields, **forced}
    known = {k: v for k, v in merged.items() if hasattr(base, k)}
    return replace(base, **known)


@dataclass(frozen=True)
class ReduceConfig:
    """Legacy string-policy config; converts to :class:`CommConfig`."""

    policy: str = "fused_ring_hierarchical"
    data_axes: tuple[str, ...] = ("pod", "data")
    bucket_bytes: int = 4 * 2**20
    chunks: int = 2
    bidirectional: bool = True
    wire_dtype: str | None = None
    codec_block: int = 512
    local_op: str = "kernel"
    mean: bool = True

    def comm_config(self, channels: int = 0):
        return comm_config_from_policy(
            self.policy, data_axes=self.data_axes,
            bucket_bytes=self.bucket_bytes, chunks=self.chunks,
            bidirectional=self.bidirectional, wire_dtype=self.wire_dtype,
            codec_block=self.codec_block, local_op=self.local_op,
            mean=self.mean, channels=channels)

    def ring_config(self) -> RingConfig:
        ccfg = self.comm_config()
        codec = "int8" if self.policy == "fused_ring_compressed" else None
        return ccfg.ring_config(codec=codec)


class GradientReducer:
    """Thin deprecated facade; every operation delegates to the
    :class:`Communicator` it constructs (which makes process groups: every
    rank builds its reducers in the same order)."""

    def __init__(self, mesh: RankMesh, cfg: ReduceConfig = ReduceConfig()):
        from repro_torch.comm.api import Communicator

        if cfg.policy not in POLICIES:
            raise ValueError(f"unknown policy {cfg.policy!r}; one of {POLICIES}")
        warnings.warn(
            "GradientReducer is deprecated; use repro.comm.Communicator "
            f"(policy {cfg.policy!r} -> transport "
            f"{POLICY_TO_TRANSPORT[cfg.policy][0]!r})",
            DeprecationWarning, stacklevel=2)
        self.mesh = mesh
        self.cfg = cfg
        self.comm = Communicator(mesh, cfg.comm_config())
        # legacy attribute surface
        self.axes = self.comm.axes
        self.axis_sizes = self.comm.axis_sizes
        self.world = self.comm.world
        self.bucketer = self.comm.bucketer
        self._ring_cfg = self.comm._ring_cfg
        self._ef = self.comm._ef

    # -- public API ----------------------------------------------------------

    def __call__(self, grads, specs=None, ef_state=None):
        return self.reduce(grads, specs, ef_state)

    def reduce(self, grads, specs=None, ef_state=None):
        """Reduce-mean of this rank's local tree over the data axes.
        Returns ``(reduced, ef_state)`` as the reference's SPMD wrapper
        does; ``specs`` is accepted and unused (no SPMD level)."""
        return self.comm.all_reduce_tree(grads, ef_state)

    # -- the reference's manual-mode entry points ----------------------------

    def _ordered_axes(self) -> tuple[str, ...]:
        return self.comm.ordered_axes

    def reduce_manual(self, grads, ef_state=None):
        return self.comm.all_reduce_tree(grads, ef_state)

    def reduce_scatter_manual(self, grads):
        return self.comm.reduce_scatter_tree(grads)

    def all_gather_manual(self, shards, plan=None):
        return self.comm.all_gather_buckets(shards, plan)

    # -- error-feedback state ------------------------------------------------

    def init_ef_state(self, grads_like, specs=None):
        return self.comm.init_ef_state(grads_like, specs)

    # -- analysis ------------------------------------------------------------

    def predicted_collective_bytes(self, grads_like) -> dict[str, float]:
        return self.comm.predicted_collective_bytes(grads_like)


def per_tensor_reducer(mesh: RankMesh, cfg: ReduceConfig) -> GradientReducer:
    """The faithful 'baidu_original' baseline: bucket_bytes=1 forces one
    bucket per tensor (no fusion), matching the published code's per-call
    buffer behaviour."""
    cfg = replace(cfg, policy="baidu_original", bucket_bytes=1)
    return GradientReducer(mesh, cfg)
