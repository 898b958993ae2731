"""repro_torch.comm — the Communicator API (port of ``repro.comm``).

A :class:`Communicator` built from ``(RankMesh, CommConfig)`` reduces
gradient buckets over named transports (:mod:`repro_torch.comm.registry`)
with channel striping, bucket and arena plans (:mod:`.plan`) and issue
schedules (:mod:`.schedule`), and runs the Cartesian halo exchange on the
same rails (:class:`HaloPlan`, :func:`build_halo_schedule`) and the
expert-parallel all-to-all over a one-axis communicator (:class:`A2APlan`,
:func:`build_moe_schedule`).  At ``channels >= 2`` each rail's collectives
run on a host thread and a CUDA stream of their own (:mod:`.rails`).

Legacy string policies (``ReduceConfig.policy``) map onto transports via
:data:`POLICY_TO_TRANSPORT`; :class:`repro_torch.core.reducer.GradientReducer`
remains as a deprecated shim over this package.
"""

from repro_torch.comm.api import CommConfig, Communicator
# legacy string-policy mapping: lives with the GradientReducer shim
from repro_torch.core.reducer import (POLICY_TO_TRANSPORT,
                                      comm_config_from_policy)
from repro_torch.comm.plan import (ALPHA_S, HBM_BANDWIDTH, A2APlan,
                                   ChannelAssignment, CommPlan, HaloChannel, HaloPlan,
                                   LatencyModel, assign_channels)
from repro_torch.comm.registry import (Transport, TransportSpec,
                                       get_transport, list_transports,
                                       register_transport, transport_specs)
from repro_torch.comm.schedule import (HALO_SCHEDULES, SCHEDULE_POLICIES,
                                       CommSchedule, IssueSlot,
                                       build_halo_schedule, build_moe_schedule,
                                       build_schedule,
                                       halo_interior_fraction, halo_units)
from repro_torch.comm.wire_codec import (ErrorFeedback, IdentityCodec,
                                         Int8BlockCodec, make_codec)

__all__ = [
    "A2APlan", "ALPHA_S", "ChannelAssignment", "CommConfig", "CommPlan",
    "CommSchedule", "Communicator", "ErrorFeedback", "HALO_SCHEDULES",
    "HBM_BANDWIDTH", "HaloChannel", "HaloPlan", "IdentityCodec",
    "Int8BlockCodec", "IssueSlot", "LatencyModel", "POLICY_TO_TRANSPORT",
    "SCHEDULE_POLICIES",
    "Transport", "TransportSpec", "assign_channels", "build_halo_schedule",
    "build_moe_schedule", "build_schedule", "comm_config_from_policy",
    "get_transport", "halo_interior_fraction",
    "halo_units", "list_transports", "make_codec", "register_transport",
    "transport_specs",
]
