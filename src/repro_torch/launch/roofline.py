"""Roofline terms of one step on the card (port of ``repro.launch.roofline``).

Three terms per device::

    T_compute    = FLOPs_per_device / PEAK_FLOPS     (dense bf16 peak)
    T_memory     = bytes_per_device / HBM_BW         (device memory rate)
    T_collective = alpha_s * messages_per_device
                 + wire_bytes_per_device / link_bandwidth

The constants are the NVIDIA H100 SXM's, from its data sheet: 989e12
dense bf16 FLOP/s and 3.35e12 B/s of HBM3.  The collective term's α and
link rate are the reference's modelled constants unless a tuning-DB record
supplies measured ones (:meth:`Roofline.from_latency`).  Only
:class:`Roofline` and :func:`model_flops_estimate` are ported: the
reference's HLO parser (``collective_wire_bytes``) has no counterpart,
because the port's wire term comes from the step's own plans
(:mod:`repro_torch.obs.predict`).
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.comm.plan import ALPHA_S, HBM_BANDWIDTH, LINK_BANDWIDTH

PEAK_FLOPS = 989e12          # dense bf16, H100 SXM (data sheet)
HBM_BW = HBM_BANDWIDTH       # bytes/s, H100 SXM (data sheet)
ICI_BW = LINK_BANDWIDTH      # the reference's modelled link rate (β term)


@dataclass
class Roofline:
    flops_per_device: float
    hbm_bytes_per_device: float
    wire_bytes_per_device: float
    model_flops: float = 0.0
    overlap_fraction: float = 0.0   # CommSchedule.overlap_fraction: share of
                                    # collective traffic issued while compute
                                    # remains (0 = serialised after compute)
    messages_per_device: float = 0.0  # collective launches (α latency term)
    padding_wire_bytes_per_device: float = 0.0  # arena page padding that
                                    # rides the fused collectives
    alpha_s: float = ALPHA_S
    link_bandwidth: float = ICI_BW  # β term; a tuning-DB record replaces
                                    # both constants with measured ones
                                    # (Roofline.from_latency)

    @classmethod
    def from_latency(cls, model, **kw) -> "Roofline":
        """Roofline whose α/β constants come from a
        :class:`~repro_torch.comm.plan.LatencyModel`, typically one rebuilt
        from a tuning-DB record (``LatencyModel.from_record``)."""
        return cls(alpha_s=model.alpha_s, link_bandwidth=model.bandwidth,
                   **kw)

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        """α·messages + bytes/bw (pure bandwidth when no count supplied).
        Arena page padding is folded into the β term: fused spans carry it
        across the wire, so the prediction charges for it."""
        return (self.alpha_s * self.messages_per_device
                + (self.wire_bytes_per_device
                   + self.padding_wire_bytes_per_device)
                / self.link_bandwidth)

    @property
    def t_exposed_collective(self) -> float:
        """Collective time left *exposed* after hiding under the compute the
        schedule makes overlappable: ``max(0, t_collective −
        overlap_fraction · t_compute)``.  Equals ``t_collective`` for an
        ``accumulate_then_reduce`` schedule (overlap 0); never exceeds it."""
        hidden = min(1.0, max(0.0, self.overlap_fraction)) * self.t_compute
        return max(0.0, self.t_collective - hidden)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def bound_time_overlapped(self) -> float:
        """Step-time bound when the schedule's overlap is realised: only the
        exposed collective time serialises with compute."""
        return max(self.t_compute, self.t_memory, self.t_exposed_collective)

    @property
    def compute_fraction(self) -> float:
        """How close the step is to the compute roofline (1.0 = perfectly
        compute-bound)."""
        t = self.bound_time
        return self.t_compute / t if t > 0 else 0.0

    def useful_flops_ratio(self, n_devices: int) -> float:
        if self.flops_per_device <= 0:
            return 0.0
        return self.model_flops / (self.flops_per_device * n_devices)

    def as_dict(self, n_devices: int) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "hbm_bytes_per_device": self.hbm_bytes_per_device,
            "wire_bytes_per_device": self.wire_bytes_per_device,
            "messages_per_device": self.messages_per_device,
            "padding_wire_bytes_per_device":
                self.padding_wire_bytes_per_device,
            "alpha_s": self.alpha_s,
            "link_bandwidth": self.link_bandwidth,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "t_exposed_collective_s": self.t_exposed_collective,
            "overlap_fraction": self.overlap_fraction,
            "bottleneck": self.bottleneck,
            "compute_fraction": self.compute_fraction,
            "bound_time_overlapped_s": self.bound_time_overlapped,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio(n_devices),
        }


def model_flops_estimate(n_params_active: int, tokens: int,
                         kind: str) -> float:
    """6·N·D for training; 2·N·D for inference forward passes."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_params_active * tokens
