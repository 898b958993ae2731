"""Per-architecture launch settings (port of ``repro.launch.settings``).

The table is the reference's: data-parallel mode, microbatches, serving
weight residency and the communication substrate of each architecture.
The tuner's ``"auto"`` sentinels are not ported; the table holds none.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.comm.api import CommConfig


@dataclass(frozen=True)
class ArchSettings:
    dp_mode: str            # replicated | zero1 | fsdp
    microbatches: int       # grad-accumulation slices for train_4k
    serve_weights: str      # resident | gathered
    transport: str = "ring_hier"
    channels: int = 0       # virtual comm rails (0 = unconstrained)
    wire_codec: str | None = None
    page_bytes: int = 2 * 2**20    # arena granule (the paper's huge page)
    moe_transport: str = "a2a"
    moe_channels: int = 0

    def comm_config(self, *, chunks: int = 2,
                    bucket_bytes: int = 256 * 2**20,
                    page_bytes: int | None = None) -> CommConfig:
        """The architecture's production communicator config."""
        return CommConfig(transport=self.transport, channels=self.channels,
                          chunks=chunks, bucket_bytes=bucket_bytes,
                          page_bytes=(self.page_bytes if page_bytes is None
                                      else page_bytes),
                          wire_codec=self.wire_codec)


SETTINGS: dict[str, ArchSettings] = {
    "whisper-base": ArchSettings("replicated", 1, "resident"),
    "llama3.2-1b": ArchSettings("zero1", 1, "resident"),
    "minicpm-2b": ArchSettings("zero1", 2, "resident"),
    "hymba-1.5b": ArchSettings("zero1", 2, "resident"),
    "qwen2-7b": ArchSettings("fsdp", 2, "resident", channels=2),
    "falcon-mamba-7b": ArchSettings("fsdp", 4, "resident", channels=2),
    "phi3-medium-14b": ArchSettings("fsdp", 4, "resident", channels=2),
    "llava-next-34b": ArchSettings("fsdp", 8, "resident", channels=2),
    "mixtral-8x7b": ArchSettings("fsdp", 4, "resident", channels=2,
                                 moe_channels=2),
    "llama4-maverick-400b-a17b": ArchSettings("fsdp", 4, "gathered",
                                              channels=2, moe_channels=2),
}


def settings_for(arch: str) -> ArchSettings:
    try:
        return SETTINGS[arch]
    except KeyError:
        raise ValueError(
            f"unknown arch {arch!r}; known archs: "
            f"{', '.join(sorted(SETTINGS))}") from None
