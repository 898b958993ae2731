"""Per-architecture launch settings (port of ``repro.launch.settings``).

The table is the reference's: data-parallel mode, microbatches, serving
weight residency and the communication substrate of each architecture.
``transport="auto"``, ``page_bytes="auto"`` and ``channels=0`` are the
tuner's sentinels (:mod:`repro_torch.tune.resolve`): a launcher given a
tuning DB (``--tuned``) resolves them to its measured best config; an
unresolved ``"auto"`` falls back to the defaults with a warning.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.comm.api import CommConfig


@dataclass(frozen=True)
class ArchSettings:
    dp_mode: str            # replicated | zero1 | fsdp
    microbatches: int       # grad-accumulation slices for train_4k
    serve_weights: str      # resident | gathered
    transport: str = "ring_hier"   # a registered transport, or "auto":
                                   # the measured best from the tuning DB
    channels: int = 0       # virtual comm rails (0 = unconstrained; also
                            # the tuner's soft "resolve me" sentinel)
    wire_codec: str | None = None
    page_bytes: int | str = 2 * 2**20  # arena granule (the paper's huge
                                       # page), or "auto": from the DB
    moe_transport: str = "a2a"
    moe_channels: int = 0

    def comm_config(self, *, chunks: int = 2,
                    bucket_bytes: int = 256 * 2**20,
                    page_bytes: int | None = None) -> CommConfig:
        """The architecture's production communicator config.

        Unresolved ``"auto"`` sentinels (the caller skipped
        :func:`repro_torch.tune.resolve.resolve_settings`) fall back to the
        defaults with a warning rather than failing the launch."""
        transport, pb = self.transport, (self.page_bytes if page_bytes is None
                                         else page_bytes)
        if transport == "auto" or pb == "auto":
            import warnings

            from repro_torch.tune.resolve import (FALLBACK_PAGE_BYTES,
                                                  FALLBACK_TRANSPORT)
            warnings.warn(
                "comm_config() called with unresolved 'auto' settings; "
                "resolve via repro_torch.tune.resolve.resolve_settings (or "
                "pass --tuned to the launcher) — using defaults",
                stacklevel=2)
            if transport == "auto":
                transport = FALLBACK_TRANSPORT
            if pb == "auto":
                pb = FALLBACK_PAGE_BYTES
        return CommConfig(transport=transport, channels=self.channels,
                          chunks=chunks, bucket_bytes=bucket_bytes,
                          page_bytes=int(pb), wire_codec=self.wire_codec)


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
    """Lookup; an unknown arch names the full menu."""
    try:
        return SETTINGS[arch]
    except KeyError:
        raise ValueError(
            f"unknown arch {arch!r}; known archs: "
            f"{', '.join(sorted(SETTINGS))}") from None


def resolve_settings_for(arch: str, *, mesh_label: str | None = None,
                         db_path: str | None = None
                         ) -> tuple[ArchSettings, dict]:
    """:func:`settings_for` plus tuning-DB resolution of any ``"auto"``
    sentinels (:mod:`repro_torch.tune.resolve`); returns ``(settings,
    info)``, ``info["source"]`` saying whether a measured record was used.
    Settings with no sentinels pass through untouched."""
    from repro_torch.tune.resolve import resolve_settings

    return resolve_settings(settings_for(arch), arch, mesh_label=mesh_label,
                            db_path=db_path)
