"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Without CUDA a request for it raises; nothing falls back to
    the CPU unless the caller asked for the CPU.  Under a fake-tensor mode
    (the dry-run plans for the card and allocates nothing) ``cuda`` needs
    no card."""
    from repro_torch.fake import fake_mode_active

    dev = torch.device("cuda" if device is None else device)
    if (dev.type == "cuda" and not torch.cuda.is_available()
            and not fake_mode_active()):
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return dev
