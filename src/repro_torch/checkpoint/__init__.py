"""Checkpoints in the reference's on-disk format (``repro.checkpoint``)."""

from repro_torch.checkpoint.ckpt import (REPLICATED, SHARDED,
                                         CheckpointManager, RankShards,
                                         latest_step, restore, save)

__all__ = ["CheckpointManager", "RankShards", "REPLICATED", "SHARDED",
           "latest_step", "restore", "save"]
