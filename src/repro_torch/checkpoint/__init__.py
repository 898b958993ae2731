"""Checkpoints in the reference's on-disk format (``repro.checkpoint``)."""

from repro_torch.checkpoint.ckpt import (REPLICATED, SHARDED, Blocks,
                                         CheckpointManager, RankShards,
                                         latest_step, restore, save)

__all__ = ["Blocks", "CheckpointManager", "RankShards", "REPLICATED",
           "SHARDED", "latest_step", "restore", "save"]
