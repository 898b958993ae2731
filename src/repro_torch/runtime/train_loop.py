"""Trainer: steps and metrics on one rank.

Port of ``repro.runtime.train_loop`` without checkpointing (the port's
checkpoint slice is still open) and without the observability bus.  Data
is stateless: step ``s`` trains on ``data.batch_at(s)``, of which this rank
takes its rows.  Every step ends in a host read of the loss, which waits for
the device, so ``sec`` is the step's wall time with its device work.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.core.topology import RankMesh
from repro_torch.data import SyntheticTokens
from repro_torch.models.model_api import Model
from repro_torch.runtime.train_step import (TrainStep, TrainStepConfig,
                                            init_train_state, shard_batch)


@dataclass
class TrainerConfig:
    steps: int = 100
    log_every: int = 10
    seed: int = 0


class Trainer:
    def __init__(self, model: Model, mesh: RankMesh,
                 step_cfg: TrainStepConfig, data: SyntheticTokens,
                 tcfg: TrainerConfig, *, device: torch.device, rank: int = 0,
                 params=None, log: Callable[[str], None] = print):
        self.model = model
        self.data = data
        self.tcfg = tcfg
        self.log = log
        self.rank = rank
        self.world = mesh.size
        self.step_fn = TrainStep(model, mesh, step_cfg, device=device)
        gen = None
        if params is None:
            gen = torch.Generator(device=device).manual_seed(tcfg.seed)
        self.state = init_train_state(model, self.step_fn, params=params,
                                      generator=gen)

    def run(self) -> dict:
        history: list[dict] = []
        t_total = time.perf_counter()
        for step in range(self.state["step"], self.tcfg.steps):
            batch = shard_batch(self.data.batch_at(step), self.rank,
                                self.world)
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, batch)
            loss = float(metrics["loss"])          # waits for the device
            dt = time.perf_counter() - t0
            rec = {"step": step, "loss": loss,
                   "grad_norm": float(metrics["grad_norm"]),
                   "lr": float(metrics["lr"]), "sec": dt}
            history.append(rec)
            if step % self.tcfg.log_every == 0 or step == self.tcfg.steps - 1:
                self.log(f"[train] step {step:5d} loss {loss:.4f} "
                         f"gnorm {rec['grad_norm']:.3f} lr {rec['lr']:.2e} "
                         f"{dt * 1e3:.0f} ms")
        return {"history": history, "wall": time.perf_counter() - t_total}
