"""Trainer: steps, metrics, checkpoint-restart, straggler accounting.

Port of ``repro.runtime.train_loop``.  Data is stateless: step ``s`` trains
on ``data.batch_at(s)``, of which this rank takes the rows of its data
coordinate (the ranks of one model group take the same rows), so a resumed
run replays the same batches.

The fault-tolerance contract: every ``ckpt_every`` steps the full train
state is saved (atomically, async; the flat and the model-sharded leaves
gathered into global arrays on rank 0, in the reference's on-disk format,
:meth:`TrainStep.state_layout`), and on construction
the trainer resumes from the newest committed step.

Observability: with ``TrainerConfig.obs`` set, the trainer publishes onto
a :class:`repro_torch.obs.MetricsBus` — phase spans (data / step: dispatch
+ wait / ckpt; ``wait`` fenced on the step's metrics, so it covers the
device work), per-step gauges (step time, loss, grad norm, lr), straggler
events (via the monitor's bus) — and, when a step-time prediction is
available (explicit, the live step's roofline, or priced by a tuning DB),
feeds a :class:`repro_torch.obs.DriftDetector`.  A computed prediction
runs one forward and backward on every rank at once (it is collective
over a mesh of several ranks), so every rank's Trainer asks for it.
Every step ends in a host read of the loss, which waits for the device,
so ``sec`` is the step's wall time with its device work.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.topology import RankMesh
from repro_torch.data import SyntheticTokens
from repro_torch.models.model_api import Model
from repro_torch.obs import ObsConfig, make_obs
from repro_torch.runtime.ft import StragglerMonitor
from repro_torch.runtime.train_step import (TrainStep, TrainStepConfig,
                                            init_train_state, shard_batch)


@dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str | None = None
    log_every: int = 10
    seed: int = 0
    obs: ObsConfig | None = None   # None -> NULL_OBS: zero-overhead no-op


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
        self.obs = make_obs(tcfg.obs)
        self.monitor = StragglerMonitor(bus=self.obs.bus)
        self.step_fn = TrainStep(model, mesh, step_cfg, device=device)
        self.ckpt = (CheckpointManager(tcfg.ckpt_dir,
                                       ranks=self.step_fn.ranks)
                     if tcfg.ckpt_dir else None)
        gen = None
        if params is None:
            gen = torch.Generator(device=device).manual_seed(tcfg.seed)
        self.state = init_train_state(model, self.step_fn, params=params,
                                      generator=gen)
        self.start_step = 0
        if self.ckpt is not None:
            layout = self.step_fn.state_layout(self.state)
            try:
                restored, step = self.ckpt.restore_latest(self.state,
                                                          layout=layout)
            except ValueError as e:
                if "strict=False" not in str(e):
                    raise
                # structural change (e.g. toggling use_arena's scratch comm
                # buffer): retry path-matched, loudly — leaves absent from
                # the checkpoint keep their fresh-init values
                restored, step = self.ckpt.restore_latest(
                    self.state, strict=False, layout=layout)
                self.log(f"[trainer] state structure changed since the "
                         f"checkpoint; resumed by path matching ({e})")
            if restored is not None:
                self.state = restored
                self.start_step = int(step)
                self.log(f"[trainer] resumed from step {step}")
        self.drift = self._init_drift()

    def _init_drift(self):
        """Wire a DriftDetector when the obs config carries (or asks us to
        compute) a step-time prediction; None otherwise."""
        cfg = self.tcfg.obs
        if not self.obs.enabled or cfg is None:
            return None
        if cfg.predicted_step_s is not None:
            return self.obs.drift_detector(cfg.predicted_step_s,
                                           source="explicit")
        if not (cfg.predict or cfg.tuned_db):
            return None
        try:
            from repro_torch.obs import predict as obs_predict

            latency = None
            source = "roofline"
            step = self.step_fn
            if cfg.tuned_db:
                ccfg = step.comm.cfg
                mesh_label = "x".join(str(d) for d in step.mesh.shape)
                got = obs_predict.tuned_latency(
                    cfg.tuned_db, transport=ccfg.transport,
                    mesh_label=mesh_label, channels=ccfg.channels,
                    page_bytes=ccfg.page_bytes)
                if got is not None:
                    latency, fit_err, key = got
                    source = "tuned"
                    self.obs.event("tuned_record", key=key, **fit_err)
            batch = shard_batch(self.data.batch_at(0), step.data_index,
                                step.data_world)
            pred = obs_predict.predict_step_time(
                step, (self.state, batch),
                overlap_fraction=step.schedule.overlap_fraction,
                latency=latency)
            self.obs.event("prediction", **pred)
            self.log(f"[obs] predicted step {pred['t_step_s']*1e3:.1f} ms "
                     f"({pred['bottleneck']}-bound, {pred['source']})")
            return self.obs.drift_detector(pred["t_step_s"], source=source)
        except Exception as e:   # prediction is advisory: never kill a run
            self.obs.event("predict_failed", error=repr(e))
            self.log(f"[obs] step-time prediction failed ({e!r}); "
                     f"drift detection disabled")
            return None

    def _save(self, step: int) -> None:
        self.ckpt.save(self.state, step,
                       layout=self.step_fn.state_layout(self.state))

    def run(self) -> dict:
        history: list[dict] = []
        obs = self.obs
        t_total = time.perf_counter()
        for step in range(self.start_step, self.tcfg.steps):
            with obs.span("data", step=step):
                batch = shard_batch(self.data.batch_at(step),
                                    self.step_fn.data_index,
                                    self.step_fn.data_world)
            t0 = time.perf_counter()
            with obs.span("step", step=step):
                with obs.span("dispatch", step=step):
                    self.state, metrics = self.step_fn(self.state, batch)
                with obs.span("wait", step=step) as sp:
                    sp.fence(metrics)
                    loss = float(metrics["loss"])   # waits for the device
            dt = time.perf_counter() - t0
            ev = self.monitor.record(step, dt)
            obs.counter("steps")
            obs.gauge("step_time_s", dt)
            obs.gauge("loss", loss)
            obs.gauge("grad_norm", float(metrics["grad_norm"]))
            obs.gauge("lr", float(metrics["lr"]))
            if "moe_drop_fraction" in metrics:
                obs.gauge("moe_drop_fraction",
                          float(metrics["moe_drop_fraction"]))
            if self.drift is not None:
                self.drift.update(step, dt)
            rec = {"step": step, "loss": loss,
                   "grad_norm": float(metrics["grad_norm"]),
                   "lr": float(metrics["lr"]), "sec": dt,
                   "straggler": bool(ev)}
            history.append(rec)
            if step % self.tcfg.log_every == 0 or step == self.tcfg.steps - 1:
                self.log(f"[train] step {step:5d} loss {loss:.4f} "
                         f"gnorm {rec['grad_norm']:.3f} lr {rec['lr']:.2e} "
                         f"{dt * 1e3:.0f} ms" + (" STRAGGLER" if ev else ""))
            if self.ckpt is not None and (step + 1) % self.tcfg.ckpt_every == 0:
                with obs.span("ckpt", step=step):
                    self._save(step + 1)
        if self.ckpt is not None:
            with obs.span("ckpt", step=self.tcfg.steps):
                self._save(self.tcfg.steps)
                self.ckpt.wait()
        wall = time.perf_counter() - t_total
        obs.event("run_done", steps=self.tcfg.steps - self.start_step,
                  wall_s=wall, stragglers=len(self.monitor.events),
                  drifting=bool(self.drift.drifting) if self.drift else False)
        paths = obs.finish()
        return {"history": history, "wall": wall,
                "straggler_events": self.monitor.events,
                "obs": paths}
