"""Continuous batching over the paged decode engine.

Port of ``repro.serve.scheduler`` (pure host logic, unchanged).  The
scheduler runs between decode steps: admit requests from a FIFO queue into
free slots (allocating their first pages), stream prompt tokens through the
decode path one per step (chunked prefill, width 1 — one step function for
prefill and decode), and retire finished sequences immediately, recycling
their pages for the next request in the queue.

Two policies make the paper-style A/B measurable:

* ``continuous`` — admit whenever a slot and pages are free (in-flight
  batching).  A finished short request's slot turns around on the next
  step even while a long request keeps decoding.
* ``static`` — the classic baseline: admit a full batch only when *every*
  slot is free, then run until the whole batch finishes.  One long
  sequence holds the other slots hostage; on a mixed-length trace this is
  the ≥ 2× throughput gap the acceptance bar asks for.

Accounting: a request needs ``prompt_len + decode_len - 1`` steps (the step
feeding the last prompt token yields the first generated token); every step
at or past the prompt produces one token.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass

import numpy as np

from repro_torch.obs import NULL_OBS


@dataclass(frozen=True)
class Request:
    rid: int
    prompt_len: int
    decode_len: int

    def __post_init__(self):
        if self.prompt_len < 1 or self.decode_len < 1:
            raise ValueError(f"request {self.rid}: prompt_len and decode_len "
                             f"must be >= 1")

    @property
    def total_steps(self) -> int:
        return self.prompt_len + self.decode_len - 1

    @property
    def total_tokens(self) -> int:
        """KV positions the request occupies (sizing / can_admit)."""
        return self.prompt_len + self.decode_len


def mixed_trace(groups: int = 4, slots: int = 4, long_len: int = 64,
                short_len: int = 4, prompt_len: int = 1) -> list[Request]:
    """Mixed-length synthetic trace: each group is one long request followed
    by ``slots - 1`` short ones, so a static batch is forced to pair every
    long sequence with shorts it will hold hostage."""
    reqs: list[Request] = []
    rid = 0
    for _ in range(groups):
        reqs.append(Request(rid, prompt_len, long_len))
        rid += 1
        for _ in range(slots - 1):
            reqs.append(Request(rid, prompt_len, short_len))
            rid += 1
    return reqs


class ServeScheduler:
    """Drives a :class:`~repro_torch.serve.engine.PagedDecodeEngine` over a
    request trace under one of the two batching policies."""

    def __init__(self, engine, policy: str = "continuous", obs=None):
        if policy not in ("continuous", "static"):
            raise ValueError(f"policy must be continuous|static, "
                             f"got {policy!r}")
        self.engine = engine
        self.policy = policy
        # default to the engine's obs so one handle instruments the pair
        self.obs = obs if obs is not None \
            else getattr(engine, "obs", NULL_OBS)

    def _admit(self, queue: deque, slot_req: list, fed: np.ndarray) -> None:
        eng = self.engine
        if self.policy == "static" and eng.slot_valid.any():
            return                      # static: wait for the whole batch
        while queue and eng.can_admit(queue[0].total_tokens) :
            req = queue.popleft()
            slot = eng.free_slots()[0]
            eng.admit(slot)
            slot_req[slot] = req
            fed[slot] = 0

    def run(self, params, requests: list[Request], *,
            max_steps: int = 100_000) -> dict:
        """Process every request; returns throughput stats (tokens are
        *generated* tokens — prompt streaming is overhead, not output)."""
        eng = self.engine
        obs = self.obs
        vocab = eng.model.cfg.vocab_size
        s = eng.plan.max_seqs
        queue = deque(requests)
        slot_req: list[Request | None] = [None] * s
        fed = np.zeros((s,), np.int64)
        generated = np.zeros((s,), np.int64)
        steps = total_generated = total_prefill = 0
        live_sum = 0
        t_run = time.time()

        while queue or eng.slot_valid.any():
            self._admit(queue, slot_req, fed)
            obs.gauge("queue_depth", len(queue), policy=self.policy)
            live = np.nonzero(eng.slot_valid)[0]
            if live.size == 0:
                obs.counter("serve_stall", reason="arena_too_small")
                obs.event("serve_stall", reason="arena_too_small",
                          queued=len(queue),
                          need_tokens=queue[0].total_tokens,
                          pages_free=eng.allocator.n_free,
                          pages_total=eng.allocator.n_total)
                raise RuntimeError(
                    f"scheduler stalled with {len(queue)} queued requests: "
                    f"request needs {queue[0].total_tokens} tokens but the "
                    f"arena cannot ever fit it (free pages "
                    f"{eng.allocator.n_free}/{eng.allocator.n_total})")
            if steps >= max_steps:
                obs.counter("serve_stall", reason="max_steps")
                obs.event("serve_stall", reason="max_steps",
                          max_steps=max_steps, queued=len(queue))
                raise RuntimeError(f"exceeded max_steps={max_steps}")
            # deterministic synthetic token stream (rid-keyed): the engine's
            # numerics are pinned elsewhere; the scheduler measures steps
            token = np.zeros((s,), np.int32)
            for sl in live:
                r = slot_req[sl]
                token[sl] = (r.rid * 7 + int(fed[sl])) % vocab
            with obs.span("decode_step", policy=self.policy):
                eng.decode(params, token)
            steps += 1
            live_sum += int(live.size)
            for sl in live:
                r = slot_req[sl]
                fed[sl] += 1
                if fed[sl] >= r.prompt_len:
                    generated[sl] += 1
                    total_generated += 1
                else:
                    total_prefill += 1
                if generated[sl] >= r.decode_len:
                    eng.retire(int(sl))
                    slot_req[sl] = None
                    generated[sl] = 0

        wall = time.time() - t_run
        obs.gauge("tokens_per_step", total_generated / max(steps, 1),
                  policy=self.policy)
        obs.gauge("tokens_per_sec", total_generated / max(wall, 1e-9),
                  policy=self.policy)
        obs.gauge("mean_live_slots", live_sum / max(steps, 1),
                  policy=self.policy)
        obs.event("serve_done", policy=self.policy, steps=steps,
                  generated_tokens=total_generated, wall_s=wall,
                  n_requests=len(requests))
        return {
            "policy": self.policy,
            "n_requests": len(requests),
            "steps": steps,
            "generated_tokens": total_generated,
            "prefill_steps": total_prefill,
            "tokens_per_step": total_generated / max(steps, 1),
            "mean_live_slots": live_sum / max(steps, 1),
        }
