"""repro_torch.serve: continuous batching over a paged KV-cache arena, with
attention scored by the hand-written CUDA flash-decode kernel."""

from repro_torch.serve.engine import PagedDecodeEngine, build_paged_decode_step
from repro_torch.serve.kv import KVArenaPlan, KVPageAllocator, plan_kv_arena
from repro_torch.serve.scheduler import Request, ServeScheduler, mixed_trace

__all__ = ["KVArenaPlan", "KVPageAllocator", "plan_kv_arena",
           "PagedDecodeEngine", "build_paged_decode_step",
           "Request", "ServeScheduler", "mixed_trace"]
