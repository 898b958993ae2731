"""llama4-maverick-400b-a17b [moe]: 128-expert top-1 MoE on alternating
layers with a shared expert; iRoPE-style chunked-local attention (8192)
with a global layer every 4th; early-fusion modality is out of scope
(text backbone per assignment).  [hf:meta-llama/Llama-4-*; unverified]"""

from repro_torch.configs.base import AttnConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    d_ff=16384,                    # dense (non-MoE) layers
    vocab_size=202048,
    attn=AttnConfig(num_heads=40, num_kv_heads=8, head_dim=128,
                    chunk=8192, global_every=4, rope_theta=500_000.0),
    moe=MoEConfig(num_experts=128, top_k=1, expert_ff=8192,
                  shared_expert_ff=8192, interleave_step=2,
                  capacity_factor=1.25, parallelism="ep"),
    sharding="fsdp",
)
