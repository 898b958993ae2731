"""mixtral-8x7b [moe]: 8 experts top-2 on every layer, sliding-window
attention.  Experts are TP-sharded (8 experts < model axis).  [arXiv:2401.04088]"""

from repro_torch.configs.base import AttnConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    d_ff=0,                        # all layers are MoE
    vocab_size=32000,
    attn=AttnConfig(num_heads=32, num_kv_heads=8, head_dim=128,
                    window=4096, rope_theta=1_000_000.0),
    moe=MoEConfig(num_experts=8, top_k=2, expert_ff=14336,
                  interleave_step=1, capacity_factor=1.25, parallelism="tp"),
    sharding="fsdp",
)
