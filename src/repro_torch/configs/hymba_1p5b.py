"""hymba-1.5b [hybrid]: parallel attention + Mamba heads per layer; SWA on
all but three global-attention layers (first/middle/last); meta-tokens are
out of scope (noted in DESIGN.md).  [arXiv:2411.13676; hf]"""

from repro_torch.configs.base import AttnConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    d_ff=5504,
    vocab_size=32001,
    attn=AttnConfig(num_heads=25, num_kv_heads=5, head_dim=64,
                    window=1024, global_layers=(0, 15, 31)),
    ssm=SSMConfig(state_dim=16, conv_width=4, expand=2),
    sharding="tp",
)
