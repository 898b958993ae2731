"""falcon-mamba-7b [ssm]: attention-free Mamba-1 stack (64 blocks,
d_inner = 2*4096, state 16).  [arXiv:2410.05355; unverified]"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    d_ff=0,                        # no MLP sublayer: pure Mamba blocks
    vocab_size=65024,
    ssm=SSMConfig(state_dim=16, conv_width=4, expand=2),
    sharding="fsdp",
)
