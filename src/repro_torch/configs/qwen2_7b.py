"""qwen2-7b [dense]: GQA with QKV bias.  [arXiv:2407.10671; hf]"""

from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    d_ff=18944,
    vocab_size=152064,
    attn=AttnConfig(num_heads=28, num_kv_heads=4, head_dim=128,
                    qkv_bias=True, rope_theta=1_000_000.0),
    sharding="fsdp",
)
