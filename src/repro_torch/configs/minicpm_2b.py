"""minicpm-2b [dense]: llama-like arch; trains with the WSD schedule
(wired in optim.schedules / launch.train).  [arXiv:2404.06395; hf]"""

from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    num_layers=40,
    d_model=2304,
    d_ff=5760,
    vocab_size=122753,
    attn=AttnConfig(num_heads=36, num_kv_heads=36, head_dim=64),
    tie_embeddings=True,
    sharding="tp",
)
