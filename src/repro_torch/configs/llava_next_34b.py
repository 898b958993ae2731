"""llava-next-34b [vlm]: anyres-tiled VLM; the assigned cell is the 34B
transformer BACKBONE — the vision tower is a stub (``input_specs`` provides
precomputed patch embeddings).  [hf:llava-hf/llava-v1.6-*; unverified]"""

from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    d_ff=20480,
    vocab_size=64000,
    attn=AttnConfig(num_heads=56, num_kv_heads=8, head_dim=128,
                    rope_theta=5_000_000.0),
    frontend="vision_stub",
    frontend_seq=576,            # one 24x24 anyres base tile of patch embeds
    sharding="fsdp",
)
