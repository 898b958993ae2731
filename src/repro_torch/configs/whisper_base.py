"""whisper-base [audio]: encoder-decoder backbone; the conv/mel frontend is
a stub per assignment (``input_specs`` provides 1500 precomputed frame
embeddings).  decode_32k is exercised mechanically though the real model
caps at 448 positions (DESIGN.md).  [arXiv:2212.04356; unverified]"""

from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    num_layers=6,                  # decoder layers
    enc_layers=6,
    enc_seq=1500,
    d_model=512,
    d_ff=2048,
    vocab_size=51865,
    attn=AttnConfig(num_heads=8, num_kv_heads=8, head_dim=64),
    frontend="audio_stub",
    sharding="tp",
)
