from repro_torch.data.synthetic import DataConfig, SyntheticTokens

__all__ = ["DataConfig", "SyntheticTokens"]
