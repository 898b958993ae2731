from repro_torch.sharding.rules import (batch_spec, decode_state_specs,
                                        global_from_shards, local_shard,
                                        param_specs)

__all__ = ["batch_spec", "decode_state_specs", "global_from_shards",
           "local_shard", "param_specs"]
