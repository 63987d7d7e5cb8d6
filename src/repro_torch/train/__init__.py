"""Training and serving steps, data, the optimizer and checkpoints
(counterpart of ``repro.train``): ``data`` (synthetic and packed-shard
batches), ``optimizer`` (AdamW in place), ``train_step`` (the NaN-guarded
step with accumulation and compression), ``checkpoint`` (atomic and
asynchronous saves), ``serve_step`` (greedy generation)."""
from repro_torch.train.checkpoint import AsyncCheckpointer
from repro_torch.train.data import (PackedShardDataset, SyntheticLMDataset,
                                    write_packed_shards)
from repro_torch.train.optimizer import (OptConfig, PartialUpdateError,
                                         adamw_update, global_norm,
                                         init_opt_state, lr_at)
from repro_torch.train.train_step import init_comp_state, make_train_step

__all__ = [
    "AsyncCheckpointer", "OptConfig", "PackedShardDataset",
    "PartialUpdateError", "SyntheticLMDataset", "adamw_update",
    "global_norm", "init_comp_state", "init_opt_state", "lr_at",
    "make_train_step", "write_packed_shards",
]
