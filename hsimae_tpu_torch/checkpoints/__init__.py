from hsimae_tpu_torch.checkpoints.io import (
    save_checkpoint,
    latest_checkpoint,
    restore_checkpoint,
    save_params,
    partial_restore,
)
from hsimae_tpu_torch.checkpoints.msgpack_io import load_params
from hsimae_tpu_torch.checkpoints.async_io import AsyncCheckpointer
from hsimae_tpu_torch.checkpoints.convert import from_jax_params, load_torch_checkpoint

__all__ = [
    "save_checkpoint",
    "latest_checkpoint",
    "restore_checkpoint",
    "save_params",
    "load_params",
    "partial_restore",
    "AsyncCheckpointer",
    "load_torch_checkpoint",
    "from_jax_params",
]
