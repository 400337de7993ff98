from repro_torch.checkpoint.streaming_ckpt import (
    iter_checkpoint,
    latest_server_state,
    load_checkpoint,
    load_checkpoint_streaming,
    save_checkpoint,
    save_server_state,
)

__all__ = [
    "save_checkpoint",
    "iter_checkpoint",
    "load_checkpoint",
    "load_checkpoint_streaming",
    "save_server_state",
    "latest_server_state",
]
