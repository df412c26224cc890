"""Checkpoints in the reference's msgpack format (``repro.checkpoint``)."""
from repro_torch.checkpoint.msgpack_ckpt import (load_checkpoint, load_state_,
                                                 save_checkpoint, save_state)

__all__ = ["load_checkpoint", "load_state_", "save_checkpoint", "save_state"]
