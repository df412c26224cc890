"""Checkpoints in the reference's msgpack format (``repro.checkpoint``)."""
from repro_torch.checkpoint.msgpack_ckpt import load_checkpoint, save_checkpoint

__all__ = ["load_checkpoint", "save_checkpoint"]
