"""Checkpoints of the port, in the reference's file format."""
from repro_torch.checkpoint.ckpt import restore_pytree, save_pytree  # noqa: F401
