"""Checkpoints of the training path (``ckpt.Checkpointer``)."""
