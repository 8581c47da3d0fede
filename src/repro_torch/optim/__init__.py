"""Optimizers of the training path (``adamw``)."""
