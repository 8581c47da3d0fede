"""Data pipelines of the training path (``pipeline``)."""
