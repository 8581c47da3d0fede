"""Serving: prefill/decode steps and a batched generation engine."""
