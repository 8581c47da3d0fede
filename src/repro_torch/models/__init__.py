"""Language models of the port: every registered architecture (the dense,
MoE, hybrid, xLSTM, vision and audio families)."""
from repro_torch.models.lm import LM, Segment, build_plan  # noqa: F401
