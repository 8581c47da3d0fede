"""Language models of the port: the dense, MoE and hybrid (hymba)
families."""
from repro_torch.models.lm import LM, Segment, build_plan  # noqa: F401
