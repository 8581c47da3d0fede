"""Config registry of the port: importing this package registers the 10
architectures of the reference (``repro/configs``), field for field. The
xLSTM, vision and audio families are registered as data; ``LM`` raises for
them until they are ported (ROADMAP.md)."""
from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    get_config,
    list_archs,
    reduce_config,
    register,
)

# side-effect registration of the 10 architectures
from repro_torch.configs import (  # noqa: F401,E402
    qwen3_32b,
    qwen3_8b,
    granite_34b,
    internlm2_1_8b,
    deepseek_v3_671b,
    moonshot_v1_16b_a3b,
    hymba_1_5b,
    xlstm_125m,
    phi3_vision_4_2b,
    musicgen_medium,
)

ALL_ARCHS = list_archs()
