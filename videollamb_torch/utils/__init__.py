from videollamb_torch.utils.logging import build_logger, rank0_print  # noqa: F401
from videollamb_torch.utils.profiling import StageTimer, profile_trace  # noqa: F401
