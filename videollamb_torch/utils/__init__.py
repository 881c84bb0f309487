from videollamb_torch.utils.logging import build_logger, rank0_print  # noqa: F401
