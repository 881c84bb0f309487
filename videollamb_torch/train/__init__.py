"""Training: the step, data, checkpoints, the trainer and the CLI (port of
``videollamb_tpu/train``)."""

from videollamb_torch.train.step import (  # noqa: F401
    TrainState,
    create_optimizer,
    create_train_state,
    make_train_step,
)
