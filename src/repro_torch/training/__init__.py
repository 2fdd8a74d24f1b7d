"""Training substrate (the port of ``repro.training``): optimizer, step,
synthetic data, checkpointing, resilience, gradient compression."""
from repro_torch.training.checkpoint import (  # noqa: F401
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.training.data import DataConfig, SyntheticLM  # noqa: F401
from repro_torch.training.optimizer import (  # noqa: F401
    AdamWState,
    OptimizerConfig,
    adamw_update,
    init_optimizer,
    lr_schedule,
)
from repro_torch.training.resilience import (  # noqa: F401
    StragglerDetector,
    SupervisorConfig,
    TrainingSupervisor,
)
from repro_torch.training.train_loop import (  # noqa: F401
    cross_entropy,
    loss_fn,
    make_train_step,
    train_step,
)
