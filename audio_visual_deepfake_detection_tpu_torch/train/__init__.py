from .checkpoint import (  # noqa: F401
    latest_epoch_path, restore_checkpoint, restore_params, save_checkpoint)
from .loop import pad_batch_to, train_one_epoch  # noqa: F401
from .meters import AverageMeter, MetricsLogger  # noqa: F401
from .optim import decay_names, make_optimizer, make_schedule  # noqa: F401
from .preempt import PreemptionGuard  # noqa: F401
from .state import TrainState, build_eval_forward, build_train_step, init_model  # noqa: F401
