from mvlpt_torch.train.optim import build_device_sgd, build_lr_schedule, build_optimizer
from mvlpt_torch.train.train_step import (
    TrainState,
    WindowState,
    accuracy,
    init_train_state,
    init_window_state,
    make_cached_text_eval,
    make_eval_step,
    make_train_step,
    make_train_step_multi,
    soft_cross_entropy,
)
