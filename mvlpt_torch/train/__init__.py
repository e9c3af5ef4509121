from mvlpt_torch.train.optim import (
    DeviceOptimizer,
    build_device_optimizer,
    build_lr_schedule,
    device_update_,
)
from mvlpt_torch.train.train_step import (
    WindowState,
    accuracy,
    init_train_state,
    make_cached_text_eval,
    make_eval_step,
    make_train_step,
    make_train_step_multi,
    soft_cross_entropy,
)
