from mvlpt_torch.train.optim import build_lr_schedule, build_optimizer
from mvlpt_torch.train.train_step import (
    TrainState,
    accuracy,
    init_train_state,
    make_cached_text_eval,
    make_eval_step,
    make_train_step,
    soft_cross_entropy,
)
