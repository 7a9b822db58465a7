"""repro_torch.train — optimizer + training step (the counterpart of
``repro.train``)."""

from repro_torch.train.optim import adamw_init, adamw_update, cosine_lr, linear_warmup_lr
from repro_torch.train.step import init_train_state, make_train_step

__all__ = ["adamw_init", "adamw_update", "cosine_lr", "linear_warmup_lr",
           "init_train_state", "make_train_step"]
