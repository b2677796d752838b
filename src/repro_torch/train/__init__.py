"""``repro_torch.train`` — the trainer, port of ``repro.train``: AdamW
(:mod:`.optim`, in place), the LR schedule and the train step on
any ('data', 'model') mesh."""
from repro_torch.train.optim import adamw_init, adamw_update, opt_axes
from repro_torch.train.schedule import warmup_cosine
from repro_torch.train.trainstep import batch_shardings, jit_train_step, make_train_step

__all__ = ['adamw_init', 'adamw_update', 'batch_shardings', 'jit_train_step', 'make_train_step',
           'opt_axes', 'warmup_cosine']
