"""Training programs of the port: the train step (with microbatching), the
loss and eval steps, and the compressed DDP steps."""
from repro_torch.train.step import (  # noqa: F401
    make_eval_step, make_loss_fn, make_train_step,
)
from repro_torch.train.ddp import make_ddp_steps  # noqa: F401
