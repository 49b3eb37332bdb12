"""Training layer: the train and inference steps, the guarded Adam with its
learning-rate schedule, and the checkpoints (the JAX package's npz layout;
train/async_ckpt.py writes them off the step loop)."""

from zeroshotvideoclassification_tpu_torch.train.checkpoint import (
    host_state,
    load_checkpoint,
    read_checkpoint,
    read_meta,
    save_checkpoint,
    warm_start,
)
from zeroshotvideoclassification_tpu_torch.train.optimizer import (
    GuardedAdam,
    make_optimizer,
    multistep_lr,
    set_lr,
)
from zeroshotvideoclassification_tpu_torch.train.step import (
    TrainState,
    eval_step,
    make_train_step,
    masked_mse,
)
