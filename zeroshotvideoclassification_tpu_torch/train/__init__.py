"""Training layer: the train and inference steps, the guarded Adam with its
learning-rate schedule, and the checkpoint reader."""

from zeroshotvideoclassification_tpu_torch.train.checkpoint import (
    load_checkpoint,
    read_checkpoint,
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
