"""Training layer (so far the inference step and the checkpoint reader)."""

from zeroshotvideoclassification_tpu_torch.train.checkpoint import (
    load_checkpoint,
    read_checkpoint,
)
from zeroshotvideoclassification_tpu_torch.train.step import eval_step
