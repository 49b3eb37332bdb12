"""Utilities: metrics logging and timers."""

from zeroshotvideoclassification_tpu_torch.utils.logging import (
    MetricsLogger,
    Timer,
)
