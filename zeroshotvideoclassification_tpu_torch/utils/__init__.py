"""Utilities: metrics logging and timers (GIF sample dumps: utils.gif)."""

from zeroshotvideoclassification_tpu_torch.utils.logging import (
    MetricsLogger,
    Timer,
)
