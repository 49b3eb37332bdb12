"""The configuration, and dtype names of Config -> torch.

The port uses the JAX package's Config as it is (that module imports no
JAX) and re-exports it here; only the lookup from a dtype name to a
framework dtype is framework-specific (JAX counterpart:
config.compute_jnp_dtype and data/pipeline.transform_out_dtype).
"""

from __future__ import annotations

import torch

from zeroshotvideoclassification_tpu.config import Config

__all__ = ["Config", "torch_dtype", "transform_dtype"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name: str) -> torch.dtype:
    """'bfloat16' | 'float32' -> the torch dtype; anything else raises."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype name {name!r} "
                         f"(choose bfloat16 or float32)") from None


def transform_dtype(config) -> torch.dtype:
    """Output dtype of the fused input transform: Config.transform_dtype,
    where 'auto' follows Config.compute_dtype."""
    name = getattr(config, "transform_dtype", "auto")
    if name == "auto":
        name = getattr(config, "compute_dtype", "float32")
    return torch_dtype(name)
