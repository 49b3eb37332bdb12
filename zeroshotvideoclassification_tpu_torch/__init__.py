"""zeroshotvideoclassification_tpu_torch — the PyTorch/CUDA port of
zeroshotvideoclassification_tpu, for one NVIDIA Hopper GPU.

The module paths mirror the JAX package, so each counterpart is found at the
same place:

  config.py        compute/transform dtype names -> torch dtypes
  ops/             the hand-written CUDA kernels (csrc/) behind their wrappers,
                   each beside its plain PyTorch version; cosine distances
  models/          R(2+1)D-18 as nn.Modules with torchvision key names, the
                   zero-shot head, and the bridge from JAX pytrees
  train/           the npz checkpoint reader and the inference step
  data/            host batch -> device batch (the host pipeline is shared)
  serve/, cli/     the inference engine and the `serve` entry point

Host-side code (decoding, canvas packing, class-name embedding, the
micro-batcher and the HTTP server) is imported from the JAX package, none of
whose host modules imports JAX. Nothing here imports JAX.
"""

__version__ = "0.1.0"
