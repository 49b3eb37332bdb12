"""zeroshotvideoclassification_tpu_torch — the PyTorch/CUDA port of
zeroshotvideoclassification_tpu, for one NVIDIA Hopper GPU.

The module paths mirror the JAX package, so each counterpart is found at the
same place:

  config.py        Config, its argument parser, dtype names -> torch dtypes
  ops/             the hand-written CUDA kernels (csrc/) behind their wrappers,
                   each beside its plain PyTorch version; cosine distances
  models/          R(2+1)D-18 as nn.Modules with torchvision key names, the
                   zero-shot head, and the bridge to and from JAX pytrees
  train/           the train and inference steps, the guarded Adam, the npz
                   checkpoint reader
  data/            datasets, decoders, the host pipeline, host batch -> device
  text/            class names -> word2vec embeddings
  serve/, cli/     the inference engine, micro-batcher and HTTP server; the
                   `main` (training), `infer` and `serve` entry points
  utils/           metrics logging and timers

The package stands alone: it imports torch and numpy, never JAX and nothing
of the JAX package. Its host side (decoding, canvas packing, class-name
embedding, the micro-batcher, the HTTP server, Config) is its own copy of
the JAX package's numpy-only modules, held byte for byte against them by
tests/test_torch_host.py.
"""

__version__ = "0.1.0"
