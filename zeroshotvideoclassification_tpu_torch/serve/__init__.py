"""Serving: the port's InferenceEngine. The HTTP server (and its
micro-batcher) is the JAX package's zeroshotvideoclassification_tpu.serve,
which only duck-types the engine and imports no JAX; its entry points are
re-exported here."""

from zeroshotvideoclassification_tpu.serve.server import (
    serve_forever,
    start_server,
)
from zeroshotvideoclassification_tpu_torch.serve.engine import InferenceEngine
