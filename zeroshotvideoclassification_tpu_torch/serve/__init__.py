"""Serving front-end: the port's InferenceEngine behind a micro-batching
HTTP endpoint (MicroBatcher + a stdlib ThreadingHTTPServer, the port's own
copies of the JAX package's serve/batcher.py and serve/server.py). See
cli/serve.py for the command-line entry point."""

from zeroshotvideoclassification_tpu_torch.serve.batcher import MicroBatcher
from zeroshotvideoclassification_tpu_torch.serve.engine import InferenceEngine
from zeroshotvideoclassification_tpu_torch.serve.server import (
    ZeroShotService,
    serve_forever,
    start_server,
)
