"""Import hygiene of the PyTorch port: every module imports, none of them
imports JAX (proved in a subprocess where `import jax` fails), and importing
builds no CUDA kernel."""

import importlib
import os
import pkgutil
import subprocess
import sys

import zeroshotvideoclassification_tpu_torch as port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _all_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        port.__path__, port.__name__ + "."))


def test_every_port_module_imports():
    mods = _all_modules()
    # the 15 ported modules + _build + package inits
    for name in ("config", "_build", "ops.resample", "ops.resample_cuda",
                 "ops.bn_cuda", "ops.cdist", "models.layers",
                 "models.resnet3d", "models.heads", "models.bridge",
                 "train.checkpoint", "train.step", "data.pipeline",
                 "cli.infer", "cli.serve", "serve.engine"):
        assert f"{port.__name__}.{name}" in mods, name
    for name in mods:
        importlib.import_module(name)


def test_port_imports_no_jax_and_builds_nothing():
    code = f"""
import sys
sys.modules["jax"] = None      # any `import jax` now raises ImportError
sys.modules["jaxlib"] = None
import importlib, pkgutil
import zeroshotvideoclassification_tpu_torch as port
names = sorted(m.name for m in pkgutil.walk_packages(
    port.__path__, port.__name__ + "."))
for n in names:
    importlib.import_module(n)
from zeroshotvideoclassification_tpu_torch import _build
assert _build._lib is None, "importing the port loaded the kernel library"
assert "triton" not in sys.modules
print("OK", len(names))
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK")


def test_kernel_sources_ship_with_the_package():
    from zeroshotvideoclassification_tpu_torch import _build

    names = {p.name for p in _build.sources()}
    assert names == {"video_transform.cu", "bn_apply_relu.cu"}
    # every C entry point the wrappers call is declared with its argtypes
    text = "".join(p.read_text() for p in _build.sources())
    for fn in _build.SIGNATURES:
        assert f'extern "C" int {fn}(' in text, fn
