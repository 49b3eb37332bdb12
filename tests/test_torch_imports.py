"""Import hygiene of the PyTorch port: every module imports; none of them
imports JAX or anything of the JAX package (proved in a subprocess where
`import jax` and `import zeroshotvideoclassification_tpu` fail, in which the
port also classifies a clip); importing builds no CUDA kernel; and no source
file of the port names the JAX package in an import."""

import importlib
import os
import pkgutil
import re
import subprocess
import sys

import pytest

import zeroshotvideoclassification_tpu_torch as port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCK = """
import sys
for name in ("jax", "jaxlib", "zeroshotvideoclassification_tpu"):
    sys.modules[name] = None      # any such import now raises ImportError
"""
UNBLOCKED = """
for name in ("jax", "jaxlib", "zeroshotvideoclassification_tpu"):
    assert sys.modules[name] is None
    assert not [k for k in sys.modules if k.startswith(name + ".")], name
"""


def _all_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        port.__path__, port.__name__ + "."))


def _run(code, timeout=600):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_every_port_module_imports():
    mods = _all_modules()
    for name in ("config", "_build", "ops.resample", "ops.resample_cuda",
                 "ops.bn_cuda", "ops.cdist", "ops.temporal_conv",
                 "eval.zeroshot", "models.layers", "models.c3d",
                 "models.resnet3d", "models.heads", "models.bridge",
                 "train.checkpoint", "train.async_ckpt", "train.step",
                 "train.optimizer", "utils.profiler",
                 "data.pipeline", "data.datasets", "data.decode",
                 "data.native_decode", "data.sampling", "data.synthetic",
                 "data.stillimages", "data.transform_params",
                 "text.word2vec", "text.class_names", "text.filters",
                 "text.lemma", "utils.logging", "serve.batcher",
                 "serve.server", "serve.engine", "cli.infer", "cli.serve",
                 "cli.main", "parallel.mesh", "parallel.multihost"):
        assert f"{port.__name__}.{name}" in mods, name
    for name in mods:
        importlib.import_module(name)


def test_port_imports_no_jax_nothing_of_the_jax_package_and_builds_nothing():
    code = BLOCK + """
import importlib, pkgutil
import zeroshotvideoclassification_tpu_torch as port
names = sorted(m.name for m in pkgutil.walk_packages(
    port.__path__, port.__name__ + "."))
for n in names:
    importlib.import_module(n)
from zeroshotvideoclassification_tpu_torch import _build
from zeroshotvideoclassification_tpu_torch.cli import main, serve
assert _build._lib is None, "importing the port loaded the kernel library"
assert "triton" not in sys.modules
assert main.build_arg_parser().parse_args([]).device == "cuda"
assert serve.build_arg_parser().parse_args([]).device == "cuda"
from zeroshotvideoclassification_tpu_torch.text.lemma import verbs2basicform
assert verbs2basicform(["riding", "horses"])[0] == "ride"
# the evaluation, the temporal conv op and the image-motion transform run
# (their plain versions, on the CPU) and still load no kernel library
import numpy as np, torch
from zeroshotvideoclassification_tpu_torch.eval.zeroshot import (
    compute_accuracy)
from zeroshotvideoclassification_tpu_torch.ops.temporal_conv import (
    temporal_conv3)
from zeroshotvideoclassification_tpu_torch.ops.resample_cuda import (
    image_motion_transform)
e = np.eye(6, 300, dtype=np.float32)
assert compute_accuracy(e, e, e) == (100.0, 100.0)
y = temporal_conv3(torch.ones(1, 3, 2, 2, 4), torch.ones(3, 1, 1, 4, 5),
                   torch.float32)
assert y.shape == (1, 3, 2, 2, 5) and float(y[0, 1, 0, 0, 0]) == 12.0
z = torch.zeros(1, 2, 8, dtype=torch.int32)
x = image_motion_transform(torch.full((1, 9, 9, 3), 255, dtype=torch.uint8),
                           z, z, z.float(), z, z, z.float(), [2.0] * 3,
                           [1.0] * 3)
assert x.shape == (1, 2, 8, 8, 3) and float(x.min()) == 511.0
assert _build._lib is None
""" + UNBLOCKED + """
print("OK", len(names))
"""
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK")


def test_port_classifies_a_clip_without_the_jax_package(tmp_path):
    """cli.infer end to end on the CPU (decode, pack, transform, model,
    ranking) with JAX and the JAX package unimportable."""
    clip = tmp_path / "clip.npy"
    code = BLOCK + f"""
import json
import numpy as np
np.save({str(clip)!r}, np.random.default_rng(0).integers(
    0, 256, (12, 48, 64, 3), dtype=np.uint8))
from zeroshotvideoclassification_tpu_torch.cli import infer
res = infer.main(["--videos", {str(clip)!r}, "--classes", "playing guitar",
                  "riding a horse", "--synthetic_word2vec", "--device",
                  "cpu", "--n_clips", "1", "--clip_len", "4", "--size", "32",
                  "--compute_dtype", "float32"])
assert len(res) == 1 and res[0]["top_class"] in ("playing guitar",
                                                 "riding a horse")
assert len(res[0]["topk"]) == 2
""" + UNBLOCKED + """
print("OK")
"""
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("OK")


def _sources():
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "tools", "profile_serve.py"),
             os.path.join(ROOT, "tools", "profile_train.py"),
             os.path.join(ROOT, "tools", "profile_k3.py"),
             os.path.join(ROOT, "tools", "profile_kernels.py"),
             os.path.join(ROOT, "tools", "profile_k1.py"),
             os.path.join(ROOT, "tools", "zsl32_resume.py"),
             os.path.join(ROOT, "tools", "profile_dp.py"),
             os.path.join(ROOT, "tools", "dp_phases.py"),
             os.path.join(ROOT, "tools", "graph_phase.py")]
    for d, _, names in os.walk(os.path.dirname(port.__file__)):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


@pytest.mark.parametrize("path", [os.path.relpath(p, ROOT)
                                  for p in _sources()])
def test_no_source_imports_the_jax_package(path):
    """No `import` / `from` line of the port, chip_smoke.py or
    tools/profile_{serve,train,k3,kernels,k1,dp}.py, tools/dp_phases.py,
    tools/graph_phase.py or tools/zsl32_resume.py names jax or
    zeroshotvideoclassification_tpu
    (without _torch), nor does an importlib / __import__ call."""
    bad = re.compile(
        r"^\s*(from|import)\s+(jax|jaxlib|zeroshotvideoclassification_tpu)"
        r"(\.|\s|$)"
        r"|(import_module|__import__)\(\s*[\"'](jax|jaxlib|"
        r"zeroshotvideoclassification_tpu)[\"'.]")
    with open(os.path.join(ROOT, path)) as f:
        hits = [f"{path}:{i}: {line.rstrip()}"
                for i, line in enumerate(f, 1) if bad.search(line)]
    assert not hits, hits


def test_sources_cover_the_whole_port():
    rel = [os.path.relpath(p, ROOT) for p in _sources()]
    assert "chip_smoke.py" in rel and len(rel) > 40
    for sub in (("cli", "main.py"), ("eval", "zeroshot.py"),
                ("ops", "temporal_conv.py"), ("ops", "resample_cuda.py"),
                ("models", "c3d.py"), ("parallel", "mesh.py"),
                ("parallel", "multihost.py")):
        assert os.path.join("zeroshotvideoclassification_tpu_torch",
                            *sub) in rel, sub


def test_kernel_sources_ship_with_the_package():
    from zeroshotvideoclassification_tpu_torch import _build

    names = {p.name for p in _build.sources()}
    # K1 and K4 are one kernel template in video_transform.cu
    assert names == {"video_transform.cu", "bn_apply_relu.cu",
                     "temporal_conv.cu", "bn_stats.cu"}
    # the BN kernels' shared header is part of the build's hash
    assert {p.name for p in _build.headers()} == {"bn_common.cuh"}
    # every C entry point the wrappers call is declared with its argtypes
    text = "".join(p.read_text() for p in _build.sources() + _build.headers())
    for fn in _build.SIGNATURES:
        assert f'extern "C" int {fn}(' in text, fn
    assert {"zsvc_bn_bwd_f32", "zsvc_bn_bwd_bf16", "zsvc_bn_apply_relu_f32",
            "zsvc_bn_apply_relu_bf16", "zsvc_video_transform_f32",
            "zsvc_video_transform_bf16", "zsvc_image_motion_transform_f32",
            "zsvc_image_motion_transform_bf16", "zsvc_temporal_conv3_f32",
            "zsvc_temporal_conv3_bf16", "zsvc_bn_sums_f32",
            "zsvc_bn_sums_bf16", "zsvc_bn_sums_grad_f32",
            "zsvc_bn_sums_grad_bf16", "zsvc_bn_moments",
            "zsvc_bn_moments_grad"} == set(_build.SIGNATURES)
    # the sums are deterministic: no float atomics in any kernel
    assert "atomicAdd" not in text


def test_vendored_wordnet_data_ships_with_the_port():
    d = os.path.join(os.path.dirname(port.__file__), "text", "wordnet_verbs")
    ref = os.path.join(ROOT, "zeroshotvideoclassification_tpu", "text",
                       "wordnet_verbs")
    for name in ("verb.exc", "index.verb.lemmas"):
        with open(os.path.join(d, name), "rb") as a, open(
                os.path.join(ref, name), "rb") as b:
            assert a.read() == b.read(), name
