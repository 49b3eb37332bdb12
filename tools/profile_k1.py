#!/usr/bin/env python3
"""Where K1 and K4 (one kernel template, csrc/video_transform.cu) spend
their time, on one GPU, found by taking parts out, as tools/profile_k3.py
does for K3: the source is
compiled several times, each time with parts of the kernel switched off by
macros that this script writes into a copy of it, and every variant's
launch alone is timed on the same tensors (a run of 20 launches between two
CUDA events, median of 5):

    python tools/profile_k1.py [--json PATH]

  base         the kernel as it is
  no_compute   no pixel is computed (the tile is written as it lies)
  no_stage     no source row is copied into shared memory
  no_store     the tile is not written out
  only_stage, only_compute, only_store, nothing
               the kernel with only that part, or none, left (the taps are
               always loaded and the span always found)

The variants compute wrong results on purpose; only `base` is checked
against the wrapper's output. What a part costs is base minus the variant
without it; what it costs alone is its `only_` variant minus `nothing`.
Inputs: K1 on tools/profile_kernels.py's serving batch at bucket 8 and
16-clip training batch, K4 on the SUN path's batch (chip_smoke.
sun_motion_args: 16 images, 16 frames each), bf16 out. Needs nvcc and
prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (text of the source, what replaces it): each must be found exactly once
SWITCHES = [
    ("  if (g >= groups) return;\n",
     "  if (g >= groups) return;\n#ifdef EXP_NO_COMPUTE\n  return;\n#endif\n"),
    ("                                          size_t nbytes) {\n",
     "                                          size_t nbytes) {\n"
     "#ifdef EXP_NO_STAGE\n  return;\n#endif\n"),
    ("                                           size_t n) {\n",
     "                                           size_t n) {\n"
     "#ifdef EXP_NO_STORE\n  return;\n#endif\n"),
]
_ALL = ["NO_COMPUTE", "NO_STAGE", "NO_STORE"]
VARIANTS = {
    "base": [], "no_compute": ["NO_COMPUTE"], "no_stage": ["NO_STAGE"],
    "no_store": ["NO_STORE"],
    "only_stage": [m for m in _ALL if m != "NO_STAGE"],
    "only_compute": [m for m in _ALL if m != "NO_COMPUTE"],
    "only_store": [m for m in _ALL if m != "NO_STORE"],
    "nothing": _ALL,
}


def switched_source():
    from zeroshotvideoclassification_tpu_torch import _build

    text = (_build.CSRC / "video_transform.cu").read_text()
    for old, new in SWITCHES:
        if text.count(old) != 1:
            raise RuntimeError(f"the source no longer has exactly one "
                               f"{old!r}: bring SWITCHES up to date")
        text = text.replace(old, new)
    return text


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests"),
                    os.path.join(ROOT, "tools")]
    import torch

    if not torch.cuda.is_available():
        print("profile_k1: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from chip_smoke import sun_motion_args
    from profile_kernels import RUN, event_ms, k1_batches
    from zeroshotvideoclassification_tpu_torch import _build
    from zeroshotvideoclassification_tpu_torch.data.stillimages import (
        CH_OFFSET,
        CH_SCALE,
    )
    from zeroshotvideoclassification_tpu_torch.ops import resample_cuda as rc
    from zeroshotvideoclassification_tpu_torch.ops.resample import (
        channel_affine,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()
    print(smi, flush=True)
    record = {"nvidia_smi": smi, "batches": {}}
    entries = ("zsvc_video_transform_bf16", "zsvc_image_motion_transform_bf16")
    with tempfile.TemporaryDirectory(prefix="profile_k1_") as tmp:
        src = os.path.join(tmp, "video_transform_switched.cu")
        with open(src, "w") as f:
            f.write(switched_source())
        flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
        procs = {}
        for name, macros in VARIANTS.items():  # all variants at once
            cmd = [_build.nvcc_path(), *flags, "-shared",
                   *[f"-DEXP_{m}" for m in macros], "-o",
                   os.path.join(tmp, f"{name}.so"), src]
            procs[name] = subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                           stderr=subprocess.PIPE, text=True)
        for name, proc in procs.items():
            err = proc.communicate()[1]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{err[-3000:]}")
        fns = {entry: {} for entry in entries}
        for name in VARIANTS:
            lib = ctypes.CDLL(os.path.join(tmp, f"{name}.so"))
            for entry in entries:
                fn = getattr(lib, entry)
                fn.argtypes = _build.SIGNATURES[entry]
                fn.restype = ctypes.c_int
                fns[entry][name] = fn
        dev = torch.device("cuda")
        stream = torch.cuda.current_stream().cuda_stream
        cases = []  # (batch, entry, operands, affine, the wrapper's output)
        for batch, k1_args in k1_batches(tmp, dev).items():
            cases.append((f"K1 {batch}", entries[0], k1_args, (),
                          rc.fused_video_transform_cuda(
                              *k1_args, out_dtype=torch.bfloat16)))
        k4_args = sun_motion_args(dev)
        scale, offset = channel_affine(CH_SCALE, CH_OFFSET)
        cases.append(("K4 SUN batch", entries[1], k4_args,
                      (*map(float, scale), *map(float, offset)),
                      rc.fused_image_motion_transform_cuda(
                          *k4_args, CH_SCALE, CH_OFFSET, torch.bfloat16)))
        for batch, entry, args_, affine, want in cases:
            b, t, s = want.shape[:3]
            hc, wc = args_[0].shape[-3:-1]  # canvas or images: [..., H, W, 3]
            plan = rc.transform_plan(b, t, hc, wc, s, 2)
            out = torch.empty_like(want)

            def call(fn):
                err = fn(*(a.data_ptr() for a in args_), out.data_ptr(),
                         *affine, b, t, hc, wc, s, plan["band_rows"],
                         plan["stage_rows"], plan["threads"],
                         plan["smem_bytes"], stream)
                _build.check(err, f"{entry} variant")

            call(fns[entry]["base"])
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise RuntimeError(f"base variant is wrong on {batch}")
            ms = {k: event_ms(lambda f=f: call(f), RUN, 5)
                  for k, f in fns[entry].items()}
            record["batches"][batch] = {"shape": list(args_[0].shape),
                                        "plan": plan, "ms": ms}
            print(f"[parts] {batch}: "
                  + "  ".join(f"{k} {v:.4f}" for k, v in ms.items())
                  + f" ms  ({smi})", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
