#!/usr/bin/env python3
"""Where K3's bf16 kernels (csrc/temporal_conv.cu) spend their time, on one
GPU, found by taking parts out: the machine this port is measured on has no
kernel profiler, so the source is compiled several times, each time with
one part of the main kernels switched off by a macro that this script
writes into a copy of the source, and every variant is timed on the same
tensors (CUDA events, median of 20):

    python tools/profile_k3.py [--json PATH]

  base        the kernel as it is
  no_store    the accumulators are not written to y
  no_mma      no wgmma runs (fences, commits and waits stay)
  no_add      a chain's result is not added to the total
  no_load     x is not copied by the threads' own cp.async or loads (tiles
              that come by TMA or by a bulk copy still do)
  no_w        W is not staged
  only_load / only_store / nothing
              the loop with only that part, or none, left

The variants compute wrong results on purpose; only `base` is checked
against the plain version. What a part costs is base minus the variant
without it; what it costs alone is its `only_` variant minus `nothing`.
F.conv3d (cuDNN) on the same tensors is timed beside them. Needs nvcc and
prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [((16, 16, 56, 56, 144), 64), ((16, 8, 28, 28, 230), 128),
          ((16, 16, 56, 56, 45), 64), ((16, 8, 28, 28, 288), 128),
          ((16, 4, 14, 14, 460), 256), ((16, 4, 14, 14, 576), 256),
          ((16, 2, 7, 7, 921), 512), ((16, 2, 7, 7, 1152), 512)]
# (text of the source, what replaces it): each must be found exactly once
SWITCHES = [
    ("  const int q = lane & 3;\n  if ((Co % 8 == 0)",
     "#ifdef EXP_NO_STORE\n  if (acc[0] != 12345.678f) return;\n#endif\n"
     "  const int q = lane & 3;\n  if ((Co % 8 == 0)"),
    ("  wgmma_fence();\n#pragma unroll\n  for (int i = 0; i < kLen; ++i)\n"
     "    wgmma_m64n64k16(",
     "  wgmma_fence();\n#ifndef EXP_NO_MMA\n#pragma unroll\n"
     "  for (int i = 0; i < kLen; ++i)\n    wgmma_m64n64k16("),
    ("        i > 0 ? 1 : 0);\n  wgmma_commit();",
     "        i > 0 ? 1 : 0);\n#endif\n  wgmma_commit();"),
    ("  const uint32_t dst32 = smem_u32(dst);\n  // `per_row` copies per row;",
     "#ifdef EXP_NO_LOAD\n  return;\n#endif\n"
     "  const uint32_t dst32 = smem_u32(dst);\n  // `per_row` copies per row;"),
    ("  pin(acc);\n#pragma unroll\n  for (int i = 0; i < 32; ++i) "
     "total[i] = __fadd_rn(total[i], acc[i]);",
     "  pin(acc);\n#ifndef EXP_NO_ADD\n#pragma unroll\n  for (int i = 0; "
     "i < 32; ++i) total[i] = __fadd_rn(total[i], acc[i]);\n#endif"),
    ("  for (int dt = 0; dt < 3; ++dt)\n    stage_w(Ws + dt * tap_bytes,",
     "#ifndef EXP_NO_W\n  for (int dt = 0; dt < 3; ++dt)\n#else\n"
     "  for (int dt = 0; dt < 0; ++dt)\n#endif\n"
     "    stage_w(Ws + dt * tap_bytes,"),
]
_ALL = ["NO_MMA", "NO_LOAD", "NO_W", "NO_ADD", "NO_STORE"]
VARIANTS = {
    "base": [], "no_store": ["NO_STORE"], "no_mma": ["NO_MMA"],
    "no_add": ["NO_ADD"], "no_load": ["NO_LOAD"], "no_w": ["NO_W"],
    "only_load": [m for m in _ALL if m != "NO_LOAD"],
    "only_store": [m for m in _ALL if m != "NO_STORE"],
    "nothing": _ALL,
}


def switched_source():
    from zeroshotvideoclassification_tpu_torch import _build

    text = (_build.CSRC / "temporal_conv.cu").read_text()
    for old, new in SWITCHES:
        if text.count(old) != 1:
            raise RuntimeError(f"the source no longer has exactly one "
                               f"{old!r}: bring SWITCHES up to date")
        text = text.replace(old, new)
    return text


def time_ms(fn, reps=20):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch

    if not torch.cuda.is_available():
        print("profile_k3: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from torch_helpers import bf16_ulps
    from zeroshotvideoclassification_tpu_torch import _build
    from zeroshotvideoclassification_tpu_torch.ops import temporal_conv as tc

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].strip()
    print(smi, flush=True)
    record = {"nvidia_smi": smi, "shapes": []}
    with tempfile.TemporaryDirectory(prefix="profile_k3_") as tmp:
        src = os.path.join(tmp, "temporal_conv_switched.cu")
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
        fns = {}
        for name in VARIANTS:
            fn = ctypes.CDLL(os.path.join(tmp, f"{name}.so")
                             ).zsvc_temporal_conv3_bf16
            fn.argtypes = _build.SIGNATURES["zsvc_temporal_conv3_bf16"]
            fn.restype = ctypes.c_int
            fns[name] = fn
        g = torch.Generator(device="cuda").manual_seed(0)
        for shape, co in SHAPES:
            n, t, h, wd, ci = shape
            x = torch.randn(shape, device="cuda", generator=g).bfloat16()
            w = (torch.randn((3, 1, 1, ci, co), device="cuda", generator=g)
                 / (3 * ci) ** 0.5).bfloat16()
            y = torch.empty((*shape[:4], co), device="cuda",
                            dtype=torch.bfloat16)
            plan = tc.tile_plan(n, t, h * wd, ci, co)
            wt = torch.empty(3 * -(-co // 64) * 64 * plan["ci_pad"],
                             device="cuda", dtype=torch.bfloat16)
            stream = torch.cuda.current_stream().cuda_stream

            def call(fn):
                err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                         wt.data_ptr(), n, t, h * wd, ci, co,
                         int(plan["kernel"] == "resident"), plan["wgs"],
                         plan["ring"], tc._STAGING_BYTES[plan["staging"]],
                         plan["smem_bytes"], stream)
                _build.check(err, "temporal_conv3 variant")

            call(fns["base"])
            torch.cuda.synchronize()
            ulps = bf16_ulps(y, tc.temporal_conv3_plain(x, w))
            if ulps > 2.0 and float((y.float() - tc.temporal_conv3_plain(
                    x, w).float()).abs().max()) > 0.02:
                raise RuntimeError(f"base variant is wrong at {shape}")
            ms = {k: time_ms(lambda f=f: call(f)) for k, f in fns.items()}
            # beside them the one PyTorch call for the same function (cuDNN,
            # channels-last, benchmark mode), as chip_smoke.py times it
            xv = x.permute(0, 4, 1, 2, 3)
            wv = w.permute(4, 3, 0, 1, 2).contiguous(
                memory_format=torch.channels_last_3d)
            ms["F.conv3d"] = time_ms(
                lambda: torch.nn.functional.conv3d(xv, wv, padding=(1, 0, 0)))
            record["shapes"].append({"shape": list(shape), "co": co,
                                     "kernel": plan["kernel"],
                                     "staging": plan["staging"], "ms": ms})
            print(f"{'x'.join(map(str, shape))} -> {co} {plan['kernel']}, "
                  f"{plan['staging']}: "
                  + "  ".join(f"{k} {v:.3f}" for k, v in ms.items())
                  + f" ms  ({smi})", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
