"""Compute ops: the two hand-written CUDA kernels of the serving path, each
beside its plain PyTorch version, and the cosine distances.

  resample.py       plain fused video transform (K1's oracle and CPU path)
  resample_cuda.py  K1 wrapper (csrc/video_transform.cu) + device dispatch
  bn_cuda.py        K2 forward wrapper (csrc/bn_apply_relu.cu), its plain
                    version + device dispatch
  cdist.py          cosine distances (a float32 torch.matmul)

A CPU tensor gets the plain version; a CUDA tensor gets the kernel or an
exception. No path falls back from one to the other.
"""
