"""Compute ops: the hand-written CUDA kernels, each beside its plain PyTorch
version, and the cosine distances.

  resample.py       plain fused video transform (K1's oracle and CPU path)
  resample_cuda.py  K1 wrapper (csrc/video_transform.cu) + device dispatch
  bn_cuda.py        K2, the BN epilogue as a torch.autograd.Function: forward
                    and backward wrappers (csrc/bn_apply_relu.cu) and their
                    plain versions
  cdist.py          cosine distances (a float32 torch.matmul), nearest class

A CPU tensor gets the plain version; a CUDA tensor gets the kernel or an
exception. No path falls back from one to the other.
"""
