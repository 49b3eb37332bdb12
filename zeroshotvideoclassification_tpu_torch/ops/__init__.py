"""Compute ops: the hand-written CUDA kernels, each beside its plain PyTorch
version, and the cosine distances.

  resample.py       plain fused transforms: the video transform (K1's oracle
                    and CPU path), the 2-tap image-motion transform (K4's)
                    and the antialiased image-motion transform (plain
                    PyTorch on every device)
  resample_cuda.py  K1 and K4 wrappers (csrc/video_transform.cu,
                    csrc/image_motion_transform.cu) + device dispatch
  bn_cuda.py        K2, the BN epilogue as a torch.autograd.Function: forward
                    and backward wrappers (csrc/bn_apply_relu.cu) and their
                    plain versions
  bn_stats.py       the train-mode BN statistics as two
                    torch.autograd.Functions, the sums of x - m0 and of its
                    square, and the moments from them: wrappers
                    (csrc/bn_stats.cu; no TPU kernel, XLA computed these in
                    the JAX package) and their plain versions
  temporal_conv.py  K3, the (3,1,1) temporal conv as a
                    torch.autograd.Function: forward wrapper
                    (csrc/temporal_conv.cu), its plain version, the tile plan
  cdist.py          cosine distances (a float32 torch.matmul), nearest class,
                    top-k classes
  se_swish.py       X3D's squeeze-and-excitation and Swish after conv_b's
                    BN, one op in plain PyTorch on both devices (no kernel
                    yet)
  channelwise_conv.py
                    X3D's channel-wise 3D convs as a torch.autograd.Function:
                    forward, data-gradient and weight-gradient wrappers
                    (csrc/channelwise_conv.cu; no TPU kernel, the JAX
                    package has no X3D) and their plain versions

A CPU tensor gets the plain version; a CUDA tensor gets the kernel or an
exception. No path falls back from one to the other.
"""
