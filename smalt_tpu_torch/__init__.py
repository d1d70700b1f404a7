"""smalt_tpu_torch — the PyTorch/CUDA port of smalt_tpu.

The JAX package `smalt_tpu` is the reference; this package re-implements
its device modules in torch, with the TPU's Pallas kernels rewritten by
hand for NVIDIA Hopper, and imports the framework-free host layers
(sequence IO, index build, traceback tail, SAM output) from `smalt_tpu`.
It never imports jax.

Ported so far — `map --fast` on single-end reads up to 512 bp, one
device:
  ops/sw.py          tracked full-matrix Smith-Waterman: CUDA kernel
                     (ops/csrc/sw_full.cu) + plain torch version
  parallel/mesh.py   device index and the fast mapping step
  map/fastmode.py    the batch pipeline (device pass + host tail)
  cli.py             `python -m smalt_tpu_torch.cli map --fast`
"""
