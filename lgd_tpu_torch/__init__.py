"""lgd_tpu_torch: the PyTorch + CUDA port of lgd_tpu for one NVIDIA H100.

The layout mirrors ``lgd_tpu/`` module for module. The JAX package stays
the numerical reference; this package imports torch and never jax or flax.
Plain tensor code is PyTorch (convolutions through cuDNN); every TPU kernel
on a ported path is a hand-written Hopper kernel under ``csrc/``, with its
plain PyTorch version beside it for tensors on the CPU.
"""

__version__ = "0.1.0"
