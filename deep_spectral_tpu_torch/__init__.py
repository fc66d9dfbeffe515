"""deep_spectral_tpu_torch: the PyTorch/CUDA port of `deep_spectral_tpu`.

The port runs the pipeline's main path (stage 1 `extract_features`: DINO ViT
patch keys; stage 2 `extract_eigs`: relu-cosine affinity, whitened Laplacian,
Chebyshev-filtered subspace iteration) on an NVIDIA Hopper GPU. Plain tensor
code is PyTorch; the two Pallas kernels of that path are hand-written CUDA
kernels under `csrc/`, built with nvcc at first use (`_build.py`). Every kernel
has a plain PyTorch twin in the module that wraps it: the twin runs for CPU
tensors (the tests), the kernel for CUDA tensors.

The package imports torch and never jax; the JAX package stays the reference
that the tests hold the port against.
"""

__version__ = "0.1.0"
