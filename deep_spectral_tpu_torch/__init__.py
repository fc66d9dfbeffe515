"""deep_spectral_tpu_torch: the PyTorch/CUDA port of `deep_spectral_tpu`.

The port runs stages 1-2 of the pipeline (stage 1 `extract_features`: DINO
ViT patch keys; stage 2 `extract_eigs`: relu-cosine affinity, optionally
fused with a color graph, whitened Laplacian, Chebyshev-filtered subspace
iteration or block LOBPCG, and the reference's other eigen modes), the
localization task (CorLoc with eigenseg, LOST and dino_seg) and the DeepLab
self-training on pseudolabels (`tasks/`) on an NVIDIA Hopper GPU. Plain tensor code is
PyTorch; the Pallas kernels of those paths (the packed flash-attention
forward, the Chebyshev filter, and the trainable flash attention's forward
and two backward kernels) are hand-written CUDA kernels under `csrc/`, built
with nvcc at first use (`_build.py`). Every kernel has a plain PyTorch twin in
the module that wraps it: the twin runs for CPU tensors (the tests), the
kernel for CUDA tensors.

The package imports torch and never jax; the JAX package stays the reference
that the tests hold the port against.
"""

__version__ = "0.1.0"
