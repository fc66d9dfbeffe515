"""deep_spectral_tpu_torch: the PyTorch/CUDA port of `deep_spectral_tpu`.

The port runs what the JAX package runs on one host, on an NVIDIA Hopper
GPU: the ten pipeline stages (DINO ViT patch keys; the Laplacian
eigensolve, optionally color-fused, by Chebyshev-filtered subspace iteration
or block LOBPCG; multi- and single-region segments, boxes, box features
and clusters, semantic segmaps; the dense-CRF refinement; the gallery and
viewer) and their one-command runner `pipeline.run_all`, the localization
task (CorLoc with eigenseg, LOST and dino_seg), both evaluations, and the
DeepLab self-training on pseudolabels over a DINO ViT or a ResNet-50, with
its prediction dump (`tasks/`). Plain tensor code is PyTorch; the Pallas
kernels of those paths (the packed flash-attention forward, the Chebyshev
filter, and the trainable flash attention's forward and two backward
kernels) are hand-written CUDA kernels under `csrc/`, built with nvcc at
first use (`_build.py`). Every kernel has a plain PyTorch twin in the module
that wraps it: the twin runs for CPU tensors (the tests), the kernel for
CUDA tensors.

The package imports torch and never jax; the JAX package stays the reference
that the tests hold the port against.
"""

__version__ = "0.1.0"
