"""conv_ms.train (ms/step): device time per training step of the
convolution kernels (the DeepLab head's and the patch embedding's, forward
and backward), by kernel name. Moves `train_step_ms`."""

# cuDNN's and cuBLAS-lt's convolution kernels on Hopper (implicit GEMM
# fprop/dgrad/wgrad, winograd, FFT, cuDNN's own engines and layout passes)
PATTERNS = [r"conv(?!ert)", r"fprop", r"dgrad", r"wgrad", r"cudnn", r"winograd", r"fft"]


def read(run):
    steps = run.counts.get("steps", 0)
    if not steps:
        return None
    t = run.timeline.matching_s(PATTERNS)
    return t / steps * 1e3 if t > 0 else None
