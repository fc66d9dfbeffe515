"""swiglu_ms.extract (ms/batch): the device time of the port's `vit.swiglu`
spans (each block's SwiGLU FFN: w12, the gate and w3, between the span's
CUDA events) summed over the traced window, per stage-1 batch (`vit.extract`
spans). Silent where the port opens no such span (a model without a SwiGLU
FFN, or a port without the span). Moves `images_per_s`."""
from benchmark import spans


def read(run):
    ms, batches = spans.device_ms("vit.swiglu"), spans.opened("vit.extract")
    return ms / batches if ms is not None and batches else None
