"""window_ms.extract (ms/batch): the device time of the port's `vit.window`
spans (each SAM window block's pad and partition of its normed tokens, and
its unpartition and crop after the projection, between the span's CUDA
events) summed over the traced window, per stage-1 batch (`vit.extract`
spans). Silent where the port opens no such span (a model without windows,
or a port without the span). Moves `images_per_s`."""
from benchmark import spans


def read(run):
    ms, batches = spans.device_ms("vit.window"), spans.opened("vit.extract")
    return ms / batches if ms is not None and batches else None
