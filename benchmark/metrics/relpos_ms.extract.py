"""relpos_ms.extract (ms/batch): the device time of the port's `vit.relpos`
spans (each SAM block's relative-position tables: q laid out by token and
its batched product with the gathered rel-pos operand, between the span's
CUDA events) summed over the traced window, per stage-1 batch
(`vit.extract` spans). Silent where the port opens no such span (a model
without relative positions, or a port without the span). Moves
`images_per_s`."""
from benchmark import spans


def read(run):
    ms, batches = spans.device_ms("vit.relpos"), spans.opened("vit.extract")
    return ms / batches if ms is not None and batches else None
