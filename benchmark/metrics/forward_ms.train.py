"""forward_ms.train (ms/step): the device time of the training step's
`train.forward` span (the BN snapshot, the model and the loss), between
the CUDA events the port records around it, summed over the traced steps
and divided by them. Moves `train_step_ms`."""
from benchmark import spans


def read(run):
    steps = run.counts.get("steps", 0)
    ms = spans.device_ms("train.forward")
    return ms / steps if steps and ms is not None else None
