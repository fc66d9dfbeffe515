"""mfu.train (%): the model flops of the traced steps (`work.train_step`:
the forward, and twice the forward of what trains) over the window and
the TF32 peak, the ceiling of any f32-accurate product. Moves
`train_step_ms`."""
from benchmark import work


def read(run):
    flops = run.work.get("model", (0.0, 0.0))[0]
    w = run.timeline.window_s
    return flops / w / work.PEAK_TF32 * 100 if flops and w > 0 else None
