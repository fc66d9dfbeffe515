"""device_idle.train (%): 1 - the union of the device operations'
intervals over the traced window, the share of the window in which nothing
ran on the card. Moves `train_step_ms`."""


def read(run):
    w = run.timeline.window_s
    return (1 - run.timeline.busy_s() / w) * 100 if w > 0 else None
