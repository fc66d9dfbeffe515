"""device_idle.extract (%): 1 - the union of the device operations'
intervals over the traced window, the share of the window in which nothing
ran on the card. Moves `images_per_s`."""


def read(run):
    w = run.timeline.window_s
    return (1 - run.timeline.busy_s() / w) * 100 if w > 0 else None
