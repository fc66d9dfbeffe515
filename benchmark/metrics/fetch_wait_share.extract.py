"""fetch_wait_share.extract (%): the host's time waiting for a fetched
batch's copies to the host (the port's `stage.wait` ranges, by the trace's
clock) over the traced window. Moves `images_per_s`."""
from benchmark import spans


def read(run):
    return spans.window_share(run, "stage.wait")
