"""upload_share.extract (%): the host's time pinning and copying inputs to
the card (the port's `stage.upload` ranges, by the trace's clock) over the
traced window. Moves `images_per_s`."""
from benchmark import spans


def read(run):
    return spans.window_share(run, "stage.upload")
