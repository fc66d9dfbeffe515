"""eigs_sync_share.extract (%): the host's time inside the eigensolver's
sync points (the port's `eigs.sync` ranges, by the trace's clock) over the
traced window: how long the solver's host stood waiting for the card.
Moves `images_per_s`."""
from benchmark import spans


def read(run):
    return spans.window_share(run, "eigs.sync")
