"""eigs_syncs.extract (syncs/solve): the points where the eigensolver's host
waited for the card (the port's counter `eigs.syncs`: each outer
iteration's exit test, each small eigh, the guard's read, a re-solve's
eigh) per iterative solve (`eigs.cheb` and `eigs.lobpcg` spans), in the
traced window. Moves `images_per_s`."""
from benchmark import spans


def read(run):
    solves = spans.opened("eigs.cheb") + spans.opened("eigs.lobpcg")
    return spans.total("eigs.syncs") / solves if solves else None
