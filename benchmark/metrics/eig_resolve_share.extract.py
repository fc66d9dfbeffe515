"""eig_resolve_share.extract (%): the lanes the eigensolver's guard re-solved
with dense eigh (the port's counter `eigs.resolved`) over the valid lanes
it checked (`eigs.images`), in the traced window. The re-solves are the
stalls `batch_p95_ms` shows. Moves `images_per_s`."""
from benchmark import spans


def read(run):
    images = spans.total("eigs.images")
    return spans.total("eigs.resolved") / images * 100 if images else None
