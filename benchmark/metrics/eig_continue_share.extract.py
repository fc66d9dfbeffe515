"""eig_continue_share.extract (%): the lanes the eigensolver's guard resumed
for more Chebyshev outers before any dense re-solve (the port's counter
`eigs.continued`, at least once a solve) over the valid lanes it checked
(`eigs.images`), in the traced window: how often the continuation engages.
None where the port counts no `eigs.continued`. Moves `images_per_s`."""
from benchmark import spans


def read(run):
    recs = spans.records()
    if not any("eigs.continued" in r["counts"] for r in recs):
        return None
    images = sum(r["counts"].get("eigs.images", 0) for r in recs)
    continued = sum(r["counts"].get("eigs.continued", 0) for r in recs)
    return continued / images * 100 if images else None
