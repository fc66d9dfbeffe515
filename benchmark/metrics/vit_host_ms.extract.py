"""vit_host_ms.extract (ms/batch): the host's time inside the port's
`vit.extract` range (`extract_patch_keys`, by the trace's clock), averaged
over the traced stage-1 batches: the host's cost to issue a batch's ViT.
Moves `images_per_s`."""
from benchmark import spans


def read(run):
    ranges = spans.host_ranges(run, "vit.extract")
    return sum(e - s for s, e in ranges) / len(ranges) * 1e3 if ranges else None
