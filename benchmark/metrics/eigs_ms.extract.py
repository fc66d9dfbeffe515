"""eigs_ms.extract (ms/batch): the time of one stage-2 batch's
`spectral_decompose_batched` between the CUDA events the benchmark records
around the call (the solver's host syncs included), averaged over the
traced batches. Moves `images_per_s`."""


def read(run):
    spans = run.spans_ms.get("eigs")
    return sum(spans) / len(spans) if spans else None
