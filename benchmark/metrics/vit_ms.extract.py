"""vit_ms.extract (ms/batch): the device time of one stage-1 batch's
`extract_patch_keys`, from the CUDA events the benchmark records around the
call, averaged over the traced batches. Moves `images_per_s`."""


def read(run):
    spans = run.spans_ms.get("vit")
    return sum(spans) / len(spans) if spans else None
