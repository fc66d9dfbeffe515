"""mfu.extract (%): the model flops of the traced window (stage 1's ViT on
valid tokens, `work.vit_keys`; each image's affinity; the filter chains the
solver ran) over the window and the bf16 peak. Moves `images_per_s`."""
from benchmark import work


def read(run):
    flops = run.work.get("model", (0.0, 0.0))[0] + run.work.get("cheb_filter", (0.0, 0.0))[0]
    w = run.timeline.window_s
    return flops / w / work.PEAK_BF16 * 100 if flops and w > 0 else None
