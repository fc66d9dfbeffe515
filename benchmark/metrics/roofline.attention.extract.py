"""roofline.attention.extract (%): the masked attention of stage 1's
blocks, the least time its work could take on the card (operations at the
bf16 peak or bytes at HBM's rate, `work.attention_fwd` of each call's
shapes, valid keys only) over the device time of the kernels that carry
it. Moves `images_per_s`."""
from benchmark import work

# The port's packed flash forward (kernel 1) and any attention kernel that
# could take its place (a twin's fused attention, SDPA's flash or
# memory-efficient kernels).
PATTERNS = [r"flash_fwd", r"flash_attn", r"fmha", r"[Aa]ttention"]


def read(run):
    flops, nbytes = run.work.get("attention", (0.0, 0.0))
    t = run.timeline.matching_s(PATTERNS)
    if not flops or t <= 0:
        return None
    return work.bound_s(flops, nbytes, work.PEAK_BF16) / t * 100
