"""roofline.attention.train (%): the training step's attention in f32,
forward in every block and backward in the trained ones, the least time
its work could take (`work.attention_fwd`/`attention_bwd` of the step's
shapes; operations at the TF32 peak, the ceiling of any f32-accurate
product, or bytes at HBM's rate) over the device time of the kernels that
carry it. Moves `train_step_ms`."""
from benchmark import work

# kernels 3-5 (f32 builds) and any attention kernel that could take their place
PATTERNS = [r"flash_fwd", r"flash_bwd", r"flash_attn", r"fmha", r"[Aa]ttention"]


def read(run):
    flops, nbytes = run.work.get("attention", (0.0, 0.0))
    t = run.timeline.matching_s(PATTERNS)
    if not flops or t <= 0:
        return None
    return work.bound_s(flops, nbytes, work.PEAK_TF32) / t * 100
