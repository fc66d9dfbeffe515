"""roofline.rope.extract (%): the RoPE of stage 1's blocks, the least time
its bytes could take on the card (each block's q and k patch rows read and
written once in bf16, `rope_bytes` of the driver, at HBM's rate) over the
device time of the kernels named for it. Silent where the driver counts no
such bytes or no such kernel ran (a port without the RoPE kernel). Moves
`images_per_s`."""
from benchmark import work

# the port's RoPE kernel (csrc/rope.cu) and any kernel named for RoPE that
# could take its place
PATTERNS = [r"rope_rotate"]


def read(run):
    _, nbytes = run.work.get("rope", (0.0, 0.0))
    t = run.timeline.matching_s(PATTERNS)
    if not nbytes or t <= 0:
        return None
    return work.bound_s(0.0, nbytes, work.PEAK_BF16) / t * 100
