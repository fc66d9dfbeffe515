"""roofline.cheb_filter.extract (%): the eigensolver's Chebyshev filter
chains, the least time their work could take (`work.cheb_chain` of every
chain at the (B, N, m, degree) the solver ran it, counted by the
benchmark's wrapper around the solver's filter, on each image's valid
nodes; products at the bf16 peak or bytes at HBM's rate) over the device
time of the filter's kernels. Silent where no chain ran (LOBPCG, dense).
Moves `images_per_s`."""
from benchmark import work

# kernel 2's builds (resident, streaming, the per-step yardstick)
PATTERNS = [r"cheb_"]


def read(run):
    flops, nbytes = run.work.get("cheb_filter", (0.0, 0.0))
    t = run.timeline.matching_s(PATTERNS)
    if not flops or t <= 0:
        return None
    return work.bound_s(flops, nbytes, work.PEAK_BF16) / t * 100
