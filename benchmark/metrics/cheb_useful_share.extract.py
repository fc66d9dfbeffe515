"""cheb_useful_share.extract (%): the lanes of the Chebyshev solver's outer
iterations still above the residual tolerance (the port's counter
`cheb.lanes_active`) over the lanes the filter ran on
(`cheb.lanes_filtered`: every lane of the batch, converged or not), in the
traced window: the filter's work that was not thrown away. Silent where no
Chebyshev outer ran. Moves `images_per_s`."""
from benchmark import spans


def read(run):
    filtered = spans.total("cheb.lanes_filtered")
    return spans.total("cheb.lanes_active") / filtered * 100 if filtered else None
