"""``peak_mem_gib`` of the sample sort's cells, by its definition: the
largest footprint of one call of the window, in GiB.  A metric of its own
because the receive buffers are ``[P, cap]`` with the cap estimated from a
sample: the footprint, the largest over a pool's arrays, differs from one
seed's pool to the next."""

from sortbench.e2e.peak_mem_gib import read  # noqa: F401
