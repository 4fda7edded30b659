"""Mesh of ranks and the collectives over it."""

from mpitest_tpu_torch.parallel.mesh import make_mesh, multihost_init  # noqa: F401
from mpitest_tpu_torch.parallel import collectives  # noqa: F401
