"""utils of mpitest_tpu_torch."""
