"""models of mpitest_tpu_torch."""
