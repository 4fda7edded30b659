"""ops of mpitest_tpu_torch."""
