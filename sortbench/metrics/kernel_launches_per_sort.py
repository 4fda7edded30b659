"""Kernels the device ran per profiled call (each launch runs one)."""


def read(p):
    return p.kernels / p.calls if p.kernels else None
