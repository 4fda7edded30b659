"""Device ms per call of the kernels of the stage ``local_sort`` in a cell of
64-bit keys: the pair engine (K2's ``k2_`` kernels, K3's ``k3_`` kernels)
and the library sort of the high-word sniff's 1024-key sample."""


def read(p):
    return p.stage_ms("local_sort")
