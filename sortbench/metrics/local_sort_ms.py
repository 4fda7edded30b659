"""Device ms per call of the kernels of the stage ``local_sort``."""


def read(p):
    return p.stage_ms("local_sort")
