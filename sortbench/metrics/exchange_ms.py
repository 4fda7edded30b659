"""Device ms per call of the kernels of the stage ``exchange``."""


def read(p):
    return p.stage_ms("exchange")
