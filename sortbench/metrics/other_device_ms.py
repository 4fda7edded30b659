"""Device ms per call of every device operation outside the stages: the
codec, the verifier, gathers and glue kernels, copies and memsets."""


def read(p):
    return p.stage_ms(None)
