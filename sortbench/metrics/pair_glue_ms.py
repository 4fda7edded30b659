"""Device ms per call outside the stages in a cell of 64-bit keys: the
two-word encodes, the constant-word checks, the sniff's gather and the
two-plane verifier (``verify_scan``), copies and memsets."""


def read(p):
    return p.stage_ms(None)
