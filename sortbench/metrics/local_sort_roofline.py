"""Share (%) of the local sorts' device time that the call's keys, read once
and written once at the card's HBM peak, would need."""


def read(p):
    return p.roofline("local_sort", 2 * p.key_bytes)
