"""Share (%) of the pair engine's device time that the call's keys, read
once and written once at the card's HBM peak, would need (the yardstick of
``local_sort_roofline``, whatever engine sorts)."""


def read(p):
    return p.roofline("local_sort", 2 * p.key_bytes)
