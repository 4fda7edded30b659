"""The largest footprint of one call of the window, in GiB: the card's
``max_memory_allocated`` during the call less what it held before the call,
with the call's own input counted in."""


def read(win):
    if not win.footprint_bytes:
        return None
    return max(win.footprint_bytes) / (1 << 30)
