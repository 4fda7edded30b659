"""Share (%) of the exchange's device time that moving the keys that change
rank, (P-1)/P of them, once through HBM (read and write) would need."""


def read(p):
    if p.ranks < 2:
        return None
    return p.roofline("exchange", 2 * p.key_bytes * (p.ranks - 1) / p.ranks)
