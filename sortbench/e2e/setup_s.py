"""Seconds from the process's start to the window's: imports, the card's
initialisation, the program's kernel build or load, the keys, the mesh and
the warm-up."""


def read(win):
    return win.setup_s
