"""Keys of every call completed in the window, per second from the window's
start to the last completion, in millions."""


def read(win):
    if not win.calls or win.t_last <= win.t_start:
        return None
    return win.keys / (win.t_last - win.t_start) / 1e6
