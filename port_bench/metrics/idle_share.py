"""The share of the traced span in which no operation ran on the
device: 100 x (1 - the union of the device operations' intervals / the
span)."""


def read(view):
    if view.window_s <= 0:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)
