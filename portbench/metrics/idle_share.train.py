"""The share of the traced window in which no operation ran on the card:
1 - (union of the device operations' intervals) / (window)."""

KIND = "train"


def read(m):
    if m.kind != KIND or m.trace is None or m.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - m.trace.busy_s / m.trace.window_s)
