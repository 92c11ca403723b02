"""Frames (clips x frames a step) of every step in the window, over the
window's time up to the card's finishing the last step."""


def read(m):
    return m.frames / m.window_s if m.kind == "train" else None
