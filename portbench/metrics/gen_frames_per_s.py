"""Sampled candidate frames (clips x samples x (L - 1) a call) of every call
in the window, over the window's time, the last call waited for."""


def read(m):
    return m.frames / m.window_s if m.kind == "generate" else None
