"""Device operations (kernels, copies, fills) in the traced window over the
traced training steps."""


def read(m):
    if m.kind != "train" or m.trace is None:
        return None
    return m.trace.count() / m.units
