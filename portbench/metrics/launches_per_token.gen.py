"""Device operations (kernels, copies, fills) in the traced window over the
token steps of the traced calls."""


def read(m):
    if m.kind != "generate" or m.trace is None or "token_steps" not in m.work:
        return None
    return m.trace.count() / (m.units * m.work["token_steps"])
