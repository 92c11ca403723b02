"""Set-up: from the start of the run's process to the start of the
measured window (imports, the kernels' build or load, weights, inputs,
warm-up)."""


def read(m):
    return m.setup_s
