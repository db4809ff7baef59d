"""Set-up: from the process's start to the first measured step (data,
weights, kernel loading and warm-up; the first run of a checkout also
builds the kernels)."""


def read(r):
    return None if r.setup_s is None else r.setup_s
