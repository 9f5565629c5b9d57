"""Set-up seconds: process start to the first timed call (imports, the
kernels' build or load, weights, inputs, warm-up), by the host clock."""


def read(rec):
    return rec["setup_s"]
