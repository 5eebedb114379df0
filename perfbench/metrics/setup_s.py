"""Set-up: process start to the window's start (imports, CUDA init, the
kernel build, the load and its flush, the warm-up)."""


def read(run):
    return run.setup_s
