"""Seconds from the process's start to the first timed call: imports,
CUDA, the weights and inputs made on the device, the warm-up, and in a
run that builds or compiles, that too."""


def read(w):
    return w.setup_s
