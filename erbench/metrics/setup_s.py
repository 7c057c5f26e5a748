"""Seconds from the process's start to the window's: imports, the kernels'
build where a checkout has none yet, the corpus, the warm-up."""


def read(reading):
    return reading.setup_s
