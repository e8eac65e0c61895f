"""Seconds from the process's start to the window's first call: import,
CUDA context, the kernel library from its cache (or its build), the
inputs and weights made on the device, and the warm-up."""


def read(m):
    return m["setup_s"]
