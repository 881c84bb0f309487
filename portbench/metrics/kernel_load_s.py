"""Seconds of the process's ``kernels.load`` span (``kernels.compile`` inside it where the library was built)."""

from portbench import spans


def read(view):
    return spans.kernel_load_s(view)
