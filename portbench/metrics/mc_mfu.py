"""The window's model operations (tower, bridge, prefill, decode) in percent of the window at the bf16 peak."""

from portbench.readers import mfu


def read(view):
    return mfu(view)
