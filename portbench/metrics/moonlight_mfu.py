"""The window's model operations (admissions unabsorbed, decode absorbed, the routed and shared experts, the dense layer, the head; portbench/work_mla.py) in percent of the window at the bf16 peak."""

from portbench.readers import mfu


def read(view):
    return mfu(view)
