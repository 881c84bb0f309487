"""The routed experts' grouped products' share of their roofline over the traced steps, from the expert counters (weights of each expert once per forward that routed to it, every routed row's activations)."""

from portbench.work_mla import roofline


def read(view):
    return roofline(view, "experts")
