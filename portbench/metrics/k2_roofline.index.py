"""K2's share of its roofline over the traced encodes, (32, 8, 257, 3072) a launch."""

from portbench.readers import roofline


def read(view):
    return roofline(view, "k2")
