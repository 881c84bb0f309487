"""K1's share of its roofline over the traced encodes, (256, 257, 1024) a launch."""

from portbench.readers import roofline


def read(view):
    return roofline(view, "k1")
