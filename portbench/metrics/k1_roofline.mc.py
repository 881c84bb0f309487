"""K1's share of its roofline over the traced tower encodes of admissions."""

from portbench.readers import roofline


def read(view):
    return roofline(view, "k1")
