"""K4's share of its roofline over the traced decode steps, from every slot's resident length."""

from portbench.readers import roofline


def read(view):
    return roofline(view, "k4")
