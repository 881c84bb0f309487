"""Percent of the traced window with no device operation running."""

from portbench.readers import idle_share


def read(view):
    return idle_share(view)
