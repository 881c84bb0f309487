"""Every frame embedded in the window, over the window."""

from portbench.readers import frames_per_s


def read(view):
    return frames_per_s(view)
