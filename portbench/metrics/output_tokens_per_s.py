"""Every output token committed in the window, over the window."""

from portbench.readers import output_tokens_per_s


def read(view):
    return output_tokens_per_s(view)
