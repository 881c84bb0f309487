"""The median time to the first token, in ms, over every request submitted and completed in the window that an untraced step admitted."""

from portbench.readers import ttft_ms


def read(view):
    return ttft_ms(view, 50, untraced=True)
