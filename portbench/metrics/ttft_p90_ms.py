"""The 90th percentile of the time to the first token, in ms, over every request submitted and completed in the window."""

from portbench.readers import ttft_ms


def read(view):
    return ttft_ms(view, 90)
