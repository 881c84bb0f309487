"""Median host ms from a request's ``admit.prefill`` end to its ``request.first_token`` mark."""

from portbench import spans


def read(view):
    return spans.first_token_wait_ms(view)
