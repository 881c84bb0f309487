"""Mean host ms of the program's ``encode.tower`` span per request an untraced step admitted."""

from portbench import spans


def read(view):
    return spans.per_request_ms(view, "encode.tower")
