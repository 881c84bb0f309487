"""Mean host ms of the program's ``encode.bridge`` spans per request an untraced step admitted."""

from portbench import spans


def read(view):
    return spans.per_request_ms(view, "encode.bridge")
