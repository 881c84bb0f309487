"""Host ms in the program's ``decode.enqueue`` span per decode step of the untraced steps that admitted nothing."""

from portbench import spans


def read(view):
    return spans.per_decode_step_ms(view, "decode.enqueue")
