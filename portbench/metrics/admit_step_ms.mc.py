"""Mean host wall, in ms, of the window's engine steps in which a request got its first token (admission, prefill and the step's decode)."""

from portbench.readers import step_ms


def read(view):
    return step_ms(view, admitting=True, per_decode_step=False)
