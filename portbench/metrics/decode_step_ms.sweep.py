"""Host wall, in ms per decode step, of the window's engine steps that admitted nothing."""

from portbench.readers import step_ms


def read(view):
    return step_ms(view, admitting=False, per_decode_step=True)
