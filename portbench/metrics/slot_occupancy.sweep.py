"""Mean number of slots that committed a token in a decode step, from the engine's slot table read between step calls."""

from portbench.readers import slot_occupancy


def read(view):
    return slot_occupancy(view)
