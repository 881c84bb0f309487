"""Percent of the decode forwards in the untraced steps that replayed the program's CUDA graph (``decode.graph`` marks among ``decode.graph`` and ``decode.eager``)."""

from portbench import decode_route


def read(view):
    return decode_route.read(view)
