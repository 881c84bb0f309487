"""The paged engine's decode route, as the program's marks record it: every
decode forward leaves a ``decode.graph`` mark where it replayed the engine's
CUDA graph (its capture included) and a ``decode.eager`` one where it ran
operator by operator. A reader returns None where the program records
neither mark, as a program without the graph does."""

from __future__ import annotations

from typing import Iterable, Optional

from portbench import spans


def graph_share(records: Iterable) -> Optional[float]:
    """Percent of the decode forwards among ``records`` that replayed the graph."""
    graph = eager = 0
    for r in records:
        graph += r.name == "decode.graph"
        eager += r.name == "decode.eager"
    return 100.0 * graph / (graph + eager) if graph + eager else None


def read(view) -> Optional[float]:
    """:func:`graph_share` over the window's untraced steps."""
    steps = view.steps(untraced=True)
    recs = spans.in_steps(view, steps) if steps else None
    return graph_share(recs) if recs else None
