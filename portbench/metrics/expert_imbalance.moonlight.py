"""Over the untraced steps that admitted nothing, the mean across MoE layers of the busiest expert's routed tokens over the mean expert's, from the engine's expert counters read between step calls."""

from portbench.cells.video_qa_mla import expert_imbalance


def read(view):
    return expert_imbalance(view)
