"""Eval scripts (ports of ``videollamb_tpu.eval``): multiple-choice,
open-ended, consistency, MovieChat, likelihood-ranked and mixed-modality
video QA, the NIAVH pressure test, accuracy merging and the GPT judge."""
