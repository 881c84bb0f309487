"""The depth-cut train check of ``chip_smoke.py`` over several seeds.

    python3 scripts/train_reference_seeds.py

For each of SEEDS, ``chip_smoke.train_reference`` builds the depth-cut model at
full width (3 tower layers, 2 LM layers, LoRA r=16 and the projector) from
that seed, draws its four-scene clip from a generator seeded with it, and
holds one LoRA + projector step, kernels in bf16 on the card, against the
plain route in f32 on the host: loss and gradients within chip_smoke's
tolerances, both steps segmented at the host's SceneTilling cuts. Prints the
card's name and power limit, each seed's check line, and last one JSON line
of every seed's result. Exits non-zero if a seed fails. Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SEEDS = (0, 1, 2, 3)


def main() -> int:
    if not torch.cuda.is_available():
        print("train_reference_seeds: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)

    import chip_smoke

    print(chip_smoke.card_line())
    results, failed = [], []
    for seed in SEEDS:
        g = torch.Generator(device="cuda").manual_seed(seed)
        try:
            results.append({"seed": seed, **chip_smoke.train_reference(g, seed)})
        except AssertionError as e:
            failed.append(seed)
            results.append({"seed": seed, "error": str(e)})
    print(json.dumps({"seeds": results, "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
