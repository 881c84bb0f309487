"""Exact-match accuracy aggregator with per-type breakdown.

Counterpart of reference scripts/eval_acc.py, eval_nextqa.py (per-type via
the FIRST character of the type string), eval_moviechat.py (merge ws JSONL
dicts into one submission JSON), plus the merge step of the shard-and-merge
launchers (scripts/eval/egoschema.sh:37-48). A copy of
``videollamb_tpu/eval/acc.py`` (host-only).
"""

from __future__ import annotations

import argparse
import collections
import json
from typing import Dict, Iterable, List, Tuple


def merge_shards(paths: Iterable[str], dst: str) -> str:
    """Concatenate per-shard JSONL files (the launchers' `cat` step)."""
    with open(dst, "w") as out:
        for p in paths:
            with open(p) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        out.write(line + "\n")
    return dst


def compute_accuracy(path: str, type_mode: str = "full") -> Tuple[float, Dict[str, float], int]:
    """type_mode='full' groups by the type value (eval_acc.py);
    'first' groups by its first character (eval_nextqa.py:24 type[0])."""
    acc, total = 0, 0
    type_dct: Dict[str, List[int]] = collections.defaultdict(list)
    with open(path) as f:
        for line in f:
            res = json.loads(line)
            answer = res["answer"]
            text = res["pred"].strip(".")
            correct = int(answer == text)
            acc += correct
            total += 1
            if res.get("type") is not None:
                key = str(res["type"])
                if type_mode == "first":
                    key = key[0]
                type_dct[key].append(correct)
    overall = acc / max(total, 1)
    per_type = {k: sum(v) / len(v) for k, v in type_dct.items()}
    return overall, per_type, total


def gather_moviechat(src: str, dst: str) -> str:
    """Merge per-video ws JSONL dicts into one MovieChat submission JSON
    (reference scripts/eval_moviechat.py)."""
    all_answers: Dict = {}
    with open(src) as f:
        for line in f:
            line = line.strip()
            if line:
                all_answers.update(json.loads(line))
    with open(dst, "w") as f:
        json.dump(all_answers, f, indent=4)
    return dst


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--src", type=str, required=True)
    parser.add_argument("--dst", type=str, default=None)
    parser.add_argument("--type-mode", choices=["full", "first"], default="full")
    parser.add_argument("--gather-moviechat", action="store_true",
                        help="merge ws JSONL dicts into one submission JSON")
    args = parser.parse_args()
    if args.gather_moviechat:
        if not args.dst:
            parser.error("--dst required for --gather-moviechat")
        print(gather_moviechat(args.src, args.dst))
        return
    overall, per_type, total = compute_accuracy(args.src, args.type_mode)
    print("Accuracy: ", overall)
    for tpidx, tpacc in per_type.items():
        print(f"Accuraccy for Type {tpidx}: {tpacc}")
    if args.dst:
        with open(args.dst, "w") as f:
            json.dump({"accuracy": overall, "per_type": per_type, "n": total}, f)


if __name__ == "__main__":
    main()
