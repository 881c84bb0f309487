"""Readings from which a cell's limits are set: the program's compared
numbers over many seeds and, on some of them, the float8 control's.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 \
        [--control-seeds 1,2] [--seconds 25] [--out readings.json]

All seeds run in one process, one after another, each a whole run of the
cell (``run.run_cell``) with a short window at the cell's own load: the
model drawn anew from the seed, warmed up, driven, and its outputs compared
with the reference. On the control seeds the float8 reference
(``reference.linear.Weights(precision="fp8")``) stands in the program's
place in that comparison, so the run's ``correct`` has to come out false;
the program's own number of that window is read beside it. The benchmark's
own runs never run this.
"""

import argparse
import gc
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(workload: str, seed: int, seconds: float, control: bool, device) -> dict:
    """One seed's run: its checks, whether it came out correct, and the
    program's own numbers (with ``control``, those the control replaced)."""
    import torch

    from portbench import run
    from portbench.harness import benchmark, limits_path, load_json, now, traffic_path
    from portbench.models import load_config

    bench = benchmark()
    wl = {w["name"]: w for w in bench["workloads"]}[workload]
    t0 = now()
    res = run.run_cell(bench, wl, load_config(wl["config"]), load_json(traffic_path(wl["traffic"])),
                       load_json(limits_path(workload)), seed, seconds, False, device,
                       t_process=t0, control=control)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if res is None:
        raise RuntimeError("modules of JAX or the JAX package were loaded")
    return {"seed": seed, "control": control, "correct": res["correct"],
            "checks": res["checks"], "program": res["info"]["program"],
            "seconds": now() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=25.0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    import torch

    from portbench.harness import card_name_and_limit, log

    if not torch.cuda.is_available():
        log("control readings need a CUDA card")
        return 3
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    log(f"[control] {args.workload} on {card_name_and_limit()}")
    for s in (int(x) for x in args.seeds.split(",")):
        row = readings(args.workload, s, args.seconds, s in ctl, torch.device("cuda", 0))
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "card": card_name_and_limit(), "rows": rows},
                      f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
