"""Run one cell of the port's benchmark once, on the card it is started on.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration file
(``portbench/configs``) and a traffic mix (``portbench/traffic``), whose
``generator`` names the cell's module (``portbench/cells``). The run
builds the program's model with weights drawn on the card from the seed,
warms up the shapes of the cell's traffic, measures for ``--seconds``, then
compares what the window produced with the plain reference
(``portbench/reference``) against the cell's limits (``portbench/limits``).

With ``--trace 0`` the result's metrics are the cell's end-to-end metrics;
with ``--trace 1`` its per-layer metrics; each is read by
``portbench/metrics/<name>.py`` (``setup_s`` by the run itself) from the
window's request records and spans and from ``torch.profiler`` over its
last seconds. The
last line of standard output is the result, one JSON object. The exit code
is not 0, and no result is printed, without a CUDA card, when the modules
of JAX or of the JAX package were loaded, or when the program is missing.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Optional  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TRACE_SECONDS = 5.0  # the traced part of a --trace 1 window
HOST_THREADS = 4


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _applies(metric: dict, workload: str, bench: dict) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    moved = next((m for m in bench["end_to_end"] if m["name"] == metric.get("moves")), None)
    return moved is None or "workloads" not in moved or workload in moved["workloads"]


def cell_class(traffic: dict):
    """The ``Cell`` of ``portbench/cells/<generator>.py`` for the mix's generator."""
    import importlib

    return importlib.import_module("portbench.cells." + traffic["generator"]).Cell


def run_cell(bench: dict, wl: dict, cfg: dict, traffic: dict, limits: dict, seed: int,
             seconds: float, trace: bool, device, t_process: float = T_PROCESS,
             control: bool = False) -> Optional[dict]:
    """One run of the cell ``wl``: prints its lines and returns the result
    (None, with nothing printed, where modules of JAX were loaded). With
    ``control`` the float8 reference stands in the program's place in the
    comparison, which has to come out not correct."""
    import torch

    from portbench.harness import Spans, forbidden_loaded, log, metric, now, result_line
    from portbench.readers import RunView, read_metric

    torch.set_grad_enabled(False)
    torch.set_num_threads(HOST_THREADS)
    on_card = device.type == "cuda"
    cell = cell_class(traffic)(cfg, traffic, seed, device, Spans())
    cell.warm_up()
    if trace and on_card:  # the profiler's first start loads CUPTI: set-up, not window
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
            torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize()
    setup_s = now() - t_process
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    win = cell.window(seconds, TRACE_SECONDS if trace else 0.0)
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    found = forbidden_loaded()
    if found:
        log(f"modules of JAX or the JAX package were loaded: {', '.join(found)}")
        return None

    t0, t1 = win["t_start"], win["t_end"]
    view = RunView(cell, cfg, t0, t1, win["trace"])
    name = wl["name"]
    metrics = {}
    for m in bench["per_layer" if trace else "end_to_end"]:
        if _applies(m, name, bench):
            value = setup_s if m["name"] == "setup_s" else read_metric(m["name"], view)
            if value is not None:
                metrics[m["name"]] = metric(value, m["unit"])
    attempted, failed = cell.attempted(t0, t1)
    numbers, info = cell.finish(t0, t1, control=control)
    print(json.dumps(info), flush=True)
    log(f"[reference] {info['reference_s']:.1f} s")
    checks = {k: {"value": v, "limit": limits[k]["limit"]} for k, v in numbers.items()}
    correct = bool(numbers) and all(c["value"] <= c["limit"] for c in checks.values())

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    breakdown = None
    if trace and win["trace"] is not None:
        tr = win["trace"]
        log(f"[trace] part {tr.attempt}: window {tr.window_s!r} s on the host clock, "
            f"{tr.clock_ratio!r} of it on the device timeline; busy {tr.busy_s!r} s; "
            f"{tr.records} device events for {tr.launches} launches")
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        top = sorted(tr.kernel_s.items(), key=lambda kv: -kv[1])[:10]
        breakdown = {"device_ops": [[k, v] for k, v in top],
                     "idle_gaps": [[k, v] for k, v in tr.gaps[:10]]}
    found = forbidden_loaded()
    if found:
        log(f"modules of JAX or the JAX package were loaded: {', '.join(found)}")
        return None
    for k, c in checks.items():
        log(f"check {k}: {c['value']!r} (limit {c['limit']!r}) "
            f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}")
    line = result_line(correct=correct, attempted=attempted, failed=failed, metrics=metrics,
                       device=dev, checks=checks, breakdown=breakdown)
    print(line, flush=True)
    return json.loads(line) | {"info": info}


def main(argv=None) -> int:
    args = _args(argv)
    from portbench.harness import benchmark, limits_path, load_json, log, traffic_path
    from portbench.models import load_config

    bench = benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        log(f"no workload {args.workload!r} in BENCHMARK.json: {sorted(cells)}")
        return 2
    wl = cells[args.workload]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        log(f"{args.workload} needs {wl['chips']} CUDA card(s); "
            f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    res = run_cell(bench, wl, load_config(wl["config"]), load_json(traffic_path(wl["traffic"])),
                   load_json(limits_path(wl["name"])), args.seed, args.seconds,
                   bool(args.trace), torch.device("cuda", 0))
    return 0 if res is not None else 4


if __name__ == "__main__":
    sys.exit(main())
