"""Tiny configurations and mixes of the benchmark's cells, for CPU tests."""

import copy

import torch

from portbench import run
from portbench.harness import benchmark, limits_path, load_json, traffic_path
from portbench.models import load_config

SEED = 2 ** 31 + 12345


def videollamb_cfg() -> dict:
    cfg = load_config("videollamb-mistral-7b")
    cfg["dtype"] = "float32"
    cfg["max_length"] = 512
    cfg["lm"].update(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                     num_attention_heads=4, num_key_value_heads=2, sliding_window=1024)
    cfg["vision"].update(hidden_size=32, intermediate_size=64, num_hidden_layers=3,
                         num_attention_heads=4, image_size=56)
    cfg["bridge"].update(hidden_size=32, num_attention_heads=4, intermediate_size=64,
                         num_memory_tokens=8, pool_h=2, pool_w=2)
    return cfg


def languagebind_cfg() -> dict:
    cfg = load_config("languagebind-video-vitl14")
    cfg["dtype"] = "float32"
    cfg["vision"].update(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                         num_attention_heads=4, image_size=56)
    cfg["text"].update(hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                       num_attention_heads=4, vocab_size=100)
    cfg["projection_dim"] = 16
    return cfg


def traffic(workload: str) -> dict:
    wl = cell(workload)
    tr = copy.deepcopy(load_json(traffic_path(wl["traffic"])))
    kind = tr.get("arrivals", {}).get("kind")
    if kind == "closed":
        tr.update(frames=[32, 40], block=4)
        tr["check"]["requests"] = 3
    elif kind == "backlog":
        tr["engine"]["slots"] = 3
        tr["block"] = 4
        tr["answer"].update(median=6, lo=2, hi=12)
        tr["check"]["requests"] = 3
    else:
        tr["batch"] = 2
    return tr


def cell(workload: str) -> dict:
    return {w["name"]: w for w in benchmark()["workloads"]}[workload]


def config_for(workload: str) -> dict:
    return languagebind_cfg() if "languagebind" in cell(workload)["config"] else videollamb_cfg()


def run_tiny(workload: str, seconds: float = 2.0, trace: bool = False, capsys=None,
             mix: dict = None) -> dict:
    """One CPU run of the cell at tiny widths (``mix`` in place of its traffic);
    returns the parsed result line."""
    import json

    res = run.run_cell(benchmark(), cell(workload), config_for(workload),
                       mix if mix is not None else traffic(workload),
                       load_json(limits_path(workload)), SEED, seconds, trace,
                       torch.device("cpu"))
    assert res is not None
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


WORKLOADS = [w["name"] for w in benchmark()["workloads"]]
