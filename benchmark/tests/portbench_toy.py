"""Shared by the benchmark's tests (each imports it first): the checkout
root on `sys.path`, two torch threads a test process (the port's CPU
paths are the plain versions, and test processes may share the cores),
and a throwaway cell made of new files only: a checkout root in a
temporary directory with the repository's BENCHMARK.json plus one more
workload (and its configuration's entry, where no cell uses it yet), the
existing configuration files, a new traffic file, and the repository's
artifacts linked in."""

import json
import os
import shutil
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
torch.set_num_threads(2)
SIZES = {"switch-ctb32": (64, 96), "regular-v1-n16": (64, 128)}


def make_root(tmp, config: str, *, batch=2, check_frames=2, name="toy"):
    """The root of a checkout with workload `name` on `config` at a toy
    frame size; returns its path."""
    root = os.path.join(str(tmp), "checkout")
    os.makedirs(os.path.join(root, "benchmark", "traffic"))
    shutil.copytree(os.path.join(ROOT, "benchmark", "configs"),
                    os.path.join(root, "benchmark", "configs"))
    os.symlink(os.path.join(ROOT, "artifacts"),
               os.path.join(root, "artifacts"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    if config not in {c["name"] for c in bench["configs"]}:
        # A configuration that has a file but no cell yet is listed too.
        with open(os.path.join(ROOT, "benchmark", "configs",
                               f"{config}.json")) as f:
            cfg = json.load(f)
        bench["configs"].append({
            "name": config, "source": cfg["source"],
            "file": f"benchmark/configs/{config}.json",
            "reduced": cfg["reduced"], "why": "a toy cell of the tests"})
    bench["workloads"].append({"name": name, "config": config,
                               "traffic": name, "chips": 1,
                               "why": "a toy cell of the tests"})
    for m in bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(name)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    h, w = SIZES[config]
    with open(os.path.join(root, "benchmark", "traffic", f"{name}.json"),
              "w") as f:
        json.dump({"height": h, "width": w, "batch": batch,
                   "check_frames": check_frames}, f)
    return root
