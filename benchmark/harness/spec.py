"""What a run is: the cell named on the command line, found by name.

``BENCHMARK.json`` at the checkout's root lists the cells, configurations
and metrics. Everything that belongs to one of them sits in a file of its
own under ``benchmark/``, found by its name:

- ``configs/<config>.json``: the configuration as it is run (the program's
  family, its factory and every value handed to it), its dataset, its
  reference module, ``source``, ``reduced`` and ``assumed``;
- ``traffic/<traffic>.json``: the batch, the compute dtype, the render pair,
  the steps of the traced window;
- ``workloads/<cell>.json``: what is the cell's own: the kernel names its
  rooflines read and the limits of its output check;
- ``metrics/<metric>.py``: one reader a per-layer metric.

Adding a configuration, a traffic mix, a cell or a metric adds files and
entries; no file here changes.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # benchmark/
ROOT = os.path.dirname(HERE)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    entry: Dict          # the cell's entry in BENCHMARK.json
    config: Dict         # configs/<config>.json
    traffic: Dict        # traffic/<traffic>.json
    own: Dict            # workloads/<cell>.json
    end_to_end: List[Dict] = field(default_factory=list)
    per_layer: List[Dict] = field(default_factory=list)
    root: str = ROOT

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root``/BENCHMARK.json with its files."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(entries)})")
    entry = entries[name]
    here = os.path.join(root, "benchmark")
    own_path = os.path.join(here, "workloads", f"{name}.json")
    return Cell(
        name=name, entry=entry,
        config=load_json(os.path.join(here, "configs", f"{entry['config']}.json")),
        traffic=load_json(os.path.join(here, "traffic", f"{entry['traffic']}.json")),
        own=load_json(own_path) if os.path.exists(own_path) else {},
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)], root=root)
