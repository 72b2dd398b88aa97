"""Finds what ``BENCHMARK.json`` names by name: a cell's configuration
(``bench/configs/<name>.json``), its traffic mix (``bench/mixes/<name>.json``),
the runner of the configuration's kind (``bench/runners/<kind>.py``, from the
file's ``"kind"``; absent means ``gnn``) and each metric's reader
(``bench/metrics/<name>.py``, a ``read(ctx)`` that returns the number or None
where it finds nothing to read).  A metric split by the end-to-end metric it
moves (``device_idle_share.serve`` beside ``device_idle_share``) is read by
the reader of the name before its first dot, unless it has one of its own."""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import re
from pathlib import Path
from typing import Callable

BENCH = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list      # the BENCHMARK.json entries this cell reports
    per_layer: list
    kind: str = "gnn"     # the configuration's kind: its runner's name


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    mix = json.loads((BENCH / "mixes" / f"{w['traffic']}.json").read_text())
    return Cell(
        name=name, chips=int(w["chips"]), config=config, mix=mix,
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)],
        kind=config.get("kind", "gnn"),
    )


def runner(kind: str):
    """The module ``bench/runners/<kind>.py``."""
    if not re.fullmatch(r"[A-Za-z0-9_]+", kind) or not (BENCH / "runners" / f"{kind}.py").is_file():
        raise KeyError(f"no runner bench/runners/{kind}.py for configuration kind {kind!r}")
    return importlib.import_module(f"bench.runners.{kind}")


def reader(metric: str) -> Callable:
    path = BENCH / "metrics" / f"{metric}.py"
    if not path.is_file():
        path = BENCH / "metrics" / f"{metric.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
