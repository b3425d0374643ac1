"""Find a cell's files by name: ``BENCHMARK.json`` at the checkout's root, the
cell under ``cells/``, its configuration under ``configs/`` and its traffic
mix under ``traffic/``."""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass(frozen=True)
class Cell:
    name: str
    config: dict        # configs/<config>.json
    mix: dict           # traffic/<traffic>.json
    limits: dict        # the compared numbers' limits, from the cell's file
    end_to_end: list    # BENCHMARK.json's end-to-end metrics this cell reports
    per_layer: list     # and its per-layer metrics


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def benchmark() -> dict:
    return _read(ROOT / "BENCHMARK.json")


def load_cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` with its configuration, mix and limits; raises
    ``KeyError`` for a name ``BENCHMARK.json`` does not list."""
    bench = benchmark() if bench is None else bench
    entry = {w["name"]: w for w in bench["workloads"]}[name]
    cell = _read(HERE / "cells" / f"{name}.json")
    if (cell["config"], cell["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"cells/{name}.json names {cell['config']} under {cell['traffic']}, "
                         f"BENCHMARK.json {entry['config']} under {entry['traffic']}")
    configs = {c["name"]: c for c in bench["configs"]}
    return Cell(
        name=name, config=_read(ROOT / configs[entry["config"]]["file"]),
        mix=_read(HERE / "traffic" / f"{entry['traffic']}.json"),
        limits=cell["limits"],
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )
