"""A cell's files, found by the names in ``BENCHMARK.json``.

- ``benchmark/configs/<config>.json``: the configuration (factory, its
  arguments, the stream signature, the signal, the comparison's limits);
- ``benchmark/traffic/<mix>.json``: the traffic mix (the loop that runs
  the window, by name, and its parameters);
- ``benchmark/loops/<loop>.py``: a loop, its class ``Loop``
  (``harness/window.py`` says what it does);
- ``benchmark/reference/<config>.py``: the plain reference and the
  kernel work one step needs;
- ``benchmark/metrics/<metric>.py``: one per-layer metric's reader.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


def spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    reference: object

    def metrics(self, trace: bool) -> list:
        return self.per_layer if trace else self.end_to_end


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, bench: dict = None) -> Cell:
    bench = spec() if bench is None else bench
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{sorted(by_name)}")
    w = by_name[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads(
        (BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    ref = importlib.import_module(f"benchmark.reference.{w['config']}")
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer, ref)


def _module(folder: str, name: str):
    """``benchmark/<folder>/<name>.py``, loaded by its path (a name may
    hold dots)."""
    path = BENCH / folder / f"{name}.py"
    mod_name = f"benchmark_{folder}_" + name.replace(".", "_").replace(
        "-", "_")
    s = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The ``read(ctx)`` function of ``benchmark/metrics/<metric>.py``."""
    return _module("metrics", metric).read


def loop(name: str):
    """The ``Loop`` class of ``benchmark/loops/<name>.py``."""
    return _module("loops", name).Loop
