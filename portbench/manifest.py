"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads[]``) names a configuration (``configs[]`` with its
``file``), a traffic mix (``traffic/<traffic>.json``) and its limits
(``limits/<workload>.json``); a metric is read by ``metrics/<name>.py``.
A later cell, configuration, mix or metric is a new file and a new
entry: no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r'[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}')
UNIT = re.compile(r'[A-Za-z0-9_/%.-]{1,16}')


class Manifest:
    def __init__(self, path: Path | None = None, here: Path | None = None):
        self.path = Path(path or ROOT / 'BENCHMARK.json')
        self.root = self.path.parent
        self.here = Path(here or HERE)
        self.data = json.loads(self.path.read_text())

    def cell(self, workload: str) -> dict:
        for w in self.data['workloads']:
            if w['name'] == workload:
                return w
        raise KeyError(f'no workload {workload!r} in {self.path.name}')

    def config(self, name: str) -> dict:
        for c in self.data['configs']:
            if c['name'] == name:
                conf = json.loads((self.root / c['file']).read_text())
                return {**conf, 'name': name}
        raise KeyError(f'no configuration {name!r}')

    def traffic(self, name: str) -> dict:
        return json.loads((self.here / 'traffic' / f'{name}.json')
                          .read_text())

    def limits(self, workload: str) -> dict:
        return json.loads((self.here / 'limits' / f'{workload}.json')
                          .read_text())

    def metrics(self, workload: str, trace: bool) -> list:
        """The cell's metrics of the run: its end-to-end ones untraced,
        its per-layer ones traced; a metric without ``workloads`` is every
        cell's."""
        group = self.data['per_layer' if trace else 'end_to_end']
        return [m for m in group
                if workload in m.get('workloads', [workload])]

    def reader(self, name: str):
        """The ``read(rec)`` of ``metrics/<name>.py``."""
        path = self.here / 'metrics' / f'{name}.py'
        spec = importlib.util.spec_from_file_location(
            f'portbench_metric_{name.replace(".", "_")}', path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
