"""The PyTorch port stands alone: no JAX and nothing of ``doda_tpu``.

A subprocess imports every module of ``doda_tpu_torch`` and must end with
no jax/flax/optax module loaded; an AST scan checks every import statement
of the package, of ``chip_smoke.py`` and of the check it loads from
``tests/_torch_equivalence.py``.
"""

import ast
import subprocess
import sys
from pathlib import Path

from _torch_threads import two_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / 'doda_tpu_torch'
BANNED = ('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'doda_tpu')


def _modules():
    for path in sorted(PKG.rglob('*.py')):
        rel = path.relative_to(ROOT).with_suffix('')
        parts = rel.parts[:-1] if rel.name == '__init__' else rel.parts
        yield '.'.join(parts)


def test_import_loads_no_jax():
    mods = list(_modules())
    for name in ('ops.banded_conv', 'ops.bricks2d', 'ops.pointops',
                 'ops.pointops_offsets', 'ops.voxelize', 'native.host_ops',
                 'ops.slabs', 'ops.sparse', 'utils.visualize',
                 'tools.visualize', 'utils.roofline', 'tools.roofline',
                 'tools.bench_conv', 'tools.probe_train_mem'):
        assert f'doda_tpu_torch.{name}' in mods, name
    code = ('import importlib, sys\n'
            f'for m in {mods!r}:\n'
            '    importlib.import_module(m)\n'
            f'bad = sorted(m for m in sys.modules if m.split(".")[0] in '
            f'{BANNED!r})\n'
            'print(bad)\n'
            'sys.exit(1 if bad else 0)\n')
    res = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_no_jax():
    # chip_smoke.py also runs the ranks' check of tests/
    files = sorted(PKG.rglob('*.py')) + [ROOT / 'chip_smoke.py',
                                         ROOT / 'tests/_torch_equivalence.py']
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            top = name.split('.')[0]
            assert top not in BANNED, \
                f'{path.relative_to(ROOT)} imports {name}'
