"""BENCHMARK.json against the contract's rules, the harness found by
name, and what a run may not load."""

import ast
import json
import re
import shutil
import subprocess
import sys

from portbench import guard
from portbench.manifest import HERE, NAME, ROOT, UNIT, Manifest

DATA = json.loads((ROOT / 'BENCHMARK.json').read_text())
METRICS = DATA['end_to_end'] + DATA['per_layer']


def test_names_and_units_use_the_allowed_characters():
    names = [c['name'] for c in DATA['configs']] + \
        [w['name'] for w in DATA['workloads']] + [m['name'] for m in METRICS]
    names += [w['config'] for w in DATA['workloads']]
    names += [w['traffic'] for w in DATA['workloads']]
    names += [k for c in DATA['configs'] for k in c['reduced']]
    assert all(NAME.fullmatch(n) for n in names), names
    assert all(UNIT.fullmatch(m['unit']) for m in METRICS)
    assert len(set(names[:len(DATA['configs']) + len(DATA['workloads'])
                         + len(METRICS)])) == len(DATA['configs']) + len(
        DATA['workloads']) + len(METRICS)
    for text in [c['why'] for c in DATA['workloads']] + \
            [m['layer'] for m in DATA['per_layer']] + \
            [c['source'] for c in DATA['configs']] + DATA['command']:
        assert 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text


def test_every_cell_reports_what_its_metrics_move():
    cells = [w['name'] for w in DATA['workloads']]
    e2e = {m['name']: m.get('workloads', cells) for m in DATA['end_to_end']}
    for m in DATA['per_layer']:
        assert m['moves'] in e2e
        for cell in m.get('workloads', cells):
            assert cell in e2e[m['moves']], (m['name'], cell)
    for cell in cells:
        assert 'setup_s' in e2e and cell in e2e['setup_s']
        assert sum(cell in w for w in e2e.values()) >= 2
        assert any(cell in m.get('workloads', cells)
                   for m in DATA['per_layer'])


def test_every_configuration_has_a_cell_and_its_files():
    used = {w['config'] for w in DATA['workloads']}
    assert used == {c['name'] for c in DATA['configs']}
    man = Manifest()
    for w in DATA['workloads']:
        assert man.traffic(w['traffic'])['step'] in ('eval', 'train', 'st')
        assert man.limits(w['name'])
        assert man.config(w['config'])['name'] == w['config']
    for m in METRICS:
        assert callable(man.reader(m['name']))
    for c in DATA['configs']:
        assert c['file'].startswith(DATA['paths'][0] + '/')


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_loaded(['doda_tpu_torch', 'doda_tpu_torch.ops',
                                   'jaxtyping', 'numpy']) == []
    assert guard.forbidden_loaded(['doda_tpu.ops.bricks', 'jax._src',
                                   'flax', 'jaxlib']) == \
        ['doda_tpu', 'flax', 'jax', 'jaxlib']


RUN_AND_LIST = '''
import json, sys, tempfile
from pathlib import Path
import torch
torch.set_num_threads(2)
from portbench import bench
from portbench.tests.tiny import tiny_manifest
man = tiny_manifest(Path(tempfile.mkdtemp()))
bench.run_cell('tiny.eval', 3, 0.1, True, device='cpu', manifest=man)
files = [getattr(m, '__file__', None) or ''
         for m in list(sys.modules.values())]
print(json.dumps({'modules': sorted(sys.modules), 'files': files,
                  'tf32': torch.backends.cuda.matmul.allow_tf32}))
'''


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    out = subprocess.run([sys.executable, '-c', RUN_AND_LIST], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={'PATH': '/usr/bin:/bin', 'HOME': str(tmp_path),
                              'TMPDIR': str(tmp_path),
                              'PYTHONPATH': str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert guard.forbidden_loaded(got['modules']) == []
    assert 'doda_tpu_torch' in {m.split('.')[0] for m in got['modules']}
    root_files = {str(ROOT / 'bench.py')} | {
        str(p) for p in ROOT.glob('BENCH_*.json')}
    assert not root_files & set(got['files'])
    assert got['tf32'] is False


def test_the_harness_names_no_file_of_the_jax_bench():
    for path in HERE.rglob('*.py'):
        if 'tests' in path.relative_to(HERE).parts:
            continue
        text = path.read_text()
        assert not re.search(r'BENCH_r|BASELINE|MULTICHIP|\.\./bench', text)


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / 'reference').glob('*.py'):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ''] if node.level == 0 else []
            else:
                continue
            for mod in mods:
                assert mod.split('.')[0] in ('torch', 'numpy', '__future__',
                                             'typing'), (path.name, mod)
    code = ('import sys, torch, portbench.reference.sparse_unet, '
            'portbench.reference.train; print(sorted(m for m in sys.modules'
            ' if m.split(".")[0] in ("doda_tpu_torch", "doda_tpu", "jax")),'
            ' torch.backends.cuda.matmul.allow_tf32,'
            ' torch.backends.cudnn.allow_tf32)')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.stdout.split() == ['[]', 'False', 'False'], out.stderr


def test_new_files_add_a_configuration_a_mix_and_a_metric(tmp_path):
    """A later PR adds files and entries; no file of the harness
    changes."""
    here = tmp_path / 'portbench'
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns('__pycache__'))
    data = json.loads((ROOT / 'BENCHMARK.json').read_text())
    conf = json.loads((ROOT / data['configs'][0]['file']).read_text())
    (here / 'configs' / 'other_model.json').write_text(json.dumps(conf))
    mix = json.loads((here / 'traffic' / 'eval.rooms_b4.json').read_text())
    mix['streams']['batch']['side_m'] = [5.0, 5.0]
    (here / 'traffic' / 'eval.rooms5_b4.json').write_text(json.dumps(mix))
    (here / 'limits' / 'other_model.eval.rooms5_b4.json').write_text(
        (here / 'limits' / 'scannet.eval.rooms_b4.json').read_text())
    (here / 'metrics' / 'calls_in_window.py').write_text(
        'def read(rec):\n    return float(len(rec["calls"]))\n')
    data['configs'].append({**data['configs'][0], 'name': 'other_model',
                            'file': 'portbench/configs/other_model.json'})
    data['workloads'].append({'name': 'other_model.eval.rooms5_b4',
                              'config': 'other_model',
                              'traffic': 'eval.rooms5_b4', 'chips': 1,
                              'why': 'a later cell'})
    data['end_to_end'].append({'name': 'calls_in_window', 'unit': 'calls',
                               'better': 'higher', 'bound': 0.05,
                               'source': 'host_clock'})
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(data))
    man = Manifest(tmp_path / 'BENCHMARK.json', here)
    cell = man.cell('other_model.eval.rooms5_b4')
    assert man.config(cell['config'])['name'] == 'other_model'
    assert man.traffic(cell['traffic'])['streams']['batch']['side_m'] == \
        [5.0, 5.0]
    names = [m['name'] for m in man.metrics(cell['name'], False)]
    assert 'calls_in_window' in names and 'eval_scenes_per_s' not in names
    assert man.reader('calls_in_window')({'calls': [1, 2]}) == 2.0
    for path in HERE.rglob('*'):
        if path.is_file() and '__pycache__' not in path.parts:
            rel = path.relative_to(HERE)
            assert (here / rel).read_bytes() == path.read_bytes()
