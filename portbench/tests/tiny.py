"""A tiny copy of the benchmark for the CPU tests: the real configuration
files cut to 3 levels of width 8 (cfg and file alike), float32, rooms of
0.3-0.5 m, and limits for a float32 program against the float32
reference."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench.manifest import HERE, ROOT, Manifest

CUT = {'mid_channel': 8, 'num_levels': 3, 'brick_cap': 512,
       'dtype': 'float32',
       'cfg_set': {'MODEL.BACKBONE.mid_channel': 8,
                   'MODEL.BACKBONE.num_levels': 3,
                   'DATA_CONFIG.DATA_PROCESSOR.brick_cap': 512}}
STREAM = {'scenes': 2, 'side_m': [0.3, 0.5], 'n_cap': 1024,
          'ignore_share': 0.0, 'domain': 0}
TRAFFIC = {
    'eval': {'step': 'eval', 'pool': 3, 'warmup': 1, 'sample': 2,
             'slice': 1, 'streams': {'batch': STREAM}},
    'train': {'step': 'train', 'pool': 3, 'checked': 3, 'slice': 1,
              'streams': {'batch': STREAM}},
    'st': {'step': 'st', 'pool': 3, 'checked': 3, 'slice': 1,
           'streams': {'source': STREAM,
                       'target': {**STREAM, 'ignore_share': 0.3,
                                  'domain': 1}}},
}
LIMITS = {
    'eval': {'logit_rel_rms': 1e-4, 'pred_gap': 1e-3},
    'train': {'loss_gap': 1e-4, 'grad_gap': 1e-3, 'change_gap': 1e-3,
              'momentum_gap': 1e-3, 'stats_gap': 1e-3},
}
CELLS = {'tiny.eval': ('scannet_spconv', 'eval'),
         'tiny.train': ('scannet_spconv', 'train'),
         'tiny.st': ('da_front3d_scannet_st', 'st')}


def tiny_manifest(tmp: Path) -> Manifest:
    """A manifest in ``tmp`` whose cells are ``CELLS``."""
    real = json.loads((ROOT / 'BENCHMARK.json').read_text())
    here = tmp / 'portbench'
    shutil.copytree(HERE / 'metrics', here / 'metrics')
    for sub in ('configs', 'traffic', 'limits'):
        (here / sub).mkdir(parents=True)
    configs = []
    for c in real['configs']:
        conf = json.loads((ROOT / c['file']).read_text())
        conf.update(CUT)
        (here / 'configs' / f'{c["name"]}.json').write_text(json.dumps(conf))
        configs.append({**c, 'file': f'portbench/configs/{c["name"]}.json'})
    workloads = []
    for name, (config, step) in CELLS.items():
        (here / 'traffic' / f'{step}.json').write_text(
            json.dumps(TRAFFIC[step]))
        (here / 'limits' / f'{name}.json').write_text(
            json.dumps(LIMITS['eval' if step == 'eval' else 'train']))
        workloads.append({'name': name, 'config': config, 'traffic': step,
                          'chips': 1, 'why': 'tiny'})
    kinds = {'eval': ['tiny.eval'], 'train': ['tiny.train', 'tiny.st']}

    def cells(m):
        w = m.get('workloads')
        if w is None:
            return m
        kind = 'eval' if any('eval' in x for x in w) else 'train'
        return {**m, 'workloads': kinds[kind]}

    data = {**real, 'configs': configs, 'workloads': workloads,
            'end_to_end': [cells(m) for m in real['end_to_end']],
            'per_layer': [cells(m) for m in real['per_layer']]}
    (tmp / 'BENCHMARK.json').write_text(json.dumps(data))
    return Manifest(tmp / 'BENCHMARK.json', here)
