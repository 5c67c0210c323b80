"""One run of one cell: set-up, the measured window, an optional profiled
slice, the check against the reference, and the result line.

Set-up builds the cell's pool of host batches from the seed (audited
against the cfg's brick caps), the program's model, optimizer and step,
and the weights from the seed on the device, which both sides take; then
warms the step up (eval: ``warmup`` calls; training: the ``checked``
steps the reference follows, through the window's own call). The window
then calls the step in a closed loop, one caller, for ``seconds``: the
next call goes in once the previous call's outputs are on the host. A
traced run (``--trace 1``) then profiles ``slice`` more calls. Once the
window has closed and the peak has been read, the program's state is
freed and the reference checks its outputs.
"""

from __future__ import annotations

import gc
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from . import check, guard, port, scenes
from . import traffic as traffic_mod
from .manifest import Manifest
from .reference.plan import build_plan, level_sizes
from .yardstick import counts
from .yardstick import trace as trace_mod


def process_age() -> float | None:
    """Seconds since this process started (Linux), None elsewhere."""
    try:
        with open('/proc/self/stat') as f:
            ticks = int(f.read().rsplit(')', 1)[1].split()[19])
        return time.clock_gettime(time.CLOCK_BOOTTIME) \
            - ticks / os.sysconf('SC_CLK_TCK')
    except (OSError, ValueError, AttributeError, IndexError):
        return None


def load_net(conf: dict, quant: str | None = None):
    """The plain reference that the configuration file names."""
    stem = conf['reference'].rsplit('/', 1)[-1].removesuffix('.py')
    mod = importlib.import_module(f'portbench.reference.{stem}')
    return mod.Net(conf, quant)


def _sync(dev) -> None:
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def _log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def card(dev) -> dict:
    """The card's name, count and power limit."""
    if dev.type != 'cuda':
        return {'platform': 'cpu', 'kind': 'cpu', 'count': 1}
    try:
        smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        smi = 'nvidia-smi: not read'
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(dev),
            'count': 1, 'smi': smi}


def terms(kind: str, conf: dict, traffic: dict, item: dict) -> list:
    """(batch, domain, loss weight) of each term of a training call."""
    if kind == 'train':
        return [(item['batch'], traffic['streams']['batch']['domain'], 1.0)]
    return [(item['source'], traffic['streams']['source']['domain'],
             conf['loss_weight_source']),
            (item['target'], traffic['streams']['target']['domain'],
             conf['loss_weight_target'])]


def work(conf: dict, item: dict, dev) -> dict:
    """The conv's own work of one call on a pool item (every stream)."""
    fwd = train = subm = 0.0
    for batch in item.values():
        plan = build_plan(torch.as_tensor(batch['coords'], device=dev),
                          torch.as_tensor(batch['valid'], device=dev),
                          conf['num_levels'])
        cl = counts.convs(conf, level_sizes(plan), len(plan.points))
        fwd += counts.flops(cl)
        train += counts.flops(cl, train=True)
        subm += counts.subm_least_seconds(cl)
    return {'flops_fwd': fwd, 'flops_train': train, 'subm_least_s': subm}


def _profile(prog, items, order, dev) -> dict | None:
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if dev.type == 'cuda':
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        for idx in order:
            with record_function(trace_mod.CALL_SPAN):
                prog.call(items[idx])
        _sync(dev)
    fd, path = tempfile.mkstemp(suffix='.json')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return trace_mod.read_file(path)
    finally:
        os.unlink(path)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device='cuda', manifest: Manifest | None = None) -> tuple:
    """Run the cell once: (the result line's dict, with the check last;
    notes for standard error: every number the check computed, the card,
    the launch counters a profiled call, the seconds of each phase)."""
    man = manifest or Manifest()
    cell = man.cell(workload)
    conf = man.config(cell['config'])
    traffic = man.traffic(cell['traffic'])
    limits = man.limits(workload)
    kind = traffic['step']
    dev = torch.device(device)

    # -- set-up ------------------------------------------------------------
    phases, mark = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        phases[name] = now - mark[0]
        mark[0] = now

    phases['before'] = process_age()
    if dev.type == 'cuda':
        port.prebuild()
    lap('build')
    cfg = port.load_cfg(conf)
    caps = port.brick_caps(conf)
    pool = traffic_mod.build_pool(traffic, conf['n_classes'], seed)
    for item in pool:
        for batch in item.values():
            scenes.audit(torch.as_tensor(batch['coords'], device=dev),
                         torch.as_tensor(batch['valid'], device=dev), caps,
                         conf['brick'])
    items = [{k: port.point_batch(b) for k, b in item.items()}
             for item in pool]
    lap('scenes')
    net = load_net(conf)
    prog = port.Program(conf, cfg, kind, caps, dev)
    shapes = port.state_shapes(prog.model)
    if shapes != net.names():
        raise ValueError("the program's parameters are not the "
                         "configuration's")
    weights = scenes.seeded_weights(shapes, seed, dev)
    port.load_weights(prog.model, weights)
    n_pool = len(items)
    lap('model')
    if kind == 'eval':
        for i in range(traffic['warmup']):
            prog.call(items[i % n_pool])
        first = 0
    else:
        losses = []
        for i in range(traffic['checked']):
            losses.append(prog.losses(prog.call(items[i])))
            if i == 0:
                grad1 = prog.snapshot(conf['weight_decay'], weights)['grad1']
        program_rec = {'losses': losses, 'grad1': grad1,
                       **prog.snapshot(conf['weight_decay'])}
        first = traffic['checked']
    _sync(dev)
    lap('warmup')
    setup_s = process_age()

    # -- the window --------------------------------------------------------
    pick = np.random.default_rng([int(seed), 1])
    kept, calls, failed = [], [], 0
    if dev.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    i = first
    while not calls or time.perf_counter() - t0 < seconds:
        idx = i % n_pool
        s = time.perf_counter()
        out = prog.call(items[idx])
        e = time.perf_counter()
        calls.append((s, e, idx))
        failed += not port.finite(prog.losses(out))
        if kind == 'eval':
            # a uniform sample of the window's calls (reservoir)
            if len(kept) < traffic['sample']:
                kept.append((idx, out))
            else:
                j = int(pick.integers(len(calls)))
                if j < traffic['sample']:
                    kept[j] = (idx, out)
        i += 1
    window_s = calls[-1][1] - t0
    lap('window')
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == 'cuda' \
        else 0

    # -- the profiled slice ------------------------------------------------
    sliced, launches = None, None
    order = [(i + k) % n_pool for k in range(traffic['slice'])]
    if trace:
        before = port.launch_counters()
        sliced = _profile(prog, items, order, dev)
        after = port.launch_counters()
        launches = {k: (after[k] - before[k]) / len(order) for k in after}
        lap('slice')

    # -- the check, with the program's state freed -------------------------
    del prog, items
    gc.collect()
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    if kind == 'eval':
        served, refs = [], []
        domain = traffic['streams']['batch']['domain']
        classes = conf['n_classes']
        for idx, out in kept:
            batch = pool[idx]['batch']
            rows = check.valid_rows(batch)
            served.append((out['output'].reshape(-1, classes)[rows],
                           out['preds'].reshape(-1)[rows]))
            refs.append(check.eval_reference(net, weights, batch, domain,
                                             dev))
        numbers = check.eval_numbers(served, refs)
        del served, refs, kept
    else:
        steps = [terms(kind, conf, traffic, pool[k])
                 for k in range(traffic['checked'])]
        ref = check.train_reference(net, weights, steps, conf, dev)
        numbers = check.train_numbers(program_rec, ref, weights)
        del ref, program_rec
    ok, checked = check.judge(numbers, limits)
    lap('check')

    # -- the metrics -------------------------------------------------------
    rec = {'kind': kind, 'setup_s': setup_s, 'window_s': window_s,
           'calls': [(s, e) for s, e, _ in calls],
           'scenes_per_call': traffic_mod.scenes_per_call(traffic),
           'peak_bytes': peak, 'trace': sliced, 'work': None,
           'window_items': [c[2] for c in calls], 'slice_items': order}
    if trace:
        rec['work'] = {k: work(conf, pool[k], dev)
                       for k in sorted(set(rec['window_items'] + order))}
    metrics = {}
    for m in man.metrics(workload, trace):
        value = man.reader(m['name'])(rec)
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    info = card(dev)
    device_out = {'platform': info['platform'], 'kind': info['kind'],
                  'count': info['count'], 'memory_peak_bytes': int(peak)}
    result = {'correct': bool(ok and failed == 0), 'attempted': len(calls),
              'failed': failed, 'metrics': metrics, 'device': device_out}
    if trace and sliced is not None:
        device_out['busy_s'] = sliced['busy_s']
        device_out['window_s'] = sliced['window_s']
        result['breakdown'] = {'device_ops': sliced['device_ops'],
                               'idle_gaps': sliced['idle_gaps']}
    result['check'] = checked
    return result, {'numbers': numbers, 'card': info.get('smi'),
                    'launches': launches, 'phases': phases}


def main(args) -> int:
    man = Manifest()
    cell = man.cell(args.workload)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < int(cell['chips']):
        _log(f'portbench: {args.workload} needs {cell["chips"]} CUDA '
             f'card(s); this machine has {cards}')
        return 2
    torch.set_num_threads(4)
    result, notes = run_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace), manifest=man)
    found = guard.forbidden_loaded()
    if found:
        _log(f'portbench: the run loaded {found}; no result')
        return 3
    _log('seconds by phase: ' + json.dumps(notes['phases']))
    _log(f'card: {notes["card"]}')
    if notes['launches'] is not None:
        _log('launch counters a call: ' + json.dumps(notes['launches']))
    for name, c in result['check'].items():
        _log(f'check {name} {c["value"]!r} limit {c["limit"]!r}')
    print(json.dumps(result), flush=True)
    return 0
