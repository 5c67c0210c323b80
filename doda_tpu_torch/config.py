"""Hierarchical YAML config system.

Public surface mirrors the reference framework's config layer
(ref: util/config.py:21-90): a global attribute-dict ``cfg``, YAML files with
recursive ``_BASE_CONFIG_`` inheritance, and dotted-path CLI overrides via
``--set a.b.c val`` with literal-eval type coercion.

Implementation is self-contained (no easydict dependency). PyYAML is
imported only where a file is read, so the package imports without it.
"""

from __future__ import annotations

import copy
from ast import literal_eval
from pathlib import Path


class CfgNode(dict):
    """A dict whose items are also attributes, recursively."""

    def __init__(self, d=None):
        super().__init__()
        if d:
            for k, v in d.items():
                self[k] = v

    def __setitem__(self, key, value):
        if isinstance(value, dict) and not isinstance(value, CfgNode):
            value = CfgNode(value)
        elif isinstance(value, (list, tuple)):
            value = type(value)(
                CfgNode(v) if isinstance(v, dict) and not isinstance(v, CfgNode) else v
                for v in value
            )
        super().__setitem__(key, value)
        super().__setattr__(key, value) if False else None

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __deepcopy__(self, memo):
        out = CfgNode()
        for k, v in self.items():
            out[copy.deepcopy(k, memo)] = copy.deepcopy(v, memo)
        return out


def merge_new_config(config, new_config):
    """Recursively merge ``new_config`` into ``config``.

    ``_BASE_CONFIG_`` entries are loaded (relative to CWD or this repo root)
    and merged first, matching the reference semantics
    (ref: util/config.py:56-74).
    """
    if '_BASE_CONFIG_' in new_config:
        base_path = Path(new_config['_BASE_CONFIG_'])
        if not base_path.exists():
            alt = ROOT_DIR / base_path
            if alt.exists():
                base_path = alt
        import yaml
        with open(base_path, 'r') as f:
            base_cfg = yaml.safe_load(f)
        config.update(CfgNode(base_cfg))
        merge_new_config(config, base_cfg)

    for key, val in new_config.items():
        if key == '_BASE_CONFIG_':
            continue
        if not isinstance(val, dict):
            config[key] = val
            continue
        if key not in config or not isinstance(config[key], dict):
            config[key] = CfgNode()
        merge_new_config(config[key], val)
    return config


def cfg_from_yaml_file(cfg_file, config):
    import yaml
    with open(cfg_file, 'r') as f:
        new_config = yaml.safe_load(f)
    merge_new_config(config=config, new_config=new_config)
    # supervised single-dataset experiments (e.g. front3d/spconv.yaml,
    # which upstream ships without COMMON_CLASSES and with a missing
    # base cfg — it cannot run there): default the common class table
    # from the source dataset so every shipped config is usable.
    if ('COMMON_CLASSES' not in config and 'DATA_CONFIG' in config
            and 'DATA_CLASS' in config.DATA_CONFIG):
        dc = config.DATA_CONFIG.DATA_CLASS
        config['COMMON_CLASSES'] = CfgNode({
            'n_classes': dc.n_classes,
            'class_names': list(dc.class_names)})
    return config


def cfg_from_list(cfg_list, config):
    """Set config keys from a flat [key, value, key, value, ...] list.

    Matches the reference's ``--set`` override semantics including
    type-checked assignment, ``k1:v1,k2:v2`` sub-dict updates, and
    comma-separated list coercion (ref: util/config.py:21-53).
    """
    assert len(cfg_list) % 2 == 0, 'cfg_list must be key/value pairs'
    for k, v in zip(cfg_list[0::2], cfg_list[1::2]):
        key_list = k.split('.')
        d = config
        for subkey in key_list[:-1]:
            assert subkey in d, f'--set: no such config key: {subkey!r}'
            d = d[subkey]
        subkey = key_list[-1]
        assert subkey in d, f'--set: no such config key: {subkey!r}'
        try:
            value = literal_eval(v)
        except (ValueError, SyntaxError):
            value = v

        if type(value) != type(d[subkey]) and isinstance(d[subkey], dict):
            for src in value.split(','):
                cur_key, cur_val = src.split(':')
                val_type = type(d[subkey][cur_key])
                d[subkey][cur_key] = val_type(cur_val)
        elif type(value) != type(d[subkey]) and isinstance(d[subkey], list):
            # '4,5,6' literal_evals to a tuple; 'a,b,c' stays a string
            val_list = list(value) if isinstance(value, tuple) \
                else value.split(',')
            elem_type = type(d[subkey][0]) if len(d[subkey]) else str
            d[subkey] = [elem_type(x) for x in val_list]
        else:
            assert type(value) == type(d[subkey]), (
                f'--set {k}: new value has type {type(value).__name__}, '
                f'existing value is {type(d[subkey]).__name__}')
            d[subkey] = value


def log_config_to_file(cfg_node, pre='cfg', logger=None):
    for key, val in cfg_node.items():
        if isinstance(val, dict):
            logger.info('\n%s.%s = dict()' % (pre, key))
            log_config_to_file(val, pre=pre + '.' + key, logger=logger)
            continue
        logger.info('%s.%s: %s' % (pre, key, val))


ROOT_DIR = (Path(__file__).resolve().parent / '..').resolve()

cfg = CfgNode()
cfg.ROOT_DIR = ROOT_DIR
cfg.LOCAL_RANK = 0
