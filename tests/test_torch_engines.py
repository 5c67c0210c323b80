"""The port's subm-conv engines in the net vs the JAX package's switches.

``build_model(conv_engine=..., deep_xla_rows=...)`` is the port's
counterpart of ``DODA_CONV`` and ``DODA_DEEP_XLA``. A 2-level float32 net
with weights from ``params_from_jax`` runs on each engine against the flax
net under the matching (monkeypatched) variable, traced afresh: logits and
``return_mid_feat``'s point features to 1e-3, and each side's calls of the
engine's conv counted (the JAX package's blocks drop their slab maps, so
there 'slab' reaches the input conv alone; in the port every conv of a
slab level). The ``fuse_norm`` x engine rule is held to the JAX package's
``_fuse_norm_ok`` and, on a 3-level net, to the convs that run fused;
``subm_routes`` counts the flagship's convs by engine.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from doda_tpu.models import unet as junet
from doda_tpu.ops import bricks as jbricks
from doda_tpu.ops import slabs as jslabs
from doda_tpu_torch.config import CfgNode
from doda_tpu_torch.models import model_fn as tmf
from doda_tpu_torch.models import unet as tunet
from doda_tpu_torch.utils.convert import params_from_jax

F32 = jnp.float32
CAPS = junet.default_brick_caps(256, 2, floor=32)    # (256, 128)
# (JAX variables, port arguments, the engine's conv in each package, its
# calls: JAX, port). The flat rows are 512 and 256: DODA_DEEP_XLA=300
# sends level 1 alone.
CASES = {
    'slab': ({'DODA_CONV': 'slab'}, dict(conv_engine='slab'),
             (jslabs, 'subm_conv3_slab'), 'subm_conv3_slab', (1, 7)),
    'xla': ({'DODA_CONV': 'xla'}, dict(conv_engine='xla'),
            (jbricks, 'subm_conv3_v2'), 'subm_conv3_v2', (7, 7)),
    'oracle': ({'DODA_CONV': 'oracle'}, dict(conv_engine='oracle'),
               (junet, 'subm_conv3'), 'subm_conv3', (7, 7)),
    'deep_xla': ({'DODA_DEEP_XLA': '300'}, dict(deep_xla_rows=300),
                 (jbricks, 'subm_conv3_v2'), 'subm_conv3_v2', (2, 2)),
}


def _cfg(levels=2):
    return CfgNode({
        'COMMON_CLASSES': {'n_classes': 5},
        'MODEL': {'BACKBONE': {'use_xyz': False, 'in_channel': 3,
                               'mid_channel': 8, 'block_residual': True,
                               'block_reps': 1, 'num_levels': levels},
                  'dsnorm': False},
        'DATA_CONFIG': {'DATA_CLASS': {'ignore_label': 255,
                                       'n_classes': 5}},
        'OPTIMIZATION': {'loss': 'cross_entropy'}})


def _batch(seed=0, extent=40):
    rng = np.random.default_rng(seed)
    coords = rng.integers(0, extent, (2, 400, 3)).astype(np.int32)
    valid = np.zeros((2, 400), bool)
    valid[:, :320] = True
    feats = rng.normal(size=(2, 400, 3)).astype(np.float32)
    feats[~valid] = 0.0
    return coords, valid, feats


def _variables(shapes, rng):
    def fill(path, leaf):
        name = path[-1].key
        if name == 'mean':
            return rng.normal(0, 0.2, leaf.shape)
        if name == 'var':
            return rng.uniform(0.5, 1.5, leaf.shape)
        if name == 'scale':
            return 1 + rng.normal(0, 0.2, leaf.shape)
        if name == 'bias':
            return rng.normal(0, 0.3, leaf.shape)
        fan_in = leaf.shape[0] * (leaf.shape[1] if leaf.ndim == 3 else 1)
        b = (1.0 / fan_in) ** 0.5
        return rng.uniform(-b, b, leaf.shape)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: fill(p, x).astype(np.float32), shapes)


@pytest.fixture(scope='module')
def net():
    coords, valid, feats = _batch()
    model = junet.SparseConvNet(mid_channel=8, num_levels=2, block_reps=1,
                                n_classes=5, dtype=F32)
    plan = junet.build_level_plan(jnp.asarray(coords), jnp.asarray(valid),
                                  CAPS)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), feats,
                                               plan, train=False))
    variables = _variables(shapes, np.random.default_rng(1))
    return model, plan, variables, (coords, valid, feats)


def _counted(monkeypatch, owner, name, calls):
    fn = getattr(owner, name)

    def counting(*a, **k):
        calls.append(name)
        return fn(*a, **k)
    monkeypatch.setattr(owner, name, counting)


@pytest.mark.parametrize('case', sorted(CASES))
def test_engine_matches_flax(net, case, monkeypatch):
    model, plan, variables, (coords, valid, feats) = net
    env, kw, (jowner, jname), tname, (n_jax, n_port) = CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jcalls, tcalls = [], []
    _counted(monkeypatch, jowner, jname, jcalls)
    # a fresh trace reads the variables; a cached one would not
    want_f, want = (np.asarray(a) for a in jax.jit(lambda v: model.apply(
        v, jnp.asarray(feats), plan, train=False,
        return_mid_feat=True))(variables))
    assert len(jcalls) == n_jax, jcalls

    port = tmf.build_model(_cfg(), device='cpu', dtype=torch.float32, **kw)
    port.load_state_dict(params_from_jax(variables['params'],
                                         variables['batch_stats']),
                         strict=True)
    _counted(monkeypatch, tunet, tname, tcalls)
    tplan = tunet.build_level_plan(coords, valid, CAPS, device='cpu',
                                   slabs=case == 'slab')
    with torch.no_grad():
        got_f, got = port(torch.from_numpy(feats), tplan,
                          return_mid_feat=True)
    assert len(tcalls) == n_port, tcalls
    for g, w in ((got, want), (got_f, want_f)):
        assert g.shape == w.shape
        err = np.abs(g.numpy() - w)[valid].max()
        assert err <= 1e-3 * max(1.0, np.abs(w).max()), (case, err)
    assert np.abs(want_f).max() > 1e-2
    routes = port.subm_routes(level_rows=[2 * c for c in CAPS])
    engine = kw.get('conv_engine', 'xla')
    assert routes[engine] == n_port
    assert routes['f32'] == 7 - n_port


def test_fuse_norm_engine_rule(monkeypatch):
    """Where the fused norm engine applies: the port's rule against the
    JAX package's ``_fuse_norm_ok`` for every engine, with and without
    slab maps; then a 3-level net fused against unfused on each engine,
    counting the convs that ran fused."""
    for engine in tunet.CONV_ENGINES:
        monkeypatch.setenv('DODA_FUSE_NORM', '1')
        monkeypatch.setenv('DODA_CONV', engine)
        for slab in (None, 'maps'):
            fl = junet.FlatLevel(occ=None, nbr=None, slab=slab)
            assert tunet.fuse_norm_ok(engine, slab is not None) == \
                junet._fuse_norm_ok(fl), (engine, slab)

    caps = junet.default_brick_caps(256, 3, floor=32)
    coords, valid, feats = _batch(seed=2)
    # input conv + 2 + 2 at level 0, 2 + 2 at level 1, 2 at level 2
    want = {'2d': (10, 2, 0), 'slab': (2, 0, 9), 'xla': (0, 0, 11),
            'oracle': (0, 0, 11)}
    names = {'slab': 'subm_conv3_slab', 'xla': 'subm_conv3_v2',
             'oracle': 'subm_conv3'}
    for engine, (n_norm, n_down, n_engine) in want.items():
        outs = {}
        for fuse in (False, True):
            calls = []
            with pytest.MonkeyPatch.context() as mp:
                for name in ('subm_conv3_norm_2d', 'down_conv2_norm_2d',
                             *names.values()):
                    _counted(mp, tunet, name, calls)
                torch.manual_seed(0)
                model = tmf.build_model(_cfg(3), device='cpu',
                                        dtype=torch.float32, fuse_norm=fuse,
                                        conv_engine=engine)
                if fuse:
                    model.load_state_dict(sd)
                else:
                    sd = model.state_dict()
                plan = tunet.build_level_plan(coords, valid, caps, 'cpu',
                                              slabs=engine == 'slab')
                with torch.no_grad():
                    outs[fuse] = model(torch.from_numpy(feats), plan)
            if fuse:
                assert calls.count('subm_conv3_norm_2d') == n_norm, engine
                assert calls.count('down_conv2_norm_2d') == n_down, engine
                assert len(calls) - n_norm - n_down == (
                    n_engine if engine != '2d' else 0), (engine, calls)
                routes = model.subm_routes()
                assert routes.get(engine, 0) == n_engine, routes
                assert routes['f32'] == 11 - n_engine, routes
        torch.testing.assert_close(outs[True], outs[False], rtol=1e-4,
                                   atol=1e-4)


def test_subm_routes_by_engine():
    """The flagship's 53 subm convs (mid 16, 7 levels, 2 blocks a level)
    by engine at the bench batch's flat rows (4 scenes)."""
    rows = [4 * c for c in (40960, 16384, 3328, 768, 256, 128, 128)]
    base = {'sm': 0, 'narrow': 0, 'f32': 0, 'assembled': 0}

    def routes(fuse_norm=False, **kw):
        model = tunet.SparseConvNet(mid_channel=16, num_levels=7,
                                    fuse_norm=fuse_norm, **kw)
        return (model.subm_routes(level_rows=rows),
                model.subm_routes(True, level_rows=rows))

    assert routes() == ({**base, 'fused': 52, 'narrow': 1},
                        {**base, 'fused': 52})
    # levels 0 and 1 carry slab maps: 9 + 8 convs, 8 + 8 dx convs
    assert routes(conv_engine='slab') == (
        {**base, 'fused': 36, 'slab': 17}, {**base, 'fused': 36, 'slab': 16})
    for engine in ('xla', 'oracle'):
        assert routes(conv_engine=engine) == (
            {**base, 'fused': 0, engine: 53}, {**base, 'fused': 0,
                                               engine: 52})
    # levels 3-6 hold 3,072 / 1,024 / 512 / 512 flat rows <= 4,096
    assert routes(deep_xla_rows=4096) == (
        {**base, 'fused': 24, 'narrow': 1, 'xla': 28},
        {**base, 'fused': 24, 'xla': 28})
    # the fused norm engine: on '2d' every block conv, deep levels too;
    # under 'slab' the levels without slab maps
    pro = {**base, 'fused': 0, 'narrow': 1, 'prologue': 52, 'xla': 0}
    assert routes(True, deep_xla_rows=4096)[0] == pro
    assert routes(True, conv_engine='slab')[0] == {
        **base, 'fused': 0, 'prologue': 36, 'slab': 17}

    with pytest.raises(ValueError, match='conv_engine'):
        tunet.SparseConvNet(conv_engine='bogus')
    with pytest.raises(ValueError, match='level_rows'):
        tunet.SparseConvNet(deep_xla_rows=64).subm_routes()
    coords, valid, feats = _batch()
    plan = tunet.build_level_plan(coords, valid, CAPS, 'cpu')
    model = tmf.build_model(_cfg(), device='cpu', conv_engine='slab')
    with pytest.raises(ValueError, match='slabs=True'):
        model(torch.from_numpy(feats), plan)
