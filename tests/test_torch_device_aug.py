"""The port's on-device augmentation (``doda_tpu_torch/data/device_aug.py``)
held to the JAX package's (``doda_tpu/data/device_aug.py``) on equal
draws. The JAX functions draw from PRNG keys; ``jax_draws`` takes the same
numbers from a key in JAX's own split order, so the port's deterministic
transform can be fed exactly what the JAX function drew.

Floor flips: coords are ``floor(x - min)`` in float32, and the two
packages round the transform differently in the last bits, so a value
within an ulp of an integer can floor either way. Coords must be equal
wherever the port's value before the floor is more than 1e-4 from an
integer, and may differ by exactly 1 inside that band.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import two_threads  # noqa: F401
from doda_tpu.data import device_aug as jaug
from doda_tpu.models.model_fn import PointBatch as JBatch
from doda_tpu_torch.config import CfgNode
from doda_tpu_torch.data import device_aug as taug
from doda_tpu_torch.models import model_fn as tmf
from doda_tpu_torch.utils import optim as toptim

SCALE = 50
BAND = 1e-4


def _aug_cfg(apply_to_feat=False, jitter=True, device=True):
    return CfgNode({
        'enabled': True, 'device': device,
        'aug_list': ['scene_aug', 'elastic', 'crop', 'shuffle'],
        'scene_aug': {'rotation': {'p': 1.0, 'value': [0.1, 0.2, 1.0]},
                      'jitter': jitter, 'flip': {'p': 0.5}},
        # the cfgs' grids: d = 768 // 6 + 3 = 131 and 768 // 20 + 3 = 41
        'elastic': {'enabled': True, 'value': [[6, 40], [20, 160]],
                    'apply_to_feat': apply_to_feat, 'p': 0.8},
        'shuffle': True})


def jax_draws(aug_cfg, voxel_scale, key, b):
    """What ``doda_tpu.data.device_aug.device_augment`` draws from ``key``
    for ``b`` scenes, in the port's ``make_draws`` layout."""
    rows = []
    for k in jax.random.split(key, b):
        ks, ke, kp = jax.random.split(k, 3)
        kj, _, kfp, kr, krp = jax.random.split(ks, 5)
        rows.append({
            'jitter': jax.random.normal(kj, (3, 3)),
            'flip': jax.random.uniform(kfp), 'rot_gate': jax.random.uniform(krp),
            'rot': jax.random.uniform(kr, (3,)),
            'noise': [jax.random.normal(jax.random.fold_in(ke, i),
                                        (3, d, d, d), jnp.float32)
                      for i, (_, _, d) in enumerate(
                          taug.elastic_pairs(aug_cfg, voxel_scale))],
            'elastic_gate': jax.random.uniform(kp)})

    def stack(get):
        return torch.from_numpy(np.stack([np.asarray(get(r)) for r in rows]))
    draws = {k: stack(lambda r, k=k: r[k]) for k in rows[0] if k != 'noise'}
    draws['noise'] = [stack(lambda r, i=i: r['noise'][i])
                      for i in range(len(rows[0]['noise']))]
    return draws


def _batch(seed, b=2, n=256, n_valid=(200, 150)):
    rng = np.random.default_rng(seed)
    xyz = (rng.random((b, n, 3)).astype(np.float32) * 2 - 1) * 2.0
    valid = np.zeros((b, n), bool)
    for i, m in enumerate(n_valid):
        valid[i, :m] = True
    xyz[~valid] = 0.0
    feats = np.concatenate([xyz, rng.random((b, n, 3)).astype(np.float32)],
                           -1)
    labels = np.where(valid, rng.integers(0, 5, (b, n)), 255)
    return (np.zeros((b, n, 3), np.int32), feats, labels.astype(np.int32),
            valid)


def _assert_coords(got, want, positions, valid):
    """Equal, but for floor flips inside the band (module docstring)."""
    frac = np.abs(positions - np.round(positions))
    diff = np.abs(got.astype(np.int64) - want)
    assert (diff[frac > BAND] == 0).all(), diff.max()
    assert (diff <= 1).all()
    assert (got[~valid] == 0).all()
    return int((diff > 0).sum())


def test_blur3_and_elastic_offsets_match_jax():
    rng = np.random.default_rng(0)
    n = rng.normal(size=(2, 3, 17, 17, 17)).astype(np.float32)
    got = taug._blur3(torch.from_numpy(n)).numpy()
    for b in range(2):
        want = np.asarray(jaug._blur3(jnp.asarray(n[b])))
        np.testing.assert_allclose(got[b], want, atol=1e-6, rtol=0)
    d, gran = 17, 4
    xyz = (rng.random((2, 500, 3)).astype(np.float32) * 2 - 1) \
        * (d - 1) * gran * 1.1            # ~10% of queries out of bounds
    got = taug.elastic_offsets(torch.from_numpy(n), gran,
                               torch.from_numpy(xyz)).numpy()
    for b in range(2):
        want = np.asarray(jaug.elastic_offsets(jnp.asarray(n[b]), gran,
                                               jnp.asarray(xyz[b])))
        np.testing.assert_allclose(got[b], want, atol=1e-5, rtol=0)
    assert (got == 0).any(axis=-1).any()        # some fell outside


def test_rotation_matrix_matches_jax_on_its_draws():
    for sa in ({'rotation': {'p': 1.0, 'value': [0.1, 0.2, 1.0]},
                'jitter': True, 'flip': {'p': 0.5}},
               {'rotation': {'p': 0.5, 'value': [0.0, 0.0, 1.0]}},
               {'flip': {'p': 1.0}, 'jitter': False}):
        sa = CfgNode(sa)
        keys = jax.random.split(jax.random.PRNGKey(3), 8)
        rows = []
        for k in keys:
            kj, _, kfp, kr, krp = jax.random.split(k, 5)
            rows.append((jax.random.normal(kj, (3, 3)),
                         jax.random.uniform(kfp), jax.random.uniform(krp),
                         jax.random.uniform(kr, (3,))))
        draws = [torch.from_numpy(np.stack([np.asarray(r[i]) for r in rows]))
                 for i in range(4)]
        got = taug._rotation_matrix(sa, *draws).numpy()
        want = np.stack([np.asarray(jaug._rotation_matrix(sa, k))
                         for k in keys])
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize('apply_to_feat', [False, True])
def test_device_augment_matches_jax(apply_to_feat):
    """Two scenes, the cfgs' elastic grids, equal draws: feats to 1e-5,
    coords under the floor-flip rule."""
    cfg = _aug_cfg(apply_to_feat)
    coords, feats, labels, valid = _batch(1)
    key = jax.random.PRNGKey(7)
    want = jaug.device_augment(cfg, SCALE, JBatch(
        jnp.asarray(coords), jnp.asarray(feats), jnp.asarray(labels),
        jnp.asarray(valid)), key)
    batch = tmf.PointBatch(*(torch.from_numpy(a) for a in
                             (coords, feats, labels, valid)))
    draws = jax_draws(cfg, SCALE, key, 2)
    got = taug.device_augment(cfg, SCALE, batch, draws)
    positions, _ = taug.augmented_positions(cfg, SCALE, batch, draws)
    np.testing.assert_allclose(got.feats.numpy(), np.asarray(want.feats),
                               atol=1e-5, rtol=0)
    _assert_coords(got.coords.numpy(), np.asarray(want.coords),
                   positions.numpy(), valid)
    c = got.coords.numpy()
    for b in range(2):                  # min-shifted to 0 per scene
        assert (c[b][valid[b]].min(0) == 0).all()


def test_aug_fn_for_gating_and_draws():
    data_cfg = CfgNode({'DATA_AUG': _aug_cfg(device=False),
                        'DATA_PROCESSOR': {'voxel_scale': SCALE}})
    assert taug.aug_fn_for(data_cfg) is None
    data_cfg.DATA_AUG.device = True
    for lst, on in ((None, True), (['crop', 'shuffle'], False),
                    (['elastic', 'crop', 'shuffle'], True)):
        assert (taug.aug_fn_for(data_cfg, lst) is not None) == on
        assert (jaug.aug_fn_for(data_cfg, lst) is not None) == on
    data_cfg.DATA_AUG.elastic.enabled = False
    assert taug.aug_fn_for(data_cfg, ['elastic', 'crop']) is None
    _, draw = taug.aug_fn_for(data_cfg)
    d1 = draw(3, torch.Generator().manual_seed(5))
    d2 = draw(3, torch.Generator().manual_seed(5))
    assert sorted(d1) == ['flip', 'jitter', 'rot', 'rot_gate']
    assert all(torch.equal(d1[k], d2[k]) for k in d1)
    assert d1['jitter'].shape == (3, 3, 3)


def test_train_step_with_device_aug_equals_step_on_jax_augmented_batch(
        monkeypatch):
    """The port's train step with DATA_AUG.device on the draws of a JAX key
    equals the port's step without augmentation on the JAX package's
    ``device_augment`` of the batch with that key (loss and updated
    weights 1e-5, histograms exact), in place of the JAX step's compile."""
    def cfg(device):
        return CfgNode({
            'COMMON_CLASSES': {'n_classes': 5},
            'MODEL': {'BACKBONE': {'use_xyz': False, 'in_channel': 6,
                                   'mid_channel': 4, 'block_residual': True,
                                   'block_reps': 1, 'num_levels': 3},
                      'dsnorm': False},
            'DATA_CONFIG': {'DATA_CLASS': {'ignore_label': 255,
                                           'n_classes': 5},
                            'DATA_AUG': _aug_cfg(True, device=device),
                            'DATA_PROCESSOR': {'voxel_scale': SCALE}},
            'OPTIMIZATION': {'optim': 'sgd', 'base_lr': 0.05,
                             'momentum': 0.9, 'weight_decay': 1e-4,
                             'loss': 'cross_entropy'}})
    coords, feats, labels, valid = _batch(2)
    key = jax.random.PRNGKey(11)
    draws = jax_draws(cfg(True).DATA_CONFIG.DATA_AUG, SCALE, key, 2)
    monkeypatch.setattr(taug, 'make_draws', lambda *a, **k: draws)
    jb = jaug.device_augment(cfg(True).DATA_CONFIG.DATA_AUG, SCALE, JBatch(
        jnp.asarray(coords), jnp.asarray(feats), jnp.asarray(labels),
        jnp.asarray(valid)), key)
    batches = (tmf.PointBatch(*(torch.from_numpy(np.asarray(a)) for a in
                                (coords, feats, labels, valid))),
               tmf.PointBatch(*(torch.from_numpy(np.array(a)) for a in jb)))
    caps = (256, 128, 64)
    runs = []
    for device, batch in zip((True, False), batches):
        torch.manual_seed(0)
        c = cfg(device)
        model = tmf.build_model(c, device='cpu', dtype=torch.float32,
                                train=True)
        opt = toptim.build_optimizer(c.OPTIMIZATION, model.parameters())
        out = tmf.make_train_step(c, model, opt, caps, 'cpu')(
            batch, 0.05, step=4)
        runs.append((out, model.state_dict()))
    (a, sa), (b, sb) = runs
    aug = taug.device_augment(cfg(True).DATA_CONFIG.DATA_AUG, SCALE,
                              batches[0], draws)
    assert torch.equal(aug.coords, batches[1].coords)   # no floor flip here
    assert abs(float(a['loss']) - float(b['loss'])) <= 1e-5 * float(b['loss'])
    for k in ('intersection', 'union', 'target', 'count'):
        assert torch.equal(a[k], b[k]), k
    for name, t in sb.items():
        assert (sa[name] - t).abs().max() <= 1e-5 * max(1.0, t.abs().max()), \
            name
