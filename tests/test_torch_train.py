"""The port's train step as a whole vs the JAX package, two steps (see
tests/_torch_train_common.py): loss, gradients, updated parameters and
running statistics must agree to 1e-3, the bound of the eval logits in
tests/test_torch_model.py; both engines ran forward and backward.
"""

import numpy as np
import pytest

from _torch_threads import two_threads  # noqa: F401
from _torch_train_common import port_run, reference  # noqa: F401
from _torch_train_common import _assert_trees_close, _flat, N_CLASSES, TOL


@pytest.mark.parametrize('i', [0, 1])
def test_loss_and_metrics(reference, port_run, i):
    want, got = reference[2][i], port_run[1][i]['metrics']
    assert set(got) == {'loss', 'intersection', 'union', 'target', 'count'}
    assert abs(float(got['loss']) - want['loss']) <= TOL * want['loss']
    assert int(got['count']) == want['count'] == int(got['target'].sum())
    assert got['intersection'].shape == (N_CLASSES,)
    assert not got['loss'].requires_grad


@pytest.mark.parametrize('i', [0, 1])
def test_gradients(reference, port_run, i):
    want, got = reference[2][i]['grads'], port_run[1][i]['grads']
    assert max(np.abs(v).max() for v in want.values()) > 1e-2
    _assert_trees_close(got, want, f'step {i} gradient')


def test_updated_parameters_and_running_statistics(reference, port_run):
    _, variables, _, want_p, want_s = reference
    _, _, got_p, got_s, _ = port_run
    _assert_trees_close(got_p, want_p, 'parameter')
    _assert_trees_close(got_s, want_s, 'running statistic')
    start = {**dict(_flat(variables['params'])),
             **dict(_flat(variables['batch_stats']))}
    for name, v in {**want_p, **want_s}.items():    # everything moved
        assert np.abs(v - start[name]).max() > 1e-6, name


def test_both_engines_ran_forward_and_backward(port_run):
    """Per step: 1 input conv + 2 levels x 2 + 1 tail x 2 = 7 forward
    convs, 3 of them on K2, and 6 dx convs (the input conv's is skipped),
    4 of them on K2."""
    engines = port_run[4]
    assert len(engines) == 2 * (7 + 6)
    fwd, bwd = engines[:7], engines[7:13]
    assert sum(fwd) == 3 and sum(bwd) == 4, (fwd, bwd)
