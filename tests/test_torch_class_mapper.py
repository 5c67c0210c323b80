"""The port's class-mapper tables equal the JAX package's, for every
mapper name, given as the reference-style JSON path."""

import numpy as np
import pytest

from _torch_threads import two_threads  # noqa: F401
from doda_tpu.data import class_mapper as jmapper
from doda_tpu_torch.data import class_mapper as tmapper


@pytest.mark.parametrize('name', sorted(jmapper.MAPPERS))
def test_class_mapper_tables_match(name):
    jt, jn = jmapper.get_mapper(name)
    tt, tn = tmapper.get_mapper(f'dataset/class_mapper/{name}.json')
    np.testing.assert_array_equal(tt, jt)
    assert tn == jn
