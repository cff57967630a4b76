"""ZeRO over a gloo CPU world of 4 against the JAX package's
``group_sharded_parallel`` on a mesh of 4 devices, at every level: the
cases and tolerances of ``test_torch_sharding.py`` (a module of its own,
so that the two worlds run on different test workers)."""
import numpy as np
import pytest

import torch_dist_workers as workers
from test_torch_sharding import LEVELS, _hold_world, _inputs


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def world4(inputs, tmp_path_factory):
    d = tmp_path_factory.mktemp("zero4")
    np.savez(d / "inputs.npz", **inputs)
    return workers.run_world("zero", 4, d, timeout=240)


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("kind", ["net", "gpt"])
def test_world4_matches_reference(world4, inputs, kind, level):
    _hold_world(world4, kind, level, inputs)
