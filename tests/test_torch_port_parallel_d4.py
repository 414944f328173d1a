"""The port's gauss+tile flagship step on four gloo ranks against JAX's
`make_flagship_gauss_tile_step`: a 1D mesh of 4 (k = 3: each rank blends
one tile row of the 64-row frame) and the 2 x 2 mesh (k = 4, two cameras
per camera group), at tests/test_torch_port_parallel_steps.py's inputs and
tolerances.
"""
import pytest

from tests.test_torch_port_parallel_steps import (CASES, check_step,
                                                  inputs, spawn_steps)
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

MESHES = {"gauss_tile_d4": 4, "gauss_tile_2x2": (2, 2)}
assert all(CASES[n][3] == m for n, m in MESHES.items())
_ = inputs      # the module-scoped fixture, shared by name


@pytest.mark.parametrize("name", list(MESHES))
def test_sharded_flagship_step_on_four_ranks_matches_jax(name, inputs,
                                                         tmp_path):
    results = spawn_steps(inputs, str(tmp_path), MESHES[name])[name]
    assert len(results) == 4
    check_step(name, inputs, results)
