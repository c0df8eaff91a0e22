"""The port's copies of the JAX package's `core/energy.py` and the
`core/raster.py` import shim: the energy model's constants and values equal
JAX's, and the shim's names are the port's render functions."""

import dataclasses

import numpy as np
import pytest

from repro.core import energy as jenergy
from repro.core import raster as jraster
from repro_torch import render
from repro_torch.core import energy, raster
from repro_torch.render import common, stages


def test_energy_constants_equal_jax():
    for name in ("DRAM_J_PER_BYTE", "SRAM_J_PER_BYTE", "MAC_J", "COMM_J_PER_BYTE"):
        assert getattr(energy, name) == getattr(jenergy, name), name


@pytest.mark.parametrize("seed", range(4))
def test_client_frame_energy_equals_jax(seed):
    rng = np.random.default_rng(seed)
    args = [float(x) for x in rng.uniform(0, 1e9, 4)]
    if seed == 0:
        args = [0.0, 0.0, 0.0, 0.0]
    ours, theirs = energy.client_frame_energy(*args), jenergy.client_frame_energy(*args)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.total_j == theirs.total_j


def test_raster_shim_names_the_render_functions():
    assert raster.render_tiles is stages.render_tiles is render.render_tiles
    assert raster.render_reference is stages.render_reference
    assert raster.eye_views is common.eye_views
    assert raster._alpha is raster.pixel_alpha is common.pixel_alpha
    assert sorted(raster.__all__) == sorted(jraster.__all__)
