"""The port's config presets against aide_tpu's: every preset, field by field.

Both packages build each preset from the same data root; the port's
``TrainConfig`` tree (``dataclasses.asdict``) must equal the JAX package's,
and the port must have exactly the JAX package's preset names.
"""

import dataclasses

import pytest

from aide_tpu.cli import presets as jpresets

from aide_tpu_torch.cli import presets

NAMES = sorted(jpresets.PRESETS)


def test_same_preset_names():
    assert sorted(presets.PRESETS) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_preset_equals_jax(name):
    got = dataclasses.asdict(presets.get_preset(name, "/data"))
    want = dataclasses.asdict(jpresets.get_preset(name, "/data"))
    assert got == want


def test_unknown_preset_raises():
    with pytest.raises(KeyError, match="unknown preset"):
        presets.get_preset("kidney_proposed_mask9")
