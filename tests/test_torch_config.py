"""tpu_rvc_torch's presets against tpu_rvc's: `hparams_for` gives the same
configuration for each version and rate."""

import dataclasses

import pytest

from tpu_rvc.core.config import hparams_for as jax_hparams_for

from tpu_rvc_torch.core.config import hparams_for


@pytest.mark.parametrize("version,sr", [("v1", 32000), ("v1", 40000),
                                        ("v1", 48000), ("v2", 32000),
                                        ("v2", 40000), ("v2", 48000)])
def test_presets_match_hparams_for(version, sr):
    assert dataclasses.asdict(hparams_for(version, sr)) == \
        dataclasses.asdict(jax_hparams_for(version, sr))
