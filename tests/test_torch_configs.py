"""The port's twelve architecture configs are the JAX package's, field for
field, full and SMOKE, with the port's own fields (``PORT_FIELDS``) at the
defaults that keep the reference's arithmetic."""
import dataclasses

import pytest

import repro.configs as jax_configs
import repro_torch.configs as torch_configs
from repro_torch.models.model import PORT_FIELDS

# the port's own fields where a config keeps the reference's arithmetic
REFERENCE_DEFAULTS = {"norm_topk_prob": True, "qk_norm_whole": False,
                      "norm_eps": 1e-6}


def test_same_arch_ids():
    assert torch_configs.ARCH_IDS == jax_configs.ARCH_IDS


@pytest.mark.parametrize("arch", jax_configs.ARCH_IDS)
def test_config_fields_equal(arch):
    for getter in ("get", "get_smoke"):
        want = getattr(jax_configs, getter)(arch)
        got = getattr(torch_configs, getter)(arch)
        assert [f.name for f in dataclasses.fields(got)
                if f.name not in PORT_FIELDS] == \
            [f.name for f in dataclasses.fields(want)]
        port = dataclasses.asdict(got)
        assert {k: port.pop(k) for k in PORT_FIELDS} == REFERENCE_DEFAULTS
        assert port == dataclasses.asdict(want)
        assert got.hd == want.hd
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
