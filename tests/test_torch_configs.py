"""The port's twelve architecture configs are the JAX package's, field for
field, full and SMOKE."""
import dataclasses

import pytest

import repro.configs as jax_configs
import repro_torch.configs as torch_configs


def test_same_arch_ids():
    assert torch_configs.ARCH_IDS == jax_configs.ARCH_IDS


@pytest.mark.parametrize("arch", jax_configs.ARCH_IDS)
def test_config_fields_equal(arch):
    for getter in ("get", "get_smoke"):
        want = getattr(jax_configs, getter)(arch)
        got = getattr(torch_configs, getter)(arch)
        assert [f.name for f in dataclasses.fields(got)] == \
            [f.name for f in dataclasses.fields(want)]
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.hd == want.hd
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
