"""The port's copies of ModelConfig and the registry equal the reference's."""
import dataclasses

import pytest

from repro.configs.registry import ARCHS as JARCHS, get as jget
from repro.models import config as JCFG
from repro_torch.configs.registry import ARCHS as TARCHS, get as tget
from repro_torch.models import config as TCFG


def test_same_arch_ids():
    assert list(TARCHS) == list(JARCHS)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_config_fields_and_derived(arch, smoke):
    t, j = tget(arch, smoke=smoke), jget(arch, smoke=smoke)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.resolved_head_dim == j.resolved_head_dim
    assert t.num_groups == j.num_groups
    assert t.layer_kinds() == j.layer_kinds()
    assert t.supports_long_decode() == j.supports_long_decode()
    assert TCFG.param_count(t) == JCFG.param_count(j)
    assert TCFG.active_param_count(t) == JCFG.active_param_count(j)
