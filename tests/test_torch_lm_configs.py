"""The port's architecture registry equals the reference's, field for
field: all ten architectures, their ``reduced`` forms (default and the
launcher's overrides), the shape suite and the parameter counts."""
import dataclasses

import pytest

from repro import configs as RC
from repro_torch import configs as TC

ARCHS = sorted(RC.ARCHS)


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_registry_names():
    assert sorted(TC.ARCHS) == ARCHS
    with pytest.raises(KeyError, match="unknown arch"):
        TC.get_arch("nope")


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_fields_equal_reference(arch):
    r, t = RC.get_arch(arch), TC.get_arch(arch)
    assert _fields(t) == _fields(r)
    for prop in ("hd", "is_moe", "is_attention_free", "sub_quadratic",
                 "d_inner"):
        assert getattr(t, prop) == getattr(r, prop), prop
    assert t.n_params() == r.n_params()
    assert t.n_active_params() == r.n_active_params()


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_equals_reference(arch):
    r, t = RC.get_arch(arch), TC.get_arch(arch)
    assert _fields(TC.reduced(t)) == _fields(RC.reduced(r))
    over = dict(d_model=256, n_layers=4, n_heads=8, d_ff=1024, head_dim=32)
    assert _fields(TC.reduced(t, **over)) == _fields(RC.reduced(r, **over))


def test_shapes_equal_reference():
    assert [dataclasses.astuple(s) for s in TC.SHAPES] == \
        [dataclasses.astuple(s) for s in RC.SHAPES]
    for s in RC.SHAPES:
        assert dataclasses.astuple(TC.get_shape(s.name)) == \
            dataclasses.astuple(s)
