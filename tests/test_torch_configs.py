"""The port's configs against the JAX reference's: all ten architectures,
their smoke versions and shape assignments; unported block kinds raise
naming ROADMAP A14."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.configs import ARCH_IDS as JAX_ARCH_IDS  # noqa: E402
from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import shapes_for as jax_shapes_for  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shapes_for  # noqa: E402
from repro_torch.models import lm  # noqa: E402

UNPORTED = [a for a in JAX_ARCH_IDS if a != "xlstm-350m"]


def test_arch_ids_and_shapes_match_reference():
    assert ARCH_IDS == JAX_ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_config_matches_reference(arch):
    cfg, want = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    assert dataclasses.asdict(cfg.smoke()) == dataclasses.asdict(want.smoke())
    for c, w in ((cfg, want), (cfg.smoke(), want.smoke())):
        assert (c.padded_vocab, c.n_groups, c.resolved_head_dim, c.is_moe) == \
            (w.padded_vocab, w.n_groups, w.resolved_head_dim, w.is_moe)
    assert dataclasses.asdict(cfg.scaled(dtype="float32")) == \
        dataclasses.asdict(want.scaled(dtype="float32"))


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_shapes_for_matches_reference(arch):
    got = [dataclasses.asdict(s) for s in shapes_for(get_config(arch))]
    want = [dataclasses.asdict(s) for s in jax_shapes_for(jax_get_config(arch))]
    assert got == want


def test_unknown_arch_raises():
    with pytest.raises(KeyError):
        get_config("gpt-2")


@pytest.mark.parametrize("arch", UNPORTED)
@pytest.mark.parametrize("smoke", [False, True])
def test_unported_kinds_raise_naming_a14(arch, smoke):
    cfg = get_config(arch)
    with pytest.raises(NotImplementedError, match="A14"):
        lm.model_spec(cfg.smoke() if smoke else cfg)


def test_xlstm_with_a_dense_ffn_raises_naming_a14():
    cfg = get_config("xlstm-350m").smoke().scaled(d_ff=128)
    with pytest.raises(NotImplementedError, match="A14"):
        lm.model_spec(cfg)
