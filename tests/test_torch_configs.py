"""The port's configs against the JAX reference's: all ten architectures,
their smoke versions and shape assignments; the parts not ported yet
(Mamba, cross-attention, the encoder and the frontends) raise naming
ROADMAP A14 (c) or (d)."""
import dataclasses
import re

import pytest

pytest.importorskip("torch")

from repro.configs import ARCH_IDS as JAX_ARCH_IDS  # noqa: E402
from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import shapes_for as jax_shapes_for  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shapes_for  # noqa: E402
from repro_torch.models import lm  # noqa: E402

# the ROADMAP A14 part each still needs
UNPORTED = {"llama-3.2-vision-11b": "(d)", "seamless-m4t-large-v2": "(d)",
            "jamba-1.5-large-398b": "(c)"}


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
    with pytest.raises(NotImplementedError, match="A14 " + re.escape(UNPORTED[arch])):
        lm.model_spec(cfg.smoke() if smoke else cfg)


@pytest.mark.parametrize("kind,part", [("mamba", "(c)"), ("mamba_moe", "(c)"),
                                       ("cross", "(d)")])
def test_unported_block_kinds_name_their_part(kind, part):
    from repro_torch.models import blocks as B
    cfg = get_config("gemma2-9b").smoke()
    with pytest.raises(NotImplementedError, match="A14 " + re.escape(part)):
        B.sublayer_spec(cfg, kind)
    with pytest.raises(NotImplementedError, match="A14 " + re.escape(part)):
        B.sublayer_cache_shape(cfg, kind, 1, 4)
    with pytest.raises(ValueError):
        B.sublayer_spec(cfg, "conv")
