"""The port's configs against the JAX reference's: all ten architectures,
their smoke versions and shape assignments, and the model and block
specs each builds (every block kind, the encoder and the frontends)."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.configs import ARCH_IDS as JAX_ARCH_IDS  # noqa: E402
from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import shapes_for as jax_shapes_for  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.spec import count_params as jax_count_params  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shapes_for  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.spec import count_params  # noqa: E402
from test_torch_models import _jax_spec_table, _port_spec_table  # noqa: E402


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


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
@pytest.mark.parametrize("smoke", [False, True])
def test_model_spec_matches_reference(arch, smoke):
    """Every architecture's spec tree (shapes, axes, inits, scales) and
    size, at full and at smoke size: the encoder's, the frontend's and
    every block kind's leaves included."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    if smoke:
        cfg, jcfg = cfg.smoke(), jcfg.smoke()
    spec, jspec = lm.model_spec(cfg), jlm.model_spec(jcfg)
    assert _port_spec_table(spec) == _jax_spec_table(jspec)
    assert count_params(spec) == jax_count_params(jspec)
    assert ("encoder" in spec) == bool(cfg.encoder_layers)
    assert ("frontend_proj" in spec) == bool(cfg.frontend_dim)


@pytest.mark.parametrize("kind", ["mamba", "mamba_moe", "cross"])
def test_block_kinds_build_as_the_reference_does(kind):
    """Mamba, Mamba with MoE and cross-attention on jamba's smoke config and
    (but the MoE kind: gemma2 has no experts) on gemma2's (sandwich norms,
    a GeGLU FFN): the sublayer's spec and its decode cache's shapes and
    dtypes (f32 and bf16 activations) as the reference's; an unknown kind
    raises ``ValueError``, as there."""
    archs = ["jamba-1.5-large-398b"] + ([] if kind.endswith("_moe") else ["gemma2-9b"])
    for arch in archs:
        for dtype in ("float32", "bfloat16"):
            cfg = get_config(arch).smoke().scaled(dtype=dtype, frontend_tokens=5)
            jcfg = jax_get_config(arch).smoke().scaled(dtype=dtype, frontend_tokens=5)
            assert _port_spec_table(B.sublayer_spec(cfg, kind)) == \
                _jax_spec_table(JB.sublayer_spec(jcfg, kind))
            got = B.sublayer_cache_shape(cfg, kind, 3, 7)
            want = JB.sublayer_cache_shape(jcfg, kind, 3, 7)
            assert got.keys() == want.keys()
            for name, (shape, dt) in got.items():
                assert shape == want[name][0]
                assert str(dt).removeprefix("torch.") == want[name][1].__name__
    with pytest.raises(ValueError):
        B.sublayer_spec(cfg, "conv")
    with pytest.raises(ValueError):
        B.sublayer_cache_shape(cfg, "conv", 1, 4)
