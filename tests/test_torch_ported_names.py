"""The reference's public names that the port had no counterpart for,
each held to its JAX function on the same inputs: ``params.param_bytes``,
``params.merge`` and ``layers.untied_unembed_defs``
(``tests/test_torch_surface.py`` holds the rest of the surface)."""

import pytest

from repro.configs import archs as ref_archs
from repro.models import build_model as ref_build
from repro.models import layers as ref_layers
from repro.models import params as ref_params
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import layers, params
from repro_torch.models.encdec import encdec_param_defs
from repro_torch.models.model import lm_param_defs


def port_defs(cfg):
    if cfg.family == "audio" or cfg.n_encoder_layers:
        return encdec_param_defs(cfg)
    return lm_param_defs(cfg)


def same_def(got, want):
    return (tuple(got.shape) == tuple(want.shape) and tuple(got.logical) == tuple(want.logical)
            and got.init == want.init and got.scale == want.scale)


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_param_bytes_equals_the_reference(arch_id, smoke):
    """The port keeps one block per layer where the reference stacks
    segments; the bytes are the same at every width."""
    want_defs = ref_build(ref_archs.get_config(arch_id, smoke=smoke)).param_defs()
    got_defs = port_defs(get_config(arch_id, smoke=smoke))
    for dtype_bytes in (1, 2, 4):
        want = ref_params.param_bytes(want_defs, dtype_bytes)
        assert params.param_bytes(got_defs, dtype_bytes) == want
    assert params.param_bytes(got_defs) == ref_params.param_bytes(want_defs)


def test_merge_equals_the_reference():
    a = {"x": 1, "y": {"z": 2}}
    b = {"w": 3}
    assert params.merge(a, b) == ref_params.merge(a, b) == {"x": 1, "y": {"z": 2}, "w": 3}
    assert params.merge() == ref_params.merge() == {}
    for merge in (params.merge, ref_params.merge):
        with pytest.raises(KeyError, match="duplicate param key x"):
            merge(a, {"x": 4})


@pytest.mark.parametrize("vocab,d_model", [(256, 64), (49152, 4096), (129280, 7168)])
def test_untied_unembed_defs_equal_the_reference(vocab, d_model):
    got = layers.untied_unembed_defs(vocab, d_model)
    want = ref_layers.untied_unembed_defs(vocab, d_model)
    assert set(got) == set(want) == {"w_out"}
    assert same_def(got["w_out"], want["w_out"])


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_untied_models_declare_the_reference_s_unembedding(arch_id):
    cfg = get_config(arch_id, smoke=True)
    got = port_defs(cfg).get("unembed")
    want = ref_build(ref_archs.get_config(arch_id, smoke=True)).param_defs().get("unembed")
    assert (got is None) == (want is None) == bool(cfg.tie_embeddings)
    if got is not None:
        assert same_def(got["w_out"], want["w_out"])
