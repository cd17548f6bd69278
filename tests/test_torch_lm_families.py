"""The port's other LM families (rwkv, hybrid, encdec) held against the JAX
package at reduced size, the reference's jamba-is-stateful check on the
port, and qwen2-1.5b at its published width over one layer.  Inputs, the
reference program and the tolerances are those of
``tests/torch_lm_reference.py``.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch_lm_reference as R  # noqa: E402

from repro.configs.base import ARCH_IDS, get_config as j_get_config  # noqa: E402
from repro.configs.base import get_reduced_config as j_get_reduced  # noqa: E402
from repro.models.model_api import get_model as j_get_model  # noqa: E402
from repro.serving.serve_step import _copy_cache as j_copy_cache  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.models.model_api import get_model  # noqa: E402
from repro_torch.serving.serve_step import _copy_cache  # noqa: E402

ARCHS = [a for a in ARCH_IDS if j_get_reduced(a).family in ("rwkv", "hybrid", "encdec")]
JAMBA = "jamba-1.5-large-398b"


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_matches_reference(arch):
    R.check_loss(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_prefill_logits_and_cache_match_reference(arch):
    R.check_prefill(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_decode_steps_match_reference(arch):
    R.check_decode_steps(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_greedy_generate_matches_reference(arch):
    R.check_greedy(arch)


@pytest.mark.parametrize("arch", [a for a in ARCHS if j_get_reduced(a).num_experts])
def test_lm_routing_matches_reference(arch):
    R.check_routing(arch)


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != JAMBA])
def test_port_decode_matches_prefill(arch):
    """(Jamba's prefill zeroes its Mamba decode states on purpose, so its
    decode cannot match a longer prefill; it is checked below.)"""
    R.check_port_decode_matches_prefill(arch)


def test_port_jamba_decode_is_stateful():
    cfg, params, _ = R.port_inputs(JAMBA)
    impl = get_model(cfg)
    cache = impl.init_cache(cfg, R.B, R.T, device="cpu")
    cache["pos"] = torch.tensor(0, dtype=torch.int32)
    tok = torch.zeros((R.B, 1), dtype=torch.int32)
    logits1, cache = impl.decode_step(params, cache, {"tokens": tok}, cfg)
    logits2, cache = impl.decode_step(params, cache, {"tokens": tok}, cfg)
    assert torch.isfinite(logits1).all()
    # state must influence the second step (mamba / attention carry)
    assert not torch.allclose(logits1, logits2)


def _j_prefill_decode(params, batch, cfg):
    """The JAX package's prefill and one greedy decode step after it."""
    impl = j_get_model(cfg)
    logits, cache = impl.prefill(params, batch, cfg)
    big = j_copy_cache(cache, impl.init_cache(cfg, batch["tokens"].shape[0],
                                              batch["tokens"].shape[1] + 1))
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    return logits, tok, impl.decode_step(params, big, {"tokens": tok}, cfg)[0]


def test_qwen2_full_width_one_layer_matches_reference():
    """qwen2-1.5b's published width (d 1536, vocab 151,936, 12 / 2 heads,
    d_ff 8,960, QKV bias) with num_layers = 1, f32, B 1, T 8: the prefill
    logits and one decode step against the JAX package (f32 tolerance)."""
    j_cfg = dataclasses.replace(j_get_config("qwen2-1.5b"), num_layers=1, dtype="float32")
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), num_layers=1, dtype="float32")
    assert (cfg.d_model, cfg.vocab_size, cfg.num_heads, cfg.kv_heads, cfg.d_ff) == (
        1536, 151936, 12, 2, 8960)
    params = R.np_params(j_cfg, seed=2)
    batch = R._no_labels(R.np_batch(j_cfg, b=1, t=8, seed=2))
    want_logits, tok, want_dec = R.fast_jit(
        functools.partial(_j_prefill_decode, cfg=j_cfg), params, batch)
    t_params = lm_params_from_reference(params, cfg, device="cpu")
    del params
    impl = get_model(cfg)
    logits, cache = impl.prefill(t_params, R._t(batch), cfg)
    R.close(logits, want_logits, cfg, "prefill logits")
    assert (logits.argmax(-1).numpy() == tok).all()
    big = _copy_cache(cache, impl.init_cache(cfg, 1, 9, device="cpu"))
    logits, _ = impl.decode_step(t_params, big, {"tokens": torch.from_numpy(np.array(tok))},
                                 cfg)
    R.close(logits, want_dec, cfg, "decode logits")
