"""The port's decoder-only transformer families (dense, moe, vlm: seven of
the ten architectures) held against the JAX package at reduced size, plus
the parity traps of the family: the clamped cache write of a decode at the
cache's length and the live padded vocabulary.  Inputs, the reference
program and the tolerances are those of ``tests/torch_lm_reference.py``.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_lm_reference as R  # noqa: E402

from repro.configs.base import ARCH_IDS, get_reduced_config as j_get_reduced  # noqa: E402
from repro.models.model_api import get_model as j_get_model  # noqa: E402
from repro_torch.configs.base import get_reduced_config  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.models.model_api import get_model  # noqa: E402

ARCHS = [a for a in ARCH_IDS if j_get_reduced(a).family in ("dense", "moe", "vlm")]


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


@pytest.mark.parametrize("arch", ARCHS)
def test_port_decode_matches_prefill(arch):
    R.check_port_decode_matches_prefill(arch)


def test_decode_at_cache_length_clamps_like_reference():
    """A decode at pos == cache length: ``lax.dynamic_update_slice`` clamps
    the write to the last slot, and so does the port."""
    arch, s, b = "qwen2-1.5b", 6, R.B
    cfg, params, _ = R.port_inputs(arch)
    j_cfg, ref = j_get_reduced(arch), R.reference(arch)
    rng = np.random.default_rng(3)
    shape = (cfg.num_layers, b, s, cfg.kv_heads, cfg.hd)
    cache = {"k": rng.standard_normal(shape, dtype=np.float32),
             "v": rng.standard_normal(shape, dtype=np.float32),
             "pos": np.array(s, np.int32)}
    tok = np.array([[5], [7]], np.int32)
    decode = functools.partial(j_get_model(j_cfg).decode_step, cfg=j_cfg)
    want_logits, want_cache = R.fast_jit(decode, ref["params"], cache, {"tokens": tok})
    logits, got = get_model(cfg).decode_step(params, R._t(cache),
                                             {"tokens": torch.from_numpy(tok)}, cfg)
    R.close(logits, want_logits, cfg, "logits")
    for k in ("k", "v"):
        R.close(got[k], want_cache[k], cfg, k)
        # only the last slot changed
        np.testing.assert_array_equal(got[k][:, :, :-1].numpy(), cache[k][:, :, :-1])
    assert int(got["pos"]) == int(want_cache["pos"]) == s + 1


def test_padded_vocab_rows_are_live_in_both_packages():
    """The logits cover padded_vocab(); the padded embedding rows are live
    weights, so argmax can pick a padded id, in both packages."""
    j_cfg = dataclasses.replace(j_get_reduced("qwen2-1.5b"), vocab_size=200)
    cfg = dataclasses.replace(get_reduced_config("qwen2-1.5b"), vocab_size=200)
    assert cfg.padded_vocab() == j_cfg.padded_vocab() == 256
    params = R.np_params(j_cfg, seed=5)
    batch = R._no_labels(R.np_batch(j_cfg, seed=5))
    params["embed"][200:] *= 50.0  # large padded rows win the argmax
    want = R.fast_jit(functools.partial(j_get_model(j_cfg).prefill, cfg=j_cfg),
                      params, batch)[0]
    got, _ = get_model(cfg).prefill(lm_params_from_reference(params, cfg, device="cpu"),
                                    R._t(batch), cfg)
    assert tuple(got.shape) == want.shape == (R.B, 1, 256)
    R.close(got, want, cfg, "logits")
    assert (got.argmax(-1).numpy() == want.argmax(-1)).all()
    assert (want.argmax(-1) >= 200).all()
