"""Shared parts of the LM parity tests (``tests/test_torch_lm_*.py``): the
port's LM serving path held against the JAX package at the reduced size of
each architecture (f32, B = 2, T = 16, the reference's smoke size).

Inputs are made with numpy from a seed and feed both packages: parameters
follow the JAX package's own ``param_defs`` (every path and shape), drawn
uniform with standard deviation 0.02 (norm scales 1 + 0.1 x unit variance),
so the bias and scale paths carry live values (``init_params`` would zero
the biases); the JAX tree crosses to the port through
``convert.lm_params_from_reference``.  One JAX program per architecture
computes the reference: ``loss_fn``, ``prefill`` (logits and cache), and
four greedy ``decode_step``s from the prefill cache re-homed into a longer
one, exactly as ``greedy_generate`` does.  The port runs the same on CPU
tensors, its decode steps fed the reference's tokens.

Tolerances: f32 logits and caches rtol 2e-4 / atol 2e-5 x max(1, |ref|max)
(the port's kernel tolerance: the packages sum in other orders), for every
family; greedy tokens identical.  For the MoE and hybrid families each MoE
call of the port is also matched with the reference's call on the same
layer input, and both must route every token to the same experts.  Only a
decode against a longer prefill with experts keeps the reference's 5e-2
(tests/test_models_smoke.py): the prefill's capacity drops assignments that
a one-token decode keeps, in both packages.

The callers import torch with ``pytest.importorskip`` before this module.
"""

import contextlib
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import get_reduced_config as j_get_reduced
from repro.models import layers as JL
from repro.models.model_api import get_model as j_get_model, unflatten as j_unflatten
from repro.serving.serve_step import _copy_cache as j_copy_cache
from repro_torch.configs.base import get_reduced_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import layers as TL
from repro_torch.models.model_api import get_model
from repro_torch.serving.serve_step import _copy_cache, greedy_generate

B, T, STEPS = 2, 16, 4
F32_TOL = (2e-4, 2e-5)
DROPS_TOL = 5e-2  # decode vs a longer prefill with experts: the reference's
# the reference runs with LLVM's cheaper passes: the same programs, less
# compile time (the JAX side of this file is mostly compilation)
_FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _f32_tol(want) -> dict:
    rtol, atol = F32_TOL
    return dict(rtol=rtol, atol=atol * max(1.0, float(np.abs(want).max(initial=0.0))))


def close(got, want, cfg, what=""):
    got = got.detach().float().cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, err_msg=what,
                               **_f32_tol(want))


def np_params(cfg, seed: int = 0) -> dict:
    """A numpy tree over the JAX package's param_defs for ``cfg``: uniform
    draws (cheaper than normal ones at full width) of standard deviation
    0.02, norm scales 1 + 0.1 x a unit-variance draw."""
    rng = np.random.default_rng(seed)
    flat = {}
    for path, (shape, _) in sorted(j_get_model(cfg).param_defs(cfg).items()):
        z = rng.random(shape, dtype=np.float32)
        z -= 0.5
        z *= 2.0 * 3.0**0.5  # unit variance
        flat[path] = 1.0 + 0.1 * z if path.endswith("scale") else z.__imul__(0.02)
    return j_unflatten(flat)


def np_batch(cfg, b: int = B, t: int = T, seed: int = 0) -> dict:
    """Tokens (prefix-shortened for a VLM), labels (-1 over a VLM prefix),
    prefix embeddings or audio frames, from numpy."""
    rng = np.random.default_rng(seed)
    pfx = cfg.num_prefix_tokens
    toks = rng.integers(0, cfg.vocab_size, (b, t - pfx + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1],
             "labels": np.concatenate([-np.ones((b, pfx), np.int32), toks[:, 1:]], axis=1)}
    if pfx:
        batch["prefix_embeds"] = 0.02 * rng.standard_normal((b, pfx, cfg.d_model),
                                                            dtype=np.float32)
    if cfg.family == "encdec":
        batch["frames"] = 0.1 * rng.standard_normal((b, t, cfg.d_model), dtype=np.float32)
    return batch


def _t(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _no_labels(batch: dict) -> dict:
    return {k: v for k, v in batch.items() if k != "labels"}


def _j_reference(params, batch, cfg, total: int):
    """The JAX package's loss, prefill and a greedy chain of STEPS decodes
    from the prefill cache re-homed into ``total`` positions."""
    impl = j_get_model(cfg)
    loss = impl.loss_fn(params, batch, cfg)[0]
    logits, cache = impl.prefill(params, _no_labels(batch), cfg)
    big = j_copy_cache(cache, impl.init_cache(cfg, batch["tokens"].shape[0], total))

    def step(carry, _):
        tok, c = carry
        out, c = impl.decode_step(params, c, {"tokens": tok}, cfg)
        return (jnp.argmax(out[:, -1], axis=-1)[:, None].astype(jnp.int32), c), (tok, out)

    tok0 = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    (_, final), (toks, dec_logits) = jax.lax.scan(step, (tok0, big), None, length=STEPS)
    return {"loss": loss, "logits": logits, "cache": cache, "tokens": toks,
            "dec_logits": dec_logits, "final_cache": final}


def _prefill_len(cfg) -> int:
    return T  # a VLM's prefix counts inside T (np_batch shortens its tokens)


def _j_recording_moe(sink: list):
    """The reference's ``moe_ffn``, recording each call's input and router
    (numpy) into ``sink`` as it runs."""
    moe_ffn = JL.moe_ffn

    def recording(cfg, x, p, prefix="moe_"):
        jax.debug.callback(lambda xv, rv: sink.append((np.asarray(xv), np.asarray(rv))),
                           x, p[f"{prefix}router"])
        return moe_ffn(cfg, x, p, prefix)

    return recording


@functools.lru_cache(maxsize=None)
def reference(arch: str) -> dict:
    """numpy params and batch for ``arch`` and the JAX outputs over them;
    with experts, also every MoE call's (input, router) (``moe_inputs``)."""
    cfg = j_get_reduced(arch)
    params, batch = np_params(cfg), np_batch(cfg)
    fn = jax.jit(functools.partial(_j_reference, cfg=cfg, total=_prefill_len(cfg) + STEPS))
    sink = []
    with (mock.patch.object(JL, "moe_ffn", _j_recording_moe(sink)) if cfg.num_experts
          else contextlib.nullcontext()):
        compiled = fn.lower(params, batch).compile(_FAST_COMPILE)
    out = compiled(params, batch)
    jax.effects_barrier()
    return {"params": params, "batch": batch, "moe_inputs": sink, **_np(out)}


def port_inputs(arch: str):
    cfg = get_reduced_config(arch)
    ref = reference(arch)
    return cfg, lm_params_from_reference(ref["params"], cfg, device="cpu"), _t(ref["batch"])




def fast_jit(fn, *args):
    """``fn`` (a function of arrays) compiled with the fast options, run on ``args``."""
    return _np(jax.jit(fn).lower(*args).compile(_FAST_COMPILE)(*args))


# ---------------------------------------------------------------------------
# the checks each architecture runs (the test files parametrize them)
# ---------------------------------------------------------------------------


def check_loss(arch):
    cfg, params, batch = port_inputs(arch)
    loss, metrics = get_model(cfg).loss_fn(params, batch, cfg)
    assert float(metrics["loss"]) == float(loss)
    close(loss, reference(arch)["loss"], cfg, "loss")


def check_prefill(arch):
    cfg, params, batch = port_inputs(arch)
    ref = reference(arch)
    logits, cache = get_model(cfg).prefill(params, _no_labels(batch), cfg)
    assert logits.shape == ref["logits"].shape == (B, 1, cfg.padded_vocab())
    close(logits, ref["logits"], cfg, "prefill logits")
    assert sorted(cache) == sorted(ref["cache"])  # jax returns dicts key-sorted
    for k, want in ref["cache"].items():
        assert tuple(cache[k].shape) == want.shape, k
        close(cache[k], want, cfg, f"cache[{k!r}]")
    if cfg.family == "hybrid":  # the reference's prefill zeroes the Mamba states
        assert not cache["mamba_h"].any() and not cache["mamba_buf"].any()


def check_decode_steps(arch):
    """Four decode steps chained from the re-homed prefill cache, each fed
    the reference's token; logits every step, every cache entry after."""
    cfg, params, batch = port_inputs(arch)
    ref = reference(arch)
    impl = get_model(cfg)
    _, cache = impl.prefill(params, _no_labels(batch), cfg)
    big = _copy_cache(cache, impl.init_cache(cfg, B, _prefill_len(cfg) + STEPS, device="cpu"))
    for i in range(STEPS):
        tok = torch.from_numpy(np.array(ref["tokens"][i]))
        logits, big = impl.decode_step(params, big, {"tokens": tok}, cfg)
        close(logits, ref["dec_logits"][i], cfg, f"decode step {i}")
    assert sorted(big) == sorted(ref["final_cache"])
    for k, want in ref["final_cache"].items():
        close(big[k], want, cfg, f"cache[{k!r}] after {STEPS} steps")


def check_greedy(arch):
    cfg, params, batch = port_inputs(arch)
    want = reference(arch)["tokens"][:, :, 0].T  # (B, STEPS)
    got = greedy_generate(cfg, params, _no_labels(batch), STEPS)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, STEPS)
    np.testing.assert_array_equal(got.numpy(), want)


def check_port_decode_matches_prefill(arch):
    """Decode logits equal a longer prefill's last-position logits (the
    reference's own check and tolerance: 2e-3, 5e-2 with experts)."""
    cfg, params, batch = port_inputs(arch)
    impl = get_model(cfg)
    batch = _no_labels(batch)
    logits_p, cache = impl.prefill(params, batch, cfg)
    big = _copy_cache(cache, impl.init_cache(cfg, B, _prefill_len(cfg) + 4, device="cpu"))
    nt = torch.argmax(logits_p[:, -1], dim=-1)[:, None].to(torch.int32)
    logits_d, _ = impl.decode_step(params, big, {"tokens": nt}, cfg)
    longer = {**batch, "tokens": torch.cat([batch["tokens"], nt], dim=1)}
    logits_chk, _ = impl.prefill(params, longer, cfg)
    tol = DROPS_TOL if cfg.num_experts else 2e-3
    np.testing.assert_allclose(logits_d[:, 0].numpy(), logits_chk[:, -1].numpy(),
                               rtol=tol, atol=tol)


@functools.partial(jax.jit, static_argnums=2)
def _j_route(x, router, k):
    """The reference's routing (``repro.models.layers.moe_ffn``'s first
    lines): top-k of softmax(x @ router) in f32, the gates renormalised."""
    logits = jnp.einsum("nd,de->ne", x.astype(jnp.float32), router.astype(jnp.float32))
    gates, experts = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    return gates / jnp.maximum(jnp.sum(gates, axis=-1, keepdims=True), 1e-9), experts


def check_routing(arch):
    """Every routing round of the port's prefill and of its four decode
    steps has a call of the reference with the same router on the same input
    (f32 tolerance), and both route every token to the same experts with the
    same gates."""
    cfg, params, batch = port_inputs(arch)
    ref = reference(arch)
    impl = get_model(cfg)
    seen = []
    route = TL.moe_route

    def recording(xc, router, k):
        gates, experts = route(xc, router, k)
        seen.append((xc.numpy().copy(), router.numpy(), gates, experts))
        return gates, experts

    with mock.patch.object(TL, "moe_route", recording):
        _, cache = impl.prefill(params, _no_labels(batch), cfg)
        big = _copy_cache(cache, impl.init_cache(cfg, B, _prefill_len(cfg) + STEPS,
                                                 device="cpu"))
        for i in range(STEPS):
            tok = torch.from_numpy(np.array(ref["tokens"][i]))
            _, big = impl.decode_step(params, big, {"tokens": tok}, cfg)
    assert len(seen) == cfg.num_layers // cfg.moe_every * (1 + STEPS)
    j_inputs = [(x.reshape(-1, x.shape[-1]), r) for x, r in ref["moe_inputs"]]
    for n, (xc, router, gates, experts) in enumerate(seen):
        match = [x for x, r in j_inputs if x.shape == xc.shape and np.array_equal(r, router)
                 and np.allclose(xc, x, **_f32_tol(x))]
        assert match, f"routing round {n}: no reference call on this input"
        j_gates, j_experts = _np(_j_route(match[0], router, cfg.top_k))
        np.testing.assert_array_equal(experts.numpy(), j_experts, err_msg=f"round {n}")
        np.testing.assert_allclose(gates.numpy(), j_gates, err_msg=f"round {n}",
                                   **_f32_tol(j_gates))
