"""The port's train step (``repro_torch.training.train_step``) and the remat
of its model families, held against the JAX package at each reduced
architecture (f32, B = 2, T = 16; inputs from ``tests/torch_lm_reference``:
numpy parameters over the reference's ``param_defs``, a numpy batch).

One JAX program per architecture runs the reference's ``make_train_step``
with one microbatch (``jax.value_and_grad`` of its ``loss_fn``, then AdamW),
its AdamW wrapped to hand back the gradients it was given; the port's
``value_and_grad`` and ``make_train_step`` run the same on CPU tensors.
Tolerance: f32 rtol 2e-4 / atol 2e-5 x max(1, |ref|max) on the loss, every
gradient leaf and every parameter after the step.  The step's AdamW runs
with eps 1e-3: at the default 1e-8 a first AdamW step moves each weight by
lr x g / (|g| + 1e-8), about lr x sign(g), so a gradient of 1e-7 whose last
digits differ between the packages (well inside the gradient tolerance)
moves its weight by a different amount.

Remat: the port's gradients under ``remat`` "none", "full" and "dots" are
bitwise the same (CPU), chunked attention and the chunked rwkv6 / Mamba
scans agree with the reference's checkpointed ones, and ``prefill`` /
``decode_step`` are bitwise what they were before remat and ``unbind``.
"""

import contextlib
import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_lm_reference as R  # noqa: E402
from repro.configs.base import get_reduced_config as j_reduced  # noqa: E402
from repro.models import mamba as j_mamba  # noqa: E402
from repro.models import rwkv6 as j_rwkv6  # noqa: E402
from repro.training.optimizers import Optimizer as JOptimizer  # noqa: E402
from repro.training.optimizers import adamw as j_adamw  # noqa: E402
from repro.training.train_step import make_train_step as j_make_train_step  # noqa: E402
from repro_torch.configs.base import ARCH_IDS, get_reduced_config  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.models import encdec, hybrid, layers, mamba, rwkv6, transformer  # noqa: E402
from repro_torch.models.model_api import flatten, get_model  # noqa: E402
from repro_torch.serving.serve_step import _copy_cache  # noqa: E402
from repro_torch.training.optimizers import adamw  # noqa: E402
from repro_torch.training.train_step import make_train_step, value_and_grad  # noqa: E402

LR, EPS = 1e-2, 1e-3
FAMILIES = ("qwen2-1.5b", "deepseek-moe-16b", "rwkv6-1.6b", "jamba-1.5-large-398b",
            "whisper-base")


def _recording(opt: JOptimizer) -> JOptimizer:
    """``opt`` whose update also returns the gradients it was given."""

    def update(grads, state, params, step, specs=None):
        p, s, m = opt.update(grads, state, params, step, specs=specs)
        return p, s, {**m, "grads": grads}

    return opt._replace(update=update)


def _j_steps(cfgs, params, batch, compressions):
    """The reference's train step for each (cfg, grad_compression) pair,
    from the same parameters and a fresh AdamW state, in one program."""
    opt = _recording(j_adamw(LR, eps=EPS))
    out = []
    for cfg, comp in zip(cfgs, compressions):
        step = j_make_train_step(cfg, opt, grad_compression=comp)
        new, _, metrics = step(params, opt.init(params), batch, jnp.int32(0))
        out.append((new, metrics))
    return out


def _j_run(cfgs, params, batch, compressions=("none",)):
    fn = functools.partial(_j_steps, cfgs, compressions=compressions)
    return R.fast_jit(fn, params, batch)


@functools.lru_cache(maxsize=None)
def _inputs(arch):
    """numpy parameters and batch of ``arch`` (as the LM parity tests draw them)."""
    cfg = j_reduced(arch)
    return {"params": R.np_params(cfg), "batch": R.np_batch(cfg)}


def _port(arch, **cut):
    cfg = dataclasses.replace(get_reduced_config(arch), **cut)
    ref = _inputs(arch)
    params = lm_params_from_reference(ref["params"], cfg, device="cpu")
    return cfg, params, R._t(ref["batch"])


def _close_tree(got, want, cfg, what, tol=None):
    got, want = flatten(got), flatten(want)
    assert sorted(got) == sorted(want), what
    for k in want:
        if tol is None:
            R.close(got[k], want[k], cfg, f"{what} {k}")
        else:
            np.testing.assert_allclose(got[k].float().numpy(), np.asarray(want[k], np.float32),
                                       err_msg=f"{what} {k}", **tol)


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_matches_jax(arch):
    """Loss and every gradient leaf against the reference's value_and_grad,
    and every parameter after one AdamW step against its train step."""
    cfg, params, batch = _port(arch, microbatches_train=1)
    ref = _inputs(arch)
    jcfg = dataclasses.replace(j_reduced(arch), microbatches_train=1)
    ((j_new, j_metrics),) = _j_run((jcfg,), ref["params"], ref["batch"])
    loss, metrics, grads = value_and_grad(get_model(cfg).loss_fn, params, batch, cfg)
    assert float(metrics["loss"].detach()) == float(loss)
    R.close(loss, j_metrics["loss"], cfg, "loss")
    _close_tree(grads, j_metrics["grads"], cfg, "grad")
    opt = adamw(LR, eps=EPS)
    new, state, t_metrics = make_train_step(cfg, opt)(params, opt.init(params), batch, 0)
    assert float(t_metrics["loss"]) == float(loss)
    R.close(t_metrics["grad_norm"], j_metrics["grad_norm"], cfg, "grad_norm")
    _close_tree(new, j_new, cfg, "params after the step")


def test_microbatches_and_bf16_compression_match_jax():
    """qwen2-1.5b with two microbatches, and with two microbatches and
    bf16-compressed gradients, against the reference's: loss (microbatch
    mean), accumulated gradients, parameters after the step.  The
    compressed gradients may round to a neighbouring bf16 value where the
    f32 sums differ in their last digits: one bf16 ulp (at most 2^-7
    relative)."""
    cfg, params, batch = _port("qwen2-1.5b", microbatches_train=2)
    ref = _inputs("qwen2-1.5b")
    jcfg = dataclasses.replace(j_reduced("qwen2-1.5b"), microbatches_train=2)
    runs = _j_run((jcfg, jcfg), ref["params"], ref["batch"], compressions=("none", "bf16"))
    for (j_new, j_metrics), comp in zip(runs, ("none", "bf16")):
        opt = _recording_port(adamw(LR, eps=EPS))
        p = _clone(params)
        new, _, metrics = make_train_step(cfg, opt, grad_compression=comp)(
            p, opt.init(p), batch, 0)
        R.close(metrics["loss"], j_metrics["loss"], cfg, f"{comp} loss")
        if comp == "bf16":
            assert all(g.dtype == torch.bfloat16 for g in flatten(metrics["grads"]).values())
            _close_tree(metrics["grads"], j_metrics["grads"], cfg, "bf16 grads",
                        tol=dict(rtol=2.0**-7, atol=1e-7))
        else:
            _close_tree(metrics["grads"], j_metrics["grads"], cfg, "grads")
        _close_tree(new, j_new, cfg, f"{comp} params after the step")


def _recording_port(opt):
    def update(grads, state, params, step, specs=None):
        p, s, m = opt.update(grads, state, params, step)
        return p, s, {**m, "grads": grads}

    return opt._replace(update=update)


def test_microbatch_count_clamps_to_a_divisor_of_the_batch():
    """rwkv6-1.6b's own four microbatches on a batch of 2 run as 2; qwen2's
    four on a batch of 6 as 3 (bitwise, the port against itself); the loss
    is the microbatch mean."""
    cases = [("rwkv6-1.6b", 2, 4, 2), ("qwen2-1.5b", 6, 4, 3)]
    for arch, b, m, m_eff in cases:
        cfg, params, _ = _port(arch, microbatches_train=m)
        batch = R._t(R.np_batch(j_reduced(arch), b=b))
        runs = []
        for mm in (m, m_eff):
            opt = _recording_port(adamw(LR, eps=EPS))
            p = _clone(params)
            c = dataclasses.replace(cfg, microbatches_train=mm)
            runs.append(make_train_step(c, opt)(p, opt.init(p), batch, 0))
        (p1, _, m1), (p2, _, m2) = runs
        assert torch.equal(m1["loss"], m2["loss"])
        for k, v in flatten(m1["grads"]).items():
            assert torch.equal(v, flatten(m2["grads"])[k]), (arch, k)
        impl = get_model(cfg)
        losses = [impl.loss_fn(params, {k: v.chunk(m_eff)[i] for k, v in batch.items()},
                               cfg)[0] for i in range(m_eff)]
        torch.testing.assert_close(m1["loss"], sum(losses) / m_eff, rtol=0, atol=0)


def test_bf16_accumulation_hands_bf16_gradients_to_the_update():
    cfg, params, batch = _port("qwen2-1.5b", microbatches_train=2, grad_accum_dtype="bfloat16")
    opt = _recording_port(adamw(LR))
    _, _, metrics = make_train_step(cfg, opt)(params, opt.init(params), batch, 0)
    assert all(g.dtype == torch.bfloat16 for g in flatten(metrics["grads"]).values())


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_policies_give_the_same_gradients(arch):
    """Loss and gradients under remat "none", "full" and "dots", with
    attention in one chunk and in query chunks of 8 (nested remat), with
    MoE routing in one round and in rounds of 16 tokens: bitwise the same
    within each chunking (CPU)."""
    for chunks in ({}, {"attn_q_chunk": 8, "moe_dispatch_tokens": 16}):
        runs = {}
        for remat in ("none", "full", "dots"):
            cfg, params, batch = _port(arch, remat=remat, **chunks)
            loss, _, grads = value_and_grad(get_model(cfg).loss_fn, params, batch, cfg)
            runs[remat] = (loss, flatten(grads))
        loss0, g0 = runs["none"]
        for remat, (loss, g) in runs.items():
            assert torch.equal(loss, loss0), (remat, chunks)
            for k in g0:
                assert torch.equal(g[k], g0[k]), (remat, chunks, k)


def test_dots_policy_saves_the_batch_free_products():
    """Counting ``aten.mm`` launched during the backward (qwen2-1.5b):
    "full" recomputes a block's products, "dots" none of them (they are
    saved), "none" saves everything."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
            return func(*args, **(kwargs or {}))

    counts = {}
    for remat in ("none", "full", "dots"):
        cfg, params, batch = _port("qwen2-1.5b", remat=remat)
        leaves = [v.requires_grad_(True) for v in flatten(params).values()]
        loss, _ = get_model(cfg).loss_fn(params, batch, cfg)
        with Count() as c:
            torch.autograd.grad(loss, leaves)
        counts[remat] = c.n
    # a block's forward runs 7 products; "full" recomputes 6 of them (q, k,
    # v, o, gate, up): no backward reads the down projection's output, and
    # the recompute stops once every saved tensor it needs is rebuilt
    assert counts["dots"] == counts["none"]
    assert counts["full"] == counts["none"] + 6 * cfg.num_layers


def test_chunked_attention_gradients_match_jax():
    """qwen2-1.5b with query chunks of 8 at T = 16: the reference maps
    checkpointed chunks, the port checkpoints each chunk."""
    cfg, params, batch = _port("qwen2-1.5b", attn_q_chunk=8, microbatches_train=1)
    ref = _inputs("qwen2-1.5b")
    jcfg = dataclasses.replace(j_reduced("qwen2-1.5b"), attn_q_chunk=8)
    ((_, j_metrics),) = _j_run((jcfg,), ref["params"], ref["batch"])
    loss, _, grads = value_and_grad(get_model(cfg).loss_fn, params, batch, cfg)
    R.close(loss, j_metrics["loss"], cfg, "loss")
    _close_tree(grads, j_metrics["grads"], cfg, "grad")


def _scan_inputs(rng, shapes):
    return [0.5 * rng.standard_normal(s).astype(np.float32) for s in shapes]


def _scan_grads_match(j_fn, t_fn, arrays):
    """Gradients of sum(y * wy) + sum(state * ws) with respect to every
    input, reference against port, T = 128 (two remat chunks of 64)."""
    rng = np.random.default_rng(3)
    y0, s0 = jax.jit(j_fn)(*arrays)
    wy = rng.standard_normal(y0.shape).astype(np.float32)
    ws = rng.standard_normal(s0.shape).astype(np.float32)

    def j_obj(*xs):
        y, s = j_fn(*xs)
        return jnp.sum(y * wy) + jnp.sum(s * ws)

    j_val, j_grads = R.fast_jit(jax.value_and_grad(j_obj, argnums=tuple(range(len(arrays)))),
                                *arrays)
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    with mock.patch.object(layers, "checkpoint", side_effect=layers.checkpoint) as ck:
        y, s = t_fn(*ts)
    assert ck.call_count == 2  # the port's chunked path ran
    obj = (y * torch.tensor(wy)).sum() + (s * torch.tensor(ws)).sum()
    grads = torch.autograd.grad(obj, ts)
    np.testing.assert_allclose(obj.item(), float(j_val), rtol=2e-4)
    for i, (g, w) in enumerate(zip(grads, j_grads)):
        R.close(g, w, None, f"input {i}")


def test_chunked_rwkv6_scan_gradients_match_jax(rng):
    b, t, h, e = 2, 128, 2, 8
    arrays = _scan_inputs(rng, [(b, t, h, e)] * 3 + [(b, t, h, e), (h, e), (b, h, e, e)])
    arrays[3] = 1.0 / (1.0 + np.exp(-arrays[3] - 2.0))  # decays in (0, 1)
    _scan_grads_match(j_rwkv6._wkv_scan, rwkv6._wkv_scan, arrays)


def test_chunked_mamba_scan_gradients_match_jax(rng):
    b, t, di, ds = 2, 128, 6, 4
    arrays = _scan_inputs(rng, [(b, t, di), (b, t, di), (b, t, ds), (b, t, ds), (di, ds),
                                (b, di, ds)])
    arrays[1] = 0.1 * np.abs(arrays[1])  # dt > 0
    arrays[4] = -np.abs(arrays[4])  # a < 0
    _scan_grads_match(j_mamba._ssm_scan, mamba._ssm_scan, arrays)


def _indexed(tree: dict, n: int) -> list[dict]:
    """The slicing before ``unbind``: ``v[i]``."""
    return [{k: v[i] for k, v in tree.items()} for i in range(n)]


def _serve(cfg, params, batch):
    impl = get_model(cfg)
    prompt = R._no_labels(batch)
    logits, cache = impl.prefill(params, prompt, cfg)
    big = _copy_cache(cache, impl.init_cache(cfg, logits.shape[0], int(cache["pos"]) + 2,
                                             device="cpu"))
    tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    out = [logits] + [v.clone() for v in cache.values()]
    for _ in range(2):
        logits, big = impl.decode_step(params, big, {"tokens": tok}, cfg)
        out += [logits] + [v.clone() for v in big.values()]
        tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serving_is_bitwise_unchanged_by_remat_and_unbind(arch):
    """``prefill`` and two ``decode_step``s (logits and every cache entry)
    under remat "full" equal remat "none", and equal a run whose layers
    are sliced with ``v[i]`` as before ``unbind``."""
    cfg, params, batch = _port(arch)
    want = _serve(cfg, params, batch)
    with contextlib.ExitStack() as stack:
        for family in (transformer, rwkv6, hybrid, encdec):
            stack.enter_context(mock.patch.object(family, "stacked", _indexed))
        old = _serve(cfg, params, batch)
    full = _serve(dataclasses.replace(cfg, remat="full"), params, batch)
    for a, b, c in zip(want, old, full, strict=True):
        assert torch.equal(a, b) and torch.equal(a, c)
