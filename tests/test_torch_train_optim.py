"""The port's optimizers and schedules (``repro_torch.training``) against the
JAX package's (``repro.training``) on the same numpy parameters and
gradients, over three updates; f32 tolerance rtol 2e-4 / atol 2e-5 x
max(1, |ref|max).

The parameter tree carries the leaf names the weight-decay mask reads
(``wq``, ``ln1_scale``, ``b_up``, ``bias``), a 1-d leaf, a (6, 32, 16)
stack (Adafactor clips it per layer slice) and a (3, 32, 16) one (clipped
over the whole leaf); each step's gradients are scaled per layer slice so
that the RMS clip acts on some slices and not on others.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.training import optimizers as JO  # noqa: E402
from repro.training import schedules as JS  # noqa: E402
from repro_torch.configs.base import get_reduced_config  # noqa: E402
from repro_torch.models.model_api import abstract_params, flatten, param_pspecs  # noqa: E402
from repro_torch.training import optimizers as TO  # noqa: E402
from repro_torch.training import schedules as TS  # noqa: E402

F32_TOL = (2e-4, 2e-5)
SHAPES = {"wq": (8, 12), "ln1_scale": (12,), "b_up": (12,), "bias": (5,), "emb": (40, 1),
          "stack6": (6, 32, 16), "stack3": (3, 32, 16)}
SLICE_SCALE = (1.0, 10.0, 0.1, 3.0, 0.3, 30.0)  # per layer slice, rolled each step


def _close(got, want, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    rtol, atol = F32_TOL
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * max(1.0, np.abs(want).max()),
                               err_msg=what)


def _tree(rng, scale=1.0, step=0):
    out = {}
    for name, shape in SHAPES.items():
        z = rng.standard_normal(shape).astype(np.float32) * scale
        if name.startswith("stack"):
            z *= np.roll(SLICE_SCALE, step)[: shape[0], None, None].astype(np.float32)
        out[name] = z
    return {"layers": {k: v for k, v in out.items() if k != "emb"}, "emb": out["emb"]}


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.tensor(v) for k, v in tree.items()}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _assert_trees(got, want, what):
    got, want = flatten(got), flatten(jax.tree.map(np.asarray, want))
    assert sorted(got) == sorted(want), what
    for k in want:
        _close(got[k], want[k], f"{what} {k}")


OPTIMIZERS = [
    ("adamw", {}),
    ("adamw", {"weight_decay": 0.0, "clip_norm": 1e9, "b2": 0.99}),
    ("adafactor", {}),
    ("adafactor", {"weight_decay": 0.1, "clip_norm": 1.0}),
    ("sgdm", {}),
    ("sgdm", {"weight_decay": 0.05, "momentum": 0.8}),
]


@pytest.mark.parametrize("name,kw", OPTIMIZERS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(OPTIMIZERS)])
def test_optimizer_matches_jax_over_three_updates(rng, name, kw):
    """Parameters, optimizer state and metrics after each of three updates
    under a warmup-cosine rate; the state trees have the reference's paths."""
    p0 = _tree(rng)
    j_opt = JO.make_optimizer(name, JS.warmup_cosine(0.05, 2, 10), **kw)
    t_opt = TO.make_optimizer(name, TS.warmup_cosine(0.05, 2, 10), **kw)
    jp, tp = _jax(p0), _torch(p0)
    js, ts = j_opt.init(jp), t_opt.init(tp)
    _assert_trees(ts, js, "init")
    j_update = jax.jit(j_opt.update)
    for step in range(3):
        g = _tree(rng, scale=0.5, step=step)
        jp, js, jm = j_update(_jax(g), js, jp, jnp.int32(step))
        tp, ts, tm = t_opt.update(_torch(g), ts, tp, step)
        _assert_trees(tp, jp, f"params after step {step}")
        _assert_trees(ts, js, f"state after step {step}")
        _close(tm["grad_norm"], jm["grad_norm"], "grad_norm")
        _close(tm["lr"], jm["lr"], "lr")
        assert tm["lr"].dtype == torch.float32


def _adafactor_two_steps(p):
    opt = TO.adafactor(0.1)
    tp = _torch(p)
    state = opt.init(tp)
    for step in range(2):
        g = {k: v * np.roll(SLICE_SCALE, step)[: v.shape[0], None, None].astype(np.float32)
             for k, v in p.items()}
        tp, state, _ = opt.update(_torch(g), state, tp, step)
    return tp, state


def test_adafactor_clips_a_stack_of_more_than_four_layers_per_slice(rng):
    """The (6, 32, 16) leaf is clipped per layer slice and the (3, 32, 16)
    leaf over the whole, as the reference does; clipping the (6, 32, 16)
    leaf over the whole instead changes its numbers beyond the tolerance."""
    p = {"stack6": rng.standard_normal((6, 32, 16)).astype(np.float32),
         "stack3": rng.standard_normal((3, 32, 16)).astype(np.float32)}
    jopt = JO.adafactor(0.1)
    jp = _jax(p)
    jstate = jopt.init(jp)
    for step in range(2):
        g = {k: v * np.roll(SLICE_SCALE, step)[: v.shape[0], None, None].astype(np.float32)
             for k, v in p.items()}
        jp, jstate, _ = jopt.update(_jax(g), jstate, jp, jnp.int32(step))
    tp, state = _adafactor_two_steps(p)
    assert tuple(state["stack6"]["r"].shape) == (6, 32)
    assert tuple(state["stack6"]["c"].shape) == (6, 16)
    _assert_trees(tp, jp, "per-slice clip")
    with mock.patch.object(TO, "_per_slice", lambda p: False):
        whole, _ = _adafactor_two_steps(p)
    want = np.asarray(jp["stack6"])
    assert np.abs(whole["stack6"].numpy() - want).max() > 1e-2
    np.testing.assert_array_equal(whole["stack3"].numpy(), tp["stack3"].numpy())


def test_adafactor_without_global_clip_reports_grad_norm_zero(rng):
    p = _torch(_tree(rng))
    opt = TO.adafactor(0.01)  # clip_norm=0, the default
    _, _, metrics = opt.update(_torch(_tree(rng)), opt.init(p), p, 0)
    assert float(metrics["grad_norm"]) == 0.0


@pytest.mark.parametrize("path,decays", [
    ("layers.wq", True), ("embed", True), ("layers.ln1_scale", False),
    ("final_norm_scale", False), ("layers.b_up", False), ("layers.tm_gn_bias", False),
    ("layers.mamba_dt_bias", False), ("layers.attn_ln_scale", False),
    ("layers.mamba_conv_b", True), ("layers.ln", False),
])
def test_decay_mask_matches_jax(path, decays):
    assert TO._decay_mask(path) is decays
    keys = tuple(jax.tree_util.DictKey(k) for k in path.split("."))
    assert JO._decay_mask(keys) is decays


def test_global_norm_and_clip_match_jax(rng):
    t = _tree(rng, scale=3.0)
    _close(TO.global_norm(_torch(t)), JO.global_norm(_jax(t)), "global_norm")
    for max_norm in (1.0, 1e9):
        got, gn = TO.clip_by_global_norm(_torch(t), max_norm)
        want, jn = JO.clip_by_global_norm(_jax(t), max_norm)
        _close(gn, jn, "norm")
        _assert_trees(got, want, f"clipped to {max_norm}")
    bf = {"w": torch.tensor(t["layers"]["wq"]).to(torch.bfloat16)}
    clipped, _ = TO.clip_by_global_norm(bf, 1.0)
    assert clipped["w"].dtype == torch.bfloat16  # scaled in its own dtype


def test_warmup_cosine_matches_jax_over_steps_0_to_120():
    t_s, j_s = TS.warmup_cosine(3e-4, 11, 100), JS.warmup_cosine(3e-4, 11, 100)
    got = torch.stack([t_s(s) for s in range(121)])
    want = np.asarray(jax.vmap(j_s)(jnp.arange(121, dtype=jnp.int32)))
    assert got.dtype == torch.float32
    _close(got, want, "warmup_cosine")
    _close(t_s(torch.tensor(57)), want[57], "tensor step")
    assert float(TS.constant(0.5)(7)) == float(JS.constant(0.5)(jnp.int32(7))) == 0.5


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgdm"])
def test_state_specs_match_jax(name):
    """Logical-axis specs of the optimizer state, element for element the
    reference's PartitionSpecs (qwen2-1.5b's reduced parameter tree)."""
    from repro.configs.base import get_reduced_config as j_reduced
    from repro.models.model_api import abstract_params as j_abstract
    from repro.models.model_api import param_pspecs as j_pspecs

    cfg = get_reduced_config("qwen2-1.5b")
    got = TO.make_optimizer(name, 0.1).state_specs(param_pspecs(cfg), abstract_params(cfg))
    jcfg = j_reduced("qwen2-1.5b")
    want = JO.make_optimizer(name, 0.1).state_specs(j_pspecs(jcfg), j_abstract(jcfg))
    want = jax.tree.map(tuple, want, is_leaf=JO._is_pspec)
    assert flatten(got) == {k: tuple(v) for k, v in flatten(want).items()}
