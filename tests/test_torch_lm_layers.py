"""The port's LM building blocks (``repro_torch.models.layers``) held against
``repro.models.layers`` one function at a time, with the parity traps named:
tanh GELU, interleaved and partial RoPE, the bf16 ``rms_norm`` branch, the
MoE dispatch's capacity drops and token chunking, the clamped cache write.
Then the full (published) configs without allocation (param paths, shapes
and specs, counts, input / cache specs, the configs themselves), the serving
launcher's keys, parameters crossing from the JAX package, the rule that
every entry point runs on the card unless asked for the CPU, and the rule
that no port module imports JAX or the JAX package.

Inputs come from numpy with a seed.  Tolerances: f32 rtol 2e-4 / atol 2e-5
x max(1, |ref|max) (the packages sum in other orders); bf16 rtol / atol
2**-7 x max(1, |ref|max), two bf16 ulps (XLA may keep an elementwise chain
in f32 where torch rounds each step to bf16).
"""

import ast
import dataclasses
import functools
import importlib
import json
import os
import pathlib
import pkgutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ARCH_IDS, get_config as j_get_config  # noqa: E402
from repro.configs.base import get_reduced_config as j_get_reduced  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model_api as j_api  # noqa: E402
from repro_torch.configs.base import get_config, get_reduced_config  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model_api  # noqa: E402

F32_TOL = (2e-4, 2e-5)
BF16_TOL = (2**-7, 2**-7)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _close(got, want, tol=F32_TOL):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.detach().float().numpy()
    rtol, atol = tol
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(1.0, float(np.abs(want).max(initial=0.0))))


def _j(fn, *args, **static):
    """The JAX function on ``args`` (``static`` bound), jitted with LLVM's
    cheaper passes: one compile instead of one per eager op."""
    fast = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
    f = jax.jit(functools.partial(fn, **static))
    return f.lower(*args).compile(fast)(*args)


def _pair(rng, shape, scale=1.0):
    a = (scale * rng.standard_normal(shape)).astype(np.float32)
    return torch.from_numpy(a.copy()), jnp.asarray(a)  # no buffer shared


def _params(rng, defs: dict, lead_drop: bool = True):
    """numpy params of one layer for a defs table (the leading L axis
    dropped), as (port dict, JAX dict)."""
    t, j = {}, {}
    for name, (shape, _) in defs.items():
        shape = shape[1:] if lead_drop else shape
        a = (0.1 * rng.standard_normal(shape)).astype(np.float32)
        t[name], j[name] = torch.from_numpy(a), jnp.asarray(a)
    return t, j


# ---------------------------------------------------------------------------
# norms, rope, attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_layer_norm_match_reference(rng, dtype):
    tdt, tol = (torch.float32, F32_TOL) if dtype == "float32" else (torch.bfloat16, BF16_TOL)
    x, jx = _pair(rng, (2, 5, 48), 3.0)
    s, js = _pair(rng, (48,))
    b, jb = _pair(rng, (48,))
    x, jx = x.to(tdt), jx.astype(dtype)
    got = TL.rms_norm(x, s)
    assert got.dtype == tdt
    _close(got, _j(JL.rms_norm, jx, js), tol)
    got = TL.layer_norm(x, s, b)
    assert got.dtype == tdt
    _close(got, _j(JL.layer_norm, jx, js, jb), tol)


def test_rms_norm_bf16_branch_squares_in_bf16(rng):
    """The bf16 branch squares in bf16 before an f32 mean: its variance is
    not the one of an f32 square."""
    x = torch.from_numpy(rng.standard_normal((4, 256)).astype(np.float32)).to(torch.bfloat16)
    ones = torch.ones(256)
    want = x * torch.rsqrt(torch.mean(torch.square(x), -1, keepdim=True,
                                      dtype=torch.float32) + 1e-6).to(torch.bfloat16)
    assert torch.equal(TL.rms_norm(x, ones), want)


@pytest.mark.parametrize("fraction", [1.0, 0.5, 0.0])
def test_apply_rope_matches_reference(rng, fraction):
    x, jx = _pair(rng, (2, 7, 3, 16))
    pos = np.array([[0, 1, 2, 3, 4, 5, 6], [9, 10, 11, 12, 13, 14, 15]], np.int32)
    got = TL.apply_rope(x, torch.from_numpy(pos), fraction=fraction, theta=10000.0)
    _close(got, _j(JL.apply_rope, jx, jnp.asarray(pos), fraction=fraction, theta=10000.0))
    rot = int(16 * fraction) // 2 * 2
    assert torch.equal(got[..., rot:], x[..., rot:])  # only the first rot dims turn
    _close(TL.rope_frequencies(16, fraction, 500.0), JL.rope_frequencies(16, fraction, 500.0))


def test_apply_rope_is_interleaved_not_rotate_half():
    """Pairs (x[2i], x[2i+1]) rotate together (HF's rotate-half would pair
    x[i] with x[i + hd/2])."""
    x = torch.zeros(1, 1, 1, 8)
    x[..., 0] = 1.0
    p = 3
    got = TL.apply_rope(x, torch.tensor([p]), fraction=1.0, theta=10000.0)[0, 0, 0]
    assert torch.allclose(got[:2], torch.tensor([np.cos(p), np.sin(p)], dtype=torch.float32))
    assert not got[2:].any()


@pytest.mark.parametrize("case", ["causal_chunked", "causal_offset", "bidirectional_gqa"])
def test_attention_matches_reference(rng, case):
    b, t, h, kv, hd = 2, 12, 4, 2, 8
    q, jq = _pair(rng, (b, t, h, hd))
    s = 12 if case != "bidirectional_gqa" else 9
    k, jk = _pair(rng, (b, s, kv, hd))
    v, jv = _pair(rng, (b, s, kv, hd))
    kw = {"causal_chunked": dict(causal=True, q_chunk=4),  # three chunks of 4
          "causal_offset": dict(causal=True, q_offset=3, q_chunk=512),
          "bidirectional_gqa": dict(causal=False, q_chunk=6)}[case]
    _close(TL.attention(q, k, v, **kw), _j(JL.attention, jq, jk, jv, **kw))


def test_attention_keeps_the_chunk_assertion(rng):
    q = torch.zeros(1, 10, 2, 4)
    with pytest.raises(AssertionError):
        TL.attention(q, q, q, causal=True, q_chunk=4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_gqa_padded_cache_matches_reference(rng, dtype):
    """GQA (8 heads on 2 KV heads) against a cache padded past ``length``
    with garbage that the mask must hide."""
    q, jq = _pair(rng, (3, 1, 8, 16))
    k, jk = _pair(rng, (3, 20, 2, 16))
    v, jv = _pair(rng, (3, 20, 2, 16))
    tdt, tol = (torch.float32, F32_TOL) if dtype == "float32" else (torch.bfloat16, BF16_TOL)
    args_t = [z.to(tdt) for z in (q, k, v)]
    args_j = [z.astype(dtype) for z in (jq, jk, jv)]
    length = 11
    got = TL.decode_attention(*args_t, torch.tensor(length, dtype=torch.int32))
    _close(got, _j(JL.decode_attention, *args_j, jnp.int32(length)), tol)
    k2 = args_t[1].clone()
    k2[:, length:] = 1e3  # past the valid prefix: invisible
    assert torch.equal(TL.decode_attention(args_t[0], k2, args_t[2], length), got)


@pytest.mark.parametrize("pos", [0, 5, 7, 8, 11])
def test_write_token_clamps_like_dynamic_update_slice(rng, pos):
    c, jc = _pair(rng, (2, 8, 3))
    n, jn = _pair(rng, (2, 1, 3))
    TL.write_token(c, torch.tensor(pos, dtype=torch.int32), n)
    _close(c, jax.lax.dynamic_update_slice_in_dim(jc, jn, pos, axis=1))


def test_qkv_and_out_project_with_bias_match_reference(rng):
    cfg = get_reduced_config("qwen2-1.5b")  # qkv_bias, GQA 6 / 2
    from repro.models import transformer as JT
    from repro_torch.models import transformer as TT

    defs = {k[len("layers."):]: v for k, v in TT.param_defs(cfg).items()
            if k.startswith("layers.")}
    tp, jp = _params(rng, defs)
    x, jx = _pair(rng, (2, 5, cfg.d_model))
    got = TL.qkv_project(cfg, x, tp)
    want = _j(functools.partial(JL.qkv_project, j_get_reduced("qwen2-1.5b")), jx, jp)
    for g, w in zip(got, want):
        _close(g, w)
    _close(TL.out_project(got[0], tp), _j(JL.out_project, want[0], jp))
    _close(TL.repeat_kv(got[1], 6), JL.repeat_kv(want[1], 6))
    assert JT.TP == TT.TP


# ---------------------------------------------------------------------------
# MLPs and MoE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "whisper-base"])  # swiglu, gelu
def test_mlp_matches_reference(rng, arch):
    cfg = get_reduced_config(arch)
    d, ff = cfg.d_model, cfg.d_ff
    defs = {"w_gate": ((1, d, ff), None), "w_up": ((1, d, ff), None),
            "w_down": ((1, ff, d), None), "b_up": ((1, ff), None), "b_down": ((1, d), None)}
    tp, jp = _params(rng, defs)
    x, jx = _pair(rng, (2, 5, d))
    _close(TL.mlp(cfg, x, tp), _j(functools.partial(JL.mlp, j_get_reduced(arch)), jx, jp))


def test_gelu_is_the_tanh_approximation(rng):
    x, jx = _pair(rng, (1000,), 3.0)
    _close(TL.gelu(x), jax.nn.gelu(jx), (1e-6, 1e-6))
    assert not torch.allclose(TL.gelu(x), torch.nn.functional.gelu(x), rtol=0, atol=1e-6)


MOE_CASES = {
    # (reduced arch, overrides): base routing; drops beyond a small capacity;
    # token chunks (nchunks 4); bf16 combine with shared experts
    "base": ("grok-1-314b", {}),
    "drops": ("grok-1-314b", {"capacity_factor": 0.25}),
    "chunks": ("deepseek-moe-16b", {"moe_dispatch_tokens": 16}),
    "bf16": ("deepseek-moe-16b", {"dtype": "bfloat16"}),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_ffn_matches_reference(rng, case):
    arch, over = MOE_CASES[case]
    cfg = dataclasses.replace(get_reduced_config(arch), **over)
    j_cfg = dataclasses.replace(j_get_reduced(arch), **over)
    from repro_torch.models import transformer as TT

    defs = {k[len("layers."):]: v for k, v in TT.param_defs(cfg).items()
            if k.startswith("layers.moe_")}
    tp, jp = _params(rng, defs)
    x, jx = _pair(rng, (4, 16, cfg.d_model))  # n = 64 tokens
    tol = F32_TOL
    if case == "bf16":
        x, jx, tol = x.to(torch.bfloat16), jx.astype(jnp.bfloat16), (2e-2, 2e-2)
    got = TL.moe_ffn(cfg, x, tp)
    assert got.dtype == x.dtype
    _close(got, _j(functools.partial(JL.moe_ffn, j_cfg), jx, jp), tol)
    if case == "drops":  # some expert got more than its capacity of 8
        logits = x.reshape(64, -1) @ tp["moe_router"]
        experts = torch.topk(torch.softmax(logits, -1), cfg.top_k, dim=-1).indices
        assert torch.bincount(experts.reshape(-1), minlength=cfg.num_experts).max() > 8
    if case == "chunks":  # 64 tokens route as 4 chunks of 16
        assert 64 // 4 <= cfg.moe_dispatch_tokens < 64 // 2


def test_moe_aux_loss_matches_reference(rng):
    logits, jlogits = _pair(rng, (32, 4))
    experts = rng.integers(0, 4, (32, 2)).astype(np.int32)
    _close(TL.moe_aux_loss(logits, torch.from_numpy(experts), 4),
           _j(JL.moe_aux_loss, jlogits, jnp.asarray(experts), e=4))


# ---------------------------------------------------------------------------
# the configs and their tables (no allocation)
# ---------------------------------------------------------------------------


JAX_ONLY_KNOBS = {"residual_shard", "scan_unroll"}


def _dt(x) -> str:
    return str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_are_the_reference_numbers(arch):
    for t_cfg, j_cfg in ((get_config(arch), j_get_config(arch)),
                         (get_reduced_config(arch), j_get_reduced(arch))):
        got, want = dataclasses.asdict(t_cfg), dataclasses.asdict(j_cfg)
        # the port leaves out the reference's mesh knobs only
        assert set(want) - set(got) == JAX_ONLY_KNOBS
        assert got == {k: want[k] for k in got}
        assert str(t_cfg.activation_dtype()).replace("torch.", "") == str(
            j_cfg.activation_dtype())
        assert _dt(torch.empty(0, dtype=t_cfg.parameter_dtype())) == str(
            j_cfg.parameter_dtype())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_config_tables_match_reference(arch):
    """Published configs: param paths, shapes and specs (as tuples), counts,
    padded vocab, shape applicability, input / cache specs, abstract
    params and caches, all without allocating."""
    cfg, j_cfg = get_config(arch), j_get_config(arch)
    impl, j_impl = model_api.get_model(cfg), j_api.get_model(j_cfg)
    defs, j_defs = impl.param_defs(cfg), j_impl.param_defs(j_cfg)
    assert list(defs) == list(j_defs)
    for path, (shape, spec) in defs.items():
        assert shape == j_defs[path][0] and spec == tuple(j_defs[path][1]), path
    assert cfg.n_params() == j_cfg.n_params()
    assert cfg.n_active_params() == j_cfg.n_active_params()
    assert cfg.padded_vocab() == j_cfg.padded_vocab()
    abstract = model_api.flatten(model_api.abstract_params(cfg))
    assert all(t.device.type == "meta" for t in abstract.values())
    assert {k: tuple(t.shape) for k, t in abstract.items()} == {
        k: s for k, (s, _) in defs.items()}
    specs = model_api.flatten(model_api.param_pspecs(cfg))
    assert specs == {k: sp for k, (_, sp) in defs.items()}
    for shape, j_shape in zip(model_api.ALL_SHAPES, j_api.ALL_SHAPES):
        assert dataclasses.asdict(shape) == dataclasses.asdict(j_shape)
        ok = model_api.shape_applicable(cfg, shape)
        assert ok == j_api.shape_applicable(j_cfg, j_shape)
        if not ok[0]:
            continue
        got, want = impl.input_specs(cfg, shape), j_impl.input_specs(j_cfg, j_shape)
        assert list(got) == list(want)
        for k in got:
            assert got[k].device.type == "meta"
            assert (tuple(got[k].shape), _dt(got[k])) == (want[k].shape, str(want[k].dtype)), k
    got = impl.init_cache(cfg, 4, 48, abstract=True)
    want = j_impl.init_cache(j_cfg, 4, 48, abstract=True)
    assert list(got) == list(want)
    for k in got:
        assert got[k].device.type == "meta"
        assert (tuple(got[k].shape), _dt(got[k])) == (want[k].shape, str(want[k].dtype)), k
    got, want = impl.cache_specs(cfg, 4, 48), j_impl.cache_specs(j_cfg, 4, 48)
    assert got == {k: tuple(v) for k, v in want.items()}
    if cfg.family in ("dense", "moe", "vlm"):
        from repro.models import transformer as JT
        from repro_torch.models import transformer as TT

        for shape, j_shape in zip(model_api.ALL_SHAPES, j_api.ALL_SHAPES):
            assert TT.batch_pspecs(cfg, shape) == {
                k: tuple(v) for k, v in JT.batch_pspecs(j_cfg, j_shape).items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reduced_init_cache_matches_reference(arch):
    """init_cache on the CPU: the reference's shapes, dtypes and zeros,
    pos = seq - 1 (and an encdec's cross_len = seq); k and v distinct
    tensors (decode writes them in place)."""
    cfg, j_cfg = get_reduced_config(arch), j_get_reduced(arch)
    got = model_api.get_model(cfg).init_cache(cfg, 2, 20, device="cpu")
    want = j_api.get_model(j_cfg).init_cache(j_cfg, 2, 20)
    assert list(got) == list(want)
    for k in got:
        assert (tuple(got[k].shape), _dt(got[k])) == (want[k].shape, str(want[k].dtype)), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    tensors = [v for v in got.values() if v.ndim]
    assert len({t.data_ptr() for t in tensors}) == len(tensors)


def test_init_params_follows_the_reference_rule():
    """Ones for *scale, zeros for *bias / .b_*, scale x normal otherwise, in
    the parameter dtype, from the generator on the requested device."""
    cfg = get_reduced_config("whisper-base")  # layernorm biases and b_up / b_down
    p = model_api.flatten(model_api.init_params(torch.Generator().manual_seed(0), cfg,
                                                device="cpu"))
    again = model_api.flatten(model_api.init_params(torch.Generator().manual_seed(0), cfg,
                                                    device="cpu"))
    assert set(p) == set(model_api.get_model(cfg).param_defs(cfg))
    for path, v in p.items():
        assert v.dtype == torch.float32 and torch.equal(v, again[path])
        if path.endswith("scale"):
            assert torch.equal(v, torch.ones_like(v)), path
        elif path.endswith("bias") or ".b_" in path:
            assert not v.any(), path
        else:
            assert 0.015 < float(v.std()) < 0.025, path
    bf = dataclasses.replace(cfg, param_dtype="bfloat16")
    assert model_api.init_params(torch.Generator(), bf, device="cpu")["embed"].dtype == (
        torch.bfloat16)


# ---------------------------------------------------------------------------
# the launcher, the device rule, the import rule
# ---------------------------------------------------------------------------


def _j_launcher_keys() -> list[str]:
    """The keys of the JSON line ``python -m repro.launch.serve`` prints,
    read from its source (``json.dumps({...})``)."""
    src = pathlib.Path(j_api.__file__).parents[1] / "launch" / "serve.py"
    for node in ast.walk(ast.parse(src.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps":
            return [k.value for k in node.args[0].keys]
    raise AssertionError("no json.dumps in the JAX serve launcher")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_launcher_runs_with_the_reference_keys(arch, capsys):
    from repro_torch.launch import serve

    report = serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
                         "--prompt-len", "16", "--max-new", "3"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == report
    assert list(report) == _j_launcher_keys() == [
        "arch", "generated_shape", "tokens", "seconds", "tok_per_s", "sample"]
    assert report["arch"] == arch and report["generated_shape"] == [2, 3]
    assert report["tokens"] == 6 and len(report["sample"]) == 3


def test_params_cross_by_path_and_raise_on_mismatch():
    """The reference's own init_params tree crosses intact (every path,
    shape and value); a missing, extra or misshapen path raises."""
    from repro_torch.convert import lm_params_from_reference

    j_cfg, cfg = j_get_reduced("chatglm3-6b"), get_reduced_config("chatglm3-6b")
    tree = jax.tree.map(np.asarray, jax.jit(functools.partial(
        j_api.init_params, cfg=j_cfg))(jax.random.PRNGKey(0)))
    got = model_api.flatten(lm_params_from_reference(tree, cfg, device="cpu"))
    want = model_api.flatten(tree)
    assert list(got) == list(model_api.get_model(cfg).param_defs(cfg))
    for k, v in got.items():
        assert v.dtype == cfg.parameter_dtype()
        np.testing.assert_array_equal(v.numpy(), want[k])
    bf = dataclasses.replace(cfg, param_dtype="bfloat16")
    as_bf16 = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), tree)
    got = lm_params_from_reference(as_bf16, bf, device="cpu")
    assert torch.equal(got["embed"], torch.from_numpy(tree["embed"]).to(torch.bfloat16))
    copy = model_api.tree_map(lambda a: a, tree)
    del copy["layers"]["wq"]
    with pytest.raises(ValueError, match="missing"):
        lm_params_from_reference(copy, cfg, device="cpu")
    with pytest.raises(ValueError, match="extra"):
        lm_params_from_reference({**tree, "extra": np.zeros(3, np.float32)}, cfg, device="cpu")
    with pytest.raises(ValueError, match="shapes"):
        lm_params_from_reference({**tree, "embed": tree["embed"][:-1]}, cfg, device="cpu")


def _entry_points():
    from repro_torch.configs.base import get_reduced_config as cfg_of
    from repro_torch.convert import lm_params_from_reference
    from repro_torch.core import samplers
    from repro_torch.data import synthetic
    from repro_torch.distributed import krr_dist
    from repro_torch.launch import serve

    cfg = cfg_of("qwen2-1.5b")
    impl = model_api.get_model(cfg)
    dist_cfg = krr_dist.DistKRRConfig(n=16, d=2, sigma=1.0, lam_unscaled=1e-3, block_size=4,
                                      rank=2)
    return {
        "uniform_sampler": lambda: samplers.uniform_sampler(10, 3),
        "init_dist_state": lambda: krr_dist.init_dist_state(dist_cfg, 0),
        "init_params": lambda: model_api.init_params(torch.Generator(), cfg),
        "lm_params_from_reference": lambda: lm_params_from_reference(
            {k: np.zeros(s, np.float32) for k, (s, _) in impl.param_defs(cfg).items()}, cfg),
        "init_cache": lambda: impl.init_cache(cfg, 1, 4),
        "batch_for": lambda: synthetic.batch_for(cfg, (1, 4), 0, 0),
        "launch.serve": lambda: serve.main(["--arch", "qwen2-1.5b", "--reduced"]),
    }


@pytest.mark.parametrize("name", ["uniform_sampler", "init_dist_state", "init_params",
                                  "lm_params_from_reference", "init_cache", "batch_for",
                                  "launch.serve"])
def test_entry_points_default_to_the_card(name):
    """Given no device, each entry point asks for cuda, and without a card
    that raises (nothing quietly runs on the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda default runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()


_IMPORT_GUARD = r"""
import importlib, json, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.modules["sklearn"] = None  # the card's machine has none either
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                                  "repro_torch.")]
bad = {}
for name in names:
    try:
        importlib.import_module(name)
    except Exception as e:
        bad[name] = repr(e)
sys.path.insert(0, sys.argv[1])
import chip_smoke  # noqa: F401  (the card script imports its phases lazily)
print(json.dumps({"modules": names, "failed": bad}))
"""


def test_every_port_module_imports_without_jax_or_the_jax_package():
    """In a process where ``import jax``, ``import repro`` and ``import
    sklearn`` fail, every module of ``repro_torch`` (the LM ones included)
    and ``chip_smoke.py`` import."""
    out = subprocess.run([sys.executable, "-c", _IMPORT_GUARD, str(ROOT)], check=True,
                         capture_output=True, text=True, timeout=240,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         cwd=str(ROOT))
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["failed"] == {}
    for name in ("repro_torch.models.transformer", "repro_torch.models.hybrid",
                 "repro_torch.models.encdec", "repro_torch.configs.qwen2_1_5b",
                 "repro_torch.serving.serve_step", "repro_torch.launch.serve",
                 "repro_torch.core.askotch"):
        assert name in report["modules"]
    assert len(report["modules"]) == len(list(pkgutil.walk_packages(
        importlib.import_module("repro_torch").__path__, "repro_torch."))) + 1
