"""The port's checkpointer, data pipeline, training-state conversion and
training launcher (``repro_torch.checkpoint`` / ``data.pipeline`` /
``convert`` / ``launch.train``), on the CPU against the JAX package.

Checkpoints cross both ways bitwise (f32, int, nested dicts and tuples);
bf16 leaves round-trip in the port as bf16, and a bf16 checkpoint written
by the JAX package comes back as bf16 (the reference's own ``restore``
returns such leaves as raw 2-byte voids).  The pipeline's batches are the
port's ``synthetic.batch_for`` for (seed, step), which draws from torch's
streams: its tokens are not the JAX pipeline's, but its cursor is, and a
resumed pipeline repeats the uninterrupted one bit for bit.  The launcher's
fault drill is the JAX test's (tests/test_distributed.py:265-288).
"""

import argparse
import contextlib
import io
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_lm_reference as R  # noqa: E402

from repro.checkpoint import checkpointer as JC  # noqa: E402
from repro.configs.base import get_reduced_config as j_reduced  # noqa: E402
from repro.data.pipeline import LMDataPipeline as JPipeline  # noqa: E402
from repro.launch import train as j_train  # noqa: E402
from repro.training.optimizers import make_optimizer as j_make_optimizer  # noqa: E402
from repro_torch.checkpoint import checkpointer as TC  # noqa: E402
from repro_torch.configs.base import ARCH_IDS, get_reduced_config  # noqa: E402
from repro_torch.convert import train_state_from_reference  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.data.pipeline import LMDataPipeline  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models.model_api import flatten  # noqa: E402


def _state(rng):
    """A tree with the shapes a checkpoint holds: nested dicts, a tuple, f32
    weights, int32 and int64 leaves, a 0-d counter."""
    return {"params": {"w": rng.standard_normal((4, 6)).astype(np.float32),
                       "layers": {"b": rng.standard_normal((3,)).astype(np.float32)}},
            "opt_state": ({"m": rng.standard_normal((4, 6)).astype(np.float32)},
                          np.arange(5, dtype=np.int32)),
            "count": np.int64(12)}


def _leaves(tree):
    return dict(sorted(TC._flatten(tree).items()))


def _as_numpy(leaf):
    return leaf.numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)


def _assert_bitwise(got, want):
    got, want = _leaves(got), _leaves(want)
    assert list(got) == list(want)
    for k in want:
        a, b = _as_numpy(got[k]), _as_numpy(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_torch_tree(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def test_port_checkpoint_is_read_by_jax_bitwise(tmp_path, rng):
    state = _state(rng)
    TC.save(str(tmp_path), 7, _torch_tree(state), extra={"data": {"seed": 1, "step": 7}})
    restored, extra, step = JC.restore(str(tmp_path))
    assert step == 7 and extra == {"data": {"seed": 1, "step": 7}}
    assert isinstance(restored["opt_state"], tuple)
    _assert_bitwise(restored, state)


def test_jax_checkpoint_is_read_by_port_bitwise(tmp_path, rng):
    state = _state(rng)
    JC.save(str(tmp_path), 3, jax.tree.map(jnp.asarray, state), extra={"arch": "x"})
    restored, extra, step = TC.restore(str(tmp_path), device="cpu")
    assert step == 3 and extra == {"arch": "x"}
    assert all(isinstance(v, torch.Tensor) for v in _leaves(restored).values())
    want = {**state, "count": np.asarray(jnp.asarray(state["count"]))}  # JAX holds 32 bits
    _assert_bitwise(restored, want)


def test_bf16_leaves_round_trip_as_bf16(tmp_path, rng):
    """A bf16 leaf written by the port, and one written by the JAX package,
    restore as bf16 with the same bits; the JAX package reads the port's
    bytes as it reads its own."""
    x = rng.standard_normal((5, 7)).astype(np.float32)
    t = torch.from_numpy(x).to(torch.bfloat16)
    TC.save(str(tmp_path / "port"), 1, {"w": t, "f": torch.from_numpy(x)})
    back, _, _ = TC.restore(str(tmp_path / "port"), device="cpu")
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], t)
    j = jnp.asarray(x, jnp.bfloat16)
    JC.save(str(tmp_path / "jax"), 1, {"w": j})
    from_jax, _, _ = TC.restore(str(tmp_path / "jax"), device="cpu")
    assert from_jax["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(from_jax["w"].view(torch.int16).numpy(),
                                  np.asarray(j).view(np.int16))
    assert torch.equal(from_jax["w"], t)
    j_back, _, _ = JC.restore(str(tmp_path / "port"))
    np.testing.assert_array_equal(j_back["w"].view(np.int16), np.asarray(j).view(np.int16))
    for name in ("port", "jax"):
        manifest = json.loads((tmp_path / name / "step_00000001" / "manifest.json").read_text())
        assert manifest["dtypes"]["w"] == "bfloat16"


def test_checkpoint_crash_consistency_and_gc(tmp_path, rng):
    state = _torch_tree(_state(rng))
    TC.save(str(tmp_path), 5, state)
    # a crash mid-write of step 9: its .tmp directory is never a checkpoint
    os.makedirs(tmp_path / "step_00000009.tmp")
    (tmp_path / "step_00000009.tmp" / "arrays.npz").write_bytes(b"garbage")
    assert TC.latest_step(str(tmp_path)) == 5
    assert TC.restore(str(tmp_path), device="cpu")[2] == 5
    TC.save(str(tmp_path), 9, state)  # rewrites the stale .tmp, then renames
    assert not (tmp_path / "step_00000009.tmp").exists()
    assert TC.latest_step(str(tmp_path)) == 9
    for s in (10, 11, 12):
        TC.save(str(tmp_path), s, state, keep_last=2)
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_00000011", "step_00000012"]
    assert TC.latest_step(str(tmp_path / "missing")) is None
    with pytest.raises(FileNotFoundError):
        TC.restore(str(tmp_path / "missing"), device="cpu")


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "llava-next-mistral-7b", "whisper-base"])
def test_pipeline_is_batch_for_and_resumable(arch):
    """Each batch is ``batch_for(cfg, (B, T), seed, step)`` bitwise, with the
    JAX pipeline's keys, shapes and dtypes; a pipeline rebuilt from its
    state after two batches (or from the JAX pipeline's state) repeats
    the third."""
    cfg = get_reduced_config(arch)
    p1 = LMDataPipeline(cfg, 4, 16, seed=3, device="cpu")
    batches = [next(p1) for _ in range(3)]
    for step, b in enumerate(batches):
        want = synthetic.batch_for(cfg, (4, 16), 3, step, device="cpu")
        assert sorted(b) == sorted(want)
        assert all(torch.equal(b[k], want[k]) for k in want)
    assert p1.state() == {"seed": 3, "step": 3}
    jp = JPipeline(j_reduced(arch), 4, 16, seed=3, start_step=2)
    j_batch = jax.eval_shape(lambda: next(JPipeline(j_reduced(arch), 4, 16, seed=3)))
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in batches[0].items()} \
        == {k: (tuple(v.shape), str(v.dtype)) for k, v in j_batch.items()}
    for state in ({"seed": 3, "step": 2}, jp.state()):
        b3 = next(LMDataPipeline.from_state(cfg, 4, 16, state, device="cpu"))
        assert all(torch.equal(b3[k], batches[2][k]) for k in b3)


@pytest.mark.parametrize("arch,opt,param_dtype", [
    ("qwen2-1.5b", "adamw", "float32"),
    ("grok-1-314b", "adafactor", "bfloat16"),
    ("rwkv6-1.6b", "sgdm", "float32"),
])
def test_train_state_from_reference(arch, opt, param_dtype):
    """A JAX training state (parameters in ``param_dtype``, bf16 ones
    included; an optimizer tree of the reference's layout) carried into the
    port: every leaf bitwise, in its
    dtype; a state of another optimizer is refused."""
    import dataclasses

    jcfg = dataclasses.replace(j_reduced(arch), param_dtype=param_dtype)
    cfg = dataclasses.replace(get_reduced_config(arch), param_dtype=param_dtype)
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda a: a.astype(jcfg.parameter_dtype()), R.np_params(jcfg))
    shapes = jax.eval_shape(j_make_optimizer(opt, 1e-2).init, params)
    state = jax.tree.map(lambda z: rng.standard_normal(z.shape).astype(z.dtype), shapes)
    t_params, t_state = train_state_from_reference(params, state, cfg, opt, device="cpu")
    for got, want in ((t_params, params), (t_state, state)):
        got, want = flatten(got), flatten(want)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            g = got[k]
            if w.dtype.name == "bfloat16":
                assert g.dtype == torch.bfloat16
                np.testing.assert_array_equal(g.view(torch.int16).numpy(), w.view(np.int16))
            else:
                assert str(g.dtype) == f"torch.{w.dtype.name}"
                np.testing.assert_array_equal(g.numpy(), w)
    other = "sgdm" if opt != "sgdm" else "adamw"
    with pytest.raises(ValueError, match="state paths"):
        train_state_from_reference(params, state, cfg, other, device="cpu")


def _args(tmp_path, name, **kw):
    base = dict(arch="qwen2-1.5b", reduced=True, steps=30, batch=4, seq=16, lr=1e-3, seed=0,
                ckpt_dir=str(tmp_path / name), ckpt_every=10, log_every=5, resume=False,
                inject_failure=-1, straggler_factor=3.0, device="cpu")
    return argparse.Namespace(**{**base, **kw})


def test_launcher_fault_drill_and_resume_on_cpu(tmp_path):
    """The JAX test's drill on the port: a failure injected at step 17
    restores step 10 and replays; the step-30 loss is a clean run's (within
    1e-4; the data resume is bit-exact, so it is the same number).  A run
    resumed from the clean run's step-20 checkpoint ends on the same loss
    too."""
    drill = t_train.run(_args(tmp_path, "drill", inject_failure=17))
    clean = t_train.run(_args(tmp_path, "clean"))
    assert drill["final_step"] == clean["final_step"] == 30
    final = {r["step"]: r["loss"] for r in drill["history"]}
    final2 = {r["step"]: r["loss"] for r in clean["history"]}
    assert abs(final[30] - final2[30]) < 1e-4, (final[30], final2[30])
    assert final[30] == final2[30]
    # the clean run's checkpoints (10, 20, 30) without step 30: resume at 20
    shutil.copytree(tmp_path / "clean", tmp_path / "resume")
    shutil.rmtree(tmp_path / "resume" / "step_00000030")
    resumed = t_train.run(_args(tmp_path, "resume", resume=True))
    assert resumed["final_step"] == 30
    assert [r["step"] for r in resumed["history"]] == [25, 30]
    assert resumed["history"][-1]["loss"] == final2[30]


def test_launcher_run_keys_and_lines_match_jax(tmp_path):
    """``run()``'s keys and each printed JSON line's keys and step numbers
    are the JAX launcher's (two steps, a line a step)."""
    out = {}
    for name, mod, extra in (("jax", j_train, {}), ("port", t_train, {"device": "cpu"})):
        args = _args(tmp_path, name, steps=2, batch=2, seq=8, log_every=1, ckpt_every=2)
        if name == "jax":
            del args.device
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = mod.run(args)
        lines = [json.loads(s) for s in buf.getvalue().splitlines() if s.startswith("{")]
        out[name] = (res, lines)
    (j_res, j_lines), (t_res, t_lines) = out["jax"], out["port"]
    assert list(t_res) == list(j_res) == ["history", "final_step"]
    assert t_res["final_step"] == j_res["final_step"] == 2
    assert [list(r) for r in t_lines] == [list(r) for r in j_lines] == [["step", "loss", "sec"]] * 2
    assert [r["step"] for r in t_lines] == [r["step"] for r in j_lines] == [1, 2]
    assert t_res["history"] == t_lines
    manifest = json.loads((tmp_path / "port" / "step_00000002" / "manifest.json").read_text())
    j_manifest = json.loads((tmp_path / "jax" / "step_00000002" / "manifest.json").read_text())
    assert manifest["keys"] == j_manifest["keys"]
    assert manifest["extra"] == j_manifest["extra"]


@pytest.mark.parametrize("name", ["pipeline", "restore", "train_state", "launcher"])
def test_training_entry_points_default_to_the_card(tmp_path, name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda default runs")
    cfg = get_reduced_config("qwen2-1.5b")
    TC.save(str(tmp_path), 1, {"w": torch.zeros(2)})
    calls = {
        "pipeline": lambda: LMDataPipeline(cfg, 2, 8),
        "restore": lambda: TC.restore(str(tmp_path)),
        "train_state": lambda: train_state_from_reference({}, {}, cfg, "adamw"),
        "launcher": lambda: t_train.main(["--arch", "qwen2-1.5b", "--reduced", "--steps", "1"]),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[name]()


def test_every_config_carries_the_reference_training_knobs():
    """optimizer, remat, microbatches_train and grad_accum_dtype of all ten
    configs, published and reduced, are the JAX package's."""
    from repro.configs.base import get_config as j_config
    from repro_torch.configs.base import get_config

    keys = ("optimizer", "remat", "microbatches_train", "grad_accum_dtype")
    for arch in ARCH_IDS:
        for t_cfg, j_cfg in ((get_config(arch), j_config(arch)),
                             (get_reduced_config(arch), j_reduced(arch))):
            assert {k: getattr(t_cfg, k) for k in keys} == {k: getattr(j_cfg, k) for k in keys}
