"""The port's Mamba sublayer (``repro_torch.models.mamba``, three of every
four sublayers of the hybrid family) held against ``repro.models.mamba``:
``_causal_conv`` with and without its decode buffer, ``_ssm_scan`` (the
reference's plain scan and its time-chunked one), and ``mamba_forward`` as a
prefill and as a stateful decode chained from it.

At the family tests' 0.02 parameter scale the sublayer barely moves the
residual stream and the scan's own term is a small part of it, so these
checks use O(1) inputs: parameters are scaled so that x_in, dt, B and C are
O(1) and the decay exp(dt * A) stays between 0 and 1 without vanishing.
Tolerance: f32 rtol 2e-4 / atol 2e-5 x max(1, |ref|max), as the other LM
layer tests.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import get_reduced_config as j_get_reduced  # noqa: E402
from repro.models import mamba as JM  # noqa: E402
from repro_torch.configs.base import get_reduced_config  # noqa: E402
from repro_torch.models import mamba as TM  # noqa: E402

F32_TOL = (2e-4, 2e-5)
JAMBA = "jamba-1.5-large-398b"
_FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _close(got, want, what=""):
    want = np.asarray(want, np.float32)
    rtol, atol = F32_TOL
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=rtol, err_msg=what,
                               atol=atol * max(1.0, float(np.abs(want).max(initial=0.0))))


def _j(fn, *args):
    f = jax.jit(fn)
    return jax.tree.map(np.asarray, f.lower(*args).compile(_FAST)(*args))


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _mamba_params(cfg, rng, d_skip=True) -> dict:
    """One sublayer's params at O(1) scale (numpy, f32)."""
    d, di, ds, dr = cfg.d_model, TM.d_inner(cfg), cfg.d_state, TM.dt_rank(cfg)

    def g(shape, std):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    return {
        "in_proj": g((d, 2 * di), d ** -0.5),
        "conv_w": g((cfg.ssm_conv, di), cfg.ssm_conv ** -0.5),
        "conv_b": g((di,), 0.1),
        "x_proj": g((di, dr + 2 * ds), di ** -0.5),
        "dt_w": g((dr, di), dr ** -0.5),
        "dt_bias": g((di,), 0.5),
        "a_log": g((di, ds), 0.5),  # A = -exp(a_log) ~ -1
        "d_skip": g((di,), 1.0) if d_skip else np.zeros((di,), np.float32),
        "out_proj": g((di, d), di ** -0.5),
    }


@pytest.mark.parametrize("with_buf", [False, True])
def test_causal_conv_matches_reference(rng, with_buf):
    b, t, di, k = 2, 7, 12, 4
    x = rng.standard_normal((b, t, di)).astype(np.float32)
    w = rng.standard_normal((k, di)).astype(np.float32)
    bias = rng.standard_normal((di,)).astype(np.float32)
    buf = rng.standard_normal((b, k - 1, di)).astype(np.float32) if with_buf else None
    want_y, want_buf = _j(lambda *a: JM._causal_conv(*a, buf=buf), x, w, bias)
    got_y, got_buf = TM._causal_conv(*_t((x, w, bias)),
                                     None if buf is None else torch.from_numpy(buf))
    _close(got_y, want_y, "y")
    np.testing.assert_array_equal(got_buf.numpy(), want_buf)  # the last k - 1 inputs


@pytest.mark.parametrize("t", [16, 2 * JM.TIME_CHUNK])  # the plain scan and the chunked one
def test_ssm_scan_matches_reference(rng, t):
    b, di, ds = 2, 8, 4
    x = rng.standard_normal((b, t, di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, t, di)))).astype(np.float32)  # softplus
    bmat, cmat = (rng.standard_normal((b, t, ds)).astype(np.float32) for _ in range(2))
    a = -np.exp(0.5 * rng.standard_normal((di, ds))).astype(np.float32)
    h0 = rng.standard_normal((b, di, ds)).astype(np.float32)
    want_y, want_h = _j(JM._ssm_scan, x, dt, bmat, cmat, a, h0)
    got_y, got_h = TM._ssm_scan(*_t((x, dt, bmat, cmat, a, h0)))
    assert float(np.abs(want_y).mean()) > 0.3  # the scan's term is O(1)
    _close(got_y, want_y, "y")
    _close(got_h, want_h, "h_T")


@pytest.mark.parametrize("d_skip", ["live", "zero"])
def test_mamba_forward_prefill_and_decode_match_reference(rng, d_skip):
    """A prefill over T tokens, then three decode steps from its state
    (h, conv buffer), each against the reference; with d_skip zeroed the
    output is the selective scan's alone.  The port's chained decode also
    equals its own prefill over the T + 3 tokens."""
    cfg, j_cfg = get_reduced_config(JAMBA), j_get_reduced(JAMBA)
    cfg, j_cfg = (dataclasses.replace(c, d_model=32) for c in (cfg, j_cfg))
    p = _mamba_params(cfg, rng, d_skip=d_skip == "live")
    t, steps = 12, 3
    x = rng.standard_normal((2, t + steps, cfg.d_model)).astype(np.float32)

    def j_run(p, x):
        out, state = JM.mamba_forward(j_cfg, x[:, :t], p)
        outs = [out]
        for i in range(steps):
            o, state = JM.mamba_forward(j_cfg, x[:, t + i: t + i + 1], p, state=state)
            outs.append(o)
        return outs, state

    want, (want_h, want_buf) = _j(j_run, p, x)
    tp, tx = _t(p), torch.from_numpy(x)
    out, state = TM.mamba_forward(cfg, tx[:, :t], tp)
    assert float(np.abs(want[0]).mean()) > 0.1  # O(1), not the 0.02 scale's 1e-5
    _close(out, want[0], "prefill")
    chained = [out]
    for i in range(steps):
        o, state = TM.mamba_forward(cfg, tx[:, t + i: t + i + 1], tp, state=state)
        _close(o, want[1 + i], f"decode step {i}")
        chained.append(o)
    _close(state[0], want_h, "h after decode")
    _close(state[1], want_buf, "conv buffer after decode")
    whole, (h_whole, _) = TM.mamba_forward(cfg, tx, tp)
    _close(torch.cat(chained, dim=1), whole.numpy(), "chained decode vs one prefill")
    _close(state[0], h_whole.numpy(), "h: chained vs one prefill")


def test_mamba_state_shapes_match_reference():
    cfg, j_cfg = get_reduced_config(JAMBA), j_get_reduced(JAMBA)
    got = TM.state_shapes(cfg, 3, (2, 7))
    want = JM.init_state(j_cfg, 3, (2, 7), abstract=True)
    for (shape, dtype), w in zip(got, want):
        assert shape == w.shape and str(dtype).replace("torch.", "") == str(w.dtype)
    assert TM.state_specs(2) == tuple(tuple(s) for s in JM.state_specs(2))

