"""The port's exact sketch-and-project steps (``repro_torch.core.sap``) held
against the JAX package's (``repro.core.sap``).

Each port step is fed the reference's own ``jax.random`` draws (the block
indices ``idx=`` of randomized Newton and NSAP, the row ``j=`` of Kaczmarz
and coordinate descent), replayed from the reference's key splits; torch's
generators never reproduce JAX's streams.  Inputs are made with numpy from a
seed; JAX runs on the CPU (``backend="xla"``), the port on CPU tensors, both
in f32.  Tolerance: the iterates after ``STEPS`` steps agree to 1e-4
relative in the Frobenius norm (two f32 dense b x b solves and row sums in
another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import sap as j_sap  # noqa: E402
from repro.core.krr import KRRProblem as JProblem  # noqa: E402
from repro_torch.core import sap  # noqa: E402
from repro_torch.core.krr import KRRProblem  # noqa: E402

N, D, B, STEPS, SIGMA, LAM_UNSCALED = 160, 5, 24, 10, 1.5, 1e-3
MU, NU = 0.01, N / B  # tests/test_core_solvers.py's NSAP settings


def _rel(got, want):
    want = np.asarray(want)
    return float(np.linalg.norm(got.numpy() - want) / np.linalg.norm(want))


@pytest.fixture(scope="module", params=[None, 3], ids=["t1", "t3"])
def problems(request):
    r = np.random.default_rng(5)
    x = r.standard_normal((N, D)).astype(np.float32)
    f = np.sin(2 * x[:, 0]) + 0.3 * x[:, 1]
    t = request.param
    y = (f if t is None else f[:, None] * np.linspace(0.5, 1.5, t)[None, :])
    y = (y + 0.05 * r.standard_normal(y.shape)).astype(np.float32)
    jp = JProblem(x=jnp.asarray(x), y=jnp.asarray(y), sigma=SIGMA, lam_unscaled=LAM_UNSCALED,
                  backend="xla")
    tp = KRRProblem(x=torch.from_numpy(x), y=torch.from_numpy(y), sigma=SIGMA,
                    lam_unscaled=LAM_UNSCALED)
    return jp, tp


STEPS_OF = {
    "newton": (lambda p: j_sap.make_randomized_newton_step(p, B),
               lambda p: sap.make_randomized_newton_step(p, B), "idx"),
    "nsap": (lambda p: j_sap.make_nsap_step(p, B, MU, NU),
             lambda p: sap.make_nsap_step(p, B, MU, NU), "idx"),
    "kaczmarz": (j_sap.make_kaczmarz_step, sap.make_kaczmarz_step, "j"),
    "cd": (j_sap.make_cd_step, sap.make_cd_step, "j"),
}


def _draw(key, kind):
    """The reference step's own draw from ``key`` (``repro.core.sap``)."""
    key, kb = jax.random.split(key)
    if kind == "idx":
        return key, np.asarray(jax.random.choice(kb, N, (B,), replace=False))
    return key, int(jax.random.randint(kb, (), 0, N))


@pytest.mark.parametrize("name", sorted(STEPS_OF))
def test_step_matches_reference_with_its_draws(problems, name):
    jp, tp = problems
    make_j, make_t, kind = STEPS_OF[name]
    j_step, t_step = jax.jit(make_j(jp)), make_t(tp)
    w0 = jnp.zeros(jp.y.shape, jnp.float32)
    jstate = j_sap.SAPState(w=w0, v=w0, z=w0, key=jax.random.PRNGKey(4))
    tstate = sap.init_state(tp, seed=4)
    key = jstate.key
    for _ in range(STEPS):
        key, draw = _draw(key, kind)
        jstate = j_step(jstate)
        tstate = t_step(tstate, **{kind: draw})
    assert _rel(tstate.w, jstate.w) < 1e-4
    assert _rel(tstate.z, jstate.z) < 1e-4
    assert _rel(tstate.v, jstate.v) < 1e-4


@pytest.mark.parametrize("name,iters", [("newton", 30), ("nsap", 30), ("kaczmarz", 300),
                                        ("cd", 300)])
def test_run_with_own_draws_reduces_residual(problems, name, iters):
    _, tp = problems
    w = sap.run(tp, STEPS_OF[name][1](tp), iters, seed=1)
    assert w.shape == tp.y.shape and w.dtype == torch.float32
    assert float(tp.residual_report(w)[0]) < 1.0  # below its start at w = 0
