"""The port's telemetry (``repro_torch.obs``) held against the JAX package's
(``repro.obs``).

Inputs are made with numpy from a seed; JAX runs on the CPU
(``backend="xla"``), the port on CPU tensors.  Every check here is exact:
the schemas, the counters (host-side counts from shapes and iteration
numbers, so the same solve gives the same floats), the Prometheus text and
the report of one event stream.  The solver histories with telemetry on
equal those with it off field for field, ``time_s`` aside.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import obs as j_obs  # noqa: E402
from repro.core.krr import KRRProblem as JProblem  # noqa: E402
from repro.core.solver_api import solve as j_solve  # noqa: E402
from repro.core.solver_api import tune as j_tune  # noqa: E402
from repro.obs import metrics as j_metrics  # noqa: E402
from repro.obs import report as j_report  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core.krr import KRRProblem  # noqa: E402
from repro_torch.core.solver_api import solve, tune  # noqa: E402
from repro_torch.obs import metrics, report  # noqa: E402
from repro_torch.roofline import hw  # noqa: E402

N, D, B, R, ITERS = 200, 5, 40, 10, 4
TUNE = dict(sigmas=(1.0,), lams=(1e-4, 1e-2), folds=3, max_iters=12, rank=R, tol=1e-12)


@pytest.fixture(scope="module")
def xy():
    r = np.random.default_rng(8)
    x = r.standard_normal((N, D)).astype(np.float32)
    y = (np.sin(2 * x[:, 0]) + 0.3 * x[:, 1] + 0.05 * r.standard_normal(N)).astype(np.float32)
    return x, y


def _tp(xy):
    return KRRProblem(x=torch.from_numpy(xy[0]), y=torch.from_numpy(xy[1]), lam_unscaled=1e-4)


def _jp(xy):
    return JProblem(x=jnp.asarray(xy[0]), y=jnp.asarray(xy[1]), lam_unscaled=1e-4, backend="xla")


@pytest.fixture(scope="module")
def runs(xy, tmp_path_factory):
    """One ASkotch solve and one tune in each package, with telemetry, each
    bracketed by its registry's snapshots; the port's solve also to JSONL."""
    path = str(tmp_path_factory.mktemp("obs") / "run.jsonl")
    askotch_kw = dict(max_iters=ITERS, eval_every=2, block_size=B, rank=R)
    out = {"path": path}
    tel = obs.Telemetry(jsonl=path)
    s0 = obs.snapshot()
    out["solve"] = solve(_tp(xy), "askotch", telemetry=tel, **askotch_kw)
    s1 = obs.snapshot()
    out["tune"] = tune(_tp(xy), telemetry=tel, **TUNE)
    s2 = obs.snapshot()
    tel.close()
    out["solve_diff"], out["tune_diff"] = obs.diff(s0, s1), obs.diff(s1, s2)
    jtel = j_obs.Telemetry(ring=True)
    s0 = j_obs.snapshot()
    j_solve(_jp(xy), "askotch", telemetry=jtel, **askotch_kw)
    s1 = j_obs.snapshot()
    out["j_tune"] = j_tune(_jp(xy), telemetry=jtel, **TUNE)
    s2 = j_obs.snapshot()
    out["j_solve_diff"], out["j_tune_diff"] = j_obs.diff(s0, s1), j_obs.diff(s1, s2)
    return out


def _events(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def test_schemas_and_events_are_the_references(runs):
    assert obs.SCHEMAS == j_obs.SCHEMAS
    counts = obs.validate_jsonl(runs["path"])
    assert counts == j_obs.validate_jsonl(runs["path"])
    events = _events(runs["path"])
    for e in events:
        j_obs.validate_event(e)
    traces = [e for e in events if e["type"] == "trace" and e["solver"] == "askotch"]
    hist = runs["solve"].history
    assert len(traces) == len(hist) == ITERS // 2
    assert [e["iter"] for e in traces] == [h["iter"] for h in hist]
    assert all(e["precision"] == "f32" for e in traces)
    (span,) = [e for e in events if e["type"] == "span" and e["name"] == "solve/askotch"]
    assert span["dur_s"] >= hist[-1]["time_s"]
    assert span["attrs"] == {"n": N, "t": 1, "b": B, "max_iters": ITERS, "tol": 1e-8}
    names = {e["name"] for e in events if e["type"] == "span"}
    assert {"tune/search", "tune/group"} <= names
    tune_traces = [e for e in events if e["type"] == "trace" and e["solver"] == "tune"]
    assert tune_traces and tune_traces[-1]["sweeps"] <= runs["tune"].sweeps


def test_tile_counters_equal_the_references(runs):
    assert runs["solve_diff"] == runs["j_solve_diff"]
    flops = sum(v for k, v in runs["solve_diff"].items() if k.startswith("repro_tile_flops"))
    assert flops == ITERS * (B * B + B * N) * (2 * D + 8)


def test_tune_pair_and_cg_counters_equal_the_references(runs):
    assert runs["tune_diff"] == runs["j_tune_diff"]
    assert runs["tune_diff"]["repro_kernel_pairs_total"] == runs["tune"].sweeps * N**2
    assert runs["tune_diff"]["repro_cg_iterations_total"] > 0
    for key in ("sigma", "lam_unscaled"):
        assert runs["tune"].best[key] == runs["j_tune"].best[key]


def _fill(mod):
    reg = mod.MetricsRegistry()
    reg.counter("repro_kernel_pairs_total", help="pairs").inc(1.5e9)
    reg.counter("repro_tile_flops_total", labels={"dtype": "bf16"}).inc(3.0)
    reg.gauge("queue_depth").set(7)
    h = reg.histogram("latency_ms", labels={"model": "m"}, help="ms",
                      buckets=mod.log_buckets(0.1, 100.0, per_decade=2))
    for v in (0.05, 0.3, 2.0, 2.5, 40.0, 500.0):
        h.observe(v)
    return reg, h


def test_prometheus_histograms_and_report_equal_the_references(runs, capsys):
    (reg, h), (jreg, jh) = _fill(metrics), _fill(j_metrics)
    assert reg.prometheus_text() == jreg.prometheus_text()
    assert reg.snapshot() == jreg.snapshot()
    assert [h.quantile(q) for q in (0.0, 0.5, 0.9, 1.0)] == \
        [jh.quantile(q) for q in (0.0, 0.5, 0.9, 1.0)]
    assert report.summarize(runs["path"]) == j_report.summarize(runs["path"])
    capsys.readouterr()
    assert report.main([runs["path"]]) == 0
    got = capsys.readouterr().out
    assert j_report.main([runs["path"]]) == 0
    assert got == capsys.readouterr().out


SPAN_OF = {"cg": "solve/pcg", "pcg-nystrom": "solve/pcg"}


@pytest.mark.parametrize("method,kw", [
    ("askotch", dict(max_iters=4, eval_every=2, block_size=B, rank=R)),
    ("pcg-nystrom", dict(max_iters=5, rank=R)),
    ("cg", dict(max_iters=5)),
    ("falkon", dict(m=30, max_iters=5)),
    ("eigenpro", dict(epochs=1, eval_every=20)),
    ("direct", dict()),
])
def test_history_unchanged_with_telemetry(xy, method, kw):
    tel = obs.Telemetry(ring=True, profiler=True)
    on = solve(_tp(xy), method, telemetry=tel, **kw)
    off = solve(_tp(xy), method, **kw)
    strip = [{k: v for k, v in h.items() if k != "time_s"} for h in off.history]
    assert [{k: v for k, v in h.items() if k != "time_s"} for h in on.history] == strip
    assert [list(h) for h in on.history] == [list(h) for h in off.history]
    assert torch.equal(on.w, off.w)
    spans = [e for e in tel.ring.events() if e["type"] == "span"]
    assert [e["name"] for e in spans] == [SPAN_OF.get(method, f"solve/{method}")]
    traces = [e for e in tel.ring.events() if e["type"] == "trace"]
    assert len(traces) == len(on.history)


def test_disabled_session_and_roofline():
    assert obs.as_telemetry(None) is obs.NULL_TELEMETRY and not obs.NULL_TELEMETRY.enabled
    assert obs.NULL_TELEMETRY.span("x") is obs.span("x")  # the shared no-op span
    with pytest.raises(TypeError):
        obs.as_telemetry("run.jsonl")
    assert hw.NAME == "NVIDIA H100 80GB HBM3" and hw.POWER_LIMIT_W == 700.0
    assert metrics.roofline_time_s(67e12, 1.0) == pytest.approx(1.0)
    assert metrics.roofline_time_s(1.0, 3.35e12) == pytest.approx(1.0)
    assert metrics.roofline_time_s(989e12, 1.0, "bf16") == pytest.approx(1.0)


def test_launchers_write_valid_telemetry(tmp_path, capsys):
    from repro_torch.launch import krr_solve, krr_tune

    p1, p2 = str(tmp_path / "solve.jsonl"), str(tmp_path / "tune.jsonl")
    small = ["--n", "300", "--n-test", "50", "--d", "4", "--device", "cpu"]
    rep = krr_solve.main(small + ["--iters", "10", "--telemetry", p1])
    assert list(rep)[-1] == "telemetry" and rep["telemetry"] == p1
    assert obs.validate_jsonl(p1)["trace"] >= 1
    rep = krr_tune.main(small + ["--sigmas", "1.0", "--lams", "1e-4,1e-2", "--folds", "2",
                                 "--iters", "10", "--refit-iters", "10", "--telemetry", p2])
    assert list(rep)[-1] == "telemetry"
    names = {e["name"] for e in _events(p2) if e["type"] == "span"}
    assert {"tune/search", "tune/group", "solve/askotch"} <= names
    assert obs.validate_jsonl(p2)["metric"] >= 3
    capsys.readouterr()
