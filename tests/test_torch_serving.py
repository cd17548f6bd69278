"""The port's serving slice (``repro_torch.serving``, the ``krr_serve``
launcher, ``krr_tune --export-artifact``) held against the JAX package.

Inputs are made with numpy from a seed (n = 300 training rows, d = 5) and
cross between the packages as numpy arrays or as artifact directories; JAX
runs on the CPU, the port on CPU tensors (``device="cpu"``).  Tolerances
are the kernel tests': f32 rtol 2e-4 / atol 2e-5 and bf16 rtol 0.05 / atol
0.02, the atol scaled by max(1, |ref|max) (the packages sum in other
orders).  Within the port, coalescing must be bitwise invisible, as in
``tests/test_serving_engine.py``: on the CPU that rests on torch's matmul
giving a row the same sum in every bucket, which holds at these shapes
(not, for one, at n = 2000 with t >= 2); on the card the kernels give it by
construction (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase serve).
"""

import json
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import engine as j_engine  # noqa: E402
from repro.serving.krr_serve import make_krr_predict_fn_from_config as j_predict_fn  # noqa: E402
from repro_torch.serving import engine as t_engine  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    ServingEngine,
    bucket_for,
    bucket_sizes,
    load_model_artifact,
    save_model_artifact,
)
from repro_torch.serving.krr_serve import (  # noqa: E402
    bind_operator_from_config,
    make_krr_predict_fn_from_config,
    make_sharded_krr_predict_fn,
)

N, D, T = 300, 5, 3
TOL = {"f32": (2e-4, 2e-5), "bf16": (0.05, 0.02)}

CFG_RBF = {"kernel": "rbf", "sigma": 1.2, "precision": "f32"}
CFG_MULTI = {"kernel": ["rbf", "laplacian"], "sigma": 0.9, "weights": [0.6, 0.4],
             "precision": "f32"}
#: the configs held against the JAX package's predict closure
CONFIGS = {
    "rbf": {"kernel": "rbf", "sigma": 1.0},
    "laplacian": {"kernel": "laplacian", "sigma": 0.7},
    "multi": {"kernel": ["rbf", "laplacian", "matern52"], "sigma": [0.8, 1.0, 1.3],
              "weights": [0.5, 0.2, 0.3]},
    "precomputed": {"kernel": "precomputed", "sigma": 1.0},
    "bf16": {"kernel": "rbf", "sigma": 1.0, "precision": "bf16"},
}


def _close(got, want, precision="f32"):
    rtol, atol = TOL[precision]
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(1.0, float(np.abs(want).max())))


def _rbf_gram(a, b, sigma=1.0):
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return np.exp(-d2 / (2 * sigma**2)).astype(np.float32)


@pytest.fixture(scope="module")
def model():
    r = np.random.default_rng(3)
    x = (r.standard_normal((N, D)) / 2).astype(np.float32)
    w = r.standard_normal((N, T)).astype(np.float32)
    return x, w


@pytest.fixture()
def engine():
    eng = ServingEngine(max_batch=64, max_wait_ms=2.0, device="cpu")
    yield eng
    eng.shutdown()


@pytest.mark.parametrize("max_batch", [8, 9, 64, 100, 1024, 4096])
def test_bucket_ladder_matches_reference(max_batch):
    assert bucket_sizes(max_batch) == j_engine.bucket_sizes(max_batch)
    for q in (*range(0, 70), 100, 127, 128, 129, 1000, 1024, 1025, 4096, 5000):
        assert bucket_for(q, max_batch) == j_engine.bucket_for(q, max_batch)
    assert t_engine.MIN_BUCKET == j_engine.MIN_BUCKET
    assert (t_engine.ARTIFACT_CONFIG, t_engine.ARTIFACT_WEIGHTS) == (
        j_engine.ARTIFACT_CONFIG, j_engine.ARTIFACT_WEIGHTS)


@pytest.mark.parametrize("heads", [1, T])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_predict_from_config_matches_reference(model, name, heads):
    """The port's closure against JAX's on the same rows, weights and
    queries: 1, 7, 8, 9 and 300 rows, and 40 rows at max_batch 16 (chunks
    of 16, 16 and 8)."""
    x, w = model
    cfg = CONFIGS[name]
    w = w[:, 0].copy() if heads == 1 else w
    r = np.random.default_rng(11)
    queries = [(r.standard_normal((q, D)) / 2).astype(np.float32) for q in (1, 7, 8, 9, 300, 40)]
    if name == "precomputed":  # the Gram as rows, the queries as Gram rows
        queries = [_rbf_gram(q, x) for q in queries]
        x = _rbf_gram(x, x)
    prec = cfg.get("precision", "f32")
    for max_batch, qs in ((4096, queries[:5]), (16, queries[5:])):
        mine = make_krr_predict_fn_from_config(cfg, x, w, max_batch=max_batch, device="cpu")
        ref = j_predict_fn(cfg, x, w, max_batch=max_batch)
        for xq in qs:
            got = mine(xq)
            assert got.dtype == torch.float32 and got.device.type == "cpu"
            _close(got, ref(xq), prec)
    empty = mine(np.zeros((0, x.shape[1]), np.float32))
    assert tuple(empty.shape) == (0,) + w.shape[1:]


def test_reference_artifact_serves_on_port(tmp_path, model):
    """An artifact the JAX package saved loads in the port's engine, which
    predicts within tolerance of the JAX engine on it."""
    x, w = model
    path = j_engine.save_model_artifact(str(tmp_path / "m"), CFG_MULTI, x, w)
    cfg, x2, w2 = load_model_artifact(path)
    assert cfg == CFG_MULTI
    np.testing.assert_array_equal(x2, x)
    np.testing.assert_array_equal(w2, w)
    xq = np.random.default_rng(5).standard_normal((7, D)).astype(np.float32)
    with j_engine.ServingEngine(max_batch=8, max_wait_ms=1.0) as ref:
        ref.load_model("m", path)
        want = ref.predict("m", xq)
    with ServingEngine(max_batch=8, max_wait_ms=1.0, device="cpu") as eng:
        info = eng.load_model("m", path)
        got = eng.predict("m", xq)
    assert info["d"] == D and info["warmed_buckets"] == [8]
    _close(got, want)


def test_port_artifact_reads_in_reference(tmp_path, model):
    """An artifact the port saved from tensors reads in the JAX package as
    identical arrays and config."""
    x, w = model
    path = save_model_artifact(str(tmp_path / "m"), CFG_RBF, torch.from_numpy(x),
                               torch.from_numpy(w))
    cfg, x2, w2 = j_engine.load_model_artifact(path)
    assert cfg == CFG_RBF
    assert x2.dtype == np.float32 and w2.dtype == np.float32
    np.testing.assert_array_equal(x2, x)
    np.testing.assert_array_equal(w2, w)


def test_registry_survives_restart_via_artifacts_dir(tmp_path, model):
    x, w = model
    save_model_artifact(str(tmp_path / "alpha"), CFG_RBF, x, w)
    save_model_artifact(str(tmp_path / "beta"), CFG_MULTI, x, w)
    (tmp_path / "not_a_model").mkdir()
    (tmp_path / "stray.txt").write_text("x")
    xq = np.random.default_rng(5).standard_normal((7, D)).astype(np.float32)
    with ServingEngine(max_batch=16, max_wait_ms=1.0, device="cpu") as first:
        first.load_model("alpha", str(tmp_path / "alpha"))
        before = first.predict("alpha", xq)
    with ServingEngine(max_batch=16, max_wait_ms=1.0, device="cpu") as restored:
        info = restored.load_artifacts_dir(str(tmp_path))
        assert sorted(info) == ["alpha", "beta"] == restored.models()
        np.testing.assert_array_equal(restored.predict("alpha", xq), before)
        with pytest.raises(FileNotFoundError, match="no model artifacts"):
            restored.load_artifacts_dir(str(tmp_path / "not_a_model"))


@pytest.mark.parametrize("cfg", [CFG_RBF, CFG_MULTI], ids=["single-kernel", "multi-kernel"])
def test_threaded_clients_bitwise_equal_sequential(engine, model, cfg):
    """Threads submitting at once coalesce into shared bucket passes, yet
    every result is bitwise the sequential closure's."""
    x, w = model
    engine.register("m", cfg, x, w)
    predict = make_krr_predict_fn_from_config(cfg, x, w, max_batch=64, device="cpu")
    r = np.random.default_rng(7)
    queries = [r.standard_normal((int(r.integers(1, 20)), D)).astype(np.float32)
               for _ in range(40)]
    expected = [predict(q).numpy() for q in queries]
    results: list = [None] * len(queries)

    def client(lo, hi):
        for i in range(lo, hi):
            results[i] = engine.predict("m", queries[i])

    threads = [threading.Thread(target=client, args=(j * 10, (j + 1) * 10)) for j in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    engine.drain()
    for got, want in zip(results, expected):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    st = engine.stats("m")
    assert st["n_requests"] == len(queries)
    assert st["n_rows"] == sum(q.shape[0] for q in queries)


def test_many_clients_lose_no_request(model):
    """More client threads than cores, with a short switch interval: every
    request is served once, the in-flight count returns to 0 (drain ends)
    and the row count adds up: a lost update in the shared counters would
    break one of them."""
    import os

    x, w = model
    clients = 2 * (os.cpu_count() or 4)
    per = 10
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ServingEngine(max_batch=16, max_wait_ms=0.5, device="cpu") as eng:
            eng.register("m", CFG_RBF, x, w)
            futures: list = []
            lock = threading.Lock()

            def client(seed):
                r = np.random.default_rng(seed)
                mine = [eng.submit("m", r.standard_normal((int(r.integers(1, 5)), D))
                                   .astype(np.float32)) for _ in range(per)]
                with lock:
                    futures.extend(mine)

            threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
                assert not t.is_alive()
            eng.drain(timeout=30)
            rows = sum(f.result(timeout=10).shape[0] for f in futures)
            st = eng.stats("m")
    finally:
        sys.setswitchinterval(old)
    assert len(futures) == clients * per == st["n_requests"]
    assert st["n_rows"] == rows


def test_oversized_batch_chunks(engine, model):
    x, w = model
    engine.register("m", CFG_RBF, x, w)
    predict = make_krr_predict_fn_from_config(CFG_RBF, x, w, max_batch=64, device="cpu")
    xq = np.random.default_rng(5).standard_normal((150, D)).astype(np.float32)
    np.testing.assert_array_equal(engine.predict("m", xq), predict(xq).numpy())
    assert engine.stats("m")["occupancy"][64]["runs"] == 2


def test_empty_request_resolves_immediately(engine, model):
    x, w = model
    engine.register("m", CFG_RBF, x, w)
    fut = engine.submit("m", np.zeros((0, D), np.float32))
    out = fut.result(timeout=1)
    assert out.shape == (0, T) and out.dtype == np.float32
    assert fut.latency_ms == 0.0


def test_submit_validation(engine, model):
    x, w = model
    engine.register("m", CFG_RBF, x, w)
    with pytest.raises(KeyError, match="unknown model"):
        engine.submit("nope", np.zeros((2, D), np.float32))
    with pytest.raises(ValueError, match=r"\(q, 5\)"):
        engine.submit("m", np.zeros((2, D + 1), np.float32))
    engine.drain(timeout=5)  # neither error may leak an inflight slot


def test_unknown_precision_and_kernel_rejected(model):
    x, w = model
    with pytest.raises(ValueError, match="precision"):
        make_krr_predict_fn_from_config(dict(CFG_RBF, precision="f16"), x, w, device="cpu")
    with pytest.raises(ValueError, match="unknown kernel"):
        make_krr_predict_fn_from_config(dict(CFG_RBF, kernel="gauss"), x, w, device="cpu")


def test_lru_eviction_under_budget(model):
    x, w = model
    one = N * D * 4 + N * T * 4  # f32 x_train + w
    with ServingEngine(max_batch=16, max_wait_ms=1.0, max_bytes=2 * one + 16,
                       device="cpu") as eng:
        eng.register("a", CFG_RBF, x, w)
        eng.register("b", CFG_RBF, x, w)
        eng.predict("a", np.zeros((2, D), np.float32))  # 'a' now most recent
        info = eng.register("c", CFG_RBF, x, w)
        assert info["evicted"] == ["b"]
        assert eng.models() == ["a", "c"]
        assert eng.stats()["evictions"] == 1
    with ServingEngine(max_bytes=one // 2, device="cpu") as tiny:
        with pytest.raises(ValueError, match="budget"):
            tiny.register("big", CFG_RBF, x, w)


def test_hot_swap_under_load(model):
    """Requests submitted before a re-register finish on the old weights,
    later ones see the new."""
    x, w = model
    w2 = (w * 2.0).astype(np.float32)
    old = make_krr_predict_fn_from_config(CFG_RBF, x, w, max_batch=16, device="cpu")
    new = make_krr_predict_fn_from_config(CFG_RBF, x, w2, max_batch=16, device="cpu")
    r = np.random.default_rng(13)
    with ServingEngine(max_batch=16, max_wait_ms=50.0, device="cpu") as eng:
        info1 = eng.register("m", CFG_RBF, x, w)
        xq_old = r.standard_normal((3, D)).astype(np.float32)
        fut_old = eng.submit("m", xq_old)
        info2 = eng.register("m", CFG_RBF, x, w2)
        assert (info1["version"], info2["version"]) == (1, 2)
        xq_new = r.standard_normal((4, D)).astype(np.float32)
        out_new = eng.predict("m", xq_new)
        np.testing.assert_array_equal(fut_old.result(timeout=10), old(xq_old).numpy())
        np.testing.assert_array_equal(out_new, new(xq_new).numpy())


def test_stats_keys_match_reference(model):
    """register(), stats() and stats(name) carry the JAX engine's keys, and
    compile_cache_depth counts the bucket shapes launched."""
    x, w = model
    xq = np.ones((3, D), np.float32)
    got = {}
    for label, eng in (("jax", j_engine.ServingEngine(max_batch=16, max_wait_ms=1.0)),
                       ("port", ServingEngine(max_batch=16, max_wait_ms=1.0, device="cpu"))):
        with eng:
            info = eng.register("m", CFG_RBF, x, w)
            eng.predict("m", xq)
            got[label] = (info, eng.stats(), eng.prometheus_text())
    (j_info, j_st, j_prom), (info, st, prom) = got["jax"], got["port"]
    assert list(info) == list(j_info) and info["warmed_buckets"] == j_info["warmed_buckets"]
    assert list(st) == list(j_st)
    m, jm = st["models"]["m"], j_st["models"]["m"]
    assert list(m) == list(jm)
    assert m["compile_cache_depth"] == jm["compile_cache_depth"] == len(bucket_sizes(16))
    assert m["occupancy"] == jm["occupancy"] == {8: {"runs": 1, "rows": 3, "fill": 3 / 8}}
    assert m["bytes"] == jm["bytes"] and m["p50_ms"] > 0 and m["qps"] >= 0
    names = lambda text: [ln.split("{")[0].split(" ")[0] for ln in text.splitlines()]  # noqa: E731
    assert names(prom) == names(j_prom)


def test_shutdown_rejects_new_work(model):
    x, w = model
    eng = ServingEngine(max_batch=8, max_wait_ms=1.0, device="cpu")
    eng.register("m", CFG_RBF, x, w)
    eng.shutdown()
    assert not eng._worker.is_alive()
    with pytest.raises(RuntimeError, match="shut down"):
        eng.submit("m", np.zeros((1, D), np.float32))


def test_mesh_raises_not_implemented(engine, model):
    """A mesh binds a row-sharded operator; what has no row-sharded path
    (a precomputed Gram) or does not shard evenly is refused."""
    from repro_torch.distributed.meshes import SolverMesh
    from repro_torch.distributed.sharded_operator import ShardedKernelOperator

    x, w = model
    mesh = SolverMesh(["cpu"] * 2, shape=(2, 1))
    op, _ = bind_operator_from_config(CFG_RBF, x, w, mesh=mesh, device="cpu")
    assert isinstance(op, ShardedKernelOperator) and op.n_row_shards == 2
    with pytest.raises(ValueError, match="precomputed"):
        engine.register("m", {"kernel": "precomputed", "sigma": 1.0}, x, w, mesh=mesh)
    with pytest.raises(ValueError, match="do not shard evenly"):
        make_sharded_krr_predict_fn(SolverMesh(["cpu"] * 7, shape=(7, 1)), x, w)
    assert engine.models() == []


def test_cuda_engine_raises_without_card(model):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA engine runs (tests/test_torch_cuda.py)")
    x, w = model
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(max_batch=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_krr_predict_fn_from_config(CFG_RBF, x, w)


def test_serve_launcher_keys_match_reference(capsys, monkeypatch, tmp_path, model):
    """The port's krr_serve prints the JAX launcher's report keys, at every
    level, for the same artifact and traffic."""
    from repro.launch import krr_serve as j_launch
    from repro_torch.launch import krr_serve as t_launch

    x, w = model
    path = save_model_artifact(str(tmp_path / "m"), CFG_RBF, x, w)
    argv = ["--artifact", f"demo={path}", "--requests", "20", "--rate", "4000",
            "--max-batch", "16", "--max-wait-ms", "1", "--prometheus"]
    monkeypatch.setattr(sys, "argv", ["krr_serve", *argv, "--telemetry", str(tmp_path / "j.jsonl")])
    j_launch.main()
    j_report = json.loads(capsys.readouterr().out)
    report = t_launch.main([*argv, "--telemetry", str(tmp_path / "t.jsonl"), "--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == json.loads(json.dumps(report, default=float))
    assert list(report) == list(j_report) == ["loaded", "traffic", "stats", "prometheus",
                                              "telemetry"]
    assert list(report["loaded"]["demo"]) == list(j_report["loaded"]["demo"])
    assert list(report["traffic"]) == list(j_report["traffic"])
    assert list(report["stats"]) == list(j_report["stats"])
    assert list(report["stats"]["models"]["demo"]) == list(j_report["stats"]["models"]["demo"])
    assert report["stats"]["models"]["demo"]["n_requests"] == 20
    from repro_torch.obs import validate_jsonl

    assert validate_jsonl(str(tmp_path / "t.jsonl")).get("span", 0) >= 1
    meshed = t_launch.main([*argv, "--device", "cpu", "--mesh", "1x1"])
    capsys.readouterr()
    assert list(meshed) == list(report)[:-1]  # no --telemetry this time
    assert meshed["stats"]["models"]["demo"]["n_requests"] == 20


def test_tune_export_artifact_serves_in_reference(tmp_path):
    """krr_tune --export-artifact in the port writes an artifact the JAX
    engine loads and predicts from within tolerance of the port's engine."""
    from repro_torch.launch import krr_tune as t_launch

    art = tmp_path / "art"
    report = t_launch.main(["--n", "96", "--d", "3", "--n-test", "32", "--kernels",
                            "rbf,laplacian", "--n-weight-samples", "2", "--sigmas", "1.0",
                            "--lams", "1e-2", "--folds", "2", "--rank", "8", "--iters", "20",
                            "--refit-iters", "20", "--device", "cpu",
                            "--export-artifact", str(art)])
    keys = list(report)
    assert report["exported_artifact"] == str(art)
    assert keys.index("exported_artifact") == keys.index("refit") + 1
    cfg, x, w = j_engine.load_model_artifact(str(art))
    assert cfg == json.loads(json.dumps(report["best"]))
    assert x.shape == (96, 3) and w.shape == (96,)
    xq = np.random.default_rng(2).standard_normal((9, 3)).astype(np.float32)
    with j_engine.ServingEngine(max_batch=16, max_wait_ms=1.0) as ref:
        ref.load_model("m", str(art))
        want = ref.predict("m", xq)
    with ServingEngine(max_batch=16, max_wait_ms=1.0, device="cpu") as eng:
        eng.load_model("m", str(art))
        _close(eng.predict("m", xq), want)
