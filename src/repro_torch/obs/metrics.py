"""Process-global metrics registry: counters, gauges, log-bucket histograms
— the port's own copy of ``repro.obs.metrics`` (stdlib only), with the
roofline read from the H100 constants of ``repro_torch.roofline.hw``.

One registry (:data:`REGISTRY`) serves the whole stack — kernel-pair sweeps
(``repro_kernel_pairs_total``, fed by the tune engine's ``SweepCounter``),
tile FLOPs/bytes by dtype (:func:`record_tile_work`, the JAX package's cost
model, so the counters equal its counters for the same solve) and CG
iterations (``repro_cg_iterations_total``, fed by ``blocked_cg``).
Everything is stdlib-only and thread-safe (one lock per metric, one for
registration).

Three consumption paths:

  * :func:`snapshot` / :func:`diff` — flat ``{metric_key: value}`` dicts;
    benchmarks bracket a run with two snapshots and persist the diff.
  * :func:`prometheus_text` — the Prometheus text exposition format
    (``# TYPE`` headers, ``_bucket{le=...}``/``_sum``/``_count`` histogram
    series) for scraping or file export.
  * Direct handles — ``counter(name).inc()`` etc.; handles are get-or-create
    and re-fetching by (name, labels) returns the same object.

:class:`Histogram` uses FIXED log-spaced buckets (:func:`log_buckets`), so
memory is bounded no matter how many observations arrive.
Quantiles interpolate linearly inside the hit bucket.
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Any, Mapping

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
    "counter",
    "diff",
    "gauge",
    "histogram",
    "log_buckets",
    "prometheus_text",
    "record_tile_work",
    "roofline_time_s",
    "snapshot",
]


def log_buckets(lo: float, hi: float, per_decade: int = 3) -> tuple[float, ...]:
    """Log-spaced bucket upper bounds from ``lo`` to (at least) ``hi``.

    ``per_decade`` bounds per factor of 10; the ladder always includes ``hi``
    so the overflow bucket only catches true outliers.
    """
    if not (0 < lo < hi):
        raise ValueError(f"need 0 < lo < hi, got lo={lo}, hi={hi}")
    steps = int(math.ceil(math.log10(hi / lo) * per_decade))
    bounds = [lo * 10 ** (i / per_decade) for i in range(steps + 1)]
    bounds[-1] = max(bounds[-1], hi)
    return tuple(bounds)


#: default latency ladder (milliseconds): 10 us .. 100 s, 3 buckets/decade
LATENCY_BUCKETS_MS = log_buckets(1e-2, 1e5, per_decade=3)


def _label_key(labels: "Mapping[str, str] | None") -> tuple:
    return () if not labels else tuple(sorted(labels.items()))


def _series_name(name: str, label_key: tuple) -> str:
    if not label_key:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in label_key)
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonically increasing float counter (thread-safe)."""

    kind = "counter"
    __slots__ = ("name", "labels", "help", "_value", "_lock")

    def __init__(self, name: str, labels: tuple = (), help: str = ""):
        self.name, self.labels, self.help = name, labels, help
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, v: float = 1.0) -> None:
        """Add ``v`` (must be >= 0) to the counter."""
        if v < 0:
            raise ValueError(f"counter {self.name} cannot decrease (v={v})")
        with self._lock:
            self._value += v

    @property
    def value(self) -> float:
        """Current cumulative value."""
        return self._value


class Gauge:
    """Instantaneous value that can move both ways (thread-safe)."""

    kind = "gauge"
    __slots__ = ("name", "labels", "help", "_value", "_lock")

    def __init__(self, name: str, labels: tuple = (), help: str = ""):
        self.name, self.labels, self.help = name, labels, help
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        """Set the gauge to ``v``."""
        with self._lock:
            self._value = float(v)

    def inc(self, v: float = 1.0) -> None:
        """Add ``v`` to the gauge."""
        with self._lock:
            self._value += v

    def dec(self, v: float = 1.0) -> None:
        """Subtract ``v`` from the gauge."""
        self.inc(-v)

    @property
    def value(self) -> float:
        """Current value."""
        return self._value


class Histogram:
    """Fixed-bucket histogram with interpolated quantiles.

    Bucket bounds are set at construction (default :data:`LATENCY_BUCKETS_MS`)
    and never grow, so memory stays O(len(bounds)) regardless of observation
    count — the bounded replacement for keeping raw latency lists.  Usable
    standalone (the serving engine keeps one per model) or via the registry.
    """

    kind = "histogram"
    __slots__ = ("name", "labels", "help", "bounds", "_counts", "_sum",
                 "_count", "_lock")

    def __init__(self, name: str, labels: tuple = (), help: str = "",
                 buckets: "tuple[float, ...] | None" = None):
        self.name, self.labels, self.help = name, labels, help
        self.bounds = tuple(buckets if buckets is not None else LATENCY_BUCKETS_MS)
        if list(self.bounds) != sorted(self.bounds) or not self.bounds:
            raise ValueError("histogram buckets must be non-empty ascending")
        self._counts = [0] * (len(self.bounds) + 1)  # +1 overflow
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        """Record one observation."""
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        """Total observations recorded."""
        return self._count

    @property
    def sum(self) -> float:
        """Exact sum of all observations."""
        return self._sum

    @property
    def mean(self) -> float:
        """Exact mean (0.0 when empty)."""
        return self._sum / self._count if self._count else 0.0

    def quantile(self, q: float) -> float:
        """Estimated ``q``-quantile, interpolated inside the hit bucket.

        Exact sums/counts make the mean exact; quantiles are bucket-resolution
        estimates (overflow observations report the top bound).  0.0 when
        empty.
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        with self._lock:
            total = self._count
            counts = list(self._counts)
        if total == 0:
            return 0.0
        target = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            cum += c
            if cum >= target and c:
                if i == len(self.bounds):  # overflow bucket
                    return self.bounds[-1]
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i]
                frac = (target - (cum - c)) / c
                return lo + frac * (hi - lo)
        return self.bounds[-1]

    def reset(self) -> None:
        """Zero every bucket and the sum/count (long-running servers)."""
        with self._lock:
            self._counts = [0] * (len(self.bounds) + 1)
            self._sum = 0.0
            self._count = 0

    def bucket_counts(self) -> "list[tuple[float, int]]":
        """Cumulative (upper_bound, count) pairs, Prometheus ``le`` style
        (the final pair is ``(inf, total)``)."""
        with self._lock:
            counts = list(self._counts)
        out, cum = [], 0
        for b, c in zip(self.bounds, counts):
            cum += c
            out.append((b, cum))
        out.append((math.inf, cum + counts[-1]))
        return out


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Thread-safe get-or-create store of metrics keyed by (name, labels).

    The process-global instance is :data:`REGISTRY`; the module-level
    :func:`counter`/:func:`gauge`/:func:`histogram`/:func:`snapshot`/
    :func:`prometheus_text` helpers all operate on it.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[tuple[str, tuple], Any] = {}

    def _get(self, kind: str, name: str, labels, help, **kw):
        key = (name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = _KINDS[kind](name, labels=key[1], help=help, **kw)
                self._metrics[key] = m
            elif m.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {kind}"
                )
            return m

    def counter(self, name: str, labels=None, help: str = "") -> Counter:
        """Get-or-create a :class:`Counter`."""
        return self._get("counter", name, labels, help)

    def gauge(self, name: str, labels=None, help: str = "") -> Gauge:
        """Get-or-create a :class:`Gauge`."""
        return self._get("gauge", name, labels, help)

    def histogram(self, name: str, labels=None, help: str = "",
                  buckets=None) -> Histogram:
        """Get-or-create a :class:`Histogram` (fixed ``buckets``)."""
        return self._get("histogram", name, labels, help, buckets=buckets)

    def snapshot(self) -> dict[str, float]:
        """Flat ``{series_key: value}`` view of every registered metric.

        Counters/gauges map to their value; a histogram contributes
        ``<series>_count`` and ``<series>_sum`` entries.  Pair two snapshots
        with :func:`diff` to isolate one run's contribution.
        """
        with self._lock:
            items = list(self._metrics.items())
        out: dict[str, float] = {}
        for (name, lk), m in items:
            series = _series_name(name, lk)
            if m.kind == "histogram":
                out[series + "_count"] = float(m.count)
                out[series + "_sum"] = float(m.sum)
            else:
                out[series] = float(m.value)
        return out

    def prometheus_text(self) -> str:
        """Render every metric in the Prometheus text exposition format."""
        with self._lock:
            items = sorted(self._metrics.items())
        lines: list[str] = []
        seen_header: set[str] = set()
        for (name, lk), m in items:
            if name not in seen_header:
                seen_header.add(name)
                if m.help:
                    lines.append(f"# HELP {name} {m.help}")
                lines.append(f"# TYPE {name} {m.kind}")
            lines.extend(_render_series(name, lk, m))
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        """Drop every registered metric (tests only — handles held by
        callers keep working but are no longer exported)."""
        with self._lock:
            self._metrics.clear()


def _render_series(name: str, lk: tuple, m) -> list[str]:
    if m.kind != "histogram":
        return [f"{_series_name(name, lk)} {m.value}"]
    lines = []
    for ub, cum in m.bucket_counts():
        le = "+Inf" if math.isinf(ub) else repr(ub)
        lines.append(_series_name(name + "_bucket", lk + (("le", le),)) + f" {cum}")
    lines.append(f"{_series_name(name + '_sum', lk)} {m.sum}")
    lines.append(f"{_series_name(name + '_count', lk)} {m.count}")
    return lines


#: the process-global registry every subsystem reports into
REGISTRY = MetricsRegistry()


def counter(name: str, labels=None, help: str = "") -> Counter:
    """Get-or-create a counter in the global :data:`REGISTRY`."""
    return REGISTRY.counter(name, labels, help)


def gauge(name: str, labels=None, help: str = "") -> Gauge:
    """Get-or-create a gauge in the global :data:`REGISTRY`."""
    return REGISTRY.gauge(name, labels, help)


def histogram(name: str, labels=None, help: str = "", buckets=None) -> Histogram:
    """Get-or-create a histogram in the global :data:`REGISTRY`."""
    return REGISTRY.histogram(name, labels, help, buckets=buckets)


def snapshot() -> dict[str, float]:
    """Snapshot the global registry (see :meth:`MetricsRegistry.snapshot`)."""
    return REGISTRY.snapshot()


def prometheus_text() -> str:
    """Prometheus text exposition of the global registry."""
    return REGISTRY.prometheus_text()


def diff(before: dict[str, float], after: dict[str, float]) -> dict[str, float]:
    """Per-series delta between two :func:`snapshot` dicts.

    Series absent from ``before`` count from 0; unchanged series are dropped,
    so the result is exactly "what this run contributed" — the record
    benchmarks persist next to their wall-clock numbers.
    """
    out: dict[str, float] = {}
    for k, v in after.items():
        d = v - before.get(k, 0.0)
        if d != 0.0:
            out[k] = d
    return out


def record_tile_work(rows: int, cols: int, d: int, precision: str = "f32",
                     count: int = 1) -> None:
    """Account kernel-tile FLOPs and HBM bytes for a (rows, cols) K block.

    The JAX package's cost model, kept so the counters equal its counters
    for the same solve: the distance matmul is 2*d MACs per pair plus ~8
    flops of kernel map / matvec epilogue; bytes charge the two point sets
    and the RHS at the tile dtype's width plus an f32 accumulator row.
    Feeds the per-dtype ``repro_tile_flops_total`` /
    ``repro_tile_bytes_total`` counters that :func:`roofline_time_s`
    converts into H100-time lower bounds.
    """
    nbytes = 2 if precision == "bf16" else 4
    flops = float(rows) * float(cols) * (2 * d + 8) * count
    nbyte_total = (
        (float(rows) * d + float(cols) * d + cols) * nbytes + rows * 4.0
    ) * count
    counter("repro_tile_flops_total", labels={"dtype": precision},
            help="kernel-tile floating point operations").inc(flops)
    counter("repro_tile_bytes_total", labels={"dtype": precision},
            help="kernel-tile HBM bytes moved").inc(nbyte_total)


def roofline_time_s(flops: float, nbytes: float, precision: str = "f32") -> float:
    """Roofline lower bound (seconds) for doing ``flops`` work over
    ``nbytes`` of HBM traffic on one H100 — the max of the compute and
    memory times from ``repro_torch.roofline.hw`` (f32 at the CUDA-core
    rate, bf16 at the dense tensor-core rate)."""
    from repro_torch.roofline import hw  # lazy: obs stays stdlib-only otherwise

    peak = hw.PEAK_FLOPS_BF16 if precision == "bf16" else hw.PEAK_FLOPS_F32
    return max(flops / peak, nbytes / hw.HBM_BW)
