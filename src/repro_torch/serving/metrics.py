"""Process-local metrics registry of the port's serving stack (a copy of
``src/repro/serving/metrics.py``, which the port may not import).

One registry is the single source of truth for what the serving stack
reports: every counter, gauge and histogram that ``ServingObservability``
(``serving/tracing.py``) keeps, read as Prometheus text, as a JSON
snapshot, or windowed through ``snapshot()``/``delta()``.

* **Host-side, single-writer.**  The engine loop is the only writer, so
  updates are plain attribute writes — no locks.
* **Off the device path.**  Nothing here touches tensors; callers pass
  Python ints and floats they already had.
* **Windowable.**  Counters support ``snapshot()``/``delta()`` and
  histograms count-offset percentiles, so one lifetime registry serves
  per-pass windows without ever being reset.

``start_metrics_server`` serves the registry over HTTP (``/metrics`` and
``/metrics.json``) off the caller's asyncio loop.
"""
from __future__ import annotations

import json
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "start_metrics_server",
    "write_metrics_json",
]


LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: LabelKey) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class Counter:
    """Monotone float/int counter, optionally a labeled family."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._series: Dict[LabelKey, float] = {}

    def inc(self, amount: float = 1, **labels: str) -> None:
        key = _label_key(labels)
        self._series[key] = self._series.get(key, 0) + amount

    def value(self, **labels: str) -> float:
        return self._series.get(_label_key(labels), 0)

    def series(self) -> Dict[LabelKey, float]:
        return dict(self._series)


class Gauge:
    """Last-write-wins value, optionally a labeled family."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._series: Dict[LabelKey, float] = {}

    def set(self, value: float, **labels: str) -> None:
        self._series[_label_key(labels)] = value

    def set_max(self, value: float, **labels: str) -> None:
        key = _label_key(labels)
        if value > self._series.get(key, float("-inf")):
            self._series[key] = value

    def value(self, **labels: str) -> float:
        return self._series.get(_label_key(labels), 0)

    def series(self) -> Dict[LabelKey, float]:
        return dict(self._series)


# Default Prometheus-style bucket bounds for latency-ish histograms (ms).
_DEFAULT_BOUNDS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                   500.0, 1000.0, 2500.0, 5000.0)


class Histogram:
    """Cumulative-bucket histogram plus a bounded raw-sample reservoir.

    The buckets serve the Prometheus exposition; the reservoir serves
    exact windowed percentiles for bench arms and server summaries.
    ``percentile(q, skip=n)`` reports over observations *after* the
    first ``n`` — callers window by remembering ``count()`` at the start
    of their pass.  The reservoir is a deque capped at ``max_samples``;
    a skip that falls off the left edge degrades to "all retained
    samples", which is correct for any window newer than the cap.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 bounds: Iterable[float] = _DEFAULT_BOUNDS,
                 max_samples: int = 8192):
        self.name = name
        self.help = help
        self.bounds: Tuple[float, ...] = tuple(bounds)
        self.max_samples = max_samples
        self._count = 0
        self._sum = 0.0
        self._bucket_counts = [0] * (len(self.bounds) + 1)  # +Inf tail
        self._samples: deque = deque(maxlen=max_samples)

    def observe(self, value: float) -> None:
        self._count += 1
        self._sum += value
        for i, b in enumerate(self.bounds):
            if value <= b:
                self._bucket_counts[i] += 1
                break
        else:
            self._bucket_counts[-1] += 1
        self._samples.append(value)

    def count(self) -> int:
        return self._count

    def sum(self) -> float:
        return self._sum

    def mean(self, skip: int = 0) -> float:
        xs = self._window(skip)
        return sum(xs) / len(xs) if xs else 0.0

    def percentile(self, q: float, skip: int = 0) -> float:
        """q in [0, 1]; nearest-rank over the retained window."""
        xs = sorted(self._window(skip))
        if not xs:
            return 0.0
        return xs[min(len(xs) - 1, int(q * len(xs)))]

    def _window(self, skip: int) -> List[float]:
        # `skip` is a lifetime observation count; translate to an index
        # into the retained deque (older samples may have fallen off).
        dropped = self._count - len(self._samples)
        start = max(0, skip - dropped)
        if start == 0:
            return list(self._samples)
        return list(self._samples)[start:]

    def series(self) -> Dict[LabelKey, float]:  # uniform snapshot shape
        return {(): self._count}


class MetricsRegistry:
    """Get-or-create home for metric families, plus export views."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    # ------------------------------------------------------ creation --
    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "", **kw) -> Histogram:
        return self._get_or_create(Histogram, name, help, **kw)

    def _get_or_create(self, cls, name: str, help: str, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, help, **kw)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested {cls.kind}")
        return m

    # ------------------------------------------------------- reading --
    def get(self, name: str):
        return self._metrics.get(name)

    def value(self, name: str, **labels: str) -> float:
        m = self._metrics.get(name)
        if m is None:
            return 0
        if isinstance(m, Histogram):
            return m.count()
        return m.value(**labels)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def snapshot(self) -> Dict[str, dict]:
        """JSON-able point-in-time view of every family."""
        out: Dict[str, dict] = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if isinstance(m, Histogram):
                out[name] = {
                    "type": "histogram", "help": m.help,
                    "count": m.count(), "sum": m.sum(),
                    "buckets": {str(b): c for b, c in
                                zip(list(m.bounds) + ["+Inf"],
                                    m._bucket_counts)},
                }
            else:
                out[name] = {
                    "type": m.kind, "help": m.help,
                    "series": {_label_str(k) or "": v
                               for k, v in m.series().items()},
                }
        return out

    def delta(self, since: Dict[str, dict]) -> Dict[str, float]:
        """Flat {name: now - then} for unlabeled counters (and histogram
        counts), against a prior ``snapshot()``.  The bench families
        window every pass this way."""
        out: Dict[str, float] = {}
        for name, m in self._metrics.items():
            then = since.get(name)
            if isinstance(m, Histogram):
                prev = then["count"] if then else 0
                out[name] = m.count() - prev
            elif isinstance(m, Counter):
                prev = (then or {}).get("series", {}).get("", 0)
                out[name] = m.value() - prev
        return out

    def ratio(self, num: str, den: str,
              since: Optional[Dict[str, dict]] = None) -> float:
        """num/den over a window (or lifetime), 0 when den is 0."""
        if since is not None:
            d = self.delta(since)
            n, dn = d.get(num, 0), d.get(den, 0)
        else:
            n, dn = self.value(num), self.value(den)
        return n / dn if dn else 0.0

    # ------------------------------------------------------- export --
    def prometheus_text(self) -> str:
        """Prometheus text exposition format, families sorted by name."""
        lines: List[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            if isinstance(m, Histogram):
                cum = 0
                for b, c in zip(list(m.bounds) + ["+Inf"],
                                m._bucket_counts):
                    cum += c
                    lines.append(f'{name}_bucket{{le="{b}"}} {cum}')
                lines.append(f"{name}_sum {_fmt(m.sum())}")
                lines.append(f"{name}_count {m.count()}")
            else:
                for key, v in sorted(m.series().items()):
                    lines.append(f"{name}{_label_str(key)} {_fmt(v)}")
        return "\n".join(lines) + "\n"

    def json_text(self) -> str:
        return json.dumps(self.snapshot(), indent=2, sort_keys=True)


def _fmt(v: float) -> str:
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


def write_metrics_json(registry: MetricsRegistry, path: str) -> None:
    with open(path, "w") as f:
        f.write(registry.json_text())
        f.write("\n")


# ------------------------------------------------------- HTTP endpoint --

async def start_metrics_server(registry: MetricsRegistry,
                               port: int = 0, host: str = "127.0.0.1"):
    """Serve ``GET /metrics`` (Prometheus text) and ``GET /metrics.json``
    off the caller's asyncio loop.  Returns the ``asyncio.Server``; read
    the bound port from ``server.sockets[0].getsockname()[1]`` (handy
    with ``port=0`` in tests).  Deliberately minimal: one-shot HTTP/1.0
    responses, connection closed after each request — enough for a
    scraper, zero dependencies.
    """
    import asyncio

    async def handle(reader, writer):
        try:
            request = await reader.readline()
            parts = request.decode("latin-1").split()
            path = parts[1] if len(parts) >= 2 else "/"
            # drain headers
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
            if path.startswith("/metrics.json"):
                body = registry.json_text().encode()
                ctype = "application/json"
                status = "200 OK"
            elif path.startswith("/metrics"):
                body = registry.prometheus_text().encode()
                ctype = "text/plain; version=0.0.4"
                status = "200 OK"
            else:
                body = b"not found\n"
                ctype = "text/plain"
                status = "404 Not Found"
            writer.write(
                f"HTTP/1.0 {status}\r\nContent-Type: {ctype}\r\n"
                f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
            await writer.drain()
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    return await asyncio.start_server(handle, host=host, port=port)
