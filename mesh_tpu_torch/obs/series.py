"""Windowed time-series over the metrics registry (a copy of
mesh_tpu/obs/series.py).

The registry (obs/metrics.py) is cumulative-since-process-start: perfect
for Prometheus scrapes, useless on its own for "what is the p99 over the
last minute" or "how fast is the error budget burning NOW".  This module
adds the windowed view both consumers need:

- :class:`SampleRing` — a bounded history of cumulative samples with
  window-boundary deltas.  This is the *one* implementation of the
  "difference of the samples bracketing the window" arithmetic: the SLO
  monitor's burn rates (obs/slo.py) read their windowed (good, total)
  deltas from it instead of carrying their own ad-hoc loop.
- :class:`WindowedSeries` — a ring of fixed-resolution (1 s by default)
  registry snapshots with rate / delta / percentile queries over any
  trailing window, including histogram quantiles by bucket-delta
  interpolation.  This is what turns the per-request
  ``mesh_tpu_request_stage_seconds{stage,backend}`` histogram
  (obs/ledger.py) into "queue p99 over the last 60 s", and the p99 of a
  hold-out window that the tuner's shadow A/B guard (obs/controller.py)
  judges a knob change by.

Every clock read goes through the injected ``clock`` (default
``obs.clock.monotonic``) so tests drive windows deterministically with a
fake clock.  Stdlib-only.
"""

import threading
from collections import deque

from .clock import monotonic
from .metrics import REGISTRY

__all__ = ["SampleRing", "WindowedSeries", "SERIES", "get_series",
           "quantile_from_cumulative"]


def quantile_from_cumulative(buckets, q):
    """The q-quantile (``q`` in [0, 1]) from a cumulative bucket list
    ``[[bound, cum], ..., ["+Inf", total]]`` by linear interpolation
    inside the landing bucket; observations past the largest finite
    bound report that bound.  None with zero observations."""
    if not buckets:
        return None
    total = buckets[-1][1]
    if total <= 0:
        return None
    rank = max(float(q), 0.0) * total
    lower, prev_cum = 0.0, 0
    for bound, cum in buckets:
        d = cum - prev_cum
        if cum >= rank and d > 0:
            if bound == "+Inf":
                return lower            # best finite estimate
            bound = float(bound)
            frac = (rank - prev_cum) / d
            return lower + (bound - lower) * max(frac, 0.0)
        prev_cum = cum
        if bound != "+Inf":
            lower = float(bound)
    return lower


class SampleRing(object):
    """Bounded history of cumulative ``(t, v0, v1, ...)`` samples.

    ``append()`` records one cumulative observation; ``deltas()`` answers
    "how much did each value grow over the trailing window" by
    differencing the newest sample against the window boundary — the
    newest sample at/before ``now - window_s``, falling back to the
    oldest retained sample when history is shorter than the window (the
    SLO monitor's burn-rate semantics, now shared).
    """

    __slots__ = ("_samples",)

    def __init__(self, history=1024, samples=None):
        self._samples = deque(samples or (), maxlen=int(history))

    def __len__(self):
        return len(self._samples)

    def append(self, t, values):
        """Record one cumulative sample: ``values`` is a tuple/list of
        monotonically growing numbers observed at time ``t``."""
        self._samples.append((float(t),) + tuple(values))

    def latest(self):
        """The newest ``(t, v0, ...)`` sample (raises IndexError when
        empty)."""
        return self._samples[-1]

    def boundary(self, start_t):
        """Newest sample at/before ``start_t`` (window baseline); falls
        back to the oldest retained sample when history is shorter than
        the window."""
        boundary = self._samples[0]
        for sample in self._samples:
            if sample[0] <= start_t:
                boundary = sample
            else:
                break
        return boundary

    def deltas(self, window_s, now):
        """Per-value growth over ``[now - window_s, now]`` as a tuple
        (newest minus boundary); all-zeros when fewer than one sample."""
        if not self._samples:
            return ()
        base = self.boundary(now - float(window_s))
        last = self._samples[-1]
        return tuple(last[i] - base[i] for i in range(1, len(last)))

    def copy(self):
        """A snapshot copy safe to query while the original keeps
        appending (same bounded capacity)."""
        return SampleRing(history=self._samples.maxlen,
                          samples=list(self._samples))


# ---------------------------------------------------------------------------
# windowed registry snapshots


def _match(labels, want):
    """True when the series' label dict contains every (k, v) in the
    ``want`` filter (values compared as strings, the registry's canonical
    form)."""
    if not want:
        return True
    for key, value in want.items():
        if labels.get(key) != str(value):
            return False
    return True


def _counter_value(entry, want):
    """Summed value of every matching series in a counter/gauge
    snapshot entry."""
    total = 0
    for series in entry.get("series", []):
        if _match(series.get("labels", {}), want):
            total += series.get("value", 0)
    return total


def _hist_state(entry, want):
    """(count, sum, cumulative-bucket list) summed over every matching
    series of a histogram snapshot entry; None when nothing matches."""
    count, total, buckets = 0, 0.0, None
    for series in entry.get("series", []):
        if not _match(series.get("labels", {}), want):
            continue
        count += series.get("count", 0)
        total += series.get("sum", 0.0)
        cum = series.get("buckets", [])
        if buckets is None:
            buckets = [[bound, c] for bound, c in cum]
        else:
            for i, (_, c) in enumerate(cum):
                buckets[i][1] += c
    if buckets is None:
        return None
    return count, total, buckets


class WindowedSeries(object):
    """Ring of fixed-resolution cumulative registry snapshots.

    ``tick()`` files the current registry state into the window whose
    start covers ``now`` (one snapshot per resolution window; a second
    tick inside the same window refreshes it).  Queries difference the
    newest snapshot against the one bracketing the requested trailing
    window — the same boundary semantics as :class:`SampleRing`.
    Thread-safe; capacity-bounded (default 120 windows of 1 s = two
    minutes of history).
    """

    def __init__(self, registry=None, resolution_s=1.0, capacity=120,
                 clock=monotonic):
        self._registry = registry if registry is not None else REGISTRY
        self.resolution_s = float(resolution_s)
        self._ring = deque(maxlen=int(capacity))    # (window_start, snapshot)
        self._clock = clock
        self._lock = threading.Lock()

    # -- sampling ------------------------------------------------------

    def tick(self, now=None):
        """Snapshot the registry into the current window; returns the
        window start time."""
        now = self._clock() if now is None else float(now)
        start = int(now / self.resolution_s) * self.resolution_s
        snap = self._registry.snapshot()
        with self._lock:
            if self._ring and self._ring[-1][0] == start:
                self._ring[-1] = (start, snap)
            else:
                self._ring.append((start, snap))
        return start

    def clear(self):
        with self._lock:
            self._ring.clear()

    def windows(self):
        """Retained (window_start, snapshot) pairs, oldest first."""
        with self._lock:
            return list(self._ring)

    def _bracket(self, window_s, now):
        """(baseline snapshot or None, newest snapshot) for the trailing
        window; (None, None) with no history."""
        with self._lock:
            ring = list(self._ring)
        if not ring:
            return None, None
        if now is None:
            now = ring[-1][0]
        start_t = float(now) - float(window_s)
        baseline = None
        for t, snap in ring:
            if t <= start_t:
                baseline = snap
            else:
                break
        return baseline, ring[-1][1]

    # -- queries -------------------------------------------------------

    def delta(self, name, window_s=60.0, now=None, labels=None):
        """Counter growth of ``name`` over the trailing window (summed
        over series matching the ``labels`` filter).  The oldest retained
        window is the baseline when history is shorter than the window;
        0 with no history."""
        base, last = self._bracket(window_s, now)
        if last is None:
            return 0
        entry = last.get(name)
        if entry is None:
            return 0
        value = _counter_value(entry, labels)
        if base is not None and name in base:
            value -= _counter_value(base[name], labels)
        return value

    def rate(self, name, window_s=60.0, now=None, labels=None):
        """Counter growth per second over the trailing window."""
        return self.delta(name, window_s, now, labels) / float(window_s)

    def percentile(self, name, q, window_s=60.0, now=None, labels=None):
        """The q-quantile (``q`` in [0, 1]) of histogram ``name`` over
        the trailing window, from bucket-count deltas with linear
        interpolation inside the landing bucket (Prometheus
        ``histogram_quantile`` semantics; observations past the largest
        finite bound report that bound).  None with no observations in
        the window."""
        base, last = self._bracket(window_s, now)
        if last is None or name not in last:
            return None
        state = _hist_state(last[name], labels)
        if state is None:
            return None
        _, _, buckets = state
        base_state = (_hist_state(base[name], labels)
                      if base is not None and name in base else None)
        windowed = []
        for i, (bound, cum_new) in enumerate(buckets):
            cum_old = base_state[2][i][1] if base_state is not None else 0
            windowed.append([bound, cum_new - cum_old])
        return quantile_from_cumulative(windowed, q)

    def _at(self, t):
        """Newest snapshot at/before ``t`` (None when history starts
        later than ``t`` or is empty)."""
        with self._lock:
            ring = list(self._ring)
        snap = None
        for window_t, s in ring:
            if window_t <= float(t):
                snap = s
            else:
                break
        return snap

    def window_percentile(self, name, q, start_t, end_t, labels=None):
        """The q-quantile of histogram ``name`` over the ABSOLUTE window
        ``[start_t, end_t]`` — unlike :meth:`percentile`, the window end
        need not be "now", so the shadow A/B guard (obs/controller.py)
        can read its before-change hold-out window after the fact.  None
        with no snapshot at/before ``end_t`` or no observations in the
        window."""
        last = self._at(end_t)
        if last is None or name not in last:
            return None
        state = _hist_state(last[name], labels)
        if state is None:
            return None
        base = self._at(start_t)
        base_state = (_hist_state(base[name], labels)
                      if base is not None and name in base else None)
        windowed = []
        for i, (bound, cum_new) in enumerate(state[2]):
            cum_old = base_state[2][i][1] if base_state is not None else 0
            windowed.append([bound, cum_new - cum_old])
        return quantile_from_cumulative(windowed, q)

    def stage_breakdown(self, window_s=60.0, now=None,
                        name="mesh_tpu_request_stage_seconds"):
        """Per-(stage, backend) {count, p50_s, p99_s} over the trailing
        window of the request-stage histogram (the live view behind the
        reference's ``mesh-tpu prof top``)."""
        base, last = self._bracket(window_s, now)
        if last is None or name not in last:
            return {}
        label_sets = []
        for series in last[name].get("series", []):
            labels = series.get("labels", {})
            key = (labels.get("stage", "?"), labels.get("backend", "?"))
            if key not in label_sets:
                label_sets.append(key)
        out = {}
        for stage, backend in label_sets:
            want = {"stage": stage, "backend": backend}
            state = _hist_state(last[name], want)
            n = state[0] if state else 0
            if base is not None and name in base:
                base_st = _hist_state(base[name], want)
                if base_st:
                    n -= base_st[0]
            if n <= 0:
                continue
            out[(stage, backend)] = {
                "count": n,
                "p50_s": self.percentile(name, 0.50, window_s, now, want),
                "p99_s": self.percentile(name, 0.99, window_s, now, want),
            }
        return out


#: the process-wide windowed view (periodic loops — the SLO monitor's
#: sampling thread — call SERIES.tick(); queries are always safe)
SERIES = WindowedSeries()


def get_series():
    """The process-wide WindowedSeries (one place to monkeypatch)."""
    return SERIES
