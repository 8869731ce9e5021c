"""Profiling readers: stage breakdowns and regression attribution (a
copy of mesh_tpu/obs/prof.py).

The backing store is whatever latency evidence is on disk —

- a ledger JSONL dump (``LatencyLedger.dump_jsonl``): one request row
  per line with exact per-stage seconds;
- a serve-stats sink (``QueryService.write_stats``): the cumulative
  ``mesh_tpu_request_stage_seconds{stage,backend}`` histogram, quantiles
  estimated from buckets;
- a flight-recorder incident dump (schema >= 2): the ledger tail the
  recorder froze at trigger time;
- a bench JSON (final or ``bench_partial.json``): the ``stage_stats``
  block a stage record embeds.

``load()`` normalizes all four into one shape; ``diff()`` attributes
p50/p99 deltas between two loads to named stages — the answer perf CI
wants is "p99 regressed because DISPATCH got slower", not "a band
failed".  ``perfcheck``'s attribution lines (obs/perf.py) sit on these
functions.

Import cost: stdlib plus the stdlib-only obs siblings (ledger/series) —
safe to run while the card is wedged.
"""

import json
import math

from .ledger import LEDGER_SCHEMA, LEDGER_STAGES
from .series import quantile_from_cumulative

__all__ = [
    "ProfError", "load", "stats_from_records", "top_lines", "diff",
    "attribution",
    "load_rows", "load_request_tails", "request_trace",
    "render_request_trace", "fleet_attribution",
]

#: histogram series the sink/bench paths read
STAGE_SERIES = "mesh_tpu_request_stage_seconds"


class ProfError(ValueError):
    """Unreadable/unrecognized profile input."""


def _rank(sorted_vals, q):
    """Nearest-rank quantile of an ascending list (exact, no
    interpolation — these are real per-request samples)."""
    if not sorted_vals:
        return 0.0
    idx = max(int(math.ceil(q * len(sorted_vals))) - 1, 0)
    return sorted_vals[min(idx, len(sorted_vals) - 1)]


def stats_from_records(rows):
    """Normalize ledger rows (dicts with a ``stages`` seconds map) into
    the common shape: per-stage {count, p50_s, p99_s, mean_s}, the
    per-request total quantiles, and a backend histogram."""
    per_stage, totals, backends = {}, [], {}
    for row in rows:
        schema = row.get("schema")
        if schema is not None:
            # dump_jsonl stamps each line with its row-format version;
            # accept anything up to ours, refuse rows from the future
            try:
                schema = int(schema)
            except (TypeError, ValueError):
                raise ProfError("unparseable ledger row schema %r"
                                % (schema,))
            if schema > LEDGER_SCHEMA:
                raise ProfError(
                    "ledger row schema %d is newer than supported %d — "
                    "upgrade before profiling this dump"
                    % (schema, LEDGER_SCHEMA))
        stages = row.get("stages")
        if not isinstance(stages, dict):
            continue
        total = row.get("total_s")
        totals.append(float(total) if total is not None
                      else sum(stages.values()))
        backend = row.get("backend") or "none"
        backends[backend] = backends.get(backend, 0) + 1
        for stage, seconds in stages.items():
            per_stage.setdefault(stage, []).append(float(seconds))
    if not totals:
        raise ProfError("no request rows with a 'stages' map")
    stage_stats = {}
    for stage, vals in per_stage.items():
        vals.sort()
        stage_stats[stage] = {
            "count": len(vals),
            "p50_s": _rank(vals, 0.50),
            "p99_s": _rank(vals, 0.99),
            "mean_s": sum(vals) / len(vals),
        }
    totals.sort()
    return {
        "stages": stage_stats,
        "total": {"count": len(totals), "p50_s": _rank(totals, 0.50),
                  "p99_s": _rank(totals, 0.99)},
        "backends": backends,
    }


def _stats_from_hist(entry):
    """The common shape from a cumulative histogram snapshot entry of
    ``mesh_tpu_request_stage_seconds`` (quantiles estimated from bucket
    interpolation; no per-request totals exist at this granularity)."""
    per_stage, backends = {}, {}
    for series in entry.get("series", []):
        labels = series.get("labels", {})
        stage = labels.get("stage", "?")
        backend = labels.get("backend", "none")
        buckets = series.get("buckets", [])
        count = series.get("count", 0)
        backends[backend] = backends.get(backend, 0) + count
        agg = per_stage.get(stage)
        if agg is None:
            per_stage[stage] = {
                "count": count, "sum": series.get("sum", 0.0),
                "buckets": [[b, c] for b, c in buckets],
            }
        else:
            agg["count"] += count
            agg["sum"] += series.get("sum", 0.0)
            for i, (_, c) in enumerate(buckets):
                agg["buckets"][i][1] += c
    if not per_stage:
        raise ProfError("no %s series in the sink" % STAGE_SERIES)
    stage_stats = {}
    for stage, agg in per_stage.items():
        stage_stats[stage] = {
            "count": agg["count"],
            "p50_s": quantile_from_cumulative(agg["buckets"], 0.50) or 0.0,
            "p99_s": quantile_from_cumulative(agg["buckets"], 0.99) or 0.0,
            "mean_s": (agg["sum"] / agg["count"]) if agg["count"] else 0.0,
        }
    return {"stages": stage_stats, "total": None, "backends": backends}


def _from_bench_doc(doc):
    """The newest embedded ``stage_stats`` block in a bench JSON (final
    ``{"records": [...]}`` or staged ``bench_partial.json``), or None."""
    records = list(doc.get("records") or [])
    for stage in (doc.get("stages") or {}).values():
        rec = (stage or {}).get("record")
        if rec:
            records.append(rec)
    for rec in reversed(records):
        block = rec.get("stage_stats") if isinstance(rec, dict) else None
        if block:
            return {"stages": block, "total": rec.get("stage_total"),
                    "backends": rec.get("stage_backends") or {}}
    return None


def load(path):
    """Read any supported profile evidence file into the common shape
    (see module docstring for the four formats).  Raises
    :class:`ProfError` on unreadable/unrecognized input."""
    try:
        with open(path) as fh:
            text = fh.read()
    except OSError as e:
        raise ProfError("cannot read %s: %s" % (path, e))
    doc = None
    try:
        doc = json.loads(text)
    except ValueError:
        pass
    if isinstance(doc, dict):
        if doc.get("kind") == "incident":
            return stats_from_records(doc.get("ledger") or [])
        if "stage_stats" in doc:
            return {"stages": doc["stage_stats"],
                    "total": doc.get("stage_total"),
                    "backends": doc.get("stage_backends") or {}}
        bench = _from_bench_doc(doc)
        if bench is not None:
            return bench
        metrics = doc.get("metrics", doc)
        entry = metrics.get(STAGE_SERIES)
        if entry:
            return _stats_from_hist(entry)
        raise ProfError(
            "%s: no ledger rows, %s series, or stage_stats block"
            % (path, STAGE_SERIES))
    if isinstance(doc, list):
        return stats_from_records(doc)
    # JSON lines: one ledger row per line
    rows = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            row = json.loads(line)
        except ValueError:
            raise ProfError("%s: neither JSON nor JSONL" % path)
        if isinstance(row, dict):
            rows.append(row)
    return stats_from_records(rows)


def _stage_order(*stats):
    """Ledger stage order first, then any unknown stages alphabetically."""
    seen = set()
    for s in stats:
        seen.update(s.get("stages", {}))
    ordered = [s for s in LEDGER_STAGES if s in seen]
    ordered += sorted(seen - set(LEDGER_STAGES))
    return ordered


def _ms(seconds):
    return "%.3f" % (1e3 * seconds)


def top_lines(stats):
    """Human-readable stage/backend breakdown of one load()."""
    lines = ["stage        count      p50 ms      p99 ms     mean ms"]
    for stage in _stage_order(stats):
        row = stats["stages"][stage]
        lines.append("%-10s %7d %11s %11s %11s" % (
            stage, row["count"], _ms(row["p50_s"]), _ms(row["p99_s"]),
            _ms(row["mean_s"])))
    total = stats.get("total")
    if total:
        lines.append("%-10s %7d %11s %11s %11s" % (
            "TOTAL", total["count"], _ms(total["p50_s"]),
            _ms(total["p99_s"]), ""))
    backends = stats.get("backends") or {}
    if backends:
        lines.append("backends: " + ", ".join(
            "%s=%d" % (b, n) for b, n in sorted(backends.items())))
    return lines


def _totals(stats, q_key):
    """The comparable total for one quantile: per-request totals when
    the source has them, else the sum of per-stage quantiles (flagged
    by the caller as a stage-sum estimate)."""
    total = stats.get("total")
    if total:
        return total[q_key], True
    return sum(r[q_key] for r in stats["stages"].values()), False


def attribution(a, b, q_key="p99_s"):
    """Per-stage deltas (b - a) for one quantile, largest first:
    [(stage, delta_s), ...] over the union of stages (a stage absent on
    one side contributes its other side's value)."""
    deltas = []
    for stage in _stage_order(a, b):
        va = a["stages"].get(stage, {}).get(q_key, 0.0)
        vb = b["stages"].get(stage, {}).get(q_key, 0.0)
        deltas.append((stage, vb - va))
    deltas.sort(key=lambda kv: -kv[1])
    return deltas


def diff(a, b, tol=0.2, min_delta_s=1e-4):
    """Attribute the latency delta between two loads to named stages.

    Returns ``(rc, lines)``: rc 1 when the total p50 OR p99 of ``b``
    regressed past ``a`` by more than ``tol`` (relative) AND
    ``min_delta_s`` (absolute — sub-100 us noise never fails a gate),
    with the top line naming the dominating stage; rc 0 otherwise.
    """
    lines = ["stage            A p50      B p50     A p99      B p99   "
             "d p99 ms"]
    for stage in _stage_order(a, b):
        ra = a["stages"].get(stage)
        rb = b["stages"].get(stage)
        pa50 = ra["p50_s"] if ra else 0.0
        pb50 = rb["p50_s"] if rb else 0.0
        pa99 = ra["p99_s"] if ra else 0.0
        pb99 = rb["p99_s"] if rb else 0.0
        lines.append("%-10s %10s %10s %10s %10s %10s" % (
            stage, _ms(pa50), _ms(pb50), _ms(pa99), _ms(pb99),
            "%+.3f" % (1e3 * (pb99 - pa99))))
    rc = 0
    for q_key, label in (("p50_s", "p50"), ("p99_s", "p99")):
        ta, exact_a = _totals(a, q_key)
        tb, exact_b = _totals(b, q_key)
        exact = exact_a and exact_b
        kind = "total" if exact else "stage-sum"
        delta = tb - ta
        pct = (delta / ta) if ta > 0 else (float("inf") if delta > 0 else 0.0)
        regressed = delta > min_delta_s and pct > tol
        deltas = attribution(a, b, q_key)
        top_stage, top_delta = deltas[0] if deltas else ("?", 0.0)
        if regressed:
            rc = 1
            share = (top_delta / delta) if delta > 0 else 0.0
            lines.append(
                "FAIL %s %s regressed %s -> %s ms (%+.1f%%, tol %.0f%%) — "
                "stage '%s' accounts for %+.3f ms (%.0f%% of the delta)"
                % (label, kind, _ms(ta), _ms(tb), 1e2 * pct, 1e2 * tol,
                   top_stage, 1e3 * top_delta, 1e2 * share))
        else:
            lines.append("ok   %s %s %s -> %s ms (%+.1f%%)"
                         % (label, kind, _ms(ta), _ms(tb),
                            1e2 * pct if ta > 0 else 0.0))
    return rc, lines


# ---------------------------------------------------------------------------
# request identity: one request's joined evidence + fleet-wide attribution
#
# Everything below keys on the ``request_id`` the router/service mints
# (obs/context.py) and the ledger stamps into each row's meta — the join
# key that connects a fleet histogram exemplar, a ledger row, a retained
# span tree, and the router hop that placed the request.


def _read_doc(path):
    try:
        with open(path) as fh:
            text = fh.read()
    except OSError as e:
        raise ProfError("cannot read %s: %s" % (path, e))
    try:
        return json.loads(text), text
    except ValueError:
        return None, text


def load_rows(path):
    """Raw ledger rows from a row-based source — a JSONL dump, a JSON
    row list, or an incident's frozen ledger tail.  Returns ``None``
    for aggregate-only sources (serve-stats sink, bench stage_stats);
    raises :class:`ProfError` only on unreadable files."""
    doc, text = _read_doc(path)
    if isinstance(doc, dict):
        if doc.get("kind") == "incident":
            return [r for r in (doc.get("ledger") or [])
                    if isinstance(r, dict)]
        return None
    if isinstance(doc, list):
        return [r for r in doc if isinstance(r, dict)]
    rows = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            row = json.loads(line)
        except ValueError:
            return None
        if isinstance(row, dict):
            rows.append(row)
    return rows or None


def load_request_tails(path):
    """Retained request tails (row + span tree) from an incident dump
    (schema >= 4, the ``requests`` key), or ``None`` when the source
    carries no tail."""
    doc, _text = _read_doc(path)
    if isinstance(doc, dict) and doc.get("kind") == "incident":
        tails = doc.get("requests")
        if isinstance(tails, list):
            return [t for t in tails if isinstance(t, dict)]
    return None


def request_trace(request_id, paths=(), tail=None):
    """Join one request's evidence by its ``request_id`` across disk
    sources (ledger dumps / incident dumps) and — when ``tail`` is
    given (a :class:`~mesh_tpu_torch.obs.context.TraceTail`) — the live
    in-process tail buffer.

    Returns ``{"request_id", "rows", "spans", "retained", "sources"}``
    with ``rows`` the matching ledger rows (fleet: one per replica hop
    that admitted it) and ``spans`` the retained span tree (or ``[]``
    if the request was not tail-sampled).  Raises :class:`ProfError`
    when nothing matches anywhere.
    """
    rid = str(request_id)
    rows, spans, retained, sources = [], [], None, []

    def _norm(row):
        # dump_jsonl stamps rows with schema; incident/live copies of
        # the SAME close are unstamped — normalize so overlapping
        # sources collapse (fleet hops still differ in replica/seq)
        return {k: v for k, v in row.items() if k != "schema"}

    def _add_row(row):
        if isinstance(row, dict) and _norm(row) not in map(_norm, rows):
            rows.append(row)

    for path in paths:
        hit = False
        for row in load_rows(path) or ():
            if row.get("request_id") == rid:
                _add_row(row)
                hit = True
        for entry in load_request_tails(path) or ():
            if entry.get("request_id") == rid:
                if not spans:
                    spans = list(entry.get("spans") or [])
                    retained = entry.get("retained")
                _add_row(entry.get("row"))
                hit = True
        if hit:
            sources.append(str(path))
    if tail is not None:
        entry = tail.lookup(rid)
        if entry is not None:
            if not spans:
                spans = list(entry.get("spans") or [])
                retained = entry.get("retained")
            _add_row(entry.get("row"))
            sources.append("<live tail>")
    if not rows and not spans:
        raise ProfError(
            "request %s not found in %d source(s) — it may have aged "
            "out of the ledger ring, or was never tail-sampled "
            "(only deadline-miss/error/spilled and reservoir-slow "
            "requests keep their span tree)" % (rid, len(paths)))
    return {"request_id": rid, "rows": rows, "spans": spans,
            "retained": retained, "sources": sources}


def render_request_trace(trace):
    """Human-readable story of one request: identity/routing header,
    per-hop ledger stage timings, and the retained span tree."""
    from .export import render_tree

    lines = ["request %s" % trace["request_id"]]
    for row in trace["rows"]:
        ident = []
        for key in ("tenant", "seq", "session_id", "routing_key",
                    "replica", "outcome"):
            if row.get(key) is not None:
                ident.append("%s=%s" % (key, row[key]))
        if row.get("spilled"):
            ident.append("SPILLED (router hop: primary rejected "
                         "queue_full)")
        lines.append("  " + " ".join(ident))
        stages = row.get("stages") or {}
        for stage in [s for s in LEDGER_STAGES if s in stages] + sorted(
                set(stages) - set(LEDGER_STAGES)):
            lines.append("    %-10s %10s ms" % (stage, _ms(stages[stage])))
        if row.get("total_s") is not None:
            lines.append("    %-10s %10s ms" % ("TOTAL", _ms(row["total_s"])))
    if not trace["rows"]:
        lines.append("  (no ledger row found — span tree only)")
    if trace["spans"]:
        lines.append("retained span tree (%s):"
                     % (trace.get("retained") or "tail"))
        for ln in render_tree(trace["spans"]).splitlines():
            lines.append("  " + ln)
    else:
        lines.append("no retained span tree (request was not "
                     "tail-sampled)")
    if trace["sources"]:
        lines.append("sources: " + ", ".join(trace["sources"]))
    return lines


def fleet_attribution(named_stats, q_key="p99_s"):
    """Cross-replica latency attribution: which (replica, stage) owns
    the fleet tail.

    ``named_stats`` is ``[(replica_name, load()-shape stats), ...]`` —
    one entry per replica's ledger dump or serve-stats sink.  Returns
    ``(rc, lines)``: a per-replica quantile table, each laggard's
    delta vs the fastest replica attributed to its dominating stage,
    and a final fleet-p99 attribution line.  rc 0 always (this is a
    reader, not a gate); raises :class:`ProfError` on empty input.
    """
    if not named_stats:
        raise ProfError("fleet attribution needs at least one replica "
                        "profile")
    label = q_key.replace("_s", "")
    per = []
    for name, stats in named_stats:
        total, exact = _totals(stats, q_key)
        per.append((name, stats, total, exact))
    per.sort(key=lambda t: t[2])
    best_name, best_stats, best_total, _ = per[0]
    lines = ["replica            %s ms   d vs best   dominating stage"
             % label]
    worst = None
    for name, stats, total, exact in per:
        delta = total - best_total
        if name == best_name:
            lines.append("%-16s %9s %11s   (fastest%s)"
                         % (name, _ms(total), "-",
                            "" if exact else ", stage-sum"))
            continue
        deltas = attribution(best_stats, stats, q_key)
        top_stage, top_delta = deltas[0] if deltas else ("?", 0.0)
        lines.append("%-16s %9s %+10.3f   %s (%+.3f ms)"
                     % (name, _ms(total), 1e3 * delta, top_stage,
                        1e3 * top_delta))
        if worst is None or total > worst[2]:
            worst = (name, top_stage, total, delta, top_delta)
    if worst is not None:
        name, stage, total, delta, top_delta = worst
        lines.append(
            "fleet %s is set by replica '%s' (%s ms): stage '%s' "
            "accounts for %+.3f ms of its %+.3f ms gap to '%s'"
            % (label, name, _ms(total), stage, 1e3 * top_delta,
               1e3 * delta, best_name))
    else:
        lines.append("fleet %s: single replica '%s' at %s ms"
                     % (label, best_name, _ms(best_total)))
    return 0, lines
