"""Exporters: JSON-lines dumps, Prometheus text, and span-tree rendering
(a copy of mesh_tpu/obs/export.py).

Three consumers, three formats:

- ``write_jsonl(path)`` — every buffered span as one JSON object per
  line plus a final ``{"kind": "metrics", ...}`` line with the registry
  snapshot; the pull counterpart of the live ``MESH_TPU_OBS_JSONL``
  sink (obs/trace.py).
- ``prometheus_text()`` — the registry in the Prometheus exposition
  format (``# HELP`` / ``# TYPE`` + samples; histograms as cumulative
  ``_bucket{le=...}`` / ``_sum`` / ``_count``), for scraping.
- ``render_tree(events)`` — the nested ascii span tree, grouped per
  thread so the executor worker's spans never interleave with facade
  callers'.
"""

import json

from .metrics import REGISTRY

__all__ = ["write_jsonl", "prometheus_text", "render_tree"]


def write_jsonl(path, events=None, registry=None):
    """Dump buffered spans + a final metrics snapshot as JSON lines.

    :param events: span event dicts; default the process tracer's buffer.
    :param registry: metrics registry; default the process registry.
    :returns: number of lines written.
    """
    if events is None:
        from .trace import TRACER

        events = TRACER.events()
    registry = registry or REGISTRY
    lines = 0
    with open(path, "w") as fh:
        for event in events:
            fh.write(json.dumps(event) + "\n")
            lines += 1
        fh.write(json.dumps(
            {"kind": "metrics", "metrics": registry.snapshot()}
        ) + "\n")
        lines += 1
    return lines


def _prom_escape(value):
    """Label-value escaping per the text-format spec: backslash, double
    quote, and line feed (a raw newline would truncate the sample)."""
    return (
        str(value)
        .replace("\\", r"\\")
        .replace('"', r'\"')
        .replace("\n", r"\n")
    )


def _prom_escape_help(value):
    """HELP-line escaping per the spec: backslash and line feed only."""
    return str(value).replace("\\", r"\\").replace("\n", r"\n")


def _prom_labels(labels, extra=None):
    items = list(labels.items()) + (list(extra.items()) if extra else [])
    if not items:
        return ""
    return "{%s}" % ",".join(
        '%s="%s"' % (k, _prom_escape(v)) for k, v in items
    )


def _prom_num(value):
    if value == float("inf"):
        return "+Inf"
    return repr(float(value))


def prometheus_text(registry=None):
    """The registry in Prometheus exposition format (text/plain 0.0.4)."""
    registry = registry or REGISTRY
    out = []
    for name, snap in registry.snapshot().items():
        if snap["help"]:
            out.append("# HELP %s %s" % (name, _prom_escape_help(snap["help"])))
        out.append("# TYPE %s %s" % (name, snap["type"]))
        for series in snap["series"]:
            labels = series["labels"]
            if snap["type"] == "histogram":
                for bound, cumulative in series["buckets"]:
                    le = "+Inf" if bound == "+Inf" else _prom_num(bound)
                    out.append("%s_bucket%s %d" % (
                        name, _prom_labels(labels, {"le": le}), cumulative
                    ))
                out.append("%s_sum%s %s" % (
                    name, _prom_labels(labels), _prom_num(series["sum"])
                ))
                out.append("%s_count%s %d" % (
                    name, _prom_labels(labels), series["count"]
                ))
            else:
                out.append("%s%s %s" % (
                    name, _prom_labels(labels), _prom_num(series["value"])
                ))
    return "\n".join(out) + "\n"


def _fmt_ms(seconds):
    if seconds is None:
        return "?"
    return "%.3f ms" % (seconds * 1e3)


def render_tree(events=None):
    """Ascii tree of a span event list (default: the tracer's buffer).

    Spans nest by ``parent_id``; roots sort by start time; each thread
    gets its own heading.  A parent evicted from the bounded ring leaves
    its children rendered as roots (annotated), never dropped.
    """
    if events is None:
        from .trace import TRACER

        events = TRACER.events()
    if not events:
        return "(no spans recorded — is MESH_TPU_OBS=1 set?)"
    by_id = {e["span_id"]: e for e in events}
    children = {}
    roots_by_thread = {}
    for e in sorted(events, key=lambda e: (e["t_mono"] or 0)):
        parent = e.get("parent_id")
        if parent is not None and parent in by_id:
            children.setdefault(parent, []).append(e)
        else:
            roots_by_thread.setdefault(e.get("thread") or "?", []).append(e)

    lines = []

    def emit(e, depth):
        attrs = e.get("attrs") or {}
        detail = " ".join("%s=%s" % (k, v) for k, v in sorted(attrs.items()))
        sync = e.get("sync_elapsed_s")
        label = "%s%s  [%s%s]%s%s" % (
            "  " * depth + ("- " if depth else ""),
            e["name"],
            _fmt_ms(e.get("elapsed_s")),
            ", sync %s" % _fmt_ms(sync) if sync is not None else "",
            " " + detail if detail else "",
            " !%s" % e["status"] if e.get("status") not in (None, "ok") else "",
        )
        lines.append(label)
        for child in children.get(e["span_id"], []):
            emit(child, depth + 1)

    for thread, roots in roots_by_thread.items():
        lines.append("thread %s:" % thread)
        for root in roots:
            if root.get("parent_id") is not None:
                lines.append("  (parent span evicted from buffer)")
            emit(root, 1)
    return "\n".join(lines)
