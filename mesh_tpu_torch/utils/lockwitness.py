"""Runtime lock witness: record real acquisition orders (a copy of
mesh_tpu/utils/lockwitness.py for the port's own locks).

``MESH_TPU_LOCK_WITNESS=1`` (read at import, see
``mesh_tpu_torch/__init__``) patches the ``threading.Lock`` / ``RLock`` /
``Condition`` factories so that every primitive **created by
mesh_tpu_torch code** is wrapped in a thin recorder.  Creations from
anywhere else (stdlib, torch, user code, the reference package) get the
raw primitive back untouched — the caller-frame filter makes the patch
invisible outside the package.

Each wrapped lock is keyed by its *creation site* (repo-relative
``mesh_tpu_torch/....py:lineno``), the key the reference's static lock
analysis uses for its own package, so the dynamic log joins a static
graph without any name mapping.  A per-thread shadow stack tracks held
wrapped locks; on every acquire we record one ``held-site ->
acquired-site`` edge per lock currently held (deduped, counted).
Re-entrant re-acquires of a site already on the stack record nothing: an
RLock taken twice is not an ordering fact.

``dump()`` writes the edge multiset as JSONL (``MESH_TPU_LOCK_WITNESS_FILE``,
at process exit too); an acyclic edge graph is the witnessed order.

The witness deliberately lives below the knobs layer and imports
nothing from the rest of the package: it must be installable before
any lock-creating module is imported.
"""

import atexit
import json
import os
import sys
import threading

__all__ = ["install", "installed", "reset", "dump", "edges",
           "witness_file", "load"]

_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_REAL_CONDITION = threading.Condition

#: .../mesh_tpu_torch — creations from files under here get wrapped
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: repo checkout root, so site keys are repo-relative like the analysis
_ROOT_DIR = os.path.dirname(_PKG_DIR)
_SELF = os.path.abspath(__file__)


class _WitnessState(object):
    """Shadow stacks + the recorded edge multiset (process-global)."""

    def __init__(self):
        self._mu = _REAL_LOCK()
        self._tls = threading.local()
        self.edges = {}      # (src_site, dst_site) -> count
        self.sites = set()   # every site that ever acquired

    def _stack(self):
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        return stack

    def on_acquire(self, site):
        stack = self._stack()
        if site in stack:          # re-entrant: not an ordering fact,
            stack.append(site)     # but keep release bookkeeping honest
            return
        with self._mu:
            self.sites.add(site)
            for held in stack:
                if held != site:
                    key = (held, site)
                    self.edges[key] = self.edges.get(key, 0) + 1
        stack.append(site)

    def on_release(self, site):
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == site:
                del stack[i]
                return

    def snapshot(self):
        with self._mu:
            return dict(self.edges), set(self.sites)

    def clear(self):
        with self._mu:
            self.edges.clear()
            self.sites.clear()


_STATE = _WitnessState()


class _WitnessedLock(object):
    """Records acquire/release against the shadow stack, delegates
    everything else (including Condition's ``_release_save`` protocol)
    to the real primitive."""

    __slots__ = ("_inner", "_site")

    def __init__(self, inner, site):
        self._inner = inner
        self._site = site

    def acquire(self, blocking=True, timeout=-1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            _STATE.on_acquire(self._site)
        return got

    def release(self):
        self._inner.release()
        _STATE.on_release(self._site)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.release()
        return False

    def locked(self):
        probe = getattr(self._inner, "locked", None)
        return probe() if probe is not None else None

    # Condition hands lock state save/restore through these when
    # present; the witness treats a wait() as "still held" (the thread
    # acquires nothing while blocked, so no spurious edges appear).
    def _release_save(self):
        return self._inner._release_save()

    def _acquire_restore(self, state):
        self._inner._acquire_restore(state)

    def _is_owned(self):
        return self._inner._is_owned()

    def __repr__(self):
        return "<witnessed %r @ %s>" % (self._inner, self._site)


def _creation_site(depth):
    """Repo-relative ``path.py:lineno`` of the creating frame, or None
    when the creator is not mesh_tpu_torch code (leave those locks raw)."""
    try:
        frame = sys._getframe(depth)
    except ValueError:
        return None
    path = os.path.abspath(frame.f_code.co_filename)
    if not path.startswith(_PKG_DIR + os.sep) or path == _SELF:
        return None
    rel = os.path.relpath(path, _ROOT_DIR).replace(os.sep, "/")
    return "%s:%d" % (rel, frame.f_lineno)


def _lock_factory():
    site = _creation_site(2)
    inner = _REAL_LOCK()
    return inner if site is None else _WitnessedLock(inner, site)


def _rlock_factory():
    site = _creation_site(2)
    inner = _REAL_RLOCK()
    return inner if site is None else _WitnessedLock(inner, site)


def _condition_factory(lock=None):
    if lock is None:
        site = _creation_site(2)
        if site is not None:
            lock = _WitnessedLock(_REAL_RLOCK(), site)
    return _REAL_CONDITION(lock)


_installed = False


def install():
    """Patch the threading factories (idempotent).  Must run before the
    lock-creating mesh_tpu_torch modules are imported —
    ``mesh_tpu_torch/__init__`` calls this right after the knob registry
    loads when ``MESH_TPU_LOCK_WITNESS`` is set."""
    global _installed
    if _installed:
        return
    _installed = True
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory
    threading.Condition = _condition_factory
    atexit.register(_dump_at_exit)


def installed():
    return _installed


def reset():
    """Drop every recorded edge (tests)."""
    _STATE.clear()


def edges():
    """{(src_site, dst_site): count} snapshot of recorded orders."""
    snap, _ = _STATE.snapshot()
    return snap


#: the dump's path when ``MESH_TPU_LOCK_WITNESS_FILE`` is unset
DEFAULT_WITNESS_FILE = os.path.join("~", ".mesh_tpu_torch",
                                    "lock_witness.jsonl")


def witness_file():
    from . import knobs

    return os.path.expanduser(
        knobs.get_str("MESH_TPU_LOCK_WITNESS_FILE") or DEFAULT_WITNESS_FILE)


def dump(path=None):
    """Write the edge multiset as JSONL: one
    ``{"src": [path, line], "dst": [path, line], "count": n}`` object
    per line (plus one ``{"site": [path, line]}`` line per lock that
    ever acquired, so single-lock runs still prove the witness ran).
    Returns the path written."""
    path = path or witness_file()
    snap, sites = _STATE.snapshot()

    def split(site):
        rel, _, line = site.rpartition(":")
        return [rel, int(line)]

    dirname = os.path.dirname(path)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        for site in sorted(sites):
            fh.write(json.dumps({"site": split(site)}) + "\n")
        for (src, dst), count in sorted(snap.items()):
            fh.write(json.dumps({
                "src": split(src), "dst": split(dst), "count": count,
            }) + "\n")
    return path


def _dump_at_exit():
    try:
        dump()
    except Exception:
        pass     # exit-time best effort: never mask the real exit


def load(path):
    """Parse a witness JSONL file ->
    ``[((src_path, src_line), (dst_path, dst_line), count), ...]``."""
    out = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if "src" not in rec:
                continue
            out.append((
                (rec["src"][0], int(rec["src"][1])),
                (rec["dst"][0], int(rec["dst"][1])),
                int(rec.get("count", 1))))
    return out
