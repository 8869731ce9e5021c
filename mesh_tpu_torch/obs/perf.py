"""Hermetic perf observability: the staged, watchdogged bench harness
plus the ``perfcheck`` regression gate (a copy of mesh_tpu/obs/perf.py).

The harness decomposes a bench run into declarative **stages**, each
executed in its own subprocess under a per-stage timeout, so:

- a hang in stage k can never destroy stages 1..k-1 — every stage's
  record is persisted incrementally to ``bench_partial.json`` (atomic
  temp+rename) the moment the stage ends;
- the orchestrator itself can never wedge: the child wait runs inside
  ``call_with_timeout`` (the wedge-proof abandoned-attempt-thread
  pattern the serving ladder's rung attempts share) with a grace margin
  on top of the subprocess timeout, and a timed-out child is reaped by
  ``reap_child`` (terminate -> poll -> kill -> poll -> abandon — never
  a blocking pipe read);
- the first hang/crash auto-dumps ONE flight-recorder incident tagged
  ``bench_stage_hang`` (stage name, timeout, statuses so far, partial
  path), and every stage outcome lands in the
  ``mesh_tpu_bench_stage_{ok,hung,crashed,skipped}_total`` counters and
  the ``mesh_tpu_bench_stage_seconds`` histogram.

The stages' children are whatever command lines their ``StageSpec``
names; the port's run ``mesh_tpu_torch`` code.  ``stage_timeout``,
``partial_path`` and ``inject_fault`` read the harness's knobs
(``MESH_TPU_BENCH_TIMEOUT_<STAGE>``, ``MESH_TPU_BENCH_PARTIAL``,
``MESH_TPU_BENCH_FAULT``) for a driver and its stage children.

``perfcheck`` is the read side: stdlib-only comparison of a saved bench
JSON (final record or the partial file) against a last-good baseline
and golden records, with tolerance bands, returning nonzero on
regression — runnable while the card is wedged, which is exactly when
it is needed.

Import cost: stdlib only; torch is never touched (the stages that need
it run in child processes).
"""

import json
import os
import subprocess
import sys
import threading
import time
from collections import OrderedDict

from ..errors import DeadlineExceeded
from ..utils import knobs
from .clock import monotonic, wall
from .metrics import REGISTRY
from .recorder import get_recorder

__all__ = [
    "StageSpec", "StageResult", "call_with_timeout", "reap_child",
    "run_stages", "write_partial", "read_bench_json", "extract_records",
    "perfcheck", "PARTIAL_SCHEMA_VERSION", "INCIDENT_REASON",
    "FAULT_ENV", "PARTIAL_ENV", "TIMEOUT_ENV_PREFIX",
    "stage_timeout", "partial_path", "inject_fault",
]

#: incident reason tag for any stage hang/crash
INCIDENT_REASON = "bench_stage_hang"

#: fault injection: ``<stage>:hang`` / ``<stage>:crash`` / ``<stage>:error``
#: makes that stage's child wedge / exit nonzero / raise (tests only)
FAULT_ENV = "MESH_TPU_BENCH_FAULT"

#: relocates the incremental partial-results file
PARTIAL_ENV = "MESH_TPU_BENCH_PARTIAL"

#: per-stage timeout override: MESH_TPU_BENCH_TIMEOUT_<STAGE> seconds
TIMEOUT_ENV_PREFIX = "MESH_TPU_BENCH_TIMEOUT_"

#: bench_partial.json schema (bump on breaking shape changes)
PARTIAL_SCHEMA_VERSION = 1

#: orchestrator-side margin on top of the subprocess timeout: covers
#: spawn latency plus a full reap escalation before the attempt thread
#: itself is declared wedged and abandoned
_ATTEMPT_GRACE_S = 30.0


def call_with_timeout(fn, timeout):
    """Run ``fn()`` on a daemon helper thread, waiting at most
    ``timeout`` seconds.  Raises DeadlineExceeded on timeout — the stuck
    thread is abandoned, not joined, because the whole point is that a
    wedged device call may never return.

    (serve/deadline.py re-exports it: the serving ladder's rung attempts
    run through this one wedge-proof primitive.)
    """
    box = {}
    done = threading.Event()

    def _run():
        try:
            box["result"] = fn()
        except BaseException as e:     # noqa: BLE001 — re-raised below
            box["error"] = e
        finally:
            done.set()

    worker = threading.Thread(target=_run, name="mesh-tpu-attempt",
                              daemon=True)
    worker.start()
    if not done.wait(timeout=max(float(timeout), 0.0)):
        raise DeadlineExceeded(
            "rung call still running after %.3fs slice" % timeout)
    if "error" in box:
        raise box["error"]
    return box["result"]


def reap_child(proc, term_grace_s=3.0, kill_grace_s=10.0,
               clock=monotonic, sleep=time.sleep):
    """Escalating child teardown that can never block the caller:
    SIGTERM -> bounded poll -> SIGKILL -> bounded poll -> abandon.

    Every wait is ``poll()`` (WNOHANG — it also reaps the zombie);
    nothing here reads a pipe, because a pipe held open by a wedged
    child (or its grandchild) is exactly what made the old
    ``kill(); communicate(timeout=10)`` teardown block.  Returns
    ``"terminated"`` / ``"killed"`` / ``"abandoned"`` — abandoned means
    the child survived SIGKILL (uninterruptible device I/O); the caller
    moves on and init never blocks on it again.
    """
    if proc.poll() is not None:
        return "terminated"
    try:
        proc.terminate()
    except OSError:
        pass
    deadline = clock() + term_grace_s
    while clock() < deadline:
        if proc.poll() is not None:
            return "terminated"
        sleep(0.05)
    try:
        proc.kill()
    except OSError:
        pass
    deadline = clock() + kill_grace_s
    while clock() < deadline:
        if proc.poll() is not None:
            return "killed"
        sleep(0.05)
    return "abandoned"


class StageSpec(object):
    """One declarative bench stage.

    :param name: stage name (also the child's ``--stage`` argument and
        the ``stage=`` metric label).
    :param argv: child command line; the stage runs subprocess-isolated
        so a wedge dies with the child, not the orchestrator.
    :param timeout_s: per-stage budget; past it the child is reaped and
        the stage is ``hung``.
    :param requires_backend: stage needs the (possibly wedged)
        accelerator backend; skipped once the backend is known-bad.
    :param gate: a non-ok outcome marks the backend bad (the probe).
    :param env: extra child environment (e.g. a stage's knobs).
    """

    __slots__ = ("name", "argv", "timeout_s", "requires_backend", "gate",
                 "env")

    def __init__(self, name, argv, timeout_s, requires_backend=False,
                 gate=False, env=None):
        self.name = name
        self.argv = list(argv)
        self.timeout_s = float(timeout_s)
        self.requires_backend = bool(requires_backend)
        self.gate = bool(gate)
        self.env = dict(env) if env else {}


class StageResult(object):
    """Outcome of one stage attempt: ``ok`` / ``hung`` / ``crashed`` /
    ``skipped``, elapsed wall time, the stage's JSON record (ok only),
    and the error string otherwise."""

    __slots__ = ("name", "status", "elapsed_s", "timeout_s", "record",
                 "error")

    def __init__(self, name, status, elapsed_s, timeout_s, record=None,
                 error=None):
        self.name = name
        self.status = status
        self.elapsed_s = elapsed_s
        self.timeout_s = timeout_s
        self.record = record
        self.error = error

    @property
    def ok(self):
        return self.status == "ok"

    def to_json(self):
        out = {
            "status": self.status,
            "elapsed_s": round(self.elapsed_s, 3),
            "timeout_s": self.timeout_s,
            "record": self.record,
        }
        if self.error:
            out["error"] = self.error
        return out


def write_partial(path, state):
    """Atomically persist the partial-results state (temp + rename so a
    crash mid-write — the wedge modes this file exists for — can never
    clobber the previous good copy)."""
    tmp = path + ".tmp"
    try:
        with open(tmp, "w") as fh:
            json.dump(state, fh, indent=1, default=str)
            fh.write("\n")
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def _last_json_line(text):
    for line in reversed((text or "").splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                return json.loads(line)
            except ValueError:
                continue
    return None


def _stage_counter(status):
    # one literal name per status so the metrics-doc lint sees them all
    names = {
        "ok": "mesh_tpu_bench_stage_ok_total",
        "hung": "mesh_tpu_bench_stage_hung_total",
        "crashed": "mesh_tpu_bench_stage_crashed_total",
        "skipped": "mesh_tpu_bench_stage_skipped_total",
    }
    help_text = "bench harness stages by outcome (label: stage)"
    REGISTRY.counter("mesh_tpu_bench_stage_ok_total", help_text)
    REGISTRY.counter("mesh_tpu_bench_stage_hung_total", help_text)
    REGISTRY.counter("mesh_tpu_bench_stage_crashed_total", help_text)
    REGISTRY.counter("mesh_tpu_bench_stage_skipped_total", help_text)
    return REGISTRY.get(names[status])


def _stage_histogram():
    return REGISTRY.histogram(
        "mesh_tpu_bench_stage_seconds",
        "wall seconds per bench stage attempt (label: stage)")


def _run_one(spec, clock, sleep, popen, log):
    """One subprocess-isolated stage attempt under its timeout, with the
    call_with_timeout backstop around the whole spawn+wait+reap path."""
    t0 = clock()

    def attempt():
        env = dict(os.environ)
        env.update(spec.env)
        proc = popen(spec.argv, stdout=subprocess.PIPE,
                     stderr=subprocess.PIPE, text=True, env=env)
        try:
            out, err = proc.communicate(timeout=spec.timeout_s)
        except subprocess.TimeoutExpired:
            how = reap_child(proc, clock=clock, sleep=sleep)
            return ("hung", None,
                    "stage still running after %.1fs budget (child %s)"
                    % (spec.timeout_s, how))
        if proc.returncode != 0:
            tail = (err or "").strip().splitlines()
            return ("crashed", None, "stage exited %d: %s" % (
                proc.returncode, tail[-1] if tail else "no stderr"))
        record = _last_json_line(out)
        if record is None:
            return ("crashed", None, "stage exited 0 without a JSON record")
        return ("ok", record, None)

    try:
        status, record, error = call_with_timeout(
            attempt, spec.timeout_s + _ATTEMPT_GRACE_S)
    except DeadlineExceeded:
        # even the reap path wedged; the attempt thread is abandoned
        status, record, error = "hung", None, (
            "stage attempt still wedged %.0fs past its %.1fs budget "
            "(attempt thread abandoned)"
            % (_ATTEMPT_GRACE_S, spec.timeout_s))
    except Exception as e:          # noqa: BLE001 — spawn failures etc.
        status, record, error = "crashed", None, "%s: %s" % (
            type(e).__name__, e)
    if error:
        log("stage %s %s: %s" % (spec.name, status, error))
    return StageResult(spec.name, status, clock() - t0, spec.timeout_s,
                       record, error)


def run_stages(specs, partial_path, clock=monotonic, sleep=time.sleep,
               popen=subprocess.Popen, recorder=None, log=None):
    """Execute ``specs`` in order; returns ``OrderedDict`` name ->
    StageResult.

    Contract (the measurement floor every perf PR stands on):

    - each stage runs in its own child under its own timeout; the
      orchestrator never waits unboundedly on anything;
    - after EVERY stage the partial state lands in ``partial_path`` —
      a hang in stage k never destroys stages 1..k-1;
    - a failed ``gate`` stage, or a hung backend stage, marks the
      backend bad: later ``requires_backend`` stages are skipped
      (re-touching a wedged card just burns their budgets), while
      backend-free stages (the CPU-interpreter proxy) still run;
    - the FIRST hang/crash dumps exactly one ``bench_stage_hang``
      incident via the flight recorder (later failures only ring-record,
      so a fully wedged run produces one forensic file, not a pile).
    """
    if log is None:
        log = lambda msg: None      # noqa: E731 — quiet default
    recorder = recorder or get_recorder()
    results = OrderedDict()
    state = {
        "schema_version": PARTIAL_SCHEMA_VERSION,
        "kind": "bench_partial",
        "started_utc": wall(),
        "order": [s.name for s in specs],
        "stages": {},
    }
    write_partial(partial_path, state)
    backend_ok = True
    incident_dumped = False
    hist = _stage_histogram()
    for spec in specs:
        if spec.requires_backend and not backend_ok:
            res = StageResult(spec.name, "skipped", 0.0, spec.timeout_s,
                              error="backend unavailable (gate/hang "
                                    "earlier in the pipeline)")
        else:
            log("stage %s (budget %.0fs)..." % (spec.name, spec.timeout_s))
            res = _run_one(spec, clock, sleep, popen, log)
            hist.observe(res.elapsed_s, stage=spec.name)
        results[spec.name] = res
        _stage_counter(res.status).inc(stage=spec.name)
        recorder.record("bench.stage", stage=spec.name, status=res.status,
                        elapsed_s=round(res.elapsed_s, 3),
                        timeout_s=spec.timeout_s)
        if spec.gate and (res.status != "ok"
                          or (res.record or {}).get("backend_ok") is False):
            backend_ok = False
        if res.status == "hung" and spec.requires_backend:
            # a hang INSIDE a backend stage means the card wedged
            # mid-run; later backend stages would hang the same way
            backend_ok = False
        if res.status in ("hung", "crashed") and not incident_dumped:
            recorder.trigger(INCIDENT_REASON, context={
                "stage": spec.name,
                "status": res.status,
                "timeout_s": spec.timeout_s,
                "elapsed_s": round(res.elapsed_s, 3),
                "error": res.error,
                "completed": [n for n, r in results.items() if r.ok],
                "partial_path": partial_path,
            }, force=True)
            incident_dumped = True
        state["stages"][spec.name] = res.to_json()
        write_partial(partial_path, state)
    return results


# ---------------------------------------------------------------------------
# the harness's knobs, for a driver and its stage children


def stage_timeout(name, default):
    """Stage ``name``'s budget: ``MESH_TPU_BENCH_TIMEOUT_<NAME>`` seconds
    when set to a number, else ``default``."""
    value = knobs.raw(TIMEOUT_ENV_PREFIX + name.upper())
    if value:
        try:
            return float(value)
        except ValueError:
            pass
    return default


def partial_path(default):
    """Where the partial-results file goes: ``MESH_TPU_BENCH_PARTIAL``
    when set, else ``default``."""
    return knobs.raw(PARTIAL_ENV) or default


def inject_fault(name, sleep=time.sleep):
    """A stage child's fault hook, called first thing:
    ``MESH_TPU_BENCH_FAULT=<name>:hang`` wedges the child,
    ``<name>:crash`` exits it with code 41, ``<name>:error`` raises; any
    other value (or another stage's) returns at once."""
    fault = knobs.raw(FAULT_ENV) or ""
    if not fault.startswith(name + ":"):
        return
    mode = fault.split(":", 1)[1]
    if mode == "hang":
        while True:
            sleep(3600)
    elif mode == "crash":
        sys.exit(41)
    elif mode == "error":
        raise RuntimeError("fault injection: stage %s error" % name)


# ---------------------------------------------------------------------------
# perfcheck: the regression gate


def read_bench_json(path):
    """Load a bench JSON file: either a one-line final record (the last
    JSON line of a bench run's output), or the incremental
    ``bench_partial.json`` the staged harness maintains."""
    with open(path) as fh:
        text = fh.read()
    doc = _last_json_line(text)
    if doc is None:
        doc = json.loads(text)
    return doc


def extract_records(doc):
    """Normalize either bench JSON shape into ``{"headline": rec|None,
    "proxy": rec|None, "accel": rec|None, "stream": rec|None,
    "mxu": rec|None, "store": rec|None, "tuner": rec|None,
    "replay": rec|None, "fleet": rec|None, "anim": rec|None,
    "trace": rec|None, "stages": {...}|None}``.

    The headline slot is only filled by a FRESH measurement — a
    ``stale: true`` envelope (last-good value republished while the
    card was wedged) is deliberately dropped here, so stale records
    can neither pass nor fail a regression gate.
    """
    headline = None
    proxy = None
    accel = None
    stream = None
    mxu = None
    store = None
    tuner = None
    replay = None
    fleet = None
    anim = None
    trace = None
    stages = None
    if doc.get("kind") == "bench_partial":
        stages = doc.get("stages") or {}
        cp = stages.get("closest_point") or {}
        if cp.get("status") == "ok":
            headline = cp.get("record")
        px = stages.get("pallas_proxy") or {}
        if px.get("status") == "ok":
            proxy = px.get("record")
        ax = stages.get("accel_proxy") or {}
        if ax.get("status") == "ok":
            accel = ax.get("record")
        st = stages.get("accel_stream_proxy") or {}
        if st.get("status") == "ok":
            stream = st.get("record")
        mx = stages.get("mxu_proxy") or {}
        if mx.get("status") == "ok":
            mxu = mx.get("record")
        sc = stages.get("store_cold_start") or {}
        if sc.get("status") == "ok":
            store = sc.get("record")
        tc = stages.get("tuner_convergence") or {}
        if tc.get("status") == "ok":
            tuner = tc.get("record")
        rp = stages.get("replay_proxy") or {}
        if rp.get("status") == "ok":
            replay = rp.get("record")
        fl = stages.get("fleet_proxy") or {}
        if fl.get("status") == "ok":
            fleet = fl.get("record")
        an = stages.get("anim_proxy") or {}
        if an.get("status") == "ok":
            anim = an.get("record")
        tp = stages.get("trace_proxy") or {}
        if tp.get("status") == "ok":
            trace = tp.get("record")
    else:
        if doc.get("value") is not None and not doc.get("stale"):
            headline = doc
        prox = doc.get("proxy")
        if isinstance(prox, dict) and prox.get("value") is not None:
            proxy = prox
        acc = doc.get("accel")
        if isinstance(acc, dict) and acc.get("value") is not None:
            accel = acc
        stm = doc.get("stream")
        if isinstance(stm, dict) and stm.get("value") is not None:
            stream = stm
        mx = doc.get("mxu")
        if isinstance(mx, dict) and mx.get("value") is not None:
            mxu = mx
        sto = doc.get("store")
        if isinstance(sto, dict) and sto.get("value") is not None:
            store = sto
        tun = doc.get("tuner")
        if isinstance(tun, dict) and tun.get("value") is not None:
            tuner = tun
        rp = doc.get("replay")
        if isinstance(rp, dict) and rp.get("value") is not None:
            replay = rp
        fl = doc.get("fleet")
        if isinstance(fl, dict) and fl.get("value") is not None:
            fleet = fl
        an = doc.get("anim")
        if isinstance(an, dict) and an.get("value") is not None:
            anim = an
        tp = doc.get("trace")
        if isinstance(tp, dict) and tp.get("value") is not None:
            trace = tp
        stages = doc.get("stages")
    return {"headline": headline, "proxy": proxy, "accel": accel,
            "stream": stream, "mxu": mxu, "store": store,
            "tuner": tuner, "replay": replay, "fleet": fleet,
            "anim": anim, "trace": trace, "stages": stages}


def perfcheck(doc, baseline=None, proxy_golden=None, proxy_tol=0.5,
              headline_tol=0.2, flops_tol=0.25, accel_golden=None,
              accel_tol=0.05, stream_golden=None, stream_tol=0.05,
              store_golden=None, store_tol=0.6, tuner_golden=None,
              tuner_tol=0.25, mxu_golden=None, mxu_tol=0.2,
              replay_golden=None, replay_tol=0.0,
              fleet_golden=None, fleet_tol=0.05,
              anim_golden=None, anim_tol=0.2,
              trace_golden=None, trace_tol=0.0):
    """Compare a bench JSON against the last-good baseline and the
    golden records.  Returns ``(rc, lines)`` — rc 0 when nothing
    regressed beyond its tolerance band, 1 on regression (including a
    missing slot record when its golden exists).

    Tolerances are one-sided fractions of the golden: a candidate fails
    when it is below ``golden * (1 - tol)`` (faster never fails).  The
    exceptions fail upward: the proxy's cost-model FLOPs, the mxu repair
    rate and the tuner's steps-to-converge (``> golden * (1 + tol)``).
    Deterministic checksums (accel, stream, mxu, store, tuner, replay,
    fleet, anim, trace) are hard FAILs on drift, and the replay, fleet,
    anim and trace slots fail outright without one.  The floors under
    the bands are the reference's: store and anim speedups at 1.0, mxu
    at 1.5, fleet affinity at 0.95, the fleet AOT tier's warm hits at 1
    and its speedup at ``max(golden * 0.4, 1.0)``; the fleet's spill
    count and the trace's retained tail are exact.  The lines and the
    rc equal the reference's on equal inputs, band for band.

    When the candidate and the baseline both carry ``stage_stats``
    blocks, ``prof.diff`` attributes the change to named stages
    (informational: the bands gate).
    """
    lines = []
    rc = 0
    recs = extract_records(doc)

    for slot, golden_doc, tol, stage_name, make_cmd in (
            ("accel", accel_golden, accel_tol, "accel_proxy",
             "make accel-golden"),
            ("stream", stream_golden, stream_tol, "accel_stream_proxy",
             "make accel-stream-golden")):
        gold = None
        if golden_doc:
            gold = (extract_records(golden_doc)[slot]
                    or (golden_doc
                        if golden_doc.get("value") is not None
                        else None))
        cand = recs[slot]
        if gold is not None:
            if cand is None:
                rc = 1
                lines.append(
                    "FAIL %s: candidate carries no %s record (a golden "
                    "exists — the chip-free index metric must always be "
                    "fresh)" % (slot, stage_name))
                continue
            floor = gold["value"] * (1.0 - tol)
            verdict = ("ok" if cand["value"] >= floor else "FAIL")
            if verdict == "FAIL":
                rc = 1
            lines.append(
                "%s %s pair-tests-skipped ratio: %.4f vs golden %.4f "
                "(floor %.4f, tol %.0f%%)"
                % (verdict, slot, cand["value"], gold["value"],
                   floor, 100 * tol))
            cand_sum = cand.get("checksum")
            gold_sum = gold.get("checksum")
            if cand_sum is not None and gold_sum is not None:
                same = abs(cand_sum - gold_sum) <= 1e-6 * max(
                    1.0, abs(gold_sum))
                if not same:
                    rc = 1
                lines.append(
                    "%s %s checksum: %.6f vs golden %.6f (exact)"
                    % ("ok" if same else "FAIL", slot, cand_sum,
                       gold_sum))
        elif cand is not None:
            lines.append("note: %s record present but no golden to "
                         "compare against (record one: %s)"
                         % (slot, make_cmd))

    mxu_gold = None
    if mxu_golden:
        mxu_gold = (extract_records(mxu_golden)["mxu"]
                    or (mxu_golden
                        if mxu_golden.get("value") is not None
                        else None))
    cand_mxu = recs["mxu"]
    if mxu_gold is not None:
        if cand_mxu is None:
            rc = 1
            lines.append(
                "FAIL mxu: candidate carries no mxu_proxy record (a "
                "golden exists — the chip-free matmul-form metric must "
                "always be fresh)")
        else:
            floor = max(mxu_gold["value"] * (1.0 - mxu_tol), 1.5)
            verdict = "ok" if cand_mxu["value"] >= floor else "FAIL"
            if verdict == "FAIL":
                rc = 1
            lines.append(
                "%s mxu proxy speedup (vpu/repair): %.3fx vs golden "
                "%.3fx (floor %.3fx, tol %.0f%%, hard floor 1.5x)"
                % (verdict, cand_mxu["value"], mxu_gold["value"],
                   floor, 100 * mxu_tol))
            cand_sum = cand_mxu.get("checksum")
            gold_sum = mxu_gold.get("checksum")
            if cand_sum is not None and gold_sum is not None:
                same = abs(cand_sum - gold_sum) <= 1e-6 * max(
                    1.0, abs(gold_sum))
                if not same:
                    rc = 1
                lines.append(
                    "%s mxu checksum: %.6f vs golden %.6f (exact)"
                    % ("ok" if same else "FAIL", cand_sum, gold_sum))
            cand_rate = cand_mxu.get("repair_rate")
            gold_rate = mxu_gold.get("repair_rate")
            if cand_rate is not None and gold_rate is not None:
                # higher repair rate = weaker bf16 screen; fails upward
                ceil = gold_rate * (1.0 + mxu_tol)
                verdict = "ok" if cand_rate <= ceil else "FAIL"
                if verdict == "FAIL":
                    rc = 1
                lines.append(
                    "%s mxu repair rate: %.4f vs golden %.4f "
                    "(ceiling %.4f, tol %.0f%%)"
                    % (verdict, cand_rate, gold_rate, ceil,
                       100 * mxu_tol))
    elif cand_mxu is not None:
        lines.append("note: mxu record present but no golden to "
                     "compare against (record one: make mxu-golden)")

    store_gold = None
    if store_golden:
        store_gold = (extract_records(store_golden)["store"]
                      or (store_golden
                          if store_golden.get("value") is not None
                          else None))
    cand_store = recs["store"]
    if store_gold is not None:
        if cand_store is None:
            rc = 1
            lines.append(
                "FAIL store: candidate carries no store_cold_start "
                "record (a golden exists — the chip-free cold-start "
                "metric must always be fresh)")
        else:
            floor = max(store_gold["value"] * (1.0 - store_tol), 1.0)
            verdict = "ok" if cand_store["value"] >= floor else "FAIL"
            if verdict == "FAIL":
                rc = 1
            lines.append(
                "%s store cold-start speedup (rebuild/sidecar): %.3fx "
                "vs golden %.3fx (floor %.3fx, tol %.0f%%, hard floor "
                "1.0x)" % (verdict, cand_store["value"],
                           store_gold["value"], floor, 100 * store_tol))
            cand_sum = cand_store.get("checksum")
            gold_sum = store_gold.get("checksum")
            if cand_sum is not None and gold_sum is not None:
                same = abs(cand_sum - gold_sum) <= 1e-6 * max(
                    1.0, abs(gold_sum))
                if not same:
                    rc = 1
                lines.append(
                    "%s store checksum: %.6f vs golden %.6f (exact)"
                    % ("ok" if same else "FAIL", cand_sum, gold_sum))
    elif cand_store is not None:
        lines.append("note: store record present but no golden to "
                     "compare against (record one: make store-golden)")

    tuner_gold = None
    if tuner_golden:
        tuner_gold = (extract_records(tuner_golden)["tuner"]
                      or (tuner_golden
                          if tuner_golden.get("value") is not None
                          else None))
    cand_tuner = recs["tuner"]
    if tuner_gold is not None:
        if cand_tuner is None:
            rc = 1
            lines.append(
                "FAIL tuner: candidate carries no tuner_convergence "
                "record (a golden exists — the chip-free controller "
                "metric must always be fresh)")
        else:
            # smaller-is-better: steps-to-converge fails upward
            ceil = tuner_gold["value"] * (1.0 + tuner_tol)
            verdict = "ok" if cand_tuner["value"] <= ceil else "FAIL"
            if verdict == "FAIL":
                rc = 1
            lines.append(
                "%s tuner steps-to-converge: %d vs golden %d "
                "(ceiling %.1f, tol %.0f%%)"
                % (verdict, cand_tuner["value"], tuner_gold["value"],
                   ceil, 100 * tuner_tol))
            cand_sum = cand_tuner.get("checksum")
            gold_sum = tuner_gold.get("checksum")
            if cand_sum is not None and gold_sum is not None:
                same = abs(cand_sum - gold_sum) <= 1e-6 * max(
                    1.0, abs(gold_sum))
                if not same:
                    rc = 1
                lines.append(
                    "%s tuner trajectory checksum: %.6f vs golden %.6f "
                    "(exact)" % ("ok" if same else "FAIL", cand_sum,
                                 gold_sum))
    elif cand_tuner is not None:
        lines.append("note: tuner record present but no golden to "
                     "compare against (record one: make tuner-golden)")

    replay_gold = None
    if replay_golden:
        replay_gold = (extract_records(replay_golden)["replay"]
                       or (replay_golden
                           if replay_golden.get("value") is not None
                           else None))
    cand_replay = recs["replay"]
    if replay_gold is not None:
        if cand_replay is None:
            rc = 1
            lines.append(
                "FAIL replay: candidate carries no replay_proxy record "
                "(a golden exists — the chip-free replay-determinism "
                "metric must always be fresh)")
        else:
            floor = replay_gold["value"] * (1.0 - replay_tol)
            verdict = "ok" if cand_replay["value"] >= floor else "FAIL"
            if verdict == "FAIL":
                rc = 1
            lines.append(
                "%s replay admissions: %d vs golden %d (floor %.1f, "
                "tol %.0f%%)"
                % (verdict, cand_replay["value"], replay_gold["value"],
                   floor, 100 * replay_tol))
            cand_sum = cand_replay.get("checksum")
            gold_sum = replay_gold.get("checksum")
            if cand_sum is None:
                rc = 1
                lines.append(
                    "FAIL replay: candidate record carries no "
                    "admission-sequence checksum — determinism "
                    "unproven")
            elif gold_sum is not None:
                # CRC-style sums are exact integers: a relative
                # tolerance (the float-accumulation idiom above) would
                # swallow real drift at CRC magnitudes, so compare to
                # within float-representation noise only.
                same = abs(cand_sum - gold_sum) <= 1e-6
                if not same:
                    rc = 1
                lines.append(
                    "%s replay admission-sequence checksum: %.6f vs "
                    "golden %.6f (exact — drift means replay no longer "
                    "reproduces the same sequence)"
                    % ("ok" if same else "FAIL", cand_sum, gold_sum))
    elif cand_replay is not None:
        lines.append("note: replay record present but no golden to "
                     "compare against (record one: make replay-golden)")

    fleet_gold = None
    if fleet_golden:
        fleet_gold = (extract_records(fleet_golden)["fleet"]
                      or (fleet_golden
                          if fleet_golden.get("value") is not None
                          else None))
    cand_fleet = recs["fleet"]
    if fleet_gold is not None:
        if cand_fleet is None:
            rc = 1
            lines.append(
                "FAIL fleet: candidate carries no fleet_proxy record "
                "(a golden exists — the chip-free fleet-fabric contract "
                "must always be fresh)")
        else:
            floor = max(fleet_gold["value"] * (1.0 - fleet_tol), 0.95)
            verdict = "ok" if cand_fleet["value"] >= floor else "FAIL"
            if verdict == "FAIL":
                rc = 1
            lines.append(
                "%s fleet routing affinity: %.4f vs golden %.4f "
                "(floor %.4f, tol %.0f%%, hard floor 0.95)"
                % (verdict, cand_fleet["value"], fleet_gold["value"],
                   floor, 100 * fleet_tol))
            cand_warm = cand_fleet.get("warm_hit_rate")
            gold_warm = fleet_gold.get("warm_hit_rate")
            if cand_warm is not None and gold_warm is not None:
                floor = gold_warm * (1.0 - fleet_tol)
                verdict = "ok" if cand_warm >= floor else "FAIL"
                if verdict == "FAIL":
                    rc = 1
                lines.append(
                    "%s fleet warm-hit rate: %.4f vs golden %.4f "
                    "(floor %.4f, tol %.0f%%)"
                    % (verdict, cand_warm, gold_warm, floor,
                       100 * fleet_tol))
            cand_spills = cand_fleet.get("spills")
            gold_spills = fleet_gold.get("spills")
            if cand_spills is not None and gold_spills is not None:
                # the stampede scenario is deterministic: spill count
                # drift means admission behavior changed, exact match
                same = cand_spills == gold_spills
                if not same:
                    rc = 1
                lines.append(
                    "%s fleet spills under stampede: %d vs golden %d "
                    "(exact)" % ("ok" if same else "FAIL", cand_spills,
                                 gold_spills))
            cand_sum = cand_fleet.get("checksum")
            gold_sum = fleet_gold.get("checksum")
            if cand_sum is None:
                rc = 1
                lines.append(
                    "FAIL fleet: candidate record carries no combined "
                    "replica-admission checksum — placement determinism "
                    "unproven")
            elif gold_sum is not None:
                # CRC-exact, same rationale as the replay checksum
                same = abs(cand_sum - gold_sum) <= 1e-6
                if not same:
                    rc = 1
                lines.append(
                    "%s fleet replica-admission checksum: %.6f vs "
                    "golden %.6f (exact — drift means the router "
                    "stopped reproducing placement)"
                    % ("ok" if same else "FAIL", cand_sum, gold_sum))
            aot = cand_fleet.get("aot") or {}
            gold_aot = fleet_gold.get("aot") or {}
            warm_hits = aot.get("warm_hits")
            if warm_hits is not None:
                verdict = "ok" if warm_hits >= 1 else "FAIL"
                if verdict == "FAIL":
                    rc = 1
                lines.append(
                    "%s fleet aot warm start: %d executable cache "
                    "hit(s) (need >= 1 — the second process must load, "
                    "not recompile)" % (verdict, warm_hits))
            cand_speed = aot.get("speedup")
            gold_speed = gold_aot.get("speedup")
            if cand_speed is not None and gold_speed is not None:
                floor = max(gold_speed * 0.4, 1.0)
                verdict = "ok" if cand_speed >= floor else "FAIL"
                if verdict == "FAIL":
                    rc = 1
                lines.append(
                    "%s fleet aot compile-stage speedup (cold/warm): "
                    "%.2fx vs golden %.2fx (floor %.2fx, hard floor "
                    "1.0x)" % (verdict, cand_speed, gold_speed, floor))
    elif cand_fleet is not None:
        lines.append("note: fleet record present but no golden to "
                     "compare against (record one: make fleet-golden)")

    anim_gold = None
    if anim_golden:
        anim_gold = (extract_records(anim_golden)["anim"]
                     or (anim_golden
                         if anim_golden.get("value") is not None
                         else None))
    cand_anim = recs["anim"]
    if anim_gold is not None:
        if cand_anim is None:
            rc = 1
            lines.append(
                "FAIL anim: candidate carries no anim_proxy record (a "
                "golden exists — the chip-free refit-vs-rebuild metric "
                "must always be fresh)")
        else:
            floor = max(anim_gold["value"] * (1.0 - anim_tol), 1.0)
            verdict = "ok" if cand_anim["value"] >= floor else "FAIL"
            if verdict == "FAIL":
                rc = 1
            lines.append(
                "%s anim refit speedup (rebuild/refit): %.3fx vs "
                "golden %.3fx (floor %.3fx, tol %.0f%%, hard floor "
                "1.0x)" % (verdict, cand_anim["value"],
                           anim_gold["value"], floor, 100 * anim_tol))
            cand_sum = cand_anim.get("checksum")
            gold_sum = anim_gold.get("checksum")
            if cand_sum is None:
                rc = 1
                lines.append(
                    "FAIL anim: candidate record carries no traversal "
                    "checksum — refit exactness unproven")
            elif gold_sum is not None:
                same = abs(cand_sum - gold_sum) <= 1e-6 * max(
                    1.0, abs(gold_sum))
                if not same:
                    rc = 1
                lines.append(
                    "%s anim traversal checksum: %.6f vs golden %.6f "
                    "(exact — drift means the refit index answered "
                    "differently from a fresh build)"
                    % ("ok" if same else "FAIL", cand_sum, gold_sum))
    elif cand_anim is not None:
        lines.append("note: anim record present but no golden to "
                     "compare against (record one: make anim-golden)")

    trace_gold = None
    if trace_golden:
        trace_gold = (extract_records(trace_golden)["trace"]
                      or (trace_golden
                          if trace_golden.get("value") is not None
                          else None))
    cand_trace = recs["trace"]
    if trace_gold is not None:
        if cand_trace is None:
            rc = 1
            lines.append(
                "FAIL trace: candidate carries no trace_proxy record "
                "(a golden exists — the chip-free request-identity join "
                "contract must always be fresh)")
        else:
            floor = trace_gold["value"] * (1.0 - trace_tol)
            verdict = "ok" if cand_trace["value"] >= floor else "FAIL"
            if verdict == "FAIL":
                rc = 1
            lines.append(
                "%s trace requests joined: %d vs golden %d (floor %.1f, "
                "tol %.0f%%)"
                % (verdict, cand_trace["value"], trace_gold["value"],
                   floor, 100 * trace_tol))
            cand_tail = cand_trace.get("tail_retained")
            gold_tail = trace_gold.get("tail_retained")
            if cand_tail is not None and gold_tail is not None:
                # the forced deadline-miss/error mix is deterministic:
                # a different retained-tail count means the tail-sampling
                # guarantee (every miss/error keeps its tree) broke
                same = cand_tail == gold_tail
                if not same:
                    rc = 1
                lines.append(
                    "%s trace tail retained (miss/error trees): %d vs "
                    "golden %d (exact)"
                    % ("ok" if same else "FAIL", cand_tail, gold_tail))
            cand_sum = cand_trace.get("checksum")
            gold_sum = trace_gold.get("checksum")
            if cand_sum is None:
                rc = 1
                lines.append(
                    "FAIL trace: candidate record carries no join "
                    "checksum — the request-identity join is unproven")
            elif gold_sum is not None:
                # CRC-exact, same rationale as the replay checksum
                same = abs(cand_sum - gold_sum) <= 1e-6
                if not same:
                    rc = 1
                lines.append(
                    "%s trace join checksum: %.6f vs golden %.6f "
                    "(exact — drift means the ledger/span/router join "
                    "stopped reproducing)"
                    % ("ok" if same else "FAIL", cand_sum, gold_sum))
    elif cand_trace is not None:
        lines.append("note: trace record present but no golden to "
                     "compare against (record one: make trace-golden)")

    golden_rec = None
    if proxy_golden:
        golden_rec = (extract_records(proxy_golden)["proxy"]
                      or (proxy_golden
                          if proxy_golden.get("value") is not None
                          else None))
    cand_proxy = recs["proxy"]
    if golden_rec is not None:
        if cand_proxy is None:
            rc = 1
            lines.append(
                "FAIL proxy: candidate carries no pallas_proxy record "
                "(a golden exists — the chip-free metric must always "
                "be fresh)")
        else:
            floor = golden_rec["value"] * (1.0 - proxy_tol)
            verdict = "ok" if cand_proxy["value"] >= floor else "FAIL"
            if verdict == "FAIL":
                rc = 1
            lines.append(
                "%s proxy pair_tests/sec: %.1f vs golden %.1f "
                "(floor %.1f, tol %.0f%%)"
                % (verdict, cand_proxy["value"], golden_rec["value"],
                   floor, 100 * proxy_tol))
            cand_flops = (cand_proxy.get("hlo_cost") or {}).get("flops")
            gold_flops = (golden_rec.get("hlo_cost") or {}).get("flops")
            if cand_flops and gold_flops:
                ceil = gold_flops * (1.0 + flops_tol)
                verdict = "ok" if cand_flops <= ceil else "FAIL"
                if verdict == "FAIL":
                    rc = 1
                lines.append(
                    "%s proxy HLO cost-model flops: %.3g vs golden %.3g "
                    "(ceiling %.3g, tol %.0f%%)"
                    % (verdict, cand_flops, gold_flops, ceil,
                       100 * flops_tol))
    elif cand_proxy is not None:
        lines.append("note: proxy present but no golden to compare "
                     "against (record one: make proxy-golden)")

    base_head = None
    if baseline and baseline.get("value") is not None \
            and not baseline.get("stale"):
        base_head = baseline
    cand_head = recs["headline"]
    if cand_head is not None and base_head is not None:
        floor = base_head["value"] * (1.0 - headline_tol)
        verdict = "ok" if cand_head["value"] >= floor else "FAIL"
        if verdict == "FAIL":
            rc = 1
        lines.append(
            "%s headline %s: %.1f vs last-good %.1f (floor %.1f, "
            "tol %.0f%%)"
            % (verdict, cand_head.get("unit", "queries/sec"),
               cand_head["value"], base_head["value"], floor,
               100 * headline_tol))
    elif doc.get("stale"):
        lines.append(
            "note: headline is a STALE last-good republication "
            "(age %sh) — skipped, neither an improvement nor a "
            "regression" % doc.get("stale_age_hours"))
    elif cand_head is None:
        lines.append("note: no fresh headline in the candidate "
                     "(wedged or subset run) — headline not checked")
    elif base_head is None:
        lines.append("note: no usable last-good baseline — headline "
                     "not checked")

    # stage attribution: when both sides carry ledger stage evidence
    # (a serve-load record embeds a stage_stats block), say WHICH stage
    # moved.  Informational — the bands above gate; this turns "a band
    # failed" into "p99 regressed because dispatch got slower".
    cand_stage = _stage_stats_block(doc)
    base_stage = _stage_stats_block(baseline) if baseline else None
    if cand_stage is not None and base_stage is not None:
        from . import prof

        _, diff_lines = prof.diff(base_stage, cand_stage)
        lines.append("stage attribution vs last-good (prof diff):")
        lines.extend("  " + line for line in diff_lines)
    elif cand_stage is not None:
        lines.append("note: candidate carries stage_stats but the "
                     "baseline does not — stage attribution skipped")
    return rc, lines


def _stage_stats_block(doc):
    """The prof-shaped stage stats embedded in a bench doc (a final
    record with ``stage_stats``, or any record inside ``records`` /
    staged ``stages``), or None."""
    if not isinstance(doc, dict):
        return None
    if isinstance(doc.get("stage_stats"), dict):
        return {"stages": doc["stage_stats"],
                "total": doc.get("stage_total"),
                "backends": doc.get("stage_backends") or {}}
    from . import prof

    return prof._from_bench_doc(doc)
