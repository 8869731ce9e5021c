"""The harness shared by the A/B timing tools (``tools/ab_*.py``): two
checkouts of the repository, one CUDA card, one run.

A tool supplies the inputs (made once, on the card, and saved), a side
program's body and the checks of its answers; this module runs each side in
a process of its own from its own checkout, ``--pairs`` times, the pairs
alternating which side runs first (other, this, this, other, ...), and
prints one line per process and, last, one JSON object: every reading, per
variant the median of each side's medians and the fastest round, the
answers' agreement, the SASS of the kernels named in ``sass`` on both sides
and the card's name and power limit.

A side program is ``side_program(body, ...)``: ``SIDE_HEAD`` (its
checkout's package first on the path, the inputs in ``inputs``, ``reps``,
``rounds``, the tool's own arguments in ``extra``, its kernels built with
``-Xptxas -v`` and their register and spill lines in ``ptxas``), the
tool's ``body``, which sets ``variants`` (a list of (name, fn)),
``later`` (the same, for variants one side has and the other lacks),
``answers`` (a dict of CPU tensors) and ``queued`` (the names of variants
shorter than their host launch path), and ``SIDE_TAIL``, which times each
variant with CUDA events around ``reps`` back-to-back calls, in ``rounds``
rounds that interleave the variants, and takes the median over the rounds.
A queued variant's calls wait behind a spin of ``QUEUE_SPIN_MS`` on the
card, so the events time the card's runs and not the host's launches; a
round whose host took longer to queue them than the spin lasted is
listed in ``spin_overrun``.
The ``later`` variants run in rounds of their own after those of
``variants``: interleaved, they slowed the host-bound calls around them
on both sides of an A/B of one checkout against its own copy (PERF.md,
row 11), which biases a comparison with a side that lacks them.
"""

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: where the CUDA toolkit puts cuobjdump when it is not on PATH
TOOLKIT_CUOBJDUMP = "/usr/local/cuda/bin/cuobjdump"

SIDE_HEAD = r"""
import json, statistics, sys
import torch
sys.path.insert(0, ".")
from mesh_tpu_torch import _build

inputs = torch.load(sys.argv[1])
reps, rounds, out_path = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
extra = sys.argv[5:]
report = _build.build(verbose=True)
ptxas = {name: [line.strip() for line in report.get(name, {}).get(
    "ptxas", "").splitlines() if "registers" in line or "spill" in line]
    for name in PTXAS}
variants, later, answers, queued = [], [], {}, set()
"""

SIDE_TAIL = r"""
import time
times = {name: [] for name, _ in variants + later}
overrun = []
for group in (variants, later):
    for _ in range(rounds):
        for name, fn in group:
            fn()
            torch.cuda.synchronize()
            spin = torch.cuda.Event(enable_timing=True)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            spin.record()
            if name in queued:
                torch.cuda._sleep(int(QUEUE_SPIN_MS * 1e-3 * SPIN_CLOCK_HZ))
            t0 = time.perf_counter()
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            host_ms = (time.perf_counter() - t0) * 1e3
            end.synchronize()
            if name in queued and host_ms > spin.elapsed_time(start):
                overrun.append(name)
            times[name].append(start.elapsed_time(end) / reps)
torch.save(answers, out_path)
print(json.dumps({"ms": {k: statistics.median(v) for k, v in times.items()},
                  "rounds_ms": times, "ptxas": ptxas,
                  "queued": sorted(queued), "spin_overrun": overrun,
                  "libs": {name: _build._library_path(name)
                           for name in SASS}}))
"""

#: ``SIDE_TAIL``'s spin before a queued variant's calls, and the SM clock
#: that converts it to cycles (the H100 SXM's boost clock; a lower clock
#: only spins longer)
QUEUE_SPIN_MS = 20.0
SPIN_CLOCK_HZ = 1.98e9


def side_program(body, ptxas=(), sass=()):
    """The program a side's process runs: ``body`` between SIDE_HEAD and
    SIDE_TAIL, with the kernels whose ptxas lines it reports (``ptxas``)
    and whose libraries it names for the SASS comparison (``sass``)."""
    return ("PTXAS = %r\nSASS = %r\nQUEUE_SPIN_MS = %r\nSPIN_CLOCK_HZ = %r\n"
            % (tuple(ptxas), tuple(sass), QUEUE_SPIN_MS, SPIN_CLOCK_HZ)
            + SIDE_HEAD + body + SIDE_TAIL)


def parser(doc):
    """The arguments every A/B tool takes: ``--other``, ``--pairs``,
    ``--rounds`` and ``--reps``."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="the other checkout's root directory")
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=10)
    return ap


def side_order(pairs):
    """The sides in the order they run: pairs alternate which goes first."""
    order = ["other", "this"]
    return [side for p in range(pairs)
            for side in (order if p % 2 == 0 else order[::-1])]


def summarize(runs):
    """Per side, the median of its processes' medians and the fastest
    round of each variant."""
    summary, fastest = {}, {}
    for side in ("other", "this"):
        mine = [run["readings"] for run in runs if run["side"] == side]
        keys = sorted({k for r in mine for k in r["ms"]})
        summary[side] = {k: statistics.median(r["ms"][k] for r in mine
                                              if k in r["ms"])
                         for k in keys}
        fastest[side] = {k: min(min(r["rounds_ms"][k]) for r in mine
                                if k in r["rounds_ms"]) for k in keys}
    return summary, fastest


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return "nvidia-smi failed: %s" % exc


def same_as_first(key):
    """A check of the answers: every answer equal to the first process's
    ``key`` (the names of those that differ)."""
    def check(paths):
        import torch

        runs = [torch.load(p) for p in paths]
        want = runs[0][key]
        return sorted({name for run in runs for name, got in run.items()
                       if not torch.equal(got, want)})
    return check


def same_per_name(paths):
    """A check of the answers: each answer equal to the first process's
    answer of the same name, where that process has one (the names of
    those that differ)."""
    import torch

    runs = [torch.load(p) for p in paths]
    bad = set()
    for run in runs[1:]:
        for name, got in run.items():
            want = runs[0].get(name)
            if want is not None and not torch.equal(got, want):
                bad.add(name)
    return sorted(bad)


def sass_functions(lib):
    """{mangled name: SASS lines with their encodings, addresses dropped}
    of every function in the shared library ``lib`` (``cuobjdump
    -sass``)."""
    tool = shutil.which("cuobjdump") or TOOLKIT_CUOBJDUMP
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    funcs, body = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            # an anonymous namespace's mangled name carries a hash of the
            # file's path, which differs between checkouts
            name = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__",
                          head.group(1))
            body = funcs.setdefault(name, [])
        elif body is not None and line.strip().startswith("....."):
            body = None                      # the end of a function
        elif body is not None and line.strip():
            body.append(" ".join(
                re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).split()))
    return funcs


def compare_sass(this_lib, other_lib):
    """Per function of two libraries of one kernel, whether both sides hold
    the same SASS (instructions and encodings), with its line count on
    each side; an "error" entry if cuobjdump fails."""
    try:
        this, other = (sass_functions(lib) for lib in (this_lib, other_lib))
    except (OSError, subprocess.SubprocessError) as exc:
        return {"error": str(exc)}
    return {name: {"identical": this.get(name) == other.get(name),
                   "this_lines": len(this.get(name) or []),
                   "other_lines": len(other.get(name) or [])}
            for name in sorted(set(this) | set(other))}


def run(tool, args, side, make_inputs, check, extra=(), sass=(),
        needs="mesh_tpu_torch/__init__.py"):
    """Runs ``side`` (a program of ``side_program``) from both checkouts
    on ``make_inputs()``'s inputs, ``args.pairs`` pairs, with ``extra``
    after the common arguments; prints each process's readings and the
    summary line; exits non-zero without a card, when a side fails or when
    ``check`` (given the answers' paths) names answers that differ."""
    import torch

    if not torch.cuda.is_available():
        sys.exit("%s: no CUDA card" % tool)
    roots = {"other": os.path.abspath(args.other), "this": HERE}
    if not os.path.isfile(os.path.join(roots["other"], needs)):
        sys.exit("%s: %s holds no %s" % (tool, roots["other"], needs))
    runs, outs = [], []
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as tmp:
        path = os.path.join(tmp, "inputs.pt")
        torch.save(make_inputs(), path)
        for k, name in enumerate(side_order(args.pairs)):
            out = os.path.join(tmp, "answers_%d.pt" % k)
            res = subprocess.run(
                [sys.executable, "-c", side, path, str(args.reps),
                 str(args.rounds), out] + list(extra), cwd=roots[name],
                capture_output=True, text=True, timeout=900)
            if res.returncode:
                sys.stderr.write(res.stderr)
                sys.exit("%s: the %s side failed" % (tool, name))
            reading = json.loads(res.stdout.strip().splitlines()[-1])
            runs.append({"side": name, "readings": reading})
            outs.append(out)
            print("%s (%s): %s" % (name, roots[name], ", ".join(
                "%s %.4f" % kv for kv in reading["ms"].items())), flush=True)
            for kernel, lines in reading["ptxas"].items():
                for line in lines:
                    print("  %s ptxas %s: %s" % (name, kernel, line),
                          flush=True)
        bad = check(outs)
    libs = {r["side"]: r["readings"]["libs"] for r in runs}
    same = {name: compare_sass(libs["this"][name], libs["other"][name])
            for name in sass}
    for name, funcs in same.items():
        print("%s SASS: %s" % (name, json.dumps(funcs)), flush=True)
    summary, fastest = summarize(runs)
    print(json.dumps({"card": card(), "reps": args.reps,
                      "rounds": args.rounds, "pairs": args.pairs,
                      "median_ms": summary, "min_round_ms": fastest,
                      "answers_agree": not bad, "differ": bad, "sass": same,
                      "runs": runs}))
    if bad:
        sys.exit("%s: answers differ: %s" % (tool, ", ".join(bad)))
