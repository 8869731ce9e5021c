"""A world of CPU ranks under gloo for the port's parallel tests.

``run_world(n, cases, inputs)`` starts ``n`` processes, each running
``python tests/_torch_world.py <rank> ...``: the rank joins a gloo process
group (a file store in a temporary folder, or, with ``launcher=True``, the
environment a ``torchrun`` launcher sets, joined by the case itself),
calls ``cases(rank, n, inputs)`` (a function of a module that imports
torch, numpy and mesh_tpu_torch only) and writes what it returns.  The
world runs under one timeout; ranks that outlive it are killed.  Returns
every rank's result, in rank order; each also says whether ``jax`` got
imported into the rank.
"""

import importlib
import os
import pickle
import socket
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_world(n, cases, inputs, timeout=120, launcher=False):
    """Every rank's result of ``cases`` ("module:function") in a world of
    ``n`` gloo ranks on the CPU."""
    with tempfile.TemporaryDirectory() as folder:
        with open(os.path.join(folder, "inputs.pkl"), "wb") as fh:
            pickle.dump(inputs, fh)
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
        for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
            env.pop(name, None)
        if launcher:
            env.update(MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(_free_port()), WORLD_SIZE=str(n))
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(rank), str(n),
             cases, folder, "1" if launcher else "0"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=dict(env, RANK=str(rank)) if launcher else env, cwd=ROOT)
            for rank in range(n)]
        outs = []
        try:
            for proc in procs:
                outs.append(proc.communicate(timeout=timeout)[0])
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        results = []
        for rank, (proc, out) in enumerate(zip(procs, outs)):
            assert proc.returncode == 0, "rank %d rc=%s\n%s" % (
                rank, proc.returncode, out[-4000:])
            with open(os.path.join(folder, "out%d.pkl" % rank), "rb") as fh:
                results.append(pickle.load(fh))
        return results


def _rank_main(rank, n, cases, folder, launcher):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    if not launcher:
        dist.init_process_group(
            "gloo", init_method="file://" + os.path.join(folder, "store"),
            world_size=n, rank=rank)
    with open(os.path.join(folder, "inputs.pkl"), "rb") as fh:
        inputs = pickle.load(fh)
    module, name = cases.split(":")
    out = getattr(importlib.import_module(module), name)(rank, n, inputs)
    out["jax_imported"] = "jax" in sys.modules or any(
        m == "mesh_tpu" or m.startswith("mesh_tpu.") for m in sys.modules)
    with open(os.path.join(folder, "out%d.pkl" % rank), "wb") as fh:
        pickle.dump(out, fh)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
               sys.argv[5] == "1")
