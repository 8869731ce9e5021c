"""Build, load and launch the port's CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  The build
happens at first use, all sources at once (one ``nvcc`` each, in parallel),
into ``build/mesh_tpu_torch/`` beside the package, under a name keyed by
the sources' and flags' digest, so an edited source never loads a stale
library.  Each library checked or built is logged as one
``torch.monitor`` event (a hit when it was on disk, a miss when ``nvcc``
ran, with its seconds), which ``obs/torch_bridge.py`` folds into the
metrics registry.  Each kernel declares its C argument types; a launch passes
tensors as device pointers, ints as ints and floats as C floats, on
PyTorch's current stream, and every launch's ``cudaGetLastError()`` is
checked: a non-zero code raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "build", "mesh_tpu_torch")

_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: kernel name -> (source file, C entry point, argument types before the
#: trailing stream)
KERNELS = {
    "closest_faces": ("closest_faces.cu", "mt_closest_faces",
                      [_PTR] * 8 + [_INT] * 6),
    "closest_faces_every": ("closest_faces_every.cu",
                            "mt_closest_faces_every",
                            [_PTR] * 3 + [_INT] * 6),
    "cull_records": ("cull_records.cu", "mt_cull_records",
                     [_PTR] * 2 + [_INT] * 5),
    "nearest_vertices": ("nearest_vertices.cu", "mt_nearest_vertices",
                         [_PTR] * 3 + [_INT] * 5),
    "nearest_vertices_every": ("nearest_vertices_every.cu",
                               "mt_nearest_vertices_every",
                               [_PTR] * 3 + [_INT] * 3),
    "culled_faces": ("culled_faces.cu", "mt_culled_faces",
                     [_PTR] * 10 + [_INT] * 9),
    "rope_faces": ("rope_faces.cu", "mt_rope_faces",
                   [_PTR] * 8 + [_INT] * 7),
    "rope_mxu_faces": ("rope_mxu_faces.cu", "mt_rope_mxu_faces",
                       [_PTR] * 10 + [_INT] * 8),
    "ray_any_hit": ("ray_any_hit.cu", "mt_ray_any_hit",
                    [_PTR] * 5 + [_INT] * 4 + [_FLOAT, _INT, _FLOAT]),
    "ray_any_hit_culled": ("ray_any_hit_culled.cu", "mt_ray_any_hit_culled",
                           [_PTR] * 8 + [_INT] * 5
                           + [_FLOAT, _INT, _FLOAT]),
    "alongnormal_faces": ("alongnormal_faces.cu", "mt_alongnormal_faces",
                          [_PTR] * 15 + [_INT] * 5),
    "alongnormal_faces_every": ("alongnormal_faces_every.cu",
                                "mt_alongnormal_faces_every",
                                [_PTR] * 4 + [_INT] * 3),
    "normal_weighted_faces": ("normal_weighted_faces.cu",
                              "mt_normal_weighted_faces",
                              [_PTR] * 13 + [_INT] * 5 + [_FLOAT]),
    "normal_weighted_faces_every": ("normal_weighted_faces_every.cu",
                                    "mt_normal_weighted_faces_every",
                                    [_PTR] * 4 + [_INT] * 4 + [_FLOAT]),
    "tri_tri_any_hit": ("tri_tri_any_hit.cu", "mt_tri_tri_any_hit",
                        [_PTR] * 6 + [_INT] * 5 + [_FLOAT] * 2),
    "tri_tri_any_hit_every": ("tri_tri_any_hit_every.cu",
                              "mt_tri_tri_any_hit_every",
                              [_PTR] * 3 + [_INT] * 3 + [_FLOAT] * 2),
    "tri_records": ("tri_records.cu", "mt_tri_records",
                    [_PTR] * 5 + [_INT] * 2),
    "self_intersect": ("self_intersect.cu", "mt_self_intersect",
                       [_PTR] * 6 + [_INT] * 4 + [_FLOAT] * 2),
    "leaf_boxes": ("leaf_boxes.cu", "mt_leaf_boxes", [_PTR] * 3 + [_INT] * 4),
    "leaf_boxes_warp": ("leaf_boxes_warp.cu", "mt_leaf_boxes_warp",
                        [_PTR] * 3 + [_INT] * 2),
    "mxu_faces": ("mxu_faces.cu", "mt_mxu_faces", [_PTR] * 11 + [_INT] * 5),
    "mxu_faces_every": ("mxu_faces_every.cu", "mt_mxu_faces_every",
                        [_PTR] * 3 + [_INT] * 5),
    "mxu_bound": ("mxu_bound.cu", "mt_mxu_bound", [_PTR] * 4 + [_INT] * 3),
    "mxu_bound_culled": ("mxu_bound_culled.cu", "mt_mxu_bound_culled",
                         [_PTR] * 12 + [_INT] * 5),
    "mxu_repair": ("mxu_repair.cu", "mt_mxu_repair",
                   [_PTR] * 12 + [_INT] * 6),
    "mxu_repair_every": ("mxu_repair_every.cu", "mt_mxu_repair_every",
                         [_PTR] * 6 + [_INT] * 5),
}

#: no FMA contraction and no fast math: the kernels round like the plain
#: PyTorch versions (see csrc/argmin.cuh)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LIBS = {}


#: where the CUDA toolkit puts nvcc when it is not on PATH
TOOLKIT_NVCC = "/usr/local/cuda/bin/nvcc"


def _nvcc():
    path = shutil.which("nvcc")
    if path is None and os.path.exists(TOOLKIT_NVCC):
        path = TOOLKIT_NVCC
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built at "
                           "first use and need the CUDA toolkit")
    return path


def _library_path(name):
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in sorted(os.listdir(_CSRC)):
        if fname.endswith(".cuh") or fname == KERNELS[name][0]:
            with open(os.path.join(_CSRC, fname), "rb") as fh:
                digest.update(fname.encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR, "%s-%s.so" % (name, digest.hexdigest()[:16]))


def _log_cache_event(name, hit, seconds):
    """One ``torch.monitor`` event for kernel library ``name``; whatever a
    registered handler raises is dropped, so monitoring never breaks a
    build."""
    import datetime

    from torch import monitor

    from .obs.torch_bridge import KERNEL_CACHE_EVENT

    try:
        monitor.log_event(monitor.Event(
            name=KERNEL_CACHE_EVENT, timestamp=datetime.datetime.now(),
            data={"library": name, "hit": bool(hit),
                  "seconds": float(seconds)}))
    except Exception:
        pass


def build(verbose=False):
    """Compile every kernel whose library is missing, all in parallel.

    Returns ``{name: {"seconds": s, "ptxas": text}}`` for the kernels built
    now (``ptxas`` holds ``-Xptxas -v``'s register and shared-memory report
    when ``verbose``).  Raises with the compiler's output if one fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    report = {}
    try:
        for name, (source, _, _) in KERNELS.items():
            t0 = time.perf_counter()
            target = _library_path(name)
            if os.path.exists(target):
                _log_cache_event(name, True, time.perf_counter() - t0)
                continue
            tmp = "%s.%d.tmp" % (target, os.getpid())
            cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                   "-o", tmp, os.path.join(_CSRC, source)]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True),
                           tmp, target, time.perf_counter())
        for name, (proc, tmp, target, t0) in procs.items():
            text, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError("nvcc failed for %s (rc %d):\n%s"
                                   % (name, proc.returncode, text))
            os.replace(tmp, target)
            report[name] = {"seconds": time.perf_counter() - t0,
                            "ptxas": text}
            _log_cache_event(name, False, report[name]["seconds"])
    finally:
        for proc, tmp, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return report


def load(name):
    """The loaded ``ctypes`` library of kernel ``name``, built if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = _library_path(name)
            if not os.path.exists(path):
                build()
            lib = ctypes.CDLL(path)
            fn = getattr(lib, KERNELS[name][1])
            fn.argtypes = KERNELS[name][2] + [_PTR]
            fn.restype = ctypes.c_int
            lib.mt_error_string.argtypes = [ctypes.c_int]
            lib.mt_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def launch(name, device, *args):
    """Launch kernel ``name`` on the current stream of CUDA ``device``:
    each of ``args`` is a tensor (passed as its data pointer; the caller
    checks device, dtype, shape and contiguity), None (a null pointer), an
    int or a float, in the order of the kernel's C entry point."""
    lib = load(name)
    values = [a.data_ptr() if torch.is_tensor(a) else a if a is None
              else float(a) if isinstance(a, float) else int(a)
              for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, KERNELS[name][1])(*values, stream)
    if err != 0:
        raise RuntimeError("%s launch failed: CUDA error %d (%s)" % (
            name, err, lib.mt_error_string(err).decode()))
