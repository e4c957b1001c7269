"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled on first use with ``nvcc`` into its own shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch headers,
so a build takes seconds, not minutes). Libraries go to
``build/repro_torch_kernels/`` at the repository root (override with
``REPRO_TORCH_BUILD_DIR``) under a name that hashes the sources and flags,
so an edited kernel is rebuilt and never loaded stale. ``build()`` starts one
``nvcc`` per source, all at once. ``graph_kernel_names`` lists the kernels a
captured CUDA graph holds (read through libcuda), so a capture can check
that every launch went into it.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {
    "flash_decode": "flash_decode.cu",
    "flash_prefill": "flash_prefill.cu",
    "gate_residual": "gate_residual.cu",     # forward and backward
    "ln_modulate": "ln_modulate.cu",         # forward and backward
    "edm_loss": "edm_loss.cu",               # forward and backward
    "euler": "euler.cu",                     # forward and backward
    "flash_attention_fwd": "flash_attention_fwd.cu",
    "flash_attention_bwd": "flash_attention_bwd.cu",   # dq and dk/dv
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}   # loaded libraries, by kernel name


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parents[3] / "build" / "repro_torch_kernels"


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit (set CUDA_HOME)")
    return found


def lib_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / SOURCES[name]]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named kernels (default: all) that have no library yet,
    one ``nvcc`` process each, all started together. Returns {name:
    {"seconds", "log"}} for the builds made (``-Xptxas -v`` puts registers,
    shared memory and spills in the log); raises with the compiler's output
    if any build fails."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {}
    build_dir().mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = lib_path(n).with_suffix(f".tmp{os.getpid()}")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    failed, logs = [], {}
    for n, (tmp, p) in procs.items():
        log, _ = p.communicate()
        logs[n] = {"seconds": time.perf_counter() - t0, "log": log}
        if p.returncode != 0:
            failed.append(f"--- {n} (nvcc exit {p.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib_path(n))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed."""
    if name not in _LIBS:
        build([name])
        _LIBS[name] = ctypes.CDLL(str(lib_path(name)))
    return _LIBS[name]


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{rc}")


class _KernelNodeParams(ctypes.Structure):
    """libcuda's ``CUDA_KERNEL_NODE_PARAMS_v2``."""
    _fields_ = [("func", ctypes.c_void_p)]
    _fields_ += [(f"{a}{x}", ctypes.c_uint) for a in ("grid", "block")
                 for x in "XYZ"]
    _fields_ += [("shared_mem", ctypes.c_uint),
                 ("kernel_params", ctypes.c_void_p),
                 ("extra", ctypes.c_void_p), ("kern", ctypes.c_void_p),
                 ("ctx", ctypes.c_void_p)]


def _cu(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUresult {rc}")


@functools.lru_cache(maxsize=None)
def _libcuda() -> ctypes.CDLL:
    """libcuda with the graph-reading calls declared."""
    cu = ctypes.CDLL("libcuda.so.1")
    P, R = ctypes.c_void_p, ctypes.POINTER
    for name, args in (
            ("cuGraphGetNodes", [P, P, R(ctypes.c_size_t)]),
            ("cuGraphNodeGetType", [P, R(ctypes.c_int)]),
            ("cuGraphKernelNodeGetParams_v2", [P, R(_KernelNodeParams)]),
            ("cuFuncGetName", [R(ctypes.c_char_p), P]),
            ("cuKernelGetName", [R(ctypes.c_char_p), P])):
        fn = getattr(cu, name)
        fn.argtypes, fn.restype = args, ctypes.c_int
    return cu


def graph_kernel_names(cuda_graph) -> list:
    """The (mangled) names of the kernel nodes of a captured
    ``torch.cuda.CUDAGraph`` made with ``keep_graph=True`` and not yet
    instantiated, read through libcuda (kernels of every CUDA runtime
    in the process, ours linked statically included)."""
    cu = _libcuda()
    graph = cuda_graph.raw_cuda_graph()
    n = ctypes.c_size_t(0)
    _cu(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _cu(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        _cu(cu.cuGraphNodeGetType(node, ctypes.byref(kind)),
            "cuGraphNodeGetType")
        if kind.value != 0:                    # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        p = _KernelNodeParams()
        _cu(cu.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(p)),
            "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if p.func:
            _cu(cu.cuFuncGetName(ctypes.byref(name), p.func),
                "cuFuncGetName")
        else:
            _cu(cu.cuKernelGetName(ctypes.byref(name), p.kern),
                "cuKernelGetName")
        names.append(name.value.decode())
    return names
