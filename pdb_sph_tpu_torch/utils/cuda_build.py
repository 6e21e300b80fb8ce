"""Build the package's CUDA sources with nvcc and load them with ctypes.

`load_kernels()` compiles every `csrc/*.cu` of the package, one nvcc per
source and all started together (each with `-I csrc`, where the headers
they share live), and links the objects into one shared library with a
plain C interface, at first use, into `build/kernels/` under the
repository root (listed in `.gitignore`), and loads it. The library's
name carries a hash of the sources, the `csrc/*.cuh` headers and the
flags, so an edit of any of them rebuilds and an unchanged tree reuses the
last build. A missing nvcc or a failed build
raises; nothing falls back and nothing is fetched. Only the CUDA toolkit is
read from outside the repository.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

# sm_90a: Hopper with its architecture-specific instructions. No
# --use_fast_math: the pair math keeps IEEE division and the accurate rsqrtf.
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of every launcher: pointers and the stream as void*, so ctypes
# never truncates them to a 32-bit int
SIGNATURES = {
    # (pin, pout, ranges, seg_prefix, seg_len, partials, counters, n,
    #  chunks, own, constants..., evals, stream)
    "launch_density_lambda": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                              _F, _F, _F, _F, _F, _F, _F, _P, _P),
    "launch_density_rho": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                           _F, _F, _F, _P, _P),
    "launch_project": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                       _F, _F, _F, _F, _F, _P, _P),
    # the same without evals, then the pass's two switches before its
    # constants
    "launch_density_tc": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _F, _F, _F, _F, _F, _F, _F, _P),
    "launch_project_tc": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _F, _F, _F, _F, _F, _P),
    # (p, p_stride, last, last_stride, x, v, nonfinite, n, inv_dt, wall,
    #  keep, damp, strict, stream): csrc/pbf_finalize.cu
    "launch_finalize": (_P, _I, _P, _I, _P, _P, _P, _I, _F, _F, _F, _F, _I,
                        _P),
    # (sorted_cid, n_pad, chunks, own, ncells, width, ranges, cand, stream)
    # and (cand, chunks, seg, spare, seg_len, seg_prefix, total, overflow,
    # stream): csrc/pbf_plan.cu
    "launch_plan_windows": (_P, _I, _I, _I, _I, _I, _P, _P, _P),
    "launch_work_table": (_P, _I, _I, _I, _P, _P, _P, _P, _P),
}


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an existing build was reused
    log: str              # nvcc's output (ptxas register/smem report)

    def check(self, code: int, what: str) -> None:
        """Raise if a launcher returned a CUDA error."""
        if code != 0:
            msg = self.lib.pbf_error_string(code).decode()
            raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def find_nvcc() -> str:
    """nvcc on PATH or under $CUDA_HOME/bin (default /usr/local/cuda)."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.pathsep.join([os.environ.get("PATH", ""),
                            os.path.join(cuda_home, "bin")])
    nvcc = shutil.which("nvcc", path=path)
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found on PATH or in $CUDA_HOME/bin: the CUDA kernels "
            "cannot be built, and the port does not fall back to plain torch "
            "on a CUDA device")
    return nvcc


def _source_hash(sources: list[Path]) -> str:
    """Hash of the flags, `sources` and every header that a source may
    include: those of `csrc/` and those beside a source, which nvcc finds
    first (a variant header beside a variant source shadows csrc's)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    dirs = sorted({CSRC, *(src.parent for src in sources)})
    headers = [hdr for d in dirs for hdr in sorted(d.glob("*.cuh"))]
    for src in [*sources, *headers]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def compile_command(nvcc: str, src: Path, obj: Path) -> list[str]:
    """The nvcc command that compiles `src` into `obj`, with the package's
    headers on the include path."""
    return [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj),
            str(src)]


def ptxas_registers(log: str) -> list[str]:
    """"kernel<template arguments>: R registers" (with its spill stores
    where it has any) for each kernel in nvcc's `-Xptxas -v` log, the
    names read from their mangled form."""
    out, name, spill = [], "?", 0
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            m = re.search(r"(window_kernel|density_tc_kernel|"
                          r"project_tc_kernel|finalize_kernel|"
                          r"plan_windows_kernel|work_table_kernel)"
                          r"(?:I(.*?)EEv)?", entry.group(1))
            if m is None:
                name = entry.group(1)
            elif m.group(2) is None:
                name = m.group(1)
            else:
                name = (f"{m.group(1)}<"
                        + ",".join(re.findall(r"(?:Lb|Li|E)(\d+)E",
                                              m.group(2))) + ">")
            spill = 0
        stores = re.search(r"(\d+) bytes spill stores", line)
        if stores:
            spill = int(stores.group(1))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            out.append(f"{name}: {regs.group(1)} registers"
                       + (f", {spill} bytes spill stores" if spill else ""))
    return out


@functools.lru_cache(maxsize=1)
def load_kernels() -> KernelLibrary:
    """Build (if needed) and load the package's kernel library, once per
    process."""
    return build_library(sorted(CSRC.glob("*.cu")), BUILD_DIR)


def build_library(sources: list[Path], build_dir: Path) -> KernelLibrary:
    """Build `sources` into one library under `build_dir` (reusing a build
    of the same sources and flags) and load it. Every launcher of
    SIGNATURES that the library exports is bound."""
    out = build_dir / f"pbf_kernels_{_source_hash(sources)}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        nvcc = find_nvcc()
        build_dir.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        objs = [tmp.with_suffix(f".{i}.o") for i in range(len(sources))]
        t0 = time.perf_counter()
        try:
            procs = [subprocess.Popen(
                compile_command(nvcc, src, obj), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
                for src, obj in zip(sources, objs)]
            logs = [p.communicate()[0] for p in procs]
            log = "".join(logs)
            failed = [f"{src}: nvcc failed ({p.returncode}):\n{lg}"
                      for src, p, lg in zip(sources, procs, logs)
                      if p.returncode != 0]
            if not failed:
                cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                       *map(str, objs)]
                res = subprocess.run(cmd, capture_output=True, text=True)
                log += res.stdout + res.stderr
                if res.returncode != 0:
                    failed.append(f"link failed ({res.returncode}):\n"
                                  f"{' '.join(cmd)}\n{res.stdout}"
                                  f"{res.stderr}")
            if failed:
                tmp.unlink(missing_ok=True)
                raise RuntimeError("\n".join(failed))
            os.replace(tmp, out)
        finally:
            for obj in objs:
                obj.unlink(missing_ok=True)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is None:
            continue
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.pbf_error_string.argtypes = (ctypes.c_int,)
    lib.pbf_error_string.restype = ctypes.c_char_p
    # (stream, graph or NULL, long long counts[4]): csrc/pbf_graph.cu
    counts = getattr(lib, "pbf_graph_node_counts", None)
    if counts is not None:
        counts.argtypes = (_P, _P, ctypes.POINTER(ctypes.c_longlong))
        counts.restype = ctypes.c_int
    return KernelLibrary(lib=lib, path=out, build_seconds=seconds, log=log)
