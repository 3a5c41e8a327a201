"""Build the port's CUDA kernels into one shared library, at first use.

Every `csrc/*.cu` compiles with its own `nvcc` process (all started
together) for `sm_90a`, then one link step makes
`_build/libconsul_kernels-<hash>.so`.  The hash covers every source and
the flags, so an edited source rebuilds and an unchanged tree reuses the
library.  Only the sources in this directory are built; a failed
compile raises with nvcc's output.

`sass_census` compiles one source once per value of a macro into cubins
and counts a kernel's SASS instructions in each (`cuobjdump -sass`): the
operation counts behind K1's bounds.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# seconds the last build() in this process spent compiling (0 on reuse)
last_build_seconds = 0.0
# ptxas register/spill report of the last compile, per source
ptxas_report: dict = {}


def _tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    default = f"/usr/local/cuda/bin/{name}"
    if os.path.exists(default):
        return default
    raise RuntimeError(f"{name} not found: the CUDA toolkit is needed to "
                       f"build consul_tpu_torch's kernels")


def _nvcc() -> str:
    return _tool("nvcc")


def _digest(sources) -> str:
    h = hashlib.sha256()
    for flag in ARCH + CFLAGS:
        h.update(flag.encode())
    for path in sources:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Path of the shared library, compiling it if the sources changed."""
    global last_build_seconds
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    lib = BUILD_DIR / f"libconsul_kernels-{_digest(sources + headers)}.so"
    if lib.exists():
        last_build_seconds = 0.0
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    work = BUILD_DIR / f"tmp-{os.getpid()}"
    work.mkdir(exist_ok=True)
    try:
        procs = []
        for src in sources:
            obj = work / (src.stem + ".o")
            cmd = [nvcc, *ARCH, *CFLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        errors = []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            ptxas_report[src.name] = out
            if proc.returncode != 0:
                errors.append(f"{src.name} (rc={proc.returncode}):\n{out}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp_lib = work / lib.name
        cmd = [nvcc, *ARCH, "-shared", "-o", str(tmp_lib),
               *[str(obj) for _, obj, _ in procs]]
        link = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed (rc={link.returncode}):\n"
                               f"{link.stdout}")
        os.replace(tmp_lib, lib)   # atomic: concurrent builders agree
    finally:
        shutil.rmtree(work, ignore_errors=True)
    last_build_seconds = time.perf_counter() - t0
    return lib


def variant(source: str, macro: str, value: int = 1) -> Path:
    """A shared library of csrc/`source` alone, compiled as build()
    compiles it with -D`macro`=value (an instrumented form of one kernel,
    for a measurement), reused while the source and flags are unchanged."""
    src = CSRC / source
    h = hashlib.sha256(f"{macro}={value}".encode())
    h.update(_digest([src, *sorted(CSRC.glob("*.cuh"))]).encode())
    lib = BUILD_DIR / f"{src.stem}-{macro}-{h.hexdigest()[:12]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *ARCH, *CFLAGS, f"-D{macro}={value}", "-shared",
           str(src), "-o", str(tmp)]
    out = subprocess.run(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source} with {macro}={value}:"
                           f"\n{out.stdout}")
    os.replace(tmp, lib)
    return lib


_SASS_LINE = re.compile(r"^\s*/\*[0-9a-f]+\*/\s+(.+?)\s*;")


def count_sass(listing: str, kernel: str) -> int:
    """Instructions of `kernel`'s body in a `cuobjdump -sass` listing: from
    its first instruction to the last EXIT before the first RET (the
    subroutines after the body, such as sqrtf's slow path, are not
    counted), NOPs left out."""
    ops, inside = [], False
    for line in listing.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        m = _SASS_LINE.match(line) if inside else None
        if m:
            words = m.group(1).split()
            if words[0].startswith("@"):        # predicate guard
                words = words[1:]
            ops.append(words[0])
    if not ops:
        raise ValueError(f"no SASS for {kernel} in the listing")
    end = next((i for i, op in enumerate(ops) if op.startswith("RET")),
               len(ops))
    exits = [i for i, op in enumerate(ops[:end]) if op == "EXIT"]
    if not exits:
        raise ValueError(f"{kernel}: no EXIT in its body")
    return sum(1 for op in ops[:exits[-1] + 1] if not op.startswith("NOP"))


def sass_census(source: str, macro: str, values, kernel: str) -> dict:
    """{value: SASS instructions of `kernel`'s body} with csrc/`source`
    compiled once per value of `macro` (-D`macro`=value), as build()
    compiles it; the compiles run together."""
    nvcc, cuobjdump = _nvcc(), _tool("cuobjdump")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = BUILD_DIR / f"census-{os.getpid()}"
    work.mkdir(exist_ok=True)
    try:
        procs = {}
        for v in values:
            cubin = work / f"{macro}-{v}.cubin"
            cmd = [nvcc, *ARCH, *CFLAGS, f"-D{macro}={v}", "-cubin",
                   str(CSRC / source), "-o", str(cubin)]
            procs[v] = (cubin, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        counts = {}
        for v, (cubin, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {source} with "
                                   f"{macro}={v}:\n{out}")
            sass = subprocess.run([cuobjdump, "-sass", str(cubin)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True,
                                  check=True).stdout
            counts[v] = count_sass(sass, kernel)
        return counts
    finally:
        shutil.rmtree(work, ignore_errors=True)
