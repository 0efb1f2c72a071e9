"""Build the CUDA sources of ``csrc/`` with ``nvcc`` into shared
libraries with a plain C interface (loaded with ``ctypes`` by the kernel
wrappers), and the host C++ sources (``lap.cpp``, the native assignment
oracle) with ``g++`` (``build_host``).

The library lands in ``build/mmmot_tpu_torch/`` at the repository root,
named by a hash of the source and the flags, so a second run reuses it.
It is written under a temporary name and renamed into place, so a
concurrent reader never sees a half-written file.  Nothing here runs at
import time: the first launch builds.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mmmot_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

build_logs: dict = {}      # name -> nvcc/ptxas output of this process's build


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default location ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME to the CUDA toolkit or put nvcc on "
        "PATH (the port's kernels are compiled on first use)")


def _compile(name: str, src: Path, compiler, flags) -> Path:
    """``compiler *flags -o <lib> src`` (if not built yet) into a library
    named by a hash of the source and the flags; returns its path."""
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join(flags).encode())
    out = BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".{out.name}.", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([compiler(), *flags, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{compiler.__name__} failed on {src} (exit "
                               f"{proc.returncode}):\n{proc.stderr}")
        build_logs[name] = proc.stderr
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` (if not built yet); returns the .so."""
    return _compile(name, CSRC / f"{name}.cu", find_nvcc, NVCC_FLAGS)


def find_gxx() -> str:
    """``$CXX``, else ``g++`` on ``PATH``."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: set CXX to a C++ compiler (the "
                           "native oracle is compiled on first use)")
    return cxx


def build_host(name: str) -> Path:
    """Compile the host source ``csrc/<name>.cpp`` with g++ (if not built
    yet); returns the .so.  No ``-march=native``: the library does not
    depend on the host that built it."""
    return _compile(name, CSRC / f"{name}.cpp", find_gxx, GXX_FLAGS)


def _kernel_label(mangled: str) -> str:
    """``products_kernel<bf16>`` for a mangled kernel template instance
    (``...15products_kernelI13__nv_bfloat16E...``), ``finish_kernel<f32,
    bias,16>`` for one whose bool argument is true and whose int argument
    is 16 (``...IfLb1ELi16EEE...``: the affinity kernel's mask-list slots
    in launch 1, a lane's entries of a line in launch 2;
    ``products_kernel<bf16,segments,128>`` for the products' instance of
    several correlation ops),
    ``bn_relu_kernel<bf16,pool,8>`` for the conv epilogue's pooled
    instance of 8 channels a thread,
    ``int8_conv_main_kernel<128,64,false>`` / ``int8_conv_stem_kernel<64>``
    for the int8 conv's instances and their arguments (output-channel
    tile, K bytes a stage, HALO: ``...ILi128ELi64ELb0EEEv...``), else the
    name itself."""
    m = re.search(r"(int8_conv_(?:main|stem)_kernel)I((?:L[ib]\d+E)+)E",
                  mangled)
    if m:
        args = [v if k == "i" else ("false", "true")[int(v)]
                for k, v in re.findall(r"L([ib])(\d+)E", m.group(2))]
        return f"{m.group(1)}<{','.join(args)}>"
    m = re.search(r"([a-z][a-z_]*_kernel)I(13__nv_bfloat16|f)(?:Lb([01])E)?"
                  r"(?:Li(\d+)E)?E", mangled)
    if m is None:
        return mangled
    flag = {"products_kernel": "segments",
            "bn_relu_kernel": "pool"}.get(m.group(1), "bias")
    flag = f",{flag}" if m.group(3) == "1" else ""
    n = f",{m.group(4)}" if m.group(4) else ""
    return f"{m.group(1)}<{'f32' if m.group(2) == 'f' else 'bf16'}{flag}{n}>"


def ptxas_summary(log: str) -> dict:
    """Per kernel of an ``nvcc -Xptxas -v`` log: registers, static shared
    memory (bytes), stack frame and spill stores/loads (bytes)."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = out.setdefault(_kernel_label(m.group(1)), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m:
            cur.update(registers=int(m.group(1)),
                       smem=int(m.group(2) or 0))
    return out


def sass_counts(sass: str, opcodes=("HMMA", "HGMMA")) -> dict:
    """Per kernel of a ``cuobjdump -sass`` listing, how many instructions
    have each opcode in ``opcodes``."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(_kernel_label(m.group(1)),
                                 dict.fromkeys(opcodes, 0))
            continue
        m = re.search(r"\*/\s+(?:@!?\w+\s+)?([A-Z][A-Z0-9]*)\b", line)
        if cur is not None and m and m.group(1) in cur:
            cur[m.group(1)] += 1
    return out


def disassemble(lib: Path):
    """``cuobjdump -sass`` of a built library, or None where the toolkit
    has no cuobjdump."""
    tool = Path(find_nvcc()).with_name("cuobjdump")
    if not tool.is_file():
        return None
    proc = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump failed on {lib}:\n{proc.stderr}")
    return proc.stdout
