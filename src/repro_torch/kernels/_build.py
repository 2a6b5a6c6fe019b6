"""Builds the port's CUDA kernels and binds them with ``ctypes``.

Every ``*/csrc/*.cu`` file of this package has a plain C entry point (no
PyTorch headers), so each compiles in seconds; headers shared between them
(``common/csrc/hopper.cuh``: TMA, mbarrier and wgmma helpers) sit beside
them under ``*/csrc/``. On first use, :func:`build` runs one ``nvcc`` per
``.cu`` source, all at once, then links the objects into one shared library
under ``<checkout>/build/kernels/``. The library's name carries a hash of
every file under ``*/csrc/`` and of the flags, so an edited source or header
is rebuilt and an unchanged tree is loaded as it is. The TMA tensor maps'
driver-API encoder is fetched at run time through the CUDA runtime's
entry-point query, so the link needs no ``-lcuda``. A failed build raises
with nvcc's stderr.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
BUILD_DIR = PKG_DIR.parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_lib = None
_functions: dict = {}
PTXAS: dict = {}   # source name -> ptxas' -v report of the last build here


def sources():
    """The ``.cu`` files, one object each."""
    return sorted(PKG_DIR.glob("*/csrc/*.cu"))


def hashed_files():
    """Every file the build reads: the sources and the headers they
    include."""
    return sorted(p for p in PKG_DIR.glob("*/csrc/*") if p.is_file())


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built on the machine that has the GPU")
    return path


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in hashed_files():
        h.update(str(src.relative_to(PKG_DIR)).encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_kernels-{h.hexdigest()[:16]}.so"


def build(verbose: bool = False, force: bool = False) -> Path:
    """Compile every source (in parallel) and link one shared library;
    returns its path. An existing library of the same hash is loaded as it
    is unless ``force``. ``verbose`` prints ptxas' register and
    shared-memory report of each kernel; the report is kept in ``PTXAS``
    either way."""
    so = library_path()
    if so.exists() and not force:
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in sources():
            obj = Path(tmp) / f"{src.parent.parent.name}_{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src),
                   "-o", str(obj)]
            jobs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        errors = []
        for src, _, proc in jobs:
            out, err = proc.communicate()
            if proc.returncode:
                errors.append(f"{src} (exit {proc.returncode}):\n{out}{err}")
                continue
            PTXAS[src.name] = err
            if verbose:
                print(f"[nvcc] {src.name}\n{err}", end="", flush=True)
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp_so = Path(tmp) / so.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *(str(o) for _, o, _ in jobs),
             "-o", str(tmp_so)], capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                               f"{link.stderr}")
        os.replace(tmp_so, so)
    return so


def function(name: str, argtypes):
    """The C entry point ``name`` of the kernel library (built on first
    use), with its ``argtypes`` declared and an int (cudaError_t) result."""
    global _lib
    if name not in _functions:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        fn = getattr(_lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return _functions[name]


def refuse_grad(name: str, *tensors) -> None:
    """The kernels have no backward: a wrapper called with grad mode on and
    an input that requires grad raises, rather than return a result with no
    ``grad_fn`` whose inputs would silently get no gradient. Training runs
    the plain attention, and the collector calls the kernels under
    ``torch.no_grad()``."""
    import torch
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the kernel has no backward; call it "
                           "under torch.no_grad() or with inputs that do not "
                           "require grad")


def chunking(T: int, V: int, n_sms: int, row_tile: int, vocab_tile: int,
             blocks_per_sm: int):
    """(vocab tiles per chunk, chunks) of a vocab-chunked grid: the vocab
    is split so that the grid of (row tiles x chunks) holds about
    ``blocks_per_sm`` blocks per SM, the kernel's occupancy. Each wrapper
    passes its own kernel's tile sizes and occupancy."""
    row_tiles = -(-T // row_tile)
    vocab_tiles = -(-V // vocab_tile)
    per_chunk = -(-vocab_tiles // max(1, (blocks_per_sm * n_sms)
                                      // row_tiles))
    return per_chunk, -(-vocab_tiles // per_chunk)


def n_chunks(V: int, vocab_tile: int, per_chunk: int) -> int:
    """Chunks of ``per_chunk`` vocab tiles that cover a vocabulary of V
    rows (the grid's second dimension)."""
    vocab_tiles = -(-V // vocab_tile)
    return -(-vocab_tiles // per_chunk)


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError_t {rc}")
