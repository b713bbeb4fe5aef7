"""Build and load the port's CUDA kernels.

`nvcc` compiles every `csrc/*.cu` for sm_90a, one process per source, all
started together, and links the objects into one shared library with a
plain C interface, which is loaded with ctypes.  The library lands in
`base_tpu_torch/_build/` (git-ignored) under a name keyed on a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
reused.  The build runs at the first CUDA launch, never at import; a
missing `nvcc` or a failed build raises.  Ranks started together (torchrun)
build once: the build holds a lock file in `_build/`, and a rank that
waited on it finds the library built.  No `--use_fast_math`: the erf
polynomial, expf in the far tails and the 1e-15 / 1e-12 floors of the
marginal kernels need IEEE float32.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: tensor pointers, then int sizes, then device and stream
# (kernels 3 and 4 take the star sets' count after the four sizes).
_SIGNATURES = {
    "btt_table_fwd": [_P] * 9 + [_I] * 4 + [_I, _P],
    "btt_table_bwd": [_P] * 18 + [_I] * 4 + [_I, _P],
    "btt_marglik_fwd": [_P] * 8 + [_I] * 5 + [_I, _P],
    "btt_marglik_bwd": [_P] * 12 + [_I] * 5 + [_I, _P],
    "btt_marglik_mm_fwd": [_P] * 9 + [_I] * 4 + [_I, _P],
    "btt_marglik_mm_bwd": [_P] * 12 + [_I] * 4 + [_I, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for var in ("CUDA_HOME", "CUDA_PATH"):
        home = os.environ.get(var)
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels of base_tpu_torch cannot be built"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libbtt_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds) -> list[tuple[list[str], int, str]]:
    """Run the commands side by side; (command, exit code, output) each,
    after every process has ended."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    results = []
    for cmd, p in procs:
        text, _ = p.communicate()
        results.append((cmd, p.returncode, text))
    return results


def build() -> Path:
    """Compile csrc/ unless the library for these sources exists.  The
    compilers' output (ptxas register and shared-memory report) is kept
    beside the library as `<name>.log`."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            _compile(out)
    return out


def _compile(out: Path) -> None:
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, cmds = [], []
        for src in sorted(CSRC.glob("*.cu")):
            objs.append(str(Path(tmp) / f"{src.stem}.o"))
            cmds.append([nvcc, *NVCC_FLAGS, "-c", "-I", str(CSRC),
                         "-o", objs[-1], str(src)])
        results = _run_all(cmds)
        so = str(Path(tmp) / out.name)
        if all(rc == 0 for _, rc, _ in results):
            results += _run_all([[nvcc, *ARCH, "-shared", "-o", so, *objs]])
        out.with_suffix(".log").write_text("".join(
            " ".join(cmd) + "\n" + text for cmd, _, text in results))
        failed = [(cmd, rc, text) for cmd, rc, text in results if rc != 0]
        if failed:
            cmd, rc, text = failed[0]
            raise RuntimeError(
                f"nvcc failed ({rc}): {' '.join(cmd)}\n{text[-4000:]}")
        os.replace(so, out)  # atomic: a concurrent build sees all or none


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.btt_error_string.argtypes = [ctypes.c_int]
    lib.btt_error_string.restype = ctypes.c_char_p
    lib.btt_table_bwd_scratch.argtypes = [_I] * 4
    lib.btt_table_bwd_scratch.restype = ctypes.c_longlong
    lib.btt_marglik_mm_fwd_scratch.argtypes = [_I] * 3
    lib.btt_marglik_mm_fwd_scratch.restype = ctypes.c_longlong
    return lib


@functools.cache
def table_bwd_scratch(C: int, B: int, N: int, E2: int) -> int:
    """Floats of scratch kernel 2 needs for its per-tile partial sums."""
    return int(library().btt_table_bwd_scratch(C, B, N, E2))


@functools.cache
def marglik_mm_fwd_scratch(C: int, S: int, T: int) -> int:
    """Floats of scratch kernel 3m needs for its segment chunks' partial
    (max, sum): 0 where one chunk covers the segments."""
    return int(library().btt_marglik_mm_fwd_scratch(C, S, T))


def launch(name: str, tensors, sizes) -> None:
    """Launch C entry point `name` on the current CUDA stream of the
    tensors' device; raise if the launch was refused."""
    dev = tensors[0].device
    lib = library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = [t.data_ptr() for t in tensors] + [int(s) for s in sizes]
    status = getattr(lib, name)(*args, dev.index or 0, stream)
    if status != 0:
        msg = lib.btt_error_string(status).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({status})")


# Bands the kernels take (csrc/common.cuh MAX_B): more than the 29 filters
# of grids/filters.py, so any band set a run can name.
MAX_BANDS = 32


def check_bands(kind: str, B: int) -> None:
    """Raise unless the band count fits the kernels' band classes."""
    if B > MAX_BANDS:
        raise ValueError(f"{kind} kernels take at most {MAX_BANDS} bands, "
                         f"got {B}")


# The kernels put the chain axis on gridDim.y, which CUDA caps at 65535.
MAX_CHAINS = 65535


def check_chains(C: int) -> None:
    """Raise unless a launch's chain axis fits gridDim.y (no launch is
    split or clipped)."""
    if C > MAX_CHAINS:
        raise ValueError(
            f"{C} chains in one launch: the kernels take at most "
            f"{MAX_CHAINS} (gridDim.y); evaluate the chains in blocks")


def check(name: str, t: torch.Tensor, shape: tuple) -> None:
    """Raise unless `t` is a contiguous float32 CUDA tensor of `shape`."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
