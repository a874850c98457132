"""Build, load and launch the hand-written CUDA kernels.

The kernels live in ``repro_torch/csrc/*.cu`` behind a plain C interface.
At first use :func:`load_library` compiles each source with ``nvcc`` (all
of them at once, one process each), links them into one shared library
under ``repro_torch/_build/`` and loads it with ``ctypes``.  The library's
file name carries a digest of the sources and flags, so an edited source
is rebuilt and an unchanged one is loaded as it is.  Nothing here falls
back: a failed build or launch raises.

Every C entry point enqueues its kernel on the stream it is given (the
caller's current PyTorch stream), allocates nothing and returns
``cudaGetLastError()``; :func:`launch` raises on a non-zero code and only
then counts the launch in :data:`LAUNCHES`, and under the shapes of its
tensors in :data:`LAUNCH_SHAPES`.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

import torch

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
# No --use_fast_math: it flushes subnormals and approximates division,
# which the BFP8 codec's bit-exact contract cannot take.
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v")

#: C entry points ``smof_<name>``: one letter per argument before the
#: trailing stream, ``p`` a device pointer and ``i`` an int64.
SIGNATURES = {
    "streamed_matmul": "ppppiiii",
    "act_relu": "ppi",
    "act_relu_encode": "ppppii",
    "pool": "pppiii",
    "bfp8_dequant": "pppii",
    "conv2d": "pppiii",
    "dwconv": "pppiii",
    "bfp8_quant": "pppii",
    "pool_encode": "pppppiii",
    "conv2d_encode": "pppppiii",
    "conv2d_decode": "ppppiii",
    "conv2d_decode_encode": "ppppppiii",
    "dwconv_encode": "pppppiii",
    "dwconv_decode": "ppppiii",
    "dwconv_decode_encode": "ppppppiii",
    "pool_decode": "ppppiii",
    "pool_decode_encode": "ppppppiii",
    "act_relu_decode_encode": "pppppii",
    "act_relu_decode": "pppii",
}

#: Launches of each kernel since the last :func:`reset_launches`.
LAUNCHES: dict[str, int] = dict.fromkeys(SIGNATURES, 0)
#: The same launches by ``(name, shapes of its tensor arguments)``: the
#: shapes a run really gave each kernel.
LAUNCH_SHAPES: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: pathlib.Path
    build_s: float      # seconds spent in nvcc by this process (0: reused)
    log: str            # nvcc / ptxas output of that build


_LIBRARY: KernelLibrary | None = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    LAUNCH_SHAPES.clear()


def launches() -> dict[str, int]:
    return dict(LAUNCHES)


def launch_shapes() -> dict[tuple, int]:
    return dict(LAUNCH_SHAPES)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build(sources: list[pathlib.Path], target: pathlib.Path) -> str:
    """Compile every source in parallel, link, and move the library into
    place atomically (a concurrent build cannot see a half-written file)."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        try:
            for src in sources:
                obj = pathlib.Path(tmp) / f"{src.stem}.o"
                procs.append((src, obj, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            logs, failed = [], []
            for src, _, p in procs:
                out, _ = p.communicate()
                logs.append(f"== {src.name}\n{out}")
                if p.returncode:
                    failed.append(src.name)
        finally:
            for _, _, p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        lib = pathlib.Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(lib),
             *(str(obj) for _, obj, _ in procs)],
            capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                               f"{link.stderr}")
        os.replace(lib, target)
    return log


def load_library() -> KernelLibrary:
    """The kernel library, built from ``csrc/`` on first use."""
    global _LIBRARY
    if _LIBRARY is not None:
        return _LIBRARY
    sources = sorted(CSRC_DIR.glob("*.cu"))
    target = BUILD_DIR / f"libsmof_kernels_{_digest()}.so"
    build_s, log = 0.0, ""
    if not target.exists():
        t0 = time.perf_counter()
        log = _build(sources, target)
        build_s = time.perf_counter() - t0
    lib = ctypes.CDLL(str(target))
    for name, sig in SIGNATURES.items():
        fn = getattr(lib, f"smof_{name}")
        fn.argtypes = [ctypes.c_void_p if k == "p" else ctypes.c_int64
                       for k in sig] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.smof_error_string.argtypes = [ctypes.c_int]
    lib.smof_error_string.restype = ctypes.c_char_p
    _LIBRARY = KernelLibrary(lib=lib, path=target, build_s=build_s, log=log)
    return _LIBRARY


def check_operand(name: str, t: torch.Tensor, dtype: torch.dtype,
                  align: int = 16) -> None:
    """Refuse what a kernel cannot take: it reads raw, contiguous device
    memory with vector loads of ``align`` bytes."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data is not {align}-byte aligned")


def launch(name: str, *args) -> None:
    """Enqueue kernel ``name`` on the current stream of its first tensor's
    device; raise if it was refused, else count the launch."""
    lib = load_library().lib
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else int(a)
             for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, f"smof_{name}")(*cargs, stream)
    if code:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"{lib.smof_error_string(code).decode()}")
    LAUNCHES[name] += 1
    LAUNCH_SHAPES[(name, tuple(tuple(a.shape) for a in args
                               if isinstance(a, torch.Tensor)))] += 1

