"""Build and load the port's CUDA kernels.

The sources under ``radiorust_tpu_torch/csrc/`` compile with ``nvcc`` for
``sm_90a`` (one ``nvcc`` per source, all started together) and link into
one shared library with a plain C interface, loaded with ``ctypes``.  The
build happens at the first kernel launch, into
``build/radiorust_tpu_torch/<hash of the sources>/`` beside the package,
so a checkout builds everything it runs from its own sources.  Importing
this module needs no ``nvcc``; a launch without one raises.

Every C entry point returns ``cudaGetLastError()`` (as an int) after its
launches; :func:`check` raises on anything but 0.

:func:`on_cuda` is the one dispatch rule of every kernel wrapper: the
device of the tensors alone decides.  CUDA tensors launch the kernel or
raise; CPU tensors run the plain PyTorch version.  There is no fallback
and no switch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

__all__ = ["lib", "check", "stream_handle", "build_dir", "on_cuda",
           "f32_ptr"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_ROOT = Path(__file__).resolve().parents[2] / "build" / "radiorust_tpu_torch"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_NVCC_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_PLAN = [_P, _P, _I, _I]   # overlap-save tables, radices, passes, n2
_COLUMN_SCRATCH = [_P, _P]  # overlap-save column scratch planes, or null
# C signatures: argument types of every entry point (pointers and the
# stream as void*, sizes as int).
_SIGNATURES = {
    "rr_decimate": [_P, _I, _I, _P],        # DecimArgs*, R, G, stream
    "rr_mix_decimate": [_P, _I, _I, _P],
    "rr_decimate_wide": [_P, _P, _P],      # DecimArgs*, WideArgs*, stream
    "rr_mix_decimate_wide": [_P, _P, _P],  # DecimArgs*, MixWideArgs*, stream
    # DecimArgs*, WideArgs*, phase in, phase out, stream
    "rr_decimate_phase": [_P, _P, _P, _P, _P],
    "rr_overlap_save": ([_P, _P, _I, _P, _P, _I, _I, _I, _I] + _PLAN
                        + [_P] * 6 + [_I, _I, _I] + _COLUMN_SCRATCH + [_P]),
    "rr_demod_filter": ([_P] * 11 + [_I] * 3 + _PLAN + [_P] * 5 + [_I, _I]
                        + _COLUMN_SCRATCH + [_P]),
    "rr_filter_demod_filter": ([_P] * 17 + [_I] * 3 + _PLAN + [_P] * 7
                               + [_I, _I] + _COLUMN_SCRATCH + [_P]),
    # The cluster route of #5 and #6: the factor's stride after it.
    "rr_demod_filter_cluster": ([_P] * 8 + [_I] + [_P] + [_I] * 3 + _PLAN
                                + [_P] * 3 + [_I, _I] + [_P]),
    "rr_filter_demod_filter_cluster": ([_P] * 10 + [_I] + [_P] * 3
                                       + [_I] * 3 + _PLAN + [_P] * 5
                                       + [_I, _I] + [_P]),
    # The cluster route of #3: the arguments of the stage route's entry
    # without its scratch.
    "rr_overlap_save_cluster": ([_P, _P, _I, _P, _P, _I, _I, _I, _I] + _PLAN
                                + [_P] * 4 + [_I, _I, _I] + [_P]),
    "rr_cluster_occupancy": [_I, _I, _I],   # n1, n2, kind (#5, #6, #3)
    "rr_filter_bank": ([_P] * 4 + [_I] * 4 + _PLAN + [_P] * 8 + [_I, _I]
                       + _COLUMN_SCRATCH + [_P]),
    "rr_pfb_demod": [_P] * 3 + [_I] + [_P] * 3 + [_I] * 3 + [_P],
    "rr_pfb_demod_step": [_P] * 6 + [_I] + [_P] * 5 + [_I] * 3 + [_P],
    "rr_slew_scan": [_P] * 9 + [_I] * 4 + [_P],
    "rr_agc_scan": [_P] * 9 + [_I] * 4 + [_P],   # b, t, lanes, seg
    "rr_agc_step": [_P] * 7 + [_I] * 4 + [_P],
}

# Entry points of a development build only (``lib(defines)``).
_DEV_SIGNATURES = {
    "rr_slew_clocks": [_P] * 9 + [_I] * 3 + [_P, _P],   # RR_SCAN_CLOCKS
    "rr_cluster_clocks": [_P],                            # RR_OS_CLOCKS
    "rr_decim_clocks": [_P],                              # RR_DECIM_CLOCKS
    "rr_mix_wide_clocks": [_P],                           # RR_DECIM_CLOCKS
}

_libs = {}


def _sources():
    return sorted(list(_CSRC.glob("*.cu")) + list(_CSRC.glob("*.cuh")))


def _flags(defines=()):
    return _NVCC_FLAGS + [f"-D{d}" for d in defines]


def build_dir(defines=()) -> Path:
    """Where the library for the current sources (built with these
    preprocessor ``defines``) lives."""
    h = hashlib.sha256()
    for f in _sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(_flags(defines)).encode())
    return _ROOT / h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda): "
                       "the port's CUDA kernels cannot be built")


def _build(out: Path, defines=()) -> None:
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    srcs = [f for f in _sources() if f.suffix == ".cu"]
    objdir = Path(tempfile.mkdtemp(dir=out.parent))
    try:
        # One nvcc per source, all running at once; then one link.
        objs = [str(objdir / f"{f.stem}.o") for f in srcs]
        cmds = [[nvcc, *_flags(defines), "-c", "-o", o, str(f)]
                for o, f in zip(objs, srcs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for c in cmds]
        runs = [(c, *p.communicate(), p.returncode)
                for c, p in zip(cmds, procs)]
        # Link to a temporary name and rename: a concurrent process never
        # loads a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        if not any(rc for *_, rc in runs):
            link = [nvcc, *_ARCH, "-shared", "-o", tmp, *objs]
            res = subprocess.run(link, capture_output=True, text=True)
            runs.append((link, res.stdout, res.stderr, res.returncode))
        (out.parent / "build.log").write_text("".join(
            " ".join(c) + "\n" + so + se for c, so, se, _ in runs))
        failed = [(c, se, rc) for c, _, se, rc in runs if rc]
        if failed:
            os.unlink(tmp)
            c, se, rc = failed[0]
            raise RuntimeError(f"nvcc failed ({rc}): {' '.join(c)}\n{se}")
        os.replace(tmp, out)
    finally:
        shutil.rmtree(objdir, ignore_errors=True)


def lib(defines=()) -> ctypes.CDLL:
    """The loaded kernel library, built first if needed.  ``defines``
    (e.g. ``("RR_SCAN_CLOCKS",)``) selects a development build with those
    preprocessor macros set, in its own build directory; the kernels'
    wrappers use the build without."""
    defines = tuple(defines)
    if defines not in _libs:
        so = build_dir(defines) / "libradiorust_kernels.so"
        if not so.exists():
            _build(so, defines)
        handle = ctypes.CDLL(str(so))
        for name, argtypes in {**_SIGNATURES, **_DEV_SIGNATURES}.items():
            if name in _DEV_SIGNATURES and not hasattr(handle, name):
                continue
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[defines] = handle
    return _libs[defines]


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_handle(device) -> int:
    """PyTorch's current stream on ``device``, as a pointer value."""
    return torch.cuda.current_stream(device).cuda_stream


def on_cuda(*tensors: torch.Tensor) -> bool:
    """The dispatch rule of every kernel wrapper, decided by the device of
    its tensors alone: True on CUDA (launch the kernel), False on the CPU
    (run the plain version).  Mixed or other devices raise."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {dev}")


def f32_ptr(t: torch.Tensor, name: str) -> int:
    """Device pointer of a contiguous float32 CUDA tensor (raises on
    anything else: the kernels take no strides or other dtypes)."""
    if t.dtype != torch.float32 or not t.is_contiguous() or not t.is_cuda:
        raise ValueError(f"{name}: kernel takes a contiguous float32 CUDA "
                         f"tensor, got {t.dtype} on {t.device}, "
                         f"contiguous={t.is_contiguous()}")
    return t.data_ptr()
