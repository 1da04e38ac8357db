"""Hand-written scan kernels and their plain torch versions.

Port of the scan kernels in ``consensus_tpu/ops/pallas_scan.py``.  This
module holds the Ed25519 Horner scan (``horner_scan``, TPU body
``_scan_kernel``); the P-256 scan and the Straus MSM come in later slices.

``horner_scan`` dispatches on the tensors it is given: on a CUDA tensor it
launches the kernel in ``consensus_tpu_torch/csrc/horner_scan.cu`` or
raises; on a CPU tensor it runs ``horner_scan_reference``, the plain torch
port of ``_scan_kernel``.  The kernel is built with nvcc for ``sm_90a`` on
first use into ``csrc/build/`` and loaded through ctypes; a build or load
failure raises.

``launches`` counts kernel launches (the plain version is not counted), so
a caller can show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from consensus_tpu_torch.ops import ed25519 as ed
from consensus_tpu_torch.ops import field25519 as fe

_TABLE = 9  # |signed digit| <= 8 -> multiples 0..8 of the variable point
_WINDOWS = 64

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCE = _CSRC / "horner_scan.cu"
BUILD_DIR = _CSRC / "build"

#: Kernel launches made by :func:`horner_scan` in this process.
launches = 0


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    """How the kernel library was obtained: the nvcc command, its wall time
    (0 when an existing build of the same source was loaded), and what
    ``-Xptxas -v`` reported (registers, spills, local memory)."""

    library: str
    command: str
    seconds: float
    ptxas: str
    cached: bool


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "horner_scan: nvcc not found (looked in $CUDA_HOME/bin, "
            "/usr/local/cuda/bin and PATH); the CUDA kernel cannot be built"
        )
    return found


@functools.lru_cache(maxsize=1)
def _library() -> tuple[ctypes.CDLL, BuildInfo]:
    """Build (once per source content) and load the kernel library."""
    source = _SOURCE.read_bytes()
    tag = hashlib.sha256(source).hexdigest()[:16]
    lib_path = BUILD_DIR / f"horner_scan-{tag}.so"
    command = ""
    seconds = 0.0
    ptxas = ""
    cached = lib_path.is_file()
    if not cached:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f".horner_scan-{tag}-{os.getpid()}.so"
        cmd = [
            _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", str(tmp), str(_SOURCE),
        ]
        command = " ".join(cmd)
        start = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - start
        ptxas = (proc.stdout + proc.stderr).strip()
        if proc.returncode != 0:
            raise RuntimeError(f"horner_scan: nvcc failed ({command}):\n{ptxas}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    lib.horner_scan_launch.argtypes = [ctypes.c_void_p] * 9 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.horner_scan_launch.restype = ctypes.c_int
    lib.horner_scan_error_string.argtypes = [ctypes.c_int]
    lib.horner_scan_error_string.restype = ctypes.c_char_p
    return lib, BuildInfo(str(lib_path), command, seconds, ptxas, cached)


def build() -> BuildInfo:
    """Build and load the kernel library now (it is otherwise built on the
    first CUDA launch); returns how it was obtained."""
    return _library()[1]


def _check_inputs(coords: tuple[torch.Tensor, ...], k_digits: torch.Tensor) -> int:
    batch = coords[0].shape[-1] if coords[0].dim() == 2 else -1
    for name, t in zip("xyzt", coords):
        if t.dtype != torch.float32:
            raise TypeError(f"horner_scan: neg_a_{name} must be float32, got {t.dtype}")
        if t.shape != (fe.LIMBS, batch):
            raise ValueError(
                f"horner_scan: neg_a_{name} must be ({fe.LIMBS}, batch), got "
                f"{tuple(t.shape)} against batch {batch}"
            )
    if k_digits.dtype != torch.int32:
        raise TypeError(f"horner_scan: k_digits must be int32, got {k_digits.dtype}")
    if k_digits.shape != (_WINDOWS, batch):
        raise ValueError(
            f"horner_scan: k_digits must be ({_WINDOWS}, {batch}), got "
            f"{tuple(k_digits.shape)}"
        )
    for t in (*coords, k_digits):
        if t.device != coords[0].device:
            raise ValueError("horner_scan: all inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError("horner_scan: inputs must be contiguous")
    return batch


def horner_scan(
    neg_a_x: torch.Tensor,   # (32, batch) f32 -- the four (-A) coordinates
    neg_a_y: torch.Tensor,
    neg_a_z: torch.Tensor,
    neg_a_t: torch.Tensor,
    k_digits: torch.Tensor,  # (64, batch) int32, digit + 8, MSB first
) -> ed.Point:
    """[k](-A) per lane.

    Inputs follow the field module's weak-reduction contract; digits are
    signed 4-bit windows stored as d + 8 with d in [-8, 7].  On CUDA the
    result is the same projective point as the plain version's, written as
    canonical limbs; on the CPU it is the plain version's output."""
    global launches
    coords = (neg_a_x, neg_a_y, neg_a_z, neg_a_t)
    batch = _check_inputs(coords, k_digits)
    device = neg_a_x.device
    if device.type == "cpu":
        return horner_scan_reference(*coords, k_digits)
    if device.type != "cuda":
        raise ValueError(f"horner_scan: unsupported device {device}")
    lib, _ = _library()
    outs = [torch.empty_like(neg_a_x) for _ in range(4)]
    stream = torch.cuda.current_stream(device).cuda_stream
    # An op-scope profiler range, as inductor puts around its Triton launches:
    # a profiler links device work only to op-scope ranges, so without it the
    # kernel would belong to no range of a trace.
    with torch._C._profiler._RecordFunctionFast("horner_scan_kernel"):
        code = lib.horner_scan_launch(
            *(t.data_ptr() for t in coords), k_digits.data_ptr(),
            *(o.data_ptr() for o in outs), batch, device.index or 0, stream,
        )
    if code != 0:
        reason = lib.horner_scan_error_string(code).decode()
        raise RuntimeError(f"horner_scan: kernel launch failed: {reason} ({code})")
    launches += 1
    return ed.Point(*outs)


def horner_scan_reference(
    neg_a_x: torch.Tensor,
    neg_a_y: torch.Tensor,
    neg_a_z: torch.Tensor,
    neg_a_t: torch.Tensor,
    k_digits: torch.Tensor,
) -> ed.Point:
    """The plain torch version of the kernel: a port of ``_scan_kernel``.

    Table j*(-A), j = 0..8, by 7 sequential adds; identity as the initial
    accumulator; per window 3 doubles without T, 1 with T, a one-hot table
    lookup, a conditional negate and a complete add."""
    neg_a = ed.Point(neg_a_x, neg_a_y, neg_a_z, neg_a_t)
    table = ed.multiples_table(neg_a, _TABLE)
    lanes = torch.arange(_TABLE, dtype=torch.int32, device=neg_a_x.device)[:, None]
    acc = ed.identity_like(neg_a_x)
    for w in range(_WINDOWS):
        d = k_digits[w].to(torch.int32) - 8  # signed digit in [-8, 7]
        one_hot = (d.abs()[None] == lanes).to(torch.float32)  # (9, batch)
        for _ in range(3):
            acc = ed.double(acc, need_t=False)
        acc = ed.double(acc)
        q = ed.table_lookup(table, one_hot)
        q = ed.select(d < 0, ed.negate(q), q)
        acc = ed.add(acc, q)
    return acc


__all__ = ["BUILD_DIR", "BuildInfo", "build", "horner_scan", "horner_scan_reference", "launches"]
