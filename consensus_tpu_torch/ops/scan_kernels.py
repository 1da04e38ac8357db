"""Hand-written scan kernels and their plain torch versions.

Port of the scan kernels in ``consensus_tpu/ops/pallas_scan.py``: the
Ed25519 Horner scan (``horner_scan``, TPU body ``_scan_kernel``) and the
P-256 Horner scan (``horner_scan_p256``, TPU body ``_scan_kernel_p256``).
The Straus MSM comes in a later slice.

Each wrapper dispatches on the tensors it is given: on a CUDA tensor it
launches its kernel from ``consensus_tpu_torch/csrc/`` or raises; on a CPU
tensor it runs its plain torch version (``horner_scan_reference``,
``horner_scan_p256_reference``).  Every kernel is built by one helper: nvcc
for ``sm_90a`` on first use, into ``csrc/build/`` keyed by a hash of the
source, loaded through ctypes; a build or load failure raises.

``launches`` and ``launches_p256`` count kernel launches (the plain versions
are not counted), so a caller can show that its path went through the
kernels.
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
from consensus_tpu_torch.ops import p256

_TABLE = 9  # |signed digit| <= 8 -> multiples 0..8 of the variable point
_WINDOWS = 64
_WINDOWS_P256 = 65  # 64 windows of a 256-bit scalar plus the recoding carry

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCE = _CSRC / "horner_scan.cu"
BUILD_DIR = _CSRC / "build"

#: The kernels of this module: name -> (source, number of pointer arguments
#: of its C launch function, inputs then outputs).
KERNELS = {
    "horner_scan": (_SOURCE, 9),
    "horner_scan_p256": (_CSRC / "horner_scan_p256.cu", 6),
}

#: Kernel launches made by :func:`horner_scan` in this process.
launches = 0
#: Kernel launches made by :func:`horner_scan_p256` in this process.
launches_p256 = 0


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    """How a kernel library was obtained: the nvcc command, its wall time
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
            "scan kernels: nvcc not found (looked in $CUDA_HOME/bin, "
            "/usr/local/cuda/bin and PATH); the CUDA kernels cannot be built"
        )
    return found


@functools.lru_cache(maxsize=None)
def _library(name: str) -> tuple[ctypes.CDLL, BuildInfo]:
    """Build (once per source content) and load the library of kernel
    ``name``, and declare its C entry points ``<name>_launch`` (the
    pointers, then batch, device and stream) and ``<name>_error_string``."""
    source_path, n_pointers = KERNELS[name]
    source = source_path.read_bytes()
    tag = hashlib.sha256(source).hexdigest()[:16]
    lib_path = BUILD_DIR / f"{name}-{tag}.so"
    command = ""
    seconds = 0.0
    ptxas = ""
    cached = lib_path.is_file()
    if not cached:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f".{name}-{tag}-{os.getpid()}.so"
        cmd = [
            _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", str(tmp), str(source_path),
        ]
        command = " ".join(cmd)
        start = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - start
        ptxas = (proc.stdout + proc.stderr).strip()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed ({command}):\n{ptxas}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    launch = getattr(lib, f"{name}_launch")
    launch.argtypes = [ctypes.c_void_p] * n_pointers + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    launch.restype = ctypes.c_int
    error_string = getattr(lib, f"{name}_error_string")
    error_string.argtypes = [ctypes.c_int]
    error_string.restype = ctypes.c_char_p
    return lib, BuildInfo(str(lib_path), command, seconds, ptxas, cached)


def build(name: str = "horner_scan") -> BuildInfo:
    """Build and load kernel ``name``'s library now (it is otherwise built
    on the first CUDA launch); returns how it was obtained."""
    return _library(name)[1]


def _launch(name: str, inputs, outputs, batch: int, device: torch.device) -> None:
    """Launch kernel ``name`` on the current stream of ``device`` inside an
    op-scope profiler range, and raise if the launch was refused.

    The range is the kind inductor puts around its Triton launches: a
    profiler links device work only to op-scope ranges, so without it the
    kernel would belong to no range of a trace."""
    lib, _ = _library(name)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch._C._profiler._RecordFunctionFast(f"{name}_kernel"):
        code = getattr(lib, f"{name}_launch")(
            *(t.data_ptr() for t in inputs), *(o.data_ptr() for o in outputs),
            batch, device.index or 0, stream,
        )
    if code != 0:
        reason = getattr(lib, f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {reason} ({code})")


def _check_inputs(
    name: str, coords: dict[str, torch.Tensor], digits: torch.Tensor, windows: int
) -> int:
    """Check what the kernel ``name`` takes -- float32 (32, batch)
    coordinates, int32 (windows, batch) digits, one device, contiguous --
    and return the batch."""
    first = next(iter(coords.values()))
    batch = first.shape[-1] if first.dim() == 2 else -1
    for label, t in coords.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {label} must be float32, got {t.dtype}")
        if t.shape != (fe.LIMBS, batch):
            raise ValueError(
                f"{name}: {label} must be ({fe.LIMBS}, batch), got "
                f"{tuple(t.shape)} against batch {batch}"
            )
    if digits.dtype != torch.int32:
        raise TypeError(f"{name}: digits must be int32, got {digits.dtype}")
    if digits.shape != (windows, batch):
        raise ValueError(
            f"{name}: digits must be ({windows}, {batch}), got {tuple(digits.shape)}"
        )
    for t in (*coords.values(), digits):
        if t.device != first.device:
            raise ValueError(f"{name}: all inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {first.device}")
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
    batch = _check_inputs(
        "horner_scan", dict(zip(("neg_a_x", "neg_a_y", "neg_a_z", "neg_a_t"), coords)),
        k_digits, _WINDOWS,
    )
    device = neg_a_x.device
    if device.type == "cpu":
        return horner_scan_reference(*coords, k_digits)
    outs = [torch.empty_like(neg_a_x) for _ in range(4)]
    _launch("horner_scan", (*coords, k_digits), outs, batch, device)
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


def horner_scan_p256(
    qx: torch.Tensor,         # (32, batch) f32 -- Q's affine coordinates
    qy: torch.Tensor,
    u2_digits: torch.Tensor,  # (65, batch) int32, digit + 8, MSB first
) -> p256.Point:
    """[u2]Q per lane on P-256.

    Coordinates follow the P-256 field module's weak-reduction contract (the
    engine passes bytes); digits are 65 signed 4-bit windows stored as d + 8
    (the first window holds the recoding carry).  On CUDA the result is the
    same projective point as the plain version's, written as canonical
    limbs; on the CPU it is the plain version's output."""
    global launches_p256
    batch = _check_inputs(
        "horner_scan_p256", {"qx": qx, "qy": qy}, u2_digits, _WINDOWS_P256
    )
    device = qx.device
    if device.type == "cpu":
        return horner_scan_p256_reference(qx, qy, u2_digits)
    outs = [torch.empty_like(qx) for _ in range(3)]
    _launch("horner_scan_p256", (qx, qy, u2_digits), outs, batch, device)
    launches_p256 += 1
    return p256.Point(*outs)


def horner_scan_p256_reference(
    qx: torch.Tensor, qy: torch.Tensor, u2_digits: torch.Tensor
) -> p256.Point:
    """The plain torch version of the P-256 kernel: a port of
    ``_scan_kernel_p256``.

    Table j*Q, j = 0..8 (identity, Q, then 7 sequential complete adds);
    identity as the initial accumulator; per window 4 doubles, a one-hot
    table lookup, a conditional negate and a complete add."""
    q = p256.affine_like(qx, qy)
    table = p256.multiples_table(q, _TABLE)
    lanes = torch.arange(_TABLE, dtype=torch.int32, device=qx.device)[:, None]
    acc = p256.identity_like(qx)
    for w in range(_WINDOWS_P256):
        d = u2_digits[w].to(torch.int32) - 8  # in [-8, 7]; {0, 1} in the carry window
        one_hot = (d.abs()[None] == lanes).to(torch.float32)  # (9, batch)
        for _ in range(4):
            acc = p256.double(acc)
        t = p256.table_lookup(table, one_hot)
        t = p256.select(d < 0, p256.negate(t), t)
        acc = p256.add(acc, t)
    return acc


__all__ = [
    "BUILD_DIR",
    "BuildInfo",
    "KERNELS",
    "build",
    "horner_scan",
    "horner_scan_p256",
    "horner_scan_p256_reference",
    "horner_scan_reference",
    "launches",
    "launches_p256",
]
