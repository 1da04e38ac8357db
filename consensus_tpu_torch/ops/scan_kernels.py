"""Hand-written scan kernels and their plain torch versions.

Port of the three kernels in ``consensus_tpu/ops/pallas_scan.py``: the
Ed25519 Horner scan (``horner_scan``, TPU body ``_scan_kernel``), the P-256
Horner scan (``horner_scan_p256``, TPU body ``_scan_kernel_p256``) and the
randomized verifier's shared-doubling Straus MSM (``straus_msm``, TPU body
``_msm_kernel``).  The build registry :data:`KERNELS` also holds the port's
own kernels, which replace plain XLA of the JAX package: SHA-512 (S1, whose
wrapper is ``ops/sha512.py::sha512_blocks``), Ed25519 point decompression
(D1, :func:`decompress`), the fixed-base comb [S]B (D2,
:func:`fixed_base_mul_comb`) and the tensor-core field lane's products (M1,
whose wrappers are in ``ops/mxu_limbs.py``).

Each wrapper dispatches on the tensors it is given: on a CUDA tensor it
launches its kernel from ``consensus_tpu_torch/csrc/`` or raises; on a CPU
tensor it runs its plain torch version (``horner_scan_reference``,
``horner_scan_p256_reference``, ``straus_msm_reference``,
``decompress_reference``, ``fixed_base_mul_comb_reference``).  Every kernel is
built by one helper: nvcc for ``sm_90a`` on first use, into ``csrc/build/``
keyed by a hash of the source and of the headers beside it, loaded through
ctypes; a build or load failure raises.  A lock per kernel serializes its
first build and load, so threads that launch a kernel for the first time
together (a coalescer's flusher and a caller) run nvcc once.

Every launch is booked into the kernel ledger
(:data:`consensus_tpu_torch.obs.kernels.KERNELS`) under the kernel's name
(the plain versions are not launches), and every library obtained into
``COMPILE_CACHE`` (a miss where nvcc ran, a hit where an existing build was
loaded; the ledger's ``compiles`` counts the nvcc builds), so a caller can
show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

from consensus_tpu_torch.obs.kernels import COMPILE_CACHE
from consensus_tpu_torch.obs.kernels import KERNELS as LEDGER
from consensus_tpu_torch.ops import ed25519 as ed
from consensus_tpu_torch.ops import field25519 as fe
from consensus_tpu_torch.ops import limbs
from consensus_tpu_torch.ops import p256

_TABLE = 9  # |signed digit| <= 8 -> multiples 0..8 of the variable point
_WINDOWS = 64
_WINDOWS_P256 = 65  # 64 windows of a 256-bit scalar plus the recoding carry

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCE = _CSRC / "horner_scan.cu"
BUILD_DIR = _CSRC / "build"

#: The kernels of this module: name -> (source, number of pointer arguments
#: of its C launch function (inputs, then outputs and scratch), names of the
#: int arguments that follow the batch).
KERNELS = {
    "horner_scan": (_SOURCE, 9, ()),
    "horner_scan_p256": (_CSRC / "horner_scan_p256.cu", 6, ()),
    "straus_msm": (_CSRC / "straus_msm.cu", 15, ("n_low",)),
    # Kernel S1, SHA-512 for the fused front end; its wrapper is
    # ops/sha512.py::sha512_blocks.
    "sha512": (_CSRC / "sha512.cu", 3, ("block_count",)),
    # Kernels D1 and D2, decompression and the fixed-base comb of every
    # Ed25519 path.
    "decompress25519": (_CSRC / "decompress25519.cu", 7, ()),
    "comb25519": (_CSRC / "comb25519.cu", 6, ()),
    # Kernel M1, the tensor-core field lane's products; its wrapper is
    # ops/mxu_limbs.py (mul25519, square25519, mul_p256, square_p256).
    "mxu_limbs": (_CSRC / "mxu_limbs.cu", 3, ("curve", "a_bcast", "b_bcast")),
}

#: Loaded libraries, name -> (library, BuildInfo), and the lock that
#: serializes each kernel's first build and load.
_LIBRARIES: dict[str, tuple[ctypes.CDLL, "BuildInfo"]] = {}
_BUILD_LOCKS = {name: threading.Lock() for name in KERNELS}


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


def nvcc_command(source, output, *extra: str) -> list[str]:
    """The nvcc command every kernel library is built with: ``source`` for
    ``sm_90a`` into the shared library ``output``, with ptxas's report of
    registers, shared memory and spills; ``extra`` flags before the output
    (an include path, say)."""
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", *extra,
        "-o", str(output), str(source),
    ]


def _library(name: str) -> tuple[ctypes.CDLL, BuildInfo]:
    """The loaded library of kernel ``name``: built and loaded on the first
    call in this process, under the kernel's lock, so concurrent first
    callers wait for one build."""
    loaded = _LIBRARIES.get(name)
    if loaded is None:
        with _BUILD_LOCKS[name]:
            loaded = _LIBRARIES.get(name)
            if loaded is None:
                loaded = _LIBRARIES[name] = _build_and_load(name)
    return loaded


def _build_and_load(name: str) -> tuple[ctypes.CDLL, BuildInfo]:
    """Build (once per source content) and load the library of kernel
    ``name``, and declare its C entry points ``<name>_launch`` (the
    pointers, then batch, the kernel's int arguments, device and stream) and
    ``<name>_error_string``.  The build key covers the headers of ``csrc/``
    too, so an edited header never loads a stale library."""
    source_path, n_pointers, int_args = KERNELS[name]
    digest = hashlib.sha256(source_path.read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    tag = digest.hexdigest()[:16]
    lib_path = BUILD_DIR / f"{name}-{tag}.so"
    command = ""
    seconds = 0.0
    ptxas = ""
    cached = lib_path.is_file()
    if not cached:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f".{name}-{tag}-{os.getpid()}.so"
        cmd = nvcc_command(source_path, tmp)
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
    launch.argtypes = [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * (
        2 + len(int_args)
    ) + [ctypes.c_void_p]
    launch.restype = ctypes.c_int
    error_string = getattr(lib, f"{name}_error_string")
    error_string.argtypes = [ctypes.c_int]
    error_string.restype = ctypes.c_char_p
    COMPILE_CACHE.record(hit=cached)
    if not cached:
        LEDGER.record_compile(name)
    return lib, BuildInfo(str(lib_path), command, seconds, ptxas, cached)


def build(name: str = "horner_scan") -> BuildInfo:
    """Build and load kernel ``name``'s library now (it is otherwise built
    on the first CUDA launch); returns how it was obtained."""
    return _library(name)[1]


def _launch(
    name: str, inputs, outputs, batch: int, device: torch.device, int_args=()
) -> None:
    """Launch kernel ``name`` on the current stream of ``device`` inside an
    op-scope profiler range, and raise if the launch was refused.

    The range is the kind inductor puts around its Triton launches: a
    profiler links device work only to op-scope ranges, so without it the
    kernel would belong to no range of a trace.

    Inside a field-operation count (``limbs.counting()``) it raises: a
    hand-written kernel cannot note its operations, and a count that
    silently left them out would be wrong."""
    if limbs.counting():
        raise RuntimeError(
            f"{name}: a CUDA kernel cannot be counted by the field-operation "
            "shim; measure the plain version on CPU tensors"
        )
    lib, _ = _library(name)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch._C._profiler._RecordFunctionFast(f"{name}_kernel"):
        code = getattr(lib, f"{name}_launch")(
            *(t.data_ptr() for t in inputs), *(o.data_ptr() for o in outputs),
            batch, *int_args, device.index or 0, stream,
        )
    if code != 0:
        reason = getattr(lib, f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {reason} ({code})")


def _check_inputs(
    name: str,
    coords: dict[str, torch.Tensor],
    digits: dict[str, tuple[torch.Tensor, int]],
    per_lane: dict[str, torch.Tensor] | None = None,
) -> int:
    """Check what the kernel ``name`` takes -- float32 (32, batch)
    coordinates, int32 (windows, batch) digit arrays (label -> (array,
    windows)), int32 (batch,) per-lane values, one device, contiguous -- and
    return the batch."""
    per_lane = per_lane or {}
    first = next(iter(coords.values()), None)
    if first is None:
        first = next(iter(digits.values()))[0]
    batch = first.shape[-1] if first.dim() == 2 else -1
    for label, t in coords.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {label} must be float32, got {t.dtype}")
        if t.shape != (fe.LIMBS, batch):
            raise ValueError(
                f"{name}: {label} must be ({fe.LIMBS}, batch), got "
                f"{tuple(t.shape)} against batch {batch}"
            )
    for label, (d, windows) in digits.items():
        if d.dtype != torch.int32:
            raise TypeError(f"{name}: {label} must be int32, got {d.dtype}")
        if d.shape != (windows, batch):
            raise ValueError(
                f"{name}: {label} must be ({windows}, {batch}), got {tuple(d.shape)}"
            )
    for label, v in per_lane.items():
        if v.dtype != torch.int32:
            raise TypeError(f"{name}: {label} must be int32, got {v.dtype}")
        if v.shape != (batch,):
            raise ValueError(f"{name}: {label} must be ({batch},), got {tuple(v.shape)}")
    for t in (*coords.values(), *(d for d, _ in digits.values()), *per_lane.values()):
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
    coords = (neg_a_x, neg_a_y, neg_a_z, neg_a_t)
    batch = _check_inputs(
        "horner_scan", dict(zip(("neg_a_x", "neg_a_y", "neg_a_z", "neg_a_t"), coords)),
        {"k_digits": (k_digits, _WINDOWS)},
    )
    device = neg_a_x.device
    if device.type == "cpu":
        return horner_scan_reference(*coords, k_digits)
    outs = [torch.empty_like(neg_a_x) for _ in range(4)]
    _launch("horner_scan", (*coords, k_digits), outs, batch, device)
    LEDGER.record_launch("horner_scan")
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
    batch = _check_inputs(
        "horner_scan_p256", {"qx": qx, "qy": qy}, {"u2_digits": (u2_digits, _WINDOWS_P256)}
    )
    device = qx.device
    if device.type == "cpu":
        return horner_scan_p256_reference(qx, qy, u2_digits)
    outs = [torch.empty_like(qx) for _ in range(3)]
    _launch("horner_scan_p256", (qx, qy, u2_digits), outs, batch, device)
    LEDGER.record_launch("horner_scan_p256")
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


def straus_msm(
    neg_a: ed.Point,          # four (32, batch) f32 coordinates of (-A)
    neg_r: ed.Point,          # four (32, batch) f32 coordinates of (-R)
    zk_digits: torch.Tensor,  # (64, batch) int32, digit + 8, MSB first
    z_digits: torch.Tensor,   # (n_low, batch) int32, digit + 8, MSB first
) -> ed.Point:
    """sum_i [zk_i](-A_i) + sum_i [z_i](-R_i) over every lane, as one
    (32, 1) point.

    The z digits cover the last ``n_low`` (<= 64) windows of the zk digits'
    schedule; a lane whose digits are all 8 contributes the identity.  On
    CUDA the result is the plain version's group element as canonical limbs
    of another projective representative (compare it in affine
    coordinates); on the CPU it is the plain version's output."""
    n_low = z_digits.shape[0] if z_digits.dim() == 2 else -1
    if not 0 <= n_low <= _WINDOWS:
        raise ValueError(
            f"straus_msm: z_digits must be (n_low <= {_WINDOWS}, batch), got "
            f"{tuple(z_digits.shape)}"
        )
    coords = {f"neg_a_{c}": v for c, v in zip("xyzt", neg_a)}
    coords.update({f"neg_r_{c}": v for c, v in zip("xyzt", neg_r)})
    batch = _check_inputs(
        "straus_msm", coords,
        {"zk_digits": (zk_digits, _WINDOWS), "z_digits": (z_digits, n_low)},
    )
    device = neg_a.x.device
    if device.type == "cpu":
        return straus_msm_reference(neg_a, neg_r, zk_digits, z_digits)
    scratch = torch.empty(_msm_scratch_words(batch, n_low), dtype=torch.int64, device=device)
    outs = [torch.empty((fe.LIMBS, 1), dtype=torch.float32, device=device) for _ in range(4)]
    _launch(
        "straus_msm", (*neg_a, *neg_r, zk_digits, z_digits), (scratch, *outs),
        batch, device, (n_low,),
    )
    LEDGER.record_launch("straus_msm")
    return ed.Point(*outs)


def _msm_scratch_words(batch: int, n_low: int) -> int:
    """int64 words of the Straus MSM kernel's scratch (its tables, partial
    sums and window sums), from the CUDA source, which alone knows the
    layout."""
    lib, _ = _library("straus_msm")
    words = lib.straus_msm_scratch_words
    words.argtypes = [ctypes.c_longlong, ctypes.c_int]
    words.restype = ctypes.c_longlong
    return words(batch, n_low)


def straus_msm_reference(
    neg_a: ed.Point, neg_r: ed.Point, zk_digits: torch.Tensor, z_digits: torch.Tensor
) -> ed.Point:
    """The plain torch version of the kernel: both points' 9-entry tables by
    ``multiples_table9``, then the shared-doubling ``straus_shared_msm`` --
    the JAX package's default path for the randomized verifier."""
    return ed.straus_shared_msm(
        ed.multiples_table9(neg_a), ed.multiples_table9(neg_r), zk_digits, z_digits
    )


# --- kernels D1 and D2: decompression and the fixed-base comb ---------------------

#: The plain torch versions of D1 and D2: the port's ops, unchanged (held
#: limb for limb to the JAX package's plain XLA).
decompress_reference = ed.decompress
fixed_base_mul_comb_reference = ed.fixed_base_mul_comb

_COMB_WINDOWS = 32
_RADIX51 = (1 << 51) - 1


def decompress(y_limbs: torch.Tensor, sign: torch.Tensor) -> tuple[ed.Point, torch.Tensor]:
    """RFC 8032 section 5.1.3 decompression per lane: (point with Z = 1 and
    T = xy, valid mask).

    ``y_limbs`` is (32, m) float32 in the field module's weak contract (the
    engines pass bytes, y >= p included), ``sign`` (m,) int32.  On CUDA the
    point is the plain version's as canonical limbs (Y is y mod p) and the
    mask a bool tensor; on the CPU it is the plain version's output."""
    m = _check_inputs("decompress25519", {"y_limbs": y_limbs}, {}, {"sign": sign})
    device = y_limbs.device
    if device.type == "cpu":
        return ed.decompress(y_limbs, sign)
    outs = [torch.empty_like(y_limbs) for _ in range(4)]
    valid = torch.empty(m, dtype=torch.bool, device=device)
    _launch("decompress25519", (y_limbs, sign), (*outs, valid), m, device)
    LEDGER.record_launch("decompress25519")
    return ed.Point(*outs), valid


def fixed_base_mul_comb(s_digits8: torch.Tensor) -> ed.Point:
    """[S]B per lane from (32, n) int32 8-bit window digits (bytes 0-255),
    LSB window first.  On CUDA the result is the plain version's projective
    point as canonical limbs; on the CPU it is the plain version's output."""
    n = _check_inputs("comb25519", {}, {"s_digits8": (s_digits8, _COMB_WINDOWS)})
    device = s_digits8.device
    if device.type == "cpu":
        return ed.fixed_base_mul_comb(s_digits8)
    outs = [
        torch.empty((fe.LIMBS, n), dtype=torch.float32, device=device) for _ in range(4)
    ]
    _launch("comb25519", (comb_niels_table(device), s_digits8), outs, n, device)
    LEDGER.record_launch("comb25519")
    return ed.Point(*outs)


@functools.lru_cache(maxsize=1)
def comb_niels_np() -> np.ndarray:
    """Kernel D2's table: entry [j][d] of the plain version's comb table
    (``d * 2^(8j) * B``, affine) in the Niels form (y - x, y + x, 2d x y),
    each coordinate 5 radix-2^51 limbs, as a (32, 256, 3, 5) uint64 array."""

    def ints(arr: np.ndarray) -> list[int]:
        rows = arr.astype(np.uint8).reshape(-1, fe.LIMBS)
        return [int.from_bytes(row.tobytes(), "little") for row in rows]

    xs, ys, ts = (ints(a) for a in ed._comb_table_np())
    words = [
        (v >> (51 * i)) & _RADIX51
        for x, y, t in zip(xs, ys, ts)
        for v in ((y - x) % fe.P, (y + x) % fe.P, fe.D2 * t % fe.P)
        for i in range(5)
    ]
    return np.array(words, dtype=np.uint64).reshape(_COMB_WINDOWS, 256, 3, 5)


@functools.lru_cache(maxsize=None)
def comb_niels_table(device) -> torch.Tensor:
    """:func:`comb_niels_np` on ``device`` as int64 (the same bits), built
    once per device."""
    return torch.from_numpy(comb_niels_np().view(np.int64)).to(torch.device(device))


__all__ = [
    "BUILD_DIR",
    "BuildInfo",
    "KERNELS",
    "build",
    "comb_niels_np",
    "comb_niels_table",
    "decompress",
    "decompress_reference",
    "fixed_base_mul_comb",
    "fixed_base_mul_comb_reference",
    "horner_scan",
    "horner_scan_p256",
    "horner_scan_p256_reference",
    "horner_scan_reference",
    "straus_msm",
    "straus_msm_reference",
]
