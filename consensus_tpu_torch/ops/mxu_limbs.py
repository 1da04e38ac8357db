"""The tensor-core field lane (``CTPU_MXU_LIMBS=1``): GF(2^255-19) and
GF(p256) products as integer contractions, with kernel M1 on the card.

Torch port of ``consensus_tpu/ops/mxu_limbs.py``, with its public names.
The VPU lane (:mod:`consensus_tpu_torch.ops.field25519`,
:mod:`consensus_tpu_torch.ops.field_p256`) multiplies limbs as broadcast
products and column sums.  This lane computes the same product as two
integer contractions:

1. the batched outer product ``P[n, i, j] = a_i(n) * b_j(n)`` (operands are
   weakly reduced or one raw level, |limb| <= 680, so |P| <= 462,400);
2. the flattened products against the constant (63, 1024) 0/1
   column-assembly matrix ``C[c, 32i + j] = [i + j == c]``: the schoolbook
   columns, each below 32 * 462,400 < 2^24.

It then reduces by an int32 mirror of the field module's carry passes:
arithmetic ``>> 8`` is ``floor(x / 256)`` for negatives too, so every
intermediate equals the VPU lane's value and the weakly reduced limbs are
**bit-identical** to it, before any ``freeze``.  Squaring is ``mul(a, a)``:
the full product's columns are the VPU square's as integers.

Each public product dispatches on the tensors it is given.  On a CUDA tensor
it launches kernel M1 (``csrc/mxu_limbs.cu``: the column assembly on the
integer tensor cores, the outer product and the reduction in the same
launch) or raises; nothing on a CUDA tensor runs the VPU lane or the plain
version in its place.  On a CPU tensor it runs the plain version below, the
JAX contractions in torch int32 (``torch.bmm``, ``torch.matmul``).

Lane selection keeps the JAX module's precedence: suppression wins over
forcing, and forcing wins over ``CTPU_MXU_LIMBS == "1"``.  The port runs
eagerly, so the field modules read :func:`lane_active` at every call, where
the JAX package reads it at every trace (ROADMAP.md, divergence 22).  The
hand-written kernels compute in their own radix and never call the field
modules on the card, so they ignore the lane there, as the JAX package's
Pallas bodies trace under :func:`suppress_mxu_limbs`; their plain versions
call the field modules, so they follow the lane, as the JAX package's XLA
fallbacks do (divergence 23).

Counting: the plain version notes its contractions through
:func:`~consensus_tpu_torch.ops.limbs.note_dot` at the JAX module's sites,
as dense MACs: 32 x 1 x 32 for the outer product and 63 x 1 x 1024 for the
assembly (65,536 a lane), and 32 x 1 x 64 for the P-256 Solinas contraction
(67,584 a lane).  A launch of M1 inside a count raises, as every kernel's
does.
"""

from __future__ import annotations

import contextlib
import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

from consensus_tpu_torch.ops import limbs

LIMBS = 32
_COLS = 2 * LIMBS - 1  # 63 schoolbook columns

#: curve25519 fold weights (field25519.FOLD / TOP_FOLD).
_FOLD = 38
_TOP_FOLD = 19

#: The P-256 fold of 2^256 (field_p256._FOLD_PATTERN).
_FOLD_PATTERN_P256 = ((0, 1), (12, -1), (24, -1), (28, 1))

#: The kernel's curve argument.
_CURVES = {"ed25519": 0, "p256": 1}

#: Lane overrides (module globals, changed only under the context managers
#: below).
_FORCED = False
_SUPPRESSED = False


def lane_active() -> bool:
    """True when field ``mul``/``square`` should take this lane.

    Read at every call by the field modules.  Suppression wins over forcing;
    forcing wins over the environment."""
    if _SUPPRESSED:
        return False
    if _FORCED:
        return True
    return os.environ.get("CTPU_MXU_LIMBS", "") == "1"


@contextlib.contextmanager
def force_mxu_limbs():
    """Take the tensor-core lane inside this block whatever the environment
    says (an in-process A/B)."""
    global _FORCED
    prev = _FORCED
    _FORCED = True
    try:
        yield
    finally:
        _FORCED = prev


@contextlib.contextmanager
def suppress_mxu_limbs():
    """Take the VPU lane inside this block whatever the environment and
    :func:`force_mxu_limbs` say (the A/B's control arm)."""
    global _SUPPRESSED
    prev = _SUPPRESSED
    _SUPPRESSED = True
    try:
        yield
    finally:
        _SUPPRESSED = prev


# --- the wrapper -----------------------------------------------------------------


def _check(a: torch.Tensor, b: torch.Tensor) -> torch.Size:
    """The broadcast shape of two float32 ``(32, *batch)`` operands on one
    device; raises on anything else."""
    for label, t in (("a", a), ("b", b)):
        if t.dtype != torch.float32:
            raise TypeError(f"mxu_limbs: {label} must be float32, got {t.dtype}")
        if t.dim() < 2 or t.shape[0] != LIMBS:
            raise ValueError(
                f"mxu_limbs: {label} must be ({LIMBS}, *batch), got {tuple(t.shape)}"
            )
    if a.device != b.device:
        raise ValueError(f"mxu_limbs: a on {a.device} and b on {b.device}: one device only")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mxu_limbs: unsupported device {a.device}")
    return torch.broadcast_shapes(a.shape, b.shape)


def _product(a: torch.Tensor, b: torch.Tensor, curve: str) -> torch.Tensor:
    shape = _check(a, b)
    if a.device.type == "cpu":
        cols = _schoolbook_columns(a, b)
        reduced = _reduce_cols_i32(cols) if curve == "ed25519" else _reduce_wide_i32(cols)
        return reduced.to(torch.float32)
    return _launch(a, b, shape, curve)


def _launch(a: torch.Tensor, b: torch.Tensor, shape: torch.Size, curve: str) -> torch.Tensor:
    """One launch of M1 over the broadcast batch: an operand whose batch is
    all ones goes in as one (32,) column the kernel broadcasts, any other is
    expanded to the batch and made contiguous."""
    from consensus_tpu_torch.obs.kernels import KERNELS as LEDGER
    from consensus_tpu_torch.ops import scan_kernels

    lanes = 1
    for dim in shape[1:]:
        lanes *= int(dim)
    out = torch.empty((LIMBS, lanes), dtype=torch.float32, device=a.device)
    if lanes == 0:
        return out.reshape(shape)

    def operand(t: torch.Tensor) -> tuple[torch.Tensor, int]:
        if t.numel() == LIMBS:
            return t.reshape(LIMBS).contiguous(), 1
        return t.expand(shape).reshape(LIMBS, lanes).contiguous(), 0

    (a2, a_bcast), (b2, b_bcast) = operand(a), operand(b)
    scan_kernels._launch(
        "mxu_limbs", (a2, b2), (out,), lanes, a.device, (_CURVES[curve], a_bcast, b_bcast)
    )
    LEDGER.record_launch("mxu_limbs")
    return out.reshape(shape)


def mul25519(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """GF(2^255-19) multiplication on this lane: bit-identical to the VPU
    lane's ``field25519.mul`` (weakly reduced, |limb| <= 340)."""
    return _product(a, b, "ed25519")


def square25519(a: torch.Tensor) -> torch.Tensor:
    """Squaring as ``mul25519(a, a)``: bit-identical to the VPU square."""
    return _product(a, a, "ed25519")


def mul_p256(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """GF(p256) multiplication on this lane: bit-identical to the VPU
    lane's ``field_p256.mul``."""
    return _product(a, b, "p256")


def square_p256(a: torch.Tensor) -> torch.Tensor:
    """P-256 squaring as ``mul_p256(a, a)``."""
    return _product(a, a, "p256")


# --- the plain version: the JAX contractions in torch int32 -------------------------


@functools.lru_cache(maxsize=1)
def _conv_matrix_np() -> np.ndarray:
    """(63, 1024) 0/1 column-assembly matrix: C @ flatten(outer(a, b)) is
    the schoolbook convolution's columns."""
    c = np.zeros((_COLS, LIMBS * LIMBS), dtype=np.int32)
    for i in range(LIMBS):
        for j in range(LIMBS):
            c[i + j, LIMBS * i + j] = 1
    return c


@functools.lru_cache(maxsize=None)
def _const(name: str, device: torch.device) -> torch.Tensor:
    """This module's int32 constant ``name`` on ``device``, built once."""
    arr = _conv_matrix_np() if name == "conv" else _solinas_i32()
    return torch.from_numpy(arr).to(device)


def _schoolbook_columns(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 schoolbook columns of a * b, ``(63, *batch)``, as the
    two contractions: the outer product as a batched product and the column
    assembly against the (63, 1024) matrix."""
    shape = torch.broadcast_shapes(a.shape, b.shape)
    batch_shape = shape[1:]
    lanes = 1
    for dim in batch_shape:
        lanes *= int(dim)
    a32 = a.expand(shape).reshape(LIMBS, lanes).T.to(torch.int32)  # (B, 32)
    b32 = b.expand(shape).reshape(LIMBS, lanes).T.to(torch.int32)
    outer = torch.bmm(a32[:, :, None], b32[:, None, :])  # (B, 32, 32)
    cols = torch.matmul(
        _const("conv", a.device), outer.reshape(lanes, LIMBS * LIMBS).T
    )  # (63, B)
    if limbs.counting():
        limbs.note_dot(LIMBS, LIMBS, 1, lanes)          # outer products
        limbs.note_dot(_COLS, 1, LIMBS * LIMBS, lanes)  # column assembly
    return cols.reshape((_COLS,) + tuple(batch_shape))


def _split_i32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The int32 twin of the field modules' split: arithmetic >> 8 is
    floor(x / 256)."""
    hi = x >> 8
    return x - (hi << 8), hi


def _relax_i32(x: torch.Tensor) -> torch.Tensor:
    lo, hi = _split_i32(x)
    return lo + torch.cat([hi[LIMBS - 1 :] * _FOLD, hi[: LIMBS - 1]], dim=0)


def _top_fold_i32(x: torch.Tensor) -> torch.Tensor:
    high = x[LIMBS - 1] >> 7
    return torch.cat(
        [
            (x[0] + high * _TOP_FOLD)[None],
            x[1 : LIMBS - 1],
            (x[LIMBS - 1] - high * 128)[None],
        ],
        dim=0,
    )


def _reduce_cols_i32(cols: torch.Tensor) -> torch.Tensor:
    """int32 mirror of field25519._reduce_cols: the same integers at every
    step."""
    lo, hi = _split_i32(cols)
    c = torch.cat([lo[:1], lo[1:] + hi[:-1], hi[-1:]], dim=0)  # width 64
    r = c[:LIMBS] + c[LIMBS:] * _FOLD
    for _ in range(3):
        r = _relax_i32(r)
    return _top_fold_i32(r)


@functools.lru_cache(maxsize=1)
def _solinas_i32() -> np.ndarray:
    """field_p256's (32, 64) Solinas matrix as exact int32 (entries |m| <=
    4): a snapshot of the port's own ``_solinas_matrix``."""
    from consensus_tpu_torch.ops import field_p256 as fp

    return np.asarray(fp._solinas_matrix(), dtype=np.int32)


def _carry_save_i32(x: torch.Tensor) -> torch.Tensor:
    """``[lo; 0] + [0; hi]``: one limb wider."""
    lo, hi = _split_i32(x)
    return F.pad(lo, (0, 0, 0, 1)) + F.pad(hi, (0, 0, 1, 0))


def _reduce_wide_i32(x: torch.Tensor) -> torch.Tensor:
    """int32 mirror of field_p256._reduce_wide: the carry-save split, the
    Solinas contraction, two fold rounds."""
    if x.shape[0] > _COLS:
        raise ValueError(f"input too wide: {x.shape[0]}")
    batch_shape = x.shape[1:]
    flat = x.reshape(x.shape[0], -1)
    if flat.shape[0] < _COLS:
        flat = F.pad(flat, (0, 0, 0, _COLS - flat.shape[0]))
    wide = _carry_save_i32(flat)  # (64, B)
    r = torch.matmul(_const("solinas", x.device), wide)
    if limbs.counting():
        limbs.note_dot(LIMBS, 1, 2 * LIMBS, flat.shape[1])
    for _ in range(2):
        carried = _carry_save_i32(r)
        r, top = carried[:LIMBS], carried[LIMBS]
        for pos, sign in _FOLD_PATTERN_P256:
            r[pos] += sign * top
    return r.reshape((LIMBS,) + tuple(batch_shape))


def note_skipped_product(lanes: int) -> None:
    """Note the contractions of one Ed25519 product that an exponent's 0 bit
    skips (the JAX ladder multiplies on every bit and selects): what
    :func:`mul25519`'s plain version notes."""
    limbs.note_dot(LIMBS, LIMBS, 1, lanes)
    limbs.note_dot(_COLS, 1, LIMBS * LIMBS, lanes)


__all__ = [
    "lane_active",
    "force_mxu_limbs",
    "suppress_mxu_limbs",
    "mul25519",
    "square25519",
    "mul_p256",
    "square_p256",
]
