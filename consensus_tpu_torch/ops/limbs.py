"""Shared limb-vector helpers (torch port of ``consensus_tpu/ops/limbs.py``).

Field elements are limb vectors with the limb axis leading and the batch
trailing.

This module also hosts the **field-operation counting shim**: the field
stacks report every ``mul``/``square``/``add`` through :func:`note_mul`,
:func:`note_square` and :func:`note_add`, weighted by the number of
independent field elements the op touches (the batch lanes), and the P-256
reduction its Solinas contraction through :func:`note_dot`, so a cost model
reads measured counts.  The JAX module counts while tracing, once per
``lax.scan`` body, and weights each note by the enclosing scans' trip
counts.  The port has no trace: its loops are Python loops that run every
trip (ROADMAP.md, divergence 15), so each trip notes for itself and
:func:`counted_scan` is a plain scan that runs its body once per trip; the
totals equal the JAX module's trip-weighted ones.
:func:`measure_field_ops` runs ``fn`` on the CPU tensors it is given, so
the plain versions do the noting; a kernel wrapper reached with a CUDA
tensor while :func:`counting` is true raises
(``ops/scan_kernels.py::_launch``), since a hand-written kernel cannot note
and a silent zero would be a wrong count.  When no counter is active every
hook is a cheap no-op.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Optional

import torch


def carry_i32(x: torch.Tensor, limb_bits: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact sequential int32 carry pass over the leading (limb) axis.

    Returns ``(normalized limbs, final carry)``; negative inputs borrow
    correctly through the arithmetic right shift."""
    mask = (1 << limb_bits) - 1
    out = torch.empty_like(x)
    carry = torch.zeros_like(x[0])
    for i in range(x.shape[0]):
        v = x[i] + carry
        out[i] = v & mask
        carry = v >> limb_bits
    return out, carry


def lt_bytes(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Little-endian lexicographic ``a < b`` over byte rows.

    ``a`` is ``(n_bytes, batch)``; ``b`` is a ``(n_bytes,)`` constant.
    Equal inputs compare False.  The most significant differing byte is
    read with a gather (the JAX module's one-hot contraction is a TPU
    idiom; the function is the same)."""
    n = a.shape[0]
    b_col = b.to(device=a.device, dtype=a.dtype)[:, None]
    diff = a != b_col  # (n, batch)
    first = torch.argmax(diff.flip(0).to(torch.int32), dim=0)  # MS difference
    idx = (n - 1 - first).unsqueeze(0)
    a_at = torch.gather(a, 0, idx)[0]
    b_at = torch.gather(b_col.expand_as(a), 0, idx)[0]
    return torch.where(diff.any(dim=0), a_at < b_at, torch.zeros_like(a_at, dtype=torch.bool))


# --------------------------------------------------------------------------
# Field-operation counting shim
# --------------------------------------------------------------------------

#: Active counters (a stack, so measurements may nest).
_COUNTERS: list["FieldOpCount"] = []

#: One squaring costs roughly this many generic multiplications in the
#: schoolbook limb stack (the symmetric half of the product terms).
SQUARE_M_RATIO = 0.55

#: One field multiplication is 32 x 32 = 1024 byte-level MACs; dense
#: contraction MACs convert to mul-equivalents at this rate (the yardstick
#: :func:`note_byte_muls` uses too).
DOT_MACS_PER_MUL = 1024


class FieldOpCount:
    """Tally of the field operations run inside one counted region.

    ``muls``/``squares`` count field multiplications and squarings;
    ``dots``/``dot_macs`` count dense contractions (the P-256 reduction's
    Solinas matrix product); ``adds`` counts field additions and
    subtractions."""

    def __init__(self) -> None:
        self.muls = 0
        self.squares = 0
        self.adds = 0
        self.dots = 0
        self.dot_macs = 0

    @property
    def m_equiv(self) -> float:
        """Generic-multiplication equivalents (1 S ~ 0.55 M; 1024 dense
        dot MACs ~ 1 M; adds excluded, as in the JAX module)."""
        return (
            self.muls
            + SQUARE_M_RATIO * self.squares
            + self.dot_macs / DOT_MACS_PER_MUL
        )

    def as_dict(self) -> dict:
        """Per-kernel breakdown (muls vs dot-equivalents vs adds)."""
        return {
            "muls": self.muls,
            "squares": self.squares,
            "adds": self.adds,
            "dots": self.dots,
            "dot_macs": self.dot_macs,
            "dot_m_equiv": round(self.dot_macs / DOT_MACS_PER_MUL, 3),
            "m_equiv": round(self.m_equiv, 3),
        }

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (
            f"FieldOpCount(muls={self.muls}, squares={self.squares}, "
            f"adds={self.adds}, dots={self.dots}, dot_macs={self.dot_macs})"
        )


def counting() -> bool:
    """True while at least one :func:`count_field_ops` region is active."""
    return bool(_COUNTERS)


def _note(attr: str, weight: int) -> None:
    for counter in _COUNTERS:
        setattr(counter, attr, getattr(counter, attr) + weight)


def note_mul(lanes: int = 1) -> None:
    """Record a field multiplication over ``lanes`` independent elements."""
    if _COUNTERS:
        _note("muls", lanes)


def note_square(lanes: int = 1) -> None:
    """Record a field squaring over ``lanes`` independent elements."""
    if _COUNTERS:
        _note("squares", lanes)


def note_add(lanes: int = 1) -> None:
    """Record a field addition/subtraction over ``lanes`` elements."""
    if _COUNTERS:
        _note("adds", lanes)


def note_dot(m: int, n: int, k: int, lanes: int = 1) -> None:
    """Record a dense contraction of an (m, k) by (k, n) tile per lane,
    counted as m * n * k MACs (a constant operand's zeros included)."""
    if _COUNTERS:
        _note("dots", lanes)
        _note("dot_macs", m * n * k * lanes)


def note_byte_muls(byte_muls: int, lanes: int = 1) -> None:
    """Record byte-level multiply work in field-mul equivalents: 1024 byte
    products are one field mul, rounded up so small stages stay visible."""
    if _COUNTERS:
        _note("muls", max(1, (byte_muls + 1023) // 1024) * lanes)


def lanes_of(a: torch.Tensor, b: Optional[torch.Tensor] = None) -> int:
    """Independent field elements an op touches: the product of the
    broadcast batch dims (everything after the leading limb axis)."""
    shape = a.shape if b is None else torch.broadcast_shapes(a.shape, b.shape)
    lanes = 1
    for dim in shape[1:]:
        lanes *= int(dim)
    return lanes


@contextlib.contextmanager
def count_field_ops():
    """Collect the field-op notes of everything run inside this block."""
    counter = FieldOpCount()
    _COUNTERS.append(counter)
    try:
        yield counter
    finally:
        _COUNTERS.remove(counter)


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, tuple):
        mapped = [_tree_map(fn, t) for t in tree]
        return type(tree)(*mapped) if hasattr(tree, "_fields") else tuple(mapped)
    return fn(tree)


def _stack(ys: list) -> Any:
    """Stack per-trip outputs leaf by leaf (``None`` stays ``None``)."""
    first = ys[0]
    if first is None:
        return None
    if isinstance(first, tuple):
        parts = [_stack([y[j] for y in ys]) for j in range(len(first))]
        return type(first)(*parts) if hasattr(first, "_fields") else tuple(parts)
    return torch.stack(ys)


def _first_leaf(tree: Any) -> torch.Tensor:
    while isinstance(tree, tuple):
        tree = tree[0]
    return tree


def counted_scan(f: Callable, init: Any, xs: Any = None, length: Optional[int] = None):
    """``lax.scan``'s contract as a Python loop: ``f(carry, x) -> (carry,
    y)`` once per trip over the leading axis of ``xs`` (a tensor or a tuple
    of them; ``None`` with ``length`` trips), returning the last carry and
    the ``y`` of every trip stacked (``None`` when the body yields none).
    Every trip runs, so each notes its own field operations."""
    if xs is None:
        if length is None:
            raise ValueError("counted_scan needs xs or length")
        trips = int(length)
    else:
        trips = int(_first_leaf(xs).shape[0])
        if length is not None and int(length) != trips:
            raise ValueError(f"length {length} disagrees with xs's {trips} trips")
    carry, ys = init, []
    for i in range(trips):
        carry, y = f(carry, None if xs is None else _tree_map(lambda t: t[i], xs))
        ys.append(y)
    return carry, _stack(ys) if ys else None


def measure_field_ops(fn: Callable, *args, **kwargs) -> FieldOpCount:
    """The field operations of one run of ``fn(*args, **kwargs)`` on the
    tensors given (CPU tensors: a kernel wrapper on a CUDA tensor raises
    while counting)."""
    with count_field_ops() as counter:
        fn(*args, **kwargs)
    return counter


__all__ = [
    "carry_i32",
    "DOT_MACS_PER_MUL",
    "FieldOpCount",
    "SQUARE_M_RATIO",
    "count_field_ops",
    "counted_scan",
    "counting",
    "lanes_of",
    "lt_bytes",
    "measure_field_ops",
    "note_add",
    "note_byte_muls",
    "note_dot",
    "note_mul",
    "note_square",
]
