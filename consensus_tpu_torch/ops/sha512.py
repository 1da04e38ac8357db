"""SHA-512 over lanes of padded blocks (FIPS 180-4): the torch port of
``consensus_tpu/ops/sha512.py``, with kernel S1 on the card.

The fused front end (:mod:`consensus_tpu_torch.models.fused`) hashes on the
device: the Ed25519 challenge ``SHA-512(R || A || M)`` of every lane of a
wave, and the Fiat-Shamir transcript's leaf, root and coefficient hashes.

Layouts (the JAX module's):

* host packing: :func:`pad_messages` -> ``(blocks, n_blocks)`` with
  ``blocks`` uint32 numpy of shape ``(B, 16, 2, batch)`` (block, word,
  hi/lo, lane) and ``n_blocks`` int32 ``(batch,)``; :func:`blocks_tensor`
  puts them on a device.
* device: :func:`sha512_blocks` -> state ``(8, 2, batch)``;
  :func:`digest_bytes` -> ``(64, batch)`` int32 digest bytes in stream
  order; :func:`pack_bytes_device` turns device-resident padded byte rows
  back into block layout.

torch has no usable uint32 arithmetic (add, shift and compare raise for it),
so the device tensors of words are int32 holding the uint32 bit patterns.
:func:`sha512_blocks` launches S1 (``csrc/sha512.cu``) on a CUDA tensor and
raises if it cannot; on a CPU tensor it runs the plain version
:func:`sha512_blocks_reference`, the JAX formulas with each 32-bit half in
an int64 tensor, masked to 32 bits after every add, left shift and not.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from consensus_tpu_torch.obs.kernels import KERNELS as LEDGER
from consensus_tpu_torch.ops import scan_kernels

BLOCK_BYTES = 128

# --- constants (FIPS 180-4 4.2.3 / 5.3.5) ------------------------------------
# Derived, not transcribed: the IV words are the fractional parts of sqrt(p)
# and the round constants those of cbrt(p) over the first 8 / 80 primes.


def _primes(count: int) -> list[int]:
    out: list[int] = []
    candidate = 2
    while len(out) < count:
        if all(candidate % p for p in out):
            out.append(candidate)
        candidate += 1
    return out


def _icbrt(n: int) -> int:
    x = 1 << ((n.bit_length() + 2) // 3)
    while True:
        y = (2 * x + n // (x * x)) // 3
        if y >= x:
            break
        x = y
    return x


_MASK64 = (1 << 64) - 1
_MASK32 = 0xFFFFFFFF
_IV_INT = [math.isqrt(p << 128) & _MASK64 for p in _primes(8)]
_K_INT = [_icbrt(p << 192) & _MASK64 for p in _primes(80)]


def _split_words(values: Sequence[int]) -> np.ndarray:
    """64-bit ints -> (n, 2) rows of (hi, lo) halves."""
    return np.array([[v >> 32, v & _MASK32] for v in values], dtype=np.int64)


_IV = _split_words(_IV_INT)  # (8, 2)
_K = _split_words(_K_INT)    # (80, 2)


# --- 64-bit ops on (hi, lo) pairs of 32-bit values held in int64 -------------


def _add64(a, b):
    lo = a[1] + b[1]
    return (a[0] + b[0] + (lo >> 32)) & _MASK32, lo & _MASK32


def _ror64(x, r: int):
    hi, lo = x
    if r >= 32:
        hi, lo = lo, hi
        r -= 32
    if r == 0:
        return hi, lo
    t = 32 - r
    return (hi >> r) | ((lo << t) & _MASK32), (lo >> r) | ((hi << t) & _MASK32)


def _shr64(x, r: int):
    hi, lo = x
    if r >= 32:
        return torch.zeros_like(hi), hi >> (r - 32)
    return hi >> r, (lo >> r) | ((hi << (32 - r)) & _MASK32)


def _xor64(a, b):
    return a[0] ^ b[0], a[1] ^ b[1]


def _big_sigma0(a):
    return _xor64(_xor64(_ror64(a, 28), _ror64(a, 34)), _ror64(a, 39))


def _big_sigma1(e):
    return _xor64(_xor64(_ror64(e, 14), _ror64(e, 18)), _ror64(e, 41))


def _small_sigma0(x):
    return _xor64(_xor64(_ror64(x, 1), _ror64(x, 8)), _shr64(x, 7))


def _small_sigma1(x):
    return _xor64(_xor64(_ror64(x, 19), _ror64(x, 61)), _shr64(x, 6))


def _ch(e, f, g):
    return (
        (e[0] & f[0]) ^ ((~e[0] & _MASK32) & g[0]),
        (e[1] & f[1]) ^ ((~e[1] & _MASK32) & g[1]),
    )


def _maj(a, b, c):
    return (
        (a[0] & b[0]) ^ (a[0] & c[0]) ^ (b[0] & c[0]),
        (a[1] & b[1]) ^ (a[1] & c[1]) ^ (b[1] & c[1]),
    )


def _compress_block(state: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """One SHA-512 compression: state (8, 2, batch) + block (16, 2, batch),
    both int64 halves in [0, 2^32).

    The 80 rounds run as a Python loop carrying the working variables and a
    rolling 16-word schedule window (W[t+16] from the window), as the JAX
    module's scanned body carries them."""
    vars8 = [(state[i, 0], state[i, 1]) for i in range(8)]
    w = [(block[i, 0], block[i, 1]) for i in range(16)]
    for k_hi, k_lo in _K.tolist():
        a, b, c, d, e, f, g, h = vars8
        t1 = _add64(
            _add64(h, _big_sigma1(e)),
            _add64(_ch(e, f, g), _add64((k_hi, k_lo), w[0])),
        )
        t2 = _add64(_big_sigma0(a), _maj(a, b, c))
        vars8 = [_add64(t1, t2), a, b, c, _add64(d, t1), e, f, g]
        nxt = _add64(
            _add64(_small_sigma1(w[14]), w[9]),
            _add64(_small_sigma0(w[1]), w[0]),
        )
        w = w[1:] + [nxt]
    new = torch.stack([torch.stack(v) for v in vars8])
    lo = state[:, 1] + new[:, 1]
    hi = (state[:, 0] + new[:, 0] + (lo >> 32)) & _MASK32
    return torch.stack([hi, lo & _MASK32], dim=1)


def _to_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensors holding their bit
    patterns."""
    return (words - ((words >> 31) << 32)).to(torch.int32)


def _check(blocks: torch.Tensor, n_blocks: torch.Tensor) -> int:
    """Check what S1 takes -- int32 ``(B, 16, 2, batch)`` blocks, int32
    ``(batch,)`` counts, one device, contiguous -- and return the batch."""
    if blocks.dtype != torch.int32 or n_blocks.dtype != torch.int32:
        raise TypeError(
            f"sha512_blocks: blocks and n_blocks must be int32, got "
            f"{blocks.dtype} and {n_blocks.dtype}"
        )
    if blocks.dim() != 4 or tuple(blocks.shape[1:3]) != (16, 2):
        raise ValueError(f"sha512_blocks: blocks must be (B, 16, 2, batch), got {tuple(blocks.shape)}")
    batch = blocks.shape[3]
    if tuple(n_blocks.shape) != (batch,):
        raise ValueError(
            f"sha512_blocks: n_blocks must be ({batch},), got {tuple(n_blocks.shape)}"
        )
    if n_blocks.device != blocks.device:
        raise ValueError("sha512_blocks: all inputs must be on one device")
    if not (blocks.is_contiguous() and n_blocks.is_contiguous()):
        raise ValueError("sha512_blocks: inputs must be contiguous")
    if blocks.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sha512_blocks: unsupported device {blocks.device}")
    return batch


def sha512_blocks(blocks: torch.Tensor, n_blocks: torch.Tensor) -> torch.Tensor:
    """SHA-512 state for a batch of pre-padded messages.

    ``blocks``: int32 ``(B, 16, 2, batch)`` (uint32 bit patterns);
    ``n_blocks``: int32 ``(batch,)`` active blocks per lane.  A lane absorbs
    its first ``min(n_blocks, B)`` blocks; the rest leave its state as it
    was.  Returns the final state ``(8, 2, batch)`` int32 (uint32 bit
    patterns).  On CUDA kernel S1 computes it, on the CPU the plain
    version."""
    batch = _check(blocks, n_blocks)
    device = blocks.device
    if device.type == "cpu":
        return sha512_blocks_reference(blocks, n_blocks)
    state = torch.empty((8, 2, batch), dtype=torch.int32, device=device)
    scan_kernels._launch(
        "sha512", (blocks, n_blocks), (state,), batch, device, (blocks.shape[0],)
    )
    LEDGER.record_launch("sha512")
    return state


def sha512_blocks_reference(blocks: torch.Tensor, n_blocks: torch.Tensor) -> torch.Tensor:
    """The plain torch version of S1: a port of the JAX ``sha512_blocks``.
    Each block is compressed on every lane, and a lane whose count ends
    before it keeps its state (``torch.where``), as JAX's scan does."""
    words = blocks.to(torch.int64) & _MASK32
    counts = n_blocks.to(torch.int64)
    batch = words.shape[-1]
    state = torch.as_tensor(_IV, device=words.device)[:, :, None].expand(8, 2, batch)
    for index in range(words.shape[0]):
        new_state = _compress_block(state, words[index])
        state = torch.where((index < counts)[None, None, :], new_state, state)
    return _to_int32(state)


def digest_bytes(state: torch.Tensor) -> torch.Tensor:
    """State ``(8, 2, batch)`` -> digest bytes ``(64, batch)`` int32 in
    stream order (the order ``hashlib.sha512(...).digest()`` emits): each
    word big-endian, hi half first."""
    shifts = torch.tensor([24, 16, 8, 0], dtype=torch.int32, device=state.device)
    # (8, 2, 4, batch): word, half, byte-within-half, lane.  The mask makes
    # int32's arithmetic shift of a high bit harmless.
    expanded = (state[:, :, None, :].to(torch.int32) >> shifts[None, None, :, None]) & 0xFF
    return expanded.reshape(64, state.shape[-1])


def pack_bytes_device(rows: torch.Tensor) -> torch.Tensor:
    """Device-resident padded byte rows ``(B*128, batch)`` -> block layout
    ``(B, 16, 2, batch)`` int32.  Lets transcript stages hash values that
    were themselves just hashed on the device (leaves -> root ->
    coefficients) without a host round-trip."""
    total, batch = rows.shape
    if total % BLOCK_BYTES:
        raise ValueError("row length must be a multiple of 128")
    r = rows.to(torch.int64).reshape(total // BLOCK_BYTES, 16, 2, 4, batch)
    words = (r[..., 0, :] << 24) | (r[..., 1, :] << 16) | (r[..., 2, :] << 8) | r[..., 3, :]
    return _to_int32(words).contiguous()


# --- host packing ----------------------------------------------------------


def padded_blocks_for(length: int) -> int:
    """Blocks occupied by a ``length``-byte message after FIPS 180-4
    padding (0x80, zeros, 128-bit bit length)."""
    return (length + 17 + BLOCK_BYTES - 1) // BLOCK_BYTES


def pad_trailer(length: int) -> bytes:
    """The padding suffix for a ``length``-byte message: everything after
    the message bytes up to its final block boundary."""
    blocks = padded_blocks_for(length)
    zeros = blocks * BLOCK_BYTES - length - 1 - 16
    return b"\x80" + b"\x00" * zeros + (8 * length).to_bytes(16, "big")


def pad_messages(
    messages: Sequence[bytes], *, min_blocks: int = 1
) -> tuple[np.ndarray, np.ndarray]:
    """Pack variable-length messages into the fixed kernel block layout.

    Pure byte movement -- no hashing, no big-int.  Returns ``(blocks,
    n_blocks)``: ``blocks`` uint32 ``(B, 16, 2, n)`` with ``B`` the max
    padded block count (at least ``min_blocks``, so callers can pin a
    shape), and ``n_blocks`` int32 ``(n,)``."""
    n = len(messages)
    lengths = [len(m) for m in messages]
    n_blocks = np.array(
        [padded_blocks_for(length) for length in lengths], dtype=np.int32
    )
    total = max(int(n_blocks.max()) if n else 0, min_blocks)
    buf = np.zeros((n, total * BLOCK_BYTES), dtype=np.uint8)
    for i, message in enumerate(messages):
        length = lengths[i]
        end = int(n_blocks[i]) * BLOCK_BYTES
        buf[i, :length] = np.frombuffer(bytes(message), dtype=np.uint8)
        buf[i, length:end] = np.frombuffer(pad_trailer(length), dtype=np.uint8)
    words = buf.view(">u4").astype(np.uint32).reshape(n, total, 16, 2)
    return np.ascontiguousarray(words.transpose(1, 2, 3, 0)), n_blocks


def blocks_tensor(blocks: np.ndarray) -> torch.Tensor:
    """Host uint32 block words -> the int32 tensor of the same bits that
    :func:`sha512_blocks` takes (on the host; ``.to(device)`` moves it)."""
    return torch.from_numpy(np.ascontiguousarray(blocks, dtype=np.uint32).view(np.int32))


__all__ = [
    "BLOCK_BYTES",
    "blocks_tensor",
    "digest_bytes",
    "pack_bytes_device",
    "pad_messages",
    "pad_trailer",
    "padded_blocks_for",
    "sha512_blocks",
    "sha512_blocks_reference",
]
