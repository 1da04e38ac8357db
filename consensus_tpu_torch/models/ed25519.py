"""Batched Ed25519 signature verification, strict and randomized (torch
port of ``consensus_tpu/models/ed25519.py``).

Split of labor:

* **Host** (numpy): parse signatures, range-check ``S < L`` and ``y < p``,
  hash ``k = SHA-512(R || A || M) mod L``, and pack scalars and field
  elements into fixed-shape uint8 limb/digit arrays.
* **Device**: :func:`verify_impl` decompresses R and A (kernel D1,
  :func:`consensus_tpu_torch.ops.scan_kernels.decompress`), computes [k](-A)
  with the hand-written Horner-scan kernel B1
  (:func:`consensus_tpu_torch.ops.scan_kernels.horner_scan`), adds [S]B
  from the 8-bit fixed-base comb (kernel D2,
  :func:`consensus_tpu_torch.ops.scan_kernels.fixed_base_mul_comb`), and
  compares the sum with R.  The negation, the add and the comparison around
  the kernels are plain torch on the field module's f32 limbs.

Batches are padded to the next power of two (``pad_pow2``) or to a fixed
``pad_to``; padding lanes carry y = 0 and ``host_ok = False``.

The randomized lane (:class:`Ed25519RandomizedBatchVerifier`) checks a whole
batch in one aggregate equation, sum z_i (S_i B - k_i A_i - R_i) = 0 with
128-bit transcript coefficients z_i, and bisects only when it fails.  Its
device body :func:`batch_verify_impl` runs the shared-doubling multi-scalar
multiplication in the hand-written Straus MSM kernel
(:func:`consensus_tpu_torch.ops.scan_kernels.straus_msm`).  The pure-Python
RFC 8032 reference at the bottom is the host path for small batches and the
signer of :mod:`consensus_tpu_torch.models.verifier`.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from consensus_tpu_torch.device import DeviceLike, resolve_device
from consensus_tpu_torch.obs.kernels import KERNELS, kernel_lane_suffix
from consensus_tpu_torch.ops import ed25519 as ed
from consensus_tpu_torch.ops import field25519 as fe
from consensus_tpu_torch.ops import scan_kernels

#: Group order of edwards25519 (RFC 8032).
L = 2**252 + 27742317777372353535851937790883648493


def _bytes_rows_to_bits(rows: np.ndarray) -> np.ndarray:
    """(n, 32) little-endian byte rows -> (n, 256) LSB-first bit rows."""
    return np.unpackbits(rows, axis=-1, bitorder="little")


_WINDOW_BITS = 4
_WINDOWS = 256 // _WINDOW_BITS  # 64
_TABLE = 9  # signed digits: |d| <= 8 -> multiples 0..8 of the point


def verify_impl(
    y_r: torch.Tensor,       # (32, batch) R.y limbs, uint8
    sign_r: torch.Tensor,    # (batch,)    R.x sign bits
    y_a: torch.Tensor,       # (32, batch) A.y limbs, uint8
    sign_a: torch.Tensor,    # (batch,)    A.x sign bits
    s_digits8: torch.Tensor, # (32, batch) S 8-bit window digits, LSB window first
    k_digits: torch.Tensor,  # (64, batch) k signed 4-bit digits + 8, MSB window first
    host_ok: torch.Tensor,   # (batch,)    host-side pre-checks passed
) -> torch.Tensor:
    """Per-lane verdicts for ``[S]B == R + [k]A`` (as ``[S]B + [k](-A) == R``).

    Every op is independent per lane.  The inputs arrive in the narrowest
    dtype that holds them and are widened here, on the device.  Each stage
    runs in a ``torch.profiler.record_function`` range named
    ``ed25519.<stage>``, so a profiled run reads the stages' host and device
    time off the real call (the ranges cost nothing without a profiler)."""
    y_r = y_r.to(torch.float32)
    y_a = y_a.to(torch.float32)
    sign_r = sign_r.to(torch.int32)
    sign_a = sign_a.to(torch.int32)
    k_digits = k_digits.to(torch.int32)
    # Decompress R and A in one pass over both, stacked on the batch axis.
    batch = y_r.shape[-1]
    with record_function("ed25519.decompress"):
        pt, pt_ok = scan_kernels.decompress(
            torch.cat([y_r, y_a], dim=-1), torch.cat([sign_r, sign_a], dim=-1)
        )
    r_point = ed.Point(*(c[..., :batch] for c in pt))
    a_point = ed.Point(*(c[..., batch:] for c in pt))
    r_ok, a_ok = pt_ok[..., :batch], pt_ok[..., batch:]
    with record_function("ed25519.negate"):
        neg_a = [c.contiguous() for c in ed.negate(a_point)]
    with record_function("ed25519.horner_scan"):
        acc = scan_kernels.horner_scan(*neg_a, k_digits.contiguous())
    with record_function("ed25519.comb"):
        comb = scan_kernels.fixed_base_mul_comb(s_digits8.to(torch.int32).contiguous())
    with record_function("ed25519.add_and_equal"):
        return host_ok & r_ok & a_ok & ed.equal(ed.add(acc, comb), r_point)


_P_BYTES_BE = np.frombuffer(fe.P.to_bytes(32, "big"), dtype=np.uint8)


def _prep_compressed(points: Sequence[bytes]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Compressed point bytes -> (y limbs, sign bits, y<p validity)."""
    n = len(points)
    ok = np.ones(n, dtype=bool)
    chunks: list[bytes] = []
    for i, raw in enumerate(points):
        if len(raw) == 32:
            chunks.append(raw)
        else:
            ok[i] = False
            chunks.append(b"\x00" * 32)
    rows = np.frombuffer(b"".join(chunks), dtype=np.uint8).reshape(n, 32)
    signs = (rows[:, 31] >> 7)  # uint8
    rows = rows.copy()
    rows[:, 31] &= 0x7F

    # y < p: compare big-endian byte rows against p's bytes.
    rows_be = rows[:, ::-1]
    diff = rows_be != _P_BYTES_BE
    first = np.argmax(diff, axis=1)
    lt = rows_be[np.arange(n), first] < _P_BYTES_BE[first]
    ok &= np.where(diff.any(axis=1), lt, False)  # y == p is out of range too

    return rows, signs, ok  # byte-sized limbs: the bytes ARE the limbs


def _bits_to_signed_window_digits(bits: np.ndarray, windows: int = _WINDOWS) -> np.ndarray:
    """(n, 4 * windows) LSB-first bit rows -> (windows, n) SIGNED 4-bit
    digits in [-8, 7], encoded as d+8 (uint8), MSB window first.  k < L <
    2^253, so the recoding carry never escapes the top of 64 windows."""
    weights = np.array([1, 2, 4, 8], dtype=np.int32)
    u = bits.reshape(bits.shape[0], windows, _WINDOW_BITS) @ weights  # (n, windows)
    d = np.zeros_like(u)
    carry = np.zeros(u.shape[0], dtype=u.dtype)
    for j in range(windows):
        t = u[:, j] + carry
        over = t >= 8
        d[:, j] = np.where(over, t - 16, t)
        carry = over.astype(u.dtype)
    if carry.any():  # unreachable for canonical k (< 2^253)
        raise ValueError("scalar overflow in signed-digit recoding")
    return np.ascontiguousarray(d[:, ::-1].T + 8).astype(np.uint8)


def _bits_to_comb_digits8(bits: np.ndarray) -> np.ndarray:
    """(n, 256) LSB-first bit rows -> (32, n) 8-bit digits, LSB window first."""
    weights = np.array([1, 2, 4, 8, 16, 32, 64, 128], dtype=np.int32)
    digits = bits.reshape(bits.shape[0], 32, 8) @ weights
    return np.ascontiguousarray(digits.T).astype(np.uint8)


def to_kernel_layout(y_r, sign_r, y_a, sign_a, s_bits, k_bits, host_ok) -> tuple[np.ndarray, ...]:
    """Host row-major arrays -> the device layout as numpy: limbs/digits
    leading, batch trailing; S as 8-bit comb digits, k as MSB-first 4-bit
    Horner digits; every array in the narrowest integer dtype."""
    return (
        np.ascontiguousarray(y_r.T),
        np.asarray(sign_r),
        np.ascontiguousarray(y_a.T),
        np.asarray(sign_a),
        _bits_to_comb_digits8(s_bits),
        _bits_to_signed_window_digits(k_bits),
        np.asarray(host_ok),
    )


def kernel_inputs_from_numpy(arrays: Sequence[np.ndarray], device: DeviceLike) -> tuple[torch.Tensor, ...]:
    """The seven layout arrays (this module's or the JAX package's
    ``to_kernel_layout``, as numpy) -> :func:`verify_impl`'s inputs on
    ``device``, keeping their narrow dtypes."""
    if len(arrays) != 7:
        raise ValueError(f"expected the 7 kernel-layout arrays, got {len(arrays)}")
    dev = torch.device(device)
    return tuple(torch.from_numpy(np.array(a)).to(dev) for a in arrays)


def _next_pow2(n: int, minimum: int = 8) -> int:
    size = minimum
    while size < n:
        size *= 2
    return size


class Ed25519BatchVerifier:
    """Verify many (message, signature, public key) triples at once.

    ``verify_batch`` returns a boolean numpy array.  ``pad_pow2`` and
    ``pad_to`` fix the padded batch shapes; ``min_device_batch`` routes
    smaller batches to the host path.  ``device`` defaults to ``cuda``;
    construction raises when no card is present unless ``device="cpu"``
    is asked for explicitly."""

    def __init__(
        self,
        *,
        pad_pow2: bool = True,
        min_device_batch: int = 1,
        pad_to: int = 0,
        device: DeviceLike = None,
    ) -> None:
        self._pad_pow2 = pad_pow2
        self._min_device_batch = min_device_batch
        self._pad_to = pad_to
        self.device = resolve_device(device)

    def _prepare(
        self,
        messages: Sequence[bytes],
        signatures: Sequence[bytes],
        public_keys: Sequence[bytes],
    ) -> tuple[np.ndarray, ...]:
        """Host-side parse/hash/pack: returns the 7 unpadded kernel inputs
        ``(y_r, sign_r, y_a, sign_a, s_bits, k_bits, host_ok)``."""
        n = len(messages)
        host_ok = np.ones(n, dtype=bool)
        zeros32 = b"\x00" * 32
        r_bytes: list[bytes] = []
        s_chunks: list[bytes] = []
        k_chunks: list[bytes] = []
        sha512 = hashlib.sha512
        from_bytes = int.from_bytes
        for i in range(n):
            sig = signatures[i]
            if len(sig) != 64:
                host_ok[i] = False
                r_bytes.append(zeros32)
                s_chunks.append(zeros32)
                k_chunks.append(zeros32)
                continue
            r_raw, s_raw = sig[:32], sig[32:]
            r_bytes.append(r_raw)
            if from_bytes(s_raw, "little") >= L:  # malleability, RFC 8032 5.1.7
                host_ok[i] = False
                s_chunks.append(zeros32)
                k_chunks.append(zeros32)
                continue
            k = (
                from_bytes(sha512(r_raw + public_keys[i] + messages[i]).digest(), "little")
                % L
            )
            s_chunks.append(s_raw)
            k_chunks.append(k.to_bytes(32, "little"))
        s_rows = np.frombuffer(b"".join(s_chunks), dtype=np.uint8).reshape(n, 32)
        k_rows = np.frombuffer(b"".join(k_chunks), dtype=np.uint8).reshape(n, 32)
        s_bits = _bytes_rows_to_bits(s_rows)
        k_bits = _bytes_rows_to_bits(k_rows)

        y_r, sign_r, r_ok = _prep_compressed(r_bytes)
        y_a, sign_a, a_ok = _prep_compressed(list(public_keys))
        host_ok &= r_ok & a_ok
        return y_r, sign_r, y_a, sign_a, s_bits, k_bits, host_ok

    def padded_size(self, n: int) -> int:
        """The device batch a wave of ``n`` signatures is padded to: the
        single-device case of the JAX package's ``engine_padded_size``."""
        if self._pad_to >= n:
            return self._pad_to
        return _next_pow2(n) if self._pad_pow2 else n

    @property
    def preferred_wave_size(self) -> int:
        """The smallest padded batch that saturates this engine -- the
        device-batch floor rounded through the padding knobs.  Coalescers
        (models/engine.py) read it to size waves."""
        return self.padded_size(max(1, self._min_device_batch))

    def host_layout(
        self,
        messages: Sequence[bytes],
        signatures: Sequence[bytes],
        public_keys: Sequence[bytes],
    ) -> tuple[np.ndarray, ...]:
        """Host prep and padding to :meth:`padded_size`: the
        :func:`verify_impl` inputs for one wave as numpy arrays in the
        device layout."""
        n = len(messages)
        y_r, sign_r, y_a, sign_a, s_bits, k_bits, host_ok = self._prepare(
            messages, signatures, public_keys
        )
        pad = self.padded_size(n) - n
        if pad:
            y_r = np.pad(y_r, ((0, pad), (0, 0)))
            y_a = np.pad(y_a, ((0, pad), (0, 0)))
            sign_r = np.pad(sign_r, (0, pad))
            sign_a = np.pad(sign_a, (0, pad))
            s_bits = np.pad(s_bits, ((0, pad), (0, 0)))
            k_bits = np.pad(k_bits, ((0, pad), (0, 0)))
            host_ok = np.pad(host_ok, (0, pad))
        return to_kernel_layout(y_r, sign_r, y_a, sign_a, s_bits, k_bits, host_ok)

    def prepare_device_inputs(
        self,
        messages: Sequence[bytes],
        signatures: Sequence[bytes],
        public_keys: Sequence[bytes],
    ) -> tuple[torch.Tensor, ...]:
        """Host prep, padding and the copy to the device: the
        :func:`verify_impl` inputs for one wave."""
        return kernel_inputs_from_numpy(
            self.host_layout(messages, signatures, public_keys), self.device
        )

    def verify_batch(
        self,
        messages: Sequence[bytes],
        signatures: Sequence[bytes],
        public_keys: Sequence[bytes],
    ) -> np.ndarray:
        n = len(messages)
        if not (n == len(signatures) == len(public_keys)):
            raise ValueError("batch length mismatch")
        if n == 0:
            return np.zeros(0, dtype=bool)
        if n < self._min_device_batch:
            return self._verify_host(messages, signatures, public_keys)
        with record_function("ed25519.host_prep"):
            inputs = self.prepare_device_inputs(messages, signatures, public_keys)
        KERNELS.record_launch("ed25519.verify" + kernel_lane_suffix())
        result = verify_impl(*inputs)
        return result.cpu().numpy()[:n]

    @staticmethod
    def _canonical_ok(signatures, public_keys) -> np.ndarray:
        """The device path's host-side pre-checks, standalone: sig length,
        S < L (RFC 8032 5.1.7 malleability), and canonical compressed
        encodings (y < p) for both R and A."""
        n = len(signatures)
        ok = np.ones(n, dtype=bool)
        for i in range(n):
            sig, key = signatures[i], public_keys[i]
            if len(sig) != 64 or len(key) != 32:
                ok[i] = False
                continue
            if int.from_bytes(sig[32:], "little") >= L:
                ok[i] = False
                continue
            y_r = int.from_bytes(sig[:32], "little") & ((1 << 255) - 1)
            y_a = int.from_bytes(key, "little") & ((1 << 255) - 1)
            if y_r >= fe.P or y_a >= fe.P:
                ok[i] = False
        return ok

    @classmethod
    def _verify_host(cls, messages, signatures, public_keys) -> np.ndarray:
        """Sequential host path: the strict pre-checks, then the pure-Python
        RFC 8032 reference below.  The device path's strict checks run here
        too, so a vote's validity never depends on the batch size that
        checked it."""
        out = cls._canonical_ok(signatures, public_keys)
        for i in range(len(out)):
            if out[i]:
                out[i] = ref_verify(
                    bytes(public_keys[i]), bytes(signatures[i]), bytes(messages[i])
                )
        return out

    def verify_host(self, messages, signatures, public_keys) -> np.ndarray:
        """Verify on the host regardless of batch size, same strict
        semantics as the device path."""
        return self._verify_host(messages, signatures, public_keys)


# --- randomized batch verification ------------------------------------------
# One aggregate check for the whole batch: sum z_i (S_i B - k_i A_i - R_i) = 0
# with independent 128-bit coefficients z_i.  A batch containing any forgery
# passes with probability <= 2^-128 over the choice of z; the 256-bit
# variable-base doubling chain is paid once per batch, not per signature.

_Z_BITS = 128
#: Signed-4-bit windows for a 128-bit coefficient: 32 value windows plus one
#: for the recoding carry.
_Z_WINDOWS = _Z_BITS // _WINDOW_BITS + 1  # 33
_Z_TAG = b"ctpu/batchz/v1"


def _transcript_coefficients(
    messages: Sequence[bytes],
    signatures: Sequence[bytes],
    public_keys: Sequence[bytes],
) -> list[int]:
    """Deterministic per-batch coefficients z_i in [1, 2^128): Fiat-Shamir
    over every byte of every (message, signature, key) triple, each
    length-framed, into a root hash, and z_i = H(root || i).  No wallclock
    and no ambient RNG, so the same batch always gets the same z."""
    sha512 = hashlib.sha512

    def frame(raw: bytes) -> bytes:
        return len(raw).to_bytes(8, "little") + bytes(raw)

    leaves = [
        sha512(frame(m) + frame(s) + frame(a)).digest()
        for m, s, a in zip(messages, signatures, public_keys)
    ]
    root = sha512(
        _Z_TAG + len(leaves).to_bytes(8, "little") + b"".join(leaves)
    ).digest()
    return [
        int.from_bytes(
            sha512(root + i.to_bytes(8, "little")).digest()[:_Z_BITS // 8],
            "little",
        )
        or 1
        for i in range(len(leaves))
    ]


def _signed_digits_int(value: int, windows: int) -> list[int]:
    """Signed 4-bit digits of ``value`` in [-8, 7], MSB window first.
    ``windows`` must leave one window of headroom for the recoding carry."""
    digits = [0] * windows
    carry = 0
    for j in range(windows):
        t = (value & 15) + carry
        value >>= 4
        if t >= 8:
            digits[j] = t - 16
            carry = 1
        else:
            digits[j] = t
            carry = 0
    if carry or value:
        raise ValueError("scalar too wide for signed-digit recoding")
    return digits[::-1]


def _signed_digits_rows(values: Sequence[int], windows: int) -> np.ndarray:
    """:func:`_signed_digits_int` of every value at once, in numpy: a
    (windows, n) uint8 array of d + 8, MSB window first -- the same digits,
    without a Python loop over lanes and windows."""
    n_bytes = (windows + 1) // 2
    try:
        raw = b"".join(int(v).to_bytes(n_bytes, "little") for v in values)
    except OverflowError:
        raise ValueError("scalar too wide for signed-digit recoding") from None
    bits = _bytes_rows_to_bits(np.frombuffer(raw, dtype=np.uint8).reshape(len(values), n_bytes))
    if bits[:, _WINDOW_BITS * windows :].any():
        raise ValueError("scalar too wide for signed-digit recoding")
    return _bits_to_signed_window_digits(bits[:, : _WINDOW_BITS * windows], windows)


def msm_inputs(
    y_r: torch.Tensor,       # (32, batch) R.y limbs
    sign_r: torch.Tensor,    # (batch,)    R.x sign bits
    y_a: torch.Tensor,       # (32, batch) A.y limbs
    sign_a: torch.Tensor,    # (batch,)    A.x sign bits
    zk_digits: torch.Tensor, # (64, batch) z_i k_i mod L signed 4-bit + 8, MSB first
    z_digits: torch.Tensor,  # (33, batch) z_i signed 4-bit + 8, MSB first
    host_ok: torch.Tensor,   # (batch,)    host pre-checks passed
) -> tuple[ed.Point, ed.Point, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The Straus MSM's inputs: (-A, -R, masked zk digits, masked z digits,
    valid).  R and A are decompressed in one pass; a lane that failed a host
    pre-check or decompression has its digits set to 8 (digit 0), so it
    contributes the identity -- padding lanes ride the same mechanism."""
    batch = y_r.shape[-1]
    with record_function("ed25519.batch.decompress"):
        pt, pt_ok = scan_kernels.decompress(
            torch.cat([y_r, y_a], dim=-1).to(torch.float32),
            torch.cat([sign_r, sign_a], dim=-1).to(torch.int32),
        )
    with record_function("ed25519.batch.negate"):
        valid = host_ok & pt_ok[..., :batch] & pt_ok[..., batch:]
        eight = torch.full((), 8, dtype=torch.int32, device=y_r.device)
        zk_digits = torch.where(valid[None], zk_digits.to(torch.int32), eight)
        z_digits = torch.where(valid[None], z_digits.to(torch.int32), eight)
        neg_r = ed.negate(ed.Point(*(c[..., :batch] for c in pt)))
        neg_a = ed.negate(ed.Point(*(c[..., batch:] for c in pt)))
        neg_r = ed.Point(*(c.contiguous() for c in neg_r))
        neg_a = ed.Point(*(c.contiguous() for c in neg_a))
    return neg_a, neg_r, zk_digits, z_digits, valid


def batch_verify_impl(
    y_r: torch.Tensor,        # (32, batch) R.y limbs, uint8
    sign_r: torch.Tensor,     # (batch,)    R.x sign bits
    y_a: torch.Tensor,        # (32, batch) A.y limbs, uint8
    sign_a: torch.Tensor,     # (batch,)    A.x sign bits
    zs_digits8: torch.Tensor, # (32, 1)     sum z_i s_i mod L, 8-bit comb digits
    zk_digits: torch.Tensor,  # (64, batch) z_i k_i mod L signed 4-bit + 8, MSB first
    z_digits: torch.Tensor,   # (33, batch) z_i signed 4-bit + 8, MSB first
    host_ok: torch.Tensor,    # (batch,)    host pre-checks passed
) -> tuple[torch.Tensor, torch.Tensor]:
    """The randomized check on the device: [sum z_i s_i mod L]B +
    sum [z_i k_i mod L](-A_i) + sum [z_i](-R_i) against the identity.

    Returns ``(eq_ok, valid)``: the aggregate verdict (a 0-d bool) and the
    lanes that passed the host pre-checks and decompressed.  Decompression
    is kernel D1, the MSM the Straus kernel B3 and the comb kernel D2 at
    batch 1 (each its plain version on a CPU tensor).
    Each stage runs in a ``record_function`` range ``ed25519.batch.<stage>``."""
    neg_a, neg_r, zk_digits, z_digits, valid = msm_inputs(
        y_r, sign_r, y_a, sign_a, zk_digits, z_digits, host_ok
    )
    with record_function("ed25519.batch.straus_msm"):
        acc = scan_kernels.straus_msm(neg_a, neg_r, zk_digits, z_digits)
    with record_function("ed25519.batch.comb"):
        comb = scan_kernels.fixed_base_mul_comb(zs_digits8.to(torch.int32).contiguous())
    with record_function("ed25519.batch.check"):
        return ed.is_identity(ed.add(acc, comb))[0], valid


def _ref_negate(p):
    x, y, z, t = p
    return ((fe.P - x) % fe.P, y, z, (fe.P - t) % fe.P)


class Ed25519RandomizedBatchVerifier(Ed25519BatchVerifier):
    """Randomized batch verification with bisection fallback.

    Same ``verify_batch`` contract, and the same result vector, as
    :class:`Ed25519BatchVerifier`: one aggregate check replaces n
    independent double chains.  When the aggregate fails, the batch is split
    in half and each half re-checked under fresh transcript coefficients, so
    forgeries are localized in O(f log n) checks; every subset below
    ``min_randomized`` is decided by the strict verifier.

    ``min_device_batch`` picks between the device check
    (:func:`batch_verify_impl`) and a host big-int Straus with the same
    two-phase window schedule."""

    randomized = True

    def __init__(
        self,
        *,
        pad_pow2: bool = True,
        min_device_batch: int = 1,
        pad_to: int = 0,
        device: DeviceLike = None,
        min_randomized: int = 2,
    ) -> None:
        super().__init__(
            pad_pow2=pad_pow2, min_device_batch=min_device_batch, pad_to=pad_to, device=device
        )
        self._min_randomized = max(2, int(min_randomized))

    def _host_scalars(self, messages, signatures, public_keys):
        """The strict pre-checks and, for each lane that passes, (S, k)."""
        host_ok = self._canonical_ok(signatures, public_keys)
        scalars: dict[int, tuple[int, int]] = {}
        for i in np.flatnonzero(host_ok).tolist():
            sig = bytes(signatures[i])
            k = int.from_bytes(
                hashlib.sha512(sig[:32] + bytes(public_keys[i]) + bytes(messages[i])).digest(),
                "little",
            ) % L
            scalars[i] = (int.from_bytes(sig[32:], "little"), k)
        return host_ok, scalars

    def verify_batch(
        self,
        messages: Sequence[bytes],
        signatures: Sequence[bytes],
        public_keys: Sequence[bytes],
    ) -> np.ndarray:
        n = len(messages)
        if not (n == len(signatures) == len(public_keys)):
            raise ValueError("batch length mismatch")
        results = np.zeros(n, dtype=bool)
        if n == 0:
            return results
        with record_function("ed25519.batch.host_prep"):
            host_ok, scalars = self._host_scalars(messages, signatures, public_keys)
        self._check(
            np.flatnonzero(host_ok).tolist(),
            messages, signatures, public_keys, scalars, results,
        )
        return results

    def _check(self, idx, messages, signatures, public_keys, scalars, results):
        """Recursive bisection: decide every index in ``idx``."""
        if not idx:
            return
        if len(idx) < self._min_randomized:
            sub = super().verify_batch(
                [messages[i] for i in idx],
                [signatures[i] for i in idx],
                [public_keys[i] for i in idx],
            )
            for j, i in enumerate(idx):
                results[i] = bool(sub[j])
            return
        with record_function("ed25519.batch.host_prep"):
            zs = _transcript_coefficients(
                [messages[i] for i in idx],
                [signatures[i] for i in idx],
                [public_keys[i] for i in idx],
            )
        if len(idx) >= self._min_device_batch:
            eq_ok, valid = self._aggregate_device(idx, signatures, public_keys, scalars, zs)
        else:
            eq_ok, valid = self._aggregate_host(idx, signatures, public_keys, scalars, zs)
        if not all(valid):
            # Decompression failures are invalid, as on the strict path; their
            # digits were masked out of the aggregate, but the survivors are
            # re-checked under a fresh transcript rather than trusting a
            # verdict whose membership changed.
            survivors = [i for i, ok in zip(idx, valid) if ok]
            self._check(survivors, messages, signatures, public_keys, scalars, results)
            return
        if eq_ok:
            for i in idx:
                results[i] = True
            return
        mid = len(idx) // 2
        self._check(idx[:mid], messages, signatures, public_keys, scalars, results)
        self._check(idx[mid:], messages, signatures, public_keys, scalars, results)

    def _aggregate_inputs(self, idx, signatures, scalars, zs):
        """Host math shared by both backends: per-entry scalars z_i k_i mod L
        and the base-point scalar sum z_i s_i mod L."""
        zk = [(z * scalars[i][1]) % L for z, i in zip(zs, idx)]
        u = 0
        for z, i in zip(zs, idx):
            u += z * scalars[i][0]
        return zk, u % L

    def _aggregate_layout(self, idx, signatures, public_keys, scalars, zs):
        """:func:`batch_verify_impl`'s inputs for the subset ``idx`` as host
        arrays, padded to :meth:`padded_size` (padding lanes have
        ``host_ok`` False, so their digits are masked to the identity)."""
        m = len(idx)
        zk, u = self._aggregate_inputs(idx, signatures, scalars, zs)
        y_r, sign_r, _ = _prep_compressed([bytes(signatures[i])[:32] for i in idx])
        y_a, sign_a, _ = _prep_compressed([bytes(public_keys[i]) for i in idx])
        zk_digits = _signed_digits_rows(zk, _WINDOWS)
        z_digits = _signed_digits_rows(zs, _Z_WINDOWS)
        host_ok = np.ones(m, dtype=bool)
        padded = self.padded_size(m)
        pad = padded - m
        if pad:
            y_r = np.pad(y_r, ((0, pad), (0, 0)))
            y_a = np.pad(y_a, ((0, pad), (0, 0)))
            sign_r = np.pad(sign_r, (0, pad))
            sign_a = np.pad(sign_a, (0, pad))
            zk_digits = np.pad(zk_digits, ((0, 0), (0, pad)), constant_values=8)
            z_digits = np.pad(z_digits, ((0, 0), (0, pad)), constant_values=8)
            host_ok = np.pad(host_ok, (0, pad))
        u_rows = np.stack([
            np.frombuffer(v.to_bytes(32, "little"), dtype=np.uint8)
            for v in self._base_scalars(idx, scalars, zs, padded, u)
        ])
        zs_digits8 = _bits_to_comb_digits8(_bytes_rows_to_bits(u_rows))
        return (y_r.T, sign_r, y_a.T, sign_a, zs_digits8, zk_digits, z_digits, host_ok)

    def _base_scalars(self, idx, scalars, zs, padded, u) -> list[int]:
        """The aggregate's base-point scalars, one comb column each: here the
        one sum ``u = sum z_i s_i mod L`` from :meth:`_aggregate_inputs`."""
        return [u]

    def _aggregate_device_inputs(self, idx, signatures, public_keys, scalars, zs):
        """:func:`batch_verify_impl`'s inputs for the subset ``idx`` on the
        device (:meth:`_aggregate_layout`, copied)."""
        with record_function("ed25519.batch.host_prep"):
            return tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in self._aggregate_layout(idx, signatures, public_keys, scalars, zs)
            )

    def _aggregate_device(self, idx, signatures, public_keys, scalars, zs):
        """One device check over the subset: one launch of the MSM kernel on
        the card, and one read of the verdict and the valid lanes."""
        m = len(idx)
        inputs = self._aggregate_device_inputs(idx, signatures, public_keys, scalars, zs)
        KERNELS.record_launch("ed25519.batch_verify" + kernel_lane_suffix())
        eq_ok, valid = batch_verify_impl(*inputs)
        out = torch.cat([eq_ok.reshape(1), valid[:m]]).cpu().numpy()
        return bool(out[0]), out[1:].tolist()

    def _aggregate_host(self, idx, signatures, public_keys, scalars, zs):
        """Host big-int twin of the device check: the same two-phase
        shared-window schedule in plain integers."""
        m = len(idx)
        a_pts = [_ref_decompress(bytes(public_keys[i])) for i in idx]
        r_pts = [_ref_decompress(bytes(signatures[i])[:32]) for i in idx]
        valid = [a is not None and r is not None for a, r in zip(a_pts, r_pts)]
        if not all(valid):
            return False, valid
        zk, u = self._aggregate_inputs(idx, signatures, scalars, zs)

        def table(p):
            neg = _ref_negate(p)
            tbl = [_REF_IDENTITY, neg]
            for _ in range(_TABLE - 2):  # 2p .. 8p
                tbl.append(_ref_add(tbl[-1], neg))
            return tbl

        a_tbl = [table(p) for p in a_pts]
        r_tbl = [table(p) for p in r_pts]
        zk_digits = [_signed_digits_int(v, _WINDOWS) for v in zk]
        z_digits = [_signed_digits_int(z, _Z_WINDOWS) for z in zs]

        acc = _REF_IDENTITY
        low_start = _WINDOWS - _Z_WINDOWS
        for w in range(_WINDOWS):
            for _ in range(4):
                acc = _ref_add(acc, acc)
            for j in range(m):
                d = zk_digits[j][w]
                if d:
                    acc = _ref_add(acc, a_tbl[j][d] if d > 0 else _ref_negate(a_tbl[j][-d]))
                if w >= low_start:
                    d = z_digits[j][w - low_start]
                    if d:
                        acc = _ref_add(acc, r_tbl[j][d] if d > 0 else _ref_negate(r_tbl[j][-d]))
        acc = _ref_add(acc, _ref_mul(u, _BASE_POINT))
        eq_ok = acc[0] % fe.P == 0 and (acc[1] - acc[2]) % fe.P == 0
        return eq_ok, valid


# --- pure-Python RFC 8032 reference (host) ---------------------------------
# Plain-integer edwards25519: keygen, sign, verify.  The host-verification
# path for small batches and the signer behind models.verifier.Ed25519Signer.
# Verification keeps the device path's strict semantics: S < L, canonical
# (y < p) encodings.

_D_REF = (-121665 * pow(121666, fe.P - 2, fe.P)) % fe.P
_BASE_Y = (4 * pow(5, fe.P - 2, fe.P)) % fe.P


def _ref_recover_x(y: int, sign: int) -> Optional[int]:
    x2 = (y * y - 1) * pow(_D_REF * y * y + 1, fe.P - 2, fe.P) % fe.P
    x = pow(x2, (fe.P + 3) // 8, fe.P)
    if (x * x - x2) % fe.P:
        x = x * pow(2, (fe.P - 1) // 4, fe.P) % fe.P
    if (x * x - x2) % fe.P:
        return None
    if x == 0 and sign:
        return None  # RFC 8032 5.1.3 step 4
    if x & 1 != sign:
        x = fe.P - x
    return x


_REF_IDENTITY = (0, 1, 1, 0)


def _ref_add(p, q):
    # Extended homogeneous coordinates, RFC 8032 5.1.4.
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % fe.P
    b = (y1 + x1) * (y2 + x2) % fe.P
    c = 2 * t1 * t2 * _D_REF % fe.P
    d = 2 * z1 * z2 % fe.P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % fe.P, g * h % fe.P, f * g % fe.P, e * h % fe.P)


def _ref_mul(s: int, p):
    q = _REF_IDENTITY
    while s:
        if s & 1:
            q = _ref_add(q, p)
        p = _ref_add(p, p)
        s >>= 1
    return q


_BASE_POINT = (
    _ref_recover_x(_BASE_Y, 0),
    _BASE_Y,
    1,
    _ref_recover_x(_BASE_Y, 0) * _BASE_Y % fe.P,
)


def _ref_compress(p) -> bytes:
    x, y, z, _ = p
    zinv = pow(z, fe.P - 2, fe.P)
    x, y = x * zinv % fe.P, y * zinv % fe.P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def _ref_decompress(raw: bytes):
    if len(raw) != 32:
        return None
    y = int.from_bytes(raw, "little")
    sign, y = y >> 255, y & ((1 << 255) - 1)
    if y >= fe.P:
        return None
    x = _ref_recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, x * y % fe.P)


def _ref_scalars(seed: bytes) -> tuple[int, bytes]:
    if len(seed) != 32:
        raise ValueError("Ed25519 seed must be 32 bytes")
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


def ref_public_key(seed: bytes) -> bytes:
    """RFC 8032 5.1.5: the 32-byte public key for a 32-byte seed."""
    a, _ = _ref_scalars(seed)
    return _ref_compress(_ref_mul(a, _BASE_POINT))


def ref_sign(seed: bytes, message: bytes) -> bytes:
    """RFC 8032 5.1.6: the 64-byte signature R || S."""
    a, prefix = _ref_scalars(seed)
    a_enc = _ref_compress(_ref_mul(a, _BASE_POINT))
    r = int.from_bytes(hashlib.sha512(prefix + message).digest(), "little") % L
    r_enc = _ref_compress(_ref_mul(r, _BASE_POINT))
    k = int.from_bytes(
        hashlib.sha512(r_enc + a_enc + message).digest(), "little"
    ) % L
    s = (r + k * a) % L
    return r_enc + s.to_bytes(32, "little")


def ref_verify(public_key: bytes, signature: bytes, message: bytes) -> bool:
    """RFC 8032 5.1.7 with the device path's strict pre-checks."""
    if len(signature) != 64 or len(public_key) != 32:
        return False
    r_enc, s_raw = signature[:32], signature[32:]
    s = int.from_bytes(s_raw, "little")
    if s >= L:
        return False
    a_pt = _ref_decompress(public_key)
    r_pt = _ref_decompress(r_enc)
    if a_pt is None or r_pt is None:
        return False
    k = int.from_bytes(
        hashlib.sha512(r_enc + public_key + message).digest(), "little"
    ) % L
    lhs = _ref_mul(s, _BASE_POINT)
    rhs = _ref_add(r_pt, _ref_mul(k, a_pt))
    return (
        (lhs[0] * rhs[2] - rhs[0] * lhs[2]) % fe.P == 0
        and (lhs[1] * rhs[2] - rhs[1] * lhs[2]) % fe.P == 0
    )


__all__ = [
    "Ed25519BatchVerifier",
    "Ed25519RandomizedBatchVerifier",
    "L",
    "batch_verify_impl",
    "kernel_inputs_from_numpy",
    "msm_inputs",
    "ref_public_key",
    "ref_sign",
    "ref_verify",
    "to_kernel_layout",
    "verify_impl",
]
