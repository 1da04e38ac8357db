"""Batched ECDSA-P256 signature verification (torch port of
``consensus_tpu/models/ecdsa_p256.py``).

Split of labor, as in the JAX module:

* **Host** (numpy and Python integers): parse and range-check r, s and the
  SEC1 key, hash the message with SHA-256, and compute u1 = e/s and
  u2 = r/s mod n with one batched inversion.
* **Device**: :func:`verify_impl` computes [u2]Q with the hand-written
  Horner-scan kernel B2
  (:func:`consensus_tpu_torch.ops.scan_kernels.horner_scan_p256`) and
  [u1]G with the 8-bit fixed-base comb kernel P1
  (:func:`~consensus_tpu_torch.ops.scan_kernels.fixed_base_mul_comb_p256`),
  then kernel P2 (:func:`~consensus_tpu_torch.ops.scan_kernels.verdict_p256`)
  adds them and accepts iff Q is on the curve, the sum is not the identity
  and X == r Z or (r + n < p and X == (r + n) Z).  Around the kernels only
  dtype widening runs in torch.

Native formats: signature = 64 bytes big-endian r || s; public key =
65 bytes SEC1 uncompressed (0x04 || X || Y).  Compressed keys are rejected,
not decompressed.  There is no low-s rule: (r, n - s) verifies as (r, s)
does, as in the JAX engine.

The pure-Python P-256 reference at the bottom (key generation, RFC 6979
deterministic signing with HMAC-SHA-256, verification with the device
path's checks) is the host path for small batches and the signer of
:mod:`consensus_tpu_torch.models.verifier`; the port needs no
``cryptography`` package.
"""

from __future__ import annotations

import functools
import hashlib
import hmac
from typing import Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from consensus_tpu_torch.device import DeviceLike, resolve_device
from consensus_tpu_torch.models.ed25519 import _next_pow2
from consensus_tpu_torch.obs.kernels import KERNELS, kernel_lane_suffix
from consensus_tpu_torch.ops import field_p256 as fp
from consensus_tpu_torch.ops import p256
from consensus_tpu_torch.ops import scan_kernels

N = p256.N

_WINDOW_BITS = 4
_WINDOWS = 256 // _WINDOW_BITS


def _be_bytes_to_limb_rows(rows_be: np.ndarray) -> np.ndarray:
    """(n, 32) big-endian byte rows -> (n, 32) little-endian limb rows
    (uint8, the wire width; the device widens them)."""
    return rows_be[:, ::-1]


def _scalar_rows(values: Sequence[int]) -> np.ndarray:
    """Scalars below 2^256 -> (n, 32) little-endian byte rows."""
    n = len(values)
    return np.frombuffer(
        b"".join(v.to_bytes(32, "little") for v in values), dtype=np.uint8
    ).reshape(n, 32)


def _scalars_to_signed_window_digits(values: Sequence[int]) -> np.ndarray:
    """Scalars -> (65, n) signed 4-bit digits in [-8, 7], stored as d + 8
    (uint8), MSB window first.

    u2 can occupy all 256 bits (u2 < n ~ 2^256), so the LSB-to-MSB recoding
    carry can escape the top window; the carry c in {0, 1} is prepended as a
    65th, most significant window (its 4 doubles act on the identity, and
    the 64 later rounds of x16 give it weight 2^256)."""
    n = len(values)
    bits = np.unpackbits(_scalar_rows(values), axis=-1, bitorder="little")
    weights = np.array([1, 2, 4, 8], dtype=np.int32)
    u = bits.reshape(n, _WINDOWS, _WINDOW_BITS) @ weights  # (n, 64) LSB first
    d = np.zeros_like(u)
    carry = np.zeros(n, dtype=u.dtype)
    for j in range(_WINDOWS):
        t = u[:, j] + carry
        over = t >= 8
        d[:, j] = np.where(over, t - 16, t)
        carry = over.astype(u.dtype)
    full = np.concatenate([carry[:, None], d[:, ::-1]], axis=1)  # (n, 65) MSB first
    return np.ascontiguousarray(full.T + 8).astype(np.uint8)


def _scalars_to_comb_digits8(values: Sequence[int]) -> np.ndarray:
    """Scalars -> (32, n) 8-bit digits, LSB window first: with byte-sized
    windows the little-endian bytes are the digits."""
    return np.ascontiguousarray(_scalar_rows(values).T)


def verify_impl(
    qx: torch.Tensor,         # (32, batch) public key X limbs, uint8
    qy: torch.Tensor,         # (32, batch) public key Y limbs, uint8
    u1_digits: torch.Tensor,  # (32, batch) 8-bit comb digits of u1 = e/s, LSB first
    u2_digits: torch.Tensor,  # (65, batch) signed 4-bit windows of u2 = r/s, + 8, MSB first
    r1: torch.Tensor,         # (32, batch) r as field limbs
    r2: torch.Tensor,         # (32, batch) r + n as field limbs (where r + n < p)
    has_r2: torch.Tensor,     # (batch,) whether r + n < p
    host_ok: torch.Tensor,    # (batch,) host-side pre-checks passed
) -> torch.Tensor:
    """Per-lane verdicts for ``x([u1]G + [u2]Q) = r mod n``.

    Every op is independent per lane.  The inputs arrive in the narrowest
    dtype that holds them and are widened here, on the device.  Each stage
    runs in a ``torch.profiler.record_function`` range named
    ``p256.<stage>``, so a profiled run reads the stages' host and device
    time off the real call."""
    qx = qx.to(torch.float32).contiguous()
    qy = qy.to(torch.float32).contiguous()
    u1_digits = u1_digits.to(torch.int32).contiguous()
    u2_digits = u2_digits.to(torch.int32).contiguous()
    r1 = r1.to(torch.float32).contiguous()
    r2 = r2.to(torch.float32).contiguous()
    with record_function("p256.horner_scan"):
        acc = scan_kernels.horner_scan_p256(qx, qy, u2_digits)
    with record_function("p256.comb"):
        comb = scan_kernels.fixed_base_mul_comb_p256(u1_digits)
    with record_function("p256.check"):
        # Q on the curve, R' = acc + comb not the identity and x(R') = r
        # (mod n), in one kernel (P2).  The scan's and the comb's formulas
        # are polynomials, so an off-curve key is refused here, last.
        return scan_kernels.verdict_p256(
            acc, comb, qx, qy, r1, r2,
            has_r2.to(torch.bool).contiguous(), host_ok.to(torch.bool).contiguous(),
        )


def pad_prepared(prepped: Sequence[np.ndarray], padded: int) -> tuple[np.ndarray, ...]:
    """Pad the 8 host-side arrays of ``_prepare`` to ``padded`` lanes (zero
    keys, zero digits, ``host_ok`` False)."""
    qx, qy, u1d, u2d, r1, r2, has_r2, host_ok = prepped
    pad = padded - len(host_ok)
    if pad:
        qx = np.pad(qx, ((0, pad), (0, 0)))
        qy = np.pad(qy, ((0, pad), (0, 0)))
        u1d = np.pad(u1d, ((0, 0), (0, pad)))
        u2d = np.pad(u2d, ((0, 0), (0, pad)))
        r1 = np.pad(r1, ((0, pad), (0, 0)))
        r2 = np.pad(r2, ((0, pad), (0, 0)))
        has_r2 = np.pad(has_r2, (0, pad))
        host_ok = np.pad(host_ok, (0, pad))
    return qx, qy, u1d, u2d, r1, r2, has_r2, host_ok


def to_kernel_layout(qx, qy, u1d, u2d, r1, r2, has_r2, host_ok) -> tuple[np.ndarray, ...]:
    """Host row-major arrays -> the device layout as numpy: limbs and
    digits leading, batch trailing, each in its narrowest dtype."""
    return (
        np.ascontiguousarray(qx.T),
        np.ascontiguousarray(qy.T),
        np.asarray(u1d),
        np.asarray(u2d),
        np.ascontiguousarray(r1.T),
        np.ascontiguousarray(r2.T),
        np.asarray(has_r2),
        np.asarray(host_ok),
    )


def kernel_inputs_from_numpy(arrays: Sequence[np.ndarray], device: DeviceLike) -> tuple[torch.Tensor, ...]:
    """The eight layout arrays (this module's or the JAX package's
    ``to_kernel_layout``, as numpy) -> :func:`verify_impl`'s inputs on
    ``device``, keeping their narrow dtypes."""
    if len(arrays) != 8:
        raise ValueError(f"expected the 8 kernel-layout arrays, got {len(arrays)}")
    dev = torch.device(device)
    return tuple(torch.from_numpy(np.array(a)).to(dev) for a in arrays)


class EcdsaP256BatchVerifier:
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

    @staticmethod
    def _batch_invert_mod_n(values: Sequence[int]) -> list[int]:
        """Montgomery batch inversion mod the group order: one modular
        exponentiation and 3 multiplications per element.  Zeros pass
        through as zero (callers have already marked them invalid)."""
        prefix: list[int] = []
        acc = 1
        for v in values:
            prefix.append(acc)
            if v:
                acc = (acc * v) % N
        inv = pow(acc, N - 2, N)
        out = [0] * len(values)
        for i in range(len(values) - 1, -1, -1):
            if values[i]:
                out[i] = (inv * prefix[i]) % N
                inv = (inv * values[i]) % N
        return out

    def _prepare(
        self,
        messages: Sequence[bytes],
        signatures: Sequence[bytes],
        public_keys: Sequence[bytes],
    ) -> tuple[np.ndarray, ...]:
        """Host-side parse/hash/pack: the 8 unpadded arrays
        ``(qx, qy, u1 digits, u2 digits, r1, r2, has_r2, host_ok)``."""
        n = len(messages)
        host_ok = np.ones(n, dtype=bool)
        qx_rows = np.zeros((n, 32), dtype=np.uint8)
        qy_rows = np.zeros((n, 32), dtype=np.uint8)
        r1_rows = np.zeros((n, 32), dtype=np.uint8)
        r2_rows = np.zeros((n, 32), dtype=np.uint8)
        has_r2 = np.zeros(n, dtype=bool)
        u1s = [0] * n
        u2s = [0] * n
        rs = [0] * n
        ss = [0] * n
        es = [0] * n
        for i in range(n):
            sig = signatures[i]
            key = public_keys[i]
            if len(sig) != 64 or len(key) != 65 or key[0] != 0x04:
                host_ok[i] = False
                continue
            r = int.from_bytes(sig[:32], "big")
            s = int.from_bytes(sig[32:], "big")
            if not (1 <= r < N and 1 <= s < N):
                host_ok[i] = False
                continue
            qx = int.from_bytes(key[1:33], "big")
            qy = int.from_bytes(key[33:], "big")
            if qx >= fp.P or qy >= fp.P:
                host_ok[i] = False
                continue
            rs[i], ss[i] = r, s
            es[i] = int.from_bytes(hashlib.sha256(messages[i]).digest(), "big")
            qx_rows[i] = np.frombuffer(key[1:33], dtype=np.uint8)
            qy_rows[i] = np.frombuffer(key[33:], dtype=np.uint8)
            r1_rows[i] = np.frombuffer(r.to_bytes(32, "big"), dtype=np.uint8)
            if r + N < fp.P:
                has_r2[i] = True
                r2_rows[i] = np.frombuffer((r + N).to_bytes(32, "big"), dtype=np.uint8)
        ws = self._batch_invert_mod_n(ss)
        for i in range(n):
            if ss[i]:
                u1s[i] = (es[i] * ws[i]) % N
                u2s[i] = (rs[i] * ws[i]) % N
        return (
            _be_bytes_to_limb_rows(qx_rows),
            _be_bytes_to_limb_rows(qy_rows),
            _scalars_to_comb_digits8(u1s),
            _scalars_to_signed_window_digits(u2s),
            _be_bytes_to_limb_rows(r1_rows),
            _be_bytes_to_limb_rows(r2_rows),
            has_r2,
            host_ok,
        )

    def padded_size(self, n: int) -> int:
        """The device batch a wave of ``n`` signatures is padded to: the
        single-device case of the JAX package's ``engine_padded_size``."""
        if self._pad_to >= n:
            return self._pad_to
        return _next_pow2(n) if self._pad_pow2 else n

    @property
    def preferred_wave_size(self) -> int:
        """The smallest padded batch that saturates this engine (see the
        Ed25519 twin) -- coalescers read it to size waves."""
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
        prepped = self._prepare(messages, signatures, public_keys)
        return to_kernel_layout(*pad_prepared(prepped, self.padded_size(len(messages))))

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
        with record_function("p256.host_prep"):
            inputs = self.prepare_device_inputs(messages, signatures, public_keys)
        KERNELS.record_launch("ecdsa_p256.verify" + kernel_lane_suffix())
        result = verify_impl(*inputs)
        return result.cpu().numpy()[:n]

    @staticmethod
    def _verify_host(messages, signatures, public_keys) -> np.ndarray:
        """Sequential host path: the pure-Python reference below, which
        keeps the device path's checks, so a vote's validity never depends
        on the batch size that checked it."""
        return np.array(
            [
                ref_p256_verify(bytes(k), bytes(s), bytes(m))
                for m, s, k in zip(messages, signatures, public_keys)
            ],
            dtype=bool,
        )

    def verify_host(self, messages, signatures, public_keys) -> np.ndarray:
        """Verify on the host regardless of batch size, same semantics as
        the device path."""
        return self._verify_host(messages, signatures, public_keys)


def raw_signature_from_der(der: bytes) -> bytes:
    """DER ECDSA signature (``SEQUENCE { INTEGER r, INTEGER s }``) ->
    64-byte big-endian r || s.  Strict DER: definite minimal lengths,
    minimal non-negative integers, no trailing bytes; anything else raises
    ``ValueError``."""

    def read_len(buf: bytes, pos: int) -> tuple[int, int]:
        if pos >= len(buf):
            raise ValueError("DER: truncated length")
        first = buf[pos]
        if first < 0x80:
            return first, pos + 1
        count = first & 0x7F
        if count == 0 or count > 2 or pos + 1 + count > len(buf):
            raise ValueError("DER: bad length")
        value = int.from_bytes(buf[pos + 1 : pos + 1 + count], "big")
        if value < 0x80 or (count == 2 and value < 0x100):
            raise ValueError("DER: non-minimal length")
        return value, pos + 1 + count

    def read_int(buf: bytes, pos: int) -> tuple[int, int]:
        if pos >= len(buf) or buf[pos] != 0x02:
            raise ValueError("DER: expected INTEGER")
        length, pos = read_len(buf, pos + 1)
        body = buf[pos : pos + length]
        if length == 0 or len(body) != length:
            raise ValueError("DER: bad INTEGER")
        if body[0] & 0x80:
            raise ValueError("DER: negative INTEGER")
        if length > 1 and body[0] == 0 and not body[1] & 0x80:
            raise ValueError("DER: non-minimal INTEGER")
        return int.from_bytes(body, "big"), pos + length

    der = bytes(der)
    if not der or der[0] != 0x30:
        raise ValueError("DER: expected SEQUENCE")
    length, pos = read_len(der, 1)
    if pos + length != len(der):
        raise ValueError("DER: SEQUENCE length does not match the input")
    r, pos = read_int(der, pos)
    s, pos = read_int(der, pos)
    if pos != len(der):
        raise ValueError("DER: trailing bytes in SEQUENCE")
    return r.to_bytes(32, "big") + s.to_bytes(32, "big")


# --- pure-Python P-256 reference (host) --------------------------------------
# Plain-integer P-256 in Jacobian coordinates: key generation, RFC 6979
# deterministic signing and verification.  The host path for small batches
# and the signer behind models.verifier.EcdsaP256Signer.  Verification keeps
# the device path's checks: 64-byte r || s with 1 <= r, s < n; a 65-byte
# 0x04 key with coordinates below p on the curve; no low-s rule.

_P = fp.P
_G = (p256.GX, p256.GY)


def _ref_on_curve(x: int, y: int) -> bool:
    return (y * y - (x * x * x - 3 * x + p256.B)) % _P == 0


def _jac_double(pt):
    """dbl-2001-b for a = -3; None is the identity."""
    if pt is None:
        return None
    x, y, z = pt
    if y == 0:
        return None
    delta = z * z % _P
    gamma = y * y % _P
    beta = x * gamma % _P
    alpha = 3 * (x - delta) * (x + delta) % _P
    x3 = (alpha * alpha - 8 * beta) % _P
    z3 = ((y + z) * (y + z) - gamma - delta) % _P
    y3 = (alpha * (4 * beta - x3) - 8 * gamma * gamma) % _P
    return x3, y3, z3


def _jac_add(p1, p2):
    """add-2007-bl with the exceptional cases; None is the identity."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    z1z1 = z1 * z1 % _P
    z2z2 = z2 * z2 % _P
    u1 = x1 * z2z2 % _P
    u2 = x2 * z1z1 % _P
    s1 = y1 * z2 * z2z2 % _P
    s2 = y2 * z1 * z1z1 % _P
    if u1 == u2:
        return _jac_double(p1) if s1 == s2 else None
    h = (u2 - u1) % _P
    r = (s2 - s1) % _P
    hh = h * h % _P
    hhh = h * hh % _P
    v = u1 * hh % _P
    x3 = (r * r - hhh - 2 * v) % _P
    y3 = (r * (v - x3) - s1 * hhh) % _P
    return x3, y3, z1 * z2 * h % _P


def _jac_mul(k: int, pt) -> Optional[tuple[int, int, int]]:
    """[k]pt by MSB-first double and add."""
    acc = None
    for bit in bin(k)[2:] if k > 0 else "":
        acc = _jac_double(acc)
        if bit == "1":
            acc = _jac_add(acc, pt)
    return acc


@functools.lru_cache(maxsize=1)
def _g_powers() -> tuple[tuple[int, int, int], ...]:
    """[2^i]G for i = 0..255 in Jacobian form, for the fixed-base product."""
    out, cur = [], (p256.GX, p256.GY, 1)
    for _ in range(256):
        out.append(cur)
        cur = _jac_double(cur)
    return tuple(out)


def _base_mul(k: int):
    """[k]G from the precomputed powers: one add per set bit, no doubles."""
    acc = None
    powers = _g_powers()
    for i in range(k.bit_length()):
        if (k >> i) & 1:
            acc = _jac_add(acc, powers[i])
    return acc


def _to_affine(pt) -> Optional[tuple[int, int]]:
    if pt is None:
        return None
    x, y, z = pt
    zi = pow(z, _P - 2, _P)
    zi2 = zi * zi % _P
    return x * zi2 % _P, y * zi2 * zi % _P


def _check_private_key(private_key: int) -> int:
    if not 1 <= private_key < N:
        raise ValueError("P-256 private key must be in [1, n)")
    return private_key


def ref_p256_public_key(private_key: int) -> bytes:
    """The 65-byte SEC1 uncompressed public key of ``private_key``."""
    x, y = _to_affine(_base_mul(_check_private_key(private_key)))
    return b"\x04" + x.to_bytes(32, "big") + y.to_bytes(32, "big")


def _rfc6979_nonces(private_key: int, h1: bytes):
    """RFC 6979 section 3.2 candidate nonces for P-256 with HMAC-SHA-256
    (qlen = hlen = 256, so bits2int is a plain big-endian read)."""

    def mac(key: bytes, data: bytes) -> bytes:
        return hmac.new(key, data, hashlib.sha256).digest()

    x = private_key.to_bytes(32, "big")
    h = (int.from_bytes(h1, "big") % N).to_bytes(32, "big")  # bits2octets
    v = b"\x01" * 32
    k = b"\x00" * 32
    k = mac(k, v + b"\x00" + x + h)
    v = mac(k, v)
    k = mac(k, v + b"\x01" + x + h)
    v = mac(k, v)
    while True:
        v = mac(k, v)
        candidate = int.from_bytes(v, "big")
        if 1 <= candidate < N:
            yield candidate
        k = mac(k, v + b"\x00")
        v = mac(k, v)


def ref_p256_sign(private_key: int, message: bytes) -> bytes:
    """ECDSA over SHA-256 with the RFC 6979 deterministic nonce: the
    64-byte big-endian r || s."""
    d = _check_private_key(private_key)
    h1 = hashlib.sha256(message).digest()
    e = int.from_bytes(h1, "big")
    for k in _rfc6979_nonces(d, h1):
        r = _to_affine(_base_mul(k))[0] % N
        if r == 0:
            continue
        s = pow(k, N - 2, N) * (e + r * d) % N
        if s == 0:
            continue
        return r.to_bytes(32, "big") + s.to_bytes(32, "big")
    raise AssertionError("unreachable: the nonce generator does not end")


def ref_p256_verify(public_key: bytes, signature: bytes, message: bytes) -> bool:
    """ECDSA-P256/SHA-256 verification with the device path's checks."""
    if len(signature) != 64 or len(public_key) != 65 or public_key[0] != 0x04:
        return False
    r = int.from_bytes(signature[:32], "big")
    s = int.from_bytes(signature[32:], "big")
    if not (1 <= r < N and 1 <= s < N):
        return False
    qx = int.from_bytes(public_key[1:33], "big")
    qy = int.from_bytes(public_key[33:], "big")
    if qx >= _P or qy >= _P or not _ref_on_curve(qx, qy):
        return False
    e = int.from_bytes(hashlib.sha256(message).digest(), "big")
    w = pow(s, N - 2, N)
    point = _jac_add(_base_mul(e * w % N), _jac_mul(r * w % N, (qx, qy, 1)))
    affine = _to_affine(point)
    return affine is not None and affine[0] % N == r


__all__ = [
    "EcdsaP256BatchVerifier",
    "N",
    "kernel_inputs_from_numpy",
    "pad_prepared",
    "raw_signature_from_der",
    "ref_p256_public_key",
    "ref_p256_sign",
    "ref_p256_verify",
    "to_kernel_layout",
    "verify_impl",
]
