"""Half-aggregation of Ed25519 quorum certificates (arXiv:2302.00418): the
torch port of ``consensus_tpu/models/aggregate.py``.

A quorum cert of n commit signatures ``(R_i, s_i)`` collapses to ``(R_1..R_n,
s_agg)`` with ``s_agg = sum z_i s_i mod L``.  The coefficients are
transcript-derived (Fiat-Shamir over the length-framed ``(message, R,
key)`` triples: no wallclock, no ambient RNG) with ``z_1 = 1``, sound to
2^-128 (SAFETY.md 9).

Verification checks ``[s_agg]B + sum [z_i k_i mod L](-A_i) + sum [z_i](-R_i)
= 0`` with ``k_i = SHA-512(R_i || A_i || m_i) mod L``: the randomized
batch-verify equation with the aggregate base-point scalar supplied by the
cert.  Three backends: the fused device path (the transcript and challenges
hashed on the device, :func:`consensus_tpu_torch.models.fused
.fused_aggregate_check`), the host-prep device path (the Straus MSM kernel
B3 through :func:`consensus_tpu_torch.models.ed25519.batch_verify_impl`),
and the big-int host twin with the same two-phase window schedule.  Each
device verify is ONE B3 launch, booked in the kernel ledger as
``ed25519.halfagg_verify`` (``ed25519.fused_halfagg_verify`` fused), so a
launch count attributes cert verifies apart from batch-verify traffic.

Aggregation is self-checking: the aggregator verifies the cert it built
before releasing it, and on failure bisects with fresh transcripts; subsets
below the bisection floor are decided by STRICT verification, so the
localized bad components equal the strict verifier's on every rejection
class.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence

import numpy as np
import torch

from consensus_tpu_torch.device import DeviceLike, resolve_device
from consensus_tpu_torch.obs.kernels import KERNELS
from consensus_tpu_torch.ops import field25519 as fe

from consensus_tpu_torch.models.ed25519 import (
    _BASE_POINT,
    _REF_IDENTITY,
    _TABLE,
    _WINDOWS,
    _Z_WINDOWS,
    Ed25519BatchVerifier,
    L,
    _bits_to_comb_digits8,
    _bytes_rows_to_bits,
    _next_pow2,
    _prep_compressed,
    _ref_add,
    _ref_decompress,
    _ref_mul,
    _ref_negate,
    _signed_digits_int,
    batch_verify_impl,
)

#: Domain separation for the half-aggregation transcript.  Distinct from
#: the batch tag (``ctpu/batchz/v1``): a half-agg VERIFIER never sees
#: per-signer s_i, so the cert transcript commits to (message, R, key) only.
_HALFAGG_TAG = b"ctpu/halfagg/v1"


def halfagg_coefficients(
    messages: Sequence[bytes],
    rs: Sequence[bytes],
    public_keys: Sequence[bytes],
) -> list[int]:
    """Deterministic cert coefficients: ``z_1 = 1``, ``z_i = H(root || i)[:16]``
    for i >= 2, the root a Fiat-Shamir commitment to every length-framed
    ``(message, R, key)`` triple."""
    if not messages:
        return []
    sha512 = hashlib.sha512

    def frame(raw: bytes) -> bytes:
        return len(raw).to_bytes(8, "little") + bytes(raw)

    leaves = [
        sha512(frame(m) + frame(r) + frame(a)).digest()
        for m, r, a in zip(messages, rs, public_keys)
    ]
    root = sha512(
        _HALFAGG_TAG + len(leaves).to_bytes(8, "little") + b"".join(leaves)
    ).digest()
    zs = [1]
    for i in range(1, len(leaves)):
        zs.append(
            int.from_bytes(
                sha512(root + i.to_bytes(8, "little")).digest()[:16], "little"
            )
            or 1
        )
    return zs


def _challenge(r: bytes, key: bytes, message: bytes) -> int:
    """RFC 8032 per-signature challenge k_i = SHA-512(R_i || A_i || m_i) mod L."""
    return (
        int.from_bytes(
            hashlib.sha512(bytes(r) + bytes(key) + bytes(message)).digest(),
            "little",
        )
        % L
    )


_Y_MASK = (1 << 255) - 1


class HalfAggregator:
    """Aggregate and verify half-aggregated Ed25519 quorum certs.

    Backend knobs mirror (and, when ``engine`` is given, are inherited from)
    :class:`Ed25519BatchVerifier`: its padding, device threshold, device and
    fused front end, so a deployment's routing applies to cert verifies
    unchanged.  Without an engine the device is ``cuda`` unless ``device``
    names another."""

    def __init__(
        self,
        *,
        engine: Optional[object] = None,
        pad_pow2: bool = True,
        min_device_batch: int = 1,
        pad_to: int = 0,
        min_bisect: int = 2,
        device_prep: Optional[bool] = None,
        device: DeviceLike = None,
    ) -> None:
        if engine is not None:
            pad_pow2 = getattr(engine, "_pad_pow2", pad_pow2)
            min_device_batch = getattr(
                engine, "_min_device_batch", min_device_batch
            )
            pad_to = getattr(engine, "_pad_to", pad_to)
            if device is None:
                device = getattr(engine, "device", None)
            if device_prep is None:
                # Inherit the fused front end from the engine: a device_prep
                # deployment's cert verifies go bytes-in -> verdict-out too.
                device_prep = bool(getattr(engine, "fused", False))
        self._engine = engine
        self._pad_pow2 = pad_pow2
        self._min_device_batch = min_device_batch
        self._pad_to = pad_to
        self._min_bisect = max(2, int(min_bisect))
        self._device_prep = bool(device_prep)
        self.device = resolve_device(device)
        #: Aggregate-equation checks performed (each is one MSM launch on
        #: the device path / one host-twin evaluation).
        self.aggregate_checks = 0
        #: Aggregations whose self-check failed and fell back to the
        #: bisection localizer.
        self.fallback_bisections = 0

    # --- aggregation (the committing replica holds full signatures) -------

    def aggregate(
        self,
        messages: Sequence[bytes],
        signatures: Sequence[bytes],
        public_keys: Sequence[bytes],
    ) -> tuple[Optional[tuple[tuple[bytes, ...], bytes]], tuple[int, ...]]:
        """Build ``(rs, s_agg)`` from full signatures, self-checking the
        result before release.

        Returns ``((rs, s_agg), ())`` on success, or ``(None, bad_indices)``
        when any component is invalid, ``bad_indices`` localized by
        bisection with strict per-signature parity."""
        n = len(messages)
        if not (n == len(signatures) == len(public_keys)):
            raise ValueError("aggregate length mismatch")
        if n == 0:
            return None, ()
        rs: list[bytes] = []
        ss: list[int] = []
        bad: list[int] = []
        for i in range(n):
            sig = bytes(signatures[i])
            if len(sig) != 64 or int.from_bytes(sig[32:], "little") >= L:
                bad.append(i)
                rs.append(b"\x00" * 32)
                ss.append(0)
                continue
            rs.append(sig[:32])
            ss.append(int.from_bytes(sig[32:], "little"))
        if not bad:
            zs = halfagg_coefficients(messages, rs, public_keys)
            s_agg = sum(z * s for z, s in zip(zs, ss)) % L
            s_bytes = s_agg.to_bytes(32, "little")
            if self.verify(messages, rs, s_bytes, public_keys):
                return (tuple(rs), s_bytes), ()
        self.fallback_bisections += 1
        bad_set = set(bad)
        bad_set.update(
            self._bisect(
                [i for i in range(n) if i not in bad_set],
                messages, signatures, public_keys,
            )
        )
        return None, tuple(sorted(bad_set))

    def _bisect(self, idx, messages, signatures, public_keys) -> list[int]:
        """Localize bad components: aggregate-check subsets under FRESH
        transcripts, strict-verify below the floor."""
        if not idx:
            return []
        if len(idx) < self._min_bisect:
            sub = self._strict(
                [messages[i] for i in idx],
                [bytes(signatures[i]) for i in idx],
                [public_keys[i] for i in idx],
            )
            return [i for j, i in enumerate(idx) if not sub[j]]
        msgs = [messages[i] for i in idx]
        rs = [bytes(signatures[i])[:32] for i in idx]
        keys = [public_keys[i] for i in idx]
        zs = halfagg_coefficients(msgs, rs, keys)
        s_agg = (
            sum(
                z * int.from_bytes(bytes(signatures[i])[32:], "little")
                for z, i in zip(zs, idx)
            )
            % L
        ).to_bytes(32, "little")
        if self.verify(msgs, rs, s_agg, keys):
            return []
        mid = len(idx) // 2
        return self._bisect(
            idx[:mid], messages, signatures, public_keys
        ) + self._bisect(idx[mid:], messages, signatures, public_keys)

    def _strict(self, messages, signatures, public_keys) -> np.ndarray:
        if self._engine is not None:
            return np.asarray(
                self._engine.verify_host(messages, signatures, public_keys)
            )
        return Ed25519BatchVerifier._verify_host(
            messages, signatures, public_keys
        )

    # --- verification (any replica; full sigs never needed) ---------------

    def verify(
        self,
        messages: Sequence[bytes],
        rs: Sequence[bytes],
        s_agg: bytes,
        public_keys: Sequence[bytes],
    ) -> bool:
        """One aggregate-equation check, all-or-nothing: True iff every
        component encoding is canonical and decodable AND the MSM lands on
        the identity."""
        n = len(messages)
        if not (n == len(rs) == len(public_keys)):
            raise ValueError("verify length mismatch")
        if n == 0:
            return False
        s_agg = bytes(s_agg)
        if len(s_agg) != 32:
            return False
        u = int.from_bytes(s_agg, "little")
        if u >= L:  # canonical aggregate scalar: same reject class as S >= L
            return False
        for raw in list(rs) + list(public_keys):
            raw = bytes(raw)
            if len(raw) != 32 or (
                int.from_bytes(raw, "little") & _Y_MASK
            ) >= fe.P:
                return False
        self.aggregate_checks += 1
        if self._device_prep and n >= self._min_device_batch:
            # Fused path: the coefficient transcript, the challenge hashes and
            # the mod-L products all run on the device in the one check
            # (models/fused.py); the host work above was byte compares.
            from consensus_tpu_torch.models.fused import fused_aggregate_check

            eq_ok, valid = fused_aggregate_check(
                name="ed25519.fused_halfagg_verify",
                tag=_HALFAGG_TAG,
                messages=messages,
                rs=rs,
                keys=public_keys,
                leaf_mids=rs,
                pad_to=self._pad_to,
                pad_pow2=self._pad_pow2,
                device=self.device,
                u_bytes=s_agg,
                fixed_z1=True,
            )
            return bool(all(valid) and eq_ok)
        zs = halfagg_coefficients(messages, rs, public_keys)
        zk = [
            (z * _challenge(r, a, m)) % L
            for z, r, a, m in zip(zs, rs, public_keys, messages)
        ]
        if n >= self._min_device_batch:
            return self._verify_device(rs, public_keys, u, zk, zs)
        return self._verify_host(rs, public_keys, u, zk, zs)

    def _verify_device(self, rs, public_keys, u, zk, zs) -> bool:
        """One shared-doubling MSM launch for the whole cert."""
        m = len(rs)
        y_r, sign_r, _ = _prep_compressed([bytes(r) for r in rs])
        y_a, sign_a, _ = _prep_compressed([bytes(a) for a in public_keys])
        zk_digits = np.array(
            [_signed_digits_int(v, _WINDOWS) for v in zk], dtype=np.int16
        ).T
        z_digits = np.array(
            [_signed_digits_int(z, _Z_WINDOWS) for z in zs], dtype=np.int16
        ).T
        zk_digits = (zk_digits + 8).astype(np.uint8)
        z_digits = (z_digits + 8).astype(np.uint8)
        u_row = np.frombuffer(u.to_bytes(32, "little"), dtype=np.uint8).reshape(1, 32)
        zs_digits8 = _bits_to_comb_digits8(_bytes_rows_to_bits(u_row))
        host_ok = np.ones(m, dtype=bool)

        if self._pad_to >= m:
            padded = self._pad_to
        else:
            padded = _next_pow2(m) if self._pad_pow2 else m
        if padded != m:
            pad = padded - m
            y_r = np.pad(y_r, ((0, pad), (0, 0)))
            y_a = np.pad(y_a, ((0, pad), (0, 0)))
            sign_r = np.pad(sign_r, (0, pad))
            sign_a = np.pad(sign_a, (0, pad))
            zk_digits = np.pad(zk_digits, ((0, 0), (0, pad)), constant_values=8)
            z_digits = np.pad(z_digits, ((0, 0), (0, pad)), constant_values=8)
            host_ok = np.pad(host_ok, (0, pad))

        arrays = (y_r.T, sign_r, y_a.T, sign_a, zs_digits8, zk_digits, z_digits, host_ok)
        inputs = [torch.from_numpy(np.ascontiguousarray(a)).to(self.device) for a in arrays]
        KERNELS.record_launch("ed25519.halfagg_verify")
        eq_ok, valid = batch_verify_impl(*inputs)
        # A non-decodable R or A is masked to the identity inside the MSM, so
        # eq_ok alone could still be True: the whole cert must reject.
        out = torch.cat([eq_ok.reshape(1), valid[:m]]).cpu().numpy()
        return bool(out[1:].all()) and bool(out[0])

    def _verify_host(self, rs, public_keys, u, zk, zs) -> bool:
        """Host big-int twin: the SAME two-phase shared-window schedule as
        the kernel, in plain integers."""
        m = len(rs)
        a_pts = [_ref_decompress(bytes(a)) for a in public_keys]
        r_pts = [_ref_decompress(bytes(r)) for r in rs]
        if any(p is None for p in a_pts) or any(p is None for p in r_pts):
            return False

        def table(p):
            neg = _ref_negate(p)
            tbl = [_REF_IDENTITY, neg]
            for _ in range(_TABLE - 2):
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
                    acc = _ref_add(
                        acc, a_tbl[j][d] if d > 0 else _ref_negate(a_tbl[j][-d])
                    )
                if w >= low_start:
                    d = z_digits[j][w - low_start]
                    if d:
                        acc = _ref_add(
                            acc,
                            r_tbl[j][d] if d > 0 else _ref_negate(r_tbl[j][-d]),
                        )
        acc = _ref_add(acc, _ref_mul(u, _BASE_POINT))
        return acc[0] % fe.P == 0 and (acc[1] - acc[2]) % fe.P == 0


__all__ = [
    "HalfAggregator",
    "halfagg_coefficients",
]
