"""Fused bytes-in -> verdict-out Ed25519 engines (``Configuration.device_prep``):
the torch port of ``consensus_tpu/models/fused.py``.  Its mesh classes are
in :mod:`consensus_tpu_torch.parallel.sharding`, as in the JAX package.

The host-prep engines (:mod:`consensus_tpu_torch.models.ed25519`) hash the
challenge ``k = SHA-512(R || A || M) mod L``, range-check and recode on the
host, a Python loop per signature.  These engines leave the host only byte
movement (slicing ``R || A || M`` into padded SHA-512 blocks,
:func:`consensus_tpu_torch.ops.sha512.pad_messages`); one device pass per
wave does the rest:

    SHA-512 (kernel S1) -> reduce mod L, digit recode and canonical checks
    (kernel L1) -> decompress -> [k](-A) (kernel B1) -> comb -> verdict

For the randomized-batch and half-aggregation paths the Fiat-Shamir
transcript moves to the device too: the per-lane leaf hashes, the root hash
over the leaf digests assembled on the device
(:func:`consensus_tpu_torch.ops.sha512.pack_bytes_device`), the coefficient
hashes ``z_i = H(root || i)``, the products ``z_i k_i mod L`` and ``sum z_i
s_i mod L``, then the shared-doubling MSM (kernel B3): one device pass per
aggregate check, no host round-trip between hashing and the MSM.

Parity contract (SAFETY.md 10): accept/reject is bit-identical to the
host-prep engines on every rejection class, and the randomized transcript
bytes are identical, so bisection takes identical paths.

The JAX module donates the block arrays to XLA; torch has no donation, so
the block tensors live until their wave's call returns (ROADMAP.md,
divergences).  Each device call is booked in the kernel ledger under the
JAX package's names: ``ed25519.fused_verify``, ``ed25519.fused_batch_verify``
and ``ed25519.fused_halfagg_verify``.
"""

from __future__ import annotations

import functools
import hashlib
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from consensus_tpu_torch.device import DeviceLike
from consensus_tpu_torch.obs.kernels import KERNELS, kernel_lane_suffix
from consensus_tpu_torch.ops import field25519 as fe
from consensus_tpu_torch.ops import scalar25519 as sc
from consensus_tpu_torch.ops import sha512 as sh

from consensus_tpu_torch.models.ed25519 import (
    _Z_TAG,
    _next_pow2,
    _transcript_coefficients,
    Ed25519BatchVerifier,
    Ed25519RandomizedBatchVerifier,
    L,
    batch_verify_impl,
    verify_impl,
)

_L_BYTES_BE = np.frombuffer(L.to_bytes(32, "big"), dtype=np.uint8)
_P_BYTES_BE = np.frombuffer(fe.P.to_bytes(32, "big"), dtype=np.uint8)


# --- host-side helpers (byte movement + vectorized range checks) -----------


def _rows_lt_be(rows_be: np.ndarray, bound_be: np.ndarray) -> np.ndarray:
    """Vectorized big-endian lexicographic ``row < bound`` (row == bound
    compares False, matching the exclusive canonical ranges)."""
    n = rows_be.shape[0]
    diff = rows_be != bound_be
    first = np.argmax(diff, axis=1)
    lt = rows_be[np.arange(n), first] < bound_be[first]
    return np.where(diff.any(axis=1), lt, False)


def canonical_ok_fast(signatures, public_keys) -> np.ndarray:
    """Vectorized twin of ``Ed25519BatchVerifier._canonical_ok`` -- same
    classes (sig/key length, S < L, canonical y for R and A), no per-lane
    big-int loop.  The randomized fused engine pre-filters its subset with
    this so transcript membership matches the host-prep path exactly."""
    n = len(signatures)
    ok = np.ones(n, dtype=bool)
    sig_chunks: list[bytes] = []
    key_chunks: list[bytes] = []
    for i in range(n):
        sig, key = bytes(signatures[i]), bytes(public_keys[i])
        if len(sig) != 64:
            ok[i] = False
            sig = b"\x00" * 64
        if len(key) != 32:
            ok[i] = False
            key = b"\x00" * 32
        sig_chunks.append(sig)
        key_chunks.append(key)
    if n == 0:
        return ok
    sig_rows = np.frombuffer(b"".join(sig_chunks), dtype=np.uint8).reshape(n, 64)
    key_rows = np.frombuffer(b"".join(key_chunks), dtype=np.uint8).reshape(n, 32)
    ok &= _rows_lt_be(sig_rows[:, :31:-1], _L_BYTES_BE)  # S < L
    y_r = sig_rows[:, 31::-1].copy()
    y_r[:, 0] &= 0x7F
    ok &= _rows_lt_be(y_r, _P_BYTES_BE)
    y_a = key_rows[:, ::-1].copy()
    y_a[:, 0] &= 0x7F
    ok &= _rows_lt_be(y_a, _P_BYTES_BE)
    return ok


def _byte_rows(chunks: Sequence[bytes], width: int) -> np.ndarray:
    return np.frombuffer(b"".join(chunks), dtype=np.uint8).reshape(
        len(chunks), width
    )


def _pad_wave(arrays: Sequence[np.ndarray], n: int, padded: int):
    """Zero-pad the leading batch dim of row-major host arrays."""
    if padded == n:
        return list(arrays)
    out = []
    for a in arrays:
        pad = [(0, 0)] * a.ndim
        pad[0] = (0, padded - n)
        out.append(np.pad(a, pad))
    return out


def _pack_blocks(messages: Sequence[bytes], *, min_blocks: int = 1):
    """Pad+pack messages, quantizing the block axis to a power of two, as
    the JAX module does to keep its compiled-shape set a short ladder."""
    longest = max((len(m) for m in messages), default=0)
    want = _next_pow2(sh.padded_blocks_for(longest), minimum=min_blocks)
    return sh.pad_messages(messages, min_blocks=want)


def _padded(n: int, pad_to: int, pad_pow2: bool) -> int:
    if pad_to >= n:
        return pad_to
    return _next_pow2(n) if pad_pow2 else n


def _to_device(arrays: Sequence[np.ndarray], device: torch.device, *, pin: bool = False):
    """Host arrays -> tensors on ``device`` (uint32 block words as int32 of
    the same bits).  ``pin`` stages them in pinned host memory and copies
    with ``non_blocking=True``, so the copy queues behind the device's work
    instead of waiting for it."""
    out = []
    for a in arrays:
        a = np.require(a, requirements=("C", "W"))
        t = sh.blocks_tensor(a) if a.dtype == np.uint32 else torch.from_numpy(a)
        if pin and device.type == "cuda":
            out.append(t.pin_memory().to(device, non_blocking=True))
        else:
            out.append(t.to(device))
    return tuple(out)


# --- the fused strict body ---------------------------------------------------


def fused_verify_impl(
    sig_rows: torch.Tensor,  # (64, batch) uint8 signature bytes R || S
    key_rows: torch.Tensor,  # (32, batch) uint8 public-key bytes
    blocks: torch.Tensor,    # (B, 16, 2, batch) int32 padded SHA-512(R||A||M) blocks
    n_blocks: torch.Tensor,  # (batch,) int32 active block counts
    host_ok: torch.Tensor,   # (batch,) bool: host length checks passed
) -> torch.Tensor:
    """The fused strict body: the whole front end on the device (S1 for the
    hash; L1 for k = H mod L and its digits, read from S1's state words, and
    the canonical checks S < L, y_R < p, y_A < p in the same launch), then
    the host-prep engine's device body
    (:func:`consensus_tpu_torch.models.ed25519.verify_impl`, B1) with the S
    bytes as the comb's 8-bit digits.  Each front-end stage runs in a
    ``record_function`` range ``ed25519.fused.<stage>``; ``verify_impl``
    keeps its own."""
    with record_function("ed25519.fused.sha512"):
        state = sh.sha512_blocks(blocks, n_blocks)
    with record_function("ed25519.fused.scalars"):
        k_digits, ok = sc.scalar_challenge_checked(state, sig_rows, key_rows, host_ok)
    with record_function("ed25519.fused.checks"):
        sig = sig_rows.to(torch.int32)
        key = key_rows.to(torch.int32)
        s_bytes = sig[32:]
        y_r = torch.cat([sig[:31], (sig[31] & 0x7F)[None]])
        sign_r = sig[31] >> 7
        y_a = torch.cat([key[:31], (key[31] & 0x7F)[None]])
        sign_a = key[31] >> 7
    return verify_impl(y_r, sign_r, y_a, sign_a, s_bytes, k_digits, ok)


class FusedEd25519BatchVerifier(Ed25519BatchVerifier):
    """Strict verifier with the on-device front end.

    Same contract and bit-identical verdicts as
    :class:`~consensus_tpu_torch.models.ed25519.Ed25519BatchVerifier`; the
    host work per wave is one pass of byte slicing into the block layout.
    A device call launches S1, L1, D1, B1, D2 and E1 once each on the
    card."""

    fused = True

    def _prepare_fused(self, messages, signatures, public_keys):
        n = len(messages)
        host_ok = np.ones(n, dtype=bool)
        sig_chunks: list[bytes] = []
        key_chunks: list[bytes] = []
        prehash: list[bytes] = []
        for i in range(n):
            sig, key = bytes(signatures[i]), bytes(public_keys[i])
            if len(sig) != 64:
                host_ok[i] = False
                sig = b"\x00" * 64
            if len(key) != 32:
                host_ok[i] = False
                key = b"\x00" * 32
            sig_chunks.append(sig)
            key_chunks.append(key)
            prehash.append(sig[:32] + key + bytes(messages[i]))
        sig_rows = _byte_rows(sig_chunks, 64)
        key_rows = _byte_rows(key_chunks, 32)
        blocks, n_blocks = _pack_blocks(prehash)
        return sig_rows, key_rows, blocks, n_blocks, host_ok

    def host_layout(self, messages, signatures, public_keys) -> list[np.ndarray]:
        """Pack one wave, padded to :meth:`padded_size`:
        :func:`fused_verify_impl`'s arguments as host arrays."""
        n = len(messages)
        sig_rows, key_rows, blocks, n_blocks, host_ok = self._prepare_fused(
            messages, signatures, public_keys
        )
        padded = self.padded_size(n)
        sig_rows, key_rows, n_blocks, host_ok = _pad_wave(
            [sig_rows, key_rows, n_blocks, host_ok], n, padded
        )
        if padded != n:
            blocks = np.pad(blocks, ((0, 0),) * 3 + ((0, padded - n),))
        return [sig_rows.T, key_rows.T, blocks, n_blocks, host_ok]

    def _device_args(self, messages, signatures, public_keys, *, pin: bool = False):
        """:meth:`host_layout` as device tensors."""
        return _to_device(
            self.host_layout(messages, signatures, public_keys), self.device, pin=pin
        )

    def verify_batch(self, messages, signatures, public_keys) -> np.ndarray:
        n = len(messages)
        if not (n == len(signatures) == len(public_keys)):
            raise ValueError("batch length mismatch")
        if n == 0:
            return np.zeros(0, dtype=bool)
        if n < self._min_device_batch:
            return self._verify_host(messages, signatures, public_keys)
        with record_function("ed25519.fused.host_prep"):
            args = self._device_args(messages, signatures, public_keys)
        KERNELS.record_launch("ed25519.fused_verify" + kernel_lane_suffix())
        return fused_verify_impl(*args).cpu().numpy()[:n]

    def verify_stream(
        self, waves: Iterable[Tuple[Sequence, Sequence, Sequence]]
    ) -> Iterable[np.ndarray]:
        """Double-buffered streaming: wave i+1 is packed, staged in pinned
        memory and queued (its copies, S1, B1 and the rest) before wave i's
        verdict is read, so the host's byte packing overlaps the device's
        work.  The read of a verdict is the only wait; verdicts come out in
        wave order.  Every wave takes the device path."""
        pending: Optional[tuple[int, torch.Tensor]] = None
        for messages, signatures, public_keys in waves:
            n = len(messages)
            with record_function("ed25519.fused.host_prep"):
                args = self._device_args(messages, signatures, public_keys, pin=True)
            KERNELS.record_launch("ed25519.fused_verify" + kernel_lane_suffix())
            out = fused_verify_impl(*args)
            if pending is not None:
                prev_n, prev_out = pending
                yield prev_out.cpu().numpy()[:prev_n]
            pending = (n, out)
        if pending is not None:
            yield pending[1].cpu().numpy()[: pending[0]]


# --- the fused aggregate body (randomized batch + half-agg) -----------------


def _aggregate_constants(tag: bytes, n: int, padded: int):
    """Host constants of one aggregate body: the transcript prefix and
    trailers and the per-lane index rows."""
    prefix = tag + n.to_bytes(8, "little")
    root_len = len(prefix) + 64 * n
    root_blocks = sh.padded_blocks_for(root_len)
    root_prefix = np.frombuffer(prefix, dtype=np.uint8)[:, None]
    root_trailer = np.frombuffer(sh.pad_trailer(root_len), dtype=np.uint8)[:, None]
    z_trailer = np.broadcast_to(
        np.frombuffer(sh.pad_trailer(72), dtype=np.uint8)[:, None], (56, padded)
    )
    idx_rows = _byte_rows(
        [i.to_bytes(8, "little") for i in range(padded)], 8
    ).T  # (8, padded)
    return root_prefix, root_trailer, root_blocks, z_trailer, idx_rows


@functools.lru_cache(maxsize=8)
def _lane_constants(padded: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The coefficient hashes' per-lane rows on ``device``: the 8 index
    bytes of every lane ``(8, padded)`` and the padding trailer of a
    72-byte message ``(56, 1)``, shared by every subset size."""
    _, _, _, z_trailer, idx_rows = _aggregate_constants(b"", 0, padded)
    return (
        torch.from_numpy(idx_rows.astype(np.int32)).to(device),
        torch.from_numpy(np.ascontiguousarray(z_trailer[:, :1]).astype(np.int32)).to(device),
    )


@functools.lru_cache(maxsize=64)
def _root_rows(tag: bytes, n: int, device: torch.device):
    """The transcript root's constant rows on ``device`` -- the prefix
    ``tag || n`` and the padding trailer -- and its block count, copied once
    per subset size (a copy from pageable memory would wait for the
    device's queued work)."""
    root_prefix, root_trailer, root_blocks, _, _ = _aggregate_constants(tag, n, 0)
    return (
        torch.from_numpy(root_prefix.astype(np.int32)).to(device),
        torch.from_numpy(root_trailer.astype(np.int32)).to(device),
        root_blocks,
    )


def transcript_coefficients(
    tag: bytes, n: int, leaves: torch.Tensor, padded: int, start: int = 0,
    width: Optional[int] = None, *, fixed_z1: bool = False,
) -> torch.Tensor:
    """The coefficients of lanes ``start .. start + width`` from the leaf
    digest table ``leaves`` ((64, >= n) int32, on the device the
    coefficients come out on): the root ``H(tag || n || leaf_0 ..
    leaf_{n-1})`` over the live ``n`` leaves, then ``z_i = H(root ||
    i)[:16]`` (a zero ``z`` re-mapped to 1, as the host derivation does;
    lane 0 pinned to 1 with ``fixed_z1``).  ``padded`` is the whole wave's
    width, so a shard of a sharded engine derives its own lanes'
    coefficients.  Returns ``(16, width)`` int32 little-endian bytes; on the
    card it launches S1 twice (the root, the coefficients)."""
    device = leaves.device
    width = padded - start if width is None else width
    prefix, trailer, root_blocks = _root_rows(bytes(tag), n, device)
    idx_rows, z_trailer = _lane_constants(padded, device)
    root_rows = torch.cat([prefix, leaves[:, :n].T.reshape(64 * n, 1), trailer])
    root = sh.digest_bytes(sh.sha512_blocks(
        sh.pack_bytes_device(root_rows),
        torch.full((1,), root_blocks, dtype=torch.int32, device=device),
    ))  # (64, 1)
    z_rows = torch.cat([
        root.expand(64, width), idx_rows[:, start:start + width], z_trailer.expand(56, width),
    ])
    z_digest = sh.digest_bytes(sh.sha512_blocks(
        sh.pack_bytes_device(z_rows), torch.ones((width,), dtype=torch.int32, device=device),
    ))
    one_z = torch.zeros((16, 1), dtype=torch.int32, device=device)
    one_z[0, 0] = 1
    z = z_digest[:16]
    z = torch.where((z == 0).all(dim=0)[None], one_z, z)
    if fixed_z1:
        lane0 = (torch.arange(start, start + width, device=device) == 0)[None]
        z = torch.where(lane0, one_z, z)
    return z


def device_transcript(
    tag: bytes, n: int, leaf_blocks: torch.Tensor, leaf_nblocks: torch.Tensor, *,
    fixed_z1: bool = False,
) -> torch.Tensor:
    """The Fiat-Shamir coefficients on the device: the leaf digests of every
    lane, then :func:`transcript_coefficients` over them for every lane.
    Returns ``(16, padded)`` int32 little-endian bytes; on the card it
    launches S1 three times (leaves, root, coefficients)."""
    leaves = sh.digest_bytes(sh.sha512_blocks(leaf_blocks, leaf_nblocks))
    return transcript_coefficients(tag, n, leaves, leaf_blocks.shape[-1], fixed_z1=fixed_z1)


def aggregate_leaves(
    k_blocks: torch.Tensor,
    k_nblocks: torch.Tensor,
    leaf_blocks: torch.Tensor,
    leaf_nblocks: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The aggregate body's first stage, lane by lane: the challenge scalars
    ``k_i = H(R_i || A_i || m_i) mod L`` ((32, lanes) bytes) and the
    transcript leaf digests ((64, lanes)).  On the card it launches S1
    twice and L1 once; L1 reads the challenge hash's state words as S1
    leaves them."""
    with record_function("ed25519.fused.challenge"):
        k_bytes = sc.scalar_challenge(sh.sha512_blocks(k_blocks, k_nblocks), digits=False)
    with record_function("ed25519.fused.transcript"):
        leaves = sh.digest_bytes(sh.sha512_blocks(leaf_blocks, leaf_nblocks))
    return k_bytes, leaves


def aggregate_verdict(
    z: torch.Tensor,
    k_bytes: torch.Tensor,
    r_rows: torch.Tensor,
    s_rows: torch.Tensor,
    key_rows: torch.Tensor,
    host_ok: torch.Tensor,
    u: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The aggregate body's second stage, from the coefficients ``z`` to the
    check: the digits of ``z_i k_i`` and ``z_i`` and the base scalar ``u =
    sum z_i s_i mod L`` (unless ``u`` is given: half-agg's certificate
    scalar) in one launch of L1, then :func:`batch_verify_impl` (D1, B3,
    D2, E1).  Returns its ``(eq_ok, valid)``."""
    with record_function("ed25519.fused.scalars"):
        s = None if u is not None else s_rows.to(torch.int32).contiguous()
        zk_digits, z_digits, zs = sc.scalar_aggregate(z, k_bytes, s)
        u = zs if u is None else u
    r = r_rows.to(torch.int32)
    key = key_rows.to(torch.int32)
    y_r = torch.cat([r[:31], (r[31] & 0x7F)[None]])
    y_a = torch.cat([key[:31], (key[31] & 0x7F)[None]])
    return batch_verify_impl(y_r, r[31] >> 7, y_a, key[31] >> 7, u, zk_digits, z_digits, host_ok)


@functools.lru_cache(maxsize=None)
def _fused_aggregate_kernel(
    name: str, tag: bytes, n: int, padded: int, fixed_z1: bool, u_input: bool
):
    """One aggregate body, booked under ``name`` in the kernel ledger: the
    device Fiat-Shamir transcript (:func:`aggregate_leaves`, then
    :func:`transcript_coefficients`) feeding the shared-doubling MSM
    (:func:`aggregate_verdict`).  Cached by the JAX module's graph key.

    ``fixed_z1`` pins lane 0's coefficient to 1 (half-aggregation);
    ``u_input`` takes the aggregate base scalar from the certificate instead
    of computing ``sum z_i s_i mod L`` from per-lane S (which half-agg
    verifiers never see)."""

    def kernel(
        r_rows,        # (32, padded) R bytes
        s_rows,        # (32, padded) S bytes (zeros when u_input)
        key_rows,      # (32, padded) A bytes
        k_blocks,      # (Bk, 16, 2, padded) SHA-512(R||A||M) blocks
        k_nblocks,     # (padded,)
        leaf_blocks,   # (Bl, 16, 2, padded) transcript leaf blocks
        leaf_nblocks,  # (padded,)
        host_ok,       # (padded,)
        u_bytes,       # (32, 1) aggregate base scalar (ignored unless u_input)
    ):
        KERNELS.record_launch(name)
        k_bytes, leaves = aggregate_leaves(k_blocks, k_nblocks, leaf_blocks, leaf_nblocks)
        with record_function("ed25519.fused.transcript"):
            z = transcript_coefficients(tag, n, leaves, padded, fixed_z1=fixed_z1)
        u = u_bytes.to(torch.int32) if u_input else None
        return aggregate_verdict(z, k_bytes, r_rows, s_rows, key_rows, host_ok, u)

    return kernel


def _frame(raw: bytes) -> bytes:
    return len(raw).to_bytes(8, "little") + bytes(raw)


def aggregate_layout(
    messages: Sequence[bytes],
    rs: Sequence[bytes],
    keys: Sequence[bytes],
    leaf_mids: Sequence[bytes],
    padded: int,
    s_rows: Optional[np.ndarray] = None,
) -> list[np.ndarray]:
    """One aggregate check's host arrays, padded to ``padded`` lanes: the
    R, S and A rows (32, padded), the challenge blocks ``R || A || M`` and
    the transcript leaf blocks with their counts, and ``host_ok``.

    ``leaf_mids`` is the middle frame of each transcript leaf -- the full
    signature for the randomized batch (``ctpu/batchz/v1``), R alone for
    half-agg (``ctpu/halfagg/v1``); ``s_rows`` (n, 32) defaults to zeros
    (half-agg verifiers never see S)."""
    n = len(messages)
    r_rows = _byte_rows([bytes(r) for r in rs], 32)
    key_rows = _byte_rows([bytes(a) for a in keys], 32)
    k_blocks, k_nblocks = _pack_blocks(
        [bytes(r) + bytes(a) + bytes(m) for r, a, m in zip(rs, keys, messages)]
    )
    leaf_blocks, leaf_nblocks = _pack_blocks(
        [_frame(m) + _frame(mid) + _frame(a) for m, mid, a in zip(messages, leaf_mids, keys)]
    )
    if s_rows is None:
        s_rows = np.zeros((n, 32), dtype=np.uint8)
    host_ok = np.ones(n, dtype=bool)
    r_rows, s_rows, key_rows, k_nblocks, leaf_nblocks, host_ok = _pad_wave(
        [r_rows, s_rows, key_rows, k_nblocks, leaf_nblocks, host_ok], n, padded
    )
    if padded != n:
        batch_pad = ((0, 0),) * 3 + ((0, padded - n),)
        k_blocks = np.pad(k_blocks, batch_pad)
        leaf_blocks = np.pad(leaf_blocks, batch_pad)
    return [r_rows.T, s_rows.T, key_rows.T, k_blocks, k_nblocks, leaf_blocks, leaf_nblocks,
            host_ok]


def fused_aggregate_check(
    *,
    name: str,
    tag: bytes,
    messages: Sequence[bytes],
    rs: Sequence[bytes],
    keys: Sequence[bytes],
    leaf_mids: Sequence[bytes],
    pad_to: int,
    pad_pow2: bool,
    device: DeviceLike,
    s_rows: Optional[np.ndarray] = None,
    u_bytes: Optional[bytes] = None,
    fixed_z1: bool = False,
) -> tuple[bool, list[bool]]:
    """Run one fused aggregate check on ``device``: returns ``(eq_ok,
    valid)``, its host arrays from :func:`aggregate_layout`.

    Callers guarantee every lane already passed the canonical host
    pre-checks (transcript membership must match the host twin exactly).
    On the card this launches S1 four times (challenge, leaves, root,
    coefficients) and B3 once."""
    n = len(messages)
    with record_function("ed25519.fused.host_prep"):
        padded = _padded(n, pad_to, pad_pow2)
        u_row = np.frombuffer(
            u_bytes if u_bytes is not None else b"\x00" * 32, dtype=np.uint8
        ).reshape(32, 1)
        args = _to_device(
            aggregate_layout(messages, rs, keys, leaf_mids, padded, s_rows) + [u_row],
            torch.device(device),
        )

    kernel = _fused_aggregate_kernel(
        name, bytes(tag), n, padded, fixed_z1, u_bytes is not None
    )
    eq_ok, valid = kernel(*args)
    out = torch.cat([eq_ok.reshape(1), valid[:n]]).cpu().numpy()
    return bool(out[0]), out[1:].tolist()


class FusedEd25519RandomizedBatchVerifier(
    Ed25519RandomizedBatchVerifier, FusedEd25519BatchVerifier
):
    """Randomized batch verification with the transcript derived on the
    device.

    Bit-identical verdicts to the host-prep
    :class:`~consensus_tpu_torch.models.ed25519.Ed25519RandomizedBatchVerifier`:
    the device transcript hashes the same framed bytes, so coefficients,
    aggregate verdicts and bisection paths coincide exactly.  Host challenge
    scalars are computed only where a subset falls to the host twin
    (``min_device_batch``); subsets under ``min_randomized`` take the fused
    strict path."""

    fused = True

    def verify_batch(self, messages, signatures, public_keys) -> np.ndarray:
        n = len(messages)
        if not (n == len(signatures) == len(public_keys)):
            raise ValueError("batch length mismatch")
        results = np.zeros(n, dtype=bool)
        if n == 0:
            return results
        with record_function("ed25519.fused.host_prep"):
            host_ok = canonical_ok_fast(signatures, public_keys)
        self._check(
            np.flatnonzero(host_ok).tolist(),
            messages, signatures, public_keys, {}, results,
        )
        return results

    @staticmethod
    def _subset_scalars(idx, messages, signatures, public_keys) -> dict:
        """(S, k) big-int scalars of the subset ``idx``, for the host-twin
        fallback only (the JAX module's ``_host_scalars``)."""
        scalars = {}
        for i in idx:
            sig = bytes(signatures[i])
            k = int.from_bytes(
                hashlib.sha512(
                    sig[:32] + bytes(public_keys[i]) + bytes(messages[i])
                ).digest(),
                "little",
            ) % L
            scalars[i] = (int.from_bytes(sig[32:], "little"), k)
        return scalars

    def _strict_floor(self, messages, signatures, public_keys) -> np.ndarray:
        """Strict verification under ``min_randomized``: stays on the fused
        engine."""
        return FusedEd25519BatchVerifier.verify_batch(
            self, messages, signatures, public_keys
        )

    def _fused_aggregate(self, idx, messages, signatures, public_keys):
        """One fused aggregate check over the subset ``idx``."""
        return fused_aggregate_check(
            name="ed25519.fused_batch_verify" + kernel_lane_suffix(),
            tag=_Z_TAG,
            messages=[messages[i] for i in idx],
            rs=[bytes(signatures[i])[:32] for i in idx],
            keys=[public_keys[i] for i in idx],
            leaf_mids=[signatures[i] for i in idx],
            s_rows=_byte_rows([bytes(signatures[i])[32:] for i in idx], 32),
            pad_to=self._pad_to,
            pad_pow2=self._pad_pow2,
            device=self.device,
        )

    def _check(self, idx, messages, signatures, public_keys, scalars, results):
        if not idx:
            return
        if len(idx) < self._min_randomized:
            sub = self._strict_floor(
                [messages[i] for i in idx],
                [signatures[i] for i in idx],
                [public_keys[i] for i in idx],
            )
            for j, i in enumerate(idx):
                results[i] = bool(sub[j])
            return
        if len(idx) >= self._min_device_batch:
            eq_ok, valid = self._fused_aggregate(
                idx, messages, signatures, public_keys
            )
        else:
            zs = _transcript_coefficients(
                [messages[i] for i in idx],
                [signatures[i] for i in idx],
                [public_keys[i] for i in idx],
            )
            eq_ok, valid = self._aggregate_host(
                idx, signatures, public_keys,
                self._subset_scalars(idx, messages, signatures, public_keys), zs,
            )
        if not all(valid):
            survivors = [i for i, ok in zip(idx, valid) if ok]
            self._check(
                survivors, messages, signatures, public_keys, scalars, results
            )
            return
        if eq_ok:
            for i in idx:
                results[i] = True
            return
        mid = len(idx) // 2
        self._check(idx[:mid], messages, signatures, public_keys, scalars, results)
        self._check(idx[mid:], messages, signatures, public_keys, scalars, results)


__all__ = [
    "FusedEd25519BatchVerifier",
    "FusedEd25519RandomizedBatchVerifier",
    "aggregate_layout",
    "aggregate_leaves",
    "aggregate_verdict",
    "canonical_ok_fast",
    "device_transcript",
    "fused_aggregate_check",
    "fused_verify_impl",
    "transcript_coefficients",
]
