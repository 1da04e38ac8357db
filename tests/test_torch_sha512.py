"""The port's SHA-512 (``consensus_tpu_torch/ops/sha512.py``, kernel S1's
plain version and its source compiled for the host) and mod-L scalar stage
(``ops/scalar25519.py``) against ``hashlib``, Python integers and the JAX
package's modules.

``tests/test_sha512.py`` mirrored: the classic padding boundaries, ragged
multi-block batches, a hash of a hash through ``pack_bytes_device``, the
mod-L boundary scalars and the full 512-bit digest range, products and
sums mod L, the ``S < L`` check and the signed window recoding.  Each port
function is held to the JAX function on the same numpy input, word for
word or limb for limb: tolerance 0 throughout (integer arithmetic).
"""

import hashlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from consensus_tpu.ops import scalar25519 as jsc
from consensus_tpu.ops import sha512 as jsh
from consensus_tpu_torch.models.ed25519 import _WINDOWS, _Z_WINDOWS, _signed_digits_int
from consensus_tpu_torch.ops import scalar25519 as sc
from consensus_tpu_torch.ops import scan_kernels
from consensus_tpu_torch.ops import sha512 as sh

L = sc.L

#: Every padding regime: empty; 111/112 straddle "the length field fits the
#: first block"; 127/128 the block edge; 239/240 the same in the second block.
_BOUNDARY_LENGTHS = [0, 111, 112, 127, 128, 239, 240]


def _messages(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes() for n in lengths]


def _port_state(blocks: np.ndarray, n_blocks: np.ndarray) -> np.ndarray:
    state = sh.sha512_blocks(sh.blocks_tensor(blocks), torch.from_numpy(n_blocks))
    assert state.dtype == torch.int32 and tuple(state.shape) == (8, 2, blocks.shape[-1])
    return state.numpy().view(np.uint32)


def _jax_state(blocks: np.ndarray, n_blocks: np.ndarray) -> np.ndarray:
    return np.asarray(jsh.sha512_blocks(blocks, n_blocks))


def _digests(state: np.ndarray) -> list[bytes]:
    d = sh.digest_bytes(torch.from_numpy(state.view(np.int32))).numpy()
    return [bytes(d[:, i].astype(np.uint8)) for i in range(d.shape[1])]


def _rows(values, width=32) -> np.ndarray:
    return np.stack(
        [np.frombuffer(v.to_bytes(width, "little"), dtype=np.uint8) for v in values], axis=1
    ).astype(np.int32)


def _value(col) -> int:
    return int.from_bytes(bytes(np.asarray(col).astype(np.uint8)), "little")


def test_host_packing_is_the_jax_modules():
    msgs = _messages([0, 5, 130, 300], seed=1)
    for got, want in zip(sh.pad_messages(msgs, min_blocks=4), jsh.pad_messages(msgs, min_blocks=4)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    for n in range(0, 300, 7):
        assert sh.padded_blocks_for(n) == jsh.padded_blocks_for(n)
        assert sh.pad_trailer(n) == jsh.pad_trailer(n)
    assert np.array_equal(sh._IV.astype(np.uint32), jsh._IV)
    assert np.array_equal(sh._K.astype(np.uint32), jsh._K)


@pytest.mark.parametrize("length", _BOUNDARY_LENGTHS)
def test_sha512_padding_boundary_matches_hashlib_and_jax(length):
    msgs = _messages([length, length], seed=0xED + length)
    blocks, n_blocks = sh.pad_messages(msgs)
    state = _port_state(blocks, n_blocks)
    assert np.array_equal(state, _jax_state(blocks, n_blocks))
    assert _digests(state) == [hashlib.sha512(m).digest() for m in msgs]


def test_sha512_multiblock_and_ragged_batch():
    """A ragged batch (1-5 blocks in one padded call), with two lanes whose
    counts are forced to 0 and past the block axis: each lane hashes exactly
    its own min(n_blocks, B) blocks, as JAX's select does."""
    msgs = _messages([3, 200, 256, 400, 511, 512, 90, 90], seed=7)
    blocks, n_blocks = sh.pad_messages(msgs)
    assert set(n_blocks.tolist()) == {1, 2, 3, 4, 5}
    state = _port_state(blocks, n_blocks)
    assert np.array_equal(state, _jax_state(blocks, n_blocks))
    assert _digests(state) == [hashlib.sha512(m).digest() for m in msgs]
    forced = n_blocks.copy()
    forced[6], forced[7] = 0, 99
    state = _port_state(blocks, forced)
    assert np.array_equal(state, _jax_state(blocks, forced))
    assert np.array_equal(state[:, :, 6], np.asarray(jsh._IV))
    whole = np.full_like(forced, blocks.shape[0])
    assert np.array_equal(state[:, :, 7], _port_state(blocks, whole)[:, :, 7])


def test_sha512_chained_hash_of_hash():
    """Digest-of-digest through the device-side packing -- the shape the
    transcript root takes (root = H(prefix || leaf digests))."""
    inner = hashlib.sha512(b"ctpu fused pipeline").digest()
    msg = inner * 3
    trailer = sh.pad_trailer(len(msg))
    rows = np.frombuffer(msg + trailer, dtype=np.uint8).astype(np.int32)[:, None]
    port = sh.pack_bytes_device(torch.from_numpy(rows))
    jax_blocks = np.asarray(jsh.pack_bytes_device(rows))
    assert np.array_equal(port.numpy().view(np.uint32), jax_blocks)
    n_blocks = np.array([sh.padded_blocks_for(len(msg))], dtype=np.int32)
    (got,) = _digests(_port_state(port.numpy().view(np.uint32), n_blocks))
    assert got == hashlib.sha512(msg).digest()
    with pytest.raises(ValueError, match="multiple of 128"):
        sh.pack_bytes_device(torch.zeros((100, 1), dtype=torch.int32))


def test_sha512_wrapper_refuses_what_the_kernel_does_not_take():
    blocks, n_blocks = sh.pad_messages([b"abc", b"de"])
    good_b, good_n = sh.blocks_tensor(blocks), torch.from_numpy(n_blocks)
    with pytest.raises(TypeError, match="int32"):
        sh.sha512_blocks(good_b.to(torch.int64), good_n)
    with pytest.raises(ValueError, match=r"\(B, 16, 2, batch\)"):
        sh.sha512_blocks(good_b.reshape(1, 32, 1, 2), good_n)
    with pytest.raises(ValueError, match="n_blocks must be"):
        sh.sha512_blocks(good_b, good_n[:1])
    wide_b, wide_n = sh.pad_messages([b"abc", b"de", b"f", b"g"])
    with pytest.raises(ValueError, match="contiguous"):
        sh.sha512_blocks(sh.blocks_tensor(wide_b)[..., ::2], torch.from_numpy(wide_n[::2].copy()))


_HOST_HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "sha512.cu"
// The kernel's CTAs on the host: each CTA's producer and consumer replayed
// in the kernel's order (serial_cta), over a ring and a state poisoned
// before the run; serial_cta poisons each ring half again after its
// consumer has read it.
int main(int argc, char** argv) {
  if (argc != 5) return 2;
  long long batch = atoll(argv[1]);
  int block_count = atoi(argv[2]);
  std::vector<uint32_t> blocks((size_t)block_count * 32 * batch);
  std::vector<int32_t> n_blocks(batch);
  FILE* f = fopen(argv[3], "rb");
  if (!f || fread(blocks.data(), 4, blocks.size(), f) != blocks.size() ||
      fread(n_blocks.data(), 4, n_blocks.size(), f) != n_blocks.size()) return 3;
  fclose(f);
  std::vector<uint32_t> state(16 * batch, 0xa5a5a5a5u);
  std::vector<uint64_t> ring(2 * HALF_WORDS, 0xa5a5a5a5a5a5a5a5ULL);
  for (long long cta = 0; cta * LANES < batch; ++cta)
    serial_cta(blocks.data(), n_blocks.data(), state.data(), batch, block_count, cta,
               ring.data());
  f = fopen(argv[4], "wb");
  fwrite(state.data(), 4, state.size(), f);
  fclose(f);
  printf("threads %d lanes %d\n", THREADS, LANES);
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """S1's source compiled as plain C++ with g++ (no nvcc here) into the
    harness above; returns a function running it on (blocks, n_blocks)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel source")
    tmp = tmp_path_factory.mktemp("s1_host")
    (tmp / "harness.cpp").write_text(_HOST_HARNESS)
    exe = tmp / "harness"
    subprocess.run(
        [cxx, "-O1", "-std=c++17", "-x", "c++", f"-I{scan_kernels._CSRC}", "-o", str(exe),
         str(tmp / "harness.cpp")],
        check=True, capture_output=True, timeout=300,
    )

    def run(blocks: np.ndarray, n_blocks: np.ndarray) -> tuple[np.ndarray, str]:
        (tmp / "in.bin").write_bytes(blocks.tobytes() + n_blocks.astype(np.int32).tobytes())
        proc = subprocess.run(
            [str(exe), str(blocks.shape[-1]), str(blocks.shape[0]), str(tmp / "in.bin"),
             str(tmp / "out.bin")],
            check=True, capture_output=True, text=True, timeout=120,
        )
        out = np.fromfile(tmp / "out.bin", dtype=np.uint32).reshape(8, 2, blocks.shape[-1])
        return out, proc.stdout

    return run


def test_kernel_source_compiled_for_the_host_matches_plain_version(host_kernel):
    """S1's CTAs, compiled as plain C++ with g++ (no nvcc here), against the
    plain version on 41 lanes of 0-700 bytes (1-6 blocks; two CTAs, the
    second ragged), with lanes whose counts are 0 and past the block axis,
    and hashlib."""
    rng = np.random.default_rng(17)
    msgs = _messages(rng.integers(0, 700, size=41).tolist(), seed=18)
    blocks, n_blocks = sh.pad_messages(msgs)
    forced = n_blocks.copy()
    forced[5], forced[6] = 0, 77
    out, stdout = host_kernel(blocks, forced)
    # Two warps a CTA: the consumer's 32 lanes and the producer's.
    assert stdout.split() == ["threads", "64", "lanes", "32"]
    assert np.array_equal(out, _port_state(blocks, forced))
    assert np.array_equal(out[:, :, 5], np.asarray(jsh._IV))
    want = [hashlib.sha512(m).digest() for m in msgs]
    got = _digests(out)
    assert [g for i, g in enumerate(got) if i not in (5, 6)] == [
        w for i, w in enumerate(want) if i not in (5, 6)
    ]


@pytest.mark.parametrize("width", [1, 3, 17, 65])
def test_kernel_ring_replay_at_ragged_widths(host_kernel, width):
    """The producer/consumer replay at widths that leave a CTA's slots idle
    (1, 3, 17) or spill into a third CTA (65), on messages of 1-9 blocks
    whose counts differ within a CTA (so a lane's steps end before its
    CTA's), with a count of 0, a negative one and one past the block axis:
    equal to the plain version and to JAX, and every other lane to
    hashlib."""
    rng = np.random.default_rng(width)
    msgs = _messages(rng.integers(0, 1100, size=width).tolist(), seed=100 + width)
    blocks, n_blocks = sh.pad_messages(msgs)
    forced = n_blocks.copy()
    special = {0: blocks.shape[0] + 5, 1: 0, 2: -3}
    for lane, count in special.items():
        if lane < width:
            forced[lane] = count
    out, _ = host_kernel(blocks, forced)
    assert np.array_equal(out, _port_state(blocks, forced))
    assert np.array_equal(out, _jax_state(blocks, forced))
    want = [hashlib.sha512(m).digest() for m in msgs]
    got = _digests(out)
    assert [g for i, g in enumerate(got) if i not in special] == [
        w for i, w in enumerate(want) if i not in special
    ]


def test_kernel_ring_replay_on_one_lane_of_the_transcript_roots_length(host_kernel):
    """One lane of 439,062 bytes (3,431 blocks: the randomized config-3
    wave's transcript root) through the replay, held to hashlib (the plain
    version makes ~8,000 eager calls a block and is not run there)."""
    msg = np.random.default_rng(3431).bytes(439062)
    blocks, n_blocks = sh.pad_messages([msg])
    assert blocks.shape[0] == 3431
    out, _ = host_kernel(blocks, n_blocks)
    assert _digests(out) == [hashlib.sha512(msg).digest()]


@pytest.mark.parametrize(
    "value",
    [0, 1, L - 1, L, L + 1, 2 * L, 2**252, 2**255 - 19, 2**256 - 1],
    ids=["0", "1", "L-1", "L", "L+1", "2L", "2^252", "p", "2^256-1"],
)
def test_reduce_bytes_mod_l_boundary_scalars(value):
    rows = _rows([value])
    out = sc.reduce_bytes_mod_l(torch.from_numpy(rows)).numpy()
    assert _value(out[:, 0]) == value % L
    assert np.array_equal(out, np.asarray(jsc.reduce_bytes_mod_l(rows)))


def test_reduce_bytes_mod_l_full_512bit_range():
    """Random 64-byte inputs (the SHA-512 digest range), 2^512 - 1 and L
    widened to 64 bytes."""
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 256, size=(64, 9), dtype=np.uint8).astype(np.int32)
    rows = np.concatenate([rows, _rows([2**512 - 1, L], width=64)], axis=1)
    out = sc.reduce_bytes_mod_l(torch.from_numpy(rows)).numpy()
    for i in range(rows.shape[1]):
        assert _value(out[:, i]) == _value(rows[:, i]) % L
    assert np.array_equal(out, np.asarray(jsc.reduce_bytes_mod_l(rows)))
    with pytest.raises(ValueError, match="64 input bytes"):
        sc.reduce_bytes_mod_l(torch.zeros((65, 1), dtype=torch.int32))


def test_mul_and_sum_mod_l_match_bigint_and_jax():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, size=(16, 6), dtype=np.uint8).astype(np.int32)  # 128-bit z's
    b = rng.integers(0, 256, size=(32, 6), dtype=np.uint8).astype(np.int32)
    a[:, 0] = 255  # the largest columns
    b[:, 0] = 255
    prod = sc.mul_mod_l(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = [(_value(a[:, i]) * _value(b[:, i])) % L for i in range(6)]
    assert [_value(prod[:, i]) for i in range(6)] == want
    assert np.array_equal(prod, np.asarray(jsc.mul_mod_l(a, b)))
    square = sc.mul_mod_l(torch.from_numpy(b), torch.from_numpy(b)).numpy()
    assert np.array_equal(square, np.asarray(jsc.mul_mod_l(b, b)))
    total = sc.sum_mod_l(torch.from_numpy(prod)).numpy()
    assert total.shape == (32, 1) and _value(total[:, 0]) == sum(want) % L
    assert np.array_equal(total, np.asarray(jsc.sum_mod_l(prod)))
    with pytest.raises(ValueError):
        sc.mul_mod_l(torch.zeros((33, 1), dtype=torch.int32), torch.zeros((33, 1), dtype=torch.int32))


def test_lt_l_on_the_boundary():
    rows = _rows([0, L - 1, L, L + 1, 2**256 - 1])
    got = sc.lt_l(torch.from_numpy(rows))
    assert got.dtype == torch.bool
    assert got.tolist() == [True, True, False, False, False]
    assert got.tolist() == np.asarray(jsc.lt_l(rows)).tolist()


@pytest.mark.parametrize("windows", [_WINDOWS, _Z_WINDOWS])
def test_signed_window_digits_match_host_recoding_and_jax(windows):
    rng = np.random.default_rng(9)
    if windows == _WINDOWS:
        vals = [0, 1, L - 1, int(rng.integers(1, 2**63)) << 190, 0x8888 << 200]
        rows = _rows(vals)
    else:  # 128-bit coefficients: 16 bytes, 33 windows
        vals = [1, 2**128 - 1, 0x8888 << 100, int(rng.integers(1, 2**63)) << 60]
        rows = _rows(vals, width=16)
    got = sc.signed_window_digits(torch.from_numpy(rows), windows).numpy()
    want = np.array([_signed_digits_int(v, windows) for v in vals], dtype=np.int64).T + 8
    assert got.shape == (windows, len(vals)) and np.array_equal(got, want)
    assert np.array_equal(got, np.asarray(jsc.signed_window_digits(rows, windows)))
