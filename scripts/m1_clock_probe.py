"""Where a block of kernel M1 (``consensus_tpu_torch/csrc/mxu_limbs.cu``)
spends its clocks, on one NVIDIA GPU.

    python3 scripts/m1_clock_probe.py

Writes a copy of M1's source with ``clock64()`` stamps taken by thread 0 of
each warpgroup of block 0 (at entry, after the operand loads and the band
with their barrier, after the warpgroup's k-blocks, after the staging and its
barrier, at the end), builds it with nvcc into
``consensus_tpu_torch/csrc/build/trials/``, launches it 50 times at 1 and
8,192 lanes on both curves (the product checked against the plain version at
tolerance 0), and prints the last launch's stamps as clocks from block 0's
entry, then the card's name, power limit and SM clock.  The stamps cost a
few instructions a phase; the times of record come from
``scripts/e1_p1_trials.py``.  Exits 1 without a CUDA device.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from consensus_tpu_torch.ops import mxu_limbs, scan_kernels  # noqa: E402

#: Phases stamped, in order: (label, the source line the stamp follows).
STAMPS = (
    ("entry", "  const long long base = (long long)blockIdx.x * TILE_LANES;\n"),
    ("loads and band", "  __syncthreads();\n\n  uint32_t a_pairs[K_SPLIT];\n"),
    ("k-blocks", "  k_blocks(acc, a_pairs, bv, band_address);\n  fence_accumulators(acc);\n"),
    ("staging", "  __syncthreads();\n  const thread_quad quad = {t};\n"),
    ("reduction and stores", "  store_limbs(out, n, base + 16 * w + row, t, r[0]);\n"),
)


def probed_source() -> str:
    """M1's source with the stamps and a C function that copies them out."""
    src = (scan_kernels._CSRC / "mxu_limbs.cu").read_text()
    src = src.replace("// One kernel a curve (ptxas names them",
                      "__device__ long long m1_probe_clocks[2][8];\n\n"
                      "// One kernel a curve (ptxas names them", 1)
    for k, (label, anchor) in enumerate(STAMPS):
        if src.count(anchor) != 1:
            raise SystemExit(f"m1_clock_probe: the stamp after '{label}' has no unique place "
                             f"in mxu_limbs.cu")
        # The k-blocks' stamp waits for an accumulator, so it falls after the
        # last wait rather than where the compiler would hoist it.
        dep = " + (acc[0][0] == 0x7fffffff)" if label == "k-blocks" else ""
        src = src.replace(anchor, anchor + (
            f"  if (blockIdx.x == 0 && (threadIdx.x & 127) == 0) "
            f"m1_probe_clocks[threadIdx.x >> 7][{k}] = clock64(){dep};\n"), 1)
    return src + """
extern "C" int m1_probe_read(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, m1_probe_clocks, sizeof(long long) * 16);
}
"""


def main() -> int:
    if not torch.cuda.is_available():
        print("m1_clock_probe: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    out_dir = scan_kernels.BUILD_DIR / "trials"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, lib = out_dir / "mxu_limbs_probe.cu", out_dir / "mxu_limbs_probe.so"
    cu.write_text(probed_source())
    built = subprocess.run(scan_kernels.nvcc_command(cu, lib, f"-I{scan_kernels._CSRC}"),
                           capture_output=True, text=True)
    figures = {k: v for k, v in cs.ptxas_summary(built.stdout + built.stderr).items()
               if "registers" in v}
    if built.returncode:
        print(built.stdout + built.stderr)
        return 1
    print(f"probed build: ptxas {figures}")
    probe = ctypes.CDLL(str(lib))
    probe.mxu_limbs_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    probe.mxu_limbs_launch.restype = ctypes.c_int
    probe.m1_probe_read.argtypes = [ctypes.c_void_p]
    probe.m1_probe_read.restype = ctypes.c_int
    rng = np.random.default_rng(cs.SEED)
    ok = True
    for n in (1, 8192):
        for curve, ranges in cs.MXU_RANGES.items():
            a_cpu, b_cpu = (torch.from_numpy(rng.integers(*ranges[-1], (32, n)).astype(np.float32))
                            for _ in range(2))
            a, b = a_cpu.to(device), b_cpu.to(device)
            out = torch.empty_like(a)
            stream = torch.cuda.current_stream(device).cuda_stream
            for _ in range(50):
                code = probe.mxu_limbs_launch(a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
                                              mxu_limbs._CURVES[curve], 0, 0, 0, stream)
                if code:
                    raise RuntimeError(f"launch failed: {code}")
            torch.cuda.synchronize()
            stamps = (ctypes.c_longlong * 16)()
            if probe.m1_probe_read(ctypes.addressof(stamps)):
                raise RuntimeError("reading the stamps failed")
            equal = torch.equal(out.cpu(), cs.MXU_PRODUCTS[curve][0](a_cpu, b_cpu))
            ok &= equal
            start = stamps[0]
            for wg in range(2):
                row = [stamps[8 * wg + k] - start for k in range(len(STAMPS))]
                print(f"{curve} {n} lanes, warpgroup {wg}: " + ", ".join(
                    f"{label} {c}" for (label, _), c in zip(STAMPS, row))
                      + " clocks from block 0's entry")
            print(f"  {'equal to' if equal else 'DIFFERENT from'} the plain version at "
                  f"tolerance 0")
    print(cs.nvidia_smi("name,power.limit,clocks.sm"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
