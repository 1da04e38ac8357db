"""Block-size trials of kernels D1 (decompression) and D2 (the comb) on one
NVIDIA GPU.

    python3 scripts/d1_d2_trials.py

Builds copies of ``consensus_tpu_torch/csrc/decompress25519.cu`` and
``comb25519.cu`` with 32, 64 and 128 threads a block (the sources' own
constant rewritten) into ``consensus_tpu_torch/csrc/build/trials/``, checks
each copy against the plain version at tolerance 0, and times every copy
with CUDA events, in turns within one process (32, 64, 128, 128, 64, 32):
D1 at 16,384 points and at 512, D2 at 8,192 lanes and at one lane.  The
inputs are random y encodings with random signs (about half off the curve)
and random digit bytes, from numpy seed 0: both kernels do the same work on
any data.  Prints one line per copy and width, then the card's name and
power limit.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from consensus_tpu_torch.ops import ed25519 as ed  # noqa: E402
from consensus_tpu_torch.ops import field25519 as fe  # noqa: E402
from consensus_tpu_torch.ops import scan_kernels  # noqa: E402

TRIALS = scan_kernels.BUILD_DIR / "trials"
#: kernel -> (source, the block-size constant's name, pointer arguments).
KERNELS = {
    "decompress25519": ("decompress25519.cu", "POINTS", 7),
    "comb25519": ("comb25519.cu", "LANES", 6),
}
THREADS = (32, 64, 128)
REPS = 50


def build(name: str, threads: int) -> ctypes.CDLL:
    source, constant, n_pointers = KERNELS[name]
    text = (scan_kernels._CSRC / source).read_text()
    text, count = re.subn(rf"constexpr int {constant} = \d+;",
                          f"constexpr int {constant} = {threads};", text)
    assert count == 1, f"{source}: no {constant} constant"
    TRIALS.mkdir(parents=True, exist_ok=True)
    cu = TRIALS / f"{name}_{threads}.cu"
    cu.write_text(text)
    lib = TRIALS / f"{name}_{threads}.so"
    proc = subprocess.run(
        [scan_kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", f"-I{scan_kernels._CSRC}",
         "-o", str(lib), str(cu)],
        capture_output=True, text=True,
    )
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    regs = re.findall(r"Used (\d+) registers", proc.stdout + proc.stderr)
    print(f"{name} at {threads} threads a block: built, {regs[0]} registers", flush=True)
    handle = ctypes.CDLL(str(lib))
    launch = getattr(handle, f"{name}_launch")
    launch.argtypes = [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    launch.restype = ctypes.c_int
    return launch


def run(launch, inputs, outputs, batch: int, device) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    code = launch(*(t.data_ptr() for t in (*inputs, *outputs)), batch, device.index or 0, stream)
    if code:
        raise RuntimeError(f"launch failed: {code}")


def main() -> int:
    if not torch.cuda.is_available():
        print("d1_d2_trials: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    cases = {}
    for m in (16384, 512):
        ys = [int.from_bytes(rng.bytes(32), "little") >> 1 for _ in range(m)]
        y = torch.from_numpy(np.stack([fe.int_to_limbs(v) for v in ys], axis=1)).to(device)
        sign = torch.from_numpy(rng.integers(0, 2, m).astype(np.int32)).to(device)
        cases[("decompress25519", m)] = (y, sign)
    table = scan_kernels.comb_niels_table(device)
    for n in (8192, 1):
        digits = torch.from_numpy(rng.integers(0, 256, (32, n)).astype(np.int32)).to(device)
        cases[("comb25519", n)] = (table, digits)
    launches = {(name, t): build(name, t) for name in KERNELS for t in THREADS}

    def outputs(name, width):
        outs = [torch.empty((fe.LIMBS, width), dtype=torch.float32, device=device)
                for _ in range(4)]
        if name == "decompress25519":
            outs.append(torch.empty(width, dtype=torch.bool, device=device))
        return outs

    times: dict = {}
    for (name, width), inputs in cases.items():
        if name == "decompress25519":
            want, want_ok = ed.decompress(*inputs)
        else:
            want, want_ok = ed.fixed_base_mul_comb(inputs[1]), None
        for threads in THREADS:
            outs = outputs(name, width)
            run(launches[name, threads], inputs, outs, width, device)
            torch.cuda.synchronize()
            for g, w in zip(outs[:4], want):
                assert torch.equal(fe.freeze(g), fe.freeze(w)), (name, threads, width)
            if want_ok is not None:
                assert torch.equal(outs[4], want_ok), (name, threads, width)
        for threads in THREADS + THREADS[::-1]:
            outs = outputs(name, width)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPS):
                run(launches[name, threads], inputs, outs, width, device)
            end.record()
            torch.cuda.synchronize()
            times.setdefault((name, width, threads), []).append(start.elapsed_time(end) / REPS)
    for (name, width, threads), ms in times.items():
        print(f"{name} width {width} threads {threads}: "
              + ", ".join(f"{t:.6f}" for t in ms)
              + f" ms (CUDA events, mean of {REPS} launches; equal to the plain version)")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
