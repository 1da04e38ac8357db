"""Design trials of kernels D1 (decompression) and D2 (the comb) on one
NVIDIA GPU.

    python3 scripts/d1_d2_trials.py [ALTERNATIVE.cu ...]

Builds the designs in ``consensus_tpu_torch/csrc/`` (``decompress25519.cu``,
``comb25519.cu``) and every alternative named on the command line side by
side.  An alternative is a copy of one of them with the same C entry point,
named ``<kernel>_<design>.cu``; it is built against csrc's headers and those
beside it.  One nvcc per source, all started together, into
``consensus_tpu_torch/csrc/build/trials/``; a design that does not build is
reported and left out.  Each design is then checked against the plain
version at tolerance 0 (frozen X, Y, Z, T equal, and D1's valid mask) at
every width, and timed with CUDA events in turns within one process
(designs in order, reversed, in order): D1 at 16,384, 2,048, 512 and 16
points, D2 at 8,192, 1,024, 8 and 1 lanes (the strict wave's R || A stack
and S digits, phase 12's cluster wave, the half-agg verify's and the
randomized check's widths).  The inputs are random y encodings with random
signs (about half off the curve) and random digit bytes from numpy seed 0:
both kernels do the same work on any data.  Prints each design's ptxas
figures, one line per design and width, a JSON summary, and the card's name
and power limit.

The first versions of both kernels (one thread a point or lane, radix
2^51) and the candidates that lost to csrc's designs are kept in git
history, at the commit that redesigned both kernels for Hopper
(``git show c03d5ad:scripts/d1_d2_trials/``); to time them again, unpack
that directory and name its files here.
"""

from __future__ import annotations

import ctypes
import json
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
#: kernel -> (pointer arguments of its C launch function, widths, the int
#: arguments after the batch: D1's negate flags, none set).  A D1 design
#: written before its negate option takes no int: add the argument (and
#: ignore it) before timing it here.
KERNELS = {
    "decompress25519": (7, (16384, 2048, 512, 16), (0,)),
    "comb25519": (6, (8192, 1024, 8, 1), ()),
}
REPS = 50
ROUNDS = 3


def designs(alternatives) -> dict:
    """(kernel, design) -> source path: csrc's designs and the alternatives."""
    out = {(name, "csrc"): scan_kernels._CSRC / f"{name}.cu" for name in KERNELS}
    for path in map(Path, alternatives):
        name = next((n for n in KERNELS if path.stem.startswith(f"{n}_")), None)
        if name is None:
            raise SystemExit(f"d1_d2_trials: {path.name} is not <kernel>_<design>.cu "
                             f"with a kernel of {sorted(KERNELS)}")
        out[name, path.stem[len(name) + 1:]] = path.resolve()
    return out


def ptxas_figures(report: str) -> dict:
    """Registers, shared memory, stack frame and spills of the __global__
    kernel in an ``-Xptxas -v`` report."""
    figures = {}
    for block in report.split("Compiling entry function")[1:]:
        for key, pattern in (("registers", r"Used (\d+) registers"),
                             ("smem_bytes", r"(\d+) bytes smem"),
                             ("stack_bytes", r"(\d+) bytes stack frame"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads")):
            found = re.search(pattern, block)
            figures[key] = int(found.group(1)) if found else 0
    return figures


def build_all(sources: dict) -> dict:
    """Start one nvcc per design together; (kernel, design) -> (launch
    function, ptxas figures) for each that built."""
    TRIALS.mkdir(parents=True, exist_ok=True)
    procs = {}
    for (name, design), cu in sources.items():
        lib = TRIALS / f"{name}_{design}.so"
        procs[name, design] = (lib, subprocess.Popen(
            [scan_kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
             f"-I{scan_kernels._CSRC}", "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    built = {}
    for (name, design), (lib, proc) in procs.items():
        report = proc.communicate()[0]
        if proc.returncode:
            print(f"{name} {design}: nvcc failed\n{report}", flush=True)
            continue
        figures = ptxas_figures(report)
        print(f"{name} {design}: built; ptxas {figures}", flush=True)
        launch = getattr(ctypes.CDLL(str(lib)), f"{name}_launch")
        launch.argtypes = [ctypes.c_void_p] * KERNELS[name][0] + [ctypes.c_int] * (
            2 + len(KERNELS[name][2])) + [ctypes.c_void_p]
        launch.restype = ctypes.c_int
        built[name, design] = (launch, figures)
    return built


def run(launch, inputs, outputs, batch: int, device, ints=()) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    code = launch(*(t.data_ptr() for t in (*inputs, *outputs)), batch, *ints,
                  device.index or 0, stream)
    if code:
        raise RuntimeError(f"launch failed: {code}")


def main(alternatives) -> int:
    if not torch.cuda.is_available():
        print("d1_d2_trials: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    sources = designs(alternatives)
    built = build_all(sources)
    rng = np.random.default_rng(0)
    cases = {}
    for m in KERNELS["decompress25519"][1]:
        ys = [int.from_bytes(rng.bytes(32), "little") >> 1 for _ in range(m)]
        y = torch.from_numpy(np.stack([fe.int_to_limbs(v) for v in ys], axis=1)).to(device)
        sign = torch.from_numpy(rng.integers(0, 2, m).astype(np.int32)).to(device)
        cases["decompress25519", m] = (y, sign)
    table = scan_kernels.comb_niels_table(device)
    for n in KERNELS["comb25519"][1]:
        digits = torch.from_numpy(rng.integers(0, 256, (32, n)).astype(np.int32)).to(device)
        cases["comb25519", n] = (table, digits)

    def outputs(name, width):
        outs = [torch.empty((fe.LIMBS, width), dtype=torch.float32, device=device)
                for _ in range(4)]
        if name == "decompress25519":
            outs.append(torch.empty(width, dtype=torch.bool, device=device))
        return outs

    equal: dict = {}
    times: dict = {}
    for (name, width), inputs in cases.items():
        if name == "decompress25519":
            want, want_ok = ed.decompress(*inputs)
        else:
            want, want_ok = ed.fixed_base_mul_comb(inputs[1]), None
        frozen = [fe.freeze(w) for w in want]
        order = [d for n, d in built if n == name]
        for design in order:
            outs = outputs(name, width)
            run(built[name, design][0], inputs, outs, width, device, KERNELS[name][2])
            torch.cuda.synchronize()
            same = all(torch.equal(fe.freeze(g), w) for g, w in zip(outs[:4], frozen))
            if want_ok is not None:
                same = same and torch.equal(outs[4], want_ok)
            equal[name, design, width] = same
            if not same:
                print(f"{name} {design} width {width}: DIFFERS from the plain version", flush=True)
        for turn in range(ROUNDS):
            for design in order if turn % 2 == 0 else order[::-1]:
                outs = outputs(name, width)
                launch = built[name, design][0]
                run(launch, inputs, outs, width, device, KERNELS[name][2])  # warm-up
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(REPS):
                    run(launch, inputs, outs, width, device, KERNELS[name][2])
                end.record()
                torch.cuda.synchronize()
                times.setdefault((name, design, width), []).append(
                    start.elapsed_time(end) / REPS)
    for (name, design, width), ms in times.items():
        verdict = "equal to" if equal[name, design, width] else "DIFFERENT from"
        print(f"{name} {design} width {width}: " + ", ".join(f"{t:.6f}" for t in ms)
              + f" ms (CUDA events, mean of {REPS} launches a turn; {verdict} the plain "
              "version at tolerance 0)")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(json.dumps({
        "card": card,
        "ptxas": {f"{n} {d}": f for (n, d), (_, f) in built.items()},
        "ms": {f"{n} {d} {w}": t for (n, d, w), t in times.items()},
        "equal": {f"{n} {d} {w}": e for (n, d, w), e in equal.items()},
    }))
    print(card)
    return 0 if all(equal.values()) and len(built) == len(sources) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
