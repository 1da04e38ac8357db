"""Design trials of kernels E1 (the Ed25519 add-and-compare), P1 (the
P-256 fixed-base comb) and P2 (the P-256 verdict) on one NVIDIA GPU.

    python3 scripts/e1_p1_trials.py [ALTERNATIVE.cu ...]

Builds the designs in ``consensus_tpu_torch/csrc/`` (``verdict25519.cu``,
``comb_p256.cu``, ``verdict_p256.cu``) and every alternative named on the
command line side by
side.  An alternative is a copy of one of them with the same C entry point,
named ``<kernel>_<design>.cu``; it is built against csrc's headers.  One
nvcc per source, all started together, into
``consensus_tpu_torch/csrc/build/trials/``; a design that does not build is
reported and left out.  The inputs are the main path's own, as
``chip_smoke.py`` phase 24 makes them: E1's strict mode on the config-3
wave (7 replicas x 1,000 requests with every rejection class, 8,192 lanes:
acc, comb and R from B1, D2 and D1) and its identity mode on that wave's
first lane; P1 on the config-2 wave's u1 digits (4 replicas x 500
requests, 2,048 lanes) and on its first lane; P2 on that wave's own
inputs (acc from B2, comb from P1) and on its first lane.  Each design is
checked against the plain version at tolerance 0 (E1's and P2's verdicts;
P1's point projectively, ``chip_smoke.p256_projective_max_err``), then its
launches
alone on preallocated outputs are timed with CUDA events in turns within
one process (designs in order, reversed, in order), as a loop of launches
from Python and as launches replayed from a CUDA graph
(``chip_smoke.graph_ms``: the device's time; a Python loop issues a launch
every ~0.016 ms).  Prints each design's ptxas figures, one line per design
and width, a JSON summary, and the card's name and power limit.

The first designs of E1 and P1 (one thread a lane for E1; one chain of
32 complete adds on 8 threads a lane for P1) are in git history at the
commit before their redesign; to time them again, write them out as
alternatives (``git show <commit>:consensus_tpu_torch/csrc/comb_p256.cu >
dist/comb_p256_first.cu``).  P1's table now holds b x beside (x, y), 24
words an entry: an older P1 reads it after its ``ENTRY_WORDS`` is set to
24.  P2's first design (one thread a lane through the header's serial
add) is kept beside this script, ``e1_p1_trials/verdict_p256_first.cu``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from consensus_tpu_torch.models import ecdsa_p256 as mp  # noqa: E402
from consensus_tpu_torch.models import ed25519 as med  # noqa: E402
from consensus_tpu_torch.ops import field_p256 as fp  # noqa: E402
from consensus_tpu_torch.ops import p256  # noqa: E402
from consensus_tpu_torch.ops import scan_kernels  # noqa: E402

TRIALS = scan_kernels.BUILD_DIR / "trials"
#: kernel -> (pointer arguments, int arguments) of its C launch function.
KERNELS = {"verdict25519": (16, 3), "comb_p256": (5, 1), "verdict_p256": (13, 1)}
REPS = 50
ROUNDS = 3


def designs(alternatives) -> dict:
    """(kernel, design) -> source path: csrc's designs and the alternatives."""
    out = {(name, "csrc"): scan_kernels._CSRC / f"{name}.cu" for name in KERNELS}
    for path in map(Path, alternatives):
        name = next((n for n in KERNELS if path.stem.startswith(f"{n}_")), None)
        if name is None:
            raise SystemExit(f"e1_p1_trials: {path.name} is not <kernel>_<design>.cu "
                             f"with a kernel of {sorted(KERNELS)}")
        out[name, path.stem[len(name) + 1:]] = path.resolve()
    return out


def build_all(sources: dict) -> dict:
    """Start one nvcc per design together; (kernel, design) -> (launch
    function, ptxas figures of its __global__ kernel) for each that built."""
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
        figures = {k: v for k, v in cs.ptxas_summary(report).items() if "registers" in v}
        print(f"{name} {design}: built; ptxas {figures}", flush=True)
        launch = getattr(ctypes.CDLL(str(lib)), f"{name}_launch")
        pointers, ints = KERNELS[name]
        launch.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * (ints + 1) + [
            ctypes.c_void_p]
        launch.restype = ctypes.c_int
        built[name, design] = (launch, figures)
    return built


def run(launch, pointers, ints, device) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    code = launch(*(0 if t is None else t.data_ptr() for t in pointers), *ints,
                  device.index or 0, stream)
    if code:
        raise RuntimeError(f"launch failed: {code}")


def cases(device) -> dict:
    """(kernel, case) -> (pointer arguments, int arguments, check): the
    outputs are the last pointers; check(outputs) raises unless they equal
    the plain version's at tolerance 0."""
    wave = cs.replica_wave(cs.make_corpus(cs.REQUESTS, per_class=5), cs.REPLICAS)
    engine = med.Ed25519BatchVerifier(device=device)
    acc, comb, r_point, host_ok, r_ok, a_ok = cs.strict_tail_inputs(engine, *wave[:3])
    lanes = host_ok.shape[0]
    strict_want = scan_kernels.add_and_equal_reference(acc, comb, r_point, host_ok, r_ok, a_ok)
    one = [cs.ed.Point(*(c[:, :1].contiguous() for c in p)) for p in (acc, comb)]
    identity_want = scan_kernels.add_is_identity_reference(*one)

    def verdicts(want):
        def check(outs):
            cs._check_verdicts("verdict25519", outs[-1], want)
        return check

    pwave = cs.replica_wave(cs.make_p256_corpus(cs.P256_REQUESTS, per_class=3),
                            cs.P256_REPLICAS)
    u1d, tail = cs.p256_tail_inputs(mp.EcdsaP256BatchVerifier(device=device), *pwave[:3])
    table = scan_kernels.comb_p256_table(device)

    def comb_case(digits):
        want = scan_kernels.fixed_base_mul_comb_p256_reference(digits)
        outs = [torch.empty((fp.LIMBS, digits.shape[1]), dtype=torch.float32, device=device)
                for _ in range(3)]

        def check(outs):
            cs.p256_projective_max_err("comb_p256", p256.Point(*outs[-3:]), want)
        return [table, digits, *outs], (digits.shape[1],), check

    def p2_case(args):
        want = scan_kernels.verdict_p256_reference(*args)
        n = want.shape[0]

        def check(outs):
            cs._check_verdicts("verdict_p256", outs[-1], want)
        return ([*args[0], *args[1], *args[2:], torch.empty(n, dtype=torch.bool, device=device)],
                (n,), check)

    lane0 = lambda t: t[..., :1].contiguous()
    tail_one = [p256.Point(*map(lane0, tail[0])), p256.Point(*map(lane0, tail[1])),
                *map(lane0, tail[2:])]
    out = torch.empty(lanes, dtype=torch.bool, device=device)
    return {
        ("verdict25519", f"strict {lanes}"): (
            [*acc, *comb, *r_point, host_ok, r_ok, a_ok, out],
            (lanes, 0, r_point.x.stride(0)), verdicts(strict_want)),
        ("verdict25519", "identity 1"): (
            [*one[0], *one[1], *(None,) * 7, torch.empty(1, dtype=torch.bool, device=device)],
            (1, 1, 1), verdicts(identity_want)),
        ("comb_p256", f"{u1d.shape[1]}"): comb_case(u1d),
        ("comb_p256", "1"): comb_case(u1d[:, :1].contiguous()),
        ("verdict_p256", f"{u1d.shape[1]}"): p2_case(tail),
        ("verdict_p256", "1"): p2_case(tail_one),
    }


def main(alternatives) -> int:
    if not torch.cuda.is_available():
        print("e1_p1_trials: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    sources = designs(alternatives)
    built = build_all(sources)
    equal: dict = {}
    times: dict = {}
    graphs: dict = {}
    for (name, case), (pointers, ints, check) in cases(device).items():
        order = [d for n, d in built if n == name]
        for design in order:
            outs = [torch.ones_like(t) if t.dtype == torch.bool else torch.full_like(t, -7.0)
                    for t in pointers[-(3 if name == "comb_p256" else 1):]]
            args = [*pointers[:len(pointers) - len(outs)], *outs]
            run(built[name, design][0], args, ints, device)
            torch.cuda.synchronize()
            try:
                check(outs)
                equal[name, design, case] = True
            except AssertionError as exc:
                equal[name, design, case] = False
                print(f"{name} {design} {case}: DIFFERS from the plain version: {exc}",
                      flush=True)
        for turn in range(ROUNDS):
            for design in order if turn % 2 == 0 else order[::-1]:
                launch = built[name, design][0]
                run(launch, pointers, ints, device)  # warm-up
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(REPS):
                    run(launch, pointers, ints, device)
                end.record()
                torch.cuda.synchronize()
                times.setdefault((name, design, case), []).append(
                    start.elapsed_time(end) / REPS)
                graphs.setdefault((name, design, case), []).append(cs.graph_ms(
                    lambda: run(launch, pointers, ints, device), REPS, device))
    for (name, design, case), ms in times.items():
        verdict = "equal to" if equal[name, design, case] else "DIFFERENT from"
        print(f"{name} {design} {case}: " + ", ".join(f"{t:.6f}" for t in ms)
              + f" ms a launch alone (CUDA events, mean of {REPS} launches a turn); "
              + ", ".join(f"{t:.6f}" for t in graphs[name, design, case])
              + f" ms a launch replayed from a CUDA graph of {REPS}; {verdict} the plain "
              "version at tolerance 0")
    card = cs.nvidia_smi("name,power.limit")
    print(json.dumps({
        "card": card,
        "ptxas": {f"{n} {d}": f for (n, d), (_, f) in built.items()},
        "ms": {f"{n} {d} {c}": t for (n, d, c), t in times.items()},
        "graph_ms": {f"{n} {d} {c}": t for (n, d, c), t in graphs.items()},
        "equal": {f"{n} {d} {c}": e for (n, d, c), e in equal.items()},
    }))
    print(card)
    return 0 if all(equal.values()) and len(built) == len(sources) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
