"""Design trials of kernels E1 (the Ed25519 add-and-compare), P1 (the
P-256 fixed-base comb), P2 (the P-256 verdict), L1 (the fused scalar
stage) and M1 (the tensor-core field product) on one NVIDIA GPU.

    python3 scripts/e1_p1_trials.py [--kernel NAME ...] [ALTERNATIVE.cu ...]

Builds the designs in ``consensus_tpu_torch/csrc/`` (``verdict25519.cu``,
``comb_p256.cu``, ``verdict_p256.cu``, ``scalar25519.cu``,
``mxu_limbs.cu``; with ``--kernel``, only the named kernels') and every
alternative named on the command line side by side.  An alternative is a copy of one of them with the same C entry point,
named ``<kernel>_<design>.cu``; it is built against csrc's headers.  One
nvcc per source, all started together, into
``consensus_tpu_torch/csrc/build/trials/``; a design that does not build is
reported and left out.  The inputs are the main path's own, as
``chip_smoke.py`` phase 24 makes them: E1's strict mode on the config-3
wave (7 replicas x 1,000 requests with every rejection class, 8,192 lanes:
acc, comb and R from B1, D2 and D1) and its identity mode on that wave's
first lane; P1 on the config-2 wave's u1 digits (4 replicas x 500
requests, 2,048 lanes) and on its first lane; P2 on that wave's own
inputs (acc from B2, comb from P1) and on its first lane; L1's challenge
mode on the config-3 wave's S1 states with its signature and key rows
and host_ok (8,192 lanes: digits and the canonical checks, the digits
alone, the bytes; the first design reads the digests as byte rows and does
no checks) and its aggregate mode on z, k and s of 8,192 lanes (with s, and
without as a certificate's, also on a certificate's 8 lanes), and each on
one lane; M1 on both curves at the widths of
``chip_smoke.py`` phase 21 (8,192, 2,048, 1,024 and 1 lanes, and a (32, 1)
constant against 8,192 either side) on its widest operand range; and an
empty kernel, the launch floor.  Each design is
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
add) is kept beside this script, ``e1_p1_trials/verdict_p256_first.cu``,
and so is L1's (one thread a lane, Barrett reduction, a serial recoding
carry), ``e1_p1_trials/scalar25519_first.cu``, whose C entry point takes 8
pointers where csrc's takes 12, and L1's group of 8 threads a lane (with
the aggregate products formed whole on each role of a half),
``e1_p1_trials/scalar25519_group8.cu``.  M1's first design (8 lanes a warp
on ``mma.sync``, one thread a lane reducing) is
``e1_p1_trials/mxu_limbs_first.cu``, and ``e1_p1_trials/mxu_limbs_wg1.cu``
is the redesign as first written: one warpgroup a block on all 32 k-blocks
with 64-column ``wgmma`` tiles, each thread loading its own operands; for M1
the script also
prints each design's SASS counts (``chip_smoke.sass_counts``: instructions
and tensor-core instructions a kernel, and instructions a lane).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from consensus_tpu_torch.models import ecdsa_p256 as mp  # noqa: E402
from consensus_tpu_torch.models import ed25519 as med  # noqa: E402
from consensus_tpu_torch.models.fused import FusedEd25519BatchVerifier  # noqa: E402
from consensus_tpu_torch.ops import field_p256 as fp  # noqa: E402
from consensus_tpu_torch.ops import mxu_limbs  # noqa: E402
from consensus_tpu_torch.ops import p256  # noqa: E402
from consensus_tpu_torch.ops import scalar25519 as sc  # noqa: E402
from consensus_tpu_torch.ops import scan_kernels  # noqa: E402
from consensus_tpu_torch.ops import sha512 as sh  # noqa: E402

TRIALS = scan_kernels.BUILD_DIR / "trials"
#: kernel -> (pointer arguments, int arguments) of its C launch function.
KERNELS = {"verdict25519": (16, 3), "comb_p256": (5, 1), "verdict_p256": (13, 1),
           "scalar25519": (12, 3), "mxu_limbs": (3, 4)}
#: Designs whose C launch function differs from their kernel's.
INTERFACES = {("scalar25519", "first"): (8, 3)}
#: M1's lanes a warp by design (csrc's: 64 a warpgroup), for its SASS
#: instructions a lane.
MXU_WARP_LANES = {"first": 8}
#: M1's shapes, (a lanes, b lanes): phase 21's widths, then a (32, 1)
#: constant against the first width either side.
MXU_SHAPES = [(n, n) for n in cs.MXU_WIDTHS] + [(1, cs.MXU_BROADCAST_LANES),
                                                (cs.MXU_BROADCAST_LANES, 1)]
REPS = 50
ROUNDS = 3


def designs(alternatives, kernels=tuple(KERNELS)) -> dict:
    """(kernel, design) -> source path: csrc's designs of ``kernels`` and
    the alternatives."""
    out = {(name, "csrc"): scan_kernels._CSRC / f"{name}.cu" for name in kernels}
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
        warnings = [line for line in report.splitlines()
                    if "warning" in line.lower() or "Performance" in line]
        if warnings:
            print(f"{name} {design}: " + "\n".join(warnings), flush=True)
        if name == "mxu_limbs":
            per_warp = MXU_WARP_LANES.get(design, 16)
            for fn, f in cs.sass_counts(str(lib)).items():
                print(f"{name} {design} SASS {fn}: {f['instructions']} instructions "
                      f"({f['instructions'] / per_warp:.1f} a lane at {per_warp} lanes a warp), "
                      f"tensor-core {f['tensor']}", flush=True)
        launch = getattr(ctypes.CDLL(str(lib)), f"{name}_launch")
        pointers, ints = INTERFACES.get((name, design), KERNELS[name])
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


def l1_strict_inputs(wave, device) -> tuple:
    """The fused strict body's arguments of L1 on ``wave``: S1's states of
    its challenge hashes, its signature and key rows and host_ok."""
    engine = FusedEd25519BatchVerifier(device=device)
    sig, key, blocks, n_blocks, host_ok = engine._device_args(*wave[:3])
    return sh.sha512_blocks(blocks, n_blocks), sig, key, host_ok


def l1_aggregate_inputs(lanes: int, device, seed: int = cs.SEED) -> tuple:
    """(z (16, lanes), k (32, lanes), s (32, lanes)) int32 byte rows: random
    128-bit coefficients, k and s random below L."""
    rng = np.random.default_rng(seed)
    below_l = lambda: [int.from_bytes(rng.bytes(32), "little") % sc.L for _ in range(lanes)]
    z = torch.from_numpy(rng.integers(0, 256, (16, lanes)).astype(np.int32)).to(device)
    return z, cs._int_rows(below_l(), 32, device), cs._int_rows(below_l(), 32, device)


def l1_challenge_case(state, sig, key, host_ok, form: str = "checks"):
    """L1's challenge mode from S1's state: k's digits with the canonical
    checks (``form`` "checks", the fused strict body's), its digits alone
    ("digits") or its bytes ("bytes", the aggregate body's), against the
    plain versions; the first design reads the digest's byte rows and has no
    checks (its "checks" case writes the digits alone)."""
    n, device = state.shape[-1], state.device
    want_digits, want_ok = sc.scalar_challenge_checked_reference(state, sig, key, host_ok)
    want_bytes = sc.scalar_challenge_reference(state, digits=False)
    digest = sh.digest_bytes(state).contiguous()

    def spec(design):
        digits = form != "bytes"
        out = torch.full((64 if digits else 32, n), -7, dtype=torch.int32, device=device)
        ok = torch.ones(n, dtype=torch.bool, device=device) & ~want_ok
        outs = (out if digits else None, None, None if digits else out)
        if design == "first":
            pointers = [digest, None, None, *outs, None, None]
        elif form == "checks":
            pointers = [state, None, None, sig, key, host_ok, *outs, ok, None, None]
        else:
            pointers = [state, None, None, None, None, None, *outs, None, None, None]

        def check(_):
            assert torch.equal(out, want_digits if digits else want_bytes), "k"
            assert design == "first" or form != "checks" or torch.equal(ok, want_ok), "ok"
        return pointers, (n, 0, 64 if design == "first" else 0), check

    return spec


def l1_aggregate_case(z, k, s=None):
    """L1's aggregate mode with s (a randomized check's) or without (a
    certificate's) against the plain version's digits and u."""
    n, device = z.shape[1], z.device
    want = sc.scalar_aggregate_reference(z, k, s)

    def spec(design):
        outs = [torch.full((w, n), -7, dtype=torch.int32, device=device) for w in (64, 33)]
        u = partials = None
        if s is not None:
            u = torch.full((32, 1), -7, dtype=torch.int32, device=device)
            partials = torch.empty(-(-n // sc.L1_SUM_LANES) * 8, dtype=torch.int64,
                                   device=device)
        pointers = ([z, k, s, *outs, None, u, partials] if design == "first"
                    else [z, k, s, None, None, None, *outs, None, None, u, partials])

        def check(_):
            for got, w in zip((*outs, u), want):
                assert (got is None and w is None) or torch.equal(got, w)
        return pointers, (n, 1, 16), check

    return spec


def mxu_cases(device) -> dict:
    """M1's cases on both curves at ``MXU_SHAPES`` on the widest operand
    range of ``chip_smoke.MXU_RANGES``, against the plain version on the
    CPU."""
    out = {}
    rng = np.random.default_rng(cs.SEED)
    for curve, ranges in cs.MXU_RANGES.items():
        product = cs.MXU_PRODUCTS[curve][0]
        for a_lanes, b_lanes in MXU_SHAPES:
            a, b = (torch.from_numpy(rng.integers(*ranges[-1], (32, m)).astype(np.float32))
                    for m in (a_lanes, b_lanes))
            want = product(a, b)
            n = want.shape[1]

            def check(outs, want=want):
                assert torch.equal(outs[-1].cpu(), want), "limbs"
            out["mxu_limbs", f"{curve} {a_lanes}x{b_lanes}"] = (
                [a.to(device), b.to(device), torch.empty((32, n), device=device)],
                (n, mxu_limbs._CURVES[curve], int(a_lanes == 1), int(b_lanes == 1)), check)
    return out


def cases(device) -> dict:
    """(kernel, case) -> (pointer arguments, int arguments, check): the
    outputs are the last pointers; check(outputs) raises unless they equal
    the plain version's at tolerance 0.  L1's cases are callables of the
    design, each giving that design's arguments (see :func:`main`)."""
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
    state, sig, key, l1_ok = l1_strict_inputs(wave, device)
    z, k, s = l1_aggregate_inputs(lanes, device)
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
        ("scalar25519", f"challenge {lanes}"): l1_challenge_case(state, sig, key, l1_ok),
        ("scalar25519", f"challenge digits {lanes}"): l1_challenge_case(
            state, sig, key, l1_ok, "digits"),
        ("scalar25519", f"challenge bytes {lanes}"): l1_challenge_case(
            state, sig, key, l1_ok, "bytes"),
        ("scalar25519", "challenge 1"): l1_challenge_case(*map(lane0, (state, sig, key, l1_ok))),
        ("scalar25519", f"aggregate {lanes}"): l1_aggregate_case(z, k, s),
        ("scalar25519", f"certificate {lanes}"): l1_aggregate_case(z, k),
        ("scalar25519", "certificate 8"): l1_aggregate_case(
            *(t[:, :8].contiguous() for t in (z, k))),
        ("scalar25519", "aggregate 1"): l1_aggregate_case(*map(lane0, (z, k, s))),
    }


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("e1_p1_trials: no CUDA device", file=sys.stderr)
        return 1
    kernels = [argv[i + 1] for i, arg in enumerate(argv) if arg == "--kernel"] or list(KERNELS)
    alternatives = [arg for i, arg in enumerate(argv)
                    if arg != "--kernel" and (i == 0 or argv[i - 1] != "--kernel")]
    if not set(kernels) <= set(KERNELS):
        raise SystemExit(f"e1_p1_trials: --kernel takes one of {sorted(KERNELS)}")
    device = torch.device("cuda", 0)
    sources = designs(alternatives, kernels)
    built = build_all(sources)
    equal: dict = {}
    times: dict = {}
    graphs: dict = {}
    every = mxu_cases(device) if "mxu_limbs" in kernels else {}
    if set(kernels) - {"mxu_limbs"}:
        every.update(cases(device))
    for (name, case), spec in every.items():
        if name not in kernels:
            continue
        order = [d for n, d in built if n == name]
        # A callable spec gives each design its own arguments, outputs
        # poisoned, and a check that reads them (L1's first design takes
        # other inputs than csrc's).
        per_design = {d: spec(d) if callable(spec) else spec for d in order}
        for design in order:
            pointers, ints, check = per_design[design]
            if callable(spec):
                outs, args = [], pointers
            else:
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
                pointers, ints, _ = per_design[design]
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
    empty = cs.empty_launcher(cs.build_latency_probe().library)
    floor = [cs.graph_ms(lambda: empty(device), REPS, device) for _ in range(ROUNDS)]
    print("empty kernel (one thread): " + ", ".join(f"{t:.6f}" for t in floor)
          + f" ms a launch replayed from a CUDA graph of {REPS}: the launch floor")
    card = cs.nvidia_smi("name,power.limit")
    print(json.dumps({
        "card": card,
        "ptxas": {f"{n} {d}": f for (n, d), (_, f) in built.items()},
        "ms": {f"{n} {d} {c}": t for (n, d, c), t in times.items()},
        "graph_ms": {f"{n} {d} {c}": t for (n, d, c), t in graphs.items()},
        "equal": {f"{n} {d} {c}": e for (n, d, c), e in equal.items()},
        "empty_graph_ms": floor,
    }))
    print(card)
    return 0 if all(equal.values()) and len(built) == len(sources) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
