"""The tensor-core field lane against the VPU lane on one wave, on one NVIDIA GPU.

    python3 scripts/mxu_lane_probe.py [p256|strict|randomized]

Builds ``chip_smoke.py``'s corpus for the wave (the P-256 wave of phase 5 by
default: 4 replicas x 500 requests; the strict or randomized wave of phases
3 and 7: 7 replicas x 1,000), its engine from ``engine_for_config``, and
runs it with the lane off (``suppress_mxu_limbs``) and on
(``force_mxu_limbs``): one warm-up call a lane, then calls in turns (off,
on, on, off), each timed on the host clock ending in
``torch.cuda.synchronize()`` and checked against the construction's
verdicts; then one ``torch.profiler`` run a lane, printing the top ops by
self CPU time and by device time; then one product of 2,048 lanes through
``field_p256.mul`` under each lane, contiguous, against a (32, 1) constant
and on transposed (strided) operands, as the waves feed them (mean of 50,
host clock).  Ends with the card's name and power limit.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from consensus_tpu_torch.config import Configuration  # noqa: E402
from consensus_tpu_torch.models.verifier import engine_for_config  # noqa: E402
from consensus_tpu_torch.ops import field_p256 as fp  # noqa: E402
from consensus_tpu_torch.ops import mxu_limbs  # noqa: E402

LANES = {"off": mxu_limbs.suppress_mxu_limbs, "on": mxu_limbs.force_mxu_limbs}


def wave(name: str):
    """The wave (messages, signatures, keys, expected verdicts), the
    curve argument of ``engine_for_config`` and the configuration's knobs."""
    if name == "p256":
        corpus = cs.make_p256_corpus(cs.P256_REQUESTS, per_class=3)
        return cs.replica_wave(corpus, cs.P256_REPLICAS), dict(curve="p256"), {}
    if name == "randomized":
        corpus = cs.make_corpus(cs.REQUESTS, per_class=5, classes=cs.RANDOMIZED_CLASSES)
        knobs = {"batch_verify_mode": True}
    else:
        corpus, knobs = cs.make_corpus(cs.REQUESTS, per_class=5), {}
    return cs.replica_wave(corpus, cs.REPLICAS), {}, knobs


def main() -> int:
    if not torch.cuda.is_available():
        print("mxu_lane_probe: no CUDA device", file=sys.stderr)
        return 1
    name = sys.argv[1] if len(sys.argv) > 1 else "p256"
    dev = torch.device("cuda")
    (msgs, sigs, keys, want), kw, knobs = wave(name)
    eng = engine_for_config(Configuration(**knobs), device=dev, **kw)
    for lane in ("off", "on"):
        with LANES[lane]():
            eng.verify_batch(msgs, sigs, keys)
    torch.cuda.synchronize()
    for lane in ("off", "on", "on", "off"):
        with LANES[lane]():
            t0 = time.perf_counter()
            got = eng.verify_batch(msgs, sigs, keys)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        if not (got == want).all():
            raise AssertionError(f"lane {lane}: verdicts differ from the construction")
        print(f"{name} wave, lane {lane}: {ms:.3f} ms", flush=True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for lane in ("off", "on"):
        with LANES[lane](), torch.profiler.profile(activities=acts) as prof:
            eng.verify_batch(msgs, sigs, keys)
            torch.cuda.synchronize()
        print(f"===== lane {lane}")
        print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=30))
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=12), flush=True)
    a = torch.randint(-300, 300, (32, 2048), device=dev).float()
    c = torch.randint(0, 256, (32, 1), device=dev).float()
    strided = a.T.contiguous().T
    for label, x, y in (("contiguous", a, a), ("constant", c, a), ("strided", strided, strided)):
        for lane in ("off", "on"):
            with LANES[lane]():
                fp.mul(x, y)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(50):
                    fp.mul(x, y)
                torch.cuda.synchronize()
            print(f"{label} product, lane {lane}: "
                  f"{(time.perf_counter() - t0) * 1e3 / 50:.6f} ms (host clock)", flush=True)
    print(cs.nvidia_smi("name,power.limit"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
