"""Design trials of kernel S1 (SHA-512) on one NVIDIA GPU.

    python3 scripts/s1_trials.py [sha512_<design>.cu ...]

Builds the design in ``consensus_tpu_torch/csrc/sha512.cu`` and every
alternative named on the command line side by side.  An alternative is a
source with the same C entry point (``sha512_launch``), named
``sha512_<design>.cu``; it is built with csrc on its include path, so it may
include csrc's source and reuse its helpers.  One nvcc per source, all
started together, into ``consensus_tpu_torch/csrc/build/trials/``; a design
that does not build is reported and left out.  Each design is then checked
at every width S1 runs, at tolerance 0 against the plain version (the
transcript root, whose thousands of blocks the plain version cannot finish,
against ``hashlib``), and its launches are timed with CUDA events in turns
within one process (designs in order, reversed, in order), as launches and
as calls through the wrapper ``sha512_blocks`` with the design's library in
the wrapper's registry: 8,192 lanes of 2
blocks (a strict wave's challenges: 7,000 live lanes, the rest padding) and
the same lanes' first blocks alone, one lane of 3,431 blocks (the randomized
wave's transcript root), 8 lanes of 2 blocks (a half-agg certificate) and 16
lanes of up to 40 blocks.  The messages are random bytes from numpy seed 0.
Prints each design's ptxas figures and SASS (instructions of each kernel, of
its widest loop and that loop's mix of opcodes), the card's dependent-issue
latency from ``chip_smoke.py``'s probe, one line per design and width (its
launches' and wrapper calls' times, and a launch's time when launches
captured in a CUDA graph are replayed: at a wave's width a launch from
Python takes about as long as the kernel runs), a JSON summary, and the
card's name and power limit.

The designs csrc's design was timed against (the first version, one thread
per lane; two passes through device memory; rotations as products; four
warps a CTA; each lane's rounds split over two warps) are kept in git
history, at the commit that redesigned the kernel
(``git show c74061d:scripts/s1_trials/``), and the split with tagged
hand-offs at ``d08f3b5``; to time them again, unpack those files and name
them here.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from consensus_tpu_torch.ops import scan_kernels  # noqa: E402
from consensus_tpu_torch.ops import sha512 as sh  # noqa: E402

TRIALS = scan_kernels.BUILD_DIR / "trials"
ROUNDS = 3
#: width -> launches a turn.
REPS = {"wave": 50, "one_block": 50, "root": 3, "certs": 50, "long": 20}


def designs(alternatives) -> dict:
    """design -> source path: csrc's design and the alternatives."""
    out = {"csrc": scan_kernels._CSRC / "sha512.cu"}
    for path in map(Path, alternatives):
        if not path.stem.startswith("sha512_"):
            raise SystemExit(f"s1_trials: {path.name} is not sha512_<design>.cu")
        out[path.stem[len("sha512_"):]] = path.resolve()
    return out


def ptxas_figures(report: str) -> dict:
    """Registers, shared memory, stack frame and spills of each __global__
    kernel in an ``-Xptxas -v`` report."""
    figures = {}
    for block in report.split("Compiling entry function '")[1:]:
        name = block.split("'", 1)[0]
        entry = {}
        for key, pattern in (("registers", r"Used (\d+) registers"),
                             ("smem_bytes", r"(\d+) bytes smem"),
                             ("stack_bytes", r"(\d+) bytes stack frame"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads")):
            found = re.search(pattern, block)
            entry[key] = int(found.group(1)) if found else 0
        figures[name] = entry
    return figures


def sass_figures(library: Path) -> dict:
    """Per kernel of ``library`` (``cuobjdump -sass``): its instructions, and
    its widest loop's instructions and their opcodes by count."""
    cuobjdump = Path(scan_kernels._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    out, name, body = {}, None, []

    def close():
        if name is None:
            return
        loops = []
        for addr, ins in body:
            m = re.search(r"\bBRA\s+(?:\S+\s+)?0x([0-9a-f]+)", ins)
            if m and int(m.group(1), 16) < addr:
                loops.append((addr - int(m.group(1), 16), int(m.group(1), 16), addr))
        entry = {"instructions": sum(1 for _, ins in body if ins != "NOP")}
        if loops:
            _, lo, hi = max(loops)
            ops = [ins.split()[0] if not ins.startswith("@") else ins.split()[1]
                   for addr, ins in body if lo <= addr <= hi]
            entry["widest_loop"] = len(ops)
            entry["loop_opcodes"] = dict(collections.Counter(
                op.split(".")[0] for op in ops).most_common(12))
        out[name] = entry

    for line in text.splitlines():
        if "Function :" in line:
            close()
            name, body = line.split("Function :")[1].strip(), []
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if name and m:
            body.append((int(m.group(1), 16), m.group(2)))
    close()
    return out


def build_all(sources: dict) -> dict:
    """Start one nvcc per design together; design -> (launch function,
    ptxas figures, SASS figures) for each that built."""
    TRIALS.mkdir(parents=True, exist_ok=True)
    procs = {}
    for design, cu in sources.items():
        lib = TRIALS / f"sha512_{design}.so"
        procs[design] = (lib, subprocess.Popen(
            scan_kernels.nvcc_command(cu, lib, f"-I{scan_kernels._CSRC}"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    built = {}
    for design, (lib, proc) in procs.items():
        report = proc.communicate()[0]
        if proc.returncode:
            print(f"sha512 {design}: nvcc failed\n{report}", flush=True)
            continue
        ptxas, sass = ptxas_figures(report), sass_figures(lib)
        print(f"sha512 {design}: built; ptxas {ptxas}", flush=True)
        for kernel, figures in sass.items():
            print(f"  sass {kernel}: {figures}", flush=True)
        cdll = ctypes.CDLL(str(lib))
        launch = cdll.sha512_launch
        launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        launch.restype = ctypes.c_int
        cdll.sha512_error_string.argtypes = [ctypes.c_int]
        cdll.sha512_error_string.restype = ctypes.c_char_p
        library = (cdll, scan_kernels.BuildInfo(str(lib), "", 0.0, report, True))
        built[design] = (launch, ptxas, sass, library)
    return built


def run(launch, blocks, n_blocks, state, device) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    code = launch(blocks.data_ptr(), n_blocks.data_ptr(), state.data_ptr(),
                  blocks.shape[-1], blocks.shape[0], device.index or 0, stream)
    if code:
        raise RuntimeError(f"launch failed: {code}")


def graph_time(launch, blocks, n_blocks, state, device, reps: int) -> float:
    """Mean milliseconds of a launch when ``reps`` launches captured in one
    CUDA graph are replayed (no host work between them)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            run(launch, blocks, n_blocks, state, device)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cases(device) -> dict:
    """width -> (blocks, n_blocks, messages or None): the widths S1 runs."""
    rng = np.random.default_rng(0)
    live = [rng.bytes(int(n)) for n in rng.integers(112, 240, 7000)]
    blocks, n = sh.pad_messages(live)
    wave = np.zeros(blocks.shape[:3] + (8192,), dtype=np.uint32)
    wave[..., :7000] = blocks
    counts = np.zeros(8192, dtype=np.int32)
    counts[:7000] = n
    wave_t = sh.blocks_tensor(wave).to(device)
    counts_t = torch.from_numpy(counts).to(device)
    root = rng.bytes(439062)
    long_msgs = chip_smoke.long_lane_messages(chip_smoke.S1_LONG_LANES,
                                              chip_smoke.S1_LONG_BLOCKS)
    out = {
        "wave": (wave_t, counts_t, None),
        "one_block": (wave_t[:1].contiguous(), counts_t, None),
        "root": (*sh.pad_messages([root]), [root]),
        "certs": (wave_t[..., :8].contiguous(), counts_t[:8].contiguous(), None),
        "long": (*sh.pad_messages(long_msgs), long_msgs),
    }
    for key in ("root", "long"):
        b, c, msgs = out[key]
        out[key] = (sh.blocks_tensor(b).to(device), torch.from_numpy(c).to(device), msgs)
    return out


def main(alternatives) -> int:
    if not torch.cuda.is_available():
        print("s1_trials: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    sources = designs(alternatives)
    built = build_all(sources)
    probe = chip_smoke.build_latency_probe()
    latency = chip_smoke.dependent_issue_cycles(probe.library, device)
    probe_sass = sass_figures(Path(probe.library))
    print(f"dependent-issue latency {latency} SM clocks an instruction; probe sass {probe_sass}",
          flush=True)

    equal: dict = {}
    times: dict = {}
    graph_ms: dict = {}
    wrapper_ms: dict = {}
    for width, (blocks, n_blocks, msgs) in cases(device).items():
        want = None if width == "root" else sh.sha512_blocks_reference(blocks, n_blocks)
        order = list(built)
        for design in order:
            state = torch.full((8, 2, blocks.shape[-1]), -1, dtype=torch.int32, device=device)
            run(built[design][0], blocks, n_blocks, state, device)
            torch.cuda.synchronize()
            same = want is None or torch.equal(state, want)
            if msgs is not None:
                digests = sh.digest_bytes(state).cpu().numpy().astype(np.uint8)
                same = same and all(bytes(digests[:, i]) == hashlib.sha512(m).digest()
                                    for i, m in enumerate(msgs))
            equal[design, width] = bool(same)
            if not same:
                print(f"sha512 {design} width {width}: DIFFERS", flush=True)
        for turn in range(ROUNDS):
            for design in order if turn % 2 == 0 else order[::-1]:
                state = torch.empty((8, 2, blocks.shape[-1]), dtype=torch.int32, device=device)
                launch = built[design][0]
                run(launch, blocks, n_blocks, state, device)  # warm-up
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(REPS[width]):
                    run(launch, blocks, n_blocks, state, device)
                end.record()
                torch.cuda.synchronize()
                times.setdefault((design, width), []).append(
                    start.elapsed_time(end) / REPS[width])
                # The same design through the wrapper, as chip_smoke.py times S1:
                # its library stands in for csrc's in the wrapper's registry.
                scan_kernels._LIBRARIES["sha512"] = built[design][3]
                sh.sha512_blocks(blocks, n_blocks)
                start.record()
                for _ in range(REPS[width]):
                    sh.sha512_blocks(blocks, n_blocks)
                end.record()
                torch.cuda.synchronize()
                wrapper_ms.setdefault((design, width), []).append(
                    start.elapsed_time(end) / REPS[width])
        for design in order:
            state = torch.empty((8, 2, blocks.shape[-1]), dtype=torch.int32, device=device)
            graph_ms[design, width] = graph_time(built[design][0], blocks, n_blocks, state,
                                                 device, REPS[width])
    for (design, width), ms in times.items():
        verdict = "equal to" if equal[design, width] else "DIFFERENT from"
        print(f"sha512 {design} {width}: " + ", ".join(f"{t:.6f}" for t in ms)
              + f" ms (CUDA events, mean of {REPS[width]} launches a turn); through the "
              "wrapper " + ", ".join(f"{t:.6f}" for t in wrapper_ms[design, width]) + " ms; "
              f"{graph_ms[design, width]:.6f} ms a launch replayed from a CUDA graph; "
              f"{verdict} the plain version / hashlib", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(json.dumps({
        "card": card,
        "latency_cycles": latency["cycles"],
        "ptxas": {d: b[1] for d, b in built.items()},
        "sass": {d: b[2] for d, b in built.items()},
        "ms": {f"{d} {w}": t for (d, w), t in times.items()},
        "graph_ms": {f"{d} {w}": t for (d, w), t in graph_ms.items()},
        "wrapper_ms": {f"{d} {w}": t for (d, w), t in wrapper_ms.items()},
        "equal": {f"{d} {w}": e for (d, w), e in equal.items()},
    }))
    print(card)
    return 0 if all(equal.values()) and len(built) == len(sources) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
