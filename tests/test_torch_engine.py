"""The port's engine coalescers held against the JAX package's.

``consensus_tpu_torch.models.engine`` against ``consensus_tpu.models.engine``:
the JAX package's own cases (``tests/test_crypto.py`` ``TestCoalescer``,
``TestThreadCoalescer``, ``TestWedgedDeviceEscapeHatch``; the slice-wave
cases of ``tests/test_mesh.py``; the cross-group wave-former case of
``tests/test_groups.py``) run on the port's classes, then differential
cases with exact equality: one seeded stream of submissions through both
``BatchCoalescer``s under their ``SimScheduler``s gives the same batch
partition, and 4 replica threads x 8 signatures through a
``ThreadCoalescingVerifier`` over the port's strict engine on the CPU (the
plain torch versions) give the JAX engine's verdicts.  Last, the kernel
build lock: threads that ask for a kernel library together build it once.
"""

import threading
import time

import numpy as np
import pytest
import torch

from consensus_tpu.models import ed25519 as jmed
from consensus_tpu.models import engine as jengine
from consensus_tpu.runtime.scheduler import SimScheduler as JaxSimScheduler
from consensus_tpu_torch.metrics import GROUPS_WAVE_MULTI_KEY, InMemoryProvider, Metrics
from consensus_tpu_torch.models import BatchCoalescer, ThreadCoalescingVerifier
from consensus_tpu_torch.models import engine as tengine
from consensus_tpu_torch.models.ed25519 import Ed25519BatchVerifier, ref_public_key, ref_sign
from consensus_tpu_torch.models.engine import AdmissionReject, FairShareWaveFormer
from consensus_tpu_torch.models.verifier import Ed25519Signer
from consensus_tpu_torch.obs.kernels import COMPILE_CACHE, KERNELS
from consensus_tpu_torch.ops import scan_kernels
from consensus_tpu_torch.runtime.scheduler import SimScheduler


# --- BatchCoalescer (tests/test_crypto.py TestCoalescer) ------------------------


def test_coalescer_merges_submissions_into_one_batch():
    s = SimScheduler()
    calls = []

    def run(items):
        calls.append(list(items))
        return [x * 2 for x in items]

    c = BatchCoalescer(s, run, window=0.002, max_batch=100)
    got = {}
    c.submit([1, 2], lambda r: got.update(a=list(r)))
    c.submit([3], lambda r: got.update(b=list(r)))
    assert calls == []
    s.advance(0.002)
    assert calls == [[1, 2, 3]]
    assert got == {"a": [2, 4], "b": [6]}


def test_coalescer_max_batch_flushes_early():
    s = SimScheduler()
    calls = []
    c = BatchCoalescer(s, lambda items: (calls.append(len(items)), items)[1],
                       window=10.0, max_batch=4)
    c.submit([1, 2], lambda r: None)
    c.submit([3, 4], lambda r: None)
    assert calls == [4]
    assert s.now() == 0.0


def test_coalescer_empty_submission_completes_immediately():
    s = SimScheduler()
    c = BatchCoalescer(s, lambda items: items, window=1.0)
    out = []
    c.submit([], out.append)
    assert out == [[]]


def test_split_results_refuses_short_results():
    assert tengine._split_results([1, 2, 3], [2, 1]) == [[1, 2], [3]]
    with pytest.raises(ValueError, match="2 results for 3 items"):
        tengine._split_results([1, 2], [2, 1])


# --- ThreadCoalescingVerifier (tests/test_crypto.py TestThreadCoalescer) --------


class _Fake:
    def __init__(self):
        self.calls = []

    def verify_batch(self, msgs, sigs, keys):
        self.calls.append(len(msgs))
        return np.array([s == b"good" for s in sigs], dtype=bool)


def _make(**kw):
    fake = _Fake()
    return fake, ThreadCoalescingVerifier(fake, **kw)


def _run_threads(targets):
    threads = [threading.Thread(target=t) for t in targets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=5.0)
    assert not any(t.is_alive() for t in threads)


def test_concurrent_callers_merge_and_get_their_slices():
    fake, v = _make(window=0.05, max_batch=30)
    results = {}
    patterns = {0: [b"good"] * 10, 1: [b"bad"] * 10, 2: [b"good", b"bad"] * 5}

    def worker(i):
        sigs = patterns[i]
        results[i] = list(v.verify_batch([b"m"] * len(sigs), sigs, [b"k"] * len(sigs)))

    _run_threads([lambda i=i: worker(i) for i in patterns])
    assert fake.calls == [30]
    assert results[0] == [True] * 10
    assert results[1] == [False] * 10
    assert results[2] == [True, False] * 5
    v.close()


def test_hard_cap_splits_whole_submissions():
    fake, v = _make(window=0.01, max_batch=10, hard_cap=15)
    done = []
    worker = lambda: done.append(v.verify_batch([b"m"] * 10, [b"good"] * 10, [b"k"] * 10).all())
    _run_threads([worker, worker])
    assert fake.calls == [10, 10]
    assert done == [True, True]
    v.close()


def test_engine_error_propagates_to_every_waiter():
    class _Boom:
        def verify_batch(self, m, s, k):
            raise RuntimeError("device fell over")

    v = ThreadCoalescingVerifier(_Boom(), window=0.01, max_batch=4)
    errors = []

    def worker():
        try:
            v.verify_batch([b"m"], [b"s"], [b"k"])
        except RuntimeError as e:
            errors.append(f"{e} / cause: {e.__cause__}")

    _run_threads([worker, worker])
    assert len(errors) == 2
    assert all("device fell over" in e for e in errors)
    v.close()


def test_oversized_submission_is_chunked_not_overlaunched():
    fake, v = _make(window=0.005, max_batch=8, hard_cap=8)
    out = v.verify_batch([b"m"] * 20, [b"good"] * 19 + [b"bad"], [b"k"] * 20)
    assert len(out) == 20
    assert out[:19].all() and not out[19]
    assert max(fake.calls) <= 8
    v.close()


def test_short_engine_result_errors_instead_of_validating():
    class _Short:
        def verify_batch(self, m, s, k):
            return np.ones(len(m) - 1, dtype=bool)

    v = ThreadCoalescingVerifier(_Short(), window=0.005, max_batch=4)
    with pytest.raises(RuntimeError) as exc_info:
        v.verify_batch([b"m"] * 2, [b"s"] * 2, [b"k"] * 2)
    assert isinstance(exc_info.value.__cause__, ValueError)
    v.close()


def test_closed_coalescer_rejects_submissions():
    _, v = _make(window=0.01)
    v.close()
    with pytest.raises(RuntimeError):
        v.verify_batch([b"m"], [b"s"], [b"k"])


def test_small_submissions_bypass_the_window_on_the_callers_thread():
    fake, v = _make(window=10.0, max_batch=100, bypass_below=4)
    start = time.monotonic()
    assert list(v.verify_batch([b"m"] * 3, [b"good", b"bad", b"good"], [b"k"] * 3)) == [
        True, False, True,
    ]
    assert time.monotonic() - start < 5.0 and fake.calls == [3]
    v.close()


# --- the wedged-device escape hatch (TestWedgedDeviceEscapeHatch) ---------------


class _Hung:
    """Engine whose device path never returns but whose host path works."""

    def __init__(self):
        self.never = threading.Event()
        self.host_calls = 0

    def verify_batch(self, msgs, sigs, keys):
        self.never.wait()

    def verify_host(self, msgs, sigs, keys):
        self.host_calls += 1
        return np.array([s == b"good" for s in sigs], dtype=bool)


def test_hung_engine_falls_back_to_host_and_marks_suspect():
    fake = _Hung()
    v = ThreadCoalescingVerifier(fake, window=0.005, wait_timeout=0.15)
    start = time.monotonic()
    out = v.verify_batch([b"m"] * 3, [b"good", b"bad", b"good"], [b"k"] * 3)
    assert list(out) == [True, False, True]
    assert time.monotonic() - start < 5.0
    assert v.device_suspect
    start = time.monotonic()
    out2 = v.verify_batch([b"m"], [b"good"], [b"k"])
    assert time.monotonic() - start < 0.1
    assert out2[0]
    assert fake.host_calls >= 2
    fake.never.set()
    v.close()


def test_fast_device_error_is_served_by_host_fallback():
    class _Flaky(_Hung):
        def verify_batch(self, msgs, sigs, keys):
            raise RuntimeError("device fell over")

    v = ThreadCoalescingVerifier(_Flaky(), window=0.005, wait_timeout=5.0)
    out = v.verify_batch([b"m"] * 2, [b"good", b"bad"], [b"k"] * 2)
    assert list(out) == [True, False]
    assert v.device_suspect
    v.close()


def test_probe_recovers_device_after_transient_failure():
    class _Transient:
        def __init__(self):
            self.fail = True
            self.device_calls = 0

        def verify_batch(self, msgs, sigs, keys):
            self.device_calls += 1
            if self.fail:
                raise RuntimeError("transient device error")
            return np.array([s == b"good" for s in sigs], dtype=bool)

        def verify_host(self, msgs, sigs, keys):
            return np.array([s == b"good" for s in sigs], dtype=bool)

    fake = _Transient()
    v = ThreadCoalescingVerifier(fake, window=0.005, wait_timeout=5.0)
    v._probe_interval = 0.0
    assert list(v.verify_batch([b"m"], [b"good"], [b"k"])) == [True]
    assert v.device_suspect
    fake.fail = False
    assert list(v.verify_batch([b"m"], [b"good"], [b"k"])) == [True]
    deadline = time.monotonic() + 5.0
    while v.device_suspect and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not v.device_suspect
    before = fake.device_calls
    assert list(v.verify_batch([b"m"], [b"good"], [b"k"])) == [True]
    assert fake.device_calls > before
    v.close()


def test_flush_error_reaching_a_waiter_is_retried_on_host_not_raised():
    class _DoubleFault:
        def __init__(self):
            self.host_calls = 0

        def verify_batch(self, msgs, sigs, keys):
            raise RuntimeError("device fell over")

        def verify_host(self, msgs, sigs, keys):
            self.host_calls += 1
            if self.host_calls == 1:
                raise RuntimeError("host transient")
            return np.array([s == b"good" for s in sigs], dtype=bool)

    fake = _DoubleFault()
    v = ThreadCoalescingVerifier(fake, window=0.005, wait_timeout=5.0)
    out = v.verify_batch([b"m"] * 2, [b"good", b"bad"], [b"k"] * 2)
    assert list(out) == [True, False]
    assert fake.host_calls == 2
    assert v.device_suspect
    v.close()


def test_coalescers_share_suspect_state_per_engine():
    fake = _Hung()
    a = ThreadCoalescingVerifier(fake, window=0.005, wait_timeout=0.15)
    b = ThreadCoalescingVerifier(fake, window=0.005, wait_timeout=60.0)
    assert a.health is b.health
    assert list(a.verify_batch([b"m"], [b"good"], [b"k"])) == [True]
    assert a.device_suspect and b.device_suspect
    start = time.monotonic()
    assert list(b.verify_batch([b"m"], [b"bad"], [b"k"])) == [False]
    assert time.monotonic() - start < 5.0
    fake.never.set()
    a.close()
    b.close()


def test_probe_pacing_uses_injected_scheduler_clock():
    sched = SimScheduler()
    fake = _Hung()
    v = ThreadCoalescingVerifier(fake, window=0.005, wait_timeout=0.15, scheduler=sched)
    assert v._probe_clock == sched.now
    v.close()


# --- slice-filling waves (tests/test_mesh.py) ------------------------------------


def test_slice_wave_target_fills_whole_slices():
    class MeshEngine:
        shard_count = 4
        preferred_wave_size = 32

    class NoPreference:
        shard_count = 4
        preferred_wave_size = 0

    for mod in (tengine, jengine):
        assert mod._slice_wave_target(MeshEngine(), 256) == 32
        assert mod._slice_wave_target(MeshEngine(), 16) == 16
        assert mod._slice_wave_target(NoPreference(), 256) == 256
    assert tengine._slice_wave_target(Ed25519BatchVerifier(device="cpu"), 256) == 256


# --- the wave former (tests/test_groups.py) --------------------------------------


def _signed(signer, tag: bytes, count: int):
    messages = [tag + b"/%d" % i for i in range(count)]
    return messages, [signer.sign_raw(m) for m in messages], [signer.public_bytes] * count


def test_shared_former_coalesces_across_groups():
    metrics = Metrics(InMemoryProvider())
    engine = Ed25519BatchVerifier(min_device_batch=10**9, device="cpu")
    waves = []
    former = FairShareWaveFormer(
        engine,
        window=0.2,
        groups_metrics=metrics.groups,
        on_group_wave=lambda counts, total: waves.append(dict(counts)),
        name="test-groups-former",
    )
    signer = Ed25519Signer(1, b"\x11" * 32)
    barrier = threading.Barrier(2)
    results = {}

    def submit(gid):
        barrier.wait()
        msgs, sigs, keys = _signed(signer, gid.encode(), 3)
        results[gid] = former.submit(f"{gid}/certs", msgs, sigs, keys, group=gid)

    _run_threads([lambda g=g: submit(g) for g in ("group-0", "group-1")])
    former.close()
    assert all(results["group-0"]) and all(results["group-1"])
    multi = [w for w in waves if len(w) == 2]
    assert multi and multi[0] == {"group-0": 3, "group-1": 3}
    assert metrics.provider.dump()[GROUPS_WAVE_MULTI_KEY]["value"] >= 1.0


def test_former_rejects_past_the_tenant_queue_limit():
    entered, gate = threading.Event(), threading.Event()

    class _Gated(_Fake):
        def verify_batch(self, msgs, sigs, keys):
            entered.set()
            gate.wait(5.0)
            return super().verify_batch(msgs, sigs, keys)

    former = FairShareWaveFormer(_Gated(), window=0.001, tenant_queue_limit=4)
    submit = lambda tenant, n: former.submit(tenant, [b"m"] * n, [b"good"] * n, [b"k"] * n)
    first = threading.Thread(target=submit, args=("a", 2))
    first.start()
    assert entered.wait(5.0)  # tenant a's first wave is on the engine
    queued = threading.Thread(target=submit, args=("a", 3))
    queued.start()
    deadline = time.monotonic() + 5.0
    while former.queue_depth("a") < 3 and time.monotonic() < deadline:
        time.sleep(0.001)
    # 3 queued + 3 more pass tenant a's limit of 4: a structured reject,
    # never a stall; tenant b's own queue is untouched.
    with pytest.raises(AdmissionReject) as rej:
        submit("a", 3)
    assert (rej.value.tenant, rej.value.queue_depth, rej.value.limit) == ("a", 3, 4)
    gate.set()
    assert list(former.submit("b", [b"m"], [b"bad"], [b"k"])) == [False]
    first.join(5.0)
    queued.join(5.0)
    former.close()


# --- differential: the same submissions through both packages --------------------


def _partition(coalescer_cls, scheduler_cls, seed: int):
    rng = np.random.default_rng(seed)
    sched = scheduler_cls()
    batches, delivered = [], []

    def run(items):
        batches.append((sched.now(), list(items)))
        return [x * 3 + 1 for x in items]

    c = coalescer_cls(sched, run, window=0.004, max_batch=24)
    item = 0
    for sub in range(200):
        sched.advance(float(rng.choice([0.0, 0.001, 0.003, 0.01])))
        n = int(rng.integers(0, 9))
        items = list(range(item, item + n))
        item += n
        c.submit(items, lambda r, sub=sub: delivered.append((sub, list(r))))
    sched.advance(1.0)
    return batches, delivered


@pytest.mark.parametrize("seed", [0, 1])
def test_batch_coalescer_partition_matches_jax(seed):
    port = _partition(BatchCoalescer, SimScheduler, seed)
    assert port == _partition(jengine.BatchCoalescer, JaxSimScheduler, seed)
    batches, delivered = port
    assert len(batches) > 20 and max(len(b) for _, b in batches) >= 24
    assert len(delivered) == 200


def test_thread_coalescer_over_the_port_engine_gives_the_jax_verdicts():
    """4 replica threads x 8 signatures (valid, tampered, wrong key, S >= L)
    through one coalescer over the port's strict engine on the CPU; the
    merged flush runs the plain torch path (min_device_batch 16 <= 32)."""
    rng = np.random.default_rng(11)
    seeds = [rng.bytes(32) for _ in range(8)]
    keys = [ref_public_key(s) for s in seeds]
    replicas = []
    for r in range(4):
        msgs = [b"replica-%d/request-%d" % (r, i) for i in range(8)]
        sigs = [ref_sign(s, m) for s, m in zip(seeds, msgs)]
        ks = list(keys)
        sigs[r] = sigs[r][:32] + bytes([sigs[r][32] ^ 1]) + sigs[r][33:]
        ks[(r + 3) % 8] = keys[(r + 4) % 8]
        s_big = int.from_bytes(sigs[7][32:], "little") + jmed.L
        sigs[7] = sigs[7][:32] + s_big.to_bytes(32, "little")
        replicas.append((msgs, sigs, ks))

    class _Counting(Ed25519BatchVerifier):
        flushes = 0

        def verify_batch(self, m, s, k):
            type(self).flushes += 1
            return super().verify_batch(m, s, k)

    engine = _Counting(min_device_batch=16, device="cpu")
    coalescer = ThreadCoalescingVerifier(engine, window=5.0, max_batch=32, hard_cap=32)
    barrier = threading.Barrier(4)
    got = {}

    def replica(r):
        barrier.wait()
        got[r] = coalescer.verify_batch(*replicas[r])

    before = KERNELS.stats("ed25519.verify").launches
    threads = [threading.Thread(target=replica, args=(r,)) for r in range(4)]
    # One intra-op thread: the test workers share the box's cores.
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
    finally:
        torch.set_num_threads(torch_threads)
        coalescer.close()
    assert not any(t.is_alive() for t in threads)
    assert not coalescer.device_suspect
    # One merged flush: one device-path call of the engine, no kernel launch
    # (CPU tensors run the plain versions).
    assert _Counting.flushes == 1
    assert KERNELS.stats("ed25519.verify").launches == before + 1
    jax_engine = jmed.Ed25519BatchVerifier(min_device_batch=10**9)
    for r in range(4):
        want = jax_engine.verify_batch(*replicas[r])
        assert got[r].tolist() == want.tolist()
        assert want.tolist() == [i not in (r, (r + 3) % 8, 7) for i in range(8)]


def test_preferred_wave_size_matches_jax():
    from consensus_tpu.models import ecdsa_p256 as jp256
    from consensus_tpu_torch.models.ecdsa_p256 import EcdsaP256BatchVerifier

    for min_batch in (0, 1, 5, 8, 9, 16, 100, 7000):
        for pad_to in (0, 4, 16, 64, 8192):
            for pad_pow2 in (True, False):
                kw = dict(min_device_batch=min_batch, pad_to=pad_to, pad_pow2=pad_pow2)
                want = jmed.Ed25519BatchVerifier(**kw).preferred_wave_size
                assert Ed25519BatchVerifier(**kw, device="cpu").preferred_wave_size == want
                assert (
                    EcdsaP256BatchVerifier(**kw, device="cpu").preferred_wave_size
                    == jp256.EcdsaP256BatchVerifier(**kw).preferred_wave_size
                    == want
                )


# --- the kernel build lock ------------------------------------------------------


def test_concurrent_first_builds_of_a_kernel_build_it_once(monkeypatch):
    """Two threads asking for one kernel's library together: one build, both
    get it; another kernel's build is not held up by the lock."""
    monkeypatch.setattr(scan_kernels, "_LIBRARIES", {})
    active, peak, built = [0], [0], []
    guard = threading.Lock()

    def fake_build(name):
        with guard:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
        time.sleep(0.05)
        with guard:
            active[0] -= 1
        built.append(name)
        return object(), scan_kernels.BuildInfo(name, "", 0.0, "", True)

    monkeypatch.setattr(scan_kernels, "_build_and_load", fake_build)
    barrier = threading.Barrier(3)
    got = []

    def ask(name):
        barrier.wait()
        got.append((name, scan_kernels._library(name)))

    _run_threads([lambda: ask("horner_scan"), lambda: ask("horner_scan"), lambda: ask("straus_msm")])
    assert sorted(built) == ["horner_scan", "straus_msm"]
    assert peak[0] == 2  # the two kernels built side by side
    libs = [lib for name, lib in got if name == "horner_scan"]
    assert len(libs) == 2 and libs[0] is libs[1]


def test_library_loads_are_booked_in_the_compile_cache(monkeypatch, tmp_path):
    """A library found in the build directory is a hit; no nvcc runs and no
    compile is booked."""
    monkeypatch.setattr(scan_kernels, "_LIBRARIES", {})
    monkeypatch.setattr(scan_kernels, "BUILD_DIR", tmp_path)
    loaded = []

    class _Lib:
        def __getattr__(self, attr):
            fn = lambda *a: 0
            return fn

    monkeypatch.setattr(scan_kernels.ctypes, "CDLL", lambda path: loaded.append(path) or _Lib())
    source, _, _ = scan_kernels.KERNELS["horner_scan"]
    import hashlib

    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        digest.update(header.read_bytes())
    (tmp_path / f"horner_scan-{digest.hexdigest()[:16]}.so").write_bytes(b"")
    before, compiles = COMPILE_CACHE.snapshot(), KERNELS.stats("horner_scan").compiles
    info = scan_kernels.build("horner_scan")
    assert info.cached and loaded == [info.library]
    after = COMPILE_CACHE.snapshot()
    assert (after["hits"] - before["hits"], after["misses"] - before["misses"]) == (1, 0)
    assert KERNELS.stats("horner_scan").compiles == compiles


def test_ledger_books_every_launch_from_many_threads():
    """More threads than cores booking launches and builds with a short
    switch interval: no update is lost."""
    import os
    import sys

    from consensus_tpu_torch.obs.kernels import CompileCacheStats, KernelRegistry

    ledger, cache = KernelRegistry(), CompileCacheStats()
    workers, each = 2 * (os.cpu_count() or 4), 2000

    def book():
        for i in range(each):
            ledger.record_launch("horner_scan" if i % 2 else "straus_msm")
            ledger.record_compile("horner_scan")
            cache.record(hit=bool(i % 2))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=book) for _ in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    snap = ledger.snapshot()
    assert snap["horner_scan"]["launches"] == snap["straus_msm"]["launches"] == workers * each // 2
    assert snap["horner_scan"]["compiles"] == workers * each
    assert cache.snapshot() == {"hits": workers * each // 2, "misses": workers * each // 2}
