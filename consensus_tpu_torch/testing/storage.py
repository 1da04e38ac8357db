"""Deterministic storage-fault injection beneath the file-backed WAL.

The crash matrix (testing/faults.py) kills the *process* at instrumented
seams; this layer faults the *disk* under a live process instead.  A
:class:`StorageFaultInjector` swaps the log's injectable open seams
(``WriteAheadLog._open_for_append`` / ``_open_for_read``) for fault-wrapped
file objects, so every byte the WAL writes or reads can be corrupted,
refused, or silently dropped — deterministically, from an explicit seed,
with zero wall-clock reads (scripts/check_no_wallclock.py lints this module
too).

Fault classes (:data:`STORAGE_FAULT_CLASSES`):

``bit_flip``    flip one bit of a committed record on disk, chosen from the
                seeded RNG over record bytes (headers + payloads; never the
                inter-record zero padding, which the CRC chain does not
                cover).  Latent until the scrubber (wal/scrub.py) or the
                next boot re-walks the chain.
``torn_mid``    the next append writes only a prefix of its frame (torn at
                an RNG offset), fsyncs the partial bytes, then fails — and
                the device goes read-only (every later write refused) until
                :meth:`heal`.  Holding writes off keeps the torn frame the
                durable tail, so the fault is exactly the mid-file tear the
                scrubber must quarantine (a tear followed by more appends
                would instead be chopped by boot-time ``repair`` as if the
                suffix had never been durable).
``fsync_lie``   fsyncs keep reporting success but stop being real: at the
                next simulated crash every byte written after the arm is
                dropped (the file truncates back to its arm-time length).
                The classic lying-disk hazard — locally undetectable, so
                the harness boots the next incarnation fenced
                (:meth:`consume_suspect_fence`).
``enospc``      a byte budget, after which writes (and flushes, so the
                degraded-probe cannot lie its way out) fail with ENOSPC
                until :meth:`heal` — the WAL must degrade, stop minting
                unpersistable work, and auto-recover when space returns.
``eio_read``    the next ``count`` reads through the read seam raise EIO —
                the scrubber treats an unreadable segment as corruption at
                offset 0 and the quarantine/fence path takes over.
``slow_fsync``  the next ``count`` fsyncs fail transiently (injected-clock
                latency modeled as deferred durability): in group-commit
                mode each failure books ``wal_fsync_retry_total``; below
                the retry cap the log recovers on its own.

Every fired fault is recorded on :attr:`StorageFaultInjector.fired` as
``(kind, detail)``, mirroring the chaos engine's launch-fault injector.

The PyTorch port's copy of ``consensus_tpu/testing/storage.py``, its imports renamed.
"""

from __future__ import annotations

import errno
import os
import random
import struct
from typing import Optional

from consensus_tpu_torch.wal.log import (
    _HEADER,
    _list_segments,
    _pad,
    _segment_name,
)

#: The injectable fault taxonomy (chaos draws ``storage_fault`` actions
#: with a ``fault`` arg from this tuple, mirroring DEVICE_FAULT_CLASSES).
STORAGE_FAULT_CLASSES = (
    "bit_flip",
    "torn_mid",
    "fsync_lie",
    "enospc",
    "eio_read",
    "slow_fsync",
)


class _FaultyAppendFile:
    """Write-side wrapper installed over the WAL's current segment file.

    Forwards to the real buffered writer unless the owning injector has a
    write-side fault armed.  ``fileno`` is the fsync seam: the log calls
    ``os.fsync(self._file.fileno())``, so raising here surfaces exactly
    where a real fsync failure would."""

    def __init__(self, real, injector: "StorageFaultInjector", path: str) -> None:
        self._real = real
        self._inj = injector
        self._path = path

    def write(self, data: bytes) -> int:
        inj = self._inj
        if inj._torn_armed:
            inj._torn_armed = False
            # Tear inside the frame: at least the header start, never the
            # full frame.  The partial bytes are made durable (that is the
            # point of a torn write), then the device goes read-only so the
            # tear stays the tail until scrub/quarantine or heal.
            tear = 1 + inj._rng.randrange(max(1, len(data) - 1))
            self._real.write(data[:tear])
            self._real.flush()
            os.fsync(self._real.fileno())
            inj._enospc_budget = 0
            inj._enospc_recorded = True  # hard-full: probes must not "heal" it
            inj._suspect = True
            inj._record("torn_mid", f"{os.path.basename(self._path)}+{tear}")
            raise OSError(errno.EIO, f"injected torn write ({tear} bytes landed)")
        budget = inj._enospc_budget
        if budget is not None:
            if budget < len(data):
                inj._record_enospc()
                raise OSError(errno.ENOSPC, "injected: no space left on device")
            inj._enospc_budget = budget - len(data)
        return self._real.write(data)

    def flush(self) -> None:
        # Once a write has been REFUSED the device is hard-full: flushes
        # fail too, so the WAL's degraded probe (flush + fsync, no payload)
        # cannot declare the disk healed while writes would still bounce —
        # without this the degraded gauge would flap once per append.
        # Before the first refusal flushes pass, so a budget that drains to
        # exactly zero still lands its final frame coherently.
        if self._inj._enospc_recorded:
            raise OSError(errno.ENOSPC, "injected: no space left on device")
        self._real.flush()

    def fileno(self) -> int:
        inj = self._inj
        if inj._slow_fsyncs > 0:
            inj._slow_fsyncs -= 1
            inj._record("slow_fsync", f"remaining={inj._slow_fsyncs}")
            raise OSError(errno.EIO, "injected fsync stall")
        return self._real.fileno()

    def tell(self) -> int:
        return self._real.tell()

    def close(self) -> None:
        if self._inj._current is self:
            self._inj._current = None
        self._real.close()

    @property
    def closed(self) -> bool:
        return self._real.closed


class _FaultyReadFile:
    """Read-side wrapper: raises EIO while the injector has reads armed."""

    def __init__(self, real, injector: "StorageFaultInjector") -> None:
        self._real = real
        self._inj = injector

    def read(self, *args):
        inj = self._inj
        if inj._eio_reads > 0:
            inj._eio_reads -= 1
            inj._record("eio_read", f"remaining={inj._eio_reads}")
            raise OSError(errno.EIO, "injected read failure")
        return self._real.read(*args)

    def close(self) -> None:
        self._real.close()

    def __enter__(self) -> "_FaultyReadFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class StorageFaultInjector:
    """Seeded fault layer for one node's file-backed WAL.

    :meth:`install` swaps the log's open seams and wraps its current
    segment file; faults are then armed one at a time with :meth:`arm` and
    fire deterministically from the injector's private RNG stream — a run
    with no injector (or no armed fault) consumes zero RNG and touches no
    seam, so fault-free schedules replay byte-identically.
    """

    def __init__(self, seed: int = 0) -> None:
        self._rng = random.Random(seed)
        self._wal = None
        self._current: Optional[_FaultyAppendFile] = None
        #: Faults that actually fired, in order: ``(kind, detail)``.
        self.fired: list[tuple[str, str]] = []
        self._torn_armed = False
        self._enospc_budget: Optional[int] = None
        self._enospc_recorded = False
        self._eio_reads = 0
        self._slow_fsyncs = 0
        #: path -> durable length at fsync-lie arm time; applied (truncated
        #: back) at the next simulated crash.
        self._lie_lengths: dict[str, int] = {}
        self._lie_armed = False
        #: The disk is known-damaged in a way the next boot cannot prove
        #: from local bytes alone (a lie truncation or an unsrubbed flip):
        #: the harness boots that incarnation fenced as a learner.
        self._suspect = False

    # --- wiring ------------------------------------------------------------

    def install(self, wal) -> None:
        """Attach to a live :class:`WriteAheadLog`: swap the open seams and
        wrap the current segment file.  Called at every node (re)start —
        a remount heals transient write-side arms (budget, tear, stalls),
        while :attr:`_suspect` survives until consumed by the boot fence."""
        self._wal = wal
        self._torn_armed = False
        self._enospc_budget = None
        self._enospc_recorded = False
        self._slow_fsyncs = 0
        self._lie_armed = False
        self._lie_lengths.clear()
        wal._open_for_append = self._open_append
        wal._open_for_read = self._open_read
        if wal._file is not None:
            path = os.path.join(wal._dir, _segment_name(wal._segment_index))
            wal._file = _FaultyAppendFile(wal._file, self, path)
            self._current = wal._file

    def _open_append(self, path: str, mode: str):
        f = _FaultyAppendFile(open(path, mode), self, path)
        if self._lie_armed:
            # A segment born under a lying fsync is entirely volatile.
            self._lie_lengths.setdefault(path, os.path.getsize(path))
        self._current = f
        return f

    def _open_read(self, path: str, mode: str):
        return _FaultyReadFile(open(path, mode), self)

    # --- arming ------------------------------------------------------------

    def arm(self, fault: str, *, budget: Optional[int] = None,
            count: int = 1) -> None:
        """Arm one fault.  ``budget`` (bytes) applies to ``enospc``;
        ``count`` to ``eio_read`` / ``slow_fsync``.  ``bit_flip`` fires
        immediately (it targets bytes already on disk)."""
        if fault not in STORAGE_FAULT_CLASSES:
            raise ValueError(
                f"unknown storage fault {fault!r}; "
                f"choose from {STORAGE_FAULT_CLASSES}"
            )
        if fault == "bit_flip":
            self._flip_bit()
        elif fault == "torn_mid":
            self._torn_armed = True
        elif fault == "fsync_lie":
            self._arm_lie()
        elif fault == "enospc":
            self._enospc_budget = int(budget) if budget is not None else 0
            self._enospc_recorded = False
        elif fault == "eio_read":
            self._eio_reads = max(1, int(count))
        elif fault == "slow_fsync":
            self._slow_fsyncs = max(1, int(count))

    def heal(self) -> None:
        """The disk recovers: every pending write/read-side arm clears.
        The suspect latch deliberately SURVIVES healing — damage already
        done (a lie truncation, an unscrubbed flip) is not undone by space
        returning, so only the boot fence (:meth:`consume_suspect_fence`)
        consumes it."""
        self._torn_armed = False
        self._enospc_budget = None
        self._enospc_recorded = False
        self._eio_reads = 0
        self._slow_fsyncs = 0
        self._lie_armed = False
        self._lie_lengths.clear()

    @property
    def pending(self) -> int:
        """Armed faults that have not fired/cleared yet."""
        return (
            int(self._torn_armed)
            + int(self._enospc_budget is not None)
            + int(self._lie_armed)
            + self._eio_reads
            + self._slow_fsyncs
        )

    # --- the fault bodies ---------------------------------------------------

    def _record(self, kind: str, detail: str) -> None:
        self.fired.append((kind, detail))

    def _record_enospc(self) -> None:
        # One fault instance however many writes it refuses.
        if not self._enospc_recorded:
            self._enospc_recorded = True
            self._record("enospc", f"budget={self._enospc_budget}")

    def _arm_lie(self) -> None:
        self._lie_armed = True
        wal = self._wal
        if wal is None or wal._file is None:
            return
        # Record the truly-durable length: flush the buffered writer so
        # tell()/getsize agree, then pin the current byte count.  Everything
        # past it is what the lying disk will drop at crash time.
        try:
            wal._file.flush()
        except OSError:
            pass
        path = os.path.join(wal._dir, _segment_name(wal._segment_index))
        if os.path.exists(path):
            self._lie_lengths[path] = os.path.getsize(path)

    def on_crash(self) -> None:
        """Apply the fsync lie at simulated process death: truncate every
        tracked file back to its arm-time durable length.  Called by the
        harness AFTER the node's file handles are abandoned."""
        if not self._lie_lengths:
            return
        dropped = 0
        for path, length in sorted(self._lie_lengths.items()):
            if not os.path.exists(path):
                continue
            size = os.path.getsize(path)
            if size <= length:
                continue
            with open(path, "r+b") as f:
                f.truncate(length)
                f.flush()
                os.fsync(f.fileno())
            dropped += size - length
        self._lie_lengths.clear()
        self._lie_armed = False
        if dropped:
            self._suspect = True
            self._record("fsync_lie", f"dropped={dropped}")

    def consume_suspect_fence(self) -> bool:
        """True exactly once after a locally-undetectable damage event (a
        lie truncation, or a flip the scrubber has not yet caught when the
        node reboots): the harness fences that incarnation as a learner."""
        suspect = self._suspect
        self._suspect = False
        return suspect

    def _flip_bit(self) -> None:
        """Flip one RNG-chosen bit of a committed record byte on disk.

        Only header+payload bytes are candidates — the zero padding between
        frames is not covered by the CRC chain, so a flip there would be
        legitimately undetectable (and the scrub test would hang waiting
        for a detection that can never come)."""
        wal = self._wal
        if wal is None:
            raise ValueError("injector not installed on a WAL")
        if wal._file is not None:
            try:
                wal._file.flush()
            except OSError:
                pass
        candidates: list[tuple[str, int]] = []
        for _, name in _list_segments(wal._dir):
            path = os.path.join(wal._dir, name)
            with open(path, "rb") as f:
                buf = f.read()
            for start, end in self._frame_spans(buf):
                candidates.extend((path, off) for off in range(start, end))
        if not candidates:
            raise ValueError("no committed record bytes to flip")
        path, off = candidates[self._rng.randrange(len(candidates))]
        mask = 1 << self._rng.randrange(8)
        with open(path, "r+b") as f:
            f.seek(off)
            byte = f.read(1)[0]
            f.seek(off)
            f.write(bytes([byte ^ mask]))
            f.flush()
            os.fsync(f.fileno())
        self._suspect = True
        self._record(
            "bit_flip", f"{os.path.basename(path)}@{off} mask=0x{mask:02x}"
        )

    @staticmethod
    def _frame_spans(buf: bytes) -> list[tuple[int, int]]:
        """Frame extents (header start → payload end, excluding padding)
        walked WITHOUT CRC validation — the flip targets well-framed bytes
        whether or not an earlier flip already broke the chain."""
        spans = []
        off = 0
        while off + _HEADER.size <= len(buf):
            length = struct.unpack_from("<I", buf, off)[0]
            end = off + _HEADER.size + length
            if length < 2 or end + _pad(length) > len(buf):
                break
            spans.append((off, end))
            off = end + _pad(length)
        return spans


class FaultyDecisionStore:
    """EIO-on-read wrapper for a sync-plane DecisionStore: ``fail_reads``
    reads raise before delegation, modeling a replica whose ledger store
    (not its WAL) hits media errors mid-catch-up.  Unit-test convenience —
    the chaos vocabulary targets the WAL seams."""

    def __init__(self, inner) -> None:
        self._inner = inner
        self.fail_reads = 0
        self.fired = 0

    def height(self) -> int:
        return self._inner.height()

    def read(self, from_seq: int, to_seq: int):
        if self.fail_reads > 0:
            self.fail_reads -= 1
            self.fired += 1
            raise OSError(errno.EIO, "injected decision-store read failure")
        return self._inner.read(from_seq, to_seq)

    def append(self, decision) -> None:
        self._inner.append(decision)

    def last(self):
        return self._inner.last()


__all__ = [
    "STORAGE_FAULT_CLASSES",
    "StorageFaultInjector",
    "FaultyDecisionStore",
]
