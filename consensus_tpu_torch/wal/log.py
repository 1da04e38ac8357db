"""Segmented, CRC-chained, fsync-on-append write-ahead log.

Parity: reference pkg/wal/writeaheadlog.go:60-810 — same guarantees, fresh
layout:

* **Append durability** — every ``append`` writes one framed record and
  fsyncs before returning (the protocol persists *before* broadcasting, so a
  crashed replica can never have said something it doesn't remember).
* **Chained CRC** — each record's checksum covers its payload *and* the
  previous record's checksum, so silent mid-stream corruption or record
  reordering breaks the chain (reference chains CRC32-Castagnoli the same
  way; stdlib CRC-32 here — the polynomial is an implementation detail).
* **Segmented files** — the log rolls to a new segment at
  ``segment_max_bytes``; each segment opens with an anchor record carrying
  the running CRC so any segment is independently readable
  (reference CRC_ANCHOR, pkg/wal/logrecord.proto).
* **Truncation** — ``append(..., truncate_to=True)`` marks the record as a
  stable restore point: all *older segments* are deleted (the current one is
  kept), bounding disk use (reference writeaheadlog.go:661-708).
* **Repair** — a torn tail (crash mid-write) is detected by ``read_all`` and
  chopped off by ``repair``, which truncates after the last intact record
  (reference writeaheadlog.go:293-337).

Record frame (all integers little-endian):

    u32 payload_length | u32 crc | payload | zero padding to 8-byte multiple

Payload = 1 type byte (ENTRY / ANCHOR) + 1 flag byte (truncate_to) + data.

The PyTorch port's copy of ``consensus_tpu/wal/log.py``, its imports renamed.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
import struct
import zlib
from typing import Optional

logger = logging.getLogger("consensus_tpu_torch.wal")

_HEADER = struct.Struct("<II")
_TYPE_ENTRY = 0x01
_TYPE_ANCHOR = 0x02
_FLAG_TRUNCATE_TO = 0x01

_SEGMENT_RE = re.compile(r"^(\d{16})\.wal$")

DEFAULT_SEGMENT_MAX_BYTES = 64 * 1024 * 1024
_INITIAL_CRC = 0

#: Consecutive group-commit fsync failures tolerated before the log moves
#: into degraded mode (appends refused, waiters still drain on the retry
#: timer).  Persist-before-broadcast is unsatisfiable while the disk won't
#: fsync, so looping silently forever would let the protocol queue unbounded
#: unpersisted work.
DEFAULT_FSYNC_RETRY_CAP = 5

#: Subdirectory corrupt segment suffixes are renamed into.  Nothing under it
#: is ever read back or deleted by this module — the bytes are preserved for
#: operator forensics while the replica rebuilds through verified sync.
QUARANTINE_DIRNAME = "quarantine"


class WALError(Exception):
    """Base class for WAL failures."""


class CorruptLogError(WALError):
    """The log fails CRC/framing validation.

    ``segment`` / ``offset`` locate the first bad byte so ``repair`` can
    truncate there; ``entries`` holds everything intact before the fault.
    """

    def __init__(self, msg: str, *, segment: str, offset: int, entries: list[bytes]):
        super().__init__(f"{msg} (segment={segment!r}, offset={offset})")
        self.segment = segment
        self.offset = offset
        self.entries = entries


@dataclasses.dataclass(frozen=True)
class WALRecovery:
    """What corruption recovery salvaged and set aside.

    Attached to ``WriteAheadLog.recovery`` by the quarantine paths so the
    embedding node can decide whether it must fence itself as a non-voting
    learner (it lost durable records it may have acted on) before rejoining
    the vote."""

    #: Quarantine-relative names of the files renamed aside (never deleted).
    quarantined: tuple[str, ...]
    #: Entry records recovered from the intact prefix.
    intact_entries: int
    #: The CorruptLogError (or read failure) that triggered recovery.
    reason: str


def _pad(n: int) -> int:
    return (8 - n % 8) % 8


def _segment_name(index: int) -> str:
    return f"{index:016d}.wal"


def _list_segments(directory: str) -> list[tuple[int, str]]:
    out = []
    for name in os.listdir(directory):
        m = _SEGMENT_RE.match(name)
        if m:
            out.append((int(m.group(1)), name))
    out.sort()
    return out


def _fsync_dir(directory: str) -> None:
    fd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class WriteAheadLog:
    """Append-only log over a directory of segment files.

    Use :func:`create` for a fresh directory, :func:`open_` for an existing
    one, or :func:`initialize_and_read_all` for the boot-time "create or
    open+repair+read" flow (reference pkg/wal/writeaheadlog.go:754-810).
    """

    def __init__(
        self,
        directory: str,
        *,
        segment_max_bytes: int = DEFAULT_SEGMENT_MAX_BYTES,
        sync: bool = True,
        group_commit_window: float = 0.0,
        scheduler=None,
        metrics=None,
        fault_plan=None,
    ) -> None:
        """``group_commit_window`` > 0 (requires a ``scheduler``) batches
        fsyncs: appends write immediately but durability callbacks are
        deferred until one fsync covers every append in the window —
        amortizing the reference's 2-fsyncs-per-decision critical path
        (reference internal/bft/view.go:412,508) across concurrent
        decisions.  In group mode, callers that need the persist-before-
        broadcast invariant MUST pass ``on_durable`` and defer their send
        until it fires."""
        if group_commit_window > 0 and scheduler is None:
            raise ValueError("group_commit_window requires a scheduler")
        if group_commit_window > 0 and not sync:
            raise ValueError("group_commit_window is meaningless with sync=False")
        #: Optional MetricsWAL bundle; gauge parity: reference
        #: pkg/wal/metrics.go:8-15 (wal_count_of_files).
        self._metrics = metrics
        #: Optional testing FaultPlan (consensus_tpu/testing/faults.py).  The
        #: seams below are a single ``is None`` check when unarmed — no lock,
        #: no extra flush/fsync on the hot path.
        self.fault_plan = fault_plan
        self._dir = directory
        self._segment_max_bytes = segment_max_bytes
        self._sync = sync
        self._group_window = group_commit_window
        self._scheduler = scheduler
        self._sync_pending = False
        self._sync_timer = None
        self._sync_waiters: list = []
        self._file: Optional[object] = None  # io.BufferedWriter
        self._segment_index = 0
        self._crc = _INITIAL_CRC
        self._closed = False
        #: Data-file fsyncs issued (per-append, group flush, segment roll) —
        #: the denominator of the group-commit coalescing ratio, and what
        #: the pipelining regression guard counts per decision.
        self.fsync_count = 0
        #: Entry records written since the last data fsync (the numerator).
        self._records_since_fsync = 0
        #: Optional MetricsConsensus bundle for the coalescing-ratio gauge.
        self._consensus_metrics = None
        #: Optional decision-lifecycle tracer (trace.Tracer); None when off.
        self._tracer = None
        #: Entries found by :func:`open_`'s validation scan (None for a
        #: freshly created log) — lets boot avoid a second full-disk read.
        self.entries_at_open: Optional[list[bytes]] = None
        #: Whether the append path is currently refusing work (ENOSPC, or
        #: the group-commit fsync-retry cap was hit).  Degraded is a MODE,
        #: not an error: reads and segment scans keep working, and the log
        #: auto-recovers the moment an append or probe fsync succeeds.
        self.degraded = False
        #: Human-readable reason for the current degraded episode.
        self.degraded_reason: Optional[str] = None
        #: Callbacks ``fn(degraded: bool)`` fired on every degraded-mode
        #: transition — the controller fences proposing/voting off this.
        self.degrade_hooks: list = []
        #: Set by the quarantine paths; non-None means durable records were
        #: set aside and the embedding replica may have amnesia.
        self.recovery: Optional[WALRecovery] = None
        self._recovery_booked = False
        self._fsync_failures = 0
        self._fsync_retry_cap = DEFAULT_FSYNC_RETRY_CAP
        self._degraded_probe_timer = None
        #: Injectable file-open seams — testing/storage.py swaps these for
        #: fault-wrapped opens; production code never touches them.
        self._open_for_append = open
        self._open_for_read = open

    def attach_consensus_metrics(self, metrics) -> None:
        """Publish the group-commit coalescing ratio
        (``consensus_wal_records_per_fsync``) into a MetricsConsensus
        bundle on every data fsync."""
        self._consensus_metrics = metrics

    def attach_tracer(self, tracer) -> None:
        """Emit ``wal.append``/``wal.fsync`` instants into a decision
        tracer; the fsync instant carries the same records-per-fsync value
        the ``consensus_wal_records_per_fsync`` gauge publishes."""
        self._tracer = tracer

    def _count_fsync(self) -> None:
        self.fsync_count += 1
        if self._consensus_metrics is not None and self._records_since_fsync:
            self._consensus_metrics.wal_records_per_fsync.set(
                self._records_since_fsync
            )
        if self._tracer is not None and self._tracer.enabled:
            self._tracer.instant(
                "wal", "wal.fsync", records=self._records_since_fsync
            )
        self._records_since_fsync = 0

    # --- construction ------------------------------------------------------

    @classmethod
    def create(cls, directory: str, **kw) -> "WriteAheadLog":
        """Create a brand-new log; the directory must be empty or absent.

        Parity: reference pkg/wal/writeaheadlog.go:125-205.
        """
        os.makedirs(directory, exist_ok=True)
        if _list_segments(directory):
            raise WALError(f"directory {directory!r} already contains a WAL")
        wal = cls(directory, **kw)
        wal._start_segment(1)
        return wal

    @classmethod
    def open_(cls, directory: str, repair: bool = False, **kw) -> "WriteAheadLog":
        """Open an existing log for appending after the last intact record.

        ``repair`` makes the open-time contract explicit: ``False`` (the
        default) raises :class:`CorruptLogError` on a torn tail so the
        caller decides; ``True`` runs :func:`repair` and retries — tail
        tears only, non-tail corruption still raises (see
        :func:`initialize_and_read_all` for the quarantine flow).  Parity:
        reference writeaheadlog.go:207-291.
        """
        segments = _list_segments(directory)
        if not segments:
            raise WALError(f"no WAL in {directory!r}")
        wal = cls(directory, **kw)
        # Validate everything (raises CorruptLogError on damage) and leave
        # the chain CRC positioned after the final record.  The entries are
        # kept so boot (initialize_and_read_all) doesn't rescan the disk.
        try:
            wal.entries_at_open = wal._scan_all()
        except CorruptLogError:
            if not repair:
                raise
            _repair(directory)
            if not _list_segments(directory):
                raise WALError(
                    f"repair removed the only segment in {directory!r}"
                )
            return cls.open_(directory, repair=False, **kw)
        last_index, last_name = segments[-1]
        path = os.path.join(directory, last_name)
        wal._file = wal._open_for_append(path, "ab")
        wal._segment_index = last_index
        wal._update_file_count()
        return wal

    def close(self) -> None:
        if self._degraded_probe_timer is not None:
            self._degraded_probe_timer.cancel()
            self._degraded_probe_timer = None
        if self._sync_timer is not None:
            self._sync_timer.cancel()
            self._sync_timer = None
        if self._sync_waiters or self._sync_pending:
            if not self.flush_group():
                # flush_group re-armed a retry; a post-close retry firing
                # protocol callbacks would be worse than failing loudly.
                if self._sync_timer is not None:
                    self._sync_timer.cancel()
                    self._sync_timer = None
                raise WALError(
                    "close: pending records could not be made durable"
                )
        if self._file is not None:
            self._file.flush()
            self._file.close()
            self._file = None
        self._closed = True

    def abandon(self) -> None:
        """Simulated process death: drop the file handle WITHOUT flushing
        pending group-commit state or firing durability callbacks.  Unlike
        :meth:`close`, records whose fsync had not yet happened are simply
        lost — which is exactly what a crash does.  Used by the crash-matrix
        harness; production shutdown should keep using ``close``."""
        if self._degraded_probe_timer is not None:
            self._degraded_probe_timer.cancel()
            self._degraded_probe_timer = None
        if self._sync_timer is not None:
            self._sync_timer.cancel()
            self._sync_timer = None
        self._sync_waiters = []
        self._sync_pending = False
        if self._file is not None:
            try:
                self._file.close()
            except OSError:
                pass
            self._file = None
        self._closed = True

    # --- appending ---------------------------------------------------------

    def append(
        self, data: bytes, truncate_to: bool = False, on_durable=None
    ) -> None:
        """Durably append one record; returns after fsync (default mode).

        With group commit configured, the write lands immediately but the
        fsync is deferred to the window; ``on_durable()`` fires once the
        record is actually on stable storage.

        ``truncate_to=True`` marks a stable restore point and deletes all
        older segments.  Parity: reference writeaheadlog.go:403-497.
        """
        if self._closed or self._file is None:
            raise WALError("log is closed")
        if on_durable is not None and not self._sync:
            raise WALError("on_durable requires a sync-enabled log")
        plan = self.fault_plan
        if plan is not None:
            plan.crash("wal.append.pre_write")
        if self._tracer is not None and self._tracer.enabled:
            self._tracer.instant(
                "wal", "wal.append", bytes=len(data), truncate=truncate_to
            )
        flags = _FLAG_TRUNCATE_TO if truncate_to else 0
        try:
            self._write_record(_TYPE_ENTRY, flags, data)
        except OSError as err:
            # ENOSPC/EIO on the write or fsync: persist-before-broadcast is
            # unsatisfiable, so the log degrades (the controller's degrade
            # hook stops proposing/voting) instead of letting the replica
            # keep acting on records that never reached stable storage.
            self._enter_degraded(f"append failed: {err}")
            raise WALError(f"append failed: {err}") from err
        if self.degraded and not self._group_window:
            # The write (and, in sync mode, its fsync) succeeded: the disk
            # recovered, so the degraded episode is over.
            self._exit_degraded()
        if on_durable is not None and self._group_window:
            # Queue BEFORE any eager flush below, so a truncate-triggered
            # flush covers this record's callback too.
            self._sync_waiters.append(on_durable)
        if truncate_to:
            if self._group_window:
                # The restore point must be durable BEFORE the history it
                # replaces is deleted, or a crash in the window loses both.
                # On fsync failure the deletion rides the retry queue — with
                # the segment index captured NOW: by retry time a rollover
                # may have bumped it, and deleting against the new index
                # would destroy the segment holding the restore point.
                if self.flush_group():
                    self._drop_old_segments()
                else:
                    keep = self._segment_index
                    self._sync_waiters.append(
                        lambda: self._drop_segments_below(keep)
                    )
            else:
                self._drop_old_segments()
        if self._file.tell() >= self._segment_max_bytes:
            if plan is not None:
                plan.crash("wal.segment.roll")
            self._start_segment(self._segment_index + 1)
        if on_durable is not None and not self._group_window:
            on_durable()  # already fsynced synchronously

    def flush_group(self) -> bool:
        """Fsync now and complete every deferred durability callback;
        returns whether durability was actually achieved.

        An fsync failure (ENOSPC/EIO) keeps the waiters queued and retries
        after another window — records must never be reported durable when
        they are not, and the error must not strand the queue silently."""
        if self._sync_timer is not None:
            self._sync_timer.cancel()
            self._sync_timer = None
        if self._file is None:
            # Closed (or never opened) with work still queued: durability is
            # unachievable — never fire the callbacks as if it happened.
            return not self._sync_waiters
        if self._sync:
            try:
                self._file.flush()
                os.fsync(self._file.fileno())
                self._count_fsync()
            except OSError:
                self._fsync_failures += 1
                if self._metrics is not None:
                    self._metrics.fsync_retries.add(1)
                if self._tracer is not None and self._tracer.enabled:
                    self._tracer.instant(
                        "wal", "wal.fsync.retry",
                        consecutive=self._fsync_failures,
                    )
                logger.exception(
                    "WAL group fsync failed (%d consecutive); retrying in %.3fs",
                    self._fsync_failures,
                    self._group_window or 0.05,
                )
                if self._fsync_failures >= self._fsync_retry_cap:
                    # Capped: stop pretending this is transient.  The retry
                    # timer keeps running so queued waiters still drain the
                    # moment the disk heals, but the replica must stop
                    # generating new unpersistable work NOW.
                    self._enter_degraded(
                        f"fsync retry cap ({self._fsync_retry_cap}) hit"
                    )
                if self._scheduler is not None:
                    self._sync_pending = True
                    self._sync_timer = self._scheduler.call_later(
                        self._group_window or 0.05,
                        self.flush_group,
                        name="wal-group-commit-retry",
                    )
                    return False
                raise
            self._fsync_failures = 0
            if self.degraded:
                self._exit_degraded()
        self._sync_pending = False
        waiters, self._sync_waiters = self._sync_waiters, []
        for waiter in waiters:
            try:
                waiter()
            except Exception:
                logger.exception("on_durable callback failed; continuing with the rest")
        return True

    def _write_record(self, rtype: int, flags: int, data: bytes) -> None:
        payload = bytes([rtype, flags]) + data
        prev_crc = self._crc
        self._crc = zlib.crc32(payload, self._crc) & 0xFFFFFFFF
        frame = _HEADER.pack(len(payload), self._crc) + payload + b"\x00" * _pad(
            len(payload)
        )
        plan = self.fault_plan
        if plan is not None and rtype == _TYPE_ENTRY:
            if plan.will_fire("wal.append.torn_write"):
                # Worst-case torn write: half the frame reaches stable
                # storage, then the process dies — repair() must chop it.
                self._file.write(frame[: max(_HEADER.size, len(frame) // 2)])
                self._file.flush()
                os.fsync(self._file.fileno())
            plan.crash("wal.append.torn_write")
        try:
            self._file.write(frame)
            self._file.flush()
        except OSError:
            # The frame did not (fully) reach the file: rewind the chain CRC
            # so a later successful append continues from the last record
            # that actually landed on disk.
            self._crc = prev_crc
            raise
        if rtype == _TYPE_ENTRY:
            self._records_since_fsync += 1
        if self._sync:
            if self._group_window:
                # Group commit: one fsync covers every append in the window
                # (constructor guarantees a scheduler exists).
                if not self._sync_pending:
                    self._sync_pending = True
                    self._sync_timer = self._scheduler.call_later(
                        self._group_window, self.flush_group, name="wal-group-commit"
                    )
            else:
                if plan is not None and rtype == _TYPE_ENTRY:
                    plan.crash("wal.fsync.pre")
                os.fsync(self._file.fileno())
                self._count_fsync()
                if plan is not None and rtype == _TYPE_ENTRY:
                    plan.crash("wal.fsync.post")

    # --- degraded mode & quarantine ---------------------------------------

    def _enter_degraded(self, reason: str) -> None:
        if self.degraded:
            return
        self.degraded = True
        self.degraded_reason = reason
        logger.warning("WAL degraded: %s (appends refused)", reason)
        if self._metrics is not None:
            self._metrics.degraded.set(1)
            self._metrics.degraded_transitions.add(1)
        if self._tracer is not None and self._tracer.enabled:
            self._tracer.instant("wal", "wal.degraded", reason=reason)
        for hook in list(self.degrade_hooks):
            try:
                hook(True)
            except Exception:
                logger.exception("WAL degrade hook failed; continuing")
        self._arm_degraded_probe()

    def _exit_degraded(self) -> None:
        if not self.degraded:
            return
        self.degraded = False
        self.degraded_reason = None
        self._fsync_failures = 0
        if self._degraded_probe_timer is not None:
            self._degraded_probe_timer.cancel()
            self._degraded_probe_timer = None
        logger.info("WAL recovered from degraded mode; appends resume")
        if self._metrics is not None:
            self._metrics.degraded.set(0)
        if self._tracer is not None and self._tracer.enabled:
            self._tracer.instant("wal", "wal.recovered")
        for hook in list(self.degrade_hooks):
            try:
                hook(False)
            except Exception:
                logger.exception("WAL degrade hook failed; continuing")

    def _arm_degraded_probe(self) -> None:
        # The group-commit retry timer already doubles as a recovery probe
        # (its success path exits degraded mode); only arm a dedicated probe
        # when no retry is in flight and a scheduler exists to clock it.
        if (
            self._scheduler is None
            or self._sync_timer is not None
            or self._degraded_probe_timer is not None
        ):
            return
        self._degraded_probe_timer = self._scheduler.call_later(
            max(self._group_window, 0.05),
            self._probe_degraded,
            name="wal-degraded-probe",
        )

    def _probe_degraded(self) -> None:
        self._degraded_probe_timer = None
        if not self.degraded or self._closed or self._file is None:
            return
        try:
            self._file.flush()
            if self._sync:
                os.fsync(self._file.fileno())
        except OSError:
            self._arm_degraded_probe()
            return
        self._exit_degraded()

    def quarantine_corrupt(self, err: CorruptLogError) -> WALRecovery:
        """Live-quarantine the corrupt suffix (scrub detection path): move
        the damaged segment's suffix and every later segment into the
        quarantine directory, then reopen positioned after the last intact
        record.  Pending group-commit durability callbacks are DROPPED —
        records in the lost suffix can never be reported durable, and the
        embedding replica is expected to fence itself and rebuild through
        verified sync (see ``recovery``)."""
        if self._sync_timer is not None:
            self._sync_timer.cancel()
            self._sync_timer = None
        self._sync_pending = False
        self._sync_waiters = []
        if self._file is not None:
            try:
                self._file.close()
            except OSError:
                pass
            self._file = None
        moved = quarantine(self._dir, err)
        segments = _list_segments(self._dir)
        if not segments:
            self._crc = _INITIAL_CRC
            entries: list[bytes] = []
            self._start_segment(1)
        else:
            entries = self._scan_all()  # repositions the chain CRC
            last_index, last_name = segments[-1]
            self._file = self._open_for_append(
                os.path.join(self._dir, last_name), "ab"
            )
            self._segment_index = last_index
        self._update_file_count()
        self.recovery = WALRecovery(
            quarantined=tuple(moved),
            intact_entries=len(entries),
            reason=str(err),
        )
        self._book_recovery()
        return self.recovery

    def _book_recovery(self) -> None:
        """Book the quarantine exactly once, whenever metrics are ready
        (boot-path quarantines happen before attach_metrics)."""
        if self.recovery is None or self._recovery_booked:
            return
        if self._metrics is None:
            return
        self._recovery_booked = True
        self._metrics.quarantines.add(1)
        self._metrics.scrub_corruptions.add(1)
        if self._tracer is not None and self._tracer.enabled:
            self._tracer.instant(
                "wal", "wal.quarantine",
                files=len(self.recovery.quarantined),
                intact=self.recovery.intact_entries,
            )

    def attach_metrics(self, metrics) -> None:
        """Attach a MetricsWAL bundle after construction (the facade calls
        this: the embedder builds the WAL before the metrics provider is
        known) and publish the current file count."""
        self._metrics = metrics
        self._update_file_count()
        if self.degraded:
            metrics.degraded.set(1)
        self._book_recovery()

    def _update_file_count(self) -> None:
        if self._metrics is not None:
            self._metrics.count_of_files.set(len(_list_segments(self._dir)))

    def _start_segment(self, index: int) -> None:
        if self._file is not None:
            self._file.flush()
            if self._sync:
                os.fsync(self._file.fileno())
                self._count_fsync()
            self._file.close()
        path = os.path.join(self._dir, _segment_name(index))
        self._file = self._open_for_append(path, "ab")
        self._segment_index = index
        # Anchor: carries the running chain CRC so this segment can be
        # validated without its predecessors.
        anchor_data = struct.pack("<I", self._crc)
        self._write_record(_TYPE_ANCHOR, 0, anchor_data)
        if self._sync:
            _fsync_dir(self._dir)
        self._update_file_count()

    def _drop_old_segments(self) -> None:
        self._drop_segments_below(self._segment_index)

    def _drop_segments_below(self, keep_index: int) -> None:
        for index, name in _list_segments(self._dir):
            if index < keep_index:
                os.unlink(os.path.join(self._dir, name))
        if self._sync:
            _fsync_dir(self._dir)
        self._update_file_count()

    # --- reading -----------------------------------------------------------

    def read_all(self) -> list[bytes]:
        """All intact entry payloads, oldest first.

        Raises :class:`CorruptLogError` on a broken chain or torn tail.
        Parity: reference writeaheadlog.go:510-602.
        """
        return self._scan_all()

    def _scan_all(self) -> list[bytes]:
        entries: list[bytes] = []
        crc = _INITIAL_CRC
        first = True
        for _, name in _list_segments(self._dir):
            path = os.path.join(self._dir, name)
            with self._open_for_read(path, "rb") as f:
                buf = f.read()
            crc, first = self._scan_segment(name, buf, crc, first, entries)
        self._crc = crc
        return entries

    def _scan_segment(
        self,
        name: str,
        buf: bytes,
        crc: int,
        first_segment: bool,
        entries: list[bytes],
    ) -> tuple[int, bool]:
        off = 0
        first_record = True
        while off < len(buf):
            if off + _HEADER.size > len(buf):
                raise CorruptLogError(
                    "torn frame header", segment=name, offset=off, entries=entries
                )
            length, want_crc = _HEADER.unpack_from(buf, off)
            body_start = off + _HEADER.size
            body_end = body_start + length
            if length < 2 or body_end + _pad(length) > len(buf):
                raise CorruptLogError(
                    "torn frame payload", segment=name, offset=off, entries=entries
                )
            payload = buf[body_start:body_end]
            rtype, flags = payload[0], payload[1]
            if first_record:
                # Every segment must open with an anchor matching the chain.
                if rtype != _TYPE_ANCHOR or len(payload) < 6:
                    raise CorruptLogError(
                        "segment missing anchor", segment=name, offset=off, entries=entries
                    )
                anchor_crc = struct.unpack("<I", payload[2:6])[0]
                if not first_segment and anchor_crc != crc:
                    raise CorruptLogError(
                        "anchor breaks CRC chain", segment=name, offset=off, entries=entries
                    )
                crc = anchor_crc  # trust the anchor when this is the oldest kept segment
                first_record = False
            got = zlib.crc32(payload, crc) & 0xFFFFFFFF
            if got != want_crc:
                raise CorruptLogError(
                    "CRC mismatch", segment=name, offset=off, entries=entries
                )
            crc = got
            if rtype == _TYPE_ENTRY:
                if flags & _FLAG_TRUNCATE_TO:
                    # A stable restore point retires everything before it,
                    # including earlier records in this same segment (older
                    # segments were already deleted at append time).
                    # Parity: reference pkg/wal/writeaheadlog.go:549-551.
                    entries.clear()
                entries.append(payload[2:])
            elif rtype != _TYPE_ANCHOR:
                raise CorruptLogError(
                    f"unknown record type {rtype}", segment=name, offset=off, entries=entries
                )
            off = body_end + _pad(length)
        if first_record:
            raise CorruptLogError(
                "empty segment", segment=name, offset=0, entries=entries
            )
        return crc, False


def repair(directory: str) -> None:
    """Chop a torn tail: truncate the damaged segment after its last intact
    record (taking a ``.bak`` copy first).

    Only the *last* segment can legitimately be torn (a crash mid-append);
    corruption in an earlier, fully-fsynced segment means durable records
    were damaged at rest — silently discarding them would make the replica
    forget messages it already broadcast, so that case raises for operator
    intervention instead.  Parity: reference pkg/wal/writeaheadlog.go:293-337
    (verifies all-but-last, truncates only the last file).
    """
    probe = WriteAheadLog(directory)
    try:
        probe._scan_all()
        return  # nothing to repair
    except CorruptLogError as err:
        bad_segment, offset = err.segment, err.offset

    segments = _list_segments(directory)
    if segments and bad_segment != segments[-1][1]:
        raise WALError(
            f"corruption in non-tail segment {bad_segment!r}: durable records "
            "are damaged; refusing to auto-repair"
        )
    path = os.path.join(directory, bad_segment)
    backup = path + ".bak"
    with open(path, "rb") as src, open(backup, "wb") as dst:
        dst.write(src.read())
        dst.flush()
        os.fsync(dst.fileno())
    if offset == 0:
        # Nothing salvageable in this segment: remove it entirely.
        os.unlink(path)
    else:
        with open(path, "r+b") as f:
            f.truncate(offset)
            f.flush()
            os.fsync(f.fileno())
    _fsync_dir(directory)


# open_(repair=...) shadows the module function with its parameter name;
# this alias keeps the call reachable from inside the class.
_repair = repair


def quarantine(directory: str, err: CorruptLogError) -> list[str]:
    """Set aside the corrupt suffix, preserving the intact prefix.

    The damaged segment (from the corruption offset) and every later
    segment are RENAMED into ``quarantine/`` — never deleted: the replica
    may have broadcast votes recorded in those bytes, so they stay on disk
    for operator forensics while the node rebuilds through verified sync.
    When the corruption sits mid-segment, the segment's intact prefix (a
    whole number of records, ending just before ``err.offset``) is written
    back so those entries survive.  Returns the quarantined file names.
    """
    qdir = os.path.join(directory, QUARANTINE_DIRNAME)
    os.makedirs(qdir, exist_ok=True)
    bad_index = None
    for index, name in _list_segments(directory):
        if name == err.segment:
            bad_index = index
            break
    if bad_index is None:
        raise WALError(
            f"quarantine: segment {err.segment!r} not found in {directory!r}"
        )
    moved: list[str] = []
    for index, name in _list_segments(directory):
        if index < bad_index:
            continue
        src = os.path.join(directory, name)
        prefix = None
        if name == err.segment and err.offset > 0:
            with open(src, "rb") as f:
                prefix = f.read(err.offset)
        dst = os.path.join(qdir, name)
        bump = 0
        while os.path.exists(dst):
            bump += 1
            dst = os.path.join(qdir, f"{name}.{bump}")
        os.replace(src, dst)
        moved.append(os.path.basename(dst))
        if prefix is not None:
            with open(src, "wb") as f:
                f.write(prefix)
                f.flush()
                os.fsync(f.fileno())
    _fsync_dir(qdir)
    _fsync_dir(directory)
    return moved


def initialize_and_read_all(
    directory: str, quarantine_corrupt: bool = False, **kw
) -> tuple[WriteAheadLog, list[bytes]]:
    """Boot-time flow: create a fresh log, or open an existing one (repairing
    a torn tail if needed) and return its entries.

    ``quarantine_corrupt`` enables the amnesia-safe path: corruption beyond
    the tail (which :func:`repair` refuses — durable records were damaged
    at rest) no longer kills the boot.  The corrupt suffix is quarantined,
    the log reopens from the intact prefix, and ``wal.recovery`` carries
    what was lost so the embedding replica fences itself as a non-voting
    learner until verified sync passes a checkpoint above the intact
    prefix.  Parity: reference pkg/wal/writeaheadlog.go:754-810 (original
    repair-only flow).
    """
    os.makedirs(directory, exist_ok=True)
    if not _list_segments(directory):
        return WriteAheadLog.create(directory, **kw), []
    try:
        wal = WriteAheadLog.open_(directory, **kw)
    except CorruptLogError as err:
        try:
            repair(directory)
        except WALError:
            if not quarantine_corrupt:
                raise
            moved = quarantine(directory, err)
            if not _list_segments(directory):
                wal = WriteAheadLog.create(directory, **kw)
                entries: list[bytes] = []
            else:
                wal = WriteAheadLog.open_(directory, **kw)
                entries = (
                    wal.entries_at_open
                    if wal.entries_at_open is not None else []
                )
            wal.recovery = WALRecovery(
                quarantined=tuple(moved),
                intact_entries=len(entries),
                reason=str(err),
            )
            return wal, entries
        if not _list_segments(directory):
            # The only segment was damaged beyond its anchor: start fresh.
            return WriteAheadLog.create(directory, **kw), []
        wal = WriteAheadLog.open_(directory, **kw)
    return wal, wal.entries_at_open if wal.entries_at_open is not None else []


__all__ = [
    "WriteAheadLog",
    "WALError",
    "CorruptLogError",
    "WALRecovery",
    "repair",
    "quarantine",
    "initialize_and_read_all",
    "DEFAULT_SEGMENT_MAX_BYTES",
    "DEFAULT_FSYNC_RETRY_CAP",
    "QUARANTINE_DIRNAME",
]
