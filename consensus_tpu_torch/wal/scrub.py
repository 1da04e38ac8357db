"""Background WAL scrubber: re-walk the CRC chain, catch bit-rot early.

Appends verify their own frames, but bytes already on disk are only
re-read at restart — a flipped bit in a committed region can therefore sit
latent for the whole life of a process and only surface (fatally, pre-PR)
at the next boot.  The scrubber closes that window: on a scheduler-clocked
cadence it re-reads every segment through the log's (injectable) read seam
and re-verifies the full chain — anchors, CRCs, framing, segment
inventory — exactly the validation :func:`WriteAheadLog.read_all` runs at
open time.

Every pass books the pinned ``wal_scrub_runs_total`` /
``wal_scrub_records_total`` counters; a detection books
``wal_scrub_corruptions_total``, emits a ``wal.scrub.corruption`` trace
instant, and hands the :class:`CorruptLogError` to the ``on_corruption``
callback — the embedding node quarantines the suffix
(:meth:`WriteAheadLog.quarantine_corrupt`), snapshots a flight record, and
fences itself as a non-voting learner until verified sync carries it past
the damage (core/controller.py).  An unreadable segment (EIO) is treated
as corruption at offset 0 of that segment: the bytes may be fine, but a
replica that cannot read its own durable state must not keep voting on
the assumption that it can.

The scrubber holds no lock: the simulation scheduler is single-threaded
and every append flushes its full frame before returning, so a pass always
observes a record-aligned on-disk state.

The PyTorch port's copy of ``consensus_tpu/wal/scrub.py``, its imports renamed.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Optional

from .log import CorruptLogError, WriteAheadLog, _INITIAL_CRC, _list_segments

logger = logging.getLogger("consensus_tpu_torch.wal.scrub")

#: Default seconds (injected clock) between scrub passes.  Deliberately
#: long relative to protocol timescales — scrubbing is a bit-rot bound,
#: not a hot path.
DEFAULT_SCRUB_INTERVAL = 30.0


class WalScrubber:
    """Scheduler-clocked re-verification of a live :class:`WriteAheadLog`.

    ``on_corruption(err)`` is invoked at most once per detection with the
    triggering :class:`CorruptLogError`; the scrubber keeps running
    afterwards (the callback is expected to quarantine, leaving a clean
    log behind).
    """

    def __init__(
        self,
        wal: WriteAheadLog,
        scheduler,
        *,
        interval: float = DEFAULT_SCRUB_INTERVAL,
        metrics=None,
        tracer=None,
        on_corruption: Optional[Callable[[CorruptLogError], None]] = None,
    ) -> None:
        if interval <= 0:
            raise ValueError("scrub interval must be positive")
        self._wal = wal
        self._scheduler = scheduler
        self._interval = interval
        self._metrics = metrics
        self._tracer = tracer
        self._on_corruption = on_corruption
        self._timer = None
        self._stopped = False
        #: Passes completed (mirrors the pinned counter for tests that run
        #: without a metrics provider).
        self.runs = 0
        #: Corruptions detected over the scrubber's lifetime.
        self.corruptions = 0

    def start(self) -> None:
        self._stopped = False
        self._arm()

    def stop(self) -> None:
        self._stopped = True
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def _arm(self) -> None:
        if self._stopped or self._timer is not None:
            return
        self._timer = self._scheduler.call_later(
            self._interval, self._tick, name="wal-scrub"
        )

    def _tick(self) -> None:
        self._timer = None
        if self._stopped:
            return
        self.scrub_now()
        self._arm()

    def scrub_now(self) -> Optional[CorruptLogError]:
        """Run one full pass immediately; returns the detection, if any."""
        self.runs += 1
        if self._metrics is not None:
            self._metrics.scrub_runs.add(1)
        try:
            records = self._rewalk()
        except CorruptLogError as err:
            self.corruptions += 1
            if self._metrics is not None:
                self._metrics.scrub_corruptions.add(1)
            if self._tracer is not None and self._tracer.enabled:
                self._tracer.instant(
                    "wal", "wal.scrub.corruption",
                    segment=err.segment, offset=err.offset,
                )
            logger.warning("scrub detected corruption: %s", err)
            if self._on_corruption is not None:
                try:
                    self._on_corruption(err)
                except Exception:
                    logger.exception("on_corruption handler failed")
            return err
        if self._metrics is not None:
            self._metrics.scrub_records.add(records)
        if self._tracer is not None and self._tracer.enabled:
            self._tracer.instant("wal", "wal.scrub", records=records)
        return None

    def _rewalk(self) -> int:
        """Re-verify every segment through the log's read seam without
        touching the live log's chain state; returns intact entry count."""
        wal = self._wal
        directory = wal._dir
        entries: list[bytes] = []
        crc = _INITIAL_CRC
        first = True
        for _, name in _list_segments(directory):
            path = os.path.join(directory, name)
            try:
                with wal._open_for_read(path, "rb") as f:
                    buf = f.read()
            except OSError as err:
                raise CorruptLogError(
                    f"unreadable segment: {err}",
                    segment=name, offset=0, entries=entries,
                )
            # _scan_segment is stateless w.r.t. the instance; borrowing the
            # live log's keeps exactly one validation implementation.
            crc, first = wal._scan_segment(name, buf, crc, first, entries)
        return len(entries)


__all__ = ["WalScrubber", "DEFAULT_SCRUB_INTERVAL"]
