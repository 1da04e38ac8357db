"""Segmented CRC-chained write-ahead log (crash recovery substrate).

Parity: reference pkg/wal/.  The scrub/quarantine/degraded self-healing
layer (wal/scrub.py, WALRecovery, quarantine) is a consensus_tpu addition.

The PyTorch port's copy of ``consensus_tpu/wal/__init__.py``, its imports renamed.
"""

from consensus_tpu_torch.wal.log import (
    DEFAULT_FSYNC_RETRY_CAP,
    DEFAULT_SEGMENT_MAX_BYTES,
    QUARANTINE_DIRNAME,
    CorruptLogError,
    WALError,
    WALRecovery,
    WriteAheadLog,
    initialize_and_read_all,
    quarantine,
    repair,
)
from consensus_tpu_torch.wal.scrub import DEFAULT_SCRUB_INTERVAL, WalScrubber

__all__ = [
    "WriteAheadLog",
    "WALError",
    "CorruptLogError",
    "WALRecovery",
    "WalScrubber",
    "repair",
    "quarantine",
    "initialize_and_read_all",
    "DEFAULT_SEGMENT_MAX_BYTES",
    "DEFAULT_FSYNC_RETRY_CAP",
    "DEFAULT_SCRUB_INTERVAL",
    "QUARANTINE_DIRNAME",
]
