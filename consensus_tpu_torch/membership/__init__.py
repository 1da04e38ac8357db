"""Membership-epoch subsystem: elastic add/remove-node as an ordered,
quorum-certified decision with a first-class lifecycle.

See epoch.py for the epoch arithmetic (which committee certifies which
sequence) and bootstrap.py for the joining-node catch-up driver.

The PyTorch port's copy of ``consensus_tpu/membership/__init__.py``, its imports renamed.
"""

from consensus_tpu_torch.membership.bootstrap import JoinBootstrap
from consensus_tpu_torch.membership.epoch import (
    MembershipChange,
    MembershipConfig,
    MembershipDirectory,
)

__all__ = [
    "JoinBootstrap",
    "MembershipChange",
    "MembershipConfig",
    "MembershipDirectory",
]
