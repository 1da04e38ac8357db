"""Pure protocol math: quorum sizes, leader selection, blacklist maintenance,
vote bookkeeping, and deterministic digests.  No I/O, no clocks — everything
here is table-testable.

The PyTorch port's copy of ``consensus_tpu/utils/__init__.py``, its imports renamed.
"""

from consensus_tpu_torch.utils.quorum import compute_quorum  # noqa: F401
from consensus_tpu_torch.utils.leader import get_leader_id  # noqa: F401
from consensus_tpu_torch.utils.blacklist import (  # noqa: F401
    compute_blacklist_update,
    prune_blacklist,
)
from consensus_tpu_torch.utils.digests import commit_signatures_digest  # noqa: F401
