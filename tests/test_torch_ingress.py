"""The JAX package's ingress-plane tests (``tests/test_ingress.py``) on the
port's ``ingress/``, its imports renamed (``torch_mirror``): token buckets,
the dedup cache, admission, rendezvous placement, seed-pure traces, the
open-loop driver and its detectors, the real sidecar fleet's reroute over
sockets, and the WAN chaos arm.  The driver's summaries are held byte for
byte against the JAX package's in ``test_torch_net_parity.py``.
"""

from torch_mirror import mirror

_SCRIPT = ("runs a script of scripts/, which drives the JAX package; scripts "
           "are not modules of the package (ROADMAP.md queue A)")
mirror("test_ingress", globals(), drop={
    "test_ingress_sweep_emits_per_seed_and_summary_json": _SCRIPT,
    "test_chaos_sweep_accepts_wan_profile": _SCRIPT,
})
