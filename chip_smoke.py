"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's three main paths through the engines a user would call,
then through the engine layer the JAX package launches them through (the
coalescer and the supervisor), then through the protocol core (a replica
cluster ordering blocks), then through the process seams (a sidecar serving
the card to tenants over sockets, and the cluster over TCP verifying
through it), then through the consensus groups' shared verifier fleet and
the process-per-replica deployment rig:

* strict Ed25519 batch verification at the size of one block of a
  7-replica (f=2) Ed25519 deployment with 1,000 requests per block
  (BASELINE.json config 3): one wave of 7,000 signatures, padded to 8,192
  lanes;
* ECDSA-P256 batch verification at the size of one block of a 4-replica
  (f=1) naive_chain deployment with 500 requests per proposal
  (BASELINE.json config 2, ECDSA-P256 as in config 1): one wave of 2,000
  signatures, padded to 2,048 lanes;
* randomized Ed25519 batch verification (``batch_verify_mode``) at config
  3's size: the same 7,000-signature block wave, checked in aggregate, and
  a sync catch-up chunk of 51 decisions' 5-vote quorums;
* the fused front end (``device_prep``: the SHA-512 challenges, the
  transcript and the scalars on the card, kernel S1) on the same waves, and
  half-aggregated quorum certificates (``cert_mode="half-agg"``).

Phases:

1. device and build: the card, torch and CUDA versions, the nvcc builds of
   every kernel from ``consensus_tpu_torch/csrc`` (started together) and
   their ``-Xptxas -v`` reports;
2. the Ed25519 kernel B1 against its plain torch version on the card at the
   main path's shape, with tolerance 0 (integer arithmetic), and its time
   beside the plain version's and its bound; then the same on the first 256
   columns (the width of a catch-up chunk on the strict path), and the
   registers, stack frame and spills ptxas reports for B1;
3. the Ed25519 path: the 7,000-signature wave with every rejection class
   mixed in, verdicts held against the construction and against the
   RFC 8032 reference, kernel launch counts read around the run (D1, B1
   and D2 once each), then a 2f+1 commit quorum through
   ``verify_consenter_sigs_batch``;
4. the P-256 kernel B2 against its plain torch version on the card on the
   phase-5 wave's own kernel inputs (real keys and u2 digits, off-curve keys
   and padded zero lanes included), tolerance 0, with its time, the plain
   version's and its bound;
5. the P-256 path: the 2,000-signature wave with every rejection class of
   the JAX engine mixed in, verdicts held against the construction and the
   pure-Python reference, launch counts read around the run, a profiled
   re-run's stage split, then a 2f+1 commit quorum through
   ``EcdsaP256VerifierMixin.verify_consenter_sigs_batch``;
6. the Straus MSM kernel B3 against its plain torch version on the card on
   the phase-7 wave's first aggregate (its transcript's digits, padded and
   undecodable lanes masked to digit 8), compared in affine coordinates with
   tolerance 0, with its time, each of its CUDA kernels' device time, the
   plain version's time and its bound; then the same on the aggregate's
   first 256 columns (the catch-up chunk's width), and the registers, stack
   frame and spills ptxas reports for B3's kernels;
7. the randomized path: the config-3 wave with the host-rejected and
   undecodable classes mixed in, through ``engine_for_config(
   Configuration(batch_verify_mode=True))``, verdicts held against the
   construction, the strict engine and the RFC 8032 reference, launch counts
   read around the run (B3, D1 and D2 twice: the aggregate, then the
   survivors' re-check), and a profiled re-run's stage split;
8. a sync catch-up chunk: 51 decisions' 5-vote quorums (255 votes, 3 of
   them forged) through ``verify_consenter_sigs_multi_batch`` on the
   randomized engine, the forged votes localized by bisection, and B3's
   launches equal to the bisection nodes of at least
   ``crypto_tpu_min_batch`` votes counted on the host;
9. the engine layer's coalescer at config 3: 7 replica threads, each with
   its own ``SigOnlyVerifier`` over one shared ``ThreadCoalescingVerifier``
   (wired as benchmarks/chain_crypto_tps.py wires it), verify their 1,000
   requests from a barrier, then their commit quorum; every replica's
   verdicts equal phase 3's, B1's launches equal the device flushes and are
   fewer than the replicas, the host path is never called and the device
   never suspect;
10. the same at config 2: 4 replica threads x 500 P-256 requests, B2;
11. supervision at the catch-up chunk's width: the chunk through supervised
   strict and randomized engines (rung 0, one clean host cross-check, B1
   and B3 launched), then injected faults around the real strict engine
   (a raise degrades to the host twin, the probe after the backoff
   re-promotes and launches B1, a flipped verdict is caught by the
   cross-check), with the host seconds of each cross-check;
12. the protocol core at config 3: the port's ``Cluster`` of 7
   ``SignedRequestApp`` replicas (one strict engine on the card shared by
   all, wired as benchmarks/chain_crypto_tps.py wires its device mode
   without the coalescer; a file WAL per replica) orders 4 blocks of 1,000
   signed requests; all ledgers identical, every decision's 2f+1 commit
   signatures verified, B1's, D1's and D2's launches equal to the engine's
   device calls (every replica's proposal wave, counted by a counting
   subclass), B2 and B3 never launched; each block's time split into the
   engine's device calls, the host-path verifications and the rest, and
   the rest into WAL fsyncs (``os.fsync`` timed), collector pauses outside
   the engine's calls (``gc.callbacks``) and what is left; the sim's serial tx/s
   (the replicas' waves of a block run in turn on one thread), a profiled
   re-run of a follower wave, and B1 against its plain version on that
   wave's own inputs (1,024 lanes);
13. kernel S1 (SHA-512, ``csrc/sha512.cu``) against its plain version on
   the strict wave's challenge blocks ``R || A || M`` (7,000 signatures on
   8,192 lanes, as the fused engine packs them), tolerance 0, and every live
   lane's digest against ``hashlib.sha512``; on the same lanes' first blocks
   alone, on their first 8 lanes and on 16 lanes of up to 40 blocks, each
   at tolerance 0; then on one lane holding the randomized wave's
   transcript root message (``tag || n || n leaf digests`` over its 6,860
   live lanes) against hashlib only; at each width the time through the
   wrapper and of launches alone (CUDA events), and a bound from SHA-512's
   own work: its integer instructions over every SM, the longest lane's
   chain of dependent instructions at the card's dependent-issue latency
   (measured by a clock64() probe), and its bytes;
14. the fused strict wave (``device_prep``): phase 3's corpus through
   ``engine_for_config(Configuration(device_prep=True))``, verdicts equal to
   phase 3's lane for lane, S1 and B1 launched once, B2 and B3 never; both
   engines' host prep timed on the wave, a profiled re-run, peak memory,
   and three replicas' waves through ``verify_stream``;
15. the fused randomized wave: phase 7's corpus through
   ``FusedEd25519RandomizedBatchVerifier``, verdicts equal to phase 7's, B3
   launched once per aggregate check (as many as phase 7's) and S1 four
   times a check;
16. half-aggregated certificates: the catch-up chunk's 51 decisions'
   honest quorums aggregated over the fused engine at
   ``min_device_batch=1``, each cert verified on the card (one B3 launch)
   and on the host twin, tampered certs rejected, and each forged vote of
   the chunk localized by bisection exactly as the strict engine does;
17. the configuration path: phase 12's cluster with the engine that
   ``engine_for_config`` builds from ``Configuration(device_prep=True,
   cert_mode="half-agg", crypto_tpu_min_batch=32)``, ordering the first 2
   of the same 4 blocks of signed requests (cut from 4 to keep the script
   near its time); all ledgers identical, every decided certificate a
   ``QuorumCert`` that verifies on the host twin, B1 and S1 once per device
   call, and S1 against its plain version on the last follower wave's
   blocks;
18. kernels D1 (decompression, ``csrc/decompress25519.cu``) and D2 (the
   fixed-base comb, ``csrc/comb25519.cu``) against their plain torch
   versions on phase 3's own inputs, tolerance 0: D1 on the wave's R || A
   stack (16,384 points), on its first 1,024 lanes' (2,048, phase 12's
   width) and on its first 256 lanes' (512), with the valid masks equal;
   D2 on the wave's S digits (8,192 lanes), on its first 1,024 lanes and on
   one lane; each with its time through its wrapper (as every other
   kernel's) and of its launches alone, the plain version's and its bound,
   and the registers, shared memory, stack frame and spills ptxas reports.  D1 and D2 launch once per device call on
   every Ed25519 path (phases 3, 7, 8, 12 and 14-17 count them).
19. the device-fault chaos matrix (the JAX package's, tests/test_supervisor.py:
   425-497) through the port's chaos harness (``testing/chaos.py``): seed
   31's 4-replica schedule of 6 actions with one hang, one raise and one
   silent verdict flip armed on the engine's launches, in the strict,
   randomized, half-agg, fused and ``mesh2`` (the strict engine sharded over
   2 virtual shards of the card, ``[cuda:0] * 2``) engine modes, each engine
   on the card at ``min_device_batch=1`` (every quorum check a launch of its
   kernels, once per shard in ``mesh2``) under an ``EngineSupervisor`` that
   cross-checks every launch on the host twin.
   Per mode the fault-free card run, the faulted card run and the port's
   host-path run (``device="cpu"``) give byte-identical event logs and
   ledgers; every fault fires, degrades once and recovers; the mode's
   kernels launch in both card runs and the others do not.  The strict
   faulted run once more with the observability plane on: the same
   ledgers, an ``engine_degraded`` anomaly and no ``verify_collapse``.
20. the mesh (``consensus_tpu_torch/parallel/sharding.py``): phase 3's strict
   and phase 14's fused waves (7,000 signatures on 8,192 lanes), phases 7
   and 15's randomized waves and phase 5's P-256 wave (2,000 on 2,048),
   each through its single engine, the sharded engine over a 1-shard mesh
   and over 2 virtual shards of the card (``[cuda:0] * 2``), with the
   launch counts read around each call: verdicts equal to the single
   engine's lane for lane, the 1-shard mesh launching every kernel as often
   as the single engine, 2 shards twice as often (each kernel once per
   shard, at half the width: B1 at 4,096 lanes, B2 at 1,024), each call's
   wave ms beside the single engine's; the strict wave also over 8 virtual
   shards and the (2, 4) topology (eight times); 3 signatures on 8 shards
   (5 padding-only shards) through both randomized sharded engines, their
   verdicts the strict engine's; and a 2-shard mesh with no device list
   raises on a one-card machine.  Virtual shards measure the split and its
   launches, not scaling over cards.
21. the tensor-core field lane (``CTPU_MXU_LIMBS=1``, kernel M1 of
   ``csrc/mxu_limbs.cu``): M1's IMMA instructions counted in its SASS (none
   fails the phase); M1 through its wrapper at 8,192, 2,048, 1,024 and 1
   lanes and a (32, 1) constant against 8,192, over the three Ed25519 and
   two P-256 operand ranges, bit-identical (raw limbs) to the plain version
   on CPU copies and to the VPU lane's eager torch on the card; its time
   through the wrapper and alone beside the eager product's, the plain
   version's, ``torch._int_mm``'s one byte plane and the bound; then the
   strict, randomized and P-256 waves with the lane off and on (Ed25519
   through ``engine_for_config`` under ``CTPU_MXU_LIMBS=1``, booked as
   ``ed25519.verify_mxu`` and the like; P-256 under ``force_mxu_limbs``):
   verdicts equal, M1's launches, wall ms, busy share and peak memory.
22. the sidecar and the transport (``net/sidecar.py``, ``net/transport.py``):
   (a) phase 3's wave in 4 tenants' sweeps of 1,750, sent at once over TCP
   (per-tenant mutual handshake, a MAC on every frame) to one multi-tenant
   ``VerifySidecarServer`` whose ``FairShareWaveFormer`` (``max_wave``
   8,192) launches the strict engine at phase 3's ``min_device_batch``:
   verdicts equal to phase 3's lane for lane, B1, D1 and D2 launched once
   per wave the server counts, 7,000 signatures in the waves, no failover
   and no client suspect, each tenant's round trip; (b) phase 12's 7
   replicas over real sockets: each a ``Consensus`` on a
   ``RealtimeScheduler`` with a ``TcpComm`` (``auth_secret``) and a file
   WAL, its engine a ``SidecarVerifierClient`` on a unix socket to one
   ``VerifySidecarServer`` over a ``ThreadCoalescingVerifier`` (8,192) over
   the strict engine at phase 12's ``min_device_batch``, quorum checks
   bypassed to a counting host engine (the JAX package's
   deploy/replica_main.py wiring), ordering 3 of phase 12's blocks (cut
   from 4 to keep the script near its time; the first is warm-up): all
   ledgers identical, 2f+1 signatures a decision, every request ordered
   exactly once, B1, D1 and D2 launched once per coalesced flush, 0
   failovers; each block's wall ms, sweeps, flushes, launches, local calls,
   collector pauses (the set-up heap frozen) and fsyncs beside phase 12's.
23. the consensus groups and the deployment rig (``groups/``, ``deploy/``),
   the set-up heap frozen: (a) ``ShardedCluster(4, n=7)``, four config-3
   groups on one sim clock, 16 tenants, 8 rounds of one request a tenant
   (each group deciding at least 8 times); its committed certificates as
   real Ed25519 signatures (``cert_workload``) through one shared
   ``FairShareWaveFormer`` (``drive_shared_fleet``, one thread a group) and
   through one private former a group (``drive_private_fleets``), each over
   the strict engine on the card at ``min_device_batch=1``, the launch
   counts set to 0 just before each drive and read just after: every
   certificate verifies, both drives carry the same signatures, B1, D1 and
   D2 launch once per drive launch, the shared drive launches less often
   and at least once for 2+ groups; one forged signature makes the shared
   drive raise naming its group, and the card and the host path reject that
   lane alone; each drive's host-clock ms, launches and mean wave; (b)
   ``ClusterSpec.generate(7, 2, hold_ports=True)`` launched by
   ``ClusterLauncher(spec, device="cuda:0")``: 7 replica and 2 sidecar
   processes of the port's mains, the JAX acceptance legs (kill -9 the
   leader, kill -9 ``sc-0``, the old leader restarted by its supervisor
   rejoining from its WAL) with 5 replicas (n - f) as the bar for
   progress, then the port's ``driver_main`` for 10 s as its own process;
   the invariant monitor clean and no orphan or leaked port at
   ``launcher.stop()``; the processes holding the card after the boot.
   Cut: decisions of one request (the JAX smoke's
   ``request_batch_max_count``), since the rig's processes verify on the
   host path in pure Python, as the JAX mains do with OpenSSL.

The last line is the contract line
``{"ok": true, "device": {"platform": "gpu", ...}}``; any failed check
raises and exits non-zero.  It runs on CUDA only; the phases take a
``device`` argument so a CPU test can rehearse them at a tiny size.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import hashlib
import json
import os
import re
import shutil
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType

from consensus_tpu_torch.config import Configuration, ObsConfig
from consensus_tpu_torch.consensus import Consensus
from consensus_tpu_torch.deploy import ClusterLauncher, ClusterSpec
from consensus_tpu_torch.deploy.identity import make_client_keyring
from consensus_tpu_torch.metrics import (
    ENGINE_CROSSCHECK_KEY,
    ENGINE_CROSSCHECK_MISMATCH_KEY,
    ENGINE_DEGRADE_KEY,
    ENGINE_RECOVERED_KEY,
    ENGINE_RUNG_KEY,
    SIDECAR_WAVE_LAUNCHES_KEY,
    SIDECAR_WAVE_SIGNATURES_KEY,
    SIDECAR_WAVE_TENANTS_KEY,
    InMemoryProvider,
    Metrics,
)
from consensus_tpu_torch.models import ecdsa_p256 as mp
from consensus_tpu_torch.models import ed25519 as med
from consensus_tpu_torch.models.aggregate import HalfAggregator
from consensus_tpu_torch.models.engine import ThreadCoalescingVerifier
from consensus_tpu_torch.models.fused import (
    FusedEd25519BatchVerifier,
    FusedEd25519RandomizedBatchVerifier,
    canonical_ok_fast,
)
from consensus_tpu_torch.models.fused import _frame as frame
from consensus_tpu_torch.models.supervisor import FAULT_CLASSES, EngineSupervisor, HostTwin
from consensus_tpu_torch.models.verifier import (
    EcdsaP256Signer,
    EcdsaP256VerifierMixin,
    Ed25519Signer,
    commit_message,
    engine_for_config,
)
from consensus_tpu_torch.groups import ShardedCluster
from consensus_tpu_torch.obs import series_to_jsonl
from consensus_tpu_torch.net import SidecarVerifierClient, TcpComm, VerifySidecarServer
from consensus_tpu_torch.obs.kernels import KERNELS, TenantAccounting
from consensus_tpu_torch.ops import ed25519 as ed
from consensus_tpu_torch.ops import field25519 as fe
from consensus_tpu_torch.ops import field_p256 as fp
from consensus_tpu_torch.ops import mxu_limbs
from consensus_tpu_torch.ops import p256
from consensus_tpu_torch.ops import scan_kernels
from consensus_tpu_torch.ops import sha512 as sh
from consensus_tpu_torch.parallel import (
    MeshTopology,
    ShardedEcdsaP256Verifier,
    ShardedEd25519RandomizedVerifier,
    ShardedEd25519Verifier,
    ShardedFusedEd25519RandomizedVerifier,
    ShardedFusedEd25519Verifier,
    mesh_for_shards,
)
from consensus_tpu_torch.runtime import RealtimeScheduler
from consensus_tpu_torch.testing import Cluster
from consensus_tpu_torch.testing.app import unpack_batch
from consensus_tpu_torch.testing.chaos import ChaosEngine, ChaosSchedule
from consensus_tpu_torch.testing.crypto_app import ClientKeyring, SigOnlyVerifier, SignedRequestApp
from consensus_tpu_torch.types import Proposal, QuorumCert, Reconfig
from consensus_tpu_torch.wal import DEFAULT_SEGMENT_MAX_BYTES, initialize_and_read_all

#: BASELINE.json config 3: 7 replicas (f = 2), 1,000 requests per block.
REPLICAS = 7
REQUESTS = 1000
QUORUM = 5  # 2f + 1
SEED = 0

#: Peak device-memory rate of an H100 SXM (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
#: 32-bit integer multiply, multiply-add and extended-precision multiply-add
#: results per clock per SM on compute capability 9.0 (CUDA C++ Programming
#: Guide, arithmetic instruction throughput table).  A 32x32->64-bit product
#: is one IMAD.WIDE; counting each as one result at this full rate keeps the
#: bound a lower bound.
IMAD_PER_CLOCK_PER_SM = 64
#: 32x32->64-bit products one 256-bit field multiplication needs: 8 x 8
#: partial products of two 8-word operands, and 8 more to fold the upper
#: 256 bits back at 2^256 = 38 (mod p).
MUL_PRODUCTS = 8 * 8 + 8
#: The same for a squaring: 8 x 9 / 2 distinct partial products (the cross
#: terms are doubled by shifts, not multiplies) and the same fold.
SQUARE_PRODUCTS = 8 * 9 // 2 + 8
#: Field multiplications and squarings per lane in the Horner scan.  The table
#: takes 7 adds of 9 multiplications each (one by 2d); each of the 64 windows
#: takes 3 doubles without T (4 squarings, 3 multiplications), 1 double with
#: T (4 squarings, 4 multiplications) and 1 add.  A double squares X, Y, Z
#: and X + Y.  tests/test_torch_limbs_counting.py holds these to the counting
#: shim's count of the plain version, which routes (X + Y)^2 through a
#: multiplication: an artifact of its f32 8-bit limbs, whose one-raw-level
#: operand is past their squaring's exactness bound.
HORNER_MULS = 7 * 9 + 64 * (3 * 3 + 4 + 9)
HORNER_SQUARES = 64 * 4 * 4
#: Field multiplications and squarings per point in decompression (kernel
#: D1, csrc/decompress25519.cu): y^2, v^2, v3^2, x^2 and the 251 squarings of
#: the (p-5)/8 power; d y^2, v^3, v^7, u v^3, u v^7, the power's 11
#: multiplications, x, v x^2, x sqrt(-1) (on every lane) and T = x y.
DECOMPRESS_MULS = 5 + 11 + 4
DECOMPRESS_SQUARES = 4 + 251
#: Field multiplications per lane in the comb (kernel D2,
#: csrc/comb25519.cu): 32 mixed adds of 7 (the table holds 2d x y).
COMB_MULS = 32 * 7
#: Bytes of one entry of D2's table: (y - x, y + x, 2d x y), 5 uint64 limbs each.
COMB_ENTRY_BYTES = 3 * 5 * 8

#: The record_function ranges of the engine's wave, in the order they run.
WAVE_RANGES = (
    "ed25519.host_prep", "ed25519.decompress", "ed25519.negate",
    "ed25519.horner_scan", "ed25519.comb", "ed25519.add_and_equal",
)

#: BASELINE.json config 2: naive_chain, 4 replicas (f = 1), 500 requests
#: per proposal, ECDSA-P256 as in config 1.
P256_REPLICAS = 4
P256_REQUESTS = 500
P256_QUORUM = 3  # 2f + 1
#: Field multiplications and squarings per lane in the P-256 Horner scan: 72
#: complete adds (7 for the table, 65 in the windows) of 14 multiplications
#: each (12 + 2 by b), and 260 doubles (4 per window) of 10 multiplications
#: (8 + 2 by b) and 3 squarings each.  On 8 x 32-bit words a multiplication
#: needs 8 x 8 partial products and a squaring 8 x 9 / 2; the Solinas
#: reduction needs none.
P256_MULS = 72 * 14 + 65 * 4 * 10
P256_SQUARES = 65 * 4 * 3
P256_MUL_PRODUCTS = 8 * 8
P256_SQUARE_PRODUCTS = 8 * 9 // 2

#: The record_function ranges of the P-256 engine's wave, in the order they run.
P256_WAVE_RANGES = (
    "p256.host_prep", "p256.on_curve", "p256.horner_scan", "p256.comb", "p256.check",
)

_REQ_TAG = b"ctpu/request"
_REJECTION_CLASSES = (
    "tampered_s", "s_ge_l", "r_y_ge_p", "a_y_ge_p",
    "wrong_key", "wrong_message", "bad_length", "off_curve_y",
)
#: The randomized wave's classes: four the host rejects before the device,
#: and two that fail decompression (A off the curve, R off the curve).  No
#: forgery: the wave takes the aggregate check and the survivors' re-check.
RANDOMIZED_CLASSES = (
    "s_ge_l", "r_y_ge_p", "a_y_ge_p", "bad_length", "off_curve_y", "r_off_curve",
)

#: The randomized device check's record_function ranges, in the order they run.
BATCH_RANGES = (
    "ed25519.batch.host_prep", "ed25519.batch.decompress", "ed25519.batch.negate",
    "ed25519.batch.straus_msm", "ed25519.batch.comb", "ed25519.batch.check",
)
#: Field multiplications and squarings of one point add (8 + 1 by 2d), one
#: double without T (3 + 4: X, Y, Z and X + Y squared) and one with T (4 + 4).
ADD_MULS = 9
DOUBLE_MULS, DOUBLE_SQUARES = 3, 4
DOUBLE_T_MULS, DOUBLE_T_SQUARES = 4, 4
#: The 9-entry table of one point, built as the plain version builds it
#: (``ops/ed25519.py::multiples_table9``): 3 adds (3p, 5p, 7p) and 4
#: doubles with T (2p; 4p and 6p as one double of two lanes; 8p).
TABLE9_ADDS, TABLE9_DOUBLES = 3, 4
#: The sync catch-up chunk of phase 8: 51 decisions, a 2f+1 quorum each.
CATCH_UP_DECISIONS = 51
#: Its 255 votes padded: the width phase 6 also checks and times B3 at.
CATCH_UP_LANES = 256
#: A phase-12 wave: a block's 1,000 signatures on 1,024 lanes, the width
#: phase 18 also checks and times D1 (on 2,048 points) and D2 at.
CLUSTER_LANES = 1024
#: The coalescer of phases 9-10 as benchmarks/chain_crypto_tps.py wires it:
#: submissions below this skip the window on the caller's thread.
BYPASS_BELOW = 64
#: The coalescer's flusher thread, by name: its engine calls are the flushes.
FLUSHER = "verify-coalescer"
#: Phase 12's cluster, wired as benchmarks/chain_crypto_tps.py wires its
#: device mode without the coalescer: 16 clients, device batches from 32
#: signatures; the first of 4 blocks is warm-up.
CLUSTER_BLOCKS = 4
CLUSTER_CLIENTS = 16
CLUSTER_MIN_DEVICE_BATCH = 32
#: Phase 17 runs the same cluster on the configuration path for 2 of those
#: blocks (one warm-up, one measured), to keep the script near its time.
FUSED_CLUSTER_BLOCKS = 2

#: The fused engines' record_function ranges (models/fused.py), in the order
#: they run: the strict wave's, then an aggregate check's.
FUSED_RANGES = (
    "ed25519.fused.host_prep", "ed25519.fused.sha512", "ed25519.fused.scalars",
    "ed25519.fused.checks", "ed25519.decompress", "ed25519.negate", "ed25519.horner_scan",
    "ed25519.comb", "ed25519.add_and_equal",
)
FUSED_BATCH_RANGES = (
    "ed25519.fused.host_prep", "ed25519.fused.challenge", "ed25519.fused.transcript",
    "ed25519.fused.scalars", "ed25519.batch.decompress", "ed25519.batch.negate",
    "ed25519.batch.straus_msm", "ed25519.batch.comb", "ed25519.batch.check",
)
#: S1 launches of one fused aggregate check: the challenges, the transcript's
#: leaves, its root and its coefficients (models/fused.py).
S1_PER_CHECK = 4
#: 32-bit integer add, logical and shift results per clock per SM on compute
#: capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
#: throughput table); S1's bound counts SHA-512's instructions at this rate.
INT_PER_CLOCK_PER_SM = 64
#: SHA-512's 32-bit integer instructions a block (FIPS 180-4 6.4.2), whatever
#: kernel runs them, on a card with a funnel shift (SHF), a three-input logic
#: op (LOP3) and a three-input add (IADD3 with its carries out, IADD3.X with
#: them in): a 64-bit rotate is two funnel shifts and a 64-bit shift two (one
#: per half); a xor of three words, Ch and Maj are one LOP3 per half; a 64-bit
#: sum of up to three terms is two instructions, of four or five terms four.
#: - a schedule word W_t (t = 16..79): sigma0 (two rotates, a shift and the
#:   xor: 4 + 2 + 2) 8, sigma1 8, and the four-term sum 4: 20, 64 times;
#: - a round: Sigma0 (three rotates and the xor: 6 + 2) 8, Sigma1 8, Ch 2,
#:   Maj 2, T1 = h + Sigma1 + Ch + K + W (five terms) 4, e' = d + T1 2 and
#:   a' = T1 + Sigma0 + Maj 2: 28, 80 times;
#: - the feed-forward, eight sums of two: 16.
#: Loads, stores and the K words' fetches are not integer operations.
SHA512_WORD_OPS = 8 + 8 + 4
SHA512_ROUND_OPS = 8 + 8 + 2 + 2 + 4 + 2 + 2
SHA512_BLOCK_OPS = 64 * SHA512_WORD_OPS + 80 * SHA512_ROUND_OPS + 8 * 2
#: The fewest dependent 32-bit instructions from one round's e to the next's,
#: the chain a lane's blocks cannot spread: Sigma1(e)'s funnel shifts (each
#: reads both halves of e), the LOP3 that xors the three rotations, then the
#: low and the high half of e' = (d + h + K + W) + Sigma1 + Ch, the high half
#: taking the low half's carries.  The first term is off the chain (h and d
#: are e and a of three rounds back), and Ch(e, f, g) is one LOP3 beside
#: Sigma1.  From a to a' = T1 + Sigma0(a) + Maj(a, b, c) is four as well.
SHA512_CHAIN_DEPTH = 4
#: A clock64() probe of the card's dependent-issue latency over the
#: instructions of that chain: one thread runs steps of a funnel shift of
#: (lo, hi), the LOP3 xoring it with two more words, the low half's add with
#: its carry out and the high half's add with it in; each step's four
#: instructions depend in turn on the last's, so a step takes four
#: latencies.  Built by nvcc like the kernels (``build_latency_probe``).
LATENCY_PROBE_SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

__global__ void chain_probe_kernel(const uint32_t* in, long long* out, int steps) {
  uint32_t lo = in[0], hi = in[1];
  const uint32_t k0 = in[2], k1 = in[3], k2 = in[4], k3 = in[5];
  const long long start = clock64();
#pragma unroll 16
  for (int i = 0; i < steps; ++i) {
    uint32_t x = __funnelshift_r(lo, hi, 14);
    x = x ^ k0 ^ k1;
    asm volatile("add.cc.u32 %0, %0, %2;\n\taddc.u32 %1, %1, %3;"
                 : "+r"(x), "+r"(hi) : "r"(k2), "r"(k3));
    lo = x;
  }
  const long long stop = clock64();
  out[0] = stop - start;
  out[1] = lo;
  out[2] = hi;
}

extern "C" int chain_probe_launch(const void* in, void* out, int steps, void* stream) {
  chain_probe_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((const uint32_t*)in, (long long*)out,
                                                        steps);
  return (int)cudaGetLastError();
}
"""


def log(*parts) -> None:
    print(*parts, flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# --- corpus -------------------------------------------------------------------


def _off_curve_ys(count: int) -> list[int]:
    """Small y values with no curve point (x^2 is not a square)."""
    ys, y = [], 2
    while len(ys) < count:
        if med._ref_recover_x(y, 0) is None:
            ys.append(y)
        y += 1
    return ys


def make_corpus(
    n_requests: int, per_class: int, seed: int = SEED, classes=_REJECTION_CLASSES
):
    """``n_requests`` client requests signed with the port's ``ref_sign``
    (client keys and bodies from numpy seed ``seed``), with ``per_class``
    lanes of each rejection class of ``classes`` (by default the JAX
    package's test matrix; ``r_off_curve`` puts R's y off the curve).

    Returns (messages, signatures, keys, expected verdicts, tampered index
    list)."""
    n_bad = per_class * len(classes)
    if n_requests < n_bad + 1:
        raise ValueError("corpus too small for the rejection classes")
    rng = np.random.default_rng(seed)
    seeds = [rng.bytes(32) for _ in range(n_requests)]
    keys = [med.ref_public_key(s) for s in seeds]
    msgs = [
        _REQ_TAG + struct.pack(">IQ", i, 1) + rng.bytes(64) for i in range(n_requests)
    ]
    sigs = [med.ref_sign(s, m) for s, m in zip(seeds, msgs)]
    expected = np.ones(n_requests, dtype=bool)
    bad = rng.permutation(n_requests)[:n_bad].tolist()
    off_curve = _off_curve_ys(per_class)
    for j, i in enumerate(bad):
        kind = classes[j // per_class]
        k = j % per_class
        sig = sigs[i]
        s = int.from_bytes(sig[32:], "little")
        if kind == "tampered_s":
            s2 = s ^ (1 << (8 * k))  # still < L, wrong by math
            sigs[i] = sig[:32] + s2.to_bytes(32, "little")
        elif kind == "s_ge_l":
            sigs[i] = sig[:32] + (s + med.L).to_bytes(32, "little")
        elif kind == "r_y_ge_p":
            sigs[i] = (fe.P + 1 + k).to_bytes(32, "little") + sig[32:]
        elif kind == "a_y_ge_p":
            keys[i] = (fe.P + 2 + k).to_bytes(32, "little")
        elif kind == "wrong_key":
            keys[i] = keys[(i + 1) % n_requests]
        elif kind == "wrong_message":
            msgs[i] = msgs[i] + b"!"
        elif kind == "bad_length":
            sigs[i] = sig[:63] if k % 2 == 0 else sig + b"\x00"
        elif kind == "off_curve_y":
            keys[i] = off_curve[k].to_bytes(32, "little")
        elif kind == "r_off_curve":
            sigs[i] = off_curve[k].to_bytes(32, "little") + sig[32:]
        else:
            raise ValueError(f"unknown rejection class {kind!r}")
        expected[i] = False
    return msgs, sigs, keys, expected, bad


# --- phase 2: kernel against its plain version -----------------------------------


def weaken(c: torch.Tensor) -> torch.Tensor:
    """The same field element in another weakly reduced form: wherever a limb
    is >= 172, borrow 256 from it into the next limb, so limbs turn negative
    (|limb| stays <= 340, the value is unchanged)."""
    c = c.clone()
    for i in range(fe.LIMBS - 1):
        move = (c[i] >= 172).to(c.dtype)
        c[i] -= 256 * move
        c[i + 1] += move
    return c


def scan_inputs(keys, lanes: int, device, seed: int = SEED):
    """(-A) for ``lanes`` lanes from decompressed corpus keys (cycled), and
    signed digits of scalars drawn from numpy seed ``seed``; lane 0 has
    scalar 0 and lane 1 scalar 1.

    ``negate`` leaves its limbs in [0, 340], so the coordinates go through
    :func:`weaken`: the kernel's signed-borrow conversion of negative limbs
    is then exercised on every lane that has a limb >= 172."""
    good = [k for k in keys if med._ref_decompress(k) is not None]
    chosen = [good[i % len(good)] for i in range(lanes)]
    y, sign, _ = med._prep_compressed(chosen)
    pt, ok = ed.decompress(
        torch.from_numpy(np.ascontiguousarray(y.T)).to(device).to(torch.float32),
        torch.from_numpy(sign.astype(np.int32)).to(device),
    )
    if not bool(ok.all()):
        raise AssertionError("scan inputs: a corpus key failed to decompress")
    neg_a = tuple(weaken(c).contiguous() for c in ed.negate(pt))
    negative_lanes = int(torch.stack([(c < 0).any(dim=0) for c in neg_a]).any(dim=0).sum())
    if negative_lanes < lanes // 2:
        raise AssertionError(
            f"scan inputs: only {negative_lanes} of {lanes} lanes hold a negative limb"
        )
    rng = np.random.default_rng(seed)
    scalars = [0, 1] + [
        int.from_bytes(rng.bytes(32), "little") % med.L for _ in range(lanes - 2)
    ]
    rows = np.frombuffer(
        b"".join(s.to_bytes(32, "little") for s in scalars), dtype=np.uint8
    ).reshape(lanes, 32)
    digits = med._bits_to_signed_window_digits(med._bytes_rows_to_bits(rows))
    k_digits = torch.from_numpy(digits.astype(np.int32)).to(device)
    return neg_a, k_digits, negative_lanes


def _time_ms(fn, reps: int, device) -> float:
    """Mean milliseconds per call: CUDA events on the card, host clock on
    the CPU (rehearsal only)."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def kernel_split_ms(fn, reps: int, device) -> dict | None:
    """Mean device milliseconds per call of each CUDA kernel ``fn`` launches,
    keyed by the kernel's name, from ``torch.profiler`` over ``reps`` calls
    after a warm-up; None on the CPU (rehearsal only), where none runs."""
    if device.type != "cuda":
        return None
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split: dict[str, float] = {}
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            name = e.name.split("(")[0]
            split[name] = split.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    return split


def horner_bound(lanes: int, sm_count: int, sm_clock_hz: float) -> dict:
    """Least time for the Horner scan's work at ``lanes`` lanes: the larger
    of the 32x32->64-bit products its field multiplications and squarings
    need over the card's IMAD rate, and its bytes (four (32, lanes) f32
    coordinates in and out, (64, lanes) int32 digits in) over the memory
    rate."""
    products = (HORNER_MULS * MUL_PRODUCTS + HORNER_SQUARES * SQUARE_PRODUCTS) * lanes
    ops_ms = products / (sm_count * IMAD_PER_CLOCK_PER_SM * sm_clock_hz) * 1e3
    n_bytes = (4 + 4) * fe.LIMBS * lanes * 4 + 64 * lanes * 4
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    return {"bound_ms": max(ops_ms, bytes_ms), "bound_by": bound_by,
            "products": products, "bytes": n_bytes, "ops_ms": ops_ms, "bytes_ms": bytes_ms}


def _frozen_max_err(kernel: str, got: ed.Point, want: ed.Point) -> float:
    """The max abs err of frozen X, Y, Z, T of a kernel's point against its
    plain version's; raises where any lane differs (tolerance 0)."""
    lanes = got.x.shape[-1]
    max_err = 0.0
    for name, g, w in zip("XYZT", got, want):
        fg, fw = fe.freeze(g), fe.freeze(w)
        diff = (fg - fw).abs()
        max_err = max(max_err, float(diff.max()))
        bad = torch.nonzero(diff.amax(dim=0)).flatten()
        if bad.numel():
            raise AssertionError(
                f"{kernel}: {name} differs from the plain version on "
                f"{bad.numel()} of {lanes} lanes (first {bad[:8].tolist()})"
            )
    return max_err


def _check_horner(neg_a, k_digits) -> float:
    """horner_scan (the kernel on CUDA) against horner_scan_reference on the
    same inputs: frozen X, Y, Z, T equal on every lane, tolerance 0.
    Returns the max abs err."""
    return _frozen_max_err(
        "horner_scan", scan_kernels.horner_scan(*neg_a, k_digits),
        scan_kernels.horner_scan_reference(*neg_a, k_digits),
    )


def wave_scan_inputs(engine, msgs, sigs, keys):
    """Kernel B1's inputs on an engine's own path for one wave: its padded
    device inputs, then (-A) and the k digits as ``verify_impl`` builds
    them (decompression is per lane, so A alone gives the same points)."""
    _, _, y_a, sign_a, _, k_digits, _ = engine.prepare_device_inputs(msgs, sigs, keys)
    pt, _ = ed.decompress(y_a.to(torch.float32), sign_a.to(torch.int32))
    neg_a = tuple(c.contiguous() for c in ed.negate(pt))
    return neg_a, k_digits.to(torch.int32).contiguous()


def phase_kernel(device, keys, lanes: int, reps: int, plain_reps: int,
                 sub_lanes: int = CATCH_UP_LANES) -> dict:
    """horner_scan against horner_scan_reference (:func:`_check_horner`) at
    ``lanes`` lanes, then on their first ``sub_lanes`` columns made
    contiguous (the catch-up chunk's width), each timed over ``reps``
    launches and the plain version over ``plain_reps`` calls."""
    device = torch.device(device)
    neg_a, k_digits, negative_lanes = scan_inputs(keys, lanes, device)
    cols = min(sub_lanes, lanes)
    sub = tuple(c[:, :cols].contiguous() for c in neg_a), k_digits[:, :cols].contiguous()
    out = {"lanes": lanes, "negative_lanes": negative_lanes, "sub_lanes": cols}
    for prefix, (a, d) in (("", (neg_a, k_digits)), ("sub_", sub)):
        out[prefix + "max_abs_err"] = _check_horner(a, d)
        out[prefix + "ms"] = _time_ms(lambda: scan_kernels.horner_scan(*a, d), reps, device)
        out[prefix + "plain_ms"] = _time_ms(
            lambda: scan_kernels.horner_scan_reference(*a, d), plain_reps, device
        )
    return out


# --- phase 3: the main path --------------------------------------------------


def _subtree(event):
    yield event
    for child in event.cpu_children:
        yield from _subtree(child)


def profile_wave(
    engine, msgs, sigs, keys, device,
    wave_ranges=WAVE_RANGES, kernel: str = "horner_scan_kernel",
) -> dict:
    """One more run of the wave through the engine under ``torch.profiler``.

    For each range of ``wave_ranges`` (the engine's stages): its host time, and
    the device time of the kernels and copies launched inside it.  Besides:
    the run's host-clock time, the device's busy time over it (its kernels
    and copies; one stream, so they do not overlap), the Horner kernel's own
    device time (the device kernels whose name holds ``kernel``), and the
    device time no range claims.  Device times are None when the profiler
    saw no device activity (always so on the CPU)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        verdicts = engine.verify_batch(msgs, sigs, keys)
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    # Device activity, less the device-side copies of the ranges themselves.
    on_device = [
        e for e in events
        if e.device_type != DeviceType.CPU and e.name not in wave_ranges
    ]
    seen = bool(on_device)
    ranges = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in wave_ranges:
            dev_us = sum(
                k.duration for ev in _subtree(e) for k in ev.kernels
                if k.name not in wave_ranges
            )
            host_ms, dev_ms = ranges.get(e.name, (0.0, 0.0))
            ranges[e.name] = (host_ms + e.cpu_time_total / 1e3, dev_ms + dev_us / 1e3)
    missing = [name for name in wave_ranges if name not in ranges]
    if missing:
        raise AssertionError(f"profiled wave: no range {missing}")
    busy_ms = sum(e.time_range.elapsed_us() for e in on_device) / 1e3
    kernel_ms = sum(
        e.time_range.elapsed_us() for e in on_device if kernel in e.name
    ) / 1e3
    ranged_ms = sum(dev_ms for _, dev_ms in ranges.values())
    return {
        "verdicts": verdicts,
        "wall_ms": wall_ms,
        "ranges": {
            name: {"host_ms": host_ms, "device_ms": dev_ms if seen else None}
            for name, (host_ms, dev_ms) in ((n, ranges[n]) for n in wave_ranges)
        },
        "busy_ms": busy_ms if seen else None,
        # Device time that no range claims: zero when every launch is linked.
        "unranged_ms": busy_ms - ranged_ms if seen else None,
        "busy_share": busy_ms / wall_ms if seen else None,
        "kernel_device_ms": kernel_ms if seen else None,
    }


def phase_wave(device, corpus, replicas: int) -> dict:
    """One block's request wave on the shared engine: ``replicas`` replicas
    each verify the same requests of ``corpus`` (from :func:`make_corpus`),
    coalesced into one engine call through a SigOnlyVerifier's engine from
    ``engine_for_config(Configuration())``; then a 2f+1 commit quorum."""
    device = torch.device(device)
    msgs, sigs, keys, expected, bad = corpus
    n_requests = len(msgs)

    signers = [Ed25519Signer(i + 1, bytes([i + 1]) * 32) for i in range(REPLICAS)]
    verifier = SigOnlyVerifier(
        {s.node_id: s.public_bytes for s in signers},
        engine=engine_for_config(Configuration(), device=device),
    )
    engine = verifier.engine
    wave_msgs, wave_sigs, wave_keys, want = replica_wave(corpus, replicas)
    ed.comb_table(device)  # the constant table is set-up, not part of the wave

    # The main path, with the launch counts read around it.
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    t0 = time.perf_counter()
    got = engine.verify_batch(wave_msgs, wave_sigs, wave_keys)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wave_s = time.perf_counter() - t0
    wave_launches, horner_p256, msm = _launch_counts()
    d_launches = _d_launches()
    other_launches = horner_p256 + msm
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else None

    if got.shape != want.shape or not np.array_equal(got, want):
        wrong = np.flatnonzero(got != want)
        raise AssertionError(f"wave verdicts differ from the construction at {wrong[:16]}")
    # Against the RFC 8032 reference plus the strict pre-checks, on every
    # tampered lane and 64 sampled valid lanes (the replicas' copies of a
    # request are the same triple, so each triple is checked once).
    rng = np.random.default_rng(SEED + 1)
    valid_idx = np.flatnonzero(expected)
    sample = rng.choice(valid_idx, size=min(64, valid_idx.size), replace=False)
    checked = sorted(set(bad) | set(sample.tolist()))
    canon = med.Ed25519BatchVerifier._canonical_ok(
        [sigs[i] for i in checked], [keys[i] for i in checked]
    )
    for j, i in enumerate(checked):
        ref = bool(canon[j]) and med.ref_verify(keys[i], sigs[i], msgs[i])
        lanes = got[i::n_requests]
        if not (lanes == ref).all():
            raise AssertionError(f"request {i}: wave {lanes} vs reference {ref}")

    # Stages of the same wave, read off a profiled re-run of the engine call;
    # its launches are not counted as the main path's.
    prof = profile_wave(engine, wave_msgs, wave_sigs, wave_keys, device)
    if not np.array_equal(prof.pop("verdicts"), got):
        raise AssertionError("profiled re-run of the wave disagrees with the wave")

    # A 2f+1 commit quorum over the block: below crypto_tpu_min_batch, so it
    # takes the engine's host path (_verify_host) and launches no kernel.
    proposal = Proposal(payload=b"block-1", metadata=b"view-0/seq-1")
    quorum = [s.sign_proposal(proposal, b"aux-%d" % s.node_id) for s in signers[:QUORUM]]
    before = sum(_launch_counts()) + sum(_d_launches())
    results = verifier.verify_consenter_sigs_batch(quorum, proposal)
    if results != [q.msg for q in quorum]:
        raise AssertionError(f"commit quorum rejected: {results}")
    quorum_launches = sum(_launch_counts()) + sum(_d_launches()) - before

    n = len(wave_msgs)
    return {
        "signatures": n,
        "padded": engine.padded_size(n),
        "rejected": int((~got).sum()),
        "reference_checked": len(checked),
        "wave_ms": wave_s * 1e3,
        "sigs_per_s": n / wave_s,
        "profiled": prof,
        "wave_launches": wave_launches,
        "d_launches": d_launches,
        "other_launches": other_launches,
        "quorum_size": len(quorum),
        "quorum_launches": quorum_launches,
        "min_device_batch": Configuration().crypto_tpu_min_batch,
        "peak_bytes": peak,
        "verdicts": got,
    }


# --- P-256: corpus, phase 4 (kernel B2) and phase 5 (the P-256 path) ----------

_P256_REJECTION_CLASSES = (
    "sig_length", "key_length", "key_prefix", "r_zero", "r_ge_n", "s_zero",
    "s_ge_n", "qx_ge_p", "qy_ge_p", "off_curve", "wrong_key", "wrong_message",
)
#: Accepted as constructed: the high-s twin (r, n - s) of a valid signature.
#: The JAX engine has no low-s rule, and neither has the port.
_P256_ACCEPT_CLASSES = ("high_s",)


def make_p256_corpus(n_requests: int, per_class: int, seed: int = SEED):
    """``n_requests`` client requests, each signed by its own P-256 key with
    ``ref_p256_sign`` (keys and bodies from numpy seed ``seed``), with
    ``per_class`` lanes of each rejection class of the JAX engine and of the
    high-s accept class.

    Returns (messages, signatures, keys, expected verdicts, the list of
    rejection-class and high-s indices)."""
    classes = _P256_REJECTION_CLASSES + _P256_ACCEPT_CLASSES
    n_special = per_class * len(classes)
    if n_requests < n_special + 1:
        raise ValueError("corpus too small for the rejection classes")
    rng = np.random.default_rng(seed)
    privs = [int.from_bytes(rng.bytes(32), "big") % (mp.N - 1) + 1 for _ in range(n_requests)]
    keys = [mp.ref_p256_public_key(d) for d in privs]
    msgs = [
        _REQ_TAG + struct.pack(">IQ", i, 1) + rng.bytes(64) for i in range(n_requests)
    ]
    sigs = [mp.ref_p256_sign(d, m) for d, m in zip(privs, msgs)]
    expected = np.ones(n_requests, dtype=bool)
    special = rng.permutation(n_requests)[:n_special].tolist()
    for j, i in enumerate(special):
        kind = classes[j // per_class]
        k = j % per_class
        sig, key = sigs[i], keys[i]
        r, s = sig[:32], sig[32:]
        x, y = key[1:33], key[33:]
        if kind == "sig_length":
            sigs[i] = sig[:63] if k % 2 == 0 else sig + b"\x00"
        elif kind == "key_length":
            keys[i] = key[:64] if k % 2 == 0 else key + b"\x00"
        elif kind == "key_prefix":
            # A real compressed key (33 bytes), or 65 bytes behind 0x02.
            compressed = bytes([2 + (int.from_bytes(y, "big") & 1)]) + x
            keys[i] = compressed if k % 2 == 0 else b"\x02" + x + y
        elif kind == "r_zero":
            sigs[i] = bytes(32) + s
        elif kind == "r_ge_n":
            sigs[i] = (mp.N + k).to_bytes(32, "big") + s
        elif kind == "s_zero":
            sigs[i] = r + bytes(32)
        elif kind == "s_ge_n":
            sigs[i] = r + (mp.N + k).to_bytes(32, "big")
        elif kind == "qx_ge_p":
            keys[i] = b"\x04" + (fp.P + k).to_bytes(32, "big") + y
        elif kind == "qy_ge_p":
            keys[i] = b"\x04" + x + (fp.P + k).to_bytes(32, "big")
        elif kind == "off_curve":
            keys[i] = b"\x04" + x + ((int.from_bytes(y, "big") + 1 + k) % fp.P).to_bytes(32, "big")
        elif kind == "wrong_key":
            keys[i] = keys[(i + 1) % n_requests]
        elif kind == "wrong_message":
            msgs[i] = msgs[i][:-1] + bytes([msgs[i][-1] ^ 1])
        else:  # high_s: accepted
            sigs[i] = r + (mp.N - int.from_bytes(s, "big")).to_bytes(32, "big")
        expected[i] = kind in _P256_ACCEPT_CLASSES
    return msgs, sigs, keys, expected, special


def replica_wave(corpus, replicas: int):
    """The wave of ``replicas`` replicas each verifying every request of
    ``corpus``: (messages, signatures, keys, expected verdicts)."""
    msgs, sigs, keys, expected, _ = corpus
    return msgs * replicas, sigs * replicas, keys * replicas, np.tile(expected, replicas)


def p256_scan_inputs(corpus, replicas: int, device):
    """Kernel B2's inputs on the main path: the P-256 engine's own device
    inputs for the wave of ``corpus`` (qx, qy as bytes widened to f32, u2
    digits widened to int32), with counts of the lanes whose key is off the
    curve (padded and host-rejected lanes hold zeros) and of the padded
    lanes, whose digits are all 0 (d = -8 in every window)."""
    msgs, sigs, keys, _ = replica_wave(corpus, replicas)
    engine = mp.EcdsaP256BatchVerifier(device=device)
    qx, qy, _, u2d, *_ = engine.prepare_device_inputs(msgs, sigs, keys)
    qx = qx.to(torch.float32).contiguous()
    qy = qy.to(torch.float32).contiguous()
    u2d = u2d.to(torch.int32).contiguous()
    off_curve = int((~p256.on_curve(qx, qy)).sum())
    padded = qx.shape[1] - len(msgs)
    return (qx, qy, u2d), off_curve, padded


def p256_bound(lanes: int, sm_count: int, sm_clock_hz: float) -> dict:
    """Least time for the P-256 Horner scan's work at ``lanes`` lanes: the
    larger of the 32x32->64-bit products its multiplications and squarings
    need over the card's IMAD rate, and its bytes (two (32, lanes) f32
    coordinates and (65, lanes) int32 digits in, three (32, lanes) f32
    coordinates out) over the memory rate."""
    products = (P256_MULS * P256_MUL_PRODUCTS + P256_SQUARES * P256_SQUARE_PRODUCTS) * lanes
    ops_ms = products / (sm_count * IMAD_PER_CLOCK_PER_SM * sm_clock_hz) * 1e3
    n_bytes = ((2 + 3) * fp.LIMBS + 65) * lanes * 4
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    return {"bound_ms": max(ops_ms, bytes_ms), "bound_by": bound_by,
            "products": products, "bytes": n_bytes, "ops_ms": ops_ms, "bytes_ms": bytes_ms}


def phase_kernel_p256(device, corpus, replicas: int, reps: int, plain_reps: int) -> dict:
    """horner_scan_p256 (the kernel on CUDA) against
    horner_scan_p256_reference on the main path's inputs for the wave of
    ``corpus``: frozen X, Y, Z equal on every lane, tolerance 0."""
    device = torch.device(device)
    inputs, off_curve, padded = p256_scan_inputs(corpus, replicas, device)
    lanes = inputs[0].shape[1]
    got = scan_kernels.horner_scan_p256(*inputs)
    want = scan_kernels.horner_scan_p256_reference(*inputs)
    max_err = 0.0
    for name, g, w in zip("XYZ", got, want):
        fg, fw = fp.freeze(g), fp.freeze(w)
        diff = (fg - fw).abs()
        max_err = max(max_err, float(diff.max()))
        bad = torch.nonzero(diff.amax(dim=0)).flatten()
        if bad.numel():
            raise AssertionError(
                f"horner_scan_p256: {name} differs from the plain version on "
                f"{bad.numel()} of {lanes} lanes (first {bad[:8].tolist()})"
            )
    ms = _time_ms(lambda: scan_kernels.horner_scan_p256(*inputs), reps, device)
    plain_ms = _time_ms(
        lambda: scan_kernels.horner_scan_p256_reference(*inputs), plain_reps, device
    )
    return {"lanes": lanes, "off_curve_lanes": off_curve, "padded_lanes": padded,
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


class P256SigOnlyVerifier(EcdsaP256VerifierMixin):
    """The signature half of a P-256 replica's Verifier port (the
    application half is not exercised here)."""

    def verify_proposal(self, proposal):
        raise NotImplementedError

    def verify_request(self, raw):
        raise NotImplementedError

    def verification_sequence(self):
        return 0

    def requests_from_proposal(self, proposal):
        return []


def phase_wave_p256(device, corpus, replicas: int, valid_checked: int = 100) -> dict:
    """One block's request wave on the P-256 engine from
    ``engine_for_config(Configuration(), curve="p256")``: ``replicas``
    replicas each verify the requests of ``corpus`` (from
    :func:`make_p256_corpus`), coalesced into one engine call; then a 2f+1
    commit quorum through ``EcdsaP256VerifierMixin``."""
    device = torch.device(device)
    msgs, sigs, keys, expected, special = corpus
    n_requests = len(msgs)
    signers = [
        EcdsaP256Signer(i + 1, (i + 1).to_bytes(32, "big")) for i in range(P256_REPLICAS)
    ]
    verifier = P256SigOnlyVerifier(
        {s.node_id: s.public_bytes for s in signers},
        engine=engine_for_config(Configuration(), curve="p256", device=device),
    )
    engine = verifier.engine
    wave_msgs, wave_sigs, wave_keys, want = replica_wave(corpus, replicas)
    p256.comb_table(device)  # the constant table is set-up, not part of the wave

    # The main path, with the launch counts read around it.
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    t0 = time.perf_counter()
    got = engine.verify_batch(wave_msgs, wave_sigs, wave_keys)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wave_s = time.perf_counter() - t0
    horner, wave_launches, msm = _launch_counts()
    other_launches = horner + msm + sum(_d_launches())
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else None

    if got.shape != want.shape or not np.array_equal(got, want):
        wrong = np.flatnonzero(got != want)
        raise AssertionError(f"P-256 wave verdicts differ from the construction at {wrong[:16]}")
    # Against the pure-Python reference on every special lane and
    # ``valid_checked`` sampled valid ones (the replicas' copies of a request
    # are the same triple, so each triple is checked once).
    rng = np.random.default_rng(SEED + 2)
    plain = np.setdiff1d(np.flatnonzero(expected), special)
    sample = rng.choice(plain, size=min(valid_checked, plain.size), replace=False)
    checked = sorted(set(special) | set(sample.tolist()))
    for i in checked:
        ref = mp.ref_p256_verify(keys[i], sigs[i], msgs[i])
        lanes = got[i::n_requests]
        if not (lanes == ref).all():
            raise AssertionError(f"request {i}: P-256 wave {lanes} vs reference {ref}")
    high_s = [i for i in special if expected[i]]
    if not all(got[i] for i in high_s):
        raise AssertionError("a high-s signature was rejected")

    prof = profile_wave(
        engine, wave_msgs, wave_sigs, wave_keys, device,
        wave_ranges=P256_WAVE_RANGES, kernel="horner_scan_p256_kernel",
    )
    if not np.array_equal(prof.pop("verdicts"), got):
        raise AssertionError("profiled re-run of the P-256 wave disagrees with the wave")

    # A 2f+1 commit quorum: below crypto_tpu_min_batch, so it takes the
    # engine's host path (the pure-Python reference) and launches no kernel.
    proposal = Proposal(payload=b"block-1", metadata=b"view-0/seq-1")
    quorum = [
        s.sign_proposal(proposal, b"aux-%d" % s.node_id) for s in signers[:P256_QUORUM]
    ]
    before = sum(_launch_counts())
    results = verifier.verify_consenter_sigs_batch(quorum, proposal)
    if results != [q.msg for q in quorum]:
        raise AssertionError(f"P-256 commit quorum rejected: {results}")
    quorum_launches = sum(_launch_counts()) - before

    n = len(wave_msgs)
    return {
        "verdicts": got,
        "signatures": n,
        "padded": engine.padded_size(n),
        "rejected": int((~got).sum()),
        "high_s_accepted": len(high_s) * replicas,
        "reference_checked": len(checked),
        "wave_ms": wave_s * 1e3,
        "sigs_per_s": n / wave_s,
        "profiled": prof,
        "wave_launches": wave_launches,
        "other_launches": other_launches,
        "quorum_size": len(quorum),
        "quorum_launches": quorum_launches,
        "min_device_batch": Configuration().crypto_tpu_min_batch,
        "peak_bytes": peak,
    }


# --- randomized Ed25519: phase 6 (kernel B3), 7 (the wave), 8 (catch-up) ------


def msm_bound(lanes: int, live_lanes: int, n_low: int, sm_count: int,
              sm_clock_hz: float) -> dict:
    """Least time for the Straus MSM's work at ``lanes`` lanes, of which
    ``live_lanes`` have a nonzero digit: the larger of the 32x32->64-bit
    products its field multiplications and squarings need over the card's
    IMAD rate, and its bytes (eight (32, lanes) f32 coordinates, (64 + n_low,
    lanes) int32 digits in, four (32, 1) f32 coordinates out) over the
    memory rate.

    The work the function needs on this data: per live lane two 9-entry
    tables (``TABLE9_ADDS`` adds and ``TABLE9_DOUBLES`` doubles with T
    each), ``n_low`` adds combining the A and R entries and 64 adds summing
    its window contributions (per window, the live lanes' sum and its add
    into the accumulator); one doubling chain of 64 windows, each 3 doubles
    without T and 1 with T.  A lane whose digits are all 8 adds the
    identity and needs no work."""
    adds = live_lanes * (2 * TABLE9_ADDS + n_low + 64)
    doubles, doubles_t = 64 * 3, 64 + live_lanes * 2 * TABLE9_DOUBLES
    muls = adds * ADD_MULS + doubles * DOUBLE_MULS + doubles_t * DOUBLE_T_MULS
    squares = doubles * DOUBLE_SQUARES + doubles_t * DOUBLE_T_SQUARES
    products = muls * MUL_PRODUCTS + squares * SQUARE_PRODUCTS
    ops_ms = products / (sm_count * IMAD_PER_CLOCK_PER_SM * sm_clock_hz) * 1e3
    n_bytes = (8 * fe.LIMBS + 64 + n_low) * lanes * 4 + 4 * fe.LIMBS * 4
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    return {"bound_ms": max(ops_ms, bytes_ms), "bound_by": bound_by, "adds": adds,
            "doubles": doubles + doubles_t, "muls": muls, "squares": squares,
            "products": products, "bytes": n_bytes, "ops_ms": ops_ms, "bytes_ms": bytes_ms}


def msm_wave_inputs(corpus, replicas: int, device):
    """Kernel B3's inputs on the randomized path: the first aggregate of the
    wave of ``corpus`` as the engine builds it (the lanes that pass the host
    pre-checks, their transcript's digits, padded), through
    ``msm_inputs``, which masks padded and undecodable lanes to digit 8.
    Returns ((-A, -R, zk digits, z digits), masked lanes, padded lanes)."""
    msgs, sigs, keys, _ = replica_wave(corpus, replicas)
    engine = engine_for_config(Configuration(batch_verify_mode=True), device=device)
    host_ok, scalars = engine._host_scalars(msgs, sigs, keys)
    idx = np.flatnonzero(host_ok).tolist()
    zs = med._transcript_coefficients(
        [msgs[i] for i in idx], [sigs[i] for i in idx], [keys[i] for i in idx]
    )
    y_r, sign_r, y_a, sign_a, _, zk, z, ok = engine._aggregate_device_inputs(
        idx, sigs, keys, scalars, zs
    )
    neg_a, neg_r, zk, z, valid = med.msm_inputs(y_r, sign_r, y_a, sign_a, zk, z, ok)
    padded = zk.shape[1] - len(idx)
    return (neg_a, neg_r, zk, z), int((~valid).sum()) - padded, padded


def affine(p: ed.Point) -> tuple[torch.Tensor, torch.Tensor]:
    """Canonical limbs of x = X/Z and y = Y/Z."""
    zinv = fe.invert(p.z)
    return fe.freeze(fe.mul(p.x, zinv)), fe.freeze(fe.mul(p.y, zinv))


def _check_msm(inputs, label: str) -> tuple[float, float]:
    """straus_msm (the kernel on CUDA) against straus_msm_reference on
    ``inputs``: affine x and y equal (the projective representatives differ
    by design), tolerance 0, and not the identity.  Returns the max abs
    err and the plain version's milliseconds (one run, host clock)."""
    device = inputs[2].device
    got = scan_kernels.straus_msm(*inputs)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = scan_kernels.straus_msm_reference(*inputs)
    if device.type == "cuda":
        torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    max_err = 0.0
    for name, g, w in zip("xy", affine(got), affine(want)):
        max_err = max(max_err, float((g - w).abs().max()))
        if not torch.equal(g, w):
            raise AssertionError(
                f"straus_msm at {label}: affine {name} differs from the plain version"
            )
    if bool(ed.is_identity(got).all()):
        raise AssertionError(f"straus_msm at {label}: the aggregate MSM is the identity")
    return max_err, plain_ms


def _live_lanes(inputs) -> int:
    """Lanes with a nonzero digit: the others add the identity."""
    return int(((inputs[2] != 8).any(0) | (inputs[3] != 8).any(0)).sum())


def phase_kernel_msm(device, corpus, replicas: int, reps: int) -> dict:
    """straus_msm against straus_msm_reference on the randomized wave's
    first aggregate, then on its first ``CATCH_UP_LANES`` columns made
    contiguous (the catch-up chunk's width), each checked by
    :func:`_check_msm`, timed over ``reps`` launches and split by CUDA
    kernel (:func:`kernel_split_ms`).  The plain version runs once at each
    width."""
    device = torch.device(device)
    inputs, masked, padded = msm_wave_inputs(corpus, replicas, device)
    lanes = inputs[2].shape[1]
    max_err, plain_ms = _check_msm(inputs, f"{lanes} lanes")
    ms = _time_ms(lambda: scan_kernels.straus_msm(*inputs), reps, device)
    split = kernel_split_ms(lambda: scan_kernels.straus_msm(*inputs), reps, device)
    cols = min(CATCH_UP_LANES, lanes)
    sub = tuple(
        ed.Point(*(c[:, :cols].contiguous() for c in p)) if isinstance(p, ed.Point)
        else p[:, :cols].contiguous()
        for p in inputs
    )
    sub_err, sub_plain_ms = _check_msm(sub, f"{cols} lanes")
    sub_ms = _time_ms(lambda: scan_kernels.straus_msm(*sub), reps, device)
    sub_split = kernel_split_ms(lambda: scan_kernels.straus_msm(*sub), reps, device)
    return {"lanes": lanes, "n_low": inputs[3].shape[0], "masked_lanes": masked,
            "padded_lanes": padded, "live_lanes": _live_lanes(inputs),
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "split": split,
            "sub_lanes": cols, "sub_live_lanes": _live_lanes(sub), "sub_max_abs_err": sub_err,
            "sub_ms": sub_ms, "sub_plain_ms": sub_plain_ms, "sub_split": sub_split}


def ptxas_summary(report: str) -> dict:
    """Per function of an ``nvcc -Xptxas -v`` report: registers (kernels
    only), stack frame and spill bytes, and shared memory, keyed by the
    kernel's name (a device function's mangled symbol)."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )(\w+)", line)
        if m:
            name = m.group(1)
            plain = re.match(r"_Z(\d+)", name)  # a global function: _Z<length><name>
            if plain:
                name = name[plain.end():plain.end() + int(plain.group(1))]
            out.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[name]["smem"] = int(smem.group(1)) if smem else 0
    return out


def _launch_counts() -> tuple[int, int, int]:
    """B1, B2 and B3's launches from the kernel ledger."""
    return tuple(
        KERNELS.stats(name).launches for name in ("horner_scan", "horner_scan_p256", "straus_msm")
    )


def _s1_launches() -> int:
    """S1's launches from the kernel ledger."""
    return KERNELS.stats("sha512").launches


def _d_launches() -> tuple[int, int]:
    """D1 and D2's launches from the kernel ledger."""
    return KERNELS.stats("decompress25519").launches, KERNELS.stats("comb25519").launches


def _reset_launch_counts() -> None:
    for name in scan_kernels.KERNELS:
        KERNELS.stats(name).launches = 0


def phase_wave_randomized(device, corpus, replicas: int) -> dict:
    """One block's request wave on the randomized engine from
    ``engine_for_config(Configuration(batch_verify_mode=True))``: verdicts
    against the construction, the strict engine on the same wave (run
    before the counted window) and the RFC 8032 reference."""
    device = torch.device(device)
    msgs, sigs, keys, expected, bad = corpus
    n_requests = len(msgs)
    engine = engine_for_config(Configuration(batch_verify_mode=True), device=device)
    strict = engine_for_config(Configuration(), device=device)
    wave_msgs, wave_sigs, wave_keys, want = replica_wave(corpus, replicas)
    ed.comb_table(device)  # the constant table is set-up, not part of the wave
    strict_got = strict.verify_batch(wave_msgs, wave_sigs, wave_keys)

    # The main path, with the launch counts read around it.
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    t0 = time.perf_counter()
    got = engine.verify_batch(wave_msgs, wave_sigs, wave_keys)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wave_s = time.perf_counter() - t0
    horner, horner_p256, msm = _launch_counts()
    d_launches = _d_launches()
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else None

    if got.shape != want.shape or not np.array_equal(got, want):
        wrong = np.flatnonzero(got != want)
        raise AssertionError(f"randomized verdicts differ from the construction at {wrong[:16]}")
    if not np.array_equal(got, strict_got):
        raise AssertionError("randomized verdicts differ from the strict engine's")
    rng = np.random.default_rng(SEED + 3)
    valid_idx = np.flatnonzero(expected)
    sample = rng.choice(valid_idx, size=min(64, valid_idx.size), replace=False)
    checked = sorted(set(bad) | set(sample.tolist()))
    canon = med.Ed25519BatchVerifier._canonical_ok(
        [sigs[i] for i in checked], [keys[i] for i in checked]
    )
    for j, i in enumerate(checked):
        ref = bool(canon[j]) and med.ref_verify(keys[i], sigs[i], msgs[i])
        lanes = got[i::n_requests]
        if not (lanes == ref).all():
            raise AssertionError(f"request {i}: randomized wave {lanes} vs reference {ref}")

    prof = profile_wave(
        engine, wave_msgs, wave_sigs, wave_keys, device,
        wave_ranges=BATCH_RANGES, kernel="straus_msm",
    )
    if not np.array_equal(prof.pop("verdicts"), got):
        raise AssertionError("profiled re-run of the randomized wave disagrees with the wave")
    n = len(wave_msgs)
    return {
        "signatures": n,
        "padded": engine.padded_size(n),
        "rejected": int((~got).sum()),
        "host_rejected": int((~engine._canonical_ok(wave_sigs, wave_keys)).sum()),
        "reference_checked": len(checked),
        "wave_ms": wave_s * 1e3,
        "sigs_per_s": n / wave_s,
        "profiled": prof,
        "msm_launches": msm,
        "d_launches": d_launches,
        "horner_launches": horner,
        "horner_p256_launches": horner_p256,
        "peak_bytes": peak,
        "verdicts": got,
    }


def bisection_nodes(n: int, forged, min_device: int, min_randomized: int = 2) -> tuple[int, int]:
    """Aggregate checks that the randomized engine's bisection makes over
    ``n`` lanes that all pass the host pre-checks and decompress, with the
    forgeries at positions ``forged``: (checks of at least ``min_device``
    lanes, on the device; checks below that, on the host).  Counted here
    from the positions alone, independently of the engine."""
    forged = sorted(forged)
    device = host = 0
    stack = [(0, n)]
    while stack:
        lo, hi = stack.pop()
        size = hi - lo
        if size < min_randomized:
            continue  # decided by the strict engine
        if size >= min_device:
            device += 1
        else:
            host += 1
        if any(lo <= f < hi for f in forged):
            mid = lo + size // 2
            stack += [(lo, mid), (mid, hi)]
    return device, host


def catch_up_chunk(decisions: int, seed: int = SEED):
    """A sync catch-up chunk of config 3: ``decisions`` decisions, each with
    a 2f+1 = 5-vote commit quorum from the 7 replicas (a rotating window of
    signers), and 3 forged votes at positions drawn from numpy seed
    ``seed``: a flipped S bit, a vote signed with another replica's key, and
    a vote over another decision's digest.

    Returns (signers, groups, expected aux per vote, forged flat positions)."""
    signers = [Ed25519Signer(i + 1, bytes([i + 1]) * 32) for i in range(REPLICAS)]
    groups = []
    for d in range(decisions):
        proposal = Proposal(payload=b"block-%d" % d, metadata=b"view-0/seq-%d" % d)
        voters = [signers[(d + j) % REPLICAS] for j in range(QUORUM)]
        groups.append((proposal, [v.sign_proposal(proposal, b"aux-%d" % v.node_id) for v in voters]))
    n = decisions * QUORUM
    forged = sorted(np.random.default_rng(seed).choice(n, size=3, replace=False).tolist())
    for kind, pos in zip(("flipped_s", "wrong_key", "other_digest"), forged):
        proposal, cert = groups[pos // QUORUM]
        vote = cert[pos % QUORUM]
        if kind == "flipped_s":
            value = bytearray(vote.value)
            value[32] ^= 1  # S changes by 1: still below L, wrong by math
            value = bytes(value)
        elif kind == "wrong_key":
            other = signers[vote.id % REPLICAS]  # the next replica
            value = other.sign_proposal(proposal, vote.msg).value
        else:
            other = groups[(pos // QUORUM + 1) % decisions][0]
            value = signers[vote.id - 1].sign_proposal(other, vote.msg).value
        if int.from_bytes(value[32:], "little") >= med.L:
            raise AssertionError("catch-up chunk: a forged S left [0, L)")
        cert[pos % QUORUM] = type(vote)(id=vote.id, value=value, msg=vote.msg)
    expected = [
        [None if g * QUORUM + j in forged else sig.msg for j, sig in enumerate(cert)]
        for g, (_, cert) in enumerate(groups)
    ]
    return signers, groups, expected, forged


def phase_catch_up(device, decisions: int) -> dict:
    """A sync catch-up chunk through ``verify_consenter_sigs_multi_batch`` of
    a SigOnlyVerifier on the randomized engine: the 3 forged votes come back
    None and every other vote its aux, equal to the strict engine's answer,
    with B3 launched once per bisection node of at least
    ``crypto_tpu_min_batch`` votes."""
    device = torch.device(device)
    signers, groups, expected, forged = catch_up_chunk(decisions)
    keys = {s.node_id: s.public_bytes for s in signers}
    config = Configuration(batch_verify_mode=True)
    verifier = SigOnlyVerifier(keys, engine=engine_for_config(config, device=device))
    strict = SigOnlyVerifier(keys, engine=engine_for_config(Configuration(), device=device))
    strict_out = strict.verify_consenter_sigs_multi_batch(groups)

    _reset_launch_counts()
    t0 = time.perf_counter()
    out = verifier.verify_consenter_sigs_multi_batch(groups)
    if device.type == "cuda":
        torch.cuda.synchronize()
    chunk_s = time.perf_counter() - t0
    horner, horner_p256, msm = _launch_counts()
    d_launches = _d_launches()
    if out != expected:
        raise AssertionError("catch-up chunk: verdicts differ from the construction")
    if out != strict_out:
        raise AssertionError("catch-up chunk: randomized verdicts differ from the strict engine's")
    n = decisions * QUORUM
    device_checks, host_checks = bisection_nodes(n, forged, config.crypto_tpu_min_batch)
    return {
        "decisions": decisions, "votes": n, "padded": verifier.engine.padded_size(n),
        "forged": forged, "rejected": sum(v is None for row in out for v in row),
        "chunk_ms": chunk_s * 1e3, "msm_launches": msm, "d_launches": d_launches,
        "horner_launches": horner,
        "horner_p256_launches": horner_p256, "device_checks": device_checks,
        "host_checks": host_checks, "min_device_batch": config.crypto_tpu_min_batch,
    }


# --- the engine layer: phases 9-10 (coalesced waves) and 11 (supervision) -----


def _instrumented(engine):
    """``engine``, its class swapped for a subclass that counts the engine
    calls made on the coalescer's flusher thread (the flushes) and the calls
    of its host path ``verify_host`` (the escape hatch's and the host twin's
    way to the host).  The count lives here, not in the package."""
    base = type(engine)

    class Instrumented(base):
        def verify_batch(self, messages, signatures, public_keys):
            if threading.current_thread().name == FLUSHER:
                self.flushes += 1
            return super().verify_batch(messages, signatures, public_keys)

        def verify_host(self, messages, signatures, public_keys):
            self.host_calls += 1
            return super().verify_host(messages, signatures, public_keys)

    Instrumented.__name__ = base.__name__
    engine.__class__ = Instrumented
    engine.flushes = engine.host_calls = 0
    return engine


def phase_coalesced(device, corpus, replicas: int, direct, curve: str = "ed25519",
                    bypass_below: int = BYPASS_BELOW, window: float | None = None) -> dict:
    """``replicas`` replica threads, each with its own Verifier-port mixin
    over ONE shared ThreadCoalescingVerifier on
    ``engine_for_config(Configuration(), curve)``, wired as
    benchmarks/chain_crypto_tps.py wires it (the config's window,
    ``max_batch`` the wave, ``hard_cap`` its padded size).  From a barrier,
    each verifies every request of ``corpus`` through
    ``verifier.engine.verify_batch``, then a 2f+1 commit quorum through
    ``verify_consenter_sigs_batch``, which is below ``bypass_below`` and
    runs on the caller's thread.  Each replica's verdicts must equal
    ``direct``, the same wave's verdicts from one direct engine call.
    ``window`` (the config's unless given) lets a CPU rehearsal wait out a
    loaded host's thread start-up."""
    device = torch.device(device)
    msgs, sigs, keys, _, _ = corpus
    n = len(msgs)
    config = Configuration()
    if curve == "p256":
        signers = [EcdsaP256Signer(i + 1, (i + 1).to_bytes(32, "big")) for i in range(replicas)]
        mixin, quorum_size, kernel = P256SigOnlyVerifier, P256_QUORUM, 1
    else:
        signers = [Ed25519Signer(i + 1, bytes([i + 1]) * 32) for i in range(replicas)]
        mixin, quorum_size, kernel = SigOnlyVerifier, QUORUM, 0
    engine = _instrumented(engine_for_config(config, curve, device=device))
    wave = n * replicas
    window = config.crypto_batch_window if window is None else window
    coalescer = ThreadCoalescingVerifier(
        engine,
        window=window,
        max_batch=wave,
        hard_cap=engine.padded_size(wave),
        bypass_below=bypass_below,
        name=FLUSHER,
    )
    registry = {s.node_id: s.public_bytes for s in signers}
    verifiers = [mixin(registry, engine=coalescer) for _ in range(replicas)]
    proposal = Proposal(payload=b"block-1", metadata=b"view-0/seq-1")
    quorum = [s.sign_proposal(proposal, b"aux-%d" % s.node_id) for s in signers[:quorum_size]]

    started: list[float] = []
    barrier = threading.Barrier(replicas, action=lambda: started.append(time.perf_counter()))
    got, returned, quorum_out, errors = {}, {}, {}, []

    def replica(r: int) -> None:
        try:
            barrier.wait()
            got[r] = verifiers[r].engine.verify_batch(msgs, sigs, keys)
            returned[r] = time.perf_counter()
            quorum_out[r] = verifiers[r].verify_consenter_sigs_batch(quorum, proposal)
        except Exception as exc:  # surfaced on the main thread below
            errors.append(exc)
            barrier.abort()

    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    held = [torch.cuda.memory_allocated() if device.type == "cuda" else None]
    _reset_launch_counts()
    threads = [threading.Thread(target=replica, args=(r,), name=f"replica-{r}")
               for r in range(replicas)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        coalescer.close()
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else None
    held.append(torch.cuda.memory_allocated() if device.type == "cuda" else None)
    if errors:
        raise AssertionError(f"a replica thread failed: {errors[0]!r}") from errors[0]
    if coalescer._thread.is_alive():
        raise AssertionError("the coalescer's flusher thread outlived close()")

    for r in range(replicas):
        if not np.array_equal(got[r], direct[r * n:(r + 1) * n]):
            wrong = np.flatnonzero(got[r] != direct[r * n:(r + 1) * n])
            raise AssertionError(f"replica {r}: coalesced verdicts differ from the direct wave at {wrong[:16]}")
        if quorum_out[r] != [q.msg for q in quorum]:
            raise AssertionError(f"replica {r}: commit quorum rejected: {quorum_out[r]}")
    # On the CPU (a rehearsal) the plain versions run and nothing launches.
    flush_launches = engine.flushes if device.type == "cuda" else 0
    if launches[kernel] != flush_launches or not 0 < engine.flushes < replicas:
        raise AssertionError(
            f"{list(scan_kernels.KERNELS)[kernel]} launched {launches[kernel]} times for "
            f"{engine.flushes} coalesced flushes of {replicas} replicas"
        )
    if sum(launches) != launches[kernel]:
        raise AssertionError(f"the coalesced wave launched another kernel: {launches}")
    if engine.host_calls:
        raise AssertionError(f"the coalescer served {engine.host_calls} flushes from the host")
    if coalescer.device_suspect:
        raise AssertionError(f"the coalescer marked the device suspect ({coalescer.health.reason})")
    return {
        "replicas": replicas, "signatures": wave, "hard_cap": engine.padded_size(wave),
        "window_s": window, "flushes": engine.flushes,
        "launches": launches[kernel], "host_calls": engine.host_calls,
        "quorum_size": quorum_size, "bypass_below": bypass_below,
        "wave_ms": (max(returned.values()) - started[0]) * 1e3, "peak_bytes": peak,
        "held_bytes": held,
    }


class _TimedHostTwin(HostTwin):
    """A host twin that keeps the host seconds of each of its calls (the
    supervisor's cross-checks, and the calls it serves when degraded)."""

    def verify_batch(self, messages, signatures, public_keys):
        t0 = time.perf_counter()
        out = super().verify_batch(messages, signatures, public_keys)
        self.seconds.append(time.perf_counter() - t0)
        return out


def _timed(sup: EngineSupervisor) -> _TimedHostTwin:
    twin = sup._rungs[-1]
    twin.__class__ = _TimedHostTwin
    twin.seconds = []
    return twin


class _Faulty:
    """The real strict engine behind a fault injector: its first device call
    raises before launching, its second answers, its third flips every
    verdict, and later ones answer.  The host path is the engine's own."""

    def __init__(self, engine):
        self.engine = engine
        self.calls = 0

    def verify_batch(self, messages, signatures, public_keys):
        self.calls += 1
        if self.calls == 1:
            raise RuntimeError("injected launch failure")
        out = self.engine.verify_batch(messages, signatures, public_keys)
        return ~out if self.calls == 3 else out

    def verify_host(self, messages, signatures, public_keys):
        return self.engine.verify_host(messages, signatures, public_keys)


def _engine_dump(provider: InMemoryProvider) -> dict:
    return {k: v["value"] for k, v in provider.dump().items() if k.startswith("engine_")}


def phase_supervised(device, decisions: int) -> dict:
    """Supervision at the catch-up chunk's width: (a) the chunk through
    ``engine_for_config(Configuration(engine_supervision=True,
    engine_crosscheck_interval=1))``, strict and then randomized, which
    must stay at rung 0 with one clean cross-check and launch B1 (B3);
    (b) an EngineSupervisor over the real strict engine behind
    :class:`_Faulty` with an injected clock: the raise degrades to the host
    twin, the probe after the backoff re-promotes and launches B1, and the
    flip is caught by the cross-check."""
    device = torch.device(device)
    on_card = int(device.type == "cuda")  # the CPU rehearsal launches nothing
    signers, groups, expected, forged = catch_up_chunk(decisions)
    keys = {s.node_id: s.public_bytes for s in signers}
    out: dict = {"votes": decisions * QUORUM, "forged": forged}

    for label, config in (
        ("strict", Configuration(engine_supervision=True, engine_crosscheck_interval=1)),
        ("randomized", Configuration(engine_supervision=True, engine_crosscheck_interval=1,
                                     batch_verify_mode=True)),
    ):
        provider = InMemoryProvider()
        sup = engine_for_config(config, device=device, metrics=Metrics(provider))
        twin = _timed(sup)
        verifier = SigOnlyVerifier(keys, engine=sup)
        _reset_launch_counts()
        t0 = time.perf_counter()
        got = verifier.verify_consenter_sigs_multi_batch(groups)
        seconds = time.perf_counter() - t0
        launches = _launch_counts()
        dump = _engine_dump(provider)
        if got != expected:
            raise AssertionError(f"supervised {label} chunk: verdicts differ from the construction")
        if sup.rung != 0 or dump[ENGINE_RUNG_KEY] != 0 or sup.health.suspect:
            raise AssertionError(f"supervised {label} chunk left rung 0: {dump}")
        if (dump[ENGINE_CROSSCHECK_KEY], dump[ENGINE_CROSSCHECK_MISMATCH_KEY]) != (1, 0):
            raise AssertionError(f"supervised {label} chunk: cross-checks {dump}")
        degrades = sum(v for k, v in dump.items() if k.startswith(ENGINE_DEGRADE_KEY))
        if degrades or dump[ENGINE_RECOVERED_KEY] or len(twin.seconds) != 1:
            raise AssertionError(f"supervised {label} chunk degraded: {dump}")
        kernel = 2 if label == "randomized" else 0
        if bool(launches[kernel]) != bool(on_card) or sum(launches) != launches[kernel]:
            raise AssertionError(f"supervised {label} chunk: kernel launches {launches}")
        out[label] = {"launches": launches, "crosscheck_s": twin.seconds[0],
                      "call_ms": seconds * 1e3, "engine": dump}

    # (b) injected faults, clock injected.
    provider = InMemoryProvider()
    clock = [0.0]
    faulty = _Faulty(engine_for_config(Configuration(), device=device))
    sup = EngineSupervisor([faulty], clock=lambda: clock[0], crosscheck_interval=1,
                           metrics=Metrics(provider), name="chip-smoke-engine")
    twin = _timed(sup)
    verifier = SigOnlyVerifier(keys, engine=sup)
    steps = []
    for step, at in (("raise", 0.0), ("probe", sup.breakers["launch_raise"].backoff_initial + 1.0),
                     ("flip", sup.breakers["launch_raise"].backoff_initial + 1.0)):
        clock[0] = at
        _reset_launch_counts()
        host_before = len(twin.seconds)
        got = verifier.verify_consenter_sigs_multi_batch(groups)
        if got != expected:
            raise AssertionError(f"injected {step}: the verdicts served differ from the construction")
        steps.append({"step": step, "rung": sup.rung, "launches": _launch_counts(),
                      "host_s": twin.seconds[host_before:], "engine": _engine_dump(provider)})
    raise_, probe, flip = steps
    degrade_raise = f"{ENGINE_DEGRADE_KEY}{{launch_raise}}"
    degrade_flip = f"{ENGINE_DEGRADE_KEY}{{wrong_answer}}"
    if raise_["rung"] != 1 or raise_["engine"].get(degrade_raise) != 1 or sum(raise_["launches"]):
        raise AssertionError(f"injected raise: not one degrade to the host twin: {raise_}")
    if probe["rung"] != 0 or probe["engine"][ENGINE_RECOVERED_KEY] != 1 or probe["launches"][0] != on_card:
        raise AssertionError(f"injected raise: the probe did not re-promote and launch B1: {probe}")
    if (flip["engine"][ENGINE_CROSSCHECK_MISMATCH_KEY] != 1 or flip["engine"].get(degrade_flip) != 1
            or flip["rung"] != 1 or flip["launches"][0] != on_card):
        raise AssertionError(f"injected flip: not caught by the cross-check: {flip}")
    if flip["engine"][degrade_raise] != 1 or flip["engine"][ENGINE_RECOVERED_KEY] != 1:
        raise AssertionError(f"injected faults booked more than one degrade each: {flip}")
    out["faults"] = steps
    return out


# --- the protocol core: phase 12 (a config-3 cluster ordering blocks) ---------


class _BlockClocks:
    """WAL fsync and collector pause time while installed: ``os.fsync``
    wrapped in a timer (the WAL calls it through the ``os`` module) and a
    ``gc.callbacks`` entry timing each collection from its start to its
    stop.  Lives here, not in the copied protocol modules."""

    def __init__(self) -> None:
        self.fsync_s = self.gc_s = 0.0
        self.fsyncs = self.collections = 0
        self._lock = threading.Lock()
        self._gc_t0: float | None = None

    def __enter__(self) -> "_BlockClocks":
        self._fsync = real = os.fsync

        def timed_fsync(fd):
            t0 = time.perf_counter()
            try:
                return real(fd)
            finally:
                with self._lock:
                    self.fsync_s += time.perf_counter() - t0
                    self.fsyncs += 1

        os.fsync = timed_fsync
        gc.callbacks.append(self._on_gc)
        return self

    def __exit__(self, *exc) -> None:
        os.fsync = self._fsync
        gc.callbacks.remove(self._on_gc)

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            with self._lock:
                self.gc_s += time.perf_counter() - self._gc_t0
                self.collections += 1
            self._gc_t0 = None

    def read(self) -> tuple[float, int, float, int]:
        with self._lock:
            return self.fsync_s, self.fsyncs, self.gc_s, self.collections


def _cluster_engine(engine, clocks: _BlockClocks):
    """``engine``, its class swapped for a subclass that counts and times
    each of its calls: a device call where the batch reaches
    ``min_device_batch``, else a host-path call (``_verify_host``), each with
    the replica whose proposal wave it was, if any, and the collector pauses
    ``clocks`` saw inside it.  The count lives here, not in the package."""
    base = type(engine)

    class ClusterEngine(base):
        def verify_batch(self, messages, signatures, public_keys):
            gc_before = self.clocks.read()[2]
            t0 = time.perf_counter()
            out = super().verify_batch(messages, signatures, public_keys)
            device = len(messages) >= self._min_device_batch
            self.calls.append({
                "device": device, "n": len(messages),
                "s": time.perf_counter() - t0, "wave_of": self.wave_of,
                "gc_s": self.clocks.read()[2] - gc_before,
            })
            if device and self.wave_of is not None and not self.wave_of[1]:
                self.follower_wave = (list(messages), list(signatures), list(public_keys))
            return out

    ClusterEngine.__name__ = base.__name__
    engine.__class__ = ClusterEngine
    engine.clocks = clocks
    engine.calls = []
    engine.wave_of = None  # (node id, leader?) while a proposal wave runs
    engine.follower_wave = None  # the inputs of the last follower wave
    return engine


_SIGNED: dict = {}


def _signed_requests(blocks: int, requests: int, clients: int):
    """The cluster phases' client keyring and ``blocks`` x ``requests``
    signed requests, signed once per process, so phase 17 orders the very
    requests phase 12 ordered; and whether any were signed by this call,
    and how many seconds that took."""
    keyring, raws = _SIGNED.get((requests, clients), (None, []))
    if keyring is None:
        keyring = ClientKeyring([Ed25519Signer(1000 + c, (1000 + c).to_bytes(32, "big"))
                                 for c in range(clients)])
    fresh = len(raws) < blocks
    t0 = time.perf_counter()
    raws = raws + [[keyring.make_request(r % clients, b * requests + r) for r in range(requests)]
                   for b in range(len(raws), blocks)]
    _SIGNED[(requests, clients)] = (keyring, raws)
    return keyring, raws[:blocks], fresh, time.perf_counter() - t0


class _WaveApp(SignedRequestApp):
    """SignedRequestApp marking its fused proposal wave (the proposal's
    request signatures and the previous decision's commit certificate in one
    engine call) on the engine, so each device call can be told apart."""

    def verify_proposal_and_prev_commits(self, proposal, prev_commits, prev_proposal):
        leader = self.cluster.nodes[self.node_id].consensus.get_leader_id()
        self._engine.wave_of = (self.node_id, leader == self.node_id)
        try:
            return super().verify_proposal_and_prev_commits(proposal, prev_commits, prev_proposal)
        finally:
            self._engine.wave_of = None


def phase_cluster(device, replicas: int = REPLICAS, requests: int = REQUESTS,
                  blocks: int = CLUSTER_BLOCKS, clients: int = CLUSTER_CLIENTS,
                  min_device_batch: int = CLUSTER_MIN_DEVICE_BATCH,
                  config: Configuration | None = None) -> dict:
    """``replicas`` SignedRequestApp replicas of the port's ``Cluster`` on
    the simulated network, wired as benchmarks/chain_crypto_tps.py wires
    its device mode without the coalescer: one engine on ``device`` shared
    by every replica, an Ed25519 signer per replica, ``clients`` client
    keys, 1,000-request batches, no leader rotation, a file WAL per replica
    at the default segment size.  ``blocks`` blocks of ``requests`` signed
    requests each; the first is warm-up, the rest are measured.

    The engine is the strict ``Ed25519BatchVerifier`` at
    ``min_device_batch``, or, given a ``config``, the one
    ``engine_for_config`` builds from it, with the cluster in the config's
    ``cert_mode``."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    phase_t0 = time.perf_counter()
    if config is None:
        engine = med.Ed25519BatchVerifier(device=device, min_device_batch=min_device_batch)
    else:
        engine = engine_for_config(config, device=device)
        min_device_batch = engine._min_device_batch
    clocks = _BlockClocks()
    engine = _cluster_engine(engine, clocks)
    fused = bool(getattr(engine, "fused", False))
    half_agg = config is not None and config.cert_mode == "half-agg"
    signers = {i: Ed25519Signer(i, bytes([i]) * 32) for i in range(1, replicas + 1)}
    keys = {i: s.public_bytes for i, s in signers.items()}
    keyring, raws, signed_now, sign_s = _signed_requests(blocks, requests, clients)
    tweaks = {"request_batch_max_count": requests, "request_batch_max_interval": 0.02,
              "request_pool_size": 3 * requests}
    if config is not None:
        tweaks["cert_mode"] = config.cert_mode
    ed.comb_table(device)  # the constant table is set-up, not part of a block

    with tempfile.TemporaryDirectory(prefix="chip-smoke-wal-") as wal_dir:
        cluster = Cluster(replicas, seed=SEED, config_tweaks=tweaks, wal_dir=wal_dir,
                          wal_segment_bytes=DEFAULT_SEGMENT_MAX_BYTES)
        for node_id, node in cluster.nodes.items():
            node.app = _WaveApp(node_id, cluster, signers[node_id],
                                SigOnlyVerifier(keys, engine=engine),
                                client_keys=keyring.public_keys, engine=engine)
        try:
            cluster.start()
            if on_card:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated() if on_card else None
            ledger_name = "ed25519.fused_verify" if fused else "ed25519.verify"
            verify_before = KERNELS.stats(ledger_name).launches
            _reset_launch_counts()
            block_log = []
            with clocks:
                for b in range(blocks):
                    first_call = len(engine.calls)
                    fsync0, fsyncs0, gc0, collections0 = clocks.read()
                    t0 = time.perf_counter()
                    for raw in raws[b]:
                        cluster.submit_to_all(raw)
                    if not cluster.run_until_ledger(b + 1, max_time=600.0):
                        raise AssertionError(f"block {b + 1} was not ordered")
                    if on_card:
                        torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    fsync1, fsyncs1, gc1, collections1 = clocks.read()
                    block = engine.calls[first_call:]
                    device_s = sum(c["s"] for c in block if c["device"])
                    host_s = sum(c["s"] for c in block if not c["device"])
                    # The rest of the block: WAL fsyncs, collector pauses
                    # outside the engine's calls (those inside are in the
                    # calls' own time), and what is left.
                    fsync_s = fsync1 - fsync0
                    gc_s = (gc1 - gc0) - sum(c["gc_s"] for c in block)
                    block_log.append({
                        "wall_ms": wall * 1e3, "device_ms": device_s * 1e3, "host_ms": host_s * 1e3,
                        "rest_ms": (wall - device_s - host_s) * 1e3,
                        "fsync_ms": fsync_s * 1e3, "fsyncs": fsyncs1 - fsyncs0,
                        "gc_ms": gc_s * 1e3, "collections": collections1 - collections0,
                        "left_ms": (wall - device_s - host_s - fsync_s - gc_s) * 1e3,
                        "device_calls": sum(c["device"] for c in block),
                        "host_calls": sum(not c["device"] for c in block),
                        "host_sigs": sum(c["n"] for c in block if not c["device"]),
                    })
            launches = _launch_counts()
            s1_launches = _s1_launches()
            d_launches = _d_launches()
            verify_calls = KERNELS.stats(ledger_name).launches - verify_before
            calls = list(engine.calls)
            peak = torch.cuda.max_memory_allocated() if on_card else None
            ledgers = {i: list(n.app.ledger) for i, n in cluster.nodes.items()}
            views = {n.consensus.controller.curr_view_number for n in cluster.nodes.values()}
        finally:
            for node in cluster.nodes.values():
                if node.consensus is not None:
                    node.consensus.stop()
                if node.wal is not None:
                    node.wal.close()
        wal_bytes = sum(f.stat().st_size for f in Path(wal_dir).rglob("*.wal"))

    # All replicas ordered the same blocks, each with every request.
    digests = {i: [d.proposal.digest() for d in ledger] for i, ledger in ledgers.items()}
    if any(len(v) != blocks for v in digests.values()) or len({tuple(v) for v in digests.values()}) != 1:
        raise AssertionError(f"the replicas' ledgers differ: {digests}")
    for d in ledgers[1]:
        if int.from_bytes(d.proposal.payload[:4], "big") != requests:
            raise AssertionError("a block does not carry its 1,000 requests")
    if views != {0}:
        raise AssertionError(f"the cluster changed view: {views}")
    quorum = 2 * ((replicas - 1) // 3) + 1
    if min(len(d.signatures) for ledger in ledgers.values() for d in ledger) < quorum:
        raise AssertionError(f"a decision carries fewer than {quorum} commit signatures")
    if half_agg:
        # Every decision carries a half-aggregated certificate of 2f+1
        # components that verifies on the host twin under the registered keys.
        host_twin = HalfAggregator(min_device_batch=10**9, device=device)
        certs = [d for ledger in ledgers.values() for d in ledger]
        for d in certs:
            cert = d.signatures
            if not isinstance(cert, QuorumCert):
                raise AssertionError(f"a decision carries {type(cert).__name__}, not a QuorumCert")
            if not host_twin.verify([commit_message(d.proposal, c.msg) for c in cert],
                                    list(cert.rs), cert.s_agg, [keys[c.id] for c in cert]):
                raise AssertionError("a decided certificate fails the host twin")
        votes, sample = certs, []
    else:
        # Every decision carries 2f+1 commit signatures that verify under the
        # registered keys: all on the engine, a sample on the RFC 8032
        # reference.
        votes = [(commit_message(d.proposal, s.msg), s.value, keys[s.id])
                 for ledger in ledgers.values() for d in ledger for s in d.signatures]
        if not engine.verify_batch(*map(list, zip(*votes))).all():
            raise AssertionError("a decision carries a commit signature that does not verify")
        rng = np.random.default_rng(SEED + 12)
        sample = rng.choice(len(votes), size=min(8, len(votes)), replace=False)
        for i in sample:
            msg, sig, key = votes[i]
            if not med.ref_verify(key, sig, msg):
                raise AssertionError(f"commit signature {i} fails the RFC 8032 reference")

    # The device calls: each replica's proposal wave, nothing else; B1, D1
    # and D2 (and S1 on the fused engine) once per device call on the card
    # (the CPU runs the plain versions), B2 and B3 never.
    device_calls = [c for c in calls if c["device"]]
    others = [c for c in device_calls if c["wave_of"] is None]
    if others:
        raise AssertionError(f"device calls outside a proposal wave: {[c['n'] for c in others]}")
    followers = [c for c in device_calls if not c["wave_of"][1]]
    if verify_calls != len(device_calls):
        raise AssertionError(f"{len(device_calls)} engine calls of >= {min_device_batch} signatures "
                             f"but {verify_calls} device calls in the kernel ledger")
    if launches[0] != (len(device_calls) if on_card else 0) or launches[1] or launches[2]:
        raise AssertionError(f"kernel launches {launches} for {len(device_calls)} device calls")
    if s1_launches != (len(device_calls) if on_card and fused else 0):
        raise AssertionError(f"S1 launches {s1_launches} for {len(device_calls)} device calls")
    if d_launches != ((len(device_calls),) * 2 if on_card else (0, 0)):
        raise AssertionError(f"D1, D2 launches {d_launches} for {len(device_calls)} device calls")
    if len(followers) < (replicas - 1) * blocks:
        raise AssertionError(f"{len(followers)} follower waves for {blocks} blocks of {replicas} replicas")
    # The stages of the last follower wave, read off a profiled re-run of
    # its engine call after the counts were read.
    prof = profile_wave(engine, *engine.follower_wave, device,
                        wave_ranges=FUSED_RANGES if fused else WAVE_RANGES)
    if not prof.pop("verdicts").all():
        raise AssertionError("the profiled re-run of a follower wave rejected a signature")
    if fused:
        # S1 against its plain version at this phase's own width, on the last
        # follower wave's blocks as the engine packs them (phase 12 holds B1
        # to its plain version at the same width).
        _, _, blocks_t, n_blocks_t, _ = engine._device_args(*engine.follower_wave)
        scan = {"kernel": "sha512", "lanes": n_blocks_t.shape[0], "blocks": blocks_t.shape[0],
                "max_abs_err": _check_sha512(blocks_t, n_blocks_t)}
    else:
        # B1 against its plain version at this phase's own width, on the last
        # follower wave's scan inputs as the engine builds them.
        neg_a, k_digits = wave_scan_inputs(engine, *engine.follower_wave)
        scan = {"kernel": "horner_scan", "lanes": k_digits.shape[1],
                "max_abs_err": _check_horner(neg_a, k_digits),
                "ms": _time_ms(lambda: scan_kernels.horner_scan(*neg_a, k_digits), 20, device),
                "plain_ms": _time_ms(
                    lambda: scan_kernels.horner_scan_reference(*neg_a, k_digits), 3, device)}
    measured = block_log[1:] or block_log
    return {
        "replicas": replicas, "requests": requests, "blocks": blocks, "clients": clients,
        "min_device_batch": min_device_batch, "block_log": block_log,
        "device_calls": len(device_calls), "follower_waves": len(followers),
        "leader_waves": len(device_calls) - len(followers),
        "wave_sizes": sorted({c["n"] for c in device_calls}),
        "padded": sorted({engine.padded_size(c["n"]) for c in device_calls}),
        "wave_ms": [c["s"] * 1e3 for c in device_calls],
        "host_calls": sum(b["host_calls"] for b in block_log),
        "host_sigs": sum(b["host_sigs"] for b in block_log),
        "launches": launches, "s1_launches": s1_launches, "d_launches": d_launches,
        "fused": fused,
        "half_agg": half_agg, "quorum": quorum, "votes_checked": len(votes),
        "reference_checked": len(sample),
        "tx_per_s": requests * len(measured) / sum(b["wall_ms"] / 1e3 for b in measured),
        "peak_bytes": peak, "held_bytes": held, "profiled": prof,
        "profiled_sigs": len(engine.follower_wave[0]), "scan": scan,
        "sign_s": sign_s, "signed_now": signed_now, "wal_bytes": wal_bytes,
        "phase_s": time.perf_counter() - phase_t0,
    }


# --- kernels D1 (decompression) and D2 (the comb): phase 18 --------------------


def _products_or_bytes(products: int, n_bytes: int, sm_count: int, sm_clock_hz: float) -> dict:
    """Least time for ``products`` 32x32->64-bit products over the card's
    IMAD rate and ``n_bytes`` over its memory rate: the larger bounds."""
    ops_ms = products / (sm_count * IMAD_PER_CLOCK_PER_SM * sm_clock_hz) * 1e3
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "products": products, "bytes": n_bytes, "ops_ms": ops_ms, "bytes_ms": bytes_ms}


def decompress_bound(points: int, sm_count: int, sm_clock_hz: float) -> dict:
    """D1 at ``points`` points: its field products (DECOMPRESS_MULS and
    DECOMPRESS_SQUARES a point), and its bytes: (32,) f32 y limbs and an
    int32 sign in, four (32,) f32 coordinates and a mask byte out."""
    products = (DECOMPRESS_MULS * MUL_PRODUCTS + DECOMPRESS_SQUARES * SQUARE_PRODUCTS) * points
    n_bytes = points * (fe.LIMBS * 4 + 4) + points * (4 * fe.LIMBS * 4 + 1)
    return _products_or_bytes(products, n_bytes, sm_count, sm_clock_hz)


def comb_bound(digits: torch.Tensor, sm_count: int, sm_clock_hz: float) -> dict:
    """D2 on ``digits`` ((32, n) int32): COMB_MULS field products a lane,
    and its bytes: the digits in, four (32,) f32 coordinates a lane out, and
    each table entry these digits pick read once."""
    lanes = digits.shape[1]
    windows = torch.arange(digits.shape[0], device=digits.device)[:, None]
    entries = int(torch.unique(windows * 256 + digits.to(torch.int64)).numel())
    n_bytes = lanes * fe.LIMBS * 4 + entries * COMB_ENTRY_BYTES + lanes * 4 * fe.LIMBS * 4
    out = _products_or_bytes(COMB_MULS * MUL_PRODUCTS * lanes, n_bytes, sm_count, sm_clock_hz)
    out["entries"] = entries
    return out


def _check_decompress(y: torch.Tensor, sign: torch.Tensor) -> float:
    """decompress (D1 on CUDA) against decompress_reference on the same
    inputs: the valid masks equal and frozen X, Y, Z, T equal on every lane,
    valid or not, tolerance 0.  Returns the max abs err."""
    got, ok = scan_kernels.decompress(y, sign)
    want, want_ok = scan_kernels.decompress_reference(y, sign)
    if not torch.equal(ok, want_ok):
        raise AssertionError(
            f"decompress25519: the valid mask differs on {int((ok != want_ok).sum())} lanes"
        )
    return _frozen_max_err("decompress25519", got, want)


def _check_comb(digits: torch.Tensor) -> float:
    """fixed_base_mul_comb (D2 on CUDA) against its plain version on the
    same digits: frozen X, Y, Z, T equal on every lane, tolerance 0."""
    return _frozen_max_err(
        "comb25519", scan_kernels.fixed_base_mul_comb(digits),
        scan_kernels.fixed_base_mul_comb_reference(digits),
    )


def _launch_ms(kind: str, args, reps: int, device) -> float:
    """Mean milliseconds of one D1 (``kind`` "decompress"), D2 ("comb") or
    S1 ("sha512") launch alone: ``reps`` launches back to back on
    preallocated outputs, timed with CUDA events.  A wrapper's own host work
    (its checks, the output allocation) takes about as long as these kernels
    run, so a loop of wrapper calls leaves the card idle between launches."""
    width, int_args = args[0].shape[-1], ()
    if kind == "decompress":
        name, inputs = "decompress25519", args
        outs = [torch.empty_like(args[0]) for _ in range(4)]
        outs.append(torch.empty(width, dtype=torch.bool, device=device))
    elif kind == "comb":
        name, inputs = "comb25519", (scan_kernels.comb_niels_table(device), args[0])
        outs = [torch.empty((fe.LIMBS, width), dtype=torch.float32, device=device)
                for _ in range(4)]
    else:
        name, inputs, int_args = "sha512", args, (args[0].shape[0],)
        outs = [torch.empty((8, 2, width), dtype=torch.int32, device=device)]
    return _time_ms(lambda: scan_kernels._launch(name, inputs, outs, width, device, int_args),
                    reps, device)


def phase_decompress_comb(device, corpus, replicas: int, reps: int, plain_reps: int,
                          sub_lanes: int = CATCH_UP_LANES,
                          cluster_lanes: int = CLUSTER_LANES) -> dict:
    """D1 and D2 against their plain versions on the strict wave's own
    inputs as the engine packs them (``replicas`` copies of ``corpus``):
    D1 on the R || A stack of every lane (phase 3's wave: 16,384 points), of
    the first ``cluster_lanes`` lanes and of the first ``sub_lanes``, D2 on
    every lane's S digits, on the first ``cluster_lanes`` lanes' and on one
    lane; each kernel timed over ``reps`` calls of its wrapper after its
    check (``ms``, as every other kernel is timed) and over ``reps`` of its
    launches alone (``launch_ms``; on the CPU the wrapper's plain version
    again), the plain version over ``plain_reps`` calls."""
    device = torch.device(device)
    engine = med.Ed25519BatchVerifier(device=device)
    y_r, sign_r, y_a, sign_a, s_digits8, _, _ = engine.prepare_device_inputs(
        *replica_wave(corpus, replicas)[:3]
    )
    lanes = y_r.shape[1]
    cols = min(sub_lanes, lanes)
    wide = min(cluster_lanes, lanes)

    def stack(c: int):
        return (torch.cat([y_r[:, :c], y_a[:, :c]], dim=-1).to(torch.float32).contiguous(),
                torch.cat([sign_r[:c], sign_a[:c]]).to(torch.int32).contiguous())

    digits = s_digits8.to(torch.int32).contiguous()
    cases = {
        "d1": ("decompress", stack(lanes)), "d1_cluster": ("decompress", stack(wide)),
        "d1_sub": ("decompress", stack(cols)),
        "d2": ("comb", (digits,)), "d2_cluster": ("comb", (digits[:, :wide].contiguous(),)),
        "d2_one": ("comb", (digits[:, :1].contiguous(),)),
    }
    kernels = {
        "decompress": (_check_decompress, scan_kernels.decompress,
                       scan_kernels.decompress_reference),
        "comb": (_check_comb, scan_kernels.fixed_base_mul_comb,
                 scan_kernels.fixed_base_mul_comb_reference),
    }
    out = {"lanes": lanes, "sub_lanes": cols, "cluster_lanes": wide}
    for key, (kind, args) in cases.items():
        check, kernel, plain = kernels[kind]
        out[key] = {"width": args[0].shape[-1], "inputs": args, "max_abs_err": check(*args)}
        out[key]["ms"] = _time_ms(lambda: kernel(*args), reps, device)
        out[key]["launch_ms"] = (_launch_ms(kind, args, reps, device) if device.type == "cuda"
                                 else out[key]["ms"])
        out[key]["plain_ms"] = _time_ms(lambda: plain(*args), plain_reps, device)
    out["invalid_points"] = int((~scan_kernels.decompress_reference(*cases["d1"][1])[1]).sum())
    return out


# --- the fused front end and half-aggregated certs: phases 13-17 ---------------


def _check_sha512(blocks: torch.Tensor, n_blocks: torch.Tensor) -> int:
    """sha512_blocks (S1 on CUDA) against sha512_blocks_reference on the same
    inputs: the state equal on every lane, tolerance 0.  Returns the max abs
    err of the 32-bit words."""
    got = sh.sha512_blocks(blocks, n_blocks)
    want = sh.sha512_blocks_reference(blocks, n_blocks)
    diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
    bad = torch.nonzero(diff.amax(dim=(0, 1))).flatten()
    if bad.numel():
        raise AssertionError(
            f"sha512: the state differs from the plain version on {bad.numel()} of "
            f"{n_blocks.shape[0]} lanes (first {bad[:8].tolist()})"
        )
    return int(diff.max())


def _prehash(message: bytes, signature: bytes, key: bytes) -> bytes:
    """R || A || M as the fused engine hashes it (a signature or key of the
    wrong length stands as zeros)."""
    sig = bytes(signature) if len(signature) == 64 else b"\x00" * 64
    key = bytes(key) if len(key) == 32 else b"\x00" * 32
    return sig[:32] + key + bytes(message)


def root_message(msgs, sigs, keys) -> bytes:
    """The randomized transcript's root message over the lanes that pass the
    host pre-checks (the first aggregate check's live lanes):
    ``tag || n || leaf digests``, the leaves hashed with hashlib."""
    live = np.flatnonzero(canonical_ok_fast(sigs, keys)).tolist()
    leaves = [hashlib.sha512(frame(msgs[i]) + frame(sigs[i]) + frame(keys[i])).digest()
              for i in live]
    return med._Z_TAG + len(live).to_bytes(8, "little") + b"".join(leaves)


def sass_block_loop(library: str, kernel: str = "sha512_kernel") -> dict:
    """S1's instructions per block, from ``cuobjdump -sass`` of its library:
    the instructions of the kernel's outermost loop (from the target of its
    widest backward branch to the branch), which runs once per 128-byte
    block, and of the whole kernel."""
    cuobjdump = Path(scan_kernels._nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(cuobjdump), "-sass", library], capture_output=True,
                         text=True, check=True).stdout
    body, inside = [], False
    for line in out.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if inside and m:
            body.append((int(m.group(1), 16), m.group(2)))
    loops = []
    for addr, text in body:
        m = re.search(r"\bBRA\s+(?:\S+\s+)?0x([0-9a-f]+)", text)
        if m and int(m.group(1), 16) < addr:
            loops.append((addr - int(m.group(1), 16), int(m.group(1), 16), addr))
    if not body or not loops:
        raise AssertionError(f"sass: no block loop found in {kernel}")
    _, start, end = max(loops)
    per_block = sum(1 for addr, _ in body if start <= addr <= end)
    real = [t for _, t in body if t != "NOP"]
    return {"per_block": per_block, "kernel": len(real), "loop": (hex(start), hex(end))}


def sha512_bound(n_blocks: np.ndarray, sm_count: int, sm_clock_hz: float,
                 latency_cycles: float) -> dict:
    """Least time for SHA-512's work on lanes with ``n_blocks`` blocks each,
    whatever kernel does it: the larger of
    - its integer instructions (SHA512_BLOCK_OPS a block, times the blocks
      this data needs) at 64 results per clock per SM over every SM;
    - the longest lane's chain: its blocks x 80 rounds x SHA512_CHAIN_DEPTH
      dependent instructions, each ``latency_cycles`` (measured by
      ``dependent_issue_cycles``), since a lane's blocks and rounds run in
      order;
    - its bytes (the blocks read, the counts read, the state written) over
      the memory rate."""
    blocks = int(n_blocks.sum())
    lanes = int(n_blocks.shape[0])
    instructions = SHA512_BLOCK_OPS * blocks
    ops_ms = instructions / (sm_count * INT_PER_CLOCK_PER_SM * sm_clock_hz) * 1e3
    chain = int(n_blocks.max(initial=0)) * 80 * SHA512_CHAIN_DEPTH
    chain_ms = chain * latency_cycles / sm_clock_hz * 1e3
    n_bytes = blocks * sh.BLOCK_BYTES + 4 * lanes + 64 * lanes
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, chain_ms, bytes_ms)
    bound_by = "bytes" if bound_ms == bytes_ms else "operations"
    return {"bound_ms": bound_ms, "bound_by": bound_by, "blocks": blocks,
            "instructions": instructions, "ops_ms": ops_ms, "chain": chain,
            "chain_ms": chain_ms, "bytes": n_bytes, "bytes_ms": bytes_ms}


def sass_issue_ms(n_blocks: np.ndarray, per_block: int, sm_clock_hz: float) -> float:
    """S1's former yardstick, printed beside the bound and no longer the
    bound: the longest lane's blocks x the kernel's block loop
    (``per_block`` SASS instructions) issued in order at one a clock.  It
    moves with the kernel's design: a kernel that moves work off the loop
    lowers it."""
    return per_block * int(n_blocks.max(initial=0)) / sm_clock_hz * 1e3


def build_latency_probe() -> scan_kernels.BuildInfo:
    """Build LATENCY_PROBE_SOURCE with nvcc for ``sm_90a`` into the kernels'
    build directory (keyed by the source's hash, as the kernels are)."""
    tag = hashlib.sha256(LATENCY_PROBE_SOURCE.encode()).hexdigest()[:16]
    library = scan_kernels.BUILD_DIR / f"chain_probe-{tag}.so"
    if library.is_file():
        return scan_kernels.BuildInfo(str(library), "", 0.0, "", True)
    scan_kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    source = scan_kernels.BUILD_DIR / f"chain_probe-{tag}-{os.getpid()}.cu"
    source.write_text(LATENCY_PROBE_SOURCE)
    tmp = library.with_name(f".{library.name}-{os.getpid()}")
    cmd = scan_kernels.nvcc_command(source, tmp)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    source.unlink()
    report = (proc.stdout + proc.stderr).strip()
    if proc.returncode:
        raise RuntimeError(f"chain probe: nvcc failed:\n{report}")
    os.replace(tmp, library)
    return scan_kernels.BuildInfo(str(library), " ".join(cmd), seconds, report, False)


def dependent_issue_cycles(library: str, device, steps: int = 1 << 16) -> dict:
    """The card's dependent-issue latency, in SM clocks per instruction, over
    SHA512_CHAIN_DEPTH-instruction steps of S1's chain: the probe's clock64()
    cycles for 2 ``steps`` less those for ``steps`` (the least of three runs
    each, so the launch and the clock reads cancel), over ``steps`` x 4."""
    probe = ctypes.CDLL(library).chain_probe_launch
    probe.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    probe.restype = ctypes.c_int
    words = np.random.default_rng(SEED).integers(0, 2**31, 6).astype(np.int32)
    inputs = torch.from_numpy(words).to(device)
    out = torch.zeros(3, dtype=torch.int64, device=device)

    def cycles(n: int) -> int:
        code = probe(inputs.data_ptr(), out.data_ptr(), n,
                     torch.cuda.current_stream(device).cuda_stream)
        if code:
            raise RuntimeError(f"chain probe: launch failed ({code})")
        torch.cuda.synchronize(device)
        return int(out[0])

    cycles(steps)
    short = min(cycles(steps) for _ in range(3))
    long = min(cycles(2 * steps) for _ in range(3))
    return {"cycles": (long - short) / (steps * SHA512_CHAIN_DEPTH), "steps": steps,
            "short": short, "long": long}


#: S1's widths in phase 13 besides the strict wave's (8,192 lanes, 2
#: blocks) and the transcript root (one lane, 3,431 blocks): the same lanes'
#: first blocks alone (the randomized transcript's leaves and coefficients
#: take 1-2 blocks a lane), a certificate's 8 lanes, and a long-lane set the
#: plain version can finish (16 lanes of up to 40 blocks).
S1_CERT_LANES = 8
S1_LONG_LANES = 16
S1_LONG_BLOCKS = 40


def long_lane_messages(lanes: int, blocks: int, seed: int = SEED) -> list[bytes]:
    """``lanes`` random messages of 1 to ``blocks`` padded blocks (the first
    exactly ``blocks``), from a numpy seed."""
    rng = np.random.default_rng(seed)
    top = blocks * sh.BLOCK_BYTES - 17
    lengths = [top] + rng.integers(0, top + 1, lanes - 1).tolist()
    return [rng.bytes(int(n)) for n in lengths]


def phase_sha512(device, corpus, rand_corpus, replicas: int, reps: int, plain_reps: int,
                 long_lanes: int = S1_LONG_LANES, long_blocks: int = S1_LONG_BLOCKS) -> dict:
    """S1 against its plain version and hashlib at every width it runs:
    (1) on the strict wave's challenge blocks (``R || A || M`` of every lane
    of ``corpus``'s wave, packed by the fused engine, padded lanes included),
    tolerance 0, every live lane's digest equal to ``hashlib.sha512``; (2)
    the same lanes' first blocks alone, the first S1_CERT_LANES lanes, and
    ``long_lanes`` messages of up to ``long_blocks`` blocks, each at
    tolerance 0 (the long ones against hashlib too); (3) one lane holding the
    randomized wave's transcript root message, against hashlib only (the
    plain version runs its thousands of blocks one after another, each some
    8,000 eager torch calls).  Each width timed with CUDA events through the
    wrapper (``ms``, as every kernel is timed) and as launches alone
    (``launch_ms``; on the CPU the wrapper's plain version again)."""
    device = torch.device(device)

    def timed(blocks, n_blocks, calls: int) -> dict:
        ms = _time_ms(lambda: sh.sha512_blocks(blocks, n_blocks), calls, device)
        launch_ms = (_launch_ms("sha512", (blocks, n_blocks), calls, device)
                     if device.type == "cuda" else ms)
        # The blocks each lane absorbs: its count, cut to the block axis.
        absorbed = np.clip(n_blocks.cpu().numpy(), 0, blocks.shape[0])
        return {"lanes": n_blocks.shape[0], "block_axis": blocks.shape[0],
                "n_blocks": absorbed, "ms": ms, "launch_ms": launch_ms}

    msgs, sigs, keys, _ = replica_wave(corpus, replicas)
    engine = FusedEd25519BatchVerifier(device=device)
    _, _, blocks, n_blocks, _ = engine._device_args(msgs, sigs, keys)
    max_err = _check_sha512(blocks, n_blocks)
    digest = sh.digest_bytes(sh.sha512_blocks(blocks, n_blocks)).cpu().numpy().astype(np.uint8)
    for i, (m, s, k) in enumerate(zip(msgs, sigs, keys)):
        if bytes(digest[:, i]) != hashlib.sha512(_prehash(m, s, k)).digest():
            raise AssertionError(f"sha512: lane {i}'s digest differs from hashlib's")
    widths = {"wave": {**timed(blocks, n_blocks, reps), "max_abs_err": max_err}}
    plain_ms = _time_ms(lambda: sh.sha512_blocks_reference(blocks, n_blocks), plain_reps, device)

    lmsgs = long_lane_messages(long_lanes, long_blocks)
    lblocks, ln = sh.pad_messages(lmsgs)
    lblocks, ln = sh.blocks_tensor(lblocks).to(device), torch.from_numpy(ln).to(device)
    cases = {
        "one_block": (blocks[:1].contiguous(), n_blocks),
        "certs": (blocks[..., :S1_CERT_LANES].contiguous(),
                  n_blocks[:S1_CERT_LANES].contiguous()),
        "long": (lblocks, ln),
    }
    for key, (b, n) in cases.items():
        err = _check_sha512(b, n)
        widths[key] = {**timed(b, n, reps), "max_abs_err": err}
    got = sh.digest_bytes(sh.sha512_blocks(lblocks, ln)).cpu().numpy().astype(np.uint8)
    for i, m in enumerate(lmsgs):
        if bytes(got[:, i]) != hashlib.sha512(m).digest():
            raise AssertionError(f"sha512: long lane {i}'s digest differs from hashlib's")

    rmsgs, rsigs, rkeys, _ = replica_wave(rand_corpus, replicas)
    root = root_message(rmsgs, rsigs, rkeys)
    rblocks, rn = sh.pad_messages([root])
    rblocks = sh.blocks_tensor(rblocks).to(device)
    rn_t = torch.from_numpy(rn).to(device)
    got = sh.digest_bytes(sh.sha512_blocks(rblocks, rn_t)).cpu().numpy().astype(np.uint8)
    if bytes(got[:, 0]) != hashlib.sha512(root).digest():
        raise AssertionError("sha512: the transcript root differs from hashlib's")
    widths["root"] = timed(rblocks, rn_t, 5)
    return {
        "lanes": n_blocks.shape[0], "live": len(msgs), "block_axis": blocks.shape[0],
        "n_blocks": widths["wave"]["n_blocks"], "max_abs_err": max_err,
        "ms": widths["wave"]["ms"], "launch_ms": widths["wave"]["launch_ms"],
        "plain_ms": plain_ms, "root_live": (len(root) - len(med._Z_TAG) - 8) // 64,
        "root_bytes": len(root), "root_blocks": int(rn[0]), "widths": widths,
    }


def phase_fused_wave(device, corpus, replicas: int, direct) -> dict:
    """The strict config-3 wave of ``corpus`` through
    ``engine_for_config(Configuration(device_prep=True))``: verdicts equal to
    ``direct`` (phase 3's host-prep engine) lane for lane, S1 and B1 launched
    once, B2 and B3 never; the host prep of both engines timed on the same
    wave; a profiled re-run; then three replicas' request waves through
    ``verify_stream``."""
    device = torch.device(device)
    engine = engine_for_config(Configuration(device_prep=True), device=device)
    if type(engine) is not FusedEd25519BatchVerifier:
        raise AssertionError(f"device_prep built {type(engine).__name__}")
    wave_msgs, wave_sigs, wave_keys, _ = replica_wave(corpus, replicas)
    t0 = time.perf_counter()
    engine._prepare_fused(wave_msgs, wave_sigs, wave_keys)
    fused_prep_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    med.Ed25519BatchVerifier(device=device)._prepare(wave_msgs, wave_sigs, wave_keys)
    host_prep_ms = (time.perf_counter() - t0) * 1e3

    # The main path, with the launch counts read around it.
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    calls_before = KERNELS.stats("ed25519.fused_verify").launches
    _reset_launch_counts()
    t0 = time.perf_counter()
    got = engine.verify_batch(wave_msgs, wave_sigs, wave_keys)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wave_s = time.perf_counter() - t0
    launches, s1, d_launches = _launch_counts(), _s1_launches(), _d_launches()
    calls = KERNELS.stats("ed25519.fused_verify").launches - calls_before
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else None
    if not np.array_equal(got, direct):
        wrong = np.flatnonzero(got != direct)
        raise AssertionError(f"fused verdicts differ from the host-prep engine's at {wrong[:16]}")

    prof = profile_wave(engine, wave_msgs, wave_sigs, wave_keys, device,
                        wave_ranges=FUSED_RANGES, kernel="horner_scan")
    if not np.array_equal(prof.pop("verdicts"), got):
        raise AssertionError("profiled re-run of the fused wave disagrees with the wave")

    n_requests = len(corpus[0])
    waves = [(wave_msgs[r * n_requests:(r + 1) * n_requests],
              wave_sigs[r * n_requests:(r + 1) * n_requests],
              wave_keys[r * n_requests:(r + 1) * n_requests]) for r in range(min(3, replicas))]
    s1_before = _s1_launches()
    t0 = time.perf_counter()
    streamed = list(engine.verify_stream(iter(waves)))
    stream_ms = (time.perf_counter() - t0) * 1e3
    stream_s1 = _s1_launches() - s1_before
    for r, out in enumerate(streamed):
        if not np.array_equal(out, direct[r * n_requests:(r + 1) * n_requests]):
            raise AssertionError(f"verify_stream: wave {r}'s verdicts differ")
    n = len(wave_msgs)
    return {
        "signatures": n, "padded": engine.padded_size(n), "rejected": int((~got).sum()),
        "wave_ms": wave_s * 1e3, "sigs_per_s": n / wave_s, "launches": launches, "s1": s1,
        "d_launches": d_launches, "calls": calls, "fused_prep_ms": fused_prep_ms, "host_prep_ms": host_prep_ms,
        "profiled": prof, "peak_bytes": peak, "stream_waves": len(waves),
        "stream_ms": stream_ms, "stream_s1": stream_s1,
    }


def phase_fused_randomized(device, corpus, replicas: int, direct) -> dict:
    """The randomized config-3 wave of ``corpus`` through
    ``engine_for_config(Configuration(device_prep=True,
    batch_verify_mode=True))``: verdicts equal to ``direct`` (phase 7's),
    the launch counts read around the run, a profiled re-run."""
    device = torch.device(device)
    config = Configuration(device_prep=True, batch_verify_mode=True)
    engine = engine_for_config(config, device=device)
    if type(engine) is not FusedEd25519RandomizedBatchVerifier:
        raise AssertionError(f"device_prep with batch_verify_mode built {type(engine).__name__}")
    wave_msgs, wave_sigs, wave_keys, _ = replica_wave(corpus, replicas)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    checks_before = KERNELS.stats("ed25519.fused_batch_verify").launches
    _reset_launch_counts()
    t0 = time.perf_counter()
    got = engine.verify_batch(wave_msgs, wave_sigs, wave_keys)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wave_s = time.perf_counter() - t0
    launches, s1, d_launches = _launch_counts(), _s1_launches(), _d_launches()
    checks = KERNELS.stats("ed25519.fused_batch_verify").launches - checks_before
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else None
    if not np.array_equal(got, direct):
        wrong = np.flatnonzero(got != direct)
        raise AssertionError(f"fused randomized verdicts differ from phase 7's at {wrong[:16]}")
    prof = profile_wave(engine, wave_msgs, wave_sigs, wave_keys, device,
                        wave_ranges=FUSED_BATCH_RANGES, kernel="straus_msm")
    if not np.array_equal(prof.pop("verdicts"), got):
        raise AssertionError("profiled re-run of the fused randomized wave disagrees")
    n = len(wave_msgs)
    return {"signatures": n, "padded": engine.padded_size(n), "rejected": int((~got).sum()),
            "wave_ms": wave_s * 1e3, "sigs_per_s": n / wave_s, "launches": launches,
            "s1": s1, "d_launches": d_launches, "checks": checks, "profiled": prof,
            "peak_bytes": peak}


def phase_halfagg_certs(device, decisions: int) -> dict:
    """Config 3's catch-up chunk as ``decisions`` half-aggregated
    certificates: each decision's honest 5-vote quorum aggregated through a
    ``SigOnlyVerifier`` over ``FusedEd25519BatchVerifier(min_device_batch=1)``
    (its ``HalfAggregator`` inherits the fused front end), then every cert
    verified on the card (one B3 launch each) and on the host twin, with a
    tampered ``s_agg`` rejected by both; then each of the chunk's 3 forged
    votes in its decision's otherwise honest quorum: the aggregate fails,
    bisection localizes exactly that signer, and the strict engine
    agrees."""
    device = torch.device(device)
    signers, groups, _, forged = catch_up_chunk(decisions)
    keys = {s.node_id: s.public_bytes for s in signers}
    engine = FusedEd25519BatchVerifier(device=device, min_device_batch=1)
    verifier = SigOnlyVerifier(keys, engine=engine)
    host = HalfAggregator(min_device_batch=10**9, device=device)
    honest = []
    for g, (proposal, votes) in enumerate(groups):
        votes = list(votes)
        for j, vote in enumerate(votes):
            if g * QUORUM + j in forged:
                votes[j] = signers[vote.id - 1].sign_proposal(proposal, vote.msg)
        honest.append((proposal, votes))

    t0 = time.perf_counter()
    certs = [verifier.aggregate_cert(proposal, votes) for proposal, votes in honest]
    if device.type == "cuda":
        torch.cuda.synchronize()
    aggregate_ms = (time.perf_counter() - t0) * 1e3
    if any(not isinstance(c, QuorumCert) for c in certs):
        raise AssertionError("an honest quorum did not aggregate")

    def parts(proposal, cert):
        return ([commit_message(proposal, c.msg) for c in cert], list(cert.rs), cert.s_agg,
                [keys[c.id] for c in cert])

    checks_before = KERNELS.stats("ed25519.fused_halfagg_verify").launches
    _reset_launch_counts()
    t0 = time.perf_counter()
    device_verdicts = [verifier.verify_aggregate_cert(c, p) for (p, _), c in zip(honest, certs)]
    if device.type == "cuda":
        torch.cuda.synchronize()
    verify_ms = (time.perf_counter() - t0) * 1e3
    launches, s1, d_launches = _launch_counts(), _s1_launches(), _d_launches()
    checks = KERNELS.stats("ed25519.fused_halfagg_verify").launches - checks_before
    t0 = time.perf_counter()
    host_verdicts = [host.verify(*parts(p, c)) for (p, _), c in zip(honest, certs)]
    host_ms = (time.perf_counter() - t0) * 1e3
    for (proposal, votes), got, want in zip(honest, device_verdicts, host_verdicts):
        if got != [v.msg for v in votes] or not want:
            raise AssertionError("a certificate's device verdict differs from the host twin's")
    tampered = 0
    for (proposal, _), cert in list(zip(honest, certs))[:3]:
        msgs_c, rs, s_agg, keys_c = parts(proposal, cert)
        bad = bytearray(s_agg)
        bad[0] ^= 1
        if verifier.aggregator.verify(msgs_c, rs, bytes(bad), keys_c) or host.verify(
            msgs_c, rs, bytes(bad), keys_c
        ):
            raise AssertionError("a tampered s_agg was accepted")
        tampered += 1

    localized = []
    for pos in forged:
        proposal, votes = honest[pos // QUORUM]
        votes = list(votes)
        votes[pos % QUORUM] = groups[pos // QUORUM][1][pos % QUORUM]
        msgs_f = [commit_message(proposal, v.msg) for v in votes]
        values = [v.value for v in votes]
        keys_f = [keys[v.id] for v in votes]
        agg, bad = verifier.aggregator.aggregate(msgs_f, values, keys_f)
        strict = engine.verify_host(msgs_f, values, keys_f)
        if agg is not None or set(bad) != {pos % QUORUM} or set(bad) != {
            j for j in range(len(votes)) if not strict[j]
        }:
            raise AssertionError(f"forged vote {pos}: bisection localized {bad}")
        if verifier.aggregate_cert(proposal, votes) is not None:
            raise AssertionError(f"forged vote {pos}: the quorum aggregated")
        localized.append((pos, votes[pos % QUORUM].id))
    return {"certs": len(certs), "components": QUORUM, "aggregate_ms": aggregate_ms,
            "verify_ms": verify_ms, "host_ms": host_ms, "checks": checks,
            "launches": launches, "s1": s1, "d_launches": d_launches, "tampered": tampered,
            "localized": localized}


# --- the chaos harness: phase 19 (the device-fault chaos matrix) --------------

#: The JAX package's device-fault matrix (tests/test_supervisor.py:425-426):
#: a seeded 4-replica schedule of 6 adversary actions, and one hang, one raise
#: and one silent verdict flip, armed on the engine's 2nd, 5th and 8th launch.
CHAOS_SEED = 31
CHAOS_STEPS = 6
CHAOS_FAULTS = ((2, "hang"), (5, "raise"), (8, "flip"))
#: The kernels (by ledger name) each engine mode must launch in its card runs
#: and the ones it must not.  The randomized engine checks batches below
#: ``min_randomized`` strictly, so B1 may launch there too; half-agg runs the
#: strict engine and checks each certificate with one B3 launch.
CHAOS_KERNELS = {
    "strict": (("horner_scan", "decompress25519", "comb25519"),
               ("horner_scan_p256", "straus_msm", "sha512")),
    "randomized": (("straus_msm", "decompress25519", "comb25519"),
                   ("horner_scan_p256", "sha512")),
    "halfagg": (("horner_scan", "straus_msm", "decompress25519", "comb25519"),
                ("horner_scan_p256", "sha512")),
    "fused": (("sha512", "horner_scan", "decompress25519", "comb25519"),
              ("horner_scan_p256", "straus_msm")),
    # The JAX package's mesh2 mode: the strict engine sharded over 2 virtual
    # shards of one device; each quorum check launches its kernels per shard.
    "mesh2": (("horner_scan", "decompress25519", "comb25519"),
              ("horner_scan_p256", "straus_msm", "sha512")),
}


def chaos_mode(mode: str, device, min_device_batch: int):
    """(the chaos engine's crypto mode, an engine factory) for ``mode``, its
    engine on ``device`` at ``min_device_batch``."""
    if mode == "mesh2":
        return "ed25519", lambda: ShardedEd25519Verifier(
            [device] * 2, min_device_batch=min_device_batch)
    crypto, engine, kw = {
        "strict": ("ed25519", med.Ed25519BatchVerifier, {}),
        "randomized": ("ed25519-batch", med.Ed25519RandomizedBatchVerifier,
                       {"min_randomized": 2}),
        "halfagg": ("ed25519-halfagg", med.Ed25519BatchVerifier, {}),
        "fused": ("ed25519", FusedEd25519BatchVerifier, {}),
    }[mode]
    return crypto, lambda: engine(min_device_batch=min_device_batch, device=device, **kw)


def _kernel_launches() -> dict:
    return {name: KERNELS.stats(name).launches for name in scan_kernels.KERNELS}


def _chaos_run(schedule, card: bool, **kw) -> tuple:
    """One chaos run, its kernel launches and its wall time (host clock,
    ending in torch.cuda.synchronize() when its engines are on the card)."""
    engine = ChaosEngine(schedule, **kw)
    _reset_launch_counts()
    t0 = time.perf_counter()
    result = engine.run()
    if card:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if not result.ok:
        raise AssertionError(f"chaos run {kw.get('crypto')} failed: {result.violation}")
    return engine, result, _kernel_launches(), seconds


def _check_supervised(engine, label: str) -> dict:
    """Every armed fault fired, each class degraded once and recovered, and
    the supervisor ended at rung 0 with every breaker closed."""
    if engine.fault_injector.fired != list(CHAOS_FAULTS) or engine.fault_injector.pending:
        raise AssertionError(f"{label}: faults fired {engine.fault_injector.fired}, "
                             f"{engine.fault_injector.pending} pending")
    dump = _engine_dump(engine.engine_metrics.provider)
    for reason in FAULT_CLASSES:
        if dump.get(f"{ENGINE_DEGRADE_KEY}{{{reason}}}") != 1:
            raise AssertionError(f"{label}: not one degrade of class {reason}: {dump}")
    if (dump[ENGINE_RECOVERED_KEY], dump[ENGINE_CROSSCHECK_MISMATCH_KEY], dump[ENGINE_RUNG_KEY]) \
            != (len(CHAOS_FAULTS), 1, 0):
        raise AssertionError(f"{label}: recoveries, mismatches or rung wrong: {dump}")
    sup = engine.supervisor
    if sup.degraded or any(b.state != "closed" for b in sup.breakers.values()):
        raise AssertionError(f"{label}: the supervisor ended degraded")
    return dump


def phase_chaos_matrix(device, modes=tuple(CHAOS_KERNELS), min_device_batch: int = 1) -> dict:
    """The JAX package's device-fault chaos matrix through the port's chaos
    engine, its supervisor and its engines on ``device`` at
    ``min_device_batch`` (1 on the card: every quorum check a launch).  Per
    mode: a fault-free run, the faulted run (``CHAOS_FAULTS`` under an
    ``EngineSupervisor`` cross-checking every launch on the host twin) and
    the port's own fault-free host-path run (``device="cpu"``,
    ``min_device_batch=10**9``); ledgers and event logs of all three
    byte-identical, each fault fired, degraded once and recovered, the
    mode's kernels launched in both device runs and the others not.  Then
    the strict faulted run once more with the sampler on: its
    ledgers equal the obs-off run's, its anomalies include
    ``engine_degraded`` and not ``verify_collapse``, and every line of its
    series parses as JSON."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    schedule = ChaosSchedule.generate(CHAOS_SEED, n=4, steps=CHAOS_STEPS)
    out: dict = {"modes": {}}
    faulted_strict = None
    for mode in modes:
        crypto, factory = chaos_mode(mode, device, min_device_batch)
        _, clean, clean_launches, clean_s = _chaos_run(
            schedule, on_card, crypto=crypto, engine_factory=factory)
        engine, faulted, fault_launches, fault_s = _chaos_run(
            schedule, on_card, crypto=crypto, engine_factory=factory,
            device_faults=CHAOS_FAULTS)
        host_factory = (chaos_mode(mode, "cpu", 10**9)[1] if mode in ("fused", "mesh2")
                        else None)
        _, host, host_launches, host_s = _chaos_run(
            schedule, False, crypto=crypto, engine_factory=host_factory,
            device="cpu")
        for label, run in (("faulted", faulted), ("host-path", host)):
            if run.event_log != clean.event_log or run.ledgers != clean.ledgers:
                raise AssertionError(f"{mode}: the {label} run's event log or ledgers differ "
                                     f"from the fault-free run's")
        dump = _check_supervised(engine, mode)
        on_path, off_path = CHAOS_KERNELS[mode]
        for label, launches in (("fault-free", clean_launches), ("faulted", fault_launches)):
            if any(bool(launches[k]) != on_card for k in on_path) \
                    or any(launches[k] for k in off_path):
                raise AssertionError(f"{mode}: the {label} run launched {launches}")
        if any(host_launches.values()):
            raise AssertionError(f"{mode}: the host-path run launched {host_launches}")
        out["modes"][mode] = {
            "crypto": crypto, "clean_s": clean_s, "faulted_s": fault_s, "host_s": host_s,
            "clean_launches": clean_launches, "fault_launches": fault_launches,
            "engine_launches": engine.fault_injector.launches, "engine": dump,
            "event_lines": clean.event_log.count(b"\n"), "deliveries": clean.deliveries,
            "heights": sorted({len(v) for v in clean.ledgers.values()}),
        }
        if mode == "strict":
            faulted_strict = faulted
    crypto, factory = chaos_mode("strict", device, min_device_batch)
    engine, seen, launches, seconds = _chaos_run(
        schedule, on_card, crypto=crypto, engine_factory=factory,
        device_faults=CHAOS_FAULTS, obs=ObsConfig(enabled=True, sample_interval=2.0))
    if faulted_strict is not None and seen.ledgers != faulted_strict.ledgers:
        raise AssertionError("the observed run's ledgers differ from the obs-off run's")
    _check_supervised(engine, "observed strict")
    sampler = engine.cluster.sampler
    counts = sampler.anomaly_counts()
    if "engine_degraded" not in counts or "verify_collapse" in counts:
        raise AssertionError(f"observed run: anomalies {counts}")
    lines = series_to_jsonl(sampler.samples()).splitlines()
    for line in lines:
        json.loads(line)
    out["observed"] = {"seconds": seconds, "anomalies": counts, "samples": len(lines),
                       "launches": launches,
                       "anomaly_lines": seen.event_log.count(b" ANOMALY ")}
    return out


# --- phase 20: the mesh --------------------------------------------------------

#: Phase 20's waves: (the single engine, its sharded twin, the corpus key,
#: the replicas whose requests make the wave).
MESH_WAVES = {
    "strict": (med.Ed25519BatchVerifier, ShardedEd25519Verifier, "strict", REPLICAS),
    "fused": (FusedEd25519BatchVerifier, ShardedFusedEd25519Verifier, "strict", REPLICAS),
    "randomized": (med.Ed25519RandomizedBatchVerifier, ShardedEd25519RandomizedVerifier,
                   "randomized", REPLICAS),
    "fused_randomized": (FusedEd25519RandomizedBatchVerifier,
                         ShardedFusedEd25519RandomizedVerifier, "randomized", REPLICAS),
    "p256": (mp.EcdsaP256BatchVerifier, ShardedEcdsaP256Verifier, "p256", P256_REPLICAS),
}
#: The wider meshes phase 20 runs on the strict wave only (to keep the
#: script within its time): 8 virtual shards, 1-D and as a (2, 4) topology.
MESH_WIDE = ((8,), (2, 4))


def _mesh_run(engine, wave, device) -> tuple:
    """One wave through ``engine`` after an uncounted warm-up call: its
    verdicts, wall ms (host clock, ending in torch.cuda.synchronize() on the
    card) and every kernel's launches, the counts set to 0 just before the
    call and read just after."""
    engine.verify_batch(*wave)
    if device.type == "cuda":
        torch.cuda.synchronize()
    _reset_launch_counts()
    t0 = time.perf_counter()
    got = engine.verify_batch(*wave)
    if device.type == "cuda":
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return got, ms, _kernel_launches()


def phase_mesh(device, corpora: dict, waves=tuple(MESH_WAVES), wide=MESH_WIDE,
               replicas: dict | None = None) -> dict:
    """The sharded engines on ``device``: each wave of ``waves`` (its corpus
    from ``corpora``, by ``MESH_WAVES``' key) through its single engine,
    through the sharded engine over a 1-shard mesh and over 2 virtual
    shards (``[device] * 2``), all at ``Configuration()``'s knobs.  Verdicts
    equal the single engine's lane for lane; the 1-shard mesh launches
    every kernel as often as the single engine, the 2-shard mesh twice as
    often (each on-path kernel once per shard, at half the width).  The
    strict wave also over the ``wide`` topologies (8 virtual shards: eight
    times).  Then padding-only shards (3 signatures on 8 shards) vote ok in
    both randomized lanes, and a 2-shard mesh with no device list raises
    where fewer cards are visible."""
    device = torch.device(device)
    cfg = Configuration()
    kw = dict(pad_pow2=cfg.crypto_pad_pow2, min_device_batch=cfg.crypto_tpu_min_batch)
    out: dict = {"waves": {}}
    for name in waves:
        single_cls, mesh_cls, corpus_key, default_replicas = MESH_WAVES[name]
        n_rep = (replicas or {}).get(name, default_replicas)
        wave = replica_wave(corpora[corpus_key], n_rep)[:3]
        single = single_cls(device=device, **kw)
        want, single_ms, single_launches = _mesh_run(single, wave, device)
        if not any(single_launches.values()) and device.type == "cuda":
            raise AssertionError(f"{name}: the single engine launched no kernel")
        meshes = [("1", (1,), mesh_for_shards(1, device=device)),
                  ("2 virtual", (2,), mesh_for_shards(2, [device] * 2))]
        if name == "strict":
            meshes += [(MeshTopology(axes).label + " virtual", axes,
                        MeshTopology(axes).build_mesh([device] * MeshTopology(axes).shard_count))
                       for axes in wide]
        runs = {}
        for label, axes, mesh in meshes:
            engine = mesh_cls(mesh, **kw)
            got, ms, launches = _mesh_run(engine, wave, device)
            if got.shape != want.shape or not np.array_equal(got, want):
                wrong = np.flatnonzero(got != want)
                raise AssertionError(f"{name} on the {label} mesh: verdicts differ from the "
                                     f"single engine's at {wrong[:16]}")
            shards = engine.shard_count
            expect = {k: shards * v for k, v in single_launches.items()}
            if launches != expect:
                raise AssertionError(f"{name} on the {label} mesh launched {launches}, not "
                                     f"{shards} x the single engine's {single_launches}")
            runs[label] = {"axes": axes, "shards": shards, "ms": ms, "launches": launches,
                           "shard_lanes": engine.padded_size(len(wave[0])) // shards}
        out["waves"][name] = {
            "signatures": len(wave[0]), "padded": single.padded_size(len(wave[0])),
            "rejected": int((~want).sum()), "single_ms": single_ms,
            "single_launches": single_launches, "meshes": runs,
        }

    # Padding-only shards: 3 valid signatures padded to 8 lanes on 8 shards.
    c_msgs, c_sigs, c_keys, expected, _ = corpora["strict"]
    idx = np.flatnonzero(expected)[:3].tolist()
    msgs, sigs, keys = ([x[i] for i in idx] for x in (c_msgs, c_sigs, c_keys))
    want = med.Ed25519BatchVerifier(device=device, min_device_batch=1).verify_batch(msgs, sigs, keys)
    padding = {}
    for cls in (ShardedEd25519RandomizedVerifier, ShardedFusedEd25519RandomizedVerifier):
        engine = cls(mesh_for_shards(8, [device] * 8), min_device_batch=1)
        _reset_launch_counts()
        got = engine.verify_batch(msgs, sigs, keys)
        if not np.array_equal(got, want):
            raise AssertionError(f"{cls.__name__}: padding-only shards changed the verdicts")
        padding[cls.__name__] = _kernel_launches()
    out["padding"] = {"signatures": len(msgs), "verdicts": want.tolist(), "launches": padding}

    # The loud failure: two cards asked for, fewer visible.
    visible = torch.cuda.device_count() if device.type == "cuda" else 8
    try:
        mesh_for_shards(visible + 1, device=device)
    except ValueError as exc:
        out["refused"] = str(exc)
    else:
        raise AssertionError(f"a {visible + 1}-shard mesh over {visible} visible device(s) "
                             f"did not raise")
    return out


# --- phase 21: the tensor-core field lane (kernel M1) -----------------------------

#: Dense MACs the counting shim books for one product a lane: the outer
#: product (32 x 1 x 32) and the column assembly (63 x 1 x 1024), and for
#: P-256 the Solinas contraction (32 x 1 x 64) (tests/test_mxu_limbs.py:452-473).
MXU_MACS = {"ed25519": 32 * 32 + 63 * 1024, "p256": 32 * 32 + 63 * 1024 + 32 * 64}
#: Dense int8 tensor-core operations a second of an H100 SXM (NVIDIA data
#: sheet; a MAC is two operations).
INT8_OPS_PER_S = 1979e12
#: M1's widths on the main path: the strict wave's add_and_equal (8,192),
#: the P-256 comb and check (2,048), phase 12's waves (1,024), a certificate
#: (1); and the broadcast case, a (32, 1) constant against 8,192 lanes.
MXU_WIDTHS = (8192, 2048, 1024, 1)
MXU_BROADCAST_LANES = 8192
#: The operand ranges of tests/test_mxu_limbs.py: canonical bytes, one raw
#: add/sub level and the subtraction bias's range; P-256's bytes and its
#: weak bound.  The last of each is timed.
MXU_RANGES = {"ed25519": ((0, 256), (-340, 341), (-345, 681)), "p256": ((0, 256), (-600, 601))}
#: (the lane's product, the VPU lane's) by curve.
MXU_PRODUCTS = {"ed25519": (mxu_limbs.mul25519, fe.mul), "p256": (mxu_limbs.mul_p256, fp.mul)}
#: Phase 21's waves: (corpus key, replicas, engine config, curve, profiled
#: ranges, the ranges' kernel).
MXU_WAVES = {
    "strict": ("strict", REPLICAS, {}, "ed25519", WAVE_RANGES, "horner_scan"),
    "randomized": ("randomized", REPLICAS, {"batch_verify_mode": True}, "ed25519",
                   BATCH_RANGES, "straus_msm"),
    "p256": ("p256", P256_REPLICAS, {}, "p256", P256_WAVE_RANGES, "horner_scan_p256"),
}


def mxu_bound(lanes: int, curve: str, n_bytes: int) -> dict:
    """The least time of ``lanes`` products: the counting shim's dense MACs
    at the card's int8 tensor-core rate, or the bytes (each operand row read
    once, the output written once) over 3.35 TB/s, whichever is larger."""
    ops_ms = 2 * MXU_MACS[curve] * lanes / INT8_OPS_PER_S * 1e3
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return {
        "macs": MXU_MACS[curve] * lanes, "ops_ms": ops_ms, "bytes": n_bytes,
        "bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


def sass_imma_count(library: str) -> dict:
    """The IMMA (integer tensor-core MMA) instructions of each function in
    ``cuobjdump -sass`` of ``library``."""
    cuobjdump = Path(scan_kernels._nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(cuobjdump), "-sass", library], capture_output=True,
                         text=True, check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name is not None and re.search(r"\bIMMA\b", line):
            counts[name] += 1
    return counts


@contextlib.contextmanager
def lane_from_environment():
    """``CTPU_MXU_LIMBS=1`` inside the block, as a deployment sets it; the
    environment as it was after."""
    prev = os.environ.get("CTPU_MXU_LIMBS")
    os.environ["CTPU_MXU_LIMBS"] = "1"
    try:
        yield
    finally:
        if prev is None:
            del os.environ["CTPU_MXU_LIMBS"]
        else:
            os.environ["CTPU_MXU_LIMBS"] = prev


def _check_mxu(curve: str, a: torch.Tensor, b: torch.Tensor, device) -> float:
    """M1 through the wrapper on ``device`` against the plain version on CPU
    copies of the inputs and the VPU lane's eager torch on ``device``:
    raises unless all three are bit-identical (raw limbs, no freeze);
    returns the largest absolute difference."""
    product, vpu = MXU_PRODUCTS[curve]
    got = product(a.to(device), b.to(device)).cpu()
    plain = product(a.cpu(), b.cpu())
    with mxu_limbs.suppress_mxu_limbs():
        want = vpu(a.to(device), b.to(device)).cpu()
    for label, other in (("the plain version", plain), ("the VPU lane", want)):
        if got.shape != other.shape or not torch.equal(got, other):
            raise AssertionError(f"M1 ({curve}, {tuple(a.shape)} x {tuple(b.shape)}) differs "
                                 f"from {label}")
    return float((got - plain).abs().max())


def _int_mm_ms(lanes: int, reps: int, device) -> float | None:
    """``torch._int_mm`` on one byte plane's (64 x 1024) x (1024 x lanes)
    int8 product: the one library call that computes part of M1's work.
    None where it refuses (on the CPU, say)."""
    if device.type != "cuda":
        return None
    c = torch.zeros((64, 1024), dtype=torch.int8)
    for i in range(32):
        for j in range(32):
            c[i + j, 32 * i + j] = 1
    c = c.to(device)
    plane = torch.randint(0, 128, (lanes, 1024), dtype=torch.int8, device=device).t()
    try:
        torch._int_mm(c, plane)
    except RuntimeError as exc:
        log(f"  torch._int_mm refused the plane's product: {exc}")
        return None
    return _time_ms(lambda: torch._int_mm(c, plane), reps, device)


def phase_mxu_kernel(device, reps: int, plain_reps: int, widths=MXU_WIDTHS,
                     broadcast_lanes: int = MXU_BROADCAST_LANES) -> dict:
    """Kernel M1 at every width of ``widths`` and in the broadcast case
    (``broadcast_lanes`` against a (32, 1) constant, either side), over
    every operand range of ``MXU_RANGES``: products and squares held at
    tolerance 0 to the plain version and the VPU lane.  Then, per curve and
    width on the widest range: M1 through the wrapper (``ms``), its launches
    alone (``launch_ms``), the VPU lane's eager product (``vpu_ms``), the
    plain version on the CPU (``plain_ms``, host clock) and the bound; and
    ``torch._int_mm``'s one-plane product at the first width."""
    device = torch.device(device)
    out: dict = {"max_abs_err": 0.0, "checks": 0, "times": {}, "widths": widths,
                 "broadcast_lanes": broadcast_lanes}
    seed = SEED
    for curve, ranges in MXU_RANGES.items():
        for bounds in ranges:
            shapes = [(n, n) for n in widths] + [(1, broadcast_lanes), (broadcast_lanes, 1)]
            for a_lanes, b_lanes in shapes:
                seed += 1
                rng = np.random.default_rng(seed)
                a, b = (torch.from_numpy(rng.integers(*bounds, (32, n)).astype(np.float32))
                        for n in (a_lanes, b_lanes))
                err = _check_mxu(curve, a, b, device)
                if a_lanes == b_lanes:
                    err = max(err, _check_mxu(curve, a, a, device))
                out["max_abs_err"] = max(out["max_abs_err"], err)
                out["checks"] += 2 if a_lanes == b_lanes else 1
        product, vpu = MXU_PRODUCTS[curve]
        rng = np.random.default_rng(SEED + 100)
        for n in widths:
            a_cpu, b_cpu = (torch.from_numpy(rng.integers(*ranges[-1], (32, n)).astype(np.float32))
                            for _ in range(2))
            a, b = a_cpu.to(device), b_cpu.to(device)
            product(a, b)
            row = {"ms": _time_ms(lambda: product(a, b), reps, device)}
            if device.type == "cuda":
                dst = torch.empty_like(a)
                args = (mxu_limbs._CURVES[curve], 0, 0)
                row["launch_ms"] = _time_ms(
                    lambda: scan_kernels._launch("mxu_limbs", (a, b), (dst,), n, device, args),
                    reps, device)
            else:
                row["launch_ms"] = None
            with mxu_limbs.suppress_mxu_limbs():
                vpu(a, b)
                row["vpu_ms"] = _time_ms(lambda: vpu(a, b), reps, device)
            row["plain_ms"] = _time_ms(lambda: product(a_cpu, b_cpu), plain_reps,
                                       torch.device("cpu"))
            row["bound"] = mxu_bound(n, curve, 3 * 32 * 4 * n)
            out["times"][(curve, n)] = row
    out["library_ms"] = _int_mm_ms(widths[0], reps, device)
    return out


#: The order phase 21 times a wave's two lanes in: in turns, so drift on
#: the host's clock falls on both.
MXU_TURNS = ("off", "on", "on", "off")


def _lane(lane: str, curve: str):
    """The lane's context: the VPU lane under ``suppress_mxu_limbs``; the
    tensor-core lane from ``CTPU_MXU_LIMBS=1`` for Ed25519 (the registry's
    ``mxu`` keys) and under ``force_mxu_limbs`` for P-256, whose ``mxu``
    keys the registry refuses."""
    if lane == "off":
        return mxu_limbs.suppress_mxu_limbs()
    return mxu_limbs.force_mxu_limbs() if curve == "p256" else lane_from_environment()


def phase_mxu_waves(device, corpora: dict, waves=tuple(MXU_WAVES),
                    replicas: dict | None = None, turns=MXU_TURNS) -> dict:
    """Phase 3's strict, phase 7's randomized and phase 5's P-256 waves with
    the lane off and on, each lane's engine from ``engine_for_config``
    under its lane and warmed up by one uncounted call, then timed calls in
    ``turns``, each with the launch counts set to 0 just before it and read
    just after: verdicts equal across every call (and to the
    construction), M1 launched only with the lane on and every other kernel
    as often, wall ms (host clock, ending in synchronize), the device's
    busy share over one profiled re-run a lane, peak device memory.  The
    Ed25519 lane-on engines book their calls under the ``_mxu`` names."""
    device = torch.device(device)
    out = {}
    for name in waves:
        corpus_key, n_rep, knobs, curve, ranges, kernel = MXU_WAVES[name]
        n_rep = (replicas or {}).get(name, n_rep)
        msgs, sigs, keys, want = replica_wave(corpora[corpus_key], n_rep)
        engines = {}
        for lane in ("off", "on"):
            with _lane(lane, curve):
                engines[lane] = engine_for_config(Configuration(**knobs), curve=curve,
                                                  device=device)
                engines[lane].verify_batch(msgs, sigs, keys)
        runs = {lane: {"ms": []} for lane in ("off", "on")}
        for lane in turns:
            run = runs[lane]
            with _lane(lane, curve):
                if device.type == "cuda":
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                booked = KERNELS.snapshot()
                _reset_launch_counts()
                t0 = time.perf_counter()
                got = engines[lane].verify_batch(msgs, sigs, keys)
                if device.type == "cuda":
                    torch.cuda.synchronize()
                run["ms"].append((time.perf_counter() - t0) * 1e3)
                launches = _kernel_launches()
                calls = {k: v["launches"] - booked.get(k, {}).get("launches", 0)
                         for k, v in KERNELS.snapshot().items()
                         if k not in scan_kernels.KERNELS
                         and v["launches"] != booked.get(k, {}).get("launches", 0)}
                peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else None
            if got.shape != want.shape or not np.array_equal(got, want):
                wrong = np.flatnonzero(got != want)
                raise AssertionError(f"{name} wave, lane {lane}: verdicts differ from the "
                                     f"construction at {wrong[:16]}")
            if run.setdefault("launches", launches) != launches or \
                    run.setdefault("calls", calls) != calls:
                raise AssertionError(f"{name} wave, lane {lane}: launches {launches} and calls "
                                     f"{calls} differ from the lane's first call's")
            run["peak_bytes"] = peak
        for lane in ("off", "on"):
            with _lane(lane, curve):
                prof = profile_wave(engines[lane], msgs, sigs, keys, device, wave_ranges=ranges,
                                    kernel=kernel)
            if not np.array_equal(prof["verdicts"], want):
                raise AssertionError(f"{name} wave, lane {lane}: the profiled re-run disagrees")
            runs[lane]["busy_share"] = prof["busy_share"]
        off, on = runs["off"], runs["on"]
        on_card = device.type == "cuda"
        if off["launches"]["mxu_limbs"] or (on_card and not on["launches"]["mxu_limbs"]):
            raise AssertionError(f"{name} wave: M1 launched {off['launches']['mxu_limbs']} times "
                                 f"with the lane off and {on['launches']['mxu_limbs']} with it on")
        if {k: v for k, v in on["launches"].items() if k != "mxu_limbs"} != \
                {k: v for k, v in off["launches"].items() if k != "mxu_limbs"}:
            raise AssertionError(f"{name} wave: the lane changed the other kernels' launches: "
                                 f"{off['launches']} against {on['launches']}")
        if curve == "ed25519":
            # The lane-on engine books its device calls under the _mxu names.
            if any(k.endswith("_mxu") for k in off["calls"]) or not on["calls"] or \
                    not all(k.endswith("_mxu") for k in on["calls"]):
                raise AssertionError(f"{name} wave: device calls booked as {off['calls']} "
                                     f"(lane off) and {on['calls']} (lane on)")
        out[name] = {"signatures": len(msgs), "rejected": int((~want).sum()),
                     "off": off, "on": on}
    return out


# --- the sidecar and the transport on the card: phase 22 -------------------------

#: Phase 22a: the config-3 wave split into this many tenants' sweeps, served
#: by one multi-tenant sidecar whose wave former launches up to max_wave.
SIDECAR_TENANTS = 4
SIDECAR_MAX_WAVE = 8192
#: Phase 22b: blocks the TCP cluster orders (1 warm-up, 2 measured), cut from
#: phase 12's 4 to keep the script near its time.
SIDECAR_CLUSTER_BLOCKS = 3
#: The cluster's leader cuts a batch at 1,000 requests or after this many
#: seconds: on the wall clock, phase 12's 0.02 s would cut a block while its
#: requests are still being submitted.
SIDECAR_BATCH_INTERVAL = 5.0
SIDECAR_SECRET = b"chip-smoke-sidecar"


@contextlib.contextmanager
def held_ports(n: int):
    """``n`` localhost ports, each held by a bound socket that does not
    listen (``SO_REUSEADDR``), so a ``TcpComm`` listener can bind it while
    nothing else on the machine is handed it; released on exit."""
    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        yield [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


class _LocalHost:
    """A sidecar client's ``local_engine``: the host path of ``engine``,
    counting each call and its signatures.  A call of at least
    ``bypass_below`` signatures is a failover (the client bypasses only
    smaller ones)."""

    def __init__(self, engine, bypass_below: int) -> None:
        self.engine = engine
        self.bypass_below = bypass_below
        self.calls: list[int] = []
        self._lock = threading.Lock()

    def verify_host(self, messages, signatures, public_keys):
        with self._lock:
            self.calls.append(len(messages))
        return self.engine.verify_host(messages, signatures, public_keys)

    def read(self) -> tuple[int, int]:
        """(calls so far, failovers so far)."""
        with self._lock:
            return len(self.calls), sum(n >= self.bypass_below for n in self.calls)


class _Sweeps:
    """A sidecar server's engine: counts the sweeps it is handed, then
    passes them to ``inner`` (the coalescer), whose health it reports."""

    def __init__(self, inner) -> None:
        self.inner = inner
        self.sweeps: list[int] = []
        self._lock = threading.Lock()

    def verify_batch(self, messages, signatures, public_keys):
        with self._lock:
            self.sweeps.append(len(messages))
        return self.inner.verify_batch(messages, signatures, public_keys)

    @property
    def device_suspect(self) -> bool:
        return self.inner.device_suspect


def _sidecar_launches() -> tuple[int, int, int]:
    """B1's, D1's and D2's launches from the kernel ledger."""
    return (KERNELS.stats("horner_scan").launches,) + _d_launches()


def phase_sidecar_tenants(device, corpus, replicas: int, direct,
                          tenants: int = SIDECAR_TENANTS, max_wave: int = SIDECAR_MAX_WAVE,
                          min_device_batch: int | None = None, timeout: float = 60.0) -> dict:
    """Phase 3's wave (``replicas`` copies of ``corpus``) split into
    ``tenants`` sweeps, each sent by its own tenant's
    ``SidecarVerifierClient`` (TCP, the per-tenant mutual handshake, a MAC
    on every frame) to one multi-tenant ``VerifySidecarServer`` on
    ``("127.0.0.1", 0)``, all at once from a barrier.  The server's engine
    is ``Ed25519BatchVerifier`` on ``device`` at phase 3's
    ``min_device_batch``, behind the server's ``FairShareWaveFormer``
    (``max_wave``).  The reassembled verdicts must equal ``direct`` (phase
    3's) lane for lane; B1, D1 and D2 launch once per wave the server
    counts (none on the CPU, where the plain versions run); the waves carry
    every signature; no client fails over to its local engine or marks the
    server suspect.  ``timeout`` is each client's request timeout (a CPU
    rehearsal's plain versions may need longer than the card's 60 s)."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    msgs, sigs, keys, want = replica_wave(corpus, replicas)
    n = len(msgs)
    if min_device_batch is None:
        min_device_batch = Configuration().crypto_tpu_min_batch
    names = [f"tenant-{t}" for t in range(tenants)]
    secrets = {name: b"secret-" + name.encode() for name in names}
    cuts = np.linspace(0, n, tenants + 1).astype(int)
    engine = med.Ed25519BatchVerifier(device=device, min_device_batch=min_device_batch)
    local = _LocalHost(med.Ed25519BatchVerifier(device=device, min_device_batch=10**9), 0)
    provider = InMemoryProvider()
    accounting = TenantAccounting()
    server = VerifySidecarServer(
        ("127.0.0.1", 0), engine, tenants=secrets, max_wave=max_wave,
        metrics=Metrics(provider, label_names=("tenant",)).sidecar,
        tenant_accounting=accounting,
    )
    server.start()
    clients = [SidecarVerifierClient(server.address, auth_secret=secrets[name], tenant=name,
                                     local_engine=local, request_timeout=timeout)
               for name in names]
    got, ms, errors = {}, {}, []
    barrier = threading.Barrier(tenants)

    def tenant(t: int) -> None:
        try:
            lo, hi = cuts[t], cuts[t + 1]
            barrier.wait()
            t0 = time.perf_counter()
            got[t] = clients[t].verify_batch(msgs[lo:hi], sigs[lo:hi], keys[lo:hi])
            ms[t] = (time.perf_counter() - t0) * 1e3
        except Exception as exc:  # surfaced on the main thread below
            errors.append(exc)
            barrier.abort()

    try:
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        before = _sidecar_launches()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=tenant, args=(t,), name=f"tenant-{t}")
                   for t in range(tenants)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = tuple(a - b for a, b in zip(_sidecar_launches(), before))
        peak = torch.cuda.max_memory_allocated() if on_card else None
        suspect = [names[t] for t, c in enumerate(clients) if c._suspect]
    finally:
        for c in clients:
            c.close()
        server.stop()
    if errors:
        raise AssertionError(f"a tenant's sweep failed: {errors[0]!r}") from errors[0]
    dump = provider.dump()
    waves, signatures, tenant_rides = (
        int(dump.get(key, {}).get("value", 0)) for key in
        (SIDECAR_WAVE_LAUNCHES_KEY, SIDECAR_WAVE_SIGNATURES_KEY, SIDECAR_WAVE_TENANTS_KEY))
    verdicts = np.concatenate([got[t] for t in range(tenants)])
    if verdicts.shape != direct.shape or not np.array_equal(verdicts, direct):
        wrong = np.flatnonzero(verdicts != direct)
        raise AssertionError(f"the tenants' verdicts differ from phase 3's at {wrong[:16]}")
    if not np.array_equal(verdicts, want):
        raise AssertionError("the tenants' verdicts differ from the construction")
    if launches != ((waves,) * 3 if on_card else (0, 0, 0)) or waves < 1:
        raise AssertionError(f"(horner_scan, decompress25519, comb25519) launched {launches} "
                             f"for the server's {waves} waves")
    if signatures != n:
        raise AssertionError(f"the server's waves carried {signatures} signatures, not {n}")
    if local.calls or suspect:
        raise AssertionError(f"a client failed over: {len(local.calls)} local calls, "
                             f"suspect {suspect}")
    return {
        "tenants": tenants, "signatures": n, "sweep": [int(c) for c in np.diff(cuts)],
        "min_device_batch": min_device_batch, "max_wave": max_wave,
        "waves": waves, "tenant_rides": tenant_rides, "launches": launches,
        "roundtrip_ms": [ms[t] for t in range(tenants)], "wall_ms": wall_ms,
        "rejected": int((~verdicts).sum()), "peak_bytes": peak,
        "accounting": accounting.snapshot(),
    }


def phase_sidecar_cluster(device, replicas: int = REPLICAS, requests: int = REQUESTS,
                          blocks: int = SIDECAR_CLUSTER_BLOCKS, clients: int = CLUSTER_CLIENTS,
                          min_device_batch: int = CLUSTER_MIN_DEVICE_BATCH,
                          max_batch: int = SIDECAR_MAX_WAVE, timeout: float = 60.0) -> dict:
    """Phase 12's cluster over real sockets, verifying through one sidecar:
    ``replicas`` ``SignedRequestApp`` replicas, each a ``Consensus`` on its
    own ``RealtimeScheduler`` with a ``TcpComm`` on localhost (``auth_secret``)
    and a file WAL at the default segment size, ordering ``blocks`` blocks of
    ``requests`` signed requests (phase 12's, the first block warm-up).

    Every replica's engine is a ``SidecarVerifierClient`` on a unix socket in
    a temporary directory, with ``bypass_below`` = ``min_device_batch`` (a
    quorum check stays on the replica's host, as in phase 12) and a counting
    host engine as ``local_engine``: the wiring of the JAX package's
    deploy/replica_main.py.  The one single-tenant ``VerifySidecarServer``
    serves a ``ThreadCoalescingVerifier`` (``max_batch``) over
    ``Ed25519BatchVerifier`` on ``device`` at ``min_device_batch``.

    The set-up heap is frozen (``gc.freeze``) for the blocks, whose
    collector pauses and WAL fsyncs are timed as in phase 12.  All ledgers
    must be identical, every decision carry 2f+1 signatures and every
    request be ordered exactly once; B1, D1 and D2 launch once per
    coalesced flush (none on the CPU); the local engines serve only bypassed
    calls and no client marks the sidecar suspect.  ``timeout`` is the
    clients' request timeout and the coalescer's wait before its host
    fallback (a CPU rehearsal's plain versions may need longer)."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    phase_t0 = time.perf_counter()
    quorum = 2 * ((replicas - 1) // 3) + 1
    engine = _instrumented(med.Ed25519BatchVerifier(device=device,
                                                    min_device_batch=min_device_batch))
    coalescer = ThreadCoalescingVerifier(
        engine, window=Configuration().crypto_batch_window, max_batch=max_batch,
        hard_cap=engine.padded_size(max_batch), bypass_below=min_device_batch,
        wait_timeout=timeout, name=FLUSHER,
    )
    served = _Sweeps(coalescer)
    local = _LocalHost(med.Ed25519BatchVerifier(device=device, min_device_batch=10**9),
                       min_device_batch)
    signers = {i: Ed25519Signer(i, bytes([i]) * 32) for i in range(1, replicas + 1)}
    keys = {i: s.public_bytes for i, s in signers.items()}
    keyring, raws, signed_now, sign_s = _signed_requests(blocks, requests, clients)
    ed.comb_table(device)  # the constant table is set-up, not part of a block

    class Ledgers:
        """The replicas' sync registry (the toy sync reads the longest
        ledger; no replica falls behind here)."""

        nodes: dict = {}

        def longest_ledger(self, *, exclude):
            return []

        def reconfig_of(self, proposal):
            return Reconfig()

    registry = Ledgers()
    clocks = _BlockClocks()
    consensus, comms, schedulers, wals, sidecar_clients, apps = {}, {}, {}, {}, {}, {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-sidecar-") as tmp:
        server = VerifySidecarServer(os.path.join(tmp, "sidecar.sock"), served,
                                     auth_secret=SIDECAR_SECRET)
        server.start()
        try:
            with held_ports(replicas) as ports:
                addrs = {i + 1: ("127.0.0.1", ports[i]) for i in range(replicas)}
                for node_id in addrs:
                    client = SidecarVerifierClient(
                        server.address, local_engine=local, bypass_below=min_device_batch,
                        auth_secret=SIDECAR_SECRET, request_timeout=timeout,
                    )
                    sidecar_clients[node_id] = client
                    app = SignedRequestApp(node_id, registry, signers[node_id],
                                           SigOnlyVerifier(keys, engine=client),
                                           client_keys=keyring.public_keys, engine=client)
                    apps[node_id] = app
                    rt = RealtimeScheduler()
                    rt.start(thread_name=f"replica-{node_id}")
                    schedulers[node_id] = rt

                    def route(sender, payload, is_request, nid=node_id):
                        c = consensus.get(nid)
                        if c is None:
                            return
                        if is_request:
                            c.handle_request(sender, payload)
                        else:
                            c.handle_message(sender, payload)

                    comm = TcpComm(node_id, addrs, route, reconnect_backoff=0.05,
                                   auth_secret=SIDECAR_SECRET)
                    comm.start()
                    comms[node_id] = comm
                    wal, _ = initialize_and_read_all(
                        os.path.join(tmp, f"wal-{node_id}"),
                        segment_max_bytes=DEFAULT_SEGMENT_MAX_BYTES, scheduler=rt)
                    wals[node_id] = wal
                    config = Configuration(
                        self_id=node_id, leader_rotation=False, decisions_per_leader=0,
                        request_batch_max_count=requests,
                        request_batch_max_interval=SIDECAR_BATCH_INTERVAL,
                        request_pool_size=3 * requests,
                    )
                    consensus[node_id] = Consensus(
                        config=config, scheduler=rt, comm=comm, application=app, assembler=app,
                        wal=wal, signer=app, verifier=app, request_inspector=app.inspector,
                        synchronizer=app,
                    )
                for c in consensus.values():
                    c.start()
            if on_card:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            # The earlier phases' objects, which no replica process of a
            # deployment holds, go to the collector's permanent generation:
            # a full collection over them stalls all 7 replicas at once, and
            # a stall past the followers' 2 s request-forward timer has the
            # leader verify ~6,000 forwarded requests one by one on its host.
            gc.collect()
            gc.freeze()
            block_log = []
            with clocks:
                for b in range(blocks):
                    sweeps0, flushes0 = len(served.sweeps), engine.flushes
                    local0 = local.read()
                    launches0 = _sidecar_launches()
                    fsync0, fsyncs0, gc0, collections0 = clocks.read()
                    t0 = time.perf_counter()
                    for raw in raws[b]:
                        for c in consensus.values():
                            c.submit_request(raw)
                    deadline = time.monotonic() + 300.0
                    while not all(len(a.ledger) > b for a in apps.values()):
                        if time.monotonic() > deadline:
                            raise AssertionError(f"block {b + 1} was not ordered over TCP")
                        time.sleep(0.002)
                    if on_card:
                        torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    local1 = local.read()
                    fsync1, fsyncs1, gc1, collections1 = clocks.read()
                    block_log.append({
                        "wall_ms": wall * 1e3,
                        "sweeps": len(served.sweeps) - sweeps0,
                        "flushes": engine.flushes - flushes0,
                        "launches": tuple(a - b0 for a, b0 in
                                          zip(_sidecar_launches(), launches0)),
                        "local_calls": local1[0] - local0[0],
                        "failovers": local1[1] - local0[1],
                        "fsync_ms": (fsync1 - fsync0) * 1e3, "fsyncs": fsyncs1 - fsyncs0,
                        "gc_ms": (gc1 - gc0) * 1e3, "collections": collections1 - collections0,
                    })
            peak = torch.cuda.max_memory_allocated() if on_card else None
            suspect = [i for i, c in sidecar_clients.items() if c._suspect]
            device_suspect = coalescer.device_suspect
            ledgers = {i: list(a.ledger) for i, a in apps.items()}
            views = {c.controller.curr_view_number for c in consensus.values()}
        finally:
            gc.unfreeze()
            for c in consensus.values():
                c.stop()
            for comm in comms.values():
                comm.stop()
            for rt in schedulers.values():
                with contextlib.suppress(RuntimeError):
                    rt.stop(timeout=2.0)
            for wal in wals.values():
                wal.close()
            for client in sidecar_clients.values():
                client.close()
            server.stop()
            coalescer.close()
        wal_bytes = sum(f.stat().st_size for f in Path(tmp).rglob("*.wal"))

    digests = {i: [d.proposal.digest() for d in ledger] for i, ledger in ledgers.items()}
    if len({tuple(v[:blocks]) for v in digests.values()}) != 1 or \
            any(len(v) < blocks for v in digests.values()):
        raise AssertionError(f"the replicas' ledgers differ: {digests}")
    if min(len(d.signatures) for ledger in ledgers.values() for d in ledger) < quorum:
        raise AssertionError(f"a decision carries fewer than {quorum} commit signatures")
    ordered = [r for d in ledgers[1] for r in unpack_batch(d.proposal.payload)]
    submitted = [r for block in raws for r in block]
    if len(ordered) != len(set(ordered)) or sorted(ordered) != sorted(submitted):
        raise AssertionError(f"{len(ordered)} requests ordered ({len(set(ordered))} distinct) "
                             f"for {len(submitted)} submitted")
    flushes = sum(b["flushes"] for b in block_log)
    launches = tuple(sum(b["launches"][k] for b in block_log) for k in range(3))
    if launches != ((flushes,) * 3 if on_card else (0, 0, 0)) or not flushes:
        raise AssertionError(f"(horner_scan, decompress25519, comb25519) launched {launches} "
                             f"for {flushes} coalesced flushes")
    failovers = sum(b["failovers"] for b in block_log)
    if failovers or suspect or device_suspect or engine.host_calls:
        raise AssertionError(f"{failovers} failovers to the local engine, clients suspect "
                             f"{suspect}, coalescer device suspect {device_suspect}, "
                             f"{engine.host_calls} flushes served on the host")
    measured = block_log[1:] or block_log
    return {
        "replicas": replicas, "requests": requests, "blocks": blocks, "clients": clients,
        "quorum": quorum, "min_device_batch": min_device_batch, "max_batch": max_batch,
        "block_log": block_log, "flushes": flushes, "launches": launches,
        "sweeps": len(served.sweeps), "sweep_sizes": sorted(set(served.sweeps)),
        "local_calls": len(local.calls), "local_sigs": sum(local.calls),
        "views": sorted(views), "heights": sorted({len(v) for v in digests.values()}),
        "tx_per_s": requests * len(measured) / sum(b["wall_ms"] / 1e3 for b in measured),
        "peak_bytes": peak, "signed_now": signed_now, "sign_s": sign_s,
        "wal_bytes": wal_bytes, "phase_s": time.perf_counter() - phase_t0,
    }


#: Phase 23a: four config-3 groups (7 replicas each, f = 2) on one sim
#: clock, 16 tenants placed by the groups' directory, each group deciding
#: at least 8 times (one round of every tenant's request a decision).
GROUPS = 4
GROUP_TENANTS = 16
GROUP_DECISIONS = 8
GROUPS_SEED = 23
#: The JAX package's gate windows (tests/test_groups.py:292-293): the shared
#: former waits 0.1 s to gather the groups' batches, a private one 0.01 s.
SHARED_WINDOW = 0.1
PRIVATE_WINDOW = 0.01
#: Phase 23b: config 3's 7 replicas and a fleet of 2 sidecars as processes,
#: under the JAX acceptance run's timers (tests/test_zz_deploy_rig.py:113-
#: 120), its supervisor backoff, and decisions of one request (the JAX
#: smoke's ``request_batch_max_count``).
RIG_SIDECARS = 2
RIG_OVERRIDES = {
    "view_change_timeout": 3.0,
    "view_change_resend_interval": 1.0,
    "leader_heartbeat_timeout": 2.0,
    "leader_heartbeat_count": 8,
    "request_batch_max_count": 1,
}
RIG_BACKOFF = 8.0
#: The port's driver_main as its own process: 10 s of the clean trace, at an
#: offered rate the rig's host-path verification keeps up with.
RIG_DRIVER_SECONDS = 10.0
RIG_DRIVER_RATE = 10.0
#: The in-phase injector's transport id (the deploy driver's, outside the
#: replica ids); the injector stops before driver_main takes the id.
RIG_CLIENT_ID = 900
REPO = Path(__file__).resolve().parent


def _forge(workload: dict, gid: str) -> tuple[dict, tuple]:
    """``workload`` with bit 0 of S's byte 8 flipped in the first signature
    of ``gid``'s first batch (S stays below L: the lane fails the group
    equation, not a host check); returns it and that batch."""
    forged = {g: list(batches) for g, batches in workload.items()}
    msgs, sigs, keys = forged[gid][0]
    bad = bytearray(sigs[0])
    bad[40] ^= 1
    batch = (list(msgs), [bytes(bad)] + list(sigs[1:]), list(keys))
    forged[gid][0] = batch
    return forged, batch


def phase_groups_fleet(device, n_groups: int = GROUPS, n: int = REPLICAS,
                       tenants: int = GROUP_TENANTS, decisions: int = GROUP_DECISIONS) -> dict:
    """The groups' shared verifier fleet on ``device``.

    ``ShardedCluster(n_groups, n=n)`` on one sim clock orders ``decisions``
    rounds of every tenant's request (each group at least one decision a
    round), then its committed quorum certificates, re-expressed as real
    Ed25519 signatures (``cert_workload``), are replayed through one shared
    ``FairShareWaveFormer`` (one thread a group) and through one private
    former a group, each over ``Ed25519BatchVerifier`` on ``device`` at
    ``min_device_batch=1``.  The launch counts are set to 0 just before each
    drive and read just after: B1, D1 and D2 launch once per drive launch
    (none on the CPU, where the plain versions run).  Every certificate must
    verify, both drives carry the same signatures, the shared drive launches
    less often than the private ones, and at least one of its launches
    serves two groups.  Then one signature of the last group's first batch is
    forged: the shared drive must raise naming that group, and the device
    path and the host path must both reject that lane alone."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    shard = ShardedCluster(n_groups, n=n, seed=GROUPS_SEED, device=device)
    names = [f"tenant-{t}" for t in range(tenants)]
    placed = {shard.router.directory.assign(t) for t in names}
    if placed != set(shard.group_ids()):
        raise AssertionError(f"the {tenants} tenants reach only groups {sorted(placed)}")
    t0 = time.perf_counter()
    shard.start()
    for r in range(decisions):
        for t in names:
            shard.submit(t, b"round-%d" % r)
        if not shard.run_until_heights(r + 1, max_time=600.0):
            raise AssertionError(f"the groups stalled at heights {shard.heights()}")
    shard.assert_clean()
    sim_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    workload = shard.cert_workload()
    sign_s = time.perf_counter() - t0

    def engine():
        return med.Ed25519BatchVerifier(min_device_batch=1, device=device)

    drives = {
        "shared": lambda w: shard.drive_shared_fleet(window=SHARED_WINDOW, engine=engine(),
                                                     workload=w),
        "private": lambda w: shard.drive_private_fleets(window=PRIVATE_WINDOW,
                                                        engine_factory=engine, workload=w),
    }
    out = {}
    for name, drive in drives.items():
        if on_card:
            torch.cuda.synchronize()
        _reset_launch_counts()
        t0 = time.perf_counter()
        r = drive(workload)
        if on_card:
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = _sidecar_launches()
        if launches != ((r["launches"],) * 3 if on_card else (0, 0, 0)) or not r["launches"]:
            raise AssertionError(f"the {name} drive's {r['launches']} launches launched "
                                 f"(horner_scan, decompress25519, comb25519) {launches}")
        out[name] = dict(r, ms=ms, kernel_launches=launches,
                         mean_wave=r["total_signatures"] / r["launches"])
    shared, private = out["shared"], out["private"]
    if shared["total_signatures"] != private["total_signatures"]:
        raise AssertionError(f"the shared drive verified {shared['total_signatures']} "
                             f"signatures, the private ones {private['total_signatures']}")
    if not shared["launches"] < private["launches"] or shared["multi_group_launches"] < 1:
        raise AssertionError(f"shared {shared['launches']} launches "
                             f"({shared['multi_group_launches']} serving 2+ groups), private "
                             f"{private['launches']}")
    gid = shard.group_ids()[-1]
    forged, (msgs, sigs, keys) = _forge(workload, gid)
    try:
        shard.drive_shared_fleet(window=SHARED_WINDOW, engine=engine(), workload=forged)
    except AssertionError as exc:
        if not str(exc).endswith(f" {gid}"):
            raise AssertionError(f"the forged drive raised {exc!r}, not naming {gid}") from exc
        raised = str(exc)
    else:
        raise AssertionError(f"the shared drive accepted a forged signature of {gid}")
    want = [False] + [True] * (len(msgs) - 1)
    lanes = {
        "device": [bool(v) for v in engine().verify_batch(msgs, sigs, keys)],
        "host": [bool(v) for v in med.Ed25519BatchVerifier(
            min_device_batch=10**9, device=device).verify_batch(msgs, sigs, keys)],
    }
    if any(v != want for v in lanes.values()):
        raise AssertionError(f"the forged batch's verdicts {lanes}, not {want}")
    return {
        "groups": n_groups, "n": n, "tenants": tenants, "decisions": decisions,
        "heights": shard.heights(), "batches": {g: len(b) for g, b in workload.items()},
        "sim_s": sim_s, "sign_s": sign_s, "shared": shared, "private": private,
        "forged_group": gid, "forged_error": raised, "forged_lanes": len(msgs),
    }


class RigInjector:
    """Requests signed with a cluster's client keys, sent to every replica
    over an authenticated ``TcpComm`` from ``RIG_CLIENT_ID``, as the deploy
    driver sends them.  ``port`` is the injector's own listen port."""

    def __init__(self, spec, port: int) -> None:
        self.spec = spec
        self.keyring = make_client_keyring(spec.key_namespace, spec.clients)
        addresses = dict(spec.comm_addresses())
        addresses[RIG_CLIENT_ID] = ("127.0.0.1", port)
        self.comm = TcpComm(RIG_CLIENT_ID, addresses, lambda *a: None,
                            reconnect_backoff=0.05, auth_secret=spec.auth_secret)
        self.comm.start()
        self._seq = 0

    def submit(self, n: int, pace: float = 0.02) -> None:
        for _ in range(n):
            s = self._seq
            self._seq += 1
            client = s % self.spec.clients
            raw = self.keyring.make_request(client, (client << 32) | s)
            for node_id in self.spec.node_ids():
                self.comm.send_transaction(node_id, raw)
            time.sleep(pace)

    def stop(self) -> None:
        self.comm.stop()


def _compute_apps() -> list[tuple[int, str]]:
    """(pid, used memory) of every process holding the card, as nvidia-smi
    reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    rows = [line.split(",", 1) for line in out.stdout.strip().splitlines() if line.strip()]
    return [(int(pid), mem.strip()) for pid, mem in rows]


def _wait(predicate, timeout: float, step: float = 0.2) -> float | None:
    """Seconds until ``predicate()`` held, or None after ``timeout``."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        if predicate():
            return time.perf_counter() - t0
        time.sleep(step)
    return None


def phase_rig(device, n: int = REPLICAS, driver_seconds: float = RIG_DRIVER_SECONDS) -> dict:
    """The deployment rig at config 3's ``n``: ``ClusterSpec.generate(n,
    RIG_SIDECARS, hold_ports=True)`` launched by ``ClusterLauncher(spec,
    device=device)`` as ``n`` processes of the port's ``replica_main`` and
    ``RIG_SIDECARS`` of its ``sidecar_main`` (``--device`` in every argv), then
    the JAX acceptance legs (tests/test_zz_deploy_rig.py:109-205) with
    ``n - f`` replicas as the bar for progress: kill -9 the leader (a view
    change completes and ordering resumes), kill -9 ``sc-0`` (ordering goes
    on with ``sc-1``), and the supervisor's restart of the old leader, which
    rejoins from its WAL to the cluster's height.  Then the port's
    ``driver_main`` runs as its own process for ``driver_seconds``.  The
    invariant monitor must be clean, and ``launcher.stop()`` (always
    reached) must find no orphan and no leaked port.  On the card the
    children's holdings of device memory are read from nvidia-smi."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    f = (n - 1) // 3
    bar = n - f
    phase_t0 = time.perf_counter()
    base = tempfile.mkdtemp(prefix="ctpu-rig-")
    spec = ClusterSpec.generate(n, RIG_SIDECARS, base, config_overrides=RIG_OVERRIDES,
                                hold_ports=True)
    launcher = ClusterLauncher(spec, backoff_initial=RIG_BACKOFF, device=str(device))
    injector = None
    out: dict = {"n": n, "f": f, "bar": bar, "sidecars": RIG_SIDECARS, "backoff": RIG_BACKOFF}
    try:
        with held_ports(1) as (client_port,):
            t0 = time.perf_counter()
            launcher.start(timeout=180)
            out["boot_s"] = time.perf_counter() - t0
            argv = [sup.argv for sup in list(launcher.replicas.values())
                    + list(launcher.sidecars.values())]
            if not all(a[-2:] == ["--device", str(device)] for a in argv):
                raise AssertionError(f"a child was started without --device {device}: {argv}")
            out["gpu_apps"] = _compute_apps() if on_card else None
            out["child_pids"] = [sup.pid for sup in list(launcher.replicas.values())
                                 + list(launcher.sidecars.values())]
            injector = RigInjector(spec, client_port)
            injector.submit(5)
            if not launcher.wait_height(1, timeout=30):
                raise AssertionError(f"the rig never decided: {launcher.heights()}")
            old_leader = launcher.leader_id()
            if old_leader is None:
                raise AssertionError("no replica reports a leader")
            out["old_leader"] = old_leader

            # Leg 1: kill -9 the leader; a view change completes and
            # ordering resumes on n - f replicas.
            launcher.kill_replica(old_leader)
            t_kill = time.perf_counter()

            def view_advanced() -> bool:
                views = [h["view"] for i, sup in launcher.replicas.items()
                         if i != old_leader and (h := sup.probe()) is not None]
                return bool(views) and max(views) >= 1

            out["view_change_s"] = _wait(view_advanced, 40.0)
            if out["view_change_s"] is None:
                raise AssertionError("the view change never completed after the leader's kill")
            h0 = max(launcher.heights().values())

            def progressed(h: int):
                def check() -> bool:
                    injector.submit(2)
                    return sum(1 for v in launcher.heights().values() if v >= h + 1) >= bar
                return check

            out["resume_s"] = _wait(progressed(h0), 40.0, step=0.5)
            if out["resume_s"] is None:
                raise AssertionError(f"ordering did not resume: {launcher.heights()}")
            out["new_leader"] = launcher.leader_id()
            if out["new_leader"] == old_leader:
                raise AssertionError(f"replica {old_leader} still leads after its kill")

            # Leg 2: kill -9 sc-0; ordering goes on with sc-1.
            launcher.kill_sidecar("sc-0")
            h1 = max(launcher.heights().values())
            out["sidecar_kill_s"] = _wait(progressed(h1), 40.0, step=0.5)
            if out["sidecar_kill_s"] is None:
                raise AssertionError(f"ordering stalled after the sidecar's kill: "
                                     f"{launcher.heights()}")

            # Leg 3: the supervisor restarts the old leader, which rejoins
            # from its WAL through verified sync.
            target = max(launcher.heights().values())
            sup = launcher.replicas[old_leader]

            def rejoined() -> bool:
                h = sup.probe()
                return bool(h and h.get("restarted") and h.get("ledger", 0) >= target)

            out["rejoin_s"] = _wait(rejoined, 90.0, step=0.5)
            if out["rejoin_s"] is None:
                raise AssertionError(f"the old leader never rejoined: {sup.probe()}")
            out["rejoin_after_kill_s"] = time.perf_counter() - t_kill
            if sup.restarts < 1:
                raise AssertionError("the old leader was never restarted by its supervisor")
            out["target"] = target
            out["legs_heights"] = launcher.heights()
            out["sidecar_health"] = {sid: s.probe() for sid, s in launcher.sidecars.items()}
            injector.stop()
            injector = None

        # The port's driver_main as its own process.
        env = os.environ.copy()
        env["PYTHONPATH"] = (str(REPO) + os.pathsep + env.get("PYTHONPATH", "")).rstrip(os.pathsep)
        h2 = max(launcher.heights().values())
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "consensus_tpu_torch.deploy.driver_main", "--config",
             spec.config_path, "--seconds", str(driver_seconds), "--rate", str(RIG_DRIVER_RATE)],
            capture_output=True, text=True, env=env, cwd=str(REPO),
            timeout=driver_seconds + 120,
        )
        out["driver_s"] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"driver_main exited {proc.returncode}: {proc.stderr[-2000:]}")
        out["driver"] = json.loads(proc.stdout.strip().splitlines()[-1])
        if out["driver"]["submitted"] < 1:
            raise AssertionError(f"driver_main submitted nothing: {out['driver']}")
        out["driver_drain_s"] = _wait(
            lambda: launcher.wait_height(h2 + 1, timeout=0.5, min_nodes=bar), 60.0)
        if out["driver_drain_s"] is None:
            raise AssertionError(f"the driver's requests were never ordered: "
                                 f"{launcher.heights()}")
        out["heights"] = launcher.heights()
        launcher.observe_invariants()
        launcher.monitor.assert_clean()
        out["agreed"] = len(launcher.monitor.agreed)
        out["restarts"] = {name: s.restarts for name, s in
                           list(launcher.replicas.items()) + list(launcher.sidecars.items())}
    finally:
        if injector is not None:
            injector.stop()
        out["teardown"] = launcher.stop()
        shutil.rmtree(base, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - phase_t0
    return out


def log_groups_fleet(g: dict, card: str) -> None:
    """Print phase 23a's drives."""
    log(f"groups: {g['groups']} groups x {g['n']} replicas on one sim clock, {g['tenants']} "
        f"tenants, {g['decisions']} rounds (heights {g['heights']}, cert batches "
        f"{g['batches']}); sim {g['sim_s']:.3f} s, cert workload signed in {g['sign_s']:.3f} s "
        f"(set-up)")
    for name in ("shared", "private"):
        d = g[name]
        log(f"  {name} drive: {d['ms']:.3f} ms (host clock, ending in torch.cuda.synchronize()); "
            f"launches {d['launches']}, signatures {d['total_signatures']}, mean wave "
            f"{d['mean_wave']:.3f}; (horner_scan, decompress25519, comb25519) launched "
            f"{d['kernel_launches']}"
            + (f"; launches serving 2+ groups {d['multi_group_launches']}" if name == "shared"
               else "") + f"; {card}")
    log(f"  launch sizes: shared {list(g['shared']['launch_sizes'])}, private "
        f"{list(g['private']['launch_sizes'])}")
    log(f"  forged lane in {g['forged_group']}: the shared drive raised {g['forged_error']!r}; "
        f"the batch's {g['forged_lanes']} lanes on the card and on the host path: lane 0 "
        f"rejected, the rest accepted")


def log_rig(r: dict, card: str) -> None:
    """Print phase 23b's legs, driver and teardown."""
    log(f"rig: {r['n']} replica processes (f={r['f']}) and {r['sidecars']} sidecars of the "
        f"port's mains, booted in {r['boot_s']:.3f} s (host clock); supervisor backoff "
        f"{r['backoff']} s; progress bar {r['bar']} replicas")
    log(f"  leg 1: kill -9 leader {r['old_leader']}: view change in {r['view_change_s']:.3f} s, "
        f"ordering resumed {r['resume_s']:.3f} s later, new leader {r['new_leader']}")
    log(f"  leg 2: kill -9 sc-0: ordering went on {r['sidecar_kill_s']:.3f} s later; sidecar "
        f"health {r['sidecar_health']}")
    log(f"  leg 3: replica {r['old_leader']} restarted and rejoined at height >= {r['target']} "
        f"{r['rejoin_s']:.3f} s after the leg began ({r['rejoin_after_kill_s']:.3f} s after its "
        f"kill); heights {r['legs_heights']}")
    log(f"  driver_main, {r['driver_s']:.3f} s as its own process: {json.dumps(r['driver'])}; "
        f"its requests ordered on {r['bar']} replicas {r['driver_drain_s']:.3f} s after it ended")
    log(f"  invariants clean ({r['agreed']} agreed decisions), heights {r['heights']}, "
        f"restarts {r['restarts']}")
    log(f"  teardown: orphans {r['teardown']['orphans']}, leaked ports "
        f"{r['teardown']['leaked_ports']}; phase {r['phase_s']:.3f} s; {card}")
    if r["gpu_apps"] is not None:
        mine = [app for app in r["gpu_apps"] if app[0] in set(r["child_pids"])]
        log(f"  processes holding the card after the rig's boot (nvidia-smi "
            f"--query-compute-apps): {len(r['gpu_apps'])}, {r['gpu_apps']}, this process's "
            f"context among them; the children's pids {r['child_pids']}, matched by pid: "
            f"{mine if mine else 'none'} (nvidia-smi may report pids of another namespace)")


def log_sidecar_tenants(s: dict, direct_ms: float, card: str) -> None:
    """Print phase 22a's sweeps, waves and round trips."""
    log(f"sidecar, {s['tenants']} tenants: phase 3's {s['signatures']} signatures in sweeps of "
        f"{s['sweep']} over TCP (per-tenant mutual handshake, MAC on every frame) to one "
        f"multi-tenant VerifySidecarServer (FairShareWaveFormer, max_wave {s['max_wave']}) over "
        f"Ed25519BatchVerifier at min_device_batch {s['min_device_batch']}; reassembled verdicts "
        f"equal phase 3's on every lane ({s['rejected']} rejected); no failover, no client suspect")
    per_wave = s["tenant_rides"] / s["waves"] if s["waves"] else 0.0
    log(f"  waves {s['waves']} ({per_wave:.2f} tenants a wave), launches (horner_scan, "
        f"decompress25519, comb25519) {s['launches']}; per-tenant signatures and waves "
        f"{ {k: (v['signatures'], v['waves']) for k, v in s['accounting'].items()} }")
    log(f"  round trip per tenant (host clock, barrier to verdicts): "
        + ", ".join(f"{x:.3f} ms" for x in s["roundtrip_ms"])
        + f"; all four {s['wall_ms']:.3f} ms; phase 3's direct wave {direct_ms:.3f} ms; {card}")
    log(f"  torch.cuda.max_memory_allocated: {s['peak_bytes']} bytes")


def log_sidecar_cluster(c: dict, phase12_blocks: list, card: str) -> None:
    """Print phase 22b's blocks beside phase 12's."""
    signed = (f"signed with ref_sign in {c['sign_s']:.3f} s, set-up" if c["signed_now"]
              else "the requests phase 12 signed, reused")
    log(f"cluster over TCP: {c['replicas']} replicas (RealtimeScheduler, TcpComm with "
        f"auth_secret, file WAL) x {c['blocks']} blocks x {c['requests']} signed requests from "
        f"{c['clients']} clients ({signed}); every replica's engine a SidecarVerifierClient on one "
        f"unix-socket VerifySidecarServer over ThreadCoalescingVerifier (max_batch "
        f"{c['max_batch']}) over Ed25519BatchVerifier at min_device_batch {c['min_device_batch']}, "
        f"bypass_below {c['min_device_batch']}")
    log(f"  all ledgers identical (heights {c['heights']}, views {c['views']}), every decision "
        f">= {c['quorum']} signatures, every request ordered exactly once; 0 failovers, no "
        f"client suspect, the coalescer never suspect")
    for i, b in enumerate(c["block_log"]):
        twelve = phase12_blocks[i]["wall_ms"] if i < len(phase12_blocks) else None
        log(f"  block {i + 1}{' (warm-up)' if i == 0 else ''}: {b['wall_ms']:.3f} ms (host clock, "
            f"submit to the last replica's ledger, ending in torch.cuda.synchronize()); sweeps "
            f"to the sidecar {b['sweeps']}, coalesced flushes {b['flushes']}, launches "
            f"(horner_scan, decompress25519, comb25519) {b['launches']}, calls served by the "
            f"local engines {b['local_calls']} (bypassed, {b['failovers']} failovers); collector "
            f"pauses {b['gc_ms']:.3f} ms ({b['collections']} collections, the set-up heap frozen), "
            f"WAL fsync {b['fsync_ms']:.3f} ms ({b['fsyncs']} calls); phase 12's block {i + 1} "
            f"{_ms(twelve)} (the sim, serial waves, heap not frozen)")
    log(f"  sweep sizes {c['sweep_sizes']}; flushes {c['flushes']} for {c['sweeps']} sweeps; local "
        f"calls {c['local_calls']} ({c['local_sigs']} signatures); tx/s over the measured blocks "
        f"{c['tx_per_s']:.1f}; {card}")
    log(f"  torch.cuda.max_memory_allocated: {c['peak_bytes']} bytes; WAL on disk "
        f"{c['wal_bytes']} bytes; phase {c['phase_s']:.3f} s")


def _share(x) -> str:
    return "not measured" if x is None else f"{100 * x:.3f} %"


def _num(x) -> str:
    return "not measured" if x is None else f"{x:.6f}"


def log_mxu(k: dict, w: dict, sass: dict, info: scan_kernels.BuildInfo, card: str) -> None:
    log(f"M1's IMMA instructions (cuobjdump -sass): {sass}")
    log_ptxas(info)
    log(f"M1 held at tolerance 0 (raw limbs, no freeze) to the plain version on CPU copies and "
        f"the VPU lane on the card: {k['checks']} products and squares over "
        f"{sum(len(r) for r in MXU_RANGES.values())} operand ranges at {list(k['widths'])} lanes "
        f"and a (32, 1) constant against {k['broadcast_lanes']} lanes either side (max abs err "
        f"{k['max_abs_err']})")
    for (curve, n), r in k["times"].items():
        b = r["bound"]
        log(f"M1 {curve} product at {n} lanes: {r['ms']:.6f} ms a call through the wrapper, "
            f"{_num(r['launch_ms'])} ms a launch alone (CUDA events, mean of 20 after warm-up); the "
            f"VPU lane's eager product {r['vpu_ms']:.6f} ms; the plain version on the CPU "
            f"{r['plain_ms']:.6f} ms (host clock)")
        log(f"  bound {b['bound_ms']:.6f} ms, by {b['bound_by']}: {b['macs']} dense MACs at "
            f"1,979 int8 TOPS = {b['ops_ms']:.6f} ms; {b['bytes']} bytes over 3.35 TB/s = "
            f"{b['bytes_ms']:.6f} ms; M1 at {100 * b['bound_ms'] / r['ms']:.3f} % of it through "
            f"the wrapper, {_share(r['launch_ms'] and b['bound_ms'] / r['launch_ms'])} alone")
    lib = k["library_ms"]
    width = k["widths"][0]
    log(f"  library: torch._int_mm on one byte plane's (64 x 1024) x (1024 x {width}) int8 "
        f"product, {'not measured' if lib is None else f'{lib:.6f} ms'} (M1 runs three such planes, "
        f"the outer product and the reduction); the VPU lane's eager product "
        f"{k['times'][('ed25519', width)]['vpu_ms']:.6f} ms")
    for name, r in w.items():
        for lane in ("off", "on"):
            x = r[lane]
            log(f"{name} wave, lane {lane}: {r['signatures']} signatures, {r['rejected']} rejected "
                f"as constructed; {', '.join(f'{ms:.3f}' for ms in x['ms'])} ms (host clock, calls "
                f"in the turns {'/'.join(MXU_TURNS)} after one warm-up call a lane, each ending in "
                f"torch.cuda.synchronize()); M1 launches {x['launches']['mxu_limbs']}; kernels "
                f"{x['launches']}; device calls booked {x['calls']}; device busy "
                f"{_share(x['busy_share'])} of a profiled re-run; peak memory "
                f"{x['peak_bytes']} bytes")
        log(f"  {name}: verdicts equal lane off and on; lane on / off (means) = "
            f"{np.mean(r['on']['ms']) / np.mean(r['off']['ms']):.3f}")
    log(f"  ({card})")


def log_mesh(m: dict) -> None:
    """Print phase 20's waves, times and launches."""
    for name, r in m["waves"].items():
        log(f"{name}: {r['signatures']} signatures padded to {r['padded']}, {r['rejected']} "
            f"rejected; the single engine {r['single_ms']:.3f} ms (host clock, ending in "
            f"torch.cuda.synchronize(); after one warm-up call), launches "
            f"{r['single_launches']}")
        for label, run in r["meshes"].items():
            log(f"  {label} mesh ({run['shards']} shards, {run['shard_lanes']} lanes a shard): "
                f"verdicts equal, {run['ms']:.3f} ms, launches {run['launches']} "
                f"({run['shards']} x the single engine's)")
    p = m["padding"]
    log(f"padding-only shards ({p['signatures']} signatures on 8 shards, 5 of them padding "
        f"only): verdicts {p['verdicts']} equal to the strict engine's; launches {p['launches']}")
    log(f"a mesh wider than the visible devices raises: {m['refused']}")


def log_chaos_matrix(m: dict) -> None:
    """Print phase 19's runs, their launches and the supervisor's series."""
    for mode, r in m["modes"].items():
        log(f"{mode} (crypto {r['crypto']!r}): fault-free, faulted and host-path runs give "
            f"byte-identical event logs ({r['event_lines']} lines) and ledgers (heights "
            f"{r['heights']}, {r['deliveries']} deliveries); the faulted run's engine saw "
            f"{r['engine_launches']} verify_batch calls, faults {list(CHAOS_FAULTS)} fired")
        log(f"  wall time (host clock): fault-free {r['clean_s']:.3f} s, faulted "
            f"{r['faulted_s']:.3f} s, host path (device=cpu, min_device_batch=10**9) "
            f"{r['host_s']:.3f} s")
        log(f"  launches, fault-free run: {r['clean_launches']}")
        log(f"  launches, faulted run:    {r['fault_launches']}")
        log(f"  engine series: {r['engine']}")
    o = m["observed"]
    log(f"observed strict faulted run (ObsConfig(enabled=True, sample_interval=2.0)): ledgers "
        f"equal to the obs-off run's; anomalies {o['anomalies']} ({o['anomaly_lines']} "
        f"ANOMALY lines in the event log); {o['samples']} series lines, each parsed as JSON; "
        f"launches {o['launches']}; {o['seconds']:.3f} s (host clock)")


def log_cluster(c: dict, direct_ms: float) -> None:
    """Print phase 12's blocks, their time split, the waves and the checks."""
    signed = (f"signed with ref_sign in {c['sign_s']:.3f} s, set-up" if c["signed_now"]
              else "the requests phase 12 signed, reused")
    log(f"cluster: {c['replicas']} replicas x {c['blocks']} blocks x {c['requests']} signed requests "
        f"from {c['clients']} clients ({signed}); "
        f"all ledgers identical, view 0, every block carries its {c['requests']} requests")
    for i, b in enumerate(c["block_log"]):
        log(f"  block {i + 1}{' (warm-up)' if i == 0 else ''}: {b['wall_ms']:.3f} ms (host clock, ending "
            f"in torch.cuda.synchronize()) = device calls {b['device_ms']:.3f} ms ({b['device_calls']}) "
            f"+ host-path verifications {b['host_ms']:.3f} ms ({b['host_calls']} calls, "
            f"{b['host_sigs']} signatures) + the rest {b['rest_ms']:.3f} ms")
        log(f"    the rest = WAL fsync {b['fsync_ms']:.3f} ms ({b['fsyncs']} calls of os.fsync) "
            f"+ collector pauses outside the engine's calls {b['gc_ms']:.3f} ms "
            f"({b['collections']} collections in the block, gc.callbacks) + what is left "
            f"(protocol, codec, WAL writes, the sim) {b['left_ms']:.3f} ms")
    log(f"  the sim's serial tx/s (the {c['replicas']} waves of a block run in turn on one thread, "
        f"not side by side as in a deployment): {c['tx_per_s']:.1f} over "
        + (f"blocks 2-{c['blocks']}" if c["blocks"] > 2 else "block 2"))
    ms = c["wave_ms"]
    log(f"  device calls {c['device_calls']}: {c['follower_waves']} follower proposal waves and "
        f"{c['leader_waves']} of the leader's own proposal (it verifies what it proposed, "
        f"core/view.py reveal-before-verify), {c['wave_sizes']} signatures on {c['padded']} lanes; "
        f"per wave {min(ms):.3f}-{max(ms):.3f} ms, mean {sum(ms) / len(ms):.3f} ms (host clock, "
        f"through the engine's read-back); phase 3's direct 7-replica wave {direct_ms:.3f} ms")
    log(f"  kernel launches (horner_scan, horner_scan_p256, straus_msm) {c['launches']}, "
        f"sha512 {c['s1_launches']}, (decompress25519, comb25519) {c['d_launches']}; host-path calls {c['host_calls']} ({c['host_sigs']} signatures "
        f"< min_device_batch {c['min_device_batch']}); no coalescer, so nothing can mark the "
        f"device suspect")
    if c["half_agg"]:
        log(f"  half-aggregated certificates: all {c['votes_checked']} decided certificates are "
            f"QuorumCerts of >= {c['quorum']} components, each verified on the host twin; a "
            f"{c['quorum']}-component cert is below min_device_batch {c['min_device_batch']}, so the "
            f"reference's routing aggregates and checks it on the host twin (phase 16 covers the "
            f"device side)")
    else:
        log(f"  commit certificates: >= {c['quorum']} signatures a decision, {c['votes_checked']} "
            f"verified on the engine, {c['reference_checked']} on the RFC 8032 reference")
    log(f"  the last follower wave ({c['profiled_sigs']} signatures), profiled again after the blocks:")
    log_profile(c["profiled"], "horner_scan")
    sc = c["scan"]
    if sc["kernel"] == "sha512":
        log(f"  sha512 on that wave's own blocks ({sc['lanes']} lanes, {sc['blocks']} blocks on the "
            f"block axis): the state equal to sha512_blocks_reference on every lane (max abs err "
            f"{sc['max_abs_err']})")
    else:
        log(f"  horner_scan on that wave's own inputs ({sc['lanes']} lanes): frozen X, Y, Z, T equal "
            f"to horner_scan_reference on every lane (max abs err {sc['max_abs_err']}); kernel "
            f"{sc['ms']:.6f} ms (CUDA events, mean of 20), plain torch version {sc['plain_ms']:.6f} ms "
            f"(mean of 3)")
    log(f"  torch.cuda.max_memory_allocated: {c['peak_bytes']} bytes (torch.cuda.memory_allocated "
        f"before the blocks {c['held_bytes']} bytes); WAL on disk {c['wal_bytes']} bytes; "
        f"phase {c['phase_s']:.3f} s")


def _ms(x) -> str:
    return "not measured" if x is None else f"{x:.3f} ms"


def log_profile(p: dict, kernel: str) -> None:
    """Print a profiled re-run's wall time, busy share and stage split."""
    log(f"  profiled re-run (torch.profiler): {p['wall_ms']:.3f} ms host clock; "
        f"device busy {_ms(p['busy_ms'])}"
        + ("" if p["busy_share"] is None else f", {100 * p['busy_share']:.2f} % of it")
        + f"; {kernel} kernel {_ms(p['kernel_device_ms'])} on the device")
    for name, r in p["ranges"].items():
        log(f"    {name}: host {r['host_ms']:.3f} ms, device {_ms(r['device_ms'])}")
    log(f"    device time in no range: {_ms(p['unranged_ms'])}")


def log_coalesced(c: dict, kernel: str, direct_ms: float) -> None:
    """Print a coalesced wave's flushes, launches, time and peak memory."""
    log(f"wave: {c['replicas']} replica threads x {c['signatures'] // c['replicas']} requests "
        f"= {c['signatures']} signatures through one ThreadCoalescingVerifier (window "
        f"{c['window_s']} s, max_batch {c['signatures']}, hard_cap {c['hard_cap']}, "
        f"bypass_below {c['bypass_below']}); every replica's verdicts equal the direct wave's")
    log(f"  device flushes {c['flushes']}, {kernel} launches {c['launches']}, host-served "
        f"flushes {c['host_calls']}, device suspect: no; each {c['quorum_size']}-vote commit "
        f"quorum bypassed the window on its replica's thread (host path, no launch)")
    log(f"  barrier to the last replica's return {c['wave_ms']:.3f} ms (host clock); the direct "
        f"wave in this run {direct_ms:.3f} ms; difference {c['wave_ms'] - direct_ms:+.3f} ms")
    log(f"  torch.cuda.max_memory_allocated: {c['peak_bytes']} bytes; "
        f"torch.cuda.memory_allocated before the threads {c['held_bytes'][0]} bytes, "
        f"after the coalescer's close {c['held_bytes'][1]} bytes")


def log_split(split: dict | None) -> None:
    """Print each CUDA kernel's device time per call (torch.profiler)."""
    if not split:
        log("    per CUDA kernel: not measured (the profiler saw no device activity)")
    for name, ms in (split or {}).items():
        log(f"    {name}: {ms:.6f} ms per call (torch.profiler, mean of 20 calls)")


def log_ptxas(info: scan_kernels.BuildInfo) -> None:
    """Print each CUDA kernel's and device function's ptxas figures."""
    kernels = ptxas_summary(info.ptxas)
    if not kernels:
        log("  ptxas: not reported (an existing build was loaded)")
    for name, r in kernels.items():
        regs = f"{r['registers']} registers" if "registers" in r else "a device function"
        log(f"  ptxas {name}: {regs}, {r.get('stack')}-byte stack frame, "
            f"{r.get('spill_stores')}/{r.get('spill_loads')} bytes of spill stores/loads, "
            f"{r.get('smem', 0)} bytes of shared memory")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = nvidia_smi("name,power.limit")

    # Phase 1: device and build.
    log("== phase 1: device and build")
    log(f"card (name, power.limit): {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    # One nvcc for each source, all started together.
    # S1's bound reads the card's dependent-issue latency from a clock64()
    # probe (phase 13), built beside the kernels.
    names = list(scan_kernels.KERNELS)
    with ThreadPoolExecutor(len(names) + 1) as pool:
        probe_build = pool.submit(build_latency_probe)
        infos = dict(zip(names, pool.map(scan_kernels.build, names)))
        infos["chain_probe"] = probe_build.result()
    for name, info in infos.items():
        log(f"{name}: nvcc build {info.seconds:.3f} s "
            f"({'existing build loaded' if info.cached else info.command})")
        for line in info.ptxas.splitlines():
            log(f"  ptxas| {line}")
    t0 = time.perf_counter()
    ed.comb_table(device)
    log(f"comb table [d * 2^(8j)]B, 32 x 256 entries, built from integers and "
        f"copied to the card in {time.perf_counter() - t0:.3f} s (set-up; the plain comb's)")
    t0 = time.perf_counter()
    scan_kernels.comb_niels_table(device)
    log(f"D2's table, the same entries as (y - x, y + x, 2d x y) in radix-2^51 limbs "
        f"({scan_kernels.comb_niels_np().nbytes} bytes), built and copied to the card in "
        f"{time.perf_counter() - t0:.3f} s (set-up)")
    t0 = time.perf_counter()
    p256.comb_table(device)
    log(f"P-256 comb table [d * 2^(8j)]G, 32 x 256 entries, built from integers "
        f"and copied to the card in {time.perf_counter() - t0:.3f} s (set-up)")
    props = torch.cuda.get_device_properties(0)
    sm_clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6

    # Phase 2: kernel against its plain version at the main path's width.
    log("== phase 2: horner_scan against horner_scan_reference")
    t0 = time.perf_counter()
    corpus = make_corpus(REQUESTS, per_class=5)
    log(f"corpus: {REQUESTS} requests signed with ref_sign in "
        f"{time.perf_counter() - t0:.3f} s")
    lanes = med._next_pow2(REQUESTS * REPLICAS)
    k = phase_kernel(device, corpus[2], lanes, reps=20, plain_reps=3)
    bound = horner_bound(lanes, props.multi_processor_count, sm_clock_hz)
    log(f"horner_scan at {lanes} lanes ({k['negative_lanes']} with a negative input "
        f"limb): frozen X, Y, Z, T equal on every lane (max abs err {k['max_abs_err']})")
    log(f"  kernel {k['ms']:.6f} ms (CUDA events, mean of 20 launches after warm-up)")
    log(f"  plain torch version {k['plain_ms']:.6f} ms (mean of 3)")
    log(f"  bound {bound['bound_ms']:.6f} ms, by {bound['bound_by']}: "
        f"{HORNER_MULS} multiplications x {MUL_PRODUCTS} + {HORNER_SQUARES} "
        f"squarings x {SQUARE_PRODUCTS} 32x32->64 products per lane = "
        f"{bound['products']} IMAD.WIDE over {props.multi_processor_count} SMs x "
        f"{IMAD_PER_CLOCK_PER_SM}/clock x {sm_clock_hz / 1e6:.0f} MHz = "
        f"{bound['ops_ms']:.6f} ms; {bound['bytes']} bytes over 3.35 TB/s = "
        f"{bound['bytes_ms']:.6f} ms; kernel at {100 * bound['bound_ms'] / k['ms']:.3f} % "
        f"of it")
    sub_bound = horner_bound(k["sub_lanes"], props.multi_processor_count, sm_clock_hz)
    log(f"horner_scan at {k['sub_lanes']} lanes (the first {k['sub_lanes']} columns, "
        f"contiguous: the catch-up chunk's width): frozen X, Y, Z, T equal on every lane "
        f"(max abs err {k['sub_max_abs_err']})")
    log(f"  kernel {k['sub_ms']:.6f} ms (CUDA events, mean of 20 launches after warm-up)")
    log(f"  plain torch version {k['sub_plain_ms']:.6f} ms (mean of 3)")
    log(f"  bound {sub_bound['bound_ms']:.6f} ms, by {sub_bound['bound_by']}; kernel at "
        f"{100 * sub_bound['bound_ms'] / k['sub_ms']:.3f} % of it")
    log_ptxas(infos["horner_scan"])
    log("  library: no single PyTorch call computes this")

    # Phase 3: the main path.
    log("== phase 3: config-3 wave (7 replicas, f=2, 1,000 requests per block)")
    w = phase_wave(device, corpus, replicas=REPLICAS)
    if w["wave_launches"] != 1 or w["d_launches"] != (1, 1):
        raise AssertionError(
            f"wave launched horner_scan {w['wave_launches']} times and (decompress25519, "
            f"comb25519) {w['d_launches']}, not 1 and (1, 1)"
        )
    if w["quorum_launches"] != 0:
        raise AssertionError("the commit quorum launched the kernel")
    log(f"wave: {w['signatures']} signatures padded to {w['padded']}, "
        f"{w['rejected']} rejected as constructed; {w['reference_checked']} "
        f"requests held against ref_verify + _canonical_ok")
    log(f"  launches in the wave: decompress25519 {w['d_launches'][0]}, horner_scan "
        f"{w['wave_launches']}, comb25519 {w['d_launches'][1]}")
    log(f"  end to end {w['wave_ms']:.3f} ms = {w['sigs_per_s']:.1f} signatures/s "
        f"(host clock, ending in torch.cuda.synchronize())")
    if w["other_launches"] != 0:
        raise AssertionError("the Ed25519 wave launched horner_scan_p256 or straus_msm")
    log_profile(w["profiled"], "horner_scan")
    log(f"  torch.cuda.max_memory_allocated: {w['peak_bytes']} bytes")
    log(f"commit quorum: {w['quorum_size']} signatures < crypto_tpu_min_batch "
        f"{w['min_device_batch']}, verified on the engine's host path "
        f"(_verify_host), {w['quorum_launches']} kernel launches")

    # Phase 4: kernel B2 against its plain version on the P-256 wave's inputs.
    log("== phase 4: horner_scan_p256 against horner_scan_p256_reference")
    t0 = time.perf_counter()
    p256_corpus = make_p256_corpus(P256_REQUESTS, per_class=3)
    log(f"P-256 corpus: {P256_REQUESTS} requests, each with its own key, signed "
        f"with ref_p256_sign in {time.perf_counter() - t0:.3f} s")
    k2 = phase_kernel_p256(device, p256_corpus, P256_REPLICAS, reps=20, plain_reps=2)
    bound2 = p256_bound(k2["lanes"], props.multi_processor_count, sm_clock_hz)
    log(f"horner_scan_p256 at {k2['lanes']} lanes ({k2['off_curve_lanes']} with Q off "
        f"the curve, {k2['padded_lanes']} of them padded with all-zero digits): "
        f"frozen X, Y, Z equal on every lane (max abs err {k2['max_abs_err']})")
    log(f"  kernel {k2['ms']:.6f} ms (CUDA events, mean of 20 launches after warm-up)")
    log(f"  plain torch version {k2['plain_ms']:.6f} ms (mean of 2)")
    log(f"  bound {bound2['bound_ms']:.6f} ms, by {bound2['bound_by']}: "
        f"{P256_MULS} multiplications x {P256_MUL_PRODUCTS} + {P256_SQUARES} "
        f"squarings x {P256_SQUARE_PRODUCTS} 32x32->64 products per lane = "
        f"{bound2['products']} IMAD.WIDE over {props.multi_processor_count} SMs x "
        f"{IMAD_PER_CLOCK_PER_SM}/clock x {sm_clock_hz / 1e6:.0f} MHz = "
        f"{bound2['ops_ms']:.6f} ms; {bound2['bytes']} bytes over 3.35 TB/s = "
        f"{bound2['bytes_ms']:.6f} ms")
    log_ptxas(infos["horner_scan_p256"])
    log("  library: none (no PyTorch call computes a P-256 scalar multiplication)")

    # Phase 5: the P-256 path.
    log("== phase 5: config-2 P-256 wave (4 replicas, f=1, 500 requests per proposal)")
    w2 = phase_wave_p256(device, p256_corpus, replicas=P256_REPLICAS)
    if w2["wave_launches"] != 1:
        raise AssertionError(
            f"P-256 wave launched horner_scan_p256 {w2['wave_launches']} times, not 1"
        )
    if w2["other_launches"] != 0:
        raise AssertionError("the P-256 wave launched horner_scan or straus_msm")
    if w2["quorum_launches"] != 0:
        raise AssertionError("the P-256 commit quorum launched a kernel")
    log(f"wave: {w2['signatures']} signatures padded to {w2['padded']}, "
        f"{w2['rejected']} rejected as constructed, {w2['high_s_accepted']} high-s "
        f"lanes accepted; {w2['reference_checked']} requests held against "
        f"ref_p256_verify")
    log(f"  horner_scan_p256 launches in the wave: {w2['wave_launches']}")
    log(f"  end to end {w2['wave_ms']:.3f} ms = {w2['sigs_per_s']:.1f} signatures/s "
        f"(host clock, ending in torch.cuda.synchronize())")
    log_profile(w2["profiled"], "horner_scan_p256")
    log(f"  torch.cuda.max_memory_allocated: {w2['peak_bytes']} bytes")
    log(f"commit quorum: {w2['quorum_size']} signatures < crypto_tpu_min_batch "
        f"{w2['min_device_batch']}, verified through EcdsaP256VerifierMixin on the "
        f"engine's host path (ref_p256_verify), {w2['quorum_launches']} kernel launches")

    # Phase 6: kernel B3 against its plain version on the randomized wave's inputs.
    log("== phase 6: straus_msm against straus_msm_reference")
    t0 = time.perf_counter()
    rand_corpus = make_corpus(REQUESTS, per_class=5, classes=RANDOMIZED_CLASSES)
    log(f"randomized corpus: {REQUESTS} requests signed with ref_sign, 5 lanes of each "
        f"of {', '.join(RANDOMIZED_CLASSES)}, in {time.perf_counter() - t0:.3f} s")
    k3 = phase_kernel_msm(device, rand_corpus, REPLICAS, reps=20)
    bound3 = msm_bound(k3["lanes"], k3["live_lanes"], k3["n_low"],
                       props.multi_processor_count, sm_clock_hz)
    sub_bound3 = msm_bound(k3["sub_lanes"], k3["sub_live_lanes"], k3["n_low"],
                           props.multi_processor_count, sm_clock_hz)
    log(f"straus_msm at {k3['lanes']} lanes (the first aggregate of the phase-7 wave; "
        f"{k3['masked_lanes']} undecodable and {k3['padded_lanes']} padded lanes masked to "
        f"digit 8): affine x and y equal to the plain version's (max abs err "
        f"{k3['max_abs_err']}), not the identity")
    log(f"  kernel {k3['ms']:.6f} ms (CUDA events, mean of 20 launches after warm-up; "
        f"tables, window sums, join and chain)")
    log_split(k3["split"])
    log(f"  plain torch version {k3['plain_ms']:.6f} ms (one run, host clock to synchronize)")
    log(f"  bound {bound3['bound_ms']:.6f} ms, by {bound3['bound_by']}: {bound3['adds']} adds "
        f"({2 * TABLE9_ADDS} + {k3['n_low']} + 64 for each of the {k3['live_lanes']} lanes "
        f"with a nonzero digit) x {ADD_MULS} multiplications and {bound3['doubles']} doubles "
        f"(one chain, and {2 * TABLE9_DOUBLES} for each such lane's tables): "
        f"{bound3['muls']} multiplications and {bound3['squares']} squarings, "
        f"{bound3['products']} IMAD.WIDE over {props.multi_processor_count} SMs x "
        f"{IMAD_PER_CLOCK_PER_SM}/clock x {sm_clock_hz / 1e6:.0f} MHz = "
        f"{bound3['ops_ms']:.6f} ms; {bound3['bytes']} bytes over 3.35 TB/s = "
        f"{bound3['bytes_ms']:.6f} ms; kernel at {100 * bound3['bound_ms'] / k3['ms']:.3f} % "
        f"of it")
    log(f"straus_msm at {k3['sub_lanes']} lanes (the first {k3['sub_lanes']} columns, "
        f"contiguous: the catch-up chunk's width; {k3['sub_live_lanes']} with a nonzero "
        f"digit): affine x and y equal to the plain version's (max abs err "
        f"{k3['sub_max_abs_err']}), not the identity")
    log(f"  kernel {k3['sub_ms']:.6f} ms (CUDA events, mean of 20 launches after warm-up)")
    log_split(k3["sub_split"])
    log(f"  plain torch version {k3['sub_plain_ms']:.6f} ms (one run, host clock to synchronize)")
    log(f"  bound {sub_bound3['bound_ms']:.6f} ms, by {sub_bound3['bound_by']} "
        f"({sub_bound3['adds']} adds, {sub_bound3['doubles']} doubles); kernel at "
        f"{100 * sub_bound3['bound_ms'] / k3['sub_ms']:.3f} % of it")
    log_ptxas(infos["straus_msm"])
    log("  library: none (no PyTorch call computes an Edwards multi-scalar multiplication)")

    # Phase 7: the randomized path.
    log("== phase 7: config-3 randomized wave (batch_verify_mode=True)")
    w3 = phase_wave_randomized(device, rand_corpus, replicas=REPLICAS)
    if w3["msm_launches"] != 2:
        raise AssertionError(
            f"randomized wave launched straus_msm {w3['msm_launches']} times, not 2"
        )
    if w3["horner_launches"] or w3["horner_p256_launches"]:
        raise AssertionError("the randomized wave launched a Horner scan kernel")
    if w3["d_launches"] != (w3["msm_launches"],) * 2:
        raise AssertionError(f"randomized wave launched (D1, D2) {w3['d_launches']}")
    log(f"wave: {w3['signatures']} signatures padded to {w3['padded']}, {w3['rejected']} "
        f"rejected as constructed ({w3['host_rejected']} by the host pre-checks, the rest "
        f"undecodable), equal to the strict engine's verdicts; {w3['reference_checked']} "
        f"requests held against ref_verify + _canonical_ok")
    log(f"  straus_msm launches in the wave: {w3['msm_launches']} (the aggregate, then the "
        f"survivors' re-check); decompress25519 {w3['d_launches'][0]}, comb25519 "
        f"{w3['d_launches'][1]} (one each a check); horner_scan {w3['horner_launches']}, "
        f"horner_scan_p256 {w3['horner_p256_launches']}")
    log(f"  end to end {w3['wave_ms']:.3f} ms = {w3['sigs_per_s']:.1f} signatures/s "
        f"(host clock, ending in torch.cuda.synchronize()); the strict wave of phase 3: "
        f"{w['wave_ms']:.3f} ms = {w['sigs_per_s']:.1f} signatures/s")
    log_profile(w3["profiled"], "straus_msm")
    log(f"  torch.cuda.max_memory_allocated: {w3['peak_bytes']} bytes")

    # Phase 8: a sync catch-up chunk on the randomized engine.
    log("== phase 8: config-3 catch-up chunk (51 decisions x 5-vote quorums)")
    c = phase_catch_up(device, CATCH_UP_DECISIONS)
    if c["msm_launches"] != c["device_checks"]:
        raise AssertionError(
            f"catch-up chunk launched straus_msm {c['msm_launches']} times, but bisection "
            f"has {c['device_checks']} nodes of >= {c['min_device_batch']} votes"
        )
    if c["horner_launches"] or c["horner_p256_launches"]:
        raise AssertionError("the catch-up chunk launched a Horner scan kernel")
    if c["d_launches"] != (c["device_checks"],) * 2:
        raise AssertionError(f"catch-up chunk launched (D1, D2) {c['d_launches']}")
    log(f"chunk: {c['votes']} votes padded to {c['padded']} in one "
        f"verify_consenter_sigs_multi_batch call; forged votes at {c['forged']} came back "
        f"None ({c['rejected']} rejected), equal to the strict engine's answer")
    log(f"  aggregate checks: {c['device_checks']} on the device (>= {c['min_device_batch']} "
        f"votes; straus_msm launches {c['msm_launches']}, decompress25519 {c['d_launches'][0]}, "
        f"comb25519 {c['d_launches'][1]}), {c['host_checks']} on the host")
    log(f"  end to end {c['chunk_ms']:.3f} ms (host clock, ending in torch.cuda.synchronize())")

    # Phases 9-10: the replicas' waves through the coalescer, as the JAX
    # package runs them; the kernels' launches must equal the flushes.
    log("== phase 9: config-3 wave through the coalescer (7 replica threads, one card)")
    c9 = phase_coalesced(device, corpus, REPLICAS, w["verdicts"])
    log_coalesced(c9, "horner_scan", w["wave_ms"])
    log("== phase 10: config-2 P-256 wave through the coalescer (4 replica threads)")
    c10 = phase_coalesced(device, p256_corpus, P256_REPLICAS, w2["verdicts"], curve="p256")
    log_coalesced(c10, "horner_scan_p256", w2["wave_ms"])

    # Phase 11: supervision at the catch-up chunk's width.
    log("== phase 11: engine supervision (catch-up chunk, 255 votes on 256 lanes)")
    s11 = phase_supervised(device, CATCH_UP_DECISIONS)
    for label, kernel in (("strict", "horner_scan"), ("randomized", "straus_msm")):
        r = s11[label]
        log(f"supervised {label} engine (engine_supervision, engine_crosscheck_interval=1): "
            f"rung 0, 1 cross-check, 0 mismatches, 0 degrades; launches (horner_scan, "
            f"horner_scan_p256, straus_msm) {r['launches']}; call {r['call_ms']:.3f} ms, of it "
            f"the host cross-check {1e3 * r['crosscheck_s']:.3f} ms (host clock)")
    for f in s11["faults"]:
        log(f"injected {f['step']}: rung {f['rung']} after the call, launches {f['launches']}, "
            f"host twin {', '.join(f'{1e3 * x:.3f} ms' for x in f['host_s'])} (host clock); "
            f"engine series {f['engine']}")

    # Phase 12: the protocol core, a config-3 cluster ordering blocks.
    log("== phase 12: config-3 cluster (7 replicas, f=2, 1,000 signed requests per block)")
    c12 = phase_cluster(device)
    log_cluster(c12, w["wave_ms"])

    sm_count = props.multi_processor_count
    # Phase 13: kernel S1 against its plain version and hashlib.
    log("== phase 13: sha512 (S1) against sha512_blocks_reference and hashlib")
    latency = dependent_issue_cycles(infos["chain_probe"].library, device)
    probe_sass = sass_block_loop(infos["chain_probe"].library, "chain_probe_kernel")
    log(f"dependent-issue latency {latency['cycles']:.4f} SM clocks an instruction: a clock64() "
        f"probe of one thread, {2 * latency['steps']} and {latency['steps']} steps of S1's "
        f"chain (funnel shift, LOP3, add with carry out, add with carry in) took "
        f"{latency['long']} and {latency['short']} clocks (least of 3 each); the probe's loop is "
        f"{probe_sass['per_block']} SASS instructions for 16 steps")
    k13 = phase_sha512(device, corpus, rand_corpus, REPLICAS, reps=20, plain_reps=2)
    sass = sass_block_loop(infos["sha512"].library)
    log(f"S1's SASS (cuobjdump -sass): {sass['kernel']} instructions in the kernel; its widest "
        f"loop, the consumer's rounds of one block, {sass['per_block']} "
        f"({sass['loop'][0]}-{sass['loop'][1]})")
    labels13 = {
        "wave": (f"the strict wave's challenge blocks R || A || M: {k13['live']} signatures on "
                 f"{k13['lanes']} lanes (a block axis of {k13['block_axis']}, padded lanes 0 "
                 f"blocks): every live lane's digest equal to hashlib.sha512's"),
        "one_block": "the same lanes' first blocks alone (block axis 1)",
        "certs": f"the first {S1_CERT_LANES} lanes (a half-agg certificate's width)",
        "long": (f"{S1_LONG_LANES} lanes of up to {S1_LONG_BLOCKS} blocks: every digest equal "
                 f"to hashlib.sha512's"),
        "root": (f"the randomized wave's transcript root: tag || n || {k13['root_live']} leaf "
                 f"digests = {k13['root_bytes']} bytes on one lane: digest equal to "
                 f"hashlib.sha512's (the plain version is not run there: thousands of eager "
                 f"calls a block)"),
    }
    bounds13 = {}
    for key, label in labels13.items():
        r = k13["widths"][key]
        b = bounds13[key] = sha512_bound(r["n_blocks"], sm_count, sm_clock_hz,
                                         latency["cycles"])
        calls = 5 if key == "root" else 20
        check = ("" if key == "root" else
                 f"; the state equal to the plain version on every lane (max abs err "
                 f"{r['max_abs_err']})")
        log(f"{label}; {int(r['n_blocks'].shape[0])} lanes, {b['blocks']} blocks{check}")
        log(f"  kernel {r['ms']:.6f} ms a call through the wrapper (CUDA events, mean of "
            f"{calls} after warm-up); {r['launch_ms']:.6f} ms a launch alone (mean of {calls} "
            f"back to back on a preallocated output)")
        if key == "wave":
            log(f"  plain torch version {k13['plain_ms']:.6f} ms (mean of 2)")
        log(f"  bound {b['bound_ms']:.6f} ms, by {b['bound_by']}: {SHA512_BLOCK_OPS} integer "
            f"instructions a block x {b['blocks']} = {b['instructions']} over {sm_count} SMs x "
            f"{INT_PER_CLOCK_PER_SM}/clock x {sm_clock_hz / 1e6:.0f} MHz = {b['ops_ms']:.6f} ms; "
            f"the longest lane's chain, {int(r['n_blocks'].max(initial=0))} blocks x 80 rounds "
            f"x {SHA512_CHAIN_DEPTH} dependent instructions x {latency['cycles']:.4f} clocks = "
            f"{b['chain_ms']:.6f} ms; {b['bytes']} bytes over 3.35 TB/s = {b['bytes_ms']:.6f} "
            f"ms; kernel at {100 * b['bound_ms'] / r['ms']:.3f} % of it through the wrapper, "
            f"{100 * b['bound_ms'] / r['launch_ms']:.3f} % alone")
        log(f"  the former yardstick, not the bound: the longest lane's blocks x the block "
            f"loop's {sass['per_block']} SASS instructions at one a clock = "
            f"{sass_issue_ms(r['n_blocks'], sass['per_block'], sm_clock_hz):.6f} ms")
    bound13 = bounds13["wave"]
    log_ptxas(infos["sha512"])
    log("  library: none (no PyTorch call computes SHA-512)")

    # Phase 14: the fused strict wave.
    log("== phase 14: config-3 fused strict wave (device_prep=True)")
    log("  expected launches: sha512 1, decompress25519 1, horner_scan 1, comb25519 1, "
        "horner_scan_p256 0, straus_msm 0")
    f14 = phase_fused_wave(device, corpus, REPLICAS, w["verdicts"])
    if (f14["launches"] != (1, 0, 0) or f14["s1"] != 1 or f14["calls"] != 1
            or f14["d_launches"] != (1, 1)):
        raise AssertionError(
            f"the fused wave launched (B1, B2, B3) {f14['launches']}, S1 {f14['s1']} in "
            f"{f14['calls']} device calls, not (1, 0, 0) and 1 in 1"
        )
    if f14["stream_s1"] != f14["stream_waves"]:
        raise AssertionError(f"verify_stream launched S1 {f14['stream_s1']} times")
    log(f"wave: {f14['signatures']} signatures padded to {f14['padded']} through "
        f"FusedEd25519BatchVerifier, {f14['rejected']} rejected: verdicts equal to phase 3's "
        f"host-prep engine on every lane")
    log(f"  launches: sha512 {f14['s1']}, (horner_scan, horner_scan_p256, straus_msm) "
        f"{f14['launches']}, (decompress25519, comb25519) {f14['d_launches']}, in "
        f"{f14['calls']} device call")
    log(f"  end to end {f14['wave_ms']:.3f} ms = {f14['sigs_per_s']:.1f} signatures/s (host clock, "
        f"ending in torch.cuda.synchronize()); phase 3's host-prep wave {w['wave_ms']:.3f} ms")
    log(f"  host prep on this wave: _prepare_fused {f14['fused_prep_ms']:.3f} ms, the host-prep "
        f"engine's _prepare {f14['host_prep_ms']:.3f} ms (host clock)")
    log_profile(f14["profiled"], "horner_scan")
    log(f"  torch.cuda.max_memory_allocated: {f14['peak_bytes']} bytes (phase 3's wave "
        f"{w['peak_bytes']} bytes)")
    log(f"  verify_stream over {f14['stream_waves']} replicas' 1,000-request waves: verdicts in "
        f"wave order, equal to phase 3's; sha512 launches {f14['stream_s1']}; "
        f"{f14['stream_ms']:.3f} ms (host clock, through the last verdict's read)")

    # Phase 15: the fused randomized wave.
    log("== phase 15: config-3 fused randomized wave (device_prep=True, batch_verify_mode=True)")
    log(f"  expected launches: straus_msm {w3['msm_launches']} (phase 7's aggregate checks), "
        f"sha512 {S1_PER_CHECK * w3['msm_launches']} ({S1_PER_CHECK} a check: challenges, "
        f"leaves, root, coefficients), horner_scan 0, horner_scan_p256 0")
    f15 = phase_fused_randomized(device, rand_corpus, REPLICAS, w3["verdicts"])
    if (f15["launches"] != (0, 0, w3["msm_launches"]) or f15["checks"] != w3["msm_launches"]
            or f15["s1"] != S1_PER_CHECK * f15["checks"]
            or f15["d_launches"] != (f15["checks"],) * 2):
        raise AssertionError(
            f"the fused randomized wave launched (B1, B2, B3) {f15['launches']}, S1 {f15['s1']} "
            f"in {f15['checks']} checks; phase 7 made {w3['msm_launches']}"
        )
    log(f"wave: {f15['signatures']} signatures padded to {f15['padded']} through "
        f"FusedEd25519RandomizedBatchVerifier, {f15['rejected']} rejected: verdicts equal to "
        f"phase 7's on every lane")
    log(f"  launches: straus_msm {f15['launches'][2]} in {f15['checks']} aggregate checks, sha512 "
        f"{f15['s1']}, decompress25519 {f15['d_launches'][0]}, comb25519 {f15['d_launches'][1]}, "
        f"horner_scan {f15['launches'][0]}, horner_scan_p256 {f15['launches'][1]}")
    log(f"  end to end {f15['wave_ms']:.3f} ms = {f15['sigs_per_s']:.1f} signatures/s (host clock, "
        f"ending in torch.cuda.synchronize()); phase 7's host-prep wave {w3['wave_ms']:.3f} ms")
    log_profile(f15["profiled"], "straus_msm")
    log(f"  torch.cuda.max_memory_allocated: {f15['peak_bytes']} bytes (phase 7's wave "
        f"{w3['peak_bytes']} bytes)")

    # Phase 16: half-aggregated certificates.
    log("== phase 16: half-aggregated certificates (the catch-up chunk's 51 decisions)")
    h16 = phase_halfagg_certs(device, CATCH_UP_DECISIONS)
    if (h16["launches"] != (0, 0, h16["certs"]) or h16["checks"] != h16["certs"]
            or h16["s1"] != S1_PER_CHECK * h16["certs"]
            or h16["d_launches"] != (h16["certs"],) * 2):
        raise AssertionError(
            f"{h16['certs']} cert verifies launched (B1, B2, B3) {h16['launches']} and S1 "
            f"{h16['s1']} in {h16['checks']} checks"
        )
    log(f"certs: {h16['certs']} QuorumCerts of {h16['components']} components aggregated through "
        f"a SigOnlyVerifier over FusedEd25519BatchVerifier(min_device_batch=1) in "
        f"{h16['aggregate_ms']:.3f} ms (each a self-check on the card; host clock)")
    log(f"  verified on the card: every verdict equal to the host twin's; straus_msm "
        f"{h16['launches'][2]} launches (one a cert), decompress25519 {h16['d_launches'][0]}, "
        f"comb25519 {h16['d_launches'][1]}, sha512 {h16['s1']}, {h16['checks']} "
        f"fused_halfagg_verify checks; {h16['verify_ms']:.3f} ms for all (host clock), "
        f"{h16['verify_ms'] / h16['certs']:.3f} ms a cert; the host twin {h16['host_ms']:.3f} ms "
        f"for all")
    log(f"  {h16['tampered']} certs with a tampered s_agg rejected on the card and the host twin")
    log(f"  forged votes (flat position, signer) {h16['localized']}: each quorum's aggregate failed, "
        f"bisection localized exactly that signer, equal to the strict engine's verdicts")

    # Phase 17: the configuration path, a config-3 cluster on the fused
    # engine with half-aggregated certificates.
    log("== phase 17: config-3 cluster, Configuration(device_prep=True, cert_mode=\"half-agg\"), "
        f"{FUSED_CLUSTER_BLOCKS} of phase 12's {CLUSTER_BLOCKS} blocks")
    config17 = Configuration(device_prep=True, cert_mode="half-agg",
                             crypto_tpu_min_batch=CLUSTER_MIN_DEVICE_BATCH)
    c17 = phase_cluster(device, blocks=FUSED_CLUSTER_BLOCKS, config=config17)
    if not c17["fused"] or not c17["half_agg"]:
        raise AssertionError("phase 17 did not run the fused engine with half-agg certificates")
    log_cluster(c17, f14["wave_ms"])

    # Phase 18: kernels D1 and D2 against their plain versions.
    log("== phase 18: decompress25519 (D1) and comb25519 (D2) against their plain versions")
    k18 = phase_decompress_comb(device, corpus, REPLICAS, reps=20, plain_reps=3)
    bounds18 = {
        key: decompress_bound(k18[key]["width"], sm_count, sm_clock_hz)
        for key in ("d1", "d1_cluster", "d1_sub")
    }
    bounds18.update({
        key: comb_bound(k18[key]["inputs"][0], sm_count, sm_clock_hz)
        for key in ("d2", "d2_cluster", "d2_one")
    })
    labels = {
        "d1": f"decompress25519 on phase 3's R || A stack ({k18['lanes']} lanes, "
              f"{k18['invalid_points']} points invalid: off-curve keys, y >= p, padding)",
        "d1_cluster": f"decompress25519 on the first {k18['cluster_lanes']} lanes' R || A "
                      f"stack (phase 12's wave width)",
        "d1_sub": f"decompress25519 on the first {k18['sub_lanes']} lanes' R || A stack "
                  f"(the catch-up chunk's width)",
        "d2": f"comb25519 on phase 3's S digits ({k18['lanes']} lanes)",
        "d2_cluster": f"comb25519 on the first {k18['cluster_lanes']} lanes' S digits "
                      f"(phase 12's wave width)",
        "d2_one": "comb25519 on one lane (the randomized check's batch)",
    }
    for key, label in labels.items():
        r, b = k18[key], bounds18[key]
        log(f"{label}, {r['width']} {'points' if key.startswith('d1') else 'lanes'}: "
            + ("valid mask and " if key.startswith("d1") else "")
            + f"frozen X, Y, Z, T equal on every lane (max abs err {r['max_abs_err']})")
        log(f"  kernel {r['ms']:.6f} ms a call through the wrapper (CUDA events, mean of 20 "
            f"after warm-up); {r['launch_ms']:.6f} ms a launch alone (mean of 20 back to back "
            f"on preallocated outputs)")
        log(f"  plain torch version {r['plain_ms']:.6f} ms (mean of 3)")
        if key.startswith("d1"):
            work = (f"{DECOMPRESS_MULS} multiplications x {MUL_PRODUCTS} + {DECOMPRESS_SQUARES} "
                    f"squarings x {SQUARE_PRODUCTS} 32x32->64 products per point")
        else:
            work = (f"{COMB_MULS} multiplications x {MUL_PRODUCTS} 32x32->64 products per lane; "
                    f"{b['entries']} distinct table entries x {COMB_ENTRY_BYTES} bytes read")
        log(f"  bound {b['bound_ms']:.6f} ms, by {b['bound_by']}: {work} = {b['products']} "
            f"IMAD.WIDE over {sm_count} SMs x {IMAD_PER_CLOCK_PER_SM}/clock x "
            f"{sm_clock_hz / 1e6:.0f} MHz = {b['ops_ms']:.6f} ms; {b['bytes']} bytes over "
            f"3.35 TB/s = {b['bytes_ms']:.6f} ms; kernel at "
            f"{100 * b['bound_ms'] / r['ms']:.3f} % of it through the wrapper, "
            f"{100 * b['bound_ms'] / r['launch_ms']:.3f} % alone")
    log_ptxas(infos["decompress25519"])
    log_ptxas(infos["comb25519"])
    log("  library: none (no PyTorch call decompresses an Edwards point or computes [S]B)")

    # Phase 19: the device-fault chaos matrix through the chaos harness.
    log(f"== phase 19: device-fault chaos matrix (seed {CHAOS_SEED}, n=4, {CHAOS_STEPS} steps, "
        f"faults {list(CHAOS_FAULTS)}, engines on the card at min_device_batch=1; mesh2 on "
        f"2 virtual shards of the card)")
    log_chaos_matrix(phase_chaos_matrix(device))

    # Phase 20: the sharded engines over 1-shard and virtual-shard meshes.
    log("== phase 20: the mesh (sharded engines over 1 shard and over virtual shards "
        "of one card)")
    log_mesh(phase_mesh(device, {"strict": corpus, "randomized": rand_corpus,
                                 "p256": p256_corpus}))

    # Phase 21: the tensor-core field lane, kernel M1.
    log("== phase 21: the tensor-core field lane (kernel M1, CTPU_MXU_LIMBS=1)")
    t21 = time.perf_counter()
    sass21 = sass_imma_count(infos["mxu_limbs"].library)
    if not sass21 or not all(sass21.values()):
        raise AssertionError(f"M1 has a function without IMMA instructions: {sass21}")
    k21 = phase_mxu_kernel(device, reps=20, plain_reps=2)
    w21 = phase_mxu_waves(device, {"strict": corpus, "randomized": rand_corpus,
                                   "p256": p256_corpus})
    log_mxu(k21, w21, sass21, infos["mxu_limbs"], card)
    log(f"phase 21 took {time.perf_counter() - t21:.3f} s (host clock)")
    m1 = k21["times"][("ed25519", MXU_WIDTHS[0])]

    # Phase 22: the sidecar and the transport on the card.
    log(f"== phase 22: the sidecar and the transport ({SIDECAR_TENANTS} tenants on one sidecar; "
        f"the config-3 cluster over TCP through one sidecar, {SIDECAR_CLUSTER_BLOCKS} of phase "
        f"12's {CLUSTER_BLOCKS} blocks)")
    t22 = time.perf_counter()
    log_sidecar_tenants(phase_sidecar_tenants(device, corpus, REPLICAS, w["verdicts"]),
                        w["wave_ms"], card)
    log_sidecar_cluster(phase_sidecar_cluster(device), c12["block_log"], card)
    log(f"phase 22 took {time.perf_counter() - t22:.3f} s (host clock)")

    # Phase 23: the consensus groups' shared fleet and the process rig.
    log(f"== phase 23: the groups and the rig ({GROUPS} groups x {REPLICAS} replicas over one "
        f"shared fleet on the card; {REPLICAS} replica and {RIG_SIDECARS} sidecar processes of "
        f"the port's mains)")
    t23 = time.perf_counter()
    gc.collect()
    gc.freeze()
    try:
        log_groups_fleet(phase_groups_fleet(device), card)
        log_rig(phase_rig(device), card)
    finally:
        gc.unfreeze()
    log(f"phase 23 took {time.perf_counter() - t23:.3f} s (host clock)")

    log(card)
    log(json.dumps({"kernels": [
        {
            "name": "horner_scan",
            "route": "cuda",
            "source": "consensus_tpu_torch/csrc/horner_scan.cu",
            "replaces": "consensus_tpu/ops/pallas_scan.py:225",
            "launches": w["wave_launches"],
            "max_abs_err": k["max_abs_err"],
            "ms": k["ms"],
            "plain_ms": k["plain_ms"],
            "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"],
            "library_ms": None,
        },
        {
            "name": "horner_scan_p256",
            "route": "cuda",
            "source": "consensus_tpu_torch/csrc/horner_scan_p256.cu",
            "replaces": "consensus_tpu/ops/pallas_scan.py:357",
            "launches": w2["wave_launches"],
            "max_abs_err": k2["max_abs_err"],
            "ms": k2["ms"],
            "plain_ms": k2["plain_ms"],
            "bound_ms": bound2["bound_ms"],
            "bound_by": bound2["bound_by"],
            "library_ms": None,
        },
        {
            "name": "straus_msm",
            "route": "cuda",
            "source": "consensus_tpu_torch/csrc/straus_msm.cu",
            "replaces": "consensus_tpu/ops/pallas_scan.py:507",
            "launches": w3["msm_launches"],
            "max_abs_err": k3["max_abs_err"],
            "ms": k3["ms"],
            "plain_ms": k3["plain_ms"],
            "bound_ms": bound3["bound_ms"],
            "bound_by": bound3["bound_by"],
            "library_ms": None,
        },
        {
            "name": "sha512",
            "route": "cuda",
            "source": "consensus_tpu_torch/csrc/sha512.cu",
            "replaces": "consensus_tpu/ops/sha512.py:191",
            "launches": f14["s1"],
            "max_abs_err": k13["max_abs_err"],
            "ms": k13["ms"],
            "launch_ms": k13["launch_ms"],
            "plain_ms": k13["plain_ms"],
            "bound_ms": bound13["bound_ms"],
            "bound_by": bound13["bound_by"],
            "library_ms": None,
        },
        {
            "name": "decompress25519",
            "route": "cuda",
            "source": "consensus_tpu_torch/csrc/decompress25519.cu",
            "replaces": "consensus_tpu/ops/ed25519.py:139",
            "launches": w["d_launches"][0],
            "max_abs_err": k18["d1"]["max_abs_err"],
            "ms": k18["d1"]["ms"],
            "launch_ms": k18["d1"]["launch_ms"],
            "plain_ms": k18["d1"]["plain_ms"],
            "bound_ms": bounds18["d1"]["bound_ms"],
            "bound_by": bounds18["d1"]["bound_by"],
            "library_ms": None,
        },
        {
            "name": "comb25519",
            "route": "cuda",
            "source": "consensus_tpu_torch/csrc/comb25519.cu",
            "replaces": "consensus_tpu/ops/ed25519.py:261",
            "launches": w["d_launches"][1],
            "max_abs_err": k18["d2"]["max_abs_err"],
            "ms": k18["d2"]["ms"],
            "launch_ms": k18["d2"]["launch_ms"],
            "plain_ms": k18["d2"]["plain_ms"],
            "bound_ms": bounds18["d2"]["bound_ms"],
            "bound_by": bounds18["d2"]["bound_by"],
            "library_ms": None,
        },
        {
            "name": "mxu_limbs",
            "route": "cuda",
            "source": "consensus_tpu_torch/csrc/mxu_limbs.cu",
            "replaces": "consensus_tpu/ops/mxu_limbs.py:218",
            "launches": w21["strict"]["on"]["launches"]["mxu_limbs"],
            "max_abs_err": k21["max_abs_err"],
            "ms": m1["ms"],
            "launch_ms": m1["launch_ms"],
            "plain_ms": m1["plain_ms"],
            "bound_ms": m1["bound"]["bound_ms"],
            "bound_by": m1["bound"]["bound_by"],
            "library_ms": k21["library_ms"],
        },
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
