#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each ending in torch.cuda.synchronize(); any failure raises and the
script exits non-zero without printing a result:

0. device: a CUDA device must exist; print nvidia-smi's name and power
   limit, and the torch, CUDA and nvcc versions.
1. build the hand-written kernels (csrc/*.cu, one nvcc per source, all
   started together, for sm_90a).
2. kernel against plain version, on the card: the fused kernels B1-B4, the
   digit-matmul kernels B5-B9, the five pairing kernels B10 and the
   sequence-parallel segment kernels B11, B12, B16 for every registered
   parameter set plus n = 8192 on the qtesla-iii-speed prime and the two
   q30 sets (q = 2^30 - 2^18 + 1, 4q 1,048,572 below 2^32: n = 1024 and
   8192, RUNTIME_SETS), B in {1, 3, 64}, random and worst-case operands,
   bit for bit (tolerance 0: every value is an exact residue); B9 also for
   the all-0 and all-(q-1) diagonals; intt(ntt(x)) == x; B5 == B1, B6 == B2, B9 == B8 and each
   B10 pairing == B1 on the same inputs.  B3 takes inputs below 2q, B7
   below the MXU plan's pw_bound.  B9's prepare time (B6, host tables,
   copies) is printed per set.  B11-B16 run for every model axis k in
   {2, 4, 8} the set's split takes (k = 4 at n = 8192), on the path's own
   intermediates and on all-(q-1) shards: B13 against a random constant's
   spectrum and the all-0 and all-(q-1) ones, B15 against their folded
   tables (and against the twin that reads their compact blocks, also on
   LONG_BATCH rows), B16 also under p3x; B13 also against a spectrum of uint32
   values up to 2^32 - 1 and against the twin that reads its compact
   tables, B14 against the twin that reads its compact K2f (also on
   LONG_BATCH rows); the whole SP path equals B1, and the fixed
   and folded SP paths equal B4 and each other.  The folded SP prepare's
   host seconds (B11, B14, fourstep_fold_tables, copies) are printed.  The
   class-boundary kernels B17 and B18 for smallprime, qtesla-i and
   qtesla-iii-speed at every k the split takes and n = 8192 at k = 4, on
   random and all-(q-1) shards, B17 also against the twin that reads its
   compact K1, B18 on B17's own output after the
   exchange; the class path equals B1 and the SP path; building it for the
   four-class qtesla-p-i, qtesla-p-iii and q30 sets raises.  B11, B16 (under p3 and
   p3x), B12-B15, B17 and B18 multiply only their tables' nonzero blocks in
   persistent blocks; each case also runs them on LONG_BATCH rows, so that
   every block walks over several row groups through both of its buffers,
   and prints the rows a block holds, the depth of a product and whether
   the tables sit in shared memory or come through L2.  B5-B9 run in
   persistent blocks that stream their tables through a ring of stages in
   shared memory; every set also runs them on LONG_BATCH rows (B8 against
   a spectrum that holds q - 1, B7 on rows below pw_bound, some at
   pw_bound - 1) and prints their stages and ring.  B10's five pairings,
   B1-B4 run in register passes: every set also runs them on
   LONG_BATCH rows with rows of 0 and q - 1 (B4 against a spectrum that
   holds q - 1; B3 on rows below 2q, some at 2q - 1), against their twins
   (B1-B4 their plain versions) and B1, and prints each one's pass
   plan; then at every length from 2 to 16384 (PASS_LENGTHS, n = 8192 at
   the qtesla-iii-speed prime and at q = 2^30 - 2^18 + 1) on 300 rows with rows of q - 1 in both
   operands (B4: in x and its spectrum; B3: rows of 2q - 1; B2 also
   through B3 back to x); at the lengths whose rows span a thread-block
   cluster (CLUSTER_LENGTHS: n = 32768, 65536 at 786433 and q30, 131072;
   also at B in {1, 3, 64}), and B2 and B3 also at 262144
   (TRANSFORM_LENGTHS).  Past a cluster's reach (SWEEP_LENGTHS: n = 2^18
   at two primes, 2^19, 2^20, 2^21 and 2^25, each at the largest prime
   the registry takes there) B1-B4 and the pairings in their sweep form
   (csrc/pass_sweeps.cu; B2 and B3 at 2^18 under their sweep plan) on 3
   rows and on a row of q - 1 against their twins on the card
   (passes.SweepModel under the same plan) and plain versions, their
   launches a call the plan's.  B5-B9 at n = 8 and 16 (SMALL_RINGS, lane packed:
   32 / n rows a row of 32 lanes) against their twins and B1-B4's plain
   versions, random and worst-case, B in {1, 3, 64, 9000}.  B5-B9 in the
   split form (ops/ntt_mxu_split.py: B2's sweeps from index bit 7 up, the
   split kernel of csrc/ntt_mxu_split.cu, B3's sweeps) at SPLIT_RINGS (n =
   32768 at 786433 and q30, 65536 at q30, 2^18 and 2^20 at their
   SWEEP_RINGS primes) in all five modes against their twins, B in {1, 3,
   64}, row 0 all q - 1 (B7 all pw_bound - 1), intt(ntt(x)) == x, each
   ring's plan and B9 prepare seconds printed; then forced (split=True) at
   qtesla-iii-speed and n = 8192 beside the one-block stream kernel.  Then
   the registration sweep (utils/fuzz_params.py, SWEEP: one prime a bit size
   from 15 to 30 at n = 64 and 256, four at n = 2048) through B1-B16, B17
   and B18 at most 3 classes, against their twins, B1 and 2 C++ oracle
   rows a prime, each prime's plan printed; it fails unless the plans
   reached a split of base 128 and two digit classes.
3. main path at qtesla-iii-speed, B = 32768, through the entry points:
   polymul_negacyclic(algo="mxu"), the default fixed-operand pair of
   polymul_fixed_fn (B6, B8), intt(algo="mxu"), the same three with
   algo="fused" (B1, B2, B4, B3), the "mxu-folded" fixed pair (B6, B9) and
   polymul_negacyclic(algo=p + "_kernel") for the five pairings (B10), the
   sequence-parallel polymul_fourstep_mxu_fn(make_mesh(model=4)) (B11
   twice, B12, B16) and the fixed-operand SP pairs
   polymul_fixed_fourstep_mxu_fn (prepare B11, B14; multiply B11, B13, B16)
   and polymul_fixed_folded_fourstep_mxu_fn (prepare B11, B14; multiply
   B11, B15, B16 under p3x), and the class-boundary SP path
   polymul_fourstep_mxu_classes_fn (B17 twice, B18, B16), with every launch
   count reset just before and read just after (EXPECTED_LAUNCHES); the
   outputs must equal the plain versions on the card and each other (the
   fixed ones B4 and B8), and 8 rows of the mxu, the fused (B1), the
   Stockham kernel's, the folded and the four SP products the big-int
   oracle.
3b. remaining paths at full size, on phase 3's operands (qtesla-iii-speed,
   B = 32768) and more drawn from its generator: algo="nussbaumer" (the
   exact mod-q recursion, Karatsuba base) equal to phase 3's B1 output and
   the big-int oracle on ORACLE_ROWS, its schoolbook base on 64 rows; the
   Z_{2^32-1} ring path at max_coeff = ring_exact_coeff_bound(1024) on
   operands in [0, max_coeff] equal to B1 on them and the oracle, and
   without max_coeff raising; the incomplete NTT at (256, 3329) and
   (512, 7681) against the oracle on ORACLE_ROWS, with intt(ntt(x)) == x;
   at k = 4 Ulysses equal to B1, fixed Ulysses to B4, polymul_dp_fn
   "fused" and "mxu" to B1 and B5, polymul_fixed_dp_fn to B8, the
   plain-torch four-step (local="jnp") to B1 (and its inverse spectrum
   back to x), polymul_sp_fn at batch_hint = B (Ulysses) and at 2 rows (the
   segment kernels) to B1; the launches of that run against
   REMAINING_LAUNCHES.  Each path's time (CUDA events, median of
   EAGER_CALLS calls), its peak device memory and the aten operations it
   dispatches a chunk or a call are printed.
3c. ranks on the card: RANKS = 2 fresh processes (python -m
   qtesla_tpu_torch.parallel.dist_check, loading phase 1's library), joined
   by torch.distributed (gloo on a one-card host, where NCCL refuses two
   ranks on one device and every exchange goes through host memory; NCCL,
   one rank a card, with two or more cards), each on its shard of phase
   3's operands: DP "fused" (B1) and "mxu" (B5) and the fixed DP pair (B6,
   B8) on data = 2; on model = 2 the SP path at chunks 1 and 2 (B11, B12,
   B16), the fixed and folded SP pairs, the class path, Ulysses, fixed
   Ulysses and the plain-torch four-step, every exchange one
   all_to_all_single across the ranks, and the SP path's forward exchange
   alone.  Each path's assembled output must
   equal phase 3's (B1; B4 and B8 for the fixed forms) and the big-int
   oracle on ORACLE_ROWS, each rank's launches PROCESS_LAUNCHES; each
   path's time on the slowest rank (CUDA events, median of RANK_REPEATS),
   each rank's peak memory and the phase's wall time are printed.
3d. q30 at full size: q30-n1024, B = 32768 seeded canonical operands with
   row Q1_ROW all q - 1 in both, one random constant: every algo of
   ALGORITHMS (the 16 of models/polymul.py), the fixed forms "fused",
   "mxu" and "mxu-folded" and the inverses of the first two, the SP path
   and both fixed SP pairs at k = 4 and the incomplete NTT at (1024, q),
   launches against Q30_LAUNCHES; every product equal to B1's (the fixed
   ones to B4's) bit for bit and to the C++ oracle on ORACLE_ROWS and
   Q1_ROW.  Then each kernel B1-B16 (B16 also under p3x; the class path
   refuses the set) timed, median of 40 calls, CUDA events, beside its
   bound; phase 4 prints each beside the kernel's q-III time.
3e. large rings: q30 at n = 32768, B = 1024, and 65536, B = 512 (128 MiB
   an operand; LARGE_RINGS), then the sweep form's rings (SWEEP_RINGS: n =
   2^18, B = 128; 2^20, B = 32; 2^25, B = 4), row 1 all q - 1 in both
   operands, one random constant: polymul_negacyclic "fused" (B1) and the
   five "<pairing>_kernel" algos, polymul_fixed_fn "fused" (B2, B4), ntt
   and intt "fused" (B3(B2(x)) == x), past a cluster's reach the DP form
   of "fused", and at n = 32768 the SP path at k = 4, n1 = 256 (B11 twice,
   B12, B16); launches against large_launches (a sweep call its plan's
   launches), each product against B1 and 4 C++ oracle rows
   (LARGE_ORACLE_ROWS), past a cluster's reach against 8 coefficients of
   rows 0 and -1 from the definition and the closed form of row 1; then
   B1-B4 and the pairings timed there (median of 40, 10 at 2^25; the plain
   version of 6, 2 past a cluster's reach) beside their bytes bound, the
   blocks of their rows' cluster or their launches a call and blocks a
   sweep, B11, B12 and B16 at n = 32768, and B5-B9 at n = 8 and 16, B =
   32768 (median of 40, beside their bound).  Below 2^25 the "mxu" entry
   points run in the counted run too, in the split form:
   polymul_negacyclic "mxu" (against B1 and the oracle with the others),
   polymul_fixed_fn's "mxu" and "mxu-folded" pairs (against B4; B9's
   prepare seconds printed), ntt and intt "mxu" (ntt "mxu" == ntt "fused",
   intt(ntt(x)) == x); each split mode is timed there (the call, median of
   40, and the split kernel's launch alone in turns with its plain version,
   each beside its bound with the tables counted once; the plan's seconds
   beside them).  At 2^25 the MXU plan must refuse, naming the bytes.
   Then the SP paths past n = 32768 (SP_RINGS, n1 = n / 128: 65536 at
   786433 (k = 2, 4, 8) and q30 (k = 4), B = 512; 131072 (k = 4, 8), B =
   256; 2^18 at 7340033 and 1056440321 (k = 4), B = 128; 2^20 (k = 4, 8),
   B = 32; row 1 all q - 1): per ring B1 and B4 against the oracle, per k
   the plan's host seconds, one counted run of polymul_fourstep_mxu_fn,
   both fixed SP pairs (the folded multiply where its prepare takes less
   than FOLD_PREP_LIMIT_S), polymul_fourstep_mxu_classes_fn (q < 2^24),
   local_pipeline_fn and local_fixed_pipeline_fn against
   sp_ring_launches, every product equal to B1 or B4; then each SP kernel
   on the path's intermediates against its compact twin (the split form's
   tile kernels against their plain versions) and timed beside its bound
   (median of 40; the split call, sweeps and tile kernel, beside it);
   polymul_sp_fn at batch_hint 2 at n = 32768 and 65536 against B1; at
   2^25 the SP plan must refuse, naming the bytes.  The column segments
   run their split form (sweeps and csrc/sp_column_split.cu's tile kernel)
   where nloc >= 32768.
4. timing at B = 32768: each kernel and its plain version, CUDA events,
   3 warmup then 20 timed calls, twice in the order plain, kernel, kernel,
   plain (B16 also under p3x), B13, B15, B17, B1, B3, B4, B7 and the five
   B10 pairings, B2 and B14 beside the times their earlier designs took
   (EARLIER_MS), the five pairings and B1-B4 also beside an
   instruction-issue bound
   from their SASS
   (utils/sass_diff.py issue_bound_ms), B6, B11 and B14 also at B = 1
   (the rows of their prepare launches on the main path) and B9's prepare
   time; then
   the whole SP path and
   local_pipeline_fn (one shard's work, no exchange) at k in {2, 4, 8},
   warm and cold (L2 flushed and the host queued ahead before each call;
   B5, B1, B8 and B4 are timed cold too), with the SP cost per shard
   k * t_local / t_B5 and k * t_local / t_B1 on the cold times; then both fixed SP paths and one shard's fixed and folded work
   (local_fixed_pipeline_fn) at k in {2, 4, 8}, k * t_local / t_B8 and
   k * t_local / t_B4; then the class path beside the SP path, one shard's
   class work (local_pipeline_classes_fn) at k in {2, 4, 8} beside
   local_pipeline_fn's, and the class exchange (Dout planes a coefficient)
   against the SP path's.
5. the CLI on the card: ``python -m qtesla_tpu_torch.cli`` as subprocesses
   (loading phase 1's library), each printed with its wall time and each
   required to exit 0: info; correctness --algo all --random at
   qtesla-iii-speed (every algo, kernels included, Identical. to the
   oracle and the all-ones closed form); speed of fused and mxu at B =
   32768 (medians beside phase 4's B1 and B5, no gate), --fixed (B2 + B4,
   B6 + B8, B6 + B9) and --streamed; sweep of fused up to B = 32768;
   microbench; scaling in one process, then --distributed --backend gloo
   scaling --model 2 over CLI_RANKS ranks on the card (torchrun's
   variables; each rank waited on and killed in any case), whose rows must
   carry the shared-card caveat.

It prints a JSON line of the kernels (launches: phase 3's and phase 3e's
summed; the split kernels' times are their launches alone at the largest
ring phase 3e runs them, 2^20 (B17's split form: 2^18 at 7340033); each
with its bound: the larger of
the bytes it must move over 3.35 TB/s and its int8 tensor-core MACs * 2
over 1979 TOP/s; no single PyTorch call computes a negacyclic product mod
q, so library_ms is null), the nvidia-smi line, and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import functools
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import types

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from qtesla_tpu_torch import (available_param_sets, get_params,
                              polymul_negacyclic_oracle, register_param_set)
from qtesla_tpu_torch.models import (ALGORITHMS, intt, ntt,
                                     local_fixed_pipeline_fn,
                                     local_pipeline_classes_fn,
                                     local_pipeline_fn, make_mesh,
                                     polymul_fixed_fn,
                                     polymul_fixed_folded_fourstep_mxu_fn,
                                     polymul_fixed_fourstep_mxu_fn,
                                     polymul_fourstep_mxu_classes_fn,
                                     polymul_fourstep_mxu_fn,
                                     polymul_negacyclic)
from qtesla_tpu_torch.ops import incomplete as INC
from qtesla_tpu_torch.ops import nussbaumer as NU
from qtesla_tpu_torch.ops import ntt_fused as F
from qtesla_tpu_torch.ops import ntt_mxu as M
from qtesla_tpu_torch.ops import ntt_mxu_split as MS
from qtesla_tpu_torch.ops import ntt_pairings as P
from qtesla_tpu_torch.ops.mxu_tables import fold_plan, get_mxu_tables
from qtesla_tpu_torch.ops import passes as Ps
from qtesla_tpu_torch.ops.passes import describe_pass_plan
from qtesla_tpu_torch.ops.incomplete import polymul_incomplete_fn
from qtesla_tpu_torch.ops.tables import get_tables
from qtesla_tpu_torch.oracle import negacyclic_schoolbook
from qtesla_tpu_torch.parallel import (intt_fourstep_sharded_fn,
                                       ntt_fourstep_sharded_fn,
                                       polymul_dp_fn, polymul_fixed_dp_fn,
                                       polymul_fixed_ulysses_fn,
                                       polymul_fourstep_sharded_fn,
                                       polymul_sp_fn, polymul_ulysses_fn,
                                       sp_strategy)
from qtesla_tpu_torch.parallel import dist_check as DC
from qtesla_tpu_torch.parallel import sharded_classes as C
from qtesla_tpu_torch.parallel import sharded_mxu as S
from qtesla_tpu_torch.parallel import sharded_mxu_tables as ST
from qtesla_tpu_torch.parallel import sp_column_split as SC
from qtesla_tpu_torch.parallel.distributed import sp_n1
from qtesla_tpu_torch.parallel.sharded_mxu_tables import (class_boundary_plan,
                                                         fourstep_fold_tables,
                                                         fourstep_mxu_plans)
from qtesla_tpu_torch.utils import fuzz_params as FZ
from qtesla_tpu_torch.utils.build import BUILD_DIR, find_nvcc, load_library
from qtesla_tpu_torch.utils.native import \
    negacyclic_schoolbook as native_schoolbook
from qtesla_tpu_torch.utils.sass_diff import issue_bound_ms, kernel_sass
from qtesla_tpu_torch.utils.timing import time_cuda

MAIN_SET = "qtesla-iii-speed"
MAIN_BATCH = 32768
SMALL_BATCHES = (1, 3, 64)
# rows enough that each persistent block of B11 and B18 takes several groups
LONG_BATCH = 9000
# n = 8192 on the qtesla-iii-speed prime: B1 then needs 64 KB of shared
# memory per block, the opt-in path above 48 KB; B5 holds 2 batch rows per
# block and streams 22 MB of digit tables
WIDE_SET = ("qtesla-iii-speed-n8192", 8192, 8404993)
# q = 2^30 - 2^18 + 1: 4q is 1,048,572 below 2^32, the tightest lazy ranges
# the kernels take ("q < 2^30, so 4q < 2^32"); its MXU plan takes four
# digit classes (so the class path refuses it) and hands the forward on
# canonical (fwd_bound = q), which no shipped set does
Q30 = 1073479681
Q30_SET = ("q30-n1024", 1024, Q30)
Q30_WIDE_SET = ("q30-n8192", 8192, Q30)
# the sets phase 2 registers beside the shipped five; those of n = 8192 run
# the SP kernels at k = 4 alone
RUNTIME_SETS = (WIDE_SET, Q30_SET, Q30_WIDE_SET)
WIDE_NAMES = (WIDE_SET[0], Q30_WIDE_SET[0])
# the sequence-parallel path's model axis on the main path
SP_K = 4
# every kernel: (registry entry, CUDA source)
KERNELS = {name: (k, mod.CUDA_SOURCE) for mod in (F, M, MS, P, S, C, SC)
           for name, k in mod.KERNELS.items()}
# the split forms' kernels (B5-B9 from n = 32768, B11, B16 and B17 from
# nloc = 32768), which only phase 3e's rings launch
NO_SPLIT = {name: 0 for name in (*MS.KERNELS, *SC.KERNELS)}
# launches the main path makes: B6 prepares both single-transform fixed
# forms; B11 runs on both operands of the SP product, on the constant in each
# fixed SP prepare and on x in each fixed SP multiply; B14 in each fixed SP
# prepare; B17 on both operands of the class-boundary product; B16 ends all
# four SP products (under p3x in the folded one)
EXPECTED_LAUNCHES = {name: 1 for name in KERNELS} | NO_SPLIT | {
    "ntt_mxu": 2, "sp_seg1": 6, "sp_seg2_fwd": 2, "sp_seg3": 4,
    "sp_seg1_classes": 2}
# the sets of at most 3 digit classes whose class path phase 2 checks; the
# four-class sets must refuse it
CLASS_SETS = ("smallprime", "qtesla-i", "qtesla-iii-speed")
FOUR_CLASS_SETS = ("qtesla-p-i", "qtesla-p-iii", Q30_SET[0], Q30_WIDE_SET[0])
# the kernels redesigned last, and the medians their earlier designs (B13,
# B14 and B15 modes of the dense sp_kernel, B17 a dense kernel of its own,
# B1-B4 and B10's pairings a thread block a row with a barrier a stage, B7
# the last mode of the dense mxu_kernel) took at the timing phase's shapes
# in this script, on an NVIDIA H100 80GB HBM3 at a 700 W power limit
EARLIER_MS = {"sp_seg2_fixed": 1.2227, "sp_seg1_classes": 0.5931,
              "sp_seg2_folded": 0.5708, "intt_fused": 0.3698,
              "ntt_fused": 0.3591, "sp_seg2_fwd": 0.6422,
              # B1, B4 and B10's pairings before register passes
              "polymul_fused": 0.8215,
              "polymul_fixed_fused": 0.7174,
              # B7 as the dense mxu_kernel
              "intt_mxu": 0.7788,
              "polymul_pairing_gs_ct": 0.8635,
              "polymul_pairing_ct_ct": 0.9216,
              "polymul_pairing_gs_gs": 0.9371,
              "polymul_pairing_ct_gs": 0.9302,
              "polymul_pairing_stockham": 0.8340}
# every length the pass kernels' plans take in one block a row: (n, q), q
# prime and 1 mod 2n
PASS_LENGTHS = ((2, 5), (4, 17), (8, 17), (16, 97), (32, 193), (64, 257),
                (128, 257), (256, 7681), (512, 12289), (1024, 12289),
                (2048, 12289), (4096, 40961), (8192, 8404993), (8192, Q30),
                (16384, 786433))
# the lengths whose rows span a thread-block cluster (B1, B4 and the
# pairings: 2, 4 and 8 blocks a row; B2 and B3 one block at 32768, then 2
# and 4), each also at B in SMALL_BATCHES
CLUSTER_LENGTHS = ((32768, 786433), (32768, Q30), (65536, 786433),
                   (65536, Q30), (131072, 786433))
# the length the kernel of one transform (B2, B3) alone takes beyond them:
# 8 blocks of 1024 threads a row (q = 7 * 2^20 + 1)
TRANSFORM_LENGTHS = ((262144, 7340033),)
# the rings past a cluster's reach, where the pass kernels run their sweep
# form (csrc/pass_sweeps.cu; B2 and B3 from 2^19, at 2^18 under a sweep plan
# given): (n, q), the largest prime the registry takes at each n, and
# 5767169 = 11 * 2^19 + 1 at 2^18
SWEEP_LENGTHS = ((1 << 18, 1056440321), (1 << 18, 5767169),
                 (1 << 19, 1053818881), (1 << 20, 1012924417),
                 (1 << 21, 998244353), (1 << 25, 469762049))
# B5-B9 where a lane block is narrower than the MMA's 32-deep step, lane
# packed (mxu_tables.lane_packed): (n, q)
SMALL_RINGS = ((8, 16417), (16, 16417), (8, Q30), (16, Q30))
# B5-B9's split form (ops/ntt_mxu_split.py) past one block's reach, phase 2:
# (n, q) at their CLUSTER_LENGTHS / SWEEP_RINGS primes, each at B in
# SMALL_BATCHES with row 0 all q - 1; and the sets where phase 2 forces it
# beside the one-block stream kernel
SPLIT_RINGS = ((32768, 786433), (32768, Q30), (65536, Q30),
               (1 << 18, 1056440321), (1 << 20, 1012924417))
SPLIT_FORCED = ("qtesla-iii-speed", "qtesla-iii-speed-n8192")
# each split mode's kernel
SPLIT_ENTRY = MS.KERNEL_OF
# the registration sweep (utils/fuzz_params.py) phase 2 runs: (n, primes a
# bit size, bit sizes)
SWEEP = ((64, 1, range(15, 31)), (256, 1, range(15, 31)),
         (2048, 1, (15, 20, 25, 30)))
# the card's peaks (H100 SXM data sheet) for the bound of each kernel
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
SEED = 20261016
ORACLE_ROWS = (0, 1, 2, 3, MAIN_BATCH - 4, MAIN_BATCH - 3, MAIN_BATCH - 2,
               MAIN_BATCH - 1)
# launches phase 3b's run makes: B1 under Ulysses, DP "fused" and
# polymul_sp_fn at B rows (Ulysses); B2 and B4 the fixed Ulysses pair; B5 DP
# "mxu"; B6 and B8 the fixed DP pair; B11 twice, B12 and B16 polymul_sp_fn
# at 2 rows (the four-step)
REMAINING_LAUNCHES = {name: 0 for name in KERNELS} | {
    "polymul_fused": 3, "ntt_fused": 1, "polymul_fixed_fused": 1,
    "polymul_mxu": 1, "ntt_mxu": 1, "polymul_fixed_mxu": 1, "sp_seg1": 2,
    "sp_seg2": 1, "sp_seg3": 1}
# phase 3c: ranks (processes) on the card, each path of dist_check they run
# (the DP ones on data = RANKS, the others on model = RANKS) and the calls
# each path's time is the median of, after one warmup
RANKS = 2
RANK_PATHS = ("dp:fused", "dp:mxu", "fixed_dp:mxu", "sp:1", "sp:2",
              "fixed_sp", "folded_sp", "classes", "ulysses", "fixed_ulysses",
              "fourstep_jnp", "exchange")
RANK_REPEATS = 3
RANK_TIMEOUT_S = 300
# launches each rank makes in phase 3c's counted run: B1 DP "fused" and
# Ulysses; B5 DP "mxu"; B6 and B8 fixed DP; B11 twice in the SP path at
# chunks 1, four times at chunks 2 and twice in each fixed SP pair (its
# prepare and its multiply), B12 once a chunk, B14 in each fixed SP
# prepare, B13 and B15 once, B16 ending every SP product (one a chunk);
# B17 twice, B18 once in the class path; B2 and B4 fixed Ulysses
PROCESS_LAUNCHES = {name: 0 for name in KERNELS} | {
    "polymul_fused": 2, "ntt_fused": 1, "polymul_fixed_fused": 1,
    "polymul_mxu": 1, "ntt_mxu": 1, "polymul_fixed_mxu": 1, "sp_seg1": 10,
    "sp_seg2": 3, "sp_seg2_fwd": 2, "sp_seg2_fixed": 1, "sp_seg2_folded": 1,
    "sp_seg3": 6, "sp_seg1_classes": 2, "sp_seg2_classes": 1}
# launches phase 3d's run makes at q30-n1024: B1, B5 and the five B10
# pairings as algos; B2 and B4, B6 and B8, B6 and B9 the three fixed forms,
# B3 and B7 their inverses; B11 twice in the SP path and in each fixed SP
# prepare and multiply, B14 in each prepare, B16 ending each SP product; no
# class-path launch (four digit classes)
Q30_LAUNCHES = {name: 1 for name in KERNELS} | NO_SPLIT | {
    "ntt_mxu": 2, "sp_seg1": 6, "sp_seg2_fwd": 2, "sp_seg3": 3,
    "sp_seg1_classes": 0, "sp_seg2_classes": 0}
# phase 3d's row of q - 1 in both operands, checked beside ORACLE_ROWS
Q1_ROW = MAIN_BATCH // 2
# phase 3e: q30 at the largest rings whose products the JAX package
# computes, a row a thread-block cluster in the pass kernels: (name, n, q,
# B), 128 MiB an operand; the SP path at n = 32768, n1 = LARGE_SP_N1
LARGE_RINGS = (("q30-n32768", 32768, Q30, 1024),
               ("q30-n65536", 65536, Q30, 512))
LARGE_SP_N1 = 256
# phase 3e past a cluster's reach, the sweep form: (name, n, q, B), 128 MiB
# an operand at 2^18 and 2^20, 512 MiB at 2^25, the largest ring the
# registry takes (469762049 its only prime); the kernels' medians there of
# SWEEP_TIMED calls (10 at 2^25)
SWEEP_RINGS = (("sweep-n262144", 1 << 18, 1056440321, 128),
               ("sweep-n1048576", 1 << 20, 1012924417, 32),
               ("sweep-n33554432", 1 << 25, 469762049, 4))
# phase 3e's coefficients from the definition, of rows 0 and -1
DEFINITION_COEFFS = 8
# phase 3e's rows against the C++ oracle, row 1 all q - 1 in x and y
LARGE_ORACLE_ROWS = (0, 1, -2, -1)
# the pass kernels phase 3e times at each ring
PASS_KERNELS = ("polymul_fused", "polymul_fixed_fused", "ntt_fused",
                "intt_fused", *(f"polymul_pairing_{p}" for p in P.PAIRINGS))


# the pass kernels' kinds (ops/passes.py SWEEP_KINDS)
PASS_KINDS = dict(zip(PASS_KERNELS, ("B1", "B4", "B2", "B3", *P.PAIRINGS)))


def large_launches(n: int) -> dict:
    """Launches phase 3e's run makes at one ring: B1 and the five B10
    pairings as algos, B2 on the constant and on x, B4 and B3 once, each
    call one launch in its block or cluster form or its plan's sweeps in
    its sweep form; past a cluster's reach B1 again in the DP form; at n =
    32768 the SP path's B11 twice, B12 and B16; where the MXU tables fit
    (``mxu_ring``) the "mxu" calls in the split form (``MXU_CALLS``), each
    its mode's split kernel once and B2's and B3's sweeps
    (``MS.split_launches``)."""
    calls = {k: 1 for k in PASS_KERNELS} | {"ntt_fused": 2}
    if n > Ps.cluster_reach("B1"):
        calls["polymul_fused"] = 2
    out = {name: 0 for name in KERNELS}
    for k, c in calls.items():
        plan = Ps.kernel_plan(n, PASS_KINDS[k])
        out[k] = c * (plan.sweeps if isinstance(plan, Ps.SweepPlan) else 1)
    if n == 32768:
        out |= {"sp_seg1": 2, "sp_seg2": 1, "sp_seg3": 1}
    if mxu_ring(n):
        for mode, c in MXU_CALLS.items():
            for k, v in MS.split_launches(n, mode).items():
                out[k] += c * v
    return out


# phase 3e's "mxu" calls a ring, by split mode: polymul_negacyclic "mxu";
# B6 in the prepare of polymul_fixed_fn's "mxu" and "mxu-folded" pairs and
# in ntt "mxu"; their multiplies; intt "mxu"
MXU_CALLS = {"product": 1, "ntt": 3, "fixed": 1, "folded": 1, "intt": 1}


def mxu_ring(n: int) -> bool:
    """Phase 3e's rings where the "mxu" calls run: those below n = 2^25,
    whose tables (mxu_tables.MAX_TABLE_BYTES) the planner refuses."""
    return n < 1 << 25
# the incomplete NTT's (n, q) in phase 3b: ML-KEM's and NewHope's
INCOMPLETE_SHAPES = ((256, 3329), (512, 7681))
# timed calls of each phase-3b path (after one warmup)
EAGER_CALLS = 5
# phase 5: the CLI's commands, each a subprocess that must exit 0 within
# CLI_TIMEOUT_S; the distributed one over CLI_RANKS ranks on the card
REPO = Path(__file__).resolve().parent
CLI_TIMEOUT_S = 300
CLI_RANKS = 2


# the running phase's title and start (host clock), for its seconds
_PHASE = []


def phase(title: str | None):
    """Print the seconds the running phase took, then start ``title``
    (None: the script's end)."""
    now = time.perf_counter()
    if _PHASE:
        print(f"phase {_PHASE[0]}: {now - _PHASE[1]:.1f} s", flush=True)
    _PHASE[:] = [title, now]
    if title is not None:
        print(f"== {title}", flush=True)


def done():
    torch.cuda.synchronize()


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def max_sm_clock_hz() -> float:
    """The card's highest SM clock (nvidia-smi clocks.max.sm)."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    return float(mhz) * 1e6


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def expect_equal(what: str, got: torch.Tensor, want: torch.Tensor) -> int:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(want.shape)} {want.dtype}")
    err = max_err(got, want)
    if err != 0:
        bad = (got.to(torch.int64) != want.to(torch.int64)).nonzero()[0]
        bad = bad.tolist()
        raise AssertionError(f"{what}: max |kernel - plain| = {err}, first "
                             f"difference at {bad}")
    return err


def expect_canonical(what: str, z: torch.Tensor, shape, q: int) -> None:
    if tuple(z.shape) != tuple(shape) or z.dtype != torch.uint32:
        raise AssertionError(f"{what}: got {tuple(z.shape)} {z.dtype}")
    if int(z.to(torch.int64).max()) >= q:
        raise AssertionError(f"{what}: value >= q={q}")


def _record(errors: dict, kname: str, what: str, got, want) -> None:
    errors[kname] = max(errors[kname], expect_equal(what, got, want))


def _seconds(fn, *args) -> tuple[float, object]:
    """Host seconds of one synchronised call, and its result."""
    done()
    start = time.perf_counter()
    out = fn(*args)
    done()
    return time.perf_counter() - start, out


def fold_prep_seconds(name: str, a: torch.Tensor) -> tuple[float, float]:
    """Host seconds of the "mxu-folded" prepare of one constant, first (with
    the per-set inverse blocks) and second call, each synchronised."""
    prep = polymul_fixed_fn(name, "mxu-folded")[0]
    return tuple(_seconds(prep, a)[0] for _ in range(2))


def kernels_against_plain(errors: dict) -> None:
    dev = torch.device("cuda")
    for entry in RUNTIME_SETS:
        register_param_set(*entry)
    for name in available_param_sets():
        tbl = get_tables(name)
        start = time.perf_counter()
        mt = get_mxu_tables(name)
        plan_s = time.perf_counter() - start
        q, n = tbl.q, tbl.n
        rng = np.random.default_rng(SEED)
        cold_s, prep_s = fold_prep_seconds(
            name, torch.from_numpy(rng.integers(0, q, n, dtype=np.uint32))
            .to(dev))
        # the all-0 and all-(q-1) diagonals through the shared fold plan
        diagonals = [torch.full((n,), d, dtype=torch.int64,
                                device=dev).to(torch.uint32)
                     for d in (0, q - 1)]
        diag_ops = [M.fold_operand(d, mt) for d in diagonals]
        for B in SMALL_BATCHES:
            for kind in ("random", "worst"):
                if kind == "random":
                    xs = rng.integers(0, q, (2, B, n), dtype=np.uint32)
                    lazy = rng.integers(0, 2 * q, (B, n), dtype=np.uint32)
                    pw = rng.integers(0, mt.pw_bound, (B, n), dtype=np.uint32)
                else:
                    xs = np.full((2, B, n), q - 1, dtype=np.uint32)
                    lazy = np.full((B, n), 2 * q - 1, dtype=np.uint32)
                    pw = np.full((B, n), mt.pw_bound - 1, dtype=np.uint32)
                x, y, lazy, pw = (torch.from_numpy(v).to(dev)
                                  for v in (xs[0], xs[1], lazy, pw))
                tag = f"{name} B={B} {kind}"
                spec = F.ntt_plain(y[:1], tbl)
                cases = (
                    ("polymul_fused", F.polymul_fused(x, y, tbl),
                     F.polymul_plain(x, y, tbl)),
                    ("polymul_fixed_fused", F.polymul_fixed_fused(x, spec, tbl),
                     F.polymul_fixed_plain(x, spec, tbl)),
                    ("ntt_fused", F.ntt_fused(x, tbl), F.ntt_plain(x, tbl)),
                    ("intt_fused", F.intt_fused(lazy, tbl),
                     F.intt_plain(lazy, tbl)),
                    ("polymul_mxu", M.polymul_mxu(x, y, mt),
                     M.polymul_mxu_plain(x, y, mt)),
                    ("polymul_fixed_mxu", M.polymul_fixed_mxu(x, spec, mt),
                     M.polymul_fixed_mxu_plain(x, spec, mt)),
                    ("ntt_mxu", M.ntt_mxu(x, mt), M.ntt_mxu_plain(x, mt)),
                    ("intt_mxu", M.intt_mxu(pw, mt), M.intt_mxu_plain(pw, mt)),
                )
                for kname, got, want in cases:
                    _record(errors, kname, f"{kname} {tag}", got, want)
                    if kname == "polymul_mxu":
                        expect_equal(f"B5 == B1 {tag}", got, cases[0][1])
                    if kname == "ntt_mxu":
                        expect_equal(f"B6 == B2 {tag}", got, cases[2][1])
                folded = [(spec, M.fold_operand(spec, mt))]
                folded += zip(diagonals, diag_ops)
                for i, (sp, op) in enumerate(folded):
                    got = M.polymul_fixed_folded_mxu(x, op, mt)
                    _record(errors, "polymul_fixed_folded_mxu",
                            f"B9 {tag} spectrum {i}", got,
                            M.polymul_fixed_folded_mxu_plain(x, op, mt))
                    expect_equal(f"B9 == B8 {tag} spectrum {i}", got,
                                 M.polymul_fixed_mxu(x, sp, mt))
                for p in P.PAIRINGS:
                    kname = f"polymul_pairing_{p}"
                    got = P.polymul_pairing(x, y, tbl, p)
                    _record(errors, kname, f"{kname} {tag}", got,
                            P.polymul_pairing_plain(x, y, tbl, p))
                    expect_equal(f"B10 {p} == B1 {tag}", got, cases[0][1])
                back = F.intt_fused(F.ntt_fused(x, tbl), tbl)
                expect_equal(f"intt(ntt(x)) fused {tag}", back, x)
                back = M.intt_mxu(M.ntt_mxu(x, mt), mt)
                expect_equal(f"intt(ntt(x)) mxu {tag}", back, x)
        x, y = (torch.from_numpy(v).to(dev) for v in rng.integers(
            0, q, (2, LONG_BATCH, n), dtype=np.uint32))
        _record(errors, "polymul_mxu", f"polymul_mxu {name} B={LONG_BATCH}",
                M.polymul_mxu(x, y, mt), M.polymul_mxu_plain(x, y, mt))
        spec = F.ntt_plain(y[:1], tbl)
        op = M.fold_operand(spec, mt)
        _record(errors, "polymul_fixed_folded_mxu",
                f"B9 {name} B={LONG_BATCH}",
                M.polymul_fixed_folded_mxu(x, op, mt),
                M.polymul_fixed_folded_mxu_plain(x, op, mt))
        # a spectrum that holds q - 1 (set in numpy: no uint32 arithmetic on
        # the card)
        spec = spec.cpu().numpy()
        spec[0, ::5] = q - 1
        spec = torch.from_numpy(spec).to(dev)
        _record(errors, "polymul_fixed_mxu", f"B8 {name} B={LONG_BATCH}",
                M.polymul_fixed_mxu(x, spec, mt),
                M.polymul_fixed_mxu_plain(x, spec, mt))
        _record(errors, "ntt_mxu", f"B6 {name} B={LONG_BATCH}",
                M.ntt_mxu(x, mt), M.ntt_mxu_plain(x, mt))
        pw = rng.integers(0, mt.pw_bound, (LONG_BATCH, n), dtype=np.uint32)
        pw[::97] = mt.pw_bound - 1
        pw = torch.from_numpy(pw).to(dev)
        _record(errors, "intt_mxu", f"B7 {name} B={LONG_BATCH}",
                M.intt_mxu(pw, mt), M.intt_mxu_plain(pw, mt))
        # the pass kernels over many blocks, rows of 0 and q - 1 in both
        xy = np.stack([x.cpu().numpy(), y.cpu().numpy()])
        xy[:, 0], xy[:, 1], xy[0, 2], xy[1, 3] = 0, q - 1, 0, q - 1
        x, y = (torch.from_numpy(v).to(dev) for v in xy)
        ref = F.polymul_fused(x, y, tbl)
        _record(errors, "polymul_fused", f"B1 {name} B={LONG_BATCH}", ref,
                F.polymul_plain(x, y, tbl))
        print(f"{name} B1: {describe_pass_plan(F.fused_pass_plan(n))}; "
              f"equal to plain at B={LONG_BATCH}", flush=True)
        _record(errors, "polymul_fixed_fused", f"B4 {name} B={LONG_BATCH}",
                F.polymul_fixed_fused(x, spec, tbl),
                F.polymul_fixed_plain(x, spec, tbl))
        print(f"{name} B4: {describe_pass_plan(F.fixed_pass_plan(n))}; "
              f"equal to plain at B={LONG_BATCH} against a spectrum that "
              f"holds q - 1", flush=True)
        lazy = rng.integers(0, 2 * q, (LONG_BATCH, n), dtype=np.uint32)
        lazy[::97] = 2 * q - 1
        lazy = torch.from_numpy(lazy).to(dev)
        _record(errors, "intt_fused", f"B3 {name} B={LONG_BATCH}",
                F.intt_fused(lazy, tbl), F.intt_plain(lazy, tbl))
        print(f"{name} B3: {describe_pass_plan(F.intt_pass_plan(n))}; "
              f"equal to plain at B={LONG_BATCH} on rows below 2q, some at "
              f"2q - 1", flush=True)
        _record(errors, "ntt_fused", f"B2 {name} B={LONG_BATCH}",
                F.ntt_fused(x, tbl), F.ntt_plain(x, tbl))
        print(f"{name} B2: {describe_pass_plan(F.ntt_pass_plan(n))}; "
              f"equal to plain at B={LONG_BATCH} with rows of 0 and q - 1",
              flush=True)
        for p in P.PAIRINGS:
            kname = f"polymul_pairing_{p}"
            got = P.polymul_pairing(x, y, tbl, p)
            _record(errors, kname, f"{kname} {name} B={LONG_BATCH}", got,
                    P.polymul_pairing_plain(x, y, tbl, p))
            expect_equal(f"B10 {p} == B1 {name} B={LONG_BATCH}", got, ref)
            plan = P.pairing_pass_plan(n, p)
            print(f"{name} {p}: {describe_pass_plan(plan)}; equal to "
                  f"plain and B1 at B={LONG_BATCH}", flush=True)
        p5 = M.stream_plan(mt)
        plans = ", ".join(
            f"{b} {p.stages_f} + {p.stages_i} stages, a ring of {p.ring}, "
            f"{p.rows} rows a group"
            for b, p in (("B9", M.stream_plan(mt, "folded")),
                         ("B8", M.stream_plan(mt, "fixed")),
                         ("B6", M.stream_plan(mt, "ntt")),
                         ("B7", M.stream_plan(mt, "intt"))))
        print(f"{name}: B5 streams {p5.stages_f} + {p5.stages_i} stages of "
              f"{64 * mt.bw * mt.D // 1024} KiB a lane block through a ring "
              f"of {p5.ring} in shared memory; {p5.rows // 2} products a "
              f"group; {plans}; all five also equal to plain at "
              f"B={LONG_BATCH} (B7 on rows below pw_bound, some at "
              f"pw_bound - 1)", flush=True)
        print(f"{name} (n={n}, q={q}; MXU plan {plan_s:.1f} s: Lr={mt.Lr}, "
              f"D={mt.D}, Df={mt.Df}, Di={mt.Di}, rows/block "
              f"{M.block_rows(n, 2)}/{M.block_rows(n, 1)}; B9 prepare "
              f"{prep_s * 1e3:.1f} ms, first {cold_s * 1e3:.1f} ms): B1-B10 "
              f"equal to plain for B in {SMALL_BATCHES}, random and "
              f"worst-case, B9 also for the 0 and q-1 diagonals; B5 == B1, "
              f"B6 == B2, B9 == B8, B10 == B1; intt(ntt(x)) == x",
              flush=True)
    done()


def _n1(name: str) -> int:
    return 1 << (get_tables(name).logn // 2)


def _u32(v: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(v).to("cuda")


def _route(plan) -> str:
    """Where a compact kernel reads its tables under ``plan``."""
    return "in shared memory" if plan.smem_tables else "through L2"


def _fold(plans, spec: torch.Tensor) -> S.FoldedSpOperand:
    return S.fold_sp_operand(*fourstep_fold_tables(plans, spec.cpu().numpy()),
                             plans, "cuda")


def sp_against_plain(errors: dict) -> None:
    """B11-B16 against their twins for every set and model axis, the whole
    SP path against B1 and both fixed SP paths against B4."""
    cases = [(name, k) for name in available_param_sets()
             if name not in WIDE_NAMES for k in (2, 4, 8)] + [
                 (name, 4) for name in WIDE_NAMES]
    for name, k in cases:
        start = time.perf_counter()
        try:
            plans = fourstep_mxu_plans(name, _n1(name), k)
        except ValueError as e:
            print(f"{name} k={k}: no SP split ({e})")
            continue
        plan_s = time.perf_counter() - start
        tbl = get_tables(name)
        q, n, nloc = tbl.q, tbl.n, plans.nloc
        mesh = make_mesh(model=k)
        fn = polymul_fourstep_mxu_fn(name, mesh)
        fprep, fmul = polymul_fixed_fourstep_mxu_fn(name, mesh)
        xprep, xmul = polymul_fixed_folded_fourstep_mxu_fn(name, mesh)
        full = _u32(np.full((k, 3, nloc), q - 1, dtype=np.uint32))
        rng = np.random.default_rng(SEED)
        a = _u32(rng.integers(0, q, n, dtype=np.uint32))
        aspec = fprep(a)
        want = S.seg2_fwd_plain(S.a2a_fwd(S.seg1_plain(
            S.to_shards(a[None], plans), plans), plans), plans).reshape(n)
        _record(errors, "sp_seg2_fwd", f"B14 {name} k={k} prepare", aspec,
                want)
        # the folded prepare, first call (with the per-plan blocks) and second
        prep_s = [_seconds(xprep, a) for _ in range(2)]
        a_op = prep_s[1][1]
        # B13 and B15 against a random constant, the all-0 and all-(q-1)
        # spectra; B13 also against uint32 values up to 2^32 - 1 (JAX
        # stores its spectrum lazy)
        spectra = [aspec] + [_u32(np.full((k, nloc), v, dtype=np.uint32))
                             for v in (0, q - 1)]
        folds = [a_op] + [_fold(plans, sp) for sp in spectra[1:]]
        wide = rng.integers(0, 1 << 32, (k, nloc), dtype=np.uint32)
        wide[:, ::7] = 0xFFFFFFFF
        wide = _u32(wide)
        a_spec = F.ntt_fused(a[None], tbl)
        for B in SMALL_BATCHES:
            for kind in ("random", "worst"):
                if kind == "random":
                    xs = rng.integers(0, q, (2, B, n), dtype=np.uint32)
                else:
                    xs = np.full((2, B, n), q - 1, dtype=np.uint32)
                x, y = (_u32(v) for v in xs)
                tag = f"{name} k={k} B={B} {kind}"
                sx, sy = (S.to_shards(t, plans) for t in (x, y))
                vx, vy = (S.sp_seg1(t, plans) for t in (sx, sy))
                _record(errors, "sp_seg1", f"B11 {tag}", vx,
                        S.seg1_plain(sx, plans))
                vx, vy = (S.a2a_fwd(t, plans) for t in (vx, vy))
                w = S.sp_seg2(vx, vy, plans)
                _record(errors, "sp_seg2", f"B12 {tag}", w,
                        S.seg2_plain(vx, vy, plans))
                w = S.a2a_inv(w, plans)
                z = S.sp_seg3(w, plans)
                _record(errors, "sp_seg3", f"B16 {tag}", z,
                        S.seg3_plain(w, plans))
                got = fn(x, y)
                expect_equal(f"SP path == B1 {tag}", got,
                             F.polymul_fused(x, y, tbl))
                expect_equal(f"SP path == its segments {tag}", got,
                             S.from_shards(z, plans))
                got = S.sp_seg2_fwd(vx, plans)
                _record(errors, "sp_seg2_fwd", f"B14 {tag}", got,
                        S.seg2_fwd_plain(vx, plans))
                _record(errors, "sp_seg2_fwd",
                        f"B14 {tag} against its compact twin", got,
                        S.seg2_fwd_compact_plain(vx, plans))
                for i, (sp, op) in enumerate(zip(spectra, folds)):
                    _record(errors, "sp_seg2_fixed", f"B13 {tag} spectrum {i}",
                            S.sp_seg2_fixed(vx, sp, plans),
                            S.seg2_fixed_plain(vx, sp, plans))
                    got = S.sp_seg2_folded(vx, op, plans)
                    _record(errors, "sp_seg2_folded",
                            f"B15 {tag} spectrum {i}", got,
                            S.seg2_folded_plain(vx, op, plans))
                    _record(errors, "sp_seg2_folded",
                            f"B15 {tag} spectrum {i} against its compact "
                            f"twin", got,
                            S.seg2_folded_compact_plain(vx, op, plans))
                got = S.sp_seg2_fixed(vx, wide, plans)
                _record(errors, "sp_seg2_fixed",
                        f"B13 {tag} full-range spectrum", got,
                        S.seg2_fixed_plain(vx, wide, plans))
                _record(errors, "sp_seg2_fixed",
                        f"B13 {tag} against its compact twin", got,
                        S.seg2_fixed_compact_plain(vx, wide, plans))
                _record(errors, "sp_seg3", f"B16 p3x {tag}",
                        S.sp_seg3(w, plans, folded=True),
                        S.seg3_plain(w, plans, folded=True))
                zf = fmul(x, aspec)
                expect_equal(f"fixed SP path == B4 {tag}", zf,
                             F.polymul_fixed_fused(x, a_spec, tbl))
                expect_equal(f"folded SP path == fixed SP path {tag}",
                             xmul(x, *a_op), zf)
        for kname, got, want in (
                ("sp_seg1", S.sp_seg1(full, plans), S.seg1_plain(full, plans)),
                ("sp_seg2", S.sp_seg2(full, full, plans),
                 S.seg2_plain(full, full, plans)),
                ("sp_seg3", S.sp_seg3(full, plans),
                 S.seg3_plain(full, plans)),
                ("sp_seg2_fwd", S.sp_seg2_fwd(full, plans),
                 S.seg2_fwd_plain(full, plans)),
                ("sp_seg2_fixed", S.sp_seg2_fixed(full, spectra[2], plans),
                 S.seg2_fixed_plain(full, spectra[2], plans)),
                ("sp_seg2_folded", S.sp_seg2_folded(full, folds[2], plans),
                 S.seg2_folded_plain(full, folds[2], plans)),
                ("sp_seg3", S.sp_seg3(full, plans, folded=True),
                 S.seg3_plain(full, plans, folded=True))):
            _record(errors, kname, f"{kname} {name} k={k} all q-1 shards",
                    got, want)
        long = _u32(rng.integers(0, q, (k, LONG_BATCH, nloc),
                                 dtype=np.uint32))
        _record(errors, "sp_seg1", f"B11 {name} k={k} B={LONG_BATCH}",
                S.sp_seg1(long, plans), S.seg1_plain(long, plans))
        flip = long.flip(1).contiguous()
        _record(errors, "sp_seg2", f"B12 {name} k={k} B={LONG_BATCH}",
                S.sp_seg2(long, flip, plans), S.seg2_plain(long, flip, plans))
        for folded, seg in ((False, "sp_seg3"), (True, "sp_seg3 p3x")):
            _record(errors, "sp_seg3", f"B16 {seg} {name} k={k} "
                    f"B={LONG_BATCH}", S.sp_seg3(long, plans, folded=folded),
                    S.seg3_plain(long, plans, folded=folded))
        for i, sp in enumerate((spectra[0], wide)):
            _record(errors, "sp_seg2_fixed",
                    f"B13 {name} k={k} B={LONG_BATCH} spectrum {i}",
                    S.sp_seg2_fixed(long, sp, plans),
                    S.seg2_fixed_plain(long, sp, plans))
        _record(errors, "sp_seg2_fwd", f"B14 {name} k={k} B={LONG_BATCH}",
                S.sp_seg2_fwd(long, plans),
                S.seg2_fwd_compact_plain(long, plans))
        for i, op in enumerate((folds[0], folds[2])):
            _record(errors, "sp_seg2_folded",
                    f"B15 {name} k={k} B={LONG_BATCH} spectrum {i}",
                    S.sp_seg2_folded(long, op, plans),
                    S.seg2_folded_compact_plain(long, op, plans))
        p15 = S.seg2_folded_compact_plan(plans)
        print(f"{name} k={k}: B15 over F's nonzero blocks: {p15.rows} rows "
              f"of x a warp, blocks of {1 << p15.c1.ls} lanes, depth "
              f"{p15.c1.kp} (dense {S.plan_for(plans, 'sp_seg2_folded').kp1}), "
              f"tables {_route(p15)}; also equal to its compact twin at "
              f"B={LONG_BATCH}")
        p14 = S.seg2_fwd_compact_plan(plans)
        print(f"{name} k={k}: B14 over K2f's nonzero blocks: {p14.rows} rows "
              f"of x a warp, blocks of {1 << p14.c1.ls} lanes, depth "
              f"{p14.c1.kp} (dense {S.plan_for(plans, 'sp_seg2_fwd').kp1}), "
              f"tables {_route(p14)}; also equal to its compact twin at "
              f"B={LONG_BATCH}")
        p13 = S.seg2_fixed_compact_plan(plans)
        print(f"{name} k={k}: B13 over K2f's and K2i's nonzero blocks: "
              f"{p13.rows} rows of x a warp, blocks of {1 << p13.c1.ls} "
              f"lanes, depths {p13.c1.kp} and {p13.c2.kp}, tables "
              f"{_route(p13)}; also equal to plain at B={LONG_BATCH}")
        p12 = S.seg2_compact_plan(plans)
        print(f"{name} k={k}: B12 over K2f's and K2i's nonzero blocks: "
              f"{p12.rows // 2} + {p12.rows // 2} rows a warp, blocks of "
              f"{1 << p12.c1.ls} lanes, depths {p12.c1.kp} and {p12.c2.kp} "
              f"(dense {S.plan_for(plans, 'sp_seg2').kp1} and "
              f"{S.plan_for(plans, 'sp_seg2').kp2}), tables {_route(p12)}; "
              f"also equal to plain at B={LONG_BATCH}")
        p11 = S.seg1_compact_plan(plans)
        print(f"{name} k={k}: B11 over K1's nonzero blocks: {p11.rows} rows "
              f"a buffer, blocks of {1 << p11.c1.ls} lanes, depth {p11.c1.kp} "
              f"(dense {S.plan_for(plans, 'sp_seg1').kp1}), tables "
              f"{_route(p11)}; also equal to plain at B={LONG_BATCH}")
        for folded, seg in ((False, "sp_seg3"), (True, "sp_seg3 p3x")):
            p16 = S.seg3_compact_plan(plans, folded)
            print(f"{name} k={k}: B16 ({seg}) over K3's nonzero blocks: "
                  f"{p16.rows} rows a buffer, blocks of {1 << p16.c1.ls} "
                  f"lanes, depth {p16.c1.kp} (dense "
                  f"{S.plan_for(plans, seg).kp1}), tables {_route(p16)}; "
                  f"also equal to plain at B={LONG_BATCH}")
        print(f"{name} k={k} (SP plan {plan_s:.1f} s: nloc={nloc}, "
              f"TW={plans.TW}, A={plans.A}, Lr={plans.Lr}, din p1/p2f/p2i/p3/"
              f"p2x/p3x {plans.p1.din}/{plans.p2f.din}/{plans.p2i.din}/"
              f"{plans.p3.din}/{plans.p2x.din}/{plans.p3x.din}, rows/block "
              f"{p11.rows}/"
              f"{S.plan_for(plans, 'sp_seg2').rows}/"
              f"{p14.rows}; folded SP prepare "
              f"{prep_s[1][0] * 1e3:.1f} ms, first {prep_s[0][0] * 1e3:.1f} "
              f"ms): B11-B16 equal to plain for B in {SMALL_BATCHES}, random, "
              f"worst-case and all-(q-1) shards, B13/B15 for 3 spectra (B13 "
              f"also a full-range one, B14 and B15 also their compact twins), "
              f"B16 also "
              f"under p3x; SP path == B1, fixed SP == folded SP == B4",
              flush=True)
    done()


def classes_against_plain(errors: dict) -> None:
    """B17 and B18 against their twins at every k of the three-class sets
    and n = 8192 (k = 4), B18 on B17's own output after the exchange; the
    class path against B1 and the SP path; the four-class sets refuse it."""
    cases = [(name, k) for name in CLASS_SETS
             for k in (2, 4, 8)] + [(WIDE_SET[0], 4)]
    for name, k in cases:
        try:
            plans = fourstep_mxu_plans(name, _n1(name), k)
        except ValueError as e:
            print(f"{name} k={k}: no SP split ({e})")
            continue
        start = time.perf_counter()
        cp = class_boundary_plan(name, plans.n1, k)
        plan_s = time.perf_counter() - start
        tbl = get_tables(name)
        q, n, nloc = tbl.q, tbl.n, plans.nloc
        mesh = make_mesh(model=k)
        fn = polymul_fourstep_mxu_classes_fn(name, mesh)
        sp = polymul_fourstep_mxu_fn(name, mesh)
        rng = np.random.default_rng(SEED)
        for B in SMALL_BATCHES:
            for kind in ("random", "worst"):
                if kind == "random":
                    xs = rng.integers(0, q, (2, B, n), dtype=np.uint32)
                else:
                    xs = np.full((2, B, n), q - 1, dtype=np.uint32)
                x, y = (_u32(v) for v in xs)
                tag = f"{name} k={k} B={B} {kind}"
                sx, sy = (S.to_shards(t, plans) for t in (x, y))
                ux, uy = (C.sp_seg1_classes(t, plans, cp) for t in (sx, sy))
                _record(errors, "sp_seg1_classes", f"B17 {tag}", ux,
                        C.seg1_classes_plain(sx, plans, cp))
                _record(errors, "sp_seg1_classes",
                        f"B17 {tag} against its compact twin", uy,
                        C.seg1_classes_compact_plain(sy, plans, cp))
                ux, uy = (C.a2a_fwd_classes(t, plans, cp.Dout)
                          for t in (ux, uy))
                _record(errors, "sp_seg2_classes", f"B18 {tag}",
                        C.sp_seg2_classes(ux, uy, plans, cp),
                        C.seg2_classes_plain(ux, uy, plans, cp))
                got = fn(x, y)
                expect_equal(f"class path == B1 {tag}", got,
                             F.polymul_fused(x, y, tbl))
                expect_equal(f"class path == SP path {tag}", got, sp(x, y))
        full = _u32(np.full((k, 3, nloc), q - 1, dtype=np.uint32))
        u = C.sp_seg1_classes(full, plans, cp)
        _record(errors, "sp_seg1_classes",
                f"B17 {name} k={k} all q-1 shards", u,
                C.seg1_classes_plain(full, plans, cp))
        _record(errors, "sp_seg2_classes",
                f"B18 {name} k={k} on B17's all q-1 output",
                C.sp_seg2_classes(u, u, plans, cp),
                C.seg2_classes_plain(u, u, plans, cp))
        long = _u32(rng.integers(0, q, (k, LONG_BATCH, nloc),
                                 dtype=np.uint32))
        _record(errors, "sp_seg1_classes",
                f"B17 {name} k={k} B={LONG_BATCH}",
                C.sp_seg1_classes(long, plans, cp),
                C.seg1_classes_plain(long, plans, cp))
        long = C.seg1_classes_plain(long, plans, cp)
        _record(errors, "sp_seg2_classes",
                f"B18 {name} k={k} B={LONG_BATCH}",
                C.sp_seg2_classes(long, long.flip(1).contiguous(), plans, cp),
                C.seg2_classes_plain(long, long.flip(1).contiguous(), plans,
                                     cp))
        p17 = C.plan_for(plans, cp, "sp_seg1_classes")
        print(f"{name} k={k}: B17 over K1's nonzero blocks: {p17.rows} rows "
              f"a buffer, blocks of {1 << p17.c1.ls} lanes, depth "
              f"{p17.c1.kp}, tables {_route(p17)}; also equal to plain at "
              f"B={LONG_BATCH}")
        p2 = C.plan_for(plans, cp, "sp_seg2_classes")
        print(f"{name} k={k}: B18 over the nonzero blocks: "
              f"{p2.rows // 2} + {p2.rows // 2} rows a warp, blocks of "
              f"{1 << p2.c1.ls} lanes, depths {p2.c1.kp} and {p2.c2.kp} (dense "
              f"{sum(cp.dins) * plans.TW} and "
              f"{S.plan_for(plans, 'sp_seg2').kp2}), tables {_route(p2)}; "
              f"also equal to plain at B={LONG_BATCH}")
        print(f"{name} k={k} (class plan {plan_s:.1f} s: Dout={cp.Dout}, "
              f"dins={cp.dins}, class bounds {cp.bounds}, rows/block B17 "
              f"{p17.rows} B18 "
              f"{p2.rows}): B17 and B18 equal to plain for B in "
              f"{SMALL_BATCHES}, random, worst-case and all-(q-1) shards; "
              f"class path == B1 == SP path", flush=True)
    for name in FOUR_CLASS_SETS:
        try:
            polymul_fourstep_mxu_classes_fn(name, make_mesh(model=4))
        except ValueError as e:
            print(f"{name}: building the class path raises, as it must, so "
                  f"B17 and B18 do not run at this set: {e}")
        else:
            raise AssertionError(f"{name}: the class path was built for "
                                 f"four digit classes")
    done()


def pass_lengths_against_plain(errors: dict) -> None:
    """B1, B4 and the five pairings at every length their plans take, on
    300 rows with rows of q - 1 in both operands (B4: in x, and a spectrum
    that holds q - 1), and B2 and B3 there and at TRANSFORM_LENGTHS: B2 on
    rows of 0 and q - 1, also through B3 back to x, B3 on rows below 2q
    with rows of 2q - 1; the cluster lengths also on the first 1, 3 and 64
    of those rows (registered after the other phase-2 checks, which run
    every registered set)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    for n, q in PASS_LENGTHS + CLUSTER_LENGTHS + TRANSFORM_LENGTHS:
        name = f"pass-n{n}-q{q}"
        register_param_set(name, n, q)
        tbl = get_tables(name)
        batches = ((300,) + SMALL_BATCHES if (n, q) in CLUSTER_LENGTHS
                   else (300,))
        lazy = rng.integers(0, 2 * q, (300, n), dtype=np.uint32)
        lazy[0], lazy[2] = 2 * q - 1, 2 * q - 1
        lazy = torch.from_numpy(lazy).to(dev)
        x = rng.integers(0, q, (300, n), dtype=np.uint32)
        x[0], x[3], x[299] = q - 1, 0, q - 1
        x = torch.from_numpy(x).to(dev)
        for B in batches:
            _record(errors, "intt_fused", f"B3 n={n} q={q} B={B}",
                    F.intt_fused(lazy[:B], tbl), F.intt_plain(lazy[:B], tbl))
            spec = F.ntt_fused(x[:B], tbl)
            _record(errors, "ntt_fused", f"B2 n={n} q={q} B={B}", spec,
                    F.ntt_plain(x[:B], tbl))
            expect_equal(f"B3(B2(x)) == x n={n} q={q} B={B}",
                         F.intt_fused(spec, tbl), x[:B])
        if (n, q) in TRANSFORM_LENGTHS:
            print(f"n={n} q={q}: B2 and B3 equal to plain on 300 rows, "
                  f"B3(B2(x)) == x (B2 {describe_pass_plan(F.ntt_pass_plan(n))}"
                  f"; B3 {describe_pass_plan(F.intt_pass_plan(n))})",
                  flush=True)
            continue
        xy = rng.integers(0, q, (2, 300, n), dtype=np.uint32)
        xy[:, 0], xy[0, 1], xy[1, 2] = q - 1, q - 1, q - 1
        xs, ys = (torch.from_numpy(v).to(dev) for v in xy)
        spec = rng.integers(0, q, n, dtype=np.uint32)
        spec[::3] = q - 1
        spec = torch.from_numpy(spec).to(dev)
        for B in batches:
            x, y = xs[:B], ys[:B]
            ref = F.polymul_plain(x, y, tbl)
            _record(errors, "polymul_fused", f"B1 n={n} q={q} B={B}",
                    F.polymul_fused(x, y, tbl), ref)
            _record(errors, "polymul_fixed_fused", f"B4 n={n} q={q} B={B}",
                    F.polymul_fixed_fused(x, spec, tbl),
                    F.polymul_fixed_plain(x, spec, tbl))
            for p in P.PAIRINGS:
                kname = f"polymul_pairing_{p}"
                got = P.polymul_pairing(x, y, tbl, p)
                _record(errors, kname, f"{kname} n={n} q={q} B={B}", got,
                        P.polymul_pairing_plain(x, y, tbl, p))
                expect_equal(f"B10 {p} == B1 n={n} q={q} B={B}", got, ref)
        b1, b2 = F.fused_pass_plan(n), F.ntt_pass_plan(n)
        print(f"n={n} q={q}: B1-B4 and the five pairings equal to "
              f"plain and B1's plain on B in {batches}, B3(B2(x)) == x "
              f"(B1-B4 {b1.passes}, Stockham "
              f"{P.pairing_pass_plan(n, 'stockham').passes} passes a "
              f"transform; blocks a row: B1, B4 and the pairings "
              f"{b1.cluster}, B2 and B3 {b2.cluster})", flush=True)
        del xs, ys, x, y, lazy
    torch.cuda.empty_cache()
    done()


def small_rings_against_plain(errors: dict) -> None:
    """B5-B9 at SMALL_RINGS (n = 8 and 16: lane blocks narrower than the
    MMA's 32-deep step, 32 / n rows packed to a row of 32 lanes) against
    their twins on random and worst-case rows (all q - 1; B7 all
    pw_bound - 1) at B in SMALL_BATCHES and LONG_BATCH, B8 and B9 against a
    spectrum that holds q - 1; B5 == B1, B6 == B2, B8 == B9 == B4 and x back
    through B7 (registered after the other phase-2 checks)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    for n, q in SMALL_RINGS:
        name = f"mxu-n{n}-q{q}"
        register_param_set(name, n, q)
        tbl, mt = get_tables(name), get_mxu_tables(name)
        for B in SMALL_BATCHES + (LONG_BATCH,):
            for kind in ("random", "worst"):
                if kind == "random":
                    xs = rng.integers(0, q, (2, B, n), dtype=np.uint32)
                    pw = rng.integers(0, mt.pw_bound, (B, n), dtype=np.uint32)
                else:
                    xs = np.full((2, B, n), q - 1, dtype=np.uint32)
                    pw = np.full((B, n), mt.pw_bound - 1, dtype=np.uint32)
                spec = F.ntt_plain(torch.from_numpy(xs[1, :1]), tbl).numpy()
                spec[0, ::3] = q - 1
                x, y, pw, spec = (torch.from_numpy(v).to(dev)
                                  for v in (xs[0], xs[1], pw, spec))
                tag = f"{name} B={B} {kind}"
                b4 = F.polymul_fixed_plain(x, spec, tbl)
                op = M.fold_operand(spec, mt)
                for kname, got, want, same in (
                        ("polymul_mxu", M.polymul_mxu(x, y, mt),
                         M.polymul_mxu_plain(x, y, mt),
                         F.polymul_plain(x, y, tbl)),
                        ("ntt_mxu", M.ntt_mxu(x, mt), M.ntt_mxu_plain(x, mt),
                         F.ntt_plain(x, tbl)),
                        ("intt_mxu", M.intt_mxu(pw, mt),
                         M.intt_mxu_plain(pw, mt), None),
                        ("polymul_fixed_mxu", M.polymul_fixed_mxu(x, spec, mt),
                         M.polymul_fixed_mxu_plain(x, spec, mt), b4),
                        ("polymul_fixed_folded_mxu",
                         M.polymul_fixed_folded_mxu(x, op, mt),
                         M.polymul_fixed_folded_mxu_plain(x, op, mt), b4)):
                    _record(errors, kname, f"{kname} {tag}", got, want)
                    if same is not None:
                        expect_equal(f"{kname} == B1-B4's plain {tag}", got,
                                     same)
                expect_equal(f"B7(B6(x)) == x {tag}",
                             M.intt_mxu(M.ntt_mxu(x, mt), mt), x)
        p5 = M.stream_plan(mt)
        print(f"{name} (n={n}, q={q}; D={mt.D}, Df={mt.Df}@{mt.fwd_base}, "
              f"Di={mt.Di}@{mt.inv_base}, bw={mt.bw}): B5-B9 lane packed, "
              f"{32 // n} rows a row of {p5.n} lanes, {p5.rows} packed rows "
              f"a group, {p5.stages_f} + {p5.stages_i} stages; equal to "
              f"their twins and B1-B4's plain versions for B in "
              f"{SMALL_BATCHES + (LONG_BATCH,)}, random and worst-case",
              flush=True)
    done()


# host seconds of each ring's MXU plan (get_mxu_tables) and B9's prepare
# of one constant, where phase 2 or 3e first took them
PLAN_SECONDS: dict = {}
FOLD_SECONDS: dict = {}


def _ring_name(n: int, q: int) -> str:
    """Phase 3e's name of the ring (n, q) where it runs it, so that its plan
    is made once; else a name of phase 2's own."""
    for name, n2, q2, _ in LARGE_RINGS + SWEEP_RINGS:
        if (n2, q2) == (n, q):
            return name
    return f"split-n{n}-q{q}"


def split_tables(name: str):
    """``get_mxu_tables(name)``, its host seconds recorded the first time."""
    start = time.perf_counter()
    mt = get_mxu_tables(name)
    PLAN_SECONDS.setdefault(name, time.perf_counter() - start)
    return mt


def split_calls(mt, x, y, lazy, spec, op, split=None) -> dict:
    """Each split mode's wrapper call (``split`` forces a form) and its
    twin's, on (B, n) rows x, y, B7's rows ``lazy`` below pw_bound, B8's
    spectrum and B9's folded operand: mode -> (got, plain)."""
    return {
        "product": (M.polymul_mxu(x, y, mt, split=split),
                    M.polymul_mxu_plain(x, y, mt)),
        "fixed": (M.polymul_fixed_mxu(x, spec, mt, split=split),
                  M.polymul_fixed_mxu_plain(x, spec, mt)),
        "folded": (M.polymul_fixed_folded_mxu(x, op, mt, split=split),
                   M.polymul_fixed_folded_mxu_plain(x, op, mt)),
        "ntt": (M.ntt_mxu(x, mt, split=split), M.ntt_mxu_plain(x, mt)),
        "intt": (M.intt_mxu(lazy, mt, split=split),
                 M.intt_mxu_plain(lazy, mt))}


def split_against_plain(errors: dict) -> None:
    """B5-B9's split form (B2's sweeps, the split kernel, B3's sweeps) in
    all five modes at SPLIT_RINGS against the twins, bit for bit, at B in
    SMALL_BATCHES, row 0 all q - 1 in x and y (B7 all pw_bound - 1), B8's
    and B9's spectrum q - 1 at every third lane; then forced (``split=True``)
    at SPLIT_FORCED beside the one-block stream kernel (``split=False``)
    and the twins.  Prints each ring's plan and B9 prepare seconds."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    B = max(SMALL_BATCHES)
    for n, q in SPLIT_RINGS:
        start = time.perf_counter()
        name = _ring_name(n, q)
        register_param_set(name, n, q)
        mt = split_tables(name)
        xs = rng.integers(0, q, (2, B, n), dtype=np.uint32)
        xs[:, 0] = q - 1
        lazy = rng.integers(0, mt.pw_bound, (B, n), dtype=np.uint32)
        lazy[0] = mt.pw_bound - 1
        x, y, lazy = (torch.from_numpy(v).to(dev)
                      for v in (xs[0], xs[1], lazy))
        spec = M.ntt_mxu_plain(y[:1], mt).to(torch.int64)
        spec[0, ::3] = q - 1
        spec = spec.to(torch.uint32)
        t_fold, op = _seconds(M.fold_operand, spec, mt)
        FOLD_SECONDS.setdefault(name, t_fold)
        want = {mode: plain for mode, (_, plain) in
                split_calls(mt, x, y, lazy, spec, op).items()}
        for b in SMALL_BATCHES:
            got = split_calls(mt, x[:b], y[:b], lazy[:b], spec, op)
            for mode, (z, _) in got.items():
                kname = SPLIT_ENTRY[mode]
                _record(errors, kname, f"{kname} {name} B={b}", z,
                        want[mode][:b])
            del got
        back = M.intt_mxu(M.ntt_mxu(x, mt), mt)
        expect_equal(f"split B7(B6(x)) == x {name}", back, x)
        p5 = MS.split_plan(mt)
        fwd, inv = (Ps.sweep_plan(n, kind, low=MS.LOW)
                    for kind in ("B2", "B3"))
        print(f"split {name} (n={n}, q={q}; D={mt.D}, Df={mt.Df}@"
              f"{mt.fwd_base}, Di={mt.Di}@{mt.inv_base}, Lr={mt.Lr}): "
              f"plan {PLAN_SECONDS[name]:.2f} s on the host, tables "
              f"{mt.wf.nbytes + mt.wi.nbytes} bytes, B9 prepare "
              f"{t_fold:.2f} s; all five modes equal their twins at B in "
              f"{SMALL_BATCHES}; split kernel {p5.rows} x rows a block "
              f"(B5), {MS.split_smem(p5)} bytes of shared memory, "
              f"{p5.stages_f} + {p5.stages_i} stages a lane block; wide "
              f"stages {Ps.describe_sweep_plan(fwd)}; "
              f"{Ps.describe_sweep_plan(inv)} "
              f"({time.perf_counter() - start:.1f} s)", flush=True)
        del x, y, lazy, spec, op, want, back
        torch.cuda.empty_cache()
    for name in SPLIT_FORCED:
        mt = get_mxu_tables(name)
        q, n = mt.q, mt.n
        xs = rng.integers(0, q, (2, B, n), dtype=np.uint32)
        xs[:, 0] = q - 1
        lazy = np.full((B, n), mt.pw_bound - 1, dtype=np.uint32)
        x, y, lazy = (torch.from_numpy(v).to(dev)
                      for v in (xs[0], xs[1], lazy))
        spec = M.ntt_mxu_plain(y[:1], mt)
        op = M.fold_operand(spec, mt)
        stream = split_calls(mt, x, y, lazy, spec, op, split=False)
        for mode, (z, plain) in split_calls(mt, x, y, lazy, spec, op,
                                            split=True).items():
            kname = SPLIT_ENTRY[mode]
            _record(errors, kname, f"{kname} forced {name}", z, plain)
            expect_equal(f"{kname} forced {name} == the stream kernel", z,
                         stream[mode][0])
        print(f"split forced at {name} (n={n}): all five modes equal their "
              f"twins and the one-block stream kernel at B={B}", flush=True)
    done()


def _sweep_call(kind: str, tbl, x, y, lazy, spec, plan, twin: bool):
    """``kind``'s wrapper under the sweep ``plan`` on the card, or (twin)
    its twin (``passes.SweepModel``) under the same plan on the card."""
    if kind == "B1":
        return (F.polymul_fused_passes_plain(x, y, tbl, plan) if twin else
                F.polymul_fused(x, y, tbl, plan=plan))
    if kind == "B4":
        return (F.polymul_fixed_fused_passes_plain(x, spec, tbl, plan)
                if twin else F.polymul_fixed_fused(x, spec, tbl, plan=plan))
    if kind == "B2":
        return (F.ntt_passes_plain(x, tbl, plan) if twin else
                F.ntt_fused(x, tbl, plan=plan))
    if kind == "B3":
        return (F.intt_passes_plain(lazy, tbl, plan) if twin else
                F.intt_fused(lazy, tbl, plan=plan))
    return (P.polymul_pairing_passes_plain(x, y, tbl, kind, plan) if twin
            else P.polymul_pairing(x, y, tbl, kind, plan=plan))


def sweep_lengths_against_plain(errors: dict) -> None:
    """B1-B4 and the five pairings in their sweep form at SWEEP_LENGTHS
    (B2 and B3 under their sweep plan at 2^18 too), on 3 rows (row 1 all
    q - 1; B3 below 2q, row 1 all 2q - 1; B4 against a spectrum holding
    q - 1) and on row 1 alone, against their twins (``passes.SweepModel``
    under the same plan, on the card) and plain versions; each call adds
    its plan's launches to the kernel's count (registered after the other
    phase-2 checks)."""
    dev = torch.device("cuda")
    for n, q in SWEEP_LENGTHS:
        start = time.perf_counter()
        name = f"sweep-n{n}-q{q}"
        register_param_set(name, n, q)
        tbl = get_tables(name)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED + n)
        x, y, lazy = (torch.randint(0, m, (3, n), generator=gen, device=dev,
                                    dtype=torch.int64)
                      for m in (q, q, 2 * q))
        x[1], y[1], lazy[1] = q - 1, q - 1, 2 * q - 1
        spec = torch.randint(0, q, (n,), generator=gen, device=dev,
                             dtype=torch.int64)
        spec[::5] = q - 1
        x, y, lazy, spec = (t.to(torch.uint32) for t in (x, y, lazy, spec))
        ref = F.polymul_plain(x, y, tbl)
        plain = {"B1": ref, "B4": F.polymul_fixed_plain(x, spec, tbl),
                 "B2": F.ntt_plain(x, tbl), "B3": F.intt_plain(lazy, tbl)}
        for kind, kname in zip(PASS_KINDS.values(), PASS_KINDS):
            plan = Ps.sweep_plan(n, kind)
            kern = KERNELS[kname][0]
            tag = f"{kname} sweep n={n} q={q}"
            before = kern.launches
            got = _sweep_call(kind, tbl, x, y, lazy, spec, plan, False)
            one = _sweep_call(kind, tbl, x[1:2], y[1:2], lazy[1:2], spec,
                              plan, False)
            done()
            if kern.launches - before != 2 * plan.sweeps:
                raise AssertionError(f"{tag}: {kern.launches - before} "
                                     f"launches for 2 calls of "
                                     f"{plan.sweeps}")
            twin = _sweep_call(kind, tbl, x, y, lazy, spec, plan, True)
            _record(errors, kname, f"{tag} B=3 against its twin", got, twin)
            _record(errors, kname, f"{tag} B=3 against plain", got,
                    plain.get(kind, ref))
            _record(errors, kname, f"{tag} B=1 (all q - 1)", one, twin[1:2])
            del got, one, twin
        expect_equal(f"sweep n={n} q={q} B3(B2(x)) == x", F.intt_fused(
            F.ntt_fused(x, tbl, plan=Ps.sweep_plan(n, "B2")), tbl,
            plan=Ps.sweep_plan(n, "B3")), x)
        k = torch.arange(n, device=dev)
        expect_equal(f"sweep n={n} q={q} B1 closed form",
                     ref[1].to(torch.int64), (2 * k + 2 - n) % q)
        print(f"n={n} q={q}: B1-B4 and the five pairings' sweep form equal "
              f"to their twins and plain versions at B in (1, 3), rows of "
              f"q - 1, B3(B2(x)) == x, {time.perf_counter() - start:.1f} s; "
              f"{Ps.describe_sweep_plan(Ps.sweep_plan(n, 'B1'))}; "
              f"stockham {Ps.sweep_plan(n, 'stockham').sweeps} launches",
              flush=True)
        del x, y, lazy, spec, ref, plain
        torch.cuda.empty_cache()
    done()


def registration_sweep() -> None:
    """utils/fuzz_params.py's sweep on the card (SWEEP): B1-B16 at every
    prime, B17 and B18 where the plan has at most 3 digit classes, against
    their twins, B1 and 2 C++ oracle rows a prime; it fails on any
    mismatch, and unless its plans reached a split of base 128 and a plan
    of two digit classes."""
    lines = []

    def log(line):
        lines.append(line)
        print(line, flush=True)

    start = time.perf_counter()
    failures = sum(FZ.sweep(n, FZ.primes_for_n(n, k, bits), "cuda", sp=True,
                            seed=SEED, log=log)
                   for n, k, bits in SWEEP)
    plans = [line for line in lines if line.startswith("  q=")]
    print(f"registration sweep: {len(plans)} primes, {failures} "
          f"mismatching, {time.perf_counter() - start:.1f} s", flush=True)
    if failures:
        raise AssertionError(f"registration sweep: {failures} primes differ")
    for region, found in (("a split of base 128",
                           any("@128" in line for line in plans)),
                          ("two digit classes",
                           any(" D=2 " in line for line in plans))):
        if not found:
            raise AssertionError(f"registration sweep: no plan of {region}")
    done()


def main_path(errors: dict, seed: int) -> dict:
    ps = get_params(MAIN_SET)
    tbl = get_tables(MAIN_SET)
    mt = get_mxu_tables(MAIN_SET)
    n, q, B = ps.n, ps.q, MAIN_BATCH
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    print(f"operands: torch.Generator(device='cuda') seed {seed}")

    def draw(rows):
        return torch.randint(0, q, (rows, n), generator=gen, device="cuda",
                             dtype=torch.int64).to(torch.uint32)

    x, y, a = draw(B), draw(B), draw(1)
    mesh = make_mesh(model=SP_K)
    sp = polymul_fourstep_mxu_fn(MAIN_SET, mesh)
    sp_fixed = polymul_fixed_fourstep_mxu_fn(MAIN_SET, mesh)
    sp_folded = polymul_fixed_folded_fourstep_mxu_fn(MAIN_SET, mesh)
    sp_classes = polymul_fourstep_mxu_classes_fn(MAIN_SET, mesh)
    done()

    for k, _ in KERNELS.values():
        k.launches = 0
    out = {}
    for algo in ("mxu", "fused"):
        z = polymul_negacyclic(x, y, MAIN_SET, algo=algo)
        prep, mul = (polymul_fixed_fn(MAIN_SET) if algo == "mxu"
                     else polymul_fixed_fn(MAIN_SET, algo))
        A = prep(a)
        out[algo] = (z, A, mul(x, A), intt(A, MAIN_SET, algo))
    prep, mul = polymul_fixed_fn(MAIN_SET, "mxu-folded")
    a_op = prep(a)
    z_folded = mul(x, a_op)
    z_pair = {p: polymul_negacyclic(x, y, MAIN_SET, algo=p + "_kernel")
              for p in P.PAIRINGS}
    z_sp = sp(x, y)
    a_sp = sp_fixed[0](a)
    z_spf = sp_fixed[1](x, a_sp)
    a_spx = sp_folded[0](a)
    z_spx = sp_folded[1](x, *a_spx)
    z_cls = sp_classes(x, y)
    done()
    launches = {name: k.launches for name, (k, _) in KERNELS.items()}
    print(f"launches in the main-path run: {launches}")
    if launches != EXPECTED_LAUNCHES:
        raise AssertionError(f"launch counts {launches}, expected "
                             f"{EXPECTED_LAUNCHES}")

    want_z = F.polymul_plain(x, y, tbl)
    want_A = F.ntt_plain(a, tbl)
    want_zf = F.polymul_plain(x, a.expand(B, n).contiguous(), tbl)
    for algo, (z, A, zf, a_back) in out.items():
        names = ({"z": "polymul_mxu", "A": "ntt_mxu", "zf": "polymul_fixed_mxu",
                  "a": "intt_mxu"} if algo == "mxu" else
                 {"z": "polymul_fused", "A": "ntt_fused",
                  "zf": "polymul_fixed_fused", "a": "intt_fused"})
        expect_canonical(f"z {algo}", z, (B, n), q)
        expect_canonical(f"zf {algo}", zf, (B, n), q)
        _record(errors, names["z"], f"main path z {algo}", z, want_z)
        _record(errors, names["A"], f"spectrum {algo}", A, want_A)
        _record(errors, names["zf"], f"fixed path {algo}", zf, want_zf)
        _record(errors, names["a"], f"intt(ntt(a)) {algo}", a_back, a)
    expect_equal("B5 == B1 on the main path", out["mxu"][0], out["fused"][0])
    expect_equal("B8 == B4 on the main path", out["mxu"][2], out["fused"][2])
    _record(errors, "polymul_mxu", "B5 against its twin",
            out["mxu"][0], M.polymul_mxu_plain(x, y, mt))
    expect_canonical("z mxu-folded", z_folded, (B, n), q)
    _record(errors, "polymul_fixed_folded_mxu", "folded fixed path",
            z_folded, want_zf)
    _record(errors, "polymul_fixed_folded_mxu", "B9 against its twin",
            z_folded, M.polymul_fixed_folded_mxu_plain(x, a_op, mt))
    expect_equal("B9 == B8 on the main path", z_folded, out["mxu"][2])
    for p, z in z_pair.items():
        kname = f"polymul_pairing_{p}"
        expect_canonical(f"z {p}_kernel", z, (B, n), q)
        _record(errors, kname, f"main path z {p}_kernel", z, want_z)
        _record(errors, kname, f"{kname} against its twin", z,
                P.polymul_pairing_plain(x, y, tbl, p))
        expect_equal(f"B10 {p} == B1 on the main path", z, out["fused"][0])
    plans = fourstep_mxu_plans(MAIN_SET, _n1(MAIN_SET), SP_K)
    expect_canonical("z SP", z_sp, (B, n), q)
    expect_equal("SP path == B1 on the main path", z_sp, out["fused"][0])
    expect_equal("SP path against its plain path", z_sp,
                 S.polymul_fourstep_mxu_plain(x, y, plans))
    sx = S.to_shards(x, plans)
    v = S.sp_seg1(sx, plans)
    _record(errors, "sp_seg1", "B11 at the main path's shapes", v,
            S.seg1_plain(sx, plans))
    v = S.a2a_fwd(v, plans)
    w = S.sp_seg2(v, v, plans)
    _record(errors, "sp_seg2", "B12 at the main path's shapes", w,
            S.seg2_plain(v, v, plans))
    _record(errors, "sp_seg2", "B12 against its compact twin", w,
            S.seg2_compact_plain(v, v, plans))
    w = S.a2a_inv(w, plans)
    _record(errors, "sp_seg3", "B16 at the main path's shapes",
            S.sp_seg3(w, plans), S.seg3_plain(w, plans))
    _record(errors, "sp_seg3", "B16 under p3x at the main path's shapes",
            S.sp_seg3(w, plans, folded=True),
            S.seg3_plain(w, plans, folded=True))
    # the fixed-operand SP pairs: the spectrum, both products, the segments
    sa = S.a2a_fwd(S.seg1_plain(S.to_shards(a, plans), plans), plans)
    _record(errors, "sp_seg2_fwd", "fixed SP prepare", a_sp,
            S.seg2_fwd_plain(sa, plans).reshape(n))
    got = S.sp_seg2_fwd(v, plans)
    _record(errors, "sp_seg2_fwd", "B14 at the main path's shapes", got,
            S.seg2_fwd_plain(v, plans))
    _record(errors, "sp_seg2_fwd", "B14 against its compact twin", got,
            S.seg2_fwd_compact_plain(v, plans))
    for what, z, kname, plain in (
            ("fixed", z_spf, "sp_seg2_fixed",
             S.polymul_fixed_fourstep_mxu_plain(x, a_sp, plans)),
            ("folded", z_spx, "sp_seg2_folded",
             S.polymul_fixed_folded_fourstep_mxu_plain(x, a_spx, plans))):
        expect_canonical(f"z SP {what}", z, (B, n), q)
        _record(errors, kname, f"{what} SP path", z, want_zf)
        _record(errors, kname, f"{what} SP path against its plain path", z,
                plain)
        expect_equal(f"{what} SP path == B4 on the main path", z,
                     out["fused"][2])
        expect_equal(f"{what} SP path == B8 on the main path", z,
                     out["mxu"][2])
    _record(errors, "sp_seg2_fixed", "B13 at the main path's shapes",
            S.sp_seg2_fixed(v, a_sp, plans),
            S.seg2_fixed_plain(v, a_sp, plans))
    _record(errors, "sp_seg2_folded", "B15 at the main path's shapes",
            S.sp_seg2_folded(v, a_spx, plans),
            S.seg2_folded_plain(v, a_spx, plans))
    # the class-boundary path, then its two kernels at its shapes
    cp = class_boundary_plan(MAIN_SET, plans.n1, SP_K)
    expect_canonical("z class SP", z_cls, (B, n), q)
    expect_equal("class path == B1 on the main path", z_cls, out["fused"][0])
    expect_equal("class path == SP path on the main path", z_cls, z_sp)
    expect_equal("class path against its plain path", z_cls,
                 C.polymul_fourstep_mxu_classes_plain(x, y, plans, cp))
    sy = S.to_shards(y, plans)
    ux, uy = (C.sp_seg1_classes(t, plans, cp) for t in (sx, sy))
    _record(errors, "sp_seg1_classes", "B17 at the main path's shapes", ux,
            C.seg1_classes_plain(sx, plans, cp))
    ux, uy = (C.a2a_fwd_classes(t, plans, cp.Dout) for t in (ux, uy))
    _record(errors, "sp_seg2_classes", "B18 at the main path's shapes",
            C.sp_seg2_classes(ux, uy, plans, cp),
            C.seg2_classes_plain(ux, uy, plans, cp))
    done()
    print(f"main path: z and the fixed-operand products ({B} x {n}) of every "
          f"algo (mxu, fused, mxu-folded, the five pairing kernels, the SP "
          f"path, the fixed and folded SP pairs and the class path at "
          f"k={SP_K}) equal the plain versions and each other on the card")

    rows = [(name, *(np.concatenate([t[:4].cpu().numpy(),
                                     t[-4:].cpu().numpy()])
                     for t in (z, x, other)))
            for name, z, other in (
                ("mxu", out["mxu"][0], y),
                ("fused", out["fused"][0], y),
                ("stockham_kernel", z_pair["stockham"], y),
                ("mxu-folded", z_folded, a.expand(B, n)),
                (f"SP k={SP_K}", z_sp, y),
                (f"fixed SP k={SP_K}", z_spf, a.expand(B, n)),
                (f"folded SP k={SP_K}", z_spx, a.expand(B, n)),
                (f"class SP k={SP_K}", z_cls, y))]
    for name, zc, xc, yc in rows:
        for i, row in enumerate(ORACLE_ROWS):
            want = polymul_negacyclic_oracle(xc[i], yc[i], ps).astype(
                np.uint32)
            if not np.array_equal(zc[i], want):
                raise AssertionError(f"{name} row {row} differs from the "
                                     f"big-int oracle")
        print(f"main path: rows {ORACLE_ROWS} of algo={name!r} equal the "
              f"big-int oracle")
    ctx = {"gen": gen, "x": x, "y": y, "a": a, "z_b1": out["fused"][0],
           "zf_b4": out["fused"][2], "z_b5": out["mxu"][0],
           "zf_b8": out["mxu"][2]}
    return launches, ctx


class _OpCount(TorchDispatchMode):
    """Counts the aten operations dispatched inside it, and how many of
    them are views (which launch nothing on the card)."""

    def __init__(self):
        super().__init__()
        self.ops = self.views = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        self.views += bool(func.is_view)
        return func(*args, **(kwargs or {}))


def _path_stats(name: str, fn, args, ops_args, per: str,
                device_line: str) -> None:
    """Print the path's CUDA-event time (median of EAGER_CALLS calls after
    one warmup), its peak device memory over one call (and the part above
    what was allocated before it), and the aten operations it dispatches
    on ``ops_args`` (one chunk, or one call)."""
    done()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn(*args)
    done()
    peak = torch.cuda.max_memory_allocated()
    t = time_cuda(fn, *args, warmup=1, repeats=EAGER_CALLS)
    with _OpCount() as count:
        fn(*ops_args)
    done()
    print(f"3b {name}: {t.median_ms:.4f} ms (median of {t.calls}, min "
          f"{t.min_ms:.4f}), peak {peak / 2**20:.1f} MiB "
          f"({(peak - before) / 2**20:.1f} MiB above what was allocated "
          f"before), {count.ops} aten ops {per} ({count.ops - count.views} "
          f"not views) [{device_line}]", flush=True)


def remaining_paths(ctx: dict, device_line: str) -> None:
    """Phase 3b: the paths without kernels of their own (Nussbaumer, the
    ring path, the incomplete NTT, the plain-torch four-step) and the mesh
    forms around the existing kernels (Ulysses, DP, the SP dispatcher) at
    qtesla-iii-speed, B = 32768, on phase 3's operands, held against B1,
    B4, B5, B8 and the oracle; their launches in one counted run against
    REMAINING_LAUNCHES."""
    ps = get_params(MAIN_SET)
    n, q, B = ps.n, ps.q, MAIN_BATCH
    gen, x, y, a = ctx["gen"], ctx["x"], ctx["y"], ctx["a"]
    z_b1 = ctx["z_b1"]
    c = NU.ring_exact_coeff_bound(n)
    try:
        NU.polymul_nussbaumer_fn(MAIN_SET)
    except ValueError as e:
        print(f"ring path without max_coeff raises: {e}")
    else:
        raise AssertionError("the ring path accepted full-range operands")
    xr, yr = (torch.randint(0, c + 1, (B, n), generator=gen, device="cuda",
                            dtype=torch.int64).to(torch.uint32)
              for _ in range(2))
    inc_ops = {}
    for ni, qi in INCOMPLETE_SHAPES:
        inc_ops[ni, qi] = tuple(
            torch.randint(0, qi, (B, ni), generator=gen, device="cuda",
                          dtype=torch.int64).to(torch.uint32)
            for _ in range(2))
    print(f"operands: phase 3's x, y, a; ring operands in [0, {c}] and the "
          f"incomplete NTT's {list(INCOMPLETE_SHAPES)} from the same "
          f"generator")
    z_ring_b1 = polymul_negacyclic(xr, yr, MAIN_SET, algo="fused")
    mesh = make_mesh(model=SP_K)
    ring = NU.polymul_nussbaumer_fn(MAIN_SET, max_coeff=c)
    schoolbook = NU.polymul_nussbaumer_q_fn(MAIN_SET, "schoolbook")
    uly = polymul_ulysses_fn(MAIN_SET, mesh)
    uly_prep, uly_mul = polymul_fixed_ulysses_fn(MAIN_SET, mesh)
    dp = {algo: polymul_dp_fn(MAIN_SET, mesh, algo) for algo in
          ("fused", "mxu")}
    dp_prep, dp_mul = polymul_fixed_dp_fn(MAIN_SET, mesh)
    jnp4 = polymul_fourstep_sharded_fn(MAIN_SET, mesh, local="jnp")
    fwd4 = ntt_fourstep_sharded_fn(MAIN_SET, mesh)
    inv4 = intt_fourstep_sharded_fn(MAIN_SET, mesh)
    if (sp_strategy(mesh, B), sp_strategy(mesh, 2)) != ("ulysses",
                                                         "fourstep"):
        raise AssertionError("polymul_sp_fn would not pick Ulysses at B "
                             "and the four-step at 2 rows")
    sp_big = polymul_sp_fn(MAIN_SET, mesh, batch_hint=B)
    sp_small = polymul_sp_fn(MAIN_SET, mesh, batch_hint=2)
    done()

    for k, _ in KERNELS.values():
        k.launches = 0
    z = {"nussbaumer": polymul_negacyclic(x, y, MAIN_SET, algo="nussbaumer"),
         "schoolbook": schoolbook(x[:64], y[:64]),
         "ring": ring(xr, yr)}
    inc = {}
    for (ni, qi), (xi, yi) in inc_ops.items():
        p = INC.incomplete_params(ni, qi)
        X = INC.ntt_incomplete(xi, p)
        inc[ni, qi] = (polymul_incomplete_fn(ni, qi)(xi, yi),
                       INC.intt_incomplete(X, p))
    z["ulysses"] = uly(x, y)
    z["fixed ulysses"] = uly_mul(x, uly_prep(a[0]))
    z["dp fused"] = dp["fused"](x, y)
    z["dp mxu"] = dp["mxu"](x, y)
    z["fixed dp"] = dp_mul(x, dp_prep(a))
    z["four-step jnp"] = jnp4(x, y)
    back4 = inv4(fwd4(x))
    z["sp B"] = sp_big(x, y)
    z["sp 2 rows"] = sp_small(x[:2], y[:2])
    done()
    launches = {name: k.launches for name, (k, _) in KERNELS.items()}
    print(f"launches in phase 3b's run: "
          f"{ {k: v for k, v in launches.items() if v} }")
    if launches != REMAINING_LAUNCHES:
        raise AssertionError(f"phase 3b launch counts {launches}, expected "
                             f"{REMAINING_LAUNCHES}")

    for what, got, want in (
            ("nussbaumer == B1", z["nussbaumer"], z_b1),
            ("schoolbook base == B1", z["schoolbook"], z_b1[:64]),
            ("ring path == B1", z["ring"], z_ring_b1),
            ("Ulysses == B1", z["ulysses"], z_b1),
            ("fixed Ulysses == B4", z["fixed ulysses"], ctx["zf_b4"]),
            ("DP fused == B1", z["dp fused"], z_b1),
            ("DP mxu == B5", z["dp mxu"], ctx["z_b5"]),
            ("fixed DP == B8", z["fixed dp"], ctx["zf_b8"]),
            ("plain-torch four-step == B1", z["four-step jnp"], z_b1),
            ("four-step intt(ntt(x)) == x", back4, x),
            ("polymul_sp_fn at B (Ulysses) == B1", z["sp B"], z_b1),
            ("polymul_sp_fn at 2 rows (B11, B12, B16) == B1",
             z["sp 2 rows"], z_b1[:2])):
        expect_canonical(what, got, tuple(want.shape), q)
        expect_equal(what, got, want)
    rows = torch.tensor(ORACLE_ROWS, device="cuda")
    for name, zz, xx, yy in (("nussbaumer", z["nussbaumer"], x, y),
                             ("ring", z["ring"], xr, yr)):
        zc, xc, yc = (t.index_select(0, rows).cpu().numpy()
                      for t in (zz, xx, yy))
        for i, row in enumerate(ORACLE_ROWS):
            if not np.array_equal(zc[i], polymul_negacyclic_oracle(
                    xc[i], yc[i], ps).astype(np.uint32)):
                raise AssertionError(f"{name} row {row} differs from the "
                                     f"big-int oracle")
    for (ni, qi), (zi, back) in inc.items():
        xi, yi = inc_ops[ni, qi]
        expect_canonical(f"incomplete ({ni}, {qi})", zi, (B, ni), qi)
        expect_equal(f"incomplete ({ni}, {qi}) intt(ntt(x)) == x", back, xi)
        zc, xc, yc = (t.index_select(0, rows).cpu().numpy()
                      for t in (zi, xi, yi))
        for i, row in enumerate(ORACLE_ROWS):
            want = negacyclic_schoolbook(xc[i], yc[i], types.SimpleNamespace(
                n=ni, q=qi)).astype(np.uint32)
            if not np.array_equal(zc[i], want):
                raise AssertionError(f"incomplete ({ni}, {qi}) row {row} "
                                     f"differs from the big-int oracle")
    print(f"3b: every path equals B1, B4, B5 or B8 bit for bit at B={B}; "
          f"nussbaumer, the ring path and the incomplete NTT at "
          f"{list(INCOMPLETE_SHAPES)} equal the big-int oracle on rows "
          f"{ORACLE_ROWS}")

    chunk = NU.default_chunk(n)
    one = (x[:chunk], y[:chunk])
    mod_q = NU.polymul_nussbaumer_q_fn(MAIN_SET)
    for name, fn, args, ops_args, per in (
            ("nussbaumer (mod q, Karatsuba)", mod_q, (x, y), one,
             f"a chunk of {chunk} rows"),
            ("nussbaumer (mod q, schoolbook), 64 rows", schoolbook,
             (x[:64], y[:64]), (x[:64], y[:64]), "a chunk of 64 rows"),
            ("nussbaumer ring path", ring, (xr, yr),
             (xr[:chunk], yr[:chunk]), f"a chunk of {chunk} rows"),
            *((f"incomplete NTT polymul ({ni}, {qi})",
               polymul_incomplete_fn(ni, qi), inc_ops[ni, qi],
               inc_ops[ni, qi], "a call") for ni, qi in INCOMPLETE_SHAPES),
            (f"Ulysses k={SP_K} (B1)", uly, (x, y), (x, y), "a call"),
            (f"fixed Ulysses k={SP_K} multiply (B4)", uly_mul,
             (x, uly_prep(a[0])), (x, uly_prep(a[0])), "a call"),
            ("DP fused (B1)", dp["fused"], (x, y), (x, y), "a call"),
            ("DP mxu (B5)", dp["mxu"], (x, y), (x, y), "a call"),
            ("fixed DP multiply (B8)", dp_mul, (x, dp_prep(a)),
             (x, dp_prep(a)), "a call"),
            (f"plain-torch four-step k={SP_K}", jnp4, (x, y), (x, y),
             "a call"),
            (f"polymul_sp_fn k={SP_K} at 2 rows (B11, B12, B16)", sp_small,
             (x[:2], y[:2]), (x[:2], y[:2]), "a call")):
        _path_stats(name, fn, args, ops_args, per, device_line)
    torch.cuda.empty_cache()


def ranks_on_the_card(ctx: dict, device_line: str) -> None:
    """Phase 3c: RANKS processes (``python -m
    qtesla_tpu_torch.parallel.dist_check``, fresh interpreters that load
    the library phase 1 built) joined by torch.distributed, each running
    RANK_PATHS on its shard of phase 3's operands at qtesla-iii-speed, B =
    32768; each path's assembled output against phase 3's (B1, or B4 and B8
    for the fixed forms) and the big-int oracle on ORACLE_ROWS, each rank's
    launches against PROCESS_LAUNCHES.  One card: gloo (NCCL refuses two
    ranks on one device), whose exchange goes through host memory; two or
    more: NCCL, one rank a card.  A rank that fails, hangs past
    RANK_TIMEOUT_S or exits non-zero fails the phase."""
    start = time.perf_counter()
    ps = get_params(MAIN_SET)
    cards = torch.cuda.device_count()
    backend = "gloo" if cards == 1 else "nccl"
    if backend == "gloo":
        print(f"3c: {RANKS} ranks on the one card, backend gloo: every "
              f"exchange goes through host memory, so its times are no NCCL "
              f"or NVLink figure; the kernels run on the card")
    else:
        print(f"3c: {RANKS} ranks, backend nccl, one rank a card "
              f"({cards} cards)")
    x, y, a = (ctx[k].cpu().numpy() for k in ("x", "y", "a"))
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp = Path(tmp)
        np.savez(tmp / "in.npz", name=MAIN_SET, x=x, y=y, a=a[0])
        outs = DC.launch(RANKS, tmp / "in.npz", tmp,
                         f"file://{tmp}/rendezvous",
                         ["--device", "cuda", "--backend", backend,
                          "--model", RANKS, "--repeats", RANK_REPEATS,
                          "--paths", *RANK_PATHS], timeout=RANK_TIMEOUT_S)
    for r, o in enumerate(outs):
        launches = {name: int(o[f"launches:{name}"]) for name in KERNELS}
        if launches != PROCESS_LAUNCHES:
            raise AssertionError(f"rank {r} launch counts {launches}, "
                                 f"expected {PROCESS_LAUNCHES}")
    print(f"3c: launches of each rank's counted run equal PROCESS_LAUNCHES: "
          f"{ {k: v for k, v in PROCESS_LAUNCHES.items() if v} }")
    want = {"z": ctx["z_b1"].cpu().numpy(), "b4": ctx["zf_b4"].cpu().numpy(),
            "b8": ctx["zf_b8"].cpu().numpy()}
    rows = list(ORACLE_ROWS)
    oracle = {"z": np.stack([polymul_negacyclic_oracle(x[r], y[r], ps)
                             for r in rows]).astype(np.uint32),
              "a": np.stack([polymul_negacyclic_oracle(x[r], a[0], ps)
                             for r in rows]).astype(np.uint32)}
    # the SP path's forward exchange alone: rank d holds rows k1 of chunk d
    B, n = x.shape
    n1 = _n1(MAIN_SET)
    n1k = n1 // RANKS
    for d, o in enumerate(outs):
        want_d = x.reshape(B, n1, n // n1)[:, d * n1k:(d + 1) * n1k]
        if not np.array_equal(o["z:exchange"], want_d.reshape(B, -1)):
            raise AssertionError(f"3c exchange: rank {d} holds other values "
                                 f"than rows k1 of its chunk")
    print(f"3c exchange (one all_to_all_single of a (B, n/{RANKS}) uint32 "
          f"shard, {B * n // RANKS * 4 / 2**20:.0f} MiB a rank, "
          f"{(RANKS - 1) / RANKS:.2f} of it sent): "
          f"{max(float(o['ms:exchange']) for o in outs):.4f} ms on the "
          f"slowest rank (median of {RANK_REPEATS}, backend {backend}) "
          f"[{device_line}]")
    for path in RANK_PATHS[:-1]:
        layout = DC.layout_of(path, 1, RANKS)
        data = RANKS if layout == "dp" else 1
        got = DC.assemble([o[f"z:{path}"] for o in outs], layout, data,
                          RANKS // data)
        fixed = path.startswith(("fixed", "folded"))
        ref = ("b8" if path == "fixed_dp:mxu" else "b4") if fixed else "z"
        if not np.array_equal(got, want[ref]):
            raise AssertionError(f"3c {path}: the ranks' output differs from "
                                 f"phase 3's")
        if not np.array_equal(got[rows], oracle["a" if fixed else "z"]):
            raise AssertionError(f"3c {path}: rows {rows} differ from the "
                                 f"big-int oracle")
        print(f"3c {path} ({layout} layout, equal to phase 3's "
              f"{ {'z': 'B1', 'b4': 'B4', 'b8': 'B8'}[ref] } and the oracle): "
              f"{max(float(o[f'ms:{path}']) for o in outs):.4f} ms on the "
              f"slowest rank (median of {RANK_REPEATS} after one warmup, "
              f"CUDA events, backend {backend}), peak "
              f"{[round(int(o[f'peak:{path}']) / 2**20, 1) for o in outs]} "
              f"MiB by rank [{device_line}]", flush=True)
    print(f"3c: {RANKS} ranks, every path equal to phase 3's output and the "
          f"oracle; phase wall time {time.perf_counter() - start:.1f} s "
          f"[{device_line}]")


def q30_full_size(device_line: str) -> dict:
    """Phase 3d: every path at q30-n1024 (q = 2^30 - 2^18 + 1), B = 32768
    seeded canonical operands with row Q1_ROW all q - 1 in both and one
    random constant: every algo of ALGORITHMS, the fixed forms "fused" (B2,
    B4), "mxu" (B6, B8) and "mxu-folded" (B6, B9) and their inverses (B3,
    B7), the SP path and both fixed SP pairs at k = SP_K, and the
    incomplete NTT at (1024, q); their launches in one counted run against
    Q30_LAUNCHES.  Every product equals B1's (the fixed ones B4's) bit for
    bit and the C++ oracle on ORACLE_ROWS and Q1_ROW; B6's spectrum equals
    B2's, the inverses give the constant back.  Then each kernel's time
    (median of 40 calls, CUDA events, no plain twin) beside its bound,
    returned for phase 4 to print beside the q-III times."""
    name, n, q = Q30_SET
    B = MAIN_BATCH
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)

    def draw(rows):
        return torch.randint(0, q, (rows, n), generator=gen, device="cuda",
                             dtype=torch.int64)

    x, y = draw(B), draw(B)
    x[Q1_ROW], y[Q1_ROW] = q - 1, q - 1
    x, y = x.to(torch.uint32), y.to(torch.uint32)
    a = draw(1).to(torch.uint32)
    print(f"3d operands: {name} (n={n}, q={q}), torch.Generator(device="
          f"'cuda') seed {SEED}, B={B}, row {Q1_ROW} all q - 1 in x and y, "
          f"one random constant")
    mesh = make_mesh(model=SP_K)
    sp = polymul_fourstep_mxu_fn(name, mesh)
    sp_fixed = polymul_fixed_fourstep_mxu_fn(name, mesh)
    sp_folded = polymul_fixed_folded_fourstep_mxu_fn(name, mesh)
    fixed_fns = {algo: polymul_fixed_fn(name, algo)
                 for algo in ("fused", "mxu", "mxu-folded")}
    incomplete = polymul_incomplete_fn(n, q)
    inc_p = INC.incomplete_params(n, q)
    done()

    for k, _ in KERNELS.values():
        k.launches = 0
    z, zf, spectra, path_s = {}, {}, {}, {}
    for algo in ALGORITHMS:
        path_s[algo], z[algo] = _seconds(polymul_negacyclic, x, y, name,
                                         algo)
    for algo, (prep, mul) in fixed_fns.items():
        spectra[algo] = prep(a)
        zf[algo] = mul(x, spectra[algo])
    backs = {algo: intt(spectra[algo], name, algo)
             for algo in ("fused", "mxu")}
    path_s[f"SP k={SP_K}"], z[f"SP k={SP_K}"] = _seconds(sp, x, y)
    zf[f"fixed SP k={SP_K}"] = sp_fixed[1](x, sp_fixed[0](a))
    zf[f"folded SP k={SP_K}"] = sp_folded[1](x, *sp_folded[0](a))
    path_s["incomplete"], z["incomplete"] = _seconds(incomplete, x, y)
    back_inc = INC.intt_incomplete(INC.ntt_incomplete(x, inc_p), inc_p)
    done()
    launches = {k: kern.launches for k, (kern, _) in KERNELS.items()}
    print(f"3d launches: { {k: v for k, v in launches.items() if v} }")
    if launches != Q30_LAUNCHES:
        raise AssertionError(f"phase 3d launch counts {launches}, expected "
                             f"{Q30_LAUNCHES}")
    print("3d seconds a path (host clock, synchronised): " + ", ".join(
        f"{k} {v:.3f}" for k, v in path_s.items()), flush=True)

    for what, got in z.items():
        expect_canonical(f"3d {what}", got, (B, n), q)
        expect_equal(f"3d {what} == B1", got, z["fused"])
    for what, got in zf.items():
        expect_canonical(f"3d fixed {what}", got, (B, n), q)
        expect_equal(f"3d fixed {what} == B4", got, zf["fused"])
    expect_equal("3d B6 spectrum == B2 spectrum", spectra["mxu"],
                 spectra["fused"])
    for algo, back in backs.items():
        expect_equal(f"3d intt(ntt(a)) {algo}", back, a)
    expect_equal("3d incomplete intt(ntt(x)) == x", back_inc, x)
    rows = list(ORACLE_ROWS) + [Q1_ROW]
    idx = torch.tensor(rows, device="cuda")
    xr, yr = (t.index_select(0, idx).cpu().numpy() for t in (x, y))
    want = native_schoolbook(xr, yr, q)
    want_f = native_schoolbook(xr, np.broadcast_to(a.cpu().numpy(), xr.shape),
                               q)
    for table, oracle in ((z, want), (zf, want_f)):
        for what, got in table.items():
            if not np.array_equal(got.index_select(0, idx).cpu().numpy(),
                                  oracle):
                raise AssertionError(f"3d {what}: rows {rows} differ from "
                                     f"the C++ oracle")
    print(f"3d: every algo of ALGORITHMS ({len(ALGORITHMS)}), the SP path "
          f"at k={SP_K} and the incomplete NTT equal B1 bit for bit at "
          f"B={B}, the fixed forms (fused, mxu, mxu-folded, fixed and folded "
          f"SP) B4, B6's spectrum B2's, intt(ntt(a)) == a (B3, B7); all "
          f"equal the C++ oracle on rows {rows}", flush=True)
    del z, zf, backs, back_inc

    runs, rc = kernel_runs(name, x, y, classes=False)
    work = kernel_work(name, B, rc.fold, classes=False)
    times = {}
    for kname, (kern, _, args) in runs.items():
        samples = []
        for _ in range(2):
            samples += time_cuda(kern, *args, warmup=3,
                                 repeats=20).samples_ms
        lo, med = min(samples), float(np.median(samples))
        times[kname] = (lo, med, bound(*work[kname]))
        bms, by = times[kname][2]
        print(f"3d timing {kname}: {name} B={B} min {lo:.4f} ms median "
              f"{med:.4f} ms over {len(samples)} calls; bound {bms:.4f} ms "
              f"({by}) [{device_line}]", flush=True)
    del runs, rc
    torch.cuda.empty_cache()
    return times


def _pass_work(name: str, n: int, B: int) -> tuple[int, int]:
    """The bytes a pass kernel must move at B rows of n (each operand read
    once, z written once, its twiddle table read once); no tensor-core
    work."""
    row = 4 * B * n
    if name.startswith("polymul_pairing_"):
        return 3 * row + 32 * n, 0
    return {"polymul_fused": 3 * row, "polymul_fixed_fused": 2 * row + 4 * n,
            "ntt_fused": 2 * row, "intt_fused": 2 * row}[name] + 16 * n, 0


def _definition(x: torch.Tensor, y: torch.Tensor, q: int, ks) -> list:
    """Coefficients ks of x * y mod (X^n + 1) mod q from the definition:
    z_k = sum_{i <= k} x_i y_{k-i} - sum_{i > k} x_i y_{n+k-i}, each
    product reduced mod q, in int64 torch (no kernel) on x's device."""
    n = x.shape[0]
    x, y = x.to(torch.int64), y.to(torch.int64)
    i = torch.arange(n, device=x.device)
    out = []
    for k in ks:
        yy = y[(k - i) % n]
        out.append(int((x * torch.where(i <= k, yy, q - yy) % q).sum() % q))
    return out


def _large_oracle(name, z, zf, x, y, a, q, B, n,
                  cxx_max_n: int | None = None) -> str:
    """Phase 3e's oracle: at the cluster rings (to ``cxx_max_n`` where
    given) 4 C++ oracle rows (LARGE_ORACLE_ROWS) of every product and the
    fixed one; past them DEFINITION_COEFFS coefficients of rows 0 and -1
    from the definition, and row 1 (all q - 1 in x and y) the closed form
    z_k = 2k + 2 - n mod q.  What was checked, for the printed line."""
    start = time.perf_counter()
    if n <= (cxx_max_n or Ps.cluster_reach("B1")):
        rows = [r % B for r in LARGE_ORACLE_ROWS]
        idx = torch.tensor(rows, device="cuda")
        xr, yr = (t.index_select(0, idx).cpu().numpy() for t in (x, y))
        ar = np.broadcast_to(a.cpu().numpy(), xr.shape)
        # one row a thread: the C++ oracle runs outside the GIL
        with ThreadPoolExecutor(2 * len(rows)) as pool:
            out = list(pool.map(lambda uv: native_schoolbook(*uv, q),
                                [(u[None], v[None]) for u, v in
                                 [*zip(xr, yr), *zip(xr, ar)]]))
        want = np.concatenate(out[:len(rows)])
        want_f = np.concatenate(out[len(rows):])
        for what, zz, oracle in [*((w, v, want) for w, v in z.items()),
                                 ("fixed fused", zf, want_f)]:
            if not np.array_equal(zz.index_select(0, idx).cpu().numpy(),
                                  oracle):
                raise AssertionError(f"3e {name} {what}: rows {rows} differ "
                                     f"from the C++ oracle")
        return (f"the C++ oracle on rows {rows} "
                f"({time.perf_counter() - start:.1f} s on the host)")
    ks = np.random.default_rng(n).choice(n, DEFINITION_COEFFS,
                                         replace=False)
    ks[:2] = 0, n - 1
    k = torch.arange(n, device="cuda")
    closed = (2 * k + 2 - n) % q
    for r in (0, B - 1):
        want = _definition(x[r], y[r], q, ks)
        want_f = _definition(x[r], a[0], q, ks)
        for what, zz, oracle in [*((w, v, want) for w, v in z.items()),
                                 ("fixed fused", zf, want_f)]:
            if zz[r].cpu().numpy()[ks].astype(np.int64).tolist() != oracle:
                raise AssertionError(f"3e {name} {what}: row {r} "
                                     f"coefficients {ks.tolist()} differ "
                                     f"from the definition")
    for what, zz in z.items():
        expect_equal(f"3e {name} {what} row 1 closed form",
                     zz[1].to(torch.int64), closed)
    return (f"the definition at {DEFINITION_COEFFS} coefficients of rows 0 "
            f"and {B - 1} and the closed form of row 1 "
            f"({time.perf_counter() - start:.1f} s)")


def large_rings(device_line: str) -> dict:
    """Phase 3e: q30 at n = 32768 (B = 1024) and 65536 (B = 512), where a
    row of B1, B4 and the pairings spans a cluster of 2 and 4 blocks and
    one of B2 and B3 a block and 2, and the sweep form's rings (SWEEP_RINGS:
    n = 2^18, B = 128; 2^20, B = 32; 2^25, B = 4): seeded canonical
    operands with row 1 all q - 1 in both and one random constant, through
    the entry points (polymul_negacyclic "fused" and the five
    "<pairing>_kernel" algos, polymul_fixed_fn "fused", ntt and intt
    "fused"; past a cluster's reach the DP form of "fused" too; at n =
    32768 the SP path at k = SP_K, n1 = LARGE_SP_N1), launches in one
    counted run a ring against large_launches; every product equal to
    B1's bit for bit and to the oracle (``_large_oracle``), intt(ntt(x))
    == x.  Then each pass kernel and its plain version timed in turns
    beside its bound (median of 40 calls, 10 at 2^25; the plain version's
    of 6, 2 past a cluster's reach), and at n = 32768 B11, B12 and B16.
    Where the MXU tables fit (below 2^25), the "mxu" entry points run in
    the split form (polymul_negacyclic, polymul_fixed_fn's "mxu" and
    "mxu-folded" pairs, ntt and intt), equal to B1, B4 and B2 and counted
    in the run, then each split mode timed (``split_timing``); at 2^25 the
    MXU plan must refuse, naming the bytes.  Returns the launches summed
    over the rings and the split kernels' timing at the largest ring they
    ran."""
    launches = {name: 0 for name in KERNELS}
    split_times = {}
    for name, n, q, B in LARGE_RINGS + SWEEP_RINGS:
        sweeping = n > Ps.cluster_reach("B1")
        ring_start = time.perf_counter()
        register_param_set(name, n, q)
        tbl = get_tables(name)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)

        def draw(rows):
            return torch.randint(0, q, (rows, n), generator=gen,
                                 device="cuda", dtype=torch.int64)

        x, y = draw(B), draw(B)
        x[1], y[1] = q - 1, q - 1
        x, y = x.to(torch.uint32), y.to(torch.uint32)
        a = draw(1).to(torch.uint32)
        prepare, multiply = polymul_fixed_fn(name, "fused")
        start = time.perf_counter()
        sp = (polymul_fourstep_mxu_fn(name, make_mesh(model=SP_K),
                                      n1=LARGE_SP_N1) if n == 32768 else None)
        plan_s = time.perf_counter() - start
        dp = polymul_dp_fn(name, make_mesh(model=SP_K), "fused")
        mxu = mxu_ring(n)
        if mxu:
            split_tables(name)
            fixed_mxu = polymul_fixed_fn(name)
            fixed_folded = polymul_fixed_fn(name, "mxu-folded")
        else:
            refusal = _mxu_refusal(name)
        torch.cuda.synchronize()
        for k, _ in KERNELS.values():
            k.launches = 0
        z = {"fused": polymul_negacyclic(x, y, name, "fused")}
        for p in P.PAIRINGS:
            z[f"{p}_kernel"] = polymul_negacyclic(x, y, name, f"{p}_kernel")
        zf = multiply(x, prepare(a))
        xf = ntt(x, name, "fused")
        back = intt(xf, name, "fused")
        if sweeping:
            z["DP fused"] = dp(x, y)
        if sp is not None:
            z[f"SP k={SP_K}"] = sp(x, y)
        if mxu:
            # B5-B9 in the split form through the models' entry points
            z["mxu"] = polymul_negacyclic(x, y, name, "mxu")
            zm = fixed_mxu[1](x, fixed_mxu[0](a))
            fold_s, opf = _seconds(fixed_folded[0], a)
            zmf = fixed_folded[1](x, opf)
            xm = ntt(x, name, "mxu")
            back_m = intt(xm, name, "mxu")
        torch.cuda.synchronize()
        got = {k: kern.launches for k, (kern, _) in KERNELS.items()}
        print(f"3e {name} launches: { {k: v for k, v in got.items() if v} }")
        if got != large_launches(n):
            raise AssertionError(f"phase 3e {name} launch counts {got}, "
                                 f"expected {large_launches(n)}")
        launches = {k: launches[k] + v for k, v in got.items()}
        for what, zz in z.items():
            expect_canonical(f"3e {name} {what}", zz, (B, n), q)
            expect_equal(f"3e {name} {what} == B1", zz, z["fused"])
        expect_canonical(f"3e {name} fixed fused", zf, (B, n), q)
        expect_equal(f"3e {name} intt(ntt(x)) == x", back, x)
        if mxu:
            expect_equal(f"3e {name} fixed mxu == B4", zm, zf)
            expect_equal(f"3e {name} fixed mxu-folded == B4", zmf, zf)
            expect_equal(f"3e {name} ntt mxu == ntt fused", xm, xf)
            expect_equal(f"3e {name} intt(ntt(x)) mxu == x", back_m, x)
            mxu_line = (
                f"mxu (B5-B9 split form: B2's sweeps, the split kernel, B3's "
                f"sweeps) equals B1, its fixed pairs \"mxu\" and "
                f"\"mxu-folded\" B4, ntt \"mxu\" ntt \"fused\" and "
                f"intt(ntt(x)) == x; MXU plan {PLAN_SECONDS[name]:.2f} s, "
                f"B9 prepare {fold_s:.2f} s on the host beside B6.  ")
            del zm, zmf, xm, back_m, opf
        else:
            mxu_line = f"mxu refused: {refusal}.  "
        oracle = _large_oracle(name, z, zf, x, y, a, q, B, n)
        plans = {k: Ps.kernel_plan(n, kind) for k, kind in PASS_KINDS.items()}
        print(f"3e {name} (n={n}, q={q}), B={B}, row 1 all q - 1: "
              f"{', '.join(z)} equal B1 bit for bit, the fixed pair (B2, "
              f"B4) and intt(ntt(x)) == x (B2, B3); all equal {oracle}; "
              + (f"the SP plan took {plan_s:.1f} s.  " if sp else "")
              + mxu_line
              + "; ".join(
                  f"{PASS_KINDS[k]} " + (Ps.describe_sweep_plan(pl)
                                         if isinstance(pl, Ps.SweepPlan)
                                         else describe_pass_plan(pl))
                  for k, pl in plans.items()
                  if k in ("polymul_fused", "ntt_fused")
                  or (sweeping and k == "polymul_pairing_stockham")),
              flush=True)
        del z, zf, back, xf
        runs = pass_runs(x, y, F.ntt_fused(y[:1], tbl), tbl)
        timed = 5 if n == 1 << 25 else 20
        for kname, (kern, plain, args) in runs.items():
            # the plain version on 3 calls a turn (1 past a cluster's
            # reach): 40-135 ms each at the cluster rings
            res = _turns(kern, plain, args, KERNELS[kname][0],
                         plain_repeats=1 if sweeping else 3,
                         repeats=timed)
            res["bound"] = bound(*_pass_work(kname, n, B))
            plan = plans[kname]
            (klo, kmed), (_, pmed) = res["kernel"], res["plain"]
            bms, by = res["bound"]
            if isinstance(plan, Ps.SweepPlan):
                shape = (f"{plan.sweeps} launches a call, blocks a sweep "
                         + "/".join(str(plan.tiles[i] * plan.split[i] * B)
                                    for i in range(plan.sweeps)))
            else:
                shape = (f"{plan.cluster} block(s) a row of "
                         f"{plan.threads // plan.cluster} threads, 1 launch "
                         f"a call")
            print(f"3e timing {kname}: {name} B={B} kernel min {klo:.4f} ms "
                  f"median {kmed:.4f} ms over {2 * timed} calls, plain "
                  f"median {pmed:.4f} ms over {2 if sweeping else 6}; bound "
                  f"{bms:.4f} ms ({by}), {bms / kmed * 100:.1f} % of the "
                  f"kernel's median; {shape} [{device_line}]", flush=True)
        if sp is not None:
            sp_timing(name, x, y, device_line)
        if mxu:
            split_times = split_timing(name, x, y, a, device_line)
        del x, y, a, runs
        torch.cuda.empty_cache()
        print(f"3e {name}: {time.perf_counter() - ring_start:.1f} s",
              flush=True)
    done()
    return launches, split_times


def _mxu_refusal(name: str) -> str:
    """The MXU plan's refusal at a ring whose tables are past
    MAX_TABLE_BYTES: polymul_fixed_fn's default ("mxu") pair must raise,
    naming the bytes, before any table is built."""
    start = time.perf_counter()
    try:
        polymul_fixed_fn(name)
    except ValueError as e:
        if "bytes" not in str(e):
            raise AssertionError(f"3e {name}: refusal without the bytes: "
                                 f"{e}") from e
        return f"{e} ({time.perf_counter() - start:.2f} s)"
    raise AssertionError(f"3e {name}: the MXU plan did not refuse")


def _split_work(mt, B: int, mode: str, op, call: bool) -> tuple[int, int]:
    """The bytes and int8 MACs of one split call of ``mode`` at B rows
    (``call``: the whole call, twiddles too) or of its split-kernel launch:
    each operand read once, the output written once, the mode's tables
    (the stream's stages of each direction it runs, B9's inverse the
    constant's stages) and const rows read once; the digit products of
    every lane block at the plans' depths."""
    n = mt.n
    row = 4 * B * n
    stage = M.STAGE_DEPTH * mt.bw * mt.D
    fwd = mt.nb * M.stream_stages(mt.Df, mt.bw) * stage + 4 * n
    inv = mt.nb * M.stream_stages(mt.Di, mt.bw) * stage + 4 * n
    per = B * mt.nb * mt.bw * mt.D * mt.bw          # MACs an input plane
    fold = fold_plan(mt)
    work = {
        "product": (3 * row + fwd + inv, per * (2 * mt.Df + mt.Di)),
        "fixed": (2 * row + 4 * n + fwd + inv, per * (mt.Df + mt.Di)),
        "folded": (2 * row + fwd + _nbytes(*op.tensors()),
                   per * (mt.Df + fold.Din)),
        "ntt": (2 * row + fwd, per * mt.Df),
        "intt": (2 * row + inv, per * mt.Di)}[mode]
    return work[0] + (16 * n if call else 0), work[1]


def split_timing(name: str, x: torch.Tensor, y: torch.Tensor,
                 a: torch.Tensor, device_line: str) -> dict:
    """Each split mode at one of phase 3e's rings: the whole call (B2's
    sweeps, the split kernel, B3's sweeps; median of 40) and the split
    kernel's launch alone in turns with its plain version (the twins' block
    products, ``MS.products_plain``: median of 40, plain of 2), each beside
    its bound, the tables counted once.  Returns kernel name -> the launch's
    ``_turns`` result and bound."""
    mt = get_mxu_tables(name)
    tabs, tw = M._prepare(mt, None, None, x)
    B, n = x.shape
    spec = M.ntt_mxu(a, mt)
    op = M.fold_operand(spec, mt)
    X, Y = (MS._wide_fwd(t, mt, tw) for t in (x, y))
    calls = {"product": (M.polymul_mxu, (x, y, mt), (X, Y, None)),
             "fixed": (M.polymul_fixed_mxu, (x, spec, mt),
                       (X, spec.reshape(n), None)),
             "folded": (M.polymul_fixed_folded_mxu, (x, op, mt),
                        (X, None, op)),
             "ntt": (M.ntt_mxu, (x, mt), (X, None, None)),
             "intt": (M.intt_mxu, (x, mt), (x, None, None))}
    out = {}
    for mode, (fn, args, step2) in calls.items():
        kname = SPLIT_ENTRY[mode]
        whole = time_cuda(fn, *args, warmup=3, repeats=40)
        res = _turns(functools.partial(MS.products, mode, mt, tabs, tw),
                     functools.partial(MS.products_plain, mode, mt, tabs),
                     step2, KERNELS[kname][0], plain_repeats=1)
        res["bound"] = bound(*_split_work(mt, B, mode, op, False))
        cms, cby = bound(*_split_work(mt, B, mode, op, True))
        (klo, kmed), (_, pmed) = res["kernel"], res["plain"]
        bms, by = res["bound"]
        launches = MS.split_launches(n, mode)
        print(f"3e timing split {mode} ({kname}): {name} B={B} the call "
              f"median {whole.median_ms:.4f} ms over 40 ({sum(launches.values())} "
              f"launches: {launches}), bound {cms:.4f} ms ({cby}), "
              f"{cms / whole.median_ms * 100:.1f} % of its median; the split "
              f"kernel alone min {klo:.4f} median {kmed:.4f} ms over 40, plain "
              f"median {pmed:.4f} ms over 2, bound {bms:.4f} ms ({by}), "
              f"{bms / kmed * 100:.1f} % of its median; plan "
              f"{PLAN_SECONDS.get(name, 0.0):.2f} s on the host "
              f"[{device_line}]", flush=True)
        out[kname] = res
    return out


def sp_timing(name: str, x: torch.Tensor, y: torch.Tensor,
              device_line: str) -> None:
    """B11, B12 and B16 at phase 3e's n = 32768 (k = SP_K, n1 =
    LARGE_SP_N1) on the path's own intermediates, each and its plain
    version timed in turns (median of 40; plain of 2) beside its bound."""
    plans = fourstep_mxu_plans(name, LARGE_SP_N1, SP_K)
    sx, sy = (S.to_shards(t, plans) for t in (x, y))
    vx, vy = (S.a2a_fwd(S.sp_seg1(t, plans), plans) for t in (sx, sy))
    sw = S.a2a_inv(S.sp_seg2(vx, vy, plans), plans)
    work = _sp_work(plans, x.shape[0])
    for kname, (kern, plain, args) in {
            "sp_seg1": (S.sp_seg1, S.seg1_plain, (sx, plans)),
            "sp_seg2": (S.sp_seg2, S.seg2_plain, (vx, vy, plans)),
            "sp_seg3": (S.sp_seg3, S.seg3_plain, (sw, plans))}.items():
        res = _turns(kern, plain, args, KERNELS[kname][0], plain_repeats=1)
        (klo, kmed), (_, pmed) = res["kernel"], res["plain"]
        bms, by = bound(*work[kname])
        print(f"3e timing {kname}: {name} B={x.shape[0]} k={SP_K} "
              f"n1={LARGE_SP_N1} kernel min {klo:.4f} ms median {kmed:.4f} "
              f"ms over 40 calls, plain median {pmed:.4f} ms over 2; bound "
              f"{bms:.4f} ms ({by}), {bms / kmed * 100:.1f} % of the "
              f"kernel's median [{device_line}]", flush=True)


# phase 3e's sequence-parallel rings past n = 32768, at the split the entry
# points take there (distributed.sp_n1: n1 = n / 128, n2 = 128): (name, n,
# q, model axes, B, forms), the forms "pair" (the SP product), "fixed" and
# "folded" (the fixed pairs) and "classes" (the class path, q < 2^24); the
# column segments take their split form where nloc = n / k >= 32768
SP_RINGS = (
    ("sp-n65536", 65536, 786433, (2, 4, 8), 512,
     ("pair", "fixed", "folded", "classes")),
    ("q30-n65536", 65536, Q30, (4,), 512, ("pair", "fixed", "folded")),
    ("sp-n131072", 131072, 786433, (4, 8), 256,
     ("pair", "fixed", "folded", "classes")),
    ("sp-n262144", 1 << 18, 7340033, (4,), 128,
     ("pair", "fixed", "folded", "classes")),
    ("sweep-n262144", 1 << 18, 1056440321, (4,), 128,
     ("pair", "fixed", "folded")),
    ("sweep-n1048576", 1 << 20, 1012924417, (4, 8), 32,
     ("pair", "fixed", "folded")))
# polymul_sp_fn at batch_hint 2 (the four-step at k = SP_K, n1 = n / 128,
# 2 rows): (name, n, q)
SP_FN_RINGS = (("sp-n32768", 32768, 786433), ("sp-n65536", 65536, 786433))
# the folded fixed pair's multiply runs where its prepare (B11, B14 and the
# host fold tables) took less (s)
FOLD_PREP_LIMIT_S = 60.0
# the rings whose products the C++ oracle checks on LARGE_ORACLE_ROWS; past
# it, DEFINITION_COEFFS coefficients of rows 0 and -1 from the definition
# and the closed form of row 1 (131072: 21 s of oracle rows on the host)
SP_ORACLE_MAX_N = 65536
# each column segment's key in its split form (its tile kernel's name)
SPLIT_OF = {"sp_seg1": "sp_seg1_split", "sp_seg3": "sp_seg3_split",
            "sp_seg3 p3x": "sp_seg3_split p3x",
            "sp_seg1_classes": "sp_seg1_classes_split"}


def _sp_calls(forms, folded_multiply: bool = True) -> dict:
    """Segment calls of one counted run of a ring and model axis: the
    ``forms``' entry points, then one shard's local work
    (local_pipeline_fn, local_fixed_pipeline_fn against the spectrum);
    "sp_seg3 p3x" is B16 under the folded plan."""
    each = {"pair": {"sp_seg1": 2, "sp_seg2": 1, "sp_seg3": 1},
            "fixed": {"sp_seg1": 2, "sp_seg2_fwd": 1, "sp_seg2_fixed": 1,
                      "sp_seg3": 1},
            "folded": ({"sp_seg1": 2, "sp_seg2_fwd": 1, "sp_seg2_folded": 1,
                        "sp_seg3 p3x": 1} if folded_multiply
                       else {"sp_seg1": 1, "sp_seg2_fwd": 1}),
            "classes": {"sp_seg1_classes": 2, "sp_seg2_classes": 1,
                        "sp_seg3": 1},
            "local": {"sp_seg1": 3, "sp_seg2": 1, "sp_seg2_fixed": 1,
                      "sp_seg3": 2}}
    calls = {}
    for form in (*forms, "local"):
        for seg, c in each[form].items():
            calls[seg] = calls.get(seg, 0) + c
    return calls


def sp_ring_launches(plans, calls: dict) -> dict:
    """The kernel launches of segment ``calls`` (``_sp_calls``) under
    ``plans``: a column segment in its block form its kernel once, in its
    split form its sweeps (on B2's or B3's entry) and its tile kernel once
    (``SC.split_launches``); a row segment its kernel once."""
    out = {name: 0 for name in KERNELS}
    for seg, c in calls.items():
        classes = seg == "sp_seg1_classes"
        if seg in SPLIT_OF and S.column_split(
                plans, "sp_seg1" if classes else seg, class_sums=classes):
            launches = SC.split_launches(plans, seg.split()[0])
        else:
            launches = {seg.split()[0]: 1}
        for k, v in launches.items():
            out[k] += c * v
    return out


def _compact_macs(wc: torch.Tensor, din: int, rows: int, plans,
                  kind: str, D: int) -> int:
    """int8 MACs of ``rows`` rows of every (shard, tile) through compact
    tables wc (any leading axes, then blocks of (D*s, kp)), the blocks of
    one kind (``ST.compact_layout``) held once for every shard and tile or
    shared: din * D for each (output, input) lane pair of a block nonzero
    in some digit plane, over the tensor's blocks, scaled to the k * A *
    nblk blocks of all tiles.  K1 and K3 are kron(M, I_n2k) and K2f, K2i
    and the folded F block-diagonal over n2-blocks, so most pairs of a
    dense tile are zero products that no work needs."""
    lay = ST.compact_layout(plans, kind)
    s = lay.s
    blocks = wc.reshape(-1, D, s, wc.shape[-1])[..., :din * s]
    pairs = (blocks.reshape(-1, D, s, din, s) != 0).sum(dim=(1, 3)) > 0
    slots = plans.k * plans.A * lay.nblk
    return rows * din * D * int(pairs.sum()) * slots // blocks.shape[0]


def _sp_ring_work(plans, B: int, tabs, op, aspec, cp=None,
                  ctabs=None) -> dict:
    """Bytes and int8 MACs of each SP kernel at B rows of every shard
    under ``plans``, ``kernel_work``'s counting over the nonzero blocks:
    each input read once (the tables' blocks too), the output written once;
    the split form's tile kernels as their block form less the twiddles
    (the wide stages are their sweeps')."""
    row = 4 * B * plans.n
    D = plans.D
    m = {p: _compact_macs(w, getattr(plans, p).din, B, plans, kind, D)
         for p, w, kind in (("p1", tabs.w1c, "columns"),
                            ("p2f", tabs.w2fc, "rows"),
                            ("p2i", tabs.w2ic, "rows"),
                            ("p3", tabs.w3c, "columns"),
                            ("p3x", tabs.w3xc, "columns"))}
    tw = _nbytes(tabs.tw)
    seg2 = _nbytes(tabs.w2fc, tabs.c2f, tabs.w2ic, tabs.c2i)
    tile = {p: 2 * row + _nbytes(getattr(tabs, w), getattr(tabs, c))
            for p, w, c in (("p1", "w1c", "c1"), ("p3", "w3c", "c3"),
                            ("p3x", "w3xc", "c3x"))}
    work = {"sp_seg1": (tile["p1"] + tw, m["p1"]),
            "sp_seg1_split": (tile["p1"], m["p1"]),
            "sp_seg3": (tile["p3"] + tw, m["p3"]),
            "sp_seg3_split": (tile["p3"], m["p3"]),
            "sp_seg3 p3x": (tile["p3x"] + tw, m["p3x"]),
            "sp_seg3_split p3x": (tile["p3x"], m["p3x"]),
            "sp_seg2": (3 * row + seg2, 2 * m["p2f"] + m["p2i"]),
            "sp_seg2_fixed": (2 * row + _nbytes(aspec) + seg2,
                              m["p2f"] + m["p2i"]),
            "sp_seg2_fwd": (2 * row + _nbytes(tabs.w2fc, tabs.c2f),
                            m["p2f"])}
    if op is not None:
        work["sp_seg2_folded"] = (2 * row + _nbytes(*op), _compact_macs(
            op.w, plans.p2x.din, B, plans, "rows", D))
    if cp is not None:
        classes = (1 + D) * row + _nbytes(tabs.w1c)
        work["sp_seg1_classes"] = (classes + tw, m["p1"])
        work["sp_seg1_classes_split"] = (classes, m["p1"])
        work["sp_seg2_classes"] = (
            (2 * D + 1) * row + _nbytes(ctabs.w2cc, ctabs.c2c, tabs.w2ic,
                                        tabs.c2i),
            2 * _compact_macs(ctabs.w2cc, sum(cp.dins), B, plans, "rows", D)
            + m["p2i"])
    return work


def _forget_plans() -> None:
    """Drop every cached SP plan and its device tables (the rings' tables
    take up to 2 GB each on the host and the card)."""
    for mod in (ST, S, C, SC):
        for v in vars(mod).values():
            if hasattr(v, "cache_clear"):
                v.cache_clear()
    torch.cuda.empty_cache()


def _sp_ring_timing(name: str, plans, B: int, tabs, args: dict, work: dict,
                    errors: dict, device_line: str) -> dict:
    """Each SP kernel of one (ring, k) on the path's own intermediates
    (``args``): its output against its plain version (the compact twins;
    the split form's tile kernel against ``SC.products_plain``), recorded
    in ``errors``, then timed in turns with it (median of 40; plain of 2)
    beside its bound.  A column segment in its split form is timed as its
    tile kernel's launch alone, and the whole call (its sweeps too) beside
    it.  Returns key -> the ``_turns`` result and bound."""
    k, sl = plans.k, slice(0, plans.k)
    sx, vx, vy, w, aspec, op = (args[a] for a in ("sx", "vx", "vy", "w",
                                                  "aspec", "op"))
    cp, ux, uy = args.get("cp"), args.get("ux"), args.get("uy")
    ctabs = args.get("ctabs")
    runs = {}
    split1 = S.column_split(plans, "sp_seg1")
    if split1:
        v1 = SC.column_sweeps(sx, plans, inverse=False)
        runs["sp_seg1_split"] = (
            SC.products, SC.products_plain, (v1, plans, tabs, sl),
            lambda: S.sp_seg1(sx, plans, tabs))
    else:
        runs["sp_seg1"] = (S.sp_seg1, S.seg1_compact_plain, (sx, plans,
                                                            tabs), None)
    runs["sp_seg2"] = (S.sp_seg2, S.seg2_compact_plain, (vx, vy, plans,
                                                         tabs), None)
    runs["sp_seg2_fixed"] = (S.sp_seg2_fixed, S.seg2_fixed_compact_plain,
                             (vx, aspec, plans, tabs), None)
    runs["sp_seg2_fwd"] = (S.sp_seg2_fwd, S.seg2_fwd_compact_plain,
                           (vx, plans, tabs), None)
    if op is not None:
        runs["sp_seg2_folded"] = (S.sp_seg2_folded,
                                  S.seg2_folded_compact_plain,
                                  (vx, op, plans), None)
    for folded, seg in ((False, "sp_seg3"), (True, "sp_seg3 p3x")):
        if S.column_split(plans, seg):
            runs[SPLIT_OF[seg]] = (
                SC.products, SC.products_plain, (w, plans, tabs, sl, seg),
                functools.partial(S.sp_seg3, w, plans, tabs, folded=folded))
        else:
            runs[seg] = (functools.partial(S.sp_seg3, folded=folded),
                         functools.partial(S.seg3_compact_plain,
                                           folded=folded),
                         (w, plans, tabs), None)
    if cp is not None:
        if S.column_split(plans, "sp_seg1", class_sums=True):
            v1c = SC.column_sweeps(sx, plans, inverse=False)
            runs["sp_seg1_classes_split"] = (
                C.split_class_sums, C.split_class_sums_plain,
                (v1c, plans, cp, ctabs, sl),
                lambda: C.sp_seg1_classes(sx, plans, cp, ctabs))
        else:
            runs["sp_seg1_classes"] = (C.sp_seg1_classes,
                                       C.seg1_classes_compact_plain,
                                       (sx, plans, cp, ctabs), None)
        runs["sp_seg2_classes"] = (C.sp_seg2_classes,
                                   C.seg2_classes_compact_plain,
                                   (ux, uy, plans, cp, ctabs), None)
    out = {}
    for key, (kern, plain, fargs, call) in runs.items():
        kname = key.split()[0]
        got, want = kern(*fargs), plain(*fargs)
        _record(errors, kname, f"3e {name} k={k} {key} == plain", got,
                want.to(got.dtype))
        del got, want
        res = _turns(kern, plain, fargs, KERNELS[kname][0], plain_repeats=1)
        res["bound"] = bound(*work[key])
        (klo, kmed), (_, pmed) = res["kernel"], res["plain"]
        bms, by = res["bound"]
        whole = ""
        if call is not None:
            t = time_cuda(call, warmup=3, repeats=40).median_ms
            seg = {"sp_seg1_split": "sp_seg1",
                   "sp_seg1_classes_split": "sp_seg1_classes"}.get(
                       kname, "sp_seg3")
            sweeps = SC.column_sweep_plan(plans, seg == "sp_seg3")
            cms, cby = bound(work[key][0] + _nbytes(tabs.tw) + (
                sweeps.sweeps * 2 * 4 * B * plans.n if sweeps else 0),
                work[key][1])
            whole = (f"; the whole split call (its "
                     f"{sweeps.sweeps if sweeps else 0} sweeps and the tile "
                     f"kernel) median {t:.4f} ms over 40, bound {cms:.4f} ms "
                     f"({cby})")
        print(f"3e SP timing {key}: {name} (n={plans.n}, q={plans.q}) k={k} "
              f"n1={plans.n1} nloc={plans.nloc} B={B} "
              f"{'split' if call is not None else 'block'} form: kernel min "
              f"{klo:.4f} ms median {kmed:.4f} ms over 40 calls, plain "
              f"median {pmed:.4f} ms over 2; bound {bms:.4f} ms ({by}), "
              f"{bms / kmed * 100:.1f} % of the kernel's median{whole} "
              f"[{device_line}]", flush=True)
        out[key] = res
    return out


def sp_large_rings(device_line: str, errors: dict) -> tuple[dict, dict]:
    """Phase 3e's SP rings past n = 32768 (SP_RINGS), at n1 = n / 128
    (``distributed.sp_n1``): per ring seeded canonical operands (B rows,
    row 1 all q - 1 in both) and one constant, B1's and B4's products
    against the oracle (the C++ oracle on LARGE_ORACLE_ROWS to
    SP_ORACLE_MAX_N, past it the definition's coefficients and the closed
    form of row 1); per model axis k the plan (host seconds), then one
    counted run of the entry points (polymul_fourstep_mxu_fn, both fixed
    pairs, polymul_fourstep_mxu_classes_fn where q < 2^24,
    local_pipeline_fn and local_fixed_pipeline_fn) against
    ``sp_ring_launches``: every product equal to B1 (the fixed ones to B4)
    bit for bit, one shard's local work to the compact twins' chain; the
    folded prepare's seconds printed, its multiply run below
    FOLD_PREP_LIMIT_S.  Then each SP kernel against its plain version and
    timed (``_sp_ring_timing``).  Then polymul_sp_fn at batch_hint 2
    (SP_FN_RINGS) against B1 with its launches, and at 2^25 the plan must
    refuse, naming the bytes.  Returns the launches summed and, per split
    kernel, its timing at the largest ring it ran."""
    launches = {name: 0 for name in KERNELS}
    times = {}
    for name, n, q, axes, B, forms in SP_RINGS:
        ring_start = time.perf_counter()
        register_param_set(name, n, q)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED + n)

        def draw(rows):
            return torch.randint(0, q, (rows, n), generator=gen,
                                 device="cuda", dtype=torch.int64)

        x, y = draw(B), draw(B)
        x[1], y[1] = q - 1, q - 1
        x, y = x.to(torch.uint32), y.to(torch.uint32)
        a = draw(1).to(torch.uint32)
        z_ref = polymul_negacyclic(x, y, name, "fused")
        prep4, mul4 = polymul_fixed_fn(name, "fused")
        zf_ref = mul4(x, prep4(a))
        oracle = _large_oracle(name, {"fused": z_ref}, zf_ref, x, y, a, q, B,
                               n, cxx_max_n=SP_ORACLE_MAX_N)
        n1 = sp_n1(n)
        for k in axes:
            start = time.perf_counter()
            plans = fourstep_mxu_plans(name, n1, k)
            plan_s = time.perf_counter() - start
            mesh = make_mesh(model=k)
            cp = (class_boundary_plan(name, n1, k) if "classes" in forms
                  else None)
            fns = {"pair": polymul_fourstep_mxu_fn(name, mesh, n1=n1),
                   "fixed": polymul_fixed_fourstep_mxu_fn(name, mesh, n1=n1),
                   "folded": polymul_fixed_folded_fourstep_mxu_fn(
                       name, mesh, n1=n1)}
            if cp is not None:
                fns["classes"] = polymul_fourstep_mxu_classes_fn(name, mesh,
                                                                 n1=n1)
            pipe, _ = local_pipeline_fn(name, k, n1=n1)
            fpipe, _ = local_fixed_pipeline_fn(name, k, n1=n1)
            tabs_s, tabs = _seconds(S.device_tables, plans, x.device)
            for kern, _ in KERNELS.values():
                kern.launches = 0
            z = {"SP": fns["pair"](x, y)}
            aspec = fns["fixed"][0](a)
            zf = {"fixed SP": fns["fixed"][1](x, aspec)}
            fold_s, op = _seconds(fns["folded"][0], a)
            folded = fold_s < FOLD_PREP_LIMIT_S
            if folded:
                zf["folded SP"] = fns["folded"][1](x, *op)
            if cp is not None:
                z["class path"] = fns["classes"](x, y)
            d = min(1, k - 1)
            sx, sy = (S.to_shards(t, plans) for t in (x, y))
            local = pipe(sx[d], sy[d])
            flocal = fpipe(sx[d], aspec)
            done()
            got = {kk: kern.launches for kk, (kern, _) in KERNELS.items()}
            want = sp_ring_launches(plans, _sp_calls(forms, folded))
            if got != want:
                raise AssertionError(f"3e SP {name} k={k} launch counts "
                                     f"{got}, expected {want}")
            launches = {kk: launches[kk] + v for kk, v in got.items()}
            for what, zz in z.items():
                expect_canonical(f"3e SP {name} k={k} {what}", zz, (B, n), q)
                expect_equal(f"3e SP {name} k={k} {what} == B1", zz, z_ref)
            for what, zz in zf.items():
                expect_equal(f"3e SP {name} k={k} {what} == B4", zz, zf_ref)
            v1x, v1y = (S.seg1_compact_plain(t[d:d + 1], plans, tabs, d)
                        for t in (sx, sy))
            expect_equal(f"3e SP {name} k={k} local_pipeline_fn == twins",
                         local, S.seg3_compact_plain(S.seg2_compact_plain(
                             v1x, v1y, plans, tabs, d), plans, tabs, d)[0])
            expect_equal(
                f"3e SP {name} k={k} local_fixed_pipeline_fn == twins",
                flocal, S.seg3_compact_plain(S.seg2_fixed_compact_plain(
                    v1x, aspec, plans, tabs, d), plans, tabs, d)[0])
            del z, zf, local, flocal, v1x, v1y
            # the path's own intermediates for the kernels' timing
            vx, vy = (S.a2a_fwd(S.sp_seg1(t, plans, tabs), plans)
                      for t in (sx, sy))
            args = {"sx": sx, "vx": vx, "vy": vy, "aspec": aspec,
                    "op": op if folded else None,
                    "w": S.a2a_inv(S.sp_seg2(vx, vy, plans, tabs), plans)}
            if cp is not None:
                ctabs = C.class_device_tables(plans, cp, x.device)
                args |= {"cp": cp, "ctabs": ctabs, "ux": C.a2a_fwd_classes(
                    C.sp_seg1_classes(sx, plans, cp, ctabs), plans, cp.Dout),
                    "uy": C.a2a_fwd_classes(C.sp_seg1_classes(
                        sy, plans, cp, ctabs), plans, cp.Dout)}
            work = _sp_ring_work(plans, B, tabs, args["op"], aspec, cp,
                                 args.get("ctabs"))
            res = _sp_ring_timing(name, plans, B, tabs, args, work, errors,
                                  device_line)
            times |= {kk: r for kk, r in res.items()
                      if kk in SC.KERNELS}
            column = {seg: "split" if S.column_split(plans, seg) else "block"
                      for seg in ("sp_seg1", "sp_seg3", "sp_seg3 p3x")}
            print(f"3e SP {name} (n={n}, q={q}) k={k} n1={n1} nloc="
                  f"{plans.nloc} B={B}, row 1 all q - 1: "
                  f"{', '.join(['SP'] + (['class path'] if cp else []))} "
                  f"equal B1 bit for bit, the fixed SP pair"
                  f"{' and the folded one' if folded else ''} B4, one "
                  f"shard's local work the twins'; B1 and B4 equal "
                  f"{oracle}; column segments {column}; plan {plan_s:.2f} s "
                  f"on the host (tables {tabs_s:.2f} s), folded prepare "
                  f"{fold_s:.2f} s"
                  f"{'' if folded else ' (multiply not run)'}; "
                  f"launches { {kk: v for kk, v in got.items() if v} }",
                  flush=True)
            del args, vx, vy, sx, sy, aspec, op, fns, pipe, fpipe, tabs
            _forget_plans()
        del x, y, a, z_ref, zf_ref
        _forget_plans()
        print(f"3e SP {name}: {time.perf_counter() - ring_start:.1f} s",
              flush=True)
    for name, n, q in SP_FN_RINGS:
        register_param_set(name, n, q)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED + 1)
        x, y = (torch.randint(0, q, (2, n), generator=gen, device="cuda",
                              dtype=torch.int64) for _ in range(2))
        x[1], y[1] = q - 1, q - 1
        x, y = x.to(torch.uint32), y.to(torch.uint32)
        fn = polymul_sp_fn(name, make_mesh(model=SP_K), batch_hint=2)
        want_l = sp_ring_launches(fourstep_mxu_plans(name, sp_n1(n), SP_K),
                                  {"sp_seg1": 2, "sp_seg2": 1, "sp_seg3": 1})
        z_ref = polymul_negacyclic(x, y, name, "fused")
        done()
        for kern, _ in KERNELS.values():
            kern.launches = 0
        z = fn(x, y)
        done()
        got = {kk: kern.launches for kk, (kern, _) in KERNELS.items()}
        if got != want_l:
            raise AssertionError(f"3e polymul_sp_fn {name} launch counts "
                                 f"{got}, expected {want_l}")
        launches = {kk: launches[kk] + v for kk, v in got.items()}
        expect_equal(f"3e polymul_sp_fn {name} == B1", z, z_ref)
        print(f"3e polymul_sp_fn {name} (n={n}, q={q}) batch_hint=2, k="
              f"{SP_K}: the four-step at n1 = {sp_n1(n)} equals B1 bit for "
              f"bit, row 1 all q - 1; launches "
              f"{ {kk: v for kk, v in got.items() if v} }", flush=True)
        _forget_plans()
    # past 16 GiB of tables the SP plan refuses, naming the bytes, before
    # any table is built
    name, n, q, _ = SWEEP_RINGS[-1]
    register_param_set(name, n, q)
    start = time.perf_counter()
    try:
        fourstep_mxu_plans(name, sp_n1(n), SP_K)
    except ValueError as e:
        if "bytes" not in str(e):
            raise AssertionError(f"3e SP {name}: refusal without the bytes: "
                                 f"{e}") from e
        print(f"3e SP {name} (n={n}): the plan at k={SP_K} refuses: {e} "
              f"({time.perf_counter() - start:.2f} s)", flush=True)
    else:
        raise AssertionError(f"3e SP {name}: the SP plan did not refuse")
    return launches, times


def pass_runs(x: torch.Tensor, y: torch.Tensor, spec: torch.Tensor,
              tbl) -> dict:
    """The pass kernels' (wrapper, plain version, arguments) on (B, n)
    operands x and y, B4 against the spectrum ``spec``, B3 on x."""
    return {"polymul_fused": (F.polymul_fused, F.polymul_plain, (x, y, tbl)),
            "polymul_fixed_fused": (F.polymul_fixed_fused,
                                    F.polymul_fixed_plain, (x, spec, tbl)),
            "ntt_fused": (F.ntt_fused, F.ntt_plain, (x, tbl)),
            "intt_fused": (F.intt_fused, F.intt_plain, (x, tbl)),
            **{f"polymul_pairing_{p}": (P.polymul_pairing,
                                        P.polymul_pairing_plain,
                                        (x, y, tbl, p))
               for p in P.PAIRINGS}}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _mxu_work(mt, B: int) -> dict:
    """B5-B9's bytes and MACs at B rows of the set of MXU tables ``mt``
    (``kernel_work``'s counting): the digit products of a row's lane
    blocks, not the zero blocks a packed row of 32 lanes adds at n < 32."""
    n = mt.n
    row, spec, tw = 4 * B * n, 4 * n, 16 * n
    mtabs = M.host_tables(mt)
    wf, wi = _nbytes(mtabs.wf, mtabs.constf), _nbytes(mtabs.wi, mtabs.consti)
    fp = fold_plan(mt)
    per_block = B * mt.nb * mt.bw * mt.D * mt.bw     # MACs per input plane
    fwd, inv, fold = (per_block * d for d in (mt.Df, mt.Di, fp.Din))
    # the constant's stages: W' with no padding at bw a multiple of 64
    folded = mt.nb * fp.Dout * mt.bw * fp.Din * mt.bw + 4 * n
    return {
        "polymul_mxu": (3 * row + wf + wi + tw, 2 * fwd + inv),
        "polymul_fixed_mxu": (2 * row + spec + wf + wi + tw, fwd + inv),
        "ntt_mxu": (2 * row + wf + tw, fwd),
        "intt_mxu": (2 * row + wi + tw, inv),
        "polymul_fixed_folded_mxu": (2 * row + wf + folded + tw, fwd + fold),
    }


def small_rings_timing(device_line: str) -> None:
    """B5-B9 at SMALL_RINGS (n = 8 and 16, lane packed) at MAIN_BATCH
    rows, each and its twin timed in turns (median of 40; twin of 6)
    beside its bound (registered in phase 2)."""
    rng = np.random.default_rng(SEED)
    for n, q in SMALL_RINGS:
        name = f"mxu-n{n}-q{q}"
        tbl, mt = get_tables(name), get_mxu_tables(name)
        x, y = (torch.from_numpy(v).to("cuda") for v in rng.integers(
            0, q, (2, MAIN_BATCH, n), dtype=np.uint32))
        pw = torch.from_numpy(rng.integers(0, mt.pw_bound, (MAIN_BATCH, n),
                                           dtype=np.uint32)).to("cuda")
        spec = F.ntt_fused(y[:1], tbl)
        op = M.fold_operand(spec, mt)
        work = _mxu_work(mt, MAIN_BATCH)
        for kname, (kern, plain, args) in {
                "polymul_mxu": (M.polymul_mxu, M.polymul_mxu_plain,
                                (x, y, mt)),
                "polymul_fixed_mxu": (M.polymul_fixed_mxu,
                                      M.polymul_fixed_mxu_plain,
                                      (x, spec, mt)),
                "ntt_mxu": (M.ntt_mxu, M.ntt_mxu_plain, (x, mt)),
                "intt_mxu": (M.intt_mxu, M.intt_mxu_plain, (pw, mt)),
                "polymul_fixed_folded_mxu": (
                    M.polymul_fixed_folded_mxu,
                    M.polymul_fixed_folded_mxu_plain, (x, op, mt))}.items():
            res = _turns(kern, plain, args, KERNELS[kname][0],
                         plain_repeats=3)
            (klo, kmed), (_, pmed) = res["kernel"], res["plain"]
            bms, by = bound(*work[kname])
            print(f"small ring timing {kname}: {name} B={MAIN_BATCH} "
                  f"kernel min {klo:.4f} ms median {kmed:.4f} ms over 40 "
                  f"calls, twin median {pmed:.4f} ms over 6; bound "
                  f"{bms:.4f} ms ({by}), {bms / kmed * 100:.1f} % of the "
                  f"kernel's median [{device_line}]", flush=True)
    done()


def _sp_work(plans, B: int) -> dict:
    """B11's, B12's and B16's bytes and MACs at B rows under ``plans``
    (``kernel_work``'s counting)."""
    row = 4 * B * plans.n
    st = S.host_tables(plans)
    m1, m2f, m2i, m3 = (
        _compact_macs(w, getattr(plans, p).din, B, plans, kind, plans.D)
        for w, p, kind in ((st.w1c, "p1", "columns"),
                           (st.w2fc, "p2f", "rows"),
                           (st.w2ic, "p2i", "rows"),
                           (st.w3c, "p3", "columns")))
    sp_tw = _nbytes(st.tw)
    return {"sp_seg1": (2 * row + _nbytes(st.w1c, st.c1) + sp_tw, m1),
            "sp_seg2": (3 * row + _nbytes(st.w2fc, st.c2f, st.w2ic, st.c2i),
                        2 * m2f + m2i),
            "sp_seg3": (2 * row + _nbytes(st.w3c, st.c3) + sp_tw, m3)}


def kernel_work(name: str, B: int, sp_fold: S.FoldedSpOperand,
                classes: bool = True) -> dict:
    """Per kernel, at a timing's shapes (set ``name``, B rows, the SP
    kernels at k = SP_K, ``sp_fold`` the timed constant's folded SP operand;
    B17 and B18 with ``classes``): the bytes it must move
    (each input, tables included, read once, the output written once) and
    its int8 tensor-core MACs (the digit products at their plans' depth,
    the padding and the SP tables' zero blocks excluded).  B11, B16, B17 and
    B18 read their tables' nonzero blocks alone (``w1c``, ``w3c``, ``w3xc``,
    ``w2cc``, ``w2ic``; B12 and B13 ``w2fc`` and ``w2ic``, B14 ``w2fc``; B15 the
    constant's compact F, ``sp_fold``); their MACs are counted on the
    nonzero lane pairs of those blocks (``_compact_macs``: the dense
    tables' nonzero pairs, the same count), so a bound reads the same work
    whatever implements it.  B5's, B6's, B8's and B9's
    tables are counted once, as ``wf`` and ``wi`` (B6: ``wf`` alone; B9:
    ``wf`` and the constant's W'), whatever stream they read them in."""
    tbl = get_tables(name)
    mt = get_mxu_tables(name)
    plans = fourstep_mxu_plans(name, _n1(name), SP_K)
    n = tbl.n
    row, spec = 4 * B * n, 4 * n
    work = {k: _pass_work(k, n, B) for k in PASS_KERNELS}
    work |= _mxu_work(mt, B)
    work |= _sp_work(plans, B)
    st = S.host_tables(plans)
    m2f, m2i, m3x, mx = (
        _compact_macs(w, getattr(plans, p).din, B, plans, kind, plans.D)
        for w, p, kind in ((st.w2fc, "p2f", "rows"), (st.w2ic, "p2i", "rows"),
                           (st.w3xc, "p3x", "columns"),
                           (sp_fold.w.cpu(), "p2x", "rows")))
    sp_tw = _nbytes(st.tw)
    work["sp_seg3 p3x"] = (2 * row + _nbytes(st.w3xc, st.c3x) + sp_tw, m3x)
    work["sp_seg2_fixed"] = (2 * row + spec + _nbytes(st.w2fc, st.c2f,
                                                      st.w2ic, st.c2i),
                             m2f + m2i)
    work["sp_seg2_fwd"] = (2 * row + _nbytes(st.w2fc, st.c2f), m2f)
    work["sp_seg2_folded"] = (2 * row + _nbytes(*sp_fold), mx)
    if not classes:
        return work
    # B17 writes Dout class planes a value; B18 reads them for x and y
    cp = class_boundary_plan(name, plans.n1, SP_K)
    _, c2c = C.host_class_tables(cp)
    w2cc = C.host_compact_class_table(cp, plans)
    D = cp.Dout
    work["sp_seg1_classes"] = ((1 + D) * row + _nbytes(st.w1c) + sp_tw,
                               work["sp_seg1"][1])
    work["sp_seg2_classes"] = (
        (2 * D + 1) * row + _nbytes(w2cc, c2c, st.w2ic, st.c2i),
        2 * _compact_macs(w2cc, sum(cp.dins), B, plans, "rows", D) + m2i)
    return work


def bound(nbytes: int, macs: int) -> tuple[float, str]:
    """The least time the card could take (ms) and what sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * macs / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _turns(kern, plain, args, counter=None, plain_repeats=20,
           repeats=20) -> dict:
    """Medians of plain, kernel, kernel, plain runs of ``repeats`` timed
    calls each (the plain version's of ``plain_repeats``); with
    ``counter``, its launches must be the kernel's calls times the
    launches a call makes (``counter.launches`` moved by the first)."""
    per_call = 1
    if counter:
        before = counter.launches
        kern(*args)
        per_call = counter.launches - before
        if per_call < 1:
            raise AssertionError(f"{counter.name}: a call launched nothing")
        before = counter.launches
    samples = {"kernel": [], "plain": []}
    calls = 0
    for which in ("plain", "kernel", "kernel", "plain"):
        t = time_cuda(kern if which == "kernel" else plain, *args,
                      warmup=3 if which == "kernel" else min(3, plain_repeats),
                      repeats=repeats if which == "kernel"
                      else plain_repeats)
        samples[which].extend(t.samples_ms)
        if which == "kernel":
            calls += t.calls + t.warmup
    if counter and counter.launches - before != calls * per_call:
        raise AssertionError(f"{counter.name}: {counter.launches - before} "
                             f"launches for {calls} calls of {per_call}")
    return {which: (min(v), float(np.median(v)))
            for which, v in samples.items()}


def kernel_runs(name: str, x: torch.Tensor, y: torch.Tensor,
                classes: bool = True) -> tuple[dict, types.SimpleNamespace]:
    """Each kernel's (wrapper, plain version, arguments) on set ``name``'s
    (B, n) operands x and y: B8 and B9 against y[0]'s spectrum, the SP
    kernels at k = SP_K on the path's own intermediates, B13 and B15
    against y[0]'s SP spectrum, B17 and B18 with ``classes``; and the SP
    plans, shards, spectrum, folded operand and class plan they take."""
    tbl = get_tables(name)
    mt = get_mxu_tables(name)
    spec = F.ntt_fused(y[:1], tbl)
    op = M.fold_operand(spec, mt)
    plans = fourstep_mxu_plans(name, _n1(name), SP_K)
    sx, sy = (S.to_shards(t, plans) for t in (x, y))
    vx, vy = (S.a2a_fwd(S.sp_seg1(t, plans), plans) for t in (sx, sy))
    sw = S.a2a_inv(S.sp_seg2(vx, vy, plans), plans)
    aspec = S.fixed_spectrum(y[0], plans)
    fold = _fold(plans, aspec)
    runs = {
        **pass_runs(x, y, spec, tbl),
        "polymul_mxu": (M.polymul_mxu, M.polymul_mxu_plain, (x, y, mt)),
        "polymul_fixed_mxu": (M.polymul_fixed_mxu, M.polymul_fixed_mxu_plain,
                              (x, spec, mt)),
        "ntt_mxu": (M.ntt_mxu, M.ntt_mxu_plain, (x, mt)),
        "intt_mxu": (M.intt_mxu, M.intt_mxu_plain, (x, mt)),
        "polymul_fixed_folded_mxu": (M.polymul_fixed_folded_mxu,
                                     M.polymul_fixed_folded_mxu_plain,
                                     (x, op, mt)),
        "sp_seg1": (S.sp_seg1, S.seg1_plain, (sx, plans)),
        "sp_seg2": (S.sp_seg2, S.seg2_plain, (vx, vy, plans)),
        "sp_seg3": (S.sp_seg3, S.seg3_plain, (sw, plans)),
        "sp_seg2_fixed": (S.sp_seg2_fixed, S.seg2_fixed_plain,
                          (vx, aspec, plans)),
        "sp_seg2_fwd": (S.sp_seg2_fwd, S.seg2_fwd_plain, (vx, plans)),
        "sp_seg2_folded": (S.sp_seg2_folded, S.seg2_folded_plain,
                           (vx, fold, plans)),
        "sp_seg3 p3x": (functools.partial(S.sp_seg3, folded=True),
                        functools.partial(S.seg3_plain, folded=True),
                        (sw, plans)),
    }
    ctx = types.SimpleNamespace(plans=plans, sx=sx, vx=vx, aspec=aspec,
                                fold=fold, cp=None)
    if classes:
        ctx.cp = cp = class_boundary_plan(name, plans.n1, SP_K)
        ux, uy = (C.a2a_fwd_classes(C.sp_seg1_classes(t, plans, cp), plans,
                                    cp.Dout) for t in (sx, sy))
        runs["sp_seg1_classes"] = (C.sp_seg1_classes, C.seg1_classes_plain,
                                   (sx, plans, cp))
        runs["sp_seg2_classes"] = (C.sp_seg2_classes, C.seg2_classes_plain,
                                   (ux, uy, plans, cp))
    return runs, ctx


def timing(device_line: str, q30_times: dict) -> dict:
    """Phase 4 (module docstring); each kernel's phase-3d time at q30-n1024
    (``q30_times``) printed beside its q-III time."""
    tbl = get_tables(MAIN_SET)
    mt = get_mxu_tables(MAIN_SET)
    n, q, B = tbl.n, tbl.q, MAIN_BATCH
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    x, y = (torch.randint(0, q, (B, n), generator=gen, device="cuda",
                          dtype=torch.int64).to(torch.uint32) for _ in range(2))
    runs, rc = kernel_runs(MAIN_SET, x, y)
    plans, sx, vx, aspec, fold, cp = (rc.plans, rc.sx, rc.vx, rc.aspec,
                                      rc.fold, rc.cp)
    work = kernel_work(MAIN_SET, B, fold)
    out = {}
    for name, (kern, plain, args) in runs.items():
        res = _turns(kern, plain, args, KERNELS[name.split()[0]][0])
        res["bound"] = bound(*work[name])
        for which in ("kernel", "plain"):
            lo, med = res[which]
            print(f"timing {name} {which}: B={B} n={n} min {lo:.4f} ms "
                  f"median {med:.4f} ms over 40 calls, "
                  f"{B / (med / 1e3):.0f} rows/s [{device_line}]", flush=True)
        bms, by = res["bound"]
        print(f"bound {name}: {work[name][0] / 1e6:.1f} MB, "
              f"{work[name][1]:.3g} int8 MACs: {bms:.4f} ms ({by}), "
              f"{bms / res['kernel'][1] * 100:.1f} % of the kernel's median",
              flush=True)
        if name in EARLIER_MS:
            print(f"redesigned {name}: median {res['kernel'][1]:.4f} ms, "
                  f"its earlier design {EARLIER_MS[name]:.4f} ms (ratio "
                  f"{res['kernel'][1] / EARLIER_MS[name]:.4f}), bound "
                  f"{bms:.4f} ms [{device_line}]", flush=True)
        out[name] = res
    med = {name: res["kernel"][1] for name, res in out.items()}
    for name, (_, med30, (b30, by30)) in q30_times.items():
        b3, by3 = out[name]["bound"]
        print(f"q30 beside q-III {name}: {Q30_SET[0]} median {med30:.4f} ms, "
              f"{MAIN_SET} median {med[name]:.4f} ms (ratio "
              f"{med30 / med[name]:.4f}), bounds {b30:.4f} ms ({by30}) and "
              f"{b3:.4f} ms ({by3}), B={B} [{device_line}]", flush=True)
    # the pass kernels' instruction-issue bound, from their SASS: at n =
    # 1024 every instruction of the kernels built for that length
    # (pass_kernel<fwd,inv,32,2,10,0>, polymul_pass_kernel<32,2,10,ops,0>,
    # transform_pass_kernel<fwd,32,2,10,0>: the block form) runs once a
    # warp and row
    sass = kernel_sass(str(load_library().path))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = max_sm_clock_hz()
    scheme = {"dif": 0, "dit": 1, "stk": 2}
    pass_plans = {
        f"polymul_pairing_{p}": (P.pairing_pass_plan(n, p),
                                 f"pass_kernel<{scheme[f]},{scheme[i]},", "")
        for p, (f, i) in P.PAIRINGS.items()}
    # B1 and B4: polymul_pass_kernel<R,P,logn,operands,cluster>; B2 and B3
    # transform_pass_kernel<fwd,R,P,logn,cluster>
    pass_plans["polymul_fused"] = (F.fused_pass_plan(n),
                                   "polymul_pass_kernel<", ",2")
    pass_plans["polymul_fixed_fused"] = (F.fixed_pass_plan(n),
                                         "polymul_pass_kernel<", ",1")
    pass_plans["ntt_fused"] = (F.ntt_pass_plan(n),
                               "transform_pass_kernel<1,", "")
    pass_plans["intt_fused"] = (F.intt_pass_plan(n),
                                "transform_pass_kernel<0,", "")
    for name, (plan, kernel, ops) in pass_plans.items():
        # the launchers run n = 1024 in the kernels built for that length
        # (pass_kernel_for, polymul_pass_kernel_for,
        # transform_pass_kernel_for)
        built = (plan.radix, plan.passes, n) == (32, 2, 1024)
        key = (f"{kernel}{plan.radix},{plan.passes},"
               f"{tbl.logn if built else 0}{ops},0>")
        ms, counts = issue_bound_ms(sass[key], B, plan.threads, sms, clock)
        print(f"issue bound {name}: {key}, {counts['total']} SASS "
              f"instructions ({counts['fma']} of the FMA pipe, "
              f"{counts['alu']} of the ALU pipe) a warp and row, "
              f"{plan.threads // 32 or 1} warps a row, {sms} SMs at "
              f"{clock / 1e9:.3f} GHz: {ms:.4f} ms, {ms / med[name] * 100:.1f} "
              f"% of the kernel's median {med[name]:.4f} ms; bytes bound "
              f"{out[name]['bound'][0]:.4f} ms [{device_line}]", flush=True)
    # B6, B11 and B14 at the size of their prepare launches on the main
    # path: one row, the constant (B11 and B14 its k shards); warm, as a
    # call costs with the wrapper's host time in the way, and cold (the
    # host queued ahead: the card's time)
    for name, fn, args in (
            ("ntt_mxu", M.ntt_mxu, (x[:1], mt)),
            ("sp_seg1", S.sp_seg1, (sx[:, :1].contiguous(), plans)),
            ("sp_seg2_fwd", S.sp_seg2_fwd, (vx[:, :1].contiguous(), plans))):
        one = time_cuda(fn, *args, warmup=3, repeats=20)
        card = time_cuda(fn, *args, warmup=3, repeats=20, cold=True)
        print(f"timing {name} B=1 (the main path's prepare): min "
              f"{one.min_ms:.4f} ms median {one.median_ms:.4f} ms over 20 "
              f"calls, cold median {card.median_ms:.4f} ms; B={B} median "
              f"{med[name]:.4f} ms [{device_line}]", flush=True)
    cold_s, prep_s = fold_prep_seconds(MAIN_SET, y[0])
    print(f"timing B9 prepare (\"mxu-folded\", B6 + host tables and stages "
          f"+ copies), host clock, synchronised: {prep_s * 1e3:.1f} ms, "
          f"first call {cold_s * 1e3:.1f} ms [{device_line}]", flush=True)
    print(f"same inputs: B9 {med['polymul_fixed_folded_mxu']:.4f} ms, "
          f"B8 {med['polymul_fixed_mxu']:.4f}, "
          f"B4 {med['polymul_fixed_fused']:.4f}; "
          f"B10 gs_ct {med['polymul_pairing_gs_ct']:.4f} ms, stockham "
          f"{med['polymul_pairing_stockham']:.4f}, B1 "
          f"{med['polymul_fused']:.4f} [{device_line}]")

    # One shard's local work is timed warm, as the kernels are, and cold:
    # L2 flushed and the host queued ahead before each call
    # (time_cuda(cold=True)); the SP cost per shard divides cold times by
    # cold times of B5, B1, B8 and B4.
    def cold(fn, *args) -> float:
        return time_cuda(fn, *args, warmup=3, repeats=20,
                         cold=True).median_ms

    single = {name: cold(runs[name][0], *runs[name][2])
              for name in ("polymul_mxu", "polymul_fused",
                           "polymul_fixed_mxu", "polymul_fixed_fused")}
    print("timing cold (L2 flushed, host queued ahead): " + ", ".join(
        f"{name} {t:.4f} ms" for name, t in single.items()) +
        f" [{device_line}]", flush=True)

    # the SP path end to end, and one shard's local work at each k
    sp = polymul_fourstep_mxu_fn(MAIN_SET, make_mesh(model=SP_K))
    res = _turns(sp, lambda a, b: S.polymul_fourstep_mxu_plain(a, b, plans),
                 (x, y))
    sp_med = res["kernel"][1]
    print(f"timing SP path k={SP_K} (2 x B11, B12, B16, 3 exchanges and the "
          f"shard layout): median {res['kernel'][1]:.4f} ms, plain "
          f"{res['plain'][1]:.4f} ms; B5 {med['polymul_mxu']:.4f}, B1 "
          f"{med['polymul_fused']:.4f} [{device_line}]", flush=True)
    for k in (2, 4, 8):
        pipe, lp = local_pipeline_fn(MAIN_SET, k)
        xl, yl = (t[:, :lp.nloc].contiguous() for t in (x, y))
        tl = time_cuda(pipe, xl, yl, warmup=3, repeats=20).median_ms
        tc = cold(pipe, xl, yl)
        print(f"timing local_pipeline_fn k={k}: B={B} nloc={lp.nloc} median "
              f"{tl:.4f} ms warm, {tc:.4f} ms cold; SP cost per shard "
              f"(cold) k*t_local/t_B5 = "
              f"{k * tc / single['polymul_mxu']:.3f}, k*t_local/t_B1 = "
              f"{k * tc / single['polymul_fused']:.3f} [{device_line}]",
              flush=True)

    # the fixed SP paths end to end, and one shard's fixed and folded work
    fixed = polymul_fixed_fourstep_mxu_fn(MAIN_SET, make_mesh(model=SP_K))[1]
    folded = polymul_fixed_folded_fourstep_mxu_fn(MAIN_SET,
                                                  make_mesh(model=SP_K))[1]
    for what, kern, plain, args in (
            ("fixed SP path (B11, B13, B16, 2 exchanges)", fixed,
             functools.partial(S.polymul_fixed_fourstep_mxu_plain,
                               plans=plans), (x, aspec)),
            ("folded SP path (B11, B15, B16 p3x, 2 exchanges)",
             lambda t: folded(t, *fold),
             functools.partial(S.polymul_fixed_folded_fourstep_mxu_plain,
                               fold=fold, plans=plans), (x,))):
        res = _turns(kern, plain, args)
        print(f"timing {what} k={SP_K}: median {res['kernel'][1]:.4f} ms, "
              f"plain {res['plain'][1]:.4f} ms; B8 "
              f"{med['polymul_fixed_mxu']:.4f}, B9 "
              f"{med['polymul_fixed_folded_mxu']:.4f}, B4 "
              f"{med['polymul_fixed_fused']:.4f} [{device_line}]", flush=True)
    rng = np.random.default_rng(SEED)
    for k in (2, 4, 8):
        pipe, lp = local_fixed_pipeline_fn(MAIN_SET, k)
        xl = x[:, :lp.nloc].contiguous()
        spec = _u32(rng.integers(0, q, (k, lp.nloc), dtype=np.uint32))
        for what, const in (("fixed", spec), ("folded", _fold(lp, spec))):
            tl = time_cuda(pipe, xl, const, warmup=3, repeats=20).median_ms
            tc = cold(pipe, xl, const)
            print(f"timing local_fixed_pipeline_fn {what} k={k}: B={B} "
                  f"nloc={lp.nloc} median {tl:.4f} ms warm, {tc:.4f} ms "
                  f"cold; SP cost per shard (cold) k*t_local/t_B8 = "
                  f"{k * tc / single['polymul_fixed_mxu']:.3f}, "
                  f"k*t_local/t_B4 = "
                  f"{k * tc / single['polymul_fixed_fused']:.3f} "
                  f"[{device_line}]", flush=True)

    # the class path end to end, one shard's class work at each k, and the
    # class exchange against the SP path's
    classes = polymul_fourstep_mxu_classes_fn(MAIN_SET, make_mesh(model=SP_K))
    res = _turns(classes, lambda a, b: C.polymul_fourstep_mxu_classes_plain(
        a, b, plans, cp), (x, y))
    print(f"timing class path k={SP_K} (2 x B17, B18, B16, 3 exchanges, the "
          f"first of {cp.Dout} planes, and the shard layout): median "
          f"{res['kernel'][1]:.4f} ms, plain {res['plain'][1]:.4f} ms; SP "
          f"path {sp_med:.4f}, B17 {med['sp_seg1_classes']:.4f}, B18 "
          f"{med['sp_seg2_classes']:.4f}, B11 {med['sp_seg1']:.4f}, B12 "
          f"{med['sp_seg2']:.4f} [{device_line}]", flush=True)
    for k in (2, 4, 8):
        times = {}
        for what, make in (("classes", local_pipeline_classes_fn),
                           ("SP", local_pipeline_fn)):
            pipe, lp = make(MAIN_SET, k)[:2]
            xl, yl = (t[:, :lp.nloc].contiguous() for t in (x, y))
            times[what] = (time_cuda(pipe, xl, yl, warmup=3,
                                     repeats=20).median_ms,
                           cold(pipe, xl, yl))
        tl, tc = times["classes"]
        print(f"timing local_pipeline_classes_fn k={k}: B={B} nloc={lp.nloc} "
              f"median {tl:.4f} ms warm, {tc:.4f} ms cold "
              f"(local_pipeline_fn {times['SP'][0]:.4f}, "
              f"{times['SP'][1]:.4f}); SP cost per shard (cold) "
              f"k*t_local/t_B5 = {k * tc / single['polymul_mxu']:.3f}, "
              f"k*t_local/t_B1 = {k * tc / single['polymul_fused']:.3f} "
              f"[{device_line}]", flush=True)
    v1 = S.sp_seg1(sx, plans)
    u1 = C.sp_seg1_classes(sx, plans, cp)
    t_sp, t_cls = (time_cuda(f, t, warmup=3, repeats=20).median_ms
                   for f, t in ((lambda t: S.a2a_fwd(t, plans), v1),
                                (lambda t: C.a2a_fwd_classes(t, plans,
                                                             cp.Dout), u1)))
    print(f"timing exchange on one card: a2a_fwd_classes {t_cls:.4f} ms "
          f"({_nbytes(u1) / 1e6:.0f} MB), a2a_fwd {t_sp:.4f} ms "
          f"({_nbytes(v1) / 1e6:.0f} MB) [{device_line}]", flush=True)
    done()
    return out


def _cli_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    return env


def _cli(argv: list) -> str:
    """One CLI command in a subprocess: print it and its wall time, raise
    unless it exits 0, return its output."""
    start = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "qtesla_tpu_torch.cli",
                           *map(str, argv)], capture_output=True, text=True,
                          cwd=REPO, env=_cli_env(), timeout=CLI_TIMEOUT_S)
    print(f"5: cli {' '.join(map(str, argv))}: exit {proc.returncode}, "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"cli {argv} exited {proc.returncode}:\n"
                             f"{proc.stdout}\n{proc.stderr}")
    return proc.stdout


def _json_rows(out: str) -> list:
    return json.loads(out.strip().splitlines()[-1])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _cli_ranks(argv: list) -> list[str]:
    """The CLI with --distributed over CLI_RANKS ranks on the card, joined
    through torchrun's variables; each rank waited on at most
    CLI_TIMEOUT_S and killed in any case.  Returns each rank's output."""
    start = time.perf_counter()
    env = _cli_env() | {"MASTER_ADDR": "localhost",
                        "MASTER_PORT": str(_free_port()),
                        "WORLD_SIZE": str(CLI_RANKS)}
    procs = []
    try:
        for r in range(CLI_RANKS):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "qtesla_tpu_torch.cli",
                 *map(str, argv)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True, cwd=REPO,
                env=env | {"RANK": str(r), "LOCAL_RANK": str(r)}))
        deadline = time.monotonic() + CLI_TIMEOUT_S
        logs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0]
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    print(f"5: {CLI_RANKS} ranks, cli {' '.join(map(str, argv))}: exit "
          f"{[p.returncode for p in procs]}, "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} of cli {argv} exited "
                                 f"{p.returncode}:\n{log}")
    return logs


def cli_on_the_card(times: dict, device_line: str) -> None:
    """Phase 5: ``python -m qtesla_tpu_torch.cli`` as subprocesses (fresh
    interpreters that load phase 1's library), every command exiting 0:
    info; correctness of every algo, kernels included, at qtesla-iii-speed
    on random operands against the oracle; speed (plain, --fixed,
    --streamed) and sweep at B up to 32768; microbench; scaling in one
    process and across CLI_RANKS gloo ranks on the card, whose rows must
    carry the shared-card caveat.  The speed medians are printed beside
    phase 4's B1 and B5 medians (no gate: the CLI chains its calls)."""
    start = time.perf_counter()
    B = MAIN_BATCH
    for line in _cli(["info"]).splitlines():
        print("5: " + line)

    out = _cli(["correctness", "--param-set", MAIN_SET, "--algo", "all",
                "--random"])
    rows = [ln for ln in out.splitlines() if ln.startswith("  ")]
    bad = [ln for ln in rows if not ln.endswith("Identical.")]
    if (bad or len(rows) != 2 * len(ALGORITHMS)
            or {ln.split()[0] for ln in rows} != set(ALGORITHMS)):
        raise AssertionError(f"cli correctness: {len(rows)} lines, not "
                             f"Identical.: {bad}")
    print(f"5: correctness --algo all --random at {MAIN_SET}: "
          f"{len(rows)} lines Identical. ({len(ALGORITHMS)} algos against "
          f"{rows[0].split(' vs ')[1].split(':')[0]}, then the all-ones "
          f"closed form)")

    speed = _json_rows(_cli(["speed", "--algo", "fused,mxu", "--batch", B,
                             "--iters", 40, "--json"]))
    ref = {"fused": ("B1", times["polymul_fused"]["kernel"][1]),
           "mxu": ("B5", times["polymul_mxu"]["kernel"][1])}
    for row in speed:
        name, ms = ref[row["algo"]]
        print(f"5: speed {row['algo']} B={row['batch']}: median "
              f"{row['median_ms_per_iter']:.4f} ms a call, min "
              f"{row['min_ms_per_iter']:.4f} ({row['clock']}, chained); "
              f"phase 4 {name} median {ms:.4f} ms [{row['device']}]")
    fixed = _json_rows(_cli(["speed", "--fixed", "--algo", "fused,mxu",
                             "--batch", B, "--json"]))
    if [r["algo"] for r in fixed] != ["fixed/fused", "fixed/mxu",
                                      "fixed/mxu-folded"]:
        raise AssertionError(f"cli speed --fixed rows {fixed}")
    streamed = _json_rows(_cli(["speed", "--streamed", "--algo", "fused",
                                "--batch", B, "--json"]))
    for row in fixed + streamed:
        print(f"5: speed {row['algo']} B={row['batch']}: median "
              f"{row['median_ms_per_iter']:.4f} ms a call, min "
              f"{row['min_ms_per_iter']:.4f} ({row['clock']}) "
              f"[{row['device']}]")
    if streamed[0]["clock"] != "host":
        raise AssertionError("the streamed bracket must be the host's clock")

    for cmd in (["sweep", "--algo", "fused", "--batches",
                 "1024,4096,16384,32768"], ["microbench"]):
        for line in _cli(cmd).splitlines()[1:]:
            print("5: " + line.strip())

    one = _json_rows(_cli(["scaling", "--algo", "fused", "--global-batch", B,
                           "--json"]))
    logs = _cli_ranks(["--distributed", "--backend", "gloo", "scaling",
                       "--algo", "fused", "--model", CLI_RANKS,
                       "--global-batch", B, "--json"])
    ranks = _json_rows(logs[0])
    shared = CLI_RANKS > torch.cuda.device_count()
    if [(r["mode"], r["devices"]) for r in ranks] != [
            ("dp", 1), ("dp", 2), ("fourstep_sp", 2), ("ulysses_sp", 2)]:
        raise AssertionError(f"cli scaling across ranks: rows {ranks}")
    if shared and not all(r["virtual_devices"] and "gloo" in r["caveat"]
                          for r in ranks):
        raise AssertionError(f"cli scaling: rows of ranks sharing the card "
                             f"without the caveat: {ranks}")
    for r in one + ranks:
        eff = {k: r[k] for k in ("overhead_eff", "vs_dp_eff") if k in r}
        print(f"5: scaling {r['mode']} devices={r['devices']} "
              f"B={r['batch']}: {r['polymuls_per_s']:,.0f} polymuls/s "
              f"{eff} [{r['device']}, {r['clock']}]"
              + (" (caveat)" if "caveat" in r else ""))
    for caveat in dict.fromkeys(r["caveat"] for r in one + ranks
                                if "caveat" in r):
        print(f"5: caveat: {caveat}")
    for r, log in enumerate(logs[1:], 1):
        print(f"5: rank {r}: {log.strip().splitlines()[-1]}")
    print(f"5: every CLI command exited 0; phase wall time "
          f"{time.perf_counter() - start:.1f} s [{device_line}]", flush=True)


def main() -> int:
    phase("0 device")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    device_line = smi()
    nvcc = find_nvcc()
    nvcc_version = subprocess.run([nvcc, "--version"], capture_output=True,
                                  text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {device_line}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"torch CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    print(f"nvcc: {nvcc_version.splitlines()[-1]}")
    done()

    phase("1 build")
    start = time.perf_counter()
    lib = load_library()
    print(f"built {lib.path.name} in {lib.build_seconds:.1f} s (nvcc), "
          f"{time.perf_counter() - start:.1f} s with loading")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  " + line.strip())
    done()

    phase("2 kernels against plain, on the card")
    errors = {name: 0 for name in KERNELS}
    kernels_against_plain(errors)
    sp_against_plain(errors)
    classes_against_plain(errors)
    pass_lengths_against_plain(errors)
    sweep_lengths_against_plain(errors)
    small_rings_against_plain(errors)
    split_against_plain(errors)
    registration_sweep()

    phase("3 main path at full size")
    launches, ctx = main_path(errors, SEED)

    phase("3b remaining paths at full size")
    remaining_paths(ctx, device_line)

    phase("3c ranks on the card")
    ranks_on_the_card(ctx, device_line)
    del ctx

    phase("3d q30 at full size")
    q30_times = q30_full_size(device_line)

    phase("3e large rings")
    large, split_times = large_rings(device_line)
    small_rings_timing(device_line)
    sp_large, sp_times = sp_large_rings(device_line, errors)
    large = {name: large[name] + sp_large[name] for name in KERNELS}

    phase("4 timing")
    times = timing(device_line, q30_times) | split_times | sp_times

    phase("5 the CLI on the card")
    cli_on_the_card(times, device_line)

    phase(None)
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "qtesla_tpu"))
    if loaded:
        raise AssertionError(f"jax or the JAX package was imported: {loaded}")
    kernels = [{
        "name": name, "route": "cuda", "source": source,
        "replaces": k.replaces, "launches": launches[name] + large[name],
        "max_abs_err": errors[name], "ms": times[name]["kernel"][1],
        "plain_ms": times[name]["plain"][1],
        "bound_ms": times[name]["bound"][0],
        "bound_by": times[name]["bound"][1], "library_ms": None,
    } for name, (k, source) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(device_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
