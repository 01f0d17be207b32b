"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. Card and build: the card's name and power limit, then the twelve CUDA
   sources (sym_packed, local_update, lse_rows, epi_sum_square,
   epi_neg_log, sum_logistic, tv1d_pdas, epi_exp, sum_kl_div, sum_inv_pos,
   w_log_w, and launch_floor, the empty kernels and measured chains of
   phase 7a) are compiled from
   ``epsilon_tpu_torch/csrc``, one ``nvcc`` each, started together.
2. Kernel against its plain PyTorch version on the card, at the shape the
   main path gives it (n = 8192, R = 1) and at R = 8, in f32 and f64:
   maximum error, bitwise repeatability, and CUDA-event times of the
   kernel, the plain version and a dense matmul with the full matrix (device
   time, and the per-call time when calls are issued back to back).
3. Flagship lasso 2000 x 1000 through ``Problem.solve`` (f32, rho 1,
   rel_tol 1e-3), checked against numpy/scipy in f64.
4. The slice configuration, lasso 16384 x 8192 through ``Problem.solve`` in
   the default CUDA mode (explicit inverse, so the 8192-dimensional pivot
   applies through the sym_packed kernel every iteration), with the launch
   count and the same f64 check; then the same problem once more from a
   cold state with ``over_relaxation=1.5`` on the cached solver (no second
   set-up), one kernel launch per iteration.
5. Kernel K1 (fused consensus local update) against its plain PyTorch
   version at (S, n) = (200, 200) in f32 and f64 (the consensus row's
   shape), (50, 200) in f32 (one rank's blocks in phase 9 (d), where the
   plan must be the streaming path), (40, 5000) in f32 (4 GB of inverses,
   generated on the card) and the ragged (8, 130) in f32 and f64, on every
   path a shape can take (the
   plan's own and, where that is the ring, the streaming path through the
   private launcher): error, bitwise repeatability, two rho values through
   one loaded library, and device times of the kernel, the plain version,
   a ``Finv.sum()`` read of the same bytes, and the library call that
   computes the same function (``torch.bmm`` of the inverses with the
   right-hand side, and the sum over blocks).  Then library call, kernel
   and streaming path are timed in turns (library, kernel, stream, stream,
   kernel, library, for several rounds), each side's median and min-max
   printed, and at (200, 200) in f32 once more with L2 flushed between
   launches.
6. Consensus lasso at full width (bench.py's consensus row: 200 blocks of
   2500 x 200, 1e8 nonzeros, seed 0, lambda 0.1, rho 1, f32) through
   ``consensus_lasso_solver`` in the default CUDA mode (explicit inverse, so
   K1 runs every iteration): a solve to rel_tol 1e-5 checked in f64 numpy
   on the stacked problem and against a numpy f64 consensus iteration, the
   set-up timed in pieces, bench.py's steady re-solves of 500 iterations,
   and the K1 launch count; then the port's ``parallel.entry()`` (one
   epoch of a 4 x 32 x 16 consensus lasso as a pure function of data and
   state) once on the card against the consensus solver's own epoch.
7a. The per-row loop kernels (K3 ``lse_rows``: the LOG_SUM_EXP prox and
   epigraph; K4 ``epi_sum_square``; K5 ``epi_neg_log``) against their
   plain PyTorch versions on the card, at the shapes phase 7 gives them
   and at widths 1, 31, 33 and 257, in f32 and f64, with active and
   inactive rows: error, bitwise repeatability, and device times of kernel
   and plain version at the main path's shape, beside an empty kernel's
   launched through the same path (the launch floor).  K3, K4 and K5 stop
   their loops once the state repeats: there, and on rows whose Lambert
   arguments fall where the solve can settle into a 3-cycle and on rows
   with NaN, inf and values <= 0, each is held bitwise to its full-count
   build (the same kernel with the exit compiled out) and its step counts
   to the loops' counts; K3's prox, which runs rows of up to 16 two to a
   warp, is also held bitwise (results and step counts) to the same
   kernel one row a warp at widths 1, 7-10, 15, 16 and on mnist's rows,
   with the resident warps a SM and the waves mnist's shape takes in both
   layouts; at the main path's shape in f32 each is timed in turns with
   the builds it replaces (kernel, full count, and for K3's prox one row a
   warp, then in reverse, 5 rounds of 20 calls a reading; median and
   min-max), beside the bound of the steps this run took.  Then K6
   ``sum_logistic_prox`` (one thread an element, the launch spread over
   the SMs; its Newton exits when its state repeats, checked every fourth
   step) at the main path's 1,500 elements and at other sizes, f32 and
   f64, lam a number, a 0-d tensor and one an element: bitwise against its
   full-count build and its plain version (on the special values against
   the full-count build bitwise, the plain version's values), timed
   (kernel and full count in turns, plain, the launch floor) beside its
   bound, the measured chain of the steps its longest element took (an
   empty-handed chain of its arithmetic, ``launch_floor.cu`` k6_chain).
   And K7
   ``tv1d_pdas`` (the whole TV-1D PDAS in one cooperative launch, its first
   PCR levels in shared memory): its PCR solve bitwise against the plain
   ``pcr_tridiag_solve`` on the card, at the tile's edges too; the PDAS
   bitwise against the levels build it replaced (``pdas_levels``: x, z,
   gap, rounds), against the plain version and the exact oracle within
   ``K7_RTOL``, bitwise repeatable, cold and warm, lam a number and a 0-d
   tensor, with the plain version's rounds at the inner tolerances (within
   one at the default), each build's grid syncs counted on the device
   equal to its formula's for its rounds; at tv_1d's and fused_lasso's lengths in f32, cold
   and warm at the main path's inner tolerance, the tile build, the levels
   build and the plain version timed in turns, each build beside an empty
   cooperative kernel with its grid syncs at its grid (its floor: syncs x
   their cost).  And K8 ``epi_exp`` (the EXP epigraph, one thread an
   element: the bracket's widening, which stops once it leaves the end
   unchanged, and the safeguarded Newton, K6's exit) at ``max_softmax``'s
   2,000 elements under ``use_epigraph=False`` and at other sizes, f32 and
   f64, s one an element, a number and a 0-d tensor, active and inactive
   elements and s <= 0, and on the special values: as K6, bitwise against
   its full-count build and its plain version, its step counts within the
   loops' counts, the main shape against an f64 numpy test of the
   projection (feasibility and the active elements' KKT conditions), and
   timed as K6 beside its measured chain (``epi_exp_chain``).  And K9
   ``sum_kl_div`` (the SUM_KL_DIV prox: a widening of the bracket's upper
   end, which stops once it leaves the end unchanged, and a 60-step
   safeguarded Newton, K6's exit), K10 ``sum_inv_pos`` (the SUM_INV_POS
   prox: the same design, its cube root torch's sign and pow) and K11
   ``w_log_w`` (the SUM_EXP and SUM_NEG_ENTR proxes on the 30-step Lambert
   solve of K3, exiting at its state's first repeat), one thread an
   element, at their main paths' shapes (K9 10,000 elements, the
   two-argument family's; K10 and K11 10^6, eval_prox's in phase 8 (g)) and
   at other sizes, f32 and f64, lam a number, a 0-d tensor on the card, one
   an element and one a row (K9 also with u and v the halves of one packed
   tensor's rows, read where they lie), and on the special values: as K8,
   bitwise against their full-count builds and their plain versions, their
   step counts within the loops' counts, K10's cube root
   (``launch_floor.cu`` cube_root) bitwise against the plain version's on
   the card, and timed as K8, in turns with their full counts and their
   measured chains (``kl_div_chain``, ``inv_pos_chain``, ``w_log_w_chain``:
   lam by value, each warp running its slowest element's steps).  At 10^6
   elements they are checked with lam a number only (eval_prox's), every
   kind of lam at 10,000.
7. The problem library: every row of ``PROBLEMS_REFERENCE`` at the
   reference sizes (full width), through ``problems.benchmark``
   (``Problem.solve``) in f32 at the harness's parameters, the rows of
   ``LIBRARY_BESIDE`` in a second process beside the others.  Each row prints build, compile, set-up and solve
   seconds, iterations, ms per iteration, device operations per iteration
   (a profiled warm re-solve) and the objective, which is held to the JAX
   package's f64 objective (``tests/data/library_reference.json``) by the
   oracle matrix's one-sided test and by the same band below it; each row
   must stop ``optimal`` (or as the f64 reference did: ``max_gaussian``
   reaches the iteration cap in both), and the rows with hard constraints
   also pass a feasibility residual computed in f64 numpy.  K3, K4 and K5
   must each launch in it, K6 in both logistic rows and K7 in ``tv_1d`` and
   ``fused_lasso`` (each row prints the hand loop kernels it launched; no
   row runs K8 under these parameters).
7c. The library under the oracle matrix's other two parameter sets
   (``LIBRARY_SETS``): every row of ``PROBLEMS_REFERENCE`` at the
   reference sizes in f32, through ``problems.benchmark`` with
   ``solver="prox_admm"`` (the N-block Gauss-Seidel solver) and then with
   ``use_epigraph=False`` (the conic fallback), each set in a spawned
   process of its own that starts with phase 7 and runs beside phases 7
   and 8.  Each row is held as phase 7 holds its rows, against the JAX
   package's f64 objective under the same set (the set's key of
   ``library_reference.json``) and at its iteration cap, and prints the
   same figures and the launches of K2-K7 while it ran; each set then
   prints its table.  K3 (a), K3 (b), K4 and K5 must each launch in the
   phase (K3 (b) and K4 only under ``prox_admm``: without the epigraph
   ``max_softmax`` runs the EXP epigraph and ``oneclass_svm`` second-order
   cones), K6 in both logistic rows and K7 in ``tv_1d`` and ``fused_lasso``
   under each set, and K8 in ``max_softmax`` under ``no_epi``.  A failed
   row makes the phase raise after both sets.
8. The rest of the solver's one-device surface at the flagship's width
   (lasso 2000 x 1000, phase 3's data, f32), each solve ``optimal`` and
   held to phase 3's f64 checks: (a) adaptive rho; (b) the data scaled by
   30 (the same minimiser, rho 1 far from balanced), fixed rho 1 and
   adaptive; (c) the N-block solver at rho 1 and 4; (d) a ``Parameter``
   right-hand side re-solved five times on one cached solver; (e) a stop
   callback under ``drive="host"``; (f) a checkpoint, resumed by a new
   solver; (g) ``eval_prox`` of six kinds at 1e6 elements against the
   port on the CPU in f64: three with closed forms and
   ``sum_entries(exp(x))``, ``sum_entries(-entr(x))`` (K11) and
   ``sum_entries(power(x, -1))`` (K10), on inputs from the seed inside
   their domains, each of which must launch its kernel.
9. The meshed two-block solver and the sharded consensus solver, run by
   four processes over one process group (``tools/mesh_worker.py``, one
   rank each): NCCL with a card a rank where the machine has four cards,
   otherwise gloo with CUDA tensors, every rank on the one card; the line
   printed says which.  A rank that exits non-zero or outlives the hard
   timeout (and is killed) fails the run.  (a) Scenario stacking at full
   width: phase 6's data stated as a general problem (200 SUM_SQUARE terms
   over private variables tied to one z, NORM_1 on z) through
   ``Problem.solve(mesh=group)``: one group of 200, 50 rows a rank, held in
   f64 numpy to the stacked lasso's KKT test and to phase 6's objective,
   the same x on every rank bitwise.  (b) Term buckets at full width: the
   heterogeneous problem of ``tests/test_term_sharding.py`` at n = 2048
   with 64 groups against the same solve in this process (same iteration
   count, x within 1e-4 relative), then the flagship lasso on four ranks
   (two empty buckets) held to phase 3's checks.  (c) ``solver="prox_admm"``
   with the group on the flagship lasso, and adaptive rho with the group on
   (b)'s problem.  (d) The sharded consensus solve of phase 6's data, K1 on
   every rank's 50 blocks (the streaming path, at the shape phase 5 holds
   to the plain version), for 500 iterations against phase 6's z.
   (e) Wide scenarios: 64 blocks of 200 x 2000 (fewer rows than features;
   102.4 MB of A, a quarter a rank) with NORM_1 on z at lambda 0.1 through
   ``Problem.solve(mesh=group)``: every term keeps its factored KKT chain
   and the 64 stack as one group, 16 rows a rank; against the same solve in
   this process (same iteration count, x within 1e-4 relative).  (f) One
   consensus family of 8 per operator kind stacked since (TV-1D with its
   warm dual at d = 10^4, the epigraph, matrix, per-slice and
   two-argument modes, sparse and Kronecker blocks) with a sum of squares
   on z, each against its solve in this process the same way (the matrix
   and per-slice families to convergence; the others, the costliest a
   call, stop short of it at 10-60 iterations; the nuclear-norm family's x
   within 1e-3, the bound of its f32 solution and the card's SVDs); K7 must
   launch on every rank and in the one-process solve of the TV family, K8
   in those of the ``epigraph_elementwise`` family, K9 in those of the
   ``two_arg`` family.
   (g) (e) stopped after three epochs under ``drive="host"`` with a
   checkpointer, resumed by a new solver on the
   four ranks and then on two ranks (a second launch): both reach (e)'s
   iteration total and x within 1e-6 relative.

Depth cut when phase 9 was added, no kernel or check with it: the timed warm
re-solves of phases 3 and 4 run 500 and 100 iterations (2000 and 200
before); when (e)-(g) were added, phase 9 (a)'s warm re-solves run 50
iterations (100 before).  Phase 7c solves ``max_gaussian`` at 20,000
iterations in both sets (its f64 references at the same cap; 50,000 in
phase 7): at about 6 ms an iteration beside the other processes its
50,000 would keep the phase running about 290 s past phase 8, 20,000 about
110 s.  At the cap the port in f32 on the CPU is within 3.4e-5 of the f64
objective in both sets.
On an H100 the script takes about 550-715 s (the host sets most of the
spread; 565 s since K6 and K7 carry the logistic and TV rows), of which
the build takes about 10 s (``lse_rows.cu``'s 20
kernels: prox and epigraph per dtype, row in registers or not, with and
without the exit, and the half-warp prox per dtype with and without it),
phase 7a about 65 s (K6 and K7 about 25 s of it; K7's tile build held
bitwise to its levels build at 15 lengths),
phase 7 about 270-380 s (``max_gaussian``'s 50,000 iterations,
215-250 s in the second process; beside it the other rows' host-side build and
set-up at reference size and ``infinite_push``'s 19,860 iterations) and
phase 7c's two processes about 345-440 s from the start of phase 7, so
they end about 15-110 s after phase 8 (the ``max_gaussian`` rows take 30 s
at 5,000 iterations, 110-120 s at 20,000; ``infinite_push`` about 55 s,
``oneclass_svm`` under ``prox_admm`` 40 s),
phase 9 about 130-150 s (the one-process references of (e) and (f) about
30-45, the four ranks about 75-90, the two that resume (g) about 15);
phases 3, 4 and 6 together hold under 2 s of steady iterations.

Each record of the ``kernels`` line carries, beside the measured times,
``bound_ms``: the least time the card could take, the larger of the bytes
the function must move (inputs read once, outputs written once) over
3.35 TB/s and its operations over 67 TFLOP/s (the H100's published HBM
rate and float32 rate outside the tensor cores), and for the per-row loop
kernels their dependent chain at the card's maximum SM clock
(``row_chain_ops``), which binds them.  K6's and K8's chain is measured:
an empty-handed kernel of the same arithmetic, launched as they launch,
run for the steps their longest element took (``k6_chain_ms``,
``k8_chain_ms``).

K1 has two records, one for each shape and path that a main path gives
it: (200, 200) on the ring path with phase 6's launches, and (50, 200) on
the streaming path with rank 0's launches in phase 9 (d).  The records of
K2-K8 also carry ``launches_7c``: their launches in phase 7c, per set; K7's
``launches_9f``, rank 0's in phase 9 (f)'s TV family, and its timings at
both main lengths, cold and warm; K8's ``launches_9f``, rank 0's in the
``epigraph_elementwise`` family, and its ``launches`` those of phases 7
and 7c (no phase 7 row runs it).  K9's ``launches`` are rank 0's in phase 9
(f)'s ``two_arg`` family (``launches_7`` those of phase 7: none), K10's
and K11's those of phase 8 (g) (K11's record also carries its SUM_NEG_ENTR
entry's times under ``sum_neg_entr``).  K6's and K8's ``bound_ms`` is the
measured chain of the steps of their longest element (``chain_ms``;
``full_count_chain_ms`` for the full counts), K9's-K11's the measured chain
of each warp's slowest element's steps (``chain_ms``; timed in turns with
the kernel, its full count and the full counts' chain, which should read
at most the full-count build); K7's is the bound of its work, bytes
or operations, with its grid-sync floor beside it (``floor_ms``: its
syncs, counted on the device (``tv1d_pdas.sync_counter``) and checked
against ``tv1d_pdas.syncs_per_round``, times their measured cost at its
grid) and the levels build's time (``levels_ms``).

Prints a ``{"kernels": [...]}`` line, then a last line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
when no CUDA device is available.
"""

import json
import os
import ctypes
import functools
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import scipy.linalg
import scipy.sparse
import torch

# Phase 2 tolerance, relative to max |plain result|: the kernel sums in
# another order than torch.bmm + index_add_.
KERNEL_RTOL = {torch.float32: 1e-4, torch.float64: 1e-12}
# Lasso optimality: max over i of the subgradient violation of
# A'(Ax - b) + lam * sign(x), divided by lam.  ADMM stopped at rel_tol 1e-3
# leaves about 7e-4 here (measured on the CPU in f64 at 2000 x 1000).
KKT_TOL = 1e-2
# Flagship objective against the numpy two-block iteration run to 1e-12.
OBJ_RTOL = 1e-4
# Iterations of the timed warm re-solves of the 2000 x 1000 and the
# 16384 x 8192 lasso.
FLAGSHIP_STEADY_ITERS = 500
STEADY_ITERS = 100
# Phase 5 tolerance, relative to max |plain result|: the kernel sums in
# another order than torch.bmm.
LOCAL_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# Phase 6: consensus z (f32 on the card) against a numpy f64 consensus
# iteration run for the same count of iterations.  The port in f32 on the
# CPU drifted 1.4e-7 to 3.4e-7 from it at 20 and 40 blocks of 2500 x 200
# (max |z| about 2).
CONSENSUS_Z_ATOL = 1e-5
# bench.py's consensus row: re-solves of 500 iterations, epochs of 50.
CONSENSUS_STEADY_ITERS = 500
CONSENSUS_REPS = 3
# Phase 5's interleaved A/B: rounds, and calls per reading.
AB_ROUNDS = 5
AB_REPS = 20
# Phase 5's L2-cold reading: bytes written between launches, above the
# H100's 50 MB of L2.
L2_FLUSH_BYTES = 256 * 1024 * 1024
# Spin before each device-timed call (about 1 ms): longer than any host
# enqueue time of the calls timed.
HEAD_START_CYCLES = 2_000_000
# Phase 7: the harness's rel_tol (benchmark_epsilon's default, the
# parameter the reference objectives were made at); each row's iteration
# cap is its reference's (50,000, the harness's, unless the row is capped).
LIBRARY_REL_TOL = 1e-3
# The oracle matrix's one-sided test (tests/test_solve_suite.py):
# obj <= ref + 1e-2 |ref| + 1e-4, both in the minimization form that
# Problem.solve returns (a Maximize row's objective is negated); the same
# band below the reference holds an objective that comes out too low.
LIBRARY_OBJ_RTOL, LIBRARY_OBJ_ATOL = 1e-2, 1e-4
# tv_1d in f32 stops 1.2-1.3 % above the f64 objective, in both packages:
# 214097.16 (the port in f32 on the CPU and on an H100), 213744.14 (the JAX
# package in f32 on the CPU), against 211312.96 in f64; still 213983.14 at
# rel_tol 1e-5.  The f32 PDAS certificate floor is 3e-4 (config.py).
LIBRARY_OBJ_RTOL_ROWS = {"tv_1d": 2e-2}
# Relative violation of the hard constraints, in f64 numpy.
LIBRARY_FEAS_TOL = 1e-2
# portfolio stops at rel_tol 1e-3 with x's negative part of norm 0.0925
# (min -3.6e-3 over 500000 entries; feasibility 6.19e-2) in the JAX
# package's own f64 solve on the CPU, and the same in the port's f32 solve
# on the CPU and on an H100.
LIBRARY_FEAS_TOL_ROWS = {"portfolio": 1e-1}
# Rows that phase 7 solves in a second process while this one solves the
# others: max_gaussian's 50,000 iterations take 150-230 s of the script
# (3.0-4.5 ms each on an H100, a loop bound by its host, the card idle
# 0.91 of it), as long as the other 26 rows together.
LIBRARY_BESIDE = ("max_gaussian",)
# Phase 7c: the oracle matrix's other two parameter sets, each a key of
# tests/data/library_reference.json that holds its solver parameters and
# its rows' f64 references (tools/library_reference.py), each solved in a
# process of its own beside phases 7 and 8.
LIBRARY_SETS = ("n_block", "no_epi")
# Iterations of the profiled warm re-solve that counts device operations.
LIBRARY_PROFILE_ITERS = 10
# Phase 7a: the per-row loop kernels against their plain versions,
# relative to max(1, max |plain result|).  The kernels repeat the plain
# versions' operations in the same order but for the row sums (a lane-
# strided butterfly against torch.sum); the loops converge, so the two
# differ by rounding times the conditioning of the root.
ROW_RTOL = {torch.float32: 1e-4, torch.float64: 1e-10}
# The odd widths at which phase 7a also holds each kernel (one lane, a
# warp short, a warp over, and beyond eight elements a lane).
ROW_WIDTHS = (1, 31, 33, 257)
# The widths at which phase 7a holds K3's half-warp prox to the same
# kernel one row a warp (one lane, around a quarter and a half of the
# warp, mnist's 10), on an odd count of rows (the last half-warp idle).
HALF_WARP_WIDTHS = (1, 7, 8, 9, 10, 15, 16)
HALF_WARP_ROWS = 63
# The plain LOG_SUM_EXP epigraph issues about 208,000 eager operations a
# call (2.5 s on an H100): its time is the median of 5 calls, not 50.
ROW_PLAIN_REPS = {"lse_epi_rows": 5}
# Cycles an operation of a dependent chain takes at least (the latency of
# a dependent float32 instruction on the H100's SMs); with the card's
# maximum SM clock, it turns a chain's length into the least time.
ROW_CYCLES_PER_OP = 4
# The H100's published peaks (SXM part): HBM bytes/s, and float32 FLOP/s
# outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# Phase 8 (g): eval_prox on the card in f32 against the port on the CPU in
# f64, relative to max |CPU result|.
EVAL_PROX_RTOL = 1e-4
EVAL_PROX_N = 1_000_000
# Phase 8 (f): the resumed solution against the uninterrupted one.
RESUME_ATOL = 1e-5
# Phase 9: ranks, the hard limit on the workers' run, and (b)'s x against
# the one-process solve, relative to max |x|.
MESH_WORLD = 4
# about twice what the ranks took on an H100 with parts (e)-(g)
MESH_TIMEOUT_S = 400
MESH_X_RTOL = 1e-4
# Phase 9 (f): the nuclear-norm family against its solve in this process.
# Its f32 solution is good to about 1.6e-5 (f32 against f64 on the CPU, the
# same problem) and the card's SVDs and batched products round in another
# order for a stack than for one matrix: 1.43e-4 apart at convergence on an
# H100 (the other families 5e-7 to 3e-5).  Held to 1e-3.
MESH_F_SPECTRAL_RTOL = 1e-3
# Phase 9 (g): a resumed solve against the uninterrupted one, relative to
# max |x| (f32; on the same four ranks the two are the same operations).
MESH_RESUME_RTOL = 1e-6
# Phase 6: entry()'s epoch against the consensus solver's own (the same
# operations on the same inputs).
ENTRY_ATOL = 1e-6
# K1's shape on one rank of phase 9 (d): a quarter of the consensus row's
# 200 blocks.  Phase 5 holds the kernel to its plain version there.
K1_RANK_SHAPE = (200 // MESH_WORLD, 200)
REFERENCE_JSON = Path(__file__).resolve().parent / "tests" / "data" / "library_reference.json"
# Phase 7a, K6 (the SUM_LOGISTIC prox): the sizes at which it is also held
# (one element, a block short and over, a large vector) and the range of v
# and of lam (log-uniform).
K6_SIZES = (1, 255, 257, 100_000)
K6_V_RANGE = 60.0
K6_LAM_EXP = (-6.0, 6.0)
# Phase 7a, K8 (the EXP epigraph): the main path's elements (max_softmax's
# EXP epigraph under use_epigraph=False: 2,000, s one an element), the
# sizes at which it is also held, the range of v and of s / e^v (decades),
# and the f64 numpy test of the projection at the main shape, relative to
# the scale of each condition's terms (the f32 result rounds at 6e-8 of
# e^2x; 25 Newton steps leave no element of this range short of its root).
K8_MAIN_N = 2000
K8_SIZES = (1, 255, 257, 20_000, 100_000)
K8_V_RANGE = 10.0
K8_S_DECADES = 3.0
K8_KKT_RTOL = {torch.float32: 1e-4, torch.float64: 1e-10}
# Phase 7a, K9 (the SUM_KL_DIV prox), K10 (SUM_INV_POS) and K11 (the
# SUM_EXP and SUM_NEG_ENTR proxes): the main path's elements (K9: phase 9
# (f)'s two-argument family, d = 10,000; K10 and K11: eval_prox's 10^6 of
# phase 8 (g)), the sizes at which each is also held, the rows of the
# per-row lam case, and the inputs: u and v (K9) or v (K10, K11) uniform
# over -V/2..V and +-V, lam log-uniform over 10^+-LAM_EXP.
K9_MAIN_N = 10_000
K9_SIZES = (1, 255, 257, 100_000)
K10_K11_SIZES = (1, 255, 257, 10_000)
ELEMENT_LOOP_ROWS = 8
ELEMENT_LOOP_V = 10.0
ELEMENT_LOOP_LAM_EXP = 3.0
# Phase 7a checks K9-K11 with every kind of lam up to this many elements,
# and above it with lam a number only
ELEMENT_LOOP_ALL_KINDS_N = 100_000
# Phase 7a, K7 (the TV-1D PDAS): the lengths at which it is also held (two
# and three elements, odd, 2^k - 1 and 2^k + 1 around the PCR's step
# counts), the PCR systems' sizes (m = n - 1 of those and of the main
# path's lengths), and the inner tolerances at which its rounds must equal
# the plain version's (the solver's prox_inner_tol_for range: at least 3e-4
# in f32, 1e-7 in f64; at the default PDAS tolerance the f32 gap test reads
# rounding noise, and below 3e-4 the f32 gap floors above its threshold so
# that the stop rests on the full step's change of J, a sum at the rounding
# scale: the two may differ by a round there).
K7_LENGTHS = (2, 3, 17, 1023, 1025, 4097)
K7_INNER_TOLS = {torch.float32: (1e-3, 3e-4), torch.float64: (1e-4, 1e-6)}
K7_ROUND_SLACK = 1
# K7 against the plain PDAS on the card, max |x - x_ref| over max(1, max
# |v|) (the two differ only in the order of their sums), and against the
# exact taut-string oracle (tv1d_exact_numpy) within the same at the
# default tolerance (the plain version's distance from the oracle there is
# 7e-6 relative in f32 and 1e-14 in f64 on an H100), at an inner tolerance
# plus the PDAS certificate of the returned dual, sqrt(2 gap) with the gap
# of z evaluated in f64 (at a loose inner tolerance the PDAS stops that far
# from x*).
K7_RTOL = {torch.float32: 1e-4, torch.float64: 1e-9}
# Rows of the PCR and lengths n = m + 1 of the PDAS at the tile build's
# edges at its main-path tile (T = 511 rows, K = 8 levels, halo H = 255):
# 2^K - 1, 2^K (the largest whole-row window) and 2^K + 1, T - 1, T, T + 1,
# T + H.
K7_TILE_ROWS = (255, 256, 257, 510, 511, 512, 766)
# The plain PDAS at n = 100,000 takes about 160 ms a call on an H100: its
# readings in turns are of K7_PLAIN_REPS calls, the builds' of
# K7_KERNEL_REPS.
K7_AB_ROUNDS, K7_PLAIN_REPS, K7_KERNEL_REPS = 3, 3, 20
# Floating-point operations of one element a PDAS round (g, the system and
# the active set about 16; a PCR step 12; the six trials 6 x 14; the step
# and the gap 20), for the operations bound.
K7_FLOPS_ROUND, K7_FLOPS_PCR_STEP = 120, 12


def log(msg):
    print(msg, flush=True)


def workload(m, n, seed=0):
    """The flagship generator (bench.py's lasso workload)."""
    rng = np.random.RandomState(seed)
    A = rng.randn(m, n) / np.sqrt(m)
    x0 = rng.randn(n) * (rng.rand(n) < 0.1)
    b = A @ x0 + 0.01 * rng.randn(m)
    lam = 0.1 * np.abs(A.T @ b).max()
    return A, b, lam


def lasso_objective(A, b, lam, x):
    return 0.5 * float(np.sum((A @ x - b) ** 2)) + lam * float(np.abs(x).sum())


def kkt_violation(A, b, lam, x):
    g = A.T @ (A @ x - b)
    r = np.where(x != 0, np.abs(g + lam * np.sign(x)),
                 np.maximum(np.abs(g) - lam, 0.0))
    return float(r.max() / lam)


def numpy_two_block(A, b, lam, tol=1e-12, max_iters=20000):
    """The reference's two-block sweep in f64 numpy, run to a tight
    tolerance (bench.py's CPU iteration)."""
    n = A.shape[1]
    F = scipy.linalg.cho_factor(A.T @ A + np.eye(n))
    Atb = A.T @ b
    z = u1 = u2 = x2 = np.zeros(n)
    for _ in range(max_iters):
        x1 = scipy.linalg.cho_solve(F, Atb + z - u1)
        v = z - u2
        x2 = np.sign(v) * np.maximum(np.abs(v) - lam, 0.0)
        z_prev, z = z, 0.5 * (x1 + u1 + x2 + u2)
        u1 = u1 + x1 - z
        u2 = u2 + x2 - z
        if np.linalg.norm(x1 - z) < tol and np.linalg.norm(z - z_prev) < tol:
            break
    return x2


def _timed(fn, reps, head_start, before=None, warmup=5):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if before is not None:
            before()
        if head_start:
            torch.cuda._sleep(HEAD_START_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps=50, before=None, warmup=5):
    """Median device milliseconds of fn(), from CUDA events, after
    ``warmup`` calls.  A spin kernel queued first keeps the card busy while
    the host enqueues fn, so the events bracket the device work only, not
    the launch overhead.  ``before()`` is queued ahead of the spin, outside
    the events."""
    return _timed(fn, reps, head_start=True, before=before, warmup=warmup)


def interleaved_ms(sides, rounds=AB_ROUNDS, reps=AB_REPS):
    """Time the callables of ``sides`` (a dict by name) in turns within this
    one process: every round runs them in the dict's order and then in
    reverse (library, kernel, kernel, library), one ``device_ms`` of
    ``reps`` calls each.  Returns ``{name: (median, min, max)}`` over the
    2 * rounds readings of each."""
    readings = {name: [] for name in sides}
    for _ in range(rounds):
        for name in list(sides) + list(sides)[::-1]:
            readings[name].append(device_ms(sides[name], reps=reps))
    return {name: (statistics.median(r), min(r), max(r)) for name, r in readings.items()}


def call_ms(fn, reps=50):
    """Median milliseconds of one call of fn() issued back to back, as the
    solver loop issues it: device time or host launch time, whichever is
    longer."""
    return _timed(fn, reps, head_start=False)


def bound(n_bytes, flops):
    """``(bound_ms, bound_by)``: the least time the card could take for
    ``n_bytes`` of memory traffic and ``flops`` float32 operations."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_kernel(sp):
    """Kernel against the plain version at n = 8192; returns the JSON
    record for the main path's shape (R = 1, f32)."""
    n, T = 8192, sp.SYM_TILE
    rng = np.random.RandomState(1)
    M = rng.standard_normal((n, n))
    M = M + M.T
    dev = torch.device("cuda")
    record = None
    for dtype, np_dtype in ((torch.float32, np.float32), (torch.float64, np.float64)):
        tiles_h, ii_h, jj_h, n_pad = sp.pack_sym_tiles(M, tile=T, dtype=np_dtype)
        tiles = torch.as_tensor(tiles_h, device=dev)
        ii = torch.as_tensor(ii_h, device=dev)
        jj = torch.as_tensor(jj_h, device=dev)
        row_ptr, entries = sp.sym_packed_plan(ii_h, jj_h, n_pad // T)
        plan = (torch.as_tensor(row_ptr, device=dev), torch.as_tensor(entries, device=dev))
        dense = torch.as_tensor(M, dtype=dtype, device=dev)
        for R in (1, 8):
            x = torch.as_tensor(rng.standard_normal((n_pad, R)), dtype=dtype, device=dev)
            y = sp.sym_packed_matmul(tiles, ii, jj, x, plan)
            y2 = sp.sym_packed_matmul(tiles, ii, jj, x, plan)
            ref = sp.sym_packed_matmul_reference(tiles, ii, jj, x)
            torch.cuda.synchronize()
            scale = ref.abs().max().item()
            err = (y - ref).abs().max().item()
            if not err <= KERNEL_RTOL[dtype] * scale:
                raise AssertionError(f"sym_packed {dtype} R={R}: max error {err} "
                                     f"> {KERNEL_RTOL[dtype]} * {scale}")
            if not torch.equal(y, y2):
                raise AssertionError(f"sym_packed {dtype} R={R}: two runs differ")
            kernel = lambda: sp.sym_packed_matmul(tiles, ii, jj, x, plan)
            plain = lambda: sp.sym_packed_matmul_reference(tiles, ii, jj, x)
            dense_mm = lambda: dense @ x
            ms, plain_ms, dense_ms = device_ms(kernel), device_ms(plain), device_ms(dense_mm)
            log(f"[2] sym_packed n={n} R={R} {str(dtype)[6:]}: max_abs_err={err:.3e} "
                f"(max|ref|={scale:.3e}, rtol {KERNEL_RTOL[dtype]:g}), bitwise repeatable; "
                f"device time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"dense matmul {dense_ms:.4f} ms; back-to-back per call: kernel "
                f"{call_ms(kernel):.4f} ms, dense matmul {call_ms(dense_mm):.4f} ms")
            if dtype == torch.float32 and R == 1:
                # y = M x from the packed tiles: tiles and x read, y written
                bound_ms, bound_by = bound(_nbytes(tiles, x, y), 2.0 * n * n * R)
                log(f"[2] sym_packed n={n} R={R} f32: bound {bound_ms:.4f} ms by {bound_by} "
                    f"({_nbytes(tiles, x, y)} bytes at {PEAK_BYTES_PER_S:.3g} B/s, "
                    f"{2.0 * n * n * R:.3g} operations at {PEAK_F32_FLOPS:.3g}/s): "
                    f"kernel at {bound_ms / ms:.2f} of it")
                record = {"name": "sym_packed_matmul", "route": "cuda",
                          "source": "epsilon_tpu_torch/csrc/sym_packed.cu",
                          "replaces": "epsilon_tpu/ops/pallas_kernels.py:175",
                          "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "library_ms": dense_ms}
        del tiles, dense
    return record


SOLVE = dict(rel_tol=1e-3, abs_tol=1e-6, rho=1.0)


def lasso_problem(ep, A, b, lam):
    x = ep.Variable(A.shape[1])
    return x, ep.Problem(ep.Minimize(
        0.5 * ep.sum_squares(ep._wrap(A) * x - b) + lam * ep.norm1(x)))


def checked_solution(tag, prob, x, obj, A, b, lam, f_ref=None):
    """The solution of a lasso solve that must have stopped ``optimal``,
    held to the f64 checks: finite, KKT/lambda <= KKT_TOL and, where the
    f64 reference objective is given, the objective within OBJ_RTOL of it.
    Returns ``(x, kkt)``."""
    st = prob.solver_status
    if prob.status != "optimal":
        raise AssertionError(f"{tag}: solver state {st.state} after {st.num_iterations} iterations")
    xv = np.asarray(x.value, dtype=np.float64).ravel()
    if xv.shape != (A.shape[1],) or not np.all(np.isfinite(xv)) or not np.isfinite(obj):
        raise AssertionError(f"{tag}: non-finite or misshapen solution")
    kkt = kkt_violation(A, b, lam, xv)
    if not kkt <= KKT_TOL:
        raise AssertionError(f"{tag}: optimality violation {kkt} > {KKT_TOL}")
    if f_ref is not None:
        gap = abs(lasso_objective(A, b, lam, xv) - f_ref) / abs(f_ref)
        if not gap <= OBJ_RTOL:
            raise AssertionError(f"{tag}: objective {lasso_objective(A, b, lam, xv)} vs f64 "
                                 f"reference {f_ref}: relative gap {gap} > {OBJ_RTOL}")
    return xv, kkt


def run_lasso(ep, tag, A, b, lam, steady_iters, f_ref=None, **params):
    """Solve through Problem.solve at rel_tol 1e-3 (``params`` over
    ``SOLVE``) and check the result in f64; then re-solve the same
    (warm-started) problem for a fixed count of iterations, whose time has
    no first-touch set-up in it.  Returns the solution, the first solve's
    iterations and the problem (whose cached solver is warm)."""
    params = dict(SOLVE, warm_start=True, **params)
    x, prob = lasso_problem(ep, A, b, lam)
    t0 = time.time()
    obj = prob.solve(**params)
    torch.cuda.synchronize()
    wall = time.time() - t0
    st = prob.solver_status
    xv, kkt = checked_solution(tag, prob, x, obj, A, b, lam, f_ref)
    init_s, solve_s = st.timing.init_usec / 1e6, st.timing.solve_usec / 1e6
    log(f"{tag}: optimal in {st.num_iterations} iterations, kkt {kkt:.2e} (tol {KKT_TOL:g}); "
        f"wall {wall:.3f} s = solver set-up {init_s:.3f} s + first solve {solve_s:.3f} s "
        f"(first-touch uploads included) + compile and write-back "
        f"{wall - init_s - solve_s:.3f} s")
    first_iters = st.num_iterations

    prob.solve(**dict(params, rel_tol=0.0, abs_tol=0.0, epoch_iterations=100,
                      max_iterations=steady_iters))
    torch.cuda.synchronize()
    st = prob.solver_status
    steady_s = st.timing.solve_usec / 1e6
    log(f"{tag}: steady {st.num_iterations} iterations in {steady_s:.4f} s: "
        f"{1e3 * steady_s / st.num_iterations:.4f} ms/iter, "
        f"{st.num_iterations / steady_s:.1f} iter/s")
    return xv, first_iters, prob


def cached_solver(prob):
    """The solver that ``Problem.solve(warm_start=True)`` keeps for
    ``prob``."""
    from epsilon_tpu_torch.frontend.solve import _PROBLEM_CACHE
    return _PROBLEM_CACHE[prob][1]


def phase_local_update(lu):
    """K1 against its plain version on every path a shape can take, and the
    interleaved A/B of kernel, streaming path and library call; returns the
    JSON records of the two shapes that main paths give it, by ``(S, n)``:
    the consensus row's (200, 200) in f32 (phase 6, the ring path) and one
    rank's quarter of it, (50, 200) in f32 (phase 9 (d), the streaming
    path)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    records = {}
    for S, n, dtypes in ((200, 200, (torch.float32, torch.float64)),
                         (K1_RANK_SHAPE[0], K1_RANK_SHAPE[1], (torch.float32,)),
                         (40, 5000, (torch.float32,)),
                         (8, 130, (torch.float32, torch.float64))):
        for dtype in dtypes:
            gen.manual_seed(2)
            Finv, Atb, u, z = (torch.randn(shape, generator=gen, device=dev, dtype=dtype)
                               for shape in ((S, n, n), (S, n), (S, n), (n,)))
            tag = f"local_update S={S} n={n} {str(dtype)[6:]}"
            lib = lu._library()
            # the plan the wrapper takes, and where that is the ring, the
            # streaming path (the earlier design) through the private launcher
            chosen = lu.plan_for(Finv, Atb, u, z)
            if (S, n) == K1_RANK_SHAPE and chosen.path != "stream":
                raise AssertionError(f"{tag}: the plan is {chosen}, not the streaming path "
                                     "that phase 9 (d) is held to")
            plans = {chosen.path: chosen}
            if chosen.path == "ring":
                plans["stream"] = lu.plan_for(Finv, Atb, u, z, aligned=False)
            errs = {}
            for path, plan in plans.items():
                run = ((lambda rho: lu.fused_local_update(Finv, Atb, u, z, rho))
                       if plan is chosen else
                       (lambda rho, plan=plan: lu._launch(plan, Finv, Atb, u, z, rho)))
                for rho in (1.0, 0.37):
                    x, xu = run(rho)
                    if lu.last_plan != plan:
                        raise AssertionError(f"{tag}: ran {lu.last_plan}, not {plan}")
                    x2, xu2 = run(rho)
                    x_ref, xu_ref = lu.local_update_reference(Finv, Atb, u, z, rho)
                    torch.cuda.synchronize()
                    for name, got, again, ref in (("x", x, x2, x_ref), ("xu_sum", xu, xu2, xu_ref)):
                        scale = ref.abs().max().item()
                        err = (got - ref).abs().max().item()
                        if not err <= LOCAL_RTOL[dtype] * scale:
                            raise AssertionError(f"{tag} {path} rho={rho} {name}: "
                                                 f"max error {err} > {LOCAL_RTOL[dtype]} * {scale}")
                        if not torch.equal(got, again):
                            raise AssertionError(f"{tag} {path} {name}: two runs differ")
                        errs[path] = max(errs.get(path, (0.0, 0.0)), (err, scale))
                    if rho == 1.0:
                        x_first = x
                if lu._library() is not lib or lu.build()[1] != 0.0 or torch.equal(x_first, x):
                    raise AssertionError(f"{tag} {path}: a new rho rebuilt the library or was ignored")
            kernel = lambda: lu.fused_local_update(Finv, Atb, u, z, 0.37)
            plain = lambda: lu.local_update_reference(Finv, Atb, u, z, 0.37)
            ms, plain_ms = device_ms(kernel), device_ms(plain)
            read_ms = device_ms(lambda: Finv.sum())
            # the library call that computes K1's function on the same
            # operands: bmm of the inverses with the right-hand side (made
            # beforehand), and the sum over blocks that K1 fuses
            rhs = (Atb + 0.37 * (z[None, :] - u)).unsqueeze(-1)
            library = lambda: (torch.bmm(Finv, rhs).squeeze(-1) + u).sum(dim=0)
            bmm_only_ms = device_ms(lambda: torch.bmm(Finv, rhs))
            library_ms = device_ms(library)
            gbps = Finv.numel() * Finv.element_size() / (ms * 1e6)
            n_bytes = _nbytes(Finv, Atb, u, z, x, xu)
            bound_ms, bound_by = bound(n_bytes, 2.0 * S * n * n)
            err, scale = errs[chosen.path]
            log(f"[5] {tag}: path {chosen.path} (rows {chosen.rows}, stages {chosen.stages}, "
                f"lanes {chosen.lanes}, {chosen.smem_bytes} B of shared memory, grid "
                f"{chosen.grid} over {chosen.items} items); max_abs_err={err:.3e} "
                f"(max|ref|={scale:.3e}, rtol {LOCAL_RTOL[dtype]:g}), bitwise repeatable, "
                f"rho 1.0 and 0.37 through one library"
                + "".join(f"; {path} path max_abs_err={e:.3e}, bitwise repeatable"
                          for path, (e, _) in errs.items() if path != chosen.path)
                + f"; device time: kernel {ms:.4f} ms "
                f"({gbps:.0f} GB/s on Finv), plain {plain_ms:.4f} ms, Finv.sum() {read_ms:.4f} ms, "
                f"torch.bmm + block sum {library_ms:.4f} ms (bmm alone {bmm_only_ms:.4f} ms); "
                f"bound {bound_ms:.4f} ms by {bound_by} ({n_bytes} bytes, "
                f"{2.0 * S * n * n:.3g} operations): kernel at {bound_ms / ms:.2f} of it; "
                f"back-to-back per call: kernel {call_ms(kernel):.4f} ms")
            # The interleaved A/B, so that a margin is read against the
            # spread.  Each call follows a call on the same operands, so at
            # (200, 200) in f32 Finv (32 MB of the 50 MB L2) is found warm
            # in L2, as the consensus loop finds it from one iteration to
            # the next; in f64 (64 MB) and at (40, 5000) it is not.
            sides = {"library": library, "kernel": kernel}
            if "stream" in plans:
                sides["stream"] = lambda: lu._launch(plans["stream"], Finv, Atb, u, z, 0.37)
            ab = interleaved_ms(sides)
            log(f"[5] {tag}: in turns, {2 * AB_ROUNDS} readings of {AB_REPS} calls each, "
                "median (min-max) ms: "
                + "; ".join(f"{name} {med:.4f} ({lo:.4f}-{hi:.4f})"
                            for name, (med, lo, hi) in ab.items())
                + f"; kernel / library {ab['kernel'][0] / ab['library'][0]:.4f}"
                + (f", kernel / stream {ab['kernel'][0] / ab['stream'][0]:.4f}"
                   if "stream" in ab else ""))
            if (S, n, dtype) == (200, 200, torch.float32):
                # one reading with Finv cold in L2: a buffer larger than L2
                # is written between the launches
                flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
                cold = {name: device_ms(fn, reps=AB_REPS, before=flush.zero_)
                        for name, fn in sides.items()}
                del flush
                log(f"[5] {tag}: L2 cold ({L2_FLUSH_BYTES >> 20} MB written between launches), "
                    "ms: " + "; ".join(f"{name} {t:.4f}" for name, t in cold.items()))
            if dtype == torch.float32 and (S, n) in ((200, 200), K1_RANK_SHAPE):
                records[S, n] = {"name": "fused_local_update", "route": "cuda",
                                 "source": "epsilon_tpu_torch/csrc/local_update.cu",
                                 "replaces": "epsilon_tpu/ops/pallas_kernels.py:72",
                                 "path": chosen.path, "shape": [S, n],
                                 "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": bound_ms, "bound_by": bound_by,
                                 "library_ms": library_ms}
            del rhs, sides
            del Finv, Atb, u, z
    return records


def numpy_consensus(A, b, lam, rho, iters):
    """The consensus lasso iteration in f64 numpy (explicit inverses, fixed
    rho), run for a fixed count of iterations; returns z."""
    S, m, n = A.shape
    A = A.astype(np.float64)
    b = b.astype(np.float64)
    At = A.transpose(0, 2, 1)
    Finv = np.linalg.inv(At @ A + rho * np.eye(n))
    Atb = (At @ b[:, :, None])[:, :, 0]
    thresh = lam / (S * rho)
    u = np.zeros((S, n))
    z = np.zeros(n)
    for _ in range(iters):
        x = (Finv @ (Atb + rho * (z[None, :] - u))[:, :, None])[:, :, 0]
        v = (x + u).mean(axis=0)
        z = np.sign(v) * np.maximum(np.abs(v) - thresh, 0.0)
        u = u + x - z[None, :]
    return z


def setup_pieces(A, b, rho):
    """The consensus lasso's explicit-inverse set-up, piece by piece, as
    ``consensus_lasso_solver`` runs it: upload, products on the card, host
    f64 inverses, upload of the inverses.  Returns seconds per piece."""
    t = [time.perf_counter()]
    A_d, b_d = torch.as_tensor(A, device="cuda"), torch.as_tensor(b, device="cuda")
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    AtA = torch.bmm(A_d.transpose(1, 2), A_d)
    torch.bmm(A_d.transpose(1, 2), b_d.unsqueeze(-1))
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    Finv = np.linalg.inv(AtA.cpu().to(torch.float64).numpy() + rho * np.eye(A.shape[2]))
    t.append(time.perf_counter())
    torch.as_tensor(Finv.astype(np.float32), device="cuda")
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    return dict(zip(("upload", "products", "host f64 inverses", "inverse upload"),
                    np.diff(t)))


def phase_consensus(lu):
    """bench.py's consensus row on the card; returns K1's launch count, the
    data, the converged z and the z after the first 500 cold iterations of
    the steady solver (phase 9 holds the meshed solves to them)."""
    from epsilon_tpu_torch.parallel import consensus_lasso_solver
    from epsilon_tpu_torch.problems.scaling_bench import make_blocks
    S, m, n, lam, rho = 200, 2500, 200, 0.1, 1.0
    t0 = time.time()
    A, b = make_blocks(S, m, n)
    log(f"[6] generated {S} blocks of {m}x{n} ({A.size:.2e} nonzeros) in {time.time() - t0:.2f} s")
    lu.launches = 0

    # (a) a solve to convergence.  At rel_tol 1e-4 the f32 solve stopped
    # after 20 iterations with KKT/lambda 1.26e-2 on an H100; 1e-5 takes
    # about 30 (4.5e-5 in f64 on the CPU).
    t0 = time.perf_counter()
    solver = consensus_lasso_solver(A, b, lam, rho=rho, rel_tol=1e-5, abs_tol=1e-8,
                                    max_iterations=2000)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if solver.local_update is None:
        raise AssertionError("consensus: the K1 path was not taken")
    t0 = time.perf_counter()
    res = solver.solve()
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    iters_run = res.iterations
    z = res.z.cpu().numpy().astype(np.float64)
    if not res.converged or z.shape != (n,) or not np.all(np.isfinite(z)):
        raise AssertionError(f"consensus: converged={res.converged} after {res.iterations} "
                             "iterations, or a non-finite or misshapen z")
    X = A.astype(np.float64).reshape(S * m, n)
    g = X.T @ (X @ z) - X.T @ b.astype(np.float64).ravel()
    kkt = float(np.where(z != 0, np.abs(g + lam * np.sign(z)),
                         np.maximum(np.abs(g) - lam, 0.0)).max() / lam)
    z_ref = numpy_consensus(A, b, lam, rho, res.iterations)
    dz = float(np.abs(z - z_ref).max())
    log(f"[6] consensus {S}x{m}x{n}: converged in {res.iterations} iterations "
        f"(rel_tol 1e-5), kkt {kkt:.2e} (tol {KKT_TOL:g}), {int((z != 0).sum())} nonzeros, "
        f"max|z - z_f64 iteration| {dz:.2e} (tol {CONSENSUS_Z_ATOL:g}); "
        f"set-up {setup_s:.3f} s, solve {solve_s:.3f} s")
    if not kkt <= KKT_TOL:
        raise AssertionError(f"consensus: optimality violation {kkt} > {KKT_TOL}")
    if not dz <= CONSENSUS_Z_ATOL:
        raise AssertionError(f"consensus: z differs from the f64 iteration by {dz} "
                             f"> {CONSENSUS_Z_ATOL}")
    pieces = setup_pieces(A, b, rho)
    log("[6] set-up pieces, timed apart: " + ", ".join(f"{k} {v:.3f} s" for k, v in pieces.items()))

    # (b) bench.py's steady row
    t0 = time.perf_counter()
    solver = consensus_lasso_solver(A, b, lam, rho=rho, rel_tol=0.0, abs_tol=0.0,
                                    max_iterations=CONSENSUS_STEADY_ITERS, epoch_iterations=50)
    torch.cuda.synchronize()
    setup2_s = time.perf_counter() - t0
    res = solver.solve()
    iters_run += res.iterations
    z_steady = res.z.cpu().numpy().astype(np.float64)
    ips = []
    for _ in range(CONSENSUS_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solver.solve()
        torch.cuda.synchronize()
        ips.append(res.iterations / (time.perf_counter() - t0))
        iters_run += res.iterations
    log(f"[6] steady: {CONSENSUS_REPS} re-solves of {CONSENSUS_STEADY_ITERS} iterations: "
        f"median {statistics.median(ips):.1f} iter/s (min {min(ips):.1f}, max {max(ips):.1f}; "
        f"{1e3 / statistics.median(ips):.4f} ms/iter); set-up {setup2_s:.3f} s")

    # (c) K1 ran every iteration
    launches = lu.launches
    if launches < iters_run:
        raise AssertionError(f"consensus: local_update launched {launches} times "
                             f"in {iters_run} iterations")
    if lu.last_plan.path != "ring":
        raise AssertionError(f"consensus: local_update took {lu.last_plan}, not the ring path")
    log(f"[6] local_update launches in the main path: {launches} ({iters_run} iterations), "
        f"path {lu.last_plan.path}")

    # (d) entry(): one epoch as a pure function of (data, state)
    from epsilon_tpu_torch.parallel import dryrun, entry
    fn, (data, state) = entry()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stepped = fn(data, state)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0)
    own = consensus_lasso_solver(*dryrun._consensus_data(4, 32, 16), lam=0.1, rho=1.0)
    epoch, _, _ = own._epoch(own.init_state())
    err = max(float((a - b_).abs().max()) for a, b_ in zip(stepped[:3], epoch[:3]))
    log(f"[6] entry(): one epoch of {own.epoch_iterations} iterations on "
        f"{tuple(data['Atb'].shape)} blocks in {step_ms:.3f} ms (first call); max|step - the "
        f"solver's own epoch| over x, u, z {err:.2e} (tol {ENTRY_ATOL:g})")
    if not (err <= ENTRY_ATOL and all(bool(torch.all(torch.isfinite(t))) for t in stepped[:3])):
        raise AssertionError(f"entry(): the step differs from the solver's epoch by {err}")
    return launches, (A, b, lam), z, z_steady


def _rel(violation, scale):
    return float(np.linalg.norm(violation) / max(1.0, float(np.linalg.norm(scale))))


def _normalized(m, n):
    A = np.random.randn(m, n)
    return A / np.sqrt(np.sum(A ** 2, 0))


def feasibility(name, kw, values):
    """Relative violation of a row's hard constraints in f64 numpy, from
    the row's data drawn again as its generator draws it (seed 0) and the
    variable values in creation order; None for rows without any."""
    np.random.seed(0)
    if name == "basis_pursuit":
        A = np.random.randn(kw["m"], kw["n"])
        b = (A @ scipy.sparse.rand(kw["n"], 1, 0.1).toarray()).ravel()
        return _rel(A @ values[0].ravel() - b, b)
    if name == "lp":
        A = np.abs(np.random.randn(kw["m"], kw["n"]))
        b = A.dot(np.abs(np.random.randn(kw["n"])))
        x = values[0].ravel()
        return max(_rel(A @ x - b, b), _rel(np.minimum(x, 0.0), x))
    if name == "portfolio":
        x = values[0].ravel()
        return max(abs(x.sum() - 1.0), _rel(np.minimum(x, 0.0), x))
    if name == "quantile":
        m, n, k, p = kw["m"], kw["n"], kw["k"], kw.get("p", 1)
        x = np.random.rand(m) * 2 * np.pi * p
        mu_rbf = np.array([np.linspace(-1, 2 * np.pi * p + 1, n)])
        mu_sig = (2 * np.pi * p + 2) / n
        X = np.exp(-(mu_rbf.T - x).T ** 2 / (2 * mu_sig ** 2))
        G = X @ (values[0][:, :-1] - values[0][:, 1:])
        return _rel(np.minimum(G, 0.0), X @ values[0])
    if name == "robust_pca":
        n = kw["n"]
        L0 = np.random.randn(n, 10) @ np.random.randn(10, n)
        S0 = scipy.sparse.rand(n, n, 0.1)
        S0.data = 10 * np.random.randn(len(S0.data))
        M = L0 + S0.toarray()
        return _rel(values[0] + values[1] - M, M)
    if name == "chebyshev":
        A = [_normalized(kw["m"], kw["n"]) for _ in range(10)]
        x, t = values[0].ravel(), values[1].ravel()
        norms = np.array([np.linalg.norm(Ai @ x) for Ai in A])
        return _rel(np.maximum(norms - t, 0.0), t)
    return None


@functools.cache
def _launch_floor_library():
    from epsilon_tpu_torch.ops.kernels import _rows
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    entries = {"row_launch_floor": [P], "grid_sync_floor": [I] * 3 + [P]}
    for t in ("f32", "f64"):
        entries[f"k6_chain_{t}"] = [P, "scalar", P, L, I, P]
        entries[f"epi_exp_chain_{t}"] = [P, P, P, L, I, I, P]
        entries[f"kl_div_chain_{t}"] = [P, P, "scalar", P, P, L, I, I, P]
        entries[f"inv_pos_chain_{t}"] = [P, "scalar", P, P, L, I, I, P]
        entries[f"w_log_w_chain_{t}"] = [P, "scalar", P, P, L, I, I, P]
        entries[f"cube_root_{t}"] = [P, P, L, P]
    return _rows.load("launch_floor", entries)


def launch_floor(t):
    """One launch of an empty kernel (``csrc/launch_floor.cu``, one block,
    as a one-row launch) on t's device and stream, through the per-row
    kernels' ctypes path: the least such a launch costs."""
    from epsilon_tpu_torch.ops.kernels import _rows
    _rows.launch("row_launch_floor", _launch_floor_library().row_launch_floor, (), t)


def row_kernels():
    """The per-row loop kernels of phase 7a (K3 (a), K3 (b), K4, K5), each
    as ``name -> dict``: its module and launch-count attribute, the kernel
    entry and its plain version (the same call signature ``(v, p)``, ``p``
    the per-row ``lam`` or ``s``), its full-count build (its loops run
    their counts), for K3 (a) ``wide`` (the same kernel one row a warp),
    the JAX function it stands for, the
    main path's shape (rows, n) in phase 7, and the length of the
    kernel's dependent chain in operations for those rows (see
    ``row_chain_ops``)."""
    from epsilon_tpu_torch.ops.kernels import epi_neg_log, epi_sum_square, lse_rows
    from epsilon_tpu_torch.ops.prox import elementwise, newton_epi, registry, vector
    return {
        "lse_prox_rows": dict(
            module=lse_rows, counter="prox_launches", kernel=lse_rows.prox_rows,
            plain=vector.prox_log_sum_exp_reference, param="lam", full=lse_rows.prox_rows_full,
            wide=lse_rows.prox_rows_wide, source="epsilon_tpu_torch/csrc/lse_rows.cu",
            replaces="epsilon_tpu/ops/prox/vector.py:153", main=(10000, 10), row="mnist"),
        "lse_epi_rows": dict(
            module=lse_rows, counter="epi_launches", kernel=lse_rows.epi_rows,
            plain=newton_epi.epi_log_sum_exp_reference, param="s", full=lse_rows.epi_rows_full,
            source="epsilon_tpu_torch/csrc/lse_rows.cu",
            replaces="epsilon_tpu/ops/prox/newton_epi.py:224", main=(100, 20),
            row="max_softmax"),
        "epi_sum_square_rows": dict(
            module=epi_sum_square, counter="launches", kernel=epi_sum_square.epi_rows,
            plain=registry._epi_sum_square_reference, param="s",
            full=epi_sum_square.epi_rows_full,
            source="epsilon_tpu_torch/csrc/epi_sum_square.cu",
            replaces="epsilon_tpu/ops/prox/registry.py:65", main=(1, 200),
            row="oneclass_svm"),
        "epi_neg_log_rows": dict(
            module=epi_neg_log, counter="launches", kernel=epi_neg_log.epi_rows,
            plain=elementwise.epi_sum_neg_log_reference, param="s", full=epi_neg_log.epi_rows_full,
            source="epsilon_tpu_torch/csrc/epi_neg_log.cu",
            replaces="epsilon_tpu/ops/prox/elementwise.py:231", main=(1, 10),
            row="max_gaussian"),
    }


def loop_kernels():
    """The hand kernels of phase 7a that are not per-row loops (K6
    ``sum_logistic_prox``, K7 ``tv1d_pdas``, K8 ``epi_exp``), each as
    ``name -> dict``: its module and launch-count attribute, source, the
    JAX function it stands for, the main path's shape, the library rows
    whose main path launches it in phase 7 (``rows``) and under each set of
    phase 7c (``sets``), and for K8 the phase 9 (f) family that runs it.
    K9-K11 run in no library row: K9's main path is phase 9 (f)'s
    two-argument family, K10's and K11's ``eval_prox`` of their kinds in
    phase 8 (g)."""
    from epsilon_tpu_torch.ops.kernels import (epi_exp, sum_inv_pos, sum_kl_div, sum_logistic,
                                               tv1d_pdas, w_log_w)
    logreg = ("logreg_l1", "logreg_l1_sparse")
    tv = ("tv_1d", "fused_lasso")
    return {
        "sum_logistic_prox": dict(
            module=sum_logistic, counter="launches",
            source="epsilon_tpu_torch/csrc/sum_logistic.cu",
            replaces="epsilon_tpu/ops/prox/elementwise.py:156", main=(1500,),
            rows=logreg, sets=dict.fromkeys(LIBRARY_SETS, logreg)),
        "tv1d_pdas": dict(
            module=tv1d_pdas, counter="launches", source="epsilon_tpu_torch/csrc/tv1d_pdas.cu",
            replaces="epsilon_tpu/ops/prox/tv1d.py:292", main=(100_000, 10_000),
            rows=tv, sets=dict.fromkeys(LIBRARY_SETS, tv)),
        "epi_exp": dict(
            module=epi_exp, counter="launches", source="epsilon_tpu_torch/csrc/epi_exp.cu",
            replaces="epsilon_tpu/ops/prox/elementwise.py:121", main=(K8_MAIN_N,),
            rows=(), sets={"no_epi": ("max_softmax",)}, family="epigraph_elementwise"),
        "sum_kl_div_prox": dict(
            module=sum_kl_div, counter="launches",
            source="epsilon_tpu_torch/csrc/sum_kl_div.cu",
            replaces="epsilon_tpu/ops/prox/elementwise.py:254", main=(K9_MAIN_N,),
            rows=(), sets={}, family="two_arg"),
        "sum_inv_pos_prox": dict(
            module=sum_inv_pos, counter="launches",
            source="epsilon_tpu_torch/csrc/sum_inv_pos.cu",
            replaces="epsilon_tpu/ops/prox/elementwise.py:179", main=(EVAL_PROX_N,),
            rows=(), sets={}),
        "w_log_w_prox": dict(
            module=w_log_w, counter="launches", source="epsilon_tpu_torch/csrc/w_log_w.cu",
            replaces="epsilon_tpu/ops/prox/elementwise.py:105 (SUM_EXP), :208 (SUM_NEG_ENTR)",
            main=(EVAL_PROX_N,), rows=(), sets={}),
    }


def counted_kernels():
    """``name -> (module, counter attribute)`` of every hand loop kernel
    (K3-K7), whose launches phases 7 and 7c count."""
    out = {name: (k["module"], k["counter"]) for name, k in row_kernels().items()}
    out.update({name: (k["module"], k["counter"]) for name, k in loop_kernels().items()})
    return out


def reset_launches():
    """Set every hand loop kernel's launch count to 0 in this process."""
    for module, counter in counted_kernels().values():
        setattr(module, counter, 0)


def row_chain_ops(name, n):
    """Operations on the longest dependent chain of one row of kernel
    ``name`` at width n, counting a log, an exp, a square root and a divide
    as one operation each (a lower bound).  A Lambert step of
    ``solve_w_log_w`` has 7 on its chain (log, add, subtract, multiply,
    divide, subtract, clamp); the prox's two bracket-end solves are
    independent, so its chain is 1 + 25 + 1 of 30 steps; the epigraph runs
    24 + 1 proxes in a row.  A warp sum adds 2 operations a butterfly
    level (5 levels); a Newton step of ``newton_safeguarded`` on a scalar
    about 9, a widening step of K4 about 6; one pass of K5's row about 7
    (square, add, root, add, scale, clamp, log) and its scalar step about
    6."""
    w_prox = 27 * 30 * 7 + 27 * 10
    if name == "lse_prox_rows":
        return w_prox
    if name == "lse_epi_rows":
        return 25 * (w_prox + 4 * 10 + 20)
    if name == "epi_sum_square_rows":
        return 3 * 10 + 40 * 6 + 25 * 9
    return 25 * (7 + 2 * 10 + 6)


def row_flops(name, rows, n):
    """Floating-point operations of one call over rows x n (a log, an exp,
    a root or a divide counted as one): 8 a Lambert step an element."""
    if name == "lse_prox_rows":
        return rows * n * 28 * 30 * 8
    if name == "lse_epi_rows":
        return rows * n * 25 * (28 * 30 * 8 + 30)
    if name == "epi_sum_square_rows":
        return rows * (2 * n + 40 * 8 + 25 * 20 + n)
    return rows * n * 25 * 12


def row_chain_taken(name, steps):
    """``row_chain_ops`` per row for the steps this run's rows took
    (``steps``: the kernel's step counts, rows x 4 as numpy): a Lambert
    step 7 operations on the chain, a pass of the prox 10 (its warp sum),
    and in K3 (b) each prox 60 more, in K5 each step 33; K4 the row's sum
    and write 30, a widening step 6 (its count under "nu") and a Newton
    step 9 (under "lam").  With the full counts it is ``row_chain_ops``."""
    lam, nu, chain = (steps[:, j].astype(np.int64) for j in range(3))
    if name == "lse_prox_rows":
        return 7 * chain + 10 * (nu + 2)
    if name == "lse_epi_rows":
        return 7 * chain + 10 * (nu + 2 * (lam + 1)) + 60 * (lam + 1)
    if name == "epi_sum_square_rows":
        return 30 + 6 * nu + 9 * lam
    return 33 * (lam + 1)


def steps_out_of_counts(kernel, steps, full_steps, n):
    """Rows (a numpy bool array) whose step counts leave their loops' counts.

    ``steps`` and ``full_steps`` are the counts (rows x 4, numpy) of
    ``kernel`` (``"lse_prox_rows"``, ``"lse_epi_rows"``,
    ``"epi_sum_square_rows"`` or ``"epi_neg_log_rows"``) and of its
    full-count build on the same rows of width ``n``.  The full-count build
    runs 24 steps on lam, 25 on nu a prox and 30 a Lambert solve (0 on an
    inactive row), the exit 1-24 on lam, 1-25 on nu a prox and at most 30 a
    solve; a lane solves its elements one after another, so a pass's chain
    holds up to 30 steps an element of the lane, and a prox has 28 passes,
    27 on the chain.  K4 counts 25 Newton steps under lam and 40 widening
    steps under nu, the exit 1-25 and 1-40."""
    steps = np.asarray(steps, dtype=np.int64).reshape(-1, 4)
    full = np.asarray(full_steps, dtype=np.int64).reshape(-1, 4)
    per_lane = -(-n // 32)
    if kernel == "epi_sum_square_rows":
        active = full[:, 0] != 0
        within = ((steps[:, 0] >= 1) & (steps[:, 0] <= 25) & (steps[:, 1] >= 1)
                  & (steps[:, 1] <= 40) & (steps[:, 2:] == 0).all(axis=1))
        ok = np.where(active, within, (steps == 0).all(axis=1))
        want_full = np.array([25, 40, 0, 0])
        return ~ok | (full != np.where(active[:, None], want_full[None], 0)).any(axis=1)
    if kernel == "lse_prox_rows":
        active = np.ones(len(full), dtype=bool)
        lam_ok = steps[:, 0] == 0
        proxes, full_proxes, full_lam = 1, 1, 0
    else:
        active = full[:, 0] != 0
        lam_ok = np.where(active, (steps[:, 0] >= 1) & (steps[:, 0] <= 24), steps[:, 0] == 0)
        proxes, full_proxes, full_lam = steps[:, 0] + 1, 25, 24
    if kernel == "epi_neg_log_rows":
        want_full = np.array([24, 0, 0, 0])
        ok = lam_ok & (steps[:, 1:] == 0).all(axis=1)
    else:
        want_full = np.array([full_lam, 25 * full_proxes, 27 * 30 * per_lane * full_proxes,
                              28 * 30 * n * full_proxes])
        nu, chain, elements = steps[:, 1], steps[:, 2], steps[:, 3]
        ok = lam_ok & np.where(active, (nu >= proxes) & (nu <= 25 * proxes)
                               & (chain <= 30 * per_lane * (nu + 2 * proxes))
                               & (elements <= 30 * n * (nu + 3 * proxes)) & (elements >= chain),
                               (steps == 0).all(axis=1))
    return ~ok | (full != np.where(active[:, None], want_full[None], 0)).any(axis=1)


def row_flops_taken(name, steps, n):
    """``row_flops`` for the steps this run's rows took: 8 a Lambert step
    of an element."""
    lam, nu, elements = (steps[:, j].astype(np.int64) for j in (0, 1, 3))
    if name == "lse_prox_rows":
        return int(8 * elements.sum())
    if name == "lse_epi_rows":
        return int(8 * elements.sum() + (n * (lam + 1) * 30).sum())
    if name == "epi_sum_square_rows":
        return int((3 * n + 8 * nu + 20 * lam).sum())
    return int((n * (lam + 1) * 12).sum())


def row_inputs(name, rows, n, dtype, seed, dev):
    """``(v, p)`` for kernel ``name``: v from a seed; ``p`` the per-row lam
    (log-uniform over 1e-3..1e3) or s, placed so that about a third of the
    rows are inactive (the point lies in the epigraph) and some bounds are
    negative, with row 0 active (the main path's one row, where it has
    one); K5's rows are positive but a quarter of them, which have a
    value <= 0 (outside the domain, so never inactive)."""
    rng = np.random.RandomState(seed)
    v = rng.standard_normal((rows, n)) * 2.0
    u = rng.uniform(-1.0, 1.0, rows)
    u[0] = -0.5
    if name == "lse_prox_rows":
        p = 10.0 ** (3.0 * u)
    elif name == "lse_epi_rows":
        m = v.max(axis=1)
        p = m + np.log(np.exp(v - m[:, None]).sum(axis=1)) + 3.0 * u - 1.0
    elif name == "epi_sum_square_rows":
        p = (v * v).sum(axis=1) * (1.25 * u + 0.25)
    else:
        v = np.abs(v) + 0.05
        v[rng.rand(rows) < 0.25, 0] *= -1.0
        p = -np.log(np.abs(v)).sum(axis=1) + 3.0 * u - 1.0
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    return as_t(v), as_t(p)


def band_inputs(name, rows, n, dtype, seed, dev):
    """LOG_SUM_EXP rows whose Lambert arguments at the solution fall in
    [-2.1, -0.5], where a solve can settle into a 3-cycle: q = W(e^c) drawn
    over [0.11, 0.40] (c = q + log q).  The prox's rows v = q + log q + 1 -
    log lam with lam = sum q (so nu = 0); the epigraph's v = x + q and s =
    LSE(x) - lam with x = log(q / lam) + a shift, whose projection is
    (x, s + lam)."""
    rng = np.random.RandomState(seed)
    q = rng.uniform(0.11, 0.40, (rows, n))
    lam = q.sum(axis=1)
    if name == "lse_prox_rows":
        v, p = q + np.log(q) + 1.0 - np.log(lam)[:, None], lam
    else:
        x = np.log(q / lam[:, None]) + rng.uniform(-2.0, 2.0, (rows, 1))
        m = x.max(axis=1)
        v, p = x + q, m + np.log(np.exp(x - m[:, None]).sum(axis=1)) - lam
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    return as_t(v), as_t(p)


def special_inputs(name, rows, n, dtype, seed, dev):
    """``row_inputs`` with rows holding a NaN, +inf, -inf, 0, -0 and a
    negative value (K5's domain test), and rows whose bound is NaN, +inf,
    -inf or 0 (rows >= 10)."""
    v, p = (a.cpu().numpy() for a in row_inputs(name, rows, n, torch.float64, seed, "cpu"))
    values = (np.nan, np.inf, -np.inf, 0.0, -0.0, -1.5)
    for r, value in enumerate(values):
        v[r, r % n] = value
    for r, value in enumerate((np.nan, np.inf, -np.inf, 0.0)):
        p[len(values) + r] = value
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    return as_t(v), as_t(p)


def same_bits(a, b):
    """Bitwise equality of two tensors (NaN payloads and signed zeros
    included): ``torch.equal`` on their integer views."""
    ints = {4: torch.int32, 8: torch.int64}
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(ints[a.element_size()]), b.view(ints[b.element_size()])))


def exit_check(name, k, v, p, label):
    """The kernel against its full-count build on (v, p): bitwise equal
    results, the same as without counting steps, and step counts within the
    loops' counts.  Returns ``(steps, full_steps)`` as numpy, rows x 4."""
    batch = tuple(v.shape[:-1])
    steps = torch.zeros(batch + (4,), dtype=torch.int32, device=v.device)
    full_steps = torch.zeros_like(steps)
    plain_out = k["kernel"](v, p)
    out = k["kernel"](v, p, steps=steps)
    full = k["full"](v, p, steps=full_steps)
    torch.cuda.synchronize()
    out, full, plain_out = [o if isinstance(o, tuple) else (o,) for o in (out, full, plain_out)]
    if not all(same_bits(a, b) and same_bits(a, c) for a, b, c in zip(out, full, plain_out)):
        raise AssertionError(f"{name} {label}: the kernel differs from its full-count build")
    steps, full_steps = (a.cpu().numpy().reshape(-1, 4) for a in (steps, full_steps))
    bad = np.flatnonzero(steps_out_of_counts(name, steps, full_steps, v.shape[-1]))[:3]
    if len(bad):
        raise AssertionError(f"{name} {label}: step counts out of their loops' counts in rows "
                             f"{bad.tolist()}: {steps[bad].tolist()}, full count "
                             f"{full_steps[bad].tolist()}")
    return steps, full_steps


def wide_check(name, k, v, p, label):
    """K3's prox (two rows of up to 16 a warp) against the same kernel one
    row a warp (``k["wide"]``) on (v, p): the same step counts and the same
    bits, but where both hold a zero of another sign.  Returns the rows
    with such zeros (the layouts' butterflies agree on them by design, so
    none is expected)."""
    steps = torch.zeros(tuple(v.shape[:-1]) + (4,), dtype=torch.int32, device=v.device)
    wide_steps = torch.zeros_like(steps)
    out = k["kernel"](v, p, steps=steps)
    wide = k["wide"](v, p, steps=wide_steps)
    torch.cuda.synchronize()
    if not torch.equal(steps, wide_steps):
        raise AssertionError(f"{name} {label}: step counts differ from one row a warp's")
    ints = {4: torch.int32, 8: torch.int64}[out.element_size()]
    differ = out.view(ints) != wide.view(ints)
    if (differ & ~((out == 0) & (wide == 0))).any():
        rows = torch.nonzero(differ.reshape(-1, v.shape[-1]).any(dim=1)).flatten()[:3]
        raise AssertionError(f"{name} {label}: differs from one row a warp in rows "
                             f"{rows.tolist()}")
    return torch.nonzero(differ.reshape(-1, v.shape[-1]).any(dim=1)).flatten().tolist()


def half_warp_checks(name, k, dtype, dev, main_in):
    """Phase 7a's checks of K3's half-warp prox in one dtype: bitwise
    against one row a warp (``wide_check``) and against its full-count
    build (``exit_check``) at ``HALF_WARP_WIDTHS`` on an odd row count, on
    the band and special rows at mnist's width, and on mnist's rows."""
    main_rows, main_n = k["main"]
    cases = [(f"{HALF_WARP_ROWS}x{n}", row_inputs(name, HALF_WARP_ROWS, n, dtype, 100 + n, dev))
             for n in HALF_WARP_WIDTHS]
    cases += [(f"special {HALF_WARP_ROWS}x{main_n}",
               special_inputs(name, HALF_WARP_ROWS, main_n, dtype, 7, dev)),
              (f"band {HALF_WARP_ROWS}x{main_n}",
               band_inputs(name, HALF_WARP_ROWS, main_n, dtype, 7, dev)),
              (f"{main_rows}x{main_n}", main_in)]
    zeros = {}
    for label, (v, p) in cases:
        exit_check(name, k, v, p, f"{label} {dtype}")
        rows = wide_check(name, k, v, p, f"{label} {dtype}")
        if rows:
            zeros[label] = rows
    log(f"[7a] {name} {str(dtype)[6:]}: two rows a warp bitwise equal to one row a warp "
        "(results and step counts) and to the full-count build on "
        + ", ".join(label for label, _ in cases) + "; rows differing only in a zero's sign: "
        + (", ".join(f"{label} rows {rows}" for label, rows in zeros.items()) or "none"))


def half_warp_occupancy(name, k, v, p):
    """The resident warps a SM and the waves the main path's shape (v, p)
    takes for K3's prox in both layouts (``lse_rows.resident_warps``), and
    the share of one row a warp's work that two rows a warp issue: a warp
    runs while either of its rows steps, so it issues the longer of the
    two rows' chains (``row_chain_taken``) for both."""
    main_rows, main_n = k["main"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    parts = []
    for wide, label in ((False, "two rows a warp"), (True, "one row a warp")):
        warps = k["module"].resident_warps(v.dtype, main_n, wide)
        need = -(-main_rows // (1 if wide or main_n > 16 else 2))
        parts.append(f"{label}: {warps} warps a SM, {need} warps, "
                     f"{need / (warps * sms):.2f} waves")
    steps = torch.zeros(main_rows, 4, dtype=torch.int32, device=v.device)
    k["kernel"](v, p, steps=steps)
    chain = row_chain_taken(name, steps.cpu().numpy())
    pairs = np.concatenate([chain, chain[-1:]] if len(chain) % 2 else [chain]).reshape(-1, 2)
    return (f"{sms} SMs; " + "; ".join(parts) + "; the warps' longer chains of two rows sum "
            f"to {pairs.max(axis=1).sum() / chain.sum():.3f} of the rows' chains")


def phase_row_kernels(card):
    """Phase 7a: K3 (a), K3 (b), K4 and K5 against their plain versions on
    the card, at the main path's shapes and at odd widths, f32 and f64,
    with active and inactive rows; bitwise repeatability; each bitwise
    against its full-count build there and on the band and special rows
    (``exit_check``), K3 (a) also against one row a warp
    (``half_warp_checks``); device times of the kernel and the plain
    version at the main path's shape in f32 beside the launch floor, and
    the A/B against the builds it replaces (``exit_ab``).  Returns the
    ``kernels`` records (their launches are set after phase 7)."""
    from epsilon_tpu_torch.ops.kernels._rows import STEP_COUNTS
    dev = torch.device("cuda")
    clock_hz = 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0])
    anchor = torch.empty(1, device=dev)
    launch_floor(anchor)   # loads the library outside the timing
    floor_ms = device_ms(lambda: launch_floor(anchor))
    log(f"[7a] launch floor: an empty kernel (one block of 128 threads) through the same "
        f"ctypes path, {floor_ms:.4f} ms (device time, median of 50); {card}")
    records = {}
    for name, k in row_kernels().items():
        main_rows, main_n = k["main"]
        shapes = [k["main"]] + [(64 if main_rows > 1 else 8, n) for n in ROW_WIDTHS]
        for dtype in (torch.float32, torch.float64):
            for seed, (rows, n) in enumerate(shapes):
                v, p = row_inputs(name, rows, n, dtype, seed, dev)
                if (rows, n) == k["main"] and main_rows == 1:
                    v, p = v[0], p[0]    # the main path's one vector and 0-d bound
                out = k["kernel"](v, p)
                out2 = k["kernel"](v, p)
                ref = k["plain"](v, p)
                torch.cuda.synchronize()
                out, out2, ref = [o if isinstance(o, tuple) else (o,) for o in (out, out2, ref)]
                if not all(torch.equal(a, b) for a, b in zip(out, out2)):
                    raise AssertionError(f"{name} {(rows, n)} {dtype}: two runs differ")
                err = max((a - b).abs().max().item() for a, b in zip(out, ref))
                scale = max(1.0, max(b.abs().max().item() for b in ref))
                finite = all(torch.isfinite(a).all().item() for a in out)
                if not (finite and err <= ROW_RTOL[dtype] * scale):
                    raise AssertionError(f"{name} {(rows, n)} {dtype}: max error {err} "
                                         f"> {ROW_RTOL[dtype]} * {scale} (finite {finite})")
                inactive = ""
                if len(out) == 2:
                    same = (out[0] == v).all(dim=-1).reshape(-1)
                    inactive = f", {int(same.sum())} of {rows} rows inactive"
                exits = ""
                steps, _ = exit_check(name, k, v, p, f"{rows}x{n} {dtype}")
                exits = (f"; bitwise equal to its full-count build, steps (mean) "
                         + ", ".join(f"{c} {steps[:, j].mean():.1f}"
                                     for j, c in enumerate(STEP_COUNTS) if steps[:, j].any()))
                log(f"[7a] {name} {rows}x{n} {str(dtype)[6:]}: max_abs_err={err:.3e} "
                    f"(scale {scale:.3e}, rtol {ROW_RTOL[dtype]:g}), bitwise repeatable"
                    f"{inactive}{exits}")
                if (rows, n) == k["main"]:
                    main_in_dtype = (v, p)
                    if dtype == torch.float32:
                        main_err, main_in = err, (v, p)
            if "wide" in k:
                half_warp_checks(name, k, dtype, dev, main_in_dtype)
            # the exit's hard cases: the 3-cycle band, non-finite and <= 0 values
            checked = []
            for n in sorted({main_n, 33, 257}):
                rows = max(main_rows, 16) if n == main_n else 16
                cases = [("special", special_inputs(name, rows, n, dtype, n, dev))]
                if name.startswith("lse"):
                    cases.append(("band", band_inputs(name, rows, n, dtype, n, dev)))
                for label, (v, p) in cases:
                    exit_check(name, k, v, p, f"{label} {rows}x{n} {dtype}")
                    checked.append(f"{label} {rows}x{n}")
            log(f"[7a] {name} {str(dtype)[6:]}: bitwise equal to its full-count build on "
                + ", ".join(checked) + " (NaN, inf, -inf, 0, -0 and negative values and "
                "bounds; the band: Lambert arguments in [-2.1, -0.5])")
        v, p = main_in
        kernel = lambda: k["kernel"](v, p)
        plain = lambda: k["plain"](v, p)
        ms = device_ms(kernel)
        plain_ms = (device_ms(plain, reps=ROW_PLAIN_REPS[name], warmup=1)
                    if name in ROW_PLAIN_REPS else device_ms(plain))
        out = kernel()
        out = out if isinstance(out, tuple) else (out,)
        n_bytes = _nbytes(v, p, *out)
        chain_ms = 1e3 * row_chain_ops(name, main_n) * ROW_CYCLES_PER_OP / clock_hz
        flops = row_flops(name, main_rows, main_n)
        bound_ms, bound_by = bound(n_bytes, flops)
        if chain_ms > bound_ms:
            bound_ms, bound_by = chain_ms, "operations"
        log(f"[7a] {name} {main_rows}x{main_n} f32 ({k['row']}'s shape): kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms (device time, median of 50"
            + (f"; the plain version's of {ROW_PLAIN_REPS[name]}" if name in ROW_PLAIN_REPS
               else "") + f"); bound {bound_ms:.4f} ms by {bound_by} ({n_bytes} bytes, "
            f"{flops:.3g} operations, a chain of {row_chain_ops(name, main_n)} dependent "
            f"operations at {ROW_CYCLES_PER_OP} cycles and {clock_hz / 1e6:.0f} MHz: "
            f"{chain_ms:.4f} ms); kernel at {bound_ms / ms:.2f} of it; launch floor "
            f"{floor_ms:.4f} ms; {card}")
        if "wide" in k:
            log(f"[7a] {name} {main_rows}x{main_n} f32 occupancy: "
                + half_warp_occupancy(name, k, v, p))
        records[name] = {"name": name, "route": "cuda", "source": k["source"],
                         "replaces": k["replaces"], "max_abs_err": main_err, "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": None, "floor_ms": floor_ms}
        records[name].update(exit_ab(name, k, v, p, n_bytes, clock_hz, card))
    loops = loop_kernels()
    records["sum_logistic_prox"] = phase_sum_logistic(loops["sum_logistic_prox"], card,
                                                      floor_ms)
    records["tv1d_pdas"] = phase_tv1d(loops["tv1d_pdas"], card)
    records["epi_exp"] = phase_epi_exp(loops["epi_exp"], card, floor_ms)
    records.update(phase_element_loops(loops, card, floor_ms))
    return records


def exit_ab(name, k, v, p, n_bytes, clock_hz, card):
    """The kernel, its full-count build and (K3 (a)) the same kernel one
    row a warp at the main path's shape in f32, timed in turns
    (``interleaved_ms``), and the bound for the steps this run's rows took
    (``row_chain_taken``, ``row_flops_taken``) beside the full-count
    bound.  Returns the record's added fields."""
    from epsilon_tpu_torch.ops.kernels._rows import STEP_COUNTS
    main_rows, main_n = k["main"]
    sides = {"exit": lambda: k["kernel"](v, p), "full": lambda: k["full"](v, p)}
    if "wide" in k:
        sides["wide"] = lambda: k["wide"](v, p)
    ab = interleaved_ms(sides)
    steps, full_steps = exit_check(name, k, v, p, "main f32")
    chain = row_chain_taken(name, steps)
    if row_chain_taken(name, full_steps).max() != row_chain_ops(name, main_n):
        raise AssertionError(f"{name}: the full-count steps give a chain of "
                             f"{row_chain_taken(name, full_steps).max()} operations, "
                             f"not {row_chain_ops(name, main_n)}")
    longest = int(np.argmax(chain))
    chain_ms = 1e3 * int(chain[longest]) * ROW_CYCLES_PER_OP / clock_hz
    flops = row_flops_taken(name, steps, main_n)
    bound_taken_ms, by = bound(n_bytes, flops)
    if chain_ms > bound_taken_ms:
        bound_taken_ms, by = chain_ms, "operations"
    taken = {c: int(steps[longest, j]) for j, c in enumerate(STEP_COUNTS)}
    (med, lo, hi), (f_med, f_lo, f_hi) = ab["exit"], ab["full"]
    wide = ""
    if "wide" in ab:
        w_med, w_lo, w_hi = ab["wide"]
        wide = (f", one row a warp {w_med:.4f} ms ({w_lo:.4f}-{w_hi:.4f}), ratio "
                f"{med / w_med:.3f}")
    log(f"[7a] {name} {main_rows}x{main_n} f32 in turns ({AB_ROUNDS} rounds, "
        f"{', '.join(sides)}, then in reverse; {AB_REPS} calls a reading): exit {med:.4f} ms "
        f"({lo:.4f}-{hi:.4f}), full count {f_med:.4f} ms ({f_lo:.4f}-{f_hi:.4f}), ratio "
        f"{med / f_med:.3f}{wide}; "
        f"steps taken on the longest chain (row {longest}) {taken}, a chain of "
        f"{int(chain[longest])} operations ({chain_ms:.4f} ms), {flops:.3g} operations: "
        f"bound for the steps taken {bound_taken_ms:.4f} ms by {by}, kernel at "
        f"{bound_taken_ms / med:.2f} of it; {card}")
    fields = {"full_count_ms": f_med,
              "ab_ms": {"exit": ab["exit"], "full_count": ab["full"]},
              "steps_taken": taken, "bound_taken_ms": bound_taken_ms}
    if "wide" in ab:
        fields["one_row_a_warp_ms"] = ab["wide"][0]
        fields["ab_ms"]["one_row_a_warp"] = ab["wide"]
    return fields


def k6_chain_ms(v, lam, steps):
    """Device ms of ``launch_floor.cu`` ``k6_chain`` over v's elements with
    lam a number: each thread runs ``steps`` dependent steps of K6's
    arithmetic, launched as K6 launches, the launch included."""
    from epsilon_tpu_torch.ops.kernels import _rows
    fn = getattr(_launch_floor_library(), f"k6_chain_{_rows.suffix(v)}")
    x = torch.empty_like(v)
    return device_ms(lambda: _rows.launch("k6_chain", fn, (v.data_ptr(), float(lam),
                                                          x.data_ptr(), v.numel(), steps), v))


def k8_chain_ms(v, s, widen, newton):
    """Device ms of ``launch_floor.cu`` ``epi_exp_chain`` over the elements
    of (v, s): ``widen`` steps of K8's widening and ``newton`` Newton steps
    a thread, launched as K8 launches, the launch included."""
    from epsilon_tpu_torch.ops.kernels import _rows
    fn = getattr(_launch_floor_library(), f"epi_exp_chain_{_rows.suffix(v)}")
    s = torch.broadcast_to(torch.as_tensor(s, dtype=v.dtype, device=v.device),
                           v.shape).contiguous()
    x = torch.empty_like(v)
    return device_ms(lambda: _rows.launch("epi_exp_chain", fn, (
        v.data_ptr(), s.data_ptr(), x.data_ptr(), v.numel(), widen, newton), v))


def same_values(a, b):
    """Equal values with NaN in the same places (a NaN's payload and the
    sign of a zero aside): how a kernel is held to its plain version on
    special values, where the plain version's torch.maximum passes a NaN
    operand through and the kernel's arithmetic makes the card's own."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all()))


def k6_inputs(n, dtype, seed, dev, lam_kind):
    """``(v, lam)`` for K6: v uniform over +-K6_V_RANGE; lam log-uniform
    over 10^K6_LAM_EXP, as a number, a 0-d tensor on the card or one value
    an element."""
    rng = np.random.RandomState(seed)
    v = torch.as_tensor(rng.uniform(-K6_V_RANGE, K6_V_RANGE, n), dtype=dtype, device=dev)
    lam = 10.0 ** rng.uniform(*K6_LAM_EXP, n)
    if lam_kind == "number":
        return v, float(lam[0])
    if lam_kind == "0-d":
        return v, torch.tensor(lam[0], dtype=dtype, device=dev)
    return v, torch.as_tensor(lam, dtype=dtype, device=dev)


def k6_special(dtype, dev):
    """Every pair of the values NaN, +-inf, 0, -0, +-1e30, +-1e-30, 1 and
    -7.5 for v and of NaN, inf, 0, -0, -1, 1e-30, 1, 1e30 for lam."""
    vs = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e30, -1e30, 1e-30, -1e-30, 1.0, -7.5]
    lams = [np.nan, np.inf, 0.0, -0.0, -1.0, 1e-30, 1.0, 1e30]
    v, lam = np.meshgrid(np.array(vs), np.array(lams), indexing="ij")
    as_t = lambda a: torch.as_tensor(a.ravel(), dtype=dtype, device=dev)
    return as_t(v), as_t(lam)


def k6_check(k6, plain, v, lam, label, special=False):
    """K6 on (v, lam): two runs and the full-count build bitwise equal (so
    the exit returns the full count's state) and equal to the plain
    version, bitwise (``same_values`` on the special values), its steps
    within 1..STEPS and the full count's all STEPS; returns ``(x, steps)``."""
    steps = torch.zeros(v.shape, dtype=torch.int32, device=v.device)
    full_steps = torch.zeros_like(steps)
    x = k6.prox(v, lam, steps=steps)
    x2 = k6.prox(v, lam)
    full = k6.prox_full(v, lam, steps=full_steps)
    ref = plain(v, lam)
    torch.cuda.synchronize()
    if not (same_bits(x, x2) and same_bits(x, full)):
        raise AssertionError(f"sum_logistic_prox {label}: differs from its full-count build "
                             "or from a second run")
    if not (same_values(x, ref) if special else same_bits(x, ref)):
        raise AssertionError(f"sum_logistic_prox {label}: differs from the plain version")
    if not (bool(((steps >= 1) & (steps <= k6.STEPS)).all())
            and bool((full_steps == k6.STEPS).all())):
        raise AssertionError(f"sum_logistic_prox {label}: steps out of 1..{k6.STEPS}")
    return x, steps


def phase_sum_logistic(k, card, floor_ms):
    """Phase 7a's K6: bitwise against its full-count build and its plain
    version at the main path's 1,500 elements and at K6_SIZES, f32 and
    f64, lam a number, a 0-d tensor on the card and one an element, and on
    the special values; timed at the main path's shape in f32 (kernel and
    full count in turns, plain, launch floor) beside its bound, the
    measured chain of the steps its longest element ran (``k6_chain_ms``).
    Returns the ``kernels`` record."""
    from epsilon_tpu_torch.ops.kernels import sum_logistic as k6
    from epsilon_tpu_torch.ops.prox import elementwise
    plain = elementwise.prox_sum_logistic_reference
    dev = torch.device("cuda")
    (main_n,) = k["main"]
    for dtype in (torch.float32, torch.float64):
        parts = []
        for seed, n in enumerate((main_n,) + K6_SIZES):
            for lam_kind in ("number", "0-d", "element"):
                v, lam = k6_inputs(n, dtype, seed, dev, lam_kind)
                x, steps = k6_check(k6, plain, v, lam, f"{n} {lam_kind} {dtype}")
                if n == main_n and lam_kind == "number" and dtype == torch.float32:
                    main_err = 0.0
                parts.append(f"{n} lam {lam_kind}: steps {steps.float().mean().item():.1f} mean, "
                             f"{int(steps.max())} most")
        v, lam = k6_special(dtype, dev)
        k6_check(k6, plain, v, lam, f"special {dtype}", special=True)
        log(f"[7a] sum_logistic_prox {str(dtype)[6:]}: bitwise repeatable and equal to its "
            f"full-count build and to the plain version; Newton steps: " + "; ".join(parts)
            + "; the special values (NaN, inf, 0, -0, +-1e30, lam <= 0) bitwise equal to the "
            "full-count build, equal values to the plain version")
    v, lam = k6_inputs(main_n, torch.float32, 0, dev, "number")
    ms = device_ms(lambda: k6.prox(v, lam))
    plain_ms = device_ms(lambda: plain(v, lam), reps=10, warmup=1)
    ab = interleaved_ms({"exit": lambda: k6.prox(v, lam), "full": lambda: k6.prox_full(v, lam)})
    steps = torch.zeros(main_n, dtype=torch.int32, device=dev)
    x = k6.prox(v, lam, steps=steps)
    taken = int(steps.max())
    n_bytes = _nbytes(v, x)
    flops = 20 * int(steps.sum()) + 10 * main_n
    # the chain: the start (x0, whose sigmoid runs beside the bracket ends'
    # g) as one step, then the longest element's Newton steps
    chain_ms = k6_chain_ms(v, lam, taken + 1)
    full_chain_ms = k6_chain_ms(v, lam, k6.STEPS + 1)
    bound_ms, bound_by = bound(n_bytes, flops)
    if chain_ms > bound_ms:
        bound_ms, bound_by = chain_ms, "operations"
    (med, lo, hi), (f_med, f_lo, f_hi) = ab["exit"], ab["full"]
    log(f"[7a] sum_logistic_prox {main_n} f32 (logreg_l1's shape, lam a number, "
        f"{k6.threads(main_n)} threads a block): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
        f"(device time, medians of 50 and 10); in turns ({AB_ROUNDS} rounds of {AB_REPS} "
        f"calls): exit {med:.4f} ms ({lo:.4f}-{hi:.4f}), full count {f_med:.4f} ms "
        f"({f_lo:.4f}-{f_hi:.4f}), ratio {med / f_med:.3f}; steps "
        f"{steps.float().mean().item():.1f} mean, {taken} on the longest chain; the measured "
        f"chain of {taken} + 1 steps {chain_ms:.4f} ms (launch_floor.cu k6_chain, launch "
        f"included; of the full count's {k6.STEPS} + 1: {full_chain_ms:.4f}); bound "
        f"{bound_ms:.4f} ms by {bound_by} ({n_bytes} bytes, {flops:.3g} operations), kernel at "
        f"{bound_ms / med:.2f} of it; launch floor {floor_ms:.4f} ms; no PyTorch call computes "
        f"this function; {card}")
    return {"name": "sum_logistic_prox", "route": "cuda", "source": k["source"],
            "replaces": k["replaces"], "max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None, "floor_ms": floor_ms,
            "chain_ms": chain_ms, "full_count_chain_ms": full_chain_ms,
            "full_count_ms": f_med, "ab_ms": {"exit": ab["exit"], "full_count": ab["full"]},
            "steps_taken": taken}


def k8_inputs(n, dtype, seed, dev, s_kind="element"):
    """``(v, s)`` for K8: v uniform over +-K8_V_RANGE; s = e^v 10^u with u
    uniform over +-K8_S_DECADES (about half the elements inactive, e^v <=
    s), and every tenth element's s <= 0 (0, -0 or -e^v 10^u); s one an
    element or (``"number"``) the first element's as a number."""
    rng = np.random.RandomState(seed)
    v = rng.uniform(-K8_V_RANGE, K8_V_RANGE, n)
    s = np.exp(v) * 10.0 ** rng.uniform(-K8_S_DECADES, K8_S_DECADES, n)
    nonpos = np.arange(n) % 10 == 3
    s[nonpos] = np.choose(np.arange(nonpos.sum()) % 3, [np.zeros(nonpos.sum()),
                                                         -np.zeros(nonpos.sum()), -s[nonpos]])
    v = torch.as_tensor(v, dtype=dtype, device=dev)
    if s_kind == "number":
        return v, float(s[0])
    return v, torch.as_tensor(s, dtype=dtype, device=dev)


def k8_special(dtype, dev):
    """Every pair of the values NaN, +-inf, 0, -0, +-1e30, 1, -1 and 50 for
    v and for s."""
    vals = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e30, -1e30, 1.0, -1.0, 50.0])
    v, s = np.meshgrid(vals, vals, indexing="ij")
    as_t = lambda a: torch.as_tensor(a.ravel(), dtype=dtype, device=dev)
    return as_t(v), as_t(s)


def k8_kkt(v, s, x, t):
    """The projection of (v, s) onto {e^x <= t} tested in f64 numpy, apart
    from the kernel: inactive elements (e^v <= s) returned as they came;
    active ones on the boundary (t = e^x), feasible, x <= v, mu = t - s >=
    0 and stationary (x + mu e^x = v), each relative to the scale of its
    terms.  Returns the largest relative violation."""
    v, s, x, t = (np.asarray(a.double().cpu().numpy(), dtype=np.float64)
                  for a in torch.broadcast_tensors(v, torch.as_tensor(s, dtype=v.dtype,
                                                                        device=v.device), x, t))
    inactive = np.exp(v) <= s
    worst = float(np.abs(np.where(inactive, x - v, 0.0)).max()
                  + np.abs(np.where(inactive, t - s, 0.0)).max())
    a = ~inactive
    ex = np.exp(x[a])
    mu = t[a] - s[a]
    scale = np.maximum.reduce([np.ones_like(ex), np.abs(v[a]), ex * ex, np.abs(s[a]) * ex])
    for r in (np.abs(t[a] - ex) / np.maximum(1.0, ex),
              np.maximum(x[a] - v[a], 0.0) / np.maximum(1.0, np.abs(v[a])),
              np.maximum(-mu, 0.0) / np.maximum(1.0, np.maximum(np.abs(s[a]), t[a])),
              np.abs(x[a] + mu * ex - v[a]) / scale):
        if r.size:
            worst = max(worst, float(r.max()))
    return worst


def k8_check(k8, plain, v, s, label, special=False):
    """K8 on (v, s): two runs and the full-count build bitwise equal (so
    the exits return the full counts' states) and equal to the plain
    version, bitwise (``same_values`` on the special values); its widening
    steps within 1..WIDEN_STEPS, its Newton steps within 4..NEWTON_STEPS,
    the full count's all both counts.  Returns ``((x, t), steps)``."""
    shape = tuple(torch.broadcast_shapes(v.shape, torch.as_tensor(s).shape)) + (2,)
    steps = torch.zeros(shape, dtype=torch.int32, device=v.device)
    full_steps = torch.zeros_like(steps)
    out = k8.epi(v, s, steps=steps)
    out2 = k8.epi(v, s)
    full = k8.epi_full(v, s, steps=full_steps)
    ref = plain(v, s)
    torch.cuda.synchronize()
    if not all(same_bits(a, b) and same_bits(a, c) for a, b, c in zip(out, out2, full)):
        raise AssertionError(f"epi_exp {label}: differs from its full-count build or from a "
                             "second run")
    if not all((same_values(a, b) if special else same_bits(a, b)) for a, b in zip(out, ref)):
        raise AssertionError(f"epi_exp {label}: differs from the plain version")
    widen, newton = steps[..., 0], steps[..., 1]
    if not (bool(((widen >= 1) & (widen <= k8.WIDEN_STEPS)).all())
            and bool(((newton >= 4) & (newton <= k8.NEWTON_STEPS)).all())
            and bool((full_steps[..., 0] == k8.WIDEN_STEPS).all())
            and bool((full_steps[..., 1] == k8.NEWTON_STEPS).all())):
        raise AssertionError(f"epi_exp {label}: steps out of their counts")
    return out, steps


def phase_epi_exp(k, card, floor_ms):
    """Phase 7a's K8: bitwise against its full-count build and its plain
    version at the main path's shape (``max_softmax``'s EXP epigraph under
    ``use_epigraph=False``) and at K8_SIZES, f32 and f64, s one an element,
    a number and (at the main shape) a 0-d tensor, and on the special
    values; the main shape's results against the f64 numpy test of the
    projection (``k8_kkt``); timed at the main shape in f32 (kernel and full
    count in turns, plain, launch floor) beside its bound, the measured
    chain of its longest element's steps (``k8_chain_ms``).  Returns the
    ``kernels`` record."""
    from epsilon_tpu_torch.ops.kernels import epi_exp as k8
    from epsilon_tpu_torch.ops.prox import elementwise
    plain = elementwise.epi_exp_reference
    dev = torch.device("cuda")
    (main_n,) = k["main"]
    for dtype in (torch.float32, torch.float64):
        parts = []
        for seed, n in enumerate((main_n,) + K8_SIZES):
            for s_kind in ("element", "number") + (("0-d",) if n == main_n else ()):
                v, s = k8_inputs(n, dtype, seed, dev, "number" if s_kind == "0-d" else s_kind)
                if s_kind == "0-d":
                    s = torch.tensor(s, dtype=dtype, device=dev)
                (x, t), steps = k8_check(k8, plain, v, s, f"{n} s {s_kind} {dtype}")
                kkt = k8_kkt(v, s, x, t)
                if n == main_n and s_kind == "element":
                    if not kkt <= K8_KKT_RTOL[dtype]:
                        raise AssertionError(f"epi_exp {n} {dtype}: projection test {kkt:.3e} "
                                             f"> {K8_KKT_RTOL[dtype]}")
                    if dtype == torch.float32:
                        main_err, main_in = 0.0, (v, s)
                active = int((torch.exp(v) > s).sum())
                parts.append(f"{n} s {s_kind}: {active} active, widening "
                             f"{steps[..., 0].float().mean().item():.1f} mean "
                             f"{int(steps[..., 0].max())} most, Newton "
                             f"{steps[..., 1].float().mean().item():.1f} mean "
                             f"{int(steps[..., 1].max())} most, projection test {kkt:.1e}")
        v, s = k8_special(dtype, dev)
        k8_check(k8, plain, v, s, f"special {dtype}", special=True)
        log(f"[7a] epi_exp {str(dtype)[6:]}: bitwise repeatable and equal to its full-count "
            f"build and to the plain version; " + "; ".join(parts) + f" (the main shape's "
            f"projection test in f64 numpy within {K8_KKT_RTOL[dtype]:g}); the special values "
            "(NaN, +-inf, 0, -0, +-1e30 in v and s) bitwise equal to the full-count build, "
            "equal values to the plain version")
    v, s = main_in
    ms = device_ms(lambda: k8.epi(v, s))
    plain_ms = device_ms(lambda: plain(v, s), reps=10, warmup=1)
    ab = interleaved_ms({"exit": lambda: k8.epi(v, s), "full": lambda: k8.epi_full(v, s)})
    steps = torch.zeros(main_n, 2, dtype=torch.int32, device=dev)
    x, t = k8.epi(v, s, steps=steps)
    longest = int(torch.argmax(steps.sum(dim=1)))
    widen, newton = (int(c) for c in steps[longest])
    n_bytes = _nbytes(v, s, x, t)
    flops = 8 * int(steps[:, 0].sum()) + 24 * int(steps[:, 1].sum()) + 20 * main_n
    chain_ms = k8_chain_ms(v, s, widen, newton)
    full_chain_ms = k8_chain_ms(v, s, k8.WIDEN_STEPS, k8.NEWTON_STEPS)
    bound_ms, bound_by = bound(n_bytes, flops)
    if chain_ms > bound_ms:
        bound_ms, bound_by = chain_ms, "operations"
    (med, lo, hi), (f_med, f_lo, f_hi) = ab["exit"], ab["full"]
    log(f"[7a] epi_exp {main_n} f32 (max_softmax's EXP epigraph under use_epigraph=False, s "
        f"one an element): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (device time, medians "
        f"of 50 and 10); in turns ({AB_ROUNDS} rounds of {AB_REPS} calls): exit {med:.4f} ms "
        f"({lo:.4f}-{hi:.4f}), full count {f_med:.4f} ms ({f_lo:.4f}-{f_hi:.4f}), ratio "
        f"{med / f_med:.3f}; steps: widening {steps[:, 0].float().mean().item():.1f} mean, "
        f"Newton {steps[:, 1].float().mean().item():.1f} mean, on the longest chain (element "
        f"{longest}) {widen} + {newton}; the measured chain of those steps {chain_ms:.4f} ms "
        f"(launch_floor.cu epi_exp_chain, launch included; of the full counts "
        f"{k8.WIDEN_STEPS} + {k8.NEWTON_STEPS}: {full_chain_ms:.4f}); bound {bound_ms:.4f} ms "
        f"by {bound_by} ({n_bytes} bytes, {flops:.3g} operations), kernel at "
        f"{bound_ms / med:.2f} of it; launch floor {floor_ms:.4f} ms; no PyTorch call computes "
        f"this function; {card}")
    return {"name": "epi_exp", "route": "cuda", "source": k["source"],
            "replaces": k["replaces"], "max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None, "floor_ms": floor_ms,
            "chain_ms": chain_ms, "full_count_chain_ms": full_chain_ms,
            "full_count_ms": f_med, "ab_ms": {"exit": ab["exit"], "full_count": ab["full"]},
            "steps_taken": {"widening": widen, "newton": newton}}


def element_loops():
    """K9-K11's entries as phase 7a holds them, ``name -> dict``: the
    kernel entry, its full-count build and its plain version (each called
    ``(*operands, lam)``), the loops' counts (the columns of ``steps``), the
    number of operands, and for K11 the two entries (SUM_EXP, SUM_NEG_ENTR)
    under ``"entries"``."""
    from epsilon_tpu_torch.ops.kernels import sum_inv_pos as k10
    from epsilon_tpu_torch.ops.kernels import sum_kl_div as k9
    from epsilon_tpu_torch.ops.kernels import w_log_w as k11
    from epsilon_tpu_torch.ops.prox import elementwise as ew
    return {
        "sum_kl_div_prox": dict(entries={"sum_kl_div": (
            k9.prox, k9.prox_full, ew.prox_sum_kl_div_reference)},
            counts=(k9.WIDEN_STEPS, k9.NEWTON_STEPS), operands=2),
        "sum_inv_pos_prox": dict(entries={"sum_inv_pos": (
            k10.prox, k10.prox_full, ew.prox_sum_inv_pos_reference)},
            counts=(k10.WIDEN_STEPS, k10.NEWTON_STEPS), operands=1),
        "w_log_w_prox": dict(entries={
            "sum_exp": (k11.prox_exp, k11.prox_exp_full, ew.prox_sum_exp_reference),
            "sum_neg_entr": (k11.prox_neg_entr, k11.prox_neg_entr_full,
                             ew.prox_sum_neg_entr_reference)},
            counts=(k11.STEPS,), operands=1),
    }


def element_loop_inputs(name, n, dtype, seed, dev, lam_kind="element"):
    """``(operands, lam)`` for K9 (u, v: uniform over -V/2..V) or K10 and
    K11 (v: uniform over +-V), lam log-uniform over 10^+-LAM_EXP: a
    number, a 0-d tensor on the card, one an element, or one a row
    (``"row"``: the operands as ``(ROWS, n / ROWS)``, lam ``(ROWS, 1)``;
    ``"packed"``, K9: u and v the two halves of each row of one
    ``(ROWS, 2 n / ROWS)`` tensor, as the two-argument family's stacked
    rows and the KL epigraph pass them)."""
    rng = np.random.RandomState(seed)
    V = ELEMENT_LOOP_V
    if name == "sum_kl_div_prox":
        ops = [rng.uniform(-V / 2, V, n), rng.uniform(-V / 2, V, n)]
    else:
        ops = [rng.uniform(-V, V, n)]
    lam = 10.0 ** rng.uniform(-ELEMENT_LOOP_LAM_EXP, ELEMENT_LOOP_LAM_EXP, n)
    ops = [torch.as_tensor(a, dtype=dtype, device=dev) for a in ops]
    if lam_kind == "number":
        return ops, float(lam[0])
    if lam_kind == "0-d":
        return ops, torch.tensor(lam[0], dtype=dtype, device=dev)
    if lam_kind in ("row", "packed"):
        rows = ELEMENT_LOOP_ROWS
        ops = [a.reshape(rows, n // rows) for a in ops]
        if lam_kind == "packed":
            z = torch.cat(ops, dim=1)
            ops = [z[:, :n // rows], z[:, n // rows:]]
        return ops, torch.as_tensor(lam[:rows], dtype=dtype, device=dev).reshape(rows, 1)
    return ops, torch.as_tensor(lam, dtype=dtype, device=dev)


def element_loop_special(name, dtype, dev):
    """Every pair (K9: every triple) of the special values: for v (K9: u
    and v) NaN, +-inf, 0, -0, +-1e30, 1, -1 and 50 (K9 also +-1e-14 and
    1e-27, below eps^2 in f32 and in f64: the pass-through), for lam NaN,
    inf, 0, 1e-30, 1, 1e30 and -1; one lam an element."""
    vals = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e30, -1e30, 1.0, -1.0, 50.0]
    lams = [np.nan, np.inf, 0.0, 1e-30, 1.0, 1e30, -1.0]
    if name == "sum_kl_div_prox":
        vals = vals + [1e-14, -1e-14, 1e-27]
        grids = np.meshgrid(np.array(vals), np.array(vals), np.array(lams), indexing="ij")
    else:
        grids = np.meshgrid(np.array(vals), np.array(lams), indexing="ij")
    grids = [torch.as_tensor(a.ravel(), dtype=dtype, device=dev) for a in grids]
    return grids[:-1], grids[-1]


def element_loop_check(name, entry, e, ops, lam, label, special=False):
    """One K9-K11 entry on ``(ops, lam)``: two runs and the full-count build
    bitwise equal (so the exits return the full counts' states) and equal
    to the plain version, bitwise (``same_values`` on the special values);
    the widening's steps within 1..count, the Newton's within 4..count, the
    Lambert solve's within 1..count, the full count's all the counts.
    Returns ``(outputs, steps)``."""
    kernel, full, plain = e["entries"][entry]
    shape = _element_shape(ops, lam)
    counts = e["counts"]
    steps_shape = shape + ((len(counts),) if len(counts) > 1 else ())
    steps = torch.zeros(steps_shape, dtype=torch.int32, device=ops[0].device)
    full_steps = torch.zeros_like(steps)
    out = kernel(*ops, lam, steps=steps)
    out2 = kernel(*ops, lam)
    full_out = full(*ops, lam, steps=full_steps)
    ref = plain(*ops, lam)
    torch.cuda.synchronize()
    out, out2, full_out, ref = [o if isinstance(o, tuple) else (o,)
                                for o in (out, out2, full_out, ref)]
    if not all(same_bits(a, b) and same_bits(a, c) for a, b, c in zip(out, out2, full_out)):
        raise AssertionError(f"{entry} {label}: differs from its full-count build or from a "
                             "second run")
    if not all((same_values(a, b) if special else same_bits(a, b)) for a, b in zip(out, ref)):
        raise AssertionError(f"{entry} {label}: differs from the plain version")
    cols = steps.reshape(-1, len(counts))
    full_cols = full_steps.reshape(-1, len(counts))
    least = (1, 4) if len(counts) == 2 else (1,)
    for j, (count, low) in enumerate(zip(counts, least)):
        if not (bool(((cols[:, j] >= low) & (cols[:, j] <= count)).all())
                and bool((full_cols[:, j] == count).all())):
            raise AssertionError(f"{entry} {label}: steps out of {low}..{count}")
    return out, cols


def _element_shape(ops, lam):
    from epsilon_tpu_torch.ops.kernels import _rows
    shapes = [tuple(a.shape) for a in ops]
    if isinstance(lam, torch.Tensor):
        shapes.append(tuple(lam.shape))
    return _rows.broadcast_shape(*shapes)


def warp_steps(steps, n):
    """Each warp's steps for K9's-K11's chains: the most any of its 32
    elements ran in each loop (a warp of a one-thread-an-element launch
    lasts as long as its slowest lane; element_threads() gives whole warps
    a block), one int32 a warp (two loops: the widening in the low 16 bits,
    the Newton in the high)."""
    cols = steps.reshape(n, -1)
    pad = (-n) % 32
    if pad:
        cols = torch.cat([cols, cols.new_zeros((pad, cols.shape[1]))])
    most = cols.reshape(-1, 32, cols.shape[1]).amax(dim=1)
    packed = most[:, 0] if most.shape[1] == 1 else most[:, 0] | (most[:, 1] << 16)
    return packed.to(torch.int32).contiguous()


def element_chain(name, entry, ops, lam, warps, counts, x=None):
    """A launch of K9's, K10's or K11's measured chain (``launch_floor.cu``
    kl_div_chain, inv_pos_chain, w_log_w_chain: the arithmetic of an
    element's loops, no bracket and no exit, launched as the kernel
    launches) over the elements of ``ops`` (contiguous), lam a number as
    the kernel takes it at the timed shape: each warp runs its slowest
    element's steps from ``warps`` (:func:`warp_steps` of the kernel's
    steps array in this run), or, where it is None, every element the
    loops' ``counts``.  Returns the zero-argument callable, which writes
    its x into ``x`` where given."""
    from epsilon_tpu_torch.ops.kernels import _rows
    v = ops[-1]
    x = torch.empty_like(v) if x is None else x
    lib, t = _launch_floor_library(), _rows.suffix(v)
    fn = {"sum_kl_div_prox": f"kl_div_chain_{t}", "sum_inv_pos_prox": f"inv_pos_chain_{t}",
          "w_log_w_prox": f"w_log_w_chain_{t}"}[name]
    each = None if warps is None else warps.data_ptr()
    args = (tuple(a.data_ptr() for a in ops) + (float(lam), x.data_ptr(), each, v.numel())
            + tuple(counts) + ((int(entry == "sum_neg_entr"),) if name == "w_log_w_prox" else ()))
    return lambda: _rows.launch(fn, getattr(lib, fn), args, v)


def cube_root(a):
    """``launch_floor.cu`` cube_root: K10's cube root (``row_loops.cuh``
    torch_cbrt) of every element of ``a`` (contiguous, on the card)."""
    from epsilon_tpu_torch.ops.kernels import _rows
    out = torch.empty_like(a)
    fn = f"cube_root_{_rows.suffix(a)}"
    _rows.launch(fn, getattr(_launch_floor_library(), fn), (a.data_ptr(), out.data_ptr(),
                                                             a.numel()), out)
    return out


# Floating-point operations of one element a step, for the operations
# bound: K9's widening (g: 9, the select) and Newton (g and g': 15, the
# bracket's update, the quotients and the falsi: about 20), K10's (g: 4;
# g and g' 9 and 20), K11's Lambert step (6).
ELEMENT_LOOP_FLOPS = {"sum_kl_div_prox": (10, 35), "sum_inv_pos_prox": (5, 29),
                      "w_log_w_prox": (6,)}


def phase_element_loops(loops, card, floor_ms):
    """Phase 7a's K9 (``sum_kl_div``), K10 (``sum_inv_pos``) and K11
    (``w_log_w``, both entries): each bitwise against its full-count build
    and its plain version at its main path's shape and at the other sizes,
    f32 and f64, lam a number, a 0-d tensor on the card, one an element and
    one a row (K9 also with u and v the halves of one packed tensor's rows),
    and on the special values (at 10^6 elements lam a number only, the
    main path's); K10's cube root (``launch_floor.cu`` cube_root) bitwise
    against the plain version's on the card; each timed at the main shape
    in f32 (``element_loop_timing``: kernel, full count and their measured
    chains in turns, plain, the launch floor).  Returns the ``kernels``
    records."""
    from epsilon_tpu_torch.ops.prox import elementwise as ew
    dev = torch.device("cuda")
    records = {}
    for dtype in (torch.float32, torch.float64):
        a = torch.cat([element_loop_special("sum_inv_pos_prox", dtype, dev)[1],
                       torch.as_tensor(10.0 ** np.random.RandomState(3).uniform(-30, 30, 100_000),
                                       dtype=dtype, device=dev)])
        a = torch.cat([a, -a])
        got, want = cube_root(a), ew._cbrt(a)
        torch.cuda.synchronize()
        if not same_values(got, want):
            bits = lambda t: t.view(torch.int32 if dtype == torch.float32 else torch.int64)
            both = torch.isfinite(got) & torch.isfinite(want)
            ulps = int((bits(got)[both] - bits(want)[both]).abs().max())
            raise AssertionError(f"sum_inv_pos cbrt {dtype}: differs from the plain version's "
                                 f"sign(x) |x| ** (1/3) on the card, by up to {ulps} ulps")
    log("[7a] sum_inv_pos cube root (launch_floor.cu cube_root): bitwise equal to the plain "
        f"version's sign(x) |x| ** (1/3) on the card, f32 and f64 ({a.numel():,} values a "
        "dtype: 1e-30..1e30 and the special values of lam, both signs)")
    for name, e in element_loops().items():
        k = loops[name]
        (main_n,) = k["main"]
        sizes = (main_n,) + (K9_SIZES if name == "sum_kl_div_prox" else K10_K11_SIZES)
        lam_kinds = ("number", "0-d", "element", "row") + (
            ("packed",) if name == "sum_kl_div_prox" else ())
        for entry in e["entries"]:
            for dtype in (torch.float32, torch.float64):
                parts = []
                for seed, n in enumerate(sizes):
                    for lam_kind in lam_kinds:
                        if lam_kind in ("row", "packed") and n % ELEMENT_LOOP_ROWS:
                            continue
                        # 10^6 elements only at the main path's lam (eval_prox
                        # passes a number); every kind at 10,000
                        if n > ELEMENT_LOOP_ALL_KINDS_N and lam_kind != "number":
                            continue
                        ops, lam = element_loop_inputs(name, n, dtype, seed, dev, lam_kind)
                        _, cols = element_loop_check(name, entry, e, ops, lam,
                                                     f"{n} lam {lam_kind} {dtype}")
                        parts.append(f"{n} lam {lam_kind}: steps "
                                     + " + ".join(f"{cols[:, j].float().mean().item():.1f}"
                                                  for j in range(cols.shape[1]))
                                     + " mean, " + " + ".join(
                                         str(int(cols[:, j].max())) for j in range(cols.shape[1]))
                                     + " most")
                ops, lam = element_loop_special(name, dtype, dev)
                element_loop_check(name, entry, e, ops, lam, f"special {dtype}", special=True)
                log(f"[7a] {entry} {str(dtype)[6:]}: bitwise repeatable and equal to its "
                    f"full-count build and to the plain version; " + "; ".join(parts)
                    + "; the special values bitwise equal to the full-count build, equal "
                    "values to the plain version")
        records[name] = element_loop_timing(name, k, e, card, floor_ms)
    return records


def element_loop_timing(name, k, e, card, floor_ms):
    """The main shape in f32, lam a number: each entry's kernel, its full
    count and their measured chains in turns (the chain of each warp's
    slowest element's steps in this run, and of the full counts in every
    element: a lower bound where it reads at most its build), its plain
    version; the ``kernels`` record (timed at the first entry, K11's
    SUM_EXP; the other beside it)."""
    dev = torch.device("cuda")
    (main_n,) = k["main"]
    ops, lam = element_loop_inputs(name, main_n, torch.float32, 0, dev, "number")
    record = None
    for entry, (kernel, full, plain) in e["entries"].items():
        counts = e["counts"]
        steps = torch.zeros((main_n,) + ((len(counts),) if len(counts) > 1 else ()),
                            dtype=torch.int32, device=dev)
        out = kernel(*ops, lam, steps=steps)
        out = out if isinstance(out, tuple) else (out,)
        cols = steps.reshape(main_n, -1)
        longest = int(torch.argmax(cols.sum(dim=1)))
        taken = tuple(int(c) for c in cols[longest])
        warps = warp_steps(steps, main_n)
        ms = device_ms(lambda: kernel(*ops, lam))
        plain_ms = device_ms(lambda: plain(*ops, lam), reps=10, warmup=1)
        ab = interleaved_ms({"exit": lambda: kernel(*ops, lam),
                             "full": lambda: full(*ops, lam),
                             "chain": element_chain(name, entry, ops, lam, warps, counts),
                             "full_chain": element_chain(name, entry, ops, lam, None, counts)})
        (med, lo, hi), (f_med, f_lo, f_hi) = ab["exit"], ab["full"]
        chain_ms, full_chain_ms = ab["chain"][0], ab["full_chain"][0]
        n_bytes = _nbytes(*ops, *out)
        flops = sum(f * int(cols[:, j].sum()) for j, f in enumerate(ELEMENT_LOOP_FLOPS[name]))
        bound_ms, bound_by = bound(n_bytes, flops)
        if chain_ms > bound_ms:
            bound_ms, bound_by = chain_ms, "operations"
        log(f"[7a] {entry} {main_n} f32 (lam a number): kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms (device time, medians of 50 and 10); in turns ({AB_ROUNDS} "
            f"rounds of {AB_REPS} calls): exit {med:.4f} ms ({lo:.4f}-{hi:.4f}), full count "
            f"{f_med:.4f} ms ({f_lo:.4f}-{f_hi:.4f}), exit / full {med / f_med:.3f}; the "
            f"measured chains (launch_floor.cu, lam by value, launch included): of each warp's "
            f"slowest element's steps {chain_ms:.4f} ms ({ab['chain'][1]:.4f}-"
            f"{ab['chain'][2]:.4f}), of the full counts {counts} in every element "
            f"{full_chain_ms:.4f} ms ({ab['full_chain'][1]:.4f}-{ab['full_chain'][2]:.4f}), "
            f"full-count chain / full-count build {full_chain_ms / f_med:.3f}"
            + ("" if full_chain_ms <= f_med else " (above 1: NOT a lower bound)")
            + "; steps "
            + " + ".join(f"{cols[:, j].float().mean().item():.1f}" for j in range(cols.shape[1]))
            + f" mean, on the longest chain (element {longest}) {taken}; bound "
            f"{bound_ms:.4f} ms by {bound_by} "
            f"({n_bytes} bytes, {flops:.3g} operations), kernel at {bound_ms / med:.2f} of it; "
            f"launch floor {floor_ms:.4f} ms; no PyTorch call computes this function; {card}")
        fields = {"ms": ms, "plain_ms": plain_ms, "full_count_ms": f_med,
                  "ab_ms": {"exit": ab["exit"], "full_count": ab["full"], "chain": ab["chain"],
                            "full_count_chain": ab["full_chain"]},
                  "chain_ms": chain_ms, "full_count_chain_ms": full_chain_ms,
                  "steps_taken": taken, "bound_ms": bound_ms, "bound_by": bound_by}
        if record is None:
            record = {"name": name, "route": "cuda", "source": k["source"],
                      "replaces": k["replaces"], "max_abs_err": 0.0, "library_ms": None,
                      "floor_ms": floor_ms, **fields}
        else:
            record[entry] = fields
    return record


def tv_signal(n, seed):
    """A piecewise-constant signal with noise, as ``problems/tv_1d.py``
    makes its data (about sqrt(n) / 2 level shifts of up to +-5, unit
    noise)."""
    rng = np.random.RandomState(seed)
    x0 = np.ones(n)
    for a, b in np.sort(rng.randint(0, n, (max(int(np.sqrt(n) / 2), 1), 2)), axis=1):
        x0[a:b] += 10 * (rng.rand() - 0.5)
    return x0 + rng.randn(n)


def grid_sync_ms(t, blocks, threads, syncs):
    """Device ms of one cooperative launch of ``blocks`` x ``threads`` that
    only waits at ``syncs`` grid syncs (``csrc/launch_floor.cu``)."""
    from epsilon_tpu_torch.ops.kernels import _rows
    lib = _launch_floor_library()
    return device_ms(lambda: _rows.launch("grid_sync_floor", lib.grid_sync_floor,
                                          (blocks, threads, syncs), t))


def counted_syncs(k7, v, call):
    """``call()``'s result and the grid syncs K7 counted on v's device
    while it ran (``tv1d_pdas.sync_counter``)."""
    counter = k7.sync_counter(v.device)
    counter.zero_()
    out = call()
    return out, int(counter)


def check_syncs(k7, v, rounds, syncs, levels_rounds, levels_syncs, label):
    """Each build's counted grid syncs against its formula for its rounds
    (the tile build's plan at v's length and grid)."""
    n = v.shape[0]
    plan = k7.tile_plan(n - 1, k7.grid("pdas", n, v), v.element_size())
    want = k7.grid_syncs(rounds, k7.syncs_per_round(plan))
    want_levels = k7.grid_syncs(levels_rounds, k7.levels_syncs_per_round(plan.steps))
    if (syncs, levels_syncs) != (want, want_levels):
        raise AssertionError(f"tv1d_pdas {label}: grid syncs counted {syncs} (levels build "
                             f"{levels_syncs}), the formulas {want} ({want_levels})")
    return plan


def pdas_case(tv1d, k7, v, lam, tol, z0, exact, label):
    """K7 against the levels build it replaced (``tv1d_pdas.pdas_levels``:
    the same x, z, gap and rounds, bitwise), the plain PDAS on the card and
    the exact oracle's x (``exact``, numpy), and bitwise repeatable; each
    build's grid syncs counted on the device against its formula
    (``check_syncs``); returns the kernel's ``(x, z, gap, rounds)``, the
    plain version's rounds and the errors (x and z to the plain version's
    and x to the oracle's, relative; whether x and z are the plain
    version's bits)."""
    (x, gap, it, z), syncs = counted_syncs(
        k7, v, lambda: tv1d.prox_tv1d_pdas(v, lam, tol=tol, z0=z0, return_dual=True))
    x2, gap2, it2, z2 = tv1d.prox_tv1d_pdas(v, lam, tol=tol, z0=z0, return_dual=True)
    (xl, zl, gapl, itl), levels_syncs = counted_syncs(k7, v, lambda: k7.pdas_levels(
        v, lam, tv1d.pdas_default_tol(v.dtype) if tol is None else tol, z0=z0))
    xr, _, itr, zr = tv1d.prox_tv1d_pdas_reference(v, lam, tol=tol, z0=z0, return_dual=True)
    torch.cuda.synchronize()
    if not (same_bits(x, x2) and same_bits(z, z2) and same_bits(gap, gap2)
            and int(it) == int(it2)):
        raise AssertionError(f"tv1d_pdas {label}: two runs differ")
    check_syncs(k7, v, int(it), syncs, int(itl), levels_syncs, label)
    if not (same_bits(x, xl) and same_bits(z, zl) and same_bits(gap, gapl)
            and int(it) == int(itl)):
        raise AssertionError(f"tv1d_pdas {label}: differs from the levels build ({int(it)} "
                             f"rounds, the levels build {int(itl)})")
    lam_f = float(lam)
    scale = max(1.0, float(v.abs().max()))
    err_plain = float((x - xr).abs().max()) / scale
    err_z = float((z - zr).abs().max()) / max(1.0, abs(lam_f))
    err_exact = float(np.abs(x.double().cpu().numpy() - exact).max()) / scale
    _, gap64 = tv1d.tv1d_gap(v.double().cpu(), lam_f, z.double().cpu())
    rtol = K7_RTOL[v.dtype]
    certified = 0.0 if tol is None else np.sqrt(2.0 * max(float(gap64), 0.0)) / scale
    if not (bool(torch.isfinite(x).all()) and err_plain <= rtol and err_z <= rtol
            and err_exact <= rtol + certified):
        raise AssertionError(f"tv1d_pdas {label}: relative error to the plain version x "
                             f"{err_plain:.2e}, z {err_z:.2e}, to the exact oracle "
                             f"{err_exact:.2e} (rtol {rtol:g}, certificate {certified:.2e})")
    return (x, z, gap, int(it)), itr, (err_plain, err_z, err_exact, same_bits(x, xr)
                                       and same_bits(z, zr))


def pcr_systems(m, dtype, dev, seed):
    """Two tridiagonal systems of m rows: a diagonally dominant random one
    and one as a PDAS round makes it (pinned rows b = 1, a = c = 0; free
    rows -1, 2, -1)."""
    rng = np.random.RandomState(seed)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    rand = (as_t(-rng.rand(m)), as_t(2.5 + rng.rand(m)), as_t(-rng.rand(m)), as_t(rng.randn(m)))
    free = rng.rand(m) < 0.7
    a = as_t(np.where(free, -1.0, 0.0))
    pdas = (a, as_t(np.where(free, 2.0, 1.0)), a, as_t(np.where(free, rng.randn(m),
                                                              np.sign(rng.randn(m)))))
    return {"random": rand, "pdas": pdas}


def phase_tv1d(k, card):
    """Phase 7a's K7: one PCR solve (``tv1d_pdas.pcr``, the tile build's
    PCR code) bitwise against the plain ``pcr_tridiag_solve`` on the card,
    at K7's lengths and at its tile's edges; the PDAS against the levels
    build bitwise, the plain version and the exact oracle (``pdas_case``)
    at K7_LENGTHS, K7_TILE_ROWS and the main path's lengths, f32 and f64,
    cold and warm, lam a number and a 0-d tensor, at the default tolerance
    (rounds within K7_ROUND_SLACK of the plain version's) and at
    K7_INNER_TOLS (the same rounds); then at each main length in f32, cold
    and warm at the main path's inner tolerance, the tile build, the levels
    build and the plain version timed in turns, beside each build's
    grid-sync floor at its grid (its syncs as counted on the device, which
    equal ``tv1d_pdas``'s formulas) and the bound of the work.  Returns the ``kernels`` record (at tv_1d's
    length, warm: the main path's call) and the other timings."""
    from epsilon_tpu_torch.ops.kernels import tv1d_pdas as k7
    from epsilon_tpu_torch.ops.prox import tv1d
    dev = torch.device("cuda")
    main_lengths = k["main"]
    lengths = tuple(sorted(set(K7_LENGTHS) | {m + 1 for m in K7_TILE_ROWS})) + main_lengths
    for dtype in (torch.float32, torch.float64):
        checked = []
        for m in sorted({n - 1 for n in lengths} | {1}):
            for name, system in pcr_systems(m, dtype, dev, m).items():
                got, want = k7.pcr(*system), tv1d.pcr_tridiag_solve(*system)
                torch.cuda.synchronize()
                if not same_bits(got, want):
                    raise AssertionError(f"tv1d_pcr {name} m={m} {dtype}: differs from "
                                         "pcr_tridiag_solve")
            checked.append(str(m))
        log(f"[7a] tv1d_pcr {str(dtype)[6:]}: bitwise equal to the plain pcr_tridiag_solve on "
            f"the card, a random and a PDAS system at m = {', '.join(checked)}")
        parts, bitwise = [], 0
        for n in lengths:
            v = torch.as_tensor(tv_signal(n, n), dtype=dtype, device=dev)
            lam = 0.5 * np.sqrt(n) if n > 3 else 0.3
            exact = tv1d.tv1d_exact_numpy(v.double().cpu().numpy(), lam)
            cold, _, _ = pdas_case(tv1d, k7, v, lam, None, None, exact, f"n={n} {dtype} cold")
            v2 = v + 0.05 * torch.as_tensor(np.random.RandomState(n + 1).randn(n),
                                            dtype=dtype, device=dev)
            exact = tv1d.tv1d_exact_numpy(v2.double().cpu().numpy(), lam)
            for tol in (None,) + K7_INNER_TOLS[dtype]:
                for lam_t, z0, kind in ((lam, None, "cold"), (lam, cold[1], "warm"),
                                        (torch.tensor(lam, dtype=dtype, device=dev), cold[1],
                                         "warm, lam 0-d")):
                    label = f"n={n} {dtype} tol {tol} {kind}"
                    (_, _, _, it), itr, errs = pdas_case(tv1d, k7, v2, lam_t, tol, z0, exact,
                                                         label)
                    slack = K7_ROUND_SLACK if tol is None else 0
                    if abs(it - itr) > slack:
                        raise AssertionError(f"tv1d_pdas {label}: {it} rounds, the plain "
                                             f"version {itr}")
                    bitwise += errs[3]
                    if n in main_lengths or n == K7_LENGTHS[-1]:
                        parts.append(f"n={n} tol {tol} {kind}: {it} rounds (plain {itr}), "
                                     f"errors {errs[0]:.1e} / {errs[2]:.1e}")
        cases = len(lengths) * (1 + len(K7_INNER_TOLS[dtype])) * 3
        log(f"[7a] tv1d_pdas {str(dtype)[6:]}: {cases} cases at n = "
            f"{', '.join(map(str, lengths))} (cold, warm, lam a 0-d tensor; "
            f"default tolerance and {K7_INNER_TOLS[dtype]}): x, z, gap and rounds bitwise equal "
            f"to the levels build's, each build's grid syncs counted on the device equal to "
            f"its formula's; within {K7_RTOL[dtype]:g} of the "
            f"plain PDAS (x and z) and of the exact oracle (plus the gap's certificate), "
            f"bitwise repeatable, the same rounds "
            f"at the inner tolerances; x and z bitwise equal to the plain version's in "
            f"{bitwise} of them; " + "; ".join(parts))
    from epsilon_tpu_torch import config
    records = {}
    threads = k7.threads()
    # the main path's inner tolerance in f32 (phase 7's rel_tol)
    inner_tol = config.prox_inner_tol_for(LIBRARY_REL_TOL)
    for n in main_lengths:
        v = torch.as_tensor(tv_signal(n, 1), dtype=torch.float32, device=dev)
        lam = float(np.sqrt(n))
        _, _, _, z_cold = tv1d.prox_tv1d_pdas(v, lam, tol=inner_tol, return_dual=True)
        v2 = v + 0.05 * torch.as_tensor(np.random.RandomState(2).randn(n), dtype=torch.float32,
                                        device=dev)
        m = n - 1
        blocks = k7.grid("pdas", n, v)
        plan = k7.tile_plan(m, blocks, v.element_size())
        for kind, z0 in (("cold", None), ("warm", z_cold)):
            sides = {"tiles": lambda: tv1d.prox_tv1d_pdas(v2, lam, tol=inner_tol, z0=z0),
                     "levels": lambda: k7.pdas_levels(v2, lam, inner_tol, z0=z0),
                     "plain": lambda: tv1d.prox_tv1d_pdas_reference(v2, lam, tol=inner_tol,
                                                                    z0=z0)}
            (x_k, _, rounds), syncs = counted_syncs(k7, v2, sides["tiles"])
            (_, _, _, levels_rounds), levels_syncs = counted_syncs(k7, v2, sides["levels"])
            x_p, _, plain_rounds = sides["plain"]()
            rounds, err = int(rounds), float((x_k - x_p).abs().max())
            check_syncs(k7, v2, rounds, syncs, int(levels_rounds), levels_syncs,
                        f"n={n} f32 {kind}")
            ms = device_ms(sides["tiles"])
            levels_ms = device_ms(sides["levels"])
            plain_ms = device_ms(sides["plain"], reps=K7_PLAIN_REPS, warmup=1)
            readings = {side: [] for side in sides}
            for _ in range(K7_AB_ROUNDS):
                for side in list(sides) + list(sides)[::-1]:
                    reps = K7_PLAIN_REPS if side == "plain" else K7_KERNEL_REPS
                    readings[side].append(device_ms(sides[side], reps=reps, warmup=1))
            ab = {s: (statistics.median(r), min(r), max(r)) for s, r in readings.items()}
            sync0 = grid_sync_ms(v, blocks, threads, 0)
            floor_ms = grid_sync_ms(v, blocks, threads, syncs)
            levels_floor_ms = grid_sync_ms(v, blocks, threads, levels_syncs)
            per_sync = (levels_floor_ms - sync0) / levels_syncs
            n_bytes = v.element_size() * (2 * n + 2 * m + (m if z0 is not None else 0))
            flops = rounds * m * (K7_FLOPS_ROUND + K7_FLOPS_PCR_STEP * plan.steps)
            bound_ms, bound_by = bound(n_bytes, flops)
            (med, lo, hi), (l_med, l_lo, l_hi), (p_med, p_lo, p_hi) = (
                ab["tiles"], ab["levels"], ab["plain"])
            log(f"[7a] tv1d_pdas n={n} f32 {kind} (tol {inner_tol:g}, lam {lam:.4g}): {rounds} "
                f"rounds (plain {plain_rounds}), max|x - x_plain| {err:.3e}; tile build "
                f"{ms:.4f} ms, levels build {levels_ms:.4f} ms (device time, medians of 50), "
                f"plain {plain_ms:.4f} ms (median of {K7_PLAIN_REPS}); in turns "
                f"({K7_AB_ROUNDS} rounds of tiles, levels, plain, plain, levels, tiles; "
                f"{K7_KERNEL_REPS} calls a kernel's reading, {K7_PLAIN_REPS} a plain one's): "
                f"tiles {med:.4f} ({lo:.4f}-{hi:.4f}), levels {l_med:.4f} ({l_lo:.4f}-"
                f"{l_hi:.4f}), plain {p_med:.4f} ({p_lo:.4f}-{p_hi:.4f}), tiles / levels "
                f"{med / l_med:.4f}, tiles / plain {med / p_med:.4f}; grid {blocks} x {threads}, "
                f"{plan.steps} PCR levels, K = {plan.levels} in shared memory (tiles of "
                f"{plan.tile} rows{', the whole row' if plan.whole else ''}, "
                f"{plan.smem(v.element_size())} bytes), grid syncs counted on the device "
                f"{syncs} = 2 + {rounds} x {k7.syncs_per_round(plan)} (levels build "
                f"{levels_syncs} = 2 + {rounds} x {k7.levels_syncs_per_round(plan.steps)}); "
                f"an empty cooperative kernel with as "
                f"many syncs at the same grid {floor_ms:.4f} ms (levels build's "
                f"{levels_floor_ms:.4f}; {per_sync * 1e3:.3f} us a sync, none {sync0:.4f} ms); "
                f"bound of the work {bound_ms:.6f} ms by {bound_by} ({n_bytes} bytes, "
                f"{flops:.3g} operations); tile build at {floor_ms / ms:.2f} of its sync floor; "
                f"no PyTorch call computes this function (no tridiagonal solve in "
                f"torch.linalg; a dense solve at n = {n} would take {4 * n * n / 1e9:.1f} GB); "
                f"{card}")
            records[(n, kind)] = {
                "ms": ms, "levels_ms": levels_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "max_abs_err": err, "rounds": rounds,
                "plain_rounds": plain_rounds, "tile_levels": plan.levels, "tile": plan.tile,
                "grid_syncs": syncs, "levels_grid_syncs": levels_syncs,
                "sync_us": per_sync * 1e3, "floor_ms": floor_ms,
                "levels_floor_ms": levels_floor_ms, "launch_floor_ms": sync0,
                "ab_ms": {side: ab[side] for side in sides}}
    main = records[(main_lengths[0], "warm")]
    record = {"name": "tv1d_pdas", "route": "cuda", "source": k["source"],
              "replaces": k["replaces"], "library_ms": None,
              **{key: main[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                            "bound_by", "levels_ms", "floor_ms",
                                            "grid_syncs", "tile_levels")},
              "timings": {f"n={n} {kind}": r for (n, kind), r in records.items()}}
    return record


def library_row(bench, inst, ref, profile_iters=LIBRARY_PROFILE_ITERS, tag="", phase="7",
                params=None):
    """One phase 7 (or 7c) row: solve under the solver parameters
    ``params`` at the reference's iteration cap, check, print (``tag``
    after the row's name); returns the row (its ``ok`` says whether it
    passed)."""
    from epsilon_tpu_torch.frontend import api

    def check(prob):
        objs = {}
        api.expr_var_objects(prob.objective.expr, objs)
        for c in prob.constraints:
            api.expr_var_objects(c, objs)
        values = [np.asarray(objs[k].value, dtype=np.float64)
                  for k in sorted(objs, key=lambda k: int(k.split(":")[1]))]
        finite = all(v is not None and np.all(np.isfinite(v)) for v in values)
        return dict(finite=finite, feasibility=feasibility(inst.name, inst.kwargs, values))

    row = bench.benchmark_epsilon(inst, rel_tol=LIBRARY_REL_TOL,
                                  max_iterations=ref["max_iterations"],
                                  profile_iters=profile_iters, check=check, **(params or {}))
    want = ref["objective"]
    rtol = LIBRARY_OBJ_RTOL_ROWS.get(inst.name, LIBRARY_OBJ_RTOL)
    band = rtol * abs(want) + LIBRARY_OBJ_ATOL
    feas = row["feasibility"]
    feas_tol = LIBRARY_FEAS_TOL_ROWS.get(inst.name, LIBRARY_FEAS_TOL)
    # a row stops optimal, or as the f64 reference did (max_gaussian
    # reaches the iteration cap there too)
    status_ok = row["status"] in ("optimal", ref["status"])
    row.update(reference=want, reference_iterations=ref["iterations"],
               ok=bool(row["finite"] and status_ok
                       and want - band <= row["objective"] <= want + band
                       and (feas is None or feas <= feas_tol)))
    ops = row.get("device_ops_per_iter")
    log(f"[{phase}] {inst.name}{tag}: build {row['build_s']:.3f} s, compile "
        f"{row['compile_s']:.3f} s, "
        f"set-up {row['setup_s']:.3f} s, solve {row['solve_s']:.3f} s; {row['iterations']} "
        f"iterations ({row['status']}; the f64 reference took {ref['iterations']}, "
        f"{ref['status']}, cap {ref['max_iterations']}), "
        f"{row['ms_per_iter']:.4f} ms/iter, "
        f"{'not measured' if ops is None else f'{ops:.1f}'} device operations/iter; "
        f"objective {row['objective']:.9g} vs reference {want:.9g} (band "
        f"[{want - band:.9g}, {want + band:.9g}], rtol {rtol:g}); "
        + ("no hard constraints" if feas is None
           else f"feasibility {feas:.2e} (tol {feas_tol:g})")
        + ("" if row["ok"] else "  FAILED"))
    return row


def row_launches():
    """The hand loop kernels' (K3-K7) launch counts in this process."""
    return {name: getattr(module, counter)
            for name, (module, counter) in counted_kernels().items()}


def library_row_beside(name):
    """One phase 7 row in a second process (started by ``phase_library``
    with the spawn method): returns the row and the per-row loop kernels'
    launches in that process, counted from 0 there."""
    torch.set_num_threads(1)
    from epsilon_tpu_torch.problems import benchmark as bench
    refs = json.loads(REFERENCE_JSON.read_text())["rows"]
    inst = next(p for p in bench.PROBLEMS_REFERENCE() if p.name == name)
    row = library_row(bench, inst, refs[name], tag=" (in a second process)")
    return row, row_launches()


def library_set_beside(name):
    """Phase 7c's rows of one parameter set (``name``, a key of
    ``library_reference.json`` that holds its solver parameters and its
    rows), in a process of its own (spawned by ``start_library_sets``):
    every row of PROBLEMS_REFERENCE under those parameters, at the
    reference's iteration cap.  Returns the rows, each with the launches
    of K2-K5 while it ran (the counts set to 0 before the first row)."""
    torch.set_num_threads(1)
    from epsilon_tpu_torch.ops.kernels import sym_packed as sp
    from epsilon_tpu_torch.problems import benchmark as bench
    ref_set = json.loads(REFERENCE_JSON.read_text())[name]
    sp.launches = 0
    reset_launches()
    out = []
    for inst in bench.PROBLEMS_REFERENCE():
        before = dict(row_launches(), sym_packed=sp.launches)
        row = library_row(bench, inst, ref_set["rows"][inst.name], tag=f" ({name})",
                          phase="7c", params=ref_set["params"])
        after = dict(row_launches(), sym_packed=sp.launches)
        row["launches"] = {k: n - before[k] for k, n in after.items() if n > before[k]}
        log(f"[7c] {inst.name} ({name}): kernels launched "
            + (", ".join(f"{k} {n}" for k, n in row["launches"].items()) or "none"))
        out.append(row)
    return out


def start_library_sets():
    """Starts phase 7c: one spawned process for each set of
    ``LIBRARY_SETS``, which run beside phases 7 and 8 (the rows are bound
    by their hosts).  Returns the pool and the futures."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    pool = ProcessPoolExecutor(len(LIBRARY_SETS),
                               mp_context=multiprocessing.get_context("spawn"))
    return pool, {name: pool.submit(library_set_beside, name) for name in LIBRARY_SETS}


def phase_library_sets(pool, futures, t0):
    """Phase 7c's end: waits for the sets' processes, prints each set's
    table and the launches of K2-K5 per set, and raises after the last
    set if any row failed.  Returns the launches per kernel and set."""
    launches, failed = {}, []
    with pool:
        for name, fut in futures.items():
            rows = fut.result()
            failed += [f"{r['name']} ({name})" for r in rows if not r["ok"]]
            log(f"[7c] {name}: {sum(r['ok'] for r in rows)} of {len(rows)} rows passed; "
                "row, iterations (f64 reference), ms/iter, device operations/iter, kernels")
            for r in rows:
                ops = r.get("device_ops_per_iter")
                log(f"[7c]   {name} {r['name']}: {r['iterations']} ({r['reference_iterations']}), "
                    f"{r['ms_per_iter']:.4f} ms/iter, "
                    f"{'not measured' if ops is None else f'{ops:.1f}'} ops/iter, "
                    + (", ".join(f"{k} {n}" for k, n in r["launches"].items()) or "none")
                    + ("" if r["ok"] else "  FAILED"))
                for k, n in r["launches"].items():
                    launches.setdefault(k, dict.fromkeys(LIBRARY_SETS, 0))[name] += n
            failed += [f"{kernel} not launched in {row} ({name})"
                       for kernel, k in loop_kernels().items() for row in k["sets"].get(name, ())
                       if not next(r for r in rows if r["name"] == row)["launches"].get(kernel)]
    log(f"[7c] both sets done {time.perf_counter() - t0:.1f} s after they started; "
        f"launches per kernel and set: {json.dumps(launches)}")
    if failed:
        raise AssertionError(f"phase 7c rows failed: {failed}")
    return launches


def phase_library():
    """Phase 7: every row of PROBLEMS_REFERENCE, the rows of
    ``LIBRARY_BESIDE`` in a second process while this one solves the
    others.  Returns the rows and the kernel launches of the second
    process, and raises after the last row if any failed."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from epsilon_tpu_torch.problems import benchmark as bench
    refs = json.loads(REFERENCE_JSON.read_text())["rows"]
    out = []
    beside_launches = {}
    t0 = time.perf_counter()
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
        beside = [pool.submit(library_row_beside, name) for name in LIBRARY_BESIDE]
        for inst in bench.PROBLEMS_REFERENCE():
            if inst.name not in LIBRARY_BESIDE:
                before = row_launches()
                out.append(library_row(bench, inst, refs[inst.name]))
                out[-1]["launches"] = {k: n - before[k] for k, n in row_launches().items()
                                       if n > before[k]}
                log(f"[7] {inst.name}: kernels launched "
                    + (", ".join(f"{k} {n}" for k, n in out[-1]["launches"].items()) or "none"))
        for fut in beside:
            row, launches = fut.result()
            out.append(row)
            for name, n in launches.items():
                beside_launches[name] = beside_launches.get(name, 0) + n
    failed = [r["name"] for r in out if not r["ok"]]
    not_launched = [f"{kernel} in {r['name']}" for kernel, k in loop_kernels().items()
                    for r in out if r["name"] in k["rows"]
                    and not r.get("launches", {}).get(kernel)]
    log(f"[7] {len(out)} rows in {time.perf_counter() - t0:.1f} s, "
        f"{len(out) - len(failed)} passed")
    if failed or not_launched:
        raise AssertionError(f"library rows failed: {failed}; not launched: {not_launched}")
    return out, beside_launches


def phase_over_relaxed(sp, prob, A, b, lam, plain_iters):
    """Phase 4's second solve: the 16384 x 8192 lasso from a cold state with
    over_relaxation 1.5, on the solver that Problem.solve cached (its warm
    state dropped, so no second set-up is paid).  Returns its iterations,
    each of which launched K2 once."""
    x = next(iter(_variables(prob)))
    solver = cached_solver(prob)
    solver._warm_state = None
    before = sp.launches
    t0 = time.time()
    obj = prob.solve(**dict(SOLVE, warm_start=True, over_relaxation=1.5))
    torch.cuda.synchronize()
    wall = time.time() - t0
    if cached_solver(prob) is not solver:
        raise AssertionError("over-relaxation built a second solver")
    _, kkt = checked_solution("[4] over-relaxed", prob, x, obj, A, b, lam)
    iters = prob.solver_status.num_iterations
    launches = sp.launches - before
    if launches != iters:
        raise AssertionError(f"over-relaxed lasso 16384x8192: sym_packed launched {launches} "
                             f"times in {iters} iterations")
    log(f"[4] over_relaxation 1.5, cold, on the cached solver: optimal in {iters} iterations "
        f"(plain: {plain_iters}), kkt {kkt:.2e} (tol {KKT_TOL:g}), wall {wall:.3f} s with no "
        f"second set-up; sym_packed launches {launches}, one per iteration")
    return iters


def _variables(prob):
    from epsilon_tpu_torch.frontend import api
    objs = {}
    api.expr_var_objects(prob.objective.expr, objs)
    return list(objs.values())


def _ms_per_iter(st):
    return st.timing.solve_usec / 1e3 / st.num_iterations


def phase_surface(ep, fixed_iters, x_ref):
    """Phase 8; raises on the first check that fails.  Returns the launches
    of K10 and K11 in (g)."""
    import tempfile
    from epsilon_tpu_torch import config
    from epsilon_tpu_torch.compiler import compiler
    from epsilon_tpu_torch.solvers import SolverParams, create_solver
    from epsilon_tpu_torch.utils import SolverCheckpointer

    A, b, lam = workload(2000, 1000)
    n = A.shape[1]
    f_ref = lasso_objective(A, b, lam, x_ref)

    # (a) adaptive rho
    _, iters, prob = run_lasso(ep, "[8a] adaptive rho", A, b, lam, steady_iters=500,
                               f_ref=f_ref, adaptive_rho=True)
    rho = float(cached_solver(prob)._warm_state[2])
    log(f"[8a] adaptive rho: {iters} iterations (fixed rho 1 in phase 3: {fixed_iters}), "
        f"rho {rho:g} after the steady re-solve")

    # (b) the same minimiser with rho 1 far from balanced
    As, bs, lams = 30.0 * A, 30.0 * b, 900.0 * lam
    fs_ref = lasso_objective(As, bs, lams, x_ref)
    counts = {}
    for name, extra in (("fixed rho 1", {}), ("adaptive", dict(adaptive_rho=True))):
        x, prob = lasso_problem(ep, As, bs, lams)
        obj = prob.solve(**dict(SOLVE, warm_start=True, max_iterations=100000, **extra))
        torch.cuda.synchronize()
        st = prob.solver_status
        _, kkt = checked_solution(f"[8b] scaled by 30, {name}", prob, x, obj, As, bs, lams, fs_ref)
        counts[name] = st.num_iterations
        tail = (f", final rho {float(cached_solver(prob)._warm_state[2]):g}" if extra else "")
        log(f"[8b] scaled by 30, {name}: optimal in {st.num_iterations} iterations, kkt "
            f"{kkt:.2e}, solve {st.timing.solve_usec / 1e6:.3f} s "
            f"({_ms_per_iter(st):.4f} ms/iter){tail}")
    log(f"[8b] iterations: fixed rho 1 {counts['fixed rho 1']}, adaptive {counts['adaptive']}")

    # (c) the N-block solver
    for rho in (1.0, 4.0):
        _, iters, _ = run_lasso(ep, f"[8c] prox_admm rho {rho:g}", A, b, lam, steady_iters=500,
                                f_ref=f_ref, solver="prox_admm", rho=rho)

    # (d) a Parameter right-hand side, re-solved on one cached solver
    rng = np.random.RandomState(1)
    bp = ep.Parameter(A.shape[0], value=b)
    x = ep.Variable(n)
    prob = ep.Problem(ep.Minimize(
        0.5 * ep.sum_squares(ep._wrap(A) * x - bp) + lam * ep.norm1(x)))
    t0 = time.perf_counter()
    obj = prob.solve(**dict(SOLVE, warm_start=True))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    checked_solution("[8d] first solve", prob, x, obj, A, b, lam, f_ref)
    solver, first_iters = cached_solver(prob), prob.solver_status.num_iterations
    resolves = []
    for k in range(5):
        x0 = rng.randn(n) * (rng.rand(n) < 0.1)
        bk = A @ x0 + 0.01 * rng.randn(A.shape[0])
        bp.value = bk       # the penalty stays; only the right-hand side moves
        t0 = time.perf_counter()
        obj = prob.solve(**dict(SOLVE, warm_start=True))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        fk_ref = lasso_objective(A, bk, lam, numpy_two_block(A, bk, lam))
        checked_solution(f"[8d] re-solve {k}", prob, x, obj, A, bk, lam, fk_ref)
        if cached_solver(prob) is not solver:
            raise AssertionError("[8d] the Parameter re-solve built another solver")
        resolves.append((dt, prob.solver_status.num_iterations))
    log(f"[8d] Parameter sweep on one cached solver: first solve {first_s:.3f} s "
        f"({first_iters} iterations); re-solves "
        + ", ".join(f"{dt:.3f} s ({it})" for dt, it in resolves))

    # (e) a stop callback under host drive, after 3 epochs
    compiled = compiler.compile_problem(lasso_problem(ep, A, b, lam)[1].expression_problem())
    calls = []
    solver = create_solver(compiled, SolverParams(**dict(SOLVE, rel_tol=0.0, abs_tol=0.0,
                                                         drive="host")))
    solver.register_stop_callback(lambda: calls.append(1) or len(calls) >= 3)
    solver.solve()
    if solver.status.num_iterations != 30 or solver.status.state.value == "optimal":
        raise AssertionError(f"[8e] the stop callback gave {solver.status.num_iterations} "
                             f"iterations, state {solver.status.state}")
    log(f"[8e] stop callback under drive=host: returned after {solver.status.num_iterations} "
        f"iterations, {solver.status.state.value}")

    # (f) a checkpoint, resumed by a new solver
    # rho 8 at rel_tol 1e-5 takes a few hundred iterations (240 in f32 on
    # the CPU), well past the cut
    tight = dict(rel_tol=1e-5, abs_tol=1e-8, rho=8.0)
    whole = create_solver(compiled, SolverParams(**tight))
    x_whole = whole.solve()
    with tempfile.TemporaryDirectory() as d:
        cut = create_solver(compiled, SolverParams(**dict(tight, max_iterations=50)))
        cut.attach_checkpointer(SolverCheckpointer(d))
        cut.solve()
        ckpt = SolverCheckpointer(d)
        saved = ckpt.latest_step()
        resumed = create_solver(compiled, SolverParams(**tight))
        resumed.attach_checkpointer(ckpt)
        x_res = resumed.solve()
    diff = max(float((x_res[k] - x_whole[k]).abs().max()) for k in x_whole.keys())
    on_card = all(v.device.type == config.device().type for v in x_res.data.values())
    if (saved != 50 or resumed.status.num_iterations != whole.status.num_iterations
            or resumed.status.state.value != "optimal" or not diff <= RESUME_ATOL
            or not on_card or whole.status.num_iterations <= 50):
        raise AssertionError(f"[8f] checkpoint: saved at {saved}, resumed to "
                             f"{resumed.status.num_iterations} ({resumed.status.state}), whole "
                             f"{whole.status.num_iterations}, max difference {diff}, on the "
                             f"card {on_card}")
    log(f"[8f] checkpoint at 50 iterations, resumed by a new solver: {resumed.status.num_iterations} "
        f"iterations in all, as the uninterrupted solve; max difference {diff:.2e} "
        f"(tol {RESUME_ATOL:g})")

    # (g) eval_prox on the card against the port on the CPU in f64; the
    # kinds of K10 and K11 take inputs from the seed inside their domains,
    # and each must launch its kernel (the counts set to 0 just before the
    # card's call and read just after it)
    from epsilon_tpu_torch.ops.kernels import sum_inv_pos, w_log_w
    N = EVAL_PROX_N
    rng = np.random.RandomState(2)
    v, w, c = rng.randn(N), rng.rand(N) + 0.5, rng.randn(N)
    s0 = 0.25 * float(np.abs(v).sum())
    kinds = (
        ("norm1 (elementwise)", lambda x, t: ep.norm1(x), 0.7, False, v, None),
        ("norm1 epigraph", lambda x, t: ep.norm1(x) <= t, 1.0, True, v, None),
        ("sum_squares, affine argument",
         lambda x, t: ep.sum_squares(ep.mul_elemwise(w.reshape(-1, 1), x) - c), 0.8, False, v,
         None),
        ("sum_entries(exp(x)) (K11)", lambda x, t: ep.sum_entries(ep.exp(x)), 0.6, False,
         3.0 * rng.randn(N), ("w_log_w_prox", w_log_w)),
        ("sum_entries(-entr(x)) (K11)", lambda x, t: ep.sum_entries(-ep.entr(x)), 0.8, False,
         3.0 * rng.randn(N), ("w_log_w_prox", w_log_w)),
        ("sum_entries(power(x, -1)) (K10)", lambda x, t: ep.sum_entries(ep.power(x, -1)), 0.5,
         False, 3.0 * np.abs(rng.randn(N)) + 0.1, ("sum_inv_pos_prox", sum_inv_pos)),
    )
    launches = {"sum_inv_pos_prox": 0, "w_log_w_prox": 0}
    for name, build, lam_p, epi, v_in, kernel in kinds:
        out = {}
        for device in ("cuda", "cpu"):
            config.set_device(device)
            try:
                x, t = ep.Variable(N), ep.Variable(1)
                v_map = {x: v_in, t: np.array([s0])} if epi else {x: v_in}
                if kernel is not None and device == "cuda":
                    kernel[1].launches = 0
                t0 = time.perf_counter()
                ep.eval_prox(build(x, t), v_map, lam=lam_p)
                dt = time.perf_counter() - t0
                if kernel is not None and device == "cuda":
                    launched = kernel[1].launches
                out[device] = (np.concatenate([x.value.ravel()] + ([t.value.ravel()] if epi else [])), dt)
            finally:
                config.set_device("cuda")
        (got, dt_card), (want, dt_cpu) = out["cuda"], out["cpu"]
        err = float(np.abs(got - want).max() / np.abs(want).max())
        if got.shape != want.shape or not np.all(np.isfinite(got)) or not err <= EVAL_PROX_RTOL:
            raise AssertionError(f"[8g] eval_prox {name}: relative error {err} > {EVAL_PROX_RTOL}")
        if kernel is not None:
            if launched == 0:
                raise AssertionError(f"[8g] eval_prox {name}: {kernel[0]} was not launched")
            launches[kernel[0]] += launched
        log(f"[8g] eval_prox {name}, {N} elements: relative error {err:.2e} against the port "
            f"on the CPU in f64 (tol {EVAL_PROX_RTOL:g}); {dt_card:.3f} s on the card, "
            f"{dt_cpu:.3f} s on the CPU, compile included"
            + (f"; {kernel[0]} launches {launched}" if kernel is not None else ""))
    return launches


def run_mesh_workers(mw, out_dir, world=MESH_WORLD, timeout=MESH_TIMEOUT_S, mode="run"):
    """Run ``world`` ranks of ``tools/mesh_worker.py`` (``mode`` "run", or
    "resume" for (g) on another number of ranks) under one hard limit (a
    rank that exits non-zero, or is killed at the limit, raises) and return
    the ranks' ``(json, arrays)`` results."""
    mw.spawn_ranks(mode, world, timeout, out_dir)
    stem = "rank" if mode == "run" else "resume"
    out = []
    for rank in range(world):
        with open(os.path.join(out_dir, f"{stem}{rank}.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(out_dir, f"{stem}{rank}.npz")) as f:
            out.append((meta, {k: f[k] for k in f.files}))
    return out


def _same_on_all_ranks(ranks, part):
    digests = {meta[part]["x_digest"] for meta, _ in ranks}
    if len(digests) != 1:
        raise AssertionError(f"[9] {part}: the ranks returned different x")


def _checked_lasso_x(tag, meta, xv, A, b, lam, f_ref):
    """Phase 3's f64 checks on a flagship solution that came back from the
    ranks."""
    if meta["status"] != "optimal":
        raise AssertionError(f"{tag}: status {meta['status']} after {meta['iterations']} iterations")
    kkt = kkt_violation(A, b, lam, xv)
    gap = abs(lasso_objective(A, b, lam, xv) - f_ref) / abs(f_ref)
    if not (np.all(np.isfinite(xv)) and kkt <= KKT_TOL and gap <= OBJ_RTOL):
        raise AssertionError(f"{tag}: kkt {kkt} (tol {KKT_TOL}), objective gap {gap} (tol {OBJ_RTOL})")
    return kkt, gap


def mesh_kind_references(mw):
    """(e)'s and (f)'s solves in this process, on the card, before the
    ranks start: ``(e, {family: f})``, each with its iterations, x and ms
    per iteration."""
    import epsilon_tpu_torch as ep
    from epsilon_tpu_torch.solvers import ProxADMMTwoBlockSolver, SolverParams
    A, b = mw.consensus_blocks(*mw.FULL["wide"])
    t0 = time.perf_counter()
    prob, z, xs = mw.consensus_problem(ep, A, b, mw.LAM, first_id=mw.WIDE_IDS)
    prob.solve(warm_start=True, **mw.WIDE)
    torch.cuda.synchronize()
    st = prob.solver_status
    # no warm re-solve: the 64 ties' projection makes an iteration in one
    # process slow, so its ms per iteration is the first solve's
    e = dict(iterations=st.num_iterations, status=prob.status, x=mw._values(z, xs),
             wall_s=time.perf_counter() - t0, setup_s=st.timing.init_usec / 1e6,
             solve_s=st.timing.solve_usec / 1e6,
             ms_per_iter=st.timing.solve_usec / 1e3 / st.num_iterations)
    del prob, z, xs
    f = {}
    for family in mw.FULL["kinds"]:
        solver = ProxADMMTwoBlockSolver(mw.kind_problem(family, mw.FULL), SolverParams(
            max_iterations=mw.FULL["kind_iters"][family], **mw.KINDS))
        before = mw.loop_kernel_launches()
        x = solver.solve()
        torch.cuda.synchronize()
        f[family] = dict(iterations=solver.status.num_iterations, x=mw.flat_x(x),
                         ms_per_iter=(solver.status.timing.solve_usec / 1e3
                                      / solver.status.num_iterations),
                         launches={k: n - before[k]
                                   for k, n in mw.loop_kernel_launches().items()})
    torch.cuda.empty_cache()
    return e, f


def _rel_err(x, ref):
    return float(np.abs(x - ref).max() / np.abs(ref).max())


def check_mesh_kinds(mw, ranks, resumed, e_ref, f_refs):
    """Phase 9 (e)-(g) against the references; returns the failed parts."""
    failed = []
    metas = [m for m, _ in ranks]
    world = len(ranks)
    # (e) the wide family: the chain kept, one group, the one-process solve
    S, m, n = mw.FULL["wide"]
    e0 = metas[0]["e"]
    _same_on_all_ranks(ranks, "e")
    err = _rel_err(ranks[0][1]["e_x"], e_ref["x"])
    # per row: L (m x n), the Schur pivot's inverse (m x m) and the offset
    # (m), in the solver dtype; LU pivots beside them where the solve mode
    # is triangular (the CPU's)
    from epsilon_tpu_torch import config
    item = torch.finfo(config.default_dtype()).bits // 8
    want_bytes = (S // world) * ((m * n + m * m + m) * item
                                 + (0 if config.use_explicit_inverse() else m * 4))
    stacked = [m_["e"]["bytes"]["stacks"] for m_ in metas]
    med, lo, hi = e0["steady"]["ms_per_iter"]
    log(f"[9e] wide scenarios, {S}x{m}x{n} through {e0['route']}: signature {e0['signature']}, "
        f"chain {e0['chain']}; one group of {e0['groups'][0]['S']}, rows per rank "
        f"{[m_['e']['groups'][0]['rows'] for m_ in metas]}, {e0['bucketed_terms']} bucketed term(s); "
        f"{e0['status']} in {e0['iterations']} iterations (one process: {e_ref['status']} in "
        f"{e_ref['iterations']}); max|x - x_one|/max|x_one| {err:.2e} (tol {MESH_X_RTOL:g}); "
        f"wall {e0['wall_s']:.2f} s (set-up {e0['setup_s']:.2f} s, first solve "
        f"{e0['solve_s']:.2f} s; one process {e_ref['wall_s']:.2f} s, set-up "
        f"{e_ref['setup_s']:.2f} s); warm re-solves of {mw.FULL['steady_iters']['e']} "
        f"iterations: {med:.4f} ms/iter (min {lo:.4f}, max {hi:.4f}; one process, its first solve: "
        f"{e_ref['ms_per_iter']:.4f}), {e0['steady']['collectives_per_iter']:.2f} collectives "
        f"and {e0['steady']['device_ops_per_iter']} device operations (rank 0) per iteration; "
        f"stacked bytes per rank {stacked} (expected {want_bytes}); term-operator bytes "
        f"{[m_['e']['bytes']['term_ops'] for m_ in metas]}")
    if not (e0["status"] == "optimal" and e0["signature"] == "kkt_chain"
            and [m_["e"]["groups"][0]["rows"] for m_ in metas]
            == [[r * S // world, (r + 1) * S // world] for r in range(world)]
            and e0["iterations"] == e_ref["iterations"] and err <= MESH_X_RTOL
            and all(s_ == want_bytes for s_ in stacked)):
        failed.append("9e")
    # (f) one family per kind
    for family, f0 in metas[0]["f"].items():
        _same_on_all_ranks_arrays(ranks, f"f_{family}_x")
        ref = f_refs[family]
        err = _rel_err(ranks[0][1][f"f_{family}_x"], ref["x"])
        tol = MESH_F_SPECTRAL_RTOL if family == "matrix" else MESH_X_RTOL
        log(f"[9f] {family} (d = {f0['d']}, {f0['mode']}, {f0['rows']} rows a rank"
            + (f", warm states {f0['state_rows']} rows" if f0["state_rows"] else "")
            + f"): {f0['status']} in {f0['iterations']} iterations (one process "
            f"{ref['iterations']}); max|x - x_one|/max|x_one| {err:.2e} (tol {tol:g}); "
            f"{f0['ms_per_iter']:.4f} ms/iter (one process {ref['ms_per_iter']:.4f}); set-up "
            f"{f0['setup_s']:.2f} s; stacked bytes a rank {f0['stacked_bytes']}; K6, K7, K8, K9 "
            f"launches a rank {[list(m_['f'][family]['launches'].values()) for m_ in metas]} "
            f"(one process {list(ref['launches'].values())})")
        if not (f0["iterations"] == ref["iterations"] and err <= tol):
            failed.append(f"9f {family}")
        # the TV family's rows run K7 on every rank and in one process
        if family == "tv" and not (ref["launches"]["tv1d_pdas"] and all(
                m_["f"][family]["launches"]["tv1d_pdas"] for m_ in metas)):
            failed.append("9f tv: K7 not launched")
        # the elementwise epigraph's rows run K8 on every rank and in one process
        if family == "epigraph_elementwise" and not (ref["launches"]["epi_exp"] and all(
                m_["f"][family]["launches"]["epi_exp"] for m_ in metas)):
            failed.append("9f epigraph_elementwise: K8 not launched")
        # the two-argument family's rows run K9 on every rank and in one process
        if family == "two_arg" and not (ref["launches"]["sum_kl_div_prox"] and all(
                m_["f"][family]["launches"]["sum_kl_div_prox"] for m_ in metas)):
            failed.append("9f two_arg: K9 not launched")
    # (g) the checkpoint, resumed on the same four ranks and on two
    g0 = metas[0]["g"]
    _same_on_all_ranks_arrays(ranks, "g_x")
    err4 = _rel_err(ranks[0][1]["g_x"], ranks[0][1]["e_x"])
    r_meta = [m_ for m_, _ in resumed]
    _same_on_all_ranks_arrays(resumed, "g_x")
    err2 = _rel_err(resumed[0][1]["g_x"], ranks[0][1]["e_x"])
    log(f"[9g] (e) stopped after {g0['cut_iterations']} iterations with a checkpointer "
        f"({g0['cut_s']:.2f} s; files {g0['files']}); resumed on {world} ranks: "
        f"{g0['status']} after {g0['iterations']} iterations in all ({g0['resumed_epochs']} "
        f"epochs resumed, {g0['resume_s']:.2f} s), max|x - x_e|/max|x_e| {err4:.2e}; on "
        f"{len(resumed)} ranks (rows {[m_['rows'] for m_ in r_meta]}): {r_meta[0]['status']} after "
        f"{r_meta[0]['iterations']} ({r_meta[0]['resumed_epochs']} epochs, "
        f"{r_meta[0]['resume_s']:.2f} s), {err2:.2e} (tol {MESH_RESUME_RTOL:g}; (e): "
        f"{e0['iterations']} iterations)")
    if not (g0["cut_iterations"] == 10 * mw.CKPT_EPOCHS
            and g0["iterations"] == r_meta[0]["iterations"] == e0["iterations"]
            and err4 <= MESH_RESUME_RTOL and err2 <= MESH_RESUME_RTOL):
        failed.append("9g")
    return failed


def _same_on_all_ranks_arrays(ranks, name):
    for _, arrays in ranks[1:]:
        if not np.array_equal(arrays[name], ranks[0][1][name]):
            raise AssertionError(f"[9] {name}: the ranks returned different values")


def phase_mesh(card, flagship, consensus_data, z_consensus, z_consensus_steady):
    """Phase 9; returns K1's launch count on rank 0 in (d), all on the
    streaming path at ``K1_RANK_SHAPE``, and K7's on rank 0 in (f)'s TV
    family."""
    from tools import mesh_worker as mw
    from epsilon_tpu_torch.solvers import ProxADMMTwoBlockSolver, SolverParams

    # the one-process reference of (b), on the card, before the ranks start
    n, n_groups = mw.FULL["hetero"]
    t0 = time.perf_counter()
    ref = ProxADMMTwoBlockSolver(mw.hetero_problem(n, n_groups),
                                 SolverParams(max_iterations=20000, warm_start=True,
                                              **mw.SOLVE))
    x_one = ref.solve()
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    x_one = x_one["x"].cpu().numpy().astype(np.float64)
    one_bytes = ref.operator_bytes()
    t0 = time.perf_counter()
    e_ref, f_refs = mesh_kind_references(mw)
    log(f"[9e] [9f] the one-process references in {time.perf_counter() - t0:.1f} s")
    log(f"[9b] one process: hetero n={n}, {n_groups} groups ({len(ref.term_ops)} terms): "
        f"{ref.status.state.value} in {ref.status.num_iterations} iterations, {one_s:.2f} s "
        f"(set-up {ref.status.timing.init_usec / 1e6:.2f} s, solve "
        f"{ref.status.timing.solve_usec / 1e6:.2f} s, "
        f"{ref.status.timing.solve_usec / 1e3 / ref.status.num_iterations:.4f} ms/iter); "
        f"operator bytes {one_bytes}")
    if ref.status.state.value != "optimal":
        raise AssertionError("[9b] the one-process reference did not converge")
    one_iters = ref.status.num_iterations
    # one warm re-solve, for the ranks' ms per iteration to stand beside
    ref.params = SolverParams(**dict(mw.SOLVE, rel_tol=0.0, abs_tol=0.0, warm_start=True,
                                     epoch_iterations=50,
                                     max_iterations=mw.FULL["steady_iters"]["b"]))
    ref.solve()
    torch.cuda.synchronize()
    one_ms = ref.status.timing.solve_usec / 1e3 / ref.status.num_iterations
    del ref
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        ranks = run_mesh_workers(mw, td)
        ranks_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        resumed = run_mesh_workers(mw, td, world=MESH_WORLD // 2, mode="resume")
        resume_s = time.perf_counter() - t0
    log(f"[9g] {MESH_WORLD // 2} ranks resumed (e)'s checkpoint in {resume_s:.1f} s")
    metas = [m for m, _ in ranks]
    log(f"[9] {MESH_WORLD} ranks finished in {ranks_s:.1f} s; backend "
        f"{metas[0]['backend']}, cards {[m['card'] for m in metas]} of "
        f"{torch.cuda.device_count()}; {card}")
    if len({m["backend"] for m in metas}) != 1:
        raise AssertionError("[9] the ranks chose different backends")

    failed = []

    # (a) scenario stacking at full width
    A, b, lam = consensus_data
    S, m, n = A.shape
    a0 = metas[0]["a"]
    _same_on_all_ranks(ranks, "a")
    z = ranks[0][1]["a_z"]
    X = A.astype(np.float64).reshape(S * m, n)
    y = b.astype(np.float64).ravel()
    g = X.T @ (X @ z) - X.T @ y
    kkt = float(np.where(z != 0, np.abs(g + lam * np.sign(z)),
                         np.maximum(np.abs(g) - lam, 0.0)).max() / lam)
    f_a, f_6 = (0.5 * float(np.sum((X @ v - y) ** 2)) + lam * float(np.abs(v).sum())
                for v in (z, z_consensus))
    gap = abs(f_a - f_6) / abs(f_6)
    del X
    want_bytes = S * (n * n + n) * 4 // MESH_WORLD
    stacked = [m_["a"]["bytes"]["stacks"] for m_ in metas]
    med, lo, hi = a0["steady"]["ms_per_iter"]
    log(f"[9a] scenario stacking, {S}x{m}x{n} through {a0['route']}: one group of "
        f"{a0['groups'][0]['S']}, rows per rank {[m_['a']['groups'][0]['rows'] for m_ in metas]}, "
        f"{a0['bucketed_terms']} bucketed term(s); {a0['status']} in {a0['iterations']} iterations; "
        f"kkt {kkt:.2e} (tol {KKT_TOL:g}); objective {f_a:.9g} vs phase 6's {f_6:.9g}, relative "
        f"gap {gap:.2e} (tol {OBJ_RTOL:g}); the same x on every rank; wall {a0['wall_s']:.2f} s "
        f"(solver set-up {a0['setup_s']:.2f} s, first solve {a0['solve_s']:.2f} s); warm re-solves of "
        f"{mw.FULL['steady_iters']['a']} iterations: {med:.4f} ms/iter (min {lo:.4f}, max {hi:.4f}), "
        f"{a0['steady']['collectives_per_iter']:.2f} collectives and "
        f"{a0['steady']['device_ops_per_iter']:.1f} device operations (rank 0) per iteration; "
        f"stacked bytes per rank {stacked} (a quarter of the stacks: {want_bytes}); term-operator "
        f"bytes {[m_['a']['bytes']['term_ops'] for m_ in metas]}; CUDA bytes allocated after (a) "
        f"{[m_['a'].get('cuda_bytes_allocated') for m_ in metas]}")
    if not (a0["status"] == "optimal" and kkt <= KKT_TOL and gap <= OBJ_RTOL
            and all(s_ == want_bytes for s_ in stacked)):
        failed.append("9a")

    # (b) term buckets at full width, against the one-process solve
    b0 = metas[0]["b"]
    _same_on_all_ranks(ranks, "b")
    xb = ranks[0][1]["b_x"]
    err = float(np.abs(xb - x_one).max() / np.abs(x_one).max())
    med, lo, hi = b0["steady"]["ms_per_iter"]
    log(f"[9b] term buckets, hetero n={mw.FULL['hetero'][0]}: {b0['status']} in "
        f"{b0['iterations']} iterations (one process: {one_iters}); max|x - x_one|/max|x_one| "
        f"{err:.2e} (tol {MESH_X_RTOL:g}); bucket sizes {b0['bucket_sizes']}; wall "
        f"{b0['wall_s']:.2f} s (set-up {b0['setup_s']:.2f} s, solve {b0['solve_s']:.2f} s); warm "
        f"re-solves of {mw.FULL['steady_iters']['b']} iterations: {med:.4f} ms/iter (min {lo:.4f}, "
        f"max {hi:.4f}; one process, one re-solve: {one_ms:.4f}), "
        f"{b0['steady']['collectives_per_iter']:.2f} collectives and "
        f"{b0['steady']['device_ops_per_iter']:.1f} device operations (rank 0) per iteration; "
        f"term-operator bytes per "
        f"rank {[m_['b']['bytes']['term_ops'] for m_ in metas]} (one process: "
        f"{one_bytes['term_ops']}), constraint projection {b0['bytes']['constr_prox']} on each")
    if not (b0["status"] == "optimal" and b0["iterations"] == one_iters and err <= MESH_X_RTOL):
        failed.append("9b")
    Af, bf, lamf, f_ref = flagship
    for part, tag in (("b_flagship", "[9b] flagship lasso, two terms on four ranks"),
                      ("c_prox_admm", "[9c] flagship lasso, solver=prox_admm with the group")):
        meta = metas[0][part]
        for _, arrays in ranks[1:]:
            if not np.array_equal(arrays[f"{part}_x"], ranks[0][1][f"{part}_x"]):
                raise AssertionError(f"{tag}: the ranks returned different x")
        kkt, gap = _checked_lasso_x(tag, meta, ranks[0][1][f"{part}_x"], Af, bf, lamf, f_ref)
        log(f"{tag}: optimal in {meta['iterations']} iterations, kkt {kkt:.2e}, objective gap "
            f"{gap:.2e}" + (f"; bucket sizes {meta['bucket_sizes']}" if "bucket_sizes" in meta
                            else f"; solved by {meta['solver']}"))
    c = metas[0]["c_adaptive"]
    log(f"[9c] adaptive rho with the group on (b)'s problem: {c['status']} in {c['iterations']} "
        f"iterations, final rho {c['rho']:g}, objective {c['objective']:.9g} "
        f"(fixed rho 1: {b0['objective']:.9g})")
    if c["status"] != "optimal" or any(m_["c_adaptive"]["iterations"] != c["iterations"]
                                       for m_ in metas):
        failed.append("9c adaptive rho")

    # (d) the sharded consensus solve
    d0 = metas[0]["d"]
    dz = float(np.abs(ranks[0][1]["d_z"] - z_consensus_steady).max())
    log(f"[9d] sharded consensus, {d0['blocks']} blocks a rank, {d0['iterations']} iterations: "
        f"max|z - one-process z| {dz:.2e} (tol {CONSENSUS_Z_ATOL:g}); {d0['ms_per_iter']:.4f} "
        f"ms/iter, {d0['collectives_per_iter']:.2f} collectives per iteration, set-up {d0['setup_s']:.2f} s; K1 launches per rank "
        f"{[m_['d']['k1_launches'] for m_ in metas]}, path {d0['k1_path']} at (S, n) = "
        f"{tuple(d0['k1_shape'])}, the shape phase 5 held to the plain version")
    for _, arrays in ranks[1:]:
        if not np.array_equal(arrays["d_z"], ranks[0][1]["d_z"]):
            raise AssertionError("[9d] the ranks hold different z")
    if not (dz <= CONSENSUS_Z_ATOL and all(m_["d"]["k1"] for m_ in metas)
            and all(m_["d"]["k1_launches"] >= d0["iterations"]
                    and m_["d"]["k1_path"] == "stream"
                    and tuple(m_["d"]["k1_shape"]) == K1_RANK_SHAPE for m_ in metas)):
        failed.append("9d")
    failed += check_mesh_kinds(mw, ranks, resumed, e_ref, f_refs)
    log("[9] seconds per part on rank 0: "
        + ", ".join(f"({k}) {metas[0][f'{k}_seconds']:.1f}" for k in "abcdefg"))
    if failed:
        raise AssertionError(f"[9] failed: {failed}")
    return (d0["k1_launches"], metas[0]["f"]["tv"]["launches"]["tv1d_pdas"],
            metas[0]["f"]["epigraph_elementwise"]["launches"]["epi_exp"],
            metas[0]["f"]["two_arg"]["launches"]["sum_kl_div_prox"])


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    # seconds of each phase, in the order they end (7c runs beside 7 and 8:
    # its own count is from its start to its processes' end)
    phase_s, t_mark = {}, [t_start]

    def mark(name):
        now = time.perf_counter()
        phase_s[name], t_mark[0] = now - t_mark[0], now
    import epsilon_tpu_torch as ep
    from epsilon_tpu_torch.ops.kernels import _rows
    from epsilon_tpu_torch.ops.kernels import local_update as lu
    from epsilon_tpu_torch.ops.kernels import sym_packed as sp
    row_k = row_kernels()

    # -- 1. card and build ---------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[1] {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    modules = [sp, lu] + list({id(mod): mod for mod, _ in counted_kernels().values()}.values())
    sources = [mod.build for mod in modules] + [lambda: _rows.build("launch_floor")]
    with ThreadPoolExecutor(len(sources)) as pool:
        builds = list(pool.map(lambda build: build(), sources))
    log(f"[1] {len(sources)} kernel sources built in {time.perf_counter() - t0:.2f} s, "
        "one nvcc each, started together")
    for path, build_s, build_log in builds:
        kernels = build_log.count("Compiling entry function")
        log(f"[1] built {path.name} in {build_s:.2f} s ({kernels} kernels)")
        for line in build_log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[1]   {line.strip()}")

    mark("1")
    records = []
    # -- 2. kernel against the plain version -----------------------------------
    record = phase_kernel(sp)
    records.append(record)
    mark("2")

    # -- 3. flagship lasso 2000 x 1000 ------------------------------------------
    A, b, lam = workload(2000, 1000)
    xv, flagship_iters, _ = run_lasso(ep, "[3] lasso 2000x1000", A, b, lam,
                                      steady_iters=FLAGSHIP_STEADY_ITERS)
    f_port = lasso_objective(A, b, lam, xv)
    x_ref = numpy_two_block(A, b, lam)
    f_ref = lasso_objective(A, b, lam, x_ref)
    gap = abs(f_port - f_ref) / abs(f_ref)
    if not gap <= OBJ_RTOL:
        raise AssertionError(f"lasso 2000x1000: objective {f_port} vs f64 reference "
                             f"{f_ref}: relative gap {gap} > {OBJ_RTOL}")
    log(f"[3] lasso 2000x1000: objective {f_port:.9g} vs f64 reference {f_ref:.9g}, "
        f"relative gap {gap:.2e} (tol {OBJ_RTOL:g})")
    mark("3")

    # -- 4. the slice configuration: lasso 16384 x 8192 ---------------------------
    t0 = time.time()
    A, b, lam = workload(16384, 8192)
    log(f"[4] generated 16384x8192 data in {time.time() - t0:.2f} s")
    sp.launches = 0
    _, iters, prob = run_lasso(ep, "[4] lasso 16384x8192", A, b, lam, steady_iters=STEADY_ITERS)
    launches = sp.launches
    if launches < iters + STEADY_ITERS:
        raise AssertionError(f"lasso 16384x8192: sym_packed launched {launches} times "
                             f"in {iters} + {STEADY_ITERS} iterations")
    log(f"[4] sym_packed launches in the main path: {launches} "
        f"({iters} + {STEADY_ITERS} iterations)")
    relaxed_iters = phase_over_relaxed(sp, prob, A, b, lam, iters)
    record["launches"] = launches + relaxed_iters
    del A, b, prob
    mark("4")

    # -- 5. K1 against its plain version ------------------------------------------
    k1_records = phase_local_update(lu)
    record_k1, record_k1_rank = k1_records[200, 200], k1_records[K1_RANK_SHAPE]
    records += [record_k1, record_k1_rank]
    mark("5")

    # -- 6. consensus lasso at full width -------------------------------------------
    record_k1["launches"], consensus_data, z_consensus, z_consensus_steady = phase_consensus(lu)
    mark("6")

    # -- 7a. the per-row loop kernels against their plain versions ---------------------
    t0 = time.perf_counter()
    row_records = phase_row_kernels(card)
    log(f"[7a] passed in {time.perf_counter() - t0:.1f} s")
    mark("7a")

    # -- 7c (started). the library under the other two parameter sets -----------------
    t_sets = time.perf_counter()
    set_pool, set_futures = start_library_sets()
    try:
        # -- 7. the problem library at reference size ------------------------------------
        sp.launches = lu.launches = 0
        reset_launches()
        _, beside_launches = phase_library()
        launches = {name: n + beside_launches[name] for name, n in row_launches().items()}
        log(f"[7] hand-written kernel launches in phase 7: sym_packed {sp.launches}, "
            f"local_update {lu.launches} (no library row reaches either); "
            + ", ".join(f"{name} {n} ({beside_launches[name]} of them in the second process)"
                        for name, n in launches.items()))
        for name, n in launches.items():
            row_records[name]["launches"] = n
            if n == 0 and loop_kernels().get(name, {"rows": True})["rows"]:
                raise AssertionError(f"{name} was not launched in phase 7")
        records += list(row_records.values())
        mark("7")

        # -- 8. the rest of the solver's surface at the flagship's width -----------------
        sp.launches = lu.launches = 0
        t0 = time.perf_counter()
        launches_8g = phase_surface(ep, flagship_iters, x_ref)
        log(f"[8] passed in {time.perf_counter() - t0:.1f} s; hand-written kernel launches in "
            f"phase 8: sym_packed {sp.launches}, local_update {lu.launches} (n = 1000 is below "
            f"K2's gate); in (g) " + ", ".join(f"{k} {n}" for k, n in launches_8g.items()))
        mark("8")

        # -- 7c (end). the library under the other two parameter sets --------------------
        sets_launches = phase_library_sets(set_pool, set_futures, t_sets)
        mark("7c after 8")
        phase_s["7c"] = time.perf_counter() - t_sets
    except BaseException:
        # stop the sets' processes: a failed phase ends the run
        for proc in list(set_pool._processes.values()):
            proc.terminate()
        set_pool.shutdown(wait=False, cancel_futures=True)
        raise
    for name, rec in [("sym_packed", record)] + list(row_records.items()):
        rec["launches_7c"] = sets_launches.get(name, dict.fromkeys(LIBRARY_SETS, 0))
        if name in row_k and not sum(rec["launches_7c"].values()):
            raise AssertionError(f"{name} was not launched in phase 7c")
        if name in loop_kernels() and not all(
                rec["launches_7c"][set_name] for set_name in loop_kernels()[name]["sets"]):
            raise AssertionError(f"{name} was not launched in phase 7c under "
                                 f"{list(loop_kernels()[name]['sets'])}: {rec['launches_7c']}")
    # K8 runs in no library row under the default parameters: its launches
    # are those of the set that runs it; K10's and K11's main path is phase 8
    # (g)'s eval_prox
    row_records["epi_exp"]["launches"] += row_records["epi_exp"]["launches_7c"]["no_epi"]
    for name, n in launches_8g.items():
        row_records[name]["launches_7"] = row_records[name]["launches"]
        row_records[name]["launches"] = n

    # -- 9. the meshed paths, four processes over one group ------------------------------
    A, b, lam = workload(2000, 1000)
    # K1's second record: the streaming path at one rank's shape, its count
    # rank 0's in (d) (each rank is a process of its own and sets its count
    # to 0 just before the solve)
    (record_k1_rank["launches"], row_records["tv1d_pdas"]["launches_9f"],
     row_records["epi_exp"]["launches_9f"],
     row_records["sum_kl_div_prox"]["launches_9f"]) = phase_mesh(
        card, (A, b, lam, lasso_objective(A, b, lam, x_ref)),
        consensus_data, z_consensus, z_consensus_steady)
    # K9's main path is phase 9 (f)'s two-argument family: rank 0's count
    k9_record = row_records["sum_kl_div_prox"]
    k9_record["launches_7"], k9_record["launches"] = (k9_record["launches"],
                                                      k9_record["launches_9f"])

    mark("9")
    log(f"[end] seconds per phase: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))
    log(f"[end] every phase passed in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": records}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
