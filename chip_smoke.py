#!/usr/bin/env python3
"""Drive the PyTorch port's CPD-ALS main path on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: needs CUDA; prints the card, its power limit and the versions;
2. build: compiles every kernel from ``splatt_tpu_torch/csrc`` with
   ``nvcc -Xptxas -v`` and prints registers, shared memory and spills,
   and a line per instance of the reductions' kernel (type, NV, VEC,
   registers, spill bytes);
3. kernel against plain: NELL-2-shaped synthetic tensor (12092 x 9184 x
   28818, 20M nonzeros, rank 50, f32, ALLMODE).  For each mode the sorted
   contract of ``fused_mttkrp_t`` on the mode's own layout and the
   accumulate contract on layout (m+1) % 3 are held against
   ``fused_mttkrp_t_plain`` (max error <= 1e-4 of max|plain|), and both are
   timed with CUDA events beside the bound;
4. parity: a planted rank-8 tensor of the same dims (216k nonzeros),
   rank 16: ``cpd_als`` on the card (f32, kernel) against the CPU (f64,
   plain) from the same numpy init, 5 iterations, fits within 1e-4 at
   every iteration;
5. main path at full width: ``cpd_als`` on the phase-3 tensor for 5
   iterations with engine fallback off and every launch counter set to 0
   just before; the fit must be finite in (0, 1], no engine demoted and
   ``fused_mttkrp_t`` and the eigensolver ``sym_eig`` each launched
   nmodes x iterations times; then each phase of a sweep is timed alone
   (the solve as run, with ``torch.linalg.eigh`` in the kernel's place
   and with its Cholesky branch alone, beside the steady iteration), one
   sweep runs under ``torch.cuda.set_sync_debug_mode("error")``, and
   ``sym_eig`` on each mode's normal-equations matrix, f32 and f64, is
   held against its plain version and the matrix's f64 eigh (w within
   1e-5 / 1e-12 of max|w|, the pseudo-inverse operator within 1e-4 /
   1e-10), timed beside its bound and ``torch.linalg.eigh``, and both
   timed per call on random SPD matrices from R = 16 to the kernel's
   shared-memory limit of 168; last ``cpd_als`` at ranks 50 to 168 with
   the kernel and with ``torch.linalg.eigh`` in the solve, in turns
   (fits within 1e-4), beside where the solve's rank gate sends each;
6. the other four kernels against their plain versions on the phase-3
   layouts: ``fused_mttkrp_tg`` and ``fused_mttkrp`` in both contracts on
   every mode (the phase-3 cases), ``onehot_reduce_sorted`` on each mode's
   own layout and ``onehot_reduce_full`` at width ceil8(dim+1) on layout
   (m+1) % 3, the products made once per case; each timed beside its
   bound, its plain version and, for the two reductions, one
   ``index_add_`` call, and ``onehot_reduce_full`` also on ids that are
   all the width (every flush dropped: the walk without its atomics,
   ``no_flush_ms``); ``fused_mttkrp`` runs at its engine's chunk and is
   also timed at the chunk that cuts the grid to 8 CTAs per SM.  Then,
   on 2M-nonzero tensors of the NELL-2 dims, of its first two dims and
   of bench.py's 4-mode enron4 shape, ``fused_mttkrp_t`` and
   ``fused_mttkrp`` (chunk 1 and 3) against their plain version at every
   rank of ``WALK_RANKS`` (1 to 256), f32 and bf16 values and tables,
   both contracts on every mode; and ``fused_mttkrp_tg`` against its
   plain version at rank 512 on the NELL-2 one, f32 and bf16, both
   contracts.  The fused kernels' rows carry the bytes they gather from
   the tables, counted in 32-byte sectors, and the rate those imply;
7. the engine chain at full width: ``cpd_als`` on the phase-3 tensor, rank
   50, 3 iterations, from one numpy init, under armed engine faults (see
   ``CHAIN_SCHEDULES``): each schedule's demotions and launch counts, fits
   within 1e-4 of the unfaulted run at every iteration, λ within 1e-4 of
   it, and each mode's MTTKRP through the engines left within 1e-4 of
   ``fused_mttkrp_t``'s.  Under ``RAISING_SCHEDULES`` ``cpd_als`` must
   raise: on the card the chain ends at the last kernel engine, so with
   every kernel engine faulted (or with fallback off) no plain-torch
   engine runs;
8. rank 512 at full width: ``cpd_als`` on the phase-3 layouts, 3
   iterations, no fault: the plan reads ``fused_tg`` on every mode, no
   demotion, ``fused_mttkrp_tg`` launched 9 times, the fit finite in
   (0, 1]; then each mode's launch alone beside its bound, the 32-byte
   sectors of table rows it requests (some served from L1) and the rate
   they imply, one launch on a copy of the layout whose gathered ids are
   all 0 (the kernel without its wait on gathers) and one in bf16; the
   yardsticks, timed once per run and never called by the port, sit in
   the kernels line: a library copy of an L2-resident 16 MiB tensor and
   a library gather of L2-resident rows at a layout's ids
   (``embedding_bag``); the eigensolver's gate is printed
   (R = 512 keeps ``torch.linalg.eigh``) and the sweep phases timed as in
   phase 5;
9. the compact format v2 and bf16 storage: the phase-3 layouts re-encoded
   (``reencode_layout``, no second host sort) under ``auto``, ``u8``,
   ``delta`` and ``rle``, each mode's ``format_desc`` and
   ``storage_bytes`` beside v1's; ``fused_mttkrp_v2`` against its plain
   version (<= 1e-4 of max|plain|) for each encoding and contract, timed
   beside its bound and the bytes it gathers, with ``fused_mttkrp_t``
   and ``fused_mttkrp_tg`` (the same walk without a decode) on the v1
   layout timed in turns beside it; rows 1-5 and ``fused_mttkrp_v2``
   with bf16 values, tables and products against their plain versions
   (both contracts for the fused kernels), timed; ``fused_mttkrp_t``
   (the whole rank in one tile) and ``fused_mttkrp_tg`` (tiles of 128)
   on each mode's sorted launch at ranks ``WIDE_RANKS`` (192, 256) and
   ``ODD_RANKS`` (75, 201: scalar loads), in turns, each held to the
   other; ``cpd_als``
   at full width on the ``auto`` layouts from phase 5's seed, 5
   iterations, fallback off: the plan reads ``fused_v2`` on every mode,
   no demotion, 15 launches, fits within 1e-4 of phase 5's at every
   iteration; ``cpd_als`` with bf16 storage on phase 4's planted tensor,
   10 iterations: fit above 0.97 and within 0.03 of the f32 run's;
10. dense mode at full width: bench.py's ``densemode`` scenario with
   every dim scaled by 4 (96 x 1024 x 2048, 20M nonzeros, rank 50, f32,
   TWOMODE), ``Options(dense="auto")`` at threshold 0.05, so every mode
   gets a dense tile layout.  The host build (all sparse, hybrid, one
   dense layout alone), each mode's ``format_desc`` and
   ``storage_bytes`` (index bytes 0); ``fused_dense`` against its plain
   version per mode in f32 and bf16 (<= 1e-4 of max|plain|; the f32 error
   against the 3xTF32 emulation printed beside), timed beside its bound
   (bytes, or its products at the tensor-core rate; ``ffma_bound_ms`` at
   the FFMA rate), the plain version and the library matmul (TF32 off,
   on a materialized Khatri-Rao operand whose build is timed apart);
   ``cpd_als``, 5 iterations, fallback off, counters at 0 just before:
   ``dense/fused_dense`` on every mode, no demotion, 15 ``fused_dense``
   launches, a ``dense_dispatch`` event per mode, then the sweep phases;
   the all-sparse CPD (``dense="off"``) from the same init, fits within
   1e-4 at every iteration; ``format.dense`` armed (fires once) under
   ONEMODE: a ``format_fallback`` event with ``site="dense"`` for mode 0,
   whose plan is then ``sorted_onehot/fused_t`` beside two dense modes,
   and a 2-iteration CPD within 1e-4 of the dense one; with
   ``engine.fused_dense`` armed ``cpd_als`` raises, fallback on or off;
   the dense sweep also runs under the sync-debug check;
11. the FINE distributed CPD on phase 3's tensor over every card, or 4
   virtual ranks sharing the one card: the id-sorted ring plans built once
   per mode (shared by the mode's gathers and its reduce; their builds and
   bytes printed), ``ring_gather`` per gather leg exact against its plain
   walk and the sync ring, and timed on the shared plans and on the
   owner-stable plans it walked before, in turns; ``ring_reduce`` per mode
   within 1e-4 of its plain walk and of the sync ring; each timed beside
   its bound, its plain version and the library; the ``ASYNC_RING`` CPD
   (30 + 15 ring launches per card, one plan per mode per rank, 0
   ``comm_fallback``), the overlap probe, the single-card COO CPD and
   ``ALL2ALL`` on the stream engine (fits within 1e-4) and the
   ``comm.ring_exchange`` drill;
12. the blocked per-rank engine in the three decompositions on phase 3's
   tensor over every card, or 4 virtual ranks sharing the one card, 5
   iterations each from one numpy init, fallback off: for FINE, MEDIUM
   on the auto grid and on a grid that splits two axes ((2, 2, 1) on 4
   ranks) and COARSE, the per-rank layouts built from the package's
   pieces (host seconds, each rank's nnz and seg width), rank 0's
   ``fused_mttkrp_t`` launch of each sorted mode against its plain
   version (within 1e-4 of max|plain|) timed beside its bound, and one
   sweep under the sync check (host ms to enqueue it); then each CPD
   through ``distributed_cpd_als`` with the launch counters at 0 just
   before: ``fused_mttkrp_t`` launched (sorted modes) x ranks x
   iterations times, no demotion, fits within 1e-4 of the single-card
   COO ``cpd_als`` from the same init at every iteration and λ within
   1e-4 of it (relative); FINE also on the stream engine (the blocked
   run within 1e-4 of it); last the ``engine.fused_t`` drill (MEDIUM
   raises with fallback off, on 1M nonzeros of the same dims); MEDIUM on
   the split grid once more over phase 6's 2M tensor of the same dims
   relabeled by the ``hgraph`` reorder (``grid_cpd_als(relabel=
   "hgraph")``), held to that tensor's single-card CPD (fits, λ) and to
   the same launches;
13. the host build and the balanced layouts (``--balance`` runs the
   set-up, phase 5's host layout build and this phase alone): the native
   host sort (``csrc/host_sort.cpp``, which must build here) against
   ``np.lexsort`` on mode 0's sort of phase 6's 2M tensor, in turns, equal
   permutations, beside phase 5's host layout build and an earlier
   run's 59.3 s with ``np.lexsort``;
   then bench.py's amazon-like tensor (48212 x 17742 x 18051, zipf
   exponents 1.5 / 1.5 / 1.2, seed 0, deduplicated) at 2M and 20M draws,
   each under fixed + identity, balanced + identity and balanced +
   ``hgraph``, TWOMODE, rank 50: the layouts built by
   ``BlockedSparse.compile`` with the host seconds of its reorder, sorts
   and pack (``build_seconds``), each layout's seg width, fill and
   ``layout_imbalance`` figures, the ``engine plan:``, and a 5-iteration
   CPD from one init (what ``cpd --seed 7`` draws) with fallback off,
   ``fused_mttkrp_t`` launched exactly as the plan says; each balanced
   layout's ``fused_mttkrp_t`` launch within 1e-4 of max|plain|, timed
   beside its bound; each configuration's MTTKRP of every mode on one set
   of factors (moved in through its permutation, its output back out)
   against the f64 MTTKRP of the original tensor (the stream path on the
   card), within 1e-4 of max|reference| on a kernel path and within 1e-3
   on the plain scatter paths; at 20M draws also each final model's fit,
   taken in f64 against the original tensor (so its factors must be back
   in the original row order), within 1e-6 of fixed + identity's, and
   the ``hgraph`` run's factors on the live columns (λ at least 1e-4 of
   the largest) within 1e-5 of the identity run's, relative.  Printed, not
   held: the sweeps' f32 fits at every iteration (the f32 fit misreads
   this well-fit tensor by ~1e-3, so another summation order moves it by
   as much) and λ, and at 2M draws every CPD figure (that rank-50 CPD
   keeps 3 live components in f32 and another summation order moves its
   model; PERF.md); mode 0's plan at 2M draws beside its seg widths;
   each sorted mode's ``fused_mttkrp_t`` launch on the three
   configurations' layouts, in turns, where all three run it.  At
   20M draws the tensor is also written with ``io.save`` and factored by
   ``python -m splatt_tpu_torch.cli cpd X.bin ... --mmap`` under
   ``SPLATT_FIBER_PACKING=balanced SPLATT_REORDER=hgraph`` in a
   subprocess, with no fallback event, its model's f64 fit within 1e-6 of
   the in-process run's (its sweep fit printed beside), and the balanced
   layouts re-encoded under ``auto`` run ``fused_mttkrp_v2`` (each launch
   against its plain version; the CPD's launches; its model's f64 fit
   within 1e-6); at 2M draws the ``layout.pack`` and ``reorder.apply``
   drills each leave their event, fixed or identity layouts and a
   finished CPD with ``fused_mttkrp_t`` launched and nothing demoted.
   Every check of the phase runs before it fails.
14. the guarded driver, checkpoints and observability at full width, on
   phase 5's layouts, options and seed (rank 50, f32, fallback off), each
   check fatal: an unguarded run and a guarded traced one
   (``SPLATT_HEALTH_RETRIES`` 2 through a resilience scope), fits within
   1e-6 of phase 5's at every iteration, ``fused_mttkrp_t`` launched
   nmodes x iterations times each, no demotion; the host syncs of one
   checked iteration (a 3-iteration run's less a 2-iteration run's,
   counted from ``torch.cuda.set_sync_debug_mode("warn")``) equal with
   the guard and the tracing off, on, and on together; the iteration's ms
   in those three settings, in turns; the syncs the warn mode reports for
   each kind of small host read.  A ``cpd.sweep`` NaN at iteration 3
   rolled back (one ``health_nonfinite``, one ``health_rollback``, a
   finite fit, ``fused_mttkrp_t`` launched for the re-run sweep), and a
   budget of 1 with every sweep after iteration 2 poisoned degrading
   (``health_degraded``) to a checkpoint of iteration 2 that
   ``load_checkpoint`` verifies.  6 iterations checkpointed every 2,
   stopped after iteration 4 by ``stop`` and resumed: fits within 1e-4 of
   the uninterrupted run's, each save's ms and its parts (host copy,
   sha256, ``np.savez``, fsync and renames).  ``fit_check_every=3``
   over 6 iterations: 4 fewer host syncs than k = 1, the fits at 3 and 6
   within 1e-4.  The guarded run's Chrome trace summarized by the port's
   ``summarize_file``: 5 ``cpd.iter`` spans reconciling with the printed
   seconds per iteration, the guard share.  ``cpd_als`` at
   ``Verbosity.HIGH`` (the profiled sweep), 5 iterations: the phase table
   beside phase 5's phase times (CUDA events), the per-mode MTTKRP sum
   within 20% of the same MTTKRP calls timed in the same fenced bracket
   (host clock to the end of a synchronize, which holds each call's host
   enqueue, printed apart), fits within 1e-4.  FINE on the blocked
   engine over every card, or 4 virtual ranks sharing one, 6 iterations:
   checkpointed every 2, stopped after 4 and resumed (fits within 1e-4
   of the uninterrupted run), a ``cpd.sweep`` NaN rolled back, the
   profiled FINE sweep's ``dist_phase_report``.  Last phase 3's tensor
   written with ``io.save`` and factored by ``python -m
   splatt_tpu_torch.cli cpd X.bin -r 50 -i 4 --checkpoint F
   --checkpoint-every 2 --trace T --json`` in a subprocess: exit code 0,
   the checkpoint verifies, and the ``trace`` verb reads 4 iterations
   from T.  ``--guard`` runs the set-up, phase 3's sorted launches (row 1
   of the kernels line), phase 5's CPD and sweep phases, and phase 14.
15. the autotuner, its plan cache and the bench verb (every phase before
   it reads a plan cache of this run's own, empty; phase 15 writes files
   of its own): ``tune()`` of phase 5's tensor and options over blocks
   4096/8192 x fixed/balanced x i32/auto (``TUNE_*``), one line per
   candidate (mode, engine, block, format, packing, the tuner's ms and
   the launches it made: its kernel 3 times, warm + 2), the winners, the
   cold tune's seconds by kind; a warm tune with 0 measurements and 3
   hits; ``compile(rank=50)`` building each mode at its plan; the tuned
   CPD with launches as the plans say, a ``tuned_plan`` event for every
   mode and fits within 1e-4 of phase 5's, its iteration in turns with
   phase 5's layouts under autotune off and under autotune on with an
   empty plan cache, each one's sweep phases, MTTKRP outputs' strides
   and the plan lookup's host us per call (memoized and resolved); each
   winning kernel on its tuned layout against its plain version (1e-4
   of max|plain|), its CUDA-event ms beside the tuner's host-clock
   figure.  bench.py's amazon-like tensor at 2M draws tuned over every
   block and packing under identity and ``hgraph``: the plan keys with
   their skew, mode 1's winner beside phase 13's turns (printed, not
   gated).  ``bench_mttkrp`` of stream, blocked, blocked_pallas, scatter
   and ttbox on phase 6's 2M tensor at R = 16 and 50 with the roofline
   lines and ``crosscheck_mttkrp`` within the CLI's 9e-3; then three
   processes at once: the bench verb with ``--check``, and on the phase's
   cache the tune verb on phase 3's tensor as ``.bin`` (0 measurements,
   3 hits) and ``cpd --autotune on --alloc allmode`` with a 3-mode
   ``tuned_plan``.  Drills on the 2M tensor: ``tuner.measure:runtime:*``
   (no plan, ``tuner_degraded`` on every mode), ``engine.fused_t:
   runtime:*`` (``tuner_negative`` for fused_t alone, every mode tuned),
   and a kernel loader that raises (``tune()`` raises, the cache file
   unchanged).  ``--tune`` runs the set-up, phase 5's layouts and CPD
   and phase 15, and prints a kernels line of the winning kernels.
16. the out-of-core route, on phase 12's ranks (every card, or 4 virtual
   ranks of one): phase 6's 2M tensor written as ``.tns``, the cli's
   ``convert X.tns bin X.bin`` in a child process (it must print ``wrote
   bin (streamed)``), ``load_memmap`` of the result equal to ``io.load``
   of the text, ``native.parse_tns`` against the Python parse in turns.
   Phase 3's tensor written with ``io.save`` as ``.bin`` and factored by
   MEDIUM on phase 12's auto grid, seed and initial factors (rank 50, 5
   iterations, f32, fallback off) in two child processes: one maps it
   (``load_memmap``) and builds out of core under a scratch directory,
   one reads it whole; each prints its build seconds by kind (the grid
   decomposition, the layout sorts, the uploads), ms per iteration,
   ``fused_mttkrp_t`` launches and demotions, the fits, and its peak RSS
   less its RSS once CUDA is up.  Gates: every rank's sorted layout of
   the streamed build is a memmap under the scratch directory and equal
   to the in-memory build's (``inds``, ``vals``, ``row_start``, block,
   seg width), equal launches, no demotion, fits within 1e-4 and λ within
   1e-4 (relative), and a smaller peak RSS growth out of core; rank 0's launch on each layout
   left on disk against the plain version.  FINE and COARSE out of core
   on the 2M ``.bin`` through the cpd verb (``--mmap --scratch-dir``, 3
   iterations) against the same runs in memory: fits within 1e-4, λ
   within 1e-4 (relative), equal launches; drills: ``--mmap`` without ``--scratch-dir`` runs the stream
   engine (``per-rank engine: stream``, no launch), ``--scratch-dir``
   without a decomposition exits non-zero.  ``--ooc`` runs the set-up,
   phase 3's tensor and phase 16, and prints ``fused_mttkrp_t``'s entry
   from it.
17. the batched CPD and the warm update (``--batch`` runs the set-up and
   this phase alone): 64 tenants of one shape regime (``m3:d10-10-10:
   z18``: dims uniform in [520, 1000], 140k-250k uniform draws, values
   uniform [0, 1), slot i from seed 17 + i), stacked by ``batch_compile``
   (host build seconds, device bytes), rank 32, f32, 10 iterations,
   tolerance 0, the health sentinel on (3 retries), fallback off.  Gates:
   the batched MTTKRP of every mode on 4 lanes against ``mttkrp_stream``
   of the slot (1e-4 of max|plain|); ``sym_eig`` over each mode's stack of
   64 matrices, one launch, against its plain version (1e-5 of max|w|;
   mode 0's whole stack, 4 lanes of the others) and bit for bit against
   64 single launches, timed beside them, its bound and batched
   ``torch.linalg.eigh``; ``cpd_als_batched`` with ``compiles`` 1, one
   host sync per checked iteration (a 3-iteration run's less a
   2-iteration run's), one ``sym_eig`` launch per mode per sweep, finite
   fits, results cropped to the true dims, its ms per iteration and per
   tensor, each phase of one sweep timed alone and frozen lanes bit-exact
   through a sweep; the first 8 slots through the sequential ``cpd_als``
   from the same seeds (factors and λ within 1e-3 of max|.|, fits within
   1e-6, beside a control from another seed; its ms per tensor per
   iteration beside); bf16 storage (factors bf16, each fit within 3% of
   its f32 fit); the ``cpd.batch.sweep:nan:iter=2`` drill (slot 0 rolls back
   alone, its events name slot 0 alone, neighbours within 1e-5 of
   max|.| of the clean run, or within four times two clean runs'
   difference where that is larger: the card's ``index_add_`` is atomic, so this is
   a tolerance, not bit equality).  Then the update path on phase 6's
   2M-nonzero tensor: a rank-16 base CPD of 20 iterations, a 1% delta
   merged by concatenation and ``deduplicate``, ``refresh_touched_rows``
   and 5 warm sweeps on ``BlockedSparse.compile`` of the merged tensor
   (ALLMODE, tolerance 0, fallback off) with ``fused_mttkrp_t`` launched
   3 + 15 times and no demotion, the refreshed factors within 1e-4 of
   max|plain| of the same refresh on a CPU copy and their untouched rows
   bit for bit the base model's, the warm fit within 1e-3 and within 25%
   of a 20-iteration from-scratch refit's.
   The drill also runs under ``torch.use_deterministic_algorithms``,
   where each neighbour must equal the clean run's bit for bit; and the
   host syncs of a checked iteration are the ``cudaStreamSynchronize``
   calls ``torch.profiler`` records (1), printed beside its device-to-host
   copies and the warn mode's count.
18. the serve daemon on the card (``--serve`` runs phases 1-2 and this
   phase alone), single replica, ``SPLATT_ENGINE_FALLBACK=0`` unless a
   job's spec turns it on.  Phase 3's tensor as ``.bin`` (phase 16's file
   when the whole script runs) filed as a cpd job (rank 50, 5
   iterations, tolerance 0) on an in-process ``serve.Server``: the job
   ends done at generation 1 with ``fused_mttkrp_t`` launched (modes
   whose plan names fused_t) x 5 times, no demotion, its fit within 1e-4
   of a direct ``cpd_als`` on the same compile from the same seed; its
   seconds by part (load, compile, sweeps, commit), its ms per iteration
   (the job's ``cpd.iter`` spans) beside phase 5's, and the journal's
   fsynced append.  16 predict jobs of 4096 coordinates and a top-10 of
   each mode in turn, filed and answered through the spool: bit for bit
   ``reconstruct_entries``/``top_k_slice`` on the checkpoint's factors,
   within 1e-4 of max|x̂| of an f64 reconstruction, ms per request and
   the compute alone.  A cpd job on phase 6's 2M tensor (rank 16, 20
   iterations) and an update with phase 17's 1% delta: the refresh and
   5 warm sweeps launch ``fused_mttkrp_t`` (fused_t modes) x 6 times
   with no demotion and no refit, the generation advances to 2, and a
   predict after the commit answers at generation 2.  8 synthetic jobs
   of phase 17's regime with ``batch_min`` 8: one batched CPD, each
   member's fit within 1e-6 of its sequential ``cpd_als``.  Two jobs on
   two workers at once, A with ``faults: engine.fused_t:runtime`` and
   ``engine_fallback: true``: A carries the demotion and dispatched
   fused_tg, B none and its fit within 1e-4 of its run alone (the
   launches counted per job from the ``mttkrp.dispatch`` spans); a
   ``sym_eig`` launch forced to its sweep cap in one thread's scope
   raises there only while the other thread's CPD runs clean.  ``python
   -m splatt_tpu_torch.cli serve DIR --once`` killed with SIGKILL once
   its job's first checkpoint lands, run again: the journal has
   ``resumed``, the job ends done with its fit within 1e-4 of an
   uninterrupted run, and ``predict DIR --model ... --wait`` exits 0 with
   ``served``;
19. fleet mode on the card (``--fleet`` runs phases 1-2, phase 18's
   reference run and this phase alone): ``python -m splatt_tpu_torch.cli
   serve DIR --fleet`` replica processes, fallback off, lease
   ``FLEET_LEASE_S``, each loading the kernels ``_build/`` holds (its
   ``kernels loaded in`` line, nvcc 0 s).  (a) Two replicas; phase 18's
   full-width job with a checkpoint every iteration; its claimant
   SIGKILLed once the first checkpoint lands: the survivor journals
   ``adopted`` and commits the job, whose model meets phase 18's gates
   against phase 18's reference beside its control; a third replica joins
   during the lease.  (b) Phase 18's crash job on phase 6's 2M tensor; its
   owner SIGSTOPped once its first checkpoint lands, SIGCONTed once a
   peer journals ``adopted``: the owner's ring shows its renew refused
   (``lease_expired``, role owner), it journals no terminal record and
   writes no result, the lineage audit is clean, the stamp verifies and
   the model meets the gates against a direct run.  (c)-(d) Once every
   replica has drained: each healthy replica's largest heartbeat gap
   below the lease, no lease lost by a healthy replica; from the
   adopter's ring, its ``serve.job`` span's launches (``fused_mttkrp_t``
   = fused_t modes x the iterations after the kill, ``sym_eig`` 3 x
   those) and dispatches, its load and compile seconds and iterations;
   ``status`` agrees with the journal on every job; the aggregate counts
   2 adoptions, the lease expiries and the dead victim; the victim's ring
   holds its ``job_started`` and ends before the kill; the ``trace`` verb
   merges the three rings.  (e) ``chaos --fleet --smoke --device cuda``,
   started once (a) is done and run beside (b)-(d) over a spool of its
   own, exits 0 (its report lines printed);
20. streaming ingest and the other soaks (``--ingest`` runs phases 1-2
   and this phase alone).  (a) The live feed: phase 18's 2M cpd job
   (rank 16, 20 iterations, seed 7) on an in-process ``serve.Server`` on
   the card, one worker, fallback off; phase 17's 1% delta written as a
   ``.tns`` stream with a malformed line before every 97th line, filed as
   an ``ingest`` job with ``base``, the base's dims, chunks of 5000 and
   ``update_every`` 2.  Gates: records = lines written, nnz = good
   records, quarantined = malformed lines, the chunk journal's audit
   clean; each chained update converged with no refit and no demotion,
   its ``fused_mttkrp_t`` launches (its ``serve.job`` span) = its fused_t
   modes x (1 refresh + 5 sweeps), the generation one higher per update,
   its commit-to-commit lag observed; the final model within phase 18's
   gates of the same chunk ranges re-assembled by
   ``ingest.assemble_delta`` and applied in-process as ``update`` jobs,
   beside a control from seed 1000 that misses them.  It prints the
   records per second, each update's seconds by part and its lag.
   (b)-(d), processes started beside (a): ``chaos --smoke --device cuda``
   (``chaos.CARD_SCHEDULE``: every armed site fires, fused_t demotes to
   a kernel engine, the comm drill on 4 virtual ranks raises the injected
   failure), ``chaos --serve --smoke --device cuda`` (the daemon
   SIGKILLed mid-job and restarted, no job lost, the NaN tenant
   contained) and ``chaos --ingest --smoke`` (the SIGKILL and resume on
   the card's host, its crash windows printed), each exiting 0.

The line before the last is the ``{"kernels": [...]}`` record (the nine
TPU kernels' counterparts and ``sym_eig``); the last is
``{"ok": true, "device": {...}}``.  ``python3 chip_smoke.py --ring`` runs
phases 1-3's set-up and phase 11 alone (for a call with several cards)
and prints the two ring kernels' entries; ``--decomp`` runs the set-up
and phase 12 alone and prints ``fused_mttkrp_t``'s entry from phase 12;
``--dense`` runs phases 1-2 and phase 10 alone and prints
``fused_dense``'s; ``--batch`` runs phases 1-2 and phase 17 and prints
``fused_mttkrp_t``'s entry on the update path's layouts and ``sym_eig``'s
over the batch; ``--serve`` runs phases 1-2 and phase 18 and prints
``fused_mttkrp_t``'s entry with phase 18's launches; ``--fleet`` runs phases
1-2 and phase 19 and prints ``fused_mttkrp_t``'s entry with the adopting
replica's launches; ``--ingest`` runs phases 1-2 and phase 20 and prints
``fused_mttkrp_t``'s entry with the chained updates' launches;
``--balance`` runs the set-up and phase 13 and prints
``fused_mttkrp_t``'s and ``fused_mttkrp_v2``'s entries from it.  The line
``[total]`` gives the script's seconds.  ``--gather`` runs the
set-up, the 20M-nonzero layouts, phase 3, phase 6's ``fused_mttkrp_tg``
and ``fused_mttkrp`` rows and its 2M-nonzero checks, phase 8 (with
``fused_mttkrp_tg`` timed in turns at the rank tiles of PROBE_TILES, each
checked against the shipped tile), phase 5's CPD for its fits, phase 7's
unfaulted and ``SPLATT_EXPERIMENTAL_FUSED=1`` schedules (the launches of
``fused_mttkrp`` on a full CPD) and phase 9; it prints the entries of
the four gathering kernels.  ``--ranks`` runs the set-up (building only
what is not built yet, without ``-Xptxas -v``), the 20M-nonzero layouts,
phase 5's CPD with its sweep phases, and ``fused_mttkrp_t`` against
``fused_mttkrp_tg`` in turns at rank 50, ``ODD_RANKS`` and
``WIDE_RANKS``.  ``--reduce`` runs the same set-up, the 20M-nonzero
layouts, phase 6's two reduction rows (with the no-flush launch), phase
9's bf16 reduction rows, phase 7's unfaulted schedule and the two that
launch the reductions (``REDUCE_CHAIN``: launch counts, fits, λ and
MTTKRP against the unfaulted run), where the checkout has
``kernels.onehot_reduce_launch`` the two candidate rank tiles in turns
at ``REDUCE_TILE_RANKS`` in f32 and bf16, and prints rows 2 and 3 of
the kernels line.  ``--ranks`` and ``--reduce`` call only the package's
public wrappers (the tile turns aside), so a copy of this script run in
another checkout of the port times that checkout's kernels the same
way: two trees compared in turns in one call (parent, change, change,
parent).
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

NELL2 = (12092, 9184, 28818)
NNZ = 20_000_000
RANK = 50
ITERS = 5
CHAIN_ITERS = 3
BIG_RANK = 512
BIG_RANK_NNZ = 2_000_000
PARITY_RANK = 16
ENCODINGS = ("auto", "u8", "delta", "rle")
BF16_ITERS = 10
# --gather: the rank tiles fused_mttkrp_tg is timed at in turns at rank 512
PROBE_TILES = (64, 128, 256)
# phase 6: fused_mttkrp_t and fused_mttkrp (at each of WALK_CHUNKS) against
# their plain version at ranks that take every columns-per-lane count and
# load width of the whole-rank walk (1, 17: scalar loads; 50: 8-byte; 128;
# 200 and 256: 8 columns a lane), on the 2M-nonzero NELL-2 tensor and on a
# 2-mode (NELL-2's first two dims) and a 4-mode tensor (bench.py's enron4
# shape) of as many nonzeros
WALK_RANKS = (1, 17, 50, 128, 200, 256)
WALK_CHUNKS = (1, 3)
TWO_MODE_DIMS = NELL2[:2]
ENRON4 = (6066, 5699, 244268, 1176)
# phase 9: the ranks above fused_mttkrp_tg's one tile of 128 at which
# fused_mttkrp_t (the whole rank, 8 columns a lane) and fused_mttkrp_tg
# (tiles of 128) are timed in turns on the 20M-nonzero layouts, and two
# odd ranks, whose rows take scalar loads: 4 columns a lane at 75 (both
# kernels one tile), 8 at 201 (fused_tg two tiles at 4)
WIDE_RANKS = (192, 256)
ODD_RANKS = (75, 201)
# --reduce: the ranks at which the reductions' two candidate rank tiles,
# min(R, 128) and min(R, 256) columns, are timed in turns
REDUCE_TILE_RANKS = (192, 256, 512)
REDUCE_TILES = (128, 256)
# phase 10: bench.py's densemode scenario (24, 256, 512) with every dim
# scaled by 4, 20M nonzeros: every mode's padded density is ~0.1
DENSE_DIMS = (96, 1024, 2048)
DENSE_NNZ = 20_000_000
DENSE_THRESHOLD = 0.05
DRILL_ITERS = 2
# phase 11: the FINE CPD over the ring kernels, 5 iterations; with one
# card its ranks are virtual ranks sharing it
RING_ITERS = 5
RING_VIRTUAL_RANKS = 4
# phase 12: FINE, MEDIUM and COARSE with the blocked per-rank engine, 5
# iterations; with one card its ranks are virtual ranks sharing it
DECOMP_ITERS = 5
DECOMP_VIRTUAL_RANKS = 4
DECOMP_DRILL_NNZ = 1_000_000
DECOMP_HGRAPH_NNZ = BIG_RANK_NNZ   # the hgraph run's tensor (phase 6's)
DECOMP_SEED = 12       # phase 12's initial factors, which phase 16 redraws
BF16_MIN_FIT = 0.97    # the planted tensor's bf16 fit
BF16_FIT_GAP = 0.03    # bf16 against f32 (≙ tests/test_format.py:251-252)
PARITY_TOL = 1e-4      # f32 on the card against f64 on the CPU
KERNEL_TOL = 1e-4      # relative to max|plain|, f32 with atomics
LAMBDA_TOL = 1e-4      # λ of a faulted CPD against the unfaulted, relative
# phase 13's gates, each set from the largest reading of three passing
# runs of the phase (H100 80GB HBM3, 700 W) with the headroom given:
# a plain scatter/sorted_scatter MTTKRP (f32 atomics over whole slices)
# against the f64 MTTKRP, relative: 3.02e-4 (3.3x)
SCATTER_TOL = 1e-3
# the final models' fits taken in f64 at 20M draws, against fixed +
# identity's, the CLI's and the v2 run's against their twins': 5.14e-8
# (19x)
MODEL_FIT_TOL = 1e-6
# the hgraph run's live factors (original order) against balanced +
# identity's at 20M draws, relative: 9.1e-7 (11x)
FACTOR_TOL = 1e-5
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32 FLOP/s outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# dense bf16 and TF32 on the tensor cores, the rates of fused_dense's bf16
# products and of its f32 products made of three TF32 products (3xTF32)
BF16_TC_FLOP_PER_S = 989e12
TF32_TC_FLOP_PER_S = 495e12


def log(msg: str) -> None:
    print(msg, flush=True)


def synthetic_tensor(dims, nnz: int, seed: int = 0):
    """Power-law synthetic tensor: zipf-skewed indices per mode (the
    flagship generator of the JAX package's bench.py)."""
    from splatt_tpu_torch.coo import SparseTensor

    rng = np.random.default_rng(seed)
    inds = np.empty((len(dims), nnz), dtype=np.int64)
    for m, d in enumerate(dims):
        raw = rng.zipf(1.3, size=nnz).astype(np.int64)
        inds[m] = (raw * 2654435761 + rng.integers(0, d, size=nnz)) % d
    vals = rng.random(nnz)
    return SparseTensor(inds, vals, dims)


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of `fn` on the card (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def least_ms(moved: int, flops: int, flop_rate: float = F32_FLOP_PER_S
             ) -> tuple:
    """(ms, "bytes" or "operations"): the larger of `moved` bytes over the
    HBM rate and `flops` over `flop_rate` (the f32 rate by default)."""
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"))


def bound(layout, factors, mode: int, out) -> tuple:
    """Least time in ms for one fused MTTKRP call (fused_mttkrp_t, _tg or
    fused_mttkrp): every input byte read once and the output written once
    over the HBM rate, against nmodes x R FLOP per real nonzero over the
    f32 rate."""
    moved = nbytes(layout.inds, layout.vals, layout.row_start, out)
    moved += nbytes(*(U for k, U in enumerate(factors) if k != mode))
    return least_ms(moved, layout.nmodes * int(factors[0].shape[1])
                    * layout.nnz)


def row_sectors(R: int, itemsize: int, r0: int, cols: int) -> float:
    """Mean 32-byte sectors that columns [r0, r0 + cols) of one row of a
    (d, R) table touch, over the row offsets a table's rows take (the
    pitch R * itemsize cycles the start through the sector)."""
    pitch, lo, span = R * itemsize, r0 * itemsize, cols * itemsize
    cycle = 32 // math.gcd(pitch, 32)
    return sum(((i * pitch + lo) % 32 + span + 31) // 32
               for i in range(cycle)) / cycle


def requested_bytes(layout, factors, mode: int, rtile: int) -> int:
    """Bytes of table rows a fused launch requests, in 32-byte sectors:
    for every entry of the layout's blocks (pads too: the kernel gathers
    their clamped rows), the sectors of each other table's row in each
    rank tile of `rtile` columns.  A sector the L1 cache serves counts
    too, so the rate they imply is a request rate, not an L2 rate."""
    R = int(factors[0].shape[1])
    itemsize = factors[0].element_size()
    per_row = sum(row_sectors(R, itemsize, r0, min(rtile, R - r0))
                  for r0 in range(0, R, rtile))
    tables = len(factors) - 1
    return int(layout.nblocks * layout.block * tables * per_row * 32)


def library_gather_rate(bs, cols: int, mode: int = 0,
                        seed: int = 3) -> dict:
    """A yardstick shaped like the gathering kernels' work: one library
    call, ``embedding_bag`` in sum mode, that gathers `cols`-column f32
    rows of an L2-resident table (the dims of the first mode other than
    `mode`) at that mode's ids in `mode`'s layout, in bags of 32
    consecutive entries (a warp's load), timed with CUDA events; its rate
    counts the same requested 32-byte sectors as :func:`requested_bytes`
    (the bag sums it writes are 1/32 of them, not counted).  The port
    never calls it."""
    import torch

    lay = bs.layout_for(mode)
    k = 1 if mode == 0 else 0
    gen = torch.Generator(device="cuda").manual_seed(seed)
    table = torch.rand((bs.dims[k], cols), device="cuda", generator=gen)
    ids = lay.inds[k].clamp(0, bs.dims[k] - 1)
    offsets = torch.arange(0, ids.numel(), 32, dtype=ids.dtype,
                           device=ids.device)

    def run():
        return torch.nn.functional.embedding_bag(ids, table, offsets,
                                                 mode="sum")

    ms = time_ms(run, reps=10, warmup=2)
    moved = int(ids.numel() * row_sectors(cols, 4, 0, cols) * 32)
    row = dict(cols=cols, table_rows=bs.dims[k], ids=ids.numel(), ms=ms,
               requested_bytes=moved, requested_tb_s=gather_rate(moved, ms))
    log(f"[yardstick] embedding_bag of {cols}-column rows at mode {k}'s "
        f"ids: {json.dumps(row)}")
    del table, ids, offsets
    return row


def gather_rate(moved: int, ms: float) -> float:
    """TB/s that `moved` bytes in `ms` milliseconds imply."""
    return moved / (ms * 1e-3) / 1e12


def l2_copy_rate(mib: int = 16) -> dict:
    """A yardstick of the L2: one library copy of an L2-resident `mib`
    MiB tensor (source and destination together 2 x `mib` MiB, inside
    the 50 MB L2), read plus written bytes over its time: CUDA events
    around back-to-back copies after warm-up, and the copy kernel's own
    device time from the profiler (None where it records none).  It is
    a rate one library kernel reaches, not the L2's ceiling.  The port
    never calls it."""
    import torch

    n = mib * 2**20 // 4
    src = torch.rand(n, device="cuda")
    dst = torch.empty_like(src)
    ms = time_ms(lambda: dst.copy_(src), reps=200, warmup=20)
    moved = 2 * nbytes(src)
    row = dict(mib=mib, ms=ms, bytes=moved, tb_s=gather_rate(moved, ms))
    # the same copies' device time alone (CUDA events above include the
    # gaps between back-to-back launches of a ~10 us kernel)
    reps = 50
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            dst.copy_(src)
        torch.cuda.synchronize()
    dev_us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
                 for e in prof.key_averages()) / reps
    row["kernel_ms"] = dev_us / 1e3 if dev_us > 0 else None
    row["kernel_tb_s"] = (gather_rate(moved, dev_us / 1e3) if dev_us > 0
                          else None)
    log(f"[l2] copy of an L2-resident {mib} MiB tensor: {json.dumps(row)}")
    del src, dst
    return row


def reduce_bound(ids, prod, out, nnz: int) -> tuple:
    """Least time in ms for one onehot_reduce_* call: ids and products
    read once, the output written once, against R additions per real
    nonzero."""
    return least_ms(nbytes(ids, prod, out), int(prod.shape[-1]) * nnz)


def compare(fn, plain, label: str, reps: int = 20,
            plain_reps: int = 3) -> tuple:
    """Run a kernel wrapper and its plain version on the same inputs,
    fail past KERNEL_TOL of max|plain|, and time both; returns the
    kernel's output and the row of numbers."""
    import torch

    got = fn()
    want = plain()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    rel = err / scale if scale > 0 else err
    del want
    if not rel <= KERNEL_TOL:
        raise AssertionError(f"{label}: relative error {rel:.3e} > "
                             f"{KERNEL_TOL}")
    ms = time_ms(fn, reps=reps, warmup=2)
    plain_ms = time_ms(plain, reps=plain_reps)
    return got, dict(max_abs_err=err, max_rel_err=rel, ms=ms,
                     plain_ms=plain_ms)


def phase_device() -> dict:
    import torch

    from splatt_tpu_torch.ops.kernels import nvcc_path

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log(f"[device] {name}")
    log(smi)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"nvcc: {nvcc[-1]}")
    return {"kind": name, "count": torch.cuda.device_count(), "smi": smi}


def phase_build(verbose: bool = True) -> None:
    """Build every kernel (one nvcc per source, in parallel); with
    `verbose` under ``-Xptxas -v``, printing registers, shared memory and
    spills, else only the sources not built yet."""
    from splatt_tpu_torch.ops import kernels

    res = kernels.build(verbose=verbose)
    log(f"[build] nvcc -Xptxas -v over {len(kernels.SOURCES)} source(s): "
        f"{res['seconds']:.2f} s")
    for line in res["log"].splitlines():
        if re.search(r"registers|spill|smem|Compiling entry|\.cu", line):
            log(f"[build]   {line.strip()}")
    for inst in walk_instances(res["log"], "reduce_kernel"):
        log(f"[build] onehot_reduce.cu {json.dumps(inst)}")
    kernels.load_library()


def walk_instances(log_text: str, kernel: str) -> list:
    """Each instance of `kernel` (a template over the table type and the
    walk's NV, VEC) in an ``-Xptxas -v`` report: its type, NV, VEC,
    registers and spill bytes."""
    out, cur = [], None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            t = re.search(kernel + r"I(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E",
                          m.group(1))
            cur = None
            if t:
                cur = dict(type="f32" if t.group(1) == "f" else "bf16",
                           nv=int(t.group(2)), vec=int(t.group(3)))
                out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur.update(spill_stores=int(m.group(1)),
                       spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def random_factors(bs, rank: int, seed: int) -> list:
    """f32 uniform [0, 1) factor tables on the layouts' device."""
    import torch

    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.random((d, rank), dtype=np.float32)).to(
        bs.device) for d in bs.dims]


def contracts(bs):
    """(contract, layout, width, accumulate, mode) for both contracts of
    each mode: sorted on the mode's own layout, accumulate at width
    ceil8(dim+1) on layout (m+1) % nmodes."""
    for m in range(bs.nmodes):
        yield ("sorted", bs.layout_for(m), bs.layout_for(m).seg_width,
               False, m)
        yield ("accumulate", bs.layout_for((m + 1) % bs.nmodes),
               -(-(bs.dims[m] + 1) // 8) * 8, True, m)


def phase_kernels(bs, rank: int, seed: int = 1) -> list:
    """Each mode's two contracts against the plain version, timed."""
    import torch

    from splatt_tpu_torch.ops.kernels import (fused_mttkrp_t,
                                              fused_mttkrp_t_plain)

    factors = random_factors(bs, rank, seed)
    rows = []
    for contract, lay, width, acc, m in contracts(bs):
        got, row = compare(
            lambda: fused_mttkrp_t(lay, factors, m, width, acc),
            lambda: fused_mttkrp_t_plain(lay, factors, m, width, acc),
            f"fused_mttkrp_t {contract} mode {m}")
        row.update(contract=contract, mode=m, layout_mode=lay.mode,
                   width=width, nblocks=lay.nblocks, block=lay.block)
        row["bound_ms"], row["bound_by"] = bound(lay, factors, m, got)
        row["requested_bytes"] = requested_bytes(lay, factors, m, rank)
        row["requested_tb_s"] = gather_rate(row["requested_bytes"], row["ms"])
        log(f"[kernel] {json.dumps(row)}")
        rows.append(row)
        del got
        torch.cuda.empty_cache()
    return rows


def planted_tensor(dims, clusters: int, side: int, seed: int):
    """An exactly rank-`clusters` tensor of the given dims: cluster c is the
    outer product of random positive vectors over rows [c*side, (c+1)*side)
    of every mode.  A CPD reaches a fit far from 0, so the card's and the
    CPU's fits are compared where they carry digits; adjacent clusters keep
    every block's row span small, so the sorted modes run the kernel."""
    from splatt_tpu_torch.coo import SparseTensor

    rng = np.random.default_rng(seed)
    grid = np.indices((side,) * len(dims)).reshape(len(dims), -1)
    inds, vals = [], []
    for c in range(clusters):
        inds.append(grid + c * side)
        v = np.ones(grid.shape[1])
        for m in range(len(dims)):
            v *= (rng.random(side) + 0.5)[grid[m]]
        vals.append(v)
    return SparseTensor(np.concatenate(inds, axis=1), np.concatenate(vals),
                        dims)


def phase_parity() -> None:
    """cpd_als on the card (f32) against the CPU (f64), same init."""
    import torch

    from splatt_tpu_torch import BlockedSparse, Options, cpd_als
    from splatt_tpu_torch.config import Verbosity

    tt = planted_tensor(NELL2, clusters=8, side=30, seed=3)
    rng = np.random.default_rng(4)
    init = [rng.random((d, PARITY_RANK)) for d in tt.dims]
    fits = {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        opts = Options(max_iterations=ITERS, tolerance=0.0,
                       val_dtype=dtype, verbosity=Verbosity.NONE)
        bs = BlockedSparse.from_coo(tt, opts, device=dev)
        fits[dev] = cpd_als(bs, PARITY_RANK, opts, init=init,
                            device=dev).fits
    diff = max(abs(a - b) for a, b in zip(fits["cuda"], fits["cpu"]))
    log(f"[parity] fits card f32 {fits['cuda']}")
    log(f"[parity] fits cpu  f64 {fits['cpu']}")
    log(f"[parity] max |fit difference| {diff:.3e} (tolerance {PARITY_TOL})")
    if len(fits["cuda"]) != ITERS or not diff <= PARITY_TOL:
        raise AssertionError("card and CPU fits disagree")
    if not fits["cpu"][-1] > 0.5:
        raise AssertionError("the planted rank-8 model was not recovered")


def phase_main_path(bs, rank: int) -> dict:
    """The full-width CPD with the launch counter read around it, then
    each phase of a sweep timed alone on the final factors."""
    import torch

    from splatt_tpu_torch import Options, cpd_als, resilience
    from splatt_tpu_torch.config import BlockAlloc
    from splatt_tpu_torch.ops import kernels, linalg

    # fallback off: no rescue can hide a broken kernel
    opts = Options(block_alloc=BlockAlloc.ALLMODE, max_iterations=ITERS,
                   tolerance=0.0, random_seed=0, engine_fallback=False)
    resilience.reset_demotions()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    linalg.sym_eig.launches = 0
    t0 = time.perf_counter()
    out = cpd_als(bs, rank, opts)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.fused_mttkrp_t.launches
    eig_launches = linalg.sym_eig.launches
    if resilience.demotions():
        raise AssertionError(f"demotions on the main path: "
                             f"{resilience.demotions()}")
    peak = torch.cuda.max_memory_allocated()
    fit = out.fit
    steady = sum(out.iter_seconds[1:]) / (len(out.iter_seconds) - 1)
    log(f"[cpd] fits {list(out.fits)}")
    log(f"[cpd] iteration seconds {list(out.iter_seconds)}")
    log(f"[cpd] {steady:.5f} s/iteration (iterations 2..{ITERS}); whole "
        f"call {seconds:.3f} s with init, norm and post-processing; peak "
        f"device memory {peak / 2**30:.2f} GiB; fused_mttkrp_t launches "
        f"{launches}; sym_eig launches {eig_launches}")
    if not (math.isfinite(fit) and 0.0 < fit <= 1.0):
        raise AssertionError(f"fit {fit} is not finite in (0, 1]")
    if launches != bs.nmodes * ITERS or eig_launches != bs.nmodes * ITERS:
        raise AssertionError(f"fused_mttkrp_t launched {launches} times and "
                             f"sym_eig {eig_launches}, expected "
                             f"{bs.nmodes * ITERS} each")
    parts = sweep_phases(bs, out.factors, steady, "[cpd]")
    log(f"[cpd] an earlier run of this script with torch.linalg.eigh in "
        f"the solve (H100 80GB HBM3, 700 W, another run): solve "
        f"{EIGH_SOLVE_MS} ms, iteration {EIGH_ITER_MS} ms; this run: solve "
        f"{parts['solve']:.3f} ms, iteration {steady * 1e3:.3f} ms")
    host_ms = sweep_without_sync(bs, out.factors, "[cpd]")
    eig = phase_sym_eig(bs, out.factors)
    return {"launches": launches, "sym_eig_launches": eig_launches,
            "sec_per_iter": steady, "phases": parts, "fits": list(out.fits),
            "sweep_enqueue_ms": host_ms, "sym_eig": eig,
            "sym_eig_scaling": sym_eig_scaling(),
            "solve_crossover": solve_crossover(bs)}


#: ranks at which phase 5 runs the CPD with each eigensolver in the solve
CROSSOVER_RANKS = (50, 64, 80, 96, 112, 128, 168)
#: the two routes' fits at one rank, both f32 on the same layouts
CROSSOVER_FIT_TOL = 1e-4


def solve_crossover(bs) -> list:
    """cpd_als on the phase-3 layouts at each of CROSSOVER_RANKS with the
    solve's eigendecomposition the sym_eig kernel or torch.linalg.eigh
    (put in linalg.eigh's place, whatever the gate), after an untimed
    2-iteration run of each, in turns kernel, eigh, eigh, kernel: each
    route's steady ms per iteration, the same run's pair, and where the
    gate (linalg.solve_takes_sym_eig) sends the rank."""
    import torch

    from splatt_tpu_torch import Options, cpd_als
    from splatt_tpu_torch.config import BlockAlloc, Verbosity
    from splatt_tpu_torch.ops import linalg

    opts = Options(block_alloc=BlockAlloc.ALLMODE, max_iterations=ITERS,
                   tolerance=0.0, random_seed=0, engine_fallback=False,
                   verbosity=Verbosity.NONE)
    routes = {"sym_eig": linalg.sym_eig, "eigh": torch.linalg.eigh}
    real = linalg.eigh
    rows = []
    try:
        for R in CROSSOVER_RANKS:
            for fn in routes.values():
                linalg.eigh = fn
                cpd_als(bs, R, dataclasses.replace(opts, max_iterations=2))
            ms = {k: [] for k in routes}
            fits = {}
            for name in ("sym_eig", "eigh", "eigh", "sym_eig"):
                linalg.eigh = routes[name]
                out = cpd_als(bs, R, opts)
                ms[name].append(sum(out.iter_seconds[1:]) * 1e3
                                / (len(out.iter_seconds) - 1))
                fits[name] = list(out.fits)
            diff = max(abs(a - b) for a, b in zip(fits["sym_eig"],
                                                  fits["eigh"]))
            if not diff <= CROSSOVER_FIT_TOL:
                raise AssertionError(f"rank {R}: fits {fits} differ by "
                                     f"{diff:.3e} between the routes")
            row = dict(R=R, sym_eig_ms=sum(ms["sym_eig"]) / 2,
                       eigh_ms=sum(ms["eigh"]) / 2, runs_ms=ms,
                       fit_diff=diff,
                       gate=linalg.solve_takes_sym_eig(R, torch.float32))
            row["kernel_faster"] = row["sym_eig_ms"] < row["eigh_ms"]
            log(f"[crossover] {json.dumps(row)}")
            rows.append(row)
    finally:
        linalg.eigh = real
    return rows


def cholesky_solve_only(lhs, rhs):
    """The dense solve's Cholesky branch alone: no eigendecomposition."""
    import torch

    L, _ = torch.linalg.cholesky_ex(lhs)
    return torch.cholesky_solve(rhs.T, L).T


def solve_with_eigh(lhs, rhs):
    """The solve with torch.linalg.eigh in the eigensolver's place (the
    port's solve before the eigensolver kernel), which reads its solver
    status on the host:
    the library yardstick of the sym_eig kernel, never called by the
    port on a card within the kernel's gate."""
    import torch

    from splatt_tpu_torch.config import acc_dtype

    rhs = rhs.to(acc_dtype(rhs.dtype))
    L, info = torch.linalg.cholesky_ex(lhs)
    x_chol = torch.cholesky_solve(rhs.T, L).T
    w, v = torch.linalg.eigh(lhs)
    tol = torch.finfo(lhs.dtype).eps ** 0.5 * w.abs().max()
    w_inv = torch.where(w.abs() > tol, 1.0 / w, torch.zeros_like(w))
    x_pinv = (rhs @ (v * w_inv)) @ v.T
    spd = (info == 0) & (w.min() > tol) & torch.isfinite(x_chol).all()
    return torch.where(spd, x_chol, x_pinv)


def sweep_phases(bs, U, steady: float, tag: str) -> dict:
    """Where a sweep's time goes: each phase timed alone on factors `U`,
    summed over modes, beside the steady iteration (host clock): the rest
    is launch and host time between the phases.  The solve is timed as
    the port runs it (the sym_eig kernel within its gate), with
    torch.linalg.eigh in the kernel's place (key ``solve_eigh``) and with
    its Cholesky branch alone (``solve_cholesky_only``)."""
    from splatt_tpu_torch import mttkrp
    from splatt_tpu_torch.ops.linalg import (form_normal_lhs, gram,
                                             normalize_columns,
                                             solve_normals)

    grams = [gram(u) for u in U]
    parts = {"mttkrp": 0.0, "solve": 0.0, "normalize+gram": 0.0}
    alt = {"solve_eigh": 0.0, "solve_cholesky_only": 0.0}
    for m in range(bs.nmodes):
        M = mttkrp(bs, U, m)
        lhs = form_normal_lhs(grams, m)
        parts["mttkrp"] += time_ms(lambda: mttkrp(bs, U, m), reps=5)
        parts["solve"] += time_ms(lambda: solve_normals(lhs, M), reps=5)
        alt["solve_eigh"] += time_ms(lambda: solve_with_eigh(lhs, M), reps=5)
        alt["solve_cholesky_only"] += time_ms(
            lambda: cholesky_solve_only(lhs, M), reps=5)
        parts["normalize+gram"] += time_ms(
            lambda: gram(normalize_columns(M, "max")[0]), reps=5)
    rest = steady * 1e3 - sum(parts.values())
    log(f"{tag} sweep phases, ms summed over modes: "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f"; steady iteration {steady * 1e3:.3f} ms, of which "
          f"{rest:.3f} ms outside the phases (launches, host, fit read); "
          f"MTTKRP share {parts['mttkrp'] / 1e3 / steady:.1%}")
    log(f"{tag} solve summed over modes: {parts['solve']:.3f} ms as run, "
        f"{alt['solve_eigh']:.3f} ms with torch.linalg.eigh (host sync), "
        f"{alt['solve_cholesky_only']:.3f} ms with the Cholesky branch "
        f"alone")
    parts.update(alt, outside_phases=rest)
    return parts


def sweep_without_sync(bs, U, tag: str) -> float:
    """One ALS sweep of cpd.py on factors `U` under
    torch.cuda.set_sync_debug_mode("error"): it raises if anything in the
    sweep waits on the host.  Returns the host ms to enqueue it."""
    import torch

    from splatt_tpu_torch.cpd import _mttkrp_closure, _sweep
    from splatt_tpu_torch.ops.linalg import check_solver, gram

    do_mttkrp = _mttkrp_closure(bs, bs.device, U[0].dtype, False)

    def run():
        facs = [u.clone() for u in U]
        return _sweep(do_mttkrp, facs, [gram(u) for u in facs], False, 0.0)

    run()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        run()
        host_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check_solver()
    log(f"{tag} one sweep under set_sync_debug_mode('error'): no host "
        f"sync; enqueued in {host_ms:.3f} ms")
    return host_ms


#: f64 outside the tensor cores (NVIDIA H100 SXM data sheet), the rate of
#: sym_eig's f64 instantiation
F64_FLOP_PER_S = 34e12
#: the sym_eig kernel's tolerances against its plain version and eigh,
#: relative to the largest entry: (w, the pseudo-inverse operator)
EIG_TOL = {"float32": (1e-5, 1e-4), "float64": (1e-12, 1e-10)}
#: the NELL-2 solve summed over modes, and the iteration, with
#: torch.linalg.eigh in the solve (this script's phase 5 on an H100 80GB
#: HBM3 at 700 W, before the eigensolver kernel)
EIGH_SOLVE_MS = 4.901
EIGH_ITER_MS = 17.01
#: ring_gather per launch when every step scanned all of a rank's ids
#: (phase 11's mean over the legs in an earlier run of this script, same
#: card model, before the owner buckets): printed in the log for
#: comparison, never in the kernels line
SCAN_GATHER_MS = 5.0062


def _flop_rate(dtype) -> float:
    return (F32_FLOP_PER_S if str(dtype).endswith("float32")
            else F64_FLOP_PER_S)


def eig_bound(A) -> tuple:
    """(ms, by) least time of the symmetric eigendecomposition with
    vectors of the (R, R) `A` on the whole card: A read once and (w, V)
    written once over the HBM rate, against the 9 R^3 operations of
    tridiagonalisation and the symmetric QR algorithm with vectors (Golub
    and Van Loan) over the dtype's peak rate outside the tensor cores."""
    R = int(A.shape[0])
    return least_ms((2 * R * R + R) * A.element_size(), 9 * R ** 3,
                    _flop_rate(A.dtype))


def eig_algo_sm_ms(R: int, sweeps: int, dtype, sms: int) -> float:
    """Least ms of the Jacobi sweeps this matrix needed in one CTA: 9 n^2
    operations per round (6 per element of A, 3 per element of V) over
    n - 1 rounds, at one SM's share of the dtype's peak rate.  A bound of
    the kernel's algorithm on its one SM, not of the function."""
    n = R + (R & 1)
    ops = sweeps * (n - 1) * 9 * n * n
    return ops / (_flop_rate(dtype) / sms) * 1e3


def phase_sym_eig(bs, U, tag: str = "[eig]") -> list:
    """The sym_eig kernel on each mode's normal-equations matrix of the
    final factors `U`, f32 (as the sweep runs it) and f64: against its
    plain version and torch.linalg.eigh of the matrix in f64 (sorted w
    and the pseudo-inverse operator within EIG_TOL; the distance to
    cuSOLVER's eigh in the matrix's own dtype is recorded beside, as
    ``eigh_same_dtype_rel_err``), timed beside its bound, the plain
    version and the library call (eigh in the matrix's dtype, its host
    sync included)."""
    import torch

    from splatt_tpu_torch.ops import linalg

    sms = torch.cuda.get_device_properties(bs.device).multi_processor_count
    grams = [linalg.gram(u) for u in U]

    def op(w, v, dtype):
        """V diag(w_inv) Vᵀ with the cut of the solve in `dtype`."""
        tol = torch.finfo(dtype).eps ** 0.5 * w.abs().max()
        return (v * torch.where(w.abs() > tol, 1.0 / w,
                                torch.zeros_like(w))) @ v.T

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    rows = []
    for dtype in (torch.float32, torch.float64):
        w_tol, op_tol = EIG_TOL[str(dtype).replace("torch.", "")]
        for m in range(bs.nmodes):
            A = linalg.form_normal_lhs(grams, m).to(dtype)
            R = int(A.shape[0])
            w, v, sweeps = linalg.sym_eig(A, return_sweeps=True)
            wp, vp, sweeps_plain = linalg.sym_eig_plain(A)
            we, ve = torch.linalg.eigh(A.double())
            w_same = torch.linalg.eigh(A)[0]
            torch.cuda.synchronize()
            linalg.check_solver()
            row = dict(mode=m, dtype=str(dtype), R=R, sweeps=int(sweeps),
                       sweeps_plain=sweeps_plain,
                       max_abs_err=float((w - wp).abs().max()),
                       max_rel_err=rel(w, wp),
                       op_rel_err=rel(op(w, v, dtype), op(wp, vp, dtype)),
                       eigh_rel_err=rel(w.double(), we),
                       eigh_op_rel_err=rel(op(w, v, dtype).double(),
                                           op(we, ve, dtype)),
                       eigh_same_dtype_rel_err=rel(w, w_same),
                       eigh_same_dtype_exact_rel_err=rel(w_same.double(),
                                                         we))
            if not (row["max_rel_err"] <= w_tol and row["eigh_rel_err"]
                    <= w_tol and row["op_rel_err"] <= op_tol
                    and row["eigh_op_rel_err"] <= op_tol):
                raise AssertionError(f"sym_eig mode {m} {dtype}: {row}")
            row.update(ms=time_ms(lambda: linalg.sym_eig(A), reps=20,
                                  warmup=2),
                       plain_ms=time_ms(lambda: linalg.sym_eig_plain(A),
                                        reps=1),
                       library_ms=time_ms(lambda: torch.linalg.eigh(A),
                                          reps=20, warmup=2),
                       algo_sm_bound_ms=eig_algo_sm_ms(R, int(sweeps),
                                                       dtype, sms))
            row["bound_ms"], row["bound_by"] = eig_bound(A)
            log(f"{tag} sym_eig {json.dumps(row)}")
            rows.append(row)
    return rows


#: ranks of the eigensolver's scaling probe, up to the gate's f32 limit
EIG_SCALING_RANKS = (16, 32, 64, 96, 128, 168)


def sym_eig_scaling(seed: int = 21) -> list:
    """sym_eig against torch.linalg.eigh per call on a random SPD f32
    matrix (eigenvalues in [1, 10]) at each of EIG_SCALING_RANKS, the
    kernel held to the matrix's f64 eigh as in phase_sym_eig."""
    import torch

    from splatt_tpu_torch.ops import linalg

    rng = np.random.default_rng(seed)
    rows = []
    for R in EIG_SCALING_RANKS:
        Q, _ = np.linalg.qr(rng.standard_normal((R, R)))
        A = torch.from_numpy((Q * rng.uniform(1.0, 10.0, R)) @ Q.T).to(
            "cuda", torch.float32)
        A = (A + A.T) / 2
        w, _, sweeps = linalg.sym_eig(A, return_sweeps=True)
        exact = torch.linalg.eigh(A.double())[0]
        torch.cuda.synchronize()
        linalg.check_solver()
        err = float((w.double() - exact).abs().max() / exact.abs().max())
        if not err <= EIG_TOL["float32"][0]:
            raise AssertionError(f"sym_eig at R = {R}: w off by {err:.3e}")
        row = dict(R=R, sweeps=int(sweeps), rel_err=err,
                   threads=linalg.sym_eig_threads(R),
                   ms=time_ms(lambda: linalg.sym_eig(A), reps=20, warmup=2),
                   eigh_ms=time_ms(lambda: torch.linalg.eigh(A), reps=20,
                                   warmup=2))
        rows.append(row)
    log(f"[eig] sym_eig and eigh per call by rank, f32: {json.dumps(rows)}")
    return rows


def eig_gate(R: int) -> dict:
    """The eigensolver's static gate at rank R in f32, printed."""
    import torch

    from splatt_tpu_torch.ops import kernels, linalg

    fits = linalg.sym_eig_fits(R, torch.float32)
    takes = linalg.solve_takes_sym_eig(R, torch.float32)
    gate = dict(R=R, dtype="float32", fits=fits, solve_takes_sym_eig=takes,
                solve_max_rank=linalg.SYM_EIG_SOLVE_MAX_RANK,
                smem_bytes=linalg.sym_eig_smem_bytes(R, 4),
                smem_limit=kernels.SMEM_TILE_BYTES)
    log(f"[eig] gate at R = {R}: {json.dumps(gate)}; "
        + ("the sym_eig kernel runs" if takes else
           "the solve keeps torch.linalg.eigh and its host sync "
           "(ROADMAP.md, queue C): "
           + ("above the rank where the kernel stops winning" if fits else
              "A and V do not fit one CTA's shared memory")))
    return gate


def phase_new_kernels(bs, rank: int, seed: int = 1, gathers: bool = True,
                      reductions: bool = True) -> dict:
    """The other four kernels against their plain versions on the phase-3
    layouts and factors, timed beside their bounds: the fused_mttkrp_tg
    and fused_mttkrp rows (`gathers`) and the two reductions'
    (`reductions`), the full contract also on ids that are all `width`
    (every flush dropped: the walk without its atomics)."""
    import torch

    from splatt_tpu_torch.ops import kernels
    from splatt_tpu_torch.ops.mttkrp import FUSED_CHUNK, _gather_prod

    dev = bs.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    factors = random_factors(bs, rank, seed)
    rows = {k: [] for k in ("fused_mttkrp_tg", "fused_mttkrp",
                            "onehot_reduce_sorted", "onehot_reduce_full")}
    for contract, lay, width, acc, m in contracts(bs):
        where = dict(contract=contract, mode=m, layout_mode=lay.mode,
                     width=width)
        # fused_mttkrp at its engine's chunk; also timed at the chunk that
        # cuts the grid to 8 CTAs per SM, the evidence for FUSED_CHUNK
        wide = -(-lay.nblocks // (8 * sms))
        fused = (("fused_mttkrp_tg", kernels.fused_mttkrp_tg,
                  kernels.fused_mttkrp_tg_plain, {}),
                 ("fused_mttkrp", kernels.fused_mttkrp,
                  kernels.fused_mttkrp_plain, {"chunk": FUSED_CHUNK}))
        for name, fn, plain, kw in (fused if gathers else ()):
            got, row = compare(
                lambda: fn(lay, factors, m, width, acc, **kw),
                lambda: plain(lay, factors, m, width, acc),
                f"{name} {contract} mode {m}")
            row.update(where, **kw)
            if kw:
                row["wide_chunk"] = wide
                row["wide_chunk_ms"] = time_ms(
                    lambda: fn(lay, factors, m, width, acc, chunk=wide),
                    reps=20, warmup=2)
            row["bound_ms"], row["bound_by"] = bound(lay, factors, m, got)
            row["requested_bytes"] = requested_bytes(
                lay, factors, m, kernels.tg_rank_tile(rank)
                if name == "fused_mttkrp_tg" else rank)
            row["requested_tb_s"] = gather_rate(row["requested_bytes"],
                                             row["ms"])
            log(f"[kernel] {name} {json.dumps(row)}")
            rows[name].append(row)
            del got
        if not reductions:
            continue
        # the reductions: the products once per case, and the flat ids
        # of the one index_add_ call that computes the same sum
        nb, B = lay.nblocks, lay.block
        prod = _gather_prod(lay.inds, lay.vals, factors,
                            m).reshape(nb, B, rank)
        if acc:
            name, fn, plain = ("onehot_reduce_full",
                               kernels.onehot_reduce_full,
                               kernels.onehot_reduce_full_plain)
            ids = lay.mode_ids(m).reshape(nb, B)
            flat, nrows = ids.long(), width
        else:
            name, fn, plain = ("onehot_reduce_sorted",
                               kernels.onehot_reduce_sorted,
                               kernels.onehot_reduce_sorted_plain)
            ids = lay.blocked_locals()
            flat = ids.long() + (torch.arange(nb, device=dev)[:, None]
                                 * width)
            nrows = nb * width
        ok = (ids >= 0) & (ids < width)
        flat = torch.where(ok, flat, torch.full_like(flat, nrows))
        flat = flat.reshape(-1)
        got, row = compare(lambda: fn(ids, prod, width),
                           lambda: plain(ids, prod, width),
                           f"{name} {contract} mode {m}")
        lib = torch.zeros((nrows + 1, rank), dtype=torch.float32,
                          device=dev)
        prod2 = prod.reshape(-1, rank)
        row["library_ms"] = time_ms(
            lambda: lib.zero_().index_add_(0, flat, prod2), reps=5)
        row.update(where)
        row["bound_ms"], row["bound_by"] = reduce_bound(ids, prod, got,
                                                        lay.nnz)
        if hasattr(kernels, "reduce_rank_tile"):
            row["rank_tile"] = kernels.reduce_rank_tile(rank)
        if acc:
            # the same launch with every id `width`: the walk streams the
            # same products and drops every flush
            none = torch.full_like(ids, width)
            if float(fn(none, prod, width).abs().max()) != 0.0:
                raise AssertionError(f"{name}: ids of {width} added")
            row["no_flush_ms"] = time_ms(lambda: fn(none, prod, width),
                                         reps=20, warmup=2)
            del none
        log(f"[kernel] {name} {json.dumps(row)}")
        rows[name].append(row)
        del prod, prod2, got, lib, flat, ids
        torch.cuda.empty_cache()
    return rows


def small_layouts(dims, seed: int = 5):
    """ALLMODE layouts of a BIG_RANK_NNZ-nonzero synthetic tensor of
    `dims`, small enough for the plain versions at wide ranks (they need
    ~3 x nnz x R x 4 bytes)."""
    from splatt_tpu_torch import BlockedSparse, Options
    from splatt_tpu_torch.config import BlockAlloc

    t0 = time.perf_counter()
    bs = BlockedSparse.from_coo(synthetic_tensor(dims, BIG_RANK_NNZ, seed),
                                Options(block_alloc=BlockAlloc.ALLMODE))
    log(f"[layout] {dims}, {BIG_RANK_NNZ} nonzeros: layouts in "
        f"{time.perf_counter() - t0:.2f} s")
    return bs


def bf16_layouts(bs):
    """`bs` with its values stored in bf16."""
    import torch

    from splatt_tpu_torch.blocked import reencode_layout
    from splatt_tpu_torch.config import LayoutFormat

    return dataclasses.replace(bs, layouts=[
        reencode_layout(lay, LayoutFormat(val="bf16"),
                        val_dtype=torch.bfloat16) for lay in bs.layouts])


def phase_big_rank(bs, seed: int = 5) -> list:
    """fused_mttkrp_tg against its plain version at rank 512, both
    contracts on every mode, f32 and bf16 (values and tables), on the
    2M-nonzero layouts `bs` of the NELL-2 dims."""
    import torch

    from splatt_tpu_torch.ops import kernels

    f32 = random_factors(bs, BIG_RANK, seed)
    bs16 = bf16_layouts(bs)
    rows = []
    for dtype, X in ((torch.float32, bs), (torch.bfloat16, bs16)):
        factors = [U.to(dtype) for U in f32]
        for contract, lay, width, acc, m in contracts(X):
            got, row = compare(
                lambda: kernels.fused_mttkrp_tg(lay, factors, m, width,
                                                acc),
                lambda: kernels.fused_mttkrp_tg_plain(lay, factors, m,
                                                      width, acc),
                f"fused_mttkrp_tg rank {BIG_RANK} {dtype} {contract} "
                f"mode {m}", reps=5, plain_reps=1)
            row.update(dtype=str(dtype), contract=contract, mode=m,
                       layout_mode=lay.mode, width=width, nnz=lay.nnz)
            row["bound_ms"], row["bound_by"] = bound(lay, factors, m, got)
            # the kernel's own traffic: each rank tile re-reads the id and
            # value streams
            rtile = kernels.tg_rank_tile(BIG_RANK)
            tiles = -(-BIG_RANK // rtile)
            streams = nbytes(lay.inds, lay.vals, lay.row_start)
            row["rank_tiles"] = tiles
            row["tiled_bytes_ms"] = least_ms(
                streams * tiles + nbytes(got) + nbytes(
                    *(U for k, U in enumerate(factors) if k != m)), 0)[0]
            row["requested_bytes"] = requested_bytes(lay, factors, m, rtile)
            row["requested_tb_s"] = gather_rate(row["requested_bytes"],
                                             row["ms"])
            log(f"[rank{BIG_RANK}] fused_mttkrp_tg {json.dumps(row)}")
            rows.append(row)
            del got
            torch.cuda.empty_cache()
    return rows


KERNEL_FAULTS = ("engine.fused_t:runtime,engine.fused_tg:runtime,"
                 "engine.fused:runtime,engine.unfused_pallas:runtime")

#: phase 7: (label, armed faults, SPLATT_EXPERIMENTAL_FUSED, privatize
#: mode 0, engines demoted, launches of each kernel, unlisted = 0)
#: phase 7's schedule that runs fused_mttkrp on a full CPD
FUSED_CHAIN = "fused_t, fused_tg faulted, experimental fused"
#: phase 7's schedules that run the reductions on a full CPD: every mode
#: sorted, and mode 0 privatized (the full contract)
SORTED_CHAIN = "fused_t, fused_tg faulted"
FULL_CHAIN = "fused_t, fused_tg faulted, mode 0 privatized"
CHAIN_SCHEDULES = [
    ("no fault", "", False, False, [], {"fused_mttkrp_t": 9}),
    ("fused_t faulted", "engine.fused_t:runtime", False, False,
     ["fused_t"], {"fused_mttkrp_tg": 9}),
    (SORTED_CHAIN,
     "engine.fused_t:runtime,engine.fused_tg:runtime", False, False,
     ["fused_t", "fused_tg"], {"onehot_reduce_sorted": 9}),
    (FUSED_CHAIN, "engine.fused_t:runtime,engine.fused_tg:runtime", True,
     False,
     ["fused_t", "fused_tg"], {"fused_mttkrp": 9}),
    (FULL_CHAIN,
     "engine.fused_t:runtime,engine.fused_tg:runtime", False, True,
     ["fused_t", "fused_tg"],
     {"onehot_reduce_full": 3, "onehot_reduce_sorted": 6}),
]

#: phase 7: schedules under which cpd_als must raise, no kernel launched:
#: (label, armed faults, SPLATT_EXPERIMENTAL_FUSED, engine fallback,
#: engines demoted, site named by the error)
RAISING_SCHEDULES = [
    ("every kernel engine faulted, experimental fused", KERNEL_FAULTS, True,
     True, ["fused_t", "fused_tg", "fused"], "engine.unfused_pallas"),
    ("every kernel engine faulted", KERNEL_FAULTS, False, True,
     ["fused_t", "fused_tg"], "engine.unfused_pallas"),
    ("fused_t faulted, fallback off", "engine.fused_t:runtime", False,
     False, [], "engine.fused_t"),
]


#: --gather: the unfaulted schedule (the reference) and FUSED_CHAIN
GATHER_CHAIN = [s for s in CHAIN_SCHEDULES
                if s[0] in ("no fault", FUSED_CHAIN)]
#: --reduce: the unfaulted schedule (the reference), SORTED_CHAIN and
#: FULL_CHAIN
REDUCE_CHAIN = [s for s in CHAIN_SCHEDULES
                if s[0] in ("no fault", SORTED_CHAIN, FULL_CHAIN)]


def phase_chain(bs, rank: int, schedules=CHAIN_SCHEDULES,
                raising=RAISING_SCHEDULES) -> dict:
    """cpd_als at full width under each of `schedules` (demotions,
    launch counts, fits and λ against the first, unfaulted run, each
    mode's MTTKRP through the engines left against fused_mttkrp_t's) and
    `raising` (cpd_als raises)."""
    import dataclasses
    import os

    import torch

    from splatt_tpu_torch import Options, cpd_als, mttkrp, resilience
    from splatt_tpu_torch.config import BlockAlloc, Verbosity
    from splatt_tpu_torch.ops import kernels
    from splatt_tpu_torch.ops.mttkrp import describe_plan
    from splatt_tpu_torch.utils import faults

    rng = np.random.default_rng(9)
    init = [rng.random((d, rank)) for d in bs.dims]
    plan_factors = [torch.as_tensor(U, dtype=torch.float32, device=bs.device)
                    for U in init]
    # mode 0 on mode 1's layout, short enough to privatize: the
    # accumulate contract on a full CPD
    priv = dataclasses.replace(
        bs, mode_map={0: 1, 1: 1, 2: 2},
        opts=Options(block_alloc=BlockAlloc.ALLMODE, priv_cap=1 << 15,
                     priv_threshold=1.0))

    def reset():
        faults.reset()
        resilience.reset_demotions()
        resilience.run_report().clear()
        kernels.reset_launches()

    def run(X, schedule: str, experimental: bool, fallback: bool):
        reset()
        for site, spec in faults.parse_schedule(schedule).items():
            faults.arm(site, spec)
        if experimental:
            os.environ["SPLATT_EXPERIMENTAL_FUSED"] = "1"
        try:
            opts = Options(max_iterations=CHAIN_ITERS, tolerance=0.0,
                           verbosity=Verbosity.NONE,
                           engine_fallback=fallback)
            t0 = time.perf_counter()
            out = cpd_als(X, rank, opts, init=init)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0
        finally:
            faults.reset()

    def demoted_now():
        return [e["engine"] for e in
                resilience.run_report().events("engine_demotion")]

    def launches_now():
        return {k.__name__: k.launches for k in kernels.KERNELS}

    plan = describe_plan(bs, plan_factors)
    log(f"[chain] {plan}")
    if plan.count("sorted_onehot/fused_t") != bs.nmodes:
        raise AssertionError(f"unfaulted plan is not fused_t: {plan}")
    priv_plan = describe_plan(priv, plan_factors)
    log(f"[chain] mode 0 privatized: {priv_plan}")
    if "mode0=privatized/fused_t" not in priv_plan:
        raise AssertionError(f"mode 0 not privatized: {priv_plan}")
    # each mode's MTTKRP on fused_mttkrp_t, the reference of every engine
    reset()
    ref = [mttkrp(bs, plan_factors, m) for m in range(bs.nmodes)]
    base = None
    runs = []
    for label, schedule, experimental, privatize, demoted, want in \
            schedules:
        X = priv if privatize else bs
        try:
            out, seconds = run(X, schedule, experimental, True)
            launches = launches_now()
            got_demoted = demoted_now()
            # the engines the run was left with, on the reference factors
            mttkrp_err = 0.0
            for m in range(bs.nmodes):
                got = mttkrp(X, plan_factors, m)
                mttkrp_err = max(mttkrp_err, float(
                    (got - ref[m]).abs().max() / ref[m].abs().max()))
            plan_after = describe_plan(X, plan_factors)
        finally:
            os.environ.pop("SPLATT_EXPERIMENTAL_FUSED", None)
        if base is None:
            base = out
        fit_diff = max(abs(a - b) for a, b in zip(out.fits, base.fits))
        lam_diff = float((out.lam - base.lam).abs().max()
                         / base.lam.abs().max())
        row = dict(schedule=label, faults=schedule, demoted=got_demoted,
                   launches=launches, fits=list(out.fits),
                   max_fit_diff=fit_diff, lambda_rel_diff=lam_diff,
                   mttkrp_rel_err=mttkrp_err, seconds=seconds,
                   sec_per_iter=sum(out.iter_seconds[1:])
                   / (len(out.iter_seconds) - 1),
                   plan_after=plan_after)
        log(f"[chain] {json.dumps(row)}")
        if got_demoted != demoted:
            raise AssertionError(f"{label}: demoted {got_demoted}, "
                                 f"expected {demoted}")
        expect = {k.__name__: want.get(k.__name__, 0)
                  for k in kernels.KERNELS}
        if launches != expect:
            raise AssertionError(f"{label}: launches {launches}, expected "
                                 f"{expect}")
        if len(out.fits) != CHAIN_ITERS or not fit_diff <= PARITY_TOL:
            raise AssertionError(f"{label}: fits {out.fits} against "
                                 f"{base.fits}")
        if not lam_diff <= LAMBDA_TOL:
            raise AssertionError(f"{label}: λ differs from the unfaulted "
                                 f"run's by {lam_diff:.3e} (relative)")
        if not mttkrp_err <= KERNEL_TOL:
            raise AssertionError(f"{label}: MTTKRP differs from "
                                 f"fused_mttkrp_t's by {mttkrp_err:.3e}")
        runs.append(row)
    for label, schedule, experimental, fallback, demoted, site in \
            raising:
        try:
            run(bs, schedule, experimental, fallback)
        except RuntimeError as e:
            err = e
        else:
            raise AssertionError(f"{label}: cpd_als did not raise")
        finally:
            os.environ.pop("SPLATT_EXPERIMENTAL_FUSED", None)
        row = dict(schedule=label, faults=schedule, fallback=fallback,
                   demoted=demoted_now(), launches=launches_now(),
                   raised=repr(err))
        log(f"[chain] {json.dumps(row)}")
        if site not in str(err):
            raise AssertionError(f"{label}: raised {err!r}, not the fault "
                                 f"at {site}")
        if row["demoted"] != demoted:
            raise AssertionError(f"{label}: demoted {row['demoted']}, "
                                 f"expected {demoted}")
        if any(row["launches"].values()):
            raise AssertionError(f"{label}: launches {row['launches']}")
        runs.append(row)
    reset()
    return {r["schedule"]: r for r in runs}


def walk_tensors(nell2) -> dict:
    """The layout sets phase_walk checks: the 2M-nonzero NELL-2 layouts
    `nell2`, and as many nonzeros over a 2-mode and a 4-mode shape."""
    return {"nell2": nell2, "two_mode": small_layouts(TWO_MODE_DIMS, 6),
            "enron4": small_layouts(ENRON4, 7)}


def phase_walk(tensors: dict) -> dict:
    """fused_mttkrp_t and fused_mttkrp (at each chunk of WALK_CHUNKS)
    against their plain version at every rank of WALK_RANKS, f32 and bf16
    values and tables, both contracts on every mode of each layout set in
    `tensors` (label -> 2M-nonzero layouts); returns the largest relative
    error of each kernel and the launches checked."""
    import torch

    from splatt_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    worst = {"fused_mttkrp_t": 0.0, "fused_mttkrp": 0.0}
    checked = 0
    for label, bs in tensors.items():
        for dtype in (torch.float32, torch.bfloat16):
            X = bs if dtype == torch.float32 else bf16_layouts(bs)
            for rank in WALK_RANKS:
                factors = [U.to(dtype) for U in random_factors(bs, rank,
                                                               rank)]
                for contract, lay, width, acc, m in contracts(X):
                    want = kernels.fused_mttkrp_t_plain(lay, factors, m,
                                                        width, acc)
                    runs = [("fused_mttkrp_t", None)] + [
                        ("fused_mttkrp", c) for c in WALK_CHUNKS]
                    for name, chunk in runs:
                        got = (kernels.fused_mttkrp_t(lay, factors, m, width,
                                                      acc) if chunk is None
                               else kernels.fused_mttkrp(
                                   lay, factors, m, width, acc, chunk=chunk))
                        rel = check_close(
                            f"{name} {label} {dtype} rank {rank} chunk "
                            f"{chunk} {contract} mode {m}", got, want)
                        worst[name] = max(worst[name], rel)
                        checked += 1
                        del got
                    del want
            del X
            torch.cuda.empty_cache()
    out = dict(max_rel_err=worst, launches_checked=checked,
               ranks=list(WALK_RANKS), chunks=list(WALK_CHUNKS),
               tensors={k: list(v.dims) for k, v in tensors.items()},
               seconds=time.perf_counter() - t0)
    log(f"[walk] fused_mttkrp_t and fused_mttkrp against plain: "
        f"{json.dumps(out)}")
    return out


def wide_rank_turns(bs, ranks=ODD_RANKS + WIDE_RANKS, seed: int = 2
                    ) -> list:
    """fused_mttkrp_t (the whole rank in one tile) and fused_mttkrp_tg
    (tiles of 128) on each mode's sorted launch at each of `ranks`, in
    turns, fused_t's output held to fused_tg's; each with its requested
    sectors' rate."""
    from splatt_tpu_torch.ops import kernels

    rows = []
    for rank in ranks:
        factors = random_factors(bs, rank, seed)
        for m in range(bs.nmodes):
            lay = bs.layout_for(m)
            w = lay.seg_width
            fns = {"fused_t": lambda: kernels.fused_mttkrp_t(
                       lay, factors, m, w, False),
                   "fused_tg": lambda: kernels.fused_mttkrp_tg(
                       lay, factors, m, w, False)}
            rel = check_close(f"fused_t against fused_tg rank {rank} mode "
                              f"{m}", fns["fused_t"](), fns["fused_tg"]())
            turns = in_turns(fns, reps=5)
            for k, rtile in (("fused_t", rank),
                             ("fused_tg", kernels.tg_rank_tile(rank))):
                turns[k]["requested_bytes"] = requested_bytes(
                    lay, factors, m, rtile)
                turns[k]["requested_tb_s"] = gather_rate(
                    turns[k]["requested_bytes"], turns[k]["ms"])
            row = dict(rank=rank, mode=m, rel_t_to_tg=rel,
                       t_over_tg=turns["fused_t"]["ms"]
                       / turns["fused_tg"]["ms"], turns=turns)
            log(f"[wide] sorted launch in turns {json.dumps(row)}")
            rows.append(row)
        del factors
    return rows


def v1_fits(bs, rank: int) -> dict:
    """Phase 5's CPD (the v1 layouts, its options and seed) for
    --gather and --ranks, which skip phase 5: its fits (phase 9's auto
    CPD is held to them), its fused_mttkrp_t launches, its steady
    seconds per iteration and its final factors."""
    import torch

    from splatt_tpu_torch import Options, cpd_als
    from splatt_tpu_torch.config import BlockAlloc, Verbosity
    from splatt_tpu_torch.ops import kernels

    opts = Options(block_alloc=BlockAlloc.ALLMODE, max_iterations=ITERS,
                   tolerance=0.0, random_seed=0, engine_fallback=False,
                   verbosity=Verbosity.NONE)
    kernels.reset_launches()
    out = cpd_als(bs, rank, opts)
    torch.cuda.synchronize()
    launches = kernels.fused_mttkrp_t.launches
    steady = sum(out.iter_seconds[1:]) / (len(out.iter_seconds) - 1)
    log(f"[cpd] phase 5's CPD: fits {list(out.fits)}; fused_mttkrp_t "
        f"launches {launches}; {steady * 1e3:.3f} ms/iteration "
        f"(iterations 2..{ITERS})")
    return {"fits": list(out.fits), "launches": launches,
            "sec_per_iter": steady, "factors": out.factors}


def in_turns(fns: dict, reps: int) -> dict:
    """Each of `fns` (label -> callable) timed in turns: in order, then in
    reverse (a, b, c, c, b, a); the mean of its two runs."""
    order = list(fns)
    runs = {k: [] for k in order}
    for k in order + order[::-1]:
        runs[k].append(time_ms(fns[k], reps=reps, warmup=2))
    return {k: dict(ms=sum(v) / len(v), runs=v) for k, v in runs.items()}


def check_close(label: str, got, want) -> float:
    """`got` against `want` on the same inputs, <= KERNEL_TOL of
    max|want|; returns the relative difference."""
    import torch

    torch.cuda.synchronize()
    scale = float(want.abs().max())
    rel = float((got - want).abs().max()) / (scale if scale > 0 else 1.0)
    if not rel <= KERNEL_TOL:
        raise AssertionError(f"{label}: relative difference {rel:.3e} > "
                             f"{KERNEL_TOL}")
    return rel


def tg_tile_turns(lay, factors, m: int, want) -> dict:
    """fused_mttkrp_tg on one sorted launch at rank 512 at each rank tile
    of PROBE_TILES, in turns, each checked against the shipped tile's
    output `want` (which is held against the plain version elsewhere)."""
    from splatt_tpu_torch.ops import kernels

    w = lay.seg_width
    fns = {f"tile {t}": (lambda t=t: kernels.fused_tg_launch(
        lay, factors, m, w, False, t)) for t in PROBE_TILES}
    rel = {k: check_close(k, fn(), want) for k, fn in fns.items()}
    turns = in_turns(fns, reps=5)
    for k in turns:
        turns[k]["rel_to_shipped"] = rel[k]
    log(f"[rank{BIG_RANK}] fused_mttkrp_tg mode {m} rank tiles in turns: "
        f"{json.dumps(turns)}")
    return turns


def phase_rank512(bs, tiles: bool = False) -> dict:
    """cpd_als at rank 512 on the phase-3 layouts: fused_tg on every
    mode, no fault, no demotion; then each mode's launch alone, beside
    the sectors it requests, the library gather yardstick, on zeroed
    gather ids and in bf16, and with `tiles` (``--gather``) at each rank
    tile of PROBE_TILES in turns."""
    import torch

    from splatt_tpu_torch import Options, cpd_als, resilience
    from splatt_tpu_torch.blocked import reencode_layout
    from splatt_tpu_torch.config import LayoutFormat, Verbosity
    from splatt_tpu_torch.ops import kernels
    from splatt_tpu_torch.ops.mttkrp import describe_plan

    rng = np.random.default_rng(12)
    init = [rng.random((d, BIG_RANK)) for d in bs.dims]
    plan = describe_plan(bs, [torch.as_tensor(U, dtype=torch.float32,
                                              device=bs.device)
                              for U in init])
    log(f"[rank{BIG_RANK}] {plan}")
    if plan.count("sorted_onehot/fused_tg") != bs.nmodes:
        raise AssertionError(f"rank {BIG_RANK} plan is not fused_tg: {plan}")
    resilience.reset_demotions()
    kernels.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    opts = Options(max_iterations=CHAIN_ITERS, tolerance=0.0,
                   verbosity=Verbosity.NONE, engine_fallback=False)
    out = cpd_als(bs, BIG_RANK, opts, init=init)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = kernels.fused_mttkrp_tg.launches
    steady = sum(out.iter_seconds[1:]) / (len(out.iter_seconds) - 1)
    log(f"[rank{BIG_RANK}] fits {list(out.fits)}; iteration seconds "
        f"{list(out.iter_seconds)}; {steady:.5f} s/iteration (iterations "
        f"2..{CHAIN_ITERS}); peak device memory {peak / 2**30:.2f} GiB; "
        f"fused_mttkrp_tg launches {launches}")
    if resilience.demotions():
        raise AssertionError(f"demotions at rank {BIG_RANK}")
    if launches != bs.nmodes * CHAIN_ITERS:
        raise AssertionError(f"fused_mttkrp_tg launched {launches} times")
    if not (math.isfinite(out.fit) and 0.0 < out.fit <= 1.0):
        raise AssertionError(f"fit {out.fit} is not finite in (0, 1]")
    # the kernel alone at this width, per mode, on the final factors,
    # beside its bound, the bytes its rank tiles stream, the bytes it
    # gathers and the rate they imply; then on a copy of the layout whose
    # gathered ids are all 0 (every gather hits one row: the kernel
    # without its wait on gathers), and with bf16 values and tables
    kernel = []
    rtile = kernels.tg_rank_tile(BIG_RANK)
    tiles = -(-BIG_RANK // rtile)
    f16 = [U.to(torch.bfloat16) for U in out.factors]
    for m in range(bs.nmodes):
        lay = bs.layout_for(m)

        def launch():
            return kernels.fused_mttkrp_tg(lay, out.factors, m,
                                           lay.seg_width, False)

        got = launch()
        row = dict(mode=m, ms=time_ms(launch, reps=5))
        row["bound_ms"], row["bound_by"] = bound(lay, out.factors, m, got)
        row["tiled_bytes_ms"] = least_ms(
            nbytes(lay.inds, lay.vals, lay.row_start) * tiles + nbytes(got)
            + nbytes(*(U for k, U in enumerate(out.factors) if k != m)),
            0)[0]
        row["requested_bytes"] = requested_bytes(lay, out.factors, m, rtile)
        row["requested_tb_s"] = gather_rate(row["requested_bytes"], row["ms"])
        zero = dataclasses.replace(lay, inds=torch.where(
            (torch.arange(bs.nmodes, device=lay.inds.device) == m)[:, None],
            lay.inds, torch.zeros_like(lay.inds)))
        row["zero_ids_ms"] = time_ms(
            lambda: kernels.fused_tg_launch(zero, out.factors, m,
                                            lay.seg_width, False, rtile),
            reps=5, warmup=2)
        del zero
        lay16 = reencode_layout(lay, LayoutFormat(val="bf16"),
                                val_dtype=torch.bfloat16)
        row["bf16_ms"] = time_ms(
            lambda: kernels.fused_mttkrp_tg(lay16, f16, m, lay.seg_width,
                                            False), reps=5, warmup=2)
        row["bf16_requested_bytes"] = requested_bytes(lay16, f16, m, rtile)
        row["bf16_requested_tb_s"] = gather_rate(row["bf16_requested_bytes"],
                                              row["bf16_ms"])
        row["bf16_bound_ms"] = bound(lay16, f16, m, got)[0]
        kernel.append(row)
        if tiles:
            row["tiles"] = tg_tile_turns(lay, out.factors, m, got)
        del got, lay16
        torch.cuda.empty_cache()
    log(f"[rank{BIG_RANK}] fused_mttkrp_tg per sorted launch by mode "
        f"{json.dumps(kernel)}")
    gate = eig_gate(BIG_RANK)
    parts = sweep_phases(bs, out.factors, steady, f"[rank{BIG_RANK}]")
    return {"launches": launches, "sec_per_iter": steady, "eig_gate": gate,
            "peak_gib": peak / 2**30, "fits": list(out.fits),
            "kernel": kernel, "phases": parts}


def v2_bound(layout, factors, mode: int, out) -> tuple:
    """Least time in ms for one fused_mttkrp_v2 call: the encoded streams,
    bases and values read once, the gathered tables read once and the
    output written once, against nmodes x R FLOP per real nonzero."""
    moved = nbytes(*layout.inds, *layout.base, layout.vals, out)
    moved += nbytes(*(U for k, U in enumerate(factors) if k != mode))
    return least_ms(moved, layout.nmodes * int(factors[0].shape[1])
                    * layout.nnz)


def phase_format(bs, rank: int, main_fits: list, seed: int = 1) -> dict:
    """Phase 9: the v2 encodings and bf16 storage at full width."""
    import dataclasses

    import torch

    from splatt_tpu_torch import BlockedSparse, Options, cpd_als, resilience
    from splatt_tpu_torch.blocked import reencode_layout
    from splatt_tpu_torch.config import BlockAlloc, LayoutFormat, Verbosity
    from splatt_tpu_torch.ops import kernels
    from splatt_tpu_torch.ops.mttkrp import describe_plan

    factors = random_factors(bs, rank, seed)
    storage = {"v1": {f"mode{lay.mode}": lay.storage_bytes()
                      for lay in bs.layouts}}
    encoded = {}
    for idx in ENCODINGS:
        t0 = time.perf_counter()
        lays = [reencode_layout(lay, LayoutFormat(idx=idx))
                for lay in bs.layouts]
        torch.cuda.synchronize()
        if any(lay.encoding != "v2" for lay in lays):
            raise AssertionError(f"{idx}: a layout fell back to v1")
        encoded[idx] = dataclasses.replace(bs, layouts=lays)
        storage[idx] = {f"mode{lay.mode}": lay.storage_bytes()
                        for lay in lays}
        log(f"[format] {idx}: re-encoded in {time.perf_counter() - t0:.2f} "
            f"s; " + " ".join(f"mode{lay.mode}={lay.format_desc()} "
                              f"{lay.storage_bytes()} B" for lay in lays))
    log(f"[format] v1: " + " ".join(
        f"mode{lay.mode}={lay.format_desc()} {lay.storage_bytes()} B"
        for lay in bs.layouts))

    # fused_mttkrp_v2 against its plain version, every encoding and contract
    v2_rows = []
    for idx in ENCODINGS:
        for contract, lay, width, acc, m in contracts(encoded[idx]):
            got, row = compare(
                lambda: kernels.fused_mttkrp_v2(lay, factors, m, width, acc),
                lambda: kernels.fused_mttkrp_v2_plain(lay, factors, m, width,
                                                      acc),
                f"fused_mttkrp_v2 {idx} {contract} mode {m}")
            row.update(encoding=idx, contract=contract, mode=m,
                       layout_mode=lay.mode, width=width,
                       format=lay.format_desc())
            row["bound_ms"], row["bound_by"] = v2_bound(lay, factors, m, got)
            row["requested_bytes"] = requested_bytes(lay, factors, m, rank)
            row["requested_tb_s"] = gather_rate(row["requested_bytes"],
                                             row["ms"])
            log(f"[format] fused_mttkrp_v2 {json.dumps(row)}")
            v2_rows.append(row)
            del got
        torch.cuda.empty_cache()
    # fused_mttkrp_t and fused_tg on the v1 layout (at R <= 128 the same
    # kernel on the same grid) and fused_v2 on auto (the walk with its
    # decode) in turns; each launch's requested sectors and the rate they
    # imply
    turns = []
    for m in range(bs.nmodes):
        v1, auto = bs.layout_for(m), encoded["auto"].layout_for(m)
        fns = {
            "fused_t_v1": lambda: kernels.fused_mttkrp_t(
                v1, factors, m, v1.seg_width, False),
            "fused_v2_auto": lambda: kernels.fused_mttkrp_v2(
                auto, factors, m, auto.seg_width, False),
            "fused_tg_v1": lambda: kernels.fused_mttkrp_tg(
                v1, factors, m, v1.seg_width, False)}
        ms = in_turns(fns, reps=20)
        moved = requested_bytes(v1, factors, m, rank)
        row = dict(mode=m, requested_bytes=moved,
                   fused_t_v1_ms=ms["fused_t_v1"]["ms"],
                   fused_v2_auto_ms=ms["fused_v2_auto"]["ms"],
                   t_over_tg=ms["fused_t_v1"]["ms"]
                   / ms["fused_tg_v1"]["ms"], turns=ms)
        for k in ms:
            ms[k]["requested_tb_s"] = gather_rate(moved, ms[k]["ms"])
        turns.append(row)
    log(f"[format] sorted launch in turns {json.dumps(turns)}")

    # bf16 values, tables and products through rows 1-6
    bf16 = {}
    fac16 = [U.to(torch.bfloat16) for U in factors]
    lays16 = [reencode_layout(lay, LayoutFormat(val="bf16"),
                              val_dtype=torch.bfloat16)
              for lay in bs.layouts]
    bs16 = dataclasses.replace(bs, layouts=lays16)
    auto16 = dataclasses.replace(bs, layouts=[
        reencode_layout(lay, LayoutFormat(idx="auto", val="bf16"),
                        val_dtype=torch.bfloat16) for lay in bs.layouts])
    fused = (("fused_mttkrp_t", kernels.fused_mttkrp_t,
              kernels.fused_mttkrp_t_plain, bs16),
             ("fused_mttkrp_tg", kernels.fused_mttkrp_tg,
              kernels.fused_mttkrp_tg_plain, bs16),
             ("fused_mttkrp", kernels.fused_mttkrp,
              kernels.fused_mttkrp_plain, bs16),
             ("fused_mttkrp_v2", kernels.fused_mttkrp_v2,
              kernels.fused_mttkrp_v2_plain, auto16))
    for name, fn, plain, X in fused:
        bf16[name] = []
        for contract, lay, width, acc, m in contracts(X):
            got, row = compare(lambda: fn(lay, fac16, m, width, acc),
                               lambda: plain(lay, fac16, m, width, acc),
                               f"{name} bf16 {contract} mode {m}")
            bound_fn = v2_bound if name == "fused_mttkrp_v2" else bound
            row["bound_ms"], row["bound_by"] = bound_fn(lay, fac16, m, got)
            row.update(contract=contract, mode=m)
            log(f"[format] {name} bf16 {json.dumps(row)}")
            bf16[name].append(row)
            del got
    bf16.update(bf16_reductions(bs16, fac16, rank))
    del bs16, auto16, lays16
    torch.cuda.empty_cache()

    # the full-width CPD on the auto layouts, from phase 5's seed
    X = encoded["auto"]
    plan = describe_plan(X, factors)
    log(f"[format] {plan}")
    if plan.count("sorted_onehot/fused_v2") != bs.nmodes:
        raise AssertionError(f"auto plan is not fused_v2: {plan}")
    opts = Options(block_alloc=BlockAlloc.ALLMODE, max_iterations=ITERS,
                   tolerance=0.0, random_seed=0, engine_fallback=False,
                   verbosity=Verbosity.NONE)
    resilience.reset_demotions()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    out = cpd_als(X, rank, opts)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    peak = torch.cuda.max_memory_allocated()
    steady = sum(out.iter_seconds[1:]) / (len(out.iter_seconds) - 1)
    fit_diff = max(abs(a - b) for a, b in zip(out.fits, main_fits))
    log(f"[format] auto cpd fits {list(out.fits)} (phase 5 {main_fits}); "
        f"max |difference| {fit_diff:.3e}; iteration seconds "
        f"{list(out.iter_seconds)}; {steady:.5f} s/iteration; peak "
        f"{peak / 2**30:.2f} GiB; launches {launches}")
    if resilience.demotions():
        raise AssertionError(f"demotions on the v2 path: "
                             f"{resilience.demotions()}")
    want = {k.__name__: 0 for k in kernels.KERNELS}
    want["fused_mttkrp_v2"] = bs.nmodes * ITERS
    if launches != want:
        raise AssertionError(f"v2 launches {launches}, expected {want}")
    if len(out.fits) != ITERS or not fit_diff <= PARITY_TOL:
        raise AssertionError(f"v2 fits {out.fits} against {main_fits}")
    parts = sweep_phases(X, out.factors, steady, "[format]")
    del encoded, X
    torch.cuda.empty_cache()

    # bf16 storage on the planted tensor of phase 4
    tt = planted_tensor(NELL2, clusters=8, side=30, seed=3)
    init = [np.random.default_rng(4).random((d, PARITY_RANK))
            for d in tt.dims]
    planted = {}
    for vs in ("f32", "bf16"):
        popts = Options(max_iterations=BF16_ITERS, tolerance=0.0,
                        idx_width="auto", val_storage=vs,
                        engine_fallback=False, verbosity=Verbosity.NONE)
        pbs = BlockedSparse.from_coo(tt, popts)
        res = cpd_als(pbs, PARITY_RANK, popts, init=init)
        planted[vs] = dict(fits=list(res.fits),
                           factor_dtype=str(res.factors[0].dtype),
                           sec_per_iter=sum(res.iter_seconds[1:])
                           / (len(res.iter_seconds) - 1))
    log(f"[format] planted rank-8 tensor, rank {PARITY_RANK}: "
        f"{json.dumps(planted)}")
    f16, f32 = planted["bf16"]["fits"][-1], planted["f32"]["fits"][-1]
    if planted["bf16"]["factor_dtype"] != "torch.bfloat16":
        raise AssertionError("the bf16 run's factors are not bf16")
    if not (f16 > BF16_MIN_FIT and abs(f16 - f32) < BF16_FIT_GAP):
        raise AssertionError(f"bf16 fit {f16} against f32 {f32}")
    return {"v2_rows": v2_rows, "turns": turns, "bf16": bf16,
            "storage_bytes": storage, "launches": launches,
            "cpd": dict(fits=list(out.fits), max_fit_diff=fit_diff,
                        sec_per_iter=steady, peak_gib=peak / 2**30,
                        sweep_phase_ms=parts),
            "planted_bf16": planted}


def bf16_reductions(bs16, fac16, rank: int) -> dict:
    """Phase 9's bf16 rows of the two reductions: each mode's products
    formed from the bf16 layouts `bs16` and tables `fac16`, the sorted
    contract on the mode's own layout and the full one on layout (m+1) %
    nmodes, each against its plain version, timed beside its bound."""
    from splatt_tpu_torch.ops import kernels
    from splatt_tpu_torch.ops.mttkrp import _gather_prod

    rows = {"onehot_reduce_sorted": [], "onehot_reduce_full": []}
    for contract, lay, width, acc, m in contracts(bs16):
        nb, B = lay.nblocks, lay.block
        prod = _gather_prod(lay.inds, lay.vals, fac16, m).reshape(nb, B,
                                                                   rank)
        if acc:
            name, fn, plain = ("onehot_reduce_full",
                               kernels.onehot_reduce_full,
                               kernels.onehot_reduce_full_plain)
            ids = lay.mode_ids(m).reshape(nb, B)
        else:
            name, fn, plain = ("onehot_reduce_sorted",
                               kernels.onehot_reduce_sorted,
                               kernels.onehot_reduce_sorted_plain)
            ids = lay.blocked_locals()
        got, row = compare(lambda: fn(ids, prod, width),
                           lambda: plain(ids, prod, width),
                           f"{name} bf16 {contract} mode {m}")
        row["bound_ms"], row["bound_by"] = reduce_bound(ids, prod, got,
                                                        lay.nnz)
        row.update(contract=contract, mode=m)
        log(f"[format] {name} bf16 {json.dumps(row)}")
        rows[name].append(row)
        del prod, got, ids
    return rows


def reduce_tile_turns(bs, seed: int = 4) -> list:
    """The two reductions at each rank of REDUCE_TILE_RANKS, f32 and bf16
    products, each mode and contract on the 20M-nonzero layouts `bs`, at
    the rank tile of each of REDUCE_TILES (min(R, tile) columns) in
    turns.  The products are random (a launch's time does not depend on
    their values) at the layouts' ids; each tile's output is held to the
    plain version (to the other tile's where the plain version's f32
    copy of bf16 products would pass 24 GiB)."""
    import torch

    from splatt_tpu_torch.ops import kernels

    gen = torch.Generator(device=bs.device).manual_seed(seed)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for rank in REDUCE_TILE_RANKS:
            for contract, lay, width, acc, m in contracts(bs):
                nb, B = lay.nblocks, lay.block
                ids = (lay.mode_ids(m).reshape(nb, B) if acc
                       else lay.blocked_locals())
                prod = torch.rand((nb, B, rank), generator=gen,
                                  device=bs.device, dtype=dtype)
                fns = {f"tile {t}": (
                    lambda t=t: kernels.onehot_reduce_launch(
                        ids, prod, width, acc, min(rank, t)))
                    for t in REDUCE_TILES}
                label = f"{contract} {dtype} rank {rank} mode {m}"
                outs = {k: fn() for k, fn in fns.items()}
                if dtype == torch.float32 or prod.numel() * 4 <= 24 << 30:
                    plain = (kernels.onehot_reduce_full_plain if acc
                             else kernels.onehot_reduce_sorted_plain)
                    want = plain(ids, prod, width)
                else:
                    want = outs[f"tile {REDUCE_TILES[0]}"]
                rel = {k: check_close(f"{label} {k}", got, want)
                       for k, got in outs.items()}
                del outs, want
                turns = in_turns(fns, reps=5)
                for k in turns:
                    turns[k]["max_rel_err"] = rel[k]
                first, second = (f"tile {t}" for t in REDUCE_TILES)
                row = dict(dtype=str(dtype), rank=rank, contract=contract,
                           mode=m, turns=turns,
                           ratio=turns[second]["ms"] / turns[first]["ms"])
                log(f"[reduce] rank tiles in turns {json.dumps(row)}")
                rows.append(row)
                del prod, ids
                torch.cuda.empty_cache()
    return rows


def dense_bound(lay, factors, mode: int, out, flop_rate: float,
                products: int = 1) -> tuple:
    """Least time in ms for one fused_dense call: the value tiles, the
    other modes' factors read once and the output written once over the
    HBM rate, against `products` x (2 R operations per tile cell and R
    per Khatri-Rao entry) over `flop_rate` (3 products of TF32 for an f32
    product on the tensor cores)."""
    R = int(factors[0].shape[1])
    moved = nbytes(lay.tiles, out)
    moved += nbytes(*(U for k, U in enumerate(factors) if k != mode))
    return least_ms(moved, products * (2 * lay.tiles.numel() + lay.span)
                    * R, flop_rate)


def _cpd_launches(bs, rank: int, init, iters: int, fallback: bool = False):
    """cpd_als with every launch counter at 0 just before: (the result,
    the launches of each kernel, peak device memory in GiB)."""
    import torch

    from splatt_tpu_torch import Options, cpd_als, resilience
    from splatt_tpu_torch.config import Verbosity
    from splatt_tpu_torch.ops import kernels

    opts = Options(max_iterations=iters, tolerance=0.0,
                   engine_fallback=fallback, verbosity=Verbosity.NONE)
    resilience.reset_demotions()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    out = cpd_als(bs, rank, opts, init=init)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    if resilience.demotions():
        raise AssertionError(f"demotions: {resilience.demotions()}")
    return out, launches, torch.cuda.max_memory_allocated() / 2**30


def phase_dense(rank: int, seed: int = 1) -> dict:
    """Phase 10: dense mode at full width (see the module docstring)."""
    import dataclasses

    import torch

    from splatt_tpu_torch import BlockedSparse, Options, cpd_als, resilience
    from splatt_tpu_torch.blocked import (build_dense_layout,
                                          padded_mode_density)
    from splatt_tpu_torch.config import BlockAlloc, Verbosity
    from splatt_tpu_torch.ops import kernels
    from splatt_tpu_torch.ops.mttkrp import dense_operands, describe_plan
    from splatt_tpu_torch.utils import faults

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    tt = synthetic_tensor(DENSE_DIMS, DENSE_NNZ, seed=0)
    log(f"[dense] {DENSE_DIMS} nnz={tt.nnz}: generated in "
        f"{time.perf_counter() - t0:.2f} s")
    build = {}
    t0 = time.perf_counter()
    sparse = BlockedSparse.from_coo(tt, Options(dense="off",
                                                verbosity=Verbosity.NONE))
    torch.cuda.synchronize()
    build["sparse_s"] = time.perf_counter() - t0
    resilience.run_report().clear()
    t0 = time.perf_counter()
    bs = BlockedSparse.from_coo(tt, Options(dense="auto",
                                            dense_threshold=DENSE_THRESHOLD,
                                            verbosity=Verbosity.NONE))
    torch.cuda.synchronize()
    build["hybrid_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    build_dense_layout(tt, 0, device=bs.device)
    torch.cuda.synchronize()
    build["dense_mode0_s"] = time.perf_counter() - t0
    log(f"[dense] host build: {json.dumps(build)} (sparse: the TWOMODE "
        f"sorts; hybrid: the same sorts and the 3 dense layouts)")
    layouts = {}
    for m in range(bs.nmodes):
        lay = bs.layout_for(m)
        if lay.encoding != "dense":
            raise AssertionError(f"mode {m} is not dense: {lay!r}")
        if lay.index_bytes() != 0:
            raise AssertionError(f"mode {m} has index bytes")
        layouts[f"mode{m}"] = dict(
            format=lay.format_desc(), storage_bytes=lay.storage_bytes(),
            index_bytes=lay.index_bytes(), ntiles=lay.ntiles,
            tile=lay.tile, span=lay.span, cells=lay.tiles.numel(),
            padded_density=padded_mode_density(tt.dims, m, tt.nnz),
            bucket=lay.density_bucket)
    log(f"[dense] layouts {json.dumps(layouts)}; sparse layouts "
        + " ".join(f"mode{lay.mode}={lay.format_desc()} "
                   f"{lay.storage_bytes()} B" for lay in sparse.layouts))

    # fused_dense against its plain version per mode, f32 and bf16, timed
    # beside its bound, the plain version and the library matmul
    factors = random_factors(bs, rank, seed)
    rows = {"f32": [], "bf16": []}
    for name, fac, cast in (("f32", factors, None),
                            ("bf16", [U.to(torch.bfloat16) for U in factors],
                             torch.bfloat16)):
        for m in range(bs.nmodes):
            lay = bs.layout_for(m)
            if cast is not None:
                lay = dataclasses.replace(lay, tiles=lay.tiles.to(cast),
                                          val_storage="bf16")
            got, row = compare(
                lambda: kernels.fused_dense(lay, fac, m),
                lambda: kernels.fused_dense_plain(lay, fac, m),
                f"fused_dense {name} mode {m}")
            # f32 runs as 3xTF32 on the tensor cores, bf16 as one bf16
            # product; ffma_bound_ms: the same work at the FFMA rate
            if cast is None:
                row["bound_ms"], row["bound_by"] = dense_bound(
                    lay, fac, m, got, TF32_TC_FLOP_PER_S, products=3)
                emul = kernels.fused_dense_tf32x3(lay, fac, m)
                row["err_vs_tf32x3"] = float((got.double() - emul).abs()
                                             .max() / emul.abs().max())
                del emul
            else:
                row["bound_ms"], row["bound_by"] = dense_bound(
                    lay, fac, m, got, BF16_TC_FLOP_PER_S)
            row["ffma_bound_ms"] = dense_bound(lay, fac, m, got,
                                               F32_FLOP_PER_S)[0]
            w, u = dense_operands(lay, fac, m)
            R = int(w.shape[1])

            def make_kr():
                return (w[:, None, :] * u[None, :, :]).reshape(-1, R)

            kr = make_kr()
            flat = lay.tiles.view(-1, lay.span)
            row["kr_build_ms"] = time_ms(make_kr, reps=5)
            with kernels.ieee_matmul():
                row["library_ms"] = time_ms(lambda: torch.matmul(flat, kr),
                                            reps=5)
            row.update(contract="dense", mode=m, dtype=name, tile=lay.tile,
                       span=lay.span, ntiles=lay.ntiles)
            log(f"[dense] fused_dense {json.dumps(row)}")
            rows[name].append(row)
            del got, kr, flat, w, u, lay
            torch.cuda.empty_cache()

    # the dense CPD: every mode on fused_dense, fallback off
    rng = np.random.default_rng(13)
    init = [rng.random((d, rank)) for d in tt.dims]
    plan = describe_plan(bs, factors)
    log(f"[dense] {plan}")
    if plan.count("=dense/fused_dense") != bs.nmodes:
        raise AssertionError(f"the dense plan is not fused_dense: {plan}")
    resilience.run_report().clear()
    out, launches, peak = _cpd_launches(bs, rank, init, ITERS)
    steady = sum(out.iter_seconds[1:]) / (len(out.iter_seconds) - 1)
    events = resilience.run_report().events("dense_dispatch")
    log(f"[dense] cpd fits {list(out.fits)}; iteration seconds "
        f"{list(out.iter_seconds)}; {steady:.5f} s/iteration; peak "
        f"{peak:.2f} GiB; launches {launches}; dense_dispatch "
        f"{[(e['engine'], e['mode'], e['tile'], e['span']) for e in events]}")
    want = {k.__name__: 0 for k in kernels.KERNELS}
    want["fused_dense"] = bs.nmodes * ITERS
    if launches != want:
        raise AssertionError(f"dense launches {launches}, expected {want}")
    if sorted(e["mode"] for e in events) != list(range(bs.nmodes)):
        raise AssertionError(f"dense_dispatch events {events}")
    if not all(math.isfinite(f) and 0.0 < f <= 1.0 for f in out.fits):
        raise AssertionError(f"dense fits {out.fits}")
    parts = sweep_phases(bs, out.factors, steady, "[dense]")
    host_ms = sweep_without_sync(bs, out.factors, "[dense]")
    dense_cpd = dict(fits=list(out.fits), sec_per_iter=steady,
                     iter_seconds=list(out.iter_seconds), peak_gib=peak,
                     launches=launches, sweep_phase_ms=parts, plan=plan,
                     sweep_enqueue_ms=host_ms)

    # the same tensor all sparse, from the same init
    splan = describe_plan(sparse, factors)
    sout, slaunches, speak = _cpd_launches(sparse, rank, init, ITERS)
    ssteady = sum(sout.iter_seconds[1:]) / (len(sout.iter_seconds) - 1)
    diff = max(abs(a - b) for a, b in zip(out.fits, sout.fits))
    log(f"[dense] all-sparse {splan}; fits {list(sout.fits)}; max |fit "
        f"difference| {diff:.3e}; {ssteady:.5f} s/iteration; peak "
        f"{speak:.2f} GiB; launches {slaunches}")
    if len(sout.fits) != ITERS or not diff <= PARITY_TOL:
        raise AssertionError(f"dense fits {out.fits} against all-sparse "
                             f"{sout.fits}")
    sparse_parts = sweep_phases(sparse, sout.factors, ssteady,
                                "[dense/all-sparse]")
    sparse_cpd = dict(fits=list(sout.fits), sec_per_iter=ssteady,
                      peak_gib=speak, launches=slaunches, plan=splan,
                      max_fit_diff=diff, sweep_phase_ms=sparse_parts)
    del sparse, sout
    torch.cuda.empty_cache()

    # format.dense armed (SPLATT_FAULTS grammar, fires once): the first
    # mode's dense build degrades to its sparse layout, the others stay
    # dense; ONEMODE keeps it to one host sort
    resilience.run_report().clear()
    faults.reset()
    for site, spec in faults.parse_schedule("format.dense:runtime").items():
        faults.arm(site, spec)
    try:
        drill = BlockedSparse.from_coo(tt, Options(
            dense="auto", block_alloc=BlockAlloc.ONEMODE,
            verbosity=Verbosity.NONE))
    finally:
        faults.reset()
    fallbacks = resilience.run_report().events("format_fallback")
    dplan = describe_plan(drill, factors)
    dout, dlaunches, _ = _cpd_launches(drill, rank, init, DRILL_ITERS)
    ddiff = max(abs(a - b) for a, b in zip(dout.fits, out.fits))
    log(f"[dense] format.dense armed: events {json.dumps(fallbacks)}; "
        f"{dplan}; fits {list(dout.fits)} (max |difference| from the "
        f"dense CPD {ddiff:.3e}); launches {dlaunches}")
    if [(e["site"], e["mode"]) for e in fallbacks] != [("dense", 0)]:
        raise AssertionError(f"format.dense drill events {fallbacks}")
    if "mode0=sorted_onehot/fused_t" not in dplan or \
            dplan.count("=dense/fused_dense") != bs.nmodes - 1:
        raise AssertionError(f"format.dense drill plan {dplan}")
    if (dlaunches["fused_mttkrp_t"] != DRILL_ITERS
            or dlaunches["fused_dense"] != (bs.nmodes - 1) * DRILL_ITERS
            or not ddiff <= PARITY_TOL):
        raise AssertionError("format.dense drill CPD")
    drill_row = dict(events=fallbacks, plan=dplan, fits=list(dout.fits),
                     launches=dlaunches, max_fit_diff=ddiff)
    del drill, dout

    # engine.fused_dense armed: on the card the dense chain holds only the
    # kernel, so cpd_als raises, fallback on or off
    raised = {}
    for fallback in (True, False):
        for site, spec in faults.parse_schedule(
                "engine.fused_dense:runtime").items():
            faults.arm(site, spec)
        kernels.reset_launches()
        try:
            cpd_als(bs, rank, Options(max_iterations=1, tolerance=0.0,
                                      engine_fallback=fallback,
                                      verbosity=Verbosity.NONE), init=init)
        except RuntimeError as e:
            raised[str(fallback)] = repr(e)
        else:
            raise AssertionError(f"engine.fused_dense armed, fallback "
                                 f"{fallback}: cpd_als did not raise")
        finally:
            faults.reset()
        if "engine.fused_dense" not in raised[str(fallback)] or \
                kernels.fused_dense.launches or resilience.demotions():
            raise AssertionError(f"engine.fused_dense armed: {raised}")
    log(f"[dense] engine.fused_dense armed: cpd_als raised {raised}")
    resilience.reset_demotions()
    resilience.run_report().clear()
    seconds = time.perf_counter() - t_phase
    log(f"[dense] phase 10 took {seconds:.1f} s")
    del bs
    torch.cuda.empty_cache()
    return {"rows": rows, "layouts": layouts, "build": build,
            "cpd": dense_cpd, "all_sparse": sparse_cpd,
            "drill": drill_row,
            "raised": raised, "seconds": seconds}


# -- phase 11: the distributed FINE CPD over the ring kernels ---------------


def mesh_time_ms(fn, mesh, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of `fn` on a mesh: CUDA events on one
    card, the host clock between syncs of every card on several."""
    from splatt_tpu_torch.parallel.sharded import sync_mesh as mesh_sync

    if len(mesh.cards) == 1:
        return time_ms(fn, reps=reps, warmup=warmup)
    for _ in range(warmup):
        fn()
    mesh_sync(mesh)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    mesh_sync(mesh)
    return (time.perf_counter() - t0) / reps * 1e3


def peer_copy_rate(mesh) -> dict:
    """Bytes per second of one large copy_ from rank 0's card to rank 1's
    (a copy within the card when they share it, the hop between virtual
    ranks)."""
    import torch

    from splatt_tpu_torch.parallel.sharded import sync_mesh as mesh_sync

    a, b = mesh.devices[0], mesh.devices[1 % mesh.ndev]
    src = torch.empty(1 << 28, dtype=torch.float32, device=a)
    dst = torch.empty(1 << 28, dtype=torch.float32, device=b)
    dst.copy_(src)
    mesh_sync(mesh)
    ms = mesh_time_ms(lambda: dst.copy_(src), mesh, reps=10)
    moved = src.numel() * src.element_size()
    del src, dst
    torch.cuda.empty_cache()
    return {"from": str(a), "to": str(b), "bytes": moved, "ms": ms,
            "bytes_per_s": moved / (ms / 1e3)}


def ring_bound(mesh, hbm: list, hop: list, flops: list,
               peer: dict) -> tuple:
    """Least ms of a ring launch: per card, the largest of its ranks' HBM
    bytes (each input read once, each output written once) over the HBM
    rate, their hop bytes over the measured copy rate and their additions
    over the f32 rate; the slowest card bounds the launch."""
    best, by = 0.0, "bytes"
    for card in mesh.cards:
        ranks = mesh.ranks_on(card)
        t_hbm = sum(hbm[d] for d in ranks) / HBM_BYTES_PER_S * 1e3
        t_hop = sum(hop[d] for d in ranks) / peer["bytes_per_s"] * 1e3
        t_ops = sum(flops[d] for d in ranks) / F32_FLOP_PER_S * 1e3
        if max(t_hbm, t_hop) > best:
            best, by = max(t_hbm, t_hop), "bytes"
        if t_ops > best:
            best, by = t_ops, "operations"
    return best, by


def owner_stable(plans):
    """The ring plans' buckets in the order the gather walked before the
    plans were sorted by id: each bucket's positions ascending, a stable
    sort by owner alone.  For timing the gather on both orders."""
    import torch

    from splatt_tpu_torch.parallel import ring_kernels

    out = []
    for p in plans:
        owner = torch.repeat_interleave(
            torch.arange(int(p.offsets.shape[0]) - 1, device=p.pos.device),
            torch.diff(p.offsets.long()))
        order = torch.sort(owner * int(p.pos.shape[0])
                           + p.pos.long()).indices
        out.append(ring_kernels.RingPlan(p.pos[order], p.loc[order],
                                         p.offsets, p.block))
    return out


def ring_library(kind: str, mesh, mats, idx, block: int, dim_pad: int):
    """One library call set computing a ring kernel's function: on
    distinct cards NCCL in one process (torch.cuda.nccl.all_gather, then
    index_select; index_add_, then torch.cuda.nccl.reduce_scatter); with
    virtual ranks on one card, where NCCL cannot run, the all-gather is a
    torch.cat and the reduce-scatter a sum of the ranks' slices.  Returns
    (fn, label)."""
    import torch

    ndev = mesh.ndev
    R = int(mats[0].shape[1])
    if not mesh.virtual:
        import torch.cuda.nccl as nccl

        if kind == "gather":
            full = [torch.empty((block * ndev, R), dtype=mats[0].dtype,
                                device=dev) for dev in mesh.devices]

            def fn():
                nccl.all_gather(list(mats), full)
                return [f.index_select(0, i) for f, i in zip(full, idx)]
        else:
            out = [torch.empty((block, R), dtype=torch.float32, device=dev)
                   for dev in mesh.devices]

            def fn():
                parts = [torch.zeros((dim_pad, R), dtype=torch.float32,
                                     device=p.device)
                         .index_add_(0, i, p.float())
                         for p, i in zip(mats, idx)]
                nccl.reduce_scatter(parts, out)
                return out
        label = ("nccl.all_gather + index_select" if kind == "gather"
                 else "index_add_ + nccl.reduce_scatter")
        return fn, label
    if kind == "gather":
        def fn():
            full = torch.cat(list(mats))
            return [full.index_select(0, i) for i in idx]
        return fn, "torch.cat + index_select (one card: no NCCL)"

    def fn():
        parts = [torch.zeros((dim_pad, R), dtype=torch.float32,
                             device=p.device).index_add_(0, i, p.float())
                 for p, i in zip(mats, idx)]
        tot = parts[0]
        for q in parts[1:]:
            tot = tot + q
        return list(tot.split(block))
    return fn, "index_add_ + sum of the ranks' partials (one card: no NCCL)"


def gather_pitch_probe(mesh, U_l, idx, plans, peer) -> dict:
    """ring_gather on one leg with its rows packed (R * esize bytes
    apart) against the burst-aligned pitch it runs with, and with bf16
    shards (exact against the sync ring), each timed."""
    import torch

    from splatt_tpu_torch.parallel import ring, ring_kernels

    out = {}
    aligned = ring_kernels.ROW_PITCH_ALIGN
    try:
        for label, align in (("packed_ms", U_l[0].element_size()),
                             ("pitch_ms", aligned)):
            ring_kernels.ROW_PITCH_ALIGN = align
            out[label] = mesh_time_ms(lambda: ring_kernels.ring_gather(
                U_l, idx, mesh, plans=plans), mesh, reps=10, warmup=2)
    finally:
        ring_kernels.ROW_PITCH_ALIGN = aligned
    U_b = [u.to(torch.bfloat16) for u in U_l]
    got = ring_kernels.ring_gather(U_b, idx, mesh, plans=plans)
    want = ring.gather_hops(U_b, idx, mesh)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("bf16 ring_gather differs from the sync ring")
    del got, want
    R = int(U_b[0].shape[1])
    hbm = [4 * int(i.shape[0]) + nbytes(U) + int(i.shape[0]) * R * 2
           for U, i in zip(U_b, idx)]
    hop = [(mesh.ndev - 1) * nbytes(U) for U in U_b]
    out["bf16_ms"] = mesh_time_ms(lambda: ring_kernels.ring_gather(
        U_b, idx, mesh, plans=plans), mesh, reps=10, warmup=2)
    out["bf16_bound_ms"] = ring_bound(mesh, hbm, hop, [0] * mesh.ndev,
                                      peer)[0]
    out["pitch_align"] = aligned
    log(f"[ring] ring_gather pitch probe (mode 0's first leg): "
        f"{json.dumps(out)}")
    return out


def _peaks(mesh) -> dict:
    import torch

    return {str(c): round(torch.cuda.max_memory_allocated(c) / 2**30, 3)
            for c in mesh.cards}


def _reset_peaks(mesh) -> None:
    import torch

    for c in mesh.cards:
        torch.cuda.reset_peak_memory_stats(c)


def phase_distributed(tt, rank: int, seed: int = 11) -> dict:
    """Phase 11: the FINE CPD over the ring kernels on phase 3's tensor."""
    import torch

    from splatt_tpu_torch import Options, cpd_als, resilience
    from splatt_tpu_torch.config import CommPattern
    from splatt_tpu_torch.parallel import ring, ring_kernels
    from splatt_tpu_torch.parallel.mesh import make_mesh
    from splatt_tpu_torch.parallel.sharded import (shard_factors, shard_nnz,
                                                   sharded_cpd_als)
    from splatt_tpu_torch.parallel.sharded import sync_mesh as mesh_sync
    from splatt_tpu_torch.utils import faults

    t_phase = time.perf_counter()
    ncards = torch.cuda.device_count()
    nranks = ncards if ncards > 1 else RING_VIRTUAL_RANKS
    mesh = make_mesh(n_devices=nranks)
    log(f"[ring] phase 11: {nranks} ranks on {len(mesh.cards)} card(s)"
        + (f": {nranks} virtual ranks share one card, one launch holds "
           f"them all" if mesh.virtual else ": one rank per card"))
    peers = []
    for r in range(nranks):
        a, b = mesh.devices[r], mesh.devices[(r + 1) % nranks]
        if a != b:
            ok = torch.cuda.can_device_access_peer(a.index, b.index)
            peers.append({"pair": [str(a), str(b)], "peer_access": ok})
            log(f"[ring] can_device_access_peer({a.index}, {b.index}) = {ok}")
    peer = peer_copy_rate(mesh)
    log(f"[ring] copy rate {peer['from']} -> {peer['to']}: "
        f"{peer['bytes_per_s'] / 1e9:.1f} GB/s ({peer['bytes']} bytes in "
        f"{peer['ms']:.3f} ms)")
    ndev = mesh.ndev
    dims_pad = tuple(-(-d // ndev) * ndev for d in tt.dims)
    inds, vals = shard_nnz(tt, mesh, dtype=torch.float32)
    rng = np.random.default_rng(seed)
    init = [rng.random((d, rank)) for d in tt.dims]
    facs = shard_factors(init, tt.dims, mesh, dtype=torch.float32)
    mesh_sync(mesh)

    # 1. each kernel against its plain version on the real shards; the
    # id-sorted plans built once per mode, as the CPD builds them, and
    # shared by the mode's gathers and its reduce; the gather is also
    # timed on the owner-stable plans it walked before, in turns
    t0 = time.perf_counter()
    plans = {k: ring_kernels.build_ring_plans(
        [i[k] for i in inds], mesh, dims_pad[k] // ndev)
        for k in range(tt.nmodes)}
    mesh_sync(mesh)
    plan_s = time.perf_counter() - t0
    plan_bytes = sum(nbytes(p.pos, p.loc, p.offsets)
                     for ps in plans.values() for p in ps)
    # each rank's nonzeros per owner shard (the last: ids of no shard); a
    # ring step waits for the rank with the largest bucket of that step
    buckets = {k: [torch.diff(p.offsets).tolist() for p in ps]
               for k, ps in plans.items()}
    log(f"[ring] ring plans (id-sorted, one per mode per rank, shared by "
        f"the gathers and the reduce): {tt.nmodes} modes x {ndev} ranks "
        f"built in {plan_s:.3f} s, {plan_bytes} bytes on the card(s); "
        f"bucket sizes by mode and rank {json.dumps(buckets)}")
    owner_plans = {k: owner_stable(ps) for k, ps in plans.items()}
    rows_out = {"ring_gather": [], "ring_reduce": []}
    for m in range(tt.nmodes):
        prod = [v[:, None].clone() for v in vals]
        for k in range(tt.nmodes):
            if k == m:
                continue
            U_l, idx = facs[k], [i[k] for i in inds]
            block = dims_pad[k] // ndev
            got = ring_kernels.ring_gather(U_l, idx, mesh, plans=plans[k])
            want = ring.gather_hops(U_l, idx, mesh)
            plain = ring_kernels.ring_gather_plain(U_l, plans[k], mesh)
            mesh_sync(mesh)
            ring_kernels.check_errors()
            err = max(float((g - w).abs().max())
                      for g, w in zip(got, want))
            err_plain = max(float((g - w).abs().max())
                            for g, w in zip(got, plain))
            if err != 0.0 or err_plain != 0.0:
                raise AssertionError(f"ring_gather mode {k} for mode {m}: "
                                     f"max error {err} against the sync "
                                     f"ring, {err_plain} against the plain "
                                     f"walk, expected exact")
            prod = [p * w for p, w in zip(prod, want)]
            del got, plain
            got = ring_kernels.ring_gather(U_l, idx, mesh,
                                           plans=owner_plans[k])
            mesh_sync(mesh)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"ring_gather mode {k} on the owner-"
                                     f"stable plans differs")
            del got, want
            lib, label = ring_library("gather", mesh, U_l, idx, block,
                                      dims_pad[k])
            hbm = [4 * int(i.shape[0]) + U.numel() * U.element_size()
                   + int(i.shape[0]) * rank * U.element_size()
                   for U, i in zip(U_l, idx)]
            hop = [(ndev - 1) * U.numel() * U.element_size() for U in U_l]
            b_ms, b_by = ring_bound(mesh, hbm, hop, [0] * ndev, peer)
            # the two plan orders in turns: id, owner, owner, id
            turns = {"id": [], "owner": []}
            for order in ("id", "owner", "owner", "id"):
                ps = plans[k] if order == "id" else owner_plans[k]
                turns[order].append(mesh_time_ms(
                    lambda: ring_kernels.ring_gather(U_l, idx, mesh,
                                                     plans=ps),
                    mesh, reps=10, warmup=2))
            row = dict(leg=f"mode {m}: gather factor {k}", mode=m, factor=k,
                       block=block, max_abs_err=err, max_rel_err=err,
                       ms=sum(turns["id"]) / 2,
                       owner_plan_ms=sum(turns["owner"]) / 2,
                       turns_ms=turns,
                       plain_ms=mesh_time_ms(
                           lambda: ring_kernels.ring_gather_plain(
                               U_l, plans[k], mesh), mesh, reps=3),
                       sync_ring_ms=mesh_time_ms(lambda: ring.gather_hops(
                           U_l, idx, mesh), mesh, reps=3),
                       library_ms=mesh_time_ms(lib, mesh, reps=10),
                       library=label, bound_ms=b_ms, bound_by=b_by,
                       hbm_bytes=sum(hbm), hop_bytes=sum(hop))
            ring_kernels.check_errors()
            log(f"[ring] {json.dumps(row)}")
            rows_out["ring_gather"].append(row)
        idx = [i[m] for i in inds]
        block = dims_pad[m] // ndev
        got = ring_kernels.ring_reduce(prod, idx, mesh, block,
                                       plans=plans[m])
        want = ring.blockwise_reduce_rows(prod, idx, mesh, block)
        plain = ring_kernels.ring_reduce_plain(prod, plans[m], mesh)
        mesh_sync(mesh)
        ring_kernels.check_errors()
        scale = max(float(w.abs().max()) for w in want)
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        err_plain = max(float((g - w).abs().max())
                        for g, w in zip(got, plain))
        rel = max(err, err_plain) / scale if scale > 0 else err
        if not rel <= KERNEL_TOL:
            raise AssertionError(f"ring_reduce mode {m}: relative error "
                                 f"{err / scale:.3e} against the sync ring, "
                                 f"{err_plain / scale:.3e} against its plain "
                                 f"walk > {KERNEL_TOL}")
        del got, want, plain
        lib, label = ring_library("reduce", mesh, prod, idx, block,
                                  dims_pad[m])
        hbm = [p.numel() * p.element_size() + 4 * int(i.shape[0])
               + block * rank * 4 for p, i in zip(prod, idx)]
        hop = [(ndev - 1) * block * rank * 4 for _ in prod]
        b_ms, b_by = ring_bound(mesh, hbm, hop, [p.numel() for p in prod],
                                peer)
        row = dict(leg=f"mode {m}: reduce", mode=m, block=block,
                   max_abs_err=max(err, err_plain), max_rel_err=rel,
                   err_vs_sync_ring=err, err_vs_plain=err_plain,
                   ms=mesh_time_ms(lambda: ring_kernels.ring_reduce(
                       prod, idx, mesh, block, plans=plans[m]), mesh,
                       reps=10, warmup=2),
                   plain_ms=mesh_time_ms(
                       lambda: ring_kernels.ring_reduce_plain(
                           prod, plans[m], mesh), mesh, reps=3),
                   sync_ring_ms=mesh_time_ms(
                       lambda: ring.blockwise_reduce_rows(
                           prod, idx, mesh, block), mesh, reps=3),
                   library_ms=mesh_time_ms(lib, mesh, reps=10),
                   library=label, bound_ms=b_ms, bound_by=b_by,
                   hbm_bytes=sum(hbm), hop_bytes=sum(hop))
        ring_kernels.check_errors()
        log(f"[ring] {json.dumps(row)}")
        rows_out["ring_reduce"].append(row)
        del prod
        torch.cuda.empty_cache()
    pitch = gather_pitch_probe(mesh, facs[1], [i[1] for i in inds], plans[1],
                               peer)
    del facs, owner_plans

    def opts(comm, **kw):
        return Options(max_iterations=RING_ITERS, tolerance=0.0,
                       random_seed=0, comm_pattern=comm, **kw)

    # 2. the ASYNC_RING CPD, counters at 0 just before
    resilience.reset_demotions()
    resilience.run_report().clear()
    mesh_sync(mesh)
    _reset_peaks(mesh)
    ring_kernels.reset_launches()
    out = sharded_cpd_als(tt, rank, mesh=mesh, init=init,
                          opts=opts(CommPattern.ASYNC_RING,
                                    engine_fallback=False),
                          measure_overlap=False)
    mesh_sync(mesh)
    launches = {"ring_gather": ring_kernels.ring_gather.launches,
                "ring_reduce": ring_kernels.ring_reduce.launches}
    builds = ring_kernels.build_ring_plans.builds
    ring_peaks = _peaks(mesh)
    fallbacks = resilience.run_report().events("comm_fallback")
    steady = sum(out.iter_seconds[1:]) / (len(out.iter_seconds) - 1)
    ncards_used = len(mesh.cards)
    want_g = 2 * tt.nmodes * RING_ITERS * ncards_used
    want_r = tt.nmodes * RING_ITERS * ncards_used
    log(f"[ring] async_ring cpd fits {list(out.fits)}")
    log(f"[ring] async_ring cpd {steady:.5f} s/iteration (iterations "
        f"2..{RING_ITERS}); launches {launches} (expected {want_g} and "
        f"{want_r}: {ncards_used} card(s)); ring plans built {builds} "
        f"(expected {tt.nmodes * ndev}: one per mode per rank, shared by "
        f"the gathers and the reduce; {plan_bytes} bytes); "
        f"comm_fallback events {len(fallbacks)}; peak GiB per card "
        f"{ring_peaks}")
    gather_ms = sum(r["ms"] for r in rows_out["ring_gather"]) / len(
        rows_out["ring_gather"])
    gather_lib = sum(r["library_ms"] for r in rows_out["ring_gather"]) / len(
        rows_out["ring_gather"])
    gather_bound = sum(r["bound_ms"] for r in rows_out["ring_gather"]) / len(
        rows_out["ring_gather"])
    gather_owner = sum(r["owner_plan_ms"] for r in rows_out[
        "ring_gather"]) / len(rows_out["ring_gather"])
    log(f"[ring] ring_gather {gather_ms:.4f} ms per launch (mean over the "
        f"legs) on the shared id-sorted plans, {gather_owner:.4f} ms on "
        f"the owner-stable plans (in turns), beside its bound "
        f"{gather_bound:.4f} ms, the library "
        f"{gather_lib:.4f} ms; the all-ids scan design read "
        f"{SCAN_GATHER_MS} ms in an earlier run of this script (H100 80GB "
        f"HBM3, 700 W), not this one")
    if launches != {"ring_gather": want_g, "ring_reduce": want_r}:
        raise AssertionError(f"ring launches {launches}, expected "
                             f"{want_g} and {want_r}")
    if builds != tt.nmodes * ndev:
        raise AssertionError(f"{builds} ring plans built, expected "
                             f"{tt.nmodes * ndev}")
    if fallbacks:
        raise AssertionError(f"comm_fallback events: {fallbacks}")
    if not all(math.isfinite(f) for f in out.fits):
        raise AssertionError(f"fits {out.fits} are not finite")

    # the achieved overlap, from a second run with the probe on
    resilience.run_report().clear()
    o = Options(max_iterations=1, tolerance=0.0, random_seed=0,
                comm_pattern=CommPattern.ASYNC_RING, engine_fallback=False)
    sharded_cpd_als(tt, rank, mesh=mesh, init=init, opts=o,
                    measure_overlap=True)
    ov = resilience.run_report().events("ring_overlap")
    if len(ov) != 1:
        raise AssertionError(f"ring_overlap events: {ov}")
    overlap = {k: v for k, v in ov[0].items() if k not in ("kind", "ts")}
    log(f"[ring] ring_overlap {json.dumps(overlap)}")

    # the single-card COO oracle from the same init
    coo = cpd_als(tt, rank, opts(None), init=init, device=mesh.devices[0])
    diff = max(abs(a - b) for a, b in zip(out.fits, coo.fits))
    lam_rel = float((out.lam - coo.lam.cpu()).abs().max()
                    / coo.lam.abs().max())
    log(f"[ring] single-card COO cpd fits {list(coo.fits)}; max |fit "
        f"difference| {diff:.3e} (tolerance {PARITY_TOL}); λ relative "
        f"difference {lam_rel:.3e}")
    if len(coo.fits) != len(out.fits) or not diff <= PARITY_TOL:
        raise AssertionError("the async_ring CPD's fits leave the COO "
                             "CPD's")

    # 3. the same CPD under ALL2ALL
    mesh_sync(mesh)
    _reset_peaks(mesh)
    a2a = sharded_cpd_als(tt, rank, mesh=mesh, init=init,
                          opts=opts(CommPattern.ALL2ALL,
                                    engine_fallback=False),
                          local_engine="stream")
    mesh_sync(mesh)
    a2a_peaks = _peaks(mesh)
    a2a_steady = sum(a2a.iter_seconds[1:]) / (len(a2a.iter_seconds) - 1)
    a2a_diff = max(abs(a - b) for a, b in zip(out.fits, a2a.fits))
    log(f"[ring] all2all cpd {a2a_steady:.5f} s/iteration; fits "
        f"{list(a2a.fits)}; max |fit difference| against async_ring "
        f"{a2a_diff:.3e}; peak GiB per card {a2a_peaks}")
    if not a2a_diff <= PARITY_TOL:
        raise AssertionError("the all2all CPD's fits leave the async_ring "
                             "CPD's")

    # 4. the drill: an armed ring exchange raises, fallback on or off
    drill = []
    for fallback in (True, False):
        resilience.reset_demotions()
        faults.reset()
        faults.arm(*next(iter(faults.parse_schedule(
            "comm.ring_exchange:runtime").items())))
        err = None
        try:
            sharded_cpd_als(tt, rank, mesh=mesh, init=init,
                            opts=Options(max_iterations=1, random_seed=0,
                                         comm_pattern=CommPattern.ASYNC_RING,
                                         engine_fallback=fallback),
                            measure_overlap=False)
        except Exception as e:
            err = e
        finally:
            faults.reset()
        mesh_sync(mesh)
        if err is None or "injected" not in str(err):
            raise AssertionError(f"the comm.ring_exchange drill (fallback "
                                 f"{fallback}) did not raise: {err!r}")
        drill.append({"fallback": fallback, "raised": repr(err)[:160]})
        log(f"[ring] drill fallback={fallback}: raised {err!r}")
    resilience.reset_demotions()
    resilience.run_report().clear()
    seconds = time.perf_counter() - t_phase
    log(f"[ring] phase 11 took {seconds:.1f} s")
    return {"rows": rows_out, "launches": launches, "ranks": nranks,
            "cards": ncards_used, "virtual": mesh.virtual, "peers": peers,
            "copy_rate": peer, "plan_builds": builds, "pitch_probe": pitch,
            "plan_bytes": plan_bytes, "plan_build_s": plan_s,
            "plan_buckets": buckets,
            "cpd": {"sec_per_iter": steady, "fits": list(out.fits),
                    "iter_seconds": list(out.iter_seconds),
                    "peak_gib": ring_peaks, "coo_fits": list(coo.fits),
                    "coo_fit_diff": diff, "lam_rel_diff": lam_rel},
            "overlap": overlap,
            "all2all": {"sec_per_iter": a2a_steady, "fits": list(a2a.fits),
                        "fit_diff": a2a_diff, "peak_gib": a2a_peaks},
            "drill": drill, "seconds": seconds}


# -- phase 12: the blocked per-rank engine in FINE, MEDIUM and COARSE ---------


def rank_launch(lay, tables, m: int, tag: str) -> dict:
    """One rank's sorted fused_mttkrp_t launch on its layout and gathered
    tables against the plain version, timed beside its bound."""
    from splatt_tpu_torch.ops.kernels import (fused_mttkrp_t,
                                              fused_mttkrp_t_plain)

    got, row = compare(
        lambda: fused_mttkrp_t(lay, tables, m, lay.seg_width, False),
        lambda: fused_mttkrp_t_plain(lay, tables, m, lay.seg_width, False),
        f"{tag} fused_mttkrp_t rank 0 mode {m}")
    row["bound_ms"], row["bound_by"] = bound(lay, tables, m, got)
    row.update(decomp=tag, mode=m, rank=0, nnz=lay.nnz, nblocks=lay.nblocks,
               seg_width=lay.seg_width, dim=lay.dim)
    log(f"[decomp] {json.dumps(row)}")
    return row


def sweep_host_ms(step, factors, grams, mesh, tag: str) -> float:
    """One sweep of a decomposition under
    torch.cuda.set_sync_debug_mode("error") (it raises if anything in the
    sweep waits on the host); returns the host ms to enqueue it, the time
    the host spends outside the launches."""
    import torch

    from splatt_tpu_torch.ops.linalg import check_solver
    from splatt_tpu_torch.parallel.sharded import sync_mesh

    step(factors, grams, False)
    sync_mesh(mesh)
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        step(factors, grams, False)
        host_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sync_mesh(mesh)
    check_solver()
    log(f"[decomp] {tag}: one sweep under set_sync_debug_mode('error'): no "
        f"host sync; enqueued in {host_ms:.3f} ms")
    return host_ms


class BuildSpy:
    """Records the per-rank layouts a distributed CPD entry point builds:
    for the block, the layout function of `kind` ("fine": ``sharded.
    shard_blocked_layouts``; "coarse": ``coarse.coarse_rank_layouts``;
    "medium": ``GridDecomp.build_cell_layouts`` and ``CellLayouts.
    device_put``) is wrapped, and ``got`` holds its output, its mesh and
    its seconds, so that phase 12's checks run on the layouts of the CPD
    they check instead of a second host build."""

    def __init__(self, kind: str):
        self.kind = kind
        self.got: dict = {}
        self._saved: list = []

    def _wrap(self, owner, name: str, make) -> None:
        orig = getattr(owner, name)
        self._saved.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def __enter__(self):
        from splatt_tpu_torch.parallel import coarse, grid, sharded

        got = self.got

        def timed(orig, record):
            sig = inspect.signature(orig)

            def spy(*a, **kw):
                t0 = time.perf_counter()
                out = orig(*a, **kw)
                # by name, however the package's caller passed them
                record(out, time.perf_counter() - t0,
                       sig.bind(*a, **kw).arguments)
                return out
            return spy

        if self.kind == "fine":
            self._wrap(sharded, "shard_blocked_layouts", lambda o: timed(
                o, lambda out, sec, arg: got.update(
                    cells=out, mesh=arg["mesh"],
                    dims_pad=tuple(arg["dims_pad"]), build_s=sec)))
        elif self.kind == "coarse":
            self._wrap(coarse, "coarse_rank_layouts", lambda o: timed(
                o, lambda out, sec, arg: got.update(
                    cells=out, mesh=arg["mesh"], build_s=sec,
                    blocks=tuple(b for (_, _, b, _) in arg["per_mode"]))))
        else:
            self._wrap(grid.GridDecomp, "build_cell_layouts",
                       lambda o: timed(o, lambda out, sec, arg:
                                       got.update(decomp=arg["self"],
                                                  build_s=sec)))
            self._wrap(grid.CellLayouts, "device_put", lambda o: timed(
                o, lambda out, sec, arg: got.update(
                    cells=out, mesh=arg["mesh"],
                    build_s=got.get("build_s", 0.0) + sec)))
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        self._saved.clear()
        return False


def decomp_pieces(kind: str, tt, mesh, rank: int, init, grid=None,
                  built=None) -> dict:
    """The per-rank layouts, sharded factors and sweep of one
    decomposition, built from the package's pieces as its CPD entry
    point builds them (the host build timed), with a function giving
    rank 0's tables for mode m.  With `built` (a :class:`BuildSpy`'s
    ``got`` from the CPD entry point's run) the layouts are that run's,
    and the seconds its build's."""
    import torch

    from splatt_tpu_torch import Options
    from splatt_tpu_torch.ops.linalg import gram
    from splatt_tpu_torch.parallel.coarse import (_bucket_by_mode,
                                                  coarse_rank_layouts,
                                                  make_coarse_sweep)
    from splatt_tpu_torch.parallel.common import allreduce, ceil_to
    from splatt_tpu_torch.parallel.grid import GridDecomp, make_grid_sweep
    from splatt_tpu_torch.parallel.sharded import (gather_full,
                                                   make_sharded_sweep,
                                                   shard_blocked_layouts,
                                                   shard_factors, sync_mesh)

    opts = Options()
    ndev, nmodes = mesh.ndev, tt.nmodes
    t0 = time.perf_counter()
    if built is not None:
        mesh, cells = built["mesh"], built["cells"]
        if kind == "medium":
            decomp = built["decomp"]
        elif kind == "coarse":
            blocks = built["blocks"]
        else:
            dims_pad = built["dims_pad"]
    elif kind == "medium":
        decomp = GridDecomp.build(tt, grid=grid, val_dtype=tt.vals.dtype,
                                  balance=None)
        mesh = decomp.make_mesh(devices=mesh.devices)
        cells = decomp.build_cell_layouts(opts).device_put(mesh, nmodes)
    elif kind == "coarse":
        per_mode = [_bucket_by_mode(tt, m, ndev, tt.vals.dtype)
                    for m in range(nmodes)]
        blocks = tuple(b for (_, _, b, _) in per_mode)
        cells = coarse_rank_layouts(per_mode, opts, mesh)
        del per_mode
    else:
        dims_pad = tuple(ceil_to(d, ndev) for d in tt.dims)
        cells = shard_blocked_layouts(tt, mesh, opts, dims_pad)
    sync_mesh(mesh)
    build_s = (time.perf_counter() - t0 if built is None
               else built["build_s"])
    if kind == "medium":
        factors = decomp.shard_factors(init, mesh)
        groups = [mesh.groups([m]) for m in range(nmodes)]
        sweep = make_grid_sweep(mesh, decomp, 0.0, cells=cells,
                                fallback=False)
    elif kind == "coarse":
        factors = shard_factors(init, tt.dims, mesh,
                                dims_pad=[b * ndev for b in blocks])
        groups = [None] * nmodes
        sweep = make_coarse_sweep(mesh, blocks, 0.0, cells=cells,
                                  fallback=False)
    else:
        factors = shard_factors(init, tt.dims, mesh)
        groups = [None] * nmodes
        sweep = make_sharded_sweep(mesh, nmodes, 0.0, dims_pad, cells=cells,
                                   fallback=False)
    grams = [allreduce([gram(u) for u in f], mesh, groups=groups[m])
             for m, f in enumerate(factors)]
    dev = mesh.devices[0]
    full = [gather_full(f, mesh)[dev] for f in factors]

    def tables(m):
        if kind == "medium":
            return [f[0] for f in factors]
        if kind == "coarse":
            return [factors[k][0] if k == m else full[k]
                    for k in range(nmodes)]
        return [torch.zeros((dims_pad[m], rank), device=dev) if k == m
                else full[k] for k in range(nmodes)]

    def step(f, g, first):
        return sweep(None, None, f, g, first)

    sorted_modes = [m for m, c in enumerate(cells) if c.sort_mode == m
                    and c.path == "sorted_onehot"]
    info = dict(build_s=build_s, sorted_modes=sorted_modes,
                rank_nnz=list(cells[sorted_modes[0]].counts),
                seg_width={m: cells[m].seg_width for m in sorted_modes},
                nnz_pad={m: int(cells[m].vals[0].shape[0])
                         for m in sorted_modes})
    info["layouts_of_the_cpd"] = built is not None
    log(f"[decomp] {kind}{'' if grid is None else ' grid ' + str(grid)}: "
        f"per-rank layouts built on the host and copied in {build_s:.2f} s"
        f"{' (by the CPD checked here)' if built is not None else ''}; "
        f"{json.dumps(info)}")
    return dict(mesh=mesh, cells=cells, step=step, factors=factors,
                grams=grams, tables=tables, info=info)


def check_decomp(kind: str, tt, mesh, rank: int, init, grid,
                 built: dict) -> dict:
    """Rank 0's fused_mttkrp_t launch of each sorted mode against the
    plain version, and one sweep under the sync check, on the layouts the
    CPD entry point built (`built`, from a :class:`BuildSpy`)."""
    import torch

    p = decomp_pieces(kind, tt, mesh, rank, init, grid, built)
    tag = kind if grid is None else f"{kind} {'x'.join(map(str, grid))}"
    rows = [rank_launch(p["cells"][m].layout(0), p["tables"](m), m, tag)
            for m in p["info"]["sorted_modes"]]
    host_ms = sweep_host_ms(p["step"], p["factors"], p["grams"], p["mesh"],
                            tag)
    out = dict(p["info"], rank0_rows=rows, sweep_host_ms=host_ms)
    del p
    torch.cuda.empty_cache()
    return out


def phase_decomp(tt, rank: int, seed: int = DECOMP_SEED) -> dict:
    """Phase 12: the blocked per-rank engine in FINE, MEDIUM and COARSE on
    phase 3's tensor."""
    import torch

    from splatt_tpu_torch import Options, cpd_als, resilience
    from splatt_tpu_torch.config import CommPattern, Decomposition
    from splatt_tpu_torch.ops import kernels
    from splatt_tpu_torch.parallel import distributed_cpd_als, grid_cpd_als
    from splatt_tpu_torch.parallel.common import alloc_build_modes, ceil_to
    from splatt_tpu_torch.parallel.mesh import auto_grid, make_mesh
    from splatt_tpu_torch.parallel.sharded import sync_mesh
    from splatt_tpu_torch.utils import faults

    t_phase = time.perf_counter()
    ncards = torch.cuda.device_count()
    nranks = ncards if ncards > 1 else DECOMP_VIRTUAL_RANKS
    mesh = make_mesh(n_devices=nranks)
    auto = auto_grid(nranks, tt.dims)
    split = (2, nranks // 2, 1)
    log(f"[decomp] phase 12: {nranks} ranks on {len(mesh.cards)} card(s)"
        + (" (virtual ranks)" if mesh.virtual else "")
        + f"; MEDIUM auto grid {auto}, split grid {split}")
    rng = np.random.default_rng(seed)
    init = [rng.random((d, rank)) for d in tt.dims]
    iters = DECOMP_ITERS
    nmodes = tt.nmodes

    # the single-card reference from the same init: the COO cpd_als
    t0 = time.perf_counter()
    ref = cpd_als(tt, rank, Options(max_iterations=iters, tolerance=0.0,
                                    random_seed=0),
                  init=init, device=mesh.devices[0])
    ref_lam = ref.lam.cpu()
    log(f"[decomp] single-card COO cpd fits {list(ref.fits)} "
        f"({time.perf_counter() - t0:.1f} s)")

    # each decomposition's checks (rank 0's launches against the plain
    # version, the sync check of one sweep) run after its CPD, on the
    # layouts that CPD built (BuildSpy): one host build each
    checks = {}

    def nsorted(kind, grid=None):
        if kind == "coarse":
            return nmodes
        if kind == "medium":
            return len(alloc_build_modes(
                [ceil_to(max(d, g), g) // g for d, g in zip(tt.dims, grid)],
                Options()))
        return len(alloc_build_modes([ceil_to(d, nranks) for d in tt.dims],
                                     Options()))

    def run(label, decomp, want_launches, entry=distributed_cpd_als,
            data=None, check=None, **kw):
        x, ref_fits, ref_lam_ = data or (tt, ref.fits, ref_lam)
        resilience.reset_demotions()
        resilience.run_report().clear()
        sync_mesh(mesh)
        kernels.reset_launches()
        spy = BuildSpy(check[0]) if check is not None else None
        t0 = time.perf_counter()
        with spy or contextlib.nullcontext():
            out = entry(
                x, rank, opts=Options(max_iterations=iters, tolerance=0.0,
                                       random_seed=0, decomposition=decomp,
                                       comm_pattern=CommPattern.ALL2ALL,
                                       engine_fallback=False),
                init=init, mesh=mesh, **kw)
        sync_mesh(mesh)
        seconds = time.perf_counter() - t0
        launches = kernels.fused_mttkrp_t.launches
        demoted = [d.engine for d in resilience.demotions()]
        events = [{k: v for k, v in e.items() if k not in ("kind", "ts")}
                  for e in resilience.run_report().events("layout_imbalance")]
        steady = sum(out.iter_seconds[1:]) / (len(out.iter_seconds) - 1)
        diff = max(abs(a - b) for a, b in zip(out.fits, ref_fits))
        lam_rel = float((out.lam - ref_lam_).abs().max()
                        / ref_lam_.abs().max())
        row = dict(label=label, nnz=x.nnz, sec_per_iter=steady,
                   fits=list(out.fits),
                   fit_diff=diff, lam_rel_diff=lam_rel, launches=launches,
                   expected_launches=want_launches, demoted=demoted,
                   imbalance=events, seconds=seconds,
                   iter_seconds=list(out.iter_seconds))
        log(f"[decomp] {json.dumps(row)}")
        if len(out.fits) != iters or not diff <= PARITY_TOL:
            raise AssertionError(f"{label}: fits {out.fits} leave the "
                                 f"single-card CPD's {ref_fits}")
        if not lam_rel <= LAMBDA_TOL:
            raise AssertionError(f"{label}: λ relative difference "
                                 f"{lam_rel:.3e} > {LAMBDA_TOL}")
        if demoted:
            raise AssertionError(f"{label}: demoted {demoted}")
        if want_launches is not None and launches != want_launches:
            raise AssertionError(f"{label}: fused_mttkrp_t launched "
                                 f"{launches} times, expected "
                                 f"{want_launches}")
        if check is not None:
            kind, key, grid = check
            if "cells" not in spy.got:
                raise AssertionError(f"{label}: the {kind} layouts were not "
                                     f"built through the spied function")
            checks[key] = check_decomp(kind, tt, mesh, rank, init, grid,
                                       spy.got)
            del spy
        return row, out

    runs = {}
    runs["fine_stream"], stream = run("fine all2all stream",
                                      Decomposition.FINE, 0,
                                      local_engine="stream")
    runs["fine"], blocked = run("fine all2all blocked (the default)",
                                Decomposition.FINE,
                                nsorted("fine") * nranks * iters,
                                check=("fine", "fine", None))
    diff = max(abs(a - b) for a, b in zip(blocked.fits, stream.fits))
    lam_rel = float((blocked.lam - stream.lam).abs().max()
                    / stream.lam.abs().max())
    log(f"[decomp] fine blocked against stream: max |fit difference| "
        f"{diff:.3e}, λ relative difference {lam_rel:.3e}; "
        f"{runs['fine']['sec_per_iter']:.5f} against "
        f"{runs['fine_stream']['sec_per_iter']:.5f} s/iteration")
    if not (diff <= PARITY_TOL and lam_rel <= LAMBDA_TOL):
        raise AssertionError("the blocked FINE CPD leaves the stream one")
    runs["fine"].update(fit_diff_vs_stream=diff, lam_rel_vs_stream=lam_rel)
    del stream, blocked
    runs["medium"], _ = run(f"medium auto grid {auto}",
                            Decomposition.MEDIUM,
                            nsorted("medium", auto) * nranks * iters,
                            check=("medium", "medium", auto))
    runs["medium_split"], _ = run(f"medium grid {split}",
                                  Decomposition.MEDIUM,
                                  nsorted("medium", split) * nranks * iters,
                                  grid=split,
                                  check=("medium", "medium_split", split))
    runs["coarse"], _ = run("coarse", Decomposition.COARSE,
                            nsorted("coarse") * nranks * iters,
                            check=("coarse", "coarse", None))
    # the same split grid over a tensor relabeled by reorder.py's hgraph
    # strategy (equal fences), factors back in the original order; on
    # phase 6's 2M tensor of the same dims (the relabel's host time at
    # 20M is most of this phase's), against its own single-card CPD
    hg = synthetic_tensor(tt.dims, DECOMP_HGRAPH_NNZ, seed=5)
    hg_ref = cpd_als(hg, rank, Options(max_iterations=iters, tolerance=0.0,
                                       random_seed=0),
                     init=init, device=mesh.devices[0])
    runs["medium_split_hgraph"], _ = run(
        f"medium grid {split} relabel hgraph", Decomposition.MEDIUM,
        nsorted("medium", split) * nranks * iters, entry=grid_cpd_als,
        data=(hg, hg_ref.fits, hg_ref.lam.cpu()), grid=split,
        relabel="hgraph")
    del hg, hg_ref

    # the drill: with engine.fused_t armed and fallback off, MEDIUM
    # raises (on DRILL_NNZ nonzeros of the same dims: the host build of
    # the full tensor would only delay the raise)
    small = synthetic_tensor(tt.dims, DECOMP_DRILL_NNZ, seed=3)
    resilience.reset_demotions()
    faults.reset()
    faults.arm(*next(iter(faults.parse_schedule(
        "engine.fused_t:runtime").items())))
    err = None
    try:
        distributed_cpd_als(small, rank, Options(
            max_iterations=1, tolerance=0.0, random_seed=0,
            decomposition=Decomposition.MEDIUM, engine_fallback=False),
            init=init, mesh=mesh)
    except Exception as e:
        err = e
    finally:
        faults.reset()
    sync_mesh(mesh)
    if err is None or "injected" not in str(err):
        raise AssertionError(f"the engine.fused_t drill on MEDIUM did not "
                             f"raise: {err!r}")
    log(f"[decomp] drill engine.fused_t, fallback off, MEDIUM: raised "
        f"{err!r}")
    resilience.reset_demotions()
    resilience.run_report().clear()
    seconds = time.perf_counter() - t_phase
    log(f"[decomp] phase 12 took {seconds:.1f} s")
    return {"ranks": nranks, "cards": len(mesh.cards),
            "virtual": mesh.virtual, "auto_grid": list(auto),
            "split_grid": list(split), "ref_fits": list(ref.fits),
            "checks": checks, "runs": runs, "drill": repr(err)[:160],
            "launches": {k: runs[k]["launches"]
                         for k in ("fine", "medium", "medium_split",
                                   "coarse", "medium_split_hgraph")},
            "seconds": seconds}


def _decomp_summary(decomp: dict) -> dict:
    """Phase 12 in row 1 of the kernels line: the CPDs' launches and
    times, rank 0's launches against the plain version, the builds."""
    return dict(
        launches=decomp["launches"], ranks=decomp["ranks"],
        cards=decomp["cards"], auto_grid=decomp["auto_grid"],
        split_grid=decomp["split_grid"],
        sec_per_iter={k: r["sec_per_iter"]
                      for k, r in decomp["runs"].items()},
        rank0_rows=[r for c in decomp["checks"].values()
                    for r in c["rank0_rows"]],
        build_s={k: c["build_s"] for k, c in decomp["checks"].items()},
        sweep_host_ms={k: c["sweep_host_ms"]
                       for k, c in decomp["checks"].items()},
        phase_seconds=decomp["seconds"])


# -- phase 13: the host build, balanced packing and reordering ---------------

#: bench.py's amazon-like scenario (bench.py:110-123, :131-147, :177-179):
#: a user x item x word review tensor at 1/100 scale, zipf exponents per
#: mode; phase 13 draws it at both sizes and deduplicates
AMAZON_DIMS = (48212, 17742, 18051)
AMAZON_EXPONENTS = (1.5, 1.5, 1.2)
AMAZON_DRAWS = (2_000_000, 20_000_000)
#: phase 13's layout configurations: (packing, reorder)
BALANCE_CONFIGS = (("fixed", "identity"), ("balanced", "identity"),
                   ("balanced", "hgraph"))
#: the seed of phase 13's one init, which the CLI run draws itself
BALANCE_SEED = 7
#: phase 5's host layout build in an earlier run of this script, whose
#: layouts sorted with np.lexsort (H100 80GB HBM3 host, 700 W)
LEXSORT_BUILD_S = 59.3


def synthetic_zipf(dims, nnz: int, seed: int = 0,
                   exponents=AMAZON_EXPONENTS):
    """The port's copy of bench.py's synthetic_zipf (bench.py:131-147):
    slice popularity per mode follows zipf(exponents[m]), the hot slices
    scattered over the mode by a fixed permutation."""
    from splatt_tpu_torch.coo import SparseTensor

    rng = np.random.default_rng(seed)
    inds = np.empty((len(dims), nnz), dtype=np.int64)
    for m, d in enumerate(dims):
        raw = (rng.zipf(float(exponents[m]), size=nnz) - 1) % d
        inds[m] = rng.permutation(d)[raw]
    return SparseTensor(inds, rng.random(nnz), dims)


def sort_turns(tt) -> dict:
    """Mode 0's layout sort of `tt` by the native host sort and by
    np.lexsort, in turns (native, lexsort, native): the permutations must
    be equal.  The native sort must build here."""
    from splatt_tpu_torch import native
    from splatt_tpu_torch.blocked import secondary_order

    native.library()    # raises with the build's error: no silent lexsort
    order = [0] + secondary_order(tt.dims, 0)
    keys = tuple(tt.inds[m] for m in reversed(order))
    runs = {"native": [], "lexsort": []}
    perms = {}
    for kind in ("native", "lexsort", "native"):
        t0 = time.perf_counter()
        perm = (native.sort_perm(tt.inds, tt.dims, order)
                if kind == "native" else np.lexsort(keys))
        runs[kind].append(time.perf_counter() - t0)
        if perm is None:
            raise AssertionError("the native sort declined phase 3's "
                                 "tensor")
        perms.setdefault(kind, perm)
    if not np.array_equal(perms["native"], perms["lexsort"]):
        raise AssertionError("the native sort's permutation is not "
                             "np.lexsort's")
    out = {k: dict(runs=v, mean_s=sum(v) / len(v)) for k, v in runs.items()}
    log(f"[balance] sort of {tt.nnz} nonzeros by {order}, in turns: native "
        f"{runs['native']} s, np.lexsort {runs['lexsort']} s; equal "
        f"permutations")
    return out


def layout_stats(bs) -> list:
    """Each sparse layout's shape beside its build's ``layout_imbalance``
    event (the run report holds this build's events alone)."""
    from splatt_tpu_torch import resilience

    events = resilience.run_report().events("layout_imbalance")
    rows = []
    for lay in bs.layouts:
        ev = [e for e in events if e["mode"] == lay.mode][-1]
        rows.append(dict(
            mode=lay.mode, packing=lay.packing, reorder=lay.reorder,
            seg_width=lay.seg_width, nblocks=lay.nblocks,
            fill=lay.nnz / lay.nnz_pad,
            block_nnz_max_mean=ev["block_nnz_max_mean"],
            span_max_mean=ev["span_max_mean"], work_amp=ev["work_amp"],
            slice_max_mean=ev["slice_max_mean"]))
    return rows


def balance_launch(bs, factors, m: int, path: str, tag: str) -> dict:
    """Mode m's fused_mttkrp_t launch, as the CPD makes it, against its
    plain version, timed beside its bound; the partials' zeroing is in
    the timed ms."""
    from splatt_tpu_torch.ops.kernels import (fused_mttkrp_t,
                                              fused_mttkrp_t_plain)

    lay = bs.layout_for(m)
    acc = path == "privatized"
    width = -(-(bs.dims[m] + 1) // 8) * 8 if acc else lay.seg_width
    got, row = compare(
        lambda: fused_mttkrp_t(lay, factors, m, width, acc),
        lambda: fused_mttkrp_t_plain(lay, factors, m, width, acc),
        f"{tag} fused_mttkrp_t mode {m}")
    row["bound_ms"], row["bound_by"] = bound(lay, factors, m, got)
    row.update(tag=tag, mode=m, path=path, nnz=lay.nnz, nblocks=lay.nblocks,
               seg_width=lay.seg_width, packing=lay.packing,
               out_bytes=got.numel() * got.element_size(),
               ms_per_mnnz=row["ms"] / (lay.nnz / 1e6))
    log(f"[balance] {json.dumps(row)}")
    return row


def balance_config(tt, packing: str, how: str, init, rank: int,
                   tag: str) -> dict:
    """One configuration of phase 13: the layouts built as the CLI builds
    them (BlockedSparse.compile), with the host seconds of its reorder,
    sorts and pack as compile records them; the layouts' balance, the
    plan, and a 5-iteration CPD from `init` with fallback off and the
    launch counters at 0 just before; each fused_t launch of a balanced
    layout held to its plain version."""
    import torch

    from splatt_tpu_torch import Options, cpd_als, resilience
    from splatt_tpu_torch.blocked import BlockedSparse
    from splatt_tpu_torch.ops import kernels
    from splatt_tpu_torch.ops.mttkrp import describe_plan, plan_mttkrp

    opts = Options(max_iterations=ITERS, tolerance=0.0,
                   random_seed=BALANCE_SEED, engine_fallback=False,
                   fiber_packing=packing, reorder=how)
    resilience.reset_demotions()
    resilience.run_report().clear()
    t0 = time.perf_counter()
    bs = BlockedSparse.compile(tt, opts)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if (bs.perm is None) != (how == "identity") or bs.reorder != how:
        raise AssertionError(f"{tag}: the reorder {how} degraded: "
                             f"{resilience.run_report().events()}")
    secs = bs.build_seconds
    reorder_s, sort_s, pack_s = secs["reorder"], secs["sort"], secs["pack"]
    layouts = layout_stats(bs)
    tables = random_factors(bs, rank, 3)
    plans = {m: plan_mttkrp(bs, tables, m) for m in range(bs.nmodes)}
    want = sum(p.engine == "fused_t" for p in plans.values()) * ITERS
    log(f"[balance] {tag}: compile {build_s:.2f} s: reorder "
        f"{reorder_s:.2f} s, sorts {sort_s:.2f} s, pack (with the encode "
        f"and the copy to the card) {pack_s:.2f} s; "
        f"{describe_plan(bs, tables)}")
    for row in layouts:
        log(f"[balance] {tag} layout {json.dumps(row)}")
    resilience.reset_demotions()
    kernels.reset_launches()
    out = cpd_als(bs, rank, opts, init=init)
    torch.cuda.synchronize()
    launches = kernels.fused_mttkrp_t.launches
    demoted = [d.engine for d in resilience.demotions()]
    steady = sum(out.iter_seconds[1:]) / (len(out.iter_seconds) - 1)
    if demoted or launches != want:
        raise AssertionError(f"{tag}: fused_mttkrp_t launched {launches} "
                             f"times (the plan gives {want}); demoted "
                             f"{demoted}")
    rows = []
    if packing == "balanced":
        rows = [balance_launch(bs, tables, m, p.path, tag)
                for m, p in plans.items() if p.engine == "fused_t"]
    res = dict(tag=tag, packing=packing, reorder=how, nnz=tt.nnz,
               reorder_s=reorder_s, sort_s=sort_s, build_s=build_s,
               pack_s=pack_s, layouts=layouts,
               plan={m: f"{p.path}/{p.engine}" for m, p in plans.items()},
               launches=launches, fits=list(out.fits),
               ms_per_iter=steady * 1e3,
               iter_seconds=list(out.iter_seconds), rows=rows)
    log(f"[balance] {tag}: fits {res['fits']}; fused_mttkrp_t launches "
        f"{launches}; {steady * 1e3:.3f} ms/iteration (iterations "
        f"2..{ITERS})")
    res["true_fit"] = true_fit(tt, out.factors, out.lam)
    log(f"[balance] {tag}: the final model's fit in f64 against the "
        f"tensor {res['true_fit']:.9f} (the sweep's f32 fit "
        f"{out.fits[-1]:.9f})")
    res["factors"] = [U.cpu() for U in out.factors]
    res["lam"] = out.lam.cpu()
    res["bs"] = bs
    return res


def live_factor_rel(got, got_lam, want, want_lam) -> tuple:
    """(the live columns, max over modes of max|got - want| / max|want| on
    them): a column is live where λ is at least 1e-4 of the largest in
    both runs; a dead one (λ near 0) adds nothing to the model and is not
    determined by it."""
    live = ((want_lam >= 1e-4 * want_lam.max())
            & (got_lam >= 1e-4 * got_lam.max()))
    rel = max(float((g[:, live] - w[:, live]).abs().max()
                    / w[:, live].abs().max()) for g, w in zip(got, want))
    return int(live.sum()), rel


def true_fit(tt, factors, lam, chunk: int = 1 << 20) -> float:
    """The fit of the Kruskal model (`factors` in the tensor's labels,
    `lam`) against `tt`, every sum in f64 on the card:
    1 - ||X - Z|| / ||X|| with <X,Z> summed over the nonzeros."""
    import torch

    dev = factors[0].device
    U = [f.to(torch.float64) for f in factors]
    lam = lam.to(dev, torch.float64)
    had = torch.outer(lam, lam)
    for u in U:
        had = had * (u.T @ u)
    vals = torch.from_numpy(np.asarray(tt.vals, dtype=np.float64)).to(dev)
    inner = torch.zeros((), dtype=torch.float64, device=dev)
    for lo in range(0, tt.nnz, chunk):
        hi = min(tt.nnz, lo + chunk)
        prod = lam[None, :].expand(hi - lo, -1).clone()
        for k, u in enumerate(U):
            idx = torch.from_numpy(np.asarray(tt.inds[k][lo:hi])).to(dev)
            prod *= u.index_select(0, idx.long())
        inner += (prod.sum(dim=1) * vals[lo:hi]).sum()
    x = float((vals * vals).sum())
    res = max(x + float(had.sum()) - 2.0 * float(inner), 0.0)
    return 1.0 - math.sqrt(res) / math.sqrt(x)


def mttkrp_turns(tt, cfgs: dict, rank: int) -> dict:
    """Each configuration's MTTKRP of every mode, through its own engine
    chain, on one set of f32 factors in the original labels (moved in
    through its permutation, its output back out), against the f64
    MTTKRP of the original tensor (the stream path on the card): per
    mode the largest difference relative to max|reference|, and the
    tolerance it is held to: KERNEL_TOL on a kernel path, SCATTER_TOL on
    the plain ``scatter``/``sorted_scatter`` path (f32 atomics over whole
    slices)."""
    import torch

    from splatt_tpu_torch.ops.mttkrp import mttkrp, mttkrp_stream, plan_mttkrp

    base = cfgs["fixed+identity"]["bs"]
    F = random_factors(base, rank, 5)
    inds = torch.from_numpy(np.asarray(tt.inds)).to(base.device)
    vals = torch.from_numpy(np.asarray(tt.vals, dtype=np.float64)).to(
        base.device)
    F64 = [U.to(torch.float64) for U in F]
    want = [mttkrp_stream(inds, vals, F64, m, tt.dims[m])
            for m in range(tt.nmodes)]
    del inds, vals
    out = {}
    for name, cfg in cfgs.items():
        bs = cfg["bs"]
        perm = bs.perm
        Fi = (F if perm is None
              else [perm.permute_factor(U, m) for m, U in enumerate(F)])
        rels, tols = [], []
        for m in range(bs.nmodes):
            got = mttkrp(bs, Fi, m, fallback=False)
            if perm is not None:
                got = perm.apply_to_factor(got, m)
            rels.append(float((got.to(torch.float64) - want[m]).abs().max()
                              / want[m].abs().max()))
            path = plan_mttkrp(bs, Fi, m).path
            tols.append(KERNEL_TOL if path in ("sorted_onehot", "privatized")
                        else SCATTER_TOL)
        torch.cuda.synchronize()
        out[name] = dict(rel=rels, tol=tols)
    log(f"[balance] every mode's MTTKRP against the f64 MTTKRP of the "
        f"tensor, relative: {json.dumps(out)}")
    return out


def packing_turns(cfgs: dict, rank: int) -> dict:
    """Each sorted mode's fused_mttkrp_t launch (sorted contract) on the
    three configurations' layouts, in turns, where all three run it: ms
    per launch and per million nonzeros, beside the seg width and the
    bytes of the (nb, seg_width, R) partials it writes."""
    from splatt_tpu_torch.ops.kernels import fused_mttkrp_t

    out = {}
    nmodes = len(next(iter(cfgs.values()))["plan"])
    for m in range(nmodes):
        if any(c["plan"][m] != "sorted_onehot/fused_t"
               for c in cfgs.values()):
            continue
        fns, shapes = {}, {}
        for name, cfg in cfgs.items():
            lay = cfg["bs"].layout_for(m)
            tables = random_factors(cfg["bs"], rank, 3)
            fns[name] = (lambda lay=lay, tables=tables: fused_mttkrp_t(
                lay, tables, m, lay.seg_width, False))
            shapes[name] = dict(seg_width=lay.seg_width, nblocks=lay.nblocks,
                                nnz=lay.nnz, partials_mb=lay.nblocks
                                * lay.seg_width * rank * 4 / 1e6)
        turns = in_turns(fns, reps=20)
        out[m] = {k: dict(v, ms_per_mnnz=v["ms"] / (shapes[k]["nnz"] / 1e6),
                          **shapes[k]) for k, v in turns.items()}
        log(f"[balance] mode {m} fused_mttkrp_t in turns: "
            + "; ".join(f"{k} {v['ms']:.4f} ms (seg {v['seg_width']}, "
                        f"{v['partials_mb']:.1f} MB of partials)"
                        for k, v in out[m].items()))
    return out


def cli_bin_run(tt, rank: int) -> dict:
    """The normal entry point: the tensor written with io.save as .bin and
    factored by ``python -m splatt_tpu_torch.cli cpd --mmap`` under
    SPLATT_FIBER_PACKING=balanced and SPLATT_REORDER=hgraph, in a
    subprocess on the card; its factor files are read back for the
    model's fit in f64."""
    import os
    import shutil
    import tempfile

    import torch

    from splatt_tpu_torch.io import read_matrix, save

    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_", dir=root)
    try:
        path = os.path.join(tmp, "amazon.bin")
        t0 = time.perf_counter()
        save(tt, path)
        save_s = time.perf_counter() - t0
        stem = os.path.join(tmp, "cli")
        cmd = [sys.executable, "-m", "splatt_tpu_torch.cli", "cpd", path,
               "-r", str(rank), "-i", str(ITERS), "--tol", "0", "--seed",
               str(BALANCE_SEED), "-s", stem, "--mmap", "--json",
               "--engine-fallback", "off"]
        env = dict(os.environ, SPLATT_FIBER_PACKING="balanced",
                   SPLATT_REORDER="hgraph")
        t0 = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           cwd=root, timeout=600)
        seconds = time.perf_counter() - t0
        model = None
        if r.returncode == 0:
            model = ([read_matrix(f"{stem}.mode{m + 1}.mat")
                      for m in range(tt.nmodes)],
                     read_matrix(f"{stem}.lambda.mat").ravel())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for line in r.stdout.splitlines():
        log(f"[balance] cli | {line}")
    if r.returncode != 0:
        raise AssertionError(f"the cli run failed ({r.returncode}): "
                             f"{r.stderr[-2000:]}")
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    kinds = [e["kind"] for e in rec["events"]]
    if rec["demotions"] or "reorder_fallback" in kinds \
            or "packing_fallback" in kinds:
        raise AssertionError(f"the cli run degraded: {rec}")
    fit64 = true_fit(tt, [torch.from_numpy(U).cuda() for U in model[0]],
                     torch.from_numpy(model[1]))
    return dict(cmd=" ".join(cmd[1:]), fit=rec["fit"], true_fit=fit64,
                seconds=seconds, save_s=save_s,
                bin_mb=tt.nnz * (4 * tt.nmodes + 8) / 1e6,
                imbalance=[e for e in rec["events"]
                           if e["kind"] == "layout_imbalance"])


def balance_v2(cfg: dict, tt, rank: int, init) -> dict:
    """The balanced layouts of `cfg` re-encoded under ``auto`` (v2): each
    fused_v2 launch against its plain version, and the CPD's launches and
    fits against `cfg`'s."""
    import dataclasses

    import torch

    from splatt_tpu_torch import Options, cpd_als, resilience
    from splatt_tpu_torch.blocked import reencode_layout
    from splatt_tpu_torch.config import LayoutFormat
    from splatt_tpu_torch.ops import kernels
    from splatt_tpu_torch.ops.kernels import (fused_mttkrp_v2,
                                              fused_mttkrp_v2_plain)
    from splatt_tpu_torch.ops.mttkrp import plan_mttkrp

    bs = cfg["bs"]
    v2 = dataclasses.replace(bs, layouts=[
        reencode_layout(lay, LayoutFormat(idx="auto")) for lay in bs.layouts])
    tables = random_factors(v2, rank, 3)
    plans = {m: plan_mttkrp(v2, tables, m) for m in range(v2.nmodes)}
    rows = []
    for m, p in plans.items():
        if p.engine != "fused_v2":
            continue
        lay = v2.layout_for(m)
        acc = p.path == "privatized"
        width = -(-(v2.dims[m] + 1) // 8) * 8 if acc else lay.seg_width
        got, row = compare(
            lambda: fused_mttkrp_v2(lay, tables, m, width, acc),
            lambda: fused_mttkrp_v2_plain(lay, tables, m, width, acc),
            f"balanced auto fused_mttkrp_v2 mode {m}")
        row["bound_ms"], row["bound_by"] = v2_bound(lay, tables, m, got)
        row.update(mode=m, path=p.path, format=lay.format_desc(),
                   bytes=lay.storage_bytes())
        log(f"[balance] {json.dumps(row)}")
        rows.append(row)
    opts = Options(max_iterations=ITERS, tolerance=0.0,
                   random_seed=BALANCE_SEED, engine_fallback=False)
    resilience.reset_demotions()
    kernels.reset_launches()
    out = cpd_als(v2, rank, opts, init=init)
    torch.cuda.synchronize()
    launches = kernels.fused_mttkrp_v2.launches
    diff = max(abs(a - b) for a, b in zip(out.fits, cfg["fits"]))
    want = len(rows) * ITERS
    fit64 = true_fit(tt, out.factors, out.lam)
    log(f"[balance] balanced auto (v2) CPD: fits {list(out.fits)}, max "
        f"|fit difference| to {cfg['tag']} {diff:.3e}, the model's f64 fit "
        f"{fit64:.9f} against {cfg['true_fit']:.9f}; fused_mttkrp_v2 "
        f"launches {launches} (want {want})")
    if launches != want or resilience.demotions():
        raise AssertionError("the balanced v2 CPD left its launches or "
                             "engines")
    steady = sum(out.iter_seconds[1:]) / (len(out.iter_seconds) - 1)
    return dict(rows=rows, launches=launches, fits=list(out.fits),
                fit_diff=diff, true_fit=fit64,
                true_fit_diff=abs(fit64 - cfg["true_fit"]),
                ms_per_iter=steady * 1e3)


def balance_drills(tt, rank: int, init) -> dict:
    """The two degrades on the 2M-draw tensor: layout.pack armed on every
    build gives packing_fallback and fixed layouts, reorder.apply armed
    once gives reorder_fallback and identity order; each CPD finishes with
    fused_t launched and no kernel demoted."""
    import torch

    from splatt_tpu_torch import Options, cpd_als, resilience
    from splatt_tpu_torch.blocked import BlockedSparse
    from splatt_tpu_torch.ops import kernels
    from splatt_tpu_torch.utils import faults

    out = {}
    # layout.pack on balanced + identity (its fixed layouts are fixed +
    # identity's), reorder.apply on balanced + hgraph
    for site, times, event, how in (
            ("layout.pack", faults.ALWAYS, "packing_fallback", "identity"),
            ("reorder.apply", 1, "reorder_fallback", "hgraph")):
        opts = Options(max_iterations=DRILL_ITERS, tolerance=0.0,
                       random_seed=BALANCE_SEED, engine_fallback=False,
                       fiber_packing="balanced", reorder=how)
        resilience.reset_demotions()
        resilience.run_report().clear()
        faults.reset()
        with faults.inject(site, "runtime", times=times):
            bs = BlockedSparse.compile(tt, opts)
        events = resilience.run_report().events(event)
        kernels.reset_launches()
        res = cpd_als(bs, rank, opts, init=init)
        torch.cuda.synchronize()
        row = dict(events=len(events),
                   packings=[lay.packing for lay in bs.layouts],
                   reorder=bs.reorder, fits=list(res.fits),
                   launches=kernels.fused_mttkrp_t.launches,
                   demoted=[d.engine for d in resilience.demotions()])
        log(f"[balance] drill {site}: {json.dumps(row)}")
        ok = (events and row["launches"] > 0 and not row["demoted"]
              and math.isfinite(res.fit) and len(res.fits) == DRILL_ITERS)
        if site == "layout.pack":
            ok = ok and set(row["packings"]) == {"fixed"}
        else:
            ok = ok and bs.reorder == "identity" and bs.perm is None
        if not ok:
            raise AssertionError(f"the {site} drill: {row}")
        out[site] = row
    resilience.reset_demotions()
    resilience.run_report().clear()
    return out


def phase_balance(nell2, nell2_build_s: float, rank: int) -> dict:
    """Phase 13: the native sort on phase 3's tensor, then the amazon-like
    tensor at 2M and 20M draws under fixed + identity, balanced +
    identity and balanced + hgraph; the CLI's .bin --mmap run, the v2
    layouts and the degrades (see the module docstring)."""
    import torch

    from splatt_tpu_torch.cpd import init_factors

    t_phase = time.perf_counter()
    failures = []

    def gate(ok: bool, msg: str) -> None:
        # every check of the phase runs; the phase fails at its end
        if not ok:
            log(f"[balance] CHECK FAILED: {msg}")
            failures.append(msg)

    # phase 6's 2M-nonzero tensor of the same shape: one np.lexsort of
    # phase 3's 20M nonzeros takes 12-23 s, which the whole script cannot
    # spare within the contract's time beside phase 19
    sort = sort_turns(synthetic_tensor(NELL2, BIG_RANK_NNZ, seed=5))
    log(f"[balance] phase 5's host layout build (3 layouts, ALLMODE): "
        f"{nell2_build_s:.2f} s with the native sort; an earlier run "
        f"{LEXSORT_BUILD_S} s with np.lexsort")
    sizes = {}
    for draws in AMAZON_DRAWS:
        t0 = time.perf_counter()
        tt = synthetic_zipf(AMAZON_DIMS, draws, seed=0).deduplicate()
        gen_s = time.perf_counter() - t0
        log(f"[balance] amazon-like {AMAZON_DIMS}, {draws} draws: {tt.nnz} "
            f"nonzeros after dedup ({gen_s:.1f} s)")
        # the one init: what `cpd --seed 7` draws, in the original labels
        init = [U.numpy() for U in init_factors(
            tt.dims, rank, torch.Generator().manual_seed(BALANCE_SEED))]
        cfgs = {}
        for packing, how in BALANCE_CONFIGS:
            tag = f"{draws // 1_000_000}M {packing}+{how}"
            cfgs[f"{packing}+{how}"] = balance_config(tt, packing, how, init,
                                                      rank, tag)
        base = cfgs["fixed+identity"]
        turns = mttkrp_turns(tt, cfgs, rank)
        timed = packing_turns(cfgs, rank)
        for name, cfg in cfgs.items():
            cfg["fit_diff"] = max(abs(a - b) for a, b in
                                  zip(cfg["fits"], base["fits"]))
            cfg["true_fit_diff"] = abs(cfg["true_fit"] - base["true_fit"])
            cfg["lam_rel_diff"] = float((cfg["lam"] - base["lam"]).abs().max()
                                        / base["lam"].abs().max())
            cfg["mttkrp"] = turns[name]
        ident = cfgs["balanced+identity"]
        hg = cfgs["balanced+hgraph"]
        live, rel = live_factor_rel(hg["factors"], hg["lam"],
                                    ident["factors"], ident["lam"])
        log(f"[balance] {draws} draws, against fixed + identity: the sweeps' "
            f"f32 fits within "
            + ", ".join(f"{k} {c['fit_diff']:.3e}" for k, c in cfgs.items())
            + "; the final models' f64 fits within "
            + ", ".join(f"{k} {c['true_fit_diff']:.3e}"
                        for k, c in cfgs.items())
            + "; λ within "
            + ", ".join(f"{k} {c['lam_rel_diff']:.3e}"
                        for k, c in cfgs.items())
            + f" (relative); hgraph factors (original order) on the "
            f"{live} live columns within {rel:.3e} of balanced + "
            f"identity's, relative")
        # held at both sizes: every mode's MTTKRP of each layout on one
        # set of factors, moved in through the permutation and its output
        # back out, against the f64 MTTKRP.  Held at 20M draws: the final
        # models' fits taken in f64 against the original tensor (they
        # need the factors back in the original row order) and the hgraph
        # run's live factors.  Printed only: the sweeps' f32 fits, which
        # misread the fit by ~1e-3 on this well-fit tensor (the f32
        # <X,X> + <Z,Z> - 2<X,Z> cancels), so another summation order
        # moves them by that much; and at 2M draws every CPD figure: that
        # rank-50 CPD keeps 3 live components in f32 and another
        # summation order moves its model (PERF.md)
        for name, cfg in cfgs.items():
            gate(all(r <= t for r, t in zip(cfg["mttkrp"]["rel"],
                                            cfg["mttkrp"]["tol"])),
                 f"{cfg['tag']}: the MTTKRP leaves the f64 one by "
                 f"{cfg['mttkrp']}")
            if draws == AMAZON_DRAWS[-1]:
                gate(cfg["true_fit_diff"] <= MODEL_FIT_TOL,
                     f"{cfg['tag']}: the final model's f64 fit leaves fixed "
                     f"+ identity's by {cfg['true_fit_diff']:.3e}")
        if draws == AMAZON_DRAWS[-1]:
            gate(rel <= FACTOR_TOL,
                 f"{draws} draws: the hgraph run's live factors leave the "
                 f"identity run's by {rel:.3e}, relative")
        mode0 = {k: c["plan"][0] for k, c in cfgs.items()}
        widths = {k: c["layouts"][[r["mode"] for r in c["layouts"]].index(0)]
                  ["seg_width"] for k, c in cfgs.items()}
        expected = (mode0["fixed+identity"].startswith("sorted_scatter")
                    and mode0["balanced+identity"].endswith("/fused_t"))
        log(f"[balance] {draws} draws: mode 0 plans {mode0}, seg widths "
            f"{widths}; " + ("as predicted" if expected or draws != 2_000_000
                             else "NOT the predicted sorted_scatter -> "
                                  "fused_t at 2M draws"))
        size = dict(nnz=tt.nnz, gen_s=gen_s, hgraph_factor_rel=rel,
                    packing_turns=timed,
                    hgraph_live_columns=live,
                    mttkrp_rel=turns,
                    mode0_plans=mode0, mode0_seg_widths=widths,
                    configs={k: {kk: vv for kk, vv in c.items()
                                 if kk not in ("bs", "factors", "lam")}
                             for k, c in cfgs.items()})
        if draws == AMAZON_DRAWS[-1]:
            size["cli"] = cli_bin_run(tt, rank)
            size["cli"]["fit_diff"] = abs(size["cli"]["fit"]
                                          - hg["fits"][-1])
            size["cli"]["true_fit_diff"] = abs(size["cli"]["true_fit"]
                                               - hg["true_fit"])
            gate(size["cli"]["true_fit_diff"] <= MODEL_FIT_TOL,
                 "the cli run's model leaves the in-process run's")
            log(f"[balance] cli .bin --mmap run: fit {size['cli']['fit']} "
                f"against {hg['fits'][-1]} ({size['cli']['fit_diff']:.3e}); "
                f"its model's f64 fit {size['cli']['true_fit']:.9f} against "
                f"{hg['true_fit']:.9f} "
                f"({size['cli']['true_fit_diff']:.3e}); "
                f"{size['cli']['seconds']:.1f} s with its start")

            size["v2"] = balance_v2(ident, tt, rank, init)
            gate(size["v2"]["true_fit_diff"] <= MODEL_FIT_TOL,
                 "the balanced v2 CPD's model leaves balanced + identity's")

        else:
            size["drills"] = balance_drills(tt, rank, init)
        for c in cfgs.values():
            c.pop("bs", None)
        sizes[f"{draws // 1_000_000}M"] = size
        del cfgs, tt
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    log(f"[balance] phase 13 took {seconds:.1f} s")
    if failures:
        raise AssertionError(f"phase 13: {len(failures)} check(s) failed: "
                             f"{failures}")
    return dict(sort=sort, nell2_build_s=nell2_build_s,
                lexsort_build_s=LEXSORT_BUILD_S, sizes=sizes,
                seconds=seconds)


def _balance_t_row(bal: dict) -> dict:
    """Row 1 of the kernels line from phase 13 alone (``--balance``): the
    20M-draw balanced configurations' launches against the plain
    version, the CPDs' launches of all three configurations."""
    return _record_row(
        "fused_mttkrp_t", FUSED_SRC, f"{PK}:355",
        sum(c["launches"] for c in bal["sizes"]["20M"]["configs"].values()),
        _balance_rows(bal), None,
        note=f"ms/plain_ms/bound_ms: mean per launch over phase 13's "
        f"balanced layouts of the amazon-like tensor (20M draws), rank "
        f"{RANK}, f32; launches: phase 13's three 20M-draw CPDs",
        status=WALK_STATUS, phase13=_balance_summary(bal))


def _balance_v2_row(bal: dict) -> dict:
    """Row 6 of the kernels line from phase 13 alone: the balanced auto
    layouts' fused_v2 launches against the plain version."""
    v2 = bal["sizes"]["20M"]["v2"]
    return _record_row(
        "fused_mttkrp_v2", "splatt_tpu_torch/csrc/fused_mttkrp_v2.cu",
        f"{PK}:702", v2["launches"], v2["rows"], None,
        note=f"ms/plain_ms/bound_ms: mean per launch over phase 13's "
        f"balanced auto (v2) layouts of the amazon-like tensor (20M "
        f"draws), rank {RANK}; launches: their CPD", phase13=v2)


def _balance_rows(bal: dict) -> list:
    """Phase 13's balanced fused_t rows (the 20M-draw tensor's)."""
    return [r for c in bal["sizes"]["20M"]["configs"].values()
            for r in c["rows"]]


def _balance_summary(bal: dict) -> dict:
    """Phase 13 in row 1 of the kernels line: per size and configuration
    the launches, ms per iteration, host seconds and mode 0's plan."""
    return dict(
        sort=bal["sort"], nell2_build_s=bal["nell2_build_s"],
        sizes={k: dict(nnz=s["nnz"], mode0_plans=s["mode0_plans"],
                       packing_turns=s["packing_turns"],
                       mode0_seg_widths=s["mode0_seg_widths"],
                       configs={n: dict(launches=c["launches"],
                                        ms_per_iter=c["ms_per_iter"],
                                        reorder_s=c["reorder_s"],
                                        sort_s=c["sort_s"],
                                        pack_s=c["pack_s"],
                                        fit_diff=c["fit_diff"],
                                        true_fit_diff=c["true_fit_diff"],
                                        lam_rel_diff=c["lam_rel_diff"])
                                for n, c in s["configs"].items()})
               for k, s in bal["sizes"].items()},
        phase_seconds=bal["seconds"])


# -- phase 14: the guarded driver, checkpoints and observability ----------

#: phase 14's rollback budget on the guarded runs (SPLATT_HEALTH_RETRIES)
GUARD_RETRIES = 2
#: the iteration phase 14's rollback and degrade drills poison
GUARD_NAN_ITER = 3
#: phase 14's checkpoint/resume and deferred-check runs
GUARD_ITERS = 6
#: the profiled sweep's iterations (each mode's bracket is one host-clock
#: sample an iteration, so every iteration of the run) and its per-mode
#: MTTKRP tolerance against the same MTTKRP calls timed in the same
#: fenced bracket, relative
PROFILED_ITERS = ITERS
PROFILED_MTTKRP_TOL = 0.2
#: the guarded fits against phase 5's, and the resumed/deferred fits
#: against their uninterrupted/k = 1 twins
GUARD_FIT_TOL = 1e-6
RESUME_FIT_TOL = 1e-4


def count_syncs(fn) -> int:
    """The host syncs `fn` makes, counted from the warnings of
    torch.cuda.set_sync_debug_mode("warn")."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in got)


def sync_probe() -> dict:
    """The syncs the warn mode reports for each kind of host read of a
    small CUDA tensor."""
    import torch

    a = torch.ones((), device="cuda")
    v = torch.ones(5, device="cuda")
    reads = {"float(0-d)": lambda: float(a), "0-d.item()": lambda: a.item(),
             "0-d.cpu()": lambda: a.cpu(),
             "1-elem.cpu()": lambda: a.reshape(1).cpu(),
             "5-elem.cpu()": lambda: v.cpu(),
             "5-elem.cpu().numpy()": lambda: v.cpu().numpy(),
             "synchronize()": torch.cuda.synchronize}
    return {k: count_syncs(fn) for k, fn in reads.items()}


def guard_run(bs, rank: int, retries: int, traced: bool = False,
              iters: int = ITERS, **kw):
    """cpd_als on phase 5's layouts, options and seed inside a resilience
    scope with `retries` as its health budget, fallback off, the launch
    counters at 0 just before: (result, scope, fused_mttkrp_t launches,
    seconds)."""
    import torch

    from splatt_tpu_torch import Options, cpd_als, resilience
    from splatt_tpu_torch.config import BlockAlloc, Verbosity
    from splatt_tpu_torch.ops import kernels

    opts = Options(block_alloc=BlockAlloc.ALLMODE, max_iterations=iters,
                   tolerance=0.0, random_seed=0, engine_fallback=False,
                   verbosity=kw.pop("verbosity", Verbosity.NONE),
                   trace=traced, fit_check_every=kw.pop("k", 1))
    with resilience.scope("phase14", health_retries=retries) as sc:
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = cpd_als(bs, rank, opts, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    if sc.demoted:
        raise AssertionError(f"demotions in phase 14: {list(sc.demoted)}")
    return out, sc, kernels.fused_mttkrp_t.launches, seconds


def _max_diff(a, b) -> float:
    if len(a) != len(b):
        raise AssertionError(f"fit lists of lengths {len(a)} and {len(b)}")
    return max(abs(x - y) for x, y in zip(a, b))


def _factor_rel(a, b) -> float:
    """The largest difference of two models' factors and λ, relative to
    each one's largest entry (this tensor's fits are ~3e-6, so a fit
    tolerance alone says little)."""
    pairs = list(zip(a.factors, b.factors)) + [(a.lam, b.lam)]
    return max(float((x.float() - y.float()).abs().max())
               / max(float(y.float().abs().max()), 1e-30)
               for x, y in pairs)


def guard_and_sync(bs, rank: int, main_fits: list, tmp: str) -> dict:
    """14.1: the unguarded and the guarded traced runs against phase 5's
    fits and launches, the syncs of one checked iteration per setting,
    and the iteration's ms per setting in turns."""
    from splatt_tpu_torch import trace

    nm = bs.nmodes
    out = {}
    models = {}
    for label, retries, traced in (("guard_off", 0, False),
                                   ("guard_on_traced", GUARD_RETRIES, True)):
        if traced:
            trace.reset()
        res, sc, launches, _ = guard_run(bs, rank, retries, traced)
        models[label] = res
        diff = _max_diff(list(res.fits), main_fits)
        kinds = [e["kind"] for e in sc.report.events()]
        log(f"[guard] {label}: fits {list(res.fits)}; max |fit - phase "
            f"5's| {diff:.3e}; fused_mttkrp_t launches {launches}; events "
            f"{kinds}")
        if diff > GUARD_FIT_TOL or launches != nm * ITERS:
            raise AssertionError(f"{label}: fits {diff:.3e} from phase 5's "
                                 f"or {launches} launches (want "
                                 f"{nm * ITERS})")
        out[label] = dict(fits=list(res.fits), launches=launches,
                          max_fit_diff=diff, iter_seconds=list(
                              res.iter_seconds))
        if traced:
            path = os.path.join(tmp, "guarded.json")
            ev = trace.write_chrome_trace(path)
            if not ev["ok"]:
                raise AssertionError(f"trace export failed: {ev}")
            out["trace_path"] = path
            out["traced_iter_seconds"] = list(res.iter_seconds)
    rel = _factor_rel(models["guard_on_traced"], models["guard_off"])
    log(f"[guard] guarded model against the unguarded one: factors and λ "
        f"within {rel:.3e} (relative)")
    if rel > RESUME_FIT_TOL:
        raise AssertionError(f"the guard moved the model by {rel:.3e}")
    out["model_rel_diff"] = rel
    probe = sync_probe()
    log(f"[guard] syncs that set_sync_debug_mode('warn') reports per "
        f"host read: {probe}")
    out["sync_probe"] = probe
    # the syncs of one checked iteration: a 3-iteration run's less a
    # 2-iteration run's, per setting
    syncs = {}
    for label, retries, traced in (("guard_off", 0, False),
                                   ("guard_on", GUARD_RETRIES, False),
                                   ("guard_on_traced", GUARD_RETRIES, True)):
        n = [count_syncs(lambda i=i: guard_run(bs, rank, retries, traced,
                                               iters=i))
             for i in (2, 3)]
        syncs[label] = n[1] - n[0]
    log(f"[guard] host syncs of one checked iteration: {syncs}")
    if len(set(syncs.values())) != 1:
        raise AssertionError(f"the guard or the trace adds syncs: {syncs}")
    trace.reset()
    # the iteration's ms, the three settings in turns (a, b, c, c, b, a)
    order = (("guard_off", 0, False), ("guard_on", GUARD_RETRIES, False),
             ("guard_on_traced", GUARD_RETRIES, True))
    ms = {k: [] for k, _, _ in order}
    for label, retries, traced in order + order[::-1]:
        res = guard_run(bs, rank, retries, traced)[0]
        ms[label].append(1e3 * sum(res.iter_seconds[1:])
                         / (len(res.iter_seconds) - 1))
        trace.reset()
    ms = {k: dict(ms=sum(v) / len(v), runs=v) for k, v in ms.items()}
    log(f"[guard] ms per iteration (iterations 2..{ITERS}), in turns: "
        + ", ".join(f"{k} {v['ms']:.4f} {v['runs']}" for k, v in ms.items()))
    out.update(syncs_per_checked_iteration=syncs, iter_ms_in_turns=ms)
    return out


def guard_drills(bs, rank: int, tmp: str) -> dict:
    """14.2: a cpd.sweep NaN at GUARD_NAN_ITER rolled back (fused_t
    launched for the re-run sweep), then an exhausted budget degrading to
    a checkpoint at the last healthy check."""
    from splatt_tpu_torch.cpd import load_checkpoint
    from splatt_tpu_torch.utils import faults

    nm = bs.nmodes
    with faults.inject("cpd.sweep", "nan", iter_at=GUARD_NAN_ITER):
        res, sc, launches, _ = guard_run(bs, rank, GUARD_RETRIES)
    ev = [(e["kind"], e.get("iteration")) for e in sc.report.events()
          if e["kind"].startswith("health_")]
    log(f"[guard] rollback drill: events {ev}; fit {res.fit}; fused_t "
        f"launches {launches}")
    want = [("health_nonfinite", GUARD_NAN_ITER),
            ("health_rollback", GUARD_NAN_ITER)]
    if ev != want or not (math.isfinite(res.fit) and 0 < res.fit <= 1) \
            or launches != nm * (ITERS + 1):
        raise AssertionError(f"rollback drill: events {ev}, fit {res.fit}, "
                             f"{launches} launches (want {want}, "
                             f"{nm * (ITERS + 1)})")
    rollback = dict(events=ev, fit=res.fit, launches=launches)
    # degrade: budget 1, every sweep after iteration 2's check poisoned
    # (budget 0 turns the sentinel off, in the JAX package too)
    ck = os.path.join(tmp, "degrade.npz")
    seen = [0]

    def arm_after_two():
        seen[0] += 1
        if seen[0] == 2:
            faults.arm("cpd.sweep", faults.FaultSpec(kind="nan",
                                                     times=faults.ALWAYS))
        return False

    try:
        res, sc, launches, _ = guard_run(bs, rank, 1, checkpoint_path=ck,
                                         checkpoint_every=10,
                                         stop=arm_after_two)
    finally:
        faults.reset()
    deg = sc.report.events("health_degraded")
    f, lam, it, fit = load_checkpoint(ck)
    log(f"[guard] degrade drill: {[e['kind'] for e in sc.report.events()]}; "
        f"checkpoint at iteration {it}, fit {fit}; result fit {res.fit}")
    if len(deg) != 1 or it != 2 or abs(fit - res.fits[1]) > 0 \
            or not math.isfinite(res.fit):
        raise AssertionError(f"degrade drill: {deg}, checkpoint it {it} "
                             f"fit {fit}, run fits {list(res.fits)}")
    return dict(rollback=rollback, degrade=dict(
        events=[e["kind"] for e in sc.report.events()], checkpoint_it=it,
        checkpoint_fit=fit))


def guard_resume(bs, rank: int, tmp: str) -> dict:
    """14.3: GUARD_ITERS iterations checkpointed every 2 and stopped after
    iteration 4, then resumed, against the uninterrupted run; each save's
    parts timed (host copy, sha256, np.savez, fsync and renames)."""
    import splatt_tpu_torch.cpd as tcpd
    from splatt_tpu_torch.cpd import load_checkpoint

    whole = guard_run(bs, rank, GUARD_RETRIES, iters=GUARD_ITERS)[0]
    ck = os.path.join(tmp, "resume.npz")
    saves = []
    real = tcpd._save_checkpoint

    def timed(*a, **kw):
        t0 = time.perf_counter()
        parts = real(*a, **kw)
        saves.append(dict(parts, ms=(time.perf_counter() - t0) * 1e3))
        return parts

    tcpd._save_checkpoint = timed
    try:
        seen = [0]

        def stop_after_four():
            seen[0] += 1
            return seen[0] == 4

        first = guard_run(bs, rank, GUARD_RETRIES, iters=GUARD_ITERS,
                          checkpoint_path=ck, checkpoint_every=2,
                          stop=stop_after_four)[0]
        rest = guard_run(bs, rank, GUARD_RETRIES, iters=GUARD_ITERS,
                         checkpoint_path=ck, checkpoint_every=2)[0]
    finally:
        tcpd._save_checkpoint = real
    fits = list(first.fits) + list(rest.fits)
    diff = _max_diff(fits, list(whole.fits))
    rel = _factor_rel(rest, whole)
    it = load_checkpoint(ck)[2]
    ms = [round(s["ms"], 3) for s in saves]
    log(f"[guard] checkpoint/resume: stopped at {list(first.fit_iters)}, "
        f"resumed {list(rest.fit_iters)}; max |fit - uninterrupted| "
        f"{diff:.3e}, factors and λ within {rel:.3e} (relative); last "
        f"checkpoint iteration {it}; save ms {ms}; parts "
        + json.dumps([{k: round(v * 1e3, 3) for k, v in s.items()
                       if k.endswith("_s")} for s in saves]))
    if diff > RESUME_FIT_TOL or rel > RESUME_FIT_TOL \
            or list(first.fit_iters) != [1, 2, 3, 4] \
            or list(rest.fit_iters) != [5, 6] or it != GUARD_ITERS:
        raise AssertionError(f"checkpoint/resume: fits {diff:.3e} apart, "
                             f"iterations {first.fit_iters} + "
                             f"{rest.fit_iters}, checkpoint it {it}")
    return dict(max_fit_diff=diff, model_rel_diff=rel, saves=saves,
                save_ms_mean=sum(ms) / len(ms))


def guard_deferred(bs, rank: int) -> dict:
    """14.4: fit_check_every = 3 over GUARD_ITERS iterations reads the
    fit twice where k = 1 reads it six times; the fits at 3 and 6 agree."""
    runs = {}
    syncs = {}
    for k in (1, 3):
        box = {}

        def run(k=k, box=box):
            box["out"] = guard_run(bs, rank, GUARD_RETRIES,
                                   iters=GUARD_ITERS, k=k)[0]

        syncs[k] = count_syncs(run)
        runs[k] = box["out"]
    one, three = runs[1], runs[3]
    saved = syncs[1] - syncs[3]
    diff = _max_diff(list(three.fits), [one.fits[2], one.fits[5]])
    log(f"[guard] deferred checks: k=3 checks at {list(three.fit_iters)}; "
        f"run syncs k=1 {syncs[1]}, k=3 {syncs[3]} ({saved} fewer); fits at "
        f"3 and 6 within {diff:.3e} of k=1's")
    if list(three.fit_iters) != [3, 6] or saved != GUARD_ITERS - 2 \
            or diff > RESUME_FIT_TOL:
        raise AssertionError(f"deferred checks: iterations "
                             f"{three.fit_iters}, {saved} syncs saved, fits "
                             f"{diff:.3e} apart")
    return dict(syncs=syncs, max_fit_diff=diff,
                k3_iter_seconds=list(three.iter_seconds))


def guard_trace(g: dict) -> dict:
    """14.5: the guarded run's Chrome trace summarized with the port's
    summarize_file; its cpd.iter spans against the printed seconds."""
    from splatt_tpu_torch import trace

    s = trace.summarize_file(g["trace_path"])
    printed = sum(g["traced_iter_seconds"])
    spans = s["iter_total_us"] / 1e6
    log(f"[guard] trace: {s['spans']} spans, {len(s['iters'])} cpd.iter "
        f"spans summing {spans * 1e3:.3f} ms against the printed "
        f"{printed * 1e3:.3f} ms; guard share {s['guard_pct']}% "
        f"({s['guard_self_us']} us self time); top "
        + ", ".join(f"{n} {a['self_us']}us" for n, a in s["top"][:6]))
    if len(s["iters"]) != ITERS or not (
            0.99 * printed <= spans <= 1.1 * printed + 2e-3 * ITERS):
        raise AssertionError(f"trace reconciliation: {len(s['iters'])} "
                             f"iterations, spans {spans} s against "
                             f"printed {printed} s")
    return dict(spans=s["spans"], iter_span_s=spans, printed_s=printed,
                guard_pct=s["guard_pct"], guard_self_us=s["guard_self_us"],
                names=sorted(s["names"]))


def fenced_mttkrp_ms(bs, U, reps: int = 5) -> tuple:
    """Each mode's MTTKRP timed the way the profiled sweep's bracket
    times it: the card idle, the host clock from the call to the end of a
    torch.cuda.synchronize(); and the host time of the call alone (its
    enqueue).  Means per mode, summed over modes: (fenced, enqueue)."""
    import torch

    from splatt_tpu_torch import mttkrp

    fenced = enqueue = 0.0
    for m in range(bs.nmodes):
        mttkrp(bs, U, m)
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mttkrp(bs, U, m)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            fenced += (t2 - t0) * 1e3 / reps
            enqueue += (t1 - t0) * 1e3 / reps
    return fenced, enqueue


def guard_profiled(bs, rank: int, main_fits: list,
                   main_phases: dict) -> dict:
    """14.6: cpd_als at Verbosity.HIGH (the profiled sweep): its phase
    table beside phase 5's phase times (CUDA events).  Each profiled
    bracket is host time closed by a fence, so it holds the call's host
    enqueue too: the per-mode MTTKRP sum is held, within
    PROFILED_MTTKRP_TOL, to each mode's MTTKRP timed in that same bracket
    on the run's factors, and printed beside phase 5's event time and the
    enqueue."""
    from splatt_tpu_torch.config import Verbosity
    from splatt_tpu_torch.cpd import PROFILED_PHASES
    from splatt_tpu_torch.utils.timers import timers

    timers.reset()
    res, _, launches, _ = guard_run(bs, rank, GUARD_RETRIES,
                                    iters=PROFILED_ITERS,
                                    verbosity=Verbosity.HIGH)
    table = {n: timers[n] * 1e3 / PROFILED_ITERS for n in PROFILED_PHASES}
    per_mode = [timers[f"mttkrp_mode{m}"] * 1e3 / PROFILED_ITERS
                for m in range(bs.nmodes)]
    fenced, enqueue = fenced_mttkrp_ms(bs, res.factors)
    rel = abs(sum(per_mode) - fenced) / fenced
    events_rel = (sum(per_mode) - main_phases["mttkrp"]) / main_phases[
        "mttkrp"]
    diff = _max_diff(list(res.fits), main_fits[:PROFILED_ITERS])
    log(f"[guard] profiled sweep, ms per sweep: "
        + ", ".join(f"{k} {v:.3f}" for k, v in table.items())
        + f"; per-mode mttkrp {[round(x, 4) for x in per_mode]} (sum "
          f"{sum(per_mode):.3f}) against {fenced:.3f} in the same fenced "
          f"bracket ({rel:.1%}), of which the calls' host enqueue "
          f"{enqueue:.3f}; phase 5's CUDA-event mttkrp "
          f"{main_phases['mttkrp']:.3f} ({events_rel:+.1%}), solve "
          f"{main_phases['solve']:.3f}, normalize+gram "
          f"{main_phases['normalize+gram']:.3f}; fits {diff:.3e} from "
          f"phase 5's")
    print(timers.report(level=3), flush=True)
    if rel > PROFILED_MTTKRP_TOL or diff > RESUME_FIT_TOL \
            or min(table.values()) <= 0:
        raise AssertionError(f"profiled sweep: mttkrp {rel:.1%} off the "
                             f"fenced calls, fits {diff:.3e}, table "
                             f"{table}")
    return dict(ms_per_sweep=table, mttkrp_mode_ms=per_mode,
                fenced_mttkrp_ms=fenced, mttkrp_enqueue_ms=enqueue,
                mttkrp_rel_to_fenced=rel,
                mttkrp_rel_to_phase5_events=events_rel, launches=launches,
                sec_per_iter=sum(res.iter_seconds[1:])
                / (len(res.iter_seconds) - 1))


def guard_distributed(tt, rank: int, tmp: str) -> dict:
    """14.7: FINE on the blocked engine over every card, or 4 virtual
    ranks sharing one, GUARD_ITERS iterations from phase 5's init:
    checkpointed every 2, stopped after 4 and resumed (fits against the
    uninterrupted run), a cpd.sweep NaN rolled back, and the profiled
    sweep's phase table."""
    import torch

    from splatt_tpu_torch import Options, resilience
    from splatt_tpu_torch.cpd import init_factors, load_checkpoint
    from splatt_tpu_torch.ops import kernels
    from splatt_tpu_torch.ops.linalg import gram
    from splatt_tpu_torch.parallel.common import (allreduce, ceil_to,
                                                  dist_phase_report,
                                                  reset_dist_timers,
                                                  run_distributed_als,
                                                  wrap_profiled_step)
    from splatt_tpu_torch.parallel.mesh import make_mesh
    from splatt_tpu_torch.parallel.ring_kernels import check_errors
    from splatt_tpu_torch.parallel.sharded import (
        make_sharded_profiled_sweep, shard_factors)
    from splatt_tpu_torch.utils import faults

    ncards = torch.cuda.device_count()
    nranks = ncards if ncards > 1 else DECOMP_VIRTUAL_RANKS
    mesh = make_mesh(n_devices=nranks)
    init = init_factors(tt.dims, rank, torch.Generator().manual_seed(0))
    p = decomp_pieces("fine", tt, mesh, rank, init)
    mesh, step = p["mesh"], p["step"]
    ndev = mesh.ndev
    dims_pad = tuple(ceil_to(d, ndev) for d in tt.dims)
    xnormsq = tt.normsq()
    nsorted = len(p["info"]["sorted_modes"])

    def place(U, m):
        return shard_factors([U], (tt.dims[m],), mesh,
                             dims_pad=(dims_pad[m],))[0]

    def gram_of(f, m):
        return allreduce([gram(u) for u in f], mesh)

    def run(iters, stepper=None, retries=GUARD_RETRIES, **kw):
        opts = Options(max_iterations=iters, tolerance=0.0, random_seed=0)
        with resilience.scope("phase14-fine", health_retries=retries) as sc:
            kernels.reset_launches()
            out = run_distributed_als(
                stepper or step, p["factors"], p["grams"], rank, opts,
                xnormsq, tt.dims, torch.float32, mesh, after_fit=check_errors,
                place=place, gram_of=gram_of, **kw)
            torch.cuda.synchronize()
        if sc.demoted:
            raise AssertionError(f"demotions: {list(sc.demoted)}")
        return out, sc, kernels.fused_mttkrp_t.launches

    t0 = time.perf_counter()
    whole, _, launches = run(GUARD_ITERS)
    ck = os.path.join(tmp, "fine.npz")
    first = run(4, checkpoint_path=ck, checkpoint_every=2)[0]
    rest = run(GUARD_ITERS, checkpoint_path=ck, checkpoint_every=2)[0]
    diff = _max_diff(list(first.fits) + list(rest.fits), list(whole.fits))
    it = load_checkpoint(ck)[2]
    with faults.inject("cpd.sweep", "nan", iter_at=GUARD_NAN_ITER):
        rolled, sc, rolled_launches = run(GUARD_ITERS)
    ev = [(e["kind"], e.get("iteration")) for e in sc.report.events()
          if e["kind"].startswith("health_")]
    sweep = make_sharded_profiled_sweep(mesh, tt.nmodes, 0.0, dims_pad,
                                        cells=p["cells"], fallback=False)
    reset_dist_timers()
    prof = run(4, stepper=wrap_profiled_step(
        lambda f, g, first: sweep(None, None, f, g, first)))[0]
    report = dist_phase_report()
    for line in report:
        log(f"[guard] fine | {line}")
    pdiff = _max_diff(list(prof.fits), list(whole.fits)[:4])
    seconds = time.perf_counter() - t0
    log(f"[guard] FINE on {ndev} ranks ({len(mesh.cards)} card(s)): fits "
        f"{list(whole.fits)}; fused_t launches {launches} (want "
        f"{nsorted * ndev * GUARD_ITERS}); stopped+resumed within "
        f"{diff:.3e}, checkpoint iteration {it}; rollback {ev}, fit "
        f"{rolled.fit}, {rolled_launches} launches; profiled fits within "
        f"{pdiff:.3e}; {seconds:.2f} s")
    want_ev = [("health_nonfinite", GUARD_NAN_ITER),
               ("health_rollback", GUARD_NAN_ITER)]
    if (launches != nsorted * ndev * GUARD_ITERS or diff > RESUME_FIT_TOL
            or it != GUARD_ITERS or ev != want_ev
            or not math.isfinite(rolled.fit) or pdiff > RESUME_FIT_TOL
            or len(report) < 5):
        raise AssertionError(f"FINE drills: launches {launches}, resume "
                             f"{diff:.3e}, it {it}, rollback {ev} fit "
                             f"{rolled.fit}, profiled {pdiff:.3e}, "
                             f"report {report}")
    del p
    torch.cuda.empty_cache()
    return dict(ranks=ndev, cards=len(mesh.cards), fits=list(whole.fits),
                launches=launches, resume_max_fit_diff=diff,
                rollback=ev, rollback_launches=rolled_launches,
                phase_report=report, seconds=seconds)


def guard_cli(tt, rank: int, tmp: str) -> dict:
    """14.8: ``python -m splatt_tpu_torch.cli cpd X.bin -r R -i 4
    --checkpoint F --checkpoint-every 2 --trace T --json`` in a subprocess
    on the card, on phase 3's tensor written with io.save; the checkpoint
    verifies, and the trace verb reads 4 iterations from T."""
    from splatt_tpu_torch.cpd import load_checkpoint
    from splatt_tpu_torch.io import save

    root = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(tmp, "nell2.bin")
    t0 = time.perf_counter()
    save(tt, path)
    save_s = time.perf_counter() - t0
    ck, tr = os.path.join(tmp, "cli.npz"), os.path.join(tmp, "cli.json")
    cmd = [sys.executable, "-m", "splatt_tpu_torch.cli", "cpd", path, "-r",
           str(rank), "-i", "4", "--tol", "0", "--seed", "0",
           "--checkpoint", ck, "--checkpoint-every", "2", "--trace", tr,
           "--json", "--nowrite", "--engine-fallback", "off"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=root,
                       timeout=600)
    seconds = time.perf_counter() - t0
    for line in r.stdout.splitlines():
        log(f"[guard] cli | {line}")
    if r.returncode != 0:
        raise AssertionError(f"the cli run failed ({r.returncode}): "
                             f"{r.stderr[-2000:]}")
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    it = load_checkpoint(ck)[2]
    v = subprocess.run([sys.executable, "-m", "splatt_tpu_torch.cli",
                        "trace", tr], capture_output=True, text=True,
                       cwd=root, timeout=120)
    for line in v.stdout.splitlines():
        log(f"[guard] trace | {line}")
    if (it != 4 or rec["demotions"] or rec["degraded"]
            or v.returncode != 0 or "iterations: 4 spans" not in v.stdout):
        raise AssertionError(f"cli drill: checkpoint it {it}, record "
                             f"{rec}, trace rc {v.returncode}")
    return dict(cmd=" ".join(cmd[1:]), seconds=seconds, save_s=save_s,
                fit=rec["fit"], checkpoint_it=it)


def phase_guard(bs, tt, rank: int, main_fits: list,
                main_phases: dict) -> dict:
    """Phase 14: the guarded driver, checkpoints and observability at full
    width, on phase 5's layouts and seed."""
    import shutil
    import tempfile

    import torch

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_guard_", dir=root)
    try:
        g = guard_and_sync(bs, rank, main_fits, tmp)
        out = dict(guard=g, drills=guard_drills(bs, rank, tmp),
                   resume=guard_resume(bs, rank, tmp),
                   deferred=guard_deferred(bs, rank),
                   trace=guard_trace(g),
                   profiled=guard_profiled(bs, rank, main_fits, main_phases))
        torch.cuda.empty_cache()
        out["fine"] = guard_distributed(tt, rank, tmp)
        out["cli"] = guard_cli(tt, rank, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    g.pop("trace_path", None)
    out["launches"] = (g["guard_off"]["launches"]
                       + g["guard_on_traced"]["launches"])
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[guard] phase 14: {out['seconds']:.1f} s")
    return out


def _guard_summary(gd: dict) -> dict:
    """Phase 14's figures for the kernels line."""
    g = gd["guard"]
    return dict(
        launches=gd["launches"], seconds=gd["seconds"],
        iter_ms_in_turns={k: v["ms"] for k, v in
                          g["iter_ms_in_turns"].items()},
        syncs_per_checked_iteration=g["syncs_per_checked_iteration"],
        checkpoint_save_ms=gd["resume"]["save_ms_mean"],
        guard_trace_pct=gd["trace"]["guard_pct"],
        profiled_ms_per_sweep=gd["profiled"]["ms_per_sweep"],
        fine=dict(launches=gd["fine"]["launches"],
                  phase_report=gd["fine"]["phase_report"]),
        cli_seconds=gd["cli"]["seconds"])


# -- phase 15: the autotuner, its plan cache and the bench verb ----------------

#: phase 15's candidate matrix at full width, cut from the JAX package's
#: (4 reorders x 5 blocks x 2 packings x 10 formats: 400 builds and
#: re-encodes of 20M nonzeros per mode) to 4 builds and 4 v2 re-encodes
#: per mode sharing one host sort, so that the whole script fits the
#: contract's time; the `auto` format keeps the tuner's re-encode branch
#: and its fused_v2 candidates on the card; the value storage stays the
#: compute dtype's, so the tuned CPD's fits compare with phase 5's
TUNE_BLOCKS = (4096, 8192)
TUNE_PACKINGS = ("fixed", "balanced")
TUNE_FORMATS = (("i32", "auto"), ("auto", "auto"))
#: the skewed input's recipes (every block and packing)
SKEW_REORDERS = ("identity", "hgraph")
#: phase 13's in-turns reading of mode 1's fused_t launch at 2M draws
#: (ms; H100 80GB HBM3, 700 W)
PHASE13_MODE1_MS = {"fixed": 0.2225, "balanced": 0.1201}
#: the bench verb's algorithms on the card and ranks
BENCH_ALGS = ("stream", "blocked", "blocked_pallas", "scatter", "ttbox")
BENCH_RANKS = (16, 50)
#: the CLI's --check gate in f32
BENCH_GATE = 9e-3
#: the launch counter each kernel engine moves
ENGINE_KERNEL = {"fused_t": "fused_mttkrp_t", "fused_tg": "fused_mttkrp_tg",
                 "fused": "fused_mttkrp", "fused_v2": "fused_mttkrp_v2",
                 "unfused_pallas": "onehot_reduce_sorted",
                 "fused_dense": "fused_dense"}
#: the tuned CPD's fits against phase 5's (the same layouts' math in f32)
TUNED_FIT_TOL = 1e-4


def launch_counts() -> dict:
    from splatt_tpu_torch.ops import kernels

    return {k.__name__: k.launches for k in kernels.KERNELS}


def recording_tuner():
    """tune._measure_candidate wrapped so each candidate leaves a record
    (mode, path, engine, block, format, packing, reorder, the tuner's ms
    and the kernel launches it made), and the host builds a tune makes
    timed by kind (records[0], "host_s": sort, build, reencode, reorder,
    measure); returns (records, restore)."""
    from splatt_tpu_torch import blocked, reorder, tune

    real = tune._measure_candidate
    host = {"sort": 0.0, "build": 0.0, "reencode": 0.0, "reorder": 0.0,
            "measure": 0.0}
    records = [{"host_s": host}]
    wrapped = []

    def timed(mod, name, kind):
        fn = getattr(mod, name)

        def inner(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                host[kind] += time.perf_counter() - t0

        setattr(mod, name, inner)
        wrapped.append((mod, name, fn))

    timed(blocked, "layout_sort_order", "sort")
    timed(blocked, "build_layout", "build")
    timed(blocked, "reencode_layout", "reencode")
    timed(reorder, "apply_reorder", "reorder")

    def measured(layout, factors, mode, path, engine, st, **kw):
        rec = dict(mode=int(mode), path=path, engine=engine,
                   block=int(layout.block),
                   fmt=f"{layout.idx_width}/{layout.val_storage}",
                   packing=layout.packing, reorder=layout.reorder)
        before = launch_counts()
        try:
            sec = real(layout, factors, mode, path, engine, st, **kw)
        except Exception as e:
            rec["error"] = f"{type(e).__name__}: {str(e)[:120]}"
            records.append(rec)
            raise
        after = launch_counts()
        rec["ms"] = sec * 1e3
        rec["launches"] = {k: after[k] - before[k] for k in after
                           if after[k] != before[k]}
        records.append(rec)
        return sec

    def timed_measure(*a, **k):
        t0 = time.perf_counter()
        try:
            return measured(*a, **k)
        finally:
            host["measure"] += time.perf_counter() - t0

    def restore():
        tune._measure_candidate = real
        for mod, name, fn in wrapped:
            setattr(mod, name, fn)

    tune._measure_candidate = timed_measure
    return records, restore


def check_candidate_launches(records: list, calls: int) -> None:
    """Every measured candidate of a kernel engine launched its kernel
    `calls` times (warm and timed) and nothing else; the plain scatter
    paths' xla launched no kernel."""
    for r in records[1:]:
        if "error" in r:
            continue
        want = ({ENGINE_KERNEL[r["engine"]]: calls}
                if r["engine"] in ENGINE_KERNEL else {})
        if r["launches"] != want:
            raise AssertionError(f"candidate {r} launched {r['launches']}, "
                                 f"expected {want}")


def tune_opts(**kw):
    from splatt_tpu_torch import Options
    from splatt_tpu_torch.config import BlockAlloc, Verbosity

    kw.setdefault("block_alloc", BlockAlloc.ALLMODE)
    kw.setdefault("random_seed", 0)
    return Options(max_iterations=ITERS, tolerance=0.0,
                   engine_fallback=False, verbosity=Verbosity.NONE, **kw)


def winner_check(lay, factors, m: int, plan) -> dict:
    """The winning engine's kernel on its tuned layout against its plain
    version (<= KERNEL_TOL of max|plain|), timed with CUDA events beside
    its bound and the tuner's host-clock figure."""
    from splatt_tpu_torch.blocked import decode_to_v1
    from splatt_tpu_torch.ops import kernels
    from splatt_tpu_torch.ops.mttkrp import _gather_prod_layout

    width = lay.seg_width
    label = f"[tune] winner mode {m} {plan.engine}"
    if plan.engine == "fused_v2":
        got, row = compare(
            lambda: kernels.fused_mttkrp_v2(lay, factors, m, width, False),
            lambda: kernels.fused_mttkrp_v2_plain(lay, factors, m, width,
                                                  False), label)
        row["bound_ms"], row["bound_by"] = v2_bound(lay, factors, m, got)
    elif plan.engine in ("fused_t", "fused_tg"):
        v1 = decode_to_v1(lay)
        fn = (kernels.fused_mttkrp_t if plan.engine == "fused_t"
              else kernels.fused_mttkrp_tg)
        got, row = compare(
            lambda: fn(v1, factors, m, width, False),
            lambda: kernels.fused_mttkrp_t_plain(v1, factors, m, width,
                                                 False), label)
        row["bound_ms"], row["bound_by"] = bound(v1, factors, m, got)
    elif plan.engine == "unfused_pallas":
        v1 = decode_to_v1(lay)
        prod = _gather_prod_layout(v1, factors, m).reshape(
            v1.nblocks, v1.block, -1)
        ids = v1.blocked_locals()
        got, row = compare(
            lambda: kernels.onehot_reduce_sorted(ids, prod, width),
            lambda: kernels.onehot_reduce_sorted_plain(ids, prod, width),
            label)
        row["bound_ms"], row["bound_by"] = reduce_bound(ids, prod, got,
                                                        v1.nnz)
    else:
        return dict(mode=m, engine=plan.engine, kernel=None)
    row.update(mode=m, engine=plan.engine,
               kernel=ENGINE_KERNEL[plan.engine], block=lay.block,
               fmt=lay.format_desc(), packing=lay.packing,
               tuner_ms=plan.sec * 1e3)
    log(f"[tune] winner {json.dumps(row)}")
    return row


def lookup_us(bs, U, reps: int = 5000) -> dict:
    """Host microseconds of one dispatch's autotuned-plan lookup on each
    mode of `bs` under the current plan cache, mean over `reps` calls:
    ``warm`` as dispatch runs it (the layout's memo), ``resolve`` the
    match it memoizes (plan key, environment key, cache memo, compares),
    and whether a plan applied."""
    from splatt_tpu_torch.ops.mttkrp import (_choose_path_bs,
                                             _engine_shape_key,
                                             _resolve_tuned_plan,
                                             _tuned_plan_for)

    out = {}
    for m in range(bs.nmodes):
        lay, path, at = bs.layout_for(m), _choose_path_bs(bs, m), \
            bs.opts.autotune
        # dispatch hands the lookup the shape key it already made
        key = _engine_shape_key(lay, U, m)
        row = {"hit": _tuned_plan_for(lay, U, m, path, at, key) is not None}
        t0 = time.perf_counter()
        for _ in range(reps):
            _tuned_plan_for(lay, U, m, path, at, key)
        row["warm"] = (time.perf_counter() - t0) / reps * 1e6
        t0 = time.perf_counter()
        for _ in range(reps):
            _resolve_tuned_plan(lay, U, m, path, at)
        row["resolve"] = (time.perf_counter() - t0) / reps * 1e6
        out[m] = row
    return out


def mttkrp_out_layouts(bs, U) -> dict:
    """Each mode's MTTKRP output: shape, strides, dtype, contiguity."""
    from splatt_tpu_torch import mttkrp

    out = {}
    for m in range(bs.nmodes):
        M = mttkrp(bs, U, m)
        out[m] = dict(shape=list(M.shape), stride=list(M.stride()),
                      dtype=str(M.dtype), contiguous=M.is_contiguous())
    return out


def cpd_iter_ms(bs, rank: int, opts) -> tuple:
    """One CPD's steady ms per iteration, its fits and its output."""
    import torch

    from splatt_tpu_torch import cpd_als

    out = cpd_als(bs, rank, opts)
    torch.cuda.synchronize()
    return (sum(out.iter_seconds[1:]) / (len(out.iter_seconds) - 1) * 1e3,
            list(out.fits), out)


def tune_full_width(tt, bs, main: dict, tmp: str) -> dict:
    """15.1: tune() at full width on phase 5's tensor and options over
    the restricted matrix, the warm tune, compile at the plans, the tuned
    CPD (launches, tuned_plan, fits, iteration in turns with phase 5's)
    and each winning kernel against its plain version."""
    import torch

    from splatt_tpu_torch import BlockedSparse, resilience, tune
    from splatt_tpu_torch.ops import kernels
    from splatt_tpu_torch.ops.mttkrp import _choose_path_bs

    opts = tune_opts()
    tune.set_cache_path(os.path.join(tmp, "phase15.json"))
    kw = dict(blocks=TUNE_BLOCKS, packings=TUNE_PACKINGS,
              formats=list(TUNE_FORMATS), reorders=("identity",),
              device="cuda")
    records, restore = recording_tuner()
    t0 = time.perf_counter()
    try:
        res = tune.tune(tt, RANK, opts, **kw)
    finally:
        restore()
    cold_s = time.perf_counter() - t0
    for r in records[1:]:
        log(f"[tune] candidate {json.dumps(r)}")
    check_candidate_launches(records, 3)
    if sorted(res.plans) != list(range(tt.nmodes)) or res.skipped:
        raise AssertionError(f"cold tune: plans {res.plans}, skipped "
                             f"{res.skipped}")
    winners = {m: dataclasses.asdict(p) for m, p in res.plans.items()}
    for m, p in winners.items():
        log(f"[tune] winner mode {m}: {json.dumps(p)}")
    log(f"[tune] cold tune: {res.measured} measurements in {cold_s:.1f} s; "
        f"host seconds by kind {json.dumps(records[0]['host_s'])}")
    t0 = time.perf_counter()
    warm = tune.tune(tt, RANK, opts, **kw)
    warm_s = time.perf_counter() - t0
    log(f"[tune] warm tune: {warm.measured} measurements, "
        f"{warm.cache_hits} cache hits in {warm_s:.3f} s")
    if (warm.measured, warm.cache_hits) != (0, tt.nmodes):
        raise AssertionError("the warm tune measured")
    t0 = time.perf_counter()
    bs_t = BlockedSparse.compile(tt, opts, rank=RANK)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    built = {}
    for m, p in res.plans.items():
        lay = bs_t.layout_for(m)
        built[m] = dict(block=lay.block, fmt=lay.format_desc(),
                        idx_width=lay.idx_width, packing=lay.packing,
                        path=_choose_path_bs(bs_t, m))
        log(f"[tune] compile mode {m}: {json.dumps(built[m])}")
        if ((lay.block, lay.idx_width, lay.packing, built[m]["path"])
                != (p.nnz_block, p.idx_width, p.packing, p.path)):
            raise AssertionError(f"mode {m} built off its plan: {built[m]}")
    # the tuned CPD: launches as the plans say, every mode's plan in effect
    resilience.run_report().clear()
    kernels.reset_launches()
    iter_ms, fits, out = cpd_iter_ms(bs_t, RANK, opts)
    launches = launch_counts()
    want = {}
    for p in res.plans.values():
        if p.engine in ENGINE_KERNEL:
            k = ENGINE_KERNEL[p.engine]
            want[k] = want.get(k, 0) + ITERS
    got = {k: v for k, v in launches.items() if v}
    events = resilience.run_report().events("tuned_plan")
    diff = max(abs(a - b) for a, b in zip(fits, main["fits"]))
    log(f"[tune] tuned CPD: fits {fits}; max |fit - phase 5's| {diff:.3e}; "
        f"launches {got} (plans say {want}); tuned_plan modes "
        f"{sorted(events[-1]['plans']) if events else None}")
    if got != want or resilience.demotions():
        raise AssertionError(f"tuned CPD launches {got}, expected {want}")
    if not events or sorted(events[-1]["plans"]) != list(range(tt.nmodes)):
        raise AssertionError("no tuned_plan event with every mode")
    if len(fits) != ITERS or not diff <= TUNED_FIT_TOL:
        raise AssertionError(f"tuned fits {fits} against {main['fits']}")
    # the iteration in turns: autotune off on phase 5's layouts, on with
    # an empty plan cache on the same layouts (the plan lookup's cost
    # alone), and tuned (the plans' layouts and engines); in order, then
    # reversed, twice
    plans_file = os.path.join(tmp, "phase15.json")
    empty_file = os.path.join(tmp, "empty.json")
    runs = {"untuned": (dataclasses.replace(bs, opts=dataclasses.replace(
                bs.opts, autotune=False)), False, empty_file),
            "lookup_miss": (dataclasses.replace(bs, opts=dataclasses.replace(
                bs.opts, autotune=True)), True, empty_file),
            "tuned": (bs_t, True, plans_file)}
    turns = {k: [] for k in runs}
    for label in (list(runs) + list(runs)[::-1]) * 2:
        X, on, cache = runs[label]
        tune.set_cache_path(cache)
        turns[label].append(cpd_iter_ms(X, RANK, tune_opts(autotune=on))[0])
    turn_ms = {k: sum(v) / len(v) for k, v in turns.items()}
    log(f"[tune] ms per iteration in turns: "
        + "; ".join(f"{k} {v}" for k, v in turns.items())
        + f"; means {turn_ms}; phase 5's {main['sec_per_iter'] * 1e3:.3f}")
    # where each iteration's time goes, on the same factors, with each
    # mode's MTTKRP output's layout beside it; the plan lookup's host cost
    phases, lookups = {}, {}
    for label, (X, on, cache) in runs.items():
        tune.set_cache_path(cache)
        phases[label] = sweep_phases(X, out.factors, turn_ms[label] / 1e3,
                                     f"[tune] {label}")
        phases[label]["mttkrp_out"] = mttkrp_out_layouts(X, out.factors)
        lookups[label] = lookup_us(X, out.factors)
        log(f"[tune] {label}: MTTKRP outputs "
            f"{json.dumps(phases[label]['mttkrp_out'])}; plan lookup host "
            f"us per call {json.dumps(lookups[label])}")
    tune.set_cache_path(plans_file)
    factors = random_factors(bs_t, RANK, 1)
    checks = [winner_check(bs_t.layout_for(m), factors, m, p)
              for m, p in res.plans.items()]
    del bs_t, out, factors
    torch.cuda.empty_cache()
    return dict(cold_s=cold_s, warm_s=warm_s, compile_s=compile_s,
                measured=res.measured, candidates=records,
                winners=winners, built=built, launches=got,
                tuned_fits=fits, fit_diff=diff, tuned_iter_ms=iter_ms,
                turns=turns, turn_ms=turn_ms, phases=phases,
                lookup_us=lookups, checks=checks)


def tune_skewed(tmp: str) -> dict:
    """15.2: bench.py's amazon-like tensor at 2M draws, every block and
    packing under identity and hgraph: the plan keys with their skew
    component and mode 1's winner beside phase 13's in-turns reading."""
    from splatt_tpu_torch import tune
    from splatt_tpu_torch.blocked import mode_density_bucket
    from splatt_tpu_torch.config import BlockAlloc

    tt = synthetic_zipf(AMAZON_DIMS, AMAZON_DRAWS[0], seed=0).deduplicate()
    opts = tune_opts(block_alloc=BlockAlloc.TWOMODE)
    tune.set_cache_path(os.path.join(tmp, "phase15_skew.json"))
    records, restore = recording_tuner()
    t0 = time.perf_counter()
    try:
        res = tune.tune(tt, RANK, opts, formats=list(TUNE_FORMATS),
                        reorders=SKEW_REORDERS, device="cuda")
    finally:
        restore()
    seconds = time.perf_counter() - t0
    check_candidate_launches(records, 3)
    keys = {}
    for m in range(tt.nmodes):
        skew = tune.skew_of(tt, m)
        keys[m] = tune.plan_key(tt.dims, tt.nnz, m, RANK, "float32",
                                skew=skew, mode_density=mode_density_bucket(
                                    tt.dims, m, tt.nnz))
        p = res.plans.get(m)
        log(f"[tune] skewed mode {m}: key {keys[m]} (skew {skew}); winner "
            f"{json.dumps(dataclasses.asdict(p)) if p else None}")
    m1 = res.plans.get(1)
    faster = min(PHASE13_MODE1_MS, key=PHASE13_MODE1_MS.get)
    agrees = m1 is not None and m1.packing == faster
    log(f"[tune] skewed: {res.measured} measurements in {seconds:.1f} s "
        f"(host seconds by kind {json.dumps(records[0]['host_s'])}); "
        f"mode 1's winner packing {m1.packing if m1 else None} "
        f"{'agrees' if agrees else 'disagrees'} with phase 13's in-turns "
        f"reading ({PHASE13_MODE1_MS})")
    return dict(nnz=tt.nnz, seconds=seconds, measured=res.measured,
                keys=keys, winners={m: dataclasses.asdict(p)
                                    for m, p in res.plans.items()},
                mode1_agrees_phase13=agrees)


def bench_and_cli(tt, tmp: str) -> dict:
    """15.3: bench_mttkrp and crosscheck_mttkrp on phase 6's 2M tensor
    at R = 16 and 50 with the roofline lines; the bench verb with
    --check, then the tune verb and cpd --autotune on phase 3's tensor,
    each in a subprocess."""
    from splatt_tpu_torch.bench_algs import (bench_mttkrp, crosscheck_mttkrp,
                                             format_bench, roofline_report)
    from splatt_tpu_torch.config import BlockAlloc
    from splatt_tpu_torch.io import save

    small = synthetic_tensor(NELL2, BIG_RANK_NNZ, seed=5)
    opts = tune_opts(random_seed=1, block_alloc=BlockAlloc.ALLMODE)
    out = {"bench": {}, "crosscheck": {}}
    for R in BENCH_RANKS:
        res, lays = bench_mttkrp(small, rank=R, algs=BENCH_ALGS, opts=opts,
                                 reps=3, return_layouts=True, device="cuda")
        for line in format_bench(res).splitlines():
            log(f"[bench] R={R} {line}")
        for line in roofline_report(small, res, R, 4, lays, device="cuda"):
            log(f"[bench] R={R} {line}")
        dev = crosscheck_mttkrp(small, rank=R, algs=BENCH_ALGS, opts=opts,
                                device="cuda")
        log(f"[bench] R={R} cross-check max relative |alg - stream| = "
            f"{dev:.3e} (gate {BENCH_GATE})")
        if not dev <= BENCH_GATE:
            raise AssertionError(f"bench cross-check {dev} at R={R}")
        out["bench"][R] = {k: [v * 1e3 for v in t] for k, t in res.items()}
        out["crosscheck"][R] = dev
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env.pop("SPLATT_FAULTS", None)

    def start(args, env=env):
        return args, time.perf_counter(), subprocess.Popen(
            [sys.executable, "-m", "splatt_tpu_torch.cli", *args],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=root, env=env)

    def finish(run):
        args, t0, p = run
        try:
            out, err = p.communicate(timeout=600)
        finally:
            if p.poll() is None:
                p.kill()
                p.communicate()
        seconds = time.perf_counter() - t0
        for line in out.splitlines():
            log(f"[tune] cli {args[0]} | {line}")
        if p.returncode != 0:
            raise AssertionError(f"cli {args} failed ({p.returncode}): "
                                 f"{err[-2000:]}")
        return out, seconds

    def cli(args, env=env):
        return finish(start(args, env))

    path = os.path.join(tmp, "small.bin")
    save(small, path)
    big = os.path.join(tmp, "nell2.bin")
    save(tt, big)
    # other processes on 15.1's plan cache: the tune verb finds every
    # mode's plan (the plans survive a restart), and cpd builds and
    # dispatches at them; the three processes run at once (tune and cpd
    # only read the plans, bench reads the start-up cache)
    cenv = dict(env, SPLATT_TUNE_CACHE=os.path.join(tmp, "phase15.json"))
    bench_run = start(["bench", path, "-r", "16", "--reps", "2",
                       "--check"])
    tune_run = start(["tune", big, "-r", str(RANK)], cenv)
    cpd_run = start(
        ["cpd", big, "-r", str(RANK), "-i", "3", "--tol", "0", "--seed",
         "0", "--alloc", "allmode", "--autotune", "on", "--json",
         "--nowrite", "--engine-fallback", "off"], cenv)
    try:
        _, out["cli_bench_s"] = finish(bench_run)
        text, out["cli_tune_s"] = finish(tune_run)
    finally:
        cpd_text, out["cli_cpd_s"] = finish(cpd_run)
    if (f"tuned {tt.nmodes}/{tt.nmodes} modes (0 measurements, "
            f"{tt.nmodes} cache hits") not in text:
        raise AssertionError("the tune verb did not find 15.1's plans")
    text = cpd_text
    rec = json.loads(text.strip().splitlines()[-1])
    kinds = [e["kind"] for e in rec["events"]]
    tuned = [e for e in rec["events"] if e["kind"] == "tuned_plan"]
    if (not tuned or sorted(tuned[0]["plans"]) != [str(m) for m in
                                                   range(tt.nmodes)]
            or rec["demotions"] or "tuner_degraded" in kinds):
        raise AssertionError(f"cpd --autotune on: events {kinds}")
    out["cli_tuned_plan"] = tuned[0]["plans"]
    return out


def tune_drills(tmp: str) -> dict:
    """15.4: on phase 6's 2M tensor over one candidate layout per mode:
    the tuner.measure drill (no plan, tuner_degraded per mode), the
    engine.fused_t drill (tuner_negative for fused_t alone, every mode
    still tuned), and a kernel loader that raises (tune() raises, the
    cache file unchanged)."""
    from splatt_tpu_torch import resilience, tune
    from splatt_tpu_torch.ops import kernels
    from splatt_tpu_torch.utils import faults

    small = synthetic_tensor(NELL2, BIG_RANK_NNZ, seed=5)
    opts = tune_opts()
    kw = dict(blocks=(4096,), packings=("fixed",), formats=[("i32", "auto")],
              reorders=("identity",), device="cuda")
    out = {}
    for spec in ("tuner.measure:runtime:*", "engine.fused_t:runtime:*"):
        cache = os.path.join(tmp, f"drill_{spec.split(':')[0]}.json")
        tune.set_cache_path(cache)
        resilience.reset_demotions()
        resilience.run_report().clear()
        os.environ["SPLATT_FAULTS"] = spec
        faults.reset()
        try:
            res = tune.tune(small, RANK, opts, **kw)
        finally:
            del os.environ["SPLATT_FAULTS"]
            faults.reset()
        rep = resilience.run_report()
        degraded = sorted(e["mode"] for e in rep.events("tuner_degraded"))
        negs = sorted({e["engine"] for e in rep.events("tuner_negative")})
        log(f"[tune] drill {spec}: plans {sorted(res.plans)}, "
            f"tuner_degraded {degraded}, tuner_negative engines {negs}")
        if sorted(set(res.plans) | set(degraded)) != [0, 1, 2]:
            raise AssertionError(f"drill {spec}: a mode has neither a plan "
                                 f"nor a tuner_degraded event")
        if spec.startswith("tuner.") and res.plans:
            raise AssertionError("tuner.measure drill: a mode was tuned")
        if spec.startswith("engine.") and (
                negs != ["fused_t"] or sorted(res.plans) != [0, 1, 2]
                or any(p.engine == "fused_t" for p in res.plans.values())):
            raise AssertionError(f"engine.fused_t drill: {res.plans}")
        out[spec] = dict(plans=sorted(res.plans), degraded=degraded,
                         negative_engines=negs)
    before = open(cache, "rb").read()
    real = kernels.load_library

    def broken():
        raise RuntimeError("nvcc failed on fused_mttkrp.cu (drill)")

    kernels.load_library = broken
    try:
        tune.tune(small, RANK, opts, force=True, **kw)
        raised = None
    except RuntimeError as e:
        raised = str(e)
    finally:
        kernels.load_library = real
    unchanged = open(cache, "rb").read() == before
    log(f"[tune] drill broken loader: raised {raised!r}; cache unchanged "
        f"{unchanged}")
    if raised is None or not unchanged:
        raise AssertionError("a broken kernel loader did not propagate, or "
                             "the cache changed")
    out["broken_loader"] = dict(raised=raised, cache_unchanged=unchanged)
    return out


def phase_tune(tt, bs, main: dict) -> dict:
    """Phase 15: the autotuner, its plan cache and the bench verb; every
    write goes to files of its own, and the start-up plan cache stays
    empty for the phases after it."""
    import shutil
    import tempfile

    from splatt_tpu_torch import tune

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tune_", dir=root)
    try:
        out = dict(full=tune_full_width(tt, bs, main, tmp),
                   skewed=tune_skewed(tmp), bench=bench_and_cli(tt, tmp),
                   drills=tune_drills(tmp))
    finally:
        tune.set_cache_path(None)
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[tune] phase 15: {out['seconds']:.1f} s")
    return out


def _tune_summary(tn: dict) -> dict:
    """Phase 15's figures for the kernels line."""
    f = tn["full"]
    return dict(seconds=tn["seconds"], cold_tune_s=f["cold_s"],
                warm_tune_s=f["warm_s"], measured=f["measured"],
                winners={m: (p["engine"], p["nnz_block"], p["idx_width"],
                             p["packing"], p["sec"] * 1e3)
                         for m, p in f["winners"].items()},
                tuned_launches=f["launches"], fit_diff=f["fit_diff"],
                iter_ms_in_turns=f["turn_ms"], sweep_phase_ms=f["phases"],
                lookup_us=f["lookup_us"],
                winner_ms=[(c.get("kernel"), c.get("ms"), c.get("tuner_ms"))
                           for c in f["checks"]],
                skewed=dict(winners=tn["skewed"]["winners"],
                            mode1_agrees_phase13=tn["skewed"][
                                "mode1_agrees_phase13"]),
                bench_ms=tn["bench"]["bench"],
                crosscheck=tn["bench"]["crosscheck"],
                drills=tn["drills"])


def _tune_rows(tn: dict) -> list:
    """The kernels line of ``--tune``: one row per winning kernel, its
    winner checks' means and its launches in the tuned CPD."""
    sources = {"fused_mttkrp_t": (FUSED_SRC, f"{PK}:355"),
               "fused_mttkrp_tg": (FUSED_SRC, f"{PK}:507"),
               "fused_mttkrp_v2": ("splatt_tpu_torch/csrc/fused_mttkrp_v2.cu",
                                   f"{PK}:702"),
               "onehot_reduce_sorted": ("splatt_tpu_torch/csrc/"
                                        "onehot_reduce.cu", f"{PK}:148")}
    f = tn["full"]
    rows = []
    for name, (src, rep) in sources.items():
        mine = [c for c in f["checks"] if c.get("kernel") == name]
        if mine:
            rows.append(_record_row(
                name, src, rep, f["launches"].get(name, 0), mine, None,
                note=f"ms/plain_ms/bound_ms: mean per launch over the modes "
                f"phase 15's tune gave this kernel, on their tuned layouts, "
                f"NELL-2 shape, 20M nonzeros, rank {RANK}, f32; launches: "
                f"the tuned CPD, {ITERS} iterations", contracts=mine,
                phase15=_tune_summary(tn)))
    return rows


# -- phase 16: the out-of-core route --------------------------------------------

#: phase 16's depths: the out-of-core MEDIUM CPD at 20M nonzeros (phase
#: 12's) and FINE and COARSE through the CLI at 2M
OOC_ITERS = DECOMP_ITERS
OOC_CLI_ITERS = 3


def _rss_kib() -> int:
    """This process's resident set now, in KiB (VmRSS)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1])
    raise RuntimeError("no VmRSS in /proc/self/status")


class RssPeak:
    """The largest resident set this process reaches while it runs,
    sampled every `period` seconds by a thread.  Not ``ru_maxrss``: that
    of a process started by ``subprocess`` also holds its parent's
    resident set at the fork, which the kernel folds in at the exec (and
    not every /proc gives VmHWM)."""

    def __init__(self, period: float = 0.005) -> None:
        import threading

        self.peak = _rss_kib()
        self._period = period
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._done.wait(self._period):
            self.peak = max(self.peak, _rss_kib())

    def now(self) -> int:
        """The peak so far, a sample taken now included."""
        self.peak = max(self.peak, _rss_kib())
        return self.peak

    def stop(self) -> int:
        self._done.set()
        self._thread.join()
        return self.now()


def ooc_child(spec: dict) -> dict:
    """One MEDIUM CPD of phase 16 in a process of its own (``python3
    chip_smoke.py --ooc-child SPEC``): ``spec["kind"]`` ``ooc`` maps the
    ``.bin`` with ``load_memmap`` and builds out of core under
    ``spec["dir"]`` (its sorted layouts stay there, with each layout's
    ``row_start.npy``); ``ram`` reads it whole with ``io.load`` and then
    holds its layouts against the ``ooc`` child's files.  Returns the
    build's seconds by kind (the grid decomposition, the layout sorts,
    the uploads), ms per iteration, fused_mttkrp_t's launches, the
    demotions, the fits, and the peak RSS less the RSS right after CUDA
    and the libraries came up (:class:`RssPeak`), in KiB, with
    ``ru_maxrss`` beside it."""
    import resource

    import torch

    from splatt_tpu_torch import Options, native, resilience
    from splatt_tpu_torch.config import CommPattern, Decomposition
    from splatt_tpu_torch.io import load, load_memmap
    from splatt_tpu_torch.ops import kernels
    from splatt_tpu_torch.parallel import common, distributed_cpd_als
    from splatt_tpu_torch.parallel import grid as gridmod
    from splatt_tpu_torch.parallel.mesh import make_mesh

    kernels.load_library()
    native.available()
    mesh = make_mesh(n_devices=spec["ranks"])
    torch.zeros(1, device=mesh.devices[0])
    torch.cuda.synchronize()
    rss0 = _rss_kib()
    sampler = RssPeak()
    ooc = spec["kind"] == "ooc"
    secs = {"decompose": 0.0, "sort": 0.0, "upload": 0.0}
    # the peak RSS growth reached by the end of each kind's last call
    peaks = {}

    def timed(kind, fn):
        def wrapped(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                secs[kind] += time.perf_counter() - t0
                peaks[kind] = sampler.now() - rss0
        return wrapped

    gridmod.GridDecomp.build = staticmethod(
        timed("decompose", gridmod.GridDecomp.build))
    for name in ("blocked_buckets", "streamed_blocked_buckets"):
        setattr(common, name, timed("sort", getattr(common, name)))
    common.upload = timed("upload", common.upload)
    captured = []
    build_cells = gridmod.GridDecomp.build_cell_layouts

    def capture(decomp, *a, **k):
        cl = build_cells(decomp, *a, **k)
        captured.append((decomp, cl))
        return cl

    gridmod.GridDecomp.build_cell_layouts = capture

    t0 = time.perf_counter()
    tt = load_memmap(spec["bin"]) if ooc else load(spec["bin"])
    load_s = time.perf_counter() - t0
    rng = np.random.default_rng(DECOMP_SEED)
    init = [rng.random((d, spec["rank"])) for d in tt.dims]
    resilience.reset_demotions()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = distributed_cpd_als(
        tt, spec["rank"], opts=Options(
            max_iterations=spec["iters"], tolerance=0.0, random_seed=0,
            decomposition=Decomposition.MEDIUM,
            comm_pattern=CommPattern.ALL2ALL, engine_fallback=False),
        init=init, grid=tuple(spec["grid"]), mesh=mesh,
        out_dir=spec["dir"] if ooc else None)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    peak = sampler.stop()
    launches = kernels.fused_mttkrp_t.launches
    decomp, cells = captured[0]
    ncells = decomp.ncells
    lays = []
    equal = {}
    for lay in cells.layouts:
        m = lay["sort_mode"]
        inds = lay["inds"].reshape(tt.nmodes, ncells, -1)
        vals = lay["vals"].reshape(ncells, -1)
        starts = np.asarray(lay["row_start"]).reshape(ncells, -1)
        where = os.path.join(spec["dir"], f"cells_m{m}")
        meta = dict(sort_mode=m, block=lay["block"],
                    seg_width=lay["seg_width"], sort_dim=lay["sort_dim"],
                    nnz_pad=int(inds.shape[-1]),
                    memmap_dir=common._memmap_dir(inds))
        if ooc:
            np.save(os.path.join(where, "row_start.npy"), starts)
        else:
            disk = (np.load(os.path.join(where, "linds.npy"), mmap_mode="r"),
                    np.load(os.path.join(where, "lvals.npy"), mmap_mode="r"),
                    np.load(os.path.join(where, "row_start.npy")))
            equal[str(m)] = bool(
                np.array_equal(inds, disk[0]) and np.array_equal(vals, disk[1])
                and np.array_equal(starts, disk[2]))
        lays.append(meta)
    steady = sum(out.iter_seconds[1:]) / (len(out.iter_seconds) - 1)
    late = out.iter_seconds[2:]
    return dict(kind=spec["kind"], load_s=load_s, call_s=call_s,
                build_s=secs, rss_growth_by_kind_kib=peaks,
                ms_per_iter=steady * 1e3,
                ms_per_iter_from_3=sum(late) / len(late) * 1e3,
                iter_seconds=list(out.iter_seconds), fits=list(out.fits),
                lam=[float(x) for x in out.lam], launches=launches,
                demoted=[d.engine for d in resilience.demotions()],
                rss_after_init_kib=rss0, peak_rss_kib=peak,
                rss_growth_kib=peak - rss0,
                ru_maxrss_kib=resource.getrusage(
                    resource.RUSAGE_SELF).ru_maxrss, layouts=lays,
                layouts_equal=equal, grid=list(decomp.grid),
                block_rows=list(decomp.block_rows),
                cell_counts=[int(c) for c in decomp.cell_counts],
                relabeled=decomp.relabels is not None)


def run_ooc_child(spec: dict) -> dict:
    """:func:`ooc_child` in a child process; its result is the JSON last
    line of its output."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, os.path.join(root, "chip_smoke.py"),
                        "--ooc-child", json.dumps(spec)], capture_output=True,
                       text=True, cwd=root, timeout=600)
    for line in r.stdout.splitlines()[:-1]:
        log(f"[ooc] {spec['kind']} | {line}")
    if r.returncode != 0:
        raise AssertionError(f"the {spec['kind']} child failed "
                             f"({r.returncode}): {r.stderr[-3000:]}")
    res = json.loads(r.stdout.strip().splitlines()[-1])
    res["process_s"] = time.perf_counter() - t0
    log(f"[ooc] {json.dumps(res)}")
    return res


def ooc_rank_launch(res: dict, rank: int) -> list:
    """Rank 0's fused_mttkrp_t launch on each sorted layout the ``ooc``
    child left on disk, against the plain version over random tables of
    the cells' row counts, timed beside its bound."""
    import torch

    from splatt_tpu_torch.parallel.common import bucket_layout

    rng = np.random.default_rng(16)
    tables = [torch.from_numpy(rng.random((d, rank), dtype=np.float32)).cuda()
              for d in res["block_rows"]]
    rows = []
    for meta in res["layouts"]:
        m, where = meta["sort_mode"], meta["memmap_dir"]
        inds = np.load(os.path.join(where, "linds.npy"), mmap_mode="r")
        vals = np.load(os.path.join(where, "lvals.npy"), mmap_mode="r")
        starts = np.load(os.path.join(where, "row_start.npy"))
        lay = bucket_layout(
            torch.from_numpy(np.array(inds[:, 0])).cuda(),
            torch.from_numpy(np.array(vals[0])).to("cuda", torch.float32),
            torch.from_numpy(starts[0]).cuda(), m, meta["sort_dim"],
            meta["block"], meta["seg_width"], res["cell_counts"][0])
        rows.append(rank_launch(lay, tables, m, "ooc medium"))
    return rows


def text_route(tt, tmp: str) -> dict:
    """Phase 6's 2M tensor written as ``.tns``; the cli's ``convert X.tns
    bin X.bin`` in a child process (it must stream); the ``.bin`` mapped
    against the text loaded; ``native.parse_tns`` against the Python
    parse in turns on the same file."""
    from splatt_tpu_torch import native
    from splatt_tpu_torch.io import (load, load_memmap, parse_text_python,
                                     save)

    if not native.available():
        raise AssertionError("the native host runtime did not build: the "
                             "text route would run the Python parse")
    tns, binp = os.path.join(tmp, "x.tns"), os.path.join(tmp, "x.bin")
    t0 = time.perf_counter()
    save(tt, tns)
    write_s = time.perf_counter() - t0
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "splatt_tpu_torch.cli",
                        "convert", tns, "bin", binp], capture_output=True,
                       text=True, cwd=root, timeout=300)
    convert_s = time.perf_counter() - t0
    if r.returncode != 0 or r.stdout.strip() != \
            f"wrote bin (streamed): {binp}":
        raise AssertionError(f"convert did not stream ({r.returncode}): "
                             f"{r.stdout} {r.stderr[-2000:]}")
    mm, txt = load_memmap(binp), load(tns)
    # the dims of a text file are its largest indices
    same = (mm.dims == txt.dims
            and np.array_equal(np.asarray(mm.inds), txt.inds)
            and np.array_equal(np.asarray(mm.inds), tt.inds)
            and float(np.abs(np.asarray(mm.vals) - txt.vals).max()) == 0.0)
    if not same:
        raise AssertionError("the streamed .bin differs from the text")
    turns = {"native": [], "python": []}
    for _ in range(2):
        for name, fn in (("native", native.parse_tns),
                         ("python", parse_text_python)):
            t0 = time.perf_counter()
            got = fn(tns)
            turns[name].append(time.perf_counter() - t0)
            if not np.array_equal(got[0] - 1, tt.inds):
                raise AssertionError(f"{name} parse differs")
            del got
    out = dict(nnz=tt.nnz, tns_mb=os.path.getsize(tns) / 1e6,
               bin_mb=os.path.getsize(binp) / 1e6, write_tns_s=write_s,
               convert_process_s=convert_s, parse_s=turns,
               native_speedup=min(turns["python"]) / min(turns["native"]))
    log(f"[ooc] text route: {json.dumps(out)}")
    return out


def lam_rel(got, want) -> float:
    """The largest difference of two λ vectors relative to max|want|."""
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def cli_cpd(argv: list) -> dict:
    """The cpd verb in this process (``cli.main``), its stdout captured:
    the exit code, the per-iteration fits printed, the JSON record, the
    engine line, the model's λ, and fused_mttkrp_t's launches."""
    import contextlib
    import io

    import torch

    from splatt_tpu_torch import cli, parallel, resilience
    from splatt_tpu_torch.ops import kernels

    resilience.reset_demotions()
    resilience.run_report().clear()
    kernels.reset_launches()
    models = []
    entry = parallel.distributed_cpd_als

    def keep(*a, **k):
        models.append(entry(*a, **k))
        return models[-1]

    buf = io.StringIO()
    t0 = time.perf_counter()
    parallel.distributed_cpd_als = keep
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
    finally:
        parallel.distributed_cpd_als = entry
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"[ooc] cli | {line}")
    return dict(rc=rc, seconds=seconds,
                fits=[float(ln.split("fit = ")[1].split()[0])
                      for ln in text.splitlines() if "fit = " in ln],
                record=json.loads(text.strip().splitlines()[-1]),
                engine=next((ln.strip() for ln in text.splitlines()
                             if "per-rank engine:" in ln), None),
                lam=[float(x) for x in models[0].lam] if models else None,
                launches=kernels.fused_mttkrp_t.launches)


def ooc_cli_runs(binp: str, tmp: str, nranks: int, rank: int) -> dict:
    """FINE and COARSE through the cpd verb on the 2M ``.bin``: out of
    core (``--mmap --scratch-dir``) against in memory, the same fits and
    launches; the drills: ``--mmap`` without a scratch directory takes the
    stream engine, ``--scratch-dir`` without a decomposition exits
    non-zero."""
    import glob
    import shutil

    def base(iters):
        return ["cpd", binp, "-r", str(rank), "-i", str(iters), "--tol", "0",
                "--seed", "0", "--ndev", str(nranks), "--json", "--nowrite",
                "--engine-fallback", "off"]

    out = {}
    for decomp in ("fine", "coarse"):
        scratch = os.path.join(tmp, f"scratch_{decomp}")
        ooc = cli_cpd(base(OOC_CLI_ITERS) + ["--decomp", decomp, "--mmap",
                                             "--scratch-dir", scratch])
        ram = cli_cpd(base(OOC_CLI_ITERS) + ["--decomp", decomp])
        lay_files = sorted(os.path.relpath(p, scratch) for p in
                           glob.glob(os.path.join(scratch, "**", "linds.npy"),
                                     recursive=True))
        diff = max(abs(a - b) for a, b in zip(ooc["fits"], ram["fits"]))
        rel = lam_rel(ooc["lam"], ram["lam"])
        row = dict(ooc=ooc, ram=ram, fit_diff=diff, lam_rel_diff=rel,
                   layout_files=lay_files)
        if (ooc["rc"] or ram["rc"] or len(ooc["fits"]) != OOC_CLI_ITERS
                or not diff <= PARITY_TOL or not rel <= LAMBDA_TOL
                or not abs(ooc["record"]["fit"] - ram["record"]["fit"])
                <= PARITY_TOL
                or ooc["launches"] != ram["launches"]
                or not ooc["launches"] or ooc["record"]["demotions"]
                or ram["record"]["demotions"] or not lay_files
                or "out of core" not in (ooc["engine"] or "")):
            raise AssertionError(f"{decomp}: the out-of-core cli run leaves "
                                 f"the in-memory one: {json.dumps(row)}")
        shutil.rmtree(scratch, ignore_errors=True)
        out[decomp] = row
    lean = cli_cpd(base(1) + ["--decomp", "fine", "--mmap"])
    if lean["rc"] or lean["engine"] != "per-rank engine: stream" \
            or lean["launches"]:
        raise AssertionError(f"--mmap without --scratch-dir: {lean}")
    root = os.path.dirname(os.path.abspath(__file__))
    r = subprocess.run([sys.executable, "-m", "splatt_tpu_torch.cli", "cpd",
                        binp, "-r", str(rank), "-i", "1", "--mmap",
                        "--nowrite", "--scratch-dir",
                        os.path.join(tmp, "unused")],
                       capture_output=True, text=True, cwd=root, timeout=300)
    if r.returncode == 0 or "--scratch-dir applies to distributed runs" \
            not in r.stderr:
        raise AssertionError(f"--scratch-dir alone: rc {r.returncode}, "
                             f"{r.stderr[-1000:]}")
    out["drills"] = dict(lean_engine=lean["engine"],
                         lean_launches=lean["launches"],
                         scratch_alone_rc=r.returncode)
    log(f"[ooc] drills: {json.dumps(out['drills'])}")
    return out


def phase_ooc(tt, rank: int, big=None) -> dict:
    """Phase 16: the out-of-core route on the ranks of phase 12.  `big`
    names where phase 3's tensor is written as ``.bin`` (phase 18 reads it
    again; default a file of the phase's own scratch directory)."""
    import shutil
    import tempfile

    import torch

    from splatt_tpu_torch.io import save
    from splatt_tpu_torch.parallel.mesh import auto_grid

    t_phase = time.perf_counter()
    ncards = torch.cuda.device_count()
    nranks = ncards if ncards > 1 else DECOMP_VIRTUAL_RANKS
    grid = auto_grid(nranks, tt.dims)
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ooc_", dir=root)
    try:
        log(f"[ooc] phase 16: {nranks} ranks, MEDIUM grid {grid}; scratch "
            f"{tmp} (free {shutil.disk_usage(tmp).free / 1e9:.1f} GB)")
        small = synthetic_tensor(NELL2, BIG_RANK_NNZ, seed=5)
        text = text_route(small, tmp)
        binp = os.path.join(tmp, "x.bin")
        del small
        big = big or os.path.join(tmp, "nell2.bin")
        t0 = time.perf_counter()
        save(tt, big)
        save_s = time.perf_counter() - t0
        spec = dict(bin=big, rank=rank, iters=OOC_ITERS, grid=list(grid),
                    ranks=nranks, dir=os.path.join(tmp, "scratch"))
        ooc = run_ooc_child(dict(spec, kind="ooc"))
        ram = run_ooc_child(dict(spec, kind="ram"))
        rows = ooc_rank_launch(ooc, rank)
        diff = max(abs(a - b) for a, b in zip(ooc["fits"], ram["fits"]))
        rel = lam_rel(ooc["lam"], ram["lam"])
        failures = []
        if len(ooc["fits"]) != OOC_ITERS or not diff <= PARITY_TOL:
            failures.append(f"fits {ooc['fits']} against {ram['fits']}")
        if not rel <= LAMBDA_TOL:
            failures.append(f"λ relative difference {rel:.3e}")
        if ooc["launches"] != ram["launches"] or not ooc["launches"]:
            failures.append(f"launches {ooc['launches']} against "
                            f"{ram['launches']}")
        if ooc["demoted"] or ram["demoted"]:
            failures.append(f"demoted {ooc['demoted']} {ram['demoted']}")
        if not ram["layouts_equal"] or not all(ram["layouts_equal"].values()):
            failures.append(f"layouts differ: {ram['layouts_equal']}")
        if any(a["block"] != b["block"] or a["seg_width"] != b["seg_width"]
               for a, b in zip(ooc["layouts"], ram["layouts"])):
            failures.append("block or seg_width differ")
        if any(not (lay["memmap_dir"] or "").startswith(spec["dir"])
               for lay in ooc["layouts"]):
            failures.append(f"layouts not memmapped under {spec['dir']}: "
                            f"{ooc['layouts']}")
        if not ooc["rss_growth_kib"] < ram["rss_growth_kib"]:
            failures.append(f"peak RSS growth {ooc['rss_growth_kib']} KiB "
                            f"out of core, {ram['rss_growth_kib']} in memory")
        log(f"[ooc] MEDIUM 20M: peak RSS growth {ooc['rss_growth_kib']} KiB "
            f"out of core, {ram['rss_growth_kib']} KiB in memory; build "
            f"{json.dumps(ooc['build_s'])} against "
            f"{json.dumps(ram['build_s'])} s; {ooc['ms_per_iter']:.3f} "
            f"against {ram['ms_per_iter']:.3f} "
            f"ms/iteration; max |fit difference| {diff:.3e}, λ relative "
            f"difference {rel:.3e}")
        if failures:
            raise AssertionError("phase 16: " + "; ".join(failures))
        cli = ooc_cli_runs(binp, tmp, nranks, rank)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    log(f"[ooc] phase 16 took {seconds:.1f} s")
    return dict(ranks=nranks, grid=list(grid), text=text, save_bin_s=save_s,
                medium=dict(ooc=ooc, ram=ram, fit_diff=diff,
                            lam_rel_diff=rel), rank0_rows=rows,
                cli=cli, seconds=seconds)


def _ooc_summary(ooc: dict) -> dict:
    """Phase 16 in row 1 of the kernels line."""
    med = ooc["medium"]
    keep = ("build_s", "ms_per_iter", "ms_per_iter_from_3", "launches",
            "fits", "rss_growth_kib", "rss_growth_by_kind_kib",
            "peak_rss_kib", "load_s", "call_s", "process_s")
    return dict(
        ranks=ooc["ranks"], grid=ooc["grid"], text=ooc["text"],
        medium={k: {key: med[k][key] for key in keep}
                for k in ("ooc", "ram")},
        fit_diff=med["fit_diff"], lam_rel_diff=med["lam_rel_diff"],
        rank0_rows=ooc["rank0_rows"],
        cli={k: dict(launches=v["ooc"]["launches"],
                     seconds=[v["ooc"]["seconds"], v["ram"]["seconds"]],
                     fit_diff=v["fit_diff"], lam_rel_diff=v["lam_rel_diff"])
             for k, v in ooc["cli"].items() if k != "drills"},
        drills=ooc["cli"]["drills"], phase_seconds=ooc["seconds"])


def _ooc_row(ooc: dict) -> dict:
    """Row 1 of the kernels line from phase 16 alone (``--ooc``)."""
    return _record_row(
        "fused_mttkrp_t", FUSED_SRC, f"{PK}:355",
        ooc["medium"]["ooc"]["launches"], ooc["rank0_rows"], None,
        note=f"ms/plain_ms/bound_ms: mean per launch over rank 0's sorted "
        f"layouts of phase 16's out-of-core MEDIUM build (grid "
        f"{ooc['grid']}), NELL-2 shape, 20M nonzeros, rank {RANK}; "
        f"launches: phase 16's out-of-core MEDIUM CPD, {OOC_ITERS} "
        f"iterations", status=WALK_STATUS, phase16=_ooc_summary(ooc))


# -- phase 17: the batched CPD and the warm update pre-pass --------------------

#: phase 17's batch: the service layer's tenant mix at a fleet's size, K
#: slots of one shape regime (m3:d10-10-10:z18): dims uniform in
#: [BATCH_DIM_LO, BATCH_DIM_HI], BATCH_DRAWS uniform draws, values
#: uniform [0, 1), slot i from seed BATCH_SEED + i
BATCH_K = 64
BATCH_DIM_LO, BATCH_DIM_HI = 520, 1000
BATCH_DRAWS = (140_000, 250_000)
BATCH_SEED = 17
BATCH_RANK = 32
BATCH_ITERS = 10
BATCH_RETRIES = 3
#: the lanes whose batched MTTKRP is held to mttkrp_stream of the slot
BATCH_LANES = (0, 21, 42, 63)
#: the slots run again through the sequential cpd_als
BATCH_SEQ = 8
#: the sequential cpd_als against the batch's slot (f32, another
#: summation order): factors and λ within BATCH_SEQ_REL of max|seq|, fits
#: within BATCH_SEQ_FIT_TOL (fits of this batch are ~4e-4, computed as
#: 1 - ‖X - Z‖/‖X‖ in f32, so 1e-6 is ~16 of f32's steps near 1); the
#: control is slot 0 from another seed (BATCH_SEQ_CONTROL_SEED), read
#: beside the gate to show that it can fail
BATCH_SEQ_REL = 1e-3
BATCH_SEQ_FIT_TOL = 1e-6
BATCH_SEQ_CONTROL_SEED = 1000
#: bf16 storage against f32: each slot's fit within this share of its f32
#: fit (≙ tests/test_batched.py's 0.03, taken relative here: the fits are
#: ~4e-4, far below an absolute 0.03)
BATCH_BF16_FIT_GAP = 0.03
#: the NaN drill's neighbours against the clean run, relative to max|.|:
#: on the card the atomic index_add_ sums in a run-dependent order, so
#: two clean runs already differ, and on this batch (fits ~4e-4, a CPD
#: of uniform noise) ten sweeps amplify that past 1e-5; the gate is the
#: larger of this and four times two clean runs' difference (a drawn
#: noise, not a bound), and the drill runs again under deterministic
#: algorithms, where it is bit for bit
BATCH_DRILL_TOL = 1e-5
#: sym_eig over the stack against its plain version (phase 5's gate)
BATCH_EIG_TOL = 1e-5
#: the update path on phase 6's 2M-nonzero tensor (seed 5): the base CPD
#: and the from-scratch refit take UPDATE_ITERS, the warm run
#: UPDATE_SWEEPS (25% of them, docs/batched.md), rank UPDATE_RANK; the
#: delta is UPDATE_DELTA of the tensor's nonzeros, new draws of the same
#: generator (seed UPDATE_DELTA_SEED), merged by concatenation and
#: deduplicate
UPDATE_RANK = 16
UPDATE_ITERS = 20
UPDATE_SWEEPS = 5
UPDATE_DELTA = 0.01
UPDATE_DELTA_SEED = 99
#: the warm fit against the refit's: within UPDATE_FIT_TOL (the doc's
#: promise) and within UPDATE_FIT_REL of the refit's fit (the fits here
#: are ~1.4e-5, a CPD of uniform noise, so the first cannot fail)
UPDATE_FIT_TOL = 1e-3
UPDATE_FIT_REL = 0.25
#: the refreshed factors against refresh_touched_rows on a CPU copy of
#: the same inputs (COO, f32), per mode, relative to max|plain|
UPDATE_REFRESH_TOL = 1e-4


def batch_tensors() -> list:
    """Phase 17's K tenants (deduplicated, so every slot's nonzeros are
    distinct coordinates)."""
    from splatt_tpu_torch.coo import SparseTensor

    out = []
    for i in range(BATCH_K):
        rng = np.random.default_rng(BATCH_SEED + i)
        dims = tuple(int(d) for d in rng.integers(BATCH_DIM_LO,
                                                  BATCH_DIM_HI + 1, 3))
        n = int(rng.integers(BATCH_DRAWS[0], BATCH_DRAWS[1] + 1))
        inds = np.stack([rng.integers(0, d, n) for d in dims])
        out.append(SparseTensor(inds, rng.random(n), dims).deduplicate())
    return out


def batch_opts(**kw):
    from splatt_tpu_torch import Options
    from splatt_tpu_torch.config import Verbosity

    return Options(**dict(dict(max_iterations=BATCH_ITERS, tolerance=0.0,
                               random_seed=0, verbosity=Verbosity.NONE,
                               engine_fallback=False), **kw))


def batch_mttkrp_lanes(bb) -> list:
    """The batched MTTKRP of each mode on random factors, timed, and the
    lanes of BATCH_LANES held to mttkrp_stream of their slot."""
    import torch

    from splatt_tpu_torch.ops.mttkrp import (mttkrp_batched_stream,
                                             mttkrp_stream)

    gen = torch.Generator(device="cuda").manual_seed(3)
    F = [torch.rand((bb.k, d, BATCH_RANK), generator=gen, device="cuda")
         for d in bb.dims]
    rows = []
    for m in range(bb.nmodes):
        M = mttkrp_batched_stream(bb.inds, bb.vals, F, m, bb.dims[m])
        worst = 0.0
        for i in BATCH_LANES:
            want = mttkrp_stream(bb.inds[i], bb.vals[i], [f[i] for f in F],
                                 m, bb.dims[m])
            rel = float((M[i] - want).abs().max() / want.abs().max())
            worst = max(worst, rel)
        ms = time_ms(lambda: mttkrp_batched_stream(
            bb.inds, bb.vals, F, m, bb.dims[m]), reps=5)
        row = dict(mode=m, lanes=list(BATCH_LANES), max_rel_err=worst,
                   ms=ms, product_bytes=bb.k * bb.nnz_pad * BATCH_RANK * 4)
        log(f"[batch] mttkrp_batched_stream {json.dumps(row)}")
        if not worst <= KERNEL_TOL:
            raise AssertionError(f"batched MTTKRP mode {m}: lane error "
                                 f"{worst:.3e} > {KERNEL_TOL}")
        rows.append(row)
        del M
    return rows


def batch_sym_eig(bb) -> dict:
    """sym_eig over the stack of each mode's normal-equations matrices
    (random factors): one launch of K CTAs against its plain version
    (w within BATCH_EIG_TOL of max|w| per slot) and against K single
    launches (bit for bit), timed beside K single launches, the plain
    version, the bound and batched torch.linalg.eigh (its host sync
    included)."""
    import torch

    from splatt_tpu_torch.ops import linalg

    gen = torch.Generator(device="cuda").manual_seed(4)
    F = [torch.rand((bb.k, d, BATCH_RANK), generator=gen, device="cuda")
         for d in bb.dims]
    grams = [linalg.gram(f) for f in F]
    rows = []
    for m in range(bb.nmodes):
        A = linalg.form_normal_lhs(grams, m).contiguous()
        before = linalg.sym_eig.launches
        w, v, sweeps = linalg.sym_eig(A, return_sweeps=True)
        if linalg.sym_eig.launches != before + 1:
            raise AssertionError("the stack took more than one launch")
        singles = [linalg.sym_eig(A[i], return_sweeps=True)
                   for i in range(bb.k)]
        # the plain version over the whole stack for mode 0 (its time is
        # the row's plain_ms), over BATCH_LANES for the others
        held = list(range(bb.k)) if m == 0 else list(BATCH_LANES)
        t0 = time.perf_counter()
        wp, vp, sp = linalg.sym_eig_plain(A[held].cpu())
        plain_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        linalg.check_solver()
        errs = [float((w[i].cpu() - wp[j]).abs().max())
                for j, i in enumerate(held)]
        rel = max(e / float(wp[j].abs().max()) for j, e in enumerate(errs))
        same = all(torch.equal(w[i], s[0]) and torch.equal(v[i], s[1])
                   and int(sweeps[i]) == int(torch.as_tensor(s[2]).sum())
                   for i, s in enumerate(singles))
        if not (rel <= BATCH_EIG_TOL and same):
            raise AssertionError(f"batched sym_eig mode {m}: rel {rel:.3e}, "
                                 f"equal to single launches: {same}")
        sw = int(sweeps.sum())
        n = BATCH_RANK + (BATCH_RANK & 1)
        bound_ms, bound_by = least_ms(
            bb.k * (2 * BATCH_RANK ** 2 + BATCH_RANK) * 4,
            sw * (n - 1) * 9 * n * n)
        row = dict(mode=m, k=bb.k, R=BATCH_RANK, max_rel_err=rel,
                   max_abs_err=max(errs), plain_slots=len(held),
                   sweeps_min=int(sweeps.min()), sweeps_max=int(sweeps.max()),
                   ms=time_ms(lambda: linalg.sym_eig(A), reps=20, warmup=2),
                   singles_ms=time_ms(lambda: [linalg.sym_eig(A[i])
                                               for i in range(bb.k)],
                                      reps=3),
                   plain_ms=plain_ms if m == 0 else None,
                   library_ms=time_ms(lambda: torch.linalg.eigh(A), reps=10,
                                      warmup=2),
                   bound_ms=bound_ms, bound_by=bound_by)
        log(f"[batch] sym_eig stack {json.dumps(row)}")
        rows.append(row)
    return dict(rows=rows, plain_ms=rows[0]["plain_ms"],
                **{k: sum(r[k] for r in rows) / len(rows)
                   for k in ("ms", "singles_ms", "library_ms",
                             "bound_ms")},
                max_rel_err=max(r["max_rel_err"] for r in rows),
                max_abs_err=max(r["max_abs_err"] for r in rows),
                bound_by=rows[0]["bound_by"])


def batch_sweep_phases(bb, res) -> dict:
    """One batched sweep and its phases, each timed alone with CUDA
    events on the run's final factors: the three batched MTTKRPs, the
    three solves, normalize + Gram, the fit; and a frozen slot's lanes
    bit for bit through a sweep whose other slots run."""
    import torch

    from splatt_tpu_torch import cpd as tcpd
    from splatt_tpu_torch.ops import linalg
    from splatt_tpu_torch.ops.mttkrp import mttkrp_batched_stream

    factors = tcpd._initial_batch(bb, BATCH_RANK,
                                  list(range(bb.k)), None)
    grams = [linalg.gram(F) for F in factors]
    lam = torch.ones((bb.k, BATCH_RANK), device="cuda")
    sweep = tcpd._make_batched_sweep(bb, BATCH_RANK, bb.slot_frobsq(),
                                     {"builds": 0})
    reg = torch.zeros(bb.k, device="cuda")
    active = torch.ones(bb.k, dtype=torch.bool, device="cuda")
    frozen = active.clone()
    frozen[1::2] = False
    f2, g2, lam2, _, _ = sweep(factors, grams, lam, reg, frozen, False)
    torch.cuda.synchronize()
    exact = all(torch.equal(a[1::2], b[1::2]) for a, b in zip(f2, factors)) \
        and all(torch.equal(a[1::2], b[1::2]) for a, b in zip(g2, grams)) \
        and torch.equal(lam2[1::2], lam[1::2])
    if not exact:
        raise AssertionError("a frozen lane moved through a batched sweep")
    M = [mttkrp_batched_stream(bb.inds, bb.vals, factors, m, bb.dims[m])
         for m in range(bb.nmodes)]
    lhs = [linalg.form_normal_lhs(grams, m) for m in range(bb.nmodes)]
    U = [linalg.solve_normals(lhs[m], M[m]) for m in range(bb.nmodes)]

    def norm_gram():
        for u in U:
            linalg.gram(linalg.normalize_columns(u, "max")[0])

    def fit():
        zz, inner = tcpd._zz_inner_batched(lam, grams, M[-1], factors[-1])
        return 1.0 - torch.sqrt(torch.clamp(zz - 2.0 * inner, min=0.0))

    parts = dict(
        mttkrp=time_ms(lambda: [mttkrp_batched_stream(
            bb.inds, bb.vals, factors, m, bb.dims[m])
            for m in range(bb.nmodes)], reps=5),
        solve=time_ms(lambda: [linalg.solve_normals(lhs[m], M[m])
                               for m in range(bb.nmodes)], reps=10),
        normalize_gram=time_ms(norm_gram, reps=10),
        fit=time_ms(fit, reps=10),
        sweep=time_ms(lambda: sweep(factors, grams, lam, reg, active, False),
                      reps=5))
    log(f"[batch] sweep phases, ms (CUDA events, one sweep over "
        f"{bb.k} slots): {json.dumps(parts)}; frozen lanes bit-exact")
    return parts


def batch_cpd(bb, opts, **kw):
    """cpd_als_batched on a built batch with the launch counters read
    around it: (result, seconds, sym_eig launches, peak GiB)."""
    import torch

    from splatt_tpu_torch.cpd import cpd_als_batched
    from splatt_tpu_torch.ops import linalg

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    linalg.sym_eig.launches = 0
    t0 = time.perf_counter()
    res = cpd_als_batched(bb, BATCH_RANK, opts, **kw)
    torch.cuda.synchronize()
    return (res, time.perf_counter() - t0, linalg.sym_eig.launches,
            torch.cuda.max_memory_allocated() / 2 ** 30)


def batch_syncs(bb) -> dict:
    """Host syncs of one checked batched iteration, a 3-iteration run's
    less a 2-iteration run's (set-up and result syncs cancel): the
    cudaStreamSynchronize calls torch.profiler records on the host (the
    gate), beside its device-to-host copies and the warnings of
    set_sync_debug_mode("warn"), both of which have missed reads on this
    card (PERF.md)."""
    from torch.profiler import ProfilerActivity, profile

    from splatt_tpu_torch.cpd import cpd_als_batched

    def run(i):
        return cpd_als_batched(bb, BATCH_RANK, batch_opts(max_iterations=i))

    counts = []
    for i in (2, 3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(i)
        ev = {e.key: e.count for e in prof.key_averages()}
        counts.append((ev.get("cudaStreamSynchronize", 0),
                       sum(n for k, n in ev.items() if "DtoH" in k)))
    warn = [count_syncs(lambda i=i: run(i)) for i in (2, 3)]
    return dict(stream_syncs=counts[1][0] - counts[0][0],
                dtoh_copies=counts[1][1] - counts[0][1],
                warn_mode=warn[1] - warn[0])


def _neighbour_rel(res, clean, k: int) -> float:
    """The largest difference of slots 1..k-1 (factors and λ) between two
    batched runs, relative to each tensor's max|.|."""
    worst = 0.0
    for i in range(1, k):
        a, b = res.results[i], clean.results[i]
        for x, y in list(zip(a.factors, b.factors)) + [(a.lam, b.lam)]:
            worst = max(worst, float((x - y).abs().max() / y.abs().max()))
    return worst


def batch_drill(bb, clean) -> dict:
    """The cpd.batch.sweep NaN drill: slot 0 rolls back alone and its
    events name slot 0 alone.  On the default path, whose index_add_ is
    atomic (an order that changes from run to run), every neighbour
    within BATCH_DRILL_TOL of the clean run, beside two clean runs'
    difference; under torch.use_deterministic_algorithms (index_add_ in a
    fixed order), every neighbour bit for bit the clean run's."""
    import torch

    from splatt_tpu_torch import resilience
    from splatt_tpu_torch.cpd import cpd_als_batched
    from splatt_tpu_torch.utils import faults

    def drilled():
        with resilience.scope("batch-drill",
                              health_retries=BATCH_RETRIES) as sc:
            with faults.scoped("cpd.batch.sweep:nan:iter=2"):
                res = cpd_als_batched(bb, BATCH_RANK, batch_opts())
        return res, sorted({e.get("slot") for e in sc.report.events()
                            if e["kind"].startswith("health_")})

    res, slots = drilled()
    again = cpd_als_batched(bb, BATCH_RANK, batch_opts())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        det_clean = cpd_als_batched(bb, BATCH_RANK, batch_opts())
        det, det_slots = drilled()
    finally:
        torch.use_deterministic_algorithms(False)
    exact = all(
        all(torch.equal(x, y) for x, y in zip(a.factors, b.factors))
        and torch.equal(a.lam, b.lam) and fa == fb
        for a, b, fa, fb in list(zip(det.results, det_clean.results,
                                     det.fits, det_clean.fits))[1:])
    out = dict(rollbacks_slot0=res.rollbacks[0],
               rollbacks_others=sum(res.rollbacks[1:]), event_slots=slots,
               statuses=sorted(set(res.statuses)),
               neighbour_rel=_neighbour_rel(res, clean, bb.k),
               clean_twice_rel=_neighbour_rel(again, clean, bb.k),
               deterministic_neighbours_exact=exact,
               deterministic_rollbacks=det.rollbacks[0],
               fit0=res.fits[0], clean_fit0=clean.fits[0],
               compiles=res.compiles)
    log(f"[batch] NaN drill cpd.batch.sweep:nan:iter=2: {json.dumps(out)} "
        f"(default path: a tolerance, the card's index_add_ is atomic; "
        f"deterministic algorithms: bit for bit)")
    if not (res.rollbacks[0] >= 1 and sum(res.rollbacks[1:]) == 0
            and slots == [0] == det_slots and exact
            and out["neighbour_rel"] <= max(BATCH_DRILL_TOL,
                                            4 * out["clean_twice_rel"])
            and res.compiles == 1 and math.isfinite(res.fits[0])):
        raise AssertionError(f"NaN drill: {out}")
    return out


def _slot_rel(a, b) -> float:
    """The largest difference of two models (factors and λ), relative to
    each of `b`'s tensors' max|.|."""
    return max(float((x - y).abs().max() / y.abs().max())
               for x, y in list(zip(a.factors, b.factors)) + [(a.lam, b.lam)])


def batch_sequential(tensors, res) -> dict:
    """The first BATCH_SEQ slots through the sequential cpd_als from the
    same init (the slot's seed): factors and λ within BATCH_SEQ_REL of the
    batch's slot, fits within BATCH_SEQ_FIT_TOL, and its steady seconds
    per iteration; beside them the control, slot 0 from another seed."""
    from splatt_tpu_torch import BlockedSparse, cpd_als

    worst, worst_rel, secs = 0.0, 0.0, []
    for i in range(BATCH_SEQ):
        opts = batch_opts(random_seed=i)
        bs = BlockedSparse.from_coo(tensors[i], opts)
        out = cpd_als(bs, BATCH_RANK, opts)
        # steady: iterations 2..10, host clock to each fit read
        secs.append(sum(out.iter_seconds[1:]) / (len(out.iter_seconds) - 1))
        worst = max(worst, abs(out.fit - res.fits[i]))
        worst_rel = max(worst_rel, _slot_rel(res.results[i], out))
    opts = batch_opts(random_seed=BATCH_SEQ_CONTROL_SEED)
    ctl = cpd_als(BlockedSparse.from_coo(tensors[0], opts), BATCH_RANK, opts)
    out = dict(worst_fit_dev=worst, worst_rel=worst_rel,
               control_fit_dev=abs(ctl.fit - res.fits[0]),
               control_rel=_slot_rel(res.results[0], ctl),
               fit_tol=BATCH_SEQ_FIT_TOL, rel_tol=BATCH_SEQ_REL,
               ms_per_tensor_iter=sum(secs) / len(secs) * 1e3)
    log(f"[batch] sequential cpd_als of slots 0..{BATCH_SEQ - 1} from the "
        f"batch's inits (control: slot 0 from seed "
        f"{BATCH_SEQ_CONTROL_SEED}): {json.dumps(out)}")
    if not (worst <= BATCH_SEQ_FIT_TOL and worst_rel <= BATCH_SEQ_REL):
        raise AssertionError(f"sequential slots off: {out}")
    return out


def phase_update() -> dict:
    """The warm update on phase 6's 2M-nonzero tensor: a base CPD, a
    seeded delta merged in, refresh_touched_rows and UPDATE_SWEEPS warm
    sweeps on BlockedSparse.compile of the merged tensor (ALLMODE, so
    every mode runs fused_mttkrp_t on its own layout), fallback off, with
    the launch counters read around it; against a from-scratch refit."""
    import torch

    from splatt_tpu_torch import BlockedSparse, Options, cpd_als, resilience
    from splatt_tpu_torch.config import BlockAlloc, Verbosity
    from splatt_tpu_torch.coo import SparseTensor
    from splatt_tpu_torch.cpd import refresh_touched_rows, touched_rows
    from splatt_tpu_torch.ops import kernels

    # tolerance 0: on this tensor (fit ~1e-6 at rank 16) a tolerance
    # stops every run after two sweeps, so the counts are fixed instead
    def opts(iters):
        return Options(block_alloc=BlockAlloc.ALLMODE, max_iterations=iters,
                       tolerance=0.0, random_seed=7, reorder="identity",
                       engine_fallback=False, verbosity=Verbosity.NONE)

    tt = synthetic_tensor(NELL2, BIG_RANK_NNZ, seed=5)
    delta = synthetic_tensor(NELL2, int(tt.nnz * UPDATE_DELTA),
                             seed=UPDATE_DELTA_SEED)
    merged = SparseTensor(np.concatenate([tt.inds, delta.inds], axis=1),
                          np.concatenate([tt.vals, delta.vals]),
                          tt.dims).deduplicate()
    base = cpd_als(BlockedSparse.compile(tt, opts(UPDATE_ITERS),
                                         rank=UPDATE_RANK),
                   UPDATE_RANK, opts(UPDATE_ITERS))
    bs = BlockedSparse.compile(merged, opts(UPDATE_SWEEPS),
                               rank=UPDATE_RANK)
    touched = touched_rows(delta, 3)
    resilience.reset_demotions()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    warm = refresh_touched_rows(bs, base.factors, touched)
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    refresh_launches = kernels.fused_mttkrp_t.launches
    # the same refresh on a CPU copy of the inputs (plain torch, COO)
    plain = refresh_touched_rows(
        SparseTensor(merged.inds, merged.vals.astype(np.float32),
                     merged.dims),
        [U.cpu() for U in base.factors], touched)
    refresh_rel = max(float((w.cpu() - p).abs().max() / p.abs().max())
                      for w, p in zip(warm, plain))
    # the control: the base model, a refresh that committed nothing
    control_rel = max(float((U.cpu() - p).abs().max() / p.abs().max())
                      for U, p in zip(base.factors, plain))
    untouched_exact = all(
        torch.equal(w[idx], U[idx]) for w, U, idx in (
            (w, U, torch.from_numpy(np.setdiff1d(
                np.arange(U.shape[0]), touched[m])).to(U.device))
            for m, (w, U) in enumerate(zip(warm, base.factors))))
    up = cpd_als(bs, UPDATE_RANK, opts(UPDATE_SWEEPS), init=warm)
    torch.cuda.synchronize()
    launches = kernels.fused_mttkrp_t.launches
    demotions = len(resilience.demotions())
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    refit = cpd_als(bs, UPDATE_RANK, opts(UPDATE_ITERS))
    refit_s = time.perf_counter() - t0
    out = dict(nnz=tt.nnz, delta_nnz=delta.nnz, merged_nnz=merged.nnz,
               touched_rows=[int(r.size) for r in touched.values()],
               base_fit=base.fit, warm_fit=up.fit, warm_sweeps=len(up.fits),
               refit_fit=refit.fit, refit_sweeps=len(refit.fits),
               fit_dev=abs(up.fit - refit.fit),
               fit_rel=abs(up.fit - refit.fit) / refit.fit,
               refresh_rel=refresh_rel, refresh_control_rel=control_rel,
               untouched_exact=untouched_exact,
               refresh_launches=refresh_launches,
               fused_mttkrp_t_launches=launches, demotions=demotions,
               refresh_s=refresh_s, warm_s=warm_s, refit_s=refit_s)
    log(f"[update] {json.dumps(out)}")
    expect = bs.nmodes * (1 + UPDATE_SWEEPS)
    if not (launches == expect and refresh_launches == bs.nmodes
            and len(up.fits) == UPDATE_SWEEPS
            and demotions == 0 and out["fit_dev"] <= UPDATE_FIT_TOL
            and out["fit_rel"] <= UPDATE_FIT_REL
            and refresh_rel <= UPDATE_REFRESH_TOL and untouched_exact):
        raise AssertionError(f"update path: {out}, expected {expect} "
                             f"fused_mttkrp_t launches")
    out["layouts"] = bs
    return out


def phase_batch() -> dict:
    """Phase 17: the batched CPD at a fleet's size and the warm update
    pre-pass; every gate fatal."""
    import torch

    from splatt_tpu_torch.blocked import batch_compile
    from splatt_tpu_torch.ops import linalg

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    tensors = batch_tensors()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bb = batch_compile(tensors, batch_opts(), rank=BATCH_RANK)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    fac_bytes = bb.k * sum(bb.dims) * BATCH_RANK * 4
    log(f"[batch] {bb!r}: {bb.k} slots, nnz {min(bb.slot_nnz)}-"
        f"{max(bb.slot_nnz)}, generated in {gen_s:.2f} s")
    log(f"[batch] host build {build_s:.2f} s; device bytes: inds "
        f"{bb.inds.numel() * 4}, vals {bb.vals.numel() * 4}, factors "
        f"{fac_bytes}, one batched MTTKRP's product "
        f"{bb.k * bb.nnz_pad * BATCH_RANK * 4}")
    lanes = batch_mttkrp_lanes(bb)
    eig = batch_sym_eig(bb)
    res, secs, eig_launches, peak = batch_cpd(bb, batch_opts())
    half, secs_half, _, _ = batch_cpd(
        bb, batch_opts(max_iterations=BATCH_ITERS // 2))
    parts = batch_sweep_phases(bb, res)
    # steady ms an iteration: the 10-iteration run's less the 5-iteration
    # run's seconds (set-up, init and unstacking cancel)
    ms_iter = (secs - secs_half) / (res.iterations - half.iterations) * 1e3
    syncs = batch_syncs(bb)
    log(f"[batch] host syncs per checked iteration: {json.dumps(syncs)}")
    log(f"[batch] cpd_als_batched: {res.iterations} iterations in "
        f"{secs:.3f} s, {ms_iter:.3f} ms per iteration, "
        f"{ms_iter / bb.k:.4f} ms per tensor per iteration (the "
        f"{BATCH_ITERS}-iteration call's seconds less the "
        f"{BATCH_ITERS // 2}-iteration call's); compiles "
        f"{res.compiles}; host syncs per checked iteration "
        f"{syncs['stream_syncs']}; "
        f"sym_eig launches {eig_launches} ({eig_launches / res.iterations:g}"
        f" per sweep, {bb.nmodes} modes); peak device memory {peak:.2f} GiB")
    log(f"[batch] fits min {min(res.fits):.5f} max {max(res.fits):.5f}; "
        f"statuses {sorted(set(res.statuses))}")
    if not (res.compiles == 1 and syncs["stream_syncs"] == 1
            and eig_launches == bb.nmodes * res.iterations
            and res.iterations == BATCH_ITERS
            and all(math.isfinite(f) and 0 < f <= 1 for f in res.fits)
            and res.results[5].dims == bb.slot_dims[5]):
        raise AssertionError("batched CPD: compiles, syncs, launches or "
                             "fits off")
    seq = batch_sequential(tensors, res)
    log(f"[batch] ms per tensor per iteration: batched "
        f"{ms_iter / bb.k:.4f}, sequential {seq['ms_per_tensor_iter']:.4f}")
    bb16 = batch_compile(tensors, batch_opts(val_storage="bf16"),
                         rank=BATCH_RANK)
    res16, secs16, _, _ = batch_cpd(bb16, batch_opts(val_storage="bf16"))
    gap = max(abs(a - b) / b for a, b in zip(res16.fits, res.fits))
    bf16_ok = all(f.dtype == torch.bfloat16 for kt in res16.results
                  for f in kt.factors)
    log(f"[batch] bf16 storage: factors bf16 {bf16_ok}, worst fit gap to "
        f"f32 {gap:.3e} of the f32 fit (limit {BATCH_BF16_FIT_GAP}; the "
        f"control, another init in f32: "
        f"{seq['control_fit_dev'] / res.fits[0]:.3e}), "
        f"{secs16 / res16.iterations * 1e3:.3f} ms per iteration")
    if not (bf16_ok and gap <= BATCH_BF16_FIT_GAP):
        raise AssertionError("bf16 batch off")
    del bb16, res16
    drill = batch_drill(bb, res)
    del bb
    torch.cuda.empty_cache()
    upd = phase_update()
    seconds = time.perf_counter() - t_phase
    log(f"[batch] phase 17: {seconds:.1f} s")
    return dict(build_s=build_s, ms_per_iter=ms_iter,
                ms_per_tensor_iter=ms_iter / BATCH_K, compiles=res.compiles,
                syncs_per_check=syncs, sym_eig_launches=eig_launches,
                peak_gib=peak, sweep_phase_ms=parts, lanes=lanes,
                sym_eig=eig, sequential=seq, bf16_fit_gap=gap, drill=drill,
                update=upd, seconds=seconds)


def _batch_summary(bt: dict) -> dict:
    """Phase 17's figures for the kernels line."""
    upd = {k: v for k, v in bt["update"].items() if k != "layouts"}
    return dict({k: v for k, v in bt.items()
                 if k not in ("update", "sym_eig", "lanes")},
                update=upd, lanes_max_rel_err=max(
                    r["max_rel_err"] for r in bt["lanes"]))


def _batch_eig(bt: dict) -> dict:
    """The batched sym_eig's figures for the eigensolver's entry."""
    eig = bt["sym_eig"]
    return dict(launches=bt["sym_eig_launches"], k=BATCH_K, R=BATCH_RANK,
                **{k: eig[k] for k in ("ms", "singles_ms", "plain_ms",
                                       "library_ms", "bound_ms", "bound_by",
                                       "max_rel_err", "max_abs_err")})


#: phase 18: the serve daemon on the card.  The full-width job is phase
#: 5's CPD (rank 50, 5 iterations, tolerance 0) filed as a cpd job.  A
#: served model (read back from its checkpoint) against its reference
#: run: factors and λ within SERVE_REL of max|.| of the reference's, and
#: the model's f64 fit (true_fit) within SERVE_FIT_REL of the
#: reference's; the control, the same job from SERVE_CONTROL_SEED, must
#: miss both limits.  On a CPD of noise another seed's f64 fit lies
#: within 1e-4 of this one's, so the fit limit is far below that
SERVE_REL = 1e-4
SERVE_FIT_REL = 1e-5
SERVE_CONTROL_SEED = 1000
#: predict requests against the full-width model: coordinates each, and
#: a top-k of each mode in turn
SERVE_PREDICTS = 16
SERVE_COORDS = 4096
SERVE_TOPK = 10
#: the served answers against an f64 numpy reconstruction, relative to
#: max|x̂|
SERVE_F64_TOL = 1e-4
#: the coalesced batch: phase 17's regime, this many jobs, batch_min too
SERVE_BATCH_K = 8
#: the isolation drill's CPDs on the 2M tensor
SERVE_ISO_ITERS = 10
#: the crash drill: a long job on the 2M tensor, checkpointed every
#: SERVE_CRASH_EVERY iterations, killed once its first checkpoint lands
SERVE_CRASH_ITERS = 400
SERVE_CRASH_EVERY = 25


def _serve_result(srv, jid: str) -> dict:
    res = srv.result(jid)
    if res is None:
        raise AssertionError(f"job {jid}: no result ({srv.status(jid)})")
    return res


def _checkpoint_model(path: str):
    """A served model as the checkpoint holds it, on the card."""
    from types import SimpleNamespace

    from splatt_tpu_torch.cpd import load_checkpoint

    factors, lam, _, fit = load_checkpoint(path)
    return SimpleNamespace(factors=[f.cuda() for f in factors],
                           lam=lam.cuda(), fit=fit)


def serve_model_gate(what: str, tt, served, ref, control) -> dict:
    """`served` against `ref` and the control against `ref` (each with
    factors, λ and the sweeps' f32 fit): the largest difference relative
    to max|.| of ref's, and the f64 fits' difference relative to ref's;
    ``ok`` when the served model meets both limits and the control
    misses both (phase_serve raises at its end unless every gate is)."""
    fit_ref = true_fit(tt, ref.factors, ref.lam)
    fit_srv = true_fit(tt, served.factors, served.lam)
    fit_ctl = true_fit(tt, control.factors, control.lam)
    out = dict(rel=_slot_rel(served, ref),
               fit64_rel=abs(fit_srv - fit_ref) / abs(fit_ref),
               control_rel=_slot_rel(control, ref),
               control_fit64_rel=abs(fit_ctl - fit_ref) / abs(fit_ref),
               fit64=fit_srv, ref_fit64=fit_ref, control_fit64=fit_ctl,
               fit_dev=abs(served.fit - ref.fit), rel_tol=SERVE_REL,
               fit_rel_tol=SERVE_FIT_REL)
    out["ok"] = (out["rel"] <= SERVE_REL
                 and out["fit64_rel"] <= SERVE_FIT_REL
                 and out["control_rel"] > SERVE_REL
                 and out["control_fit64_rel"] > SERVE_FIT_REL)
    log(f"[serve] {what}: the served model against its reference "
        f"(control: seed {SERVE_CONTROL_SEED}): {json.dumps(out)}")
    return out


def _fused_t_modes(bs, rank: int) -> list:
    """The modes whose plan names fused_t on layouts `bs` at `rank`."""
    from splatt_tpu_torch.ops.mttkrp import plan_mttkrp

    factors = random_factors(bs, rank, 1)
    return [m for m in range(bs.nmodes)
            if plan_mttkrp(bs, factors, m).engine == "fused_t"]


def serve_reference(srv, spec: dict, tt=None, bs=None,
                    rank: int = RANK) -> dict:
    """A served job's reference (phases 18 and 19): the job's own options
    (`srv`'s) and layouts (`bs`, else compiled from `tt`), a direct
    cpd_als from the spec's seed, the control from SERVE_CONTROL_SEED,
    and the modes whose plan names fused_t."""
    import torch

    from splatt_tpu_torch import BlockedSparse, cpd_als

    opts = srv._options(spec)
    if bs is None:
        bs = BlockedSparse.compile(tt, opts, device="cuda", rank=rank)
    ref = dict(fused=_fused_t_modes(bs, rank),
               direct=cpd_als(bs, rank, opts, device="cuda"),
               control=cpd_als(bs, rank, srv._options(
                   dict(spec, seed=SERVE_CONTROL_SEED)), device="cuda"))
    del bs
    torch.cuda.empty_cache()
    return ref


def _job_dispatches(jid: str) -> dict:
    """engine -> count of the mttkrp.dispatch spans job `jid` recorded
    (the launch counters are process-wide; the spans carry the job)."""
    from splatt_tpu_torch import trace

    out: dict = {}
    for s in trace.spans("mttkrp.dispatch"):
        if s.get("job") == jid:
            eng = s["args"].get("engine")
            out[eng] = out.get(eng, 0) + 1
    return out


@contextlib.contextmanager
def _kept_compiles():
    """Keep what ``BlockedSparse.compile`` returns inside the block (the
    daemon's job builds its layouts there), so that the direct run takes
    the job's own layouts instead of a second host build."""
    from splatt_tpu_torch.blocked import BlockedSparse

    raw = BlockedSparse.__dict__["compile"]
    kept: list = []

    def compile_(*a, **kw):
        kept.append(raw.__func__(*a, **kw))
        return kept[-1]

    BlockedSparse.compile = staticmethod(compile_)
    try:
        yield kept
    finally:
        BlockedSparse.compile = raw


def serve_full_width(tmp: str, tt, bin_path: str, main_ms) -> dict:
    """The full-width cpd job (`tt`, written at `bin_path`) through an
    in-process daemon on the card; the served model against a direct
    cpd_als on the job's own layouts from the same seed."""
    import torch

    from splatt_tpu_torch import resilience, serve, trace
    from splatt_tpu_torch.ops import kernels

    srv = serve.Server(os.path.join(tmp, "spool"), workers=1)
    spec = dict(id="nell2", tensor=bin_path, rank=RANK, iters=ITERS,
                tol=0.0, seed=0, checkpoint_every=ITERS)
    resilience.reset_demotions()
    torch.cuda.synchronize()
    kernels.reset_launches()
    trace.reset()
    trace.set_enabled(True)
    t0 = time.perf_counter()
    try:
        with _kept_compiles() as kept:
            srv.submit(spec)
            summary = srv.run_once()
    finally:
        trace.set_enabled(None)
    job_s = time.perf_counter() - t0
    launches = kernels.fused_mttkrp_t.launches
    res = _serve_result(srv, "nell2")
    iters = sorted((s for s in trace.spans("cpd.iter")
                    if s.get("job") == "nell2"),
                   key=lambda s: s["args"]["it"])
    steady_ms = sum(s["dur"] for s in iters[1:]) / max(len(iters) - 1, 1) \
        * 1e3
    dispatch = _job_dispatches("nell2")
    trace.reset()
    # the direct run: the job's own options and layouts
    bs, = kept  # the job compiled once
    del bs
    ref = serve_reference(srv, spec, bs=kept.pop())
    direct, control, fused = ref["direct"], ref["control"], ref["fused"]
    gate = serve_model_gate("full-width job", tt, _checkpoint_model(
        os.path.join(srv.ckpt_dir, "nell2.npz")), direct, control)
    # the journal's fsynced append, on a journal of its own
    jr = serve.Journal(os.path.join(tmp, "append.jsonl"))
    t0 = time.perf_counter()
    for i in range(50):
        jr.append({"rec": "probe", "job": f"x{i}"})
    append_ms = (time.perf_counter() - t0) / 50 * 1e3
    out = dict(status=res["status"], fit=res["fit"], direct_fit=direct.fit,
               fit_dev=abs(res["fit"] - direct.fit), model=gate,
               model_gen=res.get("model_gen"), launches=launches,
               expected_launches=len(fused) * ITERS, fused_t_modes=fused,
               demotions=res["demotions"], dispatch=dispatch,
               job_s=job_s, parts_s=srv.timings.get("nell2"),
               ms_per_iter=steady_ms, main_path_ms_per_iter=main_ms,
               journal_append_ms=append_ms,
               counts=summary["counts"])
    log(f"[serve] full-width job: {json.dumps(out)}")
    if not (res["status"] == "converged" and summary["counts"] ==
            {"done": 1} and res.get("model_gen") == 1
            and fused and launches == len(fused) * ITERS
            and not res["demotions"]):
        raise AssertionError(f"phase 18, the full-width job: {out}")
    # the reference phase 19 holds its failed-over job to
    return dict(out, srv=srv, ref=ref)


def serve_predicts(srv) -> dict:
    """SERVE_PREDICTS predict jobs against the full-width model, each
    filed and answered through the spool; the answers against the
    functions on factors read straight from the checkpoint (bit for
    bit) and against an f64 reconstruction."""
    from splatt_tpu_torch import predict, serve
    from splatt_tpu_torch.cpd import load_checkpoint

    factors, lam, _, _ = load_checkpoint(os.path.join(srv.ckpt_dir,
                                                      "nell2.npz"))
    F = [f.numpy() for f in factors]
    L = lam.numpy()
    F64 = [f.astype(np.float64) for f in F]
    dims = [f.shape[0] for f in F]
    rng = np.random.default_rng(23)
    total_ms, compute_ms, worst, caches = [], [], 0.0, []
    for i in range(SERVE_PREDICTS):
        coords = np.stack([rng.integers(0, d, SERVE_COORDS) for d in dims],
                          axis=1)
        mode = i % len(dims)
        fixed = {m: int(rng.integers(0, dims[m]))
                 for m in range(len(dims)) if m != mode}
        spec = {"id": f"q{i}", "kind": "predict", "model": "nell2",
                "coords": coords.tolist(),
                "top_k": {"mode": mode, "k": SERVE_TOPK,
                          "fixed": {str(m): v for m, v in fixed.items()}}}
        t0 = time.perf_counter()
        serve.file_request(srv.root, spec)
        srv.run_once()
        res = _serve_result(srv, f"q{i}")
        total_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        want = predict.reconstruct_entries(F, L, coords)
        idx, scores = predict.top_k_slice(F, L, fixed, mode, SERVE_TOPK)
        compute_ms.append((time.perf_counter() - t0) * 1e3)
        got = np.asarray(res.get("values"), dtype=np.float64)
        exact = (res["status"] == "served" and res["gen"] == 1
                 and np.array_equal(got, want.astype(np.float64))
                 and res["top_k"]["indices"] == [int(j) for j in idx]
                 and np.array_equal(np.asarray(res["top_k"]["scores"]),
                                    scores.astype(np.float64)))
        ref = np.ones((coords.shape[0], L.shape[0]))
        for m, U in enumerate(F64):
            ref = ref * U[coords[:, m]]
        ref = ref @ L.astype(np.float64)
        rel = float(np.abs(got - ref).max() / np.abs(ref).max())
        worst = max(worst, rel)
        caches.append(res.get("cache"))
        if not exact or not rel <= SERVE_F64_TOL:
            raise AssertionError(f"phase 18, predict q{i}: exact={exact}, "
                                 f"f64 relative error {rel:.3e}")
    out = dict(requests=SERVE_PREDICTS, coords=SERVE_COORDS, k=SERVE_TOPK,
               ms_per_request=sum(total_ms) / len(total_ms),
               ms_first=total_ms[0], compute_ms=sum(compute_ms)
               / len(compute_ms), f64_rel_err=worst,
               cache=dict((c, caches.count(c)) for c in set(caches)))
    log(f"[serve] predicts: {json.dumps(out)}")
    return out


def serve_update(tmp: str, srv) -> dict:
    """A cpd job on phase 6's 2M tensor, then an update with phase 17's
    1% delta: refresh and warm sweeps on fused_mttkrp_t, no demotion, the
    generation advanced, a predict after the commit at the new one."""
    import torch

    from splatt_tpu_torch import BlockedSparse, Options, resilience, serve
    from splatt_tpu_torch.io import load, save
    from splatt_tpu_torch.ops import kernels

    small = synthetic_tensor(NELL2, BIG_RANK_NNZ, seed=5)
    delta = synthetic_tensor(NELL2, int(small.nnz * UPDATE_DELTA),
                             seed=UPDATE_DELTA_SEED)
    small_bin = os.path.join(tmp, "nell2_2m.bin")
    delta_bin = os.path.join(tmp, "delta.bin")
    save(small, small_bin)
    save(delta, delta_bin)
    srv.submit(dict(id="base2m", tensor=small_bin, rank=UPDATE_RANK,
                    iters=UPDATE_ITERS, tol=0.0, seed=7))
    srv.run_once()
    base = _serve_result(srv, "base2m")
    resilience.reset_demotions()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    srv.submit(dict(id="up", kind="update", base="base2m",
                    delta_tensor=delta_bin, iters=UPDATE_SWEEPS))
    srv.run_once()
    up_s = time.perf_counter() - t0
    launches = kernels.fused_mttkrp_t.launches
    up = _serve_result(srv, "up")
    merged = serve._merge_delta(load(small_bin), load(delta_bin))
    bs = BlockedSparse.compile(merged, Options(reorder="identity"),
                               device="cuda", rank=UPDATE_RANK)
    fused = _fused_t_modes(bs, UPDATE_RANK)
    del bs
    serve.file_request(srv.root, {"id": "q_up", "kind": "predict",
                                  "model": "base2m",
                                  "coords": [[1, 2, 3], [4, 5, 6]]})
    srv.run_once()
    q = _serve_result(srv, "q_up")
    expect = len(fused) * (1 + UPDATE_SWEEPS)
    out = dict(base_fit=base["fit"], base_gen=base.get("model_gen"),
               update=up.get("update"), status=up["status"], fit=up["fit"],
               model_gen=up.get("model_gen"), launches=launches,
               expected_launches=expect, demotions=up["demotions"],
               update_s=up_s, parts_s=srv.timings.get("up"),
               predict_gen=q.get("gen"), predict_status=q["status"])
    log(f"[serve] update: {json.dumps(out)}")
    if not (base.get("model_gen") == 1 and up["status"] == "converged"
            and "refit" not in (up.get("update") or {})
            and up.get("model_gen") == 2 and fused
            and launches == expect and not up["demotions"]
            and q["status"] == "served" and q.get("gen") == 2):
        raise AssertionError(f"phase 18, the update: {out}")
    return dict(out, small_bin=small_bin)


def serve_batch(tmp: str) -> dict:
    """SERVE_BATCH_K synthetic jobs of phase 17's regime with batch_min =
    K: one batched CPD, each member's fit within BATCH_SEQ_FIT_TOL of its
    sequential run, and the first job from SERVE_CONTROL_SEED outside it
    (batch members commit no model, so only the fits are compared)."""
    from splatt_tpu_torch import BlockedSparse, cpd_als, serve
    from splatt_tpu_torch.chaos import synthetic_tensor as serve_tensor
    from splatt_tpu_torch.config import Options, Verbosity

    srv = serve.Server(os.path.join(tmp, "batch"), workers=1,
                       batch_min=SERVE_BATCH_K)
    rng = np.random.default_rng(BATCH_SEED)
    specs = []
    for i in range(SERVE_BATCH_K):
        dims = [int(d) for d in rng.integers(BATCH_DIM_LO, BATCH_DIM_HI + 1,
                                             3)]
        nnz = int(rng.integers(BATCH_DRAWS[0], BATCH_DRAWS[1] + 1))
        specs.append(dict(id=f"bt{i}", rank=BATCH_RANK, iters=BATCH_ITERS,
                          tol=0.0, seed=i, tenant=f"t{i}",
                          synthetic=dict(dims=dims, nnz=nnz,
                                         seed=BATCH_SEED + i)))
    for s in specs:
        srv.submit(s)
    t0 = time.perf_counter()
    summary = srv.run_once()
    batch_s = time.perf_counter() - t0
    recs, _ = srv.journal.replay()
    leaders = {r["job"]: r.get("batch") for r in recs
               if r["rec"] == "started"}
    worst, fits, control = 0.0, [], None
    ks = set()
    for s in specs:
        res = _serve_result(srv, s["id"])
        ks.add((res.get("batched") or {}).get("k"))
        syn = s["synthetic"]
        tt = serve_tensor(syn["dims"], syn["nnz"], syn["seed"])
        opts = Options(random_seed=s["seed"], max_iterations=BATCH_ITERS,
                       tolerance=0.0, verbosity=Verbosity.NONE)
        seq = cpd_als(BlockedSparse.from_coo(tt, opts, device="cuda"),
                      BATCH_RANK, opts, device="cuda")
        worst = max(worst, abs(res["fit"] - seq.fit))
        fits.append(res["fit"])
        if s is specs[0]:
            # the control: the first job from another seed
            opts = dataclasses.replace(opts, random_seed=SERVE_CONTROL_SEED)
            ctl = cpd_als(BlockedSparse.from_coo(tt, opts, device="cuda"),
                          BATCH_RANK, opts, device="cuda")
            control = abs(res["fit"] - ctl.fit)
    out = dict(k=SERVE_BATCH_K, batch_s=batch_s, counts=summary["counts"],
               batched_k=sorted(k for k in ks if k is not None),
               leaders=sorted(set(leaders.values()), key=str),
               fits=[min(fits), max(fits)], worst_fit_dev=worst,
               control_fit_dev=control, fit_tol=BATCH_SEQ_FIT_TOL)
    log(f"[serve] batch: {json.dumps(out)}")
    if not (summary["counts"] == {"done": SERVE_BATCH_K}
            and ks == {SERVE_BATCH_K} and set(leaders.values()) == {"bt0"}
            and worst <= BATCH_SEQ_FIT_TOL < control):
        raise AssertionError(f"phase 18, the batch: {out}")
    return out


def serve_isolation(tmp: str, small_bin: str) -> dict:
    """Two jobs on two workers at once, job A with an engine.fused_t fault
    and fallback on: A carries the demotion, B none and B's model is its
    run alone's.  Then a sym_eig cap hit forced in one thread's scope
    raises there only, while a neighbour's CPD finishes clean; and a cap
    hit still queued when its scope ends never reaches the next one."""
    import threading

    import torch

    from splatt_tpu_torch import (BlockedSparse, Options, cpd_als,
                                  resilience, serve, trace)
    from splatt_tpu_torch.config import Verbosity
    from splatt_tpu_torch.io import load
    from splatt_tpu_torch.ops import linalg

    spec_b = dict(rank=UPDATE_RANK, iters=SERVE_ISO_ITERS, tol=0.0, seed=4,
                  tensor=small_bin)
    alone = serve.Server(os.path.join(tmp, "alone"), workers=1)
    alone.submit(dict(spec_b, id="isoB"))
    alone.run_once()
    fit_alone = _serve_result(alone, "isoB")["fit"]
    b_alone = _checkpoint_model(os.path.join(alone.ckpt_dir, "isoB.npz"))
    srv = serve.Server(os.path.join(tmp, "iso"), workers=2)
    srv.submit(dict(spec_b, id="isoA", seed=3,
                    faults="engine.fused_t:runtime", engine_fallback=True))
    srv.submit(dict(spec_b, id="isoB"))
    trace.reset()
    trace.set_enabled(True)
    try:
        summary = srv.run_once()
    finally:
        trace.set_enabled(None)
    a, b = _serve_result(srv, "isoA"), _serve_result(srv, "isoB")
    dispatch = {j: _job_dispatches(j) for j in ("isoA", "isoB")}
    trace.reset()
    tt = load(small_bin)
    opts_b = srv._options(spec_b)
    bs = BlockedSparse.compile(tt, opts_b, device="cuda", rank=UPDATE_RANK)
    control = cpd_als(bs, UPDATE_RANK, srv._options(
        dict(spec_b, seed=SERVE_CONTROL_SEED)), device="cuda")
    gate = serve_model_gate("isolation, job B", tt, _checkpoint_model(
        os.path.join(srv.ckpt_dir, "isoB.npz")), b_alone, control)
    # the cap drill: thread A's forced cap against thread B's CPD
    capped, done, cap = threading.Event(), threading.Event(), {}

    def job_a():
        with resilience.scope("capA"):
            rng = np.random.default_rng(31)
            X = rng.standard_normal((4 * UPDATE_RANK, UPDATE_RANK))
            A = torch.from_numpy(X.T @ X).to("cuda", torch.float32)
            linalg.sym_eig(A, max_sweeps=1)
            torch.cuda.synchronize()
            capped.set()
            done.wait(300)
            try:
                linalg.check_solver()
                cap["a"] = "no raise"
            except linalg.SolverError:
                cap["a"] = "raised"

    def job_b():
        with resilience.scope("capB"):
            capped.wait(300)
            try:
                o = Options(max_iterations=SERVE_ISO_ITERS, tolerance=0.0,
                            random_seed=4, engine_fallback=False,
                            verbosity=Verbosity.NONE)
                cap["b"] = cpd_als(bs, UPDATE_RANK, o, device="cuda").fit
            except Exception as e:
                cap["b"] = repr(e)
            finally:
                done.set()

    threads = [threading.Thread(target=job_a), threading.Thread(target=job_b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    linalg.check_solver()
    del bs
    # a cap hit still queued behind a long kernel when its scope ends (a
    # job that raised before its next sync): the next scope never reads it
    rng = np.random.default_rng(32)
    X = rng.standard_normal((4 * UPDATE_RANK, UPDATE_RANK))
    A = torch.from_numpy(X.T @ X).to("cuda", torch.float32)
    torch.cuda.synchronize()
    with resilience.scope("lateA"):
        word_a = linalg._WORD.get()
        torch.cuda._sleep(200_000_000)
        linalg.sym_eig(A, max_sweeps=1)
    with resilience.scope("lateB"):
        word_b = linalg._WORD.get()
        early = linalg.clear_solver_status()
        torch.cuda.synchronize()
        late = linalg.clear_solver_status()
    cap["queued"] = dict(same_word=word_a == word_b, early=early, late=late)
    out = dict(counts=summary["counts"],
               a_demotions=[d["engine"] for d in a["demotions"]],
               b_demotions=b["demotions"], a_fit=a["fit"], b_fit=b["fit"],
               b_fit_alone=fit_alone,
               b_fit_dev=abs(b["fit"] - fit_alone), b_model=gate,
               dispatch=dispatch,
               a_faults=a.get("faults_fired"), cap=cap)
    log(f"[serve] isolation: {json.dumps(out)}")
    if not (summary["counts"] == {"done": 2}
            and a["status"] == b["status"] == "converged"
            and "fused_t" in out["a_demotions"] and not b["demotions"]
            and dispatch["isoA"].get("fused_tg", 0) > 0
            and dispatch["isoB"].get("fused_t", 0) > 0
            and "fused_tg" not in dispatch["isoB"]
            and cap.get("a") == "raised"
            and isinstance(cap.get("b"), float)
            and not any(cap["queued"].values())):
        raise AssertionError(f"phase 18, isolation: {out}")
    return out


def serve_crash_resume(tmp: str, small_bin: str) -> dict:
    """The cli's serve --once killed with SIGKILL once the job's first
    checkpoint lands, then run again: the job resumes and ends done, its
    model that of an uninterrupted run; then the predict verb with
    --wait answered by a daemon on the same spool."""
    import signal

    from splatt_tpu_torch import serve
    from splatt_tpu_torch.io import load

    root = os.path.dirname(os.path.abspath(__file__))
    spool = os.path.join(tmp, "crash")
    spec = dict(id="crash", tensor=small_bin, rank=UPDATE_RANK,
                iters=SERVE_CRASH_ITERS, tol=0.0, seed=11,
                checkpoint_every=SERVE_CRASH_EVERY)
    serve.file_request(spool, spec)
    env = dict(os.environ, PYTHONPATH=root)
    cmd = [sys.executable, "-m", "splatt_tpu_torch.cli", "serve", spool,
           "--once"]
    ckpt = os.path.join(spool, "ckpt", "crash.npz")
    t0 = time.perf_counter()
    first = subprocess.Popen(cmd, cwd=root, env=env,
                             stdout=subprocess.DEVNULL,
                             stderr=subprocess.PIPE)
    try:
        while not os.path.exists(ckpt) and first.poll() is None \
                and time.perf_counter() - t0 < 300:
            time.sleep(0.002)
        killed_at = time.perf_counter() - t0
        alive = first.poll() is None
        if alive:
            os.kill(first.pid, signal.SIGKILL)
    finally:
        if first.poll() is None:
            first.kill()
        _, err = first.communicate(timeout=60)
    if not alive or not os.path.exists(ckpt):
        raise AssertionError(f"phase 18, crash: the first daemon ended "
                             f"(rc {first.returncode}) before its job's "
                             f"first checkpoint was killed: "
                             f"{err.decode()[-400:]}")
    kinds_killed = [r["rec"] for r in serve.Journal(os.path.join(
        spool, "journal.jsonl")).replay()[0] if r.get("job") == "crash"]
    t0 = time.perf_counter()
    second = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                            text=True, timeout=600)
    resume_s = time.perf_counter() - t0
    kinds = [r["rec"] for r in serve.Journal(os.path.join(
        spool, "journal.jsonl")).replay()[0] if r.get("job") == "crash"]
    res = serve.read_result(spool, "crash") or {}
    srv = serve.Server(spool, workers=1)
    # the predict verb, answered by a daemon on the spool; its process
    # starts up while the reference runs
    pred = subprocess.Popen(
        [sys.executable, "-m", "splatt_tpu_torch.cli", "predict", spool,
         "--model", "crash", "--id", "pq", "--coords", "0,1,2",
         "--coords", "5,6,7", "--wait", "120"], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        tt = load(small_bin)
        ref = serve_reference(srv, spec, tt=tt, rank=UPDATE_RANK)
        direct, control = ref["direct"], ref["control"]
        req = os.path.join(spool, "requests", "pq.json")
        t1 = time.perf_counter()
        while not os.path.exists(req) and pred.poll() is None \
                and time.perf_counter() - t1 < 120:
            time.sleep(0.01)
        srv.run_once()
        pout, perr = pred.communicate(timeout=180)
    finally:
        if pred.poll() is None:
            pred.kill()
            pred.communicate()
    gate = serve_model_gate("crash and resume", tt, _checkpoint_model(
        os.path.join(spool, "ckpt", "crash.npz")), direct, control)
    answer = json.loads(pout.strip().splitlines()[-1]) if pout.strip() \
        else {}
    out = dict(killed_after_s=killed_at, journal_at_kill=kinds_killed,
               journal=kinds, second_rc=second.returncode,
               resume_s=resume_s, status=res.get("status"),
               resumed=res.get("resumed"), fit=res.get("fit"),
               uninterrupted_fit=direct.fit,
               fit_dev=abs((res.get("fit") or 0.0) - direct.fit), model=gate,
               predict_rc=pred.returncode,
               predict_status=answer.get("status"),
               predict_gen=answer.get("gen"))
    log(f"[serve] crash and resume: {json.dumps(out)}")
    if not (second.returncode == 0 and "resumed" in kinds
            and kinds[-1] == "done" and "done" not in kinds_killed
            and res.get("status") == "converged" and res.get("resumed")
            and pred.returncode == 0
            and answer.get("status") == "served"):
        raise AssertionError(f"phase 18, crash and resume: {out}; "
                             f"{second.stderr[-400:]} {perr[-400:]}")
    return out


def phase_serve(tt, bin_path=None, main_ms=None) -> dict:
    """Phase 18: the serve daemon on the card, single replica, engine
    fallback off unless a job's spec turns it on; every check fatal."""
    import shutil
    import tempfile

    import torch

    from splatt_tpu_torch.io import save

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_", dir=root)
    saved = os.environ.get("SPLATT_ENGINE_FALLBACK")
    os.environ["SPLATT_ENGINE_FALLBACK"] = "0"
    try:
        save_s = None
        if bin_path is None or not os.path.exists(bin_path):
            bin_path = os.path.join(tmp, "nell2.bin")
            t0 = time.perf_counter()
            save(tt, bin_path)
            save_s = time.perf_counter() - t0
        full = serve_full_width(tmp, tt, bin_path, main_ms)
        srv = full.pop("srv")
        ref = full.pop("ref")
        pred = serve_predicts(srv)
        upd = serve_update(tmp, srv)
        del srv
        torch.cuda.empty_cache()
        bat = serve_batch(tmp)
        iso = serve_isolation(tmp, upd["small_bin"])
        crash = serve_crash_resume(tmp, upd.pop("small_bin"))
        gates = {"full-width job": full["model"],
                 "isolation, job B": iso["b_model"],
                 "crash and resume": crash["model"]}
        missed = {k: g for k, g in gates.items() if not g["ok"]}
        if missed:
            raise AssertionError(f"phase 18, the served models: {missed}")
    finally:
        if saved is None:
            os.environ.pop("SPLATT_ENGINE_FALLBACK", None)
        else:
            os.environ["SPLATT_ENGINE_FALLBACK"] = saved
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    log(f"[serve] phase 18 took {seconds:.1f} s")
    return dict(full=full, predict=pred, update=upd, batch=bat,
                isolation=iso, crash=crash, save_bin_s=save_s,
                seconds=seconds, ref=ref)


def _serve_summary(sv: dict) -> dict:
    """Phase 18's figures for the kernels line (row 1)."""
    f = sv["full"]
    return dict(launches=f["launches"], update_launches=sv["update"][
        "launches"], ms_per_iter=f["ms_per_iter"], parts_s=f["parts_s"],
        journal_append_ms=f["journal_append_ms"],
        predict_ms=sv["predict"]["ms_per_request"],
        predict_compute_ms=sv["predict"]["compute_ms"],
        seconds=sv["seconds"])


# -- phase 19: fleet mode on the card ------------------------------------------

#: phase 19: `serve --fleet` replica processes sharing the card.  The lease
#: (shorter than the default 10 s, which costs each drill 4 s more of
#: waiting), the heartbeat its default third; the phase prints the
#: largest heartbeat gap of every healthy replica beside it
FLEET_LEASE_S = 6.0
#: the full-width failover job: phase 18's spec, a checkpoint at every
#: iteration (the claimant is killed once the first lands)
FLEET_CKPT_EVERY = 1
#: the zombie drill: phase 18's crash job on phase 6's 2M tensor (rank 16,
#: SERVE_CRASH_ITERS iterations, a checkpoint every SERVE_CRASH_EVERY), its
#: owner stopped once the first checkpoint lands
FLEET_WAIT_S = 300.0


def _fleet_env() -> dict:
    """The replicas' environment: this checkout on the path, engine
    fallback off, a flight ring flushed at every record, the default
    lease, a metrics snapshot every second."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root, SPLATT_ENGINE_FALLBACK="0",
               SPLATT_FLIGHT_FLUSH="1", SPLATT_METRICS_INTERVAL_S="1.0",
               SPLATT_SERVE_POLL_S="0.25",
               SPLATT_FLEET_LEASE_S=str(FLEET_LEASE_S))
    for name in ("SPLATT_FAULTS", "SPLATT_FLEET_HEARTBEAT_S",
                 "SPLATT_FLEET_REPLICA", "SPLATT_METRICS_PATH",
                 "SPLATT_TRACE", "SPLATT_FLIGHT"):
        env.pop(name, None)
    return env


class _Fleet:
    """The replica processes of one spool, their logs, and a thread that
    reads their heartbeat files every 50 ms (each replica's distinct
    heartbeat times, in order)."""

    def __init__(self, tmp: str):
        import threading

        self.tmp = tmp
        self.spool = os.path.join(tmp, "spool")
        self.procs = {}
        self.logs = {}
        self.beats = {}
        self.env = _fleet_env()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()

    def _watch(self) -> None:
        hb = os.path.join(self.spool, "fleet", "replicas")
        while not self._stop.wait(0.05):
            try:
                names = os.listdir(hb)
            except OSError:
                continue
            for name in names:
                try:
                    with open(os.path.join(hb, name)) as f:
                        rec = json.load(f)
                except (OSError, ValueError):
                    continue
                ts = self.beats.setdefault(rec["replica"], [])
                if not ts or rec["ts"] != ts[-1]:
                    ts.append(rec["ts"])

    def spawn(self, rid: str) -> None:
        root = os.path.dirname(os.path.abspath(__file__))
        self.logs[rid] = os.path.join(self.tmp, f"{rid}.log")
        with open(self.logs[rid], "w") as log_f:
            self.procs[rid] = subprocess.Popen(
                [sys.executable, "-m", "splatt_tpu_torch.cli", "serve",
                 self.spool, "--fleet", "--replica", rid, "--workers", "1"],
                cwd=root, env=self.env, stdout=log_f,
                stderr=subprocess.STDOUT)

    def log_tail(self, rid: str, n: int = 1500) -> str:
        try:
            with open(self.logs[rid]) as f:
                return f.read()[-n:]
        except OSError:
            return ""

    def kernel_load(self, rid: str) -> dict:
        """The replica's ``kernels loaded in X s (nvcc Y s)`` line."""
        m = re.search(r"kernels loaded in ([\d.]+) s \(nvcc ([\d.]+) s\)",
                      self.log_tail(rid, 1 << 20))
        return (dict(load_s=float(m.group(1)), nvcc_s=float(m.group(2)))
                if m else {})

    def journal(self) -> list:
        from splatt_tpu_torch import serve

        return serve.Journal(os.path.join(self.spool,
                                          "journal.jsonl")).replay()[0]

    def record(self, kind: str, jid: str):
        """The journal's last `kind` record of job `jid`, or None."""
        recs = [r for r in self.journal()
                if r.get("rec") == kind and r.get("job") == jid]
        return recs[-1] if recs else None

    def wait(self, pred, what: str, timeout: float = FLEET_WAIT_S,
             poll: float = 0.05):
        end = time.time() + timeout
        while time.time() < end:
            got = pred()
            if got:
                return got
            time.sleep(poll)
        tails = "; ".join(f"{rid}: {self.log_tail(rid, 600)!r}"
                          for rid in self.procs)
        raise AssertionError(f"phase 19: timed out waiting for {what}; "
                             f"replica logs: {tails}")

    def ring(self, rid: str) -> list:
        from splatt_tpu_torch import trace

        return trace.load_flight(os.path.join(self.spool, "fleet", "flight",
                                              f"{rid}.jsonl"))

    def stop_all(self) -> dict:
        """SIGTERM every live replica (a drain: the final snapshot, the
        retirement, the ring flushed) and wait; returns exit codes."""
        import signal

        for p in self.procs.values():
            if p.poll() is None:
                os.kill(p.pid, signal.SIGCONT)
                p.send_signal(signal.SIGTERM)
        rcs = {}
        for rid, p in self.procs.items():
            try:
                rcs[rid] = p.wait(timeout=120)
            except subprocess.TimeoutExpired:
                p.kill()
                rcs[rid] = p.wait(timeout=60)
        return rcs

    def close(self) -> None:
        import signal

        self._stop.set()
        self._thread.join(timeout=5)
        for p in self.procs.values():
            if p.poll() is None:
                os.kill(p.pid, signal.SIGCONT)
                p.kill()
                p.wait(timeout=60)


def _beat_gaps(ts: list, skip=()) -> float:
    """The largest gap between consecutive heartbeat times, leaving out
    the gaps that overlap a window of `skip` ((t0, t1) pairs)."""
    gaps = [b - a for a, b in zip(ts, ts[1:])
            if not any(a < t1 and b > t0 for t0, t1 in skip)]
    return max(gaps) if gaps else 0.0


def _ring_job(events: list, jid: str) -> dict:
    """One job's evidence in a flight ring: its serve.job span (launches),
    its mttkrp.dispatch spans by engine, its iterations' ms, and the
    seconds from the job's start to the ALS loop (load and compile)."""
    mine = [e for e in events if (e.get("args") or {}).get("job") == jid]
    job = [e for e in mine if e["name"] == "serve.job" and e["ph"] == "X"]
    als = [e for e in mine if e["name"] == "cpd.als" and e["ph"] == "X"]
    its = sorted((e for e in mine if e["name"] == "cpd.iter"
                  and e["ph"] == "X"), key=lambda e: e["ts"])
    disp: dict = {}
    for e in mine:
        if e["name"] == "mttkrp.dispatch" and e["ph"] == "X":
            eng = e["args"].get("engine")
            disp[eng] = disp.get(eng, 0) + 1
    out = dict(dispatch=disp, iterations=len(its),
               iter_ms=[e["dur"] / 1e3 for e in its],
               points=sorted({e["name"] for e in mine if e["ph"] == "i"}))
    if job:
        out["launches"] = job[-1]["args"].get("launches") or {}
        out["job_s"] = job[-1]["dur"] / 1e6
        if als:
            out["load_compile_s"] = (als[-1]["ts"] - job[-1]["ts"]) / 1e6
    return out


def fleet_failover(fl: "_Fleet", tt, bin_path: str, ref: dict) -> dict:
    """19 (a) and (c): the full-width job on a two-replica fleet, its
    claimant SIGKILLed once the first checkpoint lands; the survivor
    adopts it and commits; the committed model against phase 18's
    reference.  Starts the third replica, for (b), during the lease."""
    import signal

    from splatt_tpu_torch import serve
    from splatt_tpu_torch.cpd import load_checkpoint

    t0 = time.time()
    for rid in ("r0", "r1"):
        fl.spawn(rid)
    hb = os.path.join(fl.spool, "fleet", "replicas")
    fl.wait(lambda: all(os.path.exists(os.path.join(hb, f"{r}.json"))
                        for r in ("r0", "r1")), "two replicas' heartbeats")
    startup_s = time.time() - t0
    builds = {rid: fl.kernel_load(rid) for rid in ("r0", "r1")}
    log(f"[fleet] two replicas up in {startup_s:.1f} s; kernels "
        f"{json.dumps(builds)}; lease {FLEET_LEASE_S:g} s")
    spec = dict(id="fw", tensor=bin_path, rank=RANK, iters=ITERS, tol=0.0,
                seed=0, checkpoint_every=FLEET_CKPT_EVERY)
    t_file = time.time()
    serve.file_request(fl.spool, spec)
    started = fl.wait(lambda: fl.record("started", "fw"),
                      "the full-width job to start")
    victim = started["replica"]
    ckpt = os.path.join(fl.spool, "ckpt", "fw.npz")
    fl.wait(lambda: os.path.exists(ckpt), "the first checkpoint",
            poll=0.002)
    os.kill(fl.procs[victim].pid, signal.SIGKILL)
    t_kill = time.time()
    fl.procs[victim].wait(timeout=60)
    k = int(load_checkpoint(ckpt)[2])
    log(f"[fleet] {victim} claimed fw and was SIGKILLed "
        f"{t_kill - t_file:.2f} s after the filing, at its checkpoint of "
        f"iteration {k}")
    fl.spawn("r2")
    done = fl.wait(lambda: fl.record("done", "fw"),
                   "the adopter to commit fw")
    adopted = fl.record("adopted", "fw")
    adopter = done["replica"]
    res = serve.read_result(fl.spool, "fw") or {}
    gate = serve_model_gate("fleet failover", tt, _checkpoint_model(ckpt),
                            ref["direct"], ref["control"])
    out = dict(victim=victim, adopter=adopter, killed_at_iteration=k,
               kill_after_filing_s=t_kill - t_file,
               kill_to_adoption_s=(adopted["ts"] - t_kill
                                   if adopted else None),
               adoption_to_commit_s=(done["ts"] - adopted["ts"]
                                     if adopted else None),
               adopted_from=(adopted or {}).get("from_replica"),
               status=res.get("status"), result_replica=res.get("replica"),
               result_adopted_from=res.get("adopted_from"),
               demotions=res.get("demotions"), model_gen=res.get("model_gen"),
               model=gate, startup_s=startup_s, kernel_builds=builds,
               t_kill=t_kill, t_adopted=(adopted or {}).get("ts"),
               t_done=done["ts"], fused_t_modes=ref["fused"])
    log(f"[fleet] failover: {json.dumps(out)}")
    if not (adopted and adopted["from_replica"] == victim
            and adopter != victim and res.get("status") == "converged"
            and res.get("replica") == adopter
            and res.get("adopted_from") == victim
            and not res.get("demotions") and res.get("model_gen") == 1
            and gate["ok"]):
        raise AssertionError(f"phase 19, the failover: {out}")
    return out


def fleet_zombie(fl: "_Fleet", small_bin: str, small_tt) -> dict:
    """19 (b): the 2M crash job; its owner SIGSTOPped once its first
    checkpoint lands and SIGCONTed once a peer has adopted the job: the
    owner journals nothing terminal, writes no result, and the committed
    model is the adopter's (its stamp verifies, it meets phase 18's gates
    against a direct run)."""
    import signal

    from splatt_tpu_torch import chaos, predict, serve

    spec = dict(id="zb", tensor=small_bin, rank=UPDATE_RANK,
                iters=SERVE_CRASH_ITERS, tol=0.0, seed=11,
                checkpoint_every=SERVE_CRASH_EVERY)
    serve.file_request(fl.spool, spec)
    started = fl.wait(lambda: fl.record("started", "zb"),
                      "the zombie drill's job to start")
    owner = started["replica"]
    ckpt = os.path.join(fl.spool, "ckpt", "zb.npz")
    fl.wait(lambda: os.path.exists(ckpt), "the drill's first checkpoint",
            poll=0.002)
    os.kill(fl.procs[owner].pid, signal.SIGSTOP)
    t_stop = time.time()
    adopted = fl.wait(lambda: fl.record("adopted", "zb"),
                      "a peer to adopt the stopped owner's job",
                      timeout=FLEET_LEASE_S * 3 + 120)
    os.kill(fl.procs[owner].pid, signal.SIGCONT)
    t_cont = time.time()
    # the direct run and its control, while the adopter runs the job
    ref = serve_reference(serve.Server(os.path.join(fl.tmp, "zb_ref"),
                                       workers=1), spec, tt=small_tt,
                          rank=UPDATE_RANK)
    direct, control = ref["direct"], ref["control"]
    done = fl.wait(lambda: fl.record("done", "zb"),
                   "the adopter to commit the drill's job")

    def owner_fenced():
        evs = [e for e in fl.ring(owner) if e["name"] == "lease_expired"
               and (e.get("args") or {}).get("job") == "zb"
               and (e.get("args") or {}).get("role") == "owner"]
        return evs[-1] if evs else None

    fenced = fl.wait(owner_fenced, "the woken owner's lease_expired",
                     timeout=60)
    recs = [r for r in fl.journal() if r.get("job") == "zb"]
    res = serve.read_result(fl.spool, "zb") or {}
    ckpt_dir = os.path.join(fl.spool, "ckpt")
    model = predict.load_model_generation(ckpt_dir, "zb")
    gate = serve_model_gate("zombie fence", small_tt,
                            _checkpoint_model(os.path.join(ckpt_dir,
                                                           "zb.npz")),
                            direct, control)
    lineage = chaos._fleet_lineage_violations(fl.journal())
    owner_terminal = [r["rec"] for r in recs if r.get("replica") == owner
                      and r["rec"] in serve.TERMINAL]
    out = dict(owner=owner, adopter=adopted["replica"],
               stopped_s=t_cont - t_stop,
               stop_to_adoption_s=adopted["ts"] - t_stop,
               fenced_after_cont_s=(fenced["ts"] / 1e6 - t_cont),
               journal=[(r["rec"], r.get("replica")) for r in recs],
               owner_terminal=owner_terminal, lineage=lineage,
               result_replica=res.get("replica"), status=res.get("status"),
               model_gen=(model or {}).get("gen"),
               stamp_verifies=model is not None, model=gate,
               t_stop=t_stop, t_cont=t_cont)
    log(f"[fleet] zombie fence: {json.dumps(out)}")
    if not (adopted["from_replica"] == owner and adopted["replica"] != owner
            and not owner_terminal and not lineage
            and done["replica"] == adopted["replica"]
            and res.get("replica") == adopted["replica"]
            and res.get("status") == "converged" and model is not None
            and gate["ok"]):
        raise AssertionError(f"phase 19, the zombie fence: {out}")
    return out


def fleet_observability(fl: "_Fleet", fo: dict, zb: dict) -> dict:
    """19 (c) and (d), once every replica has drained: the heartbeat gaps
    against the lease, no lease lost by a healthy replica, the adopter's
    launches from its flight ring, status against the journal, the merged
    aggregate, the victim's black box, the trace verb over the rings."""
    import contextlib
    import io

    from splatt_tpu_torch import cli, fleetobs, trace

    victim, adopter, owner = fo["victim"], fo["adopter"], zb["owner"]
    gaps = {}
    for rid, ts in sorted(fl.beats.items()):
        skip = [(zb["t_stop"], zb["t_cont"])] if rid == owner else []
        gaps[rid] = _beat_gaps(ts, skip)
    job_gap = _beat_gaps([t for t in fl.beats.get(adopter, [])
                          if fo["t_adopted"] - 5 <= t <= fo["t_done"] + 5])
    healthy = {rid: g for rid, g in gaps.items() if rid != victim}
    owner_losses = {}
    for rid in fl.procs:
        if rid == victim:
            continue
        evs = fl.ring(rid)
        owner_losses[rid] = sorted(
            (e.get("args") or {}).get("job") for e in evs
            if e["name"] == "lease_expired"
            and (e.get("args") or {}).get("role") == "owner")
    unexpected = {rid: jobs for rid, jobs in owner_losses.items()
                  if jobs and not (rid == owner and jobs == ["zb"])}
    # the adopter's job from its own ring
    ev = _ring_job(fl.ring(adopter), "fw")
    its = ITERS - fo["killed_at_iteration"]
    want_t = len(fo["fused_t_modes"]) * its
    launches = ev.get("launches", {})
    # status, in process through the verb, against the journal
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["status", fl.spool, "--json"])
    st = json.loads(buf.getvalue().strip().splitlines()[-1])
    last = {}
    for r in fl.journal():
        if r.get("job") and r.get("rec"):
            last[r["job"]] = r["rec"]
    disagree = {j: (st["jobs"].get(j), s) for j, s in last.items()
                if st["jobs"].get(j) != s}
    agg = fleetobs.aggregate(fl.spool)
    counts = dict(adoptions=agg.counter("splatt_fleet_adoptions_total"),
                  lease_expired=agg.counter(
                      "splatt_fleet_lease_expired_total"),
                  dead=agg.samples.get(("splatt_fleet_replicas",
                                        (("state", "dead"),)), 0.0))
    box = fl.ring(victim)
    box_started = [e for e in box if e["name"] == "job_started"
                   and (e.get("args") or {}).get("job") == "fw"]
    box_last_s = max(e["ts"] + e.get("dur", 0) for e in box) / 1e6
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        trc = cli.main(["trace", fl.spool, "--json"])
    summ = json.loads(buf.getvalue().strip().splitlines()[-1])
    rows = sorted(e["args"]["name"] for e in trace.merge_trace_files(
        trace.expand_trace_paths([fl.spool])) if e.get("ph") == "M")
    out = dict(lease_s=FLEET_LEASE_S, heartbeat_gap_max_s=gaps,
               adopter_job_gap_s=job_gap, owner_lease_losses=owner_losses,
               adopter=dict(ev, expected_fused_t=want_t,
                            expected_sym_eig=3 * its,
                            steady_iter_ms=(sum(ev["iter_ms"][1:])
                                            / max(len(ev["iter_ms"]) - 1,
                                                  1))),
               status_rc=rc, status_disagrees=disagree,
               status_counts=st["counts"], aggregate=counts,
               victim_box=dict(events=len(box),
                               job_started=len(box_started),
                               last_event_before_kill_s=(fo["t_kill"]
                                                         - box_last_s)),
               trace_rc=trc, trace_fleet=summ.get("fleet"),
               trace_rows=rows)
    log(f"[fleet] observability: {json.dumps(out)}")
    checks = {
        "healthy heartbeat gaps inside the lease":
            bool(healthy) and max(healthy.values()) < FLEET_LEASE_S,
        "no healthy replica lost a lease": not unexpected,
        "the adopter's fused_mttkrp_t launches":
            launches.get("fused_mttkrp_t") == want_t
            and ev["dispatch"].get("fused_t") == want_t,
        "the adopter's sym_eig launches": launches.get("sym_eig") == 3 * its,
        "status agrees with the journal": rc == 0 and not disagree,
        "the aggregate counts the adoptions and expiries":
            counts["adoptions"] >= 2 and counts["lease_expired"] >= 2
            and counts["dead"] >= 1,
        "the victim's black box": bool(box_started)
            and box_last_s <= fo["t_kill"] + 1e-3,
        "the trace verb merges the rings": trc == 0
            and (summ.get("fleet") or {}).get("adoptions", 0) >= 2
            and f"replica {victim}" in rows,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 19, observability: {failed}: {out}")
    return out


def start_chaos_smoke():
    """19 (e): ``chaos --fleet --smoke`` on the card, in a process of its
    own over a spool of its own; it runs beside (b)-(d), which time
    nothing it could slow but the drill's waits."""
    root = os.path.dirname(os.path.abspath(__file__))
    return time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", "splatt_tpu_torch.cli", "chaos", "--fleet",
         "--smoke", "--device", "cuda"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=root, env=_fleet_env())


def finish_chaos_smoke(run) -> dict:
    """Wait for the soak (bounded): exit 0, its report lines printed."""
    t0, p = run
    try:
        out, err = p.communicate(timeout=600)
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    seconds = time.perf_counter() - t0
    for line in out.splitlines():
        log(f"[fleet] chaos | {line}")
    if p.returncode != 0:
        raise AssertionError(f"phase 19, chaos --fleet --smoke exited "
                             f"{p.returncode}: {err[-2000:]}")
    return dict(rc=p.returncode, seconds=seconds,
                verdict=out.strip().splitlines()[-1])


def phase_fleet(tt, bin_path=None, ref=None) -> dict:
    """Phase 19: fleet mode on the card, replicas as processes sharing it,
    engine fallback off; every check fatal."""
    import shutil
    import tempfile

    import torch

    from splatt_tpu_torch import serve
    from splatt_tpu_torch.io import save

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fleet_", dir=root)
    fl = _Fleet(tmp)
    soak = None
    try:
        if bin_path is None or not os.path.exists(bin_path):
            bin_path = os.path.join(tmp, "nell2.bin")
            save(tt, bin_path)
        if ref is None:
            # phase 18's full-width reference, for --fleet alone
            ref = serve_reference(
                serve.Server(os.path.join(tmp, "ref_spool"), workers=1),
                dict(id="ref", tensor=bin_path, rank=RANK, iters=ITERS,
                     tol=0.0, seed=0), tt=tt)
        small_tt = synthetic_tensor(NELL2, BIG_RANK_NNZ, seed=5)
        small_bin = os.path.join(tmp, "nell2_2m.bin")
        save(small_tt, small_bin)
        fo = fleet_failover(fl, tt, bin_path, ref)
        soak = start_chaos_smoke()
        zb = fleet_zombie(fl, small_bin, small_tt)
        rcs = fl.stop_all()
        log(f"[fleet] replicas drained: exit codes {json.dumps(rcs)}")
        obs = fleet_observability(fl, fo, zb)
        smoke, soak = finish_chaos_smoke(soak), None
    finally:
        if soak is not None and soak[1].poll() is None:
            soak[1].kill()
            soak[1].communicate()
        fl.close()
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    log(f"[fleet] phase 19 took {seconds:.1f} s")
    return dict(failover=fo, zombie=zb, observability=obs, chaos=smoke,
                seconds=seconds)


def _fleet_summary(fl: dict) -> dict:
    """Phase 19's figures for the kernels line (rows 1 and sym_eig)."""
    fo, ob = fl["failover"], fl["observability"]
    ad = ob["adopter"]
    return dict(adopter_launches=ad.get("launches"),
                adopter_dispatch=ad["dispatch"],
                killed_at_iteration=fo["killed_at_iteration"],
                kill_to_adoption_s=fo["kill_to_adoption_s"],
                adoption_to_commit_s=fo["adoption_to_commit_s"],
                adopter_load_compile_s=ad.get("load_compile_s"),
                adopter_iter_ms=ad["iter_ms"],
                kernel_builds=fo["kernel_builds"],
                heartbeat_gap_max_s=ob["heartbeat_gap_max_s"],
                lease_s=ob["lease_s"], zombie=dict(
                    stop_to_adoption_s=fl["zombie"]["stop_to_adoption_s"],
                    fenced_after_cont_s=fl["zombie"]["fenced_after_cont_s"]),
                chaos_s=fl["chaos"]["seconds"], seconds=fl["seconds"])


# -- phase 20: streaming ingest and the other soaks on the card ---------------

#: phase 20 (a): the live feed's chunk size and update interval, and a
#: malformed line written before every INGEST_BAD_EVERY-th line of the
#: stream; the feed is phase 17's 1% delta of phase 6's 2M tensor
INGEST_CHUNK = 5000
INGEST_UPDATE_EVERY = 2
INGEST_BAD_EVERY = 97
#: phase 20 (b)-(d): the soaks' bounded wait
SOAK_WAIT_S = 600.0
#: (b)-(d): name -> the chaos verb's flags
SOAKS = {"chaos": ["--device", "cuda"],
         "chaos --serve": ["--serve", "--device", "cuda"],
         "chaos --ingest": ["--ingest"]}


def start_soaks() -> dict:
    """20 (b)-(d): ``chaos --smoke`` and ``chaos --serve --smoke`` on the
    card and ``chaos --ingest --smoke`` on its host, each a process of its
    own beside (a), each waited for (bounded) by a thread of its own, so
    that its seconds are its own.  They run with the default engine
    fallback: the plain soak's fused_t fault must demote to fused_tg."""
    import threading

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    for name in ("SPLATT_ENGINE_FALLBACK", "SPLATT_FAULTS", "SPLATT_TRACE",
                 "SPLATT_CHAOS_SCHEDULE"):
        env.pop(name, None)

    def wait(run: dict) -> None:
        try:
            run["out"], run["err"] = run["p"].communicate(timeout=SOAK_WAIT_S)
        except subprocess.TimeoutExpired:
            run["p"].kill()
            run["out"], run["err"] = run["p"].communicate()
        run["seconds"] = time.perf_counter() - run["t0"]

    runs = {}
    for name, flags in SOAKS.items():
        run = dict(t0=time.perf_counter(), p=subprocess.Popen(
            [sys.executable, "-m", "splatt_tpu_torch.cli", "chaos",
             "--smoke", "--json"] + flags, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, cwd=root, env=env))
        run["thread"] = threading.Thread(target=wait, args=(run,),
                                         daemon=True)
        run["thread"].start()
        runs[name] = run
    return runs


def stop_soaks(runs: dict) -> None:
    for run in runs.values():
        if run["p"].poll() is None:
            run["p"].kill()
        run["thread"].join(timeout=30)


def finish_soaks(runs: dict) -> dict:
    """Wait for each soak: exit 0, its report lines and result printed.
    The plain soak on the card must have fired every armed site, demoted
    fused_t to another kernel engine and seen the comm drill raise the
    injected failure (chaos.run_chaos checks each; a violation exits 1)."""
    out = {}
    for name, run in runs.items():
        run["thread"].join(timeout=SOAK_WAIT_S + 30)
        p = run["p"]
        lines = (run.get("out") or "").strip().splitlines()
        for line in lines[:-1]:
            log(f"[ingest] {name} | {line}")
        if p.returncode != 0 or not lines:
            raise AssertionError(f"phase 20, {name} --smoke exited "
                                 f"{p.returncode}: {lines[-20:]} "
                                 f"{(run.get('err') or '')[-1500:]}")
        res = json.loads(lines[-1])
        res.pop("events", None)
        out[name] = dict(rc=p.returncode, seconds=run["seconds"], result=res)
        log(f"[ingest] {name} --smoke: exit 0 in {run['seconds']:.1f} s; "
            f"{json.dumps(res)}")
    plain = out["chaos"]["result"]
    if not (plain.get("drill") or {}).get("raised") \
            or plain.get("device", "").split(":")[0] != "cuda":
        raise AssertionError(f"phase 20, chaos --smoke on the card: {plain}")
    return out


def write_feed(path: str, delta) -> tuple:
    """The live feed: `delta`'s records as .tns text (0-based indices, the
    values as exact decimals), a malformed line before every
    INGEST_BAD_EVERY-th line; returns (good, bad) records written."""
    good = bad = 0
    with open(path, "w") as f:
        f.write("# phase 20 live feed\n")
        for i in range(delta.nnz):
            if (good + bad) % INGEST_BAD_EVERY == INGEST_BAD_EVERY - 1:
                f.write("malformed\n")
                bad += 1
            f.write(" ".join(str(int(delta.inds[m, i]))
                             for m in range(delta.nmodes))
                    + f" {float(delta.vals[i])!r}\n")
            good += 1
    return good, bad


def ingest_reference(tmp: str, small_bin: str, dest: str, dims) -> dict:
    """The feed's chain of deltas applied in-process: the ingest's
    journaled chunk ranges re-assembled from its segments
    (``ingest.assemble_delta``), submitted as ``kind: update`` jobs against
    a base from the feed's seed (the reference) and from SERVE_CONTROL_SEED
    (the control), on a Server of their own."""
    from splatt_tpu_torch import ingest, serve

    srv = serve.Server(os.path.join(tmp, "ref_spool"), workers=1,
                       device="cuda")
    for jid, seed in (("ref", 7), ("ctl", SERVE_CONTROL_SEED)):
        srv.submit(dict(id=jid, tensor=small_bin, rank=UPDATE_RANK,
                        iters=UPDATE_ITERS, tol=0.0, seed=seed))
    srv.run_once()
    intents, _ = serve.Journal(os.path.join(
        dest, "deltas", "updates.jsonl")).replay()
    spans = [(int(r["lo"]), int(r["hi"])) for r in intents
             if r.get("rec") == "update_intent"]
    for lo, hi in spans:
        dpath = os.path.join(tmp, f"ref-{lo}-{hi}.bin")
        ingest.assemble_delta(dest, lo, hi, tuple(dims), dpath)
        for base in ("ref", "ctl"):
            srv.submit(dict(id=f"{base}-{lo}-{hi}", kind="update",
                            base=base, delta_tensor=dpath,
                            iters=UPDATE_SWEEPS))
        srv.run_once()
    bad = {j: s for j, s in srv.summary()["jobs"].items() if s != "done"}
    if bad:
        raise AssertionError(f"phase 20, the reference chain: {bad}")
    return dict(spans=spans,
                ref=_checkpoint_model(os.path.join(srv.ckpt_dir, "ref.npz")),
                control=_checkpoint_model(os.path.join(srv.ckpt_dir,
                                                       "ctl.npz")))


def ingest_feed(tmp: str) -> dict:
    """20 (a): an ``ingest`` job on an in-process daemon on the card (one
    worker, engine fallback off) feeding the cpd job of phase 6's 2M
    tensor, as phase 18's update builds it: exactly-once accounting
    against the generator, each chained update's fused_mttkrp_t launches
    = its sorted modes x (1 refresh + its sweeps) with no demotion, one
    generation per update, and the final model held to the same chain of
    deltas applied in-process beside a control that misses."""
    import torch

    from splatt_tpu_torch import ingest, resilience, serve, trace
    from splatt_tpu_torch.io import save

    small = synthetic_tensor(NELL2, BIG_RANK_NNZ, seed=5)
    delta = synthetic_tensor(NELL2, int(small.nnz * UPDATE_DELTA),
                             seed=UPDATE_DELTA_SEED)
    small_bin = os.path.join(tmp, "nell2_2m.bin")
    save(small, small_bin)
    src = os.path.join(tmp, "feed.tns")
    good, bad = write_feed(src, delta)
    srv = serve.Server(os.path.join(tmp, "spool"), workers=1, device="cuda")
    srv.submit(dict(id="base2m", tensor=small_bin, rank=UPDATE_RANK,
                    iters=UPDATE_ITERS, tol=0.0, seed=7))
    srv.run_once()
    base = _serve_result(srv, "base2m")
    resilience.reset_demotions()
    trace.reset()
    trace.set_enabled(True)
    try:
        with _kept_compiles() as kept:
            t0 = time.perf_counter()
            srv.submit(dict(id="feed", kind="ingest", source=src,
                            base="base2m", dims=list(small.dims),
                            chunk_records=INGEST_CHUNK,
                            update_every=INGEST_UPDATE_EVERY, format="tns"))
            srv.run_once()
            feed_s = time.perf_counter() - t0
        job_launches = {s["job"]: (s["args"] or {}).get("launches") or {}
                        for s in trace.spans("serve.job")}
    finally:
        trace.set_enabled(None)
    res = _serve_result(srv, "feed")
    info = res["ingest"]
    dest = info["dest"]
    audit = ingest.audit_journal(dest)
    ups = []
    merged_nnz = small.nnz
    for k, uid in enumerate(res["updates"]):
        ur = _serve_result(srv, uid)
        u = ur.get("update") or {}
        merged_nnz += int(u.get("delta_nnz", 0))
        bs = [b for b in kept if int(b.nnz) == merged_nnz]
        fused = _fused_t_modes(bs[0], UPDATE_RANK) if bs else []
        sweeps = int(u.get("sweeps", -1))
        got = job_launches.get(uid, {})
        ups.append(dict(
            job=uid, status=ur["status"], model_gen=ur.get("model_gen"),
            expected_gen=2 + k, delta_nnz=u.get("delta_nnz"),
            refit=u.get("refit"), sweeps=sweeps, fused_t_modes=fused,
            launches=got.get("fused_mttkrp_t", 0),
            expected_launches=len(fused) * (1 + sweeps),
            sym_eig_launches=got.get("sym_eig", 0),
            expected_sym_eig=len(small.dims) * (1 + sweeps),
            demotions=ur["demotions"], lag_s=u.get("ingest_lag_s"),
            parts_s=srv.timings.get(uid), seconds=ur.get("seconds")))
    del kept
    torch.cuda.empty_cache()
    account = dict(records=info["records"], want_records=good + bad,
                   nnz=info["nnz"], want_nnz=good,
                   quarantined=info["quarantined"], want_quarantined=bad,
                   chunks=info["chunks"], audit_ok=audit["ok"],
                   audit_violations=audit["violations"],
                   records_per_sec=info["records_per_sec"])
    log(f"[ingest] feed: {json.dumps(account)}; {feed_s:.2f} s from submit "
        f"to the last update's commit")
    for u in ups:
        log(f"[ingest] update {json.dumps(u)}")
    ref = ingest_reference(tmp, small_bin, dest, small.dims)
    tt, _ = serve._load_model_tensor(os.path.join(srv.ckpt_dir,
                                                  "base2m.model.npz"))
    gate = serve_model_gate("the ingest-fed model", tt, _checkpoint_model(
        os.path.join(srv.ckpt_dir, "base2m.npz")), ref["ref"],
        ref["control"])
    spans = [(int(u["job"].split("-up-")[1].split("-")[0]),
              int(u["job"].split("-")[-1])) for u in ups]
    ok = (res["status"] == "converged" and base.get("model_gen") == 1
          and account["records"] == good + bad and account["nnz"] == good
          and account["quarantined"] == bad and audit["ok"]
          and len(ups) >= 2 and spans == ref["spans"] and gate["ok"]
          and all(u["status"] == "converged" and not u["refit"]
                  and u["fused_t_modes"] and not u["demotions"]
                  and u["launches"] == u["expected_launches"]
                  and u["model_gen"] == u["expected_gen"]
                  and u["lag_s"] is not None for u in ups))
    out = dict(account=account, updates=ups, feed_s=feed_s, gate=gate,
               spans=spans, base_gen=base.get("model_gen"),
               status=res["status"])
    if not ok:
        raise AssertionError(f"phase 20, the live feed: {json.dumps(out)}")
    return out


def phase_ingest() -> dict:
    """Phase 20: streaming ingest on the card's daemon beside the three
    soaks; every check fatal."""
    import shutil
    import tempfile

    import torch

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ingest_", dir=root)
    runs = start_soaks()
    saved = {k: os.environ.get(k) for k in ("SPLATT_ENGINE_FALLBACK",
                                            "SPLATT_UPDATE_SWEEPS")}
    os.environ["SPLATT_ENGINE_FALLBACK"] = "0"
    os.environ["SPLATT_UPDATE_SWEEPS"] = str(UPDATE_SWEEPS)
    try:
        feed = ingest_feed(tmp)
        soaks, runs = finish_soaks(runs), {}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        stop_soaks(runs)
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    log(f"[ingest] phase 20 took {seconds:.1f} s")
    return dict(feed=feed, soaks=soaks, seconds=seconds)


def _ingest_summary(ig: dict) -> dict:
    """Phase 20's figures for the kernels line (rows 1 and sym_eig)."""
    f = ig["feed"]
    return dict(update_launches=[u["launches"] for u in f["updates"]],
                expected=[u["expected_launches"] for u in f["updates"]],
                sym_eig_launches=[u["sym_eig_launches"]
                                  for u in f["updates"]],
                expected_sym_eig=[u["expected_sym_eig"]
                                  for u in f["updates"]],
                update_parts_s=[u["parts_s"] for u in f["updates"]],
                update_lag_s=[u["lag_s"] for u in f["updates"]],
                records_per_sec=f["account"]["records_per_sec"],
                gate=dict(rel=f["gate"]["rel"],
                          fit64_rel=f["gate"]["fit64_rel"],
                          control_rel=f["gate"]["control_rel"]),
                soak_s={k: v["seconds"] for k, v in ig["soaks"].items()},
                seconds=ig["seconds"])


FUSED_SRC = "splatt_tpu_torch/csrc/fused_mttkrp.cu"
PK = "splatt_tpu/ops/pallas_kernels.py"
NOTE = ("ms/plain_ms/bound_ms: mean per launch over the 3 modes at rank "
        f"{RANK}, 20M nonzeros; launches: the phase that runs it on a full "
        "CPD; every case is in 'contracts'")


def _tg_row(launches: int, where: str, new_rows: dict, bf16: dict,
            big: dict, big_rows: list) -> dict:
    """Row 4 of the kernels line: phase 6's sorted rows at rank 50, with
    phase 8's rank-512 launches (and its rank tiles) beside them."""
    return _record_row(
        "fused_mttkrp_tg", FUSED_SRC, f"{PK}:507", launches,
        [r for r in new_rows["fused_mttkrp_tg"] if r["contract"] == "sorted"],
        None, note=NOTE + f" ({where}); rank512: phase 8's CPD, where it "
        "is the head of the chain", contracts=new_rows["fused_mttkrp_tg"],
        bf16=bf16["fused_mttkrp_tg"],
        rank512=dict(launches=big["launches"], sorted_20m=big["kernel"],
                     contracts_2m=big_rows,
                     cpd_sec_per_iter=big["sec_per_iter"],
                     peak_gib=big["peak_gib"], sweep_phase_ms=big["phases"]))


#: rows 1 and 5 of the kernels line: their design
WALK_STATUS = ("redesigned: the whole rank in one tile on "
               "csrc/gather_walk.cuh's walk_rows")
#: rows 2 and 3: their design, where the checkout holds no
#: csrc/warp_runs.cuh
REDUCE_STATUS = ("redesigned: csrc/gather_walk.cuh's walk_rows, the "
                 "block's products as its one table, rank tiles of "
                 "reduce_rank_tile")


def _reduce_rows(chain: dict, new_rows: dict, bf16: dict) -> list:
    """Rows 2 and 3 of the kernels line: phase 6's rows at rank 50 (the
    full contract's no-flush launch beside them), phase 9's bf16 rows,
    the launches of phase 7's SORTED_CHAIN and FULL_CHAIN."""
    from splatt_tpu_torch.ops import kernels

    src = "splatt_tpu_torch/csrc/onehot_reduce.cu"
    status = ("the one-entry walk of csrc/warp_runs.cuh"
              if (kernels.CSRC / "warp_runs.cuh").exists()
              else REDUCE_STATUS)
    full = new_rows["onehot_reduce_full"]
    return [
        _record_row("onehot_reduce_sorted", src, f"{PK}:148",
                    chain[SORTED_CHAIN]["launches"]["onehot_reduce_sorted"],
                    new_rows["onehot_reduce_sorted"], "library_ms",
                    note=NOTE + " (phase 7); library: one index_add_",
                    status=status,
                    contracts=new_rows["onehot_reduce_sorted"],
                    bf16=bf16["onehot_reduce_sorted"]),
        _record_row("onehot_reduce_full", src, f"{PK}:1415",
                    chain[FULL_CHAIN]["launches"]["onehot_reduce_full"],
                    full, "library_ms",
                    note=NOTE.replace("over the 3 modes", "over the 3 "
                                      "modes, accumulate contract")
                    + " (phase 7, mode 0 privatized); library: one "
                      "index_add_; no_flush_ms: the same launch on ids "
                      "that are all the width (every flush dropped)",
                    status=status,
                    no_flush_ms=sum(r["no_flush_ms"] for r in full)
                    / len(full),
                    contracts=full, bf16=bf16["onehot_reduce_full"]),
    ]


def _requested(rows: list) -> dict:
    """Mean requested bytes of table rows per launch over `rows`, and
    the mean rate they imply."""
    n = len(rows)
    return dict(requested_bytes=sum(r["requested_bytes"] for r in rows) / n,
                requested_tb_s=sum(r["requested_tb_s"] for r in rows) / n)


def _t_row(launches: int, where: str, rows: list, bf16: dict, walk: dict,
           fmt: dict, wide: list, **extra) -> dict:
    """Row 1 of the kernels line: phase 3's sorted rows at rank 50, with
    phase 6's checks at every rank of WALK_RANKS and phase 9's turns
    beside fused_tg at rank 50, ODD_RANKS and WIDE_RANKS."""
    main = [r for r in rows if r["contract"] == "sorted"]
    return _record_row(
        "fused_mttkrp_t", FUSED_SRC, f"{PK}:355", launches, main, None,
        note=NOTE + f" ({where})", status=WALK_STATUS, contracts=rows,
        bf16=bf16["fused_mttkrp_t"], walk_checks=walk,
        turns_rank50=fmt["turns"], turns_wide=wide, **_requested(main),
        **extra)


def _rowmajor_row(launches: int, where: str, new_rows: dict, bf16: dict,
                  walk: dict) -> dict:
    """Row 5 of the kernels line: phase 6's sorted rows at rank 50 and
    the engine's chunk, with phase 6's checks at every rank of
    WALK_RANKS."""
    main = [r for r in new_rows["fused_mttkrp"] if r["contract"] == "sorted"]
    return _record_row(
        "fused_mttkrp", FUSED_SRC, f"{PK}:1340", launches, main, None,
        note=NOTE + f" ({where})", status=WALK_STATUS,
        contracts=new_rows["fused_mttkrp"], bf16=bf16["fused_mttkrp"],
        walk_checks=walk, **_requested(main))


def _v2_row(fmt: dict, bf16: dict, **extra) -> dict:
    """Row 6 of the kernels line: phase 9's auto rows, sorted contract."""
    return _record_row(
        "fused_mttkrp_v2", "splatt_tpu_torch/csrc/fused_mttkrp_v2.cu",
        f"{PK}:702", fmt["launches"]["fused_mttkrp_v2"],
        [r for r in fmt["v2_rows"] if r["encoding"] == "auto"
         and r["contract"] == "sorted"], None,
        note=NOTE.replace("20M nonzeros", "20M nonzeros, idx_width auto, "
                          "sorted contract")
        + " (phase 9, the auto CPD); library: none, no single PyTorch call "
          "computes it",
        max_rel_err_all=max(r["max_rel_err"] for r in fmt["v2_rows"]),
        contracts=fmt["v2_rows"], turns=fmt["turns"],
        storage_bytes=fmt["storage_bytes"], cpd=fmt["cpd"],
        planted_bf16=fmt["planted_bf16"], bf16=bf16["fused_mttkrp_v2"],
        **extra)


def _record_row(name: str, source: str, replaces: str, launches: int,
                rows: list, library, **extra) -> dict:
    """One kernel's entry of the kernels line: ms, plain, bound and
    library means over `rows` (the contract the main path runs)."""

    def mean(key):
        return sum(r[key] for r in rows) / len(rows)

    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches,
                max_abs_err=max(r["max_abs_err"] for r in rows),
                max_rel_err=max(r["max_rel_err"] for r in rows),
                ms=mean("ms"), plain_ms=mean("plain_ms"),
                bound_ms=mean("bound_ms"), bound_by=rows[0]["bound_by"],
                library_ms=None if library is None else mean(library),
                **extra)


def _ring_row(name: str, replaces: str, dist: dict, per: str) -> dict:
    """Row 8 or 9 of the kernels line: phase 11's means over the legs."""
    rows = dist["rows"][name]
    row = _record_row(name, "splatt_tpu_torch/csrc/ring.cu", replaces,
                      dist["launches"][name], rows, "library_ms",
                      note=f"ms/plain_ms/bound_ms/library_ms: mean per "
                      f"launch over phase 11's legs, NELL-2 shape, 20M "
                      f"nonzeros, rank {RANK}, f32, {dist['ranks']} ranks "
                      f"on {dist['cards']} card(s); launches: the "
                      f"async_ring CPD, {RING_ITERS} iterations ({per}); "
                      f"bound: HBM bytes or hop bytes over the measured "
                      f"copy rate; library: {rows[0]['library']}",
                      contracts=rows)
    if name == "ring_gather":
        row.update(copy_rate=dist["copy_rate"], peers=dist["peers"],
                   cpd=dist["cpd"], overlap=dist["overlap"],
                   all2all=dist["all2all"], drill=dist["drill"],
                   phase_seconds=dist["seconds"],
                   sync_ring_ms=sum(r["sync_ring_ms"] for r in rows)
                   / len(rows),
                   owner_plan_ms=sum(r["owner_plan_ms"] for r in rows)
                   / len(rows), plan_builds=dist["plan_builds"],
                   plan_bytes=dist["plan_bytes"],
                   plan_buckets=dist["plan_buckets"],
                   pitch_probe=dist["pitch_probe"])
    return row


def _dense_row(dense: dict, bf16: dict) -> dict:
    """Row 7 of the kernels line: phase 10's f32 means over the modes."""
    rows = dense["rows"]["f32"]
    return _record_row(
        "fused_dense", "splatt_tpu_torch/csrc/fused_dense.cu",
        "splatt_tpu/ops/pallas_kernels.py:1483",
        dense["cpd"]["launches"]["fused_dense"], rows, "library_ms",
        note=f"ms/plain_ms/bound_ms/library_ms: mean per launch over the 3 "
        f"modes of {DENSE_DIMS}, 20M nonzeros, rank {RANK}, f32 tiles and "
        f"factors on the tensor cores as 3xTF32 (bound: the bytes, or 3 "
        f"TF32 products at the TF32 rate; ffma_bound_ms: the same work at "
        f"the FFMA rate); launches: phase 10's dense CPD; library: one "
        f"torch.matmul of the tiles with a materialized Khatri-Rao "
        f"operand, TF32 off (its build in kr_build_ms); bf16: bound at the "
        f"bf16 tensor-core rate",
        ffma_bound_ms=sum(r["ffma_bound_ms"] for r in rows) / len(rows),
        err_vs_tf32x3=max(r["err_vs_tf32x3"] for r in rows),
        contracts=rows, bf16=bf16, layouts=dense["layouts"],
        build=dense["build"], cpd=dense["cpd"],
        all_sparse=dense["all_sparse"], drill=dense["drill"],
        raised=dense["raised"], phase_seconds=dense["seconds"])


EIG_SRC = "splatt_tpu_torch/csrc/sym_eig.cu"
EIG_REPLACES = ("torch.linalg.eigh in the solve (splatt_tpu_torch/ops/"
                "linalg.py solve_normals; its JAX counterpart "
                "jnp.linalg.eigh, splatt_tpu/ops/linalg.py:78): a library "
                "call, not a TPU kernel")


def _batch_eig_row(bt: dict) -> dict:
    """The eigensolver's entry from phase 17 alone (``--batch``): one
    launch over the stack of 64 slots."""
    b = _batch_eig(bt)
    return dict(name="sym_eig", route="cuda", source=EIG_SRC,
                replaces=EIG_REPLACES, launches=b.pop("launches"),
                note=f"ms/bound_ms/library_ms: mean per launch over the 3 "
                f"modes' stacks of {BATCH_K} normal-equations matrices, "
                f"R = {BATCH_RANK}, f32, one launch of {BATCH_K} CTAs; "
                f"plain_ms: sym_eig_plain over mode 0's stack; library: "
                f"batched torch.linalg.eigh, its host sync included; "
                f"singles_ms: {BATCH_K} one-matrix launches; launches: "
                f"phase 17's batched CPD", **b)


def _eig_row(main_path: dict, big: dict, dense: dict, bt: dict) -> dict:
    """The eigensolver's entry of the kernels line: phase 5's f32 rows
    (the main path's dtype), its launches on the main path, the f64 rows,
    the gate at rank 512, and phase 17's launches over the batch."""
    rows = [r for r in main_path["sym_eig"] if r["dtype"] == "torch.float32"]
    f64 = [r for r in main_path["sym_eig"] if r["dtype"] == "torch.float64"]
    row = _record_row(
        "sym_eig", EIG_SRC, EIG_REPLACES,
        main_path["sym_eig_launches"], rows, "library_ms",
        note=f"ms/plain_ms/bound_ms/library_ms: mean per call over the 3 "
        f"modes' normal-equations matrices of phase 5's final factors, "
        f"R = {RANK}, f32; bound: A read and (w, V) written over the HBM "
        f"rate against 9 R^3 operations over the f32 peak, the whole "
        f"card; algo_sm_bound_ms: the Jacobi sweeps the matrix needed at "
        f"one SM's share of that peak; library: torch.linalg.eigh, "
        f"its host sync included; launches: phase 5's CPD",
        contracts=main_path["sym_eig"],
        algo_sm_bound_ms=sum(r["algo_sm_bound_ms"] for r in rows)
        / len(rows),
        f64={k: sum(r[k] for r in f64) / len(f64)
             for k in ("ms", "plain_ms", "bound_ms", "algo_sm_bound_ms",
                       "library_ms")},
        solve_ms=dict(main=main_path["phases"], dense=dense["cpd"][
            "sweep_phase_ms"], rank512=big["phases"]),
        gate_rank512=big["eig_gate"], scaling=main_path["sym_eig_scaling"],
        crossover=main_path["solve_crossover"], batched=_batch_eig(bt))
    row["max_rel_err"] = max(r["op_rel_err"] for r in rows)
    return row


def _bf16_summary(rows: list) -> dict:
    """Phase 9's (or 10's) bf16 rows of one kernel: means over the modes
    of the first contract (sorted), the largest error over all."""
    first = [r for r in rows if r["contract"] == rows[0]["contract"]]
    n = len(first)
    return dict(ms=sum(r["ms"] for r in first) / n,
                plain_ms=sum(r["plain_ms"] for r in first) / n,
                bound_ms=sum(r["bound_ms"] for r in first) / n,
                max_rel_err=max(r["max_rel_err"] for r in rows),
                contract=rows[0]["contract"], rows=rows)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if "--ooc-child" in sys.argv[1:]:
        spec = json.loads(sys.argv[sys.argv.index("--ooc-child") + 1])
        print(json.dumps(ooc_child(spec)))
        return 0
    from splatt_tpu_torch import BlockedSparse, Options
    from splatt_tpu_torch.config import BlockAlloc
    from splatt_tpu_torch.ops import kernels

    dev = phase_device()
    t_script = time.perf_counter()
    # autotuning is on by default: every phase reads a plan cache of this
    # run's own, empty until phase 15 (which writes files of its own)
    import atexit
    import shutil
    import tempfile

    cache_dir = tempfile.mkdtemp(prefix="chip_smoke_plans_",
                                 dir=os.path.dirname(os.path.abspath(
                                     __file__)))
    atexit.register(shutil.rmtree, cache_dir, True)
    os.environ["SPLATT_TUNE_CACHE"] = os.path.join(cache_dir,
                                                   "tune_cache.json")
    gather = "--gather" in sys.argv[1:]
    ranks = "--ranks" in sys.argv[1:]
    reduce = "--reduce" in sys.argv[1:]
    balance = "--balance" in sys.argv[1:]
    guard_only = "--guard" in sys.argv[1:]
    tune_only = "--tune" in sys.argv[1:]
    ooc_only = "--ooc" in sys.argv[1:]
    batch_only = "--batch" in sys.argv[1:]
    serve_only = "--serve" in sys.argv[1:]
    fleet_only = "--fleet" in sys.argv[1:]
    ingest_only = "--ingest" in sys.argv[1:]
    import concurrent.futures

    # nvcc runs in its own processes: phase 3's tensor (host numpy, no
    # kernel) is made meanwhile, where the run needs it
    pool = concurrent.futures.ThreadPoolExecutor(1)
    building = pool.submit(phase_build, verbose=not (
        ranks or reduce or balance or guard_only or tune_only or ooc_only
        or batch_only or serve_only or fleet_only or ingest_only))
    try:
        tt = data_s = None
        if not (batch_only or serve_only or fleet_only or ingest_only
                or "--dense" in sys.argv[1:]):
            t0 = time.perf_counter()
            tt = synthetic_tensor(NELL2, NNZ, seed=0)
            data_s = time.perf_counter() - t0
        building.result()
    finally:
        pool.shutdown()
    from splatt_tpu_torch import native

    # phase 13 fails without it; every earlier host build would sort with
    # np.lexsort
    log(f"[build] native host sort ({native.lib_path().name}): "
        + ("built" if native.available() else "NOT AVAILABLE"))
    if "--dense" in sys.argv[1:]:
        dense = phase_dense(RANK)
        print(json.dumps({"kernels": [_dense_row(
            dense, _bf16_summary(dense["rows"]["bf16"]))],
            "power": dev["smi"]}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}))
        return 0

    if serve_only:
        sv = phase_serve(synthetic_tensor(NELL2, NNZ, seed=0))
        small = synthetic_tensor(NELL2, BIG_RANK_NNZ, seed=5)
        rows = phase_kernels(BlockedSparse.from_coo(
            small, Options(block_alloc=BlockAlloc.ALLMODE)), UPDATE_RANK)
        print(json.dumps({"kernels": [_record_row(
            "fused_mttkrp_t", FUSED_SRC, f"{PK}:355", sv["full"]["launches"],
            [r for r in rows if r["contract"] == "sorted"], None,
            note=f"ms/plain_ms/bound_ms: mean per launch over the 3 modes' "
            f"sorted layouts of phase 6's 2M tensor (NELL-2 shape), rank "
            f"{UPDATE_RANK}; launches: phase 18's full-width cpd job",
            status=WALK_STATUS, phase18=_serve_summary(sv))],
            "power": dev["smi"]}))
        log(f"[total] {time.perf_counter() - t_script:.1f} s")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}))
        return 0

    if fleet_only:
        fl = phase_fleet(synthetic_tensor(NELL2, NNZ, seed=0))
        small = synthetic_tensor(NELL2, BIG_RANK_NNZ, seed=5)
        rows = phase_kernels(BlockedSparse.from_coo(
            small, Options(block_alloc=BlockAlloc.ALLMODE)), UPDATE_RANK)
        print(json.dumps({"kernels": [_record_row(
            "fused_mttkrp_t", FUSED_SRC, f"{PK}:355",
            fl["observability"]["adopter"]["launches"]["fused_mttkrp_t"],
            [r for r in rows if r["contract"] == "sorted"], None,
            note=f"ms/plain_ms/bound_ms: mean per launch over the 3 modes' "
            f"sorted layouts of phase 6's 2M tensor (NELL-2 shape), rank "
            f"{UPDATE_RANK}; launches: phase 19's adopting replica, the "
            f"full-width job after the kill", status=WALK_STATUS,
            phase19=_fleet_summary(fl))], "power": dev["smi"]}))
        log(f"[total] {time.perf_counter() - t_script:.1f} s")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}))
        return 0

    if ingest_only:
        ig = phase_ingest()
        small = synthetic_tensor(NELL2, BIG_RANK_NNZ, seed=5)
        rows = phase_kernels(BlockedSparse.from_coo(
            small, Options(block_alloc=BlockAlloc.ALLMODE)), UPDATE_RANK)
        print(json.dumps({"kernels": [_record_row(
            "fused_mttkrp_t", FUSED_SRC, f"{PK}:355",
            sum(u["launches"] for u in ig["feed"]["updates"]),
            [r for r in rows if r["contract"] == "sorted"], None,
            note=f"ms/plain_ms/bound_ms: mean per launch over the 3 modes' "
            f"sorted layouts of phase 6's 2M tensor (NELL-2 shape), rank "
            f"{UPDATE_RANK}; launches: phase 20's ingest-chained updates",
            status=WALK_STATUS, phase20=_ingest_summary(ig))],
            "power": dev["smi"]}))
        log(f"[total] {time.perf_counter() - t_script:.1f} s")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}))
        return 0

    if batch_only:
        bt = phase_batch()
        t_rows = phase_kernels(bt["update"]["layouts"], UPDATE_RANK)
        print(json.dumps({"kernels": [_record_row(
            "fused_mttkrp_t", FUSED_SRC, f"{PK}:355",
            bt["update"]["fused_mttkrp_t_launches"],
            [r for r in t_rows if r["contract"] == "sorted"], None,
            note=f"ms/plain_ms/bound_ms: mean per launch over the 3 modes' "
            f"sorted layouts of phase 17's merged update tensor (NELL-2 "
            f"shape, 2M nonzeros and a 1% delta), rank {UPDATE_RANK}; "
            f"launches: refresh_touched_rows and the warm cpd_als",
            status=WALK_STATUS, phase17=_batch_summary(bt)),
            _batch_eig_row(bt)], "power": dev["smi"]}))
        log(f"[total] {time.perf_counter() - t_script:.1f} s")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}))
        return 0

    log(f"[data] NELL-2-shaped {NELL2} nnz={tt.nnz}: generated in "
        f"{data_s:.2f} s, beside the kernel build")
    if "--decomp" in sys.argv[1:]:
        decomp = phase_decomp(tt, RANK)
        rows = _decomp_summary(decomp)["rank0_rows"]
        print(json.dumps({"kernels": [_record_row(
            "fused_mttkrp_t", FUSED_SRC, f"{PK}:355",
            sum(decomp["launches"].values()), rows, None,
            note=f"ms/plain_ms/bound_ms: mean per launch over rank 0's "
            f"sorted launches in phase 12's decompositions, NELL-2 shape, "
            f"20M nonzeros over {decomp['ranks']} ranks, rank {RANK}; "
            f"launches: phase 12's four blocked CPDs",
            status=WALK_STATUS, phase12=_decomp_summary(decomp))],
            "power": dev["smi"]}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}))
        return 0
    if ooc_only:
        ooc = phase_ooc(tt, RANK)
        print(json.dumps({"kernels": [_ooc_row(ooc)], "power": dev["smi"]}))
        log(f"[total] {time.perf_counter() - t_script:.1f} s")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}))
        return 0
    if "--ring" in sys.argv[1:]:
        dist = phase_distributed(tt, RANK)
        print(json.dumps({"kernels": [
            _ring_row("ring_gather", "splatt_tpu/parallel/ring_kernels.py:152",
                      dist, "2 x nmodes x iterations per card"),
            _ring_row("ring_reduce", "splatt_tpu/parallel/ring_kernels.py:260",
                      dist, "nmodes x iterations per card")],
            "power": dev["smi"]}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}))
        return 0
    t0 = time.perf_counter()
    bs = BlockedSparse.from_coo(tt, Options(block_alloc=BlockAlloc.ALLMODE))
    torch.cuda.synchronize()
    layout_s = time.perf_counter() - t0
    log(f"[layout] host sort + block of {bs.nmodes} layouts and transfer: "
        f"{layout_s:.2f} s")
    log(f"[layout] " + " ".join(
        f"mode{lay.mode}: nblocks={lay.nblocks} seg_width={lay.seg_width}"
        for lay in bs.layouts))

    if balance:
        del bs
        bal = phase_balance(tt, layout_s, RANK)
        print(json.dumps({"kernels": [
            _balance_t_row(bal), _balance_v2_row(bal)],
            "power": dev["smi"]}))
        log(f"[total] {time.perf_counter() - t_script:.1f} s")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}))
        return 0
    if guard_only:
        rows = phase_kernels(bs, RANK)
        v1 = v1_fits(bs, RANK)
        parts = sweep_phases(bs, v1["factors"], v1["sec_per_iter"], "[cpd]")
        gd = phase_guard(bs, tt, RANK, v1["fits"], parts)
        print(json.dumps({"kernels": [_record_row(
            "fused_mttkrp_t", FUSED_SRC, f"{PK}:355", gd["launches"],
            [r for r in rows if r["contract"] == "sorted"], None,
            note=NOTE + " (launches: phase 14's unguarded and guarded "
            "traced CPDs)", status=WALK_STATUS,
            phase14=_guard_summary(gd))], "power": dev["smi"]}))
        log(f"[total] {time.perf_counter() - t_script:.1f} s")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}))
        return 0
    if tune_only:
        v1 = v1_fits(bs, RANK)
        tn = phase_tune(tt, bs, v1)
        print(json.dumps({"kernels": _tune_rows(tn), "power": dev["smi"]}))
        log(f"[total] {time.perf_counter() - t_script:.1f} s")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}))
        return 0
    if ranks:
        v1 = v1_fits(bs, RANK)
        if v1["launches"] != bs.nmodes * ITERS:
            raise AssertionError(f"fused_mttkrp_t launched {v1['launches']} "
                                 f"times, expected {bs.nmodes * ITERS}")
        parts = sweep_phases(bs, v1["factors"], v1["sec_per_iter"], "[cpd]")
        turns = wide_rank_turns(bs, (RANK,) + ODD_RANKS + WIDE_RANKS)
        print(json.dumps({"turns": turns, "cpd": dict(
            fits=v1["fits"], launches=v1["launches"],
            sec_per_iter=v1["sec_per_iter"], phases=parts),
            "power": dev["smi"]}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}))
        return 0
    if reduce:
        new_rows = phase_new_kernels(bs, RANK, gathers=False)
        fac16 = [U.to(torch.bfloat16) for U in random_factors(bs, RANK, 1)]
        bf16 = {k: _bf16_summary(v) for k, v in bf16_reductions(
            bf16_layouts(bs), fac16, RANK).items()}
        chain = phase_chain(bs, RANK, REDUCE_CHAIN, [])
        # the rank tiles, where the checkout's kernels take one
        tiles = (reduce_tile_turns(bs)
                 if hasattr(kernels, "onehot_reduce_launch") else None)
        print(json.dumps({"kernels": _reduce_rows(chain, new_rows, bf16),
                          "tile_turns": tiles, "power": dev["smi"]}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}))
        return 0
    yard = {"l2_copy": l2_copy_rate(),
            "library_gather": [
                library_gather_rate(bs, c)
                for c in (kernels.tg_rank_tile(BIG_RANK), RANK)]}
    if gather:
        rows = phase_kernels(bs, RANK)
        new_rows = phase_new_kernels(bs, RANK, reductions=False)
        small = small_layouts(NELL2)
        walk = phase_walk(walk_tensors(small))
        big_rows = phase_big_rank(small)
        del small
        big = phase_rank512(bs, tiles=True)
        v1 = v1_fits(bs, RANK)
        chain = phase_chain(bs, RANK, GATHER_CHAIN, [])
        fmt = phase_format(bs, RANK, v1["fits"])
        wide = wide_rank_turns(bs)
        bf16 = {k: _bf16_summary(v) for k, v in fmt["bf16"].items()}
        print(json.dumps({"kernels": [
            _t_row(v1["launches"], "phase 5's CPD, run for its fits", rows,
                   bf16, walk, fmt, wide),
            _tg_row(big["launches"], "phase 8's rank-512 CPD", new_rows,
                    bf16, big, big_rows),
            _rowmajor_row(chain[FUSED_CHAIN]["launches"]["fused_mttkrp"],
                          "phase 7's SPLATT_EXPERIMENTAL_FUSED=1 CPD",
                          new_rows, bf16, walk),
            _v2_row(fmt, bf16)], "yardsticks": yard,
            "power": dev["smi"]}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}))
        return 0
    rows = phase_kernels(bs, RANK)
    phase_parity()
    main_path = phase_main_path(bs, RANK)
    new_rows = phase_new_kernels(bs, RANK)
    small = small_layouts(NELL2)
    walk = phase_walk(walk_tensors(small))
    big_rows = phase_big_rank(small)
    del small
    chain = phase_chain(bs, RANK)
    big = phase_rank512(bs)
    fmt = phase_format(bs, RANK, main_path["fits"])
    wide = wide_rank_turns(bs)
    bf16 = {k: _bf16_summary(v) for k, v in fmt["bf16"].items()}
    guard = phase_guard(bs, tt, RANK, main_path["fits"], main_path["phases"])
    tuned = phase_tune(tt, bs, main_path)
    del bs
    dense = phase_dense(RANK)
    bf16["fused_dense"] = _bf16_summary(dense["rows"]["bf16"])
    dist = phase_distributed(tt, RANK)
    decomp = phase_decomp(tt, RANK)
    # phase 16 writes phase 3's tensor as .bin where phase 18 reads it
    serve_bin = os.path.join(cache_dir, "nell2.bin")
    ooc = phase_ooc(tt, RANK, big=serve_bin)
    bal = phase_balance(tt, layout_s, RANK)
    bt = phase_batch()
    del bt["update"]["layouts"]
    sv = phase_serve(tt, serve_bin, main_path["sec_per_iter"] * 1e3)
    fleet = phase_fleet(tt, serve_bin, sv.pop("ref"))
    del tt
    os.remove(serve_bin)
    ing = _ingest_summary(phase_ingest())

    def launches(label, kernel):
        return chain[label]["launches"][kernel]

    record = {"kernels": [
        _t_row(main_path["launches"], "phase 5, the main path", rows, bf16,
               walk, fmt, wide, cpd_sec_per_iter=main_path["sec_per_iter"],
               sweep_phase_ms=main_path["phases"],
               phase12=_decomp_summary(decomp),
               phase16=_ooc_summary(ooc),
               phase13=_balance_summary(bal),
               phase13_rows=_balance_rows(bal),
               phase14=_guard_summary(guard),
               phase15=_tune_summary(tuned),
               phase17=_batch_summary(bt),
               phase18=_serve_summary(sv),
               phase19=_fleet_summary(fleet),
               phase20=ing),
        _tg_row(launches("fused_t faulted", "fused_mttkrp_tg"),
                "phase 7, fused_t faulted", new_rows, bf16, big, big_rows),
        _rowmajor_row(launches(FUSED_CHAIN, "fused_mttkrp"),
                      "phase 7, SPLATT_EXPERIMENTAL_FUSED=1", new_rows, bf16,
                      walk),
        *_reduce_rows(chain, new_rows, bf16),
        _v2_row(fmt, bf16, phase13=bal["sizes"]["20M"]["v2"]),
        _dense_row(dense, bf16["fused_dense"]),
        _ring_row("ring_gather", "splatt_tpu/parallel/ring_kernels.py:152",
                  dist, "2 x nmodes x iterations per card"),
        _ring_row("ring_reduce", "splatt_tpu/parallel/ring_kernels.py:260",
                  dist, "nmodes x iterations per card"),
        dict(_eig_row(main_path, big, dense, bt), phase19=dict(
            adopter_launches=fleet["observability"]["adopter"][
                "launches"].get("sym_eig"),
            expected=fleet["observability"]["adopter"][
                "expected_sym_eig"]), phase20=dict(
            update_launches=ing["sym_eig_launches"],
            expected=ing["expected_sym_eig"])),
    ], "chain": chain, "yardsticks": yard, "power": dev["smi"]}
    print(json.dumps(record))
    log(f"[total] {time.perf_counter() - t_script:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
