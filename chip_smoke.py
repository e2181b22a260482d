#!/usr/bin/env python3
"""Smoke test of gpmp_tpu_torch on one CUDA card: REML fit + predict, its
diagnosis, a batched REMAP fit through a DataLoader, MH and NUTS on a REMAP
posterior, SMC and SVGD on a REMAP posterior through the population form of
the gram kernels (K1p, K2p), noisy REML fit + LOO +
predict on the mixed Cholesky engine, conditional sample paths, large-n REML on the streamed engine through a one-card mesh, the
mesh's resident branch (the blocked Cholesky with refined panels: fit,
predict, LOO, the sharded mixed engine, n = 51200 parity), the repaired
second derivatives, and the group mesh on torch.distributed (the
row-sharded factor, K9s) as a 1-rank NCCL group and as two gloo ranks
sharing the card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA card, nvcc, and the repository's sources; it imports
neither JAX nor gpmp_tpu.  Phases (each prints lines; any failure exits
non-zero):

1. Device and build: the card's name and power limit (nvidia-smi), the
   time to build gpmp_tpu_torch/csrc with nvcc (one nvcc per source, in
   parallel), ptxas register/spill lines.
2. K1/K2 vs plain versions on the card: K1 (Matern gram) and K2 (its
   parameter pullback) in float64 and float32 against the plain PyTorch
   versions on the same CUDA tensors at GRAM_CASES (n, m up to 4099, x is
   y and the cross form, d in {1, 3, 6, 9}), p in {0, 1, 2, 3, 5}, with
   duplicated rows and a non-symmetric Kbar.  Errors are max|kernel -
   plain| / max|plain|; tolerances K1 1e-12 (f64) / 1e-5 (f32), K2 1e-9
   (f64) / 1e-3 (f32); K(x, x) exactly symmetric with the plain version's
   diagonal; K2 bitwise reproducible.
2b. K3/K4/K5/K7 vs plain versions on the card, on noisy-Matern SPD
   matrices K (n in {1000, 1024, 4099}, cond(K) ~1e3 and ~1e6, set by the
   noise variance from the gram's largest eigenvalue), with the
   tolerances and reasons given at TOL_MIXED; K3 at k in {1, 2, 3, 8}, in
   f64 and in f32, each bitwise reproducible, and at n = 16384, k = 2; K5
   at bases 1, 7, 64 and 128 (K5_BASES), exactly zero above the diagonal
   and bitwise reproducible; K7's two calls bitwise reproducible.
2c. K1d (scaled distance and its pullback, full and elementwise), K1m (the
   Matern polynomial and its backward), K7b (the LOO diagonal series, both
   branches) and K8s (the f64 sampling residual) vs their plain versions
   on the card: K1d/K1m at n in {1000, 4099}, d in {1, 6, 9}, p in {0, 2,
   3}, with coincident points, in f64 and f32, D(x, x) exactly symmetric,
   the pullback bitwise reproducible and bitwise the same from a Dbar whose
   base is not 16-byte aligned (its scalar-access instance); K7b on phase
   2b's inputs; K8s
   at n in {1000, 4099, 8192}, cond(K) ~1e3 and ~1e6; tolerances at
   TOL_2C; K4 (the f64 tensor-core residual) on K8s's inputs, exactly
   symmetric and within TOL_MIXED["K4"] of its plain version; K8s (K4's
   kernel with an f64 output) rounded to f32 bitwise K4.
2d. K6 (the preconditioner apply), K10b (row-chunk split into the f32
   pair), K10r (factorization residual from the pair and from f64 panels),
   K10m (residual against the pair) and K10t (chunked trace sums) vs their
   plain versions on the card: at n in {1000, 4099, 8192}, cond(K) ~1e3 and
   ~1e6, panels and chunks of 512 (K10r's panels also 500 and 333 wide: c0
   and w not multiples of its 64-wide tiles; K10m at k in {2, 3, 8}); and all
   five once more at n = 32768 on the engine's own residents at
   bench_large_n.py's p0; tolerances at TOL_2D.  K10r from the pair is
   bitwise K4 on hi + lo in f64 and its panels bitwise the pair's at every
   n; K6 (narrow and wide), K10m and K10t are bitwise reproducible.
2e. K8r (the refined panel's residual and guard sums), K8t (the
   triangular products of the Newton step and the Ogita-Aishima update),
   K9u (the blocked factor's trailing update, on the f64 tensor cores) and
   K9m (Murray's passes) vs their plain versions on the card: K8r/K8t on
   (b, b) panels, b in {3, 256, 488, 512} (3 and 488: the ragged last
   panels of n = 4099 and 1000), cond ~1e3 and ~1e6, K8t's upper triangle
   exact zeros, K8r bitwise reproducible, refined_cholesky's captured graph
   (L and M) bitwise its launch sequence run as it is, each replay counting
   3 K8r and 8 K8t; K9u at n in
   {1000, 4099, 16384, 51200} (phase 3e's sizes; n = 4099's odd rows take
   8-byte copies), panels of 512, at the first, a middle and the last
   panel (n = 4099's last leaves 3 rows), held entrywise by row blocks,
   exactly symmetric, nothing written outside the trailing block; K9m at n
   in {1000, 4099, 16384}; tolerances at TOL_2E.
2f. K9s (the slab form of K9u, the row-sharded factor's trailing update:
   K9u's tensor-core kernel in f64, a register-tiled CUDA-core kernel in
   f32) and K9m's slab form vs their plain versions on the card: K9s on the
   slabs of R = 1 and 2 ranks at n = 16384 (f64 and f32) at the first, a
   middle and the last panel, and on n = 4099 cut into the slabs [0, 2050)
   and [2050, 4099) with a panel straddling them (f64 and f32), held
   entrywise in units of 2 b eps, only its lower trapezoid written, and
   bitwise K9u's lower triangle at one rank (f64); K9m's slab forms bitwise
   their plain versions and the square form's rows; the slab forms of K3
   (k in {1, 2, 3, 8}, f64 and f32, reproducible),
   K6 (reproducible), K7 (reproducible; the slab at row 2050 not 16-byte
   aligned: its scalar-load instance) and K4s (the sharded mixed engine's)
   on n = 4099's slabs against their plain versions with phases 2b/2d's
   tolerances, K4s's blocks
   bitwise K4's rows; K4s at n in {1000, 4099, 8192}: bitwise K4 at one
   rank, and at two ranks R[i, j] on one bitwise R[j, i] on the other.
3. The main path: Hartmann6, n = 1000, d = 6, Matern p = 2, constant
   mean; select_parameters_with_reml then predict at nt = 1000 points, on
   the card, with the launch counters reset just before and the plain
   versions made to raise on CUDA tensors.  Checks: both kernels launched,
   finite covparam and predictions, and the port on the CPU (plain
   versions) at the card's covparam agrees to rel 1e-8 on the REML value
   and on the predicted mean and variance.
3b. The noisy-regression slice on the mixed engine: bench.py's data
   (n = 1000, d = 6, seed 7, noise 0.1), its user kernel (Matern p = 2
   plus a noise variance) and its p0; under set_chol_engine("mixed"):
   autoselect_parameters on REML, Model.loo, then predict at nt = 1000
   seeded uniform points, with the K1d/K1m/K3/K4/K5/K7/K7b counters reset
   just before and every plain version made to raise on CUDA tensors (the
   user kernel's gram runs through K1d/K1m, the LOO diagonal through
   K7b).  Checks: each kernel launched; at the fitted covparam, mixed vs the card's f64
   engine: REML rel 1e-6 (bench.py's gate), gradient within the class
   envelope of BENCHMARKS.md (1e-3 log s2, 1e-4 the others; relative at
   p0, and at the optimum, where the gradient is ~0, relative to the
   larger of the trace and quadratic terms it is the difference of,
   computed in the same run), LOO within TOL_SLICE, predictions within
   twice the error that the residual of predict's refined solve implies
   (_refine_probe); the port on the CPU (mixed engine, plain versions):
   REML rel 1e-8 at p0, and bench.py's 1e-6 at the card's covparam
   (cond(K) ~3e6 there; see phase_slice).
3c. Conditional sample paths at full width: phase 3b's model and data,
   xt = xi plus 7192 uniform points (seed 8), nt = 8192; on each engine at
   p0 and at the fitted covparam: 1024 paths (Model.sample_paths),
   predict(return_lambdas=True), conditional_sample_paths, with the
   counters reset and every plain version raising.  Checks: the branch
   sample_paths took (the mixed engine at p0 must take sampling_sqrt, K5
   and K8s launched), |C C^T - K|_F / |K|_F < 1e-8, the mean of the
   conditioned paths within 5.5 standard errors (from the paths' own
   variance) of predict's mean at every point, the card against the port
   on the CPU with the same normals (f64 engine: 1e-8 at p0; printed, not
   gated, at the fit, where cond(K) is far larger); examples 10 and 11 at
   nt = 200 on both engines: conditioned paths interpolate the noise-free
   observations to 1e-6.
3d. Large-n REML: bench_large_n.py's data and model (copied; d = 3, seed
   20260817, Matern p = 2 plus a noise variance, p0 from the data) at
   n = 32768, set_chol_engine("mixed"), a one-card mesh, the cutover forced
   at n (the mesh's resident mixed branch fits n = 32768 on an 80 GB card):
   the streamed engine must pick ff mode.  (a) one
   REML value+grad at p0 through the sharded criterion with every counter of
   the path reset and the plain versions raising: K6, K10b, K10r, K10m,
   K10t, K5, K1d/K1m and their f32 backwards each launch; (b)
   select_parameters_with_reml(mesh=..., L-BFGS-B, maxiter 2), ending finite
   and no higher than at p0; (c) recompute mode, one value+grad, against ff.
   Gates: at n = 32768 the REML value matches the port's f64 engine (core
   path, value only) to 1e-8; at n = 16384 (GPMP_STREAM_N forced) the
   gradient is within the class envelope of the f64 engine's; at n = 2048
   the card matches the port on the CPU to 1e-8.  (d) At n = 51200, past the
   resident branch's reach, the dispatcher streams in recompute mode by
   itself: one value+grad.  The rise of
   max_memory_allocated for one value+grad per streamed mode (and with the
   robust branch forced) and per resident engine, at n = 16384 and 32768.
3e. The resident one-card mesh path, bench_large_n.py's workload,
   make_mesh(1), panels of auto_shard_block = 512, the counters reset
   before each call and every plain version raising: (a) n = 16384 on the
   f64 engine, select_parameters_with_reml(mesh=..., L-BFGS-B, maxiter 2),
   then the view's predict at make_data's xt (NT = 64) and LOO, held to the
   core f64 engine (cuSOLVER) at p0 and at the fit (REML 1e-10, gradient
   1e-7, predict and LOO at 100 cond(K) eps64, cond(K) by power iteration),
   with K8r/K8t/K9u/K9m launched and the worst panel's guard residual
   printed; (b) n = 16384 on the mixed engine, the dispatcher keeping the
   resident branch (parallel/mixed.py): REML value+grad at p0 and at (a)'s
   fit against (a) (REML 1e-6, the gradient envelope as phase 3b), K3-K7
   launched; and at n = 32768, where the dispatcher's memory model keeps
   the branch resident too, one value+grad at p0: its peak rise within the
   model's units, its REML against the core f64 engine (1e-6) and its
   gradient against the f64 resident branch (the envelope); (c) n = 51200, f64: sharded_covariance, sharded_cholesky, REML
   with factor= against PARITY_51200_r03.json's NumPy oracle (1e-10),
   sharded_predict(factor=) against the core f64 engine (1e-9; cuSOLVER
   through core.kriging, on the covariance built once), and a gradient
   through factor= must raise.
3f. The repairs: the REML Hessian (torch.autograd.functional.hessian) at
   bench.py's data and p0 (n = 1000) through the built-in covariance (K1/K2
   plus a noise variance) and through bench.py's user kernel (K1d/K1m), and
   the predicted mean's gradient in xt (nt = 64), card against CPU (rel
   1e-10, the f64 engine on both); a Hessian through the mixed engine must
   raise.
3g. The group mesh as a 1-rank NCCL group (init_process_group on
   tcp://127.0.0.1, make_mesh() spanning it): phase 3e's workload at
   n = 16384, f64, panels of 512: a 2-iteration fit, the view's predict
   and LOO (counters reset before each, the plain versions raising; K9s,
   K8r, K8t, K9m launched, K9u not), one value+grad, one factor with its
   gathers and bytes, held to phase 3e's one-card results (REML, gradient,
   predict, LOO 1e-12; the fit's covparam 1e-10); the sharded mixed engine
   on the group (K3, K4s, K6, K7, K9s f32 launched) at p0 against phase 3e's f64
   and mixed branches (REML 1e-6, the gradient envelope: the two mixed
   engines' f32 preconditioners differ); n = 51200: the factor and the REML
   through factor= against PARITY_51200_r03.json's oracle (1e-12). Walls
   and peak rises beside phase 3e's.
3h. Two ranks sharing the card over gloo (spawned processes): gloo's
   collectives on CUDA tensors probed first, then REML value+grad at p0,
   predict and LOO at n = 8192, panels of 512, against the one-card path on
   the same card (1e-11), the ranks bitwise equal; and phase 3j's
   data-parallel REMAP criterion (make_data_parallel_criterion) over
   PHASE3J_GLOO_BATCHES batches of 250, half a rank, at 3j's optimum,
   against its one-card value and gradient (1e-12), the ranks bitwise
   equal.
3i. The diagnosis of phase 3's fit (example02's flow at full width): on the
   card, modeldiagnosis.diag (its report printed to a buffer), the
   parameter statistics over PHASE3I_POINTS-point profiles of the seven
   parameters through evaluate_batch, compute_performance (LOO and the
   nt = 1000 test set, with PIT), the CRPS and the CRPS truncated to the
   test values' 10%-90% range, and Model.fisher_information and
   fisher_information_torch at the fitted covparam; then the same calls on
   the CPU at that covparam.  The card's part runs with the plain versions
   of the gram, distance, mixed and refine kernels raising on CUDA tensors,
   except inside the Fisher functions, whose second derivatives go through
   the gram's plain composition by design (ops/autograd.py).  Checks: each
   number within rel 1e-8 of the CPU's (max|diff|/max|CPU| for vectors and
   matrices), K1 launched at least once per row of the profile grid and K2
   at least once (counts of K1, K2, K1d and K1m printed), and no matplotlib
   imported; its walls printed.
3j. The REMAP and dataloader slice (example30's flow at full width), with
   the plain versions of the gram, distance, mixed and refine kernels
   raising on CUDA tensors throughout, then the same on the CPU: (a)
   Hartmann6 at n = 1000, d = 6, a shuffled DataLoader of 200 (drop_last),
   select_parameters_with_remap through it (launch counters reset just
   before and read just after: K1 and K2 at least 5 x nfev, K1d and K1m
   printed), LOO on the first 400 points and modeldiagnosis.perf; (b) the
   default REMAP on phase 3's arrays (n = 1000); (c) method='lbfgs-device'
   on phase 3's REML from its start (best value returned, J at most SciPy
   L-BFGS-B's + 1e-6 max(1, |J|)); (d) make_data_parallel_criterion on
   make_mesh() over the loader's stacked batches at (a)'s optimum against
   (a)'s criterion on the same batches (1e-12). Card vs CPU (TOL_3J): each
   criterion's value and gradient at a fixed p 1e-10, the fitted criteria
   1e-9, covparam 1e-4 (SciPy's flatness). Walls, nfev and ms per
   evaluation printed beside the card's name and power limit.
3k. The posterior samplers (example23's flow at the example's own width
   and budget, PHASE3K): twobumps at ni = 10, d = 1, Matern p = 3, seed 0;
   select_parameters_with_remap, then sample_from_selection_criterion_mh
   (3000 steps, 1200 of burn-in, 2 chains) and _nuts (400 samples after
   300 of warmup, 2 chains), on the card with the launch counters reset
   just before and every plain version raising on CUDA tensors (the log
   target and its value+grad replay CUDA graphs: every MH evaluation and
   NUTS leaf must).  The same NUTS run (nuts_sample) and an MH run of 1000
   steps with the entry point's options are stopped by their log target
   just after their first checkpoint (half way) and resumed (nuts_resume;
   restore_checkpoint, continue_run): both bitwise their uninterrupted
   runs.  Then on the CPU from the card's MAP: the REMAP covparam (1e-10),
   the log target at the MAP and 8 points around it (1e-11, the
   criterion's f64 floor here, TOL_3K), the MH chains of one seed at every
   step (1e-9, the accept flags identical); the NUTS run's 798
   sampling-phase transitions run again through nuts_transition from its
   states with seeded generators, on the card and on the CPU (q_new 1e-9,
   accept_stat 1e-10; n_leapfrog, depth and divergent identical).  K1 and
   K2 launched, K1d and K1m not; the samples finite.  The samplers under
   the mixed engine at n = 256 (phase 3b's data and user kernel, REML):
   the log target not captured (no graph replay; the engine reads the card
   back), its kernels launched, the samples finite, the log target at p0
   within 1e-6 of the f64 engine's.  Printed beside the card's name and
   power limit: MH steps/s, NUTS transitions/s, ms per value+grad and per
   value, the walls on the card and on the CPU.
3l. The population samplers (bench_samplers.py's SMC and SVGD budgets,
   PHASE3L) on K1p and K2p, the population forms of K1 and K2 (B
   parameter vectors at one x, one launch).  First the kernels at (B, n,
   d) = (1000, 8, 1) (the SMC population), (32, 8, 1) (SVGD) and (64, 512,
   6) (a 134 MB f64 stack), p = 3, x is y: K1p bitwise B single K1
   launches and within 1e-14 of plain; K2p bitwise reproducible, within
   1e-13 of plain and 1e-14 of B single K2 launches (per member, relative
   to its largest component); each timed (CUDA events, device time) beside
   B single launches, its plain version and its byte bound.  Then
   example23's data at ni = 8 (twobumps, d = 1, Matern p = 3, seed 0), its
   REMAP fit (the gaussian-logsigma2-and-logrho prior), and with the
   counters reset after the fit and every plain version raising on CUDA
   tensors: sample_from_selection_criterion_smc (1000 particles, T 1e6 ->
   1, 20 MH steps, the ESS ladder) and _svgd (32 particles, 500 steps).
   Gates: both on the graph route (one CUDA graph a population shape,
   mcmc.population), K1p launched once a replay in SMC, K1p and K2p in
   SVGD with one replay a step; the single-theta K1 launched once a
   sampler (the route probe: one evaluation of the criterion as written),
   K2, K1d and K1m not.  Card vs CPU: the population criterion and the
   SVGD log target and its gradient at the MAP's 64 neighbours
   (|diff| <= 1e-11 max(1, |value|)); each SMC stage run again on the CPU
   from the card's state before it (SMC.get_state/set_state: the
   particles, weights and both generators) with the card's tempering
   parameter: the resampled indices and every sweep's accept flags
   identical, the particles within 1e-9, for every stage whose particles
   the two devices' log targets agree on within 1e-9, the last (T = 1)
   among them (at T >= ~2000 the particles reach near-singular grams,
   where the devices' criteria part by up to 1e-2: such stages are
   printed, not held); SVGD whole within 1e-8, or else each of its 500
   steps again on the CPU from the card's particles before it within
   1e-11, but for a step whose difference the two devices' gradients at
   its particles explain (step_size max|dg| / T: the first steps, from the
   MAP jittered by 1e-3, throw the particles to grams of cond ~1e8).  The
   entry point's SMC run stopped by its log target just after its first
   checkpoint, restored and resumed (restore_checkpoint, resume_restart):
   bitwise the uninterrupted run.  The mixed engine: a population of 32 at n = 256
   (phase 3b's data and user kernel, REML) goes particle by particle (the
   route printed; no graph replay; the engine's kernels launched), within
   1e-9 of the f64 engine member by member.  Printed beside the card's name
   and power limit: the walls, the stages, the ladder, the ESS and
   acceptance rates, population evaluations/s and SVGD steps/s.
4. Times on the card (CUDA events / synchronised host clock): K1 and K2 at
   n = 1000 and 8192 (x is y) and 1000 x 1000 (cross), d = 6, p = 2: events,
   device time warm and with L2 flushed, host issue per call, the byte
   bound and the f64 instruction floor (counted in the built instance's
   SASS), the plain versions; REML value+grad evals/s at n = 1000 and 8192
   (kernels and plain gram); fit+predict wall-clock.
4b. K3/K4/K6 (k = 2)/K7: kernel, plain and library-call ms at the slice's
   shapes (n = 1000) with their bounds (a row whose warm device time is under
   its bound timed again with L2 flushed before each launch), K3's host
   issue per call by layer; K5 at n = 1000 and 8192 (events, device time,
   plain, batched trsm, bound, and its longest dependent chain, counted
   from its order, beside a substitution's); K3 at n = 16384
   (k = 2) against an f64 addmm; K4 at n in {1000, 4099, 8192} (events and profiler device
   time) against an f64 addmm of the same product, with its bound; K7 at
   n = 1000 and 8192 per call (trace_sums, series_sums) and as the pair
   (events, device time warm and with L2 flushed before each call) against
   each call's bound, the pair's one-read bound (H and H^2 read once) and
   its two-call floor (H read by both calls); the noisy model's REML value+grad evals/s at n = 1000 and
   8192 on the mixed and f64 engines in turns; fit+LOO+predict wall-clock
   (first and warm); the rise of torch.cuda.max_memory_allocated over
   what was held before at n = 8192, per engine, for one value+grad and
   for the engine alone (solve_and_logdet and its backward on a fixed K).
4c. K1d, K1m, K7b, K8s and K6's wide variant: kernel, plain and
   library-call ms at the slice's shapes (n = 1000, and K8s at 8192), with
   bound and share (rows under their bound warm, K1m's backward among them:
   device time again with L2 flushed before each launch); K1d and its
   pullback at n = 1000 (d = 6) and 16384 (d = 3): events, device time warm
   and with L2 flushed, host issue per call, plain, torch.cdist, the byte
   bound and the pullback's f64 instruction floor (its f64 instructions an
   entry counted in the built instance's SASS, cuobjdump -sass, over the
   f64 rate); the full-width sample-paths call (nt = 8192, 1024 paths) per
   engine, first (phase 3c) and warm.
4d. K6 (k = 2 and 8), K10b, K10r, K10m and K10t at n = 32768 (per 512-row
   chunk for K10b and K10t), and K5 on the engine's f32 factor there: kernel
   (events and profiler device time), plain, library call
   (K6: multi_dot of the two products; K10r: a dense f64 addmm; K10m: an f64
   addmm), bound; K4 on hi + lo beside K10r, and K10r's share of its bound;
   K10r's recompute pass at n = 51200 (100 panels of 512, random inputs of
   the same shapes) and its panel with the most work (kernel, device, plain,
   bound, share beside K4's); the value and value+grad wall per mode (phase
   3d).
4e. K8r, K8t (b = 512), K9u (n = 16384; the first, a middle and the last
   panel) and K9m (n = 16384): kernel (events and profiler device time),
   plain, library call (K8r: torch.addmm(A, L, L^T, alpha=-1); K8t:
   torch.matmul; K9u: torch.addmm on the same trailing block), bound;
   K8t's and K8r's host issue time per call (time.perf_counter over 300
   calls, the card kept busy) through each layer of its path, beside the
   library call's; refined_cholesky's wall and host issue per call at
   b = 512, its graph against its launch sequence; K8r's device time
   against K4's 64-wide core (K8s) at b = 512 and 488;
   K9u's mma shape probe (m16n8k4, k8, k16 at the first panel: time and
   rate, each held to the plain version), the registers and spills of
   every instance of csrc/syrk_f64.cuh's kernel (K9u, K9s, K4, K4s, K8s),
   of the f32 K9s's and of K8t's, and K9u's first panel at b = 256, 512, 1024 (a tile's
   fixed part and its k loop's rate); the whole blocked factor
   at n = 16384 and 51200 against torch.linalg.cholesky_ex; phase 3e's
   walls and peak rises.
4f. K9s at n = 16384 on the one-rank slab (the first, a middle and the last
   panel) and on the second rank's slab of two (first panel), in f64 and in
   f32 (phase 3g's mixed engine; its bound at the f32 peak of the CUDA
   cores): kernel (events and profiler device time), plain, torch.addmm on
   the same trailing block, bound; K4s on the one-rank slab and K4 at the
   same n (phase 3e(b)'s resident mixed branch) against an f64 addmm; K6's
   slab form (k = 2) on the one-rank slab and the second rank's of two
   against multi_dot.
5. Where the time goes: torch.profiler over the noisy model's REML
   value+grad at n = 1000 and 8192, mixed and f64 engines, over one
   streamed ff value+grad at n = 32768, and over one resident f64
   value+grad at n = 16384 through the mesh, device time per evaluation by
   kernel group.

``python3 chip_smoke.py --compare ROOT`` instead times K1 and K2 (phase
4's timings, with digests, and phase 4's REML value+grad rates through
them), K8s (n = 1000 and
8192), K8t and K8r (b = 512, with their host issue time), K3 (n = 1000,
k = 2, with its host issue time) and refined_cholesky per call (b = 512),
K5 (n = 1000, 8192 and 32768), K6 (k = 2, n = 1000 and 32768), the K7
pair (n = 1000 and 8192) and K1d and its pullback (phase 4c's K1d timings:
n = 1000, d = 6 and n = 16384, d = 3, with their host issue time), runs
phases 4b's and 4f's timings of K4, K4s and
K9s (f64, f32), and times K10m, K10r (from the pair) and K10t (a 512-row
chunk) at n = 32768 and K10r's recompute pass at
n = 51200, and runs the resident f64 REML value+grad at n = 4096 and
16384, the
mixed engine's value+grad rate at n = 1000 and one streamed REML
value+grad per mode (ff at n = 32768, recompute at n = 51200), on the
gpmp_tpu_torch package under ROOT alone, with digests of K8s's, K8t's,
K8r's, K3's, K5's, K6's, K7's, K1d's, the K1d pullback's, K4's, K4s's,
K9u's, K9s's, K10m's, K10r's and K10t's outputs
(compare_main), for setting two trees side by side in one call.
``python3 chip_smoke.py --compare ROOT --k1d`` times K1d and its pullback
alone (with their digests), for trees that differ only there, and
``--compare ROOT --gram`` K1 and K2 alone.

The line before the last is {"kernels": [...]}, with each kernel's
least time on the card (bound_ms) computed from this run's shapes against
the H100 SXM's data-sheet peaks (PEAK_*); the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import contextlib
import dataclasses
import functools
import gc
import io
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BOX6 = [[0.0] * 6, [1.0] * 6]
DEVICE = "cuda"
TOL_K1 = {"float64": 1e-12, "float32": 1e-5}
TOL_K2 = {"float64": 1e-9, "float32": 1e-3}
TOL_PATH = 1e-8
# phase 3i: the points of each parameter's profile (selection_criterion_statistics_fast);
# the CPU side evaluates the same 7 x PHASE3I_POINTS grid
PHASE3I_POINTS = 50
# phase 3j: example30's batched REMAP fit (n, d = 6, batch size, LOO's first
# points), the batches of phase 3h's two ranks (4 of 250, 2 a rank), and its
# tolerances: card vs CPU at a fixed p (value and gradient), the fitted
# criteria, covparam (SciPy's flatness), the data-parallel criterion against
# the loader's on the same batches
PHASE3J_N, PHASE3J_BATCH, PHASE3J_LOO, PHASE3J_GLOO_BATCHES = 1000, 200, 400, 4
TOL_3J = {"fixed": 1e-10, "fit": 1e-9, "param": 1e-4, "dp": 1e-12}
# phase 3k: example23's flow at the example's own width and budget
PHASE3K = {"ni": 10, "n_steps_total": 3000, "burnin": 1200, "num_samples": 400,
           "num_warmup": 300, "seed": 0, "max_depth": 10, "delta_max": 1000.0,
           "ckpt_steps": 1000, "ckpt_burnin": 400, "ckpt_blocks": 10,
           # the mixed engine's case: n (>= 192, where it engages), MH steps
           # (half of them burn-in), NUTS samples after as many of warmup
           "mixed_n": 256, "mixed_mh_steps": 200, "mixed_nuts": 10}
# the log target card vs CPU, relative to max(1, |value|): the REMAP
# criterion's f64 floor at this data, not 1e-12: the card's and the CPU's
# factorizations of the same gram differ at ~3e-12; gpmp_tpu's own two
# criteria differ by up to 2.4e-12 at these points, and the port and
# gpmp_tpu on the CPU by up to 8.3e-12 (tests/test_torch_mcmc.py's
# test_remap_criteria_probe)
TOL_3K = {"covparam": 1e-10, "log_target": 1e-11, "mh": 1e-9, "nuts": 1e-9,
          # NUTS accept_stat averages exp(-(H1 - H0)) over a tree's leaves:
          # the log target's floor above, summed over up to 2^10 leaves
          "accept_stat": 1e-10}
# phase 3l: bench_samplers.py's SMC and SVGD budgets on example23's data
# (ni = 8, seed 0), K1p/K2p's shapes (B, n, d): the SMC population, the
# SVGD population, a 134 MB f64 stack; the mixed engine's population
PHASE3L = {"ni": 8, "seed": 0, "smc_particles": 1000, "smc_mh_steps": 20, "T0": 1e6, "T1": 1.0,
           "svgd_particles": 32, "svgd_steps": 500, "neighbours": 64,
           "shapes": ((1000, 8, 1), (32, 8, 1), (64, 512, 6)),
           "mixed_n": 256, "mixed_population": 32}
# K1p against plain (max|diff| / max|plain|); K2p against plain and against
# B single K2 launches, per member relative to its largest component (the
# same terms summed in other orders); the population log target and its
# gradient card vs CPU, |diff| / max(1, |value|) (phase 3k's f64 floor of
# the REMAP criterion, TOL_3K); SMC particles after each stage run again on
# the CPU; SVGD whole (card vs CPU) and step by step; the mixed engine's
# population values against the f64 engine's
TOL_3L = {"K1p plain": 1e-14, "K2p plain": 1e-13, "K2p K2": 1e-14, "target": 1e-11,
          "smc x": 1e-9, "svgd": 1e-8, "svgd step": 1e-11, "mixed": 1e-9}
DEVICE_MS_ATTEMPTS = 6  # profiler windows _device_ms takes to find a whole one
DEVICE_MS_PAD = 32      # spin kernels ahead of _device_ms's launches
L2_FLUSH_BYTES = 64 << 20  # a copy larger than the H100's 50 MB L2, between cold launches
EVAL_SIZES = ((1000, 30), (8192, 10))  # (n, evaluations) for the evals/s rates

# H100 SXM data-sheet peaks (NVIDIA; dense, at the 700 W power limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F64_FLOPS = 34e12         # f64 on the vector units
PEAK_F64_TENSOR_FLOPS = 67e12  # f64 on the tensor cores (matrix products)
PEAK_F32_FLOPS = 67e12         # f32 outside the tensor cores

# phase 2b: kernel vs plain on the card, max|kernel - plain| / max|plain|
TOL_MIXED = {
    # f64 sums over n <= 16384 terms in another order: <= n eps64 relative
    "K3": 1e-12,
    # the float32 build (GPMP_DTYPE=float32) against the plain version in f64
    # on the same f32 inputs: the kernel sums in f64, so R is within one f32
    # rounding of the f64 residual (and its norms of theirs)
    "K3 f32": 1e-6,
    # R = K - L L^T ~ eps32 |K|; the f64 sums in another order differ by up
    # to ~n eps64 |K| ~ 5e-13 |K|, then one f32 rounding
    "K4": 1e-5,
    # the kernel follows the plain version's order (8-wide leaves by
    # substitution, then the doubling levels), but its products sum over k
    # in order where torch's batched products do not: each is off by
    # ~eps32 cond(L) <= 6e-8 * 1e3 = 6e-5 (cond(L) = cond(K)^(1/2) <= 1e3)
    "K5": 1e-4,
    # f64 sums of exact products of f32 values, in another order
    "K7": 1e-12,
}
MIXED_SIZES = (1000, 1024, 4099)  # 4099: a ragged last block for K5
# K5's bases in phase 2b: the engine's TRI_INV_BASE, and a single column,
# one short of a leaf and a power of two below the base (every working size)
K5_BASES = (1, 7, 64, 128)
# K3's k: one column, the engine's 2, an odd one, the most; and phase 3e's n
K3_WIDTHS = (1, 2, 3, 8)
K3_BIG_N = 16384
MIXED_CONDS = (1e3, 1e6)          # the series and the two-level logdet branches
# phase 3b: mixed vs the card's f64 engine at the fitted covparam
TOL_SLICE = {
    "reml": 1e-6,  # bench.py's gate, |v_mixed - v_f64| / max(|v_f64|, 1)
    # BENCHMARKS.md class envelope per component: log s2, log noise, log 1/rho
    "grad": (1e-3, 1e-4),
    # LOO (n_refine sweeps, no early exit): at the fitted covparam cond(K)
    # ~3e6, near the f32 range; measured 1.7e-6 (zloo) on the card
    "loo": 1e-5,
}
# predictions: predict's refined solve keeps the reference's stagnation
# exit (r2 < r2_prev / 4), so at cond(K) ~3e6 it may stop with a residual
# R = B - K X well above f64 roundoff.  Predict's mean and variance are held
# to the error that this R implies to first order (_refine_probe), times
# PREDICT_SLACK for the second-order terms, plus TOL_PATH for f64 roundoff.
PREDICT_SLACK = 2.0
SLICE_N, SLICE_NT, SLICE_D, SLICE_SEED, SLICE_NOISE = 1000, 1000, 6, 7, 0.1
NOISY_EVAL_SIZES = ((1000, 20), (8192, 3))  # (n, evaluations per window)
# phase 4b's K7 times: the slice's n and the mixed n = 8192 path's
K7_SIZES = (SLICE_N, NOISY_EVAL_SIZES[-1][0])
# phase 2c: kernel vs plain on the card, max|kernel - plain| / max|plain|
TOL_2C = {
    # forward: ~3d f64 operations and a sqrt or exp per entry, in another
    # order (FMA contraction) than torch's; f32 within a few ulps
    ("K1d", "float64"): 1e-14, ("K1d", "float32"): 1e-5,
    ("K1m", "float64"): 1e-14, ("K1m", "float32"): 1e-5,
    # pullbacks: f64 sums of n^2 terms in another order (K1d); elementwise (K1m)
    ("K1d pullback", "float64"): 1e-12, ("K1d pullback", "float32"): 1e-5,
    ("K1m backward", "float64"): 1e-12, ("K1m backward", "float32"): 1e-5,
    # the kernel sums the series correction in f64 where the plain version
    # keeps the JAX package's f32 sum: held on diag(K^-1) to the LOO bar
    ("K7b", "float64"): 1e-8,
    # E = K - L L^T in f64, sums in another order: max|dE| <= 1e-12 max|K|
    ("K8s", "float64"): 1e-12,
}
# d = 1, 3 (bench_large_n's), 6 (the slice's): instances of their own (each
# d <= 8 has one); d = 9: the one for d up to MAX_D; 4099: odd rows, the
# scalar-access instances
DIST_SIZES, DIST_DIMS, DIST_P = (1000, 4099), (1, 3, 6, 9), (0, 2, 3)
K8S_SIZES = (1000, 4099, 8192)
# phase 3c: conditional sample paths at full width
PATHS_NT, PATHS_COUNT, PATHS_SEED = 8192, 1024, 8
PATHS_SE = 5.5  # conditioned mean vs predict, in standard errors
TOL_SQRT = 1e-8  # |C C^T - K|_F / |K|_F, tests/test_ops.py's bar
# phase 2d: the streamed engine's kernels vs their plain versions on the card
EPS32 = float(np.finfo(np.float32).eps)
STREAM_SIZES = (1000, 4099, 8192)  # cond(K) ~1e3 and ~1e6 each (MIXED_CONDS)
STREAM_PANEL = 512                 # K10r's panels and K10b/K10t's row chunks
# K10r's panel widths in phase 2d beside STREAM_PANEL: c0 and w not multiples
# of its 64-wide tiles (n = 4099's and 1000's ragged last panels too)
K10R_PANEL_WIDTHS = (STREAM_PANEL, 500, 333)
K10M_WIDTHS = (2, 3, 8)            # K10m's k: the engine's 2, an odd one, the most
K6_WIDTHS = (2, 8, 9, 1001)        # K6's narrow and wide variants
TOL_2D = {
    # y = M r32 and M^T y in f32, summed in another order than cuBLAS's: two
    # sums of <= n products, so |kernel - plain| <= 2 n eps32 (|M|^T |M| |r|)_ij
    # in the worst case; held entrywise, in units of n eps32, at about ten
    # times the largest value measured on an H100 80GB HBM3 (700 W) over
    # phase 2d's inputs, 4.7e-3 (n = 1000, k = 9), rather than at that worst
    # case, so that a dropped row block or tile shows
    "K6": 0.05,
    # both round the same f64 values to f32 (hi) and the remainder (lo)
    "K10b": 0.0,
    # K4's tolerance: f64 sums in another order (~n eps64 |K|), one f32
    # rounding of R ~ eps32 |K|; relative to max|R|
    "K10r": 1e-5,
    # K3's: f64 sums of n products in another order, relative
    "K10m": 1e-12,
    # f64 sums of exact products of f32 values in another order, relative to
    # the sums of the absolute terms
    "K10t": 1e-12,
}
# phase 3d: bench_large_n.py's workload (make_data :47, _build_model :154),
# copied here: that script imports gpmp_tpu
LARGE_N, LARGE_D, LARGE_SEED = 32768, 3, 20260817
LARGE_GRAD_N = 16384  # the gradient gate against the f64 engine (GPMP_STREAM_N forced)
LARGE_CPU_N = 2048    # the card against the port on the CPU (value)
LARGE_RC_N = 51200    # past ff's reach on one 80 GB card: recompute mode
# the REML value against the f64 engine (tests/test_parallel_streamed.py:157's
# bar); the robust branch's, forced on a healthy K (its two-level logdet,
# test_parallel_streamed.py:175's bar); the gradient's class envelope
# (bench_large_n.py:315-316): log s2, the others
TOL_LARGE = {"value": 1e-8, "robust": 1e-6, "grad": (1e-3, 1e-4)}
# ff against recompute, value: ff reads K as K32 + E32 (2^-48 relative per
# entry), recompute the f64 kernel; the ridges differ by an f32 rounding (ff
# takes mean(diag K32), recompute the f64 self-branch diagonal's mean), so
# the two preconditioners' series truncations (each <= c4^1.25 ~ 4e-9
# absolute) differ too; held at 1e-9 relative, ten times under the f64 gate
TOL_FF_RC = 1e-9
LARGE_FIT_MAXITER = 2  # L-BFGS-B iterations of the fit (1 if a value+grad takes > 20 s)
# phase 2e: the resident mesh path's kernels vs their plain versions on the card
# the blocked factor's panel sizes, and ragged last panels it meets (n = 4099
# leaves 3 rows, n = 1000 leaves 488)
K8_PANELS = (3, 256, 488, 512)
K9U_SIZES = (1000, 4099, 16384, 51200)  # K9u at its first, a middle and its last panel
K9M_SIZES = (1000, 4099, 16384)
CHOL_BLOCK = 512                 # auto_shard_block at the path's n
TOL_2E = {
    # E = A - L L^T in f64 (L the f32 factor promoted, |E| ~ eps32 |A|): sums
    # of b products in another order, |dE| <= 2 b eps64 max|A|; held at
    # 1e-13 max|A| (b <= 512)
    "K8r": 1e-13,
    # the guard's sums: sum E^2 (E differs by ~b eps64 / eps32 ~ 1e-6
    # relative) and sum A^2 (exact products in another order)
    "K8r sums": (1e-5, 1e-13),
    # C = beta A + alpha A f(B): each entry a dot product of <= b terms in
    # another order, so |dC| <= 2 b eps64 (|beta||A| + |alpha||A||f(B)|)
    # entrywise; held in those units (<= 1)
    "K8t": 1.0,
    # S - T T^T, b terms in another order: |dS| <= 2 b eps64 (|S| + |T||T|^T)
    # entrywise, held in those units (K6's way)
    "K9u": 1.0,
    # the same f64 operations (a copy, a halving, a sum and a halving)
    "K9m": 0.0,
}
# phase 3e: the resident one-card mesh path at full size
RESIDENT_N = 16384      # (a) f64 fit, predict, LOO; (b) the mixed branch
RESIDENT_MODEL_N = 32768  # (b) the dispatcher's resident choice at phase 3d's n
RESIDENT_BIG_N = 51200  # (c) bench_large_n.py --mode parity on one device
RESIDENT_MAXITER = 2
# --compare's resident f64 value+grad walls, n: timed calls: n = 4096 (8
# panels of 512, whose trailing updates are short, so the panels' issue is
# on the path; ~60 ms a call, so more calls against the host's spread) and
# RESIDENT_N (32 panels, the updates long enough to hide it)
RESIDENT_WALL_SIZES = {4096: 10, RESIDENT_N: 3}
# --compare's K5 and K6 sizes (K5: phase 4b's and 4d's n; K6: the mixed
# engine's refined solves at n = 1000 and the streamed engine's at 32768)
COMPARE_K5_SIZES = (SLICE_N, 8192, 32768)
COMPARE_K6_SIZES = (SLICE_N, 32768)
# phase 4e: the same value+grad at n = 4096, the panels' graph against their
# launch sequence in turns in one process (pairs timed, after a warm pair)
GRAPH_AB_N, GRAPH_AB_PAIRS = 4096, 10
# PARITY_51200_r03.json's reml_oracle: bench_large_n.py's NumPy oracle on the
# same data at its p0 (n = 51200, d = 3)
REML_ORACLE_51200 = -62089.0810059355
TOL_RESIDENT = {
    # (a) the blocked f64 factor against cuSOLVER's at the same covparam:
    # REML relative, gradient max|dg| / max|g|; predict and LOO relative to
    # their largest entry (the variances to the prior variance), at
    # RESIDENT_SLACK kappa(K) eps64 (two backward-stable factorizations)
    "reml": 1e-10, "grad": 1e-7,
    # (b) the mixed branch against (a): REML (bench.py's gate), the gradient
    # within the class envelope (log s2, the others) as phase 3b holds it
    "mixed reml": 1e-6, "mixed grad": (1e-3, 1e-4),
    # (c) the REML against the oracle, predict against cuSOLVER's f64 engine
    "oracle": 1e-10, "predict": 1e-9,
}
RESIDENT_SLACK = 100.0
# phase 2f: K9s (the slab form of K9u) and K9m's slab form against their plain
# versions, on slabs of R = 1 and 2 ranks at n = K9S_N and on a ragged n whose
# two slabs [0, 2050) and [2050, 4099) are straddled by the panel at 1792
K9S_N = RESIDENT_N
K9S_STRADDLE = (4099, (0, 2050, 4099), 1792)
# K4 against plain (2c), K4s against K4 (2f), K4's times (4b): a small n whose
# 64-wide tiles fill few SMs, odd n's narrow copies, and phase 3d's n
K4_SIZES = (1000, 4099, 8192)
TOL_2F = {
    # S - T Mt^T, b terms in another order: |dS| <= 2 b eps64 (|S| + |T||Mt|^T)
    # entrywise, held in those units (K9u's)
    "K9s": 1.0,  # in units of the dtype's eps (f64 and f32)
}
# phase 3f: the repaired second derivatives and point gradient, card vs CPU
# (the f64 engine on both: cuSOLVER's and LAPACK's Cholesky in another
# order, at bench.py's p0, cond(K) ~1e3 from its 1% noise variance)
REPAIR_N = 1000
TOL_REPAIR = {"hessian": 1e-10, "xt grad": 1e-10}
# phases 3g/3h: the group mesh against the one-card path
GROUP_GLOO_N = 8192
GROUP_BACKEND = "nccl"  # phase 3g's 1-rank group
TOL_GROUP = {
    # the same f64 algorithm as the one-card path, its sums in another order
    # (the gathers, the column-oriented solves' panel sums): REML, gradient,
    # predict and LOO, relative to the largest entry
    "one-card": 1e-12,
    # the two fits' covparams after RESIDENT_MAXITER L-BFGS-B steps from p0:
    # gradients 1e-13 apart, moved by the line search's steps
    "fit": 1e-10,
    # the REML through factor= against PARITY_51200_r03.json's oracle
    "oracle": 1e-12,
    # two ranks sharing the card over gloo: the panels' owners sum their
    # parts in another order again
    "gloo": 1e-11,
}


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def rel_err(a, b):
    """max|a - b| / max|b|, as a Python float."""
    scale = float(b.abs().max())
    return float((a - b).abs().max()) / (scale if scale > 0 else 1.0)


def say(*parts):
    print(*parts, flush=True)


# ----------------------------------------------------------------------------
def phase_device_and_build(torch, build):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    say(card)
    say(f"[phase 1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device0 {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build.load()
    t_build = time.perf_counter() - t0
    say(f"[phase 1] kernels built/loaded in {t_build:.2f} s "
        f"(nvcc {build.build_seconds if build.build_seconds is not None else 'cached'} s) "
        f"from {build.build_dir()}")
    if build.source_seconds:
        say("[phase 1] each source's nvcc ended at (s, all started together): " + ", ".join(
            f"{k} {v:.1f}" for k, v in sorted(build.source_seconds.items(), key=lambda kv: kv[1])))
    log = (build.build_dir() / "ptxas.log").read_text() if (
        build.build_dir() / "ptxas.log").exists() else ""
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say("[ptxas] " + line.strip())
    return card


def _inputs(torch, n, m, d, dtype, seed, same):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d))
    x[10:20] = x[0:10]  # duplicated rows: h = 0 off the diagonal
    if same:
        y = x
    else:
        y = rng.uniform(size=(m, d))
        y[:5] = x[:5]  # coincident x/y points
    theta = np.concatenate([[0.3], rng.uniform(-0.5, 1.5, size=d)])
    kbar = rng.normal(size=(n, m))
    dev = torch.device(DEVICE)
    xt = torch.as_tensor(x, dtype=dtype, device=dev)
    yt = xt if same else torch.as_tensor(y, dtype=dtype, device=dev)
    return (xt, yt, torch.as_tensor(theta, dtype=dtype, device=dev),
            torch.as_tensor(kbar, dtype=dtype, device=dev))


# (n, m, d, same): the main path's shapes (1000, d = 6, x is y and the
# cross form), odd and ragged ones (997, 503, 4099: scalar stores and
# copies, ragged tiles), an instance for each d of 1, 3, 6 and the run-time
# d one (9); with GRAM_PS, the degree-3 Horner (p <= 3) and the run-time p
# one (5)
GRAM_CASES = ((1000, 1000, 6, True), (1000, 1000, 6, False), (997, 503, 3, False),
              (1000, 1000, 1, True), (997, 997, 3, True), (1000, 1000, 9, True),
              (1000, 1000, 9, False), (4099, 4099, 6, True), (4099, 1000, 3, False))
GRAM_PS = (0, 1, 2, 3, 5)


def phase_kernels_vs_plain(torch, gram):
    worst = {}
    main_abs = {}
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).replace("torch.", "")
        for ci, (n, m, d, same) in enumerate(GRAM_CASES):
            for p in GRAM_PS:
                x, y, theta, kbar = _inputs(torch, n, m, d, dtype, 100 + ci, same)
                K = gram.matern_gram_cuda(x, y, p, theta, same)
                Kp = gram.matern_gram_plain(x, y, p, theta, same)
                th = theta.clone().requires_grad_(True)
                (gp_,) = torch.autograd.grad(
                    torch.sum(gram.matern_gram_plain(x, y, p, th, same) * kbar), th)
                g = gram.matern_gram_pullback_cuda(kbar, x, y, p, theta, same)
                torch.cuda.synchronize()
                e1 = rel_err(K, Kp)
                e2 = rel_err(g, gp_.double())
                e2_el = float(((g - gp_.double()).abs()
                               / gp_.double().abs().clamp_min(1e-300)).max())
                tag = f"{dname} n={n} m={m} d={d} {'same' if same else 'cross'} p={p}"
                say(f"[phase 2] {tag}: K1 rel {e1:.3e}  K2 rel {e2:.3e} "
                    f"(componentwise {e2_el:.3e})")
                check(torch.isfinite(K).all().item(), f"K1 non-finite: {tag}")
                check(torch.isfinite(g).all().item(), f"K2 non-finite: {tag}")
                check(e1 <= TOL_K1[dname], f"K1 {tag}: rel {e1:.3e} > {TOL_K1[dname]}")
                check(e2 <= TOL_K2[dname], f"K2 {tag}: rel {e2:.3e} > {TOL_K2[dname]}")
                if same:
                    # each pair computed once, written to both places; K_ii
                    # rounded as the plain version rounds it
                    check(torch.equal(K, K.T), f"K1 {tag}: K(x, x) is not exactly symmetric")
                    check(torch.equal(K.diagonal(), Kp.diagonal()),
                          f"K1 {tag}: the diagonal is not the plain version's")
                for key, val in (("K1", e1), ("K2", e2)):
                    worst[(key, dname)] = max(worst.get((key, dname), 0.0), val)
                if dname == "float64" and ci == 0 and p == 2:
                    main_abs["K1"] = float((K - Kp).abs().max())
                    main_abs["K2"] = float((g - gp_).abs().max())
    # K2 reproducibility: same inputs, bitwise same gradient (x is y, cross)
    for ci in (0, 1):
        n, m, d, same = GRAM_CASES[ci]
        x, y, theta, kbar = _inputs(torch, n, m, d, torch.float64, 100 + ci, same)
        g1 = gram.matern_gram_pullback_cuda(kbar, x, y, 2, theta, same)
        g2 = gram.matern_gram_pullback_cuda(kbar, x, y, 2, theta, same)
        check(torch.equal(g1, g2), f"K2 is not bitwise reproducible (same={same})")
    for (key, dname), val in sorted(worst.items()):
        say(f"[phase 2] worst {key} {dname} rel err {val:.3e}")
    return main_abs


# ----------------------------------------------------------------------------
def _problem(gp, n, nt, design="ldrandunif"):
    make = getattr(gp.misc.designs, design)
    xi = make(6, n, BOX6, seed=0)
    zi = gp.misc.testfunctions.hartmann6(xi)
    xt = make(6, nt, BOX6, seed=1)
    zt = gp.misc.testfunctions.hartmann6(xt)
    return xi, zi, xt, zt


def _model(gp, gnp, covparam=None):
    def constant_mean(x, param):
        return gnp.ones((x.shape[0], 1))

    def kernel(x, y, covparam, pairwise=False):
        return gp.kernel.maternp_covariance(x, y, 2, covparam, pairwise)

    return gp.Model(constant_mean, kernel, covparam=covparam)


def _fit_predict(gp, gnp, torch, xi, zi, xt):
    model = _model(gp, gnp)
    t0 = time.perf_counter()
    model, info = gp.kernel.select_parameters_with_reml(model, xi, zi, info=True)
    zpm, zpv = model.predict(xi, zi, xt)
    torch.cuda.synchronize()
    return model, info, zpm, zpv, time.perf_counter() - t0


class _PlainGuard:
    """Makes the plain versions raise on CUDA tensors while active, outside
    an ``exempt()`` block."""

    PLAIN = {
        "gram": ("matern_gram_plain", "matern_gram_pullback_plain",
                 "maternp_kernel_plain", "maternp_kernel_backward_plain"),
        "distance": ("scaled_distance_plain", "scaled_distance_pullback_plain",
                     "scaled_distance_elementwise_plain",
                     "scaled_distance_elementwise_pullback_plain"),
        "mixed": ("residual_plain", "precond_apply_plain", "factorization_residual_plain",
                  "diag_block_inv_plain", "trace_sums_plain", "series_sums_plain",
                  "loo_diag_series_plain", "loo_diag_pairs_plain"),
        "refine": ("sampling_residual_plain", "refine_residual_plain", "tri_product_plain"),
        "chol": ("trailing_update_plain", "murray_phi_plain", "symmetrize_plain",
                 "slab_update_plain", "murray_phi_slab_plain", "symmetrize_slab_plain"),
        "streamed": ("split_rows_plain", "residual_panel_plain", "streamed_residual_ff_plain",
                     "ff_residual_plain", "h_traces_chunk_plain"),
    }

    def __init__(self, *modules):
        self.modules = modules
        self.saved = []

    def __enter__(self):
        for mod in self.modules:
            for name in self.PLAIN[mod.__name__.rsplit(".", 1)[-1]]:
                orig = getattr(mod, name)
                self.saved.append((mod, name, orig))

                def guarded(*args, _orig=orig, _name=name, **kw):
                    if _PlainGuard._exempt == 0 and any(getattr(a, "is_cuda", False)
                                                        for a in args):
                        raise AssertionError(f"{_name} reached with CUDA tensors")
                    return _orig(*args, **kw)

                setattr(mod, name, guarded)
        return self

    def __exit__(self, *exc):
        for mod, name, orig in self.saved:
            setattr(mod, name, orig)

    _exempt = 0

    @staticmethod
    @contextlib.contextmanager
    def exempt():
        _PlainGuard._exempt += 1
        try:
            yield
        finally:
            _PlainGuard._exempt -= 1


def phase_main_path(gp, gnp, gram, torch):
    xi, zi, xt, zt = _problem(gp, 1000, 1000)
    gp.config.set_device(DEVICE)
    gram.K1_LAUNCHES = 0
    gram.K2_LAUNCHES = 0
    with _PlainGuard(gram):
        model, info, zpm, zpv, t_fp = _fit_predict(gp, gnp, torch, xi, zi, xt)
    launches = {"K1": gram.K1_LAUNCHES, "K2": gram.K2_LAUNCHES}
    say(f"[phase 3] main path launches {launches}; fit+predict (first) {t_fp:.3f} s; "
        f"nfev {info.nfev}; REML {info.fun!r}")
    check(launches["K1"] > 0, "K1 was not launched on the main path")
    check(launches["K2"] > 0, "K2 was not launched on the main path")
    check(model.covparam.device.type == DEVICE, "covparam is not on the card")
    covparam = gnp.to_np(model.covparam)
    say(f"[phase 3] covparam {covparam.tolist()}")
    check(np.all(np.isfinite(covparam)), "covparam not finite")
    check(zpm.shape == (1000,) and zpv.shape == (1000,), "prediction shapes")
    check(np.all(np.isfinite(zpm)) and np.all(np.isfinite(zpv)), "predictions not finite")
    rmse = float(np.sqrt(np.mean((zpm - zt) ** 2)))
    say(f"[phase 3] RMSE vs hartmann6 {rmse:.4e} (std(zt) {float(np.std(zt)):.4e})")
    check(rmse < np.std(zt), "RMSE is not below the spread of the test values")

    xi_c, zi_c = gnp.asarray(xi), gnp.asarray(zi)
    v_gpu = float(model.negative_log_restricted_likelihood(model.covparam, xi_c, zi_c))
    gp.config.set_device("cpu")
    try:
        model_cpu = _model(gp, gnp, covparam=covparam)
        xi_h, zi_h = gnp.asarray(xi), gnp.asarray(zi)
        v_cpu = float(model_cpu.negative_log_restricted_likelihood(
            gnp.asarray(covparam), xi_h, zi_h))
        zpm_c, zpv_c = model_cpu.predict(xi, zi, xt)
    finally:
        gp.config.set_device(DEVICE)
    e_v = abs(v_gpu - v_cpu) / abs(v_cpu)
    e_m = float(np.max(np.abs(zpm - zpm_c)) / np.max(np.abs(zpm_c)))
    e_s = float(np.max(np.abs(zpv - zpv_c)) / np.max(np.abs(zpv_c)))
    say(f"[phase 3] card vs CPU at the card's covparam: REML rel {e_v:.3e}, "
        f"mean rel {e_m:.3e}, variance rel {e_s:.3e} (tol {TOL_PATH})")
    check(e_v <= TOL_PATH, f"REML card vs CPU rel {e_v:.3e}")
    check(e_m <= TOL_PATH, f"predict mean card vs CPU rel {e_m:.3e}")
    check(e_s <= TOL_PATH, f"predict variance card vs CPU rel {e_s:.3e}")
    return launches, (xi, zi, xt), t_fp, (model, info, zt)


def _diagnosis_numbers(gp, gnp, torch, model, xi, zi, xt, zt, crit_nograd, crit, p_init):
    """Phase 3i's numbers on the configured device: name -> float or array."""
    from gpmp_tpu_torch import modeldiagnosis as md
    from gpmp_tpu_torch.misc import scoringrules as sr

    covparam = gnp.to_np(model.covparam)
    out = {"initial_val": np.array(crit(p_init))}
    stats = md.selection_criterion_statistics_fast(
        model=model, xi=xi, selection_criterion=crit_nograd, covparam=covparam,
        n_points=PHASE3I_POINTS)
    out["parameter_statistics"] = stats["parameter_statistics"].data
    out["stats fisher_information"] = gnp.to_np(stats["fisher_information"])
    perf = md.compute_performance(model, xi, zi, xtzt=(xt, zt), compute_pit=True)
    out.update({f"perf {k}": np.asarray(gnp.to_np(v), dtype=float) for k, v in perf.items()})
    zpm, zpv = model.predict(xi, zi, xt, convert_out=False)
    sigma = torch.sqrt(zpv)
    lo, hi = float(np.quantile(zt, 0.1)), float(np.quantile(zt, 0.9))
    out["crps"] = gnp.to_np(sr.crps_gaussian(zpm, sigma, zt))
    out["tcrps"] = gnp.to_np(sr.tcrps_gaussian(zpm, sigma, zt, lo, hi))
    out["fisher_information"] = gnp.to_np(model.fisher_information(xi))
    out["fisher_information_torch"] = gnp.to_np(
        model.fisher_information_torch(xi, model.covparam))
    return out


def _exempted(fn):
    def run(*args, **kw):
        with _PlainGuard.exempt():
            return fn(*args, **kw)
    return run


def phase_diagnosis(gp, gnp, gram, distance, mixed, refine, torch, main_data, fit):
    """Phase 3i: the diagnosis of phase 3's fit, on the card and on the CPU."""
    import io

    from gpmp_tpu_torch import modeldiagnosis as md
    from gpmp_tpu_torch.core import fisher

    xi, zi, xt = main_data
    model, info, zt = fit
    covparam = gnp.to_np(model.covparam)
    counters = {"K1": (gram, "K1_LAUNCHES"), "K2": (gram, "K2_LAUNCHES"),
                "K1d": (distance, "K1D_LAUNCHES"), "K1m": (gram, "K1M_LAUNCHES")}
    # Fisher's dK/dtheta and Hessian differentiate the gram twice: under
    # create_graph the gram Functions' backward is their plain composition's
    # VJP (ops/autograd.py), on the card by design, so only those calls may
    # reach a plain version
    fisher_calls = {name: _exempted(getattr(fisher, name)) for name in (
        "fisher_information", "fisher_information_cpd", "fisher_information_torch")}
    _reset(counters)
    t0 = time.perf_counter()
    report = io.StringIO()
    with _PlainGuard(gram, distance, mixed, refine), _Patched(fisher, **fisher_calls):
        with contextlib.redirect_stdout(report):
            md.diag(model, info, xi, zi)
        card = _diagnosis_numbers(gp, gnp, torch, model, xi, zi, xt, zt,
                                  info.selection_criterion_nograd, info.selection_criterion,
                                  info.initial_params)
        torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    launches = _read(counters)
    say(f"[phase 3i] diagnosis on the card {t_card:.3f} s; launches {launches}; report "
        f"{len(report.getvalue().splitlines())} lines")
    check("[Model diagnosis]" in report.getvalue() and "delta_over_sigma" in report.getvalue(),
          "diag printed no report")
    grid_rows = covparam.size * PHASE3I_POINTS
    check(launches["K1"] >= grid_rows,
          f"K1 launched {launches['K1']} times for a profile grid of {grid_rows} rows")
    check(launches["K2"] > 0, "K2 was not launched in the diagnosis phase")

    gp.config.set_device("cpu")
    t0 = time.perf_counter()
    try:
        model_cpu = _model(gp, gnp, covparam=covparam)
        crit_cpu, _, crit_ng, _ = gp.kernel.make_selection_criterion_with_gradient(
            model_cpu, gp.kernel.negative_log_restricted_likelihood, xi, zi)
        cpu = _diagnosis_numbers(gp, gnp, torch, model_cpu, xi, zi, xt, zt, crit_ng,
                                 crit_cpu, info.initial_params)
    finally:
        gp.config.set_device(DEVICE)
    t_cpu = time.perf_counter() - t0
    say(f"[phase 3i] the same on the CPU {t_cpu:.3f} s")
    errs = {}
    for key, ref in cpu.items():
        a = torch.as_tensor(np.asarray(card[key], dtype=float))
        b = torch.as_tensor(np.asarray(ref, dtype=float))
        check(a.shape == b.shape and bool(torch.isfinite(a).all()),
              f"diagnosis {key}: shape {tuple(a.shape)} vs {tuple(b.shape)} or not finite")
        errs[key] = rel_err(a, b)
    say("[phase 3i] card vs CPU rel: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    for key, e in errs.items():
        check(e <= TOL_PATH, f"diagnosis {key} card vs CPU rel {e:.3e}")
    check("matplotlib" not in sys.modules, "the diagnosis phase imported matplotlib")
    return launches, {"card": t_card, "cpu": t_cpu}, errs


def _remap_prior_args(gp, covparam0_prior, xi):
    """The default REMAP's resolved prior hyperparameters as host values (the
    anchor covparam0_prior, logrho_min from xi), for building its criterion
    outside the selection procedure (phase 3h's ranks)."""
    from gpmp_tpu_torch.kernel.prior_helpers import resolve_logsigma2_logrho_prior_args

    (gamma, coverage, alpha, _factor, log_s2_0, logrho_0, logrho_min) = (
        resolve_logsigma2_logrho_prior_args(covparam0_prior=covparam0_prior, xi=xi))
    return {"log_sigma2_0": float(log_s2_0), "gamma": gamma, "sigma2_coverage": coverage,
            "alpha": alpha, "logrho_min": gp.num.to_np(logrho_min),
            "logrho_0": gp.num.to_np(logrho_0)}


def _remap_criterion(gp, gnp, args):
    """functools.partial of the default REMAP objective on ``args``
    (_remap_prior_args' values, as tensors on the configured device)."""
    return functools.partial(
        gp.kernel.neg_log_restricted_posterior_logsigma2_and_logrho_prior,
        log_sigma2_0=gnp.asarray(args["log_sigma2_0"])[0], gamma=args["gamma"],
        sigma2_coverage=args["sigma2_coverage"], alpha=args["alpha"],
        logrho_min=gnp.asarray(args["logrho_min"]), logrho_0=gnp.asarray(args["logrho_0"]))


def _remap_slice(gp, gnp, torch, on_card, counters=None, p_fixed=None):
    """Phase 3j's (a)-(d) on the configured device: numbers, fits and walls.

    (a) example30's flow: Hartmann6 at PHASE3J_N, d = 6, a shuffled
    DataLoader of PHASE3J_BATCH (drop_last), select_parameters_with_remap
    through it, LOO on the first PHASE3J_LOO points and modeldiagnosis.perf;
    (b) the default REMAP on phase 3's arrays; (c) method='lbfgs-device' on
    phase 3's REML from its start, beside SciPy's L-BFGS-B; (d)
    make_data_parallel_criterion on make_mesh() over the loader's stacked
    batches at (a)'s optimum, against (a)'s criterion on the same batches
    (shuffle=False); and the value and gradient of each at ``p_fixed``.
    SciPy's L-BFGS-B fit of (c) and the ms per evaluation run on the card
    only."""
    import io

    from gpmp_tpu_torch import parallel
    from gpmp_tpu_torch.dataloader import DataLoader, Dataset

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    out, fits, walls = {}, {}, {}
    rng = np.random.default_rng(0)
    x30 = rng.uniform(size=(PHASE3J_N, 6))
    z30 = np.asarray(gp.misc.testfunctions.hartmann6(x30))
    dataset = Dataset(gnp.asarray(x30), gnp.asarray(z30))
    loader = DataLoader(dataset, batch_size=PHASE3J_BATCH, shuffle=True, seed=0, drop_last=True)
    if counters is not None:
        _reset(counters)
    t0 = time.perf_counter()
    model_a, info_a = gp.kernel.select_parameters_with_remap(
        _model(gp, gnp), dataloader=loader, info=True)
    sync()
    walls["(a) fit"] = time.perf_counter() - t0
    if counters is not None:
        out["launches"] = _read(counters)
    t0 = time.perf_counter()
    xe, ze = x30[:PHASE3J_LOO], z30[:PHASE3J_LOO]
    loo = model_a.loo(xe, ze)
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        gp.modeldiagnosis.perf(model_a, xe, ze, loo_res=loo)
    sync()
    walls["(a) loo+perf"] = time.perf_counter() - t0
    out["perf_lines"] = len(report.getvalue().splitlines())
    out["loo"] = [gnp.to_np(v) for v in loo]
    fits["a"] = (info_a.fun, gnp.to_np(model_a.covparam), info_a.nfev)

    xi, zi, _xt, _zt = _problem(gp, 1000, 1)
    t0 = time.perf_counter()
    model_b, info_b = gp.kernel.select_parameters_with_remap(_model(gp, gnp), xi, zi, info=True)
    sync()
    walls["(b) fit"] = time.perf_counter() - t0
    fits["b"] = (info_b.fun, gnp.to_np(model_b.covparam), info_b.nfev)

    model_c = _model(gp, gnp)
    crit, pre, _ng, grad = gp.kernel.make_selection_criterion_with_gradient(
        model_c, gp.kernel.negative_log_restricted_likelihood, xi, zi)
    p0 = gnp.to_np(gp.kernel.anisotropic_parameters_initial_guess(model_c, xi, zi))
    t0 = time.perf_counter()
    _x, r_dev = gp.kernel.autoselect_parameters(p0, pre, grad, method="lbfgs-device", info=True)
    sync()
    walls["(c) lbfgs-device"] = time.perf_counter() - t0
    fits["c"] = (r_dev.fun, r_dev.x, r_dev.nfev)
    out["c"] = (r_dev.best_value_returned, r_dev.nit, r_dev.nfev)
    if on_card:
        t0 = time.perf_counter()
        _x, r_sci = gp.kernel.autoselect_parameters(p0, pre, grad, method="L-BFGS-B",
                                                    info=True)
        walls["(c) L-BFGS-B"] = time.perf_counter() - t0
        out["c L-BFGS-B"] = (r_sci.fun, r_sci.nit, r_sci.nfev)

    mesh = parallel.make_mesh()
    ordered = DataLoader(dataset, batch_size=PHASE3J_BATCH, shuffle=False, drop_last=True)
    crit_a = info_a.selection_criterion.__self__.crit  # (a)'s criterion of (p, xb, zb)
    batch_crit = gnp.BatchDifferentiableSelectionCriterion(crit_a, ordered)
    xb, zb = ordered.as_stacked_batches(mesh=mesh)
    vg = parallel.make_data_parallel_criterion(crit_a, mesh)
    p_a = fits["a"][1]
    v, g = vg(p_a, xb, zb)
    out["(d) dp"] = (float(v), gnp.to_np(g))
    out["(d) loader"] = (batch_crit.evaluate(p_a), batch_crit.gradient(p_a))
    # the criterion rebuilt from host values, over phase 3h's batches
    args = _remap_prior_args(gp, info_a["covparam0"], x30)
    crit_h = _remap_criterion(gp, gnp, args)
    vg_h = parallel.make_data_parallel_criterion(
        lambda p, x, z: crit_h(model_a, p, x, z), mesh)
    v5, g5 = vg_h(p_a, xb, zb)
    out["(d) rebuilt"] = (float(v5), gnp.to_np(g5))
    xb4, zb4 = parallel.shard_batches(x30, z30, PHASE3J_GLOO_BATCHES, mesh=mesh)
    v4, g4 = vg_h(p_a, xb4, zb4)
    out["(d) 4 batches"] = (float(v4), gnp.to_np(g4))
    out["gloo_args"] = (args, p_a, x30, z30)

    # ms per evaluation: (a)'s loader criterion (5 batches), (d), (b)'s dense REMAP
    def per_eval(fn, reps=10):
        fn()
        sync()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        return (time.perf_counter() - t) / reps * 1e3

    if on_card:
        walls["ms/eval (a) loader"] = per_eval(lambda: batch_crit.evaluate(p_a))
        walls["ms/eval (d) data-parallel"] = per_eval(lambda: vg(p_a, xb, zb))
        walls["ms/eval (b) dense REMAP"] = per_eval(
            lambda: info_b.selection_criterion(fits["b"][1]))
    if p_fixed is not None:
        out["fixed"] = {
            "(a) loader": (batch_crit.evaluate(p_fixed), batch_crit.gradient(p_fixed)),
            "(b) REMAP": (info_b.selection_criterion(p_fixed),
                          info_b.selection_criterion.__self__.gradient(p_fixed)),
            "(c) REML": (crit(p_fixed), grad(p_fixed)),
            "(d) data-parallel": tuple(np.asarray(gnp.to_np(t), dtype=float)
                                       for t in vg(p_fixed, xb, zb)),
        }
    return out, fits, walls


def phase_remap(gp, gnp, gram, distance, mixed, refine, torch, card):
    """Phase 3j: the REMAP and dataloader slice on the card (the plain
    versions raising on CUDA tensors throughout), then on the CPU."""
    counters = {"K1": (gram, "K1_LAUNCHES"), "K2": (gram, "K2_LAUNCHES"),
                "K1d": (distance, "K1D_LAUNCHES"), "K1m": (gram, "K1M_LAUNCHES")}
    p_fixed = np.array([math.log(0.5)] + [math.log(1 / 0.4)] * 6)
    gp.config.set_device(DEVICE)
    gp.config.set_chol_engine("auto")
    t0 = time.perf_counter()
    with _PlainGuard(gram, distance, mixed, refine):
        card_out, card_fits, card_walls = _remap_slice(gp, gnp, torch, True, counters, p_fixed)
    t_card = time.perf_counter() - t0
    gp.config.set_device("cpu")
    t0 = time.perf_counter()
    try:
        cpu_out, cpu_fits, cpu_walls = _remap_slice(gp, gnp, torch, False, None, p_fixed)
    finally:
        gp.config.set_device(DEVICE)
    t_cpu = time.perf_counter() - t0

    launches, nfev_a = card_out["launches"], card_fits["a"][2]
    say(f"[phase 3j] card {card} | (a) example30 n={PHASE3J_N} d=6 batch {PHASE3J_BATCH}: "
        f"nfev {nfev_a}, REMAP {card_fits['a'][0]!r}, launches {launches}; LOO on "
        f"{PHASE3J_LOO} and perf ({card_out['perf_lines']} lines)")
    say(f"[phase 3j] card {card} | walls on the card {t_card:.3f} s: "
        + ", ".join(f"{k} {v:.3f}" + (" ms" if k.startswith("ms") else " s")
                    for k, v in card_walls.items()))
    say(f"[phase 3j] card {card} | walls on the CPU {t_cpu:.3f} s: "
        + ", ".join(f"{k} {v:.3f}" + (" ms" if k.startswith("ms") else " s")
                    for k, v in cpu_walls.items()))
    j_sci, nit_sci, nfev_sci = card_out["c L-BFGS-B"]
    say(f"[phase 3j] (b) REMAP n=1000 nfev {card_fits['b'][2]} J {card_fits['b'][0]!r}; (c) "
        f"lbfgs-device best_value_returned/nit/nfev {card_out['c']} J "
        f"{card_fits['c'][0]!r}, L-BFGS-B nit/nfev ({nit_sci}, {nfev_sci}) J {j_sci!r}")
    check(launches["K1"] >= 5 * nfev_a, f"K1 launched {launches['K1']} times for nfev {nfev_a}")
    check(launches["K2"] >= 5 * nfev_a, f"K2 launched {launches['K2']} times for nfev {nfev_a}")
    check(card_out["perf_lines"] > 0, "perf printed nothing")
    for v in card_out["loo"]:
        check(v.shape == (PHASE3J_LOO,) and np.all(np.isfinite(v)), "LOO shapes or values")
    best, j_dev = card_out["c"][0], card_fits["c"][0]
    check(best, "lbfgs-device did not return its best value")
    check(j_dev <= j_sci + 1e-6 * max(1.0, abs(j_sci)),
          f"lbfgs-device J {j_dev!r} above L-BFGS-B's {j_sci!r} + 1e-6 max(1, |J|)")

    errs = {}
    for tag in ("(d) dp", "(d) rebuilt"):
        (v, g), (v_l, g_l) = card_out[tag], card_out["(d) loader"]
        errs[f"{tag} vs loader value"] = abs(v - v_l) / abs(v_l)
        errs[f"{tag} vs loader grad"] = rel_err_np(g, g_l)
    for key in errs:
        check(errs[key] <= TOL_3J["dp"], f"phase 3j {key} rel {errs[key]:.3e}")
    for key, (cv, cg) in card_out["fixed"].items():
        pv, pg = cpu_out["fixed"][key]
        errs[f"fixed {key} value"] = abs(float(cv) - float(pv)) / abs(float(pv))
        errs[f"fixed {key} grad"] = rel_err_np(np.asarray(cg, dtype=float),
                                               np.asarray(pg, dtype=float))
        check(errs[f"fixed {key} value"] <= TOL_3J["fixed"]
              and errs[f"fixed {key} grad"] <= TOL_3J["fixed"],
              f"phase 3j card vs CPU at the fixed p, {key}")
    for key, (j_card, c_card, _n) in card_fits.items():
        j_cpu, c_cpu, _n = cpu_fits[key]
        errs[f"fit {key} J"] = abs(j_card - j_cpu) / abs(j_cpu)
        errs[f"fit {key} covparam"] = float(np.max(np.abs(np.asarray(c_card) - c_cpu)))
        check(errs[f"fit {key} J"] <= TOL_3J["fit"], f"phase 3j fit {key}: J card vs CPU")
        check(errs[f"fit {key} covparam"] <= TOL_3J["param"],
              f"phase 3j fit {key}: covparam card vs CPU")
    say("[phase 3j] errors (rel; covparam max abs): "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    args, p_a, x30, z30 = card_out["gloo_args"]
    ref = {"args": args, "p": p_a, "x": x30, "z": z30, "value": card_out["(d) 4 batches"][0],
           "grad": card_out["(d) 4 batches"][1]}
    return launches, {"card": t_card, "cpu": t_cpu, **card_walls}, errs, ref


def _posterior_points(map_p):
    """The MAP and 8 fixed points around it (radius 0.5, every 45 degrees)."""
    angles = np.arange(8) * np.pi / 4
    return [np.asarray(map_p, dtype=float)] + [
        np.asarray(map_p, dtype=float) + 0.5 * np.array([np.cos(a), np.sin(a)]) for a in angles]


class _Interrupted(Exception):
    """A sampler stopped on purpose just after a checkpoint."""


class _StopAfterCheckpoint:
    """A log target that stops its sampler at its first evaluation once the
    checkpoint file exists: a run interrupted just after its first
    checkpoint.  Evaluations go to ``log_prob`` (and its own
    ``potential_and_grad``, the captured graphs)."""

    def __init__(self, log_prob, path):
        self.log_prob, self.path = log_prob, path

    def _check(self):
        if os.path.exists(self.path):
            raise _Interrupted(self.path)

    def __call__(self, q):
        self._check()
        return self.log_prob(q)

    def potential_and_grad(self, q):
        self._check()
        return self.log_prob.potential_and_grad(q)


def _nuts_rerun(gp, gnp, torch, log_prob, samples, info):
    """The sampling phase's transitions run again one by one through the
    public nuts_transition, each from the run's own state (the sample of
    step t - 1 to step t, chain by chain), at the run's final step size and
    mass, with a generator seeded by (t, chain): the same inputs and draws
    on any device.  ``samples`` (num_samples, chains, dim)."""
    n, chains, _dim = samples.shape
    imd = gnp.asarray(1.0 / np.asarray(info["mass_diag_final"], dtype=float))
    out = []
    for t in range(1, n):
        for c in range(chains):
            q, a, nlf, depth, div = gp.mcmc.nuts_transition(
                log_prob, gnp.asarray(samples[t - 1, c]), info["step_size_final"], imd,
                PHASE3K["max_depth"], PHASE3K["delta_max"],
                generator=torch.Generator().manual_seed(t * chains + c))
            out.append((gnp.to_np(q), a, nlf, depth, div))
    return out


def _posterior_flow(gp, gnp, torch, on_card, tmp, counters=None, start=None, rerun=None):
    """Phase 3k's flow on the configured device: example23's REMAP fit,
    the log target at the MAP and around it, adaptive MH and NUTS through
    the param_posterior entry points.  On the card a NUTS run and an MH run
    are interrupted just after their first checkpoint (half way) and
    resumed, and the NUTS run's sampling-phase transitions are run again
    from its states (``_nuts_rerun``).  On the CPU (``start``: the card's
    MAP, where its samplers start) MH runs whole, and ``rerun`` (the card's
    NUTS samples and final step size and mass) is run again from the same
    states: a NUTS run amplifies rounding (its U-turn and adoption
    decisions flip on a change in the last bits, and the trees part), so
    two devices' NUTS are compared one transition at a time."""
    import gpmp_tpu_torch.mcmc  # noqa: F401
    from gpmp_tpu_torch.mcmc import nuts as mnuts
    from gpmp_tpu_torch.mcmc import param_posterior as pp

    P = PHASE3K
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    out, walls = {}, {}

    def stage(name):
        sync()
        walls[name] = time.perf_counter() - t0
        if counters is not None:
            out[f"launches {name}"] = _read(counters)
            _reset(counters)

    def mean(x, param):
        return gnp.ones((x.shape[0], 1))

    def kernel(x, y, covparam, pairwise=False):
        return gp.kernel.maternp_covariance(x, y, 3, covparam, pairwise)

    xi = gp.misc.designs.ldrandunif(1, P["ni"], [[-1], [1]], seed=P["seed"])
    zi = gp.misc.testfunctions.twobumps(xi)
    if counters is not None:
        _reset(counters)
    t0 = time.perf_counter()
    model, info = gp.kernel.select_parameters_with_remap(gp.Model(mean, kernel), xi, zi,
                                                         info=True)
    stage("REMAP")
    map_p = np.asarray(gnp.to_np(info["covparam"]), dtype=float)
    out["map"], out["nfev"] = map_p, int(info.nfev)
    init = map_p if start is None else start
    lp_mh = pp._make_log_prob(pp._resolve_selection_criterion(
        info, None, require_differentiable=False), None, None)
    lp_nuts = pp._make_log_prob(pp._resolve_selection_criterion(
        info, None, require_differentiable=True), None, None)
    with torch.no_grad():
        out["log_target"] = [float(lp_mh(gnp.asarray(p))) for p in _posterior_points(init)]
        K = model.covariance(gnp.asarray(xi), gnp.asarray(xi), gnp.asarray(init))
        out["cond K"] = float(torch.linalg.cond(K.cpu()))

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):  # the burn-in's diagnostics
        s_mh, mh = gp.mcmc.sample_from_selection_criterion_mh(
            info=info, param_initial_states=init, n_steps_total=P["n_steps_total"],
            burnin_period=P["burnin"], n_chains=2, silent=True, plot_chains=False,
            plot_empirical_distributions=False, seed=P["seed"])
    stage("MH")
    out["mh"] = (mh.x.copy(), mh.accept.copy(), mh.burnin_period)
    out["mh_samples"] = gnp.to_np(s_mh)

    if not on_card:
        t0 = time.perf_counter()
        out["nuts rerun"] = _nuts_rerun(gp, gnp, torch, lp_nuts, *rerun)
        stage("NUTS rerun")
        return out, walls

    nuts_kw = dict(num_warmup=P["num_warmup"], target_accept=0.8,
                   max_depth=P["max_depth"], delta_max=P["delta_max"], seed=P["seed"],
                   progress=False, verbose=0)
    t0 = time.perf_counter()
    s_nuts, info_nuts = gp.mcmc.sample_from_selection_criterion_nuts(
        info=info, param_initial_states=init, num_samples=P["num_samples"], n_chains=2,
        **nuts_kw)
    stage("NUTS")
    s_nuts = np.swapaxes(gnp.to_np(s_nuts), 0, 1)  # (num_samples, chains, dim)
    out["nuts"] = (s_nuts, info_nuts)
    t0 = time.perf_counter()
    out["nuts rerun"] = _nuts_rerun(gp, gnp, torch, lp_nuts, s_nuts, info_nuts)
    stage("NUTS rerun")

    # the same NUTS run (nuts_sample, as the entry point calls it) stopped
    # just after its checkpoint half way through the sampling phase, then
    # resumed from that checkpoint
    path = os.path.join(tmp, "nuts.npz")
    t0 = time.perf_counter()
    try:
        gp.mcmc.nuts_sample(
            _StopAfterCheckpoint(lp_nuts, path), np.tile(init, (2, 1)), P["num_samples"],
            options=gp.mcmc.NUTSOptions(checkpoint_path=path,
                                        checkpoint_every=P["num_samples"] // 2), **nuts_kw)
        fail("phase 3k: the NUTS run was not interrupted at its checkpoint")
    except _Interrupted:
        pass
    stage("NUTS interrupted")
    t0 = time.perf_counter()
    s_res, info_res = gp.mcmc.nuts_resume(lp_nuts, path, verbose=0)
    stage("NUTS resumed")
    out["nuts resumed"] = (gnp.to_np(s_res), info_res)

    # an MH run with the entry point's options, whole and stopped just after
    # its first checkpoint (ckpt_blocks adaptation blocks), then resumed
    path = os.path.join(tmp, "mh.npz")
    whole = dataclasses.replace(mh.options, init_msg=None)
    stopped = dataclasses.replace(whole, checkpoint_path=path,
                                  checkpoint_every=P["ckpt_blocks"])
    mh_w = gp.mcmc.MetropolisHastings(lp_mh, options=whole)
    mh_s = gp.mcmc.MetropolisHastings(_StopAfterCheckpoint(lp_mh, path), options=stopped)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        mh_w.scheduler(init, P["ckpt_steps"], P["ckpt_burnin"])
        try:
            mh_s.scheduler(init, P["ckpt_steps"], P["ckpt_burnin"])
            fail("phase 3k: the MH run was not interrupted at its checkpoint")
        except _Interrupted:
            pass
    stage("MH whole and interrupted")
    mh_r = gp.mcmc.MetropolisHastings(lp_mh, options=whole)
    mh_r.restore_checkpoint(path)
    out["mh resumed from"] = mh_r.global_iter
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        mh_r.continue_run()
    stage("MH resumed")
    out["mh whole"] = (mh_w.x.copy(), mh_w.accept.copy())
    out["mh resumed"] = (mh_r.x.copy(), mh_r.accept.copy())

    # ms per NUTS value+grad and per log-target value, each read back (as a
    # leaf and an MH block's first evaluation are)
    q = gnp.asarray(map_p)
    reps = 100
    for name, fn in (("ms per value+grad", lambda: mnuts.potential_and_grad(lp_nuts, q)[0]),
                     ("ms per value", lambda: lp_mh(q))):
        with torch.no_grad() if name == "ms per value" else contextlib.nullcontext():
            for _ in range(5):
                float(fn())
            t0 = time.perf_counter()
            for _ in range(reps):
                float(fn())
        out[name] = (time.perf_counter() - t0) / reps * 1e3
    if counters is not None:
        _reset(counters)
    return out, walls


def _posterior_mixed(gp, gnp, torch, pp, counters):
    """The samplers on the card under the mixed Cholesky engine at n =
    PHASE3K["mixed_n"] (>= 192, where it engages): phase 3b's data and user
    kernel at its p0, REML through the param_posterior entry points (a
    short MH and NUTS run, 2 chains).  The engine reads the card back during
    an evaluation, so the log target is not captured as a graph: it must
    run as written, launch the engine's kernels, and give finite samples;
    its value at p0 is held to the f64 engine's (TOL_SLICE["reml"])."""
    P = PHASE3K
    xi, zi, p0 = _bench_data(P["mixed_n"])
    crit = gp.kernel.make_selection_criterion_with_gradient(
        _bench_model(gp, gnp), gp.kernel.negative_log_restricted_likelihood,
        gnp.asarray(xi), gnp.asarray(zi))[0]
    values = {}
    try:
        for engine in ("auto", "mixed"):
            gp.config.set_chol_engine(engine)
            lp = pp._make_log_prob(pp._resolve_selection_criterion(
                None, crit, require_differentiable=False), None, None)
            with torch.no_grad():
                values[engine] = float(lp(gnp.asarray(p0)))
        replays = pp.GRAPH_REPLAYS
        _reset(counters)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            s_mh, _mh = gp.mcmc.sample_from_selection_criterion_mh(
                selection_criterion=crit, param_initial_states=p0,
                n_steps_total=P["mixed_mh_steps"], burnin_period=P["mixed_mh_steps"] // 2,
                n_chains=2, silent=True, plot_chains=False,
                plot_empirical_distributions=False, seed=P["seed"])
            s_nuts, info_nuts = gp.mcmc.sample_from_selection_criterion_nuts(
                selection_criterion=crit, param_initial_states=p0,
                num_samples=P["mixed_nuts"], num_warmup=P["mixed_nuts"], n_chains=2,
                seed=P["seed"], progress=False, verbose=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        gp.config.set_chol_engine("auto")
    return {"values": values, "launches": _read(counters), "wall": wall,
            "graph replays": pp.GRAPH_REPLAYS - replays,
            "samples": (gnp.to_np(s_mh), gnp.to_np(s_nuts)),
            "leapfrogs": int(info_nuts["n_leapfrog"].sum()
                             + info_nuts["warmup_n_leapfrog"].sum())}


def phase_posterior(gp, gnp, gram, distance, mixed, refine, torch, card):
    """Phase 3k: example23's flow (REMAP, adaptive MH, NUTS, checkpoint and
    resume) on the card with the plain versions raising on CUDA tensors,
    then on the CPU from the card's MAP; the samplers on the card under the
    mixed engine (not captured); gates at TOL_3K."""
    import tempfile

    from gpmp_tpu_torch.mcmc import param_posterior as pp

    counters = {"K1": (gram, "K1_LAUNCHES"), "K2": (gram, "K2_LAUNCHES"),
                "K1d": (distance, "K1D_LAUNCHES"), "K1m": (gram, "K1M_LAUNCHES"),
                "graph replays": (pp, "GRAPH_REPLAYS")}
    P = PHASE3K
    gp.config.set_device(DEVICE)
    gp.config.set_chol_engine("auto")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with _PlainGuard(gram, distance, mixed, refine):
            card_out, card_walls = _posterior_flow(gp, gnp, torch, True, tmp, counters)
        t_card = time.perf_counter() - t0
    mixed_counters = {k: v for k, v in _counters(gram, distance, mixed, refine).items()
                      if k in ("K1d", "K1m", "K3", "K4", "K5", "K6", "K7")}
    with _PlainGuard(gram, distance, mixed, refine):
        mixed_out = _posterior_mixed(gp, gnp, torch, pp, mixed_counters)
    s_c, info_c = card_out["nuts"]
    gp.config.set_device("cpu")
    t0 = time.perf_counter()
    try:
        cpu_out, cpu_walls = _posterior_flow(gp, gnp, torch, False, None,
                                             start=card_out["map"], rerun=(s_c, info_c))
    finally:
        gp.config.set_device(DEVICE)
    t_cpu = time.perf_counter() - t0

    launches = {name: sum(card_out[f"launches {st}"][name]
                          for st in ("REMAP", "MH", "NUTS"))
                for name in counters}
    by_stage = {st: card_out[f"launches {st}"] for st in
                ("REMAP", "MH", "NUTS", "NUTS rerun", "NUTS interrupted", "NUTS resumed",
                 "MH whole and interrupted", "MH resumed")}
    x_c, acc_c, burn_c = card_out["mh"]
    x_h, acc_h, burn_h = cpu_out["mh"]
    nuts_steps = 2 * (P["num_warmup"] + P["num_samples"])
    leapfrogs = int(info_c["n_leapfrog"].sum() + info_c["warmup_n_leapfrog"].sum())
    rates = {"MH steps/s": P["n_steps_total"] / card_walls["MH"],
             "NUTS transitions/s": nuts_steps / card_walls["NUTS"],
             "NUTS leapfrogs": leapfrogs,
             "ms per NUTS value+grad": card_out["ms per value+grad"],
             "ms per log-target value": card_out["ms per value"],
             "CPU MH steps/s": P["n_steps_total"] / cpu_walls["MH"],
             "CPU NUTS transitions/s (rerun)": len(cpu_out["nuts rerun"])
             / cpu_walls["NUTS rerun"],
             "mixed n=%d wall s" % P["mixed_n"]: mixed_out["wall"]}
    say(f"[phase 3k] card {card} | example23 ni={P['ni']} d=1 p=3: REMAP nfev "
        f"{card_out['nfev']} MAP {card_out['map'].tolist()} cond(K) {card_out['cond K']:.3e}; "
        f"MH {P['n_steps_total']} steps (burn-in {burn_c}) x 2 chains; NUTS "
        f"{P['num_samples']} after {P['num_warmup']} x 2 chains, {leapfrogs} leapfrogs; "
        f"launches {launches}, by stage {by_stage}")
    say(f"[phase 3k] card {card} | " + ", ".join(f"{k} {v:.6g}" for k, v in rates.items()))
    say(f"[phase 3k] card {card} | walls on the card {t_card:.3f} s: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in card_walls.items()))
    say(f"[phase 3k] card {card} | walls on the CPU {t_cpu:.3f} s: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in cpu_walls.items()))

    errs = {"REMAP covparam": float(np.max(np.abs(card_out["map"] - cpu_out["map"]))
                                    / np.max(np.abs(cpu_out["map"])))}
    lt_c, lt_h = np.array(card_out["log_target"]), np.array(cpu_out["log_target"])
    errs["log target"] = float(np.max(np.abs(lt_c - lt_h) / np.maximum(1.0, np.abs(lt_h))))
    errs["MH x"] = float(np.max(np.abs(x_c - x_h)))
    rer_c, rer_h = card_out["nuts rerun"], cpu_out["nuts rerun"]
    errs["NUTS q (rerun)"] = max(float(np.max(np.abs(a[0] - b[0]))) for a, b in zip(rer_c, rer_h))
    errs["NUTS accept_stat (rerun)"] = max(abs(a[1] - b[1]) for a, b in zip(rer_c, rer_h))
    rer_same = len(rer_c) == len(rer_h) == 2 * (P["num_samples"] - 1) and all(
        a[2:] == b[2:] for a, b in zip(rer_c, rer_h))
    v64, vmx = mixed_out["values"]["auto"], mixed_out["values"]["mixed"]
    errs["mixed vs f64 log target"] = abs(vmx - v64) / max(1.0, abs(v64))
    say("[phase 3k] card vs CPU: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f"; {len(rer_c)} NUTS transitions run again on both, trees identical {rer_same} "
        f"(tol {TOL_3K})")
    say(f"[phase 3k] card {card} | mixed engine n={P['mixed_n']}: log target {vmx!r} "
        f"(f64 {v64!r}); MH {P['mixed_mh_steps']} steps, NUTS {P['mixed_nuts']} after "
        f"{P['mixed_nuts']}, {mixed_out['leapfrogs']} leapfrogs, 2 chains: launches "
        f"{mixed_out['launches']}, graph replays {mixed_out['graph replays']}, wall "
        f"{mixed_out['wall']:.3f} s")
    x_r, acc_r = card_out["mh resumed"]
    x_w, acc_w = card_out["mh whole"]
    s_r, info_r = card_out["nuts resumed"]
    resumed = {
        f"MH resumed at {card_out['mh resumed from']} of {P['ckpt_steps']}":
            0 < card_out["mh resumed from"] < P["ckpt_steps"]
            and np.array_equal(x_r, x_w) and np.array_equal(acc_r, acc_w),
        f"NUTS resumed at {P['num_samples'] // 2}": (
            np.array_equal(s_r, s_c)
            and all(np.array_equal(info_r[k], info_c[k]) for k in
                    ("accept_stat", "n_leapfrog", "tree_depth", "divergent", "log_prob_trace"))),
    }
    say(f"[phase 3k] resume on the card, bitwise: {resumed}")
    check(errs["REMAP covparam"] <= TOL_3K["covparam"], "phase 3k REMAP covparam card vs CPU")
    check(errs["log target"] <= TOL_3K["log_target"], "phase 3k log target card vs CPU")
    check(np.array_equal(acc_c, acc_h) and burn_c == burn_h, "phase 3k MH accepts card vs CPU")
    check(errs["MH x"] <= TOL_3K["mh"], "phase 3k MH chains card vs CPU")
    check(rer_same, "phase 3k NUTS trees card vs CPU")
    check(errs["NUTS q (rerun)"] <= TOL_3K["nuts"], "phase 3k NUTS samples card vs CPU")
    check(errs["NUTS accept_stat (rerun)"] <= TOL_3K["accept_stat"],
          "phase 3k NUTS accept_stat card vs CPU")
    for key, ok in resumed.items():
        check(ok, f"phase 3k {key} not bitwise")
    check(launches["K1"] > 0 and launches["K2"] > 0, f"phase 3k K1/K2 launches {launches}")
    check(launches["K1d"] == 0 and launches["K1m"] == 0, f"phase 3k K1d/K1m launches {launches}")
    check(by_stage["MH"]["K1"] > 0 and by_stage["NUTS"]["K2"] > 0,
          "phase 3k samplers did not launch K1/K2")
    check(by_stage["MH"]["graph replays"] >= 2 * P["n_steps_total"]
          and by_stage["NUTS"]["graph replays"] >= leapfrogs,
          "phase 3k samplers did not replay the log target's CUDA graphs")
    for name, a in (("MH", card_out["mh_samples"]), ("NUTS", s_c),
                    ("mixed MH", mixed_out["samples"][0]),
                    ("mixed NUTS", mixed_out["samples"][1])):
        check(np.all(np.isfinite(a)), f"phase 3k {name} samples not finite")
    check(errs["mixed vs f64 log target"] <= TOL_SLICE["reml"],
          "phase 3k mixed-engine log target vs f64")
    check(mixed_out["graph replays"] == 0,
          "phase 3k the mixed engine's log target was replayed from a graph")
    check(mixed_out["launches"]["K1d"] > 0 and mixed_out["launches"]["K1m"] > 0
          and sum(mixed_out["launches"][k] for k in ("K3", "K4", "K5", "K6", "K7")) > 0,
          f"phase 3k mixed engine launches {mixed_out['launches']}")
    check("jax" not in sys.modules, "jax was imported")
    return launches, {"card": t_card, "cpu": t_cpu, **card_walls}, errs, rates


# ----------------------------------------------------------------------------
# phase 3l: the population samplers (SMC, SVGD) on K1p/K2p
# ----------------------------------------------------------------------------
def _population_inputs(torch, B, n, d, seed=19):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.uniform(-1.0, 1.0, size=(n, d)), device=DEVICE)
    thetas = torch.tensor(np.c_[0.5 * rng.normal(size=B), rng.normal(scale=0.5, size=(B, d))],
                          device=DEVICE)
    kbars = torch.tensor(rng.normal(size=(B, n, n)), device=DEVICE)
    return x, thetas, kbars


def _population_bounds(B, n, d):
    """K1p writes B n^2 f64 entries (reads x and the thetas); K2p reads the B
    Kbar stacks (and x, the thetas) and writes B (1 + d) f64: bytes."""
    small = 8 * (n * d + B * (d + 1))
    return {"K1p": _bound(8 * B * n * n + small, 0, PEAK_F64_FLOPS),
            "K2p": _bound(8 * B * n * n + small + 8 * B * (d + 1), 0, PEAK_F64_FLOPS)}


def _population_kernels(torch, gram):
    """K1p and K2p at PHASE3L's shapes (x is y, p = 3) against B single K1/K2
    launches and the plain versions on the same CUDA tensors; their times
    (CUDA events, profiler device time) beside B single launches and the
    plain versions, with the byte bound."""
    res = {}
    for B, n, d in PHASE3L["shapes"]:
        x, th, kb = _population_inputs(torch, B, n, d)
        K = gram.matern_gram_population_cuda(x, x, 3, th, True)
        Ks = torch.stack([gram.matern_gram_cuda(x, x, 3, th[b], True) for b in range(B)])
        Kp = gram.matern_gram_population_plain(x, x, 3, th, True)
        g = gram.matern_gram_population_pullback_cuda(kb, x, x, 3, th, True)
        g2 = gram.matern_gram_population_pullback_cuda(kb, x, x, 3, th, True)
        gs = torch.stack([gram.matern_gram_pullback_cuda(kb[b], x, x, 3, th[b], True)
                          for b in range(B)])
        gpl = gram.matern_gram_population_pullback_plain(kb, x, x, 3, th, True)
        torch.cuda.synchronize()
        scale = gpl.abs().amax(dim=1, keepdim=True)
        r = {"K1p bitwise K1": bool(torch.equal(K, Ks)),
             "K1p plain": float((K - Kp).abs().max() / Kp.abs().max()),
             "K1p abs": float((K - Kp).abs().max()),
             "K2p reproducible": bool(torch.equal(g, g2)),
             "K2p plain": float(((g - gpl).abs() / scale).max()),
             "K2p K2": float(((g - gs).abs() / scale).max()),
             "K2p abs": float((g - gpl).abs().max())}
        reps = 20 if B * n * n > 1e6 else 200
        loops = 3 if B > 100 else 10
        calls = {"K1p": lambda: gram.matern_gram_population_cuda(x, x, 3, th, True),
                 "K2p": lambda: gram.matern_gram_population_pullback_cuda(kb, x, x, 3, th, True)}
        r["ms"] = {k: _time_cuda(torch, fn, reps) for k, fn in calls.items()}
        r["device ms"] = {k: _device_ms(torch, fn, reps) for k, fn in calls.items()}
        r["single ms"] = {
            "K1p": _time_cuda(torch, lambda: [gram.matern_gram_cuda(x, x, 3, th[b], True)
                                              for b in range(B)], loops),
            "K2p": _time_cuda(torch, lambda: [gram.matern_gram_pullback_cuda(
                kb[b], x, x, 3, th[b], True) for b in range(B)], loops)}
        r["plain ms"] = {
            "K1p": _time_cuda(torch, lambda: gram.matern_gram_population_plain(x, x, 3, th, True),
                              loops),
            "K2p": _time_cuda(torch, lambda: gram.matern_gram_population_pullback_plain(
                kb, x, x, 3, th, True), loops)}
        r["bounds"] = _population_bounds(B, n, d)
        res[(B, n, d)] = r
        say(f"[phase 3l] K1p/K2p (B, n, d) = ({B}, {n}, {d}), p = 3, x is y: K1p bitwise "
            f"{B} single K1 launches {r['K1p bitwise K1']}, vs plain {r['K1p plain']:.3e}; K2p "
            f"reproducible {r['K2p reproducible']}, vs plain {r['K2p plain']:.3e}, vs {B} single "
            f"K2 {r['K2p K2']:.3e} (per member, relative to its largest component)")
        for k in ("K1p", "K2p"):
            b_ms, b_by = r["bounds"][k]
            say(f"[phase 3l] {k} ({B}, {n}, {d}): kernel {r['ms'][k]:.4f} ms (device "
                f"{_fmt_ms(r['device ms'][k])}), {B} single {'K1' if k == 'K1p' else 'K2'} "
                f"launches {r['single ms'][k]:.4f} ms, plain {r['plain ms'][k]:.4f} ms, library "
                f"none, bound {b_ms * 1e3:.3f} us ({b_by}), share {100 * b_ms / r['ms'][k]:.2f}%")
        del x, th, kb, K, Ks, Kp
        torch.cuda.empty_cache()
    return res


class _StageRecorder:
    """While active, every SMC.step records its stage: the sampler's state
    before and after (get_state), its tempering parameter, the resampled
    indices and every sweep's accept flags."""

    def __init__(self, smc_mod):
        self.mod, self.stages, self.cur = smc_mod, [], None

    def __enter__(self):
        mod, rec = self.mod, self
        self.saved = (mod.SMC.step, mod.ParticlesSet._apply_resample_indices,
                      mod.ParticlesSet._accept)
        step, resample, accept = self.saved

        def rec_step(smc, fn, param, debug=False, debug_plot=False):
            rec.cur = {"param": param, "before": smc.get_state(), "idx": [], "accepts": []}
            step(smc, fn, param, debug, debug_plot)
            rec.cur["after"] = smc.get_state()
            rec.stages.append(rec.cur)
            rec.cur = None

        def rec_resample(ps, idx):
            if rec.cur is not None:
                rec.cur["idx"].append(np.asarray(idx))
            return resample(ps, idx)

        def rec_accept(ps, y, logpy, u):
            a = accept(ps, y, logpy, u)
            if rec.cur is not None:
                rec.cur["accepts"].append(a)
            return a

        mod.SMC.step = rec_step
        mod.ParticlesSet._apply_resample_indices = rec_resample
        mod.ParticlesSet._accept = rec_accept
        return self

    def __exit__(self, *exc):
        (self.mod.SMC.step, self.mod.ParticlesSet._apply_resample_indices,
         self.mod.ParticlesSet._accept) = self.saved
        for st in self.stages:
            st["accepts"] = [a.cpu().numpy() for a in st["accepts"]]


def _population_fit(gp, gnp):
    """Example23's data at PHASE3L's width and its REMAP fit (the
    gaussian-logsigma2-and-logrho prior, as bench_samplers.py): (info, box)."""
    P = PHASE3L

    def mean(x, param):
        return gnp.ones((x.shape[0], 1))

    def kernel(x, y, covparam, pairwise=False):
        return gp.kernel.maternp_covariance(x, y, 3, covparam, pairwise)

    xi = gp.misc.designs.ldrandunif(1, P["ni"], [[-1], [1]], seed=P["seed"])
    zi = gp.misc.testfunctions.twobumps(xi)
    _model, info = gp.kernel.select_parameters_with_remap_gaussian_logsigma2_and_logrho_prior(
        gp.Model(mean, kernel), xi, zi, info=True)
    return info, [[b[0] for b in info.bounds], [b[1] for b in info.bounds]]


def _neighbours(map_p):
    return np.asarray(map_p) + 0.3 * np.random.default_rng(23).normal(
        size=(PHASE3L["neighbours"], len(map_p)))


def _target_at(gp, gnp, torch, pp, population, info, pts):
    """The SMC population criterion's values and the SVGD log target's value
    and gradient (vmap of grad_and_value) at pts, on the configured device."""
    crit = pp._resolve_selection_criterion(info, None, require_differentiable=False)
    lp = pp._make_log_prob(pp._resolve_selection_criterion(info, None, require_differentiable=True),
                           None, None)
    P = gnp.asarray(pts)
    with torch.no_grad():
        vals = population.Criterion(crit)(P)
        grads, lvals = torch.func.vmap(torch.func.grad_and_value(lp))(P)
    return gnp.to_np(vals), gnp.to_np(lvals), gnp.to_np(grads)


def _svgd_start(map_p):
    """The entry point's start: the MAP tiled, jittered by 1e-3 normals of the
    NumPy generator of its seed."""
    P = PHASE3L
    x0 = np.tile(np.asarray(map_p, dtype=float), (P["svgd_particles"], 1))
    return x0 + 1e-3 * np.random.default_rng(P["seed"]).normal(size=x0.shape)


def _smc_interrupted(gp, gnp, pp, smc_mod, info, box, tmp):
    """The entry point's SMC run (its configs, seed and log target) with a
    checkpoint after every ladder stage, stopped by its log target just after
    the first one, restored into a new sampler and resumed: (the resumed
    run's particles, the stage it resumed from)."""
    P = PHASE3L
    path = os.path.join(tmp, "smc.npz")
    lp = pp._tempered_population(pp._resolve_selection_criterion(
        info, None, require_differentiable=False), None, None)

    def stopping(x, T):
        if os.path.exists(path):
            raise _Interrupted(path)
        return lp(x, T)

    def make():
        return smc_mod.SMC(box=box, n=P["smc_particles"],
                           particles_config=smc_mod.ParticlesSetConfig(
                               resample_scheme="residual", covariance_method="normal"),
                           smc_config=smc_mod.SMCConfig(
                               compute_next_logpdf_param_method="ess",
                               mh_steps=P["smc_mh_steps"], checkpoint_path=path),
                           rng=np.random.default_rng(P["seed"]))

    try:
        make().step_with_possible_restart(stopping, P["T0"], P["T1"], 0.5, None)
        fail("phase 3l: the SMC run was not interrupted at its checkpoint")
    except _Interrupted:
        pass
    smc = make()
    smc.restore_checkpoint(path)
    stage = smc.stage, smc._ladder_state["current_logpdf_param"]
    smc.resume_restart(lp)
    return gnp.to_np(smc.particles.x), stage


def _population_card(gp, gnp, torch, pp, population, counters, tmp):
    """Phase 3l's flow on the card: the REMAP fit, then (the counters reset)
    SMC and SVGD through their entry points at bench_samplers.py's budgets,
    each stage of the SMC recorded; then, off the counted path, the SMC run
    stopped at its first checkpoint and resumed, and the log target at the
    MAP's 64 neighbours."""
    from gpmp_tpu_torch.mcmc import smc as smc_mod

    P = PHASE3L
    out, walls = {}, {}
    info, box = _population_fit(gp, gnp)
    out["map"], out["box"] = np.asarray(gnp.to_np(info["covparam"]), dtype=float), box
    out["info"] = info
    _reset(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _StageRecorder(smc_mod) as rec:
        x_smc, smc = gp.mcmc.sample_from_selection_criterion_smc(
            info=info, init_box=box, n_particles=P["smc_particles"],
            initial_temperature=P["T0"], final_temperature=P["T1"],
            mh_steps=P["smc_mh_steps"], seed=P["seed"])
        torch.cuda.synchronize()
    walls["SMC"] = time.perf_counter() - t0
    out["launches SMC"] = _read(counters)
    out["smc"] = (gnp.to_np(x_smc), smc.log, rec.stages, smc.population_route)
    _reset(counters)
    t0 = time.perf_counter()
    x_sv, info_sv = gp.mcmc.sample_from_selection_criterion_svgd(
        info=info, n_particles=P["svgd_particles"], n_steps=P["svgd_steps"], seed=P["seed"],
        progress=False, verbose=0, store_particles_history=True)
    torch.cuda.synchronize()
    walls["SVGD"] = time.perf_counter() - t0
    out["launches SVGD"] = _read(counters)
    out["svgd"] = (gnp.to_np(x_sv), gnp.to_np(info_sv["particles_history"]),
                   gnp.to_np(info_sv["temperature_trace"]), gnp.to_np(info_sv["bandwidth_trace"]),
                   info_sv["route"])
    t0 = time.perf_counter()
    out["resumed"] = _smc_interrupted(gp, gnp, pp, smc_mod, info, box, tmp)
    torch.cuda.synchronize()
    walls["SMC interrupted and resumed"] = time.perf_counter() - t0
    out["target"] = _target_at(gp, gnp, torch, pp, population, info, _neighbours(out["map"]))
    _reset(counters)
    return out, walls


def _population_cpu(gp, gnp, torch, pp, population, card):
    """Phase 3l on the CPU from the card's run: the log target at the card's
    MAP's neighbours; each SMC stage run again from the card's state before
    it (set_state: particles, weights, NumPy and torch generators) with the
    card's tempering parameter, and the CPU's log target at the card's
    particles after the stage against the card's (``smc conditioning``:
    where the stage's particles sit at near-singular grams the two devices'
    criteria part); the SVGD run whole, and each of its steps again from
    the card's particles before it (``svgd step errs``)."""
    from gpmp_tpu_torch.mcmc import smc as smc_mod
    from gpmp_tpu_torch.mcmc import svgd as svgd_mod

    P = PHASE3L
    out, walls = {}, {}
    info, box = _population_fit(gp, gnp)
    out["target"] = _target_at(gp, gnp, torch, pp, population, info, _neighbours(card["map"]))
    lp_smc = pp._tempered_population(pp._resolve_selection_criterion(
        info, None, require_differentiable=False), None, None)
    t0 = time.perf_counter()
    reruns, conditioning = [], []
    for st in card["smc"][2]:
        smc = smc_mod.SMC(box=box, n=P["smc_particles"],
                          particles_config=smc_mod.ParticlesSetConfig(
                              resample_scheme="residual", covariance_method="normal"),
                          smc_config=smc_mod.SMCConfig(compute_next_logpdf_param_method="ess",
                                                       mh_steps=P["smc_mh_steps"]),
                          rng=np.random.default_rng(P["seed"]))
        smc.set_state(*st["before"])
        with _StageRecorder(smc_mod) as rec:
            smc.step(lp_smc, st["param"])
        reruns.append(rec.stages[0])
        card_lp = st["after"][0]["logpx"]
        with torch.no_grad():
            cpu_lp = gnp.to_np(lp_smc(gnp.asarray(st["after"][0]["x"]), st["param"]))
        fin = np.isfinite(card_lp)
        conditioning.append(float(np.max(np.abs(cpu_lp - card_lp)[fin]
                                         / np.maximum(1.0, np.abs(card_lp[fin])))))
    walls["SMC stages again"] = time.perf_counter() - t0
    out["smc stages"], out["smc conditioning"] = reruns, conditioning
    t0 = time.perf_counter()
    x_sv, _info_sv = gp.mcmc.sample_from_selection_criterion_svgd(
        info=info, n_particles=P["svgd_particles"], n_steps=P["svgd_steps"], seed=P["seed"],
        progress=False, verbose=0)
    walls["SVGD"] = time.perf_counter() - t0
    out["svgd"] = gnp.to_np(x_sv)
    # each step again from the card's particles before it
    lp = pp._make_log_prob(pp._resolve_selection_criterion(
        info, None, require_differentiable=True), None, None)
    _x_c, hist, temps, _bw, _route = card["svgd"]
    prev = _svgd_start(card["map"])
    step_errs, grads = [], {}
    t0 = time.perf_counter()
    for s in range(P["svgd_steps"]):
        nxt, _ = svgd_mod.svgd_step(lp, gnp.asarray(prev), step_size=1e-2,
                                    temperature=float(temps[s]))
        step_errs.append(float(np.max(np.abs(gnp.to_np(nxt) - hist[s]))))
        if step_errs[-1] > TOL_3L["svgd step"]:  # the CPU's gradients there
            grads[s] = gnp.to_np(torch.func.vmap(torch.func.grad(lp))(gnp.asarray(prev)))
        prev = hist[s]
    walls["SVGD steps again"] = time.perf_counter() - t0
    out["svgd step errs"], out["svgd step grads"] = np.array(step_errs), grads
    return out, walls


def _svgd_conditioning(gnp, torch, pp, card, cpu):
    """For each SVGD step s run again past TOL_3L["svgd step"]: the card's
    gradients of the log target (vmap of grad, eager) at the card's
    particles before it against the CPU's (``svgd step grads``): (max
    |g_card - g_cpu|, max |g_card - g_cpu| / max(1, |g_cpu|)).  A step moves
    each particle by step_size (kernel @ scores) / n + ..., the scores g / T:
    so the two devices' steps part by at most about step_size max |dg| / T
    where the criterion's own gradients part (a particle at an
    ill-conditioned gram)."""
    lp_card = pp._make_log_prob(pp._resolve_selection_criterion(
        card["info"], None, require_differentiable=True), None, None)
    hist = card["svgd"][1]
    out = {}
    for s, gh in cpu["svgd step grads"].items():
        prev = _svgd_start(card["map"]) if s == 0 else hist[s - 1]
        gc = gnp.to_np(torch.func.vmap(torch.func.grad(lp_card))(
            torch.tensor(prev, dtype=torch.float64, device=DEVICE)))
        out[int(s)] = (float(np.max(np.abs(gc - gh))),
                       float(np.max(np.abs(gc - gh) / np.maximum(1.0, np.abs(gh)))))
    return out


def _population_mixed(gp, gnp, torch, pp, population, counters):
    """A population of PHASE3L["mixed_population"] at n = PHASE3L["mixed_n"]
    (>= 192: the mixed engine engages) of phase 3b's data and user kernel
    (REML) around its p0: under the mixed engine the population criterion
    must go particle by particle (the engine reads the card back), replay no
    graph and launch the engine's kernels; its values against the f64
    engine's, member by member."""
    P = PHASE3L
    xi, zi, p0 = _bench_data(P["mixed_n"])
    crit = gp.kernel.make_selection_criterion_with_gradient(
        _bench_model(gp, gnp), gp.kernel.negative_log_restricted_likelihood,
        gnp.asarray(xi), gnp.asarray(zi))[0]
    single = pp._resolve_selection_criterion(None, crit, require_differentiable=False)
    pts = gnp.asarray(np.asarray(p0) + 0.1 * np.random.default_rng(29).normal(
        size=(P["mixed_population"], len(p0))))
    with torch.no_grad():
        f64 = np.array([float(single(t)) for t in pts])
    pc = population.Criterion(single)
    try:
        gp.config.set_chol_engine("mixed")
        replays = population.GRAPH_REPLAYS
        _reset(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vals = gnp.to_np(pc(pts))
        wall = time.perf_counter() - t0
        launches = _read(counters)
    finally:
        gp.config.set_chol_engine("auto")
    return {"route": pc.route, "graph replays": population.GRAPH_REPLAYS - replays,
            "launches": launches, "wall": wall,
            "err": float(np.max(np.abs(vals - f64) / np.maximum(1.0, np.abs(f64)))),
            "finite": bool(np.all(np.isfinite(vals)))}


def phase_population(gp, gnp, gram, distance, mixed, refine, torch, card):
    """Phase 3l: K1p and K2p against B single K1/K2 launches and their plain
    versions, timed; bench_samplers.py's SMC and SVGD on example23's
    REMAP posterior on the card (the plain versions raising, the counters
    reset after the fit), held to the CPU stage by stage (SMC) and whole and
    step by step (SVGD); an SMC run stopped at its first checkpoint and
    resumed, bitwise; the mixed engine's population particle by particle.
    Gates at TOL_3L.  Returns (launches, max abs errors, times, bounds)."""
    import tempfile

    from gpmp_tpu_torch.mcmc import param_posterior as pp
    from gpmp_tpu_torch.mcmc import population

    P = PHASE3L
    t_phase = time.perf_counter()
    kern = _population_kernels(torch, gram)
    counters = {"K1": (gram, "K1_LAUNCHES"), "K2": (gram, "K2_LAUNCHES"),
                "K1p": (gram, "K1P_LAUNCHES"), "K2p": (gram, "K2P_LAUNCHES"),
                "K1d": (distance, "K1D_LAUNCHES"), "K1m": (gram, "K1M_LAUNCHES"),
                "graph replays": (population, "GRAPH_REPLAYS")}
    gp.config.set_device(DEVICE)
    gp.config.set_chol_engine("auto")
    with tempfile.TemporaryDirectory() as tmp, _PlainGuard(gram, distance, mixed, refine):
        card_out, card_walls = _population_card(gp, gnp, torch, pp, population, counters, tmp)
    mixed_counters = {k: v for k, v in _counters(gram, distance, mixed, refine).items()
                      if k in ("K1d", "K1m", "K3", "K4", "K5", "K6", "K7")}
    with _PlainGuard(gram, distance, mixed, refine):
        mixed_out = _population_mixed(gp, gnp, torch, pp, population, mixed_counters)
    gp.config.set_device("cpu")
    try:
        cpu_out, cpu_walls = _population_cpu(gp, gnp, torch, pp, population, card_out)
    finally:
        gp.config.set_device(DEVICE)

    l_smc, l_svgd = card_out["launches SMC"], card_out["launches SVGD"]
    x_smc, log, stages, route_smc = card_out["smc"]
    x_sv, _hist, _temps, bw, route_sv = card_out["svgd"]
    ladder = [st["param"] for st in stages]
    ess = [s["ess"] for s in log if s["ess"] is not None]
    rates = [r for s in log for r in s["acceptation_rate_sequence"]]
    evals_smc = l_smc["graph replays"]
    say(f"[phase 3l] card {card} | example23 ni={P['ni']} d=1 p=3 seed {P['seed']}, REMAP "
        f"(gaussian logsigma2 + logrho prior) MAP {card_out['map'].tolist()}; SMC "
        f"{P['smc_particles']} particles, T {P['T0']:g} -> {P['T1']:g}, mh_steps "
        f"{P['smc_mh_steps']}: route {route_smc}, {len(stages)} stages, ladder {ladder}, ESS "
        f"{[round(e, 3) for e in ess]}, acceptance rates {[round(r, 3) for r in rates]}; "
        f"launches {l_smc}")
    say(f"[phase 3l] card {card} | SVGD {P['svgd_particles']} x {P['svgd_steps']} steps: route "
        f"{route_sv}, bandwidth first/last {float(bw[0]):.6g}/{float(bw[-1]):.6g}, particle "
        f"mean {x_sv.mean(axis=0).tolist()}; launches {l_svgd}")
    rates_out = {"SMC wall s": card_walls["SMC"], "SVGD wall s": card_walls["SVGD"],
                 "SMC population evaluations/s": evals_smc / card_walls["SMC"],
                 "SVGD steps/s": P["svgd_steps"] / card_walls["SVGD"],
                 "CPU SVGD wall s": cpu_walls["SVGD"]}
    say(f"[phase 3l] card {card} | " + ", ".join(f"{k} {v:.6g}" for k, v in rates_out.items())
        + "; walls on the card: " + ", ".join(f"{k} {v:.3f} s" for k, v in card_walls.items())
        + "; on the CPU: " + ", ".join(f"{k} {v:.3f} s" for k, v in cpu_walls.items()))

    # a step run again past TOL_3L["svgd step"] is not held where the two
    # devices' gradients at its particles explain it (step_size max|dg| / T)
    step_errs, temps = cpu_out["svgd step errs"], card_out["svgd"][2]
    grads = _svgd_conditioning(gnp, torch, pp, card_out, cpu_out)
    excused = {s: step_errs[s] <= 2 * 1e-2 * dg / temps[s] for s, (dg, _rel) in grads.items()}
    errs = {}
    (cv, clv, cg), (hv, hlv, hg) = card_out["target"], cpu_out["target"]
    errs["population criterion"] = float(np.max(np.abs(cv - hv) / np.maximum(1.0, np.abs(hv))))
    errs["log target"] = float(np.max(np.abs(clv - hlv) / np.maximum(1.0, np.abs(hlv))))
    errs["log target gradient"] = float(np.max(np.abs(cg - hg) / np.maximum(1.0, np.abs(hg))))
    # each stage run again: held where the two devices' log targets agree at
    # its particles (TOL_3L["smc x"]); the others are printed
    rows, held = [], []
    for k, (c, h, cond) in enumerate(zip(stages, cpu_out["smc stages"],
                                         cpu_out["smc conditioning"])):
        same_idx = len(c["idx"]) == len(h["idx"]) and all(
            np.array_equal(a, b) for a, b in zip(c["idx"], h["idx"]))
        flags = sum(np.array_equal(a, b) for a, b in zip(c["accepts"], h["accepts"]))
        dx = float(np.max(np.abs(c["after"][0]["x"] - h["after"][0]["x"])))
        rows.append(f"stage {k} T {c['param']:.6g}: log target card vs CPU {cond:.3e}, "
                    f"resampling identical {same_idx}, accept flags identical {flags}/"
                    f"{len(c['accepts'])} ({len(h['accepts'])}), x {dx:.3e}")
        if cond <= TOL_3L["smc x"]:
            held.append((k, same_idx and flags == len(c["accepts"]) == len(h["accepts"]), dx))
    errs["SMC x by stage"] = max((dx for _k, _ok, dx in held), default=float("inf"))
    errs["SVGD whole"] = float(np.max(np.abs(x_sv - cpu_out["svgd"])))
    errs["SVGD by step"] = max((e for s, e in enumerate(step_errs) if s not in grads),
                               default=0.0)
    errs["mixed vs f64"] = mixed_out["err"]
    resumed_x, resumed_at = card_out["resumed"]
    resumed = bool(np.array_equal(resumed_x, x_smc))
    say(f"[phase 3l] card vs CPU: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (tol {TOL_3L})")
    for row in rows:
        say(f"[phase 3l] SMC {row}")
    say(f"[phase 3l] SMC stages held (log target card vs CPU <= {TOL_3L['smc x']:g} at their "
        f"particles): {[k for k, _ok, _dx in held]}, identical {[ok for _k, ok, _dx in held]}; "
        f"SVGD steps past {TOL_3L['svgd step']:g} when run again: "
        + ("none" if not grads else "")
        + ", ".join(f"step {s} ({step_errs[s]:.3e}; the gradients at its particles card vs "
                    f"CPU {dg:.3e}, relative {rel:.3e}: step_size max|dg| / T "
                    f"{1e-2 * dg / temps[s]:.3e}, explained {excused[s]})"
                    for s, (dg, rel) in grads.items()))
    say(f"[phase 3l] SMC stopped after its first checkpoint (stage {resumed_at[0]}, T "
        f"{resumed_at[1]:.6g}) and resumed on the card: bitwise the uninterrupted run {resumed}")
    say(f"[phase 3l] card {card} | mixed engine n={P['mixed_n']}, population "
        f"{P['mixed_population']}: route {mixed_out['route']}, graph replays "
        f"{mixed_out['graph replays']}, launches {mixed_out['launches']}, wall "
        f"{mixed_out['wall']:.3f} s, vs f64 {mixed_out['err']:.3e}")
    say(f"[phase 3l] wall {time.perf_counter() - t_phase:.1f} s")

    for (B, n, d), r in kern.items():
        check(r["K1p bitwise K1"], f"phase 3l K1p ({B}, {n}, {d}) not bitwise K1")
        check(r["K1p plain"] <= TOL_3L["K1p plain"], f"phase 3l K1p ({B}, {n}, {d}) vs plain")
        check(r["K2p reproducible"], f"phase 3l K2p ({B}, {n}, {d}) not reproducible")
        check(r["K2p plain"] <= TOL_3L["K2p plain"], f"phase 3l K2p ({B}, {n}, {d}) vs plain")
        check(r["K2p K2"] <= TOL_3L["K2p K2"], f"phase 3l K2p ({B}, {n}, {d}) vs K2")
    check(route_smc == "graph" and route_sv == "graph", "phase 3l samplers not on the graph route")
    check(l_smc["K1p"] > 0, f"phase 3l SMC did not launch K1p: {l_smc}")
    check(l_svgd["K1p"] > 0 and l_svgd["K2p"] > 0,
          f"phase 3l SVGD did not launch K1p/K2p: {l_svgd}")
    # the single-theta gram runs only in each sampler's route probe (one
    # evaluation of the criterion as written)
    for name, lc in (("SMC", l_smc), ("SVGD", l_svgd)):
        check(lc["K1"] == 1 and lc["K2"] == 0 and lc["K1d"] == 0 and lc["K1m"] == 0,
              f"phase 3l {name} single-theta launches {lc}")
        check(lc["graph replays"] > 0, f"phase 3l {name} replayed no graph")
    # K1p (K2p) runs once a replay, and besides only in the graph's capture
    # (its warm-up and its host-read probe) and SVGD's final log probabilities
    check(l_svgd["graph replays"] == P["svgd_steps"], "phase 3l SVGD: not one replay a step")
    check(l_smc["K1p"] == l_smc["graph replays"] + 2 and l_smc["K2p"] == 0,
          f"phase 3l SMC: not one K1p launch a replay: {l_smc}")
    check(l_svgd["K1p"] == l_svgd["graph replays"] + 3
          and l_svgd["K2p"] == l_svgd["graph replays"] + 2,
          f"phase 3l SVGD: not one K1p and one K2p launch a replay: {l_svgd}")
    check(errs["population criterion"] <= TOL_3L["target"]
          and errs["log target"] <= TOL_3L["target"]
          and errs["log target gradient"] <= TOL_3L["target"], "phase 3l log target card vs CPU")
    check(held and held[-1][0] == len(stages) - 1 and all(ok for _k, ok, _dx in held),
          "phase 3l SMC resampling or accept flags card vs CPU")
    check(errs["SMC x by stage"] <= TOL_3L["smc x"], "phase 3l SMC particles card vs CPU")
    check(errs["SVGD whole"] <= TOL_3L["svgd"]
          or (errs["SVGD by step"] <= TOL_3L["svgd step"] and all(excused.values())),
          "phase 3l SVGD card vs CPU")
    check(resumed and 0 < resumed_at[0], "phase 3l SMC resume not bitwise")
    check(np.all(np.isfinite(x_smc)) and np.all(np.isfinite(x_sv)),
          "phase 3l samples not finite")
    check(mixed_out["route"] == "particles" and mixed_out["graph replays"] == 0,
          f"phase 3l mixed engine route {mixed_out['route']}")
    check(mixed_out["finite"] and errs["mixed vs f64"] <= TOL_3L["mixed"],
          "phase 3l mixed-engine population vs f64")
    check(mixed_out["launches"]["K1d"] > 0 and mixed_out["launches"]["K1m"] > 0
          and sum(mixed_out["launches"][k] for k in ("K3", "K4", "K5", "K6", "K7")) > 0,
          f"phase 3l mixed engine launches {mixed_out['launches']}")
    check("jax" not in sys.modules, "jax was imported")

    smc_shape, svgd_shape = P["shapes"][0], P["shapes"][1]
    launches = {"K1p": l_smc["K1p"] + l_svgd["K1p"], "K2p": l_svgd["K2p"]}
    abs_errs = {k: max(r[f"{k} abs"] for r in kern.values()) for k in ("K1p", "K2p")}
    times = {"K1p": (kern[smc_shape]["ms"]["K1p"], kern[smc_shape]["plain ms"]["K1p"]),
             "K2p": (kern[svgd_shape]["ms"]["K2p"], kern[svgd_shape]["plain ms"]["K2p"])}
    bounds = {"K1p": kern[smc_shape]["bounds"]["K1p"], "K2p": kern[svgd_shape]["bounds"]["K2p"]}
    return launches, abs_errs, times, bounds, {"walls": {**card_walls, **{
        f"CPU {k}": v for k, v in cpu_walls.items()}}, "errs": errs, "rates": rates_out,
        "stages": len(stages), "smc held": [k for k, _ok, _dx in held],
        "svgd steps explained": {s: bool(v) for s, v in excused.items()},
        "mixed": dict(mixed_out)}


# ----------------------------------------------------------------------------
def _time_cuda(torch, fn, reps, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _evals_per_s(gp, gnp, torch, n, reps):
    # a uniform design: the low-discrepancy search costs O(n^2) per try
    xi, zi, _, _ = _problem(gp, n, 1, design="randunif")
    model = _model(gp, gnp)
    crit, _, _, _ = gp.kernel.make_selection_criterion_with_gradient(
        model, gp.kernel.negative_log_restricted_likelihood, xi, zi)
    rng = np.random.default_rng(5)
    p0 = np.concatenate([[math.log(float(np.var(zi)))],
                         -np.log(0.3 * np.ones(6))])
    crit(p0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        v = crit(p0 + 1e-3 * rng.standard_normal(p0.shape))
        if not math.isfinite(v):
            fail(f"criterion not finite at n={n}")
    return reps / (time.perf_counter() - t0)


def phase_times(gp, gnp, gram, torch, main_data):
    """Phase 4: K1 and K2 (_gram_times: n = 1000 and 8192 x is y, the cross
    1000 x 1000, with the f64 instruction floor), the REML value+grad
    rates with the kernels and with the plain gram, fit+predict warm."""
    from gpmp_tpu_torch.ops import _build as build

    res = _gram_times(torch, gram, "phase 4", build=build)
    times = {key: (res[f"{key} n={SLICE_N} m={SLICE_N} same"]["ms"],
                   res[f"{key} n={SLICE_N} m={SLICE_N} same"]["plain_ms"]) for key in ("K1", "K2")}

    import gpmp_tpu_torch.kernel.matern as matern_mod

    rates = {}
    for n, reps in EVAL_SIZES:
        rates[(n, "kernels")] = _evals_per_s(gp, gnp, torch, n, reps)
        kernel_entry = matern_mod.matern_gram
        matern_mod.matern_gram = lambda x, y, p, theta, same=False: (
            gram.matern_gram_plain(x, y, p, theta, same))
        try:
            rates[(n, "plain")] = _evals_per_s(gp, gnp, torch, n, max(3, reps // 2))
        finally:
            matern_mod.matern_gram = kernel_entry
        say(f"[phase 4] REML value+grad n={n} d=6 f64: "
            f"{rates[(n, 'kernels')]:.2f} evals/s with K1/K2, "
            f"{rates[(n, 'plain')]:.2f} evals/s with the plain gram")

    xi, zi, xt = main_data
    _, info, _, _, t_fp = _fit_predict(gp, gnp, torch, xi, zi, xt)
    say(f"[phase 4] fit+predict n=1000 nt=1000 (warm) {t_fp:.3f} s, nfev {info.nfev}")
    return times, rates, t_fp


# ----------------------------------------------------------------------------
# the mixed engine: kernels K3/K4/K5/K7 and the noisy-regression slice
# ----------------------------------------------------------------------------
def _noisy_matern_family(torch, gram, n, conds, seed):
    """Matern p=2 gram on n uniform points in [0, 1]^6 (s2 = 1, rho = 1.5)
    plus tau I, tau set from the gram's eigenvalues so that cond(K) = cond
    (or as near as the gram allows), for each cond in conds from one
    eigendecomposition.  Returns [(K, its condition number)]."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.uniform(size=(n, 6)), device=DEVICE)
    theta = torch.tensor([0.0] + [math.log(1 / 1.5)] * 6, dtype=torch.float64,
                         device=DEVICE)
    G = gram.matern_gram_plain(x, x, 2, theta)
    G = (G + G.T) / 2
    lam = torch.linalg.eigvalsh(G)
    lo, hi = max(float(lam[0]), 0.0), float(lam[-1])
    out = []
    for cond in conds:
        tau = max((hi - cond * lo) / (cond - 1.0), hi / cond * 1e-3)
        K = G + tau * torch.eye(n, dtype=torch.float64, device=DEVICE)
        out.append((K, (hi + tau) / (float(lam[0]) + tau)))
    return out


def _noisy_matern_spd(torch, gram, n, cond, seed):
    return _noisy_matern_family(torch, gram, n, (cond,), seed)[0]


def _k7b_inputs(torch, mixed, K, M32):
    """The series (M32, B32 = (D - D^2) M32) and two-level (G, W) inputs of
    K7b for K, as mixed._inv_diag builds them, and whether the LOO block
    takes the series branch there."""
    n = K.shape[0]
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    M = M32.double()
    D = M @ (K @ M.T) - eye
    D32 = D.float()
    G, W, _DL = mixed._kinv_two_level(D + eye, M)
    series = float(torch.sum(D * D)) < mixed._SERIES_TAU
    return (M32.contiguous(), (D32 - D32 @ D32) @ M32), (G, W), series


def _k3_errs(torch, mixed, K, X, B, K32):
    """K3 on (K, X, B) in f64 and on their f32 roundings (K32 given), each
    launched twice and held bitwise reproducible: (f64 rel err, f32 rel err
    against the plain version in f64 on the f32 inputs, f64 max abs err)."""
    R, nr = mixed.residual_cuda(K, X, B)
    R2, nr2 = mixed.residual_cuda(K, X, B)
    check(torch.equal(R, R2) and torch.equal(nr, nr2), "K3 (f64) not reproducible")
    Rp, nrp = mixed.residual_plain(K, X, B)
    e64 = max(rel_err(R, Rp), rel_err(nr, nrp))
    d64 = float((R - Rp).abs().max())
    X32, B32 = X.float(), B.float()
    R, nr = mixed.residual_cuda(K32, X32, B32)
    R2, nr2 = mixed.residual_cuda(K32, X32, B32)
    check(torch.equal(R, R2) and torch.equal(nr, nr2), "K3 (f32) not reproducible")
    Rp, nrp = mixed.residual_plain(K32.double(), X32.double(), B32.double())
    return e64, max(rel_err(R.double(), Rp), rel_err(nr, nrp)), d64


def phase_mixed_kernels_vs_plain(torch, gram, mixed):
    worst, main_abs, branches = {}, {}, set()
    worst_7b = {}
    for n in MIXED_SIZES:
        for ci, cond in enumerate(MIXED_CONDS):
            K, cond_k = _noisy_matern_spd(torch, gram, n, cond, 31 * n + ci)
            gen = torch.Generator(device=DEVICE).manual_seed(n + ci)
            L32, M32 = mixed._f32_preconditioner(K)
            errs = {}
            K32 = K.float()
            for k in K3_WIDTHS:
                X = torch.randn(n, k, dtype=torch.float64, device=DEVICE, generator=gen)
                B = torch.randn(n, k, dtype=torch.float64, device=DEVICE, generator=gen)
                e3, e3f, d3 = _k3_errs(torch, mixed, K, X, B, K32)
                errs["K3"] = max(errs.get("K3", 0.0), e3)
                errs["K3 f32"] = max(errs.get("K3 f32", 0.0), e3f)
                if k == 2 and n == SLICE_N and ci == 0:
                    main_abs["K3"] = d3
            del K32
            F = mixed.factorization_residual_cuda(K, L32)
            Fp = mixed.factorization_residual_plain(K, L32)
            check(torch.equal(F, F.T), f"K4 not symmetric at n={n}")
            errs["K4"] = rel_err(F, Fp)
            errs["K5"] = 0.0
            for base in K5_BASES:
                Bk = mixed.diag_block_inv_cuda(L32, base)
                Bp = mixed.diag_block_inv_plain(L32, base)
                check(bool((torch.triu(Bk, 1) == 0).all()),
                      f"K5 base {base}: not exactly zero above the diagonal")
                check(torch.equal(Bk, mixed.diag_block_inv_cuda(L32, base)),
                      f"K5 base {base} is not bitwise reproducible")
                e5 = rel_err(Bk, Bp)
                check(math.isfinite(e5) and e5 <= TOL_MIXED["K5"],
                      f"K5 n={n} cond={cond:.0e} base {base}: {e5:.3e}")
                errs["K5"] = max(errs["K5"], e5)
                if base == mixed.TRI_INV_BASE:
                    k5_abs = float((Bk - Bp).abs().max())
            del Bk, Bp
            H = M32 @ (Fp @ M32.T)
            H2 = H @ H
            t, tp = mixed.trace_sums_cuda(H), mixed.trace_sums_plain(H)
            u, up = mixed.series_sums_cuda(H, H2), mixed.series_sums_plain(H, H2)
            check(torch.equal(t, mixed.trace_sums_cuda(H))
                  and torch.equal(u, mixed.series_sums_cuda(H, H2)), "K7 not reproducible")
            errs["K7"] = float(torch.max(torch.abs(torch.cat([t - tp, u - up]))
                                         / torch.abs(torch.cat([tp, up]))))
            # K7b (phase 2c) on the same inputs: the series sums, held where the
            # LOO block takes that branch and printed elsewhere, and the
            # two-level sums, held everywhere (f64 on both sides)
            (Ms, Bs), (G, W), series_here = _k7b_inputs(torch, mixed, K, M32)
            d_s = mixed.loo_diag_series_cuda(Ms, Bs, torch.float64)
            d_sp = mixed.loo_diag_series_plain(Ms, Bs, torch.float64)
            d_p, d_pp = mixed.loo_diag_pairs_cuda(G, W), mixed.loo_diag_pairs_plain(G, W)
            check(torch.equal(d_s, mixed.loo_diag_series_cuda(Ms, Bs, torch.float64)),
                  "K7b not reproducible")
            e7s, e7p = rel_err(d_s, d_sp), rel_err(d_p, d_pp)
            tol7 = TOL_2C[("K7b", "float64")]
            say(f"[phase 2c] K7b n={n} cond={cond_k:.2e}: series {e7s:.2e}"
                f"{'' if series_here else ' (branch not taken here, not held)'}, "
                f"two-level {e7p:.2e} (tol {tol7})")
            check(e7p <= tol7 and (e7s <= tol7 or not series_here),
                  f"K7b n={n} cond={cond:.0e}: series {e7s:.3e}, two-level {e7p:.3e}")
            for key, val in (("series", e7s if series_here else 0.0), ("two-level", e7p)):
                worst_7b[key] = max(worst_7b.get(key, 0.0), val)
            if n == SLICE_N and ci == 0:
                main_abs["K7b"] = float((d_s - d_sp).abs().max())
            if n == SLICE_N and ci == 0:
                # the float32 build of K4 (GPMP_DTYPE=float32), against the
                # plain version in f64 on the same f32 inputs: the kernel
                # accumulates in f64, so K4 is within its own tolerance (K3's
                # float32 build is held above, at every n, cond and k)
                K32 = K.float()
                e4 = rel_err(mixed.factorization_residual_cuda(K32, L32),
                             mixed.factorization_residual_plain(K32.double(), L32))
                say(f"[phase 2b] float32 K4 {e4:.2e} (tol {TOL_MIXED['K4']})")
                check(e4 <= TOL_MIXED["K4"], "float32 K4 vs plain")
                main_abs["K4"] = float((F - Fp).abs().max())
                main_abs["K5"] = k5_abs
                main_abs["K7"] = float(torch.max(torch.abs(torch.cat([t - tp, u - up]))))
            # the engine end to end on the card, against the f64 Cholesky
            z = torch.randn(n, dtype=torch.float64, device=DEVICE, generator=gen)
            x, ld = mixed.mp_solve_and_logdet(K, z)
            C = torch.linalg.cholesky(K)
            ld64 = float(2.0 * torch.sum(torch.log(torch.diagonal(C))))
            x64 = torch.cholesky_solve(z[:, None], C)[:, 0]
            branch = "series" if float(t[1]) < mixed._SERIES_TAU else "two-level"
            branches.add(branch)
            e_ld = abs(float(ld) - ld64) / abs(ld64)
            e_x = rel_err(x, x64)
            say(f"[phase 2b] n={n} cond={cond_k:.2e} ({branch}): "
                + " ".join(f"{key} {val:.2e}" for key, val in errs.items())
                + f"; engine logdet rel {e_ld:.2e}, solve rel {e_x:.2e}")
            for key, val in errs.items():
                check(val <= TOL_MIXED[key], f"{key} n={n} cond={cond:.0e}: "
                      f"{val:.3e} > {TOL_MIXED[key]}")
                worst[key] = max(worst.get(key, 0.0), val)
            check(e_ld <= 1e-6 and e_x <= 1e-4, f"engine vs f64 at n={n} cond={cond:.0e}")
    check(branches == {"series", "two-level"}, f"logdet branches run: {sorted(branches)}")
    # K3 at phase 3e's n (one column chunk), k = 2, on a random K (K3 needs
    # no SPD K; a gram at this n costs an eigendecomposition)
    gen = torch.Generator(device=DEVICE).manual_seed(K3_BIG_N)
    K = torch.randn(K3_BIG_N, K3_BIG_N, dtype=torch.float64, device=DEVICE, generator=gen)
    X = torch.randn(K3_BIG_N, 2, dtype=torch.float64, device=DEVICE, generator=gen)
    B = torch.randn(K3_BIG_N, 2, dtype=torch.float64, device=DEVICE, generator=gen)
    e3, e3f, _ = _k3_errs(torch, mixed, K, X, B, K.float())
    say(f"[phase 2b] K3 n={K3_BIG_N} k=2 (random K): f64 {e3:.2e} (tol {TOL_MIXED['K3']}), "
        f"f32 {e3f:.2e} (tol {TOL_MIXED['K3 f32']}), each bitwise reproducible")
    for key, val in (("K3", e3), ("K3 f32", e3f)):
        check(val <= TOL_MIXED[key], f"{key} n={K3_BIG_N}: {val:.3e} > {TOL_MIXED[key]}")
        worst[key] = max(worst[key], val)
    del K, X, B
    for key, val in sorted(worst.items()):
        say(f"[phase 2b] worst {key} rel err {val:.3e} (tol {TOL_MIXED[key]})")
    say(f"[phase 2c] worst K7b rel err, where held: {worst_7b}")
    return main_abs


def _dist_inputs(torch, n, d, dtype, seed):
    """(loginvrho, x, y, dbar) on the card: x with duplicated rows (x[10:20]
    = x[:10]), y with points coincident with x (y[:5] = x[:5])."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d))
    x[10:20] = x[0:10]
    y = rng.uniform(size=(n, d))
    y[:5] = x[:5]
    vals = (rng.uniform(-0.5, 1.5, size=d), x, y, rng.normal(size=(n, n)))
    return [torch.as_tensor(a, dtype=dtype, device=DEVICE) for a in vals]


def phase_new_kernels_vs_plain(torch, gram, distance, mixed, refine):
    """Phase 2c: K1d, K1m and K8s against their plain versions (K7b runs in
    phase 2b's loop, on its inputs)."""
    worst, main_abs = {}, {}

    def held(key, dname, err, tag):
        tol = TOL_2C[(key, dname)]
        check(math.isfinite(err) and err <= tol, f"{key} {tag}: {err:.3e} > {tol}")
        worst[(key, dname)] = max(worst.get((key, dname), 0.0), err)
        return err

    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).replace("torch.", "")
        for n in DIST_SIZES:
            for d in DIST_DIMS:
                l, x, y, dbar = _dist_inputs(torch, n, d, dtype, 1000 + n + d)
                tag = f"{dname} n={n} d={d}"
                D = distance.scaled_distance_cuda(l, x, y)
                Dp = distance.scaled_distance_plain(l, x, y)
                g = distance.scaled_distance_pullback_cuda(dbar, l, x, y)
                gp_ = distance.scaled_distance_pullback_plain(dbar, l, x, y)
                check(torch.equal(g, distance.scaled_distance_pullback_cuda(dbar, l, x, y)),
                      "K1d pullback is not bitwise reproducible")
                # D(x, x) exactly symmetric; the pullback at x is y; Dbar at a
                # base that is not 16-byte aligned takes the scalar-access
                # instance, which sums in the same order: bitwise the same
                Ds = distance.scaled_distance_cuda(l, x, x)
                gs = distance.scaled_distance_pullback_cuda(dbar, l, x, x)
                gsp = distance.scaled_distance_pullback_plain(dbar, l, x, x)
                dbo = torch.empty(n * n + 1, dtype=dtype, device=DEVICE)[1:].view(n, n)
                dbo.copy_(dbar)
                go = distance.scaled_distance_pullback_cuda(dbo, l, x, y)
                db1 = dbar[:, 0].contiguous()
                De = distance.scaled_distance_elementwise_cuda(l, x, y)
                Dep = distance.scaled_distance_elementwise_plain(l, x, y)
                ge = distance.scaled_distance_elementwise_pullback_cuda(db1, l, x, y)
                gep = distance.scaled_distance_elementwise_pullback_plain(db1, l, x, y)
                torch.cuda.synchronize()
                check(bool((D.diagonal()[:5] == 0).all() and (D[10:15, :5].diagonal() == 0).all()
                           and (De[:5] == 0).all() and (Ds.diagonal() == 0).all()),
                      f"K1d {tag}: coincident points do not give 0")
                check(torch.equal(Ds, Ds.T), f"K1d {tag}: D(x, x) is not exactly symmetric")
                check(torch.equal(go, g), f"K1d pullback {tag}: Dbar not 16-byte aligned gives "
                      f"another result")
                errs = [held("K1d", dname, rel_err(D, Dp), tag),
                        held("K1d pullback", dname, rel_err(g, gp_), tag),
                        held("K1d pullback", dname, rel_err(gs, gsp), tag + " x is y"),
                        held("K1d", dname, rel_err(De, Dep), tag + " elementwise"),
                        held("K1d pullback", dname, rel_err(ge, gep), tag + " elementwise")]
                line = (f"[phase 2c] {tag}: K1d {errs[0]:.2e} pullback {errs[1]:.2e} (x is y "
                        f"{errs[2]:.2e}; D(x, x) exactly symmetric, Dbar's base unaligned bitwise "
                        f"the same) elementwise {errs[3]:.2e}/{errs[4]:.2e}; K1m")
                if dname == "float64" and n == SLICE_N and d == SLICE_D:
                    main_abs["K1d"] = float((D - Dp).abs().max())
                    main_abs["K1d pullback"] = float((g - gp_).abs().max())
                for p in DIST_P:
                    K = gram.maternp_kernel_cuda(p, D)
                    Kp = gram.maternp_kernel_plain(p, D)
                    b = gram.maternp_kernel_backward_cuda(p, D, dbar)
                    bp = gram.maternp_kernel_backward_plain(p, D, dbar)
                    e_f = held("K1m", dname, rel_err(K, Kp), f"{tag} p={p}")
                    e_b = held("K1m backward", dname, rel_err(b, bp), f"{tag} p={p}")
                    line += f" p={p} {e_f:.2e}/{e_b:.2e}"
                    if dname == "float64" and n == SLICE_N and d == SLICE_D and p == 2:
                        main_abs["K1m"] = float((K - Kp).abs().max())
                        main_abs["K1m backward"] = float((b - bp).abs().max())
                say(line)
                del D, Dp, dbar, Ds, dbo

    for n in K8S_SIZES:
        fam = _noisy_matern_family(torch, gram, n, MIXED_CONDS, 77 + n)
        for ci, (K, cond_k) in enumerate(fam):
            L32, _M32 = mixed._f32_preconditioner(K)
            E = refine.sampling_residual_cuda(K, L32)
            Ep = refine.sampling_residual_plain(K, L32)
            check(torch.equal(E, E.T), f"K8s not symmetric at n={n}")
            err = float((E - Ep).abs().max()) / float(K.abs().max())
            # K4 (the f64 tensor-core residual) at the same sizes, 8192 beyond
            # phase 2b's: R exactly symmetric, within TOL_MIXED["K4"] of plain;
            # K8s is K4's kernel with an f64 output, the same tiles and sums:
            # rounded to f32 it is bitwise K4
            F = mixed.factorization_residual_cuda(K, L32)
            e4 = rel_err(F, mixed.factorization_residual_plain(K, L32))
            same4 = torch.equal(E.float(), F)
            say(f"[phase 2c] K8s n={n} cond={cond_k:.2e}: max|dE|/max|K| {err:.2e}, f32(E) "
                f"bitwise K4 {same4}; K4 (tile {mixed.RESIDUAL_TILE}) rel {e4:.2e} (tol "
                f"{TOL_MIXED['K4']}), exactly symmetric {torch.equal(F, F.T)}")
            held("K8s", "float64", err, f"n={n} cond={cond_k:.2e}")
            check(same4, f"K8s rounded to f32 is not bitwise K4 at n={n}")
            check(torch.equal(F, F.T), f"K4 not symmetric at n={n}")
            check(e4 <= TOL_MIXED["K4"], f"K4 n={n} cond={cond_k:.2e}: {e4:.3e}")
            if n == SLICE_N and ci == 0:
                main_abs["K8s"] = float((E - Ep).abs().max())
            del F
        del fam, K, E, Ep
    for (key, dname), val in sorted(worst.items()):
        say(f"[phase 2c] worst {key} {dname} {val:.3e} (tol {TOL_2C[(key, dname)]})")
    return main_abs


def _bench_data(n, seed=SLICE_SEED, d=SLICE_D):
    """bench.py's data and p0 (bench.py:250-287)."""
    rng = np.random.default_rng(seed)
    xi = rng.uniform(size=(n, d))
    zi = (np.sin(3 * xi[:, 0]) + 0.5 * np.cos(5 * xi[:, 1])
          + SLICE_NOISE * rng.normal(size=n))
    p0 = np.concatenate([[np.log(np.var(zi))], [2 * np.log(0.1) + np.log(np.var(zi))],
                         -np.log(np.std(xi, axis=0))])
    return xi, zi, p0


def _bench_model(gp, gnp, covparam=None):
    """bench.py's user kernel: Matern p=2 plus a noise variance, constant mean."""
    def constant_mean(x, param):
        return gnp.ones((x.shape[0], 1))

    def kernel(x, y, param, pairwise=False):
        sigma2 = gnp.exp(param[0])
        loginvrho = param[2:]
        if y is x or y is None:
            noise_variance = gnp.exp(param[1])
            if pairwise:
                return sigma2 * gnp.ones((x.shape[0],))
            K = gnp.scaled_distance(loginvrho, x, x)
            return sigma2 * gp.kernel.maternp_kernel(2, K) + (
                noise_variance * gnp.eye(K.shape[0]))
        if pairwise:
            K = gnp.scaled_distance_elementwise(loginvrho, x, y)
        else:
            K = gnp.scaled_distance(loginvrho, x, y)
        return sigma2 * gp.kernel.maternp_kernel(2, K)

    return gp.Model(constant_mean, kernel, covparam=covparam)


def _reml_vg(gp, model, xi, zi, p):
    crit = gp.kernel.make_selection_criterion_with_gradient(
        model, gp.kernel.negative_log_restricted_likelihood, xi, zi)
    return crit[1](p), crit[3](p)


def _fit_loo_predict(gp, gnp, torch, xi, zi, xt, p0):
    model = _bench_model(gp, gnp)
    t0 = time.perf_counter()
    crit, crit_pre, _crit_ng, grad = gp.kernel.make_selection_criterion_with_gradient(
        model, gp.kernel.negative_log_restricted_likelihood, xi, zi)
    covparam, info = gp.kernel.autoselect_parameters(p0, crit_pre, grad, info=True)
    model.covparam = gnp.asarray(covparam)
    loo = model.loo(xi, zi)
    zpm, zpv = model.predict(xi, zi, xt)
    torch.cuda.synchronize()
    return model, info, loo, (zpm, zpv), time.perf_counter() - t0


def _refine_probe(gp, gnp, mixed, torch, covparam, xi, zi, xt, zpm64, zpv64, sweeps=5):
    """Predict's refined solve K X = B = [K_it, P] at covparam (constant
    mean: P = 1, P_t = 1), on the configured device.  Returns

    - cond(K);
    - for the engine's f32 inverse M of the f32 factor and for the library
      triangular solve's: M's relative error against the f64 inverse, and
      r2 = |R|^2 / |B|^2 after each of `sweeps` sweeps without early exit;
    - the relative errors of predict's mean and variance (against zpm64,
      zpv64 from the f64 engine) that the residual R = B - K X of the
      engine's own solve (refined_solve: early exit and all) implies, to
      first order.  With a = K^{-1} K_it, b = K^{-1} P and alpha = K^{-1} z
      exact (f64 Cholesky), the engine's X = [a + da, b + db] has
      K da = -R_a and K db = -R_b, so that per test point
        c = P'b, s = P'a - 1, mu = s / c, dmu = (mu b'R_b - b'R_a) / c,
        d mean = -alpha'R_a + mu alpha'R_b - (z'b) dmu,
        d var  = a'R_a - mu a'R_b + s dmu;
    - r2 of the engine's solve."""
    m = _bench_model(gp, gnp, covparam=gnp.asarray(covparam))
    x_i, x_t, c = gnp.asarray(xi), gnp.asarray(xt), gnp.asarray(covparam)
    z = gnp.asarray(zi)
    K = m.covariance(x_i, x_i, c)
    Kit = m.covariance(x_i, x_t, c)
    nt = Kit.shape[1]
    B = torch.cat([Kit, gnp.ones((x_i.shape[0], 1))], dim=1)
    lam = torch.linalg.eigvalsh(K)
    L32, M32 = mixed._f32_preconditioner(K)
    eye = torch.eye(K.shape[0], dtype=K.dtype, device=K.device)
    Minv = torch.linalg.solve_triangular(L32.double(), eye, upper=False)
    out = {}
    for name, M in (("engine", M32),
                    ("trsm", torch.linalg.solve_triangular(L32, eye.float(), upper=False))):
        X, r2 = mixed._apply(M, B), []
        for _ in range(sweeps):
            R, norms = mixed.residual(K, X, B)
            r2.append(mixed._rel2(norms, K.dtype))
            X = X + mixed._apply(M, R)
        out[name] = (rel_err(M.double(), Minv), r2)

    X = mixed.refined_solve(K, B)
    R = B - K @ X
    C = torch.linalg.cholesky(K)
    X64 = torch.cholesky_solve(B, C)
    alpha = torch.cholesky_solve(z[:, None], C)[:, 0]
    a, b, Ra, Rb = X64[:, :nt], X64[:, nt], R[:, :nt], R[:, nt]
    s = a.sum(0) - 1.0
    mu = s / b.sum()
    dmu = (mu * (b @ Rb) - b @ Ra) / b.sum()
    d_mean = -(alpha @ Ra) + mu * (alpha @ Rb) - (z @ b) * dmu
    d_var = (a * Ra).sum(0) - mu * (a.T @ Rb) + s * dmu
    implied = (float(d_mean.abs().max()) / float(np.max(np.abs(zpm64))),
               float(d_var.abs().max()) / float(np.max(np.abs(zpv64))))
    r2_engine = float((R * R).sum() / (B * B).sum())
    return float(lam[-1] / lam[0]), out, implied, r2_engine


def _reml_grad_terms(gp, gnp, torch, covparam, xi, zi, model=None):
    """The two parts of the REML gradient at covparam, in plain f64 on the
    configured device (constant mean): the trace term 1/2 d(log|K| +
    log|P'K^{-1}P|), which is 1/2 tr(W dK) with W the REML projection, and
    the quadratic term 1/2 d(z'W z), which is -1/2 (Wz)' dK (Wz).  Near
    the optimum they cancel, and each gradient component is a difference of
    two numbers of this size."""
    c = gnp.asarray(covparam).clone().requires_grad_(True)
    x, z = gnp.asarray(xi), gnp.asarray(zi)
    K = (model or _bench_model(gp, gnp)).covariance(x, x, c)
    P = gnp.ones((x.shape[0], 1))
    C = torch.linalg.cholesky(K)
    X = torch.cholesky_solve(torch.cat([z[:, None], P], dim=1), C)
    Cm = torch.linalg.cholesky(P.T @ X[:, 1:])
    u = torch.linalg.solve_triangular(Cm, (P.T @ X[:, 0])[:, None], upper=False)
    ld = 2.0 * (torch.log(torch.diagonal(C)).sum() + torch.log(torch.diagonal(Cm)).sum())
    quad = z @ X[:, 0] - (u * u).sum()
    g_tr = torch.autograd.grad(0.5 * ld, c, retain_graph=True)[0]
    g_q = torch.autograd.grad(0.5 * quad, c)[0]
    return gnp.to_np(g_tr), gnp.to_np(g_q)


def _counters(gram, distance, mixed, refine):
    """name -> (module, attribute) of each launch counter."""
    return {"K1d": (distance, "K1D_LAUNCHES"), "K1d pullback": (distance, "K1D_PULLBACK_LAUNCHES"),
            "K1m": (gram, "K1M_LAUNCHES"), "K1m backward": (gram, "K1M_BACKWARD_LAUNCHES"),
            "K3": (mixed, "K3_LAUNCHES"), "K4": (mixed, "K4_LAUNCHES"),
            "K5": (mixed, "K5_LAUNCHES"), "K6": (mixed, "K6_LAUNCHES"), "K7": (mixed, "K7_LAUNCHES"),
            "K7b": (mixed, "K7B_LAUNCHES"), "K8s": (refine, "K8S_LAUNCHES")}


def _reset(counters):
    for mod, attr in counters.values():
        setattr(mod, attr, 0)


def _read(counters):
    return {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}


def phase_slice(gp, gnp, gram, distance, mixed, refine, torch):
    xi, zi, p0 = _bench_data(SLICE_N)
    xt = np.random.default_rng(SLICE_SEED + 1).uniform(size=(SLICE_NT, SLICE_D))
    zt = np.sin(3 * xt[:, 0]) + 0.5 * np.cos(5 * xt[:, 1])
    gp.config.set_device(DEVICE)
    gp.config.set_chol_engine("mixed")
    counters = {k: v for k, v in _counters(gram, distance, mixed, refine).items() if k != "K8s"}
    _reset(counters)
    with _PlainGuard(gram, distance, mixed, refine):
        model, info, loo, (zpm, zpv), t_first = _fit_loo_predict(
            gp, gnp, torch, xi, zi, xt, p0)
    launches = _read(counters)
    say(f"[phase 3b] slice launches {launches}; fit+LOO+predict (first) {t_first:.3f} s; "
        f"nfev {info.nfev}; REML {info.fun!r}")
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched on the slice's path")
    covparam = np.asarray(info.x)
    say(f"[phase 3b] covparam {covparam.tolist()}")
    check(np.all(np.isfinite(covparam)), "covparam not finite")
    zloo, s2loo, eloo = (gnp.to_np(a) for a in loo)
    check(all(a.shape == (SLICE_N,) and np.all(np.isfinite(a)) for a in (zloo, s2loo, eloo)),
          "LOO outputs not finite or of the wrong shape")
    check(np.all(s2loo > 0), "LOO variances not positive")
    check(zpm.shape == (SLICE_NT,) and np.all(np.isfinite(zpm)) and np.all(np.isfinite(zpv)),
          "predictions not finite or of the wrong shape")
    rmse = float(np.sqrt(np.mean((zpm - zt) ** 2)))
    loo_rmse = float(np.sqrt(np.mean(eloo ** 2)))
    say(f"[phase 3b] test RMSE {rmse:.4e} (std {float(np.std(zt)):.4e}); LOO RMSE {loo_rmse:.4e}")
    check(rmse < np.std(zt), "RMSE is not below the spread of the test values")

    # the preconditioner applications (K6 launches) per REML value+grad
    xi_c, zi_c = gnp.asarray(xi), gnp.asarray(zi)
    k6 = {}
    for name, p in (("p0", p0), ("fit", covparam)):
        m = _bench_model(gp, gnp, covparam=gnp.asarray(covparam))
        mixed.K6_LAUNCHES = 0
        _reml_vg(gp, m, xi_c, zi_c, p)
        k6[name] = mixed.K6_LAUNCHES
    # and per LOO and predict call at the fit (predict's SLICE_NT
    # right-hand sides take K6's wide variant)
    m = _bench_model(gp, gnp, covparam=gnp.asarray(covparam))
    for name, fn in (("loo", lambda: m.loo(xi_c, zi_c)),
                     ("predict", lambda: m.predict(xi, zi, xt))):
        mixed.K6_LAUNCHES = 0
        fn()
        k6[name] = mixed.K6_LAUNCHES
    say(f"[phase 3b] K6 launches per REML value+grad (p0, fit), per LOO and predict call: {k6}")

    # mixed vs the card's f64 engine, at the fitted covparam (and at p0)
    res = {}
    for engine in ("mixed", "f64"):
        gp.config.set_chol_engine(engine)
        m = _bench_model(gp, gnp, covparam=gnp.asarray(covparam))
        res[engine] = (_reml_vg(gp, m, xi_c, zi_c, covparam), _reml_vg(gp, m, xi_c, zi_c, p0),
                       [gnp.to_np(a) for a in m.loo(xi_c, zi_c)], m.predict(xi, zi, xt))
    (vm, gm), (vm0, gm0), loo_m, pred_m = res["mixed"]
    (vf, gf), (vf0, gf0), loo_f, pred_f = res["f64"]
    env = np.array([TOL_SLICE["grad"][0]] + [TOL_SLICE["grad"][1]] * (len(covparam) - 1))
    e_v = abs(vm - vf) / max(abs(vf), 1.0)
    # near the optimum each gradient component is a difference of a trace
    # term and a quadratic term that cancel: its error is held relative to
    # the larger of the two, taken from this run (plain f64 on the card)
    g_tr, g_q = _reml_grad_terms(gp, gnp, torch, covparam, xi, zi)
    floor = np.maximum(np.abs(g_tr), np.abs(g_q))
    e_split = np.max(np.abs(g_tr + g_q - gf) / floor)
    e_g = np.abs(gm - gf) / np.maximum(np.abs(gf), floor)
    e_g0 = np.abs(gm0 - gf0) / np.abs(gf0)
    e_loo = [rel_err_np(a, b) for a, b in zip(loo_m, loo_f)]
    e_pred = [rel_err_np(a, b) for a, b in zip(pred_m, pred_f)]
    say(f"[phase 3b] REML gradient terms at the fit: trace "
        f"{np.array2string(g_tr, precision=3, max_line_width=200)}, quadratic "
        f"{np.array2string(g_q, precision=3, max_line_width=200)}; "
        f"their sum vs the f64 engine's gradient {e_split:.2e} (tol {TOL_PATH})")
    say(f"[phase 3b] mixed vs f64 on the card: REML rel {e_v:.3e}; grad at the fit "
        f"{np.array2string(e_g, precision=2)} (rel to the larger term), at p0 "
        f"{np.array2string(e_g0, precision=2)} (rel); LOO zloo/sigma2loo/eloo "
        f"{e_loo[0]:.2e}/{e_loo[1]:.2e}/{e_loo[2]:.2e}; predict mean/var "
        f"{e_pred[0]:.2e}/{e_pred[1]:.2e}")
    check(e_v <= TOL_SLICE["reml"], f"REML mixed vs f64 rel {e_v:.3e}")
    check(e_split <= TOL_PATH, f"REML gradient terms do not add up: {e_split:.3e}")
    check(np.all(e_g <= env) and np.all(e_g0 <= env), "gradient outside the class envelope")
    check(max(e_loo[:2]) <= TOL_SLICE["loo"], f"LOO mixed vs f64 {e_loo}")
    # predict: held to the error that its refined solve's residual implies
    # (on the card); the CPU's run is printed beside it
    for dev in (DEVICE, "cpu"):
        gp.config.set_device(dev)
        try:
            cond, probe, implied, r2_engine = _refine_probe(
                gp, gnp, mixed, torch, covparam, xi, zi, xt, *pred_f)
        finally:
            gp.config.set_device(DEVICE)
        for name, (e_m, r2) in probe.items():
            say(f"[phase 3b] predict's refined solve on {dev} at the fit, cond(K) {cond:.3e}: "
                f"f32 inverse from the {name}, rel err {e_m:.2e}, r2 by sweep "
                + " ".join(f"{v:.1e}" for v in r2))
        say(f"[phase 3b] on {dev}: the engine's solve leaves r2 {r2_engine:.2e}, which "
            f"implies predict mean/var errors {implied[0]:.2e}/{implied[1]:.2e}")
        if dev == DEVICE:
            tol_pred = [PREDICT_SLACK * e + TOL_PATH for e in implied]
            say(f"[phase 3b] predict mixed vs f64 over what the residual implies: mean "
                f"{e_pred[0] / implied[0]:.3f}, var {e_pred[1] / implied[1]:.3f} "
                f"(tol {PREDICT_SLACK} + {TOL_PATH} / implied)")
            check(e_pred[0] <= tol_pred[0] and e_pred[1] <= tol_pred[1],
                  f"predict mixed vs f64 {e_pred} above what the residual implies {implied}")

    # the card vs the port on the CPU (mixed engine, plain versions): at p0,
    # where cond(K) is moderate and both are exact to f64 roundoff, rel 1e-8;
    # at the fitted covparam (cond(K) ~3e6) bench.py's gate, since there the
    # card's engine is itself only ~1.6e-7 from the exact f64 value (the
    # CPU's f64 engine is printed beside it as the witness)
    gp.config.set_device("cpu")
    try:
        v_cpu = {}
        for engine in ("mixed", "f64"):
            gp.config.set_chol_engine(engine)
            m = _bench_model(gp, gnp, covparam=gnp.asarray(covparam))
            v_cpu[engine] = [float(m.negative_log_restricted_likelihood(
                gnp.asarray(p), gnp.asarray(xi), gnp.asarray(zi))) for p in (covparam, p0)]
    finally:
        gp.config.set_device(DEVICE)
    (v_cpu, v_cpu0), v_cpu64 = v_cpu["mixed"], v_cpu["f64"][0]
    e_c, e_c0 = abs(vm - v_cpu) / abs(v_cpu), abs(vm0 - v_cpu0) / abs(v_cpu0)
    say(f"[phase 3b] card vs CPU (mixed): REML rel {e_c0:.3e} at p0 (tol {TOL_PATH}), "
        f"{e_c:.3e} at the card's covparam (tol {TOL_SLICE['reml']}); at the latter, "
        f"CPU mixed vs CPU f64 {abs(v_cpu - v_cpu64) / abs(v_cpu64):.3e}, "
        f"card f64 vs CPU f64 {abs(vf - v_cpu64) / abs(v_cpu64):.3e}")
    check(e_c0 <= TOL_PATH, f"REML card vs CPU at p0 rel {e_c0:.3e}")
    check(e_c <= TOL_SLICE["reml"], f"REML card vs CPU at the fit rel {e_c:.3e}")
    gp.config.set_chol_engine("auto")
    return launches, (xi, zi, xt, p0, covparam), t_first, k6


def _paths_design(xi):
    """xi plus PATHS_NT - n uniform points in [0, 1]^d (seed PATHS_SEED)."""
    extra = np.random.default_rng(PATHS_SEED).uniform(size=(PATHS_NT - xi.shape[0], xi.shape[1]))
    return np.vstack([xi, extra])


def _conditional_paths(gp, gnp, torch, covparam, xi, zi, xt):
    """The slice at covparam: PATHS_COUNT paths on xt, predict's kriging
    weights, the conditioned paths.  Returns (paths, conditioned paths,
    predict's mean, seconds of the sample_paths call)."""
    model = _bench_model(gp, gnp, covparam=gnp.asarray(covparam))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    zsim = model.sample_paths(xt, PATHS_COUNT)
    torch.cuda.synchronize()
    t_paths = time.perf_counter() - t0
    zpm, _zpv, lam = model.predict(xi, zi, xt, return_lambdas=True)
    zc = model.conditional_sample_paths(zsim, np.arange(xi.shape[0]), zi,
                                        np.arange(xt.shape[0]), lam, convert_out=False)
    torch.cuda.synchronize()
    return zsim, zc, zpm, t_paths


class _FixedNormals:
    """gnp.randn hands out the given normals (on the configured device)."""

    def __init__(self, gnp, eps):
        self.gnp, self.eps = gnp, eps

    def __enter__(self):
        self.orig = self.gnp.randn
        self.gnp.randn = lambda *shape, generator=None: self.eps.to(self.gnp.get_device())
        return self

    def __exit__(self, *exc):
        self.gnp.randn = self.orig


def phase_paths(gp, gnp, gram, distance, mixed, refine, torch, slice_data):
    from gpmp_tpu_torch.core import sample_paths as sp

    xi, zi, _xt, p0, fit = slice_data
    xt = _paths_design(xi)
    gp.config.set_device(DEVICE)
    counters = {k: v for k, v in _counters(gram, distance, mixed, refine).items()
                if k in ("K1d", "K1d pullback", "K1m", "K1m backward", "K5", "K8s")}
    x_c = gnp.asarray(xt)
    launches_p0, t_first, card = None, {}, {}
    for engine in ("mixed", "f64"):
        gp.config.set_chol_engine(engine)
        for name, cp in (("p0", p0), ("fit", fit)):
            _reset(counters)
            before = dict(sp.BRANCHES)
            gnp.set_seed(PATHS_SEED)
            with _PlainGuard(gram, distance, mixed, refine):
                zsim, zc, zpm, t_paths = _conditional_paths(gp, gnp, torch, cp, xi, zi, xt)
            launches = _read(counters)
            branch = "+".join(k for k, v in sp.BRANCHES.items() if v != before[k])
            tag = f"{engine} at {name}"
            check(tuple(zsim.shape) == (PATHS_NT, PATHS_COUNT) and zsim.is_cuda,
                  f"paths {tag}: shape {tuple(zsim.shape)}")
            check(bool(torch.isfinite(zc).all()), f"conditioned paths {tag} not finite")
            check(launches["K1d"] > 0 and launches["K1m"] > 0,
                  f"the gram of {tag} did not go through K1d/K1m: {launches}")
            # the factor the path used, and how well it reproduces K
            K = _bench_model(gp, gnp).covariance(x_c, x_c, gnp.asarray(cp))
            C = sp.sampling_factor(K)
            e_sqrt = float(torch.linalg.norm(C @ C.T - K) / torch.linalg.norm(K))
            del C
            # the conditioned mean against predict, in standard errors
            zpm_t = torch.as_tensor(zpm, device=DEVICE)
            se = zc.std(dim=1) / math.sqrt(PATHS_COUNT)
            dev = (zc.mean(dim=1) - zpm_t).abs()
            z = float((dev / se.clamp_min(1e-300)).max())
            say(f"[phase 3c] {tag}: branch {branch}; launches {launches}; "
                f"sample_paths {t_paths:.3f} s (first); |CC'-K|/|K| {e_sqrt:.2e} "
                f"(tol {TOL_SQRT}); conditioned mean vs predict, max {z:.2f} standard errors "
                f"(tol {PATHS_SE})")
            check(e_sqrt < TOL_SQRT, f"|CC'-K|/|K| {e_sqrt:.3e} {tag}")
            check(z <= PATHS_SE, f"conditioned mean {z:.2f} standard errors from predict, {tag}")
            if (engine, name) == ("mixed", "p0"):
                check(branch == "sampling_sqrt",
                      f"the mixed engine at p0 took {branch!r}, not sampling_sqrt")
                check(launches["K5"] > 0 and launches["K8s"] > 0,
                      f"K5/K8s not launched on the mixed engine at p0: {launches}")
                launches_p0 = launches
            if name == "p0":
                t_first[engine] = t_paths
            if engine == "f64":
                lam = torch.linalg.eigvalsh(K)
                card[name] = (zsim, zc, float(lam[-1] / lam[0]))
            del K, zsim, zc

    # the card against the port on the CPU, f64 engine, the same normals
    gp.config.set_chol_engine("f64")
    for name, cp in (("p0", p0), ("fit", fit)):
        gnp.set_seed(PATHS_SEED)
        eps = gnp.randn(PATHS_NT, PATHS_COUNT).cpu()  # the normals the card drew
        gp.config.set_device("cpu")
        try:
            with _FixedNormals(gnp, eps):
                zsim_h, zc_h, _zpm, _t = _conditional_paths(gp, gnp, torch, cp, xi, zi, xt)
        finally:
            gp.config.set_device(DEVICE)
        zsim, zc, cond = card[name]
        e_p, e_c = rel_err(zsim.cpu(), zsim_h), rel_err(zc.cpu(), zc_h)
        say(f"[phase 3c] card vs CPU, f64 engine at {name} (cond(K) {cond:.3e}): paths rel "
            f"{e_p:.2e}, conditioned paths rel {e_c:.2e}"
            + (f" (tol {TOL_PATH})" if name == "p0" else " (not held at the fit)"))
        if name == "p0":
            check(e_p <= TOL_PATH and e_c <= TOL_PATH, f"paths card vs CPU at p0: {e_p}, {e_c}")
    del card

    _example_flows(gp, gnp, torch, sp)
    gp.config.set_chol_engine("auto")
    return launches_p0, t_first, xt


def _example11_kernel(gp, gnp):
    """examples/gpmp_tpu_example11's kernel through the port: the per-point
    noise variance travels as the last input column and is added on the
    same-set diagonal."""
    def kernel(x, y, covparam, pairwise=False):
        sigma2, loginvrho = gnp.exp(covparam[0]), covparam[1:]
        if y is x or y is None:
            xc, nv = x[:, :-1], x[:, -1].reshape(-1)
            if pairwise:
                return sigma2 * gnp.ones((xc.shape[0],)) + nv
            D = gnp.scaled_distance(loginvrho, xc, xc)
            return sigma2 * gp.kernel.maternp_kernel(2, D) + gnp.diag(nv)
        xc, yc = x[:, :-1], y[:, :-1]
        D = (gnp.scaled_distance_elementwise(loginvrho, xc, yc) if pairwise
             else gnp.scaled_distance(loginvrho, xc, yc))
        return sigma2 * gp.kernel.maternp_kernel(2, D)

    return kernel


def _example_flows(gp, gnp, torch, sp):
    """Examples 10 and 11 through the port on the card (nt = 200, 5
    observations, 6 paths), on both engines: prior paths, kriging weights,
    conditioned paths, which interpolate the noise-free observations."""
    xt = np.linspace(-1, 1, 200).reshape(-1, 1)
    zt = gp.misc.testfunctions.twobumps(xt)
    ind = [10, 45, 100, 130, 155]
    covparam = np.array([math.log(0.5**2), math.log(1 / 0.7)])
    noise_var = np.array([0.0, 0.02, 0.005, 0.0, 0.01])
    z11 = zt[ind].reshape(-1) + np.sqrt(noise_var) * np.random.default_rng(0).normal(size=5)

    def constant_mean(x, param):
        return gnp.ones((x.shape[0], 1))

    def builtin(x, y, c, pairwise=False):
        return gp.kernel.maternp_covariance(x, y, 2, c, pairwise)

    flows = {
        10: (gp.Model(constant_mean, builtin, None, covparam), xt, xt[ind],
             zt[ind].reshape(-1), [0, 1, 2, 3, 4]),
        11: (gp.Model(constant_mean, _example11_kernel(gp, gnp), None, covparam),
             np.hstack([xt, np.zeros((200, 1))]),
             np.hstack([xt[ind], noise_var[:, None]]), z11, [0, 3]),
    }
    for engine in ("mixed", "f64"):
        gp.config.set_chol_engine(engine)
        for ex, (model, xt_f, xi_f, zi, exact) in flows.items():
            before = dict(sp.BRANCHES)
            gnp.set_seed(0)
            ztsim = model.sample_paths(xt_f, 6)
            _zpm, _zpv, lam = model.predict(xi_f, zi, xt_f, return_lambdas=True)
            ztsimc = model.conditional_sample_paths(ztsim, np.asarray(ind), zi,
                                                    np.arange(200), lam)
            branch = "+".join(k for k, v in sp.BRANCHES.items() if v != before[k])
            err = float(np.max(np.abs(ztsimc[np.asarray(ind)[exact]] - zi[exact][:, None])))
            say(f"[phase 3c] example {ex} on {engine} (nt = 200): branch {branch}; "
                f"conditioned paths at the noise-free observations {err:.2e} (tol 1e-6)")
            check(ztsimc.shape == (200, 6) and np.all(np.isfinite(ztsimc)),
                  f"example {ex} on {engine}: conditioned paths")
            check(err <= 1e-6, f"example {ex} on {engine}: interpolation error {err:.3e}")


def rel_err_np(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _kernel_bounds(n, k=2, base=128, d=6, p=2):
    """(bound_ms, bound_by) of each kernel at these shapes: the larger of
    bytes (each input read once, each output written once) over the memory
    rate and operations over the peak rate for their type."""
    def bound(nbytes, flops, peak):
        t_b, t_o = nbytes / PEAK_BYTES_PER_S, flops / peak
        return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")

    nb = -(-n // base)
    sizes = [base] * (nb - 1) + [n - base * (nb - 1)]
    fma_k4 = sum((n - j) * (j + 1) for j in range(n))
    tri = n * (n + 1) // 2  # the lower triangle: K4 and K5 read no more of K and L
    # K4 reads K (f64) and L (f32) over the lower triangle and writes the
    # full f32 R; K5 reads the lower triangles of L's diagonal blocks and
    # writes nb base x base f32 inverses
    fp64 = PEAK_F64_FLOPS
    return {
        # gram: ~3d (distance) + 2(p+1) (Horner) + 4 (sqrt, exp, scalings) per entry
        "K1": bound(8 * (n * n + 2 * n * d + d + 1), n * n * (3 * d + 2 * (p + 1) + 4),
                    PEAK_F64_FLOPS),
        # distance: reads x, y, l, writes D; ~3d + 1 (sqrt) per entry
        "K1d": bound(8 * (n * n + 2 * n * d + d), n * n * (3 * d + 1), fp64),
        # its pullback: reads Dbar, x, y, l, writes d values; the distance,
        # a division and ~3d for the terms
        "K1d pullback": bound(8 * (n * n + 2 * n * d + 2 * d), n * n * (6 * d + 2), fp64),
        # Matern polynomial: reads D, writes K; Horner 2p, exp, 3 products
        "K1m": bound(16 * n * n, n * n * (2 * p + 4), fp64),
        # its backward: reads D and Kbar, writes Dbar
        "K1m backward": bound(24 * n * n, n * n * (2 * p + 5), fp64),
        # LOO diagonal, series branch: reads M32 and B32 (f32), writes n f64;
        # a square, a product, a difference and a sum per entry
        "K7b": bound(8 * n * n + 8 * n, 4 * n * n, fp64),
        # sampling residual: K4's work with an f64 output
        "K8s": bound(8 * tri + 4 * tri + 8 * n * n, 2 * fma_k4 + tri, PEAK_F64_TENSOR_FLOPS),
        # M^T (M r): the lower triangle of M32 read once, r (f64, k columns)
        # read and the result written; two triangular products in f32
        "K6": bound(4 * tri + 16 * n * k, 4 * tri * k, PEAK_F32_FLOPS),
        # pullback: K1's work plus ~2d + 2(p+1) + 4 for the derivative terms
        "K2": bound(8 * (n * n + 2 * n * d + d + 1 + d + 1),
                    n * n * (5 * d + 4 * (p + 1) + 8), PEAK_F64_FLOPS),
        "K3": bound(8 * (n * n + 3 * n * k) + 16, 2 * n * n * k + 4 * n * k,
                    PEAK_F64_FLOPS),
        "K4": bound(8 * tri + 4 * tri + 4 * n * n, 2 * fma_k4 + tri, PEAK_F64_TENSOR_FLOPS),
        "K5": bound(4 * sum(b * (b + 1) // 2 for b in sizes) + 4 * nb * base * base,
                    sum(b ** 3 // 3 + b * b for b in sizes), PEAK_F32_FLOPS),
        # K7: H and H^2 read once (the one-read bound); the two calls read H
        # twice, since the host reads trace_sums' sum H^2 before it calls
        # series_sums (the two-call floor); and each call alone
        "K7": bound(8 * n * n + 32, 6 * n * n + n, PEAK_F64_FLOPS),
        "K7 two-call": bound(12 * n * n + 32, 6 * n * n + n, PEAK_F64_FLOPS),
        "K7 trace_sums": bound(4 * n * n + 16, 2 * n * n + n, PEAK_F64_FLOPS),
        "K7 series_sums": bound(8 * n * n + 16, 4 * n * n, PEAK_F64_FLOPS),
    }


def _stream_bounds(n, k=2, c=STREAM_PANEL):
    """(bound_ms, bound_by) of the streamed engine's kernels at the large-n
    path's shapes, as _kernel_bounds: K6 at n, K10b and K10t per row chunk of
    c rows, K10r over the whole lower triangle (ff), K10m at n."""
    def bound(nbytes, flops, peak):
        t_b, t_o = nbytes / PEAK_BYTES_PER_S, flops / peak
        return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")

    tri = n * (n + 1) // 2
    fma = sum((n - j) * (j + 1) for j in range(n))  # sum over i >= j of (j + 1)
    return {
        "K6": _kernel_bounds(n, k=k)["K6"],
        # reads the f64 chunk and corr, writes hi and lo (f32); add, two
        # roundings and a difference per entry
        "K10b": bound(8 * c * n + 8 * c + 8 * c * n, 3 * c * n, PEAK_F64_FLOPS),
        # reads the pair and L over the lower triangle, writes the full f32 R;
        # sum_{i >= j} (j + 1) f64 multiply-adds at the f64 tensor peak (K4's)
        "K10r": bound(8 * tri + 4 * tri + 4 * n * n, 2 * fma + tri, PEAK_F64_TENSOR_FLOPS),
        # reads the pair, X and B (f64), writes R; two products per entry and column
        "K10m": bound(8 * n * n + 24 * n * k + 16, 4 * n * n * k, PEAK_F64_FLOPS),
        # reads Hr, H2r and the column block Hc (f32); ~6 f64 operations per entry
        "K10t": bound(12 * c * n + 32, 6 * c * n + c, PEAK_F64_FLOPS),
    }


def _stream_counters(distance, gram, mixed, ops):
    """name -> (module, attribute) of every kernel counter of the large-n path."""
    return {"K6": (mixed, "K6_LAUNCHES"), "K10b": (ops, "K10B_LAUNCHES"),
            "K10r": (ops, "K10R_LAUNCHES"), "K10m": (ops, "K10M_LAUNCHES"),
            "K10t": (ops, "K10T_LAUNCHES"), "K5": (mixed, "K5_LAUNCHES"),
            "K1d": (distance, "K1D_LAUNCHES"), "K1d pullback": (distance, "K1D_PULLBACK_LAUNCHES"),
            "K1m": (gram, "K1M_LAUNCHES"), "K1m backward": (gram, "K1M_BACKWARD_LAUNCHES")}


def _k6_err(torch, mixed, M32, R):
    """max over the entries of |K6 - plain| / (|M|^T |M| |r32|), in units of
    n eps32, and max|diff|."""
    out = mixed.precond_apply_cuda(M32, R)
    check(torch.equal(out, mixed.precond_apply_cuda(M32, R)), "K6 is not bitwise reproducible")
    diff = (out - mixed.precond_apply_plain(M32, R)).abs().double()
    Ma = M32.abs()
    scale = (Ma.T @ (Ma @ R.float().abs())).double().clamp_min(1e-300)
    return float((diff / scale).max()) / (M32.shape[0] * EPS32), float(diff.max())


def _k10t_err(torch, ops, H, chunk):
    """K10t over every row chunk of H against its plain version: max |diff|
    over the sums of the absolute terms, and max|diff|; each chunk's launch
    twice, into two accumulators that must agree bitwise."""
    acc_k, acc_k2, acc_p, acc_a = (torch.zeros(4, dtype=torch.float64, device=DEVICE)
                                   for _ in range(4))
    Habs = H.abs()
    for r0 in range(0, H.shape[0], chunk):
        H2r = H[r0:r0 + chunk] @ H
        ops.h_traces_chunk_cuda(H, H2r, r0, acc_k)
        ops.h_traces_chunk_cuda(H, H2r, r0, acc_k2)
        ops.h_traces_chunk_plain(H, H2r, r0, acc_p)
        ops.h_traces_chunk_plain(Habs, H2r.abs(), r0, acc_a)
    check(torch.equal(acc_k, acc_k2), f"K10t is not bitwise reproducible at n={H.shape[0]}")
    diff = (acc_k - acc_p).abs()
    return float((diff / acc_a.clamp_min(1e-300)).max()), float(diff.max())


def phase_streamed_kernels_vs_plain(torch, gram, mixed, ops):
    """Phase 2d: K6, K10b, K10r (both sources), K10m and K10t against their
    plain versions on noisy-Matern K at n in STREAM_SIZES, cond ~1e3 and ~1e6;
    K10r from the pair bitwise K4 on hi + lo, its panels (K10R_PANEL_WIDTHS)
    bitwise the pair's; K10m reproducible at K10M_WIDTHS columns."""
    worst = {}

    def held(key, err, tag):
        check(math.isfinite(err) and err <= TOL_2D[key], f"{key} {tag}: {err:.3e} > {TOL_2D[key]}")
        worst[key] = max(worst.get(key, 0.0), err)
        return err

    c = STREAM_PANEL
    for n in STREAM_SIZES:
        for ci, (K, cond_k) in enumerate(_noisy_matern_family(torch, gram, n, MIXED_CONDS,
                                                              55 + n)):
            tag = f"n={n} cond={cond_k:.2e}"
            gen = torch.Generator(device=DEVICE).manual_seed(7 * n + ci)
            L32, M32 = mixed._f32_preconditioner(K)
            K32 = K.float()
            E32 = (K - K32.double()).float()
            # K6 narrow (k <= 8) and wide (9, and predict's / the LOO
            # backward's width at n = 1000)
            k6 = {k: _k6_err(torch, mixed, M32, torch.randn(
                n, k, dtype=torch.float64, device=DEVICE, generator=gen))[0] for k in K6_WIDTHS}
            say(f"[phase 2d] {tag}: K6 by width (n eps32): "
                + " ".join(f"k={k} {v:.2e}" for k, v in k6.items()))
            e = {"K6": max(k6.values())}
            # K10b: every row chunk of K (+ corr) into the pair, then into K32
            # with a ridge, kernel and plain into separate buffers
            corr = 1e-2 * torch.rand(n, dtype=torch.float64, device=DEVICE, generator=gen)
            bufs = [torch.empty((n, n), dtype=torch.float32, device=DEVICE) for _ in range(4)]
            same = True
            for lo_k, lo_p, ridge in ((bufs[1], bufs[3], 0.0), (None, None, 3e-5)):
                for r0 in range(0, n, c):
                    rows, cr = K[r0:r0 + c], corr[r0:r0 + c]
                    ops.split_rows_cuda(rows, cr, r0, bufs[0], lo_k, ridge)
                    ops.split_rows_plain(rows, cr, r0, bufs[2], lo_p, ridge)
                same &= torch.equal(bufs[0], bufs[2]) and (lo_k is None or torch.equal(lo_k, lo_p))
            e["K10b"] = 0.0 if same else float("inf")
            del bufs
            # K10r from the pair (one launch) and from f64 panels of K (one per
            # panel), each against its plain version; both bitwise K4 on hi + lo
            Rk = ops.streamed_residual_ff_cuda(K32, E32, L32)
            Rp = ops.streamed_residual_ff_plain(K32, E32, L32, c)
            check(torch.equal(Rk, Rk.T), f"K10r (pair) not symmetric, {tag}")
            e["K10r"] = rel_err(Rk, Rp)
            Kp = K32.double() + E32.double()
            check(torch.equal(Rk, mixed.factorization_residual_cuda(Kp, L32)),
                  f"K10r (pair) is not bitwise K4 on hi + lo, {tag}")
            Rp2 = torch.empty_like(Rk)
            for w in K10R_PANEL_WIDTHS:
                Rk2 = torch.full_like(Rk, float("nan"))
                for c0 in range(0, n, w):
                    P = Kp[c0:, c0:c0 + w].contiguous()
                    ops.residual_panel_cuda(P, L32, c0, Rk2)
                    ops.residual_panel_plain(P, L32, c0, Rp2)
                check(torch.equal(Rk2, Rk), f"K10r panels of {w} are not bitwise the pair's, {tag}")
                e["K10r"] = max(e["K10r"], rel_err(Rk2, Rp2))
            del Kp, Rk2
            # K10m, reproducible, at K10M_WIDTHS columns
            e["K10m"] = 0.0
            for k in K10M_WIDTHS:
                X = torch.randn(n, k, dtype=torch.float64, device=DEVICE, generator=gen)
                B = torch.randn(n, k, dtype=torch.float64, device=DEVICE, generator=gen)
                (R, nr), (Rq, nrq) = ops.ff_residual_cuda(K32, E32, X, B), ops.ff_residual_plain(
                    K32, E32, X, B)
                R2, nr2 = ops.ff_residual_cuda(K32, E32, X, B)
                check(torch.equal(R, R2) and torch.equal(nr, nr2), f"K10m not reproducible, k={k}")
                e["K10m"] = max(e["K10m"], rel_err(R, Rq), rel_err(nr, nrq))
            # K10t on H = M R M^T of this K
            H = M32 @ (Rp @ M32.T)
            e["K10t"] = _k10t_err(torch, ops, H, c)[0]
            say(f"[phase 2d] {tag}: " + " ".join(
                f"{k} {held(k, v, tag):.2e}" for k, v in e.items()) + " (K6 in n eps32); K10r "
                f"bitwise K4 on hi + lo, its panels of {K10R_PANEL_WIDTHS} bitwise the pair's")
            del K, L32, M32, K32, E32, Rk, Rp, Rp2, H
    for key, val in worst.items():
        say(f"[phase 2d] worst {key} {val:.3e} (tol {TOL_2D[key]})")


def _large_data(n, d=LARGE_D, seed=LARGE_SEED):
    """bench_large_n.py make_data (:47-56): xi, zi and p0 (its xt, drawn
    after zi, is not used here)."""
    rng = np.random.default_rng(seed)
    xi = rng.uniform(size=(n, d))
    zi = (np.sin(3.0 * xi[:, 0]) + 0.5 * xi[:, 1] + 0.25 * xi[:, 2] ** 2
          + 0.05 * rng.normal(size=n))
    p0 = np.concatenate([[np.log(np.var(zi))], [np.log(1e-2)], -np.log(np.std(xi, axis=0))])
    return xi, zi, p0


def _large_model(gp, gnp):
    """bench_large_n.py _build_model (:154-178): Matern p=2 plus a noise
    variance, constant mean; covparam [log s2, log noise, log 1/rho_1..d]."""
    def mean(x, param):
        return gnp.ones((x.shape[0], 1))

    def kernel(x, y, param, pairwise=False):
        sigma2, noise, loginvrho = gnp.exp(param[0]), gnp.exp(param[1]), param[2:]
        if y is x or y is None:
            if pairwise:
                return (sigma2 + noise) * gnp.ones((x.shape[0],))
            Dm = gnp.scaled_distance(loginvrho, x, x)
            return sigma2 * gp.kernel.maternp_kernel(2, Dm) + noise * gnp.eye(Dm.shape[0])
        Dm = (gnp.scaled_distance_elementwise if pairwise
              else gnp.scaled_distance)(loginvrho, x, y)
        return sigma2 * gp.kernel.maternp_kernel(2, Dm)

    return gp.Model(mean, kernel)


def _streamed_residents(gp, gnp, torch, st, plik, n, c=STREAM_PANEL):
    """The streamed engine's residents at bench_large_n's p0 and n: (model,
    x, p, corr, K32, E32, L32), the pair built by K10b in row chunks of c,
    L32 its f32 factor (the engine's ridge)."""
    xi, _zi, p0 = _large_data(n)
    gp.config.set_device(DEVICE)
    model = _large_model(gp, gnp)
    x, p = gnp.asarray(xi), gnp.asarray(p0)
    corr = plik._diag_correction(model, p, x)
    K32, E32 = st._build_pair(model, p, x, corr, c, pair=True)
    L32, info = st._cholesky_f32(K32, 10 * EPS32 * (torch.trace(K32) / n))
    check(int(info) == 0, "the f32 factor failed at bench_large_n's p0")
    return model, x, p, corr, K32, E32, L32


def phase_streamed_large(gp, gnp, torch, mixed, ops, st, plik):
    """Phase 2d at n = LARGE_N, on the engine's own residents at bench_large_n's
    p0 (K10b's pair, the f32 factor, M, H): K6, K10b, K10r, K10m and K10t
    against their plain versions; then phase 4d's kernel times there (CUDA
    events, profiler device time, plain, library call)."""
    n, c = LARGE_N, STREAM_PANEL
    model, x, p, corr, K32, E32, L32 = _streamed_residents(gp, gnp, torch, st, plik, n)
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    errs, absd, times, device = {}, {}, {}, {}
    # K10b on the first row chunk, into copies of its rows
    k64 = model.covariance(x[:c], x, p)
    hi_k, lo_k, hi_p, lo_p = (torch.empty((n, n), dtype=torch.float32, device=DEVICE)
                              for _ in range(4))
    ops.split_rows_cuda(k64, corr[:c], 0, hi_k, lo_k)
    ops.split_rows_plain(k64, corr[:c], 0, hi_p, lo_p)
    same = torch.equal(hi_k[:c], hi_p[:c]) and torch.equal(lo_k[:c], lo_p[:c])
    errs["K10b"] = 0.0 if same else float("inf")
    absd["K10b"] = float(torch.max((hi_k[:c] - hi_p[:c]).abs().max(), (lo_k[:c] - lo_p[:c]).abs().max()))
    t = lambda fn, reps: _time_cuda(torch, fn, reps, warmup=1)  # noqa: E731
    times["K10b"] = (t(lambda: ops.split_rows_cuda(k64, corr[:c], 0, hi_k, lo_k), 20),
                     t(lambda: ops.split_rows_plain(k64, corr[:c], 0, hi_p, lo_p), 5), None)
    device["K10b"] = _device_ms(torch, lambda: ops.split_rows_cuda(k64, corr[:c], 0, hi_k, lo_k), 10)
    del hi_k, lo_k, hi_p, lo_p
    # K10r, one launch over the pair: bitwise K4 on hi + lo, and its panels
    # (recompute mode's, one launch each) bitwise the pair's
    Rk = ops.streamed_residual_ff_cuda(K32, E32, L32)
    Rp = ops.streamed_residual_ff_plain(K32, E32, L32, c)
    check(torch.equal(Rk, Rk.T), "K10r not symmetric at the large n")
    errs["K10r"], absd["K10r"] = rel_err(Rk, Rp), float((Rk - Rp).abs().max())
    del Rp
    K64 = K32.double() + E32.double()
    R4 = mixed.factorization_residual_cuda(K64, L32)
    check(torch.equal(Rk, R4), f"K10r (pair) is not bitwise K4 on hi + lo at n={n}")
    R4.fill_(float("nan"))
    for c0 in range(0, n, c):
        ops.residual_panel_cuda(K64[c0:, c0:c0 + c].contiguous(), L32, c0, R4)
    check(torch.equal(Rk, R4), f"K10r's panels of {c} are not bitwise the pair's at n={n}")
    del R4
    M32 = mixed._block_tri_inv(L32, base=mixed.TRI_INV_BASE)
    H = st._h_from_residual(M32, Rk, c)
    del Rk
    # K6 and K10m at the engine's k = 2 right-hand sides
    r = torch.randn(n, 2, dtype=torch.float64, device=DEVICE, generator=gen)
    r8 = torch.randn(n, 8, dtype=torch.float64, device=DEVICE, generator=gen)
    (e2, a2), (e8, a8) = _k6_err(torch, mixed, M32, r), _k6_err(torch, mixed, M32, r8)
    errs["K6"], absd["K6"] = max(e2, e8), max(a2, a8)
    X = torch.randn(n, 2, dtype=torch.float64, device=DEVICE, generator=gen)
    B = torch.randn(n, 2, dtype=torch.float64, device=DEVICE, generator=gen)
    (R, nr), (Rq, nrq) = ops.ff_residual_cuda(K32, E32, X, B), ops.ff_residual_plain(K32, E32, X, B)
    errs["K10m"] = max(rel_err(R, Rq), rel_err(nr, nrq))
    absd["K10m"] = float((R - Rq).abs().max())
    # K10t over every row chunk of H (one value+grad's worth)
    errs["K10t"], absd["K10t"] = _k10t_err(torch, ops, H, c)
    for key, val in errs.items():
        check(math.isfinite(val) and val <= TOL_2D[key], f"{key} at n={n}: {val:.3e}")
    say(f"[phase 2d] n={n} (bench_large_n's p0, the engine's own residents): "
        + " ".join(f"{k} {v:.2e}" for k, v in errs.items()) + " (K6 in n eps32); max|diff| "
        + " ".join(f"{k} {v:.2e}" for k, v in absd.items())
        + f"; K10r bitwise K4 on hi + lo, its panels of {c} bitwise the pair's")

    r32 = r.float()
    H2r = H[:c] @ H
    acc = torch.zeros(4, dtype=torch.float64, device=DEVICE)
    times["K6"] = (t(lambda: mixed.precond_apply_cuda(M32, r), 20),
                   t(lambda: mixed.precond_apply_plain(M32, r), 20),
                   t(lambda: torch.linalg.multi_dot((M32.T, M32, r32)), 20))
    device["K6"] = _device_ms(torch, lambda: mixed.precond_apply_cuda(M32, r), 10)
    r8_32 = r8.float()
    times["K6 k=8"] = (t(lambda: mixed.precond_apply_cuda(M32, r8), 20),
                       t(lambda: mixed.precond_apply_plain(M32, r8), 20),
                       t(lambda: torch.linalg.multi_dot((M32.T, M32, r8_32)), 20))
    device["K6 k=8"] = _device_ms(torch, lambda: mixed.precond_apply_cuda(M32, r8), 10)
    times["K10t"] = (t(lambda: ops.h_traces_chunk_cuda(H, H2r, 0, acc), 20),
                     t(lambda: ops.h_traces_chunk_plain(H, H2r, 0, acc), 5), None)
    device["K10t"] = _device_ms(torch, lambda: ops.h_traces_chunk_cuda(H, H2r, 0, acc), 10)
    del H, H2r, M32
    times["K10m"] = (t(lambda: ops.ff_residual_cuda(K32, E32, X, B), 20),
                     t(lambda: ops.ff_residual_plain(K32, E32, X, B), 3),
                     t(lambda: torch.addmm(B, K64, X, alpha=-1), 5))
    device["K10m"] = _device_ms(torch, lambda: ops.ff_residual_cuda(K32, E32, X, B), 10)
    times["K10r"] = (t(lambda: ops.streamed_residual_ff_cuda(K32, E32, L32), 2),
                     t(lambda: ops.streamed_residual_ff_plain(K32, E32, L32, c), 1), None)
    device["K10r"] = _device_ms(torch, lambda: ops.streamed_residual_ff_cuda(K32, E32, L32), 1)
    # K4 on hi + lo, K10r's yardstick (the same tiles and sums from a dense K)
    t_k4 = (t(lambda: mixed.factorization_residual_cuda(K64, L32), 2),
            _device_ms(torch, lambda: mixed.factorization_residual_cuda(K64, L32), 1))
    del K32, E32
    L64 = L32.double()
    times["K10r"] = times["K10r"][:2] + (t(lambda: torch.addmm(K64, L64, L64.T, alpha=-1), 1),)
    del K64, L64
    # K5 on the engine's own f32 factor (the streamed engine's M = L32^-1)
    k5 = _k5_times(torch, mixed, L32, "4d", reps=20)
    del L32
    bounds = _stream_bounds(n)
    bounds["K6 k=8"] = _kernel_bounds(n, k=8)["K6"]
    for key, (t_k, t_p, t_l) in times.items():
        b_ms, b_by = bounds[key]
        lib = "none" if t_l is None else f"{t_l:.4f} ms"
        say(f"[phase 4d] {key} n={n}: kernel {t_k:.4f} ms (device {_fmt_ms(device[key])}), "
            f"plain {t_p:.4f} ms, library {lib}, bound {b_ms:.4f} ms ({b_by}), "
            f"share {100 * b_ms / t_k:.1f}%")
    b_ms = bounds["K10r"][0]
    say(f"[phase 4d] K4 on hi + lo n={n} (K10r's yardstick): kernel {t_k4[0]:.4f} ms (device "
        f"{_fmt_ms(t_k4[1])}); K10r's share of its {b_ms:.2f} ms bound: events "
        f"{100 * b_ms / times['K10r'][0]:.1f}%, device "
        + ("not measured" if device["K10r"] is None else f"{100 * b_ms / device['K10r']:.1f}%"))
    times[f"K5 n={n}"], device[f"K5 n={n}"], bounds[f"K5 n={n}"] = k5
    panels = _k10r_panel_pass(torch, ops, LARGE_RC_N, STREAM_PANEL, gen)
    pb_ms, pb_by = panels["bound"]
    say(f"[phase 4d] K10r recompute pass n={LARGE_RC_N}, {panels['panels']} panels of "
        f"{STREAM_PANEL}: {panels['pass_ms']:.2f} ms; the panel with the most work "
        f"(c0={panels['c0']}): kernel {panels['ms']:.4f} ms (device "
        f"{_fmt_ms(panels['device_ms'])}), plain {panels['plain_ms']:.4f} ms, bound "
        f"{pb_ms:.4f} ms ({pb_by}), share {100 * pb_ms / panels['ms']:.1f}% (K4 at n={n}: "
        f"{100 * b_ms / t_k4[0]:.1f}%)")
    return errs, absd, times, bounds, device


def _k10r_panel_bound(n, c0, w):
    """(bound_ms, bound_by) of K10r on one panel of w columns at c0: (n - j)(j + 1)
    multiply-adds for each column j (the rows i >= j, each k <= j), at the f64
    tensor peak; it reads the f64 panel and L's rows [c0, n) up to column
    c0 + w, writes the panel's block of R and its mirror."""
    c1 = c0 + w
    fma = sum((n - j) * (j + 1) for j in range(c0, c1))
    nbytes = 8 * (n - c0) * w + 4 * sum(min(i + 1, c1) for i in range(c0, n)) \
        + 4 * ((n - c0) * w + w * (n - c1))
    t_b, t_o = nbytes / PEAK_BYTES_PER_S, (2 * fma + (n - c0) * w) / PEAK_F64_TENSOR_FLOPS
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def _k10r_panel_pass(torch, ops, n, w, gen, digests=None):
    """K10r's recompute pass at n: one launch per panel of w columns (the
    engine's rblock) on a random lower-triangular f32 L and random f64
    panels (the time depends only on the shapes), the whole pass timed with
    CUDA events, and the panel with the most work alone (events, device
    time, plain version, bound).  With digests, that panel's block of
    R goes in under "K10r panel n=...".  Frees what it made."""
    L32 = torch.rand((n, n), dtype=torch.float32, device=DEVICE, generator=gen).tril_()
    L32.div_(math.sqrt(n))  # L Lᵀ as large as the panel: its rounding shows in R
    R = torch.empty((n, n), dtype=torch.float32, device=DEVICE)
    P = torch.rand((n, w), dtype=torch.float64, device=DEVICE, generator=gen)
    starts = list(range(0, n, w))
    work = [sum((n - j) * (j + 1) for j in range(c0, min(n, c0 + w))) for c0 in starts]
    c0 = starts[work.index(max(work))]
    cw = min(w, n - c0)
    Pw = P[:n - c0, :cw].contiguous()

    def one_pass():
        for a in starts:
            aw = min(w, n - a)
            ops.residual_panel_cuda(P[:n - a, :aw] if aw == w else P[:n - a, :aw].contiguous(),
                                    L32, a, R)

    out = {"panels": len(starts), "c0": c0,
           "pass_ms": _time_cuda(torch, one_pass, 1, warmup=1),
           "ms": _time_cuda(torch, lambda: ops.residual_panel_cuda(Pw, L32, c0, R), 3, warmup=1),
           "device_ms": _device_ms(torch, lambda: ops.residual_panel_cuda(Pw, L32, c0, R), 2),
           "plain_ms": _time_cuda(torch, lambda: ops.residual_panel_plain(Pw, L32, c0, R), 1,
                                  warmup=1),
           "bound": _k10r_panel_bound(n, c0, cw)}
    if digests is not None:
        ops.residual_panel_cuda(Pw, L32, c0, R)
        digests[f"K10r panel n={n} c0={c0}"] = _digest(R[c0:, c0:c0 + cw].contiguous())
    del L32, R, P, Pw, one_pass
    gc.collect()
    torch.cuda.empty_cache()  # n = 51200's two n^2 f32: the next phase's cuBLAS needs room
    return out


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _peak_rise(torch, fn):
    """(fn(), rise of max_memory_allocated over what was held before)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - before


def _criterion(gp, model, xi, zi, mesh=None):
    """(value+grad, value-only) REML callables, through the model view on
    ``mesh`` (the sharded criterion) or on the model itself (the core path)."""
    from gpmp_tpu_torch.parallel import ShardedModelView

    m = model if mesh is None else ShardedModelView(model, mesh)
    crit, _pre, no_grad, grad = gp.kernel.make_selection_criterion_with_gradient(
        m, gp.kernel.negative_log_restricted_likelihood, xi, zi)
    return (lambda p: (crit(p), grad(p))), no_grad


class _Patched:
    """Sets module attributes while active (the engine's cutover, mode, gate)."""

    def __init__(self, mod, **values):
        self.mod, self.values = mod, values

    def __enter__(self):
        self.saved = {k: getattr(self.mod, k) for k in self.values}
        for k, v in self.values.items():
            setattr(self.mod, k, v)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(self.mod, k, v)


def phase_large_n(gp, gnp, torch, gram, distance, mixed, refine, ops, st):
    """Phase 3d: REML on bench_large_n's workload at n = LARGE_N through the
    one-card mesh, on the streamed engine."""
    t_phase = time.perf_counter()
    n = LARGE_N
    xi, zi, p0 = _large_data(n)
    gp.config.set_device(DEVICE)
    gp.config.set_chol_engine("mixed")
    check(st.STREAM_MIN_N is None, "GPMP_STREAM_N is set: phase 3d sets the cutover itself")
    with _Patched(st, STREAM_MIN_N=n):
        return _phase_large_n(gp, gnp, torch, gram, distance, mixed, refine, ops, st, t_phase)


def _phase_large_n(gp, gnp, torch, gram, distance, mixed, refine, ops, st, t_phase):
    """Phase 3d's body, the cutover forced at LARGE_N (the mesh's resident
    mixed branch fits n = 32768 on an 80 GB card): (a)-(c) stream at n, and
    (d) at LARGE_RC_N, past the resident branch's reach, streams by itself."""
    from gpmp_tpu_torch import parallel

    n = LARGE_N
    xi, zi, p0 = _large_data(n)
    unit = 4 * n * n
    total = torch.cuda.get_device_properties(0).total_memory
    cap = st._device_bytes_cap()
    mode = st.choose_mode(n)
    say(f"[phase 3d] n={n} d={LARGE_D}: card total_memory {total} B, cap 0.85 x that "
        f"{cap} B = {cap / unit:.2f} units of 4n^2 B; resident model "
        f"{st._RESIDENT_PEAK_UNITS} units = {st._RESIDENT_PEAK_UNITS * unit / 2**30:.1f} GiB "
        f"(fits: {st._resident_fits(n)}); ff {st._FF_PEAK_UNITS}, recompute "
        f"{st._RECOMPUTE_PEAK_UNITS}, robust {st._ROBUST_PEAK_UNITS} units; mode chosen {mode}, "
        f"robust branch {st._robust_fits(n)}")
    check(mode == "ff", f"the streamed engine did not pick ff mode at n={n}")
    model = _large_model(gp, gnp)
    mesh = parallel.make_mesh(1, axis_name="shard")
    counters = _stream_counters(distance, gram, mixed, ops)
    res, mem, walls = {}, {}, {}

    # (a) one REML value+grad at p0 through the sharded criterion
    vg, value = _criterion(gp, model, xi, zi, mesh)
    _reset(counters)
    with _PlainGuard(gram, distance, mixed, refine, ops):
        ((v_ff, g_ff), walls["ff value+grad (first)"]), mem[("ff", n)] = _peak_rise(
            torch, lambda: _timed(torch, lambda: vg(p0)))
    launches = _read(counters)
    say(f"[phase 3d] (a) ff value+grad at p0: {walls['ff value+grad (first)']:.3f} s, REML "
        f"{v_ff!r}, grad {np.array2string(g_ff, precision=6)}; launches {launches}")
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched on the large-n path")
    check(np.isfinite(v_ff) and np.all(np.isfinite(g_ff)), "REML value+grad not finite at p0")
    res["ff"] = (v_ff, g_ff)
    _, walls["ff value"] = _timed(torch, lambda: value(p0))

    # (b) the fit of example 40 on the mesh
    maxiter = 1 if walls["ff value+grad (first)"] > 20.0 else LARGE_FIT_MAXITER
    fit_model = _large_model(gp, gnp)
    (fit_model, info), walls["fit"] = _timed(torch, lambda: gp.kernel.select_parameters_with_reml(
        fit_model, xi, zi, covparam0=p0, mesh=mesh, method="L-BFGS-B",
        method_options={"maxiter": maxiter}, info=True))
    say(f"[phase 3d] (b) select_parameters_with_reml(mesh=..., L-BFGS-B, maxiter={maxiter}): "
        f"nfev {info.nfev}, {walls['fit']:.3f} s, REML {info.history_criterion[0]!r} at p0 -> "
        f"{info.fun!r}, covparam {np.array2string(np.asarray(info.x), precision=4)}")
    check(np.isfinite(info.fun) and info.fun <= info.history_criterion[0],
          "the fit ended above its start or not finite")

    # (c) recompute mode at the same n
    with _Patched(st, choose_mode=lambda n_, cap_bytes=None: "recompute"):
        vg_rc, value_rc = _criterion(gp, model, xi, zi, mesh)
        ((v_rc, g_rc), walls["recompute value+grad"]), mem[("recompute", n)] = _peak_rise(
            torch, lambda: _timed(torch, lambda: vg_rc(p0)))
        _, walls["recompute value"] = _timed(torch, lambda: value_rc(p0))
    res["recompute"] = (v_rc, g_rc)
    env = np.array([TOL_LARGE["grad"][0]] + [TOL_LARGE["grad"][1]] * (len(p0) - 1))
    e_rc = abs(v_rc - v_ff) / abs(v_ff)
    eg_rc = np.abs(g_rc - g_ff) / np.abs(g_ff)
    say(f"[phase 3d] (c) recompute value+grad {walls['recompute value+grad']:.3f} s: REML "
        f"{v_rc!r}, vs ff rel {e_rc:.2e} (tol {TOL_FF_RC}), grad vs ff "
        f"{np.array2string(eg_rc, precision=2)} (envelope {env.tolist()})")
    check(e_rc <= TOL_FF_RC and np.all(eg_rc <= env), "recompute vs ff")

    # the gate at n: the port's f64 engine (core path, value only)
    gp.config.set_chol_engine("f64")
    with torch.no_grad():
        v64, walls["f64 engine value (core)"] = _timed(torch, lambda: float(
            model.negative_log_restricted_likelihood(gnp.asarray(p0), gnp.asarray(xi),
                                                     gnp.asarray(zi))))
    gp.config.set_chol_engine("mixed")
    e64 = {m: abs(v - v64) / abs(v64) for m, (v, _g) in res.items()}
    say(f"[phase 3d] n={n} REML vs the f64 engine {v64!r}: "
        + ", ".join(f"{m} {e:.2e}" for m, e in e64.items()) + f" (tol {TOL_LARGE['value']})")
    check(all(e <= TOL_LARGE["value"] for e in e64.values()), "REML vs the f64 engine at n")

    # the gradient gate at LARGE_GRAD_N (the cutover forced), and each mode's
    # and each resident engine's peak there
    n2 = LARGE_GRAD_N
    xi2, zi2, p2 = _large_data(n2)
    with _Patched(st, STREAM_MIN_N=n2):
        vg2, _ = _criterion(gp, model, xi2, zi2, mesh)
        (v2, g2), mem[("ff", n2)] = _peak_rise(torch, lambda: vg2(p2))
        with _Patched(st, choose_mode=lambda n_, cap_bytes=None: "recompute"):
            vg2r, _ = _criterion(gp, model, xi2, zi2, mesh)
            _, mem[("recompute", n2)] = _peak_rise(torch, lambda: vg2r(p2))
        with _Patched(st, _SERIES_C4_TAU=0.0):  # the series gate shut: the robust branch
            vg2b, _ = _criterion(gp, model, xi2, zi2, mesh)
            (v2b, _g2b), mem[("ff robust branch", n2)] = _peak_rise(torch, lambda: vg2b(p2))
    for engine in ("mixed", "f64"):
        gp.config.set_chol_engine(engine)
        vg_core, _ = _criterion(gp, model, xi2, zi2)
        (v_core, g_core), mem[(f"resident {engine}", n2)] = _peak_rise(torch, lambda: vg_core(p2))
        res[f"resident {engine} n={n2}"] = (v_core, g_core)
    gp.config.set_chol_engine("mixed")
    v64b, g64 = res[f"resident f64 n={n2}"]
    e_v2, e_v2b = abs(v2 - v64b) / abs(v64b), abs(v2b - v64b) / abs(v64b)
    e_g2 = np.abs(g2 - g64) / np.abs(g64)
    say(f"[phase 3d] n={n2} (GPMP_STREAM_N forced), ff vs the f64 engine: REML rel {e_v2:.2e} "
        f"(robust branch forced {e_v2b:.2e}, tol {TOL_LARGE['robust']}), grad "
        f"{np.array2string(e_g2, precision=2)} "
        f"(envelope {env.tolist()})")
    check(e_v2 <= TOL_LARGE["value"] and e_v2b <= TOL_LARGE["robust"] and np.all(e_g2 <= env),
          f"streamed vs f64 engine at n={n2}")

    # the card against the port on the CPU at LARGE_CPU_N (value; plain versions there)
    n3 = LARGE_CPU_N
    xi3, zi3, p3 = _large_data(n3)
    with _Patched(st, STREAM_MIN_N=n3):
        v_card = _criterion(gp, model, xi3, zi3, mesh)[1](p3)
        gp.config.set_device("cpu")
        try:
            v_cpu = _criterion(gp, _large_model(gp, gnp), xi3, zi3,
                               parallel.make_mesh(1, axis_name="shard"))[1](p3)
        finally:
            gp.config.set_device(DEVICE)
    e_cpu = abs(v_card - v_cpu) / abs(v_cpu)
    say(f"[phase 3d] n={n3} streamed REML card vs CPU: {v_card!r} vs {v_cpu!r}, rel {e_cpu:.2e} "
        f"(tol {TOL_LARGE['value']})")
    check(e_cpu <= TOL_LARGE["value"], "card vs CPU at the small n")

    # (d) past ff's reach and the resident branch's: the dispatcher streams
    # in recompute mode by itself
    n4 = LARGE_RC_N
    xi4, zi4, p4 = _large_data(n4)
    mode4 = st.choose_mode(n4)
    check(mode4 == "recompute" and not st._resident_fits(n4),
          f"the dispatcher did not pick recompute at n={n4}: {mode4}")
    vg4, _ = _criterion(gp, model, xi4, zi4, mesh)
    with _Patched(st, STREAM_MIN_N=None):
        ((v4, g4), walls[f"recompute value+grad n={n4}"]), mem[("recompute", n4)] = _peak_rise(
            torch, lambda: _timed(torch, lambda: vg4(p4)))
    say(f"[phase 3d] (d) n={n4}: mode {mode4}; value+grad "
        f"{walls[f'recompute value+grad n={n4}']:.3f} s, REML {v4!r}, grad "
        f"{np.array2string(g4, precision=6)}")
    check(np.isfinite(v4) and np.all(np.isfinite(g4)), f"REML value+grad not finite at n={n4}")
    del vg4

    # the resident engines at n, where the model says they do not fit
    for engine in ("mixed", "f64"):
        gp.config.set_chol_engine(engine)
        vg_core, _ = _criterion(gp, model, xi, zi)
        try:
            _, mem[(f"resident {engine}", n)] = _peak_rise(torch, lambda: vg_core(p0))
        except RuntimeError as exc:  # torch's OutOfMemoryError, or cuSOLVER's allocation
            if "memory" not in str(exc).lower() and "alloc" not in str(exc).lower():
                raise
            mem[(f"resident {engine}", n)] = None
            say(f"[phase 3d] resident {engine} value+grad at n={n}: out of memory "
                f"({str(exc).splitlines()[0][:160]})")
        del vg_core
        gc.collect()
        torch.cuda.empty_cache()
    gp.config.set_chol_engine("mixed")
    for (what, nn), b in mem.items():
        say(f"[phase 3d] peak rise, one REML value+grad, {what} n={nn}: "
            + ("out of memory" if b is None else
               f"{b / 2**30:.3f} GiB = {b / (4 * nn * nn):.2f} units of 4n^2 B"))
    say(f"[phase 4d] n={n} wall: " + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items()))
    say(f"[phase 3d] phase seconds {time.perf_counter() - t_phase:.1f}")
    return launches, walls, mem, info



# ----------------------------------------------------------------------------
# phases 2e, 3e, 4e: the resident one-card mesh path (K8r, K8t, K9u, K9m)
# ----------------------------------------------------------------------------
def _resident_counters(refine, ochol):
    """name -> (module, attribute) of the resident path's new kernels."""
    return {"K8r": (refine, "K8R_LAUNCHES"), "K8t": (refine, "K8T_LAUNCHES"),
            "K9u": (ochol, "K9U_LAUNCHES"), "K9m": (ochol, "K9M_LAUNCHES")}


def _large_xt(n, d=LARGE_D, seed=LARGE_SEED, nt=64):
    """bench_large_n.py make_data's xt (:52): drawn after xi and zi."""
    rng = np.random.default_rng(seed)
    rng.uniform(size=(n, d))
    rng.normal(size=n)
    return rng.uniform(size=(nt, d))


def _large_gram(gp, gnp, n):
    """K of bench_large_n's workload at its p0 (K1d/K1m), for the kernels'
    checks at sizes where an eigendecomposition would cost seconds."""
    from gpmp_tpu_torch import parallel

    xi, _zi, p0 = _large_data(n)
    return parallel.sharded_covariance(_large_model(gp, gnp), gnp.asarray(p0), gnp.asarray(xi),
                                       None)


def _dot_units(torch, dC, scale, terms):
    """max |dC| / (2 terms eps64 scale), entrywise (0 where both are 0)."""
    unit = 2.0 * terms * float(np.finfo(np.float64).eps) * scale
    return float((dC.abs() / unit.clamp_min(1e-300)).max())


def _k9u_units(torch, A1, A2, T, off, b, rows=1024):
    """(max |dS| in units of 2 b eps64 (|S| + |T||T|^T), max |dS|, exact
    symmetry of A1's trailing block) between K9u's output A1 and the plain
    version's A2, by row blocks (no (n, n) temporary).  The input S is
    recovered as A2's S + T T^T: its rounding moves the unit by ~eps64."""
    n = A1.shape[0]
    err, dmax, sym = 0.0, 0.0, True
    for r0 in range(off, n, rows):
        r1 = min(n, r0 + rows)
        S1, S2, Tr = A1[r0:r1, off:], A2[r0:r1, off:], T[r0 - off:r1 - off]
        dS = S1 - S2
        scale = (S2 + Tr @ T.T).abs() + Tr.abs() @ T.abs().T
        err = max(err, _dot_units(torch, dS, scale, b))
        dmax = max(dmax, float(dS.abs().max()))
        sym = sym and torch.equal(S1, A1[off:, r0:r1].T)
        del dS, scale
    return err, dmax, sym


def _same(a, b):
    """Equal entry by entry, NaN where NaN."""
    if a.shape != b.shape:
        return False
    nan = a.isnan()
    return bool((nan == b.isnan()).all()) and bool((a[~nan] == b[~nan]).all())


def _refined_graph_vs_launches(torch, refine, A, tag):
    """refined_cholesky(A, with_inverse=True) on the card (its captured
    graph, replayed twice) against its launch sequence run as it is
    (refine._refined_cholesky_launches, the sequence the graph captured):
    L and M bitwise, each replay adding the graph's K8r and K8t launches
    (3 and 2 + 3 steps) to the counters; a line for the log."""
    steps, rtol2 = 2, refine._FACTOR_RTOL2
    Le, Me = refine._refined_cholesky_launches(A, steps, True, rtol2)
    refine.refined_cholesky(A, with_inverse=True)  # the capture, if not yet made
    counts = refine.K8R_LAUNCHES, refine.K8T_LAUNCHES
    Lg, Mg = refine.refined_cholesky(A, with_inverse=True)
    added = refine.K8R_LAUNCHES - counts[0], refine.K8T_LAUNCHES - counts[1]
    Lg2, Mg2 = refine.refined_cholesky(A, with_inverse=True)
    same = _same(Lg, Le) and _same(Mg, Me)
    check(same, f"refined_cholesky's graph is not bitwise its launch sequence ({tag})")
    check(_same(Lg, Lg2) and _same(Mg, Mg2), f"refined_cholesky's graph not reproducible ({tag})")
    check(added == (3, 2 + 3 * steps), f"a replay counted {added} K8r/K8t launches ({tag})")
    finite = bool(torch.isfinite(Lg).all())
    return (f"L and M bitwise the launch sequence {same}, a replay counts {added[0]} K8r and "
            f"{added[1]} K8t, L finite {finite}")


def phase_resident_kernels_vs_plain(gp, gnp, torch, gram, refine, ochol):
    """Phase 2e: K8r, K8t, K9u and K9m against their plain versions on the
    card, with the tolerances and reasons at TOL_2E."""
    worst, absd = {}, {}

    def held(key, err, tag):
        tol = TOL_2E[key]
        check(math.isfinite(err) and err <= tol, f"{key} {tag}: {err:.3e} > {tol}")
        worst[key] = max(worst.get(key, 0.0), err)

    for b in K8_PANELS:
        for cond_req in MIXED_CONDS:
            A, cond_a = _noisy_matern_spd(torch, gram, b, cond_req, 300 + b)
            tag = f"b={b} cond={cond_a:.2e}"
            # the refinement's first inputs: L = the f32 factor promoted, M its
            # f32 inverse promoted
            L32 = torch.linalg.cholesky(A.float())
            eye = torch.eye(b, dtype=torch.float32, device=DEVICE)
            L = L32.double().contiguous()
            M = torch.linalg.solve_triangular(L32, eye, upper=False).double().contiguous()
            E, sums = refine.refine_residual_cuda(A, L)
            E2, sums2 = refine.refine_residual_cuda(A, L)
            check(torch.equal(E, E2) and torch.equal(sums, sums2), f"K8r not reproducible ({tag})")
            Ep, sums_p = refine.refine_residual_plain(A, L)
            check(torch.equal(E, E.T), f"K8r not symmetric ({tag})")
            e_r = float((E - Ep).abs().max()) / float(A.abs().max())
            held("K8r", e_r, tag)
            e_s = [abs(float(sums[i] - sums_p[i])) / abs(float(sums_p[i])) for i in (0, 1)]
            check(e_s[0] <= TOL_2E["K8r sums"][0] and e_s[1] <= TOL_2E["K8r sums"][1],
                  f"K8r sums {tag}: {e_s}")
            # K8t: the Newton step's two products and the Ogita-Aishima update
            P = refine.tri_product_plain(L, M)
            X = (M @ Ep @ M.T).contiguous()
            e_t = []
            for a_, b_, beta, alpha, phi in ((L, M, 0.0, 1.0, False), (M, P, 2.0, -1.0, False),
                                            (L, X, 1.0, 1.0, True)):
                C = refine.tri_product_cuda(a_, b_, beta, alpha, phi)
                Cp = refine.tri_product_plain(a_, b_, beta, alpha, phi)
                fB = refine._phi(b_) if phi else torch.tril(b_)
                scale = abs(beta) * a_.abs() + abs(alpha) * (torch.tril(a_).abs() @ fB.abs())
                check(bool((torch.triu(C, 1) == 0).all()), f"K8t upper triangle not 0 ({tag})")
                e_t.append(_dot_units(torch, C - Cp, scale, b))
                if b == CHOL_BLOCK and cond_req == MIXED_CONDS[0]:
                    absd["K8t"] = max(absd.get("K8t", 0.0), float((C - Cp).abs().max()))
            for e in e_t:
                held("K8t", e, tag)
            if b == CHOL_BLOCK and cond_req == MIXED_CONDS[0]:
                absd["K8r"] = float((E - Ep).abs().max())
            graph = _refined_graph_vs_launches(torch, refine, A, tag)
            say(f"[phase 2e] K8r/K8t {tag}: K8r max|dE|/max|A| {e_r:.2e}, sums {e_s[0]:.2e}/"
                f"{e_s[1]:.2e}, reproducible; K8t (units of 2 b eps64 |A||f(B)|) L M "
                f"{e_t[0]:.2e}, 2M - M P {e_t[1]:.2e}, L + L Phi(X) {e_t[2]:.2e}; "
                f"refined_cholesky's graph: {graph}")
    b = CHOL_BLOCK
    for n in K9U_SIZES:
        A = (_noisy_matern_spd(torch, gram, n, MIXED_CONDS[0], 400 + n)[0] if n <= 4099
             else _large_gram(gp, gnp, n))
        gc.collect()
        torch.cuda.empty_cache()  # the gram's temporaries: n = 51200 holds two n^2 here
        A1 = torch.empty_like(A)
        for c0 in sorted({0, ((n - 1) // b // 2) * b, ((n - 1) // b - 1) * b}):
            A1.copy_(A)  # the same input for both
            off = c0 + b
            T = A[off:, c0:off].clone()
            ochol.trailing_update_cuda(A1, c0, b)
            ochol.trailing_update_plain(A, c0, b)
            err, dmax, sym = _k9u_units(torch, A1, A, T, off, b)
            check(sym, f"K9u trailing block not symmetric (n={n}, c0={c0})")
            check(torch.equal(A1[:off], A[:off]) and torch.equal(A1[off:, :off], A[off:, :off]),
                  f"K9u wrote outside the trailing block (n={n}, c0={c0})")
            held("K9u", err, f"n={n} c0={c0}")
            if n == RESIDENT_N and c0 == 0:
                absd["K9u"] = dmax
            say(f"[phase 2e] K9u n={n} panel [{c0}, {off}): max|dS| in units of 2 b eps64 "
                f"(|S| + |T||T|^T) {err:.2e} (tol {TOL_2E['K9u']}), max|dS| {dmax:.2e}")
            # the next panel's input is the gram again (S - T T^T + T T^T, to
            # rounding; both versions read only the lower triangle): without
            # the factor's panel solve in between, updated entries would grow
            # by |T|^2 b per panel
            A[off:, off:].addmm_(T, T.T)
        del A, A1, T
        gc.collect()
        torch.cuda.empty_cache()
    for n in K9M_SIZES:
        gen = torch.Generator(device=DEVICE).manual_seed(n)
        P = torch.randn(n, n, dtype=torch.float64, device=DEVICE, generator=gen)
        same = []
        for cuda_fn, plain_fn in ((ochol.murray_phi_cuda, ochol.murray_phi_plain),
                                  (ochol.symmetrize_cuda, ochol.symmetrize_plain)):
            X1, X2 = P.clone(), P.clone()
            cuda_fn(X1)
            plain_fn(X2)
            same.append(torch.equal(X1, X2))
            held("K9m", float((X1 - X2).abs().max()), f"n={n}")
        say(f"[phase 2e] K9m n={n}: phi bitwise {same[0]}, symmetrize bitwise {same[1]}")
    absd["K9m"] = 0.0
    say("[phase 2e] worst " + ", ".join(f"{k} {v:.3e} (tol {TOL_2E[k]})"
                                        for k, v in sorted(worst.items())))
    return absd


def _cond_estimate(torch, K, iters=40):
    """cond(K) ~ lambda_max / lambda_min by power and inverse power iteration
    (cuSOLVER's f64 factor for the inverse): a lower bound that converges
    from below."""
    C = torch.linalg.cholesky_ex(K)[0]
    v = torch.ones(K.shape[0], 1, dtype=K.dtype, device=K.device)
    w = v.clone()
    for _ in range(iters):
        v = K @ v
        v /= v.norm()
        w = torch.cholesky_solve(w, C)
        w /= w.norm()
    lam_max = float((v.T @ (K @ v)).squeeze())
    lam_min = float((w.T @ (K @ w)).squeeze())
    return lam_max / lam_min


def phase_resident(gp, gnp, torch, gram, distance, mixed, refine, ochol, st):
    """Phase 3e: the resident one-card mesh path at full size."""
    from gpmp_tpu_torch import parallel
    from gpmp_tpu_torch.parallel import chol as pchol
    from gpmp_tpu_torch.parallel import mixed as pmixed

    t_phase = time.perf_counter()
    eps64 = float(np.finfo(np.float64).eps)
    n = RESIDENT_N
    xi, zi, p0 = _large_data(n)
    xt = _large_xt(n)
    gp.config.set_device(DEVICE)
    mesh = parallel.make_mesh(1, axis_name="shard")
    block = parallel.auto_shard_block(n, mesh)
    check(block == CHOL_BLOCK, f"auto_shard_block({n}) = {block}")
    counters = _resident_counters(refine, ochol)
    guard = (gram, distance, mixed, refine, ochol)
    walls, mem, per_call = {}, {}, {}
    unit = 4 * n * n

    # (a) the f64 engine: REML fit, predict and LOO through the mesh
    gp.config.set_chol_engine("f64")
    model = _large_model(gp, gnp)
    vg_mesh, _ = _criterion(gp, model, xi, zi, mesh)
    vg_core, _ = _criterion(gp, model, xi, zi)
    with _PlainGuard(*guard):
        _reset(counters)
        ((v0, g0), walls["f64 mesh value+grad (first)"]), mem["f64 mesh value+grad"] = _peak_rise(
            torch, lambda: _timed(torch, lambda: vg_mesh(p0)))
        per_call["value+grad"] = _read(counters)
        _, walls["f64 mesh value+grad (warm)"] = _timed(torch, lambda: vg_mesh(p0 + 1e-3))
        _reset(counters)
        fit_model = _large_model(gp, gnp)
        (fit_model, info), walls["fit"] = _timed(
            torch, lambda: gp.kernel.select_parameters_with_reml(
                fit_model, xi, zi, covparam0=p0, mesh=mesh, method="L-BFGS-B",
                method_options={"maxiter": RESIDENT_MAXITER}, info=True))
        launches = _read(counters)
        p_fit = np.asarray(info.x)
        view = parallel.ShardedModelView(fit_model, mesh)
        _reset(counters)
        ((zpm, zpv), walls["predict"]), mem["predict"] = _peak_rise(
            torch, lambda: _timed(torch, lambda: view.predict(xi, zi, xt)))
        per_call["predict"] = _read(counters)
        _reset(counters)
        ((zloo, s2loo, eloo), walls["loo"]), mem["loo"] = _peak_rise(
            torch, lambda: _timed(torch, lambda: view.loo(xi, zi)))
        per_call["loo"] = _read(counters)
        v_fit, g_fit = vg_mesh(p_fit)
    for key in counters:
        launches[key] += per_call["predict"][key] + per_call["loo"][key]
    say(f"[phase 3e] (a) n={n} f64, make_mesh(1), block {block}: fit (L-BFGS-B, maxiter "
        f"{RESIDENT_MAXITER}) nfev {info.nfev}, {walls['fit']:.3f} s, REML "
        f"{info.history_criterion[0]!r} at p0 -> {info.fun!r}, covparam "
        f"{np.array2string(p_fit, precision=4)}; predict {walls['predict']:.3f} s, LOO "
        f"{walls['loo']:.3f} s; launches (fit + predict + LOO) {launches}; per value+grad "
        f"{per_call['value+grad']}, per predict {per_call['predict']}, per LOO {per_call['loo']}")
    for key, count in launches.items():
        check(count > 0, f"{key} was not launched on the resident mesh path")
    check(np.isfinite(info.fun) and info.fun <= info.history_criterion[0],
          "the resident fit ended above its start or not finite")

    # the core f64 engine (cuSOLVER) at p0 and at the fit
    v0c, g0c = vg_core(p0)
    _, walls["f64 core value+grad (warm)"] = _timed(torch, lambda: vg_core(p0 + 1e-3))
    v_fitc, g_fitc = vg_core(p_fit)
    e_v = max(abs(v0 - v0c) / abs(v0c), abs(v_fit - v_fitc) / abs(v_fitc))
    e_g = max(float(np.max(np.abs(g0 - g0c)) / np.max(np.abs(g0c))),
              float(np.max(np.abs(g_fit - g_fitc)) / np.max(np.abs(g_fitc))))
    core_model = _large_model(gp, gnp)
    core_model.covparam = gnp.asarray(p_fit)
    zpm_c, zpv_c = core_model.predict(xi, zi, xt, convert_out=False)
    loo_c = core_model.loo(xi, zi)
    K = parallel.sharded_covariance(core_model, gnp.asarray(p_fit), gnp.asarray(xi), mesh)
    kappa = _cond_estimate(torch, K)
    prior = float((core_model.covariance(gnp.asarray(xt), None, gnp.asarray(p_fit),
                                         pairwise=True)).abs().max())
    # the worst refined panel's err2 = |A - L L^T|_F^2 / |A|_F^2 over one
    # factor at the fit, and the launches per factor and per solve
    err2s = []
    orig = pchol.refined_cholesky

    def recording(A, **kw):
        out = orig(A, **kw)
        Lp = out[0] if isinstance(out, tuple) else out
        err2s.append(float(((A - Lp @ Lp.T) ** 2).sum() / (A * A).sum()))
        return out

    with _PlainGuard(*guard), _Patched(pchol, refined_cholesky=recording):
        _reset(counters)
        L = pchol._factor_in_place(K, mesh, block)
        per_call["factor"] = _read(counters)
        _reset(counters)
        pchol.blocked_solve_lower(L, gnp.asarray(zi), block=block, mesh=mesh)
        per_call["solve"] = _read(counters)
    del K, L
    tol_k = RESIDENT_SLACK * kappa * eps64
    e_pm = rel_err(zpm, zpm_c)
    e_pv = float((zpv - zpv_c).abs().max()) / prior
    e_loo = [rel_err(a, b) for a, b in zip((zloo, s2loo, eloo), loo_c)]
    say(f"[phase 3e] (a) vs the core f64 engine (cuSOLVER): REML rel {e_v:.2e} (tol "
        f"{TOL_RESIDENT['reml']}), grad {e_g:.2e} (tol {TOL_RESIDENT['grad']}); cond(K) at the "
        f"fit ~{kappa:.3e} (power iteration), worst panel err2 {max(err2s):.3e} over "
        f"{len(err2s)} panels (guard {refine._FACTOR_RTOL2}); predict mean {e_pm:.2e}, variance "
        f"{e_pv:.2e} of the prior variance, LOO {', '.join(f'{e:.2e}' for e in e_loo)} (tol "
        f"{RESIDENT_SLACK:g} cond(K) eps64 = {tol_k:.2e}); per factor {per_call['factor']}, "
        f"per solve {per_call['solve']}")
    check(e_v <= TOL_RESIDENT["reml"] and e_g <= TOL_RESIDENT["grad"],
          "the resident f64 REML against the core f64 engine")
    check(max(e_pm, e_pv, *e_loo) <= tol_k, "resident predict/LOO against the core f64 engine")
    check(max(err2s) < refine._FACTOR_RTOL2, "a refined panel missed the guard")

    # (b) the mixed engine: the dispatcher keeps n on the resident branch
    gp.config.set_chol_engine("mixed")
    applicable = st.streamed_applicable(model, gnp.asarray(p0), gnp.asarray(xi), mesh, "shard")
    check(st.STREAM_MIN_N is None and st._resident_fits(n) and not applicable,
          f"the dispatcher did not choose the resident branch at n={n}")
    mc = {k: (mixed, f"{k}_LAUNCHES") for k in ("K3", "K4", "K5", "K6", "K7")}
    branches = []
    core_fn = pmixed._mp_core

    def recording_core(*a):
        out = core_fn(*a)
        branches.append("series" if out[2][1] else "robust")
        return out

    level2 = []
    level2_fn = pmixed._streamed_level2_g

    def recording_level2(*a):
        g1, g2 = level2_fn(*a)
        level2.append(float(g2))
        return g1, g2

    vg_mix, _ = _criterion(gp, model, xi, zi, mesh)
    with _PlainGuard(*guard), _Patched(pmixed, _mp_core=recording_core,
                                       _streamed_level2_g=recording_level2):
        _reset(mc)
        ((vm0, gm0), walls["mixed mesh value+grad (first)"]), mem["mixed mesh value+grad"] = (
            _peak_rise(torch, lambda: _timed(torch, lambda: vg_mix(p0))))
        mixed_launches = _read(mc)
        vm1, gm1 = vg_mix(p_fit)
        _, walls["mixed mesh value+grad (warm)"] = _timed(torch, lambda: vg_mix(p0 + 1e-3))
    gp.config.set_chol_engine("f64")
    g_tr, g_q = _reml_grad_terms(gp, gnp, torch, p_fit, xi, zi, model=_large_model(gp, gnp))
    env_s2, env_rest = TOL_RESIDENT["mixed grad"]
    env = np.array([env_s2] + [env_rest] * (len(p0) - 1))
    e_vm = max(abs(vm0 - v0) / abs(v0), abs(vm1 - v_fit) / abs(v_fit))
    e_g0 = np.abs(gm0 - g0) / np.abs(g0)
    e_g1 = np.abs(gm1 - g_fit) / np.maximum.reduce([np.abs(g_fit), np.abs(g_tr), np.abs(g_q)])
    say(f"[phase 3e] (b) n={n} mixed, dispatcher: resident (streamed applicable {applicable}, "
        f"model {st._RESIDENT_PEAK_UNITS} units); logdet branches {branches}, level-2 "
        f"|G|_F^2 {', '.join(f'{g:.3e}' for g in level2)} (gate {st._level2_tau(n):.3e}; the JAX "
        f"module's absolute gate 1e-8); launches "
        f"{mixed_launches}; REML vs (a) rel {e_vm:.2e} (tol {TOL_RESIDENT['mixed reml']}); grad at "
        f"p0 {np.array2string(e_g0, precision=2)}, at the fit (relative to the trace and "
        f"quadratic terms) {np.array2string(e_g1, precision=2)} (envelope {env.tolist()})")
    for key, count in mixed_launches.items():
        check(count > 0, f"{key} was not launched on the resident mixed branch")
    check(e_vm <= TOL_RESIDENT["mixed reml"] and np.all(e_g0 <= env) and np.all(e_g1 <= env),
          "the resident mixed branch against the f64 resident branch")
    del vg_mix, vg_mesh, vg_core
    gc.collect()
    torch.cuda.empty_cache()

    # (b) at n = 32768, the largest size phase 3d names, where the memory
    # model (_RESIDENT_PEAK_UNITS) keeps the dispatcher on the resident
    # branch too: one value+grad at p0, its peak rise against the model, its
    # REML against the core f64 engine (cuSOLVER, value only, as phase 3d(a)
    # holds the stream) and its gradient against the f64 resident branch
    nb = RESIDENT_MODEL_N
    xib, zib, pb = _large_data(nb)
    gp.config.set_chol_engine("mixed")
    model_b = _large_model(gp, gnp)
    applicable_b = st.streamed_applicable(model_b, gnp.asarray(pb), gnp.asarray(xib), mesh,
                                          "shard")
    check(st._resident_fits(nb) and not applicable_b,
          f"the dispatcher did not choose the resident branch at n={nb}")
    vg_b, _ = _criterion(gp, model_b, xib, zib, mesh)
    branches.clear()
    level2.clear()
    with _PlainGuard(*guard), _Patched(pmixed, _mp_core=recording_core,
                                       _streamed_level2_g=recording_level2):
        _reset(mc)
        ((vb, gb), walls[f"mixed mesh value+grad n={nb}"]), mem_b = _peak_rise(
            torch, lambda: _timed(torch, lambda: vg_b(pb)))
        launches_b = _read(mc)
    del vg_b
    gc.collect()
    torch.cuda.empty_cache()
    gp.config.set_chol_engine("f64")
    with torch.no_grad():
        vb64 = float(model_b.negative_log_restricted_likelihood(
            gnp.asarray(pb), gnp.asarray(xib), gnp.asarray(zib)))
    vg_b64, _ = _criterion(gp, model_b, xib, zib, mesh)
    with _PlainGuard(*guard):
        (vbm, gbm), walls[f"f64 mesh value+grad n={nb}"] = _timed(torch, lambda: vg_b64(pb))
    del vg_b64
    gc.collect()
    torch.cuda.empty_cache()
    units_b = mem_b / (4 * nb * nb)
    e_vb, e_vbm = abs(vb - vb64) / abs(vb64), abs(vbm - vb64) / abs(vb64)
    e_gb = np.abs(gb - gbm) / np.abs(gbm)
    say(f"[phase 3e] (b) n={nb} mixed, dispatcher: resident (streamed applicable "
        f"{applicable_b}); peak rise {mem_b / 2**30:.3f} GiB = {units_b:.2f} units of 4n^2 B "
        f"(model {st._RESIDENT_PEAK_UNITS}); logdet branches {branches}, level-2 |G|_F^2 "
        f"{', '.join(f'{g:.3e}' for g in level2)} (gate {st._level2_tau(nb):.3e}); launches "
        f"{launches_b}; REML {vb!r} vs the core f64 engine {vb64!r} rel {e_vb:.2e} (tol "
        f"{TOL_RESIDENT['mixed reml']}); f64 resident branch REML rel {e_vbm:.2e} (tol "
        f"{TOL_RESIDENT['reml']}), mixed grad vs it {np.array2string(e_gb, precision=2)} "
        f"(envelope {env.tolist()})")
    for key, count in launches_b.items():
        check(count > 0, f"{key} was not launched on the resident mixed branch at n={nb}")
    check(units_b <= st._RESIDENT_PEAK_UNITS,
          f"the resident mixed branch's peak at n={nb} exceeds the dispatcher's model")
    check(e_vb <= TOL_RESIDENT["mixed reml"] and e_vbm <= TOL_RESIDENT["reml"]
          and np.all(e_gb <= env), f"the resident branches at n={nb} against the f64 engine")

    # (c) n = 51200, f64: bench_large_n.py --mode parity on one device
    n3 = RESIDENT_BIG_N
    xi3, zi3, p3 = _large_data(n3)
    xt3 = _large_xt(n3)
    model3 = _large_model(gp, gnp)
    model3.covparam = gnp.asarray(p3)
    x3, z3, c3 = gnp.asarray(xi3), gnp.asarray(zi3), gnp.asarray(p3)
    block3 = parallel.auto_shard_block(n3, mesh)
    with _PlainGuard(*guard):
        _reset(counters)
        K3 = parallel.sharded_covariance(model3, c3, x3, mesh)
        L3, walls[f"factor n={n3} (sharded_cholesky)"] = _timed(
            torch, lambda: parallel.sharded_cholesky(K3, mesh, block=block3))
        del K3
        per_call[f"factor n={n3}"] = _read(counters)
        v3 = float(parallel.sharded_negative_log_restricted_likelihood(
            model3, c3, x3, z3, mesh, block=block3, factor=L3))
        (zpm3, zpv3), walls[f"predict n={n3} (factor=)"] = _timed(
            torch, lambda: parallel.sharded_predict(model3, xi3, zi3, xt3, mesh, block=block3,
                                                    factor=L3))
        pg = c3.clone().requires_grad_(True)
        vg3 = parallel.sharded_negative_log_restricted_likelihood(
            model3, pg, x3, z3, mesh, block=block3, factor=L3)
        try:
            torch.autograd.grad(vg3, pg)
            refused = False
        except ValueError as exc:
            refused = "factor=" in str(exc)
    del L3, vg3
    gc.collect()
    torch.cuda.empty_cache()
    # the core f64 engine (cuSOLVER potrf + potrs through core.kriging) on the
    # covariance built once: the user kernel's own (n, n) temporaries (the
    # distances, the polynomial, the noise term) do not fit the card twice
    K3 = parallel.sharded_covariance(model3, c3, x3, mesh)
    torch.cuda.empty_cache()  # the gram's cached temporaries: potrf needs two more n^2

    def cached(x, y, c, pairwise=False):
        if not pairwise and y is not None and x.shape[0] == n3 and y.shape[0] == n3:
            return K3
        return model3.covariance(x, y, c, pairwise)

    core3 = gp.Model(model3.mean, cached, covparam=c3)
    zpm3c, zpv3c = core3.predict(xi3, zi3, xt3, convert_out=False)
    del K3, core3
    gc.collect()
    torch.cuda.empty_cache()
    e_or = abs(v3 - REML_ORACLE_51200) / abs(REML_ORACLE_51200)
    e_p3 = (rel_err(zpm3, zpm3c), rel_err(zpv3, zpv3c))
    t_factor3 = walls[f"factor n={n3} (sharded_cholesky)"]
    say(f"[phase 3e] (c) n={n3} f64, block {block3}: factor {t_factor3:.3f} s "
        f"(launches {per_call[f'factor n={n3}']}); REML factor= {v3!r} vs the NumPy oracle "
        f"{REML_ORACLE_51200!r} (PARITY_51200_r03.json) rel {e_or:.2e} (tol "
        f"{TOL_RESIDENT['oracle']}); predict (NT=64) vs the core f64 engine mean {e_p3[0]:.2e}, "
        f"variance {e_p3[1]:.2e} (tol {TOL_RESIDENT['predict']}); a gradient through factor= "
        f"raised: {refused}")
    check(e_or <= TOL_RESIDENT["oracle"], "the n=51200 REML against the oracle")
    check(max(e_p3) <= TOL_RESIDENT["predict"], "the n=51200 predict against the core f64 engine")
    check(refused, "a gradient through factor= did not raise")
    for what, b in mem.items():
        say(f"[phase 3e] peak rise, {what} n={n}: {b / 2**30:.3f} GiB = {b / unit:.2f} units of "
            f"4n^2 B")
    say(f"[phase 3e] walls: " + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items()))
    say(f"[phase 3e] phase seconds {time.perf_counter() - t_phase:.1f}")
    gp.config.set_chol_engine("auto")
    ref = {"v0": v0, "g0": g0, "vm0": vm0, "gm0": gm0, "p_fit": p_fit, "predict": (zpm, zpv),
           "loo": (zloo, s2loo, eloo), "walls": walls, "mem": mem, "per_call": per_call}
    return launches, per_call, walls, mem, ref


def _bound(nbytes, flops, peak):
    """(bound_ms, bound_by): the larger of the bytes at the memory rate and the
    operations at their peak."""
    t_b, t_o = nbytes / PEAK_BYTES_PER_S, flops / peak
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


def _k9u_bound(n, b, c0):
    """K9u on the panel [c0, c0 + b): reads the lower trailing block and T,
    writes the whole trailing block; 2 b operations per lower entry at the
    f64 tensor peak."""
    m = n - c0 - b
    tri_m = m * (m + 1) // 2
    return _bound(8 * (tri_m + m * b) + 8 * m * m, 2 * tri_m * b, PEAK_F64_TENSOR_FLOPS)


def _resident_bounds(n, b=CHOL_BLOCK):
    """(bound_ms, bound_by) of the new kernels at the shapes phase 4e times:
    K8r/K8t on one b x b panel, K9u at the first panel of an n factor, K9m's
    two in-place passes at n."""
    bound = _bound
    tri_b = b * (b + 1) // 2
    fma_r = sum((b - j) * (j + 1) for j in range(b))  # sum over i >= j of (j + 1)
    fma_t = b * (b + 1) * (b + 2) // 6                 # sum over i >= j of (i - j + 1)
    return {
        # reads the lower triangles of A (symmetric: E and sum A^2 need no
        # more) and L, writes E; the guard's sums
        "K8r": bound(8 * 2 * tri_b + 8 * b * b, 2 * fma_r + 3 * tri_b,
                     PEAK_F64_TENSOR_FLOPS),
        # reads the lower triangles of A and B, writes C
        "K8t": bound(8 * 2 * tri_b + 8 * b * b, 2 * fma_t + 2 * tri_b, PEAK_F64_TENSOR_FLOPS),
        "K9u": _k9u_bound(n, b, 0),
        # phi writes the strict upper triangle's zeros and rewrites the
        # diagonal (the lower entries it keeps need no traffic); sym reads
        # and writes every entry
        "K9m": bound(8 * (n * n - n) // 2 + 16 * n + 16 * n * n, 2 * n * n, PEAK_F64_FLOPS),
    }


def _k9u_probe(torch, ochol, K, W, b):
    """Phase 4e's look inside K9u's kernel at the first panel of K: each sm_90
    f64 mma shape (time and rate in two turns, each held to the plain
    version), the ptxas lines of csrc/syrk_f64.cuh's instances (K9u, K9s,
    K4, K4s) and of the f32 K9s, and the panel at b / 2, b and 2 b, which
    splits a wave of tiles into a fixed part (the ring's fill, the epilogue)
    and the k loop's rate."""
    from gpmp_tpu_torch.ops import _build as build

    n = K.shape[0]
    t = lambda fn, reps: _time_cuda(torch, fn, reps, warmup=1)  # noqa: E731
    chosen = build.load().gpmp_syrk_mma_k()
    m = n - b
    flops = m * (m + 1) * b
    A2 = ochol.trailing_update_plain(K.clone(), 0, b)
    T = K[b:, :b].clone()
    errs = {}
    for mk in (4, 8, 16):
        W.copy_(K)
        ochol.trailing_update_probe(W, 0, b, mk)
        err, _dmax, sym = _k9u_units(torch, W, A2, T, b, b)
        check(sym and err <= TOL_2E["K9u"],
              f"K9u's m16n8k{mk} shape: {err:.3e} units of 2 b eps64, symmetric {sym}")
        errs[mk] = err
    del A2, T
    turns = {mk: [] for mk in errs}
    for _ in range(2):
        for mk in turns:
            turns[mk].append(t(lambda: ochol.trailing_update_probe(W, 0, b, mk), 10))
    say(f"[phase 4e] K9u mma shape probe, n={n} first panel ({flops / 1e9:.1f} GFLOP; the path "
        f"runs m16n8k{chosen}): " + ", ".join(
            f"m16n8k{mk} " + "/".join(f"{ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s)"
                                      for ms in turns[mk]) + f" [{errs[mk]:.2e} units]"
            for mk in turns))
    for line in _ptxas_core_lines((build.build_dir() / "ptxas.log").read_text(), chosen):
        say(f"[phase 4e] ptxas {line}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_wave = {}
    for bb in (b // 2, b, 2 * b):
        rt = -(-(n - bb) // ochol.SYRK_TILE)
        ms = t(lambda: ochol.trailing_update_cuda(W, 0, bb), 5)
        per_wave[bb] = ms * 1e3 / (rt * (rt + 1) / 2 / sms)
    t1 = (per_wave[2 * b] - per_wave[b // 2]) / (1.5 * b)  # us per k column of a wave
    t0 = per_wave[b // 2] - b // 2 * t1
    say(f"[phase 4e] K9u first panel by b, us per wave of {sms} tiles: "
        + ", ".join(f"b={bb} {v:.2f}" for bb, v in per_wave.items())
        + f"; fixed part {t0:.2f} us a wave, k loop {2 * ochol.SYRK_TILE ** 2 * sms / t1 / 1e6:.2f}"
        " TFLOP/s")


# csrc/syrk_f64.cuh's modes, as they appear in mma_tile_kernel's mangled name
PTXAS_MODES = {"Trailing": "K9u", "Slab": "K9s f64", "ResidualIdE": "K4 (K f64)",
               "ResidualIfE": "K4 (K f32; K8s with K f32)", "ResidualSlab": "K4s",
               "SamplingResidual": "K8s (K f64)", "PairResidual": "K10r (pair)",
               "PanelResidual": "K10r (panel)"}


def _ptxas_core_lines(log, mma_k):
    """ptxas's registers and spills of every instance of csrc/syrk_f64.cuh's
    mma_tile_kernel (its mode, tile width, copy bytes and mma shape decoded
    from the mangled name; "path" where the mma shape is the built one,
    mma_k), of csrc/syrk_f32.cu's slab_update_f32_kernel (the f32 K9s), of
    csrc/chol.cu's tri_product_kernel (K8t) and refine_residual_kernel
    (K8r), by copy bytes, and of csrc/mixed.cu's ff_residual_kernel (K10m)
    and residual_kernel (K3), by type, k and load width, one line each, from
    the text of a ptxas log."""
    import re

    core = re.compile(r"mma_tile_kernelINS0_\d+([A-Za-z]+?(?:I[df]E)?)ENS0_3GeoILi(\d+)E"
                      r"Li\d+ELi\d+ELi\d+EEELi(\d+)ELi(\d+)E")
    out, entry, info = [], None, []
    for line in log.splitlines() + ["Compiling entry function (end)"]:
        if "Compiling entry function" in line:
            if entry:
                out.append(f"{entry}: " + "; ".join(info))
            mo = core.search(line)
            entry = None
            if mo:
                mode, tile, cpb, mk = mo.group(1), *map(int, mo.group(2, 3, 4))
                entry = (f"{PTXAS_MODES.get(mode, mode)} {tile}-wide tiles, {cpb}-byte copies, "
                         f"m16n8k{mk}{' (path)' if mk == mma_k else ''}")
            elif "slab_update_f32_kernel" in line:
                entry = "K9s f32 (slab_update_f32_kernel)"
            elif "ff_residual_kernel" in line:
                kv = re.search(r"ff_residual_kernelILi(\d+)ELb([01])E", line)
                entry = (f"K10m (ff_residual_kernel, k={kv.group(1)}, "
                         f"{16 if kv.group(2) == '1' else 4}-byte loads)" if kv
                         else "K10m (ff_residual_kernel)")
            elif "tri_product_kernel" in line:
                cpb = re.search(r"tri_product_kernelILi(\d+)E", line)
                entry = f"K8t (tri_product_kernel, {cpb.group(1) if cpb else '?'}-byte copies)"
            elif "refine_residual_kernel" in line:
                cpb = re.search(r"refine_residual_kernelILi(\d+)E", line)
                entry = f"K8r (refine_residual_kernel, {cpb.group(1) if cpb else '?'}-byte copies)"
            elif "residual_kernel" in line:
                kv = re.search(r"residual_kernelI([df])Li(\d+)ELb([01])E", line)
                f64 = kv and kv.group(1) == "d"
                entry = (f"K3 (residual_kernel, {'f64' if f64 else 'f32'}, k={kv.group(2)}, "
                         f"{16 if kv.group(3) == '1' else 8 if f64 else 4}-byte loads)" if kv
                         else "K3 (residual_kernel)")
            info = []
        elif entry and ("registers" in line or "spill" in line):
            info.append(line.split("info    :")[-1].strip())
    return out


def phase_resident_times(gp, gnp, torch, gram, refine, ochol, walls3e):
    """Phase 4e: the new kernels' times (CUDA events, profiler device time),
    their plain versions and library calls, the whole factor against
    cuSOLVER's, and the resident path's walls."""
    from gpmp_tpu_torch.parallel import chol as pchol
    from gpmp_tpu_torch import parallel

    b, n = CHOL_BLOCK, RESIDENT_N
    t = lambda fn, reps: _time_cuda(torch, fn, reps, warmup=1)  # noqa: E731
    times, device = {}, {}
    A, _ = _noisy_matern_spd(torch, gram, b, MIXED_CONDS[0], 300 + b)
    L32 = torch.linalg.cholesky(A.float())
    L = L32.double().contiguous()
    eye = torch.eye(b, dtype=torch.float32, device=DEVICE)
    M = torch.linalg.solve_triangular(L32, eye, upper=False).double().contiguous()
    times["K8r"] = (t(lambda: refine.refine_residual_cuda(A, L), 50),
                    t(lambda: refine.refine_residual_plain(A, L), 50),
                    t(lambda: torch.addmm(A, L, L.T, alpha=-1), 50))
    device["K8r"] = _device_ms(torch, lambda: refine.refine_residual_cuda(A, L), 20)
    times["K8t"] = (t(lambda: refine.tri_product_cuda(L, M), 50),
                    t(lambda: refine.tri_product_plain(L, M), 50),
                    t(lambda: torch.matmul(L, M), 50))
    device["K8t"] = _device_ms(torch, lambda: refine.tri_product_cuda(L, M), 20)
    host = {"K8t": _k8t_host_path(torch, refine, L, M),
            "K8r": _host_path(torch, _k8r_host_parts(torch, refine, A, L))}
    for key in ("K8t", "K8r"):
        say(f"[phase 4e] {key} b={b}: events {times[key][0] * 1e3:.2f} us, device "
            f"{_fmt_ms(device[key])}, library events {times[key][2] * 1e3:.2f} us; "
            f"host issue per call ({HOST_ISSUE_CALLS} calls, the card kept busy): "
            + ", ".join(f"{k} {v:.2f} us" for k, v in host[key].items()))
    host["refined_cholesky"] = _refined_cholesky_walls(torch, refine, A)
    host[f"resident f64 value+grad n={GRAPH_AB_N} ms"] = _graph_value_grad_ab(gp, gnp, torch,
                                                                             refine)
    # K8r against the other candidate core, csrc/syrk_f64.cuh's 64-wide tiles
    # (K4's geometry; 36 lower tiles at b = 512): its f32-operand instance
    # K8s on the same panel stages half the bytes of an f64-operand one over
    # the same tiles and k steps, so its time bounds that candidate's below
    cand = {}
    for bb in (b, 488):
        Ab, _ = _noisy_matern_spd(torch, gram, bb, MIXED_CONDS[0], 300 + bb)
        L32b = torch.linalg.cholesky(Ab.float()).contiguous()
        Lb = L32b.double()
        cand[bb] = (_device_ms(torch, lambda: refine.refine_residual_cuda(Ab, Lb), 20),
                    _device_ms(torch, lambda: refine.sampling_residual_cuda(Ab, L32b), 20))
    host["K8r candidates device ms (K8r, K4's core as K8s)"] = cand
    say("[phase 4e] K8r against K4's 64-wide core (K8s on the same panel, f32 operands: a "
        "lower bound of an f64-operand instance), device ms: " + ", ".join(
            f"b={bb} K8r {_fmt_ms(v[0])} / K8s {_fmt_ms(v[1])}" for bb, v in cand.items()))
    K = _large_gram(gp, gnp, n)
    W = K.clone()
    bounds = _resident_bounds(n)
    # K9u at the first, a middle and the last panel (phase 2e's), beside
    # torch.addmm on the same trailing block
    for c0 in sorted({0, ((n - 1) // b // 2) * b, ((n - 1) // b - 1) * b}):
        key = "K9u" if c0 == 0 else f"K9u c0={c0}"
        off = c0 + b
        S, T = K[off:, off:], K[off:, c0:off]
        reps = 10 if c0 == 0 else 30
        times[key] = (t(lambda: ochol.trailing_update_cuda(W, c0, b), reps),
                      t(lambda: ochol.trailing_update_plain(W, c0, b), 3),
                      t(lambda: torch.addmm(S, T, T.T, alpha=-1.0), reps))
        device[key] = _device_ms(torch, lambda: ochol.trailing_update_cuda(W, c0, b), 5)
        bounds[key] = _k9u_bound(n, b, c0)
        del S, T
    _k9u_probe(torch, ochol, K, W, b)
    W.copy_(K)
    times["K9m"] = (
        t(lambda: ochol.murray_phi_cuda(W), 10) + t(lambda: ochol.symmetrize_cuda(W), 10),
        t(lambda: ochol.murray_phi_plain(W), 3) + t(lambda: ochol.symmetrize_plain(W), 3), None)
    parts = (_device_ms(torch, lambda: ochol.murray_phi_cuda(W), 5),
             _device_ms(torch, lambda: ochol.symmetrize_cuda(W), 5))
    device["K9m"] = None if None in parts else sum(parts)
    del W
    # the whole factor against cuSOLVER's f64 potrf, n = 16384 and 51200
    factor = {}
    W = K.clone()
    _, factor[f"blocked n={n}"] = _timed(torch, lambda: pchol._blocked_cholesky_(W, b))
    W.copy_(K)
    _, factor[f"blocked n={n} (warm)"] = _timed(torch, lambda: pchol._blocked_cholesky_(W, b))
    del W
    _, factor[f"cholesky_ex n={n}"] = _timed(torch, lambda: torch.linalg.cholesky_ex(K))
    _, factor[f"cholesky_ex n={n} (warm)"] = _timed(torch, lambda: torch.linalg.cholesky_ex(K))
    del K
    gc.collect()
    torch.cuda.empty_cache()
    K = _large_gram(gp, gnp, RESIDENT_BIG_N)
    _, factor[f"cholesky_ex n={RESIDENT_BIG_N}"] = _timed(
        torch, lambda: torch.linalg.cholesky_ex(K))
    del K
    gc.collect()
    torch.cuda.empty_cache()
    factor[f"blocked n={RESIDENT_BIG_N} (phase 3e, with its clone of K)"] = walls3e[
        f"factor n={RESIDENT_BIG_N} (sharded_cholesky)"]
    shapes = {"K8r": f"b={b}", "K8t": f"b={b}", "K9u": f"n={n} first panel", "K9m": f"n={n}"}
    for key, (t_k, t_p, t_l) in times.items():
        b_ms, b_by = bounds[key]
        lib = "none" if t_l is None else f"{t_l:.4f} ms"
        say(f"[phase 4e] {key} {shapes.get(key, f'n={n}')}: kernel {t_k:.4f} ms (device "
            f"{_fmt_ms(device[key])}), "
            f"plain {t_p:.4f} ms, library {lib}, bound {b_ms:.4f} ms ({b_by}), "
            f"share {100 * b_ms / t_k:.1f}%")
    say("[phase 4e] whole factor: " + ", ".join(f"{k} {v:.3f} s" for k, v in factor.items())
        + f"; K9u's bound over a factor (n^3/3 flops at the f64 tensor peak) "
        f"{n ** 3 / 3 / PEAK_F64_TENSOR_FLOPS:.4f} s at n={n}, "
        f"{RESIDENT_BIG_N ** 3 / 3 / PEAK_F64_TENSOR_FLOPS:.4f} s at n={RESIDENT_BIG_N}")
    return times, bounds, device, factor, host


def phase_profile_large(gp, gnp, torch):
    """Phase 5, large n: torch.profiler over one ff REML value+grad at
    LARGE_N, device time by kernel group."""
    from torch.profiler import ProfilerActivity, profile

    from gpmp_tpu_torch import parallel

    from gpmp_tpu_torch.parallel import streamed as st

    xi, zi, p0 = _large_data(LARGE_N)
    gp.config.set_device(DEVICE)
    gp.config.set_chol_engine("mixed")
    vg, _ = _criterion(gp, _large_model(gp, gnp), xi, zi, parallel.make_mesh(1, axis_name="shard"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _Patched(st, STREAM_MIN_N=LARGE_N), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        vg(p0 + 1e-3)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    summary = _profile_groups(prof, wall_ms, f"ff n={LARGE_N}")
    del vg
    # the resident f64 branch's value+grad (the blocked factor, Murray's backward)
    xi2, zi2, p2 = _large_data(RESIDENT_N)
    gp.config.set_chol_engine("f64")
    vg2, _ = _criterion(gp, _large_model(gp, gnp), xi2, zi2,
                        parallel.make_mesh(1, axis_name="shard"))
    vg2(p2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof2:
        vg2(p2 + 1e-3)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    summary.update(_profile_groups(prof2, wall_ms, f"resident f64 n={RESIDENT_N}"))
    gp.config.set_chol_engine("auto")
    return summary


def _device_ms(torch, fn, reps, flush=None):
    """Device time per call of the kernels fn launches, from torch.profiler:
    the kernels' own time, without the host's launch gaps that CUDA events
    around a loop of short launches also count.  Each kernel record of the
    profiler's event list is read as its own interval on the card
    (key_averages() is not used: its device times hang on the CPU ops a
    kernel is attributed to); copies and fills are not counted, and fn's
    measured calls launch none.  Late in a long process the profiler loses
    the device records of the first launches of many windows (about
    twenty), while it keeps their host-side launch calls (PERF.md §7).  So
    DEVICE_MS_PAD of PyTorch's spin kernels open each window (their records,
    where kept, are not counted), a window counts only when it holds exactly
    one kernel record for every kernel launch of fn, and it is taken again,
    up to DEVICE_MS_ATTEMPTS times; None if no window was whole.  With
    ``flush`` (a device-to-device copy larger than the L2), it runs before
    each call, so fn finds its operands in device memory rather than in L2;
    a window then counts only if it also holds one copy record a call (the
    copies are not counted)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, DEVICE_MS_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(DEVICE_MS_PAD):
                torch.cuda._sleep(1)  # PyTorch's spin_kernel: a record to lose
            for _ in range(reps):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        events = prof.events()
        kernels = [evt for evt in events if evt.device_type == DeviceType.CUDA
                   and not getattr(evt, "is_user_annotation", False)
                   and not evt.name.startswith(("Memcpy", "Memset"))
                   and "spin_kernel" not in evt.name]
        launches = sum(1 for evt in events if evt.device_type == DeviceType.CPU
                       and "LaunchKernel" in evt.name) - DEVICE_MS_PAD
        copies = sum(1 for evt in events if evt.device_type == DeviceType.CUDA
                     and evt.name.startswith("Memcpy"))
        if kernels and len(kernels) == launches and (flush is None or copies == reps):
            if attempt > 1:
                say(f"[device_ms] a whole window at attempt {attempt}")
            return sum(evt.time_range.elapsed_us() for evt in kernels) / 1e3 / reps
    say(f"[device_ms] no whole window in {DEVICE_MS_ATTEMPTS} attempts (last: {len(kernels)} "
        f"kernel records for {launches} kernel launches): not measured")
    return None


def _flushed_device_ms(torch, device, bounds, calls, phase):
    """A row whose warm device time is under its bound read its operands
    from L2, where they stay between launches at n = 1000: its device time
    again with L2 flushed (a copy of L2_FLUSH_BYTES written) before each
    launch, printed and added to ``device`` as "<key> (L2 flushed)"."""
    over = [key for key, v in device.items() if v is not None and v < bounds[key][0]]
    if not over:
        return
    src = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=DEVICE)
    dst = torch.empty_like(src)
    for key in over:
        fn, reps = calls[key]
        cold = _device_ms(torch, fn, reps, flush=lambda: dst.copy_(src))
        device[f"{key} (L2 flushed)"] = cold
        say(f"[phase {phase}] {key}: warm device {_fmt_ms(device[key])} under its bound "
            f"{bounds[key][0]:.4f} ms ({bounds[key][1]}): its operands stay in L2; L2 flushed "
            f"before each launch: device {_fmt_ms(cold)}"
            + ("" if cold is None else f", share {100 * bounds[key][0] / cold:.1f}%"))
    del src, dst


def _fmt_ms(v):
    return "not measured" if v is None else f"{v:.4f} ms"


HOST_ISSUE_CALLS = 300
HOST_ISSUE_SLEEP = 40_000_000  # device clock cycles (~20 ms) spun ahead of the calls


def _host_issue_us(torch, fn, calls=HOST_ISSUE_CALLS):
    """Host time per call of fn (time.perf_counter over ``calls`` calls),
    with the card kept busy by a spin kernel queued first, so that no call
    waits on the device: the time the host takes to issue a call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(HOST_ISSUE_SLEEP)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def _refined_cholesky_walls(torch, refine, A, reps=50):
    """Phase 4e: refined_cholesky(A, with_inverse=True) per call on one panel,
    its captured graph against its launch sequence run as it is: wall per
    call (CUDA events around reps calls: the host's issue where it holds the
    card back) and host issue per call; printed, {key: value}."""
    steps, rtol2 = 2, refine._FACTOR_RTOL2
    graph = lambda: refine.refined_cholesky(A, with_inverse=True)  # noqa: E731
    launches = lambda: refine._refined_cholesky_launches(A, steps, True, rtol2)  # noqa: E731
    out = {}
    for turn in range(2):
        for tag, fn in (("launch sequence", launches), ("graph", graph)):
            out.setdefault(f"{tag} wall ms", []).append(_time_cuda(torch, fn, reps, warmup=2))
    out["launch sequence host us"] = _host_issue_us(torch, launches, 100)
    out["graph host us"] = _host_issue_us(torch, graph, 100)
    say(f"[phase 4e] refined_cholesky b={A.shape[0]} per call (two turns): launch sequence "
        f"{out['launch sequence wall ms']} ms, graph {out['graph wall ms']} ms; host issue: "
        f"launch sequence "
        f"{out['launch sequence host us']:.1f} us, graph {out['graph host us']:.1f} us")
    return out


def _graph_value_grad_ab(gp, gnp, torch, refine):
    """Phase 4e: the resident f64 value+grad at n = GRAPH_AB_N through a
    one-card mesh (phase 3e's workload at p0; 8 panels of 512), its panels
    replaying refined_cholesky's graph as the program does, against the same
    call with parallel.chol's panel factor patched to the graph's launch
    sequence; one call of each in turn, so the host's drift falls on both;
    printed, {tag: walls ms}."""
    from gpmp_tpu_torch import parallel
    from gpmp_tpu_torch.parallel import chol as pchol

    def launches(A, steps=2, with_inverse=False, rtol2=refine._FACTOR_RTOL2):
        return refine._refined_cholesky_launches(A, steps, with_inverse, rtol2)

    gp.config.set_chol_engine("f64")
    xi, zi, p0 = _large_data(GRAPH_AB_N)
    vg, _ = _criterion(gp, _large_model(gp, gnp), xi, zi,
                       parallel.make_mesh(1, axis_name="shard"))
    walls, same = {"graph": [], "launch sequence": []}, True
    for i in range(GRAPH_AB_PAIRS + 1):
        p = p0 + 1e-3 * (i + 1)
        (v, g), w = _timed(torch, lambda: vg(p))
        with _Patched(pchol, refined_cholesky=launches):
            (v2, g2), w2 = _timed(torch, lambda: vg(p))
        same = same and float(v) == float(v2) and np.array_equal(np.asarray(g), np.asarray(g2))
        if i:  # the first pair warms both
            walls["graph"].append(w * 1e3)
            walls["launch sequence"].append(w2 * 1e3)
    gp.config.set_chol_engine("auto")
    say(f"[phase 4e] resident f64 value+grad n={GRAPH_AB_N}, {GRAPH_AB_PAIRS} pairs in turns, "
        f"ms: graph median {np.median(walls['graph']):.2f} {_fmt_list(walls['graph'])}, launch "
        f"sequence median {np.median(walls['launch sequence']):.2f} "
        f"{_fmt_list(walls['launch sequence'])}; value and grad equal: {same}")
    return walls


def _fmt_list(xs):
    return "[" + ", ".join(f"{x:.2f}" for x in xs) + "]"


def _host_path(torch, parts):
    """{layer: host issue us a call} of each callable in parts."""
    return {k: _host_issue_us(torch, fn) for k, fn in parts.items()}


def _k8t_host_path(torch, refine, L, M):
    """Phase 4e: K8t's host issue time per call, through each layer of its
    path (the dispatcher, the wrapper, _build.launch with the wrapper's
    arguments ready, the bare ctypes call, the output's allocation), beside
    torch.matmul's on the same operands; us a call."""
    from gpmp_tpu_torch.ops import _build as build

    lib = build.load()
    dev, b = L.device, L.shape[0]
    plan = refine._tri_plan_on(dev, b)
    C = torch.empty_like(L)
    args = (L.data_ptr(), M.data_ptr(), C.data_ptr(), plan.data_ptr(), plan.shape[0], b,
            0.0, 1.0, 0)
    stream = torch.cuda.current_stream().cuda_stream
    return _host_path(torch, {
        "dispatcher (refine.tri_product)": lambda: refine.tri_product(L, M),
        "wrapper (tri_product_cuda)": lambda: refine.tri_product_cuda(L, M),
        "_build.launch, arguments ready": lambda: build.launch(
            "K8t tri_product", lib.gpmp_tri_product, dev, *args),
        "ctypes call alone": lambda: lib.gpmp_tri_product(*args, stream),
        "torch.empty_like": lambda: torch.empty_like(L),
        "library (torch.matmul)": lambda: torch.matmul(L, M),
    })


def _k3_host_parts(torch, mixed, K, X, B):
    """K3's host path by layer (the dispatcher, the wrapper, the checks, the
    workspace lookup, the outputs' two allocations, the device and stream
    lookup, _build.launch with the arguments ready, the bare ctypes call),
    beside torch.addmm's on the same operands: {layer: callable}."""
    from gpmp_tpu_torch.ops import _build as build

    dev, (rows, n), k = K.device, K.shape, X.shape[1]
    fp = (torch.float64, torch.float32)
    width, part, pairs, tickets, _ = mixed._residual_workspace(dev, rows, n, k)
    fn = build.load().gpmp_residual_f64
    R = torch.empty((rows, k), dtype=torch.float64, device=dev)
    norms = torch.empty(2, dtype=torch.float64, device=dev)
    args = (K.data_ptr(), X.data_ptr(), B.data_ptr(), R.data_ptr(), part, pairs, tickets,
            norms.data_ptr(), rows, n, k, width)
    stream = torch.cuda.current_stream().cuda_stream
    return {
        "dispatcher (mixed.residual)": lambda: mixed.residual(K, X, B),
        "wrapper (residual_cuda)": lambda: mixed.residual_cuda(K, X, B),
        "checks (_check_cuda)": lambda: mixed._check_cuda("K3 residual", (K, X, B),
                                                          (fp, (K.dtype,), (K.dtype,))),
        "workspace lookup": lambda: mixed._residual_workspace(dev, rows, n, k),
        "allocations (torch.empty x 2)": lambda: (
            torch.empty((rows, k), dtype=torch.float64, device=dev),
            torch.empty(2, dtype=torch.float64, device=dev)),
        "device and stream lookup": lambda: torch._C._cuda_getCurrentRawStream(
            torch._C._cuda_getDevice()),
        "_build.launch, arguments ready": lambda: build.launch("K3 residual", fn, dev, *args),
        "ctypes call alone": lambda: fn(*args, stream),
        "library (torch.addmm)": lambda: torch.addmm(B, K, X, alpha=-1),
    }


def _k8r_host_parts(torch, refine, A, L):
    """K8r's host path by layer, as _k3_host_parts, beside torch.addmm(A, L,
    L^T, alpha=-1)'s: {layer: callable}."""
    from gpmp_tpu_torch.ops import _build as build

    dev, b = A.device, A.shape[0]
    fn, plan, ntiles, pairs, ticket, _ = refine._refine_residual_on(dev, b)
    E = torch.empty_like(A)
    sums = torch.empty(2, dtype=torch.float64, device=dev)
    args = (A.data_ptr(), L.data_ptr(), E.data_ptr(), plan, ntiles, b, pairs, sums.data_ptr(),
            ticket)
    stream = torch.cuda.current_stream().cuda_stream
    f64 = (torch.float64,)
    return {
        "dispatcher (refine.refine_residual)": lambda: refine.refine_residual(A, L),
        "wrapper (refine_residual_cuda)": lambda: refine.refine_residual_cuda(A, L),
        "checks (_check_cuda)": lambda: refine._check_cuda("K8r refine_residual", (A, L),
                                                           (f64, f64)),
        "workspace lookup": lambda: refine._refine_residual_on(dev, b),
        "allocations (torch.empty x 2)": lambda: (
            torch.empty_like(A), torch.empty(2, dtype=torch.float64, device=dev)),
        "device and stream lookup": lambda: torch._C._cuda_getCurrentRawStream(
            torch._C._cuda_getDevice()),
        "_build.launch, arguments ready": lambda: build.launch("K8r refine_residual", fn, dev,
                                                               *args),
        "ctypes call alone": lambda: fn(*args, stream),
        "library (torch.addmm)": lambda: torch.addmm(A, L, L.T, alpha=-1),
    }


def _noisy_evals_per_s(gp, gnp, torch, n, reps):
    xi, zi, p0 = _bench_data(n)
    model = _bench_model(gp, gnp)
    crit, _, _, _ = gp.kernel.make_selection_criterion_with_gradient(
        model, gp.kernel.negative_log_restricted_likelihood, xi, zi)
    crit(p0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        if not math.isfinite(crit(p0 + 1e-3 * i)):
            fail(f"noisy REML not finite at n={n} on {gp.config.get_chol_engine()}")
    return reps / (time.perf_counter() - t0)


def phase_mixed_times(gp, gnp, gram, mixed, torch, slice_data):
    n = SLICE_N
    K, _ = _noisy_matern_spd(torch, gram, n, 1e3, 7)
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    X = torch.randn(n, 2, dtype=torch.float64, device=DEVICE, generator=gen)
    B = torch.randn(n, 2, dtype=torch.float64, device=DEVICE, generator=gen)
    L32, M32 = mixed._f32_preconditioner(K)
    L64 = L32.double()
    H = M32 @ (mixed.factorization_residual_plain(K, L32) @ M32.T)
    H2 = H @ H
    R32 = X.float()
    times = {
        "K3": (_time_cuda(torch, lambda: mixed.residual_cuda(K, X, B), 200),
               _time_cuda(torch, lambda: mixed.residual_plain(K, X, B), 50),
               _time_cuda(torch, lambda: torch.addmm(B, K, X, alpha=-1), 200)),
        "K4": (_time_cuda(torch, lambda: mixed.factorization_residual_cuda(K, L32), 50),
               _time_cuda(torch, lambda: mixed.factorization_residual_plain(K, L32), 50),
               _time_cuda(torch, lambda: torch.addmm(K, L64, L64.T, alpha=-1), 50)),
        # K6 at the engine's k = 2 (its refined solves at this n)
        "K6": (_time_cuda(torch, lambda: mixed.precond_apply_cuda(M32, X), 200),
               _time_cuda(torch, lambda: mixed.precond_apply_plain(M32, X), 200),
               _time_cuda(torch, lambda: torch.linalg.multi_dot((M32.T, M32, R32)), 200)),
        "K7": (_time_cuda(torch, lambda: (mixed.trace_sums_cuda(H),
                                          mixed.series_sums_cuda(H, H2)), 200),
               _time_cuda(torch, lambda: (mixed.trace_sums_plain(H),
                                          mixed.series_sums_plain(H, H2)), 50),
               None),
    }
    calls = {"K3": (lambda: mixed.residual_cuda(K, X, B), 50),
             "K4": (lambda: mixed.factorization_residual_cuda(K, L32), 50),
             "K6": (lambda: mixed.precond_apply_cuda(M32, X), 50),
             "K7": (lambda: (mixed.trace_sums_cuda(H), mixed.series_sums_cuda(H, H2)), 50)}
    device = {key: _device_ms(torch, fn, reps) for key, (fn, reps) in calls.items()}
    bounds = _kernel_bounds(n)
    _flushed_device_ms(torch, device, bounds, calls, "4b")
    for key, (t_k, t_p, t_l) in times.items():
        lib = "none" if t_l is None else f"{t_l:.4f} ms"
        b_ms, b_by = bounds[key]
        note = "; K stays in L2 between a solve's sweeps" if key == "K3" else ""
        say(f"[phase 4b] {key} n={n}: kernel {t_k:.4f} ms (device {_fmt_ms(device[key])}), "
            f"plain {t_p:.4f} ms, library {lib}, bound {b_ms:.4f} ms ({b_by}{note}), share "
            f"{100 * b_ms / t_k:.1f}%")
    # K5 at this n (the engine's L32) and at n = 8192 (K4's timing input's)
    times["K5"], device["K5"], _ = _k5_times(torch, mixed, L32, "4b")
    K8 = _time_sqrt_inputs(torch, gram, NOISY_EVAL_SIZES[-1][0])
    L8 = torch.linalg.cholesky_ex(K8.float())[0].contiguous()
    del K8
    k5_big = _k5_times(torch, mixed, L8, "4b")
    del L8
    k7 = {}
    for n7 in K7_SIZES:
        k7.update(_k7_times(torch, gram, mixed, n7, "4b"))
    host = _host_path(torch, _k3_host_parts(torch, mixed, K, X, B))
    say(f"[phase 4b] K3 n={n} k=2 host issue per call ({HOST_ISSUE_CALLS} calls, the card kept "
        "busy): " + ", ".join(f"{k} {v:.2f} us" for k, v in host.items()))
    big = _k3_big_times(torch, mixed)
    for n4 in K4_SIZES:
        _k4_times(torch, gram, mixed, n4, "4b")

    rates = {}
    for n_e, reps in NOISY_EVAL_SIZES:
        for engine in ("mixed", "f64", "f64", "mixed"):
            gp.config.set_chol_engine(engine)
            rates.setdefault((n_e, engine), []).append(
                _noisy_evals_per_s(gp, gnp, torch, n_e, reps))
        say(f"[phase 4b] noisy REML value+grad n={n_e} d=6 f64 data: "
            + ", ".join(f"{e} {rates[(n_e, e)]}" for e in ("mixed", "f64")) + " evals/s")

    # peak memory above what was held before: one REML value+grad, and the
    # engine alone (solve_and_logdet and its backward on a fixed K)
    from gpmp_tpu_torch.core import linalg

    def engine_alone():
        x, ld = linalg.solve_and_logdet(K8, rhs8)
        torch.autograd.grad(ld + x.sum(), K8)

    n8 = NOISY_EVAL_SIZES[-1][0]
    xi, zi, p0 = _bench_data(n8)
    x8 = gnp.asarray(xi)
    K8 = _bench_model(gp, gnp).covariance(x8, x8, gnp.asarray(p0)).requires_grad_(True)
    rhs8 = torch.cat([gnp.asarray(zi)[:, None], gnp.ones((n8, 1))], dim=1)
    mem = {}
    for engine in ("mixed", "f64"):
        gp.config.set_chol_engine(engine)
        model = _bench_model(gp, gnp)
        mem[engine] = _peak_rise(torch, lambda: _reml_vg(gp, model, xi, zi, p0))[1]
        mem[f"{engine} engine alone"] = _peak_rise(torch, engine_alone)[1]
    del K8, rhs8
    say(f"[phase 4b] max_memory_allocated above what was held before, n={n8}: "
        + ", ".join(f"{e} {v / 2**30:.3f} GiB" for e, v in mem.items()))

    gp.config.set_chol_engine("mixed")
    xi, zi, xt, p0, _fit = slice_data
    _, info, _, _, t_warm = _fit_loo_predict(gp, gnp, torch, xi, zi, xt, p0)
    say(f"[phase 4b] fit+LOO+predict n={SLICE_N} nt={SLICE_NT} mixed (warm) {t_warm:.3f} s, "
        f"nfev {info.nfev}")
    gp.config.set_chol_engine("auto")
    return times, rates, mem, t_warm, {"K3 host_issue_us": host, **big,
                                       "K7 ms (events, device warm, device L2 flushed, bound, "
                                       "two-call floor)": k7,
                                       f"K5 n={NOISY_EVAL_SIZES[-1][0]} ms (kernel, plain, "
                                       "library, device, bound)": (*k5_big[0], *k5_big[1:])}


def _tri_inv_chain(mixed, base):
    """The longest chain of dependent f32 steps of K5 on one diagonal block,
    (multiply-adds, divisions), counted from its order (the leaves'
    substitution, then two products s deep at each doubling level s), and
    from one thread a column substituting down the block."""
    size, leaf = mixed.tri_inv_size(base), mixed.TRI_INV_LEAF
    return {"blocked": (leaf * (leaf - 1) // 2 + 2 * (size - leaf), leaf),
            "substitution": (base * (base - 1) // 2, base)}


def _k5_times(torch, mixed, L32, phase, reps=50):
    """K5 at base TRI_INV_BASE on L32: kernel (CUDA events and profiler
    device time), plain, the library call (a batched triangular solve of
    the diagonal blocks against the identity), bound, and the longest chain
    of dependent steps of the kernel's order against the substitution's;
    printed, and returned as ((kernel, plain, library), device, bound)."""
    n, base = L32.shape[0], mixed.TRI_INV_BASE
    blocks = mixed._diag_blocks(L32, base)
    eye_b = torch.eye(base, device=DEVICE).expand(blocks.shape).contiguous()
    t = (_time_cuda(torch, lambda: mixed.diag_block_inv_cuda(L32, base), reps),
         _time_cuda(torch, lambda: mixed.diag_block_inv_plain(L32, base), 5),
         _time_cuda(torch, lambda: torch.linalg.solve_triangular(blocks, eye_b, upper=False),
                    reps))
    dev = _device_ms(torch, lambda: mixed.diag_block_inv_cuda(L32, base), min(reps, 20))
    b_ms, b_by = _kernel_bounds(n)["K5"]
    chain = _tri_inv_chain(mixed, base)
    say(f"[phase {phase}] K5 n={n} base {base} ({blocks.shape[0]} blocks): kernel {t[0]:.4f} ms "
        f"(device {_fmt_ms(dev)}), plain {t[1]:.4f} ms, library (batched trsm) {t[2]:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}), share {100 * b_ms / t[0]:.2f}%; longest chain "
        f"(multiply-adds, divisions): {chain['blocked']} (the substitution's "
        f"{chain['substitution']})")
    del blocks, eye_b
    return t, dev, (b_ms, b_by)


def _k7_inputs(torch, gram, mixed, n):
    """H = M (K - L L^T) M^T and H^2 in f32, as the mixed engine forms them,
    for phase 4b's K (n = SLICE_N: the noisy Matern K at cond 1e3) or
    _time_sqrt_inputs's (larger n)."""
    K = (_noisy_matern_spd(torch, gram, n, 1e3, 7)[0] if n == SLICE_N
         else _time_sqrt_inputs(torch, gram, n))
    L32, M32 = mixed._f32_preconditioner(K)
    H = M32 @ (mixed.factorization_residual_cuda(K, L32) @ M32.T)
    return H, H @ H


def _k7_times(torch, gram, mixed, n, phase):
    """K7 at n per call (trace_sums, then series_sums) and as the pair the
    logdet's series branch makes: CUDA events, device time warm and with L2
    flushed before each call (a copy of L2_FLUSH_BYTES; at n = 1000 H is 4 MB
    and stays in L2 between warm calls), against each call's bound and, for
    the pair, the one-read bound (H and H^2 read once) and the two-call floor
    (H read by both calls); printed, and returned as {key: (events, device
    warm, device flushed, bound, floor)} in ms."""
    H, H2 = _k7_inputs(torch, gram, mixed, n)
    bounds = _kernel_bounds(n)
    src = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=DEVICE)
    dst = torch.empty_like(src)
    calls = {"trace_sums": (lambda: mixed.trace_sums_cuda(H), "K7 trace_sums", None),
             "series_sums": (lambda: mixed.series_sums_cuda(H, H2), "K7 series_sums", None),
             "pair": (lambda: (mixed.trace_sums_cuda(H), mixed.series_sums_cuda(H, H2)), "K7",
                      "K7 two-call")}
    reps = 200 if n <= SLICE_N else 50
    out = {}
    for tag, (fn, bkey, fkey) in calls.items():
        ev = _time_cuda(torch, fn, reps)
        warm = _device_ms(torch, fn, min(reps, 50))
        cold = _device_ms(torch, fn, 20, flush=lambda: dst.copy_(src))
        b_ms = bounds[bkey][0]
        f_ms = bounds[fkey][0] if fkey else None
        out[f"K7 {tag} n={n}"] = (ev, warm, cold, b_ms, f_ms)
        shares = [] if not cold else [f"{100 * b_ms / cold:.1f}% of the bound"] + (
            [f"{100 * f_ms / cold:.1f}% of the floor"] if f_ms else [])
        say(f"[phase {phase}] K7 {tag} n={n}: kernel {ev:.4f} ms (device {_fmt_ms(warm)} warm, "
            f"{_fmt_ms(cold)} L2 flushed), bound {b_ms:.4f} ms (bytes"
            + (f", one read of H and H^2), two-call floor {f_ms:.4f} ms (H read twice)"
               if f_ms else ")") + f"; L2 flushed: {', '.join(shares) or 'not measured'}")
    if n <= SLICE_N:
        # the yardstick of a launch: a one-element PyTorch kernel's device time
        one = torch.zeros(1, device=DEVICE)
        out["one-element kernel"] = _device_ms(torch, lambda: one.add_(1), 50)
        say(f"[phase {phase}] a one-element PyTorch kernel (add_): device "
            f"{_fmt_ms(out['one-element kernel'])}, the floor of any launch")
    del src, dst, H, H2
    return out


def _k3_big_times(torch, mixed, n=K3_BIG_N):
    """K3 at phase 3e's n, k = 2, on a random K (one column chunk): events,
    device time, torch.addmm on the same operands, bound and share; printed
    and returned as {key: value}."""
    gen = torch.Generator(device=DEVICE).manual_seed(n)
    K = torch.randn(n, n, dtype=torch.float64, device=DEVICE, generator=gen)
    X = torch.randn(n, 2, dtype=torch.float64, device=DEVICE, generator=gen)
    B = torch.randn(n, 2, dtype=torch.float64, device=DEVICE, generator=gen)
    t_k = _time_cuda(torch, lambda: mixed.residual_cuda(K, X, B), 20)
    t_l = _time_cuda(torch, lambda: torch.addmm(B, K, X, alpha=-1), 20)
    dev = _device_ms(torch, lambda: mixed.residual_cuda(K, X, B), 10)
    b_ms, b_by = _kernel_bounds(n)["K3"]
    say(f"[phase 4b] K3 n={n} k=2: kernel {t_k:.4f} ms (device {_fmt_ms(dev)}), library "
        f"(f64 addmm) {t_l:.4f} ms, bound {b_ms:.4f} ms ({b_by}), share {100 * b_ms / t_k:.1f}%")
    return {f"K3 n={n} ms (kernel, library, device, bound)": (t_k, t_l, dev, b_ms)}


def _k4_times(torch, gram, mixed, n, phase, digests=None):
    """K4 at n: kernel (CUDA events and profiler device time), plain, an f64
    addmm of the same product, bound; printed, and returned as ((kernel,
    plain, library), device, bound).  With a dict ``digests``, also K4's
    output, hashed into it."""
    K = _time_sqrt_inputs(torch, gram, n)
    L32 = torch.linalg.cholesky_ex(K.float())[0].contiguous()
    L64 = L32.double()
    reps = 50 if n < 8192 else 5
    t = (_time_cuda(torch, lambda: mixed.factorization_residual_cuda(K, L32), reps),
         _time_cuda(torch, lambda: mixed.factorization_residual_plain(K, L32), max(reps // 5, 2)),
         _time_cuda(torch, lambda: torch.addmm(K, L64, L64.T, alpha=-1), reps))
    dev = _device_ms(torch, lambda: mixed.factorization_residual_cuda(K, L32), min(reps, 10))
    bound = _kernel_bounds(n)["K4"]
    if digests is not None:
        digests[f"K4 n={n}"] = _digest(mixed.factorization_residual_cuda(K, L32))
    say(f"[phase {phase}] K4 n={n}: kernel {t[0]:.4f} ms "
        f"(device {_fmt_ms(dev)}), plain {t[1]:.4f} ms, library (f64 addmm) {t[2]:.4f} ms, "
        f"bound {bound[0]:.4f} ms ({bound[1]}), share {100 * bound[0] / t[0]:.1f}%")
    del K, L32, L64
    return t, dev, bound


def _time_sqrt_inputs(torch, gram, n):
    """A noisy Matern K at n (no eigendecomposition: the kernels' times do
    not depend on cond(K))."""
    x = torch.as_tensor(np.random.default_rng(n).uniform(size=(n, 6)), device=DEVICE)
    theta = torch.tensor([0.0] + [math.log(1 / 1.5)] * 6, dtype=torch.float64, device=DEVICE)
    K = gram.matern_gram_cuda(x, x, 2, theta, True)
    K.diagonal().add_(1e-2)
    return K


# phase 4c and --compare: K1d and its pullback at the noisy slice's shape and
# at bench_large_n's (d = 3) resident n = 16384
K1D_TIME_SIZES = ((SLICE_N, SLICE_D), (16384, 3))
# the SASS opcodes that issue to the f64 pipes (at PEAK_F64_FLOPS / 2 a second)
FP64_OPCODES = ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX", "DSET")


GRAM_TIME_CASES = ((SLICE_N, SLICE_N, True), (8192, 8192, True), (SLICE_N, SLICE_N, False))


def _gram_inputs(torch, n, m, same, d=SLICE_D, seed=11):
    """(x, y, theta, Kbar) at (n, m, d): x, y and theta from numpy, Kbar (n,
    m; not symmetric) from the card's generator."""
    rng = np.random.default_rng(seed + n + m)
    x = torch.as_tensor(rng.uniform(size=(n, d)), device=DEVICE)
    y = x if same else torch.as_tensor(rng.uniform(size=(m, d)), device=DEVICE)
    theta = torch.as_tensor(np.concatenate([[0.3], rng.uniform(-0.5, 1.5, size=d)]),
                            device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + n)
    return x, y, theta, torch.randn(n, m, dtype=torch.float64, device=DEVICE, generator=gen)


def _gram_f64_floor(build, gram, key, n, m, same, d=SLICE_D):
    """K1's or K2's f64 instruction floor at (n, m, d), p = 2: the f64
    instructions an entry in the item loop of its built f64 instance
    (cuobjdump -sass; its unmasked and masked paths' entries each take one
    MUFU.RSQ64H: K1's sqrt, K2's rsqrt), times the entries computed (x is
    y: n (n + 1) / 2 pairs), over the f64 pipes' issue rate, as
    _pullback_f64_floor; or None."""
    inst = d if d <= gram.EXACT_MAX_D else gram.MAX_D
    name = "11gram_kernel" if key == "K1" else "15pullback_kernel"
    entries = n * (n + 1) // 2 if same else n * m
    return _sass_f64_floor(build, rf"{name}IdLi{inst}ELb1E", entries)


def _gram_times(torch, gram, phase, out=None, plain=True, build=None):
    """K1 and K2 at GRAM_TIME_CASES (d = 6, p = 2, f64): CUDA events,
    profiler device time warm and with L2 flushed before each call, the host
    issue per call (_host_issue_us), the byte bound, with ``plain`` the plain
    versions (the kernels held to them), with ``build`` the f64 instruction
    floor.  Into ``out`` (--compare's dict, with digests of K and of two
    pullbacks) or returned as {tag: {...}}."""
    res = {}
    src = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=DEVICE)
    dst = torch.empty_like(src)
    for n, m, same in GRAM_TIME_CASES:
        x, y, theta, kbar = _gram_inputs(torch, n, m, same)
        small = n <= SLICE_N
        bounds = _kernel_bounds(n)
        for key, fn, plain_fn, tol in (
                ("K1", lambda: gram.matern_gram_cuda(x, y, 2, theta, same),
                 lambda: gram.matern_gram_plain(x, y, 2, theta, same), TOL_K1["float64"]),
                ("K2", lambda: gram.matern_gram_pullback_cuda(kbar, x, y, 2, theta, same),
                 lambda: gram.matern_gram_pullback_plain(kbar, x, y, 2, theta, same),
                 TOL_K2["float64"])):
            tag = f"{key} n={n} m={m} {'same' if same else 'cross'}"
            r = {"ms": _time_cuda(torch, fn, 200 if small else 20),
                 "device": _device_ms(torch, fn, 20 if small else 5),
                 "flushed": _device_ms(torch, fn, 20 if small else 5,
                                       flush=lambda: dst.copy_(src)),
                 "host_us": _host_issue_us(torch, fn, HOST_ISSUE_CALLS if small else 50),
                 "bound": bounds[key]}
            if plain:
                r["plain_ms"] = _time_cuda(torch, plain_fn, 20 if small else 2, warmup=1)
                r["err"] = rel_err(fn(), plain_fn())
                check(math.isfinite(r["err"]) and r["err"] <= tol,
                      f"{tag}: {r['err']:.3e} from plain > {tol}")
            if build is not None:
                r["floor"] = _gram_f64_floor(build, gram, key, n, m, same)
            dev = r["device"]
            line = (f"[{phase}] {tag} d={SLICE_D} p=2: events {r['ms']:.4f} ms, device "
                    f"{_fmt_ms(dev)} warm / {_fmt_ms(r['flushed'])} L2 flushed, host issue "
                    f"{r['host_us']:.2f} us a call, bound {r['bound'][0]:.4f} ms "
                    f"({r['bound'][1]})"
                    + ("" if dev is None else f", {100 * r['bound'][0] / dev:.1f}% of it"))
            if plain:
                line += f"; plain {r['plain_ms']:.4f} ms (kernel within {r['err']:.2e} of it)"
            if r.get("floor"):
                f_ms, per, entries, counts = r["floor"]
                line += (f"; f64 instruction floor {f_ms:.4f} ms ({per:.2f} f64 instructions "
                         f"an entry in the d={SLICE_D} instance's loop of {entries} entries: "
                         + ", ".join(f"{k} {v}" for k, v in sorted(counts.items())) + ")")
            elif build is not None:
                line += "; f64 instruction floor not measured (SASS not read)"
            say(line)
            if out is not None:
                out["ms (kernel, plain, library)"][tag] = (r["ms"], None, None)
                out["device_ms"][tag] = dev
                out["device_ms"][f"{tag} (L2 flushed)"] = r["flushed"]
                out["host_issue_us"][tag] = r["host_us"]
                for turn in range(2 if key == "K2" else 1):
                    out["digest"][f"{tag}{' (again)' if turn else ''}"] = _digest(fn())
            res[tag] = r
        del x, y, theta, kbar
    del src, dst
    return res


def _k1d_inputs(torch, n, d, seed=7):
    """(loginvrho, x, Dbar) at (n, d): l and x from numpy, Dbar (n, n) from
    the card's generator."""
    rng = np.random.default_rng(seed + n + d)
    l = torch.as_tensor(rng.uniform(-0.5, 1.5, size=d), device=DEVICE)
    x = torch.as_tensor(rng.uniform(size=(n, d)), device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + n)
    return l, x, torch.randn(n, n, dtype=torch.float64, device=DEVICE, generator=gen)


def _sass_loop_counts(sass, name):
    """Opcode counts of the innermost loop of the function whose mangled name
    matches ``name`` (a regex), among its innermost loops the one with the
    most f64 instructions, from ``cuobjdump -sass`` text: {opcode: count}
    or None.  A loop is a backward branch and the instructions from its
    target to it; every loop's size is printed."""
    import re

    funcs, cur = {}, None
    for line in sass.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            cur = funcs.setdefault(head.group(1), [])
            continue
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if cur is not None and ins:
            cur.append((int(ins.group(1), 16), ins.group(2)))
        label = re.match(r"\s*(\.L_x_\d+):", line)
        if cur is not None and label:
            cur.append((None, label.group(1)))
    hits = [k for k in funcs if re.search(name, k)]
    if len(hits) != 1:
        return None
    body, labels, nxt = [], {}, None
    for addr, text in reversed(funcs[hits[0]]):  # a label's address is the next instruction's
        if addr is None:
            labels[text] = nxt
        else:
            body.append((addr, text))
            nxt = addr
    body.reverse()

    def opcode(text):
        return re.sub(r"^@!?U?P[T0-9]+\s+", "", text).split()[0].split(".")[0]

    loops = []
    for addr, text in body:
        if opcode(text) != "BRA":
            continue
        tgt = re.search(r"(0x[0-9a-f]+)|(\.L_x_\d+)", text.split(None, 1)[-1])
        if tgt is None:
            continue
        t = int(tgt.group(1), 16) if tgt.group(1) else labels.get(tgt.group(2))
        if t is not None and t <= addr:
            loops.append((t, addr))
    best, seen = None, []
    for a, b in loops:
        ops = [opcode(text) for addr, text in body if a <= addr <= b]
        counts = {o: ops.count(o) for o in set(ops)}
        f64 = sum(counts.get(o, 0) for o in FP64_OPCODES)
        seen.append(f"{a:#06x}-{b:#06x}: {len(ops)}/{f64}")
        inner = not any((c, e) != (a, b) and a <= c and e <= b for c, e in loops)
        if inner and (best is None or f64 > best[0]):
            best = (f64, counts)
    say(f"[phase 4c] {hits[0]}: loops (instructions/f64) " + ", ".join(seen))
    return None if best is None else best[1]


@functools.lru_cache(maxsize=2)
def _sass_dump(path):
    """cuobjdump -sass of the built library, or None."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        return subprocess.run([tool, "-sass", path], capture_output=True, text=True,
                              timeout=300).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        say(f"[phase 4c] cuobjdump -sass failed: {exc}")
        return None


def _sass_f64_floor(build, pattern, entries):
    """An f64 instruction floor: the f64 instructions an entry in the
    innermost loop of the built function matching ``pattern`` (cuobjdump
    -sass; one MUFU an entry, so the loop's MUFU count is its entries),
    times ``entries``, over the f64 pipes' issue rate PEAK_F64_FLOPS / 2:
    (floor_ms, per entry, entries a loop iteration, the loop's opcode
    counts), or None where the SASS cannot be read."""
    sass = _sass_dump(str(build.build_dir() / "libgpmp_tpu_torch.so"))
    counts = sass and _sass_loop_counts(sass, pattern)
    if not counts or not counts.get("MUFU"):
        return None
    per_loop = counts["MUFU"]
    per_entry = sum(counts.get(o, 0) for o in FP64_OPCODES) / per_loop
    return per_entry * entries / (PEAK_F64_FLOPS / 2) * 1e3, per_entry, per_loop, counts


def _pullback_f64_floor(build, distance, n, d):
    """The K1d pullback's f64 instruction floor at (n, n, d): _sass_f64_floor
    of its built f64 16-byte instance for d (one MUFU.RSQ64H an entry) over
    the n^2 entries."""
    inst = d if d <= distance.EXACT_MAX_D else distance.MAX_D
    return _sass_f64_floor(build, rf"distance_pullback_kernelIdLi{inst}ELb1E", n * n)


def _k1d_times(torch, distance, phase, out=None, plain=True, build=None):
    """K1d and its pullback at K1D_TIME_SIZES, on (l, x, x) as a gram's call:
    CUDA events, profiler device time warm and with L2 flushed before each
    call, the host issue per call (_host_issue_us), and with ``plain`` the
    plain versions and torch.cdist of the scaled points; with ``build`` the
    pullback's f64 instruction floor beside its byte bound.  Into ``out``
    (--compare's dict, with digests of D and of two pullbacks) or returned
    as {key: {...}}."""
    res = {}
    src = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=DEVICE)
    dst = torch.empty_like(src)
    for n, d in K1D_TIME_SIZES:
        l, x, dbar = _k1d_inputs(torch, n, d)
        small = n <= SLICE_N
        bounds = _kernel_bounds(n, d=d)
        xs = torch.exp(l) * x
        for key, fn, plain_fn, lib_fn in (
                ("K1d", lambda: distance.scaled_distance_cuda(l, x, x),
                 lambda: distance.scaled_distance_plain(l, x, x), lambda: torch.cdist(xs, xs)),
                ("K1d pullback", lambda: distance.scaled_distance_pullback_cuda(dbar, l, x, x),
                 lambda: distance.scaled_distance_pullback_plain(dbar, l, x, x), None)):
            tag = f"{key} n={n} d={d}"
            r = {"ms": _time_cuda(torch, fn, 200 if small else 20),
                 "device": _device_ms(torch, fn, 20 if small else 5),
                 "flushed": _device_ms(torch, fn, 20 if small else 5,
                                       flush=lambda: dst.copy_(src)),
                 "host_us": _host_issue_us(torch, fn, HOST_ISSUE_CALLS if small else 50),
                 "bound": bounds[key]}
            if plain:
                r["plain_ms"] = _time_cuda(torch, plain_fn, 20 if small else 2, warmup=1)
                r["library_ms"] = None if lib_fn is None else _time_cuda(
                    torch, lib_fn, 200 if small else 20)
                r["err"] = rel_err(fn(), plain_fn())
                tol = TOL_2C[(key, "float64")]
                check(math.isfinite(r["err"]) and r["err"] <= tol,
                      f"{tag}: {r['err']:.3e} from plain > {tol}")
            if build is not None and key == "K1d pullback":
                r["floor"] = _pullback_f64_floor(build, distance, n, d)
            dev = r["device"]
            line = (f"[{phase}] {tag}: events {r['ms']:.4f} ms, device {_fmt_ms(dev)} warm / "
                    f"{_fmt_ms(r['flushed'])} L2 flushed, host issue {r['host_us']:.2f} us a "
                    f"call, bound {r['bound'][0]:.4f} ms ({r['bound'][1]})"
                    + ("" if dev is None else f", {100 * r['bound'][0] / dev:.1f}% of it"))
            if plain:
                line += (f"; plain {r['plain_ms']:.4f} ms (kernel within {r['err']:.2e} of it)"
                         + ("" if lib_fn is None else f", cdist {r['library_ms']:.4f} ms"))
            if r.get("floor"):
                f_ms, per, entries, counts = r["floor"]
                line += (f"; f64 instruction floor {f_ms:.4f} ms ({per:.2f} f64 instructions "
                         f"an entry in the d={d} instance's loop of {entries} entries: "
                         + ", ".join(f"{k} {v}" for k, v in sorted(counts.items())) + ")")
            elif build is not None and key == "K1d pullback":
                line += "; f64 instruction floor not measured (SASS not read)"
            say(line)
            if out is not None:
                out["ms (kernel, plain, library)"][tag] = (r["ms"], None, None)
                out["device_ms"][tag] = dev
                out["device_ms"][f"{tag} (L2 flushed)"] = r["flushed"]
                out["host_issue_us"][tag] = r["host_us"]
                for turn in range(2 if key == "K1d pullback" else 1):
                    out["digest"][f"{tag}{' (again)' if turn else ''}"] = _digest(fn())
            res[tag] = r
        del l, x, dbar, xs
    del src, dst
    return res


def phase_new_times(gp, gnp, gram, distance, mixed, refine, torch, xt_paths, slice_data,
                    t_paths_first):
    """Phase 4c: (kernel, plain, library) ms of K1d, K1m, K7b, K8s and K6's
    wide variant at the slice's shapes; the device time of the rows whose
    operands stay in L2 between warm launches (their warm device time under
    their bound) again with L2 flushed before each launch; K1d and its
    pullback also at n = 16384 (d = 3), each warm and flushed, with its host
    issue per call and the pullback's f64 instruction floor (_k1d_times);
    the full-width sample-paths call."""
    n = SLICE_N
    l, x, _y, dbar = _dist_inputs(torch, n, SLICE_D, torch.float64, 7)
    db = (dbar + dbar.T) / 2
    D = distance.scaled_distance_cuda(l, x, x)
    K = _time_sqrt_inputs(torch, gram, n)
    L32, M32 = mixed._f32_preconditioner(K)
    L64 = L32.double()
    (Ms, Bs), (G, W), _series = _k7b_inputs(torch, mixed, K, M32)
    # K6's wide variant at predict's width (SLICE_NT right-hand sides)
    k6w = f"K6 wide k={SLICE_NT}"
    Rw = torch.randn(n, SLICE_NT, dtype=torch.float64, device=DEVICE,
                     generator=torch.Generator(device=DEVICE).manual_seed(5))
    Rw32 = Rw.float()
    K8 = _time_sqrt_inputs(torch, gram, PATHS_NT)
    L8, _M8 = mixed._f32_preconditioner(K8)
    L8_64 = L8.double()
    t = lambda fn, reps: _time_cuda(torch, fn, reps)  # noqa: E731
    theta = torch.cat([torch.zeros(1, dtype=torch.float64, device=DEVICE), l])
    calls = {
        "K1": (lambda: gram.matern_gram_cuda(x, x, 2, theta, True), 50),
        "K1m": (lambda: gram.maternp_kernel_cuda(2, D), 50),
        "K1m backward": (lambda: gram.maternp_kernel_backward_cuda(2, D, db), 50),
        "K7b": (lambda: mixed.loo_diag_series_cuda(Ms, Bs, torch.float64), 50),
        "K7b two-level": (lambda: mixed.loo_diag_pairs_cuda(G, W), 50),
        "K8s": (lambda: refine.sampling_residual_cuda(K, L32), 50),
        "K8s n=8192": (lambda: refine.sampling_residual_cuda(K8, L8), 5),
        k6w: (lambda: mixed.precond_apply_cuda(M32, Rw), 20),
    }
    device = {key: _device_ms(torch, fn, reps) for key, (fn, reps) in calls.items()}
    say("[phase 4c] device time per call (torch.profiler, all kernels the call launches), "
        "ms: " + ", ".join(f"{k} {_fmt_ms(v)}" for k, v in device.items()))
    times = {
        "K1m": (t(lambda: gram.maternp_kernel_cuda(2, D), 200),
                t(lambda: gram.maternp_kernel_plain(2, D), 50), None),
        "K1m backward": (t(lambda: gram.maternp_kernel_backward_cuda(2, D, db), 200),
                         t(lambda: gram.maternp_kernel_backward_plain(2, D, db), 50), None),
        "K7b": (t(lambda: mixed.loo_diag_series_cuda(Ms, Bs, torch.float64), 200),
                t(lambda: mixed.loo_diag_series_plain(Ms, Bs, torch.float64), 50), None),
        "K7b two-level": (t(lambda: mixed.loo_diag_pairs_cuda(G, W), 200),
                          t(lambda: mixed.loo_diag_pairs_plain(G, W), 50), None),
        "K8s": (t(lambda: refine.sampling_residual_cuda(K, L32), 50),
                t(lambda: refine.sampling_residual_plain(K, L32), 50),
                t(lambda: torch.addmm(K, L64, L64.T, alpha=-1), 50)),
        "K8s n=8192": (t(lambda: refine.sampling_residual_cuda(K8, L8), 5),
                       t(lambda: refine.sampling_residual_plain(K8, L8), 5),
                       t(lambda: torch.addmm(K8, L8_64, L8_64.T, alpha=-1), 5)),
        k6w: (t(lambda: mixed.precond_apply_cuda(M32, Rw), 50),
              t(lambda: mixed.precond_apply_plain(M32, Rw), 50),
              t(lambda: torch.linalg.multi_dot((M32.T, M32, Rw32)), 50)),
    }
    bounds = _kernel_bounds(n)
    bounds[k6w] = _kernel_bounds(n, k=SLICE_NT)["K6"]
    bounds["K7b two-level"] = (max(16 * n * n / PEAK_BYTES_PER_S,
                                   2 * n * n / PEAK_F64_FLOPS) * 1e3, "bytes")
    bounds["K8s n=8192"] = _kernel_bounds(PATHS_NT)["K8s"]
    _flushed_device_ms(torch, device, bounds, calls, "4c")
    del K8, L8, L8_64
    # K1d and its pullback at n = 1000 (the rows below and the kernels' line)
    # and 16384, with L2 flushed, their host issue and the pullback's floor
    from gpmp_tpu_torch.ops import _build as build

    for tag, r in _k1d_times(torch, distance, "phase 4c", build=build).items():
        key = tag.split(" n=")[0]
        if tag.endswith(f"n={n} d={SLICE_D}"):
            times[key] = (r["ms"], r["plain_ms"], r["library_ms"])
            device[key], device[f"{key} (L2 flushed)"] = r["device"], r["flushed"]
        else:
            device[tag], device[f"{tag} (L2 flushed)"] = r["device"], r["flushed"]
    for key, (t_k, t_p, t_l) in times.items():
        b_ms, b_by = bounds[key]
        kern = "none" if t_k is None else f"{t_k:.4f} ms (device {_fmt_ms(device[key])})"
        lib = "none" if t_l is None else f"{t_l:.4f} ms"
        share = "" if t_k is None else f", share {100 * b_ms / t_k:.1f}%"
        say(f"[phase 4c] {key} (n={n if 'n=' not in key else PATHS_NT}): kernel {kern}, "
            f"plain {t_p:.4f} ms, library {lib}, bound {b_ms * 1e3:.2f} us ({b_by}){share}")

    xi, zi, _xt, p0, _fit = slice_data
    t_warm = {}
    for engine in ("mixed", "f64"):
        gp.config.set_chol_engine(engine)
        model = _bench_model(gp, gnp, covparam=gnp.asarray(p0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.sample_paths(xt_paths, PATHS_COUNT)
        torch.cuda.synchronize()
        t_warm[engine] = time.perf_counter() - t0
        say(f"[phase 4c] sample_paths nt={PATHS_NT} x {PATHS_COUNT} paths at p0 on {engine}: "
            f"first {t_paths_first[engine]:.3f} s, warm {t_warm[engine]:.3f} s")
    gp.config.set_chol_engine("auto")
    return times, bounds, t_warm, device


_GROUPS = (  # the first group whose key is in a kernel's name takes it
    ("K10r streamed factorization residual", ("syrk::pairresidual", "syrk::panelresidual")),
    ("K10m streamed residual", ("ff_residual_kernel",)),
    ("K10b row split", ("split_rows",)),
    ("K10t chunked traces", ("h_traces",)),
    ("K6 preconditioner apply", ("precond_",)),
    ("K1m Matern elementwise", ("maternp_elem",)),
    ("K1d scaled distance", ("distance",)),
    ("K1/K2 gram", ("matern",)),
    ("K7b LOO diagonal", ("loo_diag",)),
    ("K9u trailing update", ("syrk::trailing",)),
    ("K9s slab update (f64)", ("syrk::slab,",)),
    ("K9s slab update (f32)", ("slab_update_f32_kernel",)),
    ("K4s slab factorization residual", ("syrk::residualslab",)),
    ("K8s sampling residual", ("syrk::samplingresidual",)),
    ("K4 factorization residual", ("syrk::residual<",)),
    ("K8r refinement residual", ("refine_residual_kernel",)),
    ("K8t triangular product", ("tri_product",)),
    ("K9m Murray passes", ("murray_kernel",)),
    ("K3 residual", ("residual_kernel",)),
    ("K5 diag-block inverse", ("diag_block_inv",)),
    ("K7 trace sums", ("trace_sums", "series_sums")),
    ("K10m partial reduction", ("reduce_pairs",)),
    ("Cholesky (cuSOLVER potrf: getrf_wo_pivot)", ("potrf", "getrf", "cholesky")),
    ("triangular solves (trsm)", ("trsm", "trsv")),
    ("matrix products (gemm)", ("gemm", "gemv", "xmma", "cutlass", "dot_kernel",
                                "splitkreduce")),
)


PROFILE_SIZES = ((1000, 10), (8192, 3))  # (n, profiled evaluations)


def phase_profile(gp, gnp, torch):
    from torch.profiler import ProfilerActivity, profile

    summary = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device=DEVICE).sum().item()  # the profiler's own start-up
    for n, reps in PROFILE_SIZES:
        summary.update(_profile_engines(gp, gnp, torch, n, reps, profile, ProfilerActivity))
    gp.config.set_chol_engine("auto")
    return summary


def _profile_engines(gp, gnp, torch, n, reps, profile, ProfilerActivity):
    xi, zi, p0 = _bench_data(n)
    summary = {}
    for engine in ("mixed", "f64"):
        gp.config.set_chol_engine(engine)
        model = _bench_model(gp, gnp)
        crit = gp.kernel.make_selection_criterion_with_gradient(
            model, gp.kernel.negative_log_restricted_likelihood, xi, zi)[0]
        for i in range(3):
            crit(p0 + 1e-3 * i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                crit(p0 + 1e-3 * i)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        summary.update(_profile_groups(prof, wall_ms, f"{engine} n={n}", reps))
    return summary


def _profile_groups(prof, wall_ms, label, reps=1):
    """Prints the profiled device time per evaluation by kernel group (and the
    six largest kernels); {label: {"wall_ms", "device_ms", groups...}}."""
    per_kernel = {}
    for evt in prof.key_averages():
        if "cuda" not in str(getattr(evt, "device_type", "")).lower():
            continue
        t_us = getattr(evt, "self_device_time_total", None)
        if t_us is None:
            t_us = getattr(evt, "self_cuda_time_total", 0.0)
        per_kernel[evt.key] = per_kernel.get(evt.key, 0.0) + t_us / 1e3 / reps
    device_ms = sum(per_kernel.values())
    groups = {}
    for name, ms in per_kernel.items():
        low = name.lower()
        group = next((g for g, keys in _GROUPS if any(k in low for k in keys)),
                     "elementwise, copies, other")
        groups[group] = groups.get(group, 0.0) + ms
    say(f"[phase 5] {label}: wall per eval (profiled) {wall_ms:.3f} ms, "
        f"device {device_ms:.3f} ms, busy {100 * device_ms / wall_ms:.1f}%")
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        say(f"[phase 5]   {group}: {ms:.4f} ms ({100 * ms / max(device_ms, 1e-300):.1f}%)")
    for name, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]:
        say(f"[phase 5]     {ms:.4f} ms  {name[:90]}")
    if device_ms <= 0:
        say(f"[phase 5] the profiler saw no device time on {label}: not measured")
    return {label: {"wall_ms": wall_ms, "device_ms": device_ms, "groups": groups}}


# ----------------------------------------------------------------------------
# the group mesh (one process per rank over torch.distributed): phases 2f,
# 3f (the repairs), 3g, 3h and 4f
# ----------------------------------------------------------------------------
def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _k9s_case(torch, ochol, A, bounds, c0, b):
    """K9s on each slab [lo, hi) of A's rows at the panel [c0, c0 + b),
    against its plain version on the same inputs: (worst error in units of
    2 b eps64 (|S| + |T||Mt|^T), max |d|, whether each wrote only its lower
    trapezoid, the one-rank slab's output or None)."""
    n = A.shape[0]
    w0 = c0 + b
    Mt = torch.zeros((n, b), dtype=A.dtype, device=A.device)
    Mt[w0:] = A[w0:, c0:w0]
    worst, dmax, only, whole = 0.0, 0.0, True, None
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if max(lo, w0) >= hi:
            continue
        W1, W2 = A[lo:hi].clone(), A[lo:hi].clone()
        ochol.slab_update_cuda(W1, lo, c0, b, Mt)
        ochol.slab_update_plain(W2, lo, c0, b, Mt)
        r0 = max(lo, w0) - lo
        only = only and torch.equal(W1[:r0], A[lo:lo + r0]) and torch.equal(
            W1[:, :w0], A[lo:hi, :w0])
        for q0 in range(r0, hi - lo, 1024):
            q1 = min(hi - lo, q0 + 1024)
            upper = torch.triu(torch.ones(q1 - q0, n - w0, dtype=torch.bool, device=A.device),
                               lo + q0 - w0 + 1)
            only = only and torch.equal(W1[q0:q1, w0:][upper], A[lo + q0:lo + q1, w0:][upper])
            d = W1[q0:q1, w0:] - W2[q0:q1, w0:]
            Tq = A[lo + q0:lo + q1, c0:w0]
            scale = (W2[q0:q1, w0:] + Tq @ Mt[w0:].T).abs() + Tq.abs() @ Mt[w0:].abs().T
            # in units of 2 b eps of A's dtype
            worst = max(worst, _dot_units(torch, d.double(), scale.double(), b)
                        * float(np.finfo(np.float64).eps) / float(torch.finfo(A.dtype).eps))
            dmax = max(dmax, float(d.abs().max()))
            del d, scale, upper
        if len(bounds) == 2:
            whole = W1
        del W2
    return worst, dmax, only, whole


def phase_group_kernels_vs_plain(gp, gnp, torch, gram, mixed, ochol):
    """Phase 2f: K9s (and K9m's slab form) against their plain versions on
    the card, and K9s against K9u at one rank, with the tolerances at TOL_2F."""
    absd = {}
    b = CHOL_BLOCK
    cases = []
    A = _large_gram(gp, gnp, K9S_N)
    gc.collect()
    torch.cuda.empty_cache()
    n = K9S_N
    panels = sorted({0, ((n - 1) // b // 2) * b, ((n - 1) // b - 1) * b})
    for R in (1, 2):
        cases.append((A, tuple(range(0, n + 1, n // R)), panels, f"n={n} R={R}"))
    # f32 (the direct factor of the mixed engine's f32 preconditioner)
    A32 = A.float()
    for R in (1, 2):
        cases.append((A32, tuple(range(0, n + 1, n // R)), panels, f"n={n} R={R} float32"))
    ns, bounds_s, c_s = K9S_STRADDLE
    As = _noisy_matern_spd(torch, gram, ns, MIXED_CONDS[0], 500 + ns)[0]
    panels_s = sorted({0, c_s, ((ns - 1) // b - 1) * b})
    cases.append((As, bounds_s, panels_s, f"n={ns} slabs {bounds_s}"))
    cases.append((As.float(), bounds_s, panels_s, f"n={ns} slabs {bounds_s} float32"))
    worst = 0.0
    for Ac, bounds, cs, tag in cases:
        for c0 in cs:
            err, dmax, only, whole = _k9s_case(torch, ochol, Ac, bounds, c0, b)
            msg = (f"[phase 2f] K9s {tag} panel [{c0}, {c0 + b}): max|dS| in units of 2 b eps "
                   f"(|S| + |T||Mt|^T) {err:.2e} (tol {TOL_2F['K9s']}), max|dS| {dmax:.2e}, "
                   f"only the lower trapezoid written {only}")
            check(math.isfinite(err) and err <= TOL_2F["K9s"], f"K9s {tag} c0={c0}: {err:.3e}")
            check(only, f"K9s wrote outside its lower trapezoid ({tag}, c0={c0})")
            worst = max(worst, err)
            if Ac.dtype == torch.float32:
                absd["K9s f32"] = max(absd.get("K9s f32", 0.0), dmax)
            if whole is not None and Ac.dtype == torch.float64:
                A1 = Ac.clone()
                ochol.trailing_update_cuda(A1, c0, b)
                w0 = c0 + b
                same = torch.equal(torch.tril(whole[w0:, w0:]), torch.tril(A1[w0:, w0:]))
                msg += f", bitwise K9u's lower triangle {same}"
                check(same, f"K9s at one rank is not K9u's lower triangle ({tag}, c0={c0})")
                del A1
                if Ac is A and c0 == 0:
                    absd["K9s"] = dmax
            say(msg)
            del whole
            gc.collect()
    del A, A32, cases
    gc.collect()
    torch.cuda.empty_cache()
    # K9m's slab form against its plain version and against the square form
    gen = torch.Generator(device=DEVICE).manual_seed(ns)
    P = torch.randn(ns, ns, dtype=torch.float64, device=DEVICE, generator=gen)
    Psq, Ssq = P.clone(), P.clone()
    ochol.murray_phi_cuda(Psq)
    ochol.symmetrize_cuda(Ssq)
    PT = P.T.contiguous()
    same = []
    for lo, hi in zip(bounds_s[:-1], bounds_s[1:]):
        X1, X2 = P[lo:hi].clone(), P[lo:hi].clone()
        ochol.murray_phi_slab(X1, lo)
        ochol.murray_phi_slab_plain(X2, lo)
        Y1, Y2 = P[lo:hi].clone(), P[lo:hi].clone()
        ochol.symmetrize_slab(Y1, PT[lo:hi], lo)
        ochol.symmetrize_slab_plain(Y2, PT[lo:hi])
        same += [torch.equal(X1, X2), torch.equal(X1, Psq[lo:hi]), torch.equal(Y1, Y2),
                 torch.equal(Y1, Ssq[lo:hi])]
    say(f"[phase 2f] K9m slab form n={ns} slabs {bounds_s}: phi bitwise plain/square "
        f"{same[0::4]}/{same[1::4]}, sym bitwise plain/square {same[2::4]}/{same[3::4]}")
    check(all(same), "K9m's slab form differs from its plain version or the square form")
    say(f"[phase 2f] worst K9s {worst:.3e} (tol {TOL_2F['K9s']})")
    absd.update(_mixed_slab_forms(torch, gram, mixed, ns, bounds_s))
    # K4s against K4: bitwise at one rank, exactly symmetric across two
    for nk in K4_SIZES:
        K = _noisy_matern_spd(torch, gram, nk, MIXED_CONDS[0], 700 + nk)[0]
        L32 = torch.linalg.cholesky(K.float()).contiguous()
        F = mixed.factorization_residual_cuda(K, L32)
        one, cross, err, dmax = _k4s_symmetry(torch, mixed, K, L32, F)
        say(f"[phase 2f] K4s n={nk}: R=1 bitwise K4 {one}, "
            f"R=2 R[i, j] on one rank bitwise R[j, i] on the other {cross}, R=1 vs plain "
            f"{err:.2e} (tol {TOL_MIXED['K4']})")
        check(one and cross and err <= TOL_MIXED["K4"],
              f"K4s at n={nk}: bitwise K4 {one}, symmetric across ranks {cross}, err {err:.3e}")
        if nk == SLICE_N:
            absd["K4s"] = dmax
        del K, L32, F
    return absd


def _mixed_slab_forms(torch, gram, mixed, n, bounds):
    """The slab forms of K3, K4s, K6 and K7 on every slab of a noisy-Matern K
    (cond ~1e3) and its f32 factor, against their plain versions, with phase
    2b's and 2d's tolerances (K3 at every k of K3_WIDTHS, f64 and f32, each
    bitwise reproducible); K4s's blocks also against K4's square output."""
    K = _noisy_matern_spd(torch, gram, n, MIXED_CONDS[0], 600 + n)[0]
    L32 = torch.linalg.cholesky(K.float()).contiguous()
    eye = torch.eye(n, dtype=torch.float32, device=DEVICE)
    M32 = torch.linalg.solve_triangular(L32, eye, upper=False).contiguous()
    R_sq = mixed.factorization_residual_cuda(K, L32)
    H = (M32 @ (R_sq @ M32.T)).contiguous()
    H2 = (H @ H).contiguous()
    gen = np.random.default_rng(n)
    X = torch.as_tensor(gen.normal(size=(n, 3)), device=DEVICE)
    Bf = torch.as_tensor(gen.normal(size=(n, 3)), device=DEVICE)
    X8 = torch.as_tensor(gen.normal(size=(n, max(K3_WIDTHS))), device=DEVICE)
    B8 = torch.as_tensor(gen.normal(size=(n, max(K3_WIDTHS))), device=DEVICE)
    eps32 = float(np.finfo(np.float32).eps)
    errs = {"K3": 0.0, "K3 f32": 0.0, "K4": 0.0, "K6": 0.0, "K7": 0.0}
    same_k4 = True
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        Ks, Ls, Ms, Hs, H2s = (A[lo:hi].contiguous() for A in (K, L32, M32, H, H2))
        Ks32 = Ks.float()
        for k in K3_WIDTHS:
            e3, e3f, _ = _k3_errs(torch, mixed, Ks, X8[:, :k].contiguous(),
                                  B8[lo:hi, :k].contiguous(), Ks32)
            errs["K3"], errs["K3 f32"] = max(errs["K3"], e3), max(errs["K3 f32"], e3f)
        del Ks32
        Rs1 = torch.empty((hi - lo, n), dtype=torch.float32, device=DEVICE)
        Rs2 = torch.empty_like(Rs1)
        for slo, shi in zip(bounds[:-1], bounds[1:]):
            Lb = L32[slo:shi].contiguous()
            mixed.factorization_residual_slab_cuda(Ks, Ls, Lb, lo, slo, Rs1)
            mixed.factorization_residual_slab_plain(Ks, Ls, Lb, slo, Rs2)
        errs["K4"] = max(errs["K4"], rel_err(Rs1.double(), Rs2.double()))
        same_k4 = same_k4 and torch.equal(Rs1, R_sq[lo:hi])
        z1 = mixed.precond_apply_slab_cuda(Ms, X, lo)
        z2 = mixed.precond_apply_slab_plain(Ms, X)
        check(torch.equal(z1, mixed.precond_apply_slab_cuda(Ms, X, lo)),
              f"K6's slab form on rows [{lo}, {hi}) is not bitwise reproducible")
        unit = n * eps32 * (Ms.abs().T @ (Ms.abs() @ X.abs().float()))
        errs["K6"] = max(errs["K6"], float(((z1 - z2).abs() / unit.clamp_min(1e-30)).max()))
        # the views' bases are 16-byte aligned only where lo n % 4 == 0 (at
        # n = 4099 the slab at row 2050 is not: K7's scalar-load instance)
        t1, t2 = mixed.trace_sums_cuda(Hs, lo), mixed.trace_sums_plain(Hs, lo)
        s1, s2 = mixed.series_sums_cuda(Hs, H2s), mixed.series_sums_plain(Hs, H2s)
        check(torch.equal(t1, mixed.trace_sums_cuda(Hs, lo))
              and torch.equal(s1, mixed.series_sums_cuda(Hs, H2s)),
              f"K7's slab form on rows [{lo}, {hi}) is not bitwise reproducible")
        errs["K7"] = max(errs["K7"], rel_err(t1, t2), rel_err(s1, s2))
    say(f"[phase 2f] slab forms n={n} slabs {bounds}: K3 {errs['K3']:.2e} (tol "
        f"{TOL_MIXED['K3']}; f32 {errs['K3 f32']:.2e}, tol {TOL_MIXED['K3 f32']}; k in "
        f"{K3_WIDTHS}, reproducible), K4s {errs['K4']:.2e} (tol {TOL_MIXED['K4']}; bitwise K4's rows "
        f"{same_k4}), K6 {errs['K6']:.2e} units of n eps32 (tol {TOL_2D['K6']}, reproducible), K7 "
        f"{errs['K7']:.2e} (tol {TOL_MIXED['K7']}, reproducible; 16-byte aligned slab bases "
        f"{[lo * n % 4 == 0 for lo in bounds[:-1]]})")
    check(errs["K3"] <= TOL_MIXED["K3"] and errs["K3 f32"] <= TOL_MIXED["K3 f32"]
          and errs["K4"] <= TOL_MIXED["K4"]
          and errs["K6"] <= TOL_2D["K6"] and errs["K7"] <= TOL_MIXED["K7"],
          "a slab form of K3/K4s/K6/K7 against its plain version")
    check(same_k4, f"K4s's blocks on the slabs {bounds} are not bitwise K4's rows")
    return {}


def _k4s_symmetry(torch, mixed, K, L32, F):
    """K4s at one rank (the whole matrix as one slab) against K4's output F,
    and at two ranks (n split at ceil(n / 2)): (bitwise F at R = 1, R[i, j]
    on one rank bitwise R[j, i] on the other, max|K4s - plain| / max|plain|
    and max|K4s - plain| at R = 1)."""
    n = K.shape[0]
    R1 = torch.empty((n, n), dtype=torch.float32, device=DEVICE)
    mixed.factorization_residual_slab_cuda(K, L32, L32, 0, 0, R1)
    one = torch.equal(R1, F)
    P = mixed.factorization_residual_slab_plain(K, L32, L32, 0, torch.empty_like(R1))
    dmax = float((R1.double() - P.double()).abs().max())
    err = dmax / float(P.abs().max())
    del R1, P
    h = n - n // 2
    cuts = (0, h, n)
    slabs = []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        Ks, Ls = K[lo:hi].contiguous(), L32[lo:hi].contiguous()
        R2 = torch.empty((hi - lo, n), dtype=torch.float32, device=DEVICE)
        for slo, shi in zip(cuts[:-1], cuts[1:]):
            mixed.factorization_residual_slab_cuda(Ks, Ls, L32[slo:shi].contiguous(), lo, slo, R2)
        slabs.append(R2)
    cross = torch.equal(slabs[0][:, h:], slabs[1][:, :h].T)
    return one, cross, err, dmax


def _builtin_noisy_model(gp, gnp):
    """bench.py's noisy model through the built-in Matern covariance (K1/K2):
    covparam [log s2, log noise, log 1/rho_1..d]."""
    def mean(x, param):
        return gnp.ones((x.shape[0], 1))

    def kernel(x, y, param, pairwise=False):
        theta = gnp.concatenate([param[:1], param[2:]])
        K = gp.kernel.maternp_covariance(x, y, 2, theta, pairwise)
        if y is x or y is None:
            K = K + gnp.exp(param[1]) * (gnp.ones((x.shape[0],)) if pairwise
                                         else gnp.eye(x.shape[0]))
        return K

    return gp.Model(mean, kernel)


def _hessian_and_xt_grad(gp, gnp, torch, model, xi, zi, xt, p):
    """(REML Hessian at p, d sum(zpm^2) / d xt at p) on the configured device."""
    from torch.autograd.functional import hessian

    x, z = gnp.asarray(xi), gnp.asarray(zi)
    H = hessian(lambda c: model.negative_log_restricted_likelihood(c, x, z), gnp.asarray(p))
    model.covparam = gnp.asarray(p)
    xtg = gnp.asarray(xt).clone().requires_grad_(True)
    zpm, _ = model.predict(x, z, xtg, convert_out=False)
    (gx,) = torch.autograd.grad(torch.sum(zpm ** 2), xtg)
    return H.detach().cpu().numpy(), gx.cpu().numpy()


def phase_repairs(gp, gnp, torch):
    """Phase 3f: the REML Hessian through the built-in (K1/K2) and the user
    (K1d/K1m) covariance, and the predicted mean's gradient in xt, card
    against CPU (f64 engine); a second derivative through the mixed engine
    raises."""
    t_phase = time.perf_counter()
    xi, zi, p0 = _bench_data(REPAIR_N)
    xt = np.random.default_rng(SLICE_SEED + 1).uniform(size=(64, xi.shape[1]))
    gp.config.set_chol_engine("f64")
    errs = {}
    for route, make in (("built-in", _builtin_noisy_model), ("user", _bench_model)):
        gp.config.set_device(DEVICE)
        (H, gx), t_card = _timed(torch, lambda: _hessian_and_xt_grad(
            gp, gnp, torch, make(gp, gnp), xi, zi, xt, p0))
        gp.config.set_device("cpu")
        try:
            t0 = time.perf_counter()
            Hc, gxc = _hessian_and_xt_grad(gp, gnp, torch, make(gp, gnp), xi, zi, xt, p0)
            t_cpu = time.perf_counter() - t0
        finally:
            gp.config.set_device(DEVICE)
        e_h = float(np.max(np.abs(H - Hc)) / np.max(np.abs(Hc)))
        e_x = float(np.max(np.abs(gx - gxc)) / np.max(np.abs(gxc)))
        asym = float(np.max(np.abs(H - H.T)) / np.max(np.abs(H)))
        errs[route] = (e_h, e_x)
        say(f"[phase 3f] {route} covariance, n={REPAIR_N}, bench.py's p0: REML Hessian card vs "
            f"CPU rel {e_h:.2e} (tol {TOL_REPAIR['hessian']}), max|H| {np.max(np.abs(Hc)):.4e}, "
            f"asymmetry {asym:.1e}, zero entries {int(np.sum(H == 0))}; d sum(zpm^2)/d xt (nt=64) "
            f"rel {e_x:.2e} (tol {TOL_REPAIR['xt grad']}); {t_card:.2f} s card, {t_cpu:.2f} s CPU")
        check(np.all(np.isfinite(H)) and np.all(H != 0), f"the {route} Hessian has zeros or NaN")
        check(e_h <= TOL_REPAIR["hessian"], f"the {route} REML Hessian, card vs CPU")
        check(e_x <= TOL_REPAIR["xt grad"], f"the {route} xt gradient, card vs CPU")
    gp.config.set_chol_engine("mixed")
    model = _bench_model(gp, gnp)
    x, z = gnp.asarray(xi), gnp.asarray(zi)
    from torch.autograd.functional import hessian

    try:
        hessian(lambda c: model.negative_log_restricted_likelihood(c, x, z), gnp.asarray(p0))
        raised = None
    except RuntimeError as exc:
        raised = str(exc)
    gp.config.set_chol_engine("auto")
    say(f"[phase 3f] the mixed engine's Hessian raised: {raised!r}")
    check(raised is not None and "second derivatives are not implemented" in raised,
          "a second derivative through the mixed engine did not raise")
    say(f"[phase 3f] phase seconds {time.perf_counter() - t_phase:.1f}")
    return errs


def _group_counters(refine, ochol):
    return {"K8r": (refine, "K8R_LAUNCHES"), "K8t": (refine, "K8T_LAUNCHES"),
            "K9u": (ochol, "K9U_LAUNCHES"), "K9s": (ochol, "K9S_LAUNCHES"),
            "K9m": (ochol, "K9M_LAUNCHES")}


def phase_group_nccl(gp, gnp, torch, gram, distance, mixed, refine, ochol, ref):
    """Phase 3g: a 1-rank NCCL group at full size, the per-rank algorithm
    (gathers of one, K9s), held against phase 3e's one-card path."""
    import datetime

    import torch.distributed as dist

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # the group is this host's loopback
    dist.init_process_group(GROUP_BACKEND, init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=300))
    try:
        return _phase_group_nccl(gp, gnp, torch, gram, distance, mixed, refine, ochol, ref)
    finally:
        dist.destroy_process_group()


def _phase_group_nccl(gp, gnp, torch, gram, distance, mixed, refine, ochol, ref):
    from gpmp_tpu_torch import parallel
    from gpmp_tpu_torch.parallel import chol as pchol
    from gpmp_tpu_torch.parallel import comm

    t_phase = time.perf_counter()
    mesh = parallel.make_mesh(axis_name="shard")
    check(mesh.is_group and mesh.size == 1 and mesh.device.type == "cuda",
          f"make_mesh() under a 1-rank NCCL group gave {mesh!r}")
    n = RESIDENT_N
    xi, zi, p0 = _large_data(n)
    xt = _large_xt(n)
    block = parallel.auto_shard_block(n, mesh)
    check(block == CHOL_BLOCK, f"auto_shard_block({n}) = {block}")
    gp.config.set_device(DEVICE)
    gp.config.set_chol_engine("f64")
    counters = _group_counters(refine, ochol)
    guard = (gram, distance, mixed, refine, ochol)
    walls, mem, per_call = {}, {}, {}
    unit = 4 * n * n
    model = _large_model(gp, gnp)
    vg, _ = _criterion(gp, model, xi, zi, mesh)
    p_ref = ref["p_fit"]
    pm = _large_model(gp, gnp)
    pm.covparam = gnp.asarray(p_ref)
    view = parallel.ShardedModelView(pm, mesh)
    with _PlainGuard(*guard):
        # the group's main path: fit, then predict and LOO, each with the
        # counts set to 0 just before and read just after
        _reset(counters)
        fit_model = _large_model(gp, gnp)
        (fit_model, info), walls["fit"] = _timed(
            torch, lambda: gp.kernel.select_parameters_with_reml(
                fit_model, xi, zi, covparam0=p0, mesh=mesh, method="L-BFGS-B",
                method_options={"maxiter": RESIDENT_MAXITER}, info=True))
        launches = _read(counters)
        _reset(counters)
        ((zpm, zpv), walls["predict"]), mem["predict"] = _peak_rise(
            torch, lambda: _timed(torch, lambda: view.predict(xi, zi, xt)))
        per_call["predict"] = _read(counters)
        _reset(counters)
        ((zloo, s2loo, eloo), walls["loo"]), mem["loo"] = _peak_rise(
            torch, lambda: _timed(torch, lambda: view.loo(xi, zi)))
        per_call["loo"] = _read(counters)
        for key in counters:
            launches[key] += per_call["predict"][key] + per_call["loo"][key]
        _reset(counters)
        comm.reset_counts()
        ((v0, g0), walls["value+grad (first)"]), mem["f64 mesh value+grad"] = _peak_rise(
            torch, lambda: _timed(torch, lambda: vg(p0)))
        per_call["value+grad"] = _read(counters)
        vg_comm = {k: (comm.CALLS[k], comm.BYTES[k]) for k in comm.CALLS}
        _, walls["value+grad (warm)"] = _timed(torch, lambda: vg(p0 + 1e-3))
        # one factor: its launches, gathers and bytes
        K = parallel.sharded_covariance(pm, gnp.asarray(p_ref), gnp.asarray(xi), mesh)
        _reset(counters)
        comm.reset_counts()
        _, walls["factor"] = _timed(torch, lambda: pchol._factor_in_place(K, mesh, block))
        per_call["factor"] = _read(counters)
        factor_comm = {k: (comm.CALLS[k], comm.BYTES[k]) for k in comm.CALLS if comm.CALLS[k]}
        del K
    p_fit = np.asarray(info.x)
    e_v = abs(v0 - ref["v0"]) / abs(ref["v0"])
    e_g = float(np.max(np.abs(g0 - ref["g0"])) / np.max(np.abs(ref["g0"])))
    e_fit = float(np.max(np.abs(p_fit - p_ref)) / np.max(np.abs(p_ref)))
    e_pred = [rel_err(a, b) for a, b in zip((zpm, zpv), ref["predict"])]
    e_loo = [rel_err(a, b) for a, b in zip((zloo, s2loo, eloo), ref["loo"])]
    say(f"[phase 3g] (a) n={n} f64, a 1-rank NCCL group ({mesh!r}), block {block}: fit "
        f"(L-BFGS-B, maxiter {RESIDENT_MAXITER}) nfev {info.nfev}, {walls['fit']:.3f} s (one card "
        f"{ref['walls']['fit']:.3f} s), REML {info.history_criterion[0]!r} -> {info.fun!r}; "
        f"launches (fit + predict + LOO) {launches}; per value+grad {per_call['value+grad']}, "
        f"per predict {per_call['predict']}, per LOO {per_call['loo']}, per factor "
        f"{per_call['factor']} (one card {ref['per_call']['factor']})")
    say(f"[phase 3g] (a) against the one-card path (phase 3e): REML at p0 rel {e_v:.2e}, "
        f"gradient {e_g:.2e}, the fit's covparam {e_fit:.2e} (tol {TOL_GROUP['fit']}); at 3e's "
        f"fit: predict mean {e_pred[0]:.2e}, variance {e_pred[1]:.2e}, LOO "
        f"{', '.join(f'{e:.2e}' for e in e_loo)} (tol {TOL_GROUP['one-card']})")
    say(f"[phase 3g] (a) collectives per factor (calls, bytes) {factor_comm}; per value+grad "
        f"{ {k: v for k, v in vg_comm.items() if v[0]} }")
    for key in ("K8r", "K8t", "K9s", "K9m"):
        check(launches[key] > 0, f"{key} was not launched on the group mesh's path")
    check(launches["K9u"] == 0, "the group mesh's path launched the one-card K9u")
    check(e_v <= TOL_GROUP["one-card"] and e_g <= TOL_GROUP["one-card"],
          "the group REML against the one-card path")
    check(e_fit <= TOL_GROUP["fit"], "the group fit against the one-card fit")
    check(max(*e_pred, *e_loo) <= TOL_GROUP["one-card"],
          "the group predict/LOO against the one-card path")
    check(np.isfinite(info.fun) and info.fun <= info.history_criterion[0],
          "the group fit ended above its start or not finite")

    # (b) the sharded mixed engine on the group (slabs: K3, K4s, K6, K7 in
    # their slab forms, the f32 factor on the f32 K9s) at p0, against phase
    # 3e's f64 and mixed one-card branches with the mixed engine's class bars
    gp.config.set_chol_engine("mixed")
    mc = {k: (mixed, f"{k}_LAUNCHES") for k in ("K3", "K6", "K7")}
    mc["K4s"] = (mixed, "K4S_LAUNCHES")
    mc["K9s f32"] = (ochol, "K9S_F32_LAUNCHES")
    vg_mix, _ = _criterion(gp, model, xi, zi, mesh)
    with _PlainGuard(*guard):
        _reset(mc)
        ((vm, gm), walls["mixed value+grad (first)"]), mem["mixed mesh value+grad"] = (
            _peak_rise(torch, lambda: _timed(torch, lambda: vg_mix(p0))))
        mixed_launches = _read(mc)
        _, walls["mixed value+grad (warm)"] = _timed(torch, lambda: vg_mix(p0 + 1e-3))
    gp.config.set_chol_engine("f64")
    del vg_mix
    env_s2, env_rest = TOL_RESIDENT["mixed grad"]
    env = np.array([env_s2] + [env_rest] * (len(p0) - 1))
    e_vm = abs(vm - ref["v0"]) / abs(ref["v0"])
    e_gm = np.abs(gm - ref["g0"]) / np.abs(ref["g0"])
    e_vmm = abs(vm - ref["vm0"]) / abs(ref["vm0"])
    e_gmm = np.abs(gm - ref["gm0"]) / np.abs(ref["gm0"])
    say(f"[phase 3g] (b) n={n} mixed on the group: launches {mixed_launches}; REML {vm!r}: "
        f"vs the one-card f64 branch rel {e_vm:.2e}, vs the one-card mixed branch rel "
        f"{e_vmm:.2e} (tol {TOL_RESIDENT['mixed reml']}); grad vs f64 "
        f"{np.array2string(e_gm, precision=2)}, vs one-card mixed "
        f"{np.array2string(e_gmm, precision=2)} (envelope {env.tolist()})")
    for key, count in mixed_launches.items():
        check(count > 0, f"{key} was not launched on the group's mixed branch")
    launches["K9s f32"] = mixed_launches["K9s f32"]
    launches["K4s"] = mixed_launches["K4s"]
    check(max(e_vm, e_vmm) <= TOL_RESIDENT["mixed reml"] and np.all(e_gm <= env)
          and np.all(e_gmm <= env), "the group's mixed branch against the one-card branches")
    gc.collect()
    torch.cuda.empty_cache()

    # (c) n = 51200, f64: the factor and the REML through factor= on the group
    n3 = RESIDENT_BIG_N
    xi3, zi3, p3 = _large_data(n3)
    model3 = _large_model(gp, gnp)
    model3.covparam = gnp.asarray(p3)
    x3, z3, c3 = gnp.asarray(xi3), gnp.asarray(zi3), gnp.asarray(p3)
    block3 = parallel.auto_shard_block(n3, mesh)
    with _PlainGuard(*guard):
        K3 = parallel.sharded_covariance(model3, c3, x3, mesh)
        _reset(counters)
        comm.reset_counts()
        (L3, walls[f"factor n={n3} (sharded_cholesky)"]), mem[f"factor n={n3}"] = _peak_rise(
            torch, lambda: _timed(torch, lambda: parallel.sharded_cholesky(K3, mesh,
                                                                           block=block3)))
        per_call[f"factor n={n3}"] = _read(counters)
        comm3 = {k: (comm.CALLS[k], comm.BYTES[k]) for k in comm.CALLS if comm.CALLS[k]}
        del K3
        v3 = float(parallel.sharded_negative_log_restricted_likelihood(
            model3, c3, x3, z3, mesh, block=block3, factor=L3))
    del L3
    gc.collect()
    torch.cuda.empty_cache()
    e_or = abs(v3 - REML_ORACLE_51200) / abs(REML_ORACLE_51200)
    say(f"[phase 3g] (c) n={n3} f64, block {block3}: factor "
        f"{walls[f'factor n={n3} (sharded_cholesky)']:.3f} s (one card "
        f"{ref['walls'][f'factor n={n3} (sharded_cholesky)']:.3f} s), launches "
        f"{per_call[f'factor n={n3}']}, collectives {comm3}; REML factor= {v3!r} vs the NumPy "
        f"oracle {REML_ORACLE_51200!r} rel {e_or:.2e} (tol {TOL_GROUP['oracle']})")
    check(e_or <= TOL_GROUP["oracle"], "the group's n=51200 REML against the oracle")
    for what, b_ in mem.items():
        nn = n3 if "51200" in what else n
        one = ref["mem"].get(what)
        beside = "" if one is None else f" (one card {one / (4 * nn * nn):.2f})"
        say(f"[phase 3g] peak rise, {what}: {b_ / 2**30:.3f} GiB = {b_ / (4 * nn * nn):.2f} units "
            f"of 4n^2 B{beside}")
    say("[phase 3g] walls: " + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items()))
    say(f"[phase 3g] phase seconds {time.perf_counter() - t_phase:.1f}")
    return launches, walls, mem, factor_comm


def _gloo_probe(torch, dist, rank, device):
    """Each collective the group mesh runs, on CUDA tensors over gloo: 'ok',
    'wrong values' or the error."""
    out = {}
    for op in ("all_gather_into_tensor", "reduce_scatter_tensor", "all_to_all_single",
               "all_reduce", "broadcast"):
        try:
            x = torch.full((4, 3), float(rank + 1), device=device)
            if op == "all_gather_into_tensor":
                y = torch.empty(8, 3, device=device)
                dist.all_gather_into_tensor(y, x)
                ok = float(y.sum()) == 36.0
            elif op == "reduce_scatter_tensor":
                y = torch.empty(2, 3, device=device)
                dist.reduce_scatter_tensor(y, x)
                ok = float(y.sum()) == 18.0
            elif op == "all_to_all_single":
                y = torch.empty(4, 3, device=device)
                dist.all_to_all_single(y, x)
                ok = float(y.sum()) == 18.0
            elif op == "all_reduce":
                dist.all_reduce(x)
                ok = float(x.sum()) == 36.0
            else:
                dist.broadcast(x, src=0)
                ok = float(x.sum()) == 12.0
            out[op] = "ok" if ok else "wrong values"
        except Exception as exc:  # noqa: BLE001  (reported, and the phase fails)
            out[op] = f"{type(exc).__name__}: {str(exc)[:160]}"
    return out


def _mesh_results(gp, gnp, torch, mesh, n, block):
    """REML value+grad at p0, the view's predict at make_data's xt and its
    LOO at p0, on ``mesh``, as numpy arrays, with the walls."""
    xi, zi, p0 = _large_data(n)
    xt = _large_xt(n)
    model = _large_model(gp, gnp)
    vg, _ = _criterion(gp, model, xi, zi, mesh)
    (v, g), t_vg = _timed(torch, lambda: vg(p0))
    model.covparam = gnp.asarray(p0)
    from gpmp_tpu_torch import parallel

    view = parallel.ShardedModelView(model, mesh, block=block)
    (zpm, zpv), t_p = _timed(torch, lambda: view.predict(xi, zi, xt))
    loo, t_l = _timed(torch, lambda: view.loo(xi, zi))
    out = {"reml": np.asarray(v), "grad": np.asarray(g)}
    for k, t in zip(("zpm", "zpv", "zloo", "s2loo", "eloo"), (zpm, zpv, *loo)):
        out[k] = t.cpu().numpy()
    return out, {"value+grad": t_vg, "predict": t_p, "loo": t_l}


def _gloo_rank(rank, world, port, queue, n, block, device, dp):
    """One rank of phase 3h: gloo on the one card."""
    import datetime
    import traceback

    import torch
    import torch.distributed as dist

    try:
        sys.path.insert(0, HERE)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=120))
        probe = _gloo_probe(torch, dist, rank, device)
        bad = {k: v for k, v in probe.items() if v != "ok"}
        if bad:
            raise RuntimeError(f"gloo does not take CUDA tensors for {bad}")
        import gpmp_tpu_torch as gp
        import gpmp_tpu_torch.kernel  # noqa: F401
        import gpmp_tpu_torch.num as gnp
        import gpmp_tpu_torch.parallel  # noqa: F401
        from gpmp_tpu_torch.ops import chol as ochol
        from gpmp_tpu_torch.parallel import comm

        gp.config.set_device(device)
        gp.config.set_chol_engine("f64")
        mesh = gp.parallel.make_mesh(world, axis_name="shard")
        ochol.K9S_LAUNCHES = 0
        comm.reset_counts()
        res, walls = _mesh_results(gp, gnp, torch, mesh, n, block)
        res["probe"], res["walls"], res["mesh"] = probe, walls, repr(mesh)
        res["k9s"] = ochol.K9S_LAUNCHES
        res["comm"] = {k: (comm.CALLS[k], comm.BYTES[k]) for k in comm.CALLS}
        # phase 3j's data-parallel REMAP criterion, this rank's share of the batches
        gp.config.set_chol_engine("auto")
        dp_mesh = gp.parallel.make_mesh(world)
        xb, zb = gp.parallel.shard_batches(dp["x"], dp["z"], PHASE3J_GLOO_BATCHES, mesh=dp_mesh)
        crit = _remap_criterion(gp, gnp, dp["args"])
        model = _model(gp, gnp)
        vg = gp.parallel.make_data_parallel_criterion(
            lambda p, x, z: crit(model, p, x, z), dp_mesh)
        v, g = vg(dp["p"], xb, zb)
        res["dp"] = (float(v), g.cpu().numpy(), int(xb.shape[0]))
        queue.put((rank, res))
    except BaseException:  # noqa: BLE001  (the parent fails the phase with it)
        queue.put((rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def phase_group_gloo(gp, gnp, torch, dp_ref):
    """Phase 3h: two ranks on the one card over gloo (spawned), n =
    GROUP_GLOO_N, against the one-card resident path on the same card; and
    phase 3j's data-parallel REMAP criterion over PHASE3J_GLOO_BATCHES
    batches, half a rank, against its one-card value (``dp_ref``)."""
    import multiprocessing as mp
    import queue as _queue

    from gpmp_tpu_torch import parallel

    t_phase = time.perf_counter()
    n, block, world = GROUP_GLOO_N, CHOL_BLOCK, 2
    gp.config.set_device(DEVICE)
    gp.config.set_chol_engine("f64")
    ref, ref_walls = _mesh_results(gp, gnp, torch, parallel.make_mesh(1, axis_name="shard"),
                                   n, block)
    gc.collect()
    torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    dp = {k: dp_ref[k] for k in ("args", "p", "x", "z")}
    procs = [ctx.Process(target=_gloo_rank, args=(r, world, port, q, n, block, DEVICE, dp))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in range(world):
            rank, res = q.get(timeout=600)
            check(not isinstance(res, str), f"phase 3h rank {rank} failed:\n{res}")
            results[rank] = res
    except _queue.Empty:
        fail(f"phase 3h: the {world} gloo ranks did not finish in 600 s")
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    t_group = time.perf_counter() - t0
    r0, r1 = results[0], results[1]
    keys = ("reml", "grad", "zpm", "zpv", "zloo", "s2loo", "eloo")
    errs = {k: float(np.max(np.abs(r0[k] - ref[k])) / np.max(np.abs(ref[k]))) for k in keys}
    same = all(np.array_equal(r0[k], r1[k]) for k in keys)
    say(f"[phase 3h] n={n} f64, {world} gloo ranks on the one card ({r0['mesh']}), block "
        f"{block}: collectives on CUDA tensors {r0['probe']}; K9s launches per rank "
        f"{r0['k9s']}/{r1['k9s']}; against the one-card path "
        + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
        + f" (tol {TOL_GROUP['gloo']}); the ranks bitwise equal {same}")
    say(f"[phase 3h] walls (rank 0) " + ", ".join(f"{k} {v:.3f} s" for k, v in r0["walls"].items())
        + "; one card " + ", ".join(f"{k} {v:.3f} s" for k, v in ref_walls.items())
        + f"; the group's processes {t_group:.1f} s in all; rank 0's collectives (calls, "
        f"bytes) { {k: v for k, v in r0['comm'].items() if v[0]} }")
    check(r0["k9s"] > 0 and r1["k9s"] > 0, "K9s was not launched on both gloo ranks")
    check(same, "the two ranks' replicated results differ")
    check(max(errs.values()) <= TOL_GROUP["gloo"], "the gloo group against the one-card path")
    (v0, g0, nb0), (v1, g1, nb1) = r0["dp"], r1["dp"]
    dp_errs = {"value": abs(v0 - dp_ref["value"]) / abs(dp_ref["value"]),
               "grad": rel_err_np(g0, dp_ref["grad"])}
    dp_same = v0 == v1 and np.array_equal(g0, g1)
    say(f"[phase 3h] data-parallel REMAP criterion, {PHASE3J_GLOO_BATCHES} batches of "
        f"{PHASE3J_N // PHASE3J_GLOO_BATCHES} ({nb0}/{nb1} a rank): against one card value "
        f"{dp_errs['value']:.2e}, grad {dp_errs['grad']:.2e} (tol {TOL_3J['dp']}); the ranks "
        f"bitwise equal {dp_same}")
    check(nb0 == nb1 == PHASE3J_GLOO_BATCHES // world, "each rank's share of the batches")
    check(dp_same, "the two ranks' data-parallel criteria differ")
    check(max(dp_errs.values()) <= TOL_3J["dp"], "the data-parallel criterion on the gloo ranks "
          "against one card")
    errs.update({f"data-parallel {k}": v for k, v in dp_errs.items()})
    say(f"[phase 3h] phase seconds {time.perf_counter() - t_phase:.1f}")
    return errs


def _k9s_bound(n, b, off, rows, c0=0, itemsize=8, peak=PEAK_F64_TENSOR_FLOPS):
    """(bound_ms, bound_by) of one K9s launch on the slab of global rows
    [off, off + rows) at the panel [c0, c0 + b): 2 b operations per lower
    trapezoid entry at the peak for their type, or reading and writing the
    trapezoid and reading T and Mt's trailing rows once."""
    w0 = c0 + b
    r0 = max(off, w0)
    ents = sum(gi - w0 + 1 for gi in range(r0, off + rows))
    nbytes = itemsize * (2 * ents + (off + rows - r0) * b + (n - w0) * b)
    return _bound(nbytes, 2 * b * ents, peak)


def _k4s_bound(n, rows, rows_b, off, offs):
    """(bound_ms, bound_by) of one K4s launch: the (rows, rows_b) column
    block of K read (f64) and of R written (f32), the rows of La and Lb read
    up to each one's last needed column (f32), and 2 min(i, j) + 2
    operations per entry at the f64 tensor peak."""
    ops, la, lb = 0, 0, 0
    jlo, jhi = offs, offs + rows_b
    for gi in range(off, off + rows):  # sum over j of (min(gi, gj) + 1)
        m = min(max(gi, jlo), jhi)  # columns gj < m have gj < gi
        ops += (m - jlo) * (jlo + m + 1) // 2 + (jhi - m) * (gi + 1)
        la += min(gi, jhi - 1) + 1
    for gj in range(jlo, jhi):
        lb += min(gj, off + rows - 1) + 1
    return _bound(8 * rows * rows_b + 4 * (la + lb) + 4 * rows * rows_b, 2 * ops,
                  PEAK_F64_TENSOR_FLOPS)


def phase_group_times(gp, gnp, torch, gram, mixed, ochol):
    """Phase 4f: the slab kernels at n = RESIDENT_N (_slab_kernel_times)."""
    K = _large_gram(gp, gnp, RESIDENT_N)
    times, bounds, device = _slab_kernel_times(torch, mixed, ochol, K, "4f")
    del K
    gc.collect()
    torch.cuda.empty_cache()
    keys = {"K9s": "R=1", "K9s f32": "f32 R=1", "K4s": "K4s R=1"}
    return ({k: times[v] for k, v in keys.items()}, {k: bounds[v] for k, v in keys.items()},
            {k: device[v] for k, v in keys.items()})


def _slab_kernel_times(torch, mixed, ochol, K, phase, digests=None):
    """K9s on K's one-rank slab (the first, a middle and the last panel) and
    on the second rank's slab of two (first panel), in f64 and in f32 (phase
    3g's mixed engine), K4s on the one-rank slab and K4 on K (phase 3e(b)'s
    resident mixed branch), K6's slab form (k = 2) on the one-rank slab and
    the second rank's: kernel (events, profiler), plain, library call
    (torch.addmm, multi_dot for K6, on the same inputs), bound; printed and
    returned as (times, bounds, device) by case.  With a dict ``digests``,
    also each K9s case's output from one launch on a fresh copy, K4s's, K4's
    and K6's, hashed into it."""
    b, n = CHOL_BLOCK, K.shape[0]
    t = lambda fn, reps: _time_cuda(torch, fn, reps, warmup=1)  # noqa: E731
    times, bounds, device = {}, {}, {}
    f64, f32 = torch.float64, torch.float32
    panels = sorted({0, ((n - 1) // b // 2) * b, ((n - 1) // b - 1) * b})
    cases = []
    for dt, pre in ((f64, ""), (f32, "f32 ")):
        cases += [(f"{pre}R=1 c0={c0}" if c0 else f"{pre}R=1", 0, n, c0, dt) for c0 in panels]
        cases += [(f"{pre}R=2 rank 1", n // 2, n // 2, 0, dt)]
    for tag, off, rows, c0, dt in cases:
        Kd = K.to(dt)
        w0 = c0 + b
        Mt = torch.zeros((n, b), dtype=dt, device=K.device)
        Mt[w0:] = Kd[w0:, c0:w0]
        W = Kd[off:off + rows].clone()
        r0 = max(off, w0) - off
        S, T = W[r0:, w0:], W[r0:, c0:w0]
        reps = 10 if c0 == 0 else 30
        times[tag] = (t(lambda: ochol.slab_update_cuda(W, off, c0, b, Mt), reps),
                      t(lambda: ochol.slab_update_plain(W, off, c0, b, Mt), 3),
                      t(lambda: torch.addmm(S, T, Mt[w0:].T, alpha=-1.0), reps))
        device[tag] = _device_ms(torch, lambda: ochol.slab_update_cuda(W, off, c0, b, Mt), 5)
        bounds[tag] = _k9s_bound(n, b, off, rows, c0, W.element_size(),
                                 PEAK_F64_TENSOR_FLOPS if dt == f64 else PEAK_F32_FLOPS)
        if digests is not None:
            W.copy_(Kd[off:off + rows])
            ochol.slab_update_cuda(W, off, c0, b, Mt)
            digests[f"K9s {tag}"] = _digest(W)
        del Kd, W, S, T, Mt
    # K4s on the one-rank slab (the group's mixed engine) and K4 at n
    L32 = torch.linalg.cholesky_ex(K.float())[0].contiguous()
    L64 = L32.double()
    R = torch.empty((n, n), dtype=f32, device=K.device)
    times["K4s R=1"] = (
        t(lambda: mixed.factorization_residual_slab_cuda(K, L32, L32, 0, 0, R), 5),
        t(lambda: mixed.factorization_residual_slab_plain(K, L32, L32, 0, R), 2),
        t(lambda: torch.addmm(K, L64, L64.T, alpha=-1), 5))
    device["K4s R=1"] = _device_ms(
        torch, lambda: mixed.factorization_residual_slab_cuda(K, L32, L32, 0, 0, R), 3)
    bounds["K4s R=1"] = _k4s_bound(n, n, n, 0, 0)
    if digests is not None:
        digests["K4s R=1"] = _digest(R)
        digests[f"K4 n={n}"] = _digest(mixed.factorization_residual_cuda(K, L32))
    del R
    times["K4"] = (t(lambda: mixed.factorization_residual_cuda(K, L32), 5),
                   t(lambda: mixed.factorization_residual_plain(K, L32), 2),
                   times["K4s R=1"][2])
    device["K4"] = _device_ms(torch, lambda: mixed.factorization_residual_cuda(K, L32), 3)
    bounds["K4"] = _kernel_bounds(n)["K4"]
    del L64
    # K6's slab form (the group's refined solves, k = 2) on the one-rank slab
    # and on the second rank's of two, the f32 factor as its lower-triangular
    # M (the time does not depend on M's values)
    r = torch.linspace(-1.0, 1.0, 2 * n, dtype=f64, device=K.device).reshape(n, 2)
    r32 = r.float()
    for tag, off, rows in (("K6 slab R=1", 0, n), ("K6 slab R=2 rank 1", n // 2, n - n // 2)):
        Ms = L32[off:off + rows]
        times[tag] = (t(lambda: mixed.precond_apply_slab_cuda(Ms, r, off), 20),
                      t(lambda: mixed.precond_apply_slab_plain(Ms, r), 5),
                      t(lambda: torch.linalg.multi_dot((Ms.T, Ms, r32)), 20))
        device[tag] = _device_ms(torch, lambda: mixed.precond_apply_slab_cuda(Ms, r, off), 10)
        tri = rows * off + rows * (rows + 1) // 2  # the slab's entries of the triangle
        bounds[tag] = _bound(4 * tri + 8 * 2 * n + 4 * 2 * n, 4 * tri * 2, PEAK_F32_FLOPS)
        if digests is not None:
            digests[tag] = _digest(mixed.precond_apply_slab_cuda(Ms, r, off))
    del L32, r, r32
    for tag, (t_k, t_p, t_l) in times.items():
        b_ms, b_by = bounds[tag]
        name = tag if tag.startswith(("K4", "K6")) else f"K9s {tag}"
        where = "" if ("c0=" in tag or tag.startswith(("K4", "K6"))) else " first panel"
        lib = "addmm f64" if tag.startswith("K4") else "multi_dot" if tag.startswith("K6") else (
            "addmm f32" if "f32" in tag else "addmm")
        say(f"[phase {phase}] {name} n={n}{where}: kernel {t_k:.4f} ms (device "
            f"{_fmt_ms(device[tag])}), plain {t_p:.4f} ms, library ({lib}) {t_l:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}), share {100 * b_ms / t_k:.1f}%")
    return times, bounds, device


# ----------------------------------------------------------------------------
# --compare ROOT: the redesigned kernels of a tree, timed alone
# ----------------------------------------------------------------------------
def _digest(t):
    import hashlib

    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def _compare_k8(torch, gram, mixed, refine, out):
    """--compare's K8s (n = SLICE_N and PATHS_NT, phase 4c's inputs), K8t and
    K8r (b = CHOL_BLOCK, phase 4e's A, L and M) and K3 (n = SLICE_N, k = 2,
    phase 4b's inputs): events, device time, the library call (f64 addmm /
    torch.matmul), the host issue time per call through the wrapper and the
    dispatcher, digests of the outputs (K8r's and K3's of two launches; K3's
    on the panel too), and refined_cholesky's wall per call on the panel,
    into out."""
    ms_out, dev_out = out["ms (kernel, plain, library)"], out["device_ms"]
    for n in (SLICE_N, PATHS_NT):
        K = _time_sqrt_inputs(torch, gram, n)
        L32 = mixed._f32_preconditioner(K)[0]
        L64 = L32.double()
        reps = 50 if n < PATHS_NT else 5
        key = f"K8s n={n}"
        ms_out[key] = (_time_cuda(torch, lambda: refine.sampling_residual_cuda(K, L32), reps),
                       None, _time_cuda(torch, lambda: torch.addmm(K, L64, L64.T, alpha=-1),
                                        reps))
        dev_out[key] = _device_ms(torch, lambda: refine.sampling_residual_cuda(K, L32),
                                  min(reps, 10))
        out["digest"][key] = _digest(refine.sampling_residual_cuda(K, L32))
        say(f"[compare] {key}: kernel {ms_out[key][0]:.4f} ms (device {_fmt_ms(dev_out[key])}), "
            f"library (f64 addmm) {ms_out[key][2]:.4f} ms")
        del K, L32, L64
    b = CHOL_BLOCK
    A, _ = _noisy_matern_spd(torch, gram, b, MIXED_CONDS[0], 300 + b)
    L32 = torch.linalg.cholesky(A.float())
    L = L32.double().contiguous()
    eye = torch.eye(b, dtype=torch.float32, device=DEVICE)
    M = torch.linalg.solve_triangular(L32, eye, upper=False).double().contiguous()
    key = f"K8t b={b}"
    ms_out[key] = (_time_cuda(torch, lambda: refine.tri_product_cuda(L, M), 50, warmup=1), None,
                   _time_cuda(torch, lambda: torch.matmul(L, M), 50, warmup=1))
    dev_out[key] = _device_ms(torch, lambda: refine.tri_product_cuda(L, M), 20)
    out["host_issue_us"][key] = {
        "wrapper": _host_issue_us(torch, lambda: refine.tri_product_cuda(L, M)),
        "dispatcher": _host_issue_us(torch, lambda: refine.tri_product(L, M)),
        "torch.matmul": _host_issue_us(torch, lambda: torch.matmul(L, M))}
    P = refine.tri_product_cuda(L, M)
    X = (M @ A @ M.T).contiguous()
    out["digest"][key] = _digest(torch.stack([
        P, refine.tri_product_cuda(M, P, 2.0, -1.0), refine.tri_product_cuda(L, X, 1.0, 1.0, True)]))
    say(f"[compare] {key}: kernel {ms_out[key][0] * 1e3:.2f} us (device "
        f"{_fmt_ms(dev_out[key])}), torch.matmul {ms_out[key][2] * 1e3:.2f} us; host issue "
        + ", ".join(f"{k} {v:.2f} us" for k, v in out["host_issue_us"][key].items()))
    # K8r on the same panel: times, host issue through the public layers,
    # digests (of two launches: they must repeat)
    key = f"K8r b={b}"
    ms_out[key] = (_time_cuda(torch, lambda: refine.refine_residual_cuda(A, L), 50, warmup=1),
                   None, _time_cuda(torch, lambda: torch.addmm(A, L, L.T, alpha=-1), 50,
                                    warmup=1))
    dev_out[key] = _device_ms(torch, lambda: refine.refine_residual_cuda(A, L), 20)
    out["host_issue_us"][key] = _host_path(torch, {
        "dispatcher": lambda: refine.refine_residual(A, L),
        "wrapper": lambda: refine.refine_residual_cuda(A, L)})
    for turn in range(2):
        E, sums = refine.refine_residual_cuda(A, L)
        out["digest"][f"{key}{' (again)' if turn else ''}"] = _digest(
            torch.cat([E.reshape(-1), sums]))
    say(f"[compare] {key}: kernel {ms_out[key][0] * 1e3:.2f} us (device "
        f"{_fmt_ms(dev_out[key])}), addmm {ms_out[key][2] * 1e3:.2f} us; host issue "
        + ", ".join(f"{k} {v:.2f} us" for k, v in out["host_issue_us"][key].items()))
    # refined_cholesky on the same panel (this tree: its graph; a tree before
    # it: the launches as they are), wall per call
    out["walls_s"][f"refined_cholesky b={b} per call"] = _time_cuda(
        torch, lambda: refine.refined_cholesky(A, with_inverse=True), 50, warmup=2) / 1e3
    # K3 at n = SLICE_N, k = 2 (phase 4b's inputs) and on the panel (digests)
    Xr = torch.linspace(-1.0, 1.0, 2 * b, dtype=torch.float64, device=DEVICE).reshape(b, 2)
    R3, norms3 = mixed.residual_cuda(A, Xr, Xr.flip(0).contiguous())
    out["digest"][f"K3 n={b}"] = _digest(torch.cat([R3.reshape(-1), norms3]))
    del A, L32, L, M, P, X
    n = SLICE_N
    K, _ = _noisy_matern_spd(torch, gram, n, 1e3, 7)
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    X = torch.randn(n, 2, dtype=torch.float64, device=DEVICE, generator=gen)
    B = torch.randn(n, 2, dtype=torch.float64, device=DEVICE, generator=gen)
    key = f"K3 n={n}"
    ms_out[key] = (_time_cuda(torch, lambda: mixed.residual_cuda(K, X, B), 200), None,
                   _time_cuda(torch, lambda: torch.addmm(B, K, X, alpha=-1), 200))
    dev_out[key] = _device_ms(torch, lambda: mixed.residual_cuda(K, X, B), 50)
    out["host_issue_us"][key] = _host_path(torch, {
        "dispatcher": lambda: mixed.residual(K, X, B),
        "wrapper": lambda: mixed.residual_cuda(K, X, B)})
    for turn in range(2):
        R3, norms3 = mixed.residual_cuda(K, X, B)
        out["digest"][f"{key}{' (again)' if turn else ''}"] = _digest(
            torch.cat([R3.reshape(-1), norms3]))
    say(f"[compare] {key} k=2: kernel {ms_out[key][0] * 1e3:.2f} us (device "
        f"{_fmt_ms(dev_out[key])}), addmm {ms_out[key][2] * 1e3:.2f} us; host issue "
        + ", ".join(f"{k} {v:.2f} us" for k, v in out["host_issue_us"][key].items()))


def _compare_k5_k6(torch, gram, mixed, out):
    """--compare's K5 (base 128) at n in COMPARE_K5_SIZES and K6 (k = 2) at
    n in COMPARE_K6_SIZES on the f32 factor of a noisy Matern K (n = SLICE_N:
    phase 4b's K; else _time_sqrt_inputs's), K6 with that factor as its
    lower-triangular M (the time does not depend on M's values): events,
    device time, the library call (batched trsm of the diagonal blocks /
    multi_dot), digests of two launches (they must repeat), into out."""
    ms_out, dev_out = out["ms (kernel, plain, library)"], out["device_ms"]
    base = mixed.TRI_INV_BASE
    gen = torch.Generator(device=DEVICE).manual_seed(12)
    for n in sorted(set(COMPARE_K5_SIZES) | set(COMPARE_K6_SIZES)):
        K = (_noisy_matern_spd(torch, gram, n, 1e3, 7)[0] if n == SLICE_N
             else _time_sqrt_inputs(torch, gram, n))
        L32 = torch.linalg.cholesky_ex(K.float())[0].contiguous()
        del K
        reps = 50 if n <= 8192 else 10
        if n in COMPARE_K5_SIZES:
            key = f"K5 n={n}"
            blocks = mixed._diag_blocks(L32, base)
            eye_b = torch.eye(base, device=DEVICE).expand(blocks.shape).contiguous()
            ms_out[key] = (_time_cuda(torch, lambda: mixed.diag_block_inv_cuda(L32, base), reps),
                           None, _time_cuda(torch, lambda: torch.linalg.solve_triangular(
                               blocks, eye_b, upper=False), reps))
            dev_out[key] = _device_ms(torch, lambda: mixed.diag_block_inv_cuda(L32, base),
                                      min(reps, 20))
            for turn in range(2):
                out["digest"][f"{key}{' (again)' if turn else ''}"] = _digest(
                    mixed.diag_block_inv_cuda(L32, base))
            del blocks, eye_b
            say(f"[compare] {key}: kernel {ms_out[key][0]:.4f} ms (device "
                f"{_fmt_ms(dev_out[key])}), batched trsm {ms_out[key][2]:.4f} ms")
        if n in COMPARE_K6_SIZES:
            key = f"K6 n={n}"
            r = torch.randn(n, 2, dtype=torch.float64, device=DEVICE, generator=gen)
            r32 = r.float()
            ms_out[key] = (_time_cuda(torch, lambda: mixed.precond_apply_cuda(L32, r), reps),
                           None, _time_cuda(torch, lambda: torch.linalg.multi_dot(
                               (L32.T, L32, r32)), reps))
            dev_out[key] = _device_ms(torch, lambda: mixed.precond_apply_cuda(L32, r),
                                      min(reps, 20))
            for turn in range(2):
                out["digest"][f"{key}{' (again)' if turn else ''}"] = _digest(
                    mixed.precond_apply_cuda(L32, r))
            say(f"[compare] {key} k=2: kernel {ms_out[key][0]:.4f} ms (device "
                f"{_fmt_ms(dev_out[key])}), multi_dot {ms_out[key][2]:.4f} ms")
        del L32


def _compare_k7(torch, gram, mixed, out):
    """--compare's K7 pair (trace_sums, then series_sums) at n in K7_SIZES on
    phase 4b's inputs (_k7_inputs): events, device time, digests of two
    pairs (they must repeat), into out."""
    ms_out, dev_out = out["ms (kernel, plain, library)"], out["device_ms"]
    for n in K7_SIZES:
        H, H2 = _k7_inputs(torch, gram, mixed, n)
        key = f"K7 n={n}"
        pair = lambda: (mixed.trace_sums_cuda(H), mixed.series_sums_cuda(H, H2))  # noqa: E731
        ms_out[key] = (_time_cuda(torch, pair, 200 if n <= SLICE_N else 50), None, None)
        dev_out[key] = _device_ms(torch, pair, 20)
        for turn in range(2):
            out["digest"][f"{key}{' (again)' if turn else ''}"] = _digest(torch.cat(pair()))
        say(f"[compare] {key} pair: kernel {ms_out[key][0]:.4f} ms (device "
            f"{_fmt_ms(dev_out[key])})")
        del H, H2


def _compare_streamed(gp, gnp, torch, out):
    """--compare's K10m, K10r (from the pair) and K10t (the first 512-row
    chunk of H) at n = LARGE_N on the engine's residents at bench_large_n's
    p0 (phase 4d's inputs), and K10r's recompute pass at n = LARGE_RC_N
    (_k10r_panel_pass): events, device time, digests (K10t's of two
    launches: they must repeat), into out."""
    from gpmp_tpu_torch.ops import mixed
    from gpmp_tpu_torch.ops import streamed as ops
    from gpmp_tpu_torch.parallel import likelihood as plik
    from gpmp_tpu_torch.parallel import streamed as st

    ms_out, dev_out = out["ms (kernel, plain, library)"], out["device_ms"]
    n = LARGE_N
    *_, K32, E32, L32 = _streamed_residents(gp, gnp, torch, st, plik, n)
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    X = torch.randn(n, 2, dtype=torch.float64, device=DEVICE, generator=gen)
    B = torch.randn(n, 2, dtype=torch.float64, device=DEVICE, generator=gen)
    key = f"K10m n={n}"
    ms_out[key] = (_time_cuda(torch, lambda: ops.ff_residual_cuda(K32, E32, X, B), 20, warmup=1),
                   None, None)
    dev_out[key] = _device_ms(torch, lambda: ops.ff_residual_cuda(K32, E32, X, B), 10)
    R, nr = ops.ff_residual_cuda(K32, E32, X, B)
    out["digest"][key] = _digest(torch.cat([R.reshape(-1), nr]))
    key = f"K10r n={n}"
    ms_out[key] = (_time_cuda(torch, lambda: ops.streamed_residual_ff_cuda(K32, E32, L32), 2,
                              warmup=1), None, None)
    dev_out[key] = _device_ms(torch, lambda: ops.streamed_residual_ff_cuda(K32, E32, L32), 1)
    Rk = ops.streamed_residual_ff_cuda(K32, E32, L32)
    out["digest"][key] = _digest(Rk)
    del K32, E32, X, B, R
    # K10t on the engine's H at p0, its first row chunk (phase 4d's inputs)
    c = STREAM_PANEL
    M32 = mixed._block_tri_inv(L32, base=mixed.TRI_INV_BASE)
    H = st._h_from_residual(M32, Rk, c)
    del Rk, M32, L32
    H2r = H[:c] @ H
    acc = torch.zeros(4, dtype=torch.float64, device=DEVICE)
    key = f"K10t n={n}"
    ms_out[key] = (_time_cuda(torch, lambda: ops.h_traces_chunk_cuda(H, H2r, 0, acc), 20,
                              warmup=1), None, None)
    dev_out[key] = _device_ms(torch, lambda: ops.h_traces_chunk_cuda(H, H2r, 0, acc), 10)
    for turn in range(2):
        acc.zero_()
        ops.h_traces_chunk_cuda(H, H2r, 0, acc)
        out["digest"][f"{key}{' (again)' if turn else ''}"] = _digest(acc)
    del H, H2r
    panels = _k10r_panel_pass(torch, ops, LARGE_RC_N, STREAM_PANEL, gen, out["digest"])
    ms_out[f"K10r recompute pass n={LARGE_RC_N}"] = (panels["pass_ms"], None, None)
    key = f"K10r panel n={LARGE_RC_N} c0={panels['c0']}"
    ms_out[key] = (panels["ms"], panels["plain_ms"], None)
    dev_out[key] = panels["device_ms"]
    say(f"[compare] K10m n={n}: {ms_out[f'K10m n={n}'][0]:.4f} ms (device "
        f"{_fmt_ms(dev_out[f'K10m n={n}'])}); K10t n={n}: {ms_out[f'K10t n={n}'][0]:.4f} ms "
        f"(device {_fmt_ms(dev_out[f'K10t n={n}'])}); K10r n={n}: {ms_out[f'K10r n={n}'][0]:.2f} ms "
        f"(device {_fmt_ms(dev_out[f'K10r n={n}'])}); K10r recompute pass n={LARGE_RC_N}: "
        f"{panels['pass_ms']:.2f} ms, {key}: {panels['ms']:.4f} ms")


def _compare_walls(gp, gnp, torch, out):
    """--compare's streamed REML walls through the one-card mesh on
    bench_large_n's workload at p0 (phase 3d's (a) and (d)): one ff
    value+grad at n = LARGE_N (the cutover forced there) and one recompute
    value+grad at n = LARGE_RC_N (the dispatcher's own choice), into out."""
    from gpmp_tpu_torch import parallel
    from gpmp_tpu_torch.parallel import streamed as st

    gp.config.set_device(DEVICE)
    mesh = parallel.make_mesh(1, axis_name="shard")
    # the resident f64 value+grad at RESIDENT_WALL_SIZES through the mesh
    # (phase 3e's workload at p0; its refined panels) and the mixed engine's
    # REML value+grad rate at n = SLICE_N (phase 4b's)
    gp.config.set_chol_engine("f64")
    for n, calls in RESIDENT_WALL_SIZES.items():
        xi, zi, p0 = _large_data(n)
        vg, _ = _criterion(gp, _large_model(gp, gnp), xi, zi, mesh)
        vg(p0)
        walls = [_timed(torch, lambda: vg(p0 + 1e-3 * (i + 1)))[1] for i in range(calls)]
        out["walls_s"][f"resident f64 value+grad n={n}"] = walls
        say(f"[compare] resident f64 value+grad n={n}: {walls} s")
        del vg
    gp.config.set_chol_engine("mixed")
    rate = _noisy_evals_per_s(gp, gnp, torch, SLICE_N, NOISY_EVAL_SIZES[0][1])
    out["walls_s"][f"mixed REML value+grad evals/s n={SLICE_N}"] = rate
    say(f"[compare] mixed value+grad n={SLICE_N}: {rate:.1f} evals/s")
    model = _large_model(gp, gnp)
    for n, tag, cutover in ((LARGE_N, "ff", LARGE_N), (LARGE_RC_N, "recompute", None)):
        xi, zi, p0 = _large_data(n)
        with _Patched(st, STREAM_MIN_N=cutover):
            check(st.choose_mode(n) == tag, f"--compare: the stream does not pick {tag} at n={n}")
            vg, _ = _criterion(gp, model, xi, zi, mesh)
            (v, _g), wall = _timed(torch, lambda: vg(p0))
        out["walls_s"][f"{tag} value+grad n={n}"] = wall
        say(f"[compare] {tag} value+grad n={n}: {wall:.3f} s, REML {v!r}")
        del vg
    gp.config.set_chol_engine("auto")


def compare_main(root, only=None):
    """``python3 chip_smoke.py --compare ROOT``: K8s's, K8t's, K8r's and K3's
    times and refined_cholesky's wall per panel (_compare_k8), K5's and K6's
    (_compare_k5_k6), K7's (_compare_k7), K1d's and its pullback's
    (_k1d_times, with digests of D and of two pullbacks), phases 4b's
    and 4f's times of K4 (K4_SIZES and n = RESIDENT_N), K4s, K9s (f64 and
    f32), and K10m's and K10r's at phase 4d's shapes (_compare_streamed) of
    the gpmp_tpu_torch package under ROOT (this checkout, or another one
    unpacked beside it, e.g. a parent commit from git archive), through the
    same helpers, with digests of K8s's, K8t's, K8r's, K3's, K5's, K6's, K9u's (first
    panel), K9s's, K4's and K4s's, K10m's and K10r's outputs, and the walls
    (_compare_walls): the resident f64 value+grad at RESIDENT_WALL_SIZES, the
    mixed value+grad rate at n = SLICE_N, and the streamed REML of phase 3d.
    Run it for two trees in turns (parent, change, change, parent) in one
    call to compare them on one card; the last line is one JSON object.
    K1's and K2's times come first (_gram_times, with digests of K and of
    two pullbacks), with the built-in covariance's REML value+grad rates at
    EVAL_SIZES.  With ``only`` "k1d" or "gram", K1d's and its pullback's or
    K1's and K2's times (and those rates) alone."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import gpmp_tpu_torch as gp
    import gpmp_tpu_torch.num as gnp
    from gpmp_tpu_torch.ops import _build as build
    from gpmp_tpu_torch.ops import chol as ochol
    from gpmp_tpu_torch.ops import distance, gram, mixed, refine

    check(os.path.abspath(build.__file__).startswith(root + os.sep),
          f"gpmp_tpu_torch was not imported from {root}")
    say(_card_line())
    t0 = time.perf_counter()
    build.load()
    out = {"root": root, "build_s": time.perf_counter() - t0, "ms (kernel, plain, library)": {},
           "device_ms": {}, "host_issue_us": {}, "digest": {}, "walls_s": {}}
    if only != "k1d":
        _gram_times(torch, gram, "compare", out, plain=False)
        for n, reps in EVAL_SIZES:  # the built-in covariance's REML through K1/K2
            out["walls_s"][f"REML value+grad evals/s n={n}"] = _evals_per_s(gp, gnp, torch, n,
                                                                            reps)
    if only is not None:
        if only == "k1d":
            _k1d_times(torch, distance, "compare", out, plain=False)
        say(json.dumps(out))
        return
    _compare_k8(torch, gram, mixed, refine, out)
    _compare_k5_k6(torch, gram, mixed, out)
    _compare_k7(torch, gram, mixed, out)
    _k1d_times(torch, distance, "compare", out, plain=False)
    for n in K4_SIZES:
        ms, dev, _bound = _k4_times(torch, gram, mixed, n, "compare", out["digest"])
        out["ms (kernel, plain, library)"][f"K4 n={n}"], out["device_ms"][f"K4 n={n}"] = ms, dev
    K = _large_gram(gp, gnp, RESIDENT_N)
    times, _bounds, device = _slab_kernel_times(torch, mixed, ochol, K, "compare", out["digest"])
    for tag in times:
        key = (f"K4 n={RESIDENT_N}" if tag == "K4" else tag if tag.startswith(("K4", "K6"))
               else f"K9s {tag}")
        out["ms (kernel, plain, library)"][key], out["device_ms"][key] = times[tag], device[tag]
    W = K.clone()
    ochol.trailing_update_cuda(W, 0, CHOL_BLOCK)
    out["digest"]["K9u"] = _digest(W)
    del W, K
    _compare_streamed(gp, gnp, torch, out)
    _compare_walls(gp, gnp, torch, out)
    say(json.dumps(out))


def _card_line():
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    sys.path.insert(0, HERE)
    try:
        import gpmp_tpu_torch as gp
        import gpmp_tpu_torch.kernel  # noqa: F401
        import gpmp_tpu_torch.misc  # noqa: F401
        import gpmp_tpu_torch.num as gnp
        from gpmp_tpu_torch.ops import _build as build
        from gpmp_tpu_torch.ops import chol as ochol
        from gpmp_tpu_torch.ops import distance, gram, mixed, refine
        from gpmp_tpu_torch.ops import streamed as ops
        from gpmp_tpu_torch.parallel import likelihood as plik
        from gpmp_tpu_torch.parallel import streamed as st
    except ImportError as exc:
        fail(f"cannot import gpmp_tpu_torch next to this script: {exc}")
    check("jax" not in sys.modules, "jax was imported")

    t_start = time.perf_counter()
    card = phase_device_and_build(torch, build)
    main_abs = phase_kernels_vs_plain(torch, gram)
    main_abs.update(phase_mixed_kernels_vs_plain(torch, gram, mixed))
    main_abs.update(phase_new_kernels_vs_plain(torch, gram, distance, mixed, refine))
    phase_streamed_kernels_vs_plain(torch, gram, mixed, ops)
    main_abs.update(phase_resident_kernels_vs_plain(gp, gnp, torch, gram, refine, ochol))
    main_abs.update(phase_group_kernels_vs_plain(gp, gnp, torch, gram, mixed, ochol))
    _errs, large_abs, large_times, large_bounds, large_device = phase_streamed_large(
        gp, gnp, torch, mixed, ops, st, plik)
    launches, main_data, t_first, fit = phase_main_path(gp, gnp, gram, torch)
    diag_launches, diag_walls, diag_errs = phase_diagnosis(
        gp, gnp, gram, distance, mixed, refine, torch, main_data, fit)
    remap_launches, remap_walls, remap_errs, dp_ref = phase_remap(
        gp, gnp, gram, distance, mixed, refine, torch, card)
    post_launches, post_walls, post_errs, post_rates = phase_posterior(
        gp, gnp, gram, distance, mixed, refine, torch, card)
    pop_launches, pop_abs, pop_times, pop_bounds, pop_summary = phase_population(
        gp, gnp, gram, distance, mixed, refine, torch, card)
    slice_launches, slice_data, t_slice_first, k6 = phase_slice(
        gp, gnp, gram, distance, mixed, refine, torch)
    launches.update(slice_launches)
    paths_launches, t_paths_first, xt_paths = phase_paths(
        gp, gnp, gram, distance, mixed, refine, torch, slice_data)
    launches["K8s"] = paths_launches["K8s"]
    large_launches, large_walls, large_mem, large_info = phase_large_n(
        gp, gnp, torch, gram, distance, mixed, refine, ops, st)
    launches.update({k: large_launches[k] for k in ("K6", "K10b", "K10r", "K10m", "K10t")})
    res_launches, res_per_call, res_walls, res_mem, res_ref = phase_resident(
        gp, gnp, torch, gram, distance, mixed, refine, ochol, st)
    launches.update(res_launches)
    repair_errs = phase_repairs(gp, gnp, torch)
    grp_launches, grp_walls, grp_mem, grp_comm = phase_group_nccl(
        gp, gnp, torch, gram, distance, mixed, refine, ochol, res_ref)
    launches["K9s"] = grp_launches["K9s"]
    launches["K9s f32"] = grp_launches["K9s f32"]
    launches["K4s"] = grp_launches["K4s"]
    gloo_errs = phase_group_gloo(gp, gnp, torch, dp_ref)
    times, rates, t_warm = phase_times(gp, gnp, gram, torch, main_data)
    mtimes, mrates, mem, t_slice_warm, k3_extra = phase_mixed_times(gp, gnp, gram, mixed, torch,
                                                                    slice_data)
    ntimes, bounds, t_paths_warm, device_ms = phase_new_times(gp, gnp, gram, distance, mixed, refine,
                                                   torch, xt_paths, slice_data, t_paths_first)
    library = {k: v[2] for k, v in (*mtimes.items(), *ntimes.items())}
    times.update({k: v[:2] for k, v in (*mtimes.items(), *ntimes.items())})
    res_times, res_bounds, res_device, res_factor, res_host = phase_resident_times(
        gp, gnp, torch, gram, refine, ochol, res_walls)
    grp_times, grp_bounds, grp_device = phase_group_times(gp, gnp, torch, gram, mixed,
                                                          ochol)
    profile = phase_profile(gp, gnp, torch)
    profile.update(phase_profile_large(gp, gnp, torch))
    check("jax" not in sys.modules, "jax was imported")
    # the streamed engine's kernels (K6 included) at the large-n path's shapes
    main_abs.update(large_abs)
    library.update({k: v[2] for k, v in large_times.items()})
    times.update({k: v[:2] for k, v in large_times.items()})
    bounds.update(large_bounds)
    device_ms.update({f"{k} n={LARGE_N}": v for k, v in large_device.items()})
    library.update({k: v[2] for k, v in res_times.items()})
    times.update({k: v[:2] for k, v in res_times.items()})
    bounds.update(res_bounds)
    device_ms.update({f"{k} resident": v for k, v in res_device.items()})
    library.update({k: v[2] for k, v in grp_times.items()})
    times.update({k: v[:2] for k, v in grp_times.items()})
    bounds.update(grp_bounds)
    device_ms.update({f"{k} n={RESIDENT_N} R=1": v for k, v in grp_device.items()})
    launches.update(pop_launches)
    main_abs.update(pop_abs)
    times.update(pop_times)
    bounds.update(pop_bounds)

    say(json.dumps({
        "card": card,
        "fit_predict_s": {"first": t_first, "warm": t_warm},
        "diagnosis_3i": {"wall_s": diag_walls, "launches": diag_launches,
                         "rel_err_vs_cpu": diag_errs},
        "remap_3j": {"walls": remap_walls, "launches": remap_launches, "errs": remap_errs},
        "posterior_3k": {"walls": post_walls, "launches": post_launches, "errs": post_errs,
                         "rates": post_rates},
        "population_3l": pop_summary,
        "reml_value_grad_evals_per_s": {f"n={n} {k}": v for (n, k), v in rates.items()},
        "noisy_fit_loo_predict_s": {"mixed first": t_slice_first, "mixed warm": t_slice_warm},
        "noisy_reml_value_grad_evals_per_s": {f"n={n} {e}": v for (n, e), v in mrates.items()},
        "max_memory_allocated_bytes_n8192": mem,
        "k6_launches_n1000": k6,
        "k3": k3_extra,
        "large_n": {"n": LARGE_N, "wall_s": large_walls, "fit_nfev": int(large_info.nfev),
                    "fit_reml": [float(large_info.history_criterion[0]), float(large_info.fun)],
                    "peak_rise_bytes": {f"{w} n={nn}": b for (w, nn), b in large_mem.items()},
                    "launches_per_value_grad": large_launches},
        "resident": {"n": RESIDENT_N, "wall_s": res_walls, "factor_s": res_factor,
                     "host_issue_us": res_host,
                     "launches_per_call": res_per_call,
                     "peak_rise_units": {k: v / (4 * RESIDENT_N ** 2) for k, v in res_mem.items()}},
        "group": {"n": RESIDENT_N, "wall_s": grp_walls, "launches": grp_launches,
                  "collectives_per_factor": grp_comm,
                  "peak_rise_units": {k: v / (4 * (RESIDENT_BIG_N if "51200" in k
                                                   else RESIDENT_N) ** 2)
                                      for k, v in grp_mem.items()},
                  "gloo_rel_err": gloo_errs},
        "repairs_rel_err": repair_errs,
        "device_ms_per_call_n1000": device_ms,
        "sample_paths_nt8192_1024_s": {f"{e} {w}": v for w, d in (("first", t_paths_first),
                                                                  ("warm", t_paths_warm))
                                       for e, v in d.items()},
        "profile_ms_per_eval": {e: {"wall": v["wall_ms"], "device": v["device_ms"],
                                    "groups": v["groups"]} for e, v in profile.items()},
        "total_s": time.perf_counter() - t_start,
    }))
    gram_src, mixed_src = "gpmp_tpu_torch/csrc/matern_gram.cu", "gpmp_tpu_torch/csrc/mixed.cu"
    dist_src, stream_src = "gpmp_tpu_torch/csrc/distance.cu", "gpmp_tpu_torch/csrc/streamed.cu"
    chol_src, syrk_src = "gpmp_tpu_torch/csrc/chol.cu", "gpmp_tpu_torch/csrc/syrk_f64.cuh"
    res_src, syrk32_src = "gpmp_tpu_torch/csrc/residual.cu", "gpmp_tpu_torch/csrc/syrk_f32.cu"
    rows = [
        ("K1", "matern_gram", gram_src, "gpmp_tpu/kernel/matern.py:69"),
        ("K2", "matern_gram_pullback", gram_src, "gpmp_tpu/parallel/likelihood.py:225"),
        ("K3", "residual", mixed_src, "gpmp_tpu/ops/mixed.py:173"),
        ("K4", "factorization_residual", res_src, "gpmp_tpu/ops/mixed.py:191"),
        ("K4s", "factorization_residual_slab", res_src, "gpmp_tpu/ops/mixed.py:191"),
        ("K5", "diag_block_inv", mixed_src, "gpmp_tpu/ops/mixed.py:94"),
        ("K7", "trace_sums+series_sums", mixed_src, "gpmp_tpu/ops/mixed.py:378"),
        ("K7b", "loo_diag_series", mixed_src, "gpmp_tpu/ops/mixed.py:637"),
        ("K1d", "scaled_distance", dist_src, "gpmp_tpu/num/__init__.py:428"),
        ("K1d pullback", "scaled_distance_pullback", dist_src, "gpmp_tpu/num/__init__.py:389"),
        ("K1m", "maternp_kernel", gram_src, "gpmp_tpu/kernel/matern.py:49"),
        ("K1m backward", "maternp_kernel_backward", gram_src, "gpmp_tpu/kernel/matern.py:49"),
        ("K8s", "sampling_residual", res_src, "gpmp_tpu/ops/refine.py:114"),
        ("K6", "precond_apply", mixed_src, "gpmp_tpu/ops/mixed.py:236"),
        ("K10b", "split_rows", stream_src, "gpmp_tpu/parallel/streamed.py:259"),
        ("K10r", "streamed_residual_ff", res_src, "gpmp_tpu/parallel/streamed.py:322"),
        ("K10m", "ff_residual", mixed_src, "gpmp_tpu/parallel/streamed.py:481"),
        ("K10t", "h_traces", stream_src, "gpmp_tpu/parallel/streamed.py:394"),
        ("K8r", "refine_residual", chol_src, "gpmp_tpu/ops/refine.py:75"),
        ("K8t", "tri_product", chol_src, "gpmp_tpu/ops/refine.py:47"),
        ("K9u", "trailing_update", syrk_src, "gpmp_tpu/parallel/chol.py:158"),
        ("K9s", "slab_update", syrk_src, "gpmp_tpu/parallel/chol.py:270"),
        ("K9s f32", "slab_update f32", syrk32_src, "gpmp_tpu/parallel/chol.py:270"),
        ("K9m", "murray_phi+symmetrize", chol_src, "gpmp_tpu/parallel/chol.py:460"),
        ("K1p", "matern_gram_population", gram_src, "gpmp_tpu/mcmc/param_posterior.py:399"),
        ("K2p", "matern_gram_population_pullback", gram_src, "gpmp_tpu/mcmc/svgd.py:166"),
    ]
    say(json.dumps({"kernels": [
        {"name": f"{key} {name}", "route": "cuda", "source": src, "replaces": where,
         "launches": launches[key], "max_abs_err": main_abs[key], "ms": times[key][0],
         "plain_ms": times[key][1], "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
         "library_ms": library.get(key)}
        for key, name, src, where in rows
    ]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if (len(sys.argv) in (3, 4) and sys.argv[1] == "--compare"
            and sys.argv[3:] in ([], ["--k1d"], ["--gram"])):
        compare_main(sys.argv[2], only=sys.argv[3][2:] if len(sys.argv) == 4 else None)
    else:
        main()
