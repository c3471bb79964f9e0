"""Drive the PyTorch port (gogp_torch) on one CUDA card and check it.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card and
the CUDA toolkit:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``gogp_torch/csrc`` (nvcc, sm_90a, one
process per source) and then runs these phases, each printing JSON lines:

1. device   - torch's device name, nvidia-smi's name and power limit, TF32.
2. build    - the kernels' build time and ptxas resource lines; beside
              it (nvcc in its own processes) a thread pays the host's
              first-call costs of a Laplace fit on the CPU at n = 16.
3. kernels  - each kernel against its plain PyTorch version on the card, in
              f32, at the shapes each of the three paths below gives it:
              errors and times (CUDA events after a warmup), beside the
              least time the card could take (bytes over 3.35 TB/s or FLOPs
              over 67 TFLOP/s, the larger) and one PyTorch library call
              where one computes the same function.  Serving: K1 on its
              n = 4096 covariance (K2 on one tile where the gate sends
              n = 4096 to the stepwise driver), the gate's solver (K4 as
              measured: K3 below n = 1024) both ways and K5 on the factor.
              Train: K1 at n = 1536 (and at 1024, 1792, 2048, 2560, 3072,
              also timed against the stepwise driver and cholesky_ex, with
              a "gates" line of K1's gate beside these times), the solver
              both ways and K5 on K1's n = 1536 factor.  Large: K2 on one
              tile, K3 and K4 both ways and K5 on the n = 16384 factor; K3
              and K4 also at n = 1024, 1536, 2048, 4096 and 8192 on the same
              factors, and a "gates" line with the gate between them beside
              these times.  K6, which no path calls, on one tile.
   k5       - K5 at each path's count of tiles (12, 32, 128) and at 200, one
              CTA a tile and split over 2 and 4 by block column, against its
              plain version, with a "gates" line of the fastest split at
              each count; K5 on ill-conditioned GP tiles against f64.
4. slice    - serving: the GP problem of ``bench.py``, n = 4096 sorted
              uniform inputs on [0, 100], y = sin(x/3) + 0.1 N(0, 1) from
              numpy seed 0, rbf.scaled() + uniform_noise at log-theta 0,
              forecast at m = 1024 points.  absorb, lml_from_posterior, lml,
              gp_observe, predict_from_posterior and predict_y_from_posterior
              run once through the front door in f32 (the kernel path), and
              are held against the same calls on the plain path in f64 on
              the card.
5. launches - the kernels' launch counts during that one run (K1, or K2
              where the gate sends n = 4096 to the stepwise driver, the
              gate's solver and K5 must each be launched, no transpose
              solve), and wall times of
              the kernel path and of the plain f32 path.
6. train    - training, then serving: the reference's barebones study
              (matern32.scaled() + uniform_noise.scaled_by(0.01)) on the same
              generator at n = 1536, y normalised, from v0 = 0.  The value
              and gradient of gp_observe at v0, Adam for 50 steps, LBFGS
              (at most 100 iterations, threshold 1e-4), then gp_posterior and
              the forecast at m = 512 points at the LBFGS optimum.  The kernel
              path in f32 is held against the plain path in f64 on the card
              (the forecast at the kernel path's own optimum on both);
              K1, the gate's solver both ways and K5 must each be launched,
              K2 not.  Wall
              time per value-and-gradient step and per fit on the kernel path
              and on the plain f32 path.

7. large    - the exact GP at large n: the JAX package's large-n problem
              (benchmarks/tpu_round2.py:76-81), rbf.scaled() + uniform_noise,
              n = 16384 sorted uniform inputs on [0, 400], y = sin(x/3) +
              0.1 N(0, 1) from numpy seed 0, v0 = 0.  The value and gradient
              of gp_observe at v0, Adam for 3 steps, then gp_posterior and
              the forecast at m = 1024 points at Adam's v, held against the
              plain path in f64 on the card; the launch counts of each stage
              (K2 per factorization, the gate's solver, K4 as measured, both
              ways per gradient, none of the other's or of K1, K5 in the
              forecast); wall time of a value-and-gradient step on
              the kernel path and on the plain f32 path; the factorization
              against cuSOLVER; peak device memory; the precision rescue's
              host read, and one step at "tensorfloat32", where it engages.

8. bayes    - Bayesian hyperparameter inference: the hyperpriors study
              (gogp_tpu/tutorial/hyperpriors.py, n = 44 points, 6
              log-thetas) under ChEES-HMC at the protocol of
              benchmarks/ess_nuts.py:729 (64 chains, seed 0) cut to 128
              warmup and 128 sampling transitions.  K7 against its plain version
              at the study's covariances of 16, 64 and 256 positions and, 64
              matrices each, at n = 32, 64, 96 and K7's n limit, with a
              "gates" line of the limit beside K7's and the library's
              times; the value and gradient of the log-joint
              ``bayes.build_logjoint`` gives the sampler (K7 route, f32)
              against the plain route's in f64 at 256 positions; the main
              path, ``bayes.main(["hyperpriors", "--engine", "chees",
              "--chains", "64", "--seed", "0", "--warmup", "128",
              "--samples", "8192", "selfcheck"])`` in process on the K7
              route, whose K7 launches must equal its log-joint's calls
              (counted by wrapping ``chees.run_chees``), with 50 finite
              forecast rows; one transition from its sampler's final state
              on both routes with the same draws; the same command line
              under force_plain at 128 + 128 transitions (in a whole run in
              a worker beside this process's; none of its calls
              may launch K7).

9. samplers - the other engines and options of the command line, each
              through ``bayes.main`` in process on the card's default
              route with its run function wrapped to count the
              log-joint's calls and its launch counts set to 0 just
              before.  Each in a worker process (5 at a time, started
              before the bayes phase's runs and running beside them and the
              evaluate phase, with the bayes phase's plain-route run and
              the exact leg's sampler): on hyperpriors NUTS (the JAX package's default command) and HMC at
              the JAX command line's defaults (4 chains, 400 + 512
              transitions, trees up to depth 10, trajectories up to 1024
              steps; NUTS at 200 warmup transitions); PT-ChEES at its
              defaults (4 ladders x 8 rungs, 400 + 128 sweeps, one
              (32, 44, 44) K7 batch a leapfrog step); GHMC at its defaults
              (1600 + 2048 one-step transitions of 4 chains); ChEES with
              --pops 4 and with --race 4 at the bayes phase's 64 chains and
              128 + 128 (the race's probe 4 arms x 64 chains, 32
              transitions); tempering.run_pt_nuts (no command line runs it
              on one device) at 8 replicas, depth 6, 128 + 128 sweeps,
              through ``pt_nuts_main``; ADVI on hyperpriors (1600 steps
              of 8 draws), HMC (cut to 20 + 32 transitions) and ADVI on
              anynoise, full-rank ADVI and SMC (512 particles) on
              barebones.  NUTS's trees (leapfrog steps
              per transition, depths and their spread across chains,
              divergences); for every MCMC run ms per transition and per
              value and gradient, ESS, ESS/s and R-hat; each NUTS and HMC
              chain's step size and mean; PT's round trips, swap rate,
              pair rejections, ladder and each ladder's cold-chain mean of
              the period coordinate v[4]; GHMC's step, damping and
              acceptance; the race's candidates, scores, costs and winner;
              each population's step and trajectory.  One NUTS (its state
              on the host, as bayes keeps it) and one HMC transition of 64
              chains from one state, one PT-ChEES sweep of 32 chains from
              the pt_chees run's final state (also on the plain route in
              f64: a chain on which f32 itself parts from f64 is
              reported, not held) and one GHMC transition of 64 chains,
              each with the same draws on the K7 route and under
              force_plain; NUTS with its tree state on the card and
              on the host, in pairs of alternating order; K7 once per
              log-joint call on the theta-only studies (none on anynoise);
              50 finite forecast rows and the theta-mean line from each
              run; K7 against its plain version at each run's batch (4, 8,
              32, 64, 256 x 44 x 44; 8, 512 x 20 x 20).  The checks that
              read the workers' runs or time the card (the transitions,
              the placement, K7) wait for the workers, after evaluate.

10. evaluate - the reference's main entry point, the rolling forecast
              (``tutorial.evaluate``): the five studies' selfcheck data,
              LBFGS 200 iterations (the fixtures' configuration), seed 0,
              batched in f32 on the card's default route (K7 with one mask
              per prefix for barebones, hyperpriors and events) against
              float64 on the card; barebones on bench.py's generator at n =
              128, K7's widest, 127 prefix fits in one (127, 128, 128) K7
              batch a step, Adam 200 and LBFGS 200 on the K7 route and
              under force_plain; a sequential run against the batched one;
              walls, ms per batched value and gradient on both routes,
              iterations, stalls; K7 once per batched value and gradient
              (none under force_plain); K7 at 127 x 128 x 128 and 43 x 44 x
              44 against its plain version, once the samplers' workers are
              done.

11. serve    - (run after large, before the samplers' workers start, like
              classify) the serving caches on the slice's problem (n = 4096,
              m = 1024): fit_serving, serve_predict and serve_predict_y;
              serve_predict_cov and serve_sample (4 draws on fixed normals,
              jitter 1e-4) at 256 points; compile_mixture of 8 log-theta
              draws 0.1 N(0, 1) (numpy seed 1) and serve_predict_mixture
              against gp.core.predict_mixture; absorb_stream of the 4096
              points in 32 appends of 128 into a capacity-4096 posterior
              against one absorb; loo_from_posterior.  The f32 kernel path
              against the f64 plain path on the card; sigma's error at
              ACCURATE_PRECISION ("float32") and at "tensorfloat32"; wall per
              request batch (median of 5) of serve_predict, of
              predict_from_posterior on the kernel path (one blocked TRSM
              per request) and on the plain path; ms per append; K1 and K5
              launches (K1 in every absorb, K5 in every tril_inv and append,
              no other kernel) and K1 and K5 at this path's shapes.
12. classify - GP classification on the slice's inputs with labels
              1[sin(x/3) + 0.3 N(0, 1) > 0] (numpy seed 0), rbf.scaled() at
              log-theta 0, bernoulli_logit: laplace_fit with its Newton
              iterations, laplace_lml's value and gradient,
              compile_laplace_serving and serve_predict_prob at m = 1024
              against laplace_predict_prob; ep_fit with its sweeps, ep_lml's
              value and gradient, compile_ep_serving; each call's wall (a
              first and a warm run), against the f64 plain path on the
              card; K1 and K5 launches, each count the one the Newton
              iterations and EP sweeps of the run give, K1 on B = I + sW K
              sW and K5 on its factor's tiles.  Then the classify study
              (n = 40, no kernel) for -e laplace, ep and ess through its
              command line (f32) and in f64 on the card: walls and the
              largest |dp_hat|; ess's NaN rows where the f32 factor fails,
              as in the JAX package, and its other rows held to rounding
              or, where a slice decision flipped, to its Monte Carlo error.

13. sparse   - (run after classify, before the samplers' workers start)
              sparse GPs at the JAX package's own full width
              (benchmarks/sparse_tpu.py:56-72): rbf.scaled() + uniform_noise
              at log-theta 0, n = 65536 sorted inputs uniform on [0, 1000],
              y = sin(x/3) + 0.1 N(0, 1) (numpy seed 0), m = 1024 inducing
              inputs Z = x[::64], minibatch x[:4096], 4096 test points.
              make_sgpr_logp's value and gradient over [log theta | Z] (1027
              coordinates), 50 Adam steps on it, sgpr_fit and sgpr_predict at
              Adam's v; svgp_elbo's value and gradient on the minibatch
              rescaled to n, Gaussian and Gauss-Hermite (laplace_noise,
              order 20); one natural-gradient step at gamma = 1 on the whole
              batch from the KL-zero start, its ELBO against
              svgp_optimal_state's (both f32); svgp_fit (100 steps) and
              svgp_fit_natgrad (50), whose ELBO traces must rise.  The f32
              kernel path against the f64 plain path on the card; each
              stage's K1 and K5 launches held to the code's count; walls,
              SGPR's value and gradient beside its FLOP bound, its device
              busy time and peak memory; K1 on B = I + A A^T (also against
              the stepwise driver) and K5 on its factor's 8 tiles.
14. surface  - the model surface at the slice's n = 4096: the Student-t
              process (make_tp_logp's value and gradient at nu = 3,
              tp_absorb and tp_predict at m = 1024), gp_observe's value and
              gradient on deep(rbf.scaled(), 1, hidden=()) with identity
              weights (held against rbf.scaled()'s), on the default (8, 8)
              deep kernel with random weights, and on icm(rbf.scaled(), 2)
              over two 2048-point tasks; against the f64 plain path, with
              each stage's launches, walls and peak memory, and K1, the
              solves and K5 at this path's shapes.
15. pathwise - (run after surface, before the samplers' workers start, like
              bo and search) pathwise posterior sampling on the JAX
              package's pathwise problem (benchmarks/pathwise_ski_tpu.py:68):
              the slice's data at n = 4096 under rbf.scaled() at theta_simil
              [1, 2] + uniform_noise at [0.1]; absorb, sample_paths (16 paths,
              2048 features) and eval_paths at m = 4096 points,
              thompson_path_scores there, 16 exact joint draws there
              (serve_sample) for comparison, the mean of 2048 paths at 256
              points against the posterior mean (a Monte Carlo bound);
              sample_paths_laplace on the classify problem, paths of
              icm(rbf.scaled(), 2) on the surface phase's two tasks and
              sample_paths_svgp on the sparse phase's fitted SVGP state, each
              with its mean check.  The f32 kernel path against the f64 plain
              path on the card with the same draws; each stage's K1 and K5
              launches; walls (median of 5) and peak memory of the paths
              against the exact draws; the periodic kernel's spectral weights
              in f32; K1 on the covariance and K5 on its factor's 32 tiles.
16. bo       - Bayesian optimization at capacity 1024 on a 64 x 64 grid of
              the Branin function (negated, scaled): bo_run with EI, UCB and
              exact Thompson (16 + 1008 iterations), batch Thompson (32
              points, 31 rounds of q = 32), thompson_path_optimize (8
              restarts, 100 steps) on its final state; each in f32 on the
              kernel path and in f64 on the plain path with the same draws.
              Each streamed posterior against one f64 absorb of its points,
              the first step's scores of each kind, each run's gap to the
              grid's maximum and the step at which the f32 and f64 runs
              part, ms per iteration, K5's launches (held to the code's
              count) and K5 on the final factor's 8 tiles.
17. search   - greedy kernel search on tests/test_search.py's trend plus
              periodic data at n = 128: search at its defaults (BIC) in f32
              on the K7 route (one (8, 128, 128) K7 batch an Adam step) and
              in f64 on the plain route from the same draws (in a worker
              process beside this one's searches): the winners, the
              round-0 fits, the winner's LML at the same v on both routes
              (its log-thetas reported); then with score "loo" on the K7
              route; K7 launches equal to each candidate's Adam steps, walls
              per candidate and per search, K7 on the winner's restart
              batch.

18. iterative - (run after search, before the samplers' workers start, like
              toeplitz, ski and large_n_bayes) the iterative engine on the
              large path's problem at n = 16384: lml_iterative's value and
              gradient at the JAX defaults (16 probes, CG 100, Lanczos 32) at
              precond_rank 0 and 32, in f32 against f64 on the same probes
              and against the exact lml (f64 plain); lml_iterative_matfree
              (panel 2048) against lml_iterative on the same probes;
              predict_iterative at m = 1024 against the exact predict;
              walls against the exact path's value and gradient (K2, the
              gate's solves and K5, held to the code's count), each CG
              solve's iterations and final relative residual, the
              preconditioner's pivots in f32 and f64; then one value and
              gradient of lml_iterative_matfree at n = 65536 (panel 2048,
              precond_rank 32) on the ski phase's problem, its wall and
              peak memory (held under 6 GiB), beside lml_ski's value.
19. toeplitz - lml_toeplitz at n = 16384 on a regular grid over [0, 400]
              (y = sin(x/3) + 0.1 N(0, 1)) at ranks 0 and 32, f32 against
              f64, against lml_iterative on the same probes and against the
              exact lml; predict_toeplitz against the exact predict; then
              one value and gradient at n = 2^20
              (benchmarks/toeplitz_tpu.py's top size): walls, CG iterations,
              peak memory.
20. ski      - SKI on bench_ski's problem (benchmarks/pathwise_ski_tpu.py:
              120-168): n = 65536 sorted uniform inputs on [0, 1000], y =
              sin(x/20) + 0.1 N(0, 1), rbf.scaled() at [1, 8] +
              uniform_noise at [0.1], grid 4096, 8 probes, CG 60, Lanczos
              24: lml_ski's value and gradient with each W^T form
              (scatter, sorted, matmul) in f32 against f64 and against each
              other on the same probes, matrix-free beside them;
              predict_ski at m = 1024 against f64 and against
              predict_iterative at x[::4]; in 2-D one value and gradient at
              n = 262144 on a 512 x 512 grid (matern32.scaled() at [1, 5]),
              f32 against f64 and the exact lml at n = 16384 on 64 x 64;
              sample_paths_ski at n = 131072 (16 paths, 2048 features, grid
              8192, "sorted", CG 100) evaluated at 4096 points, f32 against
              f64 on the same draws, the paths' mean against predict_ski's
              mu within a Monte Carlo bound.  At these CG budgets f32 and
              f64 part (reported); f32 is held by each operator piece
              against f64 on one vector at each size, and by the 2-D
              value, predict_ski and the paths (both forms) again with CG
              run to convergence.
21. large_n_bayes - ChEES on the SKI surrogate (benchmarks/large_n_bayes.py
              --ski): bench.py's noisy sine at n = 65536 on [0, 100], N(0,
              1) priors on the log-thetas, grid 4096, 16 probes, CG 100,
              Lanczos 32, one probe draw for the run; one batched value and
              gradient of 8 chains timed, the MLE warm start (Adam, 10
              chunks of 20 steps at 0.05), then 8 chains in lockstep for the
              cut's transitions: ms per value and gradient, acceptance, step
              size, ESS, R-hat, ESS/s, finite_frac.
              These four phases hold every engine call's launches of the
              port's kernels to 0.  They run alone (beside the samplers'
              workers they and the workers took about twice as long); the
              ski phase's f64 reference of the paths' mean is predict_ski's
              mu from its CG on y alone (without the variance's columns).
22. large_n_bayes_exact - the exact leg of benchmarks/large_n_bayes.py (its
              default, :45-63, 132-240): bench.py's noisy sine at n = 1024,
              8 chains, N(0, 1) priors, the batched log-joint
              ``torch.func.vmap`` of gp_observe plus the priors, as
              tutorial/bayes.py builds one, on the batched route (the
              library's batched Cholesky, one K5 launch over the 64 diagonal
              tiles, K4 over the batch both ways).  With no worker beside
              it: the MLE warm start (Adam 300 at 0.05 under force_plain),
              K2, K4 both ways and K5 against their plain versions at this
              path's shapes, one batched value and gradient of the 8 chains
              on the kernel route and under force_plain at "tensorfloat32"
              and "float32" (walls; errors against f64 on the plain route;
              the launches of one call, K5 and K4 once each way).  Then, in
              a whole run in a worker beside the samplers': ChEES (step 0.01,
              trajectory 0.1, spread 0.05, at most 64 steps) for 256 + 256
              transitions at "tensorfloat32", and the predictive mixture of
              the chains' last draws at 256 points (the stepwise driver, K2
              once per block column over the 8 draws, and the blocked TRSM)
              against f64; acceptance, step, ESS, R-hat, the NaN fraction;
              launches held: K5 and K4 both ways once per value and
              gradient, K2 once per block column, no K1.
23. utils    - a ServingPosterior at n = 4096 through utils.save and
              utils.restore, serving bit-identical answers; utils.timed of
              one request batch beside this script's event and wall times
              of it; 100 batches of 4096 rows of a packed 65536-row
              dataset from the native loader and the Python stream,
              bit-identical.
24. parallel - (after the samplers' workers are done, beside nothing)
              the multi-device layer (gogp_torch.parallel,
              ops.distributed).  In this process, on an NCCL group of world
              size 1 (init_multihost on a localhost store): on the large
              path's problem at n = 16384, block 128, the row-sharded
              Cholesky and both solves against cuSOLVER's factor and
              cholesky_solve; make_rowsharded_logp's value and gradient
              (make_rowsharded_value_and_grad, 3 calls) against the
              single-card gp_observe and the f64 plain path; the
              row-sharded iterative form at precond_rank 0 and 32 against
              the dense lml_iterative on the same probes; BASELINE.json's
              fifth configuration, run_smc_large_n with HMC mutation at n =
              16384, cut to 4 particles, one stage, one mutation of 2
              leapfrog steps; K2 held to n / 128 launches a factorization.
              Then four spawned ranks over gloo on the same card (the
              phase fails unless gloo takes CUDA tensors for all_reduce,
              broadcast and all_gather), each case against the same call on
              rank 0 alone (its log-density taking the population in the
              ranks' slabs): the row-sharded LML at n = 4096,
              run_chees_sharded on hyperpriors (64 chains, 16 a rank, 32 +
              32, trajectories cut to 8 steps), run_smc_sharded on
              hyperpriors (64 particles, 3 stages) and both sharded serving
              calls at n = 4096 (8 draws, 2 a rank, 1024 rows); K2, K7, K1
              and K5 launches held per rank; the batch witness: the
              hyperpriors log-joint and gradient at the 64 chains' starting
              positions in one batch against four slabs of 16, per chain,
              held at twice the f32 evaluation's error against f64.  Every run prints its backend
              and world size; K2, K7, K1 and K5 against their plain versions
              at these paths' shapes.  The four ranks then run the graft
              entry's dryrun_multichip(4), which the next phase checks.
25. graft    - the twin of the root __graft_entry__.py
              (gogp_torch.graft_entry): entry's forward step (the
              hyperpriors log-joint and gradient at n = 256) in f32 against
              the same fn in f64 on the card, and its warm ms;
              dryrun_multichip(1) in this process on an NCCL group of one;
              the parallel phase's four ranks' dryrun_multichip(4), its
              deterministic steps (the data-sharded LML, the distributed
              LML, SVGP, serving, the mixture, Laplace, pathwise Thompson,
              SKI) against the same steps on rank 0 alone (a 1x1 mesh);
              every step's outputs finite with the twin's shapes, each
              step's ms, K7 once per log-joint call on the steps that call
              it and never on the others; K7 against its plain version at
              the path's batch (2 x 16 x 16).

With ``--phases a,b,...`` (of kernels, k5, k7, gate, stamps, coldstart,
slice, train, large, serve, classify, sparse, surface, pathwise, bo,
search, iterative, toeplitz, ski, large_n_bayes, large_n_bayes_exact, utils, bayes, samplers, evaluate,
parallel, graft; k7 is the
bayes phase's kernel checks without its sampler runs, gate times K3 against
K4 at n = 24576 to 65536, stamps records the stages of K2, K5 and K4's chain
step and coldstart takes apart a process's first laplace_fit, the last three
in no whole run) only those phases
run, after device and build, and the script ends with ``{"ok": false,
"partial": [...]}`` and exit code 2: for work on one kernel, never a pass.

With ``--profile``, one more phase follows:

26. profile - one serving slice run, one train and one large value-and-gradient
              step, one 64-chain value and gradient of the bayes path and one
              127-prefix value and gradient of the evaluate path, on each
              path under torch.profiler: the device's busy time and idle
              share over the run, and the kernels with the most device time.

Then the peak device memory of each phase, one JSON line with the per-kernel
summary, the nvidia-smi line, and last ``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA card it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import io
import json
import math
import multiprocessing
import pathlib
import statistics
import subprocess
import sys
import threading
import time
import unittest.mock

import numpy as np
import torch

from gogp_torch import (GP, bo, dists, make_gp_logp, masked_value_and_grad, matern32, mle, periodic, rbf, search,
                        uniform_noise)
from gogp_torch.gp import (core, ep, laplace, likelihoods, model_selection, pathwise, serve, sparse, streaming,
                           tprocess)
from gogp_torch.kernels import deep, multioutput
from gogp_torch.models.params import gp_observe, gp_posterior
from gogp_torch.infer import chees, diagnostics, elliptical, ghmc, hmc, nuts, pt_chees, tempering
from gogp_torch.gp import ski as gski
from gogp_torch.ops import _build, fused_gp, iterative, linalg
from gogp_torch.ops import ski as ski_ops
from gogp_torch.ops import toeplitz as toeplitz_ops
from gogp_torch.ops import cholesky_blocked as cb
from gogp_torch.utils import dataio
from gogp_torch import utils as gutils
from gogp_torch.tutorial import bayes, classify, plot
from gogp_torch.tutorial import evaluate as tev
from gogp_torch.tutorial import io as tio

N, M = 4096, 1024
BLOCK = cb.DEFAULT_BLOCK
# Bounds the slice is held to against the f64 plain path on the card (f32
# factor and solves, different summation orders): LML 1e-6 relative, about
# 900 times the 1.1e-9 an H100 measured; mean and std 1e-4 absolute, about 70
# times the 1.4e-6 it measured.
LML_RTOL = 1e-6
PRED_ATOL = 1e-4
# Bound for each kernel against its plain f32 version, relative to the
# largest entry of the plain result (an H100 measured at most 7.1e-7).
KERNEL_RTOL = 1e-5
# K1 against its plain f32 version (cuSOLVER's factor and triangular solves
# of its tiles): the factor of a covariance with noise variance 0.01 carries
# the f32 rounding of K's condition number, about 1e3-1e4.
K1_RTOL = 1e-3
# K1 is held and timed, beside the stepwise driver and cholesky_ex, at these
# n: the measurements that set its gate (cb._FUSED_MAX_N).  Beyond the gate
# the kernel entry is called past the wrapper's range check, here only.
K1_SIZES = (1024, 1536, 1792, 2048, 2560, 3072, 4096)

# The train path: the barebones study at n = 1536, forecast at m = 512.
N_TRAIN, M_TRAIN = 1536, 512
ADAM_STEPS, LBFGS_ITERS, LBFGS_THRESHOLD = 50, 100, 1e-4
# Bounds of the train path (f32 kernel path) against the f64 plain path, 10
# to 30 times what an H100 measured (PERF.md).  The LML at v0 is about 233 on
# a covariance of condition number about 1e4, so its f32 value is off by about
# 1e-3 (4.7e-6 relative) on either f32 path.  The f32 LBFGS stops where the
# LML's f32 rounding hides further gains (a zero step, "stalled"), on a
# stretch where the LML is flat along v[0]: its v lies 0.045 from the f64
# optimum.  So the optimum is held by its LML, not its v: the f64 LML at the
# f32 optimum may lie at most lbfgs_gap_rtol below the f64 optimum's.
TRAIN_BOUNDS = {
    "value_rtol": 1e-4,  # gp_observe at v0, relative (4.7e-6 measured)
    "grad_rtol": 1e-4,  # its gradient, relative to the largest entry (6.0e-6)
    "adam_v_atol": 1e-5,  # v after 50 Adam steps (7.7e-7)
    "lbfgs_lml_rtol": 1e-4,  # the LML each path reports there (3.9e-6)
    "lbfgs_gap_rtol": 1e-4,  # f64 LML at the f32 optimum, below the f64 optimum's (2.8e-6)
    "pred_atol": 5e-3,  # forecast mean and std at the f32 optimum's v (3.2e-4)
}

# The large path: the JAX package's large-n problem (benchmarks/
# tpu_round2.py:76-81) at n = 16384, forecast at m = 1024 points.
N_LARGE, M_LARGE, X_LARGE = 16384, 1024, 400.0
ADAM_LARGE = 3
# Bounds of the large path (f32 kernel path) against the f64 plain path,
# written before its first run on the card.
LARGE_BOUNDS = {
    "value_rtol": 1e-5,  # gp_observe at v0, relative
    "grad_rtol": 1e-3,  # its gradient, relative to the largest entry
    "adam_v_atol": 1e-4,  # v after 3 Adam steps
    "pred_atol": 1e-3,  # forecast mean and std at Adam's v
}
# K3 and K4 against plain and the library call on the same factors at these
# n: the measurements that set the gate between them (cb._TRSV2D_MIN_N).
GATE_SIZES = (1024, 1536, 2048, 4096, 8192, N_LARGE)

# The bayes path: the hyperpriors study under ChEES-HMC at the protocol of
# benchmarks/ess_nuts.py:729 (run_chees_bench: 64 chains, 512 warmup and 512
# sampling transitions, seed 0) but cut to 128 + 128 transitions, through the
# command line on the K7 route; the plain route's run, reported only, at 128
# + 128 too.  A transition took 0.31-0.48 s on an H100 host (PERF.md): the
# protocol's 1024 transitions took about 450 s, which the samplers phase
# needs now.
BAYES_CHAINS, BAYES_WARMUP, BAYES_SAMPLES, BAYES_SEED = 64, 128, 128, 0
PLAIN_WARMUP, PLAIN_SAMPLES = 128, 128
K7_BATCHES = (16, BAYES_CHAINS, 256)
# K7 against the library pair at these n, 64 matrices each: the measurements
# that set its dispatch limit (fused_gp.K7_MAX_N); the largest is the limit.
K7_SIZES = (32, 64, 96, fused_gp.K7_MAX_N)
# Bounds of the bayes path.  Written before its first run on the card:
# k7 1e-2, value 1e-4, gradient 1e-2, transition 1e-2; k7, the gradient and
# the transition then set to about 10 times what an H100 showed (PERF.md).
BAYES_BOUNDS = {
    "k7_rtol": 5e-4,  # K7 against its plain f32 version, relative to the largest entry of L^-1 (4.1e-5)
    "value_rtol": 1e-4,  # the K7 route's log-joint (f32) against the plain route in f64, relative (8.8e-6)
    "grad_rtol": 4e-4,  # its gradient, relative to the largest entry (3.9e-5)
    "transition_atol": 1e-3,  # positions after one 55-step transition on the two f32 routes, same draws (1.1e-4)
    "accept_lo": 0.5, "accept_hi": 0.95,  # the post-warmup mean acceptance of the K7 route's run
}

# The card's peaks for the least time a kernel could take (NVIDIA's H100 SXM
# data sheet): HBM bytes per second, and f32 FLOPs per second outside the
# tensor cores (every kernel here computes in f32 FMA).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# Cycles per second assumed for the spin that event_ms queues calls behind
# (an H100's boost clock; a faster clock only shortens the spin).
SPIN_HZ = 2.0e9

PALLAS = "gogp_tpu/ops/cholesky_pallas.py"
KERNELS = {
    # launch-count key: (name, source, replaces)
    "fused_cholesky_invs": ("K1 fused_cholesky_invs", "gogp_torch/csrc/fused_chol.cu", f"{PALLAS}:456"),
    "chol_inv_tile": ("K2 cholesky_inv_tile", "gogp_torch/csrc/chol_inv_tile.cu", f"{PALLAS}:251"),
    "trsv_lower": ("K3 trsv_lower", "gogp_torch/csrc/trsv.cu", f"{PALLAS}:824"),
    "trsv_lower_t": ("K3 trsv_lower_t", "gogp_torch/csrc/trsv.cu", f"{PALLAS}:850"),
    "trsv2d_lower": ("K4 trsv2d_lower", "gogp_torch/csrc/trsv2d.cu", f"{PALLAS}:946"),
    "trsv2d_lower_t": ("K4 trsv2d_lower_t", "gogp_torch/csrc/trsv2d.cu", f"{PALLAS}:976"),
    "tril_inv_tile": ("K5 tril_inv_tile", "gogp_torch/csrc/tril_inv_tile.cu", f"{PALLAS}:344"),
    "chol_tile": ("K6 cholesky_tile", "gogp_torch/csrc/chol_tile.cu", f"{PALLAS}:161"),
    "fused_gp_linv": ("K7 fused_gp_linv", "gogp_torch/csrc/fused_gp.cu", "gogp_tpu/ops/fused_gp.py:213"),
}


def work(key: str, shape) -> tuple[float, float]:
    """(bytes, FLOPs) a kernel's function needs at ``shape``: each input
    read once, each output written once, only what the function uses (the
    lower triangle of a factor it solves with)."""
    b = BLOCK
    if key == "fused_gp_linv":  # each K's lower triangle in, its dense L^-1 out; n^3/3 for the factor, as much for the inverse
        count, n = shape[0], shape[-1]
        return 4 * count * (n * (n + 1) / 2 + n * n), count * 2 * n**3 / 3
    if key == "fused_cholesky_invs":  # K's block lower triangle in; L and the tile inverses out
        n = shape[0]
        return 4 * (n * (n + b) / 2 + n * n + n * b), n**3 / 3 + (n // b) * b**3 / 3
    if key == "sgpr_value_and_grad":  # (n, m): x, y and Z in, the gradient out; the (m, n) products
        # forward (L^-1 Kuf, A A^T) and backward (L^-T Xbar, Bbar X^T, the
        # two of A A^T's pullback), 10 m^2 n in all, and the two m x m
        # factorizations with their pullbacks, about 7 m^3
        n, m = shape
        return 4 * (2 * n + 2 * m + 3), 10 * m * m * n + 7 * m**3
    count = math.prod(shape[:-2])  # a stack's matrices or tiles (1 for one)
    if key == "chol_inv_tile":  # each tile in; L and inv(L) out
        return count * 4 * 3 * b * b, count * 2 * b**3 / 3
    if key == "chol_tile":
        return 4 * 2 * b * b, b**3 / 3
    if key == "tril_inv_tile":
        return 4 * 2 * count * b * b, count * b**3 / 3
    # K3 and K4: the strictly lower block triangle and the tile inverses,
    # y in, x out; a multiply-add per float of L and of the inverses; a
    # batch of solves that many times
    n = shape[-1]
    return count * 4 * (n * (n - b) / 2 + n * b + 2 * n), count * (n * (n - b) + 2 * n * b)


def bound(key: str, shape) -> tuple[float, str]:
    """The least time the card could take (ms), and what sets it."""
    nbytes, flops = work(key, shape)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def event_ms(fn, reps: int, warmup: int = 3) -> float:
    """Device time per call from CUDA events around ``reps`` calls.  The
    card first spins for about as long as the host needs to queue the calls
    (measured on the warmup), so that they run back to back and a kernel
    shorter than its host-side launch still shows its device time."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_s = (time.perf_counter() - t0) / warmup
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(1.5 * reps * host_s * SPIN_HZ))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps: int = 5) -> float:
    """Median host time per call, each call ending in a synchronize."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def max_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max abs error / max |want|), in f64."""
    got, want = got.double(), want.double()
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite values in a kernel result")
    abs_err = float((got - want).abs().max())
    return abs_err, abs_err / max(float(want.abs().max()), 1e-30)


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    info = {
        "phase": "device",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "capability": list(torch.cuda.get_device_capability(0)),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
    }
    emit(info)
    return info


def phase_build() -> None:
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    seconds = time.perf_counter() - t0
    log = (lib_path.parent / "build.log").read_text().splitlines()
    emit({"phase": "build", "seconds": round(seconds, 3), "library": str(lib_path.name), "ptxas": ptxas_lines(log)})


def host_warmup() -> None:
    """What a process's first Laplace fit pays once on the host (torch._refs'
    import of sympy, the first torch.func transform's decompositions, the
    likelihood's vmap of grad of grad; PR 12's coldstart phase), paid on
    the CPU at n = 16: by this process beside the kernels' build, which
    leaves it waiting on nvcc, and by a parallel rank while it waits for
    ``go``."""
    from gogp_torch import graft_entry

    _, gp, _ = graft_entry._flagship()
    x, y = graft_entry._series(16, 0, 0.1)
    f64 = torch.float64
    laplace.laplace_fit(gp, likelihoods.bernoulli_logit, torch.ones(gp.n_theta_simil, dtype=f64),
                        torch.zeros(0, dtype=f64), torch.as_tensor(x), torch.as_tensor((y > 0).astype(np.float64)),
                        theta_noise=torch.ones(gp.n_theta_noise, dtype=f64), max_iters=1)


def ptxas_lines(log: list[str]) -> list[str]:
    """ptxas's per-kernel lines from a build log: each entry function's name,
    then its registers, shared memory and spills."""
    keep = ("Compiling entry", "Used", "spill")
    return [line.replace("ptxas info    : ", "").strip() for line in log if any(k in line for k in keep)]


def problem(dtype: torch.dtype, device):
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0, 100, (N, 1)), axis=0)
    y = np.sin(x[:, 0] / 3.0) + 0.1 * rng.normal(size=N)
    gp = GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    v = torch.zeros(gp.n_theta, dtype=dtype, device=device)
    theta = torch.exp(v)
    return gp, t(x), t(y), v, theta[: gp.n_theta_simil], theta[gp.n_theta_simil :], t(np.linspace(0, 100, M))


def run_slice(gp, x, y, v, ts, tn, z) -> dict:
    post = core.absorb(gp, ts, tn, x, y)
    return {
        "lml_from_posterior": core.lml_from_posterior(post),
        "lml": core.lml(gp, ts, tn, x, y),
        "gp_observe": gp_observe(gp, v, x=x, y=y),
        "predict": core.predict_from_posterior(gp, post, z),
        "predict_y": core.predict_y_from_posterior(gp, post, z),
    }


def train_problem(n: int, dtype: torch.dtype, device):
    """The barebones study (gogp_tpu/tutorial/barebones.py:23) on bench.py's
    generator at n points, y normalised with the sample std as evaluate
    does, v0 = 0, forecast points on linspace(0, 100)."""
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0, 100, (n, 1)), axis=0)
    y = np.sin(x[:, 0] / 3.0) + 0.1 * rng.normal(size=n)
    y = (y - y.mean()) / y.std(ddof=1)
    gp = GP(ndim=1, simil=matern32.scaled(), noise=uniform_noise.scaled_by(0.01))

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    v0 = torch.zeros(gp.n_theta, dtype=dtype, device=device)
    return gp, t(x), t(y), v0, t(np.linspace(0, 100, M_TRAIN))


def train_cov(n: int, dev) -> torch.Tensor:
    """The train path's covariance at v0 (f32), at n points."""
    gp, x, _, v0, _ = train_problem(n, torch.float32, dev)
    theta = torch.exp(v0)
    return core.masked_cov(gp, theta[: gp.n_theta_simil], theta[gp.n_theta_simil :], x, None)


def value_and_grad_step(gp, x, y, v0, z):
    return masked_value_and_grad(make_gp_logp(gp, x=x, y=y))(v0)


def fit(gp, x, y, v0, z, lbfgs_calls: list | None = None):
    """Adam from v0, LBFGS from v0 (the reference's default), both through
    the front door; ``lbfgs_calls[0]`` counts LBFGS's objective calls."""
    logp = make_gp_logp(gp, x=x, y=y)
    adam = mle.adam(masked_value_and_grad(logp), v0, iters=ADAM_STEPS, threshold=0.0)

    def counted(v):
        if lbfgs_calls is not None:
            lbfgs_calls[0] += 1
        return logp(v)

    lbfgs = mle.lbfgs(counted, v0, iters=LBFGS_ITERS, threshold=LBFGS_THRESHOLD)
    return adam, lbfgs


def forecast(gp, x, y, v, z) -> dict:
    post = gp_posterior(gp, v, x=x, y=y)
    return {"predict": core.predict_from_posterior(gp, post, z),
            "predict_y": core.predict_y_from_posterior(gp, post, z)}


def run_train(gp, x, y, v0, z) -> dict:
    """The train path once: value and gradient at v0, Adam, LBFGS, then the
    forecast at the LBFGS optimum."""
    value, grad = value_and_grad_step(gp, x, y, v0, z)
    adam, lbfgs = fit(gp, x, y, v0, z)
    return {"value": value, "grad": grad, "adam": adam, "lbfgs": lbfgs, **forecast(gp, x, y, lbfgs.x, z)}


def large_problem(n: int, dtype: torch.dtype, device):
    """The JAX package's large-n problem (benchmarks/tpu_round2.py:76-81) at
    n points: rbf.scaled() + uniform_noise, v0 = 0, forecast points on
    linspace(0, 400)."""
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0, X_LARGE, (n, 1)), axis=0)
    y = np.sin(x[:, 0] / 3.0) + 0.1 * rng.normal(size=n)
    gp = GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    v0 = torch.zeros(gp.n_theta, dtype=dtype, device=device)
    return gp, t(x), t(y), v0, t(np.linspace(0, X_LARGE, M_LARGE))


def large_cov(n: int, dev) -> torch.Tensor:
    """The large path's covariance at v0 (f32), at n points."""
    gp, x, _, v0, _ = large_problem(n, torch.float32, dev)
    theta = torch.exp(v0)
    return core.masked_cov(gp, theta[: gp.n_theta_simil], theta[gp.n_theta_simil :], x, None)


def run_large(gp, x, y, v0, z, after=lambda stage: None) -> dict:
    """The large path once: value and gradient at v0, Adam, then the
    forecast at Adam's v; ``after(stage)`` runs after each stage."""
    value, grad = value_and_grad_step(gp, x, y, v0, z)
    after("step")
    adam = mle.adam(masked_value_and_grad(make_gp_logp(gp, x=x, y=y)), v0, iters=ADAM_LARGE, threshold=0.0)
    after("adam")
    out = forecast(gp, x, y, adam.x, z)
    after("forecast")
    return {"value": value, "grad": grad, "adam": adam, **out}


# What the library call beside a kernel computes, where it is more than one
# call or less than the kernel's function.
LIBRARY_NAMES = {
    "chol_inv_tile": "torch.linalg.cholesky + torch.linalg.solve_triangular(L, I)",
    "fused_cholesky_invs": "cholesky_ex, L only (no tile inverses)",
    "fused_gp_linv": "torch.linalg.cholesky + torch.linalg.solve_triangular(L, I)",
}


def check_kernel(path: str, key: str, kernel, plain, shape, reps: int, library=None,
                 rtol: float = KERNEL_RTOL, **extra) -> dict:
    """Hold one kernel against its plain version on the same inputs, then
    time both, ``library`` (one PyTorch call computing the same function, or
    None; LIBRARY_NAMES says which where it is more than one call) and each
    of ``extra``'s calls with CUDA events."""
    library_name = LIBRARY_NAMES.get(key) if library is not None else None
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
    errs = [max_err(g, w) for g, w in pairs]
    abs_err, rel_err = max(e[0] for e in errs), max(e[1] for e in errs)
    bound_ms, bound_by = bound(key, shape)
    row = {
        "kernel": key, "path": path, "shape": list(shape),
        "max_abs_err": abs_err, "max_rel_err": rel_err, "bound_rel": rtol,
        "ms": event_ms(kernel, reps), "plain_ms": event_ms(plain, reps),
        "library_ms": None if library is None else event_ms(library, reps),
        **({"library_name": library_name} if library_name else {}),
        "bound_ms": bound_ms, "bound_by": bound_by,
        **{name: event_ms(fn, reps) for name, fn in extra.items()},
    }
    emit({"phase": "kernels", **row})
    if not rel_err <= rtol:
        raise AssertionError(f"{key} at {list(shape)}: kernel disagrees with its plain version ({rel_err:.3e} > {rtol})")
    return row


def tile_cases(tile: torch.Tensor) -> dict:
    """K2 and K6 on one tile: key -> (kernel call, plain call, shape of the
    main input, reps, library call)."""
    eye = torch.eye(BLOCK, dtype=tile.dtype, device=tile.device)
    return {
        "chol_inv_tile": (lambda: cb.cholesky_inv_tile(tile), lambda: cb.cholesky_inv_tile_plain(tile),
                          tile.shape, 50,
                          lambda: torch.linalg.solve_triangular(torch.linalg.cholesky(tile), eye, upper=False)),
        "chol_tile": (lambda: cb.cholesky_tile(tile), lambda: cb.cholesky_tile_plain(tile),
                      tile.shape, 50, lambda: torch.linalg.cholesky(tile)),
    }


def solves_with_k4(n: int) -> bool:
    """Whether ``lml_core`` solves with K4 (not K3) at size n."""
    return cb.trsv_solvers(n, BLOCK)[0] is cb.trsv2d_lower


def solve_keys(n: int) -> tuple[str, str]:
    """The launch-count keys of the two solves ``lml_core`` takes at size n."""
    return ("trsv2d_lower", "trsv2d_lower_t") if solves_with_k4(n) else ("trsv_lower", "trsv_lower_t")


def solve_cases(L: torch.Tensor, invs: torch.Tensor, y: torch.Tensor, reps: int = 20, k4: bool = False) -> dict:
    """The two solves (K3, or K4 with ``k4``) and K5 on one factor, its tile
    inverses and a right-hand side: key -> (kernel call, plain call, shape of
    the main input, reps, library call)."""
    n = L.shape[0]
    fwd, bwd = (cb.trsv2d_lower, cb.trsv2d_lower_t) if k4 else (cb.trsv_lower, cb.trsv_lower_t)
    key = "trsv2d_lower" if k4 else "trsv_lower"
    z = fwd(L, y, invs, BLOCK)
    tiles = diag_tiles(L)
    eye = torch.eye(BLOCK, dtype=L.dtype, device=L.device)
    return {
        key: (lambda: fwd(L, y, invs, BLOCK), lambda: cb.trsv_lower_plain(L, y), L.shape, reps,
              lambda: torch.linalg.solve_triangular(L, y[:, None], upper=False)),
        f"{key}_t": (lambda: bwd(L, z, invs, BLOCK), lambda: cb.trsv_lower_t_plain(L, z), L.shape, reps,
                     lambda: torch.linalg.solve_triangular(L.mT, z[:, None], upper=True)),
        "tril_inv_tile": (lambda: cb.tril_inv_tile(tiles), lambda: cb.tril_inv_tile_plain(tiles), tiles.shape, 20,
                          lambda: torch.linalg.solve_triangular(tiles, eye, upper=False)),
    }


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version at the shapes each path gives
    it; returns {(path, key): row}."""
    rows = {}
    gp, x, y, v, ts, tn, _ = problem(torch.float32, dev)
    K = core.masked_cov(gp, ts, tn, x, None)
    L, invs = cb.blocked_cholesky_invs(K, BLOCK)  # n = 4096: K1 or the stepwise driver, as the gate says
    tiles = tile_cases(K[:BLOCK, :BLOCK].contiguous())
    # the serving path launches no transpose solve; it is held at n = 4096
    # too.  Its factorization is held with K1's sizes below, or here if the
    # gate sends n = 4096 to the stepwise driver (K2).
    serve = solve_cases(L, invs, y, k4=solves_with_k4(N))
    if SERVE_FACTOR == "chol_inv_tile":
        serve["chol_inv_tile"] = tiles["chol_inv_tile"]
    for key, case in serve.items():
        rows["serve", key] = check_kernel("serve", key, *case)
    # K6, which no path calls, on the same tile
    rows["kernels", "chol_tile"] = check_kernel("kernels", "chol_tile", *tiles["chol_tile"])
    for n in K1_SIZES:
        Kn = K if k1_path(n) == "serve" else train_cov(n, dev)  # serving's own covariance at N

        def stepwise(Kn=Kn):
            with cb.no_fused_whole():
                return cb.blocked_cholesky_invs(Kn)

        path = k1_path(n)
        with unittest.mock.patch.object(cb, "_FUSED_MAX_N", max(K1_SIZES)):  # past the range check
            rows[path, "fused_cholesky_invs"] = check_kernel(
                path, "fused_cholesky_invs",
                lambda: cb.fused_cholesky_invs(Kn), lambda: cb.fused_cholesky_invs_plain(Kn), Kn.shape, 20,
                lambda: torch.linalg.cholesky_ex(Kn), rtol=K1_RTOL, stepwise_ms=stepwise,
            )
        del Kn
    emit(fused_gate(rows))
    # the train path's solves: on K1's factor of its covariance at v0
    y = train_problem(N_TRAIN, torch.float32, dev)[2]
    L, invs = cb.fused_cholesky_invs(train_cov(N_TRAIN, dev))
    for key, case in solve_cases(L, invs, y, k4=solves_with_k4(N_TRAIN)).items():
        rows["train", key] = check_kernel("train", key, *case)
    # Both solves by K3 and by K4 on blocked_cholesky_invs' factor of the large
    # path's covariance at each of GATE_SIZES, beside plain and the library
    # call; at n = N_LARGE also the large path's K2 and K5.
    for n in GATE_SIZES:
        Kn = large_cov(n, dev)
        L, invs = cb.blocked_cholesky_invs(Kn, BLOCK)
        y = large_problem(n, torch.float32, dev)[2]
        path = "large" if n == N_LARGE else f"n={n}"
        cases = {**solve_cases(L, invs, y, reps=10), **solve_cases(L, invs, y, reps=10, k4=True)}
        if n == N_LARGE:
            cases["chol_inv_tile"] = tile_cases(Kn[:BLOCK, :BLOCK].contiguous())["chol_inv_tile"]
        else:
            del cases["tril_inv_tile"]
        for key, case in cases.items():
            rows[path, key] = check_kernel(path, key, *case)
        del Kn, L, invs
    for key in OFF_PATH_SOLVES:  # held at the large path's shape
        rows["kernels", key] = rows["large", key]
    emit(trsv_gate(rows))
    return rows


def k1_path(n: int) -> str:
    """The path whose row K1's check at size n fills: train at N_TRAIN,
    serve at N where the gate sends serving to K1."""
    if n == N_TRAIN:
        return "train"
    return "serve" if n == N and SERVE_FACTOR == "fused_cholesky_invs" else f"n={n}"


def fused_gate(rows: dict) -> dict:
    """K1's gate beside the times that set it: device ms of K1, of the
    stepwise driver and of cholesky_ex (the factor alone) at each of
    K1_SIZES, from this run's rows, and which route the gate gives each n."""
    sizes = {}
    for n in K1_SIZES:
        row = rows[k1_path(n), "fused_cholesky_invs"]
        sizes[n] = {"k1_ms": row["ms"], "stepwise_ms": row["stepwise_ms"], "cholesky_ex_ms": row["library_ms"],
                    "takes": "K1" if n <= cb._FUSED_MAX_N else "stepwise"}
    return {"phase": "gates", "gate": "_FUSED_MAX_N", "value": cb._FUSED_MAX_N, "ms": sizes}


def trsv_gate(rows: dict) -> dict:
    """The gate between K3 and K4 beside the times that set it: device ms of
    both solves by K3, by K4 and by ``solve_triangular`` at each of
    GATE_SIZES, from this run's rows."""
    sizes = {}
    for n in GATE_SIZES:
        path = "large" if n == N_LARGE else f"n={n}"
        sizes[n] = {
            "k3_ms": [rows[path, "trsv_lower"]["ms"], rows[path, "trsv_lower_t"]["ms"]],
            "k4_ms": [rows[path, "trsv2d_lower"]["ms"], rows[path, "trsv2d_lower_t"]["ms"]],
            "library_ms": [rows[path, "trsv_lower"]["library_ms"], rows[path, "trsv_lower_t"]["library_ms"]],
            "takes": "K4" if solves_with_k4(n) else "K3",
        }
    gate = cb._TRSV2D_MIN_N
    return {"phase": "gates", "gate": "_TRSV2D_MIN_N", "value": gate if np.isfinite(gate) else "none: K3 at every n",
            "forward_and_transpose_ms": sizes}


# Beyond N_LARGE the gate is looked for on synthetic factors (no
# factorization: 17 GB of L at the largest), with ``--phases gate`` only.
FAR_GATE_SIZES = (24576, 32768, 49152, 65536)


def synthetic_factor(n: int, dev):
    """A well-conditioned random lower-triangular factor at size n (unit-scale
    diagonal in [1, 2), entries below it 0.5 N(0, 1) / sqrt(n)), its tile
    inverses by K5 and a right-hand side, from a generator seeded with n."""
    g = torch.Generator(device=dev).manual_seed(n)
    L = torch.randn((n, n), generator=g, device=dev).mul_(0.5 / np.sqrt(n)).tril_()
    L.diagonal().copy_(1.0 + torch.rand(n, generator=g, device=dev))
    invs = cb.tril_inv_tile(diag_tiles(L))
    return L, invs, torch.randn(n, generator=g, device=dev)


def diag_tiles(L: torch.Tensor) -> torch.Tensor:
    """The (..., n/b, b, b) stack of L's diagonal tiles, contiguous."""
    return cb._diag_tiles(L, BLOCK).contiguous()


def phase_gate(dev) -> None:
    """K3 and K4 against ``solve_triangular`` beyond the large path's size,
    on synthetic factors (``synthetic_factor``).  Both kernels are held to
    1e-4 of the largest entry of the library's solve, itself f32 here;
    prints device ms of each, forward and transpose."""
    sizes = {}
    for n in FAR_GATE_SIZES:
        L, invs, y = synthetic_factor(n, dev)
        calls = {
            "k3_ms": (lambda: cb.trsv_lower(L, y, invs, BLOCK), lambda: cb.trsv_lower_t(L, y, invs, BLOCK)),
            "k4_ms": (lambda: cb.trsv2d_lower(L, y, invs, BLOCK), lambda: cb.trsv2d_lower_t(L, y, invs, BLOCK)),
            "library_ms": (lambda: cb.trsv_lower_plain(L, y), lambda: cb.trsv_lower_t_plain(L, y)),
        }
        want = [fn() for fn in calls["library_ms"]]
        for name in ("k3_ms", "k4_ms"):
            for got, ref in zip((fn() for fn in calls[name]), want):
                rel = max_err(got, ref)[1]
                if not rel <= 1e-4:
                    raise AssertionError(f"{name[:2]} at n = {n} disagrees with solve_triangular ({rel:.3e})")
        sizes[n] = {name: [event_ms(fn, 5) for fn in fns] for name, fns in calls.items()}
        del L, invs, y, want
    emit({"phase": "gates", "gate": "_TRSV2D_MIN_N", "factors": "synthetic", "forward_and_transpose_ms": sizes})


# K5 one CTA a tile and split over 2 and 4 CTAs by block column, at each
# path's count of tiles and past the card's 132 SMs: the measurements that
# set gogp_tril_inv_tiles' split (tril_inv_tile.cu).
K5_SPLITS = (1, 2, 4)
K5_FAR_COUNT = 200
# K5 on ill-conditioned tiles (diagonal from 1 down to 4e-4-2e-3) against
# f64, column by column: the largest error in a column over that column's
# largest entry.  Written before the first run on the card: 1e-3; then set to
# about 10 times the 3.3e-4 an H100 showed (forward substitution, the plain
# version, 2.7e-4).
K5_ILL_RTOL = 3e-3


def k5_split(tiles: torch.Tensor, split: int) -> torch.Tensor:
    """K5 at the given split (CTAs a tile), past the wrapper: for
    measurement only, counted nowhere."""
    out = torch.empty_like(tiles)
    _build.check(_build.library().gogp_tril_inv_tiles_split(
        tiles.data_ptr(), out.data_ptr(), tiles.shape[0], BLOCK, split, torch.cuda.current_stream().cuda_stream),
        "K5 at a split")
    return out


def ill_conditioned_tiles(count: int, dev) -> torch.Tensor:
    """(count, b, b) Cholesky factors of rbf covariances on b points of [0,
    1] plus jitter 1e-7, the length scale from 0.05 to 1 (log-spaced): their
    diagonals run from 1 down to 4e-4-2e-3, and forward substitution loses
    about 3e-4 of a column's scale on them in f32."""
    x = np.linspace(0, 1, BLOCK)
    tiles = [np.linalg.cholesky(np.exp(-0.5 * (x[:, None] - x[None]) ** 2 / ell**2) + 1e-7 * np.eye(BLOCK))
             for ell in np.logspace(np.log10(0.05), 0, count)]
    return torch.as_tensor(np.stack(tiles), dtype=torch.float32, device=dev)


def col_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest error in a column over the column's largest entry, in f64."""
    got, want = got.double(), want.double()
    return float(((got - want).abs().amax(dim=-2) / want.abs().amax(dim=-2).clamp_min(1e-300)).max())


def phase_k5(dev) -> dict:
    """K5 at each path's count of tiles (train 12, serve 32,
    large_n_bayes_exact 64, large 128, on each path's own factors) and at K5_FAR_COUNT synthetic tiles, at every
    split of K5_SPLITS against its plain version, with device times of each
    split, of the wrapper, of the plain version and of ``solve_triangular``;
    then K5 on ill-conditioned tiles against f64.  Returns {count: ms by
    split}."""
    gp, x, _, _, ts, tn, _ = problem(torch.float32, dev)
    stacks = {
        "train": diag_tiles(cb.fused_cholesky_invs(train_cov(N_TRAIN, dev))[0]),
        "serve": diag_tiles(cb.blocked_cholesky_invs(core.masked_cov(gp, ts, tn, x, None), BLOCK)[0]),
        "large": diag_tiles(cb.blocked_cholesky_invs(large_cov(N_LARGE, dev), BLOCK)[0]),
        "large_n_bayes_exact": diag_tiles(torch.linalg.cholesky(lnbx_covs(dev)).contiguous()).reshape(-1, BLOCK, BLOCK),
        f"count={K5_FAR_COUNT}": diag_tiles(synthetic_factor(K5_FAR_COUNT * BLOCK, dev)[0]),
    }
    eye = torch.eye(BLOCK, device=dev)
    times = {}
    for label, tiles in stacks.items():
        want = cb.tril_inv_tile_plain(tiles)
        errs = {split: max_err(k5_split(tiles, split), want)[1] for split in K5_SPLITS}
        ms = {split: event_ms(lambda split=split: k5_split(tiles, split), 20) for split in K5_SPLITS}
        times[tiles.shape[0]] = ms
        emit({"phase": "k5", "path": label, "count": tiles.shape[0], "max_rel_err": errs, "bound_rel": KERNEL_RTOL,
              "split_ms": ms, "fastest_split": min(ms, key=ms.get),
              "wrapper_ms": event_ms(lambda: cb.tril_inv_tile(tiles), 20),
              "plain_ms": event_ms(lambda: cb.tril_inv_tile_plain(tiles), 20),
              "library_ms": event_ms(lambda: torch.linalg.solve_triangular(tiles, eye, upper=False), 20),
              "bound_ms": bound("tril_inv_tile", tiles.shape)[0]})
        bad = {split: err for split, err in errs.items() if not err <= KERNEL_RTOL}
        if bad:
            raise AssertionError(f"K5 at {label} disagrees with its plain version: {bad}")
    tiles = ill_conditioned_tiles(16, dev)
    want = cb.tril_inv_tile_plain(tiles.double())
    errs = {split: col_rel_err(k5_split(tiles, split), want) for split in K5_SPLITS}
    emit({"phase": "k5", "path": "ill-conditioned", "count": tiles.shape[0],
          "diagonal": [float(tiles.diagonal(dim1=1, dim2=2).min()), float(tiles.diagonal(dim1=1, dim2=2).max())],
          "col_rel_err_vs_f64": errs, "plain_f32_col_rel_err_vs_f64": col_rel_err(cb.tril_inv_tile_plain(tiles), want),
          "wrapper_col_rel_err_vs_f64": col_rel_err(cb.tril_inv_tile(tiles), want), "bound": K5_ILL_RTOL})
    bad = {split: err for split, err in errs.items() if not err <= K5_ILL_RTOL}
    if bad:
        raise AssertionError(f"K5 on ill-conditioned tiles disagrees with f64: {bad}")
    emit({"phase": "gates", "gate": "K5 split (tril_inv_tile.cu)", "ms_by_split": times,
          "fastest": {count: min(ms, key=ms.get) for count, ms in times.items()}})
    return times


def phase_slice(dev) -> tuple[dict, tuple]:
    args32 = problem(torch.float32, dev)
    args64 = problem(torch.float64, dev)

    cb.reset_launch_counts()
    got = run_slice(*args32)
    torch.cuda.synchronize()
    launches = dict(cb.LAUNCHES)

    with linalg.force_plain():
        ref = run_slice(*args64)
    torch.cuda.synchronize()

    report = {"phase": "slice", "n": N, "m": M, "block": BLOCK,
              "bounds": {"lml_rtol": LML_RTOL, "pred_atol": PRED_ATOL}}
    failures = []
    for name in ("lml_from_posterior", "lml", "gp_observe"):
        g, r = float(got[name]), float(ref[name])
        rel = abs(g - r) / abs(r)
        report[name] = {"f32_kernels": g, "f64_plain": r, "rel_err": rel}
        if not (np.isfinite(g) and rel <= LML_RTOL):
            failures.append(name)
    for name in ("predict", "predict_y"):
        errs = {}
        for label, g, r in zip(("mu", "sigma"), got[name], ref[name]):
            if g.shape != (M,) or not torch.isfinite(g).all():
                failures.append(f"{name}.{label} shape/finite")
            errs[f"{label}_abs_err"] = float((g.double() - r).abs().max())
            if not errs[f"{label}_abs_err"] <= PRED_ATOL:
                failures.append(f"{name}.{label}")
        report[name] = errs
    emit(report)
    if failures:
        raise AssertionError(f"slice disagrees with the f64 plain path: {failures}")
    return launches, args32


# The serving slice's kernels: n = 4096 factors with K1 below the measured
# gate (cb._FUSED_MAX_N), with the stepwise driver (K2) above it, and no call
# of it asks for a gradient, so lml_core solves no alpha (no transpose solve).
SERVE_FACTOR = "fused_cholesky_invs" if N <= cb._FUSED_MAX_N else "chol_inv_tile"
SERVE_KERNELS = (SERVE_FACTOR, solve_keys(N)[0], "tril_inv_tile")
# The train path's: K1 factors at n = 1536, every gradient solves alpha.
TRAIN_KERNELS = ("fused_cholesky_invs", *solve_keys(N_TRAIN), "tril_inv_tile")
# The large path's: the stepwise factorization (K2), both solves, K5 in the
# forecast.
LARGE_KERNELS = ("chol_inv_tile", *solve_keys(N_LARGE), "tril_inv_tile")
# The bayes path's: K7, once per value-and-gradient of the chain batch.
BAYES_KERNELS = ("fused_gp_linv",)
# the exact leg of large_n_bayes: K4 both ways and K5 on each batched value
# and gradient, K2 (and K5) in the predictive mixture
LNBX_KERNELS = ("chol_inv_tile", "trsv2d_lower", "trsv2d_lower_t", "tril_inv_tile")
# K6 is on no path, and neither is the solver the gate leaves no path's size
# to (K3 as measured, K4 from n = 1024 on): their entries count their
# launches in the kernels phase.
OFF_PATH_SOLVES = tuple(k for k in ("trsv_lower", "trsv_lower_t", "trsv2d_lower", "trsv2d_lower_t")
                        if k not in (*SERVE_KERNELS, *TRAIN_KERNELS, *LARGE_KERNELS))
# The serving caches' (gp.serve, gp.streaming, gp.model_selection): K1 in
# every absorb, K5 in every tril_inv and every append's TRSM.  The
# classification path's (gp.laplace, gp.ep): K1 for B in every Newton step
# and EP sweep, K5 in the TRSMs and pullbacks and the serving inverses.
SERVE_CACHE_KERNELS = ("fused_cholesky_invs", "tril_inv_tile")
CLASSIFY_KERNELS = ("fused_cholesky_invs", "tril_inv_tile")
# The sparse path's (gp.sparse at m = 1024): K1 for every m x m factor, K5 in
# every blocked TRSM and pullback.  The model surface's (gp.tprocess, deep and
# ICM kernels at n = 4096): K1, the gate's solver both ways (lml_core's
# gradient) and K5 (the TP's Cholesky pullback and tp_predict's TRSM).
SPARSE_KERNELS = ("fused_cholesky_invs", "tril_inv_tile")
SURFACE_KERNELS = ("fused_cholesky_invs", *solve_keys(N), "tril_inv_tile")
# The pathwise path's (gp.pathwise at n = 4096): K1 for every n = 4096
# factor (and Kuu's at m = 1024), K5 in every cho_solve_mat and blocked
# TRSM, at 32 tiles.  BO's (capacity 1024): K5 in every TRSM of the
# streaming posterior, at 8 tiles.  The search's: K7, once per Adam step of
# each candidate's (8, 128, 128) restart batch.
PATHWISE_KERNELS = ("fused_cholesky_invs", "tril_inv_tile")
BO_KERNELS = ("tril_inv_tile",)
SEARCH_KERNELS = ("fused_gp_linv",)
# The evaluate path's: K7, once per batched value-and-gradient of the
# prefix fits, at 127 x 128 x 128 (barebones at EVAL_N) and 43 x 44 x 44
# (hyperpriors).
EVALUATE_KERNELS = ("fused_gp_linv",)
# The samplers path's: K7, once per batched value-and-gradient of each
# engine's run on a theta-only study, at that run's batch.
SAMPLER_PATHS = ("samplers_nuts", "samplers_hmc", "samplers_pt_chees", "samplers_ghmc", "samplers_chees_pops",
                 "samplers_chees_race", "samplers_pt_nuts", "samplers_advi", "samplers_advi_full", "samplers_smc")
PATH_KERNELS = {"serve": SERVE_KERNELS, "train": TRAIN_KERNELS, "large": LARGE_KERNELS,
                "serve_cache": SERVE_CACHE_KERNELS, "classify": CLASSIFY_KERNELS,
                "sparse": SPARSE_KERNELS, "surface": SURFACE_KERNELS,
                "pathwise": PATHWISE_KERNELS, "bo": BO_KERNELS, "search": SEARCH_KERNELS,
                "bayes": BAYES_KERNELS, "large_n_bayes_exact": LNBX_KERNELS,
                "evaluate": EVALUATE_KERNELS, "evaluate_hyperpriors": EVALUATE_KERNELS,
                **{path: ("fused_gp_linv",) for path in SAMPLER_PATHS},
                "parallel": ("chol_inv_tile",),
                "parallel_ranks": ("chol_inv_tile", "fused_gp_linv", "fused_cholesky_invs", "tril_inv_tile"),
                "graft": ("fused_gp_linv",),
                "kernels": ("chol_tile", *OFF_PATH_SOLVES)}


def phase_launches(launches: dict, args32) -> None:
    missing = [k for k in SERVE_KERNELS if launches[k] < 1]
    kernel_ms = wall_ms(lambda: run_slice(*args32))
    with linalg.force_plain():
        plain_ms = wall_ms(lambda: run_slice(*args32))
    stages = {}
    gp, x, y, v, ts, tn, z = args32
    post = core.absorb(gp, ts, tn, x, y)
    for label, plain in (("kernels", False), ("plain", True)):
        ctx = linalg.force_plain() if plain else contextlib.nullcontext()
        with ctx:
            stages[label] = {
                "absorb": wall_ms(lambda: core.absorb(gp, ts, tn, x, y)),
                "lml": wall_ms(lambda: core.lml(gp, ts, tn, x, y)),
                "predict_from_posterior": wall_ms(lambda: core.predict_from_posterior(gp, post, z)),
                "masked_cov": wall_ms(lambda: core.masked_cov(gp, ts, tn, x, None)),
            }
    emit({"phase": "launches", "launches": launches, "slice_wall_ms": {"kernels_f32": kernel_ms, "plain_f32": plain_ms},
          "stage_wall_ms": stages})
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    if launches["trsv_lower_t"] + launches["trsv2d_lower_t"] != 0:
        raise AssertionError("a transpose solve launched on the serving path, where no call asks for a gradient")


def phase_train(dev) -> dict:
    args32 = train_problem(N_TRAIN, torch.float32, dev)
    args64 = train_problem(N_TRAIN, torch.float64, dev)

    cb.reset_launch_counts()
    t0 = time.perf_counter()
    got = run_train(*args32)
    torch.cuda.synchronize()
    train_wall_s = time.perf_counter() - t0
    launches = dict(cb.LAUNCHES)

    gp64, x64, y64, v64, z64 = args64
    v_fit = got["lbfgs"].x.double()
    with linalg.force_plain():
        ref = run_train(*args64)
        # the forecast, and the LML, at the f32 kernel path's optimum
        ref_at_fit = forecast(gp64, x64, y64, v_fit, z64)
        lml_at_fit = float(make_gp_logp(gp64, x=x64, y=y64)(v_fit))
        # f32 itself, reported: the plain path's f32 value, gradient and
        # forecast at the same v
        plain32_v0 = value_and_grad_step(*args32)
        plain32_at_fit = forecast(args32[0], args32[1], args32[2], got["lbfgs"].x, args32[4])
    torch.cuda.synchronize()

    def opt(res):
        return {"x": res.x.tolist(), "value": float(res.value), "iters": res.iters,
                "converged": res.converged, "stalled": res.stalled}

    def value_rel(value):
        return abs(float(value) - float(ref["value"])) / abs(float(ref["value"]))

    def grad_rel(grad):
        return float((grad.double() - ref["grad"]).abs().max() / ref["grad"].abs().max())

    errors = {
        "value_rel": value_rel(got["value"]), "value_rel_plain_f32": value_rel(plain32_v0[0]),
        "grad_rel": grad_rel(got["grad"]), "grad_rel_plain_f32": grad_rel(plain32_v0[1]),
        "adam_v_abs": float((got["adam"].x.double() - ref["adam"].x).abs().max()),
        "lbfgs_v_abs": float((got["lbfgs"].x.double() - ref["lbfgs"].x).abs().max()),
        "lbfgs_lml_rel": abs(float(got["lbfgs"].value) - float(ref["lbfgs"].value)) / abs(float(ref["lbfgs"].value)),
        "lbfgs_gap_rel": (float(ref["lbfgs"].value) - lml_at_fit) / abs(float(ref["lbfgs"].value)),
    }
    failures = []
    for name in ("predict", "predict_y"):
        for label, gt, rt in zip(("mu", "sigma"), got[name], ref_at_fit[name]):
            if gt.shape != (M_TRAIN,) or not torch.isfinite(gt).all():
                failures.append(f"{name}.{label} shape/finite")
            errors[f"{name}_{label}_abs"] = float((gt.double() - rt).abs().max())
        for label, pt, rt in zip(("mu", "sigma"), plain32_at_fit[name], ref_at_fit[name]):
            errors[f"{name}_{label}_abs_plain_f32"] = float((pt.double() - rt).abs().max())
    checks = {
        "value_rel": "value_rtol", "grad_rel": "grad_rtol", "adam_v_abs": "adam_v_atol",
        "lbfgs_lml_rel": "lbfgs_lml_rtol", "lbfgs_gap_rel": "lbfgs_gap_rtol",
        **{f"{a}_{b}_abs": "pred_atol" for a in ("predict", "predict_y") for b in ("mu", "sigma")},
    }
    failures += [k for k, bound in checks.items() if not errors[k] <= TRAIN_BOUNDS[bound]]
    if not all(torch.isfinite(t).all() for t in (got["value"], got["grad"], got["adam"].x, got["lbfgs"].x)):
        failures.append("non-finite fit")

    step_ms, fit_ms = {}, {}
    for label, ctx in (("kernels_f32", contextlib.nullcontext), ("plain_f32", linalg.force_plain)):
        with ctx():
            step_ms[label] = wall_ms(lambda: value_and_grad_step(*args32))
            torch.cuda.synchronize()
            t0, calls = time.perf_counter(), [0]
            adam, lbfgs = fit(*args32, lbfgs_calls=calls)
            torch.cuda.synchronize()
            fit_ms[label] = {"adam_and_lbfgs": (time.perf_counter() - t0) * 1e3,
                             "lbfgs_iters": lbfgs.iters, "lbfgs_objective_calls": calls[0],
                             "lbfgs_converged": lbfgs.converged, "lbfgs_stalled": lbfgs.stalled}

    emit({"phase": "train", "n": N_TRAIN, "m": M_TRAIN, "block": BLOCK,
          "bounds": TRAIN_BOUNDS, "errors": errors,
          "gp_observe_v0": {"f32_kernels": float(got["value"]), "f64_plain": float(ref["value"]),
                            "grad_f32_kernels": got["grad"].tolist(), "grad_f64_plain": ref["grad"].tolist()},
          "adam": {"f32_kernels": opt(got["adam"]), "f64_plain": opt(ref["adam"])},
          "lbfgs": {"f32_kernels": opt(got["lbfgs"]), "f64_plain": opt(ref["lbfgs"])},
          "launches": launches, "train_wall_s": train_wall_s,
          "value_and_grad_step_wall_ms": step_ms, "fit_wall_ms": fit_ms})
    if failures:
        raise AssertionError(f"train path disagrees with the f64 plain path: {failures}")
    missing = [k for k in TRAIN_KERNELS if launches[k] < 1]
    if missing:
        raise AssertionError(f"kernels not launched on the train path: {missing}")
    if launches["chol_inv_tile"] != 0:
        raise AssertionError(f"K2 launched on the train path, where K1 factors every n <= {cb._FUSED_MAX_N}")
    return {"launches": launches, "args32": args32}


def phase_large(dev) -> dict:
    args32 = large_problem(N_LARGE, torch.float32, dev)
    args64 = large_problem(N_LARGE, torch.float64, dev)
    nb = N_LARGE // BLOCK

    stages = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cb.reset_launch_counts()
    t0 = time.perf_counter()
    got = run_large(*args32, after=lambda stage: stages.__setitem__(stage, dict(cb.LAUNCHES)))
    torch.cuda.synchronize()
    large_wall_s = time.perf_counter() - t0
    launches = dict(cb.LAUNCHES)
    peak_kernel_path = torch.cuda.max_memory_allocated()

    gp64, x64, y64, _, z64 = args64
    with linalg.force_plain():
        ref = run_large(*args64)
        ref_at_v = forecast(gp64, x64, y64, got["adam"].x.double(), z64)  # at the kernel path's v
        plain32_v0 = value_and_grad_step(*args32)
    torch.cuda.synchronize()

    def value_rel(value):
        return abs(float(value) - float(ref["value"])) / abs(float(ref["value"]))

    def grad_rel(grad):
        return float((grad.double() - ref["grad"]).abs().max() / ref["grad"].abs().max())

    errors = {
        "value_rel": value_rel(got["value"]), "value_rel_plain_f32": value_rel(plain32_v0[0]),
        "grad_rel": grad_rel(got["grad"]), "grad_rel_plain_f32": grad_rel(plain32_v0[1]),
        "adam_v_abs": float((got["adam"].x.double() - ref["adam"].x).abs().max()),
    }
    failures = []
    for name in ("predict", "predict_y"):
        for label, gt, rt in zip(("mu", "sigma"), got[name], ref_at_v[name]):
            if gt.shape != (M_LARGE,) or not torch.isfinite(gt).all():
                failures.append(f"{name}.{label} shape/finite")
            errors[f"{name}_{label}_abs"] = float((gt.double() - rt).abs().max())
    checks = {"value_rel": "value_rtol", "grad_rel": "grad_rtol", "adam_v_abs": "adam_v_atol",
              **{f"{a}_{b}_abs": "pred_atol" for a in ("predict", "predict_y") for b in ("mu", "sigma")}}
    failures += [k for k, b in checks.items() if not errors[k] <= LARGE_BOUNDS[b]]
    if not all(torch.isfinite(t).all() for t in (got["value"], got["grad"], got["adam"].x)):
        failures.append("non-finite value, gradient or v")

    # launches per stage: K2 per factorization, the gate's solves both ways
    # per gradient step, none of the other solver's or of K1 anywhere, K5 in
    # the forecast
    zero = dict.fromkeys(cb.LAUNCHES, 0)
    per_stage = {}
    for prev, stage in ((zero, "step"), (stages["step"], "adam"), (stages["adam"], "forecast")):
        per_stage[stage] = {k: stages[stage][k] - prev[k] for k in cb.LAUNCHES}
    fwd, bwd = solve_keys(N_LARGE)
    want = {
        "step": {"chol_inv_tile": nb, fwd: 1, bwd: 1},
        "adam": {"chol_inv_tile": ADAM_LARGE * nb, fwd: ADAM_LARGE, bwd: ADAM_LARGE},
        "forecast": {"chol_inv_tile": nb, fwd: 0, bwd: 0},
    }
    for stage, counts in want.items():
        failures += [f"{stage}: {k} {per_stage[stage][k]} != {v}" for k, v in counts.items()
                     if k in LARGE_KERNELS and per_stage[stage][k] != v]
    if "tril_inv_tile" in LARGE_KERNELS and per_stage["forecast"]["tril_inv_tile"] < 1:
        failures.append("forecast: no K5 launch")
    other = [k for k in ("trsv_lower", "trsv_lower_t", "trsv2d_lower", "trsv2d_lower_t") if k not in (fwd, bwd)]
    failures += [f"{k} launched" for k in (*other, "fused_cholesky_invs") if launches[k]]

    # times: a value-and-gradient step on both f32 paths, the factorization
    # against cuSOLVER, the rescue's host read, and one step in TF32
    step_ms = {"kernels_f32": wall_ms(lambda: value_and_grad_step(*args32), reps=3)}
    with linalg.force_plain():
        step_ms["plain_f32"] = wall_ms(lambda: value_and_grad_step(*args32), reps=3)
    K = large_cov(N_LARGE, dev)
    factor_ms = {"stepwise": event_ms(lambda: cb.blocked_cholesky_invs(K, BLOCK), reps=3, warmup=1),
                 "cusolver": event_ms(lambda: cb.plain_cholesky(K), reps=3, warmup=1)}
    L = cb.blocked_cholesky_invs(K, BLOCK)[0]
    del K
    rescue_read_ms = wall_ms(lambda: bool(torch.isfinite(torch.diagonal(L)).all()), reps=21)
    del L
    gp, x, y, v0, z = args32
    tf32_logp = masked_value_and_grad(make_gp_logp(gp, x=x, y=y, precision="tensorfloat32"))
    tf32_value, tf32_grad = tf32_logp(v0)
    step_ms["kernels_tf32_rescue_engaged"] = wall_ms(lambda: tf32_logp(v0), reps=3)

    emit({"phase": "large", "n": N_LARGE, "m": M_LARGE, "block": BLOCK, "adam_steps": ADAM_LARGE,
          "bounds": LARGE_BOUNDS, "errors": errors,
          "gp_observe_v0": {"f32_kernels": float(got["value"]), "f64_plain": float(ref["value"]),
                            "grad_f32_kernels": got["grad"].tolist(), "grad_f64_plain": ref["grad"].tolist()},
          "adam_v": {"f32_kernels": got["adam"].x.tolist(), "f64_plain": ref["adam"].x.tolist()},
          "tf32": {"rescue_engaged": linalg._rescue_engaged(N_LARGE, "tensorfloat32"),
                   "value_rel": value_rel(tf32_value), "grad_rel": grad_rel(tf32_grad)},
          "launches": launches, "launches_per_stage": per_stage, "large_wall_s": large_wall_s,
          "value_and_grad_step_wall_ms": step_ms, "factorization_ms": factor_ms,
          "rescue_flag_read_wall_ms": rescue_read_ms,
          "peak_gib_kernel_path": peak_kernel_path / 2**30})
    if failures:
        raise AssertionError(f"large path disagrees with the f64 plain path or its launch counts: {failures}")
    return {"launches": launches, "args32": args32}


def bayes_problem(dev, dtype=torch.float32, plain: bool = False):
    """The hyperpriors study's log-joint on the K7 route (or, with
    ``plain``, built under force_plain: gp_observe plus priors under
    autograd) as ``bayes.main`` builds it: y normalised, v0 = 0."""
    _, study, data = bayes.get_study("hyperpriors")
    x, y = tio.load_csv(data)
    y_norm = tio.normalize(y)[0]
    with linalg.force_plain() if plain else contextlib.nullcontext():
        logp, observed, v0, free = bayes.build_logjoint(study, x, y_norm, dev, dtype)
    return study, x, y_norm, logp, observed, v0, free


def bayes_step(k7_logp, plain_logp, V):
    """One value and gradient of the chain batch by autograd, as the sampler
    takes it: the plain route inside force_plain, the K7 route outside."""
    q = V.detach().requires_grad_(True)
    lp = (plain_logp if linalg._FORCE_PLAIN else k7_logp)(q)
    return lp.detach(), torch.autograd.grad(lp.sum(), q)[0]


def bayes_positions(count: int, dev, dtype=torch.float32, seed: int = 0) -> torch.Tensor:
    """``count`` positions around v0, 0.1 N(0, 1), as the protocol starts
    its chains (benchmarks/ess_nuts.py:381)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return 0.1 * torch.randn((count, 6), generator=g, dtype=dtype, device=dev)


def bayes_covs(study, x, V: torch.Tensor) -> torch.Tensor:
    """The study's covariance at each position: a (len(V), n, n) batch."""
    nts = study.gp.n_theta_simil
    xt = torch.as_tensor(x, dtype=V.dtype, device=V.device)
    return torch.func.vmap(lambda v: core.masked_cov(study.gp, torch.exp(v[:nts]), torch.exp(v[nts:]), xt, None))(V)


def k7_cases(dev) -> dict:
    """K7 on the hyperpriors covariances at each of K7_BATCHES positions
    (n = 44) and, 64 matrices each, at each n of K7_SIZES up to K7's limit
    (the study's kernel on n points at the data's spacing): path -> (kernel
    call, plain call, shape, reps, library call)."""
    study, x, _, _, _, _, _ = bayes_problem(dev)
    cases = {}
    spacing = float(x[1, 0] - x[0, 0])
    sized = [(f"n={n}", BAYES_CHAINS, spacing * np.arange(n)[:, None]) for n in K7_SIZES]
    for label, count, xs in [*((f"B={b}", b, x) for b in K7_BATCHES), *sized]:
        K = bayes_covs(study, xs, bayes_positions(count, dev, seed=1))
        eye = torch.eye(K.shape[-1], dtype=K.dtype, device=dev)
        path = "bayes" if count == BAYES_CHAINS and xs is x else label
        cases[path] = (lambda K=K: fused_gp.fused_gp_linv(K), lambda K=K: fused_gp.linv_plain(K), K.shape, 50,
                       lambda K=K, eye=eye: torch.linalg.solve_triangular(torch.linalg.cholesky(K), eye, upper=False))
    return cases


def phase_k7(dev) -> dict:
    """K7 against its plain version and the library pair at the bayes path's
    shapes and at K7_SIZES; returns {(path, key): row}.  Prints K7's dispatch
    limit beside the times that set it."""
    rows = check_k7(k7_cases(dev))
    sizes = {rows[path, key]["shape"][-1]: {"k7_ms": rows[path, key]["ms"], "library_ms": rows[path, key]["library_ms"]}
             for path, key in rows if path == "bayes" or path.startswith("n=")}
    emit({"phase": "gates", "gate": "K7_MAX_N", "value": fused_gp.K7_MAX_N, "batch": BAYES_CHAINS,
          "ms": dict(sorted(sizes.items()))})
    return rows


def run_main(warmup: int, samples: int) -> dict:
    """``bayes.main(["hyperpriors", "--engine", "chees", "--chains", "64",
    "--seed", "0", "--warmup", warmup, "--samples", 64 * samples,
    "selfcheck"])`` in process, its output captured.  Inside it,
    ``chees.run_chees`` is wrapped to count the log-joint's calls and to
    read the host clock (after a synchronize) where sampling begins; the
    sampler runs on the state's own generator, as by default.  Returns the
    output lines, the sampler's Samples, and walls in s and
    value-and-gradient calls, each split into init + warmup and sampling."""
    calls, mark, runs = [0], {}, []
    real_run_chees = chees.run_chees

    def run_chees(logp, *args, **kwargs):
        def counted(V):
            calls[0] += 1
            return logp(V)

        def draws(state):
            if state.step == kwargs["num_warmup"]:  # the first sampling transition
                torch.cuda.synchronize()
                mark.update(t=time.perf_counter(), calls=calls[0])
            return chees.generator_draws(state)

        torch.cuda.synchronize()
        mark.update(t0=time.perf_counter())
        runs.append(real_run_chees(counted, *args, draws=draws, **kwargs))
        torch.cuda.synchronize()
        mark.update(t1=time.perf_counter())
        return runs[-1]

    out = io.StringIO()
    argv = ["hyperpriors", "--engine", "chees", "--chains", str(BAYES_CHAINS), "--seed", str(BAYES_SEED),
            "--warmup", str(warmup), "--samples", str(BAYES_CHAINS * samples), "selfcheck"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), unittest.mock.patch.object(chees, "run_chees", run_chees):
        bayes.main(argv)
    torch.cuda.synchronize()
    return {"argv": argv, "wall_s": time.perf_counter() - t0, "lines": out.getvalue().strip().splitlines(),
            "samples": runs[0],
            "walls": {"init_and_warmup": mark["t"] - mark["t0"], "sampling": mark["t1"] - mark["t"]},
            "calls": {"init_and_warmup": mark["calls"], "sampling": calls[0] - mark["calls"]}}


def plain_route_run() -> dict:
    """The bayes phase's command line on the plain route, cut to
    PLAIN_WARMUP + PLAIN_SAMPLES, as plain data (its draws on the CPU) with
    its K7 launches (none may happen)."""
    before = cb.LAUNCHES["fused_gp_linv"]
    with linalg.force_plain():
        run = run_main(PLAIN_WARMUP, PLAIN_SAMPLES)
    samples = run["samples"]
    run["samples"] = {"positions": samples.positions.cpu(), "accept_probs": samples.accept_probs.cpu()}
    return {**run, "k7_launches": cb.LAUNCHES["fused_gp_linv"] - before}


def bayes_plain_worker() -> dict:
    """:func:`plain_route_run` in a worker process (spawned, as
    :func:`sampler_worker`), beside the K7 route's run in the main process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    return plain_route_run()


def _posterior_summary(pos: torch.Tensor) -> dict:
    """Diagnostics of (draws, chains, dim) positions, in f64."""
    by_chain = pos.permute(1, 0, 2).double()
    min_ess, max_rhat, converged = diagnostics.gated_min_ess(by_chain)
    flat = by_chain.reshape(-1, by_chain.shape[-1])
    ess = diagnostics.ess(by_chain)
    return {"mean": flat.mean(0), "mcse": flat.std(0) / torch.sqrt(ess), "min_bulk_ess": min_ess,
            "max_bulk_rhat": max_rhat, "converged_rhat_1.01": converged, **diagnostics.diagnose(by_chain)}


def phase_bayes(dev, rows: dict | None = None, plain_pending=None) -> dict:
    # 1. K7 against its plain version at the path's shapes (``rows``, where
    # phase_k7 ran already); ``plain_pending``: the plain route's command
    # line running in a worker (a whole run), else it runs here
    rows = phase_k7(dev) if rows is None else rows

    # 2. the value and gradient of the log-joint the sampler runs, K7 route
    # (f32), against the plain route's in f64, at 256 positions
    study, x, y, logp, observed, v0, free = bayes_problem(dev)
    plain_logp = bayes_problem(dev, plain=True)[3]
    plain64_logp = bayes_problem(dev, torch.float64, plain=True)[3]
    V = bayes_positions(256, dev, seed=2)
    val, grad = bayes_step(logp, plain64_logp, V)
    with linalg.force_plain():
        want_val, want_grad = bayes_step(logp, plain64_logp, V.double())
    errors = {"value_rel": float(((val.double() - want_val).abs() / want_val.abs()).max()),
              "grad_rel": float((grad.double() - want_grad).abs().max() / want_grad.abs().max())}

    # 4. the main path: the command line on the K7 route at the protocol,
    # its K7 launches counted against its log-joint's calls
    cb.reset_launch_counts()
    k7_run = run_main(BAYES_WARMUP, BAYES_SAMPLES)
    launches = dict(cb.LAUNCHES)
    vg_calls = sum(k7_run["calls"].values())
    pos, acc, final = k7_run["samples"].positions, k7_run["samples"].accept_probs, k7_run["samples"].state
    k7 = _posterior_summary(pos)

    # 3. one transition on both routes from one state, the same draws: the
    # final state one transition on (after 128 + 128 transitions its halton
    # index, 2^8 + 1, gives a trajectory of about half the adapted length;
    # the final state's own index 2^8 gives a single leapfrog step, whose
    # positions the log-joint cannot change)
    gen = torch.Generator(device=dev).manual_seed(3)
    start = chees.chees_transition(logp, final._replace(rng=gen), free=free)
    fixed = chees.generator_draws(start)
    n_steps = chees.n_leapfrog_steps(start)[0]
    one = {label: chees.chees_transition(lp, start, free=free, draws=lambda s: fixed)
           for label, lp in (("k7", logp), ("plain", plain_logp))}
    accepted = {label: fixed[1] < s.accept_probs for label, s in one.items()}
    errors["transition_abs"] = float((one["k7"].positions - one["plain"].positions).abs().max())
    same_accepts = bool(torch.equal(accepted["k7"], accepted["plain"]))

    # the command line on the plain route, cut to PLAIN_WARMUP +
    # PLAIN_SAMPLES: no K7 launch
    plain_run = plain_route_run() if plain_pending is None else plain_pending.get()
    plain_launches = plain_run["k7_launches"]
    ppos, pacc = (plain_run["samples"][k].to(dev) for k in ("positions", "accept_probs"))
    plain = _posterior_summary(ppos)
    gap = (k7["mean"] - plain["mean"]) / torch.sqrt(k7["mcse"] ** 2 + plain["mcse"] ** 2)

    def route(run, summ, warmup, accepts):
        walls, lines = run["walls"], run["lines"]
        transitions = warmup + accepts.shape[0]
        rows = np.array([[float(v) for v in line.split(",")] for line in lines[:-1]])
        return {"argv": run["argv"], "main_wall_s": run["wall_s"], "wall_s": walls, "vg_calls": run["calls"],
                "transitions": transitions, "ms_per_transition": 1e3 * sum(walls.values()) / transitions,
                "ms_per_vg": 1e3 * sum(walls.values()) / sum(run["calls"].values()),
                "mean_accept_sampling": float(accepts.mean()),
                **{k: (v.tolist() if isinstance(v, torch.Tensor) else v) for k, v in summ.items()},
                "ess_per_s_sampling": summ["min_bulk_ess"] / walls["sampling"],
                "forecast_rows": list(rows.shape), "theta_mean_line": lines[-1],
                "forecast_ok": bool(rows.shape == (50, 4) and np.isfinite(rows[:, [0, 2, 3]]).all()
                                    and (rows[:, 3] > 0).all() and lines[-1].startswith("# posterior theta mean: "))}

    report = {
        "phase": "bayes", "chains": BAYES_CHAINS, "warmup": BAYES_WARMUP, "samples": BAYES_SAMPLES,
        "seed": BAYES_SEED, "n": x.shape[0], "bounds": BAYES_BOUNDS, "errors": errors,
        "same_accept_decisions": same_accepts, "transition_leapfrog_steps": n_steps,
        "transition_accepted": int(accepted["k7"].sum()), "launches": launches, "vg_calls": vg_calls,
        "plain_route_k7_launches": plain_launches,
        "k7_route": {**route(k7_run, k7, BAYES_WARMUP, acc), "step_size": float(final.step_size),
                     "traj_length": float(torch.exp(final.log_traj)), "inv_mass": final.inv_mass.tolist()},
        "plain_route": route(plain_run, plain, PLAIN_WARMUP, pacc),
        "mean_gap_in_mcse": gap.tolist(),
    }
    emit(report)

    failures = [k for k, b in (("value_rel", "value_rtol"), ("grad_rel", "grad_rtol"),
                               ("transition_abs", "transition_atol")) if not errors[k] <= BAYES_BOUNDS[b]]
    if not same_accepts:
        failures.append("the two routes took different accept decisions in one transition")
    if launches["fused_gp_linv"] != vg_calls:
        failures.append(f"K7 launched {launches['fused_gp_linv']} times in {vg_calls} value-and-gradient calls")
    if plain_launches:
        failures.append(f"the plain route launched K7 {plain_launches} times")
    if not (torch.isfinite(pos).all() and torch.isfinite(ppos).all()):
        failures.append("non-finite draws")
    if not BAYES_BOUNDS["accept_lo"] <= float(acc.mean()) <= BAYES_BOUNDS["accept_hi"]:
        failures.append(f"mean acceptance {float(acc.mean()):.3f} outside the bounds")
    failures += [f"bayes.main ({label}): not 50 finite forecast rows with sigma > 0 and the theta-mean line"
                 for label in ("k7_route", "plain_route") if not report[label]["forecast_ok"]]
    if failures:
        raise AssertionError(f"bayes path: {failures}")
    return {"launches": launches, "rows": rows, "logps": (logp, plain_logp)}


# The samplers path: every engine of the command line but ChEES at its
# defaults, each through ``bayes.main`` in process on the card's default
# route: K7 on the theta-only studies (hyperpriors, barebones), the plain
# route on anynoise, whose inputs and outputs are sampled too.  NUTS is the
# JAX package's default command; anynoise under HMC beside ADVI is
# BASELINE.json's "HMC + ADVI comparison".  Sizes: the JAX command line's
# defaults (gogp_tpu/tutorial/bayes.py: 4 chains, 400 warmup transitions,
# 512 samples, NUTS's trees up to depth 10, HMC's trajectories up to 1024
# leapfrog steps; PT-ChEES 4 ladders of 8 rungs, 400 + 128 sweeps, ChEES
# trajectories up to 256 steps; GHMC 1600 + 2048 one-step transitions;
# ADVI 4 x 400 steps of 8 draws; SMC 512 particles), but for five runs.
# NUTS alone took 612 s at the defaults on an H100 (max bulk R-hat 1.29),
# so it runs at NUTS_WARMUP warmup transitions, its trees whole.  HMC on
# anynoise, whose f32 steps adapt to about 0.003 (about 300 leapfrog steps,
# 2.6 s, a transition there: its 528 transitions would take 23 minutes),
# runs ANYNOISE_HMC transitions, its trajectories whole.  ChEES with
# ``--pops 4`` and ``--race 4`` runs at the bayes phase's 64 chains and 128
# + 128 transitions (BAYES_CUT).  ``tempering.run_pt_nuts``, which no
# command line runs on one device (gogp_tpu/parallel/sample.py:1093 is its
# only caller), runs at its 8 replicas and depth 6, 128 + 128 sweeps
# (PT_NUTS_CUT; its defaults are 500 + 500), through :func:`pt_nuts_main`.
# The hyperpriors posterior has more than one mode in the seasonal period,
# 1-2 of 4 NUTS chains adapt a small step, and the lockstep pays their
# trees (PERF.md).  The runs on hyperpriors each run in a worker process
# (SAMPLER_WORKERS, SAMPLER_POOL at a time, the longest first), which a
# whole run starts before the bayes phase's runs and waits for after the
# evaluate phase, while this process takes those phases and the other runs:
# the runs are host-bound (K7 0.019 ms of a 5-9 ms value and gradient) and
# the host has cores to spare.  Nothing that times the card runs beside
# them.
NUTS_WARMUP = ("--warmup", "200")
ANYNOISE_HMC = ("--warmup", "20", "--samples", "32")
BAYES_CUT = ("--chains", str(BAYES_CHAINS), "--warmup", str(BAYES_WARMUP), "--samples",
             str(BAYES_CHAINS * BAYES_SAMPLES))
PT_NUTS_CUT = ("--replicas", "8", "--warmup", "128", "--samples", "128")
SAMPLER_RUNS = (
    ("nuts", ["hyperpriors", "--engine", "nuts", *NUTS_WARMUP, "selfcheck"]),
    ("hmc", ["hyperpriors", "--engine", "hmc", "selfcheck"]),
    ("pt_chees", ["hyperpriors", "--engine", "pt-chees", "selfcheck"]),
    ("ghmc", ["hyperpriors", "--engine", "ghmc", "selfcheck"]),
    ("chees_pops", ["hyperpriors", "--engine", "chees", *BAYES_CUT, "--pops", "4", "selfcheck"]),
    ("chees_race", ["hyperpriors", "--engine", "chees", *BAYES_CUT, "--race", "4", "selfcheck"]),
    ("pt_nuts", ["hyperpriors", "--engine", "pt-nuts", *PT_NUTS_CUT, "selfcheck"]),
    ("advi", ["hyperpriors", "--engine", "advi", "selfcheck"]),
    ("anynoise_hmc", ["anynoise", "--engine", "hmc", *ANYNOISE_HMC, "selfcheck"]),
    ("anynoise_advi", ["anynoise", "--engine", "advi", "selfcheck"]),
    ("advi_full", ["barebones", "--engine", "advi-full", "selfcheck"]),
    ("smc", ["barebones", "--engine", "smc", "selfcheck"]),
)
SAMPLER_WORKERS = ("pt_chees", "nuts", "pt_nuts", "chees_race", "chees_pops", "hmc", "anynoise_hmc", "ghmc",
                   "anynoise_advi", "advi", "advi_full", "smc")
SAMPLER_POOL = 5
# The function each engine runs, wrapped to count its log-joint's calls
# (ChEES with --pops: run_chees_pops).
SAMPLER_FNS = {"nuts": ("nuts", "run_nuts"), "hmc": ("hmc", "run_hmc"), "advi": ("advi", "run_advi"),
               "advi-full": ("advi", "run_advi_fullrank"), "smc": ("smc", "run_smc"), "chees": ("chees", "run_chees"),
               "pt-chees": ("pt_chees", "run_pt_chees"), "ghmc": ("ghmc", "run_ghmc"),
               "pt-nuts": ("tempering", "run_pt_nuts")}
# Each MCMC engine's default draws, wrapped to mark where sampling begins.
SAMPLER_DRAWS = {"nuts": nuts.generator_draws, "pt-nuts": nuts.generator_draws, "chees": chees.generator_draws,
                 "pt-chees": chees.generator_draws, "ghmc": ghmc.generator_draws}
# The one-transition check: NUTS and HMC at this many chains from one state
# with the same draws, on the K7 route and under force_plain (f32 both).
SAMPLER_CHECK_CHAINS = 64
# Bounds of the one-transition check, per chain, about 10 times the largest
# an H100 showed on either engine (PERF.md): positions absolute (1.3e-4),
# log-joints relative (4.1e-5), acceptance probabilities absolute (2.6e-3).
# Every HMC chain must agree and take the same accept decision.  A NUTS
# chain can build another tree or take another leaf where f32 rounding tips
# a U-turn or a multinomial draw (2 of 64 did there), so at least
# nuts_agree of the chains must agree.
SAMPLER_BOUNDS = {"position_atol": 1.5e-3, "logp_rtol": 4e-4, "accept_atol": 2.5e-2,
                  "nuts_agree": SAMPLER_CHECK_CHAINS - 4}
# The same check for one PT-ChEES sweep (4 ladders x 8 rungs, 32 chains, from
# the pt_chees run's final state: ChEES trajectories of up to 256 steps,
# then the swap) and one GHMC transition (64 chains, one leapfrog step, at
# the ghmc run's step size and preconditioner).  The bounds were set before
# their first run on the card, from the bayes phase's 55-step ChEES
# transition (1.1e-4) and HMC's check: every chain must agree, take the
# same accept decision, and PT's sweep the same swaps.  In that run 30 of
# PT's 32 chains agreed (2.7e-4) and two parted by 3.0 (PERF.md, PR 11), so
# the sweep also runs on the plain route in f64: a chain on which the plain
# f32 route itself parts from f64 beyond the bounds is reported, not held.
PT_CHECK_BOUNDS = {"position_atol": 5e-3, "logp_rtol": 1e-3, "accept_atol": 5e-2}
GHMC_CHECK_CHAINS = 64
GHMC_CHECK_BOUNDS = {"position_atol": 1e-4, "logp_rtol": 1e-4, "accept_atol": 1e-2}
# The K7 shapes of the samplers path, by run: the chains, rungs x ladders,
# arms x chains, draws or particles of one batched value and gradient.
SAMPLER_K7 = {"nuts": ("hyperpriors", 4), "hmc": ("hyperpriors", 4), "pt_chees": ("hyperpriors", 32),
              "ghmc": ("hyperpriors", 4), "chees_pops": ("hyperpriors", BAYES_CHAINS),
              "chees_race": ("hyperpriors", 4 * BAYES_CHAINS), "pt_nuts": ("hyperpriors", 8),
              "advi": ("hyperpriors", 8), "advi_full": ("barebones", 8), "smc": ("barebones", 512)}


def pt_nuts_main(argv: list[str]) -> None:
    """``bayes.main``'s steps for ``tempering.run_pt_nuts``, which no
    command line runs on one device: the study's log-joint on the card's
    default route, one start as ``bayes.sample_posterior`` makes it (v0 +
    0.1 N(0, 1) on the free coordinates, seed + 1), the replicas' NUTS state
    on the host through ``bayes.on_host`` as ``bayes`` keeps NUTS's, then the
    mixture forecast over the cold chain's draws and the theta-mean line."""
    ap = argparse.ArgumentParser()
    ap.add_argument("study")
    ap.add_argument("--engine")
    ap.add_argument("--replicas", type=int)
    ap.add_argument("--warmup", type=int)
    ap.add_argument("--samples", type=int)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--platform", default=None)
    ap.add_argument("mode")
    args = ap.parse_args(argv)
    dev, host = tio.device_for(args.platform or "cuda"), torch.device("cpu")
    _, study, data = bayes.get_study(args.study)
    x, y = tio.load_csv(data)
    y_norm, mean_y, std_y = tio.normalize(y)
    logp, observed, v0, free = bayes.build_logjoint(study, x, y_norm, dev)
    g = torch.Generator(device=dev).manual_seed(args.seed + 1)
    x0 = v0 + 0.1 * torch.randn(v0.shape, generator=g, dtype=v0.dtype, device=dev) * free
    res = tempering.run_pt_nuts(bayes.on_host(logp, dev), x0.to(host), torch.Generator(device=host).manual_seed(
        args.seed), n_replicas=args.replicas, num_warmup=args.warmup, num_samples=args.samples, max_tree_depth=6,
                                free=free.to(host))
    draws = res.positions.to(dev)
    lo, hi = x[:, 0].min(), x[:, 0].max()
    z = np.linspace(lo, hi + (hi - lo), 50)[:, None]
    mu, sigma = bayes.mixture_forecast(study.gp, observed, draws, z)
    tio.write_forecast_rows(sys.stdout, [[z[i, 0], float("nan"), mu[i] * std_y + mean_y, sigma[i] * std_y]
                                         for i in range(z.shape[0])])
    theta_mean = torch.exp(draws[:, : study.gp.n_theta]).mean(0)
    print("# posterior theta mean: " + ",".join(f"{t:.6f}" for t in theta_mean.tolist()))


def run_engine(argv: list[str]) -> dict:
    """``bayes.main(argv)`` (``pt_nuts_main`` for the engine "pt-nuts") in
    process, its output captured, with the engine's run function wrapped to
    count its log-joint's calls and keep its result, and an MCMC engine's
    draws wrapped to read the host clock, after a synchronize, where
    sampling begins (after the race's probe with --race); for NUTS each
    transition's trees, for a race its statistics.  The launch counts are
    set to 0 just before ``bayes.main`` and read just after."""
    engine = argv[argv.index("--engine") + 1]
    module, name = SAMPLER_FNS[engine]
    if engine == "chees" and "--pops" in argv:
        name = "run_chees_pops"
    module = importlib.import_module(f"gogp_torch.infer.{module}")
    real, calls, mark, trace, shapes, results, races = getattr(module, name), [0], {}, [], set(), [], []

    def wrapped(logp, *args, **kwargs):
        def counted(V):
            calls[0] += 1
            shapes.add(tuple(V.shape))
            return logp(V)

        if engine == "nuts":
            kwargs["trace"] = trace
        if engine in SAMPLER_DRAWS:
            base, transitions = SAMPLER_DRAWS[engine], [0]
            start = kwargs["num_warmup"] + (kwargs["race_probe"] if kwargs.get("race") else 0)

            def draws(state):
                if transitions[0] == start:  # the first sampling transition
                    torch.cuda.synchronize()
                    mark.update(t=time.perf_counter(), calls=calls[0])
                transitions[0] += 1
                mark["transitions"] = transitions[0]
                return base(state)

            kwargs["draws"] = draws
        torch.cuda.synchronize()
        mark.update(t0=time.perf_counter())
        results.append(real(counted, *args, **kwargs))
        torch.cuda.synchronize()
        mark.update(t1=time.perf_counter())
        return results[-1]

    real_race = chees.chees_race

    def race(*args, **kwargs):
        out = real_race(*args, **kwargs)
        races.append(out[1])
        return out

    out = io.StringIO()
    main = pt_nuts_main if engine == "pt-nuts" else bayes.main
    torch.cuda.synchronize()
    with (contextlib.redirect_stdout(out), unittest.mock.patch.object(module, name, wrapped),
          unittest.mock.patch.object(chees, "chees_race", race)):
        cb.reset_launch_counts()
        t0 = time.perf_counter()
        main(argv)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = cb.LAUNCHES["fused_gp_linv"]
    lines = out.getvalue().strip().splitlines()
    rows = np.array([[float(v) for v in line.split(",")] for line in lines[:-1]])
    return {"argv": argv, "wall_s": wall_s, "sampler_wall_s": mark["t1"] - mark["t0"], "k7_launches": launches,
            "vg_calls": calls[0], "batch_shapes": sorted(shapes), "trace": trace, "mark": mark,
            "result": results[0], "races": races, "theta_mean_line": lines[-1], "forecast_rows": list(rows.shape),
            "forecast_ok": bool(rows.shape == (50, 4) and np.isfinite(rows[:, [0, 2, 3]]).all()
                                and (rows[:, 3] > 0).all() and lines[-1].startswith("# posterior theta mean: "))}


def chains_report(samples) -> dict:
    """Each chain's adapted step size and posterior mean, and the
    diagnostics over the chains, of an HMC or NUTS run."""
    summ = _posterior_summary(samples.positions)
    return {"step_size": samples.state.step_size.tolist(),
            "chain_mean": samples.positions.double().mean(0).tolist(),
            "mean_accept_sampling": float(samples.accept_probs.mean()),
            "min_bulk_ess": summ["min_bulk_ess"], "max_bulk_rhat": summ["max_bulk_rhat"],
            "posterior_mean": summ["mean"].tolist()}


def nuts_report(run: dict) -> dict:
    """The NUTS run's trees, times and diagnostics."""
    trace, mark, samples = run["trace"], run["mark"], run["result"]
    warmup = len(trace) - samples.positions.shape[0]
    sampling = trace[warmup:]
    leap = [t.leapfrogs for t in trace]
    depths = torch.stack([t.depth for t in trace]).cpu()
    spread = (depths.max(1).values - depths.min(1).values).double()
    walls = {"init_and_warmup": mark["t"] - mark["t0"], "sampling": mark["t1"] - mark["t"]}
    chains = chains_report(samples)
    return {"chains": samples.positions.shape[1], "warmup": warmup, "samples_per_chain": len(sampling),
            "leapfrogs_per_transition": {"median": statistics.median(leap), "max": max(leap),
                                         "sampling_median": statistics.median([t.leapfrogs for t in sampling])},
            "tree_depth": {"median": float(depths.double().median()), "max": int(depths.max()),
                           "spread_mean": float(spread.mean()), "spread_max": int(spread.max())},
            # the share of the batch's leapfrog steps that a chain spent frozen
            "lockstep_idle_share": 1.0 - float(torch.stack([t.num_leaves for t in trace]).double().mean())
                                   / statistics.mean(leap),
            "divergences_sampling": int(sum(int(t.diverging.sum()) for t in sampling)),
            "wall_s": walls,
            "vg_calls_by_stage": {"init_and_warmup": mark["calls"], "sampling": run["vg_calls"] - mark["calls"]},
            "ms_per_transition": 1e3 * sum(walls.values()) / len(trace),
            "ms_per_transition_sampling": 1e3 * walls["sampling"] / len(sampling),
            "ms_per_vg": 1e3 * sum(walls.values()) / run["vg_calls"],
            **chains,
            "ess_per_s_sampling": chains["min_bulk_ess"] / walls["sampling"],
            "ess_per_s_total": chains["min_bulk_ess"] / sum(walls.values())}


def mcmc_report(run: dict) -> dict:
    """An MCMC run's walls, calls, transitions, diagnostics and ESS/s (over
    the sampling wall and over the whole run).  PT's draws are its cold
    chains' (one a ladder), GHMC's every transition's."""
    mark, res = run["mark"], run["result"]
    pos = res.positions if res.positions.dim() == 3 else res.positions[:, None]
    walls = {"init_and_warmup": mark["t"] - mark["t0"], "sampling": mark["t1"] - mark["t"]}
    summ = _posterior_summary(pos)
    return {"transitions": mark["transitions"], "wall_s": walls,
            "vg_calls_by_stage": {"init_and_warmup": mark["calls"], "sampling": run["vg_calls"] - mark["calls"]},
            "vg_per_transition": run["vg_calls"] / mark["transitions"],
            "ms_per_transition": 1e3 * sum(walls.values()) / mark["transitions"],
            "ms_per_vg": 1e3 * sum(walls.values()) / run["vg_calls"],
            "draws": list(pos.shape), "min_bulk_ess": summ["min_bulk_ess"], "max_bulk_rhat": summ["max_bulk_rhat"],
            "posterior_mean": summ["mean"].tolist(), "ess_per_s_sampling": summ["min_bulk_ess"] / walls["sampling"],
            "ess_per_s_total": summ["min_bulk_ess"] / sum(walls.values()),
            "draws_finite": bool(torch.isfinite(res.positions).all())}


def engine_report(label: str, run: dict) -> dict:
    """What each new engine's run adds: PT's flow, ladder and each cold
    chain's mean of the period coordinate v[4]; GHMC's step, damping and
    acceptance; the race's candidates, scores, costs and winner; each
    population's step and trajectory.  ``final``: the plain values of the
    final state that the one-transition checks start from."""
    res = run["result"]
    state = res.state
    if label in ("pt_chees", "pt_nuts"):
        pos = res.positions if res.positions.dim() == 3 else res.positions[:, None]
        out = {"round_trips": int(res.round_trips), "swap_rate": float(res.swap_rate),
               "pair_rej": res.pair_rej.tolist(), "barrier": float(res.barrier), "betas": res.betas.tolist(),
               "cold_chain_mean_v4": pos[..., 4].double().mean(0).tolist(),
               "cold_chain_mean": pos.double().mean(0).tolist()}
        if label == "pt_nuts":
            return {**out, "step_size": state.step_size.tolist()}
        return {**out, "step_size": state.step_size.tolist(), "traj_length": torch.exp(state.log_traj).tolist(),
                "mean_accept_sampling": float(state.accept_probs.mean()),
                "final": {"betas": res.betas.tolist(), "positions": state.positions.tolist(),
                          "step_size": state.step_size.tolist(), "log_traj": state.log_traj.tolist(),
                          "inv_mass": state.inv_mass.tolist(), "step": state.step}}
    if label == "ghmc":
        return {"step_size": float(state.step_size), "damping": float(ghmc._damping(state)),
                "sigma": state.sigma.tolist(), "mean_accept_sampling": float(res.accept_probs.mean()),
                "final": {"step_size": float(state.step_size), "sigma": state.sigma.tolist()}}
    out = {"mean_accept_sampling": float(res.accept_probs.mean()), "step_size": state.step_size.tolist(),
           "traj_length": torch.exp(state.log_traj).tolist()}
    if label == "chees_race":
        info = run["races"][0]
        out["race"] = {"candidates_traj_length": torch.exp(info["candidates_log_traj"]).tolist(),
                       "norm_esjd": info["norm_esjd"].tolist(), "probe_min_ess": info["probe_min_ess"].tolist(),
                       "leapfrog_cost": info["leapfrog_cost"].tolist(), "score": info["score"].tolist(),
                       "winner": info["winner"]}
    return out


def sampler_run(label: str, argv: list[str]) -> dict:
    """One run of the samplers path in this process, reduced to what the
    phase reports and checks (plain values, so that a worker process can
    hand it back): K7's launches in the run, and for NUTS and HMC each
    chain's adapted step size and inverse mass."""
    run = run_engine(argv)
    report = {"phase": "samplers", "run": label, "argv": run["argv"], "main_wall_s": run["wall_s"],
              "sampler_wall_s": run["sampler_wall_s"], "vg_calls": run["vg_calls"],
              "batch_shapes": run["batch_shapes"], "k7_launches": run["k7_launches"],
              "ms_per_vg": 1e3 * run["sampler_wall_s"] / max(run["vg_calls"], 1),
              "forecast_ok": run["forecast_ok"], "forecast_rows": run["forecast_rows"],
              "theta_mean_line": run["theta_mean_line"]}
    samples = run["result"]
    if label in ("nuts", "hmc"):
        report.update(nuts_report(run) if label == "nuts" else chains_report(samples),
                      draws_finite=bool(torch.isfinite(samples.positions).all()),
                      inv_mass=samples.state.inv_mass.tolist())
    elif label in ("pt_chees", "ghmc", "chees_pops", "chees_race", "pt_nuts"):
        report.update(mcmc_report(run), **engine_report(label, run))
    return report


def sampler_worker(label: str, argv: list[str]) -> dict:
    """:func:`sampler_run` in a worker process (spawned: it sets up the card
    as the main process does and loads the kernels the main process built)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    report = sampler_run(label, argv)
    torch.cuda.synchronize()
    return report


def fixed_nuts_draws(seed: int):
    """NUTS draws that depend only on (seed, depth, leaf) and the device:
    the same on both routes and in every call."""

    def draws(state):
        chains, dim = state.position.shape
        like = dict(dtype=state.position.dtype, device=state.position.device)

        def gen(*key):
            return torch.Generator(device=like["device"]).manual_seed(hash((seed, *key)) % 2**31)

        return nuts.NUTSDraws(torch.randn((chains, dim), generator=gen(-1), **like),
                              lambda d: torch.rand((chains,), generator=gen(-2, d), **like) < 0.5,
                              lambda d: torch.rand((chains,), generator=gen(-3, d), **like),
                              lambda d, n: torch.rand((chains,), generator=gen(d, n), **like))

    return draws


def state_to(state: hmc.HMCState, device) -> hmc.HMCState:
    """An HMCState on ``device`` (a new generator there)."""
    moved = [v.to(device) if isinstance(v, torch.Tensor) else type(v)(*(t.to(device) for t in v))
             for v in state[:-1]]
    return hmc.HMCState(*moved, torch.Generator(device=device).manual_seed(0))


def nuts_placement(logp, free, start: hmc.HMCState, dev, pairs: int = 4, transitions: int = 4) -> dict:
    """ms per leapfrog step of NUTS transitions from ``start`` with the
    sampler's state on the card, and on the host as ``bayes`` keeps it
    (``bayes.on_host``: each batch copied to the card, its value and
    gradient back in one copy), in ``pairs`` pairs whose order alternates;
    beside one batched value and gradient alone."""
    ms = {"card": [], "host": []}
    for i in range(pairs):
        for where in ("card", "host") if i % 2 == 0 else ("host", "card"):
            device = dev if where == "card" else torch.device("cpu")
            lp = logp if where == "card" else bayes.on_host(logp, dev)
            state, fr, trace = state_to(start, device), free.to(device), []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for k in range(transitions):
                state = nuts.nuts_transition(lp, state, 10, fr, fixed_nuts_draws(10 + k), trace)
            torch.cuda.synchronize()
            ms[where].append(1e3 * (time.perf_counter() - t0) / sum(t.leapfrogs for t in trace))
    vg = hmc.value_and_grad(logp, free)
    return {"chains": start.position.shape[0], "pairs": pairs, "transitions": transitions,
            "ms_per_leapfrog": ms, "host_over_card": [h / c for h, c in zip(ms["host"], ms["card"])],
            "vg_alone_ms": wall_ms(lambda: vg(start.position), reps=20)}


def transition_agreement(k7, plain, bounds: dict = SAMPLER_BOUNDS) -> tuple[dict, int]:
    """Per chain, the two routes' (positions (chains, dim), log-joints,
    acceptance probabilities) against ``bounds``: the largest errors over
    the chains that agree and over all, and how many agree."""
    errs = {"position": (k7[0] - plain[0]).abs().amax(1), "logp_rel": (k7[1] - plain[1]).abs() / plain[1].abs(),
            "accept": (k7[2] - plain[2]).abs()}
    ok = ((errs["position"] <= bounds["position_atol"]) & (errs["logp_rel"] <= bounds["logp_rtol"])
          & (errs["accept"] <= bounds["accept_atol"]))
    report = {"chains_agreeing": int(ok.sum()), "chains": int(ok.numel()), "bounds": bounds,
              "max_err_agreeing": {k: float(v[ok].max()) if ok.any() else None for k, v in errs.items()},
              "max_err_all": {k: float(v.max()) for k, v in errs.items()},
              "mean_accept": float(k7[2].mean())}
    return report, int(ok.sum())


def hmc_rows(state: hmc.HMCState) -> tuple:
    return state.position, state.logp, state.accept_prob


def pt_chees_check(logp, plain_logp, plain64_logp, free, final: dict, dev) -> tuple[dict, list]:
    """One PT-ChEES sweep (every rung's transition, then the swap) of the
    pt_chees run's final state with the same draws on the K7 route and the
    plain route in f32 and on the plain route in f64: each of the 32
    chains' positions, raw log-joints and acceptance against
    PT_CHECK_BOUNDS, the accept decisions and the swaps.  A chain on which
    the plain f32 route itself parts from f64 beyond the bounds is one whose
    trajectory f32 rounding decides (a hot rung's wide target reaches
    covariances that f32 cannot factor closely): it is reported, with both
    f32 routes' errors against f64, and the routes are held to each other
    on every other chain."""
    betas = torch.tensor(final["betas"], device=dev)
    pos = torch.tensor(final["positions"], device=dev)
    K, L, _ = pos.shape
    # an odd halton index: a jitter of at least half the adapted trajectory
    # (the final state's own index, 528, gives 3%)
    params = dict(step_size=torch.tensor(final["step_size"], device=dev),
                  log_traj=torch.tensor(final["log_traj"], device=dev),
                  inv_mass=torch.tensor(final["inv_mass"], device=dev), step=final["step"] | 1)
    start = chees.chees_init(tempering.tempered(logp, betas.repeat_interleave(L)), pos,
                             torch.Generator(device=dev).manual_seed(0), free=free)._replace(**params)
    fixed = chees.generator_draws(start._replace(rng=torch.Generator(device=dev).manual_seed(8)))
    u_swap = torch.rand((L, K), generator=torch.Generator(device=dev).manual_seed(9), device=dev)
    start64 = chees.chees_init(tempering.tempered(plain64_logp, betas.double().repeat_interleave(L)), pos.double(),
                               start.rng, free=free.double())
    start64 = start64._replace(**{k: v.double() if isinstance(v, torch.Tensor) else v for k, v in params.items()})
    out, fracs = {}, {}
    for label, lp, s0, d, u, b, fr in (
            ("k7", logp, start, fixed, u_swap, betas, free), ("plain", plain_logp, start, fixed, u_swap, betas, free),
            ("plain64", plain64_logp, start64, tuple(t.double() for t in fixed), u_swap.double(), betas.double(),
             free.double())):
        s, _, _, frac, _ = pt_chees.pt_chees_sample_chunk(lp, s0, b, 1, 0, free=fr, draws=lambda s, d=d: d,
                                                          swap_draws=lambda s, u=u: u)
        out[label] = (s.positions.reshape(K * L, -1).double(), (s.logps / b[:, None]).reshape(-1).double(),
                      s.accept_probs.reshape(-1).double())
        fracs[label] = float(frac[0])
    report, _ = transition_agreement(out["k7"], out["plain"], PT_CHECK_BOUNDS)
    agree = {pair: transition_agreement(out[a], out[b], PT_CHECK_BOUNDS)[0]
             for pair, (a, b) in (("k7_f64", ("k7", "plain64")), ("plain_f64", ("plain", "plain64")))}

    def ok(a, b):
        errs = ((out[a][0] - out[b][0]).abs().amax(1), (out[a][1] - out[b][1]).abs() / out[b][1].abs(),
                (out[a][2] - out[b][2]).abs())
        return ((errs[0] <= PT_CHECK_BOUNDS["position_atol"]) & (errs[1] <= PT_CHECK_BOUNDS["logp_rtol"])
                & (errs[2] <= PT_CHECK_BOUNDS["accept_atol"]))

    held = ok("plain", "plain64")  # the chains f32 can reproduce
    routes = ok("k7", "plain")
    u_acc = fixed[1].reshape(-1).double()
    same = bool(torch.equal((u_acc < out["k7"][2])[held], (u_acc < out["plain"][2])[held]))
    apart = (~held).nonzero().flatten().tolist()
    report.update(same_accept_decisions_where_f32_holds=same, swap_fraction=fracs,
                  leapfrog_steps=chees.n_leapfrog_steps(start)[0], chains_shape=[K, L], against_f64=agree,
                  f32_apart_from_f64={"chains": apart, "rungs": [c // L for c in apart],
                                       "k7_position_err": [float((out["k7"][0][c] - out["plain64"][0][c]).abs().max())
                                                           for c in apart],
                                       "plain_position_err": [float((out["plain"][0][c] - out["plain64"][0][c])
                                                                    .abs().max()) for c in apart]})
    failures = []
    if not bool(routes[held].all()) or not same or fracs["k7"] != fracs["plain"]:
        failures.append(f"pt-chees sweep: {int(routes[held].sum())} of the {int(held.sum())} chains that f32 "
                        f"reproduces agree on the two routes (want all), same accept decisions: {same}, swap "
                        f"fractions {fracs}")
    return report, failures


def ghmc_check(logp, plain_logp, free, final: dict, dev) -> tuple[dict, list]:
    """One GHMC transition of GHMC_CHECK_CHAINS chains around v0 at the
    ghmc run's final step size and preconditioner, on both routes with the
    same draws, against GHMC_CHECK_BOUNDS."""
    start = ghmc.ghmc_init(logp, bayes_positions(GHMC_CHECK_CHAINS, dev, seed=4),
                           torch.Generator(device=dev).manual_seed(0))
    start = start._replace(step_size=torch.tensor(final["step_size"], device=dev),
                           sigma=torch.tensor(final["sigma"], device=dev))
    fixed = ghmc.generator_draws(start._replace(rng=torch.Generator(device=dev).manual_seed(8)))
    out = {label: ghmc.ghmc_transition(lp, start, free=free, draws=lambda s: fixed)
           for label, lp in (("k7", logp), ("plain", plain_logp))}
    rows = {label: (o.positions, o.logps, o.accept_probs) for label, o in out.items()}
    report, agree = transition_agreement(rows["k7"], rows["plain"], GHMC_CHECK_BOUNDS)
    same = bool(torch.equal(fixed[1] < out["k7"].accept_probs, fixed[1] < out["plain"].accept_probs))
    report["same_accept_decisions"] = same
    failures = []
    if agree < GHMC_CHECK_CHAINS or not same:
        failures.append(f"ghmc transition: {agree} chains agree on the two routes (want all), same accept "
                        f"decisions: {same}")
    return report, failures


def check_start(logp, free, chains: int, step: float, inv_mass: torch.Tensor, dev) -> hmc.HMCState:
    """``chains`` chains around v0 at one step size and inverse mass."""
    start = hmc.init_state(logp, bayes_positions(chains, dev, seed=4), torch.Generator(device=dev).manual_seed(0),
                           free=free)
    return start._replace(step_size=torch.full_like(start.step_size, step),
                          inv_mass=inv_mass.to(start.inv_mass).expand_as(start.inv_mass).clone())


def start_sampler_workers(lnbx_x0: list | None = None):
    """The SAMPLER_WORKERS runs of the samplers path, each in a worker
    process, SAMPLER_POOL at a time in SAMPLER_WORKERS' order, after (with
    ``lnbx_x0``, in a whole run) the bayes phase's plain-route command line,
    which that phase waits for, and the exact leg's sampler from
    ``lnbx_x0``: (the pool, {label: its pending report}, {"bayes_plain":
    ..., "lnbx": ...} pending or {})."""
    pool = multiprocessing.get_context("spawn").Pool(SAMPLER_POOL)
    argvs = dict(SAMPLER_RUNS)
    others = {} if lnbx_x0 is None else {"bayes_plain": pool.apply_async(bayes_plain_worker),
                                         "lnbx": pool.apply_async(lnbx_worker, (lnbx_x0,))}
    pending = {label: pool.apply_async(sampler_worker, (label, argvs[label])) for label in SAMPLER_WORKERS}
    return pool, pending, others


def sampler_runs_here() -> dict:
    """The samplers path's other runs, in this process: {label: report}."""
    return {label: sampler_run(label, argv) for label, argv in SAMPLER_RUNS if label not in SAMPLER_WORKERS}


def phase_samplers(dev) -> dict:
    pool, pending, _ = start_sampler_workers()
    with pool:
        return finish_samplers(dev, sampler_runs_here(), pending)


def finish_samplers(dev, here: dict, pending: dict) -> dict:
    """The samplers path once its runs in this process (``here``) are done:
    waits for the workers' runs (``pending``), checks and reports every
    run, then the one-transition check, NUTS's placement and K7 at each
    run's batch, which time the card with no worker running."""
    failures = []
    # the main path: each engine's command line, NUTS and HMC in worker
    # processes beside the others, each run's launches counted from 0
    reports = {**here, **{label: result.get() for label, result in pending.items()}}
    for label, argv in SAMPLER_RUNS:
        report = reports[label]
        want = 0 if bayes.get_study(argv[0])[1].optinp else report["vg_calls"]
        if report["k7_launches"] != want:
            failures.append(f"{label}: K7 launched {report['k7_launches']} times in {report['vg_calls']} log-joint "
                            f"calls (want {want})")
        if not report["forecast_ok"]:
            failures.append(f"{label}: not 50 finite forecast rows with sigma > 0 and the theta-mean line")
        if not report.get("draws_finite", True):
            failures.append(f"{label}: non-finite draws")
        if report.get("max_bulk_rhat") is not None and not np.isfinite(report["max_bulk_rhat"]):
            failures.append(f"{label}: non-finite R-hat")
        emit({**{k: v for k, v in report.items() if k not in ("inv_mass", "final")},
              "in_worker": label in SAMPLER_WORKERS})

    # the one-transition check: NUTS and HMC at SAMPLER_CHECK_CHAINS chains
    # from one state (around v0, at the NUTS run's median step size and mean
    # inverse mass), the same draws, on the K7 route and under force_plain;
    # NUTS with its state on the host, as bayes.main keeps it
    _, _, _, logp, _, _, free = bayes_problem(dev)
    plain_logp = bayes_problem(dev, plain=True)[3]
    plain64_logp = bayes_problem(dev, torch.float64, plain=True)[3]
    nuts_step = statistics.median(reports["nuts"]["step_size"])
    nuts_mass = torch.tensor(reports["nuts"]["inv_mass"]).mean(0)
    start = check_start(logp, free, SAMPLER_CHECK_CHAINS, nuts_step, nuts_mass, dev)
    hmc_draws = hmc.generator_draws(start._replace(rng=torch.Generator(device=dev).manual_seed(8)))
    host = torch.device("cpu")
    checks = {}
    for engine in ("nuts", "hmc"):
        out, traces = {}, {}
        for label, lp in (("k7", logp), ("plain", plain_logp)):
            traces[label] = []
            out[label] = (nuts.nuts_transition(bayes.on_host(lp, dev), state_to(start, host), free=free.to(host),
                                               draws=fixed_nuts_draws(7), trace=traces[label])
                          if engine == "nuts" else hmc.hmc_transition(lp, start, free=free, draws=lambda s: hmc_draws))
        checks[engine], agree = transition_agreement(hmc_rows(out["k7"]), hmc_rows(out["plain"]))
        if engine == "nuts":
            checks[engine]["leapfrogs"] = {label: t[0].leapfrogs for label, t in traces.items()}
            checks[engine]["chains_of_another_depth"] = int((traces["k7"][0].depth != traces["plain"][0].depth).sum())
            if not agree >= SAMPLER_BOUNDS["nuts_agree"]:
                failures.append(f"nuts transition: {agree} chains agree on the two routes, "
                                f"fewer than {SAMPLER_BOUNDS['nuts_agree']}")
        else:
            same = bool(torch.equal(hmc_draws[1] < out["k7"].accept_prob, hmc_draws[1] < out["plain"].accept_prob))
            checks[engine]["same_accept_decisions"] = same
            if agree < SAMPLER_CHECK_CHAINS or not same:
                failures.append(f"hmc transition: {agree} chains agree on the two routes (want all), "
                                f"same accept decisions: {same}")
    # the same for one PT-ChEES sweep of 32 chains and one GHMC transition of
    # 64, from the runs' final states
    checks["pt_chees"], failed = pt_chees_check(logp, plain_logp, plain64_logp, free, reports["pt_chees"]["final"],
                                                dev)
    failures += failed
    checks["ghmc"], failed = ghmc_check(logp, plain_logp, free, reports["ghmc"]["final"], dev)
    failures += failed
    chains = reports["nuts"]["chains"]
    emit({"phase": "samplers", "check": f"one transition of {SAMPLER_CHECK_CHAINS} chains on both routes (PT-ChEES "
                                        f"32, GHMC {GHMC_CHECK_CHAINS})", **checks,
          "nuts_placement": nuts_placement(logp, free, check_start(logp, free, chains, nuts_step, nuts_mass, dev),
                                           dev)})
    emit({"phase": "samplers", "comparison": "anynoise: HMC beside ADVI, posterior theta means",
          "hmc": reports["anynoise_hmc"]["theta_mean_line"], "advi": reports["anynoise_advi"]["theta_mean_line"]})

    # K7 against its plain version at the path's shapes
    cases = {}
    for label, (study_name, count) in SAMPLER_K7.items():
        _, study, data = bayes.get_study(study_name)
        K = bayes_covs(study, tio.load_csv(data)[0], bayes_positions(count, dev, seed=9)[:, :study.gp.n_theta])
        eye = torch.eye(K.shape[-1], dtype=K.dtype, device=dev)
        cases[f"samplers_{label}"] = (
            lambda K=K: fused_gp.fused_gp_linv(K), lambda K=K: fused_gp.linv_plain(K), K.shape, 50,
            lambda K=K, eye=eye: torch.linalg.solve_triangular(torch.linalg.cholesky(K), eye, upper=False))
    rows = check_k7(cases)
    if failures:
        raise AssertionError(f"samplers path: {failures}")
    return {"launches": {f"samplers_{label}": {"fused_gp_linv": reports[label]["k7_launches"]} for label in SAMPLER_K7},
            "rows": rows}


# The evaluate path: the reference's main entry point (tutorial.evaluate, the
# rolling forecast) on the five studies' selfcheck data at the configuration
# of tests/fixtures/forecast_*.csv (lbfgs, seed 0; events with EVAL_EVENTS)
# but EVAL_ITERS iterations, batched, on the card's default route in f32 (K7
# for the theta-only studies) against a float64 run on the card (the plain
# route); then barebones at EVAL_N points of bench.py's generator
# (bench.py:42-51), the widest series K7 takes: EVAL_N - 1 prefix fits in one
# (EVAL_N - 1, EVAL_N, EVAL_N) K7 batch per step, Adam EVAL_ADAM_ITERS steps
# and LBFGS EVAL_ITERS, on the K7 route and under force_plain.
EVAL_STUDIES = ("barebones", "hyperpriors", "warpedtime", "anynoise", "events")
EVAL_EVENTS = "1.0:1.0:0.5,4.2:6.7:0.25"
EVAL_ITERS, EVAL_ADAM_ITERS, EVAL_SEQ_ITERS, EVAL_N = 200, 200, 50, fused_gp.K7_MAX_N
# Bounds of the evaluate path (rows' relative LML as |a - b| / max(|b|, 1),
# mu and sigma absolute in the data's units), each about 10 times the largest
# an H100 showed (PERF.md; written before the first run as 1e-4, 1e-3, 1e-2
# and 1e-3):
# - "lml_eval": each row's f32 LML against f64 at the same parameters
#   (4.1e-4, anynoise);
# - "forecast": the f32 forecast (mu, sigma) against f64 at the same
#   parameters (1.6e-5, barebones at EVAL_N);
# - "lml_gap": how far below the f64 fit's LML the f32 fit ends, both scored
#   in f64 (3.4e-5, barebones at EVAL_N; f32 cannot reach the threshold
#   1e-6, below its resolution of the gradient, and most rows stall);
# - "below_start": how far below its own start the f32 fit ends, both scored
#   in f64 (a failed LBFGS search takes no step; 0 on the H100, set before
#   the first run as 4e-3, about the f32 LML's own error);
# - "sequential": the sequential run against the batched one, Adam
#   EVAL_SEQ_ITERS steps, f32, LML and parameters (1.5e-6).
# anynoise's fits part between any two roundings within 15 iterations (its
# Laplace noise puts a kink at every latent output, where line searches
# fail; tests/test_torch_evaluate.py), so its fit-to-fit gap is reported,
# not bounded (3.7e-2 and 1.0e-1 on the H100).
EVAL_BOUNDS = {"lml_eval": 4e-3, "forecast": 2e-4, "lml_gap": 4e-4, "below_start": 4e-3, "sequential": 1.5e-5}
EVAL_UNBOUNDED_GAP = ("anynoise",)


def eval_study(name: str):
    """(study, x, y) of a study's selfcheck data (events with EVAL_EVENTS)."""
    mod = importlib.import_module(f"gogp_torch.tutorial.{name}")
    study = mod.make_study(mod.parse_events(EVAL_EVENTS)) if name == "events" else mod.make_study()
    x, y = tio.load_csv(mod.selfcheck_data())
    return study, x, y


def eval_bench(n: int):
    """The barebones study on bench.py's generator at n points (raw y:
    evaluate normalises it)."""
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0, 100, (n, 1)), axis=0)
    y = np.sin(x[:, 0] / 3.0) + 0.1 * rng.normal(size=n)
    return importlib.import_module("gogp_torch.tutorial.barebones").make_study(), x, y


def eval_run(study, x, y, dev, dtype=torch.float32, **cfg) -> dict:
    """``evaluate`` once (batched unless cfg says otherwise), its host wall
    and the batched value-and-gradient calls it made."""
    calls = [0]
    real = tev.batched_value_and_grad

    def counted(*a, **k):
        vg = real(*a, **k)

        def call(V):
            calls[0] += 1
            return vg(V)

        return call

    config = tev.EvalConfig(seed=0, **{"alg": "lbfgs", "iters": EVAL_ITERS, **cfg})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with unittest.mock.patch.object(tev, "batched_value_and_grad", counted), \
            contextlib.redirect_stderr(io.StringIO()):
        res = tev.evaluate(study, x, y, config=config, device=dev, dtype=dtype)
    torch.cuda.synchronize()
    return {"result": res, "wall_s": time.perf_counter() - t0, "vg_calls": calls[0]}


def eval_rescore(study, res, dev, start: bool = False) -> dict:
    """The f64 LML and forecast (in the data's units) at a result's own
    parameters (with start, at its fits' starting points), every row, on
    the card."""
    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=torch.float64, device=dev)

    x, y, V, masks = t(res.x), t(res.y_norm), t(res.v0 if start else res.v_all), t(res.masks)
    priors = study.make_priors(res.x, res.y_norm) if study.make_priors else None
    with torch.no_grad():
        lml = torch.func.vmap(tev.prefix_logp(study, x, y, priors))(V, masks)
        mu, sigma = torch.func.vmap(tev._forecast_fn(study, x, y))(V, masks, x)
    return {"lml": lml.cpu().numpy(), "mu": mu.cpu().numpy() * res.std_y + res.mean_y,
            "sigma": sigma.cpu().numpy() * res.std_y}


def _rel_rows(a, b) -> np.ndarray:
    return np.abs(np.asarray(a) - np.asarray(b)) / np.maximum(np.abs(np.asarray(b)), 1.0)


def eval_compare(study, run32: dict, run64: dict, dev) -> dict:
    """The f32 run against the f64 one: the f32 rows against f64 at the f32
    parameters, the f32 fit's gap below the f64 fit (both scored in f64),
    the fits' straight differences, iterations and stalls."""
    r32, r64 = run32["result"], run64["result"]
    rows32, rows64 = np.asarray(r32.rows, dtype=np.float64), np.asarray(r64.rows, dtype=np.float64)
    at32 = eval_rescore(study, r32, dev)
    start = eval_rescore(study, r32, dev, start=True)["lml"]
    fitted = r32.iters > 0
    gap = (rows64[:, 5] - at32["lml"]) / np.maximum(np.abs(rows64[:, 5]), 1.0)
    below = (start - at32["lml"]) / np.maximum(np.abs(start), 1.0)
    return {
        "lml_eval": float(_rel_rows(rows32[:, 5], at32["lml"]).max()),
        "forecast": float(max(np.abs(rows32[:, 2] - at32["mu"]).max(), np.abs(rows32[:, 3] - at32["sigma"]).max())),
        "lml_gap": float(gap.max()), "lml_gap_min": float(gap.min()), "rows_lml_gap_over_1e-3": int((gap > 1e-3).sum()),
        "below_start": float(below.max()), "rows_below_start": int((below > 0).sum()),
        "fit_to_fit": {"lml": float(_rel_rows(rows32[:, 5], rows64[:, 5]).max()),
                       "mu": float(np.abs(rows32[:, 2] - rows64[:, 2]).max()),
                       "sigma": float(np.abs(rows32[:, 3] - rows64[:, 3]).max())},
        "iters_f32": {"median": float(np.median(r32.iters[fitted])), "max": int(r32.iters.max())},
        "iters_f64": {"median": float(np.median(r64.iters[fitted])), "max": int(r64.iters.max())},
        "stalled_f32": int(r32.stalled.sum()), "stalled_f64": int(r64.stalled.sum()),
        "finite": bool(np.isfinite(rows32[:, 2:6]).all() and (rows32[:, 3] >= 0).all()),
    }


def eval_batch(study, res, dev, dtype=torch.float32):
    """The batched value and gradient an evaluate run's fits take, and the
    fitted rows' parameters at the run's end: (vg, V)."""
    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=dev)

    priors = study.make_priors(res.x, res.y_norm) if study.make_priors else None
    vg = tev.batched_value_and_grad(study, t(res.x), t(res.y_norm), t(res.masks[1:]), priors)
    return vg, t(res.v_all[1:])


def eval_vg_ms(study, res, dev) -> dict:
    """Wall ms (median of 5, each ending in a synchronize) of one batched
    value and gradient of the run's fitted rows (at their fits' parameters)
    on the default route (K7 for a theta-only study) and under force_plain,
    f32."""
    out = {}
    x32 = torch.as_tensor(res.x, dtype=torch.float32, device=dev)
    for label, ctx in (("k7" if tev.takes_k7(study, x32) else "default", contextlib.nullcontext),
                       ("plain", linalg.force_plain)):
        with ctx():
            vg, V = eval_batch(study, res, dev)
            vg(V)
            out[label] = wall_ms(lambda: vg(V), reps=5)
    return out


def eval_k7_case(study, res, dev):
    """K7 on the fitted rows' first covariances (a theta-only study's
    jittered starting thetas, seed 0, each row under its mask), for
    check_kernel."""
    n, nts = res.x.shape[0], study.gp.n_theta_simil
    V = torch.as_tensor(0.1 * tev.jitter_draws(n, study.gp.n_theta, 0)[1:], dtype=torch.float32, device=dev)
    x = torch.as_tensor(res.x, dtype=torch.float32, device=dev)
    masks = torch.as_tensor(res.masks[1:], dtype=torch.float32, device=dev)
    K = torch.func.vmap(lambda v, m: core.masked_cov(study.gp, torch.exp(v[:nts]), torch.exp(v[nts:]), x, m))(
        V, masks).contiguous()
    eye = torch.eye(n, dtype=K.dtype, device=dev)
    return (lambda: fused_gp.fused_gp_linv(K), lambda: fused_gp.linv_plain(K), K.shape, 50,
            lambda: torch.linalg.solve_triangular(torch.linalg.cholesky(K), eye, upper=False))


def phase_evaluate(dev) -> dict:
    failures = []
    # the main path: every run the evaluate path makes on the card's default
    # route (f32), its launches counted from 0
    cb.reset_launch_counts()
    runs32, study_launches = {}, {}
    for name in EVAL_STUDIES:
        before = cb.LAUNCHES["fused_gp_linv"]
        runs32[name] = eval_run(*eval_study(name), dev)
        study_launches[name] = cb.LAUNCHES["fused_gp_linv"] - before
    bench = eval_bench(EVAL_N)
    wide = {alg: eval_run(*bench, dev, alg=alg, iters=EVAL_ADAM_ITERS if alg == "adam" else EVAL_ITERS)
            for alg in ("adam", "lbfgs")}
    launches = dict(cb.LAUNCHES)
    k7_calls = (sum(r["vg_calls"] for name, r in runs32.items() if not eval_study(name)[0].optinp)
                + sum(r["vg_calls"] for r in wide.values()))
    if launches["fused_gp_linv"] != k7_calls:
        failures.append(f"K7 launched {launches['fused_gp_linv']} times in {k7_calls} batched value-and-gradient "
                        "calls on the K7 route")

    # the references: f64 on the card (the plain route), and the plain route
    # in f32 (force_plain) at n = EVAL_N
    for name in EVAL_STUDIES:
        study, x, y = eval_study(name)
        run64 = eval_run(study, x, y, dev, dtype=torch.float64)
        cmp = eval_compare(study, runs32[name], run64, dev)
        report = {"phase": "evaluate", "study": name, "n": int(x.shape[0]), "rows_fitted": int(x.shape[0] - 1),
                  "alg": "lbfgs", "iters": EVAL_ITERS, "wall_s": {"f32": runs32[name]["wall_s"], "f64": run64["wall_s"]},
                  "vg_calls": runs32[name]["vg_calls"], "ms_per_vg": eval_vg_ms(study, runs32[name]["result"], dev),
                  **cmp, "bounds": EVAL_BOUNDS}
        emit(report)
        failures += [f"{name}: {k} {cmp[k]:.3e} > {EVAL_BOUNDS[k]}" for k in ("lml_eval", "forecast", "lml_gap", "below_start")
                     if not cmp[k] <= EVAL_BOUNDS[k] and not (k == "lml_gap" and name in EVAL_UNBOUNDED_GAP)]
        if not cmp["finite"]:
            failures.append(f"{name}: non-finite forecast rows")
    for alg, run32 in wide.items():
        iters = EVAL_ADAM_ITERS if alg == "adam" else EVAL_ITERS
        with linalg.force_plain():
            plain = eval_run(*bench, dev, alg=alg, iters=iters)
        run64 = eval_run(*bench, dev, dtype=torch.float64, alg=alg, iters=iters)
        cmp = eval_compare(bench[0], run32, run64, dev)
        emit({"phase": "evaluate", "study": "barebones", "data": "bench.py generator", "n": EVAL_N,
              "rows_fitted": EVAL_N - 1, "alg": alg, "iters": iters,
              "wall_s": {"k7_f32": run32["wall_s"], "plain_f32": plain["wall_s"], "f64": run64["wall_s"]},
              "vg_calls": {"k7_f32": run32["vg_calls"], "plain_f32": plain["vg_calls"]},
              "ms_per_vg": eval_vg_ms(bench[0], run32["result"], dev), **cmp, "bounds": EVAL_BOUNDS})
        failures += [f"barebones n={EVAL_N} {alg}: {k} {cmp[k]:.3e} > {EVAL_BOUNDS[k]}"
                     for k in ("lml_eval", "forecast", "lml_gap", "below_start") if not cmp[k] <= EVAL_BOUNDS[k]]

    # sequential against batched: barebones, Adam EVAL_SEQ_ITERS steps, f32
    study, x, y = eval_study("barebones")
    seq, bat = (eval_run(study, x, y, dev, alg="adam", iters=EVAL_SEQ_ITERS, batched=b) for b in (False, True))
    rs, rb = np.asarray(seq["result"].rows), np.asarray(bat["result"].rows)
    seq_err = float(max(_rel_rows(rs[:, 4:], rb[:, 4:]).max(), np.abs(seq["result"].v_all - bat["result"].v_all).max()))

    # one batched value and gradient: one K7 launch on the K7 route, none
    # under force_plain
    study, x, y = bench
    vg, V = eval_batch(study, wide["lbfgs"]["result"], dev)
    before = cb.LAUNCHES["fused_gp_linv"]
    vg(V)
    one_call = cb.LAUNCHES["fused_gp_linv"] - before
    with linalg.force_plain():
        vg_plain, _ = eval_batch(study, wide["lbfgs"]["result"], dev)
        before = cb.LAUNCHES["fused_gp_linv"]
        vg_plain(V)
        plain_call = cb.LAUNCHES["fused_gp_linv"] - before
    emit({"phase": "evaluate", "check": "launches", "main_path": launches, "k7_vg_calls": k7_calls,
          "one_batched_vg_k7_launches": {"k7_route": one_call, "force_plain": plain_call},
          "sequential_vs_batched": {"alg": "adam", "iters": EVAL_SEQ_ITERS, "max_err": seq_err,
                                    "bound": EVAL_BOUNDS["sequential"],
                                    "wall_s": {"sequential": seq["wall_s"], "batched": bat["wall_s"]}}})
    if (one_call, plain_call) != (1, 0):
        failures.append(f"one batched value-and-gradient launched K7 {one_call} times on the K7 route and "
                        f"{plain_call} under force_plain (want 1 and 0)")
    if not seq_err <= EVAL_BOUNDS["sequential"]:
        failures.append(f"sequential against batched: {seq_err:.3e} > {EVAL_BOUNDS['sequential']}")
    # the forecast CSV the command line prints (barebones, f32), read back
    # by tutorial.plot's loader (numpy only: the card's machine has no
    # matplotlib to plot it), row for row to the CSV's six decimals
    rows = np.asarray(runs32["barebones"]["result"].rows)
    buf = io.StringIO()
    tio.write_forecast_rows(buf, rows)
    buf.seek(0)
    fx, fy, fmu, fsd = plot.load_forecast(buf)
    csv_err = float(np.abs(np.stack([fx[:, 0], fy, fmu, fsd], 1) - rows[:, :4]).max()) if fx.shape == (
        rows.shape[0], 1) else float("inf")
    emit({"phase": "evaluate", "check": "forecast_csv", "study": "barebones", "rows": rows.shape[0],
          "max_abs_err": csv_err})
    if not csv_err <= 1e-6:
        failures.append(f"the forecast CSV read back by plot.load_forecast is {csv_err:.3e} off its rows")

    if failures:
        raise AssertionError(f"evaluate path: {failures}")
    # K7 at the path's shapes, the fits' first covariances: for check_k7
    k7_cases = {"evaluate": eval_k7_case(study, wide["lbfgs"]["result"], dev),
                "evaluate_hyperpriors": eval_k7_case(eval_study("hyperpriors")[0], runs32["hyperpriors"]["result"],
                                                     dev)}
    return {"launches": launches, "hyperpriors_launches": {"fused_gp_linv": study_launches["hyperpriors"]},
            "k7_cases": k7_cases, "batch": lambda: eval_batch(study, wide["lbfgs"]["result"], dev)}


def check_k7(cases: dict) -> dict:
    """K7 against its plain version on each path's case: {(path, key): row}."""
    return {(path, "fused_gp_linv"): check_kernel(path, "fused_gp_linv", *case, rtol=BAYES_BOUNDS["k7_rtol"])
            for path, case in cases.items()}


def _device_busy_us(events) -> float:
    """Length of the union of the device events' time intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, start, end = 0.0, None, None
    for s, e in spans:
        if end is None or s > end:
            busy += 0.0 if end is None else end - start
            start, end = s, e
        else:
            end = max(end, e)
    return busy + (0.0 if end is None else end - start)


def profile_once(fn) -> dict:
    """``fn()`` once (after a warm call) under torch.profiler: the host
    window, the device's busy time (the union of its kernels' intervals),
    the idle share, the device launches and the kernels with the most
    device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    window = max(e.time_range.end for e in host) - min(e.time_range.start for e in host)
    busy = _device_busy_us(device)
    kernels = [a for a in prof.key_averages() if a.device_type == torch.autograd.DeviceType.CUDA]
    top = sorted(kernels, key=lambda a: -a.self_device_time_total)[:10]
    return {"window_us": window, "device_busy_us": busy, "idle_share": 1.0 - busy / window,
            "device_launches": len(device),
            "top_us": {a.key[:60]: [a.self_device_time_total, a.count] for a in top}}


def phase_profile(slice_args32, train_args32, large_args32, bayes_logps, evaluate_batch) -> None:
    report = {"phase": "profile"}
    V = bayes_positions(BAYES_CHAINS, slice_args32[1].device, seed=4)
    vg, V = evaluate_batch()
    with linalg.force_plain():
        vg_plain, _ = evaluate_batch()
    runs = {"slice": (run_slice, slice_args32), "train_step": (value_and_grad_step, train_args32),
            "large_step": (value_and_grad_step, large_args32), "bayes_vg": (bayes_step, (*bayes_logps, V)),
            "evaluate_vg": (lambda: (vg_plain if linalg._FORCE_PLAIN else vg)(V), ())}
    for run, (fn, args) in runs.items():
        for label, ctx in (("kernels", contextlib.nullcontext), ("plain", linalg.force_plain)):
            with ctx():
                report[f"{run}_{label}"] = profile_once(lambda: fn(*args))
    emit(report)


# The tile body's stages as tile_common.cuh's TileStage numbers them.
TILE_STAGES = ("start", "load", "diagonal factor (warp 0)", "diagonal step", "diagonal inverse (warp 0)",
               "panel", "panel write", "update", "last inverse rows", "store")


# K5's stages under the same stamps (tril_inv_tile.cu), each with its block
# row as the panel.
K5_STAGES = ("start", "load, block row 0 in place", "-", "solve (warp 0)", "-", "products", "-",
             "right-hand sides", "rest of the solves, last block row stored, next block row in place", "store")


def stage_cycles(stamped, read_stamps, labels, launches: int) -> dict:
    """Runs ``stamped`` ``launches`` times, reading the (stage * 8 + panel,
    clock64()) pairs with ``read_stamps(buf, count)`` after each: the median
    cycles from each stamp to the next, labelled by the stage that ends
    there (``labels``) and its panel, their sums by stage, and the whole
    launch's cycles."""
    buf = torch.zeros(2 * 64, dtype=torch.int64, device="cuda")
    count = torch.zeros(1, dtype=torch.int32, device="cuda")
    runs = []
    for _ in range(launches):
        stamped()
        read_stamps(buf, count)
        pairs = buf[: 2 * int(count)].view(-1, 2).tolist()
        runs.append([(f"{labels[code // 8]}/{code % 8}", clock) for code, clock in pairs])
    names = [label for label, _ in runs[0]]
    if any([label for label, _ in run] != names for run in runs):
        raise AssertionError("a stamped kernel passed different stages in different launches")
    deltas = {names[i]: statistics.median(run[i][1] - run[i - 1][1] for run in runs) for i in range(1, len(names))}
    by_stage = {}
    for label, cycles in deltas.items():
        stage = label.split("/")[0]
        by_stage[stage] = by_stage.get(stage, 0) + cycles
    return {"total_cycles": statistics.median(run[-1][1] - run[0][1] for run in runs),
            "cycles_by_stage": by_stage, "cycles_to_each_stamp": deltas}


def phase_stamps(dev, launches: int = 20) -> None:
    """The tile kernels' stages on the serving path's first tile: K2 and K5
    built apart with -DGOGP_TILE_STAMPS (thread 0 records clock64() as it
    passes each stage), ``launches`` launches each, the median cycles from
    each stamp to the next (``stage_cycles``), with the stamped and normal
    kernels' device times; then K4's chain step (``chain_stamps``).  In no
    whole run; the normal build records nothing."""
    import ctypes

    lib_path = _build.build(defines=("GOGP_TILE_STAMPS",), sources=("chol_inv_tile.cu", "tril_inv_tile.cu"))
    lib = ctypes.CDLL(str(lib_path))
    for name in ("gogp_chol_inv_tile", "gogp_chol_inv_tile_stamps", "gogp_tril_inv_tiles_split",
                 "gogp_tril_inv_tiles_stamps"):
        getattr(lib, name).argtypes = _build.SIGNATURES[name]
    gp, x, _, _, ts, tn, _ = problem(torch.float32, dev)
    tile = core.masked_cov(gp, ts, tn, x, None)[:BLOCK, :BLOCK].contiguous()
    L, V, W = torch.empty_like(tile), torch.empty_like(tile), torch.empty_like(tile)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def k2_stamped():
        _build.check(lib.gogp_chol_inv_tile(tile.data_ptr(), BLOCK, L.data_ptr(), BLOCK, V.data_ptr(), BLOCK,
                                            BLOCK, stream()), "stamped K2")

    def k5_stamped():  # one CTA, whose thread 0 alone stamps
        _build.check(lib.gogp_tril_inv_tiles_split(L.data_ptr(), W.data_ptr(), 1, BLOCK, 1, stream()), "stamped K5")

    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.split()[0]
    ptxas = ptxas_lines((lib_path.parent / "build.log").read_text().splitlines())
    k2 = stage_cycles(k2_stamped, lambda buf, count: _build.check(
        lib.gogp_chol_inv_tile_stamps(buf.data_ptr(), count.data_ptr(), stream()), "K2 stamps"), TILE_STAGES, launches)
    Lp, Vp = cb.cholesky_inv_tile_plain(tile)
    err = max(max_err(L, Lp)[1], max_err(V, Vp)[1])
    emit({"phase": "stamps", "kernel": "K2", "tile": list(tile.shape), "launches": launches, "max_rel_err": err,
          **k2, "max_sm_mhz": float(mhz), "stamped_ms": event_ms(k2_stamped, 50),
          "k2_ms": event_ms(lambda: cb.cholesky_inv_tile(tile), 50), "ptxas": ptxas})
    if not err <= KERNEL_RTOL:
        raise AssertionError(f"the stamped tile body disagrees with its plain version ({err:.3e})")
    k5 = stage_cycles(k5_stamped, lambda buf, count: _build.check(
        lib.gogp_tril_inv_tiles_stamps(buf.data_ptr(), count.data_ptr(), stream()), "K5 stamps"), K5_STAGES, launches)
    err = max_err(W, cb.tril_inv_tile_plain(L))[1]
    emit({"phase": "stamps", "kernel": "K5", "tile": list(tile.shape), "launches": launches, "max_rel_err": err,
          **k5, "max_sm_mhz": float(mhz), "stamped_ms": event_ms(k5_stamped, 50),
          "k5_ms": event_ms(lambda: k5_split(L[None], 1), 50)})
    if not err <= KERNEL_RTOL:
        raise AssertionError(f"the stamped K5 disagrees with its plain version ({err:.3e})")
    chain_stamps(dev)


# The stages of K4's chain item (trsv2d.cu, ChainStage), each named by what
# ends at its stamp.
CHAIN_STAGES = ("start", "partial sums (wait for done, read the slots)", "spin (wait for ready)", "barrier",
                "product", "reduce (resid -= product) and barrier", "diagonal apply and store", "barrier", "release")
MAX_STAMP_ROWS = 512


def chain_stamps(dev, n: int = N_LARGE, launches: int = 5) -> None:
    """K4's chain step on a synthetic factor at size n: trsv2d.cu built apart
    with -DGOGP_TRSV_STAMPS (thread 0 of each chain item records clock64()
    and %globaltimer as it passes each stage), ``launches`` launches each
    way.  Over the step rows 8 <= r < nb - 8 and the launches, the median
    cycles of each stage, the hand-off (release of row r - 1 to ready seen
    in row r) and the chain step (release to release) in ns, with the
    stamped and normal K4's device times."""
    import ctypes

    lib_path = _build.build(defines=("GOGP_TRSV_STAMPS",), sources=("trsv2d.cu",))
    lib = ctypes.CDLL(str(lib_path))
    for name in ("gogp_trsv2d_lower", "gogp_trsv2d_lower_t", "gogp_trsv2d_stamps"):
        getattr(lib, name).argtypes = _build.SIGNATURES[name]
    L, invs, y = synthetic_factor(n, dev)
    nb = n // BLOCK
    buf = torch.zeros(MAX_STAMP_ROWS * len(CHAIN_STAGES) * 2, dtype=torch.int64, device=dev)
    for direction, entry, plain, wrapper in (
            ("forward", lib.gogp_trsv2d_lower, cb.trsv_lower_plain, cb.trsv2d_lower),
            ("transpose", lib.gogp_trsv2d_lower_t, cb.trsv_lower_t_plain, cb.trsv2d_lower_t)):
        x = torch.empty_like(y)
        counters = torch.empty(1 + 2 * nb, dtype=torch.int32, device=dev)
        partial = torch.empty(nb * (nb + 1) // 2 * BLOCK, device=dev)

        def stamped():
            _build.check(entry(L.data_ptr(), y.data_ptr(), invs.data_ptr(), x.data_ptr(), counters.data_ptr(),
                               partial.data_ptr(), n, BLOCK, torch.cuda.current_stream().cuda_stream), "stamped K4")

        runs = []
        for _ in range(launches):
            stamped()
            _build.check(lib.gogp_trsv2d_stamps(buf.data_ptr(), torch.cuda.current_stream().cuda_stream), "K4 stamps")
            runs.append(buf.view(MAX_STAMP_ROWS, len(CHAIN_STAGES), 2)[:nb].cpu().numpy())
        err = max_err(x, plain(L, y))[1]
        rows = range(8, nb - 8)
        cycles = {f"{s}. {CHAIN_STAGES[s]}": statistics.median(
            float(st[r, s, 0] - st[r, s - 1, 0]) for st in runs for r in rows) for s in range(1, len(CHAIN_STAGES))}
        seen, released = CHAIN_STAGES.index("spin (wait for ready)"), len(CHAIN_STAGES) - 1
        emit({"phase": "stamps", "kernel": "K4 chain step", "direction": direction, "n": n, "launches": launches,
              "rows": [rows.start, rows.stop], "max_rel_err": err, "median_cycles_by_stage": cycles,
              "median_handoff_ns": statistics.median(
                  float(st[r, seen, 1] - st[r - 1, released, 1]) for st in runs for r in rows),
              "median_chain_step_ns": statistics.median(
                  float(st[r, released, 1] - st[r - 1, released, 1]) for st in runs for r in rows),
              "median_step_cycles_in_item": statistics.median(
                  float(st[r, released, 0] - st[r, seen, 0]) for st in runs for r in rows),
              "stamped_ms": event_ms(stamped, 10), "k4_ms": event_ms(lambda: wrapper(L, y, invs, BLOCK), 10),
              "ptxas": ptxas_lines((lib_path.parent / "build.log").read_text().splitlines())})
        if not err <= 1e-4:
            raise AssertionError(f"the stamped K4 ({direction}) disagrees with solve_triangular ({err:.3e})")


# ---------------------------------------------------------------------------
# The serving caches (gp.serve, gp.streaming, gp.model_selection) and GP
# classification (gp.laplace, gp.ep, the classify study)
# ---------------------------------------------------------------------------

# The serving-cache path, on the slice's problem (n = 4096, m = 1024): the
# joint covariance and the draws at M_COV points, the mixture of MIX_DRAWS
# log-theta draws 0 + 0.1 N(0, 1) (numpy seed MIX_SEED), the stream in
# appends of STREAM_B points into a capacity-N posterior.
M_COV, MIX_DRAWS, MIX_SEED, STREAM_B, SAMPLES = 256, 8, 1, 128, 4
# serve_sample's jitter, relative to the mean variance + 1: the joint
# covariance of M_COV points 0.39 apart under a unit lengthscale is singular
# to f32's precision, where the default 1e-8 leaves it (NaN draws, as in the
# JAX twin).
SAMPLE_JITTER = 1e-4
# Bounds of the serving-cache path (f32 kernel path) against the f64 plain
# path on the card.  Set before its first run on the card (pred, cov,
# mixture, stream_chol 1e-4, tf32 1e-1, sample 1e-2, stream_alpha 1e-3, loo
# total 1e-4, loo mu 1e-3), then to about 10 times what an H100 showed
# (PERF.md).
SERVE_CACHE_BOUNDS = {
    "pred_atol": 1.5e-5,  # serve_predict and serve_predict_y, mean and std, at ACCURATE_PRECISION (1.4e-6)
    "tf32_atol": 2.5e-2,  # the same under "tensorfloat32" (sigma 2.5e-3)
    "cov_atol": 5e-6,  # serve_predict_cov's covariance (5.4e-7)
    "sample_atol": 2e-3,  # serve_sample on the same normals (1.7e-4)
    "mixture_atol": 1.5e-5,  # serve_predict_mixture against gp.core.predict_mixture in f64 (1.4e-6)
    "stream_chol_atol": 2.5e-5,  # absorb_stream's factor against one absorb in f64 (2.5e-6)
    "stream_alpha_rtol": 5e-5,  # its alpha, relative to the largest entry (4.5e-6)
    "loo_total_rtol": 5e-7,  # loo_from_posterior's total (4.1e-8)
    "loo_mu_atol": 2e-5,  # its means (1.6e-6)
}
# The classification path: binary labels y = 1[sin(x/3) + 0.3 N(0, 1) > 0]
# on the slice's inputs (numpy seed 0), n = 4096, rbf.scaled() at log-theta
# 0 (jitter-only noise), bernoulli_logit, probabilities at m = 1024 points.
CLASSIFY_NOISE = 0.3
# Set before the first run on the card (f 1e-2, lml 1e-4, grad 1e-2, prob
# 1e-3, serve 1e-4, study 5e-3), then to about 10 times what an H100 showed
# (PERF.md).
CLASSIFY_BOUNDS = {
    "f_atol": 1e-4,  # the Laplace mode (1.1e-5)
    "lml_rtol": 1e-6,  # laplace_lml and ep_lml values (9.0e-8, 4.8e-8)
    "grad_rtol": 1e-5,  # their gradients, relative to the largest entry (7.8e-8, 8.0e-7)
    "prob_atol": 5e-5,  # class probabilities, served and predicted, against f64 (4.0e-6, 2.4e-6)
    "serve_atol": 2e-6,  # served probabilities against the same path's laplace/ep_predict_prob, f32 both (1.2e-7)
    "study_p_atol": 4e-3,  # the classify study's p_hat, f32 against f64 (laplace 3.3e-4, ep 2.2e-7)
    # ess, on a row where the f32 and f64 chains took different slice
    # decisions: this many Monte Carlo standard errors of the difference
    # (each run's from its 4 chains' means, 3 degrees of freedom: t_3's
    # two-sided 1% point is 5.8)
    "study_p_se_ess": 6.0,
}
CLASSIFY_ENGINES = ("laplace", "ep", "ess")


def serve_extras(dtype, dev):
    """The serving-cache path's other inputs: the covariance points, the
    mixture's draws and the samples' normals (numpy, shared by both
    precisions)."""
    rng = np.random.default_rng(MIX_SEED)
    vs = 0.1 * rng.normal(size=(MIX_DRAWS, 3))
    eps = np.random.default_rng(2).normal(size=(SAMPLES, M_COV))

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    return t(np.linspace(0, 100, M_COV)), t(vs), t(eps)


def timed_call(walls: dict, name: str, fn, *a, **k):
    """``fn(*a, **k)``, its wall in ms (synchronized on both sides) stored
    as ``walls[name]``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*a, **k)
    torch.cuda.synchronize()
    walls[name] = (time.perf_counter() - t0) * 1e3
    return out


def run_serve_cache(gp, x, y, ts, tn, z, zc, vs, eps, precision=linalg.ACCURATE_PRECISION) -> dict:
    """The serving-cache path once through the front door."""
    walls = {}

    def timed(name, fn, *a, **k):
        return timed_call(walls, name, fn, *a, **k)

    sp = timed("fit_serving", serve.fit_serving, gp, ts, tn, x, y, precision=precision)
    out = {"predict": timed("serve_predict", serve.serve_predict, gp, sp, z, precision),
           "predict_y": serve.serve_predict_y(gp, sp, z, precision),
           "cov": serve.serve_predict_cov(gp, sp, zc, precision)[1],
           "sample": serve.serve_sample(gp, sp, zc, num_samples=SAMPLES, jitter=SAMPLE_JITTER, precision=precision,
                                         eps=eps)}
    sm = timed("compile_mixture", serve.compile_mixture, gp, vs, x, y, precision=precision)
    out["mixture"] = timed("serve_predict_mixture", serve.serve_predict_mixture, gp, sm, z, precision)
    steps = N // STREAM_B
    empty = streaming.streaming_posterior(gp, ts, tn, N, dtype=x.dtype, device=x.device)
    post = timed("absorb_stream", streaming.absorb_stream, gp, empty, x.view(steps, STREAM_B, 1),
                 y.view(steps, STREAM_B))
    out["stream"] = (post.chol, post.alpha)
    out["loo"] = timed("loo", lambda: model_selection.loo_from_posterior(core.absorb(gp, ts, tn, x, y)))
    out["walls_ms"] = walls
    return out


def phase_serve_cache(dev) -> dict:
    """gp.serve, gp.streaming and gp.model_selection at n = 4096 (the slice's
    problem): the f32 kernel path against the f64 plain path, sigma's error
    under both precisions, the cache against one TRSM per request, the
    stream's appends, K1 and K5 on this path."""
    gp, x, y, _, ts, tn, z = problem(torch.float32, dev)
    gp64, x64, y64, _, ts64, tn64, z64 = problem(torch.float64, dev)
    zc, vs, eps = serve_extras(torch.float32, dev)
    zc64, vs64, eps64 = serve_extras(torch.float64, dev)

    cb.reset_launch_counts()
    got = run_serve_cache(gp, x, y, ts, tn, z, zc, vs, eps)
    torch.cuda.synchronize()
    launches = dict(cb.LAUNCHES)

    with linalg.force_plain():
        ref = run_serve_cache(gp64, x64, y64, ts64, tn64, z64, zc64, vs64, eps64)
        ref_mixture = core.predict_mixture(gp64, vs64, x64, y64, z64)
        ref_absorb = core.absorb(gp64, ts64, tn64, x64, y64)
    tf32 = {"predict": serve.serve_predict(gp, serve.fit_serving(gp, ts, tn, x, y, precision="tensorfloat32"), z,
                                           "tensorfloat32")}
    steady = run_serve_cache(gp, x, y, ts, tn, z, zc, vs, eps)["walls_ms"]  # the same calls, warm
    torch.cuda.synchronize()

    def abs_err(a, b):
        return float((a.double() - b).abs().max())

    errors = {}
    for label, run in (("float32", got), ("tensorfloat32", tf32)):
        for name, g, r in zip(("mu", "sigma"), run["predict"], ref["predict"]):
            errors[f"predict_{name}_{label}"] = abs_err(g, r)
    for name, g, r in zip(("mu", "sigma"), got["predict_y"], ref["predict_y"]):
        errors[f"predict_y_{name}"] = abs_err(g, r)
    errors["cov"] = abs_err(got["cov"], ref["cov"])
    errors["sample"] = abs_err(got["sample"], ref["sample"])
    for name, g, r, w in zip(("mu", "sigma"), got["mixture"], ref_mixture, ref["mixture"]):
        errors[f"mixture_{name}"] = abs_err(g, r)
        errors[f"mixture_{name}_f64_cache_vs_predict_mixture"] = abs_err(w, r)
    errors["stream_chol"] = abs_err(got["stream"][0], ref_absorb.chol)
    errors["stream_alpha_rel"] = abs_err(got["stream"][1], ref_absorb.alpha) / float(ref_absorb.alpha.abs().max())
    errors["loo_total_rel"] = abs(float(got["loo"].total) - float(ref["loo"].total)) / abs(float(ref["loo"].total))
    errors["loo_mu"] = abs_err(got["loo"].mu, ref["loo"].mu)
    b = SERVE_CACHE_BOUNDS
    checks = {
        "predict_mu_float32": b["pred_atol"], "predict_sigma_float32": b["pred_atol"],
        "predict_y_mu": b["pred_atol"], "predict_y_sigma": b["pred_atol"],
        "predict_mu_tensorfloat32": b["tf32_atol"], "predict_sigma_tensorfloat32": b["tf32_atol"],
        "cov": b["cov_atol"], "sample": b["sample_atol"], "mixture_mu": b["mixture_atol"],
        "mixture_sigma": b["mixture_atol"], "stream_chol": b["stream_chol_atol"],
        "stream_alpha_rel": b["stream_alpha_rtol"], "loo_total_rel": b["loo_total_rtol"], "loo_mu": b["loo_mu_atol"],
    }
    failures = [k for k, bound_ in checks.items() if not errors[k] <= bound_]

    # one request batch of M points, three routes: the cache's matmul, one
    # blocked TRSM per request (K5 and GEMMs), the plain path's TRSM
    sp = serve.fit_serving(gp, ts, tn, x, y)
    post = core.absorb(gp, ts, tn, x, y)
    request_ms = {"serve_predict": wall_ms(lambda: serve.serve_predict(gp, sp, z)),
                  "serve_predict_tensorfloat32": wall_ms(lambda: serve.serve_predict(gp, sp, z, "tensorfloat32")),
                  "predict_from_posterior_kernels": wall_ms(lambda: core.predict_from_posterior(gp, post, z))}
    with linalg.force_plain():
        request_ms["predict_from_posterior_plain"] = wall_ms(lambda: core.predict_from_posterior(gp, post, z))
    fit_ms = {"fit_serving": wall_ms(lambda: serve.fit_serving(gp, ts, tn, x, y)),
              "absorb": wall_ms(lambda: core.absorb(gp, ts, tn, x, y))}

    # K1 and K5 at this path's shapes: the covariance, its factor's tiles
    K = core.masked_cov(gp, ts, tn, x, None)
    tiles = diag_tiles(cb.blocked_cholesky_invs(K, BLOCK)[0])
    rows = kernel_rows("serve_cache", K, tiles)
    steps = N // STREAM_B
    expect = {"fused_cholesky_invs": 1 + MIX_DRAWS + 1, "tril_inv_tile": 1 + MIX_DRAWS + steps + 1}
    emit({"phase": "serve_cache", "n": N, "m": M, "m_cov": M_COV, "mixture_draws": MIX_DRAWS,
          "stream_appends": steps, "stream_b": STREAM_B, "accurate_precision": linalg.ACCURATE_PRECISION,
          "bounds": SERVE_CACHE_BOUNDS, "errors": errors, "launches": launches, "launches_expected": expect,
          "walls_ms_main_run": got["walls_ms"], "walls_ms_second_run": steady,
          "ms_per_append": steady["absorb_stream"] / steps,
          "request_wall_ms": request_ms, "fit_wall_ms": fit_ms})
    if failures:
        raise AssertionError(f"serving caches disagree with the f64 plain path: {failures}")
    wrong = {k: launches[k] for k in launches if launches[k] != expect.get(k, 0)}
    if wrong:
        raise AssertionError(f"serve_cache launches {wrong}, expected {expect} and no other kernel")
    return {"launches": launches, "rows": rows}


def kernel_rows(path: str, K: torch.Tensor, tiles: torch.Tensor, stepwise: bool = False) -> dict:
    """K1 on ``K`` and K5 on ``tiles`` against their plain versions, as
    ``path`` gives them; with ``stepwise``, K1's row also times the stepwise
    driver on ``K``."""
    eye = torch.eye(BLOCK, dtype=K.dtype, device=K.device)

    def stepwise_ms():
        with cb.no_fused_whole():
            return cb.blocked_cholesky_invs(K)

    return {
        (path, "fused_cholesky_invs"): check_kernel(
            path, "fused_cholesky_invs", lambda: cb.fused_cholesky_invs(K), lambda: cb.fused_cholesky_invs_plain(K),
            K.shape, 20, lambda: torch.linalg.cholesky_ex(K), rtol=K1_RTOL,
            **({"stepwise_ms": stepwise_ms} if stepwise else {})),
        (path, "tril_inv_tile"): check_kernel(
            path, "tril_inv_tile", lambda: cb.tril_inv_tile(tiles), lambda: cb.tril_inv_tile_plain(tiles),
            tiles.shape, 20, lambda: torch.linalg.solve_triangular(tiles, eye, upper=False)),
    }


def classify_problem(dtype: torch.dtype, device):
    """Binary labels on the slice's inputs: y = 1[sin(x/3) + 0.3 N(0, 1) > 0]
    (numpy seed 0), rbf.scaled() at log-theta 0."""
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0, 100, (N, 1)), axis=0)
    y = (np.sin(x[:, 0] / 3.0) + CLASSIFY_NOISE * rng.normal(size=N) > 0).astype(np.float64)
    gp = GP(ndim=1, simil=rbf.scaled())

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return gp, t(x), t(y), t(np.ones(2)), t(np.zeros(0)), t(np.linspace(0, 100, M))


def run_classify(gp, x, y, ts, tl, z) -> dict:
    """Laplace and EP once each through the front door, each call timed."""
    lik = likelihoods.bernoulli_logit
    walls, out = {}, {}

    def timed(name, fn, *a, **k):
        return timed_call(walls, name, fn, *a, **k)

    def value_and_grad(lml_fn):
        tsg = ts.clone().requires_grad_(True)
        val = lml_fn(gp, lik, tsg, tl, x, y)
        (grad,) = torch.autograd.grad(val, tsg)
        return val.detach(), grad

    for name, mod, fit, lml, predict, compile_ in (
            ("laplace", laplace, laplace.laplace_fit, laplace.laplace_lml, laplace.laplace_predict_prob,
             laplace.compile_laplace_serving),
            ("ep", ep, ep.ep_fit, ep.ep_lml, ep.ep_predict_prob, ep.compile_ep_serving)):
        post = timed(f"{name}_fit", fit, gp, lik, ts, tl, x, y)
        value, grad = timed(f"{name}_lml_value_and_grad", value_and_grad, lml)
        sp = timed(f"compile_{name}_serving", compile_, gp, post)
        out[name] = {"post": post, "value": value, "grad": grad,
                     "served": timed(f"{name}_serve_predict_prob", laplace.serve_predict_prob, gp, lik, sp, tl, z),
                     "predicted": timed(f"{name}_predict_prob", predict, gp, lik, post, z)}
    out["walls_ms"] = walls
    return out


def run_classify_study(engine: str, dev, dtype) -> tuple[np.ndarray, float, tuple | None]:
    """The classify study (n = 40, --seed 0 --iters 60): in float32 through
    its command line, in float64 through ``evaluate_classify`` on the card.
    Returns (rows, wall seconds, and for ess the (x, ESSResult) of its
    ``run_ess_gp`` call, else None)."""
    captured = []
    run_ess_gp = elliptical.run_ess_gp

    def capture(*a, **k):
        res = run_ess_gp(*a, **k)
        captured.append((a[4], res))
        return res

    t0 = time.perf_counter()
    with unittest.mock.patch.object(elliptical, "run_ess_gp", capture):
        if dtype == torch.float32:
            with contextlib.redirect_stderr(io.StringIO()):
                rows = classify.main(["-e", engine, "--seed", "0", "--iters", "60", "selfcheck"],
                                     wtr=io.StringIO())
        else:
            x, y = tio.load_csv(classify.selfcheck_data())
            rows = classify.evaluate_classify(classify.make_gp(), likelihoods.bernoulli_logit, x, y,
                                              engine=engine, seed=0, iters=60, device=dev, dtype=dtype)
    torch.cuda.synchronize()
    return np.asarray(rows, dtype=np.float64), time.perf_counter() - t0, (captured[0] if captured else None)


def ess_chain_se(x: torch.Tensor, res: elliptical.ESSResult) -> np.ndarray:
    """Each row's Monte Carlo standard error of the ess study's p_hat: the
    spread of the probability each chain alone predicts, over sqrt(chains)."""
    gp, lik, chains = classify.make_gp(), likelihoods.bernoulli_logit, res.f.shape[1]
    ps = torch.stack([elliptical.ess_predict_prob(gp, lik, res._replace(f=res.f[:, c : c + 1]), x[:, None, :])[:, 0]
                      for c in range(chains)])
    return (ps.double().std(0) / chains**0.5).cpu().numpy()


def check_ess_study(r32: np.ndarray, r64: np.ndarray, cap32: tuple, cap64: tuple) -> tuple[dict, bool]:
    """The ess study in f32 against f64.  As in the JAX package, a row whose
    prior K does not factor in the working precision has NaN chains: p_hat
    must be NaN exactly on the rows whose f32 factor is not finite, and f64
    factors every row.  On the other rows the two runs share their draws
    (``generator_draws`` draws in f64): where every slice decision agrees
    (equal shrink counts) p_hat is held to rounding, ``study_p_atol``; where
    one flipped, the chains part, and it is held to ``study_p_se_ess``
    standard errors of the difference."""
    b = CLASSIFY_BOUNDS
    (x32, res32), (x64, res64) = cap32, cap64

    def factored(res):
        return torch.isfinite(torch.diagonal(res.chol, dim1=-2, dim2=-1)).all(-1).cpu().numpy()

    fin32, fin64 = factored(res32), factored(res64)
    same = (res32.shrinks == res64.shrinks).flatten(1).all(-1).cpu().numpy()
    se = np.hypot(ess_chain_se(x32, res32), ess_chain_se(x64, res64))
    dp = np.abs(r32[:, 2] - r64[:, 2])
    bound_ = np.where(same, b["study_p_atol"], np.maximum(b["study_p_atol"], b["study_p_se_ess"] * se))
    rows_ok = fin32 & (dp <= bound_)
    out = {"rows_factored_f32": int(fin32.sum()), "rows_factored_f64": int(fin64.sum()),
           "rows_decisions_agree": int((fin32 & same).sum()),
           "max_abs_dp_hat_decisions_agree": float(dp[fin32 & same].max(initial=0.0)),
           "max_abs_dp_hat_decisions_flipped": float(dp[fin32 & ~same].max(initial=0.0)),
           "max_dp_over_bound": float((dp[fin32] / bound_[fin32]).max(initial=0.0))}
    ok = (bool(fin32.any()) and fin64.all() and np.array_equal(np.isfinite(r32[:, 2]), fin32)
          and bool(rows_ok[fin32].all()) and np.isfinite(r64).all())
    return out, ok


def phase_classify(dev) -> dict:
    """gp.laplace and gp.ep at n = 4096 (f32 kernel path against f64 plain
    on the card, K1 and K5 on this path), then the classify study."""
    args32 = classify_problem(torch.float32, dev)
    args64 = classify_problem(torch.float64, dev)

    cb.reset_launch_counts()
    got = run_classify(*args32)
    torch.cuda.synchronize()
    launches = dict(cb.LAUNCHES)
    with linalg.force_plain():
        ref = run_classify(*args64)
    steady = run_classify(*args32)["walls_ms"]  # the same calls, warm
    torch.cuda.synchronize()

    def abs_err(a, b):
        return float((a.double() - b).abs().max())

    b = CLASSIFY_BOUNDS
    errors, failures, counts = {}, [], {}
    for name in ("laplace", "ep"):
        g, r = got[name], ref[name]
        errors[f"{name}_lml_rel"] = abs(float(g["value"]) - float(r["value"])) / abs(float(r["value"]))
        errors[f"{name}_grad_rel"] = abs_err(g["grad"], r["grad"]) / float(r["grad"].abs().max())
        errors[f"{name}_served_prob"] = abs_err(g["served"], r["served"])
        errors[f"{name}_predicted_prob"] = abs_err(g["predicted"], r["predicted"])
        errors[f"{name}_served_vs_predicted_f32"] = abs_err(g["served"], g["predicted"].double())
        failures += [k for k, bound_ in ((f"{name}_lml_rel", b["lml_rtol"]), (f"{name}_grad_rel", b["grad_rtol"]),
                                         (f"{name}_served_prob", b["prob_atol"]),
                                         (f"{name}_predicted_prob", b["prob_atol"]),
                                         (f"{name}_served_vs_predicted_f32", b["serve_atol"]))
                     if not errors[k] <= bound_]
    errors["laplace_f_hat"] = abs_err(got["laplace"]["post"].f_hat, ref["laplace"]["post"].f_hat)
    if not errors["laplace_f_hat"] <= b["f_atol"]:
        failures.append("laplace_f_hat")
    iters, sweeps = int(got["laplace"]["post"].iters), int(got["ep"]["post"].sweeps)
    counts = {"laplace_newton_iters": {"f32_kernels": iters, "f64_plain": int(ref["laplace"]["post"].iters)},
              "ep_sweeps": {"f32_kernels": sweeps, "f64_plain": int(ref["ep"]["post"].sweeps)}}
    # K1: one cholesky(B) a Newton iteration and one more at the mode
    # (laplace_fit); the iterations again, the differentiable step's and
    # W's at f (laplace_lml); one a sweep and one after (ep_fit, ep_lml).
    # K5: one trsm_lower a sweep and one after (ep_fit, ep_lml); the
    # backward's tile inverses, 2 for each of laplace_lml's factors and 3
    # for ep_lml's factor and TRSM; one tril_inv a compile_*_serving, one
    # trsm_lower a *_predict_prob (the factors from K1 carry their tile
    # inverses, so cho_solve_vec launches nothing)
    expect = {"fused_cholesky_invs": (iters + 1) + (iters + 2) + 2 * (sweeps + 1),
              "tril_inv_tile": 2 * (sweeps + 1) + 2 * 2 + 3 + 2 + 2}

    # K1 on B = I + sW K sW at the Laplace mode, K5 on its factor's tiles
    gp, x, y, ts, tl, z = args32
    post = got["laplace"]["post"]
    B = laplace._b_matrix(core.masked_cov(gp, ts, torch.zeros(0, device=dev), x, None), post.sqrt_w)
    rows = kernel_rows("classify", B.contiguous(), diag_tiles(post.chol_b))

    study = {}
    for engine in CLASSIFY_ENGINES:
        r32, s32, cap32 = run_classify_study(engine, dev, torch.float32)
        r64, s64, cap64 = run_classify_study(engine, dev, torch.float64)
        p32 = r32[:, 2][np.isfinite(r32[:, 2])]
        ok = (r32.shape == r64.shape == (40, 7) and np.isfinite(np.delete(r32, 2, axis=1)).all()
              and ((p32 >= 0) & (p32 <= 1)).all())
        study[engine] = {"wall_s_f32_cli": s32, "wall_s_f64": s64,
                         "max_abs_dtheta": float(np.abs(r32[:, 5:] - r64[:, 5:]).max())}
        if engine == "ess":
            report, ok_ = check_ess_study(r32, r64, cap32, cap64)
            study[engine].update(report)
        else:
            dp = float(np.abs(r32[:, 2] - r64[:, 2]).max())
            ok_ = len(p32) == 40 and dp <= b["study_p_atol"]
            study[engine].update({"max_abs_dp_hat": dp, "bound": b["study_p_atol"]})
        if not (ok and ok_):
            failures.append(f"study_{engine}")
    emit({"phase": "classify", "n": N, "m": M, "bounds": CLASSIFY_BOUNDS, "errors": errors, "iterations": counts,
          "launches": launches, "launches_expected": expect, "walls_ms_f32_kernels": got["walls_ms"], "walls_ms_f32_kernels_second_run": steady,
          "walls_ms_f64_plain": ref["walls_ms"],
          "study": study})
    if failures:
        raise AssertionError(f"classification disagrees with the f64 plain path: {failures}")
    wrong = {k: launches[k] for k in launches if launches[k] != expect.get(k, 0)}
    if wrong:
        raise AssertionError(f"classify launches {wrong}, expected {expect} and no other kernel")
    return {"launches": launches, "rows": rows}


# ---------------------------------------------------------------------------
# The sparse path and the model surface
# ---------------------------------------------------------------------------

# The sparse path: the JAX package's own full-width sparse problem
# (benchmarks/sparse_tpu.py:56-72), nothing cut: rbf.scaled() +
# uniform_noise at log-theta 0, n = 65536 sorted inputs uniform on [0, 1000],
# y = sin(x/3) + 0.1 N(0, 1) (numpy seed 0), Z = x[::64][:1024], minibatch
# x[:4096], 4096 test points on linspace(0, 1000).
N_SPARSE, M_SPARSE, B_SPARSE, T_SPARSE, X_SPARSE = 65536, 1024, 4096, 4096, 1000.0
SPARSE_ADAM, SVGP_ITERS, NATGRAD_ITERS, QUAD_ORDER, LAPLACE_SCALE = 50, 100, 50, 20, 0.1
# Bounds of the sparse path (f32 kernel path) against the f64 plain path on
# the card, and of the natural-gradient anchor's gap in f32.  Set before the
# first run on the card (values 1e-3, gradients and v 1e-2, traces 5e-2),
# then to about 10 times what an H100 showed (PERF.md).  Adam's v is held
# by its log-thetas and by the f64 ELBO there: a Z coordinate whose gradient
# is near 0 moves by the sign of its f32 rounding, up to the rate a step
# (Z parted from f64 by 0.049 after 50 steps on an H100, reported).
SPARSE_BOUNDS = {
    "sgpr_value_rtol": 2e-6,  # make_sgpr_logp at v0, relative (1.7e-7 measured)
    "sgpr_grad_rtol": 1e-6,  # its gradient over [log theta | Z], relative to the largest entry (8.0e-8)
    "adam_theta_atol": 1e-2,  # the log-thetas after SPARSE_ADAM Adam steps
    "adam_elbo_rtol": 1e-4,  # the f64 ELBO at the f32 run's v against at the f64 run's v
    "pred_atol": 2e-4,  # sgpr_predict's mean and std at the f32 Adam v (2.1e-5)
    "svgp_value_rtol": 5e-7,  # svgp_elbo on the minibatch, both forms (4.5e-8)
    "svgp_grad_rtol": 2e-5,  # its gradient in each leaf, relative to the leaf's largest entry (1.5e-6)
    "anchor_gap_rtol": 1e-6,  # |ELBO(one natgrad step) - ELBO(optimal state)| / |ELBO(optimal state)|, f32 (0.0)
    "svgp_fit_trace_rtol": 2e-2,  # svgp_fit's ELBO trace, f32 against f64 on the same minibatches (1.6e-3)
    "natgrad_fit_trace_rtol": 2e-6,  # svgp_fit_natgrad's (1.7e-7)
}
# K1 and K5 launches of one call on the sparse path (m >= 1024, f32 on the
# card), from the code.  SGPR's value and gradient: K1 factors Kuu and B; K5
# once for each of the two forward TRSMs (L^-1 Kuf, LB^-1 A ytilde), twice in
# each Cholesky pullback (two transposed TRSMs) and once in each TRSM
# pullback.  svgp_elbo: Kuu and one TRSM, with the pullbacks when
# differentiated.  The natural-gradient step: K1 for Kuu, S (in _elbo_mS and
# again for the solves), P_new (no jitter retry) and S_new; K5 for the TRSM,
# S's Cholesky pullback and the two cho_solve_mat (two TRSMs each).
SPARSE_CALL_LAUNCHES = {
    "sgpr_value_and_grad": (2, 2 + 2 * 2 + 2 * 1),
    "sgpr_fit": (2, 2),
    "sgpr_predict": (0, 2),
    "svgp_value_and_grad": (1, 1 + 2 + 1),
    "svgp_elbo": (1, 1),
    "natgrad_step": (5, 1 + 2 + 2 * 2),
    "svgp_optimal_state": (2, 3),
}
def sparse_launches(**calls: int) -> dict:
    """The K1 and K5 launches of ``calls`` (name -> count) on the sparse path."""
    k1 = sum(SPARSE_CALL_LAUNCHES[name][0] * count for name, count in calls.items())
    k5 = sum(SPARSE_CALL_LAUNCHES[name][1] * count for name, count in calls.items())
    return {"fused_cholesky_invs": k1, "tril_inv_tile": k5}


def sparse_problem(dtype: torch.dtype, device):
    """(gp, x, y, z, t) of the sparse path."""
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0, X_SPARSE, (N_SPARSE, 1)), axis=0)
    y = np.sin(x[:, 0] / 3.0) + 0.1 * rng.normal(size=N_SPARSE)
    gp = GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return gp, t(x), t(y), t(x[:: N_SPARSE // M_SPARSE][:M_SPARSE]), t(np.linspace(0, X_SPARSE, T_SPARSE)[:, None])


def fit_draws(dev) -> sparse.SVGPDraws:
    """The fits' draws: a permutation whose first M_SPARSE entries index the
    problem's Z (x[::64]), and minibatch indices from a generator on the card
    seeded 0, so that the f32 and the f64 run take the same minibatches."""
    step = N_SPARSE // M_SPARSE
    return sparse.SVGPDraws(perm=lambda n: torch.arange(n, device=dev).view(-1, step).T.reshape(-1),
                            batch=sparse.generator_draws(torch.Generator(device=dev).manual_seed(0)).batch)


def svgp_value_and_grad(gp, state, x, y, likelihood):
    """svgp_elbo on the minibatch rescaled to N_SPARSE, at log-theta 0, and
    its gradient in [log_theta, z, q_mu, q_sqrt]."""
    leaves = [torch.zeros(gp.n_theta, dtype=x.dtype, device=x.device).requires_grad_(True),
              *(f.detach().clone().requires_grad_(True) for f in state)]
    with torch.enable_grad():
        theta = torch.exp(leaves[0])
        value = sparse.svgp_elbo(gp, theta[: gp.n_theta_simil], theta[gp.n_theta_simil :],
                                 sparse.SVGPState(*leaves[1:]), x, y, n_total=N_SPARSE, likelihood=likelihood,
                                 quad_order=QUAD_ORDER)
        grads = torch.autograd.grad(value, leaves)
    return value.detach(), grads


def natgrad_anchor(gp, x, y, z):
    """One natural-gradient step at gamma = 1 on the whole batch from the
    KL-zero start, and the closed-form optimum: (ELBO of the step, ELBO of
    the optimum), at log-theta 0."""
    ts = torch.ones(gp.n_theta_simil, dtype=x.dtype, device=x.device)
    tn = torch.ones(gp.n_theta_noise, dtype=x.dtype, device=x.device)
    stepped = sparse.svgp_natgrad_step(gp, ts, tn, sparse.svgp_init(gp, z), x, y, 1.0)
    opt = sparse.svgp_optimal_state(gp, ts, tn, x, y, z)
    return sparse.svgp_elbo(gp, ts, tn, stepped, x, y), sparse.svgp_elbo(gp, ts, tn, opt, x, y)


def run_sparse(gp, x, y, z, t, v_fit=None) -> dict:
    """The sparse path once through the front door, each stage timed and
    its launches counted from 0.  SGPR's fit and predictions at ``v_fit``
    (default: this run's own Adam result)."""
    out, launches, walls = {}, {}, {}
    out["launches"], out["walls_ms"] = launches, walls

    def stage(name, fn, *a, **k):
        cb.reset_launch_counts()
        res = timed_call(walls, name, fn, *a, **k)
        launches[name] = dict(cb.LAUNCHES)
        return res

    v0 = sparse.join_sparse_params(gp, torch.zeros(gp.n_theta, dtype=x.dtype, device=x.device), z)
    vg = masked_value_and_grad(sparse.make_sgpr_logp(gp, x, y, M_SPARSE))
    out["sgpr"] = stage("sgpr_value_and_grad", vg, v0)
    out["adam"] = stage("adam", mle.adam, vg, v0, iters=SPARSE_ADAM, threshold=0.0)
    ts, tn, zf = sparse.split_sparse_params(gp, (out["adam"].x if v_fit is None else v_fit).to(x.dtype), M_SPARSE)
    out["predict"] = stage("sgpr_fit_predict", lambda: sparse.sgpr_predict(gp, sparse.sgpr_fit(gp, ts, tn, x, y, zf), t))
    state0 = sparse.svgp_init(gp, z)
    xb, yb = x[:B_SPARSE], y[:B_SPARSE]
    for form, lik in (("gaussian", None), ("laplace", likelihoods.laplace_noise.for_svgp([LAPLACE_SCALE]))):
        out[f"svgp_{form}"] = stage(f"svgp_{form}_value_and_grad", svgp_value_and_grad, gp, state0, xb, yb, lik)
    out["anchor"] = stage("natgrad_anchor", natgrad_anchor, gp, x, y, z)
    for name, fit, iters in (("svgp_fit", sparse.svgp_fit, SVGP_ITERS),
                             ("svgp_fit_natgrad", sparse.svgp_fit_natgrad, NATGRAD_ITERS)):
        out[f"{name}_params"], out[name] = stage(name, fit, gp, x, y, M_SPARSE, iters=iters, batch=B_SPARSE,
                                                 draws=fit_draws(x.device))
    return out


def sparse_expected(adam_iters: int) -> dict:
    """Each stage's K1 and K5 launches in :func:`run_sparse`."""
    return {
        "sgpr_value_and_grad": sparse_launches(sgpr_value_and_grad=1),
        "adam": sparse_launches(sgpr_value_and_grad=adam_iters),
        "sgpr_fit_predict": sparse_launches(sgpr_fit=1, sgpr_predict=1),
        "svgp_gaussian_value_and_grad": sparse_launches(svgp_value_and_grad=1),
        "svgp_laplace_value_and_grad": sparse_launches(svgp_value_and_grad=1),
        "natgrad_anchor": sparse_launches(natgrad_step=1, svgp_optimal_state=1, svgp_elbo=2),
        "svgp_fit": sparse_launches(svgp_value_and_grad=SVGP_ITERS),
        "svgp_fit_natgrad": sparse_launches(svgp_value_and_grad=NATGRAD_ITERS, natgrad_step=NATGRAD_ITERS),
    }


def wrong_launches(got: dict, expect: dict) -> dict:
    """The stages whose launch counts differ from ``expect`` (a kernel it
    does not name must launch 0 times)."""
    return {stage: counts for stage, counts in got.items()
            if any(counts[k] != expect[stage].get(k, 0) for k in counts)}


def total_launches(stages: dict) -> dict:
    return {k: sum(counts[k] for counts in stages.values()) for k in cb.LAUNCHES}


# The largest peak (GiB) that call_peak_gib's resets of the allocator's
# statistics have cleared since main's last reset: the memory line takes it
# into the phase's peak.
_CLEARED_PEAK_GIB = [0.0]


def call_peak_gib(fn) -> float:
    """Peak device memory (GiB) allocated during ``fn()``."""
    torch.cuda.synchronize()
    _CLEARED_PEAK_GIB[0] = max(_CLEARED_PEAK_GIB[0], torch.cuda.max_memory_allocated() / 2**30)
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    _CLEARED_PEAK_GIB[0] = max(_CLEARED_PEAK_GIB[0], peak)
    return peak


def rel_err(got, want) -> float:
    return abs(float(got) - float(want)) / abs(float(want))


def grad_rel_err(got, want) -> float:
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def phase_sparse(dev) -> dict:
    """gp.sparse at n = 65536, m = 1024, minibatch 4096: the f32 kernel path
    against the f64 plain path on the card, each stage's K1 and K5 launches,
    the natural-gradient anchor, the fits' ELBO traces, walls, device busy
    time and peak memory of SGPR's value and gradient, K1 and K5 at this
    path's shapes."""
    args32 = sparse_problem(torch.float32, dev)
    args64 = sparse_problem(torch.float64, dev)
    gp, x, y, z, t = args32
    got = run_sparse(*args32)
    torch.cuda.synchronize()
    with linalg.force_plain():
        ref = run_sparse(*args64, v_fit=got["adam"].x.double())
    torch.cuda.synchronize()

    b = SPARSE_BOUNDS
    nt = gp.n_theta
    v32, v64 = got["adam"].x.double(), ref["adam"].x
    with linalg.force_plain():
        logp64 = sparse.make_sgpr_logp(*args64[:3], M_SPARSE)
        elbo_at = {"f32_v": float(logp64(v32)), "f64_v": float(logp64(v64))}
    errors = {"sgpr_value_rel": rel_err(got["sgpr"][0], ref["sgpr"][0]),
              "sgpr_grad_rel": grad_rel_err(got["sgpr"][1], ref["sgpr"][1]),
              "adam_theta_abs": float((v32[:nt] - v64[:nt]).abs().max()),
              "adam_z_abs": float((v32[nt:] - v64[nt:]).abs().max()),
              "adam_elbo_rel": rel_err(elbo_at["f32_v"], elbo_at["f64_v"])}
    for label, g, r in zip(("mu", "sigma"), got["predict"], ref["predict"]):
        errors[f"predict_{label}_abs"] = float((g.double() - r).abs().max())
    for form in ("gaussian", "laplace"):
        (gv, gg), (rv, rg) = got[f"svgp_{form}"], ref[f"svgp_{form}"]
        errors[f"svgp_{form}_value_rel"] = rel_err(gv, rv)
        errors[f"svgp_{form}_grad_rel"] = max(grad_rel_err(g_, r_) for g_, r_ in zip(gg, rg))
    (e_step, e_opt), (e_step64, e_opt64) = got["anchor"], ref["anchor"]
    errors["anchor_gap_rel_f32"] = rel_err(e_step, e_opt)
    errors["anchor_gap_rel_f64"] = rel_err(e_step64, e_opt64)
    errors["anchor_opt_elbo_rel_f32_vs_f64"] = rel_err(e_opt, e_opt64)
    traces = {}
    for name in ("svgp_fit", "svgp_fit_natgrad"):
        tr, tr64 = got[name].double(), ref[name]
        errors[f"{name}_trace_rel"] = float(((tr - tr64).abs() / tr64.abs()).max())
        traces[name] = {"first": float(tr[0]), "last": float(tr[-1]), "last10_mean": float(tr[-10:].mean()),
                        "f64_first": float(tr64[0]), "f64_last": float(tr64[-1]),
                        "rises": bool(torch.isfinite(tr).all()) and float(tr[-10:].mean()) > float(tr[0])}
    checks = {"sgpr_value_rel": "sgpr_value_rtol", "sgpr_grad_rel": "sgpr_grad_rtol",
              "adam_theta_abs": "adam_theta_atol", "adam_elbo_rel": "adam_elbo_rtol",
              "predict_mu_abs": "pred_atol", "predict_sigma_abs": "pred_atol",
              **{f"svgp_{f}_value_rel": "svgp_value_rtol" for f in ("gaussian", "laplace")},
              **{f"svgp_{f}_grad_rel": "svgp_grad_rtol" for f in ("gaussian", "laplace")},
              "anchor_gap_rel_f32": "anchor_gap_rtol",
              "svgp_fit_trace_rel": "svgp_fit_trace_rtol", "svgp_fit_natgrad_trace_rel": "natgrad_fit_trace_rtol"}
    failures = [k for k, name in checks.items() if not errors[k] <= b[name]]
    failures += [f"{name} does not rise" for name, tr in traces.items() if not tr["rises"]]
    if got["predict"][0].shape != (T_SPARSE,) or not all(torch.isfinite(p).all() for p in got["predict"]):
        failures.append("sgpr_predict shape/finite")

    # walls (median of 5) of single calls on the kernel path and, where it
    # runs the same call, the plain path in f32; SGPR's value and gradient
    # beside its FLOP bound, its device busy time and peak memory
    v0 = sparse.join_sparse_params(gp, torch.zeros(gp.n_theta, dtype=x.dtype, device=dev), z)
    vg = masked_value_and_grad(sparse.make_sgpr_logp(gp, x, y, M_SPARSE))
    ones_s, ones_n = torch.ones(gp.n_theta_simil, device=dev), torch.ones(gp.n_theta_noise, device=dev)
    post = sparse.sgpr_fit(gp, ones_s, ones_n, x, y, z)
    state0 = sparse.svgp_init(gp, z)
    lik = likelihoods.laplace_noise.for_svgp([LAPLACE_SCALE])
    calls = {
        "sgpr_value_and_grad": lambda: vg(v0),
        "sgpr_fit": lambda: sparse.sgpr_fit(gp, ones_s, ones_n, x, y, z),
        "sgpr_predict": lambda: sparse.sgpr_predict(gp, post, t),
        "svgp_gaussian_value_and_grad": lambda: svgp_value_and_grad(gp, state0, x[:B_SPARSE], y[:B_SPARSE], None),
        "svgp_laplace_value_and_grad": lambda: svgp_value_and_grad(gp, state0, x[:B_SPARSE], y[:B_SPARSE], lik),
        "natgrad_step_whole_batch": lambda: sparse.svgp_natgrad_step(gp, ones_s, ones_n, state0, x, y, 1.0),
        "svgp_optimal_state": lambda: sparse.svgp_optimal_state(gp, ones_s, ones_n, x, y, z),
    }
    wall = {"kernels_f32": {name: wall_ms(fn) for name, fn in calls.items()}}
    with linalg.force_plain():
        wall["plain_f32"] = {name: wall_ms(calls[name]) for name in ("sgpr_value_and_grad", "sgpr_predict")}
    bound_ms, bound_by = bound("sgpr_value_and_grad", (N_SPARSE, M_SPARSE))
    busy = {"kernels_f32": profile_once(calls["sgpr_value_and_grad"])}
    with linalg.force_plain():
        busy["plain_f32"] = profile_once(calls["sgpr_value_and_grad"])
    peaks = {"sgpr_value_and_grad": call_peak_gib(calls["sgpr_value_and_grad"]),
             "natgrad_step_whole_batch": call_peak_gib(calls["natgrad_step_whole_batch"])}

    # Kuu's factor against f64, and the fits' own start (Z from 1024 random
    # rows of the data, as svgp_fit draws it without a hook), reported
    kuu_err = float((sparse._chol_kuu(gp, ones_s, z, sparse.DEFAULT_JITTER).double()
                     - sparse._chol_kuu(args64[0], ones_s.double(), args64[3], sparse.DEFAULT_JITTER)).abs().max())
    zr = x[torch.randperm(N_SPARSE, generator=torch.Generator(device=dev).manual_seed(0), device=dev)[:M_SPARSE]]
    Lr = sparse._chol_kuu(gp, ones_s, zr, sparse.DEFAULT_JITTER)
    random_start = {"min_gap": float(torch.sort(zr[:, 0]).values.diff().min()),
                    "kuu_factor_finite_f32": bool(torch.isfinite(torch.diagonal(Lr)).all())}

    # K1 and K5 at this path's shapes: B = I + A A^T at v0, its factor's tiles
    A = sparse._noise_weights(gp, ones_n, x, torch.ones_like(y))[1].sqrt()[None, :] * linalg.trsm_lower(
        sparse._chol_kuu(gp, ones_s, z, sparse.DEFAULT_JITTER), gp.simil.matrix(ones_s, z, x))
    B = torch.eye(M_SPARSE, device=dev) + A @ A.T
    del A
    rows = kernel_rows("sparse", B, diag_tiles(cb.blocked_cholesky_invs(B, BLOCK)[0]), stepwise=True)

    expect = sparse_expected(got["adam"].iters)
    wrong = wrong_launches(got["launches"], expect)
    emit({"phase": "sparse", "n": N_SPARSE, "m": M_SPARSE, "batch": B_SPARSE, "t": T_SPARSE,
          "adam_steps": got["adam"].iters, "svgp_iters": SVGP_ITERS, "natgrad_iters": NATGRAD_ITERS,
          "bounds": SPARSE_BOUNDS, "errors": errors,
          "sgpr_v0": {"f32_kernels": float(got["sgpr"][0]), "f64_plain": float(ref["sgpr"][0])},
          "adam_f64_elbo_at": elbo_at,
          "anchor_elbo": {"step_f32": float(e_step), "optimal_f32": float(e_opt), "step_f64": float(e_step64),
                          "optimal_f64": float(e_opt64)},
          "traces": traces, "kuu_factor_abs_err_f32_vs_f64": kuu_err, "random_start": random_start,
          "launches": got["launches"], "launches_expected": expect,
          "walls_ms_main_run": got["walls_ms"], "walls_ms_f64_plain": ref["walls_ms"], "call_wall_ms": wall,
          "sgpr_value_and_grad_bound_ms": bound_ms, "sgpr_value_and_grad_bound_by": bound_by,
          "sgpr_value_and_grad_flops": work("sgpr_value_and_grad", (N_SPARSE, M_SPARSE))[1],
          "sgpr_value_and_grad_profile": busy, "peak_gib": peaks})
    if failures:
        raise AssertionError(f"sparse path disagrees with the f64 plain path: {failures}")
    if wrong:
        raise AssertionError(f"sparse launches {wrong}, expected {expect} and no other kernel")
    return {"launches": total_launches(got["launches"]), "rows": rows, "svgp": got["svgp_fit_natgrad_params"]}


# The model surface at the serving problem's n = 4096 (the slice's data):
# the Student-t process at nu = 3 (v_nu = log 1), deep kernels and ICM.
# Bounds set before the first run on the card (values 1e-4, gradients 1e-3,
# tp_predict 1e-3, identity 1e-6), then to about 10 times what an H100
# showed (PERF.md): each model's value against f64 (relative) and gradient
# (relative to its largest entry).  The (8, 8) deep kernel's tanh layers
# saturate on inputs up to 100, so its K is nearly constant plus the noise,
# and its f32 value parts from f64 by 1.3e-5.
SURFACE_BOUNDS = {
    "tp": (1e-6, 1.2e-6),  # make_tp_logp (8.8e-8, 1.1e-7 measured)
    "deep_identity": (1.2e-8, 1.3e-6),  # (1.1e-9, 1.3e-7)
    "rbf": (1.2e-8, 1.3e-6),  # (1.1e-9, 1.3e-7)
    "deep_mlp": (1.3e-4, 1.3e-3),  # (1.3e-5, 1.3e-4)
    "icm": (2.5e-7, 2.5e-6),  # (2.2e-8, 2.1e-7)
    "pred_atol": 1.5e-5,  # tp_predict's mean and std (1.4e-6, 1.6e-7)
    "identity_rtol": 1e-6,  # deep with identity weights against rbf.scaled(), both f32 on the kernel path (0.0)
}
TP_NU = 3.0
DEEP_SEED = 0


def surface_problem(dtype: torch.dtype, device):
    """The slice's problem, and the ICM problem on its inputs: task 0 the
    even rows with the slice's y = sin(x/3) + 0.1 N(0, 1), task 1 the odd
    rows with y = sin(x/3 + 0.5) + 0.1 N(0, 1) (numpy seed 1)."""
    gp, x, y, v, ts, tn, z = problem(dtype, device)
    x1 = x[1::2]
    y1 = torch.sin(x1[:, 0] / 3.0 + 0.5) + 0.1 * torch.as_tensor(
        np.random.default_rng(1).normal(size=x1.shape[0]), dtype=dtype, device=device)
    X, Y = multioutput.stack_tasks([x[0::2], x1], [y[0::2], y1])
    return gp, x, y, v, z, X, Y


def surface_models(dtype, device) -> dict:
    """name -> (gp, v) of the three gp_observe calls: deep with identity
    weights (one linear layer), the same GP's base rbf.scaled(), deep with
    the default (8, 8) tanh MLP and random weights, ICM with 2 tasks."""
    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    ident = GP(1, deep.deep(rbf.scaled(), 1, hidden=()), uniform_noise)
    mlp = GP(1, deep.deep(rbf.scaled(), 1), uniform_noise)
    icm = GP(2, multioutput.icm(rbf.scaled(), 2), uniform_noise)
    zeros = np.zeros(3)
    return {
        "deep_identity": (ident, t(np.concatenate([deep.identity_weights(1, hidden=()), zeros]))),
        "rbf": (GP(1, rbf.scaled(), uniform_noise), t(zeros)),
        "deep_mlp": (mlp, torch.cat([deep.init_deep_v(np.random.default_rng(DEEP_SEED), [0.0, 0.0], 1, dtype=dtype,
                                                      device=device), t([0.0])])),
        "icm": (icm, torch.cat([multioutput.init_icm_theta([0.0, 0.0], 2, 1, dtype=dtype, device=device), t([0.0])])),
    }


def run_surface(gp, x, y, v, z, X, Y) -> dict:
    """The model surface once: make_tp_logp's value and gradient, tp_absorb
    and tp_predict at the slice's m points, gp_observe's value and gradient
    on each of :func:`surface_models`; each stage timed and its launches
    counted from 0."""
    out, launches, walls = {}, {}, {}
    out["launches"], out["walls_ms"] = launches, walls

    def stage(name, fn, *a, **k):
        cb.reset_launch_counts()
        res = timed_call(walls, name, fn, *a, **k)
        launches[name] = dict(cb.LAUNCHES)
        return res

    logp, _ = tprocess.make_tp_logp(gp, x, y)
    v_tp = torch.cat([torch.zeros(1, dtype=x.dtype, device=x.device), v])  # nu = 2 + e^0
    out["tp"] = stage("tp_value_and_grad", masked_value_and_grad(logp), v_tp)
    theta = torch.exp(v)
    ts, tn = theta[: gp.n_theta_simil], theta[gp.n_theta_simil :]
    out["tp_predict"] = stage("tp_absorb_predict", lambda: tprocess.tp_predict(
        gp, TP_NU, tprocess.tp_absorb(gp, TP_NU, ts, tn, x, y), z))
    for name, (gp_, v_) in surface_models(x.dtype, x.device).items():
        xs, ys = (X, Y) if name == "icm" else (x, y)
        out[name] = stage(name, masked_value_and_grad(make_gp_logp(gp_, x=xs, y=ys)), v_)
    return out


def surface_expected() -> dict:
    """Each stage's launches in :func:`run_surface`: tp_lml factors with K1
    and its Cholesky pullback takes K5 twice; tp_absorb factors with K1 and
    tp_predict's TRSM takes K5 once; each gp_observe runs lml_core (K1, the
    solve both ways, no K5: the pullback's inverse reuses K1's tile
    inverses)."""
    solve, solve_t = solve_keys(N)
    observe = {"fused_cholesky_invs": 1, solve: 1, solve_t: 1}
    return {"tp_value_and_grad": {"fused_cholesky_invs": 1, "tril_inv_tile": 2},
            "tp_absorb_predict": {"fused_cholesky_invs": 1, "tril_inv_tile": 1},
            **{name: observe for name in ("deep_identity", "rbf", "deep_mlp", "icm")}}


def phase_surface(dev) -> dict:
    """gp.tprocess, kernels.deep and kernels.multioutput at n = 4096: the f32
    kernel path against the f64 plain path on the card, deep with identity
    weights against its base, each stage's launches, walls, the deep
    kernel's peak memory, and the kernels at this path's shapes."""
    args32 = surface_problem(torch.float32, dev)
    args64 = surface_problem(torch.float64, dev)
    got = run_surface(*args32)
    torch.cuda.synchronize()
    with linalg.force_plain():
        ref = run_surface(*args64)
    torch.cuda.synchronize()

    b = SURFACE_BOUNDS
    errors, failures = {}, []
    for name in ("tp", "deep_identity", "rbf", "deep_mlp", "icm"):
        errors[f"{name}_value_rel"] = rel_err(got[name][0], ref[name][0])
        errors[f"{name}_grad_rel"] = grad_rel_err(got[name][1], ref[name][1])
        failures += [k for k, bound_ in zip((f"{name}_value_rel", f"{name}_grad_rel"), b[name])
                     if not errors[k] <= bound_]
    for label, g, r in zip(("mu", "sigma"), got["tp_predict"], ref["tp_predict"]):
        errors[f"tp_predict_{label}_abs"] = float((g.double() - r).abs().max())
        if not errors[f"tp_predict_{label}_abs"] <= b["pred_atol"]:
            failures.append(f"tp_predict_{label}_abs")
    # identity weights: the base's value, and the base's gradient in the
    # base and noise coordinates (after the two weight slots)
    errors["identity_value_rel"] = rel_err(got["deep_identity"][0], got["rbf"][0])
    errors["identity_grad_rel"] = grad_rel_err(got["deep_identity"][1][2:], got["rbf"][1])
    failures += [k for k in ("identity_value_rel", "identity_grad_rel") if not errors[k] <= b["identity_rtol"]]

    gp, x, y, v, z, X, Y = args32
    models = surface_models(torch.float32, dev)
    calls = {name: (lambda gp_=gp_, v_=v_, xs=(X if name == "icm" else x), ys=(Y if name == "icm" else y):
                    masked_value_and_grad(make_gp_logp(gp_, x=xs, y=ys))(v_))
             for name, (gp_, v_) in models.items()}
    calls["tp_value_and_grad"] = lambda: masked_value_and_grad(tprocess.make_tp_logp(gp, x, y)[0])(
        torch.cat([torch.zeros(1, device=dev), v]))
    wall = {name: wall_ms(fn) for name, fn in calls.items()}
    peaks = {name: call_peak_gib(fn) for name, fn in calls.items()}

    # the kernels at this path's shapes: K1 on the TP's K (the slice's
    # covariance), the solves and K5 on its factor
    theta = torch.exp(v)
    K = core.masked_cov(gp, theta[: gp.n_theta_simil], theta[gp.n_theta_simil :], x, None)
    L, invs = cb.blocked_cholesky_invs(K, BLOCK)
    rows = kernel_rows("surface", K, diag_tiles(L))
    for key, case in solve_cases(L, invs, y, k4=solves_with_k4(N)).items():
        if key != "tril_inv_tile":
            rows["surface", key] = check_kernel("surface", key, *case)

    expect = surface_expected()
    wrong = wrong_launches(got["launches"], expect)
    emit({"phase": "surface", "n": N, "m": M, "nu": TP_NU, "icm_tasks": 2, "bounds": SURFACE_BOUNDS,
          "errors": errors, "values": {name: {"f32_kernels": float(got[name][0]), "f64_plain": float(ref[name][0])}
                                       for name in ("tp", "deep_identity", "rbf", "deep_mlp", "icm")},
          "launches": got["launches"], "launches_expected": expect, "walls_ms_main_run": got["walls_ms"],
          "walls_ms_f64_plain": ref["walls_ms"], "value_and_grad_wall_ms": wall, "peak_gib": peaks})
    if failures:
        raise AssertionError(f"model surface disagrees with the f64 plain path: {failures}")
    if wrong:
        raise AssertionError(f"surface launches {wrong}, expected {expect} and no other kernel")
    return {"launches": total_launches(got["launches"]), "rows": rows}


# ---------------------------------------------------------------------------
# Pathwise sampling, Bayesian optimization and kernel search (gp.pathwise,
# bo, search)
# ---------------------------------------------------------------------------

# The pathwise path: the JAX package's own pathwise problem
# (benchmarks/pathwise_ski_tpu.py:68-77, bench_pathwise): the slice's data
# (n = 4096) under rbf.scaled() at theta_simil [1, 2] + uniform_noise at
# [0.1]; S = 16 paths of F = 2048 features at m = 4096 points,
# thompson_path_scores on the same grid and, for comparison, 16 exact joint
# draws there (serve_sample from a compiled cache, the serve phase's
# jitter); the mean of 2048 paths at every 16th point against the posterior
# mean.  Also at n = 4096: sample_paths_laplace on the classify phase's
# problem, paths of icm(rbf.scaled(), 2) on the surface phase's two
# 2048-point tasks, and sample_paths_svgp on the sparse phase's fitted SVGP
# state (m = 1024) at its 4096 test points.  Nothing cut.
PATH_THETA_SIMIL, PATH_THETA_NOISE = (1.0, 2.0), (0.1,)
PATH_M, PATH_S, PATH_F, PATH_MEAN_S, PATH_MEAN_STRIDE = 4096, 16, 2048, 2048, 16
# Bounds of the pathwise path (f32 kernel path) against the f64 plain path
# on the card with the same draws.  Set before its first run on the card (v
# and every path 1e-2), then to about 10 times what an H100 showed
# (PERF.md).
PATHWISE_BOUNDS = {
    "v_rtol": 2e-3,  # sample_paths' v, relative to its largest entry (1.7e-4 measured)
    "paths_atol": 2.5e-3,  # eval_paths at the 4096 points (2.2e-4)
    "thompson_atol": 1e-3,  # thompson_path_scores on the same grid (8.9e-5)
    "laplace_atol": 2.5e-4,  # sample_paths_laplace's paths, each precision from its own Newton fit (2.2e-5)
    "icm_atol": 2e-4,  # the ICM paths at both tasks' points (1.9e-5)
    "svgp_atol": 1.5e-3,  # sample_paths_svgp's paths at the sparse phase's test points (1.5e-4)
    # the mean of PATH_MEAN_S paths against the posterior mean: at most
    # this many of its standard errors (the paths' spread over
    # sqrt(PATH_MEAN_S)), plus mean_atol for the rounding of the mean and of
    # mu; the largest of 256 standard normals exceeds 6 with probability 5e-7
    "mean_se": 6.0,
    "mean_atol": 1e-3,
}
PERIODIC_LENGTHSCALES = (0.5, 0.1, 0.05, 0.03)


def seeded_draws(dev, seed: int) -> pathwise.GeneratorDraws:
    """Draws from a generator on the card seeded ``seed``, made in f64 and
    cast, so that the f32 and the f64 run of a stage share them."""
    return pathwise.GeneratorDraws(torch.Generator(device=dev).manual_seed(seed))


def pathwise_problem(dtype: torch.dtype, dev, svgp: sparse.SVGPParams) -> dict:
    """Each pathwise problem's GP, data, hyperparameters and test points."""
    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    gp, x, y = problem(dtype, dev)[:3]
    z = t(np.linspace(0, 100, PATH_M)[:, None])
    gp_c, xc, yc, tsc, tl, _ = classify_problem(dtype, dev)
    X, Y = surface_problem(dtype, dev)[5:]
    gp_i, v_i = surface_models(dtype, dev)["icm"]
    theta_i = torch.exp(v_i)
    zh = z[::2]
    gp_s = GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)
    theta_s = torch.exp(svgp.log_theta.detach().to(dtype))
    return {"exact": (gp, x, y, t(PATH_THETA_SIMIL), t(PATH_THETA_NOISE), z),
            "laplace": (gp_c, xc, yc, tsc, tl, z),
            "icm": (gp_i, theta_i[: gp_i.n_theta_simil], theta_i[gp_i.n_theta_simil :], X, Y,
                    torch.cat([multioutput.task_inputs(zh, 0), multioutput.task_inputs(zh, 1)])),
            "svgp": (gp_s, theta_s[: gp_s.n_theta_simil], sparse.SVGPState(*(f.detach().to(dtype) for f in svgp.state)),
                     t(np.linspace(0, X_SPARSE, T_SPARSE)[:, None]))}


def path_mean(fs: torch.Tensor, mu: torch.Tensor) -> tuple:
    """(mean of the paths, its standard error, the posterior mean) at each
    point."""
    return fs.mean(0), fs.std(0) / fs.shape[0] ** 0.5, mu


def run_pathwise(prob: dict, dev) -> dict:
    """The pathwise path once through the front door, each stage timed and
    its launches counted from 0; stage k draws from ``seeded_draws(dev, k)``."""
    out, launches, walls = {}, {}, {}
    out["launches"], out["walls_ms"] = launches, walls

    def stage(name, fn, *a, **k):
        cb.reset_launch_counts()
        res = timed_call(walls, name, fn, *a, **k)
        launches[name] = dict(cb.LAUNCHES)
        return res

    gp, x, y, ts, tn, z = prob["exact"]
    zm = z[::PATH_MEAN_STRIDE]
    post = stage("absorb", core.absorb, gp, ts, tn, x, y)
    ps = stage("sample_paths", pathwise.sample_paths, gp, post, seeded_draws(dev, 0), PATH_S, PATH_F)
    out["v"] = ps.v
    out["paths"] = stage("eval_paths", pathwise.eval_paths, gp, ps, z)
    state = bo.BOState(post, x.new_zeros(1), x.new_zeros(()))
    out["thompson"] = stage("thompson_path_scores", bo.thompson_path_scores, gp, state, z, seeded_draws(dev, 1), PATH_F)
    out["exact_draws"] = stage("serve_sample", lambda: serve.serve_sample(
        gp, serve.fit_serving(gp, ts, tn, x, y), z, PATH_S, jitter=SAMPLE_JITTER,
        generator=torch.Generator(device=dev).manual_seed(2)))
    out["mean"] = stage("mean", lambda: path_mean(
        pathwise.eval_paths(gp, pathwise.sample_paths(gp, post, seeded_draws(dev, 3), PATH_MEAN_S, PATH_F), zm),
        core.predict_from_posterior(gp, post, zm)[0]))

    gp_c, xc, yc, tsc, tl, _ = prob["laplace"]
    post_c = stage("laplace_fit", laplace.laplace_fit, gp_c, likelihoods.bernoulli_logit, tsc, tl, xc, yc)
    out["laplace_iters"] = int(post_c.iters)
    out["laplace"] = stage("laplace_paths", lambda: pathwise.eval_paths(
        gp_c, pathwise.sample_paths_laplace(gp_c, post_c, seeded_draws(dev, 4), PATH_S, PATH_F), z))
    out["laplace_mean"] = stage("laplace_mean", lambda: path_mean(pathwise.eval_paths(
        gp_c, pathwise.sample_paths_laplace(gp_c, post_c, seeded_draws(dev, 5), PATH_MEAN_S, PATH_F), zm),
        laplace.laplace_predict(gp_c, post_c, zm)[0]))

    gp_i, ts_i, tn_i, X, Y, zi = prob["icm"]
    zim = zi[::PATH_MEAN_STRIDE]
    post_i = stage("icm_absorb", core.absorb, gp_i, ts_i, tn_i, X, Y)
    out["icm"] = stage("icm_paths", lambda: pathwise.eval_paths(
        gp_i, pathwise.sample_paths(gp_i, post_i, seeded_draws(dev, 6), PATH_S, PATH_F), zi))
    out["icm_mean"] = stage("icm_mean", lambda: path_mean(pathwise.eval_paths(
        gp_i, pathwise.sample_paths(gp_i, post_i, seeded_draws(dev, 7), PATH_MEAN_S, PATH_F), zim),
        core.predict_from_posterior(gp_i, post_i, zim)[0]))

    gp_s, ts_s, state_s, t_s = prob["svgp"]
    tm = t_s[::PATH_MEAN_STRIDE]
    out["svgp"] = stage("svgp_paths", lambda: pathwise.eval_paths_sparse(
        gp_s, pathwise.sample_paths_svgp(gp_s, ts_s, state_s, seeded_draws(dev, 8), PATH_S, PATH_F), t_s))
    out["svgp_mean"] = stage("svgp_mean", lambda: path_mean(pathwise.eval_paths_sparse(
        gp_s, pathwise.sample_paths_svgp(gp_s, ts_s, state_s, seeded_draws(dev, 9), PATH_MEAN_S, PATH_F), tm),
        sparse.svgp_predict(gp_s, ts_s, state_s, tm)[0]))
    return out


def pathwise_expected(laplace_iters: int) -> dict:
    """Each stage's launches in :func:`run_pathwise`: K1 in every n = 4096
    absorb (fit_serving's too) and every Newton iteration and the mode
    (laplace_fit), and for Kuu (m = 1024) in sample_paths_svgp and
    svgp_predict; K5 twice in every cho_solve_mat (sample_paths and
    sample_paths_laplace), once in every other blocked TRSM (the
    predictions) and in fit_serving's tril_inv."""
    k1, k5 = "fused_cholesky_invs", "tril_inv_tile"
    return {"absorb": {k1: 1}, "sample_paths": {k5: 2}, "eval_paths": {}, "thompson_path_scores": {k5: 2},
            "serve_sample": {k1: 1, k5: 1}, "mean": {k5: 3}, "laplace_fit": {k1: laplace_iters + 1},
            "laplace_paths": {k5: 2}, "laplace_mean": {k5: 3}, "icm_absorb": {k1: 1}, "icm_paths": {k5: 2},
            "icm_mean": {k5: 3}, "svgp_paths": {k1: 1}, "svgp_mean": {k1: 2, k5: 1}}


def periodic_features(dev) -> dict:
    """The periodic kernel's spectral weights (the 256-point trapezoid of
    exp(-z) I_k(z), z = 1/l^2) and its features at PATH_F features, in f32
    against f64 with the same draws, at each of PERIODIC_LENGTHSCALES."""
    z = torch.linspace(0, 10, 512, dtype=torch.float64, device=dev)[:, None]
    out = {}
    for l in PERIODIC_LENGTHSCALES:
        feats = {}
        for dtype in (torch.float32, torch.float64):
            theta = torch.tensor([l, 2.3], dtype=dtype, device=dev)
            feat = pathwise.sample_features(periodic, theta, seeded_draws(dev, 10), PATH_F, 1)
            feats[dtype] = (pathwise._bessel_ive(64, 1.0 / (theta[0] * theta[0])), feat,
                            pathwise.eval_features(feat, z.to(dtype)))
        (w32, f32, phi32), (w64, f64, phi64) = feats[torch.float32], feats[torch.float64]
        out[f"l={l}"] = {"z": 1.0 / l**2, "bessel_abs_err": float((w32.double() - w64).abs().max()),
                         "weight_sum_f64": float(w64[0] + 2 * w64[1:].sum()),
                         "same_harmonics": bool(torch.equal(torch.round(f32.omega.double() * 2.3 / (2 * np.pi)),
                                                            torch.round(f64.omega * 2.3 / (2 * np.pi)))),
                         "features_abs_err": float((phi32.double() - phi64).abs().max())}
    return out


def phase_pathwise(dev, svgp: sparse.SVGPParams | None = None) -> dict:
    """gp.pathwise at n = 4096: the f32 kernel path against the f64 plain
    path on the card with the same draws, the Monte Carlo checks of the
    paths' mean, each stage's K1 and K5 launches, the periodic weights in
    f32, walls and peak memory against exact joint draws, and K1 and K5 at
    this path's shapes.  ``svgp``: the sparse phase's fitted SVGP (a partial
    run without it takes the sparse problem's optimal state at log-theta 0)."""
    if svgp is None:
        gp_s, xs, ys, zs, _ = sparse_problem(torch.float32, dev)
        ones = torch.ones(3, device=dev)
        svgp = sparse.SVGPParams(torch.zeros(3, device=dev),
                                 sparse.svgp_optimal_state(gp_s, ones[:2], ones[2:], xs, ys, zs))
    prob32 = pathwise_problem(torch.float32, dev, svgp)
    prob64 = pathwise_problem(torch.float64, dev, svgp)
    got = run_pathwise(prob32, dev)
    torch.cuda.synchronize()
    with linalg.force_plain():
        ref = run_pathwise(prob64, dev)
    torch.cuda.synchronize()

    b = PATHWISE_BOUNDS

    def abs_err(a, b_):
        return float((a.double() - b_).abs().max())

    errors = {"v_rel": abs_err(got["v"], ref["v"]) / float(ref["v"].abs().max()),
              **{f"{name}_abs": abs_err(got[name], ref[name])
                 for name in ("paths", "thompson", "laplace", "icm", "svgp")}}
    checks = {"v_rel": "v_rtol", "paths_abs": "paths_atol", "thompson_abs": "thompson_atol",
              "laplace_abs": "laplace_atol", "icm_abs": "icm_atol", "svgp_abs": "svgp_atol"}
    failures = [k for k, name in checks.items() if not errors[k] <= b[name]]
    means = {}
    for name in ("mean", "laplace_mean", "icm_mean", "svgp_mean"):
        for label, run in (("f32", got), ("f64", ref)):
            mean, se, mu = (t.double() for t in run[name])
            gap = (mean - mu).abs()
            ratio = float((gap / (b["mean_se"] * se + b["mean_atol"])).max())
            means[f"{name}_{label}"] = {"max_abs": float(gap.max()), "max_se": float(se.max()),
                                        "max_over_bound": ratio}
            if not ratio <= 1.0:
                failures.append(f"{name}_{label}")
    finite = {name: bool(torch.isfinite(got[name]).all()) for name in ("paths", "thompson", "laplace", "icm", "svgp")}
    failures += [f"{name} not finite" for name, ok in finite.items() if not ok]
    if got["paths"].shape != (PATH_S, PATH_M):
        failures.append("eval_paths shape")

    # walls (median of 5) on the kernel path and on the plain f32 path, and
    # peak memory: the paths against 16 exact joint draws at the same points
    gp, x, y, ts, tn, z = prob32["exact"]
    post = core.absorb(gp, ts, tn, x, y)
    ps = pathwise.sample_paths(gp, post, seeded_draws(dev, 0), PATH_S, PATH_F)
    sp = serve.fit_serving(gp, ts, tn, x, y)
    state = bo.BOState(post, x.new_zeros(1), x.new_zeros(()))
    calls = {"absorb": lambda: core.absorb(gp, ts, tn, x, y),
             "sample_paths": lambda: pathwise.sample_paths(gp, post, seeded_draws(dev, 0), PATH_S, PATH_F),
             "eval_paths": lambda: pathwise.eval_paths(gp, ps, z),
             "thompson_path_scores": lambda: bo.thompson_path_scores(gp, state, z, seeded_draws(dev, 1), PATH_F),
             "fit_serving": lambda: serve.fit_serving(gp, ts, tn, x, y),
             "serve_sample_exact": lambda: serve.serve_sample(gp, sp, z, PATH_S, jitter=SAMPLE_JITTER,
                                                              generator=torch.Generator(device=dev).manual_seed(2))}
    wall = {"kernels_f32": {name: wall_ms(fn) for name, fn in calls.items()}}
    with linalg.force_plain():
        wall["plain_f32"] = {name: wall_ms(calls[name]) for name in ("absorb", "sample_paths", "thompson_path_scores")}
    peaks = {name: call_peak_gib(calls[name]) for name in ("sample_paths", "eval_paths", "serve_sample_exact")}
    periodic = periodic_features(dev)

    # K1 and K5 at this path's shapes: the covariance, its factor's 32 tiles
    K = core.masked_cov(gp, ts, tn, x, None)
    rows = kernel_rows("pathwise", K, diag_tiles(cb.blocked_cholesky_invs(K, BLOCK)[0]))

    expect = pathwise_expected(got["laplace_iters"])
    wrong = wrong_launches(got["launches"], expect)
    emit({"phase": "pathwise", "n": N, "m": PATH_M, "paths": PATH_S, "features": PATH_F, "mean_paths": PATH_MEAN_S,
          "theta_simil": PATH_THETA_SIMIL, "theta_noise": PATH_THETA_NOISE, "bounds": PATHWISE_BOUNDS,
          "errors": errors, "means": means, "finite": finite,
          "serve_sample_finite_f32": bool(torch.isfinite(got["exact_draws"]).all()),
          "laplace_newton_iters": {"f32_kernels": got["laplace_iters"], "f64_plain": ref["laplace_iters"]},
          "periodic_f32_vs_f64": periodic, "launches": got["launches"], "launches_expected": expect,
          "walls_ms_main_run": got["walls_ms"], "walls_ms_f64_plain": ref["walls_ms"], "call_wall_ms": wall,
          "peak_gib": peaks})
    if failures:
        raise AssertionError(f"pathwise path disagrees with the f64 plain path: {failures}")
    if wrong:
        raise AssertionError(f"pathwise launches {wrong}, expected {expect} and no other kernel")
    return {"launches": total_launches(got["launches"]), "rows": rows}


# The BO path (the JAX package has no BO benchmark, so this is the
# problem): the Branin function, a standard BO test function, on its usual
# domain [-5, 10] x [0, 15] mapped to the unit square, negated so that BO
# maximises and divided by BRANIN_SCALE; a 64 x 64 grid of candidates;
# rbf.scaled() at theta_simil [1.8, 0.27] (a maximum-likelihood fit to 256
# grid points, rounded) + uniform_noise at theta 0.1 (a variance of 1e-2;
# at 1e-4 the batch run's f32 factor went NaN on the card), fixed for every
# run (the streaming contract); capacity 1024 (a multiple of the
# 128 block, so that every trsm_lower takes K5 from the first iteration):
# EI, UCB and exact Thompson from 16 random grid points for 1008 iterations,
# batch Thompson from 32 points for 31 rounds of q = 32, then
# thompson_path_optimize (8 restarts, 100 steps) on the batch run's final
# state.  Each run in f32 on the kernel path and in f64 on the plain path
# with the same draws.  Nothing cut.
BRANIN_SCALE = 100.0
BO_GRID, BO_CAPACITY, BO_INIT, BO_BATCH_INIT, BO_Q = 64, 1024, 16, 32, 32
BO_ITERS, BO_ROUNDS = BO_CAPACITY - BO_INIT, (BO_CAPACITY - BO_BATCH_INIT) // BO_Q
BO_KINDS = ("ei", "ucb", "thompson")
BO_THETA_SIMIL, BO_THETA_NOISE = (1.8, 0.27), (0.1,)
BO_OPT_RESTARTS, BO_OPT_STEPS = 8, 100
# Bounds of the BO path.  Set before its first run on the card (the
# posteriors and first scores 1e-3, the optimizer's grid gap 1e-3), then to
# about 10 times what an H100 showed at the noise variance 1e-2 (PERF.md).
BO_BOUNDS = {
    # each run's streamed posterior at the grid against one f64 absorb of
    # its points (EI 2.9e-5 / 1.3e-4; exact Thompson's 1008 appends of one
    # point 4.4e-6 / 4.5e-4, as one f32 absorb of them: 3.9e-6 / 4.1e-4)
    "post_mu_atol": 5e-4,
    "post_sigma_atol": 5e-3,
    "first_scores_atol": 1e-4,  # the first step's scores, f32 against f64 with the same draws (UCB 1.1e-5)
    # thompson_path_optimize's value may lie at most this below the same
    # path's maximum over the grid (5.0e-5 below it)
    "opt_grid_atol": 5e-4,
}


def branin_objective(u: torch.Tensor) -> torch.Tensor:
    """-branin(x) / BRANIN_SCALE at u in the unit square (x1 = 15 u0 - 5,
    x2 = 15 u1), over the last axis."""
    x1, x2 = 15.0 * u[..., 0] - 5.0, 15.0 * u[..., 1]
    b, c, t = 5.1 / (4 * np.pi**2), 5.0 / np.pi, 1.0 / (8 * np.pi)
    return -((x2 - b * x1 * x1 + c * x1 - 6.0) ** 2 + 10.0 * (1 - t) * torch.cos(x1) + 10.0) / BRANIN_SCALE


def bo_problem(dtype: torch.dtype, dev):
    """(gp, grid, theta_simil, theta_noise) of the BO path."""
    g = torch.linspace(0.0, 1.0, BO_GRID, dtype=torch.float64)
    grid = torch.stack(torch.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    return (GP(ndim=2, simil=rbf.scaled(), noise=uniform_noise), grid.to(dev, dtype),
            torch.tensor(BO_THETA_SIMIL, dtype=dtype, device=dev),
            torch.tensor(BO_THETA_NOISE, dtype=dtype, device=dev))


def batch_bo(gp, grid, ts, tn, draws) -> bo.BOState:
    """Batch Thompson: BO_BATCH_INIT random grid points, then BO_ROUNDS
    rounds of acquire_batch_thompson (q = BO_Q) and bo_update."""
    state = bo.bo_init(gp, ts, tn, BO_CAPACITY, grid.dtype, grid.device)
    x0 = grid[draws.choice(grid.shape[0], BO_BATCH_INIT, grid)]
    state = bo.bo_update(gp, state, x0, branin_objective(x0))
    for _ in range(BO_ROUNDS):
        idx, _ = bo.acquire_batch_thompson(gp, state, grid, draws, BO_Q)
        state = bo.bo_update(gp, state, grid[idx], branin_objective(grid[idx]))
    return state


def run_bo(gp, grid, ts, tn, dev) -> dict:
    """The BO path once, each run timed and its launches counted from 0;
    run k draws from ``seeded_draws(dev, 20 + k)``."""
    out, launches, walls = {}, {}, {}
    out["launches"], out["walls_ms"] = launches, walls

    def stage(name, fn, *a, **k):
        cb.reset_launch_counts()
        res = timed_call(walls, name, fn, *a, **k)
        launches[name] = dict(cb.LAUNCHES)
        return res

    for k, kind in enumerate(BO_KINDS):
        out[kind] = stage(kind, bo.bo_run, gp, ts, tn, branin_objective, grid, BO_ITERS, seeded_draws(dev, 20 + k),
                          kind=kind, n_init=BO_INIT)[0]
    out["batch"] = stage("batch", batch_bo, gp, grid, ts, tn, seeded_draws(dev, 23))
    box = (grid.new_zeros(2), grid.new_ones(2))
    out["optimize"] = stage("optimize", bo.thompson_path_optimize, gp, out["batch"], seeded_draws(dev, 24), box,
                            BO_OPT_RESTARTS, BO_OPT_STEPS)
    return out


def bo_expected() -> dict:
    """Each run's K5 launches in :func:`run_bo` (no other kernel): the first
    update's TRSM, then each iteration's predict and append, and exact
    Thompson's TRSM of the cross-covariance; each batch round's
    cho_solve_mat (two) and append; the optimizer's cho_solve_mat."""
    k5 = "tril_inv_tile"
    return {"ei": {k5: 1 + 2 * BO_ITERS}, "ucb": {k5: 1 + 2 * BO_ITERS}, "thompson": {k5: 1 + 3 * BO_ITERS},
            "batch": {k5: 1 + 3 * BO_ROUNDS}, "optimize": {k5: 2}}


def bo_first_scores(gp, grid, ts, tn, dev) -> dict:
    """Every kind's scores at the first step: the state after BO_INIT random
    grid points (seed 30), each kind's draws from seed 31."""
    x0 = grid[seeded_draws(dev, 30).choice(grid.shape[0], BO_INIT, grid)]
    state = bo.bo_update(gp, bo.bo_init(gp, ts, tn, BO_CAPACITY, grid.dtype, grid.device), x0, branin_objective(x0))
    return {kind: bo.acquire(gp, state, grid, kind, seeded_draws(dev, 31))[1]
            for kind in (*BO_KINDS, "thompson-path")}


def phase_bo(dev) -> dict:
    """bo at capacity 1024 on the Branin grid: every run in f32 on the
    kernel path and in f64 on the plain path with the same draws, each
    streamed posterior against one f64 absorb, the first step's scores,
    each run's gap to the grid's maximum and first parting step, ms per
    iteration, K5's launches, and K5 at this path's 8 tiles."""
    gp, grid, ts, tn = bo_problem(torch.float32, dev)
    gp64, grid64, ts64, tn64 = bo_problem(torch.float64, dev)
    got = run_bo(gp, grid, ts, tn, dev)
    torch.cuda.synchronize()
    with linalg.force_plain():
        ref = run_bo(gp64, grid64, ts64, tn64, dev)
        first64 = bo_first_scores(gp64, grid64, ts64, tn64, dev)
    first = bo_first_scores(gp, grid, ts, tn, dev)
    torch.cuda.synchronize()

    b = BO_BOUNDS
    grid_max = float(branin_objective(grid64).max())
    errors, runs, failures = {}, {}, []
    for name in (*BO_KINDS, "batch"):
        st, st64 = got[name], ref[name]
        mu, sd = core.predict_from_posterior(gp, st.post, grid)
        with linalg.force_plain():
            one = core.absorb(gp64, ts64, tn64, st.post.x.double(), st.post.y.double())
            mu64, sd64 = core.predict_from_posterior(gp64, one, grid64)
        errors[f"{name}_post_mu"] = float((mu.double() - mu64).abs().max())
        errors[f"{name}_post_sigma"] = float((sd.double() - sd64).abs().max())
        # reported beside them: one f32 absorb of the same points (K1)
        mu1, sd1 = core.predict_from_posterior(gp, core.absorb(gp, ts, tn, st.post.x, st.post.y), grid)
        errors[f"{name}_one_absorb_f32_mu"] = float((mu1.double() - mu64).abs().max())
        errors[f"{name}_one_absorb_f32_sigma"] = float((sd1.double() - sd64).abs().max())
        failures += [k for k in (f"{name}_post_mu", f"{name}_post_sigma")
                     if not errors[k] <= b[f"post_{k.rsplit('_', 1)[1]}_atol"]]
        parted = (st.post.x != st64.post.x.float()).any(-1).nonzero()
        steps = BO_ITERS if name in BO_KINDS else BO_ROUNDS
        runs[name] = {"best_y_f32": float(st.best_y), "best_y_f64": float(st64.best_y),
                      "gap_to_grid_max_f32": grid_max - float(st.best_y),
                      "gap_to_grid_max_f64": grid_max - float(st64.best_y),
                      "best_x_f32": st.best_x.tolist(),
                      "first_parting_row": int(parted[0, 0]) if len(parted) else None,
                      "ms_per_iteration_f32": got["walls_ms"][name] / steps,
                      "ms_per_iteration_f64_plain": ref["walls_ms"][name] / steps,
                      "k5_per_iteration": (got["launches"][name]["tril_inv_tile"] - 1) / steps}
    for kind, scores in first.items():
        finite = torch.isfinite(scores)
        errors[f"first_{kind}_abs"] = float((scores.double() - first64[kind]).abs().max()) if finite.all() else None
        errors[f"first_{kind}_nan_f32"] = int((~finite).sum())
        # exact Thompson's f32 draw is NaN where the 4096 x 4096 grid
        # covariance does not factor in f32 (all of it, as in the JAX twin)
        ok = (errors[f"first_{kind}_abs"] is not None and errors[f"first_{kind}_abs"] <= b["first_scores_atol"]
              or kind == "thompson" and not finite.any())
        if not (ok and torch.isfinite(first64[kind]).all()):
            failures.append(f"first_{kind}")
    (x_opt, v_opt), (x64, v64) = got["optimize"], ref["optimize"]
    ps = pathwise.sample_paths(gp, got["batch"].post, seeded_draws(dev, 24), 1, 512)  # the optimizer's path
    path_grid_max = float(pathwise.eval_paths(gp, ps, grid).max())
    # the f64 run is reported, not held: its restarts may climb other local
    # maxima of the path
    optimize = {"x_f32": x_opt.tolist(), "value_f32": float(v_opt), "x_f64": x64.tolist(), "value_f64": float(v64),
                "path_grid_max_f32": path_grid_max}
    if not float(v_opt) >= path_grid_max - b["opt_grid_atol"]:
        failures.append("optimize below the path's grid maximum")

    # K5 at this path's shapes: the 8 tiles of the EI run's final factor
    tiles = diag_tiles(got["ei"].post.chol)
    eye = torch.eye(BLOCK, device=dev)
    rows = {("bo", "tril_inv_tile"): check_kernel(
        "bo", "tril_inv_tile", lambda: cb.tril_inv_tile(tiles), lambda: cb.tril_inv_tile_plain(tiles), tiles.shape,
        20, lambda: torch.linalg.solve_triangular(tiles, eye, upper=False))}

    expect = bo_expected()
    wrong = wrong_launches(got["launches"], expect)
    emit({"phase": "bo", "capacity": BO_CAPACITY, "grid": BO_GRID * BO_GRID, "iterations": BO_ITERS,
          "batch_rounds": BO_ROUNDS, "q": BO_Q, "theta_simil": BO_THETA_SIMIL, "theta_noise": BO_THETA_NOISE,
          "branin_scale": BRANIN_SCALE, "grid_max": grid_max, "bounds": BO_BOUNDS, "errors": errors, "runs": runs,
          "optimize": optimize, "launches": got["launches"], "launches_expected": expect,
          "walls_ms_main_run": got["walls_ms"], "walls_ms_f64_plain": ref["walls_ms"]})
    if failures:
        raise AssertionError(f"BO path disagrees with the f64 plain path: {failures}")
    if wrong:
        raise AssertionError(f"bo launches {wrong}, expected {expect} and no other kernel")
    return {"launches": total_launches(got["launches"]), "rows": rows}


# The search path: tests/test_search.py:12-16's trend-plus-periodic
# generator at n = 128 (numpy seed 0), search at its defaults (bases rbf,
# matern32, periodic and linear; max_depth 3; 8 restarts; Adam 400 at rate
# 0.05; BIC) in f32 on the K7 route and in f64 on the plain route from the
# same draws, then once more with score "loo" on the K7 route alone (its
# f64 run, 43 s on an H100, cut for the script's time).  Every candidate's
# restarts are one (8, 128, 128) K7 batch an Adam step (K7's widest n).
SEARCH_N, SEARCH_SCORES = 128, ("bic", "loo")
SEARCH_BASES = ("rbf", "matern32", "periodic", "linear")  # search's defaults
# Bounds of the search path: set before its first run on the card (the
# winner's LML at the same v 1e-4, its log-thetas 0.1), then to about 10
# times what an H100 showed (PERF.md).  The winner's K (noise variance 4e-3
# under a signal variance near 180) is ill-conditioned: at its optimum both
# f32 routes' L^-1 part from f64 by 5e-2 of the largest entry, and its LML
# by 1.1.  Its log-thetas are reported, not held: Adam's 400 steps end
# 0.4 apart on the two routes along the LML's flat directions (a long rbf
# lengthscale trades against its scale), so the round-0 fits, each base
# alone and well conditioned, are held instead.
SEARCH_BOUNDS = {
    "lml_rtol": 8e-2,  # the f32 winner's LML on the K7 route against the f64 route's at the same v (7.6e-3)
    "round0_lml_rtol": 2.5e-4,  # each base's fitted LML, f32 K7 route against f64 plain (2.3e-5)
    "k7_rtol": BAYES_BOUNDS["k7_rtol"],  # K7 against its plain version on the winner's starting batch (1.5e-6)
}


def search_problem(dtype: torch.dtype, dev):
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0.0, 8.0, size=(SEARCH_N, 1)), axis=0)
    y = 0.6 * x[:, 0] + 1.5 * np.sin(2.0 * np.pi * x[:, 0] / 1.7) + 0.1 * rng.normal(size=SEARCH_N)
    return torch.as_tensor(x, dtype=dtype, device=dev), torch.as_tensor(y, dtype=dtype, device=dev)


def run_search(x, y, score: str) -> dict:
    """One search, with each candidate's fit wrapped to record its Adam
    steps, its K7 launches and its wall."""
    fits, steps = [], []
    fit, adam = search._fit_candidate, mle.adam_batched

    def counted_adam(vg, V0, **kw):
        res = adam(vg, V0, **kw)
        steps.append(int(res.iters.max()))
        return res

    def counted_fit(kernel, *a):
        k7 = cb.LAUNCHES["fused_gp_linv"]
        walls = {}
        v, lml, gp = timed_call(walls, "fit", fit, kernel, *a)
        fits.append({"kernel": kernel.name, "lml": lml, "adam_steps": steps[-1],
                     "k7_launches": cb.LAUNCHES["fused_gp_linv"] - k7, "ms": walls["fit"]})
        return v, lml, gp

    walls = {}
    with unittest.mock.patch.object(search, "_fit_candidate", counted_fit), \
            unittest.mock.patch.object(mle, "adam_batched", counted_adam):
        res = timed_call(walls, "search", search.search, x, y, bases=SEARCH_BASES, score=score,
                         key=torch.Generator(device=x.device).manual_seed(0))
    return {"result": res, "fits": fits, "ms": walls["search"]}


def search_reference(device: str, score: str) -> dict:
    """The f64 plain route's search, in a worker process (spawned beside
    this process's f32 searches): its winner and fits as plain data."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x64, y64 = search_problem(torch.float64, torch.device(device))
    with linalg.force_plain():
        ref = run_search(x64, y64, score)
    res = ref["result"]
    return {"name": res.name, "lml": res.lml, "score": res.score, "v_opt": res.v_opt.tolist(),
            "history": [c.name for c in res.history], "y_mean": res.y_mean, "y_std": res.y_std,
            "fits": ref["fits"], "ms": ref["ms"]}


def phase_search(dev) -> dict:
    """search at n = 128: the f32 K7 route against the f64 plain route (its
    BIC search in a worker process beside this one's; winners, the round-0
    fits, the winner's LML at the same v; its log-thetas reported), K7
    launches equal to each candidate's Adam steps, walls per candidate and
    per search, and K7 on the winner's (8, 128, 128) restart batch."""
    x, y = search_problem(torch.float32, dev)
    x64, y64 = search_problem(torch.float64, dev)
    b = SEARCH_BOUNDS
    report, failures, launches, runs = {}, [], 0, {}
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        pending = pool.apply_async(search_reference, (str(dev), SEARCH_SCORES[0]))
        for score in SEARCH_SCORES:
            runs[score] = got = run_search(x, y, score)
            res = got["result"]
            wrong_k7 = [f for f in got["fits"] if f["k7_launches"] != f["adam_steps"]]
            failures += [f"{score}: {k}" for k, ok in (
                ("no periodic in the winner", "periodic" in res.name),
                (f"K7 launches differ from Adam steps: {wrong_k7}", not wrong_k7)) if not ok]
            launches += sum(f["k7_launches"] for f in got["fits"])
            steps = sum(f["adam_steps"] for f in got["fits"])
            report[score] = {"winner_f32": res.name, "lml_f32": res.lml, "score_f32": res.score,
                             "v_f32": res.v_opt.tolist(), "history_f32": [c.name for c in res.history],
                             "candidates": len(got["fits"]), "ms_f32": got["ms"],
                             "ms_per_candidate_f32": got["ms"] / len(got["fits"]),
                             "ms_per_adam_step_f32": sum(f["ms"] for f in got["fits"]) / steps,
                             "fits_f32": got["fits"]}
        ref = pending.get()

    score = SEARCH_SCORES[0]
    got = runs[score]
    winner = res = got["result"]
    v64 = torch.tensor(ref["v_opt"], dtype=torch.float64, device=dev)
    # the winner's LML at its v on the K7 route, the plain f32 route and the
    # f64 route (Adam's reported value is the LML before its last step)
    gp = GP(ndim=1, simil=res.kernel, noise=uniform_noise)
    y_norm = (y - res.y_mean) / res.y_std
    lml32 = float(search.batched_value_and_grad(gp, x, y_norm)(res.v_opt[None])[0][0])
    with linalg.force_plain():
        lml32_plain = float(search.batched_value_and_grad(gp, x, y_norm)(res.v_opt[None])[0][0])
        lml64 = float(gp_observe(gp, res.v_opt.double(), x=x64, y=(y64 - ref["y_mean"]) / ref["y_std"]))
    bases = len(SEARCH_BASES)
    round0 = max(abs(f["lml"] - r["lml"]) / abs(r["lml"]) for f, r in zip(got["fits"][:bases], ref["fits"][:bases]))
    same = res.name == ref["name"]
    errors = {"lml_rel": abs(lml32 - lml64) / abs(lml64), "lml_rel_plain_f32": abs(lml32_plain - lml64) / abs(lml64),
              "round0_lml_rel": round0, "v_abs": float((res.v_opt.double() - v64).abs().max()) if same else None}
    failures += [f"{score}: {k}" for k, ok in (
        ("winner differs from the f64 route's", same),
        ("lml_rel", errors["lml_rel"] <= b["lml_rtol"]), ("round0_lml_rel", round0 <= b["round0_lml_rtol"]),
        ("f64 route launched K7", not any(f["k7_launches"] for f in ref["fits"]))) if not ok]
    report[score].update({"winner_f64": ref["name"], "lml_f64": ref["lml"], "score_f64": ref["score"],
                          "lml_at_v_f32_k7": lml32, "lml_at_v_f32_plain": lml32_plain, "lml_at_v_f64_plain": lml64,
                          "v_f64": ref["v_opt"], "history_f64": ref["history"], "errors": errors,
                          "ms_f64_plain": ref["ms"], "ms_per_candidate_f64_plain": ref["ms"] / len(ref["fits"]),
                          "fits_f64_plain": ref["fits"]})

    # K7 at this path's shape: the BIC winner's restart batch at a search's
    # first starting points (0.7 N(0, 1) on log scale, a generator seeded
    # 0), against its plain version; and, reported, both against f64 at 8
    # points around the winner's optimum (0.1 N(0, 1)), where the noise the
    # fit found leaves K ill-conditioned
    gp = GP(ndim=1, simil=winner.kernel, noise=uniform_noise)
    nts, p = gp.n_theta_simil, gp.n_theta

    def covs(V):
        return torch.func.vmap(lambda v: core.masked_cov(gp, torch.exp(v[:nts]), torch.exp(v[nts:]), x, None))(
            V).contiguous()

    gen = torch.Generator(device=dev).manual_seed(0)
    K = covs(0.7 * torch.randn((8, p), generator=gen, dtype=torch.float64, device=dev).float())
    K_opt = covs(winner.v_opt + 0.1 * torch.randn((8, p), generator=gen, dtype=torch.float64, device=dev).float())
    want = fused_gp.linv_plain(K_opt.double())
    near_optimum = {name: float((fn(K_opt).double() - want).abs().max() / want.abs().max())
                    for name, fn in (("k7", fused_gp.fused_gp_linv), ("plain_f32", fused_gp.linv_plain))}
    emit({"phase": "search", "n": SEARCH_N, "bounds": b, "runs": report,
          "linv_rel_err_vs_f64_near_optimum": near_optimum})
    eye = torch.eye(SEARCH_N, device=dev)
    rows = {("search", "fused_gp_linv"): check_kernel(
        "search", "fused_gp_linv", lambda: fused_gp.fused_gp_linv(K), lambda: fused_gp.linv_plain(K), K.shape, 50,
        lambda: torch.linalg.solve_triangular(torch.linalg.cholesky(K), eye, upper=False), rtol=b["k7_rtol"])}
    if failures:
        raise AssertionError(f"search path disagrees with the f64 plain route: {failures}")
    return {"launches": {**{k: 0 for k in cb.LAUNCHES}, "fused_gp_linv": launches}, "rows": rows}


# ---------------------------------------------------------------------------
# The large-n engines: ops/iterative.py (CG, SLQ, pivoted PCG), the dense and
# matrix-free LMLs and predict_iterative; ops/toeplitz.py with lml_toeplitz
# and predict_toeplitz; ops/ski.py and gp/ski.py; sample_paths_ski; ChEES on
# the SKI surrogate.  They reach no TPU kernel in the JAX package and launch
# none of the port's: the phases hold every engine call's launches to 0.
# Every run is f32 with TF32 off, beside its f64 twin on the card with the
# same probes and draws (GeneratorDraws draws in f64 and casts).  The bounds
# were written before the phases' first run on the card (PERF.md).
# ---------------------------------------------------------------------------

ESTIMATOR = dict(num_probes=16, cg_iters=100, lanczos_iters=32)  # the JAX defaults
ITER_RANKS = (0, 32)
N_FREE, FREE_PANEL, FREE_RANK = 65536, 2048, 32
ITER_SEED = 0
ITER_BOUNDS = {
    "f32_value_rtol": 1e-4,  # lml_iterative in f32 against f64, same probes
    "f32_grad_rtol": 1e-3,  # its gradient, relative to the largest entry
    # the estimator against the exact lml (f64 plain) at 16 probes: the CPU
    # measured up to 3.1e-3 (value and gradient) at n = 4096 and 6.7e-3
    # (value, rank 32) at n = 1024 (PERF.md)
    "estimator_value_rtol": 2e-2,
    "estimator_grad_rtol": 3e-2,
    # with a preconditioner, f32 and f64 pick its pivots among ties of the
    # residual diagonal (constant at the start: a stationary K) that they
    # break apart, so their N(0, P) probes pass through different L: the two
    # are then held at the estimator's own bounds (the CPU: 6.3e-4 apart at
    # n = 1024)
    "ranked_f32_value_rtol": 2e-2,
    "ranked_f32_grad_rtol": 3e-2,
    "matfree_value_rtol": 1e-4,  # lml_iterative_matfree against lml_iterative, same probes, f32
    "matfree_grad_rtol": 1e-3,
    "predict_atol": 1e-3,  # predict_iterative (f32) against the exact predict in f64
    "matfree_peak_gib": 6.0,  # n = 65536, panel 2048: a dense f32 K would take 16 GiB
}
TOEPLITZ_BOUNDS = {
    "f32_value_rtol": 1e-4, "f32_grad_rtol": 1e-3,  # lml_toeplitz in f32 against f64
    "ranked_f32_value_rtol": 2e-2, "ranked_f32_grad_rtol": 3e-2,  # with a preconditioner: ITER_BOUNDS
    "dense_value_rtol": 1e-4, "dense_grad_rtol": 1e-3,  # against lml_iterative on the same probes, f32
    "predict_atol": 1e-3,  # predict_toeplitz (f32) against the exact predict in f64
}
N_TOEPLITZ_BIG = 2**20
# The SKI problem (benchmarks/pathwise_ski_tpu.py:120-168, bench_ski).  Its
# covariance (rbf lengthscale 8 at 65.5 points a unit, noise variance 1e-2)
# has a condition number near 1e5, so 60 CG iterations stop short in f32:
# on the CPU at full size f32 sat 1.3e-3 (value) and 3.2e-2 (gradient) off
# f64, and the scatter and sorted forms 1.3e-6 and 1.8e-2 apart.
N_SKI, G_SKI, SKI_THETA_SIMIL, SKI_THETA_NOISE = 65536, 4096, (1.0, 8.0), (0.1,)
SKI_ESTIMATOR = dict(num_probes=8, cg_iters=60, lanczos_iters=24)
SKI_METHODS = ("scatter", "sorted", "matmul")
# predict_ski against predict_iterative at x[::SKI_PRED_STRIDE] (n = 16384):
# predict_iterative at n = 65536, m = 1024 would take about a minute (200
# CG iterations, each 8.8 TFLOP of matmul and 4.3e9 kernel entries)
SKI_PRED_STRIDE = 4
N_SKI2D, G_SKI2D, N_SKI2D_CHECK, G_SKI2D_CHECK = 262144, 512, 16384, 64
N_SKIPATH, G_SKIPATH, SKIPATH_S, SKIPATH_F, SKIPATH_M = 131072, 8192, 16, 2048, 4096
# The SKI solves at the twin's settings stop short of convergence: lml_ski's
# CG 60, predict_ski's 200 and sample_paths_ski's 100 end at true residuals
# of 0.1-5 |b| on these problems (condition near 1e5), in f64 as in f32, and
# the two dtypes' unconverged iterates part.  On the CPU at a quarter of the
# paths' problem (n = 32768 on [0, 250], grid 2048) the f32 paths sat 1.5
# from f64's at CG 100 with either W^T form, and the JAX twin's f32 CG
# parted from its f64 as far (1.1e-2 of the solution against the port's
# 1.1e-2); 2-D SKI at n = 16384, g = 64 x 64 parted by 8.7e-3 in value at CG
# 60.  So those gaps are reported, and correctness in f32 is held by
#   - each piece of the operator in f32 against f64 on the same inputs and
#     the same vector ([y | 8 Rademacher probes]): the grid matvec, W, each
#     W^T form and the whole operator, at each problem's full size (CPU:
#     1e-7 to 5e-7; the sorted form's cumsum 7.8e-6 at n = 65536 and 1.4e-5
#     at 131072), and the f32-built operator against the f64-built one
#     (CPU: 3e-6, from x's own f32 rounding);
#   - the same runs with CG given CONVERGED_CG iterations at tol 1e-6, where
#     f64 converges (CPU: 954 iterations in 2-D, 272 for the paths) and f32
#     stops at its rounding floor (true residual 1e-3): 2-D value 4.8e-4 and
#     gradient 6.8e-6 apart, the paths 3.4e-3 (sorted) and 2.9e-3 (scatter),
#     predict_ski mu 1.3e-3 and sigma 8.1e-5.
CONVERGED_CG = 3000
SKI_BOUNDS = {
    "f32_value_rtol": 1e-2, "f32_grad_rtol": 2e-1,  # each 1-D method in f32 against f64, CG 60
    "methods_value_rtol": 1e-4, "methods_grad_rtol": 1e-1,  # the three W^T forms in f32
    "op_arith_rtol": 5e-6,  # each operator piece's f32 arithmetic, of the f64 result's largest entry
    "wt_sorted_arith_rtol": 2e-4,  # the sorted W^T's (its cumsum's differences)
    "op_f32_rtol": 3e-5,  # the f32-built operator against the f64-built one
    "converged_value_rtol": 5e-3, "converged_grad_rtol": 1e-4,  # 2-D lml_ski at CONVERGED_CG
    "converged_paths_abs": 3e-2,  # sample_paths_ski at CONVERGED_CG, either form
    "converged_mu_abs": 1e-2, "converged_sigma_abs": 1e-3,  # predict_ski at CONVERGED_CG
    "path_mean_se": 6.0,  # the 16 paths' mean (f64, CG 100) within 6 standard errors (+ 5e-2) of predict_ski's mu
    "path_mean_atol": 5e-2,
}
# ChEES on the SKI surrogate (benchmarks/large_n_bayes.py --ski): bench.py's
# noisy sine at n = 65536 on [0, 100], rbf.scaled() + uniform_noise, N(0, 1)
# priors on the log-thetas, grid 4096, 16 probes, CG 100, Lanczos 32, one
# probe draw for the whole run, 8 chains in lockstep; the MLE warm start
# (Adam, 10 chunks of 20 steps at 0.05), spread 0.05, step 0.01, trajectory
# 0.1, at most 64 leapfrog steps.  The W^T form is "scatter": the twin's
# default, "matmul", builds (n, g) one-hots here (PERF.md).  Cut
# from 256 + 256 transitions to 10 + 8, so that the phase stayed near 100 s
# (a batched value and gradient of the 8 chains took 199 ms on an H100, a
# transition about 24 of them), and to 6 + 4 to keep the whole script under
# 800 s beside the parallel phase (PERF.md §4).
N_LNB, G_LNB, LNB_X = 65536, 4096, 100.0
LNB_CHAINS, LNB_MAX_STEPS, LNB_SPREAD, LNB_STEP, LNB_TRAJ = 8, 64, 0.05, 0.01, 0.1
LNB_ADAM_CHUNKS, LNB_ADAM_STEPS, LNB_ADAM_RATE = 10, 20, 0.05
LNB_WARMUP, LNB_SAMPLES, LNB_SEED, LNB_PROBE_SEED = 6, 4, 0, 777
LNB_METHOD = "scatter"


def theta_vg(fn, v: torch.Tensor):
    """(value, d value / d v) of ``fn(theta_simil, theta_noise)`` at
    log-theta ``v`` ((3,), or (B, 3) for a batched engine)."""
    v = v.detach().clone().requires_grad_(True)
    th = torch.exp(v)
    value = fn(th[..., :2], th[..., 2:])
    (g,) = torch.autograd.grad(value.sum(), v)
    return value.detach(), g


@contextlib.contextmanager
def cg_log():
    """Each ``iterative.cg_solve`` inside: its iterations, budget and the
    final relative residual |B - A X| / |B| of its worst column (one more
    matvec, whose time is logged apart)."""
    log, solve = [], iterative.cg_solve

    def logged(A, B, max_iters=100, tol=1e-6, precond=None):
        X, iters = solve(A, B, max_iters, tol, precond)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mv = A if callable(A) else (lambda V: A @ V)
        Bm, Xm = (B, X) if B.dim() > 1 else (B[:, None], X[:, None])
        with torch.no_grad():
            rel = float(((Bm - mv(Xm)).norm(dim=-2) / Bm.norm(dim=-2).clamp_min(1e-30)).max())
        torch.cuda.synchronize()
        log.append({"iters": iters if isinstance(iters, int) else iters.tolist(), "max_iters": max_iters,
                    "tol": tol, "columns": Bm.shape[-1], "rel_residual": rel,
                    "check_ms": (time.perf_counter() - t0) * 1e3})
        return X, iters

    with unittest.mock.patch.object(iterative, "cg_solve", logged):
        yield log


def traced_call(fn):
    """``fn()`` once: (its result, wall ms without the residual checks, peak
    GiB, the CG log)."""
    torch.cuda.synchronize()
    _CLEARED_PEAK_GIB[0] = max(_CLEARED_PEAK_GIB[0], torch.cuda.max_memory_allocated() / 2**30)
    torch.cuda.reset_peak_memory_stats()
    with cg_log() as log:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 - sum(e["check_ms"] for e in log)
    peak = torch.cuda.max_memory_allocated() / 2**30
    _CLEARED_PEAK_GIB[0] = max(_CLEARED_PEAK_GIB[0], peak)
    return out, wall, peak, log


def launched() -> dict:
    return {k: n for k, n in cb.LAUNCHES.items() if n}


def vg_errors(got, want) -> dict:
    """Value error relative to |want|, gradient's relative to its largest
    entry."""
    return {"value_rel": rel_err(got[0], want[0]), "grad_rel": grad_rel_err(got[1], want[1])}


def gate(failures: list, label: str, errs: dict, bounds: dict, names: dict) -> None:
    failures += [f"{label}: {k} {errs[k]:.3g} > {bounds[b]:.3g}" for k, b in names.items() if not errs[k] <= bounds[b]]


def ranked_bounds(rank: int) -> dict:
    """The f32-against-f64 bound names of a run at ``rank``."""
    pre = "ranked_" if rank else ""
    return {"value_rel": f"{pre}f32_value_rtol", "grad_rel": f"{pre}f32_grad_rtol"}


def pivots(K: torch.Tensor, noise_var: float, rank: int) -> list:
    """The preconditioner's pivots on K: each column's largest |L| entry is
    its pivot's (Cauchy-Schwarz on the residual)."""
    return torch.argmax(iterative.pivoted_precond(K, rank, noise_var).L.abs(), 0).tolist()


def finite(*ts) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in ts)


def phase_iterative(dev) -> dict:
    """The iterative engine on the large path's problem at n = 16384 (f32
    against f64 with the same probes, against the exact lml and predict,
    matrix-free against dense, walls against the exact path), then
    matrix-free at n = 65536 on the SKI problem."""
    b = ITER_BOUNDS
    gp, x, y, v0, z = large_problem(N_LARGE, torch.float32, dev)
    _, x64, y64, v64, z64 = large_problem(N_LARGE, torch.float64, dev)
    failures, out = [], {"n": N_LARGE, "estimator": ESTIMATOR, "bounds": b}

    def dense(xx, yy, rank):
        return lambda ts, tn: core.lml_iterative(gp, ts, tn, xx, yy, seeded_draws(dev, ITER_SEED),
                                                 precond_rank=rank, **ESTIMATOR)

    def matfree(xx, yy, rank, panel=FREE_PANEL, est=ESTIMATOR):
        return lambda ts, tn: core.lml_iterative_matfree(gp, ts, tn, xx, yy, seeded_draws(dev, ITER_SEED),
                                                         panel=panel, precond_rank=rank, **est)

    def exact(xx, yy):
        return lambda ts, tn: core.lml(gp, ts, tn, xx, yy)

    cb.reset_launch_counts()
    runs, cg = {}, {}
    for rank in ITER_RANKS:
        runs[rank], wall, peak, cg[f"rank{rank}"] = traced_call(lambda: theta_vg(dense(x, y, rank), v0))
        out[f"dense_rank{rank}_first_call"] = {"wall_ms": wall, "peak_gib": peak}
    runs["matfree"], wall, peak, cg["matfree_rank0"] = traced_call(lambda: theta_vg(matfree(x, y, 0), v0))
    out["matfree_first_call"] = {"wall_ms": wall, "peak_gib": peak, "panel": FREE_PANEL}
    th = torch.exp(v0)
    pred, wall, peak, cg["predict_iterative"] = traced_call(
        lambda: core.predict_iterative(gp, th[:2], th[2:], x, y, z))
    out["predict_iterative_first_call"] = {"wall_ms": wall, "peak_gib": peak}
    if launched():
        failures.append(f"the iterative engine launched {launched()}")

    # the exact path: the kernel path in f32 (K2 per factor, the gate's
    # solves, K5 in the predict) and the plain path in f64
    nb = N_LARGE // BLOCK
    fwd, bwd = solve_keys(N_LARGE)
    cb.reset_launch_counts()
    exact32 = theta_vg(exact(x, y), v0)
    out["exact_vg_launches"] = launched()
    want = {"chol_inv_tile": nb, fwd: 1, bwd: 1}
    failures += [f"exact vg: {k} {cb.LAUNCHES[k]} != {n}" for k, n in want.items()
                 if k in LARGE_KERNELS and cb.LAUNCHES[k] != n]
    cb.reset_launch_counts()
    pred_exact32 = core.predict(gp, th[:2], th[2:], x, y, z)
    if "chol_inv_tile" in LARGE_KERNELS and cb.LAUNCHES["chol_inv_tile"] != nb:
        failures.append(f"exact predict: K2 {cb.LAUNCHES['chol_inv_tile']} != {nb}")
    if "tril_inv_tile" in LARGE_KERNELS and cb.LAUNCHES["tril_inv_tile"] < 1:
        failures.append("exact predict: no K5 launch")
    out["exact_predict_launches"] = launched()
    th64 = torch.exp(v64)
    with linalg.force_plain():
        exact64 = theta_vg(exact(x64, y64), v64)
        pred_exact64 = core.predict(gp, th64[:2], th64[2:], x64, y64, z64)
    ref = {rank: theta_vg(dense(x64, y64, rank), v64) for rank in ITER_RANKS}
    nv = float(th[2] ** 2)
    piv32 = pivots(core.masked_cov(gp, th[:2], th[2:], x, None), nv, ITER_RANKS[-1])
    piv64 = pivots(core.masked_cov(gp, th64[:2], th64[2:], x64, None), nv, ITER_RANKS[-1])
    out["pivots"] = {"f32": piv32, "f64": piv64, "first_difference": next(
        (j for j, (p, q) in enumerate(zip(piv32, piv64)) if p != q), None)}

    errors = {}
    for rank in ITER_RANKS:
        errors[f"rank{rank}_f32_vs_f64"] = vg_errors(runs[rank], ref[rank])
        errors[f"rank{rank}_f32_vs_exact"] = vg_errors(runs[rank], exact64)
        errors[f"rank{rank}_f64_vs_exact"] = vg_errors(ref[rank], exact64)
        gate(failures, f"rank {rank} f32", errors[f"rank{rank}_f32_vs_f64"], b, ranked_bounds(rank))
        gate(failures, f"rank {rank} estimator", errors[f"rank{rank}_f64_vs_exact"], b,
             {"value_rel": "estimator_value_rtol", "grad_rel": "estimator_grad_rtol"})
    errors["exact_f32_kernels_vs_f64"] = vg_errors(exact32, exact64)
    errors["matfree_vs_dense_f32"] = vg_errors(runs["matfree"], runs[0])
    gate(failures, "matfree", errors["matfree_vs_dense_f32"], b,
         {"value_rel": "matfree_value_rtol", "grad_rel": "matfree_grad_rtol"})
    for label, (mu, sd) in (("predict_iterative", pred), ("predict_exact_f32_kernels", pred_exact32)):
        errors[label] = {"mu_abs": float((mu.double() - pred_exact64[0]).abs().max()),
                         "sigma_abs": float((sd.double() - pred_exact64[1]).abs().max())}
    gate(failures, "predict_iterative", errors["predict_iterative"], b,
         {"mu_abs": "predict_atol", "sigma_abs": "predict_atol"})
    if not finite(*runs[0], *runs[ITER_RANKS[-1]], *pred):
        failures.append("non-finite iterative value, gradient or prediction")

    # walls, median of 5: the dense engine at each rank, matrix-free,
    # predict_iterative, against the exact path's value and gradient and
    # predict on the kernel path
    walls = {f"dense_rank{rank}_vg": wall_ms(lambda: theta_vg(dense(x, y, rank), v0)) for rank in ITER_RANKS}
    walls["exact_vg_kernels"] = wall_ms(lambda: theta_vg(exact(x, y), v0))
    walls["matfree_vg"] = wall_ms(lambda: theta_vg(matfree(x, y, 0), v0), reps=1)
    walls["predict_iterative"] = wall_ms(lambda: core.predict_iterative(gp, th[:2], th[2:], x, y, z), reps=1)
    walls["predict_exact_kernels"] = wall_ms(lambda: core.predict(gp, th[:2], th[2:], x, y, z), reps=3)
    out.update(errors=errors, walls_ms=walls, cg=cg,
               values={"rank0_f32": float(runs[0][0]), "rank32_f32": float(runs[ITER_RANKS[-1]][0]),
                       "exact_f64": float(exact64[0]), "rank0_f64": float(ref[0][0])},
               grads={"rank0_f32": runs[0][1].tolist(), "exact_f64": exact64[1].tolist()})

    # matrix-free at n = 65536 on the SKI problem: one value and gradient,
    # its memory against the 16 GiB a dense K would take, beside lml_ski
    gps, xs, ys = ski_problem(N_FREE, torch.float32, dev)
    vs = ski_log_theta(dev, torch.float32)
    cb.reset_launch_counts()
    big, wall, peak, log = traced_call(lambda: theta_vg(
        lambda ts, tn: core.lml_iterative_matfree(gps, ts, tn, xs, ys, seeded_draws(dev, ITER_SEED),
                                                  panel=FREE_PANEL, precond_rank=FREE_RANK, **ESTIMATOR), vs))
    ski_value = theta_vg(lambda ts, tn: gski.lml_ski(gps, ts, tn, xs, ys, seeded_draws(dev, ITER_SEED), G_SKI,
                                                    method="scatter", **ESTIMATOR), vs)
    if launched():
        failures.append(f"matrix-free or SKI at n = {N_FREE} launched {launched()}")
    out["matfree_n65536"] = {"n": N_FREE, "panel": FREE_PANEL, "precond_rank": FREE_RANK, "wall_ms": wall,
                             "peak_gib": peak, "cg": log, "value": float(big[0]), "grad": big[1].tolist(),
                             "lml_ski_value": float(ski_value[0]), "lml_ski_grad": ski_value[1].tolist(),
                             "value_rel_to_ski": rel_err(big[0], ski_value[0])}
    if not peak <= b["matfree_peak_gib"]:
        failures.append(f"matrix-free peak {peak:.2f} GiB > {b['matfree_peak_gib']}")
    if not finite(*big):
        failures.append("matrix-free at n = 65536 not finite")
    emit({"phase": "iterative", **out})
    if failures:
        raise AssertionError(f"iterative phase: {failures}")
    return {}


def toeplitz_problem(n: int, dtype, dev, span: float):
    """A regular grid of n points on [0, span], y = sin(x/3) + 0.1 N(0, 1)
    (numpy seed 0), rbf.scaled() + uniform_noise at log-theta 0."""
    x = np.linspace(0.0, span, n)
    y = np.sin(x / 3.0) + 0.1 * np.random.default_rng(0).normal(size=n)
    gp = GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    return gp, t(x[:, None]), t(y), torch.zeros(gp.n_theta, dtype=dtype, device=dev)


def phase_toeplitz(dev) -> dict:
    """lml_toeplitz and predict_toeplitz on a regular grid over the large
    problem's range at n = 16384 (f32 against f64, against the dense
    iterative engine on the same probes, against the exact lml), then one
    value and gradient at n = 2^20 (benchmarks/toeplitz_tpu.py's top size)."""
    b = TOEPLITZ_BOUNDS
    gp, x, y, v0 = toeplitz_problem(N_LARGE, torch.float32, dev, X_LARGE)
    _, x64, y64, v64 = toeplitz_problem(N_LARGE, torch.float64, dev, X_LARGE)
    z = torch.linspace(0.0, X_LARGE, M_LARGE, device=dev)
    failures, errors, cg, runs = [], {}, {}, {}

    def toep(xx, yy, rank):
        return lambda ts, tn: core.lml_toeplitz(gp, ts, tn, xx, yy, seeded_draws(dev, ITER_SEED),
                                                precond_rank=rank, **ESTIMATOR)

    def dense(xx, yy, rank):
        return lambda ts, tn: core.lml_iterative(gp, ts, tn, xx, yy, seeded_draws(dev, ITER_SEED),
                                                 precond_rank=rank, **ESTIMATOR)

    cb.reset_launch_counts()
    th = torch.exp(v0)
    for rank in ITER_RANKS:
        runs[rank], _, _, cg[f"rank{rank}"] = traced_call(lambda: theta_vg(toep(x, y, rank), v0))
        runs[f"dense{rank}"] = theta_vg(dense(x, y, rank), v0)
    pred, _, _, cg["predict_toeplitz"] = traced_call(lambda: core.predict_toeplitz(gp, th[:2], th[2:], x, y, z))
    th64 = torch.exp(v64)
    with linalg.force_plain():
        exact64 = theta_vg(lambda ts, tn: core.lml(gp, ts, tn, x64, y64), v64)
        pred64 = core.predict(gp, th64[:2], th64[2:], x64, y64, z.double())
    for rank in ITER_RANKS:
        ref = theta_vg(toep(x64, y64, rank), v64)
        errors[f"rank{rank}_f32_vs_f64"] = vg_errors(runs[rank], ref)
        errors[f"rank{rank}_vs_dense_f32"] = vg_errors(runs[rank], runs[f"dense{rank}"])
        errors[f"rank{rank}_f64_vs_exact"] = vg_errors(ref, exact64)
        gate(failures, f"rank {rank} f32", errors[f"rank{rank}_f32_vs_f64"], b, ranked_bounds(rank))
        gate(failures, f"rank {rank} dense", errors[f"rank{rank}_vs_dense_f32"], b,
             {"value_rel": "dense_value_rtol", "grad_rel": "dense_grad_rtol"})
    errors["predict_toeplitz"] = {"mu_abs": float((pred[0].double() - pred64[0]).abs().max()),
                                  "sigma_abs": float((pred[1].double() - pred64[1]).abs().max())}
    gate(failures, "predict_toeplitz", errors["predict_toeplitz"], b,
         {"mu_abs": "predict_atol", "sigma_abs": "predict_atol"})
    walls = {f"toeplitz_rank{rank}_vg": wall_ms(lambda: theta_vg(toep(x, y, rank), v0)) for rank in ITER_RANKS}
    walls["predict_toeplitz"] = wall_ms(lambda: core.predict_toeplitz(gp, th[:2], th[2:], x, y, z))

    # n = 2^20: x = linspace(0, n/40), y = sin(x/2) + 0.1 N(0, 1), as
    # benchmarks/toeplitz_tpu.py builds it
    n = N_TOEPLITZ_BIG
    xb = torch.linspace(0.0, n / 40.0, n, dtype=torch.float64)
    yb = torch.sin(xb / 2.0) + 0.1 * torch.as_tensor(np.random.default_rng(0).normal(size=n))
    xb, yb = xb[:, None].float().to(dev), yb.float().to(dev)
    big, wall, peak, cg["n2p20"] = traced_call(lambda: theta_vg(toep(xb, yb, 0), v0))
    walls["n2p20_vg_first_call"] = wall
    walls["n2p20_vg"] = wall_ms(lambda: theta_vg(toep(xb, yb, 0), v0), reps=3)
    if launched():
        failures.append(f"the Toeplitz path launched {launched()}")
    if not finite(*runs[0], *pred, *big):
        failures.append("non-finite Toeplitz value, gradient or prediction")
    emit({"phase": "toeplitz", "n": N_LARGE, "n_big": n, "estimator": ESTIMATOR, "bounds": b, "errors": errors,
          "walls_ms": walls, "cg": cg, "peak_gib_n2p20": peak,
          "values": {"rank0_f32": float(runs[0][0]), "exact_f64": float(exact64[0]), "n2p20_f32": float(big[0])},
          "grad_n2p20": big[1].tolist()})
    if failures:
        raise AssertionError(f"toeplitz phase: {failures}")
    return {}


def ski_problem(n: int, dtype, dev, span: float = 1000.0, period: float = 20.0):
    """bench_ski's problem: n sorted uniform inputs on [0, span], y =
    sin(x/period) + 0.1 N(0, 1) (numpy seed 0), rbf.scaled() + uniform_noise."""
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0.0, span, (n, 1)), axis=0)
    y = np.sin(x[:, 0] / period) + 0.1 * rng.normal(size=n)
    gp = GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)
    return gp, torch.as_tensor(x, dtype=dtype, device=dev), torch.as_tensor(y, dtype=dtype, device=dev)


def ski_log_theta(dev, dtype) -> torch.Tensor:
    return torch.log(torch.tensor([*SKI_THETA_SIMIL, *SKI_THETA_NOISE], dtype=dtype, device=dev))


def ski2d_problem(n: int, dtype, dev):
    """bench_ski2d's problem: n points uniform on [0, 100]^2, y = sin(x0/10)
    cos(x1/8) + 0.1 N(0, 1) (numpy seed 0), matern32.scaled() at [1, 5] +
    uniform_noise at [0.1]."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0.0, 100.0, (n, 2))
    y = np.sin(x[:, 0] / 10) * np.cos(x[:, 1] / 8) + 0.1 * rng.normal(size=n)
    gp = GP(ndim=2, simil=matern32.scaled(), noise=uniform_noise)
    v = torch.log(torch.tensor([1.0, 5.0, 0.1], dtype=dtype, device=dev))
    return gp, torch.as_tensor(x, dtype=dtype, device=dev), torch.as_tensor(y, dtype=dtype, device=dev), v


def operator_errors(gp, log_theta, x, y, dims, methods, b, failures, label) -> dict:
    """The SKI operator's f32 pieces on x against f64 on one vector, [y | 8
    Rademacher probes]: each piece's arithmetic on the same f32 inputs (the
    grid matvec, W, each W^T form, the whole operator), and the f32-built
    operator against the one built from x in f64.  Errors are of the f64
    result's largest entry; each is gated."""
    x64, th, th64 = x.double(), torch.exp(log_theta.float()), torch.exp(log_theta.double())
    V = torch.cat([y[:, None], seeded_draws(x.device, ITER_SEED).rademacher((x.shape[0], 8), y)], 1)
    V64 = V.double()
    g0, hs = gski._grid_geometry(x, dims)
    idx, w = ski_ops.cubic_interp_nd(x, g0, hs, dims)
    c, noise = gski._grid_cov(gp, th[:2], g0, hs, dims), gp.noise.vector(th[2:], x)
    g = math.prod(dims)
    grid_mv = toeplitz_ops.toeplitz_matvec_fn if len(dims) == 1 else (lambda cc: ski_ops.bttb_matvec_fn(cc, 2))
    U = V[torch.arange(g, device=x.device) % x.shape[0]]  # a (g, 9) grid-space block
    with torch.no_grad():
        errs = {"grid_matvec": grad_rel_err(grid_mv(c)(U), grid_mv(c.double())(U.double())),
                "interp": grad_rel_err(ski_ops.interp(idx, w, U), ski_ops.interp(idx, w.double(), U.double()))}
        wt64 = ski_ops.interp_t(idx, w.double(), g, V64)
        full64 = ski_ops.ski_matvec_fn(c.double(), idx, w.double(), noise.double(), "scatter")(V64)
        built64 = gski._ski_operator(gp, th64[:2], th64[2:], x64, dims, "scatter")(V64)
        wt = {"scatter": ski_ops.interp_t, "sorted": ski_ops.interp_t_sorted, "matmul": ski_ops.interp_t_matmul}
        for m in methods:
            errs[f"wt_{m}"] = grad_rel_err(wt[m](idx, w, g, V), wt64)
            errs[f"op_{m}"] = grad_rel_err(ski_ops.ski_matvec_fn(c, idx, w, noise, m)(V), full64)
            errs[f"op_{m}_built_f32"] = grad_rel_err(gski._ski_operator(gp, th[:2], th[2:], x, dims, m)(V), built64)
    for k, e in errs.items():
        bound = b["op_f32_rtol"] if k.endswith("_built_f32") else (
            b["wt_sorted_arith_rtol"] if k == "wt_sorted" else b["op_arith_rtol"])
        if not e <= bound:
            failures.append(f"{label} operator {k}: {e:.3g} > {bound:.3g}")
    return errs


def ski_mean(gp, theta_simil, theta_noise, x, y, z, grid_size: int) -> torch.Tensor:
    """predict_ski's mu (its defaults: the "sorted" W^T in 1-D, CG 200 at
    tol 1e-6) without its variance's columns: the same operator and CG on y
    alone (each CG column runs and stops on its own, so y's column gives the
    whole call's alpha), then mu = Kstar^T alpha, M points at a time."""
    x = gski._points(x)
    ts, tn, _ = gski._thetas(gp, theta_simil, theta_noise, x)
    order = torch.argsort(x[:, 0], stable=True)
    x, y = x[order], gski._like(y, x)[order]
    mv = gski._ski_operator(gp, ts, tn, x, gski._resolve_dims(grid_size, 1), "sorted")
    alpha = iterative.cg_solve(mv, y[:, None], 200, 1e-6)[0][:, 0]
    return torch.cat([gp.simil.matrix(ts, x, gski._points(zz)).T @ alpha for zz in z.split(M)])


def phase_ski(dev) -> dict:
    """SKI at n = 65536 (each W^T form in f32 and f64 on the same probes,
    matrix-free beside them, predict_ski against predict_iterative), in 2-D
    at n = 262144, and sample_paths_ski at n = 131072."""
    b = SKI_BOUNDS
    gp, x, y = ski_problem(N_SKI, torch.float32, dev)
    _, x64, y64 = ski_problem(N_SKI, torch.float64, dev)
    v, v64 = ski_log_theta(dev, torch.float32), ski_log_theta(dev, torch.float64)
    failures, errors, cg, walls, peaks = [], {}, {}, {}, {}

    def lml(xx, yy, method, n_grid=G_SKI, est=SKI_ESTIMATOR, g_=gp):
        return lambda ts, tn: gski.lml_ski(g_, ts, tn, xx, yy, seeded_draws(dev, ITER_SEED), n_grid, method=method,
                                           **est)

    cb.reset_launch_counts()
    got, ref = {}, {}
    for m in SKI_METHODS:
        got[m], _, peaks[m], cg[m] = traced_call(lambda: theta_vg(lml(x, y, m), v))
        ref[m] = theta_vg(lml(x64, y64, m), v64)
        errors[f"{m}_f32_vs_f64"] = vg_errors(got[m], ref[m])
        gate(failures, f"{m} f32", errors[f"{m}_f32_vs_f64"], b, {"value_rel": "f32_value_rtol",
                                                                  "grad_rel": "f32_grad_rtol"})
        errors[f"{m}_vs_scatter_f32"] = vg_errors(got[m], got["scatter"])
        gate(failures, f"{m} against scatter", errors[f"{m}_vs_scatter_f32"], b,
             {"value_rel": "methods_value_rtol", "grad_rel": "methods_grad_rtol"})
        walls[f"lml_ski_{m}_vg"] = wall_ms(lambda: theta_vg(lml(x, y, m), v))
    emit({"phase": "ski_methods", "errors": errors, "walls_ms": walls, "peak_gib": peaks, "cg": cg,
          "values": {m: float(got[m][0]) for m in SKI_METHODS}, "grads": {m: got[m][1].tolist() for m in SKI_METHODS}})
    # bench_ski's anchor: matrix-free on the same probes (the same Rademacher
    # draws as lml_ski's at precond_rank 0), panel 2048
    free, walls["matfree_vg_first_call"], peaks["matfree"], cg["matfree"] = traced_call(lambda: theta_vg(
        lambda ts, tn: core.lml_iterative_matfree(gp, ts, tn, x, y, seeded_draws(dev, ITER_SEED), panel=FREE_PANEL,
                                                  **SKI_ESTIMATOR), v))
    errors["matfree_vs_scatter_f32"] = vg_errors(free, got["scatter"])

    # predict_ski (its default, "sorted") at m = 1024: f32 against f64 at n =
    # 65536, and against predict_iterative at x[::4]
    th, th64 = torch.exp(v), torch.exp(v64)
    z = torch.linspace(0.0, 1000.0, M, device=dev)
    pred, walls["predict_ski"], _, cg["predict_ski"] = traced_call(
        lambda: gski.predict_ski(gp, th[:2], th[2:], x, y, z, G_SKI))
    pred64 = gski.predict_ski(gp, th64[:2], th64[2:], x64, y64, z.double(), G_SKI)
    errors["predict_ski_f32_vs_f64"] = {"mu_abs": float((pred[0].double() - pred64[0]).abs().max()),
                                        "sigma_abs": float((pred[1].double() - pred64[1]).abs().max())}
    xs, ys = x[::SKI_PRED_STRIDE], y[::SKI_PRED_STRIDE]
    pred_s = gski.predict_ski(gp, th[:2], th[2:], xs, ys, z, G_SKI)
    pred_it, walls["predict_iterative_n16384"], _, cg["predict_iterative_n16384"] = traced_call(
        lambda: core.predict_iterative(gp, th[:2], th[2:], xs, ys, z, panel=FREE_PANEL))
    errors["predict_ski_vs_iterative_n16384"] = {
        "mu_abs": float((pred_s[0] - pred_it[0]).abs().max()), "sigma_abs": float((pred_s[1] - pred_it[1]).abs().max())}

    # predict_ski with CG run to convergence: f32 against f64 at every 16th
    # of the 1024 points
    zc = z[::16]
    conv = {}
    for label, (xx, yy, tt) in (("f32", (x, y, th)), ("f64", (x64, y64, th64))):
        conv[label], walls[f"predict_ski_converged_{label}"], _, cg[f"predict_ski_converged_{label}"] = traced_call(
            lambda: gski.predict_ski(gp, tt[:2], tt[2:], xx, yy, zc.to(tt.dtype), G_SKI, cg_iters=CONVERGED_CG))
    errors["predict_ski_converged_f32_vs_f64"] = {
        "mu_abs": float((conv["f32"][0].double() - conv["f64"][0]).abs().max()),
        "sigma_abs": float((conv["f32"][1].double() - conv["f64"][1]).abs().max())}
    for k, bound in (("mu_abs", "converged_mu_abs"), ("sigma_abs", "converged_sigma_abs")):
        if not errors["predict_ski_converged_f32_vs_f64"][k] <= b[bound]:
            failures.append(f"predict_ski converged {k} {errors['predict_ski_converged_f32_vs_f64'][k]:.3g}")
    errors["operator_n65536"] = operator_errors(gp, v, x, y, (G_SKI,), SKI_METHODS, b, failures, "1-D")

    # 2-D: one value and gradient at n = 262144 on a 512 x 512 grid (wall,
    # peak) and its operator against f64; f32 against f64 at n = 16384 on 64
    # x 64 at the twin's CG 60 (reported) and converged (held), with the
    # exact lml there
    gp2, x2, y2, v2 = ski2d_problem(N_SKI2D, torch.float32, dev)
    big2, walls["ski2d_vg_first_call"], peaks["ski2d"], cg["ski2d"] = traced_call(
        lambda: theta_vg(lml(x2, y2, "scatter", (G_SKI2D, G_SKI2D), g_=gp2), v2))
    walls["ski2d_vg"] = wall_ms(lambda: theta_vg(lml(x2, y2, "scatter", (G_SKI2D, G_SKI2D), g_=gp2), v2), reps=3)
    errors["operator_2d_n262144"] = operator_errors(gp2, v2, x2, y2, (G_SKI2D, G_SKI2D), ("scatter",), b, failures,
                                                    "2-D")
    small32 = ski2d_problem(N_SKI2D_CHECK, torch.float32, dev)
    small64 = ski2d_problem(N_SKI2D_CHECK, torch.float64, dev)
    s32 = theta_vg(lml(small32[1], small32[2], "scatter", (G_SKI2D_CHECK,) * 2, g_=gp2), small32[3])
    s64 = theta_vg(lml(small64[1], small64[2], "scatter", (G_SKI2D_CHECK,) * 2, g_=gp2), small64[3])
    errors["ski2d_f32_vs_f64"] = vg_errors(s32, s64)
    est_c = dict(SKI_ESTIMATOR, cg_iters=CONVERGED_CG)
    s32c, walls["ski2d_converged_f32"], _, cg["ski2d_converged_f32"] = traced_call(lambda: theta_vg(
        lml(small32[1], small32[2], "scatter", (G_SKI2D_CHECK,) * 2, est_c, gp2), small32[3]))
    s64c, walls["ski2d_converged_f64"], _, cg["ski2d_converged_f64"] = traced_call(lambda: theta_vg(
        lml(small64[1], small64[2], "scatter", (G_SKI2D_CHECK,) * 2, est_c, gp2), small64[3]))
    errors["ski2d_converged_f32_vs_f64"] = vg_errors(s32c, s64c)
    gate(failures, "2-D converged f32", errors["ski2d_converged_f32_vs_f64"], b,
         {"value_rel": "converged_value_rtol", "grad_rel": "converged_grad_rtol"})

    # sample_paths_ski at n = 131072: 16 paths, 2048 features, grid 8192,
    # "sorted", CG 100, evaluated at 4096 points; f32 against f64 on the
    # same draws (reported); the paths' mean against predict_ski's mu (f64)
    # at all 4096 points, 1024 at a time (each CG column freezes on its own,
    # so the chunks give the one call's answer), held for the f64 paths and
    # reported for the f32; then both W^T forms with CG run to convergence,
    # f32 against f64 (held)
    gpp, xp, yp = ski_problem(N_SKIPATH, torch.float32, dev)
    _, xp64, yp64 = ski_problem(N_SKIPATH, torch.float64, dev)
    zp = torch.linspace(0.0, 1000.0, SKIPATH_M, device=dev)
    errors["operator_n131072"] = operator_errors(gpp, v, xp, yp, (G_SKIPATH,), ("sorted", "scatter"), b, failures,
                                                 "paths")
    kw = dict(num_features=SKIPATH_F, grid_size=G_SKIPATH, cg_iters=100, method="sorted")
    ps, walls["sample_paths_ski_first_call"], peaks["sample_paths_ski"], cg["sample_paths_ski"] = traced_call(
        lambda: pathwise.sample_paths_ski(gpp, th[:2], th[2:], xp, yp, seeded_draws(dev, 1), SKIPATH_S, **kw))
    fs = pathwise.eval_paths(gpp, ps, zp)
    ps64 = pathwise.sample_paths_ski(gpp, th64[:2], th64[2:], xp64, yp64, seeded_draws(dev, 1), SKIPATH_S, **kw)
    fs64 = pathwise.eval_paths(gpp, ps64, zp.double())
    walls["sample_paths_ski"] = wall_ms(
        lambda: pathwise.sample_paths_ski(gpp, th[:2], th[2:], xp, yp, seeded_draws(dev, 1), SKIPATH_S, **kw), reps=3)
    walls["eval_paths"] = wall_ms(lambda: pathwise.eval_paths(gpp, ps, zp))
    errors["paths_f32_vs_f64_abs"] = float((fs.double() - fs64).abs().max())
    errors["paths_f64_max_abs"] = float(fs64.abs().max())
    mu_p, walls["predict_ski_path_mean_f64"], peaks["predict_ski_path_mean_f64"], _ = traced_call(
        lambda: ski_mean(gpp, th64[:2], th64[2:], xp64, yp64, zp.double(), G_SKIPATH))
    for label, paths in (("f64", fs64), ("f32", fs)):
        paths = paths.double()
        se = paths.std(0) / SKIPATH_S**0.5
        gap = (paths.mean(0) - mu_p).abs()
        errors[f"path_mean_{label}"] = {"max_abs": float(gap.max()), "max_se": float(se.max()), "over_bound": float(
            (gap / (b["path_mean_se"] * se + b["path_mean_atol"])).max())}
    if not errors["path_mean_f64"]["over_bound"] <= 1.0:
        failures.append(f"path mean (f64) {errors['path_mean_f64']['over_bound']:.3g} of its bound")
    for m in ("sorted", "scatter"):
        kc = dict(kw, cg_iters=CONVERGED_CG, method=m)
        paths_c = {}
        for label, (xx, yy, tt) in (("f32", (xp, yp, th)), ("f64", (xp64, yp64, th64))):
            psc, walls[f"sample_paths_ski_converged_{m}_{label}"], _, cg[f"paths_converged_{m}_{label}"] = traced_call(
                lambda: pathwise.sample_paths_ski(gpp, tt[:2], tt[2:], xx, yy, seeded_draws(dev, 1), SKIPATH_S, **kc))
            paths_c[label] = pathwise.eval_paths(gpp, psc, zp.to(tt.dtype)).double()
        errors[f"paths_converged_{m}_f32_vs_f64_abs"] = float((paths_c["f32"] - paths_c["f64"]).abs().max())
        if not errors[f"paths_converged_{m}_f32_vs_f64_abs"] <= b["converged_paths_abs"]:
            failures.append(f"converged {m} paths f32 {errors[f'paths_converged_{m}_f32_vs_f64_abs']:.3g} from f64")
    engine_launches = launched()
    if engine_launches:
        failures.append(f"the SKI path launched {engine_launches}")
    with linalg.force_plain():
        exact2 = theta_vg(lambda ts, tn: core.lml(gp2, ts, tn, small64[1], small64[2]), small64[3])
    errors["ski2d_f64_vs_exact"] = vg_errors(s64, exact2)
    if not finite(*got["scatter"], *pred, *big2, fs):
        failures.append("non-finite SKI value, gradient, prediction or path")
    emit({"phase": "ski", "n": N_SKI, "grid": G_SKI, "estimator": SKI_ESTIMATOR, "bounds": b, "errors": errors,
          "walls_ms": walls, "peak_gib": peaks, "cg": cg,
          "values": {m: float(got[m][0]) for m in SKI_METHODS} | {"matfree": float(free[0]),
                                                                  "ski2d_n262144": float(big2[0])},
          "grads": {m: got[m][1].tolist() for m in SKI_METHODS} | {"matfree": free[1].tolist()},
          "ski2d_check": {"n": N_SKI2D_CHECK, "grid": G_SKI2D_CHECK, "f32": float(s32[0]), "f64": float(s64[0]),
                          "f32_converged": float(s32c[0]), "f64_converged": float(s64c[0]),
                          "exact_f64": float(exact2[0])}})
    if failures:
        raise AssertionError(f"ski phase: {failures}")
    return {}


def lnb_logp(gp, x, y, dev):
    """The SKI surrogate's log-joint over (chains, 3) log-thetas: one batched
    lml_ski with the run's fixed probes, plus N(0, 1) priors."""

    def logp(V):
        th = torch.exp(V)
        draws = seeded_draws(dev, LNB_PROBE_SEED)
        lml = gski.lml_ski(gp, th[:, :2], th[:, 2:], x, y, draws, G_LNB, method=LNB_METHOD, **ESTIMATOR)
        return lml + dists.normal_logp(0.0, 1.0, V).sum(-1)

    return logp


def phase_large_n_bayes(dev) -> dict:
    """ChEES on the SKI surrogate at n = 65536 (benchmarks/large_n_bayes.py
    --ski): one batched value and gradient of 8 chains timed, the MLE warm
    start, then LNB_WARMUP + LNB_SAMPLES transitions in lockstep."""
    gp, x, y = ski_problem(N_LNB, torch.float32, dev, span=LNB_X, period=3.0)
    logp = lnb_logp(gp, x, y, dev)
    calls = [0]

    def counted(V):
        calls[0] += 1
        return logp(V)

    vg = hmc.value_and_grad(counted, None)
    cb.reset_launch_counts()
    V8 = torch.zeros(LNB_CHAINS, 3, device=dev)
    (lp8, g8), vg_first_ms, vg_peak, cg8 = traced_call(lambda: vg(V8))
    vg_ms = wall_ms(lambda: vg(V8))
    vg1_ms = wall_ms(lambda: vg(V8[:1]))

    # the MLE warm start: Adam from 0, 10 chunks of 20 steps
    t0 = time.perf_counter()
    v_cur = torch.zeros(3, device=dev)
    for _ in range(LNB_ADAM_CHUNKS):
        opt = mle.adam(lambda v: tuple(t[0] for t in vg(v[None])), v_cur, iters=LNB_ADAM_STEPS, rate=LNB_ADAM_RATE)
        v_cur = opt.x
    torch.cuda.synchronize()
    mle_s = time.perf_counter() - t0
    emit({"phase": "large_n_bayes_setup", "vg_ms": {"chains8": vg_ms, "chains8_first_call": vg_first_ms,
                                                    "chain1": vg1_ms}, "vg_peak_gib": vg_peak, "vg_cg": cg8,
          "mle": {"v": v_cur.tolist(), "value": float(opt.value), "wall_s": mle_s}})
    gen = torch.Generator(device=dev).manual_seed(LNB_SEED + 1)
    x0 = v_cur[None, :] + LNB_SPREAD * torch.randn((LNB_CHAINS, 3), generator=gen, device=dev)
    calls[0] = 0
    t0 = time.perf_counter()
    res = chees.run_chees(counted, x0, torch.Generator(device=dev).manual_seed(LNB_SEED), num_warmup=LNB_WARMUP,
                          num_samples=LNB_SAMPLES, init_step_size=LNB_STEP, init_traj_length=LNB_TRAJ,
                          max_num_steps=LNB_MAX_STEPS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    pos = res.positions  # (samples, chains, 3)
    summ = _posterior_summary(pos)
    finite_frac = float(torch.isfinite(res.logps).double().mean())
    out = {"n": N_LNB, "grid": G_LNB, "method": LNB_METHOD, "chains": LNB_CHAINS, "warmup": LNB_WARMUP,
           "samples": LNB_SAMPLES, "estimator": ESTIMATOR,
           "vg_ms": {"chains8": vg_ms, "chains8_first_call": vg_first_ms, "chain1": vg1_ms},
           "vg_peak_gib": vg_peak, "vg_cg": cg8, "mle": {"v": v_cur.tolist(), "value": float(opt.value),
                                                         "wall_s": mle_s},
           "run_wall_s": run_s, "transitions": LNB_WARMUP + LNB_SAMPLES, "vg_calls": calls[0],
           "ms_per_vg_in_run": 1e3 * run_s / max(calls[0], 1),
           "accept_sampling": float(res.accept_probs.mean()), "step_size": float(res.state.step_size),
           "traj_length": float(torch.exp(res.state.log_traj)), "min_bulk_ess": summ["min_bulk_ess"],
           "max_bulk_rhat": summ["max_bulk_rhat"], "posterior_mean": summ["mean"].tolist(),
           "ess_per_s_run": summ["min_bulk_ess"] / run_s, "finite_frac": finite_frac,
           "launches": launched()}
    emit({"phase": "large_n_bayes", **out})
    failures = []
    if launched():
        failures.append(f"launched {launched()}")
    if not (finite_frac == 1.0 and finite(pos, lp8, g8)):
        failures.append("non-finite chains")
    if failures:
        raise AssertionError(f"large_n_bayes phase: {failures}")
    return {}


# The exact leg of benchmarks/large_n_bayes.py (:45-63, 132-240, its
# default): ChEES over the 3 log-thetas of bench.py's noisy sine at n = 1024
# (x sorted uniform on [0, 100] in f32, y = sin(x/3) + 0.1 N(0, 1) from numpy
# seed 0), rbf.scaled() + uniform_noise, N(0, 1) priors, 8 chains.  The
# batched log-joint is ``torch.func.vmap`` of gp_observe plus the priors, as
# tutorial/bayes.py builds one: on the card it takes the batched route (the
# library's batched Cholesky, one K5 launch over the 8 x 8 diagonal tiles, K4
# over the batch both ways), at the twin's default precision "tensorfloat32".
# The MLE warm start is Adam 300 at 0.05 on the plain route (the twin's
# force_xla); then spread 0.05, step 0.01, trajectory 0.1, at most 64
# leapfrog steps, 256 + 256 transitions; the predictive mixture of the
# chains' last draws at 256 points runs the stepwise driver (K2 over the 8
# draws, once per block column) and the blocked TRSM (K5).
N_LNBX, LNBX_CHAINS, LNBX_SEED, LNBX_M = 1024, 8, 0, 256
LNBX_WARMUP, LNBX_SAMPLES = 256, 256
LNBX_ADAM_ITERS, LNBX_ADAM_RATE = 300, 0.05
LNBX_PRECISION = "tensorfloat32"
# Bounds: 10x the errors that tests/batched_bounds.py shows on the CPU at
# the phase's full size and at its starting positions (f32 against f64 on
# the plain route; TF32 emulated by cutting the blocked drivers' matmul
# inputs to 10 mantissa bits; each kernel's algorithm against its plain
# version in f32 at the phase's shapes), in brackets.  The first bounds,
# from another 8 positions and with TF32 rounded to nearest, put the
# gradient at "tensorfloat32" at 3.0e-3; an H100 showed 4.9e-3 (PERF.md).
LNBX_BOUNDS = {
    "value_rtol": 1.3e-4,  # each chain's log-joint, both precisions (1.24e-5)
    "grad_f32_rtol": 4.8e-3,  # the gradient at "float32", of its largest entry (4.75e-4)
    "grad_tf32_rtol": 5.3e-2,  # at "tensorfloat32" (5.29e-3, emulated)
    "k4_rtol": 4.8e-5,  # K4 both ways on the 8 factors (4.78e-6, 4.66e-6)
    "k5_rtol": 2.0e-5,  # K5 on the 64 diagonal tiles (1.93e-6)
    "k2_rtol": 1.4e-3,  # K2 on the 8 first diagonal tiles: factor 3.87e-5, inverse 1.37e-4
    "mixture_mu_atol": 2.9e-4,  # the mixture's mean (2.90e-5)
    "mixture_sigma_atol": 2.9e-4,  # and std (2.84e-5)
}
# The launches of one batched value and gradient on the kernel route.
LNBX_CALL_LAUNCHES = {"tril_inv_tile": 1, "trsv2d_lower": 1, "trsv2d_lower_t": 1}


def lnbx_problem(dtype: torch.dtype, dev):
    """large_n_bayes.py's build_problem (:45-63): x in f32 (both dtypes hold
    the same inputs), y from the f32 x."""
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0, 100, (N_LNBX, 1)), axis=0).astype(np.float32)
    y = np.sin(x[:, 0].astype(np.float64) / 3.0) + 0.1 * rng.normal(size=N_LNBX)
    gp = GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)
    return gp, torch.as_tensor(x, dtype=dtype, device=dev), torch.as_tensor(y.astype(np.float32), dtype=dtype,
                                                                             device=dev)


def lnbx_covs(dev, V: torch.Tensor | None = None) -> torch.Tensor:
    """The exact leg's (chains, n, n) covariances at log-thetas V (f32);
    by default the chains' spread around 0."""
    gp, x, _ = lnbx_problem(torch.float32, dev)
    if V is None:
        V = LNB_SPREAD * torch.randn((LNBX_CHAINS, 3), generator=torch.Generator(device=dev).manual_seed(0),
                                     device=dev)
    return torch.func.vmap(lambda t: core.masked_cov(gp, t[:2], t[2:], x, None))(torch.exp(V))


def lnbx_positions(v_mle: torch.Tensor) -> torch.Tensor:
    """The chains' starting positions: the MLE plus LNB_SPREAD N(0, 1) from
    numpy (seed LNBX_SEED + 1), the same draws on any device, so that the
    CPU runs behind LNBX_BOUNDS (tests/batched_bounds.py) start where the
    card does."""
    eps = np.random.default_rng(LNBX_SEED + 1).normal(size=(LNBX_CHAINS, 3))
    return v_mle[None, :] + LNB_SPREAD * torch.as_tensor(eps, dtype=v_mle.dtype, device=v_mle.device)


def lnbx_logp(gp, x, y, precision=None):
    """The batched log-joint as tutorial/bayes.py builds one:
    ``torch.func.vmap`` of gp_observe plus N(0, 1) priors."""

    def one(v):
        return gp_observe(gp, v, x=x, y=y, precision=precision) + dists.normal_logp(0.0, 1.0, v).sum()

    return torch.func.vmap(one)


def lnbx_kernel_cases(x, y, V) -> dict:
    """K2, K4 both ways and K5 at the shapes this path gives them, on the
    covariances of the positions V: key -> (kernel, plain, shape, reps,
    library, rtol)."""
    Ks = lnbx_covs(x.device, V)
    L = torch.linalg.cholesky(Ks).contiguous()
    tiles = diag_tiles(L)  # (8, 8, 128, 128): the LML core's one K5 launch
    invs = cb.tril_inv_tile_plain(tiles).contiguous()
    y8 = y.expand(V.shape[0], -1).contiguous()
    z = cb.trsv_lower_plain(L, y8).contiguous()
    first = Ks[:, :BLOCK, :BLOCK].contiguous()  # the stepwise driver's first K2 launch over the 8 draws
    eye = torch.eye(BLOCK, device=x.device)
    b = LNBX_BOUNDS
    return {
        "chol_inv_tile": (lambda: cb.cholesky_inv_tile(first), lambda: cb.cholesky_inv_tile_plain(first), first.shape,
                          50, lambda: torch.linalg.solve_triangular(torch.linalg.cholesky(first), eye, upper=False),
                          b["k2_rtol"]),
        "trsv2d_lower": (lambda: cb.trsv2d_lower(L, y8, invs, BLOCK), lambda: cb.trsv_lower_plain(L, y8), L.shape, 20,
                         lambda: torch.linalg.solve_triangular(L, y8[..., None], upper=False), b["k4_rtol"]),
        "trsv2d_lower_t": (lambda: cb.trsv2d_lower_t(L, z, invs, BLOCK), lambda: cb.trsv_lower_t_plain(L, z), L.shape,
                           20, lambda: torch.linalg.solve_triangular(L.mT, z[..., None], upper=True), b["k4_rtol"]),
        "tril_inv_tile": (lambda: cb.tril_inv_tile(tiles), lambda: cb.tril_inv_tile_plain(tiles), tiles.shape, 20,
                          lambda: torch.linalg.solve_triangular(tiles, eye, upper=False), b["k5_rtol"]),
    }


def phase_large_n_bayes_exact(dev) -> dict:
    """The exact leg of large_n_bayes.py, its parts that time the card (no
    worker beside them): the MLE warm start, the chains' starting positions,
    K2, K4 both ways and K5 against their plain versions at this path's
    shapes, one batched value and gradient of the 8 chains on the kernel
    route and under force_plain at both precisions (walls, errors against
    f64 on the plain route, the launches of one call).  Returns the rows and
    the starting positions for :func:`lnbx_sampler`."""
    failures = []
    b = LNBX_BOUNDS
    gp, x, y = lnbx_problem(torch.float32, dev)
    _, x64, y64 = lnbx_problem(torch.float64, dev)
    # the MLE warm start on the plain route, f32
    t0 = time.perf_counter()
    with linalg.force_plain():
        vg1 = hmc.value_and_grad(lnbx_logp(gp, x, y), None)
        opt = mle.adam(lambda v: tuple(t[0] for t in vg1(v[None])), torch.zeros(3, device=dev),
                       iters=LNBX_ADAM_ITERS, rate=LNBX_ADAM_RATE)
    torch.cuda.synchronize()
    mle_s = time.perf_counter() - t0
    x0 = lnbx_positions(opt.x)

    rows = {}
    for key, (kernel, plain, shape, reps, library, rtol) in lnbx_kernel_cases(x, y, x0).items():
        rows["large_n_bayes_exact", key] = check_kernel("large_n_bayes_exact", key, kernel, plain, shape, reps,
                                                        library, rtol=rtol)

    with linalg.force_plain():
        want_v, want_g = hmc.value_and_grad(lnbx_logp(gp, x64, y64), None)(x0.double())
    errors, vg_ms, launches = {}, {}, {}
    for precision in ("tensorfloat32", "float32"):
        vg = hmc.value_and_grad(lnbx_logp(gp, x, y, precision), None)
        cb.reset_launch_counts()
        v, g = vg(x0)
        torch.cuda.synchronize()
        launches[precision] = {k: n for k, n in cb.LAUNCHES.items() if n}
        errors[precision] = {"value_rel": float(((v.double() - want_v).abs() / want_v.abs()).max()),
                             "grad_rel": float((g.double() - want_g).abs().max() / want_g.abs().max())}
        vg_ms[f"kernels_{precision}"] = wall_ms(lambda: vg(x0), reps=21)
        with linalg.force_plain():
            vg_ms[f"plain_{precision}"] = wall_ms(lambda: vg(x0), reps=21)
        if launches[precision] != LNBX_CALL_LAUNCHES:
            failures.append(f"one value and gradient at {precision} launched {launches[precision]}, "
                            f"expected {LNBX_CALL_LAUNCHES}")
        grad_bound = b["grad_tf32_rtol" if precision == "tensorfloat32" else "grad_f32_rtol"]
        if not (errors[precision]["value_rel"] <= b["value_rtol"] and errors[precision]["grad_rel"] <= grad_bound):
            failures.append(f"value and gradient at {precision} off f64: {errors[precision]}")
    emit({"phase": "large_n_bayes_exact_setup", "n": N_LNBX, "chains": LNBX_CHAINS, "bounds": b,
          "mle": {"v": opt.x.tolist(), "value": float(opt.value), "wall_s": mle_s}, "x0": x0.tolist(),
          "vg_ms": vg_ms, "errors": errors, "launches_one_call": launches})
    if failures:
        raise AssertionError(f"large_n_bayes_exact phase: {failures}")
    return {"rows": rows, "x0": x0.tolist()}


def lnbx_sampler(dev, x0: list) -> dict:
    """The exact leg's main path from ``x0``: ChEES over the 8 chains for
    LNBX_WARMUP + LNBX_SAMPLES transitions on the kernel route at
    LNBX_PRECISION, then the predictive mixture of the chains' last draws at
    LNBX_M points against f64 on the plain route, the launch counts of both
    set to 0 just before and held (K5 and K4 both ways once per value and
    gradient, K5 once and K2 once per block column in the mixture, no K1).
    Reports acceptance, step size, ESS, R-hat and the NaN fraction; a chain
    that does not mix is reported, not held.  Returns the report and the
    launch counts."""
    failures = []
    gp, x, y = lnbx_problem(torch.float32, dev)
    _, x64, y64 = lnbx_problem(torch.float64, dev)
    logp = lnbx_logp(gp, x, y, LNBX_PRECISION)
    calls = [0]

    def counted(V):
        calls[0] += 1
        return logp(V)

    x0 = torch.tensor(x0, device=dev)
    cb.reset_launch_counts()
    t0 = time.perf_counter()
    res = chees.run_chees(counted, x0, torch.Generator(device=dev).manual_seed(LNBX_SEED), num_warmup=LNBX_WARMUP,
                          num_samples=LNBX_SAMPLES, init_step_size=LNB_STEP, init_traj_length=LNB_TRAJ,
                          max_num_steps=LNB_MAX_STEPS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    sampler_launches = dict(cb.LAUNCHES)
    last = res.positions[-1]  # (chains, 3)
    z = torch.linspace(0.0, 100.0, LNBX_M, device=dev)
    mix = core.predict_mixture(gp, last, x, y, z)
    torch.cuda.synchronize()
    launches = dict(cb.LAUNCHES)
    with linalg.force_plain():
        mix64 = core.predict_mixture(gp, last.double(), x64, y64, z.double())
    expect = {k: 0 for k in launches} | {"trsv2d_lower": calls[0], "trsv2d_lower_t": calls[0],
                                         "tril_inv_tile": calls[0] + 1, "chol_inv_tile": N_LNBX // BLOCK}
    if launches != expect:
        failures.append(f"launched {launches}, expected {expect} ({calls[0]} value-and-gradient calls)")
    if sampler_launches["chol_inv_tile"] or sampler_launches["fused_cholesky_invs"]:
        failures.append(f"the sampler launched K1 or K2: {sampler_launches}")
    err = {"mu_abs": float((mix[0].double() - mix64[0]).abs().max()),
           "sigma_abs": float((mix[1].double() - mix64[1]).abs().max())}
    if not (err["mu_abs"] <= LNBX_BOUNDS["mixture_mu_atol"] and err["sigma_abs"] <= LNBX_BOUNDS["mixture_sigma_atol"]):
        failures.append(f"mixture off f64: {err}")
    summ = _posterior_summary(res.positions)
    finite_frac = float(torch.isfinite(res.logps).double().mean())
    if not (finite_frac == 1.0 and finite(res.positions, *mix)):
        failures.append("non-finite chains or mixture")
    out = {"phase": "large_n_bayes_exact", "n": N_LNBX, "chains": LNBX_CHAINS, "warmup": LNBX_WARMUP,
           "samples": LNBX_SAMPLES, "precision": LNBX_PRECISION, "run_wall_s": run_s, "vg_calls": calls[0],
           "ms_per_vg_in_run": 1e3 * run_s / max(calls[0], 1),
           "accept_sampling": float(res.accept_probs.mean()), "step_size": float(res.state.step_size),
           "traj_length": float(torch.exp(res.state.log_traj)), "min_bulk_ess": summ["min_bulk_ess"],
           "max_bulk_rhat": summ["max_bulk_rhat"], "posterior_mean": summ["mean"].tolist(),
           "ess_per_s_run": summ["min_bulk_ess"] / run_s, "finite_frac": finite_frac, "nan_frac": 1.0 - finite_frac,
           "mixture_errors": err, "launches": launches}
    emit(out)
    if failures:
        raise AssertionError(f"large_n_bayes_exact phase: {failures}")
    return {"report": out, "launches": launches}


def lnbx_worker(x0: list) -> dict:
    """:func:`lnbx_sampler` in a worker process (spawned, as
    :func:`sampler_worker`), its JSON line kept for the main process to
    print."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    lines = io.StringIO()
    try:
        with contextlib.redirect_stdout(lines):
            out = lnbx_sampler(torch.device("cuda", 0), x0)
    except Exception as e:  # with its lines so far: a worker's stdout is this buffer
        raise RuntimeError(f"{type(e).__name__}: {e}\n{lines.getvalue()}") from None
    return {**out, "stdout": lines.getvalue()}


def _partial_large_n_bayes_exact(dev) -> dict:
    setup = phase_large_n_bayes_exact(dev)
    return {**setup, **lnbx_sampler(dev, setup["x0"])}


# The utilities on the card: a ServingPosterior at the serving problem's n
# checkpointed and restored; ``utils.timed`` of one request batch beside
# this script's own device time of it; 100 batches of 4096 rows from a
# packed 65536-row dataset, native loader against the Python stream.
UTILS_N_ROWS, UTILS_BATCH, UTILS_BATCHES = 65536, 4096, 100


def phase_utils(dev) -> dict:
    failures = []
    work_dir = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke_utils"
    work_dir.mkdir(parents=True, exist_ok=True)
    gp, x, y, _, ts, tn, z = problem(torch.float32, dev)
    walls = {}
    sp = timed_call(walls, "fit_serving", serve.fit_serving, gp, ts, tn, x, y)
    want = serve.serve_predict(gp, sp, z)
    t0 = time.perf_counter()
    gutils.save(work_dir / "serving.pt", sp)
    back = gutils.restore(work_dir / "serving.pt", like=sp)
    torch.cuda.synchronize()
    walls["checkpoint_round_trip"] = (time.perf_counter() - t0) * 1e3
    got = serve.serve_predict(gp, back, z)
    identical = type(back) is serve.ServingPosterior and all(torch.equal(a, b) for a, b in zip(back, sp)) and all(
        torch.equal(a, b) for a, b in zip(got, want))
    if not identical:
        failures.append("the restored ServingPosterior does not serve the same answers")
    timed = {"utils_timed_ms": gutils.timed(lambda: serve.serve_predict(gp, sp, z), reps=21),
             "event_ms": event_ms(lambda: serve.serve_predict(gp, sp, z), 21),
             "wall_ms": wall_ms(lambda: serve.serve_predict(gp, sp, z), reps=21)}
    rng = np.random.default_rng(0)
    xd = rng.uniform(0, 100, (UTILS_N_ROWS, 1))
    path = work_dir / "rows.ggpd"
    dataio.pack_dataset(path, xd, np.sin(xd[:, 0] / 3.0) + 0.1 * rng.normal(size=UTILS_N_ROWS))
    streams = {}
    for label, use_native in (("native", True), ("python", False)):
        t0 = time.perf_counter()
        with dataio.MinibatchStream(path, batch=UTILS_BATCH, seed=1, native=use_native) as st:
            batches = [next(st) for _ in range(UTILS_BATCHES)]
        streams[label] = (batches, time.perf_counter() - t0)
    same = all(a[0].tobytes() == b[0].tobytes() and a[1].tobytes() == b[1].tobytes()
               for a, b in zip(streams["native"][0], streams["python"][0]))
    if not same:
        failures.append("the native loader's batches differ from the Python stream's")
    emit({"phase": "utils", "n": N, "checkpoint_identical": identical, "walls_ms": walls, "timed": timed,
          "stream": {"rows": UTILS_N_ROWS, "batch": UTILS_BATCH, "batches": UTILS_BATCHES, "bit_identical": same,
                     "native_s": streams["native"][1], "python_s": streams["python"][1]}})
    if failures:
        raise AssertionError(f"utils phase: {failures}")
    return {}


def coldstart_child(parts: bool) -> None:
    """The first ``laplace_fit`` of the classify problem in this (fresh)
    process, after the card's context and K1's first launch, which every
    path pays anyway.  With ``parts``, what it does first for the first time
    is timed before it, step by step: ``torch.broadcast_shapes`` (which
    imports torch._refs, sympy with it), a ``torch.func`` transform (which
    loads its decompositions) and the likelihood's ``grads`` (vmap of grad
    of grad).  Prints one JSON object of walls in ms."""
    dev = torch.device("cuda", 0)
    walls = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t0) * 1e3

    _build.library()
    step("cuda_context", lambda: torch.zeros(1, device=dev))
    step("k1_first_launch", lambda: cb.fused_cholesky_invs(torch.eye(1024, device=dev)))
    gp, x, y, ts, tl, _ = classify_problem(torch.float32, dev)
    lik = likelihoods.bernoulli_logit
    if parts:
        step("broadcast_shapes_first", lambda: torch.broadcast_shapes((2,), (3, 2)))
        step("torch_func_first", lambda: torch.func.vmap(torch.func.grad(lambda v: (v * v).sum()))(
            torch.ones(3, 2, device=dev)))
        step("likelihood_grads_first", lambda: lik.grads(tl, torch.zeros_like(y), y, torch.ones_like(y)))
    step("laplace_fit_first", lambda: laplace.laplace_fit(gp, lik, ts, tl, x, y))
    step("laplace_fit_second", lambda: laplace.laplace_fit(gp, lik, ts, tl, x, y))
    print(json.dumps(walls), flush=True)


def phase_coldstart(dev) -> None:
    """Where the first ``laplace_fit`` of a process spends its time: two
    fresh processes (:func:`coldstart_child`), one that calls it first and
    one that first takes apart what it does for the first time.  In no whole
    run."""
    del dev
    out = {}
    for parts in (False, True):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", f"import chip_smoke; chip_smoke.coldstart_child({parts})"],
                              capture_output=True, text=True, timeout=600, check=True,
                              cwd=pathlib.Path(__file__).resolve().parent)
        walls = json.loads(proc.stdout.strip().splitlines()[-1])
        walls["process_wall"] = (time.perf_counter() - t0) * 1e3
        out["parts" if parts else "whole"] = walls
    emit({"phase": "coldstart", "walls_ms": out})


def _partial_slice(dev) -> None:
    phase_launches(*phase_slice(dev))


# --- the parallel phase: gogp_torch.parallel and ops.distributed ------------------

# (a) In this process, an NCCL group of world size 1 on the large path's
# problem (n = 16384, rbf.scaled() + uniform_noise, log-theta 0, f32, block
# 128 = K2's tile): the row-sharded Cholesky and both solves, the
# row-sharded value and gradient (PAR_VG_CALLS calls), the row-sharded
# iterative form at each of PAR_PRECOND_RANKS, and BASELINE.json's fifth
# configuration, run_smc_large_n with HMC mutation at full width, cut to
# PAR_SMC (the cuts are PERF.md section 4's).
PAR_BLOCK = BLOCK
PAR_VG_CALLS = 3
PAR_PRECOND_RANKS = (0, 32)
PAR_ITER_SEED = 5
PAR_SMC = dict(num_particles=4, sigma0=0.5, max_stages=1, num_mcmc_steps=1, n_leapfrog=2)
# (b) Four spawned ranks on cuda:0 over gloo, each case against the same call
# on rank 0 alone (a 1x1 mesh of the same world): the LML at n = 4096 (block
# 128, n_local 1024), ChEES and SMC on hyperpriors with the chains and
# particles over the ranks, and both sharded serving calls at n = 4096.
PAR_WORLD = 4
PAR_N_RANKS = 4096
PAR_CHEES = dict(chains=64, num_warmup=32, num_samples=32, max_num_steps=8)
PAR_HP_SMC = dict(num_particles=64, max_stages=3, num_mcmc_steps=2, n_leapfrog=4)
PAR_SERVE_DRAWS = 8
# The ranks' case groups: PR 17's four cases ("samplers": the LML, ChEES,
# SMC and serving) and the graft entry's dry run on four ranks ("graft").
PAR_CASES = ("samplers", "graft")
# Bounds of the parallel phase, f32, written before its first run on the
# card: 10 times what the same case gave in f32 on the CPU (the world-1
# cases at n = 4096 there; PERF.md).  Where the CPU gave exactly 0 the bound
# is 10 f32 roundoffs (6e-7 relative; 2e-6 absolute on positions of scale
# about 3).  The gradient's is 10 times the single-card kernel path's error
# on this problem on the H100 (1.21e-7, the large phase; PERF.md), the CPU's
# 6.6e-9 at n = 4096 not being the same case.
PAR_BOUNDS = {
    "chol_rel": 3.4e-6,  # the row-sharded factor against cuSOLVER's, relative to its largest entry (CPU 3.37e-7)
    "solve_rel": 1.5e-5,  # alpha from both row-sharded solves against cholesky_solve (CPU 1.49e-6)
    "value_rel": 6.0e-7,  # the row-sharded LML against the f64 plain path's, relative (CPU 5.98e-8)
    "grad_rel": 1.2e-6,  # its gradient, relative to the largest entry
    "iter_value_rel": 6.0e-7,  # the row-sharded iterative LML against the dense one, same probes (CPU 0)
    "iter_grad_rel": 6.0e-7,  # (CPU 8.1e-9 at rank 0, 1.6e-8 at rank 32)
    "ranks_lml_value_rel": 6.0e-7,  # (b): 4 ranks against 1, the LML at n = 4096 (CPU 0)
    "ranks_lml_grad_rel": 6.5e-7,  # (CPU 6.5e-8)
    "ranks_chees_abs": 2e-6,  # ChEES positions, 4 ranks against 1 (CPU 0)
    "ranks_smc_abs": 2e-6,  # SMC particles (CPU 0)
    "ranks_serve_rel": 4.7e-5,  # mixture and request-sharded (mu, sigma), relative to the largest entry (CPU 4.69e-6)
}
# The batch witness's bound: a chain's log-joint value (and gradient) in a
# batch of 64 and in slabs of 16 part by at most this many times the largest
# error of the one-batch f32 evaluation against f64 on the same positions.
PAR_WITNESS_ROUNDING = 2.0
# K2 on the world-1 path (PATH_KERNELS["parallel"]); K2 (the LML), K7
# (ChEES and SMC on hyperpriors), K1 and K5 (serving) on the four ranks'
# paths (PATH_KERNELS["parallel_ranks"]).


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite values in a parallel result")
    return float((got - want).abs().max() / max(float(want.abs().max()), 1e-30))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _timed(dev, fn):
    """(fn(), its wall in ms, the card synchronized before and after)."""
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, (time.perf_counter() - t0) * 1e3


def _count_lml_calls():
    """A context in which ops.distributed.lml_rowsharded counts its calls
    (each one row-sharded factorization)."""
    from gogp_torch.ops import distributed as dops

    calls = [0]
    real = dops.lml_rowsharded

    def counted(*a, **k):
        calls[0] += 1
        return real(*a, **k)

    return unittest.mock.patch.object(dops, "lml_rowsharded", counted), calls


def parallel_world1(dev, n: int = N_LARGE, smc: dict | None = None) -> dict:
    """(a): the row-sharded exact GP on a real process group of one rank
    (NCCL on the card), measured and held against the single-card path."""
    import torch.distributed as dist
    from gogp_torch.ops import distributed as dops
    from gogp_torch.parallel import large_n, mesh as pmesh

    pmesh.init_multihost(f"127.0.0.1:{_free_port()}", 1, 0, backend="nccl" if dev.type == "cuda" else "gloo")
    try:
        mesh = pmesh.make_mesh(1, 1)
        emit({"phase": "parallel", "run": "world1", **pmesh.describe(mesh)})
        return _parallel_world1(dev, mesh, n, smc or PAR_SMC, dops, large_n, pmesh)
    finally:
        dist.destroy_process_group()


def _parallel_world1(dev, mesh, n, smc, dops, large_n, pmesh) -> dict:
    data = pmesh.DATA_AXIS
    args32 = large_problem(n, torch.float32, dev)
    args64 = large_problem(n, torch.float64, dev)
    gp, x, y, v0, _ = args32
    theta = torch.exp(v0)
    ts, tn = theta[: gp.n_theta_simil], theta[gp.n_theta_simil:]
    K = core.masked_cov(gp, ts, tn, x, None)
    nb = n // PAR_BLOCK
    out, errors, ms, launches = {}, {}, {}, {}

    # the main path: counts set to 0 just before, read just after
    cb.reset_launch_counts()
    with mesh:
        L, ms["cholesky_first"] = _timed(dev, lambda: dops.cholesky_rowsharded(K, data, PAR_BLOCK))
        launches["cholesky"] = dict(cb.LAUNCHES)
        z, ms["solve_lower_first"] = _timed(dev, lambda: dops.solve_lower_rowsharded(L, y, data, PAR_BLOCK))
        alpha, ms["solve_upper_first"] = _timed(dev, lambda: dops.solve_upper_rowsharded(L, z, data, PAR_BLOCK))
        # warm: the first calls above include the group's and the kernels' set-up
        L, ms["cholesky"] = _timed(dev, lambda: dops.cholesky_rowsharded(K, data, PAR_BLOCK))
        z, ms["solve_lower"] = _timed(dev, lambda: dops.solve_lower_rowsharded(L, y, data, PAR_BLOCK))
        alpha, ms["solve_upper"] = _timed(dev, lambda: dops.solve_upper_rowsharded(L, z, data, PAR_BLOCK))
    logp = large_n.make_rowsharded_logp(gp, x, x, y, torch.ones_like(y), data, PAR_BLOCK)
    vg = large_n.make_rowsharded_value_and_grad(logp, data)
    cb.reset_launch_counts()
    vg_ms = []
    with mesh:
        for _ in range(PAR_VG_CALLS):
            (value, grad), t = _timed(dev, lambda: vg(v0))
            vg_ms.append(t)
    launches["value_and_grad"] = dict(cb.LAUNCHES)
    ms["value_and_grad"] = vg_ms

    L_ref, ms["cusolver_cholesky"] = _timed(dev, lambda: torch.linalg.cholesky(K))
    errors["chol_rel"] = _rel(L, L_ref)
    errors["solve_rel"] = _rel(alpha, torch.cholesky_solve(y[:, None], L_ref)[:, 0])
    del L, L_ref, z, alpha
    (v32, g32), ms["single_card_value_and_grad"] = _timed(dev, lambda: value_and_grad_step(*args32))
    with linalg.force_plain():
        v64, g64 = value_and_grad_step(*args64)
    errors["value_rel"] = abs(float(value) - float(v64)) / abs(float(v64))
    errors["grad_rel"] = _rel(grad, g64)
    errors["value_rel_single_card_f32"] = abs(float(v32) - float(v64)) / abs(float(v64))
    errors["grad_rel_single_card_f32"] = _rel(g32, g64)

    # the row-sharded iterative form against the dense one, same probes
    for rank in PAR_PRECOND_RANKS:
        def rows_vg(rank=rank):
            lp = large_n.make_rowsharded_logp(gp, x, x, y, torch.ones_like(y), data, PAR_BLOCK, method="iterative",
                                              draws=seeded_draws(dev, PAR_ITER_SEED), precond_rank=rank)
            with mesh:
                return large_n.make_rowsharded_value_and_grad(lp, data)(v0)

        def dense_vg(rank=rank):
            vv = v0.clone().requires_grad_(True)
            th = torch.exp(vv)
            val = core.lml_iterative(gp, th[: gp.n_theta_simil], th[gp.n_theta_simil:], x, y,
                                     seeded_draws(dev, PAR_ITER_SEED), precond_rank=rank)
            (g,) = torch.autograd.grad(val, vv)
            return val.detach(), g

        rows_vg()  # warm
        (vi, gi), ms[f"iterative_rank{rank}"] = _timed(dev, rows_vg)
        (vd, gd), ms[f"dense_iterative_rank{rank}"] = _timed(dev, dense_vg)
        errors[f"iter_value_rel_rank{rank}"] = abs(float(vi) - float(vd)) / abs(float(vd))
        errors[f"iter_grad_rel_rank{rank}"] = _rel(gi, gd)
        errors[f"iter_value_rel_exact_rank{rank}"] = abs(float(vi) - float(v64)) / abs(float(v64))
    del K

    # BASELINE.json's fifth configuration: SMC over the hyperparameters on
    # the row-sharded covariance, cut in depth
    patch, calls = _count_lml_calls()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cb.reset_launch_counts()
    with patch:
        res, ms["smc_large_n"] = _timed(dev, lambda: large_n.run_smc_large_n(
            gp, x, y, torch.Generator(device=dev).manual_seed(0), mesh, block=PAR_BLOCK, **smc))
    launches["smc_large_n"] = dict(cb.LAUNCHES)
    smc_out = {"particles": res.particles.tolist(), "log_evidence": float(res.log_evidence),
               "accept_rate": float(res.accept_rate), "num_stages": res.num_stages,
               "betas_hit_one": res.betas_hit_one, "factorizations": calls[0],
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else None,
               "cuts": smc}
    emit({"phase": "parallel", "run": "world1", "n": n, "block": PAR_BLOCK, "ms": ms, "errors": errors,
          "launches": launches, "smc_large_n": smc_out})

    failures = []
    for name in ("chol_rel", "solve_rel", "value_rel", "grad_rel"):
        if PAR_BOUNDS[name] is not None and not errors[name] <= PAR_BOUNDS[name]:
            failures.append(f"{name} {errors[name]:.3e} > {PAR_BOUNDS[name]}")
    for rank in PAR_PRECOND_RANKS:
        for name in ("iter_value_rel", "iter_grad_rel"):
            if PAR_BOUNDS[name] is not None and not errors[f"{name}_rank{rank}"] <= PAR_BOUNDS[name]:
                failures.append(f"{name}_rank{rank} {errors[f'{name}_rank{rank}']:.3e} > {PAR_BOUNDS[name]}")
    k2 = "chol_inv_tile"
    if dev.type == "cuda":
        if launches["cholesky"][k2] != nb:
            failures.append(f"K2 launched {launches['cholesky'][k2]} times in one factorization (want {nb})")
        if launches["value_and_grad"][k2] != nb * PAR_VG_CALLS:
            failures.append(f"K2 launched {launches['value_and_grad'][k2]} times in {PAR_VG_CALLS} values and "
                            f"gradients (want {nb * PAR_VG_CALLS})")
        if launches["smc_large_n"][k2] != nb * calls[0] or calls[0] < 1:
            failures.append(f"K2 launched {launches['smc_large_n'][k2]} times in {calls[0]} factorizations of SMC")
    if not (torch.isfinite(res.particles).all() and math.isfinite(float(res.log_evidence))
            and 0.0 <= float(res.accept_rate) <= 1.0 and res.num_stages >= 1):
        failures.append("run_smc_large_n: non-finite particles or log evidence, or no stage")
    if failures:
        raise AssertionError(f"parallel (world 1): {failures}")
    return {"launches": {k2: launches["value_and_grad"][k2] + launches["smc_large_n"][k2]
                         + launches["cholesky"][k2]}, "ms": ms, "errors": errors}


def _rank_probe(dev) -> dict:
    """Asserts that gloo takes CUDA tensors for all_reduce, broadcast and
    all_gather, each tried once on a tiny tensor: the phase fails where it
    refuses one or gets it wrong (the mesh never stages through the host)."""
    import torch.distributed as dist

    world, rank = dist.get_world_size(), dist.get_rank()
    t = torch.full((2,), float(rank + 1), device=dev)
    want = {"all_reduce": torch.full((2,), world * (world + 1) / 2.0), "broadcast": torch.ones(2),
            "all_gather": torch.arange(1, world + 1, dtype=torch.float32).repeat_interleave(2)}

    def all_reduce():
        u = t.clone()
        dist.all_reduce(u)
        return u

    def broadcast():
        u = t.clone()
        dist.broadcast(u, src=0)
        return u

    def all_gather():
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t)
        return torch.cat(parts)

    ok = {}
    for name, fn in (("all_reduce", all_reduce), ("broadcast", broadcast), ("all_gather", all_gather)):
        try:
            got = fn()
        except RuntimeError as e:
            raise AssertionError(f"gloo refused a CUDA {name}: {e}") from e
        if not (got.is_cuda and torch.equal(got.cpu(), want[name])):
            raise AssertionError(f"gloo's CUDA {name} gave {got.tolist()}, want {want[name].tolist()}")
        ok[name] = True
    return ok


def _batch_witness(logp, logp64, V) -> dict:
    """The hyperpriors log-joint and its gradient at the chains' positions
    ``V`` evaluated in one batch and in the ranks' PAR_WORLD slabs: per
    chain, the largest difference of the value and of the gradient between
    the two, held at f32 rounding (twice the largest error of the one-batch
    f32 evaluation against f64 on the same positions), and on the card at
    least one chain not the same bit for bit (the cause that the one-rank
    reference's slabs stand for)."""

    def vg(fn, W):
        q = W.detach().requires_grad_(True)
        lp = fn(q)
        return lp.detach().double(), torch.autograd.grad(lp.sum(), q)[0].double()

    v1, g1 = vg(logp, V)
    slabs = [vg(logp, c) for c in V.chunk(PAR_WORLD)]
    v4, g4 = torch.cat([a for a, _ in slabs]), torch.cat([b for _, b in slabs])
    v64, g64 = vg(logp64, V.double())
    if not (torch.isfinite(v1).all() and torch.isfinite(g1).all() and torch.isfinite(v64).all()):
        raise AssertionError("the batch witness's log-joint or gradient is not finite")
    dv, dg = (v1 - v4).abs(), (g1 - g4).abs().amax(-1)
    ev, eg = (v1 - v64).abs(), (g1 - g64).abs().amax(-1)
    out = {"chains": V.shape[0], "slabs": PAR_WORLD, "value_abs_max": float(dv.max()),
           "grad_abs_max": float(dg.max()), "chains_differing": int(((dv > 0) | (dg > 0)).sum()),
           "value_f32_err_max": float(ev.max()), "grad_f32_err_max": float(eg.max()),
           "value_abs_per_chain": dv.tolist(), "grad_abs_per_chain": dg.tolist()}
    failures = []
    if not float(dv.max()) <= PAR_WITNESS_ROUNDING * float(ev.max()):
        failures.append(f"value differs by {float(dv.max()):.3e} between batchings, over "
                        f"{PAR_WITNESS_ROUNDING} x its f32 error {float(ev.max()):.3e}")
    if not float(dg.max()) <= PAR_WITNESS_ROUNDING * float(eg.max()):
        failures.append(f"gradient differs by {float(dg.max()):.3e} between batchings, over "
                        f"{PAR_WITNESS_ROUNDING} x its f32 error {float(eg.max()):.3e}")
    if V.is_cuda and out["chains_differing"] == 0:
        failures.append("the log-joint is batch-invariant here: the one-rank reference's slabs stand for nothing")
    if failures:
        raise AssertionError(f"batch witness: {failures}")
    return out


def parallel_rank(rank: int, world: int, port: int, queue, go, dev_type: str = "cuda",
                  cases: tuple = PAR_CASES) -> None:
    """(b), one spawned rank: once its group is up, waits for ``go``, then
    runs each of ``cases`` on the 4-rank mesh and, on rank 0, on a 1x1 mesh
    of the same world; puts its report on ``queue``."""
    try:
        queue.put(_parallel_rank(rank, world, port, go, dev_type, cases))
    except BaseException as e:  # the parent reports it and fails the phase
        import traceback

        queue.put({"rank": rank, "error": f"{type(e).__name__}: {e}\n{traceback.format_exc()}"})
        raise


def _parallel_rank(rank: int, world: int, port: int, go, dev_type: str, cases: tuple = PAR_CASES) -> dict:
    import torch.distributed as dist
    from gogp_torch.parallel import large_n, mesh as pmesh, sample, serving, smc_sharded

    dev = torch.device(dev_type, 0) if dev_type == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    pmesh.init_multihost(f"127.0.0.1:{port}", world, rank, backend="gloo")
    cuda_ok = _rank_probe(dev) if dev.type == "cuda" else {}
    data4 = pmesh.make_mesh(1, world)
    chain4 = pmesh.make_mesh(world, 1)
    one = pmesh.make_mesh(1, 1, ranks=[0])
    report = {"rank": rank, "backend": {**pmesh.describe(chain4), "cuda_collectives": cuda_ok}, "ms": {},
              "launches": {}, "diff": {}}
    if "graft" in cases:
        host_warmup()
    go.wait()
    f32 = torch.float32

    def run(label, fn):
        """``fn(mesh, slabs)`` on the four ranks, then on rank 0 alone with
        the log-density taking the whole population in the ranks' slabs;
        each run's launch counts set to 0 just before and read just after."""
        cb.reset_launch_counts()
        got4, report["ms"][label] = _timed(dev, lambda: fn(data4 if label == "lml" else chain4, 1))
        report["launches"][label] = dict(cb.LAUNCHES)
        dist.barrier()
        got1 = None
        if rank == 0:
            got1, report["ms"][label + "_one_rank"] = _timed(dev, lambda: fn(one, world))
        dist.barrier()
        return got4, got1

    if "samplers" in cases:
        # the LML's value and gradient at n = 4096
        gp, x, y, v0, _ = large_problem(PAR_N_RANKS, f32, dev)

        def lml(mesh, _):
            sh = pmesh.data_sharding(mesh)
            xs, ys = sh.slab(x), sh.slab(y)
            with mesh:
                lp = large_n.make_rowsharded_logp(gp, xs, pmesh.all_gather(xs, pmesh.DATA_AXIS), ys,
                                                  torch.ones_like(ys), pmesh.DATA_AXIS, PAR_BLOCK)
                return large_n.make_rowsharded_value_and_grad(lp)(v0)

        (val4, g4), got1 = run("lml", lml)
        if rank == 0:
            report["diff"]["ranks_lml_value_rel"] = abs(float(val4) - float(got1[0])) / abs(float(got1[0]))
            report["diff"]["ranks_lml_grad_rel"] = _rel(g4, got1[1])

        # ChEES and SMC on hyperpriors, chains and particles over the ranks.  On
        # the card a chain's K7-route log-joint is not bit for bit the same in a
        # batch of 16 as in one of 64, and 64 f32 transitions grow such a
        # difference to the posterior's scale; so the one-rank reference
        # evaluates its 64 chains in the ranks' four slabs of 16, and the batch
        # witness (after the samplers) measures that difference directly
        _, _, _, logp, _, hv0, free = bayes_problem(dev)
        calls = [0]

        def counted_in(slabs):
            def counted(V):
                calls[0] += 1
                return torch.cat([logp(c) for c in V.chunk(slabs)])

            return counted

        rng = np.random.default_rng(0)
        x0 = hv0 + 0.1 * torch.as_tensor(rng.normal(size=(PAR_CHEES["chains"], hv0.shape[0])), dtype=f32,
                                         device=dev) * free
        kw = {k: v for k, v in PAR_CHEES.items() if k != "chains"}

        def chees_run(mesh, slabs):
            calls[0] = 0
            res = sample.run_chees_sharded(counted_in(slabs), x0, torch.Generator(device=dev).manual_seed(0), mesh,
                                           free=free, **kw)
            return res.positions, calls[0]

        (pos4, calls4), got1 = run("chees", chees_run)
        report["chees_vg_calls"] = calls4
        if rank == 0:
            report["diff"]["ranks_chees_abs"] = float((pos4.double() - got1[0].double()).abs().max())
            report["chees_finite"] = bool(torch.isfinite(pos4).all())

        def smc_run(mesh, slabs):
            calls[0] = 0
            res = smc_sharded.run_smc_sharded(counted_in(slabs), hv0, torch.Generator(device=dev).manual_seed(1), mesh,
                                              free=free, **PAR_HP_SMC)
            return res, calls[0]

        (smc4, calls4), got1 = run("smc", smc_run)
        report["smc_vg_calls"] = calls4
        if rank == 0:
            report["diff"]["ranks_smc_abs"] = float((smc4.particles.double() - got1[0].particles.double()).abs().max())
            report["smc"] = {"stages": smc4.num_stages, "log_evidence": float(smc4.log_evidence),
                             "log_evidence_one_rank": float(got1[0].log_evidence)}
            # the batch dependence that the one-rank reference's slabs stand for,
            # at the ChEES chains' starting positions
            report["batch_witness"] = _batch_witness(logp, bayes_problem(dev, torch.float64)[3], x0)
        dist.barrier()

        # sharded serving at n = 4096: the mixture of S draws over the ranks,
        # each rank compiling its own; the request rows over the ranks
        sgp, sx, sy, _, sts, stn, sz = problem(f32, dev)
        vs = torch.as_tensor(0.1 * np.random.default_rng(1).normal(size=(PAR_SERVE_DRAWS, 3)), dtype=f32, device=dev)

        def serve_run(mesh, _):
            sm = serving.compile_mixture_sharded(sgp, vs, sx, sy, mesh)
            mix = serving.serve_predict_mixture_sharded(sgp, sm, sz, mesh)
            sp = serve.fit_serving(sgp, sts, stn, sx, sy)
            return mix, serving.serve_predict_sharded(sgp, sp, sz, mesh), sm.n_draws

        (mix4, req4, draws4), got1 = run("serve", serve_run)
        report["serve_local_draws"] = draws4
        if rank == 0:
            report["diff"]["ranks_serve_rel"] = max(_rel(a, b) for a, b in zip((*mix4, *req4), (*got1[0], *got1[1])))
    if "graft" in cases:
        # the graft entry's dry run on the four ranks, then on rank 0 alone
        report["graft"] = graft_rank(rank, world, dev, one)
    dist.destroy_process_group()
    return report


def start_parallel_ranks(dev, cases: tuple = PAR_CASES):
    """(b)'s PAR_WORLD ranks, spawned: each imports, joins its gloo group on
    one card and waits for the returned event."""
    ctx = multiprocessing.get_context("spawn")
    queue, go = ctx.Queue(), ctx.Event()
    port = _free_port()
    procs = [ctx.Process(target=parallel_rank, args=(r, PAR_WORLD, port, queue, go, dev.type, cases))
             for r in range(PAR_WORLD)]
    for p in procs:
        p.start()
    return procs, queue, go


def collect_ranks(started) -> list:
    """The spawned ranks' reports, in rank order, once ``go`` is set; the
    processes joined (killed where they hang)."""
    procs, queue, go = started
    go.set()
    reports = []
    try:
        for _ in procs:
            reports.append(queue.get(timeout=600))
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    errors = [r["error"] for r in reports if "error" in r]
    if errors:
        raise AssertionError("parallel ranks failed:\n" + "\n".join(errors))
    return sorted(reports, key=lambda r: r["rank"])


def parallel_ranks(dev, started) -> dict:
    """(b): the spawned ranks' cases, started now and beside nothing else on
    the card; each case against the same call on rank 0 alone."""
    reports = collect_ranks(started)
    r0 = reports[0]
    emit({"phase": "parallel", "run": "ranks", **{k: r0[k] for k in ("backend", "ms", "diff")},
          "launches": [r["launches"] for r in reports], "chees_vg_calls": [r["chees_vg_calls"] for r in reports],
          "smc_vg_calls": [r["smc_vg_calls"] for r in reports], "serve_local_draws": r0["serve_local_draws"],
          "smc": r0["smc"], "batch_witness": r0["batch_witness"]})
    failures = [f"{k} {v:.3e} > {PAR_BOUNDS[k]}" for k, v in r0["diff"].items()
                if PAR_BOUNDS[k] is not None and not v <= PAR_BOUNDS[k]]
    if not r0["chees_finite"]:
        failures.append("ChEES positions not finite")
    total = {}
    if dev.type == "cuda":
        nb = PAR_N_RANKS // PAR_BLOCK
        for r in reports:
            L = r["launches"]
            if L["lml"]["chol_inv_tile"] != nb:
                failures.append(f"rank {r['rank']}: K2 launched {L['lml']['chol_inv_tile']} times (want {nb})")
            for case in ("chees", "smc"):
                if L[case]["fused_gp_linv"] != r[f"{case}_vg_calls"]:
                    failures.append(f"rank {r['rank']}: K7 launched {L[case]['fused_gp_linv']} times in "
                                    f"{r[f'{case}_vg_calls']} log-joint calls of {case}")
            if L["serve"]["fused_cholesky_invs"] < 1 or L["serve"]["tril_inv_tile"] < 1:
                failures.append(f"rank {r['rank']}: serving launched no K1 or no K5")
        for key in PATH_KERNELS["parallel_ranks"]:
            total[key] = sum(r["launches"][case][key] for r in reports for case in ("lml", "chees", "smc", "serve"))
    if failures:
        raise AssertionError(f"parallel (ranks): {failures}")
    return {"launches": total, "reports": reports}


def phase_parallel(dev, cases: tuple = PAR_CASES) -> dict:
    """The multi-device layer: (a) in this process on an NCCL group of one
    rank, (b) on four spawned gloo ranks sharing the card (with the graft
    entry's 4-rank dry run, which the graft phase checks); then each kernel
    of these paths against its plain version at the paths' shapes."""
    # the ranks spawned first: each imports, joins its group, probes gloo's
    # CUDA collectives and warms up on the CPU while (a) runs here, then
    # waits; (b) starts once (a) is done, beside nothing else on the card
    started = start_parallel_ranks(dev, cases)
    try:
        world1 = parallel_world1(dev)
    except BaseException:
        for p in started[0]:
            p.kill()
        raise
    ranks = parallel_ranks(dev, started)
    # the kernels at the shapes these paths gave them: K2 on the first
    # diagonal tile of each path's covariance, K1 on the serving
    # covariance and K5 on its factor's tiles, K7 on a rank's 16 chains
    rows = {}
    for path, n in (("parallel", N_LARGE), ("parallel_ranks", PAR_N_RANKS)):
        kernel, plain, shape, reps, library = tile_cases(large_cov(n, dev)[:BLOCK, :BLOCK].contiguous())[
            "chol_inv_tile"]
        rows[path, "chol_inv_tile"] = check_kernel(path, "chol_inv_tile", kernel, plain, shape, reps, library)
    gp, x, _, _, ts, tn, _ = problem(torch.float32, dev)
    Ks = core.masked_cov(gp, ts, tn, x, None)
    tiles = cb._diag_tiles(cb.fused_cholesky_invs_plain(Ks)[0], BLOCK).contiguous()
    rows.update(kernel_rows("parallel_ranks", Ks, tiles))
    study, hx, _, _, _, _, _ = bayes_problem(dev)
    K7 = bayes_covs(study, hx, bayes_positions(PAR_CHEES["chains"] // PAR_WORLD, dev, seed=1))
    eye = torch.eye(K7.shape[-1], dtype=K7.dtype, device=dev)
    rows.update(check_k7({"parallel_ranks": (
        lambda: fused_gp.fused_gp_linv(K7), lambda: fused_gp.linv_plain(K7), K7.shape, 50,
        lambda: torch.linalg.solve_triangular(torch.linalg.cholesky(K7), eye, upper=False))}))
    return {"launches": {"parallel": world1["launches"], "parallel_ranks": ranks["launches"]}, "rows": rows,
            "reports": ranks["reports"]}


# --- graft: the twin of __graft_entry__.py (gogp_torch.graft_entry) ---------------
# entry's forward step (the hyperpriors log-joint and its gradient at n = 256)
# in f32 on the card against the same fn in f64 on the card;
# dryrun_multichip(1) in this process on an NCCL group of one;
# dryrun_multichip(4) on the parallel phase's four gloo ranks (graft_rank),
# its deterministic steps held against the same steps on rank 0 alone (a 1x1
# mesh, the 4-rank run's shapes).  Every step's outputs finite with the
# twin's shapes; every step that calls the batched log-joint (the K7 route)
# launches K7 once a call, and no other step launches it.  Bounds written
# before the first run on the card (PERF.md): entry's 10 times the CPU's f32
# against f64 of the same fn; the ranks' 10 times what each step gave in f32
# on four gloo ranks of the CPU against rank 0 alone (PERF.md), 10 f32
# roundoffs (6e-7) where that was 0.  Relative to each output's largest entry.
GRAFT_BOUNDS = {
    "entry_value_rel": 6.3e-5,  # CPU 6.32e-6
    "entry_grad_rel": 8.3e-4,  # CPU 8.31e-5
}
GRAFT_RANK_BOUNDS = {
    "data_lml": 3.6e-6,  # CPU 3.54e-7
    "sharded_lml": 6e-7,  # CPU 0
    "svgp": 1.3e-6,  # CPU 1.23e-7
    "serve": 6e-7,  # CPU 0
    "mixture": 6.1e-7,  # CPU 6.08e-8
    "laplace": 2.1e-6,  # CPU 2.04e-7
    "thompson": 6e-7,  # CPU 0 (pathwise scores and the appended factor, the same seeded draws)
    "ski": 3.4e-2,  # CPU 3.38e-3 (8 f32 CG iterations, the matvec's sums in another order)
}
# The steps that evaluate the batched log-joint (build_logjoint's K7 route).
GRAFT_LOGJOINT = ("chain_adam", "nuts", "chees", "chees_pops", "ghmc", "pt_chees", "pt_distributed",
                  "pt_chees_distributed", "advi")
GRAFT_ENTRY_REPS = 5


def graft_shapes(n_devices: int) -> list:
    """The twin's output shapes of dryrun_multichip(n_devices), from its
    statements (tests/test_torch_graft_entry.py holds them against the
    twin's own run at 4 and 3); GHMC's chains are at least 4 (the port's
    fix where the twin's n_devices = 1 step raises)."""
    from gogp_torch import graft_entry

    n_data = 2 if n_devices % 2 == 0 else 1
    n_chain, c, p, m = n_devices // n_data, 2 * n_devices, 6, 4 * n_data
    shapes = {
        "chain_adam": [(c, p), ()], "data_lml": [(), (p,)], "nuts": [(c, 2, p)], "chees": [(2, c, p)],
        "chees_pops": [(2, c, p)], "ghmc": [(4, max(c, 4), p)], "ess": [(c, 2, 16)], "sharded_lml": [()],
        "pt_chees": [(2, c, p)], "pt_distributed": [(2, p)], "pt_chees_distributed": [(2, 4, p)],
        "smc_large_n": [(4 * n_chain, p)], "chees_large_n": [(2, 2 * n_chain, p)],
        "chees_large_n_iterative": [(2, 2 * n_chain, p)], "svgp": [(p,), (m, 1), (m,), (m, m), ()],
        "serve": [(8 * n_devices,)], "mixture": [(8 * n_devices,)], "laplace": [(16,), ()],
        "thompson": [(c, 8 * n_devices), (16, 16)], "ski": [(), (5,)], "advi": [(c, p)],
    }
    return [s for name, _ in graft_entry.steps_for(n_devices) for s in shapes[name]]


def graft_run(n_devices: int, dev, mesh=None, only=None) -> tuple[list, list]:
    """dryrun_multichip(n_devices) (on ``mesh``, and only the steps named
    in ``only``, where given), with each step's wall ms, K7 launches and
    log-joint calls, the counts set to 0 just before each step and read
    just after: (outputs, steps)."""
    from gogp_torch import graft_entry

    calls = [0]
    real = bayes.build_logjoint

    def counting(*a, **k):
        logp, *rest = real(*a, **k)

        def counted(V):
            calls[0] += 1
            return logp(V)

        return (counted, *rest)

    steps, t0 = [], [0.0]

    def after(name, outs):
        _sync(dev)
        steps.append({"step": name, "ms": (time.perf_counter() - t0[0]) * 1e3,
                      "k7": cb.LAUNCHES["fused_gp_linv"], "logjoint_calls": calls[0],
                      "launches": {k: v for k, v in cb.LAUNCHES.items() if v},
                      "shapes": [list(o.shape) for o in outs],
                      "finite": all(bool(torch.isfinite(o).all()) for o in outs)})
        cb.reset_launch_counts()
        calls[0] = 0
        t0[0] = time.perf_counter()

    with unittest.mock.patch.object(bayes, "build_logjoint", counting):
        cb.reset_launch_counts()
        _sync(dev)
        t0[0] = time.perf_counter()
        out = graft_entry.dryrun_multichip(n_devices, dev, after_step=after, mesh=mesh, only=only)
    return out, steps


def graft_step_failures(steps: list, n_devices: int, dev, who: str) -> list:
    """The run's steps against the twin's order and shapes, finite, and
    K7 once per log-joint call where the log-joint runs and never elsewhere
    (on the card)."""
    from gogp_torch import graft_entry

    failures = []
    if [st["step"] for st in steps] != [name for name, _ in graft_entry.steps_for(n_devices)]:
        failures.append(f"{who}: steps {[st['step'] for st in steps]} out of the twin's order")
    if [s for st in steps for s in st["shapes"]] != [list(s) for s in graft_shapes(n_devices)]:
        failures.append(f"{who}: shapes {[st['shapes'] for st in steps]} are not the twin's")
    for st in steps:
        if not st["finite"]:
            failures.append(f"{who}: {st['step']} gave non-finite outputs")
        if dev.type != "cuda":
            continue
        if st["step"] in GRAFT_LOGJOINT:
            if not (st["logjoint_calls"] >= 1 and st["k7"] == st["logjoint_calls"]):
                failures.append(f"{who}: {st['step']} launched K7 {st['k7']} times in {st['logjoint_calls']} "
                                "log-joint calls")
        elif st["k7"] or st["logjoint_calls"]:
            failures.append(f"{who}: {st['step']} launched K7 {st['k7']} times ({st['logjoint_calls']} calls)")
    return failures


def graft_diff(out4: list, out1: list, n_devices: int) -> dict:
    """Per held step, the largest relative difference of its outputs (to
    each output's largest entry) between the whole run and the reference,
    which ran the held steps alone."""
    from gogp_torch import graft_entry

    diff, i, j = {}, 0, 0
    for name, outs in graft_entry.steps_for(n_devices):
        k = len(outs)
        if name in GRAFT_RANK_BOUNDS:
            diff[name] = max(_rel(a, b) for a, b in zip(out4[i:i + k], out1[j:j + k]))
            j += k
        i += k
    return diff


def graft_rank(rank: int, world: int, dev, one) -> dict:
    """One rank's graft case: dryrun_multichip(world) on the world, then on
    rank 0 its held steps on ``one`` (a 1x1 mesh of rank 0)."""
    import torch.distributed as dist

    out4, steps = graft_run(world, dev)
    dist.barrier()
    report = {"steps": steps}
    if rank == 0:
        out1, report["steps_one_rank"] = graft_run(world, dev, mesh=one, only=GRAFT_RANK_BOUNDS)
        report["diff"] = graft_diff(out4, out1, world)
    dist.barrier()
    return report


def graft_ranks_failures(reports: list, dev) -> tuple[list, int]:
    """The 4-rank reports' failures and their K7 launches in all."""
    failures = []
    for r in reports:
        failures += graft_step_failures(r["graft"]["steps"], PAR_WORLD, dev, f"rank {r['rank']}")
    diff = reports[0]["graft"]["diff"]
    failures += [f"4 ranks against 1: {k} {diff[k]:.3e} > {b}" for k, b in GRAFT_RANK_BOUNDS.items()
                 if not diff[k] <= b]
    return failures, sum(st["k7"] for r in reports for st in r["graft"]["steps"])


def graft_k7_case(dev):
    """K7 at the dry run's batch: the flagship's covariances at 2 chains'
    starts (a rank's chains at world 1), n = 16."""
    from gogp_torch import graft_entry

    study, _, _ = graft_entry._flagship()
    x, _ = graft_entry._series(16, 0, 0.1)
    K = bayes_covs(study, x, 0.1 * torch.randn((2, 6), generator=torch.Generator().manual_seed(0)).to(dev))
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=dev)
    return (lambda: fused_gp.fused_gp_linv(K), lambda: fused_gp.linv_plain(K), K.shape, 50,
            lambda: torch.linalg.solve_triangular(torch.linalg.cholesky(K), eye, upper=False))


def phase_graft(dev, reports: list | None = None) -> dict:
    """entry in f32 against f64 and its warm ms; dryrun_multichip(1) here
    on an NCCL group of one; the 4-rank dry run's reports (the parallel
    phase's ranks', or, run alone, ranks spawned for it); K7 at the path's
    batch against its plain version."""
    import torch.distributed as dist
    from gogp_torch import graft_entry
    from gogp_torch.parallel import mesh as pmesh

    fn, args = graft_entry.entry(dev)
    (v32, g32), first_ms = _timed(dev, lambda: fn(*args))
    warm_ms = [_timed(dev, lambda: fn(*args))[1] for _ in range(GRAFT_ENTRY_REPS)]
    v64, g64 = fn(*(a.double() for a in args))
    errors = {"entry_value_rel": abs(float(v32) - float(v64)) / abs(float(v64)), "entry_grad_rel": _rel(g32, g64)}
    failures = [f"{k} {errors[k]:.3e} > {b}" for k, b in GRAFT_BOUNDS.items() if not errors[k] <= b]
    if not (g32.shape == (6,) and math.isfinite(float(v32))):
        failures.append("entry: a non-finite value or a gradient of the wrong shape")

    pmesh.init_multihost(f"127.0.0.1:{_free_port()}", 1, 0, backend="nccl" if dev.type == "cuda" else "gloo")
    try:
        backend = dist.get_backend()
        _, steps = graft_run(1, dev)
    finally:
        dist.destroy_process_group()
    failures += graft_step_failures(steps, 1, dev, "world 1")
    if reports is None:
        reports = collect_ranks(start_parallel_ranks(dev, ("graft",)))
    rank_failures, rank_k7 = graft_ranks_failures(reports, dev)
    failures += rank_failures
    r0 = reports[0]["graft"]
    emit({"phase": "graft", "entry": {"value": float(v32), "first_ms": first_ms, "warm_ms": warm_ms,
                                      "errors": errors},
          "world1": {"backend": backend, "steps": steps},
          "ranks": {"steps": [r["graft"]["steps"] for r in reports], "steps_one_rank": r0["steps_one_rank"],
                    "diff": r0["diff"]}})
    if failures:
        raise AssertionError(f"graft: {failures}")
    rows = check_k7({"graft": graft_k7_case(dev)})
    return {"launches": {"graft": {"fused_gp_linv": sum(st["k7"] for st in steps) + rank_k7}}, "rows": rows}


# What ``--phases`` can name; "k7" is the bayes phase's kernel checks without
# its sampler runs, "slice" the serving slice with its launch counts, "gate"
# (in no whole run) K3 against K4 beyond the large path's size, "stamps" (in
# no whole run) the tile body's stage cycles and K4's chain step, "coldstart"
# (in no whole run) the first laplace_fit of a process taken apart.
PARTIAL_PHASES = {"kernels": phase_kernels, "k5": phase_k5, "k7": phase_k7, "gate": phase_gate,
                  "slice": _partial_slice, "serve": phase_serve_cache, "classify": phase_classify,
                  "sparse": phase_sparse, "surface": phase_surface, "pathwise": phase_pathwise, "bo": phase_bo,
                  "search": phase_search, "iterative": phase_iterative, "toeplitz": phase_toeplitz,
                  "ski": phase_ski, "large_n_bayes": phase_large_n_bayes,
                  "large_n_bayes_exact": _partial_large_n_bayes_exact, "utils": phase_utils,
                  "train": phase_train, "large": phase_large, "bayes": phase_bayes, "samplers": phase_samplers,
                  "evaluate": lambda dev: check_k7(phase_evaluate(dev)["k7_cases"]),
                  "parallel": lambda dev: phase_parallel(dev, ("samplers",)), "graft": phase_graft,
                  "stamps": phase_stamps, "coldstart": phase_coldstart}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true", help="also run the profile phase (torch.profiler)")
    parser.add_argument("--phases", type=lambda v: v.split(","), metavar="a,b,...",
                        help=f"run only these phases ({', '.join(PARTIAL_PHASES)}), for work on one kernel or "
                             "path; such a run ends with {\"ok\": false, \"partial\": [...]} and exit code 2")
    args = parser.parse_args()
    unknown = [name for name in args.phases or () if name not in PARTIAL_PHASES]
    if unknown:
        parser.error(f"unknown phases {unknown}: expected some of {list(PARTIAL_PHASES)}")
    info = phase_device()
    dev = torch.device("cuda", 0)
    warmup = threading.Thread(target=host_warmup)
    warmup.start()
    phase_build()
    warmup.join()
    if args.phases:
        for name in args.phases:
            t0 = time.perf_counter()
            PARTIAL_PHASES[name](dev)
            emit({"phase": name, "seconds": round(time.perf_counter() - t0, 3)})
        print(info["nvidia_smi"], flush=True)
        emit({"ok": False, "partial": args.phases})
        return 2
    peak_gib = {}

    seconds = {}

    def measured(name, fn, *a):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _CLEARED_PEAK_GIB[0] = 0.0
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        peak_gib[name] = max(torch.cuda.max_memory_allocated() / 2**30, _CLEARED_PEAK_GIB[0])
        return out

    cb.reset_launch_counts()
    kernels = measured("kernels", phase_kernels, dev)
    kernels_launches = dict(cb.LAUNCHES)
    measured("k5", phase_k5, dev)
    serve_launches, slice_args32 = measured("slice", phase_slice, dev)
    measured("launches", phase_launches, serve_launches, slice_args32)
    train = measured("train", phase_train, dev)
    large = measured("large", phase_large, dev)
    serve_cache = measured("serve", phase_serve_cache, dev)
    classify_out = measured("classify", phase_classify, dev)
    sparse_out = measured("sparse", phase_sparse, dev)
    surface_out = measured("surface", phase_surface, dev)
    pathwise_out = measured("pathwise", phase_pathwise, dev, sparse_out["svgp"])
    bo_out = measured("bo", phase_bo, dev)
    search_out = measured("search", phase_search, dev)
    # the large-n engines, GPU-bound: with workers beside them they and the
    # workers each took about twice as long (PERF.md), so they run alone
    for name, phase in (("iterative", phase_iterative), ("toeplitz", phase_toeplitz), ("ski", phase_ski),
                        ("large_n_bayes", phase_large_n_bayes)):
        measured(name, phase, dev)
    lnbx = measured("large_n_bayes_exact", phase_large_n_bayes_exact, dev)
    measured("utils", phase_utils, dev)
    for out in (serve_cache, classify_out, sparse_out, surface_out, pathwise_out, bo_out, search_out, lnbx):
        kernels.update(out["rows"])
    bayes_rows = measured("k7", phase_k7, dev)
    # Every sampler run (each host-bound) in worker processes from here on,
    # with the bayes phase's plain-route command line and the exact leg's
    # sampler, beside the bayes phase's K7 route and the evaluate phase in
    # this process; the phases that time kernels run with no worker beside
    # them
    pool, pending, others = start_sampler_workers(lnbx["x0"])
    with pool:
        bayes_out = measured("bayes", phase_bayes, dev, bayes_rows, others["bayes_plain"])
        here = measured("samplers", sampler_runs_here)
        evaluate_out = measured("evaluate", phase_evaluate, dev)
        lnbx_out = measured("large_n_bayes_exact_wait", others["lnbx"].get)
        print(lnbx_out["stdout"], end="", flush=True)
        samplers_out = measured("samplers_workers", finish_samplers, dev, here, pending)
    kernels.update(bayes_out["rows"])
    kernels.update(samplers_out["rows"])
    kernels.update(measured("evaluate_k7", check_k7, evaluate_out["k7_cases"]))
    # the multi-device layer, its four spawned ranks beside nothing else
    parallel_out = measured("parallel", phase_parallel, dev)
    kernels.update(parallel_out["rows"])
    # the graft entry: entry and the world-1 dry run here, the 4-rank dry
    # run's reports from the parallel phase's ranks
    graft_out = measured("graft", phase_graft, dev, parallel_out["reports"])
    kernels.update(graft_out["rows"])
    if args.profile:
        measured("profile", phase_profile, slice_args32, train["args32"], large["args32"], bayes_out["logps"],
                 evaluate_out["batch"])
    emit({"phase": "memory", "peak_gib": peak_gib, "seconds": seconds})
    # one entry per kernel and path that launches it: the path's launch
    # count beside the error and times at the shapes that path gives it
    launches = {"serve": serve_launches, "train": train["launches"], "large": large["launches"],
                "serve_cache": serve_cache["launches"], "classify": classify_out["launches"],
                "sparse": sparse_out["launches"], "surface": surface_out["launches"],
                "pathwise": pathwise_out["launches"], "bo": bo_out["launches"], "search": search_out["launches"],
                "bayes": bayes_out["launches"], "large_n_bayes_exact": lnbx_out["launches"],
                "evaluate": evaluate_out["launches"],
                "evaluate_hyperpriors": evaluate_out["hyperpriors_launches"], **samplers_out["launches"],
                **parallel_out["launches"], **graft_out["launches"], "kernels": kernels_launches}
    emit({"kernels": [
        {"name": f"{name} ({path}, {'x'.join(map(str, row['shape']))})", "route": "cuda",
         "source": source, "replaces": replaces, "launches": launches[path][key],
         "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
         "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": row["library_ms"]}
        for key, (name, source, replaces) in KERNELS.items()
        for path, keys in PATH_KERNELS.items() if key in keys
        for row in [kernels[path, key]]
    ]})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"], "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
