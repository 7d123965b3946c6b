#!/usr/bin/env python3
"""Drive the PyTorch port (``muse_tpu_torch``) once on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit. It builds the port's kernels from ``muse_tpu_torch/csrc/``, holds
each against its plain PyTorch version, and runs the port's main paths at
full width, each checked against an exact oracle. The paths:

  * slice 1, the field GRF: ``muse(grf_field_problem(n=1024,
    sigma_noise=0.01), 0.5, nsims=100, theta_rtol=1e-5,
    get_covariance=True)``;
  * slice 2, the north-star pipeline (examples/northstar_grf.py):
    ``grf_spectral_problem(n=1024, sigma_noise=0.01, solver="cg")``, a
    white-hoisted ``muse_fit`` of 512 sims in chunks of 128, ``get_J``
    reusing the fit's scores, and implicit-diff ``get_H`` of 51 sims;
  * slice 3, the generic L-BFGS MAP path:
    ``grf_spectral_problem(n=1024, sigma_noise=0.1, solver="lbfgs")``
    through ``muse_fit(0.5, nsims=100, max_batch=101, theta_rtol=1e-5)``,
    ``get_J`` and ``get_H(fd_order="adaptive")`` (the ``get_covariance``
    flow with adaptive FD), its solves cut at ``LBFGS_ITERS3`` iterations,
    and the user models (the funnel family and the PPL) through
    ``muse(..., get_covariance=True)``;
  * slice 4, the remaining field-model families: the lensing pipeline of
    examples/lensing_demo.py at n = 1024 (``lensing_problem(n=1024,
    theta_true=0.3)``, VarPro MAPs with the Newton-CG polish, a Broyden
    fit of 64 sims, reused J, implicit-diff H of 8 sims), the bandpower
    model with 12 bands and the pixel-space ``grf_problem``, both at
    1024² and σ_noise = 0.01;
  * slice 5, the mesh (``parallel.make_sims_mesh``, ``mesh=`` on every
    entry point): slice 2's pipeline and slice 4's bandpower model with
    ``mesh=``, on the one card — at world size 1 over NCCL, and as two
    ranks sharing the card over gloo (a sims axis of 2, then a field axis
    of 2) — and ``muse_fit(profile_dir=...)``;
  * slice 6, the field axis for every problem: slice 4's pixel
    ``grf_problem(n=1024, sigma_noise=0.01, mesh=)`` (its latent on 512 of
    the 1024 pixel rows a rank, gathered FFTs at each solve's entry and
    exit), slice 3's user models and slice 4's 256² lensing case on the
    gathered route, each on ``sims=1 × field=2`` (two ranks sharing the
    card over gloo), and ``grf_field_problem(use_pallas=False)``;
  * slice 7, θ̂ ± σ calibrated across data realizations: the funnel, the
    pixel GRF (amplitude, and amplitude with tilt), the 6-band bandpower
    model, lensing and the north star, each fitted with J and H on 10-20
    data realizations at full width, and the three demos of
    ``muse_tpu_torch/examples``;
  * slice 8, the measuring programs: ``python -m muse_tpu_torch.bench``
    (the port of bench.py) for its six models at 100 sims × 1024², with
    ``--no-hoist`` and ``--max-batch 32``, and the three scripts of
    ``muse_tpu_torch/scripts``, each run through its ``main`` in this
    process;
  * slice 9, kernel 1 with K weights: every GRF θ-score takes all its θ
    components from one ``spectrum_quadforms`` launch (one read of z),
    and the field GRF's θ-score is analytic (no backward): phases 3 and 5
    hold and time the kernel at K = 1 and 2, phase 5b compares the field
    GRF's batched θ-score routes, and every path's quadform count is the
    new wrapper's.

The noise level and θ_rtol are the repo's 1024² north-star settings. At
the default σ = 1 the field is so faint that the marginal MLE of a draw
may run to θ → −∞, and then there is nothing to check against. The θ_rtol
test measures |Δθ|·σ_F, so with σ_F ≈ 0.008 it needs 1e-5 to stop within
~0.2σ_F of the root. Phases:

  1. the card's name and power limit (``nvidia-smi``);
  2. the kernel build and its seconds;
  3. the autograd gradients of ``spectrum_quadform`` (the field GRF's
     log-likelihood) against the plain version's (rtol 1e-5, atol 1e-5
     relative to the largest entry); then spectrum_quadforms, the
     θ-scores' wrapper, at every lane count a main path gives it at
     n=1024 (``QUAD_LANES``: 1, 5, 17, 20, 32, 40, 64, 65, 101, 128) with
     K = 1 and K = 2 weights (the field GRF's score weights w·∂log C/C), and at
     (3, 100) with K = 3, (5, 33) with K = 4, (6, 33) with K = 2 (ragged
     tails, misaligned lanes): max relative error ≤ 1e-6 against its
     plain version in float64, a bitwise rerun, each column bitwise the
     K = 1 wrapper ``spectrum_quadform`` on its weight, and the first,
     middle and last lanes bitwise their launch at B = 1. The same checks
     on the slices' own θ-score inputs at their own lane counts (slice 2:
     x̃ drawn by the problem's sampler and the weight C/(C+σ²)² at the
     fit's first θ and at the MLE, chunks of 128 lanes and the one-lane
     remainder of 513, their halves under a sims axis of 2 (64), and a
     field axis of 2's row slices of 512 × 1026 at 128 and 1 lanes, both
     halves of the grid; slice 3: 101 and 40 lanes; slice 4's pixel GRF:
     packed maps and the weight w·C/((C+σ²)²n²), 101 and 20 lanes, and
     under a field axis of 2 both halves of its rows at 101 and 20
     lanes; slice 7's pixel GRF with the tilt, both weights, at 101);
  4. the slice 1 fit: |θ̂ − MLE| < 3σ_F/√100 + 0.02, 0.5 < σ/σ_F < 2, and
     every batched θ-score evaluation of the fit went through the kernel
     (spectrum_quadforms' launch count = evaluation count > 0, none of the
     log-likelihood's quadform);
  5. times: the quadforms kernel at B=101 × 1024² with K = 1 and K = 2, in
     turns, and their plain versions (CUDA events, median of 20 samples of
     20 launches each; K = 2 must take ≤ 1.2× K = 1), seconds per
     ``muse_step``, and the whole slice 1 fit + J + H. 5b: the field GRF's
     batched θ-score at 101 lanes × 1024² four ways
     (``scripts/theta_score_bench.py``): analytic through the kernel,
     analytic through the plain quadforms, ``vmap(grad(log_like))``
     through the kernel's forward and through the plain einsum: each
     one's CUDA-event ms (median of 20), its torch.profiler table, its
     kernel launches (1, 0, 1, 0), and its error against float64 and
     against ``vmap(grad)`` through the kernel, relative to the score's
     two cancelling terms (each ≤ 1e-5, the analytic kernel route's
     against float64 ≤ 1e-6); it fails unless analytic kernel < analytic
     plain < the faster ``vmap(grad)`` route;
  6. spectrum_quadform_and_grad vs plain at every lane count a main path
     gives it at n=1024 (``FUSED_LANES``: the fits' chunks of 128, 101 and
     1 lanes; the MAP solves of every get_H, 51, 40, 20, 10, 8 and 5
     lanes; under a sims axis of 2 the halves 64, 26 and 25; phase 17's
     chunks of 32 and 5 and its A/B's 17; phase 18c's 65) on the GRF
     operator A = 1 + C/σ², at 101 and 5 lanes also on the bandpower
     model's 12-band operator and at 49 and 6 on its 6-band one (phase
     16), on a field axis of 2's row slices of 512 × 1026 (both halves:
     128, 51 and 1 lanes on the GRF operator, 101 and 5 on the 12-band
     one, and for the field-axis pixel GRF 101, 10 and 20), and at
     (3, 100) and (5, 33): quad max relative error ≤ 1e-5 against the
     plain version in float64 (the float32 plain's own rounding reaches
     1.5e-5 at B=128), half_grad
     equal to the plain ``z*w`` (``torch.equal``), a bitwise-equal rerun;
  7. the slice 2 pipeline, run twice in one process (cold, then warm):
     |θ̂ − MLE| < max(1e-3, 2σ_F/√512) and 0.9 < σ/σ_F < 1.1
     (northstar_grf.py:116, 124-125); the fit went through
     ``muse_step_white`` and never ``muse_step``; quadform launches =
     batched θ-score evaluations = ``muse_step_white`` calls; fused-kernel
     launches = the CG steps that ``batched_cg`` counted, > 0;
  8. times beside the card's name and power limit: the fused kernel, its
     plain version and its bound at B=128 × 1024²; the quadform's one-call
     library route ``torch.einsum("bnm,bnm,nm->b", z, z, w)`` at B=101;
     the median warm ``muse_step_white`` at 128 lanes and a torch.profiler
     breakdown of it (device-busy share, top kernels); the cold and warm
     fit, J and H walls; the peak device memory;
  9. slice 3, run once in the process (cold), then with
     ``solver="cg"`` on the same data and seeds: per ``muse_step_white``
     the L-BFGS loop iterations (and ms each), the lanes' iterations
     (min, median, max), the line-search evaluations, the host syncs and
     the converged and failed lanes; the adaptive-FD rounds and steps; the
     walls; the peak memory; a profile of one warm L-BFGS step. It fails
     unless |θ̂ − MLE| < 3σ_F/√100 + 0.02, 0.5 < σ/σ_F < 2,
     |θ̂_lbfgs − θ̂_cg| < 0.25σ_F, no lane failed, the fit went through
     ``muse_step_white`` only, and quadform launches = batched θ-score
     evaluations = fit steps + FD rounds (one launch per batched score);
 10. the user models, each ``muse(..., nsims=200, grad_z_atol=1e-3,
     get_covariance=True)``: ``funnel_problem(512)`` (|θ̂ − exact MLE
     log(Σx²/D − 1)| < 0.05 and H within 5% of ``funnel_analytic_H``: the
     H of 20 sims has a Monte-Carlo spread of ~1.7%),
     ``vector_funnel_problem(256, 4)`` (each block within 3σ of its exact
     MLE), the PPL funnel as a model function with ``observed=`` (within
     0.05 of the exact MLE) and a PPL model with a LogNormal scale hyper
     (Blockwise θ with the volume factor; within 3σ/√nsims + 0.02 of the
     exact MLE √(Σx²/D − 1)).

 11. the lensing operators on the card at n = 1024, B ∈ {1, 5}, θ = 0.5:
     the adjoint identity |⟨Gz, w⟩ − ⟨z, Gᵀw⟩| ≤ 1e-5·‖Gz‖‖w‖ of the explicit
     pair (sums in float64); the explicit Gᵀ against the AD transpose
     (≤ 1e-4 of its largest entry); one Hessian-vector product (the vjp of
     the gradient, as batched_newton_cg takes it) against a central
     difference of the gradient in float64 at n = 64 (≤ 1e-6 relative),
     and the milliseconds of the three HVP routes (vjp of the gradient,
     jvp of the gradient, torch.func.linearize) at n = 1024, B = 5; one
     lane's ``zhat_varpro`` in a batch of 5 against the same lane alone at
     θ = −1 (objectives within 1e-5 relative, both converged): the
     stand-in for the JAX package's batch-width certifier;
 12. the lensing pipeline at full width with the settings of
     examples/lensing_demo.py's n ≥ 1024 branch: ``muse_fit(θ₀ = 0,
     nsims=64, z0=prob.suggested_z0, alpha=0.3, Hinv_update="broyden",
     regularize=`` the ±0.3 step clamp``, grad_z_atol=3e-3,
     theta_rtol=3e-4, maxsteps=30)``, ``get_J(nsims=64, skip_errors=True,
     warn_reuse=False)``, ``get_H(nsims=8, implicit_diff=True,
     implicit_diff_precond=prob.suggested_h_precond,
     implicit_fit_atol=1e-3)``. The demo's ``max_batch=3`` is a TPU width
     rule: here one warm ``muse_step_white`` is timed at chunk widths 3,
     9, 17, 33 and 65 (seconds per lane, peak memory), and the fit runs at
     the fastest. Per step: the lanes' VarPro outer iterations (min,
     median, max), inner CG iterations, line-search trials, polish
     entries with their Newton and Steihaug counts, host syncs, each lens
     pass's launches, seconds; then the fit, J and H walls, the peak memory and a profile of one
     warm step (busy share, top operators, the FFTs' share). It fails
     unless |θ̂ − 0.3| < 3σ (the demo's own assert), σ is finite and
     positive, the fit went through ``muse_step_white`` only and no lane
     is flagged ``failed`` (lanes frozen unconverged are the reference's
     designed behaviour: counted, not failed) and every fit step launched
     the lens passes' kernels. The pipeline runs again
     with the MAPs solved to 1e-3 and 1e-4 (θ̂, σ, counts and walls,
     reported and not gated). Newton-CG, which that fit never enters, runs
     on the fit's chunk at full width: ``solver="newton"`` cut at 3 outer
     iterations, and VarPro cut at one iteration with the MAPs asked to
     1e-4, which hands its lanes to the polish, its Steihaug budget cut
     to 10 (walls, Newton iterations, Steihaug steps, HVPs, peak memory;
     the MAPs must be finite and the polish must run). Then at n = 256 and
     nsims = 16, on one data set and one set of seeds, with the MAPs
     solved to 1e-3, ``solver="varpro"``, ``"newton"`` and ``"lbfgs"``:
     the three θ̂ within 0.5σ of each other, and their walls;
 13. ``bandpower_problem(n=1024, nbands=12, sigma_noise=0.01)``:
     ``muse_fit(nsims=100)``, ``get_J``, implicit ``get_H`` with
     ``suggested_h_precond`` in chunks of 5 sims, against
     ``bandpower_mle``: each θ̂_b within 3σ_b/√100 + 0.02 of its MLE, diag Σ
     within a factor 0.5-2 of the Fisher diagonal, |off-diagonal
     correlations| < 0.3, fused-kernel launches = CG steps > 0, the band
     reduction within 1e-5 of a float64 sum and bitwise equal on a rerun.
     Then
     ``grf_problem(n=1024, sigma_noise=0.01, solver="cg")`` on phase 4's
     field through ``muse(nsims=100, get_covariance=True)`` with phase 4's
     gates, quadform launches = batched score evaluations, fused launches
     = CG steps, and its θ̂ within 0.25σ_F of ``grf_field_problem``'s on the
     same field (the whitened and the non-whitened latent define the same
     marginal model).
 14. the mesh on the one card. 14a: in this process, a process group of
     world size 1 over NCCL and ``make_sims_mesh()``: phase 7's pipeline
     with ``mesh=`` gives θ̂, σ, J and H bitwise equal to phase 7's warm
     run. Then two ranks spawned with ``torch.multiprocessing`` (start
     method ``spawn``, the kernels already built, a hard limit of
     ``MESH_SPAWN_TIMEOUT_S`` after which they are killed and the run
     fails) share the card over gloo (NCCL refuses two ranks on one
     device). 14b: ``sims=2``, phase 7's pipeline, cold then warm: θ̂ and σ
     within rtol 1e-6 of phase 7 (bitwise equality printed). 14c:
     ``sims=1 × field=2``: θ̂ within 1e-4 + 1e-4·|θ̂| of phase 7, the
     north-star gates, and on each rank quadform launches = θ-score
     evaluations = ``muse_step_white`` calls, fused launches = CG steps.
     14d: phase 13's bandpower pipeline on the field axis: each θ̂_b within
     rtol 1e-4 of phase 13's, the band reduction over the field axis within
     1e-5 of a float64 sum and bitwise equal on a rerun. Every shape a rank
     launched at must have been held in phases 3 and 6. Printed, not gated:
     each rank's walls, peak memory, collectives and bytes beside the
     one-process walls of phases 7 and 13, and the median ms of one
     collective. 14e: the warm north-star fit with ``profile_dir``: one
     trace file holding the step's kernels. Last, two ranks over NCCL on
     the one card, and what NCCL answers (printed).

 15. the field axis for every problem on the one card. 15a (the
     batch-width determinism of ROADMAP's fused PCG-step item): phase 7's
     implicit H of 51 sims with its CG's per-lane sums (rz, pᵀAp, ‖r‖²,
     through the ``reduce`` hook) recorded at 51
     lanes and at 26 (the first chunk of ``max_batch=26``): the first
     step at which they differ bit for bit, the largest difference
     relative to the lane's first value of each sum (<= 1e-6, the stated
     tolerance), and which of the CG's inputs — the right-hand sides, one
     operator and one preconditioner application, ``torch.sum`` and
     ``vector_norm`` of the same rows — differ between the two widths
     (the named cause). 15b: ``grf_field_problem(use_pallas=True|False)``
     on phase 4's field, 101 lanes drawn at θ = 0.5: the batched
     log-likelihood and θ-score within 1e-5 of float64 (relative to their
     terms), one kernel launch per batched evaluation with True and none
     with False. Then the kernels at (101, 512, 1026) (CUDA events, plain
     versions, the library einsum, the bounds), and two ranks spawned as
     in phase 14 (a hard limit of ``FIELD15_SPAWN_TIMEOUT_S``) on ``sims=1
     × field=2``: the median ms of one gather of 15c's fit chunk (101
     lanes, 512 of 1024 rows), then 15c: phase 13's pixel GRF pipeline
     (fit, reused J, FD H) with ``grf_problem(mesh=)``, θ̂ within 1e-4 +
     1e-4·|θ̂| of phase 13's, J and H within rtol 1e-3, grf_problem's
     accuracy gates, quadform launches = θ-score evaluations, fused
     launches = CG steps, gathers and no field maxima (the sharded-sum
     route); 15d: phase 10's four user models with ``mesh=`` (the gathered
     route: gathers and field maxima), θ̂ within 1e-4 + 1e-4·|θ̂| and σ
     within rtol 1e-3 of phase 10's, no failed MAP; 15e: phase 12's 256²
     VarPro fit with ``mesh=``, every MAP of its last step converged, none
     failed, |θ̂ − θ̂ phase 12| < 0.1 (JAX's gate for a sharded lensing
     run). Printed per rank: walls, peak memory, collectives and bytes with
     the gathers and field maxima apart, the kernels' launches and shapes
     (each held in phases 3 and 6).

 16. calibration across data realizations (tests/test_calibration.py's
     configurations at full width, and the north star): realization i of a
     study draws its data from ``data_seed`` base + i and its sims from
     ``seed`` base + i (``DATA16``, ``SIMS16``), with the port's
     generators, so these are other realizations of the JAX file's
     configurations. 16a ``funnel_problem(512)``, R = 20, ``muse(θ₀ 0.3,
     nsims=100, theta_rtol=3e-2, get_covariance=True)``; 16b
     ``grf_problem(n=1024)`` (σ_noise 1), R = 14, fit θ₀ 0.3 with 100 sims,
     J reused, implicit H of 8 sims; 16c ``grf_problem(n=1024,
     sigma_noise=0.3, infer_tilt=True)``, R = 10, fit θ₀ (0.3, 0.1)
     (``Hinv_update="sims"``), J and H as 16b; 16d
     ``bandpower_problem(n=1024, nbands=6, sigma_noise=0.05)``, R = 10, fit
     θ₀ 0.2 with 48 sims, theta_rtol 1e-2, J reused, implicit H of 6 sims;
     16e ``lensing_problem(1024)``, R = 10, VarPro, fit θ₀ 0.3 with 16 sims,
     Broyden, every MAP to 1e-3, implicit H of 8 sims; 16f phase 7's
     pipeline, R = 20. The gates are tests/test_calibration.py's with its
     numbers: for 16a, 16b, 16e and 16f at most 4, 3, 3 and 4 z-scores
     outside ±1.96, √R·|mean z| < 3 and 0.45 < std(z) < 1.75; 16c at most 3
     of the Mahalanobis m² above 5.99, 0.4 < mean m² < 5 and the component
     z-scores' √(2R)·|mean| < 3.5; 16d at most 3 m² above 15.6 (a Hotelling
     bound for 6 bands and 48 sims), 3 < mean m² < 10.5 and each band
     within 0.8 Fisher σ of ``bandpower_mle``; 16e no failed MAP; 16f each
     |θ̂ − MLE| < max(1e-3, 2σ_F/√512) (phase 7's gate). Printed per
     study: every realization's θ̂ − θ_true, σ, steps and seconds; the z or
     m², misses, mean and std; the study's seconds, peak device memory and
     kernel launches (quadform = θ-score evaluations, fused = CG steps;
     both in 16b, 16c and 16f, the fused kernel alone in 16d, neither in
     16a and 16e). 16g runs the ``main`` of each of the port's demos on
     the card: ``northstar_grf`` at its defaults (1024², 512 sims),
     ``lensing_demo --n 1024 --nsims 64`` and ``muse_vs_hmc --dim 512
     --nsims 100 --hmc-samples 500`` (its HMC contender cut from 2000
     samples for time), each with its own asserts and its accuracy line,
     and their walls. Every study runs before a failed gate fails the run.
 17. the measuring programs (``RUNS17``), each through its ``main`` with
     its earlier lines (the card, the timed step's peak memory, the check's
     gaps) in order with its result, and the kernel counters set to 0 just
     before it and read just after. 17a: ``muse_tpu_torch.bench --grid 1024
     --nsims 100 --model`` each of grf, grf-pixel, lensing, funnel, ppl
     and bandpower (the funnel and the PPL at 1024 dims), printing
     bench.py's JSON line: ``certified`` true (in the first chunk, and in
     the last where it is narrower, the first sim lane and the last lane
     against keyed B = 1 re-solves: objective and ‖ẑ‖ within certify.py's
     tolerances, θ-score within 1e-3 of the largest entry, the same
     convergence flag), no ``floor_violation``, ``value`` and ``vs_baseline``
     finite and positive. 17b: grf with ``--no-hoist`` and with
     ``--max-batch 32`` (chunks of 32, 32, 32 and 5 lanes), the same
     gates. 17c: ``scripts.kernel_ab_bench`` (the field GRF's keyed
     ``muse_step``, 16 sims × 1024², with the CUDA quadform and with its
     plain version; one launch per batched θ-score with the kernel, none
     with the plain). 17d: ``scripts.bench_noise_modes`` (100 sims ×
     1024², noise "direct" against "fft"). 17e:
     ``scripts.lensing_calibration_study --n 256 --nsims 16 --reps 8``: no
     realization diverges (|θ̂ − 0.3| < 1) and every σ is finite. In every
     run quadform launches = θ-score evaluations, > 0 exactly where the
     run's model scores through the kernel, and fused launches = the CG
     steps of the runs whose PCG runs through it (none elsewhere); at
     bench.py's σ_noise = 1 those PCGs take no step.
 18. the batched hermitian white sampler (``ops/herm_white.py``,
     ``csrc/herm_white.cu``). 18a: ``CompiledProblem.sample_whites``
     through the kernel against the per-lane generator loop it replaces
     (the same problem with its ``sample_whites_batched`` hook taken
     away), bit for bit (``torch.equal``): the spectral GRF at n = 64,
     256, 1024 and 257 with B = 1, 128 and 513 lanes, n = 2048 (two
     grid-stride steps of torch's ``randn``) with B = 3, ``x_only`` on and
     off; the bandpower
     model and the spectral GRF's ``direct`` noise at n = 1024; the kernel
     against the loop on field-axis slices of the packed grid (a field axis
     of 2's second rank, and an uneven cut). A case that differs prints its
     count of differing floats and the first of them, and fails the run;
     every call, at B = 1, 128 and 513 alike, launches the kernel once.
     18b: the kernel's CUDA-event time at (128, L) for one part and for
     both, beside its bound (the floats written over 3.35 TB/s) and the
     loop's synchronised wall for the same lanes. 18c: the benchmark's
     ``sims512`` and ``sims64`` pipelines at 1024² (512 sims in chunks of
     128 and H over 51 sims; 64 sims in one chunk of 65 lanes and H over 8
     sims), the counters read around each: every lane batched (564 and
     73), none looped, one kernel launch a ``sample_whites`` call (6 and
     2).
 19. the lens operator's four passes (``ops/lens_planes.py``,
     ``csrc/lens_planes.cu``) at the lensing cell's 65 lanes × 1024², on
     the model's own spectral scale, deflections and draws: expand,
     combine, its residual form without r (the reduced gradient's) and
     with r (the certificate's), spread and contract, each against its
     plain version evaluated in float64 (≤ 1e-6 of the largest entry;
     the residual form's Σr² a lane ≤ 1e-5 relative), a rerun bitwise
     equal, lane 0 bitwise its launch alone, and each kernel's CUDA-event
     time beside its bound and the plain version's float32 time. Phase 11
     holds the adjoint identity and the lane-in-a-batch MAP on the same
     passes, since ``lin_ops`` and ``zhat_varpro`` run through them.

A recorder in place of each kernel wrapper keeps every input shape
launched (``record_kernel_shapes``); after phase 18 the run fails if a
kernel ran at a shape that phases 3 and 6 did not hold against the plain
version, and phase 15 checks its ranks' shapes alike.
Every path's quadform count is kernel 1's launches through
``spectrum_quadforms_cuda`` against ``SpectrumQuadforms``' evaluations,
and no path launches the K = 1 wrapper of the log-likelihood.
No phase's failure is caught: any failure exits non-zero. The line before
last is ``{"kernels": [...]}``: ``launches_by_path`` holds each kernel's
count on every slice's paths (the counters set to 0 just before each path
and read just after), kernel 1's row adds its K = 2 times (``ms_k2``,
``plain_ms_k2``, ``bound_ms_k2``), and ``launches`` is their sum: slice 8's own
paths, phase 17's bench runs at bench.py's σ_noise = 1, run the fused
kernel no time, since their PCGs meet the MAP tolerance at Z₀ = 0. The
last line is ``{"ok": true, "device": …}``. Without a card, or without
the package beside it, it exits non-zero and prints no result.
"""

import json
import os
import statistics
import subprocess
import sys
import time


def phase(msg):
    print(msg, flush=True)


def cuda_ms(fn, samples=20, per_sample=20):
    """Median device milliseconds of one call of ``fn`` (CUDA events around
    ``per_sample`` back-to-back calls, so host overhead stays hidden)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_sample):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / per_sample)
    return statistics.median(times)


# the slice 2 pipeline's settings (examples/northstar_grf.py:72-108)
NSIMS2, MAX_BATCH2, H_NSIMS2 = 512, 128, 51
# the benchmark's sims64 cell (phase 18c): the same pipeline with 64 sims,
# its fit one chunk of 65 lanes, its H over max(8, 64/10) sims
NSIMS18, H_NSIMS18 = 64, 8
# the lane counts of its fit's chunks: nsims + 1 lanes (the data lane) in
# chunks of MAX_BATCH2, the last one smaller
FIT_CHUNKS2 = sorted({min(MAX_BATCH2, NSIMS2 + 1 - s0)
                      for s0 in range(0, NSIMS2 + 1, MAX_BATCH2)})

# slice 3 (examples of the generic L-BFGS path): the spectral GRF with
# solver="lbfgs" at σ_noise = 0.1, where float32 L-BFGS converges (at 0.01
# A = 1 + C/σ² is too ill-conditioned for it); 100 sims in one chunk of 101
# lanes, adaptive-FD H of 10 sims × 4 stencil offsets
SIGMA3, DATA_SEED3, NSIMS3, H_NSIMS3 = 0.1, 42, 100, 10
H_LANES3 = H_NSIMS3 * 4
# the depth cut of slice 3: L-BFGS iterations per solve (the solver's
# default is 500). A fifth to a quarter of the 1024² lanes stop short of
# g_atol = 1e-2 at the float32 resolution of their objective (JAX's own
# batched_lbfgs leaves 2 of 8 such lanes at max_iters) and would run out
# all 500, at ~0.2 s an iteration (~20 line-search trials each), in every
# fit step; the lanes that converge need 9-60
LBFGS_ITERS3 = 60

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA's data sheet
F32_OPS_PER_S = 67e12          # float32 outside the tensor cores


def least_ms(nbytes, nops):
    """(least ms for the work on an H100 at its published peaks, what bounds
    it): bytes over the memory rate vs float32 operations over the peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def quad_counts():
    """Kernel 1's counters since the last ``reset_counts``: the launches of
    the θ-scores' wrapper ``spectrum_quadforms_cuda`` and the forward
    evaluations of its Function ``SpectrumQuadforms`` (equal on a card,
    one per batched θ-score), and the launches of its K = 1 wrapper
    ``spectrum_quadform_cuda`` (the field GRF's log-likelihood, which no
    main path evaluates: 0 on every path, and gated so)."""
    from muse_tpu_torch.ops import grf_spectrum as gs
    return {"quad_launches": gs.spectrum_quadforms_cuda.launches,
            "quad_evaluations": gs.SpectrumQuadforms.evaluations,
            "quad1_launches": gs.spectrum_quadform_cuda.launches}


#: every input shape each kernel wrapper launched at in this process, by
#: kernel, once ``record_kernel_shapes`` has run
_SHAPES = {}


def record_kernel_shapes():
    """Put a recorder in place of each kernel wrapper of
    ``ops/grf_spectrum.py`` (once a process), so that ``kernel_shapes``
    holds every input shape launched: (B, n, 2m), and (B, K, n, 2m) for
    the K-weight quadforms. The module's own calls go through its globals,
    so every launch passes the recorder; the recorder carries the
    wrapper's ``launches``, which the wrapper counts through the same
    global."""
    if _SHAPES:
        return
    import functools

    from muse_tpu_torch.ops import grf_spectrum as gs

    def plain(z, w):
        return tuple(z.shape)

    def stacked(z, W):
        return (z.shape[0], W.shape[0]) + tuple(z.shape[1:])

    for name, key in (("spectrum_quadform", plain),
                      ("spectrum_quadforms", stacked),
                      ("spectrum_quadform_and_grad", plain)):
        fn = getattr(gs, name + "_cuda")
        seen = _SHAPES[name] = set()

        @functools.wraps(fn)
        def recorder(z_ri, w, _fn=fn, _key=key, _seen=seen):
            out = _fn(z_ri, w)
            _seen.add(_key(z_ri, w))
            return out
        setattr(gs, name + "_cuda", recorder)


def kernel_shapes():
    """Every input shape each kernel wrapper launched at in this process
    (``record_kernel_shapes``)."""
    return _SHAPES


def profile_steps(step, card, label, nsteps=3, top=10, fft_share=False):
    """Where the time of a warm step goes: torch.profiler over ``nsteps``
    synchronised steps; prints the device-busy share of the host span and
    the kernels that take the most device time, and with ``fft_share`` the
    share of the FFT operators (cuFFT). Prints "not measured" when the
    profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(nsteps):
            step()
        torch.cuda.synchronize()
        span_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        phase(f"{label} [{card}] profile: no device time recorded (not "
              "measured)")
        return
    phase(f"{label} [{card}] profile of {nsteps} warm steps: device busy "
          f"{busy_ms:.2f} ms of a {span_ms:.2f} ms host span "
          f"({busy_ms / span_ms:.1%}); top kernels by device time:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        phase(f"  {e.self_device_time_total / 1e3 / nsteps:8.3f} ms/step "
              f"{e.count / nsteps:5.1f} launches/step  {e.key[:110]}")
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.self_device_time_total > 0]
    phase(f"{label} [{card}] the same by the operator that launched it:")
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:top]:
        phase(f"  {e.self_device_time_total / 1e3 / nsteps:8.3f} ms/step "
              f"{e.count / nsteps:5.1f} calls/step  {e.key[:60]}")
    if fft_share:
        fft = [e for e in ops if e.key.startswith("aten::_fft_")]
        fft_ms = sum(e.self_device_time_total for e in fft) / 1e3
        phase(f"{label} [{card}] FFT operators (cuFFT): {fft_ms / nsteps:.2f} "
              f"ms/step in {sum(e.count for e in fft) / nsteps:.0f} "
              f"calls/step, {fft_ms / busy_ms:.1%} of the device time")


def phase9(card, prob3, mle3, sig_F3):
    """Slice 3 at full width: the spectral GRF with solver="lbfgs", the
    get_covariance flow with adaptive FD (muse_fit, get_J, get_H), cold,
    then the same fit with solver="cg" on the same data and seeds.
    Returns (the quadform's launches in the cold L-BFGS run, the fused
    kernel's in the CG run)."""
    import numpy as np
    import torch

    import muse_tpu_torch
    from muse_tpu_torch.models import grf_spectral_problem
    from muse_tpu_torch.ops import grf_spectrum as gs
    from muse_tpu_torch.ops.cg import batched_cg
    from muse_tpu_torch.ops.lbfgs import batched_lbfgs
    from muse_tpu_torch.solver import CompiledProblem
    from muse_tpu_torch.theta import ThetaSpec

    B = NSIMS3 + 1
    comp3 = CompiledProblem(prob3, ThetaSpec.from_example(0.5),
                            np.array([0.5]), lbfgs_max_iters=LBFGS_ITERS3)
    step3 = comp3.muse_step_white
    per_step = []

    def counts():
        return (batched_lbfgs.iterations, batched_lbfgs.ls_evaluations,
                batched_lbfgs.host_syncs)

    def counted_step(*args, **kwargs):
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step3(*args, **kwargs)
        torch.cuda.synchronize()
        after = counts()
        it = out["iterations"].cpu().numpy()
        open_lanes = ~out["converged"]
        per_step.append({
            "g_norm_open": [round(float(v), 4) for v in torch.quantile(
                out["g_norm"][open_lanes].double(),
                torch.tensor([0.0, 0.5, 1.0], dtype=torch.float64,
                             device=open_lanes.device))]
            if bool(open_lanes.any()) else [],
            "s": time.perf_counter() - t0,
            "loop_iterations": after[0] - before[0],
            "ls_evaluations": after[1] - before[1],
            "host_syncs": after[2] - before[2],
            "lane_iterations": (int(it.min()), float(np.median(it)),
                                int(it.max())),
            "converged": int(out["converged"].sum()),
            "failed": int(out["failed"].sum())})
        return out

    def keyed_step(*args, **kwargs):
        raise AssertionError("the slice 3 fit called muse_step, not "
                             "muse_step_white")

    comp3.muse_step_white = counted_step
    comp3.muse_step = keyed_step
    runs = []
    torch.cuda.reset_peak_memory_stats()
    # one cold run and no warm rerun: the run's time limit leaves room for
    # the calibration studies of phase 16
    run = "cold"
    torch.cuda.synchronize()
    gs.reset_counts()
    batched_lbfgs.iterations = batched_lbfgs.ls_evaluations = 0
    batched_lbfgs.host_syncs = 0
    per_step.clear()
    t0 = time.perf_counter()
    res3 = muse_tpu_torch.MuseResult()
    muse_tpu_torch.muse_fit(res3, prob3, 0.5, nsims=NSIMS3, max_batch=B,
                            theta_rtol=1e-5, compiled=comp3, seed=1)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    muse_tpu_torch.get_J(res3, prob3, nsims=NSIMS3, max_batch=B,
                         compiled=comp3, warn_reuse=False)
    torch.cuda.synchronize()
    t_j = time.perf_counter() - t0 - t_fit
    fit_steps = len(per_step)
    muse_tpu_torch.get_H(res3, prob3, nsims=H_NSIMS3, fd_order="adaptive",
                         max_batch=B, compiled=comp3)
    torch.cuda.synchronize()
    t_h = time.perf_counter() - t0 - t_fit - t_j
    rounds = res3.metadata["fd_adaptive"]
    c = {**quad_counts(),
         "muse_step_white_calls": fit_steps,
         "fd_rounds": len(rounds),
         "lbfgs_iterations": batched_lbfgs.iterations,
         "lbfgs_ls_evaluations": batched_lbfgs.ls_evaluations,
         "lbfgs_host_syncs": batched_lbfgs.host_syncs}
    th, sig = float(res3.theta[0]), float(res3.sigma[0])
    runs.append({"run": run, "fit_s": t_fit, "J_s": t_j, "H_s": t_h,
                 "theta": th, "sigma": sig, **c})
    bound = 3 * sig_F3 / np.sqrt(NSIMS3) + 0.02
    phase(f"phase 9 {run} [{card}] fit: {res3}  steps {fit_steps}; MLE "
          f"{mle3:.6f} σ_F {sig_F3:.6f}; |θ̂−MLE| {abs(th - mle3):.6f} "
          f"(< {bound:.6f}); σ/σ_F {sig / sig_F3:.4f}; J "
          f"{float(res3.J[0, 0]):.1f} H {float(res3.H[0, 0]):.1f}")
    for i, st in enumerate(per_step):
        phase(f"phase 9 {run} muse_step_white {i + 1}: {st['s']:.3f} s, "
              f"{st['loop_iterations']} L-BFGS iterations "
              f"({1e3 * st['s'] / max(st['loop_iterations'], 1):.2f} "
              f"ms each), lanes min/median/max "
              f"{st['lane_iterations']}, {st['ls_evaluations']} "
              f"line-search evaluations, {st['host_syncs']} host syncs, "
              f"{st['converged']}/{B} converged (the others' g_norm "
              f"min/median/max {st['g_norm_open']}), {st['failed']} "
              f"failed")
    phase(f"phase 9 {run} adaptive FD: {len(rounds)} rounds, steps "
          f"{[float(r['step'][0]) for r in rounds]}, trunc "
          f"{[float(r['trunc'][0]) for r in rounds]}, roundoff "
          f"{[float(r['roundoff'][0]) for r in rounds]}")
    phase(f"phase 9 {run} counts: {c}; walls fit {t_fit:.3f} s, J "
          f"{t_j:.4f} s, H {t_h:.3f} s")
    if not (np.isfinite(th) and np.isfinite(sig)):
        raise AssertionError("non-finite θ̂ or σ")
    if not abs(th - mle3) < bound:
        raise AssertionError(f"θ̂ {th} vs MLE {mle3}: off by more than "
                             f"{bound}")
    if not 0.5 < sig / sig_F3 < 2:
        raise AssertionError(f"σ {sig} vs σ_F {sig_F3}")
    if any(h["map_failed"].any() for h in res3.history):
        raise AssertionError("an L-BFGS lane of the fit failed")
    # one launch per batched θ-score: each fit step, no new J sims
    # (the fit's scores are reused), one FD stencil batch per round
    if not (c["quad_launches"] > 0 and c["quad_launches"]
            == c["quad_evaluations"] == fit_steps + len(rounds)
            and c["quad1_launches"] == 0):
        raise AssertionError(f"quadform launches do not match the "
                             f"θ-score evaluations: {c}")
    peak3 = torch.cuda.max_memory_allocated() / 2 ** 30

    # the same pipeline with the PCG MAPs, on the same data and seeds
    prob3cg = grf_spectral_problem(n=prob3.grf_config.n, sigma_noise=SIGMA3,
                                   solver="cg",
                                   data_seed=DATA_SEED3, device=prob3.device)
    if not torch.equal(prob3cg.x, prob3.x):
        raise AssertionError("data_seed gave other data for solver='cg'")
    gs.reset_counts()
    batched_cg.curvature_steps = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rescg = muse_tpu_torch.MuseResult()
    muse_tpu_torch.muse_fit(rescg, prob3cg, 0.5, nsims=NSIMS3, max_batch=B,
                            theta_rtol=1e-5, seed=1)
    muse_tpu_torch.get_J(rescg, prob3cg, nsims=NSIMS3, max_batch=B,
                         warn_reuse=False)
    muse_tpu_torch.get_H(rescg, prob3cg, nsims=H_NSIMS3, fd_order="adaptive",
                         max_batch=B)
    torch.cuda.synchronize()
    t_cg = time.perf_counter() - t0
    fused_cg = gs.spectrum_quadform_and_grad_cuda.launches
    th_l, th_c = runs[0]["theta"], float(rescg.theta[0])
    phase(f"phase 9 [{card}] solver='cg' on the same data: {rescg}  steps "
          f"{len(rescg.history)}, fit + J + H {t_cg:.3f} s; fused launches "
          f"{fused_cg} = CG steps {batched_cg.curvature_steps}; "
          f"|θ̂_lbfgs − θ̂_cg| {abs(th_l - th_c):.3e} (< 0.25σ_F = "
          f"{0.25 * sig_F3:.6f})")
    if not abs(th_l - th_c) < 0.25 * sig_F3:
        raise AssertionError(f"θ̂ L-BFGS {th_l} vs CG {th_c}")
    if not fused_cg == batched_cg.curvature_steps > 0:
        raise AssertionError("fused launches do not match the CG steps")

    # where the time of one warm L-BFGS step goes: from the MAPs at the
    # fit's second θ to its third
    seeds = list(range(B))
    W = comp3.sample_whites(seeds, x_only=True)
    lanes = torch.arange(B, device=W[0].device)
    th_a, th_b = (comp3.theta(res3.history[i]["theta"]) for i in (1, 2))
    Z_a = step3(th_a, th_a, W, torch.zeros((B, comp3.nz),
                                           device=W[0].device),
                lanes, 1e-2)["Z"]
    before = counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = step3(th_b, th_b, W, Z_a, lanes, 1e-2)
    torch.cuda.synchronize()
    t_step = time.perf_counter() - t0
    n_it = batched_lbfgs.iterations - before[0]
    phase(f"phase 9 [{card}] warm muse_step_white ({B} lanes × 1024²): "
          f"{t_step:.3f} s, {n_it} L-BFGS iterations "
          f"({1e3 * t_step / max(n_it, 1):.2f} ms each), lanes "
          f"{int(out['iterations'].min())}-{int(out['iterations'].max())}")
    del out
    profile_steps(lambda: step3(th_b, th_b, W, Z_a, lanes, 1e-2), card,
                  "phase 9", nsteps=1)
    del W, Z_a
    phase(f"phase 9 [{card}] slice 3 walls: cold fit {runs[0]['fit_s']:.3f} "
          f"J {runs[0]['J_s']:.4f} H {runs[0]['H_s']:.3f} s; peak device "
          f"memory {peak3:.2f} GiB")
    return runs[0]["quad_launches"], fused_cg


def phase10(card, dev):
    """The user models, each a full muse(..., get_covariance=True) on the
    card: the 512-dim funnel, the vector funnel, the PPL funnel through
    model_problem, and a PPL model with a positive-support hyper."""
    import numpy as np
    import torch

    import muse_tpu_torch
    from muse_tpu_torch import distributions as dist
    from muse_tpu_torch import ppl, transforms
    from muse_tpu_torch.models import (funnel_analytic_H, funnel_problem,
                                       vector_funnel_problem)

    D, nsims = 512, 200
    kw = dict(nsims=nsims, theta_rtol=1e-3, grad_z_atol=1e-3,
              get_covariance=True, seed=1)

    def report(name, res, t, extra=""):
        phase(f"phase 10 [{card}] {name}: {res}  steps {len(res.history)}, "
              f"{t:.2f} s; θ̂ {np.round(res.theta, 5).tolist()} σ "
              f"{np.round(res.sigma, 5).tolist()}{extra}")
        if not (np.isfinite(res.theta).all() and np.isfinite(res.sigma).all()
                and not any(h["map_failed"].any() for h in res.history)):
            raise AssertionError(f"{name}: non-finite result or failed MAPs")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    pf = funnel_problem(D, device=dev)
    x = pf.x
    x64 = x.double().cpu().numpy()
    mle = float(np.log(np.sum(x64 ** 2) / D - 1))
    rf, t = timed(lambda: muse_tpu_torch.muse(pf, 1.0, **kw))
    th = float(rf.theta[0])
    H_exact = funnel_analytic_H(th, D)
    report("funnel_problem(512)", rf, t, f"; exact MLE {mle:.5f}, "
           f"|θ̂−MLE| {abs(th - mle):.5f} (< 0.05); H {rf.H[0, 0]:.3f} vs "
           f"analytic {H_exact:.3f} ({rf.H[0, 0] / H_exact - 1:+.2%})")
    if not abs(th - mle) < 0.05:
        raise AssertionError(f"funnel θ̂ {th} vs exact MLE {mle}")
    if not abs(rf.H[0, 0] / H_exact - 1) < 0.05:
        raise AssertionError(f"funnel H {rf.H[0, 0]} vs {H_exact}")

    pv = vector_funnel_problem(256, 4, device=dev)
    rv, t = timed(lambda: muse_tpu_torch.muse(pv, np.zeros(4), **kw))
    xb = pv.x.double().cpu().numpy().reshape(4, -1)
    mle_b = np.log(np.sum(xb ** 2, axis=1) / xb.shape[1] - 1)
    report("vector_funnel_problem(256, 4)", rv, t,
           f"; per-block exact MLEs {np.round(mle_b, 5).tolist()}")
    if not (np.abs(rv.theta - mle_b) < 3 * rv.sigma).all():
        raise AssertionError("vector funnel θ̂ off its per-block MLEs")

    def funnel():
        theta = ppl.sample("theta", dist.Normal(0.0, 3.0))
        z = ppl.sample("z", dist.Normal(0.0, torch.exp(theta / 2))
                       .expand((D,)))
        ppl.sample("x", dist.Normal(z, 1.0))

    rp, t = timed(lambda: muse_tpu_torch.muse(
        funnel, {"theta": 1.0}, observed={"x": x}, **kw))
    thp = float(rp.theta[0])
    report("PPL funnel (model function + observed)", rp, t,
           f"; |θ̂−MLE| {abs(thp - mle):.5f} (< 0.05); |θ̂ − "
           f"funnel_problem's θ̂| {abs(thp - th):.2e}")
    if not abs(thp - mle) < 0.05:
        raise AssertionError(f"PPL funnel θ̂ {thp} vs exact MLE {mle}")

    def scale_model():
        s = ppl.sample("s", dist.LogNormal(0.0, 1.0))
        z = ppl.sample("z", dist.Normal(0.0, s).expand((D,)))
        ppl.sample("x", dist.Normal(z, 1.0))

    ps = muse_tpu_torch.model_problem(scale_model, {"s": 1.0},
                                      observed={"x": x})
    if not isinstance(ps.theta_bijector, transforms.Blockwise):
        raise AssertionError("the positive hyper has no Blockwise bijector")
    rs, t = timed(lambda: muse_tpu_torch.muse(ps, {"s": 1.0}, **kw))
    s_mle = float(np.sqrt(np.sum(x64 ** 2) / D - 1))
    bound = 3 * float(rs.sigma[0]) / np.sqrt(nsims) + 0.02
    report("PPL LogNormal-scale model (Blockwise θ, volume factor)", rs, t,
           f"; exact MLE s {s_mle:.5f}, |ŝ−MLE| "
           f"{abs(float(rs.theta[0]) - s_mle):.5f} (< {bound:.5f})")
    if not abs(float(rs.theta[0]) - s_mle) < bound:
        raise AssertionError(f"ŝ {rs.theta[0]} vs exact MLE {s_mle}")
    return {name: {"theta": np.asarray(r.theta).tolist(),
                   "sigma": np.asarray(r.sigma).tolist()}
            for name, r in (("funnel", rf), ("vector_funnel", rv),
                            ("ppl_funnel", rp), ("ppl_scale", rs))}


# slice 4, the lensing pipeline (examples/lensing_demo.py:87-124, the
# n >= 1024 branch): data at θ = 0.3 from a fixed seed, 64 sims, implicit H
# of 8 sims; the chunk widths of the survey; the fit's settings
N4, THETA_TRUE4, DATA_SEED4, NSIMS4, H_NSIMS4 = 1024, 0.3, 7, 64, 8
WIDTHS4 = (3, 9, 17, 33, 65)
LENS_FIT4 = dict(alpha=0.3, Hinv_update="broyden", grad_z_atol=3e-3,
                 theta_rtol=3e-4, maxsteps=30)
ATOLS4_TIGHT = (1e-3, 1e-4)     # the MAP tolerances of the reported reruns
# the three-solver comparison, its MAPs solved to 1e-3: at the demo's 3e-3
# the L-BFGS fit's failed lanes (line searches at the float32 floor) feed
# its score and took its θ̂ to −0.05 against 0.28 for the other two
# (σ 0.22); at 1e-3 the three agree to 0.003. L-BFGS lanes flagged failed
# are printed and not gated: the plain Armijo test of batched_lbfgs has no
# float32 floor in either package, and on the same data and whites
# muse_tpu's own L-BFGS fit flags more lanes than the port's does
# (tests/test_torch_lensing.py holds the two side by side)
N4_SMALL, NSIMS4_SMALL, ATOL4_SMALL = 256, 16, 1e-3
# bandpower and the pixel GRF: 100 sims in one chunk of 101 lanes; the
# bandpower implicit H solves its fiducial MAPs in chunks of 5 sims; the
# pixel GRF's get_covariance flow solves 10 fiducial MAPs and a ±ε stencil
# batch of 20
NBANDS4, NSIMS4_GRF, H_CHUNK4_BAND = 12, 100, 5
H_LANES4_PIXEL = (NSIMS4_GRF // 10, 2 * (NSIMS4_GRF // 10))

# every lane count at which a main path launches a kernel at n = 1024.
# Phases 3 and 6 hold the kernels against their plain versions at each, and
# the run fails at its end if a kernel was launched at a shape they did
# not hold. The quadform: the fit chunks of slices 1, 3 and 4 (101 lanes)
# and of slice 2, the ±ε stencil batches of slices 1 and 4 (20 lanes) and
# slice 3's adaptive stencil (40). The fused kernel: the PCG of every fit
# chunk and of every get_H's fiducial and stencil MAP solves
#
# Slice 5, the mesh on the one card (phase 14): two ranks share it over
# gloo. A sims axis of 2 splits every chunk of lanes in two contiguous
# blocks, the first one longer (parallel/mesh.py); a field axis of 2 gives
# each rank MESH_ROWS of the 1024 rows of the packed (1024, 1026) grid
MESH_RANKS, MESH_ROWS = 2, 512


def _halves(c):
    """The sims blocks of a chunk of ``c`` lanes on MESH_RANKS ranks."""
    return {c - c // 2, c // 2} - {0}


# the sharded north star's sims halves: its fit chunks and its H's MAPs
MESH_LANES2 = sorted(set().union(*map(_halves, FIT_CHUNKS2)))
MESH_H_LANES2 = sorted(_halves(H_NSIMS2))
# Slice 7, the calibration studies (phase 16): the pixel GRF's fits in one
# chunk of 101 lanes and its implicit H's fiducial MAPs of 8 sims; the
# 6-band bandpower model's fit of 48 sims (49 lanes) and H of 6 sims; the
# north star's as slice 2's
H_NSIMS16_GRF, NSIMS16_BAND, H_NSIMS16_BAND, NBANDS16 = 8, 48, 6, 6
# Slice 8, the measuring programs (phase 17) at bench.py's defaults: 100
# sims × 1024² in one call of 101 lanes; the B = 1 baseline, check and
# floor lanes; 17b's --max-batch 32 (chunks of 32, 32, 32 and 5 lanes);
# 17c's A/B of 16 sims (17 lanes)
NSIMS17, MAX_BATCH17, AB_NSIMS17 = 100, 32, 16
LANES17 = sorted({1, NSIMS17 + 1, MAX_BATCH17, (NSIMS17 + 1) % MAX_BATCH17,
                  AB_NSIMS17 + 1})
QUAD_LANES = sorted({1, 17, 101, *FIT_CHUNKS2, NSIMS3 + 1, H_LANES3,
                     NSIMS4_GRF + 1, H_LANES4_PIXEL[1], *MESH_LANES2,
                     *LANES17, NSIMS18 + 1})
FUSED_LANES = sorted({1, 17, H_NSIMS2, *FIT_CHUNKS2, NSIMS3 + 1, H_NSIMS3,
                      H_LANES3, NSIMS4_GRF + 1, H_CHUNK4_BAND,
                      *H_LANES4_PIXEL, *MESH_LANES2, *MESH_H_LANES2,
                      H_NSIMS16_GRF, *LANES17, NSIMS18 + 1, H_NSIMS18})
# the bandpower operators' lane counts: slice 4's 12 bands, slice 7's 6
FUSED_BAND = ((NBANDS4, (NSIMS4_GRF + 1, H_CHUNK4_BAND)),
              (NBANDS16, (NSIMS16_BAND + 1, H_NSIMS16_BAND)))
# and the lane counts at which the field axis launches on MESH_ROWS rows:
# the north star's fit chunks and H's MAPs; the bandpower fit's chunk and
# its H's chunks (the 12-band operator)
QUAD_SLICED = FIT_CHUNKS2
FUSED_SLICED = sorted({*FIT_CHUNKS2, H_NSIMS2})
FUSED_SLICED_BAND = sorted({NSIMS4_GRF + 1, H_CHUNK4_BAND})


def timed(fn):
    """(fn(), its wall seconds), the device drained before and after."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def clamp_steps(theta0, width=0.3):
    """The demo's trust-region guard for a log-amplitude: each θ-step is
    clamped to ±``width`` around the last θ (examples/lensing_demo.py:56-61)."""
    import numpy as np
    prev = {"v": np.array(theta0, np.float64)}

    def regularize(th_t):
        th_t = np.clip(th_t, prev["v"] - width, prev["v"] + width)
        prev["v"] = np.asarray(th_t)
        return th_t
    return regularize


#: the lens operator's four passes (``ops/lens_planes.py``), phase 19
LENS_PASSES = ("expand", "combine", "residual", "spread", "contract")


def lensing_counts():
    """The counters of the lensing MAP solvers, as a dict."""
    from muse_tpu_torch.models.lensing import zhat_varpro_counts
    from muse_tpu_torch.ops import lens_planes as lp
    from muse_tpu_torch.ops.newton_cg import batched_newton_cg as nc
    from muse_tpu_torch.ops.varpro import batched_varpro as vp
    return {"outer": vp.iterations, "ls_trials": vp.ls_trials,
            "inner_steps": vp.inner_steps,
            "syncs": vp.host_syncs + nc.host_syncs,
            "newton": nc.iterations, "steihaug": nc.cg_steps,
            "hvps": nc.hvps, "polish": zhat_varpro_counts.polish_entries,
            **{k: getattr(lp, f"lens_{k}_cuda").launches
               for k in LENS_PASSES}}


def phase11(card, dev):
    """The lensing operators on the card: the explicit (G, Gᵀ) pair, the
    Hessian-vector product and the batch-of-5 against B=1 MAP."""
    import torch
    from torch.func import jvp, linearize, vjp

    from muse_tpu_torch.models import lensing_problem

    n = N4
    L = 2 * n * (n // 2 + 1)
    prob = lensing_problem(n=n, theta_true=THETA_TRUE4, data_seed=DATA_SEED4,
                           device=dev)
    ops = prob.varpro_ops(torch.tensor([0.5], device=dev))
    for B in (1, 5):
        g = torch.Generator(device=dev).manual_seed(B)
        Up = 0.5 * torch.randn((B, n * n), generator=g, device=dev)
        Zt = torch.randn((B, L), generator=g, device=dev)
        W = torch.randn((B, n, n), generator=g, device=dev)
        G, Gt = ops["lin_ops"](Up)
        Gz, Gtw = G(Zt), Gt(W)
        lhs = (Gz.double() * W.double()).sum((-2, -1))
        rhs = (Zt.double() * Gtw.double()).sum(-1)
        scale = (Gz.double().flatten(1).norm(dim=-1)
                 * W.double().flatten(1).norm(dim=-1))
        adj = ((lhs - rhs).abs() / scale).max().item()
        vjp_fn = vjp(lambda V: ops["obs_op"](Up, V), torch.zeros_like(Zt))[1]
        Gt_ad = vjp_fn(W)[0]
        rel_t = ((Gtw - Gt_ad).abs().max() / Gt_ad.abs().max()).item()
        obs = ops["obs_op"](Up, Zt)
        rel_g = ((Gz - obs).abs().max() / obs.abs().max()).item()
        ms = {"G": cuda_ms(lambda: G(Zt), samples=5, per_sample=4),
              "Gt": cuda_ms(lambda: Gt(W), samples=5, per_sample=4),
              "Gt_ad": cuda_ms(lambda: vjp_fn(W), samples=5, per_sample=4),
              "obs_op": cuda_ms(lambda: ops["obs_op"](Up, Zt), samples=5,
                                per_sample=4)}
        phase(f"phase 11 [{card}] n={n} B={B}: adjoint identity "
              f"|<Gz,w> - <z,Gtw>|/(|Gz||w|) {adj:.3e} (<= 1e-5); explicit Gt "
              f"vs AD transpose {rel_t:.3e} (<= 1e-4); G vs obs_op "
              f"{rel_g:.3e}; ms: G {ms['G']:.3f}, Gt {ms['Gt']:.3f}, AD "
              f"transpose {ms['Gt_ad']:.3f}, obs_op {ms['obs_op']:.3f}")
        if not (adj <= 1e-5 and rel_t <= 1e-4 and rel_g <= 1e-4):
            raise AssertionError(f"the explicit operator pair fails at B={B}")
        del G, Gt, Gz, Gtw, vjp_fn, Gt_ad, obs, Up, Zt, W

    # one HVP against a central difference of the gradient, in float64
    p64 = lensing_problem(n=64, theta_true=THETA_TRUE4, data_seed=DATA_SEED4,
                          device=dev)
    th = torch.tensor([THETA_TRUE4], device=dev)
    g = torch.Generator(device=dev).manual_seed(64)
    xs = torch.stack([p64.sample_x_z(g, THETA_TRUE4)[0] for _ in range(3)])
    fn = p64.value_and_grad(xs.double(), th)
    U = 0.3 * torch.randn((3, 2 * 64 * 64), generator=g, device=dev,
                          dtype=torch.float64)
    V = torch.randn(U.shape, generator=g, device=dev, dtype=torch.float64)
    hv = vjp(lambda u: fn(u)[1], U)[1](V)[0]
    eps = 1e-5
    fd = (fn(U + eps * V)[1] - fn(U - eps * V)[1]) / (2 * eps)
    err = ((hv - fd).abs().max() / fd.abs().max()).item()
    phase(f"phase 11 [{card}] HVP (vjp of the gradient) vs a central "
          f"difference of the gradient, float64, n=64: relative error "
          f"{err:.3e} (<= 1e-6)")
    if not err <= 1e-6:
        raise AssertionError("the Hessian-vector product is wrong")

    # the three HVP routes at full width (forward-mode AD through the FFT
    # chain is what jvp and linearize need, and implicit-diff H too)
    B = 5
    g = torch.Generator(device=dev).manual_seed(5)
    xs = torch.stack([prob.sample_x_z(g, THETA_TRUE4)[0] for _ in range(B)])
    fn = prob.value_and_grad(xs, th)

    def grad_only(u):
        return fn(u)[1]

    U = 0.3 * torch.randn((B, 2 * n * n), generator=g, device=dev)
    V = torch.randn(U.shape, generator=g, device=dev)
    (_, vjp_fn), t_vjp = timed(lambda: vjp(grad_only, U))
    (_, lin_fn), t_lin = timed(lambda: linearize(grad_only, U))
    h_vjp = vjp_fn(V)[0]
    h_jvp = jvp(grad_only, (U,), (V,))[1]
    h_lin = lin_fn(V)
    scale = h_jvp.abs().max()
    d_vj = ((h_vjp - h_jvp).abs().max() / scale).item()
    d_lj = ((h_lin - h_jvp).abs().max() / scale).item()
    ms = {"gradient": cuda_ms(lambda: fn(U), samples=5, per_sample=3),
          "vjp": cuda_ms(lambda: vjp_fn(V), samples=5, per_sample=3),
          "jvp": cuda_ms(lambda: jvp(grad_only, (U,), (V,)), samples=5,
                         per_sample=3),
          "linearize": cuda_ms(lambda: lin_fn(V), samples=5, per_sample=3)}
    phase(f"phase 11 [{card}] HVP routes at n={n} B={B}: value and gradient "
          f"{ms['gradient']:.2f} ms; vjp of the gradient (the one that "
          f"runs) {ms['vjp']:.2f} ms per product after {1e3 * t_vjp:.1f} ms "
          f"to build; jvp of the gradient {ms['jvp']:.2f} ms per product; "
          f"linearize {ms['linearize']:.2f} ms per product after "
          f"{1e3 * t_lin:.1f} ms to build; vjp vs jvp {d_vj:.3e}, linearize "
          f"vs jvp {d_lj:.3e} of the largest entry")
    if not (d_vj <= 1e-3 and d_lj <= 1e-3):
        raise AssertionError("the HVP routes disagree")
    del vjp_fn, lin_fn, h_vjp, h_jvp, h_lin, U, V, xs, fn

    # a lane in a batch of 5 against the same lane alone
    th = torch.tensor([-1.0], device=dev)
    g = torch.Generator(device=dev).manual_seed(11)
    xs = torch.stack([prob.sample_x_z(g, -1.0)[0] for _ in range(5)])
    (Z5, a5), t5 = timed(lambda: prob.custom_zhat(
        xs, torch.zeros((5, 2 * n * n), device=dev), th, 1e-2))
    (Z1, a1), t1 = timed(lambda: prob.custom_zhat(
        xs[2:3], torch.zeros((1, 2 * n * n), device=dev), th, 1e-2))
    f5, f1 = float(a5["neg_logp"][2]), float(a1["neg_logp"][0])
    rel = abs(f5 - f1) / abs(f1)
    dz = ((Z5[2] - Z1[0]).abs().max() / Z1.abs().max()).item()
    phase(f"phase 11 [{card}] zhat_varpro at θ=-1, lane 2 of 5 vs alone: "
          f"objective {f5:.3f} vs {f1:.3f} (relative {rel:.3e} <= 1e-5), "
          f"max |ΔZ|/max|Z| {dz:.3e}; iterations "
          f"{a5['iterations'].tolist()} vs {a1['iterations'].tolist()}; "
          f"g_norm {[round(float(v), 5) for v in a5['g_norm']]}; "
          f"{t5:.2f} s and {t1:.2f} s")
    if not (rel <= 1e-5 and bool(a5["converged"].all())
            and bool(a1["converged"].all())):
        raise AssertionError("a lane's MAP depends on its batch")


def phase12(card, dev):
    """The lensing pipeline at full width, then the three solvers at 256²."""
    import numpy as np
    import torch

    import muse_tpu_torch
    from muse_tpu_torch.models import lensing_problem
    from muse_tpu_torch.solver import CompiledProblem
    from muse_tpu_torch.theta import ThetaSpec
    from muse_tpu_torch.utils.keys import dummy_seed, sim_seeds

    atol = LENS_FIT4["grad_z_atol"]
    prob = lensing_problem(n=N4, theta_true=THETA_TRUE4,
                           data_seed=DATA_SEED4, device=dev)
    held = torch.cuda.memory_allocated() / 2 ** 30
    phase(f"phase 12 [{card}] lensing_problem(n={N4}, theta_true="
          f"{THETA_TRUE4}): budgets {prob.solver_budgets}; {held:.2f} GiB "
          f"of device memory are held by the phases before (the peaks below "
          f"include them)")
    comp = CompiledProblem(prob, ThetaSpec.from_example(0.0), np.array([0.0]))
    step_white = comp.muse_step_white
    seeds_all = [dummy_seed(1)] + sim_seeds(1, NSIMS4)     # the fit's lanes
    z0_flat = comp.zspec.flatten(prob.suggested_z0)

    # the chunk-width survey: the fit's first step (θ₀ = 0 from z0) and a
    # warm one a θ-step of 0.1 on, at each width
    th_a, th_b = comp.theta(np.array([0.0])), comp.theta(np.array([0.1]))
    survey = {}
    for w in WIDTHS4:
        W = comp.sample_whites(seeds_all[:w], x_only=True)
        lanes = torch.arange(w, device=dev)
        Z0 = z0_flat.expand(w, comp.nz).clone()
        torch.cuda.reset_peak_memory_stats()
        c0 = lensing_counts()
        out_a, t_a = timed(lambda: step_white(th_a, th_a, W, Z0, lanes, atol))
        c1 = lensing_counts()
        out_b, t_b = timed(lambda: step_white(th_b, th_b, W, out_a["Z"],
                                              lanes, atol))
        c2 = lensing_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        survey[w] = t_b / w
        phase(f"phase 12 [{card}] width {w}: first step {t_a:.2f} s "
              f"({t_a / w:.3f} s/lane; {c1['outer'] - c0['outer']} VarPro "
              f"iterations, {c1['inner_steps'] - c0['inner_steps']} inner "
              f"steps, {c1['newton'] - c0['newton']} polish iterations, "
              f"{int(out_a['converged'].sum())}/{w} converged), warm step "
              f"{t_b:.2f} s ({t_b / w:.3f} s/lane; "
              f"{c2['outer'] - c1['outer']} VarPro iterations, "
              f"{c2['inner_steps'] - c1['inner_steps']} inner steps, "
              f"{c2['newton'] - c1['newton']} polish iterations, "
              f"{int(out_b['converged'].sum())}/{w} converged); peak "
              f"{peak:.2f} GiB")
        del W, Z0, out_a, out_b
    width = min(survey, key=survey.get)
    phase(f"phase 12 [{card}] warm seconds per lane by width "
          f"{ {w: round(s, 4) for w, s in survey.items()} }: the fit runs "
          f"at max_batch={width}")

    # the fit, J and H
    nchunks = -(-(NSIMS4 + 1) // width)
    calls, kept = [], {}

    def counted_step(*args, **kwargs):
        c0 = lensing_counts()
        out, t = timed(lambda: step_white(*args, **kwargs))
        c1 = lensing_counts()
        it = out["iterations"].cpu().numpy()
        calls.append({
            "s": t, "lanes": len(it),
            "lane_iterations": (int(it.min()), float(np.median(it)),
                                int(it.max())),
            "inner_cg": int(out["cg_iterations"].sum()),
            "converged": int(out["converged"].sum()),
            "failed": int(out["failed"].sum()),
            **{k: c1[k] - c0[k] for k in c0}})
        if len(calls) == 2 * nchunks + 1:     # the third step's first chunk
            kept["args"] = args
        return out

    def keyed_step(*args, **kwargs):
        raise AssertionError("the lensing fit called muse_step, not "
                             "muse_step_white")

    comp.muse_step_white = counted_step
    comp.muse_step = keyed_step
    torch.cuda.reset_peak_memory_stats()
    res = muse_tpu_torch.MuseResult()
    _, t_fit = timed(lambda: muse_tpu_torch.muse_fit(
        res, prob, 0.0, nsims=NSIMS4, z0=prob.suggested_z0,
        regularize=clamp_steps([0.0]), max_batch=width, compiled=comp,
        seed=1, **LENS_FIT4))
    fit_calls = len(calls)
    _, t_j = timed(lambda: muse_tpu_torch.get_J(
        res, prob, nsims=NSIMS4, grad_z_atol=atol, max_batch=width,
        warn_reuse=False, skip_errors=True, compiled=comp))
    _, t_h = timed(lambda: muse_tpu_torch.get_H(
        res, prob, nsims=H_NSIMS4, implicit_diff=True,
        implicit_diff_precond=prob.suggested_h_precond,
        implicit_fit_atol=1e-3, max_batch=width, compiled=comp))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for i, c in enumerate(calls[:fit_calls]):
        phase(f"phase 12 step {i // nchunks + 1} chunk {i % nchunks + 1} "
              f"({c['lanes']} lanes): {c['s']:.3f} s; VarPro outer "
              f"iterations min/median/max {c['lane_iterations']} "
              f"({c['outer']} run), inner CG iterations {c['inner_cg']} "
              f"({c['inner_steps']} steps run), {c['ls_trials']} "
              f"line-search trials, {c['polish']} polish entries "
              f"({c['newton']} Newton iterations, {c['steihaug']} Steihaug "
              f"steps, {c['hvps']} HVPs), {c['syncs']} host syncs, "
              f"{c['converged']}/{c['lanes']} converged, {c['failed']} "
              f"failed; lens-plane launches "
              f"{ {k: c[k] for k in LENS_PASSES} }")
    th, sig = float(res.theta[0]), float(res.sigma[0])
    unconv = [int((~h["map_converged"]).sum()) for h in res.history]
    failed = [int(h["map_failed"].sum()) for h in res.history]
    phase(f"phase 12 [{card}] fit: {res}  steps {len(res.history)}; J/H is "
          f"{float(res.J[0, 0]) / float(res.H[0, 0]):.4f} (the covariance "
          f"warns below 0.01: the scores' scatter at this MAP tolerance is "
          f"far below the curvature); θ by "
          f"step {[round(float(h['theta'][0]), 4) for h in res.history]}; "
          f"|θ̂ − {THETA_TRUE4}| {abs(th - THETA_TRUE4):.4f} (< 3σ = "
          f"{3 * sig:.4f}; z-score {(th - THETA_TRUE4) / sig:+.2f}); J "
          f"{float(res.J[0, 0]):.2f} ({len(res.gs)} scores) H "
          f"{float(res.H[0, 0]):.2f}; lanes frozen unconverged by step "
          f"{unconv}, failed by step {failed}")
    phase(f"phase 12 [{card}] walls: fit {t_fit:.2f} s, J {t_j:.4f} s, H "
          f"{t_h:.2f} s; peak device memory {peak:.2f} GiB; max CG resid of "
          f"H {max(float(np.max(r)) for r in res.metadata['implicit_diff_cg_resid']):.3e}")
    if not (np.isfinite(th) and np.isfinite(sig) and sig > 0):
        raise AssertionError("non-finite θ̂, or σ not finite and positive")
    if not abs(th - THETA_TRUE4) < 3 * sig:
        raise AssertionError(f"θ̂ {th} is more than 3σ ({sig}) from "
                             f"{THETA_TRUE4}")
    if any(failed):
        raise AssertionError(f"lanes flagged failed, by step: {failed}")
    if not all(c[k] >= 1 for c in calls[:fit_calls] for k in LENS_PASSES):
        raise AssertionError("a fit step of the lensing model left a "
                             "lens-plane kernel unlaunched")

    # the same pipeline with the MAPs solved tighter than the demo's 3e-3,
    # which ends most 1024² solves within two VarPro iterations: what the
    # tolerance does to θ̂, σ and the walls (reported, not gated)
    comp.muse_step_white = step_white
    for tight in ATOLS4_TIGHT:
        c0 = lensing_counts()
        r = muse_tpu_torch.MuseResult()
        _, t_f = timed(lambda: muse_tpu_torch.muse_fit(
            r, prob, 0.0, nsims=NSIMS4, z0=prob.suggested_z0,
            regularize=clamp_steps([0.0]), max_batch=width, compiled=comp,
            seed=1, **dict(LENS_FIT4, grad_z_atol=tight)))
        c1 = lensing_counts()
        muse_tpu_torch.get_J(r, prob, nsims=NSIMS4, grad_z_atol=tight,
                             max_batch=width, warn_reuse=False,
                             skip_errors=True, compiled=comp)
        _, t_hh = timed(lambda: muse_tpu_torch.get_H(
            r, prob, nsims=H_NSIMS4, implicit_diff=True,
            implicit_diff_precond=prob.suggested_h_precond,
            implicit_fit_atol=tight, max_batch=width, compiled=comp))
        phase(f"phase 12 [{card}] the same with grad_z_atol={tight}: {r}  "
              f"steps {len(r.history)}; VarPro iterations "
              f"{c1['outer'] - c0['outer']}, inner steps "
              f"{c1['inner_steps'] - c0['inner_steps']}, polish iterations "
              f"{c1['newton'] - c0['newton']}; J {float(r.J[0, 0]):.5f} H "
              f"{float(r.H[0, 0]):.4f}; fit {t_f:.2f} s, H {t_hh:.2f} s; "
              f"lanes unconverged by step "
              f"{[int((~h['map_converged']).sum()) for h in r.history]}")

    # where the time of a warm step goes: the third fit step's first chunk
    step_args = kept["args"]
    _, t_step = timed(lambda: step_white(*step_args))
    phase(f"phase 12 [{card}] the third fit step's first chunk again "
          f"({step_args[4].numel()} lanes): {t_step:.3f} s")
    profile_steps(lambda: step_white(*step_args), card, "phase 12", nsteps=1,
                  fft_share=True)
    del step_args, kept

    # Newton-CG at full width, which the fit above never entered: the
    # fit's chunk at θ₀ = 0 from the Wiener start, first through
    # solver="newton" cut at 3 outer iterations, then through VarPro cut at
    # one iteration with the MAPs asked to 1e-4, which leaves lanes for the
    # polish. Walls, counts and peak memory (reported; gated on finite
    # values and the polish having run)
    xs = comp._xs_of_whites(
        comp.sample_whites(seeds_all[:width], x_only=True), th_a)
    Z0 = z0_flat.expand(width, -1).clone()
    for label, solver_kw, tol in (
            ("solver='newton', 3 outer iterations",
             dict(solver="newton", gn_max_outer=3), atol),
            ("VarPro cut at 1 iteration, then the polish (20 outer "
             "iterations of at most 10 Steihaug steps), MAPs to 1e-4",
             dict(solver="varpro", gn_max_outer=1, gn_cg_maxiter=10), 1e-4)):
        p = lensing_problem(n=N4, x_obs=prob.x, device=dev, **solver_kw)
        torch.cuda.reset_peak_memory_stats()
        c0 = lensing_counts()
        (Z, aux), t = timed(lambda: p.custom_zhat(xs, Z0, th_a, tol))
        c1 = lensing_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        phase(f"phase 12 [{card}] Newton-CG at {width} lanes × {N4}², "
              f"{label}: {t:.2f} s; {c1['newton'] - c0['newton']} Newton "
              f"iterations, {c1['steihaug'] - c0['steihaug']} Steihaug "
              f"steps, {c1['hvps'] - c0['hvps']} HVPs "
              f"({1e3 * t / max(c1['hvps'] - c0['hvps'], 1):.1f} ms of wall "
              f"each), {c1['outer'] - c0['outer']} VarPro iterations, "
              f"{c1['polish'] - c0['polish']} polish entries; "
              f"{int(aux['converged'].sum())}/{width} converged, "
              f"{int(aux['failed'].sum())} failed, sup|g| max "
              f"{float(aux['g_norm'].max()):.3e}; peak {peak:.2f} GiB")
        if not (torch.isfinite(Z).all()
                and torch.isfinite(aux["neg_logp"]).all()):
            raise AssertionError("Newton-CG at full width: non-finite MAPs")
        if solver_kw["solver"] == "varpro" and not (
                c1["polish"] - c0["polish"] == 1
                and c1["hvps"] > c0["hvps"]):
            raise AssertionError("the polish did not run")
        del p, Z, aux
    del xs, Z0, comp

    # the three solvers at 256², one data set and one set of seeds
    x_small = lensing_problem(n=N4_SMALL, theta_true=THETA_TRUE4,
                              data_seed=DATA_SEED4, device=dev).x
    found = {}
    fit_small = dict(LENS_FIT4, grad_z_atol=ATOL4_SMALL)
    for solver in ("varpro", "newton", "lbfgs"):
        p = lensing_problem(n=N4_SMALL, solver=solver, x_obs=x_small,
                            device=dev)
        r = muse_tpu_torch.MuseResult()
        _, t = timed(lambda: muse_tpu_torch.muse_fit(
            r, p, 0.0, nsims=NSIMS4_SMALL, z0=p.suggested_z0,
            regularize=clamp_steps([0.0]), seed=1, **fit_small))
        if solver == "varpro":
            muse_tpu_torch.get_J(r, p, nsims=NSIMS4_SMALL,
                                 grad_z_atol=ATOL4_SMALL, warn_reuse=False,
                                 skip_errors=True)
            muse_tpu_torch.get_H(r, p, nsims=H_NSIMS4, implicit_diff=True,
                                 implicit_diff_precond=p.suggested_h_precond,
                                 implicit_fit_atol=1e-3)
            found["sigma"] = float(r.sigma[0])
        found[solver] = float(r.theta[0])
        phase(f"phase 12 [{card}] n={N4_SMALL} nsims={NSIMS4_SMALL} "
              f"grad_z_atol={ATOL4_SMALL} solver={solver}: θ̂ "
              f"{found[solver]:.5f} in {len(r.history)} steps, fit {t:.2f} "
              f"s; lanes unconverged by step "
              f"{[int((~h['map_converged']).sum()) for h in r.history]}, "
              f"failed by step "
              f"{[int(h['map_failed'].sum()) for h in r.history]}")
    spread = max(found[s] for s in ("varpro", "newton", "lbfgs")) - min(
        found[s] for s in ("varpro", "newton", "lbfgs"))
    phase(f"phase 12 [{card}] the three θ̂ span {spread:.5f} (< 0.5σ = "
          f"{0.5 * found['sigma']:.5f}, σ {found['sigma']:.5f} from the "
          f"VarPro run's J and implicit H)")
    if not spread < 0.5 * found["sigma"]:
        raise AssertionError(f"the solvers disagree: {found}")
    found["lens_launches"] = {k: sum(c[k] for c in calls[:fit_calls])
                              for k in LENS_PASSES}
    return found


def phase19(card, dev):
    """The lens operator's four passes (``ops/lens_planes.py``,
    ``csrc/lens_planes.cu``) at the lensing cell's shapes, 65 lanes ×
    1024², on the model's own values (``varpro_ops`` at θ = 0.3: its
    spectral scale and the deflection of a drawn potential; x and z̃ drawn
    by its sampler): each kernel against its plain version evaluated in
    float64 (max error over the largest entry ≤ 1e-6; the residual form's
    Σr² a lane ≤ 1e-5 relative), a rerun bitwise equal, lane 0 bitwise
    its launch alone, and the CUDA-event time of kernel and plain version
    (float32) beside the bound (bytes read and written once over
    3.35 TB/s). Returns {pass: its row}."""
    import torch

    from muse_tpu_torch.models import lensing_problem
    from muse_tpu_torch.ops import lens_planes as lp

    n, B = N4, NSIMS4 + 1
    nr, N = n // 2 + 1, n * n
    m = n * nr
    prob = lensing_problem(n=n, theta_true=THETA_TRUE4, data_seed=DATA_SEED4,
                           device=dev)
    ops = prob.varpro_ops(torch.tensor([THETA_TRUE4], device=dev))
    g = torch.Generator(device=dev).manual_seed(19)
    draws = [prob.sample_x_z(g, THETA_TRUE4) for _ in range(B)]
    xs = torch.stack([x for x, _ in draws])
    d = ops["deflection"](torch.stack([u["uphi"] for _, u in draws])
                          .reshape(B, -1))
    zt = ops["pack"](torch.fft.rfft2(torch.stack([u["uz"] for _, u in
                                                  draws])))
    del draws
    c = ops["scale"]
    P6 = torch.fft.irfft2(lp.lens_expand(zt, c), s=(n, n))
    F6 = torch.fft.rfft2(lp.lens_spread(xs, d))
    f4, plane = 4, 4 * B * N
    # name: (pass, args, keyword, args shared by the lanes, bytes); the
    # residual form without r is the one the reduced gradient runs, with r
    # the certificate's
    cases = {"expand": ("expand", (zt, c), {}, (1,),
                        f4 * (B * 2 * m + m) + 8 * B * 6 * m),
             "combine": ("combine", (P6, d), {}, (), plane * (6 + 2 + 1)),
             "residual": ("residual", (P6, d, xs), {"keep_r": False}, (),
                          plane * (6 + 2 + 1 + 2)),
             "residual_with_r": ("residual", (P6, d, xs), {}, (),
                                 plane * (6 + 2 + 1 + 1 + 2)),
             "spread": ("spread", (xs, d), {}, (), plane * (1 + 2 + 6)),
             "contract": ("contract", (F6, c), {}, (1,),
                          8 * B * 6 * m + f4 * (m + B * 2 * m))}
    rows = {}
    for name, (base, args, kw, shared, nbytes) in cases.items():
        kernel = getattr(lp, f"lens_{base}_cuda")
        plain = getattr(lp, f"lens_{base}_plain")

        def outs(out):
            return [t for t in (out if isinstance(out, tuple) else (out,))
                    if t is not None]

        def run(*a):
            return outs(kernel(*a, **kw))
        got = run(*args)
        want = outs(plain(*[a.to(torch.complex128 if a.is_complex()
                                 else torch.float64) for a in args], **kw))
        errs = [float((k.to(w.dtype) - w).abs().max() / w.abs().max())
                for k, w in zip(got, want)]
        if base == "residual":                      # Σr² lane by lane
            i = len(got) - 2
            errs[i] = float(((got[i].double() - want[i]).abs()
                             / want[i].abs()).max())
        sum_err = errs[len(got) - 2] if base == "residual" else 0.0
        del want
        bitwise = all(torch.equal(a, b) for a, b in zip(got, run(*args)))
        alone = all(torch.equal(a, b[:1]) for a, b in zip(run(*[
            a if i in shared else a[:1].contiguous()
            for i, a in enumerate(args)]), got))
        del got
        ms = cuda_ms(lambda: kernel(*args, **kw))
        plain_ms = cuda_ms(lambda: plain(*args, **kw), samples=5,
                           per_sample=4)
        bound, _ = least_ms(nbytes, 0)
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                      "share": bound / ms, "max_err": max(errs)}
        phase(f"phase 19 [{card}] lens_{name} at ({B}, {n}²): errors vs "
              f"float64 {[f'{e:.2e}' for e in errs]}; rerun bitwise "
              f"{bitwise}, lane 0 bitwise alone {alone}; kernel {ms:.4f} "
              f"ms, bound {bound:.4f} ms ({nbytes / 1e9:.3f} GB; "
              f"{100 * bound / ms:.1f}%), plain {plain_ms:.3f} ms")
        plane_errs = [e for i, e in enumerate(errs)
                      if not (base == "residual" and i == len(errs) - 2)]
        if not (max(plane_errs) <= 1e-6 and sum_err <= 1e-5):
            raise AssertionError(f"lens_{name} disagrees with its plain "
                                 f"version: {errs}")
        if not (bitwise and alone):
            raise AssertionError(f"lens_{name} is not deterministic lane by "
                                 f"lane")
    return rows


def phase13(card, dev, field):
    """Bandpower (vector θ) and the pixel GRF at 1024², σ_noise = 0.01.
    ``field`` is (the field GRF problem, its fitted result) of phase 4.
    Returns the kernels' launch counts on the two paths."""
    import numpy as np
    import torch

    import muse_tpu_torch
    from muse_tpu_torch.models import (bandpower_mle, bandpower_problem,
                                       grf_marginal_mle, grf_problem)
    from muse_tpu_torch.models.bandpower import _k_grid64, band_edges
    from muse_tpu_torch.ops import grf_spectrum as gs
    from muse_tpu_torch.ops.cg import batched_cg

    n, nb = N4, NBANDS4
    pb = bandpower_problem(n=n, nbands=nb, sigma_noise=0.01, data_seed=42,
                           device=dev)
    mle, cov = bandpower_mle(pb.x_real, n, nb, sigma_noise=0.01)
    sig_F = np.sqrt(np.diag(cov))

    # the band reduction (sorted slices, each summed by torch.sum) on 101
    # lanes of score terms, against a float64 sum
    B = NSIMS4_GRF + 1
    band = torch.tensor(np.tile(np.searchsorted(
        band_edges(n, nb), _k_grid64(n), side="right").reshape(-1), 2),
        device=dev)
    g = torch.Generator(device=dev).manual_seed(13)
    q = torch.randn((B, band.numel()), generator=g, device=dev) ** 2
    want = torch.stack([(q.double() * (band == b)).sum(-1)
                        for b in range(nb)], -1)

    def reduce():
        return torch.func.vmap(pb.band_sum)(q)

    got, again = reduce(), reduce()
    rel = ((got.double() - want).abs() / want).max().item()
    phase(f"phase 13 [{card}] band reduction (B={B}, {nb} bands × 1024²): "
          f"{cuda_ms(reduce, samples=5, per_sample=5):.3f} ms, max relative "
          f"error vs float64 {rel:.3e} (<= 1e-5), rerun bitwise equal: "
          f"{bool(torch.equal(got, again))}")
    if not (rel <= 1e-5 and torch.equal(got, again)):
        raise AssertionError("the band reduction is off or not reproducible")
    del q, want, got, again

    gs.reset_counts()
    batched_cg.curvature_steps = 0
    torch.cuda.reset_peak_memory_stats()
    res = muse_tpu_torch.MuseResult()
    _, t_fit = timed(lambda: muse_tpu_torch.muse_fit(
        res, pb, np.zeros(nb), nsims=NSIMS4_GRF, theta_rtol=1e-5, alpha=1.0,
        seed=1))
    _, t_j = timed(lambda: muse_tpu_torch.get_J(
        res, pb, nsims=NSIMS4_GRF, warn_reuse=False))
    _, t_h = timed(lambda: muse_tpu_torch.get_H(
        res, pb, nsims=NSIMS4_GRF // 10, implicit_diff=True,
        implicit_diff_precond=pb.suggested_h_precond,
        max_batch=H_CHUNK4_BAND))
    fused_band = gs.spectrum_quadform_and_grad_cuda.launches
    cg_steps = batched_cg.curvature_steps
    Sigma = np.asarray(res.Sigma)
    ratio = np.diag(Sigma) / np.diag(cov)
    corr = Sigma / np.sqrt(np.outer(np.diag(Sigma), np.diag(Sigma)))
    off = np.abs(corr - np.eye(nb)).max()
    gap = np.abs(np.asarray(res.theta) - mle)
    bound = 3 * sig_F / np.sqrt(NSIMS4_GRF) + 0.02
    phase(f"phase 13 [{card}] bandpower fit: steps {len(res.history)}; θ̂ "
          f"{np.round(res.theta, 5).tolist()}; MLE "
          f"{np.round(mle, 5).tolist()}; σ_F {np.round(sig_F, 5).tolist()}; "
          f"max |θ̂−MLE| {gap.max():.5f} (each < 3σ_b/10 + 0.02: "
          f"{bool((gap < bound).all())}); diag Σ / Fisher "
          f"{np.round(ratio, 3).tolist()}; max |off-diagonal correlation| "
          f"{off:.3f}; fused launches {fused_band} = CG steps {cg_steps}; "
          f"walls fit {t_fit:.3f} s, J {t_j:.4f} s, implicit H {t_h:.3f} s "
          f"(max CG resid "
          f"{max(float(np.max(r)) for r in res.metadata['implicit_diff_cg_resid']):.3e}); "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    if not (gap < bound).all():
        raise AssertionError("a band's θ̂ is off its MLE")
    if not ((ratio > 0.5) & (ratio < 2.0)).all():
        raise AssertionError(f"diag Σ against the Fisher diagonal: {ratio}")
    if not off < 0.3:
        raise AssertionError(f"off-diagonal correlation {off}")
    if not fused_band == cg_steps > 0:
        raise AssertionError("fused launches do not match the CG steps")
    if any(h["map_failed"].any() for h in res.history):
        raise AssertionError("a bandpower MAP failed")
    band_theta = np.asarray(res.theta)
    del pb, res

    # the pixel GRF on the field GRF's data
    kw = dict(nsims=NSIMS4_GRF, theta_rtol=1e-5, maxsteps=20,
              get_covariance=True)
    pf, res_f = field
    pg = grf_problem(n=n, sigma_noise=0.01, solver="cg", x_obs=pf.x,
                     device=dev)
    mle_g, sig_g = grf_marginal_mle(pg.x, pg.grf_config)
    gs.reset_counts()
    batched_cg.curvature_steps = 0
    torch.cuda.reset_peak_memory_stats()
    res_g, t_g = timed(lambda: muse_tpu_torch.muse(pg, 0.5, **kw))
    qc = quad_counts()
    quad, evals = qc["quad_launches"], qc["quad_evaluations"]
    fused_grf = gs.spectrum_quadform_and_grad_cuda.launches
    th, sig = float(res_g.theta[0]), float(res_g.sigma[0])
    steps = len(res_g.history)
    bound = 3 * sig_g / np.sqrt(NSIMS4_GRF) + 0.02
    d_field = abs(th - float(res_f.theta[0]))
    phase(f"phase 13 [{card}] grf_problem(solver='cg') fit: {res_g}  steps "
          f"{steps}; MLE {mle_g:.6f} σ_F {sig_g:.6f}; |θ̂−MLE| "
          f"{abs(th - mle_g):.6f} (< {bound:.6f}); σ/σ_F {sig / sig_g:.4f}; "
          f"|θ̂ − θ̂ of grf_field_problem| {d_field:.6f} (< 0.25σ_F = "
          f"{0.25 * sig_g:.6f}); quadform launches {quad} = {evals} batched "
          f"score evaluations = {steps} steps + 1 get_H chunk; fused "
          f"launches {fused_grf} = CG steps {batched_cg.curvature_steps}; "
          f"fit + J + H {t_g:.3f} s, iterations "
          f"{[round(h['t'], 4) for h in res_g.history]} s; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    if not (np.isfinite(th) and np.isfinite(sig)):
        raise AssertionError("non-finite θ̂ or σ")
    if not abs(th - mle_g) < bound:
        raise AssertionError(f"θ̂ {th} vs MLE {mle_g}")
    if not 0.5 < sig / sig_g < 2:
        raise AssertionError(f"σ {sig} vs σ_F {sig_g}")
    if not d_field < 0.25 * sig_g:
        raise AssertionError("the whitened and the field latent disagree")
    if not (quad > 0 and quad == evals == steps + 1
            and qc["quad1_launches"] == 0):
        raise AssertionError(f"{quad} quadform launches, {evals} score "
                             f"evaluations, {steps + 1} chunks")
    if not fused_grf == batched_cg.curvature_steps > 0:
        raise AssertionError("fused launches do not match the CG steps")
    return {"fused_bandpower": fused_band, "fused_grf_pixel": fused_grf,
            "quad_grf_pixel": quad, "band_theta": band_theta,
            "band_fit_s": t_fit, "band_J_s": t_j, "band_H_s": t_h,
            "pixel": {"theta": th, "sigma": sig, "J": float(res_g.J[0, 0]),
                      "H": float(res_g.H[0, 0]), "mle": mle_g,
                      "sigma_F": sig_g, "steps": steps, "fit_J_H_s": t_g,
                      "quad_launches": quad, "fused_launches": fused_grf}}


# phase 14: the hard wall-time limit of the spawned ranks (killed when it
# passes), and the process groups' own timeout for one collective
MESH_SPAWN_TIMEOUT_S, MESH_COLLECTIVE_TIMEOUT_S = 420, 120


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def northstar_on(mesh, dev):
    """The slice 2 pipeline of phase 7 through the entry points with
    ``mesh=``: ``grf_spectral_problem(mesh=)``, the hoisted fit, the reused
    J and the implicit H. Returns θ̂, σ, J, H, the walls, the peak memory,
    the mesh's collectives and bytes and the kernels' counts."""
    import numpy as np
    import torch

    import muse_tpu_torch
    from muse_tpu_torch.models import grf_spectral_problem
    from muse_tpu_torch.ops import grf_spectrum as gs
    from muse_tpu_torch.ops.cg import batched_cg
    from muse_tpu_torch.solver import CompiledProblem
    from muse_tpu_torch.theta import ThetaSpec

    prob = grf_spectral_problem(n=1024, sigma_noise=0.01, solver="cg",
                                data_seed=42, mesh=mesh, device=dev)
    comp = CompiledProblem(prob, ThetaSpec.from_example(0.5), np.array([0.5]))
    calls = [0]
    step_white = comp.muse_step_white

    def counted(*args, **kwargs):
        calls[0] += 1
        return step_white(*args, **kwargs)

    comp.muse_step_white = counted
    mesh.collectives = mesh.collective_bytes = 0
    gs.reset_counts()
    batched_cg.curvature_steps = 0
    torch.cuda.reset_peak_memory_stats()
    res = muse_tpu_torch.MuseResult()
    _, t_fit = timed(lambda: muse_tpu_torch.muse_fit(
        res, prob, 0.5, nsims=NSIMS2, max_batch=MAX_BATCH2, theta_rtol=1e-5,
        alpha=1.0, Hinv_update="sims", compiled=comp, seed=1, mesh=mesh))
    fit_collectives = mesh.collectives
    _, t_j = timed(lambda: muse_tpu_torch.get_J(
        res, prob, nsims=NSIMS2, max_batch=MAX_BATCH2, compiled=comp,
        warn_reuse=False, mesh=mesh))
    _, t_h = timed(lambda: muse_tpu_torch.get_H(
        res, prob, nsims=H_NSIMS2, implicit_diff=True,
        implicit_diff_precond=prob.suggested_h_precond, max_batch=MAX_BATCH2,
        compiled=comp, mesh=mesh))
    return {"theta": float(res.theta[0]), "sigma": float(res.sigma[0]),
            "J": float(res.J[0, 0]), "H": float(res.H[0, 0]),
            "steps": len(res.history), "fit_s": t_fit, "J_s": t_j,
            "H_s": t_h,
            "peak_GiB": torch.cuda.max_memory_allocated() / 2 ** 30,
            "collectives": mesh.collectives,
            "fit_collectives": fit_collectives,
            "bytes": mesh.collective_bytes,
            **quad_counts(),
            "fused_launches": gs.spectrum_quadform_and_grad_cuda.launches,
            "cg_steps": batched_cg.curvature_steps,
            "muse_step_white_calls": calls[0]}


def bandpower_on(mesh, dev):
    """Phase 13's bandpower pipeline with ``mesh=``, and the band reduction
    of 101 lanes of score terms over the field axis (against a float64 sum
    of the whole, and rerun)."""
    import numpy as np
    import torch

    import muse_tpu_torch
    from muse_tpu_torch.models import bandpower_problem
    from muse_tpu_torch.models.bandpower import _k_grid64, band_edges
    from muse_tpu_torch.ops import grf_spectrum as gs
    from muse_tpu_torch.ops.cg import batched_cg

    n, nb = N4, NBANDS4
    pb = bandpower_problem(n=n, nbands=nb, sigma_noise=0.01, data_seed=42,
                           device=dev, mesh=mesh)
    B = NSIMS4_GRF + 1
    band = torch.tensor(np.tile(np.searchsorted(
        band_edges(n, nb), _k_grid64(n), side="right").reshape(-1), 2),
        device=dev)
    g = torch.Generator(device=dev).manual_seed(13)
    q = torch.randn((B, band.numel()), generator=g, device=dev) ** 2
    want = torch.stack([(q.double() * (band == b)).sum(-1)
                        for b in range(nb)], -1)
    mine = q[:, pb.field_slice].contiguous()

    def reduce():
        return mesh.reduce_field(torch.func.vmap(pb.band_sum)(mine))

    got, again = reduce(), reduce()
    rel = ((got.double() - want).abs() / want).max().item()
    bitwise = bool(torch.equal(got, again))
    del q, want, mine, got, again

    mesh.collectives = mesh.collective_bytes = 0
    gs.reset_counts()
    batched_cg.curvature_steps = 0
    torch.cuda.reset_peak_memory_stats()
    res = muse_tpu_torch.MuseResult()
    _, t_fit = timed(lambda: muse_tpu_torch.muse_fit(
        res, pb, np.zeros(nb), nsims=NSIMS4_GRF, theta_rtol=1e-5, alpha=1.0,
        seed=1, mesh=mesh))
    _, t_j = timed(lambda: muse_tpu_torch.get_J(
        res, pb, nsims=NSIMS4_GRF, warn_reuse=False, mesh=mesh))
    _, t_h = timed(lambda: muse_tpu_torch.get_H(
        res, pb, nsims=NSIMS4_GRF // 10, implicit_diff=True,
        implicit_diff_precond=pb.suggested_h_precond,
        max_batch=H_CHUNK4_BAND, mesh=mesh))
    return {"theta": np.asarray(res.theta).tolist(),
            "steps": len(res.history), "fit_s": t_fit, "J_s": t_j,
            "H_s": t_h, "reduction_rel": rel, "reduction_bitwise": bitwise,
            "failed": bool(any(h["map_failed"].any() for h in res.history)),
            "peak_GiB": torch.cuda.max_memory_allocated() / 2 ** 30,
            "collectives": mesh.collectives, "bytes": mesh.collective_bytes,
            "fused_launches": gs.spectrum_quadform_and_grad_cuda.launches,
            "cg_steps": batched_cg.curvature_steps}


def collective_ms(fn, reps=50):
    """Median host milliseconds of ``fn()`` (a collective and its copies),
    the card drained before and after each call."""
    return statistics.median(timed(fn)[1] for _ in range(reps)) * 1e3


def _mesh_rank(rank, port, out_dir):
    """One of the MESH_RANKS spawned ranks of phase 14: both on the one
    card over gloo. Runs 14b (sims=2, cold then warm), 14c and 14d
    (sims=1 × field=2) and writes what it measured to ``rank<r>.json``."""
    os.environ["LOCAL_RANK"] = "0"          # the one card, for every rank
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    from muse_tpu_torch.ops import grf_spectrum as gs
    from muse_tpu_torch.parallel import make_sims_mesh

    record_kernel_shapes()
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=MESH_RANKS,
        timeout=datetime.timedelta(seconds=MESH_COLLECTIVE_TIMEOUT_S))
    try:
        sims = make_sims_mesh(sims=MESH_RANKS)
        dev = sims.device
        out = {"14b_cold": northstar_on(sims, dev),
               "14b": northstar_on(sims, dev)}
        field = make_sims_mesh(sims=1, field=MESH_RANKS)
        out["14c"] = northstar_on(field, dev)
        out["14d"] = bandpower_on(field, dev)
        # what one collective of the sharded step costs here: the field
        # sum of a chunk's (128,) per-lane partial sums, and the sims
        # gather of the fit's (513, 5) float64 per-lane table
        part = torch.ones(MAX_BATCH2, device=dev)
        lo, hi = sims.lane_block(NSIMS2 + 1)
        table = np.zeros((hi - lo, 5))
        out["ms"] = {
            "field all_reduce (128,) float32": collective_ms(
                lambda: field.reduce_field(part)),
            "sims gather (513, 5) float64": collective_ms(
                lambda: sims.gather_sims(table, lo, NSIMS2 + 1)),
            "broadcast (4,) float64": collective_ms(
                lambda: sims.broadcast_host(np.zeros(4)))}
        out["shapes"] = {name: sorted(shapes)
                         for name, shapes in kernel_shapes().items()}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _nccl_rank(rank, port, out_dir):
    """Two ranks on the one card over NCCL: one all_reduce, and what came
    of it (NCCL is expected to refuse two ranks on one device)."""
    os.environ["LOCAL_RANK"] = "0"
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=MESH_RANKS, timeout=datetime.timedelta(seconds=60))
    try:
        t = torch.ones(4, device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        outcome = f"all_reduce ran: {t.tolist()}"
    except Exception as e:        # the refusal is the reading
        outcome = f"refused: {type(e).__name__}: " + " | ".join(
            line for line in str(e).splitlines() if line.strip())[:300]
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"nccl{rank}.json"), "w") as f:
        json.dump(outcome, f)


def spawn_ranks(fn, out_dir, timeout):
    """``fn(rank, port, out_dir)`` in MESH_RANKS processes started with the
    ``spawn`` method; kills them all and fails when ``timeout`` seconds
    pass, and fails when one of them fails."""
    import torch.multiprocessing as tmp
    ctx = tmp.start_processes(fn, args=(_free_port(), out_dir),
                              nprocs=MESH_RANKS, join=False,
                              start_method="spawn")
    deadline = time.perf_counter() + timeout
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.perf_counter())):
            if time.perf_counter() >= deadline:
                raise AssertionError(f"{fn.__name__}: the ranks ran past "
                                     f"{timeout} s; killed")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()


def phase14(card, dev, ref7, walls7, mle2, sig_F2, band13, held, comp2,
            prob2):
    """The mesh on the one card. 14a: world size 1 over NCCL in this
    process; 14b-14d: two spawned ranks sharing the card over gloo; 14e:
    ``profile_dir``; then NCCL with two ranks on the card, expected to be
    refused. Returns the kernels' launch counts on the mesh paths."""
    import datetime
    import glob
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    import muse_tpu_torch
    from muse_tpu_torch.parallel import make_sims_mesh

    torch.cuda.empty_cache()       # leave the card to the ranks
    walls_note = (f"one process (phase 7, warm): fit {walls7['fit_s']:.3f} s, "
                  f"J {walls7['J_s']:.4f} s, H {walls7['H_s']:.3f} s")

    def report(label, r):
        phase(f"phase 14{label} [{card}]: θ̂ {r['theta']:.9f} σ "
              f"{r['sigma']:.9f} J {r['J']:.6f} H {r['H']:.6f}, steps "
              f"{r['steps']}; walls fit {r['fit_s']:.3f} s, J {r['J_s']:.4f}"
              f" s, H {r['H_s']:.3f} s; peak {r['peak_GiB']:.2f} GiB; "
              f"collectives {r['collectives']} ({r['fit_collectives']} in "
              f"the fit), {r['bytes']} bytes; quadform launches "
              f"{r['quad_launches']} = evaluations {r['quad_evaluations']} "
              f"= muse_step_white calls {r['muse_step_white_calls']}; fused "
              f"launches {r['fused_launches']} = CG steps {r['cg_steps']}")

    # 14a: world size 1 over NCCL, the mesh code path at full width
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
        world_size=1,
        timeout=datetime.timedelta(seconds=MESH_COLLECTIVE_TIMEOUT_S))
    try:
        mesh = make_sims_mesh()
        a = northstar_on(mesh, dev)
        x = torch.ones(MAX_BATCH2, device=dev)
        nccl_ms = collective_ms(lambda: dist.all_reduce(x))
    finally:
        dist.destroy_process_group()
    report("a world 1 over NCCL", a)
    ref = {"theta": float(ref7.theta[0]), "sigma": float(ref7.sigma[0]),
           "J": float(ref7.J[0, 0]), "H": float(ref7.H[0, 0])}
    same = {k: a[k] == v for k, v in ref.items()}
    phase(f"phase 14a [{card}] bitwise equal to phase 7's warm run: {same}; "
          f"{walls_note}; NCCL all_reduce of (128,) float32 at world 1: "
          f"{nccl_ms:.4f} ms")
    if not all(same.values()):
        raise AssertionError(f"14a differs from phase 7: {a} vs {ref}")

    # why a sims axis can move σ in its last bits: implicit H's per-sim
    # values at 14b's widths (26 and 25 sims) against one chunk of 51, and
    # the contraction behind H2 (an einsum over z) at those widths
    Hs = [np.asarray(muse_tpu_torch.get_H(
        muse_tpu_torch.MuseResult(), prob2, ref7.theta, seed=1,
        nsims=H_NSIMS2, implicit_diff=True, max_batch=mb,
        implicit_diff_precond=prob2.suggested_h_precond,
        compiled=comp2).Hs) for mb in (None, MESH_H_LANES2[-1])]
    g = torch.Generator(device=dev).manual_seed(41)
    dF = torch.randn((H_NSIMS2, 2 * 1024 * 513, 1), generator=g, device=dev)
    Y = torch.randn((H_NSIMS2, 1, 2 * 1024 * 513), generator=g, device=dev)
    k = MESH_H_LANES2[-1]
    whole = torch.einsum("szi,sjz->sij", dF, Y)[:k]
    part = torch.einsum("szi,sjz->sij", dF[:k], Y[:k])
    phase(f"phase 14 [{card}] implicit H per sim in chunks of {k} vs one "
          f"of {H_NSIMS2}: bitwise equal {np.array_equal(*Hs)}, max "
          f"relative difference {np.max(np.abs(Hs[1] - Hs[0]) / np.abs(Hs[0])):.3e}; "
          f"einsum('szi,sjz->sij') over 1024² at {k} vs {H_NSIMS2} sims: "
          f"bitwise equal {bool(torch.equal(whole, part))}")
    del dF, Y, whole, part

    # the kernels at the shapes a mesh gives them: a field rank's rows of
    # a 128-lane chunk, a sims rank's half chunk (CUDA events; plain
    # versions, the one-call library route and the bounds beside them)
    from muse_tpu_torch.ops import grf_spectrum as gs
    g = torch.Generator(device=dev).manual_seed(14)
    for B, rows in ((MAX_BATCH2, MESH_ROWS), (MESH_LANES2[-1], 1024)):
        z = torch.randn((B, rows, 1026), generator=g, device=dev)
        w = torch.rand((rows, 1026), generator=g, device=dev) + 0.5
        L = rows * 1026
        # the θ-scores' K = 1 launch
        q = [cuda_ms(lambda: gs.spectrum_quadforms_cuda(z, w[None])),
             cuda_ms(lambda: gs.spectrum_quadform_plain(z, w)),
             cuda_ms(lambda: torch.einsum("bnm,bnm,nm->b", z, z, w)),
             *least_ms((B * L + L + B) * 4, 3 * B * L)]
        f = [cuda_ms(lambda: gs.spectrum_quadform_and_grad_cuda(z, w)),
             cuda_ms(lambda: gs.spectrum_quadform_and_grad_plain(z, w)),
             *least_ms((2 * B * L + L + B) * 4, 3 * B * L)]
        phase(f"phase 14 [{card}] kernels at ({B}, {rows}, 1026): "
              f"spectrum_quadform {q[0]:.4f} ms (plain {q[1]:.4f}, library "
              f"einsum {q[2]:.4f}, bound {q[3]:.4f} by {q[4]}); "
              f"spectrum_quadform_and_grad {f[0]:.4f} ms (plain {f[1]:.4f}, "
              f"bound {f[2]:.4f} by {f[3]})")
        del z, w

    # 14b-14d: two ranks on the card over gloo
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    _, t_spawn = timed(lambda: spawn_ranks(_mesh_rank, out_dir,
                                           MESH_SPAWN_TIMEOUT_S))
    ranks = []
    for r in range(MESH_RANKS):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    phase(f"phase 14 [{card}] {MESH_RANKS} ranks over gloo on the one card: "
          f"{t_spawn:.1f} s from spawn to exit")
    target = max(1e-3, 2.0 * sig_F2 / np.sqrt(NSIMS2))
    for r, out in enumerate(ranks):
        report(f"b rank {r} sims=2 (cold)", out["14b_cold"])
        report(f"b rank {r} sims=2", out["14b"])
        report(f"c rank {r} sims=1 × field=2", out["14c"])
        d = out["14d"]
        phase(f"phase 14d rank {r} [{card}] bandpower field=2: θ̂ "
              f"{np.round(d['theta'], 6).tolist()}; steps {d['steps']}; "
              f"walls fit {d['fit_s']:.3f} s, J {d['J_s']:.4f} s, H "
              f"{d['H_s']:.3f} s (one process, phase 13: fit "
              f"{band13['band_fit_s']:.3f} s, J {band13['band_J_s']:.4f} s, "
              f"H {band13['band_H_s']:.3f} s); peak {d['peak_GiB']:.2f} GiB; "
              f"collectives {d['collectives']}, {d['bytes']} bytes; fused "
              f"launches {d['fused_launches']} = CG steps {d['cg_steps']}; "
              f"band reduction over the field axis: max relative error vs "
              f"float64 {d['reduction_rel']:.3e}, rerun bitwise equal "
              f"{d['reduction_bitwise']}")
        phase(f"phase 14 rank {r} [{card}] one collective, median ms: "
              f"{out['ms']}; {walls_note}")
    for r, out in enumerate(ranks):
        b, c, d = out["14b"], out["14c"], out["14d"]
        for label, run in (("14b", b), ("14b cold", out["14b_cold"])):
            rel = abs(run["theta"] - ref["theta"]) / abs(ref["theta"])
            rel_s = abs(run["sigma"] - ref["sigma"]) / ref["sigma"]
            phase(f"phase {label} rank {r}: θ̂ and σ against phase 7: "
                  f"relative {rel:.3e} and {rel_s:.3e}, bitwise equal "
                  f"{run['theta'] == ref['theta'] and run['sigma'] == ref['sigma']}")
            if not (rel <= 1e-6 and rel_s <= 1e-6):
                raise AssertionError(f"{label} rank {r} off phase 7")
        gap = abs(c["theta"] - mle2)
        phase(f"phase 14c rank {r}: |θ̂ − θ̂ phase 7| "
              f"{abs(c['theta'] - ref['theta']):.3e} (<= 1e-4 + 1e-4·|θ̂|), "
              f"|θ̂−MLE| {gap:.6f} (< {target:.6f}), σ/σ_F "
              f"{c['sigma'] / sig_F2:.4f}")
        if not abs(c["theta"] - ref["theta"]) <= 1e-4 + 1e-4 * abs(
                ref["theta"]):
            raise AssertionError(f"14c rank {r} θ̂ off phase 7")
        if not (gap < target and 0.9 < c["sigma"] / sig_F2 < 1.1):
            raise AssertionError(f"14c rank {r} misses the north-star gates")
        for run in (b, c):
            if not (run["muse_step_white_calls"] > 0 and run["quad_launches"]
                    == run["quad_evaluations"]
                    == run["muse_step_white_calls"]
                    and run["quad1_launches"] == 0):
                raise AssertionError(f"rank {r}: quadform launches do not "
                                     f"match the θ-score evaluations: {run}")
            if not run["fused_launches"] == run["cg_steps"] > 0:
                raise AssertionError(f"rank {r}: fused launches do not "
                                     f"match the CG steps: {run}")
        # JAX's tolerance for a field axis (tests/test_mesh.py:216): a
        # relative bound alone fails a band whose θ̂ sits near 0
        ref_b = band13["band_theta"]
        diff_b = np.abs(np.asarray(d["theta"]) - ref_b)
        phase(f"phase 14d rank {r}: max |θ̂_b − θ̂_b phase 13| "
              f"{diff_b.max():.3e}, max relative "
              f"{(diff_b / np.abs(ref_b)).max():.3e} (each <= 1e-4 + "
              f"1e-4·|θ̂_b|)")
        if not (diff_b <= 1e-4 + 1e-4 * np.abs(ref_b)).all():
            raise AssertionError(f"14d rank {r} θ̂ off phase 13")
        if not (d["reduction_bitwise"] and d["reduction_rel"] <= 1e-5):
            raise AssertionError("the sharded band reduction is off or not "
                                 "reproducible")
        if d["failed"] or not d["fused_launches"] == d["cg_steps"] > 0:
            raise AssertionError(f"14d rank {r}: {d}")
        for name, shapes in out["shapes"].items():
            missed = sorted({tuple(x) for x in shapes} - held[name])
            phase(f"phase 14 rank {r} {name}: launched at "
                  f"{sorted(tuple(x) for x in shapes)}; not held against "
                  f"the plain version: {missed}")
            if missed:
                raise AssertionError(f"{name} ran at shapes no phase held: "
                                     f"{missed}")
    for name in ("14b", "14c"):
        if ranks[0][name]["theta"] != ranks[1][name]["theta"]:
            raise AssertionError(f"{name}: the ranks ended apart")

    # 14e: profile_dir on the warm north-star fit
    with tempfile.TemporaryDirectory() as tmp:
        res = muse_tpu_torch.MuseResult()
        _, t_prof = timed(lambda: muse_tpu_torch.muse_fit(
            res, prob2, 0.5, nsims=NSIMS2, max_batch=MAX_BATCH2,
            theta_rtol=1e-5, alpha=1.0, Hinv_update="sims", compiled=comp2,
            seed=1, profile_dir=tmp))
        traces = glob.glob(os.path.join(tmp, "*.pt.trace.json"))
        text = open(traces[0]).read() if len(traces) == 1 else ""
        kernels = {k: text.count(k) for k in
                   ("quad_partial_kernel", "quadgrad_partial_kernel")}
        phase(f"phase 14e [{card}] muse_fit(profile_dir=...): "
              f"{[os.path.basename(t) for t in traces]}, "
              f"{len(text.encode())} bytes, events of the step's kernels "
              f"{kernels}, 'muse_step' spans {text.count('muse_step')}; "
              f"the fit under the profiler {t_prof:.3f} s ({walls_note})")
        if not (text and all(kernels.values())):
            raise AssertionError("profile_dir wrote no trace of the step's "
                                 "kernels")

    # NCCL with two ranks on one card: the reading, not a gate
    spawn_ranks(_nccl_rank, out_dir, 120)
    for r in range(MESH_RANKS):
        with open(os.path.join(out_dir, f"nccl{r}.json")) as f:
            phase(f"phase 14 [{card}] NCCL, {MESH_RANKS} ranks on one card, "
                  f"rank {r}: {json.load(f)}")
    return {"a": a, "b": ranks[0]["14b"], "c": ranks[0]["14c"],
            "d": ranks[0]["14d"]}


# ------------------------------------------------------------------ #
# phase 15: the field axis for every problem (slice 6)
# ------------------------------------------------------------------ #

# two ranks share the card over gloo on sims=1 × field=2: the pixel GRF of
# phase 13 (the sharded-sum route, 100 sims: 512 of the 1024 pixel rows a
# rank, its PCG on the same rows of the packed grid), phase 10's user
# models and phase 12's 256² lensing case (the gathered route). The hard
# limit on the spawned ranks' wall time
FIELD15_SPAWN_TIMEOUT_S = 600
PIXEL_ROWS15 = 1024 // MESH_RANKS
# the lane counts at which the field-axis pixel GRF launches on
# PIXEL_ROWS15 rows: its θ-scores on the fit's chunk and on the ±ε stencil
# batch; its PCG on the fit's chunk, the fiducial MAPs and the stencil batch
QUAD_SLICED_PIXEL = (NSIMS4_GRF + 1, H_LANES4_PIXEL[1])
FUSED_SLICED_PIXEL = (NSIMS4_GRF + 1, *H_LANES4_PIXEL)


def _rank_counts(mesh):
    """The kernels' and the mesh's counters, as a dict."""
    from muse_tpu_torch.ops import grf_spectrum as gs
    from muse_tpu_torch.ops.cg import batched_cg
    return {**quad_counts(),
            "fused_launches": gs.spectrum_quadform_and_grad_cuda.launches,
            "cg_steps": batched_cg.curvature_steps,
            "collectives": mesh.collectives,
            "collective_bytes": mesh.collective_bytes,
            "gathers": mesh.gathers, "gather_bytes": mesh.gather_bytes,
            "max_reduces": mesh.max_reduces}


def _reset_counts(mesh):
    """Zero the counters of :func:`_rank_counts` and the peak memory."""
    import torch

    from muse_tpu_torch.ops import grf_spectrum as gs
    from muse_tpu_torch.ops.cg import batched_cg
    gs.reset_counts()
    batched_cg.curvature_steps = 0
    mesh.reset_counts()
    torch.cuda.reset_peak_memory_stats()


def pixel15_on(mesh, dev, x_obs):
    """Phase 13's pixel GRF pipeline, ``muse(grf_problem(n=1024,
    sigma_noise=0.01, solver="cg"), 0.5, nsims=100, theta_rtol=1e-5,
    maxsteps=20, get_covariance=True)`` on phase 4's field, as its three
    calls (the fit, get_J reusing the fit's scores, the FD get_H of 10
    sims), with the problem built with ``mesh=``."""
    import numpy as np
    import torch

    import muse_tpu_torch
    from muse_tpu_torch.models import grf_problem

    pg = grf_problem(n=N4, sigma_noise=0.01, solver="cg", x_obs=x_obs,
                     device=dev, mesh=mesh)
    kw = dict(nsims=NSIMS4_GRF, mesh=mesh)
    _reset_counts(mesh)
    res = muse_tpu_torch.MuseResult()
    _, t_fit = timed(lambda: muse_tpu_torch.muse_fit(
        res, pg, 0.5, theta_rtol=1e-5, maxsteps=20, **kw))
    fit_counts = _rank_counts(mesh)
    _, t_j = timed(lambda: muse_tpu_torch.get_J(res, pg, warn_reuse=False,
                                                **kw))
    _, t_h = timed(lambda: muse_tpu_torch.get_H(
        res, pg, nsims=max(1, NSIMS4_GRF // 10), mesh=mesh))
    return {"theta": float(res.theta[0]), "sigma": float(res.sigma[0]),
            "J": float(res.J[0, 0]), "H": float(res.H[0, 0]),
            "steps": len(res.history), "fit_s": t_fit, "J_s": t_j,
            "H_s": t_h,
            "failed": bool(any(h["map_failed"].any() for h in res.history)),
            "peak_GiB": torch.cuda.max_memory_allocated() / 2 ** 30,
            "fit_counts": fit_counts, **_rank_counts(mesh),
            "step_s": [h["t"] for h in res.history],
            "finite": bool(np.isfinite(res.theta).all()
                           and np.isfinite(res.sigma).all())}


def users15_on(mesh, dev):
    """Phase 10's user models with ``mesh=``: each ``muse(..., nsims=200,
    theta_rtol=1e-3, grad_z_atol=1e-3, get_covariance=True, seed=1)``."""
    import numpy as np
    import torch

    import muse_tpu_torch
    from muse_tpu_torch import distributions as dist
    from muse_tpu_torch import ppl
    from muse_tpu_torch.models import funnel_problem, vector_funnel_problem

    D = 512
    kw = dict(nsims=200, theta_rtol=1e-3, grad_z_atol=1e-3,
              get_covariance=True, seed=1, mesh=mesh)
    pf = funnel_problem(D, device=dev)
    x = pf.x

    def funnel():
        theta = ppl.sample("theta", dist.Normal(0.0, 3.0))
        z = ppl.sample("z", dist.Normal(0.0, torch.exp(theta / 2))
                       .expand((D,)))
        ppl.sample("x", dist.Normal(z, 1.0))

    def scale_model():
        s = ppl.sample("s", dist.LogNormal(0.0, 1.0))
        z = ppl.sample("z", dist.Normal(0.0, s).expand((D,)))
        ppl.sample("x", dist.Normal(z, 1.0))

    pv = vector_funnel_problem(256, 4, device=dev)
    runs = (("funnel", lambda: muse_tpu_torch.muse(pf, 1.0, **kw)),
            ("vector_funnel", lambda: muse_tpu_torch.muse(
                pv, np.zeros(4), **kw)),
            ("ppl_funnel", lambda: muse_tpu_torch.muse(
                funnel, {"theta": 1.0}, observed={"x": x}, **kw)),
            ("ppl_scale", lambda: muse_tpu_torch.muse(
                scale_model, {"s": 1.0}, observed={"x": x}, **kw)))
    out = {}
    for name, run in runs:
        _reset_counts(mesh)
        r, t = timed(run)
        out[name] = {
            "theta": np.asarray(r.theta).tolist(),
            "sigma": np.asarray(r.sigma).tolist(), "s": t,
            "steps": len(r.history),
            "failed": bool(any(h["map_failed"].any() for h in r.history)),
            "peak_GiB": torch.cuda.max_memory_allocated() / 2 ** 30,
            **_rank_counts(mesh)}
    return out


def lensing15_on(mesh, dev):
    """Phase 12's 256² case with ``mesh=``: VarPro MAPs to 1e-3, 16 sims,
    the demo's Broyden fit with the ±0.3 clamp, from ``suggested_z0``."""
    import torch

    import muse_tpu_torch
    from muse_tpu_torch.models import lensing_problem

    x_small = lensing_problem(n=N4_SMALL, theta_true=THETA_TRUE4,
                              data_seed=DATA_SEED4, device=dev).x
    p = lensing_problem(n=N4_SMALL, solver="varpro", x_obs=x_small,
                        device=dev)
    _reset_counts(mesh)
    c0 = lensing_counts()
    r = muse_tpu_torch.MuseResult()
    _, t = timed(lambda: muse_tpu_torch.muse_fit(
        r, p, 0.0, nsims=NSIMS4_SMALL, z0=p.suggested_z0,
        regularize=clamp_steps([0.0]), seed=1, mesh=mesh,
        **dict(LENS_FIT4, grad_z_atol=ATOL4_SMALL)))
    c1 = lensing_counts()
    return {"theta": float(r.theta[0]), "s": t, "steps": len(r.history),
            "unconverged_by_step": [int((~h["map_converged"]).sum())
                                    for h in r.history],
            "failed_by_step": [int(h["map_failed"].sum())
                               for h in r.history],
            "polish_entries": c1["polish"] - c0["polish"],
            "solver_counts": {k: c1[k] - c0[k] for k in c1},
            "peak_GiB": torch.cuda.max_memory_allocated() / 2 ** 30,
            **_rank_counts(mesh)}


def _field_rank(rank, port, out_dir):
    """One of the two spawned ranks of phase 15 (sims=1 × field=2 over gloo
    on the one card): times one gather at 15c's shape, runs 15c, 15d and
    15e and writes what it measured to ``field<r>.json``."""
    os.environ["LOCAL_RANK"] = "0"
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    from muse_tpu_torch.ops import grf_spectrum as gs
    from muse_tpu_torch.parallel import make_sims_mesh

    record_kernel_shapes()
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=MESH_RANKS,
        timeout=datetime.timedelta(seconds=MESH_COLLECTIVE_TIMEOUT_S))
    try:
        mesh = make_sims_mesh(sims=1, field=MESH_RANKS)
        dev = mesh.device
        # one gather of 15c's fit chunk: every lane's 1024² latent from
        # this rank's 512 rows (the solve's entry; its exit is as large)
        B, size = NSIMS4_GRF + 1, N4 * N4
        cols = slice(mesh.field_rows(N4).start * N4,
                     mesh.field_rows(N4).stop * N4)
        local = torch.ones((B, cols.stop - cols.start), device=dev)
        gather_ms = [collective_ms(lambda: mesh.gather_field(local, cols,
                                                             size), reps=5)]
        del local
        x_obs = np.load(os.path.join(out_dir, "field4.npy"))
        out = {"gather_ms": gather_ms,
               "gather_shape": [B, cols.stop - cols.start, size],
               "15c": pixel15_on(mesh, dev, x_obs)}
        out["15d"] = users15_on(mesh, dev)
        out["15e"] = lensing15_on(mesh, dev)
        out["shapes"] = {name: sorted(shapes)
                         for name, shapes in kernel_shapes().items()}
        with open(os.path.join(out_dir, f"field{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def phase15a(card, prob2, comp2, theta2):
    """The batch-width determinism of the CG's sums (ROADMAP, the fused
    PCG-step item): the same 51 sims of phase 7's implicit H through
    ``batched_cg`` at 51 lanes and at 26 (the first chunk of
    ``max_batch=26``): each step's per-lane rz, pᵀAp and ‖r‖² (as the
    ``reduce`` hook sees them) compared bit by bit, and the CG's inputs —
    the right-hand sides, one operator application, one preconditioner
    application and ``torch.sum`` of the same rows — at both widths."""
    import numpy as np
    import torch

    import muse_tpu_torch
    import muse_tpu_torch.solver.compiled as compiled_mod

    plain_cg = compiled_mod.batched_cg
    captured = []

    def capture(matvec, b, **kw):
        captured.append((matvec, b, kw))
        return plain_cg(matvec, b, **kw)

    compiled_mod.batched_cg = capture
    try:
        for mb in (None, MESH_H_LANES2[-1]):
            muse_tpu_torch.get_H(
                muse_tpu_torch.MuseResult(), prob2, theta2, seed=1,
                nsims=H_NSIMS2, implicit_diff=True, max_batch=mb,
                implicit_diff_precond=prob2.suggested_h_precond,
                compiled=comp2)
    finally:
        compiled_mod.batched_cg = plain_cg
    (mv_w, b_w, kw_w), (mv_n, b_n, kw_n) = captured[0], captured[1]
    k = b_n.shape[0]

    def sums(mv, b, kw):
        seen = []

        def record(t):
            seen.append(t.clone())
            return t
        plain_cg(mv, b, **dict(kw, reduce=record))
        return seen

    wide, narrow = sums(mv_w, b_w, kw_w), sums(mv_n, b_n, kw_n)
    # the records: ‖b‖², (rz, ‖r‖²) at the start, then per step pᵀAp and
    # (rz, ‖r‖²). Each difference is taken relative to the lane's first
    # value of the same sum (a converged residual's sums are rounding
    # noise, so relative to themselves they say nothing)
    names = ["‖b‖²", "(rz, ‖r‖²) start"] + [
        f"{'pᵀAp' if i % 2 == 0 else '(rz, ‖r‖²)'} step {i // 2 + 1}"
        for i in range(max(len(wide), len(narrow)) - 2)]
    first, worst = None, 0.0
    for i, (w, n) in enumerate(zip(wide, narrow)):
        w = w[..., :k]
        scale = narrow[i if i < 3 else 1 if i % 2 else 2].double().abs()
        if first is None and not torch.equal(w, n):
            first = names[i]
        worst = max(worst, ((w.double() - n.double()).abs()
                            / scale.clamp(min=1e-30)).max().item())
    P = b_w[:k]
    probes = {
        "right-hand sides": (b_w[:k], b_n),
        "operator (HVP) on the same vectors": (mv_w(b_w)[:k], mv_n(b_n)),
        "preconditioner": (kw_w["precond"](b_w)[:k], kw_n["precond"](b_n)),
        "torch.sum of the same rows": (torch.sum(b_w * b_w, -1)[:k],
                                       torch.sum(P * P, -1)),
        "vector_norm of the same rows": (
            torch.linalg.vector_norm(b_w, dim=-1)[:k],
            torch.linalg.vector_norm(P, dim=-1))}
    equal = {name: bool(torch.equal(a, b)) for name, (a, b) in probes.items()}
    cause = next((name for name, same in equal.items() if not same), None)
    phase(f"phase 15a [{card}] implicit H's CG across batch widths: 51 sims "
          f"at {b_w.shape[0]} lanes vs {k}: {len(wide)} and {len(narrow)} "
          f"reductions; first step whose per-lane sums differ: "
          f"{first or 'none (bitwise equal)'}; max difference relative to "
          f"the lane's first value of each sum {worst:.3e} (<= 1e-6, the "
          f"tolerance stated); bitwise equal at both widths: "
          f"{equal}; named cause: {cause or 'not reproduced at these inputs'}")
    if not worst <= 1e-6:
        raise AssertionError(f"the CG's per-lane sums move by {worst} "
                             "between batch widths")
    del captured, mv_w, mv_n, b_w, b_n, P, probes
    return {"first_difference": first, "max_rel": worst, "equal": equal,
            "cause": cause}


def phase15b(card, dev, prob4):
    """``grf_field_problem(use_pallas=)`` both ways on phase 4's field: the
    batched log-likelihood and θ-score of 101 lanes drawn by the problem's
    sampler at θ = 0.5, against float64, and the kernel's launches."""
    import torch
    from torch.func import grad, vmap

    from muse_tpu_torch.models import grf_field_problem
    from muse_tpu_torch.ops import grf_spectrum as gs
    from muse_tpu_torch.utils.keys import lane_generator

    B, th = NSIMS4_GRF + 1, 0.5
    cfg = prob4.grf_config
    n, s2 = cfg.n, cfg.sigma_noise ** 2
    xs, zs = map(torch.stack, zip(*(prob4.sample_x_z(
        lane_generator(s, dev), th) for s in range(B))))
    tht = torch.tensor(th, device=dev)
    out = {}
    for flag in (True, False):
        p = grf_field_problem(n=n, sigma_noise=cfg.sigma_noise,
                              x_obs=prob4.x, device=dev, use_pallas=flag)
        gs.reset_counts()
        ll = vmap(lambda a, b: p.log_like(a, b, tht))(xs, zs)
        ll_launches = gs.spectrum_quadform_cuda.launches
        g = vmap(lambda a, b: grad(lambda t: p.log_like(a, b, t))(tht))(
            xs, zs)
        out[flag] = (ll, g, ll_launches,
                     gs.spectrum_quadform_cuda.launches - ll_launches)
    # float64: quad = Σ w|ẑ|²/C; log p = −½(Σ(x−z)²/σ² + quad/n² + Σ w log C);
    # ∂θ log p = ½(quad/n² − Σ w), since ∂C/∂θ = C
    C = cfg.spectrum(th).double()
    w = cfg.herm_weight.double()
    quad = gs.spectrum_quadform_plain(gs.pack_rfft2(zs.double()),
                                      gs.pack_weights(w / C)) / n ** 2
    resid = ((xs.double() - zs.double()) ** 2).sum((-2, -1)) / s2
    ll64 = -0.5 * (resid + quad + (w * torch.log(C)).sum())
    g64 = 0.5 * (quad - w.sum())
    # the error scale: each term of the sums (the score is a difference of
    # two ~n² terms that cancel to ~n)
    ll_scale, g_scale = (resid + quad).abs(), quad.abs() + w.sum()
    errs = {flag: (((ll.double() - ll64).abs() / ll_scale).max().item(),
                   ((g.double() - g64).abs() / g_scale).max().item())
            for flag, (ll, g, _, _) in out.items()}
    agree = ((out[True][1].double() - out[False][1].double()).abs()
             / g_scale).max().item()
    phase(f"phase 15b [{card}] grf_field_problem(n=1024, sigma_noise=0.01, "
          f"use_pallas=True|False), {B} lanes at θ = {th}: log-likelihood "
          f"and θ-score error vs float64, relative to their terms' "
          f"magnitude: True {errs[True][0]:.3e}, {errs[True][1]:.3e}; "
          f"False {errs[False][0]:.3e}, {errs[False][1]:.3e} (each <= "
          f"1e-5); the two scores apart by {agree:.3e}; kernel launches "
          f"for the batched log-likelihood and the batched score: True "
          f"{out[True][2]} and {out[True][3]}, False {out[False][2]} and "
          f"{out[False][3]}")
    if not all(e <= 1e-5 for pair in errs.values() for e in pair):
        raise AssertionError(f"use_pallas: off float64: {errs}")
    if not (out[True][2] == out[True][3] == 1
            and out[False][2] == out[False][3] == 0):
        raise AssertionError("use_pallas: the kernel's launches are not 1 "
                             "per batched evaluation (True) and 0 (False)")
    del xs, zs, out, quad, resid, ll64, g64


def phase15(card, dev, prob4, pixel13, users10, lensing12, held):
    """The field axis for every problem on the one card: two ranks over
    gloo, sims=1 × field=2 (15c pixel GRF, 15d user models, 15e lensing),
    and the kernels at the field-axis pixel GRF's shapes. Returns rank 0's
    15c results (its kernels' launches: slice 6's path)."""
    import tempfile

    import numpy as np
    import torch

    from muse_tpu_torch.ops import grf_spectrum as gs

    # the kernels at the field-axis pixel GRF's fit chunk (CUDA events;
    # the plain versions, the one-call library route and the bounds)
    g = torch.Generator(device=dev).manual_seed(15)
    B, rows = NSIMS4_GRF + 1, PIXEL_ROWS15
    z = torch.randn((B, rows, 1026), generator=g, device=dev)
    w = torch.rand((rows, 1026), generator=g, device=dev) + 0.5
    L = rows * 1026
    # the θ-scores' K = 1 launch
    q = [cuda_ms(lambda: gs.spectrum_quadforms_cuda(z, w[None])),
         cuda_ms(lambda: gs.spectrum_quadform_plain(z, w)),
         cuda_ms(lambda: torch.einsum("bnm,bnm,nm->b", z, z, w)),
         *least_ms((B * L + L + B) * 4, 3 * B * L)]
    f = [cuda_ms(lambda: gs.spectrum_quadform_and_grad_cuda(z, w)),
         cuda_ms(lambda: gs.spectrum_quadform_and_grad_plain(z, w)),
         *least_ms((2 * B * L + L + B) * 4, 3 * B * L)]
    phase(f"phase 15 [{card}] kernels at ({B}, {rows}, 1026): "
          f"spectrum_quadform {q[0]:.4f} ms (plain {q[1]:.4f}, library "
          f"einsum {q[2]:.4f}, bound {q[3]:.4f} by {q[4]}); "
          f"spectrum_quadform_and_grad {f[0]:.4f} ms (plain {f[1]:.4f}, "
          f"bound {f[2]:.4f} by {f[3]})")
    del z, w

    torch.cuda.empty_cache()       # leave the card to the ranks
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_field_")
    np.save(os.path.join(out_dir, "field4.npy"),
            prob4.x.detach().cpu().numpy())
    _, t_spawn = timed(lambda: spawn_ranks(_field_rank, out_dir,
                                           FIELD15_SPAWN_TIMEOUT_S))
    ranks = []
    for r in range(MESH_RANKS):
        with open(os.path.join(out_dir, f"field{r}.json")) as f:
            ranks.append(json.load(f))
    phase(f"phase 15 [{card}] {MESH_RANKS} ranks, sims=1 × field=2 over "
          f"gloo on the one card: {t_spawn:.1f} s from spawn to exit")

    def gate(ok, msg):
        if not ok:
            raise AssertionError(msg)

    ref = pixel13
    bound = 3 * ref["sigma_F"] / np.sqrt(NSIMS4_GRF) + 0.02
    for r, out in enumerate(ranks):
        c = out["15c"]
        fc = c["fit_counts"]
        phase(f"phase 15c rank {r} [{card}] grf_problem(n=1024, "
              f"sigma_noise=0.01, mesh=field 2): θ̂ {c['theta']:.9f} σ "
              f"{c['sigma']:.9f} J {c['J']:.6f} H {c['H']:.6f}, steps "
              f"{c['steps']}; walls fit {c['fit_s']:.3f} s (steps "
              f"{[round(t, 3) for t in c['step_s']]}), J {c['J_s']:.4f} s, "
              f"H {c['H_s']:.3f} s (one process, phase 13: fit + J + H "
              f"{ref['fit_J_H_s']:.3f} s); peak {c['peak_GiB']:.2f} GiB; "
              f"collectives {c['collectives']} ({fc['collectives']} in the "
              f"fit), {c['collective_bytes']} bytes, of which gathers "
              f"{c['gathers']} ({fc['gathers']} in the fit), "
              f"{c['gather_bytes']} bytes; one gather of "
              f"{out['gather_shape']} (lanes, rank's columns, whole): "
              f"{out['gather_ms'][0]:.1f} ms; quadform launches "
              f"{c['quad_launches']} = evaluations {c['quad_evaluations']}; "
              f"fused launches {c['fused_launches']} = CG steps "
              f"{c['cg_steps']}")
        d_th = abs(c["theta"] - ref["theta"])
        rel_j = abs(c["J"] - ref["J"]) / abs(ref["J"])
        rel_h = abs(c["H"] - ref["H"]) / abs(ref["H"])
        phase(f"phase 15c rank {r}: |θ̂ − θ̂ phase 13| {d_th:.3e} (<= 1e-4 "
              f"+ 1e-4·|θ̂|), J and H relative {rel_j:.3e} and {rel_h:.3e} "
              f"(<= 1e-3); |θ̂−MLE| {abs(c['theta'] - ref['mle']):.6f} "
              f"(< {bound:.6f}); σ/σ_F {c['sigma'] / ref['sigma_F']:.4f}")
        gate(c["finite"] and not c["failed"], f"15c rank {r}: {c}")
        gate(d_th <= 1e-4 + 1e-4 * abs(ref["theta"]),
             f"15c rank {r} θ̂ off phase 13")
        gate(rel_j <= 1e-3 and rel_h <= 1e-3, f"15c rank {r} J or H off")
        gate(abs(c["theta"] - ref["mle"]) < bound
             and 0.5 < c["sigma"] / ref["sigma_F"] < 2,
             f"15c rank {r} misses grf_problem's accuracy gates")
        gate(c["quad_launches"] == c["quad_evaluations"] > 0
             and c["quad1_launches"] == 0,
             f"15c rank {r}: quadform launches")
        gate(c["fused_launches"] == c["cg_steps"] > 0,
             f"15c rank {r}: fused launches")
        gate(c["gathers"] > 0 and c["max_reduces"] == 0,
             f"15c rank {r}: not the sharded-sum route")

        for name, u in out["15d"].items():
            want = users10[name]
            d = np.abs(np.asarray(u["theta"]) - want["theta"])
            rel_s = np.abs(np.asarray(u["sigma"]) - want["sigma"]) / \
                np.asarray(want["sigma"])
            phase(f"phase 15d rank {r} [{card}] {name}: θ̂ "
                  f"{np.round(u['theta'], 6).tolist()} σ "
                  f"{np.round(u['sigma'], 6).tolist()}, {u['steps']} steps, "
                  f"{u['s']:.2f} s; max |θ̂ − θ̂ phase 10| {d.max():.3e} "
                  f"(<= 1e-4 + 1e-4·|θ̂|), σ relative {rel_s.max():.3e} "
                  f"(<= 1e-3); collectives {u['collectives']}, gathers "
                  f"{u['gathers']} ({u['gather_bytes']} bytes), field maxima "
                  f"{u['max_reduces']}; peak {u['peak_GiB']:.2f} GiB")
            gate(not u["failed"], f"15d rank {r} {name}: a MAP failed")
            gate((d <= 1e-4 + 1e-4 * np.abs(want["theta"])).all(),
                 f"15d rank {r} {name}: θ̂ off phase 10")
            gate((rel_s <= 1e-3).all(), f"15d rank {r} {name}: σ off")
            gate(u["gathers"] > 0 and u["max_reduces"] > 0,
                 f"15d rank {r} {name}: not the gathered route")

        e = out["15e"]
        gap = abs(e["theta"] - lensing12["varpro"])
        phase(f"phase 15e rank {r} [{card}] lensing n={N4_SMALL} "
              f"nsims={NSIMS4_SMALL} VarPro on field=2: θ̂ {e['theta']:.5f} "
              f"(phase 12 {lensing12['varpro']:.5f}, |Δ| {gap:.5f} < 0.1) "
              f"in {e['steps']} steps, {e['s']:.2f} s; unconverged by step "
              f"{e['unconverged_by_step']}, failed by step "
              f"{e['failed_by_step']}; polish entries "
              f"{e['polish_entries']}; solver counts {e['solver_counts']}; "
              f"collectives {e['collectives']}, gathers {e['gathers']} "
              f"({e['gather_bytes']} bytes), field maxima "
              f"{e['max_reduces']}; peak {e['peak_GiB']:.2f} GiB")
        gate(e["unconverged_by_step"][-1] == 0 and
             not any(e["failed_by_step"]),
             f"15e rank {r}: a MAP did not converge")
        gate(gap < 0.1, f"15e rank {r}: θ̂ off phase 12")
        for name, shapes in out["shapes"].items():
            missed = sorted({tuple(x) for x in shapes} - held[name])
            phase(f"phase 15 rank {r} {name}: launched at "
                  f"{sorted(tuple(x) for x in shapes)}; not held against "
                  f"the plain version: {missed}")
            gate(not missed, f"{name} ran at shapes no phase held: {missed}")
    for key in ("15c", "15e"):
        gate(ranks[0][key]["theta"] == ranks[1][key]["theta"],
             f"{key}: the ranks ended apart")
    return ranks[0]["15c"]


# ------------------------------------------------------------------ #
# phase 16: θ̂ ± σ calibrated across data realizations (slice 7)
# ------------------------------------------------------------------ #

# the studies of tests/test_calibration.py's configurations and of the
# north star at full width: R16 realizations each, realization i drawing
# its data from data_seed DATA16 + i and its sims from seed SIMS16 + i.
# The seeds were fixed before the first run and are not tuned to a gate.
# The port's generators are not JAX's threefry, so these are other
# realizations of the same configurations than the JAX file's.
R16 = {"a": 20, "b": 14, "c": 10, "d": 10, "e": 10, "f": 20}
DATA16 = {"a": 1000, "b": 2000, "c": 4000, "d": 6000, "e": 3000, "f": 5000}
SIMS16 = {"a": 700, "b": 800, "c": 1100, "d": 1300, "e": 900, "f": 500}
SIZE16 = {"a": 512, "b": 1024, "c": 1024, "d": 1024, "e": 1024, "f": 1024}
# the fits' sims (the north star's are phase 7's), the implicit H's sims,
# the bandpower model's bands; the lensing MAPs are solved to 1e-3 (at
# 1024² the demo's 3e-3 ends most solves at their start, and the default
# 1e-2 would test the MAP tolerance, not the port)
NSIMS16 = {"a": 100, "b": 100, "c": 100, "d": NSIMS16_BAND, "e": 16,
           "f": NSIMS2}
H_NSIMS16 = {"b": H_NSIMS16_GRF, "c": H_NSIMS16_GRF, "d": H_NSIMS16_BAND,
             "e": 8, "f": H_NSIMS2}
ATOL16_LENS = 1e-3


def calibration_failures(zs, max_miss=4):
    """tests/test_calibration.py:30-42 with its numbers: at most
    ``max_miss`` z outside ±1.96, √R·|mean z| < 3, 0.45 < std(z) < 1.75.
    Returns what failed (empty when every gate holds)."""
    import numpy as np
    zs = np.asarray(zs)
    R = len(zs)
    out = []
    misses = int((np.abs(zs) > 1.96).sum())
    if misses > max_miss:
        out.append(f"coverage failure: {misses}/{R} realizations outside "
                   f"±1.96σ (zs={np.round(zs, 2)})")
    if not abs(zs.mean()) * np.sqrt(R) < 3.0:
        out.append(f"bias: mean z = {zs.mean():.3f} over {R} realizations "
                   f"(√R·mean = {zs.mean() * np.sqrt(R):.2f})")
    if not 0.45 < zs.std(ddof=1) < 1.75:
        out.append(f"σθ miscalibrated: std(z) = {zs.std(ddof=1):.3f}")
    return out


def realization16(key, i, dev, size, sync):
    """Realization ``i`` of study 16``key`` at ``size`` (the funnel's
    dimension, else the field's n) through the port's entry points; returns
    θ̂ − θ_true, Σ, σ, the count of failed MAPs, the pipeline's seconds
    (problem, fit, J and H; ``sync`` drains the device) and, per study,
    its oracle."""
    import numpy as np
    import torch

    import muse_tpu_torch as mt
    from muse_tpu_torch.models import (bandpower_mle, bandpower_problem,
                                       funnel_problem, grf_marginal_mle,
                                       grf_problem, grf_spectral_problem,
                                       lensing_problem)
    from muse_tpu_torch.solver import CompiledProblem
    from muse_tpu_torch.theta import ThetaSpec

    seed, data_seed = SIMS16[key] + i, DATA16[key] + i
    nsims, out = NSIMS16[key], {}
    res = mt.MuseResult()
    sync()
    t0 = time.perf_counter()
    if key == "a":
        prob = funnel_problem(size, theta_true=0.0, data_seed=data_seed,
                              device=dev)
        res = mt.muse(prob, 0.3, nsims=nsims, theta_rtol=3e-2,
                      get_covariance=True, seed=seed)
    elif key == "f":
        prob = grf_spectral_problem(n=size, sigma_noise=0.01, solver="cg",
                                    data_seed=data_seed, device=dev)
        comp = CompiledProblem(prob, ThetaSpec.from_example(0.5),
                               np.array([0.5]))
        mt.muse_fit(res, prob, 0.5, nsims=nsims, max_batch=MAX_BATCH2,
                    theta_rtol=1e-5, alpha=1.0, Hinv_update="sims",
                    compiled=comp, seed=seed)
        mt.get_J(res, prob, nsims=nsims, max_batch=MAX_BATCH2,
                 compiled=comp, warn_reuse=False)
        mt.get_H(res, prob, nsims=H_NSIMS16[key], implicit_diff=True,
                 implicit_diff_precond=prob.suggested_h_precond,
                 max_batch=MAX_BATCH2, compiled=comp)
    else:
        atol, fit, h = 1e-2, {}, {}
        if key == "b":
            prob = grf_problem(n=size, theta_true=0.0, data_seed=data_seed,
                               device=dev)
            theta0, fit["theta_rtol"] = 0.3, 3e-2
        elif key == "c":
            prob = grf_problem(n=size, sigma_noise=0.3, infer_tilt=True,
                               theta_true=torch.zeros(2, device=dev),
                               data_seed=data_seed, device=dev)
            theta0 = np.array([0.3, 0.1])
            fit.update(theta_rtol=3e-2, Hinv_update="sims")
        elif key == "d":
            prob = bandpower_problem(n=size, nbands=NBANDS16,
                                     sigma_noise=0.05, data_seed=data_seed,
                                     device=dev)
            theta0, fit["theta_rtol"] = np.zeros(NBANDS16) + 0.2, 1e-2
        else:
            prob = lensing_problem(size, theta_true=0.0,
                                   data_seed=data_seed, device=dev)
            atol = ATOL16_LENS
            theta0, h["implicit_fit_atol"] = 0.3, atol
            fit.update(theta_rtol=3e-2, Hinv_update="broyden")
        mt.muse_fit(res, prob, theta0, nsims=nsims, grad_z_atol=atol,
                    seed=seed, **fit)
        mt.get_J(res, prob, nsims=nsims, grad_z_atol=atol, seed=seed,
                 warn_reuse=False)
        mt.get_H(res, prob, nsims=H_NSIMS16[key], implicit_diff=True,
                 implicit_diff_precond=prob.suggested_h_precond, seed=seed,
                 **h)
    sync()
    out["s"] = time.perf_counter() - t0
    if key == "f":
        out["mle"], out["sig_F"] = grf_marginal_mle(prob.x_real,
                                                    prob.grf_config)
    if key == "d":
        # at 1024² this configuration's bands 2-6 hold C ≪ σ² (Fisher σ
        # 0.5-8 in log-amplitude): a band's exact MLE may run to the
        # θ → −∞ boundary, where bandpower_mle raises (muse_tpu's does
        # alike on the same data) and there is no MLE to pin θ̂ to
        try:
            out["mle"], out["Sigma_F"] = bandpower_mle(
                prob.x_real, size, NBANDS16, sigma_noise=0.05)
        except RuntimeError as e:
            if "did not converge" not in str(e):
                raise
            out["mle_error"] = str(e)
    out.update(d=np.asarray(res.theta, np.float64),
               Sigma=np.atleast_2d(np.asarray(res.Sigma, np.float64)),
               sigma=np.asarray(res.sigma, np.float64),
               steps=len(res.history),
               failed=int(sum(np.asarray(h["map_failed"]).sum()
                              for h in res.history)))
    return out


def study16(key, dev, size, card, sync):
    """Study 16``key``: its R16 realizations, their statistics and gates.
    Returns (the study's numbers, the gates that failed)."""
    import numpy as np

    R, runs, secs = R16[key], [], []
    for i in range(R):
        runs.append(realization16(key, i, dev, size, sync))
        r = runs[-1]
        secs.append(r["s"])
        phase(f"phase 16{key} {i + 1}/{R} [{card}] data_seed "
              f"{DATA16[key] + i} seed {SIMS16[key] + i}: θ̂ − θ_true "
              f"{np.round(r['d'], 5).tolist()} σ "
              f"{np.round(r['sigma'], 5).tolist()} steps {r['steps']} failed "
              f"MAPs {r['failed']} {secs[-1]:.3f} s")
    d = np.array([r["d"] for r in runs])
    S = np.array([r["Sigma"] for r in runs])
    sig = np.array([r["sigma"] for r in runs])
    out = {"R": R, "s": secs, "study_s": sum(secs)}
    fails = []
    if key in "abef":
        zs = d[:, 0] / sig[:, 0]
        max_miss = 4 if key in "af" else 3
        fails += calibration_failures(zs, max_miss)
        out.update(z=zs, misses=int((np.abs(zs) > 1.96).sum()),
                   max_miss=max_miss, mean=zs.mean(), std=zs.std(ddof=1))
        stats = (f"z {np.round(zs, 3).tolist()}; misses {out['misses']} "
                 f"(≤ {max_miss}); mean {zs.mean():+.4f} (√R·|mean| "
                 f"{abs(zs.mean()) * np.sqrt(R):.3f} < 3); std(z) "
                 f"{zs.std(ddof=1):.4f} (0.45-1.75)")
    else:
        m2 = np.array([di @ np.linalg.solve(Si, di) for di, Si in zip(d, S)])
        q95, lo, hi = {"c": (5.99, 0.4, 5.0), "d": (15.6, 3.0, 10.5)}[key]
        misses = int((m2 > q95).sum())
        if misses > 3:
            fails.append(f"{misses}/{R} m² above {q95}: {np.round(m2, 2)}")
        if not lo < m2.mean() < hi:
            fails.append(f"mean m² {m2.mean():.3f} outside ({lo}, {hi})")
        out.update(m2=m2, misses=misses, mean=m2.mean())
        stats = (f"m² {np.round(m2, 3).tolist()}; above {q95}: {misses} "
                 f"(≤ 3); mean m² {m2.mean():.4f} ({lo}-{hi})")
        if key == "c":
            cz = (d / sig).ravel()
            t = abs(cz.mean()) * np.sqrt(len(cz))
            if not t < 3.5:
                fails.append(f"component bias: √(2R)·|mean z| {t:.3f}")
            out["component_z_mean"] = cz.mean()
            stats += (f"; component z mean {cz.mean():+.4f} (√(2R)·|mean| "
                      f"{t:.3f} < 3.5), std {cz.std(ddof=1):.4f}")
        else:
            pinned = [i for i, r in enumerate(runs) if "mle" in r]
            dev_f = np.array([np.abs(runs[i]["d"] - runs[i]["mle"])
                              / np.sqrt(np.diag(runs[i]["Sigma_F"]))
                              for i in pinned]).reshape(-1, NBANDS16)
            worst = dev_f.max() if pinned else float("nan")
            if pinned and not worst < 0.8:
                fails.append(f"a band off bandpower_mle by {worst:.3f} "
                             f"Fisher σ (realization "
                             f"{pinned[int(dev_f.max(1).argmax())]})")
            out.update(mle_dev_max=worst, mle_pinned=pinned)
            stats += (f"; bandpower_mle converged on realizations {pinned} "
                      f"(the others' MLE runs to θ → −∞ in a band), there "
                      f"max |θ̂_b − MLE_b|/σ_F,b {worst:.4f} (< 0.8), "
                      f"per realization "
                      f"{np.round(dev_f.max(1), 4).tolist()}")
    if key == "e":
        failed = sum(r["failed"] for r in runs)
        if failed:
            fails.append(f"{failed} failed MAPs")
        stats += f"; failed MAPs {failed}"
    if key == "f":
        gap = np.array([abs(r["d"][0] - r["mle"]) for r in runs])
        tgt = np.array([max(1e-3, 2.0 * r["sig_F"] / np.sqrt(NSIMS2))
                        for r in runs])
        ratio = sig[:, 0] / np.array([r["sig_F"] for r in runs])
        if not (gap < tgt).all():
            fails.append(f"|θ̂ − MLE| {np.round(gap, 6)} vs "
                         f"{np.round(tgt, 6)}")
        out["mle_gap_max"] = gap.max()
        stats += (f"; max |θ̂ − MLE| {gap.max():.3e} (each below max(1e-3, "
                  f"2σ_F/√{NSIMS2}): {bool((gap < tgt).all())}), σ/σ_F "
                  f"{np.round(ratio, 4).tolist()}")
    phase(f"phase 16{key} [{card}] R {R}: {stats}; seconds per realization "
          f"{[round(s, 3) for s in secs]}, study {sum(secs):.2f} s")
    return out, fails


def phase16(card, dev):
    """θ̂ ± σ calibrated across data realizations at full width (16a-16f),
    then the three demos of muse_tpu_torch/examples (16g). Returns each
    study's numbers and kernel launches; raises after the last study if a
    gate failed."""
    import torch

    from muse_tpu_torch.examples import (lensing_demo, muse_vs_hmc,
                                         northstar_grf)
    from muse_tpu_torch.ops import grf_spectrum as gs
    from muse_tpu_torch.ops.cg import batched_cg

    def sync():
        torch.cuda.synchronize()

    titles = {
        "a": "funnel_problem(512, θ_true = 0): muse(θ₀ 0.3, nsims 100, "
             "theta_rtol 3e-2, get_covariance)",
        "b": "grf_problem(n=1024, σ_noise 1, θ_true = 0): fit θ₀ 0.3, nsims "
             "100, theta_rtol 3e-2; reused J; implicit H of 8 sims",
        "c": "grf_problem(n=1024, σ_noise 0.3, infer_tilt, θ_true = (0, 0)): "
             "fit θ₀ (0.3, 0.1), nsims 100, Hinv sims; reused J; implicit H "
             "of 8 sims",
        "d": "bandpower_problem(n=1024, 6 bands, σ_noise 0.05): fit θ₀ 0.2, "
             "nsims 48, theta_rtol 1e-2; reused J; implicit H of 6 sims",
        "e": "lensing_problem(1024, θ_true = 0), VarPro: fit θ₀ 0.3, nsims "
             "16, Broyden, theta_rtol 3e-2, MAPs to 1e-3; reused J; implicit "
             "H of 8 sims (fiducial MAPs to 1e-3)",
        "f": "grf_spectral_problem(n=1024, σ_noise 0.01, cg): phase 7's fit "
             "(512 sims, max_batch 128, alpha 1, Hinv sims, theta_rtol "
             "1e-5), reused J, implicit H of 51 sims"}
    phase(f"phase 16 [{card}] calibration across data realizations: "
          "realization i draws its data from data_seed base + i and its sims "
          "from seed base + i with the port's generators (not JAX's "
          "threefry), so these are other realizations of "
          "tests/test_calibration.py's configurations")
    studies, fails = {}, []
    for key in "abcdef":
        phase(f"phase 16{key} [{card}] {titles[key]}")
        sync()
        torch.cuda.reset_peak_memory_stats()
        held_GiB = torch.cuda.memory_allocated() / 2 ** 30
        gs.reset_counts()
        batched_cg.curvature_steps = 0
        out, f = study16(key, dev, SIZE16[key], card, sync)
        out.update(**quad_counts(),
                   fused_launches=gs.spectrum_quadform_and_grad_cuda.launches,
                   cg_steps=batched_cg.curvature_steps,
                   peak_GiB=torch.cuda.max_memory_allocated() / 2 ** 30,
                   held_GiB=held_GiB)
        # the θ-scores of the GRF studies go through the quadform, one
        # launch per batched evaluation; every PCG step of a GRF or
        # bandpower solve through the fused kernel, one launch per CG step;
        # the funnel and lensing launch neither
        quad = key in "bcf"
        fused = key in "bcdf"
        if not (out["quad_launches"] == out["quad_evaluations"]
                and (out["quad_launches"] > 0) == quad
                and out["quad1_launches"] == 0
                and (out["fused_launches"] > 0) == fused
                and (out["fused_launches"] == out["cg_steps"]
                     or not fused)):
            f.append(f"kernel launches: quadform {out['quad_launches']} for "
                     f"{out['quad_evaluations']} evaluations, fused "
                     f"{out['fused_launches']}")
        phase(f"phase 16{key} [{card}] launches: quadform "
              f"{out['quad_launches']} (= θ-score evaluations "
              f"{out['quad_evaluations']}), fused {out['fused_launches']} "
              f"(CG steps {out['cg_steps']}); peak device memory "
              f"{out['peak_GiB']:.2f} GiB, of which {out['held_GiB']:.2f} "
              f"GiB held by earlier phases")
        for msg in f:
            phase(f"phase 16{key} GATE FAILED: {msg}")
        fails += [f"16{key}: {msg}" for msg in f]
        studies[key] = out

    # 16g: the demos' main on the card. muse_vs_hmc's HMC contender is cut
    # from 2000 samples to 500 to fit the run's time; its MUSE side runs at
    # full width (512 dims, 100 sims)
    demos = {}
    for name, mod, argv in (
            ("northstar_grf", northstar_grf, []),
            ("lensing_demo", lensing_demo, ["--n", "1024", "--nsims", "64"]),
            ("muse_vs_hmc", muse_vs_hmc,
             ["--dim", "512", "--nsims", "100", "--hmc-samples", "500"])):
        phase(f"phase 16g [{card}] python -m muse_tpu_torch.examples.{name} "
              f"{' '.join(argv)}"
              + (" (HMC cut to 500 samples for time; MUSE at full width)"
                 if name == "muse_vs_hmc" else ""))
        sync()
        gs.reset_counts()
        t0 = time.perf_counter()
        out = mod.main(argv)
        sync()
        out.update(s=time.perf_counter() - t0, **quad_counts(),
                   fused_launches=gs.spectrum_quadform_and_grad_cuda.launches)
        phase(f"phase 16g [{card}] {name}: {out['s']:.2f} s; quadform "
              f"launches {out['quad_launches']}, fused "
              f"{out['fused_launches']}")
        demos[name] = out
    if fails:
        raise AssertionError("phase 16: " + "; ".join(fails))
    return studies, demos


# ------------------------------------------------------------------ #
# phase 17: the measuring programs (slice 8)
# ------------------------------------------------------------------ #

# each run of phase 17: (its part, the module of muse_tpu_torch that runs
# it, argv of its main, whether it launches the quadform, whether its PCG
# runs through the fused kernel). 17a is bench.py's defaults for each
# model (the funnel and the PPL at 1024 dims); the quadform runs in the GRF
# θ-scores, the fused kernel at every PCG step of the GRF and bandpower
# solves; lensing, the funnel and the PPL launch neither. At bench.py's
# σ_noise = 1 the 1024² PCGs meet their tolerance (atol·√nz on ‖∇z‖) at
# Z₀ = 0 and take no step, in muse_tpu too (its grf.py:609 has the same
# test), so these runs launch the fused kernel as often as their PCGs step:
# no time
MODELS17 = ("grf", "grf-pixel", "lensing", "funnel", "ppl", "bandpower")
_GRID17 = ["--grid", "1024", "--nsims", str(NSIMS17)]
RUNS17 = {
    **{m: ("a", "bench", [*_GRID17, "--model", m], m.startswith("grf"),
           m.startswith("grf") or m == "bandpower") for m in MODELS17},
    "grf_no_hoist": ("b", "bench", [*_GRID17, "--no-hoist"], True, True),
    f"grf_max_batch_{MAX_BATCH17}": (
        "b", "bench", [*_GRID17, "--max-batch", str(MAX_BATCH17)], True,
        True),
    "kernel_ab": ("c", "scripts.kernel_ab_bench",
                  ["--n", "1024", "--nsims", str(AB_NSIMS17)], True, False),
    "noise_modes": ("d", "scripts.bench_noise_modes", _GRID17, True, True),
    # 256² and 16 sims (the JAX script's defaults), 8 realizations
    "lensing_study": ("e", "scripts.lensing_calibration_study",
                      ["--n", "256", "--nsims", "16", "--reps", "8"], False,
                      False),
}


def phase17(card):
    """The port's measuring programs in this process, each through its
    ``main`` (17a-17e, RUNS17). Returns each run's result, wall and kernel
    launches (the counters set to 0 just before the run and read just
    after); raises after the last run if a gate failed."""
    import contextlib
    import importlib
    import math

    import torch

    from muse_tpu_torch.ops import grf_spectrum as gs
    from muse_tpu_torch.ops.cg import batched_cg

    def positive(v):
        return isinstance(v, float) and math.isfinite(v) and v > 0

    runs, fails = {}, []
    for key, (part, modname, argv, quad, fused) in RUNS17.items():
        mod = importlib.import_module(f"muse_tpu_torch.{modname}")
        phase(f"phase 17{part} [{card}] python -m muse_tpu_torch.{modname} "
              f"{' '.join(argv)}")
        torch.cuda.synchronize()
        gs.reset_counts()
        batched_cg.curvature_steps = 0
        t0 = time.perf_counter()
        # the programs' earlier lines (the card, peak memory, the check's
        # gaps) go to stderr: keep them in order with their results
        with contextlib.redirect_stderr(sys.stdout):
            res = mod.main(argv)
        torch.cuda.synchronize()
        out = {"result": res, "s": time.perf_counter() - t0,
               **quad_counts(),
               "fused_launches": gs.spectrum_quadform_and_grad_cuda.launches,
               "cg_steps": batched_cg.curvature_steps}
        f = []
        if not (out["quad_launches"] == out["quad_evaluations"]
                and (out["quad_launches"] > 0) == quad
                and out["quad1_launches"] == 0
                and out["fused_launches"] == (out["cg_steps"] if fused
                                              else 0)):
            f.append(f"kernel launches: quadform {out['quad_launches']} for "
                     f"{out['quad_evaluations']} evaluations, fused "
                     f"{out['fused_launches']} for {out['cg_steps']} CG "
                     "steps")
        if modname == "bench":
            if res["certified"] is not True:
                f.append("the check of the timed step failed")
            if res.get("floor_violation"):
                f.append("floor_violation")
            if not (positive(res["value"]) and positive(res["vs_baseline"])):
                f.append(f"value {res['value']}, vs_baseline "
                         f"{res['vs_baseline']}")
        elif key == "kernel_ab":
            if not positive(res["ratio"]):
                f.append(f"cuda/plain {res['ratio']}")
        elif key == "noise_modes":
            if not (positive(res["direct_s"]) and positive(res["fft_s"])):
                f.append(f"walls {res['direct_s']}, {res['fft_s']}")
        else:
            rows, summary = res
            if summary["diverged"] or not all(
                    positive(r["sigma"]) for r in rows):
                f.append(f"{summary['diverged']} realizations diverged; σ "
                         f"{[r['sigma'] for r in rows]}")
        phase(f"phase 17{part} [{card}] {key}: {out['s']:.2f} s; quadform "
              f"launches {out['quad_launches']} (= θ-score evaluations "
              f"{out['quad_evaluations']}), fused {out['fused_launches']} "
              f"(CG steps {out['cg_steps']})")
        for msg in f:
            phase(f"phase 17{part} GATE FAILED: {key}: {msg}")
        fails += [f"17{part} {key}: {msg}" for msg in f]
        runs[key] = out
    if fails:
        raise AssertionError("phase 17: " + "; ".join(fails))
    return runs


#: phase 18a's spectral GRF cases: (n, lane counts)
WHITES18 = [(64, (1, 128, 513)), (256, (1, 128, 513)), (1024, (1, 128, 513)),
            (257, (1, 128, 513)), (2048, (3,))]


def _bits(t):
    """A float32 tensor's bits: -0 and +0 differ, as the reference's redraw
    would see them."""
    import torch
    return t.view(torch.int32)


def _first_diffs(got, want, k=3):
    """The count of floats of two equal-shaped tensors whose bits differ and
    the first ``k`` of them as (index, got, want)."""
    bad = (_bits(got) != _bits(want)).nonzero()
    first = [(tuple(ix), float(got[tuple(ix)]), float(want[tuple(ix)]))
             for ix in bad[:k].tolist()]
    return int(bad.shape[0]), first


def whites18(card, dev, cases=WHITES18, n=1024, lanes=(1, 128)):
    """18a: the kernel against the per-lane loop, bit for bit: the spectral
    GRF at ``cases``, its direct noise and the bandpower model at n with
    ``lanes``, and field-axis slices of n's packed grid at the last of
    ``lanes``. Returns the failures (none when every case is bitwise) and
    the largest absolute difference any case found."""
    import numpy as np
    import torch

    from muse_tpu_torch.models import bandpower_problem, grf_spectral_problem
    from muse_tpu_torch.models.grf import _herm_white_tensors
    from muse_tpu_torch.ops import herm_white as hw
    from muse_tpu_torch.solver import CompiledProblem
    from muse_tpu_torch.theta import ThetaSpec
    from muse_tpu_torch.utils.keys import sim_seeds

    fails, err = [], [0.0]

    def compare(label, got, want):
        ok = len(got) == len(want) and all(
            (g is None) == (w is None) and (g is None or (
                g.shape == w.shape and torch.equal(_bits(g), _bits(w))))
            for g, w in zip(got, want))
        for g, w in zip(got, want):
            if g is not None and w is not None and g.shape == w.shape:
                err[0] = max(err[0], float((g - w).abs().max()))
        if ok:
            phase(f"phase 18a [{card}] {label}: bitwise equal "
                  f"({[None if g is None else tuple(g.shape) for g in got]})")
            return
        for p, (g, w) in enumerate(zip(got, want)):
            if g is None or w is None or g.shape != w.shape:
                msg = f"part {p}: {g is None}, {w is None} None"
            else:
                count, first = _first_diffs(g, w)
                msg = f"part {p}: {count} floats differ, first {first}"
            phase(f"phase 18a [{card}] {label} DIFFERS: {msg}")
            fails.append(f"{label} {msg}")

    def against_loop(label, prob, theta0, lanes):
        spec = ThetaSpec.from_example(theta0)
        comp = CompiledProblem(prob, spec, spec.flatten(theta0))
        hook = prob.sample_whites_batched
        for B in lanes:
            seeds = sim_seeds(B + len(label), B)
            for x_only in (False, True):
                before = hw.herm_white_cuda.launches
                got = comp.sample_whites(seeds, x_only=x_only)
                launches = hw.herm_white_cuda.launches - before
                prob.sample_whites_batched = None
                try:
                    want = comp.sample_whites(seeds, x_only=x_only)
                finally:
                    prob.sample_whites_batched = hook
                if launches != 1:
                    fails.append(f"{label} B={B}: {launches} launches")
                compare(f"{label} B={B} x_only={x_only}", got, want)
                del got, want
        del comp

    for nc, lc in cases:
        against_loop(f"spectral n={nc}",
                     grf_spectral_problem(n=nc, sigma_noise=0.01,
                                          device=dev), 0.5, lc)
    against_loop(f"spectral direct n={n}",
                 grf_spectral_problem(n=n, sigma_noise=0.01, noise="direct",
                                      device=dev), 0.5, lanes)
    against_loop(f"bandpower n={n} nbands=12",
                 bandpower_problem(n=n, nbands=12, sigma_noise=0.01,
                                   device=dev), np.zeros(12), lanes)
    # a field axis of 2's second rank (the second half of the rows of the
    # (n, 2m) grid: the im half), and an uneven cut of the rows
    m2, B = 2 * (n // 2 + 1), lanes[-1]
    coeffs = _herm_white_tensors(n, dev)
    for rows in ((n // 2, n), (n * 3 // 10, n * 7 // 10)):
        cols = slice(rows[0] * m2, rows[1] * m2)
        seeds = sim_seeds(rows[0], B)
        for parts in ((0,), (0, 1)):
            compare(f"field rows {rows} parts {parts} B={B}",
                    hw.herm_white_cuda(seeds, n, coeffs, parts, cols),
                    hw.herm_white_plain(seeds, n, coeffs, parts, cols))
    return fails, err[0]


def times18(card, dev):
    """18b: the kernel's time at (128, L) beside its bound and the loop's
    wall. Returns the numbers."""
    import torch

    from muse_tpu_torch.models.grf import _herm_white_tensors
    from muse_tpu_torch.ops import herm_white as hw
    from muse_tpu_torch.utils.keys import sim_seeds

    n, B = 1024, 128
    L = 2 * n * (n // 2 + 1)
    coeffs = _herm_white_tensors(n, dev)
    seeds = sim_seeds(18, B)
    out = {}
    for parts in ((0,), (0, 1)):
        ms = cuda_ms(lambda: hw.herm_white_cuda(seeds, n, coeffs, parts))
        bound, _ = least_ms(B * L * 4 * len(parts), 0)
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hw.herm_white_plain(seeds, n, coeffs, parts)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        loop_ms = statistics.median(walls)
        out[len(parts)] = {"ms": ms, "bound_ms": bound,
                           "roofline": bound / ms, "loop_ms": loop_ms}
        phase(f"phase 18b [{card}] herm_white (B={B}, L={L}, {len(parts)} "
              f"part(s)): kernel {ms:.4f} ms, bound {bound:.4f} ms "
              f"({100 * bound / ms:.1f}%), per-lane loop {loop_ms:.2f} ms "
              f"(walls {[round(w, 2) for w in walls]})")
    return out


def pipelines18(card, dev):
    """18c: the benchmark's ``sims512`` and ``sims64`` pipelines at 1024²,
    every lane through the kernel (at lane counts phases 3 and 6 hold the
    other kernels at). Returns each pipeline's counter deltas."""
    import warnings

    import torch

    from muse_tpu_torch import MuseResult, get_H, get_J, muse_fit
    from muse_tpu_torch.models import grf_spectral_problem
    from muse_tpu_torch.utils import trace

    prob = grf_spectral_problem(n=1024, sigma_noise=0.01, device=dev)
    out = {}
    for nsims, h_sims in ((NSIMS2, H_NSIMS2), (NSIMS18, H_NSIMS18)):
        # a sample_whites call for each fit chunk and one for H's sims
        lanes = nsims + 1 + h_sims
        calls = -(-(nsims + 1) // MAX_BATCH2) + -(-h_sims // MAX_BATCH2)
        c0 = trace.counters()
        t0 = time.perf_counter()
        res = MuseResult()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            muse_fit(res, prob, 0.5, nsims=nsims, max_batch=MAX_BATCH2,
                     theta_rtol=1e-5, Hinv_update="sims", alpha=1.0,
                     maxsteps=50, grad_z_atol=1e-2, seed=18)
            get_J(res, prob, nsims=nsims, max_batch=MAX_BATCH2, seed=18,
                  warn_reuse=False)
            get_H(res, prob, nsims=h_sims, implicit_diff=True,
                  implicit_diff_precond=prob.suggested_h_precond,
                  max_batch=MAX_BATCH2, seed=18)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = {k: v - c0[k] for k, v in trace.counters().items()}
        got = {"batched_lanes": c["sample_whites.batched_lanes"],
               "looped_lanes": c["sample_whites.looped_lanes"],
               "launches": c["herm_white_cuda.launches"]}
        phase(f"phase 18c [{card}] pipeline {nsims} sims: {got} (expected "
              f"{lanes} batched lanes, 0 looped, {calls} launches); "
              f"θ̂ {float(res.theta[0]):.5f} ± {float(res.sigma[0]):.5f}, "
              f"{len(res.history)} iterations, {wall:.2f} s")
        if got != {"batched_lanes": lanes, "looped_lanes": 0,
                   "launches": calls}:
            raise AssertionError(f"phase 18c: pipeline {nsims}: {got}")
        out[nsims] = {**got, "wall_s": wall}
    return out


def phase18(card, dev):
    """The batched hermitian white sampler: 18a bitwise against the loop,
    18b its times, 18c the pipelines' counters. Raises if a case of 18a
    differs (after printing every case)."""
    fails, max_abs_err = whites18(card, dev)
    times = times18(card, dev)
    pipes = pipelines18(card, dev)
    if fails:
        raise AssertionError("phase 18a: " + "; ".join(fails))
    return {"times": times, "pipelines": pipes, "max_abs_err": max_abs_err}


def main():
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    import muse_tpu_torch
    from muse_tpu_torch.models import (grf_field_problem, grf_marginal_mle,
                                       grf_spectral_problem)
    from muse_tpu_torch.ops import grf_spectrum as gs
    from muse_tpu_torch.ops.cg import batched_cg
    from muse_tpu_torch.ops.kernels import build_library
    from muse_tpu_torch.solver import CompiledProblem
    from muse_tpu_torch.theta import ThetaSpec

    dev = torch.device("cuda", 0)
    record_kernel_shapes()

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    phase(card)
    phase(f"phase 1 card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")

    # 2. build
    info = build_library()
    phase(f"phase 2 build: {info['seconds']:.2f} s (cached={info['cached']}) "
          f"{os.path.relpath(info['path'])}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            phase("  ptxas: " + line.strip())

    # 3. kernel vs plain at the main path's shapes, on realistic values:
    # packed spectra of random fields and the weights w/C at θ = 0.5
    def inputs(B, n, seed):
        cfg = muse_tpu_torch.models.GrfConfig(n, device=dev)
        g = torch.Generator(device=dev).manual_seed(seed)
        z = gs.pack_rfft2(torch.randn((B, n, n), generator=g, device=dev))
        w = gs.pack_weights(cfg.herm_weight / cfg.spectrum(0.5))
        return z.contiguous(), w.contiguous()

    held = {name: set() for name in kernel_shapes()}

    z, w = inputs(17, 1024, seed=7)
    ct = torch.linspace(0.5, 1.5, 17, device=dev)
    grads = []
    for f in (gs.spectrum_quadform, gs.spectrum_quadform_plain):
        zz, ww = z.clone().requires_grad_(True), w.clone().requires_grad_(True)
        (f(zz, ww) * ct).sum().backward()
        grads.append((zz.grad, ww.grad))
    for name, a, b in (("dz", grads[0][0], grads[1][0]),
                       ("dinvCw2", grads[0][1], grads[1][1])):
        err = ((a - b).abs().max() / b.abs().max()).item()
        phase(f"phase 3 autograd {name}: max abs err / max |grad| {err:.3e}")
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-5 * b.abs().max().item())
    del z, w, grads, zz, ww

    def check_quadforms(label, z, W):
        """spectrum_quadforms vs its plain version in float64 (max relative
        error <= 1e-6), a bitwise rerun, each column bitwise the K = 1
        launch of its weight (spectrum_quadform_cuda), and the first,
        middle and last lanes bitwise their launch at B = 1; returns the
        max abs error."""
        B, K = z.shape[0], W.shape[0]
        held["spectrum_quadforms"].add((B, K) + tuple(z.shape[1:]))
        got = gs.spectrum_quadforms_cuda(z, W)
        again = gs.spectrum_quadforms_cuda(z, W)
        want = gs.spectrum_quadforms_plain(z.double(), W.double())
        rel = ((got.double() - want).abs() / want.abs()).max().item()
        abs_err = (got.double() - want).abs().max().item()
        bitwise = bool(torch.equal(got, again))
        # the K = 1 wrapper (the log-likelihood's) is held here too
        k1 = all(torch.equal(got[:, k], gs.spectrum_quadform_cuda(
            z, W[k].contiguous())) for k in range(K))
        held["spectrum_quadform"].add(tuple(z.shape))
        alone = all(torch.equal(got[b:b + 1], gs.spectrum_quadforms_cuda(
            z[b:b + 1].contiguous(), W)) for b in sorted({0, B // 2, B - 1}))
        held["spectrum_quadforms"].add((1, K) + tuple(z.shape[1:]))
        phase(f"phase 3 {label} B={B} K={K} {tuple(z.shape[1:])}: max rel "
              f"err {rel:.3e} (vs float64), max abs err {abs_err:.3e}; "
              f"rerun bitwise equal {bitwise}, columns bitwise the K = 1 "
              f"launches {k1}, lanes bitwise at B = 1 {alone}")
        if not (rel <= 1e-6 and bitwise and k1 and alone
                and torch.isfinite(got).all()):
            raise AssertionError(f"spectrum_quadforms disagrees on {label} "
                                 f"at B={B}, K={K}")
        return abs_err

    def check_theta_score(label, score_inputs, lane_counts, thetas):
        """The quadforms kernel on a slice's own θ-score inputs,
        ``score_inputs(B, θ) -> (z, W)`` with one weight per θ component,
        at each lane count the slice gives it (:func:`check_quadforms`)."""
        worst = 0.0
        for B in lane_counts:
            for th in thetas:
                z, W = score_inputs(B, th)
                worst = max(worst, check_quadforms(
                    f"{label} θ-score θ={np.round(th, 6).tolist()}", z, W))
                del z, W
        return worst

    def spectral_score_inputs(prob):
        """x̃ drawn by the spectral problem's sampler and the weight
        C/(C+σ²)²."""
        cfg = prob.grf_config
        grid = (cfg.n, 2 * (cfg.n // 2 + 1))

        def make(B, th):
            g = torch.Generator(device=dev).manual_seed(B)
            w1 = torch.stack([prob.sample_white(g)[0] for _ in range(B)])
            C2 = cfg.spectrum(th).reshape(-1).repeat(2)
            z = prob.x_of_white((w1, None), th)[0].reshape((B,) + grid)
            return z, (C2 / (C2 + cfg.sigma_noise ** 2) ** 2).reshape(
                (1,) + grid)
        return make

    def pixel_score_inputs(prob):
        """The pixel GRF's: packed rfft2 of maps drawn by its sampler and
        the weights w·∂C/((C+σ²)²n²), ∂C = C (and −log(k+k₀)·C with the
        tilt)."""
        cfg = prob.grf_config

        def make(B, th):
            g = torch.Generator(device=dev).manual_seed(B)
            x = torch.stack([prob.sample_x_z(g, th)[0] for _ in range(B)])
            C = cfg.spectrum(th)
            wq = cfg.herm_weight * C / ((C + cfg.sigma_noise ** 2) ** 2
                                        * cfg.n ** 2)
            d = [wq] + ([-torch.log(cfg.k + cfg.k0) * wq]
                        if cfg.infer_tilt else [])
            return (gs.pack_rfft2(x).contiguous(),
                    gs.pack_weights(torch.stack(d)).contiguous())
        return make

    def field_rows(make, rows):
        """``make``'s inputs cut to a field rank's ``rows`` of the grid."""
        def cut(B, th):
            z, W = make(B, th)
            return z[:, rows].contiguous(), W[:, rows].contiguous()
        return cut

    # the quadforms kernel at every lane count of QUAD_LANES, with one
    # weight (an amplitude's score) and with two (a tilt's), and at ragged
    # shapes with three and four: the field GRF's score weights w·∂log C/C
    # at θ = (0.5, 0.1) on packed spectra of random fields
    def score_weights(n, K):
        cfg = muse_tpu_torch.models.GrfConfig(n, infer_tilt=True, device=dev)
        C = cfg.spectrum(torch.tensor([0.5, 0.1], device=dev))
        # two more one-signed weights for K = 3 and 4 (a weight of mixed
        # sign would let a lane's sum cancel below its rounding)
        d = [torch.ones_like(C), -torch.log(cfg.k + cfg.k0),
             1.0 + 0.5 * torch.cos(cfg.k), -2.0 - torch.sin(cfg.k)]
        return gs.pack_weights(torch.stack(d[:K]) * cfg.herm_weight
                               / C).contiguous()

    # (their white fields against weights ~k² make sums of ~1e17: the
    # kernels line's max_abs_err comes from the slices' own inputs below)
    for B, K, n in ([(B, K, 1024) for B in QUAD_LANES for K in (1, 2)]
                    + [(3, 3, 100), (5, 4, 33), (6, 2, 33)]):
        z, _ = inputs(B, n, seed=B + n + K)
        check_quadforms("spectrum_quadforms", z, score_weights(n, K))
        del z

    # slice 2's θ-score inputs at the lane counts of its fit (whole, and
    # under a sims axis of 2), and at a field axis of 2's row slices; slice
    # 3's at its fit's chunk and its adaptive-FD stencil batch, slice 4's
    # pixel GRF's at its fit's chunk and its ±ε stencil batch
    prob2 = grf_spectral_problem(n=1024, sigma_noise=0.01, solver="cg",
                                 data_seed=42, device=dev)
    mle2, sig_F2 = grf_marginal_mle(prob2.x_real, prob2.grf_config)
    prob3 = grf_spectral_problem(n=1024, sigma_noise=SIGMA3, solver="lbfgs",
                                 data_seed=DATA_SEED3, device=dev)
    mle3, sig_F3 = grf_marginal_mle(prob3.x_real, prob3.grf_config)
    abs_err_path = max(
        check_theta_score("slice 2", spectral_score_inputs(prob2),
                          sorted({*FIT_CHUNKS2, *MESH_LANES2}), (0.5, mle2)),
        *(check_theta_score(
            f"slice 5 field rows {rows.start}:{rows.stop or 1024}",
            field_rows(spectral_score_inputs(prob2), rows), QUAD_SLICED,
            (0.5, mle2))
          for rows in (slice(0, MESH_ROWS), slice(MESH_ROWS, None))),
        check_theta_score("slice 3", spectral_score_inputs(prob3),
                          (NSIMS3 + 1, H_LANES3), (0.5, mle3)),
        check_theta_score("slice 4 pixel GRF", pixel_score_inputs(
            muse_tpu_torch.models.grf_problem(n=1024, sigma_noise=0.01,
                                              device=dev)),
            (NSIMS4_GRF + 1, H_LANES4_PIXEL[1]), (0.5, 0.0)),
        *(check_theta_score(
            f"slice 6 pixel GRF field rows {rows.start}:{rows.stop or 1024}",
            field_rows(pixel_score_inputs(muse_tpu_torch.models.grf_problem(
                n=1024, sigma_noise=0.01, device=dev)), rows),
            QUAD_SLICED_PIXEL, (0.5, 0.0))
          for rows in (slice(0, PIXEL_ROWS15), slice(PIXEL_ROWS15, None))),
        # slice 7's pixel GRF with the tilt (16c): both components of its
        # score in one launch on its fit's chunk
        check_theta_score("slice 7 pixel GRF with tilt", pixel_score_inputs(
            muse_tpu_torch.models.grf_problem(n=1024, sigma_noise=0.3,
                                              infer_tilt=True, device=dev)),
            (NSIMS16["c"] + 1,), (np.array([0.3, 0.1], np.float32),)))

    # 4. the main path at full width
    prob = grf_field_problem(n=1024, sigma_noise=0.01, device=dev)
    mle, sig_F = grf_marginal_mle(prob.x, prob.grf_config)
    torch.cuda.synchronize()
    gs.reset_counts()
    t0 = time.perf_counter()
    res = muse_tpu_torch.muse(prob, 0.5, nsims=100, theta_rtol=1e-5,
                              maxsteps=20, get_covariance=True)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    qc = quad_counts()
    launches, evaluations = qc["quad_launches"], qc["quad_evaluations"]
    th, sig = float(res.theta[0]), float(res.sigma[0])
    steps = len(res.history)
    h_chunks = 1                      # get_H: one chunk of 10 sims × ±ε
    bound = 3 * sig_F / np.sqrt(100) + 0.02
    phase(f"phase 4 fit: {res}  steps {steps}; MLE {mle:.6f} σ_F "
          f"{sig_F:.6f}; |θ̂−MLE| {abs(th - mle):.6f} (< {bound:.6f}); "
          f"σ/σ_F {sig / sig_F:.4f}")
    phase(f"phase 4 launches: {launches} kernel launches for {evaluations} "
          f"batched θ-score evaluations (the analytic score's "
          f"spectrum_quadforms) = {steps} muse_step chunks + {h_chunks} "
          f"get_H chunk → {launches / (steps + h_chunks):.2f} per chunk; "
          f"{qc['quad1_launches']} launches of the log-likelihood's "
          f"quadform")
    if not (np.isfinite(th) and np.isfinite(sig)):
        raise AssertionError("non-finite θ̂ or σ")
    if not abs(th - mle) < bound:
        raise AssertionError(f"θ̂ {th} vs MLE {mle}: off by more than {bound}")
    if not 0.5 < sig / sig_F < 2:
        raise AssertionError(f"σ {sig} vs σ_F {sig_F}")
    if not (launches > 0 and launches == evaluations == steps + h_chunks
            and qc["quad1_launches"] == 0):
        raise AssertionError(f"{launches} launches, {evaluations} "
                             f"evaluations, {steps + h_chunks} chunks")

    # 5. times: kernel 1 at B=101 × 1024² with one weight (an amplitude's
    # θ-score) and with two (a tilt's), in turns, beside the plain versions
    z, w = inputs(101, 1024, seed=5)
    Ws = {1: w[None], 2: score_weights(1024, 2)}
    ms_plain = [cuda_ms(lambda: gs.spectrum_quadform_plain(z, w))]
    ms_kernel = {1: [], 2: []}
    for K in (1, 2, 2, 1):
        ms_kernel[K].append(cuda_ms(
            lambda K=K: gs.spectrum_quadforms_cuda(z, Ws[K])))
    ms_plain.append(cuda_ms(lambda: gs.spectrum_quadform_plain(z, w)))
    ms_plain2 = [cuda_ms(lambda: gs.spectrum_quadforms_plain(z, Ws[2]))
                 for _ in range(2)]
    ms, plain_ms = statistics.median(ms_kernel[1]), statistics.median(ms_plain)
    ms_k2, plain_ms_k2 = (statistics.median(ms_kernel[2]),
                          statistics.median(ms_plain2))
    L = z.shape[1] * z.shape[2]
    bound_k2, by_k2 = least_ms((101 * L + 2 * L + 2 * 101) * 4, 5 * 101 * L)
    gbps = (z.numel() + w.numel()) * 4 / (ms * 1e-3) / 1e9
    del z, w, Ws
    phase(f"phase 5 [{card}] spectrum_quadforms B=101 n=1024: K = 1 {ms:.4f} "
          f"ms ({gbps:.0f} GB/s), plain {plain_ms:.4f} ms; K = 2 "
          f"{ms_k2:.4f} ms ({ms_k2 / ms:.3f}× K = 1; bound {bound_k2:.4f} ms "
          f"by {by_k2}, {bound_k2 / ms_k2:.0%} of it), plain "
          f"{plain_ms_k2:.4f} ms (runs {ms_kernel}, {ms_plain}, {ms_plain2})")
    if not ms_k2 <= 1.2 * ms:
        raise AssertionError(f"spectrum_quadforms at K = 2 takes {ms_k2} ms, "
                             f"more than 1.2× its {ms} ms at K = 1")

    spec = ThetaSpec.from_example(0.5)
    comp = CompiledProblem(prob, spec, np.array([res.theta[0]]))
    thd = comp.theta(res.theta)
    seeds = list(range(101))
    lanes = torch.arange(101, device=dev)
    Z = torch.zeros((101, comp.nz), device=dev)
    step_s = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        comp.muse_step(thd, thd, seeds, Z, lanes, 1e-2)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    phase(f"phase 5 [{card}] muse_step (101 lanes × 1024²): median "
          f"{statistics.median(step_s[1:]):.4f} s (runs {step_s}); whole fit "
          f"+ J + H {t_fit:.2f} s, of which the fit's iterations "
          f"{[round(h['t'], 4) for h in res.history]} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # 5b. the field GRF's batched θ-score at 101 lanes × 1024², route by
    # route (scripts/theta_score_bench.py): the analytic score through the
    # kernel and through the plain quadforms, and vmap(grad(log_like))
    # through the kernel's forward (the route before the analytic score)
    # and through the plain einsum's autograd
    from muse_tpu_torch.scripts import theta_score_bench
    scores = theta_score_bench.run(n=1024, lanes=NSIMS4_GRF + 1,
                                   sigma_noise=0.01, device=dev)
    theta_score_bench.report(scores, 1024, NSIMS4_GRF + 1,
                             emit=lambda line: phase(f"phase 5b [{card}] "
                                                     f"{line}"))
    want_launches = {"analytic_kernel": 1, "analytic_plain": 0,
                     "grad_kernel": 1, "grad_plain": 0}
    scores5b = {k: {m: r[m] for m in ("ms", "profile_ms", "launches",
                                      "rel_err", "rel_vs_grad")}
                for k, r in scores.items()}
    ak, ap = scores5b["analytic_kernel"], scores5b["analytic_plain"]
    fastest_grad = min(scores5b["grad_kernel"]["ms"],
                       scores5b["grad_plain"]["ms"])
    phase(f"phase 5b [{card}] batched θ-score ms: analytic kernel "
          f"{ak['ms']:.4f} < analytic plain {ap['ms']:.4f} < vmap(grad) "
          f"{fastest_grad:.4f}: {ak['ms'] < ap['ms'] < fastest_grad}")
    # each route within 1e-5 of float64 and of the grad_kernel route,
    # relative to the score's two cancelling terms (phase 15b's tolerance:
    # the plain float32 sums' own rounding); the kernel route, whose sums
    # are trees, within 1e-6
    if not ({k: r["launches"] for k, r in scores5b.items()} == want_launches
            and all(r["rel_err"] <= 1e-5 and r["rel_vs_grad"] <= 1e-5
                    for r in scores5b.values())
            and ak["rel_err"] <= 1e-6
            and ak["ms"] < ap["ms"] < fastest_grad):
        raise AssertionError(f"phase 5b: the θ-score routes: {scores5b}")
    del scores, ak, ap

    launches_slice1 = launches
    del comp, Z

    # 6. the fused kernel vs plain, on the PCG operators of the packed
    # models: random packed vectors p and the weight A = 1 + C/σ², with the
    # GRF spectrum at θ = 0.5 or the 12-band spectrum P0·exp(θ_band) of the
    # bandpower model at a θ spread over ±0.5
    def pcg_inputs(B, n, seed, bands=0, rows=None):
        cfg = muse_tpu_torch.models.GrfConfig(n, sigma_noise=0.01,
                                              device=dev)
        g = torch.Generator(device=dev).manual_seed(seed)
        grid = (n, 2 * (n // 2 + 1))
        C = cfg.spectrum(0.0 if bands else 0.5)
        if bands:
            from muse_tpu_torch.models.bandpower import _k_grid64, band_edges
            band = np.searchsorted(band_edges(n, bands), _k_grid64(n),
                                   side="right")
            C = C * torch.tensor(np.exp(np.linspace(-0.5, 0.5, bands))[band],
                                 dtype=C.dtype, device=dev)
        A = 1.0 + C.reshape(-1).repeat(2) / 0.01 ** 2
        p = torch.randn((B,) + grid, generator=g, device=dev)
        A = A.reshape(grid)
        if rows is not None:           # a field rank's rows
            p, A = p[:, rows], A[rows]
        return p.contiguous(), A.contiguous()

    # every lane count of the paths, the bandpower operator at its own, and
    # the row slices of a field axis of 2 (both halves)
    abs_err_fused = 0.0
    shapes = [(B, 1024, 0, None) for B in FUSED_LANES] + [
        (B, 1024, bands, None) for bands, lanes in FUSED_BAND for B in lanes]
    for rows in (slice(0, MESH_ROWS), slice(MESH_ROWS, None)):
        shapes += [(B, 1024, 0, rows) for B in FUSED_SLICED]
        shapes += [(B, 1024, NBANDS4, rows) for B in FUSED_SLICED_BAND]
    for rows in (slice(0, PIXEL_ROWS15), slice(PIXEL_ROWS15, None)):
        shapes += [(B, 1024, 0, rows) for B in FUSED_SLICED_PIXEL]
    for B, n, bands, rows in shapes + [(3, 100, 0, None), (5, 33, 0, None)]:
        p, A = pcg_inputs(B, n, seed=B + n, bands=bands, rows=rows)
        held["spectrum_quadform_and_grad"].add(tuple(p.shape))
        q, hg = gs.spectrum_quadform_and_grad_cuda(p, A)
        q2, hg2 = gs.spectrum_quadform_and_grad_cuda(p, A)
        qp, hgp = gs.spectrum_quadform_and_grad_plain(p, A)
        # the quad is held against the plain version in float64: the
        # float32 plain einsum is a ~1e6-term dot product whose own
        # rounding reaches ~1e-5 relative here (measured 1.5e-5 at B=128)
        q64, _ = gs.spectrum_quadform_and_grad_plain(p.double(), A.double())
        rel = ((q.double() - q64).abs() / q64.abs()).max().item()
        rel32 = ((qp.double() - q64).abs() / q64.abs()).max().item()
        abs_err = (q.double() - q64).abs().max().item()
        exact = bool(torch.equal(hg, hgp))
        bitwise = bool(torch.equal(q, q2) and torch.equal(hg, hg2))
        phase(f"phase 6 B={B} n={n} "
              f"{'' if rows is None else f'rows {rows.start}:{rows.stop or n} '}"
              f"{f'{bands}-band' if bands else 'GRF'} weight: quad max rel err {rel:.3e} (the "
              f"float32 plain's own {rel32:.3e}), max abs err "
              f"{abs_err:.3e}; half_grad == z*w: {exact}; rerun bitwise "
              f"equal: {bitwise}")
        if not (rel <= 1e-5 and exact and bitwise
                and torch.isfinite(q).all()):
            raise AssertionError(f"fused kernel disagrees at B={B}, n={n}")
        if n == 1024:
            abs_err_fused = max(abs_err_fused, abs_err)
        del p, A, q, hg, q2, hg2, qp, hgp, q64

    # 7. the slice 2 main path at full width, twice in one process
    comp2 = CompiledProblem(prob2, ThetaSpec.from_example(0.5),
                            np.array([0.5]))
    white_calls = [0]
    step_white = comp2.muse_step_white

    def counted_step_white(*args, **kwargs):
        white_calls[0] += 1
        return step_white(*args, **kwargs)

    def keyed_step(*args, **kwargs):
        raise AssertionError("the slice 2 fit called muse_step, not "
                             "muse_step_white")

    comp2.muse_step_white = counted_step_white
    comp2.muse_step = keyed_step
    target = max(1e-3, 2.0 * sig_F2 / np.sqrt(NSIMS2))
    runs = []
    torch.cuda.reset_peak_memory_stats()
    for run in ("cold", "warm"):
        torch.cuda.synchronize()
        gs.reset_counts()
        batched_cg.curvature_steps = 0
        white_calls[0] = 0
        t0 = time.perf_counter()
        res2 = muse_tpu_torch.MuseResult()
        muse_tpu_torch.muse_fit(res2, prob2, 0.5, nsims=NSIMS2,
                                max_batch=MAX_BATCH2,
                                theta_rtol=1e-5, alpha=1.0,
                                Hinv_update="sims", compiled=comp2, seed=1)
        torch.cuda.synchronize()
        t_fit2 = time.perf_counter() - t0
        muse_tpu_torch.get_J(res2, prob2, nsims=NSIMS2, max_batch=MAX_BATCH2,
                             compiled=comp2, warn_reuse=False)
        torch.cuda.synchronize()
        t_j2 = time.perf_counter() - t0 - t_fit2
        muse_tpu_torch.get_H(res2, prob2, nsims=H_NSIMS2, implicit_diff=True,
                             implicit_diff_precond=prob2.suggested_h_precond,
                             max_batch=MAX_BATCH2, compiled=comp2)
        torch.cuda.synchronize()
        t_h2 = time.perf_counter() - t0 - t_fit2 - t_j2
        counts = {**quad_counts(),
                  "fused_launches": gs.spectrum_quadform_and_grad_cuda.launches,
                  "cg_steps": batched_cg.curvature_steps,
                  "muse_step_white_calls": white_calls[0]}
        th2, sig2 = float(res2.theta[0]), float(res2.sigma[0])
        runs.append({"run": run, "fit_s": t_fit2, "J_s": t_j2, "H_s": t_h2,
                     "steps": len(res2.history), **counts})
        phase(f"phase 7 {run} [{card}] fit: {res2}  steps "
              f"{len(res2.history)}; MLE {mle2:.6f} σ_F {sig_F2:.6f}; "
              f"|θ̂−MLE| {abs(th2 - mle2):.6f} (< {target:.6f}); σ/σ_F "
              f"{sig2 / sig_F2:.4f}; J {float(res2.J[0, 0]):.1f} H "
              f"{float(res2.H[0, 0]):.1f}; max CG resid "
              f"{max(float(np.max(r)) for r in res2.metadata['implicit_diff_cg_resid']):.3e}")
        phase(f"phase 7 {run} counts: {counts}; walls fit {t_fit2:.3f} s, "
              f"J {t_j2:.4f} s, H {t_h2:.3f} s; fit iterations "
              f"{[round(h['t'], 4) for h in res2.history]} s")
        if not (np.isfinite(th2) and np.isfinite(sig2)):
            raise AssertionError("non-finite θ̂ or σ")
        if not abs(th2 - mle2) < target:
            raise AssertionError(f"θ̂ {th2} vs MLE {mle2}: off by more than "
                                 f"{target}")
        if not 0.9 < sig2 / sig_F2 < 1.1:
            raise AssertionError(f"σ {sig2} vs σ_F {sig_F2}: ratio "
                                 f"{sig2 / sig_F2}")
        if not (counts["muse_step_white_calls"] > 0 and
                counts["quad_launches"] == counts["quad_evaluations"]
                == counts["muse_step_white_calls"]
                and counts["quad1_launches"] == 0):
            raise AssertionError(f"quadform launches do not match the "
                                 f"θ-score evaluations: {counts}")
        if not (counts["fused_launches"] > 0 and
                counts["fused_launches"] == counts["cg_steps"]):
            raise AssertionError(f"fused launches do not match the CG "
                                 f"steps: {counts}")
    peak2 = torch.cuda.max_memory_allocated() / 2 ** 30
    launches_slice2 = runs[0]["quad_launches"]
    fused_launches = runs[0]["fused_launches"]
    phase(f"phase 7 [{card}] peak device memory {peak2:.2f} GiB")

    # 8. times
    z, w = inputs(101, 1024, seed=5)
    lib_ms = [cuda_ms(lambda: torch.einsum("bnm,bnm,nm->b", z, z, w))]
    lib_ms.append(cuda_ms(lambda: torch.einsum("bnm,bnm,nm->b", z, z, w)))
    library_ms = statistics.median(lib_ms)
    L = z.shape[1] * z.shape[2]
    quad_bound, quad_by = least_ms((101 * L + L + 101) * 4, 3 * 101 * L)
    del z, w
    phase(f"phase 8 [{card}] spectrum_quadform B=101 n=1024: library "
          f"einsum {library_ms:.4f} ms (runs {lib_ms}); bound "
          f"{quad_bound:.4f} ms ({quad_by})")

    p, A = pcg_inputs(128, 1024, seed=9)
    f_plain = [cuda_ms(lambda: gs.spectrum_quadform_and_grad_plain(p, A))]
    f_kernel = [cuda_ms(lambda: gs.spectrum_quadform_and_grad_cuda(p, A))
                for _ in range(2)]
    f_plain.append(cuda_ms(lambda: gs.spectrum_quadform_and_grad_plain(p, A)))
    f_ms, f_plain_ms = statistics.median(f_kernel), statistics.median(f_plain)
    L = p.shape[1] * p.shape[2]
    f_bytes = (2 * 128 * L + L + 128) * 4
    fused_bound, fused_by = least_ms(f_bytes, 3 * 128 * L)
    del p, A
    phase(f"phase 8 [{card}] spectrum_quadform_and_grad B=128 n=1024: "
          f"kernel {f_ms:.4f} ms ({f_bytes / (f_ms * 1e-3) / 1e9:.0f} GB/s),"
          f" plain {f_plain_ms:.4f} ms, bound {fused_bound:.4f} ms "
          f"({fused_by}; {fused_bound / f_ms:.0%} of it) (runs {f_kernel}, "
          f"{f_plain})")

    seeds = list(range(128))
    W = comp2.sample_whites(seeds, x_only=True)
    lanes = torch.arange(1, 129, device=dev)
    Z = torch.zeros((128, comp2.nz), device=dev)
    thd = comp2.theta(np.array([mle2]))
    step_s = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_white(thd, thd, W, Z, lanes, 1e-2)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    phase(f"phase 8 [{card}] muse_step_white (128 lanes × 1024²): median "
          f"{statistics.median(step_s[1:]):.4f} s (runs {step_s})")
    profile_steps(lambda: step_white(thd, thd, W, Z, lanes, 1e-2), card,
                  "phase 8")
    del W, Z
    phase(f"phase 8 [{card}] slice 2 walls: cold fit {runs[0]['fit_s']:.3f} "
          f"J {runs[0]['J_s']:.4f} H {runs[0]['H_s']:.3f} s; warm fit "
          f"{runs[1]['fit_s']:.3f} J {runs[1]['J_s']:.4f} H "
          f"{runs[1]['H_s']:.3f} s; peak device memory {peak2:.2f} GiB")

    phase(f"phases 1-8 took {time.perf_counter() - t_start:.1f} s")
    launches_slice3, fused_cg3 = phase9(card, prob3, mle3, sig_F3)
    phase(f"phases 1-9 took {time.perf_counter() - t_start:.1f} s")
    users10 = phase10(card, dev)
    phase(f"phases 1-10 took {time.perf_counter() - t_start:.1f} s")
    phase11(card, dev)
    phase(f"phases 1-11 took {time.perf_counter() - t_start:.1f} s")
    lensing12 = phase12(card, dev)
    phase(f"phases 1-12 took {time.perf_counter() - t_start:.1f} s")
    slice4 = phase13(card, dev, field=(prob, res))
    phase(f"phases 1-13 took {time.perf_counter() - t_start:.1f} s")
    mesh = phase14(card, dev, ref7=res2, walls7=runs[1], mle2=mle2,
                   sig_F2=sig_F2, band13=slice4, held=held, comp2=comp2,
                   prob2=prob2)
    phase(f"phases 1-14 took {time.perf_counter() - t_start:.1f} s")
    phase15a(card, prob2, comp2, res2.theta)
    phase15b(card, dev, prob)
    field15 = phase15(card, dev, prob, slice4["pixel"], users10, lensing12,
                      held)
    phase(f"phases 1-15 took {time.perf_counter() - t_start:.1f} s")
    cal16, demos16 = phase16(card, dev)
    phase(f"phases 1-16 took {time.perf_counter() - t_start:.1f} s")
    runs17 = phase17(card)
    phase(f"phases 1-17 took {time.perf_counter() - t_start:.1f} s")
    white18 = phase18(card, dev)
    phase(f"phases 1-18 took {time.perf_counter() - t_start:.1f} s")
    lens19 = phase19(card, dev)
    phase(f"phases 1-19 took {time.perf_counter() - t_start:.1f} s")

    # every shape a kernel was launched at in this run was held against
    # the plain version in phase 3 or 6
    for name, shapes in kernel_shapes().items():
        missed = sorted(shapes - held[name])
        phase(f"{name}: launched at {len(shapes)} shapes: {sorted(shapes)}; "
              f"not held against the plain version: {missed}")
        if missed:
            raise AssertionError(f"{name} ran at shapes that no phase held "
                                 f"against its plain version: {missed}")

    # slice 7's path: the calibration studies 16a-16f, each with the
    # counters set to 0 just before it and read just after
    quad16 = {f"slice7_calibration_16{k}": cal16[k]["quad_launches"]
              for k in "bcf"}
    fused16 = {f"slice7_calibration_16{k}": cal16[k]["fused_launches"]
               for k in "bcdf"}
    demo16 = demos16["northstar_grf"]
    # slice 8's paths: phase 17's runs that launch a kernel or run a PCG
    # through it, each with the counters set to 0 just before it and read
    # just after
    quad17 = {f"slice8_bench_{k.replace('-', '_')}": runs17[k]["quad_launches"]
              for k in RUNS17 if RUNS17[k][3]}
    fused17 = {f"slice8_bench_{k.replace('-', '_')}":
               runs17[k]["fused_launches"] for k in RUNS17 if RUNS17[k][4]}
    by_path = {"spectrum_quadform": {
        "slice1_field_grf": launches_slice1,
        "slice2_northstar": launches_slice2,
        "slice3_lbfgs": launches_slice3,
        "slice4_grf_pixel": slice4["quad_grf_pixel"],
        "slice5_mesh_14a": mesh["a"]["quad_launches"],
        "slice5_mesh_14b_rank0": mesh["b"]["quad_launches"],
        "slice5_mesh_14c_rank0": mesh["c"]["quad_launches"],
        "slice6_pixel_field_15c_rank0": field15["quad_launches"],
        **quad16,
        "slice7_demo_northstar": demo16["quad_launches"],
        **quad17}, "spectrum_quadform_and_grad": {
        "slice2_northstar": fused_launches,
        "slice3_cg_comparison": fused_cg3,
        "slice4_bandpower": slice4["fused_bandpower"],
        "slice4_grf_pixel": slice4["fused_grf_pixel"],
        "slice5_mesh_14a": mesh["a"]["fused_launches"],
        "slice5_mesh_14b_rank0": mesh["b"]["fused_launches"],
        "slice5_mesh_14c_rank0": mesh["c"]["fused_launches"],
        "slice5_mesh_14d_rank0": mesh["d"]["fused_launches"],
        "slice6_pixel_field_15c_rank0": field15["fused_launches"],
        **fused16,
        "slice7_demo_northstar": demo16["fused_launches"],
        **fused17}}
    # each kernel's launches over every path of the run (slice 8's own
    # paths run the fused kernel no time: their PCGs take no step)
    for name, paths in by_path.items():
        if not sum(paths.values()) > 0:
            raise AssertionError(f"{name} was launched on no path: {paths}")
    print(json.dumps({"kernels": [{
        "name": "spectrum_quadform", "route": "cuda",
        "source": "muse_tpu_torch/csrc/spectrum_quadform.cu",
        "replaces": "muse_tpu/ops/pallas_grf.py:137",
        "launches": sum(by_path["spectrum_quadform"].values()),
        "max_abs_err": abs_err_path,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": quad_bound,
        "bound_by": quad_by, "library_ms": library_ms,
        "ms_k2": ms_k2, "plain_ms_k2": plain_ms_k2, "bound_ms_k2": bound_k2,
        "launches_by_path": by_path["spectrum_quadform"]}, {
        "name": "spectrum_quadform_and_grad", "route": "cuda",
        "source": "muse_tpu_torch/csrc/spectrum_quadform.cu",
        "replaces": "muse_tpu/ops/pallas_grf.py:73",
        "launches": sum(by_path["spectrum_quadform_and_grad"].values()),
        "max_abs_err": abs_err_fused,
        "ms": f_ms, "plain_ms": f_plain_ms, "bound_ms": fused_bound,
        "bound_by": fused_by, "library_ms": None,
        "launches_by_path": by_path["spectrum_quadform_and_grad"]}, {
        "name": "herm_white", "route": "cuda",
        "source": "muse_tpu_torch/csrc/herm_white.cu", "replaces": None,
        "launches": sum(p["launches"]
                        for p in white18["pipelines"].values()),
        "max_abs_err": white18["max_abs_err"],
        "ms": white18["times"][1]["ms"],
        "plain_ms": white18["times"][1]["loop_ms"],
        "bound_ms": white18["times"][1]["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "launches_by_path": {f"pipeline_{k}_sims": p["launches"]
                             for k, p in white18["pipelines"].items()}}] + [{
        "name": f"lens_{k}", "route": "cuda",
        "source": "muse_tpu_torch/csrc/lens_planes.cu", "replaces": None,
        "launches": lensing12["lens_launches"][k],
        "max_abs_err": max(row["max_err"] for row in rows),
        "ms": rows[0]["ms"], "plain_ms": rows[0]["plain_ms"],
        "bound_ms": rows[0]["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        **({"ms_with_r": rows[1]["ms"], "bound_ms_with_r":
            rows[1]["bound_ms"]} if len(rows) > 1 else {}),
        "launches_by_path": {"slice4_lensing_fit":
                             lensing12["lens_launches"][k]}}
        for k, rows in ((k, [lens19[r] for r in lens19
                             if r.split("_")[0] == k])
                        for k in LENS_PASSES)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
