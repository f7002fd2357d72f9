#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`sde_sampler_torch`) on one CUDA card.

    python3 chip_smoke.py                   # every phase: the release check
    python3 chip_smoke.py --phases kernels  # build and kernel checks only
    python3 chip_smoke.py --phases kernels,timing  # and the kernel times

It first builds the CUDA kernels from sde_sampler_torch/csrc (timed) and
prints nvcc's register and spill report. Phases:
  kernels  hold each kernel against its plain PyTorch version on the card,
           at the shapes of the paths that run it (weights and inputs from a
           numpy seed), with the stated tolerances: kernel 1 (EM rollout) in
           its LerpCtrl form on the DIS grid and its ScoreCtrl form on the VP
           grid, kernel 2 (exponential-integrator rollout) on the DDS cosine
           grid, kernel 1's generic body (a 32-wide net), each instance of
           the mixture, wells, rings, Rosenbrock, ClippedCtrl, LerpTargetCtrl,
           PotentialCtrl and CancelDriftCtrl forms, the image and the
           given-score form (INSTANCES; the LerpTargetCtrl's, the
           PotentialCtrl's, the rings', the Rosenbrock's, the
           CancelDriftCtrl's and the image's in both bodies, the
           PotentialCtrl's also at d = 16 in both bodies and at d = 50 in
           the generic body, there also at a ragged batch of 2047 with its
           plan; the given score at d = 196 in
           the wide body and in the generic one, whose bits it must give,
           at d = 1600 in the wide body and at the alanine dipeptide's
           d = 60 and batch 512 in the generic body; mw_50d's generic body
           and Cox's wide body also at a ragged batch of 2047, with the
           plan of each, which must cover every row once; the per-coordinate instances of a score
           net of d outputs, the lerp form's in both bodies, the score
           form's and kernel 2's, each also with a table of equal rows,
           which must give the one-output instance's bits; the DenseNet
           body (conf/model/base/densenet.yaml's [200, 200] ReLU net) in
           kernel 1's lerp form on the mixture, the funnel's PIS score
           form, kernel 2 on the funnel, mw_50d's lerp form (d = 50, its
           weights streamed), a given score at d = 196 (the whitened Cox
           process at NICE's d, streamed), and
           the ClippedCtrl, LerpTargetCtrl and CancelDriftCtrl forms on the
           mixture, the resident ones also streamed, which must give the
           same bits); the LerpPriorCtrl form (both bodies, a score net of
           d outputs, the DenseNet body), the LerpCtrl over PIS's Delta
           prior, the per-coordinate LerpTargetCtrl and CancelDriftCtrl
           instances and the ScoreCtrl on the mixture under the
           time-reversal loss's VP (both bodies); the lerp forms with an
           IsotropicGauss prior and an equal diagonal Gauss, which must
           give the same bits, and with a Gauss of unequal coordinates
           against the plain twin; softmin and
           transport at 10k for d = 2, 5 (rows in registers) and 17, 50, 60,
           196 (the wide body, which each of these must launch; d = 60 also
           at the alanine dipeptide's 4096 evaluation; there transport is
           also held to float64 within WIDE_TRANSPORT_F64_RTOL), and at
           100k x 100k, softmin's
           edges at 100k (a column split of -inf duals, rows that see only
           -inf) and transport's (a column split of -inf duals, every dual
           -inf, two calls that must give the same bits);
  main     drive each path through the entry point (`sde_sampler_torch.main`)
           at full width, each with the launch counts zeroed just before and
           read just after; every kernel of the path must have run on it:
             dis        funnel (d = 10), two-phase LV, batch 2048 x 200 EM
                        steps, LerpCtrl, 220 optimizer steps (past the clip
                        milestone 200), then the final 100k evaluation (both
                        log Z estimators, ESS, Sinkhorn against exact
                        samples);
             dds        funnel, two-phase LV through kernel 2, batch 2048 x
                        257 cosine steps, ScoreCtrl, 220 steps, 100k eval;
             gmm_dis    the grid mixture (d = 2, K = 9) as dis, 220 steps,
                        100k evaluation;
             gmm_dis_densenet  the same with conf/model/base/densenet.yaml's
                        net ([200, 200], ReLU): kernel 1's DenseNet body
                        (its weights resident in shared memory), counted as
                        rollout.lerp.gmm.dense, and no scan route;
             gmm_bridge_diff_init  the mixture under the Bridge with a
                        learned inference control (a ClippedCtrl, its exact
                        divergence in phase 2 and at every evaluation step),
                        220 steps, 100k evaluation;
             gmm_dis_subtraj  the mixture under SubtrajBridge with a
                        PotentialCtrl (the net's backward pass in every EM
                        step of kernel 1), half the steps on a subtrajectory
                        that ends at T, 220 steps, 100k evaluation; it logs
                        how many steps took a subtrajectory and their lengths;
             mw_50d_dis_subtraj  the same on mw_50d (d = 50), 20 steps, a
                        10k evaluation: the potential form's generic body,
                        once per optimizer step, and the Sinkhorn kernels'
                        wide body;
             rings_dis  the rings (d = 2) under DIS, 220 steps, 100k
                        evaluation (no sampler: no Sinkhorn);
             img_dis    the image (d = 2) under DIS, 220 steps, 100k
                        evaluation and its Sinkhorn;
             cox_dis    the whitened Cox process (d = 1600) under DIS at its
                        batch 2048, 20 steps, a 10k evaluation on the
                        config's 800-step grid (no sampler: no Sinkhorn);
                        kernel 1's given-score form in the wide body, 200
                        launches a step;
             nice_smooth_dis  the smooth NICE flow (d = 196) under DIS, 5
                        steps, a 10k evaluation and its Sinkhorn through
                        the Sinkhorn kernels' wide body; the given-score form
                        in the wide body, 200 launches a step;
             aladip_vacuum_dis  the alanine dipeptide (d = 60, the native
                        force field's autograd score) under DIS at its batch
                        512, 5 steps, a 4096 evaluation and its Sinkhorn
                        against the validation set (the Sinkhorn kernels'
                        wide body); the given-score form in
                        the generic body, 200 launches a step;
             funnel_dis_lerp_dim, funnel_pis_score_dim,
             funnel_dds_score_dim  DIS, PIS and DDS with a score net of d
                        outputs (conf/model/lerp_dim.yaml, score_dim.yaml):
                        the per-coordinate instances, 20 steps, 10k eval;
             mw_50d_dis_densenet, funnel_dds_densenet  the DenseNet body
                        at d = 50 (its weights streamed through its ring)
                        and under kernel 2, 20 steps, 10k eval;
             funnel_pis_densenet, gmm_dis_no_score_densenet,
             gmm_bridge_densenet, gmm_dds_euler_langevin_init_densenet,
             nice_smooth_dis_densenet  the DenseNet body in kernel 1's
                        score, clipped, lerp_target and cancel_drift forms,
                        20 steps, and in the given-score form (d = 196,
                        streamed), 5 steps; 10k eval;
             gmm_langevin  the untrained Langevin solver at its full config
                        (conf/solver/langevin.yaml: 6000 chains, 10000 Euler
                        steps of dt 0.01, 1000 output steps, burn-in 500),
                        plain torch on the card, then the Sinkhorn at 6000;
             rings_langevin_heun  the adaptive Heun integrator on the
                        port's Brownian tree, 500 chains over T = 1; it logs
                        its accepted and rejected steps;
             dds_euler, pis (funnel), mw_dds (d = 5, kernel 2),
             mw_50d_dis (d = 50, the generic body and the Sinkhorn
             kernels' wide body, which the paths of d > 16 must take for
             every Sinkhorn launch and no other path may take),
             dw_shift_pis (d = 1),
             gmm_dis_no_score (the ClippedCtrl), gmm_bridge (the
             LerpTargetCtrl on the scaled BM, a LerpPriorCtrl inference
             control), gmm_bridge_subtraj (PotentialCtrl generative and
             inference controls, subtrajectories of any length),
             rosenbrock_dis (d = 15, the objective metrics) and
             gmm_dds_euler_langevin_init (the CancelDriftCtrl against the
             VP drift): 20 steps, 10k eval;
             gmm_dis_lerp_prior, gmm_dis_lerp_prior_dim,
             gmm_dis_lerp_prior_densenet, gmm_pis_lerp, gmm_dis_score,
             gmm_bridge_lerp_dim, gmm_dis_langevin_init_dim  solvers composed
                        with another model (model@generative_ctrl=...): the
                        LerpPriorCtrl form (with a score net of d outputs,
                        over the DenseNet), the LerpCtrl over PIS's Delta
                        prior, the ScoreCtrl under the time-reversal loss's
                        VP, the per-coordinate LerpTargetCtrl and
                        CancelDriftCtrl instances: FORM_STEPS steps, kernel 1
                        once a step, 10k eval;
             funnel_dis_explore (exploration noise 0.1 and dropout 0.5 of
             the sde control), funnel_dds_explore (noise 0.1 under kernel
             2's loss; DDS has no SDE for the dropout's neutral control)
             and gmm_pis_multilevel (a MultilevelNet: factor 5, 4 levels):
             phase 1 through the scan route (no kernel instance), which
             each must take once per optimizer step; 10 steps, 10k eval
             and its Sinkhorn through the kernels. Every other path must
             take the scan route no time;
           then the plots: with matplotlib on the card, a gmm_dis
           evaluation with plot_results=True must write its PNGs; without
           it, plot_results=True must raise at set-up, naming matplotlib;
           then the entry points' phases (ENTRY_PHASES), on funnel DIS at
           full width, 20 steps and a 10k evaluation per job, each timed:
             multirun_seq   `main -m ... seed=1,2` through the in-process
                        launcher: each job launches kernel 1 20 times and
                        the Sinkhorn's kernels, and a finished job leaves no
                        card memory behind (the second job leaves what the
                        first did and peaks where it did);
             multirun_pool  the same two jobs as two child processes on the
                        card (`launcher=joblib launcher.n_jobs=2`), which
                        must overlap; each child's launches are read from
                        the line its solver writes to its main.log;
             wandb_resume   with tests/fake_wandb.py as the backend, a
                        20-step job uploading its checkpoints every 5 steps
                        is preempted after step 10, its out_dir wiped and
                        requeued: it resumes at step 11 from the artifact,
                        its optimizer state on the card, and ends with an
                        uninterrupted run's parameters (WANDB_RESUME_RTOL;
                        it reports whether they are bit-equal);
             train_nice `python -m sde_sampler_torch.train_nice` on 4000
                        synthetic images for 200 iterations: the loss falls,
                        and its checkpoint loads in the port's Nice with a
                        finite log-density on 1000 draws;
             data_parallel  n_devices=2, the two ranks sharing the card
                        over gloo: the funnel DIS job as a child
                        `python -m sde_sampler_torch.main ... n_devices=2`
                        (each rank's launches and parameter digest read from
                        its `[rank r]` log lines: 20 kernel-1 launches, 2
                        softmin per Sinkhorn iteration and 1 transport per
                        Sinkhorn, equal digests), its 20 losses and largest
                        gradients against one rank's (DP_LOSS_RTOL); a
                        sharded 100k x 100k
                        Sinkhorn at d = 10 against one rank's kernel result
                        on the same clouds (DP_SINKHORN_RTOL), with the
                        seconds its collectives take; gmm_langevin (6000
                        chains, 1000 Euler steps) at n_devices=2 against
                        n_devices=1 (DP_LANGEVIN_RTOL); on a machine with
                        two cards, the DIS job again over NCCL, a card per
                        rank (else it prints that it was not run);
  timing   time the DIS, DDS, mixture DIS and mixture Bridge optimizer
           steps, the rings DIS, Rosenbrock DIS and langevin_init EulerDDS
           steps, the image, Cox, NICE and alanine-dipeptide DIS steps (the
           last three, 200 launches and scores a step, over three windows
           of one step, with their card memory peak and the share of the step
           that goes when their target score is replaced by zeros), and
           the mixture's and mw_50d's SubtrajBridge, on the whole trajectory
           and on a subtrajectory (with a profiler breakdown; for the Bridge also
           the card time of phase 2's divergence), each kernel and instance
           through its wrapper (a given score's with the target's score
           every step), alone (a given score's on one fixed score) and as
           its plain version at its path's shapes
           (the funnel rollouts in each body; the tiled bodies' rows of
           PERF.md §6, 1d, 1k, 1l, 1o and the potential's 1f at d = 50,
           with their bound ratio and plan; the potential's fast body at
           d = 2 and 16, each also in the generic body,
           a given score's also by the profiler's device time, NICE's also
           in the generic body and Cox's also at 8 rows a block), softmin and transport at
           100k for d = 2, 50, 60 and 196, each beside its bound (at d = 50
           the wide body also against its plain version, with its time, and
           beside a library yardstick the port never calls: torch.cdist in
           its default mode and torch.logsumexp over the same 1024-row
           chunks), one whole 100k Sinkhorn at d = 50 (eval/sinkhorn.py,
           eps = 1e-3) and one full Sinkhorn evaluation, whose
           transport kernel must lie within TRANSPORT_F64_RTOL of float64
           on the same funnel samples and duals; the gmm_dis_densenet,
           mw_50d_dis_densenet and funnel_dds_densenet steps, and the
           gmm_dis_densenet step again with phase 1 forced through the
           scan route; the steps of the solver x model compositions' paths;
           print each kernel's
           launches per paper-scale DIS run, computed from
           conf/solver/oc_base.yaml; the funnel DIS step again with phase
           1 through the loss's scan route in place of kernel 1, and the
           steps of the three scan-route paths, each with its idle share.
           Without the main phase it times the kernels only.

Each path prints the card memory it peaked at. `--paths a,b` drives only
those paths (and times only their steps), and `--phases timing --instances
a,b` times only those rollout instances: a partial run, with no result
line. It prints the card's name and power limit, a `kernels` JSON line, and,
when every phase ran, as its last line `{"ok": true, "device": {...}}`.
Any failure exits non-zero before that line. Without a CUDA card, or without the port beside this
file, it fails. Numbers are written to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
SEED = 0

# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores, and
# HBM3 bandwidth. The kernels here use no tensor cores.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# Main-path shapes (conf/solver/oc_base.yaml, conf/target/funnel.yaml,
# conf/model/lerp.yaml)
DIM, BATCH, STEPS, WIDTH, HIDDEN = 10, 2048, 200, 64, 2
GENERIC_WIDTH = 32  # a net outside the fast body's shapes
EVAL_BATCH = 100_000
EPS = 1e-3  # Sinkhorn eps (eval/sinkhorn.py default)
# DDS (conf/solver/dds.yaml, conf/loss/exponential_sde_lv.yaml): the cosine
# grid on [0, 12.8] at dt 0.05 (257 steps, the last ones of length 0)
DDS_GRID = dict(start=0.0, end=12.8, dt=0.05, rescale_t="cosine")
DDS_ALPHA, DDS_SIGMA = 1.0, 1.0
SHORT_STEPS, SHORT_EVAL = 20, 10_000  # the EulerDDS and PIS paths
# the host-bound paths, cut to fit the run's time limit: NICE's and the
# alanine dipeptide's 200 autograd scores a step, and the scan route
GIVEN_STEPS, SCAN_STEPS = 5, 10
# the paths of the solver x model compositions (model@generative_ctrl=...)
FORM_STEPS = 10
# the alanine dipeptide's batch and evaluation (results/r4/aladip_vacuum_dis)
ALADIP_BATCH, ALADIP_EVAL = 512, 4096
RAGGED_BATCH = 2047  # the tiled bodies' rows past the last full block

# Tolerances of kernel vs plain version, both float32 on the card:
# - rollout: the two sum the 64-wide products in another order (sequential
#   fma vs cuBLAS). One step from the same state differs by a few ulp:
#   |k - p| <= 1e-5 + 1e-5 |p|. Over 200 steps these differences compound
#   through the funnel score exp(-x0) and the expanding VP drift, so the
#   whole rollout is held to 1e-3 + 1e-3 |p|. Kernel 1's ScoreCtrl form and
#   kernel 2 (rollout_exp) run the same net and are held to the same
#   tolerances (the exponential integrator contracts, a < 1, so its errors
#   compound less than the VP drift's);
# - softmin: a 100k-term logsumexp at eps = 1e-3 (z up to 1e4, ulp 1e-3)
#   times eps, summed in another order: atol 1e-4 on values of order 1;
# - transport: a sum of 1e10 products, in float32 per row and column split
#   then in float64 (kernel) vs float32 rows then float64 (plain); the
#   kernel's log2-domain exponent carries about 1e-4 of random-signed error
#   into each plan entry, which averages out over the sum: rtol 1e-4.
TOL = {"rollout_step": (1e-5, 1e-5), "rollout": (1e-3, 1e-3),
       "softmin": (1e-4, 0.0), "transport": (0.0, 1e-4)}
# the transport kernel's distance from float64, relative, in the 100k funnel
# Sinkhorn at eps = 1e-3: float32 rounding of distances near 1e3, divided by
# eps and passed through the convex exp, biases every float32 form upwards
# (the kernel 1.1e-3 to 1.6e-3 above float64 in the readings of PERF.md §6)
TRANSPORT_F64_RTOL = 2e-3
# the wide body's transport (d > 16) from float64, relative, on the 10k
# clouds of the kernels phase: the sound kernel lay within 1.15e-5 of it
# (the plain float32 version within 2.4e-6), the kernels rejected in its
# design 1.8e-5 to 1.3e-4 from it (PERF.md §6, PR 14)
WIDE_TRANSPORT_F64_RTOL = 3e-5

KERNELS = ("rollout", "rollout_exp", "softmin", "transport")
REPLACES = {
    "rollout": "sde_sampler_tpu/ops/rollout_pallas.py:68",
    "rollout_exp": "sde_sampler_tpu/ops/rollout_pallas.py:229",
    "softmin": "sde_sampler_tpu/ops/sinkhorn_pallas.py:212",
    "transport": "sde_sampler_tpu/ops/sinkhorn_pallas.py:221",
}
SOURCES = {
    "rollout": "sde_sampler_torch/csrc/rollout.cuh",
    "rollout_exp": "sde_sampler_torch/csrc/rollout.cuh",
    "softmin": "sde_sampler_torch/csrc/sinkhorn.cu",
    "transport": "sde_sampler_torch/csrc/sinkhorn.cu",
}
# The paths of the main phase: target, solver, the kernels (by
# "<kernel>.<form>.<target>" for the rollouts) each must launch, its depth
# (None: the full --train-steps and --eval-batch), the log Z keys it is held
# to, and whether its rollout takes the generic body (mw_50d and the
# alanine dipeptide; NICE and Cox take the wide body). After 20
# steps the EulerDDS control is barely trained, and about a quarter of its
# evaluation trajectories reach rnd >= max_rnd (2389 of 10000 at seed 0 on
# an H100): there a single overflowing trajectory would make the plain LB
# means infinite, so the short paths are held to their finite means.
LOG_Z_KEYS = ["eval/log_norm_const_is", "eval/log_norm_const_lb", "eval/log_norm_const_lb_ito"]
FINITE_LOG_Z_KEYS = ["eval/log_norm_const_is", "eval/log_norm_const_lb_finite",
                     "eval/log_norm_const_lb_ito_finite"]
SINKHORN = ("softmin", "transport")
# the base net of conf/model/base/densenet.yaml in place of the FourierMLP
DENSENET = "model/base@base_model=densenet"
DENSE_ARCH = (200, 200)
# a score net of d outputs for a model whose config has one
TIME_EMBED_DIM = "model/base@generative_ctrl.score_model=time_embed_dim"
# the Sinkhorn kernels' wide body (d > 16), which the paths of d > 16 take
# for every launch and no other path takes
WIDE_SINKHORN = ("softmin.wide", "transport.wide")
PATHS = {
    "dis": dict(target="funnel", solver="dis", kernels=("rollout.lerp.funnel", *SINKHORN),
                steps=None, eval=None, log_z=LOG_Z_KEYS),
    "dds": dict(target="funnel", solver="dds", kernels=("rollout_exp.score.funnel", *SINKHORN),
                steps=None, eval=None, log_z=LOG_Z_KEYS),
    "dds_euler": dict(target="funnel", solver="dds_euler", kernels=("rollout.score.funnel",),
                      steps=SHORT_STEPS, eval=SHORT_EVAL, log_z=FINITE_LOG_Z_KEYS),
    "pis": dict(target="funnel", solver="pis", kernels=("rollout.score.funnel",),
                steps=SHORT_STEPS, eval=SHORT_EVAL, log_z=FINITE_LOG_Z_KEYS),
    "gmm_dis": dict(target="gmm", solver="dis", kernels=("rollout.lerp.gmm", *SINKHORN),
                    steps=None, eval=None, log_z=LOG_Z_KEYS),
    # conf/model/base/densenet.yaml's net ([200, 200], ReLU): kernel 1's
    # DenseNet body, its weights resident in shared memory, once a step
    # (held to the finite log Z means: a fresh net's overflowing
    # trajectories would make the plain means infinite)
    "gmm_dis_densenet": dict(target="gmm", solver="dis", overrides=[DENSENET],
                             kernels=("rollout.lerp.gmm.dense", *SINKHORN), steps=None,
                             eval=None, log_z=FINITE_LOG_Z_KEYS),
    "mw_dds": dict(target="mw", solver="dds", kernels=("rollout_exp.score.wells", *SINKHORN),
                   steps=SHORT_STEPS, eval=SHORT_EVAL, log_z=FINITE_LOG_Z_KEYS),
    "mw_50d_dis": dict(target="mw_50d", solver="dis",
                       kernels=("rollout.lerp.wells", *SINKHORN, *WIDE_SINKHORN),
                       steps=SHORT_STEPS, eval=SHORT_EVAL, log_z=FINITE_LOG_Z_KEYS,
                       generic=True),
    "dw_shift_pis": dict(target="dw_shift", solver="pis",
                         kernels=("rollout.score.wells", *SINKHORN),
                         steps=SHORT_STEPS, eval=SHORT_EVAL, log_z=FINITE_LOG_Z_KEYS),
    "gmm_dis_no_score": dict(target="gmm", solver="dis_no_score",
                             kernels=("rollout.clipped.none", *SINKHORN),
                             steps=SHORT_STEPS, eval=SHORT_EVAL, log_z=FINITE_LOG_Z_KEYS),
    "gmm_bridge_diff_init": dict(target="gmm", solver="bridge_diff_init",
                                 kernels=("rollout.lerp.gmm", *SINKHORN),
                                 steps=None, eval=None, log_z=LOG_Z_KEYS),
    "gmm_bridge": dict(target="gmm", solver="bridge", kernels=("rollout.lerp_target.gmm", *SINKHORN),
                       steps=SHORT_STEPS, eval=SHORT_EVAL, log_z=FINITE_LOG_Z_KEYS),
    "gmm_dis_subtraj": dict(target="gmm", solver="dis_subtraj",
                            kernels=("rollout.potential.none", *SINKHORN),
                            steps=None, eval=None, log_z=LOG_Z_KEYS, subtraj=True),
    "gmm_bridge_subtraj": dict(target="gmm", solver="bridge_subtraj",
                               kernels=("rollout.potential.none", *SINKHORN),
                               steps=SHORT_STEPS, eval=SHORT_EVAL, log_z=FINITE_LOG_Z_KEYS,
                               subtraj=True),
    # SubtrajBridge at d = 50 (mw_50d, the widest shipped target with a
    # domain): the potential form's generic body, once per optimizer step
    "mw_50d_dis_subtraj": dict(target="mw_50d", solver="dis_subtraj",
                               kernels=("rollout.potential.none", *SINKHORN, *WIDE_SINKHORN),
                               steps=SHORT_STEPS, eval=SHORT_EVAL, log_z=FINITE_LOG_Z_KEYS,
                               subtraj=True, generic=True),
    # the rings have no sampler (no Sinkhorn); their LB means are held to
    # their finite means, as the short paths' are
    "rings_dis": dict(target="rings", solver="dis", kernels=("rollout.lerp.rings",),
                      steps=None, eval=None, log_z=FINITE_LOG_Z_KEYS, sinkhorn=False),
    "img_dis": dict(target="img", solver="dis", kernels=("rollout.lerp.img", *SINKHORN),
                    steps=None, eval=None, log_z=LOG_Z_KEYS),
    # the given-score form: kernel 1 once per EM step (per_step), after the
    # target's score; Cox has no sampler (no Sinkhorn)
    "cox_dis": dict(target="cox", solver="dis",
                    overrides=["target.use_whitened=True", "~eval_sample_losses"],
                    kernels=("rollout.lerp.given.wide",), steps=SHORT_STEPS, eval=SHORT_EVAL,
                    log_z=FINITE_LOG_Z_KEYS, sinkhorn=False, per_step="rollout.lerp.given"),
    "nice_smooth_dis": dict(target="nice_smooth", solver="dis",
                            kernels=("rollout.lerp.given.wide", *SINKHORN, *WIDE_SINKHORN),
                            steps=GIVEN_STEPS, eval=SHORT_EVAL, log_z=FINITE_LOG_Z_KEYS,
                            per_step="rollout.lerp.given"),
    "rosenbrock_dis": dict(target="rosenbrock", solver="dis",
                           kernels=("rollout.lerp.rosenbrock",), steps=SHORT_STEPS,
                           eval=SHORT_EVAL, log_z=FINITE_LOG_Z_KEYS, sinkhorn=False,
                           extra_keys=["eval/obj_avg", "eval/avg_obj", "eval/min_obj"]),
    "gmm_dds_euler_langevin_init": dict(
        target="gmm", solver="dds_euler", overrides=["model@generative_ctrl=langevin_init"],
        kernels=("rollout.cancel_drift.gmm", *SINKHORN), steps=SHORT_STEPS, eval=SHORT_EVAL,
        log_z=FINITE_LOG_Z_KEYS),
    # the alanine dipeptide (d = 60) at the batch of its TPU run
    # (results/r4/aladip_vacuum_dis): the given-score form in the generic
    # body, 200 launches a step after the force field's autograd score; a
    # Sinkhorn at 4096 against draws from the validation set
    "aladip_vacuum_dis": dict(target="aladip_vacuum", solver="dis",
                              overrides=[f"train_batch_size={ALADIP_BATCH}"],
                              kernels=("rollout.lerp.given", *SINKHORN, *WIDE_SINKHORN),
                              steps=GIVEN_STEPS, eval=ALADIP_EVAL, log_z=FINITE_LOG_Z_KEYS,
                              generic=True, per_step="rollout.lerp.given"),
    # score nets of one output per coordinate (conf/model/lerp_dim.yaml,
    # score_dim.yaml): the per-coordinate instances of kernels 1 and 2
    "funnel_dis_lerp_dim": dict(target="funnel", solver="dis",
                                overrides=["model@generative_ctrl=lerp_dim"],
                                kernels=("rollout.lerp.dim", *SINKHORN), steps=SHORT_STEPS,
                                eval=SHORT_EVAL, log_z=FINITE_LOG_Z_KEYS),
    "funnel_pis_score_dim": dict(target="funnel", solver="pis",
                                 overrides=["model@generative_ctrl=score_dim"],
                                 kernels=("rollout.score.dim",), steps=SHORT_STEPS,
                                 eval=SHORT_EVAL, log_z=FINITE_LOG_Z_KEYS),
    "funnel_dds_score_dim": dict(target="funnel", solver="dds",
                                 overrides=["model@generative_ctrl=score_dim"],
                                 kernels=("rollout_exp.score.dim", *SINKHORN), steps=SHORT_STEPS,
                                 eval=SHORT_EVAL, log_z=FINITE_LOG_Z_KEYS),
    # the DenseNet body at d = 50 (its weights streamed: `streamed`) and
    # under kernel 2
    "mw_50d_dis_densenet": dict(target="mw_50d", solver="dis", overrides=[DENSENET],
                                kernels=("rollout.lerp.wells.dense", *SINKHORN, *WIDE_SINKHORN),
                                steps=SHORT_STEPS, eval=SHORT_EVAL, log_z=FINITE_LOG_Z_KEYS,
                                streamed=True),
    "funnel_dds_densenet": dict(target="funnel", solver="dds", overrides=[DENSENET],
                                kernels=("rollout_exp.score.funnel.dense", *SINKHORN),
                                steps=SHORT_STEPS, eval=SHORT_EVAL, log_z=FINITE_LOG_Z_KEYS),
    # and kernel 1's other forms over it: the PIS ScoreCtrl, the
    # ClippedCtrl, the Bridge's LerpTargetCtrl, the CancelDriftCtrl, and
    # NICE's given score (d = 196, streamed; 200 launches a step)
    "funnel_pis_densenet": dict(target="funnel", solver="pis", overrides=[DENSENET],
                                kernels=("rollout.score.funnel.dense",), steps=SHORT_STEPS,
                                eval=SHORT_EVAL, log_z=FINITE_LOG_Z_KEYS),
    "gmm_dis_no_score_densenet": dict(target="gmm", solver="dis_no_score", overrides=[DENSENET],
                                      kernels=("rollout.clipped.none.dense", *SINKHORN),
                                      steps=SHORT_STEPS, eval=SHORT_EVAL,
                                      log_z=FINITE_LOG_Z_KEYS),
    "gmm_bridge_densenet": dict(target="gmm", solver="bridge", overrides=[DENSENET],
                                kernels=("rollout.lerp_target.gmm.dense", *SINKHORN),
                                steps=SHORT_STEPS, eval=SHORT_EVAL, log_z=FINITE_LOG_Z_KEYS),
    "gmm_dds_euler_langevin_init_densenet": dict(
        target="gmm", solver="dds_euler", overrides=["model@generative_ctrl=langevin_init", DENSENET],
        kernels=("rollout.cancel_drift.gmm.dense", *SINKHORN), steps=SHORT_STEPS, eval=SHORT_EVAL,
        log_z=FINITE_LOG_Z_KEYS),
    "nice_smooth_dis_densenet": dict(target="nice_smooth", solver="dis", overrides=[DENSENET],
                                     kernels=("rollout.lerp.given.dense", *SINKHORN,
                                              *WIDE_SINKHORN),
                                     steps=GIVEN_STEPS, eval=SHORT_EVAL, log_z=FINITE_LOG_Z_KEYS,
                                     per_step="rollout.lerp.given.dense", streamed=True),
    # a solver composed with another model (model@generative_ctrl=...), each
    # once a step on kernel 1 (`once`: the PIS and Bridge paths checked as
    # the DIS ones are), FORM_STEPS steps: the LerpPriorCtrl
    # form (with a score net of d outputs, and over the DenseNet), the
    # LerpCtrl over PIS's Delta prior on its scaled BM, the ScoreCtrl under
    # the time-reversal loss's VP, and the per-coordinate LerpTargetCtrl and
    # CancelDriftCtrl instances
    "gmm_dis_lerp_prior": dict(target="gmm", solver="dis",
                               overrides=["model@generative_ctrl=lerp_prior"],
                               kernels=("rollout.lerp_prior.none", *SINKHORN), steps=FORM_STEPS,
                               eval=SHORT_EVAL, log_z=FINITE_LOG_Z_KEYS),
    "gmm_dis_lerp_prior_dim": dict(
        target="gmm", solver="dis",
        overrides=["model@generative_ctrl=lerp_prior", TIME_EMBED_DIM],
        kernels=("rollout.lerp_prior.dim", *SINKHORN), steps=FORM_STEPS, eval=SHORT_EVAL,
        log_z=FINITE_LOG_Z_KEYS),
    "gmm_dis_lerp_prior_densenet": dict(
        target="gmm", solver="dis", overrides=["model@generative_ctrl=lerp_prior", DENSENET],
        kernels=("rollout.lerp_prior.none.dense", *SINKHORN), steps=FORM_STEPS, eval=SHORT_EVAL,
        log_z=FINITE_LOG_Z_KEYS),
    "gmm_pis_lerp": dict(target="gmm", solver="pis", overrides=["model@generative_ctrl=lerp"],
                         kernels=("rollout.lerp.gmm", *SINKHORN), steps=FORM_STEPS,
                         eval=SHORT_EVAL, log_z=FINITE_LOG_Z_KEYS, once=True),
    "gmm_dis_score": dict(target="gmm", solver="dis", overrides=["model@generative_ctrl=score"],
                          kernels=("rollout.score.gmm", *SINKHORN), steps=FORM_STEPS,
                          eval=SHORT_EVAL, log_z=FINITE_LOG_Z_KEYS),
    "gmm_bridge_lerp_dim": dict(target="gmm", solver="bridge",
                                overrides=["model@generative_ctrl=lerp_dim"],
                                kernels=("rollout.lerp_target.dim", *SINKHORN), steps=FORM_STEPS,
                                eval=SHORT_EVAL, log_z=FINITE_LOG_Z_KEYS, once=True),
    "gmm_dis_langevin_init_dim": dict(
        target="gmm", solver="dis",
        overrides=["model@generative_ctrl=langevin_init", TIME_EMBED_DIM],
        kernels=("rollout.cancel_drift.dim", *SINKHORN), steps=FORM_STEPS, eval=SHORT_EVAL,
        log_z=FINITE_LOG_Z_KEYS),
    # the untrained Langevin solver: no training, no log Z; its own config's
    # chains (6000, the Sinkhorn's n) unless cut
    "gmm_langevin": dict(target="gmm", solver="langevin", kernels=SINKHORN, langevin=True),
    "rings_langevin_heun": dict(target="rings", solver="langevin", kernels=(), langevin=True,
                                sinkhorn=False,
                                overrides=["integrator=torchsde_heun", "eval_batch_size=500",
                                           "sde.terminal_t=1"]),
    # phase 1 through the scan route (`scan`): a base net without a kernel
    # body, and exploration of the sde control; the evaluation's Sinkhorn
    # through the kernels
    "funnel_dis_explore": dict(target="funnel", solver="dis",
                               overrides=["loss.sde_ctrl_noise=0.1", "loss.sde_ctrl_dropout=0.5"],
                               kernels=SINKHORN, steps=SCAN_STEPS, eval=SHORT_EVAL,
                               log_z=FINITE_LOG_Z_KEYS, scan=True),
    "funnel_dds_explore": dict(target="funnel", solver="dds",
                               overrides=["loss.sde_ctrl_noise=0.1"], kernels=SINKHORN,
                               steps=SCAN_STEPS, eval=SHORT_EVAL, log_z=FINITE_LOG_Z_KEYS,
                               scan=True),
    "gmm_pis_multilevel": dict(
        target="gmm", solver="pis",
        overrides=["generative_ctrl.base_model._target_=sde_sampler_tpu.models.mlp.MultilevelNet",
                   "~generative_ctrl.base_model.num_layers",
                   "~generative_ctrl.base_model.channels"],
        kernels=SINKHORN, steps=SCAN_STEPS, eval=SHORT_EVAL, log_z=FINITE_LOG_Z_KEYS, scan=True),
}
# the paths whose phase 1 takes the scan route
SCAN_PATHS = [path for path, spec in PATHS.items() if spec.get("scan")]
POTENTIAL_SOURCE = "sde_sampler_torch/csrc/rollout_potential.cu"
# The rollout instances beyond the funnel's, each checked against its plain
# twin and timed at the shapes of the path that runs it (gmm_dis,
# gmm_dis_no_score, dw_shift_pis, mw_dds, mw_50d_dis, gmm_bridge,
# gmm_dis_subtraj, mw_50d_dis_subtraj, rings_dis, rosenbrock_dis,
# gmm_dds_euler_langevin_init):
# label (the kernels line's name) -> control form ("exp": kernel 2's) and
# target (conf/target/*.yaml); `bodies`: also checked in the generic body,
# which must give the fast body's bits; `source`: where the form's kernels
# live, if not in rollout.cuh; `key`: the launch counter (ops/build.py's
# FORM_LAUNCHES) that counts it on its paths, if not its label, and that
# its own check must raise; `seed`: its inputs' seed, if not its place in
# the list's; `sde`: its path's SDE (seeded_instance), if not its form's.
# Its prior, which the lerp forms' control also reads, is PIS's Delta (x0 =
# 0) on PIS's scaled BM, else N(0, I).
INSTANCES = {
    "rollout.lerp.gmm": dict(form="lerp", target="gmm", paths=("gmm_dis", "gmm_bridge_diff_init")),
    "rollout.clipped.none": dict(form="clipped", target="gmm"),
    "rollout.score.wells": dict(form="score", target="dw_shift"),
    "rollout_exp.score.wells": dict(form="exp", target="mw"),
    "rollout.lerp.wells": dict(form="lerp", target="mw_50d"),
    "rollout.lerp_target.gmm": dict(form="lerp_target", target="gmm", bodies=True),
    "rollout.potential.none": dict(form="potential", target="gmm", bodies=True,
                                   paths=("gmm_dis_subtraj", "gmm_bridge_subtraj"),
                                   source=POTENTIAL_SOURCE),
    "rollout.lerp.rings": dict(form="lerp", target="rings", bodies=True),
    "rollout.lerp.rosenbrock": dict(form="lerp", target="rosenbrock", bodies=True),
    "rollout.cancel_drift.gmm": dict(form="cancel_drift", target="gmm", bodies=True),
    "rollout.lerp.img": dict(form="lerp", target="img", bodies=True),
    # the given-score form: at NICE's d = 196 the wide body by shape, and
    # the generic body, whose bits it must give; at Cox's d = 1600 the wide
    # body by shape (its launches count NICE's too)
    "rollout.lerp.given": dict(form="lerp", target="nice_smooth", wide_bits=True),
    # (the configs' last layers: small, the score net's bias 1; the seeded
    # net's full-size last layers drive the states out of the posterior,
    # where exp(latent) overflows float32 and both the kernel and its twin
    # give NaN, within 110 of the 200 steps)
    "rollout.lerp.given.wide": dict(form="lerp", target="cox",
                                    target_kwargs={"use_whitened": True}, config_last=True),
    # the alanine dipeptide's given score at d = 60 and its batch (the
    # generic body; the configs' last layers, as Cox's); it counts the
    # launches of "rollout.lerp.given" on its own path only
    "rollout.lerp.given.d60": dict(form="lerp", target="aladip_vacuum", batch=ALADIP_BATCH,
                                   key="rollout.lerp.given", paths=("aladip_vacuum_dis",),
                                   config_last=True),
    # a score net of d outputs (the per-coordinate sscore): the lerp form in
    # both bodies, kernel 1's score form and kernel 2's, on the funnel; each
    # also with all its rows equal, which must give the one-output bits
    "rollout.lerp.dim": dict(form="lerp", target="funnel", bodies=True, score_dim=True),
    "rollout.score.dim": dict(form="score", target="funnel", score_dim=True),
    "rollout_exp.score.dim": dict(form="exp", target="funnel", score_dim=True),
    # the PotentialCtrl at mw_50d's d = 50, the generic body by shape, whose
    # launches on mw_50d_dis_subtraj it counts (`seed`: the inputs of its
    # checks before it was an instance)
    "rollout.potential.none.d50": dict(form="potential", target="mw_50d", seed=SEED + 40,
                                       key="rollout.potential.generic",
                                       paths=("mw_50d_dis_subtraj",), source=POTENTIAL_SOURCE),
    # the DenseNet body (`net`: conf/model/base/densenet.yaml's net), each
    # at its path's shapes: resident at d = 2 and 10 (`dense_bodies`: also
    # streamed, which must give the same bits), streamed at d = 50 and for
    # the given score at d = 196, there on the whitened Cox process at
    # NICE's d (the configs' last layers, as the FourierMLP's); it counts
    # the launches of its NICE path. On NICE this control keeps the states
    # where the flow's score carries a one-ulp change of x0 to about 0.1 in
    # 200 steps, in the plain twin against itself
    # (`scripts/rollout_sensitivity.py`), so no two float32 rollouts agree
    # there to TOL
    "rollout.lerp.gmm.dense": dict(form="lerp", target="gmm", net="dense", dense_bodies=True),
    "rollout.score.funnel.dense": dict(form="score", target="funnel", net="dense"),
    "rollout_exp.score.funnel.dense": dict(form="exp", target="funnel", net="dense",
                                           dense_bodies=True),
    "rollout.lerp.wells.dense": dict(form="lerp", target="mw_50d", net="dense"),
    "rollout.lerp.given.dense": dict(form="lerp", target="cox", net="dense", config_last=True,
                                     target_kwargs={"use_whitened": True, "dim": 196},
                                     paths=("nice_smooth_dis_densenet",)),
    "rollout.clipped.none.dense": dict(form="clipped", target="gmm", net="dense"),
    "rollout.lerp_target.gmm.dense": dict(form="lerp_target", target="gmm", net="dense"),
    "rollout.cancel_drift.gmm.dense": dict(form="cancel_drift", target="gmm", net="dense"),
    # the forms of the solver x model compositions, at their paths' shapes:
    # the LerpPriorCtrl in both bodies, with a score net of d outputs (both
    # bodies; equal rows give the one-output bits) and over the DenseNet;
    # the LerpCtrl over PIS's Delta prior on its scaled BM from the Dirac
    # (it counts the launches of rollout.lerp.gmm on its path); the
    # LerpTargetCtrl and CancelDriftCtrl with score nets of d outputs; the
    # ScoreCtrl on the mixture under the time-reversal loss's VP
    "rollout.lerp_prior.none": dict(form="lerp_prior", target="gmm", bodies=True),
    "rollout.lerp_prior.dim": dict(form="lerp_prior", target="gmm", bodies=True,
                                   score_dim=True),
    "rollout.lerp_prior.none.dense": dict(form="lerp_prior", target="gmm", net="dense"),
    "rollout.lerp.gmm.delta": dict(form="lerp", target="gmm", sde="bm_pis",
                                   key="rollout.lerp.gmm", paths=("gmm_pis_lerp",)),
    "rollout.lerp_target.dim": dict(form="lerp_target", target="gmm", bodies=True,
                                    score_dim=True),
    "rollout.cancel_drift.dim": dict(form="cancel_drift", target="gmm", bodies=True,
                                     score_dim=True),
    "rollout.score.gmm": dict(form="score", target="gmm", sde="vp", bodies=True,
                              paths=("gmm_dis_score",)),
    # the Sinkhorn kernels' wide body (d > 16: mw_50d, the alanine dipeptide,
    # NICE), checked at 10k and timed at 100k x 100k, d = 50
    "softmin.wide": dict(sinkhorn=True),
    "transport.wide": dict(sinkhorn=True),
}
# the NICE and Cox instance of the given score counts its launches on
# their paths
INSTANCES["rollout.lerp.given"]["paths"] = ("nice_smooth_dis", "cox_dis")
ROLLOUT_INSTANCES = [label for label, spec in INSTANCES.items() if not spec.get("sinkhorn")]
# the PERF.md §6 rows of the tiled bodies: their plans are printed with their times
TILED_ROWS = {"rollout.lerp.wells": "row 1d", "rollout.lerp.given": "row 1k",
              "rollout.lerp.given.wide": "row 1l", "rollout.lerp.given.d60": "row 1o",
              "rollout.potential.none.d50": "row 1f",
              **{label: "row 1p" if label.startswith("rollout.") else "row 4c"
                 for label, spec in INSTANCES.items() if spec.get("net") == "dense"}}


def timed(fn):
    """fn()'s result and its card ms, one call between CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean ms of fn() over reps, by CUDA events after warmup calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def rollout_work(B, T, d, C, H, per_coord=25, K=0, potential=False, table=0, given=False,
                 score_dim=False, dense=None):
    # multiply-adds of the net (2 flops each), GELU with erf (~10 flops per
    # activation) and `per_coord` flops of score and update per coordinate
    # (about 25 for the LerpCtrl EM step, 20 for the ScoreCtrl exponential
    # integrator: funnel score 8, clips and score term 4, update 4, exp 4;
    # FORM_FLOPS + TARGET_FLOPS for the other instances).
    # A mixture of K components adds its row phase, per row and component
    # 3d flops for the log-weight and about 10 for the softmax (exp 4, max,
    # sum, division), and 3K flops per coordinate for the score's sum; its
    # table, K (2d + 1) floats, is read once.
    # The PotentialCtrl's net has one output, and its backward pass runs the
    # transposed products again (2C(HC + d) flops), the products with
    # gelu' (C(H + 1)) and GELU's derivative beside GELU (about 8 more flops
    # per activation: exp and four multiply-adds).
    # A target table of `table` floats (the image's energy) is read once; a
    # given score, (B, d) a step, is an input of every step; a score net of
    # d outputs adds its (T, d) table of per-coordinate scales.
    # A DenseNet of hidden widths `dense` (C and H unused) does sum_l K_l N_l
    # multiply-adds a row and step, layer l reading K_l = d + sum of the
    # widths before it (its t column tabulated) and writing N_l (d for the
    # out layer), and a ReLU per hidden activation; it reads its weights
    # once and its t table, (T, sum of the widths + d).
    n_out = 1 if potential else d
    if dense is not None:
        macs = sum((d + sum(dense[:l])) * n for l, n in enumerate((*dense, d)))
        net = 2 * macs + sum(dense)
        weights = macs + T * (sum(dense) + d)
    else:
        net = 2 * C * (d + H * C + n_out) + 10 * C * (H + 1)
        weights = T * C + C * d + C * n_out + H * C * (C + 1) + n_out
    if potential:
        net += 2 * C * (H * C + d) + C * (H + 1) + 8 * C * (H + 1)
    ops = T * B * (net + per_coord * d + K * (3 * d + 10) + 3 * K * d)
    nbytes = 4 * (B * d + T * B * d + T * 6 + weights
                  + T * B * d + B * d + K * (2 * d + 1) + table + (T * B * d if given else 0)
                  + (T * d if score_dim else 0))
    return ops, nbytes


def pair_work(n, m, d, per_pair, n_out):
    # about 3d + per_pair float32 operations per (i, j) pair; x, y and one
    # dual per point read once, n_out floats written
    return n * m * (3 * d + per_pair), 4 * (n * d + m * d + n + m + n_out)


def seeded_ctrl(device, width=WIDTH):
    """The main-path control stack with weights drawn from a numpy seed."""
    import numpy as np
    import torch

    from sde_sampler_torch.distr.funnel import Funnel
    from sde_sampler_torch.distr.gauss import IsotropicGauss
    from sde_sampler_torch.eq.sdes import VP
    from sde_sampler_torch.models.mlp import FourierMLP, TimeEmbed
    from sde_sampler_torch.models.reparam import LerpCtrl

    prior = IsotropicGauss(dim=DIM, truncate_quartile=1e-4).to(device)
    target = Funnel(dim=DIM, n_reference_samples=1000).to(device)
    sde = VP(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0, terminal_t=1.0)
    ctrl = LerpCtrl(
        base_model=FourierMLP(dim=DIM, num_layers=HIDDEN + 2, channels=width),
        score_model=TimeEmbed(dim_out=1, num_layers=4, channels=width),
        sde=sde, prior_score=prior.score, target_score=target.score,
        clip_model=10.0, clip_score=10.0, detach_score=False,
    )
    rng = np.random.default_rng(SEED)
    with torch.no_grad():
        for p in ctrl.parameters():
            b = 1.0 / math.sqrt(p.shape[-1]) if p.ndim == 2 else 0.1
            p.copy_(torch.from_numpy(rng.uniform(-b, b, p.shape).astype(np.float32)))
    return ctrl.to(device), rng


def seeded_score_ctrl(device, seed):
    """The ScoreCtrl of the DDS, EulerDDS and PIS paths (conf/model/score.yaml,
    clips 10/10), with weights drawn from a numpy seed."""
    import numpy as np
    import torch

    from sde_sampler_torch.distr.funnel import Funnel
    from sde_sampler_torch.models.mlp import FourierMLP, TimeEmbed
    from sde_sampler_torch.models.reparam import ScoreCtrl

    target = Funnel(dim=DIM, n_reference_samples=1000).to(device)
    ctrl = ScoreCtrl(
        base_model=FourierMLP(dim=DIM, num_layers=HIDDEN + 2, channels=WIDTH),
        score_model=TimeEmbed(dim_out=1, num_layers=4, channels=WIDTH),
        target_score=target.score, clip_model=10.0, clip_score=10.0, detach_score=False,
    )
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in ctrl.parameters():
            b = 1.0 / math.sqrt(p.shape[-1]) if p.ndim == 2 else 0.1
            p.copy_(torch.from_numpy(rng.uniform(-b, b, p.shape).astype(np.float32)))
    return ctrl.to(device), rng


def dds_inputs(device, rng):
    """The DDS grid, prior samples and standard-normal noise."""
    import numpy as np
    import torch

    from sde_sampler_torch.utils.common import get_timesteps

    ts = get_timesteps(**DDS_GRID, device=device)
    T = ts.shape[0] - 1
    x0 = torch.from_numpy(rng.standard_normal((BATCH, DIM)).astype(np.float32)).to(device)
    noise = torch.from_numpy(rng.standard_normal((T, BATCH, DIM)).astype(np.float32)).to(device)
    return x0, ts, noise


def conf_target(name: str, device, **kwargs):
    """A target as conf/target/<name>.yaml configures it (its `target` node
    where the file is a global package), with `kwargs` set."""
    import yaml

    from sde_sampler_torch.utils.config import instantiate

    cfg = yaml.safe_load((ROOT / "conf" / "target" / f"{name}.yaml").read_text())
    cfg = cfg.get("target", cfg)
    return instantiate({**cfg, **kwargs}).to(device)


# flops of a form's control and update, and of a target's inline score, per
# coordinate (rollout_work); a mixture's are counted by its K
FORM_FLOPS = {"lerp": 17, "lerp_target": 13, "score": 12, "exp": 12, "clipped": 8,
              "potential": 8, "cancel_drift": 17, "lerp_prior": 15}
# the rings: |x|, the nearest of 3 radii and the score, about 12 a
# coordinate at d = 2; the Rosenbrock's score of both neighbours, 14; the
# image: the pixel's multiply-add, cast and clips, two differences and
# products, about 8 a coordinate; a given score is read, not computed
TARGET_FLOPS = {"funnel": 8, "wells": 6, "gmm": 0, "none": 0, "rings": 12, "rosenbrock": 14,
                "img": 8, "given": 0}


def seeded_instance(device, label, seed, dim=None, batch=None, prior=None):
    """A rollout instance of INSTANCES at its path's shapes, with weights and
    inputs from a numpy seed: the path's control (conf/model/*.yaml, clips
    10/10), SDE (SDES) and grid, x0 from its prior (0 for PIS's Delta).
    Returns (run, plain, prepare, x0, ts, noise, work), run, plain and
    prepare (the checked inputs and tables of a launch) taking (x0, ts,
    noise). `dim` replaces the target's dimension for a form without a
    target (the PotentialCtrl), `batch` the path's batch, `prior` the lerp
    forms' prior (a Gauss; x0 stays N(0, I))."""
    import numpy as np
    import torch

    from sde_sampler_torch.distr.delta import Delta
    from sde_sampler_torch.distr.gauss import IsotropicGauss
    from sde_sampler_torch.eq.sdes import VP, ScaledBM
    from sde_sampler_torch.models.mlp import DenseNet, FourierMLP, TimeEmbed
    from sde_sampler_torch.models.reparam import (
        CancelDriftCtrl,
        ClippedCtrl,
        LerpCtrl,
        LerpPriorCtrl,
        LerpTargetCtrl,
        PotentialCtrl,
        ScoreCtrl,
    )
    from sde_sampler_torch.ops import rollout as ro
    from sde_sampler_torch.utils.common import get_timesteps

    spec = INSTANCES[label]
    form = spec["form"]
    target = conf_target(spec["target"], device, **spec.get("target_kwargs", {}))
    d = dim or target.dim
    dense = DENSE_ARCH if spec.get("net") == "dense" else None
    if dense is not None:  # conf/model/base/densenet.yaml
        base = DenseNet(dim=d, arch=dense, activation="relu")
    else:
        base = FourierMLP(dim=d, num_layers=HIDDEN + 2, channels=WIDTH,
                          dim_out=1 if form == "potential" else None)
    score_net = lambda bias: TimeEmbed(dim_out=d if spec.get("score_dim") else 1, num_layers=4,
                                       channels=WIDTH, last_bias_init={"constant": bias})
    clips = {"clip_model": 10.0, "clip_score": 10.0}
    # the path's SDE (conf/sde/*.yaml: vp_10, the Bridge's bm, PIS's scaled
    # BM, the ScoreCtrl's default; DDS's exponential integrator takes none)
    # and prior
    sdes = {"vp": lambda: VP(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0, terminal_t=1.0),
            "bm": lambda: ScaledBM(diff_coeff=1.0, terminal_t=1.0),
            "bm_pis": lambda: ScaledBM(diff_coeff=0.4472135954999579, terminal_t=5.0)}
    sde_name = spec.get("sde", {"lerp_target": "bm", "score": "bm_pis"}.get(form, "vp"))
    sde = None if form == "exp" else sdes[sde_name]()
    delta = sde_name == "bm_pis"
    if prior is None:
        prior = Delta(dim=d) if delta else IsotropicGauss(dim=d)
    prior = prior.to(device)
    if form in ("lerp", "lerp_prior"):
        cls = LerpCtrl if form == "lerp" else LerpPriorCtrl
        ctrl = cls(base_model=base, score_model=score_net(1.0), sde=sde, prior_score=prior.score,
                   target_score=target.score, **clips)
    elif form == "lerp_target":  # solver=bridge
        ctrl = LerpTargetCtrl(base_model=base, score_model=score_net(1.0), sde=sde,
                              target_score=target.score, **clips)
    elif form in ("clipped", "potential"):  # conf/model/{clipped,potential}.yaml
        cls = ClippedCtrl if form == "clipped" else PotentialCtrl
        ctrl = cls(base_model=base, clip_model=10.0, sde=sde)
    elif form == "cancel_drift":  # dds_euler + conf/model/langevin_init.yaml
        ctrl = CancelDriftCtrl(base_model=base, score_model=score_net(1.0), sde=sde,
                               target_score=target.score, langevin_init=True, **clips)
    else:
        ctrl = ScoreCtrl(base_model=base, score_model=score_net(0.01),
                         target_score=target.score, **clips)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in ctrl.parameters():
            b = 1.0 / math.sqrt(p.shape[-1]) if p.ndim == 2 else 0.1
            p.copy_(torch.from_numpy(rng.uniform(-b, b, p.shape).astype(np.float32)))
        if spec.get("config_last"):  # near conf/model/lerp.yaml's initial control
            for layer in (base.out_layer, ctrl.score_model.out_layer):
                layer.weight.mul_(0.05)
                layer.bias.mul_(0.05)
            ctrl.score_model.out_layer.bias.fill_(1.0)
    ctrl = ctrl.to(device)
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    if form == "exp":
        ts = get_timesteps(**DDS_GRID, device=device)
    else:
        ts = torch.linspace(0.0, sde.terminal_t, STEPS + 1, device=device)
    T = ts.shape[0] - 1
    batch = batch or spec.get("batch", BATCH)
    x0 = f(rng.standard_normal((batch, d)) * (0.0 if delta else 1.0))
    noise = f(rng.standard_normal((T, batch, d)))
    if form == "exp":
        run = lambda x, t, n: ro.fused_rollout_exp(ctrl, x, t, n, DDS_ALPHA, DDS_SIGMA, clips)
        plain = lambda x, t, n: ro.rollout_exp_plain(ctrl, x, t, n, DDS_ALPHA, DDS_SIGMA, clips)
        prepare = lambda x, t, n: ro._prepare(ctrl, x, t, n, clips, exp=(DDS_ALPHA, DDS_SIGMA))
    else:
        noise *= torch.sqrt(ts[1:] - ts[:-1])[:, None, None]
        pass_sde = sde if form == "score" else None
        run = lambda x, t, n: ro.fused_rollout(ctrl, x, t, n, clips, sde=pass_sde)
        plain = lambda x, t, n: ro.rollout_plain(ctrl, x, t, n, clips, sde=pass_sde)
        prepare = lambda x, t, n: ro._prepare(ctrl, x, t, n, clips, pass_sde)
    prepared = prepare(x0, ts, noise)
    kind = prepared[1]["kind"]
    table = prepared[0][9].numel()
    K = table // (2 * d + 1) if kind == "gmm" else 0
    work = rollout_work(batch, T, d, WIDTH, HIDDEN,
                        per_coord=FORM_FLOPS[form] + TARGET_FLOPS[kind], K=K,
                        potential=form == "potential", table=table if kind == "img" else 0,
                        given=kind == "given", score_dim=bool(spec.get("score_dim")),
                        dense=dense)
    return run, plain, prepare, x0, ts, noise, work


def check_rollout(name, run, plain, x0, ts, noise, report_key, report, width=WIDTH):
    """A rollout kernel against its plain twin: one step from the twin's own
    states (no compounding) at five steps, then the whole rollout."""
    T = ts.shape[0] - 1
    xs_k, xT_k = run(x0, ts, noise)
    xs_p, xT_p = plain(x0, ts, noise)
    if not bool((xs_k[0] == x0).all()):
        fail(f"{name}: xs[0] != x0")
    step_err = 0.0
    for k in (0, T // 4, T // 2, 3 * T // 4, T - 1):
        _, x1 = run(xs_p[k].contiguous(), ts[k : k + 2], noise[k : k + 1])
        want = xT_p if k == T - 1 else xs_p[k + 1]
        ok, err = within(x1, want, *TOL["rollout_step"])
        step_err = max(step_err, err)
        if not ok:
            fail(f"{name} step {k} disagrees with its plain version: {err:.3e}")
        if float(ts[k + 1] - ts[k]) == 0.0 and not bool((x1 == xs_p[k]).all()):
            fail(f"{name}: the dt = 0 step {k} changed the state")
    atol, rtol = TOL["rollout"]
    ok1, e1 = within(xs_k, xs_p, atol, rtol)
    ok2, e2 = within(xT_k, xT_p, atol, rtol)
    marks = sorted({1, T // 20, T // 4, T // 2, 3 * T // 4, T - 1})
    growth = {k: "%.1e" % float((xs_k[k] - xs_p[k]).abs().max()) for k in marks}
    n_zero = int((ts[1:] == ts[:-1]).sum())
    print(f"kernel {name} (B {x0.shape[0]}, T {T}, d {x0.shape[1]}, width {width}"
          + (f", {n_zero} steps with dt = 0" if n_zero else "") + "): "
          f"max_abs_err {max(e1, e2):.3e} (atol {atol}, rtol {rtol}); one step "
          f"{step_err:.3e} (atol, rtol {TOL['rollout_step']}); max error by "
          f"step {growth}; max |x| {float(xs_p.abs().max()):.3g}", flush=True)
    if not (ok1 and ok2):
        fail(f"{name} disagrees with its plain version")
    report[report_key] = {"max_abs_err": max(e1, e2), "step_err": step_err}


def rollout_inputs(device, rng):
    import numpy as np
    import torch

    B, T = BATCH, STEPS
    ts = torch.linspace(0.0, 1.0, T + 1, device=device)
    x0 = torch.from_numpy(rng.standard_normal((B, DIM)).astype(np.float32)).to(device)
    dbs = torch.from_numpy(rng.standard_normal((T, B, DIM)).astype(np.float32)).to(device)
    dbs *= torch.sqrt(ts[1:] - ts[:-1])[:, None, None]
    return x0, ts, dbs


def pair_inputs(device, rng, n, d, n_inf):
    """Point clouds and the duals of one Sinkhorn iteration
    (so that the plan carries mass); the first n_inf duals are -inf."""
    import numpy as np
    import torch

    from sde_sampler_torch.ops.sinkhorn import softmin

    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    x = f(rng.standard_normal((n, d)))
    y = f(rng.standard_normal((n, d)) * 1.2 + 0.3)
    log_w = EPS * math.log(1.0 / n)
    v = torch.full((n,), log_w, device=device)
    u = log_w - softmin(x, y, v, EPS)
    v = log_w - softmin(y, x, u, EPS)
    u[:n_inf] = -math.inf
    v[:n_inf] = -math.inf
    return x, y, u, v


def within(got, want, atol, rtol) -> tuple[bool, float]:
    import torch

    err = (got - want).abs()
    both_inf = torch.isinf(got) & torch.isinf(want) & (got == want)
    err = torch.where(both_inf, 0.0, err)
    ok = bool((err <= atol + rtol * want.abs().where(~both_inf, 0.0)).all())
    return ok, float(err.max())


def phase_kernels(device, report):
    """Every kernel against its plain version on the card."""
    import torch

    from sde_sampler_torch.ops import rollout as ro
    from sde_sampler_torch.ops import sinkhorn as sk

    clips = {"clip_model": 10.0, "clip_score": 10.0}
    ctrl, rng = seeded_ctrl(device)
    x0, ts, dbs = rollout_inputs(device, rng)
    check_rollout(
        "rollout", lambda x, t, n: ro.fused_rollout(ctrl, x, t, n, clips),
        lambda x, t, n: ro.rollout_plain(ctrl, x, t, n, clips), x0, ts, dbs,
        "rollout", report)

    # kernel 1's ScoreCtrl form on the VP grid of EulerDDS
    score_ctrl, score_rng = seeded_score_ctrl(device, SEED + 1)
    x0s, _, dbs_s = rollout_inputs(device, score_rng)
    vp = ctrl.sde
    check_rollout(
        "rollout.score", lambda x, t, n: ro.fused_rollout(score_ctrl, x, t, n, clips, sde=vp),
        lambda x, t, n: ro.rollout_plain(score_ctrl, x, t, n, clips, sde=vp), x0s, ts,
        dbs_s, "rollout_score", report)
    r = report["rollout"]
    r["lerp_max_abs_err"] = r["max_abs_err"]
    r["score_max_abs_err"] = report.pop("rollout_score")["max_abs_err"]
    r["max_abs_err"] = max(r["lerp_max_abs_err"], r["score_max_abs_err"])

    # kernel 2 on the DDS cosine grid
    x0e, ts_e, noise = dds_inputs(device, score_rng)
    check_rollout(
        "rollout_exp",
        lambda x, t, n: ro.fused_rollout_exp(score_ctrl, x, t, n, DDS_ALPHA, DDS_SIGMA, clips),
        lambda x, t, n: ro.rollout_exp_plain(score_ctrl, x, t, n, DDS_ALPHA, DDS_SIGMA, clips),
        x0e, ts_e, noise, "rollout_exp", report)

    # kernel 1's generic body: a 32-wide net at the DIS shapes
    from sde_sampler_torch.ops import build

    generic_ctrl, generic_rng = seeded_ctrl(device, GENERIC_WIDTH)
    x0g, _, dbs_g = rollout_inputs(device, generic_rng)
    before = build.FORM_LAUNCHES["rollout.lerp.generic"]
    check_rollout(
        "rollout.generic",
        lambda x, t, n: ro.fused_rollout(generic_ctrl, x, t, n, clips),
        lambda x, t, n: ro.rollout_plain(generic_ctrl, x, t, n, clips), x0g, ts, dbs_g,
        "rollout_generic", report, width=GENERIC_WIDTH)
    if build.FORM_LAUNCHES["rollout.lerp.generic"] <= before:
        fail("a 32-wide net did not take kernel 1's generic body")
    r["generic_max_abs_err"] = report.pop("rollout_generic")["max_abs_err"]
    r["max_abs_err"] = max(r["max_abs_err"], r["generic_max_abs_err"])

    # the two bodies on the main path's shapes: the same sums in the same order
    prepared = ro._prepare(ctrl, x0, ts, dbs, clips)
    fast = ro._launch(prepared, "fast")
    slow = ro._launch(prepared, "generic")
    r["fast_vs_generic_body"] = max(float((a - b).abs().max()) for a, b in zip(fast, slow))
    print(f"kernel rollout: fast vs generic body at width {WIDTH}: max |diff| "
          f"{r['fast_vs_generic_body']:.3e}", flush=True)

    # the instances of the mixture, the wells, the ClippedCtrl and the
    # LerpTargetCtrl, each at its path's shapes
    for i, label in enumerate(ROLLOUT_INSTANCES):
        run, plain, prepare, x0i, tsi, noisei, _ = seeded_instance(
            device, label, INSTANCES[label].get("seed", SEED + 10 + i))
        # (a DenseNet instance's label is its launch counter)
        key = INSTANCES[label].get("key", label if INSTANCES[label].get("net") else None)
        before = build.FORM_LAUNCHES[key] if key else 0
        check_rollout(label, run, plain, x0i, tsi, noisei, label, report,
                      width=DENSE_ARCH if INSTANCES[label].get("net") else WIDTH)
        if key and build.FORM_LAUNCHES[key] <= before:
            fail(f"{label} was not counted as {key}")
        if INSTANCES[label].get("dense_bodies"):
            # the DenseNet body's weights resident and streamed: the same bits
            prepared = prepare(x0i, tsi, noisei)
            resident = ro._launch(prepared, "dense")
            streamed = ro._launch(prepared, "dense_streamed")
            k = report[label]
            k["resident_vs_streamed"] = max(float((a - b).abs().max())
                                            for a, b in zip(resident, streamed))
            print(f"kernel {label}: resident vs streamed weights at its path's shapes: max |diff| "
                  f"{k['resident_vs_streamed']:.3e}", flush=True)
            if k["resident_vs_streamed"] != 0.0:
                fail(f"{label}: the resident and streamed DenseNet bodies give different bits")
        if INSTANCES[label].get("wide_bits"):
            # the generic body where the wide one is taken by shape: against
            # the plain twin, and the wide body's bits
            check_rollout(f"{label}, generic body",
                          lambda x, t, n: ro._launch(prepare(x, t, n), "generic"),
                          plain, x0i, tsi, noisei, f"{label}.generic_body", report)
            k = report[label]
            k["generic_body_max_abs_err"] = report.pop(f"{label}.generic_body")["max_abs_err"]
            k["max_abs_err"] = max(k["max_abs_err"], k["generic_body_max_abs_err"])
            prepared = prepare(x0i, tsi, noisei)
            wide, generic = ro._launch(prepared, "wide"), ro._launch(prepared, "generic")
            k["wide_vs_generic_body"] = max(float((a - b).abs().max())
                                            for a, b in zip(wide, generic))
            print(f"kernel {label}: wide vs generic body at d {x0i.shape[1]}: max |diff| "
                  f"{k['wide_vs_generic_body']:.3e}", flush=True)
            if k["wide_vs_generic_body"] != 0.0:
                fail(f"{label}: the wide and generic bodies give different bits")
        if not INSTANCES[label].get("bodies"):
            continue
        # the generic body against the plain twin, and the fast body's bits
        check_rollout(f"{label}.generic", lambda x, t, n: ro._launch(prepare(x, t, n), "generic"),
                      plain, x0i, tsi, noisei, f"{label}.generic", report)
        k = report[label]
        k["generic_max_abs_err"] = report.pop(f"{label}.generic")["max_abs_err"]
        k["max_abs_err"] = max(k["max_abs_err"], k["generic_max_abs_err"])
        prepared = prepare(x0i, tsi, noisei)
        fast, slow = ro._launch(prepared, "fast"), ro._launch(prepared, "generic")
        k["fast_vs_generic_body"] = max(float((a - b).abs().max()) for a, b in zip(fast, slow))
        print(f"kernel {label}: fast vs generic body at its path's shapes: max |diff| "
              f"{k['fast_vs_generic_body']:.3e}", flush=True)
        if k["fast_vs_generic_body"] != 0.0:
            fail(f"{label}: the fast and generic bodies give different bits")

    # the PotentialCtrl at d = 16, the widest the fast body takes: both
    # bodies against the plain twin, and the same bits
    label = "rollout.potential.none"
    run, plain, prepare, x0i, tsi, noisei, _ = seeded_instance(device, label, SEED + 27, dim=16)
    k = report[label]
    for body in ("fast", "generic"):
        check_rollout(f"{label} at d 16, {body} body",
                      lambda x, t, n: ro._launch(prepare(x, t, n), body),
                      plain, x0i, tsi, noisei, "d16", report)
        k[f"d16_{body}_max_abs_err"] = report.pop("d16")["max_abs_err"]
        k["max_abs_err"] = max(k["max_abs_err"], k[f"d16_{body}_max_abs_err"])
    prepared = prepare(x0i, tsi, noisei)
    fast, slow = ro._launch(prepared, "fast"), ro._launch(prepared, "generic")
    k["d16_fast_vs_generic_body"] = max(float((a - b).abs().max()) for a, b in zip(fast, slow))
    print(f"kernel {label}: fast vs generic body at d 16: max |diff| "
          f"{k['d16_fast_vs_generic_body']:.3e}", flush=True)
    if k["d16_fast_vs_generic_body"] != 0.0:
        fail(f"{label}: the fast and generic bodies give different bits at d = 16")

    # the tiled bodies at a ragged batch (2047, no multiple of the plan's
    # rows): mw_50d's generic body, Cox's wide body and the PotentialCtrl's
    # generic body at d = 50, each by shape, and the plan at 2047 rows
    for label, body, key in (("rollout.lerp.wells", "generic", "rollout.lerp.generic"),
                             ("rollout.lerp.given.wide", "wide", "rollout.lerp.given.wide"),
                             ("rollout.potential.none.d50", "generic",
                              "rollout.potential.generic")):
        run, plain, prepare, x0i, tsi, noisei, _ = seeded_instance(
            device, label, SEED + 50, batch=RAGGED_BATCH)
        before = build.FORM_LAUNCHES[key]
        check_rollout(f"{label} at B {RAGGED_BATCH}", run, plain, x0i, tsi, noisei, "ragged",
                      report)
        if build.FORM_LAUNCHES[key] <= before:
            fail(f"{label} at B = {RAGGED_BATCH} did not take the {body} body")
        k = report[label]
        k["ragged_max_abs_err"] = report.pop("ragged")["max_abs_err"]
        k["max_abs_err"] = max(k["max_abs_err"], k["ragged_max_abs_err"])
        plan = ro.rollout_plan(prepare(x0i, tsi, noisei))
        k["ragged_plan"] = plan._asdict()
        print(f"kernel {label} at B {RAGGED_BATCH}: plan {k['ragged_plan']}", flush=True)
        if plan.body != body or not (plan.rows * (plan.blocks - 1) < RAGGED_BATCH
                                     <= plan.rows * plan.blocks):
            fail(f"{label}: the plan {plan} does not cover {RAGGED_BATCH} rows once in the "
                 f"{body} body")

    # a score net of d outputs whose rows are all equal: the same launch with
    # the per-coordinate table and with its one column must give the same
    # bits (the per-coordinate instances run the one-output arithmetic)
    for i, (label, spec) in enumerate(INSTANCES.items()):
        if not spec.get("score_dim"):
            continue
        _, _, prepare, x0i, tsi, noisei, _ = seeded_instance(device, label, SEED + 60 + i)
        tensors, consts, form, update = prepare(x0i, tsi, noisei)
        tab = tensors[2]
        one = tab[:, :6].clone()
        one[:, 4] = tab[:, 6]
        equal = torch.cat([one, one[:, 4:5].expand(-1, tab.shape[1] - 6)], dim=1).contiguous()
        for body in ("fast", "generic") if spec.get("bodies") else ("shape",):
            got = ro._launch(([*tensors[:2], equal, *tensors[3:]], consts, form, update), body)
            want = ro._launch(([*tensors[:2], one, *tensors[3:]], consts, form, update), body)
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            print(f"kernel {label}: equal rows vs the one-output instance ({body} body): "
                  f"the same bits: {same}", flush=True)
            if not same:
                fail(f"{label}: equal rows do not give the one-output instance's bits ({body})")
        report[label]["equal_rows_bits"] = True

    # the lerp forms' Gauss prior, its loc and variance read per coordinate:
    # an IsotropicGauss's from its host floats, a diagonal Gauss's (PIS's
    # Delta) from its tensors. The same prior given either way must give the
    # same bits, and a Gauss of unequal coordinates must agree with the
    # plain twin
    from sde_sampler_torch.distr.gauss import Gauss, IsotropicGauss

    for label in ("rollout.lerp.gmm", "rollout.lerp_prior.none"):
        k = report[label]
        outs = []
        for prior in (IsotropicGauss(dim=2, loc=0.5, scale=1.5), Gauss(dim=2, loc=0.5, scale=1.5)):
            run, _, _, x0i, tsi, noisei, _ = seeded_instance(device, label, SEED + 70, prior=prior)
            outs.append(run(x0i, tsi, noisei))
        k["iso_vs_gauss_prior_bits"] = all(torch.equal(a, b) for a, b in zip(*outs))
        print(f"kernel {label}: an IsotropicGauss prior vs an equal diagonal Gauss: the same "
              f"bits: {k['iso_vs_gauss_prior_bits']}", flush=True)
        if not k["iso_vs_gauss_prior_bits"]:
            fail(f"{label}: an IsotropicGauss prior and an equal Gauss give different bits")
        # (in the fast body a thread's coordinate keeps its prior in
        # registers, in the generic body a block's prior sits in shared
        # memory)
        unequal = Gauss(dim=2, loc=[0.5, -1.0], scale=[1.0, 2.0])
        run, plain, prepare, x0i, tsi, noisei, _ = seeded_instance(device, label, SEED + 71,
                                                                   prior=unequal)
        for body in ("fast", "generic"):
            check_rollout(f"{label}, a Gauss prior of unequal coordinates, {body} body",
                          lambda x, t, n: ro._launch(prepare(x, t, n), body), plain, x0i, tsi,
                          noisei, "gauss_prior", report)
            k[f"gauss_prior_{body}_max_abs_err"] = report.pop("gauss_prior")["max_abs_err"]
            k["max_abs_err"] = max(k["max_abs_err"], k[f"gauss_prior_{body}_max_abs_err"])

    for name in ("softmin", "transport", *WIDE_SINKHORN):
        report[name] = {"max_abs_err": 0.0}
    # the paths' evaluation widths at their 10k evaluation: gmm (2), mw (5),
    # and the wide body's: 17, mw_50d (50), the alanine dipeptide (60, also
    # at its 4096 evaluation) and NICE (196), each held to its plain
    # version within TOL. Above d = 16 transport is also held to float64
    # within WIDE_TRANSPORT_F64_RTOL.
    # The widths checked before the wide body (2, 5, 50) draw from `rng` in
    # their old order, so that every later check sees the inputs it saw then;
    # the new widths draw from a generator of their own.
    import numpy as np

    new_rng = np.random.default_rng(SEED + 80)
    for n, d in ((SHORT_EVAL, 2), (SHORT_EVAL, 5), (SHORT_EVAL, 17), (SHORT_EVAL, 50),
                 (SHORT_EVAL, 60), (SHORT_EVAL, 196), (ALADIP_EVAL, 60)):
        r = rng if d in (2, 5, 50) else new_rng
        x, y, u, v = pair_inputs(device, r, n, d, n // 100)
        wide = build.FORM_LAUNCHES["softmin.wide"], build.FORM_LAUNCHES["transport.wide"]
        got, want = sk.softmin(x, y, v, EPS), sk.softmin_plain(x, y, v, EPS)
        ok, err = within(got, want, *TOL["softmin"])
        got_t, want_t = sk.transport_cost(x, y, u, v, EPS), sk.transport_cost_plain(x, y, u, v, EPS)
        took = (build.FORM_LAUNCHES["softmin.wide"] - wide[0],
                build.FORM_LAUNCHES["transport.wide"] - wide[1])
        if took != ((1, 1) if d > 16 else (0, 0)):
            fail(f"softmin and transport at d = {d} launched the wide body {took} times")
        if d > 16:
            exact = float(sk.transport_cost_plain(*(t.double() for t in (x, y, u, v)), EPS))
            rel_k, rel_p = (float(got_t) - exact) / exact, (float(want_t) - exact) / exact
            print(f"kernel transport (n = m = {n}, d {d}): kernel {float(got_t):.7g}, plain "
                  f"float32 {float(want_t):.7g}, float64 {exact:.7g}; relative to float64: "
                  f"kernel {rel_k:.3e}, plain float32 {rel_p:.3e}", flush=True)
            if not abs(rel_k) <= WIDE_TRANSPORT_F64_RTOL:
                fail(f"transport at d = {d} is {rel_k:.3e} from float64, beyond "
                     f"{WIDE_TRANSPORT_F64_RTOL:g}")
        ok_t, err_t = within(got_t, want_t, *TOL["transport"])
        print(f"kernel softmin / transport (n = m = {n}, d {d}): max_abs_err {err:.3e} / "
              f"{err_t:.3e} on {float(want_t):.6g}", flush=True)
        if not (ok and ok_t) or not bool(torch.isfinite(got).all()):
            fail(f"softmin or transport disagrees with its plain version at n = {n}, d = {d}")
        names = ("softmin", "transport") + (WIDE_SINKHORN if d > 16 else ())
        for name in names:
            e = err if name.startswith("softmin") else err_t
            report[name]["max_abs_err"] = max(report[name]["max_abs_err"], e)
    for d in (DIM, 1):
        n, n_inf = EVAL_BATCH, EVAL_BATCH // 100
        x, y, u, v = pair_inputs(device, rng, n, d, n_inf)
        got = sk.softmin(x, y, v, EPS)
        want, plain_ms = timed(lambda: sk.softmin_plain(x, y, v, EPS))
        if d == DIM:  # the plain version's time at the main path's shapes
            report["softmin"]["plain_ms"] = plain_ms
        atol, rtol = TOL["softmin"]
        ok, err = within(got, want, atol, rtol)
        print(f"kernel softmin (n = m = {n}, d {d}, {n_inf} -inf duals): "
              f"max_abs_err {err:.3e} (atol {atol})", flush=True)
        if not ok or not bool(torch.isfinite(got).all()):
            fail(f"softmin kernel disagrees with its plain version at d={d}")
        report["softmin"]["max_abs_err"] = max(report["softmin"]["max_abs_err"], err)

        got = sk.transport_cost(x, y, u, v, EPS)
        want, plain_ms = timed(lambda: sk.transport_cost_plain(x, y, u, v, EPS))
        if d == DIM:
            report["transport"]["plain_ms"] = plain_ms
        atol, rtol = TOL["transport"]
        ok, err = within(got, want, atol, rtol)
        print(f"kernel transport (n = m = {n}, d {d}): value {float(want):.6g}, "
              f"max_abs_err {err:.3e} (rtol {rtol})", flush=True)
        if not ok or not math.isfinite(float(got)):
            fail(f"transport kernel disagrees with its plain version at d={d}")
        report["transport"]["max_abs_err"] = max(report["transport"]["max_abs_err"], err)

    # softmin's edges at 100k: a whole column split of -inf duals, which
    # merges as no contribution, and duals that are all -inf (every row -inf)
    n = EVAL_BATCH
    x, y, u, v = pair_inputs(device, rng, n, DIM, n // 100)
    v_transport = v.clone()
    plan = sk.softmin_plan(n, n, DIM)
    v[plan.cols : 2 * plan.cols] = -math.inf
    for label, dual in (("a split of -inf duals", v), ("all duals -inf", torch.full_like(v, -math.inf))):
        got, want = sk.softmin(x, y, dual, EPS), sk.softmin_plain(x, y, dual, EPS)
        ok, err = within(got, want, *TOL["softmin"])
        finite = bool(torch.isfinite(got).all())
        print(f"kernel softmin (n = m = {n}, d {DIM}, {plan.splits} splits of "
              f"{plan.cols} columns, {label}): max_abs_err {err:.3e}", flush=True)
        if label.startswith("all"):
            ok = bool((got == -math.inf).all()) and bool((want == -math.inf).all())
        elif not finite:
            ok = False
        if not ok:
            fail(f"softmin kernel disagrees with its plain version ({label})")
        if not label.startswith("all"):
            report["softmin"]["max_abs_err"] = max(report["softmin"]["max_abs_err"], err)

    # transport's edges at 100k: a whole column split of -inf duals, two
    # calls on the same inputs (the same bits: no atomics), and every dual
    # -inf (exactly 0)
    plan = sk.transport_plan(n, n, DIM)
    v = v_transport
    v[plan.cols : 2 * plan.cols] = -math.inf
    got = sk.transport_cost(x, y, u, v, EPS)
    again = sk.transport_cost(x, y, u, v, EPS)
    want = sk.transport_cost_plain(x, y, u, v, EPS)
    ok, err = within(got, want, *TOL["transport"])
    print(f"kernel transport (n = m = {n}, d {DIM}, {plan.splits} splits of {plan.cols} "
          f"columns, a split of -inf duals): value {float(want):.6g}, max_abs_err "
          f"{err:.3e}; two calls equal: {bool(torch.equal(got, again))}", flush=True)
    if not ok or not math.isfinite(float(got)):
        fail("transport kernel disagrees with its plain version (a split of -inf duals)")
    if not torch.equal(got, again):
        fail("two transport calls on the same inputs gave different bits")
    report["transport"]["max_abs_err"] = max(report["transport"]["max_abs_err"], err)
    dead = torch.full_like(u, -math.inf)
    got, want = sk.transport_cost(x, y, dead, dead, EPS), sk.transport_cost_plain(x, y, dead, dead, EPS)
    print(f"kernel transport (n = m = {n}, d {DIM}, all duals -inf): value {float(got)}, "
          f"plain {float(want)}", flush=True)
    if float(got) != 0.0 or float(want) != 0.0:
        fail("transport with every dual -inf is not exactly 0")


def main_overrides(path: str, run_dir: Path, train_steps: int, eval_batch: int) -> list[str]:
    spec = PATHS[path]
    overrides = [
        f"target={spec['target']}", f"solver={spec['solver']}", *spec.get("overrides", ()),
        "plot_results=False", "store_last_ckpt=False", f"out_dir={run_dir}", f"seed={SEED}",
    ]
    if spec.get("langevin"):  # nothing to train; its own config's chains
        return overrides
    overrides += [
        "eval_init=False", f"train_steps={train_steps}", f"eval_batch_size={eval_batch}",
        "log_interval=50",
    ]
    if spec["solver"] == "dis":
        overrides.insert(2, "loss.method=lv")
    return overrides


def drive_path(path: str, train_steps: int, eval_batch: int, report):
    """One path through the entry point, launch counts zeroed just before
    and read just after; returns the trained solver."""
    from sde_sampler_torch import main as entry
    from sde_sampler_torch.ops import build

    import torch

    spec = PATHS[path]
    run_dir = OUT_DIR / f"chip_smoke_{path}"
    if run_dir.exists():
        for f in run_dir.glob("*"):
            if f.is_file():
                f.unlink()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    start = time.perf_counter()
    solver_obj = entry.main(main_overrides(path, run_dir, train_steps, eval_batch))
    seconds = time.perf_counter() - start
    launches = {k: v for k, v in {**build.LAUNCHES, **build.FORM_LAUNCHES,
                                  **build.ROUTES}.items() if v}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if spec.get("langevin"):
        train_steps, eval_batch = 0, int(solver_obj.cfg["eval_batch_size"])
    print(f"path {path}: {train_steps} steps + final eval ({eval_batch} samples) in "
          f"{seconds:.1f} s; card memory peak {peak_gib:.3f} GiB; launches {launches}",
          flush=True)
    for key in spec["kernels"]:
        count = build.FORM_LAUNCHES[key] if "." in key else build.LAUNCHES[key]
        if count <= 0:
            fail(f"kernel {key} was not launched on the {path} path")
    for key in WIDE_SINKHORN:
        # d > 16: every Sinkhorn launch in the wide body; else none
        want = build.LAUNCHES[key.split(".")[0]] if key in spec["kernels"] else 0
        if build.FORM_LAUNCHES[key] != want:
            fail(f"{path}: {build.FORM_LAUNCHES[key]} launches of {key}, expected {want}")
    scan_calls = build.ROUTES["route.scan"]
    if spec.get("scan"):
        # phase 1 through the scan route once per optimizer step, and no
        # rollout kernel
        rollouts = build.LAUNCHES["rollout"] + build.LAUNCHES["rollout_exp"]
        if scan_calls != train_steps or rollouts:
            fail(f"{path}: {scan_calls} scan-route phase 1s and {rollouts} rollout launches "
                 f"for {train_steps} optimizer steps, expected {train_steps} and 0")
    elif scan_calls:
        fail(f"{path}: phase 1 took the scan route {scan_calls} times, expected 0")
    if not spec.get("langevin") and not spec.get("scan") and (spec["solver"] == "dis"
                                                               or spec.get("once")):
        # kernel 1 once per optimizer step, or, for a given score, once per
        # EM step of it (the evaluation's rollout is the plain loop)
        key = spec.get("per_step") or spec["kernels"][0]
        want = train_steps * (int(solver_obj.train_ts.shape[0]) - 1 if "per_step" in spec else 1)
        if build.FORM_LAUNCHES[key] != want:
            fail(f"{path}: {build.FORM_LAUNCHES[key]} launches of {key}, expected {want}")
    generic = {k: v for k, v in build.FORM_LAUNCHES.items() if k.endswith(".generic") and v}
    if bool(generic) != spec.get("generic", False):
        # every path's net is 64 wide with two hidden layers: the fast body
        # unless d > 16
        fail(f"the {path} path took the rollout kernels' generic body {generic}, "
             f"expected: {spec.get('generic', False)}")
    dense = next((key for key in spec["kernels"] if key.endswith(".dense")), None)
    if dense is not None:
        # a DenseNet's launches: its weights streamed where the path says so
        # (d = 50), else resident in shared memory
        streamed = ".".join(dense.split(".")[:2]) + ".dense.streamed"
        want = build.FORM_LAUNCHES[dense] if spec.get("streamed") else 0
        if build.FORM_LAUNCHES[streamed] != want:
            fail(f"{path}: {build.FORM_LAUNCHES[streamed]} launches of {streamed}, expected {want}")
    add_launches(report, path, launches)
    subtraj = None
    if spec.get("subtraj"):
        # every optimizer step launches kernel 1 once: on the whole grid or on
        # its window (the evaluation's rollout is the plain loop)
        lengths = sorted(end - start for start, end in solver_obj.windows)
        subtraj = {"steps": len(lengths), "of": train_steps,
                   "window_steps_min": lengths[0] if lengths else None,
                   "window_steps_median": lengths[len(lengths) // 2] if lengths else None,
                   "window_steps_max": lengths[-1] if lengths else None,
                   "window_steps_mean": sum(lengths) / len(lengths) if lengths else None}
        print(f"path {path}: {len(lengths)} of {train_steps} steps on a subtrajectory; "
              f"window lengths in steps {json.dumps(subtraj)}", flush=True)
        if not lengths:
            fail(f"{path}: no step took the subtrajectory branch")
        if build.FORM_LAUNCHES["rollout.potential.none"] != train_steps:
            fail(f"{path}: {build.FORM_LAUNCHES['rollout.potential.none']} potential rollout "
                 f"launches for {train_steps} optimizer steps")
        generic_launches = build.FORM_LAUNCHES["rollout.potential.generic"]
        if generic_launches != (train_steps if spec.get("generic") else 0):
            fail(f"{path}: {generic_launches} launches of the potential's generic body for "
                 f"{train_steps} optimizer steps")

    if spec.get("langevin"):
        return langevin_result(path, solver_obj, seconds, eval_batch, launches, report)
    lines = [json.loads(l) for l in (run_dir / "metrics.jsonl").read_text().splitlines()]
    losses = [l["train/loss"] for l in lines if "train/loss" in l]
    final = solver_obj.last_metrics
    keys = spec["log_z"] + ["eval/effective_sample_size"] + spec.get("extra_keys", [])
    if spec.get("sinkhorn", True):
        keys.append("error/sinkhorn")
    summary = {k: final[k] for k in keys + ["eval/n_nonfinite_rnd", "eval/n_filtered_rnd"]}
    summary["train/loss_last"] = losses[-1] if losses else None
    summary["clip_model"] = solver_obj.scheduled_params["generative_ctrl.clip_model"]
    if solver_obj.inference_ctrl is not None:
        summary["inference_clip_model"] = solver_obj.scheduled_params["inference_ctrl.clip_model"]
    summary["log_norm_const"] = solver_obj.target.log_norm_const
    print(f"path {path} result: " + json.dumps(summary), flush=True)
    if not losses or not all(math.isfinite(x) for x in losses):
        fail(f"{path}: non-finite training loss")
    if not all(math.isfinite(final[k]) for k in keys):
        fail(f"{path}: non-finite log Z, ESS, objective or Sinkhorn value")
    if summary["clip_model"] == 10.0 and train_steps > 200:
        fail(f"{path}: the clip milestone at step 200 did not fire")
    report.setdefault("paths", {})[path] = {
        "seconds": seconds, **summary, "train_steps": train_steps,
        "eval_batch_size": eval_batch, "launches": launches, "subtraj": subtraj,
        "peak_gib": peak_gib,
    }
    return solver_obj


def add_launches(report, path: str, launches: dict) -> None:
    """Add a path's launch counts (`ops/build.py`'s keys) to the kernels'
    and instances' `launches` and `launches_by_path`."""
    counts = [(name, launches.get(name, 0)) for name in KERNELS]
    counts += [(label, launches.get(inst.get("key", label), 0))
               for label, inst in INSTANCES.items() if path in inst.get("paths", (path,))]
    for name, count in counts:
        if count:
            report[name].setdefault("launches_by_path", {})[path] = count
            report[name]["launches"] = report[name].get("launches", 0) + count


def langevin_result(path, solver_obj, seconds, n_chains, launches, report):
    """The Langevin paths' check: finite burn-in expectations and, with a
    sampler, a finite Sinkhorn; their sampling time, and the adaptive
    integrator's accepted and rejected steps."""
    spec = PATHS[path]
    final = solver_obj.last_metrics
    keys = [f"eval/{name}_direct" for name in ("square", "abs", "sum", "square_minus_sum")]
    if spec.get("sinkhorn", True):
        keys.append("error/sinkhorn")
    summary = {k: final[k] for k in keys}
    summary["sample_seconds"] = final["eval/sample_time"]
    summary["output_steps"] = int(solver_obj.eval_ts.shape[0] - 1)
    integrator = solver_obj.integrator
    summary["integrator"] = type(integrator).__name__
    if hasattr(integrator, "n_accepted"):
        summary["accepted_steps"] = integrator.n_accepted
        summary["rejected_steps"] = integrator.n_rejected
    print(f"path {path} result ({n_chains} chains, rollout {summary['sample_seconds']:.3f} s): "
          + json.dumps(summary), flush=True)
    if not all(math.isfinite(final[k]) for k in keys):
        fail(f"{path}: non-finite expectation or Sinkhorn value")
    if summary.get("accepted_steps") == 0:
        fail(f"{path}: the adaptive integrator accepted no step")
    report.setdefault("paths", {})[path] = {
        "seconds": seconds, **summary, "chains": n_chains, "launches": launches}
    return solver_obj


def phase_main(args, report):
    """Every path through the entry point, with launch counts, then the
    plots check."""
    from sde_sampler_torch.utils import wandb as wandb_shim

    wandb_shim.use_backend(None)  # the paths talk to no wandb server, installed or not
    if args.eval_batch != EVAL_BATCH:
        print(f"eval_batch_size cut to {args.eval_batch} (from {EVAL_BATCH})", flush=True)
    solvers = {}
    for path, spec in PATHS.items():
        if args.paths and path not in args.paths.split(","):
            continue
        solvers[path] = drive_path(
            path, spec.get("steps") or args.train_steps, spec.get("eval") or args.eval_batch,
            report)
    if not args.paths or "plots" in args.paths.split(","):
        report["plots"] = check_plots()
    for name, check in ENTRY_PHASES.items():
        if args.paths and name not in args.paths.split(","):
            continue
        start = time.perf_counter()
        report.setdefault("entry", {})[name] = check(report)
        seconds = time.perf_counter() - start
        report["entry"][name]["seconds"] = seconds
        print(f"phase {name}: {seconds:.1f} s", flush=True)
    return solvers


def check_plots() -> dict:
    """plot_results=True on the card: with matplotlib, one gmm_dis step and
    evaluation must write its PNGs under out_dir; without it, the solver's
    set-up must raise, naming matplotlib and plot_results=False."""
    import importlib

    from sde_sampler_torch import main as entry

    import shutil

    run_dir = OUT_DIR / "chip_smoke_plots"
    shutil.rmtree(run_dir, ignore_errors=True)
    overrides = [*main_overrides("gmm_dis", run_dir, 1, SHORT_EVAL)]
    overrides[overrides.index("plot_results=False")] = "plot_results=True"
    try:
        importlib.import_module("matplotlib")
    except ImportError:
        try:
            entry.make_solver(overrides)
        except ImportError as err:
            if "matplotlib" not in str(err) or "plot_results=False" not in str(err):
                fail(f"plots: the set-up error does not name matplotlib and "
                     f"plot_results=False: {err}")
            print(f"plots: no matplotlib on this machine; plot_results=True raised at set-up: "
                  f"{err}", flush=True)
            return {"matplotlib": False, "error": str(err)}
        fail("plots: plot_results=True did not raise at set-up without matplotlib")
    entry.main(overrides)
    pngs = sorted(p.relative_to(run_dir).as_posix() for p in run_dir.rglob("*.png"))
    if "plots/hist_0.png" not in pngs or any((run_dir / p).stat().st_size == 0 for p in pngs):
        fail(f"plots: the gmm_dis evaluation wrote {pngs}")
    print(f"plots: matplotlib present; the gmm_dis evaluation wrote {len(pngs)} PNGs", flush=True)
    return {"matplotlib": True, "pngs": pngs}


# The entry points' phases (after the paths): the main path's funnel DIS at
# full width, 20 steps and a 10k evaluation per job
ENTRY_STEPS = 20
ENTRY_OVERRIDES = ["target=funnel", "solver=dis", "loss.method=lv", f"train_steps={ENTRY_STEPS}",
                   f"eval_batch_size={SHORT_EVAL}", "eval_init=False", "plot_results=False",
                   "store_last_ckpt=False"]
NO_WANDB = "wandb.mode=disabled"  # the multirun jobs open no wandb run
ENTRY_KEYS = FINITE_LOG_Z_KEYS + ["eval/effective_sample_size", "error/sinkhorn"]
LAUNCH_LINE = "Kernel launches of this run: "


def launch_counts() -> dict[str, int]:
    from sde_sampler_torch.ops import build

    return {**build.LAUNCHES, **build.FORM_LAUNCHES, **build.ROUTES}


def check_job_launches(name: str, launches: dict, steps: int = ENTRY_STEPS) -> None:
    """A funnel DIS job: kernel 1 once per optimizer step, the Sinkhorn's
    kernels, no scan route."""
    if launches.get("rollout.lerp.funnel") != steps:
        fail(f"{name}: {launches.get('rollout.lerp.funnel')} rollout.lerp.funnel launches for "
             f"{steps} optimizer steps")
    if not launches.get("softmin") or not launches.get("transport"):
        fail(f"{name}: no Sinkhorn kernel launched: {launches}")
    if launches.get("route.scan"):
        fail(f"{name}: phase 1 took the scan route: {launches}")


def check_entry_metrics(name: str, metrics: dict) -> dict:
    summary = {k: metrics[k] for k in ENTRY_KEYS}
    if not all(math.isfinite(v) for v in summary.values()):
        fail(f"{name}: non-finite log Z, ESS or Sinkhorn: {summary}")
    return summary


def check_multirun_seq(report) -> dict:
    """Two funnel DIS jobs (seed=1,2) through `main -m` and the in-process
    launcher: each job's launches, and the card memory that a finished job
    leaves behind (none: the next job's peak is the first's)."""
    import shutil

    import torch

    from sde_sampler_torch import main as entry

    root = OUT_DIR / "chip_smoke_multirun_seq"
    shutil.rmtree(root, ignore_errors=True)
    jobs, run_job = [], entry.run_job

    def measured_job(overrides):
        before = launch_counts()
        metrics = run_job(overrides)
        torch.cuda.synchronize()
        jobs.append({
            "launches": {k: v - before[k] for k, v in launch_counts().items() if v != before[k]},
            "peak_so_far_gib": torch.cuda.max_memory_allocated() / 2**30,
            "allocated_after_gib": torch.cuda.memory_allocated() / 2**30})
        return metrics

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gib = torch.cuda.memory_allocated() / 2**30
    entry.run_job = measured_job
    try:
        results = entry.main(["-m", *ENTRY_OVERRIDES, "seed=1,2", NO_WANDB, f"out_dir={root}"])
    finally:
        entry.run_job = run_job
    total = {}
    for i, (job, metrics) in enumerate(zip(jobs, results)):
        check_job_launches(f"multirun_seq job {i}", job["launches"])
        job["result"] = check_entry_metrics(f"multirun_seq job {i}", metrics)
        for k, v in job["launches"].items():
            total[k] = total.get(k, 0) + v
    if len(jobs) != 2 or total.get("rollout.lerp.funnel") != 2 * ENTRY_STEPS:
        fail(f"multirun_seq: {len(jobs)} jobs, launches {total}")
    add_launches(report, "multirun_seq", total)
    print(f"multirun_seq: launches {json.dumps(total)}; card memory before "
          f"{base_gib:.3f} GiB; per job {json.dumps(jobs)}", flush=True)
    # the first job on a card may leave what the process keeps for good (the
    # cuBLAS workspaces); a later job adds nothing to it
    if jobs[1]["allocated_after_gib"] - jobs[0]["allocated_after_gib"] > 1 / 64:
        fail(f"multirun_seq: the second job left {jobs[1]['allocated_after_gib']:.3f} GiB "
             f"allocated on the card, the first {jobs[0]['allocated_after_gib']:.3f}")
    if jobs[1]["peak_so_far_gib"] > 1.05 * jobs[0]["peak_so_far_gib"]:
        fail(f"multirun_seq: the second job peaked at {jobs[1]['peak_so_far_gib']:.3f} GiB "
             f"against the first's {jobs[0]['peak_so_far_gib']:.3f}")
    return {"base_gib": base_gib, "jobs": jobs, "launches": total}


def check_multirun_pool(report) -> dict:
    """The same two jobs through `launcher=joblib launcher.n_jobs=2`: two
    child processes on the card, which must overlap in time; each child's
    launches come from its own main.log."""
    import shutil
    from datetime import datetime

    from sde_sampler_torch import main as entry

    root = OUT_DIR / "chip_smoke_multirun_pool"
    shutil.rmtree(root, ignore_errors=True)
    try:
        codes = entry.main(["-m", *ENTRY_OVERRIDES, "seed=1,2", "launcher=joblib",
                            "launcher.n_jobs=2", NO_WANDB, f"out_dir={root}"])
    except SystemExit as err:
        fail(f"multirun_pool: {err}")
    jobs, total = [], {}
    for i in range(2):
        log = (root / f"job{i}" / "main.log").read_text()
        lines = [line for line in log.splitlines() if LAUNCH_LINE in line]
        if not lines:
            fail(f"multirun_pool: job {i}'s main.log has no launch line")
        launches = json.loads(lines[-1].split(LAUNCH_LINE, 1)[1])
        check_job_launches(f"multirun_pool job {i}", launches)
        stamps = [datetime.strptime(line[1:24], "%Y-%m-%d %H:%M:%S,%f")
                  for line in log.splitlines() if line.startswith("[20")]
        metrics = json.loads((root / f"job{i}" / "metrics.jsonl").read_text().splitlines()[-1])
        jobs.append({"rc": codes[i], "launches": launches,
                     "result": check_entry_metrics(f"multirun_pool job {i}", metrics),
                     "start": stamps[0].isoformat(), "end": stamps[-1].isoformat(),
                     "seconds": (stamps[-1] - stamps[0]).total_seconds()})
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    if not (jobs[1]["start"] < jobs[0]["end"] and jobs[0]["start"] < jobs[1]["end"]):
        fail(f"multirun_pool: the jobs did not overlap: {jobs}")
    add_launches(report, "multirun_pool", total)
    print(f"multirun_pool: exit codes {codes}; jobs {json.dumps(jobs)}", flush=True)
    return {"jobs": jobs, "launches": total}


class Preempted(Exception):
    """The node loss that check_wandb_resume injects."""


def check_wandb_resume(report) -> dict:
    """tests/fake_wandb.py as the backend: a 20-step funnel DIS job with
    its checkpoints every 5 steps uploaded is preempted after step 10, its
    out_dir wiped, and the requeued job resumes from the artifact on the card
    and ends with the parameters of the same job run without interruption."""
    import shutil

    import torch

    from sde_sampler_torch import main as entry
    from sde_sampler_torch.solver.base import Trainable
    from sde_sampler_torch.utils import wandb as wandb_shim

    sys.path.insert(0, str(ROOT / "tests"))
    import fake_wandb

    root = OUT_DIR / "chip_smoke_wandb_resume"
    shutil.rmtree(root, ignore_errors=True)
    overrides = [*ENTRY_OVERRIDES, "seed=1", "ckpt_interval=5", "log_interval=1",
                 "upload_ckpt_to_wandb=True"]
    kill_at, train_step = ENTRY_STEPS // 2, Trainable._train_step

    def preempted_step(self):
        if self.n_steps == kill_at:
            raise Preempted(f"node lost after step {kill_at}")
        train_step(self)

    fake_wandb.reset()
    wandb_shim.use_backend(fake_wandb)
    before = launch_counts()
    try:
        whole = entry.main([*overrides, f"out_dir={root / 'whole'}"])
        Trainable._train_step = preempted_step
        try:
            entry.main([*overrides, f"out_dir={root / 'job'}"])
            fail(f"wandb_resume: the job was not preempted after step {kill_at}")
        except Preempted:
            pass
        finally:
            Trainable._train_step = train_step
        shutil.rmtree(root / "job")
        resumed_from = launch_counts()
        resumed = entry.main([*overrides, f"out_dir={root / 'job'}"])
    finally:
        wandb_shim.use_backend(None)
    after = launch_counts()
    resumed_launches = after["rollout.lerp.funnel"] - resumed_from["rollout.lerp.funnel"]
    add_launches(report, "wandb_resume", {k: v - before[k] for k, v in after.items()})
    log = (root / "job" / "main.log").read_text()
    steps = [json.loads(line).get("train/step")
             for line in (root / "job" / "metrics.jsonl").read_text().splitlines()]
    steps = [s for s in steps if s is not None]
    state = next(iter(resumed.optimizer.state.values()))
    if ("restored from wandb" not in log or min(steps) != kill_at + 1
            or resumed_launches != ENTRY_STEPS - kill_at):
        fail(f"wandb_resume: the requeued job did not resume after step {kill_at}: steps "
             f"{min(steps)}-{max(steps)}, {resumed_launches} rollout launches")
    if state["exp_avg"].device.type != "cuda" or resumed.n_steps != ENTRY_STEPS:
        fail("wandb_resume: the resumed optimizer state is not on the card")
    want = whole.modules.state_dict()
    diffs = {k: float((v - want[k]).abs().max()) for k, v in resumed.modules.state_dict().items()}
    scale = max(float(v.abs().max()) for v in want.values())
    bit_equal = all(torch.equal(v, want[k]) for k, v in resumed.modules.state_dict().items())
    max_diff = max(diffs.values())
    result = {"resumed_steps": [min(steps), max(steps)], "resumed_rollout_launches":
              resumed_launches, "bit_equal": bit_equal, "max_abs_diff": max_diff,
              "max_abs_param": scale, "result": check_entry_metrics("wandb_resume",
                                                                   resumed.last_metrics)}
    print(f"wandb_resume: {json.dumps(result)}", flush=True)
    # the resumed steps recompute the same float32 operations on the card
    if max_diff > WANDB_RESUME_RTOL * scale:
        fail(f"wandb_resume: final parameters {max_diff} from the uninterrupted run's")
    return result


# how far the resumed run's parameters may lie from the uninterrupted run's,
# relative to the largest parameter: the same operations on the same card
# give the same bits unless a reduction's order varies between runs
WANDB_RESUME_RTOL = 1e-5


def check_train_nice(report) -> dict:
    """`python -m sde_sampler_torch.train_nice` on synthetic data, 200
    iterations on the card: the loss falls, and the checkpoint loads in the
    port's Nice with a finite log-density on 1000 of its draws."""
    import re
    import shutil

    import torch

    from sde_sampler_torch.distr.nice import Nice

    out_dir = OUT_DIR / "chip_smoke_train_nice"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    out = out_dir / "nice_smoke.npz"
    start = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "sde_sampler_torch.train_nice", "--synthetic", "4000",
         "--max_iter", "200", "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - start
    if proc.returncode != 0:
        fail(f"train_nice exited {proc.returncode}: {proc.stderr[-2000:]}")
    match = re.search(r"mean loss: iterations 1-(\d+) (\S+), (\d+)-(\d+) (\S+)", proc.stdout)
    if match is None:
        fail(f"train_nice printed no loss summary: {proc.stdout[-2000:]}")
    first, last = float(match.group(2)), float(match.group(5))
    target = Nice(checkpoint=out, n_reference_samples=10).to(torch.device("cuda"))
    draws = target.sample((1000,), generator=torch.Generator("cuda").manual_seed(SEED))
    log_prob = target.unnorm_log_prob(draws)
    result = {"process_seconds": seconds, "loss_first_tenth": first, "loss_last_tenth": last,
              "log_prob_mean": float(log_prob.mean()), "finite": bool(torch.isfinite(log_prob).all())}
    print(f"train_nice: {json.dumps(result)}", flush=True)
    if not last < first:
        fail(f"train_nice: the loss did not fall ({first} -> {last})")
    if not result["finite"]:
        fail("train_nice: non-finite log-density of the trained flow's draws")
    return result


# Data parallelism (n_devices = 2, the ranks sharing the card over gloo):
# - the 20 losses of the two ranks' funnel DIS against one rank's with the
#   same seed: the same global draws and float32 reductions in another
#   order, which 20 Adam steps carry to about 1e-6 relative; the same bound
#   holds each step's largest gradient (`train/max_grad`, the summed
#   gradients' inf-norm), which a wrong sum over the ranks moves by a
#   factor where the losses, under Adam's scale invariance, would not move;
# - the sharded 100k x 100k Sinkhorn at d = 10 against one rank's kernel
#   result on the same clouds: softmin plans its column splits from its row
#   count, so a rank's rows may sum in another order than one rank's (the
#   same bits on an H100 so far, PERF.md), and the stopping iteration can
#   move by one;
# - the Langevin chains are integrated row by row from the same draws; the
#   expectations over them agree to float32 reductions of the gathered
#   chains.
DP_LOSS_RTOL = 1e-4
DP_SINKHORN_RTOL = 1e-4
DP_LANGEVIN_RTOL = 1e-5
DP_SINKHORN_N, DP_SINKHORN_DIM = 100_000, 10
RANK_LINE = re.compile(r"\[rank (\d+)\]\[INFO\] (Kernel launches of this run|Parameter digest "
                       r"of rank \d+): (.*)$")


def rank_lines(stderr: str, w: int) -> list[dict]:
    """Each rank's launch counts and parameter digest from its log lines."""
    ranks = [{} for _ in range(w)]
    for line in stderr.splitlines():
        match = RANK_LINE.search(line)
        if match:
            r, what, value = int(match.group(1)), match.group(2), match.group(3)
            if what.startswith("Kernel"):
                ranks[r]["launches"] = json.loads(value)
            else:
                ranks[r]["digest"] = value.strip()
    return ranks


def run_ranks(name: str, overrides: list[str], w: int) -> tuple[list[dict], float]:
    """`python -m sde_sampler_torch.main ... n_devices=w` in a child process:
    each rank's log lines, and the seconds it took."""
    start = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "sde_sampler_torch.main", *overrides,
                           f"n_devices={w}", NO_WANDB], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    seconds = time.perf_counter() - start
    if proc.returncode != 0:
        fail(f"{name}: n_devices={w} exited {proc.returncode}: {proc.stderr[-3000:]}")
    ranks = rank_lines(proc.stderr, w)
    if not all("launches" in r for r in ranks):
        fail(f"{name}: a rank logged no launch line: {proc.stderr[-3000:]}")
    return ranks, seconds


def losses_of(out_dir: Path, key: str = "train/loss") -> list[float]:
    """The training steps' `key` (the loss, or `train/max_grad`)."""
    lines = (out_dir / "metrics.jsonl").read_text().splitlines()
    return [row[key] for row in map(json.loads, lines) if key in row]


def max_rel_diff(got: list[float], want: list[float]) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def dp_rank(rank: int, clouds: str, langevin: list[str]) -> dict:
    """A rank of the group that runs the sharded 100k Sinkhorn on the clouds
    in `clouds` (the cost, iterations, seconds, the rank's launches and the
    seconds in its collectives, gloo's host copies included), then the
    Langevin job `langevin` through the entry point (as `main.py`'s ranks
    run it; its launches and final metrics)."""
    import torch
    import torch.distributed as dist

    from sde_sampler_torch import main as entry
    from sde_sampler_torch.eval.sinkhorn import Sinkhorn
    from sde_sampler_torch.ops import build
    from sde_sampler_torch.parallel import mesh

    x, y = (t.cuda() for t in torch.load(clouds))
    group = mesh.get_group(dist.get_world_size())
    sk = Sinkhorn(eps=EPS, group=group)
    sk(x[:1000], y[:1000])  # warm up the collectives and the kernels' first launch
    comm = {"seconds": 0.0, "calls": 0}
    gather, reduce = mesh.all_gather_rows, mesh.all_reduce

    def timed(fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            comm["seconds"] += time.perf_counter() - start
            comm["calls"] += 1
            return out
        return wrapper

    mesh.all_gather_rows, mesh.all_reduce = timed(gather), timed(reduce)
    build.reset_launches()
    try:
        mesh.barrier(group)
        torch.cuda.synchronize()
        start = time.perf_counter()
        cost = float(sk(x, y))
        seconds = time.perf_counter() - start
    finally:
        mesh.all_gather_rows, mesh.all_reduce = gather, reduce
    sinkhorn = {"cost": cost, "n_iters": sk.n_iters, "seconds": seconds,
                "launches": {k: v for k, v in build.LAUNCHES.items() if v},
                "collective_seconds": comm["seconds"], "collective_calls": comm["calls"]}
    build.reset_launches()
    start = time.perf_counter()
    solver = entry.main(langevin)
    return {"sinkhorn": sinkhorn, "langevin": {
        "seconds": time.perf_counter() - start, "final": dict(solver.last_metrics),
        "launches": {k: v for k, v in build.LAUNCHES.items() if v}}}


def check_data_parallel(report) -> dict:
    """n_devices=2 on one card: the main path's funnel DIS (20 steps, a 10k
    evaluation) as two ranks through the entry point against one rank; in
    one spawned group, the sharded 100k Sinkhorn, against one rank's, and
    gmm_langevin (6000 chains, 1000 Euler steps), against one rank; NCCL
    with a rank per card where the machine has two cards."""
    import shutil

    import numpy as np
    import torch

    from sde_sampler_torch import main as entry
    from sde_sampler_torch.eval.sinkhorn import Sinkhorn
    from sde_sampler_torch.parallel import mesh

    root = OUT_DIR / "chip_smoke_data_parallel"
    shutil.rmtree(root, ignore_errors=True)
    result, seconds = {}, {}

    # the funnel DIS: two ranks against one, seed 1
    dis = [*ENTRY_OVERRIDES, "seed=1", "log_interval=1"]
    ranks, seconds["dis_two_ranks"] = run_ranks("data_parallel dis", [
        *dis, f"out_dir={root / 'dis_two'}"], 2)
    start = time.perf_counter()
    before = launch_counts()
    entry.main([*dis, NO_WANDB, f"out_dir={root / 'dis_one'}"])
    one = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
    seconds["dis_one_rank"] = time.perf_counter() - start
    total = {}
    for r, rank in enumerate(ranks):
        check_job_launches(f"data_parallel dis rank {r}", rank["launches"])
        if rank["launches"]["transport"] != 2 or rank["launches"]["softmin"] % 2:
            fail(f"data_parallel dis rank {r}: launches {rank['launches']}, not 2 softmin per "
                 "Sinkhorn iteration and 1 transport per Sinkhorn (2 final Sinkhorns)")
        for k, v in rank["launches"].items():
            total[k] = total.get(k, 0) + v
    if ranks[0]["launches"] != ranks[1]["launches"]:
        fail(f"data_parallel dis: the ranks launched differently: {ranks}")
    if not ranks[0].get("digest") or ranks[0]["digest"] != ranks[1].get("digest"):
        fail(f"data_parallel dis: the ranks' parameters differ: {ranks}")
    add_launches(report, "data_parallel", total)
    two_losses, one_losses = losses_of(root / "dis_two"), losses_of(root / "dis_one")
    rel = [abs(a - b) / abs(b) for a, b in zip(two_losses, one_losses)]
    two_grads = losses_of(root / "dis_two", "train/max_grad")
    one_grads = losses_of(root / "dis_one", "train/max_grad")
    final = json.loads((root / "dis_two" / "metrics.jsonl").read_text().splitlines()[-1])
    result["dis"] = {"rank_launches": [r["launches"] for r in ranks], "one_rank_launches": one,
                     "digest": ranks[0]["digest"], "losses_two": two_losses,
                     "losses_one": one_losses, "max_rel_loss_diff": max(rel),
                     "max_grads_two": two_grads, "max_grads_one": one_grads,
                     "max_rel_max_grad_diff": max_rel_diff(two_grads, one_grads),
                     "result": check_entry_metrics("data_parallel dis", final)}
    if len(two_losses) != ENTRY_STEPS or len(one_losses) != ENTRY_STEPS or max(rel) > DP_LOSS_RTOL:
        fail(f"data_parallel dis: losses {two_losses} against one rank's {one_losses}")
    if len(two_grads) != ENTRY_STEPS or max_rel_diff(two_grads, one_grads) > DP_LOSS_RTOL:
        fail(f"data_parallel dis: largest gradients {two_grads} against one rank's {one_grads}")

    # one group: the sharded Sinkhorn at 100k x 100k, d = 10, then
    # gmm_langevin with 6000 chains and 1000 Euler steps of dt 0.01
    langevin = main_overrides("gmm_langevin", root / "langevin_one", 0, 0)
    langevin += ["sde.terminal_t=10", NO_WANDB]
    langevin_two = [o for o in langevin if not o.startswith("out_dir=")] + [
        f"out_dir={root / 'langevin_two'}", "n_devices=2"]
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.normal(size=(DP_SINKHORN_N, DP_SINKHORN_DIM)).astype(np.float32))
    y = torch.from_numpy((rng.normal(size=(DP_SINKHORN_N, DP_SINKHORN_DIM)) + 0.3)
                         .astype(np.float32))
    clouds = root / "clouds.pt"
    clouds.parent.mkdir(parents=True, exist_ok=True)
    torch.save((x, y), clouds)
    start = time.perf_counter()
    group_runs = mesh.spawn(dp_rank, 2, "cuda", args=(str(clouds), langevin_two), store_dir=root)
    seconds["group_of_two_ranks"] = time.perf_counter() - start
    sharded = [run["sinkhorn"] for run in group_runs]
    seconds["sinkhorn_two_ranks"] = sharded[0]["seconds"]
    sk = Sinkhorn(eps=EPS)
    xc, yc = x.cuda(), y.cuda()
    torch.cuda.synchronize()
    start = time.perf_counter()
    want = float(sk(xc, yc))
    seconds["sinkhorn_one_rank"] = time.perf_counter() - start
    got = sharded[0]["cost"]
    result["sinkhorn"] = {"ranks": sharded, "one_rank": want, "one_rank_iters": sk.n_iters,
                          "rel_diff": abs(got - want) / abs(want),
                          "collective_ms_per_iteration": [
                              1e3 * r["collective_seconds"] / r["n_iters"] for r in sharded]}
    clouds.unlink()
    for r, rank in enumerate(sharded):
        if (rank["cost"] != got or rank["launches"].get("transport") != 1
                or rank["launches"].get("softmin") != 2 * rank["n_iters"]):
            fail(f"data_parallel sinkhorn rank {r}: {rank}")
    if not abs(got - want) <= DP_SINKHORN_RTOL * abs(want):
        fail(f"data_parallel sinkhorn: two ranks {got}, one rank {want}")

    # gmm_langevin against one rank
    seconds["langevin_two_ranks"] = group_runs[0]["langevin"]["seconds"]
    start = time.perf_counter()
    one_solver = entry.main(langevin)
    seconds["langevin_one_rank"] = time.perf_counter() - start
    keys = [f"eval/{name}_direct" for name in ("square", "abs", "sum", "square_minus_sum")]
    final = group_runs[0]["langevin"]["final"]
    want = {k: one_solver.last_metrics[k] for k in keys}
    result["langevin"] = {"two": {k: final[k] for k in keys}, "one": want,
                          "rank_launches": [run["langevin"]["launches"] for run in group_runs],
                          "sinkhorn_two": final["error/sinkhorn"],
                          "sinkhorn_one": one_solver.last_metrics["error/sinkhorn"]}
    for k in keys:
        if not abs(final[k] - want[k]) <= DP_LANGEVIN_RTOL * abs(want[k]) + 1e-6:
            fail(f"data_parallel langevin: {k} {final[k]} against one rank's {want[k]}")
    for r, run in enumerate(group_runs):
        launches = run["langevin"]["launches"]
        if not launches.get("softmin") or launches.get("transport") != 1:
            fail(f"data_parallel langevin rank {r}: not one Sinkhorn's launches: {launches}")

    if torch.cuda.device_count() >= 2:
        ranks, seconds["dis_nccl"] = run_ranks("data_parallel_nccl", [
            *dis, f"out_dir={root / 'dis_nccl'}"], 2)
        nccl_losses = losses_of(root / "dis_nccl")
        nccl_grads = losses_of(root / "dis_nccl", "train/max_grad")
        if max_rel_diff(nccl_losses, one_losses) > DP_LOSS_RTOL:
            fail(f"data_parallel_nccl: losses {nccl_losses} against one rank's {one_losses}")
        if max_rel_diff(nccl_grads, one_grads) > DP_LOSS_RTOL:
            fail(f"data_parallel_nccl: largest gradients {nccl_grads} against one rank's "
                 f"{one_grads}")
        result["nccl"] = {"losses": nccl_losses, "rank_launches": [r["launches"] for r in ranks]}
        print(f"phase data_parallel_nccl: {seconds['dis_nccl']:.1f} s", flush=True)
    else:
        print("phase data_parallel_nccl: not run (1 card)", flush=True)
    result["seconds"] = seconds
    print(f"data_parallel: {json.dumps(result)}", flush=True)
    for part, value in seconds.items():
        print(f"  data_parallel {part}: {value:.1f} s", flush=True)
    return result


ENTRY_PHASES = {"multirun_seq": check_multirun_seq, "multirun_pool": check_multirun_pool,
                "wandb_resume": check_wandb_resume, "train_nice": check_train_nice,
                "data_parallel": check_data_parallel}


def kernel_ms(fn, n: int = 5) -> dict[str, float]:
    """Device ms per call of fn() by kernel name (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # device activity only: recording every host op of a step of the given
    # score (thousands of autograd ops a score) costs more than the step
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    per_kernel: dict[str, float] = {}
    for e in prof.events():
        # kernels only: device-side events that are not annotation ranges
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        per_kernel[e.name] = per_kernel.get(e.name, 0.0) + e.time_range.elapsed_us() / n / 1e3
    return per_kernel


def rollout_device_ms(fn, n: int = 3) -> float:
    """Device ms per call of fn() in kernel 1's and 2's bodies (torch.profiler)."""
    fn()
    return sum(ms for name, ms in kernel_ms(fn, n).items() if "rollout_" in name)


def step_breakdown(solver, step_ms: float, n: int = 5) -> dict:
    """Device time per optimizer step by kernel name (torch.profiler), and
    the device's idle share of the unprofiled step time."""
    per_kernel = kernel_ms(solver.step, n)
    busy_ms = sum(per_kernel.values())
    top = dict(sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12])
    idle = 1.0 - busy_ms / step_ms if busy_ms else None
    print(f"step breakdown: device busy {busy_ms:.3f} ms of {step_ms:.3f} ms "
          f"(idle share {idle if idle is None else round(idle, 4)}); top kernels "
          + json.dumps({k[:60]: round(v, 4) for k, v in top.items()}), flush=True)
    return {"device_busy_ms": busy_ms, "idle_share": idle, "top_ms": top}


def divergence_share(solver, busy_ms: float) -> dict:
    """Card time of phase 2's divergence in a Bridge step: the inference
    control and its exact divergence on every (T, B) state, forward and
    backward, as the two-phase loss runs them (torch.profiler), on states of
    the path's shapes; and its share of the step's busy time."""
    import torch

    from sde_sampler_torch.losses.oc import divx_exact

    ts, B, d = solver.train_ts, solver.train_batch_size, solver.target.dim
    T = ts.shape[0] - 1
    s = ts[:-1].reshape(T, 1, 1)
    xs = 3.0 * torch.randn((T, B, d), device=ts.device, generator=solver.generator)
    ctrl, clips = solver.inference_ctrl, solver.current_clips().get("inference_ctrl")

    def forward_backward():
        div, value = divx_exact(lambda t, x: ctrl(t, x, clips=clips), s, xs)
        (div.sum() + value.sum()).backward()
        ctrl.zero_grad(set_to_none=True)

    forward_backward()
    ms = sum(kernel_ms(forward_backward).values())
    share = ms / busy_ms if busy_ms else None
    print(f"phase 2's divergence (inference control and its exact divergence on {T} x {B} "
          f"states, forward and backward): device busy {ms:.3f} ms, "
          f"{share if share is None else round(share, 4)} of the step's busy time", flush=True)
    return {"device_busy_ms": ms, "share_of_step_busy": share}


def score_share(solver, step_ms: float, steps: int = 2) -> dict:
    """The target score's share of a given-score path's optimizer step: the
    step timed again with the control's target score replaced by zeros (one
    launch where the score was), after the timed windows; the share is the
    time that went."""
    import torch

    ctrl = solver.generative_ctrl
    score = ctrl.target_score
    ctrl.target_score = torch.zeros_like
    try:
        solver.step()
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(steps):
            solver.step()
        torch.cuda.synchronize()
        without_ms = (time.perf_counter() - start) / steps * 1e3
    finally:
        ctrl.target_score = score
    share = 1.0 - without_ms / step_ms
    print(f"the step without its target scores: {without_ms:.3f} ms of the {step_ms:.3f} ms "
          f"step: the scores' share {share:.4f}", flush=True)
    return {"step_without_score_ms": without_ms, "share_of_step": share}


def time_steps(solver, n_em_steps: int, label: str, windows: int = 5, per_window: int = 20,
               profiled: int = 5, warmup: int = 3) -> dict:
    """Median of `windows` windows of `per_window` optimizer steps of the
    trained solver, with its profiler breakdown over `profiled` steps."""
    import torch

    for _ in range(warmup):
        solver.step()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):  # the spread is reported
        start = time.perf_counter()
        for _ in range(per_window):
            solver.step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) / per_window * 1e3)
    step_ms = sorted(times)[windows // 2]
    rate = n_em_steps * solver.train_batch_size / (step_ms / 1e3)
    print(f"{label} optimizer step: median {step_ms:.3f} ms of {windows} windows of "
          f"{per_window} {[round(w, 3) for w in times]}; {rate:.4g} steps x batch / s",
          flush=True)
    return {"ms": step_ms, "windows_ms": times, "steps_x_batch_per_s": rate,
            "breakdown": step_breakdown(solver, step_ms, profiled)}


def phase_timing(solvers, device, report, instances=None):
    import torch

    from sde_sampler_torch.eval.sinkhorn import Sinkhorn
    from sde_sampler_torch.ops import rollout as ro
    from sde_sampler_torch.ops import sinkhorn as sk

    # optimizer steps of the trained solvers (more steps), of the paths that
    # ran
    if solvers is not None:
        plain_steps = (("dis", "step", "DIS"), ("dds", "dds_step", "DDS"),
                       ("gmm_dis", "gmm_step", "GMM DIS"), ("rings_dis", "rings_step", "Rings DIS"),
                       ("rosenbrock_dis", "rosenbrock_step", "Rosenbrock DIS"),
                       ("img_dis", "img_step", "Image DIS"),
                       ("gmm_dis_densenet", "gmm_densenet_step", "GMM DIS DenseNet"),
                       ("mw_50d_dis_densenet", "mw50_densenet_step", "mw_50d DIS DenseNet"),
                       ("funnel_dds_densenet", "dds_densenet_step", "DDS DenseNet"),
                       # the solver x model compositions, beside GMM DIS's step
                       ("gmm_dis_lerp_prior", "lerp_prior_step", "GMM DIS lerp_prior"),
                       ("gmm_dis_lerp_prior_dim", "lerp_prior_dim_step", "GMM DIS lerp_prior (d)"),
                       ("gmm_dis_lerp_prior_densenet", "lerp_prior_densenet_step",
                        "GMM DIS lerp_prior DenseNet"),
                       ("gmm_pis_lerp", "pis_lerp_step", "GMM PIS lerp"),
                       ("gmm_dis_score", "dis_score_step", "GMM DIS score"),
                       ("gmm_bridge_lerp_dim", "bridge_lerp_dim_step", "GMM Bridge lerp_dim"),
                       ("gmm_dis_langevin_init_dim", "langevin_init_dim_step",
                        "GMM DIS langevin_init (d)"))
        for path, key, label in plain_steps:
            if path in solvers:
                solver = solvers[path]
                report[key] = time_steps(solver, solver.train_ts.shape[0] - 1, label)
        # the DenseNet step on kernel 1, above, beside the same step with
        # phase 1 forced through the scan route (its route before the body)
        if "gmm_dis_densenet" in solvers:
            report["gmm_densenet_scan_step"] = scan_route_step(
                solvers["gmm_dis_densenet"], "GMM DIS DenseNet")
        for path in SCAN_PATHS:
            if path in solvers:
                solver = solvers[path]
                report[f"{path}_step"] = time_steps(
                    solver, solver.train_ts.shape[0] - 1, f"{path} (scan route)", windows=3,
                    per_window=2, profiled=1, warmup=1)
        # the given-score paths: 200 launches and scores a step, seconds a
        # step for NICE and the alanine dipeptide (windows of one step)
        for path, key, label in (("cox_dis", "cox_step", "Cox DIS (whitened, d 1600)"),
                                 ("nice_smooth_dis", "nice_step", "NICE smooth DIS (d 196)"),
                                 ("aladip_vacuum_dis", "aladip_step", "AlaDip DIS (d 60)")):
            if path in solvers:
                torch.cuda.reset_peak_memory_stats()
                report[key] = time_steps(solvers[path], STEPS, label, windows=3, per_window=1,
                                         profiled=1, warmup=1)
                report[key]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
                report[key]["score"] = score_share(solvers[path], report[key]["ms"], steps=1)
        if "gmm_dds_euler_langevin_init" in solvers:
            report["langevin_init_step"] = time_steps(
                solvers["gmm_dds_euler_langevin_init"], STEPS, "GMM EulerDDS (langevin_init)")
        if "gmm_bridge_diff_init" in solvers:
            bridge = solvers["gmm_bridge_diff_init"]
            report["bridge_step"] = time_steps(bridge, STEPS, "GMM Bridge (diff init)")
            report["bridge_step"]["divergence"] = divergence_share(
                bridge, report["bridge_step"]["breakdown"]["device_busy_ms"])
        # SubtrajBridge's step on the whole trajectory and on a window
        # (ending at T, of a uniform start: about half the grid on average),
        # and the Bridge form's (two potentials) on the whole trajectory
        for path, key, forced, label in (
                ("gmm_dis_subtraj", "subtraj_full_step", 0.0, "GMM DIS subtraj (whole trajectory)"),
                ("gmm_dis_subtraj", "subtraj_window_step", 1.0, "GMM DIS subtraj (subtrajectory)"),
                ("gmm_bridge_subtraj", "bridge_subtraj_full_step", 0.0,
                 "GMM Bridge subtraj (whole trajectory)"),
                ("mw_50d_dis_subtraj", "mw50_subtraj_full_step", 0.0,
                 "mw_50d DIS subtraj (whole trajectory)"),
                ("mw_50d_dis_subtraj", "mw50_subtraj_window_step", 1.0,
                 "mw_50d DIS subtraj (subtrajectory)")):
            if path not in solvers:
                continue
            subtraj = solvers[path]
            prob, subtraj.subtraj_prob = subtraj.subtraj_prob, forced
            n_windows = len(subtraj.windows)
            report[key] = time_steps(subtraj, STEPS, label)
            subtraj.subtraj_prob = prob
            lengths = [e - i for i, e in subtraj.windows[n_windows:]]
            if lengths:
                report[key]["window_steps_mean"] = sum(lengths) / len(lengths)
                print(f"{label}: the timed windows' mean length "
                      f"{report[key]['window_steps_mean']:.1f} steps of {STEPS}", flush=True)


    ctrl, rng = seeded_ctrl(device)
    x0, ts, dbs = rollout_inputs(device, rng)
    clips = {"clip_model": 10.0, "clip_score": 10.0}
    # "ms": the wrapper's whole call, which also builds the per-step tables
    # (plain torch); "kernel_ms" and "generic_body_ms": the kernel alone in
    # each body, on tables prepared once
    r = report["rollout"]
    r["ms"] = cuda_ms(lambda: ro.fused_rollout(ctrl, x0, ts, dbs, clips), reps=50, warmup=3)
    prepared = ro._prepare(ctrl, x0, ts, dbs, clips)
    r["kernel_ms"] = cuda_ms(lambda: ro._launch(prepared, "fast"), reps=50, warmup=3)
    r["generic_body_ms"] = cuda_ms(lambda: ro._launch(prepared, "generic"), reps=20)
    r["plain_ms"] = cuda_ms(
        lambda: ro.rollout_plain(ctrl, x0, ts, dbs, clips), reps=3, warmup=0)
    r["bound_ms"], r["bound_by"] = bound(*rollout_work(BATCH, STEPS, DIM, WIDTH, HIDDEN))

    score_ctrl, score_rng = seeded_score_ctrl(device, SEED + 1)
    x0e, ts_e, noise = dds_inputs(device, score_rng)
    r = report["rollout_exp"]
    r["ms"] = cuda_ms(lambda: ro.fused_rollout_exp(
        score_ctrl, x0e, ts_e, noise, DDS_ALPHA, DDS_SIGMA, clips), reps=50, warmup=3)
    prepared = ro._prepare(score_ctrl, x0e, ts_e, noise, clips, exp=(DDS_ALPHA, DDS_SIGMA))
    r["kernel_ms"] = cuda_ms(lambda: ro._launch(prepared, "fast"), reps=50, warmup=3)
    r["generic_body_ms"] = cuda_ms(lambda: ro._launch(prepared, "generic"), reps=20)
    r["plain_ms"] = cuda_ms(lambda: ro.rollout_exp_plain(
        score_ctrl, x0e, ts_e, noise, DDS_ALPHA, DDS_SIGMA, clips), reps=3, warmup=0)
    r["bound_ms"], r["bound_by"] = bound(*rollout_work(
        BATCH, ts_e.shape[0] - 1, DIM, WIDTH, HIDDEN, per_coord=20))

    # the new instances at their paths' shapes: through the wrapper, the
    # kernel alone in the body its shape takes, the plain twin
    for i, label in enumerate(ROLLOUT_INSTANCES):
        if instances is not None and label not in instances:
            continue
        run, plain, prepare, x0i, tsi, noisei, work = seeded_instance(
            device, label, INSTANCES[label].get("seed", SEED + 10 + i))
        prepared = prepare(x0i, tsi, noisei)
        k = report[label]
        if prepared[1]["kind"] == "given":
            # through the wrapper: a score and a launch a step; alone: the
            # same launches on one fixed score, by CUDA events and by the
            # profiler's device time of the rollout kernel (the host's
            # launch interval can set the events' figure)
            score = prepared[1]["score_fn"](x0i).contiguous()
            fixed = (prepared[0], {**prepared[1], "score_fn": lambda x: score}, *prepared[2:])
            k["ms"] = cuda_ms(lambda: run(x0i, tsi, noisei), reps=2, warmup=1)
            k["kernel_ms"] = cuda_ms(lambda: ro._launch(fixed), reps=5)
            k["kernel_device_ms"] = rollout_device_ms(lambda: ro._launch(fixed))
            print(f"time {label}: alone {k['kernel_ms']:.3f} ms by events, "
                  f"{k['kernel_device_ms']:.3f} ms of device time", flush=True)
            if INSTANCES[label].get("wide_bits"):
                k["generic_body_ms"] = cuda_ms(lambda: ro._launch(fixed, "generic"), reps=5)
                k["generic_body_device_ms"] = rollout_device_ms(
                    lambda: ro._launch(fixed, "generic"))
                print(f"time {label}: the generic body alone at the same shapes "
                      f"{k['generic_body_ms']:.3f} ms ({k['generic_body_device_ms']:.3f} ms of "
                      "device time)", flush=True)
            if label == "rollout.lerp.given.wide":
                # the wide body's plan (one block an SM) against 8 rows a
                # block (twice the blocks, two an SM, each pass over the
                # weights serving half the rows)
                k["rows8_ms"] = cuda_ms(lambda: ro._launch(fixed, rows=8), reps=5)
                k["rows8_device_ms"] = rollout_device_ms(lambda: ro._launch(fixed, rows=8))
                print(f"time {label}: at 8 rows a block {k['rows8_ms']:.3f} ms "
                      f"({k['rows8_device_ms']:.3f} ms of device time)", flush=True)
        else:
            k["ms"] = cuda_ms(lambda: run(x0i, tsi, noisei), reps=20, warmup=2)
            k["kernel_ms"] = cuda_ms(lambda: ro._launch(prepared), reps=20, warmup=2)
        k["plain_ms"] = cuda_ms(lambda: plain(x0i, tsi, noisei), reps=1, warmup=0)
        k["bound_ms"], k["bound_by"] = bound(*work)
        print(f"time {label} (d {x0i.shape[1]}, T {tsi.shape[0] - 1}): {k['ms']:.3f} ms "
              f"through its wrapper, {k['kernel_ms']:.3f} ms alone (plain {k['plain_ms']:.3f} "
              f"ms, bound {k['bound_ms']:.4f} ms by {k['bound_by']}; "
              f"{k['kernel_ms'] / k['bound_ms']:.1f}x)", flush=True)
        if label in TILED_ROWS:
            plan = ro.rollout_plan(prepared)
            k["plan"] = plan._asdict()
            print(f"time {label} ({TILED_ROWS[label]}): the plan {k['plan']}", flush=True)
        if INSTANCES[label].get("bodies"):
            k["generic_body_ms"] = cuda_ms(lambda: ro._launch(prepared, "generic"), reps=5)
            print(f"time {label}: its generic body alone at the same shapes "
                  f"{k['generic_body_ms']:.3f} ms", flush=True)
        if INSTANCES[label].get("dense_bodies"):
            k["streamed_ms"] = cuda_ms(lambda: ro._launch(prepared, "dense_streamed"), reps=5)
            print(f"time {label}: its weights streamed, alone at the same shapes "
                  f"{k['streamed_ms']:.3f} ms (plan {ro.rollout_plan(prepared, 'dense_streamed')})",
                  flush=True)
    # the PotentialCtrl's fast body at d = 16, the widest it takes, and its
    # generic body at the same shapes
    label = "rollout.potential.none"
    if instances is None or label in instances:
        run, plain, prepare, x0i, tsi, noisei, work = seeded_instance(
            device, label, SEED + 27, dim=16)
        prepared = prepare(x0i, tsi, noisei)
        k = report[label]
        k["d16_ms"] = cuda_ms(lambda: run(x0i, tsi, noisei), reps=20, warmup=2)
        k["d16_kernel_ms"] = cuda_ms(lambda: ro._launch(prepared), reps=20, warmup=2)
        k["d16_generic_body_ms"] = cuda_ms(lambda: ro._launch(prepared, "generic"), reps=5)
        k["d16_plain_ms"] = cuda_ms(lambda: plain(x0i, tsi, noisei), reps=1, warmup=0)
        k["d16_bound_ms"] = bound(*work)[0]
        print(f"time {label} (d 16, T {tsi.shape[0] - 1}): {k['d16_ms']:.3f} ms through its "
              f"wrapper, {k['d16_kernel_ms']:.3f} ms alone (plain {k['d16_plain_ms']:.3f} ms, "
              f"bound {k['d16_bound_ms']:.4f} ms; "
              f"{k['d16_kernel_ms'] / k['d16_bound_ms']:.1f}x); its generic body alone "
              f"{k['d16_generic_body_ms']:.3f} ms", flush=True)
    if instances is not None:
        return

    # softmin and transport at the mixture's width and the wide body's (mw_50d,
    # the alanine dipeptide, NICE), 100k x 100k, the kernels alone; at d = 50
    # the wide body also against its plain version (tens of seconds there)
    # and a library yardstick. d = 60 and 196 draw from a generator of their
    # own, so that the later draws of `rng` are those of the runs before them.
    import numpy as np

    new_rng = np.random.default_rng(SEED + 90)
    for d in (2, 50, 60, 196):
        x, y, u, v = pair_inputs(device, rng if d in (2, 50) else new_rng, EVAL_BATCH, d, 0)
        widths = report.setdefault("sinkhorn_kernels_by_d", {})
        widths[d] = {
            "softmin_ms": cuda_ms(lambda: sk.softmin(x, y, v, EPS), reps=5),
            "transport_ms": cuda_ms(lambda: sk.transport_cost(x, y, u, v, EPS), reps=5),
            "softmin_bound_ms": bound(*pair_work(EVAL_BATCH, EVAL_BATCH, d, 6, EVAL_BATCH))[0],
            "transport_bound_ms": bound(*pair_work(EVAL_BATCH, EVAL_BATCH, d, 8, 1))[0],
        }
        w = widths[d]
        print(f"time softmin / transport at 100k x 100k, d {d}: {w['softmin_ms']:.3f} "
              f"/ {w['transport_ms']:.3f} ms (bounds {w['softmin_bound_ms']:.4f} "
              f"/ {w['transport_bound_ms']:.4f} ms; {w['softmin_ms'] / w['softmin_bound_ms']:.2f}"
              f" / {w['transport_ms'] / w['transport_bound_ms']:.2f}x)", flush=True)
        if d == 50:
            time_wide_body(x, y, u, v, w, report)

    # one whole 100k Sinkhorn at d = 50 (eval/sinkhorn.py, eps = 1e-3), as an
    # mw_50d evaluation runs it
    x, y = pair_inputs(device, new_rng, EVAL_BATCH, 50, 0)[:2]
    sinkhorn = Sinkhorn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    value = float(sinkhorn(x, y))
    total = time.perf_counter() - start
    print(f"Sinkhorn 100k vs 100k at d 50 (eps {sinkhorn.eps:g}): {total:.3f} s, "
          f"{sinkhorn.n_iters} iterations, value {value:.6g}", flush=True)
    if not math.isfinite(value):
        fail("the 100k Sinkhorn at d = 50 is not finite")
    report["sinkhorn_d50"] = {"seconds": total, "iterations": sinkhorn.n_iters, "value": value}

    x, y, u, v = pair_inputs(device, rng, EVAL_BATCH, DIM, 0)
    for name, fn, plain, per_pair, n_out in (
        ("softmin", lambda: sk.softmin(x, y, v, EPS),
         lambda: sk.softmin_plain(x, y, v, EPS), 6, EVAL_BATCH),
        ("transport", lambda: sk.transport_cost(x, y, u, v, EPS),
         lambda: sk.transport_cost_plain(x, y, u, v, EPS), 8, 1),
    ):
        k = report[name]
        k["ms"] = cuda_ms(fn, reps=10)
        if "plain_ms" not in k:  # (timed in the kernels phase when it ran)
            k["plain_ms"] = cuda_ms(plain, reps=1, warmup=0)
        k["bound_ms"], k["bound_by"] = bound(
            *pair_work(EVAL_BATCH, EVAL_BATCH, DIM, per_pair, n_out))
    for name in KERNELS:
        k = report[name]
        print(f"time {name}: {k['ms']:.3f} ms (plain {k['plain_ms']:.3f} ms, "
              f"bound {k['bound_ms']:.4f} ms by {k['bound_by']})", flush=True)
    for name in ("rollout", "rollout_exp"):
        k = report[name]
        print(f"time {name}: the kernel alone {k['kernel_ms']:.3f} ms; its generic body "
              f"alone at the same shapes {k['generic_body_ms']:.3f} ms", flush=True)

    if solvers is None or "dis" not in solvers:
        return
    solver = solvers["dis"]
    samples = solver.target.sample((EVAL_BATCH,), generator=solver.generator)
    gt = solver.target.sample((EVAL_BATCH,), generator=solver.generator)
    sinkhorn = Sinkhorn()
    seen = {}
    launch = sk.transport_cost

    def recording(*args):  # keeps the evaluation's own transport inputs
        seen["args"] = args
        return launch(*args)

    sk.transport_cost = recording
    try:
        torch.cuda.synchronize()
        start = time.perf_counter()
        value = float(sinkhorn(samples, gt))
        total = time.perf_counter() - start
    finally:
        sk.transport_cost = launch
    print(f"Sinkhorn 100k vs 100k (funnel samples): {total:.3f} s, "
          f"{sinkhorn.n_iters} iterations, value {value:.6g}", flush=True)
    report["sinkhorn"] = {"seconds": total, "iterations": sinkhorn.n_iters, "value": value}
    # the same transport in the plain version, in float32 and in float64:
    # the kernel must lie within TRANSPORT_F64_RTOL of float64
    x, y, u, v, eps = seen["args"]
    plain = float(sk.transport_cost_plain(x, y, u, v, eps))
    exact = float(sk.transport_cost_plain(x.double(), y.double(), u.double(), v.double(), eps))
    report["sinkhorn"].update(plain_float32=plain, plain_float64=exact)
    print(f"Sinkhorn's transport: kernel {value:.7g}, plain float32 {plain:.7g}, "
          f"plain float64 {exact:.7g}; relative to float64: kernel "
          f"{(value - exact) / exact:.3e}, plain float32 {(plain - exact) / exact:.3e}",
          flush=True)
    if not abs(value - exact) <= TRANSPORT_F64_RTOL * abs(exact):
        fail(f"the Sinkhorn's transport kernel is {(value - exact) / exact:.3e} from float64, "
             f"beyond {TRANSPORT_F64_RTOL:g}")

    per_run = paper_scale_launches(sinkhorn.n_iters)
    smoke = {name: report[name].get("launches") for name in KERNELS}
    print("launches per paper-scale DIS run, computed from conf/solver/oc_base.yaml "
          f"({sinkhorn.n_iters} Sinkhorn iterations each): {json.dumps(per_run)}; "
          f"in this smoke run: {json.dumps(smoke)}; kernel 1 of a given score once per "
          f"EM step: {per_run['rollout'] * STEPS} a run", flush=True)
    report["paper_scale_dis_launches_computed"] = per_run

    # the main path's step with phase 1 through the loss's own scan route in
    # place of kernel 1
    report["dis_scan_step"] = scan_route_step(solver, "DIS")


def scan_route_step(solver, label: str) -> dict:
    """The solver's step with phase 1 through the loss's own scan route in
    place of its kernel: the route choice is replaced for these steps only."""
    from sde_sampler_torch.ops import rollout as ro

    choose = ro.phase1_route
    ro.phase1_route = lambda *args, **kwargs: ("scan", "timed beside kernel 1")
    try:
        return time_steps(solver, STEPS, f"{label} (phase 1 through the scan route)", windows=3,
                          per_window=2, profiled=1, warmup=1)
    finally:
        ro.phase1_route = choose


def softmin_yardstick(x, y, dual, eps, row_chunk: int = 1024):
    """softmin by torch.cdist in its default mode (matrix products past 25
    rows, in float32: TF32 is off for them) and torch.logsumexp over the
    plain version's row chunks: a library yardstick, which the port never
    calls."""
    import torch

    out = torch.empty(x.shape[0], dtype=x.dtype, device=x.device)
    for r0 in range(0, x.shape[0], row_chunk):
        z = (-torch.cdist(x[r0 : r0 + row_chunk], y) + dual[None, :]) / eps
        out[r0 : r0 + row_chunk] = eps * torch.logsumexp(z, dim=1)
    return out


def time_wide_body(x, y, u, v, widths, report):
    """The wide body at 100k x 100k, d = 50 (mw_50d's evaluation): each
    kernel against its plain version (TOL) with the plain version's time,
    beside its bound, and softmin beside the library yardstick."""
    import torch

    from sde_sampler_torch.ops import sinkhorn as sk

    if torch.backends.cuda.matmul.allow_tf32:
        fail("the yardstick's matrix products must run in float32, not TF32")
    n, d = x.shape
    got = {}
    for name, fn, plain, per_pair, n_out in (
        ("softmin.wide", lambda: sk.softmin(x, y, v, EPS),
         lambda: sk.softmin_plain(x, y, v, EPS), 6, n),
        ("transport.wide", lambda: sk.transport_cost(x, y, u, v, EPS),
         lambda: sk.transport_cost_plain(x, y, u, v, EPS), 8, 1),
    ):
        k = report[name]
        got[name] = fn()
        want, k["plain_ms"] = timed(plain)
        ok, err = within(got[name], want, *TOL[name.split(".")[0]])
        k["max_abs_err"] = max(k.get("max_abs_err", 0.0), err)
        k["ms"] = widths[f"{name.split('.')[0]}_ms"]
        k["bound_ms"], k["bound_by"] = bound(*pair_work(n, n, d, per_pair, n_out))
        value = f"value {float(want):.6g}, " if want.dim() == 0 else ""
        print(f"kernel {name} (n = m = {n}, d {d}): {value}max_abs_err {err:.3e}; "
              f"{k['ms']:.3f} ms (plain {k['plain_ms']:.3f} ms, bound {k['bound_ms']:.4f} ms "
              f"by {k['bound_by']})", flush=True)
        if not ok:
            fail(f"{name} disagrees with its plain version at n = m = {n}, d = {d}")
    k = report["softmin.wide"]
    k["yardstick_ms"] = cuda_ms(lambda: softmin_yardstick(x, y, v, EPS), reps=3)
    yard = softmin_yardstick(x, y, v, EPS)
    k["yardstick_max_abs_diff"] = float((yard - got["softmin.wide"]).abs().max())
    print(f"yardstick softmin at d {d} (torch.cdist default mode + torch.logsumexp, 1024-row "
          f"chunks): {k['yardstick_ms']:.3f} ms against the kernel's {k['ms']:.3f} ms; max "
          f"|diff| {k['yardstick_max_abs_diff']:.3e}", flush=True)


def paper_scale_launches(sinkhorn_iters: int) -> dict:
    """Launches of each kernel in one paper-scale DIS run (conf/solver/
    oc_base.yaml): kernel 1 once per optimizer step; a Sinkhorn (two
    softmins per iteration, one transport) at step 0 (eval_init), every
    eval_interval steps before the last, at the end, and once more when
    Solver.__call__ logs the final results again."""
    import yaml

    cfg = yaml.safe_load((ROOT / "conf" / "solver" / "oc_base.yaml").read_text())
    steps, interval = int(cfg["train_steps"]), int(cfg["eval_interval"])
    evals = int(bool(cfg["eval_init"])) + len(range(interval, steps, interval)) + 2
    return {"rollout": steps, "rollout_exp": 0, "softmin": evals * 2 * sinkhorn_iters,
            "transport": evals}


def ptxas_summary(log: str) -> list[str]:
    """nvcc's -Xptxas -v report, one line per kernel: its name with its
    template arguments, registers and spills."""
    import re

    lines, name = [], None
    for line in log.splitlines():
        if line.startswith("=="):
            lines.append(line.strip())
        entry = re.search(
            r"Compiling entry function '\w*?\d+([a-z_]+_kernel)(I(?:L[ib]\d+E)+E)?", line)
        if entry:
            args = re.findall(r"L[ib](\d+)E", entry.group(2) or "")
            name = entry.group(1) + (f"<{','.join(args)}>" if args else "")
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill and spill.groups() != ("0", "0"):
            lines.append(f"{name}: spills {spill.group(1)} / {spill.group(2)} bytes")
        used = re.search(r"Used (\d+) registers", line)
        if used:
            lines.append(f"{name}: {used.group(1)} registers")
    return lines


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default="kernels,main,timing")
    parser.add_argument("--train-steps", type=int, default=220)
    parser.add_argument("--eval-batch", type=int, default=EVAL_BATCH)
    parser.add_argument("--instances", default="",
                        help="comma-separated INSTANCES labels: the timing phase times only "
                             "these rollout instances (no result line)")
    parser.add_argument("--paths", default="",
                        help="comma-separated paths of the main phase, or its entry-point "
                             "phases (default: all; a subset gives no result line)")
    args = parser.parse_args()
    phases = args.phases.split(",")

    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs the card")
    if not (ROOT / "sde_sampler_torch" / "csrc").is_dir():
        fail("the port (sde_sampler_torch/) is not beside this script")
    sys.path.insert(0, str(ROOT))
    from sde_sampler_torch.ops import build
    from sde_sampler_torch.utils.device import resolve_device

    run_start = time.perf_counter()
    device = resolve_device(None)
    card = card_line()
    print(f"card: {card}", flush=True)
    report: dict = {"card": card}
    OUT_DIR.mkdir(exist_ok=True)

    start = time.perf_counter()
    build.library()
    report["build_seconds"] = time.perf_counter() - start
    print(f"kernels built in {report['build_seconds']:.1f} s", flush=True)
    for line in ptxas_summary(build.library_path().with_suffix(".log").read_text()):
        print("  " + line, flush=True)

    report.update({name: {} for name in (*KERNELS, *INSTANCES)})
    if "kernels" in phases:
        phase_kernels(device, report)
    solvers = phase_main(args, report) if "main" in phases else None
    if "timing" in phases:
        phase_timing(solvers, device, report, args.instances.split(",") if args.instances else None)

    kernels = []
    for name in (*KERNELS, *INSTANCES):
        k = report[name]
        kernel = name.split(".")[0]
        kernels.append({
            "name": name, "route": "cuda",
            "source": INSTANCES.get(name, {}).get("source", SOURCES[kernel]),
            "replaces": REPLACES[kernel], "launches": k.get("launches"),
            "launches_by_path": k.get("launches_by_path"),
            "max_abs_err": k.get("max_abs_err"), "ms": k.get("ms"),
            "kernel_ms": k.get("kernel_ms"), "kernel_device_ms": k.get("kernel_device_ms"),
            "generic_body_ms": k.get("generic_body_ms"), "streamed_ms": k.get("streamed_ms"),
            "plan": k.get("plan"),
            "plain_ms": k.get("plain_ms"), "bound_ms": k.get("bound_ms"),
            "bound_by": k.get("bound_by"), "library_ms": None,
            "yardstick_ms": k.get("yardstick_ms"),
        })
    report["seconds"] = time.perf_counter() - run_start
    print(f"phases {args.phases} done in {report['seconds']:.1f} s", flush=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    if set(phases) != {"kernels", "main", "timing"} or args.paths or args.instances:
        print(f"partial run ({args.phases}; paths {args.paths or 'all'}): no result line",
              flush=True)
        return
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
