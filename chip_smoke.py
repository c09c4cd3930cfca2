#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card: build, check, serve, train.

    python3 chip_smoke.py
    python3 chip_smoke.py --step-spread N   (not the smoke run: every check
                                             of (g), (k), (q) over N steps)
    python3 chip_smoke.py --bake-spread N   (not the smoke run: (y5)'s baked
                                             against online PSNR over N
                                             trainings of (y1))

Phases, each printing its lines; any failure raises and the run exits
non-zero. There is no CPU fallback: without a CUDA card it exits 1 before
printing any result.

  (a) device: name, torch / CUDA versions, nvidia-smi name and power limit;
  (b) build: compiles csrc/tent_contract.cu, csrc/table_scatter.cu,
      csrc/group_scatter.cu, csrc/tile_interp.cu, csrc/lane_gather.cu,
      csrc/fused_radam.cu and csrc/nerf_small_fused.cu with nvcc for
      sm_90a, one nvcc per source, started together;
  (c) tent_contract against its plain PyTorch version at the serving shapes
      (flagship side 4 / lpf 64 / F 4 over a bf16 [65536, 256] table with
      M = 16384 rays x 32 samples x 8 levels; side 5 / lpf 128 / F 2; a
      ragged M) on uniformly random rows, and on the serving path's own
      stream (the rows and positions of a render of 16,000 rays of an
      800x800 view, path_streams.serving_stream), max |diff| <= 1e-5, both
      timed with CUDA events; the bound counts of the table only the
      32-byte sectors that the case's rows and positions touch; the pack
      pass against the plain copy, timed;
  (d) serving: indoor_nerf_tpu_torch.serve's build() and handler on
      127.0.0.1 at 800x800 with the flagship preset answer /health and
      three renders; every render must launch the kernel. Then one
      100x100 image is rendered through the kernel and through the plain
      version: rgb max |diff| <= 1e-4;
  (e) table_scatter against its plain version at the flagship training
      shape (M = 4096 rays x 32 samples x 8 levels = 1,048,576 rows, F 4,
      lpf 64, side 4, bf16 rounding, a [65536, 256] f32 table): random
      rows with integer and side - 1 positions, every row on one table
      row, and the training path's own stream (the cotangent, rows and
      positions of a real step, path_streams.training_stream) with the
      reductions its inputs need; within 1e-4 relative and 1e-6 of the
      largest entry; both timed, and the un-pack pass on its own;
  (e2) fused_radam against the eager loop (train/optim.py) at the leaf
      sets of the flagship (a [65536, 256] f32 table and 9 MLP leaves) and
      of the hash grid (a [8388608, 2] table and 18): one adaptive step bit
      for bit (parameters and both moments) in one launch, then both timed
      in device time (the queue held back so the eager loop's host
      dispatch is not timed), alternating, against the bound of reading
      p, g, mu, nu and writing p, mu, nu once;
  (e3) nerf_small_fused against the eager chain (models/mlp_fused.py) at
      one 800x800 request's rows (640,000 rays x 32 samples, 20.48M rows,
      the flagship's NeRFSmall with its normal net): each channel within
      KERNEL_TOL of its largest value, then both timed in device time,
      alternating, against the bound of 8,896 multiply-adds a row and
      1,024 a ray at the float32 FMA rate; (d) holds its launches and
      rows a request on the online server's path;
  (f) training: trainer.train on the flagship CLI for 200 steps at full
      width; both kernels must launch, the loss stay finite and the mean
      loss of the last 10 steps fall below that of the first 10. Every
      training run through trainer.train or run_nerf from here on must take
      its RAdam update in one fused_radam launch a step, over every leaf
      of the model;
  (g) one step from the trained params on the same rays and draws three
      ways: through both kernels; with the backward's kernel alone replaced
      by its plain version (the same forward: the MLP's RAdam moments bit
      for bit, the table's within 1e-5 / 2e-5 of their largest entry and
      1e-5 in norm); with both replaced (the forwards differ in rounding:
      loss 1e-5, grid 1e-4, every moment 5e-3 relative in norm);
  (i) group_scatter against its plain version at the flagship grouped
      shape (4096 rays x 32 samples x 8 levels, G 4,4,2,2,1,1,1,1: 720,896
      groups, F 4, lpf 64, side 4, bf16 rounding, a [65536, 256] f32
      table), in both its forms: given rows and positions (random anchor
      rows with integer and side - 1 positions, and every group on one
      row), and with the anchor math inside, on the grouped training
      path's own stream (the cotangent and lattice coordinates of a real
      grouped step, path_streams.grouped_stream), where the rows and
      positions the kernel computes must equal _grouped_coords' bit for
      bit; tolerances as (e); all timed, the path also through
      _grouped_coords + the given form, with the reductions the inputs
      need;
  (j) grouped training: trainer.train on the flagship CLI with
      --ray_groups 4,4,2,2,1,1,1,1 for 200 steps; tent_contract and
      group_scatter must launch, the loss fall as in (f);
  (k) one grouped step from those params the same three ways, held as (g);
  (l) strided training: --ray_strides 4,4,2,2,1,1,1,1 for 100 steps;
      tent_contract and table_scatter must launch, the loss fall;
  (n) tile_interp_fwd and tile_interp_bwd_rows against their plain versions
      at the --use_pallas training shape (M = 4096 rays x 32 samples x 16
      levels = 2,097,152 gathered rows [M, 256] f32, p in [0, 4] with 4,096
      integer positions and 4,096 at side - 1) and at a ragged M: forward
      max |diff| <= 1e-5, d rows bit for bit; both timed, alternating.
      Then tile_interp_fwd(table[flat_row], p) against tent_contract(table,
      flat_row, p, 5, 2), kernel against kernel, <= 1e-5, timed side by side;
  (o) lane_select forward and backward against torch.gather and the one-hot
      sum at N = 2,097,152, k = 8 and at k = 128 with repeated indices:
      forward bit for bit, backward <= 1e-6 of the largest entry; the
      kernels, the plain versions and the single library calls
      (torch.gather, zeros.scatter_add_) timed;
  (p) tile-interp training: trainer.train on the --use_pallas CLI at the
      block-hash defaults (16 levels x 2 features, block_size 4, f32 IO)
      for 100 steps; tile_interp_fwd and tile_interp_bwd_rows must launch,
      tent_contract and table_scatter must not, the loss fall as in (f);
  (q) one step from those params on the same draws four ways: the tile
      route through the kernels, with the backward's kernel alone and with
      both replaced by their plain versions, and the default route of the
      same config (tent_contract + table_scatter, f32), held as (g); then
      the two routes' steps timed in alternating windows;
  (r) one 100x100 test-mode render at that config on the tile route and on
      the default route: rgb max |diff| <= 1e-4; tile size and peak memory;
  (s) train -> checkpoint -> serve, under a temporary --basedir:
      trainer.train for 200 flagship steps at --lrate 0.01 with --i_weights
      100 (two checkpoints, the second also the final one), a second
      trainer.train call with the
      same flags resumes ("Reloading from", the step goes on to 260, its
      first loss lies near the first run's last, not near the initial one);
      serve.build on those flags reports step 260 in /health, prints no
      UNTRAINED warning, and its render of a training pose has a higher
      PSNR against the training image than the seeded field's;
  (t) bake: bake_field of that state at resolution 256, geo_resolution -1,
      bfloat16, with the training cameras: seconds, peak memory, the
      tent_contract launches of the sweep (> 0), table shapes and bytes;
      at resolution 32 the same bake against the bake with tent_contract's
      plain version in its place (0 launches): every table entry within one
      bfloat16 step (2^-7 relative), under 1% of them different at all;
  (u) baked requests: serve.build with --baked --snapshot (the first call
      bakes and saves, the second loads: both timed) at 800x800, unguided
      (128 samples) and --guided 4, beside the online server in this
      process: warm request ms of each, PSNR of baked against online on
      held-out poses (floors: 18 dB unguided; guided within 4 dB of it),
      the tent_contract launches of the baked requests (pass 1 runs the
      kernel on float tables), one profiled request each with the device
      time of pass 1, pass 2 and the colour net and the idle share; and
      pass 1 alone at the request's shapes, through tent_contract against
      its plain form (index_select of [N*S, 128] rows + _tent_interp):
      max |diff| of relu(sigma) <= 1e-2 of the largest sigma (the kernel keeps f32 tent
      weights, the plain form rounds them to bfloat16), both timed;
  (v) from files, under a temporary directory: writes the sphere scene of
      data/scene_files.py as 32 RGBA views of 800x800 in blender layout
      (16 train, 16 val and test), trains configs/lego_tpu.txt through
      indoor_nerf_tpu_torch.run_nerf as shipped (no_batching, precrop 500,
      half_res: 400x400 views, white_bkgd) with --lrate 0.01 for 600 steps,
      --i_testset 300, --i_weights 300, --i_video 600: tent_contract and
      table_scatter must launch in the steps and tent_contract in the test
      sets (each read as the counts around the trainer's render_path calls),
      the loss fall, testset_000300/ and testset_000600/ hold a PNG per
      held-out view and test_psnrs_avg*.pkl, best.ckpt, metrics_iter_600.pkl,
      main_metrics_600.csv and the video (or its frames) exist; then
      --render_only --render_test must reproduce the last test set's mean
      PSNR within 0.01 dB and launch tent_contract, and the held-out PSNR
      must be 3 dB above the seeded field's on the same views (a render-only
      run that finds no checkpoint); prints the loader's seconds, steps/s,
      one evaluation's render and metrics seconds, peak memory;
  (w) NDC: 16 views of a textured plane in LLFF layout (poses_bounds.npy,
      images/ at 1512x2016, images_8/ at 189x252), configs/fern_tpu.txt
      (factor 8, llffhold 8, NDC, raw_noise_std 1) for 200 steps at --lrate
      0.01 with a test set at 200: both kernels launch, the loss falls, the
      held-out PSNR beats the seeded field's.

  (y1) the parity path from files, in (v)'s directory: configs/lego.txt as
      shipped (the hash grid 16 x 2 at 2^19 entries per level, 64 + 128
      samples, NeRFSmall coarse and fine) with --lrate 0.01 on (v)'s scene
      for 600 steps, test sets at 300 and 600: the loss falls, no kernel
      of csrc/ launches, render-only reproduces the last test set within
      0.01 dB, the held-out PSNR is 3 dB above the seeded field's; steps/s,
      peak memory, the loader's and an evaluation's seconds;
  (y2) one step of (y1)'s configuration from its trained state on the card
      and on the CPU, same batch and draws: the hash rows of every sample
      bit for bit, the trilinear weights within 1e-6, the loss 1e-5
      relative (over the rays whose fine samples lie in the same places on
      both; under a quarter may not), the moments and
      the parameters' update in norm (5e-3);
  (y3) configs/fern.txt (NDC, raw_noise_std 1, 64 + 64) on (w)'s plane for
      100 steps and a test set: the loss falls, the held-out PSNR beats the
      seeded field's;
  (y4) --i_embed 0 --i_embed_views 0 at the parser's width (NeRF 8 x 256
      coarse and fine) with lego's samples for 50 steps: the loss falls;
      one held-out view rendered: seconds, the peak memory per ray;
  (y5) (y1)'s checkpoint served through serve.build at 400x400 and 800x800
      online (request ms, tile size, the peak memory per ray of a tile) and
      with --baked --baked_res 128 and 256 at 800x800 (bake seconds,
      request ms, PSNR against online on the whole view, the object and the
      background): the 256^3 bake at least 18 dB on each held-out pose, as
      (u);
      online serving launches no kernel of csrc/, the baked requests
      tent_contract alone (pass 1);
  (z) (run after (u), before (v)) --precision bf16 on the flagship: a
      step and an 800x800 request at f32 and at bf16, alternating, in this
      process.

  (sp1) the structural priors from files, in (v)'s directory: the room of
      data/scene_files.py (make_room_blender_scene: 24 views of 400x400,
      6 held out) in blender layout; configs/norcliffe_common_room_tpu.txt
      as shipped (the flagship preset, 1024 rays, no_batching, precrop 500,
      lrate 5e-4) for 1000 steps with --structural_loss_start_iter 300
      --structural_loss_ramp_iters 200 --i_testset 500: the countdown, the
      banner, seven [PRIOR] lines (floor and wall pixels, the wall angle),
      the overfitting check at 1000; tent_contract and table_scatter launch
      in the steps, tent_contract in the test sets; the loss falls; the
      held-out PSNR 1 dB above the seeded field's; steps/s before and with
      the priors;
  (sp2) one step with the priors from (sp1)'s state: through the kernels
      and their plain versions as (g); card against CPU on one batch and
      draws (loss 1e-5, floor and wall counts equal, the prior terms 1e-4,
      moments and updates in norm); the priors' functions on the card's
      render, card against CPU (masks, counts, nearest pixels equal, the
      frame 1e-5, losses 1e-6); the host synchronisations of the step with
      and without the priors (equal) and of torch.linalg.svd (reported);
  (sp3) configs/norcliffe_common_room.txt as shipped (the parity path with
      the priors: hash grid, 64 + 128 samples, normal nets coarse and
      fine) on the room for 400 steps, the priors from 200: no csrc/
      kernel launches, the loss falls, held-out PSNR 0.5 dB above the
      seeded field's, steps/s before and with the priors;
  (sp4) the flagship with --distortion_loss_weight, --table_decay_weight,
      --ema_decay and both anneals for 100 steps (both kernels launch, the
      loss falls), one step of it halfway through the anneals card against
      CPU (the EMA's update too); (sp1)'s field served at 800x800 online
      and --baked at 256^3 (ms, tent_contract launches, baked against
      online PSNR on a held-out pose).

  (aq1) A-CAQ from files, in (v)'s directory: configs/lego_tpu.txt as (v)
      runs it, with --use_quantization --use_acaq --acaq_start_iter 300,
      for 700 steps (the grid quantizer's 500-step warmup passes, the
      controller runs 40 times), test sets at 300 and 600: tent_contract and
      table_scatter launch on every step (table_scatter exactly once), the
      loss falls, the [QUANT] average moves from 8 after step 300, every
      grid level is calibrated, the held-out PSNR 0.5 dB above the seeded
      field's; printed beside (v)'s at step 600, with both steps/s;
  (aq2) one controller step at 700 from (aq1)'s state, card against CPU
      (loss 1e-5 over the rays whose quantized colour agrees, at most 1%
      of them apart; soft bits and the grid's and weight's running ranges
      1e-6 relative, the activations' and infl_ema 1e-5, moments and
      updates in norm as (sp2)), then through the
      kernels against their plain versions, held as (g);
  (aq3) --block_io int8 on the flagship for 200 steps (both kernels
      launch, the loss falls); on the trained table the int8 pack pass
      against its plain form and the JAX formula on the CPU (bit for bit),
      the encode forward at M = 1,048,576 through tent_contract against
      its plain form on the card and the CPU (1e-5), the int8 and bf16
      packs and contractions timed; one int8 step of 1024 rays card
      against CPU; the
      root bench's step int8 against bf16 in eight alternating windows of
      30 steps, in this process;
  (aq4) (aq1)'s checkpoint restored (every leaf equal to the saved
      state, the quantizers included), resumed for one step through
      trainer.train, served through serve.build at 800x800 with its
      quantizers (tent_contract launches, requests timed), against the
      same params rendered unquantized (PSNR, ms) on a held-out pose.
      (aq1) also prints the render's tile model (bytes_per_ray, with the
      quantizer's activations) against the run's peak device memory.

  (rp1) the reg patches from files, in (v)'s directory: configs/lego_tpu.txt
      as (v) runs it with --reg_views 4 --reg_mode planar --reg_start_iter
      100 for 300 steps, a test set at 300: the [reg] line, the loss falls,
      tent_contract launches twice a step (the image rays' render and the
      patches') plus once a grid refresh, table_scatter exactly twice a
      step, the held-out PSNR 3 dB above the seeded field's, beside (v)'s
      at 300; then the steps of (v)'s configuration and this one in
      alternating windows of 50 steps (steps/s);
  (rp2) one patch step at 300 from (rp1)'s state: card against CPU (the
      rays apart by more than 1e-5 in colour, depth or acc, or with a
      sample moved a bin, counted; over the other image rays the image loss
      within 1e-5 relative; the smoothness op on the same maps within 1e-6;
      moments and updates in norm as (sp2)), then through the kernels
      against their plain versions, held as (g);
  (ap1) the appearance latents: (sp1)'s room written with exposure gains
      U(0.75, 1.25) on every view (the held-out views their own), trained
      through configs/norcliffe_common_room_tpu.txt as (sp1) with
      --use_appearance --testskip 2 for 400 steps, a test set at 400: the
      kernels launch, the loss falls; steps/s before and with the priors
      beside (sp1)'s, the held-out PSNR with the zero latent, the latents'
      norms (non-zero on the training images' rows, zero on the others);
  (ap2) --render_only --render_test --render_fit_appearance on (ap1)'s
      checkpoint: per held-out view the right-half PSNR with the zero and
      the fitted latent, the fit's ms and launches and those of its two
      full renders (table_scatter 0), fit_appearance.json's keys; one
      view's latent fitted on the card and on the CPU (1e-3 in norm, the
      final MSE 1e-5), and the first step's gradient on both;
  (ap3) (ap1)'s checkpoint served at 800x800 online, equal bit for bit to
      the params without the appearance leaf rendered at the server's
      tile, and --baked at 256^3, its snapshot's tables within one bf16
      step of a bake without the leaf; requests timed, baked against
      online in PSNR.

  (md1) multi-device at world size 1, in (v)'s directory:
      configs/lego_tpu.txt as (v) runs it through run_nerf with --multihost
      --num_processes 1 --process_id 0 --coordinator_address
      127.0.0.1:<free port> --mesh_shape data:1 (a NCCL process group of
      one rank: the sharded step gathers the per-ray outputs and sums the
      gradients through it) for 200 steps, a test set and a save at 200:
      the [multihost] line names nccl, tent_contract and table_scatter
      launch, the loss falls; its steps and (v)'s in alternating windows of
      50 steps; one step from its state through the sharded step and
      through train_step on one batch and draws: the forward bit for bit,
      the update held as (g)'s pair that shares a forward;
  (md2) the model axis simulated in this process at the flagship's width
      (8 levels, 4096 rays x 32 samples, a random [65536, 256] table), m =
      2 and 4, the bf16 and int8 gathers: the m local encodes of
      parallel/tp.py (tent_contract on each level block, table_scatter into
      it) concatenated equal block_hash_encode bit for bit, each block's
      gradient its rows of the full one as (e), m launches of each kernel,
      the m local passes timed against the one full pass;
  (md3) the sharded renderer (parallel/sp.py) at world size 1 over NCCL at
      800x800 from (md1)'s field against the online server's render: rgb
      within 1e-5, tent_contract launches, both timed;
  (md4) two processes on the card over Gloo (which takes the card's
      tensors for the port's collectives): one step of (md1)'s
      configuration from its state on data:2 and on model:2, the loss the
      same on both ranks bit for bit, the step held against train_step's
      as a kernel against its plain version.

The card-against-CPU steps (y2), (sp2), (sp4), (aq2), (aq3), (rp2) hold
the table's update over the entries whose RAdam moments are resolved card
against CPU (each within RESOLVED_RTOL of its own size); the share left
out is held under UNRESOLVED_SHARE. ``--step-spread N`` also runs each of
(y2), (sp2), (aq2), (rp2) and (md1)'s step check over N batches and draws.

The line before the last is {"kernels": [...]}: for each of the seven
kernels (and fused_radam and nerf_small_fused, which replace none) its
launches on the main path, its error and time against its plain
version, the least time the card could take for the same work ("bound_ms":
the larger of bytes moved once over 3.35 TB/s and operations over 67
TFLOP/s f32, computed from the run's shapes) and, where one PyTorch call
computes the same function on the same inputs, that call's time
("library_ms", else null). tent_contract and table_scatter also carry
"path_ms" (their time on the path's own stream, with "path_bound_ms") and
the time of the pack pass ("pack_ms"; tent_contract's int8 pack pass of
--block_io int8 on the trained table of (aq3): "int8_pack_ms") or of the
packed buffer's zero-fill and un-pack ("zero_fill_ms", "unpack_ms", parts
of "ms"); table_scatter
carries "reductions_from_inputs": the scalar atomics that one thread per
(row, feature) needs on that stream and the vector reductions that the
kernel's rule needs, both computed from the stream's inputs
(path_streams.count_reductions), not counted on the card. group_scatter
carries the same keys for the grouped path's stream, where it runs with the
anchor math inside ("path_ms", "path_plain_ms", "path_bound_ms";
"path_given_form_ms" is _grouped_coords followed by the kernel's given
form on that stream; "reductions_from_inputs" and
"random_reductions_from_inputs" are path_streams.count_group_reductions'
model of merged groups: scalar with one thread per (group, feature),
vector by the kernel's rule). "launches_by_path" gives each path that runs
a kernel its own count: tent_contract's include the training from files
and NDC training of (v) and (w), their test sets and render-only run;
table_scatter's the two training paths; every kernel's the parity path's
runs of (y1)-(y5), each counted: 0 but for tent_contract's in the baked
requests of (y5); and the priors' paths: training with the priors (sp1) and
with the step's other extensions (sp4), tent_contract's test sets, online
and baked requests of (sp1)'s field, and (sp3)'s parity run (0); A-CAQ's
and the int8 gather's: quantized training from files (aq1), its test sets
and its quantized 800x800 request (aq4), int8 training (aq3); the reg
patches' and the appearance latents': training with patches (rp1) and with
latents (ap1), their test sets, the half-image fits with their renders
(ap2; table_scatter 0), (ap1)'s field served online and baked (ap3); multi-device: --multihost
training at world size 1 (md1) and its test set, the m local encodes of
each simulated model axis (md2: "tp_local_<gather>_m<m>"), the sharded
render (md3), the two processes' step (md4: one rank's). The last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import functools
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer
from unittest import mock

import numpy as np

SERVE_FLAGS = ["--flagship", "--dataset_type", "synthetic", "--use_viewdirs",
               "--white_bkgd"]
SERVE_SAMPLES = 32  # the flagship's occupancy samples a ray
GROUPS = (4, 4, 2, 2, 1, 1, 1, 1)  # the 8-level --ray_groups of the help text
GROUP_FLAGS = SERVE_FLAGS + ["--ray_groups", ",".join(map(str, GROUPS))]
STRIDE_FLAGS = SERVE_FLAGS + ["--ray_strides", ",".join(map(str, GROUPS))]
KERNEL_TOL = 1e-5  # f32 accumulation both sides; summation order differs
RENDER_TOL = 1e-4
# table_scatter: f32 sums of the same rounded entries, in atomic orders
# that change from run to run (the plain version's index_add_ too).
SCATTER_RTOL = 1e-4
SCATTER_ATOL = 1e-6  # times the largest |entry|
# One step's RAdam moments, relative in norm, between two steps whose
# forwards differ in f32 summation order (a kernel against its plain
# version). Now and then a ReLU whose input lies within that rounding of 0
# takes the other branch at one sample: one rank-1 term of a layer's
# gradient, and that sample's cotangent rows in the table's, differ,
# reproducibly on both sides, by up to ~1e-2 of the gradient's largest
# entry where every other entry agrees to ~1e-7. The norm takes such a term
# in; a bound on every entry cannot. Steps that share the forward are held
# by entry (python3 chip_smoke.py --step-spread N counts all of these).
FORWARD_NORM_TOL = 5e-3
# The table's moments (mu and nu of their largest entry, both relative in
# norm) between two steps that share the forward: the backward's kernels
# and their plain versions then form the same cotangent entries, rounded
# alike, and differ by the order of the f32 sums alone (up to ~10^5 terms
# into an entry of the coarse levels).
SAME_FORWARD_TABLE_TOLS = (1e-5, 2e-5, 1e-5)
# A table's update card against CPU (y2, sp2, sp4, aq2, aq3, rp2): RAdam
# divides each entry's first moment by the root of its own second moment,
# so an entry whose first moment nearly cancels (the new gradient against
# the decayed history) moves a whole step apart when the f32 order of its
# gradient's sum changes: the f32 order acts on the moments linearly, on
# the update not. The moments are held in norm over every entry; the update
# over the entries whose mu and nu each agree card against CPU to
# RESOLVED_RTOL of their own size (the update's relative error there is
# then under ~1.5 RESOLVED_RTOL), and those left out must stay under
# UNRESOLVED_SHARE of the entries the moments touch.
RESOLVED_RTOL, UNRESOLVED_SHARE = 1e-2, 1e-2
TRAIN_STEPS = 200
STRIDED_STEPS = 100
TIMED_STEPS = 30  # per window of (z) and (aq3)
BENCH_RAYS = 4096  # the JAX package's root bench.py: N_rand
# The --use_pallas path: the block-hash grid at the parser's defaults.
TILE_FLAGS = ["--i_embed", "3", "--use_pallas", "--use_occupancy",
              "--N_importance", "0", "--occ_samples", "32", "--occ_weighting",
              "transmittance", "--dataset_type", "synthetic", "--use_viewdirs",
              "--white_bkgd"]
TILE_STEPS = 100
TILE_TIMED_STEPS = 20  # per window of (q)
RESUME_STEPS = 60  # (s): the resumed run's steps after TRAIN_STEPS
BAKE_RES = 256  # (t), (u): the server's default --baked_res
REQUEST_SIZE = 800  # (u): width and height of a request
# Baked pass 1 through tent_contract against its plain form, of the largest
# sigma: the kernel's tent weights are f32, the plain form's bfloat16
# (2^-9 relative each, three factors, eight vertices).
PASS1_RTOL = 1e-2
# Baked against online on held-out poses, 260 steps into training: 24.6-25.5
# dB measured on an H100 (33-35 dB after 1000 steps), guided within 1 dB.
BAKED_PSNR_FLOOR = 18.0  # dB
GUIDED_PSNR_GAP = 4.0  # dB, guided below unguided at most
LANE_RTOL = 1e-6  # lane_select_grad: sums of <= k terms, of the largest entry
ROOT = os.path.dirname(os.path.abspath(__file__))
# (v): configs/lego_tpu.txt on a sphere scene of 32 views of 800x800 (16
# train, 16 val and test: --testskip 8 holds out 2), 600 steps.
FILE_VIEWS, FILE_TEST_VIEWS, FILE_STEPS = 32, 2, 600
# (w): configs/fern_tpu.txt on 16 views of a plane (llffhold 8 holds out 2),
# full size 1512x2016 (images_8: 189x252), 200 steps.
NDC_VIEWS, NDC_FULL_HWF, NDC_STEPS = 16, (1512, 2016, 1630.0), 200
# (y1)-(y5), the parity path: configs/lego.txt's steps from files (test
# sets at half and all of them), configs/fern.txt's NDC steps, the PE
# run's steps; the bake resolution of its baked server.
PARITY_STEPS, PARITY_NDC_STEPS, PE_STEPS, PARITY_BAKE_RES = 600, 100, 50, 128
BAKE_SPREAD_STEPS = 1000  # --bake-spread's second reading
# (sp1)-(sp4), the structural priors: the room scene of
# data/scene_files.py in blender layout (24 views of 400x400, 6 held out);
# configs/norcliffe_common_room_tpu.txt as shipped for 1000 steps with the
# priors from 300 over a ramp of 200 and test sets every 500 (one
# overfitting check at 1000); configs/norcliffe_common_room.txt for 400
# steps with the priors from 200; the step's other extensions on the
# flagship for 100 steps.
ROOM_VIEWS, ROOM_SIZE = 24, 400
PRIOR_STEPS, PRIOR_START, PRIOR_RAMP, PRIOR_TESTSET = 1000, 300, 200, 500
PRIOR_PRINT = 100  # the parser's --i_print: a [PRIOR] line every 100 steps
NF_STEPS = 200  # (nf1): nerfacto steps on the room
PARITY_PRIOR_STEPS, PARITY_PRIOR_START = 400, 200
EXT_STEPS = 100
EXT_FLAGS = SERVE_FLAGS + [
    "--distortion_loss_weight", "0.01", "--table_decay_weight", "1e-3",
    "--ema_decay", "0.99", "--freq_anneal_iters", "50",
    "--view_anneal_iters", "50"]
# The priors on identical inputs, card against CPU: the losses to 1e-6
# relative plus 8 f32 ulps of a unit term times the weight (rsqrt rounds
# differently on each side, and 1 - cos of two near-parallel normals keeps
# that rounding while the term itself is small); the frame to 1e-5.
PRIOR_LOSS_RTOL, PRIOR_LOSS_ATOL, PRIOR_FRAME_TOL = 1e-6, 2.0 ** -20, 1e-5
# The priors' terms of one step, card against CPU (their forwards differ
# in f32 order, so their normals by ~1e-7 relative): 1e-4 relative plus
# 1e-6 times the term's weight.
PRIOR_STEP_RTOL, PRIOR_STEP_ATOL = 1e-4, 1e-6
# The card's published peaks (H100 SXM): device memory rate, and the f32
# rate outside the tensor cores, which is the type all seven kernels use.
# (aq1)-(aq4), A-CAQ and the int8 gather: configs/lego_tpu.txt as (v) runs
# it with the quantizers and the controller from step 300, 700 steps (the
# table quantizer's 500-step warmup passes, the controller runs 40 times),
# test sets at 300 and 600 (600: beside (v)'s); the flagship with
# --block_io int8, 200 steps.
AQ_STEPS, AQ_START, AQ_TESTSET, INT8_STEPS = 700, 300, 300, 200
AQ_FLAGS = ["--use_quantization", "--use_acaq", "--acaq_start_iter",
            str(AQ_START)]
INT8_FLAGS = SERVE_FLAGS + ["--block_io", "int8"]
# (rp1)-(rp2), the reg patches: (v)'s configs/lego_tpu.txt run on (v)'s
# scene with 4 patches of 8^2 rays a step in planar mode from step 100, 300
# steps and a test set at 300 (beside (v)'s); its steps/s and (v)'s in
# alternating windows of 50 steps.
RP_FLAGS = ["--reg_views", "4", "--reg_mode", "planar", "--reg_start_iter",
            "100"]
RP_STEPS, RP_WINDOW = 300, 50
# (rp2), card against CPU. The smoothness, a sum of squared second
# differences of the patch rays' disparities, agreed as one scalar to
# 1.6e-6 to 8.8e-6 in five runs on an H100 and to 2.14e-4 in a sixth (the
# loss, its weighted sum with the image term, to 2.35e-5 in a seventh).
# In an eighth the largest disparity gap sat on an opaque ray (acc 1)
# whose depth differed by 2.45e-4 of far - near; in a ninth and a tenth
# the image loss differed by 1.89e-5 and 1.43e-5, with no sample moved
# by more than 1e-5 of far. (v)'s trained field is sharp: a sample that
# the occupancy path's inverse-CDF draw (a cumsum in another order on each
# side) places a little apart, or a bin away as (y2) finds for the fine
# pass, changes its ray's colour and depth by more than rounding. So each
# render's rays apart are counted (under a quarter, as (y2)): an image
# ray's colour, a patch ray's depth (of far - near) or acc more than
# RP_MAP_ATOL apart, or a sample moved a bin. Over the other image rays
# the image loss is held at 1e-5 relative; the smoothness of the card's
# maps against the CPU's op on the same maps within RP_REG_RTOL; the
# scalars card against CPU are printed.
RP_MAP_ATOL, RP_REG_RTOL = 1e-5, 1e-6
# (ap1)-(ap3), the appearance latents: (sp1)'s room with exposure gains
# U(0.75, 1.25) on every view (the held-out ones their own), trained as
# (sp1) with --use_appearance for 400 steps; the half-image fit of its
# held-out views (one latent on the card and the CPU: 100 Adam steps of
# f32 sums in other orders, held in norm, and the final MSE).
AP_JITTER, AP_STEPS, AP_TESTSKIP = 0.25, 400, 2  # 3 of the 6 held out
# The card-against-CPU fit takes the protocol's 2,048 rays of the view's
# left half, as the timed fits do (~60 s on the CPU). The first step's
# gradient agreed to 1.45e-7 in norm, the latent after 100 Adam steps to
# 2.85e-4 and the final MSE to 3.1e-7 (one run on an H100; at 256 rays,
# with the moments divided by Python numbers, the latents had agreed to
# 4.4e-7 to 6.5e-5 in five). Adam divides each step by the root of the
# gradient's second moment, so near the optimum, where a coordinate's
# gradient is as small as its f32 error, the two sides step apart along
# directions the loss barely sees: the latent is held at 1e-3 in norm
# (3x the reading, rounded up), the MSE it reaches at 1e-5.
FIT_Z_RTOL, FIT_MSE_RTOL = 1e-3, 1e-5
TRAIN_RAYS = 4096  # the flagship preset's --N_rand
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# (md1)-(md3), multi-device on the one card: (v)'s configuration through
# --multihost at world size 1 over NCCL for MD_STEPS steps; the model axis
# simulated in one process at the flagship's width; the sharded renderer.
MD_STEPS = 200
KERNELS = ("tent_contract", "table_scatter", "group_scatter",
           "tile_interp_fwd", "tile_interp_bwd_rows", "lane_select_fwd",
           "lane_select_grad")


def bound(n_bytes: float, n_flops: float) -> dict:
    """The least time the card could take: bytes moved once over the memory
    rate, or operations over the f32 rate, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def table_sectors_touched(torch, table, flat_row, p, side) -> int:
    """The distinct 32-byte sectors (the least the card reads from device
    memory) of the packed ``table [rows, lpf, F]`` that hold a vertex
    bracketing one of the rows ``(flat_row, p)``: what the function needs
    of the table on these inputs, as csrc/tent_bracket.cuh picks the 8
    vertices (origin clamp(floor(p), 0, side - 2) per axis)."""
    lpf, F = table.shape[1:]
    i0 = torch.clamp(torch.floor(p), 0, side - 2).long()
    lane0 = (i0[:, 0] * side + i0[:, 1]) * side + i0[:, 2]
    corners = torch.tensor([(dx * side + dy) * side + dz for dx in (0, 1)
                            for dy in (0, 1) for dz in (0, 1)],
                           device=p.device)
    vertex_bytes = F * table.element_size()
    first = (flat_row.long() * lpf + lane0)[:, None] + corners[None, :]
    first = (first * vertex_bytes).reshape(-1)  # a vertex's first byte
    touched = torch.zeros(-(-nbytes(table) // 32), dtype=torch.bool,
                          device=p.device)
    touched[first // 32] = True
    touched[(first + vertex_bytes - 1) // 32] = True
    return int(touched.sum())


def launch_counts() -> dict:
    """The launches of the kernels line's seven kernels since the last
    reset_counts, by name."""
    from indoor_nerf_tpu_torch import cuda_build

    counts = cuda_build.launch_counts()
    return {k: counts[k] for k in KERNELS}


def reset_counts() -> None:
    """Clear every count of the port's kernels (cuda_build.launch_counts)."""
    from indoor_nerf_tpu_torch import cuda_build

    cuda_build.reset_counts()


# fused_radam's launches, by the training path that ran them.
RADAM_BY_PATH = {}


def hold_optimizer(tag, steps: int, params, updated=None) -> str:
    """Since the last reset_counts, every one of ``steps`` training
    steps took one fused_radam launch per MAX_LEAVES leaves over every leaf
    of ``params`` (the trained model's), or, where a step updates some of
    them only, over the leaves ``updated(steps, params)`` gives as
    ``[(steps, leaves a step), ...]``: none was left to the eager loop."""
    from indoor_nerf_tpu_torch import cuda_build
    from indoor_nerf_tpu_torch.train import optim

    counts = cuda_build.launch_counts()
    launches, leaves = counts["fused_radam"], counts["fused_radam.leaves"]
    n = len(optim.named_leaves(params))
    groups = [(steps, n)] if updated is None else updated(steps, params)
    want = sum(k * m for k, m in groups)
    want_launches = sum(k * -(-m // optim.MAX_LEAVES) for k, m in groups)
    if steps <= 0 or launches != want_launches or leaves != want:
        raise AssertionError(
            f"[{tag}] fused_radam: {launches} launches over {leaves} leaves "
            f"in {steps} steps of a {n}-leaf model (want {want_launches} "
            f"over {want})")
    RADAM_BY_PATH[tag] = launches
    return f"fused_radam {launches} launches in {steps} steps ({n} leaves)"


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def alternate(torch, plain, kernel, iters, plain_iters=None):
    """CUDA-event times of plain, kernel, kernel, plain in this order:
    (kernel ms, plain ms, the four times)."""
    t = [cuda_ms(torch, f, n) for f, n in (
        (plain, plain_iters or iters), (kernel, iters), (kernel, iters),
        (plain, plain_iters or iters))]
    return (t[1] + t[2]) / 2, (t[0] + t[3]) / 2, t


def nvidia_smi() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def phase_device(torch) -> str:
    name = torch.cuda.get_device_name(0)
    print(f"[a] device cuda:0 {name}; {torch.cuda.device_count()} visible; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"[a] nvidia-smi: {nvidia_smi()}")
    return name


def phase_build() -> None:
    from indoor_nerf_tpu_torch.cuda_build import ARCH_FLAGS, build_all

    t0 = time.perf_counter()
    built = build_all(["tent_contract", "table_scatter", "group_scatter",
                       "tile_interp", "lane_gather", "fused_radam",
                       "nerf_small_fused"])
    print(f"[b] built {len(built)} kernels in parallel in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, lib in built.items():
        print(f"[b] indoor_nerf_tpu_torch/csrc/{name}.cu with nvcc "
              f"{' '.join(ARCH_FLAGS)}: {lib.seconds:.2f} s -> {lib.path.name}")
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[b] ptxas: {line.strip()}")


def phase_kernel(torch) -> dict:
    from indoor_nerf_tpu_torch.ops import tent_contract as tc
    from indoor_nerf_tpu_torch.path_streams import serving_stream

    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(0)
    cases = [  # (label, side, F, n_rows, M, table dtype)
        ("flagship", 4, 4, 65536, 16384 * 32 * 8, torch.bfloat16),
        ("block_size4", 5, 2, 32768, 1 << 20, torch.float32),
        ("ragged", 4, 4, 65536, 12345, torch.bfloat16),
        ("serving_path", 4, 4, 65536, None, torch.bfloat16),
    ]
    stats = {}
    for label, side, F, n_rows, M, dtype in cases:
        lpf = tc.lanes_per_feature(side)
        master = torch.randn((n_rows, F * lpf), generator=g, device=dev)
        if M is None:
            # The stream of a real render; an O(1) table in place of the
            # served field's ~1e-4 entries, so the tolerance means something.
            _, flat_row, p, *geometry = serving_stream(dev)
            M = flat_row.shape[0]
            if tuple(geometry) != (side, F):
                raise AssertionError(f"serving stream: {geometry}, M {M}")
        else:
            flat_row = torch.randint(0, n_rows, (M,), generator=g, device=dev,
                                     dtype=torch.int32)
            p = torch.rand((M, 3), generator=g, device=dev) * (side - 1)
            p[:4096] = torch.randint(0, side, (4096, 3), generator=g,
                                     device=dev).float()  # tent kinks
        plain_table = master.to(dtype)  # the master's layout
        table = tc.pack_rows(master, F, dtype)  # what the kernel reads
        if not torch.equal(table, tc.pack_rows_plain(master, F, dtype)):
            raise AssertionError(f"{label}: pack_rows differs from the plain copy")
        got = tc.tent_contract(table, flat_row, p, side, F)
        want = tc.tent_contract_plain(plain_table, flat_row, p, side, F)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not (got.shape == (M, F) and err <= KERNEL_TOL):
            raise AssertionError(f"{label}: kernel vs plain max |diff| {err} "
                                 f"> {KERNEL_TOL} (shape {tuple(got.shape)})")
        ms, plain_ms, t = alternate(
            torch, lambda: tc.tent_contract_plain(plain_table, flat_row, p, side, F),
            lambda: tc.tent_contract(table, flat_row, p, side, F),
            20 if M > 100000 else 200)
        # flat_row and p read once, out written once, and of the table the
        # sectors these rows touch (all of it on random rows, a part on the
        # path's); 8 vertices x (3 weight products + 1 multiply-add) per
        # (m, f).
        sectors = table_sectors_touched(torch, table, flat_row, p, side)
        least = bound(sectors * 32 + nbytes(flat_row, p, got), M * F * 8 * 5)
        print(f"[c] {label}: side {side} lpf {lpf} F {F} table "
              f"{tuple(table.shape)} {str(dtype)[6:]} M {M}: max |diff| "
              f"{err:.3e} (tol {KERNEL_TOL}); kernel {ms:.4f} ms "
              f"({t[1]:.4f}, {t[2]:.4f}), plain {plain_ms:.4f} ms "
              f"({t[0]:.4f}, {t[3]:.4f}); the rows touch {sectors} 32-byte "
              f"sectors of the table ({sectors * 32 / nbytes(table):.3f} of "
              f"its bytes), bound {least['bound_ms']:.4f} ms")
        if label == "flagship":
            pack_ms = cuda_ms(torch, lambda: tc.pack_rows(master, F, dtype), 20)
            cast_ms = cuda_ms(torch, lambda: master.to(dtype), 20)
            print(f"[c] pack_rows {tuple(master.shape)} f32 -> "
                  f"{tuple(table.shape)} {str(dtype)[6:]}: {pack_ms:.4f} ms "
                  f"(the cast alone, which it replaces in a step: "
                  f"{cast_ms:.4f} ms)")
            stats = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     **least, "library_ms": None, "pack_ms": pack_ms}
        elif label == "serving_path":
            stats.update({"path_ms": ms, "path_plain_ms": plain_ms,
                          "path_max_abs_err": err, "path_rows": M,
                          "path_bound_ms": least["bound_ms"],
                          "path_table_sectors": sectors})
        del master, table, plain_table, flat_row, p, got, want
    torch.cuda.empty_cache()
    return stats


def _request(url, body=None):
    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        status, ctype, data = r.status, r.headers["Content-Type"], r.read()
    return status, ctype, data, time.perf_counter() - t0


def hold_mlp(tag, requests: int, rows_per_request: int) -> int:
    """Since the last reset_counts, ``requests`` requests each took the
    same number of nerf_small_fused launches, at least one, over
    ``rows_per_request`` rows: every sample of the request went through
    the kernel, none through the eager chain. Returns the launches a
    request."""
    from indoor_nerf_tpu_torch import cuda_build

    counts = cuda_build.launch_counts()
    launches = counts["nerf_small_fused"]
    rows = counts["nerf_small_fused.rows"]
    if (launches < requests or launches % requests
            or rows != requests * rows_per_request):
        raise AssertionError(
            f"[{tag}] nerf_small_fused: {launches} launches over {rows} rows "
            f"in {requests} requests (want a launch a tile and "
            f"{rows_per_request} rows a request)")
    return launches // requests


def phase_serving(torch) -> tuple:
    from indoor_nerf_tpu_torch import serve
    from indoor_nerf_tpu_torch.data.load import load_dataset
    from indoor_nerf_tpu_torch.train.config import parse_args
    from indoor_nerf_tpu_torch.utils.png import decode_png

    args = argparse.Namespace(width=800, height=800,
                              train_args=["--"] + SERVE_FLAGS)
    render, step, hw = serve.build(args)
    captured = []

    def recorded(c2w, request_id=None):
        maps, dt = render(c2w, request_id)
        captured.append((maps, dt))
        return maps, dt

    recorded.request_ids = render.request_ids

    scene = load_dataset(parse_args(SERVE_FLAGS))
    test_poses = scene.poses[scene.i_test]
    srv = ThreadingHTTPServer(("127.0.0.1", 0),
                              serve.make_handler(recorded, step, hw))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    requests = [
        ("POST /render png (test pose 0)", "/render",
         {"c2w": test_poses[0][:3].tolist(), "format": "png"}),
        ("POST /render npy (test pose 1)", "/render",
         {"c2w": test_poses[1][:3].tolist(), "format": "npy"}),
        ("GET /render?theta=45&phi=-30&radius=4",
         "/render?theta=45&phi=-30&radius=4", None),
    ]
    torch.cuda.reset_peak_memory_stats()
    try:
        reset_counts()  # the serving path's run starts here
        status, _, data, dt = _request(base + "/health")
        health = json.loads(data)
        if status != 200 or health["status"] != "ok":
            raise AssertionError(f"/health answered {status} {health}")
        print(f"[d] GET /health: {status} {health} in {dt * 1e3:.1f} ms")
        counts = [launch_counts()["tent_contract"]]
        for label, path, body in requests:
            status, ctype, data, latency = _request(base + path, body)
            counts.append(launch_counts()["tent_contract"])
            if status != 200:
                raise AssertionError(f"{label}: HTTP {status}")
            if ctype == "image/png":
                img = decode_png(data)
            else:
                img = np.load(io.BytesIO(data))
            if img.shape != (800, 800, 3):
                raise AssertionError(f"{label}: image {img.shape}")
            maps, render_s = captured[-1]
            for k in ("rgb_map", "depth_map"):
                if not np.all(np.isfinite(maps[k])):
                    raise AssertionError(f"{label}: non-finite {k}")
            if counts[-1] <= counts[-2]:
                raise AssertionError(f"{label}: tent_contract not launched")
            print(f"[d] {label}: {status} {ctype}, {len(data)} bytes, "
                  f"tent_contract launches +{counts[-1] - counts[-2]}")
            print(f"[d] latency {label}: {latency * 1e3:.1f} ms round trip, "
                  f"render {render_s * 1e3:.1f} ms")
            print(f"[d] rays/s {label}: {800 * 800 / render_s:.0f}")
        # The serving path's run ends here.
        launches = launch_counts()["tent_contract"]
        mlp = hold_mlp("d", len(requests), 800 * 800 * SERVE_SAMPLES)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    if thread.is_alive():
        raise AssertionError("server thread did not stop")
    peak = torch.cuda.max_memory_allocated()
    print(f"[d] main path: {launches} tent_contract launches over 3 renders, "
          f"nerf_small_fused {mlp} a render over {800 * 800 * SERVE_SAMPLES} "
          f"rows; peak device memory {peak / 2**30:.2f} GiB")
    return launches, mlp


def phase_render_check(torch) -> None:
    """One 100x100 render through the kernel and through the plain version."""
    from indoor_nerf_tpu_torch.data.load import load_dataset
    from indoor_nerf_tpu_torch.models.field import init_field_params, serving_params
    from indoor_nerf_tpu_torch.ops import blockhash
    from indoor_nerf_tpu_torch.ops.tent_contract import tent_contract_plain
    from indoor_nerf_tpu_torch.render.renderer import make_image_renderer
    from indoor_nerf_tpu_torch.train.config import parse_args
    from indoor_nerf_tpu_torch.train.trainer import build_train_config

    dev = torch.device("cuda:0")
    cli = parse_args(SERVE_FLAGS)
    scene = load_dataset(cli)
    cfg = build_train_config(cli, scene)
    g = torch.Generator(device=dev).manual_seed(1)
    params = init_field_params(g, cfg.render.field, dev)
    # An O(1) table so the rays are not transparent, and a random grid.
    params["table"] = torch.randn(params["table"].shape, generator=g, device=dev)
    params = serving_params(params, cfg.render.field)
    occ = {"density": 4.0 * torch.rand(cfg.render.occupancy.n_cells,
                                        generator=g, device=dev)}
    H = W = 100
    focal = scene.hwf[2] * (W / scene.hwf[1])
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    renderer = make_image_renderer(cfg.render.test_mode(), H, W)
    c2w = scene.poses[scene.i_test[0]]
    kern = renderer(params, c2w, K, scene.near, scene.far, occ)
    with mock.patch.object(blockhash, "tent_contract", tent_contract_plain):
        plain = renderer(params, c2w, K, scene.near, scene.far, occ)
    torch.cuda.synchronize()
    for k in ("rgb_map", "depth_map"):
        if not bool(torch.isfinite(kern[k]).all()):
            raise AssertionError(f"100x100 render: non-finite {k}")
    err = float((kern["rgb_map"] - plain["rgb_map"]).abs().max())
    acc = kern["acc_map"]
    print(f"[d] 100x100 render, kernel vs plain: rgb max |diff| {err:.3e} "
          f"(tol {RENDER_TOL}); acc in [{float(acc.min()):.3f}, "
          f"{float(acc.max()):.3f}]")
    if err > RENDER_TOL:
        raise AssertionError(f"render rgb kernel vs plain {err} > {RENDER_TOL}")


def hold_scatter(torch, tag, what, kernel, plain, args, shape) -> dict:
    """A scatter kernel's result against its plain version's on ``args``
    (within SCATTER_RTOL and SCATTER_ATOL of the largest entry), then both
    timed alternately; returns the numbers of the kernels line. The bound
    counts every tensor argument read once and the table written once, and
    3 weight products, a rounding and an add for each of the 8 entries per
    (row, feature) of the cotangent ``args[0]``; no one PyTorch call takes
    (g, p, rows) to the table gradient, so there is no library time."""
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    bound_ = SCATTER_ATOL * scale + SCATTER_RTOL * want.abs()
    if not (got.shape == shape and scale > 0
            and bool(((got - want).abs() <= bound_).all())):
        raise AssertionError(
            f"{what}: {kernel.__name__} vs plain max |diff| {err} beyond "
            f"rtol {SCATTER_RTOL}, atol {SCATTER_ATOL} x {scale}")
    least = bound(nbytes(got, *(a for a in args if torch.is_tensor(a))),
                  args[0].numel() * 8 * 5)
    del got, want, bound_
    ms, plain_ms, t = alternate(torch, lambda: plain(*args),
                                lambda: kernel(*args), 10)
    print(f"[{tag}] {what}: max |diff| {err:.3e} (largest entry {scale:.3e}); "
          f"kernel {ms:.4f} ms ({t[1]:.4f}, {t[2]:.4f}), plain "
          f"{plain_ms:.4f} ms ({t[0]:.4f}, {t[3]:.4f})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **least,
            "library_ms": None}


def phase_scatter(torch) -> dict:
    """(e) table_scatter against its plain version at the training shape."""
    from indoor_nerf_tpu_torch.cuda_build import launch_on_stream, load_library
    from indoor_nerf_tpu_torch.ops import table_scatter as ts
    from indoor_nerf_tpu_torch.path_streams import count_reductions, training_stream

    dev = torch.device("cuda:0")
    g0 = torch.Generator(device=dev).manual_seed(2)
    side, F, lpf, L, R = 4, 4, 64, 8, 8192
    M = 4096 * 32 * L
    flagship = None
    for label, one_row in (("flagship", False), ("one_row", True)):
        g = torch.randn((M, F), generator=g0, device=dev)
        if one_row:
            g = g.abs()  # sums of ~10^5 terms that do not cancel
        p = torch.rand((M, 3), generator=g0, device=dev) * (side - 1)
        p[:4096] = torch.randint(0, side, (4096, 3), generator=g0,
                                 device=dev).float()  # tent kinks
        p[4096:8192] = side - 1
        local = (torch.zeros(M, dtype=torch.int64, device=dev) if one_row else
                 torch.randint(0, R, (M,), generator=g0, device=dev))
        level = torch.arange(M, device=dev) % L  # level-minor, as the encode
        flat_row = (local + level * R).to(torch.int32)
        args = (g, p, flat_row, L * R, side, lpf, torch.bfloat16)
        stats = hold_scatter(
            torch, "e", f"{label}: M {M} F {F} lpf {lpf} side {side} bf16 "
            f"rounding, table {L * R}x{F * lpf} f32", ts.table_scatter,
            ts.table_scatter_plain, args, (L * R, F * lpf))
        flagship = flagship or stats
        del g, p, flat_row, args
    torch.cuda.empty_cache()

    # The stream of a real step: its cotangent, rows and positions.
    args = training_stream(dev)
    g, p, flat_row, n_rows, *geometry = args
    if tuple(geometry) != (side, lpf, torch.bfloat16) or g.shape != (M, F):
        raise AssertionError(f"training stream: {geometry}, g {tuple(g.shape)}")
    path = hold_scatter(
        torch, "e", f"training_path: the table_scatter call of a real step, M "
        f"{M}, {int((g == 0).all(1).sum())} rows of g all zero",
        ts.table_scatter, ts.table_scatter_plain, args, (n_rows, F * lpf))
    before, after = count_reductions(g, p, side, torch.bfloat16)
    print(f"[e] training_path reductions, computed from its inputs (not "
          f"counted on the card): {before} scalar f32 atomics with one thread "
          f"per (row, feature); {after} vector reductions (one per vertex "
          f"with a nonzero entry)")
    passes = torch.zeros((n_rows, lpf, F), device=dev)
    fill_ms = cuda_ms(torch, lambda: torch.zeros_like(passes), 20)
    unpacked = torch.empty((n_rows, F * lpf), device=dev)
    lib = load_library("table_scatter").lib
    unpack_ms = cuda_ms(torch, lambda: launch_on_stream(
        lib.table_scatter_unpack, lib.table_scatter_error_string,
        "table_scatter_unpack", (("packed", passes), ("out", unpacked)),
        n_rows, F, lpf), 20)
    print(f"[e] of the kernel's time: zero-fill of the packed buffer "
          f"{fill_ms:.4f} ms, un-pack into the master's layout "
          f"{unpack_ms:.4f} ms")
    flagship.update({"path_ms": path["ms"], "path_plain_ms": path["plain_ms"],
                     "path_max_abs_err": path["max_abs_err"], "path_rows": M,
                     "path_bound_ms": path["bound_ms"],
                     "reductions_from_inputs": [before, after],
                     "zero_fill_ms": fill_ms, "unpack_ms": unpack_ms})
    del args, g, p, flat_row, passes, unpacked
    torch.cuda.empty_cache()
    return flagship


# (e2): the leaf sets of the two training cells of the benchmark.
RADAM_MLP = {"sigma_net.0.w": (32, 64), "sigma_net.1.w": (64, 16),
             "color_net.0.w": (31, 64), "color_net.1.w": (64, 64),
             "color_net.2.w": (64, 3), "normal_net.0.w": (15, 32),
             "normal_net.0.b": (32,), "normal_net.1.w": (32, 3),
             "normal_net.1.b": (3,)}
RADAM_SETS = {
    "flagship": {"table": (65536, 256),
                 **{f"coarse.{k}": v for k, v in RADAM_MLP.items()}},
    "hashgrid": {"table": (8388608, 2),
                 **{f"{net}.{k}": v for net in ("coarse", "fine")
                    for k, v in RADAM_MLP.items()}}}
RADAM_BYTES = 28  # an adaptive step reads p, g, mu, nu and writes p, mu, nu
RADAM_FLOPS = 14  # 7 for the moments, 2 for the decay, 5 for the update
# (e3): one 800x800 request's field query. The least multiply-adds: a
# row's (sigma 32x64 + 64x16, colour 15x64 + 64x64 + 64x3 from the
# geometry features on, normal 15x32 + 32x3) and a ray's (the colour
# net's 16x64 view part, which depends on the ray alone;
# nerfbench/counts.py::mlp_flops_per_sample counts it a row, 9,920 in
# all). Bytes: a row's 32 features and keep flag read, 7 outputs written;
# the view features once a ray.
MLP_RAYS = 800 * 800
MLP_FMA_PER_ROW = 8896
MLP_FMA_PER_RAY = 16 * 64
MLP_BYTES_PER_ROW = 32 * 4 + 1 + 7 * 4


def device_ms(torch, fn, iters: int, rounds: int = 4) -> list:
    """Device time of ``fn`` (ms a call, ``rounds`` readings of ``iters``
    calls each), with the stream held back by a spin kernel until every
    call is queued: a function whose host dispatch is slower than its
    kernels is timed by its kernels, not by its host."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)  # ~50 ms of cycles: the host queues
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return out


def phase_fused_radam(torch) -> dict:
    """(e2) fused_radam against the eager loop at the two cells' leaf sets:
    one adaptive step bit for bit, one launch; then both timed, alternating
    (eager, kernel, kernel, eager, each the median of 4 readings)."""
    from indoor_nerf_tpu_torch import cuda_build
    from indoor_nerf_tpu_torch.train import optim

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(11)
    hyper = optim.pocketnerf_hyper_fn
    out = {}
    for label, shapes in RADAM_SETS.items():
        def draw(scale, positive=False):
            t = {n: torch.randn(s, generator=gen, device=dev) * scale
                 for n, s in shapes.items()}
            return {n: v.abs() for n, v in t.items()} if positive else t

        leaves, grads = draw(1.0), draw(1e-3)
        state = {"mu": draw(1e-3), "nu": draw(1e-6, True), "step": 100}
        copies = ({n: v.clone() for n, v in leaves.items()},
                  {"mu": {n: v.clone() for n, v in state["mu"].items()},
                   "nu": {n: v.clone() for n, v in state["nu"].items()},
                   "step": 100})
        lr = optim.exp_decay_lr(0.01, 250, 100)
        reset_counts()
        optim.radam_update(leaves, grads, state, lr, hyper)
        launches = cuda_build.launch_counts()["fused_radam"]
        optim.radam_update_plain(copies[0], grads, copies[1], lr, hyper)
        torch.cuda.synchronize()
        for n in shapes:
            for what, got, want in (
                    ("p", leaves[n], copies[0][n]),
                    ("mu", state["mu"][n], copies[1]["mu"][n]),
                    ("nu", state["nu"][n], copies[1]["nu"][n])):
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"[e2] {label}: fused_radam's {what} of {n} differs "
                        f"from the eager loop's in "
                        f"{int((got != want).sum())} entries")
        if launches != 1:
            raise AssertionError(f"[e2] {label}: {launches} launches a step")
        numel = sum(v.numel() for v in leaves.values())
        least = bound(RADAM_BYTES * numel, RADAM_FLOPS * numel)
        times = []
        for fn in ("plain", "kernel", "kernel", "plain"):
            if fn == "kernel":
                step = lambda: optim.radam_update(leaves, grads, state, lr,
                                                  hyper)
            else:
                step = lambda: optim.radam_update_plain(
                    copies[0], grads, copies[1], lr, hyper)
            times.append(float(np.median(device_ms(torch, step, 3))))
        ms, plain_ms = (times[1] + times[2]) / 2, (times[0] + times[3]) / 2
        print(f"[e2] {label}: {len(shapes)} leaves, {numel} elements, one "
              f"adaptive step bit for bit in {launches} launch; kernel "
              f"{ms:.4f} ms ({times[1]:.4f}, {times[2]:.4f}), eager loop "
              f"{plain_ms:.4f} ms ({times[0]:.4f}, {times[3]:.4f}) device "
              f"time; bound {RADAM_BYTES * numel / 1e6:.1f} MB: "
              f"{least['bound_ms']:.4f} ms ({least['bound_by']}), "
              f"{100 * least['bound_ms'] / ms:.1f}% of it")
        out[label] = {"ms": ms, "plain_ms": plain_ms, "leaves": len(shapes),
                      "elements": numel, **least}
        del leaves, grads, state, copies
        torch.cuda.empty_cache()
    return out


def phase_nerf_small_fused(torch) -> dict:
    """(e3) nerf_small_fused against the eager chain at one request's rows:
    each channel within KERNEL_TOL of its largest value, one launch; then
    both timed in device time (plain, kernel, kernel, plain, each the
    median of 4 readings of 3 calls), against the FMA bound."""
    from indoor_nerf_tpu_torch import cuda_build
    from indoor_nerf_tpu_torch.models import mlp_fused
    from indoor_nerf_tpu_torch.models.mlp import init_nerf_small
    from indoor_nerf_tpu_torch.ops.encoding import sh_encode

    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(13)
    net = init_nerf_small(torch.Generator().manual_seed(13),
                          predict_normals=True).to(dev)
    n = MLP_RAYS * SERVE_SAMPLES
    feats = torch.randn((n, 32), generator=g, device=dev)
    dirs = torch.nn.functional.normalize(
        torch.randn((MLP_RAYS, 3), generator=g, device=dev), dim=-1)
    vf = sh_encode(dirs, degree=4).contiguous()
    keep = torch.rand(n, generator=g, device=dev) < 0.8
    with torch.inference_mode():
        reset_counts()
        got = mlp_fused.nerf_small_fused(net, feats, vf, SERVE_SAMPLES, keep)
        launches = cuda_build.launch_counts()["nerf_small_fused"]
        want = mlp_fused.nerf_small_plain(net, feats, vf, SERVE_SAMPLES, keep)
        torch.cuda.synchronize()
        errs = {}
        for name, sl in (("rgb", slice(0, 3)), ("sigma", slice(3, 4)),
                         ("normal", slice(4, 7))):
            scale = float(want[:, sl].abs().max())
            errs[name] = float((got[:, sl] - want[:, sl]).abs().max()) / scale
        del got, want
        if launches != 1 or max(errs.values()) > KERNEL_TOL:
            raise AssertionError(f"[e3] nerf_small_fused: {launches} launches, "
                                 f"errors {errs} (of each channel's largest; "
                                 f"tol {KERNEL_TOL})")
        least = bound(MLP_BYTES_PER_ROW * n + 16 * 4 * MLP_RAYS,
                      2 * (MLP_FMA_PER_ROW * n + MLP_FMA_PER_RAY * MLP_RAYS))
        fns = {"kernel": lambda: mlp_fused.nerf_small_fused(
                   net, feats, vf, SERVE_SAMPLES, keep),
               "plain": lambda: mlp_fused.nerf_small_plain(
                   net, feats, vf, SERVE_SAMPLES, keep)}
        times = [float(np.median(device_ms(torch, fns[k], 3)))
                 for k in ("plain", "kernel", "kernel", "plain")]
    ms, plain_ms = (times[1] + times[2]) / 2, (times[0] + times[3]) / 2
    blocks = mlp_fused.blocks_per_sm(32, 16, True)
    print(f"[e3] nerf_small_fused: {n} rows ({MLP_RAYS} rays x "
          f"{SERVE_SAMPLES}) in {launches} launch, {blocks} blocks an SM; "
          f"max |diff| of each channel's largest {errs}; kernel {ms:.3f} ms "
          f"({times[1]:.3f}, {times[2]:.3f}), eager chain {plain_ms:.3f} ms "
          f"({times[0]:.3f}, {times[3]:.3f}) device time; bound "
          f"{least['bound_ms']:.3f} ms ({least['bound_by']}), "
          f"{100 * least['bound_ms'] / ms:.1f}% of it")
    del feats, keep, vf
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "rows": n, "errors": errs,
            "blocks_per_sm": blocks, **least}


def phase_training(torch, tag, flags, steps, expect, forbid=(), updated=None):
    """(f), (j), (l), (p): ``steps`` steps through trainer.train, the CLI's
    entry point; every kernel in ``expect`` must launch, none in ``forbid``;
    ``updated`` as hold_optimizer takes it."""
    from indoor_nerf_tpu_torch.train.config import parse_args
    from indoor_nerf_tpu_torch.train.trainer import train

    args = parse_args(flags + ["--n_iters", str(steps), "--i_print", "50"])
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # this path's run starts here
    out = train(args)
    launches = launch_counts()  # ... and ends here
    radam = hold_optimizer(tag, len(out["losses"]), out["state"]["params"],
                           updated)
    losses = np.asarray(out["losses"])
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    steps_s = steps / out["seconds"]
    what = ("--use_pallas at the block-hash defaults" if flags is TILE_FLAGS
            else " ".join(flags[len(SERVE_FLAGS):]) or "flat encode")
    print(f"[{tag}] {what}: "
          f"{steps} steps of {args.N_rand} rays: {steps_s:.2f} "
          f"steps/s, {steps_s * args.N_rand:.0f} rays/s; loss mean of the "
          f"first 10 steps {first:.6f}, last 10 {last:.6f}; PSNR "
          f"{out['psnrs'][0]:.2f} -> {out['psnrs'][-1]:.2f} dB; launches "
          f"{ {k: v for k, v in launches.items() if v} }, {radam}; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not np.all(np.isfinite(losses)):
        raise AssertionError("training loss went non-finite")
    if not last < first:
        raise AssertionError(f"loss did not fall: {first} -> {last}")
    for name in expect:
        if launches[name] <= 0:
            raise AssertionError(f"training launched no {name} kernel")
    for name in forbid:
        if launches[name] != 0:
            raise AssertionError(f"training launched {name} "
                                 f"{launches[name]} times on this route")
    return out, launches


def step_from(torch, flags, trained, batch_seed=5, draw_seed=3,
              at_step=False):
    """``(cfg, one_step)``: ``one_step(cfg)`` takes one train step under
    ``cfg`` from the params of ``trained`` with zero moments, always on the
    same rays and the same draws (those of ``flags``' config and the two
    seeds). At step 0, or with ``at_step`` at ``trained``'s step with its
    quantizers, loss EMAs and inflation EMA (A-CAQ's controller reads
    them)."""
    from indoor_nerf_tpu_torch.train.config import parse_args
    from indoor_nerf_tpu_torch.train.step import draw_step, make_train_state, train_step
    from indoor_nerf_tpu_torch.train.trainer import one_batch

    dev = torch.device("cuda:0")
    cli = parse_args(flags)
    cfg, batch = one_batch(cli, dev, seed=batch_seed)
    params = {k: v.detach() for k, v in trained["params"].items()
              if not isinstance(v, torch.nn.Module)}
    params["coarse"] = copy.deepcopy(trained["params"]["coarse"])
    step = int(trained["step"]) if at_step else 0
    draws = draw_step(torch.Generator(device=dev).manual_seed(draw_seed), cfg,
                      step, cli.N_rand, "spatial_coords" in batch,
                      n_reg_rays(batch))

    def one_step(cfg, run=None):
        """The step; ``run(state, batch, draws)`` in place of train_step."""
        # Zero moments: after this first step mu = 0.1 g and nu = 0.01 g^2.
        state = make_train_state(copy.deepcopy(params), trained["occ"].copy())
        if at_step:
            state["step"], state["quant"] = step, copy.deepcopy(trained["quant"])
            for k in ("loss_ema", "loss_ema_slow", "best_loss", "infl_ema"):
                state[k] = trained[k].clone()
        if run is not None:
            return run(state, batch, draws)
        return train_step(state, batch, cfg, draws=draws)

    return cfg, one_step


def n_reg_rays(batch) -> int:
    """The patch rays of a batch of a --reg_views run (0 without)."""
    return batch["reg_rays_o"].shape[0] if "reg_rays_o" in batch else 0


def encode_steps(torch, flags, trained, **seeds) -> dict:
    """One step of ``flags`` from ``trained`` three ways on the same rays
    and draws: through the encode's kernels, with the backward's kernels
    alone replaced by their plain versions (the same forward), and with
    every kernel replaced."""
    from indoor_nerf_tpu_torch.ops import blockhash
    from indoor_nerf_tpu_torch.ops.table_scatter import table_scatter_plain
    from indoor_nerf_tpu_torch.ops.tent_contract import tent_contract_plain

    cfg, one_step = step_from(torch, flags, trained, **seeds)
    steps = {"kernels": one_step(cfg)}
    with mock.patch.object(blockhash, "table_scatter", table_scatter_plain), \
            mock.patch.object(blockhash, "grouped_scatter",
                              blockhash.grouped_scatter_plain):
        steps["plain backward"] = one_step(cfg)
        with mock.patch.object(blockhash, "tent_contract", tent_contract_plain):
            steps["plain"] = one_step(cfg)
    return steps


def encode_step_pairs(steps: dict) -> list:
    """``(what, got, want, same_forward)`` for ``hold_steps``."""
    return [("kernels vs plain backward, same forward", steps["kernels"],
             steps["plain backward"], True),
            ("kernels vs plain versions", steps["kernels"], steps["plain"],
             False)]


def step_checks(torch, got_step, want_step, same_forward: bool) -> list:
    """``(name, error, tolerance)`` for two ``(state, metrics)`` of one step.

    Where both steps ran the same forward, the MLP's moments must agree bit
    for bit and the table's within ``SAME_FORWARD_TABLE_TOLS``. Where the
    forwards differ in rounding, every moment is held relative in norm
    (``FORWARD_NORM_TOL``) and its error by entry is reported with no
    tolerance."""
    (got, gm), (want, wm) = got_step, want_step
    torch.cuda.synchronize()
    density = want["occ"]["density"]
    checks = [("loss (relative)",
               abs(float(gm["loss"]) - float(wm["loss"])) / float(wm["loss"]), 1e-5),
              ("occ density (of the largest)",
               float((got["occ"]["density"] - density).abs().max()
                     / density.abs().max()), 1e-4)]
    for i, key in enumerate(("mu", "nu")):
        for name, w in want["opt"][key].items():
            g = got["opt"][key][name]
            by_entry = float((g - w).abs().max() / w.abs().max())
            by_norm = float(torch.linalg.norm(g - w) / torch.linalg.norm(w))
            if not same_forward:
                tols = (None, FORWARD_NORM_TOL)
            elif name == "table":
                tols = (SAME_FORWARD_TABLE_TOLS[i], SAME_FORWARD_TABLE_TOLS[2])
            else:
                tols = (0.0, 0.0)
            checks += [(f"{key} {name} (of the largest entry)", by_entry, tols[0]),
                       (f"{key} {name} (relative norm)", by_norm, tols[1])]
    return checks


def hold_steps(torch, tag, what, got_step, want_step, same_forward) -> None:
    """Raises on the first of ``step_checks`` over its tolerance, else
    prints them all."""
    checks = step_checks(torch, got_step, want_step, same_forward)
    for name, err, tol in checks:
        if tol is not None and not err <= tol:
            raise AssertionError(f"{what}: {name} {err} > {tol}")
    print(f"[{tag}] one step, {what}: loss {float(got_step[1]['loss']):.6f} vs "
          f"{float(want_step[1]['loss']):.6f}; "
          + "; ".join(f"{w} {e:.3e}" + (f" (tol {t:.3e})" if t is not None else "")
                      for w, e, t in checks))


def phase_step_check(torch, tag, flags, trained) -> None:
    """(g), (k) One step with the kernels and with their plain versions."""
    for pair in encode_step_pairs(encode_steps(torch, flags, trained)):
        hold_steps(torch, tag, *pair)


def without_tile_interp(cfg):
    """``cfg`` (a TrainConfig) on the default route of the same grid."""
    fc = cfg.render.field
    return dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, field=dataclasses.replace(fc, block_grid=dataclasses.replace(
            fc.block_grid, tile_interp=False))))


def tile_steps(torch, trained, **seeds) -> dict:
    """One --use_pallas step from ``trained`` four ways on the same rays and
    draws: the tile route through its kernels, with the backward's kernel
    alone replaced by its plain version, with both replaced, and the
    default route of the same config."""
    from indoor_nerf_tpu_torch.ops import tile_interp as ti

    cfg, one_step = step_from(torch, TILE_FLAGS, trained, **seeds)
    steps = {"kernels": one_step(cfg)}
    with mock.patch.object(ti, "tile_interp_bwd_rows",
                           ti.tile_interp_bwd_rows_plain):
        steps["plain backward"] = one_step(cfg)
        with mock.patch.object(ti, "tile_interp_fwd", ti.tile_interp_fwd_plain):
            steps["plain"] = one_step(cfg)
    steps["default route"] = one_step(without_tile_interp(cfg))
    return steps


def tile_step_pairs(steps: dict) -> list:
    """``(what, got, want, same_forward)`` for ``hold_steps``."""
    return [("tile route, kernels vs plain backward, same forward",
             steps["kernels"], steps["plain backward"], True),
            ("tile route, kernels vs plain versions", steps["kernels"],
             steps["plain"], False),
            ("tile route vs default route (tent_contract + table_scatter, f32)",
             steps["kernels"], steps["default route"], False)]


def print_spread(tag, trials, seen) -> None:
    """Median, 99th percentile, largest, and the count over the tolerance
    of each ``(what, name, tol) -> errors`` of ``seen``."""
    for (what, name, tol), errs in seen.items():
        r = np.sort(np.asarray(errs))
        held = ("not held" if tol is None else
                f"tol {tol:.3e}, {int((r > tol).sum())} over it")
        print(f"[step-spread {tag}] {trials} steps, {what}: {name}: median "
              f"{np.median(r):.3e}, 99th percentile "
              f"{np.quantile(r, 0.99):.3e}, largest {r[-1]:.3e}; {held}")


def card_vs_cpu_spread(torch, trials: int) -> None:
    """``--step-spread N``, second part: the card-against-CPU steps (y2),
    (sp2), (aq2), (rp2) and (md1)'s sharded-against-single step over N
    batches and draws each, from the states their phases train (as the
    smoke run trains them, in one temporary directory): each error's
    median, 99th percentile and largest, and the count over its
    tolerance. This is where RESOLVED_RTOL and UNRESOLVED_SHARE are read
    against."""
    def collect(tag, check):
        seen: dict = {}
        for t in range(trials):
            for name, err, tol in check(100 + t, 200 + t):
                seen.setdefault(("card vs CPU" if tag != "md1" else
                                 "sharded vs single", name, tol),
                                []).append(err)
        print_spread(tag, trials, seen)

    def via_card_vs_cpu(tag, flags, state, **kw):
        def check(b, d):
            _, metrics, _ = quietly(functools.partial(
                card_vs_cpu_step, torch, tag, flags, state, batch_seed=b,
                draw_seed=d, hold=False, **kw))[0]
            return [(k, v, card_cpu_tol(k))
                    for k, v in metrics["errs"].items()]
        collect(tag, check)

    with tempfile.TemporaryDirectory() as workdir:
        files = phase_from_files(torch, workdir)
        parity = phase_parity_from_files(torch, workdir)
        collect("y2", lambda b, d: [
            (k, v, 0.25 if k == "rays moved (share)" else card_cpu_tol(
                "loss" if k.startswith("loss") else k))
            for k, v in quietly(phase_parity_step_check, torch,
                                parity["flags"], parity["state"], b, d,
                                False)[0].items()])
        del parity
        torch.cuda.empty_cache()
        prior = phase_priors(torch, workdir)
        via_card_vs_cpu("sp2", prior["flags"]
                        + ["--structural_loss_start_iter", "0"],
                        {**prior["state"], "step": 0})
        del prior
        torch.cuda.empty_cache()
        acaq = phase_acaq(torch, workdir, files)
        via_card_vs_cpu("aq2", acaq["flags"], acaq["state"], hold_loss=False)
        del acaq
        torch.cuda.empty_cache()
        reg = phase_reg_patches(torch, workdir, files)
        via_card_vs_cpu("rp2", reg["flags"], reg["state"], hold_loss=False)
        del reg
        torch.cuda.empty_cache()
        md = phase_multihost(torch, workdir, files)
        collect("md1", lambda b, d: quietly(
            md_step_check, torch, md["flags"], md["state"], b, d, False)[0])
        torch.distributed.destroy_process_group()


def step_spread(torch, trials: int) -> None:
    """``--step-spread N``: every check of (g), (k) and (q)'s one-step
    comparisons over N batches and draws each, from 200 (tile route: 100)
    trained steps: median, 99th percentile and largest error, and how many
    lie over the tolerance. This is where ``FORWARD_NORM_TOL`` and the
    choice of its measure come from. Then ``card_vs_cpu_spread``."""
    phase_build()
    for tag, flags, n_steps, steps_of, pairs_of in (
            ("g", SERVE_FLAGS, TRAIN_STEPS,
             functools.partial(encode_steps, torch, SERVE_FLAGS), encode_step_pairs),
            ("k", GROUP_FLAGS, TRAIN_STEPS,
             functools.partial(encode_steps, torch, GROUP_FLAGS), encode_step_pairs),
            ("q", TILE_FLAGS, TILE_STEPS,
             functools.partial(tile_steps, torch), tile_step_pairs)):
        trained, _ = phase_training(torch, tag, flags, n_steps, ())
        seen: dict = {}
        for t in range(trials):
            steps = steps_of(trained["state"], batch_seed=100 + t,
                             draw_seed=200 + t)
            for what, got, want, same_forward in pairs_of(steps):
                for name, err, tol in step_checks(torch, got, want, same_forward):
                    seen.setdefault((what, name, tol), []).append(err)
            del steps
        print_spread(tag, trials, seen)
        del trained
        torch.cuda.empty_cache()
    card_vs_cpu_spread(torch, trials)


def phase_tile_step_check(torch, trained) -> None:
    """(q) One step four ways, then both routes' steps in alternating
    windows."""
    from indoor_nerf_tpu_torch.train.config import parse_args
    from indoor_nerf_tpu_torch.train.step import init_train_state, train_step
    from indoor_nerf_tpu_torch.train.trainer import one_batch

    dev = torch.device("cuda:0")
    for pair in tile_step_pairs(tile_steps(torch, trained)):
        hold_steps(torch, "q", *pair)
    torch.cuda.empty_cache()

    cli = parse_args(TILE_FLAGS)
    cfg, batch = one_batch(cli, dev, seed=6)
    default = without_tile_interp(cfg)
    runs = {}
    for name, c in (("tile_interp", cfg), ("default", default)):
        state = init_train_state(torch.Generator(device=dev).manual_seed(0),
                                 c, dev)
        gen = torch.Generator(device=dev).manual_seed(1)
        for _ in range(TILE_TIMED_STEPS):  # warm-up
            state, _ = train_step(state, batch, c, gen)
        runs[name] = (c, state, gen)
    torch.cuda.synchronize(dev)
    ms = {"tile_interp": [], "default": []}
    for name in ("default", "tile_interp", "tile_interp", "default") * 2:
        c, state, gen = runs[name]
        t0 = time.perf_counter()
        for _ in range(TILE_TIMED_STEPS):
            state, metrics = train_step(state, batch, c, gen)
        torch.cuda.synchronize(dev)
        ms[name].append((time.perf_counter() - t0) / TILE_TIMED_STEPS * 1e3)
        runs[name] = (c, state, gen)
        if not np.isfinite(float(metrics["loss"])):
            raise AssertionError(f"{name} route step: non-finite loss")
    print(f"[q] step at the block-hash defaults (16x2, block_size 4, f32), "
          f"{cli.N_rand} rays, {TILE_TIMED_STEPS} steps per window, "
          "alternating: "
          + "; ".join(f"{k} route {', '.join(f'{v:.3f}' for v in vs)} ms/step "
                      f"({cli.N_rand / (sum(vs) / len(vs)) * 1e3:.0f} rays/s)"
                      for k, vs in ms.items()))
    del runs
    torch.cuda.empty_cache()


def phase_group_scatter(torch) -> dict:
    """(i) group_scatter against its plain version at the grouped shape, in
    both forms."""
    from indoor_nerf_tpu_torch.ops import blockhash
    from indoor_nerf_tpu_torch.ops import group_scatter as gs
    from indoor_nerf_tpu_torch.path_streams import (
        count_group_reductions,
        grouped_stream,
    )

    dev = torch.device("cuda:0")
    g0 = torch.Generator(device=dev).manual_seed(4)
    side, F, lpf, L, R = 4, 4, 64, 8, 8192
    Rn, S = 4096, 32
    n_groups = Rn * sum(S // G for G in GROUPS)
    flagship = None
    for label, one_row in (("flagship", False), ("one_row", True)):
        g = torch.randn((Rn, S, L * F), generator=g0, device=dev)
        if one_row:
            g = g.abs()  # sums of ~10^5 terms that do not cancel
        p = torch.rand((Rn, S, L, 3), generator=g0, device=dev) * (side - 1)
        flat = p.view(-1, 3)
        flat[:4096] = torch.randint(0, side, (4096, 3), generator=g0,
                                    device=dev).float()  # tent kinks
        flat[4096:8192] = side - 1
        row = torch.empty((Rn, S, L), dtype=torch.int32, device=dev)
        for l, G in enumerate(GROUPS):  # one anchor row per group
            local = (torch.zeros((Rn, S // G), dtype=torch.int64, device=dev)
                     if one_row else torch.randint(0, R, (Rn, S // G),
                                                   generator=g0, device=dev))
            row[:, :, l] = (local.repeat_interleave(G, dim=1) + l * R).int()
        args = (g, row, p, GROUPS, L * R, side, lpf, torch.bfloat16)
        stats = hold_scatter(
            torch, "i", f"{label}: {Rn} rays x {S} samples x {L} levels, G "
            f"{GROUPS} ({n_groups} groups), F {F} lpf {lpf} side {side} bf16 "
            f"rounding, table {L * R}x{F * lpf} f32", gs.group_scatter,
            gs.group_scatter_plain, args, (L * R, F * lpf))
        if flagship is None:
            flagship = stats
            flagship["random_reductions_from_inputs"] = list(
                count_group_reductions(g, p, GROUPS, side, lpf, torch.bfloat16))
        del g, p, flat, row, args
    torch.cuda.empty_cache()

    # The stream of a real grouped step, through the form the path runs:
    # the anchor math inside the kernel.
    args = grouped_stream(dev)
    g, v0, w, level_ids, config, groups, n_rows = args
    if (groups != GROUPS or g.shape != (Rn, S, L * F) or n_rows != L * R
            or (config.side, config.lanes_per_feature, config.scatter_dtype)
            != (side, lpf, "bfloat16")):
        raise AssertionError(f"grouped stream: groups {groups}, g "
                             f"{tuple(g.shape)}, {n_rows} rows")
    row, p = blockhash._grouped_coords(v0, w, level_ids, config, groups)
    k_row, k_p = gs.anchor_coords(v0, w, level_ids, groups, side,
                                  config.log2_rows, blockhash._BLOCK_PRIMES)
    torch.cuda.synchronize()
    if not (torch.equal(k_row, row) and torch.equal(k_p, p)):
        raise AssertionError(
            "grouped_path: the kernel's anchor rows and positions differ from "
            f"_grouped_coords' ({int((k_row != row).sum())} rows, "
            f"{int((k_p != p).sum())} coordinates)")
    clamped = int(((p == 0) | (p == side - 1)).any(-1).sum())
    del k_row, k_p
    path = hold_scatter(
        torch, "i", f"grouped_path: the grouped_scatter call of a real grouped "
        f"step, anchor math inside the kernel, rows and positions bit for bit "
        f"_grouped_coords' ({clamped} of {row.numel()} members on a face of "
        f"their anchor tile), {int((g.reshape(-1, F) == 0).all(1).sum())} of "
        f"them with a zero cotangent",
        blockhash.grouped_scatter, blockhash.grouped_scatter_plain, args,
        (n_rows, F * lpf))

    def given_form():
        r, q = blockhash._grouped_coords(v0, w, level_ids, config, groups)
        return gs.group_scatter(g, r, q, groups, n_rows, side, lpf,
                                config.torch_scatter_dtype)

    fused_ms, given_ms, _ = alternate(
        torch, given_form, lambda: blockhash.grouped_scatter(*args), 10)
    scalar, vector = count_group_reductions(g, p, groups, side, lpf,
                                            config.torch_scatter_dtype)
    print(f"[i] grouped_path: anchor math inside the kernel {fused_ms:.4f} ms; "
          f"_grouped_coords + the given form {given_ms:.4f} ms (given, fused, "
          f"fused, given; 10 launches each); reductions computed from the inputs (not "
          f"counted on the card): {scalar} scalar f32 atomics with one thread "
          f"per (group, feature), {vector} vector reductions (one per vertex "
          f"of a group's merged row with a nonzero entry); on the random rows "
          f"{flagship['random_reductions_from_inputs']}")
    flagship.update({"path_ms": path["ms"], "path_plain_ms": path["plain_ms"],
                     "path_max_abs_err": path["max_abs_err"],
                     "path_groups": n_groups,
                     "path_bound_ms": path["bound_ms"],
                     "path_given_form_ms": given_ms,
                     "reductions_from_inputs": [scalar, vector]})
    del args, g, v0, w, row, p
    torch.cuda.empty_cache()
    return flagship


def _bench_config():
    """The root bench.py's TrainConfig, built from the port's classes."""
    from indoor_nerf_tpu_torch.models.field import FieldConfig
    from indoor_nerf_tpu_torch.ops.blockhash import BlockHashConfig
    from indoor_nerf_tpu_torch.ops.occupancy import OccupancyConfig
    from indoor_nerf_tpu_torch.render.renderer import RenderConfig
    from indoor_nerf_tpu_torch.train.step import TrainConfig

    bbox = 1.5
    bb = ((-bbox,) * 3, (bbox,) * 3)
    block_grid = BlockHashConfig(
        bbox_min=bb[0], bbox_max=bb[1], n_levels=8, n_features_per_level=4,
        log2_rows=13, base_resolution=16, finest_resolution=512,
        block_size=3, gather_dtype="bfloat16", scatter_dtype="bfloat16",
    )
    occupancy = OccupancyConfig(
        bbox_min=bb[0], bbox_max=bb[1], resolution=64, warmup_steps=8,
        weighting="transmittance",
    )
    fc = FieldConfig(block_grid=block_grid, i_embed=3, n_importance=0)
    rc = RenderConfig(field=fc, n_samples=64, n_importance=0,
                      white_bkgd=True, occupancy=occupancy, n_occ_samples=32)
    return TrainConfig(render=rc, near=2.0, far=6.0, n_rand=BENCH_RAYS)


def _bench_batch(n_rand: int = BENCH_RAYS, bbox: float = 1.5):
    """The root bench.py's numpy ray batch from seed 0."""
    rng = np.random.default_rng(0)
    d = rng.normal(size=(n_rand, 3))
    o = 4.0 * d / np.linalg.norm(d, axis=-1, keepdims=True)
    aim = rng.uniform(-bbox, bbox, size=(n_rand, 3))
    dirs = aim - o
    return {
        "rays_o": o.astype(np.float32),
        "rays_d": (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
                   ).astype(np.float32),
        "target": rng.uniform(size=(n_rand, 3)).astype(np.float32),
    }


def bench_with(**block_grid):
    """The root bench's config with ``block_grid``'s fields replaced."""
    cfg = _bench_config()
    fc = cfg.render.field
    return dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, field=dataclasses.replace(fc, block_grid=dataclasses.replace(
            fc.block_grid, **block_grid))))


def alternating_step_ms(torch, tag, configs) -> dict:
    """The root bench's step under each of two ``configs`` ``{name: cfg}``,
    in eight alternating windows of TIMED_STEPS steps (a, b, b, a, twice)
    after a warm-up of as many: ms a step of each window, printed."""
    from indoor_nerf_tpu_torch.train.step import init_train_state, train_step

    dev = torch.device("cuda:0")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in _bench_batch().items()}
    runs = {}
    for name, cfg in configs.items():
        state = init_train_state(torch.Generator(device=dev).manual_seed(0),
                                 cfg, dev)
        gen = torch.Generator(device=dev).manual_seed(1)
        for _ in range(TIMED_STEPS):  # warm-up, as the bench
            state, _ = train_step(state, batch, cfg, gen)
        runs[name] = (cfg, state, gen)
    torch.cuda.synchronize(dev)
    a, b = configs
    ms = {a: [], b: []}
    for name in (a, b, b, a) * 2:
        cfg, state, gen = runs[name]
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            state, metrics = train_step(state, batch, cfg, gen)
        torch.cuda.synchronize(dev)
        ms[name].append((time.perf_counter() - t0) / TIMED_STEPS * 1e3)
        if not np.isfinite(float(metrics["loss"])):
            raise AssertionError(f"{name} bench step: non-finite loss")
    print(f"[{tag}] bench step, {TIMED_STEPS} steps per window, alternating: "
          + "; ".join(f"{k} {', '.join(f'{v:.3f}' for v in vs)} ms/step "
                      f"({BENCH_RAYS / (sum(vs) / len(vs)) * 1e3:.0f} rays/s)"
                      for k, vs in ms.items()))
    return ms


def phase_tile_interp(torch) -> dict:
    """(n) tile_interp_fwd and tile_interp_bwd_rows against their plain
    versions; returns the numbers of both kernels' entries."""
    from indoor_nerf_tpu_torch.ops import tent_contract as tc
    from indoor_nerf_tpu_torch.ops import tile_interp as ti

    dev = torch.device("cuda:0")
    g0 = torch.Generator(device=dev).manual_seed(6)
    side = ti.SIDE
    stats = {}
    for label, M in (("training", 4096 * 32 * 16), ("ragged", 100003)):
        rows = torch.randn((M, 2 * ti.LANES), generator=g0, device=dev)
        g = torch.randn((M, 2), generator=g0, device=dev)
        p = torch.rand((M, 3), generator=g0, device=dev) * (side - 1)
        p[:4096] = torch.randint(0, side, (4096, 3), generator=g0,
                                 device=dev).float()  # tent kinks
        p[4096:8192] = side - 1
        got = ti.tile_interp_fwd(rows, p)
        want = ti.tile_interp_fwd_plain(rows, p)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not (got.shape == (M, 2) and err <= KERNEL_TOL):
            raise AssertionError(f"{label}: tile_interp_fwd vs plain max "
                                 f"|diff| {err} > {KERNEL_TOL}")
        fwd_bound = bound(nbytes(rows, p, got), M * 2 * ti.LANES * 2 + M * ti.LANES * 11)
        del want
        drows = ti.tile_interp_bwd_rows(p, g)
        dwant = ti.tile_interp_bwd_rows_plain(p, g)
        torch.cuda.synchronize()
        derr = float((drows - dwant).abs().max())
        if not (drows.shape == (M, 2 * ti.LANES) and torch.equal(drows, dwant)):
            raise AssertionError(f"{label}: tile_interp_bwd_rows differs from "
                                 f"its plain version (max |diff| {derr}); the "
                                 "products are the same __fmul_rn chain, so "
                                 "they must agree bit for bit")
        bwd_bound = bound(nbytes(p, g, drows), M * ti.LANES * 13)
        del drows, dwant, got
        iters = 10 if M > 100000 else 100
        ms, plain_ms, t = alternate(
            torch, lambda: ti.tile_interp_fwd_plain(rows, p),
            lambda: ti.tile_interp_fwd(rows, p), iters)
        print(f"[n] {label}: tile_interp_fwd rows {tuple(rows.shape)} f32: max "
              f"|diff| {err:.3e} (tol {KERNEL_TOL}); kernel {ms:.4f} ms "
              f"({t[1]:.4f}, {t[2]:.4f}), plain {plain_ms:.4f} ms ({t[0]:.4f}, "
              f"{t[3]:.4f}), bound {fwd_bound['bound_ms']:.4f} ms by "
              f"{fwd_bound['bound_by']}")
        bms, bplain_ms, bt = alternate(
            torch, lambda: ti.tile_interp_bwd_rows_plain(p, g),
            lambda: ti.tile_interp_bwd_rows(p, g), iters)
        print(f"[n] {label}: tile_interp_bwd_rows M {M}: bit for bit (max "
              f"|diff| {derr:.1e}); kernel {bms:.4f} ms ({bt[1]:.4f}, "
              f"{bt[2]:.4f}), plain {bplain_ms:.4f} ms ({bt[0]:.4f}, "
              f"{bt[3]:.4f}), bound {bwd_bound['bound_ms']:.4f} ms by "
              f"{bwd_bound['bound_by']}")
        if label == "training":
            # No one PyTorch call computes the weights from p and contracts
            # (or expands) with them: no library time.
            stats["tile_interp_fwd"] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                **fwd_bound, "library_ms": None}
            stats["tile_interp_bwd_rows"] = {
                "max_abs_err": derr, "ms": bms, "plain_ms": bplain_ms,
                **bwd_bound, "library_ms": None}
            # The tile route's forward (gather + kernel) against the fused
            # kernel of the default route, on one table and one index.
            del rows, g
            torch.cuda.empty_cache()
            table = torch.randn((65536, 2 * ti.LANES), generator=g0, device=dev)
            flat_row = torch.randint(0, 65536, (M,), generator=g0, device=dev,
                                     dtype=torch.int32)
            a = ti.tile_interp_fwd(table.index_select(0, flat_row), p)
            packed = tc.pack_rows(table, 2)  # f32, what tent_contract reads
            b = tc.tent_contract(packed, flat_row, p, side, 2)
            torch.cuda.synchronize()
            kk = float((a - b).abs().max())
            if kk > KERNEL_TOL:
                raise AssertionError("tile_interp_fwd(table[flat_row]) vs "
                                     f"tent_contract: {kk} > {KERNEL_TOL}")
            del a, b
            t_route = cuda_ms(torch, lambda: ti.tile_interp_fwd(
                table.index_select(0, flat_row), p), 10)
            t_gather = cuda_ms(torch, lambda: table.index_select(0, flat_row), 10)
            t_fused = cuda_ms(torch, lambda: tc.tent_contract(
                packed, flat_row, p, side, 2), 10)
            print(f"[n] kernel against kernel, table {tuple(table.shape)} f32, "
                  f"M {M}: tile_interp_fwd(table[flat_row], p) vs "
                  f"tent_contract(pack_rows(table), flat_row, p, 5, 2) max |diff| "
                  f"{kk:.3e} (tol {KERNEL_TOL}); gather + tile_interp_fwd "
                  f"{t_route:.4f} ms (the gather alone {t_gather:.4f} ms), "
                  f"tent_contract {t_fused:.4f} ms")
            del table, packed, flat_row
        del p
        torch.cuda.empty_cache()
    return stats


def phase_lane_select(torch) -> dict:
    """(o) lane_select forward and backward against their plain versions and
    the library calls; returns the numbers and launches of both entries."""
    from indoor_nerf_tpu_torch.ops import lane_gather as lg

    dev = torch.device("cuda:0")
    g0 = torch.Generator(device=dev).manual_seed(7)
    stats = {}
    reset_counts()
    for label, N, k in (("corners", 4096 * 32 * 16, 8), ("full", 32768, 128)):
        values = torch.randn((N, lg.LANES), generator=g0, device=dev)
        g = torch.randn((N, k), generator=g0, device=dev)
        idx = torch.randint(0, lg.LANES, (N, k), generator=g0, device=dev,
                            dtype=torch.int32)  # with replacement: repeats
        idx[0] = 77
        idx64 = idx.long()
        vg = values.clone().requires_grad_(True)
        got = lg.lane_select(vg, idx)
        (dgot,) = torch.autograd.grad(got, vg, grad_outputs=g)
        want = lg.lane_select_plain(values, idx)
        dwant = lg.lane_select_grad_plain(idx, g)
        torch.cuda.synchronize()
        scale = float(dwant.abs().max())
        derr = float((dgot - dwant).abs().max())
        if not torch.equal(got.detach(), want):
            raise AssertionError(f"{label}: lane_select differs from torch.gather")
        if not (dgot.shape == (N, lg.LANES) and derr <= LANE_RTOL * scale):
            raise AssertionError(f"{label}: lane_select_grad vs the one-hot "
                                 f"sum {derr} > {LANE_RTOL} x {scale}")
        ferr = float((got.detach() - want).abs().max())
        # values counts as what the function needs of it: the distinct
        # 32-byte sectors (8 lanes; the least the card reads from device
        # memory) that this run's idx touches, not the whole [N, 128] array.
        sectors = int(torch.zeros((N, lg.LANES // 8), dtype=torch.bool, device=dev)
                      .scatter_(1, idx64 // 8, True).sum())
        fwd_bound = bound(sectors * 32 + nbytes(idx, want), 0)
        bwd_bound = bound(nbytes(idx, g, dwant), N * k)
        del vg, got, dgot, want, dwant
        iters = 10
        ms, plain_ms, t = alternate(
            torch, lambda: lg.lane_select_plain(values, idx),
            lambda: lg.lane_select_fwd(values, idx), iters)
        lib = cuda_ms(torch, lambda: torch.gather(values, 1, idx64), iters)
        print(f"[o] {label}: lane_select_fwd N {N} k {k}: bit for bit (max "
              f"|diff| {ferr:.1e}); idx touches {sectors} 32-byte sectors of "
              f"values ({sectors * 32 / nbytes(values):.3f} of its bytes); kernel "
              f"{ms:.4f} ms ({t[1]:.4f}, {t[2]:.4f}), plain (int64 cast + "
              f"torch.gather) {plain_ms:.4f} ms ({t[0]:.4f}, {t[3]:.4f}), "
              f"torch.gather alone {lib:.4f} ms, bound "
              f"{fwd_bound['bound_ms']:.4f} ms by {fwd_bound['bound_by']}")
        bms, bplain_ms, bt = alternate(
            torch, lambda: lg.lane_select_grad_plain(idx, g),
            lambda: lg.lane_select_grad(idx, g), iters, plain_iters=3)
        blib = cuda_ms(torch, lambda: torch.zeros_like(values).scatter_add_(
            1, idx64, g), iters)
        print(f"[o] {label}: lane_select_grad N {N} k {k}: max |diff| "
              f"{derr:.3e} (largest entry {scale:.3e}, tol {LANE_RTOL} of it); "
              f"kernel {bms:.4f} ms ({bt[1]:.4f}, {bt[2]:.4f}), plain (one-hot "
              f"sum) {bplain_ms:.4f} ms ({bt[0]:.4f}, {bt[3]:.4f}), "
              f"zeros.scatter_add_ {blib:.4f} ms, bound "
              f"{bwd_bound['bound_ms']:.4f} ms by {bwd_bound['bound_by']}")
        if label == "corners":
            stats["lane_select_fwd"] = {
                "max_abs_err": ferr, "ms": ms, "plain_ms": plain_ms,
                **fwd_bound, "library_ms": lib}
            stats["lane_select_grad"] = {
                "max_abs_err": derr, "ms": bms, "plain_ms": bplain_ms,
                **bwd_bound, "library_ms": blib}
        del values, g, idx, idx64
        torch.cuda.empty_cache()
    # No path of either package runs lane_select: its launches are this
    # phase's own.
    counts = launch_counts()
    for name in lg.KERNELS:
        stats[name]["launches"] = counts[name]
    return stats


def phase_tile_render(torch) -> None:
    """(r) One 100x100 test-mode render on the tile route and on the default
    route of the same config."""
    from indoor_nerf_tpu_torch.data.load import load_dataset
    from indoor_nerf_tpu_torch.models.field import init_field_params, serving_params
    from indoor_nerf_tpu_torch.render.renderer import (
        bytes_per_ray,
        default_tile_rays,
        make_image_renderer,
    )
    from indoor_nerf_tpu_torch.train.config import parse_args
    from indoor_nerf_tpu_torch.train.trainer import build_train_config

    dev = torch.device("cuda:0")
    cli = parse_args(TILE_FLAGS)
    scene = load_dataset(cli)
    cfg = build_train_config(cli, scene)
    g = torch.Generator(device=dev).manual_seed(8)
    params = init_field_params(g, cfg.render.field, dev)
    # An O(1) table so the rays are not transparent, and a random grid.
    params["table"] = torch.randn(params["table"].shape, generator=g, device=dev)
    params = serving_params(params, cfg.render.field)
    occ = {"density": 4.0 * torch.rand(cfg.render.occupancy.n_cells,
                                        generator=g, device=dev)}
    H = W = 100
    focal = scene.hwf[2] * (W / scene.hwf[1])
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    c2w = scene.poses[scene.i_test[0]]
    out, peaks, tiles = {}, {}, {}
    for name, c in (("tile_interp", cfg), ("default", without_tile_interp(cfg))):
        rc = c.render.test_mode()
        torch.cuda.empty_cache()
        tiles[name] = default_tile_rays(dev, rc)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        out[name] = make_image_renderer(rc, H, W)(params, c2w, K, scene.near,
                                                  scene.far, occ)
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() / 2**30
        ran = {k: v for k, v in launch_counts().items() if v}
        want = {"tile_interp_fwd"} if name == "tile_interp" else {"tent_contract"}
        if set(ran) != want:
            raise AssertionError(f"{name} route render launched {ran}")
    for k in ("rgb_map", "depth_map"):
        if not bool(torch.isfinite(out["tile_interp"][k]).all()):
            raise AssertionError(f"100x100 tile-route render: non-finite {k}")
    err = float((out["tile_interp"]["rgb_map"]
                 - out["default"]["rgb_map"]).abs().max())
    acc = out["tile_interp"]["acc_map"]
    print(f"[r] 100x100 render at the block-hash defaults, tile route vs "
          f"default route: rgb max |diff| {err:.3e} (tol {RENDER_TOL}); acc in "
          f"[{float(acc.min()):.3f}, {float(acc.max()):.3f}]; tile route "
          f"{bytes_per_ray(cfg.render) / 1024:.0f} KiB per ray, tiles of "
          f"{tiles['tile_interp']} rays, peak device memory "
          f"{peaks['tile_interp']:.2f} GiB; default route tiles of "
          f"{tiles['default']} rays, peak {peaks['default']:.2f} GiB")
    if err > RENDER_TOL:
        raise AssertionError(f"render rgb tile vs default route {err} > {RENDER_TOL}")


def psnr(a, b) -> float:
    return float(-10.0 * np.log10(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


@contextlib.contextmanager
def http_server(handler):
    """A render server on 127.0.0.1 for the block; yields its base URL."""
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    if thread.is_alive():
        raise AssertionError("server thread did not stop")


def quietly(fn, *args):
    """``(fn(*args), what it printed)``; the text is printed afterwards."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def phase_checkpoint_serve(torch, basedir):
    """(s) train -> checkpoint -> resume -> serve. Returns the run's flags,
    its state after the resumed run and its scene."""
    from indoor_nerf_tpu_torch import serve
    from indoor_nerf_tpu_torch.data.load import load_dataset
    from indoor_nerf_tpu_torch.train.config import parse_args
    from indoor_nerf_tpu_torch.train.trainer import train

    # --lrate 0.01 (the bench's, not the preset's 5e-4, whose field is still
    # a fog after a few hundred steps: the baked renderer's 128 uniform
    # samples and the online one's 32 guided ones then disagree by 15 dB).
    flags = SERVE_FLAGS + ["--lrate", "0.01", "--expname", "smoke",
                           "--basedir", basedir]
    loop = ["--i_print", "100"]
    total = TRAIN_STEPS + RESUME_STEPS
    t0 = time.perf_counter()
    first, text1 = quietly(train, parse_args(flags + loop + [
        "--n_iters", str(TRAIN_STEPS), "--i_weights", str(TRAIN_STEPS // 2)]))
    second, text2 = quietly(train, parse_args(flags + loop + [
        "--n_iters", str(total)]))
    seconds = time.perf_counter() - t0
    files = ckpt_files(first["logdir"])
    want = [f"{n:06d}.ckpt" for n in (TRAIN_STEPS // 2, TRAIN_STEPS, total)]
    if files != want:
        raise AssertionError(f"checkpoints {files}, expected {want}")
    newest = os.path.join(first["logdir"], want[1])
    if "Reloading from" in text1 or f"Reloading from {newest}" not in text2:
        raise AssertionError("the second run did not resume from " + newest)
    if second["state"]["step"] != total or len(second["losses"]) != RESUME_STEPS:
        raise AssertionError(f"resumed run ended at step {second['state']['step']}"
                             f" after {len(second['losses'])} steps")
    begin = float(np.mean(first["losses"][:10]))
    last = float(np.mean(first["losses"][-10:]))
    resumed = float(np.mean(second["losses"][:10]))
    size = os.path.getsize(newest) / 2**20
    print(f"[s] {TRAIN_STEPS} steps with --i_weights {TRAIN_STEPS // 2}, then a "
          f"second call to {total}: {files} ({size:.1f} MiB each) under "
          f"{os.path.basename(first['logdir'])}; both calls {seconds:.2f} s; loss "
          f"mean of the first run's first 10 steps {begin:.6f}, its last 10 "
          f"{last:.6f}, the resumed run's first 10 {resumed:.6f}")
    if not abs(resumed - last) < abs(resumed - begin):
        raise AssertionError(f"the resumed loss {resumed} is nearer the initial "
                             f"{begin} than the trained {last}")

    scene = load_dataset(parse_args(flags))
    (trained, step, hw), text = quietly(serve.build, argparse.Namespace(
        width=None, height=None, train_args=["--"] + flags))
    (seeded, step0, _), text0 = quietly(serve.build, argparse.Namespace(
        width=None, height=None, train_args=["--"] + SERVE_FLAGS))
    if "UNTRAINED" in text or "UNTRAINED" not in text0 or step0 != 0:
        raise AssertionError("the UNTRAINED warning: with a checkpoint "
                             f"{'UNTRAINED' in text}, without {'UNTRAINED' in text0}")
    with http_server(serve.make_handler(trained, step, hw)) as base:
        status, _, data, _ = _request(base + "/health")
    health = json.loads(data)
    if status != 200 or health["step"] != total:
        raise AssertionError(f"/health answered {status} {health}, expected "
                             f"step {total}")
    i = int(scene.i_train[0])
    got, got0 = trained(scene.poses[i])[0], seeded(scene.poses[i])[0]
    after, before = (psnr(m["rgb_map"], scene.images[i]) for m in (got, got0))
    print(f"[s] serve.build on the run's flags: /health {health}; training pose "
          f"{i} at {hw[0]}x{hw[1]} against its image: PSNR {after:.2f} dB "
          f"(the seeded field {before:.2f} dB)")
    if not after > before + 3.0:
        raise AssertionError(f"served PSNR {after} not above the seeded "
                             f"field's {before} by 3 dB")
    return flags, second["state"], scene


def phase_bake(torch, flags, state, scene) -> int:
    """(t) bake_field of the trained state; returns the tent_contract
    launches of the 256^3 bake."""
    from indoor_nerf_tpu_torch import serve
    from indoor_nerf_tpu_torch.ops import blockhash
    from indoor_nerf_tpu_torch.ops import tent_contract as tc
    from indoor_nerf_tpu_torch.render.baked import bake_field
    from indoor_nerf_tpu_torch.train.config import parse_args
    from indoor_nerf_tpu_torch.train.trainer import build_train_config

    fc = build_train_config(parse_args(flags), scene).render.field
    cams = serve.train_cameras(scene)
    kw = dict(table_dtype="bfloat16", geo_resolution=-1, train_cameras=cams)
    reset_counts()
    got = bake_field(state["params"], fc, resolution=32, **kw)
    small_launches = launch_counts()["tent_contract"]
    with mock.patch.object(blockhash, "tent_contract", tc.tent_contract_plain):
        want = bake_field(state["params"], fc, resolution=32, **kw)
    plain_launches = launch_counts()["tent_contract"] - small_launches
    if small_launches <= 0 or plain_launches:
        raise AssertionError(f"32^3 bake: {small_launches} launches, the plain "
                             f"bake {plain_launches}")
    report = []
    for key in ("sigma_table", "voxel_geo"):
        g, w = got[key].float(), want[key].float()
        diff = (g - w).abs()
        differ = float((diff > 0).float().mean())
        # The largest entry that is not the -1e4 of a culled vertex.
        scale = float(w[w > -1e3].abs().max())
        ok = bool((diff <= 2.0 ** -7 * w.abs() + 1e-6 * scale).all())
        report.append(f"{key} max |diff| {float(diff.max()):.3e} of largest "
                      f"{scale:.3e}, {differ:.5f} of entries differ")
        if not (ok and differ < 0.01):
            raise AssertionError(f"32^3 bake, kernel vs plain: {report[-1]}")
    print(f"[t] 32^3 bake through tent_contract ({small_launches} launches) vs "
          f"through its plain version (0): {'; '.join(report)} (tol: one "
          "bfloat16 step, under 1% of entries)")
    del got, want

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # the bake's run starts here
    t0 = time.perf_counter()
    baked = bake_field(state["params"], fc, resolution=BAKE_RES, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()["tent_contract"]  # ... and ends here
    tables = ", ".join(
        f"{k} {tuple(v.shape)} {str(v.dtype)[6:]} {nbytes(v) / 1e6:.1f} MB"
        for k, v in baked.items() if torch.is_tensor(v))
    culled = float((baked["sigma_table"].float() < -1e3).float().mean())
    print(f"[t] bake_field at {BAKE_RES}^3, geo {baked['config'].geo_res}^3, "
          f"bfloat16, {len(cams['poses'])} training cameras of "
          f"{cams['H']}x{cams['W']}: {seconds:.3f} s, {launches} tent_contract "
          f"launches, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {tables}; "
          f"{culled:.3f} of the sigma lanes culled by visibility; block_max "
          f"up to {float(baked['block_max'].max()):.2f}")
    if launches <= 0:
        raise AssertionError("the bake launched no tent_contract kernel")
    for key in ("sigma_table", "voxel_geo", "block_max"):
        if not bool(torch.isfinite(baked[key].float()).all()):
            raise AssertionError(f"bake: non-finite {key}")
    return launches


def phase_baked_requests(torch, flags, scene, basedir) -> int:
    """(u) baked serving beside online serving; returns the tent_contract
    launches of the baked requests."""
    from indoor_nerf_tpu_torch import profile_step, serve
    from indoor_nerf_tpu_torch.ops.rays import get_rays
    from indoor_nerf_tpu_torch.render import baked as bk

    from indoor_nerf_tpu_torch.train.config import parse_args

    dev = torch.device(parse_args(flags).device)
    size = REQUEST_SIZE
    snap = os.path.join(basedir, "snapshot.pt")

    def build(**kw):
        t0 = time.perf_counter()
        (render, _, _), text = quietly(serve.build, argparse.Namespace(
            width=size, height=size, train_args=["--"] + flags, **kw))
        return render, time.perf_counter() - t0, text

    baked_kw = dict(baked=True, baked_res=BAKE_RES, snapshot=snap)
    _, bake_s, text = build(**baked_kw)
    if "saved snapshot" not in text or not os.path.exists(snap):
        raise AssertionError("the first --snapshot build did not save " + snap)
    renders = {}
    renders["baked"], load_s, text = build(**baked_kw)
    if "loaded snapshot" not in text:
        raise AssertionError("the second --snapshot build did not load " + snap)
    print(f"[u] serve.build --baked --baked_res {BAKE_RES} --snapshot at {size}x{size}: "
          f"bakes and saves in {bake_s:.2f} s (snapshot "
          f"{os.path.getsize(snap) / 1e6:.1f} MB), loads it in {load_s:.2f} s "
          "(scene, resume and one warm-up render included)")
    renders["guided4"], _, _ = build(guided=4, **baked_kw)
    renders["online"], _, _ = build()
    torch.cuda.empty_cache()

    poses = scene.poses[scene.i_test]
    ms, maps, peak = {}, {}, {}
    for name in ("online", "baked", "guided4", "guided4", "baked", "online"):
        if name == "baked":
            reset_counts()  # the baked path's run starts here
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for c2w in poses:
            out, dt = renders[name](c2w)
            ms.setdefault(name, []).append(dt * 1e3)
            maps.setdefault(name, []).append(out["rgb_map"])
        if name == "baked":
            launches = launch_counts()["tent_contract"]  # ... and ends here
        peak[name] = (torch.cuda.max_memory_allocated() - resident) / 2**30
    for name, rgbs in maps.items():
        if not all(np.all(np.isfinite(r)) and r.shape == (size, size, 3)
                   for r in rgbs):
            raise AssertionError(f"{name}: a render is not finite {size}x{size}x3")
    n = len(poses)
    quality = {name: [psnr(maps[name][i], maps["online"][i]) for i in range(n)]
               for name in ("baked", "guided4")}
    print(f"[u] warm {size}x{size} requests on {n} held-out poses, twice each, in one "
          "process (online, baked, guided, guided, baked, online): "
          + "; ".join(f"{k} {', '.join(f'{v:.1f}' for v in vs)} ms "
                      f"(median {float(np.median(vs)):.1f})"
                      for k, vs in ms.items())
          + f"; tent_contract launches over {n} baked requests: {launches}; "
          "peak device memory of a request over what the servers hold: "
          + ", ".join(f"{k} {v:.2f} GiB" for k, v in peak.items()))
    print("[u] PSNR against the online render of the same pose: "
          + "; ".join(f"{k} {', '.join(f'{v:.2f}' for v in vs)} dB"
                      for k, vs in quality.items())
          + f" (floors: baked {BAKED_PSNR_FLOOR} dB, guided within "
            f"{GUIDED_PSNR_GAP} dB of baked)")
    if launches <= 0:
        raise AssertionError("baked requests launched no tent_contract kernel")
    if min(quality["baked"]) < BAKED_PSNR_FLOOR:
        raise AssertionError(f"baked vs online PSNR {quality['baked']}")
    if min(g - b for g, b in zip(quality["guided4"], quality["baked"])) \
            < -GUIDED_PSNR_GAP:
        raise AssertionError(f"guided PSNR {quality['guided4']} against "
                             f"unguided {quality['baked']}")
    for name in ("online", "baked", "guided4"):
        m = profile_step.measure(torch, lambda: renders[name](poses[0]), dev)
        print(f"[u] one profiled request, {name}: "
              + profile_step.summary(m).replace("\n", "; "))
    del renders
    torch.cuda.empty_cache()

    # Pass 1 alone at the request's shapes: 32,768 rays from the middle rows
    # of a held-out view x 128 samples through tent_contract and through the
    # plain form.
    baked = bk.load_baked(snap, dev)
    for n_s in (128, 16):
        print(f"[u] tiles at {n_s} samples: {bk.default_baked_tile_rays(baked, n_s, 4)} "
              f"rays at {bk.baked_bytes_per_ray(baked, n_s, 4)} bytes per ray "
              "(reckoned from the shapes)")
    n_rays, S = min(32768, size * size // 4), 128
    focal = scene.hwf[2] * size / scene.hwf[1]
    K = torch.tensor([[focal, 0, size / 2], [0, focal, size / 2], [0, 0, 1]],
                     dtype=torch.float32, device=dev)
    c2w = torch.as_tensor(np.asarray(poses[0], np.float32)[:3, :4], device=dev)
    first = (size * size - n_rays) // 2
    rays_o, rays_d = (r.reshape(-1, 3)[first:first + n_rays]
                      for r in get_rays(size, size, K, c2w))
    _, _, row_idx, p = bk._tile_samples(baked["config"], rays_o, rays_d,
                                        scene.near, scene.far, S)
    args = (baked["sigma_table"], row_idx.reshape(-1),
            *(a.reshape(-1).contiguous() for a in p))
    # The renderer reads relu(sigma): next to a culled vertex (-1e4) the
    # interpolated values are large and negative on both sides.
    got = torch.relu(bk._sigma_interp(*args))
    want = torch.relu(bk._sigma_interp_plain(*args))
    torch.cuda.synchronize()
    err, scale = float((got - want).abs().max()), float(want.max())
    kernel_ms, plain_ms, t = alternate(
        torch, lambda: bk._sigma_interp_plain(*args),
        lambda: bk._sigma_interp(*args), 10, plain_iters=3)
    gather_ms = cuda_ms(torch, lambda: args[0].index_select(0, args[1]), 3)
    factor = size * size / n_rays
    print(f"[u] pass 1 alone, {n_rays} rays x {S} samples = {n_rays * S} rows "
          f"of the {tuple(args[0].shape)} {str(args[0].dtype)[6:]} sigma tile "
          f"table: through tent_contract {kernel_ms:.3f} ms ({t[1]:.3f}, "
          f"{t[2]:.3f}), plain form {plain_ms:.3f} ms ({t[0]:.3f}, {t[3]:.3f}), "
          f"of which the index_select of {n_rays * S * 256 / 1e9:.2f} GB of rows "
          f"{gather_ms:.3f} ms; x {factor:.2f} for a {size}x{size} request: "
          f"{kernel_ms * factor:.1f} ms against {plain_ms * factor:.1f} ms; max "
          f"|diff| {err:.3e} of the largest sigma {scale:.3e} (tol "
          f"{PASS1_RTOL} of it: f32 against bfloat16 tent weights)")
    if not (scale > 0 and err <= PASS1_RTOL * scale):
        raise AssertionError(f"pass 1 kernel vs plain {err} > {PASS1_RTOL} x "
                             f"{scale}")
    return launches


def ckpt_files(logdir):
    return sorted(f for f in os.listdir(logdir) if f.endswith(".ckpt"))


@contextlib.contextmanager
def counting_evals(tally):
    """Within the block, the launches made inside each of the trainer's
    render_path calls go to ``tally["testset"]`` (calls with ground truth)
    or ``tally["video"]``, read as the difference of the counts around the
    call: the training steps' own launches are the rest."""
    from indoor_nerf_tpu_torch.train import trainer

    real = trainer.render_path

    def counted(*args, **kw):
        before = launch_counts()
        out = real(*args, **kw)
        after = launch_counts()
        kind = tally.setdefault("testset" if kw.get("gt_imgs") is not None
                                else "video", dict.fromkeys(after, 0))
        for k in after:
            kind[k] += after[k] - before[k]
        return out

    with mock.patch.object(trainer, "render_path", counted):
        yield


def train_from_files(torch, tag, argv, kernels=("tent_contract", "table_scatter"),
                     updated=None):
    """``run_nerf.main(argv)`` in its own launch window, quietly: (result,
    printed text, training launches, test-set launches, peak GiB). Each of
    ``kernels`` must launch in the steps (``tent_contract`` also in the test
    sets); with none named, no kernel may launch at all (the parity path)."""
    from indoor_nerf_tpu_torch import run_nerf
    from indoor_nerf_tpu_torch.train.config import parse_args

    evals = {}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # this path's run starts here
    with counting_evals(evals):
        out, text = quietly(run_nerf.main, argv)
    launches = launch_counts()  # ... and ends here
    radam = hold_optimizer(tag, len(out["losses"]), out["state"]["params"],
                           updated)
    zero = dict.fromkeys(launches, 0)
    testset, video = evals.get("testset", zero), evals.get("video", zero)
    training = {k: launches[k] - testset[k] - video[k] for k in launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = np.asarray(out["losses"])
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    n = len(losses)
    steps_s = n / (out["seconds"] - out["eval_seconds"])
    print(f"[{tag}] {n} steps of {parse_args(argv).N_rand} rays: {steps_s:.2f} "
          f"steps/s without the {out['eval_seconds']:.2f} s of saves, test "
          f"sets and videos (loop {out['seconds']:.2f} s); scene loaded in "
          f"{out['load_seconds']:.2f} s; loss mean of the first 10 steps "
          f"{first:.6f}, last 10 {last:.6f}; training launches "
          f"{ {k: v for k, v in training.items() if v} }, test sets "
          f"{ {k: v for k, v in testset.items() if v} }, videos "
          f"{ {k: v for k, v in video.items() if v} }, {radam}; peak device "
          f"memory {peak:.2f} GiB")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"[{tag}] training loss went non-finite")
    if not last < first:
        raise AssertionError(f"[{tag}] loss did not fall: {first} -> {last}")
    for name in kernels:
        if training[name] <= 0:
            raise AssertionError(f"[{tag}] training launched no {name} kernel")
    if kernels and out["testsets"] and testset["tent_contract"] <= 0:
        raise AssertionError(f"[{tag}] the test sets launched no tent_contract")
    if not kernels and any(launches.values()):
        raise AssertionError(f"[{tag}] the parity path launched {launches}")
    return out, text, training, testset


def render_test(flags):
    """``--render_only --render_test`` of ``flags`` through run_nerf, in its
    own launch window: (result, every kernel's launches)."""
    from indoor_nerf_tpu_torch import run_nerf

    reset_counts()
    out, _ = quietly(run_nerf.main, flags + ["--render_only", "--render_test"])
    return out, launch_counts()


def held_out_gain(tag, trained_psnr, flags, seeded_basedir, gain):
    """The seeded field's mean PSNR on the same held-out views (a
    render-only run that finds no checkpoint); fails unless the trained
    field's is ``gain`` dB above it."""
    seeded, _ = render_test(flags + ["--basedir", seeded_basedir])
    if seeded["step"] != 0:
        raise AssertionError(f"[{tag}] the seeded render resumed a checkpoint")
    seeded_psnr = float(np.mean(seeded["psnrs"]))
    print(f"[{tag}] held-out PSNR {trained_psnr:.2f} dB, the seeded field's "
          f"{seeded_psnr:.2f} dB on the same views")
    if not trained_psnr >= seeded_psnr + gain:
        raise AssertionError(f"[{tag}] held-out PSNR {trained_psnr} not "
                             f"{gain} dB above the seeded {seeded_psnr}")


def png_read_ms(scene_dir) -> str:
    """Host ms of ``read_png`` of one 800x800 RGBA view as written (row
    filter None) and re-encoded with every row Paeth and with the five
    filters in turn (what an adaptive encoder such as libpng's writes)."""
    from indoor_nerf_tpu_torch.utils.png import encode_png, read_png

    path = os.path.join(scene_dir, "train", "r_0.png")
    img = read_png(path)
    out = []
    for label, filt in (("none", 0), ("Paeth", 4),
                        ("mixed", np.arange(img.shape[0]) % 5)):
        if label != "none":
            path = os.path.join(scene_dir, f"r_0_{label}.png")
            with open(path, "wb") as f:
                f.write(encode_png(img, filt))
        t0 = time.perf_counter()
        if not np.array_equal(read_png(path), img):
            raise AssertionError(f"[v] read_png of the {label} file differs")
        out.append(f"{label} {(time.perf_counter() - t0) * 1e3:.1f}")
    return ("read_png of one 800x800 RGBA view, ms by row filter: "
            + ", ".join(out))


def phase_from_files(torch, workdir) -> dict:
    """(v) configs/lego_tpu.txt from an 800x800 blender-layout scene:
    train -> test sets -> render-only. Returns its launches by path."""
    from indoor_nerf_tpu_torch.data.scene_files import (
        make_sphere_scene,
        write_blender_scene,
    )

    t0 = time.perf_counter()
    scene_dir = os.path.join(workdir, "lego")
    write_blender_scene(scene_dir, make_sphere_scene(FILE_VIEWS, 800, 800))
    print(f"[v] wrote {FILE_VIEWS} views of 800x800 RGBA in blender layout "
          f"in {time.perf_counter() - t0:.2f} s; {png_read_ms(scene_dir)}")
    flags = ["--config", os.path.join(ROOT, "configs", "lego_tpu.txt"),
             "--datadir", scene_dir, "--basedir", os.path.join(workdir, "v"),
             "--lrate", "0.01"]
    half = FILE_STEPS // 2
    out, text, training, testset = train_from_files(torch, "v", flags + [
        "--n_iters", str(FILE_STEPS), "--i_testset", str(half),
        "--i_weights", str(half), "--i_video", str(FILE_STEPS)])
    logdir = out["logdir"]
    for step in (half, FILE_STEPS):
        d = os.path.join(logdir, f"testset_{step:06d}")
        names = sorted(os.listdir(d))
        if not (len([n for n in names if n.endswith(".png")]) == FILE_TEST_VIEWS
                and any(n.startswith("test_psnrs_avg") for n in names)):
            raise AssertionError(f"[v] {d} holds {names}")
    want = ["best.ckpt", f"{half:06d}.ckpt", f"{FILE_STEPS:06d}.ckpt"]
    metrics = set(os.listdir(os.path.join(logdir, "metrics")))
    video = [n for n in os.listdir(logdir) if "_spiral_" in n]
    if (ckpt_files(logdir) != sorted(want)
            or not {f"metrics_iter_{FILE_STEPS}.pkl",
                    f"main_metrics_{FILE_STEPS}.csv"} <= metrics
            or not any("_rgb" in n for n in video)):
        raise AssertionError(f"[v] run directory {sorted(os.listdir(logdir))}")
    last = out["testsets"][-1]
    print(f"[v] held-out views {FILE_TEST_VIEWS} at 400x400: PSNR "
          f"{[round(t['psnr'], 3) for t in out['testsets']]} dB at steps "
          f"{[t['step'] for t in out['testsets']]}; SSIM {last['ssim']:.4f}, "
          f"GMSD {last['gmsd']:.4f}; one evaluation "
          f"{last['render_seconds']:.3f} s of render + "
          f"{last['metrics_seconds']:.3f} s of metrics (SSIM, GMSD on the "
          f"host); video {video}")
    shown, shown_launches = render_test(flags)
    shown_launches = shown_launches["tent_contract"]
    psnr = float(np.mean(shown["psnrs"]))
    print(f"[v] --render_only --render_test from step {shown['step']}: mean "
          f"PSNR {psnr:.4f} dB against the last test set's {last['psnr']:.4f}; "
          f"tent_contract launches {shown_launches}")
    if shown["step"] != FILE_STEPS or not abs(psnr - last["psnr"]) <= 0.01:
        raise AssertionError("[v] render-only did not reproduce the test set")
    if shown_launches <= 0:
        raise AssertionError("[v] render-only launched no tent_contract")
    held_out_gain("v", last["psnr"], flags, os.path.join(workdir, "v0"), 3.0)
    return {"training_from_files": training, "testset": testset,
            "render_only": shown_launches, "testsets": out["testsets"],
            "steps_s": FILE_STEPS / (out["seconds"] - out["eval_seconds"]),
            "scene_dir": scene_dir, "flags": flags}


def phase_ndc(torch, workdir) -> dict:
    """(w) configs/fern_tpu.txt (NDC) from an LLFF-layout scene."""
    from indoor_nerf_tpu_torch.data.scene_files import (
        make_plane_scene,
        write_llff_scene,
    )

    t0 = time.perf_counter()
    scene_dir = os.path.join(workdir, "fern")
    H, W, focal = NDC_FULL_HWF
    write_llff_scene(scene_dir, make_plane_scene(NDC_VIEWS), H, W, focal, 8)
    print(f"[w] wrote {NDC_VIEWS} views in LLFF layout ({H}x{W} in images/, "
          f"{H // 8}x{W // 8} in images_8/) in {time.perf_counter() - t0:.2f} s")
    flags = ["--config", os.path.join(ROOT, "configs", "fern_tpu.txt"),
             "--datadir", scene_dir, "--basedir", os.path.join(workdir, "w"),
             "--lrate", "0.01"]
    out, _, training, _ = train_from_files(torch, "w", flags + [
        "--n_iters", str(NDC_STEPS), "--i_testset", str(NDC_STEPS)])
    held_out_gain("w", out["testsets"][-1]["psnr"], flags,
                  os.path.join(workdir, "w0"), 0.0)
    return training


def parity_flags(workdir, config, scene, tag, extra=()):
    """A shipped config without _tpu on a scene that (v) or (w) wrote, with
    its own --basedir under ``workdir``."""
    return (["--config", os.path.join(ROOT, "configs", config), "--datadir",
             os.path.join(workdir, scene), "--basedir",
             os.path.join(workdir, tag)] + list(extra))


def phase_parity_from_files(torch, workdir) -> dict:
    """(y1) configs/lego.txt (the hash grid, 64 + 128 samples, NeRFSmall
    coarse and fine) from (v)'s 800x800 blender-layout sphere: train ->
    test sets -> render-only. Returns its flags, trained state and launches
    by path (all zero: no kernel of csrc/ lies on this path)."""
    flags = parity_flags(workdir, "lego.txt", "lego", "y1", ["--lrate", "0.01"])
    half = PARITY_STEPS // 2
    out, text, training, testset = train_from_files(torch, "y1", flags + [
        "--n_iters", str(PARITY_STEPS), "--i_testset", str(half),
        "--i_weights", str(PARITY_STEPS), "--i_video", str(10 * PARITY_STEPS)],
        kernels=())
    logdir = out["logdir"]
    for step in (half, PARITY_STEPS):
        d = os.path.join(logdir, f"testset_{step:06d}")
        names = sorted(os.listdir(d))
        if not (len([n for n in names if n.endswith(".png")]) == FILE_TEST_VIEWS
                and any(n.startswith("test_psnrs_avg") for n in names)):
            raise AssertionError(f"[y1] {d} holds {names}")
    last = out["testsets"][-1]
    table = tuple(out["state"]["params"]["table"].shape)
    print(f"[y1] configs/lego.txt (hash table {table}, "
          f"{os.path.basename(logdir)}): held-out views "
          f"{FILE_TEST_VIEWS} at 400x400: PSNR "
          f"{[round(t['psnr'], 3) for t in out['testsets']]} dB at steps "
          f"{[t['step'] for t in out['testsets']]}; SSIM {last['ssim']:.4f}, "
          f"GMSD {last['gmsd']:.4f}; one evaluation {last['render_seconds']:.3f} "
          f"s of render + {last['metrics_seconds']:.3f} s of metrics")
    shown, shown_launches = render_test(flags)
    psnr_shown = float(np.mean(shown["psnrs"]))
    print(f"[y1] --render_only --render_test from step {shown['step']}: mean "
          f"PSNR {psnr_shown:.4f} dB against the last test set's "
          f"{last['psnr']:.4f}; launches {shown_launches}")
    if shown["step"] != PARITY_STEPS or not abs(psnr_shown - last["psnr"]) <= 0.01:
        raise AssertionError("[y1] render-only did not reproduce the test set")
    if any(shown_launches.values()):
        raise AssertionError(f"[y1] render-only launched {shown_launches}")
    held_out_gain("y1", last["psnr"], flags, os.path.join(workdir, "y10"), 3.0)
    return {"flags": flags, "state": out["state"],
            "launches": {"parity_training": training,
                         "parity_testset": testset,
                         "parity_render_only": shown_launches}}


def norm_rel(got, want) -> float:
    """||got - want|| / ||want|| over the arrays of two equal trees."""
    g = np.concatenate([np.ravel(v) for v in got])
    w = np.concatenate([np.ravel(v) for v in want])
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def phase_parity_step_check(torch, flags, state, batch_seed=5, draw_seed=3,
                            hold=True) -> dict:
    """(y2) one step of (y1)'s configuration at its width, from its trained
    state, on the card and on the port's CPU path with the same batch and
    draws: the hash rows of every sample of the step bit for bit, the
    trilinear weights within 1e-6, the loss 1e-5 relative (where the fine
    samples of some rays moved by more than rounding, over the other rays;
    under a quarter of them may move), the RAdam
    moments and the parameters' update held in norm (FORWARD_NORM_TOL: the
    forwards differ in f32 order); the table's update over the entries
    whose moments are resolved card against CPU (``resolved_table_entries``,
    as ``card_vs_cpu_step``). Returns the errors; ``hold=False`` raises on
    none (``--step-spread``)."""
    from indoor_nerf_tpu_torch.bridge import state_from_numpy, state_to_numpy
    from indoor_nerf_tpu_torch.ops.encoding import hash_grid_indices
    from indoor_nerf_tpu_torch.render.renderer import render_rays
    from indoor_nerf_tpu_torch.train.config import parse_args
    from indoor_nerf_tpu_torch.train.step import draw_step, train_step
    from indoor_nerf_tpu_torch.train.trainer import one_batch

    dev = torch.device("cuda:0")
    cpu = torch.device("cpu")
    cfg, batch = one_batch(parse_args(flags), cpu, seed=batch_seed)
    tree = state_to_numpy(state)
    step = int(tree["step"])
    draws = draw_step(torch.Generator(device=cpu).manual_seed(draw_seed), cfg,
                      step, batch["rays_o"].shape[0])
    rays_d = batch["rays_d"]
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    near = cfg.near * torch.ones_like(rays_d[..., :1])
    far = cfg.far * torch.ones_like(rays_d[..., :1])
    fwd = {}
    with torch.no_grad():
        for label, d in (("cpu", cpu), ("card", dev)):
            out, _ = render_rays(state_from_numpy(tree, d)["params"],
                                 *(t.to(d) for t in (batch["rays_o"], rays_d,
                                                     viewdirs, near, far)),
                                 cfg.render, step=step,
                                 draws={k: v.to(d) for k, v in draws.items()})
            fwd[label] = {k: out[k].cpu() for k in ("pts", "z_vals", "rgb_map",
                                                    "rgb0")}
    pts = fwd["cpu"]["pts"].reshape(-1, 3)
    # sample_pdf divides the draw's offset in its cdf bin (a cumsum in
    # another order on each side) by the bin's weight, floored at 1e-5, and
    # a draw within rounding of a bin edge next to a bin of no weight lands
    # a bin away: a fine sample of some rays moves by more than rounding
    # (5.7% and 7.4% of the rays, by up to 2.3% and 2.7% of a bin, in two
    # runs on an H100).
    # Those rays are counted; the image loss of the others is held to 1e-5
    # relative, and the moved rays to under a quarter (a sampler that
    # differs moves nearly all).
    z_diff = (fwd["card"]["z_vals"] - fwd["cpu"]["z_vals"]).abs()
    moved = (z_diff > 1e-5 * cfg.far).any(-1)
    bin_width = (cfg.far - cfg.near) / (cfg.render.n_samples - 1)
    ray_loss = {k: sum(((f[m] - batch["target"]) ** 2).mean(-1)
                       for m in ("rgb_map", "rgb0")) for k, f in fwd.items()}
    held_rel = abs(float(ray_loss["card"][~moved].sum())
                   / float(ray_loss["cpu"][~moved].sum()) - 1.0)
    grid = cfg.render.field.grid
    c_idx, c_w, c_keep = hash_grid_indices(pts, grid)
    g_idx, g_w, g_keep = (t.cpu() for t in hash_grid_indices(pts.to(dev), grid))
    idx_equal = bool(torch.equal(c_idx, g_idx)) and bool(torch.equal(c_keep, g_keep))
    w_err = float((c_w - g_w).abs().max())
    res, seconds = {}, {}
    for label, d in (("cpu", cpu), ("card", dev)):
        s = state_from_numpy(tree, d)
        t = time.perf_counter()
        s, m = train_step(s, {k: v.to(d) for k, v in batch.items()}, cfg,
                          draws={k: v.to(d) for k, v in draws.items()})
        loss = float(m["loss"])
        seconds[label] = time.perf_counter() - t
        res[label] = (loss, state_to_numpy(s))
    loss_rel = abs(res["card"][0] / res["cpu"][0] - 1.0)
    got, want = res["card"][1], res["cpu"][1]
    moments = {f"{k}.{name}": norm_rel(_tree_leaves(got["opt"][k][name]),
                                       _tree_leaves(want["opt"][k][name]))
               for k in ("mu", "nu") for name in want["opt"][k]}
    updates = {}
    for name in want["params"]:
        if name == "table":
            continue
        g = [a - b for a, b in zip(_tree_leaves(got["params"][name]),
                                   _tree_leaves(tree["params"][name]))]
        w = [a - b for a, b in zip(_tree_leaves(want["params"][name]),
                                   _tree_leaves(tree["params"][name]))]
        updates[name] = norm_rel(g, w)
    resolved, share = resolved_table_entries(got, want)
    g = (got["params"]["table"] - tree["params"]["table"])[resolved]
    w = (want["params"]["table"] - tree["params"]["table"])[resolved]
    updates["table"] = norm_rel([g], [w])
    print(f"[y2] one configs/lego.txt step at step {step} ({batch['rays_o'].shape[0]} "
          f"rays x {cfg.render.n_samples} + {cfg.render.n_importance} samples), "
          f"card against the CPU on one state, batch and draws: hash rows of "
          f"all {pts.shape[0]} samples x {grid.n_levels} levels x 8 corners "
          f"equal: {idx_equal}; weights max |diff| {w_err:.3e} (tol 1e-6); "
          f"loss {res['card'][0]:.8f} vs {res['cpu'][0]:.8f} (rel {loss_rel:.2e}); "
          f"{int(moved.sum())} rays with a fine sample moved by more than "
          f"rounding (largest move {float(z_diff.max()):.3e}, a bin "
          f"{bin_width:.3e}), the image loss "
          f"of the other {int((~moved).sum())} rel {held_rel:.2e} (tol 1e-5); moments rel in norm, largest {max(moments.values()):.2e}; "
          f"parameter updates rel in norm {  {k: f'{v:.2e}' for k, v in updates.items()} } "
          f"(table over the entries whose moments are resolved, unresolved "
          f"share {share:.2e} of those touched, tol {UNRESOLVED_SHARE}; tol "
          f"{FORWARD_NORM_TOL}); step seconds "
          f"{ {k: round(v, 3) for k, v in seconds.items()} }")
    errs = {"loss over the rays not moved": held_rel,
            "rays moved (share)": float(moved.float().mean()),
            "unresolved share": share, **moments,
            **{f"params update {k}": v for k, v in updates.items()}}
    if not hold:
        return errs
    if not idx_equal or w_err > 1e-6:
        raise AssertionError("[y2] hash rows or weights differ card vs CPU")
    if held_rel > 1e-5 or (not moved.any() and loss_rel > 1e-5):
        raise AssertionError(f"[y2] loss card vs CPU rel {loss_rel}, over "
                             f"the rays with the same samples {held_rel}")
    if moved.float().mean() >= 0.25:
        raise AssertionError(f"[y2] {int(moved.sum())} rays' fine samples moved, "
                             f"by up to {float(z_diff.max())}")
    bad = {k: v for k, v in {**moments, **updates}.items() if v > FORWARD_NORM_TOL}
    if share > UNRESOLVED_SHARE:
        bad["unresolved share"] = share
    if bad:
        raise AssertionError(f"[y2] card vs CPU beyond {FORWARD_NORM_TOL}: {bad}")
    return errs


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for t in tree for v in _tree_leaves(t)]
    return [np.asarray(tree)]


def phase_parity_ndc(torch, workdir) -> dict:
    """(y3) configs/fern.txt (LLFF, NDC, raw_noise_std 1, 64 + 64 samples,
    the hash grid) on (w)'s plane scene."""
    flags = parity_flags(workdir, "fern.txt", "fern", "y3", ["--lrate", "0.01"])
    out, _, training, testset = train_from_files(torch, "y3", flags + [
        "--n_iters", str(PARITY_NDC_STEPS), "--i_testset",
        str(PARITY_NDC_STEPS)], kernels=())
    held_out_gain("y3", out["testsets"][-1]["psnr"], flags,
                  os.path.join(workdir, "y30"), 0.0)
    return {"parity_ndc": training, "parity_ndc_testset": testset}


def phase_pe(torch, workdir) -> dict:
    """(y4) --i_embed 0 --i_embed_views 0 at the parser's width (NeRF 8 x
    256, coarse and fine; PE of 10 and 4 bands) with configs/lego.txt's
    samples on (v)'s sphere, at the config's learning rate; then one
    held-out view rendered (seconds, peak memory per ray of a tile)."""
    from indoor_nerf_tpu_torch.data.load import load_dataset
    from indoor_nerf_tpu_torch.models.field import serving_params
    from indoor_nerf_tpu_torch.render.renderer import (
        bytes_per_ray,
        default_tile_rays,
        make_image_renderer,
    )
    from indoor_nerf_tpu_torch.train.config import parse_args
    from indoor_nerf_tpu_torch.train.trainer import build_train_config

    flags = parity_flags(workdir, "lego.txt", "lego", "y4",
                         ["--i_embed", "0", "--i_embed_views", "0"])
    out, _, training, _ = train_from_files(torch, "y4", flags + [
        "--n_iters", str(PE_STEPS)], kernels=())
    sizes = [tuple(l.w.shape) for l in out["state"]["params"]["fine"].pts_linears]
    # One held-out 400x400 view at the tile the server would take: its peak
    # device bytes per ray of a tile against bytes_per_ray's reckoning.
    cli = parse_args(flags)
    scene = load_dataset(cli)
    rc = build_train_config(cli, scene).render.test_mode()
    H, W, focal = scene.hwf
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    torch.cuda.empty_cache()
    tile = default_tile_rays(torch.device(cli.device), rc)
    params = serving_params(out["state"]["params"], rc.field)
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    maps = make_image_renderer(rc, int(H), int(W), tile)(
        params, scene.poses[scene.i_test[0]], K, scene.near, scene.far)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - resident
    launches = launch_counts()
    print(f"[y4] NeRFBig pts_linears {sizes}, PE of --multires 10 and "
          f"--multires_views 4; one held-out {int(H)}x{int(W)} view in "
          f"{render_s:.3f} s, tiles of {tile} rays, peak device memory "
          f"{peak / 2**30:.2f} GiB ({peak / tile / 1e6:.3f} MB per ray of a "
          f"tile; bytes_per_ray {bytes_per_ray(rc) / 1e6:.3f} MB)")
    if not bool(torch.isfinite(maps["rgb_map"]).all()) or any(launches.values()):
        raise AssertionError(f"[y4] render: launches {launches}")
    return {"pe_training": training, "pe_render": launches}


def request_ms(torch, render, poses, rounds=2):
    """Warm request ms (render + maps to the host) per pose, ``rounds``
    times, and the maps of the last round."""
    ms, maps = [], []
    for _ in range(rounds):
        maps = []
        for c2w in poses:
            out, dt = render(c2w)
            ms.append(dt * 1e3)
            maps.append(out)
    return ms, maps


def view_psnrs(got, want) -> list:
    """PSNR of the ``got`` maps against the ``want`` maps per view, as
    (whole image, object, background): the object is where ``want``'s
    acc_map is at least 0.5."""
    out = []
    for g, w in zip(got, want):
        err = np.mean((g["rgb_map"] - w["rgb_map"]) ** 2, axis=-1)
        obj = w["acc_map"] >= 0.5
        out.append(tuple(float(-10.0 * np.log10(err[m].mean()))
                         for m in (np.ones_like(obj), obj, ~obj)))
    return out


def show_psnrs(quality) -> str:
    return ", ".join("(" + ", ".join(f"{v:.2f}" for v in q) + ")"
                     for q in quality)


def parity_baked(flags, res, **kw):
    """serve.build --baked --baked_res ``res`` of ``flags``' checkpoint at
    REQUEST_SIZE: (render, bake seconds, build seconds)."""
    from indoor_nerf_tpu_torch import serve

    t0 = time.perf_counter()
    (render, _, _), text = quietly(serve.build, argparse.Namespace(
        width=REQUEST_SIZE, height=REQUEST_SIZE, baked=True, baked_res=res,
        train_args=["--"] + flags, **kw))
    build_s = time.perf_counter() - t0
    return render, float(text.split("baked in ")[1].split("s")[0]), build_s


def phase_parity_serving(torch, flags, workdir) -> dict:
    """(y5) serve (y1)'s checkpoint: online at 400x400 and 800x800 (tiles
    sized from free memory and bytes_per_ray), then --baked at 800x800 with
    --baked_res 128 and 256, the server's default (bake seconds, request
    ms, PSNR against online per held-out pose on the whole image, the
    object and the background). The 256^3 bake is held to BAKED_PSNR_FLOOR
    dB on every pose, as phase (u) holds its bake of the same resolution.
    The 128^3 bake is printed: its object sat 16.7-18.5 dB from online on
    the first held-out pose (geometry features on a 64^3 grid against the
    sphere's texture; --bake-spread)."""
    from indoor_nerf_tpu_torch import serve
    from indoor_nerf_tpu_torch.data.load import load_dataset
    from indoor_nerf_tpu_torch.render.renderer import bytes_per_ray
    from indoor_nerf_tpu_torch.train.config import parse_args
    from indoor_nerf_tpu_torch.train.trainer import build_train_config

    cli = parse_args(flags)
    scene = load_dataset(cli)
    rc = build_train_config(cli, scene).render.test_mode()
    poses = scene.poses[scene.i_test]
    launches, ms, maps, tiles, peaks = {}, {}, {}, {}, {}
    for size in (400, REQUEST_SIZE):
        torch.cuda.empty_cache()
        (render, step, _), text = quietly(serve.build, argparse.Namespace(
            width=size, height=size, train_args=["--"] + flags))
        if step != PARITY_STEPS or "UNTRAINED" in text:
            raise AssertionError(f"[y5] served step {step}: {text}")
        tiles[size] = int(text.split(" in tiles of ")[1].split()[0])
        reset_counts()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms[size], maps[size] = request_ms(torch, render, poses)
        peaks[size] = (torch.cuda.max_memory_allocated() - resident) / 2**30
        launches[f"parity_serving_{size}"] = launch_counts()
        del render
    torch.cuda.empty_cache()
    bakes, quality = {}, {}
    for res in (PARITY_BAKE_RES, BAKE_RES):
        snap = os.path.join(workdir, f"y5_snapshot_{res}.pt")
        baked, bake_s, build_s = parity_baked(flags, res, snapshot=snap)
        name = "baked" if res == BAKE_RES else f"baked_{res}"
        reset_counts()
        ms[name], maps[name] = request_ms(torch, baked, poses)
        launches[f"parity_{name}_serving"] = launch_counts()
        quality[res] = view_psnrs(maps[name], maps[REQUEST_SIZE])
        bakes[res] = (f"bake {bake_s:.2f} s (build with load and warm-up "
                      f"{build_s:.2f} s, snapshot {os.path.getsize(snap) / 1e6:.1f} "
                      f"MB), PSNR baked against online per view (whole, object, "
                      f"background) {show_psnrs(quality[res])} dB")
        del baked
        torch.cuda.empty_cache()
    tile_mb = bytes_per_ray(rc) / 1e6
    print(f"[y5] serving (y1)'s checkpoint (step {PARITY_STEPS}), warm requests "
          f"on {len(poses)} held-out poses, twice each: "
          + "; ".join(f"{k} {', '.join(f'{v:.1f}' for v in vs)} ms (median "
                      f"{float(np.median(vs)):.1f})" for k, vs in ms.items())
          + f"; online tiles {tiles} rays at bytes_per_ray {tile_mb:.3f} MB, "
          "peak device memory of a request over what the server holds "
          + ", ".join(f"{k}: {v:.2f} GiB ({v * 2**30 / tiles[k] / 1e6:.3f} MB "
                      "per ray of a tile)" for k, v in peaks.items())
          + "; " + "; ".join(f"--baked --baked_res {r}: {t}"
                             for r, t in bakes.items())
          + f" (floor {BAKED_PSNR_FLOOR} dB on each whole view at {BAKE_RES}^3); "
          "launches: " + "; ".join(f"{k} { {n: v for n, v in c.items() if v} }"
                                   for k, c in launches.items()))
    if min(q[0] for q in quality[BAKE_RES]) < BAKED_PSNR_FLOOR:
        raise AssertionError(f"[y5] baked vs online PSNR {quality}")
    # Online serving of the parity field runs no kernel of csrc/; the baked
    # renderer's pass 1 runs tent_contract on the sigma tiles, whatever
    # field was baked (phase u).
    baked = [k for k in launches if k.startswith("parity_baked")]
    online = [v for k, c in launches.items() if k not in baked
              for v in c.values()]
    if any(online) or any({k for k, v in launches[b].items() if v}
                          != {"tent_contract"} for b in baked):
        raise AssertionError(f"[y5] launches {launches}")
    return launches


def bake_spread(torch, trials: int) -> None:
    """The spread of (y5)'s baked-against-online PSNR: (y1)'s configuration
    trained ``trials`` times from its seed (the table gradient's atomics
    make each run differ), read at PARITY_STEPS and again resumed to
    BAKE_SPREAD_STEPS, each served at 800x800 online and baked at 128^3 and
    256^3: per held-out view, the PSNR on the whole image, the object and
    the background (view_psnrs). This is where (y5)'s per-view floor and
    PARITY_STEPS are read from."""
    from indoor_nerf_tpu_torch import run_nerf, serve
    from indoor_nerf_tpu_torch.data.load import load_dataset
    from indoor_nerf_tpu_torch.data.scene_files import (
        make_sphere_scene,
        write_blender_scene,
    )
    from indoor_nerf_tpu_torch.train.config import parse_args

    phase_build()
    with tempfile.TemporaryDirectory() as workdir:
        write_blender_scene(os.path.join(workdir, "lego"),
                            make_sphere_scene(FILE_VIEWS, 800, 800))
        for t in range(trials):
            flags = parity_flags(workdir, "lego.txt", "lego", f"s{t}",
                                 ["--lrate", "0.01"])
            for steps in (PARITY_STEPS, BAKE_SPREAD_STEPS):
                quietly(run_nerf.main, flags + [
                    "--n_iters", str(steps), "--i_weights", str(steps),
                    "--i_testset", str(10 * steps), "--i_video", str(10 * steps)])
                scene = load_dataset(parse_args(flags))
                poses = scene.poses[scene.i_test]
                (online, step, _), _ = quietly(serve.build, argparse.Namespace(
                    width=REQUEST_SIZE, height=REQUEST_SIZE,
                    train_args=["--"] + flags))
                if step != steps:
                    raise AssertionError(f"[bake-spread] served step {step}")
                want = request_ms(torch, online, poses, rounds=1)[1]
                del online
                for res in (PARITY_BAKE_RES, BAKE_RES):
                    baked, _, _ = parity_baked(flags, res)
                    got = request_ms(torch, baked, poses, rounds=1)[1]
                    print(f"[bake-spread] trial {t}, step {steps}, "
                          f"{res}^3: PSNR baked against online per view "
                          f"(whole, object, background) "
                          f"{show_psnrs(view_psnrs(got, want))} dB", flush=True)
                    del baked
                torch.cuda.empty_cache()


def phase_precision(torch) -> None:
    """(z) --precision bf16 against f32 on the flagship (the MLP's operands
    rounded to bf16 and multiplied in f32, as on the CPU): a step (the bench
    batch, alternating windows) and an 800x800 request (alternating) at each
    precision, in this process."""
    from indoor_nerf_tpu_torch import serve
    from indoor_nerf_tpu_torch.data.load import load_dataset
    from indoor_nerf_tpu_torch.train.config import parse_args
    from indoor_nerf_tpu_torch.train.step import init_train_state, train_step
    from indoor_nerf_tpu_torch.train.trainer import build_train_config

    dev = torch.device("cuda:0")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in _bench_batch().items()}
    cfgs, states = {}, {}
    for prec in ("f32", "bf16"):
        cli = parse_args(SERVE_FLAGS + ["--precision", prec])
        cfgs[prec] = build_train_config(cli, load_dataset(cli))
        states[prec] = init_train_state(torch.Generator(device=dev).manual_seed(0),
                                        cfgs[prec], dev)
    gens = {p: torch.Generator(device=dev).manual_seed(1) for p in cfgs}
    step_ms = {p: [] for p in cfgs}
    for prec in ("f32", "bf16", "bf16", "f32") * 2:
        for _ in range(3):  # warm
            states[prec], m = train_step(states[prec], batch, cfgs[prec], gens[prec])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            states[prec], m = train_step(states[prec], batch, cfgs[prec], gens[prec])
        torch.cuda.synchronize()
        step_ms[prec].append((time.perf_counter() - t0) / TIMED_STEPS * 1e3)
    del states
    renders, req = {}, {}
    for prec in ("f32", "bf16"):
        (renders[prec], _, _), _ = quietly(serve.build, argparse.Namespace(
            width=REQUEST_SIZE, height=REQUEST_SIZE,
            train_args=["--"] + SERVE_FLAGS + ["--precision", prec]))
    poses = load_dataset(parse_args(SERVE_FLAGS)).poses[:2]
    for prec in ("f32", "bf16", "bf16", "f32"):
        req.setdefault(prec, []).extend(request_ms(torch, renders[prec], poses,
                                                   rounds=1)[0])
    print(f"[z] flagship at --precision f32 and bf16, alternating in this "
          f"process: step ms ({TIMED_STEPS}-step windows, {batch['rays_o'].shape[0]} "
          f"rays) " + "; ".join(f"{p} {', '.join(f'{v:.2f}' for v in vs)} "
                               f"(median {float(np.median(vs)):.2f})"
                               for p, vs in step_ms.items())
          + f"; {REQUEST_SIZE}x{REQUEST_SIZE} request ms "
          + "; ".join(f"{p} {', '.join(f'{v:.1f}' for v in vs)} (median "
                      f"{float(np.median(vs)):.1f})" for p, vs in req.items()))


def room_flags(workdir, config, tag, extra=()):
    """A norcliffe config on (sp1)'s room scene with its own --basedir."""
    return (["--config", os.path.join(ROOT, "configs", config), "--datadir",
             os.path.join(workdir, "room"), "--basedir",
             os.path.join(workdir, tag)] + list(extra))


def step_rates(out, spans) -> list:
    """Median steps/s of ``trainer.train``'s print intervals (the steps
    over the host seconds between two print steps' synchronized loss reads)
    that lie in each ``(first, last)`` span of iterations, one step past
    its end allowed."""
    ips = np.asarray(out["iterations_per_second"])
    steps = np.asarray(out["iterations_per_second_steps"]).reshape(-1, 2)
    return [float(np.median(ips[(steps[:, 0] >= a) & (steps[:, 1] <= b + 1)]))
            for a, b in spans]


def phase_priors(torch, workdir) -> dict:
    """(sp1) configs/norcliffe_common_room_tpu.txt as shipped (the flagship
    preset with the structural priors) on the room scene written in
    blender layout, PRIOR_STEPS steps with the priors from PRIOR_START over
    PRIOR_RAMP and test sets every PRIOR_TESTSET: the countdown, the banner,
    the [PRIOR] lines and the overfitting check of the trainer run; the
    kernels launch in the steps and the test sets, the loss falls, the
    held-out PSNR rises above the seeded field's. Steps/s before and after
    the priors start."""
    from indoor_nerf_tpu_torch.data.scene_files import (
        make_room_blender_scene,
        write_blender_scene,
    )

    t0 = time.perf_counter()
    scene = make_room_blender_scene(ROOM_VIEWS, ROOM_SIZE, ROOM_SIZE)
    write_blender_scene(os.path.join(workdir, "room"), scene)
    print(f"[sp1] wrote the room scene: {ROOM_VIEWS} views of {ROOM_SIZE}x"
          f"{ROOM_SIZE} in blender layout in {time.perf_counter() - t0:.2f} s; "
          f"camera depths of its surfaces {float(scene['depth'].min()):.3f}-"
          f"{float(scene['depth'].max()):.3f} (near/far 2/6)")
    flags = room_flags(workdir, "norcliffe_common_room_tpu.txt", "sp1", [
        "--structural_loss_start_iter", str(PRIOR_START),
        "--structural_loss_ramp_iters", str(PRIOR_RAMP)])
    out, text, training, testset = train_from_files(torch, "sp1", flags + [
        "--n_iters", str(PRIOR_STEPS), "--i_testset", str(PRIOR_TESTSET),
        "--i_weights", str(PRIOR_STEPS), "--i_print", str(PRIOR_PRINT)])
    lines = text.splitlines()
    priors = [l for l in lines if l.startswith("[PRIOR]")]
    schedule = [l.strip() for l in lines if "Structural priors activate in" in l
                or "ACTIVATING STRUCTURAL" in l or "Overfitting" in l
                or "Reduced structural" in l]
    for l in schedule + priors:
        print(f"[sp1] {l}")
    before, after = step_rates(out, [(PRIOR_START // 3 + 1, PRIOR_START - 1),
                                     (PRIOR_START + PRIOR_RAMP + 1,
                                      PRIOR_STEPS - 1)])
    print(f"[sp1] steps/s (median, 1024 rays) before the priors "
          f"{before:.2f}, with them {after:.2f}: the priors cost "
          f"{1e3 / after - 1e3 / before:.2f} ms a step; held-out PSNR "
          f"{[round(t['psnr'], 3) for t in out['testsets']]} dB at "
          f"{[t['step'] for t in out['testsets']]}; prior weights at the end "
          f"{out['prior_weights']}, decays {out['prior_decays']}")
    if len(priors) != (PRIOR_STEPS - PRIOR_START) // PRIOR_PRINT:
        raise AssertionError(f"[sp1] {len(priors)} [PRIOR] lines")
    if not any("ACTIVATING" in l for l in schedule):
        raise AssertionError("[sp1] no activation banner")
    held_out_gain("sp1", out["testsets"][-1]["psnr"], flags,
                  os.path.join(workdir, "sp10"), 1.0)
    return {"flags": flags, "state": out["state"], "training": training,
            "testset": testset["tent_contract"], "rates": (before, after)}


def phase_nerfacto(torch, workdir) -> dict:
    """(nf1) configs/nerfacto/norcliffe_common_room.txt (the nerfacto
    preset) on (sp1)'s room, NF_STEPS steps through run_nerf: no
    block-hash kernel launches (the hash grids are eager), one fused RAdam
    a step, the loss falls. (nf2) two steps from the trained state on the
    card and on the port's CPU path with one batch and one set of draws
    each, one that updates the proposal fields and one that does not: the
    loss 1e-5 relative, every RAdam moment FORWARD_NORM_TOL relative in
    norm (f32 sums in other orders and the hash grids' atomic index_add_),
    the proposal leaves unchanged by the second on both. (nf3) three
    800x800 requests through serve.build on the run's checkpoint: ms each,
    finite maps, the peak memory."""
    import argparse

    from indoor_nerf_tpu_torch import serve
    from indoor_nerf_tpu_torch.data.load import load_dataset
    from indoor_nerf_tpu_torch.train.config import parse_args
    from indoor_nerf_tpu_torch.train.optim import named_leaves
    from indoor_nerf_tpu_torch.train.step import (
        draw_step,
        init_train_state,
        train_step,
    )
    from indoor_nerf_tpu_torch.train.trainer import build_train_config, one_batch

    flags = room_flags(workdir, os.path.join("nerfacto",
                                             "norcliffe_common_room.txt"),
                       "nf1", ["--n_iters", str(NF_STEPS), "--i_testset",
                               str(NF_STEPS), "--i_weights", str(NF_STEPS),
                               "--i_print", "50"])
    from indoor_nerf_tpu_torch.render import proposal

    def updated(steps, params):
        # Every leaf on the steps that update the proposal fields, the
        # others' alone on the rest.
        names = named_leaves(params)
        p = sum(k.startswith("proposal_") for k in names)
        u = proposal.sample_counts()["updates"]
        return [(u, len(names)), (steps - u, len(names) - p)]

    proposal.reset_counts()
    out, _, training, testset = train_from_files(torch, "nf1", flags,
                                                 kernels=(), updated=updated)
    print(f"[nf1] held-out PSNR {out['testsets'][-1]['psnr']:.3f} dB at step "
          f"{NF_STEPS}; proposal updates since the last "
          f"{out['state']['proposal_since']}")
    card = out["state"]
    cpu_dev = torch.device("cpu")
    args = parse_args(flags + ["--device", "cpu"])
    cfg = build_train_config(args, load_dataset(args))
    cpu = init_train_state(torch.Generator().manual_seed(0), cfg)
    with torch.no_grad():
        for src, dst in ((named_leaves(card["params"]),
                          named_leaves(cpu["params"])),
                         (card["opt"]["mu"], cpu["opt"]["mu"]),
                         (card["opt"]["nu"], cpu["opt"]["nu"])):
            for k, v in src.items():
                dst[k].copy_(v.detach().cpu())
    for key in ("step", "proposal_since"):
        cpu[key] = card[key]
    cpu["opt"]["step"] = card["opt"]["step"]
    errs, updates = {}, []
    for i in range(2):
        _, batch = one_batch(args, cpu_dev, seed=5 + i)
        draws = draw_step(torch.Generator().manual_seed(3 + i), cfg,
                          cpu["step"], batch["rays_o"].shape[0])
        before = {k: v.detach().clone() for k, v in
                  named_leaves(card["params"]).items()
                  if k.startswith("proposal_")}
        cpu, mc = train_step(cpu, batch, cfg, draws=draws)
        card, mg = train_step(card, {k: v.cuda() for k, v in batch.items()},
                              cfg, draws={k: v.cuda() for k, v in draws.items()})
        updates.append((mc["proposal_update"], mg["proposal_update"]))
        errs[f"step {i} loss"] = abs(float(mg["loss"]) / float(mc["loss"]) - 1)
        for k, v in cpu["opt"]["mu"].items():
            want = float(v.norm())
            got = float(card["opt"]["mu"][k].norm())
            errs[f"step {i} mu.{k}"] = abs(got - want) / max(want, 1e-30)
        if not mg["proposal_update"]:
            moved = [k for k, v in before.items() if not torch.equal(
                v, named_leaves(card["params"])[k].detach())]
            if moved:
                raise AssertionError(f"[nf2] proposal leaves moved: {moved}")
    worst = max(errs, key=errs.get)
    print(f"[nf2] card against the CPU, two steps from step "
          f"{int(card['step']) - 2}: proposal updates (cpu, card) {updates}; "
          f"worst relative gap {worst} {errs[worst]:.2e} (tol 1e-5 for the "
          f"loss, {FORWARD_NORM_TOL} else); losses "
          f"{[round(errs[f'step {i} loss'], 9) for i in range(2)]}")
    bad = {k: v for k, v in errs.items()
           if v > (1e-5 if k.endswith("loss") else FORWARD_NORM_TOL)}
    if bad or len({u for pair in updates for u in pair}) != 2 or any(
            a != b for a, b in updates):
        raise AssertionError(f"[nf2] {bad} {updates}")
    del card, cpu, out
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (render, step, _), _ = quietly(serve.build, argparse.Namespace(
        width=800, height=800, baked=False, train_args=["--"] + flags))
    scene = load_dataset(args)
    ms = []
    for pose in scene.poses[scene.i_test[:3]]:
        maps, sec = render(pose)
        ms.append(sec * 1e3)
        if not all(np.all(np.isfinite(v)) for v in maps.values()):
            raise AssertionError("[nf3] a non-finite map")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[nf3] 800x800 requests on the step-{step} checkpoint: "
          f"{[round(m, 2) for m in ms]} ms, peak {peak:.2f} GiB")
    return {"training": training, "request_ms": ms}


def _syncs(torch, fn) -> list:
    """The host synchronisations ``fn()`` makes on the card, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them: the
    ``file:line`` of the Python call that made each."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")  # outside the record: it warns too
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return [f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message)]


def resolved_table_entries(got, want):
    """The table entries whose RAdam moments agree card against CPU to
    RESOLVED_RTOL of their own size, and the share of the entries the
    moments touch that fall outside (held under UNRESOLVED_SHARE)."""
    ok = np.ones(want["opt"]["mu"]["table"].shape, bool)
    for k in ("mu", "nu"):
        g, w = got["opt"][k]["table"], want["opt"][k]["table"]
        ok &= np.abs(g - w) <= RESOLVED_RTOL * np.abs(w)
    touched = (want["opt"]["mu"]["table"] != 0) | (got["opt"]["mu"]["table"] != 0)
    share = float((touched & ~ok).sum() / max(1, touched.sum()))
    return ok, share


def card_vs_cpu_step(torch, tag, flags, state, hold_loss=True, batch_seed=5,
                     draw_seed=3, hold=True) -> dict:
    """One step of ``flags`` from ``state`` on the card and on the port's
    CPU path with one batch and one set of draws (of the two seeds): the
    loss 1e-5 relative (unless ``hold_loss`` is False: the caller holds
    it), every RAdam moment, the params' update and (where kept) the EMA's
    relative in norm (FORWARD_NORM_TOL: the forwards differ in f32 order;
    the table's update over ``resolved_table_entries``, whose unresolved
    share is held under UNRESOLVED_SHARE). Returns the config, both steps'
    metrics (with the errors under ``"errs"``) and both states after the
    step, as numpy (``{"card", "cpu"}``); ``hold=False`` raises on none
    (``--step-spread``)."""
    from indoor_nerf_tpu_torch.bridge import state_from_numpy, state_to_numpy
    from indoor_nerf_tpu_torch.train.config import parse_args
    from indoor_nerf_tpu_torch.train.step import draw_step, train_step
    from indoor_nerf_tpu_torch.train.trainer import one_batch

    cpu = torch.device("cpu")
    cfg, batch = one_batch(parse_args(flags), cpu, seed=batch_seed)
    tree = state_to_numpy(state)
    step = int(tree["step"])
    draws = draw_step(torch.Generator(device=cpu).manual_seed(draw_seed), cfg,
                      step, batch["rays_o"].shape[0],
                      "spatial_coords" in batch, n_reg_rays(batch))

    def on(d, x):
        return ({k: on(d, v) for k, v in x.items()} if isinstance(x, dict)
                else x.to(d))

    res, metrics = {}, {}
    for label, d in (("cpu", cpu), ("card", torch.device("cuda:0"))):
        s, m = train_step(state_from_numpy(tree, d), on(d, batch), cfg,
                          draws=on(d, draws))
        metrics[label] = {k: float(v) for k, v in m.items()}
        res[label] = state_to_numpy(s)
    got, want = res["card"], res["cpu"]
    errs = {"loss": abs(metrics["card"]["loss"] / metrics["cpu"]["loss"] - 1)}
    errs.update({f"{k}.{n}": norm_rel(_tree_leaves(got["opt"][k][n]),
                                      _tree_leaves(want["opt"][k][n]))
                 for k in ("mu", "nu") for n in want["opt"][k]})
    resolved, errs["unresolved share"] = resolved_table_entries(got, want)
    for key in ("params", "ema") if "ema" in want else ("params",):
        for n in want[key]:
            g = [a - b for a, b in zip(_tree_leaves(got[key][n]),
                                       _tree_leaves(tree[key][n]))]
            w = [a - b for a, b in zip(_tree_leaves(want[key][n]),
                                       _tree_leaves(tree[key][n]))]
            if n == "table":
                g, w = [g[0][resolved]], [w[0][resolved]]
            errs[f"{key} update {n}"] = norm_rel(g, w)
    print(f"[{tag}] one step at step {step}, card against the CPU on one "
          f"state, batch ({batch['rays_o'].shape[0]} rays) and draws: loss "
          f"{metrics['card']['loss']:.8f} vs {metrics['cpu']['loss']:.8f}; "
          "relative in norm " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" (tol 1e-5 for the loss, {UNRESOLVED_SHARE} for the unresolved "
          f"share, {FORWARD_NORM_TOL} else; the table's update over the "
          "entries whose moments are resolved)")
    bad = {k: v for k, v in errs.items() if v > card_cpu_tol(k)
           and (hold_loss or k != "loss")}
    if bad and hold:
        raise AssertionError(f"[{tag}] card vs CPU: {bad}")
    metrics["errs"] = errs
    return cfg, metrics, res


def card_cpu_tol(name: str) -> float:
    """The tolerance of an error of ``card_vs_cpu_step`` (and of (y2))."""
    if name == "loss":
        return 1e-5
    return UNRESOLVED_SHARE if name == "unresolved share" else FORWARD_NORM_TOL


def phase_priors_step(torch, flags, state) -> None:
    """(sp2) one step with the priors (from step 0) from (sp1)'s trained
    state: (a) through the kernels and their plain versions, held as (g);
    (b) card against CPU (``card_vs_cpu_step``), the priors' floor and wall
    counts equal and their terms 1e-4 relative; then the priors' functions
    on the card's rendered depth and normals, on the card and on the CPU:
    masks, counts and the consistency pairs' nearest neighbours equal, the
    frame within PRIOR_FRAME_TOL, each loss within PRIOR_LOSS_RTOL; (c) the
    host synchronisations of one step with and without the priors, and of
    torch.linalg.svd on a 3x3 card tensor (reported; the step's own gated
    to add none with the priors)."""
    import dataclasses as dc

    from indoor_nerf_tpu_torch.losses import priors as lp
    from indoor_nerf_tpu_torch.render.renderer import render_rays
    from indoor_nerf_tpu_torch.train.config import parse_args
    from indoor_nerf_tpu_torch.train.step import draw_step, prior_ramp_weights
    from indoor_nerf_tpu_torch.train.trainer import one_batch

    now = flags + ["--structural_loss_start_iter", "0"]
    phase_step_check(torch, "sp2", now, state)
    cfg, metrics, _ = card_vs_cpu_step(torch, "sp2", now, {**state, "step": 0})
    for k in ("structural_semantic_floor_count", "structural_semantic_wall_count"):
        if metrics["card"][k] != metrics["cpu"][k]:
            raise AssertionError(f"[sp2] {k} card {metrics['card'][k]} cpu "
                                 f"{metrics['cpu'][k]}")
    for k, w in prior_ramp_weights(cfg, 0).items():
        c, g = metrics["card"][f"structural_{k}"], metrics["cpu"][f"structural_{k}"]
        tol = PRIOR_STEP_RTOL * abs(g) + PRIOR_STEP_ATOL * w
        print(f"[sp2] structural_{k} card {c:.6e} cpu {g:.6e} (|diff| "
              f"{abs(c - g):.2e}, tol {tol:.2e})")
        if abs(c - g) > tol:
            raise AssertionError(f"[sp2] structural_{k} card {c} cpu {g}")

    # The priors' functions on identical inputs: the card's render.
    dev, cpu = torch.device("cuda:0"), torch.device("cpu")
    cfg, batch = one_batch(parse_args(now), dev, seed=5)
    n = batch["rays_o"].shape[0]
    draws = draw_step(torch.Generator(device=dev).manual_seed(3), cfg, 0, n, True)
    rays_d = batch["rays_d"]
    with torch.no_grad():
        out, _ = render_rays(
            state["params"], batch["rays_o"], rays_d,
            rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True),
            cfg.near * torch.ones_like(rays_d[..., :1]),
            cfg.far * torch.ones_like(rays_d[..., :1]),
            cfg.render, occ_state=state["occ"], step=0, draws=draws)
    weights = prior_ramp_weights(cfg, 0)
    pc = cfg.priors
    found = {}
    for label, d in (("card", dev), ("cpu", cpu)):
        normals, depth = out["normal_map"].to(d), out["depth_map"].to(d)
        coords = batch["spatial_coords"].to(d)
        pd = {k: v.to(d) for k, v in draws["priors"].items()}
        sem = lp.detect_planes(normals, pc)
        frame = lp.estimate_manhattan_frame(
            normals, torch.linalg.norm(normals, dim=-1), pd["centers"], pc)
        idx1 = pd["consist_idx"]
        dist = torch.linalg.norm(coords[idx1][:, None] - coords[None], dim=-1)
        dist[torch.arange(len(idx1), device=d), idx1] = float("inf")
        found[label] = {
            "floor_mask": sem["floor_mask"].cpu(), "wall_mask": sem["wall_mask"].cpu(),
            "pairs": torch.argmin(dist, dim=-1).cpu(), "frame": frame.cpu(),
            "manhattan": float(lp.manhattan_sdf_loss(normals, frame, sem,
                                                     weights["manhattan"])),
            "planarity": float(lp.structured_planarity_loss(
                depth, sem, weights["planarity"], pd)),
            "normal_consistency": float(lp.spatial_normal_consistency_loss(
                normals, depth, coords, weights["normal_consistency"], idx1))}
    c, g = found["card"], found["cpu"]
    same = {k: bool(torch.equal(c[k], g[k]))
            for k in ("floor_mask", "wall_mask", "pairs")}
    frame_err = float((c["frame"] - g["frame"]).abs().max())
    loss_err = {k: abs(c[k] - g[k]) / max(abs(g[k]), 1e-30) for k in weights}
    print(f"[sp2] the priors on the card's render of {n} rays, card against "
          f"CPU: floor rays {int(c['floor_mask'].sum())}, wall rays "
          f"{int(c['wall_mask'].sum())}; equal {same}; frame max |diff| "
          f"{frame_err:.2e} (tol {PRIOR_FRAME_TOL}); losses rel "
          + ", ".join(f"{k} {v:.2e}" for k, v in loss_err.items())
          + f" (tol {PRIOR_LOSS_RTOL} + {PRIOR_LOSS_ATOL:.2e} x weight)")
    if not all(same.values()) or frame_err > PRIOR_FRAME_TOL:
        raise AssertionError(f"[sp2] masks/pairs {same}, frame {frame_err}")
    for k in weights:
        if abs(c[k] - g[k]) > PRIOR_LOSS_RTOL * abs(g[k]) + PRIOR_LOSS_ATOL * weights[k]:
            raise AssertionError(f"[sp2] {k} card {c[k]} cpu {g[k]}")

    # (c) host synchronisations.
    cfg_s, one_step = step_from(torch, now, state)
    off = dc.replace(cfg_s, use_structural_priors=False)
    one_step(cfg_s)
    one_step(off)
    with_priors, without = _syncs(torch, lambda: one_step(cfg_s)), \
        _syncs(torch, lambda: one_step(off))
    a = torch.randn(3, 3, device=dev)
    svd_syncs = _syncs(torch, lambda: torch.linalg.svd(a))
    extra = list(with_priors)
    for where in without:
        if where in extra:
            extra.remove(where)
    print(f"[sp2] host synchronisations of one step (a fresh train state "
          f"and the step): with the priors {len(with_priors)}, without "
          f"{len(without)} at {sorted(set(without))}; the priors' own "
          f"{extra}; torch.linalg.svd of a 3x3 card tensor {len(svd_syncs)} "
          "(the priors' frame uses polar_factor, no SVD)")
    if extra:
        raise AssertionError(f"[sp2] the priors add host synchronisations "
                             f"to the step at {extra}")


def phase_parity_priors(torch, workdir) -> dict:
    """(sp3) configs/norcliffe_common_room.txt as shipped (the hash grid,
    64 + 128 samples, NeRFSmall coarse and fine with normal nets) on the
    room, PARITY_PRIOR_STEPS steps with the priors from PARITY_PRIOR_START:
    no kernel of csrc/ launches, the loss falls, the held-out PSNR rises
    above the seeded field's; steps/s before and with the priors."""
    flags = room_flags(workdir, "norcliffe_common_room.txt", "sp3", [
        "--structural_loss_start_iter", str(PARITY_PRIOR_START),
        "--structural_loss_ramp_iters", "100"])
    out, text, training, testset = train_from_files(torch, "sp3", flags + [
        "--n_iters", str(PARITY_PRIOR_STEPS), "--i_testset",
        str(PARITY_PRIOR_STEPS), "--i_weights", str(PARITY_PRIOR_STEPS)],
        kernels=())
    for l in text.splitlines():
        if l.startswith("[PRIOR]"):
            print(f"[sp3] {l}")
    before, after = step_rates(out, [(PARITY_PRIOR_START // 4 + 1,
                                      PARITY_PRIOR_START - 1),
                                     (PARITY_PRIOR_START + 1,
                                      PARITY_PRIOR_STEPS - 1)])
    print(f"[sp3] steps/s (median) before the priors {before:.2f}, with them "
          f"{after:.2f} ({1e3 / after - 1e3 / before:.2f} ms a step)")
    held_out_gain("sp3", out["testsets"][-1]["psnr"], flags,
                  os.path.join(workdir, "sp30"), 0.5)
    return {"parity_priors_training": training,
            "parity_priors_testset": testset}


def phase_extensions(torch, prior_flags) -> dict:
    """(sp4) the flagship with the distortion loss, the table decay, the
    params EMA and both anneals for EXT_STEPS steps (the kernels launch,
    the loss falls), one such step card against CPU; then (sp1)'s field
    served: an 800x800 request online and one --baked (256^3), each timed,
    baked against online in PSNR on a held-out pose."""
    from indoor_nerf_tpu_torch import serve
    from indoor_nerf_tpu_torch.data.load import load_dataset
    from indoor_nerf_tpu_torch.train.config import parse_args

    out, launches = phase_training(torch, "sp4", EXT_FLAGS, EXT_STEPS,
                                   ("tent_contract", "table_scatter"))
    # Halfway through both anneals (50 steps): every extension acts.
    card_vs_cpu_step(torch, "sp4", EXT_FLAGS, {**out["state"], "step": 25})
    del out
    torch.cuda.empty_cache()
    (render, step, _), text = quietly(serve.build, argparse.Namespace(
        width=REQUEST_SIZE, height=REQUEST_SIZE, train_args=["--"] + prior_flags))
    if step != PRIOR_STEPS or "UNTRAINED" in text:
        raise AssertionError(f"[sp4] served step {step}: {text}")
    scene = load_dataset(parse_args(prior_flags))
    scene_poses = scene.poses[scene.i_test]
    reset_counts()
    ms, online = request_ms(torch, render, scene_poses[:1])
    serving = launch_counts()["tent_contract"]
    del render
    torch.cuda.empty_cache()
    baked, bake_s, _ = parity_baked(prior_flags, BAKE_RES)
    reset_counts()
    baked_ms, baked_maps = request_ms(torch, baked, scene_poses[:1])
    baked_launches = launch_counts()["tent_contract"]
    del baked
    torch.cuda.empty_cache()
    quality = psnr(baked_maps[0]["rgb_map"], online[0]["rgb_map"])
    print(f"[sp4] (sp1)'s field at step {step} served at {REQUEST_SIZE}x"
          f"{REQUEST_SIZE}: online {', '.join(f'{v:.1f}' for v in ms)} ms "
          f"(tent_contract launches {serving}); --baked at {BAKE_RES}^3 (bake "
          f"{bake_s:.2f} s) {', '.join(f'{v:.1f}' for v in baked_ms)} ms "
          f"(tent_contract launches {baked_launches}); baked against online "
          f"{quality:.2f} dB on a held-out pose")
    if serving <= 0 or baked_launches <= 0:
        raise AssertionError("[sp4] serving launched no tent_contract")
    return {"training_extensions": launches, "serving_priors": serving,
            "baked_serving_priors": baked_launches}


def quant_lines(text) -> list:
    """``(step, average bits)`` of each ``[QUANT]`` line of a trainer run,
    each following its step's ``[TRAIN]`` line."""
    out, step = [], None
    for line in text.splitlines():
        if line.startswith("[TRAIN] Iter: "):
            step = int(line.split()[2])
        elif line.startswith("[QUANT] Average bits: "):
            out.append((step, float(line.split()[3].rstrip(","))))
    return out


def phase_acaq(torch, workdir, plain) -> dict:
    """(aq1) configs/lego_tpu.txt as (v) runs it, on (v)'s scene, with
    --use_quantization --use_acaq --acaq_start_iter AQ_START for AQ_STEPS
    steps, test sets every AQ_TESTSET: tent_contract and table_scatter
    launch on every step (table_scatter exactly once), the loss falls, the
    [QUANT] average moves from 8 after AQ_START, every grid level is
    calibrated (the warmup passed), the held-out PSNR is 0.5 dB above the
    seeded field's; printed beside (v)'s (``plain``) at the same step, with
    both runs' steps/s."""
    flags = ["--config", os.path.join(ROOT, "configs", "lego_tpu.txt"),
             "--datadir", plain["scene_dir"], "--basedir",
             os.path.join(workdir, "aq1"), "--lrate", "0.01"] + AQ_FLAGS
    held = torch.cuda.memory_allocated()  # by the phases before this one
    out, text, training, testset = train_from_files(torch, "aq1", flags + [
        "--n_iters", str(AQ_STEPS), "--i_testset", str(AQ_TESTSET),
        "--i_weights", str(AQ_STEPS), "--i_video", str(10 * AQ_STEPS)])
    tile_model(torch, "aq1", flags, torch.cuda.max_memory_allocated() - held,
               out["state"])
    bits = quant_lines(text)
    steps_s = AQ_STEPS / (out["seconds"] - out["eval_seconds"])
    quant = out["state"]["quant"]
    psnrs = {t["step"]: t["psnr"] for t in out["testsets"]}
    same = {t["step"]: t["psnr"] for t in plain["testsets"]}
    print(f"[aq1] [QUANT] average bits by step {bits}; soft bits at the end: "
          f"grid {[round(v, 3) for v in quant['embed']['soft_bits'].tolist()]}"
          f", activation {[round(v, 3) for v in quant['act']['soft_bits'].tolist()]}"
          f", weight {float(quant['weight']['soft_bits']):.3f}; infl_ema "
          f"{float(out['state']['infl_ema']):.5f}")
    print(f"[aq1] held-out PSNR {[round(v, 3) for v in psnrs.values()]} dB at "
          f"steps {list(psnrs)}; at step {FILE_STEPS}: quantized "
          f"{psnrs[FILE_STEPS]:.3f} dB, (v) unquantized {same[FILE_STEPS]:.3f} "
          f"dB; steps/s quantized {steps_s:.2f}, (v) {plain['steps_s']:.2f}")
    if training["table_scatter"] != AQ_STEPS or \
            training["tent_contract"] < AQ_STEPS:
        raise AssertionError(f"[aq1] not a launch a step: {training}")
    if not bits or any(b != 8.0 for s, b in bits if s <= AQ_START) \
            or bits[-1][1] == 8.0:
        raise AssertionError(f"[aq1] the [QUANT] average: {bits}")
    if not bool(quant["embed"]["calibrated"].all()):
        raise AssertionError("[aq1] a grid level stayed uncalibrated")
    held_out_gain("aq1", out["testsets"][-1]["psnr"], flags,
                  os.path.join(workdir, "aq10"), 0.5)
    return {"flags": flags, "state": out["state"], "logdir": out["logdir"],
            "training": training, "testset": testset["tent_contract"]}


def tile_model(torch, tag, flags, peak, state) -> None:
    """The render's tile model (render/renderer.py::bytes_per_ray, ROADMAP
    Queue 3 F5) of ``flags``' test sets against ``peak``, the peak device
    memory of their run above what was allocated before it: the train
    state's bytes plus one tile of ``default_tile_rays`` rays at
    ``bytes_per_ray`` (the quantized field's and, beside it, the same
    field's unquantized)."""
    from indoor_nerf_tpu_torch.data.load import load_dataset
    from indoor_nerf_tpu_torch.render.renderer import (
        bytes_per_ray,
        default_tile_rays,
    )
    from indoor_nerf_tpu_torch.train.config import parse_args
    from indoor_nerf_tpu_torch.train.trainer import build_train_config
    from indoor_nerf_tpu_torch.utils.checkpoint import _tensor_leaves

    args = parse_args(flags)
    rc = build_train_config(args, load_dataset(args)).render
    plain = dataclasses.replace(rc, field=dataclasses.replace(
        rc.field, use_quantization=False))
    tile = default_tile_rays(torch.device("cuda:0"), rc)
    state_bytes = nbytes(*_tensor_leaves(state).values())
    model = state_bytes + tile * bytes_per_ray(rc)
    print(f"[{tag}] the render's tile model: {bytes_per_ray(rc)} bytes a ray "
          f"({bytes_per_ray(plain)} unquantized), tiles of {tile} rays "
          f"({default_tile_rays(torch.device('cuda:0'), plain)} unquantized): "
          f"{tile * bytes_per_ray(rc) / 2**30:.2f} GiB + the train state's "
          f"{state_bytes / 2**30:.2f} GiB = {model / 2**30:.2f} GiB against "
          f"the run's peak device memory above what it found allocated "
          f"{peak / 2**30:.2f} GiB")


def acaq_loss_check(torch, flags, state) -> None:
    """(aq2)'s loss, card against CPU, on ``card_vs_cpu_step``'s batch and
    draws: the quantized forward at ``state``'s step on both, each ray's
    squared error. A rendered colour that differs by more than 1e-5
    marks a ray where an activation (or a table entry) lies within f32
    rounding of a rounding boundary of its ~4-bit quantizer, which then
    rounds apart on the two sides by a whole step (a twelfth of its range);
    at most 1% of the rays may. Over the others the loss holds at 1e-5
    relative, as (sp2) holds its step's."""
    from indoor_nerf_tpu_torch.bridge import state_from_numpy, state_to_numpy
    from indoor_nerf_tpu_torch.render.renderer import render_rays
    from indoor_nerf_tpu_torch.train.config import parse_args
    from indoor_nerf_tpu_torch.train.step import draw_step
    from indoor_nerf_tpu_torch.train.trainer import one_batch

    cpu = torch.device("cpu")
    cfg, batch = one_batch(parse_args(flags), cpu, seed=5)
    tree, step = state_to_numpy(state), int(state["step"])
    n = batch["rays_o"].shape[0]
    draws = draw_step(torch.Generator(device=cpu).manual_seed(3), cfg, step,
                      n, "spatial_coords" in batch)
    rgb, err = {}, {}
    for label, d in (("cpu", cpu), ("card", torch.device("cuda:0"))):
        s = state_from_numpy(tree, d)
        rays_d = batch["rays_d"].to(d)
        with torch.no_grad():
            out, _ = render_rays(
                s["params"], batch["rays_o"].to(d), rays_d,
                rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True),
                cfg.near * torch.ones_like(rays_d[..., :1]),
                cfg.far * torch.ones_like(rays_d[..., :1]), cfg.render,
                occ_state=s["occ"], step=step,
                draws={k: v.to(d) for k, v in draws.items()},
                quant_state=s["quant"], train=True)
        rgb[label] = out["rgb_map"].cpu()
        err[label] = torch.mean((rgb[label] - batch["target"]) ** 2, dim=-1)
    apart = (rgb["card"] - rgb["cpu"]).abs().amax(dim=-1) > 1e-5
    share = float(apart.float().mean())
    losses = {k: float(v[~apart].mean()) for k, v in err.items()}
    rel = abs(losses["card"] / losses["cpu"] - 1)
    print(f"[aq2] the quantized forward, card against CPU: {int(apart.sum())} "
          f"of {n} rays' colours apart by more than 1e-5 (at most 1%); the "
          f"image loss over the others {losses['card']:.8f} vs "
          f"{losses['cpu']:.8f}, {rel:.2e} relative (tol 1e-5); over all "
          f"{float(err['card'].mean()):.8f} vs {float(err['cpu'].mean()):.8f}")
    if share > 0.01 or rel > 1e-5:
        raise AssertionError(f"[aq2] loss card vs CPU: {share} of the rays "
                             f"apart, {rel} over the others")


def phase_acaq_step(torch, flags, state) -> None:
    """(aq2) one controller step after the warmup (AQ_STEPS) from (aq1)'s
    state, card against CPU on one batch and draws: the loss 1e-5 over the
    rays whose quantized forward agrees (``acaq_loss_check``), moments and
    updates in norm as ``card_vs_cpu_step``, soft bits 1e-6, infl_ema 1e-5
    relative, the grid's and the weight's running ranges 1e-6 relative, the
    activations' 1e-5, calibrated equal; then the step through the kernels
    against their plain versions, held as (g)."""
    from indoor_nerf_tpu_torch.train.step import acaq_active

    step = int(state["step"])
    cfg, _, res = card_vs_cpu_step(torch, "aq2", flags, state,
                                   hold_loss=False)
    acaq_loss_check(torch, flags, state)
    if not (acaq_active(cfg, step)
            and step >= cfg.render.field.quant.warmup_steps):
        raise AssertionError(f"[aq2] step {step} is no controller step after "
                             "the warmup")
    got, want = res["card"], res["cpu"]
    before = state["quant"]["embed"]["soft_bits"].cpu().numpy()
    errs = {}
    for group, leaves in want["quant"].items():
        for k, w in leaves.items():
            g = got["quant"][group][k]
            if w.dtype == np.bool_:
                if not np.array_equal(g, w):
                    raise AssertionError(f"[aq2] {group}.{k}: {g} vs {w}")
                continue
            errs[f"{group}.{k}"] = float(np.max(np.abs(g - w) / np.maximum(
                np.abs(w), 1e-30)))
    errs["infl_ema"] = abs(float(got["infl_ema"]) / float(want["infl_ema"]) - 1)
    moved = float(np.abs(got["quant"]["embed"]["soft_bits"] - before).min())
    print(f"[aq2] the controller at step {step}: grid bits moved by >= "
          f"{moved:.4f}; card against CPU, relative: "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + " (tol 1e-6; infl_ema and the activations' ranges 1e-5)")
    # The activations' running min and max are those of h, sums over the
    # 32 features that the card's and the CPU's matmuls take in different
    # orders (2.3e-6 apart measured): 1e-5. The grid's and the weight's are
    # entries of the table and the weight: 1e-6, as the soft bits.
    bad = {k: v for k, v in errs.items()
           if v > (1e-5 if k == "infl_ema" or (k.startswith("act.")
                                                and k != "act.soft_bits")
                   else 1e-6)}
    if bad or not moved > 0.0:
        raise AssertionError(f"[aq2] card vs CPU {bad}, bits moved {moved}")
    for pair in encode_step_pairs(encode_steps(torch, flags, state,
                                               at_step=True)):
        hold_steps(torch, "aq2", *pair)


def phase_int8(torch) -> dict:
    """(aq3) --block_io int8 on the flagship for INT8_STEPS steps (the
    kernels launch, the loss falls); on the trained table the int8 pack
    pass against its plain form (bit for bit) and against the JAX formula
    computed on the CPU in numpy (bit for bit), the encode forward at the
    training shape through tent_contract against its plain form on the
    card and on the CPU (1e-5), both packs timed; one int8 step card
    against CPU; the bench step int8 against bf16 in alternating windows.
    Returns the int8 training's launches and the int8 pack's ms."""
    from indoor_nerf_tpu_torch.ops import blockhash
    from indoor_nerf_tpu_torch.ops import tent_contract as tc
    from indoor_nerf_tpu_torch.train.config import parse_args
    from indoor_nerf_tpu_torch.train.trainer import one_batch

    out, launches = phase_training(torch, "aq3", INT8_FLAGS, INT8_STEPS,
                                   ("tent_contract", "table_scatter"))
    dev = torch.device("cuda:0")
    cfg, _ = one_batch(parse_args(INT8_FLAGS), dev)
    bg = cfg.render.field.block_grid
    L, R, F = bg.n_levels, bg.rows_per_level, bg.n_features_per_level
    table = out["state"]["params"]["table"].detach()
    reset_counts()
    packed = blockhash.gather_table(table, bg)
    plain = tc.pack_rows_plain(tc.dequantize_int8_plain(table, L), F,
                               torch.float32)
    t = table.cpu().numpy()
    scale = np.maximum(np.abs(t.reshape(L, -1)).max(axis=1),
                       np.float32(1e-12)) / np.float32(127.0)
    s = np.repeat(scale, R)[:, None]
    jax_formula = np.round(t / s) * s
    same = (bool(torch.equal(packed, plain)), bool(np.array_equal(
        tc.unpack_rows(packed).cpu().numpy(), jax_formula)))
    g = torch.Generator(device=dev).manual_seed(7)
    lo = torch.tensor(bg.bbox_min, device=dev)
    hi = torch.tensor(bg.bbox_max, device=dev)
    x = lo + (hi - lo) * torch.rand((TRAIN_RAYS * 32, 3), generator=g,
                                    device=dev)
    flat_row, p, _ = blockhash._tile_coords(x, bg)
    got = tc.tent_contract(packed, flat_row, p, bg.side, F)
    want = tc.tent_contract_plain(packed, flat_row, p, bg.side, F)
    on_cpu = tc.tent_contract_plain(torch.from_numpy(jax_formula),
                                    flat_row.cpu(), p.cpu(), bg.side, F)
    errs = (float((got - want).abs().max()),
            float((got.cpu() - on_cpu).abs().max()))
    bf16 = dataclasses.replace(bg, gather_dtype="bfloat16")
    int8_ms = cuda_ms(torch, lambda: blockhash.gather_table(table, bg), 20)
    bf16_ms = cuda_ms(torch, lambda: blockhash.gather_table(table, bf16), 20)
    contract_ms = cuda_ms(torch, lambda: tc.tent_contract(
        packed, flat_row, p, bg.side, F), 20)
    bf16_packed = blockhash.gather_table(table, bf16)
    bf16_contract_ms = cuda_ms(torch, lambda: tc.tent_contract(
        bf16_packed, flat_row, p, bg.side, F), 20)
    print(f"[aq3] on the trained [{table.shape[0]}, {table.shape[1]}] table: "
          f"the int8 pack equal to its plain form {same[0]} and to the JAX "
          f"formula on the CPU {same[1]}; the encode forward at M = "
          f"{flat_row.shape[0]:,}: kernel against plain max |diff| "
          f"{errs[0]:.2e}, against the CPU {errs[1]:.2e} (tol {KERNEL_TOL}); "
          f"pack int8 {int8_ms:.4f} ms, bf16 {bf16_ms:.4f} ms; tent_contract "
          f"on the f32 int8 pack {contract_ms:.4f} ms, on the bf16 pack "
          f"{bf16_contract_ms:.4f} ms")
    if not all(same) or max(errs) > KERNEL_TOL:
        raise AssertionError(f"[aq3] int8 pack {same}, encode {errs}")
    # At 1024 rays, to keep the CPU's side of the step short.
    card_vs_cpu_step(torch, "aq3", INT8_FLAGS + ["--N_rand", "1024"],
                     out["state"])
    del out
    torch.cuda.empty_cache()
    alternating_step_ms(torch, "aq3", {"bf16": bench_with(),
                                       "int8": bench_with(gather_dtype="int8")})
    return launches, int8_ms


def phase_acaq_serving(torch, flags, state, logdir) -> int:
    """(aq4) (aq1)'s checkpoint: restored, every leaf (the quantizers and
    infl_ema included) equals the state it saved; a second trainer.train
    call resumes it for one step; serve.build serves it at 800x800 with its
    quantizers (tent_contract launches; requests timed), and the served
    view of a held-out pose is held against the same params rendered
    unquantized (PSNR, timed). Returns the requests' tent_contract
    launches."""
    from indoor_nerf_tpu_torch import serve
    from indoor_nerf_tpu_torch.data.load import load_dataset
    from indoor_nerf_tpu_torch.models.field import serving_params
    from indoor_nerf_tpu_torch.render.renderer import make_image_renderer
    from indoor_nerf_tpu_torch.train.config import parse_args
    from indoor_nerf_tpu_torch.train.step import init_train_state
    from indoor_nerf_tpu_torch.train.trainer import build_train_config, train
    from indoor_nerf_tpu_torch.utils import checkpoint

    dev = torch.device("cuda:0")
    args = parse_args(flags)
    scene = load_dataset(args)
    cfg = build_train_config(args, scene)
    path = os.path.join(logdir, f"{AQ_STEPS:06d}.ckpt")
    restored = checkpoint.restore_checkpoint(path, init_train_state(
        torch.Generator(device=dev).manual_seed(1), cfg, dev))
    saved, back = (checkpoint._tensor_leaves(x) for x in (state, restored))
    unequal = [k for k in saved if not torch.equal(saved[k], back[k])]
    if set(saved) != set(back) or unequal or restored["step"] != AQ_STEPS:
        raise AssertionError(f"[aq4] restored {path}: unequal {unequal}")
    del restored
    resumed, text = quietly(train, parse_args(flags + [
        "--n_iters", str(AQ_STEPS + 1)]))
    if f"Reloading from {path}" not in text or \
            resumed["state"]["step"] != AQ_STEPS + 1 or \
            not np.isfinite(resumed["losses"]).all():
        raise AssertionError(f"[aq4] the resumed run: {text[-2000:]}")
    print(f"[aq4] {path} restores {len(saved)} leaves equal to the saved "
          f"state ({sum('quant.' in k for k in saved)} of the quantizers); "
          f"resumed for one step: loss {resumed['losses'][0]:.6f}")
    params, quant = resumed["state"]["params"], resumed["state"]["quant"]
    occ = resumed["state"]["occ"]
    del resumed
    torch.cuda.empty_cache()
    (render, step, hw), text = quietly(serve.build, argparse.Namespace(
        width=REQUEST_SIZE, height=REQUEST_SIZE, train_args=["--"] + flags))
    if step != AQ_STEPS + 1 or "UNTRAINED" in text:
        raise AssertionError(f"[aq4] served step {step}")
    pose = scene.poses[scene.i_test[0]]
    reset_counts()
    ms, served = request_ms(torch, render, [pose])
    launches = launch_counts()["tent_contract"]
    del render
    W = H = REQUEST_SIZE
    focal = scene.hwf[2] * (W / scene.hwf[1])
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    online = make_image_renderer(cfg.render.test_mode(), H, W)
    sp = serving_params(params, cfg.render.field)

    def unquantized(c2w):
        t0 = time.perf_counter()
        out = online(sp, c2w, K, scene.near, scene.far, occ)
        maps = {k: v.cpu().numpy() for k, v in out.items()}
        return maps, time.perf_counter() - t0

    plain_ms, plain = request_ms(torch, unquantized, [pose])
    quality = psnr(served[0]["rgb_map"], plain[0]["rgb_map"])
    bits = [round(v, 2) for v in quant["embed"]["soft_bits"].tolist()]
    print(f"[aq4] served at step {step}, {W}x{H}, grid bits {bits} (rounded "
          f"in evaluation): quantized request {', '.join(f'{v:.1f}' for v in ms)}"
          f" ms (tent_contract launches {launches}), the same params "
          f"unquantized {', '.join(f'{v:.1f}' for v in plain_ms)} ms; "
          f"quantized against unquantized {quality:.2f} dB on held-out pose "
          f"{int(scene.i_test[0])}")
    if launches <= 0 or not np.isfinite(served[0]["rgb_map"]).all():
        raise AssertionError(f"[aq4] quantized serving: launches {launches}")
    return launches


def alternating_file_steps(torch, tag, runs: dict) -> dict:
    """Steps/s of the train steps of two CLI configurations ``runs``
    ``{name: argv}`` (an argv with ``--multihost``: the sharded step over
    the process group already joined) on one scene (each from its seeded state, its batches
    from ``trainer.make_sampler``, copied to the card as ``trainer.train``
    copies them), in windows of RP_WINDOW steps, a, b, b, a twice in this
    process, after a warm-up window each; printed, and returned by name."""
    from indoor_nerf_tpu_torch.data.load import load_dataset
    from indoor_nerf_tpu_torch.train.config import parse_args
    from indoor_nerf_tpu_torch.train.step import init_train_state, train_step
    from indoor_nerf_tpu_torch.train.trainer import (
        build_train_config,
        make_sampler,
    )

    from indoor_nerf_tpu_torch.parallel.shard import (
        make_mesh,
        make_sharded_train_step,
    )

    dev = torch.device("cuda:0")
    scene, runners = None, {}
    for name, argv in runs.items():
        args = parse_args(argv)
        scene = scene or load_dataset(args)  # one scene for both
        cfg = build_train_config(args, scene)
        state = init_train_state(
            torch.Generator(device=dev).manual_seed(args.seed), cfg, dev)
        # A --multihost argv runs the sharded step over this process's mesh
        # (md1: the process group (md1) joined, of one rank).
        step = (make_sharded_train_step(cfg, make_mesh())
                if args.multihost else functools.partial(train_step,
                                                         config=cfg))
        runners[name] = {"step": step, "state": state, "i": 0,
                         "gen": torch.Generator(device=dev).manual_seed(
                             args.seed + 1),
                         "sample": make_sampler(args, scene, cfg, args.seed)[0]}

    def window(r) -> float:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(RP_WINDOW):
            r["i"] += 1
            batch = {k: torch.from_numpy(v).to(dev, non_blocking=True)
                     for k, v in r["sample"](r["i"]).items()}
            r["state"], metrics = r["step"](r["state"], batch,
                                            generator=r["gen"])
        torch.cuda.synchronize(dev)
        if not np.isfinite(float(metrics["loss"])):
            raise AssertionError(f"[{tag}] non-finite loss")
        return RP_WINDOW / (time.perf_counter() - t0)

    for r in runners.values():
        window(r)  # warm-up
    a, b = runs
    rates = {a: [], b: []}
    for name in (a, b, b, a) * 2:
        rates[name].append(window(runners[name]))
    print(f"[{tag}] steps/s in alternating windows of {RP_WINDOW} steps "
          + "; ".join(f"{k} {', '.join(f'{v:.2f}' for v in vs)} (median "
                      f"{float(np.median(vs)):.2f})" for k, vs in rates.items())
          + f": {tag} {float(np.median(rates[b]) / np.median(rates[a])):.3f} "
          f"of {a}")
    return rates


def phase_reg_patches(torch, workdir, plain) -> dict:
    """(rp1) (v)'s configs/lego_tpu.txt run on (v)'s scene with RP_FLAGS
    (4 patches of 8^2 rays a step, planar, from step 100) for RP_STEPS
    steps, a test set at RP_STEPS: the [reg] line, the loss falls, two
    tent_contract launches a step (the image rays' and the patches' render)
    plus one a grid refresh, two table_scatter launches a step, the
    held-out PSNR 3 dB above the seeded field's, beside (v)'s at the same
    step; then the steps/s of (v)'s and this configuration alternating."""
    from indoor_nerf_tpu_torch.train.config import parse_args

    flags = ["--config", os.path.join(ROOT, "configs", "lego_tpu.txt"),
             "--datadir", plain["scene_dir"], "--basedir",
             os.path.join(workdir, "rp1"), "--lrate", "0.01"] + RP_FLAGS
    out, text, training, testset = train_from_files(torch, "rp1", flags + [
        "--n_iters", str(RP_STEPS), "--i_testset", str(RP_STEPS),
        "--i_weights", str(RP_STEPS), "--i_video", str(10 * RP_STEPS)])
    reg = [l for l in text.splitlines() if l.startswith("[reg]")]
    refreshes = len(range(0, RP_STEPS, parse_args(flags).occ_update_interval))
    psnr = out["testsets"][-1]["psnr"]
    same = {t["step"]: t["psnr"] for t in plain["testsets"]}[RP_STEPS]
    print(f"[rp1] {reg}; training launches tent_contract "
          f"{training['tent_contract']} (2 a step + {refreshes} grid "
          f"refreshes), table_scatter {training['table_scatter']} (2 a step) "
          f"in {RP_STEPS} steps; held-out PSNR at step {RP_STEPS} {psnr:.3f} "
          f"dB, (v)'s without patches {same:.3f} dB")
    if not reg:
        raise AssertionError("[rp1] no [reg] line")
    if training["table_scatter"] != 2 * RP_STEPS or \
            training["tent_contract"] != 2 * RP_STEPS + refreshes:
        raise AssertionError(f"[rp1] not two launches a step: {training}")
    held_out_gain("rp1", psnr, flags, os.path.join(workdir, "rp10"), 3.0)
    alternating_file_steps(torch, "rp1", {"v": plain["flags"], "rp1": flags})
    return {"flags": flags, "state": out["state"], "training": training,
            "testset": testset["tent_contract"]}


def phase_reg_step(torch, flags, state) -> None:
    """(rp2) one patch step at (rp1)'s last step (past --reg_start_iter):
    card against CPU on one batch with its patches and one set of draws
    (``card_vs_cpu_step``), each of its two renders as the step makes it:
    the rays apart (samples moved a bin, or, image rays, a colour, patch
    rays, a depth or an acc, more than RP_MAP_ATOL apart) counted, under a
    quarter of each render's (as (y2)); the image loss over the other
    image rays within 1e-5 relative; the smoothness of the card's maps,
    the card's against the CPU's op, within RP_REG_RTOL. Then through the
    kernels against their plain versions, held as (g)."""
    from indoor_nerf_tpu_torch.ops.tv import patch_depth_regularizer
    from indoor_nerf_tpu_torch.render.renderer import render_rays
    from indoor_nerf_tpu_torch.train import step as train_step_module
    from indoor_nerf_tpu_torch.train.config import parse_args
    from indoor_nerf_tpu_torch.train.trainer import one_batch

    args = parse_args(flags)
    n_reg = args.reg_views * args.reg_patch_size ** 2
    renders = {"image": [], "patch": []}  # per render: CPU first, then card

    def render_spy(params, rays_o, *a, **kw):
        out = render_rays(params, rays_o, *a, **kw)
        renders["patch" if rays_o.shape[0] == n_reg else "image"].append(
            {k: out[0][k].detach().cpu()
             for k in ("z_vals", "rgb_map", "depth_map", "acc_map")})
        return out

    step = int(state["step"])
    with mock.patch.object(train_step_module, "render_rays", render_spy):
        cfg, metrics, _ = card_vs_cpu_step(torch, "rp2", flags, state,
                                           hold_loss=False)
    if step < cfg.reg_start_iter:
        raise AssertionError(f"[rp2] step {step} before the patches' gate")
    (img_cpu, img_card), (_, p_card) = renders["image"], renders["patch"]
    span = cfg.far - cfg.near

    def gap(k, pair):
        """|card - CPU| of output ``k`` of a render's ``(cpu, card)``."""
        cpu, card = pair
        return (card[k] - cpu[k]).abs()

    moved = {k: (gap("z_vals", renders[k]) > 1e-5 * cfg.far).any(-1)
             for k in renders}
    apart = {"image": moved["image"] | (gap("rgb_map", renders["image"])
                                        .amax(-1) > RP_MAP_ATOL),
             "patch": moved["patch"]
             | (gap("depth_map", renders["patch"]) > RP_MAP_ATOL * span)
             | (gap("acc_map", renders["patch"]) > RP_MAP_ATOL)}
    target = one_batch(args, torch.device("cpu"), seed=5)[1]["target"]
    kept = ~apart["image"]
    ray_loss = {k: ((r["rgb_map"][kept] - target[kept]) ** 2).mean(-1).sum()
                for k, r in (("cpu", img_cpu), ("card", img_card))}
    card = metrics["card"]["reg_depth_tv"]
    on_cpu = float(patch_depth_regularizer(
        p_card["depth_map"], p_card["acc_map"], cfg.reg_patch_size, cfg.near,
        cfg.far, cfg.reg_mode))
    errs = {"image loss": abs(float(ray_loss["card"] / ray_loss["cpu"]) - 1),
            "smoothness, same maps": abs(card / on_cpu - 1)}
    print(f"[rp2] the patch step at {step}, card against CPU: rays apart "
          f"(tol {RP_MAP_ATOL}), under a quarter: image "
          f"{int(apart['image'].sum())} of {len(kept)} ({int(moved['image'].sum())} "
          f"with samples moved a bin; colours up to "
          f"{float(gap('rgb_map', renders['image']).max()):.2e}), patch "
          f"{int(apart['patch'].sum())} of {n_reg} "
          f"({int(moved['patch'].sum())} moved; depth up to "
          f"{float(gap('depth_map', renders['patch']).max()) / span:.2e} of "
          f"far - near, acc {float(gap('acc_map', renders['patch']).max()):.2e}); "
          f"the image loss over the others {errs['image loss']:.2e} relative "
          f"(tol 1e-5); the smoothness of the card's maps {card:.8e}, the "
          f"CPU's op on them {on_cpu:.8e}, "
          f"{errs['smoothness, same maps']:.2e} relative (tol {RP_REG_RTOL}); "
          f"read as scalars: the image loss "
          f"{metrics['card']['img_loss'] / metrics['cpu']['img_loss'] - 1:.2e}, "
          f"the smoothness {card / metrics['cpu']['reg_depth_tv'] - 1:.2e}, "
          f"the loss {metrics['card']['loss'] / metrics['cpu']['loss'] - 1:.2e}")
    if (errs["image loss"] > 1e-5 or errs["smoothness, same maps"] > RP_REG_RTOL
            or any(int(m.sum()) * 4 >= len(m) for m in apart.values())):
        raise AssertionError(f"[rp2] card vs CPU {errs}, apart "
                             f"{[int(m.sum()) for m in apart.values()]}")
    for pair in encode_step_pairs(encode_steps(torch, flags, state,
                                               at_step=True)):
        hold_steps(torch, "rp2", *pair)


def phase_appearance(torch, workdir, prior) -> dict:
    """(ap1) the room of (sp1) with exposure gains U(1 - AP_JITTER,
    1 + AP_JITTER) on every view (the held-out views their own), trained
    through configs/norcliffe_common_room_tpu.txt as (sp1) with
    --use_appearance for AP_STEPS steps, a test set at AP_STEPS: the
    kernels launch, the loss falls; steps/s before and with the priors
    beside (sp1)'s, the held-out PSNR with the zero latent, and the
    latents' norms: non-zero on the training images' rows, zero on the
    others."""
    from indoor_nerf_tpu_torch.data.load import load_dataset
    from indoor_nerf_tpu_torch.data.scene_files import (
        make_room_blender_scene,
        write_blender_scene,
    )
    from indoor_nerf_tpu_torch.train.config import parse_args

    t0 = time.perf_counter()
    scene = make_room_blender_scene(ROOM_VIEWS, ROOM_SIZE, ROOM_SIZE,
                                    exposure_jitter=AP_JITTER,
                                    jitter_test=True)
    write_blender_scene(os.path.join(workdir, "room_jitter"), scene)
    train_ids, held = scene["i_split"][:2]
    gains = scene["exposure_gains"]
    print(f"[ap1] wrote the room with exposure gains in {time.perf_counter() - t0:.2f} s: "
          f"training views {np.round(gains[train_ids], 3).tolist()}, held out "
          f"{np.round(gains[held], 3).tolist()}")
    flags = ["--config", os.path.join(ROOT, "configs",
                                      "norcliffe_common_room_tpu.txt"),
             "--datadir", os.path.join(workdir, "room_jitter"), "--basedir",
             os.path.join(workdir, "ap1"), "--use_appearance",
             "--testskip", str(AP_TESTSKIP),
             "--structural_loss_start_iter", str(PRIOR_START),
             "--structural_loss_ramp_iters", str(PRIOR_RAMP)]
    out, _, training, testset = train_from_files(torch, "ap1", flags + [
        "--n_iters", str(AP_STEPS), "--i_testset", str(AP_STEPS),
        "--i_weights", str(AP_STEPS), "--i_print", str(PRIOR_PRINT)])
    before, after = step_rates(out, [(PRIOR_START // 3 + 1, PRIOR_START - 1),
                                     (PRIOR_START + 1, AP_STEPS - 1)])
    loaded = load_dataset(parse_args(flags))
    norms = torch.linalg.norm(out["state"]["params"]["appearance"].detach(),
                              dim=-1).cpu().numpy()
    others = np.setdiff1d(np.arange(len(norms)), loaded.i_train)
    print(f"[ap1] steps/s (median, 1024 rays) before the priors {before:.2f}, "
          f"with them {after:.2f}; (sp1)'s {prior['rates'][0]:.2f}, "
          f"{prior['rates'][1]:.2f}; held-out PSNR with the zero latent "
          f"{out['testsets'][-1]['psnr']:.3f} dB at step {AP_STEPS}; latent "
          f"norms of the {len(loaded.i_train)} training images "
          f"{np.round(norms[loaded.i_train], 4).tolist()}, of the other "
          f"{len(others)} rows at most {float(norms[others].max()):.1e}")
    if not (norms[loaded.i_train].min() > 0 and norms[others].max() == 0):
        raise AssertionError(f"[ap1] latent norms {norms}")
    return {"flags": flags, "state": out["state"], "training": training,
            "testset": testset["tent_contract"]}


def phase_fit(torch, ap) -> dict:
    """(ap2) --render_only --render_test --render_fit_appearance on (ap1)'s
    checkpoint through run_nerf: per held-out view the right-half PSNR
    with the zero and the fitted latent, the fit's ms (synchronized) and
    the launches of the fit and of the view's two full renders
    (tent_contract only: table_scatter must launch 0 times);
    fit_appearance.json with JAX's keys. Then one view's latent fitted on
    the card and on the CPU: within FIT_Z_RTOL in norm, the final MSE
    within FIT_MSE_RTOL; beside them the gradient of the fit's first step
    (at the zero latent) on both, in norm. Returns the fits' launches."""
    from indoor_nerf_tpu_torch import run_nerf
    from indoor_nerf_tpu_torch.bridge import state_from_numpy, state_to_numpy
    from indoor_nerf_tpu_torch.data.load import load_dataset
    from indoor_nerf_tpu_torch.models.field import params_device
    from indoor_nerf_tpu_torch.render import appearance
    from indoor_nerf_tpu_torch.train.config import parse_args
    from indoor_nerf_tpu_torch.train.trainer import build_train_config

    views = []
    real_fit, real_eval = (appearance.fit_view_latent,
                           appearance.eval_view_with_fitted_latent)

    def window(fn, *a, **kw):
        """fn's result, ms and launches."""
        torch.cuda.synchronize()
        before = launch_counts()
        t0 = time.perf_counter()
        res = fn(*a, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        after = launch_counts()
        return res, ms, {k: after[k] - before[k] for k in after}

    def fit(*a, **kw):
        res, ms, launches = window(real_fit, *a, **kw)
        views.append({"fit_ms": ms, "fit": launches})
        return res

    def evaluate(*a, **kw):
        res, ms, launches = window(real_eval, *a, **kw)
        views[-1].update(view_ms=ms, view=launches)
        return res

    reset_counts()
    with mock.patch.object(appearance, "fit_view_latent", fit), \
            mock.patch.object(appearance, "eval_view_with_fitted_latent",
                              evaluate):
        out, _ = quietly(run_nerf.main, ap["flags"] + [
            "--render_only", "--render_test", "--render_fit_appearance"])
    total = launch_counts()
    with open(os.path.join(out["savedir"], "fit_appearance.json")) as f:
        saved = json.load(f)
    for v, row in zip(views, saved["views"]):
        print(f"[ap2] held-out view: right-half PSNR zero "
              f"{row['psnr_right_zero']:.3f} -> fitted "
              f"{row['psnr_right_fitted']:.3f} dB (left-half MSE "
              f"{row['fit_mse_left']:.3e}); the fit {v['fit_ms']:.1f} ms, "
              f"tent_contract {v['fit']['tent_contract']}; with the two "
              f"renders {v['view_ms']:.1f} ms, tent_contract "
              f"{v['view']['tent_contract']}")
    fit_launches = {k: sum(v["view"][k] for v in views) for k in total}
    print(f"[ap2] fit_appearance.json: keys {sorted(saved)}, mean zero "
          f"{saved['mean_zero']:.3f}, fitted {saved['mean_fitted']:.3f} dB; "
          f"the fits' launches {fit_launches}; the run's {total} (the "
          f"render-only test set's "
          f"{total['tent_contract'] - fit_launches['tent_contract']})")
    if set(saved) != {"views", "mean_zero", "mean_fitted"} or \
            len(views) != len(saved["views"]) or not views:
        raise AssertionError(f"[ap2] {saved}")
    if any(n for k, n in total.items() if k != "tent_contract") or \
            any(v["fit"]["tent_contract"] <= 0 for v in views):
        raise AssertionError(f"[ap2] launches {total}")

    args = parse_args(ap["flags"])
    scene = load_dataset(args)
    cfg = build_train_config(args, scene)
    i = int(scene.i_test[0])
    fits = {}
    for label, state in (("card", ap["state"]), ("cpu", state_from_numpy(
            state_to_numpy(ap["state"]), "cpu"))):
        view = (state["params"], scene.poses[i], scene.K, scene.near,
                scene.far, scene.images[i], cfg.render, state["occ"])
        z0 = torch.zeros(cfg.render.field.input_ch_views,
                         device=params_device(state["params"]),
                         requires_grad=True)
        (g0,) = torch.autograd.grad(appearance.left_half_loss(*view)(z0),
                                    [z0])
        z, mse = appearance.fit_view_latent(*view)
        fits[label] = (z.cpu().numpy(), mse, g0.cpu().numpy())
    (zc, mc, gc), (zp, mp, gp) = fits["card"], fits["cpu"]
    z_err = float(np.linalg.norm(zc - zp) / np.linalg.norm(zp))
    g_err = float(np.linalg.norm(gc - gp) / np.linalg.norm(gp))
    mse_err = abs(mc / mp - 1)
    print(f"[ap2] view {i}'s latent fitted on the card and on the CPU: the "
          f"first step's gradient relative in norm {g_err:.2e}; |z| "
          f"{np.linalg.norm(zp):.4f}, relative in norm {z_err:.2e} (tol "
          f"{FIT_Z_RTOL}); final MSE {mc:.8e} vs {mp:.8e}, {mse_err:.2e} "
          f"(tol {FIT_MSE_RTOL})")
    if z_err > FIT_Z_RTOL or mse_err > FIT_MSE_RTOL:
        raise AssertionError(f"[ap2] card vs CPU fit: z {z_err}, mse {mse_err}")
    return fit_launches


def phase_appearance_serving(torch, ap, workdir) -> dict:
    """(ap3) (ap1)'s checkpoint served at REQUEST_SIZE through serve.build,
    online and --baked at BAKE_RES with --snapshot: the online request
    equal bit for bit to the same params without the appearance leaf
    rendered at the server's tile, the snapshot's tables within one bf16
    step (2^-7 of the largest entry) of a bake of those params, and its
    request against the online one in PSNR. Returns the requests'
    tent_contract launches."""
    from indoor_nerf_tpu_torch import serve
    from indoor_nerf_tpu_torch.data.load import load_dataset
    from indoor_nerf_tpu_torch.models.field import serving_params
    from indoor_nerf_tpu_torch.render.baked import bake_field, load_baked
    from indoor_nerf_tpu_torch.render.renderer import make_image_renderer
    from indoor_nerf_tpu_torch.train.config import parse_args
    from indoor_nerf_tpu_torch.train.trainer import build_train_config

    dev = torch.device("cuda:0")
    args = parse_args(ap["flags"])
    scene = load_dataset(args)
    rc = build_train_config(args, scene).render
    fc = rc.field
    state = ap["state"]
    params = {k: v for k, v in state["params"].items() if k != "appearance"}
    pose = scene.poses[scene.i_test[0]]
    W = H = REQUEST_SIZE
    focal = scene.hwf[2] * (W / scene.hwf[1])
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    (render, step, _), text = quietly(serve.build, argparse.Namespace(
        width=W, height=H, train_args=["--"] + ap["flags"]))
    tile = int(text.split("in tiles of ")[1].split()[0])
    reset_counts()
    ms, served = request_ms(torch, render, [pose])
    online = launch_counts()["tent_contract"]
    del render
    want = make_image_renderer(rc.test_mode(), H, W, tile)(
        serving_params(params, fc), pose, K, scene.near, scene.far,
        state["occ"])
    same = np.array_equal(served[0]["rgb_map"], want["rgb_map"].cpu().numpy())
    snap = os.path.join(workdir, "ap3.baked")
    (baked_render, _, _), _ = quietly(serve.build, argparse.Namespace(
        width=W, height=H, baked=True, baked_res=BAKE_RES, snapshot=snap,
        train_args=["--"] + ap["flags"]))
    reset_counts()
    baked_ms, baked = request_ms(torch, baked_render, [pose])
    baked_launches = launch_counts()["tent_contract"]
    del baked_render
    got = load_baked(snap, dev)
    ref = bake_field(serving_params(params, fc), fc, resolution=BAKE_RES,
                     train_cameras=serve.train_cameras(scene))
    errs = {k: float((got[k].float() - ref[k].float()).abs().max()
                     / ref[k].float().abs().max())
            for k in ("sigma_table", "voxel_geo")}
    quality = psnr(baked[0]["rgb_map"], served[0]["rgb_map"])
    print(f"[ap3] (ap1)'s field (step {step}) served at {W}x{H}: online "
          f"{', '.join(f'{v:.1f}' for v in ms)} ms (tent_contract launches "
          f"{online}), bit for bit the params without the appearance leaf: "
          f"{same}; --baked at {BAKE_RES}^3 {', '.join(f'{v:.1f}' for v in baked_ms)}"
          f" ms (tent_contract launches {baked_launches}), its tables against "
          f"a bake without the leaf, of the largest entry: {errs} (tol "
          f"{2.0 ** -7}); baked against online {quality:.2f} dB")
    if step != AP_STEPS or not same or max(errs.values()) > 2.0 ** -7:
        raise AssertionError(f"[ap3] step {step}, online equal {same}, "
                             f"baked {errs}")
    return {"serving_appearance": online,
            "baked_serving_appearance": baked_launches}


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def md_step_check(torch, flags, trained, batch_seed=5, draw_seed=3,
                  hold=True) -> list:
    """(md1)'s step check: one step of ``flags`` from ``trained``'s params
    through the sharded step at world size 1 (``make_sharded_train_step``
    over the process group md1 joined: the per-ray outputs gathered and the
    gradients summed over NCCL) and through ``train_step``, on one batch
    and one set of draws: the forward bit for bit (the loss and the grid
    equal), the update held as the kernel pairs sharing a forward are
    (``step_checks``). Returns ``step_checks``' list."""
    from indoor_nerf_tpu_torch.parallel.shard import (
        make_mesh,
        make_sharded_train_step,
    )

    cfg, one_step = step_from(torch, flags, trained, batch_seed, draw_seed)
    sharded = make_sharded_train_step(cfg, make_mesh())
    single = one_step(cfg)
    got = one_step(cfg, lambda st, b, d: sharded(st, b, draws=d))
    checks = step_checks(torch, got, single, True)
    same = (float(got[1]["loss"]) == float(single[1]["loss"])
            and bool(torch.equal(got[0]["occ"]["density"],
                                 single[0]["occ"]["density"])))
    checks.append(("forward bit for bit (0 = yes)", float(not same), 0.0))
    if hold:
        hold_steps(torch, "md1", "the sharded step at world size 1 vs "
                   "train_step, same forward", got, single, True)
        if not same:
            raise AssertionError("[md1] the sharded forward differs from "
                                 "train_step's")
    return checks


def phase_multihost(torch, workdir, plain) -> dict:
    """(md1) configs/lego_tpu.txt on (v)'s scene through run_nerf with
    --multihost at world size 1 over NCCL (--mesh_shape data:1) for
    MD_STEPS steps, a test set and a save at the end: the kernels launch,
    the loss falls, the [multihost] line names nccl; its steps and (v)'s in
    alternating windows (the collectives' cost at world size 1); one step
    against train_step (``md_step_check``). The process group stays for
    (md2)-(md3)."""
    t0 = time.perf_counter()
    flags = ["--config", os.path.join(ROOT, "configs", "lego_tpu.txt"),
             "--datadir", plain["scene_dir"], "--basedir",
             os.path.join(workdir, "md1"), "--lrate", "0.01", "--multihost",
             "--num_processes", "1", "--process_id", "0",
             "--coordinator_address", f"127.0.0.1:{free_port()}",
             "--mesh_shape", "data:1"]
    out, text, training, testset = train_from_files(torch, "md1", flags + [
        "--n_iters", str(MD_STEPS), "--i_testset", str(MD_STEPS),
        "--i_weights", str(MD_STEPS), "--i_video", str(10 * MD_STEPS)])
    line = [l for l in text.splitlines() if l.startswith("[multihost]")]
    if not line or "backend=nccl" not in line[0]:
        raise AssertionError(f"[md1] no NCCL process group: {line}")
    if not ckpt_files(out["logdir"]):
        raise AssertionError("[md1] no checkpoint written")
    print(f"[md1] {line[0]}; held-out PSNR at {MD_STEPS} "
          f"{out['testsets'][-1]['psnr']:.3f} dB")
    alternating_file_steps(torch, "md1", {"v": plain["flags"], "md1": flags})
    md_step_check(torch, flags, out["state"])
    print(f"[md1] seconds {time.perf_counter() - t0:.1f}")
    return {"flags": flags, "state": out["state"], "training": training,
            "testset": testset["tent_contract"]}


def phase_tp_local(torch) -> dict:
    """(md2) the model axis simulated in this process at the flagship's
    full width (8 levels x 4 features, 2^13 rows a level; 4096 rays x 32
    samples of points in the box, a random table and cotangent), for m = 2
    and 4 and the bf16 and int8 gathers: the m local encodes
    (``tp_block_encode_local``: tent_contract on each level block, then
    table_scatter into it), concatenated, equal ``block_hash_encode`` bit
    for bit; each block's gradient its rows of the single-device gradient
    within SCATTER_RTOL / SCATTER_ATOL, as (e); m launches of each kernel;
    the m local forward-and-backward passes timed against the one full
    pass. Returns each case's launches."""
    from indoor_nerf_tpu_torch.data.load import load_dataset
    from indoor_nerf_tpu_torch.ops.blockhash import block_hash_encode
    from indoor_nerf_tpu_torch.parallel.tp import tp_block_encode_local
    from indoor_nerf_tpu_torch.train.config import parse_args
    from indoor_nerf_tpu_torch.train.trainer import build_train_config

    t0 = time.perf_counter()
    dev = torch.device("cuda:0")
    args = parse_args(SERVE_FLAGS)
    bg0 = build_train_config(args, load_dataset(args)).render.field.block_grid
    gen = torch.Generator(device=dev).manual_seed(11)
    n = TRAIN_RAYS * 32
    lo = torch.tensor(bg0.bbox_min, device=dev)
    hi = torch.tensor(bg0.bbox_max, device=dev)
    x = lo + (hi - lo) * torch.rand((n, 3), generator=gen, device=dev)
    L, R, F = bg0.n_levels, bg0.rows_per_level, bg0.n_features_per_level
    table = 1e-2 * torch.randn((L * R, F * bg0.lanes_per_feature),
                               generator=gen, device=dev)
    g = torch.randn((n, L * F), generator=gen, device=dev)
    out = {}
    for dtype in ("bfloat16", "int8"):
        bg = dataclasses.replace(bg0, gather_dtype=dtype)

        def full_pass():
            t = table.clone().requires_grad_(True)
            f, _ = block_hash_encode(x, t, bg)
            return f, torch.autograd.grad(f, t, g)[0]

        f_full, g_full = full_pass()
        for m in (2, 4):
            rows, lp = L * R // m, L // m
            blocks = [table[j * rows:(j + 1) * rows].clone().requires_grad_(
                True) for j in range(m)]
            cots = [g[:, j * lp * F:(j + 1) * lp * F].contiguous()
                    for j in range(m)]

            def local_pass():
                fs, gs = [], []
                for j in range(m):
                    f, _ = tp_block_encode_local(x, blocks[j], j, m, bg)
                    fs.append(f)
                    gs.append(torch.autograd.grad(f, blocks[j], cots[j])[0])
                return fs, gs

            torch.cuda.synchronize()
            reset_counts()  # this case's m local encodes start here
            fs, gs = local_pass()
            launches = launch_counts()  # ... and end here
            equal = bool(torch.equal(torch.cat(fs, 1), f_full))
            scale = float(g_full.abs().max())
            errs = [float(((gj - g_full[j * rows:(j + 1) * rows]).abs()
                           - SCATTER_RTOL * g_full[j * rows:(j + 1) * rows]
                           .abs()).max() / scale) for j, gj in enumerate(gs)]
            local_ms = cuda_ms(torch, local_pass, 5)
            full_ms = cuda_ms(torch, full_pass, 5)
            print(f"[md2] {dtype} gather, model axis m={m} ({lp} levels, "
                  f"{rows} rows a block): the local encodes concatenated "
                  f"equal block_hash_encode bit for bit: {equal}; each "
                  f"block's gradient against its rows of the full one, "
                  f"largest |diff| - {SCATTER_RTOL} rel, of the largest "
                  f"entry: {max(errs):.3e} (tol {SCATTER_ATOL}); launches "
                  f"tent_contract {launches['tent_contract']}, table_scatter "
                  f"{launches['table_scatter']} (m each); forward + backward "
                  f"of the m local encodes {local_ms:.3f} ms, of the one "
                  f"full encode {full_ms:.3f} ms")
            if not equal or max(errs) > SCATTER_ATOL:
                raise AssertionError(f"[md2] {dtype} m={m}: features equal "
                                     f"{equal}, gradients {errs}")
            if launches["tent_contract"] != m or launches["table_scatter"] != m:
                raise AssertionError(f"[md2] {dtype} m={m} launches {launches}")
            out[f"tp_local_{dtype}_m{m}"] = launches
            del fs, gs, blocks
        del f_full, g_full
    torch.cuda.empty_cache()
    print(f"[md2] seconds {time.perf_counter() - t0:.1f}")
    return out


def phase_sharded_render(torch, md) -> dict:
    """(md3) the sharded renderer (parallel/sp.py) at world size 1 over
    NCCL (the image gathered through the process group md1 joined) at
    800x800 from (md1)'s field, against the online server's renderer
    (serving_params + make_image_renderer, as serve.build) on a held-out
    pose: rgb within 1e-5; tent_contract launches; both timed."""
    from indoor_nerf_tpu_torch.data.load import load_dataset
    from indoor_nerf_tpu_torch.models.field import serving_params
    from indoor_nerf_tpu_torch.parallel.shard import make_mesh
    from indoor_nerf_tpu_torch.parallel.sp import make_sharded_image_renderer
    from indoor_nerf_tpu_torch.render.renderer import make_image_renderer
    from indoor_nerf_tpu_torch.train.config import parse_args
    from indoor_nerf_tpu_torch.train.trainer import build_train_config

    t0 = time.perf_counter()
    args = parse_args(md["flags"])
    scene = load_dataset(args)
    rc = build_train_config(args, scene).render.test_mode()
    state = md["state"]
    H = W = REQUEST_SIZE
    focal = scene.hwf[2] * (W / scene.hwf[1])
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    pose = scene.poses[scene.i_test[0]]
    online = make_image_renderer(rc, H, W)
    params = serving_params(state["params"], rc.field)
    sharded = make_sharded_image_renderer(rc, H, W, make_mesh())

    def served():
        return online(params, pose, K, scene.near, scene.far, state["occ"])

    def mesh_render():
        return sharded(state["params"], pose, K, scene.near, scene.far,
                       occ_state=state["occ"])

    want = served()
    torch.cuda.synchronize()
    reset_counts()  # the sharded render's launches start here
    got = mesh_render()
    torch.cuda.synchronize()
    launches = launch_counts()  # ... and end here
    err = float((got["rgb_map"] - want["rgb_map"]).abs().max())
    ms = {}
    for label, fn in (("online", served), ("sharded", mesh_render)) * 2:
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.setdefault(label, []).append((time.perf_counter() - t) * 1e3)
    print(f"[md3] the sharded renderer at world size 1 over NCCL, "
          f"{H}x{W}: rgb max |diff| against the online server's render "
          f"{err:.3e} (tol 1e-5); tent_contract launches "
          f"{launches['tent_contract']}; ms online "
          f"{[round(v, 1) for v in ms['online']]}, sharded "
          f"{[round(v, 1) for v in ms['sharded']]}; seconds "
          f"{time.perf_counter() - t0:.1f}")
    if err > 1e-5 or launches["tent_contract"] <= 0:
        raise AssertionError(f"[md3] rgb {err}, launches {launches}")
    return launches


def _md4_rank(rank, rdv, job_path, out_path):
    """One of (md4)'s two processes on the card: joins the Gloo group and,
    on each of the job's meshes, takes its share of the global batch and
    one sharded step from the job's state; saves each mesh's loss, launches
    and gathered state."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    import indoor_nerf_tpu_torch  # noqa: F401  (sets the TF32 policy)
    from indoor_nerf_tpu_torch.bridge import state_from_numpy, state_to_numpy
    from indoor_nerf_tpu_torch.parallel.shard import (
        gather_state,
        make_mesh,
        make_sharded_train_step,
        shard_state,
    )

    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=2, rank=rank,
                            timeout=timedelta(seconds=120))
    try:
        job = torch.load(job_path, weights_only=False)
        dev = torch.device("cuda:0")
        out = {}
        for axes in job["meshes"]:
            mesh = make_mesh(axes, (2,))
            d, D = mesh.index("data"), mesh.size("data")
            batch = {k: torch.as_tensor(v[d * (len(v) // D):
                                          (d + 1) * (len(v) // D)]).to(dev)
                     for k, v in job["batch"].items()}
            state = shard_state(state_from_numpy(job["tree"], dev), mesh)
            step = make_sharded_train_step(job["cfg"], mesh)
            reset_counts()
            state, m = step(state, batch, draws={
                k: v.to(dev) for k, v in job["draws"].items()})
            torch.cuda.synchronize()
            out[axes[0]] = {"loss": float(m["loss"]),
                            "launches": launch_counts(),
                            "state": state_to_numpy(gather_state(state,
                                                                 mesh))}
        torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


def phase_two_processes(torch, md) -> dict:
    """(md4) two processes on the one card over Gloo (which takes the card's
    tensors for every collective the port calls): one step of (md1)'s
    configuration from its state, batch and draws on a data:2 mesh and on
    a model:2 mesh; the loss bit for bit the same on both ranks, and the
    step held against train_step's on the card as a kernel against its
    plain version (the forwards differ in f32 order: ``step_checks``)."""
    import multiprocessing

    from indoor_nerf_tpu_torch.bridge import state_from_numpy, state_to_numpy
    from indoor_nerf_tpu_torch.train.config import parse_args
    from indoor_nerf_tpu_torch.train.step import draw_step, train_step
    from indoor_nerf_tpu_torch.train.trainer import one_batch

    t0 = time.perf_counter()
    dev, cpu = torch.device("cuda:0"), torch.device("cpu")
    cfg, batch = one_batch(parse_args(md["flags"]), cpu, seed=5)
    tree = state_to_numpy(md["state"])
    draws = draw_step(torch.Generator(device=cpu).manual_seed(3), cfg,
                      int(tree["step"]), batch["rays_o"].shape[0])
    single = train_step(state_from_numpy(tree, dev),
                        {k: v.to(dev) for k, v in batch.items()}, cfg,
                        draws={k: v.to(dev) for k, v in draws.items()})
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        job = os.path.join(tmp, "job.pt")
        torch.save({"meshes": [("data",), ("model",)], "tree": tree,
                    "cfg": cfg, "draws": draws,
                    "batch": {k: v.numpy() for k, v in batch.items()}}, job)
        outs = [os.path.join(tmp, f"rank{r}.out") for r in (0, 1)]
        procs = [ctx.Process(target=_md4_rank,
                             args=(r, os.path.join(tmp, "rdv"), job, outs[r]))
                 for r in (0, 1)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=300)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if any(p.exitcode != 0 for p in procs):
            raise AssertionError(f"[md4] exit codes "
                                 f"{[p.exitcode for p in procs]}")
        ranks = [torch.load(o, weights_only=False) for o in outs]
    out = {}
    for axis in ("data", "model"):
        r0, r1 = ranks[0][axis], ranks[1][axis]
        same = r0["loss"] == r1["loss"]
        got = (state_from_numpy(r0["state"], dev),
               {"loss": torch.tensor(r0["loss"])})
        checks = step_checks(torch, got, single, False)
        print(f"[md4] {axis}:2, two processes on the card over Gloo: loss "
              f"{r0['loss']:.8f} and {r1['loss']:.8f} (the same on both "
              f"ranks: {same}), train_step's {float(single[1]['loss']):.8f}; "
              f"launches per rank "
              f"{[{k: v for k, v in r['launches'].items() if v} for r in (r0, r1)]}; "
              + "; ".join(f"{w} {e:.3e}" + (f" (tol {t:.3e})"
                                             if t is not None else "")
                          for w, e, t in checks))
        bad = [(w, e, t) for w, e, t in checks
               if t is not None and not e <= t]
        if not same or bad:
            raise AssertionError(f"[md4] {axis}:2: ranks' losses "
                                 f"{[r0['loss'], r1['loss']]}, {bad}")
        out[f"two_processes_{axis}"] = r0["launches"]
    print(f"[md4] seconds {time.perf_counter() - t0:.1f}")
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--step-spread", type=int, default=0, metavar="N",
        help="instead of the smoke run: the spread of every one-step "
             "comparison ((g), (k), (q), and card against CPU (y2), (sp2), "
             "(aq2), (rp2), (md1)) over N batches and draws")
    parser.add_argument(
        "--bake-spread", type=int, default=0, metavar="N",
        help="instead of the smoke run: the spread of (y5)'s baked against "
             "online PSNR over N trainings of (y1)'s configuration")
    spread = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); the port's kernels run only on the card",
              file=sys.stderr)
        return 1
    import indoor_nerf_tpu_torch  # noqa: F401  (sets the TF32 policy)

    torch.cuda.set_device(0)
    name = phase_device(torch)
    if spread.step_spread:
        step_spread(torch, spread.step_spread)
        return 0
    if spread.bake_spread:
        bake_spread(torch, spread.bake_spread)
        return 0
    phase_build()
    tent = phase_kernel(torch)
    serve_launches, serve_mlp = phase_serving(torch)
    phase_render_check(torch)
    scatter = phase_scatter(torch)
    radam = phase_fused_radam(torch)
    mlp = phase_nerf_small_fused(torch)
    trained, flat_launches = phase_training(
        torch, "f", SERVE_FLAGS, TRAIN_STEPS, ("tent_contract", "table_scatter"))
    phase_step_check(torch, "g", SERVE_FLAGS, trained["state"])
    grouped = phase_group_scatter(torch)
    trained, group_launches = phase_training(
        torch, "j", GROUP_FLAGS, TRAIN_STEPS, ("tent_contract", "group_scatter"))
    phase_step_check(torch, "k", GROUP_FLAGS, trained["state"])
    _, stride_launches = phase_training(
        torch, "l", STRIDE_FLAGS, STRIDED_STEPS, ("tent_contract", "table_scatter"))
    tile = phase_tile_interp(torch)
    lane = phase_lane_select(torch)
    trained, tile_launches = phase_training(
        torch, "p", TILE_FLAGS, TILE_STEPS,
        ("tile_interp_fwd", "tile_interp_bwd_rows"),
        forbid=("tent_contract", "table_scatter", "group_scatter"))
    phase_tile_step_check(torch, trained["state"])
    del trained
    phase_tile_render(torch)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as basedir:
        run_flags, state, scene = phase_checkpoint_serve(torch, basedir)
        bake_launches = phase_bake(torch, run_flags, state, scene)
        del state
        torch.cuda.empty_cache()
        baked_launches = phase_baked_requests(torch, run_flags, scene, basedir)
    torch.cuda.empty_cache()
    phase_precision(torch)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as workdir:
        files = phase_from_files(torch, workdir)
        ndc_launches = phase_ndc(torch, workdir)
        torch.cuda.empty_cache()
        parity = phase_parity_from_files(torch, workdir)
        phase_parity_step_check(torch, parity["flags"], parity["state"])
        parity_launches = parity["launches"]
        del parity["state"]
        torch.cuda.empty_cache()
        parity_launches.update(phase_parity_ndc(torch, workdir))
        parity_launches.update(phase_pe(torch, workdir))
        torch.cuda.empty_cache()
        parity_launches.update(phase_parity_serving(torch, parity["flags"],
                                                    workdir))
        torch.cuda.empty_cache()
        prior = phase_priors(torch, workdir)
        phase_priors_step(torch, prior["flags"], prior["state"])
        del prior["state"]
        torch.cuda.empty_cache()
        parity_launches.update(phase_parity_priors(torch, workdir))
        torch.cuda.empty_cache()
        ext = phase_extensions(torch, prior["flags"])
        torch.cuda.empty_cache()
        acaq = phase_acaq(torch, workdir, files)
        phase_acaq_step(torch, acaq["flags"], acaq["state"])
        acaq_serving = phase_acaq_serving(torch, acaq["flags"], acaq["state"],
                                          acaq["logdir"])
        del acaq["state"]
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        reg = phase_reg_patches(torch, workdir, files)
        phase_reg_step(torch, reg["flags"], reg["state"])
        del reg["state"]
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        app = phase_appearance(torch, workdir, prior)
        t2 = time.perf_counter()
        fit_launches = phase_fit(torch, app)
        t3 = time.perf_counter()
        app_serving = phase_appearance_serving(torch, app, workdir)
        del app["state"]
        print(f"[ap3] seconds: rp1-rp2 {t1 - t0:.1f}, ap1 {t2 - t1:.1f}, ap2 "
              f"{t3 - t2:.1f}, ap3 {time.perf_counter() - t3:.1f}")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        phase_nerfacto(torch, workdir)
        print(f"[nf3] seconds: nf1-nf3 {time.perf_counter() - t0:.1f}")
        torch.cuda.empty_cache()
        md = phase_multihost(torch, workdir, files)
        tp_local = phase_tp_local(torch)
        sharded_render = phase_sharded_render(torch, md)
        torch.distributed.destroy_process_group()
        two_processes = phase_two_processes(torch, md)
        del md["state"]
    torch.cuda.empty_cache()
    int8_launches, int8_pack_ms = phase_int8(torch)
    # "launches" is the count of the path of its slice that runs the
    # kernel (grouped training for tent_contract and group_scatter, strided
    # training for table_scatter, tile-interp training for the tile_interp
    # pair); "launches_by_path" gives every path that runs it its own count,
    # each read from its own reset-then-read window (200, 200, 100 and 100
    # training steps, 3 requests of 800x800, one 256^3 bake, one round of
    # baked requests; phase (v)'s 600 steps from files, its two test sets
    # and its render-only run, phase (w)'s 200 NDC steps; the parity
    # path's runs of (y1)-(y5), where no kernel launches but pass 1 of the
    # baked requests' tent_contract; A-CAQ's 700 steps from files (aq1),
    # its test sets and an 800x800 request of its field (aq4), the 200
    # int8 steps (aq3); the 300 steps with patches (rp1) and the 400 with
    # appearance latents (ap1), their test sets, the fits (ap2), the
    # latents' field served (ap3)). No path runs lane_select: its launches
    # are phase (o)'s.
    paths = {"training": flat_launches, "training_grouped": group_launches,
             "training_strided": stride_launches,
             "training_tile_interp": tile_launches,
             "training_from_files": files["training_from_files"],
             "training_ndc": ndc_launches,
             # The priors' paths (sp1, sp4) and the parity path (y1-y5,
             # sp3): every count read.
             "training_priors": prior["training"],
             "training_extensions": ext["training_extensions"],
             "training_acaq": acaq["training"],
             "training_int8": int8_launches,
             # The reg patches' and the appearance latents' (rp1, ap1) and
             # the half-image fits with their renders (ap2).
             "training_reg": reg["training"],
             "training_appearance": app["training"],
             "fit_appearance": fit_launches,
             # Multi-device (md1-md3): --multihost training at world size
             # 1, the m local encodes of the simulated model axis, the
             # sharded renderer's 800x800 image.
             "training_multihost": md["training"], **tp_local,
             "sharded_render": sharded_render, **two_processes,
             **parity_launches}

    def by_path(name):
        return {p: n[name] for p, n in paths.items()}

    csrc, pallas = "indoor_nerf_tpu_torch/csrc/", "indoor_nerf_tpu/ops/pallas/"
    print(f"[a] nvidia-smi at the end: {nvidia_smi()}")
    print(json.dumps({"kernels": [
        {"name": "tent_contract", "route": "cuda",
         "source": csrc + "tent_contract.cu",
         "replaces": pallas + "tent_contract.py:167",
         "launches": group_launches["tent_contract"],
         "int8_pack_ms": int8_pack_ms,
         "launches_by_path": {"serving": serve_launches,
                              **by_path("tent_contract"),
                              "testset": files["testset"]["tent_contract"],
                              "render_only": files["render_only"],
                              "bake": bake_launches,
                              "baked_serving": baked_launches,
                              "testset_priors": prior["testset"],
                              "serving_priors": ext["serving_priors"],
                              "baked_serving_priors":
                                  ext["baked_serving_priors"],
                              "testset_acaq": acaq["testset"],
                              "serving_acaq": acaq_serving,
                              "testset_reg": reg["testset"],
                              "testset_appearance": app["testset"],
                              "testset_multihost": md["testset"],
                              **app_serving},
         **tent},
        {"name": "table_scatter", "route": "cuda",
         "source": csrc + "table_scatter.cu",
         "replaces": pallas + "table_scatter.py:399",
         "launches": stride_launches["table_scatter"],
         "launches_by_path": by_path("table_scatter"),
         **scatter},
        {"name": "group_scatter", "route": "cuda",
         "source": csrc + "group_scatter.cu",
         "replaces": pallas + "table_scatter.py:494",
         "launches": group_launches["group_scatter"],
         "launches_by_path": by_path("group_scatter"),
         **grouped},
        {"name": "tile_interp_fwd", "route": "cuda",
         "source": csrc + "tile_interp.cu",
         "replaces": pallas + "tile_interp.py:94",
         "launches": tile_launches["tile_interp_fwd"],
         "launches_by_path": by_path("tile_interp_fwd"),
         **tile["tile_interp_fwd"]},
        {"name": "tile_interp_bwd_rows", "route": "cuda",
         "source": csrc + "tile_interp.cu",
         "replaces": pallas + "tile_interp.py:116",
         "launches": tile_launches["tile_interp_bwd_rows"],
         "launches_by_path": by_path("tile_interp_bwd_rows"),
         **tile["tile_interp_bwd_rows"]},
        {"name": "lane_select_fwd", "route": "cuda",
         "source": csrc + "lane_gather.cu",
         "replaces": pallas + "lane_gather.py:54",
         "launches_by_path": by_path("lane_select_fwd"),
         **lane["lane_select_fwd"]},
        {"name": "lane_select_grad", "route": "cuda",
         "source": csrc + "lane_gather.cu",
         "replaces": pallas + "lane_gather.py:88",
         "launches_by_path": by_path("lane_select_grad"),
         **lane["lane_select_grad"]},
        {"name": "fused_radam", "route": "cuda",
         "source": csrc + "fused_radam.cu", "replaces": None,
         "launches": RADAM_BY_PATH["f"], "launches_by_path": RADAM_BY_PATH,
         **radam},
        {"name": "nerf_small_fused", "route": "cuda",
         "source": csrc + "nerf_small_fused.cu", "replaces": None,
         "launches": serve_mlp,
         "launches_by_path": {"serving (a request)": serve_mlp}, **mlp},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
