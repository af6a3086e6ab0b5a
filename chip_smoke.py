#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # all phases but the profile (6)
    python3 chip_smoke.py --phases 1,10   # build + the list backends and absolute algos
    python3 chip_smoke.py --phases 1,11   # build + the guarded main path (health guard)
    python3 chip_smoke.py --phases 1,12   # build + the ensemble (4 members x 1M particles)
    python3 chip_smoke.py --phases 1,13   # build + SPH serving and the CLI at 1M particles
    python3 chip_smoke.py --phases 1,9    # build + llama3.2-3b served (K6, K7)
    python3 chip_smoke.py --phases 1,14   # build + the other model families served
    python3 chip_smoke.py --phases 1,15   # build + llama3.2-3b trained (K7, K7b)
    python3 chip_smoke.py --phases 1,15 --parent build/parent  # K7b beside an earlier tree's
    python3 chip_smoke.py --phases 1,16   # build + remat at 4096-token rows, the dry run
    python3 chip_smoke.py --phases 1,17   # build + sharding on one card (a (1, 1) mesh)
    python3 chip_smoke.py --phases 1,9 --parent build/parent  # K7 beside an earlier tree's
    python3 chip_smoke.py --phases 1,3,8 --parent build/parent  # K1, K3, K4, K5 beside it
    python3 chip_smoke.py --phases 1,8 --parent build/parent    # K3, K4 and K5 beside it
    python3 chip_smoke.py --phases 1,8    # build + the 1M-particle NNPS path
    python3 chip_smoke.py --phases 1,2    # build + kernel checks only
    python3 chip_smoke.py --phases 6      # the profile

Phases (each prints its own lines and raises on failure):
  1. device and build: ``nvidia-smi`` name and power limit, torch/CUDA
     versions, the nvcc build of ``src/repro_torch/csrc`` and its ptxas
     register/spill lines;
  2. every kernel against its plain PyTorch version on the card, on
     random Verlet-advanced clouds (2-D ~65k and 3-D ~30k particles, some
     with every 97th particle massless):
     K1 (cell pack) bit for bit in both slab layouts, K2 (fused force)
     by ``rcll_force.check_against_plain`` (each element within
     ``rounding_bound``, each output within ``NORMWISE_LIMIT`` over
     occupied slots) for the linear EOS + Morris and the Tait EOS +
     artificial viscosity + delta-SPH schemes, fp16 and fp32 records;
     then K4 (neighbor lists) and K5 (adjacency) bit for bit and K3
     (fused A5 gradient) by ``sph_gradient.check_against_plain``, on
     random clouds binned by ``bin_by_cell_id``, for fp16/bf16/fp32
     storage, fp32 and fp16 compute, periodic and not, and on occupancy
     masks with holes anywhere in a row (K4 at K = 3, counts past K, and
     at cap 37 with K = 50, not a multiple of 4); then K6 (RCLL-KV
     decode) at int8/fp16/bf16 residuals and K7 (flash prefill) at
     bf16/fp32, causal and not, by their ``check_against_plain``
     (``flash_attention.rounding_bound`` and ``NORMWISE_LIMIT``), on
     random inputs with ragged lengths and the model's strided views
     (K7's bf16 kernel at Dh 16-128, lengths off its tiles, Lq > Lk with
     its keyless rows exactly 0, Lq < Lk, rep 1, 3 and 8, and a view TMA
     cannot address);
  3. the main path at full size: ``Simulation.from_case("taylor_green",
     ds=1/1024)`` (N = 1,048,576, fp16 records) through ``run_timed``
     with observables every 10 steps; launch counts are zeroed just
     before and read just after; then K1 and K2 are timed on the main
     path's own inputs beside their plain versions and their bounds (K1
     also in a CUDA graph, with the bandwidth it reaches, and beside the
     design of ``--parent`` when given);
  4. the stale-binning path: the skinned, dropped-column dam break at
     ~250k particles, long enough for >= 2 in-run rebuilds between which
     K2 consumes non-zero cell shifts;
  5. a small taylor_green (ds = 1/64, 20 steps) through the kernels and
     through the plain versions, both on the card, with fp32 and with fp16
     records, at the CPU slice test's tolerances (see the phase);
  6. (only when asked: ``--phases 6``) where a main-path step's time
     goes: host-timed decision / rebuild / physics split with a
     synchronize after each, and a ``torch.profiler`` window with device
     time by kernel and the device's busy share;
  7. planted faults: in K2 (the Morris term dropped, the EOS constant 1%
     off, the last occupied slot of each neighbor tile skipped), the K2
     check at the main path's inputs, phase 2 and phase 5 must each fail
     on each; in K4 alone and in K5
     alone (r_cell^2 1% larger, the self pair kept), in K4 (padding 0 for
     -1, counts saturated at K) and in K3 (the sign of f_j - f_i
     flipped, one cell edge 1% longer, the walk one occupied slot short
     of each neighbor row, a row's first empty slot taken as its end),
     phase 2's NNPS checks and phase 8's checks must each fail on each
     (but phase 8 for the last, whose tables are prefix-occupied); in K6 (the length mask one
     block short, the int8 divisor 127 -> 128, the merge of the key splits
     skipping the last one) and in K7 (the causal mask
     one column late; P rounded to bf16 once, its hi part alone),
     phase 2's K6/K7 checks, phase 9's checks at
     captured inputs, phase 9's request check (over the prefill and 8
     decode steps) and its logit gates alone must each fail on each;
     then phase 10's path, monkeypatched in this script: ``fused._pair_rhs``
     without its dv (Morris) channel and ``nnps.rcll_neighbors_windows``
     dropping each row's last valid slot; each phase-10 gate that runs the
     faulted function on one side of its comparison must fail
     (``P10_BLIND_TO`` names the others and why);
  8. the NNPS path at the paper's 1M scale: ``gradient_test_particles(
     ds=1/1024)`` (N = 1,048,576) through ``rcll.init_state``,
     ``cells.bin_by_cell_id`` and ``ops.rcll_neighbor_lists`` (K4),
     ``ops.rcll_adjacency_cells`` (K5) and ``ops.rcll_gradient_particles``
     (K3); launch counts zeroed just before and read just after; zero
     binning overflow, K4 at most 48 neighbors and equal to
     ``nnps.rcll_neighbors``, K5's counts equal to K4's, the gradient of
     x^3 within the interior RMS gate; each kernel held against its plain
     version (K4 also at K = 8, its counts past K) and timed beside it
     and its bound, in a CUDA graph, with the bandwidth it reaches, and
     beside the design of ``--parent`` when given (K4 also beside
     ``fill_(-1)`` of its output bytes and K5 beside ``zero_``, each
     with 16-byte streaming stores required in its SASS); the paper's Table 2
     wrong-determination counts against the fp64 truth (readings);
  9. the LM serving path: ``ServeRun("llama3.2-3b", smoke=False, batch 4,
     prompt 1024, gen 160)`` at full width and depth with random weights
     from seed 0, anchored (RCLL-KV) and dense; launch counts zeroed just
     before and read just after each (K7 28 a prefill, K6 28 a decode
     step); ``cache_bytes`` equal to the count from the shapes; K6 and K7
     at the anchored run's captured inputs against their plain versions,
     timed beside them, their bounds and (K7) ``scaled_dot_product_attention``
     (K6 also with its grid, and on inputs cold in L2; K7 also beside its
     previous yardstick, the design of ``--parent`` when given, and the
     HGMMA count of its bf16 kernel's SASS);
     the whole anchored request against the plain path, teacher-forced:
     every logit finite and within ``transformer.logit_tolerance``, the
     logits within ``LOGIT_NORMWISE_LIMIT`` normwise, and every K6 and K7
     launch within its rounding bound of its plain version;
 10. the solver's other backends and algos, no kernel of their own: at N =
     1,048,576 (taylor_green, ds = 1/1024) ``backend="reference"``,
     ``"xla"`` and ``"kernel"`` from one state with fp32 records, xla and
     kernel held to reference (``p10_backends_gate``), K1/K2 launched 0
     times by the list backends and once a step by the kernel; xla with
     fp16 records against fp32 records; steps/s of ``run_timed(50,
     observe_every=10)``, peak device memory, the auto window and K of each
     backend; the skinned dam break (~260k) on xla against kernel; approach
     I (``algo="cell"``, fp32) against rcll on the kernel backend at the
     Table 5 gate; ``algo="all"`` (fp32) against rcll on the reference
     backend at ds = 1/256 (N = 65,536: the all-list search is O(N^2));
 11. the guarded main path: taylor_green at N = 1,048,576 (fp16 records,
     kernel backend) through ``recovery.run_guarded`` in blocks of 10
     steps, each gate raising on failure: (a) the clean run equals the
     unguarded one bit for bit, no events, K1/K2 launched once a step, a
     checkpoint saved every block; (b) a NaN velocity at step 15 is
     disarmed and the replay equals (a) bit for bit (also on a Verlet-
     skinned variant, whose in-place steps between rebuilds are where an
     aliased snapshot shows), K1/K2 launched for the replayed block; (c)
     a teleport at step 15 trips rho_dev under a limit set from (a)'s own
     rho_err and recovers finite; (d) capacity 2 trips cell_overflow at
     step 0, one regrow, equal to a fresh run under the regrown config;
     (e) phase 4's dam break with dt x 8 halves dt and ends finite; (f) a
     strict policy raises at step 10; (g) (a)'s newest checkpoint
     restores equal to (a), and with it truncated the step before it
     finishes equal to (a); (h) readings: steps/s guarded and unguarded,
     one host snapshot's bytes and ms, one restore's ms, peak memory.
     Then three faults planted by monkeypatching the guard: the snapshot
     aliasing the live carry -> (b), check_carry's NaN bits masked ->
     (b) and (f), a regrow keeping the old capacity -> (d);
 12. the ensemble: 4 members of phase 11's skinned taylor_green at N =
     1,048,576 each (4,194,304 particles; fp16 records, kernel backend;
     member 0 the case's own, members 1-3 with seeded velocity
     perturbations) through ``ensemble.run_ensemble`` in blocks of 10, 40
     steps, each gate raising on failure: (a) every member healthy and
     bit-equal to its solo ``run_persistent`` under ``member_config``, K1
     and K2 launched once a batched step (40, not 160), the folded launch
     held against the plain versions; (b) a NaN velocity at step 15 on
     member 2 alone: member 2 recovered by one disarm, the others with no
     events, all four bit-equal to their clean solo runs, launches equal
     to the batched steps, the replayed block included; (c) a persistent
     fault (no disarm, one dt halving, no record degrade): member 1
     quarantined with a ``SimulationDiverged``, the others bit-equal; (d)
     a ``LaneEngine`` of 3 slots takes requests of 20, 40, 40 and 20 steps
     (the fourth when the first is done) in blocks of 8, each done state
     bit-equal to its solo run; (e) a run checkpointing every block stops
     after 20 steps, its newest checkpoint torn, and the resume finishes
     bit-equal to (a); (f) readings: member-steps/s of the batch against
     the members one after another through ``run_timed``, the busy share
     of a batched block, one batch snapshot's bytes and ms, peak memory.
     Then three faults planted by monkeypatching: the folded neighbor ids
     not shifted by lane -> (a), the lane select passing a frozen lane's
     stepped row -> (d), the rollback splicing another lane's snapshot
     row -> (b);
 13. SPH serving and the scenario CLI: taylor_green at N = 1,048,576 (fp16
     records, kernel backend, blocks of 10) over real sockets on
     127.0.0.1, each gate raising on failure: (a) an in-process
     ``SimServer`` (4 slots) takes three healthy requests of 20, 30 and 40
     steps and one poisoned (NaN velocity at step 3) from four concurrent
     clients: each DONE's ``state_npz`` has the JAX server's keys and
     dtypes and is bit-equal to its solo ``run_guarded`` under
     ``member_config``, the poisoned one DIVERGED (nan_v, halve_dt,
     quarantine last), K1 and K2 launched once a batched step of the
     bucket (its blocks x 10) and the run's folded K1/K2 launch held
     against their plain versions, every frame under ``MAX_FRAME``; (b) a
     server with a checkpoint directory drains a 40-step request after two
     blocks (RETRY_AFTER, a token, step 20) and a new server resumes the
     token (ACCEPTED resumed) to a DONE bit-equal to the
     uninterrupted run; (c) ``python -m repro_torch.sph serve --chaos kill``
     as a subprocess with engine workers on the card: a 60-step request
     whose worker is SIGKILLed after two blocks and a sibling bucket (N =
     65,536, 40 steps) sent after the kill, both DONE bit-equal to their
     solo runs, a recovering event and every block's OBS for the first,
     neither for the second, worker_restarts >= 1, recovery_s > 0, SIGTERM
     exit 0; (d) ``python -m repro_torch.sph run ... --n 1048576 --time
     --json`` exits 0 with the JAX document's schema and keys, backend
     "kernel", and ``list --names`` prints JAX's four cases; (e) readings:
     ms to ACCEPTED, first OBS and DONE per request, served member-steps/s
     against ``run_ensemble``, the state_npz bytes and encode/decode ms,
     the workers' per-block lane-checkpoint ms and spawn to first progress,
     recovery_s, peak memory, the CLI's steps/s, and where (a)'s wall
     went (the engine thread's case build, admissions, blocks, encode,
     json.dumps and sendall; the clients' frame reads and parse). Then
     three faults planted by monkeypatching: ``serve.encode_state``
     widening fp16 leaves to fp32 -> (a), ``SimServer._dispatch``
     answering the neighboring lane's event -> (a), ``_admit_resume``
     admitting the checkpointed row as if at step 0 -> (b);
 14. the other model families served at full width through ``ServeRun``
     (weights from seed 0, drawn in bf16; launch counts zeroed just
     before and read just after each request, gated against the family's
     K6/K7 launches): (a) ``deepseek-moe-16b`` at full depth (16.88e9
     parameters; B 4, prompt 1024, 160 tokens, greedy) anchored and dense
     (K7 28 a prefill, K6 28 an anchored decode step), ``cache_bytes``
     equal to the count from the shapes, peak memory under the card's,
     the MoE drop fraction; K6 and K7 at the anchored run's captured
     inputs and at each new shape against their plain versions; the
     prefill's and first decode step's logits within
     ``transformer.logit_tolerance`` of the plain path; a second anchored
     run's tokens, and two runs' logits, bit-equal; (b) granite-3-8b,
     internlm2-20b, stablelm-1.6b, pixtral-12b, mamba2-130m, zamba2-1.2b,
     whisper-large-v3 (prompt 256) and deepseek-v2-236b (4 of its 60
     layers) one after another, each freed before the next is drawn: B 4,
     prompt 1024, 32 tokens, both KV modes where the family has two;
     every new K6/K7 shape (rep 1 and 6, Dh 64, whisper's non-causal
     encoder and cross-attention at Lk 1500) against its plain version
     and the first decode logits against the plain path; (c) planted
     faults: K7's ``causal_plus_one`` -> whisper's decoder shape, each
     K6 fault -> internlm2's rep-6 shape, the MoE combine's order
     shuffled a call -> (a)'s bit-equality;
 15. LM training: ``TrainRun("llama3.2-3b", smoke=False, batch 2, seq 1024,
     6 AdamW steps)`` at full width and depth (3.21e9 fp32 master
     parameters from seed 0, the data pipeline's tokens, the config's
     ``remat="full"``), each gate raising on failure: (a) every K7b call
     of the main path's first step (28, recorded to the host) against the
     plain backward on its saved (recomputed) inputs
     (``flash_attention.check_bwd_against_plain``: each of dq, dk,
     dv within ``rounding_bound_bwd`` and ``BWD_NORMWISE_LIMIT``); (b) at 2
     layers (full width) one step's gradients through K7 and K7b against
     the same step through their plain versions on the card, every leaf
     within ``P15_GRAD_TOL_ULPS`` normwise, every layer's wq / wk / wv
     gradient nonzero, two kernel-path steps bit-equal, a step with
     ``remat="none"`` bit-equal to one with ``"full"`` (the peak memory of
     each printed), every K7b call held as in (a); (c) the full-depth run:
     launch counts zeroed just before and read just after (K7 56 a step:
     28 in the forward, 28 in the recompute; K7b 28), losses and grad
     norms finite, the first loss within ``P15_FIRST_LOSS_SLACK`` of
     ln(vocab) plus the z-loss; (d) ``tests/test_integration.py``'s resume
     test on the card at SMOKE size (mamba2-130m, as there, and
     llama3.2-3b): 24 steps uninterrupted against 12 with a checkpoint and
     a resume, bit for bit;
     readings: ms a step by part (forward, backward, optimizer), tokens/s,
     peak memory (B cut to 1 on an out-of-memory, and said so), K7b timed
     at the last layer's recorded inputs beside its plain version, its
     bound (``k7b_work``), the backward of
     ``scaled_dot_product_attention`` and the design of ``--parent`` when
     given, and the HGMMA count of each bf16 K7b kernel's SASS by Dh;
     (e) planted faults: K7b's ``gqa_first_head``, ``causal_plus_one``,
     ``d_from_do`` and ``ds_hi_only`` -> (a) at the depth cut, K7
     launched without its autograd op (no gradient to wq, wk, wv) -> (b);
 16. remat and the dry run on one card: (a) ``TrainRun("llama3.2-3b")`` at
     full width and depth on ``train_4k``'s 4096-token rows, B 2 (cut to
     1 on an out-of-memory, and said so), 4 AdamW steps with the config's
     remat: losses finite, K7 2 x 28 a step and K7b 28 (counts zeroed just
     before and read just after); ms a step by part, tokens/s, peak
     memory; last, one step of B 1 x 4096 without remat, as a reading
     (whether it fits); (b) ``python -m repro_torch.launch.dryrun`` on
     meta (no card, the host's CPU): ``--all --smoke`` (mesh "1"), every
     record ok; and, started with the script, ``--all --both --smoke``
     on JAX's 16x16 and 2x16x16 meshes (fake process groups of 256 and
     512 ranks): exit 0, 64 records ok with n_chips 256 and 512, every
     train record with a collective, no process group left; then
     llama3.2-3b's ``train_4k`` and ``decode_32k`` at full size on both
     (per-device FLOPs, bytes, collective bytes, seconds, labelled CPU);
     (c) the dry run's cells at ad hoc ``ShapeSpec``s held against the
     card: the FLOPs counted (``kernels.cost.CostCounter``) over one real
     train step at B 2 x 1024 and over phase 9's prefill (B 4 x 1024) equal
     the dry run's on meta exactly, their K7 / K7b calls and FLOPs equal
     this script's pair count (``k7_work``) x 4 Dh / 10 Dh, the decode
     cells' cache bytes at phase 9's B 4 and max length equal the card
     prefill's ``cache_bytes`` in both KV modes, the train cell's
     argument bytes equal the parameters', moments', step's and batch's on
     the card, and the measured steps (this phase's, phase 15's) are no
     less than the dry run's roofline bound; readings: step over bound,
     ``temp_size_in_bytes`` beside the peak less the argument bytes;
     (d) planted faults: a remat that keeps the config's "full" but skips
     the recompute -> (a)'s launch gate, K7's count without the causal
     half and K7b's count left out -> (c)'s FLOP gate;
 17. sharding on one card: (a) ``TrainRun("llama3.2-3b",
     mesh_shape=(1, 1))`` at phase 15 (c)'s settings (full width and
     depth, B 2 x 1024, remat "full", 6 steps; a one-rank NCCL group, the
     masters, moments and batch replicated DTensors, K7 and K7b on each
     rank's local shards), then the same run without a mesh: losses, final
     parameters and both moments bit-equal; K7 336 and K7b 168 launches
     on the mesh run (counts zeroed just before and read just after);
     readings: ms a step by part and the host's step for both, their peak
     memory, DTensor's host cost (the difference); (b) K7 and K7b on each
     model rank's head shard of (2, 24, 1024, 128) bf16 causal, 8 kv heads
     (``attention.check_head_shards``), at model degrees 2, 4, 8 (whole kv
     groups) and 3, 16 (groups cut: a call per piece of a rank's heads
     inside a group): outputs and dQ bit-equal
     to the whole call, dK and dV bit-equal with whole groups, else within
     K7b's rounding bound and one bf16 rounding of each rank's part, one
     launch each per shard call; (c) planted
     faults: the kv heads one group off in the local-shard helper -> (b),
     the mesh path's attention through the plain versions on its CUDA
     shards -> (a)'s launch gate; (d) the dry run of (a)'s train cell (B
     2 x 1024) on a fake (1, 1) mesh (after (a)'s NCCL group is released)
     counts the FLOPs ``CostCounter`` read over (a)'s first (1, 1) step on
     the card and the dry run without a mesh, K7 56 and K7b 28 on both
     sides, and no collective; plant: the clip norm all-reduced on one
     device -> (d). K7's and K7b's rows of the kernel table add (a)'s
     mesh launches.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Without CUDA (or without the package
beside this script) it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_OPS_PER_S = 67e12  # fp32 outside the tensor cores, H100 SXM
H100_BF16_TENSOR_OPS_PER_S = 989e12  # bf16 on the tensor cores, dense, H100 SXM


def log(msg: str = "") -> None:
    print(msg, flush=True)


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------
#: (module, wrapper name, key in the capture store) of every kernel.
WRAPPERS = (
    ("cell_pack", "cell_tables", "k1"), ("rcll_force", "rcll_force", "k2"),
    ("sph_gradient", "rcll_gradient", "k3"),
    ("nnps_pairwise", "rcll_neighbor_list_tables", "k4"),
    ("nnps_pairwise", "rcll_adjacency", "k5"),
    ("rcll_kv_attention", "rcll_kv_decode", "k6"),
    ("flash_attention", "flash_attention", "k7"),
    ("flash_attention", "flash_attention_bwd", "k7b"),
)


def _kernel_modules() -> dict:
    from repro_torch.kernels import (cell_pack, flash_attention, nnps_pairwise, rcll_force,
                                     rcll_kv_attention, sph_gradient)

    return {"cell_pack": cell_pack, "rcll_force": rcll_force,
            "sph_gradient": sph_gradient, "nnps_pairwise": nnps_pairwise,
            "rcll_kv_attention": rcll_kv_attention, "flash_attention": flash_attention}


def wrapper(key: str):
    """The kernel wrapper (and its launch counter) of K1..K7 and K7b."""
    mod, name, _ = next(w for w in WRAPPERS if w[2] == key)
    return getattr(_kernel_modules()[mod], name)


def _map_tensors(x, fn):
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, (tuple, list)):
        return type(x)(_map_tensors(v, fn) for v in x)
    if isinstance(x, dict):
        return {k: _map_tensors(v, fn) for k, v in x.items()}
    return x


@contextlib.contextmanager
def capture_kernel_inputs(store: dict, first_on_host: bool = False):
    """Record the arguments of the next wrapper calls of each kernel (the
    calls still go through the original wrappers and their counters): the
    last call's, or with ``first_on_host`` a host copy of the first call's
    (which later steps cannot overwrite)."""
    saved = []
    for mod_name, name, key in WRAPPERS:
        mod = _kernel_modules()[mod_name]
        orig = getattr(mod, name)

        def cap(*args, _orig=orig, _key=key, **kw):
            if not first_on_host:
                store[_key] = (args, kw)
            elif _key not in store:
                store[_key] = _map_tensors((args, kw), lambda t: t.to("cpu", copy=True))
            return _orig(*args, **kw)

        saved.append((mod, name, orig))
        setattr(mod, name, cap)
    try:
        yield store
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)


@contextlib.contextmanager
def plain_versions():
    """Route the force pass through the plain versions (on the card)."""
    from repro_torch.kernels import cell_pack, rcll_force

    k1, k2 = cell_pack.cell_tables, rcll_force.rcll_force
    cell_pack.cell_tables = cell_pack.cell_tables_ref
    rcll_force.rcll_force = rcll_force.rcll_force_ref
    try:
        yield
    finally:
        cell_pack.cell_tables, rcll_force.rcll_force = k1, k2


@contextlib.contextmanager
def plain_lm_versions():
    """Route the LM path's attention through K6's and K7's plain versions."""
    from repro_torch.kernels import flash_attention as k7
    from repro_torch.kernels import rcll_kv_attention as k6

    saved = k6.rcll_kv_decode, k7.flash_attention
    k6.rcll_kv_decode, k7.flash_attention = k6.rcll_kv_decode_ref, k7.flash_attention_ref
    try:
        yield
    finally:
        k6.rcll_kv_decode, k7.flash_attention = saved


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def time_ms_graph(fn, reps: int = 50) -> float:
    """Device time per call: ``reps`` calls captured in one CUDA graph and
    replayed between CUDA events, so no host time sits between the
    launches (a short kernel's wrapper can take longer than the kernel)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    for _ in range(2):  # the first replays find the graph's memory fresh
        graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(3):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (3 * reps)


def store_yardstick(nbytes: int, reps: int = 50, fill: int | None = None) -> str:
    """A clause giving the time of ``torch.Tensor.zero_`` on ``nbytes``, or
    of ``fill_(fill)`` on them as int32 (the card's store rate for a
    kernel's output bytes, reads aside), in a CUDA graph; a yardstick
    beside the bound, not a library call of the function."""
    if fill is None:
        buf = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
        ms, what = time_ms_graph(buf.zero_, reps), "zero_"
    else:
        buf = torch.empty(nbytes // 4, dtype=torch.int32, device="cuda")
        ms, what = time_ms_graph(lambda: buf.fill_(fill), reps), f"fill_({fill})"
    del buf
    return (f"; {what} of the {nbytes} output bytes {ms:.4f} ms "
            f"({nbytes / ms / 1e9:.3f} TB/s)")


def k1_out_bytes(args, kw) -> int:
    """Bytes of K1's three tables."""
    rows16, rows32, starts = args[:3]
    return (starts.shape[0] + 1) * kw["cap"] * (2 * rows16.shape[1] + 4 * rows32.shape[1] + 4)


def k1_bytes(args, kw) -> int:
    rows16, rows32, starts, counts, fill32 = args
    n, f16 = rows16.shape
    f32 = rows32.shape[1]
    c = starts.shape[0]
    read = n * (2 * f16 + 4 * f32) + 8 * c + 4 * f32
    return read + k1_out_bytes(args, kw)


def k2_ops_per_pair(dim: int, scheme) -> int:
    """fp32 operations of one pair in the kernel's loop (a division or a
    square root counts as one; compares and selects are not counted)."""
    ops = (6 * dim - 1) + 11 + 3 * dim + 2 + 2  # decode, B-spline, dv, pressure, coef
    if scheme.has_av_term:
        ops += 10
    if scheme.has_dv_term:
        ops += 6
    ops += dim * (2 + (2 if scheme.has_dv_term else 0))
    ops += 3 + (10 if scheme.has_delta_term else 0)
    return ops


def k2_work(args, kw):
    """(occupied pairs, pairs inside the support, operations, bytes) of one
    K2 call on these inputs. Pairs of occupied slots in non-sentinel
    neighbor cells need the Eq. (7) decode and the support test; only those
    inside the support (r < 2h, where dW != 0) need the pair terms."""
    rel, shift, v, m, inv_rho, nb_ids = args
    c1, d, cap = rel.shape
    occ = kw["counts"].to(torch.int64)  # the binning's, clamped to cap; sentinel 0
    pairs = int((occ[:, None] * occ[nb_ids.long()]).sum())
    inside = k2_support_pairs(args, kw)
    decode = 6 * kw["dim"]  # (6d - 1) decode operations and the test
    ops = inside * k2_ops_per_pair(kw["dim"], kw["scheme"]) + (pairs - inside) * decode
    nbytes = (c1 * (d * cap * (rel.element_size() + 2 + v.element_size())
                    + cap * (m.element_size() + 4) + 4)
              + nb_ids.numel() * 4 + c1 * cap * (1 + d) * 4)
    return pairs, inside, ops, nbytes


def k2_support_pairs(args, kw, chunk: int = 16384) -> int:
    """Pairs of occupied slots whose distance is below 2h (the B-spline's
    support), by the plain version's decode."""
    from repro_torch.core import cells
    from repro_torch.kernels import rcll_force, tiling

    rel, shift, v, m, inv_rho, nb_ids = args
    occ = rcll_force.occupied_slots(m, kw["counts"])
    offs = cells.neighbor_cell_offsets(kw["dim"])
    support2 = (2.0 * kw["h"]) ** 2
    inside = 0
    for c0 in range(0, rel.shape[0], chunk):
        sl = slice(c0, c0 + chunk)
        for k in range(nb_ids.shape[1]):
            nbk = nb_ids[sl, k].long()
            _, r2 = tiling.tile_phys_disp_shifted(rel[sl], rel[nbk], shift[sl], shift[nbk],
                                                   offs[k], kw["hc_phys"])
            both = occ[sl][:, :, None] & occ[nbk][:, None, :]
            inside += int(((r2 < support2) & both).sum())
    return inside


def k2_visited_pairs(args, kw) -> int:
    """Pairs whose distance the kernel decodes on these inputs: each
    occupied slot and one representative empty slot per row that has one,
    against the occupied slots of its neighbor cells (csrc/rcll_force.cu)."""
    rel, shift, v, m, inv_rho, nb_ids = args
    cap = rel.shape[2]
    occ = kw["counts"].to(torch.int64)
    work = occ + (occ < cap).to(torch.int64)
    return int((work * occ[nb_ids.long()].sum(dim=1)).sum())


def _occupied_pairs(occ: torch.Tensor, nb_ids: torch.Tensor) -> int:
    """Pairs of occupied slots in each cell's 3^d neighborhood (the pairs
    whose distance K3, K4 and K5 must decide on these inputs)."""
    n_occ = (occ > 0).sum(dim=1).to(torch.int64)
    return int((n_occ[:, None] * n_occ[nb_ids.long()]).sum())


def nnps_decision_ops(dim: int) -> int:
    """Operations of one Eq. (7) decision: per axis subtract, halve,
    subtract the offset, weight, square, add; then the compare."""
    return 6 * dim + 1


def k4_work(args, kw):
    """(pairs decided, operations, bytes) of one K4 call on these inputs."""
    rel, occ, ids, nb_ids = args
    c1, d, cap = rel.shape
    pairs = _occupied_pairs(occ, nb_ids)
    nbytes = (rel.numel() * rel.element_size() + occ.numel() * 4 + ids.numel() * 4
              + nb_ids.numel() * 4 + k4_out_bytes(args, kw))
    return pairs, pairs * nnps_decision_ops(d), nbytes


def k4_out_bytes(args, kw) -> int:
    """Bytes of K4's lists and counts."""
    rel = args[0]
    c1, _, cap = rel.shape
    return c1 * cap * kw["k_slots"] * 4 + c1 * cap * 4


def k5_out_bytes(args) -> int:
    """Bytes of K5's adjacency and counts."""
    rel, occ, nb_ids = args
    c1, d, cap = rel.shape
    return c1 * nb_ids.shape[1] * cap * cap * 4 + c1 * cap * 4


def k5_work(args, kw):
    """(pairs decided, operations, bytes) of one K5 call on these inputs."""
    rel, occ, nb_ids = args
    pairs = _occupied_pairs(occ, nb_ids)
    nbytes = (rel.numel() * rel.element_size() + occ.numel() * 4 + nb_ids.numel() * 4
              + k5_out_bytes(args))
    return pairs, pairs * nnps_decision_ops(rel.shape[1]), nbytes


def k3_work(args, kw, neighbors: int):
    """(pairs decided, operations, bytes) of one K3 call: every occupied
    pair is decided, and each of the ``neighbors`` accepted pairs costs
    the physics tier (decode 6d - 1, sqrt, B-spline ~10, f_j - f_i 2,
    per axis gradient, numerator and denominator 6)."""
    rel, f, occ, nb_ids = args
    c1, d, cap = rel.shape
    pairs = _occupied_pairs(occ, nb_ids)
    ops = pairs * nnps_decision_ops(d) + neighbors * ((6 * d - 1) + 1 + 10 + 2 + 6 * d)
    nbytes = (rel.numel() * rel.element_size() + (f.numel() + occ.numel()) * 4
              + nb_ids.numel() * 4 + 2 * c1 * d * cap * 4)
    return pairs, ops, nbytes


def bound(nbytes: float, ops: float, bf16_tensor_ops: float = 0.0) -> tuple[float, str]:
    """The least time (ms) of a function that moves ``nbytes`` and does
    ``ops`` fp32 operations and ``bf16_tensor_ops`` operations that the
    bf16 tensor cores can do exactly, and what bounds it."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = (ops / H100_FP32_OPS_PER_S + bf16_tensor_ops / H100_BF16_TENSOR_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_k1(args, kw) -> None:
    from repro_torch.kernels import cell_pack

    cell_pack.check_against_plain(args, kw)
    torch.cuda.synchronize()


def k2_summary(c: dict) -> str:
    from repro_torch.kernels import rcll_force

    return (f"K2 max|err| {c['max_abs_err']:.3e} (occupied slots), max err/bound "
            f"{c['max_ratio']:.3e} (bound: 4(3^d cap + 16) 2^-24 sum|parts|), normwise "
            f"{c['normwise']:.3e} (limit {rcll_force.NORMWISE_LIMIT:g})")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------
def phase1_build() -> dict:
    from repro_torch.kernels import _build

    log(gpu_line())  # the card's name and power limit, as nvidia-smi gives them
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib = _build.library()
    log(f"[1] kernel library {lib.path.name}: nvcc build {lib.build_seconds:.1f} s "
        f"(load {time.perf_counter() - t0:.1f} s total)")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[1] ptxas {line.strip()}")
    return {"build_s": lib.build_seconds}


def _cloud_inputs(dim, n, scheme_kw, records, seed, massless=False,
                  dev=torch.device("cuda")):
    """K1/K2 inputs from ops.rcll_force_particles on a random cloud whose
    positions were Verlet-advanced (so some cell shifts are non-zero);
    ``massless`` zeroes every 97th particle's mass (massless particles
    are occupied slots wherever they sit in a row)."""
    from repro_torch.core import cells, rcll
    from repro_torch.core import scheme as scheme_lib
    from repro_torch.core.domain import Domain
    from repro_torch.kernels import ops

    rng = np.random.default_rng(seed)
    ds = (1.0 / n) ** (1.0 / dim)
    dom = Domain(lo=(0.0,) * dim, hi=(1.0,) * dim, h=1.2 * ds, cell_factor=1.5,
                 periodic=(True,) + (False,) * (dim - 1))
    x = torch.as_tensor(rng.uniform(0, 1, (n, dim)).astype(np.float32), device=dev)
    cap = cells.robust_capacity(dom, ds, n) + 8
    ps = rcll.pack_state(dom, rcll.init_state(dom, dom.normalize(x)), cap)
    skin_norm = 2.0 * 0.5 * dom.radius / dom.h_d
    step = torch.as_tensor(rng.uniform(-1, 1, (n, dim)).astype(np.float32), device=dev)
    rc = rcll.advance(dom, ps.rc, step * (0.2 * skin_norm))
    shifted = int((rc.cell_xy != ps.rc.cell_xy).any(dim=1).sum())
    v = torch.as_tensor((0.3 * rng.normal(size=(n, dim))).astype(np.float32), device=dev)
    rho = torch.as_tensor((1.0 + 0.01 * rng.normal(size=n)).astype(np.float32), device=dev)
    m = torch.full((n,), ds**dim, device=dev)
    if massless:
        m[::97] = 0.0
    store: dict = {}
    rdt = {"fp16": torch.float16, "fp32": torch.float32}[records]
    with capture_kernel_inputs(store):
        ops.rcll_force_particles(dom, ps.packing.binning, rc, v, m, rho,
                                 scheme=scheme_lib.Scheme(**scheme_kw), records_dtype=rdt)
    return store, shifted, int(ps.packing.binning.overflow)


def phase2_kernels() -> None:
    from repro_torch.kernels import rcll_force

    wcsph = dict(c0=10.0, rho0=1.0, mu=0.05)
    dam = dict(c0=10.0 * math.sqrt(2.0), rho0=1.0, eos="tait", gamma=7.0,
               viscosity="none", alpha=0.1, delta=0.1)
    cases = [
        (2, 65536, wcsph, "fp16", False), (2, 65536, wcsph, "fp32", False),
        (2, 65536, dam, "fp16", False), (2, 65536, dam, "fp32", False),
        (3, 32768, wcsph, "fp16", False), (3, 32768, dam, "fp32", False),
        (2, 65536, wcsph, "fp16", True), (3, 32768, dam, "fp32", True),
    ]
    for i, (dim, n, sch, rec, massless) in enumerate(cases):
        store, shifted, overflow = _cloud_inputs(dim, n, sch, rec, seed=100 + i,
                                                 massless=massless)
        if overflow:
            raise AssertionError(f"test cloud overflowed its cell capacity ({overflow})")
        if shifted == 0:
            raise AssertionError("test cloud has no migrated particles")
        check_k1(*store["k1"])
        c2 = rcll_force.check_against_plain(*store["k2"])
        eos = sch.get("eos", "linear")
        f16, f32 = store["k1"][0][0].shape[1], store["k1"][0][1].shape[1]
        log(f"[2] dim {dim} N {n} eos {eos} records {rec} massless "
            f"{'1 in 97' if massless else 'none'}: K1 bit-identical "
            f"(F16 {f16}, F32 {f32}); {k2_summary(c2)}; "
            f"{shifted} particles with non-zero shift")
    phase2_nnps()
    phase2_lm()


STORAGE = {"fp16": torch.float16, "bf16": torch.bfloat16, "fp32": torch.float32}


def _nnps_cloud_inputs(dim, n, storage, periodic, seed, dev=torch.device("cuda")):
    """K3/K4/K5 inputs from the ops entry points on a random cloud binned
    by ``bin_by_cell_id``; returns the capture store and the overflow."""
    from repro_torch.core import cells, rcll
    from repro_torch.core.domain import Domain
    from repro_torch.kernels import ops

    rng = np.random.default_rng(seed)
    ds = (1.0 / n) ** (1.0 / dim)
    dom = Domain(lo=(0.0,) * dim, hi=(1.0,) * dim, h=1.2 * ds,
                 periodic=(periodic,) + (False,) * (dim - 1))
    x = torch.as_tensor(rng.uniform(0, 1, (n, dim)).astype(np.float32), device=dev)
    st = rcll.init_state(dom, dom.normalize(x), STORAGE[storage])
    b = cells.bin_by_cell_id(dom, dom.flat_cell_id(st.cell_xy), st.cell_xy,
                             cells.default_capacity(dom, n))
    f = x[:, 0] ** 3 + 0.01 * torch.as_tensor(rng.normal(size=n).astype(np.float32), device=dev)
    store: dict = {}
    with capture_kernel_inputs(store):
        ops.rcll_neighbor_lists(dom, b, st.rel, k=64, nnps_dtype=STORAGE[storage])
        ops.rcll_adjacency_cells(dom, b, st.rel)
        ops.rcll_gradient_particles(dom, b, st.rel, f)
    return store, int(b.overflow)


def _holes_nnps_inputs(dim, cap, storage, seed, dev=torch.device("cuda")):
    """K3/K4/K5 tables on a small grid of cells (as the card tests'
    ``_edge_nnps_tiles`` builds them): random coordinates in each cell, a
    random {0,1} occupancy with holes anywhere in a row (the binning packs
    a prefix, so phase 8 cannot show a prefix assumption), distinct ids in
    the occupied slots, a random f; the sentinel row is empty. Returns
    the tables and the keyword arguments the kernels share."""
    from repro_torch.core import nnps
    from repro_torch.core.domain import Domain
    from repro_torch.kernels import ops

    rng = np.random.default_rng(seed)
    dom = Domain(lo=(0.0,) * dim, hi=(1.0,) * dim, h=0.07 if dim == 2 else 0.11,
                 periodic=(True,) + (False,) * (dim - 1))
    c1 = dom.ncells_total + 1
    rel = torch.as_tensor(rng.uniform(-1, 1, (c1, dim, cap)).astype(np.float32)).to(
        STORAGE[storage])
    occ = torch.as_tensor((rng.random((c1, cap)) < 0.45).astype(np.float32))
    occ[-1] = 0.0
    ids = torch.as_tensor(rng.permutation(c1 * cap).astype(np.int32).reshape(c1, cap))
    ids[occ == 0] = -1
    f = torch.as_tensor(rng.normal(size=(c1, cap)).astype(np.float32))
    t = {k: v.to(dev) for k, v in dict(rel=rel, f=f, occ=occ, ids=ids).items()}
    t["nb_ids"] = ops.nb_with_sentinel(dom, dev)
    kw = dict(weights=tuple(dom.cell_weights), r_cell=nnps.rcll_radius_cell_units(dom))
    return t, kw, dict(kw, hc_phys=tuple(dom.cell_sizes), h=dom.h, dim=dim)


#: Phase 2's masks with holes: (dim, cap, storage, compute, K4's K). K = 3
#: puts counts past K; K = 50, not a multiple of 4, takes K4's stores of
#: single ids, at cap 37 (two words of occupancy a row).
HOLES_CASES = ((2, 20, "fp16", torch.float16, 3), (2, 37, "bf16", torch.float32, 50),
               (3, 20, "fp32", torch.float32, 3))


def phase2_nnps() -> None:
    """K4 and K5 bit for bit and K3 within its bound, on random clouds and
    on masks with holes."""
    from repro_torch.kernels import nnps_pairwise, sph_gradient

    cases = [
        (2, 65536, "fp16", torch.float32, False), (2, 65536, "fp16", torch.float16, True),
        (2, 65536, "bf16", torch.float32, True), (2, 65536, "fp32", torch.float16, False),
        (3, 32768, "fp16", torch.float16, True), (3, 32768, "fp32", torch.float32, False),
    ]
    for i, (dim, n, storage, compute, periodic) in enumerate(cases):
        store, overflow = _nnps_cloud_inputs(dim, n, storage, periodic, seed=200 + i)
        if overflow:
            raise AssertionError(f"test cloud overflowed its cell capacity ({overflow})")
        a4, kw4 = store["k4"]
        a5, kw5 = store["k5"]
        a3, kw3 = store["k3"]
        kw4, kw5, kw3 = (dict(kw4, compute_dtype=compute), dict(kw5, compute_dtype=compute),
                         dict(kw3, nnps_dtype=compute))
        c4 = nnps_pairwise.check_against_plain("K4", a4, kw4)
        c5 = nnps_pairwise.check_against_plain("K5", a5, kw5)
        c3 = sph_gradient.check_against_plain(a3, kw3)
        log(f"[2] NNPS dim {dim} N {n} storage {storage} compute "
            f"{str(compute).split('.')[-1]} periodic {periodic}: K4 bit-identical "
            f"({c4['hits']} hits, K = 64), K5 bit-identical ({c5['hits']} hits); "
            f"{k3_summary(c3)}")
    for i, (dim, cap, storage, compute, k) in enumerate(HOLES_CASES):
        t, kw, kw3 = _holes_nnps_inputs(dim, cap, storage, seed=300 + i)
        a4 = (t["rel"], t["occ"], t["ids"], t["nb_ids"])
        c4 = nnps_pairwise.check_against_plain("K4", a4, dict(kw, k_slots=k,
                                                              compute_dtype=compute))
        c5 = nnps_pairwise.check_against_plain("K5", (t["rel"], t["occ"], t["nb_ids"]),
                                               dict(kw, compute_dtype=compute))
        c3 = sph_gradient.check_against_plain((t["rel"], t["f"], t["occ"], t["nb_ids"]),
                                              dict(kw3, nnps_dtype=compute))
        log(f"[2] NNPS mask with holes dim {dim} cap {cap} cells {t['occ'].shape[0]} "
            f"occupied {int((t['occ'] > 0).sum())} storage {storage} compute "
            f"{str(compute).split('.')[-1]}: K4 bit-identical ({c4['hits']} hits, K = {k}, "
            f"{c4['past_k']} counts past K), K5 bit-identical ({c5['hits']} hits); "
            f"{k3_summary(c3)}")


def k3_summary(c: dict) -> str:
    from repro_torch.kernels import sph_gradient

    return (f"K3 max|err| {c['max_abs_err']:.3e} (occupied slots), max err/bound "
            f"{c['max_ratio']:.3e}, normwise {c['normwise']:.3e} "
            f"(limit {sph_gradient.NORMWISE_LIMIT:g})")


def phase3_main_path(results: dict, parent: Path | None = None) -> None:
    from repro_torch.core import solver
    from repro_torch.core.api import Simulation
    from repro_torch.kernels import cell_pack, rcll_force

    K1, K2 = cell_pack.cell_tables, rcll_force.rcll_force
    nsteps = 50
    sim = Simulation.from_case("taylor_green", ds=1.0 / 1024)
    n = sim.n_particles
    cfg = sim.cfg
    log(f"[3] taylor_green ds=1/1024: N {n}, cells {cfg.domain.ncells}, "
        f"cap {cfg.cap(n)}, records {cfg.policy.records}, dt {cfg.dt:.3e}")
    torch.cuda.reset_peak_memory_stats()
    K1.launches = 0
    K2.launches = 0
    res, steps_per_s = sim.run_timed(nsteps, observe_every=10)
    torch.cuda.synchronize()
    l1, l2 = K1.launches, K2.launches
    driven = 2 * res.stats.steps  # run_timed: a warm-up run, then the timed run
    log(f"[3] steps/s {steps_per_s:.3f} (timed run of {res.stats.steps} steps; "
        f"{driven} steps driven incl. warm-up)")
    log(f"[3] launches: K1 {l1}, K2 {l2} (steps driven {driven}); "
        f"rebuilds in timed run {res.stats.rebuilds}; overflow {res.stats.overflow}")
    if l1 != driven or l2 != driven:
        raise AssertionError("K1/K2 launch counts differ from the step count")
    peak = torch.cuda.max_memory_allocated()
    log(f"[3] max_memory_allocated {peak} bytes ({peak / 2**30:.2f} GiB)")
    st = res.state
    fields = {"rel": st.rc.rel, "v": st.fluid.v, "rho": st.fluid.rho, "m": st.fluid.m}
    finite = {k: bool(torch.isfinite(t).all()) for k, t in fields.items()}
    log(f"[3] finite: {finite}")
    if not all(finite.values()) or res.stats.overflow:
        raise AssertionError("main path produced non-finite fields or overflowed")
    ke = res.observables.ekin.cpu().numpy().astype(float)
    log(f"[3] KE trajectory {ke.tolist()} at t {res.observables.t.cpu().numpy().tolist()}")
    if not np.all(np.diff(ke) < 0):
        raise AssertionError("taylor_green kinetic energy did not decrease monotonically")
    results["steps_per_s"] = steps_per_s
    results["launches"] = {"cell_tables": l1, "rcll_force": l2}

    # The main path's own K1/K2 inputs (one more step, outside the count).
    store: dict = {}
    carry = solver.init_persistent(cfg, sim.state)
    with capture_kernel_inputs(store):
        solver.step_persistent(cfg, carry)
    a1, kw1 = store["k1"]
    a2, kw2 = store["k2"]
    check_k1(a1, kw1)
    c2 = rcll_force.check_against_plain(a2, kw2)
    ms1 = time_ms_graph(lambda: K1(*a1, **kw1))
    eager1 = time_ms(lambda: K1(*a1, **kw1), reps=20)
    plain1 = time_ms(lambda: cell_pack.cell_tables_ref(*a1, **kw1), reps=10)
    ms2 = time_ms(lambda: K2(*a2, **kw2), reps=10)
    plain2 = time_ms(lambda: rcll_force.rcll_force_ref(*a2, **kw2), reps=3, warmup=1)
    b1, by1 = bound(k1_bytes(a1, kw1), 0.0)
    pairs, inside, ops2, bytes2 = k2_work(a2, kw2)
    b2, by2 = bound(bytes2, ops2)
    log(f"[3] K1 at main-path shapes rows16 {tuple(a1[0].shape)} rows32 "
        f"{tuple(a1[1].shape)} cap {kw1['cap']}: {ms1:.4f} ms a launch in a CUDA graph "
        f"({eager1:.4f} ms launched one by one from Python, the wrapper included; plain "
        f"{plain1:.4f} ms), bound {b1:.4f} ms by {by1} ({k1_bytes(a1, kw1)} bytes; "
        f"{k1_bytes(a1, kw1) / ms1 / 1e9:.3f} TB/s reached of 3.35), bit-identical"
        + store_yardstick(k1_out_bytes(a1, kw1))
        + wide_stores("cell_tables_kernel", "STG.E.128") + parent_times(parent, "k1", a1, kw1, ms1))
    log(f"[3] K2 at main-path shapes rel {tuple(a2[0].shape)}: {ms2:.4f} ms "
        f"(plain {plain2:.4f} ms), bound {b2:.4f} ms by {by2} ({pairs} occupied pairs, "
        f"{inside} inside the support, {k2_visited_pairs(a2, kw2)} visited by the kernel; "
        f"{ops2:.4g} ops, {bytes2} bytes); "
        f"{k2_summary(c2)}, in the kernel's "
        f"mass-normalized units (m_scale {float(carry.m_scale):.6g})")
    results["kernels"] = [
        {"name": "cell_tables", "route": "cuda",
         "source": "src/repro_torch/csrc/cell_pack.cu",
         "replaces": "src/repro/kernels/cell_pack.py:82",
         "launches": l1, "max_abs_err": 0.0, "ms": ms1, "plain_ms": plain1,
         "bound_ms": b1, "bound_by": by1, "library_ms": None},
        {"name": "rcll_force", "route": "cuda",
         "source": "src/repro_torch/csrc/rcll_force.cu",
         "replaces": "src/repro/kernels/rcll_force.py:166",
         "launches": l2, "max_abs_err": c2["max_abs_err"], "ms": ms2, "plain_ms": plain2,
         "bound_ms": b2, "bound_by": by2, "library_ms": None},
    ]


def phase4_stale_binning() -> None:
    from repro_torch.core import cases, solver
    from repro_torch.kernels import cell_pack, rcll_force

    K1, K2 = cell_pack.cell_tables, rcll_force.rcll_force
    ds = cases.resolve_ds("dam_break", 250_000)
    radius = 2.0 * cases.build_case("dam_break", ds=ds).h
    case = cases.build_case("dam_break", ds=ds, cell_factor=1.5,
                            skin=0.25 * radius, v0=1.0)
    cfg, st = case.build()
    n = st.xn.shape[0]
    log(f"[4] dam_break ds {ds:.5f}: N {n}, cells {cfg.domain.ncells}, cap {cfg.cap(n)}, "
        f"skin {cfg.skin:.3e}, dt {cfg.dt:.3e}")
    K1.launches = 0
    K2.launches = 0
    t0 = time.perf_counter()
    carry = solver.init_persistent(cfg, st)
    steps, max_shifted, segments = 0, 0, 0
    while steps < 400 and (carry.rebuilds < 3 or segments < 2):
        carry = solver.run_persistent(cfg, carry, 10)
        steps += 10
        shifted = int((carry.st.rc.cell_xy != carry.binning.cell_xy).any(dim=1).sum())
        max_shifted = max(max_shifted, shifted)
        segments += 1
    out = solver.finalize_persistent(cfg, carry)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    in_run = carry.rebuilds - 1  # the first rebuild is init_persistent's pack
    finite = all(bool(torch.isfinite(t).all())
                 for t in (out.rc.rel, out.fluid.v, out.fluid.rho))
    log(f"[4] {steps} steps in {wall:.2f} s; rebuilds {carry.rebuilds} "
        f"({in_run} in-run); K1 launches {K1.launches}, K2 launches {K2.launches}; "
        f"max particles with non-zero shift seen by K2 {max_shifted}; "
        f"overflow {bool(carry.overflow)}; finite {finite}")
    if in_run < 2 or max_shifted == 0:
        raise AssertionError("stale-binning path did not rebuild twice with live shifts")
    if K1.launches != steps or K2.launches != steps or not finite or bool(carry.overflow):
        raise AssertionError("dam_break: launch counts, finiteness or overflow check failed")


#: Phase 5's velocity limit with fp16 records, from readings on an H100
#: (PERF.md): at most 3.6e-5 over a 20-step run; a 1% error in K2's EOS
#: constant gives 3.5e-4 and a dropped Morris term 3.6e-2.
FP16_RECORDS_DV_LIMIT = 1e-4


def phase5_kernel_vs_plain_path() -> None:
    """The kernel path against the plain path, both on the card, at the
    tolerances of tests/test_torch_solver.py (the CPU slice test).

    fp32 records: positions, density and velocity at that test's
    fp32-records tolerances, on the final state as there. fp16 records
    (the default): positions and density at its fp16-records tolerances.
    Its velocity tolerance does not carry over: a velocity difference far
    below one fp16 quantum can flip the rounding of a stored velocity
    record, which moves the neighbors' viscous sums by ~3e-5 in one step;
    the maximum over the steps is held to ``FP16_RECORDS_DV_LIMIT``
    instead.
    """
    from repro_torch.core import cases, solver
    from repro_torch.core.precision import FP32_RECORDS, PrecisionPolicy

    nsteps = 20
    for policy in (FP32_RECORDS, PrecisionPolicy()):
        cfg, st = cases.build_case("taylor_green", ds=1.0 / 64, policy=policy).build()
        if policy.records == "fp32":
            tol = {"pos": 1e-6, "rho": 1e-6, "v": nsteps * cfg.dt * 1e-4}
        else:
            quantum = max(cfg.domain.cell_sizes) / 2 * 2.0**-10  # one fp16 rel step
            tol = {"pos": 1e-6 + quantum, "rho": 1e-6, "v": FP16_RECORDS_DV_LIMIT}
        ck = solver.init_persistent(cfg, st)
        with plain_versions():
            cp = solver.init_persistent(cfg, st)
        worst = dict.fromkeys(tol, 0.0)  # max over the steps
        for _ in range(nsteps):
            ck = solver.step_persistent(cfg, ck)
            with plain_versions():
                cp = solver.step_persistent(cfg, cp)
            sk, sp = solver.finalize_persistent(cfg, ck), solver.finalize_persistent(cfg, cp)
            final = {
                "pos": solver.positions(cfg, sk) - solver.positions(cfg, sp),
                "rho": sk.fluid.rho - sp.fluid.rho,
                "v": sk.fluid.v - sp.fluid.v,
            }
            final = {k: float(d.abs().max()) for k, d in final.items()}
            worst = {k: max(worst[k], final[k]) for k in final}
        # The CPU test's tolerances hold for the final state, as there; the
        # fp16 velocity limit was set from the maximum over the steps.
        held = dict(final, v=final["v"] if policy.records == "fp32" else worst["v"])
        log(f"[5] taylor_green ds=1/64 N {st.xn.shape[0]} records {policy.records}, "
            f"{nsteps} steps, kernel vs plain: " + ", ".join(
                f"|d{k}| final {final[k]:.3e}, max over the steps {worst[k]:.3e}"
                for k in final) + "; held: " + ", ".join(
                f"{k} {held[k]:.3e} <= {tol[k]:.3e}" for k in held)
            + f"; rebuilds {ck.rebuilds}/{cp.rebuilds}")
        if any(held[k] > tol[k] for k in held) or ck.rebuilds != cp.rebuilds:
            raise AssertionError(f"kernel path and plain path disagree ({policy.records} records)")


def phase7_planted_faults() -> None:
    """Plant faults in K1 (:func:`k1_planted_faults`) and in K2 through
    their run-time parameters (the sources are untouched); in K2 the
    Morris term dropped, the EOS constant 1% off, and the last occupied
    slot of every neighbor tile skipped. The K2 check at the main path's
    inputs (phase 3's), phase 2 and phase 5 must each fail on each fault;
    then the NNPS and LM kernels' faults."""
    from repro_torch.core import solver
    from repro_torch.core.api import Simulation
    from repro_torch.kernels import rcll_force

    sim = Simulation.from_case("taylor_green", ds=1.0 / 1024)
    sim.run(50)
    store: dict = {}
    with capture_kernel_inputs(store):
        solver.step_persistent(sim.cfg, solver.init_persistent(sim.cfg, sim.state))
    missed = k1_planted_faults(store)
    params = rcll_force.kernel_params
    checks = (("main-path K2 check", lambda: rcll_force.check_against_plain(*store["k2"])),
              ("phase 2", phase2_kernels), ("phase 5", phase5_kernel_vs_plain_path))
    for fault in rcll_force.FAULTS:
        for name, check in checks:
            rcll_force.kernel_params = rcll_force.planted_params(fault)
            try:
                check()
                missed.append((fault, name))
                log(f"[7] {fault}: {name} PASSED: the fault was not caught")
            except AssertionError as e:
                log(f"[7] {fault}: {name} failed, as it must: {e}")
            finally:
                rcll_force.kernel_params = params
    missed += nnps_planted_faults()
    missed += lm_planted_faults()
    missed += phase10_planted_faults()
    if missed:
        raise AssertionError(f"planted faults not caught: {missed}")


def k1_planted_faults(store: dict) -> list:
    """Faults planted in K1 through its run-time ``fault`` argument (the
    last occupied slot of each cell left empty; empty fp32 slots filled
    with 0): the K1 check at the main path's inputs (``store``) and phase
    2 must each fail on each. Returns the (fault, check) pairs that passed."""
    from repro_torch.kernels import cell_pack

    checks = (("main-path K1 check", lambda: check_k1(*store["k1"])), ("phase 2", phase2_kernels))
    missed = []
    for fault in cell_pack.FAULTS:
        for name, check in checks:
            params = cell_pack.kernel_params
            cell_pack.kernel_params = cell_pack.planted_params(fault)
            try:
                check()
                missed.append((f"K1:{fault}", name))
                log(f"[7] K1:{fault}: {name} PASSED: the fault was not caught")
            except AssertionError as e:
                log(f"[7] K1:{fault}: {name} failed, as it must: {e}")
            finally:
                cell_pack.kernel_params = params
    return missed


#: (fault, check) pairs that cannot fail: phase 8's tables come from the
#: binning, which packs each cell's particles first, so a row's first empty
#: slot is its end there.
NNPS_CHECKS_BLIND_TO = {("K3:hole_as_end", "phase 8")}


def nnps_planted_faults() -> list:
    """Faults planted in K4 or K5 alone (r_cell^2 1% larger; the self pair
    kept), in K4 alone through ``planted_params`` (padding 0 for -1;
    counts saturated at K) and in K3 (the sign of f_j - f_i flipped; the
    first cell edge 1% longer; through ``planted_params``, the walk one
    occupied slot short of each neighbor row, and a row's first empty slot
    taken as its end) through their run-time parameters: phase 2's NNPS
    checks and phase 8's checks (the path driven again with the faulty
    kernel) must each fail on each, but for :data:`NNPS_CHECKS_BLIND_TO`.
    Returns the (fault, check) pairs that passed where they must fail."""
    from repro_torch.kernels import nnps_pairwise, sph_gradient

    def nnps_fault(fault):
        # K4 and K5 share kernel_params: plant in the named kernel's call only
        kernel, fault = fault.split(":")
        caller = {"K4": "rcll_neighbor_list_tables", "K5": "rcll_adjacency"}[kernel]
        params = nnps_pairwise.kernel_params

        def faulty(**kw):
            f, i = params(**kw)
            if sys._getframe(1).f_code.co_name != caller:
                return f, i
            if fault == "r2_cell_1pct":
                f[3] *= 1.01
            else:
                i[0] = 1  # keep_self
            return f, i
        return nnps_pairwise, "kernel_params", faulty

    def list_fault(fault):  # K5 reads neither field
        return nnps_pairwise, "kernel_params", nnps_pairwise.planted_params(fault.split(":")[1])

    def gradient_fault(fault):
        params = sph_gradient.kernel_params

        def faulty(**kw):
            f = params(**kw)
            if fault == "K3:df_sign":
                f[9] = -1.0
            else:
                f[4] *= 1.01  # hc_phys[0]
            return f
        return sph_gradient, "kernel_params", faulty

    def walk_fault(fault):
        return sph_gradient, "walk_params", sph_gradient.planted_params(fault.split(":")[1])

    checks = (("phase 2 NNPS", phase2_nnps),
              ("phase 8", lambda: nnps_path_checks(nnps_path_run())))
    missed = []
    faults = ([(f"{kernel}:{fault}", nnps_fault) for kernel in ("K4", "K5")
               for fault in ("r2_cell_1pct", "self_pair")]
              + [(f"K4:{fault}", list_fault) for fault in nnps_pairwise.FAULTS]
              + [("K3:df_sign", gradient_fault), ("K3:hc0_1pct", gradient_fault)]
              + [(f"K3:{fault}", walk_fault) for fault in sph_gradient.FAULTS])
    for fault, plant in faults:
        for name, check in checks:
            mod, attr, faulty = plant(fault)
            params = getattr(mod, attr)
            setattr(mod, attr, faulty)
            try:
                out = check()
                if (fault, name) in NNPS_CHECKS_BLIND_TO:
                    log(f"[7] {fault}: {name} passed, as it must: its tables are prefix-"
                        f"occupied (the binning packs each cell first), so a row's first "
                        f"empty slot is its end there; phase 2's masks with holes catch it")
                    continue
                missed.append((fault, name))
                log(f"[7] {fault}: {name} PASSED: the fault was not caught ({out})")
            except AssertionError as e:
                log(f"[7] {fault}: {name} failed, as it must: {e}")
            finally:
                setattr(mod, attr, params)
    return missed


#: Phase 8's NNPS path: the paper's 1M-particle 2-D gradient case and the
#: list width of benchmarks/table6_sort_locality.py; K4 is also held to
#: its plain version at a K the counts pass (true counts past K).
NNPS_DS = 1.0 / 1024
NNPS_K = 48
NNPS_K_SMALL = 8


def nnps_path_run(dev=torch.device("cuda")) -> dict:
    """Drive the NNPS path once through its entry points (README, the
    port's section); launch counts of K3-K5 are zeroed just before and
    read just after. Returns the path's outputs and the kernels' inputs."""
    from repro_torch.core import cases, cells, rcll
    from repro_torch.kernels import ops

    dom, x = cases.gradient_test_particles(ds=NNPS_DS, jitter=0.2, seed=0)
    n = x.shape[0]
    store: dict = {}
    for key in ("k3", "k4", "k5"):
        wrapper(key).launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with capture_kernel_inputs(store):
        xt = torch.as_tensor(x, device=dev)
        xn = dom.normalize(xt)
        st = rcll.init_state(dom, xn)
        cap = cells.default_capacity(dom, n)
        b = cells.bin_by_cell_id(dom, dom.flat_cell_id(st.cell_xy), st.cell_xy, cap)
        nl = ops.rcll_neighbor_lists(dom, b, st.rel, k=NNPS_K)
        adj, cnt = ops.rcll_adjacency_cells(dom, b, st.rel)
        f = cases.cubic_field(xt).float()
        g = ops.rcll_gradient_particles(dom, b, st.rel, f)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {key: wrapper(key).launches for key in ("k3", "k4", "k5")}
    return dict(dom=dom, x=x, xn=xn, st=st, cap=cap, b=b, nl=nl, adj=adj, cnt=cnt, f=f, g=g,
                store=store, launches=launches, wall=wall)


def nnps_path_checks(run: dict) -> dict:
    """Phase 8's gates on one run of the path; raises AssertionError."""
    from repro_torch.core import cases, nnps
    from repro_torch.kernels import nnps_pairwise, sph_gradient

    dom, b, nl, st = run["dom"], run["b"], run["nl"], run["st"]
    if any(v != 1 for v in run["launches"].values()):
        raise AssertionError(f"NNPS path launches {run['launches']}, expected one each")
    if int(b.overflow) != 0:
        raise AssertionError(f"binning overflow {int(b.overflow)}")
    max_count = int(nl.count.max())
    if max_count > NNPS_K:
        raise AssertionError(f"K4 found up to {max_count} neighbors, more than K = {NNPS_K}")
    ref = nnps.rcll_neighbors(dom, st.rel, st.cell_xy, compute_dtype=torch.float32, k=NNPS_K,
                              binning=b)
    if not bool(nnps.neighbor_sets_equal(nl, ref).all()):
        raise AssertionError("K4's neighbor sets differ from nnps.rcll_neighbors")
    same_ids = bool(torch.equal(torch.where(nl.mask, nl.idx, -1), torch.where(ref.mask, ref.idx, -1)))
    if not same_ids:
        raise AssertionError("K4's lists are not in nnps.rcll_neighbors' order")
    if not torch.equal(run["cnt"].to(torch.int32), nl.count):
        raise AssertionError("K5's counts differ from K4's")
    x = run["x"]
    g = run["g"].cpu().numpy()
    if not np.isfinite(g).all():
        raise AssertionError("non-finite gradient")
    interior = (np.abs(x - 0.5) < 0.5 - 2.5 * dom.h).all(axis=1)
    rms = float(np.sqrt(np.mean((g[interior, 0] - cases.cubic_gradient_x(x)[interior]) ** 2)))
    if not rms < 0.15:
        raise AssertionError(f"interior RMS of the x^3 gradient {rms:.3e} >= 0.15")
    a4, kw4 = run["store"]["k4"]
    a5, kw5 = run["store"]["k5"]
    a3, kw3 = run["store"]["k3"]
    return dict(max_count=max_count, rms=rms, interior=int(interior.sum()),
                k4=nnps_pairwise.check_against_plain("K4", a4, kw4),
                k4_small=nnps_pairwise.check_against_plain(
                    "K4", a4, dict(kw4, k_slots=NNPS_K_SMALL)),
                k5=nnps_pairwise.check_against_plain("K5", a5, kw5),
                k3=sph_gradient.check_against_plain(a3, kw3))


def phase8_nnps_path(results: dict, parent: Path | None = None) -> None:
    from repro_torch.core import cells, nnps, rcll
    from repro_torch.kernels import nnps_pairwise, ops, sph_gradient

    torch.cuda.reset_peak_memory_stats()
    run = nnps_path_run()
    dom, b, nl, st = run["dom"], run["b"], run["nl"], run["st"]
    n = run["x"].shape[0]
    log(f"[8] gradient_test_particles ds=1/{round(1 / NNPS_DS)}: N {n}, cells {dom.ncells}, "
        f"cap {run['cap']}, r_cell {nnps.rcll_radius_cell_units(dom):.9g}; path "
        f"{1e3 * run['wall']:.3f} ms (host clock, synchronized); launches K3 "
        f"{run['launches']['k3']}, "
        f"K4 {run['launches']['k4']}, K5 {run['launches']['k5']}; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} bytes")
    c = nnps_path_checks(run)
    log(f"[8] overflow 0; K4 max count {c['max_count']} <= {NNPS_K}; K4 sets, ids and counts "
        f"equal nnps.rcll_neighbors (fp16 storage, fp32 compute); K5 counts equal K4's; "
        f"interior RMS of d(x^3)/dx vs 3x^2: {c['rms']:.6e} over {c['interior']} particles "
        f"(gate 0.15)")
    log(f"[8] kernel vs plain at these inputs: K4 bit-identical ({c['k4']['hits']} hits; "
        f"also at K = {NNPS_K_SMALL}, {c['k4_small']['past_k']} counts past K), "
        f"K5 bit-identical ({c['k5']['hits']} hits); {k3_summary(c['k3'])}")

    # The paper's Table 2: wrong determinations against the fp64 truth.
    x64 = torch.as_tensor(run["x"], dtype=torch.float64, device="cuda")
    truth = nnps.reference_neighbors(dom, dom.normalize(x64, dtype=torch.float64), k=NNPS_K)
    total = int(truth.count.sum())
    fp16_arith = ops.rcll_neighbor_lists(dom, b, st.rel, k=NNPS_K, compute_dtype=torch.float16)
    abs16 = nnps.cell_list_neighbors(dom, run["xn"], dtype=torch.float16, k=NNPS_K)
    for name, nlx in (("K4 lists (fp16 storage, fp32 compute; approach III)", nl),
                      ("K4 lists (fp16 storage, fp16 arithmetic)", fp16_arith),
                      ("cell_list_neighbors fp16 absolute coordinates (approach II)", abs16)):
        wrong = int(nnps.count_wrong_determinations(truth, nlx))
        log(f"[8] Table 2: {name}: {wrong} wrong determinations of {total} true pairs "
            f"({100.0 * wrong / total:.6f} %)")

    # Where the path's time goes (synchronized, second call).
    split = {}
    sync = torch.cuda.synchronize
    t = time.perf_counter()
    xn = dom.normalize(torch.as_tensor(run["x"], device="cuda"))
    st2 = rcll.init_state(dom, xn)
    sync()
    split["to_device+normalize+init_state"] = time.perf_counter() - t
    t = time.perf_counter()
    b2 = cells.bin_by_cell_id(dom, dom.flat_cell_id(st2.cell_xy), st2.cell_xy, run["cap"])
    sync()
    split["bin_by_cell_id"] = time.perf_counter() - t
    for name, fn in (("rcll_neighbor_lists (K4)", lambda: ops.rcll_neighbor_lists(
                          dom, b2, st2.rel, k=NNPS_K)),
                     ("rcll_adjacency_cells (K5)", lambda: ops.rcll_adjacency_cells(
                          dom, b2, st2.rel)),
                     ("rcll_gradient_particles (K3)", lambda: ops.rcll_gradient_particles(
                          dom, b2, st2.rel, run["f"]))):
        t = time.perf_counter()
        fn()
        sync()
        split[name] = time.perf_counter() - t
    log("[8] path split (ms, synchronized, second call): " + ", ".join(
        f"{k} {1e3 * v:.3f}" for k, v in split.items()))

    # Each kernel at these inputs beside its plain version and its bound.
    rows = []
    for key, name, src, rep, work, plain in (
        ("k3", "rcll_gradient", "sph_gradient.cu", "src/repro/kernels/sph_gradient.py:93",
         # K3 decides in fp16 as K4 does with fp16 arithmetic: same accepted pairs
         lambda a, kw: k3_work(a, kw, int(fp16_arith.count.sum())),
         sph_gradient.rcll_gradient_ref),
        ("k4", "rcll_neighbor_list_tables", "nnps_pairwise.cu",
         "src/repro/kernels/nnps_pairwise.py:158", k4_work,
         nnps_pairwise.rcll_neighbor_list_tables_ref),
        ("k5", "rcll_adjacency", "nnps_pairwise.cu", "src/repro/kernels/nnps_pairwise.py:224",
         k5_work, nnps_pairwise.rcll_adjacency_ref),
    ):
        a, kw = run["store"][key]
        fn = wrapper(key)
        ms = time_ms(lambda: fn(*a, **kw), reps=10)
        plain_ms = time_ms(lambda: plain(*a, **kw), reps=3, warmup=1)
        pairs, ops_n, nbytes = work(a, kw)
        bms, by = bound(nbytes, ops_n)
        # launches a graph: each K5 call allocates its 2.7 GB output, each K4 call 0.7 GB
        reps = {"k3": 50, "k4": 10, "k5": 8}[key]
        eager, ms = ms, time_ms_graph(lambda: fn(*a, **kw), reps=reps)
        extra = (f"; {ms:.4f} ms a launch in a CUDA graph ({eager:.4f} ms launched one by "
                 f"one from Python), {nbytes / ms / 1e9:.3f} TB/s reached of 3.35")
        if key == "k4":
            extra += (store_yardstick(k4_out_bytes(a, kw), reps=reps, fill=-1)
                      + wide_stores("neighbor_lists_kernel", "STG.E.EF.128"))
        if key == "k5":
            extra += (store_yardstick(k5_out_bytes(a), reps=reps)
                      + wide_stores("adjacency_kernel", "STG.E.EF.128"))
        extra += parent_times(parent, key, a, kw, ms, reps=reps)
        log(f"[8] {key.upper()} {name} rel {tuple(a[0].shape)} {a[0].dtype}: {ms:.4f} ms "
            f"(plain {plain_ms:.4f} ms), bound {bms:.4f} ms by {by} ({pairs} pairs decided, "
            f"{ops_n:.4g} ops, {nbytes} bytes){extra}")
        rows.append({"name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{src}",
                     "replaces": rep, "launches": run["launches"][key],
                     "max_abs_err": c[key]["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bms, "bound_by": by, "library_ms": None})
    results["nnps_kernels"] = rows


# --------------------------------------------------------------------------
# the LM serving path: K6 (RCLL-KV decode) and K7 (flash prefill)
# --------------------------------------------------------------------------
def k6_work(args, kw):
    """(keys attended, fp32 operations, bf16 tensor-core operations (none),
    bytes) of one K6 call on these inputs:
    the blocks below each row's length are read once (residuals, anchors,
    scales), q read and out, m, l written; per key below length, dequant
    (2 per element of k and v) and the rep dot products and P.V updates."""
    q, kr, ka, ks, vr, va, vs, length = args
    b, h, dh = q.shape
    _, hkv, nblk, blk, _ = kr.shape
    ln = length.long().clamp(0, nblk * blk)
    blocks = int(((ln + blk - 1) // blk).sum()) * hkv
    keys = int(ln.sum()) * hkv
    nbytes = (blocks * (2 * blk * dh * kr.element_size() + 4 * dh * 4)
              + q.numel() * 4 + b * h * (dh + 2) * 4 + b * 4)
    ops = keys * dh * (4 + 4 * (h // hkv))
    return keys, ops, 0, nbytes


def k7_work(args, kw):
    """(pairs, fp32 operations, bf16 tensor-core operations, bytes) of one
    K7 call at fp32 accuracy: 4 Dh operations per (query, visible key)
    pair, q, k, v read once and out written once. With bf16 inputs the
    q.k half is products of bf16 values summed in fp32, one bf16
    tensor-core pass; the p.v half has fp32 weights, which split exactly
    into three bf16 parts, so it takes three passes. fp32 inputs take the
    fp32 rate for all of it."""
    q, k, v = args
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    if kw.get("causal", True):
        rows = np.arange(lq)
        pairs = int(np.clip(rows + (lk - lq) + 1, 0, lk).sum())
    else:
        pairs = lq * lk
    ops = 4 * dh * b * h * pairs
    nbytes = (q.numel() + k.numel() + v.numel()) * q.element_size() + b * h * lq * dh * 4
    if q.dtype == torch.bfloat16:
        return pairs, 0, ops // 2 + 3 * (ops // 2), nbytes
    return pairs, ops, 0, nbytes


def phase2_lm() -> None:
    """K6 and K7 against their plain versions on random inputs."""
    from repro_torch.kernels import flash_attention as k7
    from repro_torch.kernels import rcll_kv_attention as k6

    for i, (b, h, hkv, dh, nblk, blk, resid, lengths, heads_last) in enumerate([
        (3, 24, 8, 128, 10, 128, torch.int8, [1153, 0, 1280], True),
        (2, 8, 2, 64, 4, 128, torch.float16, [300, 37], False),
        (4, 24, 8, 128, 9, 128, torch.bfloat16, [1, 129, 512, 1152], True),
        (2, 6, 2, 16, 3, 256, torch.int8, [700, 256], False),
    ]):
        args = k6.random_inputs(300 + i, b, h, hkv, dh, nblk, blk, resid, lengths,
                                heads_last=heads_last, device="cuda")
        c = k6.check_against_plain(args, {})
        log(f"[2] K6 B {b} H {h} Hkv {hkv} Dh {dh} nblk {nblk} blk {blk} "
            f"{str(resid).split('.')[-1]} lengths {lengths} heads-last views {heads_last} "
            f"({k6.grid(args[1])[0]} CTAs): {lm_summary(c)}; m and l within the bound")
    for i, (b, h, hkv, lq, lk, dh, dtype, causal, heads_last) in enumerate([
        (2, 24, 8, 1024, 1024, 128, torch.bfloat16, True, True),
        (2, 8, 2, 300, 300, 64, torch.float32, True, False),
        (1, 6, 2, 333, 333, 16, torch.bfloat16, True, True),
        (2, 8, 2, 200, 333, 128, torch.bfloat16, False, False),
        (2, 4, 4, 100, 300, 32, torch.float32, False, True),
        (1, 8, 2, 100, 300, 128, torch.float32, True, False),
        # the bf16 kernel's edges: Dh 16-128, lengths off its 128-row and 64-key
        # tiles, Lq > Lk and Lq < Lk, rep 1, 3 and 8
        (2, 6, 2, 129, 129, 16, torch.bfloat16, True, True),
        (2, 6, 2, 127, 127, 32, torch.bfloat16, True, False),
        (1, 16, 2, 65, 65, 64, torch.bfloat16, True, True),
        (2, 4, 4, 1, 1, 128, torch.bfloat16, True, False),
        (2, 6, 2, 200, 65, 128, torch.bfloat16, True, False),
        (2, 6, 2, 63, 1000, 128, torch.bfloat16, True, True),
        (1, 6, 2, 1000, 1000, 128, torch.bfloat16, False, True),
        (1, 6, 2, 1000, 1000, 16, torch.float32, True, True),
    ]):
        args = k7.random_inputs(400 + i, b, h, hkv, lq, lk, dh, dtype, heads_last=heads_last,
                                device="cuda")
        c = k7.check_against_plain(args, {"causal": causal})
        log(f"[2] K7 B {b} H {h} Hkv {hkv} Lq {lq} Lk {lk} Dh {dh} "
            f"{str(dtype).split('.')[-1]} causal {causal} heads-last views {heads_last}: "
            f"{lm_summary(c)}")
    q, k, v = k7.random_inputs(412, 2, 6, 2, 129, 129, 64, torch.bfloat16, device="cuda")
    padded = torch.zeros(2, 2, 129, 68, dtype=torch.bfloat16, device="cuda")
    padded[..., :64] = k
    k = padded[..., :64]  # rows 136 bytes apart: TMA cannot read it, the wrapper copies it
    assert not k7.tma_addressable(k)
    c = k7.check_against_plain((q, k, v), {"causal": True})
    log(f"[2] K7 bf16 Dh 64 L 129, k a view TMA cannot address (copied): {lm_summary(c)}")
    out = k7.flash_attention(*k7.random_inputs(413, 2, 6, 2, 200, 65, 128, torch.bfloat16,
                                               device="cuda"))
    if out[:, :, :135].any() or not bool((out[:, :, 135:].abs().sum(-1) > 0).all()):
        raise AssertionError("K7 bf16 Lq 200 > Lk 65: the 135 rows that see no key are not 0")
    log("[2] K7 bf16 Lq 200 > Lk 65, causal: the 135 rows that see no key are exactly 0")


def _twin(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` with its strides (a strided view of a cache stays one)."""
    u = torch.empty_strided(t.size(), t.stride(), dtype=t.dtype, device=t.device)
    u.copy_(t)
    return u


def k6_grid_times(a, kw, bound_ms: float, copies: int = 8) -> str:
    """K6's grid at the captured inputs, and its time in a CUDA graph
    beside the warm one every K6 time is: cycling over ``copies`` copies
    of its inputs (8 x ~10.5 MB of cache views, more than the 50 MB L2, so
    each launch finds its cache cold, as a decode step does: each layer
    has its own), with every length 0 (the two launches and the exits)
    and with one cache block a row (one CTA's load, scores, P.V and the
    merge of one partial, with no other CTA to overlap)."""
    import itertools

    from repro_torch.kernels import rcll_kv_attention as k6

    fn = wrapper("k6")
    twins = itertools.cycle([tuple(_twin(t) for t in a) for _ in range(copies)])
    cold = time_ms_graph(lambda: fn(*next(twins), **kw), reps=48)
    ctas, nsplit = k6.grid(a[1])
    blk = a[1].shape[3]
    busy = int(((a[7].long() + blk - 1) // blk).sum()) * a[1].shape[1]
    empty = a[:7] + (torch.zeros_like(a[7]),)
    one = a[:7] + (torch.full_like(a[7], blk),)
    floor_ms = time_ms_graph(lambda: fn(*empty, **kw))
    one_ms = time_ms_graph(lambda: fn(*one, **kw))
    return (f"; grid {ctas} CTAs ({nsplit} splits per (b, kv head), {busy} with keys below "
            f"length) and a merge kernel; on inputs cold in L2 {cold:.4f} ms "
            f"({cold / bound_ms:.1f}x the bound); every length 0: {floor_ms:.4f} ms; one cache "
            f"block a row: {one_ms:.4f} ms")


def lm_summary(c: dict) -> str:
    from repro_torch.kernels import flash_attention as k7

    return (f"max|err| {c['max_abs_err']:.3e}, max err/bound {c['max_ratio']:.3e} "
            f"(bound: 4 (E + (n + 8) u)(A + |out|)), normwise {c['normwise']:.3e} "
            f"(limit {k7.NORMWISE_LIMIT:g})")


#: Phase 9's request: llama3.2-3b at full width and depth, one chip.
LM_ARCH = "llama3.2-3b"
LM_REQUEST = dict(batch=4, prompt_len=1024, gen=160, seed=0)


def lm_weights(cfg):
    """The request's weights (seed 0, as ServeRun draws them), bf16 copy."""
    from repro_torch.models import transformer

    with torch.inference_mode():
        params = transformer.init_params(
            torch.Generator(device="cuda").manual_seed(LM_REQUEST["seed"]), cfg)
        return transformer.compute_weights(params)


def lm_prompt(cfg, request: dict = LM_REQUEST, device="cuda") -> torch.Tensor:
    rng = np.random.default_rng(request["seed"])  # ServeRun's prompt
    return torch.as_tensor(rng.integers(0, cfg.vocab, (request["batch"], request["prompt_len"])),
                           dtype=torch.int32, device=device)


def lm_teacher_forced(weights, cfg, prompt, max_len, steps, tokens=None):
    """Prefill and ``steps`` decode steps of ``cfg``'s family module (with
    ServeRun's modality stubs), greedy or fed ``tokens`` (B, steps);
    returns the logits of every step (steps + 1, B, vocab) and the tokens
    fed."""
    from repro_torch.launch.serve import modality_inputs
    from repro_torch.models import registry

    mod = registry.get_module(cfg)
    kw = modality_inputs(cfg, prompt.shape[0], prompt.device)
    with torch.inference_mode():
        lg, cache = mod.prefill(weights, prompt, cfg, max_len, **kw)
        out = [lg[:, -1]]
        cur = torch.argmax(lg[:, -1:], dim=-1).to(torch.int32)
        fed = []
        for i in range(steps):
            if tokens is not None:
                cur = tokens[:, i:i + 1]
            fed.append(cur)
            lg2, cache = mod.decode_step(weights, cur, cache, cfg)
            out.append(lg2[:, 0])
            cur = torch.argmax(lg2, dim=-1).to(torch.int32)
    return torch.stack(out), torch.cat(fed, dim=1)


@contextlib.contextmanager
def every_launch_checked(record: dict):
    """Hold every K6 and K7 launch against its plain version on the same
    inputs (``check_against_plain`` on the launch's own output); ``record``
    collects the count and the worst error-over-bound and normwise."""
    from repro_torch.kernels import flash_attention as k7
    from repro_torch.kernels import rcll_kv_attention as k6

    saved = k6.rcll_kv_decode, k7.flash_attention
    record.update(k6=0, k7=0, max_ratio=0.0, normwise=0.0, k6_max_ratio=0.0, k7_max_ratio=0.0)

    def note(key, c):
        record[key] += 1
        record["max_ratio"] = max(record["max_ratio"], c["max_ratio"])
        record[f"{key}_max_ratio"] = max(record[f"{key}_max_ratio"], c["max_ratio"])
        record["normwise"] = max(record["normwise"], c["normwise"])

    def k6_checked(*a, return_stats=False, **kw):
        stats = saved[0](*a, return_stats=True, **kw)
        note("k6", k6.check_against_plain(a, kw, stats=stats))
        return stats if return_stats else stats[0]

    def k7_checked(*a, **kw):
        out = saved[1](*a, **kw)
        note("k7", k7.check_against_plain(a, kw, out_k=out))
        return out

    k6.rcll_kv_decode, k7.flash_attention = k6_checked, k7_checked
    try:
        yield record
    finally:
        k6.rcll_kv_decode, k7.flash_attention = saved


#: Limit on the request's normwise logit difference, kernel path against
#: plain path (the largest over its steps of ||dlogits|| / ||logits||),
#: the geometric mean of two readings on the card (PERF.md): the clean
#: kernel path's 1.66e-2 and the int8 divisor 127 -> 128's 2.27e-2,
#: which the elementwise tolerance alone lets pass.
LOGIT_NORMWISE_LIMIT = 1.95e-2


def lm_request_check(weights, cfg, steps: int, store: dict | None = None,
                     per_launch: bool = True) -> dict:
    """The kernel path against the plain path of one anchored request on
    the card, teacher-forced with the kernel path's tokens: every logit
    finite and within ``transformer.logit_tolerance`` (the CPU slice
    test's), the logits within :data:`LOGIT_NORMWISE_LIMIT` normwise and,
    with ``per_launch``, every K6 and K7 launch of the kernel path within
    its rounding bound of its plain version on the same inputs. Raises
    AssertionError."""
    from repro_torch.models import transformer

    prompt = lm_prompt(cfg)
    max_len = -(-(LM_REQUEST["prompt_len"] + LM_REQUEST["gen"]) // cfg.kv_block) * cfg.kv_block
    launches: dict = {"k6": 0, "k7": 0, "max_ratio": 0.0, "normwise": 0.0}
    checked = every_launch_checked(launches) if per_launch else contextlib.nullcontext()
    with capture_kernel_inputs(store if store is not None else {}), checked:
        lk, toks = lm_teacher_forced(weights, cfg, prompt, max_len, steps)
    with plain_lm_versions():
        lp, _ = lm_teacher_forced(weights, cfg, prompt, max_len, steps, tokens=toks)
    if not bool(torch.isfinite(lk).all()):
        raise AssertionError("the kernel path's logits are not finite")
    tol = transformer.logit_tolerance(lp)
    diff = (lk - lp).abs()
    ratio = float((diff / tol).max())
    normwise = float((torch.linalg.vector_norm(lk - lp, dim=(1, 2))
                      / torch.linalg.vector_norm(lp, dim=(1, 2))).max())
    res = {"max_abs_diff": float(diff.max()), "max_ratio": ratio, "steps": steps,
           "tol_max": float(tol.max()), "normwise": normwise,
           "mean_ratio": float((diff / tol).mean()), "launches": launches}
    if ratio > 1.0 or normwise > LOGIT_NORMWISE_LIMIT:
        raise AssertionError(f"kernel path vs plain path: max |dlogit| {res['max_abs_diff']:.4g}"
                             f" is {ratio:.3g} x the tolerance, normwise {normwise:.4g} (limit "
                             f"{LOGIT_NORMWISE_LIMIT:g})")
    return res


def lm_kernel_checks(store: dict) -> dict:
    """K6 and K7 against their plain versions at one layer's captured inputs."""
    from repro_torch.kernels import flash_attention as k7
    from repro_torch.kernels import rcll_kv_attention as k6

    return {"k6": k6.check_against_plain(*store["k6"]),
            "k7": k7.check_against_plain(*store["k7"])}


def expected_cache_bytes(cfg, batch: int, max_len: int, mode: str) -> int:
    """The KV cache's bytes counted from the shapes (serve.py's max_len)."""
    layers, hkv, dh = cfg.n_layers, cfg.n_kv, cfg.head_dim
    length = layers * batch * 4
    if mode == "anchored":
        blk = cfg.kv_block
        nblk = max_len // blk
        return (2 * layers * batch * nblk * blk * hkv * dh  # int8 residuals
                + 4 * layers * batch * nblk * hkv * dh * 4  # anchors and scales
                + 2 * layers * batch * blk * hkv * dh * 4 + length)  # fp32 tails
    return 2 * layers * batch * max_len * hkv * dh * 2 + length


def phase9_serving(results: dict, parent: Path | None = None) -> None:
    """llama3.2-3b served at full width and depth through ServeRun, in
    both KV modes; then K6 and K7 at the anchored run's captured inputs
    against their plain versions, timed beside them, their bounds and the
    library call (K7 also beside the design in ``parent``, a checkout of
    an earlier tree, when given), and the whole request against the plain
    path."""
    from repro_torch.kernels import flash_attention as k7
    from repro_torch.kernels import rcll_kv_attention as k6
    from repro_torch.launch.serve import ServeRun
    from repro_torch.models import registry, transformer

    cfg = registry.get_config(LM_ARCH)
    K6, K7 = wrapper("k6"), wrapper("k7")
    launches, store = {}, {}
    for mode in ("anchored", "dense"):
        run = ServeRun(arch=LM_ARCH, smoke=False, kv_mode=mode, **LM_REQUEST)
        torch.cuda.reset_peak_memory_stats()
        K6.launches = 0
        K7.launches = 0
        with capture_kernel_inputs(store if mode == "anchored" else {}):
            out = run.run()
        torch.cuda.synchronize()
        launches[mode] = {"k6": K6.launches, "k7": K7.launches}
        total = LM_REQUEST["prompt_len"] + LM_REQUEST["gen"]
        max_len = -(-total // cfg.kv_block) * cfg.kv_block if mode == "anchored" else total
        want = expected_cache_bytes(cfg, LM_REQUEST["batch"], max_len, mode)
        steps = LM_REQUEST["gen"]  # the off-clock warm-up and gen - 1 timed steps
        log(f"[9] {LM_ARCH} kv {mode}: B {LM_REQUEST['batch']} prompt {LM_REQUEST['prompt_len']}"
            f" gen {LM_REQUEST['gen']} max_len {max_len}: prefill "
            f"{1e3 * out['t_prefill_s']:.3f} ms, decode {out['decode_tok_s']:.3f} tok/s "
            f"({1e3 * out['t_decode_s']:.3f} ms for {LM_REQUEST['gen'] - 1} steps); cache_bytes "
            f"{out['cache_bytes']} (from the shapes {want}); launches K6 {K6.launches}, "
            f"K7 {K7.launches}; max_memory_allocated {torch.cuda.max_memory_allocated()} bytes; "
            f"tokens[0, :12] {out['tokens'][0, :12].tolist()}")
        want_launches = {"k6": cfg.n_layers * steps if mode == "anchored" else 0,
                         "k7": cfg.n_layers}
        if out["cache_bytes"] != want:
            raise AssertionError(f"{mode}: cache_bytes {out['cache_bytes']} != {want}")
        if launches[mode] != want_launches:
            raise AssertionError(f"{mode}: launches {launches[mode]}, expected {want_launches}")
        if out["tokens"].shape != (LM_REQUEST["batch"], LM_REQUEST["gen"]):
            raise AssertionError(f"{mode}: tokens of shape {out['tokens'].shape}")
        del out

    c = lm_kernel_checks(store)
    log(f"[9] K6 at the last decode step's captured inputs (layer {cfg.n_layers - 1}): "
        f"{lm_summary(c['k6'])}")
    log(f"[9] K7 at the prefill's captured inputs (layer {cfg.n_layers - 1}): "
        f"{lm_summary(c['k7'])}")

    rows = []
    for key, name, src, rep, work, plain, lib in (
        ("k6", "rcll_kv_decode", "rcll_kv_attention.cu",
         "src/repro/kernels/rcll_kv_attention.py:98", k6_work, k6.rcll_kv_decode_ref, None),
        ("k7", "flash_attention", "flash_attention.cu",
         "src/repro/kernels/flash_attention.py:88", k7_work, k7.flash_attention_ref,
         _sdpa_library),
    ):
        a, kw = store[key]
        fn = wrapper(key)
        ms = time_ms_graph(lambda: fn(*a, **kw))
        eager_ms = time_ms(lambda: fn(*a, **kw), reps=50)
        plain_ms = time_ms(lambda: plain(*a, **kw), reps=5, warmup=1)
        lib_ms = lib(a, kw) if lib else None
        n, ops_n, tensor_ops, nbytes = work(a, kw)
        bms, by = bound(nbytes, ops_n, tensor_ops)
        extra = k6_grid_times(a, kw, bms) if key == "k6" else ""
        if key == "k7":
            extra = k7_yardsticks(a, kw, ms, lib_ms, parent)
        log(f"[9] {key.upper()} {name} {tuple(a[0].shape)} {a[1].dtype}: {ms:.4f} ms a launch "
            f"in a CUDA graph ({eager_ms:.4f} ms launched one by one from Python, the wrapper "
            f"included; plain {plain_ms:.4f} ms), bound {bms:.4f} ms by {by} ({n} "
            f"{'keys' if key == 'k6' else 'pairs'}; {ops_n:.4g} ops at fp32 67 TFLOP/s, "
            f"{tensor_ops:.4g} at bf16 tensor-core 989 TFLOP/s; {nbytes} bytes at 3.35 TB/s)"
            f"{extra}")
        rows.append({"name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{src}",
                     "replaces": rep, "launches": launches["anchored"][key],
                     "max_abs_err": c[key]["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bms, "bound_by": by, "library_ms": lib_ms})
    results["lm_kernels"] = rows
    del store

    weights = lm_weights(cfg)
    cfg_a = dataclasses.replace(cfg, kv_mode="anchored")
    t0 = time.perf_counter()
    r = lm_request_check(weights, cfg_a, steps=LM_REQUEST["gen"] - 1)
    log(f"[9] kernel path vs plain path, anchored, teacher-forced over the prefill and "
        f"{r['steps']} decode steps: all logits finite; max |dlogit| {r['max_abs_diff']:.6g}, "
        f"normwise {r['normwise']:.4g} (limit {LOGIT_NORMWISE_LIMIT:g}), mean |dlogit| / tolerance {r['mean_ratio']:.4g}, max "
        f"ratio to the tolerance {r['max_ratio']:.4g} (tolerance {transformer.LOGIT_TOL_ULPS} "
        f"bf16 ulps of the row's largest |logit|, at most {r['tol_max']:.4g}); every launch "
        f"held against its plain version ({r['launches']['k6']} K6, {r['launches']['k7']} K7): "
        f"max err/bound {r['launches']['max_ratio']:.3e} (K6 {r['launches']['k6_max_ratio']:.3e}, "
        f"K7 {r['launches']['k7_max_ratio']:.3e}), max normwise "
        f"{r['launches']['normwise']:.3e}; {time.perf_counter() - t0:.1f} s")
    lm_profile(weights, cfg_a)


def lm_profile(weights, cfg, steps: int = 4, phase: int = 9, suffix: str = "") -> None:
    """Where an anchored decode step's time goes: a ``torch.profiler``
    window over ``steps`` steps after the prefill and one warm step, with
    device time by kernel and the device's busy share; and the prefill's
    K7 share from the same kind of window."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer

    prompt = lm_prompt(cfg)
    max_len = -(-(LM_REQUEST["prompt_len"] + LM_REQUEST["gen"]) // cfg.kv_block) * cfg.kv_block
    with torch.inference_mode():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            lg, cache = transformer.prefill(weights, prompt, cfg, max_len)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        _log_profile("prefill", prof, wall, 1, phase, suffix)
        cur = torch.argmax(lg[:, -1:], dim=-1).to(torch.int32)
        lg, cache = transformer.decode_step(weights, cur, cache, cfg)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                cur = torch.argmax(lg, dim=-1).to(torch.int32)
                lg, cache = transformer.decode_step(weights, cur, cache, cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        _log_profile("anchored decode step", prof, wall, steps, phase, suffix)


def device_events(prof) -> list:
    """The device-side (kernel and memcpy) events of a ``torch.profiler``
    window. The CPU-side ops also carry their kernels' device time, so a
    sum over all events would count it twice."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def _log_profile(what: str, prof, wall: float, n: int, phase: int = 9,
                 suffix: str = "") -> None:
    events = device_events(prof)
    device_us = sum(e.self_device_time_total for e in events)
    kernels = sum(e.count for e in events)
    log(f"[{phase}] profile, {what}: wall {1e3 * wall / n:.3f} ms, device time "
        f"{device_us / 1e3 / n:.3f} ms, device busy share {device_us / 1e6 / wall:.3f}, "
        f"{kernels // n} device ops{suffix}")
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    for e in top:
        if e.self_device_time_total > 0:
            log(f"[{phase}]   {e.self_device_time_total / 1e3 / n:9.4f} ms "
                f"{e.count // n:5d} calls  "
                f"{e.key[:90]}{suffix}")


#: Times the kernel wrapper ``MOD.NAME`` of the checkout in argv[1] on the
#: inputs saved in argv[2]: the same CUDA-graph method as
#: :func:`time_ms_graph` with argv[3] launches a graph, in a process of its
#: own (the two trees' packages share a name).
PARENT_TIMER = """
import sys
sys.path.insert(0, sys.argv[1] + "/src")
import torch
from repro_torch.kernels.MOD import NAME as wrapped
reps = int(sys.argv[3])
a, kw = torch.load(sys.argv[2], weights_only=False)
fn = lambda: wrapped(*a, **kw)
side = torch.cuda.Stream()
side.wait_stream(torch.cuda.current_stream())
with torch.cuda.stream(side):
    fn()
torch.cuda.current_stream().wait_stream(side)
graph = torch.cuda.CUDAGraph()
with torch.cuda.graph(graph):
    for _ in range(reps):
        fn()
for _ in range(2):
    graph.replay()
torch.cuda.synchronize()
t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
t0.record()
for _ in range(3):
    graph.replay()
t1.record()
torch.cuda.synchronize()
print(t0.elapsed_time(t1) / (3 * reps))
"""


def parent_ms(parent: Path, key: str, a, kw, reps: int = 50) -> float:
    """Kernel ``key``'s time in a CUDA graph of ``reps`` launches as the
    tree in ``parent`` builds it, on these inputs (saved under ``build/``)."""
    mod, name, _ = next(w for w in WRAPPERS if w[2] == key)
    path = ROOT / "build" / f"{key}_inputs.pt"
    path.parent.mkdir(exist_ok=True)
    torch.save((a, kw), path)
    torch.cuda.empty_cache()  # the parent's process needs the card's memory too
    code = PARENT_TIMER.replace("MOD", mod).replace("NAME", name)
    out = subprocess.run([sys.executable, "-c", code, str(parent), str(path), str(reps)],
                         check=True, capture_output=True, text=True, timeout=900)
    return float(out.stdout.strip().splitlines()[-1])


def parent_times(parent: Path | None, key: str, a, kw, ms: float, reps: int = 50) -> str:
    """The design in ``parent`` timed before and after this tree's second
    timing (parent, this, this, parent), as a clause of a log line; "" when
    no parent is given."""
    if parent is None:
        return ""
    fn = wrapper(key)
    before = parent_ms(parent, key, a, kw, reps)
    again = time_ms_graph(lambda: fn(*a, **kw), reps)
    after = parent_ms(parent, key, a, kw, reps)
    return (f"; the design in {parent} in a CUDA graph: {before:.4f} and {after:.4f} ms "
            f"(this tree {ms:.4f} and {again:.4f} ms between them)")


@functools.cache
def sass_functions() -> dict:
    """The SASS of the built kernel library by function name (``cuobjdump -sass``)."""
    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(_build.library().path)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    return {fn.split(None, 1)[0]: fn for fn in sass.split("Function : ")[1:]}


def sass_count(kernel: str, instr: str) -> dict:
    """Instructions containing ``instr`` in each SASS function whose name
    contains ``kernel``."""
    return {name: sum(instr in line for line in body.splitlines())
            for name, body in sass_functions().items() if kernel in name}


def hgmma_counts(kernel: str = "flash_wgmma_kernel") -> dict:
    """HGMMA (wgmma) instructions in the SASS of each instantiation of the
    bf16 kernel ``kernel`` (K7's by default) of the built library, by head
    dim."""
    counts = sass_count(kernel, "HGMMA")
    return dict(sorted((int(name.split(kernel + "ILi")[1].split("E")[0]), n)
                       for name, n in counts.items()))


#: K7b's bf16 (tensor-core) kernels, whose SASS must hold HGMMA at every Dh.
K7B_WGMMA_KERNELS = ("dq_wgmma_kernel", "dkdv_wgmma_kernel")


def k7b_hgmma() -> str:
    """A clause giving the HGMMA count of each bf16 K7b kernel by Dh;
    raises if an instantiation of Dh 16, 32, 64 or 128 has none."""
    parts = []
    for kernel in K7B_WGMMA_KERNELS:
        counts = hgmma_counts(kernel)
        if sorted(counts) != [16, 32, 64, 128] or not all(counts.values()):
            raise AssertionError(f"{kernel}: an instantiation without HGMMA: {counts}")
        parts.append(f"{kernel} " + ", ".join(f"{dh} {n}" for dh, n in counts.items()))
    return "; HGMMA instructions in the SASS by Dh: " + "; ".join(parts)


def kernel_split(fn, n: int = 5) -> str:
    """A clause giving the device time a call of ``fn`` spends in each of
    the port's kernels (``torch.profiler`` over ``n`` calls)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    parts = sorted(((e.key.split("namespace)::", 1)[1].split("(")[0],
                     e.self_device_time_total / 1e3 / n)
                    for e in device_events(prof) if "namespace)::" in e.key),
                   key=lambda x: -x[1])
    if not parts:  # a reading, not a gate
        return "; device time a call by kernel: not recorded by the profiler"
    return "; device time a call by kernel: " + ", ".join(f"{k} {ms:.4f} ms" for k, ms in parts)


def wide_stores(kernel: str, instr: str) -> str:
    """A clause naming the 16-byte stores (``instr``) in the SASS of each
    instantiation of ``kernel``; raises if one has none."""
    counts = sass_count(kernel, instr)
    if not counts or not all(counts.values()):
        raise AssertionError(f"{kernel} has an instantiation without {instr}: {counts}")
    return (f"; {instr} in the SASS of its {len(counts)} instantiation(s): "
            f"{min(counts.values())} to {max(counts.values())}")


def k7_yardsticks(a, kw, ms: float, lib_ms: float, parent: Path | None) -> str:
    """K7's time beside its other yardsticks: the previous pricing (p.v at
    the fp32 rate), the bytes, the library call, the design in ``parent``
    timed before and after this tree's (parent, this, this, parent), and
    the HGMMA instructions of the bf16 kernel. Raises if the bf16 kernel
    has none."""
    pairs, _, _, nbytes = k7_work(a, kw)
    b, h, _, dh = a[0].shape
    half = 2 * dh * b * h * pairs  # the q.k half of the operations, one pass
    old_ms = (half / H100_BF16_TENSOR_OPS_PER_S + half / H100_FP32_OPS_PER_S) * 1e3
    text = (f"; the previous yardstick (p.v at the fp32 rate) {old_ms:.4f} ms, one "
            f"tensor-core pass for all {half / H100_BF16_TENSOR_OPS_PER_S * 2e3:.4f} ms, the "
            f"bytes {nbytes / H100_BYTES_PER_S * 1e3:.4f} ms; library "
            f"(scaled_dot_product_attention, fp32, causal, GQA) {lib_ms:.4f} ms")
    text += parent_times(parent, "k7", a, kw, ms)
    counts = hgmma_counts()
    if not counts or not all(counts.values()):
        raise AssertionError(f"the bf16 K7 kernel has no HGMMA instruction: {counts}")
    return text + "; HGMMA instructions in the bf16 kernel's SASS by Dh: " + ", ".join(
        f"{dh} {n}" for dh, n in counts.items())


def _sdpa_library(a, kw) -> float:
    """One PyTorch call computing K7's function on the same inputs, in fp32."""
    q, k, v = (t.float() for t in a)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return time_ms(lambda: sdpa(q, k, v, is_causal=kw.get("causal", True), enable_gqa=True),
                   reps=20)


#: The one planted fault the request's logit gates alone cannot see: P
#: rounded to bf16 once, in the prefill's attention only, moves the logits
#: by 1.81e-2 normwise against the clean path's 1.65e-2 (limit 1.95e-2) and
#: 0.35 of the 8-ulp tolerance (PERF.md, PR 17). The request check's
#: per-launch gate, phase 2 and phase 9 at captured inputs catch it.
LOGIT_GATES_BLIND_TO = {("K7:p_bf16", "phase 9 request, logit gates alone")}


def lm_planted_faults() -> list:
    """Faults planted in K6 (the length mask one block short; the int8
    divisor 127 -> 128; the merge skipping each row's last key split) and
    in K7 (the causal mask one column late; P's bf16 hi part alone)
    through ``planted_params``: phase 2's K6/K7 checks, phase 9's checks
    at captured inputs, phase 9's request check (over the prefill and 8
    decode steps) and that check's logit gates alone (no per-launch
    gate) must each fail on each, but for :data:`LOGIT_GATES_BLIND_TO`.
    Returns the (fault, check) pairs that passed where they must fail."""
    from repro_torch.kernels import flash_attention as k7
    from repro_torch.kernels import rcll_kv_attention as k6
    from repro_torch.models import registry

    cfg = dataclasses.replace(registry.get_config(LM_ARCH), kv_mode="anchored")
    weights = lm_weights(cfg)
    store: dict = {}
    clean = lm_request_check(weights, cfg, steps=8, store=store)  # inputs to plant into
    log(f"[7] clean request over 8 decode steps: max |dlogit| / tolerance "
        f"{clean['max_ratio']:.4g}, normwise {clean['normwise']:.4g}")

    checks = (("phase 2 K6/K7", phase2_lm),
              ("phase 9 K6/K7 at captured inputs", lambda: lm_kernel_checks(store)),
              ("phase 9 request vs plain path", lambda: lm_request_check(weights, cfg, steps=8)),
              ("phase 9 request, logit gates alone",
               lambda: lm_request_check(weights, cfg, steps=8, per_launch=False)))
    missed = []
    for mod in (k6, k7):
        for fault in mod.FAULTS:
            label = f"{'K6' if mod is k6 else 'K7'}:{fault}"
            for name, check in checks:
                params = mod.kernel_params
                mod.kernel_params = mod.planted_params(fault)
                try:
                    out = check()
                    if (label, name) in LOGIT_GATES_BLIND_TO:
                        log(f"[7] {label}: {name} passed; only the per-launch gate separates "
                            f"this fault ({out})")
                        continue
                    missed.append((label, name))
                    log(f"[7] {label}: {name} PASSED: the fault was not caught ({out})")
                except AssertionError as e:
                    log(f"[7] {label}: {name} failed, as it must: {e}")
                finally:
                    mod.kernel_params = params
    return missed


# --------------------------------------------------------------------------
# phase 10: the list backends and the absolute algos
# --------------------------------------------------------------------------
#: Phase 10's full-size case (N = 1,048,576) and step counts.
P10_DS = 1.0 / 1024
P10_STEPS = 10  # the three backends from one state, fp32 records
P10_CELL_STEPS = 20  # approach I against rcll
P10_ALL_STEPS = 100  # the all-list against rcll, as tests/test_solver.py runs it
P10_ALL_DS = 1.0 / 256  # the all-list's O(N^2) search, cut to N = 65,536


def _k12_zero() -> None:
    wrapper("k1").launches = 0
    wrapper("k2").launches = 0


def _k12_read() -> tuple[int, int]:
    torch.cuda.synchronize()
    return wrapper("k1").launches, wrapper("k2").launches


def _diffs(cfg_a, a, cfg_b, b, fluid_only: bool = False) -> dict:
    """Max |difference| of positions, velocity and density of two final
    states (over fluid particles when asked)."""
    from repro_torch.core import solver

    sel = ~a.fixed if fluid_only else torch.ones_like(a.fixed)
    pairs = {"pos": (solver.positions(cfg_a, a), solver.positions(cfg_b, b)),
             "v": (a.fluid.v, b.fluid.v), "rho": (a.fluid.rho, b.fluid.rho)}
    return {k: float((x[sel] - y[sel]).abs().max()) for k, (x, y) in pairs.items()}


def _run_carry(cfg, st, nsteps: int):
    """``simulate_stats`` by its parts, keeping the carry (its health flags
    and its last list) for the truncation gate; K1/K2 launches counted."""
    from repro_torch.core import solver

    _k12_zero()
    carry = solver.run_persistent(cfg, solver.init_persistent(cfg, st), nsteps)
    out = solver.finalize_persistent(cfg, carry)
    return out, carry, _k12_read()


def _ulp(x: float) -> float:
    """One fp32 ulp at magnitude ``x``."""
    return 2.0 ** (math.floor(math.log2(x)) - 23) if x > 0 else 2.0**-149


def xla_decode_dacc(cfg, st) -> float:
    """A bound on what the xla sweep's fp32 cell-unit decode adds to a
    particle's acceleration, max_i Σ_j |Δ pair term|, at the packed
    initial state of a linear-EOS + Morris case.

    ``fused`` decodes q = I + rel/2 in fp32, so each displacement
    component is off by at most one ulp of the largest cell index times
    the cell edge, |e| <= sqrt(d) · max_a ulp(ncells_a) · hc_a (the
    reference decodes the integer cell delta exactly). With W' = dW/dr
    and |W''| its pointwise second derivative: the pressure term A W'
    disp/r changes by <= |A| (|W''| + 2|W'|/r) |e|, the Morris term B
    W' r/(r^2 + 0.01h^2) dv by <= |B| |dv| (|W''|/r + |W'|/r^2) |e|.
    """
    from repro_torch.core import bspline, rcll, solver

    c = dataclasses.replace(cfg, backend="reference")
    sch = c.resolved_scheme
    if sch.has_av_term or sch.has_delta_term or sch.eos != "linear":
        raise ValueError("xla_decode_dacc covers the linear EOS + Morris scheme")
    dom = c.domain
    carry = solver.init_persistent(c, st)
    nl = solver._in_range(carry.nl, carry.order.shape[0])
    disp, r = rcll.pair_displacements(dom, carry.st.rc, nl)
    idx = nl.idx.long()
    fl = carry.st.fluid
    mj = torch.where(nl.mask, fl.m[idx], 0.0)
    inv = 1.0 / fl.rho
    por2 = sch.por2_inv(inv).abs()
    big_a = mj * (por2[:, None] + por2[idx])
    big_b = mj * 2.0 * sch.mu * inv[:, None] * inv[idx]
    dv = (fl.v[:, None, :] - fl.v[idx]).norm(dim=-1)
    h = dom.h
    rr = r / h
    w2 = bspline.alpha_d(dom.dim, h) / h**2 * torch.where(
        rr < 1.0, (3.0 * rr - 2.0).abs(), torch.where(rr < 2.0, 2.0 - rr, 0.0))
    w1 = bspline.dw_dr(r, h, dom.dim).abs()
    rs = r.clamp(min=1e-30)
    e = math.sqrt(dom.dim) * max(_ulp(float(nc)) * hc
                                 for nc, hc in zip(dom.ncells, dom.cell_sizes))
    sens = big_a * (w2 + 2.0 * w1 / rs) + big_b * dv * (w2 / rs + w1 / rs**2)
    return float((torch.where(nl.mask, sens, 0.0).sum(dim=-1) * e).max())


def p10_backends_gate(nsteps: int = P10_STEPS) -> dict:
    """``reference``, ``xla`` and ``kernel`` on taylor_green at N =
    1,048,576 with fp32 records, from one state: xla and kernel held to
    reference at tests/test_torch_solver.py's tolerances, positions and
    density 1e-6 and velocity nsteps·dt·1e-5·|acc|max (1e-4 there, |acc|
    <= 10; the larger of 10 and this state's |acc|max here), plus one
    fp32 ulp of |v|max a step: at dt = 3.4e-6 a velocity's own rounding
    (6e-8 at |v| < 1) exceeds the force term, which the CPU test's dt =
    1.9e-3 never shows. xla's velocity also carries nsteps·dt times its
    decode bound (:func:`xla_decode_dacc`): with ~426 cells an axis, its
    fp32 q = I + rel/2 rounds at 3e-5 cell units. K1/K2 launched 0 times
    by the list backends and once a step by the kernel backend; equal
    rebuilds, no overflow, no window truncation."""
    from repro_torch.core import cases, health, solver
    from repro_torch.core.precision import FP32_RECORDS

    cfg, st = cases.build_case("taylor_green", ds=P10_DS, policy=FP32_RECORDS).build()
    runs = {}
    for be in ("reference", "xla", "kernel"):
        c = dataclasses.replace(cfg, backend=be)
        t0 = time.perf_counter()
        out, carry, launches = _run_carry(c, st, nsteps)
        runs[be] = dict(cfg=c, out=out, rebuilds=carry.rebuilds, launches=launches,
                        overflow=bool(carry.overflow),
                        trunc=bool(int(carry.flags) & health.WINDOW_TRUNC),
                        s=time.perf_counter() - t0)
    ref = runs["reference"]
    cr = ref["cfg"]
    ck = runs["kernel"]["cfg"]  # K2 reads no list: |acc|max free of any list fault
    acc_max = float(solver._force_rhs_kernel(ck, solver.init_persistent(ck, st))[1]
                    .abs().max())
    v_max = float(ref["out"].fluid.v.abs().max())
    tol = {"pos": 1e-6, "rho": 1e-6,
           "v": nsteps * (cfg.dt * 1e-5 * max(10.0, acc_max) + _ulp(v_max))}
    decode = xla_decode_dacc(cfg, st)
    log(f"[10] taylor_green ds=1/1024 fp32 records: dt {cfg.dt:.4e}, |acc|max {acc_max:.4g} "
        f"at the start, |v|max {v_max:.6g} at the end, xla decode bound on |dacc| "
        f"{decode:.4g}")
    bad = []
    for be, r in runs.items():
        want = (nsteps, nsteps) if be == "kernel" else (0, 0)
        t = dict(tol, v=tol["v"] + (nsteps * cfg.dt * decode if be == "xla" else 0.0))
        d = {} if be == "reference" else _diffs(cr, ref["out"], r["cfg"], r["out"])
        log(f"[10] {be}: N {st.xn.shape[0]}, {nsteps} steps in {r['s']:.2f} s, rebuilds "
            f"{r['rebuilds']}, K1/K2 launches {r['launches']} (want {want}), overflow "
            f"{r['overflow']}, window truncation {r['trunc']}"
            + "".join(f", |d{k}| vs reference {v:.3e} (tol {t[k]:.3e})" for k, v in d.items()))
        if (r["launches"] != want or r["overflow"] or r["trunc"]
                or r["rebuilds"] != ref["rebuilds"] or any(d[k] > t[k] for k in d)):
            bad.append(be)
    if bad:
        raise AssertionError(f"phase 10 backends gate failed for {bad}")
    return runs


def p10_records_gate(runs: dict, nsteps: int = P10_STEPS) -> None:
    """``xla`` with fp16 records (the production layout) against ``xla``
    with fp32 records (``runs["xla"]``), at tests/test_fused_force.py's
    gate: velocity within 1e-6 + 1e-2 max|v|, positions within 1e-3 ds
    plus one storage quantum of the fp16 relative coordinate a step
    (hc/2 · 2^-11): the records' velocity quantization may flip the
    rounding of a stored coordinate once a step, by one quantum; at
    ds = 1/1024 a quantum is 0.56e-3 ds, against ~0.6e-3 ds at that
    test's ds = 0.1, where 1e-3 ds allows one flip."""
    from repro_torch.core import cases
    from repro_torch.core.precision import PrecisionPolicy

    cfg, st = cases.build_case("taylor_green", ds=P10_DS, backend="xla",
                               policy=PrecisionPolicy()).build()
    out, carry, launches = _run_carry(cfg, st, nsteps)
    ref = runs["xla"]
    d = _diffs(ref["cfg"], ref["out"], cfg, out)
    quantum = max(cfg.domain.cell_sizes) / 2 * 2.0**-11
    tol = {"pos": 1e-3 * cfg.ds + nsteps * quantum,
           "v": 1e-6 + 1e-2 * float(ref["out"].fluid.v.abs().max())}
    log(f"[10] xla fp16 records vs fp32 records, {nsteps} steps: |dpos| {d['pos']:.3e} "
        f"(tol {tol['pos']:.3e}; 1e-3 ds {1e-3 * cfg.ds:.3e}, a quantum {quantum:.3e}), "
        f"|dv| {d['v']:.3e} (tol {tol['v']:.3e}), |drho| {d['rho']:.3e}; K1/K2 launches "
        f"{launches}, overflow {bool(carry.overflow)}")
    if any(d[k] > tol[k] for k in tol) or launches != (0, 0) or bool(carry.overflow):
        raise AssertionError("phase 10 records gate failed")


def p10_timings() -> None:
    """Steps/s of ``run_timed(50, observe_every=10)`` and peak device
    memory for each backend at the production policy (fp16 records;
    ``reference`` reads no records), beside the card's name and limit."""
    from repro_torch.core.api import Simulation

    card = gpu_line()
    for be in ("reference", "xla", "kernel"):
        sim = Simulation.from_case("taylor_green", ds=P10_DS, backend=be)
        cfg = sim.cfg
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _k12_zero()
        res, steps_per_s = sim.run_timed(50, observe_every=10)
        launches = _k12_read()
        peak = torch.cuda.max_memory_allocated()
        want = (0, 0) if be != "kernel" else (2 * res.stats.steps,) * 2
        window = cfg.resolved_window() if be != "kernel" else "none"
        log(f"[10] {be} steps/s {steps_per_s:.3f} (run_timed(50, observe_every=10), "
            f"records {cfg.policy.records}; {card}); peak device memory {peak} bytes "
            f"({peak / 2**30:.2f} GiB); max_neighbors {cfg.max_neighbors}, auto window "
            f"{window}; rebuilds {res.stats.rebuilds}, overflow {res.stats.overflow}; "
            f"K1/K2 launches {launches} (want {want})")
        if launches != want or res.stats.overflow:
            raise AssertionError(f"phase 10 timed {be} run: launches or overflow")
        if not bool(torch.isfinite(res.state.fluid.v).all()):
            raise AssertionError(f"phase 10 timed {be} run: non-finite velocity")
        p10_step_split(cfg, sim.state, be)


def p10_step_split(cfg, st, label: str, nsteps: int = 3) -> None:
    """Where a step of one backend goes: the rebuild and the physics step
    host-timed with a synchronize after each, then one step under
    ``torch.profiler`` (device time and the device's busy share)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import solver

    carry = solver.run_persistent(cfg, solver.init_persistent(cfg, st), 1)
    torch.cuda.synchronize()
    split = {"rebuild": 0.0, "physics": 0.0}
    for _ in range(nsteps):
        t0 = time.perf_counter()
        carry = solver._rebuild(cfg, carry)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        carry = solver._physics_step(cfg, carry)
        torch.cuda.synchronize()
        split["rebuild"] += t1 - t0
        split["physics"] += time.perf_counter() - t1
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        carry = solver.step_persistent(cfg, carry)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = device_events(prof)
    device_us = sum(e.self_device_time_total for e in events)
    launches = sum(e.count for e in events if e.self_device_time_total > 0)
    log(f"[10] {label} step split (ms, synchronized): " + ", ".join(
        f"{k} {1e3 * v / nsteps:.3f}" for k, v in split.items())
        + f"; one profiled step: wall {1e3 * wall:.3f} ms, device time {device_us / 1e3:.3f} ms "
        f"in {launches} kernel launches, busy share {device_us / 1e6 / wall:.3f}")


#: Phase 10's dam-break velocity limit (xla against kernel), from readings
#: on an H100 (PERF.md §6): 4.4e-6 over its 60 steps; with each row's
#: last valid list slot dropped 2.6e-2, while positions then move by only
#: 1.5e-5, inside the 1e-4 position gate.
DAM_BREAK_DV_LIMIT = 1e-4


def p10_dam_break_gate() -> None:
    """The skinned dam break of phase 4 (~260k particles, fp32 records,
    K = 64 as in tests/test_torch_solver.py) on ``xla`` against
    ``kernel``: equal rebuild counts, at least 2 in-run rebuilds,
    positions within 1e-4 (that test's gate), velocity within
    :data:`DAM_BREAK_DV_LIMIT`, no overflow."""
    from repro_torch.core import cases, solver
    from repro_torch.core.precision import FP32_RECORDS

    ds = cases.resolve_ds("dam_break", 250_000)
    radius = 2.0 * cases.build_case("dam_break", ds=ds).h
    cfg, st = cases.build_case("dam_break", ds=ds, cell_factor=1.5, skin=0.25 * radius,
                               v0=1.0, max_neighbors=64, policy=FP32_RECORDS,
                               backend="xla").build()
    _k12_zero()
    t0 = time.perf_counter()
    carry = solver.init_persistent(cfg, st)
    steps = 0
    while steps < 400 and carry.rebuilds < 3:
        carry = solver.run_persistent(cfg, carry, 10)
        steps += 10
    out_x = solver.finalize_persistent(cfg, carry)
    lx = _k12_read()
    wall_x = time.perf_counter() - t0
    ck = dataclasses.replace(cfg, backend="kernel")
    t0 = time.perf_counter()
    out_k, stats_k = solver.simulate_stats(ck, st, steps)
    torch.cuda.synchronize()
    wall_k = time.perf_counter() - t0
    d = _diffs(cfg, out_x, ck, out_k)
    log(f"[10] dam_break N {st.xn.shape[0]}, {steps} steps: xla {wall_x:.2f} s, rebuilds "
        f"{carry.rebuilds}, overflow {bool(carry.overflow)}, K1/K2 launches {lx}; kernel "
        f"{wall_k:.2f} s, rebuilds {stats_k.rebuilds}; |dpos| {d['pos']:.3e} (tol 1e-4), "
        f"|dv| {d['v']:.3e} (limit {DAM_BREAK_DV_LIMIT:g}), |drho| {d['rho']:.3e}")
    if (carry.rebuilds != stats_k.rebuilds or carry.rebuilds - 1 < 2 or d["pos"] > 1e-4
            or d["v"] > DAM_BREAK_DV_LIMIT
            or bool(carry.overflow) or stats_k.overflow or lx != (0, 0)):
        raise AssertionError("phase 10 dam break gate failed")


def _table5_gate(label: str, cfg_a, out_a, cfg_b, out_b, ds: float) -> dict:
    """tests/test_solver.py's Table 5 gate over fluid particles: positions
    within 0.2 ds, velocity within 0.05 max|v_a| + 1e-4."""
    d = _diffs(cfg_a, out_a, cfg_b, out_b, fluid_only=True)
    vmax = float(out_a.fluid.v[~out_a.fixed].abs().max())
    tol = {"pos": 0.2 * ds, "v": 0.05 * vmax + 1e-4}
    log(f"[10] {label}: |dpos| {d['pos']:.3e} (tol {tol['pos']:.3e}), |dv| {d['v']:.3e} "
        f"(tol {tol['v']:.3e}), |drho| {d['rho']:.3e}")
    if any(d[k] > tol[k] for k in tol):
        raise AssertionError(f"phase 10 gate failed: {label}")
    return d


def p10_cell_gate(nsteps: int = P10_CELL_STEPS) -> None:
    """Approach I (``algo="cell"``, fp32 search and coordinates) at N =
    1,048,576 against ``rcll`` on the kernel backend (approach III, the
    default policy), at the Table 5 gate; K1/K2 launched 0 times by the
    absolute run."""
    from repro_torch.core import cases, solver
    from repro_torch.core.precision import PrecisionPolicy

    cfg1, st1 = cases.build_case("taylor_green", ds=P10_DS, algo="cell",
                                 policy=PrecisionPolicy(nnps="fp32", coords="fp32")).build()
    _k12_zero()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out1, stats1 = solver.simulate_stats(cfg1, st1, nsteps)
    l1 = _k12_read()
    s1 = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    cfg3, st3 = cases.build_case("taylor_green", ds=P10_DS).build()
    out3 = solver.simulate(cfg3, st3, nsteps)
    log(f"[10] cell (approach I) N {st1.xn.shape[0]}, {nsteps} steps in {s1:.2f} s "
        f"({nsteps / s1:.3f} steps/s, {gpu_line()}), peak device memory {peak} bytes, "
        f"cap {cfg1.cap(st1.xn.shape[0])}, K {cfg1.max_neighbors}; K1/K2 launches {l1}")
    if l1 != (0, 0) or not bool(torch.isfinite(out1.fluid.v).all()):
        raise AssertionError("phase 10 cell run: launches or non-finite velocity")
    _table5_gate("cell (I) vs rcll kernel (III), Table 5 gate", cfg1, out1, cfg3, out3,
                 cfg1.ds)


def p10_all_gate(nsteps: int = P10_ALL_STEPS) -> None:
    """``algo="all"`` at fp32 against ``rcll`` on the reference backend at
    fp32, at tests/test_solver.py's 5e-5 on positions, on taylor_green
    cut to ds = 1/256 (N = 65,536): the all-list search is O(N^2), ~1.1e12
    pair tests a step at N = 1,048,576."""
    from repro_torch.core import cases, solver
    from repro_torch.core.precision import PrecisionPolicy

    pol = PrecisionPolicy(nnps="fp32", coords="fp32")
    cfga, sta = cases.build_case("taylor_green", ds=P10_ALL_DS, algo="all", policy=pol).build()
    cfgr, str_ = cases.build_case("taylor_green", ds=P10_ALL_DS, backend="reference",
                                  policy=pol).build()
    _k12_zero()
    t0 = time.perf_counter()
    outa = solver.simulate(cfga, sta, nsteps)
    la = _k12_read()
    sa = time.perf_counter() - t0
    outr = solver.simulate(cfgr, str_, nsteps)
    d = _diffs(cfga, outa, cfgr, outr)
    log(f"[10] all N {sta.xn.shape[0]}, {nsteps} steps in {sa:.2f} s ({nsteps / sa:.3f} "
        f"steps/s, {gpu_line()}); vs rcll reference: |dpos| {d['pos']:.3e} (tol 5e-5), "
        f"|dv| {d['v']:.3e}, |drho| {d['rho']:.3e}; K1/K2 launches {la}")
    if d["pos"] > 5e-5 or la != (0, 0):
        raise AssertionError("phase 10 all-list gate failed")


def phase10_backends() -> None:
    """Run every gate of phase 10 (each prints its readings), then fail
    if any failed."""
    failed = []

    def gate(name, fn, *args):
        try:
            return fn(*args)
        except AssertionError as e:
            log(f"[10] {name} FAILED: {e}")
            failed.append(name)

    runs = gate("backends gate", p10_backends_gate)
    if runs is not None:
        gate("records gate", p10_records_gate, runs)
    del runs
    gate("timings", p10_timings)
    gate("dam break gate", p10_dam_break_gate)
    gate("cell gate", p10_cell_gate)
    gate("all-list gate", p10_all_gate)
    if failed:
        raise AssertionError(f"phase 10 failed: {failed}")


def _no_dv_channel(orig):
    def faulty(domain, *args, scheme):
        return orig(domain, *args, scheme=dataclasses.replace(scheme, viscosity="none"))
    return faulty


def _drop_last_valid_slot(orig):
    def faulty(*args, **kw):
        nl = orig(*args, **kw)
        n = nl.count.shape[0]
        last = nl.mask.sum(dim=1, keepdim=True) - 1
        hit = torch.arange(nl.idx.shape[1], device=nl.idx.device)[None, :] == last
        return nl._replace(idx=torch.where(hit, n, nl.idx), mask=nl.mask & ~hit)
    return faulty


#: Phase 10's gates that cannot see a fault, with the reason.
P10_BLIND_TO = {
    ("fused:no_dv_channel", "records gate"): "both of its runs are xla, faulted alike",
    ("fused:no_dv_channel", "dam break gate"): "dam_break's scheme has no Morris term",
    ("fused:no_dv_channel", "cell gate"): "neither run calls fused._pair_rhs",
    ("fused:no_dv_channel", "all-list gate"): "neither run calls fused._pair_rhs",
    ("nnps:drop_last_slot", "records gate"): "both of its runs are xla, faulted alike",
    ("nnps:drop_last_slot", "cell gate"): "neither run calls the window search",
}


def phase10_planted_faults() -> list:
    """Faults planted by monkeypatching phase 10's path (this script only):
    ``fused._pair_rhs`` without its dv (Morris) channel, and
    ``nnps.rcll_neighbors_windows`` dropping each row's last valid slot.
    Each gate of phase 10 that runs the faulted function on one side of
    its comparison must fail; :data:`P10_BLIND_TO` names the rest.
    Returns the (fault, gate) pairs that passed where they must fail."""
    from repro_torch.core import fused, nnps

    gates = (("backends gate", p10_backends_gate), ("records gate", None),  # blind
             ("dam break gate", p10_dam_break_gate),
             ("cell gate", p10_cell_gate), ("all-list gate", p10_all_gate))
    faults = (("fused:no_dv_channel", fused, "_pair_rhs", _no_dv_channel),
              ("nnps:drop_last_slot", nnps, "rcll_neighbors_windows", _drop_last_valid_slot))
    missed = []
    for fault, mod, attr, plant in faults:
        for name, gate in gates:
            if (fault, name) in P10_BLIND_TO:
                log(f"[7] {fault}: {name} not run: {P10_BLIND_TO[(fault, name)]}")
                continue
            orig = getattr(mod, attr)
            setattr(mod, attr, plant(orig))
            try:
                gate()
                missed.append((fault, name))
                log(f"[7] {fault}: {name} PASSED: the fault was not caught")
            except AssertionError as e:
                log(f"[7] {fault}: {name} failed, as it must: {e}")
            finally:
                setattr(mod, attr, orig)
    return missed


# --------------------------------------------------------------------------
# phase 11: the guarded main path
# --------------------------------------------------------------------------
P11_DS = 1.0 / 1024
P11_BLOCK = 10
P11_STEPS = 40
P11_FAULT_STEP = 15  # in the second block, so the rollback point is step 10
#: The teleport gate's rho_dev limit, as a multiple of the clean run's
#: largest observed rho_err (tests/test_health.py:144 sets its lattice's
#: limit 2.5x above that lattice's clean deviation).
P11_RHO_DEV_MARGIN = 2.0


def _same_state(a, b) -> bool:
    """Bit for bit in v, rho, rc.rel and rc.cell_xy."""
    return all(torch.equal(x, y) for x, y in (
        (a.fluid.v, b.fluid.v), (a.fluid.rho, b.fluid.rho),
        (a.rc.rel, b.rc.rel), (a.rc.cell_xy, b.rc.cell_xy)))


def _fluid_finite(state) -> bool:
    fl = ~state.fixed
    return bool(torch.isfinite(state.fluid.v[fl]).all()
                and torch.isfinite(state.fluid.rho[fl]).all())


def p11_main_case():
    """taylor_green at N = 1,048,576, fp16 records, the kernel backend."""
    from repro_torch.core import cases

    return cases.build_case("taylor_green", ds=P11_DS).build()


def p11_skinned_case(cfg, st):
    """The same flow with a Verlet skin (cell_factor 1.5, skin 0.5 r): it
    rebuilds every ~20 steps, so the steps between rebuilds update the
    carry in place. The main config (skin 0) rebuilds every step into
    fresh tensors, where an aliased snapshot cannot show."""
    from repro_torch.core import solver
    from repro_torch.core.domain import Domain

    d = cfg.domain
    sk = dataclasses.replace(cfg, domain=Domain(lo=d.lo, hi=d.hi, h=d.h, cell_factor=1.5,
                                                periodic=d.periodic), skin=0.5 * d.radius)
    return sk, solver.init_state(sk, solver.positions(cfg, st), st.fluid.v, st.fluid.m,
                                 st.fluid.rho)


def _guarded(cfg, st, policy=None, **kw):
    from repro_torch.core import recovery

    policy = policy or recovery.GuardPolicy(block=P11_BLOCK)
    return recovery.run_guarded(cfg, st, kw.pop("nsteps", P11_STEPS), policy, **kw)


def p11_clean(ctx: dict) -> None:
    """(a) the clean guarded run equals the unguarded one bit for bit, no
    events, K1 and K2 launched once a step; (g)'s checkpoints saved."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core import solver

    cfg, st = ctx["cfg"], ctx["st"]
    mgr = CheckpointManager(ctx["ckpt_dir"], keep=0)
    _k12_zero()
    out, stats, rep, rows = _guarded(cfg, st, observe_every=P11_BLOCK, checkpoint=mgr,
                                     checkpoint_every=1)
    l1, l2 = _k12_read()
    mgr.close()
    ref, ref_stats = solver.simulate_stats(cfg, st, P11_STEPS)
    ctx["clean"], ctx["clean_rebuilds"] = out, stats.rebuilds
    ctx["clean_rho_err"] = max(float(r[3]) for r in rows)
    same = _same_state(out, ref)
    log(f"[11a] clean: {P11_STEPS} steps in blocks of {P11_BLOCK}: events "
        f"{[e.action for e in rep.events]}, blocks {rep.blocks}, bit-equal to simulate_stats "
        f"{same}; rebuilds {stats.rebuilds}/{ref_stats.rebuilds}; K1/K2 launches {l1}/{l2} "
        f"(want {P11_STEPS} each: K1 packs the records every step); rho_err at the block ends "
        f"{[float(r[3]) for r in rows]}; checkpoints {CheckpointManager(ctx['ckpt_dir']).all_steps()}")
    if rep.events or not same or (l1, l2) != (P11_STEPS, P11_STEPS):
        raise AssertionError("phase 11 (a) clean gate failed")


def p11_disarm(ctx: dict) -> None:
    """(b) a NaN velocity at step 15: one disarm, the replay bit-equal to
    the clean run; on the main config and on the skinned one."""
    from repro_torch.core import health, solver

    fault = health.FaultSpec("nan_v", step=P11_FAULT_STEP)
    bad = []
    for label, cfg, st in (("main", ctx["cfg"], ctx["st"]),
                           ("skinned", ctx["sk_cfg"], ctx["sk_st"])):
        clean = ctx["clean"] if label == "main" else solver.simulate(cfg, st, P11_STEPS)
        _k12_zero()
        try:
            out, stats, rep, _ = _guarded(dataclasses.replace(cfg, fault=fault), st)
        except health.SimulationDiverged as e:
            log(f"[11b] {label}: raised {e}")
            bad.append(label)
            continue
        l1, l2 = _k12_read()
        actions = [e.action for e in rep.events]
        same = _same_state(out, clean)
        want = P11_STEPS + P11_BLOCK
        log(f"[11b] {label}: nan_v at step {P11_FAULT_STEP}: events {actions} "
            f"{[(e.step, e.checks) for e in rep.events]}, bit-equal to the clean run {same}, "
            f"K1/K2 launches {l1}/{l2} (want {want}: the replayed block), rebuilds "
            f"{stats.rebuilds}")
        if actions != ["disarm"] or not same or (l1, l2) != (want, want):
            bad.append(label)
    if bad:
        raise AssertionError(f"phase 11 (b) disarm gate failed: {bad}")


def p11_teleport(ctx: dict) -> None:
    """(c) particle 0 teleported onto particle N/2 at step 15, under a
    rho_dev limit set from the clean run's own observables."""
    from repro_torch.core import health, recovery, solver

    cfg, st = ctx["cfg"], ctx["st"]
    n = st.xn.shape[0]
    tele = dataclasses.replace(cfg, fault=health.FaultSpec(
        "teleport", step=P11_FAULT_STEP, particle=0, target=n // 2))
    probe = solver.run_persistent(tele, solver.init_persistent(tele, st), 2 * P11_BLOCK)
    spike = float(health.check_carry(tele, probe).rho_dev)
    del probe
    limit = P11_RHO_DEV_MARGIN * ctx["clean_rho_err"]
    out, _, rep, _ = _guarded(tele, st, recovery.GuardPolicy(block=P11_BLOCK,
                                                             rho_dev_limit=limit))
    events = [(e.action, e.step, e.checks, e.stats.get("rho_dev")) for e in rep.events]
    finite = _fluid_finite(out)
    log(f"[11c] teleport 0 -> {n // 2} at step {P11_FAULT_STEP}: clean run's largest rho_err "
        f"{ctx['clean_rho_err']:.6g}, limit {limit:.6g}, the unguarded teleport's rho_dev at "
        f"step {2 * P11_BLOCK} {spike:.6g}; events {events}; finite {finite}; bit-equal to "
        f"the clean run {_same_state(out, ctx['clean'])}")
    if ([e.action for e in rep.events] != ["disarm"] or "rho_dev" not in rep.events[0].checks
            or not finite):
        raise AssertionError("phase 11 (c) teleport gate failed")


def p11_cap_regrow(ctx: dict) -> None:
    """(d) capacity 2: cell_overflow at step 0, one regrow; the run equals
    a fresh run under the regrown config bit for bit."""
    from repro_torch.core import recovery, solver

    cfg, st = ctx["cfg"], ctx["st"]
    n = st.xn.shape[0]
    bad_cfg = recovery.apply_named_fault(cfg, "cap", P11_STEPS, n)
    out, stats, rep, _ = _guarded(bad_cfg, st)
    events = [(e.action, e.step, e.checks, e.detail) for e in rep.events]
    fresh = solver.simulate(rep.cfg, st, P11_STEPS)
    same_fresh = _same_state(out, fresh)
    same_clean = _same_state(out, ctx["clean"])
    log(f"[11d] capacity 2: events {events}; cap {cfg.cap(n)} -> {rep.cfg.cap(n)}; bit-equal "
        f"to a fresh run under report.cfg {same_fresh}; bit-equal to the unfaulted run at the "
        f"robust cap {cfg.cap(n)}: {same_clean} (a reading); overflow {stats.overflow}")
    if (len(rep.events) != 1 or rep.events[0].action != "regrow" or rep.events[0].step != 0
            or "cell_overflow" not in rep.events[0].checks or not same_fresh or stats.overflow):
        raise AssertionError("phase 11 (d) cap regrow gate failed")


def p11_dt_backoff(ctx: dict) -> None:
    """(e) phase 4's dam break (~250k) with dt x 8: one or more halvings
    and a finite result."""
    from repro_torch.core import cases, recovery

    ds = cases.resolve_ds("dam_break", 250_000)
    radius = 2.0 * cases.build_case("dam_break", ds=ds).h
    cfg, st = cases.build_case("dam_break", ds=ds, cell_factor=1.5, skin=0.25 * radius,
                               v0=1.0).build()
    bad_cfg = recovery.apply_named_fault(cfg, "dt", P11_STEPS, st.xn.shape[0])
    t0 = time.perf_counter()
    out, stats, rep, _ = _guarded(bad_cfg, st, recovery.GuardPolicy(block=20))
    wall = time.perf_counter() - t0
    finite = _fluid_finite(out)
    log(f"[11e] dam_break N {st.xn.shape[0]} dt {cfg.dt:.4e} x 8: events "
        f"{[(e.action, e.step, e.checks) for e in rep.events]}; final dt {rep.cfg.dt:.4e}; "
        f"finite {finite}; {stats.steps} steps, rebuilds {stats.rebuilds}, {wall:.2f} s")
    if rep.dt_halvings < 1 or not finite or stats.steps != P11_STEPS:
        raise AssertionError("phase 11 (e) dt backoff gate failed")


def p11_strict(ctx: dict) -> None:
    """(f) the NaN fault under a strict policy raises at step 10."""
    from repro_torch.core import health, recovery

    cfg = dataclasses.replace(ctx["cfg"], fault=health.FaultSpec("nan_v", step=P11_FAULT_STEP))
    try:
        _guarded(cfg, ctx["st"], recovery.GuardPolicy(block=P11_BLOCK, strict=True))
    except health.SimulationDiverged as e:
        log(f"[11f] strict: raised at step {e.step} with checks {e.checks}")
        if e.step == P11_BLOCK and "nan_v" in e.checks:
            return
        raise AssertionError("phase 11 (f) strict gate raised the wrong error") from e
    log("[11f] strict: did not raise")
    raise AssertionError("phase 11 (f) strict gate failed: no raise")


def p11_resume(ctx: dict) -> None:
    """(g) (a)'s checkpoints: the newest restores into a fresh carry equal
    to (a); with the newest file truncated the manager falls back to the
    step before it, and that carry run to the end equals (a)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core import interop, solver

    cfg, st = ctx["cfg"], ctx["st"]
    mgr = CheckpointManager(ctx["ckpt_dir"], keep=0)
    template = interop.carry_to_numpy(solver.init_persistent(cfg, st))
    ok = []
    for truncate in (False, True):
        if truncate:
            p = Path(ctx["ckpt_dir"]) / f"step_{mgr.latest_step():08d}" / "arrays.npz"
            p.write_bytes(p.read_bytes()[: p.stat().st_size // 2])
        restored, step = mgr.restore(template)
        carry = interop.carry_from_numpy(restored, st.xn.device)
        carry = solver.run_persistent(cfg, carry, P11_STEPS - step)
        same = _same_state(solver.finalize_persistent(cfg, carry), ctx["clean"])
        log(f"[11g] resume{' after truncating the newest file' if truncate else ''}: restored "
            f"step {step}, ran {P11_STEPS - step} more, bit-equal to (a) {same}, rebuilds "
            f"{carry.rebuilds} (clean {ctx['clean_rebuilds']})")
        ok.append(same and step == (P11_STEPS - P11_BLOCK if truncate else P11_STEPS))
    mgr.close()
    if not all(ok):
        raise AssertionError("phase 11 (g) resume gate failed")


def p11_readings(ctx: dict) -> None:
    """(h) readings, not gates: steps/s guarded and unguarded, one host
    snapshot's ms and bytes, one restore's ms, peak device memory."""
    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.core import recovery, solver
    from repro_torch.core.api import Simulation

    cfg, st = ctx["cfg"], ctx["st"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rates = {}
    for label, guard in (("unguarded", None), ("guarded", recovery.GuardPolicy())):
        sim = Simulation(cfg=cfg, state=st)
        _, rates[label] = sim.run_timed(P11_STEPS, observe_every=P11_BLOCK, guard=guard)
    peak = torch.cuda.max_memory_allocated()
    carry = solver.run_persistent(cfg, solver.init_persistent(cfg, st), 3)
    torch.cuda.synchronize()
    snap_ms, restore_ms = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        snap = recovery._host_snapshot(carry)
        snap_ms.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        recovery._restore(snap, cfg, cfg, st.xn.device)
        torch.cuda.synchronize()
        restore_ms.append(1e3 * (time.perf_counter() - t0))
    nbytes = sum(np.asarray(a).nbytes for a in _flatten(snap).values())
    split = p11_guard_split(cfg, st)
    log(gpu_line())
    log(f"[11h] steps/s of run_timed({P11_STEPS}, observe_every={P11_BLOCK}): unguarded "
        f"{rates['unguarded']:.3f}, guarded {rates['guarded']:.3f} (ratio "
        f"{rates['guarded'] / rates['unguarded']:.3f}); one host snapshot {nbytes} bytes in "
        f"{min(snap_ms):.3f} ms (best of 5; all {[round(x, 3) for x in snap_ms]}), one restore "
        f"{min(restore_ms):.3f} ms (all {[round(x, 3) for x in restore_ms]}); "
        f"max_memory_allocated {peak} bytes ({peak / 2**30:.2f} GiB)")
    log(f"[11h] where a guarded run_guarded({P11_STEPS}) spends its host time (synchronized "
        f"around each part): " + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items()))


def p11_guard_split(cfg, st) -> dict:
    """Host ms of one guarded run by part: the host snapshots, the health
    reductions with their word read, and the rest (init, the steps, the
    final unpack), each part synchronized before and after."""
    from repro_torch.core import recovery

    parts = {"snapshots": 0.0, "checks": 0.0}
    snapshot, check = recovery._host_snapshot, recovery._check

    def timed(key, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            if key == "checks":
                int(out.word)
            torch.cuda.synchronize()
            parts[key] += 1e3 * (time.perf_counter() - t0)
            return out
        return run

    recovery.run_guarded(cfg, st, P11_STEPS, recovery.GuardPolicy(block=P11_BLOCK))  # warm
    torch.cuda.synchronize()
    with _planted(recovery, _host_snapshot=timed("snapshots", snapshot),
                  _check=timed("checks", check)):
        t0 = time.perf_counter()
        recovery.run_guarded(cfg, st, P11_STEPS, recovery.GuardPolicy(block=P11_BLOCK))
        torch.cuda.synchronize()
        total = 1e3 * (time.perf_counter() - t0)
    return dict(total=total, **parts, rest=total - sum(parts.values()))


P11_GATES = (("(a) clean", p11_clean), ("(b) disarm", p11_disarm),
             ("(c) teleport", p11_teleport), ("(d) cap regrow", p11_cap_regrow),
             ("(e) dt backoff", p11_dt_backoff), ("(f) strict", p11_strict),
             ("(g) resume", p11_resume))


def _p11_gate(ctx: dict, name: str, fn, planted: bool = False, phase: int = 11) -> bool:
    """Run one gate of phase 11 or 12; False if it failed (an
    AssertionError or the guard's own SimulationDiverged; under a planted
    fault, any error)."""
    from repro_torch.core import health

    caught = Exception if planted else (AssertionError, health.SimulationDiverged)
    try:
        fn(ctx)
        return True
    except caught as e:
        log(f"[{phase}] {name} FAILED: {type(e).__name__}: {e}")
        return False


@contextlib.contextmanager
def _planted(mod, **attrs):
    saved = {k: getattr(mod, k) for k in attrs}
    for k, v in attrs.items():
        setattr(mod, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(mod, k, v)


def p11_planted_faults(ctx: dict) -> list:
    """Faults planted by monkeypatching the guard (this script only), each
    of which the named gates must fail: the snapshot aliasing the live
    carry (its copies dropped) -> (b); check_carry with the NaN bits
    masked off -> (b) and (f); a regrow that keeps the old capacity ->
    (d). Returns the (fault, gate) pairs that passed."""
    from repro_torch.core import health, recovery

    orig_check = health.check_carry

    def no_nan_bits(*args, **kw):
        hw = orig_check(*args, **kw)
        return hw._replace(word=hw.word & ~(health.NAN_X | health.NAN_V | health.NAN_RHO))

    plants = (
        ("aliased snapshot", dict(mod=recovery, _host_snapshot=lambda carry: carry,
                                  _to_device=lambda snap, device: snap), ("(b) disarm",)),
        ("NaN bits masked", dict(mod=health, check_carry=no_nan_bits),
         ("(b) disarm", "(f) strict")),
        ("regrow keeps the capacity", dict(
            mod=recovery, _regrown_capacity=lambda cfg, policy, occ, n: cfg.cap(n)),
         ("(d) cap regrow",)),
    )
    gates = dict(P11_GATES)
    missed = []
    for fault, attrs, names in plants:
        mod = attrs.pop("mod")
        for name in names:
            with _planted(mod, **attrs):
                caught = not _p11_gate(ctx, name, gates[name], planted=True)
            log(f"[11] planted {fault}: {name} "
                + ("failed, as it must" if caught else "PASSED: the fault was not caught"))
            if not caught:
                missed.append((fault, name))
    return missed


def phase11_guarded() -> None:
    """The guarded main path on the card: gates (a)-(g), the readings (h),
    then the three planted faults."""
    import tempfile

    cfg, st = p11_main_case()
    n = st.xn.shape[0]
    sk_cfg, sk_st = p11_skinned_case(cfg, st)
    log(f"[11] taylor_green ds=1/{round(1 / P11_DS)}: N {n}, backend "
        f"{cfg.resolved_backend}, records {cfg.policy.records}, cap {cfg.cap(n)}, dt "
        f"{cfg.dt:.4e}; skinned variant: cells {sk_cfg.domain.ncells}, skin {sk_cfg.skin:.4e}, "
        f"cap {sk_cfg.cap(n)}")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = dict(cfg=cfg, st=st, sk_cfg=sk_cfg, sk_st=sk_st, ckpt_dir=tmp)
        failed = [name for name, fn in P11_GATES if not _p11_gate(ctx, name, fn)]
        if "(a) clean" not in failed:
            p11_readings(ctx)
            missed = p11_planted_faults(ctx)
        else:
            missed = []
    log(f"[11] phase 11 in {time.perf_counter() - t0:.1f} s")
    if failed or missed:
        raise AssertionError(f"phase 11 failed: gates {failed}, planted faults not caught "
                             f"{missed}")


# --------------------------------------------------------------------------
# phase 12: the fault-isolated ensemble
# --------------------------------------------------------------------------
P12_LANES = 4
P12_BLOCK = 10
P12_STEPS = 40
P12_FAULT_STEP = 15  # in the second block, so the rollback point is step 10
#: (d)'s blocks: targets 20 and 40 end inside a block of 8, so finished
#: lanes sit frozen for part of a block, where a wrong lane select shows
#: (in blocks of 10 every target ends on a block boundary).
P12_ENGINE_BLOCK = 8
P12_ENGINE_TARGETS = (20, 40, 40, 20)


def p12_members(cfg, st) -> list:
    """P12_LANES member states: #0 the case's own, the others with seeded
    velocity perturbations of 0.01 (tests/test_ensemble.py's members)."""
    out = []
    v0 = st.fluid.v.cpu().numpy()
    for i in range(P12_LANES):
        v = v0
        if i:
            rng = np.random.default_rng(100 + i)
            v = v0 + 0.01 * rng.standard_normal(v0.shape).astype(v0.dtype)
        out.append(st._replace(fluid=st.fluid._replace(
            v=torch.as_tensor(v, device=st.xn.device))))
    return out


def _ensemble(ctx: dict, nsteps: int = P12_STEPS, policy=None, **kw):
    from repro_torch.core import ensemble

    return ensemble.run_ensemble(ctx["mcfg"], ctx["members"], nsteps,
                                 policy or ctx["policy"], **kw)


def _p12_solo_refs(ctx: dict) -> list:
    """Each member's solo unguarded run under member_config (computed once)."""
    from repro_torch.core import solver

    if "solo" not in ctx:
        ctx["solo"] = [solver.simulate(ctx["mcfg"], s, P12_STEPS) for s in ctx["members"]]
    return ctx["solo"]


def p12_clean(ctx: dict) -> None:
    """(a) the clean batch: every member healthy and bit-equal to its solo
    run, K1 and K2 launched once a batched step (not once a member); the
    folded launch's inputs held against the plain versions."""
    from repro_torch.kernels import rcll_force

    _k12_zero()
    store: dict = {}
    with capture_kernel_inputs(store):
        outs, stats, rep = _ensemble(ctx)
    l1, l2 = _k12_read()
    want = rep.blocks * P12_BLOCK
    same = [_same_state(o, r) for o, r in zip(outs, _p12_solo_refs(ctx))]
    statuses = [m.status for m in rep.members]
    log(f"[12a] clean: {P12_LANES} members x {P12_STEPS} steps in blocks of {P12_BLOCK}: "
        f"statuses {statuses}, blocks {rep.blocks}, bit-equal to their solo runs {same}; "
        f"K1/K2 launches {l1}/{l2} (want {want} each, once a batched step, not "
        f"{P12_LANES * want}); rebuilds {[s.rebuilds for s in stats]}")
    ctx.setdefault("batch", outs)  # (e)'s reference: the first clean batch
    if (statuses != ["healthy"] * P12_LANES or not all(same)
            or (l1, l2) != (want, want) or want != P12_STEPS):
        raise AssertionError("phase 12 (a) clean gate failed")
    if "k2_check" not in ctx:  # the folded launch against the plain versions, once
        a1, kw1 = store["k1"]
        a2, kw2 = store["k2"]
        check_k1(a1, kw1)
        c2 = rcll_force.check_against_plain(a2, kw2)
        ms1 = time_ms(lambda: wrapper("k1")(*a1, **kw1), reps=10)
        ms2 = time_ms(lambda: wrapper("k2")(*a2, **kw2), reps=10)
        ctx["k2_check"] = c2
        log(f"[12a] the folded launch: K1 rows16 {tuple(a1[0].shape)} into "
            f"{tuple(a1[2].shape)[0] + 1} rows, bit-identical to its plain version, "
            f"{ms1:.4f} ms; K2 rel {tuple(a2[0].shape)} {ms2:.4f} ms, {k2_summary(c2)} "
            f"(CUDA events, 10 launches one by one)")


def p12_disarm(ctx: dict) -> None:
    """(b) a NaN velocity at step 15 on member 2 alone: member 2 recovered
    with one disarm, the others healthy with no events, all four
    bit-equal to their clean solo runs; K1/K2 launched once a batched
    step, the replayed block included."""
    from repro_torch.core import health

    fault = health.FaultSpec("nan_v", step=P12_FAULT_STEP)
    _k12_zero()
    outs, _, rep = _ensemble(ctx, fault=fault, fault_members=(2,))
    l1, l2 = _k12_read()
    want = rep.blocks * P12_BLOCK
    rows = [(m.status, m.retries, [e.action for e in m.events]) for m in rep.members]
    same = [_same_state(o, r) for o, r in zip(outs, _p12_solo_refs(ctx))]
    log(f"[12b] nan_v at step {P12_FAULT_STEP} on member 2: (status, retries, events) "
        f"{rows}; blocks {rep.blocks}; bit-equal to the clean solo runs {same}; K1/K2 "
        f"launches {l1}/{l2} (want {want}: {rep.blocks} batched blocks, the replay included)")
    expect = [("healthy", 0, [])] * P12_LANES
    expect[2] = ("recovered", 1, ["disarm"])
    if rows != expect or not all(same) or (l1, l2) != (want, want) or rep.blocks != 5:
        raise AssertionError("phase 12 (b) disarm gate failed")


def p12_quarantine(ctx: dict) -> None:
    """(c) a persistent fault on member 1 (no disarm, one dt halving, no
    record degrade): member 1 quarantined with a SimulationDiverged, the
    other three bit-equal to their solo runs."""
    from repro_torch.core import health, recovery

    policy = recovery.GuardPolicy(block=P12_BLOCK, disarm_faults=False, max_dt_halvings=1,
                                  degrade_records=False)
    outs, _, rep = _ensemble(ctx, policy=policy,
                             fault=health.FaultSpec("nan_v", step=P12_FAULT_STEP),
                             fault_members=(1,))
    m = rep.members[1]
    same = [_same_state(o, r) for o, r in zip(outs, _p12_solo_refs(ctx))]
    log(f"[12c] persistent nan_v on member 1: statuses {[x.status for x in rep.members]}; "
        f"member 1 events {[(e.action, e.step) for e in m.events]}, parked at step "
        f"{m.steps}, error {type(m.error).__name__}: {str(m.error)[:120]}; bit-equal to "
        f"the solo runs {same}")
    others = [i for i in range(P12_LANES) if i != 1]
    if (m.status != "quarantined" or not isinstance(m.error, health.SimulationDiverged)
            or any(rep.members[i].status != "healthy" or not same[i] for i in others)):
        raise AssertionError("phase 12 (c) quarantine gate failed")


def p12_engine(ctx: dict) -> None:
    """(d) a LaneEngine of 3 slots takes four requests (targets 20, 40, 40,
    20; the fourth admitted when the first is done): each done state is
    bit-equal to its solo run."""
    from repro_torch.core import ensemble, recovery, solver

    policy = recovery.GuardPolicy(block=P12_ENGINE_BLOCK)
    eng = ensemble.LaneEngine(ctx["cfg"], slots=3, policy=policy)
    if "engine_solo" not in ctx:
        ctx["engine_solo"] = [solver.simulate(eng.cfg, s, n)
                              for s, n in zip(ctx["members"], P12_ENGINE_TARGETS)]
    owner, done, queue = {}, {}, list(range(len(P12_ENGINE_TARGETS)))
    while queue and eng.free_lanes:
        r = queue.pop(0)
        owner[eng.admit(ctx["members"][r], P12_ENGINE_TARGETS[r])] = r
    kinds = []
    while eng.live_lanes and eng.blocks < 16:
        evs = eng.step_block()
        kinds.append([(e.lane, e.kind, e.step) for e in evs])
        for e in evs:
            if e.kind in ("done", "diverged"):
                done[owner.pop(e.lane)] = e
        while queue and eng.free_lanes:
            r = queue.pop(0)
            owner[eng.admit(ctx["members"][r], P12_ENGINE_TARGETS[r])] = r
    same = {r: e.kind == "done" and _same_state(e.state, ctx["engine_solo"][r])
            for r, e in sorted(done.items())}
    log(f"[12d] lane engine, 3 slots, blocks of {P12_ENGINE_BLOCK}, targets "
        f"{P12_ENGINE_TARGETS}: {eng.blocks} blocks, (lane, event, step) per block "
        f"{kinds}; done states bit-equal to their solo runs {same}")
    if len(same) != len(P12_ENGINE_TARGETS) or not all(same.values()):
        raise AssertionError("phase 12 (d) lane engine gate failed")


def p12_resume(ctx: dict) -> None:
    """(e) run_ensemble checkpointing every block stops after 20 steps; its
    newest checkpoint is torn; the resume falls back to the block before
    and finishes bit-equal to (a)."""
    from repro_torch.checkpoint.manager import CheckpointManager

    ck = Path(ctx["ckpt_dir"]) / "p12"
    if ck.exists():
        shutil.rmtree(ck)
    mgr = CheckpointManager(str(ck), keep=0)
    _ensemble(ctx, nsteps=2 * P12_BLOCK, checkpoint=mgr, checkpoint_every=1)
    steps = mgr.all_steps()
    p = ck / f"step_{steps[-1]:08d}" / "arrays.npz"
    p.write_bytes(p.read_bytes()[: p.stat().st_size // 2])
    outs, stats, rep = _ensemble(ctx, checkpoint=mgr, checkpoint_every=0, resume=True)
    mgr.close()
    same = [_same_state(o, r) for o, r in zip(outs, ctx["batch"])]
    log(f"[12e] checkpoints {steps}, the newest truncated; resumed from block "
        f"{rep.resumed_from} (predecessor {rep.predecessor}), {rep.blocks} more blocks, "
        f"steps {[s.steps for s in stats]}; bit-equal to (a) {same}")
    if steps != [1, 2] or rep.resumed_from != 1 or not all(same):
        raise AssertionError("phase 12 (e) resume gate failed")


def p12_readings(ctx: dict) -> None:
    """(f) readings, not gates: member-steps/s of the batch against the same
    members one after another through run_timed, the busy share of a
    batched block under torch.profiler, one batch snapshot's bytes and ms,
    peak device memory."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.core import ensemble, recovery
    from repro_torch.core.api import Simulation

    member_steps = P12_LANES * P12_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    batch_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        _ensemble(ctx)
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    seq = {}
    for label, guard in (("unguarded", None), ("guarded", ctx["policy"])):
        wall = 0.0
        for s in ctx["members"]:
            _, rate = Simulation(cfg=ctx["mcfg"], state=s).run_timed(
                P12_STEPS, observe_every=P12_BLOCK, guard=guard)
            wall += P12_STEPS / rate
        seq[label] = member_steps / wall
    mcfg, policy = ctx["mcfg"], ctx["policy"]
    carry = ensemble._batch_init(mcfg, ensemble.stack_states(ctx["members"]))
    lanes = (np.ones(P12_LANES, np.float32), np.zeros(P12_LANES, bool),
             np.ones(P12_LANES, bool), np.full(P12_LANES, 10 * P12_STEPS))
    carry, _, _ = ensemble._ensemble_block(mcfg, carry, lanes, P12_BLOCK, policy, None)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        carry, hw, _ = ensemble._ensemble_block(mcfg, carry, lanes, P12_BLOCK, policy, None)
        hw.word.cpu()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = device_events(prof)
    device_us = sum(e.self_device_time_total for e in events)
    snap_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        snap = recovery._host_snapshot(carry)
        snap_ms.append(1e3 * (time.perf_counter() - t0))
    nbytes = sum(np.asarray(a).nbytes for a in _flatten(snap).values())
    log(gpu_line())
    log(f"[12f] member-steps/s, {P12_LANES} members x {P12_STEPS} steps: the batch "
        f"(run_ensemble, guarded, blocks of {P12_BLOCK}) {member_steps / min(batch_s):.3f} "
        f"(best of 2; walls {[round(x, 3) for x in batch_s]} s); one after another through "
        f"run_timed({P12_STEPS}, observe_every={P12_BLOCK}) unguarded "
        f"{seq['unguarded']:.3f}, guarded {seq['guarded']:.3f}; ratio batch / unguarded "
        f"{member_steps / min(batch_s) / seq['unguarded']:.3f}")
    log(f"[12f] one batched block of {P12_BLOCK} steps (a rebuild of all {P12_LANES} lanes, "
        f"the health word) under torch.profiler: wall {1e3 * wall:.3f} ms, device time "
        f"{device_us / 1e3:.3f} ms, busy share {device_us / 1e6 / wall:.3f}, "
        f"{sum(e.count for e in events)} device ops")
    log(f"[12f] one batch snapshot {nbytes} bytes in {min(snap_ms):.3f} ms (best of 3; all "
        f"{[round(x, 3) for x in snap_ms]}); max_memory_allocated of run_ensemble "
        f"{peak} bytes ({peak / 2**30:.2f} GiB)")


P12_GATES = (("(a) clean", p12_clean), ("(b) disarm", p12_disarm),
             ("(c) quarantine", p12_quarantine), ("(d) lane engine", p12_engine),
             ("(e) resume", p12_resume))


def p12_planted_faults(ctx: dict) -> list:
    """Faults planted by monkeypatching (this script only), each of which
    its gate must fail: the folded neighbor ids not shifted by lane, so
    every lane reads lane 0's cells -> (a); the lane select passing the
    stepped row of a frozen lane -> (d); the rollback splicing another
    lane's snapshot row -> (b). Returns the (fault, gate) pairs that
    passed."""
    from repro_torch.core import ensemble
    from repro_torch.kernels import ops

    def unshifted(domain, lanes, device):
        nb = ops.nb_with_sentinel(domain, device)
        c = nb.shape[0] - 1
        body = torch.where(nb[:c] == c, lanes * c, nb[:c]).repeat(lanes, 1)
        return torch.cat([body, torch.full_like(nb[:1], lanes * c)])

    def other_row(carry, snap, i):
        return ensemble._splice_lane(carry, i, ensemble._lane(snap, (i + 1) % P12_LANES))

    plants = (
        ("folded ids not shifted by lane", ops, dict(nb_lanes=unshifted), "(a) clean"),
        ("lane select passes the stepped row", ensemble,
         dict(_select_members=lambda pred, a, b: a), "(d) lane engine"),
        ("rollback splices another lane's row", ensemble, dict(_restore_lane=other_row),
         "(b) disarm"),
    )
    gates = dict(P12_GATES)
    missed = []
    for fault, mod, attrs, name in plants:
        with _planted(mod, **attrs):
            caught = not _p11_gate(ctx, name, gates[name], planted=True, phase=12)
        log(f"[12] planted {fault}: {name} "
            + ("failed, as it must" if caught else "PASSED: the fault was not caught"))
        if not caught:
            missed.append((fault, name))
    return missed


def phase12_ensemble() -> None:
    """The ensemble on the card: gates (a)-(e), the readings (f), then the
    three planted faults."""
    import tempfile

    from repro_torch.core import ensemble, recovery

    cfg, st = p11_skinned_case(*p11_main_case())
    policy = recovery.GuardPolicy(block=P12_BLOCK)
    n = st.xn.shape[0]
    t0 = time.perf_counter()
    members = p12_members(cfg, st)
    del st
    log(f"[12] {P12_LANES} members of taylor_green (skinned: cells {cfg.domain.ncells}, skin "
        f"{cfg.skin:.4e}, cap {cfg.cap(n)}) at N {n} each, {P12_LANES * n} particles; backend "
        f"{cfg.resolved_backend}, records {cfg.policy.records}, dt {cfg.dt:.4e}, "
        f"rebuild_every {P12_BLOCK}")
    with tempfile.TemporaryDirectory() as tmp:
        ctx = dict(cfg=cfg, mcfg=ensemble.member_config(cfg, policy), policy=policy,
                   members=members, ckpt_dir=tmp)
        failed = [name for name, fn in P12_GATES if not _p11_gate(ctx, name, fn, phase=12)]
        if "(a) clean" not in failed:
            p12_readings(ctx)
            missed = p12_planted_faults(ctx)
        else:
            missed = []
    log(f"[12] phase 12 in {time.perf_counter() - t0:.1f} s")
    if failed or missed:
        raise AssertionError(f"phase 12 failed: gates {failed}, planted faults not caught "
                             f"{missed}")


# --------------------------------------------------------------------------
# phase 13: SPH serving and the scenario CLI
# --------------------------------------------------------------------------
P13_DEVICE = "cuda"
P13_N = 1_048_576  # taylor_green at resolve_ds(n) = 1/1024
P13_BLOCK = 10
#: (a)'s healthy requests: different lengths, so a lane mix-up shows; the
#: second names the kernel backend "pallas", as a JAX client does.
P13_STEPS = (20, 30, 40)
P13_POISON_STEP = 3
P13_DRAIN_STEPS = 40  # (b): drained after two blocks
P13_CHAOS_STEPS = 60  # (c): the killed bucket
P13_SIBLING_N = 65_536  # (c): the sibling bucket
P13_SIBLING_STEPS = 40
P13_CLI_STEPS = 50
P13_TIMEOUT = 600.0
#: ``python -m repro.sph list --names`` of the JAX package.
P13_CASES = ["cavity", "dam_break", "poiseuille", "taylor_green"]
#: The keys and dtypes of the JAX server's ``state_npz`` for taylor_green.
P13_STATE_DTYPES = {"xn": "float32", "rc/cell_xy": "int32", "rc/rel": "float16",
                    "fluid/v": "float32", "fluid/rho": "float32", "fluid/m": "float32",
                    "fixed": "bool", "t": "float32", "kind": "int8"}
#: The keys of the JAX CLI's ``run --json`` document (an unguarded run),
#: in its order; tests/test_torch_sph_cli.py holds the port's to JAX's.
P13_RUN_KEYS = ["schema", "case", "n", "ds", "dt", "backend", "records", "nsteps",
                "observe_every", "guard", "inject", "status", "exit", "observables", "stats",
                "steps_per_sec", "validation"]


def _p13_req(nsteps: int, n: int | None = None, **kw) -> dict:
    return {"case": "taylor_green", "n": n or P13_N, "nsteps": nsteps, "records": "fp16",
            "backend": "kernel", **kw}


def _p13_env() -> dict:
    import os

    return {**os.environ, "PYTHONPATH": str(ROOT / "src")}


def _p13_solo(ctx: dict, nsteps: int, n: int | None = None):
    """A request's reference: the solo guarded run under the engine's
    member config, on the card (computed once per (n, nsteps))."""
    from repro_torch.core import ensemble, recovery
    from repro_torch.core.api import Simulation
    from repro_torch.sph import serve

    key = (n or P13_N, nsteps)
    if key not in ctx["solo"]:
        sim = Simulation.from_case("taylor_green", device=P13_DEVICE,
                                   **serve.build_overrides(_p13_req(nsteps, n)))
        mcfg = ensemble.member_config(sim.cfg, ctx["policy"])
        state, _, report, _ = recovery.run_guarded(mcfg, sim.state, nsteps, ctx["policy"])
        if report.recovered:
            raise AssertionError(f"phase 13: the solo reference ({n}, {nsteps}) recovered")
        ctx["solo"][key] = serve.state_arrays(state)
        if key[0] == P13_N:
            ctx["solo_state"] = state  # (e)'s state_npz reading
    return ctx["solo"][key]


def _p13_same(done: dict, want: dict) -> tuple[bool, bool]:
    """(keys and dtypes as JAX's, bit-equal to ``want``) of a DONE frame."""
    from repro_torch.sph import client

    got = client.final_state(done)
    layout = {k: str(v.dtype) for k, v in got.items()} == P13_STATE_DTYPES
    same = set(got) == set(want) and all(
        got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]) for k in want)
    return layout, same


def _p13_request(port: int, req: dict, out: dict, rid: str) -> None:
    """One request through the port's client; its frames, the ms to
    ACCEPTED, the first OBS and the terminal frame, and the largest frame."""
    from repro_torch.sph import client

    t0 = time.perf_counter()
    rec = {"frames": [], "max_frame": 0, "term": None}
    out[rid] = rec
    try:
        for f in client.request("127.0.0.1", port, req, timeout=P13_TIMEOUT):
            ms = 1e3 * (time.perf_counter() - t0)
            rec["frames"].append(f)
            rec["max_frame"] = max(rec["max_frame"], len(json.dumps(f)))
            key = {"accepted": "accepted_ms", "obs": "first_obs_ms"}.get(f["type"], "end_ms")
            rec.setdefault(key, ms)
            if f["type"] in client.TERMINAL:
                rec["term"] = f
    except (OSError, ValueError) as e:
        rec["error"] = f"{type(e).__name__}: {e}"


#: The name prefix of _p13_fire's client threads (_p13_parts tells the
#: clients' frame reads from the server's by it).
P13_CLIENT = "p13-client-"


@contextlib.contextmanager
def _p13_parts(parts: dict):
    """Record the wall ms of the in-process server's parts while (a) runs,
    into ``parts`` ({part: [ms, ...]}): on the engine thread the case
    build, the lane admissions, the blocks, ``encode_state``, the frame
    sends (split into ``json.dumps`` and ``sendall``) and each whole
    ``_tick``; on the client threads each frame read, split into the bytes
    off the socket and the parse. No synchronization is added: a block
    already waits for its health word."""
    import threading

    from repro_torch.core import ensemble
    from repro_torch.sph import client, serve

    def is_client():
        return threading.current_thread().name.startswith(P13_CLIENT)

    def timed(key, fn, side=None):
        def run(*args, **kw):
            if side is not None and is_client() != (side == "client"):
                return fn(*args, **kw)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                parts.setdefault(key, []).append(1e3 * (time.perf_counter() - t0))
        return run

    def send_frame(sock, obj):  # serve.send_frame's two lines, timed apart
        if is_client():
            return orig_send(sock, obj)
        t0 = time.perf_counter()
        payload = json.dumps(obj).encode()
        t1 = time.perf_counter()
        sock.sendall(serve._LEN.pack(len(payload)) + payload)
        parts.setdefault("json.dumps", []).append(1e3 * (t1 - t0))
        parts.setdefault("sendall", []).append(1e3 * (time.perf_counter() - t1))

    orig_send = serve.send_frame
    with _planted(serve.SimServer, _build=timed("case build", serve.SimServer._build),
                  _tick=timed("_tick", serve.SimServer._tick)), \
            _planted(ensemble.LaneEngine, admit=timed("admit", ensemble.LaneEngine.admit),
                     step_block=timed("step_block", ensemble.LaneEngine.step_block)), \
            _planted(serve, encode_state=timed("encode_state", serve.encode_state),
                     send_frame=send_frame,
                     _recv_exact=timed("client bytes", serve._recv_exact, "client")), \
            _planted(client, recv_frame=timed("client frame", client.recv_frame, "client")):
        yield parts


def _p13_fire(srv, reqs: dict) -> dict:
    """Fire ``reqs`` ({rid: request}) at an in-process server at once and
    wait until every client is answered or the engine has sat idle with
    nothing queued for 2 s (a request whose lane was answered under
    another's name waits forever otherwise); then drain the server."""
    import threading

    out: dict = {}
    threads = [threading.Thread(target=_p13_request, args=(srv.port, r, out, rid),
                                name=f"{P13_CLIENT}{rid}") for rid, r in reqs.items()]
    for t in threads:
        t.start()
    t0, idle_since = time.perf_counter(), None
    while any(t.is_alive() for t in threads) and time.perf_counter() - t0 < P13_TIMEOUT:
        idle = (srv.buckets and not srv.pending
                and not any(e.live_lanes for e in list(srv.buckets.values())))
        idle_since = (idle_since or time.perf_counter()) if idle else None
        if idle_since is not None and time.perf_counter() - idle_since > 2.0:
            break
        time.sleep(0.02)
    wall = time.perf_counter() - t0
    srv.request_drain()
    srv.join(120)
    for t in threads:
        t.join(60)
    out["_wall_s"] = wall
    return out


def p13_inprocess(ctx: dict) -> None:
    """(a) an in-process SimServer (4 slots, on the card): three healthy
    requests of 20, 30 and 40 steps and one poisoned (NaN velocity at
    step 3), from four concurrent clients over real sockets. Each DONE's
    state_npz has JAX's keys and dtypes and is bit-equal to its solo run;
    the poisoned one ends DIVERGED (nan_v, halve_dt, quarantine last); K1
    and K2 launch once per batched step of the bucket, and the run's first
    folded launch agrees with the plain versions; every frame is under
    MAX_FRAME."""
    from repro_torch.kernels import rcll_force
    from repro_torch.sph import serve

    want = {n: _p13_solo(ctx, n) for n in P13_STEPS}
    reqs = {f"h{n}": _p13_req(n, observe=True, return_state=True, request_id=f"h{n}")
            for n in P13_STEPS}
    reqs[f"h{P13_STEPS[1]}"]["backend"] = "pallas"
    reqs["poison"] = _p13_req(P13_STEPS[-1], observe=True, request_id="poison",
                              inject={"kind": "nan", "step": P13_POISON_STEP})
    srv = serve.SimServer(slots=4, queue=8, policy=ctx["policy"], device=P13_DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    store: dict = {}
    parts: dict = {}
    _k12_zero()
    with capture_kernel_inputs(store, first_on_host=True), _p13_parts(parts):
        out = _p13_fire(srv.start(), reqs)
    l1, l2 = _k12_read()
    peak = torch.cuda.max_memory_allocated()
    # the folded K1/K2 launch of this run against the plain versions on the
    # same inputs: the bucket's first batched step, whose four slots are
    # all finite (a later step folds the poisoned lane's NaN rows in)
    try:
        a1, kw1 = _map_tensors(store["k1"], lambda t: t.to(P13_DEVICE))
        a2, kw2 = _map_tensors(store["k2"], lambda t: t.to(P13_DEVICE))
        check_k1(a1, kw1)
        c2 = rcll_force.check_against_plain(a2, kw2)
        folded = (f"K1 rows16 {tuple(a1[0].shape)} into {tuple(a1[2].shape)[0] + 1} rows, "
                  f"bit-identical to its plain version; K2 rel {tuple(a2[0].shape)}, "
                  f"{k2_summary(c2)}")
    except (AssertionError, KeyError) as e:
        folded = f"FAILED: {type(e).__name__}: {e}"
    blocks = sum(e.blocks for e in srv.buckets.values())
    rows, ok = [], len(srv.buckets) == 1 and (l1, l2) == (blocks * P13_BLOCK,) * 2 and blocks
    for n in P13_STEPS:
        rec = out[f"h{n}"]
        term = rec["term"] or {}
        obs = [f["step"] for f in rec["frames"] if f["type"] == "obs"]
        layout, same = _p13_same(term, want[n]) if term.get("type") == "done" else (False, False)
        good = (term.get("steps") == n and layout and same
                and obs == list(range(P13_BLOCK, n, P13_BLOCK)))
        rows.append((f"h{n}", term.get("type"), term.get("steps"), obs, layout, same))
        ok = ok and good
    poison = out["poison"]["term"] or {}
    actions = [e["action"] for e in poison.get("events", [])]
    ok = ok and (poison.get("type") == "diverged" and "nan_v" in poison.get("checks", [])
                 and "halve_dt" in actions and actions[-1:] == ["quarantine"])
    biggest = max(r["max_frame"] for k, r in out.items() if k != "_wall_s")
    ok = ok and biggest < serve.MAX_FRAME and not folded.startswith("FAILED")
    log(f"[13a] in-process SimServer, 4 slots, blocks of {P13_BLOCK}: (request, terminal, "
        f"steps, OBS steps, JAX keys/dtypes, bit-equal to solo) {rows}; poisoned: "
        f"{poison.get('type')} at step {poison.get('step')}, checks {poison.get('checks')}, "
        f"events {actions}; {len(srv.buckets)} bucket, {blocks} blocks; K1/K2 launches "
        f"{l1}/{l2} (want {blocks * P13_BLOCK} each, once a batched step); largest frame "
        f"{biggest} bytes (MAX_FRAME {serve.MAX_FRAME}); the folded launch: {folded}")
    ctx["a"] = dict(out=out, peak=peak, launches=(l1, l2), blocks=blocks, parts=parts)
    if not ok:
        raise AssertionError("phase 13 (a) in-process gate failed")


def p13_drain(ctx: dict) -> None:
    """(b) a SimServer with a checkpoint directory takes a 40-step request
    and drains after two blocks: RETRY_AFTER with a token at step 20. A
    new SimServer on the same directory takes the token (ACCEPTED:
    resumed) and its DONE is bit-equal to the uninterrupted 40-step solo
    run."""
    import tempfile

    from repro_torch.sph import client, serve

    class DrainAfterTwoBlocks(serve.SimServer):
        def _tick(self):
            super()._tick()
            if any(e.blocks >= 2 for e in self.buckets.values()):
                self.request_drain()

    want = _p13_solo(ctx, P13_DRAIN_STEPS)
    with tempfile.TemporaryDirectory() as ck:
        srv = DrainAfterTwoBlocks(slots=1, queue=4, policy=ctx["policy"], checkpoint_dir=ck,
                                  device=P13_DEVICE).start()
        _, term = client.run_request("127.0.0.1", srv.port,
                                     _p13_req(P13_DRAIN_STEPS, return_state=True),
                                     timeout=P13_TIMEOUT)
        srv.join(120)
        term = term or {}
        srv2 = serve.SimServer(slots=1, queue=4, policy=ctx["policy"], checkpoint_dir=ck,
                               device=P13_DEVICE).start()
        frames, done = client.run_request(
            "127.0.0.1", srv2.port, {"resume_token": term.get("token") or "none",
                                     "return_state": True}, timeout=P13_TIMEOUT)
        srv2.request_drain()
        srv2.join(120)
    acc = frames[0] if frames else {}
    done = done or {}
    layout, same = _p13_same(done, want) if done.get("type") == "done" else (False, False)
    log(f"[13b] drained after two blocks: {term.get('type')}, token {term.get('token')}, "
        f"steps_done {term.get('steps_done')}; resumed by a new server: ACCEPTED resumed "
        f"{acc.get('resumed')}, {done.get('type')} at step "
        f"{done.get('steps')}, JAX keys/dtypes {layout}, bit-equal to the uninterrupted run "
        f"{same}")
    if not (term.get("type") == "retry_after" and term.get("token")
            and term.get("steps_done") == 2 * P13_BLOCK and acc.get("resumed") is True
            and done.get("steps") == P13_DRAIN_STEPS and layout and same):
        raise AssertionError("phase 13 (b) drain/resume gate failed")


def p13_frontend(ctx: dict) -> None:
    """(c) ``python -m repro_torch.sph serve --chaos kill`` as a subprocess
    (engine workers on the card): a 60-step request at N = 1,048,576;
    when the chaos kill has fired, a sibling request in another bucket
    (N = 65,536, 40 steps). Both DONE bit-equal to their solo runs; the
    killed bucket's stream has a recovering event and OBS at every block
    boundary, the sibling's neither a recovering event nor a gap;
    worker_restarts >= 1, recovery_s > 0; SIGTERM exits 0, drained
    cleanly."""
    import os
    import signal
    import tempfile
    import threading

    from repro_torch.sph import client

    want = _p13_solo(ctx, P13_CHAOS_STEPS)
    want_sib = _p13_solo(ctx, P13_SIBLING_STEPS, P13_SIBLING_N)
    torch.cuda.empty_cache()
    lines: list = []
    out: dict = {}
    with tempfile.TemporaryDirectory() as ck:
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.sph", "serve", "--chaos", "kill",
             "--checkpoint", ck, "--block", str(P13_BLOCK), "--slots", "2", "--port", "0",
             "--device", P13_DEVICE],
            env=_p13_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True)
        try:
            port = None
            for line in proc.stdout:
                lines.append(line.rstrip())
                if line.startswith("# serving on"):
                    port = int(line.split()[3].split(":")[1])
                    break
            if port is None:
                raise AssertionError("phase 13 (c): no banner:\n" + "\n".join(lines[-20:]))
            threading.Thread(target=lambda: lines.extend(ln.rstrip() for ln in proc.stdout),
                             daemon=True).start()
            banner_s = time.perf_counter() - t0

            def stats():
                return client.run_request("127.0.0.1", port, {"op": "stats"}, timeout=60)[1]

            ta = threading.Thread(target=_p13_request, args=(port, _p13_req(
                P13_CHAOS_STEPS, observe=True, return_state=True), out, "killed"))
            ta.start()
            deadline = time.perf_counter() + P13_TIMEOUT
            while not stats()["chaos_fired"] and time.perf_counter() < deadline:
                time.sleep(0.05)
            tb = threading.Thread(target=_p13_request, args=(port, _p13_req(
                P13_SIBLING_STEPS, P13_SIBLING_N, observe=True, return_state=True), out,
                "sibling"))
            tb.start()
            ta.join(P13_TIMEOUT)
            tb.join(P13_TIMEOUT)
            st = stats()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=180)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait(timeout=60)
    time.sleep(0.5)  # the pump thread takes the last lines
    res = {}
    for rid, ref, nsteps in (("killed", want, P13_CHAOS_STEPS),
                             ("sibling", want_sib, P13_SIBLING_STEPS)):
        rec = out.get(rid, {"frames": [], "term": None})
        term = rec["term"] or {}
        obs = [f["step"] for f in rec["frames"] if f["type"] == "obs"]
        recovering = sum(f.get("action") == "recovering" for f in rec["frames"])
        layout, same = _p13_same(term, ref) if term.get("type") == "done" else (False, False)
        res[rid] = (term.get("type"), term.get("steps") == nsteps, sorted(set(obs)),
                    recovering, layout, same)
    drained = any("# drained cleanly" in ln for ln in lines)
    log(f"[13c] frontend + workers on the card (--chaos kill, slots 2, blocks of "
        f"{P13_BLOCK}): (terminal, steps, OBS steps, recovering events, JAX keys/dtypes, "
        f"bit-equal to solo) {res}; worker_restarts {st['worker_restarts']}, recovered_lanes "
        f"{st['recovered_lanes']}, recovery_s {st['recovery_s']}; SIGTERM exit {rc}, drained "
        f"cleanly {drained}")
    ctx["c"] = dict(out=out, stats=st, banner_s=banner_s)
    k, s = res["killed"], res["sibling"]
    blocks = lambda n: list(range(P13_BLOCK, n, P13_BLOCK))
    if not (k[0] == "done" and k[1] and k[2] == blocks(P13_CHAOS_STEPS) and k[3] >= 1
            and k[4] and k[5] and s[0] == "done" and s[1] and s[3] == 0 and s[4] and s[5]
            and [f["step"] for f in out["sibling"]["frames"] if f["type"] == "obs"]
            == blocks(P13_SIBLING_STEPS)
            and st["worker_restarts"] >= 1 and (st["recovery_s"] or 0) > 0
            and rc == 0 and drained):
        log("\n".join(f"[13c]   {ln}" for ln in lines[-40:]))
        raise AssertionError("phase 13 (c) frontend gate failed")


def p13_cli(ctx: dict) -> None:
    """(d) ``python -m repro_torch.sph run taylor_green --n 1048576 --nsteps
    50 --observe-every 10 --time --json`` exits 0 with JAX's schema and
    keys, backend "kernel", status "ok"; ``list --names`` prints JAX's four
    case names."""
    cmd = [sys.executable, "-m", "repro_torch.sph"]
    run = subprocess.run(cmd + ["run", "taylor_green", "--n", str(P13_N), "--nsteps",
                                str(P13_CLI_STEPS), "--observe-every", str(P13_BLOCK),
                                "--time", "--json", "--device", P13_DEVICE],
                         env=_p13_env(), capture_output=True, text=True, timeout=600)
    names = subprocess.run(cmd + ["list", "--names"], env=_p13_env(), capture_output=True,
                           text=True, timeout=300)
    try:
        doc = json.loads(run.stdout)
    except json.JSONDecodeError:
        doc = {}
    log(f"[13d] run --json: exit {run.returncode}, schema {doc.get('schema')}, keys as "
        f"JAX's {list(doc) == P13_RUN_KEYS}, n {doc.get('n')}, backend {doc.get('backend')}, "
        f"status {doc.get('status')}, steps {doc.get('stats')}, steps_per_sec "
        f"{doc.get('steps_per_sec')}; list --names: exit {names.returncode}, "
        f"{names.stdout.split()}")
    ctx["d"] = doc
    if not (run.returncode == 0 and doc.get("schema") == "repro.sph.run/1"
            and list(doc) == P13_RUN_KEYS and doc.get("backend") == "kernel"
            and doc.get("status") == "ok" and doc.get("n") == P13_N
            and names.returncode == 0 and names.stdout.split() == P13_CASES):
        log(run.stderr[-3000:])
        raise AssertionError("phase 13 (d) CLI gate failed")


def p13_readings(ctx: dict) -> None:
    """(e) readings, not gates: per request the ms to ACCEPTED, the first
    OBS and the terminal frame; served member-steps/s of (a) against the
    same members through run_ensemble; the state_npz bytes and its encode
    and decode ms; the workers' per-block lane-checkpoint ms and spawn to
    first progress; recovery_s; the in-process server's peak memory; the
    CLI's steps/s."""
    from repro_torch.core import ensemble
    from repro_torch.core.api import Simulation
    from repro_torch.sph import serve

    log(gpu_line())
    a, c = ctx["a"], ctx["c"]
    for name, out in (("13a", a["out"]), ("13c", c["out"])):
        for rid, rec in sorted((k, v) for k, v in out.items() if k != "_wall_s"):
            log(f"[{name}e] {rid}: ACCEPTED {rec.get('accepted_ms', float('nan')):.1f} ms, "
                f"first OBS {rec.get('first_obs_ms', float('nan')):.1f} ms, "
                f"{(rec['term'] or {}).get('type')} {rec.get('end_ms', float('nan')):.1f} ms "
                f"after the request was sent; largest frame {rec['max_frame']} bytes")
    served = sum(P13_STEPS) / a["out"]["_wall_s"]
    req = _p13_req(P13_STEPS[-1])
    sim = Simulation.from_case("taylor_green", device=P13_DEVICE, **serve.build_overrides(req))
    mcfg = ensemble.member_config(sim.cfg, ctx["policy"])
    k = len(P13_STEPS)
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ensemble.run_ensemble(mcfg, [sim.state] * k, P13_STEPS[-1], ctx["policy"])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    log(f"[13e] served member-steps/s of (a) (the three healthy requests, {sum(P13_STEPS)} "
        f"member-steps beside the poisoned lane, first request sent to last answer, "
        f"{a['out']['_wall_s']:.3f} s, return_state included): {served:.3f}; "
        f"run_ensemble of {k} members x {P13_STEPS[-1]} steps, blocks of {P13_BLOCK}: "
        f"{k * P13_STEPS[-1] / min(walls):.3f} (best of 2; walls "
        f"{[round(w, 3) for w in walls]} s)")
    parts = {k: v for k, v in a["parts"].items() if k != "_tick"}
    ticks = a["parts"].get("_tick", [])
    engine = ("case build", "admit", "step_block", "encode_state", "json.dumps", "sendall")
    ranked = sorted(parts, key=lambda k: -sum(parts[k]))
    log(f"[13e] where (a)'s {1e3 * a['out']['_wall_s']:.1f} ms went (wall ms of each part: "
        f"calls, sum, largest; the engine thread's parts add up within its {len(ticks)} "
        f"ticks of {sum(ticks):.1f} ms, the clients' run beside them): "
        + "; ".join(f"{k} {len(parts[k])}, {sum(parts[k]):.1f}, {max(parts[k]):.1f}"
                    for k in ranked)
        + f"; the engine thread's parts {sum(sum(parts.get(k, [])) for k in engine):.1f} ms;"
        f" the clients' parse (frame less bytes) "
        f"{sum(parts.get('client frame', [])) - sum(parts.get('client bytes', [])):.1f} ms")
    state = ctx["solo_state"]
    enc, dec = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        blob = serve.encode_state(state)
        enc.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        serve.decode_state(blob)
        dec.append(1e3 * (time.perf_counter() - t0))
    log(f"[13e] state_npz of N {int(state.xn.shape[0])}: {len(blob)} bytes of base64 "
        f"({len(blob) / state.xn.shape[0]:.2f} a particle), encode {min(enc):.1f} ms, "
        f"decode {min(dec):.1f} ms (best of 3; {[round(x, 1) for x in enc]}, "
        f"{[round(x, 1) for x in dec]})")
    for w in c["stats"]["workers"]:
        log(f"[13e] worker w{w['wid']} ({w['tag']}): restarts {w['restarts']}, blocks "
            f"{w['blocks']}, spawn to first progress {w['first_progress_s']} s (its latest "
            f"process: CUDA context, kernel library load, case build, first block), last "
            f"per-block lane checkpoint {w['save_ms']} ms")
    log(f"[13e] frontend: banner {c['banner_s']:.1f} s after spawn; recovery_s after the "
        f"kill {c['stats']['recovery_s']}; in-process server peak max_memory_allocated "
        f"{a['peak']} bytes ({a['peak'] / 2**30:.2f} GiB); CLI run --time steps_per_sec "
        f"{ctx['d'].get('steps_per_sec')}")


P13_GATES = (("(a) in-process", p13_inprocess), ("(b) drain", p13_drain),
             ("(c) frontend", p13_frontend), ("(d) cli", p13_cli))


def p13_planted_faults(ctx: dict) -> list:
    """Faults planted by monkeypatching (this script only), each of which
    its gate must fail: ``serve.encode_state`` widening the 16-bit leaves
    to fp32 -> (a); ``SimServer._dispatch`` answering a request with its
    neighboring lane's event -> (a); ``_admit_resume`` admitting the
    checkpointed row as if at step 0 (``steps_done`` 0 and the row's step
    counter 0, so the lane runs the whole request again from the
    checkpointed state) -> (b). Returns the (fault, gate) pairs that
    passed."""
    import base64
    import io

    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.core import ensemble
    from repro_torch.sph import serve

    def widened(state):
        flat = {k: (v.float() if v.dtype in (torch.float16, torch.bfloat16) else v)
                for k, v in _flatten(state).items()}
        bio = io.BytesIO()
        np.savez(bio, **{k: v.cpu().numpy() for k, v in flat.items()})
        return base64.b64encode(bio.getvalue()).decode()

    orig_dispatch = serve.SimServer._dispatch

    def neighbor(self, key, ev):
        lanes = sorted(lane for (k, lane) in self.live if k == key)
        if ev.lane in lanes and len(lanes) > 1:
            ev = dataclasses.replace(ev, lane=lanes[(lanes.index(ev.lane) + 1) % len(lanes)])
        return orig_dispatch(self, key, ev)

    orig_resume = serve.SimServer._admit_resume
    orig_admit = ensemble.LaneEngine.admit

    def from_zero(self, p):
        def admit(engine, *args, **kw):
            if kw.get("carry_row") is not None:
                kw["carry_row"] = kw["carry_row"]._replace(steps=np.zeros((), np.int32))
                kw["steps_done"] = 0
            return orig_admit(engine, *args, **kw)

        with _planted(ensemble.LaneEngine, admit=admit):
            return orig_resume(self, p)

    plants = (
        ("encode_state widens fp16 to fp32", serve, dict(encode_state=widened),
         "(a) in-process"),
        ("_dispatch answers the neighboring lane", serve.SimServer,
         dict(_dispatch=neighbor), "(a) in-process"),
        ("_admit_resume at step 0", serve.SimServer,
         dict(_admit_resume=from_zero), "(b) drain"),
    )
    gates = dict(P13_GATES)
    missed = []
    for fault, mod, attrs, name in plants:
        with _planted(mod, **attrs):
            caught = not _p11_gate(dict(ctx), name, gates[name], planted=True, phase=13)
        log(f"[13] planted {fault}: {name} "
            + ("failed, as it must" if caught else "PASSED: the fault was not caught"))
        if not caught:
            missed.append((fault, name))
    return missed


def phase13_serving() -> None:
    """SPH serving and the CLI on the card: gates (a)-(d), the readings
    (e), then the three planted faults."""
    from repro_torch.core import recovery

    policy = recovery.GuardPolicy(block=P13_BLOCK, snapshot_every=1)
    log(f"[13] taylor_green at n {P13_N}, fp16 records, kernel backend, blocks of "
        f"{P13_BLOCK}, real sockets on 127.0.0.1, device {P13_DEVICE}")
    t0 = time.perf_counter()
    ctx = dict(policy=policy, solo={})
    failed = [name for name, fn in P13_GATES if not _p11_gate(ctx, name, fn, phase=13)]
    missed = []
    if not failed:
        p13_readings(ctx)
        missed = p13_planted_faults(ctx)
    log(f"[13] phase 13 in {time.perf_counter() - t0:.1f} s")
    if failed or missed:
        raise AssertionError(f"phase 13 failed: gates {failed}, planted faults not caught "
                             f"{missed}")


# --------------------------------------------------------------------------
# phase 14: the other model families served
# --------------------------------------------------------------------------
#: Phase 14 (a): deepseek-moe-16b at full width and depth, phase 9's request.
P14_MOE_ARCH = "deepseek-moe-16b"
P14_MOE_REQUEST = dict(batch=4, prompt_len=1024, gen=160, seed=0)
#: Phase 14 (b): every other architecture at full width, one after another
#: (arch, request overrides, layers served or 0 for all). whisper's decoder
#: context is 448 tokens; deepseek-v2-236b (2.39e11 parameters, ~479 GB
#: in bf16) keeps its widths and serves 4 of its 60 layers on one card.
P14_OTHERS = (("granite-3-8b", {}, 0), ("internlm2-20b", {}, 0), ("stablelm-1.6b", {}, 0),
              ("pixtral-12b", {}, 0), ("mamba2-130m", {}, 0), ("zamba2-1.2b", {}, 0),
              ("whisper-large-v3", {"prompt_len": 256}, 0), ("deepseek-v2-236b", {}, 4))
P14_REQUEST = dict(batch=4, prompt_len=1024, gen=32, seed=0)
#: Module globals read at call time (a CPU rehearsal sets "cpu" and the
#: SMOKE configs).
P14_DEVICE = "cuda"
P14_SMOKE = False


def p14_config(arch: str, n_layers: int = 0, kv_mode: str = "dense"):
    from repro_torch.models import registry

    cfg = registry.get_config(arch, smoke=P14_SMOKE)
    return dataclasses.replace(cfg, kv_mode=kv_mode, n_layers=n_layers or cfg.n_layers)


def p14_weights(cfg) -> dict:
    """The weights ServeRun draws for ``cfg`` from seed 0, in bf16 as drawn."""
    from repro_torch.models import registry

    with torch.inference_mode():
        return registry.init_params(torch.Generator(device=P14_DEVICE).manual_seed(0), cfg,
                                    dtype=torch.bfloat16)


def p14_modes(cfg) -> tuple:
    """The KV modes a family serves differently: both for the GQA caches
    (dense, vlm, moe); mla_moe, ssm, hybrid and encdec keep one cache."""
    return ("anchored", "dense") if cfg.family in ("dense", "vlm", "moe") else ("dense",)


def p14_expected_launches(cfg, mode: str, steps: int) -> dict:
    """K6 and K7 launches of one request: K7 runs every GQA prefill
    attention (the hybrid's shared block at each site; whisper's encoder
    self-, decoder self- and cross-attention), K6 each anchored decode
    step's attention; MLA and the SSM mixers are plain torch."""
    from repro_torch.models import hybrid

    k7 = {"dense": cfg.n_layers, "vlm": cfg.n_layers, "moe": cfg.n_layers, "mla_moe": 0,
          "ssm": 0, "hybrid": hybrid.n_sites(cfg),
          "encdec": cfg.n_enc_layers + 2 * cfg.n_layers}[cfg.family]
    anchored = mode == "anchored" and cfg.family in ("dense", "vlm", "moe")
    return {"k6": cfg.n_layers * steps if anchored else 0, "k7": k7}


@contextlib.contextmanager
def moe_drop_fractions(record: list):
    """Collect each MoE block's drop fraction (a 0-d tensor, read later)."""
    from repro_torch.models import moe

    orig = moe.moe_block

    def rec(*a, **kw):
        out, metrics = orig(*a, **kw)
        record.append(metrics["drop_frac"])
        return out, metrics

    moe.moe_block = rec
    try:
        yield record
    finally:
        moe.moe_block = orig


def p14_serve(arch: str, cfg, weights, request: dict, mode: str, gpu: str, label: str,
              store: dict | None = None) -> dict:
    """One ServeRun request on ``weights``, the K6/K7 launches counted from
    0 just before and read just after, gated against
    :func:`p14_expected_launches`; prints the readings."""
    from repro_torch.launch.serve import ServeRun

    K6, K7 = wrapper("k6"), wrapper("k7")
    run = ServeRun(arch=arch, smoke=P14_SMOKE, kv_mode=mode,
                   n_layers=cfg.n_layers, params=weights, device=P14_DEVICE, **request)
    drops: list = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K6.launches = 0
    K7.launches = 0
    with capture_kernel_inputs(store if store is not None else {}), moe_drop_fractions(drops):
        out = run.run()
    torch.cuda.synchronize()
    launches = {"k6": K6.launches, "k7": K7.launches}
    want = p14_expected_launches(cfg, mode, request["gen"])
    peak = torch.cuda.max_memory_allocated()
    drop = ""
    if drops:
        d = torch.stack(drops).float().cpu()
        n = cfg.n_layers
        drop = (f"; MoE drop fraction: prefill mean {float(d[:n].mean()):.6g} (max "
                f"{float(d[:n].max()):.6g}), decode max {float(d[n:].max()):.6g}")
    log(f"[14] {label} kv {mode}: B {request['batch']} prompt {request['prompt_len']} gen "
        f"{request['gen']}: prefill {1e3 * out['t_prefill_s']:.3f} ms, decode "
        f"{out['decode_tok_s']:.3f} tok/s; cache_bytes {out['cache_bytes']}; launches K6 "
        f"{launches['k6']}, K7 {launches['k7']}; max_memory_allocated {peak} bytes{drop}; "
        f"tokens[0, :8] {out['tokens'][0, :8].tolist()} ({gpu})")
    if launches != want:
        raise AssertionError(f"{label} {mode}: launches {launches}, expected {want}")
    if out["tokens"].shape != (request["batch"], request["gen"]):
        raise AssertionError(f"{label} {mode}: tokens of shape {out['tokens'].shape}")
    total = torch.cuda.get_device_properties(0).total_memory
    if peak >= total:
        raise AssertionError(f"{label} {mode}: peak {peak} bytes, the card has {total}")
    out.update(launches=launches, peak=peak)
    return out


def p14_first_logits(weights, cfg, request: dict, tokens=None) -> tuple:
    """The prefill's last logits and the first decode step's, greedy or
    fed ``tokens`` (B, 1), on the request's prompt and modality stubs;
    returns ((2, B, vocab) logits, the token fed)."""
    max_len = request["prompt_len"] + request["gen"]
    if cfg.kv_mode == "anchored":
        max_len = -(-max_len // cfg.kv_block) * cfg.kv_block
    return lm_teacher_forced(weights, cfg, lm_prompt(cfg, request, P14_DEVICE), max_len, 1,
                             tokens)


def p14_plain_gate(weights, cfg, request: dict, label: str, gpu: str) -> None:
    """The kernel path against the plain path (K6 and K7 through their
    plain versions), fed the same token: the prefill's last and the first
    decode step's logits within ``transformer.logit_tolerance``, and every
    K6 and K7 launch of the kernel path (every new shape of this family
    among them) within its rounding bound of its plain version on the
    same inputs. Raises AssertionError."""
    from repro_torch.models import transformer

    launches: dict = {}
    with every_launch_checked(launches):
        lk, cur = p14_first_logits(weights, cfg, request)
    with plain_lm_versions():
        lp, _ = p14_first_logits(weights, cfg, request, tokens=cur)
    if not bool(torch.isfinite(lk).all()):
        raise AssertionError(f"{label}: the kernel path's logits are not finite")
    ratio = ((lk - lp).abs() / transformer.logit_tolerance(lp)).amax(dim=(1, 2))
    log(f"[14] {label} kv {cfg.kv_mode}: kernel path vs plain path, max |dlogit| / tolerance "
        f"{float(ratio[0]):.4g} (prefill's last position), {float(ratio[1]):.4g} (first decode "
        f"step); every launch held against its plain version ({launches['k6']} K6, "
        f"{launches['k7']} K7): max err/bound K6 {launches['k6_max_ratio']:.3e}, K7 "
        f"{launches['k7_max_ratio']:.3e}, max normwise {launches['normwise']:.3e} ({gpu})")
    if float(ratio.max()) > 1.0:
        raise AssertionError(f"{label} {cfg.kv_mode}: kernel path vs plain path, max |dlogit| "
                             f"is {float(ratio.max()):.3g} x the tolerance")


def p14_moe_bit_equal(weights, cfg, request: dict) -> None:
    """Two runs of the prefill and first decode step give the same logits
    bit for bit (the MoE combine adds in one fixed order). Raises."""
    a, _ = p14_first_logits(weights, cfg, request)
    b, _ = p14_first_logits(weights, cfg, request)
    for what, x, y in (("prefill", a[0], b[0]), ("first decode", a[1], b[1])):
        if not torch.equal(x, y):
            n = int((x != y).sum())
            raise AssertionError(f"two runs differ: {n} {what} logits")


def _shuffled_combine(orig):
    """``moe.combine_positions`` with each call's k slots in a fresh
    random order: the order an atomic scatter-add might take."""
    def shuffled(order, n_tok, k):
        pos = orig(order, n_tok, k)
        return pos[:, torch.randperm(k, device=pos.device)]
    return shuffled


def p14_moe(gpu: str, missed: list) -> None:
    """(a) deepseek-moe-16b at full width and depth in both KV modes."""
    from repro_torch.models import moe

    req = P14_MOE_REQUEST
    cfg = p14_config(P14_MOE_ARCH)
    t0 = time.perf_counter()
    weights = p14_weights(cfg)
    torch.cuda.synchronize()
    log(f"[14] (a) {P14_MOE_ARCH}: {cfg.param_count(weights)} parameters drawn from seed 0 in "
        f"bf16 in {time.perf_counter() - t0:.1f} s ({gpu})")
    store: dict = {}
    tokens = {}
    for mode in ("anchored", "dense"):
        c = dataclasses.replace(cfg, kv_mode=mode)
        out = p14_serve(P14_MOE_ARCH, c, weights, req, mode, gpu, f"(a) {P14_MOE_ARCH}",
                        store if mode == "anchored" else None)
        total = req["prompt_len"] + req["gen"]
        max_len = -(-total // c.kv_block) * c.kv_block if mode == "anchored" else total
        want = expected_cache_bytes(c, req["batch"], max_len, mode)
        if out["cache_bytes"] != want:
            raise AssertionError(f"(a) {mode}: cache_bytes {out['cache_bytes']} != {want}")
        tokens[mode] = out["tokens"]
    # a second anchored request, its first 32 tokens at the first one's max_len
    # (the same cache shapes, so the same K6 grid): equal bit for bit
    max_len = -(-(req["prompt_len"] + req["gen"]) // cfg.kv_block) * cfg.kv_block
    short = {**req, "gen": min(32, req["gen"]), "max_len": max_len}
    again = p14_serve(P14_MOE_ARCH, dataclasses.replace(cfg, kv_mode="anchored"), weights, short,
                      "anchored", gpu, f"(a) {P14_MOE_ARCH} again")
    if not np.array_equal(again["tokens"], tokens["anchored"][:, :short["gen"]]):
        raise AssertionError("(a) two anchored runs gave different tokens")
    ca = lm_kernel_checks(store)
    log(f"[14] (a) K6 at the last decode step's captured inputs: {lm_summary(ca['k6'])} ({gpu})")
    log(f"[14] (a) K7 at the prefill's captured inputs: {lm_summary(ca['k7'])} ({gpu})")
    del store
    cfg_a = dataclasses.replace(cfg, kv_mode="anchored")
    p14_plain_gate(weights, cfg_a, req, f"(a) {P14_MOE_ARCH}", gpu)
    lm_profile(weights, cfg_a, phase=14, suffix=f" ({gpu})")  # where a step's time goes
    p14_moe_bit_equal(weights, cfg_a, req)
    log(f"[14] (a) two runs: the same {again['tokens'].size} tokens, and the same prefill "
        f"and first-decode logits, bit for bit ({gpu})")
    orig = moe.combine_positions
    moe.combine_positions = _shuffled_combine(orig)
    try:
        p14_moe_bit_equal(weights, cfg_a, req)
        missed.append(("MoE combine in a per-call order", "(a) bit-equality"))
        log(f"[14] (c) MoE combine in a per-call order: (a)'s bit-equality gate PASSED: the "
            f"fault was not caught ({gpu})")
    except AssertionError as e:
        log(f"[14] (c) MoE combine in a per-call order: (a)'s bit-equality gate failed, as it "
            f"must: {e} ({gpu})")
    finally:
        moe.combine_positions = orig
    del weights
    torch.cuda.empty_cache()
    log(f"[14] (a) in {time.perf_counter() - t0:.1f} s ({gpu})")


def p14_planted(label: str, mod, faults, gate, missed: list, gpu: str) -> None:
    """Each fault of ``faults`` planted in ``mod`` (K6 or K7) must fail
    ``gate()``."""
    name = "K6" if mod.__name__.endswith("rcll_kv_attention") else "K7"
    for fault in faults:
        params = mod.kernel_params
        mod.kernel_params = mod.planted_params(fault)
        try:
            gate()
            missed.append((f"{name}:{fault}", label))
            log(f"[14] (c) {name}:{fault}: {label}'s gate PASSED: the fault was not caught "
                f"({gpu})")
        except AssertionError as e:
            log(f"[14] (c) {name}:{fault}: {label}'s gate failed, as it must: {e} ({gpu})")
        finally:
            mod.kernel_params = params


def p14_others(gpu: str, missed: list) -> None:
    """(b) every other architecture at full width, one after another, each
    freed before the next is drawn; (c)'s kernel faults at whisper's
    decoder and internlm2's rep-6 shapes."""
    from repro_torch.kernels import flash_attention as k7
    from repro_torch.kernels import rcll_kv_attention as k6

    for arch, over, n_layers in P14_OTHERS:
        t0 = time.perf_counter()
        req = {**P14_REQUEST, **over}
        cfg = p14_config(arch, n_layers)
        weights = p14_weights(cfg)
        torch.cuda.synchronize()
        n_params = cfg.param_count(weights)
        cut = (f", {cfg.n_layers} of its {p14_config(arch).n_layers} layers (cut to fit one "
               f"card)" if n_layers else "")
        label = f"(b) {arch}"
        log(f"[14] {label}: {n_params} parameters in bf16{cut}, drawn in "
            f"{time.perf_counter() - t0:.1f} s ({gpu})")
        for mode in p14_modes(cfg):
            p14_serve(arch, dataclasses.replace(cfg, kv_mode=mode), weights, req, mode, gpu,
                      label)
        gate_cfg = dataclasses.replace(cfg, kv_mode=p14_modes(cfg)[0])

        def gate():
            p14_plain_gate(weights, gate_cfg, req, label, gpu)

        gate()
        if arch == "whisper-large-v3":  # the decoder's causal self-attention
            p14_planted(label, k7, ("causal_plus_one",), gate, missed, gpu)
        if arch == "internlm2-20b":  # rep 6
            p14_planted(label, k6, k6.FAULTS, gate, missed, gpu)
        del weights
        torch.cuda.empty_cache()
        log(f"[14] {label} in {time.perf_counter() - t0:.1f} s ({gpu})")


def phase14_families() -> None:
    """The other model families served at full width on the card."""
    t0 = time.perf_counter()
    gpu = gpu_line()
    missed: list = []
    p14_moe(gpu, missed)
    p14_others(gpu, missed)
    log(f"[14] phase 14 in {time.perf_counter() - t0:.1f} s ({gpu})")
    if missed:
        raise AssertionError(f"phase 14: planted faults not caught: {missed}")


# --------------------------------------------------------------------------
# phase 15: LM training (K7 forward with its logsumexp, K7b backward)
# --------------------------------------------------------------------------
P15_ARCH = "llama3.2-3b"
P15_RUN = dict(batch=2, seq=1024, steps=6, seed=0, lr=1e-3, log_every=100)
#: (b)'s and the plants' depth cut (published widths)
P15_CUT_LAYERS = 2
#: (d): ``tests/test_integration.py``'s resume test on the card (an
#: uninterrupted run, and half of it with a checkpoint then a resume, bit
#: for bit): its own case (mamba2-130m SMOKE, 24 steps of B 4 x 64, a
#: checkpoint at 12) and llama3.2-3b at full width cut to 1 layer (K7,
#: K7b; 4.9e8 parameters, each save of parameters and both moments
#: 5.9 GB), 4 steps of the main path's B 2 x 1024, the first run's last
#: step its only checkpoint.
P15_RESUME = (
    ("mamba2-130m", dict(smoke=True, steps=24, batch=4, seq=64, ckpt_every=12)),
    (P15_ARCH, dict(smoke=False, n_layers=1, steps=4, batch=2, seq=1024, ckpt_every=1000)),
)
#: Module globals read at call time (a CPU rehearsal sets "cpu" and SMOKE).
P15_DEVICE = "cuda"
P15_SMOKE = False
#: (b)'s normwise limit on each parameter's gradient, kernel path against
#: the plain path (K7 and K7b through their plain versions) on the card, in
#: bf16 ulps (2^-8 each): K7's output and K7b's dq, dk, dv are fp32 within
#: their rounding bounds of the plain versions' (~1e-6 relative) and are
#: rounded to bf16 at once, so an element may round the other way (one ulp);
#: every later bf16 product of the step may then flip as well. The CPU
#: tests' limit for two evaluations of the whole graph
#: (``tests/lm_parity.py`` ``GRAD_TOL_ULPS``, 16 ulps: JAX's jitted and
#: op-by-op gradients differ by up to 8.5) is the budget here too.
P15_GRAD_TOL_ULPS = 16
#: (c): the first loss within this of ln(vocab) + the z-loss 1e-4 ln(vocab)^2
#: (a model whose logits carry no information about the next token).
P15_FIRST_LOSS_SLACK = 0.5


def train_launches(cfg, steps: int) -> dict:
    """K7 and K7b launches of ``steps`` training steps of a dense config:
    K7 once a layer in the forward and, under ``remat="full"``, once more
    in the backward's recompute of each layer; K7b once a layer."""
    return {"k7": cfg.n_layers * (2 if cfg.remat == "full" else 1) * steps,
            "k7b": cfg.n_layers * steps}


def p15_train_run(**kw):
    from repro_torch.launch.train import TrainRun

    return TrainRun(arch=P15_ARCH, smoke=P15_SMOKE, device=P15_DEVICE, **{**P15_RUN, **kw})


def k7b_work(args, kw):
    """(pairs, fp32 operations, bf16 tensor-core operations, bytes) of one
    K7b call: 10 Dh operations per (query, visible key) pair (q.k, dO.v,
    dV += P dO, dQ += dS k, dK += dS q: five products of Dh), q, k, v, O,
    dO and lse read once and dq, dk, dv (and D) written once. With bf16
    inputs at fp32 accuracy on the tensor cores, q.k is one bf16 pass; a
    product with one fp32 operand (dO.v, dS k, dS q) takes three (its
    exact three-part bf16 split, as K7's p.v), and P dO, both fp32, six
    (the parts' products down to 2^-24). fp32 inputs take the fp32 rate."""
    q, k, v, out, lse, dout = args
    pairs, _, _, _ = k7_work((q, k, v), kw)
    b, h, lq, dh = q.shape
    units = 2 * dh * b * h * pairs  # one product of Dh per pair, 2 operations an element
    nbytes = ((q.numel() + k.numel() + v.numel()) * q.element_size()
              + (out.numel() + dout.numel() + 2 * lse.numel() + q.numel()
                 + k.numel() + v.numel()) * 4)
    if q.dtype == torch.bfloat16:
        return pairs, 0, units * (1 + 3 + 6 + 3 + 3), nbytes
    return pairs, 5 * units, 0, nbytes


def k7b_each_call(on_call):
    """Every K7b call goes through its wrapper and counter as usual, then
    ``on_call(args, kwargs, grads)`` (record it, or hold it to the plain
    version)."""
    from repro_torch.kernels import flash_attention as k7

    orig = k7.flash_attention_bwd

    def call(*a, **kw):
        out = orig(*a, **kw)
        on_call(a, kw, out)
        return out

    return _planted(k7, flash_attention_bwd=call)


def k7b_recorder(records: list, first: int):
    """``on_call`` keeping host copies of the first ``first`` calls."""
    def record(a, kw, out):
        if len(records) < first:
            records.append(_map_tensors((a, kw, out), lambda t: t.to("cpu", copy=True)))
    return record


def k7b_checker(record: dict):
    """``on_call`` holding each call to its plain version as it happens
    (``check_bwd_against_plain`` on the call's own outputs)."""
    from repro_torch.kernels import flash_attention as k7

    record.update(n=0, max_ratio=0.0, normwise=0.0)

    def check(a, kw, out):
        c = k7.check_bwd_against_plain(a, kw, grads_k=out)
        record["n"] += 1
        record["max_ratio"] = max(record["max_ratio"], c["max_ratio"])
        record["normwise"] = max(record["normwise"], c["normwise"])
    return check


def plain_train_versions():
    """Route training's attention through K7's and K7b's plain versions."""
    from repro_torch.kernels import flash_attention as k7

    return _planted(k7, flash_attention=k7.flash_attention_plain)


def p15_check_records(records: list, device: str) -> dict:
    """(a): each recorded K7b call held against the plain backward on its
    own saved inputs, on ``device``."""
    from repro_torch.kernels import flash_attention as k7

    worst = {"n": 0, "max_ratio": 0.0, "normwise": 0.0, "max_abs_err": 0.0}
    for a, kw, out in records:
        a = tuple(t.to(device) for t in a)
        c = k7.check_bwd_against_plain(a, kw, grads_k=tuple(t.to(device) for t in out))
        worst["n"] += 1
        for key in ("max_ratio", "normwise", "max_abs_err"):
            worst[key] = max(worst[key], c[key])
    return worst


def p15_grads(run, params, batch, cfg, mod, route=contextlib.nullcontext,
              times: dict | None = None) -> tuple:
    """(loss, {path: fp32 gradient}) of one ``loss_fn`` forward and
    backward of ``run``'s model, through ``route``'s attention; with
    ``times``, the forward's and the backward's ms (CUDA events) go there."""
    from repro_torch.launch.train import _seconds, _stamp, deterministic_algorithms
    from repro_torch.optim import adamw

    for p in adamw.tree_leaves(params):
        p.grad = None
    dev = torch.device(P15_DEVICE)
    with route(), deterministic_algorithms():
        t0 = _stamp(dev)
        loss, _ = mod.loss_fn(params, run._with_stubs(batch, cfg), cfg)
        t1 = _stamp(dev)
        loss.backward()
        t2 = _stamp(dev)
    if times is not None:
        if dev.type == "cuda":
            t2.synchronize()
        times.update(forward=1e3 * _seconds(t0, t1), backward=1e3 * _seconds(t1, t2))
    grads = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                grads[prefix + k] = (v.grad if v.grad is not None
                                     else torch.zeros_like(v)).detach().clone()

    walk(params)
    return float(loss.detach()), grads


def p15_step_gate(gpu: str, plant=None) -> dict:
    """(b) at the depth cut: one step's gradients from the kernel path
    (``remat="full"``) twice (bit-equal), once with ``remat="none"``
    (bit-equal; the peak memory of each read) and through the plain
    versions on the card, every parameter's within ``P15_GRAD_TOL_ULPS``
    normwise, every layer's wq / wk / wv gradient nonzero; with every K7b
    call of the kernel path held to its plain version (a). ``plant`` (a
    context) wraps the kernel path only. Raises AssertionError."""
    from repro_torch.data.pipeline import make_batch

    run = p15_train_run(n_layers=P15_CUT_LAYERS, steps=1)
    cfg, mod, dev, params, _, dcfg, _ = run.build()
    full, none = (dataclasses.replace(cfg, remat=r) for r in ("full", "none"))
    batch = make_batch(dcfg, 0, dev)
    checked: dict = {}
    peaks, times = {}, {"full": {}, "none": {}}
    with (plant or contextlib.nullcontext)():
        with k7b_each_call(k7b_checker(checked)):
            loss_k, g_k = p15_grads(run, params, batch, full, mod)
        for key, c in (("full", full), ("none", none)):
            torch.cuda.reset_peak_memory_stats()
            loss, grads = p15_grads(run, params, batch, c, mod, times=times[key])
            peaks[key] = torch.cuda.max_memory_allocated()
            if key == "full":
                loss_k2, g_k2 = loss, grads
            else:
                loss_n, g_n = loss, grads
    loss_p, g_p = p15_grads(run, params, batch, full, mod, plain_train_versions)
    res = {"loss_k": loss_k, "loss_p": loss_p, "launches_checked": checked, "peaks": peaks,
           "times": times,
           "bit_equal": all(torch.equal(g_k[k], g_k2[k]) for k in g_k) and loss_k == loss_k2,
           "remat_bit_equal": (all(torch.equal(g_k[k], g_n[k]) for k in g_k)
                               and loss_k == loss_n)}
    worst, hole = 0.0, []
    for key, gp in g_p.items():
        rel = float(torch.linalg.vector_norm(g_k[key] - gp)
                    / torch.linalg.vector_norm(gp).clamp_min(1e-30))
        if rel > worst:
            worst, res["worst_leaf"] = rel, key
    for name in ("wq", "wk", "wv"):
        g = g_k[f"layers.attn.{name}"]
        hole += [f"layer {i} {name}" for i in range(g.shape[0]) if not bool(g[i].any())]
    res["normwise"] = worst
    del params, g_k, g_k2, g_n, g_p
    torch.cuda.empty_cache()
    limit = P15_GRAD_TOL_ULPS * 2.0**-8
    if hole:
        raise AssertionError(f"(b) gradients that are all zero: {hole}")
    if worst > limit:
        raise AssertionError(f"(b) kernel path vs plain path: gradient of {res['worst_leaf']} "
                             f"normwise {worst:.4g} > {limit:g}")
    if not res["bit_equal"]:
        raise AssertionError("(b) two kernel-path steps' gradients are not bit-equal")
    if not res["remat_bit_equal"]:
        raise AssertionError("(b) the step with remat='full' and with 'none' are not bit-equal")
    return res


def p15_resume(arch: str, case: dict) -> dict:
    """(d) ``tests/test_integration.py``'s resume test on the card:
    ``case`` uninterrupted, and half of it with a checkpoint then a resume,
    bit for bit (parameters, moments, step, the resumed steps' losses)."""
    from repro_torch.launch.train import TrainRun
    from repro_torch.optim import adamw

    ck = ROOT / "build" / "p15_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    steps = case["steps"]

    def run(**kw):
        return TrainRun(arch=arch, device=P15_DEVICE, lr=1e-3, log_every=100,
                        **{**case, "smoke": case["smoke"] or P15_SMOKE, **kw}).run()

    t0 = time.perf_counter()
    ref = run()
    t1 = time.perf_counter()
    run(steps=steps // 2, ckpt_dir=str(ck))
    t2 = time.perf_counter()
    resumed = run(ckpt_dir=str(ck))
    t3 = time.perf_counter()
    same = all(torch.equal(a, b) for a, b in zip(
        adamw.tree_leaves(ref["params"]) + adamw.tree_leaves(ref["opt_state"].mu)
        + adamw.tree_leaves(ref["opt_state"].nu),
        adamw.tree_leaves(resumed["params"]) + adamw.tree_leaves(resumed["opt_state"].mu)
        + adamw.tree_leaves(resumed["opt_state"].nu)))
    n = sum(t.numel() for t in adamw.tree_leaves(ref["params"]))
    res = {"same": same, "step": int(resumed["opt_state"].step), "params": n,
           "losses": (ref["losses"], resumed["losses"]), "ref_s": t1 - t0, "half_s": t2 - t1,
           "resume_s": t3 - t2, "final": (ref["final_loss"], resumed["final_loss"]),
           "ckpt_bytes": sum(f.stat().st_size for f in ck.rglob("*") if f.is_file())}
    ref_losses = ref["losses"]
    del ref, resumed
    shutil.rmtree(ck, ignore_errors=True)
    torch.cuda.empty_cache()
    if not same or res["step"] != steps or ref_losses[steps // 2:] != res["losses"][1]:
        raise AssertionError(f"(d) {arch}: the resumed run is not bit-equal to the "
                             f"uninterrupted one (step {res['step']}; losses {res['losses']})")
    return res


def p15_main(gpu: str, batch: int) -> dict:
    """(c) the main path at full width and depth through ``TrainRun.run``:
    counts zeroed just before and read just after; the first step's K7b
    calls recorded for (a); a ``torch.profiler`` window over the second
    step (started and stopped by ``run``'s ``on_step``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import flash_attention as k7

    window: dict = {}

    def on_step(step, _loss):
        torch.cuda.synchronize()
        if step == 0:
            window["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            window["prof"].start()
            window["t0"] = time.perf_counter()
        elif step == 1:
            window["wall"] = time.perf_counter() - window["t0"]
            window["prof"].stop()

    run = p15_train_run(batch=batch)
    cfg = run.config()
    records: list = []
    torch.cuda.reset_peak_memory_stats()
    K7, K7b = wrapper("k7"), k7.flash_attention_bwd
    K7.launches = 0
    K7b.launches = 0
    t0 = time.perf_counter()
    with k7b_each_call(k7b_recorder(records, cfg.n_layers)):
        out = run.run(on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if "wall" in window:
        _log_profile("the second training step", window["prof"], window["wall"], 1, phase=15,
                     suffix=f" ({gpu})")
    res = {"launches": {"k7": K7.launches, "k7b": K7b.launches}, "wall": wall,
           "peak": torch.cuda.max_memory_allocated(), "losses": out["losses"],
           "grad_norms": out["grad_norms"], "parts": out["parts"], "records": records,
           "params": cfg.param_count(out["params"]), "batch": batch, "cfg": cfg}
    del out
    torch.cuda.empty_cache()
    return res


def p15_readings(rec: tuple, gpu: str, parent: Path | None = None) -> dict:
    """K7b at the main path's first recorded call (the last layer's):
    against its plain version, timed in a CUDA graph beside the plain
    version, its bound, the library's backward and the design in
    ``parent`` (parent, this, this, parent); the HGMMA instructions of its
    bf16 kernels (raises if one has none) and its device time by kernel."""
    from repro_torch.kernels import flash_attention as k7

    a, kw, _ = rec
    a = tuple(t.to(P15_DEVICE) for t in a)
    c = k7.check_bwd_against_plain(a, kw)
    fn = k7.flash_attention_bwd
    ms = time_ms_graph(lambda: fn(*a, **kw), reps=10)
    eager_ms = time_ms(lambda: fn(*a, **kw), reps=10)
    plain_ms = time_ms(lambda: k7.flash_attention_bwd_ref(*a, **kw), reps=3, warmup=1)
    q, k, v = (t.float().detach().requires_grad_() for t in a[:3])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    o = sdpa(q, k, v, is_causal=kw.get("causal", True), enable_gqa=True)
    lib_ms = time_ms(lambda: torch.autograd.grad(o, (q, k, v), a[5], retain_graph=True), reps=5)
    pairs, ops_n, tensor_ops, nbytes = k7b_work(a, kw)
    bms, by = bound(nbytes, ops_n, tensor_ops)
    fp32_ms = 5 * 2 * a[0].shape[-1] * a[0].shape[0] * a[0].shape[1] * pairs \
        / H100_FP32_OPS_PER_S * 1e3
    log(f"[15] K7b flash_attention_bwd {tuple(a[0].shape)} {a[0].dtype} (the main path's "
        f"first call, the last layer's): {ms:.4f} ms a call "
        f"({3 if a[0].dtype == torch.bfloat16 else 2} kernels) in a CUDA graph ({eager_ms:.4f} "
        f"ms one by one from Python; plain {plain_ms:.4f} ms), bound {bms:.4f} ms by {by} "
        f"({pairs} pairs; {tensor_ops:.4g} ops at bf16 tensor-core 989 TFLOP/s, {ops_n:.4g} at "
        f"fp32 67 TFLOP/s; {nbytes} bytes at 3.35 TB/s; all 10 Dh at the fp32 rate "
        f"{fp32_ms:.4f} ms); library (scaled_dot_product_attention's backward, fp32, causal, "
        f"GQA) {lib_ms:.4f} ms; against the plain version: max|err| {c['max_abs_err']:.3e}, "
        f"max err/bound {c['max_ratio']:.3e}, normwise {c['normwise']:.3e} (limit "
        f"{k7.BWD_NORMWISE_LIMIT:g}){parent_times(parent, 'k7b', a, kw, ms, reps=10)}"
        f"{k7b_hgmma() + kernel_split(lambda: fn(*a, **kw)) if P15_DEVICE == 'cuda' else ''} "
        f"({gpu})")
    return {"ms": ms, "plain_ms": plain_ms, "lib_ms": lib_ms, "bound_ms": bms, "bound_by": by,
            "max_abs_err": c["max_abs_err"]}


def p15_planted_faults(gpu: str) -> list:
    """(e): each K7b fault must fail (a) (every call of a depth-cut step
    held against the plain backward), and K7 launched without its
    autograd op (the silent hole: no gradient reaches wq, wk, wv) must
    fail (b)."""
    from repro_torch.kernels import flash_attention as k7

    missed = []
    for fault in k7.BACKWARD_FAULTS:
        try:
            p15_step_gate(gpu, lambda fault=fault: _planted(
                k7, backward_params=k7.planted_backward_params(fault)))
            missed.append(f"K7b:{fault}")
            log(f"[15] (e) K7b:{fault}: (a)/(b) PASSED: the fault was not caught ({gpu})")
        except AssertionError as e:
            log(f"[15] (e) K7b:{fault}: failed, as it must: {str(e)[:300]} ({gpu})")

    orig = k7.flash_attention

    def launch_only(q, k, v, *, causal=True, scale=None):
        return orig(q.detach(), k.detach(), v.detach(), causal=causal, scale=scale)

    try:
        p15_step_gate(gpu, lambda: _planted(k7, flash_attention=launch_only))
        missed.append("K7 without its autograd op")
        log(f"[15] (e) K7 without its autograd op: (b) PASSED: not caught ({gpu})")
    except AssertionError as e:
        log(f"[15] (e) K7 without its autograd op: (b) failed, as it must: {str(e)[:300]} "
            f"({gpu})")
    return missed


def phase15_training(results: dict, parent: Path | None = None) -> None:
    """LM training on the card: gates (a)-(e) and the readings (K7b
    beside the design in ``parent`` when given)."""
    from repro_torch.kernels import flash_attention as k7

    t_phase = time.perf_counter()
    gpu = gpu_line()
    t0 = time.perf_counter()
    r = p15_step_gate(gpu)
    log(f"[15] (b) {P15_ARCH}, {P15_CUT_LAYERS} layers at full width (depth cut), B "
        f"{P15_RUN['batch']} x {P15_RUN['seq']}: loss kernel path {r['loss_k']:.6f}, plain "
        f"path {r['loss_p']:.6f}; worst gradient normwise {r['normwise']:.4g} "
        f"({r.get('worst_leaf')}; limit {P15_GRAD_TOL_ULPS * 2.0**-8:g}); every layer's wq, wk, "
        f"wv gradient nonzero; two kernel-path steps bit-equal; remat 'full' and 'none' "
        f"bit-equal (loss and every gradient), peak max_memory_allocated {r['peaks']['full']} "
        f"and {r['peaks']['none']} bytes, forward {r['times']['full']['forward']:.3f} and "
        f"{r['times']['none']['forward']:.3f} ms, backward {r['times']['full']['backward']:.3f} "
        f"and {r['times']['none']['backward']:.3f} ms (one step each, CUDA events); (a) on its "
        f"{r['launches_checked']['n']} K7b calls: max err/bound "
        f"{r['launches_checked']['max_ratio']:.3e}, normwise "
        f"{r['launches_checked']['normwise']:.3e}; {time.perf_counter() - t0:.1f} s ({gpu})")

    main = None
    for batch in (P15_RUN["batch"], 1):
        try:
            main = p15_main(gpu, batch)
            break
        except torch.cuda.OutOfMemoryError as e:
            log(f"[15] (c) B {batch}: out of memory ({str(e)[:160]}); cut to B 1 ({gpu})")
            torch.cuda.empty_cache()
            if batch == 1:
                raise
    cfg = main["cfg"]
    want = train_launches(cfg, P15_RUN["steps"])
    losses, norms = main["losses"], main["grad_norms"]
    expect = math.log(cfg.vocab) + 1e-4 * math.log(cfg.vocab) ** 2
    parts = main["parts"][2:] or main["parts"]  # step 0 warms up, step 1 is profiled
    med = {k: float(np.median([p[k] for p in parts])) for k in ("forward", "backward",
                                                                "optimizer")}
    step_ms = 1e3 * sum(med.values())
    tokens = main["batch"] * P15_RUN["seq"]
    cut = "" if main["batch"] == P15_RUN["batch"] else f" (cut from B {P15_RUN['batch']})"
    log(f"[15] (c) {P15_ARCH} at full width and depth ({main['params']} parameters, fp32 "
        f"masters, seed 0, remat {cfg.remat!r}): B {main['batch']}{cut} x {P15_RUN['seq']}, "
        f"{P15_RUN['steps']} AdamW "
        f"steps through TrainRun.run in {main['wall']:.1f} s; launches K7 {main['launches']['k7']}"
        f", K7b {main['launches']['k7b']} (expected {want}); losses "
        f"{[round(x, 6) for x in losses]}; grad norms {[round(x, 5) for x in norms]}; first "
        f"loss {losses[0]:.6f} against ln(vocab) + z-loss {expect:.6f}; peak "
        f"max_memory_allocated {main['peak']} bytes ({gpu})")
    log(f"[15] (c) step time (median of steps 2-{len(main['parts']) - 1}; parts from CUDA "
        f"events, one synchronization a step): "
        f"forward {1e3 * med['forward']:.3f} ms, backward {1e3 * med['backward']:.3f} ms, "
        f"optimizer {1e3 * med['optimizer']:.3f} ms, step {step_ms:.3f} ms, "
        f"{tokens / step_ms * 1e3:.1f} tokens/s; the first step (warm-up, (a)'s host copies) "
        f"{1e3 * sum(main['parts'][0].values()):.3f} ms; the readings without remat that "
        f"PERF.md quotes (an earlier tree, another call): 392.3-417.2 ms a step, peak 69.0 "
        f"GB; the recompute's cost in this call is (b)'s backward with and without remat "
        f"({gpu})")
    results["p15"] = {"step_ms": step_ms, "peak": main["peak"], "batch": main["batch"],
                      "seq": P15_RUN["seq"], "remat": cfg.remat}
    if main["launches"] != want:
        raise AssertionError(f"(c) launches {main['launches']}, expected {want}")
    if not (all(math.isfinite(x) for x in losses + norms)):
        raise AssertionError("(c) a loss or grad norm is not finite")
    if abs(losses[0] - expect) > P15_FIRST_LOSS_SLACK:
        raise AssertionError(f"(c) first loss {losses[0]:.4f} is not within "
                             f"{P15_FIRST_LOSS_SLACK} of {expect:.4f}")

    t0 = time.perf_counter()
    a = p15_check_records(main["records"], P15_DEVICE)
    log(f"[15] (a) every K7b call of the main path's first step ({a['n']} calls, layers "
        f"{cfg.n_layers - 1}..0) against the plain backward on its saved inputs: max err/bound "
        f"{a['max_ratio']:.3e}, normwise {a['normwise']:.3e} (limit {k7.BWD_NORMWISE_LIMIT:g}),"
        f" max|err| {a['max_abs_err']:.3e}; {time.perf_counter() - t0:.1f} s ({gpu})")
    if a["n"] != cfg.n_layers:
        raise AssertionError(f"(a) {a['n']} K7b calls recorded, expected {cfg.n_layers}")
    rd = p15_readings(main["records"][0], gpu, parent)
    launches = main["launches"]["k7b"]
    del main

    for arch, case in P15_RESUME:
        t0 = time.perf_counter()
        d = p15_resume(arch, case)
        steps = case["steps"]
        size = "SMOKE" if case["smoke"] else f"{case['n_layers']} layer(s) at full width"
        log(f"[15] (d) {arch} {size} ({d['params']} parameters), B {case['batch']} x "
            f"{case['seq']}: {steps} steps uninterrupted ({d['ref_s']:.1f} s) and {steps // 2} "
            f"with a checkpoint ({d['half_s']:.1f} s) + a resume to {steps} ({d['resume_s']:.1f}"
            f" s; checkpoints {d['ckpt_bytes']} bytes): parameters, moments, step and the last "
            f"{steps // 2} losses bit-equal (final loss {d['final'][0]:.6f}); "
            f"{time.perf_counter() - t0:.1f} s ({gpu})")

    t0 = time.perf_counter()
    missed = p15_planted_faults(gpu)
    log(f"[15] (e) planted faults in {time.perf_counter() - t0:.1f} s ({gpu})")
    results["train_kernels"] = [{
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/attention.py:87", "launches": launches,
        "max_abs_err": rd["max_abs_err"], "ms": rd["ms"], "plain_ms": rd["plain_ms"],
        "bound_ms": rd["bound_ms"], "bound_by": rd["bound_by"], "library_ms": rd["lib_ms"]}]
    log(f"[15] phase 15 in {time.perf_counter() - t_phase:.1f} s ({gpu})")
    if missed:
        raise AssertionError(f"phase 15: planted faults not caught: {missed}")


# --------------------------------------------------------------------------
# phase 16: remat and the dry run on one card
# --------------------------------------------------------------------------
P16_ARCH = "llama3.2-3b"
#: (a): train_4k's 4096-token rows, B 2 (cut to 1 on an out-of-memory)
P16_RUN = dict(batch=2, seq=4096, steps=4, seed=0, lr=1e-3, log_every=100)
#: (c): the train step counted on the card and on meta (phase 15's B x L),
#: and the prefill (phase 9's B 4 x 1024)
P16_TRAIN_COUNT = (2, 1024)
P16_PREFILL = (4, 1024)
#: (c): phase 9's decode caches (B 4, prompt 1024 + 160 tokens) and the
#: cache_bytes phase 9 read for them (PERF.md)
P16_DECODE = {"anchored": (4, 1280, 429_392_320), "dense": (4, 1184, 543_162_816)}
#: (d): the planted remat's run: 2 layers at full width, one step
P16_PLANT_RUN = dict(n_layers=2, batch=1, seq=1024, steps=1)
#: Module globals read at call time (a CPU rehearsal sets "cpu" and SMOKE).
P16_DEVICE = "cuda"
P16_SMOKE = False


def p16_launch_gate(label: str, launches: dict, cfg, steps: int) -> None:
    """(a)'s gate: K7 2 x n_layers a step under remat (the forward and the
    backward's recompute), K7b n_layers a step."""
    want = train_launches(cfg, steps)
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected {want} (remat "
                             f"{cfg.remat!r})")


def k7_call_recorder(record: dict, index: int):
    """A plant over K7's ``_forward`` (every K7 call, with or without its
    logsumexp) that passes each call on and keeps host copies of call
    ``index``'s inputs (as the launch read them) and output. In a remat
    step, call n_layers is the backward's first recompute (the last
    layer's)."""
    from repro_torch.kernels import flash_attention as k7

    orig, seen = k7._forward, [0]

    def call(q, k, v, causal, scale, with_lse):
        res = orig(q, k, v, causal, scale, with_lse=with_lse)
        if seen[0] == index:
            out, _, read = res
            record.update(args=tuple(t.to("cpu", copy=True) for t in read),
                          kw={"causal": causal, "scale": scale},
                          out=out.to("cpu", copy=True), with_lse=with_lse)
        seen[0] += 1
        return res

    return _planted(k7, _forward=call)


def p16_train(gpu: str, batch: int) -> dict:
    """(a) ``TrainRun`` at 4096-token rows with the config's remat, launch
    counts zeroed just before and read just after; the first step's K7b
    calls and its first recomputed K7 call copied to the host for
    :func:`p16_long_row_checks` (held to their plain versions after the
    run: the plain versions' (L x L) fp32 score matrices, ~3.2 GB each at
    B 2, do not fit beside the step's own peak). Returns the run's
    readings, its final parameters and optimizer state."""
    from repro_torch.launch.train import TrainRun

    run = TrainRun(arch=P16_ARCH, smoke=P16_SMOKE, device=P16_DEVICE,
                   **{**P16_RUN, "batch": batch})
    cfg = run.config()
    K7, K7b = wrapper("k7"), wrapper("k7b")
    k7b_records: list = []
    k7_record: dict = {}
    torch.cuda.reset_peak_memory_stats()
    K7.launches = 0
    K7b.launches = 0
    t0 = time.perf_counter()
    with k7b_each_call(k7b_recorder(k7b_records, cfg.n_layers)), \
            k7_call_recorder(k7_record, cfg.n_layers):
        out = run.run()
    torch.cuda.synchronize()
    return {"cfg": cfg, "batch": batch, "wall": time.perf_counter() - t0,
            "launches": {"k7": K7.launches, "k7b": K7b.launches},
            "peak": torch.cuda.max_memory_allocated(), "losses": out["losses"],
            "parts": out["parts"], "params": out["params"], "opt_state": out["opt_state"],
            "k7b_records": k7b_records, "k7_record": k7_record}


def p16_long_row_checks(a: dict, gpu: str) -> list:
    """(a)'s kernel gates at the main path's own shapes and inputs: the
    first step's recomputed K7 call against the plain forward and every
    K7b call of that step against the plain backward, on the card; then
    K7 and K7b each with a fault planted (``causal_plus_one``: each query
    sees one future key) on the same inputs, which these checks must fail.
    Raises AssertionError if a clean check fails; returns the plants not
    caught."""
    from repro_torch.kernels import flash_attention as k7

    cfg, rec = a["cfg"], a["k7_record"]
    if not rec or not rec["with_lse"]:
        raise AssertionError(f"(a) K7 call {cfg.n_layers} of the first step was not the "
                             f"recompute's (with its logsumexp): {rec.get('with_lse')}")
    args = tuple(t.to(P16_DEVICE) for t in rec["args"])
    t0 = time.perf_counter()
    c7 = k7.check_against_plain(args, rec["kw"], out_k=rec["out"].to(P16_DEVICE))
    cb = p15_check_records(a["k7b_records"], P16_DEVICE)
    log(f"[16] (a) the first step's recomputed K7 call {tuple(args[0].shape)} "
        f"{args[0].dtype} (the last layer's) against the plain forward: max|err| "
        f"{c7['max_abs_err']:.3e}, max err/bound {c7['max_ratio']:.3e}, normwise "
        f"{c7['normwise']:.3e} (limit {k7.NORMWISE_LIMIT:g}); every K7b call of that step "
        f"({cb['n']} calls) against the plain backward on its saved inputs: max err/bound "
        f"{cb['max_ratio']:.3e}, normwise {cb['normwise']:.3e} (limit "
        f"{k7.BWD_NORMWISE_LIMIT:g}), max|err| {cb['max_abs_err']:.3e}; "
        f"{time.perf_counter() - t0:.1f} s ({gpu})")
    if cb["n"] != cfg.n_layers:
        raise AssertionError(f"(a) {cb['n']} K7b calls recorded, expected {cfg.n_layers}")
    b_args, b_kw, _ = a["k7b_records"][0]
    b_args = tuple(t.to(P16_DEVICE) for t in b_args)
    missed = []
    for name, plant, check in (
            ("K7 causal_plus_one", lambda: _planted(
                k7, kernel_params=k7.planted_params("causal_plus_one")),
             lambda: k7.check_against_plain(args, rec["kw"])),
            ("K7b causal_plus_one", lambda: _planted(
                k7, backward_params=k7.planted_backward_params("causal_plus_one")),
             lambda: k7.check_bwd_against_plain(b_args, b_kw))):
        with plant():
            try:
                check()
                missed.append(f"(a) {name}")
                log(f"[16] (a) {name} at {tuple(args[0].shape)}: the check PASSED: not "
                    f"caught ({gpu})")
            except AssertionError as e:
                log(f"[16] (a) {name} at {tuple(args[0].shape)}: the check failed, as it "
                    f"must: {str(e)[:200]} ({gpu})")
    return missed


def p16_dryrun_start(out_dir: Path) -> subprocess.Popen:
    """(b): ``python -m repro_torch.launch.dryrun --all --smoke`` on meta
    (no card: ``CUDA_VISIBLE_DEVICES`` empty), the registry's 32 cells at
    SMOKE size in one process beside the card work. The CPU tests run
    every cell at full size on meta (``tests/test_torch_dryrun_full_*.py``);
    here (c) runs the full-size cells it holds to the card."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
    with open(out_dir / "log.txt", "w") as f:
        return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
                                 "--smoke", "--out", str(out_dir)], cwd=ROOT, env=env,
                                stdout=f, stderr=subprocess.STDOUT)


def p16_dryrun_gate(proc: subprocess.Popen, out_dir: Path, gpu: str) -> None:
    """(b)'s gate: the process exits 0 and every cell's record is ``ok``."""
    from repro_torch.models import registry

    rc = proc.wait(timeout=600)
    failed = []
    for arch, shape in registry.runnable_cells(smoke=True):
        f = out_dir / f"{arch}__{shape}__1.json"
        rec = json.loads(f.read_text()) if f.exists() else {"ok": False}
        if not rec["ok"]:
            failed.append((arch, shape, rec.get("error")))
    if rc != 0 or failed:
        raise AssertionError(f"(b) the dry run's CLI: exit {rc}, cells not ok {failed[:4]}; "
                             f"{(out_dir / 'log.txt').read_text()[-400:]}")
    log(f"[16] (b) python -m repro_torch.launch.dryrun --all --smoke on meta "
        f"(CUDA_VISIBLE_DEVICES empty): exit 0, {len(registry.runnable_cells(smoke=True))} "
        f"cells ok ({gpu})")


#: (b): the full-size cells run on JAX's meshes beside the CLI's SMOKE run
P16_MESH_CELLS = (("llama3.2-3b", "train_4k"), ("llama3.2-3b", "decode_32k"))


def p16_mesh_dryrun_start(out_dir: Path) -> list:
    """(b) on JAX's meshes, started when the script starts (they run on the
    host's CPU beside every phase, one core each, at a lower priority):
    ``python -m repro_torch.launch.dryrun --all --both --smoke`` (the 32
    cells on 16x16 and 2x16x16, each over a fake process group of 256 or
    512 ranks) and, one process each, :data:`P16_MESH_CELLS` at full size
    with ``--both``. Returns [(label, Popen, out dir, start time)]."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
    runs = [("--all --both --smoke", ["--all", "--both", "--smoke"], out_dir / "smoke")]
    runs += [(f"{a} {sh} --both", ["--arch", a, "--shape", sh, "--both"], out_dir / "full")
             for a, sh in P16_MESH_CELLS]
    procs = []
    for i, (label, args, out) in enumerate(runs):
        out.mkdir(parents=True, exist_ok=True)
        with open(out_dir / f"log{i}.txt", "w") as f:
            procs.append((label, subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", *args, "--out", str(out)],
                cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT,
                preexec_fn=lambda: os.nice(10)), out, time.perf_counter()))
    return procs


def p16_mesh_dryrun_gate(procs: list, out_dir: Path, gpu: str) -> None:
    """(b)'s gate on JAX's meshes: each process exits 0 (the CLI fails where
    a fake mesh's process group outlives its cell); the 64 SMOKE records
    ``ok``, named 16x16 and 2x16x16 with n_chips 256 and 512, every train
    record with at least one collective; the full-size cells ``ok``, their
    per-device FLOPs, bytes, collective bytes and seconds printed."""
    from repro_torch.models import registry

    for i, (label, proc, _, t0) in enumerate(procs):
        rc = proc.wait(timeout=900)
        if rc != 0:
            text = (out_dir / f"log{i}.txt").read_text()
            fails = [line for line in text.splitlines() if " FAIL " in line]
            raise AssertionError(f"(b) dryrun {label}: exit {rc}; {fails[:6]}; {text[-300:]}")
    smoke = procs[0][2]
    bad, n = [], 0
    for arch, shape in registry.runnable_cells(smoke=True):
        for mesh, chips in (("16x16", 256), ("2x16x16", 512)):
            f = smoke / f"{arch}__{shape}__{mesh}.json"
            rec = json.loads(f.read_text()) if f.exists() else {"ok": False}
            n += rec["ok"]
            if (not rec["ok"] or rec["mesh"] != mesh or rec["n_chips"] != chips
                    or (rec["kind"] == "train" and not sum(rec["collectives"]["counts"].values()))):
                bad.append((arch, shape, mesh, rec.get("error")))
    if bad or n != 64:
        raise AssertionError(f"(b) --all --both --smoke: {n} ok records of 64; bad {bad[:4]}")
    secs = sum(json.loads(f.read_text())["t_total_s"] for f in smoke.glob("*.json"))
    log(f"[16] (b) python -m repro_torch.launch.dryrun --all --both --smoke on the host's CPU "
        f"(meta tensors, fake process groups of 256 and 512 ranks; CUDA_VISIBLE_DEVICES "
        f"empty): exit 0, 64 records ok (16x16 n_chips 256, 2x16x16 n_chips 512), every "
        f"train record with collectives, no process group left; cells {secs:.1f} s (CPU)")
    for arch, shape in P16_MESH_CELLS:
        for mesh in ("16x16", "2x16x16"):
            rec = json.loads((procs[1][2] / f"{arch}__{shape}__{mesh}.json").read_text())
            if not rec["ok"]:
                raise AssertionError(f"(b) {arch} {shape} {mesh} at full size: {rec['error']}")
            c = rec["collectives"]
            calls = [rec["kernels"].get(k, {}).get("calls", 0)
                     for k in ("flash_attention", "flash_attention_bwd", "rcll_kv_decode")]
            log(f"[16] (b) {arch} {shape} on {mesh} at full size, on the host's CPU (meta): per "
                f"device {rec['flops_per_device']} FLOPs, {rec['bytes_per_device']} bytes, "
                f"collective bytes {c['total']} (" + ", ".join(
                    f"{k} {v} in {c['counts'][k]}" for k, v in c["by_op"].items() if v)
                + f"), K7/K7b/K6 calls {calls}, "
                f"argument bytes {rec['memory']['argument_size_in_bytes']}, bound "
                f"{1e3 * max(rec['t_compute'], rec['t_memory'], rec['t_collective']):.3f} ms "
                f"({rec['bottleneck']}), useful_flops_frac {rec['useful_flops_frac']:.4f}; "
                f"{rec['t_total_s']:.1f} s on the CPU; roofline terms are the dry run's H100 "
                f"constants, not readings ({gpu})")


def p16_counted(fn) -> "object":
    """The dry run's counter over ``fn()`` on the card."""
    from repro_torch.kernels.cost import CostCounter

    with CostCounter() as c:
        fn()
    torch.cuda.synchronize()
    return c


def p16_expected_attention(cfg, b: int, l: int, steps_kind: str) -> dict:
    """The K7 and K7b FLOPs a step of ``cfg`` at B x L must count, from this
    script's own pair count (``k7_work``): K7 4 Dh a visible pair, once a
    layer (twice under remat in a train step), K7b 10 Dh once a layer."""
    h, dh = cfg.n_heads, cfg.head_dim
    q = torch.empty((b, h, l, dh), dtype=torch.bfloat16, device="meta")
    kv = torch.empty((b, cfg.n_kv, l, dh), dtype=torch.bfloat16, device="meta")
    pairs = k7_work((q, kv, kv), {"causal": True})[0]
    if steps_kind == "prefill":
        return {"flash_attention": {"calls": cfg.n_layers,
                                    "flops": cfg.n_layers * 4 * dh * b * h * pairs}}
    calls = train_launches(cfg, 1)
    return {"flash_attention": {"calls": calls["k7"],
                                "flops": calls["k7"] * 4 * dh * b * h * pairs},
            "flash_attention_bwd": {"calls": calls["k7b"],
                                    "flops": calls["k7b"] * 10 * dh * b * h * pairs}}


def p16_flop_gate(label: str, card, rec: dict, want: dict) -> None:
    """(c)'s FLOP gate: the counter's FLOPs over the card's step equal the
    dry run's record on meta exactly, and its K7 / K7b calls and FLOPs equal
    :func:`p16_expected_attention`'s."""
    got = {k: {"calls": v["calls"], "flops": v["flops"]} for k, v in card.kernels.items()}
    if card.flops != rec["flops_per_device"]:
        raise AssertionError(f"(c) {label}: {card.flops} FLOPs counted on the card, "
                             f"{rec['flops_per_device']} by the dry run on meta")
    if got != want:
        raise AssertionError(f"(c) {label}: kernel counts {got}, expected {want}")


def p16_dryrun_cell(kind: str, b: int, l: int) -> dict:
    """The dry run's record of ``P16_ARCH``'s cell at an ad hoc
    ``ShapeSpec`` (B x L), run on meta."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun

    rec = dryrun.run_cell(P16_ARCH, ShapeSpec(f"{kind}_{b}x{l}", l, b, kind), smoke=P16_SMOKE)
    if not rec["ok"]:
        raise AssertionError(f"(c) the dry run's {kind} B {b} x {l} cell failed: {rec['error']}")
    return rec


def p16_card_counts(a: dict, gpu: str) -> None:
    """(c) on (a)'s trained parameters: the train step at B 2 x 1024 and
    the prefill at B 4 x 1024 counted on the card, against the dry run's
    cells on meta; the decode cells' cache bytes against the real
    prefill's ``cache_bytes`` in both KV modes; the train cell's argument
    bytes against the card's parameters, moments, step and batch."""
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch.serve import cache_bytes
    from repro_torch.launch.train import TrainRun, train_step
    from repro_torch.models import registry
    from repro_torch.optim import adamw

    cfg, params, opt = a["cfg"], a["params"], a["opt_state"]
    mod = registry.get_module(cfg)
    dev = torch.device(P16_DEVICE)
    b, l = P16_TRAIN_COUNT
    batch = make_batch(DataConfig(vocab=cfg.vocab, seq_len=l, global_batch=b), 0, dev)
    rec = p16_dryrun_cell("train", b, l)
    mem = rec["memory"]
    card = p16_counted(lambda: train_step(mod, cfg, adamw.OptConfig(), params, opt,
                                          TrainRun._with_stubs(batch, cfg)))
    p16_flop_gate(f"train B {b} x {l}", card, rec, p16_expected_attention(cfg, b, l, "train"))
    args = sum(t.numel() * t.element_size() for t in adamw.tree_leaves(params)
               + adamw.tree_leaves(opt.mu) + adamw.tree_leaves(opt.nu)
               + [opt.step, batch["tokens"], batch["labels"]])
    if args != mem["argument_size_in_bytes"]:
        raise AssertionError(f"(c) argument bytes: the card's {args}, the dry run's "
                             f"{mem['argument_size_in_bytes']}")
    log(f"[16] (c) train step B {b} x {l} ({cfg.remat!r} remat): {card.flops} FLOPs counted on "
        f"the card = the dry run's on meta (K7 {card.kernels['flash_attention']['calls']} calls "
        f"{card.kernels['flash_attention']['flops']} FLOPs, K7b "
        f"{card.kernels['flash_attention_bwd']['calls']} calls "
        f"{card.kernels['flash_attention_bwd']['flops']} FLOPs, as k7_work's pairs give); bytes "
        f"{card.bytes} on the card, {rec['bytes_per_device']} on meta; argument bytes {args} = "
        f"the dry run's; dry-run bound {1e3 * max(rec['t_compute'], rec['t_memory']):.3f} ms "
        f"({rec['bottleneck']}) ({gpu})")

    b, l = P16_PREFILL
    prompt = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (b, l)),
                             dtype=torch.int32, device=dev)
    rec = p16_dryrun_cell("prefill", b, l)
    with torch.no_grad():
        card = p16_counted(lambda: mod.prefill(params, prompt, cfg, l))
    p16_flop_gate(f"prefill B {b} x {l}", card, rec, p16_expected_attention(cfg, b, l,
                                                                           "prefill"))
    log(f"[16] (c) prefill B {b} x {l}: {card.flops} FLOPs counted on the card = the dry run's "
        f"on meta (K7 {card.kernels['flash_attention']['calls']} calls); dry-run bound "
        f"{1e3 * max(rec['t_compute'], rec['t_memory']):.3f} ms ({gpu})")

    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun

    for mode, (b, max_len, phase9) in P16_DECODE.items():
        cfg_m = dataclasses.replace(cfg, kv_mode=mode)
        spec = registry.input_specs(cfg_m, ShapeSpec("decode", max_len, b, "decode"))["cache"]
        want = dryrun.tree_bytes(spec)
        with torch.no_grad():
            _, cache = mod.prefill(params, prompt, cfg_m, max_len)
        got = cache_bytes(cache)
        del cache
        log(f"[16] (c) decode cell, kv {mode}, B {b}, max_len {max_len}: cache bytes {want} "
            f"(dry run) = {got} (ServeRun's cache_bytes of the card's prefill cache; phase 9 "
            f"read {phase9}, from the shapes {expected_cache_bytes(cfg, b, max_len, mode)}) "
            f"({gpu})")
        if want != got:
            raise AssertionError(f"(c) kv {mode}: the dry run's cache bytes {want} != {got}")


def p16_count_plants(a: dict, gpu: str) -> list:
    """(d): K7's count without the causal half, and K7b's count left out,
    must each fail (c)'s FLOP gate (the train step at B 2 x 1024)."""
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.kernels import flash_attention as k7
    from repro_torch.launch.train import TrainRun, train_step
    from repro_torch.models import registry
    from repro_torch.optim import adamw

    cfg, params, opt = a["cfg"], a["params"], a["opt_state"]
    mod = registry.get_module(cfg)
    b, l = P16_TRAIN_COUNT
    batch = TrainRun._with_stubs(make_batch(DataConfig(vocab=cfg.vocab, seq_len=l,
                                                       global_batch=b), 0, P16_DEVICE), cfg)
    k7_cost, k7b_cost = k7.k7_cost, k7.k7b_cost
    missed = []
    for name, plant in (
            ("K7's count without the causal half", lambda: _planted(
                k7, k7_cost=lambda q, k, v, causal, with_lse: k7_cost(q, k, v, False, with_lse))),
            ("K7b's count left out", lambda: _planted(
                k7, k7b_cost=lambda q, k, v, causal: (0, 0, False)))):
        with plant():
            try:
                rec = p16_dryrun_cell("train", b, l)
                card = p16_counted(lambda: train_step(mod, cfg, adamw.OptConfig(), params, opt,
                                                      batch))
                p16_flop_gate("planted", card, rec, p16_expected_attention(cfg, b, l, "train"))
                missed.append(name)
                log(f"[16] (d) {name}: (c) PASSED: not caught ({gpu})")
            except AssertionError as e:
                log(f"[16] (d) {name}: (c) failed, as it must: {str(e)[:240]} ({gpu})")
    return missed


def p16_remat_plant(gpu: str) -> list:
    """(d): a remat that keeps the config's "full" but runs each layer
    body plainly (no recompute) must fail (a)'s launch gate."""
    from repro_torch.launch.train import TrainRun
    from repro_torch.models import transformer

    run = TrainRun(arch=P16_ARCH, smoke=P16_SMOKE, device=P16_DEVICE, lr=1e-3, log_every=100,
                   **P16_PLANT_RUN)
    cfg = run.config()
    K7, K7b = wrapper("k7"), wrapper("k7b")
    with _planted(transformer, run_body=lambda remat, body, *args, **_: body(*args)):
        K7.launches = 0
        K7b.launches = 0
        run.run()
        launches = {"k7": K7.launches, "k7b": K7b.launches}
    torch.cuda.empty_cache()
    try:
        p16_launch_gate("planted", launches, cfg, P16_PLANT_RUN["steps"])
        log(f"[16] (d) remat without its recompute: (a)'s launch gate PASSED: not caught "
            f"({gpu})")
        return ["remat without its recompute"]
    except AssertionError as e:
        log(f"[16] (d) remat without its recompute: (a)'s launch gate failed, as it must: "
            f"{str(e)[:240]} ({gpu})")
        return []


def p16_no_remat_reading(gpu: str) -> None:
    """(a), last: one step of B 1 x 4096 with ``remat="none"`` (a reading:
    whether it fits the card, and its peak)."""
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch.train import TrainRun, train_step
    from repro_torch.optim import adamw

    run = TrainRun(arch=P16_ARCH, smoke=P16_SMOKE, device=P16_DEVICE, steps=1, batch=1,
                   seq=P16_RUN["seq"], seed=0)
    cfg, mod, dev, params, opt, dcfg, _ = run.build()
    torch.cuda.reset_peak_memory_stats()
    try:
        train_step(mod, dataclasses.replace(cfg, remat="none"),
                   adamw.OptConfig(lr=1e-3, warmup_steps=20, total_steps=1), params, opt,
                   run._with_stubs(make_batch(dcfg, 0, dev), cfg))
        torch.cuda.synchronize()
        log(f"[16] (a) reading: one step of B 1 x {P16_RUN['seq']} without remat fits: peak "
            f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes ({gpu})")
    except torch.cuda.OutOfMemoryError as e:
        log(f"[16] (a) reading: one step of B 1 x {P16_RUN['seq']} without remat does not fit "
            f"the card: out of memory ({str(e)[:200]}); peak max_memory_allocated before it "
            f"{torch.cuda.max_memory_allocated()} bytes ({gpu})")
    del params, opt
    torch.cuda.empty_cache()


def phase16_remat_dryrun(results: dict) -> None:
    """remat and the dry run on one card: (a) llama3.2-3b trained at 4096-token
    rows with remat, its K7 and K7b calls held to their plain versions (and a
    no-remat reading), (b) the dry run's CLI over the 32 cells on meta, (c)
    the dry run held against the card's own counts, cache bytes and argument
    bytes, and the roofline bound against the measured steps, (d) planted
    faults."""
    import tempfile

    t_phase = time.perf_counter()
    gpu = gpu_line()
    spent = {}
    a = None
    for batch in (P16_RUN["batch"], 1):
        try:
            a = p16_train(gpu, batch)
            break
        except torch.cuda.OutOfMemoryError as e:
            log(f"[16] (a) B {batch}: out of memory ({str(e)[:160]}); cut to B 1 ({gpu})")
            torch.cuda.empty_cache()
            if batch == 1:
                raise
    spent["(a)"] = time.perf_counter() - t_phase
    out_dir = Path(tempfile.mkdtemp(prefix="p16_dryrun_"))
    proc = p16_dryrun_start(out_dir)
    try:
        missed = p16_card_phases(a, results, gpu, spent)
        t0 = time.perf_counter()
        p16_dryrun_gate(proc, out_dir, gpu)
        if results.get("p16_mesh_runs"):
            p16_mesh_dryrun_gate(*results["p16_mesh_runs"], gpu)
        spent["(b) wait"] = time.perf_counter() - t0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(out_dir, ignore_errors=True)
    log(f"[16] phase 16 in {time.perf_counter() - t_phase:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in spent.items()) + f" ({gpu})")
    if missed:
        raise AssertionError(f"phase 16: planted faults not caught: {missed}")


def p16_card_phases(a: dict, results: dict, gpu: str, spent: dict) -> list:
    """Phase 16's gates and readings on the card after (a)'s run, while
    (b) runs on the host; returns the plants not caught."""
    cfg, steps, l = a["cfg"], P16_RUN["steps"], P16_RUN["seq"]
    parts = a["parts"][1:] or a["parts"]  # step 0 warms up
    med = {k: float(np.median([p[k] for p in parts])) for k in ("forward", "backward",
                                                                "optimizer")}
    step_ms = 1e3 * sum(med.values())
    cut = "" if a["batch"] == P16_RUN["batch"] else f" (cut from B {P16_RUN['batch']})"
    log(f"[16] (a) {P16_ARCH} at full width and depth, remat {cfg.remat!r}: B {a['batch']}{cut} x "
        f"{l}, {steps} AdamW steps through TrainRun.run in {a['wall']:.1f} s; launches K7 "
        f"{a['launches']['k7']}, K7b {a['launches']['k7b']} (expected "
        f"{train_launches(cfg, steps)}); losses {[round(x, 6) for x in a['losses']]}; step "
        f"(median of steps 1-{steps - 1}; parts from CUDA events, one synchronization a step): "
        f"forward {1e3 * med['forward']:.3f} ms, backward {1e3 * med['backward']:.3f} ms, "
        f"optimizer {1e3 * med['optimizer']:.3f} ms, step {step_ms:.3f} ms, "
        f"{a['batch'] * l / step_ms * 1e3:.1f} tokens/s; peak max_memory_allocated "
        f"{a['peak']} bytes ({gpu})")
    p16_launch_gate("(a)", a["launches"], cfg, steps)
    if not all(math.isfinite(x) for x in a["losses"]):
        raise AssertionError(f"(a) a loss is not finite: {a['losses']}")

    t0 = time.perf_counter()
    p16_card_counts(a, gpu)
    spent["(c)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    missed = p16_count_plants(a, gpu)
    spent["(d) count plants"] = time.perf_counter() - t0
    del a["params"], a["opt_state"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    missed += p16_long_row_checks(a, gpu)
    del a["k7b_records"], a["k7_record"]
    torch.cuda.empty_cache()
    spent["(a) kernel checks"] = time.perf_counter() - t0

    # the roofline bound against the measured steps, and held memory beside the peaks
    rec_a = p16_dryrun_cell("train", a["batch"], l)
    mem_a = rec_a["memory"]
    bound_a = 1e3 * max(rec_a["t_compute"], rec_a["t_memory"])
    log(f"[16] (c) (a)'s step {step_ms:.3f} ms against the dry run's bound {bound_a:.3f} ms "
        f"({rec_a['bottleneck']}): {step_ms / bound_a:.3f}x; temp_size_in_bytes "
        f"{mem_a['temp_size_in_bytes']} (held at the end of the forward) beside "
        f"max_memory_allocated - argument bytes {a['peak'] - mem_a['argument_size_in_bytes']} "
        f"({gpu})")
    if step_ms < bound_a:
        raise AssertionError(f"(c) (a)'s step {step_ms:.3f} ms is below its bound {bound_a:.3f}")
    p15 = results.get("p15")
    if p15:
        rec15 = p16_dryrun_cell("train", p15["batch"], p15["seq"])
        mem15 = rec15["memory"]
        bound15 = 1e3 * max(rec15["t_compute"], rec15["t_memory"])
        log(f"[16] (c) phase 15's step {p15['step_ms']:.3f} ms against the dry run's bound "
            f"{bound15:.3f} ms ({rec15['bottleneck']}): {p15['step_ms'] / bound15:.3f}x; "
            f"temp_size_in_bytes {mem15['temp_size_in_bytes']} beside max_memory_allocated - "
            f"argument bytes {p15['peak'] - mem15['argument_size_in_bytes']} ({gpu})")
        if p15["step_ms"] < bound15:
            raise AssertionError(f"(c) phase 15's step is below its bound {bound15:.3f} ms")

    t0 = time.perf_counter()
    p16_no_remat_reading(gpu)
    spent["(a) no remat"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    missed += p16_remat_plant(gpu)
    spent["(d) remat plant"] = time.perf_counter() - t0
    return missed


# --------------------------------------------------------------------------
# phase 17: sharding on one card
# --------------------------------------------------------------------------
P17_ARCH = "llama3.2-3b"
#: (a): phase 15 (c)'s settings (B 2 x 1024, 6 AdamW steps, seed 0, lr 1e-3)
P17_RUN = P15_RUN
#: (b): llama3.2-3b's layer shapes (B, H, Hkv, L, Dh), bf16, causal
P17_SHAPE = (2, 24, 8, 1024, 128)
#: (b): model degrees; 2, 4 and 8 keep whole kv groups (rep 3), 3 and 16
#: cut them (16: two heads a rank, four ranks empty)
P17_DEGREES = (2, 4, 8, 3, 16)
#: (c): the launch gate's plant, a depth cut (full widths), one step of B 1
P17_PLANT_RUN = dict(n_layers=2, batch=1, steps=1)
#: Module globals read at call time (a CPU rehearsal sets "cpu" and SMOKE).
P17_DEVICE = "cuda"
P17_SMOKE = False


def p17_train_run(mesh_shape: tuple, **kw):
    from repro_torch.launch.train import TrainRun

    return TrainRun(arch=P17_ARCH, smoke=P17_SMOKE, device=P17_DEVICE, mesh_shape=mesh_shape,
                    **{**P17_RUN, **kw})


def p17_train(mesh_shape: tuple, **kw) -> dict:
    """One ``TrainRun`` (on a mesh when ``mesh_shape``): K7 and K7b counts
    zeroed just before and read just after, wall time, peak memory, each
    step's parts and host seconds; the final fp32 parameters and both
    moments copied to the host leaf by leaf (a DTensor's local tensor) and
    the run's device memory freed."""
    from repro_torch.optim import adamw

    run = p17_train_run(mesh_shape, **kw)
    K7, K7b = wrapper("k7"), wrapper("k7b")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K7.launches = 0
    K7b.launches = 0
    t0 = time.perf_counter()
    out = run.run()
    torch.cuda.synchronize()
    res = {"launches": {"k7": K7.launches, "k7b": K7b.launches},
           "wall": time.perf_counter() - t0, "peak": torch.cuda.max_memory_allocated(),
           "losses": out["losses"], "parts": out["parts"], "step_s": out["step_s"],
           "cfg": run.config(), "trees": []}
    for tree in (out["params"], out["opt_state"].mu, out["opt_state"].nu):
        for t in adamw.tree_leaves(tree):
            t = t.detach()
            res["trees"].append((t.to_local() if hasattr(t, "to_local") else t).to(
                "cpu", copy=True))
    del out, run
    torch.cuda.empty_cache()
    return res


def p17_launch_gate(label: str, launches: dict, cfg, steps: int) -> None:
    want = train_launches(cfg, steps)
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected {want}")


def p17_medians(r: dict) -> dict:
    """Median ms of each part and of the host's step (steps 1 on; step 0
    warms up)."""
    parts = r["parts"][1:] or r["parts"]
    med = {k: 1e3 * float(np.median([p[k] for p in parts]))
           for k in ("forward", "backward", "optimizer")}
    med["host_step"] = 1e3 * float(np.median(r["step_s"][1:] or r["step_s"]))
    return med


def p17_count_first_step(record: dict):
    """Over ``launch.train.train_step``: its first call counted by the dry
    run's ``CostCounter`` (kept in ``record["counter"]``), every call run
    as it is."""
    from repro_torch.kernels.cost import CostCounter
    from repro_torch.launch import train as ttrain

    orig = ttrain.train_step

    def counted(*args, **kw):
        if "counter" in record:
            return orig(*args, **kw)
        with CostCounter() as c:
            out = orig(*args, **kw)
        record["counter"] = c
        return out

    return _planted(ttrain, train_step=counted)


def p17_mesh_vs_plain(gpu: str) -> dict:
    """(a): the (1, 1) mesh run, then the run without a mesh, one after the
    other in this process (each peaks near the card's memory, so the first
    is on the host before the second starts): losses, final parameters and
    moments bit-equal; the mesh run's launches. The mesh run's first step
    is counted by the dry run's counter, for (d)."""
    counted = {}
    with p17_count_first_step(counted):
        mesh = p17_train((1, 1))
    mesh["counter"] = counted["counter"]
    p17_launch_gate("(a) the (1, 1) mesh run", mesh["launches"], mesh["cfg"], P17_RUN["steps"])
    plain = p17_train(())
    if mesh["losses"] != plain["losses"]:
        raise AssertionError(f"(a) losses differ: mesh {mesh['losses']}, none {plain['losses']}")
    diff = [i for i, (a, b) in enumerate(zip(mesh["trees"], plain["trees"], strict=True))
            if not torch.equal(a, b)]
    if diff:
        raise AssertionError(f"(a) {len(diff)} of {len(plain['trees'])} final leaves (parameters, "
                             f"mu, nu) differ, the first at {diff[0]}")
    n = len(plain["trees"])
    for r in (mesh, plain):
        del r["trees"]
    return {"mesh": mesh, "plain": plain, "leaves": n}


def p17_head_shards(local=None) -> list:
    """(b): ``attention.check_head_shards`` at :data:`P17_SHAPE` for each
    degree of :data:`P17_DEGREES` (``local`` a planted helper), the K7 and
    K7b launches of each (its shard calls and one whole call)."""
    from repro_torch.kernels import flash_attention as k7
    from repro_torch.models import attention as attn

    b, h, hkv, l, dh = P17_SHAPE
    q, k, v = k7.random_inputs(1700, b, h, hkv, l, l, dh, torch.bfloat16, heads_last=True,
                               device=P17_DEVICE)
    gen = torch.Generator(device=P17_DEVICE).manual_seed(1700)
    dout = torch.randn(q.shape, generator=gen, device=P17_DEVICE)
    K7, K7b = wrapper("k7"), wrapper("k7b")
    rows = []
    for degree in P17_DEGREES:
        K7.launches = 0
        K7b.launches = 0
        r = attn.check_head_shards(q, k, v, dout, degree, causal=True, local=local)
        r["launches"] = (K7.launches, K7b.launches)
        rows.append((degree, r))
    return rows


def p17_shard_gate(rows: list) -> None:
    _, h, hkv, _, _ = P17_SHAPE
    for degree, r in rows:
        want = (r["calls"] + 1, r["calls"] + 1)  # the shard calls and the whole call
        whole = -(-h // degree) % (h // hkv) == 0  # each rank's ceil(H / degree) heads
        if not r["ok"] or r["launches"] != want or r["whole_groups"] != whole:
            raise AssertionError(f"(b) degree {degree}: {r}, launches expected {want}")


def _kv_one_group_off(q, k, v, h0, h1, n_heads, *, causal):
    """The local-shard helper with its kv heads one group off."""
    from repro_torch.models import attention as attn

    return attn.local_attention(q, k.roll(-1, 1), v.roll(-1, 1), h0, h1, n_heads, causal=causal)


def p17_planted_faults(gpu: str) -> list:
    """(c): a kv-head offset one group off in the local-shard helper ->
    (b)'s check; the mesh path calling the plain attention on its CUDA
    shards -> (a)'s launch gate (at :data:`P17_PLANT_RUN`). Returns the
    plants that were not caught."""
    from repro_torch.kernels import flash_attention as k7
    from repro_torch.models import attention as attn

    missed = []
    global P17_DEGREES
    degrees, P17_DEGREES = P17_DEGREES, (4,)
    try:
        rows = p17_head_shards(local=_kv_one_group_off)
    finally:
        P17_DEGREES = degrees
    try:
        p17_shard_gate(rows)
        missed.append("kv one group off")
    except AssertionError as e:
        log(f"[17] (c) kv heads one group off in the local-shard helper: (b) fails ({str(e)[:90]}"
            f"...) ({gpu})")
    plain_local = functools.partial(attn.local_attention, attend=k7.flash_attention_plain)
    with _planted(attn, local_attention=plain_local):
        r = p17_train((1, 1), **P17_PLANT_RUN)
    try:
        p17_launch_gate("(c) the mesh run", r["launches"], r["cfg"], P17_PLANT_RUN["steps"])
        missed.append("plain attention on the shards")
    except AssertionError as e:
        log(f"[17] (c) the mesh path's attention through the plain versions on its CUDA shards: "
            f"(a)'s launch gate fails ({e}) ({gpu})")
    return missed


def p17_fake_dryrun() -> "object":
    """The dry run's train cell of (a) (``P17_ARCH``, B x L of ``P17_RUN``)
    on a fake (1, 1) mesh on meta: its ``CostCounter``. Raises where a
    process group is still initialized (the one (a) made must be gone)."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib

    b, l = P17_RUN["batch"], P17_RUN["seq"]
    with mesh_lib.fake_mesh((1, 1), ("data", "model")) as mesh:
        _, fn, args, _ = dryrun.build_cell(P17_ARCH, ShapeSpec(f"train_{b}x{l}", l, b, "train"),
                                           smoke=P17_SMOKE, mesh=mesh)
        counter, _ = dryrun.memory(fn, args)
    if torch.distributed.is_initialized():
        raise AssertionError("(d) a process group is left initialized after the fake mesh")
    return counter


def p17_dryrun_gate(label: str, fake, card, plain_flops: int, cfg) -> None:
    """(d)'s gate: the fake (1, 1) mesh's dry run counts the FLOPs the
    counter read over (a)'s first (1, 1) NCCL step on the card and the
    dry run of the same cell without a mesh (mesh "1"), K7 2 x n_layers
    and K7b n_layers calls on both sides, and no collective."""
    want = train_launches(cfg, 1)
    for side, c in (("the fake (1, 1) dry run", fake), ("the card's (1, 1) step", card)):
        calls = {k: c.kernels.get(n, {}).get("calls", 0)
                 for k, n in (("k7", "flash_attention"), ("k7b", "flash_attention_bwd"))}
        if calls != want:
            raise AssertionError(f"(d) {label}: {side} counts kernel calls {calls}, "
                                 f"expected {want}")
        if c.collectives["total"] or sum(c.collectives["counts"].values()):
            raise AssertionError(f"(d) {label}: {side} counts collectives {c.collectives}")
    if not fake.flops == card.flops == plain_flops:
        raise AssertionError(f"(d) {label}: FLOPs {fake.flops} (fake (1, 1) dry run), "
                             f"{card.flops} (the card's (1, 1) step), {plain_flops} (dry run "
                             f"without a mesh)")


def _norm_reduced_always(orig):
    """A planted ``train.mesh_grad_norm`` that all-reduces the squared norm
    over the world even on a mesh of one device (the same value there, one
    collective more)."""
    def norm(params, grads):
        from torch.distributed import _functional_collectives as funcol

        n = orig(params, grads)
        return funcol.wait_tensor(funcol.all_reduce(n * n, "sum",
                                                    torch.distributed.group.WORLD)).sqrt()

    return norm


def p17_dryrun_checks(card, gpu: str) -> list:
    """(d) and its plant: returns the plants not caught. (On a (1, 1) mesh
    every product runs on local tensors, so a counter that also counted
    DTensor ops at their global shapes would count no FLOP more: the plant
    is in the mesh path's collectives instead.)"""
    from repro_torch.launch import train as ttrain

    b, l = P17_RUN["batch"], P17_RUN["seq"]
    t0 = time.perf_counter()
    plain = p16_dryrun_cell("train", b, l)["flops_per_device"]
    fake = p17_fake_dryrun()
    cfg = p17_train_run(()).config()
    p17_dryrun_gate("(a)'s cell", fake, card, plain, cfg)
    log(f"[17] (d) the dry run of (a)'s train cell (B {b} x {l}) on a fake (1, 1) mesh (meta): "
        f"{fake.flops} FLOPs = the dry-run counter over (a)'s first (1, 1) NCCL step on the card "
        f"= the dry run without a mesh; K7 {fake.kernels['flash_attention']['calls']}, K7b "
        f"{fake.kernels['flash_attention_bwd']['calls']} calls on both sides; no collective on "
        f"either; the one-rank NCCL group released before the fake group was made; "
        f"{time.perf_counter() - t0:.1f} s ({gpu})")
    with _planted(ttrain, mesh_grad_norm=_norm_reduced_always(ttrain.mesh_grad_norm)):
        planted = p17_fake_dryrun()
    what = "the clip norm all-reduced on a one-device mesh"
    try:
        p17_dryrun_gate("planted", planted, card, plain, cfg)
        log(f"[17] (d) plant: {what}: (d) PASSED: not caught ({gpu})")
        return [what]
    except AssertionError as e:
        log(f"[17] (d) plant: {what}: (d) fails, as it must: {str(e)[:200]} ({gpu})")
        return []


def phase17_sharding(results: dict) -> None:
    """Sharding on one card: (a) llama3.2-3b at full width and depth on a
    (1, 1) mesh bit-equal to the run without one, (b) K7 and K7b on each
    model rank's head shard, (c) planted faults."""
    t_phase = time.perf_counter()
    gpu = gpu_line()
    t0 = time.perf_counter()
    a = p17_mesh_vs_plain(gpu)
    mesh, plain, cfg = a["mesh"], a["plain"], a["mesh"]["cfg"]
    mm, pm = p17_medians(mesh), p17_medians(plain)
    log(f"[17] (a) {P17_ARCH} at full width and depth (remat {cfg.remat!r}, B "
        f"{P17_RUN['batch']} x {P17_RUN['seq']}, {P17_RUN['steps']} AdamW steps, seed 0): "
        f"TrainRun(mesh_shape=(1, 1)) (one-rank NCCL group; DTensor masters, moments and "
        f"batch) and TrainRun without a mesh bit-equal: losses {mesh['losses']}, the "
        f"{a['leaves']} final fp32 parameter, mu and nu leaves; mesh-run launches K7 "
        f"{mesh['launches']['k7']}, K7b {mesh['launches']['k7b']} (expected "
        f"{train_launches(cfg, P17_RUN['steps'])}); {time.perf_counter() - t0:.1f} s ({gpu})")
    log(f"[17] (a) ms a step (median of steps 1-{P17_RUN['steps'] - 1}; parts from CUDA "
        f"events): mesh forward {mm['forward']:.3f}, backward {mm['backward']:.3f}, optimizer "
        f"{mm['optimizer']:.3f}, host step {mm['host_step']:.3f}; no mesh forward "
        f"{pm['forward']:.3f}, backward {pm['backward']:.3f}, optimizer {pm['optimizer']:.3f}, "
        f"host step {pm['host_step']:.3f}; DTensor's cost a step (mesh - none) "
        f"{mm['host_step'] - pm['host_step']:.3f} ms of host step, forward "
        f"{mm['forward'] - pm['forward']:.3f}, backward {mm['backward'] - pm['backward']:.3f}; "
        f"peak max_memory_allocated mesh {mesh['peak']}, none {plain['peak']} bytes; wall "
        f"{mesh['wall']:.1f} and {plain['wall']:.1f} s ({gpu})")
    results["p17"] = {"launches": mesh["launches"]}

    t0 = time.perf_counter()
    rows = p17_head_shards()
    p17_shard_gate(rows)
    b, h, hkv, l, dh = P17_SHAPE
    for degree, r in rows:
        log(f"[17] (b) K7 + K7b on each of {degree} model ranks' head shards of ({b}, {h}, {l}, "
            f"{dh}) bf16 causal, {hkv} kv heads ({r['calls']} shard calls, "
            f"{'whole kv groups' if r['whole_groups'] else 'kv groups cut: a call a piece'}): "
            f"outputs and dQ bit-equal to the whole call, dK/dV "
            f"{'bit-equal' if r['dkv_equal'] else 'within the bound'} (max err/bound "
            f"{r['dkv_ratio']:.3e}); "
            f"launches K7 {r['launches'][0]}, K7b {r['launches'][1]} (the shards' and the whole "
            f"call's)")
    log(f"[17] (b) {len(rows)} layouts in {time.perf_counter() - t0:.1f} s ({gpu})")

    t0 = time.perf_counter()
    missed = p17_planted_faults(gpu)
    log(f"[17] (c) planted faults in {time.perf_counter() - t0:.1f} s ({gpu})")
    missed += p17_dryrun_checks(mesh["counter"], gpu)
    for row in results.get("lm_kernels", []) + results.get("train_kernels", []):
        key = {"flash_attention": "k7", "flash_attention_bwd": "k7b"}.get(row["name"])
        if key:
            row["launches"] += mesh["launches"][key]
    log(f"[17] phase 17 in {time.perf_counter() - t_phase:.1f} s ({gpu})")
    if missed:
        raise AssertionError(f"phase 17: planted faults not caught: {missed}")


def phase6_profile(nsteps: int = 10) -> None:
    from repro_torch.core import solver
    from repro_torch.core.api import Simulation

    sim = Simulation.from_case("taylor_green", ds=1.0 / 1024)
    cfg = sim.cfg
    carry = solver.init_persistent(cfg, sim.state)
    carry = solver.run_persistent(cfg, carry, 3)  # warm-up
    torch.cuda.synchronize()
    split = {"decide": 0.0, "rebuild": 0.0, "physics": 0.0}
    for _ in range(nsteps):
        t0 = time.perf_counter()
        need = solver._needs_rebuild(cfg, carry)
        t1 = time.perf_counter()
        if need:
            carry = solver._rebuild(cfg, carry)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        carry = solver._physics_step(cfg, carry)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        split["decide"] += t1 - t0
        split["rebuild"] += t2 - t1
        split["physics"] += t3 - t2
    log("[6] host-timed step split (ms/step, synchronized): " + ", ".join(
        f"{k} {1e3 * v / nsteps:.3f}" for k, v in split.items()))
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        carry = solver.run_persistent(cfg, carry, nsteps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = device_events(prof)
    device_us = sum(e.self_device_time_total for e in events)
    log(f"[6] profiled {nsteps} steps: wall {1e3 * wall / nsteps:.3f} ms/step, device "
        f"time {device_us / 1e3 / nsteps:.3f} ms/step, device busy share "
        f"{device_us / 1e6 / wall:.3f}")
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:15]
    for e in top:
        if e.self_device_time_total > 0:
            log(f"[6]   {e.self_device_time_total / 1e3 / nsteps:9.4f} ms/step "
                f"{e.count // nsteps:4d} calls/step  {e.key[:90]}")
    passes = {e.key.split("namespace)::", 1)[1].split("(")[0]: e for e in events
              if "namespace)::" in e.key}
    log("[6] K1 and K2 passes: " + ", ".join(
        f"{name} {e.self_device_time_total / 1e3 / nsteps:.4f} ms/step"
        for name, e in sorted(passes.items())
        if name.startswith(("cell_tables_kernel", "stage_kernel", "force_kernel"))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="1,2,3,4,5,7,8,9,10,11,12,13,14,15,16,17",
                    help="comma-separated phases to run (default: all but 6)")
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of an earlier tree whose K1, K3-K5, K7 and K7b phases "
                         "3, 8, 9 and 15 time beside this tree's")
    args = ap.parse_args()
    phases = {int(p) for p in args.phases.split(",")}
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails here without the package)

    results: dict = {}
    t0 = time.perf_counter()
    mesh_dir, mesh_runs = None, []
    if 16 in phases:  # (b)'s dry runs on JAX's meshes start now, on the host's CPU
        import tempfile

        mesh_dir = Path(tempfile.mkdtemp(prefix="p16_mesh_"))
        mesh_runs = p16_mesh_dryrun_start(mesh_dir)
        results["p16_mesh_runs"] = (mesh_runs, mesh_dir)
    try:
        run_phases(phases, results, args.parent)
    finally:
        for _, proc, _, _ in mesh_runs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if mesh_dir is not None:
            shutil.rmtree(mesh_dir, ignore_errors=True)
    log(f"[done] phases {sorted(phases)} in {time.perf_counter() - t0:.1f} s")
    if 1 not in phases:
        log(gpu_line())
    log(json.dumps({"kernels": results.get("kernels", []) + results.get("nnps_kernels", [])
                    + results.get("lm_kernels", []) + results.get("train_kernels", [])}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run_phases(phases: set, results: dict, parent) -> None:
    if 1 in phases:
        phase1_build()
    if 2 in phases:
        phase2_kernels()
    if 3 in phases:
        phase3_main_path(results, parent)
    if 4 in phases:
        phase4_stale_binning()
    if 5 in phases:
        phase5_kernel_vs_plain_path()
    if 6 in phases:
        phase6_profile()
    if 7 in phases:
        phase7_planted_faults()
    if 8 in phases:
        phase8_nnps_path(results, parent)
    if 9 in phases:
        phase9_serving(results, parent)
    if 10 in phases:
        phase10_backends()
    if 11 in phases:
        phase11_guarded()
    if 12 in phases:
        phase12_ensemble()
    if 13 in phases:
        phase13_serving()
    if 14 in phases:
        phase14_families()
    if 15 in phases:
        phase15_training(results, parent)
    if 16 in phases:
        phase16_remat_dryrun(results)
    if 17 in phases:
        phase17_sharding(results)


if __name__ == "__main__":
    sys.exit(main())
