#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``lightgbm_tpu_torch``) on one
NVIDIA GPU: ``python3 chip_smoke.py`` from the root of a checkout.

Phases, each of which raises (exit code != 0, no result line) on failure:

1. the card's name and power limit; the CUDA kernels are built from
   ``lightgbm_tpu_torch/csrc`` (one ``nvcc`` per source, all at once);
   the analyzer (slice 8): the three fixture kernels of
   ``csrc/analysis_fixtures.cu`` at their legal geometries, counted,
   bitwise against their plain versions, each seeded geometry refused
   before a launch, each kernel timed; then ``run_analysis`` under
   ``--strict`` with the resources read fresh from the built libraries
   (``cuobjdump -res-usage``, names from ``cu++filt``, ``ptxas -v``
   held against it): no finding on the port, every fixture exactly its
   codes, and one ``kernel resources`` line per kernel; the fresh report
   is written to ``lightgbm_tpu_torch/build/``, and a checked-in
   ``analysis/resources_sm90a.txt`` that differs from it fails the run
   after every other phase;
2. serving (slice 1, redesigned in slice 16): ``serve_traverse``'s
   two entries (the bins entry, and the raw entry with the quantizer
   inside) in both forms against their plain versions on small seeded
   forests with categorical splits, NaN rows, f32 and bf16 leaf tables,
   the wide record, the quantizer's edge values (the raw entry's bins
   bitwise ``quantize_rows_kernel``'s) and padded buckets, and on a
   2,000-tree x 255-leaf forest larger than shared memory; then the
   serving main path at full width: a seeded binary forest of 100 trees
   x 255 leaves over 28 features, loaded from model text, scoring
   1,000,000 rows with ``Booster.predict`` and 512 batches of 64 rows
   through ``ServingQueue`` (both through the raw entry), counted, the
   queue's results bitwise bulk predict's, and 4,096 rows held against
   the f64 host walk; the kernel's times at 65,536 and 64 rows, eager
   and in a graph, and the dispatch breakdown at both sizes;
3. the training kernels (slices 2, 3 and 5) against their plain
   versions at the main path's shapes (1,000,000 x 28 real bins, B =
   256): ``hist_comb``, ``partition_scan`` and ``copyback``;
   ``stream_init`` and ``stream_refresh`` bitwise, the refresh's root
   histogram bitwise ``hist_comb``'s (slice 16: the refresh is the plain
   refresh's kernel and then ``hist_comb``'s root, timed beside its two
   parts, both packs, eager and in a graph); ``fused_split`` on the 1M-row
   segment and on a 3,000-row segment at an odd offset, its rows and
   nleft bitwise and both histograms bitwise ``hist_comb``'s of each
   child range; ``apply_find`` (slice 13: one cluster of blocks over the
   features) bitwise on a real split's histograms (the 1M-row root
   split) and on seeded adversarial splits at 28 and 136 features (equal
   keys in the last two blocks, the winner in the last block);
   ``partition_3ph`` bitwise on the 1M-row segment, the 3,000-row one,
   a 400,000-row mid-matrix segment with an 8-word bitset descriptor
   and a dead split (also against its plain version on CPU copies);
   ``stream_refresh_plain`` bitwise at 1M rows; then each kernel's time
   beside its plain version's; ``hist_rows`` (slice 4) bitwise against
   its plain version run on CPU copies, on the 1M x 28 u16 bins of
   ``max_bin=1023`` (B = 1024, the root, and a 3,000-row child through a
   permutation index), u8 bins through an index and a B = 1040 case,
   each timed beside its plain version, one ``index_add_`` and its
   bound;
4. training parity, card against ``device="cpu"``, 20,000 x 28, 255
   leaves: 1 tree on the default route, slice 2's route, the row-order
   route at ``max_bin=1023`` and the 3ph route (bitwise);
5. the training main path on the default route (score-resident
   gradients, fused split, one-kernel split tail): 1,000,000 x 28, 255
   leaves, 10 iterations, the launch counts zeroed just before and read
   just after (``expected_launches``), per-tree stage times, holdout
   AUC, host reads, and the trained booster served through
   ``serve_traverse``; then slice 2's route (``LGBM_TPU_STREAM=0
   LGBM_TPU_FUSED=0 LGBM_TPU_APPLY_IMPL=xla``) for 3 iterations, counted
   the same way, its trees held against the default route's first 3;
   the row-order route (slice 4) at ``max_bin=1023`` for 10 iterations
   and under ``LGBM_TPU_PHYS=0`` at ``max_bin=255`` for 3, counted the
   same way (``hist_rows`` once per tree and per split), the latter's
   trees printed beside the default route's; ``hist_rows`` (slice 11)
   timed at the root and at the quartiles and maximum of the row-order
   trees' smaller children (and at 3,000 rows), eager and as one replay
   of a CUDA graph of 20 calls, beside ``index_add_`` both ways and the
   bound, each case bitwise its plain version first and its kernels
   read from a profiler trace (one launch at up to two slices);
   ``fused_split`` and ``fused_split_p2`` (slice 12) timed at the 1M-row
   root and at the quartiles and largest child of the default route's
   split segments, eager and in a graph, beside the plain version and
   the bound, each case bitwise its plain version first and its kernels
   read from a profiler trace (``count_tiles``, ``fused_scatter``,
   ``fused_hist``, and ``reduce_partials`` above 16 slices); the 3ph
   route (slice 5, ``LGBM_TPU_PART=3ph``) for 2 iterations
   (``partition_3ph`` once per split, ``hist_comb`` per tree and per
   split, the plain refresh per tree), its trees printed beside the
   default route's, and ``LGBM_TPU_POOL_TAIL=0`` for 2 (``apply_find``
   once per split), its trees held against the default route's bit for
   bit; the tail (slice 13) bitwise its plain version on the median
   split of a default-route and of a row-order tree, both entries timed
   at 28 x 256, 28 x 1024 and 136 x 256, eager and in a graph
   (``tools/profile_apply_find.py``); the 10-iteration main paths'
   holdout AUCs held to the earlier slices' (default and pack=2
   0.774389521391751, row-order 0.7743261350960159); one profiled
   iteration of each route but the last, its kernels counted per split
   and per stage (the tail's ms among them);
6. pack=2 (slice 6, ``LGBM_TPU_COMB_PACK=2``, one record per row): the
   five record kernels (``stream_init_p2``, ``hist_comb_p2``,
   ``fused_split_p2``, ``copyback_p2``, ``stream_refresh_p2``) bitwise
   against their plain versions and against their pack=1 kernels on the
   same logical rows, at 1,000,000 x 28 (S = 64: the root, the 1M-row
   segment, a segment at an odd offset of odd length, a dead split) and
   at 250,000 x 40 (S = 80), each timed beside its pack=1 kernel; the
   pack=2 route card against device="cpu" (20,000 rows, 1 tree,
   bitwise); its main path (1M x 28, 255 leaves, 10 iterations) counted,
   its trees held against the default route's bit for bit, and one
   profiled iteration; ``copyback_p2`` (slice 11, four 16-byte words in
   flight a thread) at 1M records and at the median and largest segment
   of the pack=2 route's splits, eager and in a graph, beside
   ``Tensor.copy_``, in turns, its output bitwise ``copy_``'s;
7. pack=2 without the fused split (slice 7): ``partition_scan_p2`` and
   ``stream_refresh_plain_p2`` in the record-kernel phase above (the
   whole, odd and dead segments; binary and l2), each timed beside its
   pack=1 kernel; card against device="cpu" on ``LGBM_TPU_COMB_PACK=2
   LGBM_TPU_FUSED=0`` and on slice 2's route at pack=2 (bitwise); the
   main path ``LGBM_TPU_COMB_PACK=2 LGBM_TPU_FUSED=0`` (1M x 28, 255
   leaves, 2 iterations) counted and served, beside the pack=1
   ``LGBM_TPU_FUSED=0`` route, both bitwise the default route's first 3
   trees, and slice 2's route at pack=2 (3), bitwise slice 2's route's
   trees; one profiled iteration of each unfused route; then (slice 14)
   ``hist_comb`` and ``hist_comb_p2`` on seeded 1M x 28 rows at the
   root, at the smaller children's quartiles and largest of the P1
   ``FUSED=0`` route's trees and at every slice count up to one past
   the range-mode limit, each bitwise its plain version on CPU copies
   with the kernels a call launches read from a profiler trace (range
   mode one ``hist_comb_range``, feature mode ``hist_comb_partial`` and
   ``reduce_partials``), the root and children timed eager and in a
   graph beside ``index_add_`` (the same again at 136 features in the
   wide phase); and (slice 15) the partitions' one-launch scan
   (``csrc/partition_scan.cuh``): ``partition_scan`` + ``copyback``,
   ``partition_3ph`` and ``partition_scan_p2`` + ``copyback_p2``
   bitwise their plain versions on the adversarial segments of
   ``partition_edge_cases`` (every row left or right, one row, one row
   past a tile boundary, an odd start with the NaN bin routed either
   way, one-hot categorical, 8 membership words) at 28 and 136 features
   and at pack=2, and at 8,000 features (the scan's unstaged kernels),
   then each timed at the 1M-row root and at its route's split-segment
   quartiles and largest segment below a root
   (``tools/profile_partition.py``'s cases), eager and in a graph beside
   the bound, failing unless a scan call is one memset of its look-back
   state and ``scan_tiles``, and a 3ph call the same and
   ``copyback_3ph``; each profiled iteration counts the partitions'
   kernels and memsets (``partition_kernels``);
8. the launch-cost probes (slice 9, TPU rows T11, T10, T9): the two
   tools of ``lightgbm_tpu_torch.tools`` run with the counts zeroed
   before and read after, their tables printed (T11: 254
   ``select_update``s eager, from C, as a replayed CUDA graph and as
   PyTorch ops; T10's four ``step_cost`` variants and T9's
   ``stream_tiles`` at n = 2^20, each output exactly its plain
   version's), then ``select_update`` bitwise its plain version after
   254 eager launches, 254 from C and a graph replay from four seeded
   states;
9. the partition-bisection probes (slice 10, TPU rows T1-T8): every
   scenario of ``lightgbm_tpu_torch.tools.profile_legacy`` at its
   default shape (``part2`` at 2^21 rows), counted with the counts zeroed
   before and read after, each kernel output bitwise its plain version
   on the card, timed eager and as a replayed CUDA graph; then the
   adversarial in-place inputs (a first block keeping nothing, one kept
   row a block, T = 512 k and 512 k +- 1, an odd s0 and cnt) and T8 on
   overlapping windows, bitwise their plain versions;
10. wide datasets (slice 9): ``hist_comb`` at 1,000,000 x 136 u8 bins,
   B = 256, in 17 feature chunks of 8, bitwise its plain version run on CPU
   copies and timed beside its byte bound and ``index_add_``; training
   parity at 10,000 x 136, card against device="cpu", 1 tree of 63
   leaves, bit-identical; 2 iterations of ``make_higgs_like(1M, 136)`` with 255
   leaves on the unfused stream route with the cluster kernel tail,
   counted exactly, the tail bitwise on a tree's median split, and one
   profiled iteration;
11. sorted-subset categorical splits (slice 17), on
   ``make_categorical_like`` (``bench.py --categorical 1024,8``: 2^20
   training and 100,000 holdout rows, 28 dense and 8 categorical
   features of 1,024 Zipf-skewed categories, binary, 255 leaves,
   ``max_cat_to_onehot`` 4, ``min_data_per_group`` 5): the five
   membership-word modes (``fused_split``, ``fused_split_p2``,
   ``partition_scan``, ``partition_scan_p2``, ``partition_3ph`` with 8
   words) against their plain versions on adversarial words at 36
   features (rows and nleft bitwise; the fused modes' histograms within
   4 * n * eps_f32 * max|v|); the card against device="cpu" on the
   first 5,000 rows on six routes, 1 tree of 31 leaves (bitwise); the
   default route for 2 iterations, pack=2, both
   ``FUSED=0`` routes and 3ph for 1
   (pack=2's and the unfused routes' trees bitwise the default
   route's), ``max_bin`` 1023 (``cat_overwide``, row-order) and the
   one-hot twin (``max_cat_to_onehot`` 1025, the kernel tail) for 1,
   each counted
   with each word mode launched on its route, holdout
   AUCs and splits of more than one category printed, served
   predictions held against the f64 host walk on edge categories; each
   word mode timed beside its one-hot mode, eager and in a graph;
12. monotone constraints (slice 18), on the main path's cell with +1 on
   features 0-3 and -1 on 4-7: the constrained instantiation of the
   split tail (``apply_find_mono_kernel``, both entries) bitwise its
   plain version on the card and on CPU copies on adversarial cases at
   28 and 136 features (a winner the violation mask removes, bounds
   clipping every candidate, equal keys across the last two blocks with
   one constrained, the penalty's 1e-15 floor, the done guard) and on
   the median split of a default-route, a row-order and a wide tree;
   the card against device="cpu" on the first 5,000 rows, 1 tree of 63
   leaves, on the default, pack=2 and row-order routes (bitwise); the basic method on
   the default route for 2 iterations, pack=2, P1 ``FUSED=0``, 3ph,
   ``POOL_TAIL=0``, row-order (``max_bin`` 1023) and the wide 1M x 136
   route for 2, ``monotone_penalty`` 2.0 and the intermediate method
   (the PyTorch tail and the adjacency pass) for 2, each counted and
   held to its route, pack=2's, ``FUSED=0``'s and ``POOL_TAIL=0``'s
   trees bitwise the default route's, every model's served predictions
   monotone on a grid of each constrained feature's bin bounds over 256
   holdout rows (zero violations), and within 64 ulps a tree of the
   host walk; printed: s / iteration and holdout AUC beside the
   unconstrained twin's, splits on constrained features, the tail's
   share, kernels a split and the constrained tail's times beside the
   unconstrained ones (``monotone routes``, ``monotone tail times``);
13. multiclass training and the regression and cross-entropy objectives
   (slice 19), on the kernel-tail physical route: the card against
   device="cpu" at 5,000 x 28, 31 leaves, bitwise, for 1 iteration of
   the 5-class softmax and the 3-class one-vs-all and 1 tree of each of
   ``regression_l1``, ``huber``, ``fair``, ``poisson``, ``quantile``
   (alpha 0.9), ``mape``, ``gamma``, ``tweedie``, ``cross_entropy`` and
   ``cross_entropy_lambda`` on a seeded label each accepts
   (``objective_label``), the softmax at pack=2 (255 leaves) bitwise
   the pack=1 card trees; the multiclass main path (``bench.py
   --multiclass 5``'s cell, ``make_multiclass_like``: 1M x 28 training
   and 100,000 holdout rows, 255 leaves, 2 iterations of 5 trees)
   counted against ``expected_launches``, its holdout ``multi_logloss``
   below the class prior's, served through ``serve_traverse`` within 64
   ulps a tree of the training scores and of the f64 host walk on 4,096
   holdout rows, its probabilities summing to 1 within 1e-6, and one
   profiled iteration; the l1 main path on the same rows and a
   heavy-tailed target (2 iterations) counted, its holdout ``l1`` below
   the constant median's, the leaf renewal timed as a stage; printed as
   ``objective routes {...}``;
14. bagging, GOSS and random-forest boosting (slice 20), on the
   kernel-tail physical route: the threefry draws on the card bitwise
   the CPU's at 1M rows (the bagging mask at iterations 0 and 5, GOSS's
   sample); the card against device="cpu" at 5,000 x 28, 31 leaves,
   bitwise, for 2 trees of bagging (0.8, every iteration), of
   ``pos_bagging_fraction`` 0.5 and of RF, 3 of GOSS (sampling from its
   third), and the bagging run at pack=2 bitwise the pack=1 card trees;
   the three main paths on the training main path's rows (LightGBM's
   ``binary_classification`` example's bagging 0.8 every 5 iterations
   with ``feature_fraction`` 0.8 for 10 iterations, GOSS 0.2 / 0.1 for
   12, RF 0.7 every iteration with ``feature_fraction`` 0.8 for 3),
   counted against ``expected_launches``, each holdout AUC above 0.5,
   served through ``serve_traverse`` within 64 ulps a tree of the f64
   host walk (RF's the average), one profiled iteration each; printed
   as ``sampling routes {...}``;
15. the split options (slice 22) on the PyTorch split tail: interaction
   constraints (the UCI HIGGS column groups), CEGB with a split
   penalty and coupled costs on the derived masses (columns 21-27), the
   same costs as lazy costs (the row-order path), forced splits
   (``FORCED_SPLITS``, in the shape of LightGBM's
   ``examples/binary_classification/forced_splits.json``),
   ``feature_fraction_bynode`` 0.5 with ``feature_fraction`` 0.8 and
   ``extra_trees``: each card against device="cpu" at 5,000 x 28, 63
   leaves, 2 trees, bitwise; a tree's node draws on the card bitwise the
   CPU's; each on the training main path's rows for 2 iterations,
   counted against ``expected_launches``, its route, s / iteration, ms a
   tree by stage, kernels a split and busy share of one profiled
   iteration, holdout AUC beside the default route's booster at 2
   iterations, and its gate (no root-to-leaf path leaving one
   interaction set; fewer splits on columns 21-27 than the default
   route's first 2 trees under coupled and lazy CEGB; the forced nodes
   on top of every tree; by-node sampling's and extra trees' trees
   other than the default route's); printed as ``split options {...}``;
16. linear trees (slice 23, ``linear_phase``): the card against
   device="cpu" at 5,000 x 28, 63 leaves, 2 trees (the second grown on
   the first's linear scores), trees, leaf values and leaf models
   bitwise; the main path on the training main path's bins with their
   raw values kept (``with_raw``) and ``linear_target``'s seeded
   piecewise-linear label, ``LINEAR_PARAMS`` (regression,
   ``linear_lambda`` 0.1, 255 leaves), 3 iterations on ``path=physical
   fused=1 tail=kernel (linear_tree)``, counted (one ``linear_moments``
   a tree), the ``linear_fit`` stage cut into the moments kernel, the
   host solve and the prediction, one profiled iteration, its holdout
   l2 beside the constant-leaf twin's; ``linear_moments`` bitwise its
   plain version on tree 0's leaves (and on CPU copies of the first
   four leaves' rows), timed beside its bound; ``Booster.predict`` on the
   holdout against the f64 host walk, the model text saved and loaded
   predicting the trained booster's bits, the serving model refusing the
   linear trees; 2 iterations continued from the model text through
   ``init_model`` starting from the model's raw predictions;
   ``rollback_one_iter`` on this route and on the default stream route
   (the main path's booster) giving back the scores bit for bit;
   printed as ``linear trees {...}``;
17. ``gpu_use_dp`` (slice 23, ``dp_phase``): the f64 mode of
   ``hist_rows`` bitwise its plain version on the card and on CPU
   copies at B = 256 (the main path's bins: root, 3,000 and 250,000
   indexed rows) and B = 1024 (seeded u16 bins: root, 3,000 indexed);
   the card against device="cpu" at the parity cut (bitwise); the
   Higgs binary main path with ``gpu_use_dp`` for 3 iterations on
   ``path=row_order`` (reason ``gpu_use_dp``), counted, beside its f32
   row-order twin (``LGBM_TPU_PHYS=0``, 3 iterations); the f64 mode
   at the root and the smaller children's quartiles and maximum, in
   turns with the f32 mode, beside ``index_add_`` in f64 and the bound;
   printed as ``gpu_use_dp {...}``;
18. the parallel learners (slice 24, ``parallel_phase``): the split
   tail's global side (``side=``) bitwise its plain version on the card
   and on CPU copies (agreeing with the local counts, then also bitwise
   the call without it, and flipping them) at 28 x 256, 28 x 1024,
   136 x 256 and on a real root split; every wrapper of the path on a
   segment empty on a rank (zeros, ``nleft = 0``, no launch); then W = 2
   ranks spawned on the one card over gloo (CUDA tensors staged through
   pinned host buffers): ``tree_learner=data`` on the main path's rows
   (1M x 28, 255 leaves, ``max_bin`` 255, 2 iterations) with the
   reduce-scatter merge, counted on rank 0, and with the full merge
   (bitwise the same trees); ``data``, ``voting`` (``top_k`` 5) and
   ``feature`` at ``PARITY_ROWS`` x ``PARITY_CUT_LEAVES`` leaves, 2
   trees, card against the same 2-rank run on the CPU, bitwise; every
   rank's model text the same; the holdout AUC within 0.002 of the
   serial route's at 2 iterations; a world-size-1 NCCL group through
   ``parallel.collectives.Comm``; printed as ``parallel {...}``
   (s / iteration, collectives and bytes a split, the ``collective``
   stage's ms a tree);
19. the training API and the dataset inputs (slice 25, ``api_phase``):
   a custom objective (numpy binary logloss) with a custom metric
   (holdout error rate) on the training main path's rows (1M x 28, 255
   leaves, 3 iterations) on ``path=physical fused=1 tail=kernel
   (objective_not_streamable)``, counted, its ``gradients`` stage a
   tree, holdout AUC beside the default route's at 3 iterations and the
   metric beside its value from ``predict``; at the parity cut (5,000
   rows, 31 leaves, 2 trees) the custom objective's card trees bitwise
   the CPU's and a pass-through objective's bitwise the built-in twin's;
   ``cv`` (3 folds x 3 rounds on the main rows, counted per fold, the
   folds' AUCs from ``predict`` averaging to ``valid auc-mean`` within
   1e-9); ``refit`` of the default-route booster on the holdout (decay
   0.9), its leaf values bitwise a CPU refit's, its structure unchanged,
   the leaf pass timed and the f64 rows whose kernel leaf differs from
   the host walk counted; the 1M-row binary cache and the holdout as a
   CSV with a named label column loaded back to the same bins; printed
   as ``api {...}``;
20. the resilience layer (slice 27, ``resilience_phase``) on the
   default stream route at 200,000 x 28, 63 leaves, 6 iterations, a
   snapshot every 2: three subprocesses (``LGBM_TPU_CKPT_AT_REFRESH`` 0
   and 1, GOSS) killed by ``LGBM_TPU_FAULT=death@3`` and resumed here,
   each byte for byte (model text, raw f32 scores) its uninterrupted
   run; ``nan@2`` under ``LGBM_TPU_NUMERICS=raise`` on the l1 route
   recovered from its snapshot to its uninterrupted run's bytes; a
   resume with another ``num_leaves`` refused; ``stream_init``'s
   launches over the saves; ``LGBM_TPU_NUMERICS=off`` launching the
   kernels of no knob at all (counters and a profiler trace); a save's
   ``stream_init`` at 200,000 rows timed; printed as ``resilience
   {...}``;
21. the public edges (slice 28, ``edges_phase``): ``pred_contrib`` of
   the main path's 10 trees on 65,536 holdout rows through the
   ``tree_shap`` kernel (counted, bitwise its plain version on 1,024
   rows and 2 trees, each row's sum against its f64 raw score, timed
   eager and in a graph beside the plain version and the bound) and of
   the categorical default route's model; ``pred_early_stop`` bitwise
   the f64 host computation; an ``LGBMClassifier`` at 1M rows (its
   launches, trees and probabilities against the main path's); the CLI
   (``task=train`` from a 1M-row CSV, ``predict``, ``convert_model``
   compiled with ``g++``);
22. one JSON line ``{"kernels": [...]}`` with each kernel's launches,
   parity and times (``multiclass_launches`` on the multiclass main
   path, ``sampling_launches`` on the three sampling main paths,
   ``ranking_launches``, ``split_options_launches`` on the split
   options' routes, ``linear_launches``, ``gpu_use_dp_launches``,
   ``parallel_launches`` and ``api_launches``),
   then the device line last; ``phase NAME took S s`` after each
   phase.

The forests and rows are generated from seeds: the card's machine has
no JAX.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np

N_FEATURES = 28
MAIN_TREES = 100
MAIN_LEAVES = 255
MAIN_ROWS = 1_000_000
BUCKET = 65_536
QUEUE_BATCHES = 512
QUEUE_ROWS = 64
HOST_ROWS = 4096
# H100 SXM peaks: HBM bytes/s and the float32 rate outside the tensor
# cores, the nearest published rate for the walk's 32-bit integer work
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
# integer operations per node visit of the walk: node index, feature
# load, meta test, NaN-bin compare, threshold compare, two selects, the
# loop test
OPS_PER_VISIT = 8


def make_higgs_like(n_rows: int, n_features: int = 28, seed: int = 0,
                    with_weights: bool = False):
    """Higgs-style rows: kinematic-style continuous features and a
    nonlinear decision surface (the generator bench.py serves).
    ``with_weights`` also returns the linear weights ``w``."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_rows, n_features)).astype(np.float32)
    w = rng.normal(size=(n_features,))
    logit = (x @ w * 0.3
             + 0.8 * x[:, 0] * x[:, 1]
             - 0.6 * np.abs(x[:, 2])
             + 0.5 * x[:, 3] ** 2)
    y = (logit + rng.logistic(size=n_rows) > 0).astype(np.float32)
    return (x, y, w) if with_weights else (x, y)


def feature_missing_types(n_features: int, seed: int, cat_features=()):
    """One missing type per numerical feature (0 none, 1 zero, 2 NaN),
    -1 for categorical ones; the same draw the row generator uses."""
    rng = np.random.default_rng(seed + 7)
    mt = rng.choice([0, 1, 2], size=n_features, p=[0.4, 0.2, 0.4])
    mt[list(cat_features)] = -1
    return mt


def random_model_text(*, n_trees: int, num_leaves: int, n_features: int,
                      seed: int, cat_features=(), n_cat: int = 40,
                      num_class: int = 1) -> str:
    """LightGBM model text of a seeded random forest, written by the
    port's own ``Tree`` and model-text writer.  Trees grow leaf-wise by
    random splits; numerical thresholds come from a per-feature grid of
    255 values; each numerical feature has one missing type, NaN
    features get a random default direction per node, zero-as-missing
    features the direction of 0.0; categorical features split on random
    raw-value bitsets."""
    from lightgbm_tpu_torch.models.model_text import (loaded_param_string,
                                                      save_model_to_string)
    from lightgbm_tpu_torch.models.tree import Tree

    rng = np.random.default_rng(seed)
    mt = feature_missing_types(n_features, seed, cat_features)
    grids = [np.sort(rng.normal(size=255)) for _ in range(n_features)]
    trees = []
    for _ in range(n_trees):
        nl = int(num_leaves)
        ni = nl - 1
        left = np.zeros(ni, np.int32)
        right = np.zeros(ni, np.int32)
        feat = np.zeros(ni, np.int32)
        thr = np.zeros(ni, np.float64)
        dtype = np.zeros(ni, np.uint8)
        leaf_parent = {0: (-1, 0)}
        cat_bounds, cat_words = [0], []
        for node in range(ni):
            leaf = int(rng.integers(0, node + 1))
            new_leaf = node + 1
            parent, side = leaf_parent[leaf]
            if parent >= 0:
                (left if side == 0 else right)[parent] = node
            left[node], right[node] = ~leaf, ~new_leaf
            leaf_parent[leaf] = (node, 0)
            leaf_parent[new_leaf] = (node, 1)
            f = int(rng.integers(0, n_features))
            feat[node] = f
            if mt[f] < 0:
                members = np.flatnonzero(rng.random(n_cat) < 0.5)
                if len(members) == 0:
                    members = np.array([0])
                words = np.zeros(int(members.max()) // 32 + 1, np.uint32)
                for v in members:
                    words[v // 32] |= np.uint32(1 << (int(v) % 32))
                thr[node] = len(cat_words)
                cat_words.append(words)
                cat_bounds.append(cat_bounds[-1] + len(words))
                dtype[node] = 1 | (2 << 2)
            else:
                thr[node] = grids[f][int(rng.integers(0, 255))]
                if mt[f] == 2:
                    dl = bool(rng.random() < 0.5)
                elif mt[f] == 1:
                    dl = 0.0 <= thr[node]
                else:
                    dl = False
                dtype[node] = (int(mt[f]) << 2) | (int(dl) << 1)
        t = Tree(num_leaves=nl)
        t.split_feature = feat
        t.threshold = thr
        t.threshold_bin = np.zeros(ni, np.int32)
        t.decision_type = dtype
        t.split_gain = rng.uniform(0.1, 10.0, ni)
        t.left_child, t.right_child = left, right
        t.internal_value = rng.normal(0, 0.1, ni)
        t.internal_weight = rng.uniform(1, 100, ni)
        t.internal_count = rng.integers(20, 1000, ni)
        t.leaf_value = rng.normal(0, 0.1, nl)
        t.leaf_weight = rng.uniform(1, 10, nl)
        t.leaf_count = rng.integers(20, 200, nl)
        t.num_cat = len(cat_words)
        t.cat_boundaries = np.asarray(cat_bounds, np.int32)
        t.cat_threshold = (np.concatenate(cat_words) if cat_words
                           else np.zeros(0, np.uint32))
        t.shrinkage = 0.1
        trees.append(t)
    model = types.SimpleNamespace(
        models=trees, num_class=num_class,
        num_tree_per_iteration=num_class,
        objective=("binary sigmoid:1" if num_class == 1
                   else f"multiclass num_class:{num_class}"),
        average_output=False,
        feature_names=[f"Column_{i}" for i in range(n_features)],
        feature_infos=["none" if mt[i] < 0 else "[-4:4]"
                       for i in range(n_features)],
        max_feature_idx=n_features - 1,
        param_string=loaded_param_string(num_class))
    return save_model_to_string(model)


def chain_model_text(depth: int, n_features: int, seed: int) -> str:
    """LightGBM model text of two chain trees of ``depth`` splits (each
    split's left child a leaf, its right child the next split): tree 0
    splits on feature ``i`` at level ``i`` (a unique depth of ``depth``,
    ``n_features >= depth``), tree 1 on feature ``i % 7`` (every level
    after the seventh takes a feature the path has).  Thresholds near
    -2 send most rows of ``make_rows`` deep; missing types and default
    directions as ``random_model_text``'s."""
    from lightgbm_tpu_torch.models.model_text import (loaded_param_string,
                                                      save_model_to_string)
    from lightgbm_tpu_torch.models.tree import Tree
    rng = np.random.default_rng(seed)
    mt = feature_missing_types(n_features, seed)
    trees = []
    for period in (n_features, 7):
        ni, nl = depth, depth + 1
        t = Tree(num_leaves=nl)
        t.split_feature = np.arange(ni, dtype=np.int32) % period
        t.threshold = rng.uniform(-2.5, -1.5, ni)
        t.threshold_bin = np.zeros(ni, np.int32)
        t.decision_type = np.array(
            [(int(mt[f]) << 2) | (int(mt[f] == 2 and rng.random() < 0.5
                                      or mt[f] == 1 and t.threshold[i] >= 0)
                                  << 1)
             for i, f in enumerate(t.split_feature)], np.uint8)
        t.split_gain = rng.uniform(0.1, 10.0, ni)
        t.left_child = ~np.arange(ni, dtype=np.int32)
        t.right_child = np.append(np.arange(1, ni, dtype=np.int32),
                                  np.int32(~ni))
        t.internal_value = rng.normal(0, 0.1, ni)
        t.internal_weight = rng.uniform(1, 100, ni)
        t.leaf_value = rng.normal(0, 0.1, nl)
        t.leaf_weight = rng.uniform(1, 10, nl)
        t.leaf_count = rng.integers(20, 200, nl)
        # each node's count its subtree's leaves'
        t.internal_count = np.cumsum(t.leaf_count[::-1])[::-1][:ni].copy()
        t.num_cat = 0
        t.cat_boundaries = np.array([0], np.int32)
        t.cat_threshold = np.zeros(0, np.uint32)
        t.shrinkage = 0.1
        trees.append(t)
    model = types.SimpleNamespace(
        models=trees, num_class=1, num_tree_per_iteration=1,
        objective="binary sigmoid:1", average_output=False,
        feature_names=[f"Column_{i}" for i in range(n_features)],
        feature_infos=["[-4:4]"] * n_features,
        max_feature_idx=n_features - 1,
        param_string=loaded_param_string(1))
    return save_model_to_string(model)


def make_rows(n_rows: int, n_features: int, seed: int, cat_features=(),
              n_cat: int = 40) -> np.ndarray:
    """Higgs-style f32 rows with the missing values of the model made
    from the same seed: 5% NaN on
    NaN-missing features, 3% exact zeros on zero-missing ones, and
    categorical columns of raw values from -2 to n_cat + 9 with NaN."""
    x, _ = make_higgs_like(n_rows, n_features, seed)
    rng = np.random.default_rng(seed + 1)
    mt = feature_missing_types(n_features, seed, cat_features)
    for f in range(n_features):
        if mt[f] == 2:
            x[rng.random(n_rows) < 0.05, f] = np.nan
        elif mt[f] == 1:
            x[rng.random(n_rows) < 0.03, f] = 0.0
        elif mt[f] < 0:
            x[:, f] = rng.integers(-2, n_cat + 10, n_rows)
            x[rng.random(n_rows) < 0.05, f] = np.nan
    return x


def adversarial_rows(forest, n_orig: int, seed: int = 0) -> np.ndarray:
    """f32 rows [n, n_orig] that put the quantizer's edge values in every
    used column: NaN, +-inf, +-0, +-1e-35 and their f32 neighbours,
    subnormals, each ``ub`` entry of the feature and one ulp either
    side; categorical columns get 3e9, 2^31, -1, -0.5, NaN, +-inf and
    the int32 range's edges.  Columns cycle through their lists, the
    rest of the row is seeded normal noise."""
    f = forest.numpy()
    f32 = np.float32
    tiny = f32(1e-35)
    common = [np.nan, np.inf, -np.inf, 0.0, -0.0, tiny, -tiny,
              np.nextafter(tiny, f32(0)), np.nextafter(tiny, f32(1)),
              np.nextafter(-tiny, f32(0)), np.nextafter(-tiny, f32(-1)),
              1e-40, -1e-40, np.float32(1.4e-45), np.float32(-1.4e-45)]
    cat_vals = [3e9, 2.0 ** 31, -1.0, -0.5, np.nan, np.inf, -np.inf, 0.0,
                -0.0, 0.5, 1.0, 7.9, 2147483520.0, -2147483648.0, -3e9,
                31.0, 32.0, 33.0, 1e-40]
    cols = {}
    for i, c in enumerate(f["used_cols"]):
        if f["cat_col"][i]:
            vals = np.asarray(cat_vals, f32)
        else:
            ub = f["ub"][i]
            ub = ub[np.isfinite(ub)].astype(f32)
            near = np.concatenate([ub, np.nextafter(ub, f32(np.inf)),
                                   np.nextafter(ub, f32(-np.inf))])
            vals = np.concatenate([np.asarray(common, f32), near])
        cols[int(c)] = vals
    n = max([len(v) for v in cols.values()] + [1])
    x = np.random.default_rng(seed).normal(size=(n, n_orig)).astype(f32)
    for c, vals in cols.items():
        x[:, c] = np.resize(vals, n)
    return x


def score_tolerance(scores: np.ndarray, n_trees: int) -> np.ndarray:
    """64 f32 ulps per tree, relative to max(|s|, 1): the f32 sums are
    taken in another order than the reference's."""
    return (64 * n_trees * np.finfo(np.float32).eps
            * np.maximum(np.abs(scores), 1.0))


# ---------------------------------------------------------------------
def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _leaf_depths(forest) -> np.ndarray:
    """[T, nl_pad] depth of each leaf (node visits to reach it)."""
    lc = forest.left_child.cpu().numpy()
    rc = forest.right_child.cpu().numpy()
    init = forest.init_node.cpu().numpy()
    depth = np.zeros((lc.shape[0], forest.leaf_value.shape[1]), np.int64)
    for t in range(lc.shape[0]):
        if init[t] < 0:
            depth[t, 0] = 1     # one step parks a single-leaf tree
            continue
        stack = [(0, 1)]
        while stack:
            node, d = stack.pop()
            for child in (int(lc[t, node]), int(rc[t, node])):
                if child < 0:
                    depth[t, ~child] = d
                else:
                    stack.append((child, d + 1))
    return depth


def _parity(sm, x: np.ndarray, n_real: int, label: str,
            wide=None) -> dict:
    """Both entries of the kernel, both forms, against the plain version
    on the card, same inputs: leaves exactly, scores bitwise (the plain
    version adds in the kernel's order) and within 64 ulps a tree; the
    raw entry's bins exactly ``quantize_rows_kernel``'s.  ``wide=True``
    packs the forest with the wide record."""
    import torch

    from lightgbm_tpu_torch.ops.predict import quantize_rows_kernel
    from lightgbm_tpu_torch.ops.serve_kernel import (forest_kernel_args,
                                                     pack_forest,
                                                     serve_traverse,
                                                     serve_traverse_raw,
                                                     serve_traverse_ref)
    f = sm.forest
    dev = f.device
    pf = pack_forest(f, sm.n_steps, wide=wide) if wide else sm.packed()
    raw = torch.from_numpy(x).to(dev)
    bins = quantize_rows_kernel(f, raw[:, f.used_cols.long()]).contiguous()
    n = bins.shape[0]
    k = sm.num_class
    largs = forest_kernel_args(f, leaves=True)
    sargs = forest_kernel_args(f)
    lk = torch.full((n, sm.n_trees), -7, dtype=torch.int32, device=dev)
    lr = torch.full_like(lk, -7)
    lp = torch.empty_like(lk)
    bo = torch.full_like(bins, -9)
    serve_traverse(largs, bins, n_real, lk, n_steps=sm.n_steps, leaves=True,
                   packed=pf)
    serve_traverse_raw(pf, raw, n_real, lr, leaves=True, bins_out=bo)
    serve_traverse_ref(largs, bins, n_real, lp, n_steps=sm.n_steps,
                       leaves=True)
    sk = torch.full((n, k), float("nan"), device=dev)
    sr = torch.full_like(sk, float("nan"))
    sp = torch.empty_like(sk)
    serve_traverse(sargs, bins, n_real, sk, n_steps=sm.n_steps, packed=pf)
    serve_traverse_raw(pf, raw, n_real, sr)
    serve_traverse_ref(sargs, bins, n_real, sp, n_steps=sm.n_steps)
    torch.cuda.synchronize()
    bins_exact = torch_equal(bo, bins)
    lk, lr, lp = lk.cpu().numpy(), lr.cpu().numpy(), lp.cpu().numpy()
    sk, sr, sp = sk.cpu().numpy(), sr.cpu().numpy(), sp.cpu().numpy()
    leaves_exact = bool(np.array_equal(lk, lp) and np.array_equal(lr, lp))
    err = np.maximum(np.abs(sk - sp), np.abs(sr - sp))
    scores_ok = bool(np.all(np.isfinite(sk)) and np.all(np.isfinite(sr))
                     and np.all(err <= score_tolerance(sp, sm.n_trees)))
    rec = {"case": label, "n": int(n), "n_real": int(n_real),
           "trees": sm.n_trees, "num_class": k, "tiles": pf.n_tiles,
           "wide": pf.wide, "staged_tiles": bool(pf.stage_units),
           "cat_words_w": sm.kernel_geometry()["cat_words_w"],
           "leaf_dtype": str(f.leaf_value.dtype).replace("torch.", ""),
           "leaves_exact": leaves_exact, "raw_bins_exact": bins_exact,
           "scores_bitwise_plain": bool(np.array_equal(sk, sp)
                                        and np.array_equal(sr, sp)),
           "max_abs_err": float(err.max()),
           "ok": leaves_exact and scores_ok and bins_exact}
    print("parity " + json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise RuntimeError(f"serve_traverse disagrees with its plain "
                           f"version on the card: {rec}")
    return rec


def _dispatch_breakdown(eng, x: np.ndarray, reps: int = 20) -> dict:
    """Where one bucketed dispatch's time goes, in ms per stage: the
    host-side pad (host clock), then on the stream the host-to-device
    copy, the quantizer and the traversal kernel, and the device-to-host
    copy of the live rows (CUDA events); the mean of ``reps`` runs after
    one warm-up.  An engine of the port's raw entry (``_packed``) runs
    the quantizer inside the kernel: its ``quantize`` stage is 0 and
    ``kernel`` holds both; an engine of an earlier commit runs
    ``quantize_rows_kernel`` and then the bins kernel (the package is
    the engine's own, so one process can time two commits)."""
    import importlib

    import torch

    pkg = type(eng).__module__.rsplit(".serve", 1)[0]
    sk = importlib.import_module(pkg + ".ops.serve_kernel")
    pred = importlib.import_module(pkg + ".ops.predict")
    n = x.shape[0]
    bucket = eng.bucket_for(n)
    model = eng.model
    raw_entry = hasattr(eng, "_packed")
    cols = model.forest.used_cols.long()
    buf = torch.empty((bucket, model.num_class), device=eng.device)
    stages = ("pad_host", "h2d", "quantize", "kernel", "d2h")
    sums = dict.fromkeys(stages, 0.0)
    for rep in range(reps + 1):
        t0 = time.perf_counter()
        padded = eng._pad(x, bucket)
        pad_ms = (time.perf_counter() - t0) * 1e3
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        raw = torch.from_numpy(padded).to(eng.device)
        ev[1].record()
        if raw_entry:
            ev[2].record()
            sk.serve_traverse_raw(eng._packed, raw, n, buf)
        else:
            bins = pred.quantize_rows_kernel(model.forest,
                                             raw[:, cols]).contiguous()
            ev[2].record()
            sk.serve_traverse(eng._scores_args, bins, n, buf,
                              n_steps=model.n_steps)
        ev[3].record()
        buf[:n].cpu()
        ev[4].record()
        torch.cuda.synchronize()
        if rep:
            sums["pad_host"] += pad_ms
            for i, name in enumerate(stages[1:]):
                sums[name] += ev[i].elapsed_time(ev[i + 1])
    out = {"rows": n, "bucket": bucket,
           "entry": "raw" if raw_entry else "bins"}
    out.update({k: v / reps for k, v in sums.items()})
    return out


def serve_phases(gpu: str, build_s: float) -> dict:
    """Slice 1 (slice 16's packed kernel): serve_traverse's two entries
    against their plain versions, then the serving main path (bulk
    predict and the queue, both through the raw entry), counted.
    Returns the kernel's record for the ``{"kernels": [...]}`` line."""
    import dataclasses

    import torch

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops.serve_kernel import serve_traverse

    # 2. kernel vs plain on the card: small edge forests, the quantizer's
    # edge values, the wide record, a forest past shared memory
    cat = (2, 5)
    small = []
    for label, k, bf16 in (("cat_f32_binary", 1, False),
                           ("cat_bf16_binary", 1, True),
                           ("cat_f32_multiclass3", 3, False)):
        text = random_model_text(n_trees=24 * k, num_leaves=63,
                                 n_features=10, seed=11 + k,
                                 cat_features=cat, num_class=k)
        sm = lgt.Booster(model_str=text).serving_engine().model
        if bf16:
            sm.forest = dataclasses.replace(
                sm.forest,
                leaf_value=sm.forest.leaf_value.to(torch.bfloat16))
        x = make_rows(1024, 10, 11 + k, cat)
        x[:7] = np.nan
        x[7:10, list(cat)] = np.array([[3e9], [np.inf], [-np.inf]],
                                      np.float32)
        small.append(_parity(sm, x, 1000, label))
        small.append(_parity(sm, x[:64], 64, label + "_n64"))
        small.append(_parity(sm, x, 1000, label + "_wide", wide=True))
        small.append(_parity(sm, adversarial_rows(sm.forest, 10, 11 + k),
                             1000, label + "_adversarial"))
    big_text = random_model_text(n_trees=2000, num_leaves=255,
                                 n_features=N_FEATURES, seed=3)
    big = lgt.Booster(model_str=big_text).serving_engine().model
    x_big = make_rows(512, N_FEATURES, 3)
    small.append(_parity(big, x_big, 500, "forest_2000x255"))
    small.append(_parity(big, x_big[:64], 64, "forest_2000x255_n64"))
    del big

    # the main path's forest and bucket
    main_text = random_model_text(n_trees=MAIN_TREES,
                                  num_leaves=MAIN_LEAVES,
                                  n_features=N_FEATURES, seed=0)
    bst = lgt.Booster(model_str=main_text)
    x_main = make_rows(MAIN_ROWS, N_FEATURES, 0)
    sm = bst.serving_engine().model
    main_par = _parity(sm, x_main[:BUCKET], BUCKET, "main_bucket")
    small.append(_parity(sm, x_main[:BUCKET], BUCKET - 17,
                         "main_bucket_padded"))
    small.append(_parity(sm, adversarial_rows(sm.forest, N_FEATURES, 1),
                         100, "main_adversarial"))

    # 3. the serving main path, counted: bulk predict, then the queue
    bst.predict(x_main[:100])          # warm: engine, pools, CUDA context
    torch.cuda.synchronize()
    serve_traverse.launches = 0
    t0 = time.perf_counter()
    prob = bst.predict(x_main)
    bulk_s = time.perf_counter() - t0
    bulk_launches = serve_traverse.launches
    q = lgt.ServingQueue(bst.serving_engine())
    for i in range(QUEUE_BATCHES):
        q.submit(x_main[i * QUEUE_ROWS:(i + 1) * QUEUE_ROWS])
    got = q.drain()
    launches = serve_traverse.launches
    lat = q.latency_percentiles()
    if bulk_launches <= 0 or launches - bulk_launches <= 0:
        raise RuntimeError("the main path launched serve_traverse 0 times")

    # what came out
    if prob.shape != (MAIN_ROWS,) or not np.all(np.isfinite(prob)) \
            or not np.all((prob >= 0) & (prob <= 1)):
        raise RuntimeError("bulk predict gave non-finite or out-of-range "
                           "probabilities")
    queued = np.concatenate(got, axis=0)[:, 0]
    raw_head = bst.predict(x_main[:QUEUE_BATCHES * QUEUE_ROWS],
                           raw_score=True)
    if not np.array_equal(queued, raw_head):
        raise RuntimeError("ServingQueue results disagree with bulk "
                           "predict (order or values)")
    xh = x_main[:HOST_ROWS].astype(np.float64)
    host_leaves = np.stack([t.predict_leaf(xh) for t in bst._models],
                           axis=1)
    eng_leaves = bst.serving_engine().predict_leaves(x_main[:HOST_ROWS])
    host_raw = sum(t.predict(xh) for t in bst._models)
    dev_raw = bst.predict(x_main[:HOST_ROWS], raw_score=True)
    if not np.array_equal(eng_leaves, host_leaves):
        raise RuntimeError("kernel leaf indices differ from the f64 host "
                           "walk")
    if not np.all(np.abs(dev_raw - host_raw)
                  <= score_tolerance(host_raw, MAIN_TREES)):
        raise RuntimeError("kernel scores differ from the f64 host walk "
                           "beyond 64 ulps per tree")
    print(f"main path: {MAIN_TREES} trees x {MAIN_LEAVES} leaves, "
          f"depth {sm.n_steps}, {MAIN_ROWS} rows in {bulk_s:.3f} s = "
          f"{MAIN_ROWS / bulk_s:.0f} rows/s; queue {QUEUE_BATCHES}x"
          f"{QUEUE_ROWS} rows p50 {lat['p50_ms']} ms p99 "
          f"{lat['p99_ms']} ms; launches {bulk_launches} bulk + "
          f"{launches - bulk_launches} queue; host walk parity ok on "
          f"{HOST_ROWS} rows [{gpu}]", flush=True)

    times = serve_times(sm, x_main, gpu)
    big_t = times[str(BUCKET)]
    kernels = [{
        "name": "serve_traverse",
        "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/serve_traverse.cu",
        "replaces": "lightgbm_tpu/ops/pallas/serve_kernel.py:219",
        "launches": launches,
        "launches_bulk": bulk_launches,
        "launches_queue": launches - bulk_launches,
        "max_abs_err": max(r["max_abs_err"] for r in [main_par] + small),
        "ms": big_t["raw_ms"],
        "plain_ms": big_t["plain_ms"],
        "bound_ms": big_t["bound_ms"],
        "bound_by": big_t["bound_by"],
        "library_ms": None,
        "graph_ms": big_t["raw_graph_ms"],
        "ms_64": times[str(QUEUE_ROWS)]["raw_ms"],
        "graph_ms_64": times[str(QUEUE_ROWS)]["raw_graph_ms"],
        "bound_ms_64": times[str(QUEUE_ROWS)]["bound_ms"],
        "parity": "ok",
        "leaves_exact": all(r["leaves_exact"] for r in [main_par] + small),
        "raw_bins_exact": all(r["raw_bins_exact"]
                              for r in [main_par] + small),
        "gpu": gpu,
        "rows_per_s": MAIN_ROWS / bulk_s,
        "queue_p50_ms": lat["p50_ms"],
        "queue_p99_ms": lat["p99_ms"],
        "build_s": build_s,
    }]
    eng = bst.serving_engine()
    for rows in (BUCKET, QUEUE_ROWS):
        print("breakdown " + json.dumps(dict(
            _dispatch_breakdown(eng, x_main[:rows]), gpu=gpu)), flush=True)
    t0 = time.perf_counter()
    np.asarray(np.asarray(x_main, np.float64), np.float32)
    print(f"breakdown booster f64 -> f32 input copies of {MAIN_ROWS} rows: "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms (host)", flush=True)
    return kernels[0]


def serve_bound(sm, x: np.ndarray) -> dict:
    """The least time of the raw entry on ``x`` (all rows live): the
    bytes it must move (the raw rows, the packed forest and the
    quantizer's tables once, the scores once) over the HBM rate, and its
    operations (``OPS_PER_VISIT`` a node visit this data makes, and a
    binary search of the thresholds a used feature of a row) over the
    f32 rate."""
    import torch

    from lightgbm_tpu_torch.ops.serve_kernel import (forest_kernel_args,
                                                     serve_traverse_ref)
    f = sm.forest
    pf = sm.packed()
    n = x.shape[0]
    from lightgbm_tpu_torch.ops.predict import quantize_rows_kernel
    raw = torch.from_numpy(x).to(f.device)
    bins = quantize_rows_kernel(f, raw[:, f.used_cols.long()]).contiguous()
    leaves = torch.empty((n, sm.n_trees), dtype=torch.int32,
                         device=f.device)
    serve_traverse_ref(forest_kernel_args(f, leaves=True), bins, n, leaves,
                       n_steps=sm.n_steps, leaves=True)
    depth = _leaf_depths(f)
    visits = int(depth[np.arange(sm.n_trees)[None, :],
                       leaves.cpu().numpy()].sum())
    n_feat = int(f.used_cols.shape[0])
    bq = int(f.ub.shape[1])
    search = 3 * int(np.ceil(np.log2(bq + 1))) + 4
    n_bytes = (x.size * 4 + pf.blob.numel() * 4 + pf.qmeta.numel() * 4
               + f.ub.numel() * 4 + 8 * pf.trees + n * sm.num_class * 4)
    n_ops = visits * OPS_PER_VISIT + n * n_feat * search
    bytes_ms = n_bytes / PEAK_BYTES_S * 1e3
    ops_ms = n_ops / PEAK_OPS_S * 1e3
    return {"bytes": n_bytes, "visits": visits, "ops": n_ops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def serve_times(sm, x_main: np.ndarray, gpu: str) -> dict:
    """The kernel's times at the main path's bucket and at the queue's
    64 rows, rows and forest hot in L2 as in steady serving: the raw
    entry (the quantizer inside) and the bins entry, eager (20 calls
    back to back) and as one replay of a graph of 20 calls, beside the
    plain version (quantize_rows_kernel and serve_traverse_ref, 65,536
    rows only) and the bound; the kernels a raw call launches from a
    profiler trace."""
    import torch

    from lightgbm_tpu_torch.ops.predict import quantize_rows_kernel
    from lightgbm_tpu_torch.ops.serve_kernel import (forest_kernel_args,
                                                     serve_geometry,
                                                     serve_traverse,
                                                     serve_traverse_raw,
                                                     serve_traverse_raw_ref)
    f = sm.forest
    pf = sm.packed()
    sargs = forest_kernel_args(f)
    out = {}
    for n in (BUCKET, QUEUE_ROWS):
        raw = torch.from_numpy(x_main[:n]).cuda()
        bins = quantize_rows_kernel(f, raw[:, f.used_cols.long()]
                                    ).contiguous()
        buf = torch.empty((n, 1), device="cuda")
        before = serve_traverse.launches
        raw_ms, raw_graph = eager_and_graph_ms(
            lambda: serve_traverse_raw(pf, raw, n, buf))
        bins_ms, bins_graph = eager_and_graph_ms(
            lambda: serve_traverse(sargs, bins, n, buf,
                                   n_steps=sm.n_steps, packed=pf))
        if serve_traverse.launches <= before:
            raise RuntimeError("the timed calls did not launch the kernel")
        geo = serve_geometry(pf, n, int(f.used_cols.shape[0]), raw=True,
                             leaves=False)
        rec = {"rows": n, "raw_ms": raw_ms, "raw_graph_ms": raw_graph,
               "bins_ms": bins_ms, "bins_graph_ms": bins_graph,
               "geometry": dict(rows=geo.rows, grid=[geo.grid_x, geo.grid_y],
                                tiles_per_block=geo.tiles_per_block,
                                nbuf=geo.nbuf, smem=geo.smem),
               "kernels": kernels_of_call(
                   lambda: serve_traverse_raw(pf, raw, n, buf))}
        if n == BUCKET:
            rec["plain_ms"] = _time_ms(
                lambda: serve_traverse_raw_ref(pf, raw, n, buf), 3)
        rec.update(serve_bound(sm, x_main[:n]))
        out[str(n)] = rec
    print("serve times [ms] " + json.dumps(dict(out, gpu=gpu)), flush=True)
    return out


# ---------------------------------------------------------------------
# Slice 2: training on the card
TRAIN_ROWS = 1_000_000
HOLDOUT_ROWS = 100_000
TRAIN_LEAVES = 255
TRAIN_ITERS = 10
PARITY_ROWS = 20_000
PARITY_TREES = 1
# the leaves of the card-against-CPU runs of every phase after the
# training main paths (the script's time budget: a CPU tree's time is
# about its splits')
PARITY_CUT_LEAVES = 31
TRAIN_PARAMS = {"objective": "binary", "num_leaves": TRAIN_LEAVES,
                "max_bin": 255, "learning_rate": 0.1, "metric": "auc",
                "verbosity": -1}
LEAF_RTOL = 1e-5
EPS32 = float(np.finfo(np.float32).eps)
# bytes per row of the row matrix: F u8 bins + 3 f32 values + i32 row id
# + f32 score + 2 f32 objective constants
ROW_EXTRA_BYTES = 28


def random_row_matrix(n_rows: int, n_features: int, seed: int,
                      n_bins: int = 255, nan_bin: int = -1):
    """A seeded row matrix ``(bins u8 [n, F], vals f32 [n, 3], rid i32
    [n], score f32 [n], consts f32 [n, 2])``: uniform bins below
    ``n_bins`` (with ``nan_bin`` >= 0, 5% of feature 0's rows sit in
    that bin), gradient-like values, a shuffled row-id column, raw
    scores and binary-style constants (sign +-1, label weight)."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, n_bins, size=(n_rows, n_features), dtype=np.uint8)
    if nan_bin >= 0:
        bins[rng.random(n_rows) < 0.05, 0] = nan_bin
    w = (rng.random(n_rows) < 0.9).astype(np.float32)
    vals = np.stack([rng.normal(size=n_rows).astype(np.float32) * w,
                     rng.uniform(0.01, 0.25, n_rows).astype(np.float32) * w,
                     w], axis=1)
    rid = rng.permutation(n_rows).astype(np.int32)
    score = rng.normal(size=n_rows).astype(np.float32)
    consts = np.stack([np.where(rng.random(n_rows) < 0.5, 1.0, -1.0),
                       rng.uniform(0.5, 2.0, n_rows)], axis=1)
    return (bins, np.ascontiguousarray(vals), rid, score,
            np.ascontiguousarray(consts, dtype=np.float32))


def rows_on(arrays, device):
    """A copy of numpy row arrays as the port's ``Rows`` on ``device``."""
    import torch

    from lightgbm_tpu_torch.ops.device_data import Rows
    return Rows(*(torch.tensor(a, device=device) for a in arrays))


def hist_tolerance(rows, rng) -> float:
    """4 * n * eps_f32 * max|v| over the n rows of the range: f32 sums
    of the same values taken in another order."""
    from lightgbm_tpu_torch.ops.hist_kernel2 import _window
    lo, hi = _window(rng, rows.bins.shape[0])
    if hi <= lo:
        return 0.0
    vmax = float(rows.vals[lo:hi, :2].abs().max())
    return 4.0 * (hi - lo) * EPS32 * vmax


def hist_parity(rows, rng, padded_bins: int, label: str) -> dict:
    """Kernel vs plain version on the same rows and range, and two
    kernel launches bitwise equal."""
    import torch

    from lightgbm_tpu_torch.ops.hist_kernel2 import (
        build_histogram_comb, build_histogram_comb_ref)
    dev = rows.bins.device
    rng_t = torch.tensor(rng, dtype=torch.int32, device=dev)
    max_rows = max(int(rng[2]), 1)
    k1 = build_histogram_comb(rows, rng_t, padded_bins=padded_bins,
                              max_rows=max_rows)
    k2 = build_histogram_comb(rows, rng_t, padded_bins=padded_bins,
                              max_rows=max_rows)
    ref = build_histogram_comb_ref(rows, rng_t, padded_bins=padded_bins,
                                   max_rows=max_rows)
    torch.cuda.synchronize()
    err = float((k1 - ref).abs().max())
    tol = hist_tolerance(rows, rng)
    rec = {"case": label, "range": list(rng), "max_abs_err": err,
           "tol": tol, "bitwise_repeat": bool(torch.equal(k1, k2)),
           "finite": bool(torch.isfinite(k1).all())}
    rec["ok"] = rec["bitwise_repeat"] and rec["finite"] and err <= tol
    print("parity hist_comb " + json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise RuntimeError(f"hist_comb disagrees with its plain version: "
                           f"{rec}")
    return rec


def partition_parity(rows, sel, label: str) -> dict:
    """Scan and copyback against their plain versions on copies of the
    same rows: the scanned segment byte-identical with equal nleft,
    then the whole row matrix byte-identical after the copyback."""
    import torch

    from lightgbm_tpu_torch.ops.device_data import Rows
    from lightgbm_tpu_torch.ops.partition_kernel import (
        copyback, copyback_ref, partition_scan, partition_scan_ref)
    dev = rows.bins.device
    rk = Rows(*(a.clone() for a in rows))
    rp = Rows(*(a.clone() for a in rows))
    sk = Rows(*(torch.zeros_like(a) for a in rows))
    sp = Rows(*(torch.zeros_like(a) for a in rows))
    nk = torch.full((1,), -1, dtype=torch.int32, device=dev)
    npl = torch.full((1,), -2, dtype=torch.int32, device=dev)
    s0, cnt = int(sel[0]), int(sel[1])
    partition_scan(rk, sk, sel, nk)
    partition_scan_ref(rp, sp, sel, npl)
    torch.cuda.synchronize()
    scan_ok = all(torch.equal(a[s0:s0 + cnt], b[s0:s0 + cnt])
                  for a, b in zip(sk, sp)) and int(nk) == int(npl)
    copyback(rk, sk, s0, cnt)
    copyback_ref(rp, sp, s0, cnt)
    torch.cuda.synchronize()
    rows_ok = all(torch.equal(a, b) for a, b in zip(rk, rp))
    rec = {"case": label, "s0": s0, "cnt": cnt, "nleft": int(nk),
           "scan_identical": bool(scan_ok), "rows_identical": rows_ok,
           "ok": bool(scan_ok and rows_ok)}
    print("parity partition " + json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise RuntimeError(f"partition kernels disagree with their plain "
                           f"versions: {rec}")
    return rec


def partition_3ph_parity(rows, sel, label: str) -> dict:
    """partition_3ph against its plain version on copies of the same
    rows, on the card and on CPU copies: the whole row matrix
    byte-identical (so rows outside the segment untouched), equal nleft,
    one counted launch (none for a dead split)."""
    import torch

    from lightgbm_tpu_torch.ops.device_data import Rows
    from lightgbm_tpu_torch.ops.partition_kernel import (partition_3ph,
                                                         partition_3ph_ref)
    dev = rows.bins.device
    rk = Rows(*(a.clone() for a in rows))
    rp = Rows(*(a.clone() for a in rows))
    rc = Rows(*(a.cpu().clone() for a in rows))
    scratch = lambda r: Rows(*(torch.zeros_like(a) for a in r))  # noqa
    nk = torch.full((1,), -1, dtype=torch.int32, device=dev)
    npl = torch.full((1,), -2, dtype=torch.int32, device=dev)
    nc = torch.full((1,), -3, dtype=torch.int32)
    launches = partition_3ph.launches
    partition_3ph(rk, scratch(rk), sel, nk)
    partition_3ph_ref(rp, scratch(rp), sel, npl)
    partition_3ph_ref(rc, scratch(rc), sel, nc)
    torch.cuda.synchronize()
    s0, cnt = int(sel[0]), int(sel[1])
    rec = {"case": label, "s0": s0, "cnt": cnt, "words": len(sel) - 8
           if len(sel) > 8 else 0, "nleft": int(nk),
           "nleft_equal": int(nk) == int(npl) == int(nc),
           "rows_identical": _rows_equal(rk, rp),
           "cpu_plain_identical": _rows_equal(Rows(*(a.cpu() for a in rk)),
                                              rc),
           "launched": partition_3ph.launches - launches}
    rec["ok"] = (rec["nleft_equal"] and rec["rows_identical"]
                 and rec["cpu_plain_identical"]
                 and rec["launched"] == (1 if cnt > 0 else 0))
    print("parity partition_3ph " + json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise RuntimeError(f"partition_3ph disagrees with its plain version: "
                           f"{rec}")
    return rec


# membership words of the partitions' bitset case: word 2 with bit 31
# set, word 7 bit 31 alone (as i32)
EDGE_WORDS = (0x0F0F0F0F, 0x12345678, -0x7FFF0000, 0, 0x7FFFFFFF,
              0x55555555, 0x00010001, -0x80000000)


def partition_edge_cases(tile: int, nan_bin: int, n_rows: int = 0,
                         bitset: bool = False) -> list:
    """[(label, sel)] of the partitions' adversarial segments for a scan
    of ``tile``-row tiles over rows of at least 6 features whose feature
    0 holds ``nan_bin`` and whose other bins lie below 255: every row
    left, every row right, one row (at the middle of ``n_rows``), one
    row past a tile boundary (and two tiles past), an odd ``s0`` with
    the NaN bin routed left and right, a one-hot categorical split and,
    with ``bitset``, one of 8 membership words over feature 5 (the
    3-phase partition's descriptor)."""
    out = [("all_left", (1, 3 * tile + 5, 1, 254, 0, 0, -1)),
           ("all_right", (2, 2 * tile + 7, 1, -1, 0, 0, -1)),
           ("one_row", (n_rows // 2 + 1, 1, 2, 100, 0, 0, -1)),
           ("one_past_tile", (0, tile + 1, 3, 127, 0, 0, -1)),
           ("two_tiles_and_one", (tile, 2 * tile + 1, 3, 60, 0, 0, -1)),
           ("odd_s0_nan_left", (1_235, 4 * tile + 3, 0, 90, 1, 0, nan_bin)),
           ("odd_s0_nan_right", (777, 2 * tile + 1, 0, 90, 0, 0, nan_bin)),
           ("one_hot_categorical", (5, 3 * tile - 1, 4, 17, 0, 1, -1))]
    if bitset:
        out.append(("bitset_8_words", (129, 3 * tile + 2, 5, 0, 0, 1, -1, 0,
                                       *EDGE_WORDS)))
    return out


def _rows_equal(a, b, lo: int = 0, hi=None) -> bool:
    return all(torch_equal(x[lo:hi], y[lo:hi]) for x, y in zip(a, b))


def torch_equal(a, b) -> bool:
    """Bitwise equality of two tensors (NaNs with equal bits are equal)."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        view = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a = a.contiguous().view(view[a.element_size()])
        b = b.contiguous().view(view[b.element_size()])
    return bool(torch.equal(a, b))


def stream_aux(n: int, kind: str, seed: int, device):
    """Seeded stream-route inputs: scores, validity (90 % valid) and the
    objective's constants (binary: sign, label weight; l2: target,
    weight)."""
    import torch
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)  # noqa
    score = t(rng.normal(size=n) * 2.0)
    valid = t(rng.random(n) < 0.9)
    if kind == "binary":
        c = np.stack([np.where(rng.random(n) < 0.4, 1.0, -1.0),
                      rng.uniform(0.5, 2.0, n)], axis=1)
    else:
        c = np.stack([rng.normal(size=n), rng.uniform(0.5, 2.0, n)], axis=1)
    return score, valid, t(c).contiguous()


def stream_parity(bins, kind: str, padded_bins: int, label: str,
                  sigmoid: float = 1.0, seed: int = 5) -> dict:
    """stream_init and stream_refresh against their plain versions on the
    same inputs, bitwise (rows after init, rows after the refresh), and
    the refresh's root histogram bitwise equal to hist_comb over [0, n)
    of the refreshed rows."""
    import torch

    from lightgbm_tpu_torch.ops.hist_kernel2 import build_histogram_comb
    from lightgbm_tpu_torch.ops.stream_grad import (stream_init,
                                                    stream_init_ref,
                                                    stream_refresh,
                                                    stream_refresh_ref)
    dev = bins.device
    n = bins.shape[0]
    score, valid, consts = stream_aux(n, kind, seed, dev)
    kw = dict(kind=kind, sigmoid=sigmoid)
    rk = stream_init(bins, score, valid, consts, **kw)
    rp = stream_init_ref(bins, score, valid, consts, **kw)
    torch.cuda.synchronize()
    init_ok = _rows_equal(rk, rp)
    lv = torch.tensor(np.random.default_rng(seed + 1).normal(size=n) * 0.1,
                      dtype=torch.float32, device=dev)
    hk = stream_refresh(rk, lv, padded_bins=padded_bins, **kw)
    hp = stream_refresh_ref(rp, lv, padded_bins=padded_bins, **kw)
    root = torch.tensor([0, 0, n], dtype=torch.int32, device=dev)
    hc = build_histogram_comb(rk, root, padded_bins=padded_bins, max_rows=n)
    torch.cuda.synchronize()
    rec = {"case": label, "n": n, "kind": kind, "init_identical": init_ok,
           "refresh_identical": _rows_equal(rk, rp),
           "root_hist_bitwise_hist_comb": torch_equal(hk, hc),
           "root_hist_vs_plain_max_abs_err": float((hk - hp).abs().max()),
           "tol": hist_tolerance(rk, (0, 0, n))}
    rec["ok"] = (init_ok and rec["refresh_identical"]
                 and rec["root_hist_bitwise_hist_comb"]
                 and rec["root_hist_vs_plain_max_abs_err"] <= rec["tol"])
    print("parity stream_grad " + json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise RuntimeError(f"stream kernels disagree with their plain "
                           f"versions: {rec}")
    return rec


def refresh_plain_parity(bins, kind: str, padded_bins: int, label: str,
                         sigmoid: float = 1.0, seed: int = 5) -> dict:
    """stream_refresh_plain against its plain version on the same rows
    (the plain init's), bitwise, one counted launch; and the rows the
    fused route's refresh leaves, bitwise the same.  Its plain version
    on CPU copies is reported beside it (the f64 ``exp`` of the card and
    of the CPU may round differently in a rare last place)."""
    import torch

    from lightgbm_tpu_torch.ops.device_data import Rows
    from lightgbm_tpu_torch.ops.stream_grad import (stream_init_ref,
                                                    stream_refresh,
                                                    stream_refresh_plain,
                                                    stream_refresh_plain_ref)
    dev = bins.device
    n = bins.shape[0]
    score, valid, consts = stream_aux(n, kind, seed, dev)
    kw = dict(kind=kind, sigmoid=sigmoid)
    rk = stream_init_ref(bins, score, valid, consts, **kw)
    rp = Rows(*(a.clone() for a in rk))
    rf = Rows(*(a.clone() for a in rk))
    rc = Rows(*(a.cpu().clone() for a in rk))
    lv = torch.tensor(np.random.default_rng(seed + 1).normal(size=n) * 0.1,
                      dtype=torch.float32, device=dev)
    launches = stream_refresh_plain.launches
    stream_refresh_plain(rk, lv, **kw)
    stream_refresh_plain_ref(rp, lv, **kw)
    stream_refresh(rf, lv, padded_bins=padded_bins, **kw)
    stream_refresh_plain_ref(rc, lv.cpu(), **kw)
    torch.cuda.synchronize()
    rec = {"case": label, "n": n, "kind": kind,
           "rows_identical": _rows_equal(rk, rp),
           "fused_refresh_rows_identical": _rows_equal(rk, rf),
           "cpu_plain_identical": _rows_equal(Rows(*(a.cpu() for a in rk)),
                                              rc),
           "launched": stream_refresh_plain.launches - launches}
    rec["ok"] = (rec["rows_identical"] and rec["fused_refresh_rows_identical"]
                 and rec["launched"] == 1)
    print("parity stream_refresh_plain " + json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise RuntimeError(f"stream_refresh_plain disagrees with its plain "
                           f"version: {rec}")
    return rec


# the pack=1 init's and plain refresh's odd shapes: row counts off a
# group of 4 rows and a block of 256, feature counts off a 16-byte word
# (5, 28, 36) and wide (136)
STREAM_SHAPE_ROWS = (1, 3, 4097, 1_000_003)
STREAM_SHAPE_FEATURES = (28, 36, 5, 136)


def stream_shape_parity(n: int, f: int, kind: str, device, seed: int = 41,
                        offset: bool = False) -> dict:
    """``stream_init`` and ``stream_refresh_plain`` against their plain
    versions on the same seeded inputs at ``n`` rows x ``f`` features,
    bitwise: the rows after the init, then the rows after the refresh.
    ``offset`` hands the init a score and the refresh an ``lv`` that
    start 4 bytes past a 16-byte boundary (the kernels' 4-byte path)."""
    import torch

    from lightgbm_tpu_torch.ops.device_data import Rows
    from lightgbm_tpu_torch.ops.stream_grad import (stream_init,
                                                    stream_init_ref,
                                                    stream_refresh_plain,
                                                    stream_refresh_plain_ref)
    gen = torch.Generator(device=device).manual_seed(seed + n + f)
    bins = torch.randint(0, 256, (n, f), dtype=torch.uint8, device=device,
                         generator=gen)
    score, valid, consts = stream_aux(n, kind, seed, device)
    lv = torch.tensor(np.random.default_rng(seed + 1).normal(size=n) * 0.1,
                      dtype=torch.float32, device=device)
    if offset:
        shifted = torch.empty(n + 1, dtype=torch.float32, device=device)
        shifted[1:] = score
        score = shifted[1:]
        shifted = torch.empty(n + 1, dtype=torch.float32, device=device)
        shifted[1:] = lv
        lv = shifted[1:]
    kw = dict(kind=kind, sigmoid=1.0)
    launches = (stream_init.launches, stream_refresh_plain.launches)
    rk = stream_init(bins, score, valid, consts, **kw)
    rp = stream_init_ref(bins, score, valid, consts, **kw)
    rec = {"n": n, "f": f, "kind": kind, "offset": offset,
           "init_identical": _rows_equal(rk, rp)}
    rc = Rows(*(a.clone() for a in rp))
    stream_refresh_plain(rc, lv, **kw)
    stream_refresh_plain_ref(rp, lv, **kw)
    rec["refresh_identical"] = _rows_equal(rc, rp)
    rec["launched"] = [stream_init.launches - launches[0],
                       stream_refresh_plain.launches - launches[1]]
    rec["ok"] = (rec["init_identical"] and rec["refresh_identical"]
                 and rec["launched"] == [1, 1])
    return rec


def stream_shape_cases() -> list:
    """(n, f, kind, offset) of :func:`stream_shape_parity`'s cases: every
    row count at every feature count for both objectives, and the
    offset pointers at 28 features."""
    cases = [(n, f, kind, False) for f in STREAM_SHAPE_FEATURES
             for n in STREAM_SHAPE_ROWS for kind in ("binary", "l2")]
    return cases + [(n, 28, kind, True) for n in (4097, 1_000_003)
                    for kind in ("binary", "l2")]


def stream_shape_parities() -> dict:
    """Every :func:`stream_shape_cases` case on the card; prints
    ``parity stream shapes {...}`` and raises on a case that is not
    bitwise."""
    import torch
    dev = torch.device("cuda")
    recs = [stream_shape_parity(n, f, kind, dev, offset=off)
            for n, f, kind, off in stream_shape_cases()]
    torch.cuda.synchronize()
    out = {"cases": len(recs), "bitwise": all(r["ok"] for r in recs),
           "failed": [r for r in recs if not r["ok"]]}
    print("parity stream shapes " + json.dumps(out), flush=True)
    if not out["bitwise"]:
        raise RuntimeError(f"stream_init / stream_refresh_plain disagree "
                           f"with their plain versions: {out['failed']}")
    return out


def fused_parity(rows, sel, padded_bins: int, label: str) -> dict:
    """fused_split against its plain version on copies of the same rows:
    the scratch segment byte-identical with equal nleft, each side's
    histogram bitwise equal to hist_comb of that child's range (grid of
    max_rows = cnt // 2 + 1) and within 4 * n * eps_f32 * max|v| of the
    plain version, then the rows byte-identical after the copyback."""
    import torch

    from lightgbm_tpu_torch.ops.device_data import Rows
    from lightgbm_tpu_torch.ops.fused_split import (child_ranges,
                                                    fused_split,
                                                    fused_split_ref)
    from lightgbm_tpu_torch.ops.hist_kernel2 import build_histogram_comb
    from lightgbm_tpu_torch.ops.partition_kernel import copyback, copyback_ref
    dev = rows.bins.device
    rk = Rows(*(a.clone() for a in rows))
    rp = Rows(*(a.clone() for a in rows))
    sk = Rows(*(torch.zeros_like(a) for a in rows))
    sp = Rows(*(torch.zeros_like(a) for a in rows))
    nk = torch.full((1,), -1, dtype=torch.int32, device=dev)
    npl = torch.full((1,), -2, dtype=torch.int32, device=dev)
    s0, cnt = int(sel[0]), int(sel[1])
    launches = fused_split.launches
    hk = fused_split(rk, sk, sel, nk, padded_bins=padded_bins)
    hp = fused_split_ref(rp, sp, sel, npl, padded_bins=padded_bins)
    torch.cuda.synchronize()
    scan_ok = _rows_equal(sk, sp, s0, s0 + cnt) and int(nk) == int(npl)
    hist_bitwise, err, tol = True, 0.0, 0.0
    for side, rng in enumerate(child_ranges(s0, cnt, int(nk))):
        hc = build_histogram_comb(
            sk, torch.tensor(rng, dtype=torch.int32, device=dev),
            padded_bins=padded_bins, max_rows=cnt // 2 + 1)
        hist_bitwise &= torch_equal(hk[side], hc)
        err = max(err, float((hk[side] - hp[side]).abs().max()))
        tol = max(tol, hist_tolerance(sk, rng))
    copyback(rk, sk, s0, cnt)
    copyback_ref(rp, sp, s0, cnt)
    torch.cuda.synchronize()
    rec = {"case": label, "s0": s0, "cnt": cnt, "nleft": int(nk),
           "scan_identical": scan_ok, "rows_identical": _rows_equal(rk, rp),
           "hist_bitwise_hist_comb": hist_bitwise, "max_abs_err": err,
           "tol": tol, "launched": fused_split.launches - launches}
    rec["ok"] = (scan_ok and rec["rows_identical"] and hist_bitwise
                 and err <= tol
                 and rec["launched"] == (1 if cnt > 0 else 0))
    print("parity fused_split " + json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise RuntimeError(f"fused_split disagrees with its plain version: "
                           f"{rec}")
    return rec


def split_state(grower, rows):
    """A real split's inputs to the tail: the root's tree state built by
    ``grower`` from ``rows``, the root's best split applied by the fused
    split (rows partitioned in place) and its histogram pair, nleft and
    the SplitAt."""
    import torch

    from lightgbm_tpu_torch.ops.apply_find import BB, BDL, BF, SplitAt
    from lightgbm_tpu_torch.ops.device_data import empty_rows_like
    from lightgbm_tpu_torch.ops.fused_split import fused_split
    from lightgbm_tpu_torch.ops.hist_kernel2 import build_histogram_comb
    from lightgbm_tpu_torch.ops.partition_kernel import copyback
    dd = grower.dd
    n, dev, b = dd.num_data, dd.device, dd.padded_bins
    root = torch.tensor([0, 0, n], dtype=torch.int32, device=dev)
    fmask = torch.ones(dd.num_features, dtype=torch.float32, device=dev)
    st = grower.init_tree_state(
        rows, build_histogram_comb(rows, root, padded_bins=b, max_rows=n),
        fmask)
    feat, sbin, dl = (int(v) for v in st.best[0, [BF, BB, BDL]].tolist())
    nanb = (int(dd.num_bins[feat]) - 1 if bool(dd.has_nan[feat]) else -1)
    cat = int(bool(dd.is_cat[feat]))
    sel = (0, n, feat, sbin, dl, cat, nanb)
    nleft = torch.zeros(1, dtype=torch.int32, device=dev)
    scratch = empty_rows_like(rows)
    pair = fused_split(rows, scratch, sel, nleft, padded_bins=b)
    copyback(rows, scratch, 0, n)
    return st, pair, nleft, fmask, SplitAt(0, 1, 0, 0, n)


def apply_find_parity(grower, rows, label: str) -> dict:
    """:func:`tail_parity` on a real split: the root's state built by
    ``grower`` from ``rows`` and its best split applied
    (:func:`split_state`)."""
    from lightgbm_tpu_torch.tools.profile_apply_find import TailCase
    st, pair, nleft, fmask, at = split_state(grower, rows)
    return tail_parity(TailCase(pair[0], pair[1], nleft, st, grower.finder,
                                fmask, grower.hp, grower.max_depth, at),
                       label)


def tail_parity(case, label: str, want_features=None) -> dict:
    """apply_find_pool and apply_find on ``case`` (a
    ``tools.profile_apply_find.TailCase`` on the card) against their
    plain versions on the card and on CPU copies, bitwise (every state
    tensor and both pool rows), and the done guard leaving every tensor
    untouched; ``want_features``: the features both children's splits
    must lie in (the adversarial cases).  Launches the pool entry twice and the
    plain-pool entry once."""
    import torch

    from lightgbm_tpu_torch.ops.apply_find import (BF, TreeState, apply_find,
                                                   apply_find_pool,
                                                   apply_find_pool_ref,
                                                   apply_find_ref,
                                                   tail_geometry)
    at = case.at
    copy = lambda s: TreeState(*(a.clone() for a in s))  # noqa: E731
    cpu = case.to("cpu")
    sk, sp, sc = copy(case.st), copy(case.st), copy(cpu.st)
    apply_find_pool(case.h_a, case.h_b, case.nleft, sk, *case.args()[2:])
    apply_find_pool_ref(case.h_a, case.h_b, case.nleft, sp,
                        *case.args()[2:])
    apply_find_pool_ref(cpu.h_a, cpu.h_b, cpu.nleft, sc, *cpu.args()[2:])
    torch.cuda.synchronize()
    pool_ok = all(torch_equal(a, b) for a, b in zip(sk, sp))
    pool_cpu = all(torch_equal(a.cpu(), b) for a, b in zip(sk, sc))
    h2 = torch.stack([sp.pool[at.leaf], sp.pool[at.right]]).contiguous()
    pk, pp = copy(case.st), copy(case.st)
    apply_find(h2, case.nleft, pk, *case.args()[2:])
    apply_find_ref(h2, case.nleft, pp, *case.args()[2:])
    dk = copy(case.st)
    apply_find_pool(case.h_a, case.h_b, case.nleft, dk, *case.args()[2:-1],
                    at._replace(done=1))
    torch.cuda.synchronize()
    f, b = case.h_a.shape[:2]
    feats = [int(v) for v in sk.best[[at.leaf, at.right], BF].tolist()]
    rec = {"case": label, "features": int(f), "bins": int(b),
           "cnt": at.cnt, "nleft": int(case.nleft),
           "geometry": tail_geometry(int(f), int(b))._asdict(),
           "pool_entry_identical": pool_ok,
           "pool_entry_identical_cpu_plain": pool_cpu,
           "plain_entry_identical": all(torch_equal(a, b)
                                        for a, b in zip(pk, pp)),
           "done_untouched": all(torch_equal(a, b)
                                 for a, b in zip(dk, case.st)),
           "best_rows": sk.best[[at.leaf, at.right]].tolist()}
    rec["ok"] = (pool_ok and pool_cpu and rec["plain_entry_identical"]
                 and rec["done_untouched"]
                 and (want_features is None
                      or all(v in want_features for v in feats)))
    print("parity apply_find " + json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise RuntimeError(f"apply_find disagrees with its plain version: "
                           f"{rec}")
    return rec


def tail_edge_cases(f: int, b: int = 256) -> list:
    """The adversarial tails at ``f`` x ``b`` (synthetic splits): equal
    keys in the last two blocks of the cluster (a strong feature, the
    last of the second-last block, copied into the first of the last:
    the smaller wins), and the winner in the last feature of the last
    block."""
    from lightgbm_tpu_torch.ops.apply_find import tail_geometry
    from lightgbm_tpu_torch.tools.profile_apply_find import synthetic_split
    geo = tail_geometry(f, b)
    j = (geo.blocks - 1) * geo.feats - 1
    return [tail_parity(synthetic_split(f, b, ties=(j,), strong=(j,),
                                        device="cuda"),
                        f"{f}x{b}_equal_keys_in_the_last_two_blocks",
                        want_features=(j,)),
            tail_parity(synthetic_split(f, b, strong=(f - 1,),
                                        device="cuda"),
                        f"{f}x{b}_winner_in_the_last_block",
                        want_features=(f - 1,))]


def median_tail_parity(ds, env: dict, params: dict, label: str) -> dict:
    """:func:`tail_parity` on the median-sized split of one tree trained
    on ``ds`` on the route ``env`` selects: the tree is trained twice,
    the first time for the splits' segment sizes, the second to take a
    copy of the tail's inputs at the split of the median size."""
    import torch

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import grow as grow_mod
    from lightgbm_tpu_torch.ops.apply_find import TreeState
    from lightgbm_tpu_torch.tools.profile_apply_find import TailCase
    real = grow_mod.apply_find_pool
    sizes, held = [], {}

    def hook(h_a, h_b, nleft, st, fc, fmask, hp, max_depth, at,
             child=None):
        if held.get("at") == len(sizes):
            held["case"] = TailCase(
                h_a.clone(), h_b.clone(), nleft.clone(),
                TreeState(*(a.clone() for a in st)), fc, fmask.clone(), hp,
                max_depth, at)
        sizes.append(at.cnt if not at.done else -1)
        return real(h_a, h_b, nleft, st, fc, fmask, hp, max_depth, at,
                    child)
    grow_mod.apply_find_pool = hook
    try:
        with route_env(env):
            lgt.train(params, ds, num_boost_round=1, device="cuda")
            live = sorted(c for c in sizes if c >= 0)
            median = live[len(live) // 2]
            held["at"] = sizes.index(median)
            sizes.clear()
            lgt.train(params, ds, num_boost_round=1, device="cuda")
    finally:
        grow_mod.apply_find_pool = real
    torch.cuda.synchronize()
    if "case" not in held:
        raise RuntimeError(f"no tail call to copy on the {label}")
    rec = tail_parity(held["case"], f"median split, {label}")
    rec["splits"] = len(live)
    return rec


def apply_find_times(gpu: str) -> dict:
    """Both tail entries timed at the main paths' shapes (28 x 256, the
    row-order route's 28 x 1024, the wide route's 136 x 256) on seeded
    1M-row splits, eager (20 calls) and as one replay of a CUDA graph of
    20 calls, each bitwise its plain version on CPU copies first
    (``tools/profile_apply_find.py``), beside the byte bound, in the
    unconstrained and then the monotone instantiation (keys
    ``<entry>_mono``); each shape's geometry and the clusters of it the
    card holds at once."""
    from lightgbm_tpu_torch.ops.apply_find import max_clusters, tail_geometry
    from lightgbm_tpu_torch.tools import profile_apply_find as pa
    out = {}
    for shape in pa.SHAPES.split(","):
        f, b = (int(v) for v in shape.split("x"))
        geo = tail_geometry(f, b)
        out[shape] = {"geometry": geo._asdict(),
                      "max_clusters": max_clusters(geo, f, b),
                      "max_clusters_mono": max_clusters(geo, f, b,
                                                        mono=True)}
        for r in pa.time_shape(f, b):
            key = r["entry"] + ("_mono" if r["mode"] == "mono" else "")
            out[shape][key] = {k: r[k] for k in
                               ("ms", "graph_ms", "bound_ms")}
        if min(out[shape]["max_clusters"],
               out[shape]["max_clusters_mono"]) < 1:
            raise RuntimeError(f"the card holds no cluster of the tail's "
                               f"geometry {geo} at {shape}")
    print("apply_find times [ms] " + json.dumps(out) + f" [{gpu}]",
          flush=True)
    return out


def compare_trees(models_a, models_b, rtol: float = LEAF_RTOL) -> dict:
    """Structure equal (num_leaves, split features, threshold bins,
    decision types, leaf counts) and leaf values within ``rtol``
    relative to the tree's largest leaf magnitude, tree by tree (a leaf
    near zero is a difference of nearly equal gradient sums, so its own
    magnitude is no scale for f32 noise)."""
    if len(models_a) != len(models_b):
        return {"ok": False, "reason": f"{len(models_a)} vs "
                                         f"{len(models_b)} trees"}
    worst = 0.0
    for i, (a, b) in enumerate(zip(models_a, models_b)):
        same = (a.num_leaves == b.num_leaves
                and np.array_equal(a.split_feature, b.split_feature)
                and np.array_equal(a.threshold_bin, b.threshold_bin)
                and np.array_equal(a.decision_type, b.decision_type)
                and np.array_equal(a.leaf_count, b.leaf_count))
        if not same:
            return {"ok": False, "reason": f"tree {i} structure differs"}
        rel = (np.abs(a.leaf_value - b.leaf_value)
               / max(float(np.abs(b.leaf_value).max()), 1e-30))
        worst = max(worst, float(rel.max()))
    return {"ok": worst <= rtol, "max_rel_leaf_err": worst,
            "trees": len(models_a)}


SLICE2_ROUTE = {"LGBM_TPU_STREAM": "0", "LGBM_TPU_FUSED": "0",
                "LGBM_TPU_APPLY_IMPL": "xla"}
SLICE2_ITERS = 3
SLICE2_PARITY_TREES = 1
ROUTE_KNOBS = ("LGBM_TPU_STREAM", "LGBM_TPU_FUSED", "LGBM_TPU_APPLY_IMPL",
               "LGBM_TPU_PHYS", "LGBM_TPU_HIST_IMPL", "LGBM_TPU_PART",
               "LGBM_TPU_POOL_TAIL", "LGBM_TPU_COMB_PACK",
               "LGBM_TPU_HIST_SCATTER")
# the port's kernels (PERF.md rows 1-16)
OUR_KERNEL_NAMES = ("hist_comb", "scan_tiles", "copyback_3ph", "copy_span",
                    "count_tiles", "fused_scatter", "fused_hist",
                    "reduce_partials", "stream_", "apply_find", "hist_rows",
                    "copy_records")
# the partitions' kernels (csrc/partition_scan.cuh, partition.cu,
# partition_3ph.cu): the scan, its state's memset (the profiler's
# "Memset (Device)") and each route's copyback
PARTITION_KERNELS = re.compile(
    r"scan_tiles|Memset|copyback_3ph|copy_span|copy_records")


@contextlib.contextmanager
def route_env(env: dict):
    """The JAX package's route knobs set as ``env`` says (and the others
    unset) inside the block, restored after it."""
    keys = ROUTE_KNOBS
    saved = {k: os.environ.get(k) for k in keys}
    for k in keys:
        os.environ.pop(k, None)
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def train_parity(gpu: str, env: dict, trees: int, label: str,
                 params: dict = TRAIN_PARAMS, bitwise: bool = False,
                 n_features: int = N_FEATURES, y=None,
                 rows: int = PARITY_ROWS) -> dict:
    """``rows`` (20,000) rows x ``n_features`` (28; NaN and zero missing
    values), 255 leaves, ``trees`` iterations on the route ``env``
    selects, trained on the card and with device="cpu"; whether the leaf
    values are bitwise equal too (a gate when ``bitwise``).  ``y``
    replaces the binary label."""
    import lightgbm_tpu_torch as lgt
    x = make_rows(rows, n_features, 3)
    if y is None:
        _, y = make_higgs_like(rows, n_features, 3)
    traces = []

    def _train(device):
        bst = lgt.Booster(params, lgt.Dataset(x, label=y), device=device)
        traces.append([])
        bst._inner.grow.trace = traces[-1]
        for _ in range(trees):
            bst.update()
        return bst
    with route_env(env):
        t0 = time.perf_counter()
        bst_c = _train("cuda")
        t1 = time.perf_counter()
        bst_p = _train("cpu")
        t2 = time.perf_counter()
    rec = compare_trees(bst_c._models, bst_p._models)
    diff = [i for i, (a, b) in enumerate(zip(*traces)) if a != b]
    if diff:
        i = diff[0]
        rec["first_split_diff"] = {"split": i, "cuda": traces[0][i],
                                   "cpu": traces[1][i]}
    rec.update(case=f"{label}: {rows}x{n_features}, {params['num_leaves']} "
               f"leaves, {trees} trees", cuda_s=t1 - t0, cpu_s=t2 - t1,
               route=bst_c._inner.grow.route.describe(),
               leaves_bitwise=leaves_bitwise(bst_c._models, bst_p._models),
               leaves=[t.num_leaves for t in bst_c._models])
    if bitwise:
        rec["ok"] = rec["ok"] and rec["leaves_bitwise"]
    print("parity training " + json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise RuntimeError(f"training on the card differs from the CPU "
                           f"run: {rec}")
    return rec


def leaves_bitwise(models_a, models_b) -> bool:
    return len(models_a) == len(models_b) and all(
        np.asarray(a.leaf_value, np.float64).tobytes()
        == np.asarray(b.leaf_value, np.float64).tobytes()
        for a, b in zip(models_a, models_b))


def _same_trees(bst_a, bst_b, label: str) -> dict:
    """Hold ``bst_b``'s trees against the first as many of ``bst_a``'s,
    bit for bit; raises if they differ."""
    k = len(bst_b._models)
    same = compare_trees(bst_a._models[:k], bst_b._models)
    same.update(case=f"{label}, {k} trees at "
                f"{bst_b._inner.train_set.num_data} rows",
                leaves_bitwise=leaves_bitwise(bst_a._models[:k],
                                              bst_b._models))
    print("parity routes " + json.dumps(same), flush=True)
    if not (same["ok"] and same["leaves_bitwise"]):
        raise RuntimeError(f"{label}: other trees: {same}")
    return same


def profile_tallies(prof) -> tuple:
    """``(by_name, by_stage)`` of a finished ``torch.profiler`` run, read
    from its raw events (building ``prof.events()``' tree takes seconds
    an iteration): every device event but the ranges' own annotations
    as ``{name: (count, us)}``, and the kernels each ``stage:<name>``
    range of an enabled ``StageTimer`` launched, by the host event each
    kernel is linked to (``linked_correlation_id``) starting inside the
    range.  The port's own kernels, launched through ctypes, are linked
    to no host op and count in no stage.  The kernels and their times
    are ``events()``' to the count; ``events()``' tree also put some 0.8
    kernels a split more in the grower's stages (one default-route
    iteration on an H100: 2,801 against 2,703 in ``split_tail``, 101
    against 0 in ``fused_split``)."""
    import bisect

    from torch.autograd import DeviceType
    stage = "stage:"

    def span(e):
        if hasattr(e, "start_ns"):
            return e.start_ns(), e.duration_ns()
        return e.start_us() * 1000, e.duration_us() * 1000
    by_name, ranges, ops, linked = {}, [], {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            t, d = span(e)
            if name.startswith(stage):
                ranges.append((t, t + d, name[len(stage):]))
            corr = e.linked_correlation_id()
            if corr > 0:
                ops.setdefault(corr, t)
        elif not name.startswith(stage):
            c, us = by_name.get(name, (0, 0.0))
            by_name[name] = (c + 1, us + span(e)[1] / 1e3)
            linked.append(e.linked_correlation_id())
    ranges.sort()
    starts = [r[0] for r in ranges]
    by_stage = {}
    for corr in linked:
        t = ops.get(corr) if corr > 0 else None
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= ranges[i][1]:
            by_stage[ranges[i][2]] = by_stage.get(ranges[i][2], 0) + 1
    return by_name, by_stage


def profile_iteration(bst, gpu: str) -> dict:
    """One more boosting iteration of ``bst`` under ``torch.profiler``:
    kernel launches, in all and per split by the grower's stage
    (:func:`profile_tallies`), and the device's busy share of the host
    wall time (the profiler's own overhead lengthens the wall time, so
    the busy share is a lower bound).  Returns {"measured": False, ...}
    when the profiler reports no device kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bst.update()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, by_stage = profile_tallies(prof)
    kernels = sum(c for c, _ in by_name.values())
    if not kernels:
        return {"measured": False, "gpu": gpu}
    busy_ms = sum(us for _, us in by_name.values()) / 1e3
    ours_ms = sum(us for k, (_, us) in by_name.items()
                  if any(o in k for o in OUR_KERNEL_NAMES)) / 1e3
    k = bst._inner.num_tree_per_iteration
    splits = max(sum(t.num_leaves - 1 for t in bst._models[-k:]), 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    # the fused split's kernels (csrc/fused_split.cu): ms an iteration
    fused = {}
    for k, (c, us) in by_name.items():
        m = re.search(r"(count_tiles|fused_\w+|reduce_partials)", k)
        if m:
            a = fused.setdefault(m.group(1), [0, 0.0])
            a[0] += c
            a[1] += us / 1e3
    # hist_comb's kernels (csrc/hist_comb.cu): ms an iteration; on the
    # physical routes without the fused split the only reduce_partials is
    # its own (the fused split's and hist_rows' elsewhere)
    hist = {}
    route = bst._inner.grow.route
    own_reduce = not route.fused and route.path != "row_order"
    for k, (c, us) in by_name.items():
        m = re.search(r"(hist_comb_\w+|reduce_partials)", k)
        if m and (own_reduce or m.group(1) != "reduce_partials"):
            a = hist.setdefault(m.group(1), [0, 0.0])
            a[0] += c
            a[1] += us / 1e3
    part = {}
    for k, (c, us) in by_name.items():
        m = PARTITION_KERNELS.search(k)
        if m:
            a = part.setdefault(m.group(), [0, 0.0])
            a[0] += c
            a[1] += us / 1e3
    return {"measured": True, "route": bst._inner.grow.route.describe(),
            "wall_ms": wall_ms, "busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms, "kernels": kernels,
            "splits": splits, "kernels_per_split": kernels / splits,
            "stage_kernels_per_split": {k: v / splits
                                        for k, v in by_stage.items()},
            "kernels_outside_stages_per_split":
                (kernels - sum(by_stage.values())) / splits,
            "our_kernels_ms": ours_ms,
            "other_kernels_ms_per_split": (busy_ms - ours_ms) / splits,
            "top": [[k[:60], c, us / 1e3] for k, (c, us) in top],
            "fused_split_kernels": fused,
            "fused_split_ms": sum(ms for _, ms in fused.values()),
            "apply_find_ms": sum(us for k, (_, us) in by_name.items()
                                 if "apply_find" in k) / 1e3,
            "hist_comb_kernels": hist,
            "hist_comb_ms": sum(ms for _, ms in hist.values()),
            "partition_kernels": part,
            "partition_ms": sum(ms for _, ms in part.values()),
            "partition_launches_per_split":
                sum(c for c, _ in part.values()) / splits,
            "gpu": gpu}


def _kernel_record(name, source, replaces, launches, err, ms, plain_ms,
                   n_bytes, n_ops, gpu, **extra) -> dict:
    bytes_ms = n_bytes / PEAK_BYTES_S * 1e3
    ops_ms = n_ops / PEAK_OPS_S * 1e3
    rec = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": int(launches),
           "max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": None, "parity": "ok", "gpu": gpu,
           "bound_bytes": int(n_bytes), "bound_ops": int(n_ops)}
    rec.update(extra)
    return rec


def flat_hist_inputs(bins, vals, padded_bins: int, rows=None):
    """The library yardstick's inputs, built outside any timed call: the
    flat (feature, bin) cell index [m * F] i64 of the rows (every row,
    or the i64 ``rows``) and their values repeated per feature
    [m * F, 2], so one ``index_add_`` computes the [F, B, 2] histogram."""
    import torch

    from lightgbm_tpu_torch.ops.device_data import bins_i32
    b = bins_i32(bins, rows)
    m, f = b.shape
    flat = (b.long() + torch.arange(f, device=b.device)
            * padded_bins).reshape(-1)
    v = vals[:, :2] if rows is None else vals[:, :2].index_select(0, rows)
    upd = v[:, None, :].expand(m, f, 2).reshape(-1, 2).contiguous()
    return flat, upd


def library_hist_ms(bins, vals, padded_bins: int, rows=None,
                    reps: int = 5) -> float:
    """Time of one ``Tensor.index_add_`` over a precomputed flat cell
    index: the PyTorch call that computes the same [F, B, 2] histogram
    (the index build is excluded)."""
    import torch
    flat, upd = flat_hist_inputs(bins, vals, padded_bins, rows)
    out = torch.zeros((bins.shape[1] * padded_bins, 2), dtype=torch.float32,
                      device=bins.device)
    return _time_ms(lambda: out.index_add_(0, flat, upd), reps)


def library_copy_ms(dst, src, s0: int, cnt: int, reps: int = 20) -> float:
    """Time of the ``Tensor.copy_`` calls that compute a copyback: rows
    ``[s0, s0 + cnt)`` of each array of ``src`` into ``dst`` (the five
    arrays of a pack=1 ``Rows``, or the one record buffer of a
    ``PackedRows``), one call per array."""
    pairs = [(d.narrow(0, s0, cnt), s.narrow(0, s0, cnt))
             for d, s in zip(dst, src) if hasattr(d, "narrow")]

    def run():
        for d, s in pairs:
            d.copy_(s)
    return _time_ms(run, reps)


def training_kernels(gpu: str, ds) -> list:
    """Slices 2 and 3: every training kernel against its plain version
    at the main path's shapes (the training matrix's real bins, seeded
    values), then each one's time on the card beside its plain
    version's.  Returns the records, launches still 0."""
    import torch

    from lightgbm_tpu_torch.ops.apply_find import (apply_find,
                                                   apply_find_pool,
                                                   apply_find_pool_ref,
                                                   apply_find_ref)
    from lightgbm_tpu_torch.ops.device_data import (Rows, init_rows,
                                                    to_device)
    from lightgbm_tpu_torch.ops.fused_split import (fused_split,
                                                    fused_split_ref)
    from lightgbm_tpu_torch.ops.grow import SerialGrower, StreamSpec
    from lightgbm_tpu_torch.ops.hist_kernel2 import (
        build_histogram_comb, build_histogram_comb_ref)
    from lightgbm_tpu_torch.ops.partition_kernel import (
        copyback, copyback_ref, partition_3ph, partition_3ph_ref,
        partition_scan, partition_scan_ref)
    from lightgbm_tpu_torch.ops.routing import RouteInputs, decide
    from lightgbm_tpu_torch.ops.split import SplitHyperParams
    from lightgbm_tpu_torch.ops.stream_grad import (stream_init,
                                                    stream_init_ref,
                                                    stream_refresh,
                                                    stream_refresh_plain,
                                                    stream_refresh_plain_ref,
                                                    stream_refresh_ref)

    dev = torch.device("cuda")
    bins = torch.as_tensor(ds._binned.bin_matrix, device=dev)
    n, f = bins.shape
    b_pad = 256
    rows = init_rows(bins)
    vals = random_row_matrix(n, 1, 7)[1]
    rows.vals.copy_(torch.as_tensor(vals, device=dev))
    hist_recs = [hist_parity(rows, (0, 0, n), b_pad, "root"),
                 hist_parity(rows, (333_331, 5, 250_000), b_pad,
                             "child_unaligned")]
    # a numerical split with a NaN bin routed left: feature 0's bins
    # with 5% of rows moved to bin 255, the NaN bin
    parts = random_row_matrix(n, f, 11, nan_bin=255)
    prows = rows_on((np.ascontiguousarray(
        np.concatenate([parts[0][:, :1], ds._binned.bin_matrix[:, 1:]], 1)),
        *parts[1:]), dev)
    sel = (0, n, 0, 120, 1, 0, 255)
    small_sel = (100_001, 3000, 0, 60, 1, 0, 255)
    part_recs = [partition_parity(prows, sel, "1M_nan_default_left"),
                 partition_parity(prows, small_sel, "3000_at_odd_offset")]
    stream_recs = [stream_parity(bins, "binary", b_pad, "1M_binary"),
                   stream_parity(bins, "l2", b_pad, "1M_l2")]
    fused_recs = [fused_parity(prows, sel, b_pad, "1M_nan_default_left"),
                  fused_parity(prows, small_sel, b_pad,
                               "3000_at_odd_offset")]
    # slice 5: the 3-phase partition (a bitset descriptor of 8 words on
    # feature 1's real bins, word 3 with bit 31 set) and the plain refresh
    words = [int(w) for w in np.random.default_rng(19).integers(
        -2 ** 31, 2 ** 31, 8)]
    words[3] |= -2 ** 31
    p3_recs = [partition_3ph_parity(prows, sel, "1M_nan_default_left"),
               partition_3ph_parity(prows, small_sel, "3000_at_odd_offset"),
               partition_3ph_parity(prows, (250_007, 400_000, 1, 0, 0, 1, -1,
                                            0, *words),
                                    "400000_bitset_8_words_mid_matrix"),
               partition_3ph_parity(prows, (500_000, 0, 2, 10, 0, 0, -1),
                                    "dead_split")]
    rp_recs = [refresh_plain_parity(bins, "binary", b_pad, "1M_binary"),
               refresh_plain_parity(bins, "l2", b_pad, "1M_l2")]
    shapes = stream_shape_parities()
    dd = to_device(ds._binned, dev)
    grower = SerialGrower(SplitHyperParams(), num_leaves=TRAIN_LEAVES,
                          max_depth=-1, dd=dd, route=decide(RouteInputs()),
                          stream=StreamSpec("binary", 1.0))
    af_rows = init_rows(dd.bins)
    af_rows.vals.copy_(torch.as_tensor(vals, device=dev))
    af_recs = [apply_find_parity(grower, af_rows, "1M_root_split")]
    af_recs += tail_edge_cases(N_FEATURES) + tail_edge_cases(WIDE_FEATURES)

    # times at the main path's shapes (root range, whole-matrix segment,
    # the root split's tail), L2 warm as in training's back-to-back splits
    root = torch.tensor([0, 0, n], dtype=torch.int32, device=dev)
    scratch = Rows(*(torch.empty_like(a) for a in prows))
    nl = torch.zeros(1, dtype=torch.int32, device=dev)
    score, valid, consts = stream_aux(n, "binary", 5, dev)
    s_kw = dict(kind="binary", sigmoid=1.0)
    srows = stream_init(bins, score, valid, consts, **s_kw)
    lv = torch.zeros(n, dtype=torch.float32, device=dev)
    st, pair, nleft, fmask, at = split_state(grower, af_rows)
    af_args = (nleft, st, grower.finder, fmask, grower.hp, -1, at)
    t = {}
    t["hist_comb"] = (
        _time_ms(lambda: build_histogram_comb(
            rows, root, padded_bins=b_pad, max_rows=n), 20),
        _time_ms(lambda: build_histogram_comb_ref(
            rows, root, padded_bins=b_pad, max_rows=n), 3))
    hist_comb_library_ms = library_hist_ms(rows.bins, rows.vals, b_pad)
    t["partition_scan"] = (
        _time_ms(lambda: partition_scan(prows, scratch, sel, nl), 20),
        _time_ms(lambda: partition_scan_ref(prows, scratch, sel, nl), 3))
    t["copyback"] = (
        _time_ms(lambda: copyback(prows, scratch, 0, n), 20),
        _time_ms(lambda: copyback_ref(prows, scratch, 0, n), 3))
    copyback_library_ms = library_copy_ms(prows, scratch, 0, n)
    t["stream_init"] = (
        _time_ms(lambda: stream_init(bins, score, valid, consts, **s_kw), 20),
        _time_ms(lambda: stream_init_ref(bins, score, valid, consts, **s_kw),
                 3))
    t["stream_refresh"] = (
        _time_ms(lambda: stream_refresh(srows, lv, padded_bins=b_pad,
                                        **s_kw), 20),
        _time_ms(lambda: stream_refresh_ref(srows, lv, padded_bins=b_pad,
                                            **s_kw), 3))
    t["fused_split"] = (
        _time_ms(lambda: fused_split(prows, scratch, sel, nl,
                                     padded_bins=b_pad), 20),
        _time_ms(lambda: fused_split_ref(prows, scratch, sel, nl,
                                         padded_bins=b_pad), 3))
    t["apply_find"] = (
        _time_ms(lambda: apply_find_pool(pair[0], pair[1], *af_args), 50),
        _time_ms(lambda: apply_find_pool_ref(pair[0], pair[1], *af_args),
                 5))
    h2 = torch.stack([st.pool[at.leaf], st.pool[at.right]]).contiguous()
    t["apply_find_plain_entry"] = (
        _time_ms(lambda: apply_find(h2, *af_args), 50),
        _time_ms(lambda: apply_find_ref(h2, *af_args), 5))
    t["partition_3ph"] = (
        _time_ms(lambda: partition_3ph(prows, scratch, sel, nl), 20),
        _time_ms(lambda: partition_3ph_ref(prows, scratch, sel, nl), 3))
    t["stream_refresh_plain"] = (
        _time_ms(lambda: stream_refresh_plain(srows, lv, **s_kw), 20),
        _time_ms(lambda: stream_refresh_plain_ref(srows, lv, **s_kw), 3))
    print("kernel times [ms, plain ms] at the main path's shapes "
          + json.dumps(t) + f" [{gpu}]", flush=True)
    del prows, scratch, rows, srows, af_rows

    row_bytes = f + ROW_EXTRA_BYTES
    hist_out = f * b_pad * 2 * 4
    hist_bytes = n * (f + 8) + hist_out
    cells = 2 * 2 * f * b_pad
    recs = [
        _kernel_record(
            "hist_comb", "lightgbm_tpu_torch/csrc/hist_comb.cu",
            "lightgbm_tpu/ops/pallas/hist_kernel2.py:225", 0,
            max(r["max_abs_err"] for r in hist_recs), *t["hist_comb"],
            hist_bytes, 2 * n * f, gpu,
            bitwise_repeat=all(r["bitwise_repeat"] for r in hist_recs),
            library_ms=hist_comb_library_ms,
            library_call="index_add_ over a precomputed flat (feature, "
                         "bin) index, index build excluded"),
        _kernel_record(
            "partition_scan", "lightgbm_tpu_torch/csrc/partition.cu",
            "lightgbm_tpu/ops/pallas/partition_kernel2.py:377", 0, 0.0,
            *t["partition_scan"], 2 * n * row_bytes + 4, 0, gpu),
        _kernel_record(
            "copyback", "lightgbm_tpu_torch/csrc/partition.cu",
            "lightgbm_tpu/ops/pallas/partition_kernel2.py:325", 0, 0.0,
            *t["copyback"], 2 * n * row_bytes, 0, gpu,
            library_ms=copyback_library_ms,
            library_call="five Tensor.copy_ of the segment's rows, one "
                         "per array"),
        # reads bins, score, validity, two constants; writes every column;
        # ~16 f32 operations a row (the f64 exp counted as one)
        _kernel_record(
            "stream_init", "lightgbm_tpu_torch/csrc/stream_grad.cu",
            "lightgbm_tpu/ops/pallas/stream_grad.py:784", 0, 0.0,
            *t["stream_init"], n * (f + 16) + n * row_bytes, 16 * n, gpu,
            parity_cases=[r["case"] for r in stream_recs],
            shape_cases=shapes["cases"], shapes_bitwise=shapes["bitwise"]),
        # reads bins, score, w, two constants, lv; writes score, g*w, h*w
        # and the histogram; ~17 operations a row plus 2 * F histogram adds
        _kernel_record(
            "stream_refresh", "lightgbm_tpu_torch/csrc/stream_grad.cu",
            "lightgbm_tpu/ops/pallas/stream_grad.py:515", 0,
            max(r["root_hist_vs_plain_max_abs_err"] for r in stream_recs),
            *t["stream_refresh"], n * (f + 20) + 12 * n + hist_out,
            n * (17 + 2 * f), gpu, root_hist_bitwise_hist_comb=all(
                r["root_hist_bitwise_hist_comb"] for r in stream_recs)),
        # reads and writes every row of the segment once, writes both
        # histograms; 2 * F histogram adds a row
        _kernel_record(
            "fused_split", "lightgbm_tpu_torch/csrc/fused_split.cu",
            "lightgbm_tpu/ops/pallas/fused_split.py:346", 0,
            max(r["max_abs_err"] for r in fused_recs), *t["fused_split"],
            2 * n * row_bytes + 2 * hist_out, 2 * n * f, gpu,
            hist_bitwise_hist_comb=all(r["hist_bitwise_hist_comb"]
                                       for r in fused_recs)),
        # reads the parent's pool row and the smaller child's histogram,
        # writes two pool rows; ~40 operations per candidate of the
        # 2 children x 2 directions x F x B
        _kernel_record(
            "apply_find", "lightgbm_tpu_torch/csrc/apply_find.cu",
            "lightgbm_tpu/ops/pallas/apply_find.py:571", 0, 0.0,
            *t["apply_find"], 4 * hist_out, 40 * cells, gpu,
            also_replaces="lightgbm_tpu/ops/pallas/apply_find.py:529 "
                          "(plain-pool entry apply_find, same body)",
            plain_entry_ms=t["apply_find_plain_entry"][0],
            plain_entry_plain_ms=t["apply_find_plain_entry"][1],
            parity_cases=[r["case"] for r in af_recs],
            # reads both children's histograms; no pool row moves
            plain_entry_bound_ms=max(2 * hist_out / PEAK_BYTES_S,
                                     40 * cells / PEAK_OPS_S) * 1e3),
        # an in-place stable partition reads each row of the segment once
        # (its split column included) and writes it once, plus nleft; the
        # trip through scratch and back is this design's cost, not the
        # function's
        _kernel_record(
            "partition_3ph", "lightgbm_tpu_torch/csrc/partition_3ph.cu",
            "lightgbm_tpu/ops/pallas/partition_kernel.py:329", 0, 0.0,
            *t["partition_3ph"], 2 * n * row_bytes + 4, 0, gpu,
            parity_cases=[r["case"] for r in p3_recs],
            cpu_plain_identical=all(r["cpu_plain_identical"]
                                    for r in p3_recs)),
        # reads score, w, two constants and lv; writes score, g*w, h*w;
        # ~17 operations a row (the f64 exp counted as one)
        _kernel_record(
            "stream_refresh_plain", "lightgbm_tpu_torch/csrc/stream_grad.cu",
            "lightgbm_tpu/ops/pallas/stream_grad.py:557", 0, 0.0,
            *t["stream_refresh_plain"], 20 * n + 12 * n, 17 * n, gpu,
            fused_refresh_rows_identical=all(
                r["fused_refresh_rows_identical"] for r in rp_recs),
            cpu_plain_identical=all(r["cpu_plain_identical"]
                                    for r in rp_recs),
            shape_cases=shapes["cases"], shapes_bitwise=shapes["bitwise"]),
    ]
    return recs


# ---------------------------------------------------------------------
# Slice 4: the row-order route (u16 bins, hist_rows)
WIDE_PARAMS = dict(TRAIN_PARAMS, max_bin=1023)
# holdout AUC of the 10-iteration main paths at each max_bin: the trees
# every route has grown since slice 3 (default and pack=2) and slice 4
# (row-order), bit for bit
MAIN_PATH_AUC = {255: 0.774389521391751, 1023: 0.7743261350960159}
ROW_ORDER_ITERS = 10
ROW_ORDER_PARITY_TREES = 1
PHYS_OFF = {"LGBM_TPU_PHYS": "0"}
PHYS_OFF_ITERS = 3
CHILD_ROWS = 3000


def hist_rows_case(bins, vals, rng: tuple, index, padded_bins: int,
                   max_rows: int, label: str, gpu: str = "",
                   timed: bool = True) -> dict:
    """hist_rows against its plain version on the same inputs: bitwise
    against the plain version run on CPU copies of them (sequential
    ``index_add_``, the kernel's order of additions), within
    4 * n * eps_f32 * max|v| of the plain version on the card (CUDA's
    ``index_add_`` adds in another order), two launches bitwise.  With
    ``timed``, the times of the kernel, the plain version on the card and
    one ``index_add_`` over a precomputed flat index, and the bound."""
    import torch

    from lightgbm_tpu_torch.ops.hist_kernel2 import (
        _window, build_histogram_rows, build_histogram_rows_ref)
    dev = bins.device
    rng_t = torch.tensor(rng, dtype=torch.int32, device=dev)
    kw = dict(index=index, padded_bins=padded_bins, max_rows=max_rows)
    launches = build_histogram_rows.launches
    k1 = build_histogram_rows(bins, vals, rng_t, **kw)
    k2 = build_histogram_rows(bins, vals, rng_t, **kw)
    ref = build_histogram_rows_ref(bins, vals, rng_t, **kw)
    cpu_kw = dict(kw, index=None if index is None else index.cpu())
    ref_cpu = build_histogram_rows_ref(bins.cpu(), vals.cpu(), rng_t.cpu(),
                                       **cpu_kw)
    torch.cuda.synchronize()
    n_pos = bins.shape[0] if index is None else index.shape[0]
    lo, hi = _window((rng[0], 0, rng[1]), n_pos)
    pos = torch.arange(lo, hi, device=dev)
    rows = pos if index is None else index[lo:hi].long()
    vmax = float(vals[rows].abs().max()) if hi > lo else 0.0
    rec = {"case": label, "range": list(rng), "indexed": index is not None,
           "bins": str(bins.dtype).replace("torch.", ""),
           "shape": list(bins.shape), "padded_bins": padded_bins,
           "bitwise_cpu_plain": torch_equal(k1.cpu(), ref_cpu),
           "bitwise_repeat": torch_equal(k1, k2),
           "max_abs_err": float((k1 - ref).abs().max()),
           "tol": 4.0 * (hi - lo) * EPS32 * vmax,
           "launched": build_histogram_rows.launches - launches}
    rec["ok"] = (rec["bitwise_cpu_plain"] and rec["bitwise_repeat"]
                 and rec["max_abs_err"] <= rec["tol"]
                 and rec["launched"] == 2)
    if timed:
        m, f = hi - lo, bins.shape[1]
        rec["ms"] = _time_ms(lambda: build_histogram_rows(
            bins, vals, rng_t, **kw), 20)
        rec["plain_ms"] = _time_ms(lambda: build_histogram_rows_ref(
            bins, vals, rng_t, **kw), 3)
        rec["library_ms"] = library_hist_ms(
            bins, vals, padded_bins, None if index is None else rows)
        # each selected row's bins and values read once, its index entry
        # once, the histogram written once; 2 adds per (row, feature)
        rec["bound_bytes"] = (m * (f * bins.element_size() + 8)
                              + (4 * m if index is not None else 0)
                              + f * padded_bins * 8)
        rec["bound_ops"] = 2 * m * f
        rec["bound_ms"] = max(rec["bound_bytes"] / PEAK_BYTES_S,
                              rec["bound_ops"] / PEAK_OPS_S) * 1e3
        rec["gpu"] = gpu
    print("parity hist_rows " + json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise RuntimeError(f"hist_rows disagrees with its plain version: "
                           f"{rec}")
    return rec


def hist_rows_kernels(gpu: str, ds, ds_wide) -> dict:
    """Slice 4: hist_rows against its plain version at the row-order
    main path's shapes (the 1M x 28 u16 bins of max_bin=1023, B = 1024:
    the root without an index, a 3,000-position child at an odd offset
    through a seeded permutation), u8 bins of max_bin=255 (B = 256)
    through an index, and u16 bins at B = 1040; each case timed.
    Returns the kernel's record, launches still 0."""
    import torch
    dev = torch.device("cuda")
    wide = torch.as_tensor(ds_wide._binned.bin_matrix, device=dev)
    narrow = torch.as_tensor(ds._binned.bin_matrix, device=dev)
    n, f = wide.shape
    b_wide = 1024
    rng_np = np.random.default_rng(17)
    vals = torch.tensor(rng_np.normal(size=(n, 2)).astype(np.float32),
                        device=dev)
    perm = torch.tensor(rng_np.permutation(n).astype(np.int32), device=dev)
    b1040 = torch.tensor(rng_np.integers(0, 1040, size=(250_000, f))
                         .astype(np.uint16), device=dev)
    cases = [
        hist_rows_case(wide, vals, (0, n), None, b_wide, n,
                       "1M_u16_B1024_root", gpu),
        hist_rows_case(wide, vals, (100_001, CHILD_ROWS), perm, b_wide,
                       CHILD_ROWS, "3000_u16_B1024_indexed_odd_offset", gpu),
        hist_rows_case(narrow, vals, (333_331, 250_000), perm, 256,
                       250_000, "250000_u8_B256_indexed", gpu),
        hist_rows_case(b1040, vals[:250_000], (0, 250_000), None, 1040,
                       250_000, "250000_u16_B1040", gpu),
    ]
    root, child = cases[0], cases[1]
    rec = _kernel_record(
        "hist_rows", "lightgbm_tpu_torch/csrc/hist_rows.cu",
        "lightgbm_tpu/ops/pallas/hist_kernel2.py:339", 0,
        max(c["max_abs_err"] for c in cases), root["ms"], root["plain_ms"],
        root["bound_bytes"], root["bound_ops"], gpu,
        library_ms=root["library_ms"],
        library_call="index_add_ over a precomputed flat (feature, bin) "
                     "index, index build excluded",
        also_replaces="lightgbm_tpu/ops/pallas/hist_kernel.py:122 "
                      "(build_histogram_pallas, the same function)",
        bitwise_cpu_plain=all(c["bitwise_cpu_plain"] for c in cases),
        child_ms=child["ms"], child_plain_ms=child["plain_ms"],
        child_bound_ms=child["bound_ms"],
        child_library_ms=child["library_ms"],
        cases=[{k: c[k] for k in ("case", "ms", "plain_ms", "library_ms",
                                  "bound_ms", "max_abs_err")}
               for c in cases])
    print("kernel hist_rows " + json.dumps(rec), flush=True)
    return rec


# calls one CUDA graph of a timing holds, timed as one replay (slice 11)
GRAPH_CALLS = 20


def split_sizes(models) -> np.ndarray:
    """[splits, 2] i64 (the split leaf's rows, its smaller child's rows)
    of every split of ``models``, read from the trees' internal and leaf
    counts."""
    out = []
    for t in models:
        for node in range(len(t.internal_count)):
            kids = [int(t.internal_count[c]) if c >= 0
                    else int(t.leaf_count[~c])
                    for c in (t.left_child[node], t.right_child[node])]
            out.append((int(t.internal_count[node]), min(kids)))
    return np.asarray(out, dtype=np.int64).reshape(-1, 2)


def eager_and_graph_ms(fn) -> tuple:
    """(eager, graph) milliseconds of one call of ``fn``: ``_time_ms``
    over 20 calls back to back (the host's cost of each call included
    where the card waits for it), and one replay of a CUDA graph of
    ``GRAPH_CALLS`` calls (median of 5) over ``GRAPH_CALLS``: the card's
    time alone."""
    from lightgbm_tpu_torch.tools.profile_lib import graph_ms

    def many():
        for _ in range(GRAPH_CALLS):
            fn()
    eager = _time_ms(fn, 20)
    graph, g = graph_ms(many, reps=5, warmup=1)
    del g
    return eager, graph / GRAPH_CALLS


L2_FLUSH_BYTES = 128 << 20      # over twice the H100's 50 MB L2


def cold_ms(fn, reps: int = 20, flush_by: str = "write") -> float:
    """Median milliseconds of one call of ``fn`` with the L2 cache
    flushed before it (a 128 MB buffer between calls, outside the timed
    span): the time from device memory, where a replayed graph of calls
    can find a working set under 50 MB still in L2.  ``flush_by``
    ``"write"`` zeroes the buffer, so the call also pays the write-back
    of the L2's dirty lines it evicts, as a training's call does after
    a kernel that wrote; ``"read"`` sums it, so the call finds a clean
    L2 and pays for its own bytes alone."""
    import torch
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    flush.zero_()
    fn()
    times = []
    for _ in range(reps):
        if flush_by == "write":
            flush.zero_()
        else:
            flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    del flush
    return float(np.median(times))


def mangled_base_name(name: str) -> str:
    """A kernel's name up to its template arguments from its mangled
    symbol (``_ZN<len><name>...I...``: the last name of the nested
    name), the symbol itself where it is not mangled."""
    m = re.match(r"_ZN?", name)
    if not m:
        return name
    at, last = m.end(), name
    while at < len(name) and name[at].isdigit():
        n = re.match(r"\d+", name[at:]).group()
        at += len(n)
        last = name[at:at + int(n)]
        at += int(n)
    return last


def kernels_of_call(fn) -> list:
    """[[kernel, blocks], ...] of the device kernels one call of ``fn``
    launches, in launch order: the call (after one warm-up call) is
    captured into a CUDA graph, whose kernel nodes the driver API lists
    (a stream's capture is a chain, listed in the order its nodes were
    made), each with its kernel's name up to its template arguments and
    its grid's block count; a memset node as ``["memset", bytes]``."""
    import ctypes

    import torch
    cu = ctypes.CDLL("libcuda.so.1")
    vp = ctypes.c_void_p

    def check(rc):
        if rc != 0:
            raise RuntimeError(f"CUDA driver call failed with error {rc}")
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    graph = vp(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)))
    nodes = (vp * max(n.value, 1))()
    if n.value:
        check(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)))
    out = []
    for node in list(nodes)[:n.value]:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(vp(node), ctypes.byref(kind)))
        if kind.value == 2:          # CU_GRAPH_NODE_TYPE_MEMSET
            # CUDA_MEMSET_NODE_PARAMS: elementSize at 20, width at 24,
            # height at 32
            params = (ctypes.c_uint8 * 64)()
            check(cu.cuGraphMemsetNodeGetParams(vp(node), params))
            size = [ctypes.c_uint32.from_buffer(params, 20).value,
                    ctypes.c_uint64.from_buffer(params, 24).value,
                    ctypes.c_uint64.from_buffer(params, 32).value]
            out.append(["memset", int(np.prod(size))])
            continue
        if kind.value != 0:          # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        # CUDA_KERNEL_NODE_PARAMS_v2: func at 0, gridDim at 8, 12, 16,
        # kern (CUkernel) at 56
        params = (ctypes.c_uint8 * 128)()
        check(cu.cuGraphKernelNodeGetParams_v2(vp(node), params))
        func = vp.from_buffer(params, 0).value
        grid = [ctypes.c_uint32.from_buffer(params, 8 + 4 * k).value
                for k in range(3)]
        name = ctypes.c_char_p()
        if func:
            check(cu.cuFuncGetName(ctypes.byref(name), vp(func)))
        else:
            check(cu.cuKernelGetName(ctypes.byref(name),
                                     vp(vp.from_buffer(params, 56).value)))
        out.append([mangled_base_name(name.value.decode()),
                    int(np.prod(grid))])
    del g
    torch.cuda.synchronize()
    return out


def hist_rows_times(gpu: str, ds_wide, models) -> dict:
    """Slice 11: hist_rows on the row-order main path's 1M x 28 u16 bins
    (B = 1024) at the root, at the 3,000-row child, and at the
    quartiles and the maximum of the smaller children of the trained
    trees ``models`` (each through a seeded permutation from an odd
    offset, with the grower's bound max_rows = parent // 2 + 1), eager
    and in a graph, beside one ``index_add_`` over a precomputed flat
    index both ways, the plain version on the card and the bound.  Each
    case's output is held bitwise against the plain version on CPU
    copies first, and the kernels one call launches (and their blocks)
    are read from a profiler trace: one launch at up to two slices."""
    import torch

    from lightgbm_tpu_torch.ops.hist_kernel2 import (
        build_histogram_rows, build_histogram_rows_ref, rows_blocks)
    dev = torch.device("cuda")
    bins = torch.as_tensor(ds_wide._binned.bin_matrix, device=dev)
    n, f = bins.shape
    b = 1024
    g = np.random.default_rng(17)
    vals = torch.tensor(g.normal(size=(n, 2)).astype(np.float32), device=dev)
    perm = torch.tensor(g.permutation(n).astype(np.int32), device=dev)
    sizes = split_sizes(models)
    order = np.argsort(sizes[:, 1], kind="stable")
    at = {q: sizes[order[int(round(q * (len(order) - 1)))]]
          for q in (0.25, 0.5, 0.75, 1.0)}
    child = {"splits": int(len(sizes)),
             **{name: int(at[q][1]) for name, q in (
                 ("q25", 0.25), ("median", 0.5), ("q75", 0.75),
                 ("max", 1.0))}}
    print("row-order smaller children " + json.dumps(child), flush=True)
    cases = [("root", 0, n, None, n),
             (f"child_{CHILD_ROWS}", 100_001, CHILD_ROWS, perm,
              CHILD_ROWS)]
    cases += [(f"child_{name}", 100_001, int(at[q][1]), perm,
               int(at[q][0]) // 2 + 1)
              for name, q in (("q25", 0.25), ("median", 0.5),
                              ("q75", 0.75), ("max", 1.0))]
    out = []
    for label, start, count, index, max_rows in cases:
        rng_t = torch.tensor([start, count], dtype=torch.int32, device=dev)
        kw = dict(index=index, padded_bins=b, max_rows=max_rows)
        k1 = build_histogram_rows(bins, vals, rng_t, **kw)
        ref = build_histogram_rows_ref(
            bins.cpu(), vals.cpu(), rng_t.cpu(),
            **dict(kw, index=None if index is None else index.cpu()))
        if not torch_equal(k1.cpu(), ref):
            raise RuntimeError(f"hist_rows {label} differs from its plain "
                               f"version")
        rows = None if index is None else index[start:start + count].long()
        flat, upd = flat_hist_inputs(bins, vals, b, rows)
        acc = torch.zeros((f * b, 2), dtype=torch.float32, device=dev)
        ms, graph_ms_ = eager_and_graph_ms(
            lambda: build_histogram_rows(bins, vals, rng_t, **kw))
        lib, lib_graph = eager_and_graph_ms(
            lambda: acc.index_add_(0, flat, upd))
        nb = (count * (f * 2 + 8) + (4 * count if index is not None else 0)
              + f * b * 8)
        # one launch wherever max_rows gives at most two slices, else the
        # partials and the reduction: read from the profiler's trace
        kernels = kernels_of_call(
            lambda: build_histogram_rows(bins, vals, rng_t, **kw))
        want = (["hist_rows_direct"] if rows_blocks(max_rows, b) <= 2
                else ["hist_rows_partial", "reduce_partials"])
        if [k for k, _ in kernels] != want:
            raise RuntimeError(f"hist_rows {label} launched {kernels}, "
                               f"not {want}")
        out.append({
            "case": label, "rows": count, "max_rows": max_rows,
            "slices": rows_blocks(max_rows, b),
            "kernels_a_call": kernels,
            "ms": ms, "graph_ms": graph_ms_,
            "library_ms": lib, "library_graph_ms": lib_graph,
            "plain_ms": _time_ms(lambda: build_histogram_rows_ref(
                bins, vals, rng_t, **kw), 3),
            "bound_ms": max(nb / PEAK_BYTES_S,
                            2 * count * f / PEAK_OPS_S) * 1e3,
            "bitwise_cpu_plain": True})
        del flat, upd, acc
    rec = {"child_sizes": child, "times": out, "gpu": gpu}
    print("hist_rows times [ms] " + json.dumps(rec), flush=True)
    return rec


def copyback_p2_times(gpu: str, models) -> dict:
    """Slice 11: copyback_p2 (16-byte words, four in flight a thread) on
    1M seeded 64-byte records, at the whole buffer and at the median and
    largest segment of the pack=2 route's splits (``models``' split
    leaves), eager and in a graph, beside one ``Tensor.copy_`` of the
    same bytes, taken in turns (kernel, copy_, copy_, kernel); the
    kernel's output held bitwise against ``copy_``'s first, the records
    around the segment untouched."""
    import torch

    from lightgbm_tpu_torch.ops.device_data import PackedRows, pack_rows
    from lightgbm_tpu_torch.ops.partition_kernel import copyback_p2
    dev = torch.device("cuda")
    rows = pack_rows(rows_on(random_row_matrix(TRAIN_ROWS, N_FEATURES, 11,
                                               nan_bin=254), dev))
    scratch = PackedRows(torch.randint(0, 256, rows.buf.shape,
                                       dtype=torch.uint8, device=dev),
                         rows.layout)
    stride = rows.layout.stride
    segs = np.sort(split_sizes(models)[:, 0])
    cases = [("whole", 0, TRAIN_ROWS),
             ("median_segment", 1, int(segs[len(segs) // 2])),
             ("largest_segment", 0, int(segs[-1]))]
    out = []
    for label, s0, cnt in cases:
        d, src = rows.buf[s0:s0 + cnt], scratch.buf[s0:s0 + cnt]
        fns = {"kernel": lambda: copyback_p2(rows, scratch, s0, cnt),
               "copy_": lambda: d.copy_(src)}
        rows.buf.zero_()
        fns["kernel"]()
        torch.cuda.synchronize()
        if not (torch.equal(d, src) and not rows.buf[:s0].any()
                and not rows.buf[s0 + cnt:].any()):
            raise RuntimeError(f"copyback_p2 {label} differs from "
                               f"Tensor.copy_")
        t = {k: [] for k in fns}
        for name in ("kernel", "copy_", "copy_", "kernel"):
            t[name].append(eager_and_graph_ms(fns[name]))
        rec = {"case": label, "s0": s0, "records": cnt, "stride": stride}
        for name, key in (("kernel", ""), ("copy_", "library_")):
            rec[f"{key}ms"] = float(np.mean([e for e, _ in t[name]]))
            rec[f"{key}graph_ms"] = float(np.mean([g_ for _, g_ in t[name]]))
        rec["bound_ms"] = 2 * cnt * stride / PEAK_BYTES_S * 1e3
        out.append(rec)
    res = {"times": out, "gpu": gpu}
    print("copyback_p2 times [ms] " + json.dumps(res), flush=True)
    del rows, scratch
    return res


def segment_sizes(models) -> dict:
    """The split segments of the trees ``models`` (each split leaf's
    rows, from the trees' internal counts): the count, the quartiles
    over every split and the largest segment below a tree's root."""
    every, below_root = [], []
    for t in models:
        counts = [int(c) for c in t.internal_count]
        every += counts
        below_root += counts[1:]
    every = np.sort(np.asarray(every, dtype=np.int64))
    at = {q: int(every[int(round(q * (len(every) - 1)))])
          for q in (0.25, 0.5, 0.75)}
    return {"splits": int(len(every)), "q25": at[0.25], "median": at[0.5],
            "q75": at[0.75], "max_child": int(max(below_root))}


def fused_split_times(gpu: str, models) -> dict:
    """Slice 12: fused_split and fused_split_p2 on 1M seeded rows
    (``tools/profile_fused.make_rows``) at the 1M-row root and at the
    quartiles and the largest child of the default route's split
    segments (``models``' trees), eager (20 calls) and as one replay of
    a graph of 20 calls, beside the plain version on the card and the
    bound.  Each case's histograms, scratch rows and nleft are held
    bitwise against the plain version on CPU copies first, and the
    kernels one call launches (and their blocks) are read from a
    profiler trace: count_tiles, fused_scatter, fused_hist, and
    reduce_partials where the split has more than one slice."""
    import torch

    from lightgbm_tpu_torch.ops.device_data import Rows, pack_rows
    from lightgbm_tpu_torch.ops.fused_split import (fused_split,
                                                    fused_split_p2)
    from lightgbm_tpu_torch.ops.hist_kernel2 import hist_blocks
    from lightgbm_tpu_torch.tools.profile_fused import (make_rows,
                                                        segment_sel,
                                                        time_segment)
    dev = torch.device("cuda")
    arrays = make_rows()
    rows = Rows(*(torch.tensor(a, device=dev) for a in arrays))
    packed = pack_rows(rows)
    cpu_rows = Rows(*(torch.tensor(a) for a in arrays))
    sizes = segment_sizes(models)
    print("default route split segments " + json.dumps(sizes), flush=True)
    n = rows.bins.shape[0]
    b = 256
    out = []
    for label in ("root", "q25", "median", "q75", "max_child"):
        cnt = n if label == "root" else sizes[label]
        rec = time_segment(rows, packed, cpu_rows, cnt, plain=True)
        rec["case"] = label
        sel = segment_sel(cnt, n)
        scr1 = Rows(*(torch.empty_like(a) for a in rows))
        scr2 = type(packed)(torch.empty_like(packed.buf), packed.layout)
        nl = torch.zeros(1, dtype=torch.int32, device=dev)
        for pack, fn in ((1, lambda: fused_split(rows, scr1, sel, nl,
                                                 padded_bins=b)),
                         (2, lambda: fused_split_p2(packed, scr2, sel, nl,
                                                    padded_bins=b))):
            want = ["count_tiles", "fused_scatter", "fused_hist"]
            if hist_blocks(cnt // 2 + 1) > 1:
                want.append("reduce_partials")
            kernels = kernels_of_call(fn)
            if [k for k, _ in kernels] != want:
                raise RuntimeError(f"fused split pack={pack} {label} "
                                   f"launched {kernels}, not {want}")
            key = "" if pack == 1 else "p2_"
            rec[f"{key}kernels_a_call"] = kernels
        del scr1, scr2
        out.append(rec)
    res = {"segments": sizes, "times": out, "gpu": gpu}
    print("fused_split times [ms] " + json.dumps(res), flush=True)
    del rows, packed
    return res


# slice 15: the kernels one call of each unfused partition launches
# (after the memset of the scan's look-back state)
PARTITION_CALL_KERNELS = {"scan": ["memset", "scan_tiles"],
                          "scan_p2": ["memset", "scan_tiles"],
                          "3ph": ["memset", "scan_tiles", "copyback_3ph"]}


# rows too wide for the partition scan to stage (its unstaged kernels)
MANY_FEATURES, MANY_ROWS = 8_000, 6_000


def partition_edges(rows, packed, n: int, f: int) -> list:
    """``partition_scan`` + ``copyback``, ``partition_3ph`` and
    ``partition_scan_p2`` + ``copyback_p2`` bitwise their plain versions
    on the adversarial segments (``partition_edge_cases`` at the tile
    the geometry gives each) of ``n`` rows of ``f`` features."""
    from lightgbm_tpu_torch.ops import partition_kernel as pk
    from lightgbm_tpu_torch.tools import profile_partition as pp
    tile = pk.scan_geometry(n, f).tile
    tile2 = pk.scan_geometry(n, record_stride=packed.layout.stride).tile
    out = [partition_parity(rows, sel, f"{f}_{label}")
           for label, sel in partition_edge_cases(tile, pp.NAN_BIN, n)]
    out += [partition_3ph_parity(rows, sel, f"{f}_{label}")
            for label, sel in partition_edge_cases(tile, pp.NAN_BIN, n,
                                                   bitset=True)]
    out += [pack2_scan_case(rows, packed, sel, f"{f}_{label}")
            for label, sel in partition_edge_cases(tile2, pp.NAN_BIN, n)]
    return out


def partition_phases(gpu: str, route_models: dict) -> dict:
    """Slice 15, the partitions' one-launch scan: on seeded 1M-row
    matrices of 28 and 136 features (``tools/profile_partition.py``'s
    rows), :func:`partition_edges`, then each timed at the 1M-row root
    and (at 28 features) at the split-segment quartiles and largest
    segment below a root of its route's trees (``route_models``: ``unfused``,
    ``pack2_unfused``, ``3ph``), eager and in a graph beside the bound,
    each case bitwise its plain version first and the phase failing
    unless a call launches ``PARTITION_CALL_KERNELS``; last,
    :func:`partition_edges` on ``MANY_ROWS`` rows of ``MANY_FEATURES``,
    which the scan reads unstaged."""
    import torch

    from lightgbm_tpu_torch.ops import partition_kernel as pk
    from lightgbm_tpu_torch.ops.device_data import pack_rows
    from lightgbm_tpu_torch.tools import profile_partition as pp
    cs = sys.modules[__name__]
    n = pp.N_ROWS
    edges, times, segments = [], [], {}
    for route, models in route_models.items():
        seg = segment_sizes(models)
        segments[route] = {k: seg[k] for k in ("q25", "median", "q75",
                                               "max_child")}
    for f in (N_FEATURES, WIDE_FEATURES):
        rows, packed = pp.device_rows(cs, f)
        edges += partition_edges(rows, packed, n, f)
        for route, kernel in (("unfused", "scan"), ("pack2_unfused",
                                                    "scan_p2"),
                              ("3ph", "3ph")):
            if f != N_FEATURES and kernel == "scan_p2":
                continue
            cases = [("root", 0, n)] + [
                (k, pp.SEG_START, c) for k, c in segments[route].items()
                if f == N_FEATURES]
            for label, s0, cnt in cases:
                rec = pp.time_case(cs, kernel, rows, packed,
                                   (s0, cnt, 0, 120, 1, 0, pp.NAN_BIN))
                got = [k for k, _ in rec["kernels_a_call"]]
                if got != PARTITION_CALL_KERNELS[kernel]:
                    raise RuntimeError(f"{kernel} at {cnt} rows launched "
                                       f"{got}, not "
                                       f"{PARTITION_CALL_KERNELS[kernel]}")
                rec.update(route=route, case=label)
                times.append(rec)
        del rows, packed
        torch.cuda.empty_cache()
    rows = rows_on(random_row_matrix(MANY_ROWS, MANY_FEATURES, 32,
                                     nan_bin=pp.NAN_BIN), "cuda")
    packed = pack_rows(rows)
    if pk.scan_geometry(MANY_ROWS, MANY_FEATURES).staged or pk.scan_geometry(
            MANY_ROWS, record_stride=packed.layout.stride).staged:
        raise RuntimeError(f"the scan stages rows of {MANY_FEATURES} "
                           "features")
    edges += partition_edges(rows, packed, MANY_ROWS, MANY_FEATURES)
    del rows, packed
    res = {"segments": segments, "times": times,
           "edge_cases": len(edges), "gpu": gpu}
    print("partition times [ms] " + json.dumps(res), flush=True)
    return res


def hist_comb_cases(models) -> tuple:
    """Slice 14's ranges: the 1M-row root, the smaller children's
    quartiles and the largest smaller child of ``models`` (the P1
    ``FUSED=0`` route's trees), each under the bound ``parent // 2 + 1``
    the grower passes, and each slice count from 1 to one past
    ``COMB_RANGE_SLICES``.  Returns (cases, children)."""
    from lightgbm_tpu_torch.ops.hist_kernel2 import COMB_RANGE_SLICES
    from lightgbm_tpu_torch.tools.profile_hist_comb import cases
    sizes = split_sizes(models)
    order = np.argsort(sizes[:, 1], kind="stable")
    children = {}
    for name, q in (("q25", 0.25), ("median", 0.5), ("q75", 0.75),
                    ("max", 1.0)):
        parent, child = sizes[order[int(round(q * (len(order) - 1)))]]
        children[name] = (int(child), int(parent) // 2 + 1)
    return (cases(TRAIN_ROWS, children, range(1, COMB_RANGE_SLICES + 2)),
            children)


def hist_comb_times(gpu: str, f: int, cases: list) -> list:
    """Slice 14: hist_comb and hist_comb_p2 on seeded 1M x ``f`` rows
    (``tools/profile_hist_comb.device_rows``) at each of ``cases``: both
    packs bitwise the plain version run on CPU copies, and the kernels
    one call launches read from a profiler trace (range mode one
    ``hist_comb_range`` and no ``reduce_partials``, feature mode
    ``hist_comb_partial`` and ``reduce_partials``); the root and the
    children also timed, eager (20 calls) and as one replay of a graph
    of 20, beside one ``index_add_`` of the same rows both ways and the
    byte bound."""
    import torch

    from lightgbm_tpu_torch.ops.hist_kernel2 import comb_geometry
    from lightgbm_tpu_torch.tools.profile_hist_comb import (device_rows,
                                                            time_case)
    me = sys.modules[__name__]
    rows, packed, rows_cpu = device_rows(f)
    out = []
    for label, rng, max_rows in cases:
        geo = comb_geometry(f, 256, max_rows)
        rec = time_case(me, rows, packed, rows_cpu, rng, max_rows,
                        timed=not label.startswith("slices_"))
        want = (["hist_comb_range"] if geo.ranged
                else ["hist_comb_partial", "reduce_partials"])
        for key in ("kernels_a_call", "p2_kernels_a_call"):
            if [k for k, _ in rec[key]] != want:
                raise RuntimeError(f"hist_comb {label} at {f} features "
                                   f"launched {rec[key]}, not {want}")
        rec.update(case=label, features=f, ranged=geo.ranged)
        out.append(rec)
    print(f"hist_comb times [ms] {f} features " + json.dumps(
        {"times": out, "gpu": gpu}), flush=True)
    del rows, packed
    torch.cuda.empty_cache()
    return out


def row_order_phases(gpu: str, ds, valid, ds_wide, valid_wide, x,
                     bst_default) -> tuple:
    """Slice 4's training: card against device="cpu" at 20,000 rows
    (max_bin=1023, bitwise), the row-order main path (1M x 28,
    max_bin=1023, 10 iterations) counted and served, and LGBM_TPU_PHYS=0
    at max_bin=255 (3 iterations, the one-kernel tail), its trees
    printed beside the default route's first 3.  Returns (main-path
    booster, record, PHYS=0 booster, PHYS=0 record, parity record)."""
    parity = train_parity(gpu, {}, ROW_ORDER_PARITY_TREES,
                          "row-order route, max_bin=1023",
                          params=WIDE_PARAMS, bitwise=True)
    bst, main = train_main_path(gpu, ds_wide, valid_wide, x, {},
                                ROW_ORDER_ITERS,
                                "main path, row-order route, max_bin=1023",
                                params=WIDE_PARAMS)
    if not main["route"].startswith("path=row_order"):
        raise RuntimeError(f"max_bin=1023 took the route {main['route']}")
    bst_off, off = train_main_path(gpu, ds, valid, x, PHYS_OFF,
                                   PHYS_OFF_ITERS,
                                   "LGBM_TPU_PHYS=0, max_bin=255")
    if not off["route"].startswith("path=row_order fused=0 tail=kernel"):
        raise RuntimeError(f"LGBM_TPU_PHYS=0 took the route {off['route']}")
    same = compare_trees(bst_default._models[:PHYS_OFF_ITERS],
                         bst_off._models)
    same.update(case=f"default route vs LGBM_TPU_PHYS=0, first "
                f"{PHYS_OFF_ITERS} trees at {TRAIN_ROWS} rows (reported, "
                "not a gate: the sums are taken in another row order)",
                leaves_bitwise=leaves_bitwise(
                    bst_default._models[:PHYS_OFF_ITERS], bst_off._models))
    print("routes default vs row_order " + json.dumps(same), flush=True)
    return bst, main, bst_off, off, parity


def expected_launches(route, trees: int, splits: int) -> dict:
    """Each training kernel's launches on ``route`` for ``trees`` trees
    of ``splits`` splits in all, every tree split at least once: the
    row-order path histograms every root and smaller child through the
    index; the physical path's stream init runs once, the fused route
    carries each next root histogram out of its refresh (tree 0's from
    hist_comb; without the stream every root is built), the unfused
    routes build every root and smaller child with hist_comb and refresh
    without a histogram; per split the fused split + copyback, the scan
    + copyback or the 3-phase partition, and the tail's kernel entry.
    At pack=2 the record kernels take the pack=1 kernels' places.  Under
    ``gpu_use_dp`` the row-order histograms are its f64 mode's; linear
    trees fit each tree's leaves with one ``linear_moments``."""
    kernel_tail = route.tail == "kernel"
    expect = dict.fromkeys(
        ("stream_init", "stream_refresh", "stream_refresh_plain",
         "build_histogram_comb", "partition_scan", "partition_3ph",
         "fused_split", "copyback", "build_histogram_rows",
         "stream_init_p2", "stream_refresh_p2", "stream_refresh_plain_p2",
         "build_histogram_comb_p2", "partition_scan_p2", "fused_split_p2",
         "copyback_p2", "build_histogram_rows_dp"), 0)
    expect["linear_moments"] = trees if "linear_tree" in route.reasons \
        else 0
    expect["apply_find_pool"] = splits if kernel_tail and route.pool_tail \
        else 0
    expect["apply_find"] = splits if kernel_tail and not route.pool_tail \
        else 0
    if route.path == "row_order":
        dp = "gpu_use_dp" in route.reasons
        expect["build_histogram_rows_dp" if dp
               else "build_histogram_rows"] = trees + splits
        return expect
    stream, fused = route.stream, route.fused
    three = route.scheme == "3ph"
    rows = dict(
        stream_init=1 if stream else 0,
        stream_refresh=trees if stream and fused else 0,
        stream_refresh_plain=trees if stream and not fused else 0,
        build_histogram_comb=(1 if stream else trees) if fused
        else trees + splits,
        fused_split=splits if fused else 0,
        partition_scan=splits if not fused and not three else 0,
        copyback=splits if not three else 0,
        partition_3ph=splits if three else 0)
    # the 3ph scheme is never pack=2, so every nonzero count has a p2 kernel
    suffix = "_p2" if route.pack == 2 else ""
    expect.update({k + suffix: v for k, v in rows.items() if v})
    return expect


# ---------------------------------------------------------------------
# Slice 5: the 3-phase partition route and the pool-less tail
PART_3PH = {"LGBM_TPU_PART": "3ph"}
PART_3PH_ITERS = 2
POOL_TAIL_OFF = {"LGBM_TPU_POOL_TAIL": "0"}
POOL_TAIL_ITERS = 2


def part_3ph_phases(gpu: str, ds, valid, x, bst_default) -> tuple:
    """Slice 5's training: the 3ph route card against device="cpu" at
    20,000 rows (bitwise), its main path (1M x 28, 255 leaves, 3
    iterations) counted and served, its trees printed beside the default
    route's first 3 (not a gate: the right children add their rows in
    another order), and LGBM_TPU_POOL_TAIL=0 (2 iterations), counted,
    whose trees must equal the default route's bit for bit.  Returns
    (3ph booster, 3ph record, pool-tail record, parity record)."""
    parity = train_parity(gpu, PART_3PH, PARITY_TREES, "3ph route",
                          bitwise=True)
    bst, main = train_main_path(gpu, ds, valid, x, PART_3PH, PART_3PH_ITERS,
                                "main path, 3ph route")
    if main["route"] != ("path=stream scheme=3ph fused=0 tail=kernel "
                         "(part_3ph)"):
        raise RuntimeError(f"LGBM_TPU_PART=3ph took the route "
                           f"{main['route']}")
    same = compare_trees(bst_default._models[:PART_3PH_ITERS], bst._models)
    same.update(case=f"default route vs 3ph route, first {PART_3PH_ITERS} "
                f"trees at {TRAIN_ROWS} rows (reported, not a gate: the "
                "right children's rows are added in another order)",
                leaves_bitwise=leaves_bitwise(
                    bst_default._models[:PART_3PH_ITERS], bst._models))
    print("routes default vs 3ph " + json.dumps(same), flush=True)
    bst_pool, pool = train_main_path(gpu, ds, valid, x, POOL_TAIL_OFF,
                                     POOL_TAIL_ITERS, "LGBM_TPU_POOL_TAIL=0")
    if "pool_tail=0" not in pool["route"]:
        raise RuntimeError(f"LGBM_TPU_POOL_TAIL=0 took the route "
                           f"{pool['route']}")
    _same_trees(bst_default, bst_pool, "default route vs "
                "LGBM_TPU_POOL_TAIL=0")
    return bst, main, pool, parity


# ---------------------------------------------------------------------
# Slice 6: pack=2, one record per row on the default route
PACK2 = {"LGBM_TPU_COMB_PACK": "2"}
PACK2_WIDE_ROWS = 250_000
PACK2_WIDE_FEATURES = 40


def pack2_stream_case(bins, kind: str, padded_bins: int, label: str,
                      seed: int = 5) -> dict:
    """stream_init_p2 and stream_refresh_p2 against their plain versions
    (the records byte for byte) and against stream_init / stream_refresh
    on the same inputs (the records' fields bitwise the pack=1 rows, the
    refresh's root histograms bitwise), the refresh's histogram bitwise
    hist_comb_p2's over the refreshed records and within
    4 * n * eps_f32 * max|v| of its plain version's; one counted launch
    each."""
    import torch

    from lightgbm_tpu_torch.ops.device_data import PackedRows
    from lightgbm_tpu_torch.ops.hist_kernel2 import build_histogram_comb_p2
    from lightgbm_tpu_torch.ops.stream_grad import (stream_init,
                                                    stream_init_p2,
                                                    stream_init_p2_ref,
                                                    stream_refresh,
                                                    stream_refresh_p2,
                                                    stream_refresh_p2_ref)
    dev = bins.device
    n = bins.shape[0]
    score, valid, consts = stream_aux(n, kind, seed, dev)
    kw = dict(kind=kind, sigmoid=1.0)
    launches = (stream_init_p2.launches, stream_refresh_p2.launches)
    k2 = stream_init_p2(bins, score, valid, consts, **kw)
    r2 = stream_init_p2_ref(bins, score, valid, consts, **kw)
    k1 = stream_init(bins, score, valid, consts, **kw)
    torch.cuda.synchronize()
    rec = {"case": label, "n": n, "kind": kind, "stride": k2.layout.stride,
           "init_identical": torch_equal(k2.buf, r2.buf),
           "init_fields_pack1_identical": _rows_equal(k2.fields(), k1)}
    r2 = PackedRows(k2.buf.clone(), k2.layout)
    lv = torch.tensor(np.random.default_rng(seed + 1).normal(size=n) * 0.1,
                      dtype=torch.float32, device=dev)
    hk2 = stream_refresh_p2(k2, lv, padded_bins=padded_bins, **kw)
    hr2 = stream_refresh_p2_ref(r2, lv, padded_bins=padded_bins, **kw)
    hk1 = stream_refresh(k1, lv, padded_bins=padded_bins, **kw)
    root = torch.tensor([0, 0, n], dtype=torch.int32, device=dev)
    hc2 = build_histogram_comb_p2(k2, root, padded_bins=padded_bins,
                                  max_rows=n)
    torch.cuda.synchronize()
    rec.update(
        refresh_identical=torch_equal(k2.buf, r2.buf),
        refresh_fields_pack1_identical=_rows_equal(k2.fields(), k1),
        root_hist_bitwise_pack1=torch_equal(hk2, hk1),
        root_hist_bitwise_hist_comb_p2=torch_equal(hk2, hc2),
        max_abs_err=float((hk2 - hr2).abs().max()),
        tol=hist_tolerance(k2.fields(), (0, 0, n)),
        launched=[stream_init_p2.launches - launches[0],
                  stream_refresh_p2.launches - launches[1]])
    rec["ok"] = (rec["init_identical"] and rec["init_fields_pack1_identical"]
                 and rec["refresh_identical"]
                 and rec["refresh_fields_pack1_identical"]
                 and rec["root_hist_bitwise_pack1"]
                 and rec["root_hist_bitwise_hist_comb_p2"]
                 and rec["max_abs_err"] <= rec["tol"]
                 and rec["launched"] == [1, 1])
    print("parity pack2 stream " + json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise RuntimeError(f"the pack=2 stream kernels disagree: {rec}")
    return rec


def pack2_hist_case(rows, packed, rng, padded_bins: int, label: str) -> dict:
    """hist_comb_p2 on the records against hist_comb on the same rows
    (bitwise), against its plain version (within 4 * n * eps_f32 *
    max|v|), two launches bitwise."""
    import torch

    from lightgbm_tpu_torch.ops.hist_kernel2 import (
        build_histogram_comb, build_histogram_comb_p2,
        build_histogram_comb_p2_ref)
    rng_t = torch.tensor(rng, dtype=torch.int32, device=rows.bins.device)
    kw = dict(padded_bins=padded_bins, max_rows=max(int(rng[2]), 1))
    launches = build_histogram_comb_p2.launches
    k1 = build_histogram_comb_p2(packed, rng_t, **kw)
    k2 = build_histogram_comb_p2(packed, rng_t, **kw)
    p1 = build_histogram_comb(rows, rng_t, **kw)
    ref = build_histogram_comb_p2_ref(packed, rng_t, **kw)
    torch.cuda.synchronize()
    rec = {"case": label, "range": list(rng), "stride": packed.layout.stride,
           "bitwise_pack1": torch_equal(k1, p1),
           "bitwise_repeat": torch_equal(k1, k2),
           "max_abs_err": float((k1 - ref).abs().max()),
           "tol": hist_tolerance(rows, rng),
           "launched": build_histogram_comb_p2.launches - launches}
    rec["ok"] = (rec["bitwise_pack1"] and rec["bitwise_repeat"]
                 and rec["max_abs_err"] <= rec["tol"]
                 and rec["launched"] == 2)
    print("parity pack2 hist_comb " + json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise RuntimeError(f"hist_comb_p2 disagrees: {rec}")
    return rec


def pack2_split_case(rows, packed, sel, padded_bins: int, label: str) -> dict:
    """fused_split_p2 + copyback_p2 on copies of the records against
    their plain versions (scratch segment and, after the copyback, the
    whole record buffer byte for byte; histograms within 4 * n *
    eps_f32 * max|v|) and against fused_split + copyback on the same
    rows (fields, nleft and both histograms bitwise); one counted launch
    each (none for a dead split)."""
    import torch

    from lightgbm_tpu_torch.ops.device_data import PackedRows, Rows
    from lightgbm_tpu_torch.ops.fused_split import (child_ranges,
                                                    fused_split,
                                                    fused_split_p2,
                                                    fused_split_p2_ref)
    from lightgbm_tpu_torch.ops.partition_kernel import (copyback,
                                                         copyback_p2,
                                                         copyback_p2_ref)
    dev = rows.bins.device
    pk = PackedRows(packed.buf.clone(), packed.layout)
    pp = PackedRows(packed.buf.clone(), packed.layout)
    sk = PackedRows(torch.zeros_like(packed.buf), packed.layout)
    sp = PackedRows(torch.zeros_like(packed.buf), packed.layout)
    r1 = Rows(*(a.clone() for a in rows))
    s1 = Rows(*(torch.zeros_like(a) for a in rows))
    nk, npl, n1 = (torch.full((1,), v, dtype=torch.int32, device=dev)
                   for v in (-1, -2, -3))
    s0, cnt = int(sel[0]), int(sel[1])
    launches = (fused_split_p2.launches, copyback_p2.launches)
    hk = fused_split_p2(pk, sk, sel, nk, padded_bins=padded_bins)
    hp = fused_split_p2_ref(pp, sp, sel, npl, padded_bins=padded_bins)
    h1 = fused_split(r1, s1, sel, n1, padded_bins=padded_bins)
    torch.cuda.synchronize()
    seg = slice(s0, s0 + cnt)
    rec = {"case": label, "s0": s0, "cnt": cnt, "nleft": int(nk),
           "stride": packed.layout.stride,
           "nleft_equal": int(nk) == int(npl) == int(n1),
           "scan_identical": torch_equal(sk.buf[seg], sp.buf[seg]),
           "scan_fields_pack1_identical": _rows_equal(
               [a[seg] for a in sk.fields()], [a[seg] for a in s1]),
           "hist_bitwise_pack1": torch_equal(hk, h1),
           "max_abs_err": float((hk - hp).abs().max()) if cnt else 0.0,
           "tol": max([hist_tolerance(sk.fields(), r) for r in
                       child_ranges(s0, cnt, int(nk))] + [0.0])}
    copyback_p2(pk, sk, s0, cnt)
    copyback_p2_ref(pp, sp, s0, cnt)
    copyback(r1, s1, s0, cnt)
    torch.cuda.synchronize()
    rec.update(rows_identical=torch_equal(pk.buf, pp.buf),
               rows_fields_pack1_identical=_rows_equal(pk.fields(), r1),
               outside_untouched=(torch_equal(pk.buf[:s0], packed.buf[:s0])
                                  and torch_equal(pk.buf[s0 + cnt:],
                                                  packed.buf[s0 + cnt:])),
               launched=[fused_split_p2.launches - launches[0],
                         copyback_p2.launches - launches[1]])
    live = 1 if cnt > 0 else 0
    rec["ok"] = (rec["nleft_equal"] and rec["scan_identical"]
                 and rec["scan_fields_pack1_identical"]
                 and rec["hist_bitwise_pack1"]
                 and rec["max_abs_err"] <= rec["tol"]
                 and rec["rows_identical"]
                 and rec["rows_fields_pack1_identical"]
                 and rec["outside_untouched"]
                 and rec["launched"] == [live, live])
    print("parity pack2 fused_split+copyback " + json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise RuntimeError(f"fused_split_p2 / copyback_p2 disagree: {rec}")
    return rec


def pack2_scan_case(rows, packed, sel, label: str) -> dict:
    """partition_scan_p2 + copyback_p2 (the unfused pack=2 split) on
    copies of the records against their plain versions (scratch segment
    and, after the copyback, the whole record buffer byte for byte) and
    against partition_scan + copyback on the same rows (fields and nleft
    bitwise); one counted launch each (none for a dead split)."""
    import torch

    from lightgbm_tpu_torch.ops.device_data import PackedRows, Rows
    from lightgbm_tpu_torch.ops.partition_kernel import (
        copyback, copyback_p2, copyback_p2_ref, partition_scan,
        partition_scan_p2, partition_scan_p2_ref)
    dev = rows.bins.device
    pk = PackedRows(packed.buf.clone(), packed.layout)
    pp = PackedRows(packed.buf.clone(), packed.layout)
    sk = PackedRows(torch.zeros_like(packed.buf), packed.layout)
    sp = PackedRows(torch.zeros_like(packed.buf), packed.layout)
    r1 = Rows(*(a.clone() for a in rows))
    s1 = Rows(*(torch.zeros_like(a) for a in rows))
    nk, npl, n1 = (torch.full((1,), v, dtype=torch.int32, device=dev)
                   for v in (-1, -2, -3))
    s0, cnt = int(sel[0]), int(sel[1])
    launches = (partition_scan_p2.launches, copyback_p2.launches)
    partition_scan_p2(pk, sk, sel, nk)
    partition_scan_p2_ref(pp, sp, sel, npl)
    partition_scan(r1, s1, sel, n1)
    torch.cuda.synchronize()
    seg = slice(s0, s0 + cnt)
    rec = {"case": label, "s0": s0, "cnt": cnt, "nleft": int(nk),
           "stride": packed.layout.stride,
           "nleft_equal": int(nk) == int(npl) == int(n1),
           "scan_identical": torch_equal(sk.buf[seg], sp.buf[seg]),
           "scan_fields_pack1_identical": _rows_equal(
               [a[seg] for a in sk.fields()], [a[seg] for a in s1])}
    copyback_p2(pk, sk, s0, cnt)
    copyback_p2_ref(pp, sp, s0, cnt)
    copyback(r1, s1, s0, cnt)
    torch.cuda.synchronize()
    rec.update(rows_identical=torch_equal(pk.buf, pp.buf),
               rows_fields_pack1_identical=_rows_equal(pk.fields(), r1),
               outside_untouched=(torch_equal(pk.buf[:s0], packed.buf[:s0])
                                  and torch_equal(pk.buf[s0 + cnt:],
                                                  packed.buf[s0 + cnt:])),
               launched=[partition_scan_p2.launches - launches[0],
                         copyback_p2.launches - launches[1]])
    live = 1 if cnt > 0 else 0
    rec["ok"] = (rec["nleft_equal"] and rec["scan_identical"]
                 and rec["scan_fields_pack1_identical"]
                 and rec["rows_identical"]
                 and rec["rows_fields_pack1_identical"]
                 and rec["outside_untouched"]
                 and rec["launched"] == [live, live])
    print("parity pack2 partition_scan+copyback " + json.dumps(rec),
          flush=True)
    if not rec["ok"]:
        raise RuntimeError(f"partition_scan_p2 / copyback_p2 disagree: {rec}")
    return rec


def pack2_refresh_plain_case(bins, kind: str, label: str,
                             seed: int = 5) -> dict:
    """stream_refresh_plain_p2 on the plain init's records against its
    plain version (the records byte for byte, so the bins and pads
    untouched) and against stream_refresh_plain on the same rows (the
    fields bitwise); one counted launch."""
    import torch

    from lightgbm_tpu_torch.ops.device_data import PackedRows, pack_rows
    from lightgbm_tpu_torch.ops.stream_grad import (
        stream_init_ref, stream_refresh_plain, stream_refresh_plain_p2,
        stream_refresh_plain_p2_ref)
    dev = bins.device
    n = bins.shape[0]
    score, valid, consts = stream_aux(n, kind, seed, dev)
    kw = dict(kind=kind, sigmoid=1.0)
    r1 = stream_init_ref(bins, score, valid, consts, **kw)
    k2 = pack_rows(r1)
    before = k2.buf.clone()
    p2 = PackedRows(k2.buf.clone(), k2.layout)
    lv = torch.tensor(np.random.default_rng(seed + 1).normal(size=n) * 0.1,
                      dtype=torch.float32, device=dev)
    launches = stream_refresh_plain_p2.launches
    stream_refresh_plain_p2(k2, lv, **kw)
    stream_refresh_plain_p2_ref(p2, lv, **kw)
    stream_refresh_plain(r1, lv, **kw)
    torch.cuda.synchronize()
    fb = k2.layout.fb
    rec = {"case": label, "n": n, "kind": kind, "stride": k2.layout.stride,
           "rows_identical": torch_equal(k2.buf, p2.buf),
           "fields_pack1_identical": _rows_equal(k2.fields(), r1),
           "bins_untouched": torch_equal(k2.buf[:, :fb], before[:, :fb]),
           "changed": not torch_equal(k2.buf, before),
           "launched": stream_refresh_plain_p2.launches - launches}
    rec["ok"] = (rec["rows_identical"] and rec["fields_pack1_identical"]
                 and rec["bins_untouched"] and rec["changed"]
                 and rec["launched"] == 1)
    print("parity pack2 stream_refresh_plain " + json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise RuntimeError(f"stream_refresh_plain_p2 disagrees: {rec}")
    return rec


def pack2_cases(bins, prows, padded_bins: int, label: str) -> dict:
    """Every pack=2 case at one width: the stream kernels on ``bins``
    (binary and l2, both refreshes), the histogram and both splits on
    the records of the seeded row matrix ``prows`` (the root / the whole
    matrix, a range and a segment at an odd offset of odd length, a dead
    split)."""
    from lightgbm_tpu_torch.ops.device_data import pack_rows
    n = prows.bins.shape[0]
    packed = pack_rows(prows)
    odd = (n // 10 | 1, n // 300 | 1, 0, 60, 1, 0, 254)
    sels = (("whole", (0, n, 0, 120, 1, 0, 254)),
            ("odd_offset_odd_count", odd),
            ("dead_split", (n // 2, 0, 2, 10, 0, 0, -1)))
    kinds = ("binary", "l2")
    return {
        "stream": [pack2_stream_case(bins, k, padded_bins, f"{label}_{k}")
                   for k in kinds],
        "refresh_plain": [pack2_refresh_plain_case(bins, k, f"{label}_{k}")
                          for k in kinds],
        "hist": [pack2_hist_case(prows, packed, r, padded_bins, f"{label}_{c}")
                 for c, r in (("root", (0, 0, n)),
                              ("odd", (n // 3 | 1, 4, n // 4 | 1)))],
        "split": [pack2_split_case(prows, packed, sel, padded_bins,
                                   f"{label}_{c}") for c, sel in sels],
        "scan": [pack2_scan_case(prows, packed, sel, f"{label}_{c}")
                 for c, sel in sels]}


def pack2_kernels(gpu: str, ds) -> list:
    """Slices 6 and 7: the seven record kernels against their plain
    versions and their pack=1 kernels at the main path's shapes (the
    training matrix's real bins, 1M x 28, S = 64) and at 250,000 x 40
    (S = 80), then each one's time beside its pack=1 kernel's (taken in
    turns: pack=1, pack=2, pack=2, pack=1) and its plain version's.
    Returns the seven records, launches still 0."""
    import torch

    from lightgbm_tpu_torch.ops.device_data import (PackedRows,
                                                    RecordLayout, Rows,
                                                    pack_rows)
    from lightgbm_tpu_torch.ops.fused_split import (fused_split,
                                                    fused_split_p2,
                                                    fused_split_p2_ref)
    from lightgbm_tpu_torch.ops.hist_kernel2 import (
        build_histogram_comb, build_histogram_comb_p2,
        build_histogram_comb_p2_ref)
    from lightgbm_tpu_torch.ops.partition_kernel import (
        copyback, copyback_p2, copyback_p2_ref, partition_scan,
        partition_scan_p2, partition_scan_p2_ref)
    from lightgbm_tpu_torch.ops.stream_grad import (
        stream_init, stream_init_p2, stream_init_p2_ref, stream_refresh,
        stream_refresh_p2, stream_refresh_p2_ref, stream_refresh_plain,
        stream_refresh_plain_p2, stream_refresh_plain_p2_ref)
    dev = torch.device("cuda")
    bins = torch.as_tensor(ds._binned.bin_matrix, device=dev)
    n, f = bins.shape
    b_pad = 256
    parts = random_row_matrix(n, f, 11, nan_bin=254)
    prows = rows_on((np.ascontiguousarray(
        np.concatenate([parts[0][:, :1], ds._binned.bin_matrix[:, 1:]], 1)),
        *parts[1:]), dev)
    main = pack2_cases(bins, prows, b_pad, "1M_F28")
    wide = random_row_matrix(PACK2_WIDE_ROWS, PACK2_WIDE_FEATURES, 13,
                             nan_bin=254)
    wide_rows = rows_on(wide, dev)
    wide_cases = pack2_cases(wide_rows.bins, wide_rows, b_pad, "250000_F40")
    del wide_rows

    # times at the main path's shapes, L2 warm as in training
    packed = pack_rows(prows)
    scratch1 = Rows(*(torch.empty_like(a) for a in prows))
    scratch2 = PackedRows(torch.empty_like(packed.buf), packed.layout)
    sel = (0, n, 0, 120, 1, 0, 254)
    nl = torch.zeros(1, dtype=torch.int32, device=dev)
    root = torch.tensor([0, 0, n], dtype=torch.int32, device=dev)
    score, valid, consts = stream_aux(n, "binary", 5, dev)
    s_kw = dict(kind="binary", sigmoid=1.0)
    srows1 = stream_init(bins, score, valid, consts, **s_kw)
    srows2 = stream_init_p2(bins, score, valid, consts, **s_kw)
    lv = torch.zeros(n, dtype=torch.float32, device=dev)
    h_kw = dict(padded_bins=b_pad, max_rows=n)
    pairs = {
        "stream_init": (
            lambda: stream_init(bins, score, valid, consts, **s_kw),
            lambda: stream_init_p2(bins, score, valid, consts, **s_kw),
            lambda: stream_init_p2_ref(bins, score, valid, consts, **s_kw)),
        "hist_comb": (
            lambda: build_histogram_comb(prows, root, **h_kw),
            lambda: build_histogram_comb_p2(packed, root, **h_kw),
            lambda: build_histogram_comb_p2_ref(packed, root, **h_kw)),
        "fused_split": (
            lambda: fused_split(prows, scratch1, sel, nl, padded_bins=b_pad),
            lambda: fused_split_p2(packed, scratch2, sel, nl,
                                   padded_bins=b_pad),
            lambda: fused_split_p2_ref(packed, scratch2, sel, nl,
                                       padded_bins=b_pad)),
        "copyback": (
            lambda: copyback(prows, scratch1, 0, n),
            lambda: copyback_p2(packed, scratch2, 0, n),
            lambda: copyback_p2_ref(packed, scratch2, 0, n)),
        "stream_refresh": (
            lambda: stream_refresh(srows1, lv, padded_bins=b_pad, **s_kw),
            lambda: stream_refresh_p2(srows2, lv, padded_bins=b_pad, **s_kw),
            lambda: stream_refresh_p2_ref(srows2, lv, padded_bins=b_pad,
                                          **s_kw)),
        "partition_scan": (
            lambda: partition_scan(prows, scratch1, sel, nl),
            lambda: partition_scan_p2(packed, scratch2, sel, nl),
            lambda: partition_scan_p2_ref(packed, scratch2, sel, nl)),
        "stream_refresh_plain": (
            lambda: stream_refresh_plain(srows1, lv, **s_kw),
            lambda: stream_refresh_plain_p2(srows2, lv, **s_kw),
            lambda: stream_refresh_plain_p2_ref(srows2, lv, **s_kw)),
    }
    t = {}
    for name, (p1, p2, plain) in pairs.items():
        a1, a2 = _time_ms(p1, 20), _time_ms(p2, 20)
        b2, b1 = _time_ms(p2, 20), _time_ms(p1, 20)
        t[name] = {"pack1_ms": (a1 + b1) / 2, "ms": (a2 + b2) / 2,
                   "plain_ms": _time_ms(plain, 3)}
    library_ms = library_hist_ms(prows.bins, prows.vals, b_pad)
    copy_library_ms = library_copy_ms(packed, scratch2, 0, n)
    print("pack2 kernel times [ms] at the main path's shapes "
          + json.dumps(t) + f" [{gpu}]", flush=True)
    del packed, scratch1, scratch2, srows1, srows2, prows

    lay = RecordLayout(f)
    stride = lay.stride
    row1 = f + ROW_EXTRA_BYTES
    hist_out = f * b_pad * 2 * 4
    def worst(kind: str) -> float:
        return max(r["max_abs_err"] for r in main[kind] + wide_cases[kind])
    # (name, source, replaces, pack=1 name, bytes at pack=2, bytes at
    # pack=1, operations, max |err| vs plain)
    specs = [
        # reads bins, score, validity, two constants; writes every record
        ("stream_init_p2", "lightgbm_tpu_torch/csrc/stream_grad.cu",
         "lightgbm_tpu/ops/pallas/stream_grad.py:754", "stream_init",
         n * (f + 16) + n * stride, n * (f + 16) + n * row1, 16 * n, 0.0),
        # reads each row's bins and (g*w, h*w), writes the histogram
        ("hist_comb_p2", "lightgbm_tpu_torch/csrc/hist_comb.cu",
         "lightgbm_tpu/ops/pallas/hist_kernel2.py:225", "hist_comb",
         n * (f + 8) + hist_out, n * (f + 8) + hist_out, 2 * n * f,
         worst("hist")),
        # reads and writes every record of the segment once, both
        # histograms
        ("fused_split_p2", "lightgbm_tpu_torch/csrc/fused_split.cu",
         "lightgbm_tpu/ops/pallas/fused_split.py:417", "fused_split",
         2 * n * stride + 2 * hist_out, 2 * n * row1 + 2 * hist_out,
         2 * n * f, worst("split")),
        ("copyback_p2", "lightgbm_tpu_torch/csrc/partition.cu",
         "lightgbm_tpu/ops/pallas/partition_kernel3.py:562", "copyback",
         2 * n * stride, 2 * n * row1, 0, 0.0),
        # reads bins, score, w, two constants, lv; writes score, g*w, h*w
        # and the histogram
        ("stream_refresh_p2", "lightgbm_tpu_torch/csrc/stream_grad.cu",
         "lightgbm_tpu/ops/pallas/stream_grad.py:610", "stream_refresh",
         n * (f + 20) + 12 * n + hist_out, n * (f + 20) + 12 * n + hist_out,
         n * (17 + 2 * f), worst("stream")),
        # reads the split column, reads and writes every record of the
        # segment once, writes nleft
        ("partition_scan_p2", "lightgbm_tpu_torch/csrc/partition.cu",
         "lightgbm_tpu/ops/pallas/partition_kernel3.py:633",
         "partition_scan", 2 * n * stride + 4, 2 * n * row1 + 4, 0, 0.0),
        # reads score, w, two constants and lv, writes score, g*w, h*w;
        # ~17 operations a row (the f64 exp counted as one)
        ("stream_refresh_plain_p2", "lightgbm_tpu_torch/csrc/stream_grad.cu",
         "lightgbm_tpu/ops/pallas/stream_grad.py:652",
         "stream_refresh_plain", 32 * n, 32 * n, 17 * n, 0.0),
    ]
    recs = []
    for name, src, replaces, p1, nb, nb1, ops, err in specs:
        tm = t[p1]
        extra = dict(pack1_kernel=p1, pack1_ms=tm["pack1_ms"],
                     pack1_bound_ms=max(nb1 / PEAK_BYTES_S,
                                        ops / PEAK_OPS_S) * 1e3,
                     record_stride=stride, parity_vs_pack1="bitwise")
        if name == "hist_comb_p2":
            extra.update(library_ms=library_ms,
                         library_call="index_add_ over a precomputed flat "
                                      "(feature, bin) index, index build "
                                      "excluded")
        if name == "copyback_p2":
            extra.update(library_ms=copy_library_ms,
                         library_call="one Tensor.copy_ of the segment's "
                                      "records")
        if name == "stream_refresh_plain_p2":
            # what a record layout costs a narrow kernel: the 32-byte
            # sectors that the fields [Fb, Fb + 28) touch, read once and
            # written once, and lv
            sector = n * (2 * 32 * _sectors(lay.fb, lay.fb + 28) + 4)
            extra.update(sector_bytes=sector,
                         sector_bound_ms=sector / PEAK_BYTES_S * 1e3)
        recs.append(_kernel_record(name, src, replaces, 0, err, tm["ms"],
                                   tm["plain_ms"], nb, ops, gpu, **extra))
    recs[0]["wide_case_stride"] = wide_cases["split"][0]["stride"]
    return recs


def _sectors(lo: int, hi: int) -> int:
    """32-byte sectors that bytes [lo, hi) of a record touch (records
    start on 16-byte boundaries; S a multiple of 32 keeps the count
    the same for every record)."""
    return (hi - 1) // 32 - lo // 32 + 1


def row_kernel_times(n: int = TRAIN_ROWS, f: int = N_FEATURES,
                     reps: int = 20) -> dict:
    """CUDA-event times of the pack=1 kernels whose sources the record
    kernels share (hist_comb at the root, fused_split and copyback on the
    whole matrix, stream_init, stream_refresh) on seeded rows, printed as
    one JSON line: run from two checkouts on one card to compare them
    (the wrappers it calls have the same signatures since slice 3)."""
    import torch

    from lightgbm_tpu_torch.ops.device_data import Rows
    from lightgbm_tpu_torch.ops.fused_split import fused_split
    from lightgbm_tpu_torch.ops.hist_kernel2 import build_histogram_comb
    from lightgbm_tpu_torch.ops.partition_kernel import copyback
    from lightgbm_tpu_torch.ops.stream_grad import (stream_init,
                                                    stream_refresh)
    dev = torch.device("cuda")
    rows = rows_on(random_row_matrix(n, f, 11, nan_bin=254), dev)
    scratch = Rows(*(torch.empty_like(a) for a in rows))
    root = torch.tensor([0, 0, n], dtype=torch.int32, device=dev)
    sel = (0, n, 0, 120, 1, 0, 254)
    nl = torch.zeros(1, dtype=torch.int32, device=dev)
    score, valid, consts = stream_aux(n, "binary", 5, dev)
    kw = dict(kind="binary", sigmoid=1.0)
    srows = stream_init(rows.bins, score, valid, consts, **kw)
    lv = torch.zeros(n, dtype=torch.float32, device=dev)
    out = {
        "hist_comb": _time_ms(lambda: build_histogram_comb(
            rows, root, padded_bins=256, max_rows=n), reps),
        "fused_split": _time_ms(lambda: fused_split(
            rows, scratch, sel, nl, padded_bins=256), reps),
        "copyback": _time_ms(lambda: copyback(rows, scratch, 0, n), reps),
        "stream_init": _time_ms(lambda: stream_init(
            rows.bins, score, valid, consts, **kw), reps),
        "stream_refresh": _time_ms(lambda: stream_refresh(
            srows, lv, padded_bins=256, **kw), reps),
        "gpu": _gpu_line()}
    print("row kernel times [ms] " + json.dumps(out), flush=True)
    return out


def refresh_times(gpu: str, n: int = TRAIN_ROWS, f: int = N_FEATURES,
                         pkg: str = "lightgbm_tpu_torch") -> dict:
    """The root-histogram refresh at the main path's shapes (n rows x f
    features, B = 256), both packs, beside its parts in this package
    (the plain refresh and ``hist_comb``'s root over [0, n)), eager and
    as one replay of a graph of 20 calls (``eager_and_graph_ms``).
    ``pkg`` names the package to time (another commit's, loaded under
    another name, whose refresh may be one fused kernel)."""
    import importlib

    import torch
    sg = importlib.import_module(pkg + ".ops.stream_grad")
    hk = importlib.import_module(pkg + ".ops.hist_kernel2")
    dev = torch.device("cuda")
    bins = rows_on(random_row_matrix(n, f, 11, nan_bin=254), dev).bins
    score, valid, consts = stream_aux(n, "binary", 5, dev)
    kw = dict(kind="binary", sigmoid=1.0)
    lv = torch.tensor(np.random.default_rng(6).normal(size=n) * 0.01,
                      dtype=torch.float32, device=dev)
    root = torch.tensor([0, 0, n], dtype=torch.int32, device=dev)
    out = {"rows": n, "features": f, "package": pkg, "gpu": gpu}
    for pack in (1, 2):
        init = sg.stream_init if pack == 1 else sg.stream_init_p2
        refresh = sg.stream_refresh if pack == 1 else sg.stream_refresh_p2
        plain = (sg.stream_refresh_plain if pack == 1
                 else sg.stream_refresh_plain_p2)
        hist = (hk.build_histogram_comb if pack == 1
                else hk.build_histogram_comb_p2)
        rows = init(bins, score, valid, consts, **kw)
        out[f"pack{pack}"] = {
            # one launch a training; from device memory like the first
            # tree's, the bins' 28 MB flushed out of L2 before each call
            "init": eager_and_graph_ms(
                lambda: init(bins, score, valid, consts, **kw)),
            "init_l2_flushed": cold_ms(
                lambda: init(bins, score, valid, consts, **kw)),
            "init_l2_clean": cold_ms(
                lambda: init(bins, score, valid, consts, **kw),
                flush_by="read"),
            "refresh": eager_and_graph_ms(
                lambda: refresh(rows, lv, padded_bins=256, **kw)),
            "plain_refresh": eager_and_graph_ms(
                lambda: plain(rows, lv, **kw)),
            # from device memory: the rows' 32 MB stay in L2 between
            # the calls of a replayed graph
            "plain_refresh_l2_flushed": cold_ms(
                lambda: plain(rows, lv, **kw)),
            "plain_refresh_l2_clean": cold_ms(
                lambda: plain(rows, lv, **kw), flush_by="read"),
            "hist_comb_root": eager_and_graph_ms(
                lambda: hist(rows, root, padded_bins=256, max_rows=n))}
        del rows
    print("refresh times [ms, graph ms] " + json.dumps(out), flush=True)
    return out


def pack2_phases(gpu: str, ds, valid, x, bst_default) -> tuple:
    """Slice 6's training: the pack=2 route card against device="cpu" at
    20,000 rows (bitwise), its main path (1M x 28, 255 leaves, 10
    iterations) counted and served, its trees held against the default
    route's bit for bit.  Returns (booster, record, parity record)."""
    parity = train_parity(gpu, PACK2, PARITY_TREES, "pack=2 route",
                          bitwise=True)
    bst, main = train_main_path(gpu, ds, valid, x, PACK2, TRAIN_ITERS,
                                "main path, pack=2 route")
    if main["route"] != "path=stream fused=1 tail=kernel pack=2":
        raise RuntimeError(f"LGBM_TPU_COMB_PACK=2 took the route "
                           f"{main['route']}")
    _same_trees(bst_default, bst, "default route vs pack=2 route")
    return bst, main, parity


# ---------------------------------------------------------------------
# Slice 7: pack=2 without the fused split
FUSED_OFF = {"LGBM_TPU_FUSED": "0"}
PACK2_UNFUSED = dict(PACK2, **FUSED_OFF)
PACK2_SLICE2 = dict(PACK2, **SLICE2_ROUTE)
PACK2_UNFUSED_ITERS = 2


def pack2_unfused_phases(gpu: str, ds, valid, x, bst_default,
                         bst_slice2) -> tuple:
    """Slice 7's training: card against device="cpu" at 20,000 rows
    (bitwise) on COMB_PACK=2 FUSED=0 and on pack=2 slice 2's route; the
    main path COMB_PACK=2 FUSED=0 (1M x 28, 255 leaves, 3 iterations)
    counted and served, beside the pack=1 FUSED=0 route (3 iterations),
    both bitwise the default route's first 3 trees; slice 2's route at
    pack=2 (3 iterations), bitwise slice 2's route's trees.  Returns
    (boosters, records, parity records), each keyed by route."""
    parity = {
        "pack2_unfused": train_parity(gpu, PACK2_UNFUSED, PARITY_TREES,
                                      "pack=2 unfused route", bitwise=True),
        "pack2_slice2": train_parity(gpu, PACK2_SLICE2, SLICE2_PARITY_TREES,
                                     "pack=2 slice 2 route", bitwise=True)}
    # (key, knobs, label, the route they must take, the booster whose
    # first trees they must grow)
    runs = (("pack2_unfused", PACK2_UNFUSED, "main path, pack=2 unfused route",
             "path=stream fused=0 tail=kernel pack=2 (fused_env_off)",
             bst_default),
            ("pack1_unfused", FUSED_OFF, "pack=1 unfused route",
             "path=stream fused=0 tail=kernel (fused_env_off)", bst_default),
            ("pack2_slice2", PACK2_SLICE2, "pack=2 slice 2 route",
             "path=physical fused=0 tail=xla pack=2 (stream_env_off, "
             "fused_env_off, tail_env_xla)", bst_slice2))
    bsts, recs = {}, {}
    for key, env, label, want, ref in runs:
        bsts[key], recs[key] = train_main_path(gpu, ds, valid, x, env,
                                               PACK2_UNFUSED_ITERS, label)
        if recs[key]["route"] != want:
            raise RuntimeError(f"{env} took the route {recs[key]['route']}")
        _same_trees(ref, bsts[key],
                    f"{label} vs {ref._inner.grow.route.describe()}")
    return bsts, recs, parity


def counted_training_kernels():
    """The training kernels a main path counts (``train_main_path``)."""
    from lightgbm_tpu_torch.ops.apply_find import apply_find, apply_find_pool
    from lightgbm_tpu_torch.ops.fused_split import (fused_split,
                                                    fused_split_p2)
    from lightgbm_tpu_torch.ops.hist_kernel2 import (
        build_histogram_comb, build_histogram_comb_p2, build_histogram_rows,
        build_histogram_rows_dp)
    from lightgbm_tpu_torch.ops.linear_kernel import linear_moments
    from lightgbm_tpu_torch.ops.partition_kernel import (
        copyback, copyback_p2, partition_3ph, partition_scan,
        partition_scan_p2)
    from lightgbm_tpu_torch.ops.stream_grad import (
        stream_init, stream_init_p2, stream_refresh, stream_refresh_p2,
        stream_refresh_plain, stream_refresh_plain_p2)
    return (stream_init, stream_refresh, stream_refresh_plain,
            build_histogram_comb, partition_scan, partition_3ph,
            fused_split, copyback, apply_find_pool, apply_find,
            build_histogram_rows, stream_init_p2, stream_refresh_p2,
            build_histogram_comb_p2, fused_split_p2, copyback_p2,
            partition_scan_p2, stream_refresh_plain_p2,
            build_histogram_rows_dp, linear_moments)


def binary_holdout(bst) -> dict:
    """The binary main paths' holdout gate: an AUC better than chance."""
    auc = bst.best_score["valid_0"]["auc"]
    if not (0.5 < auc <= 1.0):
        raise RuntimeError(f"holdout AUC {auc} is not better than chance")
    return {"holdout_auc": auc}


def train_main_path(gpu: str, ds, valid, x, env: dict, iters: int,
                    label: str, params: dict = TRAIN_PARAMS,
                    n_features: int = N_FEATURES, holdout=binary_holdout,
                    callbacks=(), feval=None):
    """The training main path on the route ``env`` selects, counted and
    timed by stage, its booster served through serve_traverse (the
    served raw scores of every class against the training scores), its
    holdout metrics gated by ``holdout(booster) -> dict``; ``callbacks``
    run after each iteration too, ``feval`` is ``train``'s.  Returns
    (booster, record)."""
    import torch

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops.grow import StageTimer
    from lightgbm_tpu_torch.ops.serve_kernel import serve_traverse
    counted = counted_training_kernels() + (serve_traverse,)
    its = []

    def _tick(env_):
        torch.cuda.synchronize()
        its.append(time.perf_counter())
    _tick.order = 40
    timer = StageTimer(enabled=True)
    with route_env(env):
        torch.cuda.synchronize()
        for fn in counted:
            fn.launches = 0
        t_start = time.perf_counter()
        bst = lgt.train(params, ds, num_boost_round=iters,
                        valid_sets=[valid], callbacks=[_tick, *callbacks],
                        feval=feval, device="cuda", timer=timer)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t_start
        raw = bst.predict(x, raw_score=True)
        launches = {fn.__name__: fn.launches for fn in counted}
    models = bst._models
    splits = sum(t.num_leaves - 1 for t in models)
    route = bst._inner.grow.route
    expect = expected_launches(route, len(models), splits)
    for name, want in expect.items():
        if launches[name] != want:
            raise RuntimeError(f"the {label} launched {name} "
                               f"{launches[name]} times, expected {want}")
    if launches["serve_traverse"] <= 0:
        raise RuntimeError("predict on the trained booster did not launch "
                           "serve_traverse")
    k = bst._inner.num_tree_per_iteration
    n = x.shape[0]
    train_score = bst._inner.scores.cpu().numpy().astype(np.float64)
    if bst._inner.average_output:
        # RF: the scores hold the sum of the trees' outputs
        train_score /= bst._inner.iter_
    if (raw.shape != ((n,) if k == 1 else (n, k))
            or not np.all(np.isfinite(raw))):
        raise RuntimeError("predict on the trained booster gave non-finite "
                           "or misshapen scores")
    raw = raw.reshape(n, k).T
    tol = score_tolerance(train_score, len(models) // k)
    err = np.abs(raw - train_score)
    if not np.all(err <= tol):
        raise RuntimeError(f"served scores differ from the training scores "
                           f"beyond 64 ulps per tree (max {err.max()})")
    held = holdout(bst)
    if route.stream:
        rows = bst._inner.grow.rows.fields()
        if not torch.equal(rows.score, bst._inner.train_score[
                rows.rid.long()]):
            raise RuntimeError("the scores the rows carry differ from the "
                               "booster's training scores")
    per_it = np.diff([t_start] + its)
    calls = timer.calls_ms()
    stages = {k: sum(v) / len(models) for k, v in calls.items()}
    # the stages run once a tree: tree 0 (the kernels' first calls, their
    # builds included) apart from the mean of the others
    once = {k: v for k, v in calls.items() if len(v) == len(models) > 1}
    rec = {"case": label, "route": route.describe(), "rows": x.shape[0],
           "features": n_features, "leaves": TRAIN_LEAVES,
           "max_bin": params["max_bin"],
           "padded_bins": bst._inner.dd.padded_bins,
           "iterations": len(models), "train_s": train_s,
           "s_per_iter_first": float(per_it[0]),
           "s_per_iter_rest_mean": float(per_it[1:].mean()),
           "s_per_iter": [float(v) for v in per_it],
           "stage_ms_per_tree": stages,
           "stage_ms_tree0": {k: v[0] for k, v in once.items()},
           "stage_ms_per_tree_after_first": {
               k: float(np.mean(v[1:])) for k, v in once.items()},
           **held,
           "splits": splits, "host_reads": bst._inner.grow.host_reads,
           "launches": launches,
           "predict_max_abs_err": float(err.max()), "gpu": gpu}
    print(f"training {label} " + json.dumps(rec), flush=True)
    return bst, rec


def train_phases(gpu: str) -> tuple:
    """Slices 2 to 7: the training kernels against their plain versions
    at the main paths' shapes, training parity card vs CPU on seven
    routes, the training main path on the default route (1M x 28, 255
    leaves, 10 iterations) counted, timed by stage and served, slice 2's
    route beside it (3 iterations, its trees held against the default
    route's first 3), the row-order route at max_bin=1023 (10
    iterations) and under LGBM_TPU_PHYS=0 (3), the 3ph route (3),
    LGBM_TPU_POOL_TAIL=0 (2), the pack=2 route (10, its trees held
    against the default route's), the pack=2 and pack=1 unfused routes
    (3 each, against the default route's) and slice 2's route at pack=2
    (3, against slice 2's route's), and one profiled iteration of each
    route but LGBM_TPU_POOL_TAIL=0 and slice 2's at pack=2, then the
    monotone phase (:func:`mono_phases`) on the same datasets.  Returns
    the seventeen training kernels' records and the tail's two
    constrained instantiations', and the main path's datasets and
    holdout AUC for :func:`sampling_phases`."""
    import lightgbm_tpu_torch as lgt

    x_all, y_all = make_higgs_like(TRAIN_ROWS + HOLDOUT_ROWS, N_FEATURES,
                                   seed=0)
    x, y = x_all[:TRAIN_ROWS], y_all[:TRAIN_ROWS]
    xv, yv = x_all[TRAIN_ROWS:], y_all[TRAIN_ROWS:]
    t0 = time.perf_counter()
    ds = lgt.Dataset(x, label=y, params={"max_bin": 255}).construct()
    valid = lgt.Dataset(xv, label=yv, reference=ds).construct()
    t1 = time.perf_counter()
    ds_wide = lgt.Dataset(x, label=y, params={"max_bin": 1023}).construct()
    valid_wide = lgt.Dataset(xv, label=yv, reference=ds_wide).construct()
    print(f"binned {TRAIN_ROWS} + {HOLDOUT_ROWS} rows x {N_FEATURES} in "
          f"{t1 - t0:.2f} s at max_bin=255 and "
          f"{time.perf_counter() - t1:.2f} s at max_bin=1023 (host)",
          flush=True)

    lap("training/binning")
    recs = training_kernels(gpu, ds)
    lap("training/kernels")
    recs.append(hist_rows_kernels(gpu, ds, ds_wide))
    lap("training/hist_rows kernels")
    recs += pack2_kernels(gpu, ds)
    lap("training/pack2 kernels")
    refresh_t = refresh_times(gpu)
    lap("training/refresh times")
    for r in recs:
        if r["name"] in ("stream_refresh", "stream_refresh_p2"):
            d = refresh_t["pack2" if r["name"].endswith("p2") else "pack1"]
            for k, v in d.items():
                if isinstance(v, tuple):
                    r[f"{k}_ms"], r[f"{k}_graph_ms"] = v
                else:
                    r[f"{k}_ms"] = v
        if r["name"] in ("stream_refresh_plain", "stream_refresh_plain_p2"):
            d = refresh_t["pack2" if r["name"].endswith("p2") else "pack1"]
            r["l2_flushed_ms"] = d["plain_refresh_l2_flushed"]
            r["l2_clean_ms"] = d["plain_refresh_l2_clean"]
        if r["name"] in ("stream_init", "stream_init_p2"):
            d = refresh_t["pack2" if r["name"].endswith("p2") else "pack1"]
            r["eager_ms"], r["graph_ms"] = d["init"]
            r["l2_flushed_ms"] = d["init_l2_flushed"]
            r["l2_clean_ms"] = d["init_l2_clean"]
    parity = train_parity(gpu, {}, PARITY_TREES, "default route")
    parity2 = train_parity(gpu, SLICE2_ROUTE, SLICE2_PARITY_TREES,
                           "slice 2 route")
    lap("training/parity default, slice 2")

    bst, main = train_main_path(gpu, ds, valid, x, {}, TRAIN_ITERS,
                                "main path, default route")
    bst2, main2 = train_main_path(gpu, ds, valid, x, SLICE2_ROUTE,
                                  SLICE2_ITERS, "slice 2 route")
    routes = compare_trees(bst._models[:SLICE2_ITERS], bst2._models)
    routes.update(case=f"default route vs slice 2 route, first "
                  f"{SLICE2_ITERS} trees at {TRAIN_ROWS} rows",
                  leaves_bitwise=leaves_bitwise(bst._models[:SLICE2_ITERS],
                                                bst2._models))
    print("parity routes " + json.dumps(routes), flush=True)
    if not routes["ok"]:
        raise RuntimeError(f"the default route's trees differ from slice "
                           f"2's route's: {routes}")
    lap("training/main path, slice 2 route")
    bst3, main3, bst4, off, parity3 = row_order_phases(
        gpu, ds, valid, ds_wide, valid_wide, x, bst)
    lap("training/row-order")
    tail_medians = [
        median_tail_parity(ds, {}, TRAIN_PARAMS, "default route"),
        median_tail_parity(ds_wide, {}, WIDE_PARAMS,
                           "row-order route, max_bin=1023")]
    tail_times = apply_find_times(gpu)
    lap("training/tail medians and times")
    rows_times = hist_rows_times(gpu, ds_wide, bst3._models)
    fused_times = fused_split_times(gpu, bst._models)
    lap("training/hist_rows and fused_split times")
    bst5, main5, pool5, parity5 = part_3ph_phases(gpu, ds, valid, x, bst)
    bst6, main6, parity6 = pack2_phases(gpu, ds, valid, x, bst)
    copy_times = copyback_p2_times(gpu, bst6._models)
    bsts7, mains7, parity7 = pack2_unfused_phases(gpu, ds, valid, x, bst,
                                                  bst2)
    lap("training/3ph, pack=2, unfused")
    part_times = partition_phases(gpu, {
        "unfused": bsts7["pack1_unfused"]._models,
        "pack2_unfused": bsts7["pack2_unfused"]._models,
        "3ph": bst5._models})
    lap("training/partition times")
    comb_cases, comb_children = hist_comb_cases(bsts7["pack1_unfused"]._models)
    comb_times = hist_comb_times(gpu, N_FEATURES, comb_cases)
    lap("training/hist_comb times")
    for run in (main, main6, main3):
        want = MAIN_PATH_AUC[run["max_bin"]]
        if run["holdout_auc"] != want:
            raise RuntimeError(f"the {run['case']} gave holdout AUC "
                               f"{run['holdout_auc']}, not the {want} of "
                               "the trees the earlier slices grew")
    # one more tree of each under the profiler, after every check
    with route_env({}):
        print("profiled iteration, default route "
              + json.dumps(profile_iteration(bst, gpu)), flush=True)
    with route_env(SLICE2_ROUTE):
        print("profiled iteration, slice 2 route "
              + json.dumps(profile_iteration(bst2, gpu)), flush=True)
    with route_env({}):
        print("profiled iteration, row-order route, max_bin=1023 "
              + json.dumps(profile_iteration(bst3, gpu)), flush=True)
    with route_env(PHYS_OFF):
        print("profiled iteration, LGBM_TPU_PHYS=0, max_bin=255 "
              + json.dumps(profile_iteration(bst4, gpu)), flush=True)
    with route_env(PART_3PH):
        print("profiled iteration, 3ph route "
              + json.dumps(profile_iteration(bst5, gpu)), flush=True)
    with route_env(PACK2):
        print("profiled iteration, pack=2 route "
              + json.dumps(profile_iteration(bst6, gpu)), flush=True)
    for key, env in (("pack2_unfused", PACK2_UNFUSED),
                     ("pack1_unfused", FUSED_OFF)):
        with route_env(env):
            print(f"profiled iteration, {key.replace('_', ' ')} route "
                  + json.dumps(profile_iteration(bsts7[key], gpu)),
                  flush=True)
    lap("training/profiled iterations")

    names = {"hist_comb": "build_histogram_comb",
             "apply_find": "apply_find_pool",
             "hist_rows": "build_histogram_rows",
             "hist_comb_p2": "build_histogram_comb_p2"}
    for r in recs:
        key = names.get(r["name"], r["name"])
        for run, where in ((main, None), (main2, "slice 2 route"),
                           (main3, "row-order route"), (main5, "3ph route"),
                           (main6, "pack=2 route"),
                           (mains7["pack2_unfused"], "pack=2 unfused route"),
                           (mains7["pack2_slice2"], "pack=2 slice 2 route")):
            if run["launches"][key] > 0:
                r["launches"] = run["launches"][key]
                if where:
                    r["launched_on"] = where
                break
        if r["launches"] <= 0:
            raise RuntimeError(f"{r['name']} was launched on no main path")
    by_name = {r["name"]: r for r in recs}
    by_name["hist_rows"]["phys_off_launches"] = \
        off["launches"]["build_histogram_rows"]
    recs[0]["train_parity"] = parity["ok"] and parity2["ok"]
    by_name["hist_rows"]["train_parity_bitwise"] = parity3["ok"]
    by_name["hist_rows"]["child_sizes"] = rows_times["child_sizes"]
    by_name["hist_rows"]["times"] = rows_times["times"]
    by_name["copyback_p2"]["times"] = copy_times["times"]
    for name in ("hist_comb", "hist_comb_p2"):
        by_name[name]["child_sizes"] = comb_children
        by_name[name]["cases"] = comb_cases
        by_name[name]["times"] = comb_times
    for name in ("fused_split", "fused_split_p2"):
        by_name[name]["segments"] = fused_times["segments"]
        by_name[name]["times"] = fused_times["times"]
    by_name["apply_find"]["plain_entry_launches"] = \
        pool5["launches"]["apply_find"]
    by_name["apply_find"]["plain_entry_launched_on"] = "LGBM_TPU_POOL_TAIL=0"
    by_name["apply_find"]["row_order_launches"] = \
        main3["launches"]["apply_find_pool"]
    # the times at each shape; the geometry stays on the times line (one
    # launch a call whatever the cluster)
    by_name["apply_find"]["times"] = {
        shape: {k: v for k, v in rec.items() if k.startswith("apply_find")}
        for shape, rec in tail_times.items()}
    by_name["apply_find"]["parity_cases"] += [r["case"]
                                              for r in tail_medians]
    by_name["partition_3ph"]["train_parity_bitwise"] = parity5["ok"]
    for name, kernel in (("partition_scan", "scan"),
                         ("partition_scan_p2", "scan_p2"),
                         ("partition_3ph", "3ph")):
        by_name[name]["segments"] = part_times["segments"]
        by_name[name]["times"] = [t for t in part_times["times"]
                                  if t["kernel"] == kernel]
        by_name[name]["edge_cases_bitwise"] = part_times["edge_cases"]
    by_name["fused_split_p2"]["train_parity_bitwise"] = parity6["ok"]
    for name in ("partition_scan_p2", "stream_refresh_plain_p2"):
        by_name[name]["train_parity_bitwise"] = all(
            r["ok"] for r in parity7.values())
    recs += mono_phases(gpu, ds, valid, ds_wide, valid_wide, x, y, xv, main,
                        tail_times)
    lap("training/monotone")
    higgs = {"ds": ds, "valid": valid, "x": x, "xv": xv, "yv": yv,
             "auc": main["holdout_auc"], "bst": bst}
    return recs, higgs


# -- the static analyzer and its fixture kernels (slice 8) -------------------
FIXTURES_DIR = "lightgbm_tpu/analysis/fixtures"
FIXTURE_REPS = 20
# above the 48 KB default: the legal accumulator that needs the opt-in
SMEM_ACC_OPTIN = 64 * 1024


def fixture_cases(seed: int = 0) -> list:
    """The fixture kernels at their legal geometries
    (``analysis/entries.py``) on seeded CPU tensors: [(kernel, label,
    wrapper, plain version, args, kwargs)]."""
    import torch

    from lightgbm_tpu_torch.analysis.entries import (FIXTURE_STAGE_LEGAL,
                                                     SMEM_ACC_LEGAL)
    from lightgbm_tpu_torch.ops import analysis_fixtures as af
    rng = np.random.default_rng(seed)
    cases = []
    for name, dtype, classes, rows, cols, copied, _ in FIXTURE_STAGE_LEGAL:
        shape = (classes, rows, cols) if classes > 1 else (rows, cols)
        x = (rng.integers(-2**31, 2**31 - 1, size=shape, dtype=np.int32)
             if dtype == "int32" else rng.normal(size=shape).astype(
                 np.float32))
        cases.append(("fixture_stage_copy", name, af.stage_copy,
                      af.stage_copy_ref, (torch.from_numpy(x), copied), {}))
    x = torch.from_numpy(rng.normal(size=(32, 128)).astype(np.float32))
    for acc in (SMEM_ACC_LEGAL, SMEM_ACC_OPTIN):
        cases.append(("fixture_smem_acc", f"fixture_vmem acc={acc}",
                      af.smem_acc, af.smem_acc_ref, (x,),
                      {"acc_bytes": acc}))
    xh = torch.from_numpy(rng.normal(size=(8, 128)).astype(np.float32))
    cases.append(("fixture_scale_bias", "fixture_host", af.scale_bias,
                  af.scale_bias_ref, (xh, xh[0, :1].clone(),
                                      xh.sum().reshape(1)), {}))
    return cases


def _on(args, dev):
    return tuple(a.to(dev) if hasattr(a, "to") else a for a in args)


def _bits(t):
    import torch
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def analysis_kernels(gpu: str) -> list:
    """Slice 8: the three fixture kernels.  Their path, each legal
    geometry once through its wrapper, runs with the counts zeroed just
    before and read just after; each result is held bitwise against its
    plain version on the CPU inputs; the seeded geometries are refused
    before any launch; each kernel is timed over 20 launches beside its
    plain version and one PyTorch call.  Returns the three records."""
    import torch

    from lightgbm_tpu_torch.analysis import fixtures as fx
    from lightgbm_tpu_torch.ops import analysis_fixtures as af
    from lightgbm_tpu_torch.utils.log import LightGBMError
    dev = torch.device("cuda")
    cases = fixture_cases()
    wrappers = {"fixture_stage_copy": af.stage_copy,
                "fixture_smem_acc": af.smem_acc,
                "fixture_scale_bias": af.scale_bias}
    for w in wrappers.values():
        w.launches = 0
    outs = [fn(*_on(args, dev), **kw) for _, _, fn, _, args, kw in cases]
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    parity = []
    for (kernel, label, _, plain, args, kw), out in zip(cases, outs):
        ok = torch.equal(_bits(out.cpu()), _bits(plain(*args, **kw)))
        parity.append({"kernel": kernel, "case": label, "bitwise": ok})
        if not ok:
            raise RuntimeError(f"{kernel} differs from its plain version at "
                               f"{label}")
    # the seeded geometries: refused before a launch, counts unchanged
    refused = []
    for name, (_, dtype, classes, rows, cols, copied, _) in \
            fx.STAGE_SEEDED.items():
        shape = (classes, rows, cols) if classes > 1 else (rows, cols)
        t = torch.zeros(shape, dtype=getattr(torch, dtype), device=dev)
        try:
            af.stage_copy(t, copied)
        except LightGBMError:
            refused.append(name)
    try:
        af.smem_acc(outs[4], acc_bytes=fx.SMEM_ACC_SEEDED)
    except LightGBMError:
        refused.append("bad_vmem")
    torch.cuda.synchronize()
    if (sorted(refused) != sorted([*fx.STAGE_SEEDED, "bad_vmem"])
            or {k: w.launches for k, w in wrappers.items()} != launches):
        raise RuntimeError(f"a seeded geometry reached a launch: refused "
                           f"only {refused}")
    print("analysis fixture kernels " + json.dumps(
        {"launches": launches, "parity": parity, "seeded_refused": refused})
        + f" [{gpu}]", flush=True)

    by = {c[1]: c for c in cases}
    recs = []
    # (kernel, timed case, replaces, bytes, operations, library call)
    x5, rows5 = _on(by["fixture_mc_batch"][4], dev)
    out5 = torch.zeros_like(x5)
    xv = _on(by["fixture_vmem acc=8192"][4], dev)[0]
    ov = torch.empty_like(xv)
    xh, sc, bi = _on(by["fixture_host"][4], dev)
    specs = [
        ("fixture_stage_copy", "fixture_mc_batch",
         f"{FIXTURES_DIR}/__init__.py:77, :280, :326, :393",
         2 * x5[..., :rows5, :].numel() * 4, 0,
         lambda: out5.narrow(-2, 0, rows5).copy_(x5.narrow(-2, 0, rows5)),
         "Tensor.copy_ of the rows"),
        ("fixture_smem_acc", "fixture_vmem acc=8192",
         f"{FIXTURES_DIR}/__init__.py:107", 2 * xv.numel() * 4, 0,
         lambda: ov.copy_(xv), "Tensor.copy_"),
        ("fixture_scale_bias", "fixture_host",
         f"{FIXTURES_DIR}/bad_host_ast.py:21", 2 * xh.numel() * 4 + 8,
         2 * xh.numel(), lambda: torch.addcmul(bi, xh, sc),
         "torch.addcmul(bias, x, scale)"),
    ]
    for kernel, label, replaces, n_bytes, n_ops, lib, lib_call in specs:
        _, _, fn, plain, args, kw = by[label]
        dargs = _on(args, dev)
        ms = _time_ms(lambda: fn(*dargs, **kw), FIXTURE_REPS)
        plain_ms = _time_ms(lambda: plain(*dargs, **kw), FIXTURE_REPS)
        recs.append(_kernel_record(
            kernel, "lightgbm_tpu_torch/csrc/analysis_fixtures.cu",
            replaces, launches[kernel], 0.0, ms, plain_ms, n_bytes, n_ops,
            gpu, library_ms=_time_ms(lib, FIXTURE_REPS),
            library_call=lib_call, timed_case=label,
            parity_cases=[p["case"] for p in parity
                          if p["kernel"] == kernel]))
    return recs


def same_resources(a: dict, b: dict) -> bool:
    """Whether two resource reports hold the same sources, content
    hashes and kernel resources (spills compared when both reports know
    them: ``cuobjdump`` does not count them)."""
    from dataclasses import replace
    known = all(u.spills is not None for rep in (a, b)
                for su in rep.values() for u in su.kernels.values())

    def key(rep):
        return {n: (su.digest, {k: u if known else replace(
            u, spill_stores=None, spill_loads=None)
            for k, u in su.kernels.items()}) for n, su in rep.items()}
    return key(a) == key(b)


def analysis_phase(gpu: str) -> dict:
    """Slice 8: the static analyzer in-process under --strict with the
    resources read fresh from the built libraries (``cuobjdump
    -res-usage``, spills from this build's ``ptxas -v``, names from
    ``cu++filt``): the report's two sources agree on every kernel's
    static shared memory, the clean run has no finding (every smem
    formula equal to its library export) and each fixture gives exactly
    its codes.  Writes the fresh report to ``lightgbm_tpu_torch/build/``
    (for regenerating the checked-in one) and records, without raising,
    whether the checked-in ``resources_sm90a.txt`` equals it: ``main``
    fails on a stale report only after every other phase has run.
    Prints each registered kernel's registers, static and dynamic shared
    memory, stack and spills.  Raises on any other mismatch."""
    from lightgbm_tpu_torch.analysis import fixtures as fx
    from lightgbm_tpu_torch.analysis import registry
    from lightgbm_tpu_torch.analysis import resources as res
    from lightgbm_tpu_torch.analysis.run import PASS_NAMES, run_analysis
    from lightgbm_tpu_torch.ops import _build
    t0 = time.perf_counter()
    fresh = res.read_built()
    with open(_build.BUILD_DIR / "resources_sm90a.txt", "w") as fh:
        fh.write(res.format_report(fresh, f"gpu: {gpu}"))
    for name, log in _build.BUILD_LOGS.items():
        for sym, u in res.by_symbol(res.parse_ptxas(log)).items():
            k = fresh[name].kernels[sym]
            if (u.regs, u.smem, u.stack) != (k.regs, k.smem, k.stack):
                raise RuntimeError(f"ptxas -v and cuobjdump disagree on "
                                   f"{name} {sym}: {u} vs {k}")
    current = same_resources(res.load_report(), fresh)
    clean = run_analysis(strict=True, resources="built")
    failing = clean.failing()
    if failing:
        raise RuntimeError(
            f"analysis on the card: {len(failing)} failing finding(s) "
            f"{[(f.code, f.where) for f in failing][:5]}")
    fast = [p for p in PASS_NAMES if p != "purity"]
    flagged = {}
    for name in sorted(fx.FIXTURES):
        rep = run_analysis(passes=PASS_NAMES if name == "bad_purity"
                           else fast, fixtures=[name], strict=True,
                           resources="built")
        codes = {f.code for f in rep.findings if f.fixture}
        if codes != fx.EXPECTED[name] or any(
                not f.fixture and not f.allowlisted for f in rep.findings):
            raise RuntimeError(f"fixture {name} gave {sorted(codes)}, "
                               f"expected {sorted(fx.EXPECTED[name])}")
        flagged[name] = sorted(codes)
    exports = [e.name for e in registry.collect().values() if e.export]
    for e in registry.collect().values():
        u = fresh[e.source].kernels[e.symbol]
        print(f"kernel resources {e.source} {e.symbol}: regs {u.regs} "
              f"static smem {u.smem} B dynamic smem {e.dyn_smem} B at "
              f"{e.name} stack {u.stack} B spill stores {u.spill_stores} B "
              f"loads {u.spill_loads} B [{gpu}]", flush=True)
    rec = {"strict": True, "resources": "cuobjdump -res-usage of the "
           "built libraries", "entries": len(clean.entries),
           "errors": 0, "allowlisted": sum(f.allowlisted
                                           for f in clean.findings),
           "smem_formulas_checked": exports, "fixtures": flagged,
           "checked_in_report_current": current,
           "seconds": time.perf_counter() - t0, "gpu": gpu}
    print("analysis " + json.dumps(rec), flush=True)
    return rec


# -- slice 9: wide datasets and the launch-cost probes -----------------------
WIDE_FEATURES = 136           # MSLR-WEB30K's width: hist_comb in chunks
WIDE_ITERS = 2
WIDE_PARITY_TREES = 1
WIDE_PARITY_ROWS = 10_000     # the script's time budget
WIDE_ROUTE = "path=stream fused=0 tail=kernel (fused_smem)"
PROBE_ROWS = 1 << 20          # tools/profile_step_cost.py PN = 20
PROBE_REPS = 20               # T11 iterations of 254 timed per mode
STEP_REPS = 30                # tools/profile_step_cost.py REPS
PROBE_SRC = "lightgbm_tpu_torch/csrc/probes.cu"


def probe_states(seed: int = 0) -> dict:
    """Seeded leaf states f32 [255, 20] for T11: the tool's own (zeros,
    [0, 0] = 1), normal values, ties in column 0 and a row near 1e8,
    where (row + 1) - row is not 1."""
    rng = np.random.default_rng(seed)
    tool = np.zeros((255, 20), np.float32)
    tool[0, 0] = 1.0
    normal = rng.normal(size=(255, 20)).astype(np.float32)
    ties = rng.normal(size=(255, 20)).astype(np.float32)
    ties[:, 0] = rng.integers(0, 3, size=255)
    big = rng.normal(size=(255, 20)).astype(np.float32)
    big[37] = 1e8 + rng.integers(0, 64, size=20) * 8
    return {"tool": tool, "normal": normal, "ties": ties, "big": big}


def probe_phases(gpu: str) -> list:
    """Slice 9: the launch-cost probes (TPU rows T11, T10, T9).  Their
    path, the two tools' runs (``lightgbm_tpu_torch.tools``: T11's five
    modes, 254 updates a timed iteration; T10's four variants and T9 at
    n = 2^20, each output held exactly against its plain version on the
    card), runs with the counts zeroed just before and read just after,
    its tables printed; then T11 bitwise its plain version after 254
    eager launches, 254 from C and a graph replay, from each seeded
    state.  Returns the six kernels' records."""
    import torch

    from lightgbm_tpu_torch.ops import probes
    from lightgbm_tpu_torch.tools import profile_pallas_ov as ov
    from lightgbm_tpu_torch.tools import profile_step_cost as sc
    counted = (probes.select_update, probes.step_cost, probes.stream_tiles)

    def log(tag):
        return lambda line: print(f"{tag} {line} [{gpu}]", flush=True)
    torch.cuda.synchronize()
    for fn in counted:
        fn.launches = 0
    t11 = ov.run("cuda", reps=PROBE_REPS, log=log("T11"))
    t10 = sc.run("cuda", n=PROBE_ROWS, reps=STEP_REPS, log=log("T10/T9"))
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counted}
    if launches["select_update"] != t11["expected_launches"] or \
            [launches["step_cost"], launches["stream_tiles"]] != \
            [t10["launches"]["step_cost"], t10["launches"]["stream_tiles"]]:
        raise RuntimeError(f"the probes' launches {launches} differ from "
                           f"the tools' counts")
    checks = {}
    for name, st in probe_states().items():
        checks[name] = ov.check(torch.from_numpy(st).cuda())
        if not all(checks[name][m] for m in ("eager", "c_loop", "graph")):
            raise RuntimeError(f"select_update differs from its plain "
                               f"version from the {name} state: "
                               f"{checks[name]}")
    print("parity probes " + json.dumps(
        {"launches": launches, "select_update": checks,
         "step_cost": [{k: r[k] for k in ("variant", "n", "out")}
                       for r in t10["rows"]]}) + f" [{gpu}]", flush=True)
    print("probes T11 " + json.dumps(t11), flush=True)
    print("probes T10/T9 " + json.dumps(t10), flush=True)

    modes = {r["mode"]: r["ms"] / ov.N for r in t11["rows"]}
    lf = torch.from_numpy(probe_states()["normal"]).cuda()
    recs = [_kernel_record(
        "select_update", PROBE_SRC, "tools/profile_pallas_ov.py:40",
        launches["select_update"], 0.0,
        modes["select_update, Python wrapper"],
        _time_ms(lambda: probes.select_update_ref(lf), 50),
        2 * lf.numel() * 4 + probes.SEL * 4, 3 * lf.numel(), gpu,
        library_ms=modes["PyTorch ops (xla_loop), eager"],
        library_call="argmax + index_select + index_copy_ (xla_loop's "
                     "body in PyTorch ops), a call",
        c_loop_ms=modes["select_update_loop, one call from C"],
        graph_ms=modes["CUDA graph of the wrapper calls, replayed"],
        library_graph_ms=modes["PyTorch ops (xla_loop), CUDA graph"],
        timed_case="254 updates of the tool's state, median of "
                   f"{PROBE_REPS}, per launch",
        parity_cases=sorted(checks))]
    rows = sc.make_rows(PROBE_ROWS, "cuda")
    sel = torch.tensor([0, PROBE_ROWS], dtype=torch.int32, device="cuda")
    nb = PROBE_ROWS // probes.TILE_ROWS
    # the one PyTorch call that gives each output (None: no one call)
    one_call = {"empty": ("sel[:1].clone()", lambda: sel[:1].clone()),
                "dma_nw": ("torch.add(sel[:1], nb)",
                           lambda: torch.add(sel[:1], nb)),
                "waits": ("torch.add(sel[:1], nb)",
                          lambda: torch.add(sel[:1], nb))}
    at_n = {r["variant"]: r for r in t10["rows"] if r["n"] == PROBE_ROWS}
    per_var = {}
    for r in t10["rows"]:
        per_var[r["variant"]] = per_var.get(r["variant"], 0) + r["launches"]
    for var in sc.VARIANTS:
        r = at_n[var]
        dma = var in ("dma_nw", "dma_bs")
        name = "stream_tiles" if var == "dma_bs" else f"step_cost_{var}"
        ref = sc.plain(var)
        # bytes: the output, sel, and for the copy variants the rows
        # they copy (the TPU kernel's work, not what the output needs);
        # operations: a few integer ones a block
        out_bytes = 4 + (nb * 4 if var == "dma_bs" else 8)
        n_bytes = out_bytes + (rows.numel() * 4 if dma else 0)
        call = one_call.get(var)
        extra = {}
        if dma:
            extra = dict(
                bound_note="copied bytes: the rows the probe copies, not "
                           "the bytes its output depends on",
                output_bound_ms=out_bytes / PEAK_BYTES_S * 1e3,
                same_bytes_ms=t10["torch_sum_ms"],
                same_bytes_call="torch.sum(rows): the same bytes, not the "
                                "same function")
        recs.append(_kernel_record(
            name, PROBE_SRC, "tools/profile_step_cost.py:"
            + ("52" if var == "dma_bs" else "86"),
            per_var[var], 0.0, r["ms"],
            _time_ms(lambda: ref(rows), 10), n_bytes, 4 * r["blocks"], gpu,
            library_ms=_time_ms(call[1], 50) if call else None,
            library_call=call[0] if call else None,
            graph_ms=r["graph_ms"], blocks=r["blocks"],
            us_per_block=r["us_per_block"], out=r["out"],
            timed_case=f"n = {PROBE_ROWS}, {STEP_REPS} launches in a row",
            **extra))
    one = next(r for r in t10["rows"] if r["variant"] == "empty"
               and r["blocks"] == 1)
    recs[1].update(one_block_ms=one["ms"], one_block_graph_ms=one["graph_ms"])
    for r in recs:
        if r["launches"] <= 0:
            raise RuntimeError(f"{r['name']} was not launched on its path")
    return recs


# -- slice 10: the partition-bisection probes of tools/profile_legacy.py -------
LEGACY_SRC = "lightgbm_tpu_torch/csrc/legacy_probes.cu"
LEGACY_REPS = 10              # calls a timing and chained calls a graph
# scenario -> (n, variants); part2 at 2^21 rather than 2^22 for time
LEGACY_RUNS = (("part2", 1 << 21, None), ("part3", None, None),
               ("part4", None, None), ("part5", None, None),
               ("part6", None, None),
               ("part7", None, ("nosmem", "deadsel", "scratchthr", "smem",
                                "noalias", "hbmsel")),
               ("part8", None, None), ("pool", None, None),
               ("pool2", None, None), ("hbm_alias", None, None))
# (TPU row, record name, scenario, the variants it covers, the timed one,
# file:line of the pallas_call)
LEGACY_ROWS = (
    ("T1", "block_copy", "part3", ("copy", "copy3"), "copy", 150),
    ("T2", "partition_dense", "part3", ("scan", "scan2", "full"), "scan2",
     172),
    ("T3", "compact_part4", "part4", None, "base", 369),
    ("T4", "compact_part5", "part5", None, "pred", 467),
    ("T5", "compact_prefetch", "part6", ("prefetch",), "prefetch", 562),
    ("T6", "compact_part6", "part6", ("nosmem", "smem", "smemuse"), "nosmem",
     577),
    ("T7", "compact_part7", "part7", None, "nosmem", 686),
    ("T8", "hbm_alias_step", "hbm_alias", None, None, 898))
LEGACY_ADVERSARIAL_N = 1 << 19
# T8's overlapping windows: dst > src and dst < src within 1024 rows
ALIAS_OVERLAPS = ((100, 612), (612, 100), (3, 1026), (64512, 64000))


def legacy_adversarial(gpu: str) -> dict:
    """The in-place compaction, nsplit, noalias and the three-phase
    partition on the adversarial inputs of ``profile_legacy`` at 2^19
    rows, and the script's descriptor moved to an odd s0 and cnt; T8 on
    overlapping windows: each bitwise its plain version on the card."""
    from lightgbm_tpu_torch.tools import profile_legacy as tl
    n = LEGACY_ADVERSARIAL_N
    out = {}
    cases = (("compact", "nosmem"), ("compact", "pred"),
             ("compact", "nsplit"), ("compact", "noalias"),
             ("compact", "grid2"), ("partition_dense", 3))
    for kind in tl.ADVERSARIAL:
        rows = tl.adversarial_rows(kind, n, n + 2 * tl.R, "cuda")
        for sel in (tl.script_sel(n), [37, n - 1001] + tl.script_sel(n)[2:]):
            inp = tl.Inputs(rows, sel, n, scratch_fill=-1.0)
            for kernel, arg in cases:
                rec = tl.check(kernel, arg, inp)
                out[f"{kind} s0={sel[0]} {kernel}<{arg}>"] = rec["ok"]
            del inp
    for src, dst in ALIAS_OVERLAPS:
        out[f"hbm_alias {src}->{dst}"] = tl.alias_check([(src, dst)],
                                                          "cuda")
    bad = [k for k, ok in out.items() if not ok]
    print("parity legacy adversarial " + json.dumps(
        {"cases": len(out), "failed": bad}) + f" [{gpu}]", flush=True)
    if bad:
        raise RuntimeError(f"legacy probes differ from their plain versions "
                           f"on {bad}")
    return out


def legacy_phases(gpu: str) -> list:
    """Slice 10: the partition-bisection probes (TPU rows T1-T8).  Their
    path, every scenario of ``lightgbm_tpu_torch.tools.profile_legacy``
    at its default shape (``part2`` at 2^21 rows, ``part7`` with
    ``noalias`` and ``hbmsel``), runs with the counts zeroed just before
    and read just after, each kernel output held bitwise against its
    plain version on the card before it is timed; then the adversarial
    inputs (not counted).  Returns one record per TPU row."""
    import torch

    from lightgbm_tpu_torch.ops import legacy_probes as lp
    from lightgbm_tpu_torch.tools import profile_legacy as tl
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    for fn in lp.COUNTED:
        fn.launches = 0
    runs, expected = {}, dict.fromkeys(tl.KERNELS, 0)
    for scenario, n, variants in LEGACY_RUNS:
        def log(line, tag=scenario):
            print(f"legacy {tag} {line} [{gpu}]", flush=True)
        runs[scenario] = tl.run(scenario, "cuda", n=n, reps=LEGACY_REPS,
                                variants=variants, log=log)
        for k, v in runs[scenario]["expected_launches"].items():
            expected[k] += v
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in lp.COUNTED}
    if launches != expected:
        raise RuntimeError(f"the legacy probes counted {launches}, expected "
                           f"{expected}")
    for scenario, res in runs.items():
        print(f"legacy {scenario} " + json.dumps(res), flush=True)
    adversarial = legacy_adversarial(gpu)

    recs = []
    for row, name, scenario, covers, timed, line in LEGACY_ROWS:
        res = runs[scenario]
        if scenario == "hbm_alias":
            r = res["rows"][0]
            comb = torch.from_numpy(tl.alias_matrix()).cuda()
            plain_ms = _time_ms(lambda: lp.hbm_alias_step_ref(comb, 0, 0),
                                20)
            lib_ms = _time_ms(lambda: torch.add(
                comb[:lp.ALIAS_ROWS], 1.0,
                out=comb[2 * lp.ALIAS_ROWS:3 * lp.ALIAS_ROWS]), 20)
            recs.append(_kernel_record(
                name, LEGACY_SRC, f"tools/profile_legacy.py:{line}",
                res["launches"]["hbm_alias_step"], 0.0, r["ms"], plain_ms,
                r["bound_bytes"], lp.ALIAS_ROWS * lp.C, gpu,
                library_ms=lib_ms,
                library_call="torch.add(comb[0:1024], 1, out=comb[2048:"
                             "3072]), windows apart", tpu_row=row,
                graph_ms=r.get("graph_ms"), single_ok=r["single_ok"],
                chain_ok=r["chain_ok"], overlaps_ok=all(
                    v for k, v in adversarial.items()
                    if k.startswith("hbm_alias"))))
            continue
        rows = [r for r in res["rows"]
                if covers is None or r["variant"] in covers]
        t = next(r for r in rows if r["variant"] == timed)
        n_alloc = tl.n_alloc_of(scenario, timed, t["n"])
        inp = tl.Inputs(tl.make_rows(n_alloc, "cuda"), tl.script_sel(t["n"]),
                        t["n"])
        plain_ms = _time_ms(lambda: tl.apply(t["kernel"], t["arg"], inp,
                                             plain=True), 3)
        lib_ms, lib_call = None, None
        if t["kernel"] == "block_copy":
            m = t["n"]
            lib_ms = _time_ms(lambda: inp.scratch[:m].copy_(inp.rows[:m]),
                              20)
            lib_call = "Tensor.copy_ of the first n rows"
        del inp
        recs.append(_kernel_record(
            name, LEGACY_SRC, f"tools/profile_legacy.py:{line}",
            sum(r["launches"] for r in rows), 0.0, t["ms"], plain_ms,
            t["bound_bytes"], t["n_alloc"], gpu, library_ms=lib_ms,
            library_call=lib_call, tpu_row=row, graph_ms=t.get("graph_ms"),
            timed_case=f"{scenario} {timed}, n = {t['n']}",
            variants={r["variant"]: {k: r.get(k) for k in (
                "ms", "graph_ms", "bound_ms", "us_per_block", "launches")}
                for r in rows}))
    for r in recs:
        if r["launches"] <= 0:
            raise RuntimeError(f"{r['name']} was not launched on its path")
    print("legacy records " + json.dumps(recs), flush=True)
    print(f"legacy phase took {time.perf_counter() - t0:.1f} s (host clock, "
          f"row generation included) [{gpu}]", flush=True)
    return recs


@contextlib.contextmanager
def forced_comb_chunk(fc: int):
    """``hist_comb`` launched with ``fc`` features a feature-mode block
    inside the block (the wrapper's ``comb_chunk`` replaced)."""
    from lightgbm_tpu_torch.ops import hist_kernel2 as hk
    saved = hk.comb_chunk
    hk.comb_chunk = lambda f, b, slices: fc
    try:
        yield
    finally:
        hk.comb_chunk = saved


# features a block timed beside the wrapper's chunk at the 1M-row root
# (8 at 136 features, 14 at 28): 17 the first chunked rule's, 32 the
# most a feature-mode block stages, 28 one chunk, 7 one feature a warp
CHUNK_SWEEP = {WIDE_FEATURES: (17, 32), 28: (28, 7)}


def comb_chunk_sweep(gpu: str, f: int, rows, k1) -> dict:
    """``hist_comb`` over every row of ``rows`` (B = 256) timed at the
    wrapper's chunk and at each of ``CHUNK_SWEEP[f]`` features a block,
    each bitwise ``k1``, the wrapper's result."""
    import torch

    from lightgbm_tpu_torch.ops.hist_kernel2 import (
        build_histogram_comb, comb_chunk, comb_feature_smem, hist_blocks)
    n = rows.bins.shape[0]
    kw = dict(padded_bins=256, max_rows=n)
    rng = torch.tensor([0, 0, n], dtype=torch.int32, device="cuda")
    shipped = comb_chunk(f, 256, hist_blocks(n))
    out = {}
    for fc in (shipped,) + CHUNK_SWEEP[f]:
        with forced_comb_chunk(fc):
            same = torch_equal(build_histogram_comb(rows, rng, **kw), k1)
            out[fc] = {"smem": comb_feature_smem(fc, 256), "bitwise": same,
                       "ms": _time_ms(
                           lambda: build_histogram_comb(rows, rng, **kw), 20)}
        if not same:
            raise RuntimeError(f"hist_comb at {fc} of {f} features a block "
                               f"differs from the wrapper's chunk of "
                               f"{shipped}")
    print(f"hist_comb chunk sweep, {n} x {f}, B = 256, wrapper's chunk "
          f"{shipped}: " + json.dumps(out) + f" [{gpu}]", flush=True)
    return out


def hist_comb_wide_case(gpu: str) -> dict:
    """hist_comb at 1,000,000 x 136 u8 bins, B = 256 (17 feature
    chunks of 8): bitwise its plain version run on CPU copies, two
    launches bitwise, timed beside the plain version on the card, one
    ``index_add_`` and the byte bound; then the chunk sweeps of
    ``CHUNK_SWEEP`` at 136 and at 28 features."""
    import torch

    from lightgbm_tpu_torch.ops.hist_kernel2 import (
        build_histogram_comb, build_histogram_comb_ref, comb_chunk,
        hist_blocks)
    b = 256
    arrays = random_row_matrix(TRAIN_ROWS, WIDE_FEATURES, 9)
    rows = rows_on(arrays, "cuda")
    rows_cpu = rows_on(arrays, "cpu")
    kw = dict(padded_bins=b, max_rows=TRAIN_ROWS)
    rng = torch.tensor([0, 0, TRAIN_ROWS], dtype=torch.int32, device="cuda")
    k1 = build_histogram_comb(rows, rng, **kw)
    k2 = build_histogram_comb(rows, rng, **kw)
    ref = build_histogram_comb_ref(rows_cpu, rng.cpu(), **kw)
    torch.cuda.synchronize()
    rec = {"case": f"hist_comb root, {TRAIN_ROWS} x {WIDE_FEATURES}, B = {b}",
           "feature_chunk": comb_chunk(WIDE_FEATURES, b,
                                       hist_blocks(TRAIN_ROWS)),
           "bitwise_cpu_plain": torch_equal(k1.cpu(), ref),
           "bitwise_repeat": torch_equal(k1, k2),
           "max_abs_err": float((k1.cpu() - ref).abs().max())}
    if not (rec["bitwise_cpu_plain"] and rec["bitwise_repeat"]):
        raise RuntimeError(f"hist_comb at {WIDE_FEATURES} features differs "
                           f"from its plain version: {rec}")
    rec["ms"] = _time_ms(lambda: build_histogram_comb(rows, rng, **kw), 20)
    rec["plain_ms"] = _time_ms(
        lambda: build_histogram_comb_ref(rows, rng, **kw), 2)
    rec["library_ms"] = library_hist_ms(rows.bins, rows.vals, b)
    rec["bound_bytes"] = (TRAIN_ROWS * (WIDE_FEATURES + 8)
                          + WIDE_FEATURES * b * 8)
    rec["bound_ms"] = rec["bound_bytes"] / PEAK_BYTES_S * 1e3
    rec["chunk_sweep"] = comb_chunk_sweep(gpu, WIDE_FEATURES, rows, k1)
    del rows, rows_cpu, ref
    narrow = rows_on(random_row_matrix(TRAIN_ROWS, 28, 9), "cuda")
    rng28 = torch.tensor([0, 0, TRAIN_ROWS], dtype=torch.int32,
                         device="cuda")
    rec["chunk_sweep_28"] = comb_chunk_sweep(
        gpu, 28, narrow, build_histogram_comb(narrow, rng28, **kw))
    rec["gpu"] = gpu
    print("parity hist_comb wide " + json.dumps(rec), flush=True)
    return rec


def wide_phases(gpu: str, comb_cases: list) -> dict:
    """Slice 9's repair: datasets above 19 features at B = 256 build their
    histograms in feature chunks, so 136 features fit.  ``hist_comb`` at 1M x 136 bitwise its
    plain version and timed; training parity at 10,000 x 136, card
    against device="cpu", 1 tree, bit-identical; the main path,
    ``make_higgs_like(1M, 136)``, 255 leaves, 3 iterations on the route
    the rules give (unfused stream, the cluster kernel tail), counted
    exactly; the tail bitwise its plain version on the median split of
    one tree, and one profiled iteration; slice 14's ``comb_cases`` of
    hist_comb in both packs at 136 features (``hist_comb_times``).
    Returns {"hist": ..., "parity": ..., "main": ..., "tail": ...,
    "times": ..., "mono": ..., "data": the binned 1M x 136 rows and
    their holdout}."""
    import lightgbm_tpu_torch as lgt
    hist = hist_comb_wide_case(gpu)
    times = hist_comb_times(gpu, WIDE_FEATURES, comb_cases)
    lap("wide/hist_comb")
    parity = train_parity(gpu, {}, WIDE_PARITY_TREES, "wide dataset",
                          params=dict(TRAIN_PARAMS,
                                      num_leaves=PARITY_CUT_LEAVES),
                          bitwise=True, n_features=WIDE_FEATURES,
                          rows=WIDE_PARITY_ROWS)
    lap("wide/parity")
    x_all, y_all, w = make_higgs_like(TRAIN_ROWS + HOLDOUT_ROWS,
                                      WIDE_FEATURES, seed=0,
                                      with_weights=True)
    x, y = x_all[:TRAIN_ROWS], y_all[:TRAIN_ROWS]
    t0 = time.perf_counter()
    ds = lgt.Dataset(x, label=y, params={"max_bin": 255}).construct()
    valid = lgt.Dataset(x_all[TRAIN_ROWS:], label=y_all[TRAIN_ROWS:],
                        reference=ds).construct()
    print(f"binned {TRAIN_ROWS} + {HOLDOUT_ROWS} rows x {WIDE_FEATURES} in "
          f"{time.perf_counter() - t0:.2f} s at max_bin=255 (host)",
          flush=True)
    lap("wide/binning")
    bst, main = train_main_path(gpu, ds, valid, x, {}, WIDE_ITERS,
                                "main path, wide dataset",
                                n_features=WIDE_FEATURES)
    if main["route"] != WIDE_ROUTE:
        raise RuntimeError(f"the wide dataset took {main['route']}, "
                           f"expected {WIDE_ROUTE}")
    tail = median_tail_parity(ds, {}, TRAIN_PARAMS, "wide route")
    with route_env({}):
        print("profiled iteration, wide route "
              + json.dumps(profile_iteration(bst, gpu)), flush=True)
    mono = mono_wide_phase(gpu, ds, valid, x, x_all[TRAIN_ROWS:], bst, w)
    return {"hist": hist, "parity": parity, "main": main, "tail": tail,
            "times": times, "mono": mono,
            "data": {"ds": ds, "valid": valid, "x": x,
                     "xv": x_all[TRAIN_ROWS:]}}


# ---------------------------------------------------------------------
# Slice 18: monotone constraints, the constrained mode of the split tail
MONO_CONSTRAINED = 8
MONO_SIGNS = [1] * 4 + [-1] * 4      # features 0-3 up, 4-7 down, rest free
MONO_ITERS = 2
MONO_SHORT_ITERS = 2
MONO_PENALTY = 2.0
MONO_PARITY_ROWS = 5_000
MONO_PARITY_TREES = 1
MONO_GRID_ROWS = 256
MONO_ROUTES = {"pack2": PACK2, "unfused": FUSED_OFF, "3ph": PART_3PH,
               "pool_tail_off": POOL_TAIL_OFF}
MONO_ROUTE_NAMES = {
    "default": "path=stream fused=1 tail=kernel",
    "pack2": "path=stream fused=1 tail=kernel pack=2",
    "unfused": "path=stream fused=0 tail=kernel (fused_env_off)",
    "3ph": "path=stream scheme=3ph fused=0 tail=kernel (part_3ph)",
    "pool_tail_off": "path=stream fused=1 tail=kernel pool_tail=0",
    "max_bin_1023": "path=row_order fused=0 tail=kernel (non_u8_bins)",
    "penalty": "path=stream fused=1 tail=kernel",
    "intermediate": "path=stream fused=1 tail=xla (tail_mono_intermediate)",
    "wide": WIDE_ROUTE}


def mono_params(params: dict, n_features: int, **extra) -> dict:
    """``params`` with ``MONO_SIGNS`` on the first eight of
    ``n_features`` features, 0 on the rest."""
    signs = MONO_SIGNS + [0] * (n_features - MONO_CONSTRAINED)
    return dict(params, monotone_constraints=signs, **extra)


def constrained_splits(models) -> int:
    """Splits on the constrained features (0-7) over ``models``."""
    return sum(int(np.sum(np.asarray(t.split_feature[:t.num_leaves - 1])
                          < MONO_CONSTRAINED)) for t in models)


def splits_along_signs(models) -> dict:
    """Of ``models``' splits on each constrained feature (0-7): how many
    there are, and how many order their children's outputs along
    ``MONO_SIGNS`` (the right child, the larger values, not below the
    left one for +1, not above it for -1): the splits a constrained
    search could also have taken."""
    out = {j: [0, 0] for j in range(MONO_CONSTRAINED)}
    for t in models:
        for i in range(t.num_leaves - 1):
            j = int(t.split_feature[i])
            if j >= MONO_CONSTRAINED:
                continue
            lo, ro = (float(t.internal_value[c]) if c >= 0
                      else float(t.leaf_value[~c])
                      for c in (int(t.left_child[i]), int(t.right_child[i])))
            out[j][0] += 1
            out[j][1] += int(MONO_SIGNS[j] * (ro - lo) >= 0)
    return {j: {"splits": n, "along_sign": k} for j, (n, k) in out.items()}


def mono_violations(bst, xv: np.ndarray, label: str) -> dict:
    """``MONO_GRID_ROWS`` holdout rows, each constrained feature walked
    over every upper bound of its bins (in the booster's own binning)
    and one value past the last: the served raw predictions must never
    move against the feature's sign (exactly: each tree is monotone, and
    f32 sums in a fixed order keep the order).  Raises on a violation."""
    ts = bst._inner.train_set
    rows = np.array(xv[:MONO_GRID_ROWS], np.float64)
    counts, walked = {}, 0
    for j, s in enumerate(MONO_SIGNS):
        inner = int(np.flatnonzero(ts.used_feature_map == j)[0])
        ub = np.asarray(ts.mappers[inner].upper_bounds, np.float64)
        fin = ub[np.isfinite(ub)]
        grid = np.append(fin, fin[-1] + 1.0 if len(fin) else 0.0)
        xs = np.repeat(rows, len(grid), axis=0)
        xs[:, j] = np.tile(grid, len(rows))
        p = bst.predict(xs, raw_score=True).reshape(len(rows), len(grid))
        counts[j] = int(np.sum(s * np.diff(p, axis=1) < 0))
        walked += xs.shape[0]
    rec = {"case": label, "rows": len(rows), "points": walked,
           "violations": sum(counts.values()), "by_feature": counts}
    if rec["violations"]:
        raise RuntimeError(f"the {label} moves against its monotone "
                           f"constraints: {rec}")
    return rec


def mono_train_parity(gpu: str, x, y, env: dict, params: dict,
                      label: str) -> dict:
    """``MONO_PARITY_TREES`` trees of ``PARITY_CUT_LEAVES`` leaves of the
    monotone cell's first ``MONO_PARITY_ROWS`` rows on the route ``env``
    selects, on the card
    and with device="cpu": trees and leaves bit for bit (a gate), and
    whether every split descriptor the card read equals the CPU run's."""
    import lightgbm_tpu_torch as lgt
    xc, yc = x[:MONO_PARITY_ROWS], y[:MONO_PARITY_ROWS]
    traces, bsts = [], []
    with route_env(env):
        for device in ("cuda", "cpu"):
            ds = lgt.Dataset(xc, label=yc,
                             params={"max_bin": params["max_bin"]})
            bst = lgt.Booster(dict(params, num_leaves=PARITY_CUT_LEAVES),
                              ds, device=device)
            traces.append([])
            bst._inner.grow.trace = traces[-1]
            t0 = time.perf_counter()
            for _ in range(MONO_PARITY_TREES):
                bst.update()
            bsts.append((bst, time.perf_counter() - t0))
    (bc, tc), (bp, tp) = bsts
    rec = compare_trees(bc._models, bp._models)
    rec.update(case=f"monotone {label}: first {MONO_PARITY_ROWS} rows x "
               f"{x.shape[1]}, {PARITY_CUT_LEAVES} leaves, "
               f"{MONO_PARITY_TREES} trees",
               route=bc._inner.grow.route.describe(),
               leaves_bitwise=leaves_bitwise(bc._models, bp._models),
               descriptors_equal=traces[0] == traces[1],
               constrained_splits=constrained_splits(bc._models),
               cuda_s=tc, cpu_s=tp)
    rec["ok"] = rec["ok"] and rec["leaves_bitwise"]
    print("parity training " + json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise RuntimeError(f"monotone training on the card differs from "
                           f"the CPU run: {rec}")
    return rec


def mono_tail_edge_cases(f: int = N_FEATURES, b: int = 256) -> list:
    """The constrained tail's adversarial cases at ``f`` x ``b``
    (synthetic 1M-row splits, ``tools/profile_apply_find.synthetic_split``
    with ``mono``), each through :func:`tail_parity` (both entries
    bitwise their plain versions on the card and on CPU copies, the done
    guard leaving every tensor untouched): a winner the violation mask
    removes (the strong feature's sign set against one child's order:
    that child's winner moves off it), bounds that clip every candidate
    (``[0.001, 0.002]``, the right child's bounds crossing), equal keys
    in the last two blocks of the cluster, the second constrained (the
    smaller, free feature wins), and a depth at which the penalty factor
    is the 1e-15 floor (penalty 3.0 at the children's depth 2: both
    winners on free features)."""
    import torch

    from lightgbm_tpu_torch.ops.apply_find import (BF, BLO, BRO, SMN, SMX,
                                                   apply_find_pool_ref,
                                                   tail_geometry)
    from lightgbm_tpu_torch.tools.profile_apply_find import synthetic_split
    geo = tail_geometry(f, b)
    out = []
    # 1. the violation mask removes a winner
    j = 5
    free = synthetic_split(f, b, strong=(j,), mono=True, signs=[0] * f)
    ref = free.clone()
    apply_find_pool_ref(ref.h_a, ref.h_b, *ref.args())
    rows = ref.st.best[[ref.at.leaf, ref.at.right]]
    won = [int(v) for v in rows[:, BF].tolist()]
    order = float(rows[0, BRO] - rows[0, BLO])
    signs = [0] * f
    signs[j] = -1 if order > 0 else 1
    case = synthetic_split(f, b, strong=(j,), mono=True, signs=signs,
                           device="cuda")
    rec = tail_parity(case, f"{f}x{b}_mono_violation_removes_the_winner")
    moved = int(rec["best_rows"][0][BF])
    rec["free_winners"] = won
    if won[0] != j or moved == j:
        raise RuntimeError(f"the violation case did not remove the left "
                           f"child's winner on feature {j}: {won} -> "
                           f"{moved}")
    out.append(rec)
    # 2. bounds that clip every candidate
    case = synthetic_split(f, b, mono=True, bounds=(0.001, 0.002),
                           device="cuda")
    rec = tail_parity(case, f"{f}x{b}_mono_bounds_clip_every_candidate")
    st = case.clone()
    apply_find_pool_ref(st.h_a, st.h_b, *st.args())
    lo = st.st.lstate[[st.at.leaf, st.at.right]][:, [SMN, SMX]]
    outs = st.st.best[[st.at.leaf, st.at.right]][:, [BLO, BRO]]
    if not bool(((outs >= torch.minimum(lo[:, :1], lo[:, 1:]))
                 & (outs <= lo[:, 1:])).all()):
        raise RuntimeError("the clipping case's winners left their bounds")
    out.append(rec)
    # 3. equal keys in the last two blocks, the second constrained
    k = (geo.blocks - 1) * geo.feats - 1
    signs = [0] * f
    signs[k + 1] = 1
    out.append(tail_parity(
        synthetic_split(f, b, ties=(k,), strong=(k,), mono=True,
                        signs=signs, penalty=0.0, device="cuda"),
        f"{f}x{b}_mono_equal_keys_in_the_last_two_blocks",
        want_features=(k,)))
    # 4. the penalty factor at its floor
    signs = [1 if i % 2 else -1 for i in range(f)]
    signs[0] = 1
    for i in (3, 6):
        signs[i] = 0
    out.append(tail_parity(
        synthetic_split(f, b, strong=(2, 3), mono=True, signs=signs,
                        penalty=3.0, depth=1.0, device="cuda"),
        f"{f}x{b}_mono_penalty_floor", want_features=(3, 6)))
    return out


def mono_phases(gpu: str, ds, valid, ds_wide, valid_wide, x, y, xv,
                twin: dict, tail_times: dict) -> list:
    """Slice 18: monotone constraints on the main path's cell (1M x 28
    Higgs-like rows, 100,000 holdout, 255 leaves, binary; +1 on features
    0-3, -1 on 4-7).  The constrained tail bitwise its plain version on
    its adversarial cases and on the median split of a default-route and
    a row-order tree; the card against the CPU on the first 5,000 rows
    (1 tree) on the default, pack=2 and row-order routes (bitwise); the basic
    method on the default route for 2 iterations, pack=2, P1
    ``FUSED=0``, 3ph, ``POOL_TAIL=0`` and row-order (``max_bin`` 1023)
    for 2, ``monotone_penalty`` 2.0 and the intermediate method for 2,
    each counted (the tail's launches are its constrained launches),
    pack=2's, ``FUSED=0``'s and ``POOL_TAIL=0``'s trees bitwise the
    default route's, every model monotone on the grid, served scores
    within 64 ulps a tree of the host walk; ``twin`` is the unconstrained
    default route's run.  Returns the two constrained instantiations'
    kernel records (the wide route's run is added in the wide phase)."""
    import torch

    from lightgbm_tpu_torch.ops.apply_find import (apply_find_pool_ref,
                                                   apply_find_ref)
    from lightgbm_tpu_torch.tools.profile_apply_find import synthetic_split
    params = mono_params(TRAIN_PARAMS, N_FEATURES)
    params_1023 = mono_params(WIDE_PARAMS, N_FEATURES)
    edges = mono_tail_edge_cases() + mono_tail_edge_cases(WIDE_FEATURES)
    medians = [median_tail_parity(ds, {}, params, "monotone default route"),
               median_tail_parity(ds_wide, {}, params_1023,
                                  "monotone row-order route, max_bin=1023")]
    parities = {k: mono_train_parity(gpu, x, y, env, params, k)
                for k, env in (("default", {}), ("pack2", PACK2))}
    parities["max_bin_1023"] = mono_train_parity(gpu, x, y, {}, params_1023,
                                                 "max_bin 1023")
    runs, bsts = {}, {}
    bsts["default"], runs["default"] = train_main_path(
        gpu, ds, valid, x, {}, MONO_ITERS, "monotone default route",
        params=params)
    for key, env in MONO_ROUTES.items():
        bsts[key], runs[key] = train_main_path(
            gpu, ds, valid, x, env, MONO_SHORT_ITERS,
            f"monotone {key} route", params=params)
    bsts["max_bin_1023"], runs["max_bin_1023"] = train_main_path(
        gpu, ds_wide, valid_wide, x, {}, MONO_SHORT_ITERS,
        "monotone max_bin 1023 route", params=params_1023)
    bsts["penalty"], runs["penalty"] = train_main_path(
        gpu, ds, valid, x, {}, MONO_SHORT_ITERS, "monotone penalty 2.0",
        params=dict(params, monotone_penalty=MONO_PENALTY))
    bsts["intermediate"], runs["intermediate"] = train_main_path(
        gpu, ds, valid, x, {}, MONO_SHORT_ITERS, "monotone intermediate",
        params=dict(params, monotone_constraints_method="intermediate"))
    for key, run in runs.items():
        if run["route"] != MONO_ROUTE_NAMES[key]:
            raise RuntimeError(f"the monotone {key} run took {run['route']},"
                               f" not {MONO_ROUTE_NAMES[key]}")
    for key in ("pack2", "unfused", "pool_tail_off"):
        _same_trees(bsts["default"], bsts[key], f"monotone {key} route")
    k = MONO_SHORT_ITERS
    p3 = compare_trees(bsts["default"]._models[:k], bsts["3ph"]._models)
    p3["case"] = (f"monotone 3ph route vs the default route, {k} trees "
                  "(reported, not a gate: the right rows come in another "
                  "order)")
    print("parity routes " + json.dumps(p3), flush=True)
    grid = {key: mono_violations(bst, xv, f"monotone {key} route")
            for key, bst in bsts.items()}
    # served predictions against the f64 host walk
    bst = bsts["default"]
    xh = np.array(xv[:HOST_ROWS], np.float64)
    served = bst.predict(xh, raw_score=True)
    host = sum(t.leaf_value[t.predict_leaf(xh)] for t in bst._models)
    if not np.all(np.abs(served - host)
                  <= score_tolerance(host, len(bst._models))):
        raise RuntimeError("served monotone predictions differ from the "
                           "host walk")
    with route_env({}):
        prof = profile_iteration(bsts["default"], gpu)
    print("profiled iteration, monotone default route " + json.dumps(prof),
          flush=True)
    with route_env({}):
        prof_i = profile_iteration(bsts["intermediate"], gpu)
    print("profiled iteration, monotone intermediate " + json.dumps(prof_i),
          flush=True)
    summary = {}
    for key, run in runs.items():
        stages = run["stage_ms_per_tree"]
        summary[key] = {
            "route": run["route"], "iterations": run["iterations"],
            "s_per_iter_first": run["s_per_iter_first"],
            "s_per_iter": run["s_per_iter_rest_mean"],
            "holdout_auc": run["holdout_auc"], "splits": run["splits"],
            "constrained_splits": constrained_splits(bsts[key]._models),
            "split_tail_share": stages.get("split_tail", 0.0)
            / max(sum(stages.values()), 1e-9),
            "host_reads": run["host_reads"],
            "launches": {n: v for n, v in run["launches"].items() if v},
            "grid_violations": grid[key]["violations"]}
    summary["default"].update(
        twin_holdout_auc=twin["holdout_auc"],
        twin_s_per_iter=twin["s_per_iter_rest_mean"],
        kernels_per_split=prof.get("kernels_per_split"),
        apply_find_ms=prof.get("apply_find_ms"),
        apply_find_share_of_busy=(prof["apply_find_ms"] / prof["busy_ms"]
                                  if prof.get("measured") else None),
        busy_share=prof.get("busy_share"),
        predict_vs_host_max_abs_err=float(np.abs(served - host).max()))
    summary["intermediate"].update(
        kernels_per_split=prof_i.get("kernels_per_split"),
        busy_share=prof_i.get("busy_share"))
    times = {shape: {k: v for k, v in rec.items() if k.startswith(
        "apply_find")} for shape, rec in tail_times.items()}
    print("monotone routes " + json.dumps(summary) + f" [{gpu}]", flush=True)
    print("monotone tail times [ms] " + json.dumps(times) + f" [{gpu}]",
          flush=True)
    for key, run in runs.items():
        if constrained_splits(bsts[key]._models) <= 0:
            raise RuntimeError(f"the monotone {key} run split no "
                               "constrained feature")
    # the plain versions' times on the default shape's constrained split
    case = synthetic_split(N_FEATURES, 256, mono=True, device="cuda")
    t = case.clone()
    plain_ms = _time_ms(lambda: apply_find_pool_ref(t.h_a, t.h_b, *t.args()),
                        5)
    h2 = torch.stack([t.st.pool[t.at.leaf], t.st.pool[t.at.right]])
    plain_entry_ms = _time_ms(lambda: apply_find_ref(h2, *t.args()), 5)
    cells = N_FEATURES * 256
    hist_out = cells * 2 * 4
    shape = f"{N_FEATURES}x256"
    recs = []
    for name, wrapper, key, replaces, plain, n_bytes in (
            ("apply_find_pool_mono", "apply_find_pool", "default", 571,
             plain_ms, 4 * hist_out),
            ("apply_find_mono", "apply_find", "pool_tail_off", 529,
             plain_entry_ms, 2 * hist_out)):
        tt = tail_times[shape][wrapper + "_mono"]
        recs.append(_kernel_record(
            name, "lightgbm_tpu_torch/csrc/apply_find.cu",
            f"lightgbm_tpu/ops/pallas/apply_find.py:{replaces}",
            runs[key]["launches"][wrapper], 0.0, tt["ms"], plain,
            n_bytes, 40 * cells, gpu,
            launched_on=f"monotone {key} route",
            instantiation=f"apply_find_mono_kernel<"
                          f"{'true' if wrapper.endswith('pool') else 'false'}>",
            graph_ms=tt["graph_ms"],
            unconstrained_ms=tail_times[shape][wrapper]["ms"],
            unconstrained_graph_ms=tail_times[shape][wrapper]["graph_ms"],
            times=times,
            launches_by_route={k: r["launches"][wrapper]
                               for k, r in runs.items()
                               if r["launches"][wrapper]},
            parity_cases=[r["case"] for r in edges + medians],
            train_parity_bitwise=all(r["ok"] for r in parities.values())))
    recs[0]["monotone_runs"] = summary
    return recs


def mono_wide_phase(gpu: str, ds, valid, x, xv, twin, w) -> dict:
    """The monotone cell's signs on the wide 1M x 136 dataset: 3
    iterations on its route (unfused stream, the cluster tail), counted,
    monotone on the grid, and the constrained tail bitwise its plain
    version on a tree's median split at 136 x 256; the splits on the
    constrained features are printed, beside those of ``twin`` (the
    unconstrained wide model) on each of them, how many of its splits
    order their children along the sign, and the generator's linear
    weights ``w`` of features 0-7."""
    params = mono_params(TRAIN_PARAMS, WIDE_FEATURES)
    tail = median_tail_parity(ds, {}, params, "monotone wide route")
    bst, run = train_main_path(gpu, ds, valid, x, {}, MONO_SHORT_ITERS,
                               "monotone wide route", params=params,
                               n_features=WIDE_FEATURES)
    if run["route"] != MONO_ROUTE_NAMES["wide"]:
        raise RuntimeError(f"the monotone wide run took {run['route']}")
    grid = mono_violations(bst, xv, "monotone wide route")
    # printed, not a gate: among 136 features the eight constrained ones
    # may find no split that keeps their order in 3 trees
    rec = {"route": run["route"], "s_per_iter": run["s_per_iter_rest_mean"],
           "holdout_auc": run["holdout_auc"], "splits": run["splits"],
           "constrained_splits": constrained_splits(bst._models),
           "launches": run["launches"]["apply_find_pool"],
           "grid_violations": grid["violations"], "tail": tail["case"]}
    print("monotone wide route " + json.dumps(rec) + f" [{gpu}]", flush=True)
    # a witness of whether no constrained winner is a property of the
    # data: the twin's splits on features 0-7 and the generator's signs
    twin_rec = {"twin_constrained_splits": constrained_splits(twin._models),
                "twin_splits": sum(t.num_leaves - 1 for t in twin._models),
                "twin_by_feature": splits_along_signs(twin._models),
                "signs": MONO_SIGNS,
                "generator_w": [round(float(v), 4)
                                for v in w[:MONO_CONSTRAINED]]}
    print("monotone wide twin " + json.dumps(twin_rec) + f" [{gpu}]",
          flush=True)
    rec["twin"] = twin_rec
    return rec


# ---------------------------------------------------------------------
# Slice 17: sorted-subset categorical splits, the membership-word modes
# of the fused split and the partitions
CAT_CATS, CAT_COLS = 1024, 8          # bench.py --categorical 1024,8
CAT_ROWS = 1_048_576
CAT_FEATURES = N_FEATURES + CAT_COLS
CAT_PARAMS = {"objective": "binary", "num_leaves": TRAIN_LEAVES,
              "max_bin": 255, "max_cat_to_onehot": 4,
              "min_data_per_group": 5, "metric": "auc", "verbosity": -1}
CAT_DS_PARAMS = {"max_bin": 255, "min_data_in_bin": 1}
# bench_cat_onehot's setting: a threshold above the cardinality keeps
# every categorical split one-hot (and the kernel tail)
CAT_ONEHOT_PARAMS = dict(CAT_PARAMS, max_cat_to_onehot=CAT_CATS + 1)
CAT_ITERS = 2
CAT_SHORT_ITERS = 1
# the cut of the categorical data the card is held against the CPU on
CAT_PARITY_ROWS = 5_000
CAT_PARITY_TREES = 1
CAT_ROUTES = {"default": {}, "pack2": PACK2, "unfused": FUSED_OFF,
              "pack2_unfused": PACK2_UNFUSED, "3ph": PART_3PH}
# each word mode: (wrapper name, the route whose main path launches it,
# source, the JAX package's registration of the mode)
CAT_WORD_MODES = {
    "fused_split_cat": ("fused_split", "default",
                        "lightgbm_tpu_torch/csrc/fused_split.cu",
                        "lightgbm_tpu/ops/pallas/fused_split.py:483"),
    "fused_split_p2_cat": ("fused_split_p2", "pack2",
                           "lightgbm_tpu_torch/csrc/fused_split.cu",
                           "lightgbm_tpu/ops/pallas/fused_split.py:505"),
    "partition_scan_cat": ("partition_scan", "unfused",
                           "lightgbm_tpu_torch/csrc/partition.cu",
                           "lightgbm_tpu/ops/pallas/partition_kernel3.py"
                           ":689"),
    "partition_scan_p2_cat": ("partition_scan_p2", "pack2_unfused",
                              "lightgbm_tpu_torch/csrc/partition.cu",
                              "lightgbm_tpu/ops/pallas/partition_kernel3.py"
                              ":710"),
    "partition_3ph_cat": ("partition_3ph", "3ph",
                          "lightgbm_tpu_torch/csrc/partition_3ph.cu",
                          "lightgbm_tpu/ops/pallas/partition_kernel.py:372"),
}
# adversarial membership words (as i32)
CAT_WORDS = {
    "all_zero": (0,) * 8,
    "all_set": (-1,) * 8,
    "bit31_every_word": (-(1 << 31),) * 8,
    "single_bit": (0, 0, 1 << 13, 0, 0, 0, 0, 0),
    "last_word": (0,) * 7 + (-0x7FFF0000,),
    "mixed": EDGE_WORDS,
}


def make_categorical_like(n_rows: int, n_cats: int, n_cat_cols: int,
                          n_features: int = N_FEATURES, seed: int = 0):
    """Higgs-style dense features and ``n_cat_cols`` categorical columns
    of ``n_cats`` Zipf-skewed categories (frequency ~ 1 / rank^1.1), a
    hidden good third of each column's categories flipping the label
    where most columns hold one (the generator bench.py serves for
    ``--categorical``).  Returns ``(x, y, categorical column ids)``,
    the categorical columns first."""
    x, y = make_higgs_like(n_rows, n_features, seed)
    rng = np.random.default_rng(seed + 2)
    probs = 1.0 / np.arange(1.0, n_cats + 1.0) ** 1.1
    probs /= probs.sum()
    cats = rng.choice(n_cats, size=(n_rows, n_cat_cols),
                      p=probs).astype(np.float32)
    flip = np.zeros(n_rows, np.float32)
    for j in range(n_cat_cols):
        good = rng.choice(n_cats, size=max(n_cats // 3, 1), replace=False)
        flip += np.isin(cats[:, j], good)
    y = np.logical_xor(y > 0,
                       flip >= (n_cat_cols + 1) // 2).astype(np.float32)
    return np.hstack([cats, x]), y, list(range(n_cat_cols))


def cat_word_cases(tile: int, cat_feature: int, nan_bin: int) -> list:
    """[(label, sel)] of the word modes' adversarial descriptors over
    rows whose feature ``cat_feature`` spans every u8 bin and whose
    feature 0 holds ``nan_bin``: a categorical split with each of
    ``CAT_WORDS``, across tiles at odd starts; numerical splits carrying
    zero words (the NaN bin routed left, no NaN bin) and one carrying
    set words, which it ignores."""
    zero = CAT_WORDS["all_zero"]
    out = [(f"cat_{k}", (1 + 2 * i, 3 * tile + 2 * i + 1, cat_feature, 0, 0,
                         1, -1, 0, *w))
           for i, (k, w) in enumerate(CAT_WORDS.items())]
    out += [("nan_bin_zero_words", (777, 2 * tile + 1, 0, 90, 1, 0, nan_bin,
                                    0, *zero)),
            ("numerical_zero_words", (5, 4 * tile - 3, 1, 100, 0, 0, -1, 0,
                                      *zero)),
            ("numerical_ignores_words", (3, 3 * tile, 2, 60, 0, 0, -1, 0,
                                         *CAT_WORDS["mixed"]))]
    return out


def cat_rows(n: int, f: int, seed: int, device):
    """Seeded rows for the word modes: ``random_row_matrix`` with feature
    0's NaN bin 254 and the last feature over every u8 bin."""
    arrays = list(random_row_matrix(n, f, seed, n_bins=254, nan_bin=254))
    arrays[0][:, f - 1] = np.random.default_rng(seed + 1).integers(0, 256, n)
    return rows_on(arrays, device)


def cat_word_parity(gpu: str) -> dict:
    """Each word mode against its plain version on the adversarial
    descriptors of ``cat_word_cases`` at 36 features (the categorical
    cell's width, 64-byte records): partition_scan + copyback,
    partition_3ph (also on CPU copies), partition_scan_p2 + copyback_p2,
    fused_split + copyback and fused_split_p2 + copyback_p2, each call
    one launch.  The partitions are gated bitwise; the fused modes' rows
    and nleft are bitwise, their histograms bitwise hist_comb's and within
    4 * n * eps_f32 * max|v| of the plain version.  Returns {mode:
    {"cases": [labels], "max_abs_err": the largest difference from the
    plain version over the cases, "tol": the largest tolerance}}."""
    import torch

    from lightgbm_tpu_torch.ops import fused_split as fs
    from lightgbm_tpu_torch.ops import partition_kernel as pk
    from lightgbm_tpu_torch.ops.device_data import pack_rows
    n, f = 200_000, CAT_FEATURES
    rows = cat_rows(n, f, 17, "cuda")
    packed = pack_rows(rows)
    tile = pk.scan_geometry(n, f).tile
    runs = {"partition_scan_cat": (pk.partition_scan,
                                   lambda sel, lab: partition_parity(
                                       rows, sel, lab)),
            "partition_3ph_cat": (pk.partition_3ph,
                                  lambda sel, lab: partition_3ph_parity(
                                      rows, sel, lab)),
            "partition_scan_p2_cat": (pk.partition_scan_p2,
                                      lambda sel, lab: pack2_scan_case(
                                          rows, packed, sel, lab)),
            "fused_split_cat": (fs.fused_split,
                                lambda sel, lab: fused_parity(
                                    rows, sel, 256, lab)),
            "fused_split_p2_cat": (fs.fused_split_p2,
                                   lambda sel, lab: pack2_split_case(
                                       rows, packed, sel, 256, lab))}
    out = {}
    for mode, (fn, check) in runs.items():
        recs, labels = [], []
        for label, sel in cat_word_cases(tile, f - 1, 254):
            before = fn.launches
            recs.append(check(sel, f"{mode} {label}"))
            labels.append(label)
            torch.cuda.synchronize()
            if fn.launches - before != 1:
                raise RuntimeError(f"{mode} {label} launched {fn.__name__} "
                                   f"{fn.launches - before} times, not once")
        out[mode] = {"cases": labels,
                     "max_abs_err": max(r.get("max_abs_err", 0.0)
                                        for r in recs),
                     "tol": max(r.get("tol", 0.0) for r in recs)}
    print("parity word modes " + json.dumps(
        {"rows": n, "features": f, "tile": tile, "cases": out,
         "gpu": gpu}), flush=True)
    del rows, packed
    return out


def cat_word_times(gpu: str, models) -> dict:
    """Each word mode beside its one-hot mode on the same split (the
    words hold the one-hot bin alone, so both move the same rows), on
    seeded 2^20 x 36 rows at the root and at the quartiles of the
    categorical main path's split segments (``models``' trees), eager
    and as one replay of a graph of 20 calls; the word mode's plain
    version at the root.  Returns {mode: {"root": ..., "times": [...]}}."""
    import torch

    from lightgbm_tpu_torch.ops import fused_split as fs
    from lightgbm_tpu_torch.ops import partition_kernel as pk
    from lightgbm_tpu_torch.ops.device_data import (empty_packed_like,
                                                    empty_rows_like,
                                                    pack_rows)
    n, f = CAT_ROWS, CAT_FEATURES
    rows = cat_rows(n, f, 23, "cuda")
    packed = pack_rows(rows)
    scr, scr2 = empty_rows_like(rows), empty_packed_like(packed)
    nl = torch.zeros(1, dtype=torch.int32, device=rows.bins.device)
    sizes = segment_sizes(models)
    print("categorical route split segments " + json.dumps(sizes),
          flush=True)
    bin_, cat_f = 17, f - 1
    words = [0] * 8
    words[bin_ // 32] = 1 << (bin_ % 32)
    calls = {
        "fused_split_cat": lambda sel: fs.fused_split(rows, scr, sel, nl,
                                                      padded_bins=256),
        "fused_split_p2_cat": lambda sel: fs.fused_split_p2(
            packed, scr2, sel, nl, padded_bins=256),
        "partition_scan_cat": lambda sel: pk.partition_scan(rows, scr, sel,
                                                            nl),
        "partition_scan_p2_cat": lambda sel: pk.partition_scan_p2(
            packed, scr2, sel, nl),
        "partition_3ph_cat": lambda sel: pk.partition_3ph(rows, scr, sel,
                                                          nl)}
    plain = {
        "fused_split_cat": lambda sel: fs.fused_split_ref(rows, scr, sel, nl,
                                                          padded_bins=256),
        "fused_split_p2_cat": lambda sel: fs.fused_split_p2_ref(
            packed, scr2, sel, nl, padded_bins=256),
        "partition_scan_cat": lambda sel: pk.partition_scan_ref(rows, scr,
                                                                sel, nl),
        "partition_scan_p2_cat": lambda sel: pk.partition_scan_p2_ref(
            packed, scr2, sel, nl),
        "partition_3ph_cat": lambda sel: pk.partition_3ph_ref(rows, scr, sel,
                                                              nl)}
    out = {}
    for mode, call in calls.items():
        times = []
        for label in ("root", "q25", "median", "q75"):
            cnt = n if label == "root" else sizes[label]
            s0 = (n - cnt) // 2
            onehot = (s0, cnt, cat_f, bin_, 0, 1, -1)
            worded = onehot + (0, *words)
            e1, g1 = eager_and_graph_ms(lambda: call(onehot))
            e2, g2 = eager_and_graph_ms(lambda: call(worded))
            times.append({"case": label, "cnt": cnt, "onehot_ms": e1,
                          "onehot_graph_ms": g1, "words_ms": e2,
                          "words_graph_ms": g2,
                          "graph_diff_ms": g2 - g1})
        root = (0, n, cat_f, 0, 0, 1, -1, 0, *CAT_WORDS["mixed"])
        out[mode] = {"ms": _time_ms(lambda: call(root), 20),
                     "plain_ms": _time_ms(lambda: plain[mode](root), 3),
                     "times": times}
    res = {"segments": sizes, "modes": out, "gpu": gpu}
    print("word mode times [ms] " + json.dumps(res), flush=True)
    del rows, packed, scr, scr2
    return res


def cat_train_parity(gpu: str, x, y, cats, env: dict, params: dict,
                     label: str) -> dict:
    """``CAT_PARITY_TREES`` trees of the categorical workload's first
    ``CAT_PARITY_ROWS`` rows on the route ``env`` selects, on the card
    and with device="cpu": trees and leaves bit for bit (a gate), and
    whether every split descriptor (membership words included) read on
    the card equals the CPU run's."""
    import lightgbm_tpu_torch as lgt
    xc, yc = x[:CAT_PARITY_ROWS], y[:CAT_PARITY_ROWS]
    traces, bsts = [], []
    with route_env(env):
        for device in ("cuda", "cpu"):
            ds = lgt.Dataset(xc, label=yc, categorical_feature=cats,
                             params=dict(CAT_DS_PARAMS,
                                         max_bin=params["max_bin"]))
            bst = lgt.Booster(params, ds, device=device)
            traces.append([])
            bst._inner.grow.trace = traces[-1]
            t0 = time.perf_counter()
            for _ in range(CAT_PARITY_TREES):
                bst.update()
            bsts.append((bst, time.perf_counter() - t0))
    (bc, tc), (bp, tp) = bsts
    rec = compare_trees(bc._models, bp._models)
    rec.update(case=f"categorical {label}: first {CAT_PARITY_ROWS} rows x "
               f"{CAT_FEATURES}, {params['num_leaves']} leaves, "
               f"{CAT_PARITY_TREES} trees",
               route=bc._inner.grow.route.describe(),
               leaves_bitwise=leaves_bitwise(bc._models, bp._models),
               descriptors_equal=traces[0] == traces[1],
               multi_category_splits=multi_category_splits(bc._models),
               cuda_s=tc, cpu_s=tp)
    rec["ok"] = rec["ok"] and rec["leaves_bitwise"]
    print("parity training " + json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise RuntimeError(f"categorical training on the card differs from "
                           f"the CPU run: {rec}")
    return rec


def multi_category_splits(models) -> int:
    """Categorical splits whose bitset holds more than one category."""
    n = 0
    for t in models:
        for i in range(t.num_leaves - 1):
            if t.decision_type[i] & 1:
                slot = int(t.threshold[i])
                lo, hi = t.cat_boundaries[slot], t.cat_boundaries[slot + 1]
                n += sum(bin(int(w)).count("1")
                         for w in t.cat_threshold[lo:hi]) > 1
    return n


def cat_phases(gpu: str) -> list:
    """Slice 17: the categorical workload (``bench.py --categorical
    1024,8``: 2^20 training and 100,000 holdout rows, 28 dense and 8
    categorical features of Zipf-skewed categories, binary, 255 leaves,
    max_bin 255, min_data_in_bin 1, min_data_per_group 5,
    max_cat_to_onehot 4).  The word modes against their plain versions
    on adversarial words; the card against the CPU on a cut of the data
    on every categorical route (bit for bit); the default route for 2
    iterations, pack=2, both FUSED=0 routes and 3ph for 1 (pack=2 and
    the unfused routes' trees bitwise the default route's), max_bin 1023
    (cat_overwide, row_order) for 1 and the one-hot twin
    (max_cat_to_onehot 1025, the kernel tail) for 1, each counted, each
    word mode launched on its route, served through
    serve_traverse and held against the f64 host walk; the word modes
    timed beside their one-hot modes.  Returns the five word modes'
    kernel records and the default route's model text and first
    EDGE_ROWS holdout rows (for :func:`edges_phase`)."""
    import lightgbm_tpu_torch as lgt
    parity = cat_word_parity(gpu)
    lap("categorical/word parity")
    x_all, y_all, cats = make_categorical_like(CAT_ROWS + HOLDOUT_ROWS,
                                               CAT_CATS, CAT_COLS)
    x, y = x_all[:CAT_ROWS], y_all[:CAT_ROWS]
    xv, yv = x_all[CAT_ROWS:], y_all[CAT_ROWS:]
    t0 = time.perf_counter()
    ds = lgt.Dataset(x, label=y, categorical_feature=cats,
                     params=CAT_DS_PARAMS).construct()
    valid = lgt.Dataset(xv, label=yv, reference=ds).construct()
    t1 = time.perf_counter()
    ds_wide = lgt.Dataset(x, label=y, categorical_feature=cats,
                          params=dict(CAT_DS_PARAMS, max_bin=1023)).construct()
    valid_wide = lgt.Dataset(xv, label=yv, reference=ds_wide).construct()
    print(f"binned {CAT_ROWS} + {HOLDOUT_ROWS} rows x {CAT_FEATURES} "
          f"({CAT_COLS} categorical of {CAT_CATS} categories) in "
          f"{t1 - t0:.2f} s at max_bin=255 and "
          f"{time.perf_counter() - t1:.2f} s at max_bin=1023 (host)",
          flush=True)
    wide_params = dict(CAT_PARAMS, max_bin=1023)
    cut = {"num_leaves": PARITY_CUT_LEAVES}
    parities = {k: cat_train_parity(gpu, x, y, cats, env,
                                    dict(CAT_PARAMS, **cut), k)
                for k, env in CAT_ROUTES.items()}
    parities["max_bin_1023"] = cat_train_parity(
        gpu, x, y, cats, {}, dict(wide_params, **cut), "max_bin 1023")

    lap("categorical/binning and train parity")
    runs, bsts = {}, {}
    for key, env in CAT_ROUTES.items():
        bsts[key], runs[key] = train_main_path(
            gpu, ds, valid, x, env,
            CAT_ITERS if key == "default" else CAT_SHORT_ITERS,
            f"categorical {key} route", params=CAT_PARAMS,
            n_features=CAT_FEATURES)
    bsts["max_bin_1023"], runs["max_bin_1023"] = train_main_path(
        gpu, ds_wide, valid_wide, x, {}, CAT_SHORT_ITERS,
        "categorical max_bin 1023 route", params=wide_params,
        n_features=CAT_FEATURES)
    bsts["onehot"], runs["onehot"] = train_main_path(
        gpu, ds, valid, x, {}, CAT_SHORT_ITERS, "categorical one-hot twin",
        params=CAT_ONEHOT_PARAMS, n_features=CAT_FEATURES)
    want_routes = {
        "default": "path=stream fused=1 tail=xla (tail_cat_subset)",
        "max_bin_1023": "path=row_order fused=0 tail=xla (cat_overwide, "
                        "non_u8_bins, tail_cat_subset)",
        "onehot": "path=stream fused=1 tail=kernel"}
    for key, want in want_routes.items():
        if runs[key]["route"] != want:
            raise RuntimeError(f"the categorical {key} run took "
                               f"{runs[key]['route']}, not {want}")
    summary = {}
    for key, run in runs.items():
        models = bsts[key]._models
        summary[key] = {"route": run["route"],
                        "s_per_iter": run["s_per_iter_rest_mean"],
                        "holdout_auc": run["holdout_auc"],
                        "multi_category_splits":
                            multi_category_splits(models),
                        "splits": run["splits"],
                        "host_reads": run["host_reads"],
                        "launches": {k: v for k, v in run["launches"].items()
                                     if v}}
        if key != "onehot" and summary[key]["multi_category_splits"] <= 0:
            raise RuntimeError(f"the categorical {key} run made no split of "
                               "more than one category")
        if run["host_reads"] > run["splits"] + len(models):
            raise RuntimeError(f"the categorical {key} run read the host "
                               f"{run['host_reads']} times for "
                               f"{run['splits']} splits")
    # each word mode ran on its route (every split of a subset model
    # carries the words)
    for mode, (wrapper, key, _, _) in CAT_WORD_MODES.items():
        if runs[key]["launches"][wrapper] <= 0:
            raise RuntimeError(f"the categorical {key} route launched "
                               f"{wrapper} no time")
    # pack=2 and the unfused routes grow the default route's trees
    for key in ("pack2", "unfused", "pack2_unfused"):
        _same_trees(bsts["default"], bsts[key], f"categorical {key} route")
    k = CAT_SHORT_ITERS
    p3 = compare_trees(bsts["default"]._models[:k], bsts["3ph"]._models)
    p3["case"] = (f"categorical 3ph route vs the default route, {k} trees "
                  "(reported, not a gate: the right rows come in another "
                  "order)")
    print("parity routes " + json.dumps(p3), flush=True)
    # served predictions against the f64 host walk
    bst = bsts["default"]
    xh = np.array(xv[:HOST_ROWS], np.float64)
    xh[:64, 0] = -3.0                    # a negative category
    xh[64:128, 1] = 5_000.0              # an unseen category
    xh[128:192, 2] = np.nan              # a NaN category
    served = bst.predict(xh, raw_score=True)
    host = sum(t.leaf_value[t.predict_leaf(xh)] for t in bst._models)
    tol = score_tolerance(host, len(bst._models))
    if not np.all(np.abs(served - host) <= tol):
        raise RuntimeError("served categorical predictions differ from the "
                           "host walk")
    summary["default"]["predict_vs_host_max_abs_err"] = float(
        np.abs(served - host).max())
    print("categorical routes " + json.dumps(summary) + f" [{gpu}]",
          flush=True)
    with route_env({}):
        print("profiled iteration, categorical default route "
              + json.dumps(profile_iteration(bsts["default"], gpu)),
              flush=True)

    lap("categorical/main paths")
    times = cat_word_times(gpu, bsts["default"]._models)
    n, row_bytes = CAT_ROWS, CAT_FEATURES + ROW_EXTRA_BYTES
    stride = 64
    hist_out = CAT_FEATURES * 256 * 2 * 4
    bounds = {"fused_split_cat": (2 * n * row_bytes + 2 * hist_out,
                                  2 * n * CAT_FEATURES),
              "fused_split_p2_cat": (2 * n * stride + 2 * hist_out,
                                     2 * n * CAT_FEATURES),
              "partition_scan_cat": (2 * n * row_bytes + 4, 0),
              "partition_scan_p2_cat": (2 * n * stride + 4, 0),
              "partition_3ph_cat": (2 * n * row_bytes + 4, 0)}
    recs = []
    for mode, (wrapper, key, source, replaces) in CAT_WORD_MODES.items():
        t = times["modes"][mode]
        recs.append(_kernel_record(
            mode, source, replaces, runs[key]["launches"][wrapper],
            parity[mode]["max_abs_err"], t["ms"], t["plain_ms"],
            *bounds[mode], gpu, launched_on=f"categorical {key} route",
            times=t["times"], segments=times["segments"],
            parity_cases=parity[mode]["cases"], tol=parity[mode]["tol"],
            train_parity_bitwise=parities[key]["ok"]))
    recs[0]["categorical_runs"] = summary
    recs[0]["train_parity"] = {k: r["ok"] for k, r in parities.items()}
    cat = {"model": bsts["default"].model_to_string(),
           "xv": np.asarray(xv[:EDGE_ROWS])}
    return recs, cat


# -- Slice 19: multiclass training and the regression and cross-entropy
# objectives (on the kernel-tail physical route) ----------------------------
MC_CLASSES = 5
MC_ITERS = 2
MC_PARAMS = {"objective": "multiclass", "num_class": MC_CLASSES,
             "num_leaves": TRAIN_LEAVES, "max_bin": 255,
             "learning_rate": 0.1, "metric": ["multi_logloss", "multi_error"],
             "verbosity": -1}
OVA_PARAMS = dict(MC_PARAMS, objective="multiclassova", num_class=3)
MC_PARITY_ITERS = 1
MC_ROUTE = ("path=physical fused=1 tail=kernel (objective_not_streamable, "
            "multi_tree_iter)")
OBJ_ROUTE = "path=physical fused=1 tail=kernel (objective_not_streamable)"
# the objectives whose trees the card grows as the CPU does, 2 each
OBJ_PARITY = {"regression_l1": {}, "huber": {}, "fair": {}, "poisson": {},
              "quantile": {"alpha": 0.9}, "mape": {}, "gamma": {},
              "tweedie": {}, "cross_entropy": {}, "cross_entropy_lambda": {}}
OBJ_PARITY_TREES = 1
# rows of the objectives' and the sampling modes' card-against-CPU runs
# (fewer than PARITY_ROWS: the script's time budget)
OBJ_PARITY_ROWS = 5_000
L1_ITERS = 2
L1_PARAMS = {"objective": "regression_l1", "num_leaves": TRAIN_LEAVES,
             "max_bin": 255, "learning_rate": 0.1, "metric": "l1",
             "verbosity": -1}


def make_multiclass_like(n_rows: int, num_class: int,
                         n_features: int = 28, seed: int = 0):
    """Higgs-style dense features with a K-way label whose classes are
    separated by hidden per-class split structure (the generator of
    ``bench.py --multiclass K``, the 5-class softmax cell of
    BASELINE.json): every class gets a private feature-pair threshold
    rule on top of a shared linear field."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_rows, n_features)).astype(np.float32)
    w = rng.normal(size=(n_features, num_class))
    logits = (x @ w) * 0.4
    for c in range(num_class):
        j0, j1 = rng.choice(n_features, size=2, replace=False)
        t0, t1 = rng.normal(scale=0.5, size=2)
        logits[:, c] += 1.5 * np.logical_xor(x[:, j0] > t0,
                                             x[:, j1] > t1)
    y = np.argmax(logits + rng.gumbel(size=logits.shape),
                  axis=1).astype(np.float32)
    return x, y


def objective_label(objective: str, x: np.ndarray, seed: int) -> np.ndarray:
    """A seeded label ``objective`` accepts from rows ``x`` (NaN read as
    0): classes for the multiclass objectives, counts for poisson and
    tweedie, positive values for gamma, probabilities for the
    cross-entropies, and a continuous target with heavy-tailed noise
    (Student's t, 2 degrees of freedom: the user of l1 or huber) for the
    rest."""
    rng = np.random.default_rng(seed)
    xz = np.nan_to_num(x[:, :8]).astype(np.float64)
    t = xz @ rng.normal(size=8) * 0.5 + xz[:, 0] * xz[:, 1]
    noise = rng.standard_t(2, size=len(x))
    if objective.startswith("multiclass"):
        k = OVA_PARAMS["num_class"] if objective == "multiclassova" \
            else MC_CLASSES
        logits = xz[:, :k] + rng.gumbel(size=(len(x), k))
        return np.argmax(logits, axis=1).astype(np.float32)
    if objective in ("poisson", "tweedie"):
        return rng.poisson(np.exp(0.3 * np.tanh(t))).astype(np.float32)
    if objective == "gamma":
        return np.exp(0.3 * np.tanh(t) + 0.2 * rng.normal(size=len(x))
                      ).astype(np.float32)
    if objective.startswith("cross_entropy"):
        return (1.0 / (1.0 + np.exp(-t))).astype(np.float32)
    return (t + 0.5 * noise).astype(np.float32)


def relabel(ds, y: np.ndarray):
    """The constructed Dataset ``ds``'s bins under another label (no
    binning again)."""
    import copy

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.io.dataset_core import Metadata
    binned = copy.copy(ds._binned)
    binned.metadata = Metadata()
    binned.metadata.set_label(y)
    binned.metadata.check(binned.num_data)
    return lgt.Dataset.from_binned(binned)


def card_booster(params: dict, x, y, iters: int, env: dict):
    """``iters`` iterations on the card on the route ``env`` selects, the
    training kernels' launches counted: (booster, launches)."""
    import torch

    import lightgbm_tpu_torch as lgt
    counted = counted_training_kernels()
    with route_env(env):
        torch.cuda.synchronize()
        for fn in counted:
            fn.launches = 0
        bst = lgt.Booster(params, lgt.Dataset(x, label=y), device="cuda")
        for _ in range(iters):
            bst.update()
        torch.cuda.synchronize()
    return bst, {fn.__name__: fn.launches for fn in counted}


def objective_parities(gpu: str) -> dict:
    """The card against device="cpu" at 5,000 x 28, bitwise: softmax
    (K = 5) and one-vs-all (K = 3) for 1 iteration, the softmax at
    pack=2 (255 leaves) bitwise the pack=1 card trees (its record
    kernels counted), and 1 tree of each regression and cross-entropy
    objective on a label it accepts (one tree, 5,000 rows and
    ``PARITY_CUT_LEAVES`` leaves each but the pack=2 pair: the script's
    time budget)."""
    x = make_rows(OBJ_PARITY_ROWS, N_FEATURES, 3)
    out = {}
    for name, params in (("multiclass", MC_PARAMS),
                         ("multiclassova", OVA_PARAMS)):
        params = dict(params, num_leaves=PARITY_CUT_LEAVES)
        rec = train_parity(gpu, {}, MC_PARITY_ITERS, name, params=params,
                           bitwise=True, y=objective_label(name, x, 5),
                           rows=OBJ_PARITY_ROWS)
        if rec["route"] != MC_ROUTE:
            raise RuntimeError(f"{name} trained on {rec['route']}")
        out[name] = rec
    y = objective_label("multiclass", x, 5)
    p1, _ = card_booster(MC_PARAMS, x, y, MC_PARITY_ITERS, {})
    p2, launches = card_booster(MC_PARAMS, x, y, MC_PARITY_ITERS, PACK2)
    if p2._inner.grow.route.pack != 2:
        raise RuntimeError("the pack=2 multiclass run trained pack=1")
    out["multiclass_pack2"] = _same_trees(p1, p2, "multiclass pack=2 route")
    out["multiclass_pack2"]["launches"] = {k: v for k, v in launches.items()
                                           if v}
    for name, extra in OBJ_PARITY.items():
        params = dict(TRAIN_PARAMS, objective=name, metric="None",
                      num_leaves=PARITY_CUT_LEAVES, **extra)
        rec = train_parity(gpu, {}, OBJ_PARITY_TREES, name, params=params,
                           bitwise=True, y=objective_label(name, x, 7),
                           rows=OBJ_PARITY_ROWS)
        if rec["route"] != OBJ_ROUTE:
            raise RuntimeError(f"{name} trained on {rec['route']}")
        out[name] = rec
    return out


def multiclass_holdout(y_train: np.ndarray, yv: np.ndarray):
    """The multiclass main path's holdout gate: ``multi_logloss`` below
    the class-prior model's."""
    counts = np.bincount(y_train.astype(np.int64), minlength=MC_CLASSES)
    prior = counts / counts.sum()
    prior_loss = float(-np.mean(np.log(prior[yv.astype(np.int64)])))

    def gate(bst) -> dict:
        got = bst.best_score["valid_0"]
        if not got["multi_logloss"] < prior_loss:
            raise RuntimeError(f"holdout multi_logloss "
                               f"{got['multi_logloss']} is not below the "
                               f"class prior's {prior_loss}")
        return {"holdout_multi_logloss": got["multi_logloss"],
                "holdout_multi_error": got["multi_error"],
                "prior_multi_logloss": prior_loss}
    return gate


def l1_holdout(y_train: np.ndarray, yv: np.ndarray):
    """The l1 main path's holdout gate: ``l1`` below the constant-median
    model's."""
    const = float(np.mean(np.abs(yv - np.median(y_train))))

    def gate(bst) -> dict:
        got = bst.best_score["valid_0"]["l1"]
        if not got < const:
            raise RuntimeError(f"holdout l1 {got} is not below the "
                               f"constant median's {const}")
        return {"holdout_l1": got, "median_l1": const}
    return gate


def multiclass_phases(gpu: str) -> dict:
    """Slice 19: the objectives' parity runs (:func:`objective_parities`),
    then the multiclass main path at full width (``bench.py --multiclass
    5``'s cell: 1M x 28 training and 100,000 holdout rows, 5-class
    softmax, 255 leaves, 2 iterations, 10 trees) on the kernel-tail
    physical route, counted, its holdout ``multi_logloss`` below the
    class prior's, the booster served through serve_traverse (every
    class's raw scores within 64 ulps a tree of the training scores and
    of the f64 host walk at 4,096 holdout rows, the probabilities
    summing to 1 within 1e-6), one profiled iteration; then the l1 main
    path on the same rows with a heavy-tailed continuous target (3
    iterations, its leaf renewal timed as a stage of its own), its
    holdout ``l1`` below the constant median's."""
    import lightgbm_tpu_torch as lgt
    parity = objective_parities(gpu)
    lap("multiclass/parity")
    x_all, y_all = make_multiclass_like(TRAIN_ROWS + HOLDOUT_ROWS,
                                        MC_CLASSES, seed=0)
    x, y = x_all[:TRAIN_ROWS], y_all[:TRAIN_ROWS]
    xv, yv = x_all[TRAIN_ROWS:], y_all[TRAIN_ROWS:]
    t0 = time.perf_counter()
    ds = lgt.Dataset(x, label=y, params={"max_bin": 255}).construct()
    valid = lgt.Dataset(xv, label=yv, reference=ds).construct()
    print(f"binned {TRAIN_ROWS} + {HOLDOUT_ROWS} rows x {N_FEATURES} "
          f"(multiclass) in {time.perf_counter() - t0:.2f} s (host)",
          flush=True)
    bst, run = train_main_path(gpu, ds, valid, x, {}, MC_ITERS,
                               "multiclass main path", params=MC_PARAMS,
                               holdout=multiclass_holdout(y, yv))
    if run["route"] != MC_ROUTE:
        raise RuntimeError(f"the multiclass main path took {run['route']}")
    if any(t.num_leaves <= 1 for t in bst._models):
        raise RuntimeError("a multiclass main-path tree is a stump")
    k = MC_CLASSES
    xh = np.array(xv[:HOST_ROWS], np.float64)
    served = bst.predict(xh, raw_score=True)
    host = np.stack([sum(t.leaf_value[t.predict_leaf(xh)]
                         for t in bst._models[c::k]) for c in range(k)],
                    axis=1)
    if not np.all(np.abs(served - host)
                  <= score_tolerance(host, len(bst._models) // k)):
        raise RuntimeError("served multiclass scores differ from the host "
                           "walk")
    prob = bst.predict(xv)
    sums = np.abs(prob.sum(axis=1) - 1.0).max()
    if prob.shape != (HOLDOUT_ROWS, k) or not sums <= 1e-6:
        raise RuntimeError(f"multiclass probabilities of shape "
                           f"{prob.shape} sum to 1 only within {sums}")
    run.update(host_walk_rows=HOST_ROWS, probability_sum_err=float(sums))
    with route_env({}):
        prof = profile_iteration(bst, gpu)
    print("profiled iteration, multiclass main path " + json.dumps(prof),
          flush=True)
    lap("multiclass/main path")
    y1_all = objective_label("regression_l1", x_all, 11)
    y1, yv1 = y1_all[:TRAIN_ROWS], y1_all[TRAIN_ROWS:]
    bst1, run1 = train_main_path(gpu, relabel(ds, y1), relabel(valid, yv1),
                                 x, {}, L1_ITERS, "l1 main path",
                                 params=L1_PARAMS,
                                 holdout=l1_holdout(y1, yv1))
    if run1["route"] != OBJ_ROUTE:
        raise RuntimeError(f"the l1 main path took {run1['route']}")
    renew = run1["stage_ms_per_tree"].get("leaf_renew")
    if renew is None:
        raise RuntimeError("the l1 main path renewed no leaves")
    print("objective routes " + json.dumps({
        "multiclass": {key: run[key] for key in (
            "route", "s_per_iter_rest_mean", "holdout_multi_logloss",
            "holdout_multi_error", "prior_multi_logloss", "splits")},
        "multiclass_profiled": {key: prof.get(key) for key in (
            "kernels_per_split", "busy_share", "wall_ms")},
        "l1": {key: run1[key] for key in (
            "route", "s_per_iter_rest_mean", "holdout_l1", "median_l1")},
        "l1_leaf_renew_ms_per_tree": renew, "gpu": gpu}), flush=True)
    return {"parity": parity, "multiclass": run, "l1": run1,
            "profile": prof}


# ---------------------------------------------------------------------
# Slice 20: bagging, GOSS and random-forest boosting
BAG_PARAMS = dict(TRAIN_PARAMS, bagging_fraction=0.8, bagging_freq=5,
                  feature_fraction=0.8)
GOSS_PARAMS = dict(TRAIN_PARAMS, boosting="goss", top_rate=0.2,
                   other_rate=0.1)
RF_PARAMS = dict(TRAIN_PARAMS, boosting="rf", bagging_fraction=0.7,
                 bagging_freq=1, feature_fraction=0.8)
# (params, iterations, route) of each main path: the example's bagging,
# GOSS sampling from its 11th iteration (1 / learning_rate of warm-up)
SAMPLING_MAIN = {
    "bagging": (BAG_PARAMS, 10,
                "path=physical fused=1 tail=kernel (bagging_on)"),
    "goss": (GOSS_PARAMS, 12,
             "path=physical fused=1 tail=kernel (boosting_not_gbdt)"),
    "rf": (RF_PARAMS, 3, "path=physical fused=1 tail=kernel "
           "(boosting_not_gbdt, bagging_on)"),
}
# (params, trees) of each card-against-CPU run at OBJ_PARITY_ROWS
SAMPLING_PARITY = {
    "bagging": (dict(TRAIN_PARAMS, bagging_fraction=0.8, bagging_freq=1), 2),
    "pos_bagging": (dict(TRAIN_PARAMS, pos_bagging_fraction=0.5,
                         bagging_freq=1), 2),
    "goss": (dict(TRAIN_PARAMS, boosting="goss", learning_rate=0.5), 3),
    "rf": (dict(TRAIN_PARAMS, boosting="rf", bagging_fraction=0.7,
                bagging_freq=1), 2),
}
SAMPLE_REPS = 20


def _event_ms(fn, reps: int = SAMPLE_REPS) -> float:
    """Median device time of ``fn()`` over ``reps`` calls, each between
    two CUDA events."""
    import torch
    fn()
    out = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1))
    return float(np.median(out))


def sampling_draws(gpu: str, bag, goss) -> dict:
    """The card's draws against the same draws on the CPU, bitwise, at
    the main path's rows: the bagging main path's mask at iterations 0
    and 5 (``GBDT._bagging_mask`` run on a CPU stand-in of the booster)
    and the GOSS main path's sample at its last iteration from its own
    gradients (``GOSS._sample`` on CPU copies); each timed on the card."""
    import torch

    from lightgbm_tpu_torch.models.gbdt import GBDT
    from lightgbm_tpu_torch.models.goss import GOSS
    n = bag.train_set.num_data
    cpu = torch.device("cpu")
    twin = types.SimpleNamespace(config=bag.config, _cached_bag=None,
                                 train_set=bag.train_set, device=cpu,
                                 _label_pos=None)
    out = {"rows": n}
    for it in (0, 5):
        card = bag._bagging_mask(it).cpu()
        host = GBDT._bagging_mask(twin, it)
        if not torch.equal(card, host):
            raise RuntimeError(f"the card's bagging mask of iteration {it} "
                               "differs from the CPU's")
        out[f"bagging_it{it}_in_bag"] = int(card.sum())
    out["bagging_draw_ms"] = _event_ms(lambda: bag._bagging_mask(0))
    grad, hess = goss._gradients()
    it = goss.iter_ - 1
    card = GOSS._sample(goss, grad, hess, it)
    stand_in = types.SimpleNamespace(config=goss.config,
                                     _valid_rows=torch.ones(n))
    host = GOSS._sample(stand_in, grad.cpu(), hess.cpu(), it)
    if not all(torch.equal(a.cpu(), b) for a, b in zip(card, host)):
        raise RuntimeError("the card's GOSS sample differs from the CPU's")
    out["goss_in_bag"] = int(card[2].sum())
    out["goss_sample_ms"] = _event_ms(
        lambda: GOSS._sample(goss, grad, hess, it))
    out["gpu"] = gpu
    print("sampling draws " + json.dumps(out), flush=True)
    return out


def sampling_parities(gpu: str) -> dict:
    """The card against device="cpu" at 5,000 x 28, 31 leaves,
    bitwise, for each of ``SAMPLING_PARITY``, and the bagging run at
    pack=2 bitwise the pack=1 card trees (its record kernels counted)."""
    out = {}
    for name, (params, trees) in SAMPLING_PARITY.items():
        out[name] = train_parity(
            gpu, {}, trees, name,
            params=dict(params, num_leaves=PARITY_CUT_LEAVES), bitwise=True,
            rows=OBJ_PARITY_ROWS)
    x = make_rows(OBJ_PARITY_ROWS, N_FEATURES, 3)
    _, y = make_higgs_like(OBJ_PARITY_ROWS, N_FEATURES, 3)
    params, trees = SAMPLING_PARITY["bagging"]
    p1, _ = card_booster(params, x, y, trees, {})
    p2, launches = card_booster(params, x, y, trees, PACK2)
    if p2._inner.grow.route.pack != 2:
        raise RuntimeError("the pack=2 bagging run trained pack=1")
    out["bagging_pack2"] = _same_trees(p1, p2, "bagging pack=2 route")
    out["bagging_pack2"]["launches"] = {k: v for k, v in launches.items()
                                        if v}
    return out


def sampling_phases(gpu: str, higgs: dict) -> dict:
    """Slice 20: the card-against-CPU runs (:func:`sampling_parities`),
    then bagging, GOSS and RF at full width on the training main path's
    rows (``SAMPLING_MAIN``), each counted, its holdout AUC above 0.5
    and printed beside the default route's, its in-bag rows a tree (the
    root's count), served through serve_traverse within 64 ulps a tree
    of the f64 host walk on 4,096 holdout rows (RF: the walk's average),
    the draws held against the CPU's (:func:`sampling_draws`), and one
    profiled iteration each."""
    parity = sampling_parities(gpu)
    lap("sampling/parity")
    ds, valid, x, xv = higgs["ds"], higgs["valid"], higgs["x"], higgs["xv"]
    xh = np.array(xv[:HOST_ROWS], np.float64)
    bsts, runs = {}, {}
    for mode, (params, iters, want) in SAMPLING_MAIN.items():
        bst, run = train_main_path(gpu, ds, valid, x, {}, iters,
                                   f"{mode} main path", params=params)
        if run["route"] != want:
            raise RuntimeError(f"the {mode} main path took {run['route']}")
        served = bst.predict(xh, raw_score=True)
        host = sum(t.leaf_value[t.predict_leaf(xh)] for t in bst._models)
        if bst._inner.average_output:
            host = host / len(bst._models)
        tol = score_tolerance(host, len(bst._models))
        if not np.all(np.abs(served - host) <= tol):
            raise RuntimeError(f"the {mode} main path's served scores "
                               "differ from the host walk")
        run.update(in_bag_rows=[int(t.internal_count[0])
                                for t in bst._models],
                   host_walk_rows=HOST_ROWS,
                   host_walk_max_abs_err=float(np.abs(served - host).max()),
                   default_route_auc=higgs["auc"])
        bsts[mode], runs[mode] = bst, run
    lap("sampling/main paths")
    draws = sampling_draws(gpu, bsts["bagging"]._inner, bsts["goss"]._inner)
    profiles = {}
    with route_env({}):
        for mode, bst in bsts.items():
            profiles[mode] = profile_iteration(bst, gpu)
            print(f"profiled iteration, {mode} main path "
                  + json.dumps(profiles[mode]), flush=True)
    summary = {mode: {
        "route": run["route"], "iterations": run["iterations"],
        "s_per_iter_rest_mean": run["s_per_iter_rest_mean"],
        "sample_ms_per_iter": run["stage_ms_per_tree"].get("sample"),
        "holdout_auc": run["holdout_auc"],
        "default_route_auc": run["default_route_auc"],
        "in_bag_rows": run["in_bag_rows"], "splits": run["splits"],
        "kernels_per_split": profiles[mode].get("kernels_per_split"),
        "busy_share": profiles[mode].get("busy_share")}
        for mode, run in runs.items()}
    summary["draws"] = {k: v for k, v in draws.items() if k != "gpu"}
    summary["gpu"] = gpu
    print("sampling routes " + json.dumps(summary), flush=True)
    return {"parity": parity, "main": runs, "draws": draws,
            "profile": profiles}


# ---------------------------------------------------------------------
# Slice 21: learning to rank with DART (BASELINE.json's fourth
# configuration, examples/lambdarank's train.conf at MSLR-WEB30K's width)
RANK_PARAMS = {"objective": "lambdarank", "boosting": "dart",
               "metric": "ndcg", "eval_at": [1, 3, 5],
               "min_data_in_leaf": 50, "min_sum_hessian_in_leaf": 5.0,
               "learning_rate": 0.1, "max_bin": 255,
               "num_leaves": TRAIN_LEAVES, "verbosity": -1,
               # DART's defaults (drop_rate 0.1, skip_drop 0.5) drop no
               # tree in 10 iterations from the default drop_seed 4 (the
               # first drop is at iteration 12); seed 11 drops [0],
               # [0, 1] and [6] at iterations 2, 3 and 7
               "drop_seed": 11}
RANK_ITERS = 5
# the drop sets of the first 10 iterations; the main path checks its
# RANK_ITERS first
RANK_DROPS = [[], [], [0], [0, 1], [], [], [], [6], [], []]
RANK_ROUTE = ("path=physical fused=0 tail=kernel (objective_not_streamable, "
              "boosting_not_gbdt, fused_smem)")
RANK_TWIN_ROUTE = ("path=physical fused=0 tail=kernel "
                   "(objective_not_streamable, fused_smem)")
RANK_PARITY_ROWS = 10_000
# (params, iterations) of each card-against-CPU run at RANK_PARITY_ROWS x
# 28: lambdarank DART dropping from its third iteration ([], [], [1], [0]
# from drop_seed 4), rank_xendcg GBDT
RANK_PARITY = {
    "lambdarank_dart": (dict(RANK_PARAMS, drop_rate=0.5, skip_drop=0.0,
                             drop_seed=4), 4),
    "rank_xendcg": (dict(RANK_PARAMS, objective="rank_xendcg",
                         boosting="gbdt"), 2),
}


def rank_labels(x: np.ndarray, seed: int) -> np.ndarray:
    """Relevance grades 0-4 from a seeded, noisy function of the rows'
    first 16 features (NaN read as 0): half the documents 0, 30 % 1,
    13 % 2, 5 % 3 and 2 % 4, about MSLR-WEB30K's mix."""
    rng = np.random.default_rng(seed)
    xz = np.nan_to_num(x[:, :16]).astype(np.float64)
    t = (xz @ rng.normal(size=xz.shape[1]) * 0.4
         + 0.6 * xz[:, 0] * xz[:, 1] - 0.4 * np.abs(xz[:, 2])
         + rng.normal(size=len(x)))
    return np.digitize(t, np.quantile(t, [0.5, 0.8, 0.93, 0.98])).astype(
        np.float32)


def rank_groups(n: int, seed: int, lo: int = 20, hi: int = 236
                ) -> np.ndarray:
    """Seeded query sizes of ``lo``-``hi`` documents (mean 128, near
    MSLR-WEB30K's ~120) over ``n`` rows in order; the last query takes
    the rest (into the one before it when under ``lo``: at most 255)."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(lo, hi + 1, size=n // lo + 1)
    ends = np.cumsum(sizes)
    q = int(np.searchsorted(ends, n))
    sizes = sizes[:q + 1].copy()
    sizes[-1] = n - (int(ends[q - 1]) if q else 0)
    if sizes[-1] < lo and len(sizes) > 1:
        sizes[-2] += sizes[-1]
        sizes = sizes[:-1]
    return sizes


def regroup(ds, y: np.ndarray, group: np.ndarray):
    """The constructed Dataset ``ds``'s bins under another label and query
    groups (no binning again)."""
    import copy

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.io.dataset_core import Metadata
    binned = copy.copy(ds._binned)
    binned.metadata = Metadata()
    binned.metadata.num_data = binned.num_data
    binned.metadata.set_label(y)
    binned.metadata.set_group(group)
    binned.metadata.check(binned.num_data)
    return lgt.Dataset.from_binned(binned)


def ranking_holdout(yv: np.ndarray, gv: np.ndarray):
    """The ranking main paths' holdout gate: each ``ndcg@k`` above the
    documents' own order's (a random order: the rows are drawn
    independently)."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.dataset_core import Metadata
    from lightgbm_tpu_torch.metric import create_metrics
    md = Metadata()
    md.num_data = len(yv)
    md.set_label(yv)
    md.set_group(gv)
    (metric,) = create_metrics(Config.from_params(
        {"metric": "ndcg", "eval_at": RANK_PARAMS["eval_at"]}))
    metric.init(md, len(yv))
    zero = np.zeros(len(yv))
    base = {name: v for name, v, _ in metric.eval(zero, zero)}

    def gate(bst) -> dict:
        got = bst.best_score["valid_0"]
        for name, v in base.items():
            if not got[name] > v:
                raise RuntimeError(f"holdout {name} {got[name]} is not above "
                                   f"the documents' own order's {v}")
        return {"holdout_ndcg": {k: got[k] for k in base},
                "own_order_ndcg": base}
    return gate


def rank_parity(gpu: str, name: str, params: dict, iters: int) -> dict:
    """``iters`` iterations of ``params`` at ``PARITY_CUT_LEAVES`` leaves
    on a seeded 10,000 x 28 ranking set (``make_rows``' missing values,
    ``rank_labels``, ``rank_groups``)
    trained on the card and with device="cpu": the trees must be equal
    and their leaves bitwise, and the drop sets equal."""
    import lightgbm_tpu_torch as lgt
    x = make_rows(RANK_PARITY_ROWS, N_FEATURES, 3)
    y = rank_labels(x, 7)
    group = rank_groups(RANK_PARITY_ROWS, 8)
    out = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        bst = lgt.Booster(dict(params, num_leaves=PARITY_CUT_LEAVES),
                          lgt.Dataset(x, label=y, group=group),
                          device=device)
        drops = []
        for _ in range(iters):
            bst.update()
            drops.append(list(getattr(bst._inner, "drop_index", [])))
        out[device] = (bst, drops, time.perf_counter() - t0)
    (bc, dc, tc), (bp, dp, tp) = out["cuda"], out["cpu"]
    rec = compare_trees(bc._models, bp._models)
    rec.update(case=f"{name}: {RANK_PARITY_ROWS}x{N_FEATURES}, "
               f"{len(group)} queries, {PARITY_CUT_LEAVES} leaves, {iters} "
               "iterations", route=bc._inner.grow.route.describe(),
               drop_sets=dc, cuda_s=tc, cpu_s=tp,
               leaves_bitwise=leaves_bitwise(bc._models, bp._models),
               leaves=[t.num_leaves for t in bc._models])
    rec["ok"] = rec["ok"] and rec["leaves_bitwise"] and dc == dp
    print("parity ranking " + json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise RuntimeError(f"ranking training on the card differs from the "
                           f"CPU run: {rec}")
    return rec


def rank_gradient_parity(gpu: str, bst, label: str, score,
                         queries=None) -> dict:
    """The main path's lambdarank gradients on the card against the plain
    CPU run of the same function (the objective initialised on the CPU
    from the same metadata) on the same scores, over every query or the
    first ``queries`` (a query's gradients read its own rows only): the
    largest difference, within 4 f32 eps of the largest gradient, and
    the card's time."""
    import torch

    from lightgbm_tpu_torch.io.dataset_core import Metadata
    from lightgbm_tpu_torch.objective import create_objective
    inner = bst._inner
    card = inner.objective
    md = inner.train_set.metadata
    qb = md.query_boundaries
    if queries is not None and queries >= len(qb) - 1:
        queries = None
    n = int(qb[queries]) if queries is not None else inner.train_set.num_data
    if queries is not None:
        part = Metadata()
        part.num_data = n
        part.set_label(md.label[:n])
        part.set_group(qb[:queries + 1])
        md = part
    host = create_objective(inner.config)
    host.init(md, n, torch.device("cpu"))
    t0 = time.perf_counter()
    want = host.get_gradients(score[:n].cpu())
    cpu_s = time.perf_counter() - t0
    got = [v[:n].cpu() for v in card.get_gradients(score)]
    err = [float((a - b).abs().max()) for a, b in zip(got, want)]
    scale = [float(b.abs().max()) for b in want]
    rec = {"case": label, "rows": n, "queries": host.num_queries,
           "batches": len(card.batches),
           "max_abs_err": err, "max_abs": scale,
           "bitwise": all(torch.equal(a, b) for a, b in zip(got, want)),
           "cpu_s": cpu_s, "card_ms": _event_ms(
               lambda: card.get_gradients(score), reps=5), "gpu": gpu}
    print("lambdarank gradients " + json.dumps(rec), flush=True)
    tol = 4 * np.finfo(np.float32).eps
    if not all(e <= tol * max(m, 1e-30) for e, m in zip(err, scale)):
        raise RuntimeError(f"the card's lambdarank gradients differ from "
                           f"the CPU run's: {rec}")
    return rec


def ranking_phases(gpu: str, wide: dict) -> dict:
    """Slice 21: the card-against-CPU runs (:func:`rank_parity`: lambdarank
    DART and rank_xendcg at 10,000 x 28), then lambdarank DART on the
    wide phase's binned 1M x 136 rows (``RANK_PARAMS``, 5 iterations)
    with seeded grades and query groups (``rank_labels``,
    ``rank_groups``: ~7,800 training queries, the 100,000 holdout rows
    in their own), on the wide route without the stream, counted, its
    stages and drop sets, its holdout ``ndcg@1/3/5`` against a GBDT
    twin's, the lambdarank gradients of its first iteration (every
    query) and of its trained scores (the first 1,000) held against the
    CPU's
    (:func:`rank_gradient_parity`), the model saved and loaded
    predicting the booster's holdout scores, and one profiled
    iteration."""
    import torch

    import lightgbm_tpu_torch as lgt
    parity = {name: rank_parity(gpu, name, params, iters)
              for name, (params, iters) in RANK_PARITY.items()}
    lap("ranking/parity")
    data = wide["data"]
    x, xv = data["x"], data["xv"]
    y_all = rank_labels(np.concatenate([x, xv]), 21)
    y, yv = y_all[:len(x)], y_all[len(x):]
    group = rank_groups(len(y), 23)
    gv = rank_groups(len(yv), 24)
    ds = regroup(data["ds"], y, group)
    valid = regroup(data["valid"], yv, gv)
    gate = ranking_holdout(yv, gv)
    drops = []

    def _drops(env):
        drops.append(list(env.model._inner.drop_index))
    _drops.order = 41
    bst, run = train_main_path(gpu, ds, valid, x, {}, RANK_ITERS,
                               "ranking main path", params=RANK_PARAMS,
                               n_features=WIDE_FEATURES, holdout=gate,
                               callbacks=[_drops])
    if run["route"] != RANK_ROUTE:
        raise RuntimeError(f"the ranking main path took {run['route']}, "
                           f"expected {RANK_ROUTE}")
    if drops != RANK_DROPS[:RANK_ITERS]:
        raise RuntimeError(f"the ranking main path dropped {drops}, "
                           f"expected {RANK_DROPS[:RANK_ITERS]}")
    for stage in ("gradients", "dart"):
        if stage not in run["stage_ms_per_tree"]:
            raise RuntimeError(f"the ranking main path timed no {stage} "
                               "stage")
    run.update(drop_sets=drops, queries=len(group),
               holdout_queries=len(gv),
               grades=np.bincount(y.astype(np.int64)).tolist(),
               largest_query=int(max(group.max(), gv.max())))
    lap("ranking/main path")
    twin, twin_run = train_main_path(
        gpu, ds, valid, x, {}, RANK_ITERS, "ranking GBDT twin",
        params=dict(RANK_PARAMS, boosting="gbdt"), n_features=WIDE_FEATURES,
        holdout=gate)
    if twin_run["route"] != RANK_TWIN_ROUTE:
        raise RuntimeError(f"the ranking twin took {twin_run['route']}")
    lap("ranking/GBDT twin")
    n = len(y)
    grads = {"first_iteration": rank_gradient_parity(
        gpu, bst, "ranking main path, first iteration (zero scores)",
        torch.zeros(n, device=bst._inner.device)),
        "trained": rank_gradient_parity(
        gpu, bst, "ranking main path, trained scores, first 1,000 queries",
        bst._inner.train_score, queries=1000)}
    lap("ranking/gradient parity")
    loaded = lgt.Booster(model_str=bst.model_to_string(), device="cuda")
    served = loaded.predict(xv, raw_score=True)
    held = bst._inner.valid_sets[0].scores[0].cpu().numpy().astype(
        np.float64)
    serve_err = float(np.abs(served - held).max())
    if not np.all(np.abs(served - held)
                  <= score_tolerance(held, len(bst._models))):
        raise RuntimeError(f"the loaded DART model's holdout scores differ "
                           f"from the booster's (max {serve_err})")
    with route_env({}):
        prof = profile_iteration(bst, gpu)
    print("profiled iteration, ranking main path " + json.dumps(prof),
          flush=True)
    # the kernels one gradient pass launches, from a captured graph (last:
    # a capture the CUDA driver refused would leave the stream unusable)
    try:
        names = [k for k, _ in kernels_of_call(
            lambda: bst._inner.objective.get_gradients(
                bst._inner.train_score))]
        graph = {"kernels": len(names),
                 "by_name": {k: names.count(k) for k in sorted(set(names))}}
    except Exception as e:      # noqa: BLE001 - reported, not measured
        graph = {"kernels": f"not measured: {type(e).__name__}: {e}"}
    summary = {
        "route": run["route"], "iterations": RANK_ITERS,
        "s_per_iter_rest_mean": run["s_per_iter_rest_mean"],
        "twin_s_per_iter_rest_mean": twin_run["s_per_iter_rest_mean"],
        "stage_ms_per_tree": run["stage_ms_per_tree"],
        "twin_stage_ms_per_tree": twin_run["stage_ms_per_tree"],
        "drop_sets": drops, "holdout_ndcg": run["holdout_ndcg"],
        "twin_holdout_ndcg": twin_run["holdout_ndcg"],
        "own_order_ndcg": run["own_order_ndcg"],
        "queries": len(group), "holdout_queries": len(gv),
        "splits": run["splits"],
        "launches": {k: v for k, v in run["launches"].items() if v},
        "launches_per_split": {k: v / run["splits"] for k, v in
                               run["launches"].items() if v},
        "kernels_per_split": prof.get("kernels_per_split"),
        "stage_kernels_per_split": prof.get("stage_kernels_per_split"),
        "busy_share": prof.get("busy_share"),
        "gradient_card_ms": {k: g["card_ms"] for k, g in grads.items()},
        "gradient_graph_kernels": graph,
        "gradient_max_abs_err": {k: g["max_abs_err"]
                                 for k, g in grads.items()},
        "loaded_model_holdout_max_abs_err": serve_err, "gpu": gpu}
    print("ranking route " + json.dumps(summary), flush=True)
    return {"parity": parity, "main": run, "twin": twin_run,
            "gradients": grads, "gradient_graph": graph, "profile": prof}


# ---------------------------------------------------------------------
# Slice 22: the split options on the PyTorch split tail (interaction
# constraints, CEGB, forced splits, feature_fraction_bynode, extra_trees)
SPLIT_ITERS = 2
SPLIT_PARITY_TREES = 2
# the UCI HIGGS columns' groups: the lepton and the missing energy, each
# of the four jets, the seven derived masses
HIGGS_SETS = [list(range(0, 5)), list(range(5, 9)), list(range(9, 13)),
              list(range(13, 17)), list(range(17, 21)), list(range(21, 28))]
# CEGB costs on the derived masses (columns 21-27), the features that
# cost to compute: CEGB_COST is near the median gain of the twin's splits
# on them at 1M rows (PERF.md section 4), so their first use in a tree
# must beat the other columns by that much; the per-row split penalty
# stays far below every split's gain per row
CEGB_COLS = range(21, 28)
CEGB_COST = 150.0
CEGB_SPLIT = 5e-4
CEGB_COSTS = [CEGB_COST if c in CEGB_COLS else 0.0
              for c in range(N_FEATURES)]
# the shape of LightGBM's examples/binary_classification/forced_splits.json
FORCED_SPLITS = {"feature": 25, "threshold": 1.30,
                 "left": {"feature": 26, "threshold": 0.85},
                 "right": {"feature": 26, "threshold": 0.85}}
SPLIT_ROUTE = "path=stream fused=1 tail=xla ({})"
# (extra params, route) of each split option's main path
SPLIT_OPTIONS = {
    "interaction": ({"interaction_constraints": HIGGS_SETS},
                    SPLIT_ROUTE.format("tail_interaction")),
    "cegb_coupled": ({"cegb_penalty_split": CEGB_SPLIT,
                      "cegb_penalty_feature_coupled": CEGB_COSTS},
                     SPLIT_ROUTE.format("tail_cegb")),
    "cegb_lazy": ({"cegb_penalty_split": CEGB_SPLIT,
                   "cegb_penalty_feature_lazy": CEGB_COSTS},
                  "path=row_order fused=0 tail=xla (cegb_lazy, tail_cegb)"),
    "forced": ({"forcedsplits_filename": None},
               SPLIT_ROUTE.format("tail_forced")),
    "bynode": ({"feature_fraction_bynode": 0.5, "feature_fraction": 0.8},
               SPLIT_ROUTE.format("tail_bynode")),
    "extra_trees": ({"extra_trees": True, "extra_seed": 6},
                    SPLIT_ROUTE.format("tail_extra_trees")),
}


def forced_splits_file() -> str:
    """``FORCED_SPLITS`` written under the checkout's build directory."""
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "lightgbm_tpu_torch", "build")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "forced_splits.json")
    with open(path, "w") as fh:
        json.dump(FORCED_SPLITS, fh)
    return path


def split_option_params(name: str) -> dict:
    extra = dict(SPLIT_OPTIONS[name][0])
    if "forcedsplits_filename" in extra:
        extra["forcedsplits_filename"] = forced_splits_file()
    return dict(TRAIN_PARAMS, **extra)


def tree_paths(t) -> list:
    """The split features (raw columns) on each root-to-leaf path."""
    out, stack = [], [(0, ())]
    while stack:
        node, feats = stack.pop()
        feats = feats + (int(t.split_feature[node]),)
        for c in (int(t.left_child[node]), int(t.right_child[node])):
            if c >= 0:
                stack.append((c, feats))
            else:
                out.append(feats)
    return out


def interaction_violations(models, sets) -> int:
    """Root-to-leaf paths whose features no one interaction set holds."""
    sets = [set(s) for s in sets]
    return sum(not any(set(p) <= s for s in sets)
               for t in models if t.num_leaves > 1 for p in tree_paths(t))


def splits_on(models, cols) -> int:
    return int(sum(np.isin(t.split_feature[:t.num_leaves - 1],
                           list(cols)).sum() for t in models))


def forced_nodes_on_top(models, ds) -> dict:
    """Whether every tree's first three nodes are the forced ones: node 0
    on column 25 at the bin of 1.30, its children nodes 1 and 2 on column
    26 at the bin of 0.85 (every forced child here is non-empty)."""
    inner = {int(c): j for j, c in enumerate(ds.used_feature_map)}
    b25 = int(ds.mappers[inner[25]].values_to_bins(np.array([1.30]))[0])
    b26 = int(ds.mappers[inner[26]].values_to_bins(np.array([0.85]))[0])
    ok = all(t.num_leaves >= 4
             and [int(v) for v in t.split_feature[:3]] == [25, 26, 26]
             and [int(v) for v in t.threshold_bin[:3]] == [b25, b26, b26]
             and int(t.left_child[0]) == 1 and int(t.right_child[0]) == 2
             for t in models)
    return {"ok": ok, "bins": [b25, b26],
            "root_counts": [[float(c) for c in t.internal_count[:3]]
                            for t in models]}


def split_draws(gpu: str) -> dict:
    """A tree's node draws (``utils/random``: fold_in keys over the 2L - 1
    node salts, then a uniform row a node) on the card bitwise the CPU's,
    timed on the card."""
    import torch

    from lightgbm_tpu_torch.utils.random import fold_in, prng_key, uniform_rows

    def draw(dev):
        salts = torch.arange(2 * TRAIN_LEAVES - 1, dtype=torch.int64,
                             device=dev)
        keys = fold_in(fold_in(prng_key(6), 7, dev), salts)
        return uniform_rows(keys, N_FEATURES, dev)
    card, host = draw("cuda"), draw("cpu")
    if not torch.equal(card.cpu(), host):
        raise RuntimeError("the card's node draws differ from the CPU's")
    out = {"nodes": 2 * TRAIN_LEAVES - 1, "features": N_FEATURES,
           "bitwise": True, "draw_ms": _event_ms(lambda: draw("cuda")),
           "gpu": gpu}
    print("split draws " + json.dumps(out), flush=True)
    return out


def split_option_phases(gpu: str, higgs: dict) -> dict:
    """Slice 22: each split option (``SPLIT_OPTIONS``) trained on the card
    against device="cpu" at 5,000 x 28, 31 leaves, 2 trees (bitwise),
    then on the training main path's 1M rows (``TRAIN_PARAMS``, 2
    iterations) on its route, counted against ``expected_launches``,
    its holdout AUC beside the default route's booster at 2 iterations,
    its gate (no path leaving one interaction set; fewer splits on
    columns 21-27 than that booster's first 2 trees under coupled and
    lazy CEGB; the forced nodes on top of every tree; trees other than
    the twin's under by-node sampling and extra trees), one profiled
    iteration; the node draws bitwise (:func:`split_draws`)."""
    from lightgbm_tpu_torch.metric.metrics import _weighted_auc
    parity = {}
    for name in SPLIT_OPTIONS:
        parity[name] = train_parity(
            gpu, {}, SPLIT_PARITY_TREES, f"split options {name}",
            params=dict(split_option_params(name),
                        num_leaves=PARITY_CUT_LEAVES),
            bitwise=True, rows=OBJ_PARITY_ROWS)
    draws = split_draws(gpu)
    lap("split options/parity")
    ds, valid, x, xv = higgs["ds"], higgs["valid"], higgs["x"], higgs["xv"]
    twin = higgs["bst"]._models[:SPLIT_ITERS]
    twin_auc = _weighted_auc(
        higgs["yv"], higgs["bst"].predict(xv, raw_score=True,
                                          num_iteration=SPLIT_ITERS), None)
    gains = np.concatenate([t.split_gain[:t.num_leaves - 1]
                            for t in higgs["bst"]._models])
    feats = np.concatenate([t.split_feature[:t.num_leaves - 1]
                            for t in higgs["bst"]._models])
    on_cols = np.isin(feats, list(CEGB_COLS))
    twin_gains = {
        "trees": len(higgs["bst"]._models),
        "splits": int(len(gains)), "splits_on_21_27": int(on_cols.sum()),
        "gain_quartiles": np.percentile(gains, [25, 50, 75]).tolist(),
        "gain_quartiles_21_27": (np.percentile(gains[on_cols], [25, 50, 75])
                                 .tolist() if on_cols.any() else None)}
    print("split options twin gains " + json.dumps(twin_gains), flush=True)
    runs, profiles, gates = {}, {}, {}
    for name, (_, want) in SPLIT_OPTIONS.items():
        params = split_option_params(name)
        bst, run = train_main_path(gpu, ds, valid, x, {}, SPLIT_ITERS,
                                   f"split options {name}", params=params)
        if run["route"] != want:
            raise RuntimeError(f"the {name} main path took {run['route']}")
        models = bst._models[:SPLIT_ITERS]
        if name == "interaction":
            gate = {"paths_leaving_a_set": interaction_violations(
                models, HIGGS_SETS)}
            ok = gate["paths_leaving_a_set"] == 0
        elif name.startswith("cegb"):
            gate = {"splits_on_21_27": splits_on(models, CEGB_COLS),
                    "twin_splits_on_21_27": splits_on(twin, CEGB_COLS),
                    "leaves": [t.num_leaves for t in models]}
            ok = (gate["splits_on_21_27"] < gate["twin_splits_on_21_27"]
                  and all(n == TRAIN_LEAVES for n in gate["leaves"]))
        elif name == "forced":
            gate = forced_nodes_on_top(models, ds._binned)
            ok = gate["ok"]
        else:
            gate = {"differs_from_twin": not compare_trees(
                models, twin)["ok"]}
            ok = gate["differs_from_twin"]
        if not ok:
            raise RuntimeError(f"the {name} main path fails its gate: {gate}")
        gates[name] = gate
        runs[name] = run
        profiles[name] = profile_iteration(bst, gpu)
        print(f"profiled iteration, split options {name} "
              + json.dumps(profiles[name]), flush=True)
        lap(f"split options/{name}")
    summary = {name: {
        "route": run["route"], "iterations": run["iterations"],
        "s_per_iter_first": run["s_per_iter_first"],
        "s_per_iter_rest_mean": run["s_per_iter_rest_mean"],
        "stage_ms_per_tree": run["stage_ms_per_tree"],
        "kernels_per_split": profiles[name].get("kernels_per_split"),
        "busy_share": profiles[name].get("busy_share"),
        "holdout_auc": run["holdout_auc"],
        "default_route_auc_same_iterations": twin_auc,
        "splits": run["splits"], "host_reads": run["host_reads"],
        "gate": gates[name],
        "parity_bitwise": parity[name]["ok"]}
        for name, run in runs.items()}
    summary["draws"] = {k: v for k, v in draws.items() if k != "gpu"}
    summary["twin_gains"] = twin_gains
    summary["costs"] = {"cegb_cost_21_27": CEGB_COST,
                        "cegb_penalty_split": CEGB_SPLIT}
    summary["gpu"] = gpu
    print("split options " + json.dumps(summary), flush=True)
    return {"parity": parity, "main": runs, "profile": profiles,
            "draws": draws}


# -- slice 23: linear trees, gpu_use_dp, init_model, rollback_one_iter -------
LINEAR_PARAMS = {"objective": "regression", "linear_tree": True,
                 "linear_lambda": 0.1, "num_leaves": TRAIN_LEAVES,
                 "max_bin": 255, "learning_rate": 0.1, "metric": "l2",
                 "verbosity": -1}
LINEAR_ITERS = 3
LINEAR_CONTINUED = 2
LINEAR_ROUTE = "path=physical fused=1 tail=kernel (linear_tree)"
LINEAR_PARITY_TREES = 2
# the leaves of slice 23's card-against-CPU runs (63: the second tree
# grows on the first's linear scores over many leaves)
LINEAR_PARITY_LEAVES = 63
# Booster.predict (the leaf entry, f64 leaf models on the card) against
# the f64 host walk (Tree.predict) on f32-exact rows: the same leaves, the
# sums taken in another order (k order against numpy's matmul)
LINEAR_PREDICT_RTOL = 1e-12
LINEAR_PREDICT_ATOL = 1e-9
DP_PARAMS = dict(TRAIN_PARAMS, gpu_use_dp=True)
DP_ITERS = 3
DP_ROUTE = "path=row_order fused=0 tail=kernel (gpu_use_dp)"
# H100 SXM data sheet: FP64 through the tensor cores (the vector rate is
# 34 TFLOP/s); the f64 modes' bound is taken at the higher rate
PEAK_F64_OPS_S = 67e12


def linear_target(x: np.ndarray, seed: int, noise_seed: int) -> np.ndarray:
    """A seeded piecewise-linear regression target of ``x`` (NaN read as
    0): four regions cut by features 0 and 1, each its own linear field
    over all the features (drawn from ``seed``: training and holdout rows
    share it) and its own offset, and Gaussian noise (from
    ``noise_seed``); a constant-leaf tree needs many splits where a
    linear leaf needs one."""
    w = np.random.default_rng(seed).normal(size=(4, x.shape[1])) * 0.3
    xz = np.nan_to_num(x).astype(np.float64)
    region = (xz[:, 0] > 0).astype(np.int64) * 2 + (xz[:, 1] > 0)
    y = ((xz * w[region]).sum(axis=1) + 0.5 * region
         + 0.1 * np.random.default_rng(noise_seed).normal(size=len(x)))
    return y.astype(np.float32)


def with_raw(ds, x: np.ndarray, y: np.ndarray):
    """The constructed Dataset ``ds``'s bins under the label ``y`` with the
    raw values of its used columns kept (``convert.dataset_from_numpy``:
    no binning again), as ``linear_tree`` needs."""
    from lightgbm_tpu_torch.convert import dataset_from_numpy
    b = ds._binned
    return dataset_from_numpy(
        [m.to_dict() for m in b.mappers], b.bin_matrix, y,
        used_feature_map=b.used_feature_map,
        num_total_features=b.num_total_features,
        raw_matrix=x[:, b.used_feature_map])


def linear_fields_bitwise(models_a, models_b) -> bool:
    """Every tree's leaf models bit for bit (constants, features,
    coefficients)."""
    def key(t):
        if not t.is_linear:
            return (False,)
        return (True, np.asarray(t.leaf_const, np.float64).tobytes(),
                tuple(np.asarray(f, np.int64).tobytes()
                      for f in t.leaf_features),
                tuple(np.asarray(c, np.float64).tobytes()
                      for c in t.leaf_coeff))
    return (len(models_a) == len(models_b)
            and all(key(a) == key(b) for a, b in zip(models_a, models_b)))


def linear_parity(gpu: str) -> dict:
    """The card against device="cpu" at the parity cut (5,000 x 28, 63
    leaves, 2 trees, so the second tree grows on the first's linear
    scores): trees equal, leaf values and the leaf models bit for bit."""
    import lightgbm_tpu_torch as lgt
    rows = OBJ_PARITY_ROWS
    x = make_rows(rows, N_FEATURES, 3)
    y = linear_target(x, 5, 6)
    params = dict(LINEAR_PARAMS, num_leaves=LINEAR_PARITY_LEAVES)

    def train(device):
        bst = lgt.Booster(params, lgt.Dataset(x, label=y), device=device)
        for _ in range(LINEAR_PARITY_TREES):
            bst.update()
        return bst
    t0 = time.perf_counter()
    bc = train("cuda")
    t1 = time.perf_counter()
    bp = train("cpu")
    rec = compare_trees(bc._models, bp._models)
    rec.update(case=f"linear trees: {rows}x{N_FEATURES}, "
               f"{LINEAR_PARITY_LEAVES} leaves, {LINEAR_PARITY_TREES} trees",
               route=bc._inner.grow.route.describe(),
               leaves_bitwise=leaves_bitwise(bc._models, bp._models),
               linear_bitwise=linear_fields_bitwise(bc._models, bp._models),
               scores_bitwise=torch_equal(bc._inner.scores.cpu(),
                                          bp._inner.scores),
               leaf_features=[sum(len(f) > 0 for f in t.leaf_features)
                              for t in bc._models],
               cuda_s=t1 - t0, cpu_s=time.perf_counter() - t1, gpu=gpu)
    rec["ok"] = (rec["ok"] and rec["leaves_bitwise"]
                 and rec["linear_bitwise"] and rec["scores_bitwise"]
                 and all(t.is_linear for t in bc._models))
    print("parity training " + json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise RuntimeError(f"linear trees on the card differ from the CPU "
                           f"run: {rec}")
    return rec


def linear_moments_bound(leaf_id, feat_idx) -> dict:
    """The least time of one ``linear_moments`` call on these inputs:
    the larger of the bytes it must move (the path features' values each
    row needs, the row's order, leaf and factors read once, the moments
    written once) at PEAK_BYTES_S and the f64 operations of each leaf's
    own entries at PEAK_F64_OPS_S."""
    from lightgbm_tpu_torch.ops.linear_kernel import moment_layout
    n = leaf_id.shape[0]
    k_leaf = (feat_idx >= 0).sum(dim=1).long()[leaf_id.long()]   # [n]
    k1_row = k_leaf + 1
    p_row = k1_row * (k1_row + 1) // 2
    _, e = moment_layout(feat_idx.shape[1])
    rec = {"bound_bytes": int(4 * k_leaf.sum()) + n * 20
           + int(feat_idx.shape[0]) * e * 8,
           "bound_ops": int((3 * p_row + 2 * k1_row + 1).sum())}
    by_bytes = rec["bound_bytes"] / PEAK_BYTES_S
    by_ops = rec["bound_ops"] / PEAK_F64_OPS_S
    rec["bound_ms"] = max(by_bytes, by_ops) * 1e3
    rec["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
    return rec


def skewed_leaves(n: int, leaves: int, big: int, device, seed: int = 31):
    """i32 [n] leaf ids: ``big`` seeded rows in leaf 0, the others spread
    evenly over the other leaves (the skewed tree); ``big = n //
    leaves`` gives an even tree."""
    import torch
    g = np.random.default_rng(seed)
    leaf = np.empty(n, np.int32)
    perm = g.permutation(n)
    leaf[perm[:big]] = 0
    leaf[perm[big:]] = 1 + np.arange(n - big) % (leaves - 1)
    return torch.as_tensor(leaf, device=device)


def path_features(leaves: int, kmax: int, f: int, device, seed: int = 32):
    """i32 [leaves, kmax]: each leaf's kmax distinct seeded features of
    f (every leaf's path as long as the tree's longest)."""
    import torch
    g = np.random.default_rng(seed)
    fi = np.stack([g.permutation(f)[:kmax] for _ in range(leaves)])
    return torch.as_tensor(fi.astype(np.int32), device=device)


LINEAR_CPU_ROWS = 20_000     # the CPU plain version's rows a case


def linear_moments_case(gpu: str, raw, leaf_id, feat_idx, label: str,
                        plain: bool = True) -> dict:
    """``linear_moments`` against its plain version on the same card
    inputs and, on the first LINEAR_CPU_ROWS rows, against the CPU plain
    version of CPU copies, bitwise; timed eager and as one replay of a
    graph of GRAPH_CALLS calls (the wrapper's sort included), beside its
    bound (``linear_moments_bound``) and, under ``plain``, the plain
    version's time."""
    import torch

    from lightgbm_tpu_torch.ops.linear_kernel import (linear_moments,
                                                      linear_moments_ref)
    dev = raw.device
    n = raw.shape[0]
    g = np.random.default_rng(29)
    grad = torch.tensor(g.normal(size=n).astype(np.float32), device=dev)
    hess = torch.tensor(g.uniform(0.1, 1.0, size=n).astype(np.float32),
                        device=dev)
    w = torch.tensor((g.random(n) < 0.9).astype(np.float32), device=dev)
    launches = linear_moments.launches
    k1 = linear_moments(raw, leaf_id, grad, hess, w, feat_idx)
    k2 = linear_moments(raw, leaf_id, grad, hess, w, feat_idx)
    ref = linear_moments_ref(raw, leaf_id, grad, hess, w, feat_idx)
    torch.cuda.synchronize()
    sub = slice(0, min(n, LINEAR_CPU_ROWS))
    cpu_args = [t[sub].contiguous() for t in (raw, leaf_id, grad, hess, w)]
    ref_cpu = linear_moments_ref(*(t.cpu() for t in cpu_args),
                                 feat_idx.cpu())
    k_sub = linear_moments(*cpu_args, feat_idx)
    rec = {"case": label, "rows": n, "leaves": int(feat_idx.shape[0]),
           "kmax": int(feat_idx.shape[1]),
           "largest_leaf_rows": int(torch.bincount(leaf_id.long()).max()),
           "bitwise_plain": torch_equal(k1, ref),
           "bitwise_cpu_plain": torch_equal(k_sub.cpu(), ref_cpu),
           "bitwise_repeat": torch_equal(k1, k2),
           "max_abs_err": float((k1 - ref).abs().max()),
           "launched": linear_moments.launches - launches}
    del ref
    rec["ok"] = (rec["bitwise_plain"] and rec["bitwise_cpu_plain"]
                 and rec["bitwise_repeat"] and rec["launched"] == 3)
    rec["ms"], rec["graph_ms"] = eager_and_graph_ms(
        lambda: linear_moments(raw, leaf_id, grad, hess, w, feat_idx))
    if plain:
        rec["plain_ms"] = _time_ms(lambda: linear_moments_ref(
            raw, leaf_id, grad, hess, w, feat_idx), 2)
    rec.update(linear_moments_bound(leaf_id, feat_idx))
    rec["gpu"] = gpu
    print("parity linear_moments " + json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise RuntimeError(f"linear_moments disagrees with its plain "
                           f"version: {rec}")
    return rec


def tree_leaf_inputs(bst, i: int):
    """Tree ``i`` of a trained linear booster as the fit saw it: every
    training row's leaf (bin-space walk on the card) and the leaves' path
    features (``models.linear.leaf_path_features``)."""
    import torch

    from lightgbm_tpu_torch.models.gbdt import _bin_tree
    from lightgbm_tpu_torch.models.linear import leaf_path_features
    from lightgbm_tpu_torch.ops.grow import predict_leaf_bins
    inner = bst._inner
    ta = _bin_tree(bst._models[i], inner._inner_ids())
    bins = inner.dd.bins
    leaf = predict_leaf_bins(ta, bins, inner.dd.num_bins, inner.dd.has_nan)
    fi = leaf_path_features(ta, inner._is_cat, ta.num_leaves)
    return (leaf.to(torch.int32).contiguous(),
            torch.as_tensor(fi, device=bins.device))


def linear_predict_checks(bst, xv: np.ndarray, gpu: str) -> dict:
    """``Booster.predict`` of the linear model on the holdout (f32-exact
    rows) against the f64 host walk (``Tree.predict`` summed in tree
    order), within LINEAR_PREDICT_RTOL / _ATOL; its text saved and
    loaded on the card predicts the trained booster's bits; the serving
    model refuses the linear trees (``predict_linear_tree``)."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.serve import ServingModel
    from lightgbm_tpu_torch.utils.log import LightGBMError
    xq = np.asarray(xv, np.float32).astype(np.float64)
    t0 = time.perf_counter()
    got = bst.predict(xq, raw_score=True)
    predict_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = np.zeros(len(xq))
    for t in bst._models:
        host += t.predict(xq)
    host_s = time.perf_counter() - t0
    err = np.abs(got - host)
    tol = LINEAR_PREDICT_ATOL + LINEAR_PREDICT_RTOL * np.abs(host)
    loaded = lgt.Booster(model_str=bst.model_to_string(), device="cuda")
    again = loaded.predict(xq, raw_score=True)
    try:
        ServingModel.from_booster(bst, device="cuda")
        refused = False
    except LightGBMError:
        refused = True
    rec = {"rows": len(xq), "trees": len(bst._models),
           "max_abs_err_host_walk": float(err.max()),
           "within_tol": bool(np.all(err <= tol)),
           "rtol": LINEAR_PREDICT_RTOL, "atol": LINEAR_PREDICT_ATOL,
           "loaded_bitwise": bool(np.asarray(again).tobytes()
                                  == np.asarray(got).tobytes()),
           "serving_refuses_linear": refused,
           "predict_s": predict_s, "host_walk_s": host_s, "gpu": gpu}
    print("linear predict " + json.dumps(rec), flush=True)
    if not (rec["within_tol"] and rec["loaded_bitwise"] and refused
            and np.all(np.isfinite(got))):
        raise RuntimeError(f"linear predict fails its checks: {rec}")
    return rec


def rollback_check(bst, label: str) -> dict:
    """One more iteration of ``bst``, then ``rollback_one_iter``: the
    training and validation scores bit for bit the ones before it, the
    tree gone; then one iteration again (on the stream route the rows
    are rebuilt from the scores, and their scores must equal the
    booster's).  The regrown tree is printed beside the rolled-back one:
    the rows it sums come in another order (rebuilt, or still in the
    rolled-back tree's permutation), so its leaves may differ in their
    last bits."""
    import torch
    inner = bst._inner
    before = inner.scores.clone()
    before_v = [vs.scores.clone() for vs in inner.valid_sets]
    n_trees = len(bst._models)
    bst.update()
    grown = bst._models[-1]
    bst.rollback_one_iter()
    torch.cuda.synchronize()
    rec = {"case": label, "route": inner.grow.route.describe(),
           "scores_bitwise": torch.equal(inner.scores, before),
           "valid_bitwise": all(torch.equal(vs.scores, b) for vs, b in
                                zip(inner.valid_sets, before_v)),
           "trees_back": len(bst._models) == n_trees}
    bst.update()
    again = bst._models[-1]
    if inner.route.stream:
        rows = inner.grow.rows.fields()
        rec["rows_carry_scores"] = torch.equal(
            rows.score, inner.train_score[rows.rid.long()])
    rec["ok"] = all(v for v in rec.values() if isinstance(v, bool))
    rec["regrown"] = dict(compare_trees([grown], [again]),
                          leaves_bitwise=leaves_bitwise([grown], [again]))
    print("rollback " + json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise RuntimeError(f"rollback_one_iter fails on the {label}: {rec}")
    return rec


def l2_holdout(yv: np.ndarray):
    """The linear main path's holdout gate: ``l2`` finite and below the
    label's variance (the constant model's)."""
    const = float(np.var(yv))

    def gate(bst) -> dict:
        got = bst.best_score["valid_0"]["l2"]
        if not (np.isfinite(got) and got < const):
            raise RuntimeError(f"holdout l2 {got} is not below the label "
                               f"variance {const}")
        return {"holdout_l2": got, "variance_l2": const}
    return gate


def linear_phase(gpu: str, higgs: dict) -> tuple:
    """Slice 23's main path: linear trees at Higgs width (the main path's
    1M x 28 bins with their raw values kept, ``linear_target``'s label,
    100,000 holdout rows, ``LINEAR_PARAMS``, 3 iterations) counted and
    timed by stage (``linear_fit`` cut into the moments kernel, the host
    solve and the prediction; tree 0 apart from the mean of the others),
    its holdout l2 beside the constant-leaf twin's; ``linear_moments``
    bitwise its plain version on tree 0's leaves, on a skewed tree (one
    leaf of half the rows) and at kmax 28, eager and graph times beside
    the bound; the parity run; predict, save / load and the serving
    refusal; 2 iterations continued through ``init_model`` from the
    model text; ``rollback_one_iter`` on this route and on the default
    stream route (the main path's booster).  Returns (the kernel's
    record, the phase's summary)."""
    import torch

    import lightgbm_tpu_torch as lgt
    parity = linear_parity(gpu)
    lap("linear/parity")
    x, xv = higgs["x"], higgs["xv"]
    y, yv = linear_target(x, 11, 12), linear_target(xv, 11, 13)
    ds = with_raw(higgs["ds"], x, y)
    valid = with_raw(higgs["valid"], xv, yv)
    bst, run = train_main_path(gpu, ds, valid, x, {}, LINEAR_ITERS,
                               "linear main path", params=LINEAR_PARAMS,
                               holdout=l2_holdout(yv))
    if run["route"] != LINEAR_ROUTE:
        raise RuntimeError(f"the linear main path took {run['route']}")
    profile = profile_iteration(bst, gpu)
    print("profiled iteration, linear main path " + json.dumps(profile),
          flush=True)
    bst.rollback_one_iter()
    twin, twin_run = train_main_path(
        gpu, ds, valid, x, {}, LINEAR_ITERS, "linear twin, constant leaves",
        params=dict(LINEAR_PARAMS, linear_tree=False),
        holdout=l2_holdout(yv))
    lap("linear/main path and twin")
    leaf, fi = tree_leaf_inputs(bst, 0)
    raw = bst._inner._raw
    n = raw.shape[0]
    kernel = linear_moments_case(gpu, raw, leaf, fi,
                                 "tree 0 of the linear main path")
    cases = [kernel, linear_moments_case(
        gpu, raw, skewed_leaves(n, TRAIN_LEAVES, n // 2, raw.device),
        path_features(TRAIN_LEAVES, fi.shape[1], N_FEATURES, raw.device),
        f"skewed: one leaf of {n // 2} rows, the others even", plain=False),
        linear_moments_case(
        gpu, raw, leaf, path_features(TRAIN_LEAVES, N_FEATURES, N_FEATURES,
                                      raw.device),
        "tree 0's leaves, kmax 28 (every feature)", plain=False)]
    lap("linear/kernel")
    predict = linear_predict_checks(bst, xv, gpu)
    # continued training from the model text: the dataset's init score
    # is the model's raw predictions, and the first new tree starts there
    init = bst.predict(x, raw_score=True)
    ds2 = with_raw(higgs["ds"], x, y)
    ds2.set_init_score(init)
    start = []

    def first_scores(env):
        if not start:
            start.append(env.model._inner.scores.clone())
    first_scores.before_iteration = True
    cont = lgt.train(LINEAR_PARAMS, ds2, num_boost_round=LINEAR_CONTINUED,
                     valid_sets=[valid], init_model=bst.model_to_string(),
                     callbacks=[first_scores], device="cuda")
    want = torch.as_tensor(init.astype(np.float32), device="cuda")[None]
    continued = {
        "trees": len(cont._models), "iterations": cont.current_iteration(),
        "starts_from_init_scores": torch.equal(start[0], want),
        "holdout_l2": cont.best_score["valid_0"]["l2"],
        "base_holdout_l2": run["holdout_l2"]}
    continued["ok"] = (continued["starts_from_init_scores"]
                       and continued["trees"]
                       == len(bst._models) + LINEAR_CONTINUED
                       and continued["holdout_l2"] <= run["holdout_l2"])
    print("linear continued " + json.dumps(continued), flush=True)
    if not continued["ok"]:
        raise RuntimeError(f"continued training from init_model fails: "
                           f"{continued}")
    rollback = [rollback_check(bst, "linear main path"),
                rollback_check(higgs["bst"], "default route")]
    lap("linear/predict, continued, rollback")
    stages = run["stage_ms_per_tree"]
    parts = ("linear_fit", "linear_moments", "linear_solve",
             "linear_predict")
    after = {k: run["stage_ms_per_tree_after_first"].get(k) for k in parts}
    summary = {
        "route": run["route"], "iterations": run["iterations"],
        "s_per_iter_first": run["s_per_iter_first"],
        "s_per_iter_rest_mean": run["s_per_iter_rest_mean"],
        "linear_fit_ms_per_tree": {k: stages.get(k) for k in parts},
        "linear_fit_ms_tree0": {k: run["stage_ms_tree0"].get(k)
                                for k in parts},
        "linear_fit_ms_per_tree_after_first": after,
        # the parts' sum over the stage, after the first tree (the rest is
        # the host's gaps between them)
        "linear_parts_over_fit": sum(after[k] for k in parts[1:])
        / after["linear_fit"],
        "stage_ms_per_tree": stages,
        "kernels_per_split": profile.get("kernels_per_split"),
        "busy_share": profile.get("busy_share"),
        "holdout_l2": run["holdout_l2"],
        "twin_holdout_l2": twin_run["holdout_l2"],
        "twin_s_per_iter_rest_mean": twin_run["s_per_iter_rest_mean"],
        "variance_l2": run["variance_l2"],
        "linear_moments_ms": kernel["ms"],
        "linear_moments_graph_ms": kernel["graph_ms"],
        "linear_moments_bound_ms": kernel["bound_ms"],
        "linear_moments_cases": [
            {k: c[k] for k in ("case", "kmax", "largest_leaf_rows", "ms",
                               "graph_ms", "bound_ms", "bound_by")}
            for c in cases],
        "parity_bitwise": parity["ok"], "predict": predict,
        "continued": continued, "rollback": rollback,
        "launches": run["launches"], "gpu": gpu}
    print("linear trees " + json.dumps(summary), flush=True)
    rec = _kernel_record(
        "linear_moments", "lightgbm_tpu_torch/csrc/linear_fit.cu",
        "none: lightgbm_tpu/models/linear.py:101 (XLA einsum)",
        run["launches"]["linear_moments"], kernel["max_abs_err"],
        kernel["ms"], kernel["plain_ms"], kernel["bound_bytes"], 0, gpu,
        bound_ops=kernel["bound_ops"], bound_ms=kernel["bound_ms"],
        bound_by=kernel["bound_by"], library_ms=None,
        library_call="none: no one PyTorch call computes the per-leaf "
                     "moments",
        bitwise_plain=kernel["bitwise_plain"],
        bitwise_cpu_plain=kernel["bitwise_cpu_plain"],
        train_parity_bitwise=parity["ok"], kmax=kernel["kmax"],
        graph_ms=kernel["graph_ms"],
        cases_bitwise=all(c["ok"] for c in cases))
    print("kernel linear_moments " + json.dumps(rec), flush=True)
    return rec, summary


def dp_hist_case(bins, vals, rng: tuple, index, padded_bins: int,
                 max_rows: int, label: str) -> dict:
    """The gpu_use_dp mode against its plain version: bitwise on the card
    and on CPU copies (the f64 sums' order is the kernel's), two launches
    bitwise."""
    import torch

    from lightgbm_tpu_torch.ops.hist_kernel2 import (
        build_histogram_rows_dp, build_histogram_rows_ref)
    dev = bins.device
    rng_t = torch.tensor(rng, dtype=torch.int32, device=dev)
    kw = dict(index=index, padded_bins=padded_bins, max_rows=max_rows)
    launches = build_histogram_rows_dp.launches
    k1 = build_histogram_rows_dp(bins, vals, rng_t, **kw)
    k2 = build_histogram_rows_dp(bins, vals, rng_t, **kw)
    ref = build_histogram_rows_ref(bins, vals, rng_t, dp=True, **kw)
    ref_cpu = build_histogram_rows_ref(
        bins.cpu(), vals.cpu(), rng_t.cpu(), dp=True,
        **dict(kw, index=None if index is None else index.cpu()))
    torch.cuda.synchronize()
    rec = {"case": label, "range": list(rng), "padded_bins": padded_bins,
           "bins": str(bins.dtype).replace("torch.", ""),
           "bitwise_plain": torch_equal(k1, ref),
           "bitwise_cpu_plain": torch_equal(k1.cpu(), ref_cpu),
           "bitwise_repeat": torch_equal(k1, k2),
           "max_abs_err": float((k1 - ref).abs().max()),
           "launched": build_histogram_rows_dp.launches - launches}
    rec["ok"] = (rec["bitwise_plain"] and rec["bitwise_cpu_plain"]
                 and rec["bitwise_repeat"] and rec["launched"] == 2)
    print("parity hist_rows f64 " + json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise RuntimeError(f"the gpu_use_dp histogram disagrees with its "
                           f"plain version: {rec}")
    return rec


def dp_hist_times(gpu: str, bins, vals, perm, models) -> list:
    """The f64 mode at the dp main path's root and at the quartiles and
    maximum of its trees' smaller children (through a seeded permutation,
    max_rows = parent // 2 + 1), eager, in turns with the f32 mode (f32,
    f64, f64, f32), beside the plain version, ``index_add_`` in f64 and
    the bound."""
    import torch

    from lightgbm_tpu_torch.ops.hist_kernel2 import (
        build_histogram_rows, build_histogram_rows_dp,
        build_histogram_rows_ref)
    dev = bins.device
    n, f = bins.shape
    b = 256
    sizes = split_sizes(models)
    order = np.argsort(sizes[:, 1], kind="stable")
    at = {q: sizes[order[int(round(q * (len(order) - 1)))]]
          for q in (0.25, 0.5, 0.75, 1.0)}
    cases = [("root", 0, n, None, n)] + [
        (f"child_{name}", 100_001, int(at[q][1]), perm,
         int(at[q][0]) // 2 + 1)
        for name, q in (("q25", 0.25), ("median", 0.5), ("q75", 0.75),
                        ("max", 1.0))]
    out = []
    for label, start, count, index, max_rows in cases:
        rng_t = torch.tensor([start, count], dtype=torch.int32, device=dev)
        kw = dict(index=index, padded_bins=b, max_rows=max_rows)
        turns = {"f32": [], "f64": []}
        for mode in ("f32", "f64", "f64", "f32"):
            fn = (build_histogram_rows_dp if mode == "f64"
                  else build_histogram_rows)
            turns[mode].append(_time_ms(
                lambda: fn(bins, vals, rng_t, **kw), 20))
        rows = None if index is None else index[start:start + count].long()
        flat, upd = flat_hist_inputs(bins, vals, b, rows)
        upd = upd.double()
        acc = torch.zeros((f * b, 2), dtype=torch.float64, device=dev)
        lib = _time_ms(lambda: acc.index_add_(0, flat, upd), 10)
        nb = (count * (f + 8) + (4 * count if index is not None else 0)
              + f * b * 8)
        out.append({
            "case": label, "rows": count, "max_rows": max_rows,
            "f64_ms": turns["f64"], "f32_ms": turns["f32"],
            "plain_ms": _time_ms(lambda: build_histogram_rows_ref(
                bins, vals, rng_t, dp=True, **kw), 2),
            "library_f64_ms": lib,
            "bound_ms": max(nb / PEAK_BYTES_S,
                            2 * count * f / PEAK_F64_OPS_S) * 1e3})
        del flat, upd, acc
    rec = {"times": out, "gpu": gpu}
    print("hist_rows f64 times [ms] " + json.dumps(rec), flush=True)
    return out


def dp_phase(gpu: str, higgs: dict) -> tuple:
    """Slice 23: ``gpu_use_dp`` on the Higgs binary main path (1M x 28, 255
    leaves, 3 iterations; route ``path=row_order`` for ``gpu_use_dp``)
    counted and timed, beside its f32 row-order twin (``LGBM_TPU_PHYS=0``,
    3 iterations); the f64 mode bitwise its plain version at B = 256 (the
    main path's bins) and B = 1024 (seeded u16 bins), root and an indexed
    child; the card's trees against the CPU's at the parity cut; the f64
    mode's times in turns with the f32 mode's.  Returns (the mode's
    record, the phase's summary)."""
    import torch
    dev = torch.device("cuda")
    ds, valid, x = higgs["ds"], higgs["valid"], higgs["x"]
    parity = train_parity(gpu, {}, 2, "gpu_use_dp",
                          params=dict(DP_PARAMS,
                                      num_leaves=LINEAR_PARITY_LEAVES),
                          bitwise=True, rows=OBJ_PARITY_ROWS)
    if parity["route"] != DP_ROUTE:
        raise RuntimeError(f"the gpu_use_dp parity run took "
                           f"{parity['route']}")
    bins = torch.as_tensor(ds._binned.bin_matrix, device=dev)
    n, f = bins.shape
    g = np.random.default_rng(23)
    vals = torch.tensor(g.normal(size=(n, 2)).astype(np.float32), device=dev)
    perm = torch.tensor(g.permutation(n).astype(np.int32), device=dev)
    wide = torch.tensor(g.integers(0, 1024, size=(n, f)).astype(np.uint16),
                        device=dev)
    cases = [dp_hist_case(bins, vals, (0, n), None, 256, n, "1M_u8_B256_root"),
             dp_hist_case(bins, vals, (100_001, CHILD_ROWS), perm, 256,
                          CHILD_ROWS, "3000_u8_B256_indexed"),
             dp_hist_case(bins, vals, (333_331, 250_000), perm, 256,
                          250_000, "250000_u8_B256_indexed"),
             dp_hist_case(wide, vals, (0, n), None, 1024, n,
                          "1M_u16_B1024_root"),
             dp_hist_case(wide, vals, (100_001, CHILD_ROWS), perm, 1024,
                          CHILD_ROWS, "3000_u16_B1024_indexed")]
    del wide
    lap("gpu_use_dp/parity and kernel")
    bst, run = train_main_path(gpu, ds, valid, x, {}, DP_ITERS,
                               "gpu_use_dp main path", params=DP_PARAMS)
    if run["route"] != DP_ROUTE:
        raise RuntimeError(f"the gpu_use_dp main path took {run['route']}")
    twin, twin_run = train_main_path(gpu, ds, valid, x, PHYS_OFF, DP_ITERS,
                                     "gpu_use_dp twin, f32 row order")
    profile = profile_iteration(bst, gpu)
    print("profiled iteration, gpu_use_dp main path "
          + json.dumps(profile), flush=True)
    times = dp_hist_times(gpu, bins, vals, perm, bst._models[:DP_ITERS])
    lap("gpu_use_dp/main path, twin and times")
    same = compare_trees(bst._models[:DP_ITERS], twin._models)
    summary = {
        "route": run["route"], "iterations": run["iterations"],
        "s_per_iter_first": run["s_per_iter_first"],
        "s_per_iter_rest_mean": run["s_per_iter_rest_mean"],
        "twin_s_per_iter_rest_mean": twin_run["s_per_iter_rest_mean"],
        "holdout_auc": run["holdout_auc"],
        "twin_holdout_auc": twin_run["holdout_auc"],
        "trees_equal_twin_structure": same["ok"] or same.get("reason"),
        "stage_ms_per_tree": run["stage_ms_per_tree"],
        "twin_stage_ms_per_tree": twin_run["stage_ms_per_tree"],
        "kernels_per_split": profile.get("kernels_per_split"),
        "busy_share": profile.get("busy_share"),
        "parity_bitwise": parity["ok"], "launches": run["launches"],
        "gpu": gpu}
    print("gpu_use_dp " + json.dumps(summary), flush=True)
    root = times[0]
    root_bound = root["bound_ms"]
    m = n
    rec = _kernel_record(
        "hist_rows_f64", "lightgbm_tpu_torch/csrc/hist_rows.cu",
        "none: lightgbm_tpu/ops/histogram.py:178 (XLA scatter-add under "
        "x64)", run["launches"]["build_histogram_rows_dp"],
        max(c["max_abs_err"] for c in cases), float(np.median(root["f64_ms"])),
        root["plain_ms"], m * (f + 8) + f * 256 * 8, 0, gpu,
        bound_ops=2 * m * f, bound_ms=root_bound, bound_by="bytes",
        library_ms=root["library_f64_ms"],
        library_call="index_add_ in f64 over a precomputed flat (feature, "
                     "bin) index, index build excluded",
        f32_mode_ms=float(np.median(root["f32_ms"])),
        bitwise_plain=all(c["bitwise_plain"] for c in cases),
        bitwise_cpu_plain=all(c["bitwise_cpu_plain"] for c in cases),
        train_parity_bitwise=parity["ok"],
        cases=[c["case"] for c in cases], times=times)
    print("kernel hist_rows_f64 " + json.dumps(rec), flush=True)
    return rec, summary


# ---------------------------------------------------------------------
# Slice 24: the parallel tree learners (tree_learner=data|voting|feature)
# on torch.distributed, W = 2 ranks sharing the one card over gloo
PARALLEL_RANKS = 2
PARALLEL_ITERS = 2
PARALLEL_PARITY_TREES = 2
PARALLEL_TIMEOUT_S = 600
PARALLEL_LEARNERS = {"data": {"tree_learner": "data"},
                     "voting": {"tree_learner": "voting", "top_k": 5},
                     "feature": {"tree_learner": "feature"}}
# the main run's AUC against the serial kernel-tail route's at as many
# iterations: near-ties may flip where the merged sums add in another order
PARALLEL_AUC_SPREAD = 0.002


def side_tail_parity(case, label: str) -> dict:
    """The split tail's global side (``side=``, slice 24): the pool entry
    with ``side`` bitwise its plain version on the card and on CPU
    copies, at the side the local counts give (then also bitwise the
    call without ``side``) and at one that flips it (the globally smaller
    child is the locally larger: the pool takes ``h_b`` and the segments
    still move by the local ``nleft``)."""
    import torch

    from lightgbm_tpu_torch.ops.apply_find import (TreeState, apply_find_pool,
                                                   apply_find_pool_ref)
    at, nl = case.at, int(case.nleft)
    copy = lambda s: TreeState(*(a.clone() for a in s))  # noqa: E731
    cpu = case.to("cpu")
    # the flip: the side the local counts do not pick
    flip = [at.cnt, at.cnt] if 2 * nl <= at.cnt else [0, at.cnt]
    sides = {"agree": [nl, at.cnt], "flip": flip}
    base = copy(case.st)
    apply_find_pool(case.h_a, case.h_b, case.nleft, base, *case.args()[2:])
    rec = {"case": label, "cnt": at.cnt, "nleft": nl}
    outs = {}
    for name, sv in sides.items():
        side = torch.tensor(sv, dtype=torch.int32, device=case.nleft.device)
        sk, sp, sc = copy(case.st), copy(case.st), copy(cpu.st)
        apply_find_pool(case.h_a, case.h_b, case.nleft, sk, *case.args()[2:],
                        side=side)
        apply_find_pool_ref(case.h_a, case.h_b, case.nleft, sp,
                            *case.args()[2:], side=side)
        apply_find_pool_ref(cpu.h_a, cpu.h_b, cpu.nleft, sc, *cpu.args()[2:],
                            side=side.cpu())
        torch.cuda.synchronize()
        rec[f"{name}_identical"] = all(torch_equal(a, b)
                                       for a, b in zip(sk, sp))
        rec[f"{name}_identical_cpu_plain"] = all(
            torch_equal(a.cpu(), b) for a, b in zip(sk, sc))
        outs[name] = sk
    rec["agree_equals_no_side"] = all(torch_equal(a, b) for a, b in
                                      zip(outs["agree"], base))
    rec["flip_moves_the_pool"] = not torch_equal(outs["flip"].pool,
                                                 base.pool)
    rec["flip_segments_local"] = torch_equal(outs["flip"].seg, base.seg)
    rec["ok"] = all(v for k, v in rec.items()
                    if k.endswith(("identical", "plain", "no_side",
                                   "pool", "local")))
    print("parity apply_find side " + json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise RuntimeError(f"apply_find_pool with side disagrees: {rec}")
    return rec


def empty_segment_cases(device) -> dict:
    """The wrappers of the parallel learners' path on a segment empty on
    this rank: ``fused_split``, the partition scan and ``copyback`` at
    ``cnt = 0`` write ``nleft = 0`` and return zeros, ``hist_comb`` and
    ``hist_rows`` at ``max_rows = 0`` return zeros, none of them
    launching; ``hist_comb`` and ``hist_rows`` launched over a range
    whose device count is 0 return zeros.  Counts their launches."""
    import torch

    from lightgbm_tpu_torch.ops.device_data import empty_rows_like, init_rows
    from lightgbm_tpu_torch.ops.fused_split import fused_split
    from lightgbm_tpu_torch.ops.hist_kernel2 import (build_histogram_comb,
                                                     build_histogram_rows)
    from lightgbm_tpu_torch.ops.partition_kernel import (copyback, partition,
                                                         partition_scan)
    n, f, b = 4096, N_FEATURES, 256
    gen = torch.Generator().manual_seed(24)
    bins = torch.randint(0, 255, (n, f), generator=gen,
                         dtype=torch.uint8).to(device)
    rows = init_rows(bins)
    rows.vals.copy_(torch.rand((n, 3), generator=gen).to(device))
    scratch = empty_rows_like(rows)
    before = [r.clone() for r in rows]
    nleft = torch.full((1,), 7, dtype=torch.int32, device=device)
    fns = (fused_split, partition_scan, copyback, build_histogram_comb,
           build_histogram_rows)
    counts0 = [fn.launches for fn in fns]
    sel = (1000, 0, 3, 100, 0, 0, -1)
    h2 = fused_split(rows, scratch, sel, nleft, padded_bins=b)
    ok = {"fused_split": bool((h2 == 0).all()) and int(nleft) == 0}
    nleft.fill_(7)
    partition(rows, scratch, sel, nleft)
    copyback(rows, scratch, 1000, 0)
    ok["partition_copyback"] = int(nleft) == 0 and all(
        torch_equal(a, c) for a, c in zip(rows, before))
    rng3 = torch.tensor([1000, 0, 0], dtype=torch.int32, device=device)
    ok["hist_comb_max_rows_0"] = bool((build_histogram_comb(
        rows, rng3, padded_bins=b, max_rows=0) == 0).all())
    vals = rows.vals[:, :2].contiguous()
    rng2 = torch.tensor([1000, 0], dtype=torch.int32, device=device)
    ok["hist_rows_max_rows_0"] = bool((build_histogram_rows(
        bins, vals, rng2, padded_bins=b, max_rows=0) == 0).all())
    no_launch = [fn.launches - c for fn, c in zip(fns, counts0)]
    ok["no_launch"] = not any(no_launch)
    # a launch over a range whose device count is zero
    ok["hist_comb_count_0"] = bool((build_histogram_comb(
        rows, rng3, padded_bins=b, max_rows=2048) == 0).all())
    ok["hist_rows_count_0"] = bool((build_histogram_rows(
        bins, vals, rng2, padded_bins=b, max_rows=2048) == 0).all())
    torch.cuda.synchronize()
    rec = {"cases": ok, "ok": all(ok.values())}
    print("parity empty segments " + json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise RuntimeError(f"a wrapper mishandles an empty segment: {rec}")
    return rec


def nccl_world_one(device) -> dict:
    """A world-size-1 NCCL group through ``parallel.collectives.Comm`` on
    device tensors: every collective the learners make runs once through
    NCCL on the card, each result the input's (W = 1).  NCCL across
    several ranks needs a card a rank: unverified on this machine."""
    import torch
    import torch.distributed as dist

    from lightgbm_tpu_torch.parallel import Comm
    port = _free_port()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        comm = Comm(device=device)
        h = torch.rand((N_FEATURES, 256, 2), device=device)
        rows = torch.rand((2, 10), device=device)
        nl = torch.tensor([5], dtype=torch.int32, device=device)
        checks = {
            "backend": comm.backend, "staged": comm.staged,
            "all_gather": torch_equal(comm.all_gather(h)[0], h),
            "all_to_all": torch_equal(comm.all_to_all([h])[0], h),
            "allreduce_sum": torch_equal(comm.allreduce_sum(h), h),
            "reduce_scatter": torch_equal(comm.reduce_scatter(h), h),
            "full_merge": torch_equal(comm.full_merge(h), h),
            "elect": torch_equal(comm.elect(rows), rows),
            "counts": comm.counts(nl, 9).tolist() == [5, 9],
            "gather_rows": torch_equal(comm.gather_rows(rows, 10), rows)}
        # W = 1 returns without a collective where it can; these run one
        dist.all_reduce(h)
        dist.all_to_all([torch.empty_like(h)], [h])
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    checks["ok"] = checks["backend"] == "nccl" and not checks["staged"] and \
        all(v for k, v in checks.items()
            if k not in ("backend", "staged"))
    print("parallel nccl world 1 " + json.dumps(checks), flush=True)
    if not checks["ok"]:
        raise RuntimeError(f"NCCL collectives at W = 1 failed: {checks}")
    return checks


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_PAR_DATA = {}


def _parallel_data(rows: int):
    """The main path's rows (``make_higgs_like(TRAIN_ROWS + HOLDOUT_ROWS,
    28, seed=0)``): the first ``rows`` binned at ``max_bin`` 255, and the
    holdout's raw rows and labels; binned once a rank process."""
    import lightgbm_tpu_torch as lgt
    if rows not in _PAR_DATA:
        x_all, y_all = make_higgs_like(TRAIN_ROWS + HOLDOUT_ROWS, N_FEATURES,
                                       seed=0)
        ds = lgt.Dataset(x_all[:rows], label=y_all[:rows],
                         params={"max_bin": 255}).construct()
        _PAR_DATA[rows] = (ds, x_all[TRAIN_ROWS:], y_all[TRAIN_ROWS:])
    return _PAR_DATA[rows]


def _parallel_job(job: dict) -> dict:
    """One training of a rank (``parallel_phase``'s jobs): returns its
    model text, route, collectives and, for a counted main run, its
    kernel launches, s / iteration, stages and holdout AUC."""
    import torch

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.metric.metrics import _weighted_auc
    from lightgbm_tpu_torch.ops.grow import StageTimer
    ds, xv, yv = _parallel_data(job["rows"])
    dev = job["device"]
    counted = counted_training_kernels()
    its = []

    def _tick(env_):
        if dev == "cuda":
            torch.cuda.synchronize()
        its.append(time.perf_counter())
    timer = StageTimer(enabled=job["count"])
    with route_env(job["env"]):
        for fn in counted:
            fn.launches = 0
        t0 = time.perf_counter()
        bst = lgt.train(job["params"], ds, num_boost_round=job["iters"],
                        callbacks=[_tick], device=dev, timer=timer)
        launches = {fn.__name__: fn.launches for fn in counted}
    inner = bst._inner
    models = bst._models
    splits = sum(t.num_leaves - 1 for t in models)
    out = {"text": bst.model_to_string(), "route": inner.route.describe(),
           "trees": len(models), "splits": splits,
           "collectives": inner.comm.calls,
           "bytes_sent": inner.comm.bytes_sent}
    if job["count"]:
        per_it = np.diff([t0] + its)
        expect = expected_launches(inner.grow.route, len(models), splits)
        out.update(
            launches={k: v for k, v in launches.items() if v},
            launches_expected={k: v for k, v in expect.items() if v},
            launches_ok=all(launches[k] == v for k, v in expect.items()),
            s_per_iter=[float(v) for v in per_it],
            stage_ms_per_tree={k: v / len(models)
                               for k, v in timer.totals_ms().items()},
            holdout_auc=_weighted_auc(yv, bst.predict(xv, raw_score=True),
                                      None),
            merged_hist_bytes=inner.dd.num_features * inner.dd.padded_bins
            * 2 * 4,
            rows_on_rank=inner.dd.num_data)
    return out


def _parallel_rank(rank: int, world: int, port: int, jobs, queue) -> None:
    """A rank of the parallel phase (spawned; module level): join the
    gloo group and run ``jobs`` in order, then put ``(rank, results)``."""
    import datetime
    import traceback

    import torch
    import torch.distributed as dist

    import lightgbm_tpu_torch as lgt
    torch.set_num_threads(4)
    lgt.set_verbosity(-1)
    out = {}
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=PARALLEL_TIMEOUT_S))
        for job in jobs:
            t0 = time.perf_counter()
            out[job["label"]] = _parallel_job(job)
            out[job["label"]]["seconds"] = time.perf_counter() - t0
    except Exception:   # noqa: BLE001 - reported to the parent
        out["error"] = traceback.format_exc()
    finally:
        queue.put((rank, out))
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(world: int, jobs: list, timeout: float) -> list:
    """``jobs`` on ``world`` spawned ranks; each rank's results in rank
    order.  Every rank still alive at ``timeout`` is killed."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_parallel_rank,
                         args=(r, world, port, jobs, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world:
            r, res = queue.get(timeout=max(deadline - time.monotonic(), 1))
            got[r] = res
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    for r in range(world):
        if "error" in got[r]:
            raise RuntimeError(f"parallel rank {r} failed:\n{got[r]['error']}")
    return [got[r] for r in range(world)]


def parallel_phase(gpu: str, higgs: dict) -> dict:
    """Slice 24: the tail's global side against its plain version and the
    empty-segment wrappers in this process; then W = 2 ranks spawned on
    the one card over gloo (the kernels already built): ``tree_learner=
    data`` on the main path's 1M x 28 rows, 255 leaves, ``max_bin`` 255,
    2 iterations with the reduce-scatter merge (counted on rank 0) and
    with the full merge (``LGBM_TPU_HIST_SCATTER=0``); at
    ``PARITY_ROWS`` x ``PARITY_CUT_LEAVES`` the card's ``data``,
    ``voting`` (``top_k`` 5) and ``feature`` trees against the same
    2-rank run on the CPU; then a world-size-1 NCCL group.  Gates: every
    rank's model text the same, the full merge's the reduce-scatter's,
    card = CPU bit for bit, the launch counts, the holdout AUC within
    ``PARALLEL_AUC_SPREAD`` of the serial kernel-tail route's at 3
    iterations.  Prints ``parallel {...}``."""
    import torch

    from lightgbm_tpu_torch.tools.profile_apply_find import synthetic_split
    side = [side_tail_parity(synthetic_split(f, b, seed=f + b,
                                             device="cuda"),
                             f"{f}x{b}")
            for f, b in ((N_FEATURES, 256), (N_FEATURES, 1024), (136, 256))]
    split = split_state_case()
    side.append(side_tail_parity(split, "root split of 20,000 seeded rows"))
    empty = empty_segment_cases(torch.device("cuda"))
    lap("parallel/side and empty segments")
    base = dict(TRAIN_PARAMS, verbosity=-1)
    main = dict(rows=TRAIN_ROWS, iters=PARALLEL_ITERS, device="cuda",
                count=True, params=dict(base, tree_learner="data"))
    # the full merge first: it bins the rows and warms the ranks, so the
    # counted reduce-scatter run is timed warm
    jobs = [dict(main, label="full", env={"LGBM_TPU_HIST_SCATTER": "0"},
                 count=False),
            dict(main, label="scatter", env={})]
    for name, lp in PARALLEL_LEARNERS.items():
        for dev in ("cuda", "cpu"):
            jobs.append(dict(label=f"{name}_{dev}", rows=PARITY_ROWS,
                             iters=PARALLEL_PARITY_TREES, device=dev,
                             count=dev == "cuda", env={},
                             params=dict(base, num_leaves=PARITY_CUT_LEAVES,
                                         **lp)))
    # the unfused data route (the scan and copyback, hist_comb a child)
    for dev in ("cuda", "cpu"):
        data = next(j for j in jobs if j["label"] == f"data_{dev}")
        jobs.append(dict(data, label=f"data_unfused_{dev}",
                         env={"LGBM_TPU_FUSED": "0"}))
    t0 = time.perf_counter()
    ranks = run_ranks(PARALLEL_RANKS, jobs, timeout=PARALLEL_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0
    lap("parallel/ranks")
    same = {j["label"]: all(r[j["label"]]["text"] == ranks[0][j["label"]]
                            ["text"] for r in ranks) for j in jobs}
    r0 = ranks[0]
    sc, full = r0["scatter"], r0["full"]
    parity = {name: r0[f"{name}_cuda"]["text"] == r0[f"{name}_cpu"]["text"]
              for name in list(PARALLEL_LEARNERS) + ["data_unfused"]}
    counted = [j["label"] for j in jobs if j["count"]]
    twin_auc = _weighted_auc_np(higgs["yv"], higgs["bst"].predict(
        higgs["xv"], raw_score=True, num_iteration=PARALLEL_ITERS))
    splits = sc["splits"]
    per_it = sc["s_per_iter"]
    nccl = nccl_world_one(torch.device("cuda"))
    rec = {"ranks": PARALLEL_RANKS, "backend": "gloo (pinned host staging)",
           "rows_per_rank": [r["scatter"]["rows_on_rank"] for r in ranks],
           "route": sc["route"], "route_full": full["route"],
           "routes_parity": {n: r0[f"{n}_cuda"]["route"]
                             for n in PARALLEL_LEARNERS},
           "same_text_every_rank": same,
           "full_equals_scatter": sc["text"] == full["text"],
           "card_equals_cpu": parity,
           # the unfused smaller child sums its rows in the geometry of
           # the local segment's bound, the fused split in that of half
           # of it: the same trees up to the order of f32 additions
           "unfused_bitwise_fused": (r0["data_unfused_cuda"]["text"]
                                     == r0["data_cuda"]["text"]),
           "s_per_iter": per_it,
           "s_per_iter_rest_mean": float(np.mean(per_it[1:])),
           "s_per_iter_note": "both ranks share the one card",
           "stage_ms_per_tree": sc["stage_ms_per_tree"],
           "collective_ms_per_tree": sc["stage_ms_per_tree"].get(
               "collective", 0.0),
           "holdout_auc": sc["holdout_auc"],
           "serial_kernel_tail_auc": twin_auc,
           "auc_delta": sc["holdout_auc"] - twin_auc,
           "splits": splits,
           "collectives_per_split": sc["collectives"] / splits,
           "bytes_sent_per_split": sc["bytes_sent"] / splits,
           "merged_hist_bytes": sc["merged_hist_bytes"],
           "collectives_per_split_full": full["collectives"] / splits,
           "bytes_sent_per_split_full": full["bytes_sent"] / splits,
           "launches": sc["launches"],
           "launches_expected": sc["launches_expected"],
           "parity_launches": {lb: r0[lb]["launches"] for lb in counted
                               if lb != "scatter"},
           "parity_routes": {lb: r0[lb]["route"] for lb in counted},
           "parity_rows": PARITY_ROWS, "parity_leaves": PARITY_CUT_LEAVES,
           "parity_trees": PARALLEL_PARITY_TREES,
           "seconds": {j["label"]: r0[j["label"]]["seconds"] for j in jobs},
           "ranks_s": ranks_s, "side_tail": side, "empty_segments": empty,
           "nccl_world_1": nccl, "gpu": gpu}
    print("parallel " + json.dumps(rec), flush=True)
    fails = [k for k, v in same.items() if not v]
    if fails:
        raise RuntimeError(f"the ranks' model texts differ: {fails}")
    if not rec["full_equals_scatter"]:
        raise RuntimeError("the full merge's trees differ from the "
                           "reduce-scatter merge's")
    if not all(parity.values()):
        raise RuntimeError(f"card != CPU on the parallel learners: {parity}")
    for lb in counted:
        if not r0[lb]["launches_ok"]:
            raise RuntimeError(f"the parallel run {lb} launched "
                               f"{r0[lb]['launches']}, expected "
                               f"{r0[lb]['launches_expected']}")
    if abs(rec["auc_delta"]) > PARALLEL_AUC_SPREAD:
        raise RuntimeError(f"the data learner's holdout AUC "
                           f"{sc['holdout_auc']} is more than "
                           f"{PARALLEL_AUC_SPREAD} from the serial route's "
                           f"{twin_auc}")
    return rec


# ---------------------------------------------------------------------
# Slice 25: the training API (custom objectives and metrics, cv, refit)
# and the dataset inputs (the binary cache, text files)
API_ITERS = 3
API_CV_FOLDS = 3
API_CV_ROUNDS = 3
API_PARITY_TREES = 2
API_REFIT_DECAY = 0.9
API_CACHE = "lightgbm_tpu_torch/build/api_cache.bin"
API_CSV = "lightgbm_tpu_torch/build/api_holdout.csv"


def refit_leaf_flips(bst, x: np.ndarray) -> int:
    """Rows of ``x`` (f64) whose leaf in some tree of ``bst`` differs
    between the traversal kernel's leaf entry (the rows cast to f32, as
    serving and ``Booster.refit`` cast them) and the f64 host walk
    (``Tree.predict_leaf``): rows whose value and its f32 rounding lie
    on two sides of a threshold."""
    from lightgbm_tpu_torch.serve import ServingEngine, ServingModel
    sm = ServingModel.from_booster(bst, device=bst.device, leaves_only=True)
    kernel = ServingEngine(sm, device=bst.device).predict_leaves(x)
    host = np.stack([t.predict_leaf(x) for t in bst._models], axis=1)
    return int(np.any(kernel != host, axis=1).sum())


def api_fobj(preds, dataset):
    """The api phase's custom objective: binary logloss in numpy on the
    f64 scores it is given."""
    labels = dataset._binned.metadata.label
    p = 1.0 / (1.0 + np.exp(-preds))
    return p - labels, p * (1.0 - p)


def api_feval(preds, eval_data):
    """The api phase's custom metric: the error rate of raw scores (no
    objective, so no transform: a positive score predicts 1)."""
    return ("error_rate",
            float(np.mean((preds > 0) != (eval_data.get_label() > 0))),
            False)


def api_parity(gpu: str) -> dict:
    """At the later phases' cut (``OBJ_PARITY_ROWS`` x 28, 31 leaves, 2
    trees): the custom objective's trees on the card against the CPU
    run's, and a pass-through objective (the port's binary gradients on
    the card, returned as CUDA tensors) against the built-in twin
    (``boost_from_average=False``, ``LGBM_TPU_STREAM=0``), bit for
    bit."""
    import torch

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.objective import create_objective
    x = make_rows(OBJ_PARITY_ROWS, N_FEATURES, 3)
    _, y = make_higgs_like(OBJ_PARITY_ROWS, N_FEATURES, 3)
    params = dict(TRAIN_PARAMS, num_leaves=PARITY_CUT_LEAVES, metric="None")
    runs = {dev: lgt.train(dict(params, objective=api_fobj),
                           lgt.Dataset(x, label=y), API_PARITY_TREES,
                           device=dev) for dev in ("cuda", "cpu")}
    rec = compare_trees(runs["cuda"]._models, runs["cpu"]._models)
    rec.update(case=f"custom objective: {OBJ_PARITY_ROWS}x{N_FEATURES}, "
               f"{PARITY_CUT_LEAVES} leaves, {API_PARITY_TREES} trees",
               route=runs["cuda"]._inner.grow.route.describe(),
               leaves_bitwise=leaves_bitwise(runs["cuda"]._models,
                                             runs["cpu"]._models))
    ds = lgt.Dataset(x, label=y).construct()
    obj = create_objective(Config.from_params({"objective": "binary"}))
    obj.init(ds._binned.metadata, ds.num_data(), torch.device("cuda"))

    def passthrough(preds, dataset):
        return obj.get_gradients(torch.as_tensor(
            preds, dtype=torch.float32, device="cuda"))
    through = lgt.train(dict(params, objective=passthrough), ds,
                        API_PARITY_TREES, device="cuda")
    with route_env({"LGBM_TPU_STREAM": "0"}):
        twin = lgt.train(dict(params, boost_from_average=False),
                         lgt.Dataset(x, label=y), API_PARITY_TREES,
                         device="cuda")
    rec["pass_through"] = dict(
        compare_trees(through._models, twin._models),
        leaves_bitwise=leaves_bitwise(through._models, twin._models),
        scores_bitwise=torch.equal(through._inner.scores,
                                   twin._inner.scores),
        twin_route=twin._inner.grow.route.describe())
    rec["ok"] = (rec["ok"] and rec["leaves_bitwise"]
                 and rec["route"] == OBJ_ROUTE
                 and rec["pass_through"]["ok"]
                 and rec["pass_through"]["leaves_bitwise"]
                 and rec["pass_through"]["scores_bitwise"])
    print("parity custom objective " + json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise RuntimeError(f"the custom objective's trees differ: {rec}")
    return rec


def api_cv(gpu: str, higgs: dict) -> dict:
    """``cv`` on the training main path's rows: 3 folds x 3 rounds, 255
    leaves, on the default route, counted per fold against
    ``expected_launches``; each fold's holdout AUC recomputed from its
    booster's ``predict`` (and from its validation scores) averages to
    ``valid auc-mean`` within 1e-9."""
    import torch

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.engine import _make_n_folds
    counted = counted_training_kernels()
    ds, x = higgs["ds"], higgs["x"]
    # f64 labels, as the metric holds them (an f32 count of pairs rounds)
    y = np.asarray(ds.get_label(), np.float64)
    torch.cuda.synchronize()
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    res = lgt.cv(TRAIN_PARAMS, ds, num_boost_round=API_CV_ROUNDS,
                 nfold=API_CV_FOLDS, return_cvbooster=True, device="cuda")
    torch.cuda.synchronize()
    cv_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    boosters = res.pop("cvbooster").boosters
    want = {}
    for b in boosters:
        splits = sum(t.num_leaves - 1 for t in b._models)
        for k, v in expected_launches(b._inner.grow.route, len(b._models),
                                      splits).items():
            want[k] = want.get(k, 0) + v
    folds = list(_make_n_folds(ds, API_CV_FOLDS, 0, True, True))
    aucs = [_weighted_auc_np(y[test], b.predict(x[test], raw_score=True))
            for b, (_, test) in zip(boosters, folds)]
    # the validation scores the metric read, in the fold's row order
    own = [_weighted_auc_np(y[test], b._inner.valid_sets[0].scores[0]
                            .double().cpu().numpy())
           for b, (_, test) in zip(boosters, folds)]
    mean = res["valid auc-mean"][-1]
    rec = {"folds": API_CV_FOLDS, "rounds": API_CV_ROUNDS, "cv_s": cv_s,
           "s_per_round": cv_s / API_CV_ROUNDS,
           "route": boosters[0]._inner.grow.route.describe(),
           "valid_auc_mean": res["valid auc-mean"],
           "valid_auc_stdv": res["valid auc-stdv"],
           "fold_aucs_from_predict": aucs,
           "mean_err_predict": abs(float(np.mean(aucs)) - mean),
           "fold_aucs_from_valid_scores": own,
           "mean_err_valid_scores": abs(float(np.mean(own)) - mean),
           "launches": {k: v for k, v in launches.items() if v}}
    rec["ok"] = (rec["mean_err_valid_scores"] <= 1e-9
                 and rec["mean_err_predict"] <= 1e-9
                 and len(res["valid auc-mean"]) == API_CV_ROUNDS
                 and all(launches[k] == v for k, v in want.items()))
    print("api cv " + json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise RuntimeError(f"cv fails: {rec}; expected launches {want}")
    del boosters
    torch.cuda.empty_cache()
    return rec


def api_refit(gpu: str, higgs: dict) -> dict:
    """``Booster.refit`` of the training main path's default-route
    booster on the holdout (``decay_rate`` 0.9): the leaf values on the
    card bit for bit a CPU refit's, every tree's structure unchanged,
    the leaves' pass through ``serve_traverse``'s leaf entry counted and
    timed; the rows whose kernel leaf differs from the f64 host walk,
    on the holdout (f32 values: none) and on seeded f64 rows."""
    import torch

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops.serve_kernel import serve_traverse
    from lightgbm_tpu_torch.serve import ServingEngine, ServingModel
    bst, xv, yv = higgs["bst"], higgs["xv"], higgs["yv"]
    torch.cuda.synchronize()
    serve_traverse.launches = 0
    t0 = time.perf_counter()
    card = bst.refit(xv, yv, decay_rate=API_REFIT_DECAY)
    torch.cuda.synchronize()
    refit_s = time.perf_counter() - t0
    launches = serve_traverse.launches
    t1 = time.perf_counter()
    cpu = lgt.Booster(model_str=bst.model_to_string(), device="cpu").refit(
        xv, yv, decay_rate=API_REFIT_DECAY, **TRAIN_PARAMS)
    cpu_s = time.perf_counter() - t1
    keys = ("split_feature", "threshold", "decision_type", "left_child",
            "right_child")
    same_structure = all(
        a.num_leaves == b.num_leaves and all(
            np.array_equal(getattr(a, k), getattr(b, k)) for k in keys)
        for a, b in zip(card._models, bst._models))
    moved = sum(not np.array_equal(a.leaf_value, b.leaf_value)
                for a, b in zip(card._models, bst._models))
    sm = ServingModel.from_booster(card, device="cuda", leaves_only=True)
    eng = ServingEngine(sm, device="cuda")
    leaf_ms = _time_ms(lambda: eng.predict_leaves(xv), 5)
    x64 = np.random.default_rng(25).normal(size=(HOLDOUT_ROWS, N_FEATURES))
    rec = {"rows": HOLDOUT_ROWS, "trees": len(card._models),
           "decay_rate": API_REFIT_DECAY, "refit_s": refit_s,
           "cpu_refit_s": cpu_s, "leaf_pass_ms": leaf_ms,
           "serve_traverse_launches": launches,
           "leaves_bitwise_cpu": leaves_bitwise(card._models, cpu._models),
           "structure_unchanged": same_structure, "trees_moved": moved,
           "f32_holdout_leaf_flips": refit_leaf_flips(
               card, xv.astype(np.float64)),
           "f64_rows_leaf_flips": refit_leaf_flips(card, x64),
           "f64_rows": HOLDOUT_ROWS,
           "holdout_auc_before": _weighted_auc_np(
               yv.astype(np.float64), bst.predict(xv, raw_score=True)),
           "holdout_auc_after": _weighted_auc_np(
               yv.astype(np.float64), card.predict(xv, raw_score=True))}
    rec["ok"] = (rec["leaves_bitwise_cpu"] and same_structure
                 and moved == len(card._models) and launches > 0
                 and rec["f32_holdout_leaf_flips"] == 0)
    print("api refit " + json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise RuntimeError(f"refit fails: {rec}")
    return rec


API_FLIP_ROWS = 20_000
API_CV_ES_ROWS = 50_000
API_CV_ES_ROUNDS = 10


def threshold_rows(bst, n: int, seed: int) -> np.ndarray:
    """[n, F] seeded f64 rows (normal values), a quarter of them with one
    feature set to a split threshold of a seeded node of a seeded tree:
    where that f64 threshold's f32 rounding lies above it, the f64 host
    walk sends the row left and its f32 rounding right."""
    g = np.random.default_rng(seed)
    x = g.normal(size=(n, N_FEATURES))
    trees = [t for t in bst._models if t.num_leaves > 1]
    for r in range(0, n, 4):
        t = trees[g.integers(len(trees))]
        node = g.integers(t.num_leaves - 1)
        x[r, int(t.split_feature[node])] = float(t.threshold[node])
    return x


def api_refit_f64(gpu: str, higgs: dict) -> dict:
    """``Booster.refit`` of the default-route booster on seeded f64 rows
    (``threshold_rows``) whose f32 rounding crosses a threshold: its
    leaves (``basic.refit_leaves``) equal the f64 host walk's on every
    row, some rows flip under the kernel's f32 entry, and the refit
    leaves are the CPU refit's bit for bit."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.basic import refit_leaves
    bst = higgs["bst"]
    x = threshold_rows(bst, API_FLIP_ROWS, 26)
    y = (np.random.default_rng(27).random(API_FLIP_ROWS) < 0.5).astype(
        np.float64)
    t0 = time.perf_counter()
    leaves = refit_leaves(bst, x)
    leaves_s = time.perf_counter() - t0
    host = np.stack([t.predict_leaf(x) for t in bst._models], axis=1)
    card = bst.refit(x, y, decay_rate=API_REFIT_DECAY)
    cpu = lgt.Booster(model_str=bst.model_to_string(), device="cpu").refit(
        x, y, decay_rate=API_REFIT_DECAY, **TRAIN_PARAMS)
    rec = {"rows": API_FLIP_ROWS, "trees": len(bst._models),
           "kernel_leaf_flips": refit_leaf_flips(bst, x),
           "leaves_equal_host_walk": bool(np.array_equal(leaves, host)),
           "leaves_bitwise_cpu": leaves_bitwise(card._models, cpu._models),
           "refit_leaves_s": leaves_s}
    rec["ok"] = (rec["leaves_equal_host_walk"] and rec["leaves_bitwise_cpu"]
                 and rec["kernel_leaf_flips"] > 0)
    print("api refit f64 rows " + json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise RuntimeError(f"refit on f64 rows fails: {rec}")
    return rec


def api_cv_callbacks(gpu: str, higgs: dict) -> dict:
    """``cv`` on the first API_CV_ES_ROWS training rows (3 folds, 31
    leaves, learning rate 1.5, up to API_CV_ES_ROUNDS rounds) from the
    default-route booster as ``init_model``, with ``early_stopping(1)``
    as a callback and a before-iteration callback: each fold's first
    scores are the model's raw predictions of its rows bit for bit, the
    callbacks run each round, the early stop cuts the history and sets
    every fold's best iteration."""
    import torch

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.engine import _make_n_folds
    x = higgs["x"][:API_CV_ES_ROWS]
    y = np.asarray(higgs["ds"].get_label())[:API_CV_ES_ROWS]
    bst = higgs["bst"]
    raw = bst.predict(x, raw_score=True)
    first, rounds = [], []

    def before(env):
        rounds.append(env.iteration)
        if env.iteration == 0:
            first.extend(b._inner.scores.clone() for b in env.model.boosters)
    before.before_iteration = True
    params = dict(TRAIN_PARAMS, num_leaves=31, learning_rate=1.5,
                  metric="binary_logloss")
    t0 = time.perf_counter()
    res = lgt.cv(params, lgt.Dataset(x, label=y), num_boost_round=
                 API_CV_ES_ROUNDS, nfold=API_CV_FOLDS, init_model=bst,
                 callbacks=[before, lgt.early_stopping(1, verbose=False)],
                 return_cvbooster=True, device="cuda")
    cv_s = time.perf_counter() - t0
    cvb = res.pop("cvbooster")
    folds = list(_make_n_folds(lgt.Dataset(x, label=y), API_CV_FOLDS, 0,
                               True, True))
    starts = [torch.equal(s[0].cpu(), torch.as_tensor(
        raw[tr].astype(np.float32))) for s, (tr, _) in zip(first, folds)]
    best = cvb.best_iteration
    rec = {"rows": API_CV_ES_ROWS, "folds": API_CV_FOLDS, "cv_s": cv_s,
           "init_trees": len(bst._models),
           "fold_starts_bitwise_init_model": starts,
           "rounds_run": len(rounds), "best_iteration": best,
           "history_rounds": len(res["valid binary_logloss-mean"]),
           "fold_best_iterations": [b.best_iteration for b in cvb.boosters],
           "fold_trees": [len(b._models) for b in cvb.boosters],
           "valid_logloss_mean": res["valid binary_logloss-mean"]}
    rec["ok"] = (all(starts) and 0 < best <= rec["rounds_run"]
                 and rec["history_rounds"] == best
                 and rec["fold_best_iterations"] == [best] * API_CV_FOLDS
                 and rec["fold_trees"] == [len(bst._models) + len(rounds)]
                 * API_CV_FOLDS)
    print("api cv callbacks " + json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise RuntimeError(f"cv's callbacks or init_model fail: {rec}")
    del cvb
    torch.cuda.empty_cache()
    return rec


def api_inputs(gpu: str, higgs: dict) -> dict:
    """The binary cache of the 1M-row dataset saved and loaded back
    (``Dataset(path)``), and the holdout written as a CSV with a header
    and its label in a named column, loaded with the training mappers:
    bins and metadata equal the in-memory datasets'."""
    import lightgbm_tpu_torch as lgt
    ds, valid = higgs["ds"]._binned, higgs["valid"]._binned
    os.makedirs(os.path.dirname(API_CACHE), exist_ok=True)
    t0 = time.perf_counter()
    higgs["ds"].save_binary(API_CACHE)
    t1 = time.perf_counter()
    back = lgt.Dataset(API_CACHE).construct()._binned
    t2 = time.perf_counter()
    cache = {
        "rows": back.num_data, "bytes": os.path.getsize(API_CACHE),
        "save_s": t1 - t0, "load_s": t2 - t1,
        "bins_equal": np.array_equal(back.bin_matrix, ds.bin_matrix),
        "metadata_equal": np.array_equal(back.metadata.label,
                                         ds.metadata.label)
        and back.metadata.weight is None and ds.metadata.weight is None,
        "mappers_equal": [m.to_dict() for m in back.mappers]
        == [m.to_dict() for m in ds.mappers]
        and np.array_equal(back.used_feature_map, ds.used_feature_map)
        and back.feature_names == ds.feature_names}
    os.remove(API_CACHE)
    xv, yv = higgs["xv"], higgs["yv"]
    t3 = time.perf_counter()
    cols = np.column_stack([yv, xv]).astype(np.float64).astype(str)
    with open(API_CSV, "w") as f:
        f.write(",".join(["target"] + [f"f{j}" for j in range(N_FEATURES)])
                + "\n")
        f.write("\n".join(",".join(r) for r in cols.tolist()) + "\n")
    t4 = time.perf_counter()
    loaded = lgt.Dataset(API_CSV, params={"header": True,
                                          "label_column": "name:target"},
                         reference=higgs["ds"]).construct()._binned
    t5 = time.perf_counter()
    csv = {"rows": loaded.num_data, "bytes": os.path.getsize(API_CSV),
           "write_s": t4 - t3, "load_s": t5 - t4,
           "bins_equal": np.array_equal(loaded.bin_matrix,
                                        valid.bin_matrix),
           "label_equal": np.array_equal(loaded.metadata.label, yv)}
    os.remove(API_CSV)
    rec = {"cache": cache, "csv": csv}
    rec["ok"] = all(v for d in rec.values() for v in d.values()
                    if isinstance(v, bool))
    print("api inputs " + json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise RuntimeError(f"the dataset inputs differ: {rec}")
    return rec


def api_phase(gpu: str, higgs: dict) -> dict:
    """Slice 25: the training API and the dataset inputs.  The custom
    objective's main path (``api_fobj``, numpy binary logloss, on the
    training main path's 1M x 28 rows, 255 leaves, 3 iterations, with
    ``api_feval`` on the holdout) on ``path=physical fused=1
    tail=kernel (objective_not_streamable)``, counted against
    ``expected_launches``, its ``gradients`` stage (the scores to the
    host, the numpy objective, the gradients to the card) a tree, its
    holdout AUC beside the default route's at 3 iterations and its
    ``feval`` beside the value recomputed from ``predict``; then
    :func:`api_parity`, :func:`api_cv`, :func:`api_cv_callbacks`,
    :func:`api_refit`, :func:`api_refit_f64` and :func:`api_inputs`."""
    x, xv, yv = higgs["x"], higgs["xv"], higgs["yv"]
    bst, run = train_main_path(
        gpu, higgs["ds"], higgs["valid"], x, {}, API_ITERS,
        "custom objective main path", params=dict(TRAIN_PARAMS,
                                                  objective=api_fobj),
        feval=api_feval)
    if run["route"] != OBJ_ROUTE:
        raise RuntimeError(f"the custom objective took {run['route']}")
    feval_v = bst.best_score["valid_0"]["error_rate"]
    label = type("Holdout", (), {"get_label": staticmethod(lambda: yv)})
    again = api_feval(bst.predict(xv, raw_score=True), label)[1]
    twin_auc = _weighted_auc_np(yv.astype(np.float64), higgs["bst"].predict(
        xv, raw_score=True, num_iteration=API_ITERS))
    fobj = {"route": run["route"], "iterations": run["iterations"],
            "s_per_iter_first": run["s_per_iter_first"],
            "s_per_iter_rest_mean": run["s_per_iter_rest_mean"],
            "gradients_ms_per_tree": run["stage_ms_per_tree"].get(
                "gradients"),
            "stage_ms_per_tree": run["stage_ms_per_tree"],
            "holdout_auc": run["holdout_auc"],
            "default_route_auc_5_iters": twin_auc,
            "feval_error_rate": feval_v,
            "feval_from_predict": again,
            "splits": run["splits"], "launches": run["launches"]}
    print("api custom objective " + json.dumps(fobj), flush=True)
    if abs(feval_v - again) > 1e-4:
        raise RuntimeError(f"feval {feval_v} differs from its value from "
                           f"predict {again}")
    parity = api_parity(gpu)
    cv = api_cv(gpu, higgs)
    cv_cb = api_cv_callbacks(gpu, higgs)
    refit = api_refit(gpu, higgs)
    refit_f64 = api_refit_f64(gpu, higgs)
    inputs = api_inputs(gpu, higgs)
    summary = {"custom_objective": fobj, "parity": parity, "cv": cv,
               "cv_callbacks": cv_cb, "refit": refit,
               "refit_f64_rows": refit_f64, "inputs": inputs, "gpu": gpu,
               "launches": {"custom_objective": run["launches"],
                            "cv": cv["launches"],
                            "refit": {"serve_traverse":
                                      refit["serve_traverse_launches"]}}}
    print("api " + json.dumps({k: v for k, v in summary.items()
                               if k != "parity"}), flush=True)
    return summary


# ---------------------------------------------------------------------
# Slice 27: resilience/ (checkpoint / resume, fault injection, numerics)
ROOT = Path(__file__).resolve().parent
RES_ROWS = 200_000
RES_LEAVES = 63
RES_ITERS = 6
RES_EVERY = 2
RES_KILL_AT = 3
RES_PARAMS = {"objective": "binary", "num_leaves": RES_LEAVES,
              "max_bin": 255, "learning_rate": 0.1, "verbosity": -1}
# GOSS samples from iteration 1 / learning_rate = 2 on
RES_GOSS = dict(RES_PARAMS, boosting="goss", learning_rate=0.5)
RES_L1 = dict(RES_PARAMS, objective="regression_l1")
RES_KNOBS = ("LGBM_TPU_CKPT_DIR", "LGBM_TPU_CKPT_EVERY",
             "LGBM_TPU_CKPT_KEEP", "LGBM_TPU_CKPT_AT_REFRESH",
             "LGBM_TPU_FAULT", "LGBM_TPU_FAULT_RETRIES", "LGBM_TPU_NUMERICS")


@contextlib.contextmanager
def knob_env(env: dict):
    """The route and resilience knobs set as ``env`` says (the others
    unset) inside the block, restored after it."""
    keys = tuple(ROUTE_KNOBS) + RES_KNOBS
    saved = {k: os.environ.get(k) for k in keys}
    for k in keys:
        os.environ.pop(k, None)
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def resilience_data(rows: int, objective: str = "binary"):
    """(x, y) of the resilience runs: Higgs-like rows from seed 27, the
    l1 runs' labels from ``objective_label``."""
    x, y = make_higgs_like(rows, N_FEATURES, 27)
    if objective != "binary":
        y = objective_label(objective, x, 27)
    return x, y


def resilience_train(params: dict, rows: int, iters: int, env: dict,
                     device: str = "cuda", ds=None):
    """``engine.train`` of the resilience runs under the knobs ``env``
    (the fault drill re-armed): the booster."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.resilience import faults
    if ds is None:
        x, y = resilience_data(rows, params["objective"])
        ds = lgt.Dataset(x, label=y)
    with knob_env(env):
        faults.rearm()
        return lgt.train(dict(params), ds, num_boost_round=iters,
                         device=device)


def resilience_worker(params: dict, rows: int, iters: int, env: dict,
                      device: str) -> None:
    """The killed process of a kill-and-resume run (``LGBM_TPU_FAULT=
    death@i`` in ``env`` kills it)."""
    resilience_train(params, rows, iters, env, device)


def ckpt_env(d, every: int = RES_EVERY, **extra) -> dict:
    return dict({"LGBM_TPU_CKPT_DIR": str(d),
                 "LGBM_TPU_CKPT_EVERY": str(every)}, **extra)


def same_run(a, b) -> dict:
    """Model text and raw f32 training scores of two boosters, byte for
    byte."""
    sa = a._inner.scores.detach().cpu().numpy()
    sb = b._inner.scores.detach().cpu().numpy()
    return {"model_text_identical": a.model_to_string()
            == b.model_to_string(),
            "raw_scores_identical": sa.dtype == sb.dtype == np.float32
            and sa.tobytes() == sb.tobytes()}


def resilience_runs(device: str = "cuda", rows: int = RES_ROWS,
                    iters: int = RES_ITERS, root=None, ds=None) -> dict:
    """The kill-and-resume drills of the resilience phase at ``rows`` x
    28, RES_LEAVES leaves, ``iters`` iterations, a snapshot every
    RES_EVERY: for the default stream route under
    ``LGBM_TPU_CKPT_AT_REFRESH`` 0 and 1 and for GOSS, a subprocess
    killed by ``death@RES_KILL_AT`` (the three at once), then resumed
    here, model text and raw scores byte for byte the uninterrupted
    run's; ``nan@2`` under ``LGBM_TPU_NUMERICS=raise`` on the l1 route
    recovered from its snapshot, the same bytes as its uninterrupted
    run; a resume with another ``num_leaves`` refused; ``stream_init``'s
    launches over each uninterrupted stream run's saves.  ``ds`` is the
    binary runs' dataset of :func:`resilience_data` (built when None).
    Raises on any failure."""
    import shutil
    import tempfile

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops.stream_grad import stream_init
    from lightgbm_tpu_torch.resilience import checkpoint as ckpt
    from lightgbm_tpu_torch.resilience import faults
    base = Path(tempfile.mkdtemp(prefix="resilience-", dir=root))
    kills = {"stream": (RES_PARAMS, {}),
             "stream_at_refresh": (RES_PARAMS,
                                   {"LGBM_TPU_CKPT_AT_REFRESH": "1"}),
             "goss": (RES_GOSS, {})}
    out = {"rows": rows, "features": N_FEATURES, "leaves": RES_LEAVES,
           "iterations": iters, "every": RES_EVERY,
           "killed_at": RES_KILL_AT, "device": device}
    try:
        procs = {}
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
        for name, (params, extra) in kills.items():
            knobs = ckpt_env(base / f"{name}_killed",
                             LGBM_TPU_FAULT=f"death@{RES_KILL_AT}", **extra)
            code = ("import chip_smoke as cs; cs.resilience_worker("
                    f"{params!r}, {rows}, {iters}, {knobs!r}, {device!r})")
            procs[name] = subprocess.Popen(
                [sys.executable, "-c", code], env=env, cwd=str(ROOT),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if ds is None:
            ds = lgt.Dataset(*resilience_data(rows))
        refs = {}
        for name, (params, extra) in kills.items():
            before = stream_init.launches
            t0 = time.perf_counter()
            refs[name] = resilience_train(
                params, rows, iters, ckpt_env(base / f"{name}_ref", **extra),
                device, ds)
            out[f"{name}_uninterrupted_s"] = time.perf_counter() - t0
            if params is RES_PARAMS:
                launched = stream_init.launches - before
                saves = iters // RES_EVERY
                # one build at the start, then one a save that a tree
                # follows (at once under AT_REFRESH=1: every save)
                want = 1 + (saves if extra else saves - (iters % RES_EVERY
                                                         == 0))
                out[f"{name}_stream_init_launches"] = launched
                # (the plain version on the CPU counts no launch)
                if (device != "cpu" and launched != want
                        or not refs[name]._inner.route.stream):
                    raise RuntimeError(f"the {name} run launched stream_init "
                                       f"{launched} times over {saves} saves, "
                                       f"expected {want}")
        for name, (params, extra) in kills.items():
            log_text, _ = procs[name].communicate(timeout=600)
            if procs[name].returncode != -9:
                raise RuntimeError(f"the {name} worker was not killed "
                                   f"(exit {procs[name].returncode}):\n"
                                   + log_text[-3000:])
            got = resilience_train(params, rows, iters, ckpt_env(
                base / f"{name}_killed", **extra), device, ds)
            rec = dict(same_run(got, refs[name]),
                       resumed_from=got.resumed_from,
                       route=got._inner.route.describe())
            out[name] = rec
            if not (rec["model_text_identical"]
                    and rec["raw_scores_identical"]
                    and rec["resumed_from"] == RES_KILL_AT - 1):
                raise RuntimeError(f"the {name} kill-and-resume run differs "
                                   f"from the uninterrupted run: {rec}")
        # numerics: nan@2 on the l1 route (gradients handed in), raised,
        # recovered from the snapshot at 2
        x1, y1 = resilience_data(rows, "regression_l1")
        ds1 = lgt.Dataset(x1, label=y1)
        ref1 = resilience_train(RES_L1, rows, iters,
                                ckpt_env(base / "l1_ref"), device, ds1)
        got1 = resilience_train(RES_L1, rows, iters, ckpt_env(
            base / "l1_nan", LGBM_TPU_FAULT="nan@2",
            LGBM_TPU_NUMERICS="raise"), device, ds1)
        rec = dict(same_run(got1, ref1),
                   reports=[(r["class"], r["recovered"])
                            for r in faults.run_reports()],
                   route=got1._inner.route.describe())
        out["l1_nan_raise"] = rec
        if not (rec["model_text_identical"] and rec["raw_scores_identical"]
                and rec["reports"] == [("nan_gradients", True)]):
            raise RuntimeError(f"nan@2 under LGBM_TPU_NUMERICS=raise was not "
                               f"recovered to the uninterrupted run: {rec}")
        # a resume of another config refuses
        try:
            resilience_train(dict(RES_PARAMS, num_leaves=31), rows, iters,
                             ckpt_env(base / "stream_ref"), device, ds)
        except ckpt.ResumeRefused as e:
            out["refused"] = e.finding["code"]
        else:
            raise RuntimeError("a resume with another num_leaves was not "
                               "refused")
        if out["refused"] != "RESUME_CONFIG_MISMATCH":
            raise RuntimeError(f"the refusal was {out['refused']}")
    finally:
        for p in locals().get("procs", {}).values():
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(base, ignore_errors=True)
    return out


def resilience_phase(gpu: str) -> dict:
    """Slice 27: :func:`resilience_runs` on the card and a save's
    ``stream_init`` at the phase's rows (eager, a graph of 20 calls, L2
    flushed); prints ``resilience {...}``.  Returns the record."""
    import torch

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops.stream_grad import stream_init
    rec = {"gpu": gpu}
    t0 = time.perf_counter()
    ds = lgt.Dataset(*resilience_data(RES_ROWS)).construct()
    rec["runs"] = resilience_runs(root=str(ROOT / "lightgbm_tpu_torch"
                                           / "build"), ds=ds)
    rec["runs_s"] = time.perf_counter() - t0
    bins = torch.as_tensor(ds._binned.bin_matrix, device="cuda")
    score, valid, consts = stream_aux(RES_ROWS, "binary", 5, bins.device)
    init = lambda: stream_init(bins, score, valid, consts,  # noqa: E731
                               kind="binary", sigmoid=1.0)
    eager, graph = eager_and_graph_ms(init)
    rec["save_stream_init_ms"] = {"eager": eager, "graph": graph,
                                  "l2_flushed": cold_ms(init),
                                  "l2_clean": cold_ms(init,
                                                      flush_by="read")}
    print("resilience " + json.dumps(rec), flush=True)
    return rec


# ---------------------------------------------------------------------
# Slice 28: the public edges (pred_contrib on the card, pred_early_stop,
# the scikit-learn estimators, the CLI and convert_model)
EDGE_ROWS = 65_536             # the holdout rows of pred_contrib and early stop
SHAP_SUM_RTOL = 1e-9           # of the largest |raw score|
SHAP_SRC = "lightgbm_tpu_torch/csrc/tree_shap.cu"
SHAP_REPLACES = ("none: lightgbm_tpu/models/shap.py:97 (TreeSHAP on the "
                 "host, a Python recursion a row)")
# the f64 operations of one step of an unwound sum (the kernel's inner
# loop: (i + 1) o, nop (d + 1), the quotient, the sum, tmp z, the
# fraction, its product and the difference)
SHAP_OPS_PER_STEP = 8
SHAP_REPS = 3
ES_FREQ, ES_MARGIN = 2, 1.0
SK_ITERS = 3
CLI_ITERS = 3
CLI_DIR = "lightgbm_tpu_torch/build/cli"
CONVERT_ROWS = 16
CSV_WORKERS = 8

_CSV_ROWS = {}


def _csv_chunk(span) -> str:
    """The CSV lines of rows ``span`` of the matrix ``_CSV_ROWS`` holds
    (a worker of :func:`write_csv`)."""
    lo, hi = span
    cols = _CSV_ROWS["m"][lo:hi].astype(str)
    return "\n".join(",".join(r) for r in cols.tolist()) + "\n"


def write_csv(path: str, y: np.ndarray, x: np.ndarray) -> float:
    """``y`` then the f32 columns of ``x`` as CSV lines (each value's
    shortest repr, which reads back to the same f32), formatted by
    CSV_WORKERS forked processes; returns the seconds it took."""
    import concurrent.futures as cf
    import multiprocessing as mp
    t0 = time.perf_counter()
    _CSV_ROWS["m"] = np.column_stack([y.astype(np.float32), x])
    n = x.shape[0]
    step = -(-n // CSV_WORKERS)
    spans = [(lo, min(lo + step, n)) for lo in range(0, n, step)]
    try:
        with cf.ProcessPoolExecutor(CSV_WORKERS,
                                    mp_context=mp.get_context("fork")) as ex:
            parts = list(ex.map(_csv_chunk, spans))
    finally:
        _CSV_ROWS.clear()
    with open(path, "w") as f:
        f.writelines(parts)
    return time.perf_counter() - t0


def unique_depths(t) -> list:
    """Each leaf's unique depth: the distinct split features on its
    path (the length of its TreeSHAP path)."""
    if t.num_leaves <= 1:
        return [0]
    out, stack = [], [(0, frozenset())]
    while stack:
        node, feats = stack.pop()
        if node < 0:
            out.append(len(feats))
            continue
        feats = feats | {int(t.split_feature[node])}
        stack += [(int(t.left_child[node]), feats),
                  (int(t.right_child[node]), feats)]
    return out


def shap_bound(trees, n: int, f: int, width: int) -> dict:
    """The least time of one ``tree_shap`` call: the larger of its bytes
    (the f64 rows read once, the nodes' 32 bytes and the leaves' 16,
    the categorical words, the contributions written once) at
    PEAK_BYTES_S and its f64 operations (SHAP_OPS_PER_STEP a step of
    each leaf's unwound sums, the unique depth squared a leaf, a row and
    a tree) at PEAK_F64_OPS_S."""
    steps = sum(d * d for t in trees for d in unique_depths(t))
    nodes = sum(max(t.num_leaves - 1, 0) for t in trees)
    leaves = sum(t.num_leaves for t in trees)
    words = sum(len(t.cat_threshold) for t in trees)
    rec = {"bound_bytes": n * f * 8 + nodes * 32 + leaves * 16 + words * 4
           + n * width * 8,
           "bound_ops": n * steps * SHAP_OPS_PER_STEP,
           "unwound_steps_per_row": steps}
    by_bytes = rec["bound_bytes"] / PEAK_BYTES_S
    by_ops = rec["bound_ops"] / PEAK_F64_OPS_S
    rec["bound_ms"] = max(by_bytes, by_ops) * 1e3
    rec["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
    return rec


def host_raw(bst, x: np.ndarray) -> np.ndarray:
    """``[n]`` f64 raw scores of a one-class booster from the f64 host
    walk (``pred_leaf``'s leaves and the leaf values, in tree order)."""
    raw = np.zeros(x.shape[0])
    for t in bst._models:
        raw = raw + t.leaf_value[t.predict_leaf(x)]
    return raw


def shap_times(fn) -> tuple:
    """(eager, graph) milliseconds of one call: ``_time_ms`` over
    SHAP_REPS calls, and one replay of a graph of SHAP_REPS calls
    (median of 3) over SHAP_REPS."""
    from lightgbm_tpu_torch.tools.profile_lib import graph_ms

    def many():
        for _ in range(SHAP_REPS):
            fn()
    eager = _time_ms(fn, SHAP_REPS)
    graph, g = graph_ms(many, reps=3, warmup=1)
    del g
    return eager, graph / SHAP_REPS


def shap_case(gpu: str, bst, x: np.ndarray, label: str,
              time_it: bool = False) -> dict:
    """``pred_contrib`` of a one-class CUDA booster, every tree of it, on
    the rows ``x``: ``Booster.predict(pred_contrib=True)`` counted (it
    must launch ``tree_shap``) and held bit for bit against the plain
    version on the card on the same rows and trees (timed once); every
    row's contributions summed against its f64 raw score from the host
    walk within SHAP_SUM_RTOL of the largest ``|raw|``; under ``time_it``
    the kernel's eager and graph times beside the bound, its timed
    output held against the plain version too.  Raises on any
    failure."""
    import torch

    from lightgbm_tpu_torch.models.shap import tree_depth, tree_shap_ref
    from lightgbm_tpu_torch.ops.shap_kernel import (pack_shap_forest,
                                                    tree_shap)
    n, f = x.shape
    nf = bst.num_feature()
    trees = len(bst._models)
    x64 = np.ascontiguousarray(x, np.float64)
    tree_shap.launches = 0
    t0 = time.perf_counter()
    contrib = bst.predict(x64, pred_contrib=True)
    predict_s = time.perf_counter() - t0
    launches = tree_shap.launches
    raw = host_raw(bst, x64)
    sum_err = float(np.abs(contrib.sum(axis=1) - raw).max())
    tol = SHAP_SUM_RTOL * float(np.abs(raw).max())
    forest = pack_shap_forest(bst._models, 1, nf, iters=trees,
                              average=False, device="cuda")
    xd = torch.as_tensor(x64, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = tree_shap_ref(forest.trees, 1, nf, forest.ev, xd, trees, False)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    want_np = want.cpu().numpy()
    rec = {"case": label, "rows": n, "features": f, "trees": trees,
           "current_iteration": bst.current_iteration(),
           "max_leaves": max(t.num_leaves for t in bst._models),
           "max_depth": max(tree_depth(t) for t in bst._models),
           "launches": launches, "predict_s": predict_s,
           "shape": list(contrib.shape), "finite": bool(
               np.isfinite(contrib).all()),
           "sum_max_abs_err": sum_err, "sum_tol": tol,
           "bitwise_plain": bool(np.array_equal(contrib, want_np)),
           "max_abs_err": float(np.abs(contrib - want_np).max()),
           "plain_ms": plain_ms}
    ok = [launches > 0, rec["finite"], sum_err <= tol, rec["bitwise_plain"],
          rec["shape"] == [n, nf + 1], rec["current_iteration"] == trees]
    if time_it:
        got = tree_shap(forest, xd)
        rec["timed_bitwise_plain"] = torch_equal(got, want)
        rec["max_abs_err"] = max(rec["max_abs_err"],
                                 float((got - want).abs().max()))
        rec["ms"], rec["graph_ms"] = shap_times(
            lambda: tree_shap(forest, xd))
        rec.update(shap_bound(bst._models, n, f, nf + 1))
        ok.append(rec["timed_bitwise_plain"])
    rec["ok"] = all(ok)
    rec["gpu"] = gpu
    print(f"pred_contrib {label} " + json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise RuntimeError(f"pred_contrib {label} fails: {rec}")
    return rec


def early_stop_case(gpu: str, bst, x: np.ndarray) -> dict:
    """``pred_early_stop`` (freq ES_FREQ, margin ES_MARGIN) of the main
    path's booster, every tree of it, on the rows ``x``: counted (it must
    launch ``serve_traverse`` for the leaves), against the f64 host
    computation from ``pred_leaf``'s leaves, bit for bit; the share of
    rows that stopped."""
    from lightgbm_tpu_torch.ops.serve_kernel import serve_traverse
    x64 = np.ascontiguousarray(x, np.float64)
    serve_traverse.launches = 0
    t0 = time.perf_counter()
    got = bst.predict(x64, raw_score=True, pred_early_stop=True,
                      pred_early_stop_freq=ES_FREQ,
                      pred_early_stop_margin=ES_MARGIN)
    s = time.perf_counter() - t0
    launches = serve_traverse.launches
    leaves = bst.predict(x64, pred_leaf=True)
    raw = np.zeros(x.shape[0])
    active = np.ones(x.shape[0], bool)
    for j, t in enumerate(bst._models):
        raw[active] += t.leaf_value[leaves[active, j]]
        if (j + 1) % ES_FREQ == 0:
            active &= 2.0 * np.abs(raw) < ES_MARGIN
    full = host_raw(bst, x64)
    rec = {"rows": x.shape[0], "freq": ES_FREQ, "margin": ES_MARGIN,
           "bitwise_host": bool(np.array_equal(got, raw)),
           "stopped_share": float(1.0 - active.mean()),
           "differs_from_full_share": float(np.mean(got != full)),
           "serve_traverse_launches": launches, "predict_s": s, "gpu": gpu}
    rec["ok"] = rec["bitwise_host"] and launches > 0
    print("pred_early_stop " + json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise RuntimeError(f"pred_early_stop differs from the host: {rec}")
    return rec


def trees_block(text: str) -> str:
    """The trees of a model text (from ``Tree=0`` to ``end of trees``)."""
    return text[text.index("Tree=0"):text.index("end of trees")]


def sklearn_case(gpu: str, higgs: dict) -> dict:
    """An ``LGBMClassifier`` with the main path's parameters fit on its
    1M rows for SK_ITERS iterations with the holdout as ``eval_set``, on
    the card: its route's launches against ``expected_launches``, its
    trees the main-path booster's first SK_ITERS (model text), its
    ``predict_proba`` the booster's ``predict`` at SK_ITERS iterations,
    bit for bit."""
    from lightgbm_tpu_torch.sklearn import LGBMClassifier
    x, xv, yv = higgs["x"], higgs["xv"], higgs["yv"]
    y = np.asarray(higgs["ds"].get_label())
    counted = counted_training_kernels()
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    clf = LGBMClassifier(n_estimators=SK_ITERS, device="cuda",
                         **TRAIN_PARAMS)
    clf.fit(x, y, eval_set=[(xv, yv)])
    fit_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    bst = clf.booster_
    models = bst._models
    route = bst._inner.grow.route
    expect = expected_launches(route, len(models),
                               sum(t.num_leaves - 1 for t in models))
    wrong = {k: (launches[k], v) for k, v in expect.items()
             if launches[k] != v}
    proba = clf.predict_proba(xv)
    want = higgs["bst"].predict(xv, num_iteration=SK_ITERS)
    rec = {"rows": x.shape[0], "iterations": SK_ITERS,
           "route": route.describe(), "fit_s": fit_s,
           "launches": {k: v for k, v in launches.items() if v},
           "launches_as_expected": not wrong,
           "trees_equal_main_path": trees_block(bst.model_to_string())
           == trees_block(higgs["bst"].model_to_string(
               num_iteration=SK_ITERS)),
           "proba_equal_predict": bool(np.array_equal(proba[:, 1], want)),
           "proba_shape": list(proba.shape),
           "valid_auc": clf.evals_result_["valid_0"]["auc"],
           "feature_importances_sum": int(clf.feature_importances_.sum()),
           "gpu": gpu}
    rec["ok"] = (rec["launches_as_expected"] and rec["trees_equal_main_path"]
                 and rec["proba_equal_predict"]
                 and route.describe().startswith("path=stream fused=1"))
    print("sklearn " + json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise RuntimeError(f"the sklearn estimator fails: {rec} {wrong}")
    return rec


CONVERT_MAIN = """#include <cstdio>
#include "model.cpp"
int main() {
  double row[%d];
  double out[1];
  while (scanf("%%lf", &row[0]) == 1) {
    for (int j = 1; j < %d; ++j) {
      if (scanf("%%lf", &row[j]) != 1) return 1;
    }
    lightgbm_tpu_model::PredictRaw(row, out);
    printf("%%.17g\\n", out[0]);
  }
  return 0;
}
"""


def cli_case(gpu: str, higgs: dict) -> dict:
    """The CLI on the card, in-process (``application.Application``):
    ``task=train`` (255 leaves, CLI_ITERS iterations) on the 1M training
    rows written as CSV (writing and parsing it took 15 s on the card's
    host, under the 20 s past which a ``task=save_binary`` cache would
    stand in for it), ``task=predict`` on the holdout's CSV (bitwise the
    booster's ``predict`` of the f32 rows), ``task=convert_model``
    compiled with ``g++`` and run on CONVERT_ROWS rows (bitwise the f64
    host walk, within 1e-6 of ``predict``'s raw scores)."""
    import shutil

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.application import Application
    d = Path(CLI_DIR).resolve()
    if d.exists():
        shutil.rmtree(d)
    d.mkdir(parents=True)
    x, xv, yv = higgs["x"], higgs["xv"], higgs["yv"]
    y = np.asarray(higgs["ds"].get_label())
    rec = {"rows": x.shape[0], "gpu": gpu}
    try:
        train_csv, valid_csv = str(d / "train.csv"), str(d / "holdout.csv")
        rec["write_train_csv_s"] = write_csv(train_csv, y, x)
        rec["write_holdout_csv_s"] = write_csv(valid_csv, yv, xv)
        rec["train_csv_bytes"] = os.path.getsize(train_csv)
        t1 = time.perf_counter()
        model = str(d / "model.txt")
        dev = ["device_type=gpu"]
        Application(dev + ["task=train", f"data={train_csv}",
                     "objective=binary", f"num_leaves={TRAIN_LEAVES}",
                     "max_bin=255", f"num_iterations={CLI_ITERS}",
                     f"output_model={model}", "verbosity=-1"]).run()
        t2 = time.perf_counter()
        pred = str(d / "pred.txt")
        Application(dev + ["task=predict", f"data={valid_csv}",
                     f"input_model={model}", f"output_result={pred}"]).run()
        t3 = time.perf_counter()
        cpp = d / "model.cpp"
        Application(["task=convert_model", f"input_model={model}",
                     f"convert_model={cpp}"]).run()
        (d / "main.cpp").write_text(CONVERT_MAIN % (N_FEATURES, N_FEATURES))
        exe = d / "pred"
        subprocess.run(["g++", "-O1", "-o", str(exe), str(d / "main.cpp")],
                       check=True, cwd=d, timeout=300)
        rows = np.asarray(xv[:CONVERT_ROWS], np.float64)
        inp = "\n".join(" ".join(repr(float(v)) for v in r) for r in rows)
        res = subprocess.run([str(exe)], input=inp, capture_output=True,
                             text=True, check=True, timeout=60)
        t4 = time.perf_counter()
        got_cpp = np.array([float(s) for s in res.stdout.split()])
        bst = lgt.Booster(model_file=model, device="cuda")
        served = bst.predict(xv)
        cli_pred = np.loadtxt(pred)
        rec.update({
            "train_s": t2 - t1,
            "predict_s": t3 - t2, "convert_compile_run_s": t4 - t3,
            "trees": len(bst._models),
            "holdout_auc": _weighted_auc_np(yv.astype(np.float64),
                                            bst.predict(xv, raw_score=True)),
            "predict_equal_booster": bool(np.array_equal(cli_pred, served)),
            "convert_rows": CONVERT_ROWS,
            "convert_bitwise_host": bool(np.array_equal(
                got_cpp, host_raw(bst, rows))),
            "convert_max_abs_err_predict": float(np.abs(
                got_cpp - bst.predict(rows, raw_score=True)).max())})
    finally:
        shutil.rmtree(d, ignore_errors=True)
    rec["ok"] = (rec["trees"] == CLI_ITERS and rec["predict_equal_booster"]
                 and rec["convert_bitwise_host"]
                 and rec["convert_max_abs_err_predict"] <= 1e-6
                 and rec["holdout_auc"] > 0.5)
    print("cli " + json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise RuntimeError(f"the CLI fails: {rec}")
    return rec


def edges_phase(gpu: str, higgs: dict, cat: dict) -> tuple:
    """Slice 28: ``pred_contrib`` of the main path's booster as the
    earlier phases left it (its TRAIN_ITERS trees, the profiled
    iteration's and the one regrown after ``rollback_check``: 255 leaves
    each) on EDGE_ROWS holdout rows through the ``tree_shap`` kernel
    (counted, timed eager and in a graph beside its plain version and its
    bound, bitwise its plain version, summing to the f64 raw scores) and
    of the categorical default route's model on its holdout;
    ``pred_early_stop``; the scikit-learn classifier; the CLI and
    ``convert_model``.  Returns (the kernel's record, the phase's
    summary)."""
    import lightgbm_tpu_torch as lgt
    xv = higgs["xv"][:EDGE_ROWS]
    bst = higgs["bst"]
    main = shap_case(gpu, bst, xv, "main path", time_it=True)
    cat_bst = lgt.Booster(model_str=cat["model"], device="cuda")
    cat_rec = shap_case(gpu, cat_bst, cat["xv"][:EDGE_ROWS],
                        "categorical default route")
    lap("edges/pred_contrib")
    es = early_stop_case(gpu, bst, xv)
    sk = sklearn_case(gpu, higgs)
    lap("edges/early stop and sklearn")
    cli = cli_case(gpu, higgs)
    summary = {"pred_contrib": main, "pred_contrib_categorical": cat_rec,
               "pred_early_stop": es, "sklearn": sk, "cli": cli}
    rec = _kernel_record(
        "tree_shap", SHAP_SRC, SHAP_REPLACES, main["launches"],
        main["max_abs_err"], main["ms"], main["plain_ms"],
        main["bound_bytes"], main["bound_ops"], gpu,
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=None,
        library_call="none: no PyTorch call computes TreeSHAP",
        graph_ms=main["graph_ms"], rows=main["rows"], trees=main["trees"],
        max_depth=main["max_depth"],
        bitwise_plain=main["bitwise_plain"],
        sum_max_abs_err=main["sum_max_abs_err"],
        categorical_launches=cat_rec["launches"],
        timed_bitwise_plain=main["timed_bitwise_plain"],
        categorical_bitwise_plain=cat_rec["bitwise_plain"],
        categorical_max_abs_err=cat_rec["max_abs_err"],
        categorical_sum_max_abs_err=cat_rec["sum_max_abs_err"])
    print("kernel tree_shap " + json.dumps(rec), flush=True)
    return rec, summary


def _weighted_auc_np(y, raw) -> float:
    from lightgbm_tpu_torch.metric.metrics import _weighted_auc
    return float(_weighted_auc(y, raw, None))


def split_state_case():
    """A real split on the card as a tail case: the root of 20,000 seeded
    rows x 8 features (10 % NaN), its best split applied
    (``split_state``)."""
    import torch

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops.device_data import init_rows, to_device
    from lightgbm_tpu_torch.ops.grow import SerialGrower, StreamSpec
    from lightgbm_tpu_torch.ops.routing import RouteInputs, decide
    from lightgbm_tpu_torch.ops.split import SplitHyperParams
    from lightgbm_tpu_torch.tools.profile_apply_find import TailCase
    x, y = make_higgs_like(20_000, 8, seed=4)
    x[np.random.default_rng(4).random(x.shape) < 0.1] = np.nan
    dd = to_device(lgt.Dataset(x, label=y).construct()._binned,
                   torch.device("cuda"))
    grower = SerialGrower(SplitHyperParams(), num_leaves=31, max_depth=-1,
                          dd=dd, route=decide(RouteInputs()),
                          stream=StreamSpec("binary", 1.0))
    rows = init_rows(dd.bins)
    rows.vals.copy_(torch.as_tensor(random_row_matrix(20_000, 1, 6)[1],
                                    device=dd.device))
    st, pair, nleft, fmask, at = split_state(grower, rows)
    return TailCase(pair[0], pair[1], nleft, st, grower.finder, fmask,
                    grower.hp, grower.max_depth, at)


_CLOCK = [time.perf_counter()]


def lap(phase: str) -> None:
    """Print the seconds since the previous lap as ``phase NAME took S
    s`` (the script's time budget is read from these lines)."""
    now = time.perf_counter()
    print(f"phase {phase} took {now - _CLOCK[0]:.1f} s", flush=True)
    _CLOCK[0] = now


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs one CUDA GPU", file=sys.stderr)
        return 2
    from lightgbm_tpu_torch.ops import _build

    gpu = _gpu_line()
    print(f"gpu: {gpu}", flush=True)
    kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    print(f"kernels built in {build_s:.2f} s", flush=True)
    lap("build")
    fixtures = analysis_kernels(gpu)
    analysis = analysis_phase(gpu)
    lap("analysis")
    probes = probe_phases(gpu)
    lap("probes")
    probes += legacy_phases(gpu)
    lap("legacy probes")
    kernels = [serve_phases(gpu, build_s)] + fixtures
    lap("serving")
    train_recs, higgs = train_phases(gpu)
    kernels += train_recs
    lap("training")
    comb = next(k for k in kernels if k["name"] == "hist_comb")
    wide = wide_phases(gpu, comb["cases"])
    lap("wide")
    comb.update({f"wide_{k}": wide["hist"][k] for k in (
        "ms", "plain_ms", "library_ms", "bound_ms", "feature_chunk")})
    comb["wide_launches"] = wide["main"]["launches"]["build_histogram_comb"]
    comb["wide_train_parity_bitwise"] = wide["parity"]["ok"]
    for k in kernels:
        if k["name"] in ("hist_comb", "hist_comb_p2"):
            k["wide_times"] = wide["times"]
    tail = next(k for k in kernels if k["name"] == "apply_find")
    tail["wide_launches"] = wide["main"]["launches"]["apply_find_pool"]
    tail["parity_cases"].append(wide["tail"]["case"])
    tail = next(k for k in kernels if k["name"] == "apply_find_pool_mono")
    tail["wide_launches"] = wide["mono"]["launches"]
    tail["parity_cases"].append(wide["mono"]["tail"])
    tail["monotone_runs"]["wide"] = wide["mono"]
    cat_recs, cat = cat_phases(gpu)
    kernels += cat_recs
    lap("categorical")
    objectives = multiclass_phases(gpu)
    lap("multiclass and objectives")
    sampling = sampling_phases(gpu, higgs)
    lap("sampling")
    ranking = ranking_phases(gpu, wide)
    lap("ranking")
    options = split_option_phases(gpu, higgs)
    lap("split options")
    linear_rec, linear = linear_phase(gpu, higgs)
    lap("linear trees")
    dp_rec, dp = dp_phase(gpu, higgs)
    lap("gpu_use_dp")
    par = parallel_phase(gpu, higgs)
    lap("parallel")
    api = api_phase(gpu, higgs)
    lap("api")
    res = resilience_phase(gpu)
    lap("resilience")
    shap_rec, edges = edges_phase(gpu, higgs, cat)
    lap("edges")
    # the launches of the multiclass, sampling, ranking and split-option
    # routes, and of the pack=2 parity runs
    mc, mc2 = (objectives["multiclass"]["launches"],
               objectives["parity"]["multiclass_pack2"]["launches"])
    bag2 = sampling["parity"]["bagging_pack2"]["launches"]
    for k in kernels:
        if k.get("route") != "cuda":
            continue
        key = {"hist_comb": "build_histogram_comb",
               "hist_comb_p2": "build_histogram_comb_p2",
               "hist_rows": "build_histogram_rows",
               "hist_rows_f64": "build_histogram_rows_dp",
               "apply_find": "apply_find_pool"}.get(k["name"], k["name"])
        if mc.get(key):
            k["multiclass_launches"] = mc[key]
        if key in mc2:
            k["multiclass_pack2_parity_launches"] = mc2[key]
        got = {mode: run["launches"][key] for mode, run in
               sampling["main"].items() if run["launches"].get(key)}
        if got:
            k["sampling_launches"] = got
        if key in bag2:
            k["bagging_pack2_parity_launches"] = bag2[key]
        if ranking["main"]["launches"].get(key):
            k["ranking_launches"] = ranking["main"]["launches"][key]
        got = {name: run["launches"][key] for name, run in
               options["main"].items() if run["launches"].get(key)}
        if got:
            k["split_options_launches"] = got
        if linear["launches"].get(key):
            k["linear_launches"] = linear["launches"][key]
        if dp["launches"].get(key):
            k["gpu_use_dp_launches"] = dp["launches"][key]
        if par["launches"].get(key):
            k["parallel_launches"] = par["launches"][key]
        got = {mode: run[key] for mode, run in api["launches"].items()
               if run.get(key)}
        if got:
            k["api_launches"] = got
        if k["name"] == "apply_find":
            k["side_parity"] = par["side_tail"]
        if k["name"] == "stream_init":
            runs = res["runs"]
            k["resilience_launches"] = {
                name: runs[f"{name}_stream_init_launches"]
                for name in ("stream", "stream_at_refresh")}
            k["resilience_saves"] = RES_ITERS // RES_EVERY
            k["save_ms"] = res["save_stream_init_ms"]
    for k in kernels:
        if k["name"] == "serve_traverse":
            k["pred_early_stop_launches"] = edges["pred_early_stop"][
                "serve_traverse_launches"]
    kernels += [linear_rec, dp_rec, shap_rec]
    kernels += probes
    if not analysis["checked_in_report_current"]:
        raise RuntimeError(
            "lightgbm_tpu_torch/analysis/resources_sm90a.txt is stale: copy "
            "lightgbm_tpu_torch/build/resources_sm90a.txt over it")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
