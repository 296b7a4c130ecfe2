"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py [--profile DIR]

1. builds the port's CUDA kernels from ``cloud_transformers_tpu_torch/csrc``;
2. prints the card's name and power limit (nvidia-smi);
3. holds every kernel against its plain PyTorch version on the card at each
   shape the classifier gives it (R = B*H = 128, K = 2048): the splat
   exactly (and bit-equal over two runs), slice and grid conv within 1e-5
   of the output scale; the splat
   backward's winner map exactly and its gradients within 1e-6, the slice
   backward within 1e-5 and bit-equal over two runs (its d_grid is summed
   in fixed point), the conv weight gradient within 1e-5; times the
   kernel, the plain version and, where one PyTorch call computes the same
   function, that call (``scatter_reduce_`` amax for the splat, ``grid_sample`` for
   the slice, grouped ``conv3d`` for the conv, ``scatter_add_`` for the
   d_grid half of the slice backward, ``convolution_backward`` for the conv
   weight gradient; each is held to the plain version too; no single call
   routes a cotangent to the lowest-indexed winner, so the splat backward
   has none); and computes each kernel's bound from this run's inputs (the
   slice and the two point backwards count only the grid rows their mapping
   touches).  The kernels of the JAX package's execution switches too: the
   2D conv and its weight gradient at the three 2D head-group shapes and
   the 3D pair at 8^3 x 32 (against ``conv2d``/``conv3d`` and
   ``convolution_backward``), the winner-tracking splat (grid equal to the
   plain version's and to splat_max's, map equal to the plain version's
   and to the two-pass backward's, two runs bit-equal) and the routing
   pass alone (bit-equal to the two-pass backward) at every splat shape,
   and the fused block at every head group's shape, with and without gk2
   (gk exact, points and gk2 within 1e-5, two runs bit-equal), timed
   beside the three separate kernels.  The fused block, the splat, the
   splat backward, the winner-tracking splat, the routing pass and the
   slice backward also at the completion decoder's rows (B = 2 clouds x 16
   heads, K = 16384 points) at every head group's shape, with the same
   gates; and the splat, the slice, the splat backward, the winner-tracking
   splat, the routing pass and the slice backward at the S3DIS segmenter's
   rows (B = 8 x 16 heads, K = 4096 points: a row's chunk over two scans of
   the splat, the slice backward's fixed point one bit lower), and again at
   the single-view reconstructor decoder's rows (B = 4 x 16 heads,
   K = 8192 points), and again, with the fused block, at the KPConv
   protocol's ragged rows (B = 6 spheres x 16 heads, K = 8192 points, each
   sphere's valid share drawn from 0.08-1.0; a padded point repeats a
   valid point's keys, its values and its slice cotangent are 0, so the
   splat meets exact ties at 0 and the slice backward zero cotangents);
   Then row 13 of the kernel table, the BatchNorm kernels
   (``ops/batch_norm.py``: statistics, apply, backward) at [196608, 512]
   and [65536, 64] in training mode with the ReLU: each against its plain
   version (1e-5 of the output scale, the running statistics 1e-6) and
   timed by a loop of 20 calls (``ms``) and a CUDA graph (``device_ms``)
   beside its bound (x read once, y or dx written once, dy read once) and
   its plain version, with a whole forward and backward of the module on
   the kernels beside its plain autograd ops and the library's BatchNorm
   (``F.batch_norm`` in training mode and ``relu``, timed only), each by a
   loop of 20 (``ms``) and by its kernels' summed device time under the
   profiler (``device_ms``).  Every
   later phase counts the BatchNorm kernels with the others: a forward
   launches an apply for each channel-last BatchNorm (91 in the
   classifier), a training step a statistics pass, an apply and a backward
   for each (``bn_counts``); the classifier's and the KPConv segmenter's
   sync-free steps also hold ``bn.plain`` to the channels-first
   BatchNorms (15 and 0).  The ``{"batch_norm": ...}`` line, before the
   kernels line, has row 13, the launches a classifier and a KPConv step
   and every path's launches;
4. serves 100 full-width ScanObjectNN classifier requests (random weights
   from a seed, clouds of 1024 to 3000 points) through
   ``InferenceEngine.classify`` in the B=8 x 2048 bucket, with the launch
   counters set to 0 just before and read just after: 26 splat, 24 slice,
   8 conv and 91 BatchNorm apply launches per forward; ms/forward is the
   median over the calls; then runs one forward under
   ``torch.cuda.set_sync_debug_mode("error")``, so that any operation that
   makes the host wait for the device raises;
5. runs the same model and weights on the CPU (plain versions) for one cloud
   and holds the card's logits and mask to it (cosine > 0.999, median
   error <= 1e-3); then serves the same 100 requests, runs the sync-free
   forward and holds the card to the CPU under set A
   (``set_grid_conv_strategy("pallas")`` + ``FWD_WINNER``: 26 splat, 24
   slice, 12 3D and 12 2D conv launches per forward) and under set B
   (``set_block_fusion("fused")``: 24 fused blocks and the pools' 2 splats
   per forward), with the switches set and restored by the script;
6. trains the full-width classifier through ``Trainer`` (synthetic
   ScanObjectNN, the optimizer of ``configs/scanobjectnn.yaml``, B=8 x 2048):
   one warm-up step, then 50 timed steps with the six launch counters set
   to 0 just before and read just after: per step 26 splat, 24 slice and 16
   conv launches (8 forward, 8 input gradients), 26 splat-backward, 24
   slice-backward and 8 weight-gradient launches.  Every loss is finite,
   the last 10 are lower on average than the first 10, every parameter has
   a finite gradient and some ``key_bn.bias`` a nonzero one.  Then one
   forward + backward runs under ``set_sync_debug_mode("error")``;
7. gradient parity: the same full-width model (one stage, B=4 x 2048, train
   mode, no dropout) takes one forward + backward on the card (kernels) and
   one on the CPU (plain versions): loss within 1e-4, the concatenated
   gradient with cosine > 0.999 and median error <= 1e-3 of its scale.
   Phases 6 and 7 run again under set A (1 + 20 steps, per step 26
   winner-tracking splats and 26 routing passes, no plain splat and no
   two-pass backward, 24 slice and slice backward, 24 3D and 24 2D convs,
   12 weight gradients of each) and under set B (per step 24 fused blocks,
   2 splats, 26 two-pass splat backwards, 24 slice backwards, 12 of each
   conv and each weight gradient);
8. the completion path: trains the full-width ``completion_inpainter`` of
   ``configs/inpainting.yaml`` through ``Trainer`` (synthetic ShapeNet
   pairs, B=2, 2048 partial and 16384 decoder points, the EMD loss at eps
   0.005 and 50 rounds): one warm-up step, then 20 timed steps with the
   eight launch counters set to 0 just before and read just after: per step
   50 splat, 48 slice, 32 conv, 50 splat-backward, 48 slice-backward and 16
   weight-gradient launches, and one ``top2`` launch per auction round.
   Every loss and gradient is finite, every decoder key ``scale`` has a
   nonzero gradient, the assignment is in range; the model's forward,
   backward and update run under ``set_sync_debug_mode("error")`` (the
   auction waits for the device once a round and is left out).  Then it
   saves a checkpoint, restores it into a fresh model with
   ``restore_params_only`` and holds the two reconstructions equal (after
   one more training step under each set, whose loss and gradients must be
   finite and whose launches follow from the default step's), and
   runs the evaluation protocol (F-score@0.01, Chamfer x 1000, EMD at eps
   0.004 and up to 3000 rounds) on 4 synthetic test clouds;
9. the same EMD with the window tail switched on, on a pair that converges
   (B=2 x 16384): it ends inside the budget, one to one, at a cost within
   2% of the staged tail's, through ``auction_window`` launches; a third
   run under the profiler sums its ``auction_window`` kernels' device
   time;
10. the completion path on the card against the CPU: the full-width
   inpainter with one stage each side, B=1, same weights and noise
   (cosine > 0.999, median error <= 1e-3), and ``loss_emd`` at N=2048
   within 2%;
11. the segmenter path: trains the full-width ``s3dis_segmenter`` of
   ``configs/s3dis.yaml`` through ``Trainer`` (synthetic S3DIS blocks,
   B=8 x 4096 x 6, the config's Adam and StepLR, loader workers and
   augmentations, ``grad_stats`` on): one warm-up step, then 20 timed
   steps with the counters set to 0 just before and read just after: per
   step 24 splat, 24 slice, 16 conv, 24 splat-backward, 24 slice-backward
   and 8 weight-gradient launches (the classifier's less its two pools);
   every loss and gradient norm finite, the last 10 losses lower on average
   than the first 10; 10 steps of ``Trainer.fit`` in one logging window
   (its ``data_time`` and ``batch_time``); one step under
   ``set_sync_debug_mode("error")``; ``Trainer.validate`` with
   ``SegEvalAccumulator`` (24/24/8 launches per forward; OA, mAcc and mIoU
   finite and in [0, 1]); one step under each set with its launches and
   finite gradients; then the one-stage segmenter at B=2 x 4096 on the
   card against the CPU (logits and gradients: cosine > 0.999, median
   error <= 1e-3);
12. the reconstructor path: trains the full-width ``image_reconstructor``
   of ``configs/reconstruction.yaml`` (a ResNet-50 on cuDNN, the 12-block
   AdaIN decoder) through ``Trainer`` (synthetic images, B=4 x 128^2, 8192
   sphere-noise and ground-truth points, the EMD loss at eps 0.005 and 50
   rounds, the config's loader workers): one warm-up step, then 20 timed
   steps with the counters set to 0 just before and read just after: per
   step 24 splat, 24 slice, 16 conv, 24 splat-backward, 24 slice-backward
   and 8 weight-gradient launches and one ``top2`` launch per auction
   round; every loss and gradient finite, every decoder key ``scale`` and
   the ResNet's stem with a nonzero gradient; the model's forward,
   backward and update under ``set_sync_debug_mode("error")``; one step
   under each set with its launches; the F-score protocol on 4 synthetic
   test images (two merged passes of 8192 points against 10000, 24/24/8
   launches a pass); then the full ResNet-50 with one decoder stage at B=1
   x 8192 on the card against the CPU (output and the gradients of a loss
   without the auction: cosine > 0.999, median error <= 1e-3; the EMD of
   2048 points of each device's output within 2%);
13. the KPConv path: trains the full-width ``s3dis_segmenter_pad`` of
   ``configs/s3dis_kpconv.yaml`` through ``Trainer`` (the synthetic rooms,
   subsampled by the native subsampler built into ``build/native/``;
   B=6 spheres x 8192 points, ragged, 7 stem channels; the config's
   optimizer, clipping at 10, loader workers and augmentations; epochs cut
   to 120 spheres): one warm-up step, then 20 timed steps with the
   counters set to 0 just before and read just after (the segmenter's
   24/24/16/24/24/8 launches per step); every loss and gradient finite,
   the last 10 losses lower on average than the first 10; one step under
   ``set_sync_debug_mode("error")``; a checkpoint restored bit for bit by
   ``restore_params_only``; the 2-vote validation (24/24/8 launches per
   forward; part, sub-cloud and full-cloud mIoU finite and in [0, 1]);
   one step under each set; then the one-stage model on 2 ragged spheres
   on the card against the CPU (the logits at the valid points and the
   gradients: cosine > 0.999, median error <= 1e-3; the masked loss
   within 1e-4);
14. the scales classifier: trains the full-width
   ``scanobject_classifier_scales`` (``configs/scanobjectnn.yaml`` with
   that model: 12 blocks at model_dim 512, the frames' scales drawn from
   U(0.5, 1.5) first) through ``Trainer`` at B=8 x 2048: one warm-up step,
   then 20 timed steps with the counters set to 0 just before and read
   just after (``PER_STEP``); every loss and gradient finite, every
   frame's scales with a nonzero gradient; a step under
   ``set_sync_debug_mode("error")``; a step under each set; a checkpoint.
   ``InferenceEngine.from_checkpoint`` serves 8 counted, timed calls of 8
   synthetic clouds from it (``PER_FORWARD``), its logits on a padded
   batch within 1e-6 of their scale from the trained model's (bit-equality
   reported); then a seeded full-width state written in the reference's
   layout (``reference_layout``, which ``convert.reference_state_dict``
   takes back to the same tensors) is served from a ``.t7`` on the card
   and on the CPU: logits and mask by the PARITY.md criteria.  Then the
   remat policies: the scales classifier's step from the trained weights
   on one batch with remat off twice and under ``point_io``,
   ``point_io_grids`` and ``full``, each run a warm-up step and a step
   under ``set_sync_debug_mode("error")`` with cuDNN deterministic (its
   launches: ``remat_counts``; its gradients and BatchNorm statistics no
   farther from the first remat-off run's than the second remat-off run's
   are), then with cuDNN as it was 3 timed steps (host clock, CUDA events,
   peak memory) and a profiled one (the device's busy time); and the same
   for the completion model's forward, backward and update and for the
   KPConv segmenter's step, with remat off and under ``point_io``;
15. the bf16 operand policy, on every model, built from the configs with
   ``model.mxu_dtype: bfloat16`` as a user turns it on (every kernel stays
   float32; the policy is float32 again after each part): the full-width
   classifier at B=8 x 2048 serves 100 counted, timed requests
   (``PER_FORWARD``) and a sync-free forward; its logits on a batch hold
   to the same weights' float32 logits on the card (cosine >= 0.9999,
   top-1 agreement reported) and, for one cloud, to the CPU port under
   bf16 (PARITY.md, median error of max(1, max |logit|)); it trains 1 +
   20 counted, timed steps through ``Trainer`` (``PER_STEP``, a falling
   loss, a sync-free step) and one step under each set (``set_counts``);
   one step's gradients from seeded weights on a fixed batch under bf16
   and in float32 (``held_bf16``: cosine > 0.999, or at least the mean
   cosine of float32 steps with noise of the policy's size on every
   contraction's output, PARITY.md's jittered floor); the
   full-width reconstructor at B=4 x
   128^2 x 8192 trains 1 + 10 counted, timed steps (its float32 launches,
   one ``top2`` a round) and runs one evaluation forward (24/24/8
   launches) whose output cloud holds to float32 (cosine > 0.999); one
   step each of the completion model, the S3DIS segmenter and the KPConv
   segmenter with their float32 steps' launches and finite losses and
   gradients.  Then ``V2VModel(32, 8, groups=4)`` on B=2 x 32^3 and
   ``UNet(16, n_out=8, groups=4)`` on B=4 x 16 x 128^2 in train mode on
   the card against the CPU (output by PARITY.md, gradients by cosine >
   0.999 and median error <= 1e-3 of their scale) and under bf16 against
   float32 on the card (``held_bf16``); and the vertex-list API at the
   classifier's head-group shapes: ``grid_positions`` equal to the
   mapping's vertex weights and indices, ``splat_max``/``slice_grid`` on
   the card against the CPU (the grid and the single-winner routing
   exact, the slice within 1e-6), ``splat_max_mapping``/
   ``slice_grid_mapping`` bit-equal to the ``_k`` forms, forward and
   backward, one launch of each kernel counted each way;
16. the parallel layer (``cloud_transformers_tpu_torch/parallel``), in child
   processes started after phase 1's build, so that no rank builds: two
   ranks on the one card in a gloo group (a TCP rendezvous on localhost;
   gloo takes CUDA tensors, NCCL one rank a card) each hold half of every
   cloud at the classifier's head-group shapes (R = 128, K = 2048 split 1024
   + 1024): ``splat_max_point_sharded`` bit-equal to the single-process
   kernel on the whole cloud, twice; ``slice_grid_point_sharded`` and the
   value gradient within 1e-6 of the single-process ones (the gradient where
   no positive maximum is held by both ranks; bit-equality and the count of
   such cells reported); on a built tie (the cloud's second half repeats its
   first) each rank's share is half the lowest index's gradient, bit for
   bit; and ``chamfer_point_sharded`` at B=2 x 16384 x 16384 within 1e-6 of
   ``chamfer_distance`` with equal indices. Then the full-width classifier
   (``configs/scanobjectnn.yaml``) trains data-parallel at B=4 x 2048 a rank
   (phase 6's global batch): one warm-up step and 10 counted, timed steps
   (each rank ``PER_STEP`` a step), every loss and gradient finite,
   parameters and buffers bit-equal across the ranks after the last step, 3
   more steps under the profiler (each rank's device time), one step whose
   all-reduces are counted, and the time of an all-reduce of the flat
   gradient and of a small one; then one step with dropout 0 against one
   process's at B=8 on the same global batch and weights: the loss within
   1e-5 (relative), the averaged gradients by PARITY.md (cosine > 0.999,
   median error <= 1e-3 of their scale), the BatchNorm running statistics
   within 1e-6 of max(1, each buffer's largest value). Last, in one more
   child with cuDNN deterministic, that one-process step twice without a
   process group and once in a world of one over NCCL: bit-equal where the
   two group-less steps are, else no farther apart than they. gloo copies
   through the host, so the ranks' times are not the multi-card NCCL cost;
17. the points axis (``parallel/mesh.py``): four ranks on the one card over
   gloo make a data 2 x points 2 grid (``make_mesh(2, 2)``), each with its
   data row's clouds and one block of every cloud's points, and train
   through ``Trainer(mesh=...)``: 17a the full-width, full-depth classifier
   (``configs/scanobjectnn.yaml``, dropout 0) at a global B=8 x 2048 (a
   rank: 4 x 1024), one step from the initial weights on the synthetic
   set's first batch against phase 16's one-process step at B=8 (the loss
   within 1e-5 relative, the gradients by PARITY.md, the running
   statistics within 1e-6 of max(1, |buffer|), the four ranks' parameters
   and buffers bit-equal), then 3 timed steps (host ms a step, each rank's
   launches of #1-#6 equal to ``PER_STEP`` a step, peak memory), one
   profiled step (device ms, idle share) and one whose all-reduces are
   counted; 17b ``s3dis_segmenter_pad`` at full width and one stage on 4
   ragged spheres of 8192 points (valid prefixes of 3000, 5200, 8192 and
   6100 points, so that the first sphere's second point block holds no
   valid point) and 17c ``completion_inpainter`` at full width, one
   encoder and one decoder stage, on the Chamfer loss at B=2, 2048 ->
   16384 points, one step each against one process's by the same
   criteria, with each rank's launches (``PTS_PER_STEP``).  The
   one-process references run in one more child, cuDNN deterministic;
18. prints ms/forward and clouds/s, then the training line (ms/step,
   clouds/s, peak memory), then the completion line (ms/step, clouds/s,
   peak memory, the EMD's share of a step, the evaluation's table values,
   rounds and seconds per cloud, both tails), then the ``{"switched":
   ...}`` line (both sets' serving, training and parity numbers), then the
   segmenter line (ms/step, clouds/s, peak memory, the data wait,
   Trainer.fit's ``data_time``/``batch_time``, OA/mAcc/mIoU, the
   card-vs-CPU cosines and the launches of each of its runs), then the
   reconstructor line (ms/step, images/s, peak memory, the EMD's share of
   a step, F-score, precision and recall and seconds per evaluated image,
   the card-vs-CPU numbers and the launches of each of its runs), then the
   KPConv line (ms/step, peak memory, the spheres' valid shares, the data
   wait, the vote validation's mIoU and seconds, the card-vs-CPU numbers
   and the launches of each of its runs), then the scales and remat line
   (the scales classifier's step, serving and ``.t7`` numbers, each remat
   run's peak memory, host, event and device-busy ms and launches a step,
   the gradient and statistics differences from remat off), then the
   bf16 line (phase 15's numbers beside float32's and the launches of
   each of its runs), then the parallel line (phase 16's checks, each
   rank's times and launches, the parity numbers), then the points line
   (phase 17's parity numbers for the three models, each rank's launches,
   the classifier's times, device idle share, collectives and peak
   memory a rank), then one
   ``{"kernels": [...]}`` line of all thirteen kernels (the TPU kernel
   table's twelve rows, row 9 as its forward and its routed backward; the
   2D and 3D convs, their weight gradients, the slice, ``top2``, the
   fused block, the splat, the winner-tracking splat, the splat backward,
   the routing pass, the slice backward and ``auction_window`` also with
   ``bound_share``, bound_ms / ms, per pass and per shape, and per shape
   whether the kernel took less time than its library call in this run;
   the slice, ``top2``, ``auction_window`` and those six also with their
   device and host times, and per shape their launch plan; the fused
   block also beside the three separate kernels, by the loop and on the
   device; those six also per completion decoder step, from the
   decoder's rows, and #1-#6 per segmenter step from its rows;
   ``top2`` also per evaluated
   cloud, from the bid searches the evaluation ran at each width; #1-#6,
   #9 and ``top2`` also per reconstructor step from its rows; #1-#6, #9
   and #10 also per KPConv step from its ragged rows), then
   the ``{"ok": true, "device": ...}`` line last.

In phase 3 the auction's two kernels are held too: ``top2`` against
``top2_plain`` at every (B, W, M) the staged schedule gives it at N = 16384
(B = 2 in training, 1 in evaluation; W = 16384, 2048, 1024, 512, 256) and
at N = 8192 (the reconstructor's B = 4; W = 8192, 1024, 512, 256), at a
shape that is a multiple of nothing, with duplicated targets, with one
target and on a mid-auction state: values and indices bit for bit, with
its square-root skip on and off; ``auction_window`` against
``auction_window_plain`` from a mid-auction state at W=512, M=16384, up to
64 rounds, at B=2 (the checked call, whose times stand in the kernels
line), at B=1 and with 5 lanes of the window bidding (the window tail's
usual call): prices, owner map and rounds used bit for bit, in two
calls.  ``top2`` is timed beside ``torch.cdist`` + ``topk(2)`` (two
library calls and an elementwise pass, not one); its bound is B * W * M
values of 12 float32 operations, or their square roots at the
special-function rate, whichever takes longer.  Every kernel's ``ms`` and
``library_ms`` time a loop of 20 launches (``cuda_ms``), so they hold the
wrapper's host cost wherever it exceeds the kernel's.  The slice, ``top2``,
``auction_window``, ``grid_sample``, the fused block, the splat kernels and
the slice backward (with ``scatter_add_``) take tens
of microseconds at some shapes, about what a wrapper takes on the host, so
they are also timed by replaying a CUDA graph of 20 calls (``graph_ms``),
which leaves the host out: ``device_ms`` and
``library_device_ms``; ``host_ms`` and ``library_host_ms`` are the host
time to launch one call; ``top2`` on the mid-auction state also with its
square-root skip off.

TF32 is off for matmuls and cuDNN convolutions, so everything is float32
outside phase 15, and cuBLAS accumulates bf16 products in float32.
Any failure raises and the exit code is non-zero; without CUDA the script
exits non-zero before printing any result.  ``--profile DIR`` profiles 10
more classify calls: it adds their host wall time, device busy time and the
device's idle share (one window, both clocks) to the result line, and
writes the torch.profiler table by kernel to ``DIR/profile_forward.txt``;
it does the same for 5 more training steps of the classifier
(``DIR/profile_train.txt``) and of the completion model
(``DIR/profile_completion.txt``), of the segmenter
(``DIR/profile_segmenter.txt``) and of the reconstructor
(``DIR/profile_reconstructor.txt``), of the KPConv segmenter
(``DIR/profile_kpconv.txt``) and of the scales classifier
(``DIR/profile_scales.txt``), for the classify calls and training
steps under each set (``DIR/profile_{forward,train}_set_{a,b}.txt``) and
under bf16 (``DIR/profile_{forward,train,reconstructor}_bf16.txt``).
"""

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOP_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
B, H, K = 8, 16, 2048
R = B * H
# (sizes, F, splat launches, slice launches) per forward: 4 stages of the
# stage plan, plus the two pools (8^3 x 32 and 16^2 x 16 splat only)
POINT_SHAPES = [((128, 128), 4, 4, 4), ((32, 32, 32), 4, 4, 4),
                ((64, 64), 16, 4, 4), ((16, 16, 16), 16, 4, 4),
                ((16, 16), 16, 5, 4), ((8, 8, 8), 32, 5, 4)]
# (sizes, F, calls per forward on the default path, calls per forward
# under set A): 8^3 x 32 reaches the kernel under "pallas" only
CONV_SHAPES = [((32, 32, 32), 4, 4, 4), ((16, 16, 16), 16, 4, 4),
               ((8, 8, 8), 32, 0, 4)]
# the 2D head groups: (sizes, F, calls per forward under set A)
CONV2D_SHAPES = [((128, 128), 4, 4), ((64, 64), 16, 4), ((16, 16), 16, 4)]
# every head group's block: (sizes, F, fused launches per forward, set B)
BLOCK_SHAPES = [((128, 128), 4, 4), ((32, 32, 32), 4, 4), ((64, 64), 16, 4),
                ((16, 16, 16), 16, 4), ((16, 16), 16, 4), ((8, 8, 8), 32, 4)]
# the completion decoder's rows: (clouds, points a cloud); each head group's
# shape takes 4 fused blocks (set B) and 4 splat backwards per step
COMPLETION_ROWS = (2, 16384)
SWITCHED_STEPS = 20   # timed optimizer steps under each set, after a warm-up
N_REQUESTS = 100   # classify calls in the counted, timed run
PROFILE_CALLS = 10   # classify calls in the --profile window
TRAIN_STEPS = 50   # timed optimizer steps, after one warm-up step
PROFILE_STEPS = 5   # training steps in the --profile window
PARITY_B = 4   # clouds in the card-vs-CPU gradient comparison
TOL = 1e-5   # max abs error relative to max(1, max |plain output|)
ROUTE_TOL = 1e-6   # the same, for the splat backward (no atomics, few terms)
LIB_TOL = 1e-4   # the same, for a library yardstick (other op order)
SFU_OP_PER_S = 132 * 16 * 1.98e9   # H100 SXM: 16 special-function results
#                                    a clock on each of 132 SMs at 1.98 GHz
# top2 shapes (B, W, M): the widths of the staged schedule at N = 16384 for
# the training batch (B = 2) and for one evaluated cloud (B = 1), and one
# shape that is a multiple of nothing
TOP2_SHAPES = [(b, w, 16384) for b in (2, 1)
               for w in (16384, 2048, 1024, 512, 256)] + [(2, 777, 3001)]
# the reconstructor's training batch (B = 4) at N = 8192: W = 8192, then
# the staged widths N/8, N/16, N/32
TOP2_SHAPES += [(4, w, 8192) for w in (8192, 1024, 512, 256)]
WINDOW_SHAPE = (2, 512, 16384)   # (B, W, M) of the auction_window check
COMPLETION_STEPS = 20   # timed optimizer steps, after one warm-up step
EVAL_CLOUDS = 4
SEG_K = 4096   # the S3DIS segmenter's points a block (configs/s3dis.yaml)
SEG_STEPS = 20   # timed segmenter steps, after one warm-up step
SEG_FIT_STEPS = 10   # steps of Trainer.fit, one window of its own timing
SEG_PARITY_B = 2   # blocks in the card-vs-CPU segmenter comparison
# the single-view reconstructor (configs/reconstruction.yaml): B images of
# IM^2, REC_K sphere-noise and ground-truth points a cloud
REC_B, REC_K, REC_IM = 4, 8192, 128
REC_STEPS = 20   # timed reconstructor steps, after one warm-up step
REC_EVAL_POINTS = 10000   # ground-truth points an evaluated image
REC_PARITY_EMD_N = 2048   # points of the card-vs-CPU EMD comparison
# the KPConv protocol's segmenter (configs/s3dis_kpconv.yaml): B spheres of
# K points, each padded to K by repeating its own points, with a 0/1 mask
KP_B, KP_K = 6, 8192
KP_VALID = (0.08, 1.0)   # the valid share of a sphere: the synthetic rooms'
#                           spread over an epoch of 120 spheres
KP_STEPS = 20   # timed KPConv steps, after one warm-up step
KP_EPOCH = 120   # spheres an epoch of each synthetic set (the config's 2000,
#                  cut for time)
KP_VOTES = 2   # votes of the validation (the per-epoch validation's)
KP_PARITY_B = 2   # spheres in the card-vs-CPU comparison
SCALES = "scanobject_classifier_scales"
SCALES_STEPS = 20   # timed steps of the scales classifier, after a warm-up
SCALES_SERVE_CALLS = 8   # classify calls from each checkpoint, B clouds each
SCALES_SERVE_TOL = 1e-6   # served against trained logits, of max(1, |logit|)
REMAT_STEPS = 3   # timed steps of each remat run, after the gated step
REMAT_PROFILE_STEPS = 1   # steps of each remat run under the profiler
# the classifier's remat runs: (label, remat_policy; None: remat off); two
# runs with remat off give the gradients' and statistics' own spread
REMAT_RUNS = (("off", None), ("off_again", None), ("point_io", "point_io"),
              ("point_io_grids", "point_io_grids"), ("full", "full"))
BF16_STEPS = 20   # timed bf16 classifier steps, after a warm-up
BF16_REC_STEPS = 10   # timed bf16 reconstructor steps, after a warm-up
BF16_LOGIT_COS = 0.9999   # bf16 against f32 logits on the card (the JAX
#                           package's TPU figure: 0.999997, PARITY.md)
BF16_COS = 0.999   # bf16 against f32: clouds, outputs, gradients (or the
#                    float32 floor of ``held_bf16`` where chaos rules)
BF16_NOISE = 2.0 ** -7   # the relative noise of that floor's float32 runs
REPLACES = {
    "splat_max": "cloud_transformers_tpu/ops/pallas_splat.py:528",
    "slice_gather": "cloud_transformers_tpu/ops/pallas_splat.py:780",
    "grid_conv3d": "cloud_transformers_tpu/ops/pallas_grid_conv.py:100",
    "splat_max_bwd": "cloud_transformers_tpu/ops/pallas_splat.py:1179",
    "slice_bwd": "cloud_transformers_tpu/ops/pallas_splat.py:1382",
    "grid_conv3d_dw": "cloud_transformers_tpu/ops/pallas_grid_conv.py:183",
    "top2": "cloud_transformers_tpu/ops/pallas_emd.py:112",
    "auction_window": "cloud_transformers_tpu/ops/pallas_emd.py:373",
    "grid_conv2d": "cloud_transformers_tpu/ops/pallas_grid_conv.py:277",
    "grid_conv2d_dw": "cloud_transformers_tpu/ops/pallas_grid_conv.py:362",
    # pallas_splat(..., with_winner=True) and pallas_splat_bwd_routed
    "splat_max_winner": "cloud_transformers_tpu/ops/pallas_splat.py:528",
    "splat_route": "cloud_transformers_tpu/ops/pallas_splat.py:1024",
    "fused_block": "cloud_transformers_tpu/ops/pallas_fused_block.py:196",
}
_SPLAT_CU = "cloud_transformers_tpu_torch/csrc/splat_slice.cu"
_CONV_CU = "cloud_transformers_tpu_torch/csrc/grid_conv.cu"
_EMD_CU = "cloud_transformers_tpu_torch/csrc/emd.cu"
SOURCES = {
    "splat_max": _SPLAT_CU, "slice_gather": _SPLAT_CU,
    "grid_conv3d": _CONV_CU, "splat_max_bwd": _SPLAT_CU,
    "slice_bwd": _SPLAT_CU, "grid_conv3d_dw": _CONV_CU,
    "top2": _EMD_CU, "auction_window": _EMD_CU,
    "grid_conv2d": _CONV_CU, "grid_conv2d_dw": _CONV_CU,
    "splat_max_winner": _SPLAT_CU, "splat_route": _SPLAT_CU,
    "fused_block": "cloud_transformers_tpu_torch/csrc/fused_block.cu",
}
# the BatchNorm kernels (row 13 of the kernel table), apart from SOURCES
BN_WRAPPERS = ("bn_stats", "bn_apply", "bn_backward")


def bn_counts(n, training):
    """Launches of the BatchNorm kernels in a forward of a model with ``n``
    channel-last BatchNorms (an apply each, with the running statistics)
    or in a training step (statistics, apply and backward each)."""
    return dict.fromkeys(BN_WRAPPERS if training else ("bn_apply",), n)


# launches per forward of the serving path, and per training step: the
# classifier's 91 channel-last BatchNorms take the kernels, its trunk's 15
# channels-first ones the plain ops
PER_FORWARD = {"splat_max": 26, "slice_gather": 24,
               "grid_conv3d": 8} | bn_counts(91, False)
PER_STEP = {"splat_max": 26, "slice_gather": 24, "grid_conv3d": 16,
            "splat_max_bwd": 26, "slice_bwd": 24,
            "grid_conv3d_dw": 8} | bn_counts(91, True)
# the channel-last BatchNorms of the 12 unions (two head groups' key,
# value and after BatchNorms and the union's own, 7 a union), which a
# remat policy runs again (``remat_counts``): the classifier's, the
# completion encoder's and the KPConv segmenter's
UNION_BNS = 84
# the JAX package's execution switches, as the port names them (launches
# per pass under each: ``set_counts``):
# set A = set_grid_conv_strategy("pallas") + FWD_WINNER: every grid conv on
# the kernels (12 blocks x one 2D and one 3D head group), every splat under
# a gradient tracks its winner map, whose backward is the routing pass alone
# set B = set_block_fusion("fused"): each head group one fused block, the
# two pools plain splats; the backward composes the slice backward, the
# conv's backward kernels (whatever the conv strategy) and the two-pass
# splat backward
SETS = ("set_a", "set_b")
# per completion training step: the encoder (the classifier's backbone, 26
# splats, and 90 channel-last BatchNorms) and the decoder (4 stages x 3
# unions x 2 heads groups, 24 splats; AdaIN, no BatchNorm)
PER_STEP_COMPLETION = {
    "splat_max": 50, "slice_gather": 48, "grid_conv3d": 32,
    "splat_max_bwd": 50, "slice_bwd": 48,
    "grid_conv3d_dw": 16} | bn_counts(90, True)
# 24 head groups (8 of them 3D with X >= 16), per forward and per step
TRUNK_FORWARD = {"splat_max": 24, "slice_gather": 24, "grid_conv3d": 8}
TRUNK_STEP = {"splat_max": 24, "slice_gather": 24, "grid_conv3d": 16,
              "splat_max_bwd": 24, "slice_bwd": 24, "grid_conv3d_dw": 8}
# the S3DIS segmenter: the classifier's 12-block trunk without its pools,
# and 86 channel-last BatchNorms, per forward and per training step
PER_FORWARD_SEGMENTER = TRUNK_FORWARD | bn_counts(86, False)
PER_STEP_SEGMENTER = TRUNK_STEP | bn_counts(86, True)
# the reconstructor's AdaIN decoder: 4 stages x 3 unions x 2 head groups,
# per forward and per training step; its ResNet-50 runs on cuDNN (its
# BatchNorms channels-first, on the plain ops), and the EMD adds one top2
# launch a round
PER_FORWARD_RECONSTRUCTOR = dict(TRUNK_FORWARD)
PER_STEP_RECONSTRUCTOR = dict(TRUNK_STEP)
# the KPConv protocol's segmenter: the same trunk, the mask applied around
# the kernels
PER_FORWARD_KPCONV = dict(PER_FORWARD_SEGMENTER)
PER_STEP_KPCONV = dict(PER_STEP_SEGMENTER)
# where ``library_ms`` is not the time of one PyTorch call
LIBRARY_IS = {"top2": "torch.cdist + an elementwise pass + topk(2): two "
                      "library calls, not one"}
# kernels whose entries in the kernels line also give the share of the
# bound reached (bound_ms / ms), per pass and per shape
BOUND_SHARE = ("grid_conv2d", "grid_conv2d_dw", "grid_conv3d",
               "grid_conv3d_dw", "slice_gather", "top2", "fused_block",
               "splat_max_bwd", "splat_route", "splat_max",
               "splat_max_winner", "slice_bwd", "auction_window")
# kernels short enough that a loop of launches may time their wrappers on
# the host: their entries also carry the device time of a CUDA graph
# replay (``device_ms``, ``device_bound_share``; per shape, against the
# library call's, ``faster_than_library_device``)
DEVICE_TIMED = ("slice_gather", "top2", "fused_block", "splat_max_bwd",
                "splat_route", "splat_max", "splat_max_winner", "slice_bwd",
                "auction_window")
# the path whose run gives each kernel's ``launches``
MAIN_PATH = {"splat_max": "serving", "slice_gather": "serving",
             "grid_conv3d": "serving", "splat_max_bwd": "training",
             "slice_bwd": "training", "grid_conv3d_dw": "training",
             "top2": "completion", "auction_window": "window",
             "grid_conv2d": "serving_set_a",
             "grid_conv2d_dw": "training_set_a",
             "splat_max_winner": "training_set_a",
             "splat_route": "training_set_a", "fused_block": "serving_set_b"}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters=200):
    """Host time to launch one ``fn()``: ``iters`` calls from a synchronised
    start, timed on the host clock before the card catches up (its launch
    queue takes them all).  Where it exceeds the device time, a loop of
    launches (``cuda_ms``) reads this."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t * 1e3 / iters


def graph_ms(fn, iters=20, replays=5):
    """Device time of one ``fn()``: ``iters`` calls captured in a CUDA
    graph (after a warm-up on a side stream) and replayed ``replays``
    times between CUDA events.  Beside ``cuda_ms`` for kernels that take
    about as long as their wrappers do on the host: the replay leaves the
    host out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # captured on the warm-up stream, whose top2 arrival counts exist
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


def bound(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mapping_inputs(sizes, f, gen, b=B, k=K):
    """A kernel-input mapping as the forward makes it: tanh lattice ->
    grid_mapping, rows per (b, h); values like post-BN features.  Also
    returns the keys per row, [B * H, K, dim], clipped as grid_mapping
    clips."""
    from cloud_transformers_tpu_torch.core.grid_mapping import grid_mapping
    from cloud_transformers_tpu_torch.core.splat_slice import (
        _flatten_mapping)
    lat = torch.tanh(torch.randn(b, k, H, len(sizes), generator=gen,
                                 device="cuda"))
    mapping = _flatten_mapping(grid_mapping(lat, sizes, len(sizes)))
    values = torch.randn(b * H, k, f, generator=gen, device="cuda")
    keys = lat.transpose(1, 2).reshape(b * H, k, len(sizes)).clamp(
        -1 + 1e-7, 1 - 1e-7)
    return [a.contiguous() for a in mapping], values, keys


def ragged_inputs(sizes, f, gen, b=KP_B, k=KP_K):
    """``mapping_inputs`` for rows as the KPConv protocol pads them: a
    cloud's first n points are valid (n / k drawn from KP_VALID), the rest
    repeat valid points' keys with zero values (the model's mask zeroes a
    padded point's values before the splat).  -> (mapping, values, keys,
    the row mask [B * H, K])."""
    from cloud_transformers_tpu_torch.core.grid_mapping import grid_mapping
    from cloud_transformers_tpu_torch.core.splat_slice import (
        _flatten_mapping)
    lo, hi = KP_VALID
    lat = torch.tanh(torch.randn(b, k, H, len(sizes), generator=gen,
                                 device="cuda"))
    share = lo + (hi - lo) * torch.rand(b, generator=gen, device="cuda")
    n = (share * k).long().clamp(1, k)
    pos = torch.arange(k, device="cuda")[None]
    valid = pos < n[:, None]
    src = (torch.rand(b, k, generator=gen, device="cuda") * n[:, None]).long()
    lat = torch.gather(lat, 1, torch.where(valid, pos, src)[
        ..., None, None].expand_as(lat))
    mapping = _flatten_mapping(grid_mapping(lat, sizes, len(sizes)))
    mask = valid.float().repeat_interleave(H, 0)
    values = torch.randn(b * H, k, f, generator=gen, device="cuda") * \
        mask[..., None]
    keys = lat.transpose(1, 2).reshape(b * H, k, len(sizes)).clamp(
        -1 + 1e-7, 1 - 1e-7)
    return [a.contiguous() for a in mapping], values, keys, mask


def grid_sample_inputs(grid, keys, sizes):
    """The flat grid [R, G, F] and keys [R, K, dim] laid out for
    ``F.grid_sample``: input [R, F, X, Y(, Z)], sample points [R, 1(, 1), K,
    dim] with the coordinates in (last axis, ..., first axis) order.
    align_corners=True maps [-1, 1] to [0, size - 1], the mapping's scale."""
    r, k, dim = keys.shape
    inp = grid.reshape((r,) + tuple(sizes) + (grid.shape[-1],)).movedim(-1, 1)
    pts = keys.flip(-1).reshape((r,) + (1,) * (dim - 1) + (k, dim))
    return inp.contiguous(), pts.contiguous()


def grid_sample_slice(inp, pts):
    return torch.nn.functional.grid_sample(
        inp, pts, mode="bilinear", padding_mode="zeros", align_corners=True)


def held(what, got, plain, tol):
    """Max abs error of ``got`` against ``plain``; raises above ``tol``
    times max(1, max |plain|)."""
    err = float((got - plain).abs().max())
    scale = max(1.0, float(plain.abs().max()))
    if not err <= tol * scale:
        raise AssertionError(f"{what}: max abs err {err} > {tol} x {scale}")
    return err


def touched_rows(ps, mapping, sizes):
    """The grid rows a mapping's points read: distinct (row, cell) with a
    vertex weight > 0."""
    r = mapping[0].shape[0]
    cells = ps.kernel_grid_dims(sizes)[2]
    idx, w = ps.vertex_index_weights(*mapping, sizes)
    return int(torch.unique(
        (torch.arange(r, device="cuda")[:, None, None] * cells
         + idx)[w > 0]).numel())


def shape_name(sizes, f, r=R, k=K):
    """A shape's name in the kernels line: its grid and F, and its rows
    and points where they are not the classifier's."""
    name = f"{'x'.join(map(str, sizes))} F={f}"
    return name if r == R else f"{name} R={r} K={k}"


def check_splat(ps, mapping, values, sizes, f, calls):
    """``splat_max`` at one shape: bit-equal to the plain version and over
    two runs; timed by the loop, by graph replay and on the host, beside
    ``scatter_reduce_`` amax on products expanded outside the timing (held
    to the plain version).  -> (its entry, the grid)."""
    r, k = mapping[0].shape
    shape = shape_name(sizes, f, r, k)
    cells = ps.kernel_grid_dims(sizes)[2]
    grid = ps.splat_max(*mapping, values, sizes)
    plain = ps.splat_max_plain(*mapping, values, sizes)
    n_diff = int((grid != plain).sum())
    if n_diff:
        raise AssertionError(f"splat_max {shape}: {n_diff} elements differ "
                             "from the plain version")
    if not torch.equal(grid, ps.splat_max(*mapping, values, sizes)):
        raise AssertionError(f"splat_max {shape}: two runs differ")
    idx, w = ps.vertex_index_weights(*mapping, sizes)
    index = idx.reshape(r, k * 8, 1).expand(r, k * 8, f).contiguous()
    src = (w[..., None] * values[:, :, None, :]).reshape(r, k * 8, f)

    def library():
        return torch.zeros(r, cells, f, device="cuda").scatter_reduce_(
            1, index, src, "amax")
    if not torch.equal(library(), plain):
        raise AssertionError(f"scatter_reduce_ {shape}: not the plain splat")
    del plain, idx, w

    def splat():
        return ps.splat_max(*mapping, values, sizes)
    row = dict(
        shape=shape, calls=calls, max_abs_err=0.0,
        plan=ps.splat_plan(r, k, f, sizes)._asdict(),
        ms=cuda_ms(splat), device_ms=graph_ms(splat), host_ms=host_ms(splat),
        plain_ms=cuda_ms(lambda: ps.splat_max_plain(*mapping, values, sizes),
                         iters=5),
        library_ms=cuda_ms(library),
        # reads the mapping and the values; writes the grid
        bound=bound(r * k * 40 + r * k * f * 4 + r * cells * f * 4,
                    r * k * 2 ** len(sizes) * f * 2))
    return row, grid


def check_winner_splat(ps, mapping, values, grid, winner, sizes, f, calls):
    """``splat_max_winner`` at one shape: its grid bit-equal to the plain
    version's and to ``splat_max``'s (``grid``), its map equal to the plain
    map and to the two-pass backward's (``winner``), two runs bit-equal;
    timed by the loop, by graph replay and on the host.  -> its entry."""
    r, k = mapping[0].shape
    shape = shape_name(sizes, f, r, k)
    cells = ps.kernel_grid_dims(sizes)[2]
    w_grid, w_map = ps.splat_max_winner(*mapping, values, sizes)
    p_grid, p_map = ps.splat_max_winner_plain(*mapping, values, sizes)
    if not (torch.equal(w_grid, p_grid) and torch.equal(w_map, p_map)
            and torch.equal(w_grid, grid) and torch.equal(w_map, winner)):
        raise AssertionError(f"splat_max_winner {shape}: the grid or the "
                             "winner map differs from the plain version's")
    if not all(torch.equal(a, b) for a, b in zip(
            ps.splat_max_winner(*mapping, values, sizes), (w_grid, w_map))):
        raise AssertionError(f"splat_max_winner {shape}: two runs differ")
    splat_plan = ps.splat_plan(r, k, f, sizes)
    bwd_plan = ps.splat_bwd_plan(r, k, f, sizes)

    def winner_splat():
        return ps.splat_max_winner(*mapping, values, sizes)
    return dict(
        shape=shape, calls=calls,
        max_abs_err=float((w_grid - p_grid).abs().max()),
        won=int((w_map != ps.NO_WINNER).sum()),
        plan={"splat": splat_plan._asdict(),
              "winners_in_splat": ps.winners_in_splat(splat_plan),
              "winner_pass": None if ps.winners_in_splat(splat_plan) else {
                  key: getattr(bwd_plan, key) for key in (
                      "winner_group", "winner_blocks", "winner_features")}},
        ms=cuda_ms(winner_splat), device_ms=graph_ms(winner_splat),
        host_ms=host_ms(winner_splat),
        plain_ms=cuda_ms(lambda: ps.splat_max_winner_plain(
            *mapping, values, sizes), iters=3, warmup=1),
        library_ms=None,
        # reads the mapping and the values; writes the grid and the map
        bound=bound(r * k * 40 + r * k * f * 4 + 2 * r * cells * f * 4,
                    r * k * 2 ** len(sizes) * f * 2))


def check_splat_backward(ps, gen, mapping, values, grid, sizes, f, calls,
                         touched):
    """The splat backward's two passes and the routing pass alone at one
    shape, on the forward's own grid (so that winners exist): the winner
    map equal to the plain one, the same set of contributions routed, the
    gradients within ROUTE_TOL, and ``splat_route`` on that map bit-equal
    to the two-pass backward.  -> (splat_max_bwd's entry, splat_route's
    entry), each timed by the loop, by graph replay and on the host."""
    r, k = mapping[0].shape
    shape = shape_name(sizes, f, r, k)
    cells = ps.kernel_grid_dims(sizes)[2]
    n_vert = 2 ** len(sizes)
    map_bytes = r * k * 40
    plan = ps.splat_bwd_plan(r, k, f, sizes)._asdict()
    g = torch.randn(grid.shape, generator=gen, device="cuda")
    d_lo, d_hi, d_val, winner = ps.splat_max_bwd(
        *mapping, values, grid, g, sizes, return_winner=True)
    if not torch.equal(winner, ps.splat_winner_plain(*mapping, values, grid,
                                                     sizes)):
        raise AssertionError(f"splat_max_bwd {shape}: the winner map "
                             "differs from the plain version")
    p_lo, p_hi, p_val = ps.splat_max_bwd_plain(*mapping, values, grid, g,
                                               sizes)
    if not torch.equal(d_val != 0, p_val != 0):
        raise AssertionError(f"splat_max_bwd {shape}: another set of "
                             "contributions was routed")
    err = max(held(f"splat_max_bwd {shape} {n}", a, b, ROUTE_TOL)
              for n, a, b in (("d_w_lo", d_lo, p_lo), ("d_w_hi", d_hi, p_hi),
                              ("d_values", d_val, p_val)))
    again = ps.splat_max_bwd(*mapping, values, grid, g, sizes,
                             return_winner=True)
    if not all(torch.equal(a, b) for a, b in zip(again,
                                                 (d_lo, d_hi, d_val, winner))):
        raise AssertionError(f"splat_max_bwd {shape}: two runs differ")
    del again, p_lo, p_hi, p_val

    def bwd():
        return ps.splat_max_bwd(*mapping, values, grid, g, sizes)
    bwd_row = dict(
        shape=shape, calls=calls, max_abs_err=err, plan=plan,
        grid_rows_read=touched, grid_rows=r * cells,
        won=int((winner != ps.NO_WINNER).sum()),
        ms=cuda_ms(bwd), device_ms=graph_ms(bwd), host_ms=host_ms(bwd),
        plain_ms=cuda_ms(lambda: ps.splat_max_bwd_plain(
            *mapping, values, grid, g, sizes), iters=3, warmup=1),
        library_ms=None,
        # reads the mapping, the values and the touched rows of the grid
        # and of the cotangent; writes d_values and the two d_w
        bound=bound(map_bytes + r * k * f * 4 + 2 * touched * f * 4
                    + r * k * f * 4 + r * k * 32,
                    r * k * n_vert * f * 5))
    routed = ps.splat_route(*mapping, values, winner, g, sizes)
    if not all(torch.equal(a, b) for a, b in zip(routed, (d_lo, d_hi, d_val))):
        raise AssertionError(f"splat_route {shape}: not bit-equal to the "
                             "two-pass splat_max_bwd")
    plain = ps.splat_route_plain(*mapping, values, winner, g, sizes)
    err = max(held(f"splat_route {shape} {n}", a, b, ROUTE_TOL)
              for n, a, b in zip(("d_w_lo", "d_w_hi", "d_values"), routed,
                                 plain))
    del routed, plain, d_lo, d_hi, d_val

    def route():
        return ps.splat_route(*mapping, values, winner, g, sizes)
    route_row = dict(
        shape=shape, calls=calls, max_abs_err=err, plan=plan,
        grid_rows_read=touched, grid_rows=r * cells,
        ms=cuda_ms(route), device_ms=graph_ms(route), host_ms=host_ms(route),
        plain_ms=cuda_ms(lambda: ps.splat_route_plain(
            *mapping, values, winner, g, sizes), iters=3, warmup=1),
        library_ms=None,
        # reads the mapping, the values and the touched rows of the winner
        # map and of the cotangent; writes d_values and the two d_w
        bound=bound(map_bytes + r * k * f * 4 + 2 * touched * f * 4
                    + r * k * f * 4 + r * k * 32,
                    r * k * n_vert * f * 4))
    return bwd_row, route_row, winner


def check_slice(ps, mapping, grid, keys, sizes, f, calls, touched):
    """``slice_gather`` at one shape, on a grid of the forward's kind (the
    splat's output): within TOL of the plain version; timed by the loop,
    by graph replay and on the host, beside one ``grid_sample`` call on
    layouts made outside the timing (held to the plain version).  -> its
    entry."""
    r, k = mapping[0].shape
    shape = shape_name(sizes, f, r, k)
    cells = ps.kernel_grid_dims(sizes)[2]
    out = ps.slice_gather(*mapping, grid, sizes)
    plain = ps.slice_plain(*mapping, grid, sizes)
    err = held(f"slice {shape}", out, plain, TOL)
    inp, pts = grid_sample_inputs(grid, keys, sizes)
    lib = grid_sample_slice(inp, pts).reshape(r, f, k).transpose(1, 2)
    lib_err = held(f"grid_sample {shape}", lib, plain, LIB_TOL)
    del plain, out, lib

    def slice_():
        return ps.slice_gather(*mapping, grid, sizes)

    def library():
        return grid_sample_slice(inp, pts)
    return dict(
        shape=shape, calls=calls, max_abs_err=err, library_err=lib_err,
        grid_rows_read=touched, grid_rows=r * cells,
        plan=ps.slice_plan(r, k, f, sizes)._asdict(),
        ms=cuda_ms(slice_), device_ms=graph_ms(slice_),
        host_ms=host_ms(slice_),
        plain_ms=cuda_ms(lambda: ps.slice_plain(*mapping, grid, sizes),
                         iters=5),
        library_ms=cuda_ms(library), library_device_ms=graph_ms(library),
        library_host_ms=host_ms(library),
        # reads the mapping and the touched grid rows; writes the points
        bound=bound(r * k * 40 + touched * f * 4 + r * k * f * 4,
                    r * k * 2 ** len(sizes) * f * 2))


def check_point_backwards(ps, rows, gen, mapping, values, grid, sizes, f,
                          n_splat, n_slice, touched, mask=None):
    """The splat and slice backward kernels at one main-path shape.  The
    splat's ``grid`` is the forward's own output, so winners exist;
    ``mask`` as in ``check_slice_bwd``."""
    bwd_row, route_row, winner = check_splat_backward(
        ps, gen, mapping, values, grid, sizes, f, n_splat, touched)
    rows["splat_max_bwd"].append(bwd_row)
    rows["splat_route"].append(route_row)

    # set A: the splat that records the winner map in the forward, then the
    # routing pass alone, bit-equal to the two-pass backward
    rows["splat_max_winner"].append(check_winner_splat(
        ps, mapping, values, grid, winner, sizes, f, n_splat))
    del winner

    rows["slice_bwd"].append(check_slice_bwd(ps, gen, mapping, grid, sizes,
                                             f, n_slice, touched, mask))


def check_slice_bwd(ps, gen, mapping, grid, sizes, f, calls, touched,
                    mask=None):
    """``slice_bwd`` at one shape, on a grid of the forward's kind: its
    outputs bit-equal over two runs (d_grid is summed in fixed point) and
    within TOL of the plain version; timed by the loop, by graph replay and
    on the host, beside ``scatter_add_`` (the d_grid half: one call on
    products expanded outside the timing, held to the plain version).
    Where ``mask`` [R, K] is given, a padded point's cotangent is 0 (the
    model's mask zeroes its output after the slice) and so are its vertex
    weights' gradients.  -> its entry."""
    r, k = mapping[0].shape
    shape = shape_name(sizes, f, r, k)
    cells = ps.kernel_grid_dims(sizes)[2]
    g_pts = torch.randn(r, k, f, generator=gen, device="cuda")
    if mask is not None:
        g_pts *= mask[..., None]
    d_grid, d_lo, d_hi = ps.slice_bwd(*mapping, g_pts, grid, sizes)
    if not all(torch.equal(a, b) for a, b in zip(
            ps.slice_bwd(*mapping, g_pts, grid, sizes),
            (d_grid, d_lo, d_hi))):
        raise AssertionError(f"slice_bwd {shape}: two runs differ")
    p_grid, p_lo, p_hi = ps.slice_bwd_plain(*mapping, g_pts, grid, sizes)
    err = max(held(f"slice_bwd {shape} {n}", a, b, TOL)
              for n, a, b in (("d_grid", d_grid, p_grid),
                              ("d_w_lo", d_lo, p_lo), ("d_w_hi", d_hi, p_hi)))
    if len(sizes) == 2 and (d_lo[..., 2:].any() or d_hi[..., 2:].any()):
        raise AssertionError(f"slice_bwd {shape}: 2D slots 2, 3 not zero")
    if mask is not None and (d_lo[mask == 0].any() or d_hi[mask == 0].any()):
        raise AssertionError(f"slice_bwd {shape}: a padded point's vertex "
                             "weights have a gradient")
    del d_grid, d_lo, d_hi, p_lo, p_hi
    idx, w = ps.vertex_index_weights(*mapping, sizes)
    index = idx.reshape(r, k * 8, 1).expand(r, k * 8, f).contiguous()
    src = (w[..., None] * g_pts[:, :, None, :]).reshape(r, k * 8, f)
    del idx, w

    def library():
        return torch.zeros(r, cells, f, device="cuda").scatter_add_(
            1, index, src)
    lib_err = held(f"scatter_add_ {shape}", library(), p_grid, LIB_TOL)
    del p_grid

    def slice_bwd():
        return ps.slice_bwd(*mapping, g_pts, grid, sizes)
    row = dict(
        shape=shape, calls=calls, max_abs_err=err, library_err=lib_err,
        grid_rows_read=touched, grid_rows=r * cells,
        plan=ps.slice_bwd_plan(r, k, f, sizes)._asdict(),
        ms=cuda_ms(slice_bwd), device_ms=graph_ms(slice_bwd),
        host_ms=host_ms(slice_bwd),
        plain_ms=cuda_ms(lambda: ps.slice_bwd_plain(
            *mapping, g_pts, grid, sizes), iters=3, warmup=1),
        library_ms=cuda_ms(library), library_device_ms=graph_ms(library),
        # reads the mapping, the point cotangents and the touched grid
        # rows; writes the whole d_grid (zeros included) and the two d_w
        bound=bound(r * k * 40 + r * k * f * 4 + touched * f * 4
                    + r * cells * f * 4 + r * k * 32,
                    r * k * 2 ** len(sizes) * f * 4))
    del index, src
    return row


def check_kernels(gen):
    """Phase 3: compare, time and bound every kernel at each shape."""
    from cloud_transformers_tpu_torch.ops import pallas_grid_conv as gc
    from cloud_transformers_tpu_torch.ops import pallas_splat as ps
    rows = {name: [] for name in REPLACES}
    for sizes, f, n_splat, n_slice in POINT_SHAPES:
        mapping, values, keys = mapping_inputs(sizes, f, gen)
        splat_row, grid = check_splat(ps, mapping, values, sizes, f, n_splat)
        rows["splat_max"].append(splat_row)
        touched = touched_rows(ps, mapping, sizes)
        rows["slice_gather"].append(check_slice(ps, mapping, grid, keys,
                                                sizes, f, n_slice, touched))
        # the backward kernels run 4 times per shape in a step (the pools'
        # fifth splat has no slice)
        check_point_backwards(ps, rows, gen, mapping, values, grid, sizes,
                              f, n_splat, n_slice, touched)
        del grid
    for sizes, f, n_conv, n_set_a in CONV_SHAPES:
        check_conv(gc, rows, gen, sizes, f, n_conv, n_set_a)
    for sizes, f, n_set_a in CONV2D_SHAPES:
        check_conv(gc, rows, gen, sizes, f, n_set_a, n_set_a)
    for sizes, f, n_set_b in BLOCK_SHAPES:
        rows["fused_block"].append(check_fused_block(gen, sizes, f, n_set_b))
    return rows


def check_conv(gc, rows, gen, sizes, f, calls, calls_set_a):
    """The grid conv and its weight gradient of the grid's dimension at one
    shape; ``calls`` per forward (per step for the weight gradient) on the
    kernel's main path, ``calls_set_a`` under set A."""
    dim = len(sizes)
    fwd, dw = ("grid_conv2d", "grid_conv2d_dw") if dim == 2 else (
        "grid_conv3d", "grid_conv3d_dw")
    conv = torch.nn.functional.conv2d if dim == 2 else \
        torch.nn.functional.conv3d
    shape = shape_name(sizes, f)
    cells = int(np.prod(sizes))
    grid = torch.randn(R, cells, f, generator=gen, device="cuda").relu()
    weight = torch.randn((H * f, f) + (3,) * dim, generator=gen,
                         device="cuda") * (3 ** dim * f) ** -0.5
    bias = torch.randn(H * f, generator=gen, device="cuda") * 0.1
    out = getattr(gc, fwd)(grid, weight, bias, sizes, H)
    plain = gc.grid_conv_plain(grid, weight, bias, sizes, H)
    err = held(f"{fwd} {shape}", out, plain, TOL)
    x_cf = grid.reshape((B, H) + sizes + (f,)).movedim(-1, 2).reshape(
        (B, H * f) + sizes).contiguous()
    lib_out = conv(x_cf, weight, bias, padding=1, groups=H)
    lib_err = held(f"conv{dim}d {shape}", lib_out.reshape(
        (B, H, f) + sizes).movedim(2, -1).reshape(R, cells, f), plain,
        LIB_TOL)
    # (output cell, tap) pairs whose input lies inside the grid: the taps
    # over the zero padding need no work
    pairs = int(np.prod([3 * s - 2 for s in sizes]))
    rows[fwd].append(dict(
        shape=shape, calls=calls, calls_set_a=calls_set_a, max_abs_err=err,
        library_err=lib_err,
        ms=cuda_ms(lambda: getattr(gc, fwd)(grid, weight, bias, sizes, H)),
        plain_ms=cuda_ms(lambda: gc.grid_conv_plain(
            grid, weight, bias, sizes, H), iters=5),
        library_ms=cuda_ms(lambda: conv(x_cf, weight, bias, padding=1,
                                        groups=H)),
        bound=bound(2 * R * cells * f * 4 + weight.numel() * 4
                    + bias.numel() * 4,
                    R * (pairs * f * f * 2 + cells * f))))
    del out, plain, lib_out
    # the weight gradient for a cotangent of the output's shape
    g = torch.randn(R, cells, f, generator=gen, device="cuda")
    d_w = getattr(gc, dw)(grid, g, sizes, H)
    plain = gc.grid_conv_dw_plain(grid, g, sizes, H)
    err = held(f"{dw} {shape}", d_w, plain, TOL)
    if not torch.equal(d_w, getattr(gc, dw)(grid, g, sizes, H)):
        raise AssertionError(f"{dw} {shape}: two runs differ")
    g_cf = g.reshape((B, H) + sizes + (f,)).movedim(-1, 2).reshape(
        (B, H * f) + sizes).contiguous()

    def library():
        return torch.ops.aten.convolution_backward(
            g_cf, x_cf, weight, None, [1] * dim, [1] * dim, [1] * dim,
            False, [0] * dim, H, (False, True, False))[1]
    lib_err = held(f"convolution_backward {shape}", library(), plain,
                   LIB_TOL)
    rows[dw].append(dict(
        shape=shape, calls=calls, calls_set_a=calls_set_a, max_abs_err=err,
        library_err=lib_err,
        ms=cuda_ms(lambda: getattr(gc, dw)(grid, g, sizes, H)),
        plain_ms=cuda_ms(lambda: gc.grid_conv_dw_plain(grid, g, sizes, H),
                         iters=5),
        library_ms=cuda_ms(library),
        bound=bound(2 * R * cells * f * 4 + weight.numel() * 4,
                    R * pairs * f * f * 2)))


def check_fused_block(gen, sizes, f, calls, b=B, k=K, ragged=False):
    """Set B's fused block at one head group's shape, ``b`` clouds of ``k``
    points (``ragged``: padded as ``ragged_inputs`` pads them), with and
    without gk2: gk bit-equal to the plain composition's, the points and
    gk2 within TOL, two runs bit-equal.  Timed beside the three separate
    kernels on the same inputs (by the loop and by graph replay); no single
    PyTorch call computes the block.  -> its entry."""
    from cloud_transformers_tpu_torch.ops import pallas_fused_block as fb
    from cloud_transformers_tpu_torch.ops import pallas_grid_conv as gc
    from cloud_transformers_tpu_torch.ops import pallas_splat as ps
    dim = len(sizes)
    r = b * H
    shape = shape_name(sizes, f, r, k)
    cells = int(np.prod(sizes))
    mapping, values = (ragged_inputs if ragged else mapping_inputs)(
        sizes, f, gen, b, k)[:2]
    weight = torch.randn((H * f, f) + (3,) * dim, generator=gen,
                         device="cuda") * (3 ** dim * f) ** -0.5
    bias = torch.randn(H * f, generator=gen, device="cuda") * 0.1
    args = (*mapping, values, weight, bias, sizes, H)
    plain = fb.fused_block_plain(*args, want_gk2=True)
    err = 0.0
    for want in (False, True):
        got = fb.fused_block(*args, want_gk2=want)
        if not torch.equal(got[1], plain[1]):
            raise AssertionError(f"fused_block {shape}: gk differs from the "
                                 "plain splat's")
        err = max(err, held(f"fused_block {shape} pts", got[0], plain[0],
                            TOL))
        if want:
            err = max(err, held(f"fused_block {shape} gk2", got[2],
                                plain[2], TOL))
        if not all(torch.equal(x, y) for x, y in zip(
                got, fb.fused_block(*args, want_gk2=want))):
            raise AssertionError(f"fused_block {shape}: two runs differ")
    del got, plain
    conv = gc.grid_conv2d if dim == 2 else gc.grid_conv3d

    def separate():
        gk = ps.splat_max(*mapping, values, sizes)
        return ps.slice_gather(*mapping, conv(gk, weight, bias, sizes, H),
                               sizes)

    def fused():
        return fb.fused_block(*args)
    n_vert = 2 ** dim
    pairs = int(np.prod([3 * s - 2 for s in sizes]))
    return dict(
        shape=shape, calls=calls, max_abs_err=err,
        plan=fb.fused_block_plan(r, k, f, sizes)._asdict(),
        ms=cuda_ms(fused), device_ms=graph_ms(fused), host_ms=host_ms(fused),
        ms_with_gk2=cuda_ms(lambda: fb.fused_block(*args, want_gk2=True)),
        separate_kernels_ms=cuda_ms(separate),
        separate_kernels_device_ms=graph_ms(separate),
        plain_ms=cuda_ms(lambda: fb.fused_block_plain(*args), iters=3,
                         warmup=1),
        library_ms=None,
        # reads the mapping, the values and the weights; writes the points
        # and gk (serving: no gk2)
        bound=bound(r * k * 40 + 2 * r * k * f * 4 + weight.numel() * 4
                    + bias.numel() * 4 + r * cells * f * 4,
                    r * k * n_vert * f * 4
                    + r * (pairs * f * f * 2 + cells * f)))


def check_completion_rows(gen):
    """The fused block, the splat, the splat backward, the winner-tracking
    splat, the routing pass and the slice backward at the completion
    decoder's rows (B = 2 clouds x 16 heads, K = 16384 points) at each head
    group's shape, with the gates of the classifier's shapes.  ->
    {kernel: [entry per shape]}, ``calls`` per completion step (the
    decoder's part)."""
    from cloud_transformers_tpu_torch.ops import pallas_splat as ps
    b, k = COMPLETION_ROWS
    out = {"fused_block": [], "splat_max": [], "splat_max_bwd": [],
           "splat_max_winner": [], "splat_route": [], "slice_bwd": []}
    for sizes, f, calls in BLOCK_SHAPES:
        out["fused_block"].append(check_fused_block(gen, sizes, f, calls,
                                                    b, k))
        mapping, values, _ = mapping_inputs(sizes, f, gen, b, k)
        splat_row, grid = check_splat(ps, mapping, values, sizes, f, calls)
        out["splat_max"].append(splat_row)
        touched = touched_rows(ps, mapping, sizes)
        bwd_row, route_row, winner = check_splat_backward(
            ps, gen, mapping, values, grid, sizes, f, calls, touched)
        out["splat_max_bwd"].append(bwd_row)
        out["splat_route"].append(route_row)
        out["splat_max_winner"].append(check_winner_splat(
            ps, mapping, values, grid, winner, sizes, f, calls))
        out["slice_bwd"].append(check_slice_bwd(
            ps, gen, mapping, grid, sizes, f, calls, touched))
        del mapping, values, grid, winner
        torch.cuda.empty_cache()
    return out


def check_trunk_rows(gen, rows, b, k, ragged=False):
    """Kernels #1-#6 at the rows of a model whose head groups are the
    classifier trunk's without its pools (``b`` clouds x 16 heads, ``k``
    points: the S3DIS segmenter's B = 8 x 4096, the reconstructor
    decoder's B = 4 x 8192, the KPConv protocol's B = 6 x 8192) at each
    head group's shape, with the gates of the classifier's shapes; the
    winner-tracking splat and the routing pass beside them (set A).  With
    ``ragged`` the rows are padded as ``ragged_inputs`` pads them (a
    padded point's values and slice cotangent 0) and the fused block (set
    B) is checked at each shape too.  The grid convs take the same grids
    at any K, so their entries are the classifier's (``rows``), with the
    model's calls.  -> {kernel: [entry per shape]}, ``calls`` per training
    step."""
    from cloud_transformers_tpu_torch.ops import pallas_splat as ps
    out = {name: [] for name in ("splat_max", "slice_gather", "splat_max_bwd",
                                 "splat_route", "splat_max_winner",
                                 "slice_bwd")}
    for sizes, f, _, calls in POINT_SHAPES:
        if ragged:
            mapping, values, keys, mask = ragged_inputs(sizes, f, gen, b, k)
        else:
            (mapping, values, keys), mask = mapping_inputs(
                sizes, f, gen, b, k), None
        splat_row, grid = check_splat(ps, mapping, values, sizes, f, calls)
        out["splat_max"].append(splat_row)
        touched = touched_rows(ps, mapping, sizes)
        out["slice_gather"].append(check_slice(ps, mapping, grid, keys,
                                               sizes, f, calls, touched))
        check_point_backwards(ps, out, gen, mapping, values, grid, sizes, f,
                              calls, calls, touched, mask)
        del mapping, values, keys, grid, mask
        torch.cuda.empty_cache()
    if ragged:
        out["fused_block"] = [check_fused_block(gen, sizes, f, calls, b, k,
                                                ragged=True)
                              for sizes, f, calls in BLOCK_SHAPES]
    # a forward and an input gradient a 3D head group at X >= 16 (4 each a
    # shape), one weight gradient
    for fwd, per in (("grid_conv3d", 2), ("grid_conv3d_dw", 1)):
        out[fwd] = [dict(r, calls=r["calls"] * per) for r in rows[fwd]
                    if r["calls"]]
    return out


BN_SHAPES = ((196608, 512), (65536, 64))   # KPConv B=24 x 8192; cls x 64


def batch_norm_row(gen, n, c):
    """Row 13 at one shape: the BatchNorm kernels against their plain
    versions, in training mode with the ReLU, and their times."""
    from cloud_transformers_tpu_torch.nn.norm import BatchNorm
    from cloud_transformers_tpu_torch.ops import batch_norm as bn_ops
    x = torch.randn(n, c, generator=gen, device="cuda") * 2 + 0.5
    dy = torch.randn(n, c, generator=gen, device="cuda")
    scale = torch.rand(c, generator=gen, device="cuda") + 0.5
    bias = torch.randn(c, generator=gen, device="cuda")
    runs = [(torch.zeros(c, device="cuda"), torch.ones(c, device="cuda"))
            for _ in range(2)]
    mean, rstd = bn_ops.bn_stats(x, *runs[0], 1e-5, 0.1, True)
    p_mean, p_rstd = bn_ops.bn_stats_plain(x, *runs[1], 1e-5, 0.1, True)
    err = {"stats": max(held("bn_stats mean", mean, p_mean, TOL),
                        held("bn_stats rstd", rstd, p_rstd, TOL),
                        held("bn_stats running mean", runs[0][0],
                             runs[1][0], 1e-6),
                        held("bn_stats running var", runs[0][1],
                             runs[1][1], 1e-6))}
    y = bn_ops.bn_apply(x, mean, rstd, scale, bias, True)
    err["apply"] = held("bn_apply", y, bn_ops.bn_apply_plain(
        x, mean, rstd, scale, bias, True), TOL)
    got = bn_ops.bn_backward(x, dy, mean, rstd, scale, bias, True, True)
    want = bn_ops.bn_backward_plain(x, dy, mean, rstd, scale, bias, True,
                                    True)
    err["backward"] = max(held(f"bn_backward {k}", a, b, TOL) for k, a, b
                          in zip(("dx", "d_scale", "d_bias"), got, want))
    one = x.numel() * 4
    calls = {
        "stats": (lambda: bn_ops.bn_stats(x, *runs[0], 1e-5, 0.1, True),
                  lambda: bn_ops.bn_stats_plain(x, *runs[1], 1e-5, 0.1,
                                                True), one),
        "apply": (lambda: bn_ops.bn_apply(x, mean, rstd, scale, bias, True),
                  lambda: bn_ops.bn_apply_plain(x, mean, rstd, scale, bias,
                                                True), 2 * one),
        "backward": (lambda: bn_ops.bn_backward(x, dy, mean, rstd, scale,
                                                bias, True, True),
                     lambda: bn_ops.bn_backward_plain(
                         x, dy, mean, rstd, scale, bias, True, True),
                     3 * one)}
    out = {"shape": [n, c]}
    for name, (kernel, plain, n_bytes) in calls.items():
        ms = cuda_ms(kernel)
        bound_ms = bound(n_bytes, 0)[0]
        out[name] = {"ms": ms, "device_ms": graph_ms(kernel),
                     "bound_ms": bound_ms, "bound_share": bound_ms / ms,
                     "plain_ms": cuda_ms(plain), "max_abs_err": err[name]}
    # a whole forward and backward: the module's kernels against its plain
    # autograd ops (what the kernels replaced) and against the library's
    # BatchNorm of the same [N, C] view (timed here only; the port never
    # calls it)
    module = BatchNorm(c).cuda()
    xg = x.clone().requires_grad_()
    lib_stats = (torch.zeros(c, device="cuda"), torch.ones(c, device="cuda"))

    def step(how):
        if how == "library":
            y = torch.relu(torch.nn.functional.batch_norm(
                xg, *lib_stats, module.scale, module.bias, training=True,
                momentum=module.momentum, eps=module.eps))
        elif how == "plain":
            y = module._plain(xg, True)
        else:
            y = module(xg, relu=True)
        torch.autograd.grad(y, [xg, module.scale, module.bias], dy)
    for how in ("kernels", "plain", "library"):
        key = "module" if how == "kernels" else f"module_{how}"
        out[f"{key}_ms"] = cuda_ms(lambda: step(how))
        out[f"{key}_device_ms"] = profiled_device_ms(lambda: step(how))
    out["module_bound_ms"] = bound(6 * one, 0)[0]
    return out


def profiled_device_ms(fn, iters=20):
    """Device time of one ``fn()``: its kernels and copies summed over
    ``iters`` calls under the profiler (after a warm-up), whatever the
    host's own time between them."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return device_ms(prof.key_averages()) / iters


def plain_batch_norms(model, run, what):
    """``run()`` (a training step of ``model``) with the tracer on -> the
    BatchNorm calls on the card that took the plain ops (``bn.plain``);
    raises unless they are ``model``'s channels-first BatchNorms, one call
    each (the channel-last ones take the kernels, which the launch counts
    hold)."""
    from cloud_transformers_tpu_torch.nn.norm import BatchNorm
    from cloud_transformers_tpu_torch.utils import trace
    trace.take()
    was = trace.enable(True)
    try:
        run()
    finally:
        trace.enable(was)
    got = trace.take()["counts"].get("bn.plain", 0)
    want = sum(m.dim != -1 for m in model.modules()
               if isinstance(m, BatchNorm))
    if got != want:
        raise AssertionError(f"{what}: {got} BatchNorm calls took the plain "
                             f"ops, expected the {want} channels-first ones")
    return got


def batch_norm_phase(gen):
    """Row 13 of the kernel table at each of ``BN_SHAPES`` (phase 3); the
    launches a step come from the main path's runs."""
    return {"source": "cloud_transformers_tpu_torch/csrc/batch_norm.cu",
            "replaces": None,
            "per_shape": [batch_norm_row(gen, n, c) for n, c in BN_SHAPES]}


def bound_top2(pairs, n_bytes):
    """The bid search's least time: ``pairs`` values of 12 float32
    operations and one square root each, the square roots at the
    special-function rate, against ``n_bytes`` moved."""
    t_ops = max(pairs * 12 / F32_FLOP_PER_S, pairs / SFU_OP_PER_S) * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def equal_top2(what, got, plain):
    """Values and indices bit for bit; raises otherwise.  -> 0.0, the
    max abs error."""
    for n, a, b in zip(("best", "better", "best_i"), got, plain):
        if not torch.equal(a, b):
            raise AssertionError(
                f"{what} {n}: {int((a != b).sum())} elements differ from "
                f"the plain version (max abs err "
                f"{float((a.double() - b.double()).abs().max())})")
    return 0.0


def mid_auction_state(x1, x2, eps, until):
    """The staged auction of ``losses/emd.py`` run until at most ``until``
    points of a row are unassigned.  -> (state, rounds)."""
    from cloud_transformers_tpu_torch.losses import emd
    b, n, _ = x1.shape
    state = emd._init_state(b, n, n, x1.device)
    rounds = 0
    caps = [None] + [c for c in (n // 8, n // 16, n // 32, n // 64)
                     if c >= 256]
    for cap, nxt in zip(caps, caps[1:] + [0]):
        while emd._max_unassigned(state[0]) > max(until, nxt):
            idx = (None if cap is None
                   else emd._compact_unassigned(state[0][:, :n], cap))
            state = emd._auction_round(x1, x2, eps, 2048, state, last=False,
                                       idx=idx)
            rounds += 1
    return state, rounds


def check_emd_kernels(gen):
    """Phase 3, the auction's two kernels: compare, time and bound."""
    from cloud_transformers_tpu_torch.losses import emd
    from cloud_transformers_tpu_torch.ops import pallas_emd as pe
    rows = {"top2": [], "auction_window": []}
    for b, w, m in TOP2_SHAPES:
        x1 = torch.rand(b, w, 3, generator=gen, device="cuda") * 2 - 1
        x2 = torch.rand(b, m, 3, generator=gen, device="cuda") * 2 - 1
        price = torch.rand(b, m, generator=gen, device="cuda") * 0.1
        got = pe.top2(x1, x2, price)
        plain = pe.top2_plain(x1, x2, price)
        err = equal_top2(f"top2 {(b, w, m)}", got, plain)
        for skip in (True, False):
            equal_top2(f"top2 {(b, w, m)} skip={skip}",
                       pe._launch_top2(x1, x2, price, skip), plain)
        if not bool(((got[2] >= 0) & (got[2] < m)).all()):
            raise AssertionError(f"top2 {(b, w, m)}: index out of range")

        def library():
            # two library calls and an elementwise pass, not one call
            value = 3.0 - torch.cdist(x1, x2) - price[:, None, :]
            return value.topk(2, dim=-1)
        lib = library()
        lib_err = max(held(f"cdist+topk {(b, w, m)} best",
                           lib.values[..., 0], plain[0], LIB_TOL),
                      held(f"cdist+topk {(b, w, m)} better",
                           lib.values[..., 1], plain[1], LIB_TOL))
        del lib
        rows["top2"].append(dict(
            shape=f"B={b} W={w} M={m}", b=b, w=w, m=m, calls=0.0,
            max_abs_err=err, library_err=lib_err,
            plan=pe.top2_plan(b, w, m)._asdict(),
            ms=cuda_ms(lambda: pe.top2(x1, x2, price)),
            device_ms=graph_ms(lambda: pe.top2(x1, x2, price)),
            host_ms=host_ms(lambda: pe.top2(x1, x2, price)),
            plain_ms=cuda_ms(lambda: pe.top2_plain(x1, x2, price), iters=3,
                             warmup=1),
            library_ms=cuda_ms(library, iters=3, warmup=1),
            bound=bound_top2(b * w * m,
                             (b * w * 3 + b * m * 4 + b * w * 3) * 4)))
        log(f"top2 B={b} W={w} M={m}: {rows['top2'][-1]['ms']:.4f} ms "
            f"({rows['top2'][-1]['device_ms']:.4f} on the device), "
            f"plain {rows['top2'][-1]['plain_ms']:.3f} ms, bit-equal")
        del x1, x2, price, got, plain

    # exact duplicates: the second-best equals the best, the first
    # occurrence wins; and a single target: no second-best
    x1 = torch.rand(2, 1024, 3, generator=gen, device="cuda")
    half = torch.rand(2, 3000, 3, generator=gen, device="cuda")
    x2 = torch.cat([half, half], 1)
    price = torch.zeros(2, 6000, device="cuda")
    got, plain = pe.top2(x1, x2, price), pe.top2_plain(x1, x2, price)
    equal_top2("top2 duplicated targets", got, plain)
    if not (bool((got[2] < 3000).all()) and torch.equal(got[0], got[1])):
        raise AssertionError("top2 duplicated targets: not the first "
                             "occurrence, or the second-best is not the best")
    one = pe.top2(x1, x2[:, :1].contiguous(), price[:, :1].contiguous())
    equal_top2("top2 one target", one, pe.top2_plain(
        x1, x2[:, :1].contiguous(), price[:, :1].contiguous()))
    if not (bool((one[1] == -1e9).all()) and bool((one[2] == 0).all())):
        raise AssertionError("top2 with one target: second-best is not -1e9")
    log("top2: duplicated targets and the single target hold")

    # the window from a mid-auction state
    b, w, m = WINDOW_SHAPE
    eps = 0.004
    x1 = torch.rand(b, m, 3, generator=gen, device="cuda") * 2 - 1
    x2 = torch.rand(b, m, 3, generator=gen, device="cuda") * 2 - 1
    state, rounds = mid_auction_state(x1, x2, eps, 2 * w)
    # the bid search on the same state: every point bids at the prices the
    # auction has reached (what the skip meets in the auction's rounds)
    first = rows["top2"][0]
    if (first["b"], first["w"]) != (b, m):
        raise AssertionError("the first top2 shape is not B=2, W=M=16384")
    equal_top2("top2 mid-auction", pe.top2(x1, x2, state[2]),
               pe.top2_plain(x1, x2, state[2]))
    first["auction_state_device_ms"] = graph_ms(
        lambda: pe.top2(x1, x2, state[2]))
    first["auction_state_device_ms_no_skip"] = graph_ms(
        lambda: pe._launch_top2(x1, x2, state[2], False))
    log(f"top2 on a mid-auction state: "
        f"{first['auction_state_device_ms']:.4f} ms on the device, "
        f"{first['auction_state_device_ms_no_skip']:.4f} without the skip")
    idx = emd._compact_unassigned(state[0][:, :m], w)
    x1w = torch.gather(x1, 1, idx.clamp(max=m - 1)[..., None]
                       .expand(-1, -1, 3)).contiguous()
    j_real = idx.to(torch.int32).contiguous()
    owner = state[1].to(torch.int32)
    unassigned = int((state[0][:, :m] < 0).sum(1).max())
    # the window tail's usual call: a handful of lanes bid, the rest pad
    tail_j = torch.full_like(j_real, m)
    tail_j[:, :5] = j_real[:, :5]
    windows = [
        ("B=2", (x1w, j_real, x2, state[2], owner)),
        ("B=1", (x1w[:1].contiguous(), j_real[:1].contiguous(), x2[:1],
                 state[2][:1].contiguous(), owner[:1].contiguous())),
        ("B=2, 5 lanes", (x1w, tail_j, x2, state[2], owner))]
    for what, inputs in windows:
        bb = inputs[0].shape[0]
        args = inputs + (3000, eps, m)
        got = pe.auction_window(*args, rounds_cap=64)
        *plain, bids = pe.auction_window_plain(*args, rounds_cap=64,
                                               return_bids=True)
        again = pe.auction_window(*args, rounds_cap=64)
        for name, k, c, p in zip(("price", "owner", "used"), got, again,
                                 plain):
            if not (torch.equal(k, p) and torch.equal(c, p)):
                raise AssertionError(
                    f"auction_window {what} {name}: "
                    f"{int((k != p).sum())} elements differ from the plain "
                    f"version, {int((c != p).sum())} in a second call")

        def window():
            return pe.auction_window(*args, rounds_cap=64)
        rows["auction_window"].append(dict(
            shape=f"{what} W={w} M={m}", calls=0.0, max_abs_err=0.0,
            rounds_before=rounds, used=got[2].tolist(), bids=bids,
            unassigned_before=unassigned,
            plan=pe.auction_window_plan(bb, w, m)._asdict(),
            ms=cuda_ms(window), device_ms=graph_ms(window),
            host_ms=host_ms(window),
            plain_ms=cuda_ms(lambda: pe.auction_window_plain(
                *args, rounds_cap=64), iters=2, warmup=0),
            library_ms=None,
            # the bids the data needed, each over M targets
            bound=bound_top2(bids * m, bb * (w * 16 + m * 28))))
        r = rows["auction_window"][-1]
        log(f"auction_window {r['shape']}: used {r['used']} rounds, {bids} "
            f"bids, {r['ms']:.4f} ms ({r['device_ms']:.4f} on the device, "
            f"{r['host_ms']:.4f} on the host), plain {r['plain_ms']:.1f} "
            f"ms, bit-equal over two calls")
    return rows


def per_shape(name, s, per):
    """One shape's entry of the kernels line."""
    return {
        "shape": s["shape"], per: s["calls"],
        "ms": s["ms"], "plain_ms": s["plain_ms"],
        "bound_ms": s["bound"][0], "bound_by": s["bound"][1],
        "library_ms": s["library_ms"],
        "max_abs_err": s["max_abs_err"],
        **({"bound_share": s["bound"][0] / s["ms"]}
           if name in BOUND_SHARE else {}),
        **({"faster_than_library": s["ms"] < s["library_ms"]}
           if name in BOUND_SHARE and s["library_ms"] is not None else {}),
        **({"device_ms": s["device_ms"],
            "device_bound_share": s["bound"][0] / s["device_ms"]}
           if name in DEVICE_TIMED else {}),
        **({"library_device_ms": s["library_device_ms"],
            "faster_than_library_device":
                s["device_ms"] < s["library_device_ms"]}
           if "library_device_ms" in s else {}),
        **({"faster_than_separate_kernels":
                s["ms"] < s["separate_kernels_ms"],
            "faster_than_separate_kernels_device":
                s["device_ms"] < s["separate_kernels_device_ms"]}
           if "separate_kernels_ms" in s else {}),
        **{k: s[k] for k in (
            "library_err", "grid_rows_read", "grid_rows", "won",
            "plan", "host_ms", "library_host_ms",
            "calls_per_evaluated_cloud",
            "auction_state_device_ms",
            "auction_state_device_ms_no_skip",
            "used", "bids",
            "rounds_before", "unassigned_before", "calls_set_a",
            "ms_with_gk2", "separate_kernels_ms",
            "separate_kernels_device_ms") if k in s}}


def per_pass(name, done, per):
    """The sum over shapes of one pass at other rows than the classifier's
    (a completion decoder step, a segmenter step, a reconstructor step, a
    KPConv segmenter step), and its shapes."""
    out = {"ms": sum(c["ms"] * c["calls"] for c in done),
           "plain_ms": sum(c["plain_ms"] * c["calls"] for c in done),
           "bound_ms": sum(c["bound"][0] * c["calls"] for c in done)}
    if all("device_ms" in c for c in done):
        out["device_ms"] = sum(c["device_ms"] * c["calls"] for c in done)
    if all(c["library_ms"] is not None for c in done):
        out["library_ms"] = sum(c["library_ms"] * c["calls"] for c in done)
    if name == "fused_block":
        out["separate_kernels_ms"] = sum(
            c["separate_kernels_ms"] * c["calls"] for c in done)
    out["per_shape"] = [per_shape(name, c, per) for c in done]
    return out


def kernel_line(rows, launches, completion_rows, segmenter_rows,
                reconstructor_rows, kpconv_rows):
    """Per kernel: times summed over the calls of one pass of its path
    (each shape times its calls): one forward for the three kernels of the
    serving path, one training step of the classifier for the three
    backward kernels, one training step of the completion model for
    ``top2``, the one checked call for ``auction_window``; beside them, a
    completion decoder step, a segmenter step, a reconstructor step and a
    KPConv segmenter step on its ragged rows (``completion_rows``,
    ``segmenter_rows``, ``reconstructor_rows``, ``kpconv_rows``).
    ``launches`` is {path: {kernel: count}}: a kernel's ``launches`` is the
    count of its path's run (``MAIN_PATH``), and every path's count stands
    beside it."""
    times_are = {"serving": "per_forward", "training": "per_step",
                 "completion": "per_completion_step",
                 "window": "per_call_from_the_checked_state",
                 "serving_set_a": "per_forward_set_a",
                 "training_set_a": "per_step_set_a",
                 "serving_set_b": "per_forward_set_b"}
    out = []
    for name, shapes in rows.items():
        per = times_are[MAIN_PATH[name]]

        def total(key):
            return sum(s[key] * s["calls"] for s in shapes)
        t_bound = sum(s["bound"][0] * s["calls"] for s in shapes)
        by = max(shapes, key=lambda s: s["bound"][0] * s["calls"])
        lib = (None if any(s["library_ms"] is None for s in shapes)
               else total("library_ms"))
        out.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": launches[MAIN_PATH[name]][name],
            **{f"launches_{path}": counts.get(name, 0)
               for path, counts in launches.items()},
            "times_are": per,
            "max_abs_err": max(s["max_abs_err"] for s in shapes),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": t_bound, "bound_by": by["bound"][1],
            "library_ms": lib,
            **({"library_is": LIBRARY_IS[name]} if name in LIBRARY_IS
               else {}),
            **({"separate_kernels_ms": total("separate_kernels_ms"),
                "separate_kernels_device_ms":
                    total("separate_kernels_device_ms")}
               if name == "fused_block" else {}),
            **({"ms_per_evaluated_cloud": sum(
                    sh["ms"] * sh["calls_per_evaluated_cloud"]
                    for sh in shapes),
                "device_ms_per_evaluated_cloud": sum(
                    sh["device_ms"] * sh["calls_per_evaluated_cloud"]
                    for sh in shapes)}
               if name == "top2" else {}),
            **({"bound_share": t_bound / total("ms")}
               if name in BOUND_SHARE else {}),
            **({"device_ms": total("device_ms"),
                "device_bound_share": t_bound / total("device_ms")}
               if name in DEVICE_TIMED else {}),
            **({"library_device_ms": total("library_device_ms")}
               if "library_device_ms" in shapes[0] else {}),
            "per_shape": [per_shape(name, s, per) for s in shapes],
            **({"per_completion_decoder_step": per_pass(
                name, done, "per_completion_step")}
               if (done := completion_rows.get(name)) else {}),
            **({"per_segmenter_step": per_pass(
                name, seg, "per_segmenter_step")}
               if (seg := segmenter_rows.get(name)) else {}),
            **({"per_reconstructor_step": per_pass(
                name, rec, "per_reconstructor_step")}
               if (rec := reconstructor_rows.get(name)) else {}),
            **({"per_kpconv_step": per_pass(name, kp, "per_kpconv_step")}
               if (kp := kpconv_rows.get(name)) else {}),
        })
    return {"kernels": out}


# the port's names -> the reference implementation's (the inverse of
# ``convert.reference_state_dict``), per layout: (pattern, replacement, the
# port's Linear weight was a Conv1d kernel [out, in, 1] there), tried in
# order on a key outside the unions or on the rest of a union's key
_TO_REF_UNION = (
    (r"attention_(\d+)\.kv\.keys_values_pred\.",
     r"attentions.\1.keys_values_pred.0.", True),
    (r"attention_(\d+)\.kv\.(key_bn|values_bn|transform)\.",
     r"attentions.\1.\2.", False),
    (r"attention_(\d+)\.conv\.", r"attentions.\1.conv.0.", False),
    (r"attention_(\d+)\.after_bn\.", r"attentions.\1.after.0.", False),
    (r"after_conv\.", "after.0.", True),
    (r"after_bn\.", "after.1.", False),
    (r"(shortcut_conv)\.", r"shortcut.\1.", True),
    (r"(shortcut_bn)\.", r"shortcut.\1.", False),
)
_TO_REF_UNION_ADAIN = (
    (r"attention_(\d+)\.keys_values_pred\.",
     r"attentions.\1.keys_values_pred.0.", True),
    (r"attention_(\d+)\.(keys|values)_adain\.dense\.",
     r"attentions.\1.\2_bn.0.linear.", False),
    (r"attention_(\d+)\.(?=scale$)", r"attentions.\1.", False),
    (r"attention_(\d+)\.transform\.", r"attentions.\1.transform.", False),
    (r"attention_(\d+)\.conv\.", r"attentions.\1.conv.0.", False),
    (r"attention_(\d+)\.after_adain\.dense\.",
     r"attentions.\1.after.0.linear.", False),
    (r"after_conv\.", "after.0.", True),
    (r"after_adain\.dense\.", "after.1.linear.", False),
    (r"shortcut_conv\.", "shortcut.shortcut_conv.", True),
    (r"shortcut_adain\.dense\.", "shortcut.shortcut_bn.linear.", False),
)
_TO_REF_RES = {"conv1": "res_branch.0", "bn1": "res_branch.1",
               "conv2": "res_branch.3", "bn2": "res_branch.4",
               "skip_conv": "skip_con.0", "skip_bn": "skip_con.1"}
_TO_REF_RESNET = (0, 3, 7, 13, 16)   # torchvision's (3, 4, 6, 3) blocks


def _to_ref_backbone(port, ref):
    return (
        (port + r"stem\.", ref + "first_process.0.", True),
        (port + r"stem_bn\.", ref + "first_process.1.", False),
        (port + r"(pool[23]d)\.kv\.keys_values_pred\.",
         ref + r"\1.keys_values_pred.0.", True),
        (port + r"(pool[23]d)\.kv\.(key_bn|values_bn|transform)\.",
         ref + r"\1.\2.", False),
        (port + r"res([23]d)\.(\d)\.(\w+)\.",
         lambda m: (f"{ref}after_pool{m.group(1)}.{2 * int(m.group(2))}."
                    f"{_TO_REF_RES[m.group(3)]}."), False),
    )


def _to_ref_resnet_block(m):
    b = int(m.group(1))
    stage = max(i for i, first in enumerate(_TO_REF_RESNET) if b >= first)
    part = {"downsample_conv": "downsample.0",
            "downsample_bn": "downsample.1"}.get(m.group(2), m.group(2))
    return (f"res50_model.0.features.{4 + stage}."
            f"{b - _TO_REF_RESNET[stage]}.{part}.")


_TO_REF_DECODER_HEAD = (
    (r"mapping\.", "mapping.0.", False),
    (r"start_conv\.", "start.0.", True),
    (r"start_adain\.dense\.", "start.1.linear.", False),
    (r"final_conv1\.", "final.0.", True),
    (r"final_adain\.dense\.", "final.1.linear.", False),
    (r"final_conv2\.", "final.3.", True),
)
_TO_REF = {
    "scanobject_classifier": (
        {"backbone.trunk.stages": ("attentions_encoder", _TO_REF_UNION)},
        _to_ref_backbone(r"backbone\.", "") + (
            (r"class_vector\.", "class_vector.0.", False),
            (r"class_vector_bn\.", "class_vector.1.", False),
            (r"class_head\.", "class_head.1.", False),
            (r"mask_conv1\.", "mask_head.1.", True),
            (r"mask_bn\.", "mask_head.2.", False),
            (r"mask_conv2\.", "mask_head.4.", True))),
    "completion_inpainter": (
        {"encoder.backbone.trunk.stages": ("encoder.attentions_encoder",
                                           _TO_REF_UNION),
         "decoder.stages": ("attentions_decoder", _TO_REF_UNION_ADAIN)},
        _to_ref_backbone(r"encoder\.backbone\.", "encoder.") + (
            (r"encoder\.class_head\.", "encoder.class_head.0.", False),
            (r"encoder\.class_head_bn\.", "encoder.class_head.1.", False),
        ) + _TO_REF_DECODER_HEAD),
    "image_reconstructor": (
        {"decoder.stages": ("attentions_decoder", _TO_REF_UNION_ADAIN)}, (
            (r"res50\.trunk\.stem_conv\.", "res50_model.0.features.0.",
             False),
            (r"res50\.trunk\.stem_bn\.", "res50_model.0.features.1.",
             False),
            (r"res50\.trunk\.blocks\.(\d+)\.(\w+)\.", _to_ref_resnet_block,
             False),
        ) + _TO_REF_DECODER_HEAD),
}
_TO_REF["scanobject_classifier_scales"] = _TO_REF["scanobject_classifier"]
_TO_REF_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean",
              "var": "running_var"}


def reference_layout(model_name, state):
    """The port's ``state`` of ``model_name`` -> a state dict with the
    reference implementation's names and layouts (numpy float32), as its
    released ``.t7`` files hold them: what ``convert.reference_state_dict``
    takes back to ``state``."""
    unions, top = _TO_REF[model_name]
    out = {}
    for key, value in state.items():
        rules, prefix, rest = top, "", key
        for port, (ref, union_rules) in unions.items():
            m = re.match(re.escape(port) + r"\.(\d+)\.union_(\d+)\.", key)
            if m:
                i = 3 * int(m.group(1)) + int(m.group(2))
                rules, prefix, rest = union_rules, f"{ref}.{i}.", \
                    key[m.end():]
                break
        for pattern, repl, conv1d in rules:
            head = re.match(pattern, rest)
            if head is None:
                continue
            layer = prefix + (repl(head) if callable(repl)
                              else head.expand(repl))
            leaf = rest[head.end():]
            if re.search(r"bn\d?$", key.rsplit(".", 1)[0]):
                leaf = _TO_REF_BN[leaf]
            a = value.detach().cpu().numpy().astype(np.float32)
            out[layer + leaf] = a[..., None] if conv1d and \
                leaf == "weight" else a
            break
        else:
            raise KeyError(f"{key!r} has no reference name")
    return out


def requests(rng, n):
    sizes = [1500, 2048, 3000, 1800, 2048, 2500, 1024, 2048]
    return [rng.uniform(-1, 1, (sizes[i % len(sizes)], 3)).astype(np.float32)
            for i in range(n)]


def parity(card, cpu, what):
    a = card.reshape(-1).double()
    b = cpu.reshape(-1).double()
    cos = float(torch.dot(a, b) / (a.norm() * b.norm()))
    p50 = float((a - b).abs().median())
    log(f"parity {what}: cosine {cos:.7f}  p50 err {p50:.3e}  "
        f"max err {float((a - b).abs().max()):.3e}")
    if not (cos > 0.999 and p50 <= 1e-3):
        raise AssertionError(f"{what}: card vs CPU cosine {cos}, p50 {p50}")
    return cos, p50


def device_ms(events):
    """Kernels and copies on the card, summed as the profiler table's
    footer sums them; one stream, so they do not overlap."""
    return sum(
        e.self_device_time_total for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)) / 1e3


# device kernels by a part of their name, first match wins
KERNEL_GROUPS = (
    ("top2_kernel", "top2"), ("auction_window_kernel", "auction_window"),
    # the 2D kernels ahead of the 3D patterns
    ("conv2d_dw_kernel", "grid_conv2d_dw"),
    ("conv2d_dw_sum_kernel", "grid_conv2d_dw"),
    ("conv2d_fwd_kernel", "grid_conv2d"),
    ("grid_conv3d_dw", "grid_conv3d_dw"),
    # the forward and its weight packing pass
    ("grid_conv3d_", "grid_conv3d"),
    ("fused_block", "fused_block"), ("fused_cluster", "fused_block"),
    # the winner-tracking splat's two launches: splat_max's kernel and
    # splat_max_bwd's winner pass, tagged use::splat_max_winner
    ("splat_max_winner", "splat_max_winner"),
    ("splat_winner", "splat_max_bwd"),
    # the routing pass: splat_max_bwd's second pass, or splat_route alone
    ("splat_route", "splat routing pass (splat_max_bwd, splat_route)"),
    ("splat_slab", "splat_max"), ("slice_bwd", "slice_bwd"),
    ("slice_kernel", "slice_gather"),
    ("cudnn", "cuDNN convolutions and their layout kernels"),
    ("implicit_gemm", "cuDNN convolutions and their layout kernels"),
    ("implicit_convolve", "cuDNN convolutions and their layout kernels"),
    # cuDNN's bf16 convs: its CUTLASS fprop and its direct and tiled
    # weight-gradient kernels, whose names carry no "cudnn"
    ("fprop", "cuDNN convolutions and their layout kernels"),
    ("dgrad", "cuDNN convolutions and their layout kernels"),
    ("wgrad", "cuDNN convolutions and their layout kernels"),
    ("gemm", "matmuls (cuBLAS, CUTLASS)"),
    # cuBLASLt's Hopper kernels (the bf16 matmuls)
    ("nvjet", "matmuls (cuBLAS, CUTLASS)"),
    ("", "elementwise, reductions, copies and the rest"))


def device_table(events, passes, limit=40):
    """The kernels and copies on the card by self time, per pass (forward
    or training step): sums by ``KERNEL_GROUPS``, then ms and launches of
    the longest kernels."""
    rows = sorted(((e.self_device_time_total / 1e3 / passes,
                    e.count / passes, e.key) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)),
                  reverse=True)
    total = sum(ms for ms, _, _ in rows)
    groups = {}
    for ms, n, key in rows:
        name = next(g for part, g in KERNEL_GROUPS if part in key)
        t, c = groups.get(name, (0.0, 0.0))
        groups[name] = (t + ms, c + n)
    lines = [f"{ms:10.3f} ms {100 * ms / total:5.1f}% {n:9.1f} launches  "
             f"{name}" for name, (ms, n) in sorted(
                 groups.items(), key=lambda item: -item[1][0])]
    lines.append(f"{total:10.3f} ms in all, "
                 f"{sum(n for _, n, _ in rows):.1f} launches")
    lines += [f"{ms:10.3f} ms {n:9.1f} launches  {key[:120]}"
              for ms, n, key in rows[:limit]]
    rest = sum(ms for ms, _, _ in rows[limit:])
    return "\n".join(lines + [f"{rest:10.3f} ms in {len(rows) - limit} "
                              "more kernels"] * (len(rows) > limit))


@contextlib.contextmanager
def switches(name):
    """The port's execution switches set as ``name`` ("set_a", "set_b")
    says, and back to the defaults afterwards."""
    from cloud_transformers_tpu_torch.core import splat_slice as ss
    from cloud_transformers_tpu_torch.nn import grouped_conv as gcm
    try:
        if name == "set_a":
            gcm.set_grid_conv_strategy("pallas")
            ss.FWD_WINNER = True
        elif name == "set_b":
            gcm.set_block_fusion("fused")
        else:
            raise ValueError(name)
        yield
    finally:
        gcm.set_grid_conv_strategy(None)
        gcm.set_block_fusion(None)
        ss.FWD_WINNER = False


def set_counts(name, per_pass, training):
    """Launches per forward (or per training step) under a set, from the
    default path's (``per_pass``) splat and slice counts of a model whose
    head groups are half 2D and half 3D (the pools' splats have no slice):
    each slice is one head group.  The BatchNorm kernels launch as on the
    default path.  The classifier (26 splats, 24 slices): set A 26 splat,
    24 slice, 12 + 12 conv per forward; per step 26 winner splats and
    routing passes, 24 slice and slice backward, 24 + 24 conv, 12 + 12
    weight gradients.  Set B 24 fused and 2 splat per forward; per step 24
    fused, 2 splat, 26 splat backward, 24 slice backward, 12 of each conv
    and each weight gradient."""
    n_splat, n_slice = per_pass["splat_max"], per_pass["slice_gather"]
    groups = n_slice // 2   # of each dimension
    normed = {k: v for k, v in per_pass.items() if k in BN_WRAPPERS}
    if name == "set_a":
        if not training:
            return {"splat_max": n_splat, "slice_gather": n_slice,
                    "grid_conv3d": groups, "grid_conv2d": groups} | normed
        return {"splat_max_winner": n_splat, "splat_route": n_splat,
                "slice_gather": n_slice, "slice_bwd": n_slice,
                "grid_conv3d": 2 * groups, "grid_conv3d_dw": groups,
                "grid_conv2d": 2 * groups, "grid_conv2d_dw": groups} | normed
    if not training:
        return {"fused_block": n_slice,
                "splat_max": n_splat - n_slice} | normed
    return {"fused_block": n_slice, "splat_max": n_splat - n_slice,
            "splat_max_bwd": n_splat, "slice_bwd": n_slice,
            "grid_conv3d": groups, "grid_conv3d_dw": groups,
            "grid_conv2d": groups, "grid_conv2d_dw": groups} | normed


def remat_counts(policy, per_step, union_bns=0):
    """Launches a training step under the remat ``policy`` (as
    ``nn/remat.policy`` names it; None: off) from the same step's launches
    with remat off: under ``"point_io"`` and ``"full"`` each head group's
    kernel chain runs once more in the backward (a splat and a slice a head
    group, which is a slice of the step, and the 3D convs with X >= 16, as
    many as their weight gradients); ``"point_io_grids"`` recomputes only
    dense ops.  Under every policy the ``union_bns`` BatchNorms inside the
    unions (``UNION_BNS``) run their statistics and apply kernels once more
    in the backward."""
    out = dict(per_step)
    if policy is not None and union_bns:
        for name in ("bn_stats", "bn_apply"):
            out[name] = out.get(name, 0) + union_bns
    if policy in ("point_io", "full"):
        groups = per_step.get("slice_gather", 0)
        for name, extra in (("splat_max", groups), ("slice_gather", groups),
                            ("grid_conv3d", per_step.get("grid_conv3d_dw",
                                                         0))):
            if extra:
                out[name] = out.get(name, 0) + extra
    return out


def profile_serving(engine, batches, smi, path):
    """``PROFILE_CALLS`` more classify calls under torch.profiler: the
    device kernels by group in ``path``.  -> {profiled_...} with the device
    busy time and host wall time of the same window; the profiler's own
    host cost makes this idle share an upper bound."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for clouds in batches[:PROFILE_CALLS]:
            engine.classify(clouds)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    busy = device_ms(events)
    profiled = {"profiled_calls": PROFILE_CALLS,
                "profiled_wall_ms_per_forward": wall_ms / PROFILE_CALLS,
                "profiled_device_ms_per_forward": busy / PROFILE_CALLS,
                "profiled_device_idle_share": 1 - busy / wall_ms}
    table = events.table(sort_by="cuda_time_total", row_limit=40)
    with open(path, "w") as fh:
        fh.write(f"{smi}\n{json.dumps(profiled)}\n"
                 f"device kernels, per forward:\n"
                 f"{device_table(events, PROFILE_CALLS)}\n"
                 f"(totals over {PROFILE_CALLS} classify calls)\n{table}")
    log(json.dumps(profiled))
    return profiled


def switched_serving(name, engine, cpu_engine, batches, wrappers, smi,
                     profile_dir):
    """The serving path under a set: the timed, counted classify calls, one
    forward under ``set_sync_debug_mode("error")``, and the card's logits
    and mask against the CPU's for one cloud; with ``profile_dir``, the
    profile of ``PROFILE_CALLS`` more calls.  -> (result, launches)."""
    engine.classify(batches[0])                  # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    zero_launches(wrappers)
    call_ms = []
    for clouds in batches:
        t0 = time.perf_counter()
        probs = engine.classify(clouds)
        call_ms.append((time.perf_counter() - t0) * 1e3)
    launches = read_launches(wrappers)
    check_launches(launches, set_counts(name, PER_FORWARD, False),
                   len(batches), f"{name} forwards")
    if probs.shape != (B, 15) or not np.isfinite(probs).all():
        raise AssertionError(f"{name}: bad class probabilities {probs}")
    pcd = torch.from_numpy(engine.pad_batch(batches[0])[0]).to("cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            engine.model(pcd)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    cloud = batches[0][:1]
    (card_cls, card_mask, _), _, _, _ = engine.predict_padded(cloud)
    (cpu_cls, cpu_mask, _), _, _, _ = cpu_engine.predict_padded(cloud)
    parity(card_cls[:1].cpu(), cpu_cls, f"{name} class logits")
    parity(card_mask[:1].cpu(), cpu_mask, f"{name} point mask")
    ms = float(np.median(call_ms))
    log(f"{name}: {ms:.3f} ms/forward (median), launches {launches}")
    result = {"classify_ms_per_forward": ms, "clouds_per_s": B * 1e3 / ms,
              "classify_ms_p10": float(np.percentile(call_ms, 10)),
              "classify_ms_p90": float(np.percentile(call_ms, 90))}
    if profile_dir:
        result.update(profile_serving(engine, batches, smi, os.path.join(
            profile_dir, f"profile_forward_{name}.txt")))
    return result, launches


def endless(loader):
    """Batches of ``loader``, epoch after epoch."""
    epoch = 0
    while True:
        loader.set_epoch(epoch)
        yield from loader
        epoch += 1


def train_phase(wrappers, smi, profile_dir, exp_root, steps=TRAIN_STEPS,
                per_step=PER_STEP, profile_name="profile_train.txt",
                mxu_dtype=None, after=None):
    """Phase 6: optimizer steps on the full-width classifier through the
    Trainer, whose experiment directories go under ``exp_root``, with
    ``per_step`` launches of each kernel in each of the ``steps`` timed
    steps (none of the others).  ``mxu_dtype`` goes into the config's
    ``model.mxu_dtype``; ``after(trainer, batches)`` runs last.  -> (result
    dict, launches in the timed steps)."""
    from cloud_transformers_tpu_torch.tasks import classification
    from cloud_transformers_tpu_torch.train.config import (
        load_config,
        model_from_config,
    )
    from cloud_transformers_tpu_torch.train.trainer import Trainer

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config(os.path.join(root, "configs", "scanobjectnn.yaml"))
    if (cfg["data"]["batch_size"], cfg["data"]["num_points"]) != (B, K):
        raise AssertionError("configs/scanobjectnn.yaml is not B=8 x 2048")
    cfg["experiment"] = {"root": exp_root}
    if mxu_dtype is not None:
        cfg["model"]["mxu_dtype"] = mxu_dtype
    trainer = Trainer(
        model_from_config(cfg), cfg, "chip_smoke",
        classification.make_loss_fn(
            float(cfg["train"].get("seg_weight", 0.5))),
        device="cuda", seed=0)
    train_loader, _ = classification.make_datasets(cfg, synthetic=True)
    batches = endless(train_loader)
    model = trainer.model
    if len(model.backbone.trunk.stages) != 4 or \
            model.backbone.stem.out_features != 512:
        raise AssertionError("the trained model is not the full-width one")

    torch.cuda.reset_peak_memory_stats()
    trainer.train_step(next(batches))            # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    zero_launches(wrappers)
    step_ms, losses = [], []
    for _ in range(steps):
        batch = next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"])
    launches = read_launches(wrappers)
    peak = torch.cuda.max_memory_allocated()
    check_launches(launches, per_step, steps, "training steps")
    log(f"launches in {steps} training steps: {launches}")

    losses = torch.stack(losses).cpu().numpy()
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite training loss: {losses}")
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    if not last < first:
        raise AssertionError(f"the loss did not fall: first 10 steps "
                             f"{first}, last 10 steps {last}")
    key_grad = 0.0
    for name, param in model.named_parameters():
        if param.grad is None or not bool(torch.isfinite(param.grad).all()):
            raise AssertionError(f"{name}: missing or non-finite gradient")
        if name.endswith("key_bn.bias"):
            key_grad = max(key_grad, float(param.grad.abs().max()))
    if not key_grad > 0:
        raise AssertionError("every key_bn.bias gradient is zero: the key "
                             "path through d_w is not connected")
    if trainer.global_step != steps + 1 or \
            trainer.optimizer.lrs != [1e-3]:
        raise AssertionError("the trainer's step count or learning rate "
                             f"is off: {trainer.global_step}, "
                             f"{trainer.optimizer.lrs}")

    # forward, backward and the optimizer step never make the host wait;
    # only the trunk's channels-first BatchNorms take the plain ops
    batch = trainer.to_device(next(batches))
    model.train()
    torch.cuda.synchronize()

    def step():
        torch.cuda.set_sync_debug_mode("error")
        try:
            trainer.optimizer.zero_grad()
            loss, _ = trainer.loss_fn(model, batch)
            loss.backward()
            trainer.optimizer.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    plain = plain_batch_norms(model, step, "training step")
    log(f"training step: no host-device synchronisation; {plain} "
        "BatchNorm calls on the plain ops")

    ms = float(np.median(step_ms))
    result = {"train_ms_per_step": ms, "train_clouds_per_s": B * 1e3 / ms,
              "train_ms_mean": float(np.mean(step_ms)),
              "train_ms_p10": float(np.percentile(step_ms, 10)),
              "train_ms_p90": float(np.percentile(step_ms, 90)),
              "train_steps": steps,
              "train_peak_memory_bytes": int(peak),
              "loss_first10": first, "loss_last10": last,
              "key_bn_bias_grad_max": key_grad, "bn_plain_per_step": plain,
              "batch": B, "points": K}

    if profile_dir:
        result.update(profiled_steps(
            trainer, batches, smi, os.path.join(profile_dir, profile_name),
            "train_"))
    if after is not None:
        after(trainer, batches)
    return result, launches


def gradient_parity():
    """Phase 7: one forward + backward of the same full-width model (one
    stage, train mode, no dropout) on the card with the kernels and on the
    CPU with the plain versions.  -> result dict.

    The weights are a fresh initialisation, so the key BatchNorm's scale is
    0 as at the start of training: the key path's gradient is there (in
    ``key_bn.scale`` and ``key_bn.bias``, through the d_w of both backward
    kernels), and the comparison is well conditioned.  With a key scale of
    0.25 each block multiplies a rounding difference in its keys by about
    (size - 1) / 2, up to 63.5, and the two devices' float32 gradients then
    agree only to a cosine of about 0.98, on the CPU alone as well."""
    from cloud_transformers_tpu_torch.data import ScanObjectNN
    from cloud_transformers_tpu_torch.tasks import classification

    ds = ScanObjectNN(None, train=True, synthetic_items=PARITY_B,
                      num_points=K)
    batch = {k: torch.as_tensor(np.stack([ds[i][k] for i in range(PARITY_B)]))
             for k in ("pcd", "label", "mask")}
    batch["label"] = batch["label"].long()
    result, _ = card_cpu_gradients(
        "scanobject_classifier", dict(repeats=1, dropout=0.0), batch,
        classification.make_loss_fn(0.5), "gradient parity")
    return {"parity_batch": PARITY_B,
            **{f"parity_{k}": v for k, v in result.items()}}


def card_cpu_gradients(model_name, model_kw, batch, loss_fn, what,
                       cut=None):
    """One forward + backward of the model ``model_name`` (``model_kw``,
    cut in depth by ``cut(model)`` where given, weights from seed 1, train
    mode) on ``batch`` on the card and on the CPU: the loss within 1e-4
    (relative), the concatenated gradient with cosine > 0.999 and median
    error <= 1e-3 of its scale.  -> (result dict, {device: the loss
    function's aux outputs})."""
    from cloud_transformers_tpu_torch.models import get_model
    from cloud_transformers_tpu_torch.nn.init import init_model_

    runs, aux = {}, {}
    for device in ("cuda", "cpu"):
        model = get_model(model_name, **model_kw)
        if cut is not None:
            cut(model)
        init_model_(model, torch.Generator().manual_seed(1))
        model = model.to(device).train()
        t0 = time.perf_counter()
        loss, aux[device] = loss_fn(
            model, {k: v.to(device) for k, v in batch.items()})
        loss.backward()
        loss = loss.detach()
        runs[device] = (float(loss),
                        {n: p.grad.detach().cpu().double()
                         for n, p in model.named_parameters()})
        log(f"{what}: {device} forward + backward in "
            f"{time.perf_counter() - t0:.1f} s, loss {float(loss):.6f}")
    (card_loss, card), (cpu_loss, cpu) = runs["cuda"], runs["cpu"]
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    a = torch.cat([card[n].reshape(-1) for n in cpu])
    b = torch.cat([cpu[n].reshape(-1) for n in cpu])
    if not bool(torch.isfinite(a).all()):
        raise AssertionError(f"{what}: non-finite gradient on the card")
    cos = float(torch.dot(a, b) / (a.norm() * b.norm()))
    scale = float(b.abs().max())
    p50 = float((a - b).abs().median()) / scale
    # per tensor, over those that carry a gradient at all (a bias before a
    # BatchNorm has none: rounding noise, with no direction to compare)
    worst = min(
        ((float(torch.dot(card[n].reshape(-1), cpu[n].reshape(-1))
                / (card[n].norm() * cpu[n].norm())), n)
         for n in cpu if float(cpu[n].abs().max()) > 1e-6 * scale))
    log(f"{what}: loss rel diff {loss_rel:.3e}, cosine {cos:.7f}, "
        f"p50 err {p50:.3e} of scale {scale:.3e}, worst tensor cosine "
        f"{worst[0]:.7f} ({worst[1]})")
    if not (loss_rel <= 1e-4 and cos > 0.999 and p50 <= 1e-3):
        raise AssertionError(f"{what}: card vs CPU gradients: loss rel diff "
                             f"{loss_rel}, cosine {cos}, p50 {p50}")
    return {"loss_rel_diff": loss_rel, "grad_cosine": cos,
            "grad_p50_of_scale": p50, "worst_tensor_cosine": worst[0],
            "worst_tensor": worst[1]}, aux


class EmdRecorder:
    """Stands in for ``losses.emd.emd_auction_with_rounds`` and
    ``_top2_dispatch`` while a phase runs: it passes every call through and
    keeps the rounds each auction used, the CUDA events around it, its
    last assignment, and the bid searches by (batch, width)."""

    def __init__(self):
        from cloud_transformers_tpu_torch.losses import emd
        self.emd = emd
        self.auction, self.dispatch = (emd.emd_auction_with_rounds,
                                       emd._top2_dispatch)
        self.rounds, self.events, self.widths = [], [], {}
        self.assignment = None

    def __enter__(self):
        def auction(xyz1, xyz2, *args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            dist, assignment, rounds = self.auction(xyz1, xyz2, *args,
                                                    **kwargs)
            end.record()
            self.rounds.append(rounds)
            self.events.append((start, end))
            self.assignment = assignment
            return dist, assignment, rounds

        def dispatch(x1w, x2, price, chunk_size):
            key = (x1w.shape[0], x1w.shape[1])
            self.widths[key] = self.widths.get(key, 0) + 1
            return self.dispatch(x1w, x2, price, chunk_size)

        self.emd.emd_auction_with_rounds = auction
        self.emd._top2_dispatch = dispatch
        return self

    def __exit__(self, *exc):
        self.emd.emd_auction_with_rounds = self.auction
        self.emd._top2_dispatch = self.dispatch

    def ms(self):
        """Device time between each auction's first and last kernel."""
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


def read_launches(wrappers):
    return {name: w.launches for name, w in wrappers.items()}


def check_launches(launches, per_pass, passes, what):
    """Raise unless every kernel launched ``per_pass[name]`` (0 where it is
    not named) times in each of ``passes`` passes."""
    expect = {name: per_pass.get(name, 0) * passes for name in launches}
    if launches != expect:
        raise AssertionError(f"{what}: launches {launches} in {passes} "
                             f"passes, expected {expect}")


def zero_launches(wrappers):
    for w in wrappers.values():
        w.launches = 0


def completion_phase(wrappers, smi, profile_dir, exp_root):
    """The third path: the full-width completion model trained for 1 +
    COMPLETION_STEPS steps through the Trainer on synthetic ShapeNet pairs,
    a checkpoint round trip, and the evaluation protocol on EVAL_CLOUDS
    test clouds.  -> (result dict, launches in the timed steps, launches in
    the evaluation, bid searches per step and per evaluated cloud by
    (batch, width), launches of the one step under each set).  An auction
    makes the host wait once per round (its exit test) and once more where
    a phase of the width schedule ends."""
    from cloud_transformers_tpu_torch import eval_inpainting
    from cloud_transformers_tpu_torch.core.noise import partial_postprocess
    from cloud_transformers_tpu_torch.data import (
        DataLoader,
        ShapeNetCompletion,
    )
    from cloud_transformers_tpu_torch.tasks import completion
    from cloud_transformers_tpu_torch.train.checkpoint import (
        restore_params_only,
    )
    from cloud_transformers_tpu_torch.train.config import (
        load_config,
        model_from_config,
    )
    from cloud_transformers_tpu_torch.train.trainer import Trainer

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config(os.path.join(root, "configs", "inpainting.yaml"))
    d = cfg["data"]
    bsz, n_in, n_gt = d["batch_size"], d["input_size"], d["gt_size"]
    if (bsz, n_in, n_gt) != (2, 2048, 16384):
        raise AssertionError("configs/inpainting.yaml is not B=2, 2048 "
                             "partial and 16384 ground-truth points")
    cfg["experiment"] = {"root": exp_root}
    gens = {"train": torch.Generator("cuda").manual_seed(1)}
    trainer = Trainer(
        model_from_config(cfg), cfg, "chip_smoke_completion",
        completion.make_loss_fn(
            gens["train"], float(cfg["train"].get("chamfer_weight", 0.0))),
        device="cuda", seed=0, generators=gens)
    model = trainer.model
    if (len(model.encoder.backbone.trunk.stages), len(model.decoder.stages),
            model.start_conv.out_features, model.mapping.out_features) \
            != (4, 4, 512, 512):
        raise AssertionError("the completion model is not the full-width one")
    train_loader, _ = completion.make_datasets(cfg, synthetic=True)
    batches = endless(train_loader)

    torch.cuda.reset_peak_memory_stats()
    trainer.train_step(next(batches))            # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    step_ms, losses = [], []
    with EmdRecorder() as rec:
        zero_launches(wrappers)
        for _ in range(COMPLETION_STEPS):
            batch = next(batches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = trainer.train_step(batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(metrics["loss"])
        launches = read_launches(wrappers)
        emd_ms = rec.ms()
    peak = torch.cuda.max_memory_allocated()
    expect = {name: PER_STEP_COMPLETION.get(name, 0) * COMPLETION_STEPS
              for name in launches}
    # one bid search per round, the last round included; with
    # _KERNEL_BID_MIN_WIDTH = 1 every one of them is a kernel launch
    expect.update(top2=sum(rec.rounds), auction_window=0)
    if launches != expect or sum(rec.widths.values()) != launches["top2"]:
        raise AssertionError(f"completion training: launches {launches}, "
                             f"expected {expect}; bid searches {rec.widths}")
    log(f"launches in {COMPLETION_STEPS} completion steps: {launches}; "
        f"rounds per auction {rec.rounds}; bid searches by (B, W) "
        f"{rec.widths}")
    a = rec.assignment
    if a.shape != (bsz, n_gt) or int(a.min()) < 0 or int(a.max()) >= n_gt:
        raise AssertionError("completion training: assignment out of range")
    losses = torch.stack(losses).cpu().numpy()
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite completion loss: {losses}")
    scale_grads = {}
    for name, param in model.named_parameters():
        if param.grad is None or not bool(torch.isfinite(param.grad).all()):
            raise AssertionError(f"{name}: missing or non-finite gradient")
        if name.startswith("decoder.") and name.endswith(".scale") \
                and param.dim() == 0:
            scale_grads[name] = float(param.grad.abs())
    if len(scale_grads) != 24 or not all(g > 0 for g in scale_grads.values()):
        raise AssertionError("a decoder key scale has no gradient: the key "
                             f"path is not connected ({scale_grads})")
    if trainer.global_step != COMPLETION_STEPS + 1:
        raise AssertionError(f"trainer step count {trainer.global_step}")

    # the model's forward, backward and update never make the host wait;
    # the auction does, once a round, and is left out of this check
    batch = trainer.to_device(next(batches))
    parts, noise = partial_postprocess(gens["train"], batch["partial"], n_gt)
    model.train()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        trainer.optimizer.zero_grad()
        recon, _ = model(noise, parts)
        recon.square().mean().backward()
        trainer.optimizer.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log("completion model step: no host-device synchronisation")

    ms = float(np.median(step_ms))
    result = {
        "completion_ms_per_step": ms,
        "completion_clouds_per_s": bsz * 1e3 / ms,
        "completion_ms_mean": float(np.mean(step_ms)),
        "completion_ms_p10": float(np.percentile(step_ms, 10)),
        "completion_ms_p90": float(np.percentile(step_ms, 90)),
        "completion_steps": COMPLETION_STEPS,
        "completion_peak_memory_bytes": int(peak),
        "completion_emd_ms_per_step": float(np.median(emd_ms)),
        "completion_emd_share_of_step": float(np.sum(emd_ms)
                                              / np.sum(step_ms)),
        "completion_emd_rounds": rec.rounds,
        "completion_loss_first": float(losses[0]),
        "completion_loss_last": float(losses[-1]),
        "completion_scale_grad_min": min(scale_grads.values()),
        "batch": bsz, "partial_points": n_in, "points": n_gt}
    widths_per_step = {k: v / COMPLETION_STEPS for k, v in rec.widths.items()}

    if profile_dir:
        result.update(profiled_steps(
            trainer, batches, smi,
            os.path.join(profile_dir, "profile_completion.txt"),
            "completion_"))

    # one training step under each set: the AdaIN blocks take the same
    # branches as the classifier's
    switched_launches = {}
    for name in SETS:
        result[f"completion_{name}_loss"], switched_launches[name] = \
            emd_step_under_set(name, trainer, batches, wrappers,
                               PER_STEP_COMPLETION, "completion")

    # checkpoint: save, restore into a fresh model, same reconstruction
    path = trainer.save()
    fresh = restore_params_only(path, model_from_config(cfg)).to("cuda")
    model.eval()
    fresh.eval()
    with torch.no_grad():
        same = torch.equal(model(noise, parts)[0], fresh(noise, parts)[0])
    if not same:
        raise AssertionError("the restored model's reconstruction differs "
                             "from the trainer's")
    result["checkpoint_bytes"] = os.path.getsize(path)
    log(f"checkpoint {result['checkpoint_bytes'] / 2 ** 20:.1f} MiB: the "
        "restored model reconstructs bit for bit")
    del trainer, model

    # the evaluation protocol on synthetic test clouds
    ds = ShapeNetCompletion(split="test", n_input=n_in, n_output=n_gt)
    loader = DataLoader(ds, 1, shuffle=False, drop_last=False)
    with EmdRecorder() as rec:
        zero_launches(wrappers)
        per_cat = eval_inpainting.evaluate(
            fresh, loader, torch.Generator("cuda").manual_seed(2), "cuda",
            limit=EVAL_CLOUDS, emd=True, emd_eps=0.004, emd_iters=3000)
        eval_launches = read_launches(wrappers)
        eval_emd_ms = rec.ms()
    table = eval_inpainting.format_table(per_cat, emd=True)
    log(table)
    m = next(iter(per_cat.values()))
    flat = [v for key in ("f", "cd", "emd") for v in m[key]]
    if len(per_cat) != 1 or len(m["f"]) != EVAL_CLOUDS \
            or not np.isfinite(flat).all():
        raise AssertionError(f"evaluation: bad table\n{table}")
    if eval_launches["top2"] != sum(m["rounds"]):
        raise AssertionError(f"evaluation: {eval_launches['top2']} top2 "
                             f"launches, rounds {m['rounds']}")
    result.update({
        "eval_clouds": EVAL_CLOUDS, "eval_f_score": float(np.mean(m["f"])),
        "eval_chamfer_x1000": float(np.mean(m["cd"])),
        "eval_emd": float(np.mean(m["emd"])), "eval_rounds": m["rounds"],
        "eval_seconds_per_cloud": float(np.median(m["seconds"])),
        "eval_seconds": m["seconds"],
        "eval_emd_ms_per_cloud": float(np.median(eval_emd_ms)),
        "eval_top2_launches_per_cloud": eval_launches["top2"] / EVAL_CLOUDS,
        "eval_bid_searches_by_width": {
            f"B={k[0]} W={k[1]}": v for k, v in rec.widths.items()}})
    eval_widths = {k: v / EVAL_CLOUDS for k, v in rec.widths.items()}
    return result, launches, eval_launches, widths_per_step, eval_widths, \
        switched_launches


def emd_step_under_set(name, trainer, batches, wrappers, per_step, what):
    """One training step of a model trained on the EMD under the set of
    switches ``name``: its launches (``per_step``'s splats and slices as
    ``set_counts`` moves them, one ``top2`` a round), a finite loss and
    gradients.  -> (the loss, the launches)."""
    with switches(name), EmdRecorder() as rec:
        zero_launches(wrappers)
        metrics = trainer.train_step(next(batches))
        torch.cuda.synchronize()
        got = read_launches(wrappers)
    expect = set_counts(name, per_step, True)
    expect["top2"] = sum(rec.rounds)
    check_launches(got, expect, 1, f"{what} step under {name}")
    loss = float(metrics["loss"])
    bad = [n for n, p in trainer.model.named_parameters()
           if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    if not np.isfinite(loss) or bad:
        raise AssertionError(f"{what} step under {name}: loss {loss}, "
                             f"missing or non-finite gradients {bad[:5]}")
    log(f"{what} step under {name}: loss {loss:.6f}, launches {got}")
    return loss, got


def kernel_device_ms(run, part):
    """Device time of the kernels whose names hold ``part`` that ``run()``
    launches, summed, and their count, from a torch.profiler trace of the
    card (no synchronisation a call; the trace's own cost falls on the
    host).  -> (ms, launches)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    hit = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and part in e.key]
    return (sum(e.self_device_time_total for e in hit) / 1e3,
            sum(e.count for e in hit))


def window_tail_phase(wrappers):
    """The EMD once more with the window tail switched on (the module
    switch, set and restored here): a pair that converges (uniform clouds,
    the first a permutation of the second plus noise of 0.01, B=2 x 16384,
    eps 0.004, up to 3000 rounds) through the staged tail and through the
    window tail, then the window tail again under the profiler for the
    device time of its ``auction_window`` kernels.  The synthetic ShapeNet
    pairs do not converge within 3000 rounds under either tail (their
    clipped corners hold exact duplicates), so they cannot show that the
    window tail ends.
    -> (result dict, launches)."""
    from cloud_transformers_tpu_torch.losses import emd

    rs = np.random.RandomState(0)
    n = 16384
    gt = rs.rand(2, n, 3).astype(np.float32)
    perm = np.stack([rs.permutation(n) for _ in range(2)])
    x1 = torch.as_tensor(
        np.take_along_axis(gt, perm[..., None], 1)
        + 0.01 * rs.randn(2, n, 3).astype(np.float32)).to("cuda")
    x2 = torch.as_tensor(gt).to("cuda")
    runs = {}
    for tail in (False, True):
        emd._WINDOW_TAIL = tail
        try:
            zero_launches(wrappers)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dist, assignment, rounds = emd.emd_auction_with_rounds(
                x1, x2, eps=0.004, iters=3000)
            torch.cuda.synchronize()
            runs[tail] = (time.perf_counter() - t0, rounds,
                          float(torch.sqrt(dist + 1e-12).mean()),
                          assignment, read_launches(wrappers))
        finally:
            emd._WINDOW_TAIL = False
    (s_sec, s_rounds, s_cost, _, s_launches) = runs[False]
    (w_sec, w_rounds, w_cost, w_asg, w_launches) = runs[True]
    one_to_one = all(int(torch.unique(w_asg[i]).numel()) == n
                     for i in range(w_asg.shape[0]))
    rel = abs(w_cost - s_cost) / s_cost
    emd._WINDOW_TAIL = True
    try:
        k_ms, k_launches = kernel_device_ms(
            lambda: emd.emd_auction_with_rounds(x1, x2, eps=0.004,
                                                iters=3000),
            "auction_window_kernel")
    finally:
        emd._WINDOW_TAIL = False
    log(f"window tail: {w_rounds} rounds in {w_sec:.3f} s, "
        f"{w_launches['auction_window']} window launches, cost {w_cost:.6f}"
        f"; their kernels {k_ms:.3f} ms on the device ({k_launches} "
        f"profiled); staged tail: {s_rounds} rounds in {s_sec:.3f} s, cost "
        f"{s_cost:.6f}; rel diff {rel:.3e}")
    if not (w_rounds < 3000 and one_to_one and rel <= 0.02
            and w_launches["auction_window"] > 0
            and s_launches["auction_window"] == 0):
        raise AssertionError(
            f"window tail: rounds {w_rounds}, one to one {one_to_one}, cost "
            f"rel diff {rel}, launches {w_launches}")
    return ({"window_tail_rounds": w_rounds, "window_tail_seconds": w_sec,
             "window_tail_launches": w_launches["auction_window"],
             "window_tail_top2_launches": w_launches["top2"],
             "window_tail_kernel_device_ms": k_ms,
             "window_tail_kernel_profiled_launches": k_launches,
             "window_tail_cost": w_cost, "staged_tail_rounds": s_rounds,
             "staged_tail_seconds": s_sec, "staged_tail_cost": s_cost,
             "staged_tail_top2_launches": s_launches["top2"],
             "window_vs_staged_cost_rel_diff": rel}, w_launches)


def completion_parity():
    """Card against CPU for the completion path: the full-width inpainter
    with one encoder and one decoder stage, B=1, the same weights and the
    same noise (PARITY.md criteria on the reconstruction), and ``loss_emd``
    on one pair of clouds at N=2048 within 2% (the auction amplifies
    rounding, so the loss is held and not the assignment)."""
    from cloud_transformers_tpu_torch.core.noise import partial_postprocess
    from cloud_transformers_tpu_torch.data import ShapeNetCompletion
    from cloud_transformers_tpu_torch.losses import loss_emd
    from cloud_transformers_tpu_torch.models import get_model
    from cloud_transformers_tpu_torch.nn.init import init_model_

    item = ShapeNetCompletion(split="test")[0]
    partial = torch.as_tensor(item["partial"])[None] * 2.0
    parts, noise = partial_postprocess(torch.Generator().manual_seed(3),
                                       partial, 16384)
    out = {}
    for device in ("cuda", "cpu"):
        model = get_model("completion_inpainter", encoder_repeats=1,
                          decoder_repeats=1)
        init_model_(model, torch.Generator().manual_seed(1))
        with torch.no_grad():
            # the key scales start at 0; a trained model's are not
            for name, p in model.named_parameters():
                if name.endswith(".scale") and p.dim() == 0:
                    p.fill_(0.05)
        model = model.to(device).eval()
        t0 = time.perf_counter()
        with torch.no_grad():
            out[device] = model(noise.to(device), parts.to(device))[0].cpu()
        log(f"completion parity: {device} forward in "
            f"{time.perf_counter() - t0:.1f} s")
    if not bool(torch.isfinite(out["cuda"]).all()):
        raise AssertionError("non-finite reconstruction on the card")
    parity(out["cuda"], out["cpu"],
           f"reconstruction {list(out['cpu'].shape)}")

    rs = np.random.RandomState(4)
    x2 = rs.rand(1, 2048, 3).astype(np.float32)
    x1 = (x2[:, rs.permutation(2048)]
          + 0.05 * rs.randn(1, 2048, 3)).astype(np.float32)
    x1, x2 = torch.as_tensor(x1), torch.as_tensor(x2)
    card = float(loss_emd(x1.cuda(), x2.cuda(), eps=0.004, iters=3000))
    cpu = float(loss_emd(x1, x2, eps=0.004, iters=3000))
    rel = abs(card - cpu) / cpu
    log(f"loss_emd N=2048: card {card:.7f}, CPU {cpu:.7f}, rel diff "
        f"{rel:.3e}")
    if not rel <= 0.02:
        raise AssertionError(f"loss_emd card {card} vs CPU {cpu}")
    return {"completion_parity_loss_emd_rel_diff": rel}


def segmenter_phase(wrappers, smi, profile_dir, exp_root):
    """The fourth path: the full-width ``s3dis_segmenter`` of
    ``configs/s3dis.yaml`` trained through the Trainer on synthetic blocks
    (B=8 x 4096, the config's optimizer, loader workers and augmentations,
    ``grad_stats`` on): one warm-up step, SEG_STEPS timed and counted
    steps, SEG_FIT_STEPS steps of ``Trainer.fit`` (one window of its
    ``data_time``/``batch_time``), a step under
    ``set_sync_debug_mode("error")``, ``Trainer.validate`` with
    ``SegEvalAccumulator`` (its forwards counted), and a step under each
    set.  -> (result dict, {path: launches})."""
    from cloud_transformers_tpu_torch.tasks import segmentation
    from cloud_transformers_tpu_torch.train.config import (
        load_config,
        model_from_config,
    )
    from cloud_transformers_tpu_torch.train.trainer import Trainer

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config(os.path.join(root, "configs", "s3dis.yaml"))
    d = cfg["data"]
    if (d["batch_size"], d["num_points"]) != (B, SEG_K):
        raise AssertionError("configs/s3dis.yaml is not B=8 x 4096")
    cfg["experiment"] = {"root": exp_root}
    cfg["train"].update(grad_stats=True, save=False)
    n_classes = int(cfg["model"]["n_classes"])
    trainer = Trainer(
        model_from_config(cfg), cfg, "chip_smoke_segmenter",
        segmentation.make_loss_fn(
            n_classes, 0.1 if cfg["train"].get("label_smooth") else 0.0),
        device="cuda", seed=0)
    model = trainer.model
    if (len(model.trunk.stages), model.stem.in_features,
            model.stem.out_features, model.final_conv2.out_features) \
            != (4, 6, 512, n_classes):
        raise AssertionError("the segmenter is not the full-width one")
    train_loader, val_loader = segmentation.make_datasets(cfg, synthetic=True)
    if train_loader.num_workers != d["num_workers"]:
        raise AssertionError("the loader does not use the config's workers")
    batches = endless(train_loader)

    torch.cuda.reset_peak_memory_stats()
    trainer.train_step(next(batches))            # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    zero_launches(wrappers)
    step_ms, data_ms, losses, norms = [], [], [], []
    for _ in range(SEG_STEPS):
        t0 = time.perf_counter()
        batch = next(batches)
        t1 = time.perf_counter()
        metrics = trainer.train_step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        data_ms.append((t1 - t0) * 1e3)
        losses.append(metrics["loss"])
        norms.append(metrics["grad_norm"])
    launches = {"segmenter": read_launches(wrappers)}
    peak = torch.cuda.max_memory_allocated()
    check_launches(launches["segmenter"], PER_STEP_SEGMENTER, SEG_STEPS,
                   "segmenter training steps")
    log(f"launches in {SEG_STEPS} segmenter steps: {launches['segmenter']}")

    losses = torch.stack(losses).cpu().numpy()
    norms = torch.stack(norms).cpu().numpy()
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()
            and (norms > 0).all()):
        raise AssertionError(f"segmenter: losses {losses}, gradient norms "
                             f"{norms}")
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    if not last < first:
        raise AssertionError(f"the segmenter's loss did not fall: first 10 "
                             f"steps {first}, last 10 steps {last}")
    named = dict(model.named_parameters())
    per_param = {k for k in metrics if k.startswith("grad_norm/")}
    if per_param != {f"grad_norm/{n}" for n in named}:
        raise AssertionError("grad_stats does not name every parameter")
    key_grad = 0.0
    for name, param in named.items():
        if param.grad is None or not bool(torch.isfinite(param.grad).all()):
            raise AssertionError(f"{name}: missing or non-finite gradient")
        if name.endswith("key_bn.bias"):
            key_grad = max(key_grad, float(param.grad.abs().max()))
    if not key_grad > 0:
        raise AssertionError("segmenter: every key_bn.bias gradient is zero")
    if trainer.global_step != SEG_STEPS + 1 or \
            trainer.optimizer.lrs != [1e-3]:
        raise AssertionError("the segmenter's step count or learning rate "
                             f"is off: {trainer.global_step}, "
                             f"{trainer.optimizer.lrs}")

    # Trainer.fit for one show_each window of its own: its data_time (host
    # seconds a step waiting for the loader) and batch_time (in train_step,
    # which does not wait for the device) reach metrics.jsonl
    batches.close()
    end = trainer.global_step + SEG_FIT_STEPS
    cfg["train"]["show_each"] = end
    t0 = time.perf_counter()
    trainer.fit(train_loader, max_steps=end)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    with open(os.path.join(trainer.writer_dir, "metrics.jsonl")) as fh:
        logged = [json.loads(line) for line in fh]
    window = [m for m in logged if "train/data_time" in m]
    if len(window) != 1 or window[0]["step"] != end or \
            "train/grad_norm" not in window[0]:
        raise AssertionError(f"Trainer.fit logged {logged}")
    window = window[0]
    log(f"Trainer.fit: {SEG_FIT_STEPS} steps in {fit_s:.3f} s, data_time "
        f"{window['train/data_time']:.6f} s, batch_time "
        f"{window['train/batch_time']:.6f} s a step")

    # forward, backward, the gradient norms and the optimizer step never
    # make the host wait
    batches = endless(train_loader)
    batch = trainer.to_device(next(batches))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        trainer.train_step(batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log("segmenter step (grad_stats on): no host-device synchronisation")

    # validation: OA, mAcc, mIoU through the eval hook
    hook = segmentation.SegEvalAccumulator(n_classes)
    torch.cuda.synchronize()
    zero_launches(wrappers)
    t0 = time.perf_counter()
    val = trainer.validate(val_loader, hook)
    val_s = time.perf_counter() - t0
    launches["segmenter_validation"] = read_launches(wrappers)
    check_launches(launches["segmenter_validation"], PER_FORWARD_SEGMENTER,
                   len(val_loader), "segmenter validation forwards")
    scores = {k: float(val[k]) for k in ("oa", "macc", "miou", "loss")}
    if not all(np.isfinite(v) for v in scores.values()) or \
            not all(0.0 <= scores[k] <= 1.0 for k in ("oa", "macc", "miou")):
        raise AssertionError(f"segmenter validation: {val}")
    log(f"segmenter validation ({len(val_loader)} batches, {val_s:.2f} s): "
        f"{scores}")

    result = {
        "segmenter_ms_per_step": float(np.median(step_ms)),
        "segmenter_clouds_per_s": B * 1e3 / float(np.median(step_ms)),
        "segmenter_ms_mean": float(np.mean(step_ms)),
        "segmenter_ms_p10": float(np.percentile(step_ms, 10)),
        "segmenter_ms_p90": float(np.percentile(step_ms, 90)),
        "segmenter_data_wait_ms_median": float(np.median(data_ms)),
        "segmenter_data_wait_ms_max": float(np.max(data_ms)),
        "segmenter_steps": SEG_STEPS,
        "segmenter_peak_memory_bytes": int(peak),
        "segmenter_loss_first10": first, "segmenter_loss_last10": last,
        "segmenter_grad_norm_first": float(norms[0]),
        "segmenter_grad_norm_last": float(norms[-1]),
        "segmenter_key_bn_bias_grad_max": key_grad,
        "segmenter_fit_steps": SEG_FIT_STEPS,
        "segmenter_fit_seconds": fit_s,
        "segmenter_fit_data_time": window["train/data_time"],
        "segmenter_fit_batch_time": window["train/batch_time"],
        "segmenter_fit_steps_per_sec": window["train/steps_per_sec"],
        "segmenter_loader_workers": train_loader.num_workers,
        "segmenter_val_batches": len(val_loader),
        "segmenter_val_seconds": val_s,
        **{f"segmenter_val_{k}": v for k, v in scores.items()},
        "batch": B, "points": SEG_K}

    if profile_dir:
        result.update(profiled_steps(
            trainer, batches, smi,
            os.path.join(profile_dir, "profile_segmenter.txt"),
            "segmenter_"))

    # one training step under each set
    for name in SETS:
        with switches(name):
            zero_launches(wrappers)
            metrics = trainer.train_step(next(batches))
            torch.cuda.synchronize()
            got = read_launches(wrappers)
        check_launches(got, set_counts(name, PER_STEP_SEGMENTER, True), 1,
                       f"segmenter step under {name}")
        loss = float(metrics["loss"])
        bad = [n for n, p in model.named_parameters()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())]
        if not np.isfinite(loss) or bad:
            raise AssertionError(f"segmenter step under {name}: loss {loss}, "
                                 f"missing or non-finite gradients {bad[:5]}")
        result[f"segmenter_{name}_loss"] = loss
        result[f"segmenter_{name}_grad_norm"] = float(metrics["grad_norm"])
        launches[f"segmenter_{name}"] = got
        log(f"segmenter step under {name}: loss {loss:.6f}, launches {got}")
    batches.close()
    return result, launches


def segmenter_parity():
    """The segmenter on the card against the CPU: the full-width model with
    one stage, B=2 x 4096 synthetic blocks, train mode, the same weights;
    its logits and its concatenated gradients by the PARITY.md criteria,
    its cross-entropy within 1e-4."""
    import torch.nn.functional as F

    from cloud_transformers_tpu_torch.data import Indoor3DSemSeg

    ds = Indoor3DSemSeg(None, train=True, num_points=SEG_K,
                        synthetic_items=SEG_PARITY_B)
    batch = {k: torch.as_tensor(np.stack([ds[i][k]
                                          for i in range(SEG_PARITY_B)]))
             for k in ("pcd", "label")}
    batch["label"] = batch["label"].long()

    def loss_fn(model, batch):
        logits, _ = model(batch["pcd"])
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               batch["label"].reshape(-1)), logits.detach()
    result, logits = card_cpu_gradients(
        "s3dis_segmenter", dict(repeats=1), batch, loss_fn,
        "segmenter gradient parity")
    cos, p50 = parity(logits["cuda"].cpu(), logits["cpu"],
                      f"segmenter logits {list(logits['cpu'].shape)}")
    return {"segmenter_parity_batch": SEG_PARITY_B,
            "segmenter_parity_logits_cosine": cos,
            "segmenter_parity_logits_p50": p50,
            **{f"segmenter_parity_{k}": v for k, v in result.items()}}


def reconstructor_phase(wrappers, smi, profile_dir, exp_root):
    """The fifth path: the full-width ``image_reconstructor`` of
    ``configs/reconstruction.yaml`` (ResNet-50, the 12-block AdaIN
    decoder) trained through the Trainer on synthetic images (B=4 x 128^2,
    8192 sphere-noise and ground-truth points, the EMD loss at eps 0.005
    and 50 rounds, the config's loader workers): one warm-up step,
    REC_STEPS timed and counted steps, a forward, backward and update
    under ``set_sync_debug_mode("error")``, a step under each set, and the
    F-score protocol on one batch of REC_B test images (two merged passes
    of 8192 points, 10000 ground-truth points).  -> (result dict, {path:
    launches}, bid searches per step by (batch, width))."""
    from cloud_transformers_tpu_torch import eval_reconstruction_f1
    from cloud_transformers_tpu_torch.core.noise import sphere_noise
    from cloud_transformers_tpu_torch.data import DataLoader, ImageToPoint
    from cloud_transformers_tpu_torch.tasks import reconstruction
    from cloud_transformers_tpu_torch.train.config import (
        load_config,
        model_from_config,
    )
    from cloud_transformers_tpu_torch.train.trainer import Trainer

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config(os.path.join(root, "configs", "reconstruction.yaml"))
    d = cfg["data"]
    if (d["batch_size"], d["im_size"], d["gt_size"]) != (REC_B, REC_IM,
                                                         REC_K):
        raise AssertionError("configs/reconstruction.yaml is not B=4 x "
                             "128^2 images, 8192 points")
    cfg["experiment"] = {"root": exp_root}
    cfg["train"]["save"] = False
    gens = {"train": torch.Generator("cuda").manual_seed(1)}
    trainer = Trainer(model_from_config(cfg), cfg, "chip_smoke_reconstructor",
                      reconstruction.make_loss_fn(gens["train"]),
                      device="cuda", seed=0, generators=gens)
    model = trainer.model
    if (len(model.res50.trunk.blocks), len(model.decoder.stages),
            model.start_conv.out_features, model.mapping.out_features) \
            != (16, 4, 512, 512):
        raise AssertionError("the reconstructor is not the full-width one")
    train_loader, _ = reconstruction.make_datasets(cfg, synthetic=True)
    if train_loader.num_workers != d["num_workers"]:
        raise AssertionError("the loader does not use the config's workers")
    batches = endless(train_loader)

    torch.cuda.reset_peak_memory_stats()
    trainer.train_step(next(batches))            # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    step_ms, losses, chamfer = [], [], []
    with EmdRecorder() as rec:
        zero_launches(wrappers)
        for _ in range(REC_STEPS):
            batch = next(batches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = trainer.train_step(batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(metrics["loss"])
            chamfer.append(metrics["loss_chamfer"])
        launches = {"reconstructor": read_launches(wrappers)}
        emd_ms = rec.ms()
    peak = torch.cuda.max_memory_allocated()
    expect = {name: PER_STEP_RECONSTRUCTOR.get(name, 0) * REC_STEPS
              for name in launches["reconstructor"]}
    expect["top2"] = sum(rec.rounds)
    if launches["reconstructor"] != expect or \
            sum(rec.widths.values()) != expect["top2"]:
        raise AssertionError(
            f"reconstructor training: launches {launches['reconstructor']}, "
            f"expected {expect}; bid searches {rec.widths}")
    log(f"launches in {REC_STEPS} reconstructor steps: "
        f"{launches['reconstructor']}; rounds per auction {rec.rounds}; "
        f"bid searches by (B, W) {rec.widths}")
    a = rec.assignment
    if a.shape != (REC_B, REC_K) or int(a.min()) < 0 or \
            int(a.max()) >= REC_K:
        raise AssertionError("reconstructor training: assignment out of "
                             "range")
    losses = torch.stack(losses).cpu().numpy()
    chamfer = torch.stack(chamfer).cpu().numpy()
    if not (np.isfinite(losses).all() and np.isfinite(chamfer).all()):
        raise AssertionError(f"reconstructor: losses {losses}, Chamfer "
                             f"{chamfer}")
    scale_grads = {}
    for name, param in model.named_parameters():
        if param.grad is None or not bool(torch.isfinite(param.grad).all()):
            raise AssertionError(f"{name}: missing or non-finite gradient")
        if name.startswith("decoder.") and name.endswith(".scale") \
                and param.dim() == 0:
            scale_grads[name] = float(param.grad.abs())
    if len(scale_grads) != 24 or not all(g > 0 for g in scale_grads.values()):
        raise AssertionError("a decoder key scale has no gradient: the key "
                             f"path is not connected ({scale_grads})")
    stem_grad = float(model.res50.trunk.stem_conv.weight.grad.abs().max())
    if not stem_grad > 0:
        raise AssertionError("the ResNet's stem has no gradient")
    if trainer.global_step != REC_STEPS + 1:
        raise AssertionError(f"trainer step count {trainer.global_step}")

    # the model's forward, backward and update never make the host wait;
    # the auction does, once a round, and is left out of this check
    batch = trainer.to_device(next(batches))
    noise = sphere_noise(gens["train"], REC_B, REC_K, "cuda")
    model.train()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        trainer.optimizer.zero_grad()
        recon, _ = model(noise, batch["image"])
        (recon - batch["pcd"]).square().mean().backward()
        trainer.optimizer.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log("reconstructor step: no host-device synchronisation")

    ms = float(np.median(step_ms))
    result = {
        "reconstructor_ms_per_step": ms,
        "reconstructor_images_per_s": REC_B * 1e3 / ms,
        "reconstructor_ms_mean": float(np.mean(step_ms)),
        "reconstructor_ms_p10": float(np.percentile(step_ms, 10)),
        "reconstructor_ms_p90": float(np.percentile(step_ms, 90)),
        "reconstructor_steps": REC_STEPS,
        "reconstructor_peak_memory_bytes": int(peak),
        "reconstructor_emd_ms_per_step": float(np.median(emd_ms)),
        "reconstructor_emd_share_of_step": float(np.sum(emd_ms)
                                                 / np.sum(step_ms)),
        "reconstructor_emd_rounds": rec.rounds,
        "reconstructor_loss_first": float(losses[0]),
        "reconstructor_loss_last": float(losses[-1]),
        "reconstructor_chamfer_first": float(chamfer[0]),
        "reconstructor_chamfer_last": float(chamfer[-1]),
        "reconstructor_scale_grad_min": min(scale_grads.values()),
        "reconstructor_stem_grad_max": stem_grad,
        "reconstructor_loader_workers": train_loader.num_workers,
        "batch": REC_B, "image_size": REC_IM, "points": REC_K}
    widths_per_step = {k: v / REC_STEPS for k, v in rec.widths.items()}

    if profile_dir:
        result.update(profiled_steps(
            trainer, batches, smi,
            os.path.join(profile_dir, "profile_reconstructor.txt"),
            "reconstructor_"))

    # one training step under each set: the decoder's AdaIN blocks take
    # the same branches as the completion decoder's
    for name in SETS:
        result[f"reconstructor_{name}_loss"], \
            launches[f"reconstructor_{name}"] = emd_step_under_set(
                name, trainer, batches, wrappers, PER_STEP_RECONSTRUCTOR,
                "reconstructor")
    batches.close()

    # the F-score protocol: two merged passes of 8192 points an image
    ds = ImageToPoint(split="test", im_size=REC_IM, points=REC_EVAL_POINTS)
    loader = DataLoader(ds, d["batch_size_val"], shuffle=False,
                        drop_last=False)
    torch.cuda.synchronize()
    zero_launches(wrappers)
    t0 = time.perf_counter()
    per_class = eval_reconstruction_f1.evaluate(
        model, loader, torch.Generator("cuda").manual_seed(2), "cuda",
        limit=1)
    eval_s = time.perf_counter() - t0
    launches["reconstructor_evaluation"] = read_launches(wrappers)
    check_launches(launches["reconstructor_evaluation"],
                   PER_FORWARD_RECONSTRUCTOR, 2,
                   "reconstructor evaluation: two forwards")
    table = eval_reconstruction_f1.format_table(per_class, ds.class_names)
    log(table)
    m = per_class.get(0, {})
    flat = [v for key in ("f", "p", "r") for v in m.get(key, [])]
    if list(per_class) != [0] or len(m["f"]) != d["batch_size_val"] or \
            not np.isfinite(flat).all():
        raise AssertionError(f"reconstructor evaluation: bad table\n{table}")
    result.update({
        "eval_images": len(m["f"]), "eval_f_score": float(np.mean(m["f"])),
        "eval_precision": float(np.mean(m["p"])),
        "eval_recall": float(np.mean(m["r"])),
        "eval_seconds_per_image": float(np.median(m["seconds"])),
        "eval_seconds": eval_s})
    return result, launches, widths_per_step


def reconstructor_parity():
    """The reconstructor on the card against the CPU: the full-width model
    with its full ResNet-50 and one decoder stage, B=1 x 8192 points and a
    128^2 synthetic image, train mode, the same weights and noise: its
    output by the PARITY.md criteria, the gradients of the mean squared
    distance to the ground truth (no auction in it, so that the auction's
    ties do not enter) by ``card_cpu_gradients``' gates, and the training
    loss's EMD of each device's output (its first 2048 points against the
    ground truth's) within 2%."""
    from cloud_transformers_tpu_torch.core.noise import sphere_noise
    from cloud_transformers_tpu_torch.data import ImageToPoint
    from cloud_transformers_tpu_torch.losses import loss_emd

    item = ImageToPoint(split="test", im_size=REC_IM, points=REC_K)[0]
    batch = {"image": torch.as_tensor(item["image"])[None],
             "pcd": torch.as_tensor(item["pcd"])[None],
             "noise": sphere_noise(torch.Generator().manual_seed(3), 1,
                                   REC_K)}

    def cut(model):
        model.decoder.stages = model.decoder.stages[:1]

    def loss_fn(model, batch):
        recon, _ = model(batch["noise"], batch["image"])
        return (recon - batch["pcd"]).square().sum(-1).mean(), \
            recon.detach()
    result, recon = card_cpu_gradients(
        "image_reconstructor", {}, batch, loss_fn,
        "reconstructor gradient parity", cut=cut)
    cos, p50 = parity(recon["cuda"].cpu(), recon["cpu"],
                      f"reconstruction {list(recon['cpu'].shape)}")
    # the training loss's EMD on the first REC_PARITY_EMD_N points of each
    # output and of the ground truth (the CPU's auction at 8192 points
    # takes most of a minute)
    emd = {}
    n = REC_PARITY_EMD_N
    for device, out in recon.items():
        t0 = time.perf_counter()
        emd[device] = float(loss_emd(out[:, :n].contiguous(),
                                     batch["pcd"][:, :n].to(device)))
        log(f"reconstructor parity: {device} EMD {emd[device]:.7f} in "
            f"{time.perf_counter() - t0:.1f} s")
    rel = abs(emd["cuda"] - emd["cpu"]) / emd["cpu"]
    if not rel <= 0.02:
        raise AssertionError(f"reconstructor EMD card {emd['cuda']} vs CPU "
                             f"{emd['cpu']}")
    return {"reconstructor_parity_output_cosine": cos,
            "reconstructor_parity_output_p50": p50,
            "reconstructor_parity_loss_emd_rel_diff": rel,
            "reconstructor_parity_loss_emd_points": n,
            **{f"reconstructor_parity_{k}": v for k, v in result.items()}}


def kpconv_phase(wrappers, smi, profile_dir, exp_root):
    """The sixth path: the full-width ``s3dis_segmenter_pad`` of
    ``configs/s3dis_kpconv.yaml`` trained through the Trainer on the
    synthetic rooms (B=6 spheres x 8192 points, ragged, 7 stem channels,
    the config's Adam, StepLR, clipping at 10, loader workers and
    augmentations; epochs of KP_EPOCH spheres): one warm-up step, KP_STEPS
    timed and counted steps, a step under ``set_sync_debug_mode("error")``,
    a checkpoint restored bit for bit by the evaluation command line's
    ``restore_params_only`` path, the KP_VOTES-vote validation (its
    forwards counted) and a step under each set.  -> (result dict, {path:
    launches})."""
    from cloud_transformers_tpu_torch.data import subsample
    from cloud_transformers_tpu_torch.tasks import segmentation_kpconv as task
    from cloud_transformers_tpu_torch.train.checkpoint import (
        restore_params_only,
    )
    from cloud_transformers_tpu_torch.train.config import (
        load_config,
        model_from_config,
    )
    from cloud_transformers_tpu_torch.train.trainer import Trainer

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config(os.path.join(root, "configs", "s3dis_kpconv.yaml"))
    d = cfg["data"]
    if (d["batch_size"], d["num_points"], d["input_features_dim"]) != (
            KP_B, KP_K, 4):
        raise AssertionError("configs/s3dis_kpconv.yaml is not B=6 x 8192 "
                             "with 4 features")
    cfg["experiment"] = {"root": exp_root}
    d["num_steps"] = KP_EPOCH
    cfg["train"].update(grad_stats=True, save=False)
    cfg["train"].setdefault("clip_grad_norm", 10.0)
    n_classes = int(cfg["model"]["n_classes"])
    trainer = Trainer(model_from_config(cfg), cfg, "chip_smoke_kpconv",
                      task.make_loss_fn(), device="cuda", seed=0)
    model = trainer.model
    if (len(model.trunk.stages), model.stem.in_features,
            model.stem.out_features, model.final_conv2.out_features) \
            != (4, 7, 512, n_classes):
        raise AssertionError("the KPConv segmenter is not the full-width one")

    # the synthetic sets through the native subsampler, and only it
    native, numpy_path = subsample._native_subsample, \
        subsample._numpy_subsample
    used = []

    def counted(*a):
        used.append(a[0].shape[0])
        return native(*a)

    def refused(*a):
        raise AssertionError("the numpy subsampler ran")
    subsample._native_subsample, subsample._numpy_subsample = counted, refused
    t0 = time.perf_counter()
    try:
        train_ds, val_ds, train_loader, val_loader = task.make_datasets(
            cfg, synthetic=True)
    finally:
        subsample._native_subsample, subsample._numpy_subsample = \
            native, numpy_path
    data_s = time.perf_counter() - t0
    if len(used) != len(train_ds.sub_points) + len(val_ds.sub_points) or \
            not subsample.library_path().exists():
        raise AssertionError(f"the native subsampler ran on {used}")
    if train_loader.num_workers != d["num_workers"]:
        raise AssertionError("the loader does not use the config's workers")
    log(f"KPConv sets (native subsampler, {len(used)} clouds of {used} "
        f"points) in {data_s:.1f} s")
    batches = endless(train_loader)

    torch.cuda.reset_peak_memory_stats()
    warm = next(batches)
    if warm["features"].shape != (KP_B, KP_K, 4) or \
            warm["points"].shape != (KP_B, KP_K, 3):
        raise AssertionError(f"KPConv batch {warm['features'].shape}")
    trainer.train_step(warm)                     # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    zero_launches(wrappers)
    step_ms, data_ms, losses, norms, valid = [], [], [], [], []
    for _ in range(KP_STEPS):
        t0 = time.perf_counter()
        batch = next(batches)
        t1 = time.perf_counter()
        metrics = trainer.train_step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        data_ms.append((t1 - t0) * 1e3)
        losses.append(metrics["loss"])
        norms.append(metrics["grad_norm"])
        valid.append(batch["mask"].mean(1))
    launches = {"kpconv": read_launches(wrappers)}
    peak = torch.cuda.max_memory_allocated()
    check_launches(launches["kpconv"], PER_STEP_KPCONV, KP_STEPS,
                   "KPConv training steps")
    log(f"launches in {KP_STEPS} KPConv steps: {launches['kpconv']}")
    valid = np.concatenate(valid)
    if not (valid.min() < 1.0 and valid.min() > 0.0):
        raise AssertionError(f"KPConv spheres not ragged: {valid}")

    losses = torch.stack(losses).cpu().numpy()
    norms = torch.stack(norms).cpu().numpy()
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()
            and (norms > 0).all()):
        raise AssertionError(f"KPConv: losses {losses}, gradient norms "
                             f"{norms}")
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    if not last < first:
        raise AssertionError(f"the KPConv segmenter's loss did not fall: "
                             f"first 10 steps {first}, last 10 {last}")
    key_grad = 0.0
    for name, param in model.named_parameters():
        if param.grad is None or not bool(torch.isfinite(param.grad).all()):
            raise AssertionError(f"{name}: missing or non-finite gradient")
        if name.endswith("key_bn.bias"):
            key_grad = max(key_grad, float(param.grad.abs().max()))
    if not key_grad > 0:
        raise AssertionError("KPConv: every key_bn.bias gradient is zero")
    if trainer.optimizer.clip_grad_norm != 10.0:
        raise AssertionError("KPConv: the gradient is not clipped at 10")

    # forward, backward, the gradient norms and the optimizer step never
    # make the host wait
    batch = trainer.to_device(next(batches))
    torch.cuda.synchronize()

    def step():
        torch.cuda.set_sync_debug_mode("error")
        try:
            trainer.train_step(batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    plain = plain_batch_norms(model, step, "KPConv step")
    log("KPConv step (masked loss, grad_stats on): no host-device "
        f"synchronisation; {plain} BatchNorm calls on the plain ops")

    # a checkpoint, restored as the evaluation command line restores it
    path = trainer.save()
    restored = restore_params_only(path, model_from_config(cfg)).to("cuda")
    want = model.state_dict()
    if set(restored.state_dict()) != set(want) or not all(
            torch.equal(v, want[k]) for k, v in
            restored.state_dict().items()):
        raise AssertionError("KPConv: the restored checkpoint differs")
    with torch.no_grad():
        a = model.eval()(batch["points"], batch["mask"], batch["features"])[0]
        b = restored.eval()(batch["points"], batch["mask"],
                            batch["features"])[0]
    if not torch.equal(a, b):
        raise AssertionError("KPConv: the restored model's logits differ")
    del restored, a, b
    log(f"KPConv checkpoint {os.path.basename(path)} restored bit for bit")

    # the vote validation: part, sub-cloud and full-cloud mIoU
    torch.cuda.synchronize()
    zero_launches(wrappers)
    t0 = time.perf_counter()
    val = task.validate_votes(trainer.eval_step, val_ds, val_loader,
                              n_classes, num_votes=KP_VOTES,
                              input_features_dim=d["input_features_dim"])
    val_s = time.perf_counter() - t0
    launches["kpconv_validation"] = read_launches(wrappers)
    check_launches(launches["kpconv_validation"], PER_FORWARD_KPCONV,
                   KP_VOTES * len(val_loader), "KPConv validation forwards")
    scores = {k: float(val[k]) for k in ("part_miou", "sub_miou",
                                         "running_sub_miou", "miou")}
    if not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in scores.values()):
        raise AssertionError(f"KPConv validation: {val}")
    log(f"KPConv validation ({KP_VOTES} votes of {len(val_loader)} batches, "
        f"{val_s:.2f} s): {scores}")

    result = {
        "kpconv_ms_per_step": float(np.median(step_ms)),
        "kpconv_spheres_per_s": KP_B * 1e3 / float(np.median(step_ms)),
        "kpconv_ms_mean": float(np.mean(step_ms)),
        "kpconv_ms_p10": float(np.percentile(step_ms, 10)),
        "kpconv_ms_p90": float(np.percentile(step_ms, 90)),
        "kpconv_data_wait_ms_median": float(np.median(data_ms)),
        "kpconv_data_wait_ms_max": float(np.max(data_ms)),
        "kpconv_steps": KP_STEPS,
        "kpconv_bn_plain_per_step": plain,
        "kpconv_peak_memory_bytes": int(peak),
        "kpconv_valid_share_min": float(valid.min()),
        "kpconv_valid_share_median": float(np.median(valid)),
        "kpconv_valid_share_max": float(valid.max()),
        "kpconv_loss_first10": first, "kpconv_loss_last10": last,
        "kpconv_grad_norm_first": float(norms[0]),
        "kpconv_grad_norm_last": float(norms[-1]),
        "kpconv_key_bn_bias_grad_max": key_grad,
        "kpconv_sets_seconds": data_s,
        "kpconv_loader_workers": train_loader.num_workers,
        "kpconv_epoch_spheres": KP_EPOCH,
        "kpconv_val_votes": KP_VOTES,
        "kpconv_val_batches": len(val_loader),
        "kpconv_val_seconds": val_s,
        **{f"kpconv_val_{k}": v for k, v in scores.items()},
        "batch": KP_B, "points": KP_K}

    if profile_dir:
        result.update(profiled_steps(
            trainer, batches, smi,
            os.path.join(profile_dir, "profile_kpconv.txt"), "kpconv_"))

    # one training step under each set
    for name in SETS:
        with switches(name):
            zero_launches(wrappers)
            metrics = trainer.train_step(next(batches))
            torch.cuda.synchronize()
            got = read_launches(wrappers)
        check_launches(got, set_counts(name, PER_STEP_KPCONV, True), 1,
                       f"KPConv step under {name}")
        loss = float(metrics["loss"])
        bad = [n for n, p in model.named_parameters()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())]
        if not np.isfinite(loss) or bad:
            raise AssertionError(f"KPConv step under {name}: loss {loss}, "
                                 f"missing or non-finite gradients {bad[:5]}")
        result[f"kpconv_{name}_loss"] = loss
        result[f"kpconv_{name}_grad_norm"] = float(metrics["grad_norm"])
        launches[f"kpconv_{name}"] = got
        log(f"KPConv step under {name}: loss {loss:.6f}, launches {got}")
    batches.close()
    return result, launches


def kpconv_parity():
    """The KPConv segmenter on the card against the CPU: the full-width
    model with one stage, KP_PARITY_B ragged synthetic spheres of 8192
    points, train mode, the same weights; its logits at the valid points
    and its concatenated gradients by the PARITY.md criteria, its masked
    cross-entropy within 1e-4."""
    from cloud_transformers_tpu_torch.data import S3DISSeg
    from cloud_transformers_tpu_torch.tasks import segmentation_kpconv as task

    ds = S3DISSeg(split="val", num_points=KP_K, num_steps=16, num_epochs=1)
    items = [it for it in (ds[i] for i in range(16))
             if it["mask"].mean() < 1.0][:KP_PARITY_B]
    if len(items) < KP_PARITY_B:
        raise AssertionError("too few ragged spheres for the parity")
    batch = {k: torch.as_tensor(np.stack([it[k] for it in items]))
             for k in ("points", "mask", "features", "label")}
    batch["label"] = batch["label"].long()
    loss_fn = task.make_loss_fn()

    def masked(model, batch):
        loss, aux = loss_fn(model, batch)
        return loss, aux["logits"]
    result, logits = card_cpu_gradients(
        "s3dis_segmenter_pad", dict(repeats=1), batch, masked,
        "KPConv gradient parity")
    valid = batch["mask"] > 0
    cos, p50 = parity(logits["cuda"].cpu()[valid], logits["cpu"][valid],
                      f"KPConv logits at {int(valid.sum())} valid points")
    return {"kpconv_parity_batch": KP_PARITY_B,
            "kpconv_parity_valid_share": float(batch["mask"].mean()),
            "kpconv_parity_logits_cosine": cos,
            "kpconv_parity_logits_p50": p50,
            **{f"kpconv_parity_{k}": v for k, v in result.items()}}


def scales_config(exp_root):
    """``configs/scanobjectnn.yaml`` with the scales classifier as its
    model, B=8 x 2048 asserted."""
    from cloud_transformers_tpu_torch.train.config import load_config

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config(os.path.join(root, "configs", "scanobjectnn.yaml"))
    if (cfg["data"]["batch_size"], cfg["data"]["num_points"]) != (B, K):
        raise AssertionError("configs/scanobjectnn.yaml is not B=8 x 2048")
    cfg["experiment"] = {"root": exp_root}
    cfg["model"]["name"] = SCALES
    cfg["model"].pop("generator", None)
    return cfg


def full_width_scales(model):
    """Raise unless ``model`` is the full-width scales classifier: 12
    blocks at model_dim 512, scales in every frame (24 head groups and the
    two pools)."""
    trunk = model.backbone.trunk
    blocks = sum(st.n for st in trunk.stages)
    scales = [n for n, _ in model.named_parameters()
              if n.endswith("transform.scales")]
    if (blocks, model.backbone.stem.out_features, len(scales)) != \
            (12, 512, 26):
        raise AssertionError(f"the scales classifier is not the full-width "
                             f"one: {blocks} blocks, "
                             f"{model.backbone.stem.out_features} wide, "
                             f"{len(scales)} frames with scales")


def scales_phase(wrappers, smi, profile_dir, exp_root):
    """Phase 14 (a): the full-width ``scanobject_classifier_scales``
    trained through the Trainer at B=8 x 2048, its scales drawn from
    U(0.5, 1.5) first: one warm-up step, SCALES_STEPS timed and counted
    steps (``PER_STEP``), a step under ``set_sync_debug_mode("error")``, a
    step under each set, a checkpoint; with ``profile_dir``, PROFILE_STEPS
    profiled steps.  -> (result dict, {path: launches}, the trainer, the
    checkpoint's path)."""
    from cloud_transformers_tpu_torch.tasks import classification
    from cloud_transformers_tpu_torch.train.config import model_from_config
    from cloud_transformers_tpu_torch.train.trainer import Trainer

    cfg = scales_config(exp_root)
    trainer = Trainer(
        model_from_config(cfg), cfg, "chip_smoke_scales",
        classification.make_loss_fn(
            float(cfg["train"].get("seg_weight", 0.5))),
        device="cuda", seed=0)
    model = trainer.model
    full_width_scales(model)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("transform.scales"):
                p.copy_(torch.empty(p.shape).uniform_(0.5, 1.5,
                                                      generator=gen))
    train_loader, _ = classification.make_datasets(cfg, synthetic=True)
    batches = endless(train_loader)

    torch.cuda.reset_peak_memory_stats()
    trainer.train_step(next(batches))            # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    zero_launches(wrappers)
    step_ms, event_ms, losses = [], [], []
    for _ in range(SCALES_STEPS):
        batch = next(batches)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        metrics = trainer.train_step(batch)
        end.record()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        event_ms.append(start.elapsed_time(end))
        losses.append(metrics["loss"])
    launches = {"scales_training": read_launches(wrappers)}
    peak = torch.cuda.max_memory_allocated()
    check_launches(launches["scales_training"], PER_STEP, SCALES_STEPS,
                   "scales classifier steps")
    losses = torch.stack(losses).cpu().numpy()
    if not np.isfinite(losses).all():
        raise AssertionError(f"scales classifier: losses {losses}")
    scale_grad = {}
    for name, p in model.named_parameters():
        if p.grad is None or not bool(torch.isfinite(p.grad).all()):
            raise AssertionError(f"{name}: missing or non-finite gradient")
        if name.endswith("transform.scales"):
            scale_grad[name] = float(p.grad.abs().max())
    if not all(g > 0 for g in scale_grad.values()):
        raise AssertionError(f"a frame's scales have no gradient: "
                             f"{scale_grad}")
    log(f"scales classifier: {SCALES_STEPS} steps, launches "
        f"{launches['scales_training']}, losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, smallest scales gradient "
        f"{min(scale_grad.values()):.3e}")

    # forward, backward and the optimizer step never make the host wait
    batch = trainer.to_device(next(batches))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        trainer.train_step(batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log("scales classifier step: no host-device synchronisation")

    result = {
        "scales_ms_per_step": float(np.median(step_ms)),
        "scales_ms_p10": float(np.percentile(step_ms, 10)),
        "scales_ms_p90": float(np.percentile(step_ms, 90)),
        "scales_event_ms_per_step": float(np.median(event_ms)),
        "scales_steps": SCALES_STEPS,
        "scales_peak_memory_bytes": int(peak),
        "scales_loss_first": float(losses[0]),
        "scales_loss_last": float(losses[-1]),
        "scales_grad_min": min(scale_grad.values()),
        "scales_frames": len(scale_grad), "batch": B, "points": K}
    if profile_dir:
        result.update(profiled_steps(
            trainer, batches, smi,
            os.path.join(profile_dir, "profile_scales.txt"), "scales_"))
    for name in SETS:
        with switches(name):
            zero_launches(wrappers)
            metrics = trainer.train_step(next(batches))
            torch.cuda.synchronize()
            got = read_launches(wrappers)
        check_launches(got, set_counts(name, PER_STEP, True), 1,
                       f"scales classifier step under {name}")
        bad = [n for n, p in model.named_parameters()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())]
        loss = float(metrics["loss"])
        if not np.isfinite(loss) or bad:
            raise AssertionError(f"scales step under {name}: loss {loss}, "
                                 f"gradients {bad[:5]}")
        result[f"scales_{name}_loss"] = loss
        launches[f"scales_{name}"] = got
        log(f"scales classifier step under {name}: loss {loss:.6f}, "
            f"launches {got}")
    path = trainer.save()
    batches.close()
    return result, launches, trainer, path


def reference_scales_state(seed):
    """A full-width scales classifier's weights of a trained-like scale:
    ``init_model_``'s kernels (U(+-1/sqrt(fan in))), BatchNorm scales
    0.5-1.5 (0.05-0.15 on the keys, small key offsets: larger ones make
    the random 12 blocks chaotic, ``tests/test_torch_reference_convert.py``),
    biases and running means 0.1 N(0, 1), running variances 0.5-1.5, the
    frames' scales 0.5-1.5, from ``seed``.  -> the port's state dict."""
    from cloud_transformers_tpu_torch.models import get_model
    from cloud_transformers_tpu_torch.nn.init import init_model_

    gen = torch.Generator().manual_seed(seed)
    model = init_model_(get_model(SCALES), gen)
    full_width_scales(model)
    state = model.state_dict()
    for name, t in state.items():
        layer, leaf = name.rsplit(".", 1)
        if leaf in ("scales", "scale", "var"):   # "scale": a BatchNorm's
            lo, hi = ((0.05, 0.15) if layer.endswith("key_bn")
                      and leaf == "scale" else (0.5, 1.5))
            t.copy_(torch.empty(t.shape).uniform_(lo, hi, generator=gen))
        elif leaf in ("mean", "bias"):
            t.copy_(0.1 * torch.randn(t.shape, generator=gen))
    return state


def serving_from_checkpoints(wrappers, trainer, path, exp_root):
    """Phase 14 (b): ``InferenceEngine.from_checkpoint`` from the trained
    scales classifier's checkpoint (SCALES_SERVE_CALLS counted, timed calls
    of B synthetic clouds; the padded batch's logits against the trained
    model's eval logits, within SCALES_SERVE_TOL of their scale), then from
    a reference-shaped ``.t7`` of a seeded full-width state (converted back
    to the same tensors; the card's logits and mask for one cloud against
    the CPU's by the PARITY.md criteria).  -> result dict, launches."""
    from cloud_transformers_tpu_torch.convert import reference_state_dict
    from cloud_transformers_tpu_torch.serve import InferenceEngine

    rng = np.random.RandomState(4)
    batches = [requests(rng, B) for _ in range(SCALES_SERVE_CALLS)]
    engine = InferenceEngine.from_checkpoint(
        SCALES, path, device="cuda", batch_buckets=(B,), point_buckets=(K,))
    full_width_scales(engine.model)
    engine.classify(batches[0])                  # warm-up
    torch.cuda.synchronize()
    zero_launches(wrappers)
    call_ms = []
    for clouds in batches:
        t0 = time.perf_counter()
        probs = engine.classify(clouds)
        call_ms.append((time.perf_counter() - t0) * 1e3)
    launches = read_launches(wrappers)
    check_launches(launches, PER_FORWARD, len(batches),
                   "scales classifier forwards from its checkpoint")
    if probs.shape != (B, 15) or not np.isfinite(probs).all():
        raise AssertionError(f"scales serving: probabilities {probs}")
    pcd = torch.from_numpy(engine.pad_batch(batches[0])[0]).to("cuda")
    with torch.no_grad():
        served = engine.model(pcd)[0]
        trained = trainer.model.eval()(pcd)[0]
    scale = max(1.0, float(trained.abs().max()))
    err = float((served - trained).abs().max()) / scale
    want = trainer.model.state_dict()
    same_state = all(torch.equal(v, want[k])
                     for k, v in engine.model.state_dict().items())
    if not (same_state and err <= SCALES_SERVE_TOL):
        raise AssertionError(f"served logits {err} of their scale from the "
                             f"trained model's (weights equal: "
                             f"{same_state})")
    log(f"scales classifier served from {os.path.basename(path)}: "
        f"{np.median(call_ms):.3f} ms/forward, logits "
        f"{'bit-equal' if err == 0 else f'within {err:.3e}'} of the "
        f"trained model's")
    result = {"scales_serve_ms_per_forward": float(np.median(call_ms)),
              "scales_serve_ms_p10": float(np.percentile(call_ms, 10)),
              "scales_serve_ms_p90": float(np.percentile(call_ms, 90)),
              "scales_serve_calls": len(call_ms),
              "scales_serve_logit_err_of_scale": err,
              "scales_serve_bit_equal": err == 0.0,
              "scales_serve_weights_equal": same_state}
    del engine

    state = reference_scales_state(5)
    ref = reference_layout(SCALES, state)
    back = reference_state_dict(SCALES, ref)
    if set(back) != set(state) or not all(torch.equal(back[k], state[k])
                                          for k in state):
        raise AssertionError("the reference layout does not convert back "
                             "to the same tensors")
    t7 = os.path.join(exp_root, "classifier_scales.t7")
    torch.save({k: torch.from_numpy(v) for k, v in ref.items()}, t7)
    card = InferenceEngine.from_checkpoint(
        SCALES, t7, device="cuda", batch_buckets=(1,), point_buckets=(K,))
    cpu = InferenceEngine.from_checkpoint(
        SCALES, t7, device="cpu", batch_buckets=(1,), point_buckets=(K,))
    cloud = batches[0][:1]
    (card_cls, card_mask, _), *_ = card.predict_padded(cloud)
    (cpu_cls, cpu_mask, _), *_ = cpu.predict_padded(cloud)
    cos, p50 = parity(card_cls.cpu(), cpu_cls, "scales .t7 class logits")
    mcos, mp50 = parity(card_mask.cpu(), cpu_mask, "scales .t7 point mask")
    result.update(scales_t7_tensors=len(ref),
                  scales_t7_logits_cosine=cos, scales_t7_logits_p50=p50,
                  scales_t7_mask_cosine=mcos, scales_t7_mask_p50=mp50)
    return result, launches


def _spread(a, b):
    """The largest difference between two runs' tensors {name: tensor},
    relative to the first run's largest magnitude over all of them."""
    scale = max(float(t.abs().max()) for t in a.values())
    return max(float((a[k] - b[k]).abs().max()) for k in a) / max(
        scale, 1e-30)


def remat_run(trainer, batch, step, wrappers, per_step, what, timed=True):
    """One model under one remat policy: a warm-up step and a gated step
    with cuDNN deterministic (so that two runs from the same weights and
    batch agree), the gated one under ``set_sync_debug_mode("error")``,
    with its launches (``per_step``); then (``timed``) REMAT_STEPS timed
    steps with cuDNN as it was (host clock, CUDA events around each, the
    peak memory of those steps) and REMAT_PROFILE_STEPS under the profiler
    (the device's busy time).  ``step(trainer, batch)`` is one optimizer step;
    dropout draws from a generator seeded before each.  -> (result, the
    gradients and buffers after the gated step)."""
    from torch.profiler import ProfilerActivity, profile

    t_run = time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        torch.manual_seed(0)
        step(trainer, batch)                     # warm-up (cuDNN plans)
        torch.cuda.synchronize()
        torch.manual_seed(1)
        zero_launches(wrappers)
        torch.cuda.set_sync_debug_mode("error")
        try:
            step(trainer, batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    torch.cuda.synchronize()
    launches = read_launches(wrappers)
    check_launches(launches, per_step, 1, what)
    model = trainer.model
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    stats = {n: b.detach().clone() for n, b in model.named_buffers()}
    if not all(bool(torch.isfinite(g).all()) for g in grads.values()):
        raise AssertionError(f"{what}: non-finite gradients")
    result = {"launches_per_step": {k: v for k, v in launches.items() if v}}
    if timed:
        host, event = [], []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(REMAT_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            step(trainer, batch)
            end.record()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
            event.append(start.elapsed_time(end))
        peak = torch.cuda.max_memory_allocated()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(REMAT_PROFILE_STEPS):
                step(trainer, batch)
            torch.cuda.synchronize()
        busy = device_ms(prof.key_averages()) / REMAT_PROFILE_STEPS
        result.update(peak_memory_bytes=int(peak),
                      host_ms_per_step=float(np.median(host)),
                      event_ms_per_step=float(np.median(event)),
                      device_busy_ms_per_step=busy)
        log(f"{what}: peak {peak / 2 ** 30:.2f} GiB, host "
            f"{result['host_ms_per_step']:.3f} ms, events "
            f"{result['event_ms_per_step']:.3f} ms, device busy {busy:.3f} "
            f"ms a step")
    log(f"{what}: launches {result['launches_per_step']} in the gated "
        f"step; {time.perf_counter() - t_run:.1f} s")
    return result, grads, stats


def _train_step(trainer, batch):
    trainer.train_step(batch)


def remat_phase(wrappers, state, exp_root):
    """Phase 14 (c): the scales classifier's step (weights ``state``, one
    batch) with remat off twice and under each policy; each policy's
    gradients and BatchNorm statistics after its gated step no farther from
    the first remat-off run's than the second remat-off run's are; then the
    completion model's and the KPConv segmenter's step with remat off and
    under ``point_io`` (``remat_run``).  -> result dict, {path:
    launches}."""
    from cloud_transformers_tpu_torch.core.noise import partial_postprocess
    from cloud_transformers_tpu_torch.nn.remat import policy as remat_policy
    from cloud_transformers_tpu_torch.tasks import classification
    from cloud_transformers_tpu_torch.tasks import completion
    from cloud_transformers_tpu_torch.tasks import segmentation_kpconv
    from cloud_transformers_tpu_torch.train.config import (
        load_config,
        model_from_config,
    )
    from cloud_transformers_tpu_torch.train.trainer import Trainer

    root = os.path.dirname(os.path.abspath(__file__))
    result, launches = {}, {}
    cfg = scales_config(exp_root)
    loss_fn = classification.make_loss_fn(
        float(cfg["train"].get("seg_weight", 0.5)))
    loader, _ = classification.make_datasets(cfg, synthetic=True)
    batch = next(iter(loader))
    runs = {}
    for label, name in REMAT_RUNS:
        cfg["model"].update(remat=name is not None,
                            remat_policy=name or "point_io")
        trainer = Trainer(model_from_config(cfg), cfg,
                          f"chip_smoke_remat_{label}", loss_fn,
                          device="cuda", seed=0)
        trainer.model.load_state_dict(state)
        batch_dev = trainer.to_device(batch)
        out, grads, stats = remat_run(
            trainer, batch_dev, _train_step, wrappers,
            remat_counts(remat_policy(name) if name else None,
                         PER_STEP, UNION_BNS),
            f"scales classifier step, remat {label}",
            timed=label != "off_again")
        runs[label] = (grads, stats)
        result[f"classifier_{label}"] = out
        launches[f"scales_remat_{label}"] = out["launches_per_step"]
        del trainer
        torch.cuda.empty_cache()
    grads0, stats0 = runs["off"]
    floor_g = _spread(grads0, runs["off_again"][0])
    floor_s = _spread(stats0, runs["off_again"][1])
    for label, _ in REMAT_RUNS[2:]:
        g = _spread(grads0, runs[label][0])
        st = _spread(stats0, runs[label][1])
        result[f"classifier_{label}"].update(
            grad_diff_from_off=g, stats_diff_from_off=st)
        log(f"remat {label}: gradients {g:.3e} and statistics {st:.3e} "
            f"from remat off (two remat-off runs: {floor_g:.3e}, "
            f"{floor_s:.3e})")
        if g > floor_g or st > floor_s:
            raise AssertionError(
                f"remat {label}: gradients {g} and statistics {st} from "
                f"remat off, farther than two remat-off runs "
                f"({floor_g}, {floor_s})")
    result.update(classifier_off_grad_spread=floor_g,
                  classifier_off_stats_spread=floor_s)
    del runs

    # the completion model's forward, backward and update (the EMD's
    # auction waits for the device once a round and is left out)
    cfg = load_config(os.path.join(root, "configs", "inpainting.yaml"))
    cfg["experiment"] = {"root": exp_root}
    gen = torch.Generator("cuda").manual_seed(1)
    loader, _ = completion.make_datasets(cfg, synthetic=True)
    raw = next(iter(loader))

    def completion_step(trainer, batch):
        parts, noise = batch
        trainer.optimizer.zero_grad()
        recon, _ = trainer.model(noise, parts)
        recon.square().mean().backward()
        trainer.optimizer.step()

    for label, name in (("off", "off"), ("point_io", "point_io")):
        cfg["model"]["remat_policy"] = name
        trainer = Trainer(model_from_config(cfg), cfg,
                          f"chip_smoke_remat_completion_{label}",
                          None, device="cuda", seed=0)
        dev = trainer.to_device(raw)
        gen.manual_seed(1)
        parts_noise = partial_postprocess(gen, dev["partial"],
                                          dev["gt"].shape[1])
        out, _, _ = remat_run(
            trainer, parts_noise, completion_step, wrappers,
            remat_counts(remat_policy(name), PER_STEP_COMPLETION,
                         UNION_BNS),
            f"completion model step, remat {label}")
        result[f"completion_{label}"] = out
        launches[f"completion_remat_{label}"] = out["launches_per_step"]
        del trainer, parts_noise
        torch.cuda.empty_cache()

    cfg = load_config(os.path.join(root, "configs", "s3dis_kpconv.yaml"))
    cfg["experiment"] = {"root": exp_root}
    cfg["data"]["num_steps"] = KP_EPOCH
    _, _, loader, _ = segmentation_kpconv.make_datasets(cfg,
                                                        synthetic=True)
    raw = next(iter(loader))
    for label, name in (("off", None), ("point_io", "point_io")):
        cfg["model"].update(remat=name is not None,
                            remat_policy=name or "point_io")
        trainer = Trainer(model_from_config(cfg), cfg,
                          f"chip_smoke_remat_kpconv_{label}",
                          segmentation_kpconv.make_loss_fn(),
                          device="cuda", seed=0)
        out, _, _ = remat_run(
            trainer, trainer.to_device(raw), _train_step, wrappers,
            remat_counts(name, PER_STEP_KPCONV, UNION_BNS),
            f"KPConv step, remat {label}")
        result[f"kpconv_{label}"] = out
        launches[f"kpconv_remat_{label}"] = out["launches_per_step"]
        del trainer
        torch.cuda.empty_cache()
    return result, launches


def profiled_steps(trainer, batches, smi, path, prefix):
    """PROFILE_STEPS more training steps under torch.profiler: the device
    kernels by group in ``path``.  -> {prefix + profiled_...}: the host
    wall time, the device busy time and the idle share of the window."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            trainer.train_step(next(batches))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    busy = device_ms(events)
    profiled = {f"{prefix}profiled_steps": PROFILE_STEPS,
                f"{prefix}profiled_wall_ms_per_step": wall_ms / PROFILE_STEPS,
                f"{prefix}profiled_device_ms_per_step": busy / PROFILE_STEPS,
                f"{prefix}profiled_device_idle_share": 1 - busy / wall_ms}
    table = events.table(sort_by="cuda_time_total", row_limit=40)
    with open(path, "w") as fh:
        fh.write(f"{smi}\n{json.dumps(profiled)}\n"
                 f"device kernels, per training step:\n"
                 f"{device_table(events, PROFILE_STEPS)}\n"
                 f"(totals over {PROFILE_STEPS} training steps)\n{table}")
    log(json.dumps(profiled))
    return profiled


@contextlib.contextmanager
def mxu_policy(dtype):
    """The operand policy set to ``dtype`` while the context lasts, and
    back to what it was afterwards."""
    from cloud_transformers_tpu_torch.nn import precision
    before = precision.resolve()
    try:
        precision.set_default_mxu_dtype(dtype)
        yield
    finally:
        precision.set_default_mxu_dtype(before)


def cosine(a, b):
    a, b = a.reshape(-1).double().cpu(), b.reshape(-1).double().cpu()
    return float(torch.dot(a, b) / (a.norm() * b.norm()))


def scaled_parity(card, cpu, what):
    """PARITY.md's criteria with the median error relative to max(1, max
    |cpu|): cosine > 0.999, median error <= 1e-3 of that scale."""
    a, b = card.reshape(-1).double().cpu(), cpu.reshape(-1).double()
    cos = cosine(a, b)
    p50 = float((a - b).abs().median()) / max(1.0, float(b.abs().max()))
    log(f"parity {what}: cosine {cos:.7f}  p50 err {p50:.3e} of the scale")
    if not (cos > 0.999 and p50 <= 1e-3):
        raise AssertionError(f"{what}: cosine {cos}, p50 {p50}")
    return cos, p50


@contextlib.contextmanager
def contraction_noise(model, seed):
    """While the context lasts, the output of every ``MXU*`` contraction of
    ``model`` is multiplied by 1 + U(-BF16_NOISE, BF16_NOISE), drawn on the
    card from ``seed``: float32 with an error the size of the bf16
    policy's (bf16 rounds both operands and the result, each by up to
    2^-8 of its magnitude)."""
    from cloud_transformers_tpu_torch.nn.precision import MXU_MODULES
    gen = torch.Generator(next(model.parameters()).device).manual_seed(seed)

    def jitter(module, inputs, out):
        u = torch.rand(out.shape, generator=gen, device=out.device)
        return out * (1 + (2 * u - 1) * BF16_NOISE)
    hooks = [m.register_forward_hook(jitter) for m in model.modules()
             if isinstance(m, MXU_MODULES)]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


def held_bf16(cos, floors, what):
    """A bf16 result against float32 passes where its cosine exceeds
    BF16_COS or reaches the float32 floor, the mean cosine of float32 runs
    under ``contraction_noise`` against the plain float32 run (PARITY.md's
    jittered-floor method): a result that chaos amplifies (a random
    model's gradients, a train-mode UNet) cannot meet a fixed bar in any
    framework, but a fault would fall below its floor.  -> the floor."""
    floor = float(np.mean(floors))
    log(f"{what}: bf16 vs f32 cosine {cos:.7f}; float32 under noise of the "
        f"policy's size {[round(f, 7) for f in floors]} (floor {floor:.7f})")
    if not (cos > BF16_COS or cos >= floor):
        raise AssertionError(f"{what}: bf16 vs f32 cosine {cos}, below "
                             f"{BF16_COS} and the float32 floor {floor}")
    return floor


def bf16_classifier_config():
    """``configs/scanobjectnn.yaml`` with ``model.mxu_dtype: bfloat16``:
    ``model_from_config`` builds the full-width classifier from it and
    sets the policy, as a user turns it on."""
    from cloud_transformers_tpu_torch.nn import precision
    from cloud_transformers_tpu_torch.train.config import (
        load_config,
        model_from_config,
    )

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config(os.path.join(root, "configs", "scanobjectnn.yaml"))
    if (cfg["data"]["batch_size"], cfg["data"]["num_points"]) != (B, K):
        raise AssertionError("configs/scanobjectnn.yaml is not B=8 x 2048")
    cfg["model"]["mxu_dtype"] = "bfloat16"
    model = model_from_config(cfg)
    trunk = model.backbone.trunk
    if precision.resolve() is not torch.bfloat16 or \
            sum(st.n for st in trunk.stages) != 12 or \
            model.backbone.stem.out_features != 512:
        raise AssertionError("the bf16 classifier is not the full-width "
                             "one under the bf16 policy")
    return cfg, model


def bf16_serving(wrappers, smi, profile_dir):
    """Phase 15 (a), serving: the full-width classifier built from the bf16
    config with weights from seed 0 serves N_REQUESTS classify calls
    (``PER_FORWARD``), one forward under ``set_sync_debug_mode("error")``;
    its logits on a batch of B clouds against the same weights served in
    float32 on the card (cosine >= BF16_LOGIT_COS, the top-1 agreement
    reported) and, for one cloud, against the CPU port under bf16
    (``scaled_parity``).  -> (result, launches)."""
    from cloud_transformers_tpu_torch.models import get_model
    from cloud_transformers_tpu_torch.nn.init import init_model_
    from cloud_transformers_tpu_torch.serve import InferenceEngine

    _, model = bf16_classifier_config()
    init_model_(model, torch.Generator().manual_seed(0))
    engine = InferenceEngine(model, "cuda", batch_buckets=(B,),
                             point_buckets=(K,))
    rng = np.random.RandomState(0)
    batches = [requests(rng, B) for _ in range(N_REQUESTS)]
    engine.classify(batches[0])                  # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    zero_launches(wrappers)
    call_ms = []
    for clouds in batches:
        t0 = time.perf_counter()
        probs = engine.classify(clouds)
        call_ms.append((time.perf_counter() - t0) * 1e3)
    launches = read_launches(wrappers)
    check_launches(launches, PER_FORWARD, len(batches), "bf16 forwards")
    if probs.shape != (B, 15) or not np.isfinite(probs).all():
        raise AssertionError(f"bf16: bad class probabilities {probs}")
    pcd = torch.from_numpy(engine.pad_batch(batches[0])[0]).to("cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            engine.model(pcd)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log("bf16 forward: no host-device synchronisation")
    result = {"bf16_classify_ms_per_forward": float(np.median(call_ms)),
              "bf16_classify_ms_p10": float(np.percentile(call_ms, 10)),
              "bf16_classify_ms_p90": float(np.percentile(call_ms, 90))}
    if profile_dir:
        result.update({f"bf16_{k}": v for k, v in profile_serving(
            engine, batches, smi, os.path.join(
                profile_dir, "profile_forward_bf16.txt")).items()})

    # the same weights in float32 on the card (the policy is read at call
    # time), and under bf16 on the CPU
    (l16, _, _), _, _, _ = engine.predict_padded(batches[1])
    with mxu_policy(None):
        (l32, _, _), _, _, _ = engine.predict_padded(batches[1])
    cos = cosine(l16, l32)
    top1 = int((l16.argmax(-1) == l32.argmax(-1)).sum())
    log(f"bf16 vs f32 logits on the card: cosine {cos:.7f}, max abs diff "
        f"{float((l16 - l32).abs().max()):.3e}, top-1 agreement {top1}/{B}")
    if not (torch.isfinite(l16).all() and cos >= BF16_LOGIT_COS):
        raise AssertionError(f"bf16 vs f32 logits: cosine {cos}")
    cpu_model = get_model("scanobject_classifier")
    cpu_model.load_state_dict(model.state_dict())
    cpu_engine = InferenceEngine(cpu_model, "cpu", batch_buckets=(1,),
                                 point_buckets=(K,))
    cloud = batches[1][:1]
    (card_cls, card_mask, _), _, _, _ = engine.predict_padded(cloud)
    (cpu_cls, cpu_mask, _), _, _, _ = cpu_engine.predict_padded(cloud)
    result.update({
        "bf16_vs_f32_logits_cosine": cos,
        "bf16_vs_f32_logits_max_abs_diff": float((l16 - l32).abs().max()),
        "bf16_vs_f32_top1_agreement": top1,
        "bf16_parity_logits_cosine": scaled_parity(
            card_cls[:1], cpu_cls, "bf16 class logits, card vs CPU")[0],
        "bf16_parity_mask_cosine": scaled_parity(
            card_mask[:1], cpu_mask, "bf16 point mask, card vs CPU")[0]})
    return result, launches


def classifier_step_under_set(name, trainer, batches, wrappers, what):
    """One classifier training step under the set ``name``: its launches
    (``set_counts``), a finite loss and gradients.  -> launches."""
    with switches(name):
        zero_launches(wrappers)
        metrics = trainer.train_step(next(batches))
        torch.cuda.synchronize()
        got = read_launches(wrappers)
    check_launches(got, set_counts(name, PER_STEP, True), 1,
                   f"{what} step under {name}")
    bad = [n for n, p in trainer.model.named_parameters()
           if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    if not np.isfinite(float(metrics["loss"])) or bad:
        raise AssertionError(f"{what} step under {name}: loss "
                             f"{metrics['loss']}, gradients {bad[:5]}")
    log(f"{what} step under {name}: launches {got}")
    return got


def bf16_gradient_cosine():
    """Phase 15 (a): one training step's gradients of the full-width
    classifier (weights from seed 1, no dropout, train mode, the key
    BatchNorms' scales at their initial 0) on a fixed batch of B synthetic
    clouds, under bf16 and in float32 on the card, by ``held_bf16``
    against two float32 steps under ``contraction_noise``.  A random
    full-width model at its first step is chaotic at the policy's scale
    (the splat's max picks another winner where two contributions are
    within a rounding of each other), so its bf16 gradients meet no fixed
    cosine such as 0.999, the JAX package's no better than the port's
    (``tests/test_torch_precision.py``)."""
    from cloud_transformers_tpu_torch.data import ScanObjectNN
    from cloud_transformers_tpu_torch.models import get_model
    from cloud_transformers_tpu_torch.nn.init import init_model_
    from cloud_transformers_tpu_torch.tasks import classification

    ds = ScanObjectNN(None, train=True, synthetic_items=B, num_points=K)
    batch = {k: torch.as_tensor(np.stack([ds[i][k] for i in range(B)]))
             .to("cuda") for k in ("pcd", "label", "mask")}
    batch["label"] = batch["label"].long()
    model = init_model_(get_model("scanobject_classifier", dropout=0.0),
                        torch.Generator().manual_seed(1)).cuda().train()
    loss_fn = classification.make_loss_fn(0.5)

    def step(dtype=None, noise_seed=None):
        model.zero_grad()
        with mxu_policy(dtype), (contraction_noise(model, noise_seed)
                                 if noise_seed else contextlib.nullcontext()):
            loss, _ = loss_fn(model, batch)
            loss.backward()
        return float(loss.detach()), torch.cat([p.grad.reshape(-1)
                                                for p in model.parameters()])

    loss32, g32 = step()
    loss16, g16 = step("bfloat16")
    if not bool(torch.isfinite(g16).all()):
        raise AssertionError("bf16 gradients are not finite")
    cos = cosine(g16, g32)
    floors = [cosine(step(noise_seed=seed)[1], g32) for seed in (1, 2)]
    held_bf16(cos, floors, f"one step's gradients (loss {loss16:.6f} "
              f"against {loss32:.6f})")
    return {"bf16_vs_f32_grad_cosine": cos,
            "bf16_grad_noise_floor_cosines": floors,
            "bf16_vs_f32_loss_rel_diff": abs(loss16 - loss32) / abs(loss32)}


def bf16_reconstructor(wrappers, smi, profile_dir, exp_root):
    """Phase 15 (b): the full-width ``image_reconstructor`` of
    ``configs/reconstruction.yaml`` with ``model.mxu_dtype: bfloat16``
    trained through the Trainer at B=4 x 128^2 x 8192: a warm-up step,
    BF16_REC_STEPS timed and counted steps (``PER_STEP_RECONSTRUCTOR`` and
    one ``top2`` a round), finite losses and gradients; then one
    evaluation forward (``PER_FORWARD_RECONSTRUCTOR``) whose output cloud
    holds to the same weights' float32 forward, cosine > BF16_COS.
    -> (result, launches)."""
    from cloud_transformers_tpu_torch.core.noise import sphere_noise
    from cloud_transformers_tpu_torch.nn import precision
    from cloud_transformers_tpu_torch.tasks import reconstruction
    from cloud_transformers_tpu_torch.train.config import (
        load_config,
        model_from_config,
    )
    from cloud_transformers_tpu_torch.train.trainer import Trainer

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config(os.path.join(root, "configs", "reconstruction.yaml"))
    d = cfg["data"]
    if (d["batch_size"], d["im_size"], d["gt_size"]) != (REC_B, REC_IM,
                                                         REC_K):
        raise AssertionError("configs/reconstruction.yaml is not B=4 x "
                             "128^2 images, 8192 points")
    cfg["experiment"] = {"root": exp_root}
    cfg["train"]["save"] = False
    cfg["model"]["mxu_dtype"] = "bfloat16"
    gens = {"train": torch.Generator("cuda").manual_seed(1)}
    trainer = Trainer(model_from_config(cfg), cfg,
                      "chip_smoke_reconstructor_bf16",
                      reconstruction.make_loss_fn(gens["train"]),
                      device="cuda", seed=0, generators=gens)
    model = trainer.model
    if precision.resolve() is not torch.bfloat16 or \
            (len(model.res50.trunk.blocks), len(model.decoder.stages)) != \
            (16, 4):
        raise AssertionError("the bf16 reconstructor is not the full-width "
                             "one under the bf16 policy")
    train_loader, _ = reconstruction.make_datasets(cfg, synthetic=True)
    batches = endless(train_loader)
    torch.cuda.reset_peak_memory_stats()
    trainer.train_step(next(batches))            # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    step_ms, losses = [], []
    with EmdRecorder() as rec:
        zero_launches(wrappers)
        for _ in range(BF16_REC_STEPS):
            batch = next(batches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(trainer.train_step(batch)["loss"])
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        got = read_launches(wrappers)
    peak = torch.cuda.max_memory_allocated()
    expect = {name: PER_STEP_RECONSTRUCTOR.get(name, 0) * BF16_REC_STEPS
              for name in got}
    expect["top2"] = sum(rec.rounds)
    if got != expect:
        raise AssertionError(f"bf16 reconstructor training: launches {got}, "
                             f"expected {expect}")
    losses = torch.stack(losses).cpu().numpy()
    bad = [n for n, p in model.named_parameters()
           if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    if not np.isfinite(losses).all() or bad:
        raise AssertionError(f"bf16 reconstructor: losses {losses}, "
                             f"gradients {bad[:5]}")
    result = {"bf16_reconstructor_ms_per_step": float(np.median(step_ms)),
              "bf16_reconstructor_steps": BF16_REC_STEPS,
              "bf16_reconstructor_peak_memory_bytes": int(peak),
              "bf16_reconstructor_loss_first": float(losses[0]),
              "bf16_reconstructor_loss_last": float(losses[-1])}
    if profile_dir:
        result.update(profiled_steps(
            trainer, batches, smi,
            os.path.join(profile_dir, "profile_reconstructor_bf16.txt"),
            "bf16_reconstructor_"))
    batch = trainer.to_device(next(batches))
    batches.close()
    noise = sphere_noise(torch.Generator("cuda").manual_seed(2), REC_B,
                         REC_K, "cuda")
    model.eval()
    with torch.no_grad():
        zero_launches(wrappers)
        out16 = model(noise, batch["image"])[0]
        torch.cuda.synchronize()
        evaluation = read_launches(wrappers)
        with mxu_policy(None):
            out32 = model(noise, batch["image"])[0]
    check_launches(evaluation, PER_FORWARD_RECONSTRUCTOR, 1,
                   "bf16 reconstructor evaluation forward")
    cos = cosine(out16, out32)
    log(f"bf16 reconstructor: {result['bf16_reconstructor_ms_per_step']:.3f}"
        f" ms/step, output vs f32 cosine {cos:.7f}")
    if not (torch.isfinite(out16).all() and cos > BF16_COS):
        raise AssertionError(f"bf16 reconstructor output vs f32: {cos}")
    result["bf16_reconstructor_output_vs_f32_cosine"] = cos
    return result, {"bf16_reconstructor": got,
                    "bf16_reconstructor_evaluation": evaluation}


def bf16_single_steps(wrappers, exp_root):
    """Phase 15 (c): one bf16 training step (``model.mxu_dtype: bfloat16``
    in the config) of the full-width completion model, S3DIS segmenter and
    KPConv segmenter through the Trainer on their synthetic data: the
    launches of their float32 steps (the EMD's ``top2`` one a round), a
    finite loss and finite gradients.  -> (result, launches)."""
    from cloud_transformers_tpu_torch.tasks import completion, segmentation
    from cloud_transformers_tpu_torch.tasks import segmentation_kpconv
    from cloud_transformers_tpu_torch.train.config import (
        load_config,
        model_from_config,
    )
    from cloud_transformers_tpu_torch.train.trainer import Trainer

    root = os.path.dirname(os.path.abspath(__file__))

    def completion_parts(cfg, gen):
        return (completion.make_loss_fn(
            gen, float(cfg["train"].get("chamfer_weight", 0.0))),
            completion.make_datasets(cfg, synthetic=True)[0])

    def segmenter_parts(cfg, gen):
        return (segmentation.make_loss_fn(
            int(cfg["model"]["n_classes"]),
            0.1 if cfg["train"].get("label_smooth") else 0.0),
            segmentation.make_datasets(cfg, synthetic=True)[0])

    def kpconv_parts(cfg, gen):
        cfg["data"]["num_steps"] = KP_B
        return (segmentation_kpconv.make_loss_fn(),
                segmentation_kpconv.make_datasets(cfg, synthetic=True)[2])

    result, launches = {}, {}
    for what, config, per_step, parts in (
            ("completion", "inpainting.yaml", PER_STEP_COMPLETION,
             completion_parts),
            ("segmenter", "s3dis.yaml", PER_STEP_SEGMENTER, segmenter_parts),
            ("kpconv", "s3dis_kpconv.yaml", PER_STEP_KPCONV, kpconv_parts)):
        cfg = load_config(os.path.join(root, "configs", config))
        cfg["experiment"] = {"root": exp_root}
        cfg["train"]["save"] = False
        cfg["model"]["mxu_dtype"] = "bfloat16"
        gens = {"train": torch.Generator("cuda").manual_seed(1)}
        loss_fn, loader = parts(cfg, gens["train"])
        trainer = Trainer(model_from_config(cfg), cfg,
                          f"chip_smoke_{what}_bf16", loss_fn, device="cuda",
                          seed=0, generators=gens)
        batches = endless(loader)
        batch = next(batches)
        batches.close()
        torch.cuda.synchronize()
        with EmdRecorder() as rec:
            zero_launches(wrappers)
            t0 = time.perf_counter()
            metrics = trainer.train_step(batch)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            got = read_launches(wrappers)
        expect = {name: per_step.get(name, 0) for name in got}
        expect["top2"] = sum(rec.rounds)
        if got != expect:
            raise AssertionError(f"bf16 {what} step: launches {got}, "
                                 f"expected {expect}")
        loss = float(metrics["loss"])
        bad = [n for n, p in trainer.model.named_parameters()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())]
        if not np.isfinite(loss) or bad:
            raise AssertionError(f"bf16 {what} step: loss {loss}, "
                                 f"gradients {bad[:5]}")
        log(f"bf16 {what} step: loss {loss:.6f} in {seconds:.2f} s (the "
            f"first step, cuDNN plans included), launches {got}")
        result[f"bf16_{what}_loss"] = loss
        result[f"bf16_{what}_first_step_seconds"] = seconds
        launches[f"bf16_{what}"] = got
        del trainer
        torch.cuda.empty_cache()
    return result, launches


def card_cpu_block(name, make, x):
    """Phase 15 (d): the block ``make()`` (weights from seed 0, train mode)
    on ``x`` on the card against the CPU: its output by ``scaled_parity``
    and its gradients (the output's sum against a seeded cotangent) by
    ``card_cpu_gradients``' gates; then the card's output under bf16
    against its float32 one by ``held_bf16`` (train-mode BatchNorm
    normalizes away a channel's mean and so magnifies a contraction's
    rounding where the mean dwarfs the spread, in the JAX package's UNet
    as in the port's: ``tests/test_torch_v2v_unet.py``).  -> result
    dict."""
    from cloud_transformers_tpu_torch.nn.init import init_model_

    cot = None
    runs = {}
    for device in ("cuda", "cpu"):
        model = init_model_(make(), torch.Generator().manual_seed(0))
        model = model.to(device).train()
        out = model(x.to(device))
        if cot is None:
            cot = torch.randn(out.shape, generator=torch.Generator()
                              .manual_seed(1))
        (out * cot.to(device)).sum().backward()
        runs[device] = (out.detach().cpu(),
                        torch.cat([p.grad.reshape(-1).cpu()
                                   for p in model.parameters()]))
        if device == "cuda":
            with torch.no_grad():
                with mxu_policy("bfloat16"):
                    out16 = model(x.to(device))
                noisy = []
                for seed in (1, 2):
                    with contraction_noise(model, seed):
                        noisy.append(model(x.to(device)).cpu())
    result = {f"{name}_parity_output_cosine": scaled_parity(
        runs["cuda"][0], runs["cpu"][0], f"{name} output")[0]}
    a, b = (g.double() for g in (runs["cuda"][1], runs["cpu"][1]))
    cos = cosine(a, b)
    p50 = float((a - b).abs().median()) / float(b.abs().max())
    log(f"{name} gradients card vs CPU: cosine {cos:.7f}, p50 {p50:.3e}")
    if not (bool(torch.isfinite(a).all()) and cos > 0.999 and p50 <= 1e-3):
        raise AssertionError(f"{name} gradients: cosine {cos}, p50 {p50}")
    cos16 = cosine(out16, runs["cuda"][0])
    floors = [cosine(n, runs["cuda"][0]) for n in noisy]
    held_bf16(cos16, floors, f"{name} output on the card")
    result.update({f"{name}_parity_grad_cosine": cos,
                   f"{name}_parity_grad_p50_of_scale": p50,
                   f"{name}_bf16_vs_f32_output_cosine": cos16,
                   f"{name}_bf16_noise_floor_cosines": floors})
    return result


def blocks_phase():
    """Phase 15 (d): ``V2VModel(32, 8, groups=4)`` on B=2 x 32^3 and
    ``UNet(16, n_out=8, groups=4)`` on B=4 x 16 x 128^2."""
    from cloud_transformers_tpu_torch.nn import UNet, V2VModel

    g = torch.Generator().manual_seed(2)
    result = card_cpu_block("v2v", lambda: V2VModel(32, 8, groups=4),
                            torch.randn(2, 32, 32, 32, 32, generator=g))
    result.update(card_cpu_block(
        "unet", lambda: UNet(16, n_out=8, groups=4),
        torch.randn(4, 16, 128, 128, generator=g)))
    return result


def vertex_list_phase(wrappers):
    """Phase 15 (e): the vertex-list API at the classifier's head-group
    shapes (B=8 x 2048 points, 4 heads).  ``grid_positions`` exactly equal
    to the mapping's ``vertex_weights``/``flat_vertex_indices``;
    ``splat_max``/``slice_grid`` on the card against the CPU: the grid and
    the splat's single-winner cotangent routing exact, the slice within
    1e-6 of its scale; ``splat_max_mapping``/``slice_grid_mapping`` bit-
    equal to the ``_k`` forms reshaped, forward and backward, with one
    launch each way counted.  -> (result, launches)."""
    from cloud_transformers_tpu_torch.core import coords
    from cloud_transformers_tpu_torch.core import grid_mapping as gm
    from cloud_transformers_tpu_torch.core import splat_slice as ss
    from cloud_transformers_tpu_torch.core import vertex_list as vl

    h = 4
    gen = torch.Generator().manual_seed(3)
    result, launches = {}, {}
    for sizes, f in (((128, 128), 4), ((32, 32, 32), 4)):
        dim, cells = len(sizes), int(np.prod(sizes))
        keys = torch.tanh(torch.randn(B, K, h, dim, generator=gen))
        keys[:, 1::2] = keys[:, 0::2]                # exact ties
        values = torch.randn(B, K, h * f, generator=gen)
        cot = torch.randn(B, h, cells, f, generator=gen)
        tag = "x".join(map(str, sizes))
        # grid_positions against the kernels' form of the same relation
        w, idx = coords.grid_positions(keys.cuda(), sizes, dim)
        m = gm.grid_mapping(keys.cuda(), sizes, dim)
        order = [0, 4, 2, 6, 1, 5, 3, 7] if dim == 3 else [0, 2, 1, 3]
        mw, mi = gm.vertex_weights(m), gm.flat_vertex_indices(m, sizes)
        if dim == 2:
            mw, mi = mw[..., [0, 1, 4, 5]], mi[..., [0, 1, 4, 5]]
        if not (torch.equal(w[..., order], mw) and
                torch.equal(idx[..., order], mi)):
            raise AssertionError(f"grid_positions {tag}: not the mapping's")
        # the vertex-list splat and slice, card against CPU
        runs = {}
        for device in ("cuda", "cpu"):
            w, idx = coords.grid_positions(keys.to(device), sizes, dim)
            v = values.to(device)
            b, p = B, K
            pre = (w[..., None] * v.reshape(b, p, h, 1, f)).transpose(1, 2)
            pre = pre.reshape(b * h, -1, f).requires_grad_()
            rows = vl._rows(idx)
            grid = vl._SplatCore.apply(pre, rows, cells)
            grid.backward(cot.to(device).reshape(b * h, cells, f))
            sliced = vl.slice_grid(w, idx, grid.detach().reshape(
                b, h, cells, f), h)
            runs[device] = [t.detach().cpu() for t in (grid, pre.grad,
                                                       sliced)]
        (g_card, d_card, s_card), (g_cpu, d_cpu, s_cpu) = runs["cuda"], \
            runs["cpu"]
        err = float((s_card - s_cpu).abs().max()) / max(
            1.0, float(s_cpu.abs().max()))
        if not (torch.equal(g_card, g_cpu) and torch.equal(d_card, d_cpu)
                and err <= 1e-6 and bool(g_card.any())):
            raise AssertionError(f"vertex-list splat/slice {tag}: card vs "
                                 f"CPU (slice error {err})")
        result[f"vertex_list_{tag}_slice_err"] = err
        # the spatial-layout mapping forms against the _k forms
        grid_in = torch.randn(B, h, cells, f, generator=gen).cuda()
        cot_pts = torch.randn(B, K, h * f, generator=gen).cuda()
        forms = {}
        for form in ("spatial", "k"):
            kk, vv, gg = (t.cuda().clone().requires_grad_()
                          for t in (keys, values, grid_in))
            zero_launches(wrappers)
            m = gm.grid_mapping(kk, sizes, dim)
            if form == "spatial":
                grid = ss.splat_max_mapping(m, vv, sizes)
                out = ss.slice_grid_mapping(m, gg, sizes)
            else:
                grid = ss.splat_max_mapping_k(m, vv, sizes).reshape(gg.shape)
                out = ss.slice_grid_mapping_k(
                    m, gg.reshape(B * h, cells, f), sizes, f)
            ((out * cot_pts).sum() + (grid * cot.cuda()).sum()).backward()
            torch.cuda.synchronize()
            got = read_launches(wrappers)
            check_launches(got, {"splat_max": 1, "slice_gather": 1,
                                 "splat_max_bwd": 1, "slice_bwd": 1}, 1,
                           f"{form} mapping forms {tag}")
            launches[f"vertex_list_{form}_{tag}"] = got
            forms[form] = (grid.detach(), out.detach(), kk.grad, vv.grad,
                           gg.grad)
        if not all(torch.equal(a, c) for a, c in zip(forms["spatial"],
                                                     forms["k"])):
            raise AssertionError(f"mapping forms {tag}: not the _k forms'")
        log(f"vertex-list API {tag}: grid_positions is the mapping's, "
            f"splat exact and slice within {err:.2e} card vs CPU, mapping "
            f"forms bit-equal to the _k forms")
    return result, launches


def bf16_phase(wrappers, smi, profile_dir, exp_root):
    """Phase 15: the bf16 operand policy on every model, the V2V and UNet
    blocks and the vertex-list API.  The policy is float32 again after
    each part.  -> (result, {path: launches})."""
    launches = {}
    with mxu_policy(None):
        result, launches["bf16_serving"] = bf16_serving(wrappers, smi,
                                                        profile_dir)
    torch.cuda.empty_cache()
    holder = {}

    def sets(trainer, batches):
        for name in SETS:
            holder[name] = classifier_step_under_set(
                name, trainer, batches, wrappers, "bf16 training")

    with mxu_policy(None):
        trained, launches["bf16_training"] = train_phase(
            wrappers, smi, profile_dir, exp_root, steps=BF16_STEPS,
            profile_name="profile_train_bf16.txt", mxu_dtype="bfloat16",
            after=sets)
    for name in SETS:
        launches[f"bf16_training_{name}"] = holder[name]
    result.update({f"bf16_{k}": v for k, v in trained.items()})
    torch.cuda.empty_cache()
    with mxu_policy(None):
        result.update(bf16_gradient_cosine())
    torch.cuda.empty_cache()
    with mxu_policy(None):
        rebuilt, got = bf16_reconstructor(wrappers, smi, profile_dir,
                                          exp_root)
    result.update(rebuilt)
    launches.update(got)
    torch.cuda.empty_cache()
    with mxu_policy(None):
        stepped, got = bf16_single_steps(wrappers, exp_root)
    result.update(stepped)
    launches.update(got)
    torch.cuda.empty_cache()
    result.update(blocks_phase())
    torch.cuda.empty_cache()
    listed, got = vertex_list_phase(wrappers)
    result.update(listed)
    launches.update(got)
    return result, launches


# --- phase 16: the parallel layer, ranks on the one card -----------------

PAR_WORLD = 2   # ranks on the card, over gloo (NCCL takes one rank a card)
PAR_B = B // PAR_WORLD   # clouds a rank: the global batch is phase 6's
PAR_STEPS = 10   # timed data-parallel steps, after one warm-up step
PAR_PROFILE_STEPS = 3   # steps of each rank under the profiler
PAR_CHAMFER = (2, 16384)   # (clouds, points a cloud) of the sharded Chamfer
PAR_JOIN_S = 900   # the children of a run, joined with this timeout
PAR_GROUP_S = 600   # the process group's timeout: a dead peer fails the rest
PAR_STAT_TOL = 1e-6   # running statistics, of max(1, a buffer's largest)
PAR_LOSS_TOL = 1e-5   # the two-rank loss against one process's, relative


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(target, world, workdir, *args):
    """``target(rank, world, port, workdir, *args)`` in ``world`` fresh
    processes (spawn) that meet at a TCP rendezvous on localhost; each
    saves ``workdir/rank{r}.pt``.  A rank that fails fails the phase: no
    rank's error is caught, the join has a timeout, and a rank left
    running is killed.  -> [rank r's saved dict]."""
    import multiprocessing
    os.makedirs(workdir, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=target, args=(r, world, port, workdir)
                         + args) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + PAR_JOIN_S
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(30)
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise AssertionError(f"{target.__name__}: rank exit codes {codes} "
                             f"(a killed rank outlived {PAR_JOIN_S} s)")
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def _rank_setup():
    """A child's start: the repository on the path, float32 as the parent
    has it, and the kernels the parent built."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cloud_transformers_tpu_torch.nn.precision import strict_f32
    from cloud_transformers_tpu_torch.ops import cuda_build
    torch.cuda.set_device(0)
    strict_f32()
    cuda_build.build()
    cuda_build.libraries()


def _rank_wrappers():
    from cloud_transformers_tpu_torch.ops import pallas_grid_conv as gc
    from cloud_transformers_tpu_torch.ops import pallas_splat as ps
    return {"splat_max": ps.splat_max, "slice_gather": ps.slice_gather,
            "grid_conv3d": gc.grid_conv3d,
            "splat_max_bwd": ps.splat_max_bwd, "slice_bwd": ps.slice_bwd,
            "grid_conv3d_dw": gc.grid_conv3d_dw}


def sharded_ops(rank, world):
    """Phase 16a on one rank: the point-sharded splat, slice and Chamfer on
    this rank's half of each cloud against the single-process kernels on
    the whole cloud, which every rank also runs.  -> result dict."""
    from cloud_transformers_tpu_torch.core.grid_mapping import (
        GridMapping,
        grid_mapping,
    )
    from cloud_transformers_tpu_torch.core.splat_slice import (
        slice_grid_mapping,
        splat_max_mapping,
    )
    from cloud_transformers_tpu_torch.losses.chamfer import chamfer_distance
    from cloud_transformers_tpu_torch.parallel import point_sharded as pps
    from cloud_transformers_tpu_torch.parallel.distributed import all_reduce_

    gen = torch.Generator(device="cuda").manual_seed(16)   # alike on ranks
    lo, hi = rank * K // world, (rank + 1) * K // world
    out = {}

    def local(m):
        return GridMapping(*(a[:, lo:hi] for a in m))

    def grad_of(fn, v, cot):
        v = v.detach().clone().requires_grad_(True)
        (fn(v) * cot).sum().backward()
        return v.grad

    for sizes, f, _, _ in POINT_SHAPES:
        name = shape_name(sizes, f)
        dim = len(sizes)
        lat = torch.tanh(torch.randn(B, K, H, dim, generator=gen,
                                     device="cuda"))
        values = torch.randn(B, K, H * f, generator=gen, device="cuda")
        m = grid_mapping(lat, sizes, dim)
        ml = local(m)
        whole = splat_max_mapping(m, values, sizes)
        grid = pps.splat_max_point_sharded(ml, values[:, lo:hi], sizes)
        again = pps.splat_max_point_sharded(ml, values[:, lo:hi], sizes)
        if not (torch.equal(grid, whole) and torch.equal(grid, again)):
            raise AssertionError(f"sharded splat {name}: not the "
                                 "single-process grid, bit for bit, twice")
        # cells whose positive maximum more than one rank holds
        held = (splat_max_mapping(ml, values[:, lo:hi], sizes) == grid)
        ties = int(((all_reduce_(held.float(), "sum") > 1)
                    & (grid > 0)).sum())
        cot = torch.randn(whole.shape, generator=gen, device="cuda")
        d_sh = grad_of(lambda v: pps.splat_max_point_sharded(
            ml, v, sizes), values[:, lo:hi], cot)
        d_one = grad_of(lambda v: splat_max_mapping(m, v, sizes), values,
                        cot)[:, lo:hi]
        g_err = float((d_sh - d_one).abs().max()) / max(
            1.0, float(d_one.abs().max()))
        if ties == 0 and g_err > ROUTE_TOL:
            raise AssertionError(f"sharded splat backward {name}: {g_err} "
                                 "from the single-process gradient")
        sl = pps.slice_grid_point_sharded(ml, whole, sizes)
        sl_one = slice_grid_mapping(m, whole, sizes)[:, lo:hi]
        s_err = float((sl - sl_one).abs().max()) / max(
            1.0, float(sl_one.abs().max()))
        if s_err > ROUTE_TOL:
            raise AssertionError(f"sharded slice {name}: {s_err}")
        out[name] = {"grid_bit_equal": True, "cross_rank_ties": ties,
                     "value_grad_err": g_err,
                     "value_grad_bit_equal": bool(torch.equal(d_sh, d_one)),
                     "slice_err": s_err,
                     "slice_bit_equal": bool(torch.equal(sl, sl_one))}

    # a built tie: the second half of the cloud repeats the first, so each
    # positive maximum is held by both ranks, which split its cotangent
    sizes, f = (32, 32, 32), 4
    half = K // world
    lat = torch.tanh(torch.randn(B, half, H, 3, generator=gen,
                                 device="cuda")).repeat(1, world, 1, 1)
    values = torch.randn(B, half, H * f, generator=gen,
                         device="cuda").repeat(1, world, 1)
    m = grid_mapping(lat, sizes, 3)
    cot = torch.randn(B, H, int(np.prod(sizes)), f, generator=gen,
                      device="cuda")
    d_sh = grad_of(lambda v: pps.splat_max_point_sharded(
        local(m), v, sizes), values[:, lo:hi], cot)
    d_one = grad_of(lambda v: splat_max_mapping(m, v, sizes), values, cot)
    shares = all_reduce_(d_sh.clone(), "sum")
    first = all_reduce_(d_sh.clone() * (rank == 0), "sum")
    if not (torch.equal(shares, d_one[:, :half])
            and torch.equal(first * 2, shares)
            and not d_one[:, half:].any() and bool(d_one.any())):
        raise AssertionError("built cross-rank tie: the two ranks' shares "
                             "are not halves of the lowest index's gradient")
    out["tie_split"] = {"shape": shape_name(sizes, f),
                        "points_with_gradient": int(
                            (d_one[:, :half].abs().sum(-1) > 0).sum())}

    cb, cn = PAR_CHAMFER
    x = torch.randn(cb, cn, 3, generator=gen, device="cuda")
    y = torch.randn(cb, cn, 3, generator=gen, device="cuda")
    c0, c1 = rank * cn // world, (rank + 1) * cn // world
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sharded = pps.chamfer_point_sharded(x[:, c0:c1], y[:, c0:c1])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    whole = chamfer_distance(x, y)
    d_err = max(float((s - w[:, c0:c1]).abs().max())
                for s, w in zip(sharded[:2], whole[:2]))
    same_idx = all(torch.equal(s, w[:, c0:c1])
                   for s, w in zip(sharded[2:], whole[2:]))
    if d_err > 1e-6 or not same_idx:
        raise AssertionError(f"sharded Chamfer: distances {d_err} off, "
                             f"indices equal {same_idx}")
    out["chamfer"] = {"clouds": cb, "points": cn, "dist_max_abs_err": d_err,
                      "indices_equal": True, "host_ms": ms}
    return out


def _classifier_trainer(exp_root, dropout=None, mesh=None):
    """The full-width classifier of ``configs/scanobjectnn.yaml`` in a
    ``Trainer`` on this process's card, its loader taking this process's
    rows of the synthetic set (``data.batch_size`` a process, or a data
    row of ``mesh``)."""
    import contextlib

    from cloud_transformers_tpu_torch.parallel.distributed import world_size
    from cloud_transformers_tpu_torch.tasks import classification
    from cloud_transformers_tpu_torch.train.config import (
        load_config,
        model_from_config,
    )
    from cloud_transformers_tpu_torch.train.trainer import Trainer

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config(os.path.join(root, "configs", "scanobjectnn.yaml"))
    cfg["data"]["batch_size"] = B // (world_size() if mesh is None
                                      else mesh.n_data)
    cfg["experiment"] = {"root": exp_root}
    cfg["train"]["auto_resume"] = False
    if dropout is not None:
        cfg["model"]["dropout"] = dropout
    trainer = Trainer(model_from_config(cfg), cfg, "parallel",
                      classification.make_loss_fn(
                          float(cfg["train"].get("seg_weight", 0.5))),
                      device="cuda:0", seed=0, mesh=mesh)
    with mesh if mesh is not None else contextlib.nullcontext():
        loader, _ = classification.make_datasets(cfg, synthetic=True)
    return trainer, loader


def _flat(tensors):
    return torch.cat([t.detach().reshape(-1).float() for t in tensors])


def parity_step(exp_root):
    """One training step of the full-width classifier, dropout 0, on this
    process's rows of the synthetic set's first global batch.  -> the
    loss, the (averaged) gradients and the BatchNorm buffers after it,
    flat, on the host."""
    trainer, loader = _classifier_trainer(exp_root, dropout=0.0)
    loader.set_epoch(0)
    loss = trainer.train_step(next(iter(loader)))["loss"]
    model = trainer.model
    return {"loss": float(loss),
            "grads": _flat(p.grad for p in model.parameters()).cpu(),
            "buffers": _flat(model.buffers()).cpu(),
            "buffer_sizes": [b.numel() for b in model.buffers()]}


def collective_costs(trainer, batches):
    """Where a data-parallel step's host time goes: the collectives one
    step makes (counted at ``torch.distributed.all_reduce``, restored
    after) and the time of one all-reduce of the flat gradient and of a
    small one (a BatchNorm's statistics), each the median of a few, host
    clock, synchronised."""
    import torch.distributed as dist
    from cloud_transformers_tpu_torch.parallel.distributed import all_reduce_

    calls, sizes = [0], []
    reduce = dist.all_reduce

    def counted(t, *a, **kw):
        calls[0] += 1
        sizes.append(t.numel())
        return reduce(t, *a, **kw)

    dist.all_reduce = counted
    try:
        trainer.train_step(next(batches))
        torch.cuda.synchronize()
    finally:
        dist.all_reduce = reduce

    def timed(n, reps):
        buf = torch.zeros(n, device="cuda")
        ms = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            all_reduce_(buf, "sum")
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ms))

    n_grad = sum(p.numel() for p in trainer.model.parameters())
    return {"all_reduces_per_step": calls[0],
            "floats_all_reduced_per_step": int(sum(sizes)),
            "gradient_all_reduce_ms": timed(n_grad, 5),
            "gradient_floats": n_grad,
            "small_all_reduce_ms": timed(1024, 50)}


def parallel_rank(rank, world, port, workdir):
    """Phase 16 on one of ``world`` ranks of a gloo group on the one card:
    16a, then ``PAR_STEPS`` counted, timed data-parallel steps of the
    full-width classifier, then its parity step.  Saves its results in
    ``workdir/rank{rank}.pt``."""
    _rank_setup()
    from cloud_transformers_tpu_torch.parallel import distributed as pdist

    pdist.distributed_init(f"localhost:{port}", world, rank,
                           backend="gloo", device="cuda:0",
                           timeout_s=PAR_GROUP_S)
    out = {"ops": sharded_ops(rank, world)}
    torch.cuda.empty_cache()
    wrappers = _rank_wrappers()
    trainer, loader = _classifier_trainer(os.path.join(workdir, "exp"))
    batches = endless(loader)
    trainer.train_step(next(batches))            # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    zero_launches(wrappers)
    step_ms, losses = [], []
    for _ in range(PAR_STEPS):
        batch = next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(trainer.train_step(batch)["loss"])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = read_launches(wrappers)
    check_launches(launches, PER_STEP, PAR_STEPS,
                   f"rank {rank}'s data-parallel steps")
    losses = torch.stack(losses).cpu().numpy()
    model = trainer.model
    if not np.isfinite(losses).all() or not all(
            p.grad is not None and bool(torch.isfinite(p.grad).all())
            for p in model.parameters()):
        raise AssertionError(f"rank {rank}: a non-finite loss or gradient")
    # every rank holds rank 0's parameters and buffers, bit for bit
    state = _flat(list(model.parameters()) + list(model.buffers()))
    ref = pdist.broadcast_tensors_([state.clone()])[0]
    differ = pdist.all_reduce_(
        torch.tensor([float(not torch.equal(state, ref))], device="cuda"),
        "max")
    if float(differ) != 0:
        raise AssertionError("the ranks' parameters or buffers differ after "
                             f"{PAR_STEPS + 1} steps")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PAR_PROFILE_STEPS):
            trainer.train_step(next(batches))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = device_ms(prof.key_averages())
    out["collectives"] = collective_costs(trainer, batches)
    out["training"] = {
        "rank": rank, "launches": launches,
        "ms_per_step": float(np.median(step_ms)),
        "ms_p10": float(np.percentile(step_ms, 10)),
        "ms_p90": float(np.percentile(step_ms, 90)),
        "profiled_wall_ms_per_step": wall / PAR_PROFILE_STEPS,
        "profiled_device_ms_per_step": busy / PAR_PROFILE_STEPS,
        "profiled_device_idle_share": 1 - busy / wall,
        "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
        "peak_memory_bytes": int(torch.cuda.max_memory_allocated())}
    del trainer, model, batches, loader, state, ref
    torch.cuda.empty_cache()
    out["parity"] = parity_step(os.path.join(workdir, "exp_parity"))
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    pdist.destroy()


def solo_rank(rank, world, port, workdir):
    """The one-process references of phase 16, cuDNN deterministic: the
    parity step at the whole global batch twice with no process group,
    then once more in a world of one over NCCL."""
    _rank_setup()
    from cloud_transformers_tpu_torch.parallel import distributed as pdist

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    exp = os.path.join(workdir, "exp_solo")
    out = {"alone": parity_step(exp), "alone_again": parity_step(exp)}
    pdist.distributed_init(f"localhost:{port}", world, rank,
                           backend="nccl", device="cuda:0",
                           timeout_s=PAR_GROUP_S)
    out["nccl_world_of_one"] = parity_step(exp)
    out["backend"] = torch.distributed.get_backend()
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    pdist.destroy()


def parallel_phase(smi):
    """Phase 16: two ranks on the card over gloo (16a, the data-parallel
    training and its parity step), then the one-process references.
    -> (result dict, {rank: launches in the timed steps})."""
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        ranks = spawn_ranks(parallel_rank, PAR_WORLD,
                            os.path.join(workdir, "ranks"))
        ranked_s = time.perf_counter() - t0
        solo = spawn_ranks(solo_rank, 1, os.path.join(workdir, "solo"))[0]
    result = {"world": PAR_WORLD, "backend": "gloo (CUDA tensors)",
              "batch_per_rank": PAR_B, "points": K, "steps": PAR_STEPS,
              "ranks_seconds": ranked_s, "card": smi,
              "ops": [r["ops"] for r in ranks],
              "training": [r["training"] for r in ranks],
              "collectives": [r["collectives"] for r in ranks]}
    # parity: the two ranks' step against one process's on the same global
    # batch and weights
    alone = solo["alone"]
    two = [r["parity"] for r in ranks]
    if not torch.equal(two[0]["grads"], two[1]["grads"]):
        raise AssertionError("the ranks' averaged gradients differ")
    loss = float(np.mean([t["loss"] for t in two]))
    loss_rel = abs(loss - alone["loss"]) / abs(alone["loss"])
    if loss_rel > PAR_LOSS_TOL:
        raise AssertionError(f"two-rank loss {loss} against one process's "
                             f"{alone['loss']}: {loss_rel} relative")
    g, g1 = two[0]["grads"].double(), alone["grads"].double()
    cos = float(g @ g1 / (g.norm() * g1.norm()))
    p50 = float((g - g1).abs().median() / g1.abs().max())
    if not (cos > 0.999 and p50 <= 1e-3):
        raise AssertionError(f"two-rank gradients against one process's: "
                             f"cosine {cos}, p50 {p50}")
    stat_err = 0.0
    for t in two:
        for a, b in zip(torch.split(t["buffers"], t["buffer_sizes"]),
                        torch.split(alone["buffers"],
                                    alone["buffer_sizes"])):
            stat_err = max(stat_err, float((a - b).abs().max())
                           / max(1.0, float(b.abs().max())))
    if stat_err > PAR_STAT_TOL:
        raise AssertionError(f"running statistics {stat_err} relative from "
                             "one process's")
    # a world of one over NCCL takes the step of no process group
    again = solo["alone_again"]
    repeat_equal = torch.equal(again["grads"], alone["grads"]) and \
        torch.equal(again["buffers"], alone["buffers"])
    world1 = solo["nccl_world_of_one"]
    world1_equal = torch.equal(world1["grads"], alone["grads"]) and \
        torch.equal(world1["buffers"], alone["buffers"]) and \
        world1["loss"] == alone["loss"]
    spread = float((again["grads"] - alone["grads"]).abs().max())
    world1_err = float((world1["grads"] - alone["grads"]).abs().max())
    if solo["backend"] != "nccl" or (
            world1_err > spread if not repeat_equal else not world1_equal):
        raise AssertionError(
            f"world of one over {solo['backend']}: gradients {world1_err} "
            f"from the step without a group (two such steps: {spread}; bit "
            f"equal {repeat_equal})")
    result["parity"] = {
        "loss_two_ranks": loss, "loss_one_process": alone["loss"],
        "loss_rel_diff": loss_rel, "grad_cosine": cos, "grad_p50": p50,
        "running_stats_rel_err": stat_err,
        "one_process_repeat_bit_equal": repeat_equal,
        "nccl_world_of_one_bit_equal": world1_equal,
        "nccl_world_of_one_grad_max_abs_diff": world1_err}
    launches = {f"rank{t['rank']}": t["launches"]
                for t in result["training"]}
    return result, launches


# --- phase 17: the points axis -----------------------------------------------

PTS_GRID = (2, 2)   # (data, points) ranks on the card, over gloo
PTS_WORLD = PTS_GRID[0] * PTS_GRID[1]
PTS_STEPS = 3   # timed grid steps of the classifier, after its parity step
PTS_KP = (4, 8192)   # 17b: ragged spheres, points a sphere
# 17b: each sphere's valid points, a prefix; the first sphere's second point
# block (its points 4096..8191 on a points rank) holds no valid point
PTS_KP_VALID = (3000, 5200, 8192, 6100)
PTS_INP = (2, 2048, 16384)   # 17c: clouds, partial points, output points
# 17b and 17c: the config and the depth cut to keep the phase short
PTS_MODELS = {"segmenter": ("s3dis_kpconv.yaml", {"repeats": 1}),
              "inpainter": ("inpainting.yaml", {"encoder_repeats": 1,
                                                "decoder_repeats": 1})}


def trunk_step_counts(repeats, pools=0):
    """Launches of #1-#6 in one training step of ``repeats`` stages of
    ``DEFAULT_STAGE_PLAN`` (6 head groups a stage, 2 of them 3D grids with
    X >= 16) and ``pools`` pool heads (a splat each)."""
    return {"splat_max": 6 * repeats + pools, "slice_gather": 6 * repeats,
            "grid_conv3d": 4 * repeats, "splat_max_bwd": 6 * repeats + pools,
            "slice_bwd": 6 * repeats, "grid_conv3d_dw": 2 * repeats}


# per step on every rank of the grid: 17a's full classifier (``PER_STEP``'s
# #1-#6; the grid's BatchNorms span the points group, on the plain ops),
# 17b's one-stage segmenter, 17c's one-stage encoder (with its two pools)
# and one-stage decoder
PTS_PER_STEP = {"classifier": trunk_step_counts(4, 2),
                "segmenter": trunk_step_counts(1),
                "inpainter": trunk_step_counts(2, 2)}


def points_batch(family):
    """17b's or 17c's global batch, from numpy's generator (alike in every
    process).  17b pads each sphere as ``S3DISSeg`` does: the valid points
    first, then repeats of valid points (keys, features and labels)."""
    rs = np.random.RandomState(17)
    if family == "segmenter":
        b, k = PTS_KP
        pts = rs.uniform(-1, 1, (b, k, 3)).astype(np.float32)
        feats = rs.uniform(0, 1, (b, k, 4)).astype(np.float32)
        labels = rs.randint(0, 13, (b, k)).astype(np.int32)
        mask = np.zeros((b, k), np.float32)
        for i, n in enumerate(PTS_KP_VALID):
            idx = np.concatenate([np.arange(n), rs.randint(0, n, k - n)])
            pts[i], feats[i], labels[i] = pts[i, idx], feats[i, idx], \
                labels[i, idx]
            mask[i, :n] = 1
        return {"points": pts, "features": feats, "mask": mask,
                "label": labels}
    b, n_in, n_out = PTS_INP
    extent = np.linspace(0.6, 1.0, b)[:, None, None]   # clouds unalike
    xyz = rs.randn(b, n_out, 3)
    label = (np.arange(n_out) % 2)[None, :, None].repeat(b, 0)
    return {"partial": (rs.uniform(-0.5, 0.5, (b, n_in, 3))
                        * extent).astype(np.float32),
            "gt": (rs.uniform(-0.5, 0.5, (b, n_out, 3))
                   * extent).astype(np.float32),
            "noise": np.concatenate(
                [xyz / np.linalg.norm(xyz, axis=-1, keepdims=True), label],
                -1).astype(np.float32)}


def chamfer_loss(model, batch):
    """17c's loss, the dryrun's: the Chamfer distance of the completion
    against ``gt``."""
    from cloud_transformers_tpu_torch.losses.chamfer import loss_chamfer
    recon, _ = model(batch["noise"], batch["partial"])
    return loss_chamfer(recon, batch["gt"]), {}


def _points_trainer(family, exp_root, mesh=None):
    """17b's or 17c's model at full width, its depth cut
    (``PTS_MODELS``), in a ``Trainer`` on this process's card."""
    from cloud_transformers_tpu_torch.tasks import segmentation_kpconv
    from cloud_transformers_tpu_torch.train.config import (
        load_config,
        model_from_config,
    )
    from cloud_transformers_tpu_torch.train.trainer import Trainer

    name, keys = PTS_MODELS[family]
    root = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config(os.path.join(root, "configs", name))
    cfg["model"].update(keys)
    cfg["experiment"] = {"root": exp_root}
    cfg["train"]["auto_resume"] = False
    loss_fn = segmentation_kpconv.make_loss_fn() if family == "segmenter" \
        else chamfer_loss
    return Trainer(model_from_config(cfg), cfg, family, loss_fn,
                   device="cuda:0", seed=0, mesh=mesh)


def _step_result(trainer, loss):
    model = trainer.model
    return {"loss": float(loss),
            "grads": _flat(p.grad for p in model.parameters()).cpu(),
            "buffers": _flat(model.buffers()).cpu(),
            "buffer_sizes": [b.numel() for b in model.buffers()]}


def _alike_on_ranks(model):
    """Whether every rank holds rank 0's parameters and buffers, bit for
    bit."""
    from cloud_transformers_tpu_torch.parallel import distributed as pdist
    state = _flat(list(model.parameters()) + list(model.buffers()))
    ref = pdist.broadcast_tensors_([state.clone()])[0]
    differ = pdist.all_reduce_(
        torch.tensor([float(not torch.equal(state, ref))], device="cuda"),
        "max")
    return float(differ) == 0


def points_rank(rank, world, port, workdir):
    """Phase 17 on one rank of the data 2 x points 2 grid over gloo on the
    one card: 17a's parity step and ``PTS_STEPS`` timed steps of the
    full-width classifier, then 17b's and 17c's parity steps, each
    counted.  Saves its results in ``workdir/rank{rank}.pt``."""
    _rank_setup()
    from cloud_transformers_tpu_torch.parallel import distributed as pdist
    from cloud_transformers_tpu_torch.parallel.mesh import (
        make_mesh,
        shard_batch,
    )

    pdist.distributed_init(f"localhost:{port}", world, rank,
                           backend="gloo", device="cuda:0",
                           timeout_s=PAR_GROUP_S)
    mesh = make_mesh(*PTS_GRID)
    wrappers = _rank_wrappers()
    out = {"rank": rank, "index": (mesh.data_index, mesh.points_index)}

    # 17a: the parity step from the initial weights on the first batch
    trainer, loader = _classifier_trainer(os.path.join(workdir, "exp_a"),
                                          dropout=0.0, mesh=mesh)
    batches = endless(loader)
    zero_launches(wrappers)
    loss = trainer.train_step(next(batches))["loss"]
    torch.cuda.synchronize()
    out["classifier"] = _step_result(trainer, loss)
    out["classifier"]["launches"] = read_launches(wrappers)
    check_launches(out["classifier"]["launches"], PTS_PER_STEP["classifier"],
                   1, f"rank {rank}'s classifier grid step")
    if not _alike_on_ranks(trainer.model):
        raise AssertionError("17a: the ranks' parameters or buffers differ "
                             "after a grid step")
    # then timed steps, a profiled one, and one with its collectives counted
    torch.cuda.reset_peak_memory_stats()
    zero_launches(wrappers)
    step_ms, losses = [], []
    for _ in range(PTS_STEPS):
        batch = next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(trainer.train_step(batch)["loss"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = read_launches(wrappers)
    check_launches(launches, PTS_PER_STEP["classifier"], PTS_STEPS,
                   f"rank {rank}'s timed classifier grid steps")
    peak = int(torch.cuda.max_memory_allocated())
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(next(batches))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = device_ms(prof.key_averages())
    if not np.isfinite(losses).all():
        raise AssertionError(f"17a rank {rank}: non-finite losses {losses}")
    out["timing"] = {
        "rank": rank, "index": out["index"], "launches": launches,
        "steps": PTS_STEPS, "ms_per_step": float(np.median(step_ms)),
        "ms_p10": float(np.percentile(step_ms, 10)),
        "ms_p90": float(np.percentile(step_ms, 90)),
        "profiled_wall_ms": wall, "profiled_device_ms": busy,
        "profiled_device_idle_share": 1 - busy / wall,
        "peak_memory_bytes": peak, "losses": losses,
        "collectives": collective_costs(trainer, batches)}
    del trainer, loader, batches
    torch.cuda.empty_cache()

    # 17b and 17c: one parity step each
    for family in ("segmenter", "inpainter"):
        trainer = _points_trainer(family, os.path.join(workdir, family),
                                  mesh)
        rows = shard_batch(mesh, points_batch(family))
        zero_launches(wrappers)
        loss = trainer.train_step(rows)["loss"]
        torch.cuda.synchronize()
        out[family] = _step_result(trainer, loss)
        out[family]["launches"] = read_launches(wrappers)
        check_launches(out[family]["launches"], PTS_PER_STEP[family], 1,
                       f"rank {rank}'s {family} grid step")
        if not _alike_on_ranks(trainer.model):
            raise AssertionError(f"17 {family}: the ranks' parameters or "
                                 "buffers differ after a grid step")
        del trainer
        torch.cuda.empty_cache()
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    pdist.destroy()


def points_solo(rank, world, port, workdir):
    """Phase 17's one-process references, cuDNN deterministic: each
    family's step on the whole global batch, with no process group."""
    _rank_setup()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out = {"classifier": parity_step(os.path.join(workdir, "exp_solo"))}
    for family in ("segmenter", "inpainter"):
        trainer = _points_trainer(family, os.path.join(workdir, family))
        loss = trainer.train_step(points_batch(family))["loss"]
        out[family] = _step_result(trainer, loss)
        del trainer
        torch.cuda.empty_cache()
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))


def _points_parity(family, grid, alone):
    """The grid's step (the ranks' mean loss, their averaged gradients and
    running statistics, equal on every rank) against one process's: the
    loss within ``PAR_LOSS_TOL`` relative, the gradients by PARITY.md,
    the statistics within ``PAR_STAT_TOL`` of max(1, |buffer|)."""
    for g in grid[1:]:
        if not (torch.equal(g["grads"], grid[0]["grads"])
                and torch.equal(g["buffers"], grid[0]["buffers"])):
            raise AssertionError(f"17 {family}: the ranks' averaged "
                                 "gradients or statistics differ")
    loss = float(np.mean([g["loss"] for g in grid]))
    loss_rel = abs(loss - alone["loss"]) / abs(alone["loss"])
    if loss_rel > PAR_LOSS_TOL:
        raise AssertionError(f"17 {family}: grid loss {loss} against one "
                             f"process's {alone['loss']}: {loss_rel}")
    g, g1 = grid[0]["grads"].double(), alone["grads"].double()
    cos = float(g @ g1 / (g.norm() * g1.norm()))
    p50 = float((g - g1).abs().median() / g1.abs().max())
    if not (cos > 0.999 and p50 <= 1e-3):
        raise AssertionError(f"17 {family}: grid gradients against one "
                             f"process's: cosine {cos}, p50 {p50}")
    stat_err = 0.0
    for a, b in zip(torch.split(grid[0]["buffers"], grid[0]["buffer_sizes"]),
                    torch.split(alone["buffers"], alone["buffer_sizes"])):
        stat_err = max(stat_err, float((a - b).abs().max())
                       / max(1.0, float(b.abs().max())))
    if stat_err > PAR_STAT_TOL:
        raise AssertionError(f"17 {family}: running statistics {stat_err} "
                             "relative from one process's")
    return {"loss_grid": loss, "loss_one_process": alone["loss"],
            "loss_rel_diff": loss_rel, "grad_cosine": cos,
            "grad_p50": p50, "running_stats_rel_err": stat_err,
            "grad_max_abs_diff": float((g - g1).abs().max()),
            "launches_per_rank": [r["launches"] for r in grid]}


def points_phase(smi):
    """Phase 17: the data 2 x points 2 grid of ranks on the card over
    gloo (17a-17c), then the one-process references.  -> (result dict,
    {path: rank 0's launches})."""
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        ranks = spawn_ranks(points_rank, PTS_WORLD,
                            os.path.join(workdir, "ranks"))
        ranked_s = time.perf_counter() - t0
        solo = spawn_ranks(points_solo, 1, os.path.join(workdir, "solo"))[0]
    result = {"grid": {"data": PTS_GRID[0], "points": PTS_GRID[1]},
              "backend": "gloo (CUDA tensors, four ranks on one card)",
              "card": smi, "ranks_seconds": ranked_s,
              "classifier_batch": {"global": [B, K],
                                   "rank": [B // PTS_GRID[0],
                                            K // PTS_GRID[1]]},
              "segmenter_batch": {"global": list(PTS_KP),
                                  "valid": list(PTS_KP_VALID)},
              "inpainter_batch": {"global": list(PTS_INP)}}
    for family in ("classifier", "segmenter", "inpainter"):
        result[family] = _points_parity(family, [r[family] for r in ranks],
                                        solo[family])
    result["classifier"]["timing"] = [r["timing"] for r in ranks]
    launches = {f"points_{family}": ranks[0][family]["launches"]
                for family in ("classifier", "segmenter", "inpainter")}
    return result, launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help=f"profile {PROFILE_CALLS} classify calls and "
                         f"{PROFILE_STEPS} training steps of each model: "
                         "device idle share, and the tables in "
                         "DIR/profile_forward.txt, DIR/profile_train.txt, "
                         "DIR/profile_completion.txt, "
                         "DIR/profile_segmenter.txt, "
                         "DIR/profile_reconstructor.txt, "
                         "DIR/profile_kpconv.txt, "
                         "DIR/profile_scales.txt, under each "
                         "set, "
                         "DIR/profile_{forward,train}_set_{a,b}.txt and "
                         "under bf16 DIR/profile_{forward,train,"
                         "reconstructor}_bf16.txt")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available; nothing was run")
        return 2
    # the default path is the JAX package's defaults; the sets of switches
    # are set by the phases themselves
    for var in ("CT_GRID_CONV", "CT_BLOCK_FUSION"):
        if os.environ.pop(var, None) is not None:
            log(f"{var} ignored: chip_smoke runs each set of switches itself")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cloud_transformers_tpu_torch.nn.precision import strict_f32
    from cloud_transformers_tpu_torch.ops import batch_norm as bn_ops
    from cloud_transformers_tpu_torch.ops import cuda_build
    from cloud_transformers_tpu_torch.ops import pallas_emd as pe
    from cloud_transformers_tpu_torch.ops import pallas_fused_block as fb
    from cloud_transformers_tpu_torch.ops import pallas_grid_conv as gc
    from cloud_transformers_tpu_torch.ops import pallas_splat as ps
    from cloud_transformers_tpu_torch.serve import InferenceEngine

    strict_f32()
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}, "
        f"torch.backends.cudnn.allow_tf32 = "
        f"{torch.backends.cudnn.allow_tf32}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # 1. build
    t0 = time.perf_counter()
    built = cuda_build.build()
    cuda_build.libraries()
    log(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for so in built.values():
        ptxas = so.with_suffix(".log").read_text(errors="replace")
        log("\n".join(line for line in ptxas.splitlines()
                      if "registers" in line or "spill" in line))

    # 2. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    # 3. kernels vs plain versions at the main-path shapes
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    rows = check_kernels(gen)
    rows.update(check_emd_kernels(gen))
    completion_rows = check_completion_rows(gen)
    segmenter_rows = check_trunk_rows(gen, rows, B, SEG_K)
    reconstructor_rows = check_trunk_rows(gen, rows, REC_B, REC_K)
    kpconv_rows = check_trunk_rows(gen, rows, KP_B, KP_K, ragged=True)
    torch.cuda.empty_cache()
    normed = batch_norm_phase(gen)
    log(f"kernel checks done in {time.perf_counter() - t0:.1f} s")

    # 4. the main path: serve full-width classifier requests
    rng = np.random.RandomState(0)
    engine = InferenceEngine.build(
        "scanobject_classifier", seed=0, device="cuda",
        batch_buckets=(B,), point_buckets=(K,))
    batches = [requests(rng, B) for _ in range(N_REQUESTS)]
    probs = engine.classify(batches[0])          # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    wrappers = {"splat_max": ps.splat_max, "slice_gather": ps.slice_gather,
                "grid_conv3d": gc.grid_conv3d,
                "splat_max_bwd": ps.splat_max_bwd, "slice_bwd": ps.slice_bwd,
                "grid_conv3d_dw": gc.grid_conv3d_dw, "top2": pe.top2,
                "auction_window": pe.auction_window,
                "grid_conv2d": gc.grid_conv2d,
                "grid_conv2d_dw": gc.grid_conv2d_dw,
                "splat_max_winner": ps.splat_max_winner,
                "splat_route": ps.splat_route, "fused_block": fb.fused_block,
                **{name: getattr(bn_ops, name) for name in BN_WRAPPERS}}
    zero_launches(wrappers)
    call_ms = []   # classify returns numpy, so each call ends synchronised
    for clouds in batches:
        t0 = time.perf_counter()
        probs = engine.classify(clouds)
        call_ms.append((time.perf_counter() - t0) * 1e3)
    launches = read_launches(wrappers)
    check_launches(launches, PER_FORWARD, len(batches), "forwards")
    if probs.shape != (B, 15) or not np.isfinite(probs).all() or \
            not np.allclose(probs.sum(-1), 1.0, atol=1e-5):
        raise AssertionError(f"bad class probabilities {probs}")
    ms_fwd = float(np.median(call_ms))
    log(f"launches in {len(batches)} forwards: {launches}")

    # the forward itself never makes the host wait for the device
    pcd = torch.from_numpy(engine.pad_batch(batches[0])[0]).to("cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            engine.model(pcd)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log("forward: no host-device synchronisation")

    profiled = {}
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        profiled = profile_serving(engine, batches, smi, os.path.join(
            args.profile, "profile_forward.txt"))

    # 5. the same model and weights on the CPU, one cloud
    cloud = batches[0][:1]
    cpu_engine = InferenceEngine.build(
        "scanobject_classifier", seed=0, device="cpu",
        batch_buckets=(1,), point_buckets=(K,))
    (card_cls, card_mask, _), _, _, _ = engine.predict_padded(cloud)
    (cpu_cls, cpu_mask, _), _, _, _ = cpu_engine.predict_padded(cloud)
    for t in (card_cls, card_mask):
        if not torch.isfinite(t).all():
            raise AssertionError("non-finite model output on the card")
    parity(card_cls[:1].cpu(), cpu_cls,
           f"class logits {list(cpu_cls.shape)}")
    parity(card_mask[:1].cpu(), cpu_mask,
           f"point mask {list(cpu_mask.shape)}")

    # 5b. the serving path under each set of the JAX package's switches
    switched, all_launches = {}, {"serving": launches}
    for name in SETS:
        with switches(name):
            switched[name], all_launches[f"serving_{name}"] = \
                switched_serving(name, engine, cpu_engine, batches, wrappers,
                                 smi, args.profile)

    # 6. the second path: training steps at full width
    del engine, cpu_engine
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as exp_root:
        trained, train_launches = train_phase(wrappers, smi, args.profile,
                                              exp_root)
    log(f"training phase done in {time.perf_counter() - t0:.1f} s")

    # 7. the same gradients on the card and on the CPU
    trained.update(gradient_parity())
    all_launches["training"] = train_launches

    # 7b. training, the sync-free step and gradient parity under each set
    for name in SETS:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with switches(name), tempfile.TemporaryDirectory() as exp_root:
            result, all_launches[f"training_{name}"] = train_phase(
                wrappers, smi, args.profile, exp_root, steps=SWITCHED_STEPS,
                profile_name=f"profile_train_{name}.txt",
                per_step=set_counts(name, PER_STEP, True))
            result.update(gradient_parity())
        switched[name].update(result)
        log(f"{name} training phase done in {time.perf_counter() - t0:.1f} s")

    # 8. the third path: completion training, checkpoint, evaluation
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as exp_root:
        (completed, completion_launches, eval_launches, widths_per_step,
         eval_widths, completion_switched) = completion_phase(
             wrappers, smi, args.profile, exp_root)
    for name, got in completion_switched.items():
        all_launches[f"completion_{name}"] = got
    log(f"completion phase done in {time.perf_counter() - t0:.1f} s")
    for row in rows["top2"]:
        row["calls"] = widths_per_step.get((row["b"], row["w"]), 0.0)
        row["calls_per_evaluated_cloud"] = eval_widths.get(
            (row["b"], row["w"]), 0.0)
    if round(sum(r["calls"] for r in rows["top2"]) * COMPLETION_STEPS) \
            != completion_launches["top2"]:
        raise AssertionError("a bid search of the completion step ran at a "
                             f"width that was not checked: {widths_per_step}")
    if round(sum(r["calls_per_evaluated_cloud"] for r in rows["top2"])
             * EVAL_CLOUDS) != eval_launches["top2"]:
        raise AssertionError("a bid search of the evaluation ran at a width "
                             f"that was not checked: {eval_widths}")

    # 9. the window tail, a path of its own
    torch.cuda.empty_cache()
    windowed, window_launches = window_tail_phase(wrappers)
    # the window's times are of the one checked call (B=2), from a
    # mid-auction state with every lane bidding; the tail's own calls
    # mostly have a few lanes left and cost less (the 5-lane shape;
    # window_tail_kernel_device_ms has their sum)
    rows["auction_window"][0]["calls"] = 1.0
    completed.update(windowed)

    # 10. the completion path on the card and on the CPU
    completed.update(completion_parity())

    # 11. the fourth path: the S3DIS segmenter's training at B=8 x 4096,
    # validation, both sets, and the card against the CPU
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as exp_root:
        segmented, segmenter_launches = segmenter_phase(
            wrappers, smi, args.profile, exp_root)
    torch.cuda.empty_cache()
    segmented.update(segmenter_parity())
    all_launches.update(segmenter_launches)
    log(f"segmenter phase done in {time.perf_counter() - t0:.1f} s")

    # 12. the fifth path: the single-view reconstructor's training at B=4
    # x 128^2 images and 8192 points, both sets, the F-score protocol, and
    # the card against the CPU
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as exp_root:
        rebuilt, reconstructor_launches, rec_widths = reconstructor_phase(
            wrappers, smi, args.profile, exp_root)
    torch.cuda.empty_cache()
    rebuilt.update(reconstructor_parity())
    all_launches.update(reconstructor_launches)
    reconstructor_rows["top2"] = [
        {k: v for k, v in row.items() if k != "calls_per_evaluated_cloud"}
        | {"calls": rec_widths.get((row["b"], row["w"]), 0.0)}
        for row in rows["top2"] if (row["b"], row["m"]) == (REC_B, REC_K)]
    if round(sum(r["calls"] for r in reconstructor_rows["top2"])
             * REC_STEPS) != reconstructor_launches["reconstructor"]["top2"]:
        raise AssertionError("a bid search of the reconstructor step ran at "
                             f"a width that was not checked: {rec_widths}")
    log(f"reconstructor phase done in {time.perf_counter() - t0:.1f} s")

    # 13. the sixth path: the KPConv protocol's segmenter, training at B=6
    # x 8192 ragged spheres, a checkpoint, the vote validation, both sets,
    # and the card against the CPU
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as exp_root:
        kpconv, kpconv_launches = kpconv_phase(wrappers, smi, args.profile,
                                               exp_root)
    torch.cuda.empty_cache()
    kpconv.update(kpconv_parity())
    all_launches.update(kpconv_launches)
    log(f"KPConv phase done in {time.perf_counter() - t0:.1f} s")

    # 14. the scales classifier: training, both sets, serving from its
    # checkpoint and from a reference .t7, and the remat policies
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as exp_root:
        scaled, scales_launches, trainer, path = scales_phase(
            wrappers, smi, args.profile, exp_root)
        served, all_launches["scales_serving"] = serving_from_checkpoints(
            wrappers, trainer, path, exp_root)
        scaled.update(served)
        state = {k: v.detach().cpu().clone()
                 for k, v in trainer.model.state_dict().items()}
        del trainer
        torch.cuda.empty_cache()
        rematted, remat_launches = remat_phase(wrappers, state, exp_root)
    all_launches.update(scales_launches)
    all_launches.update(remat_launches)
    log(f"scales and remat phase done in {time.perf_counter() - t0:.1f} s")

    # 15. the bf16 operand policy on every model, the V2V and UNet blocks
    # and the vertex-list API
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as exp_root:
        halved, bf16_launches = bf16_phase(wrappers, smi, args.profile,
                                           exp_root)
    all_launches.update(bf16_launches)
    log(f"bf16, blocks and vertex-list phase done in "
        f"{time.perf_counter() - t0:.1f} s")

    # 16. the parallel layer: two ranks on the card over gloo, then the
    # one-process references (the children start after phase 1's build)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    paralleled, parallel_launches = parallel_phase(smi)
    log(f"parallel phase done in {time.perf_counter() - t0:.1f} s")

    # 17. the points axis: a data 2 x points 2 grid of ranks on the card
    # over gloo trains the classifier, the ragged KPConv segmenter and the
    # AdaIN inpainter, each against one process
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pointed, points_launches = points_phase(smi)
    all_launches.update(points_launches)
    log(f"points-axis phase done in {time.perf_counter() - t0:.1f} s")

    # 18. results
    log(f"{ms_fwd:.3f} ms/forward (median) at B={B} x {K} points, "
        f"{B * 1e3 / ms_fwd:.2f} clouds/s "
        f"({len(batches)} classify calls, host clock, synchronised)")
    print(json.dumps({"classify_ms_per_forward": ms_fwd,
                      "clouds_per_s": B * 1e3 / ms_fwd,
                      "classify_ms_mean": float(np.mean(call_ms)),
                      "classify_ms_p10": float(np.percentile(call_ms, 10)),
                      "classify_ms_p90": float(np.percentile(call_ms, 90)),
                      "classify_calls": len(call_ms),
                      "batch": B, "points": K, **profiled}), flush=True)
    log(f"{trained['train_ms_per_step']:.3f} ms/step (median) at B={B} x {K} "
        f"points, {trained['train_clouds_per_s']:.2f} clouds/s, peak memory "
        f"{trained['train_peak_memory_bytes'] / 2 ** 30:.2f} GiB "
        f"({TRAIN_STEPS} steps, host clock, synchronised)")
    print(json.dumps(trained), flush=True)
    log(f"{completed['completion_ms_per_step']:.3f} ms/step (median) for the "
        f"completion model at B={completed['batch']} x "
        f"{completed['partial_points']} -> {completed['points']} points, "
        f"{completed['completion_clouds_per_s']:.3f} clouds/s, peak memory "
        f"{completed['completion_peak_memory_bytes'] / 2 ** 30:.2f} GiB, EMD "
        f"{100 * completed['completion_emd_share_of_step']:.1f}% of a step; "
        f"evaluation {completed['eval_seconds_per_cloud']:.3f} s/cloud")
    print(json.dumps(completed), flush=True)
    for name, res in switched.items():
        log(f"{name}: {res['classify_ms_per_forward']:.3f} ms/forward "
            f"(default {ms_fwd:.3f}), {res['train_ms_per_step']:.3f} ms/step "
            f"(default {trained['train_ms_per_step']:.3f})")
    print(json.dumps({"switched": switched}), flush=True)
    log(f"{segmented['segmenter_ms_per_step']:.3f} ms/step (median) for the "
        f"S3DIS segmenter at B={B} x {SEG_K} points, "
        f"{segmented['segmenter_clouds_per_s']:.2f} clouds/s, peak memory "
        f"{segmented['segmenter_peak_memory_bytes'] / 2 ** 30:.2f} GiB; "
        f"Trainer.fit data_time {segmented['segmenter_fit_data_time']:.6f} "
        f"s, batch_time {segmented['segmenter_fit_batch_time']:.6f} s; "
        f"OA {segmented['segmenter_val_oa']:.4f}, mAcc "
        f"{segmented['segmenter_val_macc']:.4f}, mIoU "
        f"{segmented['segmenter_val_miou']:.4f}; card vs CPU cosine "
        f"{segmented['segmenter_parity_logits_cosine']:.7f} (logits), "
        f"{segmented['segmenter_parity_grad_cosine']:.7f} (gradients)")
    print(json.dumps({"segmenter": segmented, "segmenter_launches": {
        path: {k: v for k, v in counts.items() if v}
        for path, counts in segmenter_launches.items()}}), flush=True)
    log(f"{rebuilt['reconstructor_ms_per_step']:.3f} ms/step (median) for "
        f"the reconstructor at B={REC_B} x {REC_IM}^2 images, {REC_K} "
        f"points, {rebuilt['reconstructor_images_per_s']:.2f} images/s, peak "
        f"memory {rebuilt['reconstructor_peak_memory_bytes'] / 2 ** 30:.2f} "
        f"GiB, EMD {100 * rebuilt['reconstructor_emd_share_of_step']:.1f}% "
        f"of a step; F-score {rebuilt['eval_f_score']:.4f} at "
        f"{rebuilt['eval_seconds_per_image']:.3f} s/image; card vs CPU "
        f"cosine {rebuilt['reconstructor_parity_output_cosine']:.7f} "
        f"(output), {rebuilt['reconstructor_parity_grad_cosine']:.7f} "
        f"(gradients)")
    print(json.dumps({"reconstructor": rebuilt, "reconstructor_launches": {
        path: {k: v for k, v in counts.items() if v}
        for path, counts in reconstructor_launches.items()}}), flush=True)
    log(f"{kpconv['kpconv_ms_per_step']:.3f} ms/step (median) for the "
        f"KPConv segmenter at B={KP_B} x {KP_K} points (valid share "
        f"{kpconv['kpconv_valid_share_min']:.2f}-"
        f"{kpconv['kpconv_valid_share_max']:.2f}), peak memory "
        f"{kpconv['kpconv_peak_memory_bytes'] / 2 ** 30:.2f} GiB; "
        f"{KP_VOTES}-vote mIoU part {kpconv['kpconv_val_part_miou']:.4f}, "
        f"sub {kpconv['kpconv_val_sub_miou']:.4f}, full "
        f"{kpconv['kpconv_val_miou']:.4f} in "
        f"{kpconv['kpconv_val_seconds']:.2f} s; card vs CPU cosine "
        f"{kpconv['kpconv_parity_logits_cosine']:.7f} (logits), "
        f"{kpconv['kpconv_parity_grad_cosine']:.7f} (gradients)")
    print(json.dumps({"kpconv": kpconv, "kpconv_launches": {
        path: {k: v for k, v in counts.items() if v}
        for path, counts in kpconv_launches.items()}}), flush=True)
    log(f"{scaled['scales_ms_per_step']:.3f} ms/step (median) for the "
        f"scales classifier at B={B} x {K} points, served from its "
        f"checkpoint at {scaled['scales_serve_ms_per_forward']:.3f} "
        f"ms/forward; remat peak memory (GiB) and device busy ms a step: " +
        ", ".join(f"{k} {v['peak_memory_bytes'] / 2 ** 30:.2f}, "
                  f"{v['device_busy_ms_per_step']:.3f}"
                  for k, v in rematted.items()
                  if isinstance(v, dict) and "peak_memory_bytes" in v))
    print(json.dumps({"scales": scaled, "remat": rematted,
                      "scales_launches": {
                          path: {k: v for k, v in counts.items() if v}
                          for path, counts in {**scales_launches,
                                               **remat_launches}.items()}}),
          flush=True)
    log(f"bf16: {halved['bf16_classify_ms_per_forward']:.3f} ms/forward "
        f"(f32 {ms_fwd:.3f}), {halved['bf16_train_ms_per_step']:.3f} ms/step "
        f"(f32 {trained['train_ms_per_step']:.3f}), peak memory "
        f"{halved['bf16_train_peak_memory_bytes'] / 2 ** 30:.2f} GiB "
        f"(f32 {trained['train_peak_memory_bytes'] / 2 ** 30:.2f}); logits "
        f"vs f32 cosine {halved['bf16_vs_f32_logits_cosine']:.7f}, top-1 "
        f"{halved['bf16_vs_f32_top1_agreement']}/{B}, gradients "
        f"{halved['bf16_vs_f32_grad_cosine']:.7f}; reconstructor "
        f"{halved['bf16_reconstructor_ms_per_step']:.3f} ms/step (f32 "
        f"{rebuilt['reconstructor_ms_per_step']:.3f}), output vs f32 "
        f"{halved['bf16_reconstructor_output_vs_f32_cosine']:.7f}")
    print(json.dumps({"bf16": halved, "bf16_launches": {
        path: {k: v for k, v in counts.items() if v}
        for path, counts in bf16_launches.items()}}), flush=True)
    log("parallel: " + ", ".join(
        f"rank {t['rank']} {t['ms_per_step']:.3f} ms/step (device "
        f"{t['profiled_device_ms_per_step']:.3f})"
        for t in paralleled["training"])
        + f" at B={PAR_B} x {K} a rank over gloo; two ranks against one "
        f"process: loss {paralleled['parity']['loss_rel_diff']:.2e} "
        f"relative, gradient cosine "
        f"{paralleled['parity']['grad_cosine']:.7f}")
    print(json.dumps({"parallel": paralleled,
                      "parallel_launches": parallel_launches}), flush=True)
    log("points: " + ", ".join(
        f"rank {t['rank']} {t['ms_per_step']:.1f} ms/step (device "
        f"{t['profiled_device_ms']:.1f} ms, idle "
        f"{t['profiled_device_idle_share']:.3f})"
        for t in pointed["classifier"]["timing"])
        + f" for the classifier at B={B} x {K} on the data 2 x points 2 "
        "grid over gloo; against one process: " + ", ".join(
            f"{f} loss {pointed[f]['loss_rel_diff']:.2e} relative, "
            f"gradient cosine {pointed[f]['grad_cosine']:.7f}"
            for f in ("classifier", "segmenter", "inpainter")))
    print(json.dumps({"points": pointed}), flush=True)
    all_launches.update(completion=completion_launches,
                        evaluation=eval_launches, window=window_launches)
    normed["per_step"] = {
        "classifier": {k: train_launches[k] / TRAIN_STEPS
                       for k in BN_WRAPPERS}
        | {"bn.plain": trained["bn_plain_per_step"]},
        "kpconv": {k: all_launches["kpconv"][k] / KP_STEPS
                   for k in BN_WRAPPERS}
        | {"bn.plain": kpconv["kpconv_bn_plain_per_step"]}}
    normed["launches"] = {
        path: {k: counts.get(k, 0) for k in BN_WRAPPERS}
        for path, counts in all_launches.items()}
    print(json.dumps({"batch_norm": normed}), flush=True)
    print(json.dumps(kernel_line(rows, all_launches, completion_rows,
                                 segmenter_rows, reconstructor_rows,
                                 kpconv_rows)),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
