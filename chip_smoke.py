#!/usr/bin/env python3
"""On-card check of chap_tpu_torch, the PyTorch / CUDA port, on one NVIDIA
H100. Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device    nvidia-smi name and power limit; torch / CUDA / Triton versions
  2. build     one nvcc per CUDA source, started together: csrc/ccl.cu (K2,
               2D and 3D entry points) and csrc/sliding_window.cu (K3);
               registers and shared memory per kernel from -Xptxas=-v;
               meanwhile Triton compiles K1
  3. K1        the fused masked dice+CE Triton kernels, one region (R = 1)
               and two (R = 2, mix_loss's single call), against their plain
               version at the 2D path's [6, 4, 256, 256], a ragged
               [1, 4, 23, 29] and [2, 3, 23, 29] with labels outside
               [0, C) that match a padded class index, and the 3D step's
               [1, 2, 112, 112, 80] (R = 2) and [2, 2, 112, 112, 80]
               (R = 1) and a ragged [2, 3, 23, 29, 17], and the ACAL
               steps' labeled half [12, 4, 256, 256] (R = 1), the BraTS
               supervised step's [4, 2, 96, 96, 96] (R = 1) and the 2D zoo's
               single-decoder step's [24, 4, 256, 256] (R = 1): statistics, dice,
               ce and d/dlogits (also with one region's grads None) at
               rtol 2e-3, two calls bit-identical; then at bf16 logits (the
               configs as written) at [1, 2, 112, 112, 80] (R = 2),
               [2, 2, 112, 112, 80] (R = 1), [4, 2, 96, 96, 96] (R = 1) and
               the ACAL / ablation steps' [12, 4, 256, 256] (R = 1):
               losses at rtol 2e-3, the bf16 gradients within one bf16
               rounding of the plain version's; at the timed shapes
               torch.profiler counts the device kernels of 3 forward calls
               (1 or 2 kernels each) and of 3 backward calls (1 each);
               device ms per launch over 100 back-to-back calls, host us
               per call, and the median of single calls
  4. K2        the CUDA largest-CC kernel exactly equal to its plain version
               on adversarial maps (ragged, a serpentine through every tile,
               all foreground / background, one-pixel components, ties
               across tiles, C = 2 and 4) and on the 2D path's 24 maps of
               256^2 in three regimes (speckled, clean phantoms, percolating
               30% fill), timed as K1
  5. parity    one CHAP step on the card (kernels) and one on the CPU (plain
               versions) from the same weights and draws, feature_chns
               (4, 8, 16, 16, 32), batch 8 at 32^2, TF32 off: the 7 metrics
               at rtol 2e-3
  6. slice     the CHAP train step at configs/acdc_chap.yml's values
               (widths 16-256, batch 24 = 12 labeled + 12 unlabeled at
               256^2, fp32, random weights from a seed) on phantom batches:
               1 warm-up and 5 timed steps; launch counters are set to 0
               just before the timed steps and read just after (4 K1
               forward, 12 K1 backward, 1 K2 per step); then torch.profiler
               over 2 steps: device ms per step by kernel class
  7. eval      evaluate_volumes on the card (TF32 off) and on the CPU from
               the same weights, feature_chns (4, 8, 16, 16, 32) trained 30
               supervised steps on the card, 2 synthetic volumes of 6 x 64^2:
               >= 99.9% of predicted pixels agree, mean dice within 1e-3
  8. trainer   chap_tpu_torch.cli.train_2d.main in process at
               configs/acdc_chap.yml's values with --dataset synthetic
               (1,312-slice device pool, labeled_num 7): 20 CHAP steps with
               an eval every 10 on 2 val volumes of 10 x 256^2, --resume to
               30 (the step counter continues, the best slot is kept), then
               cli.test_2d on ``best`` (2 of its 8 phantom volumes); 5 supervised steps and 10 CHAP steps
               on the host loader path (data.device_input=false). Launch
               counters are set to 0 just before each run and read just
               after: 4 / 12 / 1 per CHAP step, 2 / 2 / 0 per supervised
               step. Prints the ``trainer`` line (pool build s, steps/s
               between evals per path beside phase 6's bare step, eval s,
               checkpoint ms, val dice, peak memory)
  9. K2 3D     the 26-connected entry point (8x16x16 tiles labelled in
               shared memory in hooking rounds, one global union per
               distinct pair of touching tile-local components, per-tile
               lists of their representatives) exactly equal to
               its plain version (max_pool3d propagation), and deterministic,
               on ragged maps (against the old 4x8x16 and the 8x16x16 tile
               in every axis), serpentines through every tile, chains and
               pairs joined only through tile corners or edges, two combs
               interleaved across a tile face that must stay two
               components, ties across tiles, all foreground / background,
               C = 2 and 3 (percolating too), labels outside [0, C); then on
               the 3D step's 4 maps of 112x112x80 in three regimes (clean
               ellipsoids, speckled, percolating 30% fill), timed as K1,
               with each sub-kernel's time
 10. K3        the sliding-window accumulate (4 z-voxels a thread, 16-byte
               loads where pz and a patch's z-start are multiples of 4)
               against its plain version over whole patch grids: the LA
               eval's batches of 16 patches of 112x112x80 in a 160x160x96
               volume, a ragged 16x16x8 patch in a 40x36x20 volume at C = 3
               (z-stride 6), a 16x16x8 patch at z-stride 4 (16-byte path)
               and a 16x16x10 patch at z-stride 3 (scalar path); score
               within 1e-6 relative, counts equal, label maps equal
               (near-ties within 1e-5 counted), two runs bit-identical; one
               LA batch timed. Then one output (no second logits, unet_3D's
               eval) at the BraTS eval's batch of 8 patches of 96^3 over a
               160x160x128 volume, held and timed the same way. Then K3's
               bf16-logits instantiation (a bf16 model's eval) over the LA
               grid (two outputs) and the BraTS batch (one output) against
               its plain version on the same bf16 logits: score within
               1e-5, counts equal, bit-identical on repeat; timed, its bound
               from the bf16 bytes
 11. parity 3D one 3D CHAP step on the card and on the CPU from the same
               weights and draws (nf 4, patch 32x32x16, batch 4, TF32 off):
               the 7 metrics at rtol 2e-3, launches 4 / 12 / 1 (K2 3D);
               then the sliding-window eval of a 48x48x24 volume on both
               from weights trained 20 supervised steps on the card:
               >= 99.9% of voxels agree, each map 1-99% foreground, K3
               once per patch batch. Both again in bf16 (configs/
               la_chap.yml's dtype): the card's step metrics on three
               batches, one vector, within 2x the CPU's own bf16-vs-float32
               gap of the CPU's bf16 ones, every K1 launch at bf16 logits;
               the card's bf16 label map agreeing
               with the CPU's bf16 one at least as well as the CPU's bf16
               and float32 maps agree, less 0.5 points
 12. slice 3D  the 3D CHAP step at configs/la_chap.yml's values (nf 16,
               widths 16-256, patch 112x112x80, batch 4 = 2 + 2, fp32 via
               model.dtype=float32, beside phase 21's bf16 step) on phantom
               patches, random weights from a
               seed: 1 warm-up and 3 timed steps, launches per step asserted
               (4 K1 forward, 12 K1 backward, 1 K2 3D), peak memory; then
               torch.profiler over 1 step by kernel class
 13. trainer3d chap_tpu_torch.cli.train_3d.main at configs/la_chap.yml's
               values as written (bf16 compute) on synthetic volumes (12 of
               128x128x88 in the device pool; the LA patch set back by
               override, since --dataset synthetic pins 64x64x48): 4 CHAP
               steps, --resume to 6 (the step counter continues), 2 cps and
               2 supervised steps (2 / 2 / 0 a step), 3 CHAP steps on the
               host loader, every K1 launch at bf16 logits; then
               test_all_case on the run's latest (float32) weights over 2
               synthetic volumes of 160x160x96 at stride 18/4, sw_batch 16,
               with the model in bf16 (K3's bf16 instantiation once per
               patch batch) and in float32 (its float32 one); cli.test_3d
               on the card.
               Prints the ``trainer3d`` line (steps/s, eval s per volume,
               checkpoint ms, peak bytes)
 14. parity    one ACAL joint step, decoder max-step and encoder min-step
     ACAL      on the card and on the CPU from the same weights and draws,
               with the mse and the softdice discrepancy, and one ablation
               step with the channel dropout and VAT on (feature_chns (4, 8,
               16, 16, 32), batch 8 at 32^2, TF32 off): metrics at rtol
               2e-3, the card's K1 launches 2 / 2 (joint, max), 0 / 0
               (min), 2 / 2 / 0 K2 (ablation)
 15. slice     the ACAL iteration at configs/acdc_share_acal.yml's values
     ACAL      (widths 16-256, batch 24 = 12 + 12 at 256^2, fp32, random
               weights from a seed) on phantom batches, the memory bank fed
               from the knowledge map: 1 warm-up and 5 timed iterations of
               joint step, bank feed and replay pair, each part timed to a
               sync, launches asserted per step, peak memory; torch.profiler
               over 1 iteration by kernel class; then the ablation step at
               configs/acdc_chap.yml's values, 1 warm-up and 3 timed steps
 16. trainer   chap_tpu_torch.cli.train_share_2d.main --cfg
     ACAL      configs/acdc_share_acal.yml --acal --dataset synthetic
               semi.acal_start_iter=10: 20 iterations, an eval of both
               decoders every 10 on 2 val volumes; 60 / 60 K1 launches (20
               joint steps and 10 replay pairs); the best_model1,
               best_model2 and latest slots. Prints the ``trainer_share``
               line (iterations/s, bank feed ms, eval s per decoder,
               checkpoint ms, peak memory)
 17. trainer   cli.train_2d.main --mode ablation at configs/acdc_chap.yml's
     ablation  values on synthetic data: 10 steps, 2 / 2 / 0 a step, one
               disagreement.csv row per log step; the ``trainer_ablation``
               line
 18. parity    every net_factory_3d key (unet_3D, attention_unet, voxresnet,
     zoo3d     vnet, vnet_ds, dualdecoder, resvnet, unet_3D_dv_semi) and
               VNet with groupnorm and instancenorm at a small width on the
               card and on the CPU from the same weights and dropout draws
               (48x32x16, TF32 off): every output in eval and train mode
               and the BatchNorm batch statistics at 5e-4 of the output's
               scale, and every output in bf16 within 2x the CPU's own
               bf16-vs-float32 gap of the CPU's bf16 output (float32
               statistics); one supervised step each of unet_3D, attention_unet,
               voxresnet and unet_3D_dv_semi, loss at rtol 2e-3, the card's
               K1 launches 1 / 1 (4 / 4 for unet_3D_dv_semi); vnet_ds and
               resvnet refused by the supervised step
 19. slice     the supervised step at configs/brats_supervised.yml's values
     zoo3d     (96^3, batch 4, 2 classes, fp32 by override beside phase
               21's bf16 step, random weights
               from a seed) for unet_3D (feature_scale 4: widths 16-256),
               attention_unet and unet_3D_dv_semi: 1 warm-up and 3 timed
               steps, launches asserted (1 / 1 a step, 4 / 4 for
               unet_3D_dv_semi), peak memory; torch.profiler over 1 unet_3D
               step by kernel class (``slice_zoo3d``, ``profile_zoo3d``)
 20. trainer   cli.train_3d.main --cfg configs/brats_supervised.yml --method
     zoo3d     supervised --dataset synthetic (the 96^3 patch set back by
               override, bf16 as written): 4 unet_3D steps, --resume to 6,
               1 / 1 K1 a step at bf16 logits; test_all_case on the latest
               weights over 2 synthetic volumes of 160x160x128 at stride
               64, sw_batch 8, with the model in bf16 and in float32, and
               cli.test_3d --model unet_3D, K3 launches equal to the patch
               batches in each. Prints the ``trainer_zoo3d`` line (steps/s,
               eval s per volume, checkpoint ms, peak bytes)
 21. slice     configs/la_chap.yml, configs/pancreas_chap.yml and
     bf16      configs/brats_supervised.yml as written, no override (bf16
               compute over float32 parameters): the CHAP step at
               112x112x80 and at 96^3 and the unet_3D supervised step at
               96^3, batch 4, bf16 phantom patches, random weights from a
               seed: 1 warm-up and 3 timed steps, launches asserted with
               every K1 launch at bf16 logits, peak memory; torch.profiler
               over 1 LA and 1 unet_3D step, which must show bf16
               convolution kernels (``slice_bf16``, ``profile_bf16_*``).
               Beside it the ACAL and ablation paths in bf16, which no
               shipped config asks for (model.dtype=bfloat16 by override):
               at the parity size (feature_chns (4, 8, 16, 16, 32), batch 8
               at 32^2, TF32 off) the ACAL iteration (joint, max, min) and
               the ablation step on three batches, the card's bf16 metrics
               against the CPU's bf16 ones within 2x the CPU's own
               bf16-vs-fp32 gap (``parity_bf16_share``); then at
               configs/acdc_share_acal.yml's and acdc_chap.yml's full width
               1 warm-up and 3 timed ACAL iterations (bank fed from the
               bf16 knowledge map, replay batch in bf16) and ablation
               steps, every K1 launch at bf16 logits, peak memory, one
               profiled iteration / step showing bf16 convolution kernels
               (``slice_bf16_share``, ``profile_bf16_acal``,
               ``profile_bf16_ablation``)
 23. data      (runs before the report) chap_tpu_torch/parallel/dist.py on
     parallel  the one card, W gloo ranks spawned on it (NCCL puts no two
               ranks on one device). First which ops of the models take a
               batch of 0 rows on the card (``zero_rows``; a rank may hold
               none) and K1 / K2 at 0 rows (1 / 0 forward / backward K1
               launches, 0 K2). Then three bare steps on each rank's rows
               of the global batches (TF32 off) against this process's
               steps on the whole batches from the same weights and draws,
               every gap (metrics, the parameter update, BN running
               statistics and GradSim scores as vectors) within rtol 2e-3
               or twice the largest of this process's own gaps over three
               control draws measured in the same call (PyTorch's native
               convolutions in place of cuDNN's, twice, and cuDNN's steps
               once more; CONTROL_CONVS), and each
               rank's launches asserted (K1's backward and K2 only where
               the rank holds rows): (b) W = 2 and (d) W = 4 at
               configs/acdc_chap.yml's values (batch 24 x 256^2, fp32),
               with each W = 2 rank's all-reduces replayed alone; (e) W = 2
               and W = 4 at configs/la_chap.yml's values in fp32 (batch 4
               x 112x112x80; at W = 4 ranks 0 and 2 hold no row), its
               metrics, update and running statistics held after the first
               step as well, its metrics not after the third
               (FIRST_STEP_KINDS says why), with two negative controls its
               bars must reject (W = 2 with rank 1's gradient left out of
               the all-reduce; every summed gradient scaled by 0.95 in this
               process), and W = 2 as written (bf16, timed;
               within twice this process's bf16-against-fp32 gap); (f) W =
               2 at brats_supervised.yml's
               unet_3D step (96^3, fp32); (g) test_all_case at W = 2 over
               two 160x160x96 volumes (stride 18 / 4, sw_batch 16) against
               W = 1's label maps (under 0.1% of voxels may differ; the
               count printed) with each rank's K3 launches; (a)
               cli.train_2d (6 steps) and (h) cli.train_3d at
               configs/la_chap.yml as written (4 steps) under ``torchrun
               --nproc_per_node 1`` (NCCL) against the same runs in this
               process: losses within rtol 2e-3; (c) cli.train_2d in the
               two gloo ranks: 6 steps and --resume to 9 (an eval every 3),
               one run dir written by rank 0, the records, val.csv and eval
               dice of W = 1's run (dice within 5e-3), 9 x (4 + 12 / 1) launches a
               rank, and the eval of its final weights at W = 2 equal to
               this process's eval of them, exactly; (i) the ACAL iteration
               (joint step, decoder max-step, encoder min-step) at
               configs/acdc_share_acal.yml's values (batch 24 = 12 + 12 at
               256^2, fp32) and (j) the ablation step at acdc_chap.yml's
               (dropout and VAT on), each half of the batch dealt on its
               own, three each at W = 2 and W = 4 against this process's
               from the same weights and draws with the same bars (the
               ACAL update of each parameter group apart, both schedule
               counts equal) and 4 + 4 / 2 + 2 K1 launches a rank a step;
               (k) cli.train_share_2d --acal in the two gloo ranks (8
               iterations, a bank feed each, replay from 4, one loader
               thread, TF32 off) against the same run in this process: one run dir
               written by rank 0, losses within rtol 2e-3, every replay
               draw's masks equal, both decoders' eval dice within 5e-3,
               26 / 26 K1 launches a rank; the same run with TF32 on (the
               card's default) at W = 2 against W = 1, within twice W =
               1's own gap between TF32 on and off; and the eval of phase
               16's trained weights (dice above 0) at W = 2 equal to W =
               1's, exactly; (l) cli.train_2d --mode
               ablation in the two ranks (4 steps): disagreement.csv's
               ratios within 5e-3 of W = 1's. The spawned ranks run their
               bare steps without a warm-up step (their step ms include
               first-call costs). Prints the ``dist`` line
               (the gloo figures are ranks sharing one card, not a
               multi-card speed)
 24. zoo2d     (runs before 23) every 2D net_factory key: (a) each but
               the dual decoder at a small width (the UNet family at
               feature_chns (4, 8, 16, 16, 32), PNet at 8 filters,
               SwinUNet at 64^2; ResUNet, ENet, EfficientUNet-b0 at their
               widths) on the card and on the CPU from the same weights
               and draws (TF32 off): every output in eval and train mode
               and the BN batch statistics at 5e-4 of the output's scale,
               and the logit-ensemble, ds, adv and polyp predictors (label
               maps within 0.1% of pixels, polyp Dice within 1e-3); (b) at
               configs/acdc_chap.yml's width (24 x 256^2, swinunet at
               224^2, fp32, TF32 on, random weights from a seed) 1 warm-up
               and 3 timed single-decoder supervised steps (chap_tpu's dual=False) of
               unet, resunet, swinunet, enet, pnet and efficient_unet,
               1 / 1 K1 a step asserted, step ms and peak memory; a train
               and an eval forward of unetp, unet_cct, unet_urpc and
               dual_student, which that step refuses; (c) cli.test_2d (2 of
               its 8 phantom volumes) on a
               snapshot of every key written from (b)'s weights, over the
               ensemble modes for the keys of several outputs, and
               cli.train_2d refusing --model unet in supervised mode before
               a run dir (``slice_zoo2d``, ``test_zoo2d``, ``zoo2d`` lines)
 25. library   (runs after 24, before 23) the models no factory key
               reaches and the .pth import: (a) every model of
               models/{blocks, resnet, discriminator, extras, gan_legacy,
               transformer_decoder}.py and EffiUNet-b3 at a small width on
               the card and on the CPU from the same weights and dropout
               draws (TF32 off): every output in eval and train mode and
               the BN batch statistics at 5e-4 of the output's scale; the
               parameter gradients of GRL (a UNet's features reversed into
               NetD), KMax, the GAN pair (ResnetGenerator under
               NLayerDiscriminator) and TinyUNet3D at rtol 2e-3 as vectors;
               mask_selection with the same uniforms, equal
               (``parity_library``); (b) at full width (TF32 on, random
               weights from a seed) one warm-up and three timed forward +
               backward calls each: resnet50 and resnet50_16s on 24 x 3 x
               256^2, the three transformer decoders at their default
               widths on resnet50's pyramid of that batch, ResnetGenerator,
               UnetGenerator and NLayerDiscriminator at 4 x 3 x 256^2,
               FCDiscriminator on 24 x 4 x 256^2 with NetD on its map,
               UNetTsne on 24 x 1 x 256^2, TinyUNet3D on 4 x 1 x 96^3,
               EffiUNet-b3, and utils.timing.benchmark_fwd_bwd on the ACDC
               DualDecoder: ms and peak GB (``slice_library``); (c)
               reference-named .pth files of seeded weights (``module.``
               prefixes in a ``{"state_dict": ...}`` wrapper: the ACDC
               DualDecoder, LA's VNet and DualDecoder3d at n_filters_3d
               16, swinunet) through cli.convert_torch, then cli.test_2d
               (2 phantom volumes) or cli.test_3d --nms 1 on the card, the
               converted snapshot's label maps against the same weights
               loaded straight into the factory's model within 0.1%
               (``convert_library``; its K3 launches go to the K2 3D / K3
               rows as ``library_test3d_launches``); the ``library`` line
 22. report    the kernels line (JSON; K1 and K3 at bf16 logits have rows
               of their own; the K1 / K2 / K3 rows carry phase 23's
               launches on each rank; K1 at bf16 logits at the ACAL shape
               has rows of its own, and K1 at the 2D zoo's step shape
               [24, 4, 256, 256] (``K1_{fwd,bwd}_zoo2d``: launches over
               phase 24's timed steps); the R = 1 rows carry
               ``caller_bound_ms``, the bound for what their supervised
               callers need: the logits and uint8 labels, no mask; a
               count no run measured is null), the ``phase_s`` line (each
               phase's seconds), the card line, and the last line
               {"ok": true, "device": {...}}

The 2D and 3D phases keep the counts and depths they had before the ACAL
path and the 3D zoo were added; the 3D trainer phases (13, 20) run their
configs as written, in bf16, and the float32 steps of phases 12 and 19
stand beside phase 21's bf16 ones.

Two diagnostics run only by hand, each from the repository root:

    python3 -c "import chip_smoke as c; c.phase_slice()"
    python3 -c "import chip_smoke as c; c.loop_breakdown('by_hand')"

the first is phase 6 alone (``c.phase_slice_3d()`` is phase 12 alone); the
second prints a ``loop`` line, the ms per
full-width step on phantom and on device-pool batches with a sync after
every step and after 5, and the batch function's own device ms. A third,

    python3 -c "import chip_smoke as c; c.k2_3d_variants()"

rebuilds csrc/ccl.cu with the alternatives to its 3D design (other tiles,
1024 threads a tile, no path halving, pruned hooks) and times each against
the kept design (``k2_3d_variant`` lines).
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import functools
import inspect
import json
import math
import multiprocessing as mp
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

from chap_tpu_torch.cli import convert_torch as cli_convert
from chap_tpu_torch.cli import test_2d as cli_test
from chap_tpu_torch.cli import test_3d as cli_test3d
from chap_tpu_torch.cli import train_2d as cli_train
from chap_tpu_torch.cli import train_3d as cli_train3d
from chap_tpu_torch.cli import train_share_2d as cli_share
from chap_tpu_torch.config import acdc_chap_config, load_config
from chap_tpu_torch.data.datasets import (SyntheticSliceDataset, SyntheticVolumeDataset,
                                          build_datasets, patients_to_slices,
                                          phantom_batch)
from chap_tpu_torch.data.device_data import build_device_batch_fn, build_device_pool
from chap_tpu_torch.data.pipeline import to_device
from chap_tpu_torch.eval import sliding_window as sw
from chap_tpu_torch.eval.eval2d import (evaluate_volumes, make_adv_predictor,
                                        make_ds_predictor, make_predictor,
                                        predict_volume, test_single_adv_polyp,
                                        test_single_volume_polyp)
from chap_tpu_torch.models import resnet
from chap_tpu_torch.models.attention3d import AttentionUNet3D
from chap_tpu_torch.models.blocks import Conv2dReLU, SCSEModule, SEBlock3d, SqEx
from chap_tpu_torch.models.discriminator import FC3DDiscriminator, FCDiscriminator
from chap_tpu_torch.models.dsnet import DSNet
from chap_tpu_torch.models.efficientunet import EffiUNet
from chap_tpu_torch.models.enet import ENet
from chap_tpu_torch.models.extras import NetD, TinyUNet3D, UNet2dBCP, UNetTsne
from chap_tpu_torch.models.factory import net_factory, net_factory_3d
from chap_tpu_torch.models.gan_legacy import (NLayerDiscriminator, ResnetGenerator,
                                              UnetGenerator, gan_loss)
from chap_tpu_torch.models.grl import gradient_reverse
from chap_tpu_torch.models.layers import FlaxBatchNorm, set_compute_dtype
from chap_tpu_torch.models.perturb import mask_selection
from chap_tpu_torch.models.pnet import PNet2D
from chap_tpu_torch.models.resunet2d import ResUNet2d
from chap_tpu_torch.models.resvnet import ResVNet
from chap_tpu_torch.models.swin_unet import SwinUNet
from chap_tpu_torch.models.transformer_decoder import (KMaxTransformerDecoder,
                                                       MaskTransformerDecoder,
                                                       MaskTransformerDecoderV1)
from chap_tpu_torch.models.unet2d import UNet, UNetCCT, UNetPlus, UNetURPC
from chap_tpu_torch.models.unet3d import UNet3D
from chap_tpu_torch.models.unet3d_dv import UNet3DDvSemi
from chap_tpu_torch.models.vnet3d import DualDecoder3d, VNet, VNetDS
from chap_tpu_torch.models.voxresnet import VoxResNet
from chap_tpu_torch.ops import cuda_build, fused_losses
from chap_tpu_torch.parallel import dist
from chap_tpu_torch.semi import nms
from chap_tpu_torch.semi.gradsim import VNET_LEVEL_PATHS
from chap_tpu_torch.semi.memory_bank import ImageMemoryBank
from chap_tpu_torch.train.state import create_train_state, make_optimizer
from chap_tpu_torch.train.step_chap import (build_chap_train_step, draw_step_uniforms,
                                            level_channels)
from chap_tpu_torch.train.step_ablation import (build_ablation_train_step,
                                                draw_ablation_uniforms)
from chap_tpu_torch.train.step_share import (build_acal_steps, build_share_joint_step,
                                             create_share_state)
from chap_tpu_torch.train.step_supervised import (build_supervised_train_step,
                                                  draw_supervised_uniforms)
from chap_tpu_torch.train.trainer_3d import build_supervised3d_train_step
from chap_tpu_torch.utils.checkpoint import CheckpointManager
from chap_tpu_torch.utils.timing import benchmark_fwd_bwd

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12        # outside the tensor cores
RTOL = 2e-3
# per CHAP step: 4 mix_loss calls, each one K1 forward over both regions and
# one K1 backward in each of grads_l, grads_u and total.backward(); one K2
# (the 2D kernel for slices, the 3D one for patches); no K3 (eval only)
LAUNCHES_PER_STEP = {"K1_fwd": 4, "K1_bwd": 12, "K2_ccl": 1, "K2_ccl3d": 0,
                     "K3_sw": 0}
LAUNCHES_PER_STEP_3D = {**LAUNCHES_PER_STEP, "K2_ccl": 0, "K2_ccl3d": 1}
# per supervised (or 3D cps) step: dice_ce_supervised on each decoder
# output, K1 with R = 1
SUPERVISED_LAUNCHES_PER_STEP = {"K1_fwd": 2, "K1_bwd": 2, "K2_ccl": 0,
                                "K2_ccl3d": 0, "K3_sw": 0}
# the trainer phase: configs/acdc_chap.yml through the CLI, synthetic data
RUNS_DIR = os.path.join("build", "chip_smoke_runs")
TRAINER_FLAGS = ["--cfg", "configs/acdc_chap.yml", "--dataset", "synthetic",
                 "--adv_noise", "--dropout", "--labeled_num", "7",
                 "--device", "cuda"]
TRAINER_OVERRIDES = ["eval.eval_every=10", "data.synthetic_val_volumes=2",
                     "run.log_every=10", f"run.snapshot_root={RUNS_DIR}"]
# cli.test_2d's synthetic set cut to 2 of its 8 phantom volumes (phases 8,
# 24 and 25; the host's surface metrics take most of a run)
TWO_VOLUMES = functools.partial(SyntheticVolumeDataset, length=2)
METRICS = ("loss", "bcp_loss", "loss_l", "loss_u", "fp_loss", "vat_loss",
           "consistency_weight")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"FAILED: {what}")


def launch_counts() -> dict:
    return {"K1_fwd": fused_losses.stats_kernel.launches,
            "K1_bwd": fused_losses.stats_grad_kernel.launches,
            "K2_ccl": nms.ccl_kernel.launches,
            "K2_ccl3d": nms.ccl3d_kernel.launches,
            "K3_sw": sw.sw_accumulate_kernel.launches}


def bf16_launch_counts() -> dict:
    """The launches at bf16 logits of the kernels that take them (K1's
    forward and backward, K3), a part of launch_counts()' totals."""
    return {"K1_fwd": fused_losses.stats_kernel.launches_bf16,
            "K1_bwd": fused_losses.stats_grad_kernel.launches_bf16,
            "K3_sw": sw.sw_accumulate_kernel.launches_bf16}


def zero_launch_counts() -> None:
    for fn in (fused_losses.stats_kernel, fused_losses.stats_grad_kernel,
               sw.sw_accumulate_kernel):
        fn.launches = fn.launches_bf16 = 0
    nms.ccl_kernel.launches = 0
    nms.ccl3d_kernel.launches = 0


def check_all_bf16(what: str) -> dict:
    """Every K1 and K3 launch since the counters were set to 0 took bf16
    logits (a bf16 model's path); returns the bf16 counts."""
    total, bf16 = launch_counts(), bf16_launch_counts()
    check(all(bf16[k] == total[k] for k in bf16),
          f"{what}: every K1 / K3 launch at bf16 logits: {bf16} of {total}")
    return bf16


def single_call_ms(fn, n: int = 20, warmup: int = 3) -> float:
    """Median of n single calls, each between two CUDA events (with an empty
    queue it is mostly the host's enqueue)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, n: int = 100, warmup: int = 5) -> float:
    """Device time per call: one pair of CUDA events around n back-to-back
    calls, divided by n."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def host_us(fn, n: int = 100, warmup: int = 5) -> float:
    """Host time per call: a host clock around n calls with no
    synchronisation inside, divided by n."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / n * 1e6


def device_kernels(fn, n: int = 1) -> list:
    """(name, us) of each device kernel torch.profiler sees while fn runs n
    times, from Kineto's raw events: ``prof.events()`` drops a device
    kernel it cannot tie to a CPU op, and lost one of three K1 backward
    kernels in each of three sessions in a row on an H100 (the backward
    launches from autograd's device thread)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return [(ev.name(), ev.duration_ns() / 1e3)
            for ev in prof.profiler.kineto_results.events()
            if ev.device_type() == torch.autograd.DeviceType.CUDA]


def kernel_counts(fn, n: int) -> dict:
    """name -> number of device kernels torch.profiler sees while fn runs n
    times, where fn launches each of its kernels at every call. A session
    that saw no device kernel, or a kernel fewer than n times and none more,
    has lost events and is taken again, up to three sessions:
    torch.profiler has returned an empty session for a short call, and
    once 2 launches of a kernel over 3 calls of K1's Function. A kernel
    seen more than n times ends the retries, and a kernel of another name
    shows in every session."""
    for _ in range(3):
        counts = {}
        for name, _ in device_kernels(fn, n):
            counts[name] = counts.get(name, 0) + 1
        if counts and (min(counts.values()) >= n or max(counts.values()) > n):
            break
    return counts


def short_name(kernel: str) -> str:
    """A device kernel's name without its namespace, return type and
    arguments: ``sw_accumulate<2>``, ``ccl3_local``."""
    return re.sub(r"^(void )?\(anonymous namespace\)::|\(.*$", "", kernel)


def timings(fn, n: int = 100) -> dict:
    """device_ms: events around n back-to-back calls (bounded below by the
    host's enqueue when that is slower); kernel_ms: the kernels' own device
    time per call, from torch.profiler over 20 calls; host_us; and the
    median of single calls between two events. A profiler session that saw
    no device kernel is taken once more (torch.profiler has returned empty
    sessions late in the process); if the second is empty too, kernel_ms
    is None: not measured."""
    for _ in range(2):
        by_kernel = {}
        for name, us in device_kernels(fn, 20):
            name = short_name(name)
            by_kernel[name] = by_kernel.get(name, 0.0) + us / 20 / 1e3
        if by_kernel:
            break
    return {"device_ms": device_ms(fn, n), "host_us": host_us(fn, n),
            "kernel_ms": sum(by_kernel.values()) if by_kernel else None,
            "kernel_ms_by_name": by_kernel, "single_call_ms": single_call_ms(fn)}


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_summary(log: str) -> list:
    """(kernel, resource line) for each entry function in nvcc's
    -Xptxas=-v output: registers, shared memory, spills."""
    out, name = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            short = re.search(r"\d+((?:ccl3?|sw)_[a-z_]+)(ILi(\d+)E)?",
                              entry.group(1))
            name = entry.group(1) if not short else (
                short.group(1) + (f"<{short.group(3)}>" if short.group(3) else ""))
        elif name and "Used" in line:
            out.append((name, line.split(":", 1)[-1].strip()))
            name = None
    return out


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def set_tf32(cudnn: bool, matmul: bool = False) -> None:
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = matmul


def tf32_settings() -> str:
    return (f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
            f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")


# ---------------------------------------------------------------------------
# phase 3: K1
# ---------------------------------------------------------------------------

def k1_inputs(shape, seed, label_values=None, dtype=torch.float32):
    """Logits in ``dtype``, two label maps with values in [0, label_values)
    (default C; larger values are labels outside [0, C), which count
    nowhere) and a {0, 1} mask."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, c, *spatial = shape
    hi = label_values or c
    logits = (torch.randn(shape, generator=gen, device="cuda") * 2).to(dtype)
    labels = torch.randint(0, hi, (b, *spatial), generator=gen, device="cuda",
                           dtype=torch.int32)
    labels2 = torch.randint(0, hi, (b, *spatial), generator=gen, device="cuda",
                            dtype=torch.int32)
    mask = (torch.rand((b, *spatial), generator=gen, device="cuda") < 0.6).float()
    return logits, labels, labels2, mask


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp_min(1e-30))


def _k1_grads(x, lab, mask, lab2, weights, used):
    """d/dlogits of sum_i weights[i] * loss_i over the losses in ``used``,
    through the card's Function (``kernel``) and the plain version."""
    out = {}
    for name, fn in (("kernel", fused_losses.region_dice_ce),
                     ("plain", lambda *a: tuple(fused_losses.compose_plain(
                         fused_losses.region_stats_plain(*a), 1e-10,
                         1e-16).view(-1).unbind()))):
        xg = x.clone().requires_grad_(True)
        vals = fn(xg, lab, mask, lab2)
        sum(weights[i] * vals[i] for i in used).backward()
        out[name] = (torch.stack([v.detach() for v in vals]), xg.grad)
    return out


def bf16_rounding_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| in units of one bf16 rounding of the larger
    of the two (2^-7 of it), with 1e-5 of want's peak as the floor: <= 1
    when got and want differ by no more than bf16 rounding."""
    g, w = got.double(), want.double()
    unit = 2.0 ** -7 * torch.maximum(g.abs(), w.abs()) + 1e-5 * w.abs().max()
    return float(((g - w).abs() / unit).max())


def phase_k1(shape, seed, regions, timed=False, label_values=None,
             dtype=torch.float32):
    """K1 with R = ``regions`` against its plain version: statistics, losses,
    the Function's gradient and the backward kernel alone; bit-identical on
    repeat. At the main path's shape it also counts the device kernels of
    one forward and one backward and times kernel and plain version. At
    bf16 logits (a bf16 model's) the losses are held at rtol 2e-3 as in
    float32 (both upcast the logits), and the gradients, bf16 in both,
    within one bf16 rounding of the plain version's."""
    logits, labels, labels2, mask = k1_inputs(shape, seed, label_values, dtype)
    lab2 = labels2 if regions == 2 else None
    c = shape[1]
    bf16 = dtype == torch.bfloat16
    tag = (f"{shape} R={regions} labels<{label_values or c}"
           + (" bf16" if bf16 else ""))
    # forward: statistics and losses
    losses, stats = fused_losses.stats_kernel(logits, labels, mask, lab2)
    losses2, stats2 = fused_losses.stats_kernel(logits, labels, mask, lab2)
    check(torch.equal(losses, losses2) and torch.equal(stats, stats2),
          f"K1 forward deterministic at {tag}")
    p_stats = fused_losses.region_stats_plain(logits, labels, mask, lab2)
    p_losses = fused_losses.compose_plain(p_stats, 1e-10, 1e-16)
    k_stats = stats[:, :, :c]
    check(torch.allclose(k_stats, p_stats, rtol=RTOL, atol=1e-3),
          f"K1 I/Z/Y/CE at {tag}")
    check(torch.allclose(losses, p_losses, rtol=RTOL, atol=0),
          f"K1 dice/ce at {tag}: {losses.tolist()} vs {p_losses.tolist()}")
    fwd_err = float((k_stats - p_stats).abs().max())
    # the Function's gradient, every loss used and one region unused
    weights = (0.5, 0.35, 0.25, 0.6)
    patterns = [(0, 1)] if regions == 1 else [(0, 1, 2, 3), (2, 3)]
    g_err = bwd_abs = 0.0
    for used in patterns:
        g = _k1_grads(logits, labels, mask, lab2, weights, used)
        g2 = _k1_grads(logits, labels, mask, lab2, weights, used)
        check(torch.equal(g["kernel"][1], g2["kernel"][1]),
              f"K1 backward deterministic at {tag}")
        check(g["kernel"][1].dtype == dtype, f"K1 gradient dtype at {tag}")
        err = rel_err(g["kernel"][1], g["plain"][1])
        if bf16:    # both round a float32 gradient to bf16 once
            units = bf16_rounding_err(g["kernel"][1], g["plain"][1])
            check(units <= 1.0, f"K1 bf16 gradient within bf16 rounding of the "
                                f"plain one at {tag} {used}: {units} units")
        else:
            check(err <= RTOL, f"K1 gradient at {tag} {used}: "
                               f"max|diff|/max|plain| = {err}")
        g_err = max(g_err, err)
        bwd_abs = max(bwd_abs, float((g["kernel"][1] - g["plain"][1]).abs().max()))
    # the backward kernel alone against the plain analytic gradient
    grads = [torch.tensor(w, device="cuda") for w in weights[:2 * regions]]
    k_grad = fused_losses.stats_grad_kernel(logits, labels, mask, stats, grads,
                                            lab2)
    p_grad = fused_losses.stats_grad_plain(
        logits, labels, mask, stats, torch.stack(grads).view(regions, 2),
        1e-10, 1e-16, lab2)
    if bf16:
        check(bf16_rounding_err(k_grad, p_grad) <= 1.0,
              f"K1 bf16 backward kernel within bf16 rounding at {tag}")
    else:
        check(rel_err(k_grad, p_grad) <= RTOL, f"K1 backward kernel at {tag}")
    res = {"shape": list(shape), "regions": regions, "dtype": str(dtype),
           "losses": losses.view(-1).tolist(), "fwd_max_abs_err": fwd_err,
           "bwd_max_abs_err": bwd_abs, "bwd_rel_err": g_err}
    if timed:
        # device kernels of 3 Function calls: each forward launches 1 or 2
        # kernels, each backward 1
        x = logits.clone().requires_grad_(True)
        fwd_k = kernel_counts(
            lambda: fused_losses.region_dice_ce(x, labels, mask, lab2), 3)
        vals = fused_losses.region_dice_ce(x, labels, mask, lab2)
        bwd_k = kernel_counts(
            lambda: torch.autograd.grad(vals, [x], grads, retain_graph=True), 3)
        check(1 <= len(fwd_k) <= 2 and set(fwd_k.values()) == {3}
              and len(bwd_k) == 1 and set(bwd_k.values()) == {3},
              f"K1 Function's device kernels over 3 calls at {tag}: forward "
              f"{fwd_k}, backward {bwd_k}")
        xg = logits.clone().requires_grad_(True)
        p_vals = fused_losses.compose_plain(fused_losses.region_stats_plain(
            xg, labels, mask, lab2), 1e-10, 1e-16).view(-1)
        g_vec = torch.stack(grads)
        n = logits.numel() // c
        io = logits.numel() * logits.element_size() + n * 4 * (1 + regions)
        res.update({
            "fwd_device_kernels": fwd_k, "bwd_device_kernels": bwd_k,
            "fwd": timings(lambda: fused_losses.stats_kernel(
                logits, labels, mask, lab2)),
            "bwd": timings(lambda: fused_losses.stats_grad_kernel(
                logits, labels, mask, stats, grads, lab2)),
            "fwd_plain_ms": device_ms(lambda: fused_losses.compose_plain(
                fused_losses.region_stats_plain(logits, labels, mask, lab2),
                1e-10, 1e-16), n=20),
            "bwd_plain_ms": device_ms(lambda: torch.autograd.grad(
                p_vals, [xg], g_vec, retain_graph=True), n=20),
            # softmax ~10 flops a class, ~8 more a class per region
            "fwd_bound": bound_ms(io, n * c * (10 + 8 * regions)),
            "bwd_bound": bound_ms(io + logits.numel() * logits.element_size(),
                                  n * c * (10 + 12 * regions))})
        if regions == 1:
            # the supervised callers (dice_ce_supervised) pass an all-ones
            # mask and hold their labels as uint8: what the function needs
            # there is the logits and one byte a pixel
            need = logits.numel() * logits.element_size() + n
            res.update({
                "fwd_caller_bound": bound_ms(need, n * c * 18),
                "bwd_caller_bound": bound_ms(
                    need + logits.numel() * logits.element_size(), n * c * 22)})
    print("K1", json.dumps(res), flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 4: K2
# ---------------------------------------------------------------------------

def k2_regime(name: str, rs: np.random.RandomState, b=24, hw=256, c=4):
    if name == "clean":
        return phantom_batch(rs, b, hw, c)[1]
    if name == "speckled":
        lab = phantom_batch(rs, b, hw, c)[1]
        noise = rs.rand(b, hw, hw) < 0.08
        lab[noise] = rs.randint(0, c, int(noise.sum()))
        return lab
    u = rs.rand(b, hw, hw)
    return np.select([u < 0.3, u < 0.6, u < 0.9], [1, 2, 3], 0).astype(np.int32)


def serpentine(h, w, stride=3):
    """One component that snakes through every row band: rows 0, stride,
    ... are full and joined alternately at the right and left ends, so it
    crosses every 32x32 tile of K2."""
    m = np.zeros((h, w), np.int32)
    rows = list(range(0, h, stride))
    for i, y in enumerate(rows):
        m[y] = 1
        if i + 1 < len(rows):
            x = w - 1 if i % 2 == 0 else 0
            m[y:rows[i + 1] + 1, x] = 1
    return m


def k2_adversarial(rs: np.random.RandomState) -> dict:
    """name -> (segmentation [B, H, W] int32, num_classes)."""
    u = rs.rand(2, 257, 100)
    one = np.zeros((2, 64, 64), np.int32)
    one[:, ::2, ::2] = 1
    ties = np.zeros((1, 96, 96), np.int32)
    for y, x in [(5, 5), (40, 70), (70, 10), (30, 31)]:
        ties[0, y:y + 3, x:x + 3] = 1          # equal squares in four tiles
    ties[0, 80:82, 80:82] = 2
    ties[0, 10:12, 60:62] = 2
    snakes = np.stack([serpentine(256, 256), serpentine(256, 256, 5) * 2,
                       serpentine(256, 256, 2) * 3])
    u4 = rs.rand(4, 64, 64)
    return {
        "ragged_3x23x29": (rs.randint(0, 4, (3, 23, 29)), 4),
        "ragged_2x257x100": (np.select([u < 0.2, u < 0.4, u < 0.55], [1, 2, 3], 0), 4),
        "serpentine_3x256x256": (snakes, 4),
        "serpentine_ragged_70x90": (serpentine(70, 90)[None] * 2, 4),
        "all_foreground": (np.full((2, 64, 64), 3), 4),
        "all_background": (np.zeros((2, 64, 64)), 4),
        "one_pixel_components": (one, 2),
        "ties_across_tiles": (ties, 4),
        "c2_percolating": ((rs.rand(3, 64, 64) < 0.45), 2),
        "c4_percolating": (np.select([u4 < 0.3, u4 < 0.6, u4 < 0.9], [1, 2, 3], 0), 4),
        "labels_out_of_range": (rs.randint(-1, 6, (2, 40, 40)), 4),
    }


def phase_k2():
    out = {}
    for name, (seg, c) in k2_adversarial(np.random.RandomState(7)).items():
        seg = torch.from_numpy(np.asarray(seg, np.int32)).cuda()
        k = nms.ccl_kernel(seg, c)
        torch.cuda.synchronize()
        check(torch.equal(k, nms.largest_cc_batch_plain(seg, c)),
              f"K2 equals its plain version ({name})")
    print("K2 adversarial cases equal to the plain version:",
          ", ".join(k2_adversarial(np.random.RandomState(7))), flush=True)
    for i, regime in enumerate(("speckled", "clean", "percolating")):
        seg = torch.from_numpy(k2_regime(regime, np.random.RandomState(100 + i))
                               ).to(device="cuda", dtype=torch.int32)
        k = nms.ccl_kernel(seg, 4)
        p = nms.largest_cc_batch_plain(seg, 4)
        check(torch.equal(k, p), f"K2 equals its plain version ({regime})")
        check(torch.equal(k, nms.ccl_kernel(seg, 4)), f"K2 deterministic ({regime})")
        # one int32 map read, one written
        res = {"maps": seg.shape[0], "kept_pixels": int((k > 0).sum()),
               "bound": bound_ms(2 * seg.numel() * seg.element_size(), 0),
               "max_abs_err": float((k - p).abs().max()),
               **timings(lambda: nms.ccl_kernel(seg, 4), n=50),
               "plain_ms": device_ms(lambda: nms.largest_cc_batch_plain(seg, 4),
                                     n=3, warmup=1)}
        print("K2", regime, json.dumps(res), flush=True)
        out[regime] = res
    return out


# ---------------------------------------------------------------------------
# phases 5 and 6: the train step
# ---------------------------------------------------------------------------

def make_step(cfg, device, seed=0, state_dict=None):
    torch.manual_seed(seed)
    model = net_factory(cfg.model.name, cfg.data.in_chns, cfg.data.num_classes,
                        cfg.model, device=device)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    opt = make_optimizer(model, cfg.optim.base_lr, cfg.optim.momentum,
                         cfg.optim.weight_decay)
    state = create_train_state(model, opt, cfg.model.feature_chns)
    return state, build_chap_train_step(model, opt, cfg, device=device)


def phantom_inputs(cfg, seed, device):
    images, labels = phantom_batch(np.random.RandomState(seed),
                                   cfg.data.batch_size, cfg.data.image_size[0],
                                   cfg.data.num_classes)
    return {"image": torch.from_numpy(images).to(device),
            "label": torch.from_numpy(labels).to(device)}


def to_cuda(obj):
    """Every tensor of a nest of dicts and lists, copied to the card."""
    if isinstance(obj, torch.Tensor):
        return obj.cuda()
    if isinstance(obj, dict):
        return {k: to_cuda(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [to_cuda(v) for v in obj]
    return obj


def phase_parity():
    set_tf32(False)
    cfg = acdc_chap_config()
    cfg.model.feature_chns = (4, 8, 16, 16, 32)
    cfg.data.batch_size, cfg.data.labeled_bs = 8, 4
    cfg.data.image_size = (32, 32)
    cpu_state, cpu_step = make_step(cfg, "cpu")
    cuda_state, cuda_step = make_step(cfg, "cuda",
                                      state_dict=cpu_state.model.state_dict())
    batch = phantom_inputs(cfg, 1, "cpu")
    draws = draw_step_uniforms(cfg, batch["image"].shape,
                               torch.Generator().manual_seed(2), "cpu")
    before = launch_counts()
    on_cpu = cpu_step(cpu_state, batch, draws=draws).metrics
    on_card = cuda_step(cuda_state, to_cuda(batch), draws=to_cuda(draws)).metrics
    after = launch_counts()
    ran = {k: after[k] - before[k] for k in after}
    check(ran == LAUNCHES_PER_STEP,
          f"the card's step went through K1 and K2: {ran} launches, "
          f"expected {LAUNCHES_PER_STEP}")
    res = {}
    for k in METRICS:
        a, b = float(on_card[k]), float(on_cpu[k])
        check(math.isclose(a, b, rel_tol=RTOL, abs_tol=1e-6),
              f"step parity {k}: card {a} vs cpu {b}")
        res[k] = [a, b]
    print("parity", tf32_settings(), json.dumps(res), flush=True)


def phase_slice():
    set_tf32(True)     # PyTorch's defaults: TF32 in cuDNN convs, not in matmuls
    cfg = acdc_chap_config()
    state, step = make_step(cfg, "cuda", seed=1337)
    batches = [phantom_inputs(cfg, 10 + i, "cuda") for i in range(6)]
    gen = torch.Generator(device="cuda").manual_seed(1337)
    out = step(state, batches[0], gen)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    times, metrics = [], []
    n_steps = len(batches) - 1
    for batch in batches[1:]:
        t0 = time.perf_counter()
        out = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in out.metrics.items()})
    launches = launch_counts()
    for m in metrics:
        check(all(math.isfinite(v) for v in m.values()), f"finite metrics {m}")
    check(launches == {k: v * n_steps for k, v in LAUNCHES_PER_STEP.items()},
          f"launches over {n_steps} steps: {launches}, expected "
          f"{LAUNCHES_PER_STEP} per step")
    res = {"step_ms": times, "median_step_ms": statistics.median(times),
           "slices_per_s": 1e3 * cfg.data.batch_size / statistics.median(times),
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "launches_per_step": {k: v / n_steps for k, v in launches.items()},
           "last_metrics": metrics[-1], "settings": tf32_settings(),
           "batch": cfg.data.batch_size, "image_size": list(cfg.data.image_size),
           "feature_chns": list(cfg.model.feature_chns),
           "remat": cfg.optim.remat}
    print("slice", json.dumps(res), flush=True)
    print("clocks", subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip(), flush=True)
    phase_profile(state, step, batches[1:3], gen)
    return launches, res["median_step_ms"]


def _kernel_class(name: str) -> str:
    n = name.lower()
    if n.startswith(("stats_partials", "stats_finalize")):
        return "K1_fwd"
    if n.startswith("stats_grad"):
        return "K1_bwd"
    if "ccl3_" in n:
        return "K2_ccl3d"
    if "ccl_" in n:
        return "K2_ccl"
    if "sw_accumulate" in n:
        return "K3_sw"
    if "batch_norm" in n or "batchnorm" in n or "bn_" in n or "welford" in n:
        return "batchnorm"
    if any(k in n for k in ("conv", "xmma", "gemm", "cudnn", "wgrad", "dgrad",
                            "implicit", "winograd", "cutlass", "sm90")):
        return "conv"
    if "upsample" in n or "interp" in n or "max_pool" in n or "pool" in n:
        return "pool_upsample"
    if "reduce" in n or "softmax" in n:
        return "reduce_softmax"
    return "elementwise_other"


def phase_profile(state, step, batches, gen, tag="profile") -> dict:
    """Device time by kernel class over the steps of ``batches``
    (torch.profiler), and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):     # a session that saw no device kernel is taken again
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for batch in batches:
                step(state, batch, gen)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_class, top, ported, conv_bf16 = {}, [], {}, 0.0
        for ev in prof.key_averages():
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "self_cuda_time_total", 0.0)
            if dev_us <= 0 or getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
                continue
            cls = _kernel_class(ev.key)
            by_class[cls] = by_class.get(cls, 0.0) + dev_us / 1e3 / len(batches)
            if cls == "conv" and "bf16" in ev.key.lower():
                conv_bf16 += dev_us / 1e3 / len(batches)
            top.append((dev_us / 1e3 / len(batches), ev.count // len(batches),
                        ev.key[:70]))
            if cls.startswith(("K1", "K2", "K3")):
                ported[ev.key[:70]] = [dev_us / 1e3 / len(batches),
                                       ev.count / len(batches)]
        if by_class:
            break
    device_ms = sum(by_class.values())
    top.sort(reverse=True)
    res = {
        "steps": len(batches), "wall_ms_per_step": wall_ms / len(batches),
        "device_ms_per_step": device_ms,
        "device_busy_share": device_ms / (wall_ms / len(batches)),
        "ms_per_step_by_class": dict(sorted(by_class.items(),
                                            key=lambda kv: -kv[1])),
        "ported_kernels_ms_and_calls_per_step": ported,
        # convolution kernels whose names say bf16 (cuDNN's and CUTLASS's
        # name their element types)
        "conv_bf16_ms_per_step": conv_bf16,
        "top_kernels_ms_per_step": [[round(t, 3), c, k] for t, c, k in top[:15]]}
    print(tag, json.dumps(res), flush=True)
    return res


# ---------------------------------------------------------------------------
# phases 7 and 8: eval parity and the trainer through its CLI
# ---------------------------------------------------------------------------

def phase_eval_parity() -> dict:
    """Slice-wise eval on the card and on the CPU from the same weights,
    trained briefly on phantoms so the predictions are not one class."""
    set_tf32(False)
    cfg = acdc_chap_config()
    cfg.model.feature_chns = (4, 8, 16, 16, 32)
    cfg.data.batch_size, cfg.data.labeled_bs = 8, 4
    cfg.data.image_size = (64, 64)
    torch.manual_seed(5)
    model = net_factory(cfg.model.name, cfg.data.in_chns, cfg.data.num_classes,
                        cfg.model, device="cuda")
    opt = make_optimizer(model, cfg.optim.base_lr)
    state = create_train_state(model, opt, cfg.model.feature_chns)
    step = build_supervised_train_step(model, opt, cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    for i in range(30):
        step(state, phantom_inputs(cfg, 200 + i, "cuda"), gen)
    cpu_model = net_factory(cfg.model.name, cfg.data.in_chns,
                            cfg.data.num_classes, cfg.model, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    ds = SyntheticVolumeDataset((6, 64, 64), cfg.data.num_classes, length=2)
    on_card = make_predictor(model, device="cuda")
    on_cpu = make_predictor(cpu_model, device="cpu")
    agree = [float(np.mean(predict_volume(on_card, ds[i]["image"], (64, 64))
                           == predict_volume(on_cpu, ds[i]["image"], (64, 64))))
             for i in range(len(ds))]
    m_card = evaluate_volumes(ds, on_card, cfg.data.num_classes, (64, 64))
    m_cpu = evaluate_volumes(ds, on_cpu, cfg.data.num_classes, (64, 64))
    dice = [float(m_card[:, 0].mean()), float(m_cpu[:, 0].mean())]
    res = {"pixel_agreement": agree, "mean_dice_card_cpu": dice,
           "mean_hd95_card_cpu": [float(m_card[:, 1].mean()),
                                  float(m_cpu[:, 1].mean())],
           "settings": tf32_settings()}
    print("eval_parity", json.dumps(res), flush=True)
    check(min(agree) >= 0.999, f"eval predictions agree on >= 99.9%: {agree}")
    check(abs(dice[0] - dice[1]) <= 1e-3, f"eval mean dice card vs cpu {dice}")
    return res


def _records(save_dir: str) -> list:
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _meta(save_dir: str) -> dict:
    with open(os.path.join(save_dir, "checkpoints", "meta.json")) as f:
        return json.load(f)


def trainer_run(flags, overrides, steps, per_step) -> dict:
    """One cli.train_2d.main call with the launch counters set to 0 just
    before it and read just after; they must be ``steps`` x ``per_step``
    (eval and checkpoints launch no K1 or K2)."""
    zero_launch_counts()
    t0 = time.perf_counter()
    out = cli_train.main(TRAINER_FLAGS + flags + TRAINER_OVERRIDES + overrides)
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    want = {k: v * steps for k, v in per_step.items()}
    check(launches == want, f"trainer launches {launches}, expected {want} "
                            f"({per_step} per step over {steps} steps)")
    records = _records(out["save_dir"])
    return {**out, "wall_s": wall_s, "launches": launches, "records": records}


def phase_trainer(bare_step_ms: float) -> dict:
    set_tf32(True)     # PyTorch's defaults, as in phase 6
    shutil.rmtree(RUNS_DIR, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    first = trainer_run(["--max_iterations", "20"], [], 20, LAUNCHES_PER_STEP)
    peak = torch.cuda.max_memory_allocated()
    save_dir = first["save_dir"]
    check(first["steps"] == 20, f"20 CHAP steps, ran {first['steps']}")
    best_before = _meta(save_dir)
    resumed = trainer_run(["--max_iterations", "30", "--resume"], [], 10,
                          LAUNCHES_PER_STEP)
    check(resumed["save_dir"] == save_dir and resumed["steps"] == 30,
          f"resume continues the run to step 30: {resumed['steps']}")
    evals = [r for r in resumed["records"] if "val_mean_dice" in r]
    check([r["step"] for r in evals] == [10, 20, 30],
          f"evals at 10, 20, 30: {[r['step'] for r in evals]}")
    best_after = _meta(save_dir)
    check(best_after["best_metric"] >= best_before["best_metric"] and
          (best_after == best_before or best_after["best_iteration"] == 30),
          f"best slot kept across the resume: {best_before} -> {best_after}")
    t0 = time.perf_counter()
    with mock.patch.object(cli_test, "SyntheticVolumeDataset", TWO_VOLUMES):
        test_mean = cli_test.main(["--snapshot", save_dir, "--ckpt", "best",
                                   "--device", "cuda"])
    test_s = time.perf_counter() - t0
    check(np.isfinite(test_mean).all() and test_mean.shape == (3, 4),
          f"cli.test_2d metrics {test_mean}")
    check(os.path.exists(os.path.join(save_dir, "performance.txt")),
          "cli.test_2d wrote performance.txt")
    supervised = trainer_run(["--max_iterations", "5", "--mode", "supervised",
                              "--exp", "supervised"], ["eval.eval_every=5"],
                             5, SUPERVISED_LAUNCHES_PER_STEP)
    # 10 steps with an eval every 5: the second stretch runs without the
    # first step's warm-up or the loader's start
    host = trainer_run(["--max_iterations", "10", "--exp", "host_input"],
                       ["eval.eval_every=5", "data.device_input=false"],
                       10, LAUNCHES_PER_STEP)

    def rates(run, key="steps_per_sec_since_eval", after=0):
        return [r[key] for r in run["records"] if key in r and r["step"] > after]
    for run in (first, resumed, supervised, host):
        for r in run["records"]:
            if "loss" in r:
                check(math.isfinite(r["loss"]), f"finite loss {r}")
    pool = [r["pool_build_s"] for r in resumed["records"] if "pool_build_s" in r]
    with open(os.path.join(save_dir, "config.json")) as f:
        data_cfg = json.load(f)["data"]
    res = {
        "card": card_line(), "batch": data_cfg["batch_size"],
        "labeled_bs": data_cfg["labeled_bs"], "image_size": data_cfg["image_size"],
        "pool_slices": data_cfg["synthetic_train_size"], "pool_build_s": pool,
        "device_input_steps_per_s": rates(resumed),
        "host_input_steps_per_s": rates(host),
        "supervised_steps_per_s": rates(supervised),
        "bare_step_steps_per_s": 1e3 / bare_step_ms,
        # steps over the wall time from the run's loop start to each log
        # step, the evals and checkpoints before it included
        "window_steps_per_s": {
            "chap_20": rates(first, "steps_per_sec"),
            "resume_10": rates(resumed, "steps_per_sec", after=20)},
        "eval_s": [r["eval_s"] for r in evals],
        "checkpoint_ms": [r["checkpoint_ms"] for r in evals],
        "val_dice": [r["val_mean_dice"] for r in evals],
        "best": best_after, "test_2d_mean": test_mean.mean(axis=0).tolist(),
        "test_2d_s": test_s, "peak_mem_bytes": peak,
        "wall_s": {"chap_20": first["wall_s"], "resume_10": resumed["wall_s"],
                   "supervised_5": supervised["wall_s"], "host_10": host["wall_s"]},
        "launches": {"chap_20": first["launches"], "resume_10": resumed["launches"],
                     "supervised_5": supervised["launches"],
                     "host_10": host["launches"]},
        "settings": tf32_settings()}
    print("trainer", json.dumps(res), flush=True)
    shutil.rmtree(RUNS_DIR, ignore_errors=True)
    return res


# ---------------------------------------------------------------------------
# phases 9-14: the 3D path (K1 at 5-D, K2 in 3D, K3, parity, slice, trainer)
# ---------------------------------------------------------------------------

LA_PATCH = (112, 112, 80)
# configs/la_chap.yml through the 3D CLI on synthetic volumes; --dataset
# synthetic pins a 64x64x48 patch, so the LA patch is set back by override
TRAINER3D_FLAGS = ["--cfg", "configs/la_chap.yml", "--dataset", "synthetic",
                   "--adv_noise", "--dropout", "--device", "cuda"]
TRAINER3D_OVERRIDES = ["data.patch_size_3d=[112,112,80]", "run.log_every=2",
                       f"run.snapshot_root={RUNS_DIR}"]
F32 = "model.dtype=float32"


def la_config(*overrides):
    """configs/la_chap.yml as written (bf16 compute), with ``overrides``
    (``F32`` for the float32 phases kept beside the bf16 ones)."""
    return load_config("configs/la_chap.yml", list(overrides))


def serpentine3d(nx, ny, nz):
    """One component through every 8x16x16 tile of K2 in 3D (and every
    4x8x16 tile of its first version): a 2D serpentine in each even x
    plane, the planes joined at (y, z) = (0, 0)."""
    m = np.zeros((nx, ny, nz), np.int32)
    for x in range(0, nx, 2):
        m[x] = serpentine(ny, nz)
    m[:, 0, 0] = 1
    return m


def diagonals3d(n):
    """Voxel chains joined only through corners (x, y, z all step) or along
    edge diagonals (two of them step), across tile boundaries, in every
    backward direction; plus two 2-voxel components, one joined only across a
    tile corner and one only across a tile edge, of another class."""
    m = np.zeros((n, n, n), np.int32)
    for t in range(n):
        m[t, t, t] = 1
    for t in range(n - 4):
        m[t, n - 1 - t, t + 2] = 1
        m[t + 1, t, n - 1 - t] = 1
    for t in range(n - 6):
        m[t + 3, t, 0] = 1
        m[t, 0, t + 5] = 1
    m[3, 7, 15] = m[4, 8, 16] = 2
    m[7, 15, 3] = m[8, 16, 3] = 2
    return m


def ellipsoids(rs, b, shape, n=4):
    """[b, *shape] maps of class 1 on a few random ellipsoids each."""
    axes = np.meshgrid(*(np.arange(s, dtype=np.float32) for s in shape),
                       indexing="ij")
    out = np.zeros((b, *shape), np.int32)
    for i in range(b):
        for _ in range(n):
            c = [rs.uniform(0.2, 0.8) * s for s in shape]
            r = [rs.uniform(0.05, 0.2) * s for s in shape]
            inside = sum(((a - ci) / ri) ** 2 for a, ci, ri in zip(axes, c, r)) <= 1
            out[i][inside] = 1
    return out


def k2_regime_3d(name: str, rs: np.random.RandomState, b=4, shape=LA_PATCH):
    """The 3D CHAP step's 4 maps of 112x112x80, 2 classes."""
    if name == "clean":
        return ellipsoids(rs, b, shape)
    if name == "speckled":
        lab = ellipsoids(rs, b, shape)
        noise = rs.rand(b, *shape) < 0.08
        lab[noise] = rs.randint(0, 2, int(noise.sum()))
        return lab
    return (rs.rand(b, *shape) < 0.3).astype(np.int32)


TILE_3D = (8, 16, 16)      # K2's 3D tile (ccl.cu's kTX, kTY, kTZ)


def tile_contacts3d(tile=TILE_3D):
    """[7, 3 tx, 2.5 ty, 2.5 tz] maps whose components join only where two
    voxels meet across a tile corner or a tile edge, in each direction a
    cross-tile contact can take: map 0 a chain of corner steps through a
    corner of eight tiles; maps 1-6 a pair joined only across one tile edge
    (both voxels step across both boundaries, or one forward and one
    backward), beside a lone voxel with the smallest label, which a pair
    left apart would tie with and lose to."""
    tx, ty, tz = tile
    m = np.zeros((7, 3 * tx, ty * 5 // 2, tz * 5 // 2), np.int32)
    for t in range(3 * tx):
        m[0, t, t + ty - tx, t + tz - tx] = 1
    pairs = [((tx - 1, ty - 1, 5), (tx, ty, 5)), ((tx - 1, 3, tz - 1), (tx, 3, tz)),
             ((3, ty - 1, tz - 1), (3, ty, tz)), ((tx - 1, ty, 5), (tx, ty - 1, 5)),
             ((tx - 1, 5, tz), (tx, 5, tz - 1)), ((3, ty - 1, tz), (3, ty, tz - 1))]
    for i, (a, b) in enumerate(pairs, start=1):
        m[(i,) + a] = m[(i,) + b] = m[i, 0, 0, 0] = 1
    return m


def combs3d(axis, tile=TILE_3D, n=32):
    """A 32^3 map with two class-1 combs whose teeth interleave (two voxels
    apart) across the face between two tiles along ``axis``, each tile
    holding pieces of both: the larger comb (B, spine above the face) alone
    is kept. A wrong pair of tile-local roots merges them; a missed one cuts
    teeth off B."""
    t = tile[axis]
    m = np.zeros((n, n, n), np.int32)
    b_ax, w_ax = [d for d in range(3) if d != axis]

    def put(a, b):
        idx = [0, 0, 0]
        idx[axis], idx[b_ax], idx[w_ax] = a, b, 4
        m[tuple(idx)] = 1
    for b in range(0, n, 4):
        for a in range(t - 6, t + 4):
            put(a, b)
        for a in range(t - 4, t + 6):
            put(a, b + 2)
    for b in range(0, n - 3):
        put(t - 6, b)
    for b in range(2, n - 1):
        put(t + 5, b)
        put(t + 6, b)
    return m


def k2_adversarial_3d(rs: np.random.RandomState) -> dict:
    """name -> (segmentation [B, X, Y, Z] int32, num_classes)."""
    ties = np.zeros((1, 12, 24, 40), np.int32)
    for x, y, z in [(0, 0, 0), (5, 10, 20), (9, 17, 35), (2, 12, 33)]:
        ties[0, x:x + 2, y:y + 2, z:z + 2] = 1        # equal cubes, four tiles
    ties[0, 8:10, 2:4, 2:3] = 2
    ties[0, 1:3, 20:22, 10:11] = 2
    snakes = np.stack([serpentine3d(24, 56, 80), serpentine3d(24, 56, 80) * 2])
    u = rs.rand(2, 20, 24, 33)
    u2, u3 = rs.rand(2, 11, 35, 50), rs.rand(2, 17, 33, 35)
    return {
        "ragged_2x23x29x17": (rs.randint(0, 3, (2, 23, 29, 17)), 3),
        "serpentine_2x24x56x80": (snakes, 3),
        "serpentine_ragged_13x27x37": (serpentine3d(13, 27, 37)[None] * 2, 3),
        "corner_and_edge_diagonals_40": (diagonals3d(40)[None], 3),
        "ties_across_tiles": (ties, 3),
        "all_foreground": (np.full((2, 20, 20, 36), 2), 3),
        "all_background": (np.zeros((2, 20, 20, 36)), 2),
        "c2_percolating_3x33x40x50": ((rs.rand(3, 33, 40, 50) < 0.3), 2),
        "c3_percolating": (np.select([u < 0.3, u < 0.6], [1, 2], 0), 3),
        "labels_out_of_range": (rs.randint(-1, 5, (2, 20, 24, 33)), 3),
        "ragged_2x11x35x50": (np.select([u2 < 0.15, u2 < 0.3], [1, 2], 0), 3),
        "serpentine_16x48x64": (serpentine3d(16, 48, 64)[None], 2),
        "tile_contacts_7x24x40x40": (tile_contacts3d(), 2),
        "interleaved_combs_3x32x32x32": (np.stack([combs3d(a) for a in range(3)]), 2),
        "c3_percolating_2x17x33x35": (np.select([u3 < 0.3, u3 < 0.6], [1, 2], 0), 3),
    }


def phase_k2_3d():
    names = []
    for name, (seg, c) in k2_adversarial_3d(np.random.RandomState(8)).items():
        seg = torch.from_numpy(np.asarray(seg, np.int32)).cuda()
        k = nms.ccl3d_kernel(seg, c)
        torch.cuda.synchronize()
        check(torch.equal(k, nms.largest_cc_batch_plain(seg, c)),
              f"K2 3D equals its plain version ({name})")
        check(torch.equal(k, nms.ccl3d_kernel(seg, c)), f"K2 3D deterministic ({name})")
        names.append(name)
    print("K2 3D adversarial cases equal to the plain version and deterministic:",
          ", ".join(names), flush=True)
    out = {}
    for i, regime in enumerate(("speckled", "clean", "percolating")):
        seg = torch.from_numpy(k2_regime_3d(regime, np.random.RandomState(200 + i))
                               ).to(device="cuda", dtype=torch.int32)
        k = nms.ccl3d_kernel(seg, 2)
        p = nms.largest_cc_batch_plain(seg, 2)
        check(torch.equal(k, p), f"K2 3D equals its plain version ({regime})")
        check(torch.equal(k, nms.ccl3d_kernel(seg, 2)),
              f"K2 3D deterministic ({regime})")
        res = {"maps": list(seg.shape), "kept_voxels": int((k > 0).sum()),
               "bound": bound_ms(2 * seg.numel() * seg.element_size(), 0),
               "max_abs_err": float((k - p).abs().max()),
               **timings(lambda: nms.ccl3d_kernel(seg, 2), n=50),
               "plain_ms": device_ms(lambda: nms.largest_cc_batch_plain(seg, 2),
                                     n=2, warmup=1)}
        print("K2_3d", regime, json.dumps(res), flush=True)
        out[regime] = res
    return out


# ccl.cu's 3D design against its alternatives, as text substitutions in a
# copy of the source: other tiles; ccl3_local's flatten without path
# halving; ccl3_local hooking only the backward neighbours that no other
# hooked one is adjacent to (x-1 alone covers the other 12), which keeps
# the same components; registers capped for 2 blocks of 512 threads an SM
# in place of 4; and 1024 threads a tile (2 voxels each)
_PRUNE = """__device__ __forceinline__ int prune(int same) {
  int keep = 0, covered = 0;
#pragma unroll
  for (int i = 0; i < 13; ++i) {
    const int k = i == 0 ? 4 : i == 1 ? 10 : i == 2 ? 12 : i < 7 ? i - 3 : i < 12 ? i - 2 : 11;
    if (!(same >> k & 1) || (covered >> k & 1)) continue;
    keep |= 1 << k;
#pragma unroll
    for (int j = 0; j < 13; ++j) {
      const int ex = nb_dx(j) - nb_dx(k), ey = nb_dy(j) - nb_dy(k), ez = nb_dz(j) - nb_dz(k);
      if (j != k && ex * ex <= 1 && ey * ey <= 1 && ez * ez <= 1) covered |= 1 << j;
    }
  }
  return keep;
}

"""
_LOCAL = "// grid n_tiles, block kLocalThreads. Thread t holds"
_PRUNED = {"    same[j] = m;": "    same[j] = prune(m);", _LOCAL: _PRUNE + _LOCAL}
K2_3D_VARIANTS = {
    "8x16x16": {},
    "4x8x16": {"kTX = 8, kTY = 16, kTZ = 16;": "kTX = 4, kTY = 8, kTZ = 16;"},
    "4x16x16": {"kTX = 8, kTY = 16, kTZ = 16;": "kTX = 4, kTY = 16, kTZ = 16;"},
    "no_halving": {"        lab[x] = gp;": "        (void)0;"},
    "pruned": _PRUNED,
    "2_blocks_an_sm": {"kLocalBlocksPerSM = 4;": "kLocalBlocksPerSM = 2;"},
    "1024_threads": {"kLocalThreads = 512;": "kLocalThreads = 1024;",
                     "kLocalBlocksPerSM = 4;": "kLocalBlocksPerSM = 2;"},
}


def k2_3d_variants(rounds: int = 2) -> list:
    """By hand: each K2_3D_VARIANTS build of ccl.cu (one nvcc each, started
    together, into build/kernels/variants/) exactly equal to the plain
    version, then its profiler kernel ms by sub-kernel in the three regimes
    at 4 x 112x112x80, the variants in turns over ``rounds``. Launches here
    count nowhere."""
    text = (cuda_build.CSRC / "ccl.cu").read_text()
    out_dir = cuda_build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)

    def build(tag):
        src = text
        for a, b in K2_3D_VARIANTS[tag].items():
            check(src.count(a) == 1, f"variant {tag}: '{a}' once in ccl.cu")
            src = src.replace(a, b)
        cu, so = out_dir / f"ccl_{tag}.cu", out_dir / f"libccl_{tag}.so"
        cu.write_text(src)
        built = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o",
                                str(so), str(cu)], check=True, capture_output=True,
                               text=True)
        for kernel, use in ptxas_summary(built.stdout + built.stderr):
            if kernel == "ccl3_local":
                print("ptxas", tag, kernel, use, flush=True)
        return nms.bind(ctypes.CDLL(str(so)))
    with concurrent.futures.ThreadPoolExecutor(len(K2_3D_VARIANTS)) as pool:
        libs = dict(zip(K2_3D_VARIANTS, pool.map(build, K2_3D_VARIANTS)))
    out = []
    for i, regime in enumerate(("speckled", "clean", "percolating")):
        seg = torch.from_numpy(k2_regime_3d(regime, np.random.RandomState(200 + i))
                               ).to(device="cuda", dtype=torch.int32)
        plain = nms.largest_cc_batch_plain(seg, 2)
        for r in range(rounds):
            for tag, lib in libs.items():
                def run():
                    return nms._launch_k2("chap_largest_cc_3d", seg, 2, 3, lib=lib)
                check(torch.equal(run(), plain), f"K2 3D variant {tag} exact ({regime})")
                by_name = {}
                for name, us in device_kernels(run, 20):
                    name = short_name(name)
                    by_name[name] = by_name.get(name, 0.0) + us / 20 / 1e3
                res = {"variant": tag, "regime": regime, "round": r,
                       "kernel_ms": sum(by_name.values()), "kernel_ms_by_name": by_name}
                print("k2_3d_variant", json.dumps(res), flush=True)
                out.append(res)
    return out


def phase_k3() -> dict:
    """K3 against its plain version over a whole patch grid: the LA eval's
    batches of 16 patches of 112x112x80 in a 160x160x96 volume (80 patches;
    pz and every z-start multiples of 4: the 16-byte path), a ragged 16x16x8
    patch in a 40x36x20 volume at C = 3 in batches of 5 (z-stride 6: both
    paths in one batch), a 16x16x8 patch at z-stride 4 (16-byte path) and a
    16x16x10 patch at z-stride 3 (scalar path). Score and count within 1e-6
    of the plain version's, label maps equal (voxels whose two best classes
    tie within 1e-5 are counted, not held), two runs bit-identical; one LA
    batch timed."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    cases = {"la_160x160x96": ((160, 160, 96), LA_PATCH, 18, 4, 16, 2),
             "ragged_40x36x20": ((40, 36, 20), (16, 16, 8), 12, 6, 5, 3),
             "z4_40x36x24": ((40, 36, 24), (16, 16, 8), 12, 4, 6, 2),
             "pz10_z3_40x36x20": ((40, 36, 20), (16, 16, 10), 12, 3, 6, 3)}
    out = {}
    for name, (shape, patch, sxy, sz, bs, c) in cases.items():
        starts = sw.compute_grid(shape, patch, sxy, sz)
        maps = [(torch.zeros((c, *shape), device="cuda"),
                 torch.zeros(shape, device="cuda")) for _ in range(3)]
        for i in range(0, len(starts), bs):
            st = starts[i:i + bs]
            l1, l2 = (torch.randn((len(st), c, *patch), generator=gen,
                                  device="cuda") * 3 for _ in range(2))
            sw.sw_accumulate_kernel(l1, l2, st, *maps[0])
            sw.sw_accumulate_kernel(l1, l2, st, *maps[1])
            sw.sw_accumulate_plain(l1, l2, st, *maps[2])
        torch.cuda.synchronize()
        (ks, kc), (rs_, rc), (ps, pc) = maps
        check(torch.equal(ks, rs_) and torch.equal(kc, rc),
              f"K3 bit-identical on repeat ({name})")
        check(torch.equal(kc, pc), f"K3 count equals the plain version's ({name})")
        err = rel_err(ks, ps)
        check(err <= 1e-6, f"K3 score within 1e-6 of the plain version ({name}): {err}")
        k_prob, p_prob = ks / kc.clamp_min(1e-8), ps / pc.clamp_min(1e-8)
        differ = k_prob.argmax(0) != p_prob.argmax(0)
        top2 = p_prob.topk(2, dim=0).values
        near_tie = (top2[0] - top2[1]) <= 1e-5
        check(not bool((differ & ~near_tie).any()),
              f"K3 label maps equal the plain version's ({name})")
        res = {"patches": len(starts), "batch": bs, "classes": c,
               "max_abs_err": float((ks - ps).abs().max()), "rel_err": err,
               "label_voxels_differing_at_near_ties": int(differ.sum())}
        if name.startswith("la"):
            st = starts[:bs]
            l1, l2 = (torch.randn((bs, c, *patch), generator=gen, device="cuda")
                      for _ in range(2))
            score, cnt = (torch.zeros((c, *shape), device="cuda"),
                          torch.zeros(shape, device="cuda"))
            lo, size = sw.batch_box(st, patch)
            box = math.prod(size)
            # logits read once; score and count read and written over the box;
            # per patch voxel about 8 operations a class
            res.update({"box": size,
                        "bound": bound_ms(2 * l1.numel() * 4 + 2 * (c + 1) * box * 4,
                                          8 * l1.numel()),
                        **timings(lambda: sw.sw_accumulate_kernel(l1, l2, st, score,
                                                                  cnt), n=20),
                        "plain_ms": device_ms(lambda: sw.sw_accumulate_plain(
                            l1, l2, st, score, cnt), n=5, warmup=1)})
        print("K3", name, json.dumps(res), flush=True)
        out[name] = res
    return out


def phantom_patches(cfg, seed, device):
    """A [B, 1, *patch] batch of crops of 2-class phantom volumes."""
    patch = tuple(cfg.data.patch_size_3d)
    b = cfg.data.batch_size
    vols = SyntheticVolumeDataset((patch[2] + 8, patch[0] + 16, patch[1] + 16),
                                  cfg.data.num_classes, length=b, seed=seed)
    rs = np.random.RandomState(seed)
    images, labels = [], []
    for i in range(b):
        v = vols[i]
        img, lab = v["image"].transpose(2, 1, 0), v["label"].transpose(2, 1, 0)
        s = [rs.randint(0, n - p + 1) for n, p in zip(img.shape, patch)]
        sl = tuple(slice(a, a + p) for a, p in zip(s, patch))
        images.append(img[sl])
        labels.append(lab[sl])
    return {"image": torch.from_numpy(np.stack(images)[:, None]).to(device),
            "label": torch.from_numpy(np.stack(labels).astype(np.int32)).to(device)}


def make_step_3d(cfg, device, seed=0, state_dict=None):
    torch.manual_seed(seed)
    model = net_factory_3d("dualdecoder", cfg.data.in_chns, cfg.data.num_classes,
                           "train", cfg.model, device=device)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    opt = make_optimizer(model, cfg.optim.base_lr, cfg.optim.momentum,
                         cfg.optim.weight_decay)
    state = create_train_state(model, opt, level_channels(cfg, 3))
    return state, build_chap_train_step(model, opt, cfg, use_nms=True,
                                        level_paths=VNET_LEVEL_PATHS, device=device)


def phase_parity_3d() -> dict:
    """One 3D CHAP step on the card and on the CPU from the same weights and
    draws (nf 4, patch 32x32x16, batch 4, TF32 off): the 7 metrics at rtol
    2e-3. Then the sliding-window eval of a 48x48x24 volume on both, from
    weights trained 20 supervised steps on the card: >= 99.9% of voxels
    agree, each map between 1% and 99% foreground (so agreement cannot come
    from two all-background maps), K3 launched once per patch batch."""
    set_tf32(False)
    cfg = la_config(F32)
    cfg.model.n_filters_3d = 4
    cfg.data.patch_size_3d = (32, 32, 16)
    cpu_state, cpu_step = make_step_3d(cfg, "cpu")
    init = {k: v.clone() for k, v in cpu_state.model.state_dict().items()}
    cuda_state, cuda_step = make_step_3d(cfg, "cuda", state_dict=init)
    batch = phantom_patches(cfg, 1, "cpu")
    draws = draw_step_uniforms(cfg, batch["image"].shape,
                               torch.Generator().manual_seed(2), "cpu")
    before = launch_counts()
    on_cpu = cpu_step(cpu_state, batch, draws=dict(draws)).metrics
    on_card = cuda_step(cuda_state, to_cuda(batch), draws=to_cuda(draws)).metrics
    after = launch_counts()
    ran = {k: after[k] - before[k] for k in after}
    check(ran == LAUNCHES_PER_STEP_3D,
          f"the card's 3D step went through K1 and K2 in 3D: {ran} launches, "
          f"expected {LAUNCHES_PER_STEP_3D}")
    res = {}
    for k in METRICS:
        a, b = float(on_card[k]), float(on_cpu[k])
        check(math.isclose(a, b, rel_tol=RTOL, abs_tol=1e-6),
              f"3D step parity {k}: card {a} vs cpu {b}")
        res[k] = [a, b]
    res["bf16_step"] = bf16_step_parity(init, draws)
    # eval parity from briefly trained weights
    model = cuda_state.model
    opt = make_optimizer(model, cfg.optim.base_lr)
    state = create_train_state(model, opt)
    step = build_supervised3d_train_step(model, opt, cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    for i in range(20):
        step(state, phantom_patches(cfg, 300 + i, "cuda"), gen)
    cpu_model = net_factory_3d("dualdecoder", 1, 2, "test", cfg.model, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    vol = SyntheticVolumeDataset((24, 48, 48), 2, length=1, seed=9)[0]
    image = vol["image"].transpose(2, 1, 0)
    n_batches = -(-len(sw.compute_grid(image.shape, (32, 32, 16), 8, 4)) // 4)
    zero_launch_counts()
    on_card = sw.test_single_case(model, image, 8, 4, (32, 32, 16), 2, sw_batch=4,
                                  device="cuda")
    k3 = sw.sw_accumulate_kernel.launches
    on_cpu = sw.test_single_case(cpu_model, image, 8, 4, (32, 32, 16), 2,
                                 sw_batch=4, device="cpu")
    agree = float(np.mean(on_card == on_cpu))
    res.update({"eval_voxel_agreement": agree, "eval_fg_share": float(on_cpu.mean()),
                "eval_k3_launches": k3, "settings": tf32_settings()})
    res["bf16_eval"] = bf16_eval_parity(model.state_dict(), image, on_cpu, n_batches)
    print("parity_3d", json.dumps(res), flush=True)
    check(k3 == n_batches, f"eval launched K3 {k3} times for {n_batches} batches")
    check(agree >= 0.999, f"3D eval voxels agree on >= 99.9%: {agree}")
    fg = [float(on_card.mean()), float(on_cpu.mean())]
    check(all(0.01 < f < 0.99 for f in fg),
          f"3D eval parity needs foreground and background in the maps: {fg}")
    return res


def bf16_step_parity(init, draws) -> dict:
    """Phase 11's step in bf16 (configs/la_chap.yml's dtype) from the same
    weights and draws on three batches (their images in bf16): the card's
    metrics against the CPU's bf16 ones, all as one vector, within 2x the
    CPU's own bf16-vs-float32 gap on the same batches (a single scalar's
    gap is one draw of a rounding error); every K1 launch at bf16 logits."""
    cfgs = {"float32": la_config(F32), "bfloat16": la_config()}
    for cfg in cfgs.values():
        cfg.model.n_filters_3d = 4
        cfg.data.patch_size_3d = (32, 32, 16)
    runs = {"cpu_f32": [], "cpu_bf16": [], "card_bf16": []}
    zero_launch_counts()
    for seed in (1, 2, 3):
        batch = phantom_patches(cfgs["float32"], seed, "cpu")
        b16 = {"image": batch["image"].bfloat16(), "label": batch["label"]}
        for name, cfg, dev, b in (("cpu_f32", cfgs["float32"], "cpu", batch),
                                  ("cpu_bf16", cfgs["bfloat16"], "cpu", b16),
                                  ("card_bf16", cfgs["bfloat16"], "cuda", b16)):
            state, step = make_step_3d(cfg, dev, state_dict=init)
            out = (step(state, b, draws=dict(draws)) if dev == "cpu" else
                   step(state, to_cuda(b), draws=to_cuda(draws)))
            runs[name].append([float(out.metrics[k]) for k in METRICS])
    ran = launch_counts()
    check(ran == {k: 3 * v for k, v in LAUNCHES_PER_STEP_3D.items()},
          f"the card's bf16 3D steps: {ran} launches")
    check_all_bf16("the card's bf16 3D step")
    cpu32, cpu16, card16 = (np.array(runs[k]) for k in ("cpu_f32", "cpu_bf16",
                                                        "card_bf16"))
    gap = float(np.abs(cpu16 - cpu32).max())
    diff = float(np.abs(card16 - cpu16).max())
    check(diff <= 2 * gap + 1e-6, f"bf16 3D step, card against CPU: {diff}, the "
                                  f"CPU's bf16-vs-float32 gap {gap}")
    return {"card_vs_cpu": diff, "cpu_bf16_vs_f32": gap, "metrics": METRICS,
            **runs}


def bf16_eval_parity(state_dict, image, on_cpu32, n_batches) -> dict:
    """Phase 11's sliding-window eval with the model in bf16: the card's
    label map agrees with the CPU's bf16 one at least as well as the CPU's
    bf16 map agrees with its float32 one, less 0.5 points; K3's bf16
    instantiation once per patch batch."""
    cfg = la_config()
    cfg.model.n_filters_3d = 4
    maps = {}
    for dev in ("cuda", "cpu"):
        model = net_factory_3d("dualdecoder", 1, 2, "test", cfg.model, device=dev)
        model.load_state_dict(state_dict)
        zero_launch_counts()
        maps[dev] = sw.test_single_case(model, image, 8, 4, (32, 32, 16), 2,
                                        sw_batch=4, device=dev)
        if dev == "cuda":
            k3 = check_all_bf16("the card's bf16 eval")["K3_sw"]
    share_ref = float(np.mean(maps["cpu"] == on_cpu32))
    share = float(np.mean(maps["cuda"] == maps["cpu"]))
    check(k3 == n_batches, f"bf16 eval launched K3 {k3} times for {n_batches} batches")
    check(share >= share_ref - 0.005, f"bf16 3D eval: card and CPU agree on "
                                      f"{share}, CPU bf16 and float32 on {share_ref}")
    return {"card_vs_cpu_agreement": share, "cpu_bf16_vs_f32_agreement": share_ref,
            "k3_bf16_launches": k3}


def phase_slice_3d():
    """The 3D CHAP step at configs/la_chap.yml's values (nf 16, patch
    112x112x80, batch 4 = 2 + 2, fp32) on phantom patches, random weights
    from a seed: 1 warm-up and 3 timed steps, launches per step asserted,
    peak memory, then one step profiled by kernel class."""
    set_tf32(True)     # PyTorch's defaults: TF32 in cuDNN convs, not in matmuls
    cfg = la_config(F32)
    state, step = make_step_3d(cfg, "cuda", seed=1337)
    batches = [phantom_patches(cfg, 10 + i, "cuda") for i in range(5)]
    gen = torch.Generator(device="cuda").manual_seed(1337)
    step(state, batches[0], gen)                 # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    times, metrics = [], []
    for batch in batches[1:4]:
        t0 = time.perf_counter()
        out = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in out.metrics.items()})
    launches = launch_counts()
    n_steps = len(times)
    for m in metrics:
        check(all(math.isfinite(v) for v in m.values()), f"finite 3D metrics {m}")
    check(launches == {k: v * n_steps for k, v in LAUNCHES_PER_STEP_3D.items()},
          f"3D launches over {n_steps} steps: {launches}, expected "
          f"{LAUNCHES_PER_STEP_3D} per step")
    res = {"step_ms": times, "median_step_ms": statistics.median(times),
           "patches_per_s": 1e3 * cfg.data.batch_size / statistics.median(times),
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "launches_per_step": {k: v / n_steps for k, v in launches.items()},
           "last_metrics": metrics[-1], "settings": tf32_settings(),
           "batch": cfg.data.batch_size, "patch": list(cfg.data.patch_size_3d),
           "n_filters_3d": cfg.model.n_filters_3d}
    print("slice_3d", json.dumps(res), flush=True)
    profile = phase_profile(state, step, batches[4:5], gen, tag="profile_3d")
    del state, step, batches
    torch.cuda.empty_cache()
    return launches, res, profile


def conv_flop(model, x) -> int:
    """Operations (2 per multiply-add) of the model's 3D convolutions and
    transpose convolutions in one eval-mode forward of x, from forward
    hooks on the modules' shapes."""
    total = [0]

    def hook(module, inputs, output):
        k = math.prod(module.kernel_size)
        if isinstance(module, torch.nn.ConvTranspose3d):
            total[0] += 2 * inputs[0].numel() * module.out_channels * k
        else:
            total[0] += 2 * output.numel() * module.in_channels * k

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (torch.nn.Conv3d, torch.nn.ConvTranspose3d))]
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in handles:
            h.remove()
        model.train(was_training)
    return total[0]


def trainer3d_run(flags, overrides, steps, per_step) -> dict:
    """One cli.train_3d.main call with the launch counters set to 0 just
    before it and read just after; they must be ``steps`` x ``per_step``,
    every K1 launch at bf16 logits (configs/la_chap.yml's dtype)."""
    zero_launch_counts()
    t0 = time.perf_counter()
    out = cli_train3d.main(TRAINER3D_FLAGS + flags + TRAINER3D_OVERRIDES + overrides)
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    want = {k: v * steps for k, v in per_step.items()}
    check(launches == want, f"3D trainer launches {launches}, expected {want} "
                            f"({per_step} per step over {steps} steps)")
    bf16 = check_all_bf16("the 3D trainer on configs/la_chap.yml")
    check(out["steps"] == steps or "--resume" in flags,
          f"3D trainer ran {out['steps']} steps, expected {steps}")
    records = _records(out["save_dir"])
    for r in records:
        if "loss" in r:
            check(math.isfinite(r["loss"]), f"finite 3D loss {r}")
    return {**out, "wall_s": wall_s, "launches": launches,
            "launches_bf16": bf16, "records": records}


def phase_trainer_3d(bare_step_ms: float) -> dict:
    """cli.train_3d at configs/la_chap.yml's values as written (bf16) on
    synthetic volumes: 4 CHAP steps, --resume to 6, 2 cps and 2 supervised
    steps, 3 CHAP steps on the host loader; then test_all_case on the run's
    latest weights over 2 synthetic volumes of 160x160x96 (stride 18/4,
    sw_batch 16) with the model in bf16 (K3's bf16 instantiation once per
    patch batch) and, from the same float32 parameters, in float32 (K3's
    float32 one), and cli.test_3d on the card."""
    set_tf32(True)
    shutil.rmtree(RUNS_DIR, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    first = trainer3d_run(["--max_iterations", "4"], [], 4, LAUNCHES_PER_STEP_3D)
    save_dir = first["save_dir"]
    resumed = trainer3d_run(["--max_iterations", "6", "--resume"], [], 2,
                            LAUNCHES_PER_STEP_3D)
    check(resumed["save_dir"] == save_dir and resumed["steps"] == 6,
          f"resume continues the 3D run to step 6: {resumed['steps']}")
    check([r["step"] for r in resumed["records"] if "loss" in r] == [2, 4, 6],
          "3D log steps 2, 4 before and 6 after the resume")
    cps = trainer3d_run(["--max_iterations", "2", "--method", "cps", "--exp", "cps"],
                        [], 2, SUPERVISED_LAUNCHES_PER_STEP)
    sup = trainer3d_run(["--max_iterations", "2", "--method", "supervised",
                         "--model", "dualdecoder", "--exp", "sup"], [], 2,
                        SUPERVISED_LAUNCHES_PER_STEP)
    host = trainer3d_run(["--max_iterations", "3", "--exp", "host_input"],
                         ["data.device_input=false"], 3, LAUNCHES_PER_STEP_3D)
    peak = torch.cuda.max_memory_allocated()
    # the sliding-window eval on the run's latest weights
    cfg = la_config()
    model = net_factory_3d("dualdecoder", 1, 2, "test", cfg.model, device="cuda")
    CheckpointManager(save_dir).restore(
        "latest", create_train_state(model, make_optimizer(model, 0.01),
                                     level_channels(cfg, 3)))
    check(all(v.dtype == torch.float32 for v in model.state_dict().values()
              if v.is_floating_point()), "the bf16 run checkpoints float32")
    vols = SyntheticVolumeDataset((96, 160, 160), 2, length=2, seed=4)
    cases = [{"image": vols[i]["image"].transpose(2, 1, 0),
              "label": vols[i]["label"].transpose(2, 1, 0),
              "case": vols[i]["case"]} for i in range(2)]
    n_batches = sum(-(-len(sw.compute_grid(c["image"].shape, LA_PATCH, 18, 4)) // 16)
                    for c in cases)
    torch.cuda.synchronize()
    zero_launch_counts()
    t0 = time.perf_counter()
    metrics = sw.test_all_case(model, cases, 2, LA_PATCH, 18, 4, sw_batch=16,
                               device="cuda")
    eval_s = time.perf_counter() - t0
    k3 = check_all_bf16("test_all_case with the bf16 model")["K3_sw"]
    check(k3 == n_batches, f"test_all_case launched K3 {k3} times for "
                           f"{n_batches} patch batches")
    check(np.isfinite(metrics).all() and metrics.shape == (1, 2),
          f"test_all_case metrics {metrics}")
    # the same parameters in float32: K3's float32 instantiation
    model32 = net_factory_3d("dualdecoder", 1, 2, "test", la_config(F32).model,
                             device="cuda")
    model32.load_state_dict(model.state_dict())
    zero_launch_counts()
    t0 = time.perf_counter()
    metrics32 = sw.test_all_case(model32, cases, 2, LA_PATCH, 18, 4, sw_batch=16,
                                 device="cuda")
    eval32_s = time.perf_counter() - t0
    k3_32 = launch_counts()["K3_sw"]
    check(k3_32 == n_batches and bf16_launch_counts()["K3_sw"] == 0,
          f"float32 test_all_case launched K3 {k3_32} times, none in bf16")
    check(np.isfinite(metrics32).all(), f"float32 test_all_case metrics {metrics32}")
    # the card's part of one volume: forwards, K3 and argmax, no host metrics
    engine = sw.SlidingWindowEngine(model, LA_PATCH, 16, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.predict_async(cases[0]["image"], 18, 4, 2)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    batches_per_volume = n_batches // len(cases)
    forward_flop = conv_flop(model, torch.zeros((16, 1) + LA_PATCH, device="cuda"))
    t0 = time.perf_counter()
    test_metrics = cli_test3d.main(["--dataset", "synthetic", "--snapshot", save_dir,
                                    "--ckpt", "latest", "--model", "dualdecoder",
                                    "--sw_batch", "16", "--device", "cuda"])
    test_s = time.perf_counter() - t0
    check(test_metrics.shape == (1, 4) and np.isfinite(test_metrics[:, 0]).all(),
          f"cli.test_3d metrics {test_metrics}")

    def rates(run):
        return [r["steps_per_sec"] for r in run["records"] if "steps_per_sec" in r]
    res = {
        "card": card_line(), "patch": list(LA_PATCH), "batch": cfg.data.batch_size,
        "n_filters_3d": cfg.model.n_filters_3d,
        "pool_build_s": [r["pool_build_s"] for r in first["records"]
                         if "pool_build_s" in r],
        "window_steps_per_s": {"chap_4": rates(first), "host_3": rates(host)},
        "bare_step_steps_per_s": 1e3 / bare_step_ms,
        "checkpoint_ms": [r["checkpoint_ms"] for r in resumed["records"]
                          if "checkpoint_ms" in r],
        "eval_volumes": [list(c["image"].shape) for c in cases],
        "eval_patch_batches": n_batches, "eval_s_per_volume": eval_s / len(cases),
        "eval_f32_s_per_volume": eval32_s / len(cases),
        "eval_f32_dice_hd95": metrics32[0].tolist(),
        "predict_s_per_volume": predict_s, "dtype": cfg.model.dtype,
        "conv_tflop_per_volume": forward_flop * batches_per_volume / 1e12,
        "conv_tflop_per_s": forward_flop * batches_per_volume / predict_s / 1e12,
        "eval_dice_hd95": metrics[0].tolist(), "test_3d_s": test_s,
        "test_3d_mean": test_metrics.mean(axis=0).tolist(), "peak_mem_bytes": peak,
        "wall_s": {"chap_4": first["wall_s"], "resume_2": resumed["wall_s"],
                   "cps_2": cps["wall_s"], "supervised_2": sup["wall_s"],
                   "host_3": host["wall_s"]},
        "launches": {"chap_4": first["launches"], "resume_2": resumed["launches"],
                     "cps_2": cps["launches"], "supervised_2": sup["launches"],
                     "host_3": host["launches"], "test_all_case": k3,
                     "test_all_case_f32": k3_32},
        "launches_bf16": {"chap_4": first["launches_bf16"],
                          "resume_2": resumed["launches_bf16"],
                          "cps_2": cps["launches_bf16"],
                          "supervised_2": sup["launches_bf16"],
                          "host_3": host["launches_bf16"]},
        "settings": tf32_settings()}
    print("trainer3d", json.dumps(res), flush=True)
    shutil.rmtree(RUNS_DIR, ignore_errors=True)
    return res


# ---------------------------------------------------------------------------
# phases 14-17: the ACAL shared-encoder trainer and the ablation step
# ---------------------------------------------------------------------------

ACAL_CFG = "configs/acdc_share_acal.yml"
# K1 launches of each ACAL step: the joint step and the decoder max-step run
# dice_ce_supervised on both outputs' labeled half (R = 1), the encoder
# min-step none; the ablation step as the supervised step
ACAL_LAUNCHES = {"joint": SUPERVISED_LAUNCHES_PER_STEP,
                 "max": SUPERVISED_LAUNCHES_PER_STEP,
                 "min": {k: 0 for k in SUPERVISED_LAUNCHES_PER_STEP}}
ABLATION_LAUNCHES_PER_STEP = SUPERVISED_LAUNCHES_PER_STEP
SHARE_METRICS = {"joint": ("loss", "model1_loss", "model2_loss"),
                 "max": ("dis_loss", "acal_f_loss"), "min": ("dis_loss_g",)}
ABLATION_METRICS = ("loss", "sup_loss", "fp_loss", "vat_loss",
                    "disagreement_ratio", "consistency_weight")


def acal_config():
    """configs/acdc_share_acal.yml with semi.acal on, as ``--acal`` sets it."""
    cfg = load_config(ACAL_CFG)
    cfg.semi.acal = True
    return cfg


def make_share(cfg, device, seed=0, state_dict=None):
    """(ShareTrainState, joint step, decoder max-step, encoder min-step)."""
    torch.manual_seed(seed)
    model = net_factory("acalnet", cfg.data.in_chns, cfg.data.num_classes,
                        cfg.model, device=device)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    state = create_share_state(model, cfg)
    joint = build_share_joint_step(model, state.optimizer_g, state.optimizer_f,
                                   cfg, device=device)
    dec, enc = build_acal_steps(model, state.optimizer_g, state.optimizer_f,
                                cfg, device=device)
    return state, joint, dec, enc


def launches_since(before: dict) -> dict:
    now = launch_counts()
    return {k: now[k] - before[k] for k in now}


def phase_parity_share() -> dict:
    """One joint step, one decoder max-step and one encoder min-step on the
    card and on the CPU from the same weights and draws, with the mse and
    the softdice discrepancy; then one ablation step with the channel
    dropout and VAT on. Feature_chns (4, 8, 16, 16, 32), batch 8 = 4 + 4 at
    32^2, TF32 off: metrics at rtol 2e-3, the card's K1 launches per step."""
    set_tf32(False)
    res = {}
    for adv in ("mse", "softdice"):
        cfg = acal_config()
        cfg.semi.adv_losstype = adv
        cfg.model.feature_chns = (4, 8, 16, 16, 32)
        cfg.data.batch_size, cfg.data.labeled_bs = 8, 4
        cfg.data.image_size = (32, 32)
        cpu = make_share(cfg, "cpu")
        card = make_share(cfg, "cuda", state_dict=cpu[0].model.state_dict())
        on_card = {"cpu": False, "card": True}
        batch = phantom_inputs(cfg, 1, "cpu")
        mask = torch.zeros(4, 32, 32)
        mask[:, 8:24, 4:20] = 1.0
        draws = [draw_supervised_uniforms(cfg, batch["image"].shape,
                                          torch.Generator().manual_seed(s), "cpu")
                 for s in (2, 3, 4)]
        out = {}
        for (state, joint, dec, enc), where in ((cpu, "cpu"), (card, "card")):
            b = to_cuda(batch) if on_card[where] else batch
            m = to_cuda(mask) if on_card[where] else mask
            d = [to_cuda(x) for x in draws] if on_card[where] else draws
            steps = {
                "joint": lambda: joint(state, b, draws=d[0])[1],
                "max": lambda: dec(state, b["image"], b["label"], m, draws=d[1])[1],
                "min": lambda: enc(state, b["image"], m, draws=d[2])[1]}
            for name, run in steps.items():
                before = launch_counts()
                metrics = run()
                ran = launches_since(before)
                if on_card[where]:
                    check(ran == ACAL_LAUNCHES[name],
                          f"ACAL {name} step on the card: {ran} launches, "
                          f"expected {ACAL_LAUNCHES[name]}")
                out[(name, where)] = {k: float(metrics[k])
                                      for k in SHARE_METRICS[name]}
        for name, keys in SHARE_METRICS.items():
            for k in keys:
                a, b = out[(name, "card")][k], out[(name, "cpu")][k]
                check(math.isclose(a, b, rel_tol=RTOL, abs_tol=1e-6),
                      f"ACAL {name} ({adv}) parity {k}: card {a} vs cpu {b}")
                res[f"{adv}/{name}/{k}"] = [a, b]
    # the ablation step, channel dropout and VAT on
    cfg = acdc_chap_config()
    cfg.model.feature_chns = (4, 8, 16, 16, 32)
    cfg.data.batch_size, cfg.data.labeled_bs = 8, 4
    cfg.data.image_size = (32, 32)
    torch.manual_seed(0)
    metrics = {}
    batch = phantom_inputs(cfg, 1, "cpu")
    draws = draw_ablation_uniforms(cfg, batch["image"].shape,
                                   torch.Generator().manual_seed(5), "cpu")
    state_dict = None
    for where, device in (("cpu", "cpu"), ("card", "cuda")):
        model = net_factory(cfg.model.name, 1, cfg.data.num_classes, cfg.model,
                            device=device)
        if state_dict is None:      # the CPU's initial weights, for both
            state_dict = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(state_dict)
        opt = make_optimizer(model, cfg.optim.base_lr, cfg.optim.momentum,
                             cfg.optim.weight_decay)
        state = create_train_state(model, opt, cfg.model.feature_chns)
        step = build_ablation_train_step(model, opt, cfg, device=device)
        b, d = (to_cuda(batch), to_cuda(draws)) if where == "card" else (batch, draws)
        before = launch_counts()
        metrics[where] = {k: float(v) for k, v in step(state, b, draws=d).metrics.items()}
        ran = launches_since(before)
        if where == "card":
            check(ran == ABLATION_LAUNCHES_PER_STEP,
                  f"ablation step on the card: {ran} launches, expected "
                  f"{ABLATION_LAUNCHES_PER_STEP}")
    for k in ABLATION_METRICS:
        a, b = metrics["card"][k], metrics["cpu"][k]
        check(math.isclose(a, b, rel_tol=RTOL, abs_tol=1e-6),
              f"ablation parity {k}: card {a} vs cpu {b}")
        res[f"ablation/{k}"] = [a, b]
    check(metrics["card"]["fp_loss"] > 0 and metrics["card"]["vat_loss"] > 0,
          f"the ablation step ran its dropout and VAT passes: {metrics['card']}")
    print("parity_share", tf32_settings(), json.dumps(res), flush=True)
    return res


def phase_slice_share() -> dict:
    """The ACAL iteration at configs/acdc_share_acal.yml's values (widths
    16-256, batch 24 = 12 + 12 at 256^2, fp32, random weights from a seed)
    on phantom batches, with a memory bank fed from the knowledge map: 1
    warm-up and 5 timed iterations of joint step, bank feed (the knowledge
    map's copy plus the host ranking) and replay pair (decoder max-step +
    encoder min-step), each part timed to a sync; launches per step
    asserted; then torch.profiler over 1 iteration by kernel class. Then
    the ablation step at configs/acdc_chap.yml's values: 1 warm-up and 3
    timed steps."""
    set_tf32(True)     # PyTorch's defaults, as in phase 6
    cfg = acal_config()
    lbs = cfg.data.labeled_bs
    state, joint, dec, enc = make_share(cfg, "cuda", seed=1337)
    bank = ImageMemoryBank(cfg.semi.mb_capacity, cfg.data.image_size,
                           cfg.semi.mb_patch_size, seed=cfg.run.seed)
    host = [phantom_batch(np.random.RandomState(30 + i), cfg.data.batch_size,
                          cfg.data.image_size[0], cfg.data.num_classes)
            for i in range(7)]
    batches = [{"image": torch.from_numpy(im).cuda(),
                "label": torch.from_numpy(lab).cuda()} for im, lab in host]
    gen = torch.Generator(device="cuda").manual_seed(1337)
    parts = {"joint": [], "feed": [], "replay": []}
    per_step = {"joint": [], "max": [], "min": []}

    def iteration(state, i, gen, timed=False):
        t0 = time.perf_counter()
        before = launch_counts()
        state, m, knowledge = joint(state, batches[i], gen)
        ran_joint = launches_since(before)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        bank.add(host[i][0][lbs:], knowledge.cpu().numpy(), 8)
        t2 = time.perf_counter()
        replay = to_device(bank.get_samples(cfg.data.batch_size - lbs),
                           torch.device("cuda"))
        image = torch.cat([batches[i]["image"][:lbs], replay["image"]])
        before = launch_counts()
        state, f = dec(state, image, batches[i]["label"], replay["mask"], gen)
        ran_max = launches_since(before)
        before = launch_counts()
        state, g = enc(state, image, replay["mask"], gen)
        ran_min = launches_since(before)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        if timed:
            parts["joint"].append((t1 - t0) * 1e3)
            parts["feed"].append((t2 - t1) * 1e3)
            parts["replay"].append((t3 - t2) * 1e3)
            for name, ran in (("joint", ran_joint), ("max", ran_max),
                              ("min", ran_min)):
                per_step[name].append(ran)
        return {k: float(v) for k, v in {**m, **f, **g}.items()}

    iteration(state, 0, gen)                    # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    metrics = [iteration(state, i, gen, timed=True) for i in range(1, 6)]
    launches = launch_counts()
    n = len(metrics)
    for m in metrics:
        check(all(math.isfinite(v) for v in m.values()), f"finite ACAL metrics {m}")
    for name, runs in per_step.items():
        check(all(r == ACAL_LAUNCHES[name] for r in runs),
              f"ACAL {name} step launches {runs}, expected {ACAL_LAUNCHES[name]}")
    want = {k: sum(ACAL_LAUNCHES[s][k] for s in ACAL_LAUNCHES) * n for k in launches}
    check(launches == want, f"ACAL launches over {n} iterations: {launches}, "
                            f"expected {want}")
    res = {"joint_ms": parts["joint"], "feed_ms": parts["feed"],
           "replay_pair_ms": parts["replay"],
           "median_ms": {k: statistics.median(v) for k, v in parts.items()},
           "median_iteration_ms": statistics.median(
               [a + b + c for a, b, c in zip(*parts.values())]),
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "launches_per_iteration": {k: v / n for k, v in launches.items()},
           "launches_per_step": {k: v[0] for k, v in per_step.items()},
           "bank_entries": len(bank), "counts": [state.count_g, state.count_f],
           "last_metrics": metrics[-1], "settings": tf32_settings(),
           "batch": cfg.data.batch_size, "image_size": list(cfg.data.image_size),
           "feature_chns": list(cfg.model.feature_chns),
           "adv_losstype": cfg.semi.adv_losstype}
    print("slice_share", json.dumps(res), flush=True)
    profile = phase_profile(state, iteration, [6], gen, tag="profile_share")
    del state, joint, dec, enc, batches
    torch.cuda.empty_cache()

    # the ablation step at configs/acdc_chap.yml's values (dropout and VAT on)
    cfg = acdc_chap_config()
    torch.manual_seed(1337)
    model = net_factory(cfg.model.name, cfg.data.in_chns, cfg.data.num_classes,
                        cfg.model, device="cuda")
    opt = make_optimizer(model, cfg.optim.base_lr, cfg.optim.momentum,
                         cfg.optim.weight_decay)
    astate = create_train_state(model, opt, cfg.model.feature_chns)
    step = build_ablation_train_step(model, opt, cfg, device="cuda")
    abatches = [phantom_inputs(cfg, 50 + i, "cuda") for i in range(4)]
    step(astate, abatches[0], gen)                # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    times, ametrics = [], []
    for batch in abatches[1:]:
        t0 = time.perf_counter()
        out = step(astate, batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        ametrics.append({k: float(v) for k, v in out.metrics.items()})
    alaunches = launch_counts()
    want = {k: v * len(times) for k, v in ABLATION_LAUNCHES_PER_STEP.items()}
    check(alaunches == want, f"ablation launches {alaunches}, expected {want}")
    for m in ametrics:
        check(all(math.isfinite(v) for v in m.values()), f"finite ablation {m}")
    ablation = {"step_ms": times, "median_step_ms": statistics.median(times),
                "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                "launches_per_step": {k: v / len(times) for k, v in alaunches.items()},
                "last_metrics": ametrics[-1], "settings": tf32_settings()}
    print("slice_ablation", json.dumps(ablation), flush=True)
    del astate, step, model, opt, abatches
    torch.cuda.empty_cache()
    return {**res, "launches": launches, "profile": profile,
            "ablation": ablation, "ablation_launches": alaunches}


def phase_trainer_share() -> dict:
    """chap_tpu_torch.cli.train_share_2d.main in process at
    configs/acdc_share_acal.yml's values with --acal --dataset synthetic and
    semi.acal_start_iter=10: 20 iterations with an eval of both decoders
    every 10 on 2 val volumes of 10 x 256^2. Launch counters set to 0 just
    before and read just after: 20 joint steps and 10 replay pairs, 2 + 2 K1
    each, so 60 / 60. The three slots are written."""
    set_tf32(True)
    shutil.rmtree(RUNS_DIR, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    t0 = time.perf_counter()
    out = cli_share.main(["--cfg", ACAL_CFG, "--acal", "--dataset", "synthetic",
                          "--max_iterations", "20", "--device", "cuda",
                          "semi.acal_start_iter=10", "eval.eval_every=10",
                          "data.synthetic_val_volumes=2", "run.log_every=10",
                          f"run.snapshot_root={RUNS_DIR}"])
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {**{k: 0 for k in launches}, "K1_fwd": 60, "K1_bwd": 60}
    check(out["steps"] == 20, f"20 ACAL iterations, ran {out['steps']}")
    check(launches == want, f"ACAL trainer launches {launches}, expected {want}")
    save_dir = out["save_dir"]
    for slot in ("best_model1", "best_model2", "latest"):
        check(os.path.isfile(os.path.join(save_dir, "checkpoints", slot, "state.pt")),
              f"ACAL trainer wrote the {slot} slot")
    records = _records(save_dir)
    logged = [r for r in records if "loss" in r]
    evals = [r for r in records if "model1_val_mean_dice" in r]
    check([r["step"] for r in logged] == [10, 20] and
          ["dis_loss" in r for r in logged] == [False, True],
          f"ACAL log steps and replay metrics: {logged}")
    check([r["step"] for r in evals] == [10, 20], f"ACAL evals at 10, 20: {evals}")
    for r in logged:
        check(all(math.isfinite(v) for v in r.values()), f"finite ACAL log {r}")
    with open(os.path.join(save_dir, "config.json")) as f:
        cfg = json.load(f)
    res = {"card": card_line(), "batch": cfg["data"]["batch_size"],
           "labeled_bs": cfg["data"]["labeled_bs"],
           "image_size": cfg["data"]["image_size"], "acal": cfg["semi"]["acal"],
           "acal_start_iter": cfg["semi"]["acal_start_iter"],
           "window_iterations_per_s": [r["steps_per_sec"] for r in logged],
           "mb_feed_ms": [r["mb_feed_ms"] for r in logged],
           "eval_s": {k: [r[f"{k}_eval_s"] for r in evals]
                      for k in ("model1", "model2")},
           "checkpoint_ms": [r["checkpoint_ms"] for r in evals],
           "val_dice": {k: [r[f"{k}_val_mean_dice"] for r in evals]
                        for k in ("model1", "model2")},
           "best": {k: out[f"best_dice_{k}"] for k in ("model1", "model2")},
           "peak_mem_bytes": peak, "wall_s": wall_s,
           "launches": {"acal_20": launches}, "settings": tf32_settings()}
    print("trainer_share", json.dumps(res), flush=True)
    # the latest slot's weights (val dice above 0) for phase 23's (k)
    res["weights"] = share_weights(save_dir)
    shutil.rmtree(RUNS_DIR, ignore_errors=True)
    return res


def phase_trainer_ablation() -> dict:
    """cli.train_2d.main --mode ablation at configs/acdc_chap.yml's values
    (channel dropout and VAT on) on synthetic data: 10 steps, a log every 2
    and an eval at 10; 2 / 2 / 0 K1 forward / K1 backward / K2 a step, one
    disagreement.csv row a log step; the step ms between the log steps."""
    set_tf32(True)
    shutil.rmtree(RUNS_DIR, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    run = trainer_run(["--max_iterations", "10", "--mode", "ablation",
                       "--exp", "ablation"], ["run.log_every=2"], 10,
                      ABLATION_LAUNCHES_PER_STEP)
    peak = torch.cuda.max_memory_allocated()
    check(run["steps"] == 10, f"10 ablation steps, ran {run['steps']}")
    logged = [r for r in run["records"] if "disagreement_ratio" in r]
    with open(os.path.join(run["save_dir"], "disagreement.csv")) as f:
        rows = [line.strip().split(",") for line in f][1:]
    check([int(r[0]) for r in rows] == [r["step"] for r in logged] == [2, 4, 6, 8, 10],
          f"disagreement.csv rows {rows} against log steps "
          f"{[r['step'] for r in logged]}")
    for r in logged:
        check(all(math.isfinite(v) for v in r.values()), f"finite ablation log {r}")
    # wall time between the log records at steps 2 and 10 (each log reads
    # the metrics off the card, a sync), over the 8 steps between
    step_ms = (logged[-1]["time"] - logged[0]["time"]) * 1e3 / 8
    res = {"card": card_line(), "step_ms_between_logs": step_ms,
           "steps_per_s": [r["steps_per_sec"] for r in logged],
           "disagreement_ratio": [float(r[1]) for r in rows],
           "val_dice": [r["val_mean_dice"] for r in run["records"]
                        if "val_mean_dice" in r],
           "peak_mem_bytes": peak, "wall_s": run["wall_s"],
           "launches": {"ablation_10": run["launches"]},
           "settings": tf32_settings()}
    print("trainer_ablation", json.dumps(res), flush=True)
    shutil.rmtree(RUNS_DIR, ignore_errors=True)
    return res



# ---------------------------------------------------------------------------
# phases 18-20: the 3D model zoo and the BraTS supervised protocol
# ---------------------------------------------------------------------------

BRATS_CFG = "configs/brats_supervised.yml"
BRATS_PATCH = (96, 96, 96)
# K1 launches of a supervised step: one R = 1 dice_ce_supervised per output
ZOO_OUTPUTS = {"unet_3D": 1, "attention_unet": 1, "voxresnet": 1,
               "unet_3D_dv_semi": 4}
# the 3D CLI at configs/brats_supervised.yml's values on synthetic volumes:
# --dataset synthetic pins a 64x64x48 patch, so the BraTS patch is set back
# by override; 8 of the 12 phantom volumes labeled (the config's 250 would
# leave no unlabeled stream)
ZOO_TRAINER_FLAGS = ["--cfg", BRATS_CFG, "--method", "supervised", "--dataset",
                     "synthetic", "--labeled_num", "8", "--device", "cuda"]
ZOO_TRAINER_OVERRIDES = ["data.patch_size_3d=[96,96,96]", "run.log_every=2",
                         f"run.snapshot_root={RUNS_DIR}"]


def supervised_launches(outputs: int) -> dict:
    return {"K1_fwd": outputs, "K1_bwd": outputs, "K2_ccl": 0, "K2_ccl3d": 0,
            "K3_sw": 0}


def brats_config(*overrides):
    """configs/brats_supervised.yml as written (bf16 compute), with
    ``overrides``, and the BraTS patch the CLI pins from the dataset
    name."""
    cfg = load_config(BRATS_CFG, list(overrides))
    cfg.data.patch_size_3d = BRATS_PATCH
    return cfg


def small_zoo(key: str):
    """Each net_factory_3d key's model at a small width (feature_scale 16,
    8 VoxResNet channels, n_filters 4; n_filters 16 for VNet's groupnorm,
    whose 16 groups need 16 channels), dropout on."""
    return {"unet_3D": lambda: UNet3D(1, 2, 16),
            "attention_unet": lambda: AttentionUNet3D(1, 2, 16),
            "voxresnet": lambda: VoxResNet(1, 2, 8),
            "vnet": lambda: VNet(1, 2, 4, "batchnorm", True),
            "vnet_groupnorm": lambda: VNet(1, 2, 16, "groupnorm", True),
            "vnet_instancenorm": lambda: VNet(1, 2, 4, "instancenorm", True),
            "vnet_ds": lambda: VNetDS(1, 2, 4, "batchnorm", True),
            "dualdecoder": lambda: DualDecoder3d(1, 2, 4, "batchnorm", True),
            "resvnet": lambda: ResVNet(1, 2, 4, has_dropout=True),
            "unet_3D_dv_semi": lambda: UNet3DDvSemi(1, 2, 16)}[key]()


def _flat(out) -> list:
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [out]


def zoo_tol(want: torch.Tensor) -> float:
    """5e-4 x max(1, peak |want|): the port's forward bar, relative to the
    output's scale above 1, as tests/test_torch_models3d.py holds train-mode
    VNet logits of up to ~30, where float32 alone moves them by 1e-3."""
    return 5e-4 * max(1.0, float(want.abs().max()))


def phase_parity_zoo3d() -> dict:
    """Every net_factory_3d key (and VNet with groupnorm and instancenorm)
    at a small width on the card and on the CPU from the same weights and
    dropout draws (48x32x16, batch 2, TF32 off): every output in eval and
    train mode at 5e-4 (zoo_tol), and the train pass's BatchNorm batch
    statistics (the new running stats' inputs). Then one supervised step of
    unet_3D, attention_unet, voxresnet and unet_3D_dv_semi on both (32x32x16,
    batch 4): loss at rtol 2e-3, the card's K1 launches 1 / 1 a step (4 / 4
    for unet_3D_dv_semi). vnet_ds and resvnet are refused by the step."""
    set_tf32(False)
    spatial = (48, 32, 16)
    keys = ("unet_3D", "attention_unet", "voxresnet", "vnet", "vnet_groupnorm",
            "vnet_instancenorm", "vnet_ds", "dualdecoder", "resvnet",
            "unet_3D_dv_semi")
    res = {"forward_max_abs_err": {}, "stats_max_abs_err": {}, "step": {},
           "bf16": {}}
    gen = torch.Generator().manual_seed(21)
    for key in keys:
        torch.manual_seed(7)
        cpu = small_zoo(key)
        card = small_zoo(key).cuda()
        card.load_state_dict(cpu.state_dict())
        x = torch.randn((2, 1, *spatial), generator=gen)
        drop_u = [torch.rand(s, generator=gen) for s in cpu.dropout_shapes(2, spatial)]
        err = stats_err = 0.0
        for train in (False, True):
            cpu.train(train)
            card.train(train)
            s_cpu, s_card = {}, {}
            with torch.no_grad():
                o_cpu = _flat(cpu(x, drop_u=drop_u, stats=s_cpu))
                o_card = _flat(card(x.cuda(), drop_u=[u.cuda() for u in drop_u],
                                    stats=s_card))
            res["bf16"].setdefault(key, {})[f"train={train}"] = zoo_bf16_parity(
                key, cpu, card, x, drop_u, o_cpu)
            check(len(o_cpu) == len(o_card), f"{key} outputs")
            for a, b in zip(o_card, o_cpu):
                e = float((a.cpu() - b).abs().max())
                check(e <= zoo_tol(b), f"zoo parity {key} (train={train}): {e}")
                err = max(err, e)
            check(set(s_cpu) == set(s_card), f"{key} BN statistics keys")
            for k in s_cpu:
                for a, b in zip(s_card[k], s_cpu[k]):
                    e = float((a.cpu() - b).abs().max())
                    check(e <= zoo_tol(b), f"zoo BN statistics {key} {k}: {e}")
                    stats_err = max(stats_err, e)
        res["forward_max_abs_err"][key] = err
        res["stats_max_abs_err"][key] = stats_err
    cfg = brats_config(F32)
    cfg.data.patch_size_3d = (32, 32, 16)
    for key, outputs in ZOO_OUTPUTS.items():
        torch.manual_seed(8)
        cpu = small_zoo(key)
        card = small_zoo(key).cuda()
        card.load_state_dict(cpu.state_dict())
        batch = phantom_patches(cfg, 40, "cpu")
        draws = {"drop": [torch.rand(s, generator=gen)
                          for s in cpu.dropout_shapes(4, cfg.data.patch_size_3d)]}
        metrics = []
        for model, dev in ((cpu, "cpu"), (card, "cuda")):
            opt = make_optimizer(model, cfg.optim.base_lr, cfg.optim.momentum,
                                 cfg.optim.weight_decay)
            step = build_supervised3d_train_step(model, opt, cfg, device=dev)
            before = launch_counts()
            out = step(create_train_state(model, opt),
                       batch if dev == "cpu" else to_cuda(batch),
                       draws=draws if dev == "cpu" else to_cuda(draws))
            metrics.append(float(out.metrics["loss"]))
            ran = launches_since(before)
        check(ran == supervised_launches(outputs),
              f"{key} supervised step on the card: {ran} launches")
        check(math.isclose(metrics[1], metrics[0], rel_tol=RTOL, abs_tol=1e-6),
              f"{key} supervised step loss card {metrics[1]} vs cpu {metrics[0]}")
        res["step"][key] = {"loss_card": metrics[1], "loss_cpu": metrics[0],
                            "launches": ran}
    for key in ("vnet_ds", "resvnet"):
        model = small_zoo(key).cuda()
        try:
            build_supervised3d_train_step(model, make_optimizer(model, 0.01), cfg,
                                          device="cuda")
            refused = False
        except ValueError as e:
            refused = key in str(e)
        check(refused, f"the supervised step refuses {key}")
    res["settings"] = tf32_settings()
    print("parity_zoo3d", json.dumps(res), flush=True)
    return res


def zoo_bf16_parity(key, cpu, card, x, drop_u, o_cpu32) -> list:
    """One forward of a phase 18 model pair in bf16 (the configs' dtype):
    every output of the card within 2x the CPU's own bf16-vs-float32 gap of
    the CPU's bf16 output; bf16 outputs, float32 BatchNorm statistics. The
    pair goes back to float32 after."""
    out = []
    try:
        for m in (cpu, card):
            set_compute_dtype(m, torch.bfloat16)
        s_cpu, s_card = {}, {}
        with torch.no_grad():
            o_cpu = _flat(cpu(x, drop_u=drop_u, stats=s_cpu))
            o_card = _flat(card(x.cuda(), drop_u=[u.cuda() for u in drop_u],
                                stats=s_card))
        for a, b, b32 in zip(o_card, o_cpu, o_cpu32):
            check(a.dtype == b.dtype == torch.bfloat16, f"{key} bf16 output dtype")
            gap = float((b.float() - b32).abs().max())
            diff = float((a.float().cpu() - b.float()).abs().max())
            check(diff <= 2 * gap + 1e-6, f"zoo bf16 parity {key}: card {diff} from "
                                          f"the CPU, the CPU's bf16 gap {gap}")
            out.append([diff, gap])
        check(all(t.dtype == torch.float32 for pair in s_card.values()
                  for t in pair), f"{key} bf16 BatchNorm statistics are float32")
    finally:
        for m in (cpu, card):
            set_compute_dtype(m, torch.float32)
    return out


def make_zoo_step(key, cfg, seed=1337):
    torch.manual_seed(seed)
    model = net_factory_3d(key, cfg.data.in_chns, cfg.data.num_classes, "train",
                           cfg.model, device="cuda")
    opt = make_optimizer(model, cfg.optim.base_lr, cfg.optim.momentum,
                         cfg.optim.weight_decay)
    return (create_train_state(model, opt),
            build_supervised3d_train_step(model, opt, cfg, device="cuda"))


def phase_slice_zoo3d() -> dict:
    """The supervised step at configs/brats_supervised.yml's values (96^3,
    batch 4, 2 classes, fp32 by override, random weights from a seed) on
    phantom patches for unet_3D (the BraTS model), attention_unet and
    unet_3D_dv_semi at their factory widths: 1 warm-up and 3 timed steps,
    launches per step asserted, peak memory; torch.profiler over 1 unet_3D
    step by kernel class."""
    set_tf32(True)     # PyTorch's defaults, as in phase 12
    cfg = brats_config(F32)
    batches = [phantom_patches(cfg, 50 + i, "cuda") for i in range(5)]
    gen = torch.Generator(device="cuda").manual_seed(1337)
    out = {}
    for key in ("unet_3D", "attention_unet", "unet_3D_dv_semi"):
        state, step = make_zoo_step(key, cfg)
        step(state, batches[0], gen)              # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launch_counts()
        times, losses = [], []
        for batch in batches[1:4]:
            t0 = time.perf_counter()
            m = step(state, batch, gen).metrics
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
        launches = launch_counts()
        want = {k: 3 * v for k, v in supervised_launches(ZOO_OUTPUTS[key]).items()}
        check(launches == want, f"{key} launches over 3 steps {launches}, "
                                f"expected {want}")
        check(all(math.isfinite(v) for v in losses), f"finite {key} losses {losses}")
        res = {"step_ms": times, "median_step_ms": statistics.median(times),
               "patches_per_s": 1e3 * cfg.data.batch_size / statistics.median(times),
               "peak_mem_bytes": torch.cuda.max_memory_allocated(),
               "launches": launches, "losses": losses,
               "params": sum(p.numel() for p in state.model.parameters()),
               "conv_tflop_forward": conv_flop(
                   state.model, batches[0]["image"]) / 1e12,
               "batch": cfg.data.batch_size, "patch": list(BRATS_PATCH),
               "settings": tf32_settings(), "card": card_line()}
        print("slice_zoo3d", key, json.dumps(res), flush=True)
        if key == "unet_3D":
            res["profile"] = phase_profile(state, step, batches[4:5], gen,
                                           tag="profile_zoo3d")
            res["launches_main"] = launches
        out[key] = res
        del state, step
        torch.cuda.empty_cache()
    return out


def phase_k3_brats() -> dict:
    """K3 at the BraTS eval's shape, one output (logits2 None, unet_3D's
    path): 2x2x2 patches of 96^3 at stride 64 over a 160x160x128 volume, one
    batch of 8, against its plain version as phase 10 holds it; timed."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    shape, c = (160, 160, 128), 2
    starts = sw.compute_grid(shape, BRATS_PATCH, 64, 64)
    check(len(starts) == 8, f"BraTS grid of {len(starts)} patches")
    l1 = torch.randn((8, c, *BRATS_PATCH), generator=gen, device="cuda") * 3
    maps = [(torch.zeros((c, *shape), device="cuda"),
             torch.zeros(shape, device="cuda")) for _ in range(3)]
    sw.sw_accumulate_kernel(l1, None, starts, *maps[0])
    sw.sw_accumulate_kernel(l1, None, starts, *maps[1])
    sw.sw_accumulate_plain(l1, None, starts, *maps[2])
    torch.cuda.synchronize()
    (ks, kc), (rs_, rc), (ps, pc) = maps
    check(torch.equal(ks, rs_) and torch.equal(kc, rc), "K3 BraTS bit-identical")
    check(torch.equal(kc, pc), "K3 BraTS count equals the plain version's")
    err = rel_err(ks, ps)
    check(err <= 1e-6, f"K3 BraTS score within 1e-6 of the plain version: {err}")
    score, cnt = maps[0]
    lo, size = sw.batch_box(starts, BRATS_PATCH)
    box = math.prod(size)
    res = {"patches": len(starts), "batch": 8, "classes": c, "box": size,
           "max_abs_err": float((ks - ps).abs().max()), "rel_err": err,
           # logits read once; score and count read and written over the box
           "bound": bound_ms(l1.numel() * 4 + 2 * (c + 1) * box * 4,
                             8 * l1.numel()),
           **timings(lambda: sw.sw_accumulate_kernel(l1, None, starts, score, cnt),
                     n=20),
           "plain_ms": device_ms(lambda: sw.sw_accumulate_plain(
               l1, None, starts, score, cnt), n=5, warmup=1)}
    print("K3 brats_160x160x128", json.dumps(res), flush=True)
    return res


def phase_slice_bf16() -> dict:
    """configs/la_chap.yml, configs/pancreas_chap.yml and
    configs/brats_supervised.yml as written, no override (bf16 compute over
    float32 parameters): the CHAP step of the DualDecoder3d (nf 16) at the
    LA patch 112x112x80 and the Pancreas patch 96^3, and the unet_3D
    supervised step at 96^3, each at batch 4 = 2 + 2 on bf16 phantom patches
    (the pool's dtype), random weights from a seed: 1 warm-up and 3 timed
    steps, launches per step asserted with every K1 launch at bf16 logits,
    peak memory; torch.profiler over 1 LA step and 1 unet_3D step, which
    must show bf16 convolution kernels (their share of the convolution time
    is reported). The float32 steps of phases 12 and 19 stand beside
    these."""
    set_tf32(True)
    out = {}
    jobs = [("la_chap", "configs/la_chap.yml"),
            ("pancreas_chap", "configs/pancreas_chap.yml"),
            ("brats_supervised", BRATS_CFG)]
    for name, path in jobs:
        cfg = load_config(path)
        check(cfg.model.dtype == "bfloat16", f"{path} asks for bf16")
        cfg.data.patch_size_3d = cli_train3d.PROTOCOLS[cfg.data.dataset]["patch"]
        if name == "brats_supervised":
            state, step = make_zoo_step(cfg.model.name_3d, cfg)
            per_step = supervised_launches(1)
        else:
            state, step = make_step_3d(cfg, "cuda", seed=1337)
            per_step = LAUNCHES_PER_STEP_3D
        batches = []
        for i in range(5):
            b = phantom_patches(cfg, 60 + i, "cuda")
            batches.append({"image": b["image"].bfloat16(), "label": b["label"]})
        gen = torch.Generator(device="cuda").manual_seed(1337)
        step(state, batches[0], gen)             # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launch_counts()
        times, losses = [], []
        for batch in batches[1:4]:
            t0 = time.perf_counter()
            m = step(state, batch, gen).metrics
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
        launches = launch_counts()
        bf16 = check_all_bf16(f"the {name} step")
        want = {k: 3 * v for k, v in per_step.items()}
        check(launches == want, f"{name} launches over 3 steps {launches}, "
                                f"expected {want}")
        check(all(math.isfinite(v) for v in losses), f"finite {name} losses {losses}")
        res = {"config": path, "dtype": cfg.model.dtype,
               "model": "dualdecoder" if name != "brats_supervised" else
               cfg.model.name_3d, "patch": list(cfg.data.patch_size_3d),
               "batch": cfg.data.batch_size, "step_ms": times,
               "median_step_ms": statistics.median(times),
               "patches_per_s": 1e3 * cfg.data.batch_size / statistics.median(times),
               "peak_mem_bytes": torch.cuda.max_memory_allocated(),
               "launches": launches, "launches_bf16": bf16, "losses": losses,
               "params_dtype": str(next(state.model.parameters()).dtype),
               "settings": tf32_settings(), "card": card_line()}
        print("slice_bf16", name, json.dumps(res), flush=True)
        if name != "pancreas_chap":
            prof = phase_profile(state, step, batches[4:5], gen,
                                 tag=f"profile_bf16_{name}")
            conv = prof["ms_per_step_by_class"].get("conv", 0.0)
            check(prof["conv_bf16_ms_per_step"] > 0,
                  f"{name}: the profile shows bf16 convolution kernels "
                  f"({prof['conv_bf16_ms_per_step']} of {conv} ms)")
            res["profile"] = prof
            res["conv_bf16_share"] = prof["conv_bf16_ms_per_step"] / conv
        out[name] = res
        del state, step, batches
        torch.cuda.empty_cache()
    return out


SHARE_KEYS = ("loss", "model1_loss", "model2_loss", "dis_loss", "acal_f_loss",
              "dis_loss_g")


def small_2d(cfg):
    """A config cut to the parity phases' size: feature_chns (4, 8, 16, 16,
    32), batch 8 = 4 + 4 at 32^2."""
    cfg.model.feature_chns = (4, 8, 16, 16, 32)
    cfg.data.batch_size, cfg.data.labeled_bs = 8, 4
    cfg.data.image_size = (32, 32)
    return cfg


def share_bf16_parity() -> dict:
    """The ACAL iteration (joint step, decoder max-step, encoder min-step,
    mse discrepancy) and the ablation step (channel dropout and VAT on) in
    bf16 (model.dtype=bfloat16) on the card and on the CPU, from the same
    weights and draws on three batches (their images in bf16), at the
    parity phases' size, TF32 off: the card's metrics against the CPU's
    bf16 ones, each path's as one vector, within 2x the CPU's own
    bf16-vs-float32 gap on the same batches; every K1 launch at bf16
    logits (2 + 2 joint, 2 + 2 max, 0 min, 2 + 2 ablation)."""
    set_tf32(False)
    res = {}
    for path in ("acal", "ablation"):
        if path == "acal":
            cfgs = {dt: small_2d(load_config(ACAL_CFG, [f"model.dtype={dt}"]))
                    for dt in ("float32", "bfloat16")}
        else:
            cfgs = {dt: small_2d(acdc_chap_config()) for dt in ("float32", "bfloat16")}
            cfgs["bfloat16"].model.dtype = "bfloat16"
        cfg32 = cfgs["float32"]
        torch.manual_seed(0)
        init = {k: v.clone() for k, v in net_factory(
            cfg32.model.name, 1, cfg32.data.num_classes, cfg32.model,
            device="cpu").state_dict().items()}
        mask = torch.zeros(4, 32, 32)
        mask[:, 8:24, 4:20] = 1.0
        runs = {"cpu_f32": [], "cpu_bf16": [], "card_bf16": []}
        zero_launch_counts()
        for seed in (1, 2, 3):
            batch = phantom_inputs(cfg32, seed, "cpu")
            shape = batch["image"].shape
            if path == "acal":
                draws = [draw_supervised_uniforms(
                    cfg32, shape, torch.Generator().manual_seed(10 * seed + i),
                    "cpu") for i in range(3)]
            else:
                draws = draw_ablation_uniforms(
                    cfg32, shape, torch.Generator().manual_seed(10 * seed), "cpu")
            for name, dt, dev in (("cpu_f32", "float32", "cpu"),
                                  ("cpu_bf16", "bfloat16", "cpu"),
                                  ("card_bf16", "bfloat16", "cuda")):
                cfg = cfgs[dt]
                b = {"image": batch["image"].to(torch.bfloat16 if dt == "bfloat16"
                                                else torch.float32),
                     "label": batch["label"]}
                m, d = mask, draws
                if dev == "cuda":
                    b, m, d = to_cuda(b), to_cuda(mask), to_cuda(draws)
                if path == "acal":
                    state, joint, dec, enc = make_share(cfg, dev, state_dict=init)
                    out = dict(joint(state, b, draws=d[0])[1])
                    out.update(dec(state, b["image"], b["label"], m, draws=d[1])[1])
                    out.update(enc(state, b["image"], m, draws=d[2])[1])
                    keys = SHARE_KEYS
                else:
                    model = net_factory(cfg.model.name, 1, cfg.data.num_classes,
                                        cfg.model, device=dev)
                    model.load_state_dict(init)
                    opt = make_optimizer(model, cfg.optim.base_lr,
                                         cfg.optim.momentum, cfg.optim.weight_decay)
                    state = create_train_state(model, opt, cfg.model.feature_chns)
                    out = build_ablation_train_step(model, opt, cfg, device=dev)(
                        state, b, draws=d).metrics
                    keys = ABLATION_METRICS
                runs[name].append([float(out[k]) for k in keys])
        ran = launch_counts()
        want = {**{k: 0 for k in ran}, "K1_fwd": 12 if path == "acal" else 6,
                "K1_bwd": 12 if path == "acal" else 6}
        check(ran == want, f"the card's bf16 {path} steps: {ran} launches, "
                           f"expected {want}")
        check_all_bf16(f"the card's bf16 {path} steps")
        cpu32, cpu16, card16 = (np.array(runs[k]) for k in ("cpu_f32", "cpu_bf16",
                                                            "card_bf16"))
        gap = float(np.abs(cpu16 - cpu32).max())
        diff = float(np.abs(card16 - cpu16).max())
        check(diff <= 2 * gap + 1e-6, f"bf16 {path} steps, card against CPU: "
                                      f"{diff}, the CPU's bf16-vs-float32 gap {gap}")
        res[path] = {"card_vs_cpu": diff, "cpu_bf16_vs_f32": gap,
                     "metrics": list(keys), **runs}
    print("parity_bf16_share", tf32_settings(), json.dumps(res), flush=True)
    return res


def phase_slice_bf16_share() -> dict:
    """Phase 21's companion for the ACAL and ablation paths, which no
    shipped config runs in bf16: configs/acdc_share_acal.yml (with semi.acal
    on) and configs/acdc_chap.yml with model.dtype=bfloat16 as an override,
    at full width (widths 16-256, batch 24 = 12 + 12 at 256^2) on bf16
    phantom batches, random weights from a seed. First ``share_bf16_parity``
    at a small width. Then the ACAL iteration (joint step, bank feed from
    the bf16 knowledge map, replay pair on [labeled ; replayed] in bf16) and
    the ablation step: 1 warm-up and 3 timed each, launches asserted with
    every K1 launch at bf16 logits, peak memory; torch.profiler over 1
    iteration / step, which must show bf16 convolution kernels. The float32
    figures of phase 15 stand beside these."""
    parity = share_bf16_parity()
    set_tf32(True)
    cfg = load_config(ACAL_CFG, ["model.dtype=bfloat16"])
    cfg.semi.acal = True
    lbs, n_u = cfg.data.labeled_bs, cfg.data.batch_size - cfg.data.labeled_bs
    state, joint, dec, enc = make_share(cfg, "cuda", seed=1337)
    bank = ImageMemoryBank(cfg.semi.mb_capacity, cfg.data.image_size,
                           cfg.semi.mb_patch_size, seed=cfg.run.seed)
    batches = [phantom_inputs(cfg, 70 + i, "cuda") for i in range(5)]
    for b in batches:
        b["image"] = b["image"].bfloat16()
    gen = torch.Generator(device="cuda").manual_seed(1337)
    parts = {"joint": [], "feed": [], "replay": []}
    dtypes = set()

    def iteration(state, i, gen, timed=False):
        t0 = time.perf_counter()
        state, m, knowledge = joint(state, batches[i], gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        bank.add(batches[i]["image"][lbs:].cpu(), knowledge.cpu(), 8)
        t2 = time.perf_counter()
        replay = to_device(bank.get_samples(n_u), torch.device("cuda"))
        image = torch.cat([batches[i]["image"][:lbs],
                           replay["image"].to(batches[i]["image"].dtype)])
        dtypes.update({str(knowledge.dtype), str(image.dtype)})
        state, f = dec(state, image, batches[i]["label"], replay["mask"], gen)
        state, g = enc(state, image, replay["mask"], gen)
        torch.cuda.synchronize()
        if timed:
            parts["joint"].append((t1 - t0) * 1e3)
            parts["feed"].append((t2 - t1) * 1e3)
            parts["replay"].append((time.perf_counter() - t2) * 1e3)
        return {k: float(v) for k, v in {**m, **f, **g}.items()}

    iteration(state, 0, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    metrics = [iteration(state, i, gen, timed=True) for i in range(1, 4)]
    launches = launch_counts()
    bf16 = check_all_bf16("the bf16 ACAL iterations")
    want = {**{k: 0 for k in launches}, "K1_fwd": 12, "K1_bwd": 12}
    check(launches == want, f"bf16 ACAL launches over 3 iterations {launches}, "
                            f"expected {want}")
    check(dtypes == {"torch.bfloat16"}, f"bf16 knowledge map and replay batch: {dtypes}")
    for m in metrics:
        check(all(math.isfinite(v) for v in m.values()), f"finite bf16 ACAL {m}")
    acal = {"config": ACAL_CFG + " model.dtype=bfloat16", "joint_ms": parts["joint"],
            "feed_ms": parts["feed"], "replay_pair_ms": parts["replay"],
            "median_iteration_ms": statistics.median(
                [a + b + c for a, b, c in zip(*parts.values())]),
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "launches": launches, "launches_bf16": bf16,
            "last_metrics": metrics[-1], "settings": tf32_settings(),
            "card": card_line()}
    print("slice_bf16_share acal", json.dumps(acal), flush=True)
    prof = phase_profile(state, iteration, [4], gen, tag="profile_bf16_acal")
    check(prof["conv_bf16_ms_per_step"] > 0,
          f"bf16 ACAL: the profile shows bf16 convolution kernels {prof}")
    acal["profile"] = prof
    del state, joint, dec, enc, batches
    torch.cuda.empty_cache()

    cfg = acdc_chap_config()
    cfg.model.dtype = "bfloat16"
    torch.manual_seed(1337)
    model = net_factory(cfg.model.name, cfg.data.in_chns, cfg.data.num_classes,
                        cfg.model, device="cuda")
    opt = make_optimizer(model, cfg.optim.base_lr, cfg.optim.momentum,
                         cfg.optim.weight_decay)
    astate = create_train_state(model, opt, cfg.model.feature_chns)
    step = build_ablation_train_step(model, opt, cfg, device="cuda")
    abatches = [phantom_inputs(cfg, 80 + i, "cuda") for i in range(5)]
    for b in abatches:
        b["image"] = b["image"].bfloat16()
    step(astate, abatches[0], gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    times, ametrics = [], []
    for batch in abatches[1:4]:
        t0 = time.perf_counter()
        out = step(astate, batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        ametrics.append({k: float(v) for k, v in out.metrics.items()})
    alaunches = launch_counts()
    abf16 = check_all_bf16("the bf16 ablation steps")
    want = {k: 3 * v for k, v in ABLATION_LAUNCHES_PER_STEP.items()}
    check(alaunches == want, f"bf16 ablation launches {alaunches}, expected {want}")
    for m in ametrics:
        check(all(math.isfinite(v) for v in m.values()), f"finite bf16 ablation {m}")
    ablation = {"config": "configs/acdc_chap.yml model.dtype=bfloat16",
                "step_ms": times, "median_step_ms": statistics.median(times),
                "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                "launches": alaunches, "launches_bf16": abf16,
                "last_metrics": ametrics[-1], "settings": tf32_settings()}
    print("slice_bf16_share ablation", json.dumps(ablation), flush=True)
    prof = phase_profile(astate, step, abatches[4:5], gen,
                         tag="profile_bf16_ablation")
    check(prof["conv_bf16_ms_per_step"] > 0,
          f"bf16 ablation: the profile shows bf16 convolution kernels {prof}")
    ablation["profile"] = prof
    del astate, step, model, opt, abatches
    torch.cuda.empty_cache()
    return {"parity": parity, "acal": acal, "ablation": ablation}


def phase_k3_bf16() -> dict:
    """K3's bf16-logits instantiation (a bf16 model's eval) against its
    plain version on the same bf16 logits: the LA eval's whole grid of 80
    patches of 112x112x80 in a 160x160x96 volume, two outputs, in batches of
    16; and the BraTS eval's batch of 8 patches of 96^3 over a 160x160x128
    volume, one output. Score within 1e-5 absolute, count exact, two runs
    bit-identical; one batch of each timed, its bound from the bf16 bytes."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    cases = {"la_160x160x96": ((160, 160, 96), LA_PATCH, 18, 4, 16, 2),
             "brats_160x160x128": ((160, 160, 128), BRATS_PATCH, 64, 64, 8, 1)}
    out = {}
    for name, (shape, patch, sxy, sz, bs, outputs) in cases.items():
        c = 2
        starts = sw.compute_grid(shape, patch, sxy, sz)
        maps = [(torch.zeros((c, *shape), device="cuda"),
                 torch.zeros(shape, device="cuda")) for _ in range(3)]
        launches_before = sw.sw_accumulate_kernel.launches_bf16
        for i in range(0, len(starts), bs):
            st = starts[i:i + bs]
            ls = [(torch.randn((len(st), c, *patch), generator=gen, device="cuda")
                   * 3).bfloat16() for _ in range(outputs)]
            l1, l2 = ls[0], (ls[1] if outputs == 2 else None)
            sw.sw_accumulate_kernel(l1, l2, st, *maps[0])
            sw.sw_accumulate_kernel(l1, l2, st, *maps[1])
            sw.sw_accumulate_plain(l1, l2, st, *maps[2])
        torch.cuda.synchronize()
        n_calls = 2 * -(-len(starts) // bs)
        check(sw.sw_accumulate_kernel.launches_bf16 - launches_before == n_calls,
              f"K3 bf16 instantiation launched for {name}")
        (ks, kc), (rs_, rc), (ps, pc) = maps
        check(torch.equal(ks, rs_) and torch.equal(kc, rc),
              f"K3 bf16 bit-identical on repeat ({name})")
        check(torch.equal(kc, pc), f"K3 bf16 count equals the plain version's ({name})")
        err = float((ks - ps).abs().max())
        check(err <= 1e-5, f"K3 bf16 score within 1e-5 of the plain version "
                           f"({name}): {err}")
        st = starts[:bs]
        ls = [(torch.randn((len(st), c, *patch), generator=gen, device="cuda")
               * 3).bfloat16() for _ in range(outputs)]
        l1, l2 = ls[0], (ls[1] if outputs == 2 else None)
        score, cnt = (torch.zeros((c, *shape), device="cuda"),
                      torch.zeros(shape, device="cuda"))
        lo, size = sw.batch_box(st, patch)
        box = math.prod(size)
        logit_bytes = outputs * l1.numel() * l1.element_size()
        res = {"patches": len(starts), "batch": bs, "outputs": outputs,
               "classes": c, "box": size, "max_abs_err": err,
               # the bf16 logits read once; score and count read and
               # written over the box; about 8 operations a class a voxel
               "bound": bound_ms(logit_bytes + 2 * (c + 1) * box * 4,
                                 8 * l1.numel()),
               "logit_bytes": logit_bytes, "map_bytes": 2 * (c + 1) * box * 4,
               **timings(lambda: sw.sw_accumulate_kernel(l1, l2, st, score, cnt),
                         n=20),
               "plain_ms": device_ms(lambda: sw.sw_accumulate_plain(
                   l1, l2, st, score, cnt), n=5, warmup=1)}
        print("K3_bf16", name, json.dumps(res), flush=True)
        out[name] = res
    return out


def phase_trainer_zoo3d() -> dict:
    """cli.train_3d --cfg configs/brats_supervised.yml --method supervised
    --dataset synthetic (unet_3D, 96^3 by override, bf16 as written): 4
    steps, --resume to 6, 1 / 1 K1 a step at bf16 logits; then
    test_all_case on the run's latest weights over 2 synthetic volumes of
    160x160x128 at the BraTS protocol (stride 64, sw_batch 8) with the model
    in bf16 and, from the same parameters, in float32, K3 launches (bf16,
    then float32) equal to the patch batches, and cli.test_3d --model
    unet_3D over its 2 synthetic volumes, K3 once per patch batch."""
    set_tf32(True)
    shutil.rmtree(RUNS_DIR, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()

    def run(flags, steps):
        zero_launch_counts()
        t0 = time.perf_counter()
        out = cli_train3d.main(ZOO_TRAINER_FLAGS + flags + ZOO_TRAINER_OVERRIDES)
        wall_s = time.perf_counter() - t0
        launches = launch_counts()
        want = {k: v * steps for k, v in supervised_launches(1).items()}
        check(launches == want, f"BraTS trainer launches {launches}, expected {want}")
        bf16 = check_all_bf16("the BraTS trainer on configs/brats_supervised.yml")
        records = _records(out["save_dir"])
        check(all(math.isfinite(r["loss"]) for r in records if "loss" in r),
              "finite BraTS trainer losses")
        return {**out, "wall_s": wall_s, "launches": launches,
                "launches_bf16": bf16, "records": records}

    first = run(["--max_iterations", "4"], 4)
    save_dir = first["save_dir"]
    check(first["steps"] == 4 and save_dir.endswith(os.path.join("unet_3D", "run_0")),
          f"the BraTS run dir is named after the model: {save_dir}")
    resumed = run(["--max_iterations", "6", "--resume"], 2)
    check(resumed["save_dir"] == save_dir and resumed["steps"] == 6,
          f"resume continues the BraTS run to step 6: {resumed['steps']}")
    check([r["step"] for r in resumed["records"] if "loss" in r] == [2, 4, 6],
          "BraTS log steps 2, 4 before and 6 after the resume")
    peak = torch.cuda.max_memory_allocated()
    cfg = brats_config()
    model = net_factory_3d("unet_3D", 1, 2, "test", cfg.model, device="cuda")
    CheckpointManager(save_dir).restore(
        "latest", create_train_state(model, make_optimizer(model, 0.01)))
    vols = SyntheticVolumeDataset((128, 160, 160), 2, length=2, seed=6)
    cases = [{"image": vols[i]["image"].transpose(2, 1, 0),
              "label": vols[i]["label"].transpose(2, 1, 0),
              "case": vols[i]["case"]} for i in range(2)]
    n_batches = sum(-(-len(sw.compute_grid(c["image"].shape, BRATS_PATCH, 64, 64))
                      // cfg.eval.sw_batch) for c in cases)
    torch.cuda.synchronize()
    zero_launch_counts()
    t0 = time.perf_counter()
    metrics = sw.test_all_case(model, cases, 2, BRATS_PATCH, 64, 64,
                               sw_batch=cfg.eval.sw_batch, device="cuda")
    eval_s = time.perf_counter() - t0
    k3 = check_all_bf16("BraTS test_all_case with the bf16 model")["K3_sw"]
    check(k3 == n_batches, f"BraTS test_all_case launched K3 {k3} times for "
                           f"{n_batches} patch batches")
    check(np.isfinite(metrics).all() and metrics.shape == (1, 2),
          f"BraTS test_all_case metrics {metrics}")
    model32 = net_factory_3d("unet_3D", 1, 2, "test", brats_config(F32).model,
                             device="cuda")
    model32.load_state_dict(model.state_dict())
    zero_launch_counts()
    t0 = time.perf_counter()
    metrics32 = sw.test_all_case(model32, cases, 2, BRATS_PATCH, 64, 64,
                                 sw_batch=cfg.eval.sw_batch, device="cuda")
    eval32_s = time.perf_counter() - t0
    k3_32 = launch_counts()["K3_sw"]
    check(k3_32 == n_batches and bf16_launch_counts()["K3_sw"] == 0,
          f"float32 BraTS test_all_case launched K3 {k3_32} times, none in bf16")
    check(np.isfinite(metrics32).all(), f"float32 BraTS metrics {metrics32}")
    engine = sw.SlidingWindowEngine(model, BRATS_PATCH, cfg.eval.sw_batch,
                                    device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.predict_async(cases[0]["image"], 64, 64, 2)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    # cli.test_3d's synthetic cases: 2 volumes of 112x112x96 at the LA
    # protocol (112x112x80, stride 18/4): 5 patches, one batch of 8 each
    test_batches = 2 * -(-len(sw.compute_grid((112, 112, 96), LA_PATCH, 18, 4)) // 8)
    zero_launch_counts()
    t0 = time.perf_counter()
    test_metrics = cli_test3d.main(["--dataset", "synthetic", "--snapshot", save_dir,
                                    "--ckpt", "latest", "--model", "unet_3D",
                                    "--device", "cuda"])
    test_s = time.perf_counter() - t0
    test_k3 = check_all_bf16("cli.test_3d on the bf16 BraTS run")["K3_sw"]
    check(test_k3 == test_batches, f"cli.test_3d launched K3 {test_k3} times for "
                                   f"{test_batches} patch batches")
    check(test_metrics.shape == (1, 4) and np.isfinite(test_metrics[:, 0]).all(),
          f"cli.test_3d metrics {test_metrics}")

    def rates(r):
        return [x["steps_per_sec"] for x in r["records"] if "steps_per_sec" in x]
    res = {
        "card": card_line(), "model": "unet_3D", "patch": list(BRATS_PATCH),
        "batch": cfg.data.batch_size,
        "window_steps_per_s": {"first_4": rates(first), "resumed_2": rates(resumed)},
        "checkpoint_ms": [r["checkpoint_ms"] for r in resumed["records"]
                          if "checkpoint_ms" in r],
        "eval_volumes": [list(c["image"].shape) for c in cases],
        "eval_patch_batches": n_batches, "eval_s_per_volume": eval_s / len(cases),
        "eval_f32_s_per_volume": eval32_s / len(cases), "dtype": cfg.model.dtype,
        "eval_f32_dice_hd95": metrics32[0].tolist(),
        "predict_s_per_volume": predict_s, "eval_dice_hd95": metrics[0].tolist(),
        "test_3d_s": test_s, "test_3d_k3": test_k3,
        "test_3d_mean": test_metrics.mean(axis=0).tolist(), "peak_mem_bytes": peak,
        "wall_s": {"first_4": first["wall_s"], "resumed_2": resumed["wall_s"]},
        "launches": {"first_4": first["launches"], "resumed_2": resumed["launches"],
                     "test_all_case": k3, "test_all_case_f32": k3_32,
                     "test_3d": test_k3},
        "launches_bf16": {"first_4": first["launches_bf16"],
                          "resumed_2": resumed["launches_bf16"]},
        "settings": tf32_settings()}
    print("trainer_zoo3d", json.dumps(res), flush=True)
    shutil.rmtree(RUNS_DIR, ignore_errors=True)
    return res


# ---------------------------------------------------------------------------
# phase 23: data parallelism (chap_tpu_torch/parallel/dist.py)
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 24: the 2D zoo
# ---------------------------------------------------------------------------

ZOO2D_SINGLE = ("unet", "resunet", "swinunet", "enet", "pnet", "efficient_unet")
ZOO2D_SEVERAL = ("unetp", "unet_cct", "unet_urpc", "dual_student")
ZOO2D_CHNS = (4, 8, 16, 16, 32)
ZOO2D_SWIN = dict(img_size=64, embed_dim=12, depths=(2, 2, 2),
                  num_heads=(2, 4, 8), window_size=4)
ZOO2D_RUNS = os.path.join(RUNS_DIR, "zoo2d")


def small_zoo2d(key: str):
    """Each 2D net_factory key's model at a small width (the UNet family at
    feature_chns (4, 8, 16, 16, 32), PNet at 8 filters, DSNet's projection
    at 16, SwinUNet at img_size 64) or at its fixed width (ResUNet, ENet,
    EfficientUNet-b0), and its input side."""
    ch = ZOO2D_CHNS
    return {"unet": (lambda: UNet(1, 4, ch), 32),
            "unetp": (lambda: UNetPlus(1, 4, ch), 32),
            "unet_cct": (lambda: UNetCCT(1, 4, ch), 32),
            "unet_urpc": (lambda: UNetURPC(1, 4, ch), 32),
            "resunet": (lambda: ResUNet2d(1, 4), 32),
            "dual_student": (lambda: DSNet(1, 4, project_dim=16), 32),
            "swinunet": (lambda: SwinUNet(1, 4, **ZOO2D_SWIN), 64),
            "enet": (lambda: ENet(1, 4), 32),
            "pnet": (lambda: PNet2D(1, 4, 8), 32),
            "efficient_unet": (lambda: EffiUNet(1, 4), 64)}[key]


def zoo2d_draws(model, rows: int, side: int, gen, device) -> dict:
    """A train pass's uniforms at the model's own shapes: drop_u, and
    perturb_u for CCT and URPC."""
    kw = {"drop_u": [torch.rand(s, generator=gen).to(device)
                     for s in model.dropout_shapes(rows, (side, side))]}
    if hasattr(model, "perturb_shapes"):
        kw["perturb_u"] = [torch.rand(s, generator=gen).to(device)
                           for s in model.perturb_shapes(rows, (side, side))]
    return kw


class FedPerturb(torch.nn.Module):
    """A model whose eval forward takes fixed perturbation draws (CCT
    perturbs in eval mode too), so a predictor on the card and one on the
    CPU see the same."""

    def __init__(self, model, perturb_u):
        super().__init__()
        self.model, self.perturb_u = model, perturb_u

    def forward(self, x):
        return self.model(x, perturb_u=self.perturb_u)


def zoo2d_predictor_parity(gen) -> dict:
    """(a)'s predictors card against CPU, from the same weights: the
    logit-ensemble predictor and the ds predictor on every key (CCT with
    fixed perturbations), the adv predictor (encoder, then each decoder)
    on a DualDecoder, test_single_volume_polyp and test_single_adv_polyp:
    label maps within 0.1% of pixels, the polyp Dice within 1e-3."""
    res = {}
    for key in ZOO2D_SINGLE + ZOO2D_SEVERAL:
        torch.manual_seed(31)
        make, side = small_zoo2d(key)
        cpu, card = make(), make().cuda()
        card.load_state_dict(cpu.state_dict())
        if key == "unet_cct":
            pert = zoo2d_draws(cpu, 4, side, gen, "cpu")["perturb_u"]
            cpu = FedPerturb(cpu, pert)
            card = FedPerturb(card, [u.cuda() for u in pert])
        x = torch.randn((4, 1, side, side), generator=gen)
        for kind, maker in (("logit_ensemble", lambda m, d: make_predictor(
                m, "logit_ensemble", device=d)),
                            ("ds", lambda m, d: make_ds_predictor(m, device=d))):
            got = maker(card, "cuda")(x).cpu()
            want = maker(cpu, "cpu")(x)
            agree = float((got == want).float().mean())
            check(agree >= 0.999, f"zoo2d {kind} predictor {key}: {agree}")
            res[f"{key}_{kind}_agree"] = agree
    x = torch.randn((4, 1, 32, 32), generator=gen)
    rs = np.random.RandomState(33)
    image = rs.rand(32, 32).astype(np.float32)
    label = (rs.rand(32, 32) > 0.5).astype(np.uint8)
    # the ACAL model (4 classes) for the adv predictor, a binary one for the
    # polyp protocol's F-measure
    for classes in (4, 2):
        torch.manual_seed(32)
        pair = [net_factory("dualdecoder", 1, classes,
                            small_2d(acdc_chap_config()).model, device=d)
                for d in ("cuda", "cpu")]
        pair[0].load_state_dict(pair[1].state_dict())
        card, cpu = pair
        for decoder in ("model1", "model2"):
            if classes == 4:
                got = make_adv_predictor(card, decoder, device="cuda")(x).cpu()
                want = make_adv_predictor(cpu, decoder, device="cpu")(x)
                agree = float((got == want).float().mean())
                check(agree >= 0.999, f"zoo2d adv predictor {decoder}: {agree}")
                res[f"adv_{decoder}_agree"] = agree
            else:
                dice = [test_single_adv_polyp(image, label, m, decoder, device=d)
                        for m, d in ((card, "cuda"), (cpu, "cpu"))]
                check(abs(dice[0] - dice[1]) <= 1e-3,
                      f"zoo2d adv polyp {decoder}: {dice}")
                res[f"adv_polyp_{decoder}_dice"] = dice
    dice = [test_single_volume_polyp(image, label,
                                     make_predictor(m, "logit_ensemble", device=d))
            for m, d in ((card, "cuda"), (cpu, "cpu"))]
    check(abs(dice[0] - dice[1]) <= 1e-3, f"zoo2d volume polyp: {dice}")
    res["volume_polyp_dice"] = dice
    return res


def phase_parity_zoo2d() -> dict:
    """(a) every 2D net_factory key but the dual decoder (phase 5's) at a
    small width on the card and on the CPU from the same weights and
    draws (TF32 off): every output in eval and train mode and the train
    pass's BatchNorm batch statistics at 5e-4 of the output's scale
    (zoo_tol), as phase 18; the predictors (zoo2d_predictor_parity)."""
    set_tf32(False)
    res = {"forward_max_abs_err": {}, "stats_max_abs_err": {}}
    gen = torch.Generator().manual_seed(30)
    for key in ZOO2D_SINGLE + ZOO2D_SEVERAL:
        torch.manual_seed(7)
        make, side = small_zoo2d(key)
        cpu, card = make(), make().cuda()
        card.load_state_dict(cpu.state_dict())
        x = torch.randn((2, 1, side, side), generator=gen)
        kw = zoo2d_draws(cpu, 2, side, gen, "cpu")
        kw_card = {k: [u.cuda() for u in v] for k, v in kw.items()}
        err = stats_err = 0.0
        for train in (False, True):
            cpu.train(train)
            card.train(train)
            s_cpu, s_card = {}, {}
            with torch.no_grad():
                o_cpu = _flat(cpu(x, stats=s_cpu, **kw))
                o_card = _flat(card(x.cuda(), stats=s_card, **kw_card))
            check(len(o_cpu) == len(o_card), f"{key} outputs")
            for a, b in zip(o_card, o_cpu):
                e = float((a.cpu() - b).abs().max())
                check(e <= zoo_tol(b), f"zoo2d parity {key} (train={train}): {e}")
                err = max(err, e)
            check(set(s_cpu) == set(s_card), f"{key} BN statistics keys")
            for k in s_cpu:
                for a, b in zip(s_card[k], s_cpu[k]):
                    e = float((a.cpu() - b).abs().max())
                    check(e <= zoo_tol(b), f"zoo2d BN statistics {key} {k}: {e}")
                    stats_err = max(stats_err, e)
        res["forward_max_abs_err"][key] = err
        res["stats_max_abs_err"][key] = stats_err
    res["predictors"] = zoo2d_predictor_parity(gen)
    res["settings"] = tf32_settings()
    print("parity_zoo2d", json.dumps(res), flush=True)
    return res


def zoo2d_config(key: str):
    """configs/acdc_chap.yml's values (batch 24, 4 classes, widths 16-256,
    fp32) at 256^2, or 224^2 for swinunet (its factory's img_size)."""
    cfg = acdc_chap_config()
    cfg.model.name = key
    if key == "swinunet":
        cfg.data.image_size = (224, 224)
    return cfg


def phase_slice_zoo2d() -> dict:
    """(b) at full width (zoo2d_config, TF32 on as PyTorch's default, random
    weights from a seed, phantom batches): the single-decoder supervised
    step of each single-output key, 1 warm-up and 3 timed steps, 1 K1
    forward and 1 backward a step asserted, step ms (median), peak memory;
    each key of several outputs refused by that step, and one train-mode
    and one eval-mode forward of it, its peak. Returns the figures, the K1
    launches of every timed step together, and the state of each key for
    (c)."""
    set_tf32(True)
    out = {"keys": {}, "states": {}}
    total = {k: 0 for k in launch_counts()}
    for key in ZOO2D_SINGLE + ZOO2D_SEVERAL:
        cfg = zoo2d_config(key)
        batches = [phantom_inputs(cfg, 60 + i, "cuda") for i in range(4)]
        gen = torch.Generator(device="cuda").manual_seed(1337)
        torch.manual_seed(1337)
        torch.cuda.reset_peak_memory_stats()
        model = net_factory(key, 1, 4, cfg.model, device="cuda")
        opt = make_optimizer(model, cfg.optim.base_lr, cfg.optim.momentum,
                             cfg.optim.weight_decay)
        state = create_train_state(model, opt)
        res = {"params": sum(p.numel() for p in model.parameters()),
               "batch": cfg.data.batch_size, "side": cfg.data.image_size[0]}
        if key in ZOO2D_SINGLE:
            step = build_supervised_train_step(model, opt, cfg, device="cuda")
            step(state, batches[0], gen)              # warm-up
            torch.cuda.synchronize()
            zero_launch_counts()
            times, losses = [], []
            for batch in batches[1:]:
                t0 = time.perf_counter()
                m = step(state, batch, gen).metrics
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(m["loss"]))
            launches = launch_counts()
            want = {k: 3 * v for k, v in supervised_launches(1).items()}
            check(launches == want, f"zoo2d {key} launches over 3 steps "
                                    f"{launches}, expected {want}")
            check(all(math.isfinite(v) for v in losses), f"zoo2d {key} losses {losses}")
            total = {k: total[k] + launches[k] for k in total}
            res.update({"step_ms": times, "median_step_ms": statistics.median(times),
                        "slices_per_s": 1e3 * cfg.data.batch_size
                        / statistics.median(times),
                        "launches": launches, "losses": losses})
        else:
            try:
                build_supervised_train_step(model, opt, cfg, device="cuda")(
                    state, batches[0], gen)
                refused = False
            except ValueError as e:
                refused = type(model).__name__ in str(e) and state.step == 0
            check(refused, f"the single-decoder step refuses {key}")
            torch.cuda.reset_peak_memory_stats()    # the forwards' peak alone
            x = batches[0]["image"]
            kw = zoo2d_draws(model, x.shape[0], x.shape[-1],
                             torch.Generator().manual_seed(61), "cuda")
            for train in (True, False):
                model.train(train)
                t0 = time.perf_counter()
                with torch.no_grad():
                    outs = _flat(model(x, stats={}, **kw) if train else model(x))
                torch.cuda.synchronize()
                res[f"{'train' if train else 'eval'}_forward_ms"] = \
                    (time.perf_counter() - t0) * 1e3
                check(all(bool(torch.isfinite(o).all()) for o in outs),
                      f"zoo2d {key} finite outputs (train={train})")
                res[f"{'train' if train else 'eval'}_outputs"] = [
                    list(o.shape) for o in outs]
        res["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        res["card"] = card_line()
        print("slice_zoo2d", key, json.dumps(res), flush=True)
        out["keys"][key] = res
        out["states"][key] = state
        del model, opt, batches
        torch.cuda.empty_cache()
    out["launches"] = total
    out["settings"] = tf32_settings()
    return out


def phase_test_zoo2d(states: dict) -> dict:
    """(c) cli.test_2d on a snapshot of each key, written here: (b)'s
    weights in a ``best`` slot and a config.json naming the model,
    --dataset synthetic (2 of the CLI's 8 phantom volumes of 10 slices at
    256^2, 224^2 for swinunet: TWO_VOLUMES); unet_cct under each ensemble
    mode, unet_urpc and dual_student under logit_ensemble and model2
    (output 1), the others under the default. Then cli.train_2d refusing a single-output model in
    supervised mode, before it writes a run dir."""
    shutil.rmtree(ZOO2D_RUNS, ignore_errors=True)
    res = {}
    for key, state in states.items():
        cfg = zoo2d_config(key)
        cfg.data.dataset = "synthetic"
        snap = os.path.join(ZOO2D_RUNS, key)
        CheckpointManager(snap).save_best(state)
        with open(os.path.join(snap, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(cfg), f)
        modes = {"unet_cct": ("logit_ensemble", "prob_ensemble", "model1", "model2"),
                 "unet_urpc": ("logit_ensemble", "model2"),
                 "dual_student": ("logit_ensemble", "model2")}.get(
                     key, ("logit_ensemble",))
        for mode in modes:
            t0 = time.perf_counter()
            with mock.patch.object(cli_test, "SyntheticVolumeDataset", TWO_VOLUMES):
                mean = cli_test.main(["--snapshot", snap, "--device", "cuda",
                                      "--model_type", mode])
            check(mean.shape == (3, 4) and np.isfinite(mean[:, 0]).all(),
                  f"cli.test_2d {key} {mode}: {mean}")
            res[f"{key} {mode}"] = {"mean_dice": float(mean[:, 0].mean()),
                                    "s": time.perf_counter() - t0}
        lines = open(os.path.join(snap, "performance.txt")).read().splitlines()
        check(len(lines) == len(modes), f"cli.test_2d {key} performance.txt {lines}")
    root = os.path.join(ZOO2D_RUNS, "refused")
    try:
        cli_train.main(["--cfg", "configs/acdc_chap.yml", "--dataset", "synthetic",
                        "--model", "unet", "--mode", "supervised", "--device",
                        "cuda", f"run.snapshot_root={root}"])
        refused = False
    except ValueError as e:
        refused = "'unet'" in str(e)
    check(refused and not os.path.exists(root),
          "cli.train_2d refuses unet in supervised mode before a run dir")
    print("test_zoo2d", json.dumps(res), flush=True)
    shutil.rmtree(ZOO2D_RUNS, ignore_errors=True)
    return res


def phase_zoo2d() -> dict:
    """Phase 24, the 2D zoo: (a) parity, (b) the full-width steps and
    forwards, (c) cli.test_2d on every key. Prints the ``zoo2d`` line."""
    t0 = time.perf_counter()
    parity = phase_parity_zoo2d()
    slice_ = phase_slice_zoo2d()
    test = phase_test_zoo2d(slice_.pop("states"))
    res = {"parity": parity, "slice": slice_, "test": test,
           "phase_s": time.perf_counter() - t0}
    print("zoo2d", json.dumps({"phase_s": res["phase_s"],
                               "launches": slice_["launches"]}), flush=True)
    torch.cuda.empty_cache()
    return res


# phase 25: the library (models no factory key reaches, convert, timing)
LIB_RUNS = os.path.join(RUNS_DIR, "library")
LIB_CHNS = (4, 8, 16, 16, 32)


def library_models() -> dict:
    """(a)'s models at small widths: name -> (make, input shapes). Sizes
    where a train-mode BatchNorm normalises 8 values a channel or more."""
    dec = dict(num_queries=4, hidden_dim=32, num_heads=4)
    return {
        "sqex": (lambda: SqEx(32), [(2, 32, 4, 4, 4)]),
        "seblock3d": (lambda: SEBlock3d(32), [(2, 32, 4, 4, 4)]),
        "scse": (lambda: SCSEModule(32), [(2, 32, 8, 8)]),
        "conv2d_relu": (lambda: Conv2dReLU(32, 16), [(2, 32, 8, 8)]),
        "resnet18": (lambda: resnet.resnet18(), [(2, 1, 32, 32)]),
        "resnet50_d": (lambda: resnet.resnet50_d(), [(2, 1, 64, 64)]),
        "resnext101_32x8d": (lambda: resnet.resnext101_32x8d(), [(2, 1, 64, 64)]),
        "resnet50_16s_3d": (lambda: resnet.resnet50_16s(ndim=3), [(2, 1, 16, 16, 16)]),
        "fc3d_discriminator": (lambda: FC3DDiscriminator(2, ndf=16),
                               [(2, 2, 32, 32, 16), (2, 1, 32, 32, 16)]),
        "fc_discriminator": (lambda: FCDiscriminator(4, ndf=16), [(2, 4, 64, 64)]),
        "unet_2dbcp": (lambda: UNet2dBCP(1, 4, LIB_CHNS), [(2, 1, 32, 32)]),
        "unet_tsne": (lambda: UNetTsne(1, 4, LIB_CHNS), [(2, 1, 32, 32)]),
        "net_d": (lambda: NetD(512), [(2, 4, 8, 8)]),
        "tiny_unet3d": (lambda: TinyUNet3D(1, 2), [(2, 1, 16, 16, 16)]),
        "resnet_generator": (lambda: ResnetGenerator(3, 3, ngf=8, n_blocks=2),
                             [(2, 3, 32, 32)]),
        "resnet_generator_in_dropout": (
            lambda: ResnetGenerator(3, 3, ngf=8, n_blocks=2, norm="instancenorm",
                                    use_dropout=True), [(2, 3, 32, 32)]),
        "unet_generator": (lambda: UnetGenerator(3, 3, num_downs=5, ngf=8),
                           [(2, 3, 32, 32)]),
        "unet_generator_in_dropout": (
            lambda: UnetGenerator(3, 3, num_downs=7, ngf=4, norm="instancenorm",
                                  use_dropout=True), [(2, 3, 128, 128)]),
        "nlayer_discriminator": (lambda: NLayerDiscriminator(3, ndf=8),
                                 [(2, 3, 64, 64)]),
        "mask_decoder": (lambda: MaskTransformerDecoder((16, 8), num_layers=4, **dec),
                         [[(2, 16, 8, 8), (2, 8, 16, 16)]]),
        "mask_decoder_v1": (lambda: MaskTransformerDecoderV1(
            (16, 8, 8), 8, num_classes=3, num_layers=3, **dec),
            [[(2, 16, 4, 4), (2, 8, 8, 8), (2, 8, 16, 16)], (2, 8, 32, 32)]),
        "kmax_decoder": (lambda: KMaxTransformerDecoder((16,), num_layers=2, **dec),
                         [[(2, 16, 8, 8)]]),
        "effiunet_b3": (lambda: EffiUNet(1, 4, encoder_name="efficientnet-b3"),
                        [(2, 1, 64, 64)]),
    }


def _rand_inputs(shapes, gen) -> list:
    return [[torch.randn(s, generator=gen) for s in x] if isinstance(x, list)
            else torch.randn(x, generator=gen) for x in shapes]


def _to(inputs, device) -> list:
    return [[t.to(device) for t in x] if isinstance(x, list) else x.to(device)
            for x in inputs]


def _train_kwargs(model, inputs, gen) -> dict:
    """A train pass's keywords: the BatchNorms' stats dict where the model
    reports them, its dropout draws where it has dropouts."""
    params = inspect.signature(model.forward).parameters
    kw = {"stats": {}} if "stats" in params else {}
    if hasattr(model, "dropout_shapes"):
        x = inputs[0]
        shapes = model.dropout_shapes(x.shape[0], x.shape[2:])
        if shapes:
            kw["drop_u"] = [torch.rand(s, generator=gen) for s in shapes]
    return kw


def grad_gap(card: torch.nn.Module, cpu: torch.nn.Module) -> dict:
    """Card-against-CPU gaps of the parameter gradients: of all of them as
    one vector, and the largest of a parameter's own (relative to its
    norm) over the parameters whose gradient is at least 1e-4 of the
    whole's norm. Below that lie the gradients that are rounding noise in
    both (a conv bias in front of a BatchNorm has none), which the whole's
    gap still holds."""
    pairs = [(n, a.grad.cpu() if a.grad is not None else torch.zeros_like(b),
              b.grad if b.grad is not None else torch.zeros_like(b))
             for (n, a), (_, b) in zip(card.named_parameters(), cpu.named_parameters())]
    whole = torch.cat([b.reshape(-1) for _, _, b in pairs]).norm()
    diff = torch.cat([(a - b).reshape(-1) for _, a, b in pairs]).norm()
    check(float(whole) > 0, "a gradient reaches the parameters")
    each, name = max((float((a - b).norm() / b.norm()), n) for n, a, b in pairs
                     if b.norm() >= 1e-4 * whole)
    return {"whole": float(diff / whole), "largest_parameter": each,
            "largest_parameter_name": name}


class GrlPair(torch.nn.Module):
    """GRL between a small UNet's decoder features (pooled to 8 x 8) and
    NetD: the discriminator's loss reaches the UNet reversed."""

    def __init__(self):
        super().__init__()
        self.unet = UNet2dBCP(1, 4, LIB_CHNS)
        self.netd = NetD(2 * 4 * 8 * 8)

    def forward(self, x):
        # zero uniforms keep every unit: the same dropout on both devices
        keep = [torch.zeros(s, device=x.device)
                for s in self.unet.dropout_shapes(x.shape[0], x.shape[2:])]
        _, feats = self.unet(x, drop_u=keep, with_feats=True)
        h = gradient_reverse(torch.nn.functional.avg_pool2d(feats, 4), 0.5)
        return gan_loss(self.netd(h), True, use_lsgan=False)


class GanPair(torch.nn.Module):
    """ResnetGenerator under NLayerDiscriminator, the lsgan pair's losses."""

    def __init__(self):
        super().__init__()
        self.g = ResnetGenerator(3, 3, ngf=8, n_blocks=2)
        self.d = NLayerDiscriminator(3, ndf=8)

    def forward(self, x):
        return gan_loss(self.d(self.g(x)), True) + gan_loss(self.d(x), False)


def tiny_loss(out, lab) -> torch.Tensor:
    """TinyUNet3D's train outputs: CE of the logits plus the multiscale
    maps' foreground squared."""
    logits, maps = out
    return (torch.nn.functional.cross_entropy(logits, lab)
            + sum((p[:, 1] ** 2).mean() for p in maps))


def library_grad_parity(gen) -> dict:
    """(a)'s gradients card against CPU (TF32 off, train mode, the same
    weights): GRL, KMax, the GAN pair, TinyUNet3D; rtol 2e-3 as vectors
    (grad_gap)."""
    w = [torch.randn((2, 4, 8, 8), generator=gen) for _ in range(2)]
    lab = torch.randint(0, 2, (2, 16, 16, 16), generator=gen)
    cases = {
        "grl": (GrlPair, [torch.randn((2, 1, 32, 32), generator=gen)],
                lambda m, x: m(x)),
        "kmax": (lambda: KMaxTransformerDecoder((16,), num_queries=4, hidden_dim=32,
                                                num_layers=2, num_heads=4),
                 [[torch.randn((2, 16, 8, 8), generator=gen)]],
                 lambda m, x: sum((s * wi.to(s.device)).sum()
                                  for s, wi in zip(m(x), w))),
        "gan_pair": (GanPair, [torch.randn((2, 3, 32, 32), generator=gen)],
                     lambda m, x: m(x)),
        "tiny_unet3d": (lambda: TinyUNet3D(1, 2),
                        [torch.randn((2, 1, 16, 16, 16), generator=gen)],
                        lambda m, x: tiny_loss(m(x), lab.to(x.device))),
    }
    res = {}
    for name, (make, inputs, loss_fn) in cases.items():
        torch.manual_seed(51)
        cpu, card = make(), make().cuda()
        card.load_state_dict(cpu.state_dict())
        losses = []
        for model, dev in ((cpu, "cpu"), (card, "cuda")):
            model.train()
            x = _to(inputs, dev)
            loss = loss_fn(model, x[0])
            loss.backward()
            losses.append(float(loss.detach()))
        gap = grad_gap(card, cpu)
        check(abs(losses[1] - losses[0]) <= RTOL * max(abs(losses[0]), 1e-6),
              f"library {name} loss card {losses[1]} cpu {losses[0]}")
        check(max(gap["whole"], gap["largest_parameter"]) <= RTOL,
              f"library {name} gradients: gaps {gap}")
        res[name] = {"loss": losses, "grad_rel_gap": gap}
    return res


def phase_parity_library() -> dict:
    """(a) every model of models/{blocks, resnet, discriminator, extras,
    gan_legacy, transformer_decoder}.py and EffiUNet-b3 at a small width on
    the card and on the CPU from the same weights and draws (TF32 off):
    every output in eval and train mode and the BN batch statistics at
    5e-4 of the output's scale (zoo_tol); the gradients of GRL, KMax, the
    GAN pair and TinyUNet3D (library_grad_parity); mask_selection with the
    same uniforms, equal."""
    set_tf32(False)
    res = {"forward_max_abs_err": {}}
    gen = torch.Generator().manual_seed(50)
    for name, (make, shapes) in library_models().items():
        torch.manual_seed(52)
        cpu, card = make(), make().cuda()
        card.load_state_dict(cpu.state_dict())
        inputs = _rand_inputs(shapes, gen)
        train_kw = _train_kwargs(cpu, inputs, gen)
        err = 0.0
        for train in (False, True):
            cpu.train(train)
            card.train(train)
            kw = train_kw if train else {}
            kw_cpu = {k: ({} if k == "stats" else v) for k, v in kw.items()}
            kw_card = {k: ({} if k == "stats" else [u.cuda() for u in v])
                       for k, v in kw.items()}
            with torch.no_grad():
                o_cpu = _flat(cpu(*inputs, **kw_cpu))
                o_card = _flat(card(*_to(inputs, "cuda"), **kw_card))
            check(len(o_cpu) == len(o_card), f"library {name} outputs")
            for a, b in zip(o_card, o_cpu):
                e = float((a.cpu() - b).abs().max())
                check(e <= zoo_tol(b), f"library parity {name} (train={train}): {e}")
                err = max(err, e)
            if "stats" in kw:
                has_bn = any(isinstance(m, FlaxBatchNorm) for m in cpu.modules())
                check(set(kw_cpu["stats"]) == set(kw_card["stats"])
                      and bool(kw_cpu["stats"]) == has_bn,
                      f"library {name} BN statistics keys")
                for k, (m_cpu, v_cpu) in kw_cpu["stats"].items():
                    for a, b in zip(kw_card["stats"][k], (m_cpu, v_cpu)):
                        e = float((a.cpu() - b).abs().max())
                        check(e <= zoo_tol(b), f"library BN statistics {name} {k}: {e}")
        res["forward_max_abs_err"][name] = err
    res["gradients"] = library_grad_parity(gen)
    scores = torch.rand((4, 32), generator=gen)
    u = torch.rand((4, 32), generator=gen)
    for wrs in (True, False):
        for percent in (0.1, 0.5):
            want = mask_selection(scores, percent, wrs, u=u)
            got = mask_selection(scores.cuda(), percent, wrs, u=u.cuda()).cpu()
            check(torch.equal(got, want), f"mask_selection wrs={wrs} {percent}")
    res["mask_selection_equal"] = True
    res["settings"] = tf32_settings()
    print("parity_library", json.dumps(res), flush=True)
    return res


def fwd_bwd_timed(make_loss, n: int = 3) -> dict:
    """``make_loss()`` built, then one warm-up and ``n`` timed forward +
    backward calls of the loss it returns (a sync after each): median ms,
    peak GB of the whole (warm-up included)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss_fn, params = make_loss()
    times = []
    for i in range(n + 1):
        for p in params:
            p.grad = None
        t0 = time.perf_counter()
        loss = loss_fn()
        loss.backward()
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
        check(math.isfinite(float(loss)), "finite loss")
    return {"ms": statistics.median(times), "step_ms": times,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def _mean_loss(out) -> torch.Tensor:
    return sum(o.float().mean() for o in _flat(out))


def phase_slice_library() -> dict:
    """(b) at full width (TF32 on, random weights from a seed): one warm-up
    and three timed forward + backward calls of each, ms and peak GB:
    resnet50 and resnet50_16s on 24 x 3 x 256^2; the three decoders at
    their default widths on resnet50's pyramid of that batch ([c5, c4, c3,
    c2]; V1's mask features c1); ResnetGenerator, UnetGenerator and
    NLayerDiscriminator at 4 x 3 x 256^2; FCDiscriminator on 24 x 4 x
    256^2 and NetD on its [24, 1, 8, 8] map (NetD flattens its whole input
    into one row: on the image batch it would hold 2e13 weights); UNetTsne
    on 24 x 1 x 256^2; TinyUNet3D on 4 x 1 x 96^3; EffiUNet-b3 on 24 x 1 x
    256^2; then utils.timing.benchmark_fwd_bwd on the ACDC DualDecoder
    (configs/acdc_chap.yml's widths, 24 x 1 x 256^2)."""
    set_tf32(True)
    gen = torch.Generator(device="cuda").manual_seed(53)
    img3 = torch.randn((24, 3, 256, 256), generator=gen, device="cuda")
    out = {}

    def model_loss(make, *inputs, train=True, **kw):
        def build():
            torch.manual_seed(54)
            model = make().cuda().train(train)
            return (lambda: _mean_loss(model(*inputs, **kw))), list(model.parameters())
        return build

    cases = {
        "resnet50": model_loss(lambda: resnet.resnet50(in_chns=3), img3),
        "resnet50_16s": model_loss(lambda: resnet.resnet50_16s(in_chns=3), img3),
    }
    for name, build in cases.items():
        out[name] = fwd_bwd_timed(build)
    torch.manual_seed(54)
    with torch.no_grad():
        pyramid = resnet.resnet50(in_chns=3).cuda().eval()(img3)
    levels = pyramid[:0:-1]                 # c5, c4, c3, c2
    chans = [f.shape[1] for f in levels]
    decoders = {
        "mask_decoder": model_loss(lambda: MaskTransformerDecoder(chans), levels),
        "mask_decoder_v1": model_loss(lambda: MaskTransformerDecoderV1(
            chans, pyramid[0].shape[1]), levels, pyramid[0]),
        "kmax_decoder": model_loss(lambda: KMaxTransformerDecoder(chans), levels),
    }
    for name, build in decoders.items():
        out[name] = fwd_bwd_timed(build)
    del pyramid, levels
    img4 = torch.randn((4, 3, 256, 256), generator=gen, device="cuda")
    seg = torch.randn((24, 4, 256, 256), generator=gen, device="cuda").softmax(1)
    gray = torch.randn((24, 1, 256, 256), generator=gen, device="cuda")
    vol = torch.randn((4, 1, 96, 96, 96), generator=gen, device="cuda")

    def fc_netd():
        torch.manual_seed(54)
        d, netd = FCDiscriminator(4).cuda(), NetD(24 * 8 * 8).cuda()
        return (lambda: netd(d(seg)).mean(),
                list(d.parameters()) + list(netd.parameters()))

    cases = {
        "resnet_generator": model_loss(lambda: ResnetGenerator(3, 3), img4),
        "unet_generator": model_loss(lambda: UnetGenerator(3, 3), img4),
        "nlayer_discriminator": model_loss(lambda: NLayerDiscriminator(3), img4),
        "fc_discriminator_net_d": fc_netd,
        "unet_tsne": model_loss(lambda: UNetTsne(1, 4), gray),
        "tiny_unet3d": model_loss(lambda: TinyUNet3D(1, 2), vol),
        "effiunet_b3": model_loss(lambda: EffiUNet(1, 4, encoder_name="efficientnet-b3"),
                                  gray),
    }
    for name, build in cases.items():
        out[name] = fwd_bwd_timed(build)
    cfg = acdc_chap_config()
    torch.manual_seed(54)
    dual = net_factory("dualdecoder", 1, 4, cfg.model, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    out["timing_dualdecoder"] = {**benchmark_fwd_bwd(dual, gray, num_iters=3),
                                 "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    out["settings"] = tf32_settings()
    out["card"] = card_line()
    print("slice_library", json.dumps(out), flush=True)
    return out


# (c): the .pth families converted on the card's path: name -> (family,
# dimension, classes)
LIB_PTH = {"acdc_dualdecoder": ("dualdecoder", 2, 4), "la_vnet": ("vnet", 3, 2),
           "la_dualdecoder3d": ("dualdecoder3d", 3, 2),
           "swinunet": ("swinunet", 2, 4)}


def phase_convert_library() -> dict:
    """(c) cli.convert_torch on the card's path: reference-named .pth files
    (``module.`` prefixes in a ``{"state_dict": ...}`` wrapper) of seeded
    weights: the ACDC DualDecoder at configs/acdc_chap.yml's widths, LA's
    VNet and DualDecoder3d at n_filters_3d 16 and swinunet (224^2);
    each converted, then cli.test_2d (2 of its 8 phantom volumes, the rest
    of (c)'s time) or cli.test_3d --nms 1 (its 2 synthetic volumes of
    112x112x96, K3 launched a patch batch and counted; the eval's NMS is
    the host's largest-CC, as chap_tpu's test_LA.py --nms, so K2 3D is
    counted and stays 0) with --device cuda, and
    the converted snapshot's label maps (restored by the CLIs' restore)
    against the same weights loaded straight into the factory's model:
    within 0.1% of pixels / voxels."""
    shutil.rmtree(LIB_RUNS, ignore_errors=True)
    os.makedirs(LIB_RUNS)
    res = {"launches_test3d": {k: 0 for k in launch_counts()}}
    cfg = acdc_chap_config()
    for name, (family, dim, classes) in LIB_PTH.items():
        key = cli_convert.FAMILIES[family][1]
        torch.manual_seed(55)
        if dim == 2:
            direct = net_factory(key, 1, classes, cfg.model, device="cuda")
        else:
            direct = net_factory_3d(key, 1, classes, mode="test", device="cuda")
        sd = {f"module.{k}": v.cpu() for k, v in direct.state_dict().items()}
        pth = os.path.join(LIB_RUNS, f"{name}.pth")
        torch.save({"state_dict": sd}, pth)
        snap = os.path.join(LIB_RUNS, name)
        t0 = time.perf_counter()
        cli_convert.main(["--pth", pth, "--model", family, "--out", snap,
                          "--num_classes", str(classes), "--device", "cuda"])
        row = {"convert_s": time.perf_counter() - t0}
        direct.eval()
        t0 = time.perf_counter()
        if dim == 2:
            with open(os.path.join(snap, "config.json")) as f:
                conf = json.load(f)
            conf["data"]["dataset"] = "synthetic"
            with open(os.path.join(snap, "config.json"), "w") as f:
                json.dump(conf, f)
            with mock.patch.object(cli_test, "SyntheticVolumeDataset", TWO_VOLUMES):
                mean = cli_test.main(["--snapshot", snap, "--device", "cuda"])
            check(mean.shape == (classes - 1, 4) and np.isfinite(mean[:, 0]).all(),
                  f"cli.test_2d {name}: {mean}")
            _, restored = cli_test.restore(snap, "best", "cuda")
            side = tuple(conf["data"]["image_size"])
            vols = SyntheticVolumeDataset((10, *side), classes, length=2)
            maps = [[predict_volume(make_predictor(m, "logit_ensemble", device="cuda"),
                                    vols[i]["image"], side) for i in range(2)]
                    for m in (restored, direct)]
        else:
            zero_launch_counts()
            mean = cli_test3d.main(["--dataset", "synthetic", "--snapshot", snap,
                                    "--model", key, "--num_classes", str(classes),
                                    "--nms", "1", "--device", "cuda"])
            got = launch_counts()
            check(got["K3_sw"] > 0, f"cli.test_3d {name} launches K3: {got}")
            res["launches_test3d"] = {k: res["launches_test3d"][k] + got[k] for k in got}
            row["launches"] = got
            check(np.isfinite(mean[:, 0]).all(), f"cli.test_3d {name}: {mean}")
            restored = cli_test3d.restore(snap, key, classes, "best", "cuda")
            cases = cli_test3d._SyntheticCases(classes)
            maps = [[sw.test_single_case(m, cases[i]["image"], 18, 4, LA_PATCH,
                                         classes, device="cuda") for i in range(2)]
                    for m in (restored, direct)]
        row["eval_s"] = time.perf_counter() - t0
        total = sum(m.size for m in maps[0])
        differ = sum(int((a != b).sum()) for a, b in zip(*maps))
        check(differ <= 1e-3 * total,
              f"convert {name}: {differ} of {total} labels differ from the direct load")
        row.update({"mean_dice": float(mean[:, 0].mean()), "labels": total,
                    "labels_differing": differ})
        res[name] = row
    print("convert_library", json.dumps(res), flush=True)
    shutil.rmtree(LIB_RUNS, ignore_errors=True)
    return res


def phase_library() -> dict:
    """Phase 25, the library: (a) parity, (b) the full-width forward +
    backward calls, (c) cli.convert_torch and the test CLIs. Prints the
    ``library`` line."""
    t0 = time.perf_counter()
    res = {"parity": phase_parity_library(), "slice": phase_slice_library(),
           "convert": phase_convert_library()}
    res["phase_s"] = time.perf_counter() - t0
    print("library", json.dumps({"phase_s": res["phase_s"],
                                 "launches_test3d": res["convert"]["launches_test3d"],
                                 "timed": {k: v["ms"] for k, v in res["slice"].items()
                                           if isinstance(v, dict) and "ms" in v}}),
          flush=True)
    torch.cuda.empty_cache()
    return res


DIST_RUNS = os.path.join(RUNS_DIR, "dist")
DIST_STEPS = 3
# phase 23's control draws of each kind, a bar's samples of the card's
# summation order: PyTorch's native convolutions and BatchNorm twice and
# cuDNN's default steps once more
CONTROL_CONVS = ("native", "native", "cudnn")
# the kinds held at their first step as well as over DIST_STEPS: the fp32
# LA CHAP step. Its first step's gaps repeat from call to call on an H100
# (W ranks' update 4.8e-3 against the native steps' 5.1e-3, metrics 3e-5);
# over three steps its argmax pseudo-labels and VAT direction amplify the
# summation order, and its metrics' largest relative gap (vat_loss) is
# heavy-tailed (W ranks 1.6e-3-2.4e-2, draws up to 2.3e-2), so those are
# printed, not held; its three-step update, running statistics and GradSim
# scores are steady and stay held
FIRST_STEP_KINDS = ("la",)
# (e)'s smaller planted fault: every summed gradient scaled by this, an
# update 5% short from the first step on
SCALED_GRADIENT = 0.95
# cli.train_2d at configs/acdc_chap.yml's values with an eval every 3 and a
# log line every step; the synthetic pool cut to 256 slices (labeled_num 7
# takes 136 of them) so that each rank builds its pool in a second. (c)
# runs DIST_TRAINER_STEPS then resumes to DIST_RESUME_STEPS, (a) runs
# DIST_TRAINER_STEPS
DIST_TRAINER_STEPS = 6
DIST_RESUME_STEPS = 9
DIST_OVERRIDES = ["eval.eval_every=3", "data.synthetic_val_volumes=2",
                  "data.synthetic_train_size=256", "run.log_every=1",
                  f"run.snapshot_root={DIST_RUNS}"]
# (h): cli.train_3d at configs/la_chap.yml as written (bf16), a log line a
# step
DIST3D_STEPS = 4
DIST3D_OVERRIDES = ["data.patch_size_3d=[112,112,80]", "run.log_every=1",
                    f"run.snapshot_root={DIST_RUNS}"]
# the bare steps phase 23 runs at W ranks against this process, by kind
DIST_KINDS = {"acdc": "2D CHAP, configs/acdc_chap.yml, fp32",
              "la": "3D CHAP, configs/la_chap.yml in fp32",
              "la_bf16": "3D CHAP, configs/la_chap.yml as written (bf16)",
              "brats": "unet_3D supervised, configs/brats_supervised.yml in fp32",
              "acal": "ACAL joint + max + min, configs/acdc_share_acal.yml, fp32",
              "ablation": "ablation step, configs/acdc_chap.yml, fp32"}
# the kinds whose batch is [labeled ; unlabeled] dealt half by half
SHARE_KINDS = ("acal", "ablation")
# (k): cli.train_share_2d --acal at configs/acdc_share_acal.yml's values, 8
# iterations with a bank feed each and replay from iteration 4, one loader
# thread (so every rank loads W = 1's batches), an eval of both decoders at 8
SHARE_DIST_ITERATIONS = 8
SHARE_DIST_ARGV = ["--cfg", ACAL_CFG, "--acal", "--dataset", "synthetic",
                   "--device", "cuda", "--max_iterations",
                   str(SHARE_DIST_ITERATIONS), "semi.acal_start_iter=3",
                   "semi.mb_feed_every=1", "data.num_workers=1",
                   "eval.eval_every=8", "data.synthetic_val_volumes=2",
                   "data.synthetic_train_size=256", "run.log_every=1",
                   f"run.snapshot_root={DIST_RUNS}"]
# (l): cli.train_2d --mode ablation at configs/acdc_chap.yml's values
ABLATION_DIST_STEPS = 4


def dist_config(kind: str):
    return {"acdc": acdc_chap_config, "la": lambda: la_config(F32),
            "la_bf16": la_config, "brats": lambda: brats_config(F32),
            "acal": acal_config, "ablation": acdc_chap_config}[kind]()


def dist_roles(kind: str):
    """The roles of a kind's batch (parallel/dist.py ``rank_rows``)."""
    if kind in SHARE_KINDS:
        return dist.Halves(dist_config(kind).data.labeled_bs)
    return dist.ONE_ROLE if kind == "brats" else dist.CHAP_ROLES


def dist_rows(kind: str):
    """A rank's rows of a global batch of the kind (of the ACAL replay
    mask, which covers the unlabeled half, its rows of that half)."""
    return lambda batch: {k: dist.shard_rows(v, dist.ONE_ROLE if k == "mask"
                                             else dist_roles(kind))
                          for k, v in batch.items()}


def dist_init(kind: str) -> dict:
    """The kind's model built from a seed: its state dict on the host (the
    bf16 LA step takes la's float32 parameters)."""
    cfg = dist_config(kind)
    torch.manual_seed(23)
    if kind in ("acdc",) + SHARE_KINDS:
        model = net_factory(cfg.model.name, 1, 4, cfg.model, device="cuda")
    else:
        model = net_factory_3d(cfg.model.name_3d, 1, cfg.data.num_classes,
                               "train", cfg.model, device="cuda")
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


class _Out:
    """A step's output as the bare-step loop reads it."""

    def __init__(self, metrics):
        self.metrics = metrics


def dist_make(kind: str, state_dict: dict):
    cfg = dist_config(kind)
    if kind == "acdc":
        return make_step(cfg, "cuda", state_dict=state_dict)
    if kind == "acal":
        # one ACAL iteration: joint step, then the replay pair on the batch
        # with its replay mask, each with its draws
        state, joint, dec, enc = make_share(cfg, "cuda", state_dict=state_dict)

        def iteration(state, batch, draws):
            _, m, _ = joint(state, batch, draws=draws[0])
            _, f = dec(state, batch["image"], batch["label"], batch["mask"],
                       draws=draws[1])
            _, g = enc(state, batch["image"], batch["mask"], draws=draws[2])
            return _Out({**m, **f, **g})
        return state, iteration
    if kind == "ablation":
        model = net_factory(cfg.model.name, 1, 4, cfg.model, device="cuda")
        model.load_state_dict(state_dict)
        opt = make_optimizer(model, cfg.optim.base_lr, cfg.optim.momentum,
                             cfg.optim.weight_decay)
        state = create_train_state(model, opt, cfg.model.feature_chns)
        return state, build_ablation_train_step(model, opt, cfg, device="cuda")
    if kind == "brats":
        state, step = make_zoo_step(cfg.model.name_3d, cfg)
        state.model.load_state_dict(state_dict)
        return state, step
    return make_step_3d(cfg, "cuda", state_dict=state_dict)


def dist_step_inputs(kind: str):
    """Phase 23's global batches and step draws of a kind, made alike in
    every process on the card (numpy phantoms, Philox draws from a seed)."""
    cfg = dist_config(kind)
    gens = [torch.Generator(device="cuda").manual_seed(40 + i)
            for i in range(DIST_STEPS)]
    if kind in ("acdc",) + SHARE_KINDS:
        batches = [phantom_inputs(cfg, 40 + i, "cuda") for i in range(DIST_STEPS)]
    else:
        batches = [phantom_patches(cfg, 40 + i, "cuda") for i in range(DIST_STEPS)]
    if kind == "la_bf16":      # the pool's dtype for a bf16 model
        batches = [{**b, "image": b["image"].bfloat16()} for b in batches]
    if kind == "brats":
        shapes = net_factory_3d(cfg.model.name_3d, 1, cfg.data.num_classes,
                                "train", cfg.model, device="cpu").dropout_shapes(
            cfg.data.batch_size, cfg.data.patch_size_3d)
        draws = [{"drop": [torch.rand(sh, generator=g, device="cuda")
                           for sh in shapes]} for g in gens]
    elif kind == "acal":
        # a replay mask of the bank's window size at a random corner a row
        n_u, p = cfg.data.batch_size - cfg.data.labeled_bs, cfg.semi.mb_patch_size
        for b, g in zip(batches, gens):
            corner = torch.randint(0, cfg.data.image_size[0] - p, (n_u, 2),
                                   generator=g, device="cuda").tolist()
            b["mask"] = torch.zeros((n_u, *cfg.data.image_size), device="cuda")
            for row, (y, x) in enumerate(corner):
                b["mask"][row, y:y + p, x:x + p] = 1.0
        draws = [[draw_supervised_uniforms(cfg, b["image"].shape, g, "cuda")
                  for _ in range(3)] for b, g in zip(batches, gens)]
    elif kind == "ablation":
        draws = [draw_ablation_uniforms(cfg, b["image"].shape, g, "cuda")
                 for b, g in zip(batches, gens)]
    else:
        draws = [draw_step_uniforms(cfg, b["image"].shape, g, "cuda")
                 for b, g in zip(batches, gens)]
    return batches, draws


def dist_expected_launches(kind: str, rank_: int, world: int) -> dict:
    """A rank's kernel launches over DIST_STEPS bare steps. The CHAP step's
    four mix_loss calls are two a stream: a call over 0 rows still
    launches K1's forward (one program, zero statistics) but no backward,
    and a rank with no row launches no K2."""
    if kind in SHARE_KINDS:
        # 2 + 2 K1 a dice_ce_supervised pair (the joint and max steps, the
        # ablation step); a rank without labeled rows launches the
        # forwards over nothing and no backward
        cfg = dist_config(kind)
        lbs = cfg.data.labeled_bs
        held = len(dist.half_rows(cfg.data.batch_size, lbs, rank_, world)[0])
        pairs = 2 if kind == "acal" else 1
        per = {**{k: 0 for k in LAUNCHES_PER_STEP}, "K1_fwd": 2 * pairs,
               "K1_bwd": 2 * pairs * (held > 0)}
    elif kind == "brats":
        per = supervised_launches(1)
    else:
        per = dict(LAUNCHES_PER_STEP if kind == "acdc" else LAUNCHES_PER_STEP_3D)
        s = dist_config(kind).data.labeled_bs // 2
        n_a, n_b = (len(dist.stream_rows(s, k, 2, rank_, world)) for k in (0, 1))
        per["K1_bwd"] = per["K1_bwd"] * (2 * (n_a > 0) + 2 * (n_b > 0)) // 4
        per["K2_ccl" if kind == "acdc" else "K2_ccl3d"] = int(n_a + n_b > 0)
    return {k: v * DIST_STEPS for k, v in per.items()}


def dist_steps(init: dict, rows, conv: str = "cudnn", kind: str = "acdc",
               warm_up: bool = True) -> dict:
    """DIST_STEPS bare steps of ``kind`` (DIST_KINDS) from ``init`` (TF32
    off) on ``rows(batch)`` of each global batch, after one warm-up step
    from the same start with ``warm_up`` (this process's timed runs; a
    control draw and the spawned ranks skip it, so a rank's first step
    time holds its first-call costs): metrics,
    step ms, the final state dict (parameters and BN running statistics)
    and GradSim scores (on the host), the launches and the collectives
    made. ``conv`` picks the convolutions and BatchNorm: cuDNN's
    (``cudnn``) or PyTorch's own (``native``, cuDNN off), two summation
    orders of the same arithmetic."""
    saved = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = conv != "native"
    try:
        return _dist_steps(init, rows, kind, warm_up)
    finally:
        torch.backends.cudnn.enabled = saved


def _dist_steps(init: dict, rows, kind: str, warm_up: bool) -> dict:
    set_tf32(False)
    batches, draws = dist_step_inputs(kind)
    if warm_up:
        state, step = dist_make(kind, init)
        step(state, rows(batches[0]), draws=draws[0])
    state, step = dist_make(kind, init)
    torch.cuda.synchronize()
    zero_launch_counts()
    times, metrics, first = [], [], None
    with dist.record_collectives() as collectives:
        for batch, d in zip(batches, draws):
            t0 = time.perf_counter()
            m = step(state, rows(batch), draws=d).metrics
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            metrics.append({k: float(v) for k, v in m.items()})
            if first is None and kind in FIRST_STEP_KINDS:
                first = {k: v.detach().cpu().clone() for k, v in
                         state.model.state_dict().items()}
    out = {"metrics": metrics, "step_ms": times, "launches": launch_counts(),
           "launches_bf16": bf16_launch_counts(),
           "rows": rows(batches[0])["image"].shape[0],
           "params": {k: v.detach().cpu() for k, v in
                      state.model.state_dict().items()},
           "first_params": first,
           "sim": [s.cpu() for s in getattr(state, "sim_scores", [])],
           "counts": [getattr(state, k, None) for k in ("count_g", "count_f")],
           "collectives": list(collectives)}
    del state, step, batches, draws
    torch.cuda.empty_cache()
    return out


def collective_figures(steps: dict, replay: bool = False) -> None:
    """Replace a rank's record of collectives by its all-reduces and MB a
    step, and with ``replay`` the ms of the same all-reduces made alone."""
    if replay:
        buffers = {c: torch.zeros(c[0], dtype=c[1], device="cuda")
                   for c in set(steps["collectives"])}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c in steps["collectives"]:
            dist.all_reduce_(buffers[c])
        torch.cuda.synchronize()
        steps["allreduce_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / DIST_STEPS
    steps["collectives_per_step"] = len(steps["collectives"]) / DIST_STEPS
    steps["allreduce_mb_per_step"] = sum(
        n * torch.empty((), dtype=t).element_size()
        for n, t in steps.pop("collectives")) / DIST_STEPS / 1e6


def dist_val_set(cfg=None):
    """The synthetic val volumes of phase 23's trainer runs (at ``cfg``'s
    data settings, configs/acdc_chap.yml's by default)."""
    cfg = cfg or acdc_chap_config()
    cfg.data.dataset = "synthetic"
    cfg.data.synthetic_val_volumes, cfg.data.synthetic_train_size = 2, 256
    return build_datasets(cfg.data, None)[1]


def dist_eval(save_dir: str) -> np.ndarray:
    """evaluate_volumes of a run's latest weights at this process's W, with
    TF32 on, as the trainer evaluates."""
    set_tf32(True)
    cfg = acdc_chap_config()
    model = net_factory("dualdecoder", 1, 4, cfg.model, device="cuda")
    state = create_train_state(model, make_optimizer(model, 0.01),
                               cfg.model.feature_chns)
    CheckpointManager(save_dir).restore_latest(state)
    return evaluate_volumes(dist_val_set(), make_predictor(model, device="cuda"),
                            4, tuple(cfg.data.image_size))


def dist_eval_cases() -> list:
    """(g)'s two phantom volumes of 160x160x96 [X, Y, Z] (80 LA patches
    each at stride 18 / 4)."""
    vols = SyntheticVolumeDataset((96, 160, 160), 2, length=2, seed=23)
    return [{"image": vols[i]["image"].transpose(2, 1, 0),
             "label": vols[i]["label"].transpose(2, 1, 0)} for i in range(2)]


def dist_eval_weights(init: dict) -> dict:
    """The LA model from ``init`` with the BN running statistics of one
    train-mode pass over phantom patches, so its label maps are not one
    class."""
    cfg = la_config(F32)
    model = net_factory_3d("dualdecoder", 1, 2, "train", cfg.model, device="cuda")
    model.load_state_dict(init)
    stats = {}
    with torch.no_grad():
        model.train()(phantom_patches(cfg, 77, "cuda")["image"], stats=stats)
    for m in model.modules():
        if m.__class__.__name__ == "BatchNorm3d":
            m.running_mean.copy_(stats[m.stats_key][0])
            m.running_var.copy_(stats[m.stats_key][1])
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def dist_eval_3d(weights: dict) -> dict:
    """test_all_case of the LA model (fp32, TF32 off) over (g)'s volumes at
    the LA protocol (stride 18 / 4, configs/la_chap.yml's sw_batch 16) at
    this process's W: per-case metrics, its K3 launches, and each volume's
    label map from the engine."""
    set_tf32(False)
    cfg = la_config(F32)
    model = net_factory_3d("dualdecoder", 1, 2, "train", cfg.model, device="cuda")
    model.load_state_dict(weights)
    cases = dist_eval_cases()
    per_case = []
    zero_launch_counts()
    t0 = time.perf_counter()
    metrics = sw.test_all_case(model, cases, 2, LA_PATCH, 18, 4,
                               sw_batch=cfg.eval.sw_batch, per_case=per_case,
                               device="cuda")
    eval_s = time.perf_counter() - t0
    launches = launch_counts()["K3_sw"]
    engine = sw.SlidingWindowEngine(model, LA_PATCH, cfg.eval.sw_batch,
                                    device="cuda")
    maps = [engine.predict(c["image"], 18, 4, 2) for c in cases]
    return {"metrics": metrics, "per_case": [m for _, m in per_case],
            "maps": maps, "launches": launches, "eval_s": eval_s}


def dist_eval_launches(rank_: int, world: int) -> int:
    """K3 launches of a rank in test_all_case over (g)'s volumes: one a
    batch of 16 patches in which it holds any."""
    per_rank = la_config().eval.sw_batch // world
    n = 0
    for c in dist_eval_cases():
        grid = sw.compute_grid(c["image"].shape, LA_PATCH, 18, 4).shape[0]
        n += len(range(rank_ * per_rank, grid, per_rank * world))
    return n


def zero_row_ops() -> dict:
    """Which PyTorch ops of the port's models take a batch of 0 rows on the
    card, forward and backward (a data-parallel rank without rows runs
    them): {op: "ok" or the error}. Then K1 (R = 1 and 2) and K2 (2D, 3D)
    at 0 rows through their wrappers: K1's forward launches one program
    that sums nothing (zero statistics, the plain version's losses within
    1e-6), its backward and K2 launch nothing."""
    import torch.nn.functional as F

    def x(shape, dtype=torch.float32):
        return torch.zeros(shape, device="cuda", dtype=dtype, requires_grad=True)

    def w(*shape, dtype=torch.float32):
        return torch.randn(shape, device="cuda", dtype=dtype).requires_grad_(True)

    def run(fn, *args):
        out = fn(*args)
        out.float().sum().backward()
        torch.cuda.synchronize()

    up = dict(scale_factor=2, align_corners=True)
    ops = {
        "conv3d": lambda: run(F.conv3d, x((0, 4, 8, 8, 8)), w(6, 4, 3, 3, 3)),
        "conv3d_bf16": lambda: run(F.conv3d, x((0, 4, 8, 8, 8), torch.bfloat16),
                                   w(6, 4, 3, 3, 3, dtype=torch.bfloat16)),
        "conv3d_stride2": lambda: run(lambda a, b: F.conv3d(a, b, stride=2),
                                      x((0, 4, 8, 8, 8)), w(6, 4, 2, 2, 2)),
        "conv_transpose3d": lambda: run(lambda a, b: F.conv_transpose3d(
            a, b, stride=2), x((0, 4, 8, 8, 8)), w(4, 6, 2, 2, 2)),
        "conv2d": lambda: run(F.conv2d, x((0, 4, 16, 16)), w(6, 4, 3, 3)),
        "conv_transpose2d": lambda: run(lambda a, b: F.conv_transpose2d(
            a, b, stride=2), x((0, 4, 16, 16)), w(4, 6, 2, 2)),
        "upsample_trilinear": lambda: run(lambda a: F.interpolate(
            a, mode="trilinear", **up), x((0, 4, 8, 8, 8))),
        "upsample_bilinear": lambda: run(lambda a: F.interpolate(
            a, mode="bilinear", **up), x((0, 4, 16, 16))),
        "max_pool3d": lambda: run(lambda a: F.max_pool3d(a, 2), x((0, 4, 8, 8, 8))),
        "max_pool2d": lambda: run(lambda a: F.max_pool2d(a, 2), x((0, 4, 16, 16))),
        "avg_pool3d": lambda: run(lambda a: F.avg_pool3d(a, 2), x((0, 4, 8, 8, 8))),
        "instance_norm3d": lambda: run(F.instance_norm, x((0, 4, 8, 8, 8))),
        "group_norm3d": lambda: run(lambda a: F.group_norm(a, 2), x((0, 4, 8, 8, 8))),
        "batch_norm_eval": lambda: run(lambda a: F.batch_norm(
            a, torch.zeros(4, device="cuda"), torch.ones(4, device="cuda")),
            x((0, 4, 8, 8, 8))),
        "batch_norm_train": lambda: run(lambda a: F.batch_norm(
            a, None, None, training=True), x((0, 4, 8, 8, 8))),
        "softmax_argmax": lambda: run(lambda a: torch.softmax(a, 1)
                                      + a.argmax(1, keepdim=True), x((0, 2, 8, 8, 8))),
    }
    res = {}
    for name, fn in ops.items():
        try:
            fn()
            res[name] = "ok"
        except Exception as e:     # the finding is which ops refuse
            res[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    print("zero_rows ops", json.dumps(res), flush=True)

    # the kernels' wrappers at 0 rows
    for regions in (1, 2):
        logits, labels, labels2, mask = k1_inputs((0, 2, 8, 8, 8), 3)
        cpu = logits.detach().cpu().requires_grad_(True)
        want = fused_losses.region_dice_ce(cpu, labels.cpu(), mask.cpu(),
                                           None if regions == 1 else labels2.cpu())
        x_ = logits.clone().requires_grad_(True)
        before = launch_counts()
        got = fused_losses.region_dice_ce(x_, labels, mask,
                                          None if regions == 1 else labels2)
        sum(got).backward()
        torch.cuda.synchronize()
        delta = launches_since(before)
        check(delta["K1_fwd"] == 1 and delta["K1_bwd"] == 0,
              f"K1 R = {regions} at 0 rows: 1 forward launch, no backward: {delta}")
        # the finalize kernel's fp32 division s / s rounds (1 - 1.3e-8)
        check(all(abs(float(g) - float(v)) <= 1e-6 for g, v in zip(got, want)),
              f"K1 R = {regions} at 0 rows: losses {got} against plain {want}")
        check(tuple(x_.grad.shape) == (0, 2, 8, 8, 8), "K1 gradient at 0 rows")
    for shape in ((0, 16, 16), (0, 16, 16, 8)):
        before = launch_counts()
        out = nms.largest_cc_batch(torch.zeros(shape, dtype=torch.int32,
                                               device="cuda"), 4)
        check(tuple(out.shape) == shape and sum(launches_since(before).values()) == 0,
              f"K2 at 0 maps {shape}: no launch")
    res["kernels"] = ("K1 forward 1 launch (zero statistics, the plain "
                      "losses), backward 0; K2 2D / 3D 0 launches")
    return res


def share_weights(save_dir: str) -> dict:
    """The ACAL model's weights in a run's latest slot, on the host."""
    cfg = acal_config()
    model = net_factory("acalnet", 1, 4, cfg.model, device="cuda")
    CheckpointManager(save_dir).restore_latest(create_share_state(model, cfg))
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def share_eval(weights: dict) -> np.ndarray:
    """(k): both decoders of the ACAL model with ``weights`` evaluated as
    the trainer evaluates them (evaluate_volumes, TF32 on) at this
    process's W, on (k)'s val volumes: [2, classes - 1, 2]."""
    set_tf32(True)
    cfg = acal_config()
    model = net_factory("acalnet", 1, 4, cfg.model, device="cuda")
    model.load_state_dict(weights)
    val = dist_val_set(acal_config())
    return np.stack([evaluate_volumes(val, make_predictor(model, name, device="cuda"),
                                      4, tuple(cfg.data.image_size))
                     for name in ("model1", "model2")])


def share_trainer_run(tag: str, tf32: bool = False) -> dict:
    """(k): cli.train_share_2d at SHARE_DIST_ARGV at this process's W (TF32
    off, as the bars of (b)-(j); with ``tf32`` on, the card's default), its
    memory bank recorded: the result, the run dirs beside its own, rank 0's
    records (None elsewhere), every replay draw's masks, each feed's new
    entries (score, window corner), and the launches."""
    from chap_tpu_torch.train import trainer_share

    masks, feeds = [], []

    class RecordingBank(ImageMemoryBank):
        def add(self, images, knowledge, n):
            before = len(self._scores)
            super().add(images, knowledge, n)
            feeds.append([(s, np.argwhere(m)[0].tolist()) for s, m in
                          zip(self._scores[before:], self._masks[before:])])

        def get_samples(self, batch_size=12):
            out = super().get_samples(batch_size)
            masks.append(out["mask"].copy())
            return out

    set_tf32(tf32)
    real = trainer_share.ImageMemoryBank
    trainer_share.ImageMemoryBank = RecordingBank
    zero_launch_counts()
    t0 = time.perf_counter()
    try:
        out = cli_share.main(SHARE_DIST_ARGV + ["--exp", tag])
    finally:
        trainer_share.ImageMemoryBank = real
    return {"result": out, "wall_s": time.perf_counter() - t0,
            "runs": sorted(os.listdir(os.path.dirname(out["save_dir"]))),
            "records": _records(out["save_dir"]) if dist.is_main() else None,
            "replay_masks": masks, "feeds": feeds, "launches": launch_counts()}


def ablation_trainer_run(tag: str) -> dict:
    """(l): cli.train_2d --mode ablation at configs/acdc_chap.yml's values,
    ABLATION_DIST_STEPS steps, at this process's W: the result, the run
    dirs, rank 0's disagreement.csv rows and records, the launches (TF32
    off, as (k))."""
    set_tf32(False)
    zero_launch_counts()
    out = cli_train.main(TRAINER_FLAGS + DIST_OVERRIDES + [
        "--mode", "ablation", "--exp", tag, "--max_iterations",
        str(ABLATION_DIST_STEPS)])
    rows = records = None
    if dist.is_main():
        with open(os.path.join(out["save_dir"], "disagreement.csv")) as f:
            rows = [line.strip().split(",") for line in f][1:]
        records = _records(out["save_dir"])
    return {"result": out, "csv": rows, "records": records,
            "runs": sorted(os.listdir(os.path.dirname(out["save_dir"]))),
            "launches": launch_counts()}


def wrong_steps(init: dict, rows, fault: str) -> dict:
    """(e)'s negative controls, the LA steps with a wrong update:
    ``left_out`` zeroes rank 1's gradient before the all-reduce (at W = 2
    half the batch's gradient is lost), ``scaled`` scales every summed
    gradient by SCALED_GRADIENT (in one process too)."""
    real = dist.all_reduce_grads

    def wrong(params):
        params = [p for p in params if p.grad is not None]
        if fault == "left_out" and dist.rank() == 1:
            for p in params:
                p.grad.zero_()
        real(params)
        if fault == "scaled":
            for p in params:
                p.grad.mul_(SCALED_GRADIENT)

    dist.all_reduce_grads = wrong
    try:
        return dist_steps(init, rows, kind="la", warm_up=False)
    finally:
        dist.all_reduce_grads = real


def dist_rank_phase(inits: dict, eval_weights: dict, share_w: dict,
                    steps_done) -> dict:
    """What each gloo rank on the card runs in phase 23 at W = 2: (b) the
    bare 2D steps on its rows, with the all-reduce ms of the same
    collectives replayed alone after them; (e) the LA steps in fp32 and as
    written (bf16), (f) the BraTS unet_3D steps, (i) the ACAL iterations,
    (j) the ablation steps, (g) the sliding-window eval; then
    ``steps_done`` set (the card is no longer the ranks' alone); (c)
    cli.train_2d, 6 steps and --resume to 9 (TF32 on, as phase 8), and
    the eval of its latest weights at W = 2; (k) cli.train_share_2d with
    TF32 off and on, and the eval of ``share_w`` (trained ACAL weights) at
    W = 2; (l) cli.train_2d --mode ablation."""
    out = {"rank": dist.rank(), "world": dist.world_size()}
    out["acdc"] = dist_steps(inits["acdc"], dist_rows("acdc"), warm_up=False)
    collective_figures(out["acdc"], replay=True)
    for kind in ("la", "la_bf16", "brats") + SHARE_KINDS:
        out[kind] = dist_steps(inits["la" if kind == "la_bf16" else kind],
                               dist_rows(kind), kind=kind, warm_up=False)
        collective_figures(out[kind])
    out["la_left_out"] = wrong_steps(inits["la"], dist_rows("la"), "left_out")
    out["eval3d"] = dist_eval_3d(eval_weights)
    if dist.is_main():
        steps_done.set()
    torch.cuda.empty_cache()

    set_tf32(True)
    argv = TRAINER_FLAGS + DIST_OVERRIDES + ["--exp", "w2"]
    zero_launch_counts()
    first = cli_train.main(argv + ["--max_iterations", str(DIST_TRAINER_STEPS)])
    resumed = cli_train.main(argv + ["--max_iterations", str(DIST_RESUME_STEPS),
                                     "--resume"])
    out["trainer"] = {"first": first, "resumed": resumed,
                      "launches": launch_counts()}
    out["eval_w2"] = dist_eval(resumed["save_dir"])
    out["share_trainer"] = share_trainer_run("w2_share")
    out["share_trainer_tf32"] = share_trainer_run("w2_share_tf32", tf32=True)
    out["share_eval"] = share_eval(share_w)
    out["ablation_trainer"] = ablation_trainer_run("w2_ablation")
    return out


def dist_rank_phase4(inits: dict) -> dict:
    """What each gloo rank runs at W = 4: (d) the bare 2D steps (three
    pairs of each stream a rank), (e) the LA steps in fp32 (ranks 0 and
    2 hold no row), (i) the ACAL iterations and (j) the ablation steps
    (three labeled and three unlabeled rows a rank)."""
    out = {"rank": dist.rank(), "world": dist.world_size()}
    for kind in ("acdc", "la") + SHARE_KINDS:
        out[kind] = dist_steps(inits[kind], dist_rows(kind), kind=kind,
                               warm_up=False)
        collective_figures(out[kind])
    return out


def dist_gaps(got: dict, want: dict, init: dict) -> dict:
    """How far one run of dist_steps lies from another: the largest relative
    gap of a metric over the steps; the parameters' update from ``init``,
    the BN running statistics and the GradSim scores each as one vector,
    |got - want| / |want| (norms), and for the ACAL model the update of
    each parameter group (encoder, decoders) apart; and the largest element
    gap of each of these (a model without BN, or a step without GradSim,
    has no such entry). Where both runs kept their first step's state
    (FIRST_STEP_KINDS), the same of the first step alone: ``first_metrics``,
    ``first_update``, ``first_running``."""
    def vec(state, keys, minus=None):
        return torch.cat([(state[k].double() - (0 if minus is None else
                                                 minus[k].double())).reshape(-1)
                          for k in keys])

    running = [k for k in want["params"] if k.endswith(("running_mean",
                                                         "running_var"))]
    params = [k for k, v in want["params"].items()
              if v.is_floating_point() and k not in running]
    pairs = {"update": (vec(got["params"], params, init),
                        vec(want["params"], params, init))}
    if any(k.startswith("encoder.") for k in params) and want["counts"][0] is not None:
        # the ACAL model's two parameter groups, each its own optimizer's
        for name, keep in (("update_encoder", True), ("update_decoders", False)):
            group = [k for k in params if k.startswith("encoder.") == keep]
            pairs[name] = (vec(got["params"], group, init),
                           vec(want["params"], group, init))
    if running:
        pairs["running"] = (vec(got["params"], running),
                            vec(want["params"], running))
    if want["sim"]:
        pairs["sim"] = (torch.cat([x.double().reshape(-1) for x in got["sim"]]),
                        torch.cat([x.double().reshape(-1) for x in want["sim"]]))
    first = (got.get("first_params") is not None
             and want.get("first_params") is not None)
    if first:
        pairs["first_update"] = (vec(got["first_params"], params, init),
                                 vec(want["first_params"], params, init))
        if running:
            pairs["first_running"] = (vec(got["first_params"], running),
                                      vec(want["first_params"], running))

    def worst(steps):
        return max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-6)
                   for g, w in zip(got["metrics"][:steps], want["metrics"][:steps])
                   for k in w)
    out = {"metrics": worst(len(want["metrics"]))}
    if first:
        out["first_metrics"] = worst(1)
    for name, (g, w) in pairs.items():
        # scores that the step never moves (the ablation step's) stay 0
        out[name] = float((g - w).norm() / max(float(w.norm()), 1e-30))
        out[name + "_max_abs"] = float((g - w).abs().max())
    return out


def hold_ranks(kind: str, ranks: list, one: dict, init: dict, bars: dict,
               world: int) -> dict:
    """Each rank's steps of ``kind`` against this process's: every gap
    within its bar, the rank's launches as dist_expected_launches says
    (at bf16 logits every K1 launch for la_bf16). Returns the figures."""
    gaps = [dist_gaps(got[kind], one, init) for got in ranks]
    print(f"dist {kind} W = {world} against one process: gaps "
          + json.dumps(gaps) + "; bars " + json.dumps(bars), flush=True)
    for got, gap in zip(ranks, gaps):
        r = got["rank"]
        check(got["world"] == world, f"rank {r} in a group of {world}")
        want = dist_expected_launches(kind, r, world)
        check(got[kind]["launches"] == want,
              f"{kind} W = {world} rank {r} launches {got[kind]['launches']}, "
              f"expected {want}")
        check(got[kind]["counts"] == one["counts"],
              f"{kind} W = {world} rank {r}: schedule counts {got[kind]['counts']}"
              f", one process {one['counts']}")
        if kind == "la_bf16":
            bf16 = got[kind]["launches_bf16"]
            check(bf16["K1_fwd"] == want["K1_fwd"] and bf16["K1_bwd"] == want["K1_bwd"],
                  f"la_bf16 rank {r}: every K1 launch at bf16 logits {bf16}")
        check(not over_bars(gap, bars),
              f"{kind} W = {world} rank {r} gaps {over_bars(gap, bars)} over "
              f"their bars {bars}: {gap}")
    return {"gaps": gaps, "bars": bars, "one_process_step_ms": one["step_ms"],
            "per_rank": [{k: got[kind][k] for k in (
                "rows", "step_ms", "launches", "collectives_per_step",
                "allreduce_mb_per_step") + (("allreduce_ms_per_step",)
                                             if "allreduce_ms_per_step" in got[kind]
                                             else ())}
                for got in ranks]}


def share_loss_gaps(got: list, want: list) -> dict:
    """By logged step, the largest relative gap of a loss in ``got``'s
    records to ``want``'s."""
    gaps = {}
    for g, w in zip(got, want):
        for k in SHARE_KEYS:
            if k in w:
                gaps[w["step"]] = max(gaps.get(w["step"], 0.0),
                                      abs(g[k] - w[k]) / max(abs(w[k]), 1e-6))
    return gaps


def replays_differing(got: dict, want: dict) -> int:
    """How many of a (k) run's replay draws picked other masks than
    ``want``'s."""
    return sum(not np.array_equal(a, b)
               for a, b in zip(got["replay_masks"], want["replay_masks"]))


def hold_share_trainer(ranks: list, one: dict) -> dict:
    """(k): the W = 2 ranks' cli.train_share_2d against this process's run:
    one run dir, written by rank 0; the same result on both ranks; W = 1's
    logged steps, losses within rtol 2e-3; every replay draw's masks equal
    to W = 1's on both ranks; both decoders' eval dice within 5e-3; the K1
    launches of 8 joint steps and the replays a rank."""
    got0 = ranks[0]
    check(all(r["result"] == got0["result"] for r in ranks)
          and got0["result"]["steps"] == SHARE_DIST_ITERATIONS,
          f"(k) both ranks return one result: {[r['result'] for r in ranks]}")
    check(got0["runs"] == ["run_0"] and ranks[1]["records"] is None,
          f"(k) one run dir, written by rank 0: {got0['runs']}")
    want = one["records"]
    check([r["step"] for r in got0["records"]] == [r["step"] for r in want],
          "(k) W = 2 writes W = 1's records")
    step_gaps = share_loss_gaps(got0["records"], want)
    gaps = list(step_gaps.values())
    dice_keys = ("model1_val_mean_dice", "model2_val_mean_dice")
    dice = [(g[k], w[k]) for g, w in zip(got0["records"], want)
            for k in dice_keys if k in w]
    replays = len(one["replay_masks"])
    differ = [replays_differing(r, one) for r in ranks]
    # where the banks part, if they do: the first feed whose windows differ,
    # and the largest relative gap of a new entry's score
    windows = [[c for _, c in f] for f in one["feeds"]]
    first = [next((i for i, f in enumerate(r["feeds"])
                   if [c for _, c in f] != windows[i]), None) for r in ranks]
    score_gap = max(abs(a[0] - b[0]) / max(abs(b[0]), 1e-30)
                    for r in ranks for fa, fb in zip(r["feeds"], one["feeds"])
                    for a, b in zip(fa, fb))
    res = {"iterations": SHARE_DIST_ITERATIONS, "replays": replays,
           "largest_rel_loss_gap": max(gaps), "rel_loss_gap_by_step": step_gaps,
           "first_feed_with_other_windows_per_rank": first,
           "largest_rel_score_gap": score_gap,
           "val_dice_w1_w2": dice, "replay_draws_differing_per_rank": differ,
           "launches_per_rank": [r["launches"] for r in ranks],
           "wall_s_per_rank": [r["wall_s"] for r in ranks],
           "wall_s_w1": one["wall_s"]}
    print("dist (k) gloo W = 2 cli.train_share_2d against W = 1: "
          + json.dumps(res), flush=True)
    check(replays == SHARE_DIST_ITERATIONS - 3
          and all(len(r["replay_masks"]) == replays for r in ranks),
          f"(k) replay from iteration 4 on every rank: {res}")
    check(max(gaps) <= RTOL, f"(k) losses within rtol 2e-3 of W = 1: {res}")
    check(differ == [0] * len(ranks), f"(k) the replay masks are W = 1's: {res}")
    check(len(dice) == 2 and all(abs(g - w) <= 5e-3 for g, w in dice),
          f"(k) both decoders' eval dice within 5e-3 of W = 1: {res}")
    want_k1 = 2 * (SHARE_DIST_ITERATIONS + replays)
    for r in ranks:
        check(r["launches"] == {**{k: 0 for k in r["launches"]},
                                "K1_fwd": want_k1, "K1_bwd": want_k1},
              f"(k) launches {r['launches']}, expected {want_k1} / {want_k1} K1")
    return res


def hold_share_tf32(ranks: list, one_on: dict, one_off: dict) -> dict:
    """(k) at the card's default, TF32 on: the W = 2 ranks' run against
    this process's, within twice this process's own gap between TF32 on
    and off (or rtol 2e-3): the part of W = 2's gap that TF32 rounding
    alone accounts for. Replay draws that part are counted, not held."""
    got0 = ranks[0]
    check([r["step"] for r in got0["records"]]
          == [r["step"] for r in one_on["records"]]
          == [r["step"] for r in one_off["records"]],
          "(k) TF32 on: W = 2 and W = 1 write the records of TF32 off")
    control = share_loss_gaps(one_on["records"], one_off["records"])
    gaps = share_loss_gaps(got0["records"], one_on["records"])
    bar = max(RTOL, 2 * max(control.values()))
    res = {"bar": bar,
           "control_w1_on_vs_off": {
               "largest_rel_loss_gap": max(control.values()),
               "rel_loss_gap_by_step": control,
               "replay_draws_differing": replays_differing(one_on, one_off)},
           "w2_vs_w1_on": {
               "largest_rel_loss_gap": max(gaps.values()),
               "rel_loss_gap_by_step": gaps,
               "replay_draws_differing_per_rank": [
                   replays_differing(r, one_on) for r in ranks]},
           # a reading, not held: which W = 1 run W = 2's TF32-on run follows
           "w2_on_vs_w1_off": {
               "largest_rel_loss_gap": max(share_loss_gaps(
                   got0["records"], one_off["records"]).values()),
               "replay_draws_differing_per_rank": [
                   replays_differing(r, one_off) for r in ranks]},
           "replays": len(one_on["replay_masks"]), "settings": "cudnn.allow_tf32=True"}
    print("dist (k) TF32 on, W = 2 against W = 1 beside W = 1 on against off: "
          + json.dumps(res), flush=True)
    check(max(gaps.values()) <= bar,
          f"(k) TF32 on: W = 2's losses within twice TF32's own gap: {res}")
    for r in ranks:
        check(r["launches"] == one_on["launches"] == one_off["launches"],
              f"(k) TF32 on: launches {r['launches']} as TF32 off's")
    return res


def hold_share_eval(ranks: list, one: np.ndarray) -> dict:
    """(k): the eval of trained ACAL weights (both decoders' val dice above
    0) at W = 2 equal to W = 1's on every rank."""
    dice = one[:, :, 0].mean(axis=1).tolist()
    res = {"mean_dice_model1_model2": dice,
           "equal_on_ranks": [bool(np.array_equal(r, one)) for r in ranks]}
    print("dist (k) eval of trained ACAL weights at W = 2 against W = 1: "
          + json.dumps(res), flush=True)
    check(min(dice) > 0, f"(k) the trained weights' dice is above 0: {res}")
    check(all(res["equal_on_ranks"]),
          f"(k) eval at W = 2 equals W = 1's on the same weights: {res} "
          f"{[r.tolist() for r in ranks]} against {one.tolist()}")
    return res


def hold_ablation_trainer(ranks: list, one: dict) -> dict:
    """(l): the W = 2 ranks' cli.train_2d --mode ablation against this
    process's: one run dir written by rank 0, disagreement.csv's iterations
    as W = 1's and its ratios (a global mean) within 5e-3, losses within
    rtol 2e-3; 2 / 2 K1 launches a step a rank."""
    got0 = ranks[0]
    check(all(r["result"] == got0["result"] for r in ranks)
          and got0["runs"] == ["run_0"] and ranks[1]["csv"] is None,
          f"(l) one result and one run dir: {got0['runs']}")
    check([r[0] for r in got0["csv"]] == [r[0] for r in one["csv"]]
          == [str(i) for i in range(1, ABLATION_DIST_STEPS + 1)],
          f"(l) disagreement.csv iterations {got0['csv']} against {one['csv']}")
    ratio_gap = max(abs(float(g[1]) - float(w[1]))
                    for g, w in zip(got0["csv"], one["csv"]))
    loss_gap = max(abs(g["loss"] - w["loss"]) / abs(w["loss"])
                   for g, w in zip(got0["records"], one["records"]) if "loss" in w)
    res = {"steps": ABLATION_DIST_STEPS, "ratios_w2": [float(r[1]) for r in got0["csv"]],
           "ratios_w1": [float(r[1]) for r in one["csv"]],
           "largest_ratio_gap": ratio_gap, "largest_rel_loss_gap": loss_gap,
           "launches_per_rank": [r["launches"] for r in ranks]}
    print("dist (l) gloo W = 2 ablation trainer against W = 1: " + json.dumps(res),
          flush=True)
    check(ratio_gap <= 5e-3, f"(l) ratios within 5e-3 of W = 1: {res}")
    check(loss_gap <= RTOL, f"(l) losses within rtol 2e-3 of W = 1: {res}")
    want = {k: v * ABLATION_DIST_STEPS for k, v in ABLATION_LAUNCHES_PER_STEP.items()}
    for r in ranks:
        check(r["launches"] == want, f"(l) launches {r['launches']}, expected {want}")
    return res


def control_bars(controls: list) -> dict:
    """Each gap's bar from several control draws (dist_gaps of this
    process's own steps in other summation orders, CONTROL_CONVS): twice
    the largest draw, or rtol 2e-3 where that is larger."""
    return {k: max(RTOL, 2 * max(c[k] for c in controls)) for k in controls[0]
            if not k.endswith("_max_abs")}


def over_bars(gap: dict, bars: dict) -> dict:
    """The gaps of ``gap`` over their bar in ``bars``."""
    return {k: v for k, v in gap.items() if k in bars and v > bars[k]}


def hold_negative_control(kind: str, wrong: list, one: dict, init: dict,
                          bars: dict) -> dict:
    """The bars of ``kind`` must reject each wrong run in ``wrong`` (name,
    steps): some gap over its bar. Prints the ``dist (e) negative
    control`` line."""
    res = {}
    for name, steps in wrong:
        gap = dist_gaps(steps, one, init)
        res[name] = {"gap": gap, "over": over_bars(gap, bars)}
    print(f"dist (e) negative control {kind}: "
          + json.dumps({"bars": bars, **res}), flush=True)
    for name in res:
        check(bool(res[name]["over"]), f"(e) negative control {name}: the bars "
              f"of {kind} rejected no gap of a wrong update: {res[name]}")
    return res


def torchrun(module: str, argv: list) -> subprocess.Popen:
    """``module`` under torchrun --nproc_per_node 1 (NCCL), started now."""
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", "-m", module, *argv],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def torchrun_losses(launch: subprocess.Popen, said: str, run_dir: str,
                    ref: dict, what: str) -> float:
    """Check a torchrun W = 1 run against the same run in this process:
    an NCCL group, the same logged steps, losses within rtol 2e-3; returns
    the largest relative gap."""
    check(launch.returncode == 0, f"{what}: {said[-4000:]}")
    check("data parallel: backend nccl, rank 0 of 1" in said,
          f"{what} joined an NCCL group: {said[-2000:]}")
    got = {r["step"]: r["loss"] for r in _records(run_dir) if "loss" in r}
    check(sorted(got) == sorted(ref), f"{what} logged steps {sorted(got)}")
    gap = max(abs(got[s] - ref[s]) / abs(ref[s]) for s in ref)
    print(f"dist {what}: {len(ref)} losses, largest relative gap to one "
          f"process {gap:.3e}", flush=True)
    check(gap <= RTOL, f"{what} losses against one process: largest "
                       f"relative gap {gap}")
    return gap


def phase_dist(share_w: dict = None) -> dict:
    """Phase 23: the port's data parallelism on the one card, W gloo ranks
    sharing it (NCCL puts no two ranks on one device): (b) W = 2 and (d) W
    = 4, three bare 2D CHAP steps against this process's steps on the
    global batches; (e) the LA CHAP step at W = 2 and 4 (fp32, ranks
    without rows at W = 4) and at W = 2 as written (bf16, timed); (f) the
    BraTS unet_3D supervised step at W = 2; (g) the sliding-window eval at
    W = 2 against W = 1's maps; (a) cli.train_2d and (h) cli.train_3d under
    torchrun at W = 1 over NCCL against the same runs in this process; (c)
    the W = 2 2D trainer with a resume, its evals against W = 1's; (i)-(l)
    the ACAL and ablation paths, (k)'s eval on ``share_w``, trained ACAL
    weights (phase 16's, or trained here when None). The gloo figures are
    of ranks sharing one card, not a multi-card speed."""
    if share_w is None:
        share_w = phase_trainer_share()["weights"]
    t_phase = time.perf_counter()
    shutil.rmtree(DIST_RUNS, ignore_errors=True)
    res = {"card": card_line(), "zero_rows": zero_row_ops()}

    # the references, this process's steps on the global batches, and their
    # control: the same steps on PyTorch's own convolutions, which sum in
    # another order (the step's discrete choices, the VAT direction, the
    # top-k mask, LeakyReLU's kink under the GradSim cosines, the argmax
    # pseudo-labels, amplify that)
    inits = {kind: dist_init(kind) for kind in ("acdc", "la", "brats") + SHARE_KINDS}
    one, bars = {}, {}
    for kind in ("acdc", "la", "brats") + SHARE_KINDS:
        one[kind] = dist_steps(inits[kind], lambda batch: batch, kind=kind)
        check(one[kind]["collectives"] == [], "one process makes no collective")
        # the control draws: the same steps in each other summation order
        # (CONTROL_CONVS), the cuDNN steps themselves once more
        controls = [dist_gaps(dist_steps(inits[kind], lambda batch: batch,
                                         conv=conv, kind=kind, warm_up=False),
                              one[kind], inits[kind]) for conv in CONTROL_CONVS]
        print(f"dist control {kind} ({', '.join(CONTROL_CONVS)}): "
              + json.dumps(controls), flush=True)
        bars[kind] = control_bars(controls)
        if kind in FIRST_STEP_KINDS:
            # held at the first step (first_metrics); FIRST_STEP_KINDS
            del bars[kind]["metrics"]
        res[f"control_{kind}"] = controls
    # (e)'s smaller planted fault, in this process
    la_scaled = wrong_steps(inits["la"], lambda batch: batch, "scaled")
    # the bf16 step at W ranks against this process's bf16 step: within
    # twice this process's bf16-against-fp32 gap
    one["la_bf16"] = dist_steps(inits["la"], lambda batch: batch, kind="la_bf16")
    res["bf16_vs_fp32_la"] = dist_gaps(one["la_bf16"], one["la"], inits["la"])
    bars["la_bf16"] = control_bars([res["bf16_vs_fp32_la"]])
    eval_weights = dist_eval_weights(inits["la"])
    eval_w1 = dist_eval_3d(eval_weights)
    check(all(len(np.unique(m)) > 1 for m in eval_w1["maps"]),
          "(g) label maps of more than one class")
    share_eval_w1 = share_eval(share_w)
    torch.cuda.empty_cache()
    res["references_s"] = time.perf_counter() - t_phase

    # the W = 2 ranks; the card is theirs until they have timed their steps
    # and the eval, then (a), (h) and the W = 1 trainer runs beside (c)
    t_spawn = time.perf_counter()
    steps_done = mp.get_context("spawn").Event()
    pool = concurrent.futures.ThreadPoolExecutor(1)
    spawned = pool.submit(dist.spawn_ranks, dist_rank_phase, 2,
                          (inits, eval_weights, share_w, steps_done), backend="gloo",
                          device="cuda", timeout=900)
    pool.shutdown(wait=False)
    while not steps_done.wait(1.0):
        if spawned.done():
            spawned.result()          # raises what the ranks raised
            check(False, "the ranks ended before their timed steps")

    # (a) cli.train_2d and (h) cli.train_3d under torchrun, one rank over
    # NCCL, beside the same runs in this process
    t0 = time.perf_counter()
    launch = torchrun("chap_tpu_torch.cli.train_2d", [
        *TRAINER_FLAGS, *DIST_OVERRIDES, "--exp", "nccl1", "--max_iterations",
        str(DIST_TRAINER_STEPS)])
    launch3d = torchrun("chap_tpu_torch.cli.train_3d", [
        *TRAINER3D_FLAGS, *DIST3D_OVERRIDES, "--exp", "nccl1_3d",
        "--max_iterations", str(DIST3D_STEPS)])
    try:
        set_tf32(True)
        argv = TRAINER_FLAGS + DIST_OVERRIDES + ["--exp", "w1"]
        w1 = cli_train.main(argv + ["--max_iterations", str(DIST_TRAINER_STEPS)])
        cli_train.main(argv + ["--max_iterations", str(DIST_RESUME_STEPS),
                               "--resume"])
        w1_3d = cli_train3d.main(TRAINER3D_FLAGS + DIST3D_OVERRIDES + [
            "--exp", "w1_3d", "--max_iterations", str(DIST3D_STEPS)])
        w1_share = share_trainer_run("w1_share")
        w1_share_tf32 = share_trainer_run("w1_share_tf32", tf32=True)
        w1_ablation = ablation_trainer_run("w1_ablation")
        said = launch.communicate(timeout=300)[0]
        said3d = launch3d.communicate(timeout=300)[0]
    finally:
        for p in (launch, launch3d):
            if p.poll() is None:
                p.kill()
                p.wait()
    torchrun_s = time.perf_counter() - t0
    ranks = spawned.result()
    res["spawn_s"] = time.perf_counter() - t_spawn
    w1_records = _records(w1["save_dir"])
    gap_a = torchrun_losses(
        launch, said, os.path.join(DIST_RUNS, "synthetic", "nccl1_7_labeled",
                                   "dualdecoder", "run_0"),
        {r["step"]: r["loss"] for r in w1_records
         if "loss" in r and r["step"] <= DIST_TRAINER_STEPS},
        "(a) torchrun W = 1 cli.train_2d")
    res["a_nccl_w1"] = {"largest_rel_loss_gap": gap_a,
                        "torchrun_s_beside_other_runs": torchrun_s}
    la_labeled = la_config().data.labeled_num
    gap_h = torchrun_losses(
        launch3d, said3d, os.path.join(DIST_RUNS, "synthetic",
                                       f"nccl1_3d_{la_labeled}_labeled",
                                       "dualdecoder3d", "run_0"),
        {r["step"]: r["loss"] for r in _records(w1_3d["save_dir"]) if "loss" in r},
        "(h) torchrun W = 1 cli.train_3d")
    res["h_nccl_w1_3d"] = {"largest_rel_loss_gap": gap_h, "steps": DIST3D_STEPS,
                           "config": "configs/la_chap.yml as written (bf16)"}

    # (b), (e) at W = 2, (f)
    res["b_gloo_w2_steps"] = hold_ranks("acdc", ranks, one["acdc"],
                                        inits["acdc"], bars["acdc"], 2)
    res["e_gloo_w2_la"] = hold_ranks("la", ranks, one["la"], inits["la"],
                                     bars["la"], 2)
    # the bars still reject a wrong update: rank 1's gradient left out of
    # the all-reduce, and every summed gradient scaled by SCALED_GRADIENT
    res["e_negative_control"] = hold_negative_control(
        "la", [(f"left_out rank {got['rank']}", got["la_left_out"]) for got in ranks]
        + [(f"scaled x{SCALED_GRADIENT}", la_scaled)],
        one["la"], inits["la"], bars["la"])
    res["e_gloo_w2_la_bf16"] = hold_ranks("la_bf16", ranks, one["la_bf16"],
                                          inits["la"], bars["la_bf16"], 2)
    res["f_gloo_w2_brats"] = hold_ranks("brats", ranks, one["brats"],
                                        inits["brats"], bars["brats"], 2)

    # (g): every rank's label maps against W = 1's
    total = sum(m.size for m in eval_w1["maps"])
    g_res = {"voxels": total, "eval_s_w1": eval_w1["eval_s"], "per_rank": []}
    for got in ranks:
        r, ev = got["rank"], got["eval3d"]
        differ = sum(int((a != b).sum()) for a, b in zip(ev["maps"], eval_w1["maps"]))
        check(differ <= 1e-3 * total,
              f"(g) W = 2 rank {r}: {differ} of {total} voxels differ from W = 1")
        check(ev["launches"] == dist_eval_launches(r, 2),
              f"(g) rank {r} K3 launches {ev['launches']}, expected "
              f"{dist_eval_launches(r, 2)}")
        metric_gap = float(np.abs(np.asarray(ev["metrics"]) - eval_w1["metrics"]).max())
        g_res["per_rank"].append({"voxels_differing": differ,
                                  "largest_metric_gap": metric_gap,
                                  "launches": ev["launches"],
                                  "eval_s": ev["eval_s"]})
    print("dist (g) sliding-window eval W = 2 against W = 1: "
          + json.dumps(g_res), flush=True)
    res["g_gloo_w2_eval3d"] = g_res

    # (c): rank 0 picked one run dir and wrote it once; evals as W = 1's
    resumed = ranks[0]["trainer"]["resumed"]
    check(all(got["trainer"]["resumed"] == resumed for got in ranks)
          and resumed["steps"] == DIST_RESUME_STEPS
          and resumed["save_dir"] == ranks[0]["trainer"]["first"]["save_dir"],
          f"W = 2 resume continues one run to {DIST_RESUME_STEPS}: {resumed}")
    check(os.listdir(os.path.dirname(resumed["save_dir"])) == ["run_0"],
          "W = 2 trainer: one run dir")
    w2_records = _records(resumed["save_dir"])
    check([r["step"] for r in w2_records] == [r["step"] for r in w1_records],
          "W = 2 writes W = 1's records, once")
    want_launches = {k: v * DIST_RESUME_STEPS for k, v in LAUNCHES_PER_STEP.items()}
    for got in ranks:
        check(got["trainer"]["launches"] == want_launches,
              f"W = 2 trainer launches {got['trainer']['launches']}")
    dice = [{r["step"]: r["val_mean_dice"] for r in records
             if "val_mean_dice" in r} for records in (w1_records, w2_records)]
    evals_at = [3, 6, 9]        # eval.eval_every=3 to DIST_RESUME_STEPS
    check(sorted(dice[0]) == sorted(dice[1]) == evals_at,
          f"evals at {evals_at}: {dice}")
    dice_gap = max(abs(dice[1][s] - dice[0][s]) for s in dice[0])
    val = [[row.split(",")[1:] for row in
            open(os.path.join(d, "val.csv")).read().splitlines()[1:]]
           for d in (w1["save_dir"], resumed["save_dir"])]
    print(f"dist (c) gloo W = 2 trainer: val dice {dice[1]} against W = 1 "
          f"{dice[0]}; val.csv (iteration, val_acc) {val}", flush=True)
    check(dice_gap <= 5e-3, f"W = 2 eval dice within 5e-3 of W = 1: {dice}")
    check([row[0] for row in val[0]] == [row[0] for row in val[1]]
          and all(abs(float(a[1]) - float(b[1])) <= 5e-3
                  for a, b in zip(*val)),
          f"W = 2 val.csv as W = 1's: {val}")
    eval_w1_2d = dist_eval(resumed["save_dir"])
    for got in ranks:
        check(np.array_equal(got["eval_w2"], eval_w1_2d),
              f"eval at W = 2 {got['eval_w2'].tolist()} equals W = 1's "
              f"{eval_w1_2d.tolist()} on the same weights")
    res["c_gloo_w2_trainer"] = {
        "val_dice_w1": dice[0], "val_dice_w2": dice[1],
        "largest_val_dice_gap": dice_gap, "eval_w2_equals_w1": True,
        # batch x steps over the wall time of the resumed segment, the card
        # shared with the W = 1 runs of (a) and (c) for part of it
        "window_slices_per_s_w2_beside_other_runs": [acdc_chap_config().data.batch_size
                                   * r["steps_per_sec"]
                                   for r in w2_records
                                   if "steps_per_sec" in r][-1]}

    # (i), (j) at W = 2
    res["i_gloo_w2_acal"] = hold_ranks("acal", ranks, one["acal"], inits["acal"],
                                       bars["acal"], 2)
    res["j_gloo_w2_ablation"] = hold_ranks("ablation", ranks, one["ablation"],
                                           inits["ablation"], bars["ablation"], 2)
    res["k_gloo_w2_share_trainer"] = hold_share_trainer(
        [got["share_trainer"] for got in ranks], w1_share)
    res["k_tf32_on"] = hold_share_tf32(
        [got["share_trainer_tf32"] for got in ranks], w1_share_tf32, w1_share)
    res["k_eval_trained_weights"] = hold_share_eval(
        [got["share_eval"] for got in ranks], share_eval_w1)
    res["l_gloo_w2_ablation_trainer"] = hold_ablation_trainer(
        [got["ablation_trainer"] for got in ranks], w1_ablation)
    del ranks
    torch.cuda.empty_cache()

    # (d), (e), (i) and (j) at W = 4
    t_spawn = time.perf_counter()
    ranks4 = dist.spawn_ranks(dist_rank_phase4, 4, (inits,), backend="gloo",
                              device="cuda", timeout=600)
    res["spawn4_s"] = time.perf_counter() - t_spawn
    res["d_gloo_w4_steps"] = hold_ranks("acdc", ranks4, one["acdc"],
                                        inits["acdc"], bars["acdc"], 4)
    res["e_gloo_w4_la"] = hold_ranks("la", ranks4, one["la"], inits["la"],
                                     bars["la"], 4)
    res["i_gloo_w4_acal"] = hold_ranks("acal", ranks4, one["acal"],
                                       inits["acal"], bars["acal"], 4)
    res["j_gloo_w4_ablation"] = hold_ranks("ablation", ranks4, one["ablation"],
                                           inits["ablation"], bars["ablation"], 4)
    res["phase_s"] = time.perf_counter() - t_phase
    print("dist", json.dumps(res), flush=True)
    shutil.rmtree(DIST_RUNS, ignore_errors=True)
    return res


def loop_breakdown(when: str, rounds: int = 2, n: int = 5) -> dict:
    """What the trainer's loop adds to the bare step, in one process at one
    moment: ms per step on phase 6's phantom batches and on batches the
    device pool's batch function draws each step, each with a sync after
    every step and with one sync after ``n`` steps (the trainer's way),
    alternated over ``rounds``; and the batch function's own device ms.
    ``when`` tags the line. main does not run it: call it by hand."""
    set_tf32(True)     # PyTorch's defaults, as in phase 6
    cfg =cli_train.build_config(cli_train.parse_args(
        TRAINER_FLAGS + TRAINER_OVERRIDES))
    state, step = make_step(cfg, "cuda", seed=1337)
    slices = cfg.data.synthetic_train_size
    labeled = patients_to_slices(cfg.data.dataset, cfg.data.labeled_num)
    pool = build_device_pool(SyntheticSliceDataset(
        cfg.data.image_size[0], cfg.data.num_classes, slices),
        cfg.data.image_size, device="cuda")
    batch_fn = build_device_batch_fn(slices, labeled, cfg.data.batch_size,
                                     cfg.data.labeled_bs)
    gen = torch.Generator(device="cuda").manual_seed(1337)
    bgen = torch.Generator(device="cuda").manual_seed(7)
    phantoms = [phantom_inputs(cfg, 10 + i, "cuda") for i in range(n)]
    step(state, phantoms[0], gen)                    # warm-up
    torch.cuda.synchronize()

    def run(pooled: bool, sync_each: bool) -> float:
        t0 = time.perf_counter()
        for i in range(n):
            step(state, batch_fn(pool, bgen) if pooled else phantoms[i], gen)
            if sync_each:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    kinds = {"phantom_sync_each": (False, True), "pool_sync_each": (True, True),
             "pool_sync_end": (True, False), "phantom_sync_end": (False, False)}
    ms = {k: [] for k in kinds}
    for _ in range(rounds):
        for k, (pooled, sync_each) in kinds.items():
            ms[k].append(run(pooled, sync_each))
    res = {"ms_per_step": ms,
           "batch_fn_device_ms": device_ms(lambda: batch_fn(pool, bgen), 50),
           "batch_fn_host_us": host_us(lambda: batch_fn(pool, bgen), 50),
           "steps": n, "rounds": rounds, "when": when}
    print("loop", json.dumps(res), flush=True)
    return res


def main() -> int:
    phase_s, t_mark = {}, [time.perf_counter()]

    def lap(name: str) -> None:
        """The seconds since the last lap, as phase ``name``'s."""
        now = time.perf_counter()
        phase_s[name] = now - t_mark[0]
        t_mark[0] = now

    # phase 1: device
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card")
    card = card_line()
    print("card", card, flush=True)
    import triton
    print(f"torch {torch.__version__} cuda {torch.version.cuda} triton "
          f"{triton.__version__} python {sys.version.split()[0]} "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # phase 2: build: one nvcc per CUDA source, all started together, while
    # Triton compiles K1
    t0 = time.perf_counter()
    sources = ("ccl.cu", "sliding_window.cu")
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        nvcc = {src: pool.submit(cuda_build.build, src) for src in sources}
        logits, labels, labels2, mask = k1_inputs((1, 4, 8, 8), 0)
        for lab2 in (None, labels2):       # K1 with R = 1 and R = 2
            x = logits.clone().requires_grad_(True)
            sum(fused_losses.region_dice_ce(x, labels, mask, lab2)).backward()
        torch.cuda.synchronize()
        triton_s = time.perf_counter() - t0
        built = {src: f.result() for src, f in nvcc.items()}
    print("build " + " ".join(f"nvcc_s[{src}]={b['seconds']:.2f}"
                              for src, b in built.items())
          + f" triton_first_call_s={triton_s:.2f} "
          f"wall_s={time.perf_counter() - t0:.2f}", flush=True)
    for b in built.values():
        for kernel, use in ptxas_summary(b["log"]):
            print("ptxas", kernel, use, flush=True)
    lap("1-2_device_build")

    # phase 3: K1
    set_tf32(False)
    k1 = phase_k1((6, 4, 256, 256), 1, 2, timed=True)   # mix_loss's shape
    k1_r1 = phase_k1((6, 4, 256, 256), 1, 1, timed=True)
    for regions in (1, 2):
        phase_k1((1, 4, 23, 29), 2, regions)
    # C = 3 pads the class axis to 4: labels 3 and 4 lie outside [0, C)
    phase_k1((2, 3, 23, 29), 3, 2, label_values=5)
    # the 3D step's calls: the 3D mix_loss (R = 2, sub_bs 1) and
    # dice_ce_supervised on the labeled half (R = 1), and a ragged volume
    k1_3d = phase_k1((1, 2) + LA_PATCH, 4, 2, timed=True)
    k1_3d_r1 = phase_k1((2, 2) + LA_PATCH, 4, 1, timed=True)
    phase_k1((2, 3, 23, 29, 17), 5, 2, label_values=5)
    # the ACAL joint step's and max-step's dice_ce_supervised on the labeled
    # half (R = 1)
    k1_acal = phase_k1((12, 4, 256, 256), 6, 1, timed=True)
    # the BraTS supervised step's dice_ce_supervised (R = 1) on a unet_3D
    # output; torch.profiler has returned empty sessions for K1 late in the
    # process, so every timed K1 shape is checked here
    k1_brats = phase_k1((4, 2) + BRATS_PATCH, 7, 1, timed=True)
    # K1 at bf16 logits (the configs as written compute in bf16): the LA
    # step's 3D mix_loss (R = 2) and supervised (R = 1) calls, the BraTS
    # supervised call, and the ACAL / ablation steps' supervised call on
    # the labeled half in bf16 (model.dtype=bfloat16)
    bf16 = torch.bfloat16
    k1_bf16 = {"la": phase_k1((1, 2) + LA_PATCH, 8, 2, timed=True, dtype=bf16),
               "la_r1": phase_k1((2, 2) + LA_PATCH, 8, 1, timed=True, dtype=bf16),
               "brats": phase_k1((4, 2) + BRATS_PATCH, 9, 1, timed=True,
                                 dtype=bf16),
               "acal": phase_k1((12, 4, 256, 256), 10, 1, timed=True,
                                dtype=bf16)}
    # the 2D zoo's single-decoder supervised step (R = 1) on the whole batch
    k1_zoo2d = phase_k1((24, 4, 256, 256), 11, 1, timed=True)
    lap("3_k1")
    # phase 4: K2
    k2 = phase_k2()
    lap("4_k2")
    # phase 5: CUDA-against-CPU step parity
    phase_parity()
    lap("5_parity")
    # phase 6: the slice at full width
    launches, bare_step_ms = phase_slice()
    lap("6_slice")
    # phase 7: eval parity, card against CPU
    phase_eval_parity()
    lap("7_eval")
    # phase 8: the trainer through its CLI at full width
    trainer = phase_trainer(bare_step_ms)
    torch.cuda.empty_cache()
    lap("8_trainer")
    # phases 9-14: the 3D path
    k2_3d = phase_k2_3d()
    k3 = phase_k3()
    k3_brats = phase_k3_brats()
    k3_bf16 = phase_k3_bf16()
    lap("9-10_k2_3d_k3")
    phase_parity_3d()
    launches_3d, slice_3d, profile_3d = phase_slice_3d()
    lap("11-12_parity_slice_3d")
    trainer_3d = phase_trainer_3d(slice_3d["median_step_ms"])
    torch.cuda.empty_cache()
    lap("13_trainer3d")
    # phases 14-17: the ACAL trainer and the ablation step
    phase_parity_share()
    slice_share = phase_slice_share()
    lap("14-15_acal")
    trainer_share = phase_trainer_share()
    trainer_ablation = phase_trainer_ablation()
    torch.cuda.empty_cache()
    lap("16-17_trainer_acal_ablation")
    # phases 18-20: the 3D zoo and the BraTS supervised protocol
    phase_parity_zoo3d()
    slice_zoo = phase_slice_zoo3d()
    trainer_zoo = phase_trainer_zoo3d()
    torch.cuda.empty_cache()
    lap("18-20_zoo3d")
    # phase 21: configs/la_chap.yml, pancreas_chap.yml and
    # brats_supervised.yml as written (bf16)
    slice_bf16 = phase_slice_bf16()
    torch.cuda.empty_cache()
    # beside it: the ACAL and ablation paths in bf16 (by override)
    share_bf16 = phase_slice_bf16_share()
    torch.cuda.empty_cache()
    lap("21_bf16")
    # phase 24: the 2D zoo
    zoo2d = phase_zoo2d()
    lap("24_zoo2d")
    # phase 25: the library (models no factory key reaches, convert)
    library = phase_library()
    lap("25_library")
    # phase 23: data parallelism (torchrun over NCCL at W = 1, two gloo
    # ranks on the card)
    dist_res = phase_dist(trainer_share.pop("weights"))
    lap("23_dist")

    # phase 22: report
    def trainer_launches(run, name, logits=None):
        """A kernel's launches over a trainer phase's training runs: all of
        them, or those at ``logits`` ("bf16" or "float32") logits, from the
        counters of the phases that record their bf16 launches."""
        total = sum(r[name] for r in run["launches"].values() if isinstance(r, dict))
        if logits is None:
            return total
        bf16 = sum(r[name] for r in run["launches_bf16"].values())
        return bf16 if logits == "bf16" else total - bf16

    # the K1 launches of the ACAL and ablation paths, by run
    k1_new_paths = {
        key: {"acal_slice_5_iterations": slice_share["launches"][key],
              "acal_trainer_20": trainer_launches(trainer_share, key),
              "ablation_slice_3_steps": slice_share["ablation_launches"][key],
              "ablation_trainer_10": trainer_launches(trainer_ablation, key)}
        for key in ("K1_fwd", "K1_bwd")}

    def k1_row(name, replaces, key, res, res_r1, launches_of, trainer_n):
        return {"name": name, "route": "triton",
                "source": "chap_tpu_torch/ops/fused_losses.py",
                "replaces": replaces, "launches": launches_of[key],
                "trainer_launches": trainer_n, "dtype": res["dtype"],
                "acal_ablation_launches": k1_new_paths[key],
                "shape": res["shape"], "regions": res["regions"],
                "max_abs_err": max(res[f"{name[3:6]}_max_abs_err"],
                                   res_r1[f"{name[3:6]}_max_abs_err"]),
                "ms": res[name[3:6]]["device_ms"],
                "kernel_ms": res[name[3:6]]["kernel_ms"],
                "host_us": res[name[3:6]]["host_us"],
                "plain_ms": res[f"{name[3:6]}_plain_ms"],
                "bound_ms": res[f"{name[3:6]}_bound"][0],
                "bound_by": res[f"{name[3:6]}_bound"][1], "library_ms": None,
                # at the supervised callers: no mask, uint8 labels (R = 1)
                "caller_bound_ms": (res[f"{name[3:6]}_caller_bound"][0]
                                    if res["regions"] == 1 else None)}

    def k2_row(name, res, launches_of, key, run):
        return {"name": name, "route": "cuda",
                "source": "chap_tpu_torch/csrc/ccl.cu",
                "replaces": "chap_tpu/semi/nms.py:118",
                "launches": launches_of[key],
                "trainer_launches": trainer_launches(run, key),
                "max_abs_err": max(r["max_abs_err"] for r in res.values()),
                "ms": res["clean"]["device_ms"],
                "kernel_ms": res["clean"]["kernel_ms"],
                "host_us": res["clean"]["host_us"],
                "plain_ms": res["clean"]["plain_ms"],
                "bound_ms": res["clean"]["bound"][0],
                "bound_by": res["clean"]["bound"][1], "library_ms": None}

    def k3_row(name, res, launches_n, max_abs_err):
        return {"name": name, "route": "cuda",
                "source": "chap_tpu_torch/csrc/sliding_window.cu",
                "replaces": "chap_tpu/eval/sliding_window.py:98",
                "launches": launches_n, "max_abs_err": max_abs_err,
                "ms": res["device_ms"], "kernel_ms": res["kernel_ms"],
                "host_us": res["host_us"], "plain_ms": res["plain_ms"],
                "bound_ms": res["bound"][0], "bound_by": res["bound"][1],
                "library_ms": None}

    la = k3["la_160x160x96"]
    kernels = [
        k1_row("K1_fwd", "chap_tpu/ops/fused_losses.py:99", "K1_fwd", k1, k1_r1,
               launches, trainer_launches(trainer, "K1_fwd")),
        k1_row("K1_bwd", "chap_tpu/ops/fused_losses.py:159", "K1_bwd", k1, k1_r1,
               launches, trainer_launches(trainer, "K1_bwd")),
        k1_row("K1_fwd_3d", "chap_tpu/ops/fused_losses.py:99", "K1_fwd", k1_3d,
               k1_3d_r1, launches_3d,
               trainer_launches(trainer_3d, "K1_fwd", "float32")),
        k1_row("K1_bwd_3d", "chap_tpu/ops/fused_losses.py:159", "K1_bwd", k1_3d,
               k1_3d_r1, launches_3d,
               trainer_launches(trainer_3d, "K1_bwd", "float32")),
        k1_row("K1_fwd_acal", "chap_tpu/ops/fused_losses.py:99", "K1_fwd",
               k1_acal, k1_acal, slice_share["launches"],
               trainer_launches(trainer_share, "K1_fwd")),
        k1_row("K1_bwd_acal", "chap_tpu/ops/fused_losses.py:159", "K1_bwd",
               k1_acal, k1_acal, slice_share["launches"],
               trainer_launches(trainer_share, "K1_bwd")),
        k2_row("K2_ccl", k2, launches, "K2_ccl", trainer),
        k2_row("K2_ccl3d", k2_3d, launches_3d, "K2_ccl3d", trainer_3d),
        k3_row("K3_sw", la, trainer_3d["launches"]["test_all_case_f32"],
               max(r["max_abs_err"] for r in k3.values())),
        k1_row("K1_fwd_brats", "chap_tpu/ops/fused_losses.py:99", "K1_fwd",
               k1_brats, k1_brats, slice_zoo["unet_3D"]["launches_main"],
               trainer_launches(trainer_zoo, "K1_fwd", "float32")),
        k1_row("K1_bwd_brats", "chap_tpu/ops/fused_losses.py:159", "K1_bwd",
               k1_brats, k1_brats, slice_zoo["unet_3D"]["launches_main"],
               trainer_launches(trainer_zoo, "K1_bwd", "float32")),
        k3_row("K3_sw_brats", k3_brats, trainer_zoo["launches"]["test_all_case_f32"],
               k3_brats["max_abs_err"]),
        # bf16 logits: the configs as written (phase 21's bare steps for
        # launches, phases 13 and 20 for the trainers and the bf16 evals)
        k1_row("K1_fwd_bf16", "chap_tpu/ops/fused_losses.py:99", "K1_fwd",
               k1_bf16["la"], k1_bf16["la_r1"],
               slice_bf16["la_chap"]["launches_bf16"],
               trainer_launches(trainer_3d, "K1_fwd", "bf16")),
        k1_row("K1_bwd_bf16", "chap_tpu/ops/fused_losses.py:159", "K1_bwd",
               k1_bf16["la"], k1_bf16["la_r1"],
               slice_bf16["la_chap"]["launches_bf16"],
               trainer_launches(trainer_3d, "K1_bwd", "bf16")),
        k1_row("K1_fwd_bf16_brats", "chap_tpu/ops/fused_losses.py:99", "K1_fwd",
               k1_bf16["brats"], k1_bf16["brats"],
               slice_bf16["brats_supervised"]["launches_bf16"],
               trainer_launches(trainer_zoo, "K1_fwd", "bf16")),
        k1_row("K1_bwd_bf16_brats", "chap_tpu/ops/fused_losses.py:159", "K1_bwd",
               k1_bf16["brats"], k1_bf16["brats"],
               slice_bf16["brats_supervised"]["launches_bf16"],
               trainer_launches(trainer_zoo, "K1_bwd", "bf16")),
        k3_row("K3_sw_bf16", k3_bf16["la_160x160x96"],
               trainer_3d["launches"]["test_all_case"],
               k3_bf16["la_160x160x96"]["max_abs_err"]),
        k3_row("K3_sw_bf16_brats", k3_bf16["brats_160x160x128"],
               trainer_zoo["launches"]["test_all_case"],
               k3_bf16["brats_160x160x128"]["max_abs_err"]),
        # the ACAL iterations' bf16 launches (3 iterations of the bf16
        # slice); no trainer runs these paths in bf16, so no trainer count
        k1_row("K1_fwd_bf16_acal", "chap_tpu/ops/fused_losses.py:99", "K1_fwd",
               k1_bf16["acal"], k1_bf16["acal"],
               share_bf16["acal"]["launches_bf16"], None),
        k1_row("K1_bwd_bf16_acal", "chap_tpu/ops/fused_losses.py:159", "K1_bwd",
               k1_bf16["acal"], k1_bf16["acal"],
               share_bf16["acal"]["launches_bf16"], None),
    ]
    for row in kernels[-2:]:
        key = row["name"][:6]
        row["acal_ablation_launches"] = {
            "acal_bf16_slice_3_iterations": share_bf16["acal"]["launches_bf16"][key],
            "ablation_bf16_slice_3_steps": share_bf16["ablation"]["launches_bf16"][key]}
    # the 2D zoo's single-decoder steps: launches over phase 24's timed
    # steps of the six single-output keys (3 each); no trainer runs them
    for name, replaces in (("K1_fwd_zoo2d", "chap_tpu/ops/fused_losses.py:99"),
                           ("K1_bwd_zoo2d", "chap_tpu/ops/fused_losses.py:159")):
        row = k1_row(name, replaces, name[:6], k1_zoo2d, k1_zoo2d,
                     zoo2d["slice"]["launches"], None)
        del row["acal_ablation_launches"]
        row["zoo2d_keys"] = list(ZOO2D_SINGLE)
        kernels.append(row)
    # phase 23's bare steps and eval at W gloo ranks: each rank's launches
    # (3 steps; a rank without rows launches K1's forward over nothing and
    # neither K1's backward nor K2)
    per_rank = {"K1_fwd": ("b_gloo_w2_steps", "d_gloo_w4_steps"),
                "K1_bwd": ("b_gloo_w2_steps", "d_gloo_w4_steps"),
                "K2_ccl": ("b_gloo_w2_steps", "d_gloo_w4_steps"),
                "K1_fwd_3d": ("e_gloo_w2_la", "e_gloo_w4_la"),
                "K1_bwd_3d": ("e_gloo_w2_la", "e_gloo_w4_la"),
                "K2_ccl3d": ("e_gloo_w2_la", "e_gloo_w4_la"),
                "K1_fwd_brats": ("f_gloo_w2_brats",),
                "K1_bwd_brats": ("f_gloo_w2_brats",),
                "K1_fwd_bf16": ("e_gloo_w2_la_bf16",),
                "K1_bwd_bf16": ("e_gloo_w2_la_bf16",),
                "K1_fwd_acal": ("i_gloo_w2_acal", "i_gloo_w4_acal",
                                "j_gloo_w2_ablation", "j_gloo_w4_ablation"),
                "K1_bwd_acal": ("i_gloo_w2_acal", "i_gloo_w4_acal",
                                "j_gloo_w2_ablation", "j_gloo_w4_ablation")}
    for row in kernels:
        for key in per_rank.get(row["name"], ()):
            name = row["name"][:6] if row["name"].startswith("K1") else row["name"]
            row[f"{key}_launches_per_rank"] = [
                r["launches"][name] for r in dist_res[key]["per_rank"]]
        if row["name"] == "K3_sw":
            row["g_gloo_w2_eval3d_launches_per_rank"] = [
                r["launches"] for r in dist_res["g_gloo_w2_eval3d"]["per_rank"]]
    # phase 25's cli.test_3d runs (--nms 1) of the converted LA snapshots
    for row in kernels:
        if row["name"] in ("K2_ccl3d", "K3_sw"):
            row["library_test3d_launches"] = library["convert"]["launches_test3d"][
                row["name"]]
    for row in kernels:
        check(row["launches"] > 0, f"{row['name']} launched on its main path")
    lap("22_report")
    phase_s["total"] = sum(phase_s.values())
    print("phase_s", json.dumps(phase_s), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
