#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``acr_wsss_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and exits
non-zero without one. Imports nothing of JAX and nothing of the JAX
package. Phases, each of which fails the run when it fails:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: ``nvcc`` builds every kernel into build/torch_kernels/, all at
   once, with the ``-Xptxas -v`` lines printed, and the blocks per SM of
   the pair kernel, of K3's tile kernel and of K4;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main paths' shapes and at ragged ones (N = 17, 37, and 1025, crop
   512, which is not a multiple of the attention kernels' 64-token tiles):
   K1f/K1n (export "mean" in float32 and bfloat16, and "none"), K2f, K2b
   (fed K2f's own sign tile), K1b (a float32 or bfloat16 dense de, or
   none), K3 and K4 chained over 10 iterations (at B=2 and B=8 views of
   384x384 with the default dilations, B=3 with 21 channels at 65x131,
   17x13 with a dilation beyond the image, all through K3's tile kernel,
   and 70x90 with dilation 40, beyond the tile's halo, through its gather
   kernel); K1f and K1b at N = 4001 (B=1) and K2f at N = 4001 (B=2),
   above the 3.4k-token limit of the earlier attention kernels; and the
   kernels twice on the same inputs, which must give the same bits: the
   attention kernels for every export mode, the pair forward and every
   source of de, K3 through either kernel, and K4;
4. inference path: GETAM CAM inference as a user runs it (vitb_hybrid,
   crop 384, ``grad`` from layer 10, affinity refinement, flip TTA, 4
   class slots) on two seeded VOC-sized images, with the weights of
   bench_artifacts/stability_r3/stability_r3_last.npz when present, else
   seeded random ones; launches counted; CAM dicts written to a temporary
   directory and scored by the port's ``evaluate``; CAMs checked against
   the same run with plain attention; then the same with ``--pamr 10``
   (K3 once and K4 10 times per image), PAMR alone checked against its
   plain version on the same CAMs, and the whole path against plain
   attention with plain PAMR;
5. training path: ``train.train`` as a user runs it (vitb_hybrid, crop
   384, batch 4, the recipe: lr 0.05, alpha 125, fused consistency) from
   seeded random weights on a seeded synthetic VOC fixture of 375x500
   JPEGs, a few steps and a validation pass; launches counted; every loss
   part finite; the final npz read by the port's ``infer_cam``;
6. resumable training at full width on the training fixture, each part
   timed: (a) SIGTERM at loop step 2 of ``train.train`` with
   ``checkpoint_every=2`` leaves a checkpoint at step 2, no final npz and
   the signal handlers as they were; the checkpoint restores parameters
   and momentum buffers bit for bit and the lr of update 3; one step from
   it agrees with one step from the state in memory within the step
   gates of phase 7; a second ``train.train`` resumes at step 3 and
   finishes (launches counted), its first step traced by the profiler
   window, whose trace must name the kernels of K2f and K2b; the seconds
   and bytes of one checkpoint save; (b) ``--device_aug``: a packed
   batch's crops made on the card against the host crops of the same seed
   (3e-4), and one train step on the packed batch against one on the host
   path fed the card's crops, within the step gates of phase 7 and with
   the same launches; (c) the relaunch
   supervisor: a hang injected after the step-1 checkpoint trips the
   watchdog in a spawned child, which exits 75, and the relaunch resumes
   and finishes; (d) ``--pretrained``: the trunk from a zoo npz of seeded
   weights, bit for bit, the head not; (e) COCO: ``train_coco.main`` for 3
   steps with ``--device_aug`` on 80-class bbox labels and images up to
   640 px, validation on the separate ``--valpath`` directory, and the CAM
   pass with ``dataset="coco"`` (launches counted);
7. one train step of the kernel path against the plain path from the same
   weights and batch, for the fused branch and the per-layer branch (which
   launches K1f and K1b): step-0 loss parts and parameters after the
   update;
8. attention entries: K5a (``attention_with_probs(impl="kernel")``), K5b
   (``fused_attention_nhd``) and K5c (``fused_attention_qkv``), forward
   and backward, against their plain versions at the training shape (B=8,
   N=577) with a float32 and a bfloat16 export; then each entry through
   autograd as a user calls it, launches counted, gradients against the
   plain backward; then the per-layer branch with ``probs_dtype=
   "bfloat16"`` (K1f exporting bf16, K1b reading a bf16 de): one step
   against the plain path, and ``train.train`` for a few steps, launches
   counted;
9. pipeline: ``pipeline.main`` as a user runs it, train -> infer with
   ``--pamr 10`` -> 100-threshold eval (vitb_hybrid, crop 384, the
   recipe) on the training fixture with seeded label PNGs; launches
   counted; the npz, one CAM dict per name and the evallog checked;
10. CRF and pseudo masks: (a) the device CRF (``ops/crf.py``, plain torch)
   at the JAX bench's shape (512x512, 21 labels, t=10) against its CPU
   run and the host's native engine, and two runs' difference; (b) ``infer_cam`` with ``--out_crf --crf_device
   --heatmap`` on phase 4's images, then with the host route: keys,
   shapes, argmax agreement of the routes, every image on the route asked
   for, K1f's launches as in phase 4; (c) ``pseudo_label.main`` on the
   CAM dicts; (d) the device CRF's, the host engine's and the --out_crf
   stage's times;
11. segmentation: (a) ``train_seg`` as a user runs it, at JAX's defaults
   (float32, plain attention; vitb_hybrid, crop 384, batch 8, 2 epochs
   over 16 names: 5 steps) on phase 10's pseudo masks and seeded masks of
   phase 5's images, then ``seg_validation`` on 4 images with seeded
   ground truth: no kernel launched, every loss part finite, the
   ``_last.npz`` read back into a fresh model with the same logits to the
   bit, mIoU in [0, 1]; (b) one step of the bf16 DPT model on the kernel
   path, whose trunk runs K1n and K1b with no de in each block under
   autograd, against the plain path from the same weights and batch,
   within phase 7's step gates and, tighter, in the attention blocks'
   tensors, launches counted; (c) the seg step's time
   and images/s and its device time per step (CUDA events), for (a)'s
   model and both bf16 paths;
12. serving and the reference import, at full width (vitb_hybrid, crop
   384, the tracked npz's weights where present, else seeded ones): (a)
   ``serving.export_infer`` (plain attention, batch 2, 4 slots), loaded
   and called on phase 4's first image and its mirror with other class
   ids in a child process whose import system refuses
   ``acr_wsss_tpu_torch``: against the live plain path (1e-5) and the live
   kernel path (the CAM gates), export seconds, bytes and call ms; the
   embedded-weights variant the same way at a small width (vit_small,
   crop 64); (b) the phase's weights as a reference-layout state dict
   (``flax_params_to_torch_state_dict``), ``torch.save``d, through the
   convert CLI with and without ``--scan``: ``infer_cam`` on each npz
   gives the original weights' CAMs to the bit;
13. parallel, on the one card: (a) DDP and FSDP2 (``train.py``,
   ``parallel/``) at world size 1 over NCCL (a ``file://`` store), one
   step each from phase 7's weights and batch against phase 7's
   one-device kernel step, within its step gates, 12 K2f and 12 K2b
   launches each, and the three step times, median of 5 after a warm-up;
   (b) two spawned ranks on the card over gloo (NCCL refuses two ranks on
   one GPU), 2 + 2 images, a DDP and an FSDP2 step against the one-device
   step that accumulates the same 2 + 2 images (the same function on the
   same shapes; the step on 4 images in one call rounds the stem's bf16
   gradients otherwise, printed beside it); (c) ``infer_cam --dp 2``'s worker processes, both on cuda:0
   through the device list, on phase 4's images with phase 4's weights,
   without and with ``--pamr 10``, against one process: the CAM gates, the
   same bits printed, K1f, K3 and K4 launches summed over the workers
   equal to one process's; (d) ``--dp`` beyond the visible GPUs fails with
   JAX's message;
14. timing: per-image latency with and without PAMR, the PAMR step's device
   time, train step time and images/s, the training loop's step time fed
   by the host path and by ``--device_aug``, device time breakdowns, each
   kernel's device time (CUDA events around launches enqueued while the
   device is held busy) beside its plain version, a library call where one
   computes the same function, and its bound;
15. Swin and PiT (``models/{registry,swin,pit}.py``, ``train_swin.py``):
   (a) ``train_swin.main --pretrained`` as a user runs it (swin_base_384,
   crop 384, batch 4, lr 0.05, alpha 125; the zoo npz seeded weights with
   nonzero biases, 1000 classes) on phase 5's fixture, 5 steps with a
   snapshot at step 3, then ``_last.npz``: every loss part finite, the
   window consistency positive and taken over all 24 blocks, no kernel
   launched (window attention is plain torch), the npz read back into a
   fresh model bit for bit; again with ``--device_aug``; (b) one float32
   step (TF32 off) twice from the same seeded weights and batch: the same
   bits in the loss parts and every parameter after the update; the bf16
   step's loss parts within phase 7's gate of the float32 step's; (c) the
   bf16 step's time (median of 6 after a warm-up), device busy time
   (profiler) and peak memory; (d) the pit_b and pit_b_distilled_224
   forwards (bf16, crop 224, batch 2, export "mean") on the kernel path:
   13 K1f launches each (N = 962/963, 257/258, 65/66), K1f against its
   plain version on every block's own attention input, the same bits from
   a second forward, logits and every block's probs against the plain
   path; a PiT at head dim 24, outside the kernel's range, raises;
16. the classifier zoo: (a) vit_base_patch16_384,
   vit_deit_base_distilled_patch16_384, vit_base_r50_s16_384,
   vit_small_patch16_224 (head dim 96) and vit_huge_patch14_224_in21k
   (head dim 80) at their published widths and depths, bf16, eval,
   trained-like seeded weights, batch 8: K1n once per block (counted),
   the same bits from two forwards, logits against the plain path, the
   forward's host-clock time on either path; (b) K1f and K1n at head dims
   32, 48, 80 and 96 against their plain versions on phase 3's cases and
   tolerances, two launches to the same bits; (c) pit_s_224, pit_xs_224
   and pit_ti_224 (head dims 48, 48, 32) on K1f as in phase 15 (d); (d)
   resnetv2_50 and resnetv2_50x1_bitm at 224 (cuDNN, no kernel): finite
   bf16 logits, the float32 forward against the CPU's, and
   ``features_only``'s maps against its ``feature_info``; (e)
   ``create_model(..., checkpoint_path=<timm .pth>)`` giving the logits of
   ``flax_to_state_dict`` on the same weights, to the bit; then K1n's and
   K1f's times at the new head dims;
17. fine-tuning on the kernels: (a) K1b with a float32, a bf16 and no de,
   and the K5a-c backwards, at head dims 16, 32, 48, 80, 96 and 128 (one
   zero-filled 64-column tile up to 64, two above) against their plain
   versions on phase 3's cases and at N = 197, H = 8, in phase 3's
   gradient tolerances, K1b twice to the same bits; (b) one bf16 SGD step
   of vit_small_resnet50d_s16_224 (head dim 96; 8 K1n and 8 K1b with no
   de) and of pit_s_224 (head dim 48; 12 K1f and 12 K1b) at batch 8, crop
   224, from trained-like weights, on the kernels against the plain path
   in phase 7's step gates, launches counted, their blocks first through
   phase 16's check, K1b on the (qkv, g) each block's backward got, equal
   to the bit to the step's gradient and held to its plain version in
   phase 3's tolerances, each path's step time; (c) the four ViT names on a
   ResNet-D stem (``models/resnet_timm.py``) on K1n against the plain
   path, timed; (d) resnet50's and ecaresnet26t's float32 train-mode step
   (flax BatchNorm, TF32 off) on the card against the same step on the
   CPU: logits and the running statistics within 1e-3, the parameter
   updates within twice the spread the CPU's own other summation orders
   (one thread; oneDNN off) make in the same run; (e) bf16
   forwards of resnet50, resnet50d, seresnext26d_32x4d, densenet121 and
   vgg16_bn (host clock); then K1b's and the K5 backwards' times at the
   fine-tune shapes beside SDPA's forward and backward;
18. the zoo and the WSSS surface, no kernel: (a) ``train_swin``'s step on
   the data mesh (``make_data_mesh_for_batch``, DDP) at swin_base_384's
   widths and depth, crop 384, from phase 15's seeded zoo npz
   (``--pretrained``), float32 with TF32 off: two gloo ranks on the card,
   2 + 2 images, against the one-device step on the 4, the update within
   twice the yardstick of the one-device step's own other summation
   orders (2 + 2 accumulated, the batch permuted) measured in the same
   run, and a world-size-1 NCCL step giving the one-device step's bits;
   then ``train_swin.main --pretrained`` on the two ranks under the
   launcher's variables: 2 steps, one history on both, ``swin_last.npz``
   written by rank 0 alone, no launch; (b) float32 eval forwards at each name's default input size, batch 8,
   of efficientnet_b0/b3, mobilenetv3_large_100, regnety_032, seresnet50,
   resnest50d, res2net50_26w_4s, skresnet50 and legacy_senet154 against
   the CPU within 1e-3 of the largest |logit|, and each one's bf16
   forward time; (c) phase 17 (d)'s train-mode step for efficientnet_b0
   and seresnet50; (d) ``ASPP`` (2048 -> 256 on 32x32), ``AttentionConv``
   (64 channels, kernel 7, 8 groups, 64x64) and ``grad_cam`` on (b)'s
   seresnet50 features, card against CPU within 1e-4 of the largest
   value. (b)'s float32 checks, (c) and (d) run while (a)'s ranks work;
   (b)'s bf16 forwards are timed after, alone.
19. the mesh's model axis, tensor parallelism (``train --mesh
   data=D,model=M``): (a) two gloo ranks on the card, mesh
   data=1,model=2, vitb_hybrid at full width and depth, crop 384, phase
   7's weights and batch: the float32 step (TF32 off) against the
   one-device float32 per-layer step, gated at twice the yardstick of the
   one-device step's other summation orders in the same run, on the whole
   update and its worst tensor; the bf16 kernel step (per-layer branch,
   bf16 export, 6 heads per rank) against the one-device bf16 per-layer
   kernel step in phase 7's gates on the tensors phase 13 (b) gates; 12
   K1f and 12 K1b per rank and no other launch; K1f and K1b at H = 6
   against their plain versions on rank 0's own block inputs (a row
   stride of 1152), each equal to the bit to what the step got; (b) four
   ranks, data=2,model=2, vitb at 4 of its 12 blocks, float32, against
   the one-device step on the same 4 images, (a)'s gate; (c) each rank's
   bf16 step time, host clock and CUDA events.

The second-to-last lines are the card's name and power limit and a JSON
object with one entry per kernel; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

sys.dont_write_bytecode = True
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from PIL import Image  # noqa: E402

from acr_wsss_tpu_torch import evaluate  # noqa: E402
from acr_wsss_tpu_torch import infer_cam  # noqa: E402
from acr_wsss_tpu_torch import pipeline  # noqa: E402
from acr_wsss_tpu_torch import pseudo_label  # noqa: E402
from acr_wsss_tpu_torch import serving  # noqa: E402
from acr_wsss_tpu_torch import train as train_mod  # noqa: E402
from acr_wsss_tpu_torch import train_coco  # noqa: E402
from acr_wsss_tpu_torch import train_seg  # noqa: E402
from acr_wsss_tpu_torch import train_swin  # noqa: E402
from acr_wsss_tpu_torch.configs import InferConfig, ModelConfig, TrainConfig  # noqa: E402
from acr_wsss_tpu_torch.data import coco as coco_data  # noqa: E402
from acr_wsss_tpu_torch.data import device_aug  # noqa: E402
from acr_wsss_tpu_torch.data import voc as voc_data  # noqa: E402
from acr_wsss_tpu_torch.infer_cam import build_infer_fn, process_image  # noqa: E402
from acr_wsss_tpu_torch.models.acr import ACR, init_random_  # noqa: E402
from acr_wsss_tpu_torch.models import acr as acr_mod  # noqa: E402
from acr_wsss_tpu_torch.models import vit as vit_mod  # noqa: E402
from acr_wsss_tpu_torch.getam import grad_cam  # noqa: E402
from acr_wsss_tpu_torch.models import convert, extras, registry, zoo  # noqa: E402
from acr_wsss_tpu_torch.models.layers import classifier_head  # noqa: E402
from acr_wsss_tpu_torch.models.convert import flax_to_state_dict, state_dict_to_flax  # noqa: E402
from acr_wsss_tpu_torch.models.dpt import DPTSegmentationModel  # noqa: E402
from acr_wsss_tpu_torch.ops import _build, attn_pair  # noqa: E402
from acr_wsss_tpu_torch.ops import crf as crf_ops  # noqa: E402
from acr_wsss_tpu_torch.ops import imops  # noqa: E402
from acr_wsss_tpu_torch.ops import pamr as pamr_ops  # noqa: E402
from acr_wsss_tpu_torch.ops.attention import attention_with_probs  # noqa: E402
from acr_wsss_tpu_torch.ops.attn_cuda import (BWD_KERNEL, KERNEL,  # noqa: E402
                                              attention_qkv_cols_backward,
                                              attention_qkv_cols_backward_plain,
                                              attention_qkv_cols_forward,
                                              attention_qkv_cols_plain,
                                              backward_plain, fused_attention_nhd,
                                              fused_attention_qkv,
                                              fused_attention_qkv_cols,
                                              fused_attention_with_probs)
from acr_wsss_tpu_torch.ops.attn_cuda import backward as attn_backward  # noqa: E402
from acr_wsss_tpu_torch.ops.attn_cuda import forward as attn_forward  # noqa: E402
from acr_wsss_tpu_torch.ops.attn_cuda import forward_plain  # noqa: E402
from acr_wsss_tpu_torch.ops.attn_pair import (pair_consistency_backward,  # noqa: E402
                                              pair_consistency_backward_plain,
                                              pair_consistency_forward,
                                              pair_consistency_forward_plain)
from acr_wsss_tpu_torch.ops.pamr import (affinity_route, make_pamr_fn,  # noqa: E402
                                         pamr_affinity, pamr_affinity_plain, pamr_plain,
                                         pamr_update, pamr_update_plain)
from acr_wsss_tpu_torch.utils.checkpoint import (CheckpointManager,  # noqa: E402
                                                 load_params_npz, save_params_npz)
from acr_wsss_tpu_torch.utils.schedule import make_optimizer, poly_factor  # noqa: E402
from acr_wsss_tpu_torch.utils.supervisor import run_train_supervised  # noqa: E402
from acr_wsss_tpu_torch.parallel import distributed  # noqa: E402
from acr_wsss_tpu_torch.parallel.mesh import make_data_mesh_for_batch, make_mesh  # noqa: E402
from acr_wsss_tpu_torch.parallel.sharding import (full_like, full_tensors,  # noqa: E402
                                                  shard_like, unwrap)
from torch.nn.parallel import DistributedDataParallel  # noqa: E402

WEIGHTS = os.path.join(ROOT, "bench_artifacts", "stability_r3", "stability_r3_last.npz")
CROP, START_LAYER, CLASS_SLOTS, HEADS, HEAD_DIM, DEPTH = 384, 10, 4, 12, 64, 12
N_TOKENS = (CROP // 16) ** 2 + 1
IMAGE_SIZES = ((375, 500), (333, 500))
# Published dense peaks of one H100 SXM (NVIDIA data sheet, 700 W): bf16
# on the tensor cores, fp32 on the CUDA cores, device memory.
PEAK_BF16_FLOPS, PEAK_FP32_FLOPS, PEAK_BYTES = 989e12, 67e12, 3.35e12
# Kernel against its plain version, both bf16 in / bf16 out on the card.
# probs: float32 on both sides, logits summed in another order -> ~1e-7
# relative on p <= 1. out: p is rounded to bf16 before p @ v on both sides,
# so a last-bit difference in p can flip one term's rounding (2^-8 * p *
# |v|, absolute) and the final bf16 rounding adds one ulp (2^-8 relative).
PROBS_ATOL = 1e-6
OUT_RTOL, OUT_ATOL = 2.0 ** -7, 2.0 ** -8
# bf16 export: kernel and plain version each round a float32 head mean once,
# and the means agree within PROBS_ATOL, so the two bf16 values are at most
# one bf16 ulp apart: 2^-7 of the value at most (values just above a power
# of two), plus PROBS_ATOL where a mean is near 0.
BF16_PROBS_RTOL = 2.0 ** -7
# CAMs (min-max normalized to [0, 1]) of the kernel path against the plain
# path, both bf16 through 12 blocks: the rounding differences above, carried
# through blocks 0-9 and the GETAM backward of blocks 10-11.
CAM_MAX_ABS, CAM_MEAN_ABS = 0.05, 0.005
# K2f sums of |delta|: float32 over up to N^2 terms in another order ->
# rtol 1e-5. Sign tile: equal wherever the plain |delta| exceeds SIGN_EPS,
# above the float32 error of two 12-term head means of probabilities <= 1
# (24 roundings of at most 2^-24 each). K2b and K1b dqkv: float32
# arithmetic in another order, then one bf16 rounding on each side -> one
# bf16 ulp (2^-7 relative), plus 1e-4 of the tensor's largest value for
# entries that cancel to near zero (sums of up to N terms).
SUM_RTOL, SIGN_EPS = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL_FRAC = 2.0 ** -7, 1e-4
# Training path: the recipe at batch 4, 16 training and 4 validation
# images, one epoch: 4 updates, so 5 train steps (range(0, max_step + 1)).
TRAIN_BATCH, TRAIN_IMAGES, VAL_IMAGES = 4, 16, 4
TRAIN_SIZES = ((375, 500), (500, 375), (333, 500), (375, 500))
# One train step, kernel path against plain path, both bf16 through the
# stem and 12 blocks: bf16 rounding (2^-8 relative) of each block's output
# carried to the logits and the probabilities -> step-0 loss parts within
# 2e-2 relative. After the update, each parameter tensor's update p1 - p0
# within 5e-2 of the plain path's in L2 norm (the relative tolerance of
# the hybrid's one-step test against the reference, tests/
# test_train_parity.py): the two backward formulations round to bf16 at
# other places (the kernels' backward is float32 on a recomputed p), and
# weight standardization in the stem amplifies gradients about 12x, so
# an element-wise bound on parameters would be set by the largest
# updates, not by the error.
LOSS_RTOL, UPDATE_REL = 2e-2, 5e-2
# PAMR as ``--pamr 10`` runs it: 10 iterations over the default dilations
# (P = 48 neighbours), 20 class rows, guidance 3 x 384 x 384 per view.
# K3 and K4 against their plain versions, float32 on both sides: the taps
# and the neighbours are summed in the same order, so only the softmax's
# sum and the scalar divisions may round otherwise -> the JAX package's
# own tolerance between its Pallas kernels and its XLA formulation
# (tests/test_pamr.py), also after 10 chained K4 steps (each step is a
# convex combination, which does not grow an error).
PAMR_ITERS, PAMR_DILATIONS, NUM_CLASSES = 10, (1, 2, 4, 8, 12, 24), 20
PAMR_RTOL, PAMR_ATOL = 2e-5, 2e-6
# Pipeline phase: 8 of the training fixture's images (2 updates, 3 train
# steps) and its 4 validation images as the inference and eval list.
PIPE_TRAIN_IMAGES = 8
# CRF phase (a): the JAX bench's on-device CRF shape (bench.py:290-345),
# 512x512 RGB, 21 labels, t=10, the crf_inference recipe (Gaussian 3/3,
# bilateral 80/13/10), on the inputs of tests/test_bilateral_crf.py's
# production-scale case (seed 0). The card against the same function on the
# CPU: float32 in another order and atomic scatter sums, carried through ten
# mean-field steps (5e-5 at 64x96 in tests/test_torch_crf.py; the marginals
# here are sharper) -> 1e-3 on the marginals, argmax agreement >= 0.999.
# Against the host's native engine, another filter (a permutohedral
# lattice): JAX's own bound at this shape (test_bilateral_crf.py:265).
CRF_PAD, CRF_LABELS, CRF_ITERS = 512, 21, 10
CRF_CPU_ATOL, CRF_CPU_AGREE, CRF_NATIVE_AGREE = 1e-3, 0.999, 0.97
# (b) --out_crf through the device route: against the same route on the
# CPU, argmax agreement as in (a); the scatter's atomic sums change order
# from run to run, and on phase 4's CAMs, near-uniform over wide regions,
# ten mean-field steps carry that to 4.6e-4 and 7.3e-4 in two calls on an
# H100 (333x500, alpha 1) -> 5e-3 on the marginals. The device route
# against the host route measures two approximations, not the port: the
# device route fills the 512 bucket with edge-replicated rows (179 of them
# for a 333-row image) and filters on a bilateral grid, the host route runs
# the permutohedral lattice at the native size. On phase 4's CAMs of the
# tracked npz JAX's own two routes agree on only 0.877 of the 375x500
# image, CAMs and both routes on the CPU, as the port's do to the pixel
# (tests/test_torch_crf_infer.py). So that agreement is printed beside
# the same route's on the CPU, from which the gate above keeps it within
# 1 - CRF_CPU_AGREE, and JAX's bound for this wiring
# (test_bilateral_crf.py:171-190) is held on JAX's own input: a 24x20
# two-region image, classes 4 and 11 split at column 10, alpha 4, pad 32.
CRF_ROUTE_CPU_ATOL, CRF_ROUTE_AGREE, CRF_TOY_PAD = 5e-3, 0.9, 32
# Resume phase (a): checkpoints every 2 steps, SIGTERM in loop step 2 of
# the 5-step run; 3 steps run, then 2 after the resume, the first of them
# inside the profiler window (train.PROFILE_WINDOW, moved there), whose
# trace must name the kernels of K2f and K2b.
RESUME_EVERY, PREEMPT_STEP = 2, 2
TRACED_KERNELS = ("attn_fwd_out_kernel", "attn_pair_kernel", "attn_pair_sums_kernel",
                  "attn_bwd_rows_kernel", "attn_bwd_keys_kernel")
# (b) The card's crops against the host's of the same seed: the constant of
# tests/test_device_aug.py (the host resizes, then crops; the gather
# composes both in float32, ~1e-4 apart where the orders differ).
AUG_ATOL = 3e-4
# (c) 8 training images (3 steps), a checkpoint every step, the hang at
# the watchdog's beat 2, after step 1's checkpoint. The timeout must be
# above the first step's warm-up in a fresh process on the card (CUDA
# libraries and kernels loaded, cuDNN picking algorithms: 2.4-2.6 s on an
# H100, measured below), which the clock exempts only because it starts at
# the first beat, and far above a live step with its checkpoint's copy to
# the host (0.1 s); 6 s keeps the injected hang's cost to about 7.5 s.
SUPERVISED_IMAGES, HANG_BEAT, STEP_TIMEOUT_S = 8, 2, 6.0
# (e) COCO: 8 training images (3 steps), 4 validation images (one batch),
# the CAM pass on 2; images up to 640 px, COCO's largest side.
COCO_SIZES = ((480, 640), (640, 427), (427, 640), (640, 480))
COCO_TRAIN, COCO_VAL, COCO_CAM = 8, 4, 2
# Segmentation phase (a): train_seg at its defaults but for the corpus and
# the lr: vitb_hybrid, crop 384, batch 8, 2 epochs over 16 names (4
# updates, 5 steps), validation on 4 images with ground truth. lr 1e-4
# (tests/test_train_seg.py's step test): from the seeded init, the CLI's
# 0.01, the recipe for an ImageNet-initialized trunk that train_seg cannot
# load, takes the loss 9.9, 95.6, 4.3e5, NaN, and 1e-3 still 9.9 to 122 in
# 5 steps; at 1e-4 it falls (CPU, crop 64; JAX's steps behave alike,
# tests/test_torch_train_seg.py).
SEG_BATCH, SEG_TRAIN, SEG_EPOCHS, SEG_VAL, SEG_LR = 8, 16, 2, 4, 1e-4
# Phase 11 (b) holds the attention blocks' tensors (qkv and proj, weights
# and biases), the ones the kernels' gradients reach first, to a tighter
# update bound than UPDATE_REL: the qkv weights read at most 0.0046 there
# (H100, 700 W), while the whole-model gate is set by the stem's GroupNorm
# scales (0.047), which bf16 rounding through weight standardization moves
# on either attention path.
SEG_ATTN_UPDATE_REL = 1.5e-2
# The timing phase's training loop, per arm (host path, --device_aug, twice each):
# steps timed, and the first ones left out (the loader's first batches,
# which nothing overlaps).
LOOP_STEPS, LOOP_WARMUP = 20, 3
# Phase 12, serving. The artifact against the live plain path: the same
# ATen operations on the same card -> 1e-5 absolute; against the live
# kernel path, the CAM gates on min-max normalized CAMs. Class ids of the
# call, other than the traced 0-3. The embedded-weights variant at a small
# width (vit_small, crop 64), where it exports in seconds.
SERVE_ATOL, SERVE_IDS, SERVE_SMALL_CROP = 1e-5, (14, 2, 7, 19), 64
SERVE_CHILD = """
import importlib.abc, json, sys, time

REFUSED = ("acr_wsss_tpu_torch", "acr_wsss_tpu", "jax", "jaxlib", "flax")


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == r or name.startswith(r + ".") for r in REFUSED):
            raise ImportError(f"refused import of {name}")
        return None


sys.meta_path.insert(0, Refuse())
import torch

sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
tmp = sys.argv[1]
inputs = torch.load(f"{tmp}/inputs.pt", weights_only=True)
params = torch.load(f"{tmp}/params.pt", weights_only=True)
outs, ms = {}, {}
for name, args in (("cam", (params, inputs["x"], inputs["ids"])),
                   ("cam_embedded", (inputs["x_small"], inputs["ids"]))):
    program = torch.export.load(f"{tmp}/{name}.pt2").module()
    outs[name] = {k: v.cpu() for k, v in program(*args).items()}
    times = []
    for _ in range(5):
        sync()
        t0 = time.perf_counter()
        program(*args)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    ms[name] = sorted(times)[2]
torch.save(outs, f"{tmp}/child_out.pt")
try:
    import acr_wsss_tpu_torch  # noqa: F401
    raise SystemExit("acr_wsss_tpu_torch was importable in the child")
except ImportError:
    pass
print(json.dumps({"ms": ms, "device": str(inputs["x"].device)}))
"""
# Phase 13, data parallelism on the one card: step timing rounds (one
# step of each arm per round, after the compared step as a warm-up), the
# ranks of part (b) and the --dp workers of part (c). NCCL refuses two
# ranks on one GPU, so (b) runs over gloo, which carries every collective
# that DDP and FSDP2 issue there (all-reduce, all-gather into a tensor,
# reduce-scatter of a tensor; checked on an H100 before the phase was
# written).
DP_TIMING_ROUNDS, DP_RANKS = 8, 2
# Part (b)'s steps on the ranks: name -> (FSDP, float32 on the plain path).
# The recipe's bf16 kernel step (K2f, K2b) of the hybrid puts its stem's
# updates up to 1.42 (relative L2) from the float32 step's on the same
# images, and a change of the batch's shape alone (4 images, or the same
# 4 twice: the same update) moves them by 0.294; in float32 with TF32 off,
# 2 + 2 images read at most 3.1e-05 against 4 on every tensor
# (docs/dp_split_probe.py, H100, 700 W). So the ranks' global-batch
# update is held in float32 on every tensor (DDP's; FSDP2's bf16 step is
# held to DDP's through the accumulated step, to 7e-06), and their bf16
# steps against the bf16 step on 4 images on every tensor that bf16
# rounding leaves within the gate (dp_check_global).
DP_CASES = {"ddp": (False, False), "fsdp": (True, False), "ddp_fp32": (False, True)}
# Phase 15, Swin and PiT. (a) ``train_swin.main`` as a user runs it at
# swin_base_384's published widths and depth (crop 384, the recipe's batch
# 4, lr 0.05, alpha 125) on phase 5's 16 images, one epoch: 4 updates, 5
# steps, a snapshot at step 3; with ``--pretrained`` (the reference trains
# Swin from ImageNet weights) from a zoo npz of seeded weights whose
# biases and norm scales are nonzero, as a trained checkpoint's are
# (``trained_like``). From the seeded init itself (biases 0) the recipe
# diverges in both packages alike: the pad-crop's zero patches reach the
# embedding's LayerNorm with zero variance, the first update moves the
# patch embedding's bias by 7.8e13, and the loss is NaN by step 3
# (docs/swin_seeded_init_probe.py: JAX and the port step for step, depths
# (2, 2, 2, 2), CPU; the full depth on an H100 the same). (b) uses
# trained-like weights too. (c) the bf16 step, median of SWIN_TIMED
# steps after a warm-up. (d) pit_b and pit_b_distilled_224 at crop 224,
# batch 2: every block's attention input kept, K1f against its plain
# version on it (phase 3's tolerances); the whole forward on the kernel
# path against the plain path, both bf16 through 13 blocks: K1f's out is
# within one bf16 ulp of the plain version's, and a last-bit difference in
# a block's output is carried through the later blocks. Giving one
# attention output in 1,000 a one-ulp change in every block of the plain
# bf16 pit_b (seeded init, crop 224, CPU) moves its logits by 0.0202 of a
# largest |logit| of 3.53 and the probabilities by at most 6.1e-4; the
# gates are 5e-2 of the largest |logit| and 3e-3.
SWIN_MODEL, SWIN_SAVE_EVERY, SWIN_TIMED = "swin_base_384", 3, 6
PIT_CROP, PIT_BATCH = 224, 2
PIT_LOGITS_REL, PIT_PROBS_ATOL = 5e-2, 3e-3
# Classifier phase: (a) the ViT and DeiT classifiers at their published
# widths and depths (name, crop, depth: None for the registry's), bf16,
# eval, trained-like seeded weights, batch 8, on K1n: every block's input
# kept and K1n held to its plain version on it with phase 3's tolerances;
# the whole forward against the plain path with PiT's gate (5e-2 of the
# largest |logit|) for the same reason, bf16 rounding carried through
# every block. (b) K1f and K1n
# at the head dims of the PiT names (48, 32) and of the classifiers (80,
# 96) on phase 3's cases and tolerances: the head dim changes how many
# products each sum holds, not their rounding. (d) the float32 ResNetV2
# forward on the card (TF32 off) against the CPU's: cuDNN's and the CPU's
# sums in other orders, 1e-3 of the largest |logit|.
CLS_BATCH, CNN_REL = 8, 1e-3
CLS_CASES = (("vit_base_patch16_384", 384, None),
             ("vit_deit_base_distilled_patch16_384", 384, None),
             ("vit_base_r50_s16_384", 384, None),
             ("vit_small_patch16_224", 224, None),
             ("vit_huge_patch14_224_in21k", 224, None))
CLS_HEAD_DIMS = (32, 48, 80, 96)
# Fine-tuning phase: (a) the backward kernels (K1b with a float32, a bf16
# or no de; the K5 backwards) at these head dims against their plain
# versions, on phase 3's cases and N = 197, H = 8, in phase 3's gradient
# tolerances (the head dim changes how many products a sum holds, not its
# roundings); (b) one bf16 SGD step of each FT_CASES name (name, forward
# kernel, blocks) from trained-like weights, kernel path against plain
# path, in phase 7's step gates (LOSS_RTOL, UPDATE_REL); (d) one float32
# train-mode step (TF32 off) of each CNN_STEP_NAMES name on the card
# against the same step on the CPU: cuDNN's and the CPU's sums in other
# orders, CNN_REL of the largest |logit| and of each running statistic's
# update (relative L2). The parameter updates are held to the spread that
# other summation orders make on the CPU itself, measured in the same run
# (one thread; oneDNN off, PyTorch's own convolutions): train-mode
# BatchNorm's backward subtracts batch means that cancel, so those alone
# move resnet50's whole update by 5.6e-3 and 2.3e-2, far above CNN_REL.
# cuDNN is a third family of orders; CNN_SPREAD allows it twice the CPU's
# larger reading (distances of independent orders add in quadrature, so
# sqrt(2), rounded up), and never more than phase 7's UPDATE_REL.
BWD_HEAD_DIMS = (16, 32, 48, 80, 96, 128)
FT_BATCH, FT_CROP, FT_LR = 8, 224, 1e-2
FT_CASES = (("vit_small_resnet50d_s16_224", "K1n", 8), ("pit_s_224", "K1f", 12))
HYBRIDS = ("vit_small_resnet26d_224", "vit_small_resnet50d_s16_224", "vit_base_resnet26d_224",
           "vit_base_resnet50d_224")
CNN_STEP_NAMES, CNN_STEP_BATCH, CNN_STEP_CROP = ("resnet50", "ecaresnet26t"), 2, 128
CNN_SPREAD = 2.0
CNN_TIMED = ("resnet50", "resnet50d", "seresnext26d_32x4d", "densenet121", "vgg16_bn")
# Phase 18, the zoo and the WSSS surface. (a) ``train_swin`` on the data
# mesh at swin_base_384's published widths and depth (phase 15's
# configuration and seeded zoo npz, --pretrained), float32 with TF32 off:
# at world size 1 (NCCL) the one-device step's bits; two gloo ranks on the
# card, 2 + 2 images, against the one-device 4-image step: the loss parts
# in LOSS_RTOL, the update in ORDER_SPREAD x the yardstick of the
# one-device step's own other orders. The ranks' worst tensor, a
# relative-position bias table at 4.15e-4, is the one-device 2 + 2
# accumulated step's own reading: the table's update is 3.5e4 times
# smaller than its values, so one float32 ulp of the stored parameter is
# 3.1e-3 of the update's norm, and float32 puts that update 9.8e-4 from
# float64's, where 2 + 2 and 4 agree to 5.8e-14 (docs/dp_split_probe.py
# --swin, H100, 700 W). (b) float32 eval forwards (TF32
# off) of ZOO_FORWARDS at each name's default input size, batch CLS_BATCH,
# card against CPU within CNN_REL of the largest |logit| (phase 16 (d)'s
# reason); their bf16 forward times. (c) phase 17 (d)'s train-mode step
# for ZOO_STEP_NAMES. CNN_ZERO_GRAD: per name, the tensors whose gradient
# is 0 in exact arithmetic (EfficientNet's project BatchNorm feeds the next
# 1x1 conv and its train-mode BatchNorm, which takes the mean out). (d) the
# WSSS surface, card against CPU on the same inputs within SURFACE_REL of
# the largest |value|: one layer of float32 sums in another order, no
# chain of them (CNN_REL's 1e-3 covers a whole network).
ZOO_FORWARDS = ("efficientnet_b0", "efficientnet_b3", "mobilenetv3_large_100", "regnety_032",
                "seresnet50", "resnest50d", "res2net50_26w_4s", "skresnet50", "legacy_senet154")
ZOO_STEP_NAMES = ("efficientnet_b0", "seresnet50")
CNN_ZERO_GRAD = {"efficientnet_b0": r"\.project\.bn\.bias$"}
SURFACE_REL, SWIN_DP_RANKS = 1e-4, 2
ASPP_CASE = (2, 2048, 32, 32)          # DeepLab's widths: 2048 in, 256 out
ATTN_CONV_CASE = (2, 64, 64, 64)       # 64 channels, kernel 7, 8 groups
# Phase 19, the mesh's model axis (tensor parallelism) on the one card,
# over gloo as phase 13 (b). A float32 step on a data or model mesh sums
# the same terms as the one-device step in other orders: the batch's
# terms in two halves (data), the projections' and the MLP's partial
# products and the head mean in two halves (model). The yardstick is the
# one-device step's own spread under other orders of its sums, measured in
# the same run: the batch as 2 + 2 accumulated micro-steps and the batch
# permuted. ORDER_SPREAD allows a mesh's float32 step twice the larger
# reading, on the whole update and on its worst tensor (independent
# orders add in quadrature: sqrt(2), rounded up, as CNN_SPREAD), never
# more than phase 7's UPDATE_REL. (The same step on the CPU is no
# yardstick: oneDNN's and cuDNN's convolutions put vitb_hybrid's stem
# updates 0.087 apart.) (b) runs vitb at TP_DEPTH of its 12 blocks: four
# ranks of the whole model on one card would hold the phase's length past
# its share of the run.
TP_RANKS, TP_AXES, TP_DEPTH, TP_DEPTH_BACKBONE, TP_TIMED = 2, ("data", "model"), 4, "vitb_tp4", 5
ORDER_SPREAD = 2.0
KERNELS = (KERNEL, attn_pair.KERNEL, BWD_KERNEL, pamr_ops.KERNEL)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def check_close(name, got, ref, rtol, atol) -> float:
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    max_err = err.max().item()
    log(f"  {name}: max abs err {max_err:.3g} (tolerance {atol:.3g} + {rtol:.3g}*|ref|)")
    if not torch.isfinite(got).all() or bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} elements out of tolerance, "
                             f"max abs err {max_err:.3g}")
    return max_err


def check_k1(device, errs) -> None:
    gen = torch.Generator(device=device).manual_seed(0)
    for B, N in ((2, N_TOKENS), (4, N_TOKENS), (SEG_BATCH, N_TOKENS), (3, 37), (3, 17),
                 (2, 1025)):
        qkv = torch.randn((B, N, 3 * HEADS * HEAD_DIM), generator=gen, device=device,
                          dtype=torch.float32).to(torch.bfloat16)
        for export in ("mean", "none"):
            out, probs = fused_attention_qkv_cols(qkv, HEAD_DIM ** -0.5, HEADS, export)
            ref_out, ref_probs = attention_qkv_cols_plain(qkv, HEAD_DIM ** -0.5, HEADS, export)
            torch.cuda.synchronize()
            log(f"  K1 forward B={B} N={N} export={export}")
            err = check_close("out", out, ref_out, OUT_RTOL, OUT_ATOL)
            if export == "mean":
                err = max(err, check_close("probs", probs, ref_probs, 0.0, PROBS_ATOL))
            elif probs is not None:
                raise AssertionError("export='none' returned probs")
            errs[("K1", B, N, export)] = err
        out, probs = fused_attention_qkv_cols(qkv, HEAD_DIM ** -0.5, HEADS, "mean",
                                              torch.bfloat16)
        ref_out, ref_probs = attention_qkv_cols_plain(qkv, HEAD_DIM ** -0.5, HEADS, "mean",
                                                      torch.bfloat16)
        torch.cuda.synchronize()
        log(f"  K1 forward B={B} N={N} export=mean, probs bfloat16")
        if probs.dtype != torch.bfloat16:
            raise AssertionError(f"bf16 export came back as {probs.dtype}")
        errs[("K1", B, N, "mean_bf16")] = max(
            check_close("out", out, ref_out, OUT_RTOL, OUT_ATOL),
            check_close("probs", probs, ref_probs, BF16_PROBS_RTOL, PROBS_ATOL))


def check_grad(name, got, ref) -> float:
    atol = GRAD_ATOL_FRAC * ref.float().abs().max().item()
    return check_close(name, got, ref, GRAD_RTOL, atol)


def check_k2f(qkv):
    """K2f against its plain version on ``qkv``: (max abs err, the
    kernel's sign tile)."""
    B, N, _ = qkv.shape
    scale = HEAD_DIM ** -0.5
    log(f"  K2f B={B} N={N}")
    out, cls_s, aff_s, sign = pair_consistency_forward(qkv, scale, HEADS)
    ref_out, ref_cls, ref_aff, ref_sign = pair_consistency_forward_plain(qkv, scale, HEADS)
    _, probs = attention_qkv_cols_plain(qkv, scale, HEADS, "mean")
    torch.cuda.synchronize()
    err = check_close("out", out, ref_out, OUT_RTOL, OUT_ATOL)
    err = max(err, check_close("cls_sums", cls_s, ref_cls, SUM_RTOL, 0.0))
    err = max(err, check_close("aff_sums", aff_s, ref_aff, SUM_RTOL, 0.0))
    clear = (probs[0::2] - probs[1::2]).abs() > SIGN_EPS
    flips = int((sign != ref_sign).sum())
    bad = int((sign != ref_sign)[clear].sum())
    log(f"  sign tile: {flips} of {sign.numel()} entries differ from the plain "
        f"version, {bad} of them where |delta| > {SIGN_EPS}")
    if bad or sign.dtype != torch.int8:
        raise AssertionError("K2f sign tile disagrees with the plain version")
    return err, sign


def check_k2_k1b(device, errs) -> None:
    gen = torch.Generator(device=device).manual_seed(1)
    scale = HEAD_DIM ** -0.5
    for B, N in ((2 * TRAIN_BATCH, N_TOKENS), (2, 37), (2, 17), (2, 1025)):
        qkv = torch.randn((B, N, 3 * HEADS * HEAD_DIM), generator=gen,
                          device=device).to(torch.bfloat16)
        g = torch.randn((B, N, HEADS * HEAD_DIM), generator=gen,
                        device=device).to(torch.bfloat16)
        errs[("K2f", B, N)], sign = check_k2f(qkv)

        log(f"  K2b B={B} N={N} (plain version fed the kernel's sign tile)")
        g_cls = torch.rand(B // 2, generator=gen, device=device) * 100
        g_aff = torch.rand(B // 2, generator=gen, device=device) * 100
        got = pair_consistency_backward(qkv, g, sign, g_cls, g_aff, scale, HEADS)
        ref = pair_consistency_backward_plain(qkv, g, sign, g_cls, g_aff, scale, HEADS)
        torch.cuda.synchronize()
        errs[("K2b", B, N)] = check_grad("dqkv", got, ref)

        for with_de in (True, False, "bf16"):
            de = torch.randn((B, N, N), generator=gen, device=device) if with_de else None
            if with_de == "bf16":
                de = de.to(torch.bfloat16)
            log(f"  K1b B={B} N={N} de={'none' if de is None else de.dtype}")
            got = attention_qkv_cols_backward(qkv, g, de, scale, HEADS)
            ref = attention_qkv_cols_backward_plain(qkv, g, de, scale, HEADS)
            torch.cuda.synchronize()
            errs[("K1b", B, N, with_de)] = check_grad("dqkv", got, ref)


def check_many_tokens(device, errs, n=4001) -> None:
    """K1f and K1b at B=1, and K2f at B=2 (one pair), with more tokens than
    the earlier kernels' shared-memory limit (about 3.4k): the tensor-core
    kernels have none."""
    gen = torch.Generator(device=device).manual_seed(6)
    scale = HEAD_DIM ** -0.5
    qkv = torch.randn((1, n, 3 * HEADS * HEAD_DIM), generator=gen,
                      device=device).to(torch.bfloat16)
    log(f"  K1 forward B=1 N={n}, export mean")
    out, probs = attention_qkv_cols_forward(qkv, scale, HEADS, "mean")
    ref_out, ref_probs = attention_qkv_cols_plain(qkv, scale, HEADS, "mean")
    torch.cuda.synchronize()
    errs[("K1", 1, n, "mean")] = max(check_close("out", out, ref_out, OUT_RTOL, OUT_ATOL),
                                     check_close("probs", probs, ref_probs, 0.0, PROBS_ATOL))
    del out, probs, ref_out, ref_probs
    g = torch.randn((1, n, HEADS * HEAD_DIM), generator=gen, device=device).to(torch.bfloat16)
    de = torch.randn((1, n, n), generator=gen, device=device)
    log(f"  K1b B=1 N={n} de float32")
    got = attention_qkv_cols_backward(qkv, g, de, scale, HEADS)
    ref = attention_qkv_cols_backward_plain(qkv, g, de, scale, HEADS)
    torch.cuda.synchronize()
    errs[("K1b", 1, n, True)] = check_grad("dqkv", got, ref)
    del qkv, g, de, got, ref
    qkv = torch.randn((2, n, 3 * HEADS * HEAD_DIM), generator=gen,
                      device=device).to(torch.bfloat16)
    errs[("K2f", 2, n)] = check_k2f(qkv)[0]


def check_same_bits(device) -> None:
    """The forward kernel (export fp32, bf16, none), the pair forward, and
    the backward kernel (de none, fp32, bf16 and the sign tile) twice on
    the same inputs at the training shape, and K3 (through either of its
    kernels) and PAMR_ITERS chained K4 launches at B=2 views of 384x384:
    the outputs must be equal to the bit (no atomics, sums in a fixed
    order)."""
    gen = torch.Generator(device=device).manual_seed(7)
    B, N, scale = 2 * TRAIN_BATCH, N_TOKENS, HEAD_DIM ** -0.5
    qkv = torch.randn((B, N, 3 * HEADS * HEAD_DIM), generator=gen,
                      device=device).to(torch.bfloat16)
    g = torch.randn((B, N, HEADS * HEAD_DIM), generator=gen, device=device).to(torch.bfloat16)
    de = torch.randn((B, N, N), generator=gen, device=device)
    g_cls, g_aff = (torch.rand(B // 2, generator=gen, device=device) * 100 for _ in range(2))
    sign = pair_consistency_forward(qkv, scale, HEADS)[3]
    runs = {f"forward, export {export} {str(dtype)[6:]}":
            lambda export=export, dtype=dtype: attention_qkv_cols_forward(qkv, scale, HEADS,
                                                                          export, dtype)
            for export, dtype in (("mean", torch.float32), ("mean", torch.bfloat16),
                                  ("none", torch.float32))}
    runs["pair forward: out, cls and aff sums, sign tile"] = (
        lambda: pair_consistency_forward(qkv, scale, HEADS))
    runs.update({f"backward, de {name}":
                 lambda d=d: (attention_qkv_cols_backward(qkv, g, d, scale, HEADS),)
                 for name, d in (("none", None), ("float32", de),
                                 ("bfloat16", de.to(torch.bfloat16)))})
    runs["backward, sign tile"] = lambda: (pair_consistency_backward(
        qkv, g, sign, g_cls, g_aff, scale, HEADS),)
    x = torch.randn((2, 3, CROP, CROP), generator=gen, device=device)
    m = torch.rand((2, NUM_CLASSES, CROP, CROP), generator=gen, device=device)
    aff = pamr_affinity(x, PAMR_DILATIONS)
    for dils in (PAMR_DILATIONS, (1, 40)):
        runs[f"PAMR affinity (K3, {affinity_route(dils)} kernel), dilations {dils}"] = (
            lambda dils=dils: (pamr_affinity(x, dils),))
    runs[f"PAMR update (K4), {PAMR_ITERS} chained launches"] = lambda: (
        pamr_update(m, aff, PAMR_DILATIONS, PAMR_ITERS),)
    for name, run in runs.items():
        first, second = run(), run()
        torch.cuda.synchronize()
        same = all((a is None and b is None) or torch.equal(a, b) for a, b in zip(first, second))
        log(f"  {name}: two launches {'equal to the bit' if same else 'DIFFER'}")
        if not same:
            raise AssertionError(f"{name}: two launches on the same inputs differ")


def check_pamr(device, errs) -> None:
    """K3, and K4 chained over PAMR_ITERS launches on the same affinity,
    against their plain versions: B=2 and B=8 views of 384x384 with the
    default dilations; B=3, 21 channels at 65x131, whose rows straddle
    K4's blocks of 128 pixels and whose last tiles of K3 are partial in
    both axes; a ragged 17x13 image with dilation 24, smaller than K3's
    halo; and 70x90 with dilation 40, beyond the halo, which K3 takes
    through its gather kernel."""
    gen = torch.Generator(device=device).manual_seed(2)
    for B, C, H, W, dils in ((2, NUM_CLASSES, CROP, CROP, PAMR_DILATIONS),
                             (8, NUM_CLASSES, CROP, CROP, PAMR_DILATIONS),
                             (3, NUM_CLASSES + 1, 65, 131, PAMR_DILATIONS),
                             (1, NUM_CLASSES, 17, 13, (1, 24)),
                             (1, NUM_CLASSES, 70, 90, (1, 40))):
        x = torch.randn((B, 3, H, W), generator=gen, device=device)
        m = torch.rand((B, C, H, W), generator=gen, device=device)
        log(f"  K3 B={B} {H}x{W} dilations {dils} ({affinity_route(dils)} kernel)")
        aff = pamr_affinity(x, dils)
        ref = pamr_affinity_plain(x, dils)
        torch.cuda.synchronize()
        errs[("K3", B, H, W)] = check_close("aff", aff, ref, PAMR_RTOL, PAMR_ATOL)
        log(f"  K4 B={B} C={C} {H}x{W}, {PAMR_ITERS} chained launches")
        got = pamr_update(m, aff, dils, PAMR_ITERS)
        ref = m
        for _ in range(PAMR_ITERS):
            ref = pamr_update_plain(ref, aff, dils)
        torch.cuda.synchronize()
        errs[("K4", B, H, W)] = check_close("mask", got, ref, PAMR_RTOL, PAMR_ATOL)


def phase_kernels(device) -> dict:
    """Kernel against plain version; returns max abs errs by case."""
    errs: dict = {}
    check_k1(device, errs)
    check_k2_k1b(device, errs)
    check_many_tokens(device, errs)
    check_same_bits(device)
    check_pamr(device, errs)
    return errs


ENTRIES = {"K5a": fused_attention_with_probs, "K5b": fused_attention_nhd,
           "K5c": fused_attention_qkv}
ENTRY_LAYOUTS = {"K5a": "bhnd", "K5b": "nhd", "K5c": "cols"}
# The export dtypes each entry takes (JAX's K5a exports float32 only).
ENTRY_DTYPES = {"K5a": (torch.float32,), "K5b": (torch.float32, torch.bfloat16),
                "K5c": (torch.float32, torch.bfloat16)}


def zero_counts() -> dict:
    return {"K1f": 0, "K1n": 0, "K1b": 0, "K2f": 0, "K2b": 0, "K3": 0, "K4": 0,
            **{f"{e}{d}": 0 for e in ENTRIES for d in "fb"}}


def reset_counts() -> None:
    """Every kernel wrapper's launch count to 0."""
    fused_attention_qkv_cols.launches = 0
    fused_attention_qkv_cols.launches_noexport = 0
    attention_qkv_cols_backward.launches = attention_qkv_cols_backward.launches_no_de = 0
    pair_consistency_forward.launches = 0
    pair_consistency_backward.launches = 0
    pamr_affinity.launches = 0
    pamr_update.launches = 0
    for fn in ENTRIES.values():
        fn.launches = fn.launches_noexport = fn.backward_launches = 0


def read_counts() -> dict:
    noexport = fused_attention_qkv_cols.launches_noexport
    return {"K1f": fused_attention_qkv_cols.launches - noexport, "K1n": noexport,
            "K1b": attention_qkv_cols_backward.launches,
            "K2f": pair_consistency_forward.launches,
            "K2b": pair_consistency_backward.launches,
            "K3": pamr_affinity.launches, "K4": pamr_update.launches,
            **{f"{e}f": fn.launches for e, fn in ENTRIES.items()},
            **{f"{e}b": fn.backward_launches for e, fn in ENTRIES.items()}}


def make_images(tmp: str, seed: int):
    """Seeded VOC-sized JPEGs, 1-3 labels each, and label PNGs."""
    rng = np.random.default_rng(seed)
    names, paths, labels = [], [], []
    os.makedirs(os.path.join(tmp, "gt"))
    for i, (h, w) in enumerate(IMAGE_SIZES):
        name = f"smoke_{i}"
        coarse = rng.integers(0, 256, (h // 25, w // 25, 3), dtype=np.uint8)
        img = Image.fromarray(coarse).resize((w, h), Image.BILINEAR)
        img.save(os.path.join(tmp, f"{name}.jpg"), quality=90)
        classes = rng.choice(20, size=int(rng.integers(1, 4)), replace=False)
        label = np.zeros(20, np.float32)
        label[classes] = 1.0
        gt = rng.choice(np.concatenate([[0], classes + 1]), size=(h // 25, w // 25))
        Image.fromarray(gt.astype(np.uint8)).resize((w, h), Image.NEAREST).save(
            os.path.join(tmp, "gt", f"{name}.png"))
        names.append(name)
        paths.append(os.path.join(tmp, f"{name}.jpg"))
        labels.append(label)
    return names, paths, labels


def load_model(device, attn_impl, state=None) -> ACR:
    model = ACR(backbone_name="vitb_hybrid", dtype=torch.bfloat16, attn_impl=attn_impl)
    if state is not None:
        model.load_state_dict(state)
    elif os.path.exists(WEIGHTS):
        model.load_state_dict(flax_to_state_dict(load_params_npz(WEIGHTS),
                                                 model.state_dict()))
        log(f"  weights: {os.path.relpath(WEIGHTS, ROOT)} (flax npz through the converter)")
    else:
        init_random_(model, seed=0)
        log("  weights: seeded random init (seed 0); the tracked npz is absent")
    return model.to(device)


def check_cams(names, labels, cams, sizes) -> None:
    """One CAM per present class, finite, in [0, 1], at native size."""
    for name, lab, cam, (h, w) in zip(names, labels, cams, sizes):
        present = sorted(np.flatnonzero(lab).tolist())
        if sorted(cam) != present:
            raise AssertionError(f"{name}: CAM classes {sorted(cam)} != labels {present}")
        for c, m in cam.items():
            if m.shape != (h, w) or not np.isfinite(m).all() or m.min() < 0 or m.max() > 1:
                raise AssertionError(f"{name} class {c}: shape {m.shape}, range "
                                     f"[{m.min()}, {m.max()}]")


def compare_cams(what, cams, refs) -> None:
    diffs = [np.abs(cam[c] - ref[c]) for cam, ref in zip(cams, refs) for c in cam]
    max_abs = max(d.max() for d in diffs)
    mean_abs = float(np.mean([d.mean() for d in diffs]))
    log(f"  {what}: max abs {max_abs:.4g} (tolerance {CAM_MAX_ABS}), mean abs "
        f"{mean_abs:.4g} (tolerance {CAM_MEAN_ABS})")
    if max_abs > CAM_MAX_ABS or mean_abs > CAM_MEAN_ABS:
        raise AssertionError(f"{what}: the kernel and plain paths disagree")


def phase_main_path(device, tmp):
    """The inference path without and with ``--pamr 10``. Returns (infer
    fn, image paths, labels, launches, launches with PAMR, PAMR fn, PAMR's
    first input (guidance, CAMs))."""
    model = load_model(device, "kernel")
    names, paths, labels = make_images(tmp, seed=0)
    infer = build_infer_fn(model, CROP, START_LAYER, "grad", True, NUM_CLASSES,
                           class_slots=CLASS_SLOTS)
    passes = sum(math.ceil(int((lab > 0).sum()) / CLASS_SLOTS) for lab in labels)

    reset_counts()
    cams = [process_image(infer, p, lab, CROP)[0] for p, lab in zip(paths, labels)]
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"  launches: {launches} over {passes} trunk passes "
        f"({launches['K1f'] / passes:g} K1f per pass, blocks 0-{START_LAYER - 1})")
    if launches != {**zero_counts(), "K1f": START_LAYER * passes}:
        raise AssertionError(f"expected {START_LAYER} K1f launches per pass and no other")
    check_cams(names, labels, cams, IMAGE_SIZES)
    for name, cam in zip(names, cams):
        np.save(os.path.join(tmp, f"{name}.npy"), cam)
    log(f"  CAMs: {sum(len(c) for c in cams)} maps, finite, in [0, 1], native size")
    curve = evaluate.do_python_eval_curve(tmp, os.path.join(tmp, "gt"), names, num_workers=1)
    best = max(range(len(curve)), key=lambda i: curve[i]["mIoU"])
    log(f"  evaluate: mIoU curve of {len(curve)} thresholds on seeded labels, "
        f"best {curve[best]['mIoU']:.3f}% at {best / 100:.2f}")

    pamr_fn = make_pamr_fn(PAMR_ITERS, PAMR_DILATIONS)
    inputs = []

    def keep_inputs(x, mask):
        inputs.append((x.clone(), mask.clone()))
        return pamr_fn(x, mask)

    reset_counts()
    cams_pamr = [process_image(infer, p, lab, CROP, pamr_fn=keep_inputs)[0]
                 for p, lab in zip(paths, labels)]
    torch.cuda.synchronize()
    pamr_launches = read_counts()
    log(f"  with --pamr {PAMR_ITERS} (dilations {PAMR_DILATIONS}): launches {pamr_launches} "
        f"over {len(paths)} images, one scale")
    if pamr_launches != {**zero_counts(), "K1f": START_LAYER * passes, "K3": len(paths),
                         "K4": PAMR_ITERS * len(paths)}:
        raise AssertionError(f"expected {START_LAYER} K1f per pass, 1 K3 and {PAMR_ITERS} "
                             f"K4 per image, and no other")
    check_cams(names, labels, cams_pamr, IMAGE_SIZES)
    log(f"  CAMs with PAMR: {sum(len(c) for c in cams_pamr)} maps, finite, in [0, 1], "
        f"native size")
    # PAMR alone, kernels against plain on the same CAMs; the CAMs are not
    # in [0, 1], so the absolute part of the tolerance scales with them.
    for x, mask in inputs:
        ref = pamr_plain(x, mask, PAMR_ITERS, PAMR_DILATIONS)
        got = pamr_fn(x, mask)
        torch.cuda.synchronize()
        log(f"  PAMR alone on the inference path's CAMs {tuple(mask.shape)} -> "
            f"{tuple(ref.shape)}, |CAM| <= {ref.abs().max().item():.4g}")
        check_close("refined CAMs", got, ref, PAMR_RTOL, PAMR_ATOL * ref.abs().max().item())

    plain = load_model(device, "plain", state=model.state_dict())
    plain_infer = build_infer_fn(plain, CROP, START_LAYER, "grad", True, NUM_CLASSES,
                                 class_slots=CLASS_SLOTS)
    plain_pamr = functools.partial(pamr_plain, num_iter=PAMR_ITERS, dilations=PAMR_DILATIONS)
    refs = [process_image(plain_infer, p, lab, CROP)[0] for p, lab in zip(paths, labels)]
    refs_pamr = [process_image(plain_infer, p, lab, CROP, pamr_fn=plain_pamr)[0]
                 for p, lab in zip(paths, labels)]
    compare_cams("kernel path vs plain path CAMs", cams, refs)
    compare_cams(f"with --pamr {PAMR_ITERS}, kernel path vs plain attention and plain PAMR",
                 cams_pamr, refs_pamr)
    del plain, plain_infer
    return infer, paths, labels, launches, pamr_launches, pamr_fn, inputs[0]


def make_train_fixture(root: str, seed: int) -> TrainConfig:
    """A seeded synthetic VOC fixture (375x500-class JPEGs, 1-3 labels each,
    cls_labels.npy, train and val lists) and the recipe's config over it."""
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "JPEGImages")
    os.makedirs(img_dir)
    names, labels = [], {}
    for i in range(TRAIN_IMAGES + VAL_IMAGES):
        h, w = TRAIN_SIZES[i % len(TRAIN_SIZES)]
        name = f"2007_{i:06d}"
        coarse = rng.integers(0, 256, (h // 25, w // 25, 3), dtype=np.uint8)
        Image.fromarray(coarse).resize((w, h), Image.BILINEAR).save(
            os.path.join(img_dir, f"{name}.jpg"), quality=90)
        label = np.zeros(20, np.float32)
        label[rng.choice(20, size=int(rng.integers(1, 4)), replace=False)] = 1.0
        names.append(name)
        labels[name] = label
    np.save(os.path.join(root, "cls_labels.npy"), labels)
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("\n".join(names[:TRAIN_IMAGES]) + "\n")
    with open(os.path.join(root, "val.txt"), "w") as f:
        f.write("\n".join(names[TRAIN_IMAGES:]) + "\n")
    return TrainConfig(
        model=ModelConfig(backbone="vitb_hybrid", attn_impl="kernel", fuse_consistency=True),
        crop_size=CROP, batch_size=TRAIN_BATCH, max_epochs=1, log_every=1,
        val_every=TRAIN_IMAGES // TRAIN_BATCH, checkpoint_dir=os.path.join(root, "weight"),
        session_name="smoke", image_dir=img_dir,
        train_list=os.path.join(root, "train.txt"), val_list=os.path.join(root, "val.txt"),
        cls_labels_path=os.path.join(root, "cls_labels.npy"), num_workers=4,
        device="cuda")


def phase_train_path(device, root):
    """train.train as a user runs it; returns (config, launches, state)."""
    cfg = make_train_fixture(root, seed=0)
    log(f"  recipe: {cfg.model.backbone}, crop {cfg.crop_size}, batch {cfg.batch_size} "
        f"({2 * cfg.batch_size} images through the trunk), lr {cfg.lr}, alpha {cfg.alpha}, "
        f"wd {cfg.weight_decay}, momentum {cfg.momentum}, fused consistency; "
        f"weights: seeded random init (seed {cfg.seed}); {TRAIN_IMAGES} training and "
        f"{VAL_IMAGES} validation images")
    reset_counts()
    state = train_mod.train(cfg)
    torch.cuda.synchronize()
    launches = read_counts()
    depth = state.model.spec.depth
    val_passes = math.ceil(VAL_IMAGES / cfg.batch_size)
    expected = {**zero_counts(), "K2f": depth * state.steps, "K2b": depth * state.steps,
                "K1n": depth * val_passes}
    log(f"  launches: {launches} over {state.steps} train steps and {val_passes} "
        f"validation batch (expected {expected})")
    if launches != expected:
        raise AssertionError("the training path did not launch the kernels as expected")
    for step, parts in enumerate(state.history):
        log(f"  step {step}: " + ", ".join(f"{k} {v:.6g}" for k, v in parts.items()))
        if not all(math.isfinite(v) for v in parts.values()):
            raise AssertionError(f"step {step}: a loss part is not finite")
    npz = os.path.join(cfg.checkpoint_dir, f"{cfg.session_name}_last.npz")
    model = infer_cam.load_model(InferConfig(weights=npz, device="cuda"))
    infer = build_infer_fn(model, CROP, START_LAYER, "grad", True, 20, class_slots=CLASS_SLOTS)
    name = voc_data.read_file(cfg.val_list)[0]
    labels = voc_data.load_cls_labels(cfg.cls_labels_path)
    cam, _, rgb = process_image(infer, os.path.join(cfg.image_dir, f"{name}.jpg"),
                                labels[name], CROP)
    if not cam or not all(np.isfinite(m).all() and m.shape == rgb.shape[:2]
                          for m in cam.values()):
        raise AssertionError("infer_cam on the trained npz gave no or non-finite CAMs")
    log(f"  {os.path.basename(npz)} ({os.path.getsize(npz) / 1e6:.1f} MB) read by the "
        f"port's infer_cam: {len(cam)} finite CAMs at {rgb.shape[0]}x{rgb.shape[1]}")
    del model, infer
    return cfg, launches, state


def _attn_inputs(model):
    """Forward hooks that keep each block's attention input."""
    inputs, handles = [], []
    for block in model.trunk.blocks:
        handles.append(block.attn.register_forward_hook(
            lambda mod, args, out: inputs.append((mod, args[0].detach()))))
    return inputs, handles


@torch.no_grad()
def kernel_signs(model, x):
    """The K2f sign tiles of the fused forward of ``model`` on the
    interleaved pairs of ``x`` and its flip, one per layer."""
    xi = torch.stack([x, torch.flip(x, dims=(2,))], dim=1).reshape((-1,) + x.shape[1:])
    inputs, handles = _attn_inputs(model)
    try:
        model.forward_cls(xi, export="pair_l1", mirror_second_half="interleaved")
    finally:
        for h in handles:
            h.remove()
    return [pair_consistency_forward(F.linear(a, m.qkv.weight.to(a.dtype),
                                              m.qkv.bias.to(a.dtype)),
                                     m.scale, m.num_heads)[3] for m, a in inputs]


@torch.no_grad()
def plain_signs(model, x):
    """sign(mean_h p1 - mean_h p2) of the plain per-layer aligned forward."""
    b = x.shape[0]
    out = model.forward_cls(torch.cat([x, torch.flip(x, dims=(2,))]), mirror_second_half=True)
    cls_mask, aff_mask = attn_pair.pair_masks(out["n_tokens"], x.device)
    return [torch.where(cls_mask | aff_mask, torch.sign(p[:b] - p[b:]), 0.0).to(torch.int8)
            for p in out["probs_layers"]]


def step_on(model, opt, cfg, batch):
    """(model, optimizer, step-0 parts, parameters before, after) of one
    train step of ``model`` and ``opt`` on ``batch``."""
    grid = (cfg.crop_size // 16, cfg.crop_size // 16)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    parts = train_mod.make_train_step(model, opt, cfg, grid)(batch)
    parts = {k: float(v) for k, v in parts.items()}
    after = {k: v.detach().clone() for k, v in model.named_parameters()}
    return model, opt, parts, before, after


def one_step(cfg, attn_impl, fuse, state_dict, batch):
    """``step_on`` a model loaded with ``state_dict`` and a fresh
    optimizer."""
    tcfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, attn_impl=attn_impl, fuse_consistency=fuse))
    model = train_mod.build_model(tcfg.model)
    model.load_state_dict(state_dict)
    model.to(cfg.device)
    opt = train_mod.make_optimizer(model.parameters(), tcfg.lr, TRAIN_IMAGES // TRAIN_BATCH,
                                   tcfg.weight_decay, tcfg.momentum, tcfg.poly_power)
    return step_on(model, opt, tcfg, batch)


def update_rel(got, ref) -> dict:
    """Per parameter tensor: |(p1 - p0) - (ref p1 - p0)| / |ref p1 - p0|."""
    _, _, _, p0, p1 = got
    rel = {}
    for k, ref_p1 in ref[4].items():
        ref_u = ref_p1 - p0[k]
        rel[k] = float((p1[k] - p0[k] - ref_u).norm() / ref_u.norm().clamp_min(1e-30))
    return rel


def compare_steps_losses(name, got, ref, ref_name) -> None:
    """Step-0 loss parts against ``ref_name``'s."""
    parts, ref_parts = got[2], ref[2]
    for k in ref_parts:
        rel = abs(parts[k] - ref_parts[k]) / max(abs(ref_parts[k]), 1e-30)
        log(f"    {k}: {parts[k]:.7g} vs {ref_parts[k]:.7g} (rel {rel:.3g}, "
            f"tolerance {LOSS_RTOL})")
        if rel > LOSS_RTOL:
            raise AssertionError(f"{name}: step-0 {k} disagrees with {ref_name}")


def compare_steps(name, got, ref, ref_name="the plain path") -> None:
    """Step-0 loss parts and parameters after one update, against
    ``ref_name``'s."""
    compare_steps_losses(name, got, ref, ref_name)
    rel = update_rel(got, ref)
    worst = sorted(rel, key=rel.get, reverse=True)
    attn = [k for k in rel if ".attn.qkv." in k]
    log(f"    update p1 - p0 against {ref_name}'s, relative L2 per tensor: worst "
        + ", ".join(f"{k} {rel[k]:.3g}" for k in worst[:3])
        + f"; attention qkv weights at most {max(rel[k] for k in attn):.3g} "
        f"(tolerance {UPDATE_REL})")
    if rel[worst[0]] > UPDATE_REL:
        raise AssertionError(f"{name}: parameter updates disagree with {ref_name}")


def phase_step_compare(device, cfg):
    """One train step, kernel path against plain path, from the same seeded
    weights and the first training batch. Returns (fused kernel step's
    model, optimizer, batch, per-layer launches, (weights, batch,
    the plain step), the fused kernel step)."""
    weights = init_random_(train_mod.build_model(cfg.model), seed=cfg.seed).state_dict()
    labels = voc_data.load_cls_labels(cfg.cls_labels_path)
    it = voc_data.TrainIterator(
        voc_data.VOCClassificationSource(cfg.image_dir, labels, cfg.crop_size),
        voc_data.read_file(cfg.train_list), cfg.batch_size, seed=cfg.seed, num_workers=4)
    batch = next(it)
    it.close()

    plain = one_step(cfg, "plain", False, weights, batch)
    fused = one_step(cfg, "kernel", True, weights, batch)
    log("  fused branch (K2f, K2b) against the plain per-layer path:")
    compare_steps("fused branch", fused, plain)
    x = torch.as_tensor(batch["image"]).to(device)
    model_k = train_mod.build_model(cfg.model).to(device)
    model_k.load_state_dict(weights)
    model_p = train_mod.build_model(dataclasses.replace(cfg.model, attn_impl="plain")).to(device)
    model_p.load_state_dict(weights)
    ks, ps = kernel_signs(model_k, x), plain_signs(model_p, x)
    differ = sum(int((a != b).sum()) for a, b in zip(ks, ps))
    total = sum(a.numel() for a in ks)
    log(f"  sign-tile entries that differ between the kernel and the plain path at step 0: "
        f"{differ} of {total} ({100 * differ / total:.4f}%), over {len(ks)} layers")
    del model_k, model_p

    reset_counts()
    per_layer = one_step(cfg, "kernel", False, weights, batch)
    torch.cuda.synchronize()
    launches = read_counts()
    depth = per_layer[0].spec.depth
    log(f"  per-layer branch (K1f, K1b) against the plain per-layer path; launches "
        f"{launches}")
    if launches != {**zero_counts(), "K1f": depth, "K1b": depth}:
        raise AssertionError(f"expected {depth} K1f and {depth} K1b launches, no other")
    compare_steps("per-layer branch", per_layer, plain)
    del per_layer
    return fused[0], fused[1], batch, launches, (weights, batch, plain), fused


def read_metrics(cfg):
    with open(os.path.join(cfg.checkpoint_dir, f"{cfg.session_name}_metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def first_batch(cfg, **iterator_kw):
    labels = voc_data.load_cls_labels(cfg.cls_labels_path)
    it = voc_data.TrainIterator(
        voc_data.VOCClassificationSource(cfg.image_dir, labels, cfg.crop_size),
        voc_data.read_file(cfg.train_list), cfg.batch_size, seed=cfg.seed, num_workers=4,
        **iterator_kw)
    try:
        return next(it)
    finally:
        it.close()


def resume_after_preemption(device, cfg, card):
    """(a) SIGTERM at loop step PREEMPT_STEP, checks of the checkpoint and
    of a step from it, the cost of one save, then the resumed run."""
    rcfg = dataclasses.replace(cfg, checkpoint_every=RESUME_EVERY, session_name="smoke_resume")
    ckpt = CheckpointManager(os.path.join(rcfg.checkpoint_dir, rcfg.session_name))
    npz = os.path.join(rcfg.checkpoint_dir, f"{rcfg.session_name}_last.npz")
    max_step = TRAIN_IMAGES // TRAIN_BATCH
    handlers = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM, signal.SIGINT)}
    orig_add, calls = train_mod.AverageMeter.add, []

    def add_then_sigterm(meter, values):   # in the main thread, after each step's sync
        orig_add(meter, values)
        calls.append(values)
        if len(calls) == PREEMPT_STEP + 1:
            signal.raise_signal(signal.SIGTERM)

    train_mod.AverageMeter.add = add_then_sigterm
    reset_counts()
    try:
        first = train_mod.train(rcfg)
    finally:
        train_mod.AverageMeter.add = orig_add
    torch.cuda.synchronize()
    launches = read_counts()
    depth = first.model.spec.depth
    log(f"  SIGTERM in loop step {PREEMPT_STEP} (checkpoint_every {RESUME_EVERY}): "
        f"{first.steps} steps ran, checkpoints at steps {ckpt.steps()}, final npz "
        f"{'written' if os.path.exists(npz) else 'not written'}, launches {launches}")
    if (first.steps, ckpt.steps(), os.path.exists(npz)) != (PREEMPT_STEP + 1, [PREEMPT_STEP],
                                                           False):
        raise AssertionError("the preempted run did not stop with its checkpoint and no npz")
    if {sig: signal.getsignal(sig) for sig in handlers} != handlers:
        raise AssertionError("the preemption guard did not restore the signal handlers")
    if launches != {**zero_counts(), "K2f": depth * first.steps, "K2b": depth * first.steps}:
        raise AssertionError(f"expected {depth} K2f and K2b launches per step, no other")

    model, opt = train_mod.create_train_state(dataclasses.replace(rcfg, seed=rcfg.seed + 1),
                                              max_step)
    t0 = time.perf_counter()
    step = train_mod.restore_checkpoint(ckpt, model, opt)
    restore_s = time.perf_counter() - t0
    same_params = all(torch.equal(a, b) for a, b in zip(first.model.parameters(),
                                                        model.parameters(), strict=True))
    buffers = [(first.optimizer.sgd.state[a]["momentum_buffer"],
                opt.sgd.state[b]["momentum_buffer"])
               for a, b in zip(first.optimizer.params, opt.params, strict=True)]
    same_momentum = all(torch.equal(a, b) for a, b in buffers)
    want_lr = rcfg.lr * poly_factor(PREEMPT_STEP + 1, max_step, rcfg.poly_power)
    log(f"  restored step {step} in {restore_s:.2f} s: parameters bit for bit {same_params}, "
        f"{len(buffers)} momentum buffers bit for bit {same_momentum}, updates {opt.updates}, "
        f"lr {opt.lr!r} (poly_factor({PREEMPT_STEP + 1}, {max_step}) x lr = {want_lr!r})")
    if not (step == PREEMPT_STEP and same_params and same_momentum and opt.lr == want_lr
            and opt.updates == PREEMPT_STEP + 1):
        raise AssertionError("the checkpoint did not restore the preempted state")

    ckpt_timing = CheckpointManager(os.path.join(rcfg.checkpoint_dir, "smoke_save_timing"))
    t0 = time.perf_counter()
    ckpt_timing.save(0, train_mod.checkpoint_state(0, model, opt))
    copy_s = time.perf_counter() - t0
    ckpt_timing.wait()
    save_s = time.perf_counter() - t0
    nbytes = os.path.getsize(os.path.join(ckpt_timing.directory, "0.pt"))
    log(f"  one checkpoint save (fp32 parameters and momentum, step, lr): {save_s:.2f} s, of "
        f"which {copy_s:.2f} s copying to host memory before save() returns and the rest "
        f"writing on its thread; {nbytes} bytes [{card}]")
    shutil.rmtree(ckpt_timing.directory)

    batch = first_batch(rcfg)
    log("  one step from the restored state against one from the state in memory, same "
        "batch:")
    restored = step_on(model, opt, rcfg, batch)
    in_memory = step_on(first.model, first.optimizer, rcfg, batch)
    compare_steps("restored state", restored, in_memory, "the state in memory")
    log(f"    parameters after the two steps bit for bit equal: "
        f"{all(torch.equal(restored[4][k], in_memory[4][k]) for k in restored[4])}")
    del model, opt, first, restored, in_memory

    profile_dir = os.path.join(rcfg.checkpoint_dir, "profile")
    window = train_mod.PROFILE_WINDOW
    train_mod.PROFILE_WINDOW = (PREEMPT_STEP + 1, PREEMPT_STEP + 2)
    reset_counts()
    try:
        second = train_mod.train(dataclasses.replace(rcfg, profile_dir=profile_dir))
    finally:
        train_mod.PROFILE_WINDOW = window
    torch.cuda.synchronize()
    launches = read_counts()
    trace = os.path.join(profile_dir, f"{rcfg.session_name}_trace.json")
    with open(trace) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"}
    traced = {k: sum(k in n for n in names) > 0 for k in TRACED_KERNELS}
    log(f"  profiler window on loop step {PREEMPT_STEP + 1}: {os.path.getsize(trace)} bytes "
        f"of Chrome trace, {len(names)} distinct kernel names; the port's kernels by name: "
        f"{traced}")
    if not all(traced.values()):
        raise AssertionError("the profiler trace does not name the kernels of K2f and K2b")
    steps = max_step - PREEMPT_STEP
    val_passes = math.ceil(VAL_IMAGES / rcfg.batch_size)
    expected = {**zero_counts(), "K2f": depth * steps, "K2b": depth * steps,
                "K1n": depth * val_passes}
    logged = [r["step"] for r in read_metrics(rcfg)]
    log(f"  relaunch: {second.steps} steps (JAX step count {second.step}), losses "
        + ", ".join(f"{p['loss']:.5g}" for p in second.history)
        + f"; metrics logged at steps {logged}; launches {launches} (expected {expected})")
    if (second.steps, second.step, logged) != (steps, max_step, list(range(max_step + 1))):
        raise AssertionError("the relaunch did not resume at the step after the checkpoint")
    if launches != expected:
        raise AssertionError("the resumed run did not launch the kernels as expected")
    if not os.path.exists(npz) or not all(math.isfinite(v) for p in second.history
                                          for v in p.values()):
        raise AssertionError("the resumed run wrote no npz or a loss part is not finite")
    shutil.rmtree(ckpt.directory)
    shutil.rmtree(profile_dir)
    os.remove(npz)


def device_aug_step(device, cfg) -> None:
    """(b) ``--device_aug`` crops on the card against the host's, then one
    train step on the packed batch against one on the host path fed the
    card's own crops, from the seeded init of phase 7: the same input
    through both paths, held to the step gates."""
    host = first_batch(cfg)
    packed = first_batch(cfg, device_aug=True, aug_pad=cfg.aug_pad)
    t0 = time.perf_counter()
    crops = device_aug.materialize_batch(packed, cfg.crop_size, device)["image"]
    torch.cuda.synchronize()
    aug_ms = (time.perf_counter() - t0) * 1e3
    err = (crops.cpu() - torch.from_numpy(host["image"])).abs().max().item()
    log(f"  packed batch {tuple(packed['image_u8'].shape)} uint8 + {tuple(packed['aug'].shape)} "
        f"descriptors -> crops {tuple(crops.shape)} on {crops.device} in {aug_ms:.1f} ms "
        f"(first call, upload included); max abs against the host crops {err:.3g} "
        f"(tolerance {AUG_ATOL})")
    if crops.device.type != device.type or err > AUG_ATOL or packed["name"] != host["name"]:
        raise AssertionError("device_aug crops disagree with the host crops")
    init = init_random_(train_mod.build_model(cfg.model), seed=cfg.seed).state_dict()
    runs = {}
    for name, batch in (("host", dict(host, image=crops.cpu().numpy())),
                        ("device_aug", packed)):
        reset_counts()
        runs[name] = one_step(cfg, "kernel", True, init, batch)
        torch.cuda.synchronize()
        runs[name] += (read_counts(),)
    depth = runs["host"][0].spec.depth
    log(f"  launches: host path on the card's crops {runs['host'][5]}, packed batch "
        f"{runs['device_aug'][5]}")
    if not runs["host"][5] == runs["device_aug"][5] == {**zero_counts(), "K2f": depth,
                                                        "K2b": depth}:
        raise AssertionError(f"expected {depth} K2f and K2b launches per step, no other")
    ref, got = runs["host"][:5], runs["device_aug"][:5]
    log("  one step on the packed batch against one on the host path fed the card's crops, "
        "from the seeded init:")
    compare_steps("--device_aug step", got, ref, "the host path")
    log(f"    parameters after the two steps bit for bit equal: "
        f"{all(torch.equal(got[4][k], ref[4][k]) for k in ref[4])}")


def supervised_relaunch(cfg, root) -> None:
    """(c) a hang injected at beat HANG_BEAT of a supervised child."""
    train_list = os.path.join(root, "sup_train.txt")
    with open(train_list, "w") as f:
        f.write("\n".join(voc_data.read_file(cfg.train_list)[:SUPERVISED_IMAGES]) + "\n")
    scfg = dataclasses.replace(cfg, train_list=train_list, session_name="smoke_sup",
                               checkpoint_every=1, step_timeout_s=STEP_TIMEOUT_S)
    sentinel = os.path.join(root, "hang_injected")
    os.environ.update(ACR_FAULT_HANG_ONCE=sentinel, ACR_FAULT_HANG_BEAT=str(HANG_BEAT))
    try:
        relaunches = run_train_supervised(scfg, max_relaunches=1)
    finally:
        for k in ("ACR_FAULT_HANG_ONCE", "ACR_FAULT_HANG_BEAT"):
            os.environ.pop(k, None)
    records = read_metrics(scfg)
    ckpt = CheckpointManager(os.path.join(scfg.checkpoint_dir, scfg.session_name))
    steps = SUPERVISED_IMAGES // scfg.batch_size + 1
    npz = os.path.join(scfg.checkpoint_dir, f"{scfg.session_name}_last.npz")
    # the Timer starts before the first batch: step 0's record reads the
    # time to it through imps = batch / elapsed
    warmup = scfg.batch_size / records[0]["imps"]
    live = records[1]["time"] - records[0]["time"]
    log(f"  relaunches {relaunches} (the child exited 75 at the injected hang), hang "
        f"injected: {os.path.exists(sentinel)}, checkpoints {ckpt.steps()}, steps logged "
        f"{[r['step'] for r in records]}, final npz {os.path.exists(npz)}; first child: step "
        f"0 with its batch {warmup:.2f} s after the loop started (exempt), step 1 and its "
        f"checkpoint {live:.2f} s; watchdog timeout {STEP_TIMEOUT_S} s")
    if (relaunches, os.path.exists(sentinel), ckpt.steps(), [r["step"] for r in records],
            os.path.exists(npz)) != (1, True, [steps - 2, steps - 1], list(range(steps)), True):
        raise AssertionError("the supervised run did not relaunch once and resume to the end")
    if max(warmup, live) >= STEP_TIMEOUT_S:
        raise AssertionError("a live step came near the watchdog timeout")
    shutil.rmtree(ckpt.directory)
    os.remove(npz)


def pretrained_init(cfg, root) -> None:
    """(d) ``--pretrained`` from a zoo npz of seeded weights."""
    zoo_dir = os.path.join(root, "zoo")
    os.makedirs(zoo_dir)
    path = zoo.npz_path(cfg.model.backbone, zoo_dir)
    donor = state_dict_to_flax(init_random_(train_mod.build_model(cfg.model),
                                            seed=cfg.seed + 7))
    save_params_npz(path, donor)
    previous = os.environ.get("ACR_WSSS_ZOO")
    os.environ["ACR_WSSS_ZOO"] = zoo_dir
    try:
        model, _ = train_mod.create_train_state(dataclasses.replace(cfg, pretrained=True),
                                                TRAIN_IMAGES // TRAIN_BATCH)
    finally:
        if previous is None:
            os.environ.pop("ACR_WSSS_ZOO")
        else:
            os.environ["ACR_WSSS_ZOO"] = previous
    got = state_dict_to_flax(model)
    trunk = [k for k in donor if k.startswith(zoo.TRUNK)]
    same_trunk = all(np.array_equal(got[k], donor[k]) for k in trunk)
    head = "params/cls_head/kernel"
    log(f"  {os.path.basename(path)} ({os.path.getsize(path)} bytes): {len(trunk)} trunk "
        f"arrays bit for bit {same_trunk}; head kernel equal to the npz's "
        f"{np.array_equal(got[head], donor[head])}; model on {next(model.parameters()).device}")
    if not same_trunk or np.array_equal(got[head], donor[head]):
        raise AssertionError("--pretrained did not graft exactly the trunk")
    shutil.rmtree(zoo_dir)


def make_coco_fixture(root: str, seed: int):
    """Train and val directories of COCO-sized JPEGs and a bbox txt per
    image (1-3 categories of the 80). Returns (train dir, val dir, bbox dir)."""
    rng = np.random.default_rng(seed)
    dirs = [os.path.join(root, d) for d in ("train2014", "val2014", "bbox")]
    for d in dirs:
        os.makedirs(d)
    for split, d, n in (("train2014", dirs[0], COCO_TRAIN), ("val2014", dirs[1], COCO_VAL)):
        for i in range(n):
            h, w = COCO_SIZES[i % len(COCO_SIZES)]
            name = f"COCO_{split}_{i:012d}"
            coarse = rng.integers(0, 256, (h // 25, w // 25, 3), dtype=np.uint8)
            Image.fromarray(coarse).resize((w, h), Image.BILINEAR).save(
                os.path.join(d, f"{name}.jpg"), quality=90)
            cats = rng.choice(coco_data.COCO_CATEGORY_IDS, size=int(rng.integers(1, 4)),
                              replace=False)
            with open(os.path.join(dirs[2], f"{name}.txt"), "w") as f:
                f.write("".join(f"{rng.integers(0, w)} {rng.integers(0, h)} {c} 20 20\n"
                                for c in cats))
    return dirs


def coco_path(cfg, root) -> None:
    """(e) ``train_coco.main``, validation on ``--valpath``, the CAM pass,
    at the crop and on the device of ``cfg``."""
    train_dir, val_dir, bbox_dir = make_coco_fixture(os.path.join(root, "coco"), seed=3)
    argv = ["--IMpath", train_dir, "--bbox_dir", bbox_dir, "--valpath", val_dir,
            "--max_epoches", "1", "--device_aug", "--session_name", "smoke_coco",
            "--crop_size", str(cfg.crop_size), "--device", cfg.device]
    log("  python -m acr_wsss_tpu_torch.train_coco " + " ".join(argv))
    reset_counts()
    with contextlib.chdir(os.path.join(root, "coco")):   # its checkpoint_dir is ./weight
        state = train_coco.main(argv)
    torch.cuda.synchronize()
    launches = read_counts()
    depth = state.model.spec.depth
    steps = COCO_TRAIN // TRAIN_BATCH + 1
    log(f"  {state.steps} steps, losses " + ", ".join(f"{p['loss']:.5g}" for p in state.history)
        + f"; launches {launches}")
    if state.steps != steps or not all(math.isfinite(v) for p in state.history
                                       for v in p.values()):
        raise AssertionError("COCO training did not run its steps with finite losses")
    if launches != {**zero_counts(), "K2f": depth * steps, "K2b": depth * steps}:
        raise AssertionError(f"expected {depth} K2f and K2b launches per step, no other")

    coco_cfg = train_coco.parse_args(argv)
    reset_counts()
    val_loss = train_mod.validate(coco_cfg, state.model,
                                  train_mod.make_eval_step(state.model))
    torch.cuda.synchronize()
    launches = read_counts()
    val_passes = math.ceil(COCO_VAL / coco_cfg.batch_size)
    log(f"  validation on --valpath ({COCO_VAL} images): loss {val_loss:.5g}, launches "
        f"{launches}")
    if not math.isfinite(val_loss) or launches != {**zero_counts(), "K1n": depth * val_passes}:
        raise AssertionError(f"expected {depth * val_passes} K1n launches and a finite loss")
    del state

    names = coco_data.list_image_names(train_dir)[:COCO_CAM]
    infer_list = os.path.join(root, "coco", "cam_list.txt")
    with open(infer_list, "w") as f:
        f.write("\n".join(names) + "\n")
    out_cam = os.path.join(root, "coco", "cams")
    icfg = InferConfig(model=ModelConfig(num_classes=80), dataset="coco",
                       weights=os.path.join(root, "coco", "weight", "smoke_coco_last.npz"),
                       crop_size=cfg.crop_size, image_dir=train_dir, infer_list=infer_list,
                       cls_labels_path=bbox_dir, out_cam=out_cam, device=cfg.device)
    labels = [coco_data.get_coco_cls_label(n, bbox_dir) for n in names]
    passes = sum(math.ceil(int(lab.sum()) / CLASS_SLOTS) for lab in labels)
    reset_counts()
    infer_cam.run(icfg)
    torch.cuda.synchronize()
    launches = read_counts()
    cams = [np.load(os.path.join(out_cam, f"{n}.npy"), allow_pickle=True).item() for n in names]
    sizes = [Image.open(os.path.join(train_dir, f"{n}.jpg")).size[::-1] for n in names]
    log(f"  CAM pass, dataset coco, {len(names)} images: classes "
        f"{[sorted(c) for c in cams]}, launches {launches}")
    if launches != {**zero_counts(), "K1f": START_LAYER * passes}:
        raise AssertionError(f"expected {START_LAYER} K1f launches per pass, no other")
    check_cams(names, labels, cams, sizes)


def phase_resume(device, cfg, root, card) -> None:
    """Phase 6: parts (a)-(e), each timed."""
    def timed(label, fn, *args):
        log(f"  {label}")
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"  {label}: {time.perf_counter() - t0:.1f} s [{card}]")
        return out

    timed("(a) preempt and resume", resume_after_preemption, device, cfg, card)
    timed("(b) --device_aug", device_aug_step, device, cfg)
    timed("(c) supervised relaunch", supervised_relaunch, cfg, root)
    timed("(d) --pretrained", pretrained_init, cfg, root)
    timed("(e) COCO", coco_path, cfg, root)


class _PlainK1(torch.autograd.Function):
    """K1 and its VJP as their plain versions, on any device."""

    @staticmethod
    def forward(ctx, qkv, scale, num_heads, export, probs_dtype):
        ctx.save_for_backward(qkv)
        ctx.scale, ctx.num_heads = scale, num_heads
        ctx.set_materialize_grads(False)
        return attention_qkv_cols_plain(qkv, scale, num_heads, export, probs_dtype)

    @staticmethod
    def backward(ctx, g_out, g_probs):
        (qkv,) = ctx.saved_tensors
        if g_out is None:
            g_out = qkv.new_zeros(qkv.shape[:-1] + (qkv.shape[-1] // 3,))
        return (attention_qkv_cols_backward_plain(qkv, g_out.to(qkv.dtype), g_probs,
                                                  ctx.scale, ctx.num_heads),
                None, None, None, None)


@contextlib.contextmanager
def k1_as_plain():
    """The model's kernel branch with K1 replaced by its plain versions, the
    bf16 export included: the reference that isolates the kernels in a bf16
    step. (The plain path exports float32; the L1 terms' gradient, alpha
    times the sign of a difference of two views' probs, changes wherever
    the bf16 rounding makes that difference 0 or flips it.)"""
    kernel = vit_mod.fused_attention_qkv_cols
    vit_mod.fused_attention_qkv_cols = (
        lambda qkv, scale, num_heads, export="mean", probs_dtype=torch.float32:
        _PlainK1.apply(qkv, scale, num_heads, export, probs_dtype))
    try:
        yield
    finally:
        vit_mod.fused_attention_qkv_cols = kernel


def entry_inputs(qkv, entry):
    """An entry's inputs as a projection gives them: K5a the (B, H, N, D)
    permute views of qkv (as the model's plain branch makes them), K5b its
    three column chunks, K5c qkv itself."""
    if entry == "K5a":
        return list(qkv.unflatten(-1, (3, HEADS, HEAD_DIM)).permute(2, 0, 3, 1, 4))
    if entry == "K5b":
        return [t.contiguous() for t in qkv.chunk(3, dim=-1)]
    return [qkv]


def call_entry(entry, xs, probs_dtype, export="mean"):
    """The entry as a user calls it: K5a through ``attention_with_probs``."""
    if entry == "K5a":
        return attention_with_probs(*xs, HEAD_DIM ** -0.5, export=export, impl="kernel")
    return ENTRIES[entry](*xs, HEAD_DIM ** -0.5, HEADS, export, probs_dtype)


def check_entries(device, errs) -> None:
    """K5a, K5b and K5c, forward and backward, against their plain versions
    at the training shape, with each export dtype; export "none" gives the
    same out and no probs."""
    gen = torch.Generator(device=device).manual_seed(4)
    B, N, scale = 2 * TRAIN_BATCH, N_TOKENS, HEAD_DIM ** -0.5
    qkv = torch.randn((B, N, 3 * HEADS * HEAD_DIM), generator=gen,
                      device=device).to(torch.bfloat16)
    for entry, layout in ENTRY_LAYOUTS.items():
        xs = entry_inputs(qkv, entry)
        for probs_dtype in ENTRY_DTYPES[entry]:
            name = f"{entry} ({layout}) B={B} N={N} probs {str(probs_dtype)[6:]}"
            log(f"  {name} forward")
            out, probs = attn_forward(layout, xs, scale, HEADS, "mean", probs_dtype,
                                      ENTRIES[entry])
            out_none, probs_none = attn_forward(layout, xs, scale, HEADS, "none", probs_dtype,
                                                ENTRIES[entry])
            ref_out, ref_probs = forward_plain(layout, xs, scale, HEADS, "mean", probs_dtype)
            torch.cuda.synchronize()
            if probs.dtype != probs_dtype or probs_none is not None \
                    or not torch.equal(out_none, out):
                raise AssertionError(f"{name}: probs dtype {probs.dtype}, or export 'none' "
                                     f"differs from 'mean'")
            rtol = 0.0 if probs_dtype == torch.float32 else BF16_PROBS_RTOL
            errs[(entry, "fwd", probs_dtype)] = max(
                check_close("out", out, ref_out, OUT_RTOL, OUT_ATOL),
                check_close("probs", probs, ref_probs, rtol, PROBS_ATOL))
            log(f"  {name} backward, de {str(probs_dtype)[6:]}")
            g = torch.randn(out.shape, generator=gen, device=device).to(torch.bfloat16)
            de = torch.randn((B, N, N), generator=gen, device=device).to(probs_dtype)
            got = attn_backward(layout, xs, g, de, scale, HEADS, ENTRIES[entry])
            ref = backward_plain(layout, xs, g, de, scale, HEADS)
            torch.cuda.synchronize()
            errs[(entry, "bwd", probs_dtype)] = max(
                check_grad(f"d{i}", a, b) for i, a, b in zip("qkv" if len(got) == 3 else "x",
                                                             got, ref))


def phase_attention_entries(device, cfg, step_ctx):
    """The three K5 entries against their plain versions, then through
    autograd as a user calls them (launches counted), then the per-layer
    branch with a bf16 export: one step against the plain path and a few
    steps of ``train.train``. Returns the max abs errs and the launches
    of the entry run and of the bf16 training run."""
    errs: dict = {}
    check_entries(device, errs)

    gen = torch.Generator(device=device).manual_seed(5)
    B, N, scale = 2 * TRAIN_BATCH, N_TOKENS, HEAD_DIM ** -0.5
    qkv = torch.randn((B, N, 3 * HEADS * HEAD_DIM), generator=gen,
                      device=device).to(torch.bfloat16)
    w_probs = torch.randn((B, N, N), generator=gen, device=device)
    runs = []
    reset_counts()
    for entry, layout in ENTRY_LAYOUTS.items():
        for probs_dtype in ENTRY_DTYPES[entry]:
            xs = [t.detach().requires_grad_(True) for t in entry_inputs(qkv, entry)]
            out, probs = call_entry(entry, xs, probs_dtype)
            w_out = torch.randn(out.shape, generator=gen, device=device)
            ((out.float() * w_out).sum() + (probs.float() * w_probs).sum()).backward()
            runs.append((entry, layout, probs_dtype, xs, w_out))
    torch.cuda.synchronize()
    launches = read_counts()
    expected = {**zero_counts(), **{f"{e}{d}": len(ENTRY_DTYPES[e]) for e in ENTRIES
                                   for d in "fb"}}
    log(f"  entries through autograd (K5a as attention_with_probs(impl='kernel')), each "
        f"export dtype once: launches {launches}")
    if launches != expected:
        raise AssertionError(f"expected {expected}")
    for entry, layout, probs_dtype, xs, w_out in runs:
        log(f"  {entry} gradients through autograd, probs {str(probs_dtype)[6:]}, against "
            f"the plain backward")
        refs = backward_plain(layout, [x.detach() for x in xs], w_out.to(torch.bfloat16),
                              w_probs.to(probs_dtype), scale, HEADS)
        for x, ref in zip(xs, refs):
            if x.grad is None or x.grad.shape != x.shape:
                raise AssertionError(f"{entry}: no gradient of the input's shape")
            check_grad("grad", x.grad, ref)
    del runs

    weights, batch, plain = step_ctx
    cfg16 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, fuse_consistency=False, probs_dtype="bfloat16"),
        session_name="smoke_bf16")
    reset_counts()
    step = one_step(cfg16, "kernel", False, weights, batch)
    torch.cuda.synchronize()
    step_launches = read_counts()
    depth = step[0].spec.depth
    log(f"  per-layer branch, probs_dtype bfloat16 (K1f bf16 export, K1b bf16 de), against "
        f"the plain per-layer path; launches {step_launches}")
    if step_launches != {**zero_counts(), "K1f": depth, "K1b": depth}:
        raise AssertionError(f"expected {depth} K1f and {depth} K1b launches, no other")
    with torch.no_grad():
        dtypes = {p.dtype for p in step[0].forward_cls(
            torch.zeros((1, CROP, CROP, 3), device=device))["probs_layers"]}
    if dtypes != {torch.bfloat16}:
        raise AssertionError(f"the bf16 model exported {dtypes}")
    reset_counts()
    with k1_as_plain():
        ref = one_step(cfg16, "kernel", False, weights, batch)
    torch.cuda.synchronize()
    if read_counts() != zero_counts():
        raise AssertionError("the plain reference launched a kernel")
    log("  against the same step with K1's plain versions (bf16 export, bf16 de):")
    compare_steps("per-layer branch, bf16 export", step, ref)
    log("  against the plain per-layer path, which exports float32:")
    compare_steps("per-layer branch, bf16 against float32 export", step, plain)
    del step, ref, plain

    log(f"  train.train, per-layer branch, probs_dtype bfloat16, {TRAIN_IMAGES} images, "
        f"batch {cfg16.batch_size}")
    reset_counts()
    state = train_mod.train(cfg16)
    torch.cuda.synchronize()
    train_launches = read_counts()
    val_passes = math.ceil(VAL_IMAGES / cfg16.batch_size)
    expected = {**zero_counts(), "K1f": depth * state.steps, "K1b": depth * state.steps,
                "K1n": depth * val_passes}
    log(f"  launches: {train_launches} over {state.steps} train steps and {val_passes} "
        f"validation batch (expected {expected})")
    if train_launches != expected:
        raise AssertionError("the bf16 per-layer training did not launch the kernels as "
                             "expected")
    for i, parts in enumerate(state.history):
        log(f"  step {i}: " + ", ".join(f"{k} {v:.6g}" for k, v in parts.items()))
        if not all(math.isfinite(v) for v in parts.values()):
            raise AssertionError(f"step {i}: a loss part is not finite")
    del state
    return errs, launches, train_launches


def phase_pipeline(cfg: TrainConfig, root: str) -> dict:
    """``pipeline.main`` on the training fixture of ``cfg``: train on its
    first PIPE_TRAIN_IMAGES images, infer with ``--pamr 10`` and evaluate
    on its validation images, whose seeded label PNGs are written here.
    Returns the launches."""
    names = voc_data.read_file(cfg.train_list)[:PIPE_TRAIN_IMAGES]
    train_list = os.path.join(root, "pipe_train.txt")
    with open(train_list, "w") as f:
        f.write("\n".join(names) + "\n")
    val_names = voc_data.read_file(cfg.val_list)
    labels = voc_data.load_cls_labels(cfg.cls_labels_path)
    gt_dir = os.path.join(root, "gt")
    os.makedirs(gt_dir)
    rng = np.random.default_rng(1)
    sizes = []
    for name in val_names:
        h, w = Image.open(os.path.join(cfg.image_dir, f"{name}.jpg")).size[::-1]
        sizes.append((h, w))
        gt = rng.choice(np.concatenate([[0], np.flatnonzero(labels[name]) + 1]),
                        size=(h // 25, w // 25))
        Image.fromarray(gt.astype(np.uint8)).resize((w, h), Image.NEAREST).save(
            os.path.join(gt_dir, f"{name}.png"))
    out_cam, logfile = os.path.join(root, "pipe_cams"), os.path.join(root, "evallog.txt")
    argv = ["--session_name", "smoke_pipe", "--IMpath", cfg.image_dir, "--gt_dir", gt_dir,
            "--cls_labels", cfg.cls_labels_path, "--train_list", train_list,
            "--val_list", cfg.val_list, "--infer_list", cfg.val_list, "--max_epoches", "1",
            "--pamr", str(PAMR_ITERS), "--weight_dir", os.path.join(root, "pipe_weight"),
            "--out_cam", out_cam, "--logfile", logfile]
    log("  python -m acr_wsss_tpu_torch.pipeline " + " ".join(argv))
    reset_counts()
    pipeline.main(argv)
    torch.cuda.synchronize()
    launches = read_counts()
    steps = len(names) // cfg.batch_size + 1
    union = sorted(set().union(*(np.flatnonzero(labels[n]).tolist() for n in val_names)))
    passes = math.ceil(len(union) / CLASS_SLOTS)
    expected = {**zero_counts(), "K2f": DEPTH * steps, "K2b": DEPTH * steps,
                "K1f": START_LAYER * passes, "K3": 1, "K4": PAMR_ITERS}
    log(f"  launches: {launches} (expected {expected}: {steps} train steps, no validation "
        f"at the default val_every; {len(val_names)} images in one inference pass of "
        f"{2 * len(val_names)} views, {passes} class-slot passes)")
    if launches != expected:
        raise AssertionError("the pipeline did not launch the kernels as expected")

    npz = os.path.join(root, "pipe_weight", "smoke_pipe_last.npz")
    flat = load_params_npz(npz)
    if not all(np.isfinite(v).all() for v in flat.values()):
        raise AssertionError(f"{npz}: non-finite weights")
    check_cams(val_names, [labels[n] for n in val_names],
               [np.load(os.path.join(out_cam, f"{n}.npy"), allow_pickle=True).item()
                for n in val_names], sizes)
    with open(logfile) as f:
        text = f.read()
    record = text.split("mIoU:[")[1].split("]")[0].split(",") if "mIoU:[" in text else []
    if "smoke_pipe" not in text or len(record) != 100:
        raise AssertionError(f"{logfile}: no 100-threshold mIoU record of the session")
    log(f"  {os.path.basename(npz)}: {len(flat)} finite arrays; {len(val_names)} CAM dicts, "
        f"finite, in [0, 1], native size; evallog: 100-threshold mIoU record, best "
        f"{max(float(v) for v in record):.3f}%")
    return launches


def crf_inputs(seed=0):
    """The production-scale inputs of tests/test_bilateral_crf.py: a
    512x512 image with three coloured discs on a noisy grey ground, and a
    21-label unary made the way ``--out_crf`` makes it (blurred disc CAMs
    plus noise, min-max normalized, the background at power 4, the absent
    classes at 1e-7)."""
    rng = np.random.default_rng(seed)
    H = W = CRF_PAD
    img = rng.integers(90, 150, (H, W, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    gt = np.zeros((H, W), np.int32)
    present = [3, 7, 12]
    for i, c in enumerate(present):
        cy, cx = rng.integers(100, 412), rng.integers(100, 412)
        r = rng.integers(60, 110)
        sel = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        img[sel] = (np.array([60 + 60 * i, 200 - 50 * i, 80 + 40 * i])
                    + rng.normal(0, 8, (int(sel.sum()), 3)))
        gt[sel] = c
    img = np.clip(img, 0, 255)

    def blur(x, sigma):
        k = np.exp(-0.5 * (np.arange(-3 * sigma, 3 * sigma + 1) / sigma) ** 2)
        k /= k.sum()
        x = np.apply_along_axis(lambda r_: np.convolve(r_, k, mode="same"), 0, x)
        return np.apply_along_axis(lambda r_: np.convolve(r_, k, mode="same"), 1, x)

    cams = []
    for c in present:
        cam = blur((gt == c).astype(np.float32), 24)
        cam += rng.uniform(0, 0.1, (H, W))
        cams.append(((cam - cam.min()) / (cam.max() - cam.min())).astype(np.float32))
    probs = np.full((CRF_LABELS, H, W), 1e-7, np.float32)
    probs[0] = np.power(1 - np.max(cams, axis=0), 4)
    for c, cam in zip(present, cams):
        probs[c + 1] = cam
    return img, probs


def crf_toy_inputs(seed=0):
    """The input of tests/test_bilateral_crf.py::
    test_crf_with_alpha_device_matches_host: a 24x20 two-region image
    (red left, blue right, noise of sd 5) and CAMs of classes 4 and 11
    split at column 10."""
    rng = np.random.default_rng(seed)
    img = np.zeros((24, 20, 3), np.float32)
    img[:, :10] = [200, 30, 30]
    img[:, 10:] = [30, 30, 200]
    img = np.clip(img + rng.normal(0, 5, size=img.shape).astype(np.float32), 0, 255)
    cam = np.zeros((24, 20), np.float32)
    cam[:, :10] = 0.95
    return img.astype(np.uint8), {4: cam, 11: 1.0 - cam}


def agreement(a, b) -> float:
    """Share of pixels where two (L, H, W) maps (or {label: (H, W)} dicts
    with the same keys) have the same argmax."""
    if isinstance(a, dict):
        a, b = (np.stack([m[k] for k in sorted(a)]) for m in (a, b))
    return float((np.asarray(a).argmax(0) == np.asarray(b).argmax(0)).mean())


def time_device_crf(img, probs, reps=10) -> float:
    """Median ms of ``reps`` calls of the device CRF on ``img``'s device
    after a warm-up, each between two CUDA events."""
    crf_ops.crf_inference_torch(img, probs, device=img.device)
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        crf_ops.crf_inference_torch(img, probs, device=img.device)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def host_ms(fn, reps=3) -> float:
    """Median host-clock ms of ``reps`` synchronized calls."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def phase_crf(device, tmp, paths, labels, infer_launches, card) -> str:
    """(a) the device CRF alone at the bench's shape against its CPU run
    and the host engine; (b) ``infer_cam`` with
    ``--out_crf --crf_device --heatmap`` on phase 4's images, then with the
    host route; (c) ``pseudo_label.main`` on the CAM dicts; (d) times.
    Returns the directory of (c)'s pseudo masks."""
    img, probs = crf_inputs()
    t0 = time.perf_counter()
    cpu = crf_ops.crf_inference_torch(img, probs, device="cpu").numpy()
    cpu_s = time.perf_counter() - t0
    img_d, probs_d = torch.from_numpy(img).to(device), torch.from_numpy(probs).to(device)
    runs = [crf_ops.crf_inference_torch(img_d, probs_d, device=device) for _ in range(2)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    native = crf_ops.crf_inference(img, probs, t=CRF_ITERS)
    native_s = time.perf_counter() - t0
    dev = runs[0].cpu().numpy()
    log(f"  (a) crf_inference_torch, {CRF_PAD}x{CRF_PAD} RGB, {CRF_LABELS} labels, "
        f"t={CRF_ITERS}, recipe 3/3 + 80/13/10 (CPU run {cpu_s:.2f} s, host engine "
        f"{native_s:.2f} s)")
    if not np.isfinite(dev).all() or np.abs(dev.sum(0) - 1).max() > 1e-4:
        raise AssertionError("device CRF: marginals not finite or not normalized")
    err = float(np.abs(dev - cpu).max())
    agree = agreement(dev, cpu)
    log(f"  card against the CPU: max abs {err:.3g} (tolerance {CRF_CPU_ATOL}), "
        f"argmax agreement {agree:.6f} (>= {CRF_CPU_AGREE})")
    if err > CRF_CPU_ATOL or agree < CRF_CPU_AGREE:
        raise AssertionError("device CRF: the card and the CPU disagree")
    agree = agreement(dev, native)
    moved = float((native.argmax(0) != probs.argmax(0)).mean())
    log(f"  card against the host's native engine: argmax agreement {agree:.6f} "
        f"(> {CRF_NATIVE_AGREE}); the native CRF moved {moved:.4f} of the pixels off the "
        f"unary's argmax")
    if agree <= CRF_NATIVE_AGREE:
        raise AssertionError("device CRF: disagrees with the native engine")
    log(f"  two runs on the card (atomic index_add_): max difference "
        f"{(runs[0] - runs[1]).abs().max().item():.3g}, "
        f"{int((runs[0] != runs[1]).sum())} of {runs[0].numel()} values differ")
    del runs

    names = [os.path.splitext(os.path.basename(p))[0] for p in paths]
    root = os.path.join(tmp, "crf_phase")
    os.makedirs(root)
    lst, labels_npy = os.path.join(root, "list.txt"), os.path.join(root, "labels.npy")
    with open(lst, "w") as f:
        f.write("\n".join(names) + "\n")
    np.save(labels_npy, dict(zip(names, labels)))
    weights = os.path.join(root, "weights.npz")
    save_params_npz(weights, state_dict_to_flax(load_model(device, "kernel")))
    out_cam, heat = os.path.join(root, "cams"), os.path.join(root, "heat")
    common = ["--weights", weights, "--LISTpath", lst, "--IMpath", tmp,
              "--cls_labels", labels_npy, "--crop_size", str(CROP), "--batch_images", "1",
              "--device", device.type]
    outs = {}
    for route, extra in (("device", ["--out_cam", out_cam, "--crf_device", "--heatmap", heat]),
                         ("host", [])):
        argv = common + ["--out_crf", os.path.join(root, f"crf_{route}"), *extra]
        log("  (b) python -m acr_wsss_tpu_torch.infer_cam " + " ".join(argv))
        reset_counts()
        t0 = time.perf_counter()
        routes = infer_cam.run(infer_cam.parse_args(argv))
        torch.cuda.synchronize()
        launches = read_counts()
        log(f"  {route} route: {time.perf_counter() - t0:.2f} s for {len(names)} images; "
            f"images per route {routes}; launches {launches}")
        if launches != infer_launches:
            raise AssertionError(f"launches {launches} != phase 4's {infer_launches}")
        if routes != {"device": 0, "host": 0, route: len(names)}:
            raise AssertionError(f"expected every image on the {route} route, got {routes}")
        outs[route] = {(alpha, n): np.load(os.path.join(root, f"crf_{route}_{alpha}",
                                                        f"{n}.npy"), allow_pickle=True).item()
                       for alpha in (1, 12) for n in names}
    cams = [np.load(os.path.join(out_cam, f"{n}.npy"), allow_pickle=True).item()
            for n in names]
    rgbs = [np.asarray(Image.open(p).convert("RGB")) for p in paths]
    for (alpha, name), dev in outs["device"].items():
        i = names.index(name)
        ref = infer_cam.crf_with_alpha_device(cams[i], alpha, rgbs[i], "cpu", pad=CRF_PAD)
        err = max(float(np.abs(dev[k] - ref[k]).max()) for k in ref)
        agree = agreement(dev, ref)
        log(f"  {name} alpha {alpha}: device route on the card against it on the CPU, max abs "
            f"{err:.3g} (tolerance {CRF_ROUTE_CPU_ATOL}), argmax agreement {agree:.6f} "
            f"(>= {CRF_CPU_AGREE})")
        if sorted(dev) != sorted(ref) or err > CRF_ROUTE_CPU_ATOL or agree < CRF_CPU_AGREE:
            raise AssertionError("the device route on the card and on the CPU disagree")
        host = outs["host"][(alpha, name)]
        size = IMAGE_SIZES[names.index(name)]
        present = [0] + [c + 1 for c in np.flatnonzero(labels[names.index(name)])]
        if sorted(dev) != sorted(host) or sorted(dev) != present:
            raise AssertionError(f"{name} alpha {alpha}: keys {sorted(dev)} / {sorted(host)}")
        if any(dev[k].shape != size or host[k].shape != size or not np.isfinite(dev[k]).all()
               for k in dev):
            raise AssertionError(f"{name} alpha {alpha}: shapes or values")
        log(f"  {name} ({size[0]}x{size[1]}) alpha {alpha}: device against host route, "
            f"argmax agreement {agreement(dev, host):.4f} on the card, "
            f"{agreement(ref, host):.4f} on the CPU")
    toy_img, toy_cams = crf_toy_inputs()
    host = infer_cam.crf_with_alpha(toy_cams, 4.0, toy_img)
    dev = infer_cam.crf_with_alpha_device(toy_cams, 4.0, toy_img, device, pad=CRF_TOY_PAD)
    agree = agreement(dev, host)
    log(f"  JAX's wiring case ({toy_img.shape[0]}x{toy_img.shape[1]}, pad {CRF_TOY_PAD}): device "
        f"route on the card against the host route, argmax agreement {agree:.4f} "
        f"(> {CRF_ROUTE_AGREE})")
    if not sorted(dev) == sorted(host) == [0, 5, 12] or agree <= CRF_ROUTE_AGREE:
        raise AssertionError("the device and host CRF routes disagree")
    n_heat = len(os.listdir(heat))
    if n_heat != int(sum(lab.sum() for lab in labels)):
        raise AssertionError(f"{n_heat} heatmaps for {sum(lab.sum() for lab in labels)} CAMs")
    log(f"  keys and shapes equal on both routes, K1f launches as in phase 4; "
        f"{n_heat} heatmap JPEGs")

    pseudo = os.path.join(root, "pseudo")
    pseudo_label.main(["--cam_dir", out_cam, "--IMpath", tmp, "--list", lst,
                       "--out_dir", pseudo])
    for name, size in zip(names, IMAGE_SIZES):
        mask = np.asarray(Image.open(os.path.join(pseudo, f"{name}.png")))
        values = set(np.unique(mask).tolist())
        if mask.shape != size or not values <= set(range(21)) | {255}:
            raise AssertionError(f"{name}: pseudo mask {mask.shape}, values {sorted(values)}")
        log(f"  (c) pseudo_label.main: {name}.png {mask.shape}, values {sorted(values)}")

    dev_ms = time_device_crf(img_d, probs_d)
    native_ms = host_ms(lambda: crf_ops.crf_inference(img, probs, t=CRF_ITERS), reps=2)
    log(f"  (d) device CRF per call at {CRF_PAD}x{CRF_PAD}, {CRF_LABELS} labels, "
        f"t={CRF_ITERS} (CUDA events, median of 10 after a warm-up): "
        f"{dev_ms:.2f} ms; host engine "
        f"{native_ms:.1f} ms per call (median of 2) [{card}]")
    stage = {
        "device": lambda: [infer_cam.crf_with_alpha_device(c, a, r, device, pad=CRF_PAD)
                           for c, r in zip(cams, rgbs) for a in (1, 12)],
        "host": lambda: [infer_cam.crf_with_alpha(c, a, r)
                         for c, r in zip(cams, rgbs) for a in (1, 12)]}
    per_image = {route: host_ms(run, reps=2) / len(names) for route, run in stage.items()}
    log(f"  --out_crf stage per image (both alphas, upload, pad, crop and download "
        f"included; host clock, median of 2 passes over the {len(names)} images): device "
        f"route {per_image['device']:.1f} ms, host route {per_image['host']:.1f} ms [{card}]")
    return pseudo


def make_seg_fixture(root: str, cfg: TrainConfig, tmp: str, pseudo_dir: str):
    """The segmentation stage's corpus: phase 4's two images with phase
    10's pseudo masks and the first SEG_TRAIN - 2 training images of phase
    5's fixture with seeded masks (0, the image's classes + 1, 255 on a few
    cells), in one directory; phase 5's validation images with seeded
    ground truth. Returns (image dir, mask dir, train list, val list, gt
    dir, the training names with seeded masks)."""
    rng = np.random.default_rng(11)
    img_dir, mask_dir, gt_dir = (os.path.join(root, d) for d in ("img", "pseudo", "gt"))
    for d in (img_dir, mask_dir, gt_dir):
        os.makedirs(d)
    smoke = sorted(os.path.splitext(n)[0] for n in os.listdir(pseudo_dir)
                   if re.fullmatch(r"smoke_\d+\.png", n))
    for name in smoke:
        shutil.copy(os.path.join(tmp, f"{name}.jpg"), img_dir)
        shutil.copy(os.path.join(pseudo_dir, f"{name}.png"), mask_dir)
    labels = voc_data.load_cls_labels(cfg.cls_labels_path)
    train_names = voc_data.read_file(cfg.train_list)[:SEG_TRAIN - len(smoke)]
    val_names = voc_data.read_file(cfg.val_list)[:SEG_VAL]
    for name, out_dir, ignore in ([(n, mask_dir, 0.05) for n in train_names]
                                  + [(n, gt_dir, 0.0) for n in val_names]):
        src = os.path.join(cfg.image_dir, f"{name}.jpg")
        shutil.copy(src, img_dir)
        w, h = Image.open(src).size
        values = np.concatenate([[0], np.flatnonzero(labels[name]) + 1])
        coarse = rng.choice(values, size=(h // 25, w // 25))
        coarse[rng.uniform(size=coarse.shape) < ignore] = 255
        Image.fromarray(coarse.astype(np.uint8)).resize((w, h), Image.NEAREST).save(
            os.path.join(out_dir, f"{name}.png"))
    lists = []
    for kind, names in (("train", smoke + train_names), ("val", val_names)):
        lists.append(os.path.join(root, f"{kind}.txt"))
        with open(lists[-1], "w") as f:
            f.write("\n".join(names) + "\n")
    return img_dir, mask_dir, lists[0], lists[1], gt_dir, train_names


def seg_step_on(model, batch, max_step):
    """(model, optimizer, step-0 parts, parameters before, after) of one
    ``train_seg`` step with a fresh optimizer (phase (a)'s lr)."""
    opt = make_optimizer(model.parameters(), SEG_LR, max_step)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    parts = {k: float(v) for k, v in train_seg.make_seg_train_step(model, opt)(batch).items()}
    after = {k: v.detach().clone() for k, v in model.named_parameters()}
    return model, opt, parts, before, after


def time_seg_step(label, model, batch, max_step, card, reps=5) -> dict:
    """One seg step on ``batch``: host-clock median of ``reps``
    synchronized steps after a warm-up (the batch uploaded in each), and
    the device time per step (CUDA events around steps on a batch already
    on the card, enqueued while the device is held busy)."""
    step = train_seg.make_seg_train_step(model, make_optimizer(model.parameters(), SEG_LR,
                                                               max_step))
    device = next(model.parameters()).device
    step(batch)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = float(np.median(times))
    on_card = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
    device_ms = time_call(lambda: step(on_card), reps)
    n = batch["image"].shape[0]
    log(f"  seg step, {label}, batch {n}, crop {batch['image'].shape[1]}: median of {reps} "
        f"after a warm-up {step_ms:.2f} ms (all: {', '.join(f'{t:.2f}' for t in times)}), "
        f"{n / step_ms * 1e3:.2f} images/s; device time per step (CUDA events) "
        f"{device_ms:.2f} ms [{card}]")
    return {"step_ms": step_ms, "device_ms": device_ms}


def phase_seg(device, cfg: TrainConfig, tmp: str, pseudo_dir: str, card) -> dict:
    """(a) ``train_seg`` as a user runs it (JAX's defaults: float32, plain
    attention; vitb_hybrid, crop 384, batch 8, SEG_EPOCHS epochs over
    SEG_TRAIN names, validation on SEG_VAL images with ground truth): no
    kernel launched, finite losses, the ``_last.npz`` read back into a
    fresh model with the same logits to the bit, mIoU in [0, 1]; (b) one
    step of the bf16 model on the kernel path (K1n and K1b with no de in
    each block) against the plain path, same weights and batch, within the
    step gates of phase 7, launches counted; (c) step times: (a)'s model,
    then the bf16 paths in turns (plain, kernel, kernel, plain). Returns
    the kernel step's launches, its no-de K1b launches and the times."""
    root = os.path.join(tmp, "seg")
    img_dir, mask_dir, train_list, val_list, gt_dir, seeded = make_seg_fixture(
        root, cfg, tmp, pseudo_dir)
    weight_dir = os.path.join(root, "weight")
    argv = ["--IMpath", img_dir, "--pseudo_dir", mask_dir, "--train_list", train_list,
            "--backbone", "vitb_hybrid", "--batch_size", str(SEG_BATCH),
            "--max_epoches", str(SEG_EPOCHS), "--lr", str(SEG_LR), "--crop_size", str(CROP),
            "--session_name", "smoke_seg", "--weight_dir", weight_dir,
            "--val_list", val_list, "--gt_dir", gt_dir]
    log("  (a) python -m acr_wsss_tpu_torch.train_seg " + " ".join(argv))
    reset_counts()
    t0 = time.perf_counter()
    run = train_seg.train(train_seg.parse_args(argv))
    torch.cuda.synchronize()
    launches = read_counts()
    max_step = SEG_TRAIN // SEG_BATCH * SEG_EPOCHS
    log(f"  {len(run.history)} steps ({max_step} updates) and validation in "
        f"{time.perf_counter() - t0:.1f} s; launches {launches}")
    if launches != zero_counts() or len(run.history) != max_step + 1:
        raise AssertionError("the float32 plain trainer launched a kernel or ran "
                             f"{len(run.history)} steps")
    for i, parts in enumerate(run.history):
        log(f"  step {i}: " + ", ".join(f"{k} {v:.6g}" for k, v in parts.items()))
        if not all(math.isfinite(v) for v in parts.values()):
            raise AssertionError(f"seg step {i}: a loss part is not finite")
    if run.miou is None or not 0.0 <= run.miou <= 1.0:
        raise AssertionError(f"seg validation mIoU {run.miou}")
    npz = os.path.join(weight_dir, "smoke_seg_last.npz")
    fresh = DPTSegmentationModel(backbone_name="vitb_hybrid")
    fresh.load_state_dict(flax_to_state_dict(load_params_npz(npz), fresh.state_dict()))
    fresh.to(device)
    x = torch.from_numpy(train_seg.load_seg_batch(img_dir, mask_dir, ["smoke_0"], CROP,
                                                  np.random.default_rng(1))["image"])
    with torch.no_grad():
        got = fresh(x.to(device), export="none")["seg_logits"]
        ref = run.model(x.to(device), export="none")["seg_logits"]
    if not torch.equal(got, ref) or not torch.isfinite(ref).all():
        raise AssertionError("the _last.npz read back gives other seg_logits")
    log(f"  mIoU {run.miou:.4f} on {SEG_VAL} images; {os.path.basename(npz)} "
        f"({os.path.getsize(npz) / 1e6:.1f} MB) read back into a fresh model: seg_logits "
        f"{tuple(ref.shape)} equal to the bit")
    del fresh

    # (b)'s batch has seeded masks only: phase 10's depend on the weights
    # phase 4 loads, which differ between checkouts (the tracked npz).
    weights = init_random_(DPTSegmentationModel(backbone_name="vitb_hybrid"), seed=1).state_dict()
    batch = train_seg.load_seg_batch(img_dir, mask_dir, seeded[:SEG_BATCH], CROP,
                                     np.random.default_rng(0))

    def seg_model(attn_impl):
        model = DPTSegmentationModel(backbone_name="vitb_hybrid", dtype=torch.bfloat16,
                                     attn_impl=attn_impl)
        model.load_state_dict(weights)
        return model.to(device)

    plain = seg_step_on(seg_model("plain"), batch, max_step)
    reset_counts()
    kernel = seg_step_on(seg_model("kernel"), batch, max_step)
    torch.cuda.synchronize()
    step_launches = read_counts()
    no_de = attention_qkv_cols_backward.launches_no_de
    depth = kernel[0].spec.depth
    log(f"  (b) one bf16 seg step, kernel path against the plain path (batch {SEG_BATCH}, "
        f"crop {CROP}); launches {step_launches}, K1b with no de {no_de}")
    if step_launches != {**zero_counts(), "K1n": depth, "K1b": depth} or no_de != depth:
        raise AssertionError(f"expected {depth} K1n and {depth} K1b (no de) launches, "
                             "no other")
    compare_steps("bf16 seg step", kernel, plain)
    rel = update_rel(kernel, plain)
    attn = {k: v for k, v in rel.items() if ".attn.qkv." in k or ".attn.proj." in k}
    worst = max(attn, key=attn.get)
    log(f"    attention blocks' qkv and proj tensors ({len(attn)}): update at most "
        f"{attn[worst]:.3g} ({worst}; tolerance {SEG_ATTN_UPDATE_REL}); the whole model's "
        f"worst {max(rel.values()):.3g} ({max(rel, key=rel.get)}) against its gate "
        f"{UPDATE_REL}")
    if attn[worst] > SEG_ATTN_UPDATE_REL:
        raise AssertionError("bf16 seg step: an attention block's update disagrees with "
                             "the plain path")
    again = seg_step_on(seg_model("plain"), batch, max_step)
    rel = update_rel(again, plain)
    log(f"  the plain step again, against its first run (the floor of the update gate): "
        f"loss {again[2]['loss']:.7g} vs {plain[2]['loss']:.7g}, worst update "
        f"{max(rel.values()):.3g} ({max(rel, key=rel.get)})")
    del again
    times = {"float32 plain": [time_seg_step(
        "float32, plain attention (train_seg's model)", run.model, batch, max_step, card)]}
    del run
    torch.cuda.empty_cache()
    models = {"bf16 plain": plain[0], "bf16 kernel": kernel[0]}
    for name in ("bf16 plain", "bf16 kernel", "bf16 kernel", "bf16 plain"):
        times.setdefault(name, []).append(time_seg_step(name, models[name], batch, max_step,
                                                        card))
    del plain, kernel, models
    return {"launches": step_launches, "no_de": no_de, "times": times}


def normalized(cams: torch.Tensor) -> np.ndarray:
    """(K, B, n) CAMs min-max normalized per slot and view, on the host."""
    return imops.minmax_normalize(cams.float().cpu().numpy(), axis=(2,))


def serve_inputs(path, device):
    """The image at ``path`` and its mirror, normalized, as one batch."""
    from acr_wsss_tpu_torch.data import transforms

    x = transforms.val_transform(transforms.load_image_rgb(path), CROP)
    return torch.as_tensor(np.stack([x, x[:, ::-1]])).to(device)


def phase_surface(device, tmp, paths, labels, card) -> None:
    """Serving and the reference import at full width (vitb_hybrid, crop
    384), on the tracked npz where the checkout has it, else seeded
    weights: (a) the serving export, called in a child process that cannot
    import the port, and its embedded-weights variant at a small width;
    (b) the reference import and the convert CLI."""
    ref_model = load_model(device, "kernel")
    weights = {k: v.detach().clone() for k, v in ref_model.state_dict().items()}
    infer_k = build_infer_fn(ref_model, CROP, START_LAYER, "grad", True, NUM_CLASSES,
                             class_slots=CLASS_SLOTS)

    log("  (a) serving: export_infer (batch 2, grad from layer 10, affinity, 4 slots) on "
        "cuda, loaded in a child process that cannot import acr_wsss_tpu_torch")
    serve_dir = os.path.join(tmp, "serve")
    os.makedirs(serve_dir)
    plain = load_model(device, "plain", state=weights)
    small = init_random_(ACR(backbone_name="vit_small", attn_impl="plain"), seed=3).to(device)
    sizes, export_s = {}, {}
    for name, model, crop, embed in (("cam", plain, CROP, False),
                                     ("cam_embedded", small, SERVE_SMALL_CROP, True)):
        t0 = time.perf_counter()
        exported = serving.export_infer(model, crop, 2, start_layer=START_LAYER,
                                        getam_func="grad", use_aff=True,
                                        num_classes=NUM_CLASSES, class_slots=CLASS_SLOTS,
                                        embed_weights=embed)
        path = os.path.join(serve_dir, f"{name}.pt2")
        serving.save_exported(path, exported)
        export_s[name] = time.perf_counter() - t0
        sizes[name] = os.path.getsize(path)
        del exported
    x = serve_inputs(paths[0], device)
    x_small = torch.randn((2, SERVE_SMALL_CROP, SERVE_SMALL_CROP, 3),
                          generator=torch.Generator(device).manual_seed(5), device=device)
    ids = torch.tensor(SERVE_IDS, device=device)
    torch.save({"x": x, "x_small": x_small, "ids": ids}, os.path.join(serve_dir, "inputs.pt"))
    torch.save(dict(plain.state_dict()), os.path.join(serve_dir, "params.pt"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", SERVE_CHILD, serve_dir], cwd=serve_dir,
                          env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError("the serving child failed:\n" + proc.stdout + proc.stderr[-4000:])
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    got = torch.load(os.path.join(serve_dir, "child_out.pt"), weights_only=True)
    live_plain = build_infer_fn(plain, CROP, START_LAYER, "grad", True, NUM_CLASSES,
                                class_slots=CLASS_SLOTS)
    live_small = build_infer_fn(small, SERVE_SMALL_CROP, START_LAYER, "grad", True,
                                NUM_CLASSES, class_slots=CLASS_SLOTS)
    refs = {"cam": {k: v.cpu() for k, v in live_plain(x, ids).items()},
            "cam_embedded": {k: v.cpu() for k, v in live_small(x_small, ids).items()}}
    for name, ref in refs.items():
        err = max(float((got[name][k] - ref[k]).abs().max()) for k in ref)
        log(f"    {name}.pt2: against the live plain path max abs {err:.3g} (tolerance "
            f"{SERVE_ATOL})")
        if err > SERVE_ATOL:
            raise AssertionError(f"{name}: the artifact disagrees with the live plain path")
    ker = {k: v.cpu() for k, v in infer_k(x, ids).items()}
    diff = np.abs(normalized(got["cam"]["cams"]) - normalized(ker["cams"]))
    log(f"    cam.pt2's CAMs against the live kernel path, normalized: max abs "
        f"{diff.max():.4g}, mean abs {diff.mean():.4g} (gates {CAM_MAX_ABS}, {CAM_MEAN_ABS})")
    if diff.max() > CAM_MAX_ABS or diff.mean() > CAM_MEAN_ABS:
        raise AssertionError("cam: the artifact disagrees with the live kernel path")
    live_ms = {}
    for label, fn in (("plain", live_plain), ("kernel", infer_k)):
        times = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(x, ids)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        live_ms[label] = float(np.median(times[1:]))
    log(f"  cam.pt2 (vitb_hybrid, crop {CROP}): export {export_s['cam']:.1f} s, "
        f"{sizes['cam']} bytes, call median of 5 in the child {child['ms']['cam']:.2f} ms; "
        f"live build_infer_fn on the same inputs, median of 5: plain {live_ms['plain']:.2f} "
        f"ms, kernel {live_ms['kernel']:.2f} ms [{card}]")
    log(f"  cam_embedded.pt2 (vit_small, crop {SERVE_SMALL_CROP}): export "
        f"{export_s['cam_embedded']:.1f} s, {sizes['cam_embedded']} bytes, call median of 5 "
        f"in the child {child['ms']['cam_embedded']:.2f} ms [{card}]")
    del plain, live_plain, small, live_small

    log("  (b) reference import: flax_params_to_torch_state_dict, torch.save, the "
        "convert CLI with and without --scan, infer_cam on the npz")
    reference = convert.flax_params_to_torch_state_dict(state_dict_to_flax(ref_model))
    ref_path = os.path.join(serve_dir, "ref.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in reference.items()}}, ref_path)
    cams_ref = process_image(infer_k, paths[0], labels[0], CROP)[0]
    for scan in (False, True):
        npz = os.path.join(serve_dir, f"converted_{int(scan)}.npz")
        convert.main([ref_path, npz, "--backbone", "vitb_hybrid"] + (["--scan"] if scan else []))
        model = infer_cam.load_model(InferConfig(weights=npz, device=str(device)))
        if not all(torch.equal(model.state_dict()[k], v) for k, v in weights.items()):
            raise AssertionError(f"{npz}: the weights do not round-trip")
        cams = process_image(build_infer_fn(model, CROP, START_LAYER, "grad", True,
                                            NUM_CLASSES, class_slots=CLASS_SLOTS),
                             paths[0], labels[0], CROP)[0]
        if sorted(cams) != sorted(cams_ref) or not all(
                np.array_equal(cams[c], cams_ref[c]) for c in cams):
            raise AssertionError(f"infer_cam on {npz}: CAMs differ from the original weights'")
        log(f"    {len(reference)} reference tensors -> {os.path.basename(npz)} "
            f"({'scanned' if scan else 'unrolled'} layout): infer_cam's CAMs the same bits")
        del model
    del ref_model, infer_k


def dp_model(cfg, weights, mesh):
    """(model, optimizer, train step) of ``cfg`` from ``weights``, on
    ``mesh`` (DDP, or FSDP2 with ``cfg.fsdp``, with the model axis's cut on
    a (data, model) mesh; None: one device)."""
    model, opt = train_mod.create_train_state(cfg, TRAIN_IMAGES // TRAIN_BATCH, init=False,
                                              mesh=mesh)
    base = unwrap(model)
    current = base.state_dict(keep_vars=True)
    base.load_state_dict({k: shard_like(v.to(current[k].device), current[k])
                          for k, v in weights.items()})
    grid = (cfg.crop_size // 16, cfg.crop_size // 16)
    return model, opt, train_mod.make_train_step(model, opt, cfg, grid, mesh)


def dp_first_step(cfg, weights, batch, mesh):
    """One step of ``dp_model`` on ``batch``: (model, optimizer, step, loss
    parts, launches)."""
    model, opt, step = dp_model(cfg, weights, mesh)
    reset_counts()
    parts = {k: float(v) for k, v in step(batch).items()}
    torch.cuda.synchronize()
    return model, opt, step, parts, read_counts()


def fp32_plain(cfg):
    """``cfg`` in float32 on the plain per-layer path (no kernel)."""
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="float32", attn_impl="plain"))


def one_device_accumulated(cfg, weights, batch, ref):
    """The one-device kernel step on ``batch`` as DP_RANKS accumulated
    micro-steps of the ranks' shares, in ``step_on``'s form: the loss
    parts are the micro-steps' mean, as the ranks report them."""
    model, opt, step = dp_model(dataclasses.replace(cfg, accum_steps=DP_RANKS), weights, None)
    per = cfg.batch_size // DP_RANKS
    micro = [{k: float(v) for k, v in step({k: v[r * per:(r + 1) * per]
                                             for k, v in batch.items()}).items()}
             for r in range(DP_RANKS)]
    parts = {k: float(np.mean([m[k] for m in micro])) for k in micro[0]}
    return model, opt, parts, ref[3], dp_params(model)


def dp_params(model) -> dict:
    """The parameters of ``model``; FSDP's gathered (a collective)."""
    return full_tensors({k: v.detach() for k, v in unwrap(model).named_parameters()})


def dp_rank(rank, world, store, tmp, cfg):
    """Part (b): one of ``world`` ranks on the one card, over gloo; each
    takes its share of the batch and runs one step of each of DP_CASES,
    and writes the loss parts, launches and parameters after of each:
    DDP's whole (rank 0), FSDP's as this rank's shards with their
    dimension. ``DTensor.full_tensor`` (a functional all-gather and its
    wait) ends the process with SIGSEGV over gloo on CUDA tensors, while
    FSDP2's own all-gather and reduce-scatter run there, so the parent
    joins the shards."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.initialize("cuda:0", init_method=f"file://{store}", rank=rank,
                           world_size=world, backend="gloo")
    weights = torch.load(os.path.join(tmp, "dp_weights.pt"), weights_only=True)
    batch = dict(np.load(os.path.join(tmp, "dp_batch.npz")))
    per = cfg.batch_size // world
    share = {k: v[rank * per:(rank + 1) * per] for k, v in batch.items()}
    out = {}
    for name, (fsdp, fp32) in DP_CASES.items():
        ccfg = dataclasses.replace(fp32_plain(cfg) if fp32 else cfg, fsdp=fsdp,
                                   device="cuda:0")
        mesh = make_data_mesh_for_batch(ccfg.batch_size, "cuda")
        model, _, _, parts, launches = dp_first_step(ccfg, weights, share, mesh)
        if fsdp:
            after = {k: (v.detach().to_local().cpu(), v.placements[0].dim)
                     for k, v in model.named_parameters()}
        else:
            after = {k: v.cpu() for k, v in dp_params(model).items()}
        out[name] = {"parts": parts, "after": after, "launches": launches}
        del model
    torch.save(out, os.path.join(tmp, f"dp_rank{rank}.pt"))
    distributed.shutdown()


def dp_joined(outs, name) -> dict:
    """Part (b)'s parameters after, FSDP's shards of the ranks joined."""
    if not DP_CASES[name][0]:
        return outs[0][name]["after"]
    return {k: torch.cat([o[name]["after"][k][0] for o in outs], dim=dim)
            for k, (_, dim) in outs[0][name]["after"].items()}


def dp_check_global(name, parts, after, ref, bf16_err) -> None:
    """Part (b)'s bf16 data-parallel step against the one-device bf16
    kernel step on the whole batch ``ref``: the loss parts within
    LOSS_RTOL, and the update of every tensor within UPDATE_REL where the
    bf16 step is within UPDATE_REL / 2 of the float32 step (``bf16_err``,
    per tensor): two bf16 steps then agree within UPDATE_REL whatever
    their roundings. The other tensors are printed beside their bf16
    error."""
    log(f"   {name} against the {TRAIN_BATCH}-image one-device kernel step:")
    got = (None, None, parts, ref[3], after)
    compare_steps_losses(name, got, ref, "the one-device kernel step")
    rel = update_rel(got, ref)
    gated = [k for k in rel if 2 * bf16_err[k] < UPDATE_REL]
    covered = sorted((k for k in rel if k not in gated), key=rel.get, reverse=True)
    worst = max(gated, key=rel.get)
    qkv = max(rel[k] for k in rel if ".attn.qkv." in k)
    stem = sum(".backbone." in k for k in covered)
    log(f"    update p1 - p0, relative L2 per tensor: {len(gated)} of {len(rel)} tensors "
        f"gated, worst {worst} {rel[worst]:.3g} (tolerance {UPDATE_REL}); attention qkv "
        f"weights at most {qkv:.3g}; not gated, the bf16 step {UPDATE_REL / 2:g} or more "
        f"from the float32 step: {len(covered)} ({stem} in the stem), worst "
        + ", ".join(f"{k} {rel[k]:.3g} (bf16 {bf16_err[k]:.3g})" for k in covered[:3]))
    if rel[worst] > UPDATE_REL:
        raise AssertionError(f"{name}: parameter updates disagree with the one-device "
                             "kernel step on the whole batch")


def dp_check(name, parts, after, launches, ref, expected,
             ref_name="the one-device kernel step") -> None:
    """A data-parallel step against a one-device step ``ref`` (as
    ``step_on`` returns it): the step gates, the largest differences,
    whether the bits are the same, the launches."""
    log(f"   {name} against {ref_name}:")
    got = (None, None, parts, ref[3], after)
    compare_steps(name, got, ref, ref_name)
    loss = max(abs(parts[k] - ref[2][k]) for k in ref[2])
    param = max(float((after[k] - ref[4][k]).abs().max()) for k in ref[4])
    log(f"    largest difference: loss parts {loss:.4g}, parameters after {param:.4g} "
        f"(abs), the same bits: {loss == param == 0}; launches (per rank in (b)) {launches}")
    if launches != expected:
        raise AssertionError(f"{name}: launches {launches}, expected {expected}")


def dp_infer_config(tmp, names, labels, pamr, out) -> InferConfig:
    """``infer_cam``'s config for phase 4's images with phase 4's weights,
    one image per pass (as phase 4 runs them: the launches then add up
    per image, whatever the worker)."""
    root = os.path.join(tmp, "dp_infer")
    if not os.path.exists(root):
        os.makedirs(root)
        np.save(os.path.join(root, "cls_labels.npy"), dict(zip(names, labels)))
        with open(os.path.join(root, "list.txt"), "w") as f:
            f.write("\n".join(names) + "\n")
        if not os.path.exists(WEIGHTS):
            model = init_random_(ACR(backbone_name="vitb_hybrid"), seed=0)
            save_params_npz(os.path.join(root, "seeded.npz"), state_dict_to_flax(model))
    weights = WEIGHTS if os.path.exists(WEIGHTS) else os.path.join(root, "seeded.npz")
    return InferConfig(weights=weights, crop_size=CROP, start_layer=START_LAYER,
                       class_slots=CLASS_SLOTS, image_dir=tmp,
                       infer_list=os.path.join(root, "list.txt"),
                       cls_labels_path=os.path.join(root, "cls_labels.npy"),
                       out_cam=os.path.join(root, out), batch_images=1,
                       pamr_iters=pamr, device="cuda")


def read_cam_dir(cfg, names):
    return [np.load(os.path.join(cfg.out_cam, f"{n}.npy"), allow_pickle=True).item()
            for n in names]


def dp_infer(tmp, names, labels) -> dict:
    """Part (c): ``--dp 2``'s workers, both on cuda:0, against one process,
    without and with ``--pamr``. Returns the workers' summed launches."""
    summed = {}
    for pamr in (0, PAMR_ITERS):
        one = dp_infer_config(tmp, names, labels, pamr, f"one_{pamr}")
        reset_counts()
        infer_cam.run(one)
        torch.cuda.synchronize()
        ref_launches = {k: v for k, v in read_counts().items() if v}
        two = dataclasses.replace(one, out_cam=one.out_cam.replace("one_", "two_"), dp=DP_RANKS)
        reports = infer_cam.run_workers(two, devices=["cuda:0"] * DP_RANKS)
        kernel_ids = {"attention_qkv_cols": "K1f", "attention_qkv_cols_noexport": "K1n",
                      "pamr_affinity": "K3", "pamr_update": "K4"}
        launches = {kernel_ids[k]: sum(r["launches"][k] for r in reports) for k in kernel_ids}
        launches = {k: v for k, v in launches.items() if v}
        refs, cams = read_cam_dir(one, names), read_cam_dir(two, names)
        same = all(sorted(a) == sorted(b) and all(np.array_equal(a[c], b[c]) for c in a)
                   for a, b in zip(refs, cams))
        log(f"  --dp {DP_RANKS}{f' --pamr {pamr}' if pamr else ''}: workers' launches "
            f"{[r['launches'] for r in reports]}, summed {launches}; one process {ref_launches}; "
            f"the same bits as one process: {same}")
        if any(sorted(a) != sorted(b) for a, b in zip(refs, cams)):
            raise AssertionError("--dp wrote other classes than one process")
        check_cams(names, labels, cams, IMAGE_SIZES)
        compare_cams(f"--dp {DP_RANKS} against one process", cams, refs)
        if launches != ref_launches:
            raise AssertionError("the workers' launches do not add up to one process's")
        summed[pamr] = launches
    return summed


def phase_parallel(device, cfg, tmp, names, labels, fused, card) -> dict:
    """(a) DDP and FSDP2 on a world-size-1 NCCL group against phase 7's
    one-device kernel step, and their step times; (b) two ranks on the one
    card over gloo, 2 + 2 images: in float32 against the one-device
    float32 step on the 4, and the bf16 kernel steps against the
    one-device kernel step accumulating the same 2 + 2 and against the one
    on the 4 (``dp_check_global``); (c) ``--dp 2``'s workers against one
    process; (d) ``--dp`` beyond the visible GPUs refused. (b) runs while
    (c) does; (a) times alone."""
    weights, batch, ref = fused
    batch = {k: np.asarray(batch[k]) for k in ("image", "label")}
    torch.save(weights, os.path.join(tmp, "dp_weights.pt"))
    np.savez(os.path.join(tmp, "dp_batch.npz"), **batch)
    depth = ref[0].spec.depth
    expected = {**zero_counts(), "K2f": depth, "K2b": depth}

    t0 = time.perf_counter()
    ranks = torch.multiprocessing.spawn(dp_rank, args=(DP_RANKS, os.path.join(tmp, "dp_store"),
                                                       tmp, cfg), nprocs=DP_RANKS, join=False)
    try:
        log(f"  (c) infer_cam --dp {DP_RANKS}, both workers on cuda:0 through the device "
            "list, phase 4's images, one image per pass:")
        infer_launches = dp_infer(tmp, names, labels)
        # (b)'s one-device references, while the ranks run
        fcfg = fp32_plain(cfg)
        model, opt, _ = dp_model(fcfg, weights, None)
        fp32 = step_on(model, opt, fcfg, batch)
        del model, opt
        acc = one_device_accumulated(cfg, weights, batch, ref)
    finally:
        while not ranks.join(timeout=300):
            pass
    outs = [torch.load(os.path.join(tmp, f"dp_rank{r}.pt"), weights_only=True)
            for r in range(DP_RANKS)]
    bf16_err = update_rel(ref, fp32)
    per = cfg.batch_size // DP_RANKS
    stem = max((v for k, v in bf16_err.items() if ".backbone." in k), default=0.0)
    rest = max(v for k, v in bf16_err.items() if ".backbone." not in k)
    log(f"  (b) {DP_RANKS} ranks on cuda:0 over gloo, {per} images each "
        f"({time.perf_counter() - t0:.1f} s with (c)); the one-device bf16 kernel step's "
        f"updates read up to {stem:.3g} in the stem and {rest:.3g} elsewhere against the "
        f"float32 step's on the same {cfg.batch_size} images (plain path, TF32 off):")
    for name, (fsdp, in_fp32) in DP_CASES.items():
        label = (f"{DP_RANKS}-rank {'FSDP' if fsdp else 'DDP'} "
                 f"{'float32' if in_fp32 else 'bf16'} step")
        parts = outs[0][name]["parts"]
        after = {k: v.to(device) for k, v in dp_joined(outs, name).items()}
        launches = [o[name]["launches"] for o in outs]
        if any(o[name]["parts"] != parts for o in outs):
            raise AssertionError(f"{label}: the ranks' averaged loss parts differ")
        if in_fp32:
            dp_check(label, parts, after, launches, fp32, [zero_counts()] * DP_RANKS,
                     f"the {cfg.batch_size}-image one-device float32 step")
            continue
        dp_check(label, parts, after, launches, acc, [expected] * DP_RANKS,
                 f"the {DP_RANKS} x {per}-image accumulated one-device kernel step")
        dp_check_global(label, parts, after, ref, bf16_err)
    del acc, fp32

    log("  (a) world size 1 over NCCL (a file:// store): DDP and FSDP2 steps against the "
        "one-device kernel step")
    distributed.initialize("cuda:0", init_method=f"file://{os.path.join(tmp, 'nccl_store')}",
                           rank=0, world_size=1)
    try:
        mesh = make_data_mesh_for_batch(cfg.batch_size, "cuda")
        arms = {"one device": dp_model(cfg, weights, None)[2]}
        for name in ("ddp", "fsdp"):
            ccfg = dataclasses.replace(cfg, fsdp=name == "fsdp")
            model, _, step, parts, launches = dp_first_step(ccfg, weights, batch, mesh)
            dp_check(f"world-size-1 {name.upper()} step", parts, dp_params(model), launches,
                     ref, expected)
            arms[name.upper()] = step
        # DDP as wrap_ddp builds it searches the graph for unused parameters
        # every step (find_unused_parameters, for trunk.norm); this arm
        # tells DDP to leave trunk.norm out instead. A parameter that no
        # step reached would fail its next step.
        model, opt, _ = dp_model(cfg, weights, None)
        DistributedDataParallel._set_params_and_buffers_to_ignore_for_model(
            model, ["trunk.norm.weight", "trunk.norm.bias"])
        model = DistributedDataParallel(model, device_ids=[0], process_group=mesh.get_group())
        step = train_mod.make_train_step(model, opt, cfg, (cfg.crop_size // 16,) * 2, mesh)
        reset_counts()
        parts = {k: float(v) for k, v in step(batch).items()}
        dp_check("world-size-1 DDP step, trunk.norm ignored", parts, dp_params(model),
                 read_counts(), ref, expected)
        arms["DDP, trunk.norm ignored"] = step
        arms["one device"](batch)
        times = {k: [] for k in arms}
        for _ in range(DP_TIMING_ROUNDS):
            for name, step in arms.items():
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                step(batch)
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t1) * 1e3)
    finally:
        distributed.shutdown()
    step_ms = {k: float(np.median(v)) for k, v in times.items()}
    log(f"  step time, median of {DP_TIMING_ROUNDS} after a warm-up, arms in turn: "
        + "; ".join(f"{k} {v:.2f} ms (all: {', '.join(f'{t:.2f}' for t in times[k])})"
                    for k, v in step_ms.items()) + f" [{card}]")

    visible = torch.cuda.device_count()
    dp = max(DP_RANKS, visible + 1)
    try:
        infer_cam.run(dataclasses.replace(dp_infer_config(tmp, names, labels, 0, "refused"),
                                          dp=dp))
    except ValueError as e:
        message = str(e)
    else:
        raise AssertionError(f"--dp {dp} with {visible} visible GPUs ran")
    log(f"  (d) --dp {dp} with {visible} visible: {message}")
    if f"--dp {dp} requested but only {visible} devices visible" not in message:
        raise AssertionError("--dp beyond the visible GPUs failed with another message")
    return {"step_ms": step_ms, "infer_launches": infer_launches}


def trained_like(model, seed: int):
    """Seeded weights in place, as a trained checkpoint's look: fan-in
    normal weights, position embeddings and Swin's relative-position bias
    tables N(0, 0.02^2) and tokens 0 (``init_random_``'s rules), but every
    bias N(0, 0.1^2) and every norm scale 1 + N(0, 0.1^2), where the seeded
    init's are 0 and 1. Drawn on the model's device from a seeded
    generator, so that the largest classifier
    (vit_huge_patch14_224_in21k, 632M parameters) is not drawn on the
    host."""
    gen = None
    with torch.no_grad():
        for name, p in model.named_parameters():
            if gen is None:
                gen = torch.Generator(device=p.device).manual_seed(seed)
            noise = torch.randn(p.shape, generator=gen, device=p.device)
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("pos_embed", "relative_position_bias_table"):
                p.copy_(0.02 * noise)
            elif leaf == "weight" and p.dim() > 1:
                p.copy_(noise / math.sqrt(p[0].numel()))
            elif leaf == "weight":
                p.copy_(1.0 + 0.1 * noise)
            elif leaf == "bias":
                p.copy_(0.1 * noise)
            else:
                p.zero_()
    return model


def swin_zoo(root: str, seed: int) -> str:
    """A zoo directory holding ``<SWIN_MODEL>_in21k.npz``: seeded weights in
    the shape of an ImageNet checkpoint (1000 classes), trained-like."""
    zoo_dir = os.path.join(root, "swin_zoo")
    os.makedirs(zoo_dir, exist_ok=True)
    donor = trained_like(registry.create_model(SWIN_MODEL, num_classes=1000, img_size=CROP),
                         seed)
    save_params_npz(zoo.npz_path(SWIN_MODEL, zoo_dir), state_dict_to_flax(donor))
    return zoo_dir


def swin_cli(cfg, root, name, *extra):
    """``train_swin.main`` as a user runs it, on phase 5's fixture; (the
    run's state, its weight directory)."""
    weight_dir = os.path.join(root, name)
    state = train_swin.main([
        "--model", SWIN_MODEL, "--crop_size", str(CROP), "--batch_size", str(TRAIN_BATCH),
        "--lr", str(cfg.lr), "--alpha", str(cfg.alpha), "--max_epoches", "1",
        "--IMpath", cfg.image_dir, "--train_list", cfg.train_list,
        "--cls_labels", cfg.cls_labels_path, "--weight_dir", weight_dir,
        "--session_name", "swin", "--save_every", str(SWIN_SAVE_EVERY), "--device", cfg.device,
        *extra])
    return state, weight_dir


def check_swin_run(label, state, weight_dir, launches) -> None:
    """Every step's loss parts finite, the consistency positive over every
    block, no kernel launched, the snapshot and ``_last.npz`` written, the
    latter read back into a fresh model bit for bit."""
    layout = train_swin.swin_block_layout(state.model, CROP)
    blocks = train_swin.consistency_blocks(layout)
    log(f"  {label}: {state.steps} steps; window consistency over {len(blocks)} of "
        f"{len(layout)} blocks (windows {sorted({ws for _, _, ws, _ in layout})}, "
        f"{sum(1 for *_, shift in layout if shift)} shifted); launches {launches}")
    if state.steps != TRAIN_IMAGES // TRAIN_BATCH + 1 or len(blocks) != len(layout):
        raise AssertionError(f"{label}: expected 5 steps and every block in the consistency")
    if launches != zero_counts():
        raise AssertionError(f"{label}: the Swin path launched a kernel")
    for step, parts in enumerate(state.history):
        log(f"    step {step}: " + ", ".join(f"{k} {v:.6g}" for k, v in parts.items()))
        if not all(math.isfinite(v) for v in parts.values()):
            raise AssertionError(f"{label} step {step}: a loss part is not finite")
        if not parts["window_consistency"] > 0:
            raise AssertionError(f"{label} step {step}: window consistency is not positive")
    paths = [os.path.join(weight_dir, f"swin_{tag}.npz") for tag in ("snapshot", "last")]
    if not all(os.path.exists(p) for p in paths):
        raise AssertionError(f"{label}: {paths} not both written")
    fresh = registry.create_model(SWIN_MODEL, num_classes=20, img_size=CROP)
    fresh.load_state_dict(flax_to_state_dict(load_params_npz(paths[1]), fresh.state_dict()))
    ref = fresh.state_dict()
    for k, v in state.model.state_dict().items():
        if not torch.equal(v.cpu(), ref[k]):
            raise AssertionError(f"{label}: {k} of the npz is not the trained tensor")
    log(f"  {label}: swin_snapshot.npz (step {SWIN_SAVE_EVERY}) and swin_last.npz "
        f"({os.path.getsize(paths[1]) / 1e6:.1f} MB) written; _last.npz read back into a "
        f"fresh model: every tensor the same bits")


def swin_step(weights, dtype, batch, cfg, device):
    """((model, optimizer, step-0 parts, parameters before, after), the
    step) of one ``train_swin`` step of a fresh model loaded with
    ``weights``."""
    model = registry.create_model(SWIN_MODEL, num_classes=20, img_size=CROP, dtype=dtype)
    model.load_state_dict(weights)
    model.to(device)
    opt = make_optimizer(model.parameters(), cfg.lr, TRAIN_IMAGES // TRAIN_BATCH,
                         cfg.weight_decay, cfg.momentum, cfg.poly_power)
    step = train_swin.make_swin_train_step(model, opt, cfg, CROP, device)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    parts = {k: float(v) for k, v in step(batch).items()}
    after = {k: v.detach().clone() for k, v in model.named_parameters()}
    return (model, opt, parts, before, after), step


def max_err_and_bad(got, ref, rtol, atol):
    err = (got.float() - ref.float()).abs()
    bad = (err > atol + rtol * ref.float().abs()) | ~torch.isfinite(got.float())
    return err.max().item(), int(bad.sum())


def tensors_of(out: dict) -> list:
    """The tensors of a model's output dict, lists and dicts flattened."""
    found = []
    for v in out.values():
        if isinstance(v, torch.Tensor):
            found.append(v)
        elif isinstance(v, (list, tuple)):
            found += [t for t in v if isinstance(t, torch.Tensor)]
        elif isinstance(v, dict):
            found += tensors_of(v)
    return found


def check_model_on_kernel(label, model, x, kernel, card=None) -> dict:
    """One bf16 model on K1f or K1n (``kernel``) against the plain path on
    the same weights: the forward with its launches counted (one per
    attention block and no other); every block's attention input kept,
    and the kernel against its plain version on it (phase 3's tolerances),
    its out through the block's projection equal to the bit to the block's
    output, and K1f's probs to the block's export; a second forward, the
    same bits in every output; then the attention switched to plain:
    ``logits`` (and a distilled model's two heads) within PIT_LOGITS_REL of
    the largest |logit|, every block's probs within PIT_PROBS_ATOL. With
    ``card``, the forward's host-clock time on either path. Returns the
    launches, the kernel's largest error on each (N, heads, head dim) and
    the block's shape."""
    export = "mean" if kernel == "K1f" else "none"
    attns = [m for m in model.modules() if isinstance(m, vit_mod.Attention)]
    kept = []
    handles = [m.register_forward_hook(lambda mod, args, out: kept.append((mod, args[0], out)))
               for m in attns]
    reset_counts()
    try:
        with torch.no_grad():
            out = model(x)
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    launches = read_counts()
    with torch.no_grad():
        again = model(x)
    res = {"launches": launches[kernel], "errs": {}}
    if card is not None:
        res["ms"] = host_forward_ms(model, x)
    set_attn_impl(model, "plain")
    try:
        with torch.no_grad():
            ref = model(x)
        if card is not None:
            res["plain_ms"] = host_forward_ms(model, x)
    finally:
        set_attn_impl(model, "kernel")
    head_dims = sorted({m.qkv.out_features // (3 * m.num_heads) for m in attns})
    log(f"  {label}: bf16, batch {x.shape[0]}, crop {x.shape[1]}, {len(attns)} attention "
        f"blocks, head dim {head_dims}, export {export}; launches {launches}")
    if launches != {**zero_counts(), kernel: len(attns)} or len(kept) != len(attns):
        raise AssertionError(f"{label}: expected {len(attns)} {kernel} launches and no other")
    if not all(torch.equal(a, b) for a, b in zip(tensors_of(out), tensors_of(again))):
        raise AssertionError(f"{label}: two forwards on the kernels differ")
    for mod, a, (h, probs) in kept:
        qkv = vit_mod.linear(a, mod.qkv)
        k_out, k_probs = attention_qkv_cols_forward(qkv, mod.scale, mod.num_heads, export)
        p_out, p_probs = attention_qkv_cols_plain(qkv, mod.scale, mod.num_heads, export)
        if not torch.equal(vit_mod.linear(k_out, mod.proj), h) or (
                export == "mean" and not torch.equal(k_probs, probs)):
            raise AssertionError(f"{label}: {kernel} on a block's input is not the path's")
        pairs = [(k_out, p_out, OUT_RTOL, OUT_ATOL)]
        if export == "mean":
            pairs.append((k_probs, p_probs, 0.0, PROBS_ATOL))
        key = (qkv.shape[1], mod.num_heads, qkv.shape[2] // (3 * mod.num_heads))
        for got, want, rtol, atol in pairs:
            err, bad = max_err_and_bad(got, want, rtol, atol)
            if bad:
                raise AssertionError(f"{label}: {kernel} at (N, H, D) = {key}: {bad} elements "
                                     f"out of tolerance, max abs err {err:.3g}")
            res["errs"][key] = max(res["errs"].get(key, 0.0), err)
    for (n, heads, d), err in res["errs"].items():
        log(f"    {kernel} on the blocks' own inputs at N={n}, H={heads}, D={d}: max abs err "
            f"{err:.3g} (out {OUT_ATOL:.3g} + {OUT_RTOL:.3g}*|ref|"
            + (f", probs {PROBS_ATOL:.3g})" if export == "mean" else ")"))
    scale = ref["logits"].abs().max().item()
    for k in [k for k in ("logits", "head_logits", "dist_logits") if k in out]:
        err, bad = max_err_and_bad(out[k], ref[k], 0.0, PIT_LOGITS_REL * scale)
        log(f"    {k} {tuple(out[k].shape)}, kernel path against plain path: max abs err "
            f"{err:.4g} (tolerance {PIT_LOGITS_REL} x max |logit| {scale:.4g})")
        if bad:
            raise AssertionError(f"{label}: {k} disagree with the plain path")
    if "probs_per_block" in out:
        errs_p = [max_err_and_bad(a, b, 0.0, PIT_PROBS_ATOL) for a, b in
                  zip(out["probs_per_block"], ref["probs_per_block"])]
        log(f"    probs per block, kernel path against plain path: max abs err "
            + ", ".join(f"{e:.3g}" for e, _ in errs_p) + f" (tolerance {PIT_PROBS_ATOL})")
        if any(bad for _, bad in errs_p):
            raise AssertionError(f"{label}: a block's probs disagree with the plain path")
    if card is not None:
        log(f"    forward (host clock, synchronized, median of 5): kernel path "
            f"{res['ms']:.2f} ms, plain path {res['plain_ms']:.2f} ms; "
            f"{x.shape[0] / res['ms'] * 1e3:.1f} images/s [{card}]")
    n = max(n for n, _, _ in res["errs"])
    res.update(n=n, heads=attns[0].num_heads, head_dim=head_dims[0])
    return res


def check_pit(name, device) -> dict:
    """(d) for one PiT on K1f (``check_model_on_kernel``), trained-like
    seeded weights, PIT_BATCH images at PIT_CROP."""
    with torch.device(device):
        model = trained_like(registry.create_model(name, num_classes=20), seed=0).eval()
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((PIT_BATCH, PIT_CROP, PIT_CROP, 3), generator=gen, device=device)
    return check_model_on_kernel(name, model, x, "K1f")


def phase_swin_pit(device, cfg, root, card) -> dict:
    """(a) ``train_swin.main --pretrained`` at swin_base_384, crop 384, on the
    host path and with ``--device_aug``, from a trained-like seeded zoo npz;
    (b) one float32 step twice (the same bits) from trained-like seeded
    weights and one bf16 step against it; (c) the bf16 step's time, device busy
    time and peak memory; (d) the pit_b and pit_b_distilled_224 forwards
    on the kernels against the plain path, pit_s refusing the kernel.
    Returns K1f's launches over (d)'s two forwards and K1f's errors on the
    blocks' inputs of pit_b by token count."""
    previous = os.environ.get("ACR_WSSS_ZOO")
    os.environ["ACR_WSSS_ZOO"] = swin_zoo(root, cfg.seed + 11)
    try:
        for label, extra in (("host path", ()), ("--device_aug", ("--device_aug",))):
            reset_counts()
            t0 = time.perf_counter()
            state, weight_dir = swin_cli(cfg, root, f"swin{len(extra)}", "--pretrained", *extra)
            torch.cuda.synchronize()
            launches = read_counts()
            log(f"  (a) train_swin.main --pretrained, {SWIN_MODEL}, {label}: "
                f"{time.perf_counter() - t0:.1f} s")
            check_swin_run(f"train_swin ({label})", state, weight_dir, launches)
            del state
    finally:
        if previous is None:
            os.environ.pop("ACR_WSSS_ZOO")
        else:
            os.environ["ACR_WSSS_ZOO"] = previous

    weights = trained_like(registry.create_model(SWIN_MODEL, num_classes=20, img_size=CROP),
                           cfg.seed + 12).state_dict()
    batch = first_batch(cfg)
    scfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, backbone=SWIN_MODEL))
    fp32 = [swin_step(weights, torch.float32, batch, scfg, device)[0] for _ in range(2)]
    for k, v in fp32[0][2].items():
        if v != fp32[1][2][k]:
            raise AssertionError(f"two float32 Swin steps differ in {k}: {v!r}, "
                                 f"{fp32[1][2][k]!r}")
    for k, v in fp32[0][4].items():
        if not torch.equal(v, fp32[1][4][k]):
            raise AssertionError(f"two float32 Swin steps differ in {k} after the update")
    log(f"  (b) one float32 step (TF32 off) twice from the same seeded weights and batch: "
        f"the same bits in {len(fp32[0][2])} loss parts and {len(fp32[0][4])} parameters "
        f"after the update; parts " + ", ".join(f"{k} {v:.7g}" for k, v in fp32[0][2].items()))
    bf16, step = swin_step(weights, torch.bfloat16, batch, scfg, device)
    log("  (b) the bf16 step against the float32 step (phase 7's loss gate):")
    compare_steps_losses("bf16 Swin step", bf16, fp32[0], "the float32 step")
    rel = update_rel(bf16, fp32[0])
    worst = sorted(rel, key=rel.get, reverse=True)[:3]
    log("    update p1 - p0 against the float32 step's, relative L2 per tensor (not gated): "
        "worst " + ", ".join(f"{k} {rel[k]:.3g}" for k in worst))
    del fp32

    model = bf16[0]
    timing = time_step(f"(c) Swin train step (bf16, {SWIN_MODEL}, batch {TRAIN_BATCH}, crop "
                       f"{CROP}, {2 * TRAIN_BATCH} images through the trunk)", step, batch,
                       TRAIN_BATCH, card, SWIN_TIMED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f"  (c) peak device memory of one step: {peak / 2**30:.2f} GiB "
        f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f}M parameters) [{card}]")
    del model, step, bf16

    pits = {name: check_pit(name, device) for name in ("pit_b", "pit_b_distilled_224")}
    try:
        registry.create_model("pit_s_224", num_classes=20, base_dims=(24, 24, 24),
                              attn_impl="kernel")
    except ValueError as e:
        message = str(e)
    else:
        raise AssertionError("a PiT at head dim 24 took the kernel")
    if "head dim" not in message:
        raise AssertionError(f"head dim 24 with the kernel failed with another error: {message}")
    log(f"  (d) a PiT at head dim 24 (pit_s_224's layout) with attn_impl='kernel': {message}")
    return {"launches": sum(r["launches"] for r in pits.values()),
            "errs": pits["pit_b"]["errs"], **timing, "peak": peak}


def set_attn_impl(model, impl: str) -> None:
    for m in model.modules():
        if isinstance(m, vit_mod.Attention):
            m.attn_impl = impl


def host_forward_ms(model, x, reps=5) -> float:
    """Median of ``reps`` synchronized forwards on the host clock, after one."""
    with torch.no_grad():
        model(x)
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(x)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def check_classifier(name, crop, depth, device, card) -> dict:
    """(a) for one ViT name: CLS_BATCH images at ``crop`` through the bf16
    model on K1n (``check_model_on_kernel``, timed), trained-like seeded
    weights."""
    kw = {} if depth is None else {"depth": depth}
    with torch.device(device):
        model = registry.create_model(name, **kw)
    trained_like(model, seed=len(name)).eval()
    gen = torch.Generator(device=device).manual_seed(crop)
    x = torch.randn((CLS_BATCH, crop, crop, 3), generator=gen, device=device)
    return check_model_on_kernel(name, model, x, "K1n", card)


def check_k1_head_dims(device) -> None:
    """(b) K1f (float32 and bf16 export) and K1n against their plain
    versions at each head dim of CLS_HEAD_DIMS, on phase 3's cases (12
    heads) and tolerances; two launches on the training shape, the same
    bits."""
    gen = torch.Generator(device=device).manual_seed(16)
    for d in CLS_HEAD_DIMS:
        scale = d ** -0.5
        for B, N in ((2, N_TOKENS), (4, N_TOKENS), (SEG_BATCH, N_TOKENS), (3, 37), (3, 17),
                     (2, 1025)):
            qkv = torch.randn((B, N, 3 * HEADS * d), generator=gen, device=device).to(
                torch.bfloat16)
            worst = {}
            for export, dtype in (("mean", torch.float32), ("none", torch.float32),
                                  ("mean", torch.bfloat16)):
                out, probs = fused_attention_qkv_cols(qkv, scale, HEADS, export, dtype)
                ref_out, ref_probs = attention_qkv_cols_plain(qkv, scale, HEADS, export, dtype)
                torch.cuda.synchronize()
                err, bad = max_err_and_bad(out, ref_out, OUT_RTOL, OUT_ATOL)
                if export == "mean":
                    rtol = BF16_PROBS_RTOL if dtype == torch.bfloat16 else 0.0
                    perr, pbad = max_err_and_bad(probs, ref_probs, rtol, PROBS_ATOL)
                    err, bad = max(err, perr), bad + pbad
                elif probs is not None:
                    raise AssertionError("export='none' returned probs")
                if bad:
                    raise AssertionError(f"K1 at head dim {d}, B={B} N={N}, export {export} "
                                         f"{dtype}: {bad} elements out of tolerance, max abs "
                                         f"err {err:.3g}")
                worst[f"{export}/{str(dtype)[6:]}"] = err
            log(f"  K1 at head dim {d}, B={B} N={N}: max abs err " + ", ".join(
                f"{k} {v:.3g}" for k, v in worst.items()))
        qkv = torch.randn((2 * TRAIN_BATCH, N_TOKENS, 3 * HEADS * d), generator=gen,
                          device=device).to(torch.bfloat16)
        for export, dtype in (("mean", torch.float32), ("mean", torch.bfloat16),
                              ("none", torch.float32)):
            first = attention_qkv_cols_forward(qkv, scale, HEADS, export, dtype)
            second = attention_qkv_cols_forward(qkv, scale, HEADS, export, dtype)
            torch.cuda.synchronize()
            if not all((a is None and b is None) or torch.equal(a, b)
                       for a, b in zip(first, second)):
                raise AssertionError(f"K1 at head dim {d}, export {export}: two launches on "
                                     "the same inputs differ")
        log(f"  K1 at head dim {d}, B={2 * TRAIN_BATCH} N={N_TOKENS}: two launches equal to "
            "the bit for each export")


def check_resnetv2(device, root, card) -> None:
    """(d) resnetv2_50 and resnetv2_50x1_bitm at 224 (bf16, batch
    CLS_BATCH): finite logits; the float32 forward on the card against the
    same on the CPU (2 images); ``create_model("resnetv2_50",
    features_only=True)``: four NCHW maps whose strides and channels are
    its ``feature_info``."""
    gen = torch.Generator(device=device).manual_seed(50)
    x = torch.randn((CLS_BATCH, PIT_CROP, PIT_CROP, 3), generator=gen, device=device)
    for name in ("resnetv2_50", "resnetv2_50x1_bitm"):
        with torch.device(device):
            model = trained_like(registry.create_model(name), seed=7).eval()
        with torch.no_grad():
            logits = model(x)["logits"]
        ms = host_forward_ms(model, x)
        if not torch.isfinite(logits).all() or tuple(logits.shape) != (CLS_BATCH, 1000):
            raise AssertionError(f"{name}: logits {tuple(logits.shape)} not finite")
        model32 = registry.create_model(name, dtype=torch.float32)
        model32.load_state_dict(model.state_dict())
        with torch.no_grad():
            cpu = model32(x[:2].cpu())["logits"]
            card32 = model32.to(device)(x[:2])["logits"].cpu()
        err = (card32 - cpu).abs().max().item()
        scale = cpu.abs().max().item()
        log(f"  {name}: bf16 logits {tuple(logits.shape)} finite; forward {ms:.2f} ms (host "
            f"clock, median of 5) [{card}]; float32 on the card against the CPU: max abs err "
            f"{err:.3g} of max |logit| {scale:.3g} (tolerance {CNN_REL} x)")
        if err > CNN_REL * scale:
            raise AssertionError(f"{name}: the card's float32 forward disagrees with the CPU's")
        del model, model32
    with torch.device(device):
        fx = registry.create_model("resnetv2_50", features_only=True)
    trained_like(fx, seed=8).eval()
    with torch.no_grad():
        feats = fx(x)
    info = fx.feature_info(PIT_CROP)
    shapes = [tuple(f.shape) for f in feats]
    want = [(CLS_BATCH, i["num_chs"], PIT_CROP // i["reduction"], PIT_CROP // i["reduction"])
            for i in info]
    log(f"  create_model('resnetv2_50', features_only=True): maps {shapes}, feature_info "
        f"{info}")
    if shapes != want or [i["reduction"] for i in info] != [4, 8, 16, 32] or not all(
            torch.isfinite(f).all() for f in feats):
        raise AssertionError("resnetv2_50 features_only: maps disagree with feature_info")


def timm_vit_state_dict(flat: dict) -> dict:
    """The flat flax dict of a ``ViTClassifier`` in timm's layout (bare
    trunk names, ``head``, ``head_dist``, ``pre_logits.fc``): the inverse
    of ``convert.vit_timm_state_dict_to_flax``."""
    heads = {"head": "head", "head_dist": "head_dist", "pre_logits": "pre_logits.fc"}
    out = {}
    for path, value in flat.items():
        path = path[len("params/"):]
        module, _, leaf = path.rpartition("/")
        if module in heads:
            value = value.T if leaf == "kernel" else value
            out[f"{heads[module]}.{'weight' if leaf == 'kernel' else leaf}"] = value
            continue
        name, inverse = convert._reference_name(path)
        out[name[len("pretrained.model."):]] = inverse(value)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


def check_checkpoint_path(device, root) -> None:
    """(e) ``create_model(name, checkpoint_path=<timm .pth>)`` against the
    same weights put in by ``flax_to_state_dict``: the same logits to the
    bit (vit_base_r50_s16_384, crop 384, 2 images)."""
    name = "vit_base_r50_s16_384"
    model = trained_like(registry.create_model(name), seed=9)
    flat = state_dict_to_flax(model)
    path = os.path.join(root, "timm_vit.pth")
    torch.save({"model": timm_vit_state_dict(flat)}, path)
    loaded = registry.create_model(name, checkpoint_path=path).to(device).eval()
    ref = registry.create_model(name)
    ref.load_state_dict(flax_to_state_dict(flat, ref.state_dict()))
    ref.to(device).eval()
    x = torch.randn((2, CROP, CROP, 3), generator=torch.Generator(device=device).manual_seed(3),
                    device=device)
    with torch.no_grad():
        got, want = loaded(x)["logits"], ref(x)["logits"]
    log(f"  create_model('{name}', checkpoint_path=<timm .pth, "
        f"{os.path.getsize(path) / 1e6:.1f} MB>): logits {tuple(got.shape)} "
        f"{'equal to the bit' if torch.equal(got, want) else 'DIFFER'} to flax_to_state_dict's")
    if not torch.equal(got, want):
        raise AssertionError("checkpoint_path loaded other weights than flax_to_state_dict")


def time_k1_head_dims(device, card) -> dict:
    """K1n at the ViT classifiers' shapes (B=CLS_BATCH): vit_small_patch16_224
    (N=197, H=8, D=96) and vit_huge_patch14_224_in21k (N=257, H=16, D=80);
    K1f at pit_s_224's and pit_ti_224's first stage (B=PIT_BATCH, N=730,
    H=3, D=48 and H=2, D=32) and, on no model's path, at the two
    classifier shapes."""
    gen = torch.Generator(device=device).manual_seed(17)
    out = {}
    for key, B, N, H, D, export in (("K1n_D96", CLS_BATCH, 197, 8, 96, "none"),
                                    ("K1n_D80", CLS_BATCH, 257, 16, 80, "none"),
                                    ("K1f_D48", PIT_BATCH, 730, 3, 48, "mean"),
                                    ("K1f_D32", PIT_BATCH, 730, 2, 32, "mean"),
                                    ("K1f_D96", CLS_BATCH, 197, 8, 96, "mean"),
                                    ("K1f_D80", CLS_BATCH, 257, 16, 80, "mean")):
        qkv = torch.randn((B, N, 3 * H * D), generator=gen, device=device).to(torch.bfloat16)
        q, k, v = (t.contiguous() for t in qkv.reshape(B, N, 3, H, D).permute(2, 0, 3, 1, 4))
        nbytes = qkv.numel() * 2 + B * N * H * D * 2 + (B * N * N * 4 if export == "mean" else 0)
        scale = D ** -0.5
        out[key] = time_kernel(
            f"{KERNEL} ({key[:3]}) at B={B} N={N} H={H} D={D}, export {export}",
            lambda: attention_qkv_cols_forward(qkv, scale, H, export),
            lambda: attention_qkv_cols_plain(qkv, scale, H, export),
            lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), nbytes,
            4 * B * H * N * N * D, 20, card,
            "SDPA (the same function)" if export == "none" else "SDPA (output only)")
    return out


def phase_classifiers(device, root, card) -> dict:
    """(a) the ViT and DeiT classifiers of CLS_CASES on K1n against the plain
    path; (b) K1f and K1n at the head dims CLS_HEAD_DIMS against their plain
    versions; (c) pit_s_224, pit_xs_224 and pit_ti_224 (head dims 48, 48,
    32) on K1f; (d) resnetv2_50, resnetv2_50x1_bitm and ``features_only``;
    (e) ``checkpoint_path`` on a timm .pth; then the kernels' times at the
    new head dims. Returns the runs of (a) and (c) by name (launches, the
    kernel's errors on the blocks' own inputs, times) and the kernels'
    times."""
    res = {"cls": {}, "pit": {}}
    for name, crop, depth in CLS_CASES:
        res["cls"][name] = check_classifier(name, crop, depth, device, card)
        torch.cuda.empty_cache()
    log("  (b) K1f and K1n at head dims " + ", ".join(map(str, CLS_HEAD_DIMS)))
    check_k1_head_dims(device)
    log("  (c) the PiT names at head dims 48 and 32 on K1f, against the plain path")
    for name in ("pit_s_224", "pit_xs_224", "pit_ti_224"):
        res["pit"][name] = check_pit(name, device)
    log("  (d) the ResNetV2 and BiT classifiers and features_only (cuDNN, no kernel)")
    check_resnetv2(device, root, card)
    log("  (e) checkpoint_path")
    check_checkpoint_path(device, root)
    res["timing"] = time_k1_head_dims(device, card)
    return res


def check_bwd_head_dims(device) -> dict:
    """(a) K1b (float32, bf16 and no de) and the K5a-c backwards (float32
    de) at each head dim of BWD_HEAD_DIMS against their plain versions:
    phase 3's (B, N) cases at 12 heads and (8, 197) at 8; two launches at
    the training shape, the same bits. Returns the largest error by
    (kernel, head dim, de)."""
    gen = torch.Generator(device=device).manual_seed(19)
    errs = {}
    cases = ((2 * TRAIN_BATCH, N_TOKENS, HEADS), (2, 37, HEADS), (2, 17, HEADS),
             (2, 1025, HEADS), (FT_BATCH, 197, 8))
    for d in BWD_HEAD_DIMS:
        scale = d ** -0.5
        for B, N, H in cases:
            qkv = torch.randn((B, N, 3 * H * d), generator=gen, device=device).to(torch.bfloat16)
            g = torch.randn((B, N, H * d), generator=gen, device=device).to(torch.bfloat16)
            de32 = torch.randn((B, N, N), generator=gen, device=device)
            worst = {}
            for de in (de32, de32.to(torch.bfloat16), None):
                kind = "none" if de is None else str(de.dtype)[6:]
                got = attention_qkv_cols_backward(qkv, g, de, scale, H)
                ref = attention_qkv_cols_backward_plain(qkv, g, de, scale, H)
                torch.cuda.synchronize()
                err, bad = max_err_and_bad(got, ref, GRAD_RTOL,
                                           GRAD_ATOL_FRAC * ref.float().abs().max().item())
                if bad:
                    raise AssertionError(f"K1b at head dim {d}, B={B} N={N} H={H}, de {kind}: "
                                         f"{bad} elements out of tolerance, max abs err {err:.3g}")
                worst[kind] = err
                errs[("K1b", d, kind)] = max(errs.get(("K1b", d, kind), 0.0), err)
                if (B, N) == (2 * TRAIN_BATCH, N_TOKENS):
                    if not torch.equal(got, attention_qkv_cols_backward(qkv, g, de, scale, H)):
                        raise AssertionError(f"K1b at head dim {d}, de {kind}: two launches on "
                                             "the same inputs differ")
            for entry, layout in ENTRY_LAYOUTS.items():
                xs = (list(qkv.unflatten(-1, (3, H, d)).permute(2, 0, 3, 1, 4))
                      if entry == "K5a" else [t.contiguous() for t in qkv.chunk(3, dim=-1)]
                      if entry == "K5b" else [qkv])
                g_out = g.unflatten(-1, (H, d)).transpose(1, 2).contiguous() \
                    if entry == "K5a" else g
                heads = None if entry == "K5a" else H
                grads = attn_backward(layout, xs, g_out, de32, scale, heads, ENTRIES[entry])
                refs = backward_plain(layout, xs, g_out, de32, scale, heads)
                torch.cuda.synchronize()
                for got, ref in zip(grads, refs):
                    err, bad = max_err_and_bad(got, ref, GRAD_RTOL,
                                               GRAD_ATOL_FRAC * ref.float().abs().max().item())
                    if bad:
                        raise AssertionError(f"{entry} backward at head dim {d}, B={B} N={N}: "
                                             f"{bad} elements out of tolerance, max abs err "
                                             f"{err:.3g}")
                    worst[entry] = max(worst.get(entry, 0.0), err)
                    errs[(entry, d, "float32")] = max(errs.get((entry, d, "float32"), 0.0), err)
            log(f"  backward at head dim {d}, B={B} N={N} H={H}: max abs err " + ", ".join(
                f"{k} {v:.3g}" for k, v in worst.items()))
        log(f"  K1b at head dim {d}, B={2 * TRAIN_BATCH} N={N_TOKENS}: two launches equal to the "
            "bit for each de")
    return errs


def finetune_step(model, x, labels):
    """One SGD step (lr FT_LR) of ``model`` in training mode on softmax cross
    entropy: (model, None, {"loss": ...}, state before, state after), the
    layout of ``compare_steps``."""
    opt = torch.optim.SGD(model.parameters(), lr=FT_LR)
    p0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    model.train()
    loss = F.cross_entropy(model(x)["logits"].float(), labels)
    loss.backward()
    opt.step()
    torch.cuda.synchronize()
    return (model, None, {"loss": loss.item()}, p0,
            {k: v.detach().clone() for k, v in model.state_dict().items()})


@contextlib.contextmanager
def keep_k1_backward_io(kept: list):
    """While open, every K1 call of the model's attention blocks appends a
    dict to ``kept``: its qkv, scale and heads, and, once the backward has
    run, the gradient that reached its out (``g``) and the one that left
    for its qkv (``dqkv``), the backward kernel's own input and output."""
    kernel = vit_mod.fused_attention_qkv_cols

    def keeping(qkv, scale, num_heads, export="mean", probs_dtype=torch.float32):
        out, probs = kernel(qkv, scale, num_heads, export, probs_dtype)
        rec = {"qkv": qkv.detach(), "scale": scale, "heads": num_heads}
        out.register_hook(lambda g: rec.__setitem__("g", g.detach()))
        qkv.register_hook(lambda d: rec.__setitem__("dqkv", d.detach()))
        kept.append(rec)
        return out, probs

    vit_mod.fused_attention_qkv_cols = keeping
    try:
        yield
    finally:
        vit_mod.fused_attention_qkv_cols = kernel


def check_blocks_backward(label, kept) -> dict:
    """K1b (no de) on the (qkv, g) that each attention block of a step gave
    its backward: the kernel's dqkv equal to the bit to the gradient the
    step sent to the block's qkv, and held to its plain version with phase
    3's gradient tolerances. Returns the largest error by (N, heads, head
    dim)."""
    errs = {}
    for rec in kept:
        qkv, g, heads = rec["qkv"], rec["g"], rec["heads"]
        got = attention_qkv_cols_backward(qkv, g, None, rec["scale"], heads)
        ref = attention_qkv_cols_backward_plain(qkv, g, None, rec["scale"], heads)
        torch.cuda.synchronize()
        key = (qkv.shape[1], heads, qkv.shape[2] // (3 * heads))
        if not torch.equal(got, rec["dqkv"]):
            raise AssertionError(f"{label}: K1b on a block's (qkv, g) at (N, H, D) = {key} is "
                                 "not the gradient the step gave its qkv")
        err, bad = max_err_and_bad(got, ref, GRAD_RTOL,
                                   GRAD_ATOL_FRAC * ref.float().abs().max().item())
        if bad:
            raise AssertionError(f"{label}: K1b at (N, H, D) = {key}: {bad} elements out of "
                                 f"tolerance, max abs err {err:.3g}")
        errs[key] = max(errs.get(key, 0.0), err)
    for (n, heads, d), err in errs.items():
        log(f"    K1b (no de) on the step's own (qkv, g) at N={n}, H={heads}, D={d}: max abs "
            f"err {err:.3g} ({GRAD_RTOL:.3g}*|ref| + {GRAD_ATOL_FRAC:.3g}*max |ref|); equal to "
            "the bit to the step's gradient")
    return errs


def check_finetune(name, kernel, blocks, device, card) -> dict:
    """(b) one name of FT_CASES: trained-like bf16 weights, FT_BATCH images at
    FT_CROP; its blocks on the kernel (``check_model_on_kernel``); one SGD
    step on the kernel path, ``blocks`` forward and ``blocks`` K1b launches
    with no de and no other, against the same step on the plain path from
    the same weights, and K1b held to its plain version on every block's
    own backward input (``check_blocks_backward``); each path's step
    time."""
    with torch.device(device):
        model = trained_like(registry.create_model(name), seed=len(name)).eval()
        plain = registry.create_model(name, attn_impl="plain")
    plain.load_state_dict(model.state_dict())
    gen = torch.Generator(device=device).manual_seed(FT_CROP)
    x = torch.randn((FT_BATCH, FT_CROP, FT_CROP, 3), generator=gen, device=device)
    labels = torch.randint(0, model.head.out_features, (FT_BATCH,), generator=gen, device=device)
    res = check_model_on_kernel(name, model, x, kernel)
    kept = []
    with keep_k1_backward_io(kept):
        reset_counts()
        got = finetune_step(model, x, labels)
        launches = read_counts()
    no_de = attention_qkv_cols_backward.launches_no_de
    ref = finetune_step(plain, x, labels)
    log(f"  {name}: one bf16 SGD step (lr {FT_LR}, batch {FT_BATCH}, crop {FT_CROP}) on the "
        f"kernels, launches {launches} ({no_de} K1b with no de), against the plain path:")
    if launches != {**zero_counts(), kernel: blocks, "K1b": blocks} or no_de != blocks:
        raise AssertionError(f"{name}: expected {blocks} {kernel} and {blocks} K1b (no de) "
                             "launches and no other")
    compare_steps(f"{name} fine-tune step", got, ref)
    if len(kept) != blocks:
        raise AssertionError(f"{name}: {len(kept)} attention blocks kept, expected {blocks}")
    res["bwd_errs"] = check_blocks_backward(name, kept)
    res["step_launches"] = launches["K1b"]
    for label, m in (("kernel path", model), ("plain path", plain)):
        opt = torch.optim.SGD(m.parameters(), lr=FT_LR)

        def step(batch, m=m, opt=opt):
            opt.zero_grad(set_to_none=True)
            F.cross_entropy(m(batch[0])["logits"].float(), batch[1]).backward()
            opt.step()

        res[label] = time_step(f"{name} fine-tune step, {label} (bf16, batch {FT_BATCH}, "
                               f"crop {FT_CROP})", step, (x, labels), FT_BATCH, card, reps=5)
    del model, plain
    torch.cuda.empty_cache()
    return res


def cnn_step(model, x, labels):
    """One float32 train-mode SGD step (lr 0.1): (logits, state before,
    state after), running statistics included."""
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    p0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    model.train()
    logits = model(x)["logits"]
    F.cross_entropy(logits, labels).backward()
    opt.step()
    return logits.detach().cpu(), p0, {k: v.detach().clone() for k, v in
                                       model.state_dict().items()}


def update_rels(p0, p1, ref_p1) -> dict:
    """Per tensor that moved in ``ref_p1``: the relative L2 distance of the
    update p1 - p0 from ref_p1 - p0; under "(all parameters)" that of the
    whole parameter update (the statistics left out) as one vector."""
    rel, num, den = {}, 0.0, 0.0
    for k, v in ref_p1.items():
        ref_u = v.double().cpu() - p0[k].double().cpu()
        diff = p1[k].double().cpu() - p0[k].double().cpu() - ref_u
        if ref_u.norm() > 0:
            rel[k] = float(diff.norm() / ref_u.norm())
            if not k.endswith((".mean", ".var")):
                num, den = num + float(diff.norm()) ** 2, den + float(ref_u.norm()) ** 2
    rel["(all parameters)"] = math.sqrt(num / den)
    return rel


def check_cnn_steps(device, names=CNN_STEP_NAMES) -> None:
    """(d) ``names``: the step on the card (float32, TF32 off) against
    the port's step on the CPU (all threads, oneDNN) from the same
    trained-like weights. Logits within CNN_REL of the largest |logit|;
    each running statistic's update within CNN_REL (relative L2); the
    statistics must move. The parameter updates are held to the CPU's own
    spread: the CPU step again on one thread and with oneDNN off, each
    against the reference; the card's whole update and its worst tensor
    within CNN_SPREAD times the larger of those two readings, and never
    above phase 7's UPDATE_REL. A name's CNN_ZERO_GRAD tensors, whose
    gradient is 0 in exact arithmetic, are printed and left out of the
    worst tensor (their update is rounding noise on every side) and held,
    on the card and on the CPU alike, within CNN_REL of the largest
    element of the CPU's update."""
    gen = torch.Generator().manual_seed(26)
    x = torch.randn((CNN_STEP_BATCH, CNN_STEP_CROP, CNN_STEP_CROP, 3), generator=gen)
    labels = torch.randint(0, 1000, (CNN_STEP_BATCH,), generator=gen)
    threads = torch.get_num_threads()
    for name in names:
        zero = CNN_ZERO_GRAD.get(name)
        weights = trained_like(registry.create_model(name, dtype=torch.float32),
                               seed=26).state_dict()
        cpu = []
        for n_threads, onednn in ((threads, True), (1, True), (threads, False)):
            torch.set_num_threads(n_threads)
            cpu_model = registry.create_model(name, dtype=torch.float32)
            cpu_model.load_state_dict(weights)
            with torch.backends.mkldnn.flags(enabled=onednn):
                cpu.append(cnn_step(cpu_model, x, labels))
        torch.set_num_threads(threads)
        ref_logits, p0, ref_p1 = cpu[0]
        with torch.device(device):
            card_model = registry.create_model(name, dtype=torch.float32)
        card_model.load_state_dict(weights)
        logits, _, p1 = cnn_step(card_model, x.to(device), labels.to(device))
        torch.cuda.synchronize()
        rel = update_rels(p0, p1, ref_p1)
        stats = [k for k in rel if k.endswith((".mean", ".var"))]
        noise = [k for k in p0 if zero and re.search(zero, k)]
        params = [k for k in rel if k not in stats + noise and k != "(all parameters)"]
        whole, worst = "(all parameters)", max(params, key=rel.get)
        worst_stat = max(stats, key=rel.get) if stats else None
        spread = {whole: 0.0, "tensor": 0.0}
        log(f"  {name}: one float32 train-mode step (batch {CNN_STEP_BATCH}, crop "
            f"{CNN_STEP_CROP}), against the CPU's ({threads} threads, oneDNN); the update as "
            "relative L2 of all parameters and of the worst tensor")
        for label, (other_logits, _, other_p1) in zip(("CPU, 1 thread", "CPU, oneDNN off"),
                                                      cpu[1:]):
            other = update_rels(p0, other_p1, ref_p1)
            other_worst = max(params, key=other.get)
            spread = {whole: max(spread[whole], other[whole]),
                      "tensor": max(spread["tensor"], other[other_worst])}
            log(f"    {label}: logits max abs err "
                f"{(other_logits - ref_logits).abs().max().item():.3g}; update {other[whole]:.3g}, "
                f"{other_worst} {other[other_worst]:.3g}")
        err = (logits - ref_logits).abs().max().item()
        limit = {k: min(UPDATE_REL, CNN_SPREAD * v) for k, v in spread.items()}
        log(f"    card: logits max abs err {err:.3g} of max |logit| {ref_logits.abs().max():.3g} "
            f"(tolerance {CNN_REL} x); {len(stats)} running statistics, worst update "
            f"{worst_stat} {rel[worst_stat]:.3g} (tolerance {CNN_REL}); update {rel[whole]:.3g} "
            f"(tolerance {limit[whole]:.3g}), {worst} {rel[worst]:.3g} (tolerance "
            f"{limit['tensor']:.3g}): {CNN_SPREAD} x the CPU's, at most {UPDATE_REL}")
        if noise:
            largest = max((ref_p1[k] - p0[k]).abs().max().item() for k in params)
            tiny = {side: max((after[k].cpu() - p0[k]).abs().max().item() for k in noise)
                    for side, after in (("CPU", ref_p1), ("card", p1))}
            log(f"    {len(noise)} tensors with a gradient of 0 in exact arithmetic ({zero}) "
                f"left out of the worst tensor: their update at most {tiny['CPU']:.3g} on the "
                f"CPU and {tiny['card']:.3g} on the card, the largest update {largest:.3g} "
                f"(tolerance {CNN_REL} x)")
            if max(tiny.values()) > CNN_REL * largest:
                raise AssertionError(f"{name}: a tensor of {zero} moved")
        if (not stats or err > CNN_REL * ref_logits.abs().max().item()
                or rel[worst_stat] > CNN_REL or rel[whole] > limit[whole]
                or rel[worst] > limit["tensor"]):
            raise AssertionError(f"{name}: the card's train-mode step disagrees with the CPU's "
                                 "or its running statistics did not move")
        del card_model, cpu, weights


def time_cnn_forwards(device, card) -> dict:
    """(e) bf16 eval forwards of CNN_TIMED at batch CLS_BATCH, crop PIT_CROP:
    host clock, median of 5 after one."""
    gen = torch.Generator(device=device).manual_seed(27)
    x = torch.randn((CLS_BATCH, PIT_CROP, PIT_CROP, 3), generator=gen, device=device)
    out = {}
    for name in CNN_TIMED:
        with torch.device(device):
            model = trained_like(registry.create_model(name), seed=27).eval()
        with torch.no_grad():
            logits = model(x)["logits"]
        if not torch.isfinite(logits).all():
            raise AssertionError(f"{name}: bf16 logits not finite")
        out[name] = host_forward_ms(model, x)
        log(f"  {name}: bf16 forward, batch {CLS_BATCH}, crop {PIT_CROP}: {out[name]:.2f} ms "
            f"(host clock, median of 5), {CLS_BATCH / out[name] * 1e3:.1f} images/s [{card}]")
        del model
    return out


def time_bwd_head_dims(device, card) -> dict:
    """K1b at the fine-tune steps' shapes: no de at vit_small_resnet50d_s16_224's
    (B=FT_BATCH, N=197, H=8, D=96) and pit_s_224's first stage (N=730, H=3,
    D=48); at D = 96 also with a float32 and a bf16 de, and the K5a-c
    backwards with a float32 de. The library row: SDPA forward+backward."""
    gen = torch.Generator(device=device).manual_seed(28)
    out = {}
    for key, N, H, D, entries in (("D96", 197, 8, 96, True), ("D48", 730, 3, 48, False)):
        B, scale = FT_BATCH, D ** -0.5
        qkv = torch.randn((B, N, 3 * H * D), generator=gen, device=device).to(torch.bfloat16)
        g = torch.randn((B, N, H * D), generator=gen, device=device).to(torch.bfloat16)
        de = torch.randn((B, N, N), generator=gen, device=device)
        q, k, v = (t.detach().contiguous().requires_grad_(True)
                   for t in qkv.reshape(B, N, 3, H, D).permute(2, 0, 3, 1, 4))
        g_heads = g.reshape(B, N, H, D).transpose(1, 2).contiguous()

        def sdpa_fwd_bwd():
            F.scaled_dot_product_attention(q, k, v, scale=scale).backward(g_heads)

        io, flops = 2 * qkv.numel() * 2 + g.numel() * 2, 10 * B * H * N * N * D
        dense = [("none", None, 0)] + ([("float32", de, 4), ("bf16", de.to(torch.bfloat16), 2)]
                                       if entries else [])
        for kind, de_t, size in dense:
            out[f"K1b_{key}_{kind}"] = time_kernel(
                f"{BWD_KERNEL} (K1b, de {kind}) at B={B} N={N} H={H} D={D}",
                lambda de_t=de_t: attention_qkv_cols_backward(qkv, g, de_t, scale, H),
                lambda de_t=de_t: attention_qkv_cols_backward_plain(qkv, g, de_t, scale, H),
                sdpa_fwd_bwd, io + B * N * N * size, flops, 20, card,
                "SDPA forward+backward (no de)")
        if entries:
            for entry, layout in ENTRY_LAYOUTS.items():
                xs = ([q.detach(), k.detach(), v.detach()] if entry == "K5a" else
                      [t.contiguous() for t in qkv.chunk(3, dim=-1)] if entry == "K5b"
                      else [qkv])
                g_out = g_heads if entry == "K5a" else g
                heads = None if entry == "K5a" else H
                out[f"{entry}b_{key}"] = time_kernel(
                    f"{BWD_KERNEL} ({entry}, {layout} layout, de float32) at B={B} N={N} H={H} "
                    f"D={D}",
                    lambda xs=xs, g_out=g_out, heads=heads, layout=layout, entry=entry:
                        attn_backward(layout, xs, g_out, de, scale, heads, ENTRIES[entry]),
                    lambda xs=xs, g_out=g_out, heads=heads, layout=layout:
                        backward_plain(layout, xs, g_out, de, scale, heads),
                    sdpa_fwd_bwd, io + B * N * N * 4, flops, 20, card,
                    "SDPA forward+backward (no de)")
    return out


def phase_finetune(device, card) -> dict:
    """(a) the backward kernels at head dims 16-128 against their plain
    versions; (b) a fine-tuning step on the kernels of each FT_CASES name
    against the plain path; (c) the four ViT names on a ResNet-D stem on
    K1n against the plain path; (d) resnet50's and ecaresnet26t's
    train-mode step on the card against the CPU's; (e) bf16 CNN forwards;
    then K1b's and the K5 backwards' times at the fine-tune shapes.
    Returns (a)'s errors, the runs of (b) and (c) by name and the times."""
    res = {"errs": check_bwd_head_dims(device), "ft": {}, "hybrids": {}}
    log("  (b) one fine-tuning step on the kernels against the plain path")
    for name, kernel, blocks in FT_CASES:
        res["ft"][name] = check_finetune(name, kernel, blocks, device, card)
    log("  (c) the ViT names on a ResNet-D stem (models/resnet_timm.py) on K1n")
    gen = torch.Generator(device=device).manual_seed(29)
    x = torch.randn((CLS_BATCH, PIT_CROP, PIT_CROP, 3), generator=gen, device=device)
    for name in HYBRIDS:
        with torch.device(device):
            model = trained_like(registry.create_model(name), seed=len(name)).eval()
        res["hybrids"][name] = check_model_on_kernel(name, model, x, "K1n", card)
        del model
    torch.cuda.empty_cache()
    log("  (d) the CNNs' train-mode step, card against CPU (float32, TF32 off)")
    check_cnn_steps(device)
    log("  (e) CNN forwards (cuDNN, no kernel)")
    res["cnn_ms"] = time_cnn_forwards(device, card)
    res["timing"] = time_bwd_head_dims(device, card)
    return res


def swin_dp_config(cfg):
    """Phase 15's Swin configuration (SWIN_MODEL at crop 384, the recipe's
    batch, lr and alpha) in float32 on the first card."""
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone=SWIN_MODEL, compute_dtype="float32"), device="cuda:0")


def swin_dp_step(cfg, batch, mesh, micro=(slice(None),)):
    """One ``train_swin`` step as ``main`` builds it (``--pretrained`` from
    the zoo npz of ``ACR_WSSS_ZOO``), on ``mesh`` (None: one device), over
    the ``micro`` rows of ``batch`` (micro-steps that ``cfg.accum_steps``
    accumulates; the loss parts their mean): (None, None, loss parts,
    parameters before, after), launches."""
    device = torch.device(cfg.device)
    model, opt = train_swin.create_swin_train_state(cfg, TRAIN_IMAGES // TRAIN_BATCH,
                                                    SWIN_MODEL, pretrained=True, mesh=mesh)
    if cfg.accum_steps > 1:   # train_swin accumulates no micro-steps of its own
        opt = make_optimizer(unwrap(model).parameters(), cfg.lr, TRAIN_IMAGES // TRAIN_BATCH,
                             cfg.weight_decay, cfg.momentum, cfg.poly_power,
                             accum_steps=cfg.accum_steps)
    before = {k: v.detach().clone() for k, v in unwrap(model).named_parameters()}
    step = train_swin.make_swin_train_step(model, opt, cfg, CROP, device, mesh)
    reset_counts()
    steps = [step({k: v[rows] for k, v in batch.items()}) for rows in micro]
    parts = {k: float(np.mean([float(p[k]) for p in steps])) for k in steps[0]}
    torch.cuda.synchronize()
    launches = read_counts()
    after = {k: v.detach().clone() for k, v in unwrap(model).named_parameters()}
    return (None, None, parts, before, after), launches


def swin_dp_rank(rank, world, store, tmp, cfg, port, argv):
    """(a)'s ranks: one of ``world`` gloo ranks on the card, its share of
    the batch in ``tmp``; rank 0 writes the loss parts (averaged over the
    ranks) and the parameters after the update. Then ``train_swin.main(argv)``
    under the launcher's variables, each rank with the weight directory
    ``<argv's>/rank<r>``, writing its run's steps and history to
    ``tmp/swin_dp_cli<r>.pt``. NCCL takes no two ranks on one card, so the
    rank joins the launcher's group over gloo (``env://``, ``LOCAL_RANK``
    0: the one card) before ``main``, whose own ``initialize`` finds it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.initialize("cuda:0", init_method=f"file://{store}", rank=rank,
                           world_size=world, backend="gloo")
    batch = dict(np.load(os.path.join(tmp, "swin_dp_batch.npz")))
    per = cfg.batch_size // world
    mesh = make_data_mesh_for_batch(cfg.batch_size, "cuda")
    (_, _, parts, _, after), launches = swin_dp_step(
        cfg, {k: v[rank * per:(rank + 1) * per] for k, v in batch.items()}, mesh)
    if rank == 0:
        torch.save({"parts": parts, "after": {k: v.cpu() for k, v in after.items()},
                    "launches": launches}, os.path.join(tmp, "swin_dp_rank0.pt"))
    distributed.shutdown()
    del after
    torch.cuda.empty_cache()

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    distributed.initialize("cuda", backend="gloo")
    argv = list(argv)
    argv[argv.index("--weight_dir") + 1] += f"/rank{rank}"
    reset_counts()
    state = train_swin.main(argv)
    torch.save({"steps": state.steps, "history": state.history, "launches": read_counts()},
               os.path.join(tmp, f"swin_dp_cli{rank}.pt"))


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def check_swin_dp_cli(tmp, weight_dir) -> None:
    """(a)'s ``train_swin.main`` on the ranks: both ran every step with the
    same loss parts, finite, and no kernel; rank 0 alone wrote the npz."""
    runs = [torch.load(os.path.join(tmp, f"swin_dp_cli{r}.pt"), weights_only=True)
            for r in range(SWIN_DP_RANKS)]
    files = {r: sorted(os.listdir(os.path.join(weight_dir, f"rank{r}")))
             if os.path.isdir(os.path.join(weight_dir, f"rank{r}")) else []
             for r in range(SWIN_DP_RANKS)}
    log(f"  (a) train_swin.main --pretrained on {SWIN_DP_RANKS} gloo ranks under the launcher's "
        f"variables, {TRAIN_BATCH // SWIN_DP_RANKS} images each: steps "
        f"{[run['steps'] for run in runs]}, files written {files}, launches "
        f"{[run['launches'] for run in runs]}")
    for step, parts in enumerate(runs[0]["history"]):
        log(f"    step {step}: " + ", ".join(f"{k} {v:.6g}" for k, v in parts.items()))
    if not all(run["steps"] == 2 and run["history"] == runs[0]["history"] for run in runs):
        raise AssertionError("the ranks of train_swin.main ran other steps or other loss parts")
    if not all(math.isfinite(v) for parts in runs[0]["history"] for v in parts.values()):
        raise AssertionError("train_swin.main on the ranks: a loss part is not finite")
    if files[0] != ["swin_last.npz"] or any(files[r] for r in range(1, SWIN_DP_RANKS)):
        raise AssertionError("train_swin.main on the ranks: rank 0 alone must write "
                             "swin_last.npz")
    if any(run["launches"] != zero_counts() for run in runs):
        raise AssertionError("train_swin.main on the ranks launched a kernel")


def check_swin_data_parallel(device, cfg, root, tmp, meanwhile) -> None:
    """(a) ``train_swin`` over the data mesh: SWIN_DP_RANKS gloo ranks take
    their steps (2 + 2 images) and then run ``train_swin.main`` under the
    launcher's variables, while this process takes the one-device step on
    the 4, the same step as 2 + 2 accumulated micro-steps and on the 4
    permuted (the yardstick of ``order_yardstick``), the world-size-1 NCCL
    step (bit for bit against it) and then ``meanwhile()``; the ranks'
    step against the one-device one (``check_against_yardstick``), and
    their ``main`` runs, once they are done. No time is read while the
    ranks run."""
    scfg = swin_dp_config(cfg)
    batch = {k: np.asarray(v) for k, v in first_batch(cfg).items() if k in ("image", "label")}
    np.savez(os.path.join(tmp, "swin_dp_batch.npz"), **batch)
    # One batch of the fixture and one epoch: main's two steps (the range's
    # and the one at its end).
    cli_list, weight_dir = os.path.join(tmp, "swin_dp_list.txt"), os.path.join(tmp, "swin_dp")
    with open(cli_list, "w") as fh:
        fh.write("\n".join(voc_data.read_file(cfg.train_list)[:TRAIN_BATCH]) + "\n")
    argv = ["--model", SWIN_MODEL, "--crop_size", str(CROP), "--batch_size", str(TRAIN_BATCH),
            "--lr", str(cfg.lr), "--alpha", str(cfg.alpha), "--max_epoches", "1",
            "--IMpath", cfg.image_dir, "--train_list", cli_list,
            "--cls_labels", cfg.cls_labels_path, "--weight_dir", weight_dir,
            "--session_name", "swin", "--pretrained", "--device", "cuda"]
    previous = os.environ.get("ACR_WSSS_ZOO")
    os.environ["ACR_WSSS_ZOO"] = os.path.join(root, "swin_zoo")   # phase 15's npz
    t0 = time.perf_counter()
    try:
        ranks = torch.multiprocessing.spawn(
            swin_dp_rank, args=(SWIN_DP_RANKS, os.path.join(tmp, "swin_dp_store"), tmp, scfg,
                                free_port(), argv),
            nprocs=SWIN_DP_RANKS, join=False)
        try:
            ref, ref_launches = swin_dp_step(scfg, batch, None)
            half = TRAIN_BATCH // 2
            others = {"2 + 2 accumulated": swin_dp_step(
                          dataclasses.replace(scfg, accum_steps=2), batch, None,
                          [slice(0, half), slice(half, None)])[0],
                      "the batch permuted": swin_dp_step(
                          scfg, {k: v[[1, 0, 3, 2]] for k, v in batch.items()}, None)[0]}
            distributed.initialize("cuda:0",
                                   init_method=f"file://{os.path.join(tmp, 'swin_ws1')}",
                                   rank=0, world_size=1)
            try:
                ws1, ws1_launches = swin_dp_step(
                    scfg, batch, make_data_mesh_for_batch(scfg.batch_size, "cuda"))
            finally:
                distributed.shutdown()
            same = ws1[2] == ref[2] and all(torch.equal(v, ref[4][k]) for k, v in ws1[4].items())
            diff = max(float((v - ref[4][k]).abs().max()) for k, v in ws1[4].items())
            log(f"  (a) world-size-1 NCCL DDP step of train_swin against the one-device step: "
                "loss parts " + ", ".join(f"{k} {v:.7g}" for k, v in ws1[2].items())
                + f"; parameters after, largest difference {diff:.3g}; the same bits: {same}")
            if not same:
                raise AssertionError("the world-size-1 Swin DDP step is not the one-device "
                                     "step's bits")
            del ws1
            meanwhile()
        finally:
            while not ranks.join(timeout=300):
                pass
    finally:
        if previous is None:
            os.environ.pop("ACR_WSSS_ZOO")
        else:
            os.environ["ACR_WSSS_ZOO"] = previous
    out = torch.load(os.path.join(tmp, "swin_dp_rank0.pt"), weights_only=True)
    log(f"  (a) {SWIN_DP_RANKS} gloo ranks on cuda:0, {scfg.batch_size // SWIN_DP_RANKS} images "
        f"each, {time.perf_counter() - t0:.1f} s with the rest of (a), (b), (c) and (d); launches: "
        f"one device {ref_launches}, rank 0 {out['launches']}, world size 1 {ws1_launches}")
    if not ref_launches == out["launches"] == ws1_launches == zero_counts():
        raise AssertionError("a Swin step launched a kernel")
    got = (None, None, out["parts"], ref[3], {k: v.to(device) for k, v in out["after"].items()})
    check_against_yardstick(f"{SWIN_DP_RANKS}-rank float32 Swin DDP step", got, ref,
                            order_yardstick("(a)", ref, others))
    check_swin_dp_cli(tmp, weight_dir)


def check_zoo_forwards(device) -> dict:
    """(b) ZOO_FORWARDS: float32 eval forwards on the card against the CPU
    from the same trained-like weights. Returns each name's weights, for
    ``time_zoo_forwards``, and seresnet50's CPU model and CPU output, for
    (d)."""
    kept = {"weights": {}}
    for name in ZOO_FORWARDS:
        size = registry.get_default_cfg(name)["input_size"][1]
        gen = torch.Generator().manual_seed(30)
        x = torch.randn((CLS_BATCH, size, size, 3), generator=gen)
        cpu_model = trained_like(registry.create_model(name, dtype=torch.float32), seed=30).eval()
        with torch.device(device):
            card_model = registry.create_model(name, dtype=torch.float32).eval()
        card_model.load_state_dict(cpu_model.state_dict())
        with torch.no_grad():
            want = cpu_model(x)
            got = card_model(x.to(device))
        torch.cuda.synchronize()
        scale = want["logits"].abs().max().item()
        err = (got["logits"].cpu() - want["logits"]).abs().max().item()
        del card_model
        log(f"  (b) {name}: float32, batch {CLS_BATCH}, {size}x{size}, logits card against CPU "
            f"max abs err {err:.3g} of max |logit| {scale:.3g} (tolerance {CNN_REL} x)")
        if not (math.isfinite(scale) and scale > 0 and err <= CNN_REL * scale):
            raise AssertionError(f"{name}: the card's forward disagrees with the CPU's")
        kept["weights"][name] = cpu_model.state_dict()
        if name == "seresnet50":
            kept["seresnet"] = {"model": cpu_model, "out": want}
        del cpu_model
    torch.cuda.empty_cache()
    return kept


def time_zoo_forwards(device, card, weights) -> dict:
    """(b) each name's bf16 eval forward from ``weights``: host clock,
    median of 5 after one, with nothing else running."""
    out = {}
    for name, state in weights.items():
        size = registry.get_default_cfg(name)["input_size"][1]
        x = torch.randn((CLS_BATCH, size, size, 3), generator=torch.Generator().manual_seed(30))
        with torch.device(device):
            bf16 = registry.create_model(name).eval()
        bf16.load_state_dict(state)
        out[name] = host_forward_ms(bf16, x.to(device))
        del bf16
        log(f"  (b) {name}: bf16 forward, batch {CLS_BATCH}, {size}x{size}: {out[name]:.2f} ms "
            f"(host clock, median of 5), {CLS_BATCH / out[name] * 1e3:.1f} images/s [{card}]")
    torch.cuda.empty_cache()
    return out


def check_surface_module(label, cpu_fn, card_fn) -> float:
    """``card_fn()`` against ``cpu_fn()`` within SURFACE_REL of the largest
    |value|; returns the error relative to it."""
    want = cpu_fn()
    got = card_fn()
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    err = (got.detach().cpu() - want.detach()).abs().max().item()
    log(f"  (d) {label}: card against CPU max abs err {err:.3g} of max |value| {scale:.3g} "
        f"(tolerance {SURFACE_REL} x)")
    if not (math.isfinite(scale) and scale > 0 and err <= SURFACE_REL * scale):
        raise AssertionError(f"{label}: the card disagrees with the CPU")
    return err / scale


def check_surface(device, seresnet) -> None:
    """(d) ``ASPP`` at DeepLab's widths, ``AttentionConv``, and
    ``grad_cam`` on (b)'s seresnet50 features (the CPU's, on both sides)
    for the top class of its first image, through its classifier head."""
    gen = torch.Generator().manual_seed(31)
    for label, make, shape in (
            ("ASPP 2048 -> 256, dilations 1/6/12/18", lambda: extras.ASPP(2048), ASPP_CASE),
            ("AttentionConv 64, kernel 7, 8 groups",
             lambda: extras.AttentionConv(64, 64, kernel_size=7, groups=8), ATTN_CONV_CASE)):
        cpu_m = trained_like(make(), seed=31).eval()
        with torch.device(device):
            card_m = make().eval()
        card_m.load_state_dict(cpu_m.state_dict())
        x = torch.randn(shape, generator=gen)
        with torch.no_grad():
            check_surface_module(f"{label}, {tuple(shape)}", lambda: cpu_m(x),
                                 lambda: card_m(x.to(device)))
    cpu_model, out = seresnet["model"], seresnet["out"]
    with torch.device(device):
        card_fc = torch.nn.Linear(cpu_model.fc.in_features, cpu_model.fc.out_features)
    card_fc.load_state_dict(cpu_model.fc.state_dict())
    feats = out["features"]
    cls = int(out["logits"][0].argmax())
    check_surface_module(
        f"grad_cam on seresnet50's features {tuple(feats.shape)}, class {cls}",
        lambda: grad_cam(feats, lambda f: classifier_head(f, cpu_model.fc), cls),
        lambda: grad_cam(feats.to(device), lambda f: classifier_head(f, card_fc), cls))


def phase_zoo_surface(device, cfg, root, tmp, card) -> None:
    """(a) ``train_swin`` over the data mesh, whose ranks run while this
    process takes (a)'s one-device and world-size-1 steps, (b) the mobile
    and attention CNN families' float32 forwards against the CPU, (c) the
    CNNs' train-mode step and (d) the WSSS surface (ASPP, AttentionConv,
    grad_cam); then, with the ranks done, (b)'s bf16 forwards timed
    alone."""
    kept = {}

    def meanwhile():
        t0 = time.perf_counter()
        kept.update(check_zoo_forwards(device))
        log(f"  (b) {time.perf_counter() - t0:.1f} s")
        log("  (c) the train-mode step, card against CPU (float32, TF32 off)")
        check_cnn_steps(device, ZOO_STEP_NAMES)
        check_surface(device, kept["seresnet"])

    check_swin_data_parallel(device, cfg, root, tmp, meanwhile)
    time_zoo_forwards(device, card, kept.pop("weights"))


def tp_config(cfg, mesh_shape, fp32: bool, backbone=None):
    """Phase 19's step configuration on the first card: the recipe's bf16
    per-layer kernel branch with the bf16 export, or float32 on the plain
    path (TF32 off); on the (data, model) mesh ``mesh_shape``, or on one
    device for None."""
    base = fp32_plain(cfg) if fp32 else cfg
    model = dataclasses.replace(base.model, fuse_consistency=False, probs_dtype="bfloat16",
                                backbone=backbone or base.model.backbone)
    mesh = {} if mesh_shape is None else {"mesh_shape": mesh_shape, "mesh_axes": TP_AXES}
    return dataclasses.replace(base, model=model, device="cuda:0", **mesh)


def register_tp_depth_backbone() -> None:
    """(b)'s vitb at TP_DEPTH blocks, its head on the last one."""
    acr_mod.BACKBONES.setdefault(TP_DEPTH_BACKBONE, dataclasses.replace(
        acr_mod.BACKBONES["vitb"], depth=TP_DEPTH, taps=(TP_DEPTH - 1,)))


@contextlib.contextmanager
def keep_tp_k1_io(kept: list):
    """``keep_k1_backward_io`` with the export: each K1 call of the blocks
    also keeps its out and probs, and the cotangent that reached its probs
    (``de``)."""
    kernel = vit_mod.fused_attention_qkv_cols

    def keeping(qkv, scale, num_heads, export="mean", probs_dtype=torch.float32):
        out, probs = kernel(qkv, scale, num_heads, export, probs_dtype)
        rec = {"qkv": qkv.detach(), "scale": scale, "heads": num_heads, "out": out.detach(),
               "probs": probs.detach(), "dtype": probs_dtype}
        out.register_hook(lambda g: rec.__setitem__("g", g.detach()))
        probs.register_hook(lambda d: rec.__setitem__("de", d.detach()))
        qkv.register_hook(lambda d: rec.__setitem__("dqkv", d.detach()))
        kept.append(rec)
        return out, probs

    vit_mod.fused_attention_qkv_cols = keeping
    try:
        yield
    finally:
        vit_mod.fused_attention_qkv_cols = kernel


def check_tp_kernels(kept) -> dict:
    """K1f and K1b on the (qkv, g, de) that each block of rank 0's step gave
    them (its H / M heads): each equal to the bit to what the step got,
    and held to its plain version with phase 3's tolerances (the bf16
    export's, and the gradient's). Returns the largest errors and the
    shapes."""
    errs = {"K1f out": 0.0, "K1f probs": 0.0, "K1b": 0.0}
    for rec in kept:
        qkv, heads, scale = rec["qkv"], rec["heads"], rec["scale"]
        out, probs = attention_qkv_cols_forward(qkv, scale, heads, "mean", rec["dtype"])
        p_out, p_probs = attention_qkv_cols_plain(qkv, scale, heads, "mean", rec["dtype"])
        dqkv = attention_qkv_cols_backward(qkv, rec["g"], rec["de"], scale, heads)
        ref = attention_qkv_cols_backward_plain(qkv, rec["g"], rec["de"], scale, heads)
        torch.cuda.synchronize()
        if not (torch.equal(out, rec["out"]) and torch.equal(probs, rec["probs"])
                and torch.equal(dqkv, rec["dqkv"])):
            raise AssertionError("K1f or K1b on a block's own inputs is not what the model-axis "
                                 "step got")
        for key, got, want, rtol, atol in (
                ("K1f out", out, p_out, OUT_RTOL, OUT_ATOL),
                ("K1f probs", probs, p_probs, BF16_PROBS_RTOL, PROBS_ATOL),
                ("K1b", dqkv, ref, GRAD_RTOL, GRAD_ATOL_FRAC * ref.float().abs().max().item())):
            err, bad = max_err_and_bad(got, want, rtol, atol)
            if bad:
                raise AssertionError(f"{key} at H = {heads} on a block's own inputs: {bad} "
                                     f"elements out of tolerance, max abs err {err:.3g}")
            errs[key] = max(errs[key], err)
    qkv = kept[0]["qkv"]
    errs["shape"] = (tuple(qkv.shape), kept[0]["heads"], qkv.stride(1), kept[0]["de"].dtype)
    return errs


def tp_params(model) -> dict:
    """Every parameter in the one-device layout, on the host (the model
    axis's parts gathered: an all-reduce, which gloo takes on the card)."""
    return {k: full_like(v).detach().to("cpu", torch.float32, copy=True)
            for k, v in unwrap(model).named_parameters()}


def time_tp_steps(step, batch, reps=TP_TIMED) -> dict:
    """``reps`` more steps on ``batch``: each one's host-clock time
    (synchronized) and its CUDA-event time, in ms."""
    host, events = [], []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        step(batch)
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        events.append(start.elapsed_time(end))
    return {"host": host, "events": events}


def tp_rank(rank, world, store, tmp, part, mesh_shape, cases):
    """Phase 19's ranks: one of ``world`` gloo ranks on the card, on the
    (data, model) mesh ``mesh_shape``; each of ``cases`` (name: config)
    from ``tmp/tp_weights_<backbone>.pt`` on this rank's data rows of
    ``tmp/tp_batch.npz``; rank 0 keeps its K1f and K1b inputs on a kernel
    case and checks them, and every rank times a kernel case's next steps.
    Each rank writes ``tmp/tp_<part>_rank<r>.pt``: loss parts, launches,
    times, and on rank 0 the parameters after."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.initialize("cuda:0", init_method=f"file://{store}", rank=rank,
                           world_size=world, backend="gloo")
    register_tp_depth_backbone()
    batch = dict(np.load(os.path.join(tmp, "tp_batch.npz")))
    mesh = make_mesh(mesh_shape, TP_AXES, "cuda")
    data, per = mesh["data"].get_local_rank(), TRAIN_BATCH // mesh_shape[0]
    share = {k: v[data * per:(data + 1) * per] for k, v in batch.items()}
    out = {}
    for name, ccfg in cases.items():
        kernel = ccfg.model.attn_impl == "kernel"
        weights = torch.load(os.path.join(tmp, f"tp_weights_{ccfg.model.backbone}.pt"),
                             weights_only=True)
        model, _, step = dp_model(ccfg, weights, mesh)
        del weights
        kept = []
        reset_counts()
        with keep_tp_k1_io(kept) if kernel and rank == 0 else contextlib.nullcontext():
            parts = {k: float(v) for k, v in step(share).items()}
        torch.cuda.synchronize()
        res = {"parts": parts, "launches": read_counts()}
        after = tp_params(model)
        if rank == 0:
            res["after"] = after
        if kept:
            res["k1"] = check_tp_kernels(kept)
        del kept, after
        if kernel:
            res["ms"] = time_tp_steps(step, share)
        out[name] = res
        del model, step
        torch.cuda.empty_cache()
    torch.save(out, os.path.join(tmp, f"tp_{part}_rank{rank}.pt"))
    distributed.shutdown()


def tp_one_device(ccfg, weights, batch) -> tuple:
    """``step_on``'s tuple for one one-device step of ``ccfg`` on ``batch``,
    its parameters on the host."""
    model, opt, step = dp_model(ccfg, weights, None)
    before = {k: v.detach().to("cpu", torch.float32, copy=True)
              for k, v in model.named_parameters()}
    reset_counts()
    if ccfg.accum_steps > 1:
        per = TRAIN_BATCH // ccfg.accum_steps
        micro = [step({k: v[r * per:(r + 1) * per] for k, v in batch.items()})
                 for r in range(ccfg.accum_steps)]
        parts = {k: float(np.mean([float(m[k]) for m in micro])) for k in micro[0]}
    else:
        parts = {k: float(v) for k, v in step(batch).items()}
    torch.cuda.synchronize()
    launches = read_counts()
    after = {k: v.detach().to("cpu", torch.float32, copy=True)
             for k, v in model.named_parameters()}
    return (None, None, parts, before, after), launches


def order_yardstick(label, ref, others) -> dict:
    """The spread of the one-device float32 step ``ref`` under other
    summation orders of the same sums (``others``: name -> step), as
    relative L2 of the whole update and of its worst tensor: the larger
    reading of each, which ORDER_SPREAD multiplies into a gate."""
    spread = {"whole": 0.0, "tensor": 0.0}
    for name, other in others.items():
        rel = update_rels(ref[3], other[4], ref[4])
        whole = rel.pop("(all parameters)")
        worst = max(rel, key=rel.get)
        spread = {"whole": max(spread["whole"], whole), "tensor": max(spread["tensor"], rel[worst])}
        log(f"    {label} yardstick, {name} against the one-device step: update {whole:.3g}, "
            f"worst {worst} {rel[worst]:.3g}")
    return spread


def check_against_yardstick(name, got, ref, spread) -> dict:
    """A float32 model-axis step against the one-device step: loss parts
    within LOSS_RTOL, the whole update and its worst tensor within
    ORDER_SPREAD times the yardstick's readings, never above UPDATE_REL."""
    compare_steps_losses(name, got, ref, "the one-device float32 step")
    rel = update_rels(ref[3], got[4], ref[4])
    whole = rel.pop("(all parameters)")
    worst = max(rel, key=rel.get)
    limit = {k: min(UPDATE_REL, ORDER_SPREAD * v) for k, v in spread.items()}
    log(f"    update p1 - p0 against the one-device float32 step's, relative L2: all "
        f"parameters {whole:.3g} (tolerance {limit['whole']:.3g}), worst tensor {worst} "
        f"{rel[worst]:.3g} (tolerance {limit['tensor']:.3g}): {ORDER_SPREAD} x the "
        f"yardstick, at most {UPDATE_REL}")
    if whole > limit["whole"] or rel[worst] > limit["tensor"]:
        raise AssertionError(f"{name}: the update disagrees with the one-device step beyond "
                             "the float32 yardstick")
    return {"whole": whole, "worst": worst, "worst_rel": rel[worst], "limit": limit}


def phase_tensor_parallel(device, cfg, tmp, ref, card) -> dict:
    """(a) TP_RANKS gloo ranks on the card, mesh data=1,model=TP_RANKS,
    vitb_hybrid at full width and depth, crop 384, phase 7's weights and
    batch: the float32 step (TF32 off) against the one-device float32
    per-layer step, gated at ORDER_SPREAD x the yardstick of the
    one-device step's other summation orders (2 + 2 accumulated, the
    batch permuted), every tensor; the bf16 kernel step against the
    one-device bf16 per-layer kernel step in phase 7's step gates on the
    tensors phase 13 (b) gates (``dp_check_global``); K1f and K1b
    TP_LAYERS times each per rank and nothing else; K1f and K1b at H / M
    heads against their plain versions on rank 0's own block inputs.
    (b) four ranks, data=2,model=2, vitb at TP_DEPTH blocks, float32,
    against the one-device step on the same 4 images, (a)'s gate with its
    own yardstick. (c) each rank's bf16 kernel step, host clock and CUDA
    events. A model axis of 5 (no divisor of 12 heads) is refused. The
    one-device references run while the ranks do."""
    weights, batch, _ = ref
    batch = {k: np.asarray(batch[k]) for k in ("image", "label")}
    np.savez(os.path.join(tmp, "tp_batch.npz"), **batch)
    torch.save(weights, os.path.join(tmp, f"tp_weights_{cfg.model.backbone}.pt"))
    register_tp_depth_backbone()
    small = tp_config(cfg, None, True, TP_DEPTH_BACKBONE)
    small_weights = init_random_(train_mod.build_model(small.model), seed=cfg.seed).state_dict()
    torch.save(small_weights, os.path.join(tmp, f"tp_weights_{TP_DEPTH_BACKBONE}.pt"))
    mesh_a, mesh_b = (1, TP_RANKS), (2, 2)
    cases_a = {"fp32": tp_config(cfg, mesh_a, True), "bf16": tp_config(cfg, mesh_a, False)}
    cases_b = {"fp32": tp_config(cfg, mesh_b, True, TP_DEPTH_BACKBONE)}
    perm = [1, 0, 3, 2]
    permuted = {k: v[perm] for k, v in batch.items()}
    depth = ref[2][0].spec.depth

    t0 = time.perf_counter()
    ranks = torch.multiprocessing.spawn(
        tp_rank, args=(TP_RANKS, os.path.join(tmp, "tp_store_a"), tmp, "a", mesh_a, cases_a),
        nprocs=TP_RANKS, join=False)
    try:
        one = tp_config(cfg, None, True)
        fp32, fp32_launches = tp_one_device(one, weights, batch)
        others = {"2 + 2 accumulated": tp_one_device(dataclasses.replace(one, accum_steps=2),
                                                     weights, batch)[0],
                  "the batch permuted": tp_one_device(one, weights, permuted)[0]}
        bf16, bf16_launches = tp_one_device(tp_config(cfg, None, False), weights, batch)
    finally:
        while not ranks.join(timeout=300):
            pass
    outs = [torch.load(os.path.join(tmp, f"tp_a_rank{r}.pt"), weights_only=True)
            for r in range(TP_RANKS)]
    log(f"  (a) {TP_RANKS} gloo ranks on cuda:0, mesh data=1,model={TP_RANKS}, "
        f"{cfg.model.backbone} at crop {cfg.crop_size}, {TRAIN_BATCH} images on each "
        f"({time.perf_counter() - t0:.1f} s with the one-device references); one-device "
        f"launches: float32 {fp32_launches['K1f']} K1f, bf16 {bf16_launches}")
    spread = order_yardstick("(a)", fp32, others)
    res = {"a": {}, "b": {}}
    for name in cases_a:
        parts = outs[0][name]["parts"]
        if any(o[name]["parts"] != parts for o in outs):
            raise AssertionError(f"(a) {name}: the model ranks' loss parts differ")
        got = (None, None, parts, fp32[3], outs[0][name]["after"])
        label = f"{TP_RANKS}-rank model-axis {'float32' if name == 'fp32' else 'bf16 kernel'} step"
        launches = [o[name]["launches"] for o in outs]
        expected = ({**zero_counts(), "K1f": depth, "K1b": depth} if name == "bf16"
                    else zero_counts())
        log(f"   {label}: launches per rank {launches}")
        if any(n != expected for n in launches):
            raise AssertionError(f"(a) {label}: launches {launches}, expected {expected}")
        if name == "fp32":
            res["a"]["fp32"] = check_against_yardstick(label, got, fp32, spread)
            continue
        dp_check_global(label, parts, got[4], bf16, update_rel(bf16, fp32))
        k1 = outs[0][name]["k1"]
        shape, heads, stride, de_dtype = k1["shape"]
        log(f"    K1f and K1b on rank 0's own block inputs, qkv {shape} (row stride {stride}), "
            f"H = {heads}, de {de_dtype}: max abs err K1f out {k1['K1f out']:.3g}, probs "
            f"{k1['K1f probs']:.3g}, K1b {k1['K1b']:.3g} (phase 3's tolerances); each equal to "
            "the bit to what the step got")
        res["a"]["k1"] = k1
        res["a"]["ms"] = [o[name]["ms"] for o in outs]
        res["a"]["launches"] = launches[0]
    del outs

    t0 = time.perf_counter()
    ranks = torch.multiprocessing.spawn(
        tp_rank, args=(4, os.path.join(tmp, "tp_store_b"), tmp, "b", mesh_b, cases_b),
        nprocs=4, join=False)
    try:
        one = tp_config(cfg, None, True, TP_DEPTH_BACKBONE)
        fp32, _ = tp_one_device(one, small_weights, batch)
        others = {"2 + 2 accumulated": tp_one_device(dataclasses.replace(one, accum_steps=2),
                                                     small_weights, batch)[0],
                  "the batch permuted": tp_one_device(one, small_weights, permuted)[0]}
    finally:
        while not ranks.join(timeout=300):
            pass
    outs = [torch.load(os.path.join(tmp, f"tp_b_rank{r}.pt"), weights_only=True)
            for r in range(4)]
    log(f"  (b) 4 gloo ranks on cuda:0, mesh data=2,model=2, vitb at {TP_DEPTH} of its 12 "
        f"blocks, float32, 2 images each ({time.perf_counter() - t0:.1f} s with the "
        "references)")
    spread = order_yardstick("(b)", fp32, others)
    parts = outs[0]["fp32"]["parts"]
    if any(o["fp32"]["parts"] != parts for o in outs):
        raise AssertionError("(b): the ranks' averaged loss parts differ")
    res["b"] = check_against_yardstick("4-rank data=2,model=2 float32 step",
                                       (None, None, parts, fp32[3], outs[0]["fp32"]["after"]),
                                       fp32, spread)
    del outs

    refused = dataclasses.replace(cfg, mesh_shape=(1, 5), mesh_axes=TP_AXES)
    try:
        train_mod.check_mesh(refused)
    except ValueError as e:
        log(f"  a model axis of 5 on {cfg.model.backbone}: {e}")
    else:
        raise AssertionError("a model axis that does not divide the heads was taken")

    log(f"  (c) the bf16 kernel step on each of (a)'s {TP_RANKS} ranks, {TP_TIMED} steps after "
        "the compared one, both ranks on the one card at once:")
    for r, ms in enumerate(res["a"]["ms"]):
        log(f"    rank {r}: host clock median {float(np.median(ms['host'])):.2f} ms (all: "
            + ", ".join(f"{t:.2f}" for t in ms["host"]) + "); CUDA events median "
            f"{float(np.median(ms['events'])):.2f} ms (all: "
            + ", ".join(f"{t:.2f}" for t in ms["events"]) + f") [{card}]")
    return res


def time_step(label, step, batch, images, card, reps=6) -> dict:
    """Host-clock time (synchronized) of ``step(batch)``: median of ``reps``
    after a warm-up; then a profiler window of 2 steps."""
    from torch.profiler import ProfilerActivity, profile

    step(batch)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = float(np.median(times))
    log(f"  {label}, median of {reps} after a warm-up: {step_ms:.2f} ms (all: "
        f"{', '.join(f'{t:.2f}' for t in times)}), {images / step_ms * 1e3:.2f} "
        f"images/s [{card}]")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            step(batch)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
            and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3 / 2 if rows else float("nan")
    if rows:
        log(f"  device busy per step (sum of kernel times, profiler, 2 steps): "
            f"{busy_ms:.2f} ms of {window_ms / 2:.2f} ms under the profiler "
            f"({100 * busy_ms / (window_ms / 2):.1f}%) [{card}]; top kernels per step:")
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:16]:
            log(f"    {e.self_device_time_total / 2e3:9.3f} ms  {e.count // 2:5d} x  "
                f"{e.key[:90]}")
    else:
        log("  device busy per step: not measured (profiler saw no device activity)")
    return {"step_ms": step_ms, "images_per_s": images / step_ms * 1e3, "busy_ms": busy_ms}


def time_train_step(model, opt, cfg, batch, card, reps=6) -> dict:
    """``time_step`` of the fused kernel step."""
    grid = (cfg.crop_size // 16, cfg.crop_size // 16)
    return time_step(f"train step (fused branch, batch {cfg.batch_size}, crop "
                     f"{cfg.crop_size})", train_mod.make_train_step(model, opt, cfg, grid),
                     batch, cfg.batch_size, card, reps)


def time_train_loop(model, opt, cfg, card) -> None:
    """Step time of the training loop as ``train.train`` runs it (the next
    batch loaded while the device runs this step, the loss parts' read the
    step's one sync), fed by the host path and by ``--device_aug``,
    alternating, LOOP_STEPS steps each: median and mean of all but the
    first LOOP_WARMUP."""
    labels = voc_data.load_cls_labels(cfg.cls_labels_path)
    source = voc_data.VOCClassificationSource(cfg.image_dir, labels, cfg.crop_size)
    names = voc_data.read_file(cfg.train_list)
    step = train_mod.make_train_step(model, opt, cfg, (cfg.crop_size // 16,) * 2)
    for aug in (False, True, False, True):
        it = voc_data.TrainIterator(source, names, cfg.batch_size, seed=cfg.seed,
                                    num_workers=cfg.num_workers, device_aug=aug,
                                    aug_pad=cfg.aug_pad)
        try:
            times = []
            batch = next(it)
            for _ in range(LOOP_STEPS):
                t0 = time.perf_counter()
                parts = step(batch)
                batch = next(it)
                torch.stack(list(parts.values())).tolist()
                times.append((time.perf_counter() - t0) * 1e3)
        finally:
            it.close()
        kept = times[LOOP_WARMUP:]
        log(f"  training loop, {'--device_aug' if aug else 'host path  '} ({cfg.num_workers} "
            f"loader threads, batch {cfg.batch_size}, crop {cfg.crop_size}, {len(names)} "
            f"375x500-class JPEGs): step median {np.median(kept):.2f} ms, mean "
            f"{np.mean(kept):.2f} ms over {len(kept)} steps after {LOOP_WARMUP} [{card}]")


def time_image(infer, path, label, pamr_fn=None, reps=5) -> float:
    process_image(infer, path, label, CROP, pamr_fn=pamr_fn)          # warm-up
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        process_image(infer, path, label, CROP, pamr_fn=pamr_fn)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def time_getam_pass(infer, path, label, reps=5) -> float:
    """The device pass alone (both views, present classes in one slot
    group), from host arrays to host arrays: median ms."""
    from acr_wsss_tpu_torch.data import transforms

    x = transforms.val_transform(transforms.load_image_rgb(path), CROP)
    batch = np.stack([x, x[:, ::-1]])
    present = np.flatnonzero(label).tolist()[:CLASS_SLOTS]
    ids = present + [present[-1]] * (CLASS_SLOTS - len(present))
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = infer(batch, ids)
        out["cams"].cpu(), out["patch_cam"].cpu()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times[1:]))


def device_breakdown(infer, path, label, image_ms, card, pamr_fn=None, top=12) -> None:
    """Device time of one image by kernel name (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        process_image(infer, path, label, CROP, pamr_fn=pamr_fn)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
            and e.self_device_time_total > 0]
    if not rows:
        log("  device time by kernel: not measured (profiler saw no device activity)")
        return
    total_ms = sum(e.self_device_time_total for e in rows) / 1e3
    log(f"  device busy per image (sum of kernel times, profiler): {total_ms:.2f} ms, "
        f"{100 * total_ms / image_ms:.1f}% of the per-image latency [{card}]; top kernels:")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d} x  {e.key[:90]}")


def time_call(fn, reps=50) -> float:
    """Device ms per call: CUDA events around ``reps`` calls that the host
    enqueues while the device is held busy, so that a call which takes the
    host longer than the device is timed on the device, not at the host's
    enqueue rate."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    # Device cycles to cover the enqueue of `reps` calls (at most 2 GHz).
    torch.cuda._sleep(int(2 * (time.perf_counter() - t0) * reps * 2e9))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_kernel(label, kernel, plain, library, nbytes, flops, reps, card,
                library_name, peak_flops=PEAK_BF16_FLOPS) -> dict:
    """plain, kernel, kernel, plain in turns on one card (CUDA events over
    ``reps`` launches each), then the library call where there is one; the
    bound from the bytes moved once and the operations at ``peak_flops``."""
    plain_ms = [time_call(plain, reps)]
    kernel_ms = [time_call(kernel, reps), time_call(kernel, reps)]
    plain_ms.append(time_call(plain, reps))
    library_ms = None if library is None else time_call(library, reps)
    bytes_ms, flops_ms = nbytes / PEAK_BYTES * 1e3, flops / peak_flops * 1e3
    res = {"ms": float(np.mean(kernel_ms)), "plain_ms": float(np.mean(plain_ms)),
           "library_ms": library_ms, "bound_ms": max(bytes_ms, flops_ms),
           "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}
    library_text = (f"{library_name} {library_ms*1e3:.1f} us" if library is not None
                    else f"library: {library_name}")
    log(f"  {label} (CUDA events, {reps} launches each): kernel "
        f"{kernel_ms[0]*1e3:.1f} / {kernel_ms[1]*1e3:.1f} us, plain "
        f"{plain_ms[0]*1e3:.1f} / {plain_ms[1]*1e3:.1f} us, {library_text}; bound "
        f"{res['bound_ms']*1e3:.2f} us by {res['bound_by']} "
        f"({nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP) [{card}]")
    return res


def phase_kernel_timing(device, card) -> dict:
    """Each kernel's time at its main path's shape: K1f at B=2 (inference),
    K1n at B=2 and B=4 (validation) and B=8 (the seg step), K2f, K2b, K1b
    (with a float32 or bf16 de, or none: the seg step's) and K1f with
    either export dtype at B=8 (training), K5a, K5b and K5c forward and
    backward at B=8, and K1f at pit_b's first stage (B=2, N=962, H=4)."""
    H, D, N = HEADS, HEAD_DIM, N_TOKENS
    scale = D ** -0.5
    gen = torch.Generator(device=device).manual_seed(1)
    out = {}

    def inputs(B):
        qkv = torch.randn((B, N, 3 * H * D), generator=gen, device=device).to(torch.bfloat16)
        q, k, v = (t.contiguous() for t in qkv.reshape(B, N, 3, H, D).permute(2, 0, 3, 1, 4))
        return qkv, q, k, v

    def sdpa(q, k, v):
        return lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)

    def sdpa_fwd_bwd(q, k, v, g):
        q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))

        def run():
            F.scaled_dot_product_attention(q, k, v, scale=scale).backward(g)
        return run

    qkv, q, k, v = inputs(2)
    io = qkv.numel() * 2 + 2 * N * H * D * 2
    out["K1f"] = time_kernel(
        f"{KERNEL} (K1f) at B=2 N={N} H={H} D={D} bf16, export mean",
        lambda: attention_qkv_cols_forward(qkv, scale, H, "mean"),
        lambda: attention_qkv_cols_plain(qkv, scale, H, "mean"), sdpa(q, k, v),
        io + 2 * N * N * 4, 4 * 2 * H * N * N * D, 50, card, "SDPA (output only)")
    for B in (2, 4, SEG_BATCH):
        qkv, q, k, v = inputs(B)
        out[f"K1n_B{B}"] = time_kernel(
            f"{KERNEL} (K1n) at B={B}, export none",
            lambda: attention_qkv_cols_forward(qkv, scale, H, "none"),
            lambda: attention_qkv_cols_plain(qkv, scale, H, "none"), sdpa(q, k, v),
            qkv.numel() * 2 + B * N * H * D * 2, 4 * B * H * N * N * D, 20, card,
            "SDPA (the same function)")

    B = 2 * TRAIN_BATCH
    pairs = B // 2
    qkv, q, k, v = inputs(B)
    g = torch.randn((B, N, H * D), generator=gen, device=device).to(torch.bfloat16)
    g_heads = g.reshape(B, N, H, D).transpose(1, 2).contiguous()
    g_cls = torch.rand(pairs, generator=gen, device=device)
    g_aff = torch.rand(pairs, generator=gen, device=device)
    de = torch.randn((B, N, N), generator=gen, device=device)
    sign = pair_consistency_forward(qkv, scale, H)[3]
    fwd_flops, bwd_flops = 4 * B * H * N * N * D, 10 * B * H * N * N * D
    out["K2f"] = time_kernel(
        f"{attn_pair.KERNEL} (K2f) at B={B} ({pairs} pairs)",
        lambda: pair_consistency_forward(qkv, scale, H),
        lambda: pair_consistency_forward_plain(qkv, scale, H), sdpa(q, k, v),
        qkv.numel() * 2 + B * N * H * D * 2 + sign.numel() + 2 * pairs * 4, fwd_flops, 10,
        card, "SDPA (output only)")
    out["K2b"] = time_kernel(
        f"{BWD_KERNEL} (K2b, sign tile) at B={B}",
        lambda: pair_consistency_backward(qkv, g, sign, g_cls, g_aff, scale, H),
        lambda: pair_consistency_backward_plain(qkv, g, sign, g_cls, g_aff, scale, H),
        sdpa_fwd_bwd(q, k, v, g_heads),
        2 * qkv.numel() * 2 + g.numel() * 2 + sign.numel() + 2 * pairs * 4, bwd_flops, 10,
        card, "SDPA forward+backward (no de)")
    out["K1b"] = time_kernel(
        f"{BWD_KERNEL} (K1b, dense de) at B={B}",
        lambda: attention_qkv_cols_backward(qkv, g, de, scale, H),
        lambda: attention_qkv_cols_backward_plain(qkv, g, de, scale, H),
        sdpa_fwd_bwd(q, k, v, g_heads),
        2 * qkv.numel() * 2 + g.numel() * 2 + de.numel() * 4, bwd_flops, 10,
        card, "SDPA forward+backward (no de)")
    out["K1b_none"] = time_kernel(
        f"{BWD_KERNEL} (K1b, no de: the seg step's) at B={B}",
        lambda: attention_qkv_cols_backward(qkv, g, None, scale, H),
        lambda: attention_qkv_cols_backward_plain(qkv, g, None, scale, H),
        sdpa_fwd_bwd(q, k, v, g_heads), 2 * qkv.numel() * 2 + g.numel() * 2, bwd_flops, 10,
        card, "SDPA forward+backward (the same gradients)")
    de16 = de.to(torch.bfloat16)
    out["K1b_bf16"] = time_kernel(
        f"{BWD_KERNEL} (K1b, dense bf16 de) at B={B}",
        lambda: attention_qkv_cols_backward(qkv, g, de16, scale, H),
        lambda: attention_qkv_cols_backward_plain(qkv, g, de16, scale, H),
        sdpa_fwd_bwd(q, k, v, g_heads),
        2 * qkv.numel() * 2 + g.numel() * 2 + de16.numel() * 2, bwd_flops, 10,
        card, "SDPA forward+backward (no de)")
    io = qkv.numel() * 2 + B * N * H * D * 2
    for dtype, size in ((torch.float32, 4), (torch.bfloat16, 2)):
        out[f"K1f_B{B}_{str(dtype)[6:]}"] = time_kernel(
            f"{KERNEL} (K1f) at B={B}, export mean, probs {str(dtype)[6:]}",
            lambda: attention_qkv_cols_forward(qkv, scale, H, "mean", dtype),
            lambda: attention_qkv_cols_plain(qkv, scale, H, "mean", dtype), sdpa(q, k, v),
            io + B * N * N * size, fwd_flops, 10, card, "SDPA (output only)")
    # K5: K5a on contiguous (B, H, N, D) q, k, v, K5b on split (B, N, H*D)
    # tensors, K5c on the joint projection; float32 export and de.
    operands = {"K5a": ([q, k, v], g_heads), "K5b": ([t.contiguous() for t in qkv.chunk(3, -1)],
                                                      g), "K5c": ([qkv], g)}
    for entry, layout in ENTRY_LAYOUTS.items():
        xs, g_out = operands[entry]
        out[f"{entry}f"] = time_kernel(
            f"{KERNEL} ({entry}, {layout} layout) at B={B}, export mean, probs float32",
            lambda: call_entry(entry, xs, torch.float32),
            lambda: forward_plain(layout, xs, scale, H, "mean", torch.float32), sdpa(q, k, v),
            io + B * N * N * 4, fwd_flops, 10, card, "SDPA (output only)")
        out[f"{entry}b"] = time_kernel(
            f"{BWD_KERNEL} ({entry}, {layout} layout, dense float32 de) at B={B}",
            lambda: attn_backward(layout, xs, g_out, de, scale, H, ENTRIES[entry]),
            lambda: backward_plain(layout, xs, g_out, de, scale, H),
            sdpa_fwd_bwd(q, k, v, g_heads),
            2 * qkv.numel() * 2 + g.numel() * 2 + de.numel() * 4, bwd_flops, 10,
            card, "SDPA forward+backward (no de)")
    del qkv, q, k, v, g, g_heads, de, de16, sign, operands
    # pit_b's first stage (crop 224): 962 tokens, 4 heads of dim 64
    n_pit, h_pit = 962, 4
    qkv = torch.randn((PIT_BATCH, n_pit, 3 * h_pit * D), generator=gen,
                      device=device).to(torch.bfloat16)
    q, k, v = (t.contiguous() for t in qkv.reshape(
        PIT_BATCH, n_pit, 3, h_pit, D).permute(2, 0, 3, 1, 4))
    out["K1f_pit"] = time_kernel(
        f"{KERNEL} (K1f, PiT) at B={PIT_BATCH} N={n_pit} H={h_pit} D={D} bf16, export mean",
        lambda: attention_qkv_cols_forward(qkv, scale, h_pit, "mean"),
        lambda: attention_qkv_cols_plain(qkv, scale, h_pit, "mean"), sdpa(q, k, v),
        qkv.numel() * 2 + PIT_BATCH * n_pit * h_pit * D * 2 + PIT_BATCH * n_pit * n_pit * 4,
        4 * PIT_BATCH * h_pit * n_pit * n_pit * D, 50, card, "SDPA (output only)")
    del qkv, q, k, v
    out.update(pamr_kernel_timing(device, card))
    return out


def pamr_kernel_timing(device, card) -> dict:
    """K3 and one K4 launch at B=2 views (one image, ``--pamr``) and B=8
    (four images per pass, the pipeline's ``--infer_batch_images 4``),
    384x384, the default dilations, 20 class rows."""
    gen = torch.Generator(device=device).manual_seed(3)
    dils, P, C = PAMR_DILATIONS, 8 * len(PAMR_DILATIONS), NUM_CLASSES
    n = 9 * len(dils)
    out = {}
    for B in (2, 8):
        x = torch.randn((B, 3, CROP, CROP), generator=gen, device=device)
        m = torch.rand((B, C, CROP, CROP), generator=gen, device=device)
        aff = pamr_affinity(x, dils)
        pixels = B * CROP * CROP
        # per pixel and channel: the 9n-tap sum, the variance (sub, mul,
        # add per tap), sqrt and the divisions, 4 operations per neighbour;
        # then the softmax over P (6 operations each)
        k3_flops = pixels * (3 * (n + 3 * n + 4 * P + 5) + 6 * P)
        out[f"K3_B{B}"] = time_kernel(
            f"{pamr_ops.KERNEL} affinity (K3) at B={B} K=3 {CROP}x{CROP} P={P} fp32",
            lambda: pamr_affinity(x, dils), lambda: pamr_affinity_plain(x, dils), None,
            (x.numel() + aff.numel()) * 4, k3_flops, 20, card,
            "none (a dilated 48-tap stencil with replicated edges)", PEAK_FP32_FLOPS)
        out[f"K4_B{B}"] = time_kernel(
            f"{pamr_ops.KERNEL} update (K4), one step, at B={B} C={C} {CROP}x{CROP} P={P} fp32",
            lambda: pamr_update(m, aff, dils), lambda: pamr_update_plain(m, aff, dils), None,
            (2 * m.numel() + aff.numel()) * 4, 2 * P * pixels * C, 20, card,
            "none (per-pixel weights over a dilated 48-tap stencil)", PEAK_FP32_FLOPS)
        del x, m, aff
    return out


def time_pamr_step(pamr_fn, x, mask, card, reps=20) -> float:
    """Device time of ``pamr_fn`` on one image's views (CUDA events): the
    mask's resize to crop resolution, one K3 and PAMR_ITERS K4 launches."""
    ms = time_call(lambda: pamr_fn(x, mask), reps)
    log(f"  PAMR step (resize + K3 + {PAMR_ITERS} K4) on {tuple(x.shape)} guidance and "
        f"{tuple(mask.shape)} CAMs, CUDA events over {reps} calls: {ms * 1e3:.1f} us "
        f"[{card}]")
    return ms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this run needs one GPU",
              file=sys.stderr, flush=True)
        return 1
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain attention: full fp32 logits
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    log(f"[1/19] device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"nvidia-smi: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    reports = _build.build(list(KERNELS))
    log(f"[2/19] build: {time.perf_counter() - t0:.1f} s with nvcc into "
        f"{os.path.relpath(_build.BUILD_DIR, ROOT)}/, one process per source")
    for name, report in reports.items():
        kernel = ""
        for line in report.splitlines():
            entry = re.search(r"Compiling entry function '\S*?(\d+[a-z_]+_kernel)(I\S*?E)?E",
                              line)
            if entry:   # the mangled name: length, name, template arguments
                kernel = entry.group(1).lstrip("0123456789") + (
                    "<" + entry.group(2)[3:-1] + ">" if entry.group(2) else "")
            elif "registers" in line or "spill" in line or "smem" in line:
                log(f"  {name}: {kernel}: {line.strip()}")
    n_dil = len(PAMR_DILATIONS)
    log(f"  blocks per SM (CUDA's occupancy calculator): attn_pair_kernel "
        f"{attn_pair.pair_kernel_blocks_per_sm()}, pamr_affinity_tile_kernel<{n_dil}> "
        f"{pamr_ops.affinity_blocks_per_sm(PAMR_DILATIONS)} (at its largest halo), "
        f"pamr_update_kernel<{n_dil}> {pamr_ops.update_blocks_per_sm(PAMR_DILATIONS)}")

    log("[3/19] kernels against their plain versions on the card")
    errs = phase_kernels(device)

    with tempfile.TemporaryDirectory() as tmp:
        log("[4/19] inference path: GETAM CAM inference, vitb_hybrid, crop 384, 2 images, "
            f"without and with --pamr {PAMR_ITERS}")
        t0 = time.perf_counter()
        (infer, paths, labels, infer_launches, pamr_launches, pamr_fn,
         pamr_input) = phase_main_path(device, tmp)
        log(f"  inference path phase: {time.perf_counter() - t0:.1f} s")

        log("[5/19] training path: train.train, vitb_hybrid, crop 384, batch 4, the recipe")
        t0 = time.perf_counter()
        cfg, train_launches, state = phase_train_path(device, os.path.join(tmp, "train"))
        del state
        log(f"  training path phase: {time.perf_counter() - t0:.1f} s")

        log("[6/19] resumable training: preempt and resume, --device_aug, the relaunch "
            "supervisor, --pretrained, COCO; vitb_hybrid, crop 384")
        t0 = time.perf_counter()
        phase_resume(device, cfg, os.path.join(tmp, "train"), card)
        log(f"  resume phase: {time.perf_counter() - t0:.1f} s")

        log("[7/19] one train step, kernel path against plain path, same weights and batch")
        t0 = time.perf_counter()
        model, opt, batch, layer_launches, step_ctx, fused = phase_step_compare(device, cfg)
        dp_ref = (step_ctx[0], batch, fused)
        del fused
        log(f"  step comparison phase: {time.perf_counter() - t0:.1f} s")

        log("[8/19] attention entries: K5a, K5b, K5c against their plain versions and "
            "through autograd; the per-layer branch with a bf16 export")
        t0 = time.perf_counter()
        entry_errs, entry_launches, bf16_launches = phase_attention_entries(
            device, cfg, step_ctx)
        del step_ctx
        log(f"  attention entries phase: {time.perf_counter() - t0:.1f} s")

        log(f"[9/19] pipeline: train -> infer --pamr {PAMR_ITERS} -> eval, vitb_hybrid, "
            f"crop 384, the recipe")
        t0 = time.perf_counter()
        phase_pipeline(cfg, os.path.join(tmp, "train"))
        log(f"  pipeline phase: {time.perf_counter() - t0:.1f} s")

        log("[10/19] CRF and pseudo masks: the device CRF at 512x512, infer_cam --out_crf "
            "on either route, pseudo_label")
        t0 = time.perf_counter()
        pseudo_dir = phase_crf(device, tmp, paths, labels, infer_launches, card)
        log(f"  CRF phase: {time.perf_counter() - t0:.1f} s")

        log("[11/19] segmentation: train_seg on pseudo masks, vitb_hybrid, crop 384, batch "
            f"{SEG_BATCH}; one bf16 seg step, kernel path against plain path")
        t0 = time.perf_counter()
        seg = phase_seg(device, cfg, tmp, pseudo_dir, card)
        log(f"  segmentation phase: {time.perf_counter() - t0:.1f} s")

        log("[12/19] serving and the reference import: the serving export, the convert "
            "CLI; vitb_hybrid, crop 384")
        t0 = time.perf_counter()
        phase_surface(device, tmp, paths, labels, card)
        log(f"  serving phase: {time.perf_counter() - t0:.1f} s")

        log("[13/19] parallel: DDP, FSDP and --dp on one card; vitb_hybrid, crop 384, "
            "batch 4, the recipe")
        t0 = time.perf_counter()
        names = [os.path.splitext(os.path.basename(p))[0] for p in paths]
        phase_parallel(device, cfg, tmp, names, labels, dp_ref, card)
        log(f"  parallel phase: {time.perf_counter() - t0:.1f} s")

        log(f"[14/19] timing on {card}")
        image_ms = time_image(infer, paths[0], labels[0])
        log(f"  per-image latency (process_image, {IMAGE_SIZES[0][0]}x{IMAGE_SIZES[0][1]}, "
            f"{int(labels[0].sum())} labels, median of 5 after a warm-up): {image_ms:.2f} ms "
            f"[{card}]")
        pamr_image_ms = time_image(infer, paths[0], labels[0], pamr_fn)
        log(f"  per-image latency with --pamr {PAMR_ITERS}, the same image: "
            f"{pamr_image_ms:.2f} ms (+{pamr_image_ms - image_ms:.2f} ms) [{card}]")
        time_pamr_step(pamr_fn, *pamr_input, card)
        pass_ms = time_getam_pass(infer, paths[0], labels[0])
        log(f"  of which the GETAM pass (infer_fn on the 2 views, host arrays in and out): "
            f"{pass_ms:.2f} ms; host decode, resize and normalization: "
            f"{image_ms - pass_ms:.2f} ms [{card}]")
        device_breakdown(infer, paths[0], labels[0], image_ms, card)
        log(f"  with --pamr {PAMR_ITERS}:")
        device_breakdown(infer, paths[0], labels[0], pamr_image_ms, card, pamr_fn)
        del infer, pamr_input
        time_train_step(model, opt, cfg, batch, card)
        time_train_loop(model, opt, cfg, card)
        del model, opt
        torch.cuda.empty_cache()

        log(f"[15/19] Swin and PiT: train_swin at {SWIN_MODEL}, crop {CROP}, batch "
            f"{TRAIN_BATCH}, the recipe; pit_b forwards on K1f at crop {PIT_CROP}")
        t0 = time.perf_counter()
        swin_pit = phase_swin_pit(device, cfg, os.path.join(tmp, "train"), card)
        log(f"  Swin and PiT phase: {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()

        log(f"[16/19] the classifier zoo: ViT and DeiT classifiers on K1n at batch "
            f"{CLS_BATCH}, K1f and K1n at head dims {CLS_HEAD_DIMS}, the PiT names on K1f, "
            "ResNetV2 and BiT, features_only, checkpoint_path")
        t0 = time.perf_counter()
        zoo_phase = phase_classifiers(device, tmp, card)
        log(f"  classifier phase: {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()

        log(f"[17/19] fine-tuning on the kernels: the backward kernels at head dims "
            f"{BWD_HEAD_DIMS}, a bf16 SGD step of {', '.join(n for n, _, _ in FT_CASES)}, the "
            "ViT names on a ResNet-D stem, the CNNs' train-mode step and forwards")
        t0 = time.perf_counter()
        ft_phase = phase_finetune(device, card)
        log(f"  fine-tuning phase: {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()

        log(f"[18/19] the zoo and the WSSS surface: train_swin on the data mesh ({SWIN_MODEL}, "
            f"crop {CROP}, batch {TRAIN_BATCH}), {len(ZOO_FORWARDS)} EfficientNet, MobileNetV3, "
            "RegNet and attention-ResNet forwards, their train-mode step, ASPP, AttentionConv, "
            "grad_cam")
        t0 = time.perf_counter()
        phase_zoo_surface(device, cfg, os.path.join(tmp, "train"), tmp, card)
        log(f"  zoo and surface phase: {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()

        log(f"[19/19] the mesh's model axis: {TP_RANKS} ranks at data=1,model={TP_RANKS} "
            f"({cfg.model.backbone}, crop {CROP}, batch {TRAIN_BATCH}) and 4 at "
            f"data=2,model=2 (vitb at {TP_DEPTH} blocks), gloo on the one card")
        t0 = time.perf_counter()
        phase_tensor_parallel(device, cfg, tmp, dp_ref, card)
        del dp_ref
        log(f"  model-axis phase: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    timing = phase_kernel_timing(device, card)

    src, tpu = "acr_wsss_tpu_torch/csrc/", "acr_wsss_tpu/ops/attn_pallas.py:"
    tpu_pamr = "acr_wsss_tpu/ops/pamr_pallas.py:"
    n = N_TOKENS
    b_train = 2 * TRAIN_BATCH
    kernels = [
        {"name": KERNEL, "route": "cuda", "source": src + "attn_fwd_headmean.cu",
         "replaces": tpu + "380", "launches": infer_launches["K1f"],
         "max_abs_err": errs[("K1", 2, n, "mean")], **timing["K1f"]},
        {"name": KERNEL + " (export none)", "route": "cuda",
         "source": src + "attn_fwd_headmean.cu", "replaces": tpu + "873",
         "launches": train_launches["K1n"],
         "max_abs_err": errs[("K1", 4, n, "none")], **timing["K1n_B4"]},
        {"name": KERNEL + " (export none, seg step)", "route": "cuda",
         "source": src + "attn_fwd_headmean.cu", "replaces": tpu + "873",
         "launches": seg["launches"]["K1n"],
         "max_abs_err": errs[("K1", SEG_BATCH, n, "none")],
         **timing[f"K1n_B{SEG_BATCH}"]},
        {"name": BWD_KERNEL + " (dense de)", "route": "cuda", "source": src + "attn_bwd.cu",
         "replaces": tpu + "421", "launches": layer_launches["K1b"],
         "max_abs_err": errs[("K1b", b_train, n, True)], **timing["K1b"]},
        {"name": BWD_KERNEL + " (no de)", "route": "cuda", "source": src + "attn_bwd.cu",
         "replaces": tpu + "421", "launches": seg["no_de"],
         "max_abs_err": errs[("K1b", b_train, n, False)], **timing["K1b_none"]},
        {"name": attn_pair.KERNEL, "route": "cuda", "source": src + "attn_pair_fwd.cu",
         "replaces": tpu + "1028", "launches": train_launches["K2f"],
         "max_abs_err": errs[("K2f", b_train, n)], **timing["K2f"]},
        {"name": BWD_KERNEL + " (sign tile)", "route": "cuda", "source": src + "attn_bwd.cu",
         "replaces": tpu + "1075", "launches": train_launches["K2b"],
         "max_abs_err": errs[("K2b", b_train, n)], **timing["K2b"]},
        {"name": pamr_ops.KERNEL + " (affinity)", "route": "cuda", "source": src + "pamr.cu",
         "replaces": tpu_pamr + "85", "launches": pamr_launches["K3"],
         "max_abs_err": errs[("K3", 2, CROP, CROP)], **timing["K3_B2"]},
        {"name": pamr_ops.KERNEL + " (update)", "route": "cuda", "source": src + "pamr.cu",
         "replaces": tpu_pamr + "125", "launches": pamr_launches["K4"],
         "max_abs_err": errs[("K4", 2, CROP, CROP)], **timing["K4_B2"]},
        {"name": KERNEL + " (bf16 export)", "route": "cuda",
         "source": src + "attn_fwd_headmean.cu", "replaces": tpu + "380",
         "launches": bf16_launches["K1f"], "max_abs_err": errs[("K1", 4, n, "mean_bf16")],
         **timing[f"K1f_B{b_train}_bfloat16"]},
        {"name": BWD_KERNEL + " (dense bf16 de)", "route": "cuda",
         "source": src + "attn_bwd.cu", "replaces": tpu + "421",
         "launches": bf16_launches["K1b"], "max_abs_err": errs[("K1b", b_train, n, "bf16")],
         **timing["K1b_bf16"]},
    ]
    # K5: the kernel bodies each entry's pallas_calls run (fwd, bwd).
    for entry, fwd_line, bwd_line in (("K5a", "71", "152"), ("K5b", "380", "421"),
                                      ("K5c", "597", "633")):
        layout = ENTRY_LAYOUTS[entry]
        kernels += [
            {"name": f"{KERNEL} ({entry}, {layout} layout)", "route": "cuda",
             "source": src + "attn_fwd_headmean.cu", "replaces": tpu + fwd_line,
             "launches": entry_launches[entry + "f"],
             "max_abs_err": max(v for (e, d, _), v in entry_errs.items()
                                if e == entry and d == "fwd"), **timing[entry + "f"]},
            {"name": f"{BWD_KERNEL} ({entry}, {layout} layout)", "route": "cuda",
             "source": src + "attn_bwd.cu", "replaces": tpu + bwd_line,
             "launches": entry_launches[entry + "b"],
             "max_abs_err": max(v for (e, d, _), v in entry_errs.items()
                                if e == entry and d == "bwd"), **timing[entry + "b"]}]
    kernels.append(
        {"name": KERNEL + " (PiT)", "route": "cuda", "source": src + "attn_fwd_headmean.cu",
         "replaces": tpu + "380", "launches": swin_pit["launches"],
         "max_abs_err": max(swin_pit["errs"].values()), **timing["K1f_pit"]})
    # The classifier zoo: K1n at head dims 96 and 80 (the ViT classifiers),
    # K1f at 48 and 32 (the PiT names); the errors of their own blocks.
    cls, pit, zt = zoo_phase["cls"], zoo_phase["pit"], zoo_phase["timing"]
    for key, runs, what in (
            ("K1n_D96", [cls["vit_small_patch16_224"]], "vit_small_patch16_224"),
            ("K1n_D80", [cls["vit_huge_patch14_224_in21k"]], "vit_huge_patch14_224_in21k"),
            ("K1f_D48", [pit["pit_s_224"], pit["pit_xs_224"]], "pit_s_224, pit_xs_224"),
            ("K1f_D32", [pit["pit_ti_224"]], "pit_ti_224")):
        kind, d = key[:3], int(key[-2:])
        kernels.append(
            {"name": f"{KERNEL} ({'export none' if kind == 'K1n' else 'K1f'}, head dim {d}: "
                     f"{what})", "route": "cuda", "source": src + "attn_fwd_headmean.cu",
             "replaces": tpu + ("873" if kind == "K1n" else "380"),
             "launches": sum(r["launches"] for r in runs),
             "max_abs_err": max(e for r in runs for (_, _, dd), e in r["errs"].items()
                                if dd == d), **zt[key]})
    # The fine-tuning steps: K1b with no de at head dims 96 and 48; the
    # errors on their own blocks' backward inputs.
    ft, ft_t = ft_phase["ft"], ft_phase["timing"]
    for key, name, d in (("K1b_D96_none", "vit_small_resnet50d_s16_224", 96),
                         ("K1b_D48_none", "pit_s_224", 48)):
        kernels.append(
            {"name": f"{BWD_KERNEL} (no de, head dim {d}: {name} fine-tune step)",
             "route": "cuda", "source": src + "attn_bwd.cu", "replaces": tpu + "421",
             "launches": ft[name]["step_launches"], "max_abs_err": max(ft[name]["bwd_errs"].values()),
             **ft_t[key]})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
