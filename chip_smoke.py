#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA device and the
CUDA toolkit (``nvcc``):

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the package from its sources (nvcc, one
     process per source, in parallel), timed, with each kernel's registers,
     spills and shared memory (``-Xptxas -v``);
  3. each kernel against its plain PyTorch version at the shape its path
     gives it, max |diff| must be 0; kernel, plain and bound times. K1
     (batched RoIPool): B=2, 87x87x2048 bf16 maps, P=4096 RoIs with edge
     cases and invalid slots, as the detect and train paths give it, with
     its cell reads (each RoI cell once, and bin by bin), its read rate,
     and its time with the RoIs in RoI order beside the top-row order the
     wrapper launches them in; K2
     (single-image RoIPool, float and int8 mode) looped over the ablation
     tool's own B=2 88x88x2048 bf16 inputs, and on the edge-case boxes of
     the first 87x87 image; K3 (banded RoIPool) against its plain version
     and against K1 on the banded probe's own inputs at its four buckets
     (B=1, P=4096, 88^2 to 192^2 x 2048 bf16), with its time split into the
     partition, the band launch (beside its own bound), the top-row order
     and the rest launch, and on the edge-case boxes of K1's inputs; K2's
     time split into one image's quantization, its top-row order, one
     launch (in the top-row order and in RoI order) and the looped call
     beside K1's B=2 call, each queued alone, and the looped call's peak
     memory against its output plus one image's quantization; K4
     (narrow-dtype max) bit for bit in each of its six
     dtypes, on the dtype probe's input and on seeded random bit patterns,
     with ``torch.maximum`` of the halves timed beside it where torch has it,
     and the wrapper's host issue split into its parts;
  4. the detect path of the flagship config at full width (R50-WS DC5,
     DAN [2048, 4096], 3 OICR branches, bf16, seeded random weights),
     answering detect requests of B=2 704x704 images with P=4096 proposals.
     Requests are timed in windows, one client, each request read back
     before the next is sent: the host clock and CUDA events over each
     request and over the whole window. Then a per-part split of a few more
     requests (device ms and the host ms taken to issue each part), with the
     card's clocks sampled throughout;
  5. the train step of the flagship config at full width (the YAML's
     solver, dropout 0.5, bf16, B=2, 704x704, P=4096): warm-up steps, then
     windows of steps timed by CUDA events and the host clock; every loss
     finite under the JAX package's names, frozen parameters bit-unchanged,
     trainable ones moved, one K1 launch per step, peak memory, and a
     per-part split of a few more steps;
  6. the port's train-step ablation tool (``drn_wsod_torch.tools.
     ablate_bench``) at its full shape: every line of its table, with K2
     launched B times per looped call in each mode;
  7. the port's banded-pool probe (``drn_wsod_torch.tools.
     pool_banded_probe``) at its four buckets: classic (K1) against banded
     (K3) device ms, max |diff| 0, one K1 launch per classic call and one
     launch of each of K3's two kernels per banded call;
  8. the port's dtype probe (``drn_wsod_torch.tools.mosaic_dtype_probe``):
     every dtype OK, one K4 launch each;
  9. the CUDA tests (``tests/test_torch_cuda.py``: each kernel against its
     plain version at a small shape, and toy configs on the card against the
     same weights on the CPU), run by pytest; every test must pass;
 10. the flagship's eval protocol ("eval"): ``GeneralizedRCNNWithTTAAVG.
     detect_image`` at full width with the YAML's TTA (8 scales x flip,
     MAX_SIZE 4000, views built on the device), P=4096 VOC-like proposals,
     on 2 warm-up and 8 timed VOC07-sized u8 images drawn from a seed (no
     JPEG decode: phase 22 has it): ms per image by CUDA events and
     the host clock, views and bucket groups per image, one K1 launch per
     group, a per-part split of each timed image, peak memory, K1 against
     its plain version on the largest group's own inputs (B=4, the 1216
     bucket's 2048-channel bf16 maps), detections finite and inside their
     images, and the VOC evaluator's AP and CorLoc finite in [0, 100];
 11. the flagship's training entry point ("train_entry"), all through
     ``drn_wsod_torch.tools.train_net.main`` on the flagship YAML at full
     width (B=4, crop, 24 scales 480-1216 under MAX 2000, flip, DAN [2048,
     4096], dropout 0.5; seeded random weights, as ``MODEL.WEIGHTS`` is not
     in the repository) from a shard of 24 synthetic VOC-sized records
     packed by ``pack_dataset`` (no JPEG decode: phase 22 has it) with
     their proposals in a
     Detectron2 pickle: (a) 16 steps from scratch, then the TTA eval of the
     4 test and 24 train records; (b) ``--resume`` to 24 steps, its
     restored parameters, momentum and step bit-equal to the checkpoint of
     16, then the TTA eval; (c), run between them, ``--eval-only
     --resume`` without TTA (the test loader) on the checkpoint of 16; (d)
     ``DefaultPredictor`` on one 500x375 image with 4096 proposals. Losses
     finite and lr the schedule's in ``metrics.json``, checkpoints at 8, 16
     and 24, detections finite and inside their images, and at least one
     an image on the weights of 16 ((a) and (c)), K1 launched once per
     step, per TTA group and per test-loader image; steps/s, img/s and the
     loader's wait (``data_time``) from ``metrics.json``, each step's
     device ms by CUDA events with its bucket and its losses (a bucket's
     first step against its reruns), peak memory per run, and K1 against
     its plain version at the largest map the steps gave it;
 12. PCL ("pcl"): ``train_net.main`` on ``pcl_WSR_50_DC5_1x.yaml`` at full
     width and depth (R50-WS DC5, DAN [2048, 4096], 3 PCL branches, bf16,
     B=4, crop, 24 scales, flip, P=4096, seeded random weights) for 8 steps
     from a packed shard of 8 synthetic records, then the YAML's TTA eval
     of the 4 test and 8 train records: every loss finite, K1 once per
     step and per TTA group, detections finite and inside their images;
     each step's device ms with its bucket, the last step split into
     backbone, K1, DAN, WSDDN, PCL mining, PCL loss, backward and
     optimizer (device and host-issue ms), peak memory; the clusters mined
     on the card from one image of a step (P=4096, C=20) against the CPU
     path on the same tensors (where they differ, each class whose 3-means
     boundary differs, with the SSE each device computes);
 13. CSC ("csc"), R18-WS DC5, DAN [512, 4096], B=4, P=4096: (a)
     ``train_net.main`` on ``csc_WSR_18_DC5_1x.yaml`` with
     ``WSL.CSC_MAX_ITER 2``, 4 steps (the CSC step at 0-2, the plain step
     at 3), then the TTA eval, all through the differentiable pool: no K1
     launch, the CPG maps zero and W = 1 (the JAX package stops the image
     gradient at FREEZE_AT 5); (b) ``make_csc_train_step(tau=0)`` at
     ``FREEZE_AT 2`` for 2 steps on loader batches: every present class's
     map live, W != 1 for some present class (else each one's contrast
     range and image probability printed), losses finite, the stem and
     res2 bit-unchanged, res3-res5 and the heads moved; each step's device
     ms split into the CPG pass, ``csc_forward``, the loss pass and the
     optimizer, peak memory.
 14. VGG-16 ("vgg"): ``train_net.main`` on ``oicr_V_16_DC5_1x.yaml`` at
     full width and depth (VGG-16 CONV5_DILATION 2, DAN [4096, 4096], 3
     OICR branches, bf16, B=4, crop, 24 scales, flip, P=4096, seeded random
     weights) for 8 steps from a packed shard of 8 synthetic records, then
     the YAML's TTA eval of 4: every loss finite, K1 once per step and per
     TTA group, K1 exact at the largest 512-channel stride-8 map the steps
     gave it, detections finite and inside their images; each step's
     device ms with its bucket, peak memory;
 15. the plain ResNet ("plain_resnet"): the same on
     ``wsddn_R_50_DC5_1x.yaml`` (strided R50, res5 dilated at stride 16,
     DAN [2048, 4096]), 4 steps, the TTA eval of 2; K1 exact at the
     largest 2048-channel stride-16 map;
 16. WSJDS ("wsjds"): ``ws_jds_V_16_DC5_1x.yaml`` with
     ``SEM_SEG_HEAD.CONSTRAINT True`` and ``WSL.CSC_MAX_ITER 2`` at full
     width, 4 steps (the CSC step at 0-2, the plain step at 3), the TTA
     eval of 2: ``loss_seg`` and ``loss_constraint`` finite, the CPG maps
     zero and every seg target background (FREEZE_AT 5), no K1 launch;
     each step's device ms split into the CPG pass, the seg head, the CRF,
     the loss pass and the optimizer; ``semantic_logits`` on the last
     batch finite, its CRF's probabilities in [0, 1] summing to 1; one
     ``crf_forward`` call's device and host-issue ms at its seg shape; the
     seg head's forward at that batch's map, each ASPP conv alone and the
     head with ``cudnn.benchmark`` off (as the model runs) and on.
 17. COCO ("coco"): ``COCO-Detection/oicr_WSR_50_DC5_1x.yaml`` (WS-R50
     DC5, 80 classes, 3 OICR branches, bf16, B=4, TTA 8 scales x flip,
     seeded random weights) through ``train_net.main``: a COCO-format json
     (the 80 categories under COCO's sparse ids, XYWH boxes, crowd boxes
     with RLE segmentations, a test image without annotations) loaded by
     the port's ``load_coco_json``, given synthetic pixels, packed and
     registered as ``coco_2014_train`` / ``coco_2014_val``; 8 steps, then
     the TTA eval of 4 images into the COCO box evaluator: OICR's losses
     finite, K1 once per step and per TTA group and exact at the largest
     map, AP / AP50 / AP75 finite in [0, 100], and ``evaluate()`` after a
     ``state_dict`` / ``merge_states`` round trip equal to the run's;
 18. trainable BatchNorm and PreciseBN ("bn"): the flagship YAML with
     ``MODEL.RESNETS.NORM BN``, ``TEST.PRECISE_BN.ENABLED``, ``NUM_ITER``
     4 and ``TEST.EVAL_PERIOD`` 4, its statistics drawn from a seed at
     build: 4 steps, PreciseBN after training, the EvalHook's and
     ``main``'s TTA evals of 2 images; K1's map float32 (4, H, W, 2048)
     and K1 exact in float32 at the largest; K1 launches = steps + the
     hook's forwards + both evals' TTA groups; BatchNorm's affine
     unchanged; the statistics equal to the PreciseBN formula applied on
     the host to the drawn ones, bit for bit; K1 queued in float32 and in
     bf16 on the same map, each beside its bound; peak memory.
 19. the supervised retraining heads ("supervised"): ``train_net.main`` on
     ``retrain_fast_rcnn_WSR_50_DC5_1x.yaml`` (Fast R-CNN, DAN [2048,
     4096]) and on ``cascade_rcnn_WSR_50_DC5_1x.yaml`` (three stages of 2
     FC 1024, class-agnostic boxes), both WS-R50 DC5 at FREEZE_AT 2
     (res3-res5 trained through the differentiable RoIPool), bf16, the
     YAMLs' 640-800 scales, from seeded random weights on a packed shard
     of 8 records with instance GT: 4 steps of B=4 each (the YAMLs' 8
     cut) at BASE_LR 1e-4 (the YAMLs' 0.01 cut: on random weights it
     drives Cascade to NaN), at two buckets or more, then the eval
     without TTA of 2 images: losses finite, no K1 launch, 512 slots with
     at most 128 foreground per image, the sampler's core on the card
     bit-equal to the CPU's on the same keys;
 20. the FPN ("fpn"): ``COCO-Detection/fpn_oicr_WSR_50_1x.yaml`` (WS-R50
     pyramid, FPN 256, ROIAlignV2 over p2-p5, DAN [1024, 4096], 80
     classes, FREEZE_AT 5, bf16, TTA) on a packed COCO-format shard of 8
     images: 4 steps of B=4, the TTA eval of 2 images at P=4096 a view;
     OICR's losses finite, no K1 launch, the multi-level pool of one
     image's pyramid and RoIs on the card against the CPU (the share of
     equal values and the largest difference in bf16 ulps, at most one),
     every bottom-up and FPN weight at the start times the scalar that
     weight decay and momentum alone give after 4 steps, every bias
     unchanged;
 21. the deformable blocks ("deform"): ``oicr_WSR_50_DC5_deform_1x.yaml``
     (modulated deformable res4 and res5, K1, FREEZE_AT 5, TTA) from
     seeded random weights with nonzero offset convs: 4 steps of B=4, the
     TTA eval of 2 images; K1 once per step and per TTA group and exact at
     the largest map, ``deform_conv2d`` of one image of a train step's
     call on the card against the CPU (within one bf16 ulp of each value
     plus 2^-15 of the largest), and res4's
     first block with zero offsets and unit masks against the plain
     bottleneck of its weights (within 2 bf16 ulps of the largest value).
 22. JPEG files ("jpeg"), decoded by the port's own decoder
     (``ops/csrc/jpeg_decode.cpp``, built in phase 2 by the host's C++
     compiler; no Pillow, no libjpeg): every fixture Pillow wrote
     (``drn_wsod_torch/data/jpeg_fixtures``, ``FIXTURES``) decoded at each scale its
     manifest records against the digest there (CMYK at 8), the CMYK one
     through ``read_image`` to Pillow's digest; the host
     decode ms an image of the VOC-sized baseline and progressive and the
     COCO-sized fixtures; a VOC directory of the fixtures (8 trainval and 2
     test ids, 4096 proposals an image in a Detectron2 pickle) packed by
     ``pack_dataset``, its pixels the fixtures' digests; then
     ``train_net.main`` on the flagship YAML at full width, 4 steps of B=4
     from the shard and the TTA eval of the 2 unpacked test records,
     which ``read_image`` decodes from their files: losses finite, K1 once
     per step and per TTA group and exact at the largest map, each image's
     detections (every finite score kept) present, finite and inside it.
 23. the mask and keypoint arms ("masks"), all from seeded random weights
     through ``train_net.main``: the rasterizer without Pillow on the
     committed mask fixtures (``drn_wsod_torch/data/mask_fixtures``), and
     the Mask R-CNN YAML's training mapper on a packed shard of the
     fixtures' 8 COCO-sized train images against their digests of
     Pillow's masks; (a) ``Misc/mask_rcnn_R_50_FPN_1x`` (R50-FPN,
     ROIAlignV2, 80 classes, the mask head 4 x 256 at 14^2 -> 28^2,
     FREEZE_AT 2, bf16), 4 steps of B=4 from the shard at BASE_LR 1e-4,
     then the eval without TTA of the 2 test images into the COCO box and
     mask evaluator: losses finite with ``loss_mask``, masks pasted at the
     original size, segm AP finite in [0, 100] (or all NaN), the mask
     head's forward and ``mask_loss`` on the card against the CPU in
     float32; (b) the same YAML set as Detectron2's
     ``keypoint_rcnn_R_50_FPN_1x`` (person only, 17 keypoints, the
     keypoint head 8 x 512 at 14^2 -> 56^2) on a person shard, 4 steps,
     keypoint AP, keypoints in the original frame; (c)
     ``cascade_rcnn_WSR_50_DC5_1x`` with ``MASK_ON`` on (a)'s shard, 2
     steps and the eval at every finite score, every loss finite, masks
     pasted; each step's device ms and bucket, the
     heads' forward ms, the host's paste and segm evaluation seconds, peak
     memory; no K1 launch (a line says so).
 24. RetinaNet ("retinanet"), from seeded random weights through
     ``train_net.main``: (a) ``COCO-Detection/retinanet_R_50_FPN_1x``
     (R50-FPN p3-p6, 9 anchors a cell, 80 classes, focal loss, FREEZE_AT
     2, bf16, 640-800 scales under MAX 2000) on a packed shard of the mask
     fixtures' 8 COCO-sized images, 4 steps of B=4 at BASE_LR 1e-4, then
     the eval without TTA of 2 into COCO box AP: the losses finite,
     K = sum of min(1000, anchors) candidates over the levels at each
     test image, at most 100 detections an image, the head in float32 on
     the card against the CPU; (b) ``quick_schedules/
     retinanet_R_50_instant_test`` as the YAML stands (R18, 10 steps of
     B=2 at 512) but BASE_LR 1e-4; each step's device ms and bucket, the
     detect ms an image, the anchors a level, peak memory; no K1 launch.
 25. the dense paths ("dense"): (a) every committed PNG fixture
     (``drn_wsod_torch/data/png_fixtures``) decoded by the port's reader
     with Pillow blocked against the digests of Pillow's decode and
     ``convert("RGB")`` (the interlaced and 16-bit ones among them), and
     the semantic YAML's training mapper's ``sem_seg``
     canvases against the digests of Pillow's; (b)
     ``Misc/semantic_R_50_FPN_1x`` (SemanticSegmentor, the SemSegFPN
     head, 54 classes) on the fixtures' COCO panoptic-separated tree, 4
     steps of B=4, then mIoU of its val images registered as "sem_seg";
     (c) ``Misc/panoptic_fpn_R_50_1x`` with a proposal file in opts, 4
     steps, then box and segm AP and PQ: the losses finite, the metrics in
     [0, 100]; no K1 launch.
 26. RPN, RRPN, rotated boxes, LVIS and Cityscapes ("rotated_lvis_
     cityscapes"), at full width from seeded random weights: the p2-p6
     maps of the R50-FPN of ``Misc/mask_rcnn_R_50_FPN_1x`` (FREEZE_AT 2,
     bf16) on 4 images at the 1216 bucket; (a) ``StandardRPNHead`` (3
     anchors, Detectron2's Base-RCNN-FPN sizes and ratios) with 20 live
     GT in 100 slots: 4 steps of ``rpn_losses`` + backward + SGD on the
     head (keys from a generator on the card), then ``select_proposals``
     per image and level (pre 2000, post 1000, NMS 0.7); (b) the same
     with rotated anchors (angles -90/0/90, 1.1 M an image) and 20
     rotated GT in 32 slots: ``rrpn_losses``, ``select_proposals_rotated``,
     ``roi_align_rotated`` of the kept p4 proposals in bf16 and float32,
     ``RotatedCOCODetectionEvaluator`` on the host; the card's losses,
     samples, proposals and pools against the CPU's on the same inputs,
     ``pairwise_iou_rotated`` against the float64 host IoU within 1e-5;
     (c) ``COCO-Detection/oicr_WSR_50_DC5_1x`` with 1203 classes and
     Detectron2's LVIS recipe through ``train_net.main`` on an LVIS
     v1-shaped tree of PNG images that ``register_all`` finds under
     ``$DETECTRON2_DATASETS``: 4 steps of B=4, the TTA eval of 2 into the
     LVIS evaluator, K1 exact at the largest map; (d) a Cityscapes tree of
     2048x1024 PNGs registered by ``register_all_cityscapes``: (d1) the
     Mask R-CNN YAML with 8 classes, 4 steps, the eval of 2 into
     ``CityscapesInstanceEvaluator``; (d2) the semantic YAML on the raw
     labelIds (``FILTER_EMPTY_ANNOTATIONS False``), 2 steps, then
     ``CityscapesSemSegEvaluator``. Times by CUDA events, peak memory;
     K1 in (c) only.
 27. several processes on the card ("multi_device",
     ``drn_wsod_torch/parallel``), rank processes of this script
     (``--ph27-rank``) joined by ``torch.distributed`` on a free
     localhost port, each killed where it outlives PH27_TIMEOUT_S: (a)
     NCCL at world size 1: the flagship's ``make_sharded_train_step``
     (bf16, dropout 0.5, global B=4, 704^2, P=4096) for 3 steps bit-equal
     to ``make_train_step`` from the same seeded init, losses and the
     digest of every parameter and buffer; (b) two ranks sharing the card
     over gloo (NCCL puts no two ranks on one device), ``("data",) =
     (2,)``, B=2 each, the flagship in float32 (TF32 off, so that only
     the order of float sums parts them): losses within rtol 1e-4 and the
     trainable parameters within 1e-6 + 1e-4 |p| of one process's B=4
     steps, the ranks' parameters and buffers bit-equal after every step,
     each step's device ms, the gradient ``all_reduce``'s ms and each
     rank's peak memory, one more step split by ``split_step``; (c)
     ``("data", "model") = (1, 2)`` over the same ranks, the DAN split
     (fc1 by rows of the torch weight, fc2 by columns, shapes printed),
     held to (b)'s reference, its checkpoint (written by rank 0 alone)
     loaded at world size 1 to the same digest; (d) ``train_net.main``
     as two gloo ranks on ``cuda:0`` from a packed shard: 4 steps and the
     YAML's TTA eval of 4 test records, 2 a rank, gathered to rank 0:
     ``metrics.json`` and the checkpoint written once, rank 1's log apart
     and its results {}, rank 0's VOC metrics and the detections it
     evaluated equal to a one-process ``--eval-only --resume`` on the
     checkpoint. K1 launches of the ranks and of that eval are counted, and
     every rank of (a)-(d) holds K1 exact to its plain version on the
     largest map it pooled in its train steps (and, in (d), its TTA).
 28. the last slice ("last_slice"), the flagship at full width:
     (a) ``export.export_inference`` at the export CLI's default shape
     (B=1, 512^2, P=2048, seeded random weights): the graph holds the K1
     op, the export's seconds and bytes, the reloaded program launches K1
     once a call, K1 exact to its plain version on the pooled inputs, the
     outputs bit-equal to the live model, CUDA-event latency exported
     against eager, the host's issue of a call, and one ``torch.profiler``
     trace of each (the card's kernel time a call and the ops that part
     the two, by device and by host time); K1
     through the ``torch.library`` op against the direct launch it
     replaced, a call and queued; (b) ``tools/generate_pgt`` over 8
     VOC-sized JPEGs written by the port's encoder with P=2048, its boxes
     equal to ``make_detect_fn``'s top box of each present class; (c) (b)'s
     detections drawn, each PNG read back equal and each JPEG decoded by
     the port's decoder, the demo's ``--output`` on two frames, and
     ``train_net.do_train`` with ``PGTVisualization`` for 2 steps (its
     PNGs written); (d) ``analyze_model``, ``benchmark`` (train, eval,
     TTA, data), ``plain_train_net`` (2 steps) and ``imagenet`` (3 steps,
     BN on batch statistics) on the card. Files under
     ``build/chip_smoke_ph28/``, removed at the end.
 29. every image file the JAX package's readers decode ("image_formats"),
     Pillow blocked: (a) the fixtures of CMYK, YCCK, arithmetic coding,
     progressive files cut at three points (libjpeg's block smoothing),
     lossless files and the misnamed pair at each scale their manifest
     records and through ``read_image``, the Adam7 and 16-bit PNGs
     through ``read_png`` and ``read_png_rgb``, against their digests;
     (b) a VOC tree of VOC-sized files of those kinds and a baseline one,
     all named .jpg, packed by ``pack_dataset``, then ``train_net.main``
     on the flagship YAML at full width, 4 steps of B=4 from the shard and
     the TTA eval of the 2 unpacked test records (YCCK, Adam7 PNG) decoded
     by ``read_image``: losses finite, K1 once per step and per TTA group
     and exact at the largest map, detections finite and inside; (c) the
     ``imagenet`` tool for 3 steps (WS-R50, B=8, 224^2) over a two-class
     tree of those files named .JPEG; (d) the host ms of a 500x375 decode
     of each new path. Files under ``build/chip_smoke_ph29/``, removed at
     the end.
Every path (4-8, 10-29) is run with the kernels' launch counts set to 0
just before it and read just after. The line before the kernels' JSON
line names the JPEG decoder's compiler, its build seconds, the fixture
decodes matched and the host decode times; the line before that gives the
run's total seconds. The second-to-last line is the card's name
and power limit, the line before it a JSON object of per-kernel numbers,
the last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

B, IMG, P = 2, 704, 4096
WARMUP, REQUESTS, WINDOWS, SPLITS = 2, 5, 3, 5
TRAIN_WARMUP, TRAIN_STEPS, TRAIN_WINDOWS, TRAIN_SPLITS = 2, 5, 3, 3
ABLATE_ITERS = 3
PROBE_ITERS = 10
# the eval phase's VOC07-test-like images, (H, W): 500x375, 375x500,
# 500x333, 333x500, 500x500, 486x500, 500x281 and 400x500 (W x H); the two
# warm-up images take the first two sizes
EVAL_SIZES = ((375, 500), (500, 375), (333, 500), (500, 333), (500, 500),
              (500, 486), (281, 500), (500, 400))
EVAL_WARMUP = 2
# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 ops/s
# outside the tensor cores
PEAK_BYTES_S, PEAK_F32_OPS_S = 3.35e12, 67e12


class Fail(Exception):
    """A phase failed; the message says which and why."""


class ClockSampler:
    """The card's SM and memory clocks, power draw and temperature, read by
    ``nvidia-smi`` every 50 ms while the context is open."""

    FIELDS = ("clocks.sm", "clocks.mem", "power.draw", "temperature.gpu")

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", f"--query-gpu={','.join(self.FIELDS)}",
             "--format=csv,noheader,nounits", "-lms", "50"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out = self.proc.communicate(timeout=10)[0]
        rows = []
        for line in out.splitlines():
            try:
                rows.append([float(v) for v in line.split(",")])
            except ValueError:
                continue
        self.summary = "no samples" if not rows else ", ".join(
            f"{name} min {min(col):g} median {statistics.median(col):g} "
            f"max {max(col):g}"
            for name, col in zip(self.FIELDS, zip(*rows))) + \
            f" ({len(rows)} samples)"


def cuda_ms(fn, reps: int) -> float:
    """Median device time of ``fn()`` over ``reps`` runs, CUDA events."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def queued_ms(fn, calls: int) -> float:
    """Device ms per call of ``fn`` with its host issue hidden: after a
    warm-up call, ``calls`` calls are queued behind a sleep of about 50 ms
    on the stream, so the card runs them back to back; CUDA events around
    the calls. For work that takes the host about as long to issue as the
    card to run (K3's partition, K4's tiny launches)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def host_us(fn, calls: int) -> float:
    """Host us per call to issue ``fn``, ``time.perf_counter`` over
    ``calls`` calls issued with the card idle (few enough that the launch
    queue never fills, so the host never waits on the card)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def identity_order(boxes):
    """(B, P) int32 0..P-1 in each row on the boxes' device: K1's launch
    with its blocks taking the RoIs in RoI order."""
    B, P = boxes.shape[:2]
    return torch.arange(P, dtype=torch.int32,
                        device=boxes.device).expand(B, P).contiguous()


def ptxas_report(log: str):
    """(kernel, [ptxas lines]) for each kernel of one source's build log:
    its registers, spills and stack; names demangled by the toolkit's
    ``cu++filt`` where it has one."""
    from drn_wsod_torch.ops import _build

    entries, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = entries.setdefault(m.group(1), [])
        elif cur is not None and ("registers" in line or "spill" in line):
            cur.append(line.split("ptxas info    :")[-1].strip())
    names = list(entries)
    try:
        tool = os.path.join(os.path.dirname(_build._nvcc()), "cu++filt")
        out = subprocess.run([tool, *names], capture_output=True, text=True,
                             timeout=60, check=True).stdout.splitlines()
    except (OSError, RuntimeError, subprocess.SubprocessError):
        out = names
    if len(out) != len(names):
        out = names
    return [(_without_params(label), entries[n])
            for label, n in zip(out, names)]


def _without_params(label: str) -> str:
    """A demangled kernel name without ``void`` and its parameter list
    (the last parenthesised group; template arguments such as ``(int)7``
    stay)."""
    label = label.removeprefix("void ")
    depth = 0
    for i in range(len(label) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(label[i], 0)
        if depth == 0:
            return label[:i] if label.endswith(")") else label
    return label


def pool_boxes():
    """The flagship RoIPool inputs' boxes (B, P, 4) and roi_scale (B, P),
    on the CPU: the synthetic-batch box distribution at 704 px with edge
    cases mixed in, and some invalid slots."""
    from drn_wsod_torch.synthetic import synthetic_batch

    batch = synthetic_batch(B, IMG, IMG, P, 20, seed=1, device="cpu")
    boxes = batch.proposals.numpy().copy()
    rng = np.random.RandomState(2)
    n = 64
    boxes[:, 0:n] = 8.0 * (rng.randint(-3, 90, (B, n, 4)) + 0.5)  # half cells
    boxes[:, n:2 * n, 2:] = boxes[:, n:2 * n, :2] - rng.uniform(
        0, 40, (B, n, 2))                                      # x2<x1, y2<y1
    boxes[:, 2 * n:3 * n] += rng.uniform(-900, 900, (B, n, 1))  # off the map
    boxes[:, 3 * n] = [-50, -50, IMG + 50, IMG + 50]           # whole map
    boxes[:, 3 * n + 1] = [100, 100, 101, 101]                 # sub-cell
    obj = batch.objectness.numpy()
    mask = rng.uniform(0, 1, (B, P)) > 0.05
    mask[:, -256:] = False                                     # padded tail
    scale = ((obj + 1.0) * mask).astype(np.float32)
    return torch.from_numpy(boxes), torch.from_numpy(scale)


def pool_inputs(dev, generator):
    """Flagship-shaped RoIPool inputs: random (B, 87, 87, 2048) bf16 maps
    and :func:`pool_boxes`, on ``dev``."""
    boxes, scale = pool_boxes()
    feats = torch.randn(B, 87, 87, 2048, device=dev, generator=generator,
                        dtype=torch.float32).to(torch.bfloat16)
    return feats, boxes.to(dev), scale.to(dev)


def roi_pool_bound(feats, boxes, scale, out, spatial_scale: float,
                   epilogue_ops: int = 1):
    """Least time for this call: bytes moved once (map, boxes, scales read;
    output written) over HBM rate, against this data's max comparisons
    (cells of every bin times channels) plus ``epilogue_ops`` multiplies per
    output over the float32 rate. Returns (ms, "bytes" | "operations")."""
    from drn_wsod_torch.ops.roi_pool import bin_cells

    H, W, C = feats.shape[-3:]
    cells = bin_cells(boxes, spatial_scale, H, W).sum().item()
    ops = cells * C + epilogue_ops * out.numel()
    nbytes = sum(t.numel() * t.element_size()
                 for t in (feats, boxes, scale, out))
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _launch_counts():
    """The wrappers' per-kernel launch counters (dicts)."""
    from drn_wsod_torch.ops import narrow_max as nm
    from drn_wsod_torch.ops import roi_pool as rp

    return (rp.roi_pool_image.launches, rp.roi_pool_banded.launches,
            nm.narrow_max.launches)


def reset_launches():
    from drn_wsod_torch.ops import roi_pool as rp

    rp.roi_pool_batched.launches = 0
    for counts in _launch_counts():
        for k in counts:
            counts[k] = 0


def read_launches() -> dict:
    from drn_wsod_torch.ops import roi_pool as rp

    image, banded, narrow = _launch_counts()
    return {"roi_pool": rp.roi_pool_batched.launches, **image, **banded,
            **{f"narrow_max_{k}": v for k, v in narrow.items()}}


class Marks:
    """CUDA events and host times at named points in the order they are
    reached, set by hooks on the model's own modules; ``split`` sums each
    span between consecutive points into the part its starting point opens
    (a point reached once per TTA bucket group adds the groups' spans):
    per-part device ms and host-issue ms (launches are asynchronous, so
    where a part's host ms reaches its device ms the card waits on the
    host)."""

    def __init__(self):
        self.marks, self.hooks = [], []

    def __call__(self, name):
        def mark(*_):
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.marks.append((name, event, time.perf_counter()))
        return mark

    def hook(self, module, before: str, after: str):
        self.hooks += [module.register_forward_pre_hook(self(before)),
                       module.register_forward_hook(self(after))]

    def remove(self):
        for h in self.hooks:
            h.remove()

    def split(self, parts: dict):
        """``parts`` maps each point but the last to the part it opens."""
        device = dict.fromkeys(parts.values(), 0.0)
        host = dict.fromkeys(parts.values(), 0.0)
        for (a, ea, ha), (_, eb, hb) in zip(self.marks, self.marks[1:]):
            device[parts[a]] += ea.elapsed_time(eb)
            host[parts[a]] += (hb - ha) * 1e3
        return device, host


def timed_window(run, inputs):
    """Closed loop, one client: each call is read back (synchronised)
    before the next is sent. Returns the outputs, per-call host ms and
    device ms (CUDA events around each call), and the window's host ms and
    device ms (first call's start to last call's end)."""
    starts = [torch.cuda.Event(enable_timing=True) for _ in inputs]
    ends = [torch.cuda.Event(enable_timing=True) for _ in inputs]
    outs, host = [], []
    t_window = time.perf_counter()
    for x, start, end in zip(inputs, starts, ends):
        t = time.perf_counter()
        start.record()
        outs.append(run(x))
        end.record()
        end.synchronize()
        host.append((time.perf_counter() - t) * 1e3)
    window_host = (time.perf_counter() - t_window) * 1e3
    device = [a.elapsed_time(b) for a, b in zip(starts, ends)]
    return outs, host, device, window_host, starts[0].elapsed_time(ends[-1])


def print_windows(phase, what, n, windows, tag):
    for i, (host, device, window_host, window_dev) in enumerate(windows):
        print(f"{phase}: window {i} of {n} {what}: "
              f"{B * n / window_dev * 1e3:.3f} img/s by CUDA events "
              f"({window_dev:.3f} ms), "
              f"{B * n / window_host * 1e3:.3f} img/s by the host "
              f"clock ({window_host:.3f} ms); ms each, device "
              f"[{', '.join(f'{t:.3f}' for t in device)}], host "
              f"[{', '.join(f'{t:.3f}' for t in host)}] {tag}", flush=True)


def print_split(phase, what, parts, tag):
    for kind, runs in (("device", [d for d, _ in parts]),
                       ("host issue", [h for _, h in parts])):
        split = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
        print(f"{phase}: {kind} ms per part, median of {len(runs)} {what} "
              "with hooks: "
              + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
              + "; sum each ["
              + ", ".join(f"{sum(r.values()):.3f}" for r in runs)
              + f"] {tag}", flush=True)


def split_request(model, detect, batch):
    """Per-part device and host-issue ms of one detect request."""
    marks = Marks()
    marks.hook(model.backbone, "backbone_in", "backbone_out")
    marks.hook(model.box_head.fc1, "fc1_in", "fc1_out")
    marks.hooks.append(model.box_head.register_forward_hook(marks("dan_out")))
    scores_fn = model.inference_scores

    def timed_scores(b, feats=None):
        out = scores_fn(b, feats)
        marks("scores_out")()
        return out

    model.inference_scores = timed_scores
    try:
        marks("request_in")()
        detect(batch)
        marks("request_out")()
        torch.cuda.synchronize()
    finally:
        del model.inference_scores
        marks.remove()
    return marks.split({
        "request_in": "preprocess", "backbone_in": "backbone",
        "backbone_out": "pool kernel", "fc1_in": "DAN fc1",
        "fc1_out": "DAN fc2", "dan_out": "heads",
        "scores_out": "NMS + rescale"})


def split_step(model, tx, step, state, batch):
    """Per-part device and host-issue ms of one train step."""
    marks = Marks()
    marks.hook(model, "forward_in", "forward_out")
    marks.hook(model.backbone, "backbone_in", "backbone_out")
    marks.hook(model.box_head, "dan_in", "dan_out")
    update = tx.update

    def timed_update(*args):
        marks("update_in")()
        update(*args)
        marks("update_out")()

    tx.update = timed_update
    try:
        marks("step_in")()
        step(state, batch, 0)
        torch.cuda.synchronize()
    finally:
        del tx.update
        marks.remove()
    return marks.split({
        "step_in": "set-up", "forward_in": "preprocess",
        "backbone_in": "backbone", "backbone_out": "pool kernel",
        "dan_in": "DAN forward", "dan_out": "heads and losses",
        "forward_out": "backward", "update_in": "optimizer"})


def split_tta(model, tta, image, record):
    """Per-part device and host-issue ms of one TTA image, summed over its
    bucket groups: set-up (the uploads), view build (the device views and
    preprocess), backbone, K1 (with the map's layout and the RoI scales),
    DAN, heads (with the sums over views), finalize with NMS (and the host
    copy of the detections)."""
    from drn_wsod_torch import tta as tta_mod

    marks = Marks()
    marks.hook(model.backbone, "backbone_in", "backbone_out")
    marks.hook(model.box_head, "dan_in", "dan_out")
    build, finalize = tta_mod._device_view_batch, tta._finalize

    def timed_build(*args):
        marks("view_in")()
        return build(*args)

    def timed_finalize(*args):
        marks("finalize_in")()
        return finalize(*args)

    tta_mod._device_view_batch, tta._finalize = timed_build, timed_finalize
    try:
        marks("request_in")()
        tta.detect_image(image, record)
        marks("request_out")()
        torch.cuda.synchronize()
    finally:
        tta_mod._device_view_batch, tta._finalize = build, finalize
        marks.remove()
    return marks.split({
        "request_in": "set-up", "view_in": "view build",
        "backbone_in": "backbone", "backbone_out": "K1", "dan_in": "DAN",
        "dan_out": "heads", "finalize_in": "finalize + NMS"})


def exact(name, got, want, phase: int = 3) -> float:
    """max |got - want|; raises unless it is 0 and ``got`` is finite."""
    err = (got.float() - want.float()).abs().max().item()
    if err != 0.0 or not torch.isfinite(got.float()).all():
        raise Fail(f"phase {phase}: {name} kernel vs plain max|diff| {err}")
    return err


def kernel_entry(name, source, replaces, err, ms, plain_ms, bound,
                 library_ms=None) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": library_ms}


# ---------------------------------------------------------------- phases
def phase3_kernels(dev, gen, tag) -> dict:
    """Every kernel against its plain version at the shape its path gives
    it: K1 at the detect and train paths' flagship shape, K2 in both modes
    on the very inputs the ablation tool (phase 6) pools, built by the
    tool's own ``pool_inputs``. K2 is also held on the flagship edge-case
    boxes of one 87x87 image."""
    from drn_wsod_torch.ops import roi_pool as rp
    from drn_wsod_torch.synthetic import synthetic_batch
    from drn_wsod_torch.tools import ablate_bench

    feats, boxes, scale = pool_inputs(dev, gen)
    f0, b0, s0 = feats[0], boxes[0], scale[0]
    edge_err = {}
    for name, int8 in (("roi_pool_image", False),
                       ("roi_pool_image_int8", True)):
        edge_err[name] = exact(
            name, rp.roi_pool_image(f0, b0, 0.125, 7, s0, int8),
            rp.roi_pool_image_plain(f0, b0, 0.125, 7, s0, int8))
        print(f"phase 3: {name} kernel == plain (max|diff| 0.0) on the "
              f"edge-case boxes of one {tuple(f0.shape)} bf16 map, P={P}",
              flush=True)

    C_cls = ablate_bench.flagship_cfg().MODEL.ROI_HEADS.NUM_CLASSES
    tf, tb, ts = ablate_bench.pool_inputs(
        synthetic_batch(B, IMG, IMG, P, C_cls, seed=0, device=dev).proposals,
        IMG)

    def looped_plain(int8):
        return torch.stack([rp.roi_pool_image_plain(f, b, 0.125, 7, s, int8)
                            for f, b, s in zip(tf, tb, ts)])

    cases = {
        "roi_pool": (
            "drn_wsod_torch/ops/csrc/roi_pool.cu",
            "drn_wsod_tpu/ops/roi_pool_pallas.py:695",
            lambda: rp.roi_pool_batched(feats, boxes, 0.125, 7, scale),
            lambda: rp.roi_pool_plain(feats, boxes, 0.125, 7, scale),
            (feats, boxes, scale), 1, "one call, the detect and train "
            "paths' flagship inputs"),
        "roi_pool_image": (
            "drn_wsod_torch/ops/csrc/roi_pool_image.cu",
            "drn_wsod_tpu/ops/roi_pool_pallas.py:1030",
            lambda: rp.roi_pool_looped(tf, tb, 0.125, 7, ts),
            lambda: looped_plain(False),
            (tf, tb, ts), 1, f"one roi_pool_looped call ({B} launches), "
            "the ablation tool's inputs"),
        "roi_pool_image_int8": (
            "drn_wsod_torch/ops/csrc/roi_pool_image.cu",
            "drn_wsod_tpu/ops/roi_pool_pallas.py:1030 (quantize_int8, "
            ":1097-1108)",
            lambda: rp.roi_pool_looped(tf, tb, 0.125, 7, ts, True),
            lambda: looped_plain(True),
            (tf, tb, ts), 2, f"one roi_pool_looped call ({B} launches), "
            "the ablation tool's inputs"),
    }
    kernels = {}
    for name, (source, replaces, kernel, plain, args, epi,
               what) in cases.items():
        got = kernel()
        torch.cuda.synchronize()
        err = max(exact(name, got, plain()), edge_err.get(name, 0.0))
        ms, plain_ms = cuda_ms(kernel, 20), cuda_ms(plain, 5)
        bound_ms, bound_by = roi_pool_bound(*args, got, 0.125, epi)
        print(f"phase 3: {name} kernel == plain (max|diff| 0.0) at "
              f"{tuple(args[0].shape)} bf16, P={P}, {what}: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}); no single PyTorch call computes RoIPool (no "
              f"torchvision), library n/a {tag}", flush=True)
        kernels[name] = kernel_entry(name, source, replaces, err, ms,
                                     plain_ms, (bound_ms, bound_by))
        del got
    phase3_k1_reads(feats, boxes, scale, kernels["roi_pool"]["ms"], tag)
    phase3_k2_split(tf, tb, ts, tag)
    kernels["roi_pool_banded"] = phase3_banded(feats, boxes, scale, tag)
    del feats, tf
    kernels.update(phase3_narrow_max(dev, tag))
    return kernels


def cell_reads_gb(feats, boxes):
    """K1's cell reads per call, GB: each RoI's clamped cells once
    (``roi_cells``, what its body reads) and every bin's cells
    (``bin_cells``, what a pool that reads each bin separately reads)."""
    from drn_wsod_torch.ops import roi_pool as rp

    H, W, C = feats.shape[-3:]
    return tuple(count(boxes, 0.125, H, W).sum().item() * C
                 * feats.element_size() / 1e9
                 for count in (rp.roi_cells, rp.bin_cells))


def phase3_k1_reads(feats, boxes, scale, ms, tag) -> None:
    """K1 at the flagship shape: its cell reads and read rate, its time
    queued (calls back to back, the host's issue hidden) beside phase 3's
    single call ``ms``, and the same launch with the RoIs in RoI order
    instead of the top-row order (``top_row_order``, timed alone too):
    exact either way."""
    from drn_wsod_torch.ops import roi_pool as rp

    def k1():
        return rp.roi_pool_batched(feats, boxes, 0.125, 7, scale)

    ident = identity_order(boxes)

    def roi_order():
        return rp._launch_batched(feats, boxes, 0.125, 7, scale, ident)

    exact("roi_pool in RoI order", roi_order(),
          rp.roi_pool_plain(feats, boxes, 0.125, 7, scale))
    queued, roi_order_queued = queued_ms(k1, 20), queued_ms(roi_order, 20)
    roi_order_ms = cuda_ms(roi_order, 20)
    sort_ms = queued_ms(lambda: rp.top_row_order(boxes), 20)
    sort_us, k1_us = (host_us(fn, 100) for fn in
                      (lambda: rp.top_row_order(boxes), k1))
    once, bins = cell_reads_gb(feats, boxes)
    print(f"phase 3: roi_pool cell reads per call {once:.2f} GB, each RoI "
          f"cell once (roi_cells; {bins:.2f} GB bin by bin, bin_cells): in "
          f"the top-row order {queued:.4f} ms queued ({once / queued:.2f} "
          f"GB/ms; a single call {ms:.4f} ms, the order alone {sort_ms:.4f} "
          f"ms queued); in RoI order {roi_order_queued:.4f} ms queued ("
          f"{once / roi_order_queued:.2f} GB/ms; a single call "
          f"{roi_order_ms:.4f} ms), exact; host issue, us per call over "
          f"100 calls: the order {sort_us:.3f} of the wrapper's "
          f"{k1_us:.3f} {tag}", flush=True)


def looped_peak_mb(fn) -> float:
    """MB allocated at the peak of one call of ``fn`` above what was
    allocated before it (its output included)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e6


def phase3_k2_split(tf, tb, ts, tag) -> None:
    """K2's time on the ablation tool's inputs, each part queued alone:
    ``int8_quantize`` of one image, ``top_row_order`` of one image's boxes,
    one launch (in the top-row order the wrapper passes, and in RoI
    order), the whole ``roi_pool_looped`` call, and K1's B=2 call on the
    same inputs beside them; each launch exact against the plain version.
    Then the peak memory of one looped call, which must stay within 5% of
    its output plus one image's quantization."""
    from drn_wsod_torch.ops import roi_pool as rp

    f, b, s = tf[0], tb[0], ts[0]
    q, ch_scale = rp.int8_quantize(f)
    orders = {"top-row order": rp.top_row_order(b[None])[0],
              "RoI order": identity_order(b[None])[0]}
    out = torch.empty((b.shape[0], 7, 7, f.shape[2]), dtype=f.dtype,
                      device=f.device)
    k1_ms = queued_ms(lambda: rp.roi_pool_batched(tf, tb, 0.125, 7, ts), 20)
    order_ms = queued_ms(lambda: rp.top_row_order(b[None]), 20)
    for int8 in (False, True):
        name = "roi_pool_image_int8" if int8 else "roi_pool_image"
        want = rp.roi_pool_image_plain(f, b, 0.125, 7, s, int8)
        launches = {}
        for oname, order in orders.items():
            def launch():
                rp._launch_image(q if int8 else f, b, 0.125, 7, s, order, out,
                                 ch_scale if int8 else None)
            out.fill_(float("nan"))
            launch()
            exact(f"{name} one launch in {oname}", out, want)
            launches[oname] = queued_ms(launch, 20)

        def looped():
            return rp.roi_pool_looped(tf, tb, 0.125, 7, ts, int8)

        looped_ms = queued_ms(looped, 20)
        quant_ms = queued_ms(lambda: rp.int8_quantize(f), 20) if int8 else 0.0
        quant_mb = looped_peak_mb(lambda: rp.int8_quantize(f)) if int8 else 0.0
        out_mb = (tf.shape[0] * out.numel() * out.element_size()) / 1e6
        peak_mb = looped_peak_mb(looped)
        print(f"phase 3: {name} split, ms per call queued (20 calls behind a "
              f"sleep), the ablation tool's {tuple(tf.shape)} bf16 inputs, "
              f"P={b.shape[0]}: int8_quantize of one image "
              + (f"{quant_ms:.4f}" if int8 else "n/a")
              + f"; top_row_order of one image {order_ms:.4f}; one launch "
              "alone " + ", ".join(f"{k} {v:.4f}" for k, v in launches.items())
              + f"; the looped call (B={tf.shape[0]}, {tf.shape[0]} launches) "
              f"{looped_ms:.4f}; K1's B={tf.shape[0]} call on the same inputs "
              f"{k1_ms:.4f} (looped / K1 {looped_ms / k1_ms:.3f}) {tag}",
              flush=True)
        if peak_mb > 1.05 * (out_mb + quant_mb):
            raise Fail(f"phase 3: {name} looped peak {peak_mb:.1f} MB above "
                       f"its output {out_mb:.1f} MB and quantization "
                       f"{quant_mb:.1f} MB")
        print(f"phase 3: {name} peak memory of one looped call {peak_mb:.1f} "
              f"MB: the output {out_mb:.1f} MB, one image's quantization "
              f"{quant_mb:.1f} MB ({peak_mb / (out_mb + quant_mb):.3f}x their "
              f"sum) {tag}", flush=True)


def band_launch_bound(f, part, resolution=7, band_rows=48):
    """Least time of K3's band launch alone: the short RoIs' outputs
    written once and the staged bands (one per nonempty run, all channels)
    read once, at HBM rate. Returns (ms, output bytes, band bytes)."""
    H, W, C = f.shape[-3:]
    runs = (part.run_start.diff() > 0).sum().item()
    out_b = part.short.sum().item() * resolution ** 2 * C * f.element_size()
    band_b = runs * min(band_rows, H) * W * C * f.element_size()
    return (out_b + band_b) / PEAK_BYTES_S * 1e3, out_b, band_b


def phase3_banded(feats, boxes, scale, tag) -> dict:
    """K3 against its plain version and against K1: on K1's flagship
    edge-case inputs, then at each bucket of the banded probe on the
    probe's own inputs (its boxes drawn in its order), with K3's time split
    into its parts: the partition, the band launch (beside its own bound),
    the top-row order and the rest launch, each queued alone. Times at each
    bucket; the JSON entry holds the 1536 bucket's, the one K3 exists
    for."""
    from drn_wsod_torch.ops import roi_pool as rp
    from drn_wsod_torch.tools import pool_banded_probe

    got = rp.roi_pool_banded(feats, boxes, 0.125, 7, scale)
    torch.cuda.synchronize()
    err = max(exact("roi_pool_banded", got,
                    rp.roi_pool_banded_plain(feats, boxes, 0.125, 7, scale)),
              exact("roi_pool_banded (against K1)", got,
                    rp.roi_pool_batched(feats, boxes, 0.125, 7, scale)))
    del got
    print(f"phase 3: roi_pool_banded kernel == plain == roi_pool kernel "
          f"(max|diff| 0.0) on the edge-case boxes of {tuple(feats.shape)} "
          f"bf16, P={P}", flush=True)
    rs = np.random.RandomState(0)
    for S in pool_banded_probe.BUCKETS:
        f, b, s = pool_banded_probe.bucket_inputs(rs, S, feats.device)
        part = rp.band_partition(b, 0.125, f.shape[1])
        tile = rp.band_tile(f)
        order = rp.top_row_order(b)

        def kernel():
            return rp.roi_pool_banded(f, b, 0.125, 7, s)

        def plain():
            return rp.roi_pool_banded_plain(f, b, 0.125, 7, s)

        def k1():
            return rp.roi_pool_batched(f, b, 0.125, 7, s)

        ident = identity_order(b)

        def k1_roi_order():
            return rp._launch_batched(f, b, 0.125, 7, s, ident)

        got = kernel()
        torch.cuda.synchronize()
        err = max(err, exact(f"roi_pool_banded at {S}", got, plain()),
                  exact(f"roi_pool_banded at {S} (against K1)", got, k1()),
                  exact(f"roi_pool_banded at {S} (against K1 in RoI order)",
                        got, k1_roi_order()))
        ms, k1_ms = queued_ms(kernel, 20), queued_ms(k1, 20)
        k1_roi_order_ms = queued_ms(k1_roi_order, 20)
        once, bins = cell_reads_gb(f, b)
        single_ms, plain_ms = cuda_ms(kernel, 20), cuda_ms(plain, 3)
        out = torch.full_like(got, float("nan"))
        parts = {
            "partition": lambda: rp.band_partition(b, 0.125, f.shape[1]),
            "band launch": lambda: rp._launch_band(
                f, b, 0.125, 7, s, part, tile, 48, out),
            "top_row_order": lambda: rp.top_row_order(b),
            "rest launch": lambda: rp._launch_rest(
                f, b, 0.125, 7, s, order, part.short, out)}
        split = {name: queued_ms(fn, 20) for name, fn in parts.items()}
        exact(f"roi_pool_banded at {S} (its two launches alone)", out, got)
        band_ms, out_b, band_b = band_launch_bound(f, part)
        bound = roi_pool_bound(f, b, s, got, 0.125)
        vec = 16 // f.element_size()
        band_smem = min(48, f.shape[1]) * rp.band_pitch(
            f.shape[2], tile.ct // vec) * 16
        longest = part.run_start.diff().max().item()
        print(f"phase 3: roi_pool_banded kernel == plain == roi_pool kernel "
              f"(max|diff| 0.0) at bucket {S}, {tuple(f.shape)} bf16, "
              f"P={P}, the probe's boxes, {part.short.sum().item()} short "
              f"RoIs in {part.num_bands} bands (the longest run "
              f"{longest}), channel tile {tile.ct}, RoI chunk {tile.chunk} "
              f"(a band of {band_smem} B and a table of "
              f"{rp.table_bytes(7, tile.chunk)} B of shared memory): kernel "
              f"{ms:.4f} ms per call queued ({single_ms:.4f} a single call, "
              f"its host issue included), K1 {k1_ms:.4f} ms queued ("
              f"{once / k1_ms:.2f} GB/ms of {once:.2f} GB of reads each RoI "
              f"cell once; {bins:.2f} GB bin by bin), K1 in RoI order "
              f"{k1_roi_order_ms:.4f} ms queued ({once / k1_roi_order_ms:.2f}"
              f" GB/ms), plain {plain_ms:.4f} ms, bound {bound[0]:.4f} ms "
              f"({bound[1]}); library n/a, as K1 {tag}", flush=True)
        print(f"phase 3: roi_pool_banded parts at bucket {S}, ms per call "
              f"queued, each alone: "
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
              + f"; sum {sum(split.values()):.4f} of K3's {ms:.4f} (K1 "
              f"{k1_ms:.4f}, K3 / K1 {ms / k1_ms:.3f}); the band launch's "
              f"bound {band_ms:.4f} ms (bytes: {out_b / 1e6:.0f} MB of short "
              f"RoI outputs, {band_b / 1e6:.0f} MB of staged bands), "
              f"bound / time {band_ms / split['band launch']:.1%} {tag}",
              flush=True)
        del got, out, f
    return kernel_entry(
        "roi_pool_banded", "drn_wsod_torch/ops/csrc/roi_pool_banded.cu",
        "drn_wsod_tpu/ops/roi_pool_pallas.py:948 (_banded_launch :897, "
        "pallas_call :927)", err, ms, plain_ms, bound)


def k4_issue_split(x, kind, calls: int = 1000) -> dict:
    """Host us per call of each part of K4's wrapper, ``time.perf_counter``
    over ``calls`` calls each (the card idle at the start of each part):
    its checks, its allocation, the raw stream lookup (and the
    ``torch.cuda.current_stream`` object it replaced), the ctypes call with
    its launch and without it (a call the C side refuses), the whole
    wrapper, and ``torch.maximum`` of the halves where torch has it."""
    from drn_wsod_torch.ops import _build
    from drn_wsod_torch.ops import narrow_max as nm

    spec = nm._SPECS[kind]
    device = x.get_device()
    shape = (x.shape[0] >> 1, *x.shape[1:])
    out = x.new_empty(shape)
    fn = nm._kernel()
    args = (x.data_ptr(), out.data_ptr(), x.nbytes // 2, spec[1],
            _build.raw_stream(device))
    lo, hi = x[:shape[0]], x[shape[0]:]
    parts = {
        "checks": lambda: nm._half_bytes(x, kind, spec),
        "new_empty": lambda: x.new_empty(shape),
        "raw stream": lambda: _build.raw_stream(device),
        "torch.cuda.current_stream": lambda: torch.cuda.current_stream(
            device).cuda_stream,
        "ctypes call and launch": lambda: fn(*args),
        # the C side refuses a half of 0 bytes before any CUDA call
        "ctypes call alone": lambda: fn(args[0], args[1], 0, *args[3:]),
        "wrapper": lambda: nm.narrow_max(x, kind),
        "torch.maximum": lambda: torch.maximum(lo, hi)}
    split = {}
    for name, part in parts.items():
        try:
            part()
        except (RuntimeError, NotImplementedError):
            continue                    # torch.maximum: no such kernel
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            part()
        split[name] = (time.perf_counter() - t) / calls * 1e6
        torch.cuda.synchronize()
    if kind == "int4":
        split.pop("torch.maximum", None)    # torch has no int4 dtype
    return split


def issued_ms(fns: dict, calls: int = 200, turns: int = 5) -> dict:
    """Per-call device ms of each of ``fns`` issued with the card idle
    (``ablate_bench.cuda_ms``: CUDA events around ``calls`` calls, so the
    host's issue rate), taken in turns ``turns`` times; the median of each.
    Host times on a shared machine drift, so versions compared are timed
    in alternation."""
    from drn_wsod_torch.tools.ablate_bench import cuda_ms as per_call_ms

    runs = {name: [] for name in fns}
    for _ in range(turns):
        for name, fn in fns.items():
            runs[name].append(per_call_ms(fn, calls))
    return {name: statistics.median(r) for name, r in runs.items()}


def phase3_narrow_max(dev, tag) -> dict:
    """K4 in each dtype, bit for bit against its plain version on the dtype
    probe's input and on seeded random bit patterns of the same (16, 512)
    shape; device ms per launch over 200 queued launches (and the host's
    rate, 200 launches issued with the card idle), and ``torch.maximum`` of
    the halves where torch has it for the dtype."""
    from drn_wsod_torch.ops import narrow_max as nm

    gen = torch.Generator(device=dev).manual_seed(4)
    kernels = {}
    for kind in nm.KINDS:
        probe_x = nm.probe_input(kind, dev)
        raw = torch.randint(0, 256, (16, probe_x[0].numel()
                                     * probe_x.element_size()),
                            generator=gen, device=dev, dtype=torch.uint8)
        for what, x in (("probe input", probe_x),
                        ("random bits", raw.view(nm.DTYPES[kind]))):
            got = nm.narrow_max(x, kind)
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.uint8),
                               nm.narrow_max_plain(x, kind).view(
                                   torch.uint8)):
                raise Fail(f"phase 3: narrow_max {kind} kernel differs from "
                           f"plain on the {what}")
        x = raw.view(nm.DTYPES[kind])
        ms = queued_ms(lambda: nm.narrow_max(x, kind), 200)
        plain_ms = queued_ms(lambda: nm.narrow_max_plain(x, kind), 200)
        lo, hi = x[:8], x[8:]
        issue = {"kernel": lambda: nm.narrow_max(x, kind)}
        try:
            torch.maximum(lo, hi)
        except (RuntimeError, NotImplementedError) as e:
            library_ms, library = None, f"n/a ({str(e).splitlines()[0]})"
        else:
            library_ms = queued_ms(lambda: torch.maximum(lo, hi), 200)
            issue["torch.maximum"] = lambda: torch.maximum(lo, hi)
        issued = issued_ms(issue)
        host_ms = issued["kernel"]
        if "torch.maximum" in issued:
            library = (f"{library_ms:.5f} ms queued, "
                       f"{issued['torch.maximum']:.5f} issued")
        if kind == "int4":
            library_ms, library = None, "n/a (torch has no int4 dtype)"
        split = k4_issue_split(x, kind)
        print(f"phase 3: narrow_max_{kind} host issue, us per call over "
              f"1000 calls (time.perf_counter): "
              + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
              + f" {tag}", flush=True)
        nbytes = 1.5 * x.numel() * x.element_size()
        bound = (nbytes / PEAK_BYTES_S * 1e3, "bytes")
        print(f"phase 3: narrow_max_{kind} kernel == plain bit for bit on "
              f"the probe input and on random bits, {tuple(x.shape)} "
              f"{x.dtype}: kernel {ms:.5f} ms queued ({host_ms:.5f} issued "
              f"with the card idle, median of 5 turns with torch.maximum's), "
              f"plain {plain_ms:.5f} ms queued, bound "
              f"{bound[0]:.2e} ms (bytes, {nbytes:.0f} B), torch.maximum "
              f"{library} {tag}", flush=True)
        kernels[f"narrow_max_{kind}"] = kernel_entry(
            f"narrow_max_{kind}", "drn_wsod_torch/ops/csrc/narrow_max.cu",
            "tools/mosaic_dtype_probe.py:18 (pallas_call :27)", 0.0, ms,
            plain_ms, bound, library_ms)
    return kernels


def phase4_detect(dev, gen, tag) -> dict:
    import drn_wsod_torch
    from drn_wsod_torch.tools import ablate_bench

    # B=2 batches without TTA; phase 10 runs the flagship's TTA protocol
    cfg = ablate_bench.flagship_cfg(overrides=("TEST.AUG.ENABLED", False))
    model = drn_wsod_torch.build_model(cfg, device=dev, generator=gen)
    topk = cfg.TEST.DETECTIONS_PER_IMAGE
    detect = drn_wsod_torch.make_detect_fn(
        model, cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST,
        cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST, topk, device=dev)
    C = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    batches = [drn_wsod_torch.synthetic_batch(B, IMG, IMG, P, C, seed=s,
                                              device=dev)
               for s in range(WARMUP + REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with ClockSampler() as clock_sampler:
        outs = [detect(batch) for batch in batches[:WARMUP]]
        torch.cuda.synchronize()
        windows = []
        for _ in range(WINDOWS):
            w = timed_window(detect, batches[WARMUP:])
            outs += w[0]
            windows.append(w[1:])
        launches = read_launches()
        # the per-part split runs after the count is read: its hooks make
        # these requests differ from a caller's
        parts = [split_request(model, detect,
                               batches[WARMUP + i % REQUESTS])
                 for i in range(SPLITS)]

    n_req = WARMUP + WINDOWS * REQUESTS
    if launches["roi_pool"] != n_req:
        raise Fail(f"phase 4: roi_pool launched {launches['roi_pool']} "
                   f"times for {n_req} requests")
    for dets in outs:
        shapes = {k: tuple(v.shape) for k, v in dets.items()}
        want_shapes = {"boxes": (B, topk, 4), "scores": (B, topk),
                       "classes": (B, topk), "valid": (B, topk),
                       "all_scores": (B, P, C + 1), "all_boxes": (B, P, 4)}
        if shapes != want_shapes:
            raise Fail(f"phase 4: output shapes {shapes}")
        finite = all(torch.isfinite(v.float()).all().item()
                     for v in dets.values())
        row_sums = dets["all_scores"].sum(-1)
        if (not finite or not dets["valid"].any()
                or (row_sums - 1).abs().max().item() > 1e-4
                or (dets["scores"] < 0).any() or (dets["scores"] > 1).any()
                or (dets["classes"][dets["valid"]] >= C).any()):
            raise Fail("phase 4: outputs not finite, empty or out of range")
    print(f"phase 4: {n_req} detect requests (B={B}, {IMG}x{IMG}, P={P}, "
          f"R50-WS DC5, DAN [2048, 4096], 3 OICR branches, bf16); "
          f"launches {launches} (roi_pool once per request); "
          f"outputs finite, shapes {shapes}", flush=True)
    print_windows("phase 4", "requests", REQUESTS, windows, tag)
    print(f"phase 4: peak device memory of the requests "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {tag}",
          flush=True)
    print_split("phase 4", "requests", parts, tag)
    print(f"phase 4: card during the requests: {clock_sampler.summary} "
          f"{tag}", flush=True)
    return launches


def phase5_train(dev, gen, tag) -> dict:
    import drn_wsod_torch
    from drn_wsod_torch.tools import ablate_bench

    cfg = ablate_bench.flagship_cfg()
    model = drn_wsod_torch.build_model(cfg, device=dev, generator=gen)
    tx = drn_wsod_torch.build_optimizer(cfg, model)
    state = drn_wsod_torch.create_train_state(model, tx)
    step = drn_wsod_torch.make_train_step(model, tx)
    C = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    batches = [drn_wsod_torch.synthetic_batch(B, IMG, IMG, P, C, seed=100 + s,
                                              device=dev)
               for s in range(TRAIN_WARMUP + TRAIN_STEPS)]
    trainable = {n: p for n, p in model.named_parameters() if p.requires_grad}
    start = {n: p.detach().clone() for n, p in trainable.items()}
    frozen = {n: t.clone() for n, t in model.state_dict().items()
              if n not in trainable}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with ClockSampler() as clock_sampler:
        metrics = [step(state, b, 0)[1] for b in batches[:TRAIN_WARMUP]]
        torch.cuda.synchronize()
        windows = []
        for _ in range(TRAIN_WINDOWS):
            w = timed_window(lambda b: step(state, b, 0)[1],
                             batches[TRAIN_WARMUP:])
            metrics += w[0]
            windows.append(w[1:])
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        parts = [split_step(model, tx, step, state,
                            batches[TRAIN_WARMUP + i % TRAIN_STEPS])
                 for i in range(TRAIN_SPLITS)]

    n_steps = TRAIN_WARMUP + TRAIN_WINDOWS * TRAIN_STEPS
    if launches["roi_pool"] != n_steps:
        raise Fail(f"phase 5: roi_pool launched {launches['roi_pool']} "
                   f"times for {n_steps} steps")
    names = {"loss_cls", "loss_cls_r0", "loss_cls_r1", "loss_cls_r2",
             "total_loss"}
    values = [{k: v.item() for k, v in m.items()} for m in metrics]
    if any(set(v) != names or not all(map(math.isfinite, v.values()))
           for v in values):
        raise Fail(f"phase 5: losses not finite or misnamed: {values}")
    changed = [n for n, t in frozen.items()
               if not torch.equal(t, model.state_dict()[n])]
    if changed:
        raise Fail(f"phase 5: frozen tensors changed: {changed[:5]}")
    # a parameter moves exactly where its momentum trace is nonzero (the
    # bbox_pred biases of branches without box regression get neither a
    # gradient nor weight decay)
    still = [n for n, p in trainable.items()
             if torch.equal(p, start[n])
             != bool((state.opt_state["trace"][n] == 0).all())]
    moved = [n for n, p in trainable.items() if not torch.equal(p, start[n])]
    if still or "box_head.fc1.weight" not in moved:
        raise Fail(f"phase 5: trainable parameters did not move as their "
                   f"updates say: {still}")
    first, last = values[0], values[-1]
    print(f"phase 5: {n_steps} train steps (B={B}, {IMG}x{IMG}, P={P}, "
          f"flagship solver: BASE_LR {cfg.SOLVER.BASE_LR}, WD "
          f"{cfg.SOLVER.WEIGHT_DECAY}, BIAS_LR_FACTOR "
          f"{cfg.SOLVER.BIAS_LR_FACTOR}, dropout "
          f"{cfg.MODEL.ROI_BOX_HEAD.DROPOUT}, bf16); launches {launches} "
          f"(roi_pool once per step); losses finite, first step "
          f"{json.dumps(first)}, last {json.dumps(last)}; "
          f"{len(frozen)} frozen tensors bit-unchanged; "
          f"{len(moved)} of {len(trainable)} trainable moved", flush=True)
    print_windows("phase 5", "steps", TRAIN_STEPS, windows, tag)
    print(f"phase 5: peak device memory of the steps {peak / 2**30:.2f} GiB "
          f"{tag}", flush=True)
    print_split("phase 5", "steps", parts, tag)
    print(f"phase 5: card during the steps: {clock_sampler.summary} {tag}",
          flush=True)
    return launches


def phase6_ablate(tag) -> dict:
    from drn_wsod_torch.tools import ablate_bench

    reset_launches()
    rows = ablate_bench.run(
        ABLATE_ITERS, emit=lambda r: print(
            "phase 6: " + ablate_bench.format_row(r, tag), flush=True))
    launches = read_launches()
    calls = {r.name: r.calls for r in rows}
    for name, key in ((f"K2 pool, looped per image (B={B})",
                       "roi_pool_image"),
                      (f"K2 pool, looped per image, int8 (B={B})",
                       "roi_pool_image_int8")):
        if launches[key] != B * calls[name]:
            raise Fail(f"phase 6: {key} launched {launches[key]} times in "
                       f"{calls[name]} looped calls of B={B}")
    if launches["roi_pool"] == 0:
        raise Fail("phase 6: the tool's train steps launched no roi_pool")
    if not all(math.isfinite(r.ms) and r.ms > 0 for r in rows):
        raise Fail(f"phase 6: a time is not positive: {rows}")
    print(f"phase 6: launches {launches} ({B} K2 launches per looped call, "
          f"in each mode)", flush=True)
    return launches


def phase7_banded_probe(tag) -> dict:
    from drn_wsod_torch.tools import pool_banded_probe

    reset_launches()
    rows = pool_banded_probe.run(
        pool_banded_probe.BUCKETS, PROBE_ITERS,
        emit=lambda r: print("\n".join(
            "phase 7: " + line
            for line in pool_banded_probe.format_bucket(r, tag)), flush=True))
    launches = read_launches()
    calls = sum(r.calls for r in rows)
    want = {"roi_pool": calls, "roi_pool_banded": calls,
            "roi_pool_banded_rest": calls}
    got = {k: launches[k] for k in want}
    if got != want:
        raise Fail(f"phase 7: launches {got} for {calls} calls of each path")
    if any(r.max_diff != 0.0 for r in rows):
        raise Fail(f"phase 7: classic and banded differ: {rows}")
    print(f"phase 7: launches {launches} ({calls} calls of each path: one "
          f"K1 launch per classic call, one launch of each K3 kernel per "
          f"banded call)", flush=True)
    return launches


def phase8_dtype_probe(tag) -> dict:
    from drn_wsod_torch.tools import mosaic_dtype_probe

    reset_launches()
    rows = mosaic_dtype_probe.run(emit=lambda kind, result: print(
        f"phase 8: {kind:16s} {result} {tag}", flush=True))
    launches = read_launches()
    bad = [(k, r) for k, r in rows
           if r != "OK" or launches[f"narrow_max_{k}"] != 1]
    if bad:
        raise Fail(f"phase 8: {bad}; launches {launches}")
    print(f"phase 8: launches {launches} (one K4 launch per dtype)",
          flush=True)
    return launches


def phase9_tests(tag) -> None:
    root = Path(__file__).resolve().parent
    # NCCL across cards needs two of them: left out on one card, not
    # skipped; the full-width data-parallel check (minutes of four ranks)
    # runs in a call of its own (PERF.md)
    left = ["tests/test_torch_cuda.py::"
            "test_data_parallel_full_width_is_float_order"]
    if torch.cuda.device_count() < 2:
        left.append("tests/test_torch_cuda.py::test_nccl_across_cards")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q",
         "-p", "no:cacheprovider", "tests/test_torch_cuda.py",
         *(a for t in left for a in ("--deselect", t))],
        cwd=root, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(root)})
    summary = (proc.stdout.strip().splitlines() or [""])[-1]
    left_out = r", \d+ deselected"
    if proc.returncode != 0 or not re.fullmatch(
            rf"=* *\d+ passed{left_out}(, \d+ warnings?)? in .*", summary):
        raise Fail(f"phase 9: tests/test_torch_cuda.py: {summary}\n"
                   f"{proc.stdout[-4000:]}{proc.stderr[-2000:]}")
    print(f"phase 9: tests/test_torch_cuda.py on the card: {summary} {tag}",
          flush=True)


def eval_image(rs, H, W, index, P=P, C=20):
    """A u8 (H, W, 3) image drawn from ``rs`` and its record: P VOC-like
    proposals (log-uniform sides, inside the image, XYXY, objectness
    descending) and 1-3 GT boxes of random classes."""
    image = rs.randint(0, 256, (H, W, 3)).astype(np.uint8)
    w = np.exp(rs.uniform(np.log(8), np.log(W), P))
    h = np.clip(w * np.exp(rs.uniform(-1, 1, P)), 8, H)
    x1 = rs.uniform(0, W - w)
    y1 = rs.uniform(0, H - h)
    boxes = np.stack([x1, y1, x1 + w - 1, y1 + h - 1], 1).astype(np.float32)
    gt = []
    for _ in range(rs.randint(1, 4)):
        i = rs.randint(P)
        gt.append({"category_id": int(rs.randint(C)),
                   "bbox": [float(v) for v in boxes[i]], "difficult": 0})
    return image, {
        "image_id": f"{index:06d}", "height": H, "width": W,
        "proposal_boxes": boxes,
        "proposal_objectness_logits": np.sort(
            rs.uniform(-1, 1, P)).astype(np.float32)[::-1].copy(),
        "annotations": gt}


def view_build_ms(tta, image, record, bucket: int) -> dict:
    """Device ms of one bucket group's view build alone (median of 5 calls
    each): ``_device_view_batch`` whole, and one view's ``scale_linear``
    (the resize's two float32 products) and ``weight_mat`` pair."""
    from drn_wsod_torch import tta as tta_mod
    from drn_wsod_torch.ops.resize import scale_linear, weight_mat

    dev = tta.device
    H0, W0 = image.shape[:2]
    rb = int(np.ceil(max(H0, W0) / 256) * 256)
    raw = torch.from_numpy(np.pad(image, ((0, rb - H0), (0, rb - W0),
                                          (0, 0)), mode="edge")).to(dev)
    views = tta.groups((H0, W0))[bucket]
    P = tta.num_proposals
    boxes = torch.zeros(P, 4, device=dev)
    mask = torch.ones(P, dtype=torch.bool, device=dev)
    nh, nw, _ = views[0]
    sy = torch.full((), nh / H0, device=dev)
    sx = torch.full((), nw / W0, device=dev)
    rawf = raw.float()
    return {
        f"_device_view_batch ({len(views)} views)": cuda_ms(
            lambda: tta_mod._device_view_batch(
                raw, (H0, W0), [(h, w) for h, w, _ in views],
                [f for _, _, f in views], bucket, boxes, mask,
                torch.zeros(P, device=dev), torch.zeros(20, device=dev)), 5),
        "scale_linear (one view)": cuda_ms(
            lambda: scale_linear(rawf, (bucket, bucket), sy, sx), 5),
        "weight_mat pair (one view)": cuda_ms(
            lambda: (weight_mat(rb, bucket, sy), weight_mat(rb, bucket, sx)),
            5)}


def phase10_eval(dev, gen, tag) -> dict:
    """The flagship's own eval protocol (TTA-AVG over 8 scales x flip, one
    NMS, VOC AP and CorLoc) through ``GeneralizedRCNNWithTTAAVG.
    detect_image`` at full width on VOC-sized images: per image ms by CUDA
    events and the host clock, views, groups, K1 launches (one per group),
    then a per-part split of each timed image, K1 against its plain version
    on the largest group's own inputs, and the evaluator's metrics."""
    import drn_wsod_torch
    from drn_wsod_torch.data.datasets.voc import VOC_CLASS_NAMES
    from drn_wsod_torch.models import meta_arch
    from drn_wsod_torch.ops import roi_pool as rp
    from drn_wsod_torch.tools import ablate_bench

    cfg = ablate_bench.flagship_cfg()
    aug = cfg.TEST.AUG
    if not (aug.ENABLED and aug.DEVICE_VIEWS and aug.FLIP
            and len(aug.MIN_SIZES) == 8 and aug.MAX_SIZE == 4000):
        raise Fail(f"phase 10: the flagship's TEST.AUG is not its YAML's: "
                   f"{aug}")
    model = drn_wsod_torch.build_model(cfg, device=dev, generator=gen)
    tta = drn_wsod_torch.GeneralizedRCNNWithTTAAVG(cfg, model, device=dev)
    C = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    topk = cfg.TEST.DETECTIONS_PER_IMAGE
    rs = np.random.RandomState(7)
    images = [eval_image(rs, H, W, i) for i, (H, W) in
              enumerate(EVAL_SIZES[:EVAL_WARMUP] + EVAL_SIZES)]
    groups = {}
    for image, record in images:
        groups[record["image_id"]] = {
            b: len(v) for b, v in tta.groups(image.shape[:2]).items()}
    if groups["000000"] != {704: 2, 896: 4, 1216: 4, 1280: 2, 1408: 2,
                            1536: 2}:
        raise Fail(f"phase 10: 500x375 groups {groups['000000']}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    rows, outs = [], []
    with ClockSampler() as clock_sampler:
        for image, record in images:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            before = rp.roi_pool_batched.launches
            t = time.perf_counter()
            start.record()
            outs.append(tta.detect_image(image, record))
            end.record()
            end.synchronize()
            rows.append(((time.perf_counter() - t) * 1e3,
                         start.elapsed_time(end),
                         rp.roi_pool_batched.launches - before))
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        # the per-part split runs after the count is read: its hooks make
        # these images differ from a caller's
        parts = [split_tta(model, tta, *im) for im in images[EVAL_WARMUP:]]

    for (image, record), (_, _, k1), dets in zip(images, rows, outs):
        H, W = image.shape[:2]
        n_groups = len(groups[record["image_id"]])
        if k1 != n_groups:
            raise Fail(f"phase 10: image {record['image_id']} ({W}x{H}): "
                       f"K1 launched {k1} times for {n_groups} groups")
        b, v = dets["boxes"], dets["valid"]
        if ({k: a.shape for k, a in dets.items()} != {
                "boxes": (topk, 4), "scores": (topk,), "classes": (topk,),
                "valid": (topk,), "all_scores": (P, C + 1),
                "all_boxes": (P, 4)}
                or not all(np.isfinite(a.astype(np.float64)).all()
                           for a in dets.values())
                or not v.any() or (b[v] < 0).any()
                or (b[v][:, [0, 2]] > W).any() or (b[v][:, [1, 3]] > H).any()
                or (dets["classes"][v] >= C).any()):
            raise Fail(f"phase 10: image {record['image_id']} ({W}x{H}): "
                       "detections not finite, empty or outside the image")
    if launches["roi_pool"] != sum(r[2] for r in rows):
        raise Fail(f"phase 10: launches {launches}")

    evaluator = drn_wsod_torch.PascalVOCDetectionEvaluator(
        VOC_CLASS_NAMES, {r["image_id"]: r["annotations"]
                          for _, r in images[EVAL_WARMUP:]}, 2007)
    for (_, record), dets in zip(images[EVAL_WARMUP:], outs[EVAL_WARMUP:]):
        evaluator.process_single(record["image_id"], dets["boxes"],
                                 dets["scores"], dets["classes"],
                                 dets["valid"])
    res = evaluator.evaluate()
    metrics = {**{k: res["bbox"][k] for k in ("AP", "AP50", "AP75")},
               **{k: res["bbox CorLoc"][k] for k in ("CL", "CL50", "CL75")}}
    if not all(math.isfinite(x) and 0.0 <= x <= 100.0
               for x in metrics.values()):
        raise Fail(f"phase 10: evaluator metrics {metrics}")

    # K1 on the largest group's own inputs: the 500x375 image's 1216 bucket
    # (the larger of its two 4-view groups; 2048-channel bf16 maps, the
    # views' own proposals)
    captured = {}
    pool = meta_arch.roi_pool_batched

    def capture(feats, boxes, spatial_scale, R, roi_scale):
        if feats.shape[0] == 4:
            captured[feats.shape[1]] = (feats.clone(), boxes.clone(),
                                        roi_scale.clone())
        return pool(feats, boxes, spatial_scale, R, roi_scale)

    meta_arch.roi_pool_batched = capture
    try:
        tta.detect_image(*images[0])
    finally:
        meta_arch.roi_pool_batched = pool
    feats, boxes, scale = captured[max(captured)]

    def k1():
        return rp.roi_pool_batched(feats, boxes, 0.125, 7, scale)

    def plain():
        return rp.roi_pool_plain(feats, boxes, 0.125, 7, scale)

    got = k1()
    torch.cuda.synchronize()
    err = exact("roi_pool at the 1216 TTA group", got, plain(), phase=10)
    ms, plain_ms = queued_ms(k1, 20), cuda_ms(plain, 3)
    bound_ms, bound_by = roi_pool_bound(feats, boxes, scale, got, 0.125)
    k1_shape = (tuple(feats.shape), tuple(boxes.shape))
    del got, captured, feats
    views_ms = view_build_ms(tta, *images[0], 1216)

    timed = rows[EVAL_WARMUP:]
    for (image, record), (host, device, k1n), (dev_p, host_p) in zip(
            images[EVAL_WARMUP:], timed, parts):
        H, W = image.shape[:2]
        g = groups[record["image_id"]]
        print(f"phase 10: image {record['image_id']} {W}x{H}: "
              f"{sum(g.values())} views in {len(g)} groups "
              f"{json.dumps(g)}, K1 launches {k1n}; {device:.3f} ms by CUDA "
              f"events, {host:.3f} ms by the host clock; split (hooked "
              "run), device ms: " + ", ".join(
                  f"{k} {v:.3f}" for k, v in dev_p.items())
              + f" (sum {sum(dev_p.values()):.3f}); host-issue ms: "
              + ", ".join(f"{k} {v:.3f}" for k, v in host_p.items())
              + f" {tag}", flush=True)
    dev_ms = [r[1] for r in timed]
    host_ms = [r[0] for r in timed]
    med = {k: statistics.median(p[0][k] for p in parts) for k in parts[0][0]}
    print(f"phase 10: {len(images)} images ({EVAL_WARMUP} warm-up) through "
          f"GeneralizedRCNNWithTTAAVG.detect_image, flagship at full width "
          f"(R50-WS DC5, DAN [2048, 4096], 3 OICR branches, bf16, seeded "
          f"random weights), TTA-AVG {len(aug.MIN_SIZES)} scales x flip, "
          f"MAX_SIZE {aug.MAX_SIZE}, views on the device, P={P}, "
          f"{topk} detections per image; launches {launches} (K1 once per "
          f"group: {sum(r[2] for r in rows)} for "
          f"{sum(len(g) for g in groups.values())} groups); detections "
          f"finite and inside their images", flush=True)
    print(f"phase 10: ms per image over the {len(timed)} timed images: by "
          f"CUDA events median {statistics.median(dev_ms):.3f}, mean "
          f"{statistics.mean(dev_ms):.3f} (min {min(dev_ms):.3f}, max "
          f"{max(dev_ms):.3f}); by the host clock median "
          f"{statistics.median(host_ms):.3f}, mean "
          f"{statistics.mean(host_ms):.3f}; warm-up "
          f"{', '.join(f'{r[1]:.3f}' for r in rows[:EVAL_WARMUP])} ms; "
          f"peak device memory {peak / 2**30:.2f} GiB; device ms per part, "
          f"median over the timed images: "
          + ", ".join(f"{k} {v:.3f}" for k, v in med.items()) + f" {tag}",
          flush=True)
    print(f"phase 10: roi_pool kernel == plain (max|diff| {err}) on the "
          f"1216 group's own inputs (the 500x375 image's 4 views: map "
          f"{k1_shape[0]} bf16, boxes {k1_shape[1]}): kernel {ms:.4f} ms "
          f"queued, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) {tag}",
          flush=True)
    print(f"phase 10: view build alone, the 500x375 image's 1216 group ("
          f"raw image edge-padded to 512x512), ms by CUDA events: "
          + ", ".join(f"{k} {v:.4f}" for k, v in views_ms.items())
          + f" {tag}", flush=True)
    print(f"phase 10: VOC evaluator on the {len(timed)} timed images: "
          + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items())
          + " (finite, in [0, 100]; random weights and synthetic GT: the "
          "values mean nothing)", flush=True)
    print(f"phase 10: card during the images: {clock_sampler.summary} {tag}",
          flush=True)
    return launches


# ------------------------------------------------------------- phase 11
PH11_TRAIN, PH11_TEST, PH11_PROPOSALS = 24, 4, 4500
PH11_STEPS, PH11_RESUMED, PH11_CKPT, PH11_PREDICTS = 16, 24, 8, 4


def entry_logger(output_dir=None, name="drn_wsod_torch", distributed_rank=0):
    """``default_setup``'s logger, writing to OUTPUT_DIR/log.txt only (this
    script's own process is rank 0 of 1)."""
    import logging

    logging.basicConfig(
        level=logging.INFO, force=True,
        format="[%(asctime)s %(name)s]: %(message)s",
        handlers=[logging.FileHandler(os.path.join(output_dir, "log.txt"))])
    return logging.getLogger(name)


def close_logging():
    import logging

    for handler in logging.getLogger().handlers[:]:
        logging.getLogger().removeHandler(handler)
        handler.close()


def tta_group_count(cfg, hw: dict) -> int:
    """K1 launches of a TTA eval of the images of sizes ``hw``: one per
    bucket group of each image's views."""
    from drn_wsod_torch.data import pick_bucket
    from drn_wsod_torch.tta import enumerate_views

    return sum(len({pick_bucket(nh, nw, cfg.INPUT.BUCKETS)
                    for nh, nw, _ in enumerate_views(
                        v, cfg.TEST.AUG.MIN_SIZES, cfg.TEST.AUG.MAX_SIZE,
                        cfg.TEST.AUG.FLIP)})
               for v in hw.values())


def ph11_dataset(root: Path, name: str, sizes, rs, start: int):
    """Draw ``sizes`` VOC-like records (phase 10's ``eval_image``: u8 BGR
    pixels, PH11_PROPOSALS proposals, 1-3 GT boxes of random VOC classes),
    pack them with the port's ``pack_dataset`` (pixels in, proposals out),
    write their proposals as a Detectron2 pickle, and register the shard in
    the port's ``DatasetCatalog`` with VOC metadata. Returns the pickle's
    path and {image_id: (H, W)}."""
    import pickle

    from drn_wsod_torch.data import pack_dataset

    records, props = [], {"ids": [], "boxes": [], "objectness_logits": [],
                          "bbox_mode": 0}
    for i, (H, W) in enumerate(sizes):
        image, rec = eval_image(rs, H, W, start + i, P=PH11_PROPOSALS)
        records.append({"file_name": f"{name}/{rec['image_id']}.jpg",
                        "image_id": rec["image_id"], "height": H, "width": W,
                        "annotations": rec["annotations"], "image": image})
        props["ids"].append(rec["image_id"])
        props["boxes"].append(rec["proposal_boxes"])
        props["objectness_logits"].append(rec["proposal_objectness_logits"])
    shard = root / f"{name}.rec"
    pack_dataset(records, str(shard))
    prop_file = root / f"{name}_proposals.pkl"
    with open(prop_file, "wb") as f:
        pickle.dump(props, f)
    register_shard(name, shard)
    return str(prop_file), {r["image_id"]: (r["height"], r["width"])
                            for r in records}


def register_shard(name: str, shard: Path) -> None:
    """Register a packed VOC-like shard in the port's ``DatasetCatalog``
    with VOC metadata (the rank processes of phase 27 register the parent's
    shards again)."""
    from drn_wsod_torch.data import (DatasetCatalog, MetadataCatalog,
                                     RecordDataset)
    from drn_wsod_torch.data.datasets.voc import VOC_CLASS_NAMES

    if name in DatasetCatalog:
        DatasetCatalog.remove(name)
    DatasetCatalog.register(name, lambda: list(RecordDataset(str(shard))))
    MetadataCatalog.get(name).set(thing_classes=list(VOC_CLASS_NAMES),
                                  evaluator_type="pascal_voc", year=2007,
                                  split=name)


def phase11_train_entry(dev, tag) -> dict:
    """The flagship's training entry point at full width through
    ``drn_wsod_torch.tools.train_net.main``: (a) 16 steps from scratch on a
    packed shard of 24 synthetic VOC-sized records, then the TTA eval of the
    test and train sets; (c) ``--eval-only --resume`` without TTA (the test
    loader) on the checkpoint of step 16; (b) ``--resume`` to 24 steps,
    then the TTA eval; (d) ``DefaultPredictor`` on one 500x375 image."""
    import shutil

    import drn_wsod_torch
    from drn_wsod_torch.checkpoint import Checkpointer
    from drn_wsod_torch.engine import defaults
    from drn_wsod_torch.engine import trainer as trainer_lib
    from drn_wsod_torch.evaluation import voc_eval
    from drn_wsod_torch.models import meta_arch
    from drn_wsod_torch.ops import roi_pool as rp
    from drn_wsod_torch.solver.build import build_lr_schedule
    from drn_wsod_torch.tools import train_net

    t_phase = time.perf_counter()
    here = Path(__file__).resolve().parent
    yaml = here / "configs" / "PascalVOC-Detection" / "oicr_WSR_50_DC5_1x.yaml"
    work = here / "build" / "chip_smoke_phase11"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    out = work / "output"
    rs = np.random.RandomState(11)
    train_sizes = [EVAL_SIZES[i % len(EVAL_SIZES)] for i in range(PH11_TRAIN)]
    test_sizes = list(EVAL_SIZES[:PH11_TEST])
    train_props, train_hw = ph11_dataset(work, "ph11_train", train_sizes, rs,
                                         0)
    test_props, test_hw = ph11_dataset(work, "ph11_test", test_sizes, rs,
                                       100)
    hw = {**train_hw, **test_hw}
    opts = ["DATASETS.TRAIN", "('ph11_train',)",
            "DATASETS.TEST", "('ph11_test',)",
            "DATASETS.PROPOSAL_FILES_TRAIN", repr((train_props,)),
            "DATASETS.PROPOSAL_FILES_TEST", repr((test_props,)),
            "MODEL.WEIGHTS", "", "OUTPUT_DIR", str(out), "SEED", "0",
            "SOLVER.CHECKPOINT_PERIOD", str(PH11_CKPT),
            "TEST.EVAL_PERIOD", "0"]
    cfg = drn_wsod_torch.get_cfg()
    cfg.merge_from_file(str(yaml))
    cfg.merge_from_list(opts + ["SOLVER.MAX_ITER", str(PH11_STEPS)])
    if not (cfg.SOLVER.IMS_PER_BATCH == 4 and cfg.INPUT.CROP.ENABLED
            and len(cfg.INPUT.MIN_SIZE_TRAIN) == 24
            and cfg.INPUT.MAX_SIZE_TRAIN == 2000
            and cfg.INPUT.RANDOM_FLIP != "none"
            and list(cfg.MODEL.ROI_BOX_HEAD.DAN_DIM) == [2048, 4096]
            and cfg.MODEL.ROI_BOX_HEAD.DROPOUT == 0.5
            and cfg.TEST.AUG.ENABLED and cfg.TEST.EVAL_TRAIN):
        raise Fail(f"phase 11: the flagship YAML is not as expected: "
                   f"{cfg.SOLVER.IMS_PER_BATCH} {cfg.INPUT}")
    sched = build_lr_schedule(cfg)
    k = train_net.steps_per_dispatch(cfg)

    tta_launches = tta_group_count(cfg, hw)
    steps, resumed, starts, dets, bad = [], {}, {}, [], []
    captured = {}
    run = {"name": ""}

    make_step = trainer_lib.make_train_step

    def timed_make_step(*a, **kw):
        step = make_step(*a, **kw)

        def timed(state, batch, seed):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out_ = step(state, batch, seed)
            end.record()
            # the step's metrics stay on the card until the phase reads them
            steps.append((run["name"], int(batch.image.shape[1]), start, end,
                          out_[1]))
            return out_
        return timed

    resume_or_load = Checkpointer.resume_or_load

    def checked_resume(self, state, *a, **kw):
        state, start = resume_or_load(self, state, *a, **kw)
        starts[run["name"]] = start
        if run["name"] == "b":
            saved = torch.load(self.path(PH11_STEPS), map_location=dev,
                               weights_only=True)
            sd = state.model.state_dict()
            resumed["params"] = all(torch.equal(sd[n], t)
                                    for n, t in saved["model"].items())
            resumed["momentum"] = all(
                torch.equal(state.opt_state["trace"][n], t)
                for n, t in saved["opt_state"]["trace"].items()
                if t is not None)
            resumed["tensors"] = len(saved["model"]) + len(
                saved["opt_state"]["trace"])
            resumed["step"], resumed["start"] = state.step, start
            resumed["saved_step"] = saved["step"]
            del saved
        return state, start

    process = voc_eval.PascalVOCDetectionEvaluator.process_single

    def checked_process(self, image_id, boxes, scores, classes, valid):
        H, W = hw[image_id]
        b, v = np.asarray(boxes), np.asarray(valid)
        finite = all(np.isfinite(np.asarray(a, np.float64)).all()
                     for a in (boxes, scores, classes))
        inside = not ((b[v] < 0).any() or (b[v][:, [0, 2]] > W).any()
                      or (b[v][:, [1, 3]] > H).any()
                      or (np.asarray(classes)[v] >= 20).any())
        dets.append((run["name"], image_id, int(v.sum())))
        if not (finite and inside):
            bad.append((run["name"], image_id, finite, inside, int(v.sum())))
        return process(self, image_id, boxes, scores, classes, valid)

    pool = meta_arch.roi_pool_batched

    def capture(feats, boxes, spatial_scale, R, roi_scale):
        if run["name"] in ("a", "b") and torch.is_grad_enabled() and \
                feats.shape[1] > captured.get("side", 0):
            captured.update(side=feats.shape[1], feats=feats.clone(),
                            boxes=boxes.clone(), scale=roi_scale.clone())
        return pool(feats, boxes, spatial_scale, R, roi_scale)

    peaks = {}

    def main_run(name, extra):
        run["name"] = name
        args = train_net.argument_parser().parse_args(
            ["--config-file", str(yaml), *extra])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = rp.roi_pool_batched.launches
        t = time.perf_counter()
        results = train_net.main(args, device=dev)
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated()
        return (results, rp.roi_pool_batched.launches - before,
                time.perf_counter() - t)

    torch.cuda.synchronize()
    reset_launches()
    with contextlib.ExitStack() as patches, ClockSampler() as clock_sampler:
        for obj, name, new in (
                (defaults, "setup_logger", entry_logger),
                (trainer_lib, "make_train_step", timed_make_step),
                (Checkpointer, "resume_or_load", checked_resume),
                (voc_eval.PascalVOCDetectionEvaluator, "process_single",
                 checked_process),
                (meta_arch, "roi_pool_batched", capture)):
            patches.enter_context(mock.patch.object(obj, name, new))
        res_a, k1_a, s_a = main_run(
            "a", [*opts, "SOLVER.MAX_ITER", str(PH11_STEPS)])
        ck = Checkpointer(str(out / "checkpoints"))
        ckpts_a = ck.all_steps()
        # (c) before (b): the test loader on the checkpoint of step 16
        res_c, k1_c, s_c = main_run(
            "c", ["--eval-only", "--resume", *opts, "SOLVER.MAX_ITER",
                  str(PH11_STEPS), "TEST.AUG.ENABLED", "False"])
        res_b, k1_b, s_b = main_run(
            "b", ["--resume", *opts, "SOLVER.MAX_ITER", str(PH11_RESUMED)])
        ckpts_b = ck.all_steps()
        # (d) DefaultPredictor on one 500x375 image with 4096 proposals
        run["name"] = "d"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        image, record = eval_image(np.random.RandomState(12), 375, 500, 900)
        predictor = drn_wsod_torch.DefaultPredictor(cfg, device=dev)
        before = rp.roi_pool_batched.launches
        pred = predictor(image, record["proposal_boxes"],
                         record["proposal_objectness_logits"])
        t = time.perf_counter()
        for _ in range(PH11_PREDICTS - 1):
            predictor(image, record["proposal_boxes"],
                      record["proposal_objectness_logits"])
        pred_ms = (time.perf_counter() - t) / (PH11_PREDICTS - 1) * 1e3
        k1_d = rp.roi_pool_batched.launches - before
        del predictor
        launches = read_launches()
        peaks["d"] = torch.cuda.max_memory_allocated()
    close_logging()
    torch.cuda.empty_cache()

    # ---- checks
    with open(out / "metrics.json") as f:
        lines = [json.loads(line) for line in f]
    losses = [(m["iteration"], k, v) for m in lines for k, v in m.items()
              if "loss" in k]
    if not losses or not all(math.isfinite(v) for _, _, v in losses):
        raise Fail(f"phase 11: losses not finite in metrics.json: {losses}")
    lr_bad = [(m["iteration"], m.get("lr")) for m in lines
              if m.get("lr") not in (sched(m["iteration"]),
                                     sched(m["iteration"] - 1))]
    if lr_bad or not any("lr" in m for m in lines):
        raise Fail(f"phase 11: lr in storage not the schedule's: {lr_bad}")
    n_eval = len(hw)
    want = {"a": PH11_STEPS + tta_launches,
            "b": PH11_RESUMED - PH11_STEPS + tta_launches,
            "c": n_eval, "d": PH11_PREDICTS}
    got = {"a": k1_a, "b": k1_b, "c": k1_c, "d": k1_d}
    if got != want or launches["roi_pool"] != sum(want.values()):
        raise Fail(f"phase 11: K1 launches {got}, want {want} (one per "
                   f"step plus one per TTA group or test-loader image); "
                   f"{launches}")
    step_runs = [r for r, *_ in steps]
    # each step's losses, read back once the runs are over
    step_losses = [{k: float(v) for k, v in m.items()}
                   for *_, m in steps]
    if step_runs != ["a"] * PH11_STEPS + \
            ["b"] * (PH11_RESUMED - PH11_STEPS):
        raise Fail(f"phase 11: train steps {step_runs}")
    if ckpts_a != [PH11_CKPT, PH11_STEPS] or \
            ckpts_b != [PH11_CKPT, PH11_STEPS, PH11_RESUMED]:
        raise Fail(f"phase 11: checkpoints {ckpts_a} after (a), {ckpts_b} "
                   f"after (b)")
    if not (resumed.get("params") and resumed.get("momentum")
            and resumed["step"] == resumed["start"] == resumed["saved_step"]
            == PH11_STEPS):
        raise Fail(f"phase 11: the resumed state is not the one saved at "
                   f"{PH11_STEPS}: {resumed}")
    if starts != {"a": 0, "c": PH11_STEPS, "b": PH11_STEPS}:
        raise Fail(f"phase 11: resume_or_load started the runs at {starts}")
    if bad or len(dets) != 3 * n_eval:
        raise Fail(f"phase 11: detections not finite or outside their "
                   f"images (run, image, finite, inside, detections): "
                   f"{bad}; {len(dets)} images evaluated")
    kept = {r: [n for rr, _, n in dets if rr == r] for r in "acb"}
    # (a) and (c) evaluate the weights of step 16, with TTA and through the
    # test loader: every image keeps at least one detection
    empty = {r: [i for rr, i, n in dets if rr == r and n == 0] for r in "ac"}
    if any(empty.values()):
        raise Fail(f"phase 11: images with no detection on the weights of "
                   f"step {PH11_STEPS}: {empty}")
    pb = pred["boxes"]
    if (not len(pb) or not all(np.isfinite(np.asarray(v, np.float64)).all()
                               for v in pred.values())
            or (pb < 0).any() or (pb[:, [0, 2]] > 500).any()
            or (pb[:, [1, 3]] > 375).any()):
        raise Fail(f"phase 11: DefaultPredictor detections {pred}")
    metrics = {}
    for r, res in (("a", res_a), ("b", res_b), ("c", res_c)):
        for ds, tasks in res.items():
            for task in ("bbox", "bbox CorLoc"):
                for key in ("AP50", "CL50"):
                    if key in tasks[task]:
                        metrics[f"{r}/{ds}/{key}"] = tasks[task][key]
    if not all(math.isfinite(v) and 0.0 <= v <= 100.0
               for v in metrics.values()) or len(metrics) != 12:
        raise Fail(f"phase 11: evaluator metrics {metrics}")

    # K1 at the largest map the train steps gave it
    feats, boxes, scale = (captured[k] for k in ("feats", "boxes", "scale"))

    def k1():
        return rp.roi_pool_batched(feats, boxes, 0.125, 7, scale)

    def plain():
        return rp.roi_pool_plain(feats, boxes, 0.125, 7, scale)

    k1_out = k1()
    torch.cuda.synchronize()
    err = exact(f"roi_pool at the train step's {captured['side']}^2 map",
                k1_out, plain(), phase=11)
    k1_ms, plain_ms = queued_ms(k1, 10), cuda_ms(plain, 2)
    bound_ms, bound_by = roi_pool_bound(feats, boxes, scale, k1_out, 0.125)
    k1_shape = (tuple(feats.shape), tuple(boxes.shape))
    del k1_out, captured, feats
    torch.cuda.empty_cache()

    # ---- records
    tb = "left out (no tensorboard package)" if "TensorboardWriter left " \
        "out" in (out / "log.txt").read_text() else "written"
    by_bucket = {}
    for r, bucket, start, end, _ in steps:
        by_bucket.setdefault(bucket, []).append((r, start.elapsed_time(end)))
    ims = cfg.SOLVER.IMS_PER_BATCH
    for r, n in (("a", PH11_STEPS), ("b", PH11_RESUMED - PH11_STEPS)):
        per_step = [(bucket, s.elapsed_time(e), loss)
                    for (rr, bucket, s, e, _), loss in zip(steps, step_losses)
                    if rr == r]
        # IterationTimer's fenced time and the loop's wait for a chunk, as
        # the JSONWriter wrote them: each the median of its values put so far
        # (time after every step past the warm-up, data_time at each read-back).
        # A chunk's time runs from its call to its read-back, after the wait,
        # so the loop spends time + data_time a step
        writes = [m for m in lines if "time" in m and "data_time" in m
                  and (m["iteration"] <= PH11_STEPS) == (r == "a")]
        print(f"phase 11: run ({r}) {n} steps of B={ims}, {k}-step chunks; "
              f"metrics.json, smoothed as written (iteration: IterationTimer "
              f"s/step, steps/s, img/s, data_time s, its share of the loop's "
              f"time + data_time): " + ", ".join(
                  f"{m['iteration']}: {m['time']:.4f}, {1 / m['time']:.3f}, "
                  f"{ims / m['time']:.3f}, {m['data_time']:.4f}, "
                  f"{100 * m['data_time'] / (m['time'] + m['data_time']):.1f}%"
                  for m in writes)
              + "; per step (bucket, device ms by CUDA events, total_loss, "
              "largest term): " + ", ".join(
                  f"({b}, {v:.1f}, {loss['total_loss']:.4g}, "
                  + max(((t, x) for t, x in loss.items()
                         if t != "total_loss"), key=lambda tx: tx[1])[0]
                  + ")" for b, v, loss in per_step)
              + f" (device sum {sum(v for _, v, _ in per_step):.1f} ms) "
              f"{tag}", flush=True)
    first_vs_rerun = {
        b: (v[0][1], statistics.median([t for _, t in v[1:]]) if v[1:]
            else None, len(v))
        for b, v in sorted(by_bucket.items())}
    print("phase 11: buckets met (steps at each), the first step's device "
          "ms against the median of its reruns: " + ", ".join(
              f"{b}: {n} steps, first {f:.1f}"
              + (f" vs {m:.1f}" if m is not None else "")
              for b, (f, m, n) in first_vs_rerun.items()) + f" {tag}",
          flush=True)
    print(f"phase 11: main wall s: (a) train + TTA eval {s_a:.3f}, (c) "
          f"test-loader eval {s_c:.3f}, (b) resume + TTA eval {s_b:.3f}; "
          f"DefaultPredictor {pred_ms:.3f} ms per 500x375 image with "
          f"4096 proposals (host clock, {PH11_PREDICTS - 1} calls after the "
          f"first), {len(pb)} detections; peak device memory GiB "
          + ", ".join(f"({r}) {v / 2**30:.2f}" for r, v in peaks.items())
          + f" {tag}", flush=True)
    print(f"phase 11: roi_pool kernel == plain (max|diff| {err}) at the "
          f"train step's largest map (map {k1_shape[0]} bf16, boxes "
          f"{k1_shape[1]}): kernel {k1_ms:.4f} ms queued, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) {tag}",
          flush=True)
    print(f"phase 11: train_net.main (a) {PH11_STEPS} steps from scratch on "
          f"a packed shard of {PH11_TRAIN} records (flagship YAML at full "
          f"width: B={cfg.SOLVER.IMS_PER_BATCH}, crop "
          f"{cfg.INPUT.CROP.SIZE}, {len(cfg.INPUT.MIN_SIZE_TRAIN)} scales "
          f"{cfg.INPUT.MIN_SIZE_TRAIN[0]}-{cfg.INPUT.MIN_SIZE_TRAIN[-1]}, "
          f"MAX {cfg.INPUT.MAX_SIZE_TRAIN}, flip, DAN "
          f"{list(cfg.MODEL.ROI_BOX_HEAD.DAN_DIM)}, dropout "
          f"{cfg.MODEL.ROI_BOX_HEAD.DROPOUT}, seeded random weights) then "
          f"TTA eval; (c) --eval-only --resume through the test loader on "
          f"the checkpoint of {PH11_STEPS}; (b) --resume from "
          f"{resumed['start']} to {PH11_RESUMED} ({resumed['tensors']} "
          f"tensors and the step bit-equal to the checkpoint) then TTA "
          f"eval; (d) DefaultPredictor. K1 "
          f"launches {got} (one per step, per TTA group: {tta_launches} per "
          f"TTA eval of {n_eval} images, per test-loader image); "
          f"checkpoints {ckpts_b}; losses finite ({len(losses)} values in "
          f"metrics.json), lr the schedule's; detections finite and inside "
          f"their images, at least one an image in (a) and (c) "
          f"({len(dets)} image evaluations; detections above "
          f"SCORE_THRESH_TEST per run, total and images with none: "
          + ", ".join(f"({r}) {sum(n)} / {sum(x == 0 for x in n)}"
                      for r, n in kept.items())
          + f"); TensorBoard "
          f"{tb}; VOC metrics " + ", ".join(
              f"{key} {v:.4f}" for key, v in metrics.items())
          + " (random weights, synthetic GT: the values mean nothing); "
          f"phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    print(f"phase 11: card during the phase: {clock_sampler.summary} {tag}",
          flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return launches


# phases 12 and 13: records per shard, steps, the CSC switch
PH12_TRAIN, PH12_TEST, PH12_STEPS = 8, 4, 8
PH13_CSC_MAX_ITER, PH13_STEPS, PH13_B_STEPS = 2, 4, 2


def entry_setup(prefix: str, seed: int, n_train: int = PH12_TRAIN,
                n_test: int = PH12_TEST):
    """A fresh work directory under build/ with a packed train shard of
    ``n_train`` and a test shard of ``n_test`` synthetic VOC-sized records
    (``ph11_dataset``); returns (work dir, the CLI overrides naming them
    with ``MODEL.WEIGHTS ""``, OUTPUT_DIR, SEED 0 and EVAL_PERIOD 0, {id:
    (H, W)})."""
    import shutil

    here = Path(__file__).resolve().parent
    work = here / "build" / f"chip_smoke_{prefix}"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    rs = np.random.RandomState(seed)
    train_sizes = [EVAL_SIZES[i % len(EVAL_SIZES)] for i in range(n_train)]
    train_props, train_hw = ph11_dataset(work, f"{prefix}_train", train_sizes,
                                         rs, 0)
    test_props, test_hw = ph11_dataset(work, f"{prefix}_test",
                                       list(EVAL_SIZES[:n_test]), rs, 100)
    opts = ["DATASETS.TRAIN", f"('{prefix}_train',)",
            "DATASETS.TEST", f"('{prefix}_test',)",
            "DATASETS.PROPOSAL_FILES_TRAIN", repr((train_props,)),
            "DATASETS.PROPOSAL_FILES_TEST", repr((test_props,)),
            "MODEL.WEIGHTS", "", "OUTPUT_DIR", str(work / "output"),
            "SEED", "0", "TEST.EVAL_PERIOD", "0"]
    return work, opts, {**train_hw, **test_hw}


def detection_checker(hw: dict, dets: list, bad: list, evaluator=None,
                      num_classes: int = 20, dense: dict = None):
    """A ``process_single`` of ``evaluator`` (the VOC evaluator by
    default) that records (image, detections) in ``dets`` and, in ``bad``,
    every image whose detections are not finite, leave the image or name a
    class past ``num_classes``, then calls the evaluator's own. Where the
    loop passes ``masks`` (the COCO evaluator's segm task), each must be a
    bool (D, H, W) mask at the image's original size; where it passes
    ``keypoints``, each valid detection's (K, 3) keypoints must be finite,
    inside the image and scored in [0, 1]; ``dense`` counts them."""
    from drn_wsod_torch.evaluation import voc_eval

    process = (evaluator or voc_eval.PascalVOCDetectionEvaluator
               ).process_single
    dense = {} if dense is None else dense

    def checked(self, image_id, boxes, scores, classes, valid, masks=None,
                keypoints=None):
        H, W = hw[image_id]
        b, v = np.asarray(boxes), np.asarray(valid)
        finite = all(np.isfinite(np.asarray(a, np.float64)).all()
                     for a in (boxes, scores, classes))
        inside = not ((b[v] < 0).any() or (b[v][:, [0, 2]] > W).any()
                      or (b[v][:, [1, 3]] > H).any()
                      or (np.asarray(classes)[v] >= num_classes).any())
        kw = {}
        if masks is not None:
            m = np.asarray(masks)
            inside &= m.dtype == bool and m.shape == (len(v), H, W)
            dense["masks"] = dense.get("masks", 0) + int(v.sum())
            dense["mask_pixels"] = dense.get("mask_pixels", 0) + int(
                m[v].sum())
            kw["masks"] = masks
        if keypoints is not None:
            k = np.asarray(keypoints, np.float64)[v]
            finite &= bool(np.isfinite(k).all())
            inside &= bool((k[..., 0] >= 0).all() and (k[..., 0] <= W).all()
                           and (k[..., 1] >= 0).all()
                           and (k[..., 1] <= H).all()
                           and (k[..., 2] >= 0).all()
                           and (k[..., 2] <= 1).all())
            dense["keypoints"] = dense.get("keypoints", 0) + k.shape[0] * \
                k.shape[1]
            kw["keypoints"] = keypoints
        dets.append((image_id, int(v.sum())))
        if not (finite and inside):
            bad.append((image_id, finite, inside, int(v.sum())))
        return process(self, image_id, boxes, scores, classes, valid, **kw)

    return checked


def step_recorder(steps: list, kind: str, make):
    """Wrap a ``make_*_train_step`` so that each step appends (kind,
    bucket, start event, end event, metrics) to ``steps``."""
    def wrapped(*a, **kw):
        step = make(*a, **kw)

        def timed(state, batch, seed):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(state, batch, seed)
            end.record()
            steps.append((kind, int(batch.image.shape[1]), start, end,
                          out[1]))
            return out
        return timed
    return wrapped


def pcl_mining_diff(prev, props, mask, labels) -> list:
    """Classes whose 3-means boundary differs between the CPU and the card
    on the CPU path's pools: (class, the two (i, j) boundaries, the SSE
    each device computes at each)."""
    from drn_wsod_torch.ops import pcl as pcl_lib

    lines = []
    pv = prev.clamp(1e-9, 1.0 - 1e-9)
    consumed = torch.zeros_like(mask)
    for c in range(pv.shape[-1]):
        pool = mask & ~consumed
        best = {}
        for d in ("cpu", "cuda"):
            total = pcl_lib.kmeans3_sse(pv[..., c].to(d), pool.to(d))[0]
            flat = total.reshape(total.shape[0], -1)
            best[d] = (int(flat.argmin(-1)[0]), flat[0].cpu())
        if best["cpu"][0] != best["cuda"][0]:
            side = total.shape[-1]
            k = (best["cpu"][0], best["cuda"][0])
            lines.append(
                f"class {c}: boundaries (i, j) CPU {divmod(k[0], side)}, "
                f"card {divmod(k[1], side)}; SSE at both, CPU "
                f"{[float(best['cpu'][1][i]) for i in k]}, card "
                f"{[float(best['cuda'][1][i]) for i in k]}")
        _, _, _, picked = pcl_lib._class_graph_centers(pv[..., c], props,
                                                       pool, 32, 5, 0.4)
        consumed = consumed | (picked & (labels[:, c] > 0.5)[:, None])
    return lines


def split_pcl_step(model, tx, step, state, batch, seed):
    """Per-part device and host-issue ms of one PCL train step: PCL mining
    and the PCL loss summed over the 3 branches, the branch layers with
    the other head arithmetic."""
    from drn_wsod_torch.ops import pcl as pcl_lib

    marks = Marks()
    marks.hook(model, "forward_in", "forward_out")
    marks.hook(model.backbone, "backbone_in", "backbone_out")
    marks.hook(model.box_head, "dan_in", "dan_out")
    marks.hook(model.box_predictor, "wsddn_in", "wsddn_out")
    mine, loss, update = pcl_lib.mine_pcl_clusters, pcl_lib.pcl_loss, \
        tx.update

    def marked(fn, before, after):
        def run(*args, **kw):
            marks(before)()
            out = fn(*args, **kw)
            marks(after)()
            return out
        return run

    pcl_lib.mine_pcl_clusters = marked(mine, "mine_in", "mine_out")
    pcl_lib.pcl_loss = marked(loss, "loss_in", "loss_out")
    tx.update = marked(update, "update_in", "update_out")
    try:
        marks("step_in")()
        step(state, batch, seed)
        torch.cuda.synchronize()
    finally:
        pcl_lib.mine_pcl_clusters, pcl_lib.pcl_loss = mine, loss
        del tx.update
        marks.remove()
    return marks.split({
        "step_in": "set-up", "forward_in": "preprocess",
        "backbone_in": "backbone", "backbone_out": "K1", "dan_in": "DAN",
        "dan_out": "heads", "wsddn_in": "WSDDN", "wsddn_out": "heads",
        "mine_in": "PCL mining", "mine_out": "heads",
        "loss_in": "PCL loss", "loss_out": "heads",
        "forward_out": "backward", "update_in": "optimizer"})


def phase12_pcl(dev, tag) -> dict:
    """PCL (``pcl_WSR_50_DC5_1x.yaml``) through ``train_net.main`` at full
    width and depth: PH12_STEPS steps from seeded random weights on a
    packed shard, then the YAML's TTA eval; K1 once per step and per TTA
    group; the clusters mined on the card from one image of a step against
    the CPU path on the same tensors."""
    import shutil

    import drn_wsod_torch
    from drn_wsod_torch.engine import defaults
    from drn_wsod_torch.engine import trainer as trainer_lib
    from drn_wsod_torch.evaluation import voc_eval
    from drn_wsod_torch.ops import pcl as pcl_lib
    from drn_wsod_torch.tools import train_net

    t_phase = time.perf_counter()
    yaml = Path(__file__).resolve().parent / "configs" / \
        "PascalVOC-Detection" / "pcl_WSR_50_DC5_1x.yaml"
    work, opts, hw = entry_setup("ph12", 12)
    opts += ["SOLVER.MAX_ITER", str(PH12_STEPS),
             "SOLVER.CHECKPOINT_PERIOD", str(PH12_STEPS)]
    y = drn_wsod_torch.get_cfg()
    y.merge_from_file(str(yaml))
    if not (y.MODEL.ROI_HEADS.NAME == "PCLROIHeads"
            and y.MODEL.RESNETS.DEPTH == 50 and y.WSL.REFINE_NUM == 3
            and list(y.MODEL.ROI_BOX_HEAD.DAN_DIM) == [2048, 4096]
            and y.MODEL.ROI_BOX_HEAD.DROPOUT == 0.5
            and y.MODEL.DTYPE == "bfloat16"
            and y.SOLVER.IMS_PER_BATCH == 4 and y.INPUT.CROP.ENABLED
            and len(y.INPUT.MIN_SIZE_TRAIN) == 24
            and y.TEST.AUG.ENABLED and y.TEST.AUG.FLIP
            and len(y.TEST.AUG.MIN_SIZES) == 8):
        raise Fail(f"phase 12: the PCL YAML is not as expected: {y.MODEL}")
    cfg = y.clone()
    cfg.merge_from_list(opts)
    tta_launches = tta_group_count(cfg, hw) if cfg.TEST.EVAL_TRAIN else \
        tta_group_count(cfg, {k: v for k, v in hw.items()
                              if int(k) >= 100})
    steps, dets, bad, captured, split = [], [], [], {}, {}
    mine = pcl_lib.mine_pcl_clusters
    calls = {"mine": 0}

    def capturing(prev, props, mask, labels, **kw):
        # one image of step 4's first branch (scores past the first steps)
        if calls["mine"] == 3 * (PH12_STEPS // 2):
            i = int((labels > 0.5).sum(-1).argmax())
            captured.update({k: v[i:i + 1].detach().clone() for k, v in (
                ("prev", prev), ("props", props), ("mask", mask),
                ("labels", labels))})
        calls["mine"] += 1
        return mine(prev, props, mask, labels, **kw)

    record = step_recorder(steps, "plain", trainer_lib.make_train_step)

    def split_last(model, tx, *a, **kw):
        step = record(model, tx, *a, **kw)

        def run(state, batch, seed):
            if state.step == PH12_STEPS - 1:
                split["parts"] = split_pcl_step(model, tx, step, state,
                                                batch, seed)
                return state, steps[-1][4]
            return step(state, batch, seed)
        return run

    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as patches, ClockSampler() as clocks:
        for obj, name, new in (
                (defaults, "setup_logger", entry_logger),
                (trainer_lib, "make_train_step", split_last),
                (voc_eval.PascalVOCDetectionEvaluator, "process_single",
                 detection_checker(hw, dets, bad)),
                (pcl_lib, "mine_pcl_clusters", capturing)):
            patches.enter_context(mock.patch.object(obj, name, new))
        t = time.perf_counter()
        results = train_net.main(train_net.argument_parser().parse_args(
            ["--config-file", str(yaml), *opts]), device=dev)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
    close_logging()
    torch.cuda.empty_cache()

    # ---- checks
    step_losses = [{k: float(v) for k, v in m.items()} for *_, m in steps]
    names = {"loss_cls", "loss_cls_r0", "loss_cls_r1", "loss_cls_r2",
             "total_loss"}
    if len(steps) != PH12_STEPS or any(
            set(m) != names or not all(math.isfinite(v) for v in m.values())
            for m in step_losses):
        raise Fail(f"phase 12: step losses {step_losses}")
    with open(work / "output" / "metrics.json") as f:
        lines = [json.loads(line) for line in f]
    logged = [(m["iteration"], k, v) for m in lines for k, v in m.items()
              if k in names]
    if {k for _, k, _ in logged} != names or not all(
            math.isfinite(v) for _, _, v in logged):
        raise Fail(f"phase 12: losses in metrics.json {logged}")
    want = PH12_STEPS + tta_launches
    if launches["roi_pool"] != want:
        raise Fail(f"phase 12: K1 launches {launches['roi_pool']}, want "
                   f"{want} ({PH12_STEPS} steps + {tta_launches} TTA "
                   f"groups); {launches}")
    n_eval = len(hw) if cfg.TEST.EVAL_TRAIN else PH12_TEST
    if bad or len(dets) != n_eval:
        raise Fail(f"phase 12: detections (image, finite, inside, count) "
                   f"{bad}; {len(dets)} images evaluated, want {n_eval}")
    metrics = {f"{ds}/{key}": tasks[task][key]
               for ds, tasks in results.items()
               for task in ("bbox", "bbox CorLoc")
               for key in ("AP50", "CL50") if key in tasks[task]}
    if not metrics or not all(math.isfinite(v) and 0 <= v <= 100
                              for v in metrics.values()):
        raise Fail(f"phase 12: evaluator metrics {metrics}")
    # the clusters of one image on the card against the CPU path
    if not captured:
        raise Fail("phase 12: no mining call captured")
    args = [captured[k] for k in ("prev", "props", "mask", "labels")]
    t = time.perf_counter()
    on_cpu = mine(*(a.cpu() for a in args))
    cpu_s = time.perf_counter() - t
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    on_card = mine(*args)
    end.record()
    end.synchronize()
    card_ms = start.elapsed_time(end)
    same = {f: torch.equal(g.cpu(), c) for f, g, c in
            zip(on_cpu._fields, on_card, on_cpu)}
    n_present = int((captured["labels"] > 0.5).sum())
    n_centers = int(on_cpu.center_valid.sum())
    if not all(same.values()):
        diff = pcl_mining_diff(*(a.cpu() for a in args))
        print("phase 12: PCL mining on the card differs from the CPU path "
              f"({same}); per class: {diff or 'no 3-means boundary differs'}"
              f" {tag}", flush=True)

    # ---- records
    per_step = [(b, s.elapsed_time(e), m["total_loss"])
                for (_, b, s, e, _), m in zip(steps, step_losses)]
    device, host = split["parts"]
    print(f"phase 12: PCL train_net.main, {PH12_STEPS} steps of "
          f"B={cfg.SOLVER.IMS_PER_BATCH} (R50-WS DC5, DAN "
          f"{list(cfg.MODEL.ROI_BOX_HEAD.DAN_DIM)}, 3 PCL branches, "
          f"{cfg.MODEL.DTYPE}, dropout 0.5, crop, 24 scales, flip, "
          f"P={cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE}, seeded random "
          f"weights) on a packed shard of {PH12_TRAIN} records, then TTA eval "
          f"of {n_eval} images: per step (bucket, device ms by CUDA events, "
          "total_loss): " + ", ".join(f"({b}, {v:.1f}, {x:.4g})"
                                      for b, v, x in per_step)
          + f"; the last step split with hooks, device ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in device.items())
          + "; host-issue ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in host.items())
          + f"; main {main_s:.2f} s, peak device memory "
          f"{peak / 2**30:.2f} GiB {tag}", flush=True)
    print(f"phase 12: K1 launches {launches['roi_pool']} (one per step, "
          f"{tta_launches} TTA groups); detections finite and inside their "
          f"images ({len(dets)} images, {sum(n for _, n in dets)} "
          f"detections); VOC metrics " + ", ".join(
              f"{k} {v:.4f}" for k, v in metrics.items())
          + " (random weights: the values mean nothing); mining of one "
          f"image (P={args[0].shape[1]}, C={args[0].shape[2]}, "
          f"{n_present} present classes, {n_centers} centers) on the card "
          f"{'equals' if all(same.values()) else 'DIFFERS FROM'} the CPU "
          f"path ({same}): card {card_ms:.2f} ms, CPU {cpu_s:.2f} s; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    print(f"phase 12: card during the phase: {clocks.summary} {tag}",
          flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return launches


def split_csc_step(step, state, batch, tx):
    """Device ms of one CSC step split into the CPG pass (the scores and
    the C backward passes to the image), ``csc_forward``, the loss pass
    (forward and backward) and the optimizer; returns (parts, the CPG
    maps' per-map max (B, C), W, the contrasts (B * C, P), preds)."""
    from drn_wsod_torch.ops import csc as csc_lib

    events, seen = [], {}

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        events.append((name, e))

    cpg_fn, fwd_fn, pool_fn, update = (csc_lib.cpg_from_scores,
                                       csc_lib.csc_forward,
                                       csc_lib.csc_pool_class, tx.update)

    def cpg(scores, image, labels, preds, tau):
        out = cpg_fn(scores, image, labels, preds, tau)
        seen["cpg_max"], seen["preds"] = out.amax((2, 3)), preds
        seen["score_max"] = scores.detach().amax(1)
        mark("cpg_out")
        return out

    def fwd(*a, **kw):
        out = fwd_fn(*a, **kw)
        seen["W"] = out[0]
        mark("csc_out")
        return out

    def pool(*a, **kw):
        seen["contrast"] = pool_fn(*a, **kw)
        return seen["contrast"]

    def upd(*a):
        mark("update_in")
        update(*a)
        mark("update_out")

    csc_lib.cpg_from_scores, csc_lib.csc_forward = cpg, fwd
    csc_lib.csc_pool_class, tx.update = pool, upd
    try:
        mark("step_in")
        _, metrics = step(state, batch, 0)
        torch.cuda.synchronize()
    finally:
        csc_lib.cpg_from_scores, csc_lib.csc_forward = cpg_fn, fwd_fn
        csc_lib.csc_pool_class = pool_fn
        del tx.update
    names = dict(step_in="CPG pass", cpg_out="csc_forward",
                 csc_out="loss pass", update_in="optimizer")
    parts = {names[a]: ea.elapsed_time(eb)
             for (a, ea), (_, eb) in zip(events, events[1:]) if a in names}
    return parts, metrics, seen


def diff_pool_ms(model, batch) -> dict:
    """Device ms of the differentiable pool (forward, and forward plus the
    backward to the map) and of K1 on one batch's own map and proposals."""
    from drn_wsod_torch.ops import roi_pool as rp

    b = model.sanitize(batch)
    with torch.no_grad():
        feats = model.features(b.image.float())
    args = (b.proposals, b.proposal_mask, b.objectness)
    scale = (b.objectness + 1.0) * b.proposal_mask.to(b.objectness.dtype)

    def forward():
        with torch.no_grad():
            return model.pool(feats, *args)

    def backward():
        f = feats.detach().requires_grad_(True)
        return torch.autograd.grad(model.pool(f, *args).float().sum(), f)

    def k1():
        return rp.roi_pool_batched(feats, b.proposals.contiguous(),
                                   1.0 / model.feature_stride,
                                   model.pooler_resolution,
                                   scale.contiguous())

    out = {"map": tuple(feats.shape), "forward": cuda_ms(forward, 3),
           "backward": cuda_ms(backward, 3), "k1": cuda_ms(k1, 3)}
    del feats
    torch.cuda.empty_cache()
    return out


def phase13_csc(dev, tag) -> dict:
    """CSC (``csc_WSR_18_DC5_1x.yaml``) at full width and depth: (a)
    ``train_net.main`` with the CSC step through iteration
    PH13_CSC_MAX_ITER and the plain step after it, then the YAML's TTA
    eval, all through the differentiable pool (no K1 launch); the CPG maps
    are zero and W = 1, as the JAX package computes them at FREEZE_AT 5.
    (b) ``make_csc_train_step(tau=0)`` at FREEZE_AT 2 on loader batches:
    live maps, the frozen stem and res2 unchanged, res3-res5 and the
    heads moved."""
    import shutil

    import drn_wsod_torch
    from drn_wsod_torch.data import (DatasetMapper,
                                     build_detection_train_loader)
    from drn_wsod_torch.engine import defaults
    from drn_wsod_torch.engine import trainer as trainer_lib
    from drn_wsod_torch.evaluation import voc_eval
    from drn_wsod_torch.ops import csc as csc_lib
    from drn_wsod_torch.tools import train_net

    t_phase = time.perf_counter()
    yaml = Path(__file__).resolve().parent / "configs" / \
        "PascalVOC-Detection" / "csc_WSR_18_DC5_1x.yaml"
    work, opts, hw = entry_setup("ph13", 13)
    opts_a = opts + ["SOLVER.MAX_ITER", str(PH13_STEPS),
                     "SOLVER.CHECKPOINT_PERIOD", str(PH13_STEPS),
                     "WSL.CSC_MAX_ITER", str(PH13_CSC_MAX_ITER)]
    y = drn_wsod_torch.get_cfg()
    y.merge_from_file(str(yaml))
    if not (y.MODEL.ROI_HEADS.NAME == "CSCROIHeads"
            and y.MODEL.RESNETS.DEPTH == 18
            and list(y.MODEL.ROI_BOX_HEAD.DAN_DIM) == [512, 4096]
            and y.MODEL.BACKBONE.FREEZE_AT == 5
            and y.MODEL.DTYPE == "bfloat16"
            and y.SOLVER.IMS_PER_BATCH == 4 and y.TEST.AUG.ENABLED):
        raise Fail(f"phase 13: the CSC YAML is not as expected: {y.MODEL}")
    cfg = y.clone()
    cfg.merge_from_list(opts_a)
    steps, dets, bad, seen = [], [], [], []
    cpg_fn, fwd_fn = csc_lib.cpg_from_scores, csc_lib.csc_forward

    def cpg(scores, image, labels, preds, tau):
        out = cpg_fn(scores, image, labels, preds, tau)
        seen.append({"cpg_max": out.amax()})
        return out

    def fwd(cpgs, labels, preds, rois, mask, **kw):
        W, PL, NL = fwd_fn(cpgs, labels, preds, rois, mask, **kw)
        counted = (labels > 0.5)[:, None, :] & mask[..., None]
        seen[-1]["W_not_1"] = (counted & (W != 1.0)).sum()
        return W, PL, NL

    # (a) the YAML through train_net.main
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as patches, ClockSampler() as clocks:
        for obj, name, new in (
                (defaults, "setup_logger", entry_logger),
                (trainer_lib, "make_train_step", step_recorder(
                    steps, "plain", trainer_lib.make_train_step)),
                (trainer_lib, "make_csc_train_step", step_recorder(
                    steps, "csc", trainer_lib.make_csc_train_step)),
                (voc_eval.PascalVOCDetectionEvaluator, "process_single",
                 detection_checker(hw, dets, bad)),
                (csc_lib, "cpg_from_scores", cpg),
                (csc_lib, "csc_forward", fwd)):
            patches.enter_context(mock.patch.object(obj, name, new))
        t = time.perf_counter()
        results = train_net.main(train_net.argument_parser().parse_args(
            ["--config-file", str(yaml), *opts_a]), device=dev)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t
        launches = read_launches()
        peak_a = torch.cuda.max_memory_allocated()
    close_logging()
    step_losses = [{k: float(v) for k, v in m.items()} for *_, m in steps]
    kinds = [k for k, *_ in steps]
    want_kinds = ["csc"] * (PH13_CSC_MAX_ITER + 1) + ["plain"] * (
        PH13_STEPS - PH13_CSC_MAX_ITER - 1)
    if kinds != want_kinds:
        raise Fail(f"phase 13: (a) step kinds {kinds}, want {want_kinds}")
    for kind, m in zip(kinds, step_losses):
        need = ({"loss_cls_pos", "loss_cls_neg"} if kind == "csc"
                else {"loss_cls"})
        if not need <= set(m) or not all(math.isfinite(v)
                                         for v in m.values()):
            raise Fail(f"phase 13: (a) {kind} step losses {m}")
    zeros = [(float(x["cpg_max"]), int(x["W_not_1"])) for x in seen]
    if len(zeros) != PH13_CSC_MAX_ITER + 1 or any(z != (0.0, 0)
                                                  for z in zeros):
        raise Fail(f"phase 13: (a) CPG max and weights W != 1 per CSC step "
                   f"{zeros}: FREEZE_AT 5 stops the image gradient, so the "
                   "maps must be zero and W 1")
    if launches["roi_pool"] != 0:
        raise Fail(f"phase 13: (a) K1 launched {launches['roi_pool']} "
                   "times; CSC pools through the differentiable pool")
    n_eval = len(hw) if cfg.TEST.EVAL_TRAIN else PH12_TEST
    if bad or len(dets) != n_eval:
        raise Fail(f"phase 13: (a) detections (image, finite, inside, "
                   f"count) {bad}; {len(dets)} images evaluated")
    metrics = {f"{ds}/{key}": tasks[task][key]
               for ds, tasks in results.items()
               for task in ("bbox", "bbox CorLoc")
               for key in ("AP50", "CL50") if key in tasks[task]}
    if not metrics or not all(math.isfinite(v) and 0 <= v <= 100
                              for v in metrics.values()):
        raise Fail(f"phase 13: (a) evaluator metrics {metrics}")
    per_step = [(k, b, s.elapsed_time(e), m["total_loss"])
                for (k, b, s, e, _), m in zip(steps, step_losses)]
    print(f"phase 13: (a) CSC train_net.main, {PH13_STEPS} steps of "
          f"B={cfg.SOLVER.IMS_PER_BATCH} (R18-WS DC5, DAN "
          f"{list(cfg.MODEL.ROI_BOX_HEAD.DAN_DIM)}, FREEZE_AT 5, "
          f"{cfg.MODEL.DTYPE}, P={cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE}, "
          f"CSC_MAX_ITER {PH13_CSC_MAX_ITER}, seeded random weights) "
          f"then TTA eval of {n_eval} images: per step (kind, bucket, device "
          "ms, total_loss): " + ", ".join(f"({k}, {b}, {v:.1f}, {x:.4g})"
                                          for k, b, v, x in per_step)
          + f"; CPG max and W != 1 count per CSC step {zeros} (zero maps, "
          f"W = 1: the JAX package's FREEZE_AT 5); K1 launches "
          f"{launches['roi_pool']}; {len(dets)} images, "
          f"{sum(n for _, n in dets)} detections, VOC metrics "
          + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items())
          + f"; main {main_s:.2f} s, peak {peak_a / 2**30:.2f} GiB {tag}",
          flush=True)
    del steps, seen
    torch.cuda.empty_cache()

    # (b) the CSC step at FREEZE_AT 2, tau 0, on loader batches
    cfg_b = drn_wsod_torch.get_cfg()
    cfg_b.merge_from_file(str(yaml))
    cfg_b.merge_from_list(opts + ["MODEL.BACKBONE.FREEZE_AT", "2"])
    model = drn_wsod_torch.build_model(cfg_b, device=dev)
    tx = drn_wsod_torch.build_optimizer(cfg_b, model)
    state = drn_wsod_torch.create_train_state(model, tx)
    step = trainer_lib.make_csc_train_step(model, tx, tau=0.0)
    loader = iter(build_detection_train_loader(
        cfg_b, DatasetMapper(cfg_b, is_train=True)))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs = []
    with ClockSampler() as clocks_b:
        for _ in range(PH13_B_STEPS):
            batch = next(loader).to(dev)
            parts, metrics_b, seen_b = split_csc_step(step, state, batch, tx)
            runs.append((int(batch.image.shape[1]), parts,
                         {k: float(v) for k, v in metrics_b.items()},
                         seen_b, batch.labels > 0.5, batch.proposal_mask))
    peak_b = torch.cuda.max_memory_allocated()
    pool_ms = diff_pool_ms(model, batch)
    frozen_ok = all(torch.equal(p, before[n])
                    for n, p in model.named_parameters()
                    if n.startswith(("backbone.stem.", "backbone.res2.")))
    moved = {n: not torch.equal(p, before[n])
             for n, p in model.named_parameters() if p.requires_grad}
    stages = {s: all(v for n, v in moved.items()
                     if n.startswith(f"backbone.{s}."))
              for s in ("res3", "res4", "res5")}
    heads = sum(v for n, v in moved.items() if not n.startswith("backbone"))
    if not frozen_ok or not all(stages.values()) or heads < len(
            [n for n in moved if not n.startswith("backbone")]) - 1:
        raise Fail(f"phase 13: (b) the stem and res2 unchanged {frozen_ok}, "
                   f"res3-res5 moved {stages}, heads moved {heads}")
    w_not_1, dead = [], []
    for i, (bucket, parts, m, sn, present, mask) in enumerate(runs):
        if not all(math.isfinite(v) for v in m.values()):
            raise Fail(f"phase 13: (b) step {i} metrics {m}")
        # a present class's map is zero where no gradient reaches the
        # image: the random weights' class softmax saturates once the
        # YAML's lr has moved them (PERF.md section 6), so every present map
        # must be live on the fresh weights of step 0, and some after it
        live = sn["cpg_max"][present] > 0
        dead.append([(b, c, float(sn["preds"][b, c]),
                      float(sn["score_max"][b, c]))
                     for b, c in present.nonzero().tolist()
                     if not sn["cpg_max"][b, c] > 0])
        if not bool(live.all() if i == 0 else live.any()):
            raise Fail(f"phase 13: (b) step {i}: present classes with a zero "
                       f"CPG map at FREEZE_AT 2 (image, class, pred, largest "
                       f"proposal score) {dead[-1]}")
        counted = present[:, None, :] & mask[..., None]
        w_not_1.append(int((counted & (sn["W"] != 1.0)).sum()))
    if not any(w_not_1):
        # why: each present class's contrast range and image probability
        for i, (_, _, _, sn, present, mask) in enumerate(runs):
            B, C = present.shape
            con = sn["contrast"].reshape(B, C, -1)
            for b, c in present.nonzero().tolist():
                v = con[b, c][mask[b]]
                print(f"phase 13: (b) step {i} image {b} class {c}: contrast "
                      f"max {v.max().item():.4g} min {v.min().item():.4g}, "
                      f"pred {sn['preds'][b, c].item():.4g}", flush=True)
    for i, (bucket, parts, m, sn, present, mask) in enumerate(runs):
        print(f"phase 13: (b) make_csc_train_step tau 0 at FREEZE_AT 2, step "
              f"{i} (bucket {bucket}, {int(present.sum())} present classes): "
              "device ms " + ", ".join(f"{k} {v:.2f}" for k, v in
                                       parts.items())
              + f" (sum {sum(parts.values()):.2f}); losses "
              + ", ".join(f"{k} {v:.4g}" for k, v in m.items())
              + f"; present maps live (max 1) but (image, class, pred, "
              f"largest proposal score) {dead[i]}; weights W != 1 at "
              f"{w_not_1[i]} (present class, valid proposal) pairs {tag}",
              flush=True)
    print(f"phase 13: (b) the stem and res2 bit-unchanged, res3-res5 and "
          f"{heads} head tensors moved; peak device memory "
          f"{peak_b / 2**30:.2f} GiB; at the last step's map "
          f"{pool_ms['map']}: the differentiable pool (B images, with the "
          f"scale) {pool_ms['forward']:.3f} ms forward, "
          f"{pool_ms['backward']:.3f} ms forward + backward to the map, K1 "
          f"{pool_ms['k1']:.3f} ms (CUDA events, 3 calls each); phase "
          f"{time.perf_counter() - t_phase:.1f} s {tag}", flush=True)
    print(f"phase 13: card during (a): {clocks.summary}; during (b): "
          f"{clocks_b.summary} {tag}", flush=True)
    del model, state, tx, runs
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    return launches


# phases 14-16: the other backbones and WSJDS
PH14_STEPS, PH14_TEST = 8, 4
PH15_STEPS, PH15_TEST = 4, 2
PH16_CSC_MAX_ITER, PH16_STEPS, PH16_TEST = 2, 4, 2


def entry_main(phase: int, dev, yaml: Path, opts: list, hw: dict,
               patches=(), coco: bool = False, num_classes: int = None,
               dense: dict = None, metrics: dict = None, evaluator=None):
    """``train_net.main`` on ``yaml`` with ``opts`` (the TTA eval of the
    test records only), each step recorded by ``step_recorder`` as
    "plain" or "csc", each evaluated image by ``detection_checker`` (of the
    VOC evaluator, or with ``coco`` of the COCO evaluator over
    ``num_classes``, 80 by default, its masks and keypoints counted in
    ``dense``; of ``evaluator`` where given), plus ``patches`` ((object,
    name, value) each), with the launch counts set to 0 just before and
    read just after. ``metrics`` ({task: keys}, VOC's or COCO's box
    metrics by default; an evaluator whose results are flat, as LVIS's,
    counts as the "bbox" task) must each be finite in [0, 100]; where it
    names no "bbox" task, no detection is checked. Returns a dict of the
    results, launches, steps, detections, bad images, main's seconds, peak
    memory and the clock summary."""
    from drn_wsod_torch.engine import defaults
    from drn_wsod_torch.engine import trainer as trainer_lib
    from drn_wsod_torch.evaluation import coco_eval, voc_eval
    from drn_wsod_torch.tools import train_net

    steps, dets, bad = [], [], []
    evaluator = evaluator or (coco_eval.COCODetectionEvaluator if coco
                              else voc_eval.PascalVOCDetectionEvaluator)
    if metrics is None:
        metrics = ({"bbox": ("AP", "AP50", "AP75")} if coco else
                   {"bbox": ("AP50",), "bbox CorLoc": ("CL50",)})
    checker = [(evaluator, "process_single", detection_checker(
        hw, dets, bad, evaluator, num_classes or (80 if coco else 20),
        dense))] if "bbox" in metrics else []
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with contextlib.ExitStack() as stack, ClockSampler() as clocks:
        for obj, name, new in (
                (defaults, "setup_logger", entry_logger),
                (trainer_lib, "make_train_step", step_recorder(
                    steps, "plain", trainer_lib.make_train_step)),
                (trainer_lib, "make_csc_train_step", step_recorder(
                    steps, "csc", trainer_lib.make_csc_train_step)),
                *checker, *patches):
            stack.enter_context(mock.patch.object(obj, name, new))
        t = time.perf_counter()
        results = train_net.main(train_net.argument_parser().parse_args(
            ["--config-file", str(yaml), *opts]), device=dev)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
    close_logging()
    torch.cuda.empty_cache()
    metrics = {f"{ds}/{key}": tasks[task][key]
               for ds, tasks in results.items()
               for tasks in [tasks if all(isinstance(v, dict)
                                          for v in tasks.values())
                             else {"bbox": tasks}]
               for task, keys in metrics.items() if task in tasks
               for key in keys if key in tasks[task]}
    if not metrics or not all(math.isfinite(v) and 0 <= v <= 100
                              for v in metrics.values()):
        raise Fail(f"phase {phase}: evaluator metrics {metrics}")
    return dict(results=results, launches=launches, steps=steps, dets=dets,
                bad=bad, main_s=main_s, peak=peak, clocks=clocks.summary,
                metrics=metrics)


def check_steps(phase: int, run: dict, kinds: list, names: dict) -> list:
    """Each step of ``run`` of the kind ``kinds`` says, with exactly the
    metric names ``names[kind]``, all finite; returns the per-step
    (kind, bucket, device ms, metrics)."""
    got = [k for k, *_ in run["steps"]]
    if got != kinds:
        raise Fail(f"phase {phase}: step kinds {got}, want {kinds}")
    out = []
    for kind, bucket, start, end, m in run["steps"]:
        m = {k: float(v) for k, v in m.items()}
        if set(m) != names[kind] or not all(math.isfinite(v)
                                            for v in m.values()):
            raise Fail(f"phase {phase}: {kind} step metrics {m}, want "
                       f"{sorted(names[kind])}, all finite")
        out.append((kind, bucket, start.elapsed_time(end), m))
    return out


def check_detections(phase: int, run: dict, n_eval: int) -> None:
    if run["bad"] or len(run["dets"]) != n_eval:
        raise Fail(f"phase {phase}: detections (image, finite, inside, "
                   f"count) {run['bad']}; {len(run['dets'])} images "
                   f"evaluated, want {n_eval}")


def k1_capture(captured: dict, evaluated: dict | None = None):
    """A stand-in for ``meta_arch.roi_pool_batched`` that keeps the inputs
    of the largest map a train step (autograd on) gives K1, and into
    ``evaluated``, where given, those of the largest map the evaluation
    (autograd off) gives it."""
    from drn_wsod_torch.models import meta_arch

    pool = meta_arch.roi_pool_batched

    def capture(feats, boxes, spatial_scale, R, roi_scale):
        into = captured if torch.is_grad_enabled() else evaluated
        if into is not None and \
                feats.shape[1] * feats.shape[2] > into.get("cells", 0):
            into.update(cells=feats.shape[1] * feats.shape[2],
                        feats=feats.clone(), boxes=boxes.clone(),
                        scale=roi_scale.clone(), spatial_scale=spatial_scale)
        return pool(feats, boxes, spatial_scale, R, roi_scale)

    return meta_arch, "roi_pool_batched", capture


def k1_exact(phase: int, captured: dict, what: str = "train step") -> dict:
    """K1 against its plain version on the captured inputs (max |diff| 0),
    with its queued time, the plain version's and the bound."""
    from drn_wsod_torch.ops import roi_pool as rp

    if "feats" not in captured:
        raise Fail(f"phase {phase}: no K1 call captured in a {what}")
    feats, boxes, scale, ss = (captured[k] for k in (
        "feats", "boxes", "scale", "spatial_scale"))

    def k1():
        return rp.roi_pool_batched(feats, boxes, ss, 7, scale)

    def plain():
        return rp.roi_pool_plain(feats, boxes, ss, 7, scale)

    out = k1()
    torch.cuda.synchronize()
    err = exact(f"roi_pool at the {what}'s {tuple(feats.shape)} "
                f"{str(feats.dtype)[6:]} map (spatial scale {ss})", out,
                plain(), phase=phase)
    rec = dict(err=err, map=tuple(feats.shape), boxes=tuple(boxes.shape),
               spatial_scale=ss, ms=queued_ms(k1, 10), plain_ms=cuda_ms(
                   plain, 2))
    rec["bound_ms"], rec["bound_by"] = roi_pool_bound(feats, boxes, scale,
                                                      out, ss)
    captured.clear()
    del out
    torch.cuda.empty_cache()
    return rec


def yaml_is(phase: int, yaml: Path, **want) -> None:
    """Fail unless the YAML merges to ``want`` (dotted keys with __)."""
    import drn_wsod_torch

    y = drn_wsod_torch.get_cfg()
    y.merge_from_file(str(yaml))
    got = {k: y.get_by_path(k.replace("__", ".")) for k in want}
    got = {k: list(v) if isinstance(v, tuple) else v for k, v in got.items()}
    if got != want:
        raise Fail(f"phase {phase}: {yaml.name} is not as expected: {got}")


def metrics_kind(metrics: dict) -> str:
    if any("APr" in k for k in metrics):
        return "LVIS"
    return "COCO" if any("AP75" in k for k in metrics) else "VOC"


def print_entry(phase, what, per_step, run, k1, k1_want, n_eval, extra,
                tag):
    print(f"phase {phase}: {what}; per step (kind, bucket, device ms by CUDA "
          "events, total_loss): " + ", ".join(
              f"({k}, {b}, {v:.1f}, {m['total_loss']:.4g})"
              for k, b, v, m in per_step)
          + f"; K1 launches {run['launches']['roi_pool']} ({k1_want})"
          + (f"; K1 == plain (max|diff| {k1['err']}) at the largest train "
             f"map {k1['map']} (spatial scale {k1['spatial_scale']}, boxes "
             f"{k1['boxes']}): kernel {k1['ms']:.4f} ms queued, plain "
             f"{k1['plain_ms']:.4f} ms, bound {k1['bound_ms']:.4f} ms "
             f"({k1['bound_by']})" if k1 else "")
          + f"; detections finite and inside their images ({n_eval} "
          f"images, {sum(n for _, n in run['dets'])} detections); "
          f"{metrics_kind(run['metrics'])}"
          " metrics " + ", ".join(f"{k} {v:.4f}"
                                 for k, v in run["metrics"].items())
          + " (random weights: the values mean nothing)" + extra
          + f"; main {run['main_s']:.2f} s, peak device memory "
          f"{run['peak'] / 2**30:.2f} GiB {tag}", flush=True)
    print(f"phase {phase}: card during the phase: {run['clocks']} {tag}",
          flush=True)


OICR_NAMES = {"loss_cls", "loss_cls_r0", "loss_cls_r1", "loss_cls_r2",
              "total_loss"}


def phase14_vgg(dev, tag) -> dict:
    """VGG-16 (``oicr_V_16_DC5_1x.yaml``) through ``train_net.main`` at full
    width and depth: PH14_STEPS steps from seeded random weights on a packed
    shard, then the YAML's TTA eval of PH14_TEST records; K1 once per step
    and per TTA group, and exact at the largest 512-channel stride-8 map
    the steps gave it."""
    import shutil

    t_phase = time.perf_counter()
    yaml = Path(__file__).resolve().parent / "configs" / \
        "PascalVOC-Detection" / "oicr_V_16_DC5_1x.yaml"
    yaml_is(14, yaml, MODEL__BACKBONE__NAME="build_vgg_backbone",
            MODEL__VGG__CONV5_DILATION=2, MODEL__ROI_HEADS__NAME=
            "OICRROIHeads", MODEL__ROI_BOX_HEAD__DAN_DIM=[4096, 4096],
            WSL__REFINE_NUM=3, MODEL__DTYPE="bfloat16",
            SOLVER__IMS_PER_BATCH=4, INPUT__CROP__ENABLED=True,
            INPUT__MAX_SIZE_TRAIN=2000, TEST__AUG__ENABLED=True,
            TEST__AUG__FLIP=True)
    work, opts, hw = entry_setup("ph14", 14, PH12_TRAIN, PH14_TEST)
    opts += ["SOLVER.MAX_ITER", str(PH14_STEPS), "SOLVER.CHECKPOINT_PERIOD",
             str(PH14_STEPS), "TEST.EVAL_TRAIN", "False"]
    test_hw = {k: v for k, v in hw.items() if int(k) >= 100}
    import drn_wsod_torch

    cfg = drn_wsod_torch.get_cfg()
    cfg.merge_from_file(str(yaml))
    cfg.merge_from_list(opts)
    tta_groups = tta_group_count(cfg, test_hw)
    captured = {}
    run = entry_main(14, dev, yaml, opts, hw, [k1_capture(captured)])
    per_step = check_steps(14, run, ["plain"] * PH14_STEPS,
                           {"plain": OICR_NAMES})
    if run["launches"]["roi_pool"] != PH14_STEPS + tta_groups:
        raise Fail(f"phase 14: K1 launches {run['launches']['roi_pool']}, "
                   f"want {PH14_STEPS} steps + {tta_groups} TTA groups")
    check_detections(14, run, PH14_TEST)
    if captured.get("feats") is None or captured["feats"].shape[-1] != 512 \
            or captured["spatial_scale"] != 0.125:
        raise Fail("phase 14: K1's train map is not VGG's 512-channel "
                   "stride-8 plain5")
    k1 = k1_exact(14, captured)
    print_entry(14, f"VGG-16 OICR train_net.main, {PH14_STEPS} steps of B=4 "
                f"(oicr_V_16_DC5_1x: VGG-16 CONV5_DILATION 2, DAN [4096, "
                f"4096], 3 OICR branches, bfloat16, dropout 0.5, crop, 24 "
                f"scales, flip, P=4096, seeded random weights) on a packed "
                f"shard of {PH12_TRAIN} records, then TTA eval of "
                f"{PH14_TEST} images", per_step, run, k1,
                f"{PH14_STEPS} steps + {tta_groups} TTA groups",
                PH14_TEST, f"; phase {time.perf_counter() - t_phase:.1f} s",
                tag)
    shutil.rmtree(work, ignore_errors=True)
    return run["launches"]


def phase15_plain_resnet(dev, tag) -> dict:
    """The plain R50 (``wsddn_R_50_DC5_1x.yaml``, res5 at stride 16)
    through ``train_net.main`` at full width: PH15_STEPS steps, then the
    TTA eval of PH15_TEST records; K1 once per step and per TTA group, and
    exact at the largest 2048-channel stride-16 map."""
    import shutil

    import drn_wsod_torch

    t_phase = time.perf_counter()
    yaml = Path(__file__).resolve().parent / "configs" / \
        "PascalVOC-Detection" / "wsddn_R_50_DC5_1x.yaml"
    yaml_is(15, yaml, MODEL__BACKBONE__NAME="build_resnet_backbone",
            MODEL__RESNETS__DEPTH=50, MODEL__RESNETS__RES5_DILATION=2,
            MODEL__ROI_HEADS__NAME="WSDDNROIHeads",
            MODEL__ROI_BOX_HEAD__DAN_DIM=[2048, 4096],
            MODEL__DTYPE="bfloat16", SOLVER__IMS_PER_BATCH=4,
            TEST__AUG__ENABLED=True)
    work, opts, hw = entry_setup("ph15", 15, PH12_TRAIN, PH15_TEST)
    opts += ["SOLVER.MAX_ITER", str(PH15_STEPS), "SOLVER.CHECKPOINT_PERIOD",
             str(PH15_STEPS), "TEST.EVAL_TRAIN", "False"]
    cfg = drn_wsod_torch.get_cfg()
    cfg.merge_from_file(str(yaml))
    cfg.merge_from_list(opts)
    tta_groups = tta_group_count(cfg, {k: v for k, v in hw.items()
                                       if int(k) >= 100})
    captured = {}
    run = entry_main(15, dev, yaml, opts, hw, [k1_capture(captured)])
    per_step = check_steps(15, run, ["plain"] * PH15_STEPS,
                           {"plain": {"loss_cls", "total_loss"}})
    if run["launches"]["roi_pool"] != PH15_STEPS + tta_groups:
        raise Fail(f"phase 15: K1 launches {run['launches']['roi_pool']}, "
                   f"want {PH15_STEPS} steps + {tta_groups} TTA groups")
    check_detections(15, run, PH15_TEST)
    if captured.get("feats") is None or \
            captured["feats"].shape[-1] != 2048 or \
            captured["spatial_scale"] != 1.0 / 16:
        raise Fail("phase 15: K1's train map is not the plain R50's "
                   "2048-channel stride-16 res5")
    k1 = k1_exact(15, captured)
    print_entry(15, f"plain R50 WSDDN train_net.main, {PH15_STEPS} steps of "
                f"B=4 (wsddn_R_50_DC5_1x: strided R50, 7x7 stem, res5 "
                f"dilated at stride 16, DAN [2048, 4096], bfloat16, dropout "
                f"0.5, crop, 24 scales, flip, P=4096, seeded random weights) "
                f"on a packed shard of {PH12_TRAIN} records, then TTA eval "
                f"of {PH15_TEST} images", per_step, run, k1,
                f"{PH15_STEPS} steps + {tta_groups} TTA groups",
                PH15_TEST, f"; phase {time.perf_counter() - t_phase:.1f} s",
                tag)
    shutil.rmtree(work, ignore_errors=True)
    return run["launches"]


def seg_head_ms(model, feats) -> dict:
    """Device ms of the seg head's forward on ``feats`` (CUDA events, 3
    calls after one): each ASPP conv alone and the whole head, as the
    model runs them (``cudnn.benchmark`` off, channels_last bf16), the
    most dilated conv on a contiguous NCHW input and in float32, then the
    whole head with ``cudnn.benchmark`` on (its tuning call before the
    timed ones)."""
    aspp = model.seg_head.aspp
    x = feats.permute(0, 3, 1, 2)
    last = getattr(aspp, f"conv3x3_d{aspp.dilations[-1]}")
    out = {}
    with torch.no_grad():
        runs = [(name, getattr(aspp, name), x) for name in (
            "conv1x1", *(f"conv3x3_d{d}" for d in aspp.dilations))]
        runs += [(f"conv3x3_d{aspp.dilations[-1]} on NCHW", last,
                  x.contiguous()),
                 (f"conv3x3_d{aspp.dilations[-1]} in float32",
                  lambda t: F.conv2d(t.float(), last.weight.float(),
                                     last.bias.float(),
                                     padding=last.padding,
                                     dilation=last.dilation), x)]
        for name, conv, inp in runs:
            conv(inp)
            out[name] = cuda_ms(lambda: conv(inp), 3)
        model.seg_head(feats)
        out["head"] = cuda_ms(lambda: model.seg_head(feats), 3)
        flag = torch.backends.cudnn.benchmark
        torch.backends.cudnn.benchmark = True
        try:
            model.seg_head(feats)
            out["head, cudnn.benchmark"] = cuda_ms(
                lambda: model.seg_head(feats), 3)
        finally:
            torch.backends.cudnn.benchmark = flag
    return out


def crf_call_ms(probs, image) -> dict:
    """One ``crf_forward`` call at its seg shape: device ms by CUDA events
    around calls as the host issues them, device ms queued behind a sleep
    (the card's own time), and host-issue ms (card idle)."""
    from drn_wsod_torch.ops.crf import crf_forward

    def call():
        return crf_forward(probs, image)

    return {"issued": cuda_ms(call, 3), "queued": queued_ms(call, 3),
            "host": host_us(call, 2) / 1e3}


def phase16_wsjds(dev, tag) -> dict:
    """WSJDS (``ws_jds_V_16_DC5_1x.yaml`` with ``SEM_SEG_HEAD.CONSTRAINT
    True``, as the reference's ws-jds configs and ``ws_jds_WSR_18`` set
    it) through ``train_net.main`` at full width: the CSC step through
    PH16_CSC_MAX_ITER, the plain step after it, PH16_STEPS steps, then the
    TTA eval of PH16_TEST records: the CPG maps zero (FREEZE_AT 5), so
    every seg target is background; ``loss_seg`` and ``loss_constraint``
    finite; no K1 launch; each step split into the CPG pass, the seg head,
    the CRF, the loss pass and the optimizer; ``semantic_logits`` on the
    last batch; one ``crf_forward`` call timed at its seg shape."""
    import shutil

    import drn_wsod_torch
    from drn_wsod_torch.engine import trainer as trainer_lib
    from drn_wsod_torch.models import meta_arch
    from drn_wsod_torch.models.heads import seg as seg_lib
    from drn_wsod_torch.ops import csc as csc_lib

    t_phase = time.perf_counter()
    yaml = Path(__file__).resolve().parent / "configs" / \
        "PascalVOC-DetectionSegmentation" / "ws_jds_V_16_DC5_1x.yaml"
    yaml_is(16, yaml, MODEL__BACKBONE__NAME="build_vgg_backbone",
            MODEL__ROI_HEADS__NAME="WSJDSROIHeads",
            MODEL__BACKBONE__FREEZE_AT=5,
            MODEL__ROI_BOX_HEAD__DAN_DIM=[4096, 4096],
            MODEL__DTYPE="bfloat16", SOLVER__IMS_PER_BATCH=4,
            TEST__AUG__ENABLED=True)
    work, opts, hw = entry_setup("ph16", 16, PH12_TRAIN, PH16_TEST)
    opts += ["SOLVER.MAX_ITER", str(PH16_STEPS), "SOLVER.CHECKPOINT_PERIOD",
             str(PH16_STEPS), "TEST.EVAL_TRAIN", "False",
             "WSL.CSC_MAX_ITER", str(PH16_CSC_MAX_ITER),
             "MODEL.SEM_SEG_HEAD.CONSTRAINT", "True"]
    seen = {"cpg_max": [], "targets": [], "crf": [], "split": []}
    cpg_fn, targets_fn = csc_lib.cpg_from_scores, seg_lib.seg_targets
    crf_fn = seg_lib.crf_forward
    marks = {}

    def point(name):
        if "m" in marks:
            marks["m"](name)()

    def cpg(*a, **kw):
        out = cpg_fn(*a, **kw)
        seen["cpg_max"].append(out.amax())
        point("cpg_out")
        return out

    def targets(cpg_small, labels, *a, **kw):
        t, v = targets_fn(cpg_small, labels, *a, **kw)
        seen["targets"].append(((t != 0).sum(), (~v).sum(), t.numel()))
        return t, v

    def crf(probs, image, **kw):
        point("crf_in")
        out = crf_fn(probs, image, **kw)
        point("crf_out")
        seen["crf_args"] = (probs.detach(), image)
        return out

    def make_step(make, first):
        """``make`` whose steps set the split's points: ``first`` at the
        step's start, the seg head's entry and exit (hooks on the model's
        own module), the CPG maps', the CRF's and the optimizer's."""
        def wrapped(model, tx, *a, **kw):
            step = make(model, tx, *a, **kw)
            if "update" not in vars(tx):         # both steps share one tx
                update = tx.update

                def upd(*args):
                    point("update_in")
                    update(*args)
                    point("update_out")
                tx.update = upd

            def run(state, batch, seed):
                m = Marks()
                marks["m"] = m
                m.hook(model.seg_head, "seg_in", "seg_out")
                m(first)()
                try:
                    out = step(state, batch, seed)
                finally:
                    m.remove()
                    marks.pop("m")
                seen["split"].append(m)
                seen["model"], seen["batch"] = model, batch
                return out
            return run
        return wrapped

    patches = [(csc_lib, "cpg_from_scores", cpg),
               (seg_lib, "seg_targets", targets),
               (seg_lib, "crf_forward", crf)]
    # the step recorder wraps what these return, so the split's marks sit
    # inside each recorded step
    csc_make, plain_make = (trainer_lib.make_csc_train_step,
                            trainer_lib.make_train_step)
    with mock.patch.object(trainer_lib, "make_csc_train_step",
                           make_step(csc_make, "csc_in")), \
            mock.patch.object(trainer_lib, "make_train_step",
                              make_step(plain_make, "plain_in")):
        run = entry_main(16, dev, yaml, opts, hw, patches)
    csc_names = {"loss_cls_pos", "loss_cls_neg", "loss_seg",
                 "loss_constraint", "total_loss", "csc/W_pos_mean",
                 "csc/W_neg_mean", "csc/pred_mean"}
    kinds = ["csc"] * (PH16_CSC_MAX_ITER + 1) + ["plain"] * (
        PH16_STEPS - PH16_CSC_MAX_ITER - 1)
    per_step = check_steps(16, run, kinds, {
        "csc": csc_names, "plain": {"loss_cls", "loss_constraint",
                                    "total_loss"}})
    zeros = [float(x) for x in seen["cpg_max"]]
    if zeros != [0.0] * (PH16_CSC_MAX_ITER + 1):
        raise Fail(f"phase 16: CPG maxima per CSC step {zeros}: FREEZE_AT 5 "
                   "stops the image gradient, so the maps must be zero")
    targets_seen = [tuple(int(x) for x in t) for t in seen["targets"]]
    if len(targets_seen) != PH16_CSC_MAX_ITER + 1 or any(
            fg or ignored for fg, ignored, _ in targets_seen):
        raise Fail(f"phase 16: seg targets (foreground, ignored, pixels) per "
                   f"CSC step {targets_seen}: zero maps label every pixel "
                   "background")
    if run["launches"]["roi_pool"] != 0:
        raise Fail(f"phase 16: K1 launched {run['launches']['roi_pool']} "
                   "times; WSJDS pools through the differentiable pool")
    check_detections(16, run, PH16_TEST)
    parts = []
    for m in seen["split"]:
        device, host = m.split({
            "csc_in": "CPG pass", "plain_in": "loss pass",
            "cpg_out": "loss pass",
            "seg_in": "seg head", "seg_out": "loss pass",
            "crf_in": "CRF", "crf_out": "loss pass",
            "update_in": "optimizer"})
        parts.append((device, host))
    # semantic_logits on the last batch, its CRF's refined probabilities
    model, batch = seen["model"], seen["batch"]
    refined = {}

    def keep(probs, image, **kw):
        refined["q"] = crf_fn(probs, image, **kw)
        return refined["q"]

    with mock.patch.object(meta_arch, "crf_forward", keep):
        logits = model.semantic_logits(batch)
    q = refined["q"].float()
    sums = q.sum(-1)
    if not (torch.isfinite(logits).all() and q.min() >= 0 and q.max() <= 1
            and (sums - 1).abs().max() < 1e-4):
        raise Fail(f"phase 16: semantic_logits finite "
                   f"{bool(torch.isfinite(logits).all())}, refined "
                   f"probabilities in [{q.min().item()}, {q.max().item()}], "
                   f"label sums {sums.min().item()}-{sums.max().item()}")
    probs, image = seen["crf_args"]
    crf_ms = crf_call_ms(probs, image)
    with torch.no_grad():
        feats = model.features(batch.image)
    seg_ms = seg_head_ms(model, feats)
    lines = ", ".join(
        f"({k}, {b}, " + ", ".join(f"{n} {v:.1f}" for n, v in d.items())
        + f"; host issue {sum(h.values()):.1f})"
        for (k, b, _, _), (d, h) in zip(per_step, parts))
    print_entry(16, f"WSJDS train_net.main, {PH16_STEPS} steps of B=4 "
                f"(ws_jds_V_16_DC5_1x with SEM_SEG_HEAD.CONSTRAINT True: "
                f"VGG-16, DAN [4096, 4096], ASPP seg head, bfloat16, "
                f"FREEZE_AT 5, CSC_MAX_ITER {PH16_CSC_MAX_ITER}, P=4096, "
                f"seeded random weights) on a packed shard of {PH12_TRAIN} "
                f"records, then TTA eval of {PH16_TEST} images", per_step,
                run, None, "none: the differentiable pool", PH16_TEST,
                f"; CPG maxima per CSC step {zeros} (zero maps: FREEZE_AT 5"
                f"), seg targets (foreground, ignored, pixels) "
                f"{targets_seen}; each step's device ms split (kind, bucket, "
                f"parts): {lines}; semantic_logits {tuple(logits.shape)} "
                f"finite, the CRF's refined probabilities in "
                f"[{q.min().item():.3g}, {q.max().item():.3g}], label sums "
                f"within {(sums - 1).abs().max().item():.2e} of 1; one "
                f"crf_forward at {tuple(probs.shape)}: device "
                f"{crf_ms['issued']:.2f} ms as issued, "
                f"{crf_ms['queued']:.2f} ms queued, host issue "
                f"{crf_ms['host']:.2f} ms; the seg head's forward at the "
                f"last batch's map {tuple(feats.shape)}, device ms: "
                + ", ".join(f"{k} {v:.2f}" for k, v in seg_ms.items())
                + f"; phase {time.perf_counter() - t_phase:.1f} s", tag)
    del model, batch, seen, logits, refined, feats
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    return run["launches"]


# phase 17: COCO at full width; phase 18: trainable BN and PreciseBN
PH17_TRAIN, PH17_TEST, PH17_STEPS = 8, 4, 8
PH18_STEPS, PH18_TEST, PH18_NUM_ITER = 4, 2, 4
# COCO's 80 category ids: 1-90 without its ten gaps
COCO_IDS = tuple(i for i in range(1, 91) if i not in (
    12, 26, 29, 30, 45, 66, 68, 69, 71, 83))
# COCO-like image sizes (H, W)
COCO_SIZES = ((480, 640), (427, 640), (640, 480), (640, 427), (375, 500),
              (612, 612), (360, 640), (500, 333))


def coco_split(root: Path, name: str, n: int, rs, start: int):
    """A COCO instances json of ``n`` images (the 80 categories under
    COCO's sparse ids, listed out of order; 1-5 XYWH boxes an image, about
    one in six a crowd with an RLE segmentation, polygons otherwise; the
    last image of the test split without annotations), loaded with the
    port's ``load_coco_json`` (which sets ``name``'s metadata), the
    records given phase 10's synthetic pixels and PH11_PROPOSALS
    proposals, packed with ``pack_dataset`` and registered under ``name``.
    Returns the proposals pickle and {image_id: (H, W)}."""
    import json
    import pickle

    from drn_wsod_torch.data import (DatasetCatalog, RecordDataset,
                                     pack_dataset)
    from drn_wsod_torch.data.datasets import load_coco_json

    cats = [{"id": i, "name": f"coco_{i}", "supercategory": "thing"}
            for i in COCO_IDS]
    coco = {"categories": [cats[i] for i in rs.permutation(len(cats))],
            "images": [], "annotations": []}
    pixels, props = {}, {"ids": [], "boxes": [], "objectness_logits": [],
                         "bbox_mode": 0}
    for i in range(n):
        H, W = COCO_SIZES[(start + i) % len(COCO_SIZES)]
        image_id = 1000 * start + 37 * i + 9
        coco["images"].append({"id": image_id, "height": H, "width": W,
                               "file_name": f"{image_id:012d}.jpg"})
        image, rec = eval_image(rs, H, W, image_id, P=PH11_PROPOSALS)
        pixels[image_id] = image
        props["ids"].append(image_id)
        props["boxes"].append(rec["proposal_boxes"])
        props["objectness_logits"].append(rec["proposal_objectness_logits"])
        if start and i == n - 1:
            continue
        for k in range(rs.randint(1, 6)):
            w, h = rs.uniform(12, W * 0.6), rs.uniform(12, H * 0.6)
            x, y = rs.uniform(0, W - w), rs.uniform(0, H - h)
            crowd = int(k == 0 and i % 6 == 1)
            coco["annotations"].append({
                "id": len(coco["annotations"]) + 1, "image_id": image_id,
                "category_id": int(COCO_IDS[rs.randint(80)]),
                "bbox": [x, y, w, h], "area": w * h, "iscrowd": crowd,
                "segmentation": ({"counts": [int(w * h)], "size": [H, W]}
                                 if crowd else
                                 [[x, y, x + w, y, x + w, y + h, x, y + h]])})
    json_file = root / f"{name}.json"
    json_file.write_text(json.dumps(coco))
    records = load_coco_json(str(json_file), str(root / name), name)
    if [r["image_id"] for r in records] != props["ids"]:
        raise Fail(f"phase 17: load_coco_json reordered {name}")
    for r in records:
        r["image"] = pixels[r["image_id"]]
    shard = root / f"{name}.rec"
    pack_dataset(records, str(shard))
    prop_file = root / f"{name}_proposals.pkl"
    with open(prop_file, "wb") as f:
        pickle.dump(props, f)
    if name in DatasetCatalog:
        DatasetCatalog.remove(name)
    DatasetCatalog.register(name, lambda: list(RecordDataset(str(shard))))
    return str(prop_file), {str(r["image_id"]): (r["height"], r["width"])
                            for r in records}


def metrics_equal(a: dict, b: dict) -> bool:
    """Equal metric dicts, NaN equal to NaN."""
    return a.keys() == b.keys() and all(
        (math.isnan(a[k]) and math.isnan(b[k])) or a[k] == b[k] for k in a)


def phase17_coco(dev, tag) -> dict:
    """COCO (``COCO-Detection/oicr_WSR_50_DC5_1x.yaml``: WS-R50 DC5, 80
    classes, 3 OICR branches, bfloat16, B=4, TTA 8 scales x flip) through
    ``train_net.main`` at full width from seeded random weights: a COCO
    json under COCO's sparse category ids loaded by ``load_coco_json``,
    packed with synthetic pixels and registered as ``coco_2014_train`` /
    ``coco_2014_val``; PH17_STEPS steps, then the TTA eval of PH17_TEST
    images into the COCO box evaluator. Every loss finite, K1 once per
    step and per TTA group and exact at the largest map, AP / AP50 / AP75
    finite in [0, 100], and ``evaluate()`` after a ``state_dict`` /
    ``merge_states`` round trip equal to the run's."""
    import pickle
    import shutil

    import drn_wsod_torch
    from drn_wsod_torch.data import DatasetCatalog, MetadataCatalog
    from drn_wsod_torch.evaluation import coco_eval

    t_phase = time.perf_counter()
    yaml = Path(__file__).resolve().parent / "configs" / \
        "COCO-Detection" / "oicr_WSR_50_DC5_1x.yaml"
    yaml_is(17, yaml, MODEL__ROI_HEADS__NUM_CLASSES=80,
            MODEL__RESNETS__DEPTH=50, MODEL__RESNETS__RES5_DILATION=2,
            MODEL__ROI_HEADS__NAME="OICRROIHeads", WSL__REFINE_NUM=3,
            MODEL__DTYPE="bfloat16", SOLVER__IMS_PER_BATCH=4,
            DATASETS__TRAIN=["coco_2014_train"],
            DATASETS__TEST=["coco_2014_val"], TEST__AUG__ENABLED=True,
            TEST__AUG__FLIP=True)
    work = Path(__file__).resolve().parent / "build" / "chip_smoke_ph17"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    rs = np.random.RandomState(17)
    train_props, train_hw = coco_split(work, "coco_2014_train", PH17_TRAIN,
                                       rs, 0)
    test_props, test_hw = coco_split(work, "coco_2014_val", PH17_TEST, rs, 1)
    meta = MetadataCatalog.get("coco_2014_val")
    if meta.evaluator_type != "coco" or len(meta.thing_classes) != 80 or \
            list(meta.thing_dataset_id_to_contiguous_id) != list(COCO_IDS):
        raise Fail("phase 17: load_coco_json's metadata is not COCO's")
    opts = ["DATASETS.PROPOSAL_FILES_TRAIN", repr((train_props,)),
            "DATASETS.PROPOSAL_FILES_TEST", repr((test_props,)),
            "MODEL.WEIGHTS", "", "OUTPUT_DIR", str(work / "output"),
            "SEED", "0", "TEST.EVAL_PERIOD", "0", "TEST.EVAL_TRAIN", "False",
            "SOLVER.MAX_ITER", str(PH17_STEPS), "SOLVER.CHECKPOINT_PERIOD",
            str(PH17_STEPS)]
    cfg = drn_wsod_torch.get_cfg()
    cfg.merge_from_file(str(yaml))
    cfg.merge_from_list(opts)
    tta_groups = tta_group_count(cfg, {int(k): v for k, v in test_hw.items()})
    captured, evaluated = {}, []
    evaluate = coco_eval.COCODetectionEvaluator.evaluate

    def recording(self):
        out = evaluate(self)
        evaluated.append((self, out))
        return out
    try:
        run = entry_main(17, dev, yaml, opts, {**train_hw, **test_hw},
                         [k1_capture(captured),
                          (coco_eval.COCODetectionEvaluator, "evaluate",
                           recording)], coco=True)
    finally:
        for name in ("coco_2014_train", "coco_2014_val"):
            if name in DatasetCatalog:
                DatasetCatalog.remove(name)
    per_step = check_steps(17, run, ["plain"] * PH17_STEPS,
                           {"plain": OICR_NAMES})
    if run["launches"]["roi_pool"] != PH17_STEPS + tta_groups:
        raise Fail(f"phase 17: K1 launches {run['launches']['roi_pool']}, "
                   f"want {PH17_STEPS} steps + {tta_groups} TTA groups")
    check_detections(17, run, PH17_TEST)
    if captured.get("feats") is None or captured["feats"].shape[-1] != 2048 \
            or captured["feats"].dtype != torch.bfloat16:
        raise Fail("phase 17: K1's train map is not the 2048-channel bf16 "
                   "res5")
    k1 = k1_exact(17, captured)
    if len(evaluated) != 1:
        raise Fail(f"phase 17: {len(evaluated)} COCO evaluations, want 1")
    ev, got = evaluated[0]
    again = coco_eval.COCODetectionEvaluator(ev._class_names, ev._gt)
    again.merge_states([pickle.loads(pickle.dumps(ev.state_dict()))])
    if not metrics_equal(again.evaluate()["bbox"], got["bbox"]):
        raise Fail(f"phase 17: evaluate() after a state_dict round trip "
                   f"{again.evaluate()}, the run's {got}")
    print_entry(17, f"COCO OICR train_net.main, {PH17_STEPS} steps of B=4 "
                f"(COCO-Detection/oicr_WSR_50_DC5_1x: WS-R50 DC5, 80 "
                f"classes, DAN [2048, 4096], 3 OICR branches, bfloat16, "
                f"dropout 0.5, crop, 24 scales, flip, P=4096, seeded random "
                f"weights) on a packed COCO-format shard of {PH17_TRAIN} "
                f"images (80 categories under COCO's sparse ids, crowd "
                f"boxes), then TTA eval of {PH17_TEST} images (one without "
                f"annotations) by the COCO box evaluator", per_step, run, k1,
                f"{PH17_STEPS} steps + {tta_groups} TTA groups", PH17_TEST,
                "; the evaluator's state_dict / merge_states round trip "
                "evaluates the same; "
                + ", ".join(f"{k} {got['bbox'][k]:.4f}"
                            for k in ("APs", "APm", "APl"))
                + f"; phase {time.perf_counter() - t_phase:.1f} s", tag)
    shutil.rmtree(work, ignore_errors=True)
    return run["launches"]


def precise_bn_host(stats: dict, n: int) -> dict:
    """The PreciseBN formula on the host in float32 for a backbone that
    never writes its statistics: ``n`` times ``(s - 0.9 s) / (1 - 0.9)``
    summed from zeros, then divided by ``n``."""
    m, one_minus_m = np.float32(0.9), np.float32(1.0 - 0.9)
    out = {}
    for k, s in stats.items():
        x = (s - m * s) / one_minus_m
        acc = np.zeros_like(s)
        for _ in range(n):
            acc = acc + x
        out[k] = acc / np.float32(n)
    return out


def phase18_bn(dev, tag) -> dict:
    """Trainable BatchNorm and PreciseBN at full width: the flagship YAML
    with ``MODEL.RESNETS.NORM BN``, ``TEST.PRECISE_BN.ENABLED``
    (``NUM_ITER`` PH18_NUM_ITER) and ``TEST.EVAL_PERIOD`` PH18_STEPS,
    through ``train_net.main``: PH18_STEPS steps, PreciseBN after training,
    the EvalHook's TTA eval and ``main``'s of PH18_TEST images. The
    statistics are drawn from a seed at build. K1 takes the float32
    (4, H, W, 2048) map, exact against its plain version at the largest;
    K1 launches = steps + the hook's forwards + two TTA evals' groups;
    BatchNorm's affine unchanged; the statistics after training equal the
    PreciseBN formula applied on the host to the drawn ones, bit for bit.
    K1 queued in float32 and in bf16 on the same map, each beside its
    bound."""
    import shutil

    import drn_wsod_torch
    from drn_wsod_torch.engine import precise_bn
    from drn_wsod_torch.models.backbones.resnet_ws import BatchNorm
    from drn_wsod_torch.ops import roi_pool as rp
    from drn_wsod_torch.tools import train_net

    t_phase = time.perf_counter()
    yaml = Path(__file__).resolve().parent / "configs" / \
        "PascalVOC-Detection" / "oicr_WSR_50_DC5_1x.yaml"
    yaml_is(18, yaml, MODEL__RESNETS__DEPTH=50, MODEL__DTYPE="bfloat16",
            MODEL__BACKBONE__FREEZE_AT=5, SOLVER__IMS_PER_BATCH=4,
            TEST__AUG__ENABLED=True)
    work, opts, hw = entry_setup("ph18", 18, PH12_TRAIN, PH18_TEST)
    opts += ["MODEL.RESNETS.NORM", "BN", "TEST.PRECISE_BN.ENABLED", "True",
             "TEST.PRECISE_BN.NUM_ITER", str(PH18_NUM_ITER),
             "TEST.EVAL_PERIOD", str(PH18_STEPS),
             "SOLVER.MAX_ITER", str(PH18_STEPS), "SOLVER.CHECKPOINT_PERIOD",
             str(PH18_STEPS), "TEST.EVAL_TRAIN", "False"]
    cfg = drn_wsod_torch.get_cfg()
    cfg.merge_from_file(str(yaml))
    cfg.merge_from_list(opts)
    tta_groups = tta_group_count(cfg, {k: v for k, v in hw.items()
                                       if int(k) >= 100})
    built, hook_forwards = {}, []
    build_model = train_net.build_model

    def seeded_bn(cfg, device=None):
        model = build_model(cfg, device=device)
        g = torch.Generator(device=device).manual_seed(18)
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, BatchNorm):
                    m.running_mean.normal_(0.0, 0.1, generator=g)
                    m.running_var.uniform_(0.5, 1.5, generator=g)
        built["model"] = model
        built["before"] = {k: v.detach().cpu().clone()
                           for k, v in model.state_dict().items()
                           if ".norm." in k}
        return model
    train_forward = precise_bn.train_forward

    def counted(model, batch):
        hook_forwards.append(int(batch.image.shape[1]))
        return train_forward(model, batch)
    captured = {}
    run = entry_main(18, dev, yaml, opts, hw, [
        k1_capture(captured), (train_net, "build_model", seeded_bn),
        (precise_bn, "train_forward", counted)])
    per_step = check_steps(18, run, ["plain"] * PH18_STEPS,
                           {"plain": OICR_NAMES})
    want = PH18_STEPS + len(hook_forwards) + 2 * tta_groups
    if len(hook_forwards) != PH18_NUM_ITER or \
            run["launches"]["roi_pool"] != want:
        raise Fail(f"phase 18: K1 launches {run['launches']['roi_pool']}, "
                   f"hook forwards {len(hook_forwards)}; want {PH18_STEPS} "
                   f"steps + {PH18_NUM_ITER} hook forwards + 2 x "
                   f"{tta_groups} TTA groups")
    check_detections(18, run, 2 * PH18_TEST)
    feats = captured.get("feats")
    if feats is None or feats.dtype != torch.float32 or \
            feats.shape[0] != 4 or feats.shape[-1] != 2048:
        got = None if feats is None else (feats.dtype, tuple(feats.shape))
        raise Fail(f"phase 18: K1's train map is not float32 (4, H, W, "
                   f"2048): {got}")
    after = {k: v.detach().cpu() for k, v in
             built["model"].state_dict().items() if ".norm." in k}
    before = built["before"]
    affine = [k for k in before if k.endswith((".weight", ".bias"))]
    moved = [k for k in affine if not torch.equal(after[k], before[k])]
    if not affine or moved:
        raise Fail(f"phase 18: BatchNorm's affine moved: {moved[:3]}")
    stats = {k: before[k].numpy() for k in before
             if k.endswith(("running_mean", "running_var"))}
    host = precise_bn_host(stats, PH18_NUM_ITER)
    off = [k for k in stats if not np.array_equal(after[k].numpy(), host[k])]
    rounded = sum(int((after[k].numpy() != stats[k]).sum()) for k in stats)
    if not stats or off:
        raise Fail(f"phase 18: statistics after PreciseBN differ from the "
                   f"host formula: {off[:3]}")
    boxes, scale, ss = (captured[k] for k in ("boxes", "scale",
                                              "spatial_scale"))
    bf16 = feats.to(torch.bfloat16)
    out16 = rp.roi_pool_batched(bf16, boxes, ss, 7, scale)
    ms16 = queued_ms(lambda: rp.roi_pool_batched(bf16, boxes, ss, 7, scale),
                     10)
    bound16 = roi_pool_bound(bf16, boxes, scale, out16, ss)
    del out16, bf16
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    k1 = k1_exact(18, captured)
    k1_peak = torch.cuda.max_memory_allocated()
    print_entry(18, f"trainable BatchNorm + PreciseBN train_net.main, "
                f"{PH18_STEPS} steps of B=4 (oicr_WSR_50_DC5_1x with "
                f"MODEL.RESNETS.NORM BN, TEST.PRECISE_BN.ENABLED, NUM_ITER "
                f"{PH18_NUM_ITER}, EVAL_PERIOD {PH18_STEPS}: the backbone's "
                f"map float32, bfloat16 convs, seeded random weights and "
                f"statistics) on a packed shard of {PH12_TRAIN} records, "
                f"PreciseBN after training ({len(hook_forwards)} forwards, "
                f"buckets {hook_forwards}), then the EvalHook's and main's "
                f"TTA evals of {PH18_TEST} images", per_step, run, k1,
                f"{PH18_STEPS} steps + {len(hook_forwards)} hook forwards + "
                f"2 x {tta_groups} TTA groups", 2 * PH18_TEST,
                f"; K1 float32 {k1['ms']:.4f} ms queued (bound "
                f"{k1['bound_ms']:.4f}, {k1['bound_by']}) against bf16 on the "
                f"same map {ms16:.4f} ms queued (bound {bound16[0]:.4f}, "
                f"{bound16[1]}); peak device memory around the float32 "
                f"kernel and its plain version {k1_peak / 2**30:.2f} GiB; "
                f"BatchNorm's affine unchanged ({len(affine)} tensors); "
                f"{len(stats)} statistics equal the host's PreciseBN formula "
                f"bit for bit ({rounded} of their values moved by the "
                f"rounding)"
                f"; phase {time.perf_counter() - t_phase:.1f} s", tag)
    built.clear()
    shutil.rmtree(work, ignore_errors=True)
    return run["launches"]


# phases 19-21: steps, eval images, train records
PH19_STEPS, PH19_TEST = 4, 2
# on random weights the YAMLs' BASE_LR 0.01 drives Cascade's losses to NaN
# within 3 steps (a CPU rehearsal at narrow widths); the smoke cuts it
PH19_LR = 1e-4
PH20_STEPS, PH20_TRAIN, PH20_TEST = 4, 8, 2
PH21_STEPS, PH21_TEST = 4, 2
SUPERVISED_NAMES = {
    "fast_rcnn": {"loss_cls", "loss_box_reg", "total_loss"},
    "cascade": {f"loss_{n}_stage{k}" for n in ("cls", "box_reg")
                for k in range(3)} | {"total_loss"}}


def bf16_ulps(got, want) -> tuple:
    """(values equal, largest |diff| in bfloat16 ulps of the CPU value) of
    a card tensor against its CPU twin."""
    g, w = got.float().cpu(), want.float().cpu()
    ulp = 2.0 ** (torch.floor(torch.log2(w.abs().clamp(min=2.0 ** -126)))
                  - 7)
    return (float((g == w).float().mean()),
            float(((g - w).abs() / ulp).max()))


def sampler_capture(calls: list):
    """A stand-in for ``fast_rcnn.subsample_proposals`` that keeps each
    call's per-image foreground count and slot count, and the first
    call's inputs and output."""
    from drn_wsod_torch.models.heads import fast_rcnn

    core = fast_rcnn.subsample_proposals

    def capture(*args, **kw):
        out = core(*args, **kw)
        n_fg = ((out.gt_class >= 0) & out.valid).sum(1).tolist()
        calls.append(dict(n_fg=n_fg, slots=int(out.indices.shape[1]),
                          n_valid=out.valid.sum(1).tolist(),
                          first=(args, kw, out) if not calls else None))
        return out

    return fast_rcnn, "subsample_proposals", capture


def phase19_supervised(dev, tag) -> dict:
    """Fast R-CNN and Cascade R-CNN (``retrain_fast_rcnn_WSR_50_DC5_1x``,
    ``cascade_rcnn_WSR_50_DC5_1x``: WS-R50 DC5, FREEZE_AT 2, the
    differentiable RoIPool, bfloat16) through ``train_net.main`` at full
    width from seeded random weights on packed shards with instance GT:
    PH19_STEPS steps of B=4 each (the YAMLs' 8 is cut) at BASE_LR PH19_LR
    (the YAMLs' 0.01 is cut), then the YAMLs' eval without TTA (the test loader) of PH19_TEST images. Every loss
    finite, at least two buckets, no K1 launch (a trainable backbone takes
    the differentiable pool), at most 128 foreground slots of 512 per
    image, and the sampler's core on the card bit-equal to the CPU's on
    the same keys."""
    import shutil

    from drn_wsod_torch.models.heads import fast_rcnn

    t_phase = time.perf_counter()
    here = Path(__file__).resolve().parent / "configs" / "PascalVOC-Detection"
    launches = {}
    for name, yaml, head in (
            ("fast_rcnn", here / "retrain_fast_rcnn_WSR_50_DC5_1x.yaml",
             "StandardROIHeads"),
            ("cascade", here / "cascade_rcnn_WSR_50_DC5_1x.yaml",
             "CascadeROIHeads")):
        yaml_is(19, yaml, MODEL__ROI_HEADS__NAME=head,
                MODEL__BACKBONE__FREEZE_AT=2, MODEL__RESNETS__DEPTH=50,
                MODEL__RESNETS__RES5_DILATION=2, MODEL__DTYPE="bfloat16",
                MODEL__ROI_BOX_HEAD__POOLER_TYPE="ROIPool",
                SOLVER__IMS_PER_BATCH=8, TEST__AUG__ENABLED=False)
        work, opts, hw = entry_setup(f"ph19_{name}", 19, PH12_TRAIN,
                                     PH19_TEST)
        opts += ["SOLVER.IMS_PER_BATCH", "4", "SOLVER.BASE_LR",
                 str(PH19_LR), "SOLVER.MAX_ITER", str(PH19_STEPS),
                 "SOLVER.CHECKPOINT_PERIOD", str(PH19_STEPS),
                 "TEST.EVAL_TRAIN", "False"]
        calls = []
        run = entry_main(19, dev, yaml, opts, hw, [sampler_capture(calls)])
        per_step = check_steps(19, run, ["plain"] * PH19_STEPS,
                               {"plain": SUPERVISED_NAMES[name]})
        buckets = sorted({b for _, b, _, _ in per_step})
        if len(buckets) < 2:
            raise Fail(f"phase 19: {name} trained at buckets {buckets}, "
                       "want two")
        if run["launches"]["roi_pool"] != 0:
            raise Fail(f"phase 19: {name} launched K1 "
                       f"{run['launches']['roi_pool']} times; its trainable "
                       "backbone takes the differentiable pool")
        check_detections(19, run, PH19_TEST)
        n_fg = [n for c in calls for n in c["n_fg"]]
        if len(calls) != PH19_STEPS or any(c["slots"] != 512
                                           for c in calls) \
                or max(n_fg) > 128:
            raise Fail(f"phase 19: {name} sampler calls {len(calls)}, slots "
                       f"{[c['slots'] for c in calls]}, foreground per image "
                       f"{n_fg}: want one call a step, 512 slots, at most "
                       "128 foreground")
        args, kw, out = calls[0]["first"]
        cpu = fast_rcnn.subsample_proposals(*(a.cpu() for a in args), **kw)
        same = [f for f, a, b in zip(out._fields, out, cpu)
                if torch.equal(a.cpu(), b)]
        if len(same) != len(out._fields):
            raise Fail(f"phase 19: {name} sampler core on the card differs "
                       f"from the CPU's: only {same} equal")
        neck = ("DAN [2048, 4096]" if name == "fast_rcnn"
                else "3 stages of 2 FC 1024, class-agnostic boxes")
        print_entry(19, f"{name} train_net.main ({yaml.name}: WS-R50 DC5, "
                    f"FREEZE_AT 2, {neck}, bfloat16, dropout 0.5, the YAML's 640-800 scales, "
                    f"P=4096, seeded random weights) {PH19_STEPS} steps of "
                    f"B=4 (the YAML's 8 cut) at BASE_LR {PH19_LR} (the "
                    f"YAML's 0.01 cut) on a packed shard of "
                    f"{PH12_TRAIN} records with instance GT, then the eval "
                    f"without TTA of {PH19_TEST} images", per_step, run,
                    None, "none: the differentiable pool", PH19_TEST,
                    f"; buckets {buckets}; sampler: 512 slots, foreground "
                    f"per image {n_fg}, valid per image "
                    f"{[n for c in calls for n in c['n_valid']]}; its core "
                    f"on the card == CPU on the same keys "
                    f"({', '.join(same)})"
                    f"; phase so far {time.perf_counter() - t_phase:.1f} s",
                    tag)
        calls.clear()
        launches[name] = run["launches"]
        shutil.rmtree(work, ignore_errors=True)
    return {k: sum(v[k] for v in launches.values())
            for k in launches["fast_rcnn"]}


def sgd_decay_factor(cfg, steps: int) -> float:
    """The factor SGD with zero gradients leaves on a decayed weight after
    ``steps`` updates (coupled decay, then momentum, then the lr), in
    float64 from the config's schedule."""
    from drn_wsod_torch.solver.build import build_lr_schedule

    s, sched = cfg.SOLVER, build_lr_schedule(cfg)
    a, t = 1.0, 0.0
    for k in range(steps):
        t = s.WEIGHT_DECAY * a + s.MOMENTUM * t
        a -= sched(k) * t
    return a


def pool_capture(captured: dict):
    """A stand-in for ``meta_arch.multilevel_roi_pool`` that keeps the
    first image's pyramid and boxes a train step gives it."""
    from drn_wsod_torch.models import meta_arch

    pool = meta_arch.multilevel_roi_pool

    def capture(features, strides, boxes, *a, **kw):
        if torch.is_grad_enabled() and "features" not in captured:
            captured.update(features={k: v.clone()
                                      for k, v in features.items()},
                            strides=dict(strides), boxes=boxes.clone(),
                            args=a, kw=kw)
        return pool(features, strides, boxes, *a, **kw)

    return meta_arch, "multilevel_roi_pool", capture


def phase20_fpn(dev, tag) -> dict:
    """The FPN (``COCO-Detection/fpn_oicr_WSR_50_1x.yaml``: WS-R50 pyramid,
    FPN 256, ROIAlignV2 over p2-p5, DAN [1024, 4096], 80 classes, 3 OICR
    branches, bfloat16, FREEZE_AT 5, TTA) through ``train_net.main`` at
    full width from seeded random weights on a packed COCO-format shard:
    PH20_STEPS steps of B=4, then the TTA eval of PH20_TEST images (P=4096
    a view). Every loss finite, no K1 launch, the multi-level pool on the
    card against the CPU on one image's pyramid and RoIs (bfloat16: values
    equal, largest difference within one ulp), and every bottom-up and FPN
    weight moved by weight decay and momentum alone: its ratio to the
    start is the one scalar the schedule gives, the biases unchanged."""
    import shutil

    import drn_wsod_torch
    from drn_wsod_torch.data import DatasetCatalog
    from drn_wsod_torch.ops.poolers import (assign_boxes_to_levels,
                                            multilevel_roi_pool)
    from drn_wsod_torch.tools import train_net

    t_phase = time.perf_counter()
    yaml = Path(__file__).resolve().parent / "configs" / \
        "COCO-Detection" / "fpn_oicr_WSR_50_1x.yaml"
    yaml_is(20, yaml, MODEL__BACKBONE__NAME="build_resnet_fpn_backbone",
            MODEL__FPN__OUT_CHANNELS=256, MODEL__ROI_HEADS__IN_FEATURES=[
                "p2", "p3", "p4", "p5"],
            MODEL__ROI_BOX_HEAD__POOLER_TYPE="ROIAlignV2",
            MODEL__ROI_BOX_HEAD__DAN_DIM=[1024, 4096],
            MODEL__ROI_HEADS__NUM_CLASSES=80, MODEL__BACKBONE__FREEZE_AT=5,
            MODEL__DTYPE="bfloat16", SOLVER__IMS_PER_BATCH=4,
            TEST__AUG__ENABLED=True)
    work = Path(__file__).resolve().parent / "build" / "chip_smoke_ph20"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    rs = np.random.RandomState(20)
    train_props, train_hw = coco_split(work, "coco_2014_train", PH20_TRAIN,
                                       rs, 0)
    test_props, test_hw = coco_split(work, "coco_2014_val", PH20_TEST, rs, 1)
    opts = ["DATASETS.PROPOSAL_FILES_TRAIN", repr((train_props,)),
            "DATASETS.PROPOSAL_FILES_TEST", repr((test_props,)),
            "MODEL.WEIGHTS", "", "OUTPUT_DIR", str(work / "output"),
            "SEED", "0", "TEST.EVAL_PERIOD", "0", "TEST.EVAL_TRAIN", "False",
            "SOLVER.MAX_ITER", str(PH20_STEPS), "SOLVER.CHECKPOINT_PERIOD",
            str(PH20_STEPS)]
    cfg = drn_wsod_torch.get_cfg()
    cfg.merge_from_file(str(yaml))
    cfg.merge_from_list(opts)
    built, captured = {}, {}
    build_model = train_net.build_model

    def snapshot(cfg, device=None):
        model = build_model(cfg, device=device)
        built["model"] = model
        built["before"] = {k: v.detach().cpu().clone() for k, v in
                           model.backbone.named_parameters()}
        return model
    try:
        run = entry_main(20, dev, yaml, opts, {**train_hw, **test_hw},
                         [pool_capture(captured),
                          (train_net, "build_model", snapshot)], coco=True)
    finally:
        for name in ("coco_2014_train", "coco_2014_val"):
            if name in DatasetCatalog:
                DatasetCatalog.remove(name)
    per_step = check_steps(20, run, ["plain"] * PH20_STEPS,
                           {"plain": OICR_NAMES})
    if run["launches"]["roi_pool"] != 0:
        raise Fail(f"phase 20: K1 launched {run['launches']['roi_pool']} "
                   "times; the FPN pools by RoIAlign")
    check_detections(20, run, PH20_TEST)
    model = built["model"]
    if model.pyramid_strides != (("p2", 4), ("p3", 8), ("p4", 16),
                                 ("p5", 32)):
        raise Fail(f"phase 20: pyramid {model.pyramid_strides}")
    want = sgd_decay_factor(cfg, PH20_STEPS)
    after = {k: v.detach().cpu() for k, v in
             model.backbone.named_parameters()}
    spread, bad = 0.0, []
    for k, p0 in built["before"].items():
        p = after[k]
        if k.endswith(".bias"):
            if not torch.equal(p, p0):
                bad.append(k)
            continue
        nz = p0 != 0
        ratio = p.double()[nz] / p0.double()[nz]
        spread = max(spread, float(ratio.max() - ratio.min()))
        if abs(float(ratio.mean()) - want) > 1e-6 or \
                float(ratio.max() - ratio.min()) > 2e-6:
            bad.append(k)
    if bad or len(after) != len(built["before"]):
        raise Fail(f"phase 20: frozen backbone weights moved other than by "
                   f"decay (factor {want}): {bad[:4]}")
    feats = captured.get("features")
    if feats is None:
        raise Fail("phase 20: no multi-level pool captured in a train step")
    args = (captured["strides"], captured["boxes"], *captured["args"])
    got = multilevel_roi_pool(feats, *args, **captured["kw"])
    cpu = multilevel_roi_pool({k: v.cpu() for k, v in feats.items()},
                              captured["strides"], captured["boxes"].cpu(),
                              *captured["args"], **captured["kw"])
    equal, ulps = bf16_ulps(got, cpu)
    if ulps > 1:
        raise Fail(f"phase 20: multi-level pool on the card {ulps} bf16 "
                   "ulps from the CPU")
    levels = torch.bincount(assign_boxes_to_levels(
        captured["boxes"], 2, 5).long().cpu(), minlength=6)[2:].tolist()
    pool_ms = cuda_ms(lambda: multilevel_roi_pool(feats, *args,
                                                  **captured["kw"]), 3)
    print_entry(20, f"FPN OICR train_net.main, {PH20_STEPS} steps of B=4 "
                f"(COCO-Detection/fpn_oicr_WSR_50_1x: WS-R50 pyramid, FPN "
                f"256 p2-p6, ROIAlignV2 over p2-p5, DAN [1024, 4096], 80 "
                f"classes, 3 OICR branches, bfloat16, FREEZE_AT 5, dropout "
                f"0.5, crop, 24 scales, flip, P=4096, seeded random "
                f"weights) on a packed COCO-format shard of {PH20_TRAIN} "
                f"images, then TTA eval of {PH20_TEST} images", per_step,
                run, None, "none: the pyramid pools by RoIAlign",
                PH20_TEST,
                f"; {len(after)} bottom-up and FPN tensors in the optimizer "
                f"with zero gradients: every weight's ratio to its start "
                f"the decay factor {want:.9f} (largest spread {spread:.3g}), "
                f"every bias unchanged; multi-level pool of one image "
                f"({tuple(captured['boxes'].shape)} RoIs, levels p2-p5 "
                f"{levels}, pyramid "
                f"{[tuple(v.shape) for v in feats.values()]}) on the card "
                f"vs the CPU: {equal:.6f} of the values equal, largest "
                f"difference {ulps:g} bf16 ulps; {pool_ms:.3f} ms a call "
                f"(CUDA events)"
                f"; phase {time.perf_counter() - t_phase:.1f} s", tag)
    built.clear()
    captured.clear()
    shutil.rmtree(work, ignore_errors=True)
    return run["launches"]


def deform_capture(captured: dict):
    """A stand-in for ``resnet_ws.deform_conv2d`` that keeps the first
    image of the first call a train step makes."""
    from drn_wsod_torch.models.backbones import resnet_ws

    op = resnet_ws.deform_conv2d

    def capture(x, offsets, weight, modulation=None, dilation=1):
        if "x" not in captured:
            captured.update(x=x[:1].clone(), offsets=offsets[:1].clone(),
                            weight=weight.clone(), dilation=dilation,
                            modulation=None if modulation is None
                            else modulation[:1].clone())
        return op(x, offsets, weight, modulation, dilation=dilation)

    return resnet_ws, "deform_conv2d", capture


def zero_offset_check(block, x) -> tuple:
    """The modulated block with its offset conv zeroed and its mask bias
    at 30 (sigmoid 1 in float32) against the plain bottleneck of the same
    weights on ``x``: (largest |diff|, one bfloat16 ulp of the largest
    |value|)."""
    import copy

    from drn_wsod_torch.models.backbones.resnet_ws import BottleneckBlock

    deform = copy.deepcopy(block)
    with torch.no_grad():
        deform.conv2_offset.weight.zero_()
        deform.conv2_offset.bias.zero_()
        deform.conv2_offset.bias[18:] = 30.0
        plain = BottleneckBlock(
            deform.conv1.in_channels, deform.conv3.out_channels,
            deform.conv1.out_channels, dilation=deform.conv2.dilation[0],
            has_pool=deform.has_pool, pool_stride=deform.pool_stride,
            dtype=deform.conv1.compute_dtype).to(x.device)
        plain.load_state_dict({k: v for k, v in deform.state_dict().items()
                               if "conv2_offset" not in k})
        plain.to(memory_format=torch.channels_last)
        a, b = deform(x).float(), plain(x).float()
    top = float(b.abs().max())
    return float((a - b).abs().max()), 2.0 ** (math.floor(math.log2(top))
                                               - 7)


def phase21_deform(dev, tag) -> dict:
    """Deformable blocks (``oicr_WSR_50_DC5_deform_1x.yaml``: modulated
    deformable bottlenecks in res4 and res5, FREEZE_AT 5, K1, TTA) through
    ``train_net.main`` at full width from seeded random weights (nonzero
    ``conv2_offset``): PH21_STEPS steps of B=4, then the TTA eval of
    PH21_TEST images. Every loss finite, K1 once per step and per TTA
    group and exact at the largest map, ``deform_conv2d`` on the card
    against the CPU on one image of a train step's call (bfloat16, within
    one ulp of each value plus 2^-15 of the largest, for the float32
    sums' order), and res4's first block with zero offsets and unit masks
    against the plain bottleneck of its weights (within 2 bfloat16 ulps of
    the largest value)."""
    import shutil

    import drn_wsod_torch
    from drn_wsod_torch.ops.deform_conv import deform_conv2d
    from drn_wsod_torch.tools import train_net

    t_phase = time.perf_counter()
    yaml = Path(__file__).resolve().parent / "configs" / \
        "PascalVOC-Detection" / "oicr_WSR_50_DC5_deform_1x.yaml"
    yaml_is(21, yaml, MODEL__RESNETS__DEFORM_ON_PER_STAGE=[
                False, False, True, True],
            MODEL__RESNETS__DEFORM_MODULATED=True, MODEL__RESNETS__DEPTH=50,
            MODEL__BACKBONE__FREEZE_AT=5, MODEL__DTYPE="bfloat16",
            SOLVER__IMS_PER_BATCH=4, TEST__AUG__ENABLED=True)
    work, opts, hw = entry_setup("ph21", 21, PH12_TRAIN, PH21_TEST)
    opts += ["SOLVER.MAX_ITER", str(PH21_STEPS), "SOLVER.CHECKPOINT_PERIOD",
             str(PH21_STEPS), "TEST.EVAL_TRAIN", "False"]
    cfg = drn_wsod_torch.get_cfg()
    cfg.merge_from_file(str(yaml))
    cfg.merge_from_list(opts)
    tta_groups = tta_group_count(cfg, {k: v for k, v in hw.items()
                                       if int(k) >= 100})
    captured, deform, built = {}, {}, {}
    build_model = train_net.build_model

    def keep(cfg, device=None):
        built["model"] = build_model(cfg, device=device)
        return built["model"]
    run = entry_main(21, dev, yaml, opts, hw, [
        k1_capture(captured), deform_capture(deform),
        (train_net, "build_model", keep)])
    per_step = check_steps(21, run, ["plain"] * PH21_STEPS,
                           {"plain": OICR_NAMES})
    if run["launches"]["roi_pool"] != PH21_STEPS + tta_groups:
        raise Fail(f"phase 21: K1 launches {run['launches']['roi_pool']}, "
                   f"want {PH21_STEPS} steps + {tta_groups} TTA groups")
    check_detections(21, run, PH21_TEST)
    model = built.pop("model")
    block = model.backbone.res4[0]
    if type(block).__name__ != "DeformBottleneckBlock" or \
            block.conv2_offset.out_channels != 27 or \
            not block.conv2_offset.weight.abs().sum() > 0:
        raise Fail("phase 21: res4's blocks are not modulated deformable "
                   "blocks with a nonzero offset conv")
    if "x" not in deform:
        raise Fail("phase 21: no deform_conv2d call captured")
    args = (deform["x"], deform["offsets"], deform["weight"],
            deform["modulation"])
    got = deform_conv2d(*args, dilation=deform["dilation"]).float().cpu()
    cpu = deform_conv2d(*(a.cpu() for a in args),
                        dilation=deform["dilation"]).float()
    # the sampled taps round alike on both devices; the float32 sums
    # differ in order, which near a cancelling sum moves the one bf16
    # rounding by more than an ulp of the (small) value: allow one ulp of
    # the value plus 2^-15 of the largest |value|
    d_equal, d_ulps = bf16_ulps(got, cpu)
    top = float(cpu.abs().max())
    ulp = 2.0 ** (torch.floor(torch.log2(cpu.abs().clamp(min=2.0 ** -126)))
                  - 7)
    d_off = (got - cpu).abs() - ulp
    if float(d_off.max()) > top * 2.0 ** -15:
        raise Fail(f"phase 21: deform_conv2d on the card "
                   f"{float(d_off.max())} past one ulp from the CPU "
                   f"(allowed {top * 2.0 ** -15})")
    d_top = float((got - cpu).abs().max()) / (2.0 ** (math.floor(
        math.log2(top)) - 7))
    d_more = int((d_off > 0).sum())
    d_ms = cuda_ms(lambda: deform_conv2d(*args, dilation=deform["dilation"]),
                   3)
    x = torch.relu(torch.randn(2, block.conv1.in_channels, 88, 88,
                               device=dev, dtype=torch.bfloat16)).to(
        memory_format=torch.channels_last)
    z_diff, z_tol = zero_offset_check(block, x)
    if z_diff > 2 * z_tol:
        raise Fail(f"phase 21: the block with zero offsets is {z_diff} from "
                   f"the plain bottleneck (2 ulps: {2 * z_tol})")
    del model, block
    k1 = k1_exact(21, captured)
    print_entry(21, f"deformable OICR train_net.main, {PH21_STEPS} steps of "
                f"B=4 (oicr_WSR_50_DC5_deform_1x: WS-R50 DC5, modulated "
                f"deformable res4 and res5, DAN [2048, 4096], 3 OICR "
                f"branches, bfloat16, FREEZE_AT 5, dropout 0.5, crop, 24 "
                f"scales, flip, P=4096, seeded random weights with nonzero "
                f"offset convs) on a packed shard of {PH12_TRAIN} records, "
                f"then TTA eval of {PH21_TEST} images", per_step, run, k1,
                f"{PH21_STEPS} steps + {tta_groups} TTA groups", PH21_TEST,
                f"; deform_conv2d of one image "
                f"{tuple(deform['x'].shape)} (dilation "
                f"{deform['dilation']}, weight "
                f"{tuple(deform['weight'].shape)}) on the card vs the CPU: "
                f"{d_equal:.6f} of the values equal, {d_more} of "
                f"{cpu.numel()} more than an ulp of their own from the CPU "
                f"(largest {d_ulps:g} of its own ulps), largest difference "
                f"{d_top:g} ulps of the largest |value| {top:g}; "
                f"{d_ms:.3f} ms a call (CUDA events); "
                f"res4.0 with zero offsets and unit masks vs the plain "
                f"bottleneck on (2, {x.shape[1]}, 88, 88): max |diff| "
                f"{z_diff:g} (one bf16 ulp of the largest value {z_tol:g})"
                f"; phase {time.perf_counter() - t_phase:.1f} s", tag)
    deform.clear()
    shutil.rmtree(work, ignore_errors=True)
    return run["launches"]


PH22_TRAIN, PH22_TEST, PH22_STEPS, PH22_DECODES = 8, 2, 4, 20
# the fixtures timed on the host: VOC-sized baseline and progressive, and
# COCO-sized
PH22_TIMED = ("voc_500x375_q90.jpg", "voc_500x375_q90_progressive.jpg",
              "coco_640x480_q75.jpg")
PH22_TEST_FILES = ("voc_500x375_q90.jpg", "coco_640x480_q75.jpg")


def sha256_of(a) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@contextlib.contextmanager
def no_pillow():
    """Pillow unimportable inside the block, whether or not the machine
    has it: what decodes there decodes with the port's own decoder."""
    keys = ("PIL", "PIL.Image")
    saved = {k: sys.modules[k] for k in keys if k in sys.modules}
    sys.modules.update(dict.fromkeys(keys))
    try:
        yield
    finally:
        for k in keys:
            sys.modules.pop(k)
        sys.modules.update(saved)


def ph22_voc(root: Path, fixtures: Path, manifest: dict, rs):
    """A VOC-layout directory (``voc_tree``) from the JPEG fixtures Pillow
    wrote (``make_jpeg_fixtures.FIXTURES``): the RGB ones not cut short
    under PH22_TRAIN trainval ids, PH22_TEST_FILES under test ids 100+. Returns (directory, proposal file, {id: (H, W)}, {id: fixture
    name})."""
    from drn_wsod_torch.tools.make_jpeg_fixtures import FIXTURES

    colour = [n for n, e in manifest["files"].items()
              if n in FIXTURES and e["mode"] == "RGB"
              and e["truncate"] is None]
    names = {f"{i:06d}": colour[i % len(colour)] for i in range(PH22_TRAIN)}
    names.update({f"{100 + i:06d}": n
                  for i, n in enumerate(PH22_TEST_FILES)})
    sources = {fid: (fixtures / n, manifest["files"][n]["shape"][:2])
               for fid, n in names.items()}
    d, prop_file, hw = voc_tree(root, sources, rs)
    return d, prop_file, hw, names


def voc_tree(root: Path, sources: dict, rs):
    """A VOC-layout directory: each of ``sources`` ({id: (file, (H, W))})
    copied to ``JPEGImages/<id>.jpg`` whatever its format, as VOC names
    its files, ids below 100 in the trainval split and the others in the
    test split, each with an XML of 1-2 objects of random VOC classes;
    and a Detectron2 proposal pickle of P proposals an image (phase 10's
    ``eval_image`` boxes). Returns (directory, proposal file, {id: (H,
    W)})."""
    import pickle
    import shutil

    from drn_wsod_torch.data.datasets.voc import VOC_CLASS_NAMES

    d = root / "VOC2007"
    for sub in ("Annotations", "ImageSets/Main", "JPEGImages"):
        (d / sub).mkdir(parents=True)
    props = {"ids": [], "boxes": [], "objectness_logits": [], "bbox_mode": 0}
    hw = {}
    for fid, (src, (H, W)) in sources.items():
        shutil.copyfile(src, d / "JPEGImages" / f"{fid}.jpg")
        hw[fid] = (H, W)
        _, rec = eval_image(rs, H, W, int(fid))
        objs = ""
        for a in rec["annotations"][:2]:
            x1, y1, x2, y2 = (int(v) for v in a["bbox"])
            objs += (f"<object><name>{VOC_CLASS_NAMES[a['category_id']]}"
                     f"</name><difficult>0</difficult><bndbox><xmin>"
                     f"{x1 + 1}</xmin><ymin>{y1 + 1}</ymin><xmax>{x2 + 1}"
                     f"</xmax><ymax>{y2 + 1}</ymax></bndbox></object>")
        (d / "Annotations" / f"{fid}.xml").write_text(
            f"<annotation><size><width>{W}</width><height>{H}</height>"
            f"<depth>3</depth></size>{objs}</annotation>\n")
        props["ids"].append(fid)
        props["boxes"].append(rec["proposal_boxes"])
        props["objectness_logits"].append(rec["proposal_objectness_logits"])
    for split, ids in (("trainval", [i for i in sources if int(i) < 100]),
                       ("test", [i for i in sources if int(i) >= 100])):
        (d / "ImageSets" / "Main" / f"{split}.txt").write_text(
            "\n".join(ids) + "\n")
    prop_file = root / "proposals.pkl"
    with open(prop_file, "wb") as f:
        pickle.dump(props, f)
    return d, str(prop_file), hw


def phase22_jpeg(dev, tag, host_build: dict):
    """JPEG files on the main path, decoded by the port's own decoder
    (``ops/csrc/jpeg_decode.cpp``, built by the host's C++ compiler in
    phase 2; the machine has neither Pillow nor libjpeg, and Pillow is
    blocked here all the same): (b) the decode of every fixture Pillow
    wrote (``make_jpeg_fixtures.FIXTURES``) at each scale its manifest records
    against the digest there (CMYK at 8, the only scale Pillow decodes);
    (c) the host decode time of PH22_TIMED; (d) ``read_image`` decoding
    CMYK to its digest; (e, f) a VOC directory of the fixtures
    packed by ``pack_dataset``, its pixels the fixtures' digests in BGR;
    (g, h) ``train_net.main`` on the flagship YAML at full width, PH22_STEPS
    steps of B=4 from the shard, then the YAML's TTA eval of the PH22_TEST
    unpacked test records, each decoded from its file by ``read_image``;
    (i) losses finite, K1 once per step and per TTA group and exact at the
    largest map, each test image's detections (every finite score kept:
    random weights keep none above the YAML's 1e-5) present, finite and
    inside the image. Returns (K1 launches, the decoder's summary
    line)."""
    import shutil

    import drn_wsod_torch
    from drn_wsod_torch import native, tta
    from drn_wsod_torch.data import (DatasetCatalog, MetadataCatalog,
                                     RecordDataset, pack_dataset)
    from drn_wsod_torch.data import mapper
    from drn_wsod_torch.data.datasets.voc import (VOC_CLASS_NAMES,
                                                  load_voc_instances)
    from drn_wsod_torch.tools import make_jpeg_fixtures

    t_phase = time.perf_counter()
    here = Path(__file__).resolve().parent
    fixtures = make_jpeg_fixtures.FIXTURE_DIR
    manifest = json.loads((fixtures / "manifest.json").read_text())
    with no_pillow():
        # (b) every fixture Pillow wrote, at each recorded scale
        checked = check_jpeg_digests(22, fixtures, manifest,
                                     make_jpeg_fixtures.FIXTURES)
        # (c) host decode time, ms an image
        decode_ms = {}
        for name in PH22_TIMED:
            data = (fixtures / name).read_bytes()
            times = []
            for _ in range(PH22_DECODES):
                t = time.perf_counter()
                native.jpeg_decode(data)
                times.append((time.perf_counter() - t) * 1e3)
            decode_ms[name] = statistics.median(times)
        # (d) CMYK, which only Pillow decodes, through read_image
        cmyk = mapper.read_image(str(fixtures / "cmyk_64x48.jpg"), "RGB")
        if sha256_of(cmyk) != \
                manifest["files"]["cmyk_64x48.jpg"]["read_image_sha256"]:
            raise Fail("phase 22: read_image on the CMYK fixture differs "
                       "from Pillow's decode")
        # (e, f) a VOC directory of the fixtures, packed
        work = here / "build" / "chip_smoke_ph22"
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
        voc, prop_file, hw, names = ph22_voc(work, fixtures, manifest,
                                             np.random.RandomState(22))
        shard = work / "ph22_train.rec"
        t = time.perf_counter()
        n_packed = pack_dataset(load_voc_instances(str(voc), "trainval"),
                                str(shard))
        pack_s = time.perf_counter() - t
        packed = list(RecordDataset(str(shard)))
        for r in packed:
            want = manifest["files"][names[r["image_id"]]]["sha256"]["8"]
            if sha256_of(r["image"][:, :, ::-1]) != want:
                raise Fail(f"phase 22: packed pixels of {r['image_id']} "
                           f"are not {names[r['image_id']]}'s decode")
        if n_packed != PH22_TRAIN or len(packed) != PH22_TRAIN:
            raise Fail(f"phase 22: packed {n_packed} records, want "
                       f"{PH22_TRAIN}")
        for name, get in (("ph22_train",
                           lambda: list(RecordDataset(str(shard)))),
                          ("ph22_test",
                           lambda: load_voc_instances(str(voc), "test"))):
            if name in DatasetCatalog:
                DatasetCatalog.remove(name)
            DatasetCatalog.register(name, get)
            MetadataCatalog.get(name).set(
                thing_classes=list(VOC_CLASS_NAMES),
                evaluator_type="pascal_voc", year=2007, split=name)
        # (g, h) the flagship from the shard, then TTA from the JPEGs
        yaml = here / "configs" / "PascalVOC-Detection" / \
            "oicr_WSR_50_DC5_1x.yaml"
        yaml_is(22, yaml, MODEL__ROI_BOX_HEAD__DAN_DIM=[2048, 4096],
                SOLVER__IMS_PER_BATCH=4, INPUT__CROP__ENABLED=True,
                INPUT__MAX_SIZE_TRAIN=2000, MODEL__DTYPE="bfloat16",
                TEST__AUG__ENABLED=True, TEST__AUG__FLIP=True)
        opts = ["DATASETS.TRAIN", "('ph22_train',)",
                "DATASETS.TEST", "('ph22_test',)",
                "DATASETS.PROPOSAL_FILES_TRAIN", repr((prop_file,)),
                "DATASETS.PROPOSAL_FILES_TEST", repr((prop_file,)),
                "MODEL.WEIGHTS", "", "OUTPUT_DIR", str(work / "output"),
                "SEED", "0", "TEST.EVAL_PERIOD", "0",
                "SOLVER.MAX_ITER", str(PH22_STEPS),
                "SOLVER.CHECKPOINT_PERIOD", str(PH22_STEPS),
                "TEST.EVAL_TRAIN", "False",
                # 4 steps from random weights leave no class score above
                # the YAML's 1e-5, and some images' at exactly 0: keep
                # every finite score, so that each image keeps detections
                # to check and only a NaN score leaves it none
                "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "-1.0"]
        test_hw = {k: v for k, v in hw.items() if int(k) >= 100}
        cfg = drn_wsod_torch.get_cfg()
        cfg.merge_from_file(str(yaml))
        cfg.merge_from_list(opts)
        tta_groups = tta_group_count(cfg, test_hw)
        decoded = []
        read = tta.read_image

        def counted_read(path, fmt="BGR"):
            decoded.append(Path(path).name)
            return read(path, fmt)

        captured = {}
        run = entry_main(22, dev, yaml, opts, hw, [
            k1_capture(captured), (tta, "read_image", counted_read)])
    per_step = check_steps(22, run, ["plain"] * PH22_STEPS,
                           {"plain": OICR_NAMES})
    if run["launches"]["roi_pool"] != PH22_STEPS + tta_groups:
        raise Fail(f"phase 22: K1 launches {run['launches']['roi_pool']}, "
                   f"want {PH22_STEPS} steps + {tta_groups} TTA groups")
    check_detections(22, run, PH22_TEST)
    if any(n == 0 for _, n in run["dets"]):
        raise Fail(f"phase 22: images without a finite score: "
                   f"{run['dets']}")
    if sorted(decoded) != sorted(f"{i}.jpg" for i in test_hw):
        raise Fail(f"phase 22: the TTA eval decoded {decoded}, want the "
                   f"{PH22_TEST} test JPEGs")
    k1 = k1_exact(22, captured)
    times = ", ".join(f"{n} {decode_ms[n]:.3f}" for n in PH22_TIMED)
    print_entry(22, f"JPEG: {checked} decodes of "
                f"{len(make_jpeg_fixtures.FIXTURES)} fixtures equal their "
                "manifest digests at each recorded scale (Pillow blocked), "
                "CMYK decoded by read_image to Pillow's digest; host decode "
                f"ms an image (median of "
                f"{PH22_DECODES}, host time, not the card's): {times}; "
                f"pack_dataset of {PH22_TRAIN} JPEG records in {pack_s:.2f} "
                "s, pixels equal the fixtures' digests; the flagship "
                f"train_net.main, {PH22_STEPS} steps of B=4 (DAN [2048, "
                "4096], bfloat16, crop, 24 scales, flip, P=4096, seeded "
                "random weights) from the shard, then TTA eval of "
                f"{PH22_TEST} unpacked test records decoded by read_image "
                f"from their JPEGs ({len(decoded)} decodes)", per_step, run,
                k1, f"{PH22_STEPS} steps + {tta_groups} TTA groups",
                PH22_TEST, f"; phase {time.perf_counter() - t_phase:.1f} s",
                tag)
    shutil.rmtree(work, ignore_errors=True)
    line = (f"jpeg decoder: ops/csrc/jpeg_decode.cpp built by "
            f"{host_build['compiler']} in {host_build['seconds']:.2f} s "
            f"(no libjpeg); {checked} fixture decodes matched at their "
            "recorded scales; host ms an image " + times)
    return run["launches"], line


def check_jpeg_digests(phase: int, fixtures: Path, manifest: dict,
                       names) -> int:
    """The decode of each of the JPEG fixtures ``names`` at each scale its
    manifest entry records, against the digest there (Pillow blocked by
    the caller); returns the count of decodes."""
    from drn_wsod_torch import native

    checked = 0
    for name in names:
        entry = manifest["files"][name]
        data = (fixtures / name).read_bytes()
        for s, want in entry["sha256"].items():
            a = native.jpeg_decode(data, int(s))
            if a is None or sha256_of(a) != want:
                raise Fail(f"phase {phase}: {name} at scale {s}/8 differs "
                           "from its manifest digest ("
                           f"{native.jpeg_unsupported_reason(data)})")
            checked += 1
    return checked



# ------------------------------------------------------------- phase 23
PH23_STEPS, PH23_CASCADE_STEPS, PH23_NEAR = 4, 2, 48
PH23_HEAD_ROIS = 128
# Detectron2's COCO-Keypoints/keypoint_rcnn_R_50_FPN_1x.yaml on the Mask
# R-CNN YAML's base: person only, 17 keypoints, no mask head
PH23_KEYPOINT = ["MODEL.MASK_ON", "False", "MODEL.KEYPOINT_ON", "True",
                 "MODEL.ROI_HEADS.NUM_CLASSES", "1"]


def ph23_split(root: Path, name: str, coco: dict, rs):
    """A COCO json dict loaded by ``load_coco_json`` (``name``'s
    metadata set), its records given random u8 pixels and PH11_PROPOSALS
    proposals (PH23_NEAR near its GT boxes first, then phase 10's
    VOC-like ones), packed by ``pack_dataset`` and registered under
    ``name``. Returns (proposals pickle, {image_id: (H, W)}, shard path)."""
    import json
    import pickle

    from drn_wsod_torch.data import (DatasetCatalog, RecordDataset,
                                     pack_dataset)
    from drn_wsod_torch.data.datasets import load_coco_json

    json_file = root / f"{name}.json"
    json_file.write_text(json.dumps(coco))
    records = load_coco_json(str(json_file), str(root / name), name)
    props = {"ids": [], "boxes": [], "objectness_logits": [], "bbox_mode": 0}
    for r in records:
        H, W = r["height"], r["width"]
        image, rec = eval_image(rs, H, W, r["image_id"], P=PH11_PROPOSALS)
        r["image"] = image
        boxes = rec["proposal_boxes"]
        gt = np.asarray([a["bbox"] for a in r["annotations"]], np.float32)
        if len(gt):
            near = gt[rs.randint(len(gt), size=PH23_NEAR)]
            near = near + rs.uniform(-0.08, 0.08, near.shape) * np.tile(
                near[:, 2:] - near[:, :2], 2)
            near = np.clip(near, 0, [W - 1, H - 1, W - 1, H - 1])
            boxes = np.concatenate([near, boxes])[:PH11_PROPOSALS]
        props["ids"].append(r["image_id"])
        props["boxes"].append(boxes.astype(np.float32))
        props["objectness_logits"].append(rec["proposal_objectness_logits"])
    shard = root / f"{name}.rec"
    pack_dataset(records, str(shard))
    prop_file = root / f"{name}_proposals.pkl"
    with open(prop_file, "wb") as f:
        pickle.dump(props, f)
    if name in DatasetCatalog:
        DatasetCatalog.remove(name)
    DatasetCatalog.register(name, lambda: list(RecordDataset(str(shard))))
    return str(prop_file), {str(r["image_id"]): (r["height"], r["width"])
                            for r in records}, shard


def ph23_rasterizer(shard: Path, manifest: dict) -> str:
    """The rasterizer without Pillow against the committed digests of
    Pillow's masks: every polygon case of the manifest, and the Mask
    R-CNN YAML's training mapper on the packed shard's records, each with
    its manifest seed (every instance's mask in its bucket)."""
    from drn_wsod_torch.data import DatasetMapper, RecordDataset
    from drn_wsod_torch.structures.masks import fill_polygon
    from drn_wsod_torch.tools import make_mask_fixtures as fx

    t = time.perf_counter()
    with no_pillow():
        for c in manifest["polygons"]:
            out = np.zeros((c["height"], c["width"]), bool)
            for poly in c["polygons"]:
                fill_polygon(out, np.reshape(poly, (-1, 2)))
            if fx.mask_digest(out) != c["sha256"]:
                raise Fail(f"phase 23: polygon case {c} differs from "
                           "Pillow's fill")
        t_cases = time.perf_counter() - t
        mapper = DatasetMapper(fx.mask_mapper_cfg(), is_train=True)
        n, t_map, buckets = 0, 0.0, []
        records = list(RecordDataset(str(shard)))
        for r, e in zip(records, manifest["mapper"]):
            if r["image_id"] != e["image_id"]:
                raise Fail(f"phase 23: shard record {r['image_id']} is not "
                           f"the manifest's {e['image_id']}")
            t0 = time.perf_counter()
            out = mapper(r, np.random.RandomState(e["seed"]))
            t_map += time.perf_counter() - t0
            k = len(e["masks_sha256"])
            got = [fx.mask_digest(m) for m in out["gt_masks"][:k]]
            if out["_bucket"] != e["bucket"] or got != e["masks_sha256"] \
                    or out["gt_masks"][k:].any():
                raise Fail(f"phase 23: the mapper's masks of image "
                           f"{r['image_id']} differ from Pillow's")
            n += k
            buckets.append(out["_bucket"])
    if len(records) != len(manifest["mapper"]):
        raise Fail("phase 23: the shard does not hold the manifest's records")
    return (f"{len(manifest['polygons'])} polygon cases ({t_cases:.2f} s) "
            f"and the training mapper's {n} instance masks of "
            f"{len(records)} shard records (buckets {buckets}, "
            f"{t_map / len(records) * 1e3:.1f} ms a record, G=100 slots) "
            "equal to the digests of Pillow's, Pillow blocked")


def ph23_captures(captured: dict):
    """Stand-ins that keep the mask head's and the keypoint head's first
    training input (the module too), ``mask_loss``'s first arguments, and
    time the host's mask pasting and dense evaluation."""
    from drn_wsod_torch.evaluation import coco_eval
    from drn_wsod_torch.evaluation import evaluator as evaluator_lib
    from drn_wsod_torch.models.heads import keypoint, seg

    def keep(cls, key):
        forward = cls.forward

        def capture(self, x):
            if torch.is_grad_enabled() and key not in captured:
                captured[key] = (self, x.detach().clone())
            return forward(self, x)
        return cls, "forward", capture

    loss = seg.mask_loss

    def mask_loss(*args):
        captured.setdefault("mask_loss", tuple(a.detach().clone()
                                               for a in args))
        return loss(*args)

    def timed(obj, name):
        fn = getattr(obj, name)

        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                captured[f"{name}_s"] = captured.get(f"{name}_s", 0.0) + \
                    time.perf_counter() - t
        return obj, name, run

    return [keep(seg.MaskRCNNHead, "mask_head"),
            keep(keypoint.KRCNNConvDeconvUpsampleHead, "keypoint_head"),
            (seg, "mask_loss", mask_loss),
            timed(evaluator_lib, "paste_masks_in_image"),
            timed(coco_eval.COCODetectionEvaluator, "_evaluate_dense_task")]


def ph23_head_check(captured: dict) -> str:
    """The mask head's forward on PH23_HEAD_ROIS of a train step's RoIs
    and ``mask_loss`` on that step's logits and targets, on the card
    against the CPU, both in float32 (the head's convs switched from
    bfloat16 to float32 in a copy): within 1e-4 of the largest value; and
    each head's forward ms a call at the step's input."""
    import copy

    head, x = captured["mask_head"]
    h32 = copy.deepcopy(head).float()
    for m in h32.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float32
    x32 = x[:PH23_HEAD_ROIS].float()
    with torch.no_grad():
        got = h32(x32)
        want = h32.cpu()(x32.cpu())
    top = float(want.abs().max())
    err = float((got.cpu() - want).abs().max())
    if not err <= 1e-4 * top:
        raise Fail(f"phase 23: the mask head on the card differs from the "
                   f"CPU by {err} (largest {top})")
    from drn_wsod_torch.models.heads.seg import mask_loss

    args = captured["mask_loss"]
    card = float(mask_loss(*args))
    cpu = float(mask_loss(*(a.cpu() for a in args)))
    if not (math.isfinite(card) and abs(card - cpu) <= 1e-4 * abs(cpu)):
        raise Fail(f"phase 23: mask_loss on the card {card}, CPU {cpu}")
    with torch.no_grad():
        ms = {"mask": cuda_ms(lambda: head(x), 3)}
        if "keypoint_head" in captured:
            kh, kx = captured["keypoint_head"]
            ms["keypoint"] = cuda_ms(lambda: kh(kx), 3)
    return (f"mask head (4 x 256, deconv, 80 classes) on {PH23_HEAD_ROIS} "
            f"of a step's {tuple(x.shape)} RoIs on the card == CPU in "
            f"float32 to {err:.3g} (largest {top:.3g}); mask_loss card "
            f"{card:.6f} CPU {cpu:.6f} on {tuple(args[0].shape)} logits; "
            f"forward ms a call at the step's input (bf16, CUDA events): "
            + ", ".join(f"{k} head {v:.2f}" for k, v in ms.items()))


def ph23_crowd(coco: dict) -> str:
    """The test split's crowd region (uncompressed RLE, on an image with
    polygon instances of its class) through the segm evaluator that
    ``build_evaluator`` makes, Pillow blocked: decoded to its area and
    box; ignored, so that the image's polygon GT, each detected by its own
    mask, gives AP 100 with the crowd undetected; matched without penalty,
    so that a detection of the crowd's mask scored above all of them
    leaves AP at 100."""
    from drn_wsod_torch.evaluation.coco_eval import (COCODetectionEvaluator,
                                                     gt_segmentation_mask)
    from drn_wsod_torch.tools import make_mask_fixtures as fx

    with no_pillow():
        records = fx.coco_records(coco)
        gt = {str(r["image_id"]): r["annotations"] for r in records}
        crowds = [(r, a) for r in records for a in r["annotations"]
                  if a["iscrowd"]]
        if len(crowds) != 1 or not isinstance(
                crowds[0][1]["segmentation"], dict):
            raise Fail(f"phase 23: the test split holds {len(crowds)} crowd "
                       "regions, not one as RLE")
        r, crowd = crowds[0]
        m = gt_segmentation_mask(crowd["segmentation"], r["height"],
                                 r["width"])
        ys, xs = np.nonzero(m)
        box = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
        if m.sum() != crowd["area"] or not np.allclose(box, crowd["bbox"]):
            raise Fail(f"phase 23: the crowd RLE decodes to {m.sum()} pixels "
                       f"in {box}, not {crowd['area']} in {crowd['bbox']}")
        names = [f"class{c}" for c in range(len(coco["categories"]))]
        aps = []
        for with_crowd in (False, True):
            ev = COCODetectionEvaluator(names, gt, tasks=("segm",))
            for rec in records:
                annos = [a for a in rec["annotations"]
                         if with_crowd or not a["iscrowd"]]
                if not annos:
                    continue
                annos.sort(key=lambda a: -a["iscrowd"])
                ev.process_single(
                    str(rec["image_id"]),
                    np.array([a["bbox"] for a in annos]),
                    np.linspace(1.0, 0.5, len(annos)),
                    np.array([a["category_id"] for a in annos]),
                    masks=np.stack([gt_segmentation_mask(
                        a["segmentation"], rec["height"], rec["width"])
                        for a in annos]))
            aps.append(ev.evaluate()["segm"]["AP"])
    if aps != [100.0, 100.0]:
        raise Fail(f"phase 23: segm AP with the crowd undetected, detected "
                   f"first: {aps}, not 100 (crowd not ignored)")
    return (f"the test split's crowd RLE ({int(m.sum())} pixels, class "
            f"{crowd['category_id']}) decoded and ignored by the segm "
            f"evaluator: AP {aps[0]} undetected, {aps[1]} detected first")


def ph23_dense_metrics(phase_part: str, results: dict, task: str,
                       phase: int = 23) -> dict:
    """The dense task's metrics of every test dataset: finite in [0, 100],
    or NaN where no class has GT (then every one is NaN)."""
    out = {}
    for ds, tasks in results.items():
        if task not in tasks:
            raise Fail(f"phase {phase}: {phase_part} gave no {task} AP: "
                       f"{tasks}")
        vals = {k: tasks[task][k] for k in ("AP", "AP50", "AP75")}
        if not (all(math.isfinite(v) and 0 <= v <= 100
                    for v in vals.values())
                or all(math.isnan(v) for v in vals.values())):
            raise Fail(f"phase {phase}: {phase_part} {task} metrics "
                       f"{vals}")
        out.update({f"{ds}/{task}/{k}": v for k, v in vals.items()})
    return out


def phase23_masks(dev, tag) -> dict:
    """The mask and keypoint arms at full width from seeded random weights,
    each through ``train_net.main``: (a) ``Misc/mask_rcnn_R_50_FPN_1x``
    (R50-FPN, ROIAlignV2 over p2-p5, Fast R-CNN over 80 classes, the mask
    head 4 x 256 at 14^2 -> 28^2, FREEZE_AT 2, bf16) on a packed COCO
    shard of the committed fixtures' 8 train and 2 test images (polygon
    masks, a crowd RLE in each split, an image without annotations):
    PH23_STEPS steps of B=4 (the YAML's 16 cut), then the eval without TTA
    into the COCO box and mask evaluator, and the test split's crowd
    through that evaluator on its own (``ph23_crowd``); (b) the same YAML
    as Detectron2's keypoint YAML sets it (person only, 17 keypoints, the
    keypoint head 8 x 512 at 14^2 -> 56^2) on a person shard: PH23_STEPS
    steps, then keypoint AP; (c) ``cascade_rcnn_WSR_50_DC5_1x`` with
    ``MASK_ON`` on (a)'s shard: PH23_CASCADE_STEPS steps. The rasterizer
    and the mapper's masks against the committed digests of Pillow's, the
    heads' and the losses' names and finiteness, the pasted masks at the
    original size, the keypoints in the original frame, AP in range, the
    mask head and ``mask_loss`` on the card against the CPU; no K1
    launch."""
    import shutil

    from drn_wsod_torch.data import DatasetCatalog
    from drn_wsod_torch.tools import make_mask_fixtures as fx

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    mask_yaml = root / "configs" / "Misc" / "mask_rcnn_R_50_FPN_1x.yaml"
    cascade_yaml = root / "configs" / "PascalVOC-Detection" / \
        "cascade_rcnn_WSR_50_DC5_1x.yaml"
    yaml_is(23, mask_yaml, MODEL__MASK_ON=True, MODEL__KEYPOINT_ON=False,
            MODEL__BACKBONE__NAME="build_resnet_fpn_backbone",
            MODEL__BACKBONE__FREEZE_AT=2, MODEL__RESNETS__DEPTH=50,
            MODEL__ROI_HEADS__NAME="StandardROIHeads",
            MODEL__ROI_HEADS__NUM_CLASSES=80,
            MODEL__ROI_HEADS__IN_FEATURES=["p2", "p3", "p4", "p5"],
            MODEL__ROI_BOX_HEAD__POOLER_TYPE="ROIAlignV2",
            MODEL__ROI_MASK_HEAD__POOLER_RESOLUTION=14,
            MODEL__ROI_KEYPOINT_HEAD__NUM_KEYPOINTS=17,
            MODEL__ROI_KEYPOINT_HEAD__POOLER_RESOLUTION=14,
            MODEL__DTYPE="bfloat16", SOLVER__IMS_PER_BATCH=16,
            TEST__AUG__ENABLED=False)
    work = root / "build" / "chip_smoke_ph23"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    manifest = fx.load_manifest()
    rs = np.random.RandomState(23)
    names = ("coco_2017_train", "coco_2017_val", "ph23_person_train",
             "ph23_person_val")
    launches, lines, captured = {}, [], {}
    try:
        train_props, train_hw, shard = ph23_split(
            work, names[0], manifest["coco"]["train"], rs)
        test_props, test_hw, _ = ph23_split(
            work, names[1], manifest["coco"]["test"], rs)
        lines.append(ph23_rasterizer(shard, manifest))
        lines.append(ph23_crowd(manifest["coco"]["test"]))
        base = ["MODEL.WEIGHTS", "", "SEED", "0", "TEST.EVAL_PERIOD", "0",
                "TEST.EVAL_TRAIN", "False", "SOLVER.IMS_PER_BATCH", "4",
                "SOLVER.BASE_LR", str(PH19_LR)]

        # (a) Mask R-CNN
        dense = {}
        opts = base + [
            "DATASETS.PROPOSAL_FILES_TRAIN", repr((train_props,)),
            "DATASETS.PROPOSAL_FILES_TEST", repr((test_props,)),
            "OUTPUT_DIR", str(work / "out_mask"),
            "SOLVER.MAX_ITER", str(PH23_STEPS),
            "SOLVER.CHECKPOINT_PERIOD", str(PH23_STEPS)]
        run = entry_main(23, dev, mask_yaml, opts, {**train_hw, **test_hw},
                         ph23_captures(captured), coco=True, dense=dense)
        per_step = check_steps(23, run, ["plain"] * PH23_STEPS, {"plain": {
            "loss_cls", "loss_box_reg", "loss_mask", "total_loss"}})
        check_detections(23, run, len(test_hw))
        segm = ph23_dense_metrics("(a)", run["results"], "segm")
        if not dense.get("masks"):
            raise Fail(f"phase 23: (a) pasted no masks: {dense}")
        heads = ph23_head_check(captured)
        launches["mask"] = run["launches"]
        print_entry(23, f"(a) Mask R-CNN train_net.main "
                    f"(Misc/mask_rcnn_R_50_FPN_1x: R50-FPN 256, ROIAlignV2 "
                    f"over p2-p5, DAN [1024, 1024], 80 classes, mask head 4 "
                    f"x 256 at 14^2 -> 28^2, FREEZE_AT 2, bfloat16, the "
                    f"YAML's 480-1200 scales under MAX 2000, seeded random "
                    f"weights) {PH23_STEPS} steps of B=4 (the YAML's 16 "
                    f"cut) at BASE_LR {PH19_LR} (0.02 cut) on a packed "
                    f"shard of the mask fixtures' {len(train_hw)} COCO-sized "
                    f"images, then the eval without TTA of "
                    f"{len(test_hw)}", per_step, run, None,
                    "none: the pyramid pools by RoIAlign", len(test_hw),
                    f"; {dense['masks']} masks pasted at the original size "
                    f"({dense['mask_pixels']} pixels), paste "
                    f"{captured.get('paste_masks_in_image_s', 0):.3f} s and "
                    f"segm evaluation "
                    f"{captured.get('_evaluate_dense_task_s', 0):.3f} s on "
                    f"the host; segm " + ", ".join(
                        f"{k} {v:.4f}" for k, v in segm.items())
                    + f"; {heads}", tag)
        captured.clear()

        # (b) Keypoint R-CNN
        kp_train, kp_train_hw, _ = ph23_split(
            work, names[2], fx.synthetic_coco(231, 8, keypoints=True), rs)
        kp_test, kp_test_hw, _ = ph23_split(
            work, names[3], fx.synthetic_coco(232, 2, first_id=101,
                                              keypoints=True), rs)
        dense = {}
        opts = base + PH23_KEYPOINT + [
            "DATASETS.TRAIN", f"('{names[2]}',)",
            "DATASETS.TEST", f"('{names[3]}',)",
            "DATASETS.PROPOSAL_FILES_TRAIN", repr((kp_train,)),
            "DATASETS.PROPOSAL_FILES_TEST", repr((kp_test,)),
            "OUTPUT_DIR", str(work / "out_keypoint"),
            "SOLVER.MAX_ITER", str(PH23_STEPS),
            "SOLVER.CHECKPOINT_PERIOD", str(PH23_STEPS)]
        run = entry_main(23, dev, mask_yaml, opts,
                         {**kp_train_hw, **kp_test_hw},
                         ph23_captures(captured), coco=True, num_classes=1,
                         dense=dense)
        per_step = check_steps(23, run, ["plain"] * PH23_STEPS, {"plain": {
            "loss_cls", "loss_box_reg", "loss_keypoint", "total_loss"}})
        check_detections(23, run, len(kp_test_hw))
        kps = ph23_dense_metrics("(b)", run["results"], "keypoints")
        if not dense.get("keypoints") or "mask_head" in captured:
            raise Fail(f"phase 23: (b) keypoints {dense}, mask head run "
                       f"{'mask_head' in captured}")
        kh, kx = captured["keypoint_head"]
        with torch.no_grad():
            kp_ms = cuda_ms(lambda: kh(kx), 3)
        launches["keypoint"] = run["launches"]
        print_entry(23, f"(b) Keypoint R-CNN train_net.main (the same YAML "
                    f"with MODEL.MASK_ON False, KEYPOINT_ON True, "
                    f"NUM_CLASSES 1, as Detectron2's COCO-Keypoints/"
                    f"keypoint_rcnn_R_50_FPN_1x.yaml: 17 keypoints, keypoint "
                    f"head 8 x 512 at 14^2 -> 56^2) {PH23_STEPS} steps of "
                    f"B=4 on a packed person shard of {len(kp_train_hw)} "
                    f"images (visibility 0/1/2, a quarter with none "
                    f"labelled), then the eval of {len(kp_test_hw)}",
                    per_step, run, None, "none", len(kp_test_hw),
                    f"; {dense['keypoints']} keypoints decoded in the "
                    f"original frame; keypoints " + ", ".join(
                        f"{k} {v:.4f}" for k, v in kps.items())
                    + f"; keypoint head forward {kp_ms:.2f} ms a call at "
                    f"the step's {tuple(kx.shape)} RoIs (bf16, CUDA events)",
                    tag)
        captured.clear()

        # (c) Cascade R-CNN with the mask head, on (a)'s shards; every
        # finite score kept (the YAML's 0.05 keeps none of 81 classes'
        # near-uniform scores on random weights), so masks are predicted
        dense = {}
        opts = base + [
            "MODEL.MASK_ON", "True", "MODEL.ROI_HEADS.NUM_CLASSES", "80",
            "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "-1",
            "DATASETS.TRAIN", f"('{names[0]}',)",
            "DATASETS.TEST", f"('{names[1]}',)",
            "DATASETS.PROPOSAL_FILES_TRAIN", repr((train_props,)),
            "DATASETS.PROPOSAL_FILES_TEST", repr((test_props,)),
            "OUTPUT_DIR", str(work / "out_cascade"),
            "SOLVER.MAX_ITER", str(PH23_CASCADE_STEPS),
            "SOLVER.CHECKPOINT_PERIOD", str(PH23_CASCADE_STEPS)]
        run = entry_main(23, dev, cascade_yaml, opts,
                         {**train_hw, **test_hw}, coco=True, dense=dense)
        per_step = check_steps(23, run, ["plain"] * PH23_CASCADE_STEPS, {
            "plain": {"loss_mask", "total_loss", *(
                f"loss_{n}_stage{k}" for k in range(3)
                for n in ("cls", "box_reg"))}})
        check_detections(23, run, len(test_hw))
        segm = ph23_dense_metrics("(c)", run["results"], "segm")
        if not dense.get("masks"):
            raise Fail(f"phase 23: (c) pasted no masks: {dense}")
        launches["cascade"] = run["launches"]
        print_entry(23, f"(c) Cascade R-CNN with the mask head "
                    f"train_net.main (cascade_rcnn_WSR_50_DC5_1x + MASK_ON "
                    f"True, NUM_CLASSES 80: WS-R50 DC5, FREEZE_AT 2, ROIPool, "
                    f"3 stages, the mask head on stage 0's sample, bf16) "
                    f"{PH23_CASCADE_STEPS} steps of B=4 on (a)'s shard, then "
                    f"the eval of (a)'s {len(test_hw)} test images keeping "
                    f"every finite score (the YAML's threshold 0.05 cut)",
                    per_step, run, None, "none: the differentiable pool",
                    len(test_hw), f"; {dense.get('masks', 0)} masks pasted; "
                    f"segm " + ", ".join(f"{k} {v:.4f}"
                                         for k, v in segm.items()), tag)
    finally:
        for name in names:
            if name in DatasetCatalog:
                DatasetCatalog.remove(name)
        captured.clear()
    k1 = {k: v["roi_pool"] for k, v in launches.items()}
    if any(k1.values()):
        raise Fail(f"phase 23: K1 launched {k1}")
    print(f"phase 23: no K1 launch in (a), (b) or (c) ({k1}): the mask "
          f"and keypoint arms pool by RoIAlign and the differentiable "
          f"RoIPool, and their heads are cuDNN convolutions; "
          f"{'; '.join(lines)}; phase {time.perf_counter() - t_phase:.1f} "
          f"s {tag}",
          flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return {k: sum(v[k] for v in launches.values())
            for k in launches["mask"]}

PH24_STEPS, PH24_HEAD_CROP = 4, 32
PH25_STEPS = 4
RETINANET_NAMES = {"loss_cls", "loss_box_reg", "total_loss"}
PANOPTIC_NAMES = {"loss_sem_seg", "loss_cls", "loss_box_reg", "loss_mask",
                  "total_loss"}


def ph24_captures(captured: dict):
    """Stand-ins that keep RetinaNet's head and its first training input,
    each ``inference_scores`` call's candidate count beside the levels'
    anchor counts, and each detect call's host ms (synchronised)."""
    from drn_wsod_torch.models import retinanet
    from drn_wsod_torch.tools import train_net

    forward = retinanet.RetinaNetHead.forward

    def head(self, feats):
        if torch.is_grad_enabled() and "head" not in captured:
            captured["head"] = (self, [f.detach().clone() for f in feats])
        return forward(self, feats)

    scores_fn = retinanet.RetinaNet.inference_scores

    @torch.inference_mode()
    def inference_scores(self, batch, feats=None):
        out = scores_fn(self, batch, feats)
        feats = feats if feats is not None else self.features(batch.image)
        A = len(self.aspect_ratios) * len(self.anchor_sizes[0])
        n = [feats[f].shape[1] * feats[f].shape[2] * A
             for f in self.in_features]
        captured.setdefault("candidates", []).append(
            (out[0].shape[1], sum(min(self.topk_candidates, k) for k in n),
             n, int(batch.image.shape[1])))
        return out

    make = train_net.make_detect_fn

    def make_detect_fn(*a, **k):
        detect = make(*a, **k)

        def timed(batch):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = detect(batch)
            torch.cuda.synchronize()
            captured.setdefault("detect_ms", []).append(
                (time.perf_counter() - t) * 1e3)
            return out
        return timed

    return [(retinanet.RetinaNetHead, "forward", head),
            (retinanet.RetinaNet, "inference_scores", inference_scores),
            (train_net, "make_detect_fn", make_detect_fn)]


def ph24_head_check(captured: dict) -> str:
    """RetinaNet's head (its towers switched from bfloat16 to float32 in a
    copy) on the first image of a train step's levels, p3 and p4 cut to
    PH24_HEAD_CROP^2 cells, on the card against the CPU: every output
    within 1e-4 of the level's largest."""
    import copy

    head, feats = captured["head"]
    h32 = copy.deepcopy(head).float()
    for m in h32.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float32
    x = [f[:1, :, :PH24_HEAD_CROP, :PH24_HEAD_CROP].float() for f in feats]
    with torch.no_grad():
        got = h32(x)
        want = h32.cpu()([f.cpu() for f in x])
    errs = []
    for (gc, gb), (wc, wb) in zip(got, want):
        for g, w in ((gc, wc), (gb, wb)):
            top = float(w.abs().max())
            err = float((g.cpu() - w).abs().max())
            if not err <= 1e-4 * top:
                raise Fail(f"phase 24: the RetinaNet head on the card "
                           f"differs from the CPU by {err} (largest {top})")
            errs.append(err / top)
    return (f"the head (4 + 4 convs 256, cls_score 9 x 80, bbox_pred 9 x 4) "
            f"in float32 on the card == CPU on a train step's "
            f"{[tuple(f.shape) for f in x]} level maps to {max(errs):.3g} "
            f"of each output's largest (tolerance 1e-4)")


def phase24_retinanet(dev, tag) -> dict:
    """RetinaNet through ``train_net.main`` from seeded random weights: (a)
    ``COCO-Detection/retinanet_R_50_FPN_1x`` (R50-FPN p3-p6, 9 anchors a
    cell, 80 classes, focal loss, FREEZE_AT 2, bf16, the YAML's 640-800
    scales under MAX 2000) on a packed COCO shard of the mask fixtures' 8
    train images: PH24_STEPS steps of B=4 (the YAML's 16 cut) at BASE_LR
    1e-4 (0.01 cut), then the eval without TTA of the 2 test images into
    COCO box AP, every finite score kept (the YAML's 0.05 keeps none of
    random weights' near-prior scores); (b)
    ``quick_schedules/retinanet_R_50_instant_test`` as the YAML stands (10
    steps of R18 at 512, B=2) but BASE_LR 1e-4 on the same shards. The losses' names and
    finiteness, the candidates K = sum of min(1000, anchors) over the
    levels at each test bucket, at most 100 detections an image, AP in
    range, the head in float32 on the card against the CPU; no K1
    launch."""
    import shutil

    from drn_wsod_torch.data import DatasetCatalog
    from drn_wsod_torch.tools import make_mask_fixtures as fx

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    full = root / "configs" / "COCO-Detection" / "retinanet_R_50_FPN_1x.yaml"
    instant = root / "configs" / "quick_schedules" / \
        "retinanet_R_50_instant_test.yaml"
    yaml_is(24, full, MODEL__META_ARCHITECTURE="RetinaNet",
            MODEL__BACKBONE__NAME="build_resnet_fpn_backbone",
            MODEL__BACKBONE__FREEZE_AT=2, MODEL__RESNETS__DEPTH=50,
            MODEL__RETINANET__NUM_CLASSES=80,
            MODEL__RETINANET__IN_FEATURES=["p3", "p4", "p5", "p6"],
            MODEL__DTYPE="bfloat16", SOLVER__IMS_PER_BATCH=16,
            INPUT__MAX_SIZE_TRAIN=2000, TEST__AUG__ENABLED=False)
    yaml_is(24, instant, MODEL__RESNETS__DEPTH=18, SOLVER__MAX_ITER=10,
            SOLVER__IMS_PER_BATCH=2, INPUT__BUCKETS=[512])
    work = root / "build" / "chip_smoke_ph24"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    manifest = fx.load_manifest()
    rs = np.random.RandomState(24)
    names = ("coco_2017_train", "coco_2017_val")
    launches, captured = {}, {}
    try:
        _, train_hw, _ = ph23_split(work, names[0],
                                    manifest["coco"]["train"], rs)
        _, test_hw, _ = ph23_split(work, names[1], manifest["coco"]["test"],
                                   rs)
        hw = {**train_hw, **test_hw}
        # ROI_HEADS.NUM_CLASSES 80: the mapper's image-level labels index
        # by the class, and the YAMLs leave it at 20, which fails on COCO's
        # classes in both packages
        base = ["MODEL.WEIGHTS", "", "SEED", "0", "TEST.EVAL_PERIOD", "0",
                "TEST.EVAL_TRAIN", "False", "MODEL.ROI_HEADS.NUM_CLASSES", "80",
                "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "-1"]
        opts = base + ["SOLVER.IMS_PER_BATCH", "4",
                       "SOLVER.BASE_LR", str(PH19_LR),
                       "OUTPUT_DIR", str(work / "out_full"),
                       "SOLVER.MAX_ITER", str(PH24_STEPS),
                       "SOLVER.CHECKPOINT_PERIOD", str(PH24_STEPS)]
        run = entry_main(24, dev, full, opts, hw, ph24_captures(captured),
                         coco=True)
        per_step = check_steps(24, run, ["plain"] * PH24_STEPS,
                               {"plain": RETINANET_NAMES})
        check_detections(24, run, len(test_hw))
        most = max(n for _, n in run["dets"])
        cands = captured.get("candidates", [])
        if most > 100 or not cands or any(k != want
                                          for k, want, _, _ in cands):
            raise Fail(f"phase 24: (a) detections an image up to {most}; "
                       f"candidates (K, sum of min(1000, n), levels, "
                       f"bucket) {cands}")
        heads = ph24_head_check(captured)
        levels = [tuple(f.shape[2:]) for f in captured["head"][1]]
        detect_ms = captured["detect_ms"][1:] or captured["detect_ms"]
        launches["full"] = run["launches"]
        print_entry(24, f"(a) RetinaNet train_net.main "
                    f"(COCO-Detection/retinanet_R_50_FPN_1x: R50-FPN 256, "
                    f"p3-p6, 9 anchors a cell (3 sizes x 3 ratios), 80 "
                    f"classes, FREEZE_AT 2, bf16, the YAML's 640-800 scales "
                    f"under MAX 2000, seeded random weights) {PH24_STEPS} "
                    f"steps of B=4 (the YAML's 16 cut) at BASE_LR {PH19_LR} "
                    f"(0.01 cut) on a packed shard of the mask fixtures' "
                    f"{len(train_hw)} COCO-sized images, then the eval "
                    f"without TTA of {len(test_hw)}, every finite score "
                    f"kept", per_step, run, None,
                    "none: the dense detector pools nothing", len(test_hw),
                    f"; step ms past the first (median) "
                    f"{statistics.median(v for _, _, v, _ in per_step[1:]):.1f}"
                    f"; the first train step's levels {levels}, anchors a "
                    f"level {[h * w * 9 for h, w in levels]}; candidates K "
                    f"at each test image (bucket, K, anchors a level): "
                    + ", ".join(f"({b}, {k}, {n})" for k, _, n, b in cands)
                    + f"; at most {most} detections an image; detect "
                    f"{statistics.median(detect_ms):.1f} ms an image (host "
                    f"clock, synchronised, B=1, the first left out) ; "
                    f"{heads}", tag)
        captured.clear()

        # the YAML's 0.01 drives random weights to NaN within 10 steps
        opts = base + ["SOLVER.BASE_LR", str(PH19_LR),
                       "OUTPUT_DIR", str(work / "out_instant")]
        run = entry_main(24, dev, instant, opts, hw, ph24_captures(captured),
                         coco=True)
        per_step = check_steps(24, run, ["plain"] * 10,
                               {"plain": RETINANET_NAMES})
        check_detections(24, run, len(test_hw))
        cands = captured.get("candidates", [])
        if not cands or any(k != want for k, want, _, _ in cands):
            raise Fail(f"phase 24: (b) candidates {cands}")
        launches["instant"] = run["launches"]
        print_entry(24, f"(b) quick_schedules/retinanet_R_50_instant_test "
                    f"train_net.main as the YAML stands (R18-FPN, 10 steps "
                    f"of B=2 at 256 under MAX 512, bucket 512) but BASE_LR "
                    f"{PH19_LR} (0.01 cut) on (a)'s shards, then the eval "
                    f"of its test images at 256",
                    per_step, run, None, "none", len(test_hw),
                    "; candidates (bucket, K, anchors a level): " + ", ".join(
                        f"({b}, {k}, {n})" for k, _, n, b in cands), tag)
    finally:
        for name in names:
            if name in DatasetCatalog:
                DatasetCatalog.remove(name)
        captured.clear()
    k1 = {k: v["roi_pool"] for k, v in launches.items()}
    if any(k1.values()):
        raise Fail(f"phase 24: K1 launched {k1}")
    print(f"phase 24: no K1 launch in (a) or (b) ({k1}): RetinaNet's towers "
          f"and predictors are cuDNN convolutions; phase "
          f"{time.perf_counter() - t_phase:.1f} s {tag}", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return {k: sum(v[k] for v in launches.values())
            for k in launches["full"]}


def ph25_tree(split: str):
    from drn_wsod_torch.tools import make_png_fixtures as pf

    root = pf.FIXTURE_DIR / "panoptic"
    return (str(root / "annotations" / f"panoptic_{split}.json"), str(root),
            str(root / f"panoptic_{split}"),
            str(root / f"panoptic_stuff_{split}"),
            str(root / "annotations" / f"instances_{split}.json"))


def ph25_split(work: Path, name: str, split: str, etype: str, rs):
    """The PNG fixtures' panoptic-separated ``split`` loaded by
    ``load_coco_panoptic_separated`` (``name``'s metadata set), each
    record given random u8 pixels (the packed-record path), registered
    under ``name`` as ``etype``, with a proposals pickle (PH11_PROPOSALS
    an image, PH23_NEAR near its GT first). Returns (proposals pickle,
    {image_id: (H, W)})."""
    import pickle

    from drn_wsod_torch.data import DatasetCatalog, MetadataCatalog
    from drn_wsod_torch.data.datasets import load_coco_panoptic_separated

    records = load_coco_panoptic_separated(*ph25_tree(split), name)
    props = {"ids": [], "boxes": [], "objectness_logits": [], "bbox_mode": 0}
    for r in records:
        H, W = r["height"], r["width"]
        image, rec = eval_image(rs, H, W, r["image_id"], P=PH11_PROPOSALS)
        r["image"] = image
        boxes = rec["proposal_boxes"]
        gt = np.asarray([a["bbox"] for a in r["annotations"]
                         if not a["iscrowd"]], np.float32)
        if len(gt):
            near = gt[rs.randint(len(gt), size=PH23_NEAR)]
            near = near + rs.uniform(-0.08, 0.08, near.shape) * np.tile(
                near[:, 2:] - near[:, :2], 2)
            near = np.clip(near, 0, [W - 1, H - 1, W - 1, H - 1])
            boxes = np.concatenate([near, boxes])[:PH11_PROPOSALS]
        props["ids"].append(r["image_id"])
        props["boxes"].append(boxes.astype(np.float32))
        props["objectness_logits"].append(rec["proposal_objectness_logits"])
    prop_file = work / f"{name}_proposals.pkl"
    with open(prop_file, "wb") as f:
        pickle.dump(props, f)
    if name in DatasetCatalog:
        DatasetCatalog.remove(name)
    DatasetCatalog.register(name, lambda: records)
    MetadataCatalog.get(name).set(evaluator_type=etype)
    return str(prop_file), {str(r["image_id"]): (r["height"], r["width"])
                            for r in records}


def ph25_decodes() -> str:
    """Every committed PNG fixture decoded by the port's reader with
    Pillow blocked, against the manifest's digests of Pillow's decode and
    ``convert("RGB")``, the interlaced and 16-bit ones among them; the
    semantic YAML's training mapper on the
    tree's train records against the digests of Pillow's canvases."""
    from drn_wsod_torch.data import DatasetMapper, png
    from drn_wsod_torch.data.datasets import load_coco_panoptic_separated
    from drn_wsod_torch.tools import make_png_fixtures as pf

    manifest = pf.load_manifest()
    n, t_decode = 0, 0.0
    with no_pillow():
        for rel, e in manifest["files"].items():
            path = str(pf.FIXTURE_DIR / rel)
            t = time.perf_counter()
            a = png.read_png(path)
            rgb = png.read_png_rgb(path)
            t_decode += time.perf_counter() - t
            if (pf.digest(a), str(a.dtype), list(a.shape),
                    pf.digest(rgb)) != (e["sha256"], e["dtype"], e["shape"],
                                        e["rgb_sha256"]):
                raise Fail(f"phase 25: {rel} decodes unlike Pillow")
            n += 1
        records = load_coco_panoptic_separated(*ph25_tree("train2017"))
        mapper = DatasetMapper(pf.sem_mapper_cfg(), is_train=True)
        t_map, buckets = 0.0, []
        for r, e in zip(records, manifest["mapper"]):
            r = dict(r, image=np.zeros((r["height"], r["width"], 3),
                                       np.uint8))
            t = time.perf_counter()
            out = mapper(r, np.random.RandomState(e["seed"]))
            t_map += time.perf_counter() - t
            if out["_bucket"] != e["bucket"] or \
                    pf.digest(out["sem_seg"]) != e["sha256"]:
                raise Fail(f"phase 25: the sem_seg canvas of image "
                           f"{r['image_id']} differs from Pillow's")
            buckets.append(out["_bucket"])
    if n != len(manifest["files"]) or \
            len(buckets) != len(manifest["mapper"]):
        raise Fail(f"phase 25: {n} files matched")
    return (f"(a) {n} PNG fixtures (gray 1-16 bits, palette 1-8 bits, "
            f"gray+alpha, RGB, RGBA at 8 and 16 bits, plain and Adam7, "
            f"each filter type, several IDAT chunks, the panoptic tree's "
            f"RGB and label PNGs and two VOC-sized ones) decoded equal to "
            f"the digests of Pillow's decode and convert('RGB'), Pillow "
            f"blocked, {t_decode * 1e3 / n:.2f} ms a file (host); the "
            f"semantic YAML's training mapper's {len(buckets)} sem_seg canvases (buckets {buckets}, "
            f"{t_map / len(buckets) * 1e3:.1f} ms a record) equal to the "
            f"digests of Pillow's NEAREST")


def phase25_dense(dev, tag) -> dict:
    """The dense paths: (a) ``ph25_decodes``; (b)
    ``Misc/semantic_R_50_FPN_1x`` (SemanticSegmentor: R50-FPN, the
    SemSegFPN head 128 wide over p2-p5, 54 classes, FREEZE_AT 2, bf16)
    through ``train_net.main`` from seeded random weights on the PNG
    fixtures' panoptic-separated tree (its 8 train images given random
    pixels, their label PNGs): PH25_STEPS steps of B=4 (the YAML's 16 cut)
    at BASE_LR 1e-4 (0.02 cut), then mIoU on the 2 val images registered
    as "sem_seg" (the YAML's own split is "coco_panoptic_seg", whose
    evaluation needs instances); (c) ``Misc/panoptic_fpn_R_50_1x``
    (PanopticFPN: the same backbone and semantic head at loss weight 0.5,
    Fast R-CNN over ROIAlignV2 of p2-p5, the mask head, 80 thing classes)
    on the same tree with a proposal file passed in opts (the YAML names
    none, and without one no slot is live): PH25_STEPS steps, then box and
    segm AP and PQ of the val images. The losses' names and finiteness,
    the metrics in [0, 100], no K1 launch."""
    import shutil

    from drn_wsod_torch.data import DatasetCatalog

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    sem_yaml = root / "configs" / "Misc" / "semantic_R_50_FPN_1x.yaml"
    pan_yaml = root / "configs" / "Misc" / "panoptic_fpn_R_50_1x.yaml"
    yaml_is(25, sem_yaml, MODEL__META_ARCHITECTURE="SemanticSegmentor",
            MODEL__BACKBONE__FREEZE_AT=2, MODEL__SEM_SEG_HEAD__NUM_CLASSES=54,
            MODEL__LOAD_PROPOSALS=False, MODEL__DTYPE="bfloat16",
            DATASETS__TRAIN=["coco_2017_train_panoptic_separated"])
    yaml_is(25, pan_yaml, MODEL__META_ARCHITECTURE="PanopticFPN",
            MODEL__MASK_ON=True, MODEL__ROI_HEADS__NUM_CLASSES=80,
            MODEL__SEM_SEG_HEAD__LOSS_WEIGHT=0.5, MODEL__LOAD_PROPOSALS=True,
            DATASETS__PROPOSAL_FILES_TRAIN=[], MODEL__DTYPE="bfloat16")
    lines = [ph25_decodes()]
    work = root / "build" / "chip_smoke_ph25"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    rs = np.random.RandomState(25)
    names = ("coco_2017_train_panoptic_separated",
             "coco_2017_val_panoptic_separated", "ph25_sem_val")
    launches = {}
    try:
        train_props, train_hw = ph25_split(work, names[0], "train2017",
                                           "coco_panoptic_seg", rs)
        test_props, test_hw = ph25_split(work, names[1], "val2017",
                                         "coco_panoptic_seg", rs)
        ph25_split(work, names[2], "val2017", "sem_seg", rs)
        hw = {**train_hw, **test_hw}
        base = ["MODEL.WEIGHTS", "", "SEED", "0", "TEST.EVAL_PERIOD", "0",
                "TEST.EVAL_TRAIN", "False", "SOLVER.IMS_PER_BATCH", "4",
                "SOLVER.BASE_LR", str(PH19_LR),
                "SOLVER.MAX_ITER", str(PH25_STEPS),
                "SOLVER.CHECKPOINT_PERIOD", str(PH25_STEPS),
                # the mapper's image-level labels index by the thing class:
                # the YAMLs' default 20 fails on COCO's 80 in both packages
                "MODEL.ROI_HEADS.NUM_CLASSES", "80"]

        # (b) SemanticSegmentor
        opts = base + ["DATASETS.TEST", f"('{names[2]}',)",
                       "OUTPUT_DIR", str(work / "out_sem")]
        sem_keys = ("mIoU", "fwIoU", "pACC", "mACC")
        run = entry_main(25, dev, sem_yaml, opts, hw,
                         metrics={"sem_seg": sem_keys})
        per_step = check_steps(25, run, ["plain"] * PH25_STEPS, {
            "plain": {"loss_sem_seg", "total_loss"}})
        launches["semantic"] = run["launches"]
        lines.append(
            f"(b) SemanticSegmentor train_net.main "
            f"(Misc/semantic_R_50_FPN_1x: R50-FPN 256, SemSegFPN head 128 "
            f"over p2-p5 with GroupNorm, 54 classes, FREEZE_AT 2, bf16, "
            f"480-1200 scales under MAX 2000, seeded random weights) "
            f"{PH25_STEPS} steps of B=4 (16 cut) at BASE_LR {PH19_LR} (0.02 "
            f"cut) on the tree's {len(train_hw)} images; per step (bucket, "
            f"device ms, loss_sem_seg): " + ", ".join(
                f"({b}, {v:.1f}, {m['loss_sem_seg']:.4g})"
                for _, b, v, m in per_step)
            + "; mIoU of the val images " + ", ".join(
                f"{k} {v:.4f}" for k, v in run["metrics"].items())
            + f" (random weights); main {run['main_s']:.2f} s, peak "
            f"{run['peak'] / 2**30:.2f} GiB; K1 launches "
            f"{run['launches']['roi_pool']}")

        # (c) PanopticFPN, with a proposal file
        opts = base + ["DATASETS.PROPOSAL_FILES_TRAIN", repr((train_props,)),
                       "DATASETS.PROPOSAL_FILES_TEST", repr((test_props,)),
                       "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "-1",
                       "OUTPUT_DIR", str(work / "out_pan")]
        dense = {}
        run = entry_main(25, dev, pan_yaml, opts, hw, coco=True, dense=dense,
                         metrics={"bbox": ("AP", "AP50", "AP75"),
                                  "panoptic_seg": ("PQ", "SQ", "RQ")})
        per_step = check_steps(25, run, ["plain"] * PH25_STEPS,
                               {"plain": PANOPTIC_NAMES})
        check_detections(25, run, len(test_hw))
        segm = ph23_dense_metrics("(c)", run["results"], "segm", phase=25)
        pq = [tasks["panoptic_seg"] for tasks in run["results"].values()]
        if not dense.get("masks") or not pq or not all(p["N"] > 0 for p in pq):
            raise Fail(f"phase 25: (c) masks {dense}, PQ {pq}")
        launches["panoptic"] = run["launches"]
        print_entry(25, f"(c) PanopticFPN train_net.main "
                    f"(Misc/panoptic_fpn_R_50_1x: R50-FPN 256, Fast R-CNN "
                    f"over ROIAlignV2 of p2-p5, mask head 4 x 256 at 14^2 "
                    f"-> 28^2, SemSegFPN head 128 at loss weight 0.5, 80 "
                    f"thing and 54 semantic classes, FREEZE_AT 2, bf16) "
                    f"{PH25_STEPS} steps of B=4 on the tree's "
                    f"{len(train_hw)} images with {PH11_PROPOSALS} proposals "
                    f"an image passed in opts, then the eval of "
                    f"{len(test_hw)}: box and segm AP, PQ over "
                    f"{pq[0]['N']} categories", per_step, run, None,
                    "none: the pyramid pools by RoIAlign", len(test_hw),
                    f"; {dense['masks']} masks pasted; segm " + ", ".join(
                        f"{k} {v:.4f}" for k, v in segm.items()), tag)
    finally:
        for name in names:
            if name in DatasetCatalog:
                DatasetCatalog.remove(name)
    k1 = {k: v["roi_pool"] for k, v in launches.items()}
    if any(k1.values()):
        raise Fail(f"phase 25: K1 launched {k1}")
    print(f"phase 25: {'; '.join(lines)}; no K1 launch in (b) or (c) "
          f"({k1}); phase {time.perf_counter() - t_phase:.1f} s {tag}",
          flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return {k: sum(v[k] for v in launches.values())
            for k in launches["semantic"]}


PH26_B, PH26_BUCKET, PH26_STEPS, PH26_LR = 4, 1216, 4, 1e-3
PH26_GT, PH26_SLOTS, PH26_RSLOTS = 20, 100, 32
PH26_PRE, PH26_POST, PH26_NMS, PH26_TOP = 2000, 1000, 0.7, 100
# Detectron2's configs/Base-RCNN-FPN.yaml anchors and its default angles
PH26_LEVELS = (("p2", 4, 32.0), ("p3", 8, 64.0), ("p4", 16, 128.0),
               ("p5", 32, 256.0), ("p6", 64, 512.0))
PH26_RATIOS, PH26_ANGLES = (0.5, 1.0, 2.0), (-90.0, 0.0, 90.0)
PH26_LVIS_TRAIN, PH26_LVIS_TEST, PH26_LVIS_STEPS = 8, 2, 4
# LVIS v1's rare / common / frequent category counts
PH26_LVIS_FREQ = (("r", 337), ("c", 461), ("f", 405))
PH26_CITY_TRAIN, PH26_CITY_TEST, PH26_CITY_HW = 8, 2, (1024, 2048)
PH26_CITY_STEPS, PH26_SEM_STEPS, PH26_CITY_DETS = 4, 2, 20
PH26_NEAR = 1e-5


def write_png(path: Path, arr: np.ndarray) -> None:
    """An 8-bit gray (H, W) or RGB (H, W, 3) PNG by the standard library's
    ``zlib``, every row of filter type 0 (no Pillow)."""
    import struct
    import zlib

    arr = np.ascontiguousarray(arr, np.uint8)
    h, w = arr.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, -1)], 1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))
    head = struct.pack(">IIBBBBB", w, h, 8, 2 if arr.ndim == 3 else 0, 0, 0,
                       0)
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", head)
                     + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
                     + chunk(b"IEND", b""))


def smooth_image(rs, H: int, W: int) -> np.ndarray:
    """A u8 (H, W, 3) image of 16x16 blocks of random colour."""
    cells = rs.randint(0, 256, (-(-H // 16), -(-W // 16), 3)).astype(np.uint8)
    return np.repeat(np.repeat(cells, 16, 0), 16, 1)[:H, :W]


def timed(fn):
    """(fn's result, its device ms by CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def ph26_maps(dev):
    """p2-p6 of the R50-FPN that ``Misc/mask_rcnn_R_50_FPN_1x`` builds
    (FREEZE_AT 2, bf16, seeded random weights) on PH26_B smooth random
    images at the PH26_BUCKET bucket, and the forward's device ms."""
    import drn_wsod_torch

    yaml = Path(__file__).resolve().parent / "configs" / "Misc" / \
        "mask_rcnn_R_50_FPN_1x.yaml"
    yaml_is(26, yaml, MODEL__BACKBONE__NAME="build_resnet_fpn_backbone",
            MODEL__BACKBONE__FREEZE_AT=2, MODEL__RESNETS__DEPTH=50,
            MODEL__DTYPE="bfloat16")
    cfg = drn_wsod_torch.get_cfg()
    cfg.merge_from_file(str(yaml))
    model = drn_wsod_torch.build_model(cfg, device=dev)
    rs = np.random.RandomState(26)
    image = torch.from_numpy(np.stack([
        smooth_image(rs, PH26_BUCKET, PH26_BUCKET) for _ in range(PH26_B)]))
    image = image.to(dev)
    with torch.no_grad():
        model.backbone(model.preprocess(image[:1]).permute(0, 3, 1, 2))
        maps, ms = timed(lambda: model.backbone(
            model.preprocess(image).permute(0, 3, 1, 2)))
    del model
    return {n: maps[n] for n, _, _ in PH26_LEVELS}, ms


def ph26_gt(rs, rotated: bool, slots: int, dev):
    """PH26_GT live GT boxes an image in ``slots`` slots (XYXY, or (cx,
    cy, w, h, angle) turned in [-90, 90)), sides 32-400, inside the
    image."""
    S = PH26_BUCKET
    gt = np.zeros((PH26_B, slots, 5 if rotated else 4), np.float32)
    for i in range(PH26_B):
        w, h = rs.uniform(32, 400, PH26_GT), rs.uniform(32, 400, PH26_GT)
        cx = rs.uniform(w / 2, S - w / 2)
        cy = rs.uniform(h / 2, S - h / 2)
        gt[i, :PH26_GT] = (np.stack([cx, cy, w, h, rs.uniform(
            -90, 90, PH26_GT)], 1) if rotated else np.stack(
            [cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], 1))
    valid = np.zeros((PH26_B, slots), bool)
    valid[:, :PH26_GT] = True
    return torch.from_numpy(gt).to(dev), torch.from_numpy(valid).to(dev)


def ph26_flatten(outs, box_dim: int):
    """The head's per-level NCHW outputs -> (B, N) logits and (B, N,
    box_dim) deltas, anchors of a cell innermost, levels in order, and
    each level's anchor count."""
    obj = [o.permute(0, 2, 3, 1).reshape(o.shape[0], -1) for o, _ in outs]
    deltas = [d.permute(0, 2, 3, 1).reshape(d.shape[0], -1, box_dim)
              for _, d in outs]
    return torch.cat(obj, 1), torch.cat(deltas, 1), [o.shape[1] for o in obj]


def ph26_match(quality, valid, low_quality: bool):
    from drn_wsod_torch.ops.matcher import match

    return match(quality, valid, [0.3, 0.7], [0, -1, 1],
                 allow_low_quality=low_quality)


def ph26_sample_check(what, got, want, q_card, q_cpu, valid,
                      low_quality) -> str:
    """The card's sampled (indices, valid, foreground) against the CPU's:
    equal, or different only where an anchor's label differs between the
    card's IoU ``q_card`` and the CPU's ``q_cpu`` and the CPU's IoU there
    lies within PH26_NEAR of 0.3, 0.7 or (low-quality matches) a GT's
    best IoU, where the two devices' float32 rounding decides (at
    Detectron2's angles every rotated anchor has a twin turned 90 or 180
    degrees, which ties with it mathematically)."""
    got = [t.cpu() for t in got]
    if all(torch.equal(g, w) for g, w in zip(got, want)):
        return f"{what}: sampled anchors equal"
    valid = valid.cpu()
    lab_card = ph26_match(q_card, valid.to(q_card.device),
                          low_quality)[1].cpu()
    lab_cpu = ph26_match(q_cpu, valid, low_quality)[1]
    diff = (lab_card != lab_cpu).nonzero()[:, 0]
    q = torch.where(valid[:, None], q_cpu, -1.0)
    qv = q[:, diff]
    near = ((qv - 0.3).abs() < PH26_NEAR) | ((qv - 0.7).abs() < PH26_NEAR)
    if low_quality:
        near |= (qv - q.amax(1, keepdim=True)).abs() < PH26_NEAR
    if len(diff) == 0 or not bool(near.any(0).all()):
        raise Fail(f"phase 26: {what}: the card's sampled anchors differ "
                   f"from the CPU's; labels differ at {diff.tolist()[:8]}, "
                   f"not all near a threshold or a tie")
    return (f"{what}: sampled anchors differ from the CPU's, {len(diff)} "
            f"anchors' labels flip within {PH26_NEAR} of a threshold or a "
            f"GT's best IoU")


def ph26_loss_check(what, got, fn, inputs, quality, iou_fn, low_quality,
                    encode):
    """``fn`` (``rpn_losses`` or ``rrpn_losses``) on the CPU on the card's
    float32 ``inputs`` (anchors, logits, deltas, GT, GT valid, keys)
    against the card's ``got`` (losses and sample), ``quality`` the card's
    IoU and ``iou_fn`` the one the CPU computes: the samples as
    ``ph26_sample_check`` allows, and the losses within rtol 1e-5 of the
    CPU's on the same sample (where the labels flipped, the CPU's loss
    terms on the card's labels)."""
    from drn_wsod_torch.models import proposal_generator as pg

    inputs = [t.detach().cpu() if torch.is_tensor(t) else
              tuple(k.cpu() for k in t) for t in inputs]
    t = time.perf_counter()
    want = fn(*inputs, return_sampled=True)
    cpu_s = time.perf_counter() - t
    line = ph26_sample_check(what, got[2], want[2], quality,
                             iou_fn(inputs[3], inputs[0]), inputs[4],
                             low_quality)
    if not line.endswith("equal"):
        midx, mlab = ph26_match(quality, inputs[4].to(quality.device),
                                low_quality)
        anchors, obj, deltas, gt, _, keys = inputs
        want = pg._sampled_losses(midx.cpu(), mlab.cpu(), keys, anchors, obj,
                                  deltas, gt, encode, 256, 0.5)[3:]
    err = max(abs(float(g.detach()) - float(w)) / max(abs(float(w)), 1e-12)
              for g, w in zip(got[:2], want[:2]))
    if err > 1e-5:
        raise Fail(f"phase 26: {what}: losses on the card "
                   f"{[float(g) for g in got[:2]]}, the CPU "
                   f"{[float(w) for w in want[:2]]}")
    return (f"{line}; its losses within rtol {err:.2e} of the CPU's "
            f"({cpu_s:.1f} s on the CPU)")


def ph26_proposals_check(what, got, want, anchors, obj, deltas) -> str:
    """``select_proposals`` on the card (``got``) against the CPU
    (``want``) for one image and level: the same slots, scores and
    (within 1e-2) boxes, or other slots only where two of the top
    candidates' IoU (float64, on the CPU) lies within PH26_NEAR of the
    NMS threshold."""
    from drn_wsod_torch.structures import boxes as box_ops

    gb, gs, gv = (t.cpu() for t in got)
    wb, ws, wv = want
    if torch.equal(gv, wv) and torch.equal(gs, ws):
        if gv.any() and float((gb - wb)[gv].abs().max()) > 1e-2:
            raise Fail(f"phase 26: {what}: the card keeps the CPU's "
                       f"proposals, boxes apart")
        return f"{what}: {int(gv.sum())} kept, equal"
    b = box_ops.clip(box_ops.apply_deltas(
        deltas.cpu().double(), anchors.cpu().double(), (1.0,) * 4),
        (PH26_BUCKET, PH26_BUCKET))
    top = torch.sort(obj.cpu(), descending=True, stable=True).indices
    cand = b[top[:PH26_PRE]]
    iou = box_ops.pairwise_iou(cand, cand)
    near = int(((iou - PH26_NMS).abs() < PH26_NEAR).triu(1).sum())
    if not near:
        raise Fail(f"phase 26: {what}: the card keeps {int(gv.sum())} "
                   f"proposals, the CPU {int(wv.sum())}, "
                   f"{int((gs != ws).sum())} slots' scores differ, with no "
                   f"candidate IoU within {PH26_NEAR} of {PH26_NMS}")
    return (f"{what}: {int(gv.sum())} kept on the card, {int(wv.sum())} on "
            f"the CPU; {near} candidate pairs within {PH26_NEAR} of the "
            f"NMS threshold")


def ph26_rotated_nms_check(what, got, want, anchors, obj, deltas) -> str:
    """``select_proposals_rotated`` on the card (``got``) against the CPU
    (``want``) for one image and level. Where the kept proposals differ:
    the card's own NMS decisions, replayed by ``nms_mask`` on the CPU
    from the card's IoU matrix, must give the card's proposals, and each
    pair of candidates that one device suppresses and the other does not
    must sit within PH26_NEAR of the threshold, or be a pair where a
    device's float32 convex formula lies more than 1e-3 from the float64
    clip (``iou_matrix_rotated``): near-identical boxes, whose IoU the
    formula, as the JAX package's, can get far wrong (ROADMAP.md
    section 3). Checks at most 400 such pairs."""
    from drn_wsod_torch.evaluation.rotated_coco_eval import \
        iou_matrix_rotated
    from drn_wsod_torch.models import proposal_generator as pg
    from drn_wsod_torch.ops.nms import nms_mask
    from drn_wsod_torch.structures import rotated_boxes as rb

    gb, gs, gv = (t.cpu() for t in got)
    wb, ws, wv = want
    if torch.equal(gv, wv) and torch.equal(gs, ws):
        d = (gb - wb).abs()
        d[:, 4] = ((gb[:, 4] - wb[:, 4] + 180.0) % 360.0 - 180.0).abs()
        if gv.any() and float(d[gv].max()) > 1e-2:
            raise Fail(f"phase 26: {what}: the card keeps the CPU's "
                       f"proposals, boxes {float(d[gv].max())} apart")
        return f"{what}: {int(gv.sum())} kept, equal"

    def candidates(dev):
        b = rb.apply_deltas_rotated(deltas.to(dev), anchors.to(dev))
        b = torch.cat([b[:, :2].clamp(0, PH26_BUCKET), b[:, 2:]], 1)
        s, idx = torch.sort(obj.to(dev), descending=True, stable=True)
        b, s = b[idx[:PH26_PRE]], s[:PH26_PRE]
        ok = (b[:, 2] > 0) & (b[:, 3] > 0) & torch.isfinite(s)
        return b, s, ok, rb.pairwise_iou_rotated(b, b)
    bc, sc, okc, iouc = (t.cpu() for t in candidates(anchors.device))
    bh, sh, okh, iouh = candidates("cpu")
    keep = nms_mask(bc[:, :4], sc, okc, PH26_NMS, iou=iouc)
    replay = pg._after_nms(bc, sc, keep, PH26_POST)
    if not (torch.equal(replay[2], gv) and torch.equal(replay[1], gs)):
        raise Fail(f"phase 26: {what}: nms_mask on the card's IoU on the "
                   f"CPU does not give the card's proposals")
    flips = (((iouc > PH26_NMS) != (iouh > PH26_NMS)) & okc[:, None]
             & okc[None]).triu(1).nonzero()
    near = far = 0
    for i, j in flips[:400].tolist():
        if abs(float(iouh[i, j]) - PH26_NMS) < PH26_NEAR:
            near += 1
            continue
        exact = iou_matrix_rotated(bh[i:i + 1].double().numpy(),
                                   bh[j:j + 1].double().numpy())[0, 0]
        if max(abs(float(iouc[i, j]) - exact),
               abs(float(iouh[i, j]) - exact)) <= 1e-3:
            raise Fail(f"phase 26: {what}: the devices split on candidates "
                       f"{i}, {j}: IoU {float(iouc[i, j])} on the card, "
                       f"{float(iouh[i, j])} on the CPU, {exact} in float64")
        far += 1
    return (f"{what}: {int(gv.sum())} kept on the card, "
            f"{int((gs != ws).sum())} of their slots other than the CPU's: "
            f"the card's IoU replayed through nms_mask gives the card's; "
            f"{len(flips)} candidate pairs suppress on one device only, "
            f"{far} of the {min(len(flips), 400)} checked where a device's "
            f"float32 IoU is over 1e-3 from the float64 clip, {near} within "
            f"{PH26_NEAR} of {PH26_NMS}")


def ph26_rpn(dev, maps) -> str:
    """(a) the RPN over p2-p6: PH26_STEPS steps of ``rpn_losses`` + backward
    + SGD on the head, then ``select_proposals`` per image and level."""
    from drn_wsod_torch.models import proposal_generator as pg
    from drn_wsod_torch.structures import boxes as box_ops

    rs = np.random.RandomState(261)
    gen = torch.Generator(device=dev).manual_seed(26)
    C = maps["p2"].shape[1]
    head = pg.StandardRPNHead(C, len(PH26_RATIOS), 256,
                              dtype=torch.bfloat16)
    head.init_weights(torch.Generator().manual_seed(26))
    head.to(dev)
    opt = torch.optim.SGD(head.parameters(), lr=PH26_LR, momentum=0.9)
    anchors = torch.cat([pg.generate_anchors(
        tuple(maps[n].shape[2:]), s, (size,), PH26_RATIOS, device=dev)
        for n, s, size in PH26_LEVELS])
    gt, gv = ph26_gt(rs, False, PH26_SLOTS, dev)
    feats = [maps[n] for n, _, _ in PH26_LEVELS]
    steps, checks = [], []
    torch.cuda.reset_peak_memory_stats()
    for step in range(PH26_STEPS):
        keys = [pg.draw_rpn_keys(anchors.shape[0], gen, dev)
                for _ in range(PH26_B)]
        outs, head_ms = timed(lambda: head(feats))
        obj, deltas, counts = ph26_flatten(outs, 4)

        def losses():
            return [pg.rpn_losses(anchors, obj[i], deltas[i], gt[i], gv[i],
                                  keys[i], return_sampled=True)
                    for i in range(PH26_B)]
        per, loss_ms = timed(losses)
        lo = sum(p[0] for p in per) / PH26_B
        ll = sum(p[1] for p in per) / PH26_B
        lo_v, ll_v = float(lo.detach()), float(ll.detach())

        def update():
            (lo + ll).backward()
            opt.step()
            opt.zero_grad(set_to_none=True)
        _, bwd_ms = timed(update)
        if not (math.isfinite(lo_v) and math.isfinite(ll_v)):
            raise Fail(f"phase 26: (a) step {step} losses {lo_v}, {ll_v}")
        steps.append((lo_v, ll_v, head_ms, loss_ms, bwd_ms))
        if step == 0:           # image 0 on the CPU, same float32 inputs
            checks.append(ph26_loss_check(
                "image 0", per[0], pg.rpn_losses,
                (anchors, obj[0], deltas[0], gt[0], gv[0], keys[0]),
                box_ops.pairwise_iou(gt[0], anchors), box_ops.pairwise_iou,
                False,
                lambda a, g: box_ops.get_deltas(a, g, (1.0,) * 4)))
    peak_steps = torch.cuda.max_memory_allocated()

    with torch.no_grad():
        obj, deltas, counts = ph26_flatten(head(feats), 4)
    offs = np.cumsum([0] + counts)
    kept, sel_ms = [], []
    for i in range(PH26_B):
        for li, (n, _, _) in enumerate(PH26_LEVELS):
            sl = slice(offs[li], offs[li + 1])
            out, ms = timed(lambda: pg.select_proposals(
                anchors[sl], obj[i, sl], deltas[i, sl],
                (PH26_BUCKET, PH26_BUCKET), PH26_PRE, PH26_POST, PH26_NMS))
            sel_ms.append(ms)
            kept.append(int(out[2].sum()))
            if i == 0:
                want = pg.select_proposals(
                    anchors[sl].cpu(), obj[i, sl].cpu(), deltas[i, sl].cpu(),
                    (PH26_BUCKET, PH26_BUCKET), PH26_PRE, PH26_POST,
                    PH26_NMS)
                checks.append(ph26_proposals_check(
                    f"select_proposals {n}", out, want, anchors[sl],
                    obj[i, sl], deltas[i, sl]))
    if not all(kept):
        raise Fail(f"phase 26: (a) kept proposals {kept}")
    del head, opt
    return (f"(a) RPN: StandardRPNHead(256 -> 3 anchors, 3x3 conv bf16) "
            f"over p2-p6 of {PH26_B} images at {PH26_BUCKET}^2, "
            f"{anchors.shape[0]} anchors an image (sizes 32-512, ratios "
            f"0.5/1/2), {PH26_GT} live GT in {PH26_SLOTS} slots; "
            f"{PH26_STEPS} steps (loss_obj, loss_loc, head fwd ms, "
            f"rpn_losses ms, backward + SGD ms): " + ", ".join(
                f"({a:.4f}, {b:.4f}, {c:.2f}, {d:.2f}, {e:.2f})"
                for a, b, c, d, e in steps)
            + f"; peak {peak_steps / 2**30:.2f} GiB; select_proposals "
            f"(pre {PH26_PRE}, post {PH26_POST}, NMS {PH26_NMS}) per image "
            f"and level: median {statistics.median(sel_ms):.2f} ms, total "
            f"{sum(sel_ms):.1f} ms, kept {sum(kept)}; " + "; ".join(checks))


def ph26_rrpn(dev, maps) -> str:
    """(b) the RRPN over p2-p6 with rotated anchors: one step of
    ``rrpn_losses`` + backward + SGD, ``select_proposals_rotated`` per
    image and level, ``roi_align_rotated`` of the kept p4 proposals in
    bf16 and float32, and ``RotatedCOCODetectionEvaluator``."""
    from drn_wsod_torch.evaluation import rotated_coco_eval as rce
    from drn_wsod_torch.models import proposal_generator as pg
    from drn_wsod_torch.ops.roi_align_rotated import roi_align_rotated
    from drn_wsod_torch.structures import rotated_boxes as rb

    rs = np.random.RandomState(262)
    gen = torch.Generator(device=dev).manual_seed(262)
    A = len(PH26_RATIOS) * len(PH26_ANGLES)
    head = pg.StandardRPNHead(maps["p2"].shape[1], A, 256,
                              dtype=torch.bfloat16, box_dim=5)
    head.init_weights(torch.Generator().manual_seed(262))
    head.to(dev)
    opt = torch.optim.SGD(head.parameters(), lr=PH26_LR, momentum=0.9)
    anchors = torch.cat([pg.generate_rotated_anchors(
        tuple(maps[n].shape[2:]), s, (size,), PH26_RATIOS, PH26_ANGLES,
        device=dev) for n, s, size in PH26_LEVELS])
    gt, gv = ph26_gt(rs, True, PH26_RSLOTS, dev)
    feats = [maps[n] for n, _, _ in PH26_LEVELS]
    lines = []
    torch.cuda.reset_peak_memory_stats()
    keys = [pg.draw_rpn_keys(anchors.shape[0], gen, dev)
            for _ in range(PH26_B)]
    outs, head_ms = timed(lambda: head(feats))
    obj, deltas, counts = ph26_flatten(outs, 5)
    per, loss_ms = timed(lambda: [pg.rrpn_losses(
        anchors, obj[i], deltas[i], gt[i], gv[i], keys[i],
        return_sampled=True) for i in range(PH26_B)])
    lo = sum(p[0] for p in per) / PH26_B
    ll = sum(p[1] for p in per) / PH26_B
    lo_v, ll_v = float(lo.detach()), float(ll.detach())

    def update():
        (lo + ll).backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
    _, bwd_ms = timed(update)
    if not (math.isfinite(lo_v) and math.isfinite(ll_v)):
        raise Fail(f"phase 26: (b) losses {lo_v}, {ll_v}")
    quality, iou_ms = timed(lambda: rb.pairwise_iou_rotated(gt[0], anchors))
    lines.append(ph26_loss_check(
        "image 0", per[0], pg.rrpn_losses,
        (anchors, obj[0], deltas[0], gt[0], gv[0], keys[0]), quality,
        rb.pairwise_iou_rotated, True,
        lambda a, g: rb.get_deltas_rotated(a, g, (1.0,) * 5)))
    del quality

    with torch.no_grad():
        obj, deltas, counts = ph26_flatten(head(feats), 5)
    offs = np.cumsum([0] + counts)
    kept, sel_ms, props = {}, [], []
    for i in range(PH26_B):
        image_props = []
        for li, (n, _, _) in enumerate(PH26_LEVELS):
            sl = slice(offs[li], offs[li + 1])
            out, ms = timed(lambda: pg.select_proposals_rotated(
                anchors[sl], obj[i, sl], deltas[i, sl],
                (PH26_BUCKET, PH26_BUCKET), PH26_PRE, PH26_POST, PH26_NMS))
            sel_ms.append(ms)
            kept[(i, n)] = out
            image_props.append(out)
            if i == 0 and n == "p4":
                top = torch.sort(obj[i, sl], descending=True,
                                 stable=True).indices[:PH26_PRE]
                c = rb.apply_deltas_rotated(deltas[i, sl],
                                            anchors[sl])[top]
                _, nms_iou_ms = timed(lambda: rb.pairwise_iou_rotated(c, c))
                want = pg.select_proposals_rotated(
                    anchors[sl].cpu(), obj[i, sl].cpu(), deltas[i, sl].cpu(),
                    (PH26_BUCKET, PH26_BUCKET), PH26_PRE, PH26_POST,
                    PH26_NMS)
                lines.append(ph26_rotated_nms_check(
                    f"select_proposals_rotated {n}", out, want, anchors[sl],
                    obj[i, sl], deltas[i, sl]))
        props.append(image_props)
    if not all(int(v[2].sum()) for v in kept.values()):
        raise Fail("phase 26: (b) a level kept no proposal")
    peak = torch.cuda.max_memory_allocated()

    # rotated RoIAlign of the kept p4 proposals, 7x7, ratio 2
    p4 = maps["p4"]
    rois = [kept[(i, "p4")][0][kept[(i, "p4")][2]] for i in range(PH26_B)]
    n_rois = sum(len(r) for r in rois)

    def pool(dtype):
        return [roi_align_rotated(p4[i].permute(1, 2, 0).to(dtype), rois[i],
                                  1 / 16, 7, 2) for i in range(PH26_B)]
    pool(torch.bfloat16)
    pooled, bf16_ms = timed(lambda: pool(torch.bfloat16))
    pooled32, f32_ms = timed(lambda: pool(torch.float32))
    sub = rois[0][:64]
    m0 = p4[0].permute(1, 2, 0)
    want32 = roi_align_rotated(m0.float().cpu(), sub.cpu(), 1 / 16, 7, 2)
    want16 = roi_align_rotated(m0.to(torch.bfloat16).cpu(), sub.cpu(),
                               1 / 16, 7, 2).float()
    err32 = float((pooled32[0][:64].cpu() - want32).abs().max())
    d16 = (pooled[0][:64].float().cpu() - want16).abs()
    ulp = torch.exp2(torch.floor(torch.log2(want16.abs().clamp(
        min=1e-30))) - 7)
    if err32 > 1e-4 * float(want32.abs().max()) or bool((d16 > ulp).any()):
        raise Fail(f"phase 26: (b) roi_align_rotated on the card against "
                   f"the CPU: float32 {err32}, bf16 ulps "
                   f"{float((d16 / ulp).max())}")
    lines.append(f"roi_align_rotated of {n_rois} kept p4 proposals (7x7, "
                 f"ratio 2, 256 channels, chunks of 512): bf16 "
                 f"{bf16_ms:.2f} ms, float32 {f32_ms:.2f} ms; 64 RoIs "
                 f"against the CPU: float32 max|diff| {err32:.2e}, bf16 "
                 f"within one ulp ({int((d16 > 0).sum())} of {d16.numel()} "
                 f"values differ)")

    # the rotated COCO evaluator on the host: the top PH26_TOP proposals
    # of each image over the levels as class-0 detections
    gt_host = gt.cpu().numpy().astype(np.float64)
    gvh = gv.cpu().numpy()
    gt_by_image = {str(i): [{"category_id": 0, "bbox": [float(v) for v in g],
                             "difficult": 0} for g in gt_host[i][gvh[i]]]
                   for i in range(PH26_B)}
    ev = rce.RotatedCOCODetectionEvaluator(["object"], gt_by_image)
    dets = {}
    for i, image_props in enumerate(props):
        b = torch.cat([p[0][p[2]] for p in image_props])
        s = torch.cat([p[1][p[2]] for p in image_props])
        top = torch.sort(s, descending=True, stable=True).indices[:PH26_TOP]
        dets[i] = b[top]
        ev.process_single(str(i), b[top].cpu().numpy(), s[top].cpu().numpy(),
                          np.zeros(len(top), np.int64),
                          np.ones(len(top), bool))
    t = time.perf_counter()
    ap = ev.evaluate()["bbox"]
    eval_s = time.perf_counter() - t
    if not all(math.isfinite(v) and 0 <= v <= 100 for k, v in ap.items()
               if k in ("AP", "AP50", "AP75")):
        raise Fail(f"phase 26: (b) rotated AP {ap}")
    g0 = gt[0][gv[0]]
    card = rb.pairwise_iou_rotated(dets[0], g0)
    host = rce.iou_matrix_rotated(dets[0].cpu().double().numpy(),
                                  g0.cpu().double().numpy())
    err = np.abs(card.cpu().numpy() - host)
    iou_err = float(err.max())
    if iou_err > 1e-5:
        i, j = np.unravel_index(err.argmax(), err.shape)
        a, b = dets[0][i:i + 1], g0[j:j + 1]
        raise Fail(f"phase 26: (b) pairwise_iou_rotated on the card is "
                   f"{iou_err} from iou_matrix_rotated at {a.tolist()} "
                   f"against {b.tolist()}: card {float(card[i, j])}, CPU "
                   f"{float(rb.pairwise_iou_rotated(a.cpu(), b.cpu()))}, "
                   f"float64 {host[i, j]}; card corners "
                   f"{rb.rotated_to_corners(a).tolist()}, CPU "
                   f"{rb.rotated_to_corners(a.cpu()).tolist()}; card "
                   f"intersection "
                   f"{float(rb.convex_intersection_area(rb.rotated_to_corners(a), rb.rotated_to_corners(b)))}")
    lines.append(f"pairwise_iou_rotated on the card within {iou_err:.2e} of "
                 f"iou_matrix_rotated (float64, host) on {card.numel()} "
                 f"pairs ({int((host > 0).sum())} overlapping)")
    lines.append(f"RotatedCOCODetectionEvaluator (top {PH26_TOP} an image "
                 f"as class 0, {PH26_GT} GT an image) on the host "
                 f"{eval_s:.2f} s: " + ", ".join(
                     f"{k} {v:.4f}" for k, v in ap.items())
                 + " (random weights)")
    del head, opt
    return (f"(b) RRPN: StandardRPNHead(256 -> {A} anchors, 5 deltas each) "
            f"over p2-p6, {anchors.shape[0]} rotated anchors an image "
            f"(angles -90/0/90), {PH26_GT} live rotated GT in {PH26_RSLOTS} "
            f"slots; one step: loss_obj {lo_v:.4f}, loss_loc "
            f"{ll_v:.4f}, head fwd {head_ms:.2f} ms, rrpn_losses "
            f"{loss_ms:.2f} ms for {PH26_B} images, backward + SGD "
            f"{bwd_ms:.2f} ms; the matcher's rotated IoU ({PH26_RSLOTS} x "
            f"{anchors.shape[0]}, chunks of {rb.DEFAULT_CHUNK} pairs) "
            f"{iou_ms:.2f} ms an image, the NMS's ({PH26_PRE} x {PH26_PRE} "
            f"at p4) {nms_iou_ms:.2f} ms; select_proposals_rotated per "
            f"image and level: median {statistics.median(sel_ms):.2f} ms, "
            f"total {sum(sel_ms):.1f} ms; peak {peak / 2**30:.2f} GiB; "
            + "; ".join(lines))


def ph26_lvis(root: Path, rs) -> tuple:
    """An LVIS v1-shaped tree under ``root``: ``lvis/lvis_v1_{train,
    val}.json`` with 1203 categories of LVIS v1's r/c/f counts, images
    named only in ``coco_url`` and written as PNGs in ``coco/`` (the
    COCO-sized synthetic images and proposals of phase 17's split), per
    image negative and not-exhaustive classes, each val image holding a
    rare, a common and a frequent class; and a proposals pickle a split.
    Returns ({split: proposals}, {image_id: (H, W)}, frequencies)."""
    import json
    import pickle

    freq = [f for f, n in PH26_LVIS_FREQ for _ in range(n)]
    freq = [freq[i] for i in rs.permutation(len(freq))]
    by_freq = {f: [i + 1 for i, g in enumerate(freq) if g == f]
               for f, _ in PH26_LVIS_FREQ}
    cats = [{"id": i + 1, "name": f"lvis_{i + 1}", "frequency": f,
             "synset": f"s{i + 1}.n.01"} for i, f in enumerate(freq)]
    props, hw = {}, {}
    (root / "lvis").mkdir(parents=True)
    for split, n, start in (("train", PH26_LVIS_TRAIN, 0),
                            ("val", PH26_LVIS_TEST, 1)):
        (root / "coco").mkdir(parents=True, exist_ok=True)
        data = {"categories": cats, "images": [], "annotations": []}
        pr = {"ids": [], "boxes": [], "objectness_logits": [], "bbox_mode": 0}
        for i in range(n):
            H, W = COCO_SIZES[(start + i) % len(COCO_SIZES)]
            image_id = 1000 * start + 37 * i + 9
            _, rec = eval_image(rs, H, W, image_id, P=PH11_PROPOSALS)
            # the loaders take the file name alone from coco_url, so the
            # images sit in coco/ itself, not in its split folder
            name = f"{image_id:012d}.png"
            write_png(root / "coco" / name, smooth_image(rs, H, W))
            classes = [int(rs.choice(by_freq[f])) for f in "rcf"] if \
                split == "val" else [int(rs.choice(by_freq["f"]))
                                     for _ in range(rs.randint(1, 5))]
            for c in classes:
                w, h = rs.uniform(24, W * 0.6), rs.uniform(24, H * 0.6)
                x, y = rs.uniform(0, W - w), rs.uniform(0, H - h)
                data["annotations"].append({
                    "id": len(data["annotations"]) + 1, "image_id": image_id,
                    "category_id": c, "bbox": [x, y, w, h], "area": w * h})
            data["images"].append({
                "id": image_id, "height": H, "width": W,
                "coco_url": f"http://images.cocodataset.org/{split}2017/"
                            f"{name}",
                "neg_category_ids": [int(c) for c in rs.choice(
                    [c for c in by_freq["c"] if c not in classes], 3,
                    replace=False)],
                "not_exhaustive_category_ids": classes[-1:]})
            hw[str(image_id)] = (H, W)
            pr["ids"].append(image_id)
            pr["boxes"].append(rec["proposal_boxes"])
            pr["objectness_logits"].append(rec["proposal_objectness_logits"])
        (root / "lvis" / f"lvis_v1_{split}.json").write_text(json.dumps(data))
        props[split] = str(root / f"lvis_{split}_proposals.pkl")
        with open(props[split], "wb") as f:
            pickle.dump(pr, f)
    return props, hw, freq


def ph26_lvis_run(dev, work: Path, tag) -> tuple:
    """(c) ``COCO-Detection/oicr_WSR_50_DC5_1x`` on the LVIS tree through
    ``train_net.main`` (``register_all`` finds it under
    ``$DETECTRON2_DATASETS``) with Detectron2's LVIS recipe."""
    from drn_wsod_torch.data import DatasetCatalog, MetadataCatalog
    from drn_wsod_torch.evaluation import lvis_eval

    yaml = Path(__file__).resolve().parent / "configs" / \
        "COCO-Detection" / "oicr_WSR_50_DC5_1x.yaml"
    yaml_is(26, yaml, MODEL__BACKBONE__FREEZE_AT=5, MODEL__DTYPE="bfloat16",
            TEST__AUG__ENABLED=True, SOLVER__IMS_PER_BATCH=4)
    root = work / "datasets"
    props, hw, freq = ph26_lvis(root, np.random.RandomState(263))
    opts = ["DATASETS.TRAIN", "('lvis_v1_train',)",
            "DATASETS.TEST", "('lvis_v1_val',)",
            "DATASETS.PROPOSAL_FILES_TRAIN", repr((props["train"],)),
            "DATASETS.PROPOSAL_FILES_TEST", repr((props["val"],)),
            "MODEL.ROI_HEADS.NUM_CLASSES", "1203",
            "DATALOADER.SAMPLER_TRAIN", "RepeatFactorTrainingSampler",
            "DATALOADER.REPEAT_THRESHOLD", "0.001",
            "TEST.DETECTIONS_PER_IMAGE", "300",
            "MODEL.WEIGHTS", "", "OUTPUT_DIR", str(work / "out_lvis"),
            "SEED", "0", "TEST.EVAL_PERIOD", "0", "TEST.EVAL_TRAIN", "False",
            "SOLVER.MAX_ITER", str(PH26_LVIS_STEPS),
            "SOLVER.CHECKPOINT_PERIOD", str(PH26_LVIS_STEPS)]
    captured = {}
    keys = ("AP", "AP50", "AP75", "APr", "APc", "APf")
    # the earlier phases' train_net.main registered the LVIS names under
    # the default root: drop them, so that register_all finds this tree
    for name in ("lvis_v1_train", "lvis_v1_val"):
        if name in DatasetCatalog:
            DatasetCatalog.remove(name)
    try:
        with mock.patch.dict(os.environ, {"DETECTRON2_DATASETS": str(root)}):
            run = entry_main(26, dev, yaml, opts, hw, [k1_capture(captured)],
                             num_classes=1203, metrics={"bbox": keys},
                             evaluator=lvis_eval.LVISDetectionEvaluator)
        meta = MetadataCatalog.get("lvis_v1_val")
        if meta.get("thing_frequencies") != freq or \
                meta.get("evaluator_type") != "lvis":
            raise Fail("phase 26: (c) the LVIS metadata is not the json's")
    finally:
        for name in ("lvis_v1_train", "lvis_v1_val"):
            if name in DatasetCatalog:
                DatasetCatalog.remove(name)
    per_step = check_steps(26, run, ["plain"] * PH26_LVIS_STEPS,
                           {"plain": OICR_NAMES})
    check_detections(26, run, PH26_LVIS_TEST)
    if len(run["metrics"]) != len(keys) or not run["launches"]["roi_pool"]:
        raise Fail(f"phase 26: (c) LVIS metrics {run['metrics']}, K1 "
                   f"launches {run['launches']['roi_pool']}")
    k1 = k1_exact(26, captured)
    print_entry(26, f"(c) LVIS: train_net.main on COCO-Detection/"
                f"oicr_WSR_50_DC5_1x (WS-R50 DC5 FREEZE_AT 5, bf16, TTA 8 "
                f"scales x flip) with NUM_CLASSES 1203, "
                f"RepeatFactorTrainingSampler at 0.001 and 300 detections "
                f"an image (Detectron2's LVISv1 recipe) on an LVIS "
                f"v1-shaped tree ({PH26_LVIS_TRAIN} + {PH26_LVIS_TEST} "
                f"COCO-sized PNG images named in coco_url, 1203 classes "
                f"r/c/f 337/461/405, negative and not-exhaustive classes) "
                f"registered by register_all from $DETECTRON2_DATASETS, "
                f"{PH26_LVIS_STEPS} steps of B=4, then the TTA eval of "
                f"{PH26_LVIS_TEST}", per_step, run, k1,
                f"{PH26_LVIS_STEPS} steps + the TTA groups", PH26_LVIS_TEST,
                "", tag)
    return run["launches"]


CITY_THINGS = ("person", "rider", "car", "truck", "bus", "train",
               "motorcycle", "bicycle")


def ph26_cityscapes(root: Path, rs) -> tuple:
    """A Cityscapes tree under ``root/cityscapes``: PH26_CITY_TRAIN +
    PH26_CITY_TEST smooth random 2048x1024 ``*_leftImg8bit.png`` images in
    two cities, their ``gtFine`` polygon json (thing objects, a
    "cargroup" crowd region, a deleted car, a "road" outside the 8
    classes) and labelIds PNGs (the objects drawn on a road and sky
    ground), and a proposals pickle a split. Returns ({split: proposals},
    {image_id: (H, W)})."""
    import json
    import pickle

    H, W = PH26_CITY_HW
    props, hw = {}, {}
    ids = {"person": 24, "rider": 25, "car": 26, "truck": 27, "bus": 28,
           "train": 31, "motorcycle": 32, "bicycle": 33}
    for split, n in (("train", PH26_CITY_TRAIN), ("val", PH26_CITY_TEST)):
        pr = {"ids": [], "boxes": [], "objectness_logits": [], "bbox_mode": 0}
        for k in range(n):
            city = ("aachen", "bremen")[k % 2]
            stem = f"{city}_{k:06d}_000019_"
            img_dir = root / "cityscapes" / "leftImg8bit" / split / city
            gt_dir = root / "cityscapes" / "gtFine" / split / city
            img_dir.mkdir(parents=True, exist_ok=True)
            gt_dir.mkdir(parents=True, exist_ok=True)
            write_png(img_dir / f"{stem}leftImg8bit.png",
                      smooth_image(rs, H, W))
            label = np.full((H, W), 7, np.uint8)           # road
            label[:H // 3] = 23                            # sky
            objs = []
            for j in range(rs.randint(4, 9)):
                name = CITY_THINGS[rs.randint(len(CITY_THINGS))]
                w, h = rs.uniform(60, 500), rs.uniform(60, 400)
                x, y = rs.uniform(0, W - w), rs.uniform(H // 3, H - h)
                objs.append({"label": name, "polygon": [
                    [x, y], [x + w, y], [x + w * 0.8, y + h], [x, y + h]]})
                label[int(y):int(y + h), int(x):int(x + w * 0.8)] = ids[name]
            objs += [{"label": "cargroup", "polygon": [
                [10, H - 200], [400, H - 200], [400, H - 10], [10, H - 10]]},
                     {"label": "car", "deleted": 1, "polygon": [
                         [500, 500], [600, 500], [600, 600]]},
                     {"label": "road", "polygon": [
                         [0, H // 2], [W - 1, H // 2], [W - 1, H - 1]]}]
            (gt_dir / f"{stem}gtFine_polygons.json").write_text(json.dumps(
                {"imgHeight": H, "imgWidth": W, "objects": objs}))
            write_png(gt_dir / f"{stem}gtFine_labelIds.png", label)
            image_id = f"{city}_{k:06d}_000019"
            hw[image_id] = (H, W)
            _, rec = eval_image(rs, H, W, 0, P=PH11_PROPOSALS)
            pr["ids"].append(image_id)
            pr["boxes"].append(rec["proposal_boxes"])
            pr["objectness_logits"].append(rec["proposal_objectness_logits"])
        props[split] = str(root / f"cityscapes_{split}_proposals.pkl")
        with open(props[split], "wb") as f:
            pickle.dump(pr, f)
    return props, hw


def ph26_cityscapes_run(dev, work: Path, tag) -> dict:
    """(d) the Cityscapes tree registered by ``register_all_cityscapes``:
    (d1) ``Misc/mask_rcnn_R_50_FPN_1x`` with 8 classes into
    ``CityscapesInstanceEvaluator``; (d2) ``Misc/semantic_R_50_FPN_1x``
    into ``CityscapesSemSegEvaluator``, trained on the raw labelIds with
    ``DATALOADER.FILTER_EMPTY_ANNOTATIONS False`` (semantic records carry
    no annotations: with the filter on, both packages' loaders stop on an
    empty dataset)."""
    from drn_wsod_torch.data import DatasetCatalog
    from drn_wsod_torch.data.datasets import register_all_cityscapes
    from drn_wsod_torch.evaluation import cityscapes_eval

    root = Path(__file__).resolve().parent
    mask_yaml = root / "configs" / "Misc" / "mask_rcnn_R_50_FPN_1x.yaml"
    sem_yaml = root / "configs" / "Misc" / "semantic_R_50_FPN_1x.yaml"
    data = work / "datasets"
    props, hw = ph26_cityscapes(data, np.random.RandomState(264))
    before = set(DatasetCatalog.list())
    register_all_cityscapes(str(data))
    names = sorted(set(DatasetCatalog.list()) - before)
    if len(names) != 6:
        raise Fail(f"phase 26: (d) register_all_cityscapes added {names}")
    launches = {}
    base = ["MODEL.WEIGHTS", "", "SEED", "0", "TEST.EVAL_PERIOD", "0",
            "TEST.EVAL_TRAIN", "False", "SOLVER.IMS_PER_BATCH", "4",
            "SOLVER.BASE_LR", str(PH19_LR)]
    try:
        instance = DatasetCatalog.get("cityscapes_fine_instance_seg_train")
        crowd = sum(a["iscrowd"] for r in instance
                    for a in r["annotations"])
        if crowd != PH26_CITY_TRAIN or any(
                a["category_id"] >= 8 for r in instance
                for a in r["annotations"]):
            raise Fail(f"phase 26: (d) the loader's crowd regions {crowd}")
        # (d1) Mask R-CNN, 8 classes
        opts = base + [
            "MODEL.ROI_HEADS.NUM_CLASSES", "8",
            "TEST.DETECTIONS_PER_IMAGE", str(PH26_CITY_DETS),
            "DATASETS.TRAIN", "('cityscapes_fine_instance_seg_train',)",
            "DATASETS.TEST", "('cityscapes_fine_instance_seg_val',)",
            "DATASETS.PROPOSAL_FILES_TRAIN", repr((props["train"],)),
            "DATASETS.PROPOSAL_FILES_TEST", repr((props["val"],)),
            "OUTPUT_DIR", str(work / "out_city_mask"),
            "SOLVER.MAX_ITER", str(PH26_CITY_STEPS),
            "SOLVER.CHECKPOINT_PERIOD", str(PH26_CITY_STEPS)]
        evaluated = []
        process = cityscapes_eval.CityscapesInstanceEvaluator.process_single

        def counting(self, image_id, boxes, scores, classes, valid,
                     masks=None):
            m = np.asarray(masks)
            if m.dtype != bool or m.shape[1:] != hw[image_id]:
                raise Fail(f"phase 26: (d1) masks {m.dtype} {m.shape}")
            evaluated.append(int(np.asarray(valid).sum()))
            return process(self, image_id, boxes, scores, classes, valid,
                           masks=masks)
        run = entry_main(26, dev, mask_yaml, opts, hw, [(
            cityscapes_eval.CityscapesInstanceEvaluator, "process_single",
            counting)], metrics={"segm": ("AP", "AP50")})
        per_step = check_steps(26, run, ["plain"] * PH26_CITY_STEPS, {
            "plain": {"loss_cls", "loss_box_reg", "loss_mask",
                      "total_loss"}})
        if len(evaluated) != PH26_CITY_TEST or not sum(evaluated):
            raise Fail(f"phase 26: (d1) masks evaluated {evaluated}")
        launches["city_mask"] = run["launches"]
        d1 = (f"(d1) Misc/mask_rcnn_R_50_FPN_1x with NUM_CLASSES 8 on "
              f"cityscapes_fine_instance_seg_train ({PH26_CITY_TRAIN} "
              f"2048x1024 PNGs, polygon masks, a crowd cargroup an image, "
              f"{PH11_PROPOSALS} proposals an image), {PH26_CITY_STEPS} "
              f"steps of B=4 at BASE_LR {PH19_LR} (bucket, device ms, "
              f"total_loss): " + ", ".join(
                  f"({b}, {v:.1f}, {m['total_loss']:.4g})"
                  for _, b, v, m in per_step)
              + f"; the eval of {PH26_CITY_TEST} through do_dense_test "
              f"({PH26_CITY_DETS} detections an image, 100 cut) into "
              f"CityscapesInstanceEvaluator, {sum(evaluated)} masks pasted "
              f"at 2048x1024: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in run["metrics"].items())
              + f"; main {run['main_s']:.2f} s, peak "
              f"{run['peak'] / 2**30:.2f} GiB")

        # (d2) SemanticSegmentor on the raw labelIds
        opts = base + [
            "DATALOADER.FILTER_EMPTY_ANNOTATIONS", "False",
            "DATASETS.TRAIN", "('cityscapes_fine_sem_seg_train',)",
            "DATASETS.TEST", "('cityscapes_fine_sem_seg_val',)",
            "OUTPUT_DIR", str(work / "out_city_sem"),
            "SOLVER.MAX_ITER", str(PH26_SEM_STEPS),
            "SOLVER.CHECKPOINT_PERIOD", str(PH26_SEM_STEPS)]
        run = entry_main(26, dev, sem_yaml, opts, hw,
                         metrics={"sem_seg": ("mIoU", "fwIoU", "pACC",
                                              "mACC")})
        per_step = check_steps(26, run, ["plain"] * PH26_SEM_STEPS, {
            "plain": {"loss_sem_seg", "total_loss"}})
        res = next(iter(run["results"].values()))["sem_seg"]
        if len([k for k in res if k.startswith("IoU-")]) != 19:
            raise Fail(f"phase 26: (d2) the evaluator's classes {list(res)}")
        launches["city_sem"] = run["launches"]
        d2 = (f"(d2) Misc/semantic_R_50_FPN_1x (54 classes) trained on "
              f"the raw labelIds of cityscapes_fine_sem_seg_train with "
              f"FILTER_EMPTY_ANNOTATIONS False, {PH26_SEM_STEPS} steps of "
              f"B=4 (bucket, device ms, loss_sem_seg): " + ", ".join(
                  f"({b}, {v:.1f}, {m['loss_sem_seg']:.4g})"
                  for _, b, v, m in per_step)
              + f"; CityscapesSemSegEvaluator over the 19 trainIds: "
              + ", ".join(f"{k} {v:.4f}" for k, v in run["metrics"].items())
              + f"; main {run['main_s']:.2f} s, peak "
              f"{run['peak'] / 2**30:.2f} GiB")
    finally:
        for name in names:
            if name in DatasetCatalog:
                DatasetCatalog.remove(name)
    print(f"phase 26: (d) Cityscapes via register_all_cityscapes: {d1}; "
          f"{d2} {tag}", flush=True)
    return launches


def phase26_rotated_lvis_cityscapes(dev, tag) -> dict:
    """The RPN and RRPN, rotated RoIAlign and the rotated, LVIS and
    Cityscapes evaluators at full width: (a) ``ph26_rpn``, (b)
    ``ph26_rrpn`` on the R50-FPN maps of ``ph26_maps``, (c)
    ``ph26_lvis_run``, (d) ``ph26_cityscapes_run``. Returns the launch
    counts of (c) and (d), the paths through ``train_net``; (a) and (b)
    launch no kernel of the port."""
    import shutil

    t_phase = time.perf_counter()
    work = Path(__file__).resolve().parent / "build" / "chip_smoke_ph26"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    reset_launches()
    maps, fwd_ms = ph26_maps(dev)
    print(f"phase 26: R50-FPN (Misc/mask_rcnn_R_50_FPN_1x, FREEZE_AT 2, "
          f"bf16, seeded random weights) forward of {PH26_B} images at "
          f"{PH26_BUCKET}^2 {fwd_ms:.1f} ms; {ph26_rpn(dev, maps)} "
          f"{tag}", flush=True)
    torch.cuda.empty_cache()
    print(f"phase 26: {ph26_rrpn(dev, maps)} {tag}", flush=True)
    ab = read_launches()
    if any(ab.values()):
        raise Fail(f"phase 26: (a)-(b) launched {ab}")
    del maps
    torch.cuda.empty_cache()
    launches = {"lvis": ph26_lvis_run(dev, work, tag)}
    torch.cuda.empty_cache()
    launches.update(ph26_cityscapes_run(dev, work, tag))
    k1 = {k: v["roi_pool"] for k, v in launches.items()}
    if not k1["lvis"] or k1["city_mask"] or k1["city_sem"]:
        raise Fail(f"phase 26: K1 launches {k1}: want some in (c) only")
    print(f"phase 26: K1 launches {k1}; phase "
          f"{time.perf_counter() - t_phase:.1f} s {tag}", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return {k: sum(v[k] for v in launches.values())
            for k in launches["lvis"]}


# ---------------------------------------------------------------- phase 27
PH27_STEPS, PH27_B = 3, 4
PH27_TRAIN, PH27_TEST, PH27_MAIN_STEPS = 8, 4, 4
PH27_TIMEOUT_S = 600
# (b) and (c) against one process: float32 (TF32 off), where a step of the
# ranks and one of one process differ by the order of float sums only
PH27_LOSS_RTOL, PH27_PARAM_ATOL, PH27_PARAM_RTOL = 1e-4, 1e-6, 1e-4
_PH27_REF = {}      # rank 0's one-process reference, across its cases


def state_digest(sd: dict) -> str:
    """sha256 of every tensor's bytes, by name (bit-equality across
    processes)."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(sd):
        h.update(k.encode())
        h.update(sd[k].detach().contiguous().view(-1).view(torch.uint8)
                 .cpu().numpy().tobytes())
    return h.hexdigest()


def ph27_spawn(work: Path, world: int, payload: dict, tag: str) -> list:
    """``world`` rank processes of this script (``--ph27-rank``), all on
    card 0: each joins a ``payload["backend"]`` group on a free localhost port (from torchrun's
    environment variables), runs the payload's cases and writes its
    results. Every rank is killed and the phase fails where they do not
    all end within PH27_TIMEOUT_S; returns the results in rank order."""
    import socket

    work.mkdir(parents=True, exist_ok=True)
    torch.save(payload, work / "payload.pt")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK="0",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        log = open(work / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--ph27-rank",
             str(work)], env=env, stdout=log, stderr=subprocess.STDOUT),
            log))
    deadline = time.perf_counter() + PH27_TIMEOUT_S
    failed = None
    try:
        for p, _ in procs:
            p.wait(timeout=max(deadline - time.perf_counter(), 1.0))
    except subprocess.TimeoutExpired:
        failed = f"ranks did not end within {PH27_TIMEOUT_S} s"
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    if failed is None and any(p.returncode for p, _ in procs):
        failed = f"rank exit codes {[p.returncode for p, _ in procs]}"
    if failed:
        tails = "".join(f"\n--- rank {r}:\n"
                        + (work / f"rank{r}.log").read_text()[-4000:]
                        for r in range(world))
        raise Fail(f"phase 27: {failed} {tag}{tails}")
    return [torch.load(work / f"result{r}.pt", weights_only=False)
            for r in range(world)]


def ph27_rank(workdir: str) -> int:
    """One rank of ``ph27_spawn`` (never the driver's entry: main runs
    without arguments)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import datetime

    import torch.distributed as dist

    from drn_wsod_torch.parallel import multihost

    work = Path(workdir)
    payload = torch.load(work / "payload.pt", weights_only=False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", multihost.get_local_rank())
    torch.cuda.set_device(dev)
    # a group of one rank too (NCCL at world size 1), from the environment
    dist.init_process_group(backend=payload["backend"], init_method="env://",
                            timeout=datetime.timedelta(seconds=300))
    results = {}
    for name, case in payload["cases"].items():
        fn = ph27_main_case if case["kind"] == "main" else ph27_steps_case
        results[name] = fn(case, dev, work)
        torch.cuda.empty_cache()
    torch.save(results, work / f"result{multihost.get_rank()}.pt")
    dist.barrier()
    dist.destroy_process_group()
    return 0


def ph27_cfg(overrides=()):
    from drn_wsod_torch.tools import ablate_bench

    return ablate_bench.flagship_cfg(overrides=list(overrides))


def ph27_batches(cfg, dev):
    import drn_wsod_torch

    C = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    return [drn_wsod_torch.synthetic_batch(PH27_B, IMG, IMG, P, C,
                                           seed=270 + s, device=dev)
            for s in range(PH27_STEPS)]


def ph27_plain_run(cfg, dev, batches):
    """One process's plain steps on the global batches from the seeded
    init: (metrics per step, {trainable name: tensor}, digest)."""
    import drn_wsod_torch

    model = drn_wsod_torch.build_model(
        cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    tx = drn_wsod_torch.build_optimizer(cfg, model)
    state = drn_wsod_torch.create_train_state(model, tx)
    step = drn_wsod_torch.make_train_step(model, tx)
    metrics = []
    for b in batches:
        state, m = step(state, b, 0)
        metrics.append({k: v.item() for k, v in m.items()})
    trainable = {n: p.detach().clone() for n, p in model.named_parameters()
                 if p.requires_grad}
    return metrics, trainable, state_digest(model.state_dict())


def ph27_k1(captured: dict, what: str = "train step") -> dict:
    """``k1_exact`` in a rank: its record, or the failure's message."""
    try:
        return k1_exact(27, captured, what)
    except Fail as e:
        return {"fail": str(e)}


def ph27_steps_case(case, dev, work: Path) -> dict:
    """The flagship's sharded step over the case's mesh on the rank's
    block of each global batch (B=4, 704^2, P=4096, dropout 0.5): per-step
    device ms (CUDA events), the gradient all_reduce's ms (host clock around
    it, synchronised, and CUDA events), peak memory, K1 launches, losses,
    the digest of the full parameters and buffers, K1 against its plain
    version on the rank's own pooled inputs; under the split the shards'
    shapes and a checkpoint; on rank 0 the one-process reference (``bit``:
    bit-equal, else within the PH27 tolerances)."""
    import drn_wsod_torch
    from drn_wsod_torch.checkpoint import Checkpointer
    from drn_wsod_torch.parallel import context
    from drn_wsod_torch.parallel import mesh as pmesh
    from drn_wsod_torch.parallel import multihost
    from drn_wsod_torch.parallel import train_parallel as tp

    cfg = ph27_cfg(case["overrides"])
    batches = ph27_batches(cfg, dev)
    model = drn_wsod_torch.build_model(
        cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    tx = drn_wsod_torch.build_optimizer(cfg, model)
    state = drn_wsod_torch.create_train_state(model, tx)
    mesh = pmesh.create_mesh(case["axes"], case["shape"])
    step = tp.make_sharded_train_step(model, tx, mesh, state=state)
    reduce_ms = []
    reduce = context.reduce_gradients

    def timed_reduce(grads):
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        e0.record()
        out = reduce(grads)
        e1.record()
        torch.cuda.synchronize()
        reduce_ms.append(((time.perf_counter() - t0) * 1e3,
                          e0.elapsed_time(e1)))
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    metrics, step_ms, digests, captured = [], [], [], {}
    with mock.patch.object(context, "reduce_gradients", timed_reduce), \
            mock.patch.object(*k1_capture(captured)):
        for b in batches:
            local = pmesh.shard_batch(b, mesh)
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            state, m = step(state, local, 0)
            e1.record()
            torch.cuda.synchronize()
            step_ms.append(e0.elapsed_time(e1))
            metrics.append({k: v.item() for k, v in m.items()})
            digests.append(state_digest(pmesh.full_state_dict(model)))
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    out = dict(metrics=metrics, step_ms=step_ms, reduce_ms=reduce_ms,
               digests=digests, peak_gib=peak / 2 ** 30, launches=launches,
               k1=[ph27_k1(captured)],
               rank=multihost.get_rank(), split=pmesh.split_dims(model),
               shapes={n: tuple(p.shape) for n, p in model.named_parameters()
                       if n.startswith("box_head.")})
    if case.get("save"):
        Checkpointer(str(work / case["save"])).save(state, state.step)
        out["checkpoint_digest"] = digests[-1]
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    # copies: the split step below moves the parameters in place
    full = {n: t.clone() for n, t in pmesh.full_state_dict(model).items()
            if n in trainable}
    if case.get("split_step"):
        out["parts"] = split_step(model, tx, step, state,
                                  pmesh.shard_batch(batches[0], mesh))
    del model, tx, state, step
    torch.cuda.empty_cache()
    if case.get("reference") and multihost.get_rank() == 0:
        key = json.dumps(case["overrides"])
        if key not in _PH27_REF:
            _PH27_REF[key] = ph27_plain_run(cfg, dev, batches)
        ref_metrics, ref_params, ref_digest = _PH27_REF[key]
        if case.get("bit"):
            out["bit_equal"] = (metrics == ref_metrics
                                and digests[-1] == ref_digest)
        out["ref_metrics"] = ref_metrics
        out["loss_rel"] = max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-12)
                              for g, w in zip(metrics, ref_metrics)
                              for k in w)
        worst = (0.0, "", 0.0)
        out["param_diffs"] = {}
        for n, w in ref_params.items():
            d = (full[n].float() - w.float()).abs()
            over = d > PH27_PARAM_ATOL + PH27_PARAM_RTOL * w.float().abs()
            excess = (d - PH27_PARAM_ATOL
                      - PH27_PARAM_RTOL * w.float().abs()).max().item()
            out["param_diffs"][n] = (d.max().item(), int(over.sum()),
                                     d.numel())
            if excess > worst[0] or not worst[1]:
                worst = (excess, n, d.max().item())
        out["param_worst"] = worst
    return out


def stashing_voc_evaluator():
    """The VOC evaluator class whose ``evaluate`` keeps the detections it
    evaluates (sorted, per class) in ``stash``."""
    from drn_wsod_torch.evaluation import voc_eval

    class Stashing(voc_eval.PascalVOCDetectionEvaluator):
        stash = []

        def evaluate(self):
            type(self).stash.append({k: sorted(v)
                                     for k, v in self._dets.items()})
            return super().evaluate()

    return Stashing


def ph27_main_case(case, dev, work: Path) -> dict:
    """``train_net.main`` on this rank (the shards registered again), the
    detections that rank 0 evaluates kept, K1 against its plain version on
    the largest map of the rank's train steps and of its TTA groups."""
    from drn_wsod_torch.parallel import multihost
    from drn_wsod_torch.tools import train_net

    for name, shard in case["shards"]:
        register_shard(name, Path(shard))
    stashing = stashing_voc_evaluator()
    captured, evaluated = {}, {}
    reset_launches()
    t = time.perf_counter()
    with mock.patch.object(train_net, "PascalVOCDetectionEvaluator",
                           stashing), \
            mock.patch.object(*k1_capture(captured, evaluated)):
        results = train_net.main(train_net.argument_parser().parse_args(
            case["argv"]), device=dev)
    torch.cuda.synchronize()
    close_logging()
    out = dict(results=results, launches=read_launches(),
               main_s=time.perf_counter() - t, rank=multihost.get_rank(),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               dets=stashing.stash)
    out["k1"] = [ph27_k1(captured), ph27_k1(evaluated, "TTA group")]
    return out


def ph27_k1_exact(part: str, res: list, tag: str) -> None:
    """Fail unless K1 equalled its plain version on every rank's captured
    inputs; print the records."""
    for r in res:
        for rec in r["k1"]:
            if "fail" in rec:
                raise Fail(f"phase 27: ({part}) rank {r['rank']}: "
                           f"{rec['fail']}")
            print(f"phase 27: ({part}) rank {r['rank']}: K1 == plain "
                  f"(max|diff| {rec['err']}) at the rank's {rec['map']} map "
                  f"(spatial scale {rec['spatial_scale']}, boxes "
                  f"{rec['boxes']}): kernel {rec['ms']:.4f} ms queued, plain "
                  f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
                  f"({rec['bound_by']}); the ranks share the card {tag}",
                  flush=True)


def ph27_print_steps(what: str, res: list, tag: str) -> None:
    for r in res:
        ms = ", ".join(f"{v:.1f}" for v in r["step_ms"])
        red = ", ".join(f"{h:.1f} host / {d:.1f} device"
                        for h, d in r["reduce_ms"])
        print(f"phase 27: {what} rank {r['rank']}: step device ms [{ms}]; "
              f"gradient all_reduce ms [{red}]; peak {r['peak_gib']:.2f} GiB; "
              f"K1 launches {r['launches']['roi_pool']} {tag}", flush=True)


def phase27_multi_device(dev, tag) -> dict:
    """Several processes on the one card (``drn_wsod_torch/parallel``):
    (a) NCCL at world size 1, the flagship's ``make_sharded_train_step``
    for 3 steps bit-equal to ``make_train_step``; (b) two ranks sharing
    the card over gloo, ``("data",) = (2,)``, B=2 each, against one
    process's B=4 step; (c) ``("data", "model") = (1, 2)``, the DAN split,
    against the same reference, its checkpoint loaded at world size 1;
    (d) ``train_net.main`` as two gloo ranks, 4 steps from a packed shard
    and the TTA eval through the cross-process gather, against a
    one-process ``--eval-only --resume``. Returns K1's launches in the
    ranks."""
    import shutil

    import drn_wsod_torch
    from drn_wsod_torch.checkpoint import Checkpointer

    t_phase = time.perf_counter()
    work = Path(__file__).resolve().parent / "build" / "chip_smoke_ph27"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    bf16 = ("MODEL.ROI_BOX_HEAD.DROPOUT", "0.5")
    f32 = bf16 + ("MODEL.DTYPE", "float32")
    launches = {}

    # (a) NCCL at world size 1
    t = time.perf_counter()
    (a,) = ph27_spawn(work / "a", 1, {"backend": "nccl", "cases": {"a": {
        "kind": "steps", "overrides": bf16, "axes": ("data",),
        "shape": (1,), "reference": True, "bit": True}}}, tag)
    a = a["a"]
    launches["a"] = a["launches"]["roi_pool"]
    if not a["bit_equal"] or a["launches"]["roi_pool"] != PH27_STEPS:
        raise Fail(f"phase 27: (a) NCCL world 1 bit-equal "
                   f"{a['bit_equal']}, K1 launches {a['launches']}: "
                   f"{a['metrics']} vs {a['ref_metrics']}")
    print(f"phase 27: (a) NCCL at world size 1, flagship (bf16, dropout "
          f"0.5, B={PH27_B}, {IMG}^2, P={P}): {PH27_STEPS} sharded steps "
          f"bit-equal to make_train_step (losses and the digest of every "
          f"parameter and buffer); last step {json.dumps(a['metrics'][-1])}"
          f"; {time.perf_counter() - t:.1f} s {tag}", flush=True)
    ph27_print_steps("(a)", [a], tag)
    ph27_k1_exact("a", [a], tag)

    # (b) and (c): two gloo ranks on the card, float32
    t = time.perf_counter()
    bc = ph27_spawn(work / "bc", 2, {"backend": "gloo", "cases": {
        "b": {"kind": "steps", "overrides": f32, "axes": ("data",),
              "shape": (2,), "reference": True, "split_step": True},
        "c": {"kind": "steps", "overrides": f32, "axes": ("data", "model"),
              "shape": (1, 2), "reference": True, "save": "ckpt_split"}}},
        tag)
    for part in ("b", "c"):
        r0, r1 = bc[0][part], bc[1][part]
        ph27_k1_exact(part, [r0, r1], tag)
        if r0["digests"] != r1["digests"]:
            raise Fail(f"phase 27: ({part}) ranks' parameters and buffers "
                       "differ after a step")
        excess, name, dmax = r0["param_worst"]
        if r0["loss_rel"] > PH27_LOSS_RTOL or excess > 0:
            raise Fail(f"phase 27: ({part}) against one process: loss rel "
                       f"{r0['loss_rel']:.3g} (tol {PH27_LOSS_RTOL}), "
                       f"{name} max |diff| {dmax:.3g} (tol "
                       f"{PH27_PARAM_ATOL} + {PH27_PARAM_RTOL} |p|); per "
                       f"parameter (max |diff|, elements over, of): "
                       f"{r0['param_diffs']}; metrics {r0['metrics']} vs "
                       f"{r0['ref_metrics']}")
        launches[part] = r0["launches"]["roi_pool"] + \
            r1["launches"]["roi_pool"]
        if r0["launches"]["roi_pool"] != PH27_STEPS or \
                r1["launches"]["roi_pool"] != PH27_STEPS:
            raise Fail(f"phase 27: ({part}) K1 launches "
                       f"{r0['launches']} {r1['launches']}")
    b0, c0, c1 = bc[0]["b"], bc[0]["c"], bc[1]["c"]
    print(f"phase 27: (b) two gloo ranks on one card, (\"data\",) = (2,), "
          f"B=2 each, float32 (TF32 off), dropout 0.5: against one process "
          f"at B={PH27_B} max loss rel diff {b0['loss_rel']:.3g} (tol "
          f"{PH27_LOSS_RTOL}), worst parameter {b0['param_worst'][1]} max "
          f"|diff| {b0['param_worst'][2]:.3g} (tol {PH27_PARAM_ATOL} + "
          f"{PH27_PARAM_RTOL} |p|); parameters and buffers bit-equal across "
          f"the ranks after every step {tag}", flush=True)
    ph27_print_steps("(b)", [bc[0]["b"], bc[1]["b"]], tag)
    print("phase 27: (b) gloo stages each all_reduce through host memory: "
          "its ms are no yardstick for NCCL across cards, which is not run "
          "here (one card)", flush=True)
    print_split("phase 27 (b) rank 0", "steps", [b0["parts"]], tag)
    fc = {k: v for k, v in c0["shapes"].items() if k in c0["split"]}
    if set(c0["split"]) != {"box_head.fc1.weight", "box_head.fc1.bias",
                            "box_head.fc2.weight"} or \
            c0["shapes"]["box_head.fc1.weight"][0] * 2 != 2048:
        raise Fail(f"phase 27: (c) split {c0['split']} shapes {fc}")
    cfg = ph27_cfg(f32)
    model = drn_wsod_torch.build_model(cfg, device=dev)
    tx = drn_wsod_torch.build_optimizer(cfg, model)
    state = Checkpointer(str(work / "bc" / "ckpt_split")).load(
        drn_wsod_torch.create_train_state(model, tx))
    loaded = state_digest(model.state_dict())
    if loaded != c0["checkpoint_digest"] or state.step != PH27_STEPS:
        raise Fail("phase 27: (c) the split's checkpoint loaded at world "
                   "size 1 differs from the ranks' gathered state")
    del model, tx, state
    torch.cuda.empty_cache()
    print(f"phase 27: (c) (\"data\", \"model\") = (1, 2), the DAN split: "
          f"rank 0's shards {fc} (rank 1 {json.dumps({k: c1['shapes'][k] for k in fc})}); "
          f"against one process max loss rel diff {c0['loss_rel']:.3g}, "
          f"worst parameter {c0['param_worst'][1]} max |diff| "
          f"{c0['param_worst'][2]:.3g}; the checkpoint the split wrote "
          f"loads at world size 1 to the same digest; "
          f"{time.perf_counter() - t:.1f} s for (b) and (c) {tag}",
          flush=True)
    ph27_print_steps("(c)", [c0, c1], tag)

    # (d) train_net.main as two gloo ranks
    t = time.perf_counter()
    yaml = Path(__file__).resolve().parent / "configs" / \
        "PascalVOC-Detection" / "oicr_WSR_50_DC5_1x.yaml"
    dwork, opts, hw = entry_setup("ph27", 27, n_train=PH27_TRAIN,
                                  n_test=PH27_TEST)
    out_dir = dwork / "output"
    opts += ["SOLVER.MAX_ITER", str(PH27_MAIN_STEPS),
             "SOLVER.CHECKPOINT_PERIOD", str(PH27_MAIN_STEPS),
             "TEST.EVAL_TRAIN", "False"]
    shards = [(n, str(dwork / f"{n}.rec")) for n in ("ph27_train",
                                                     "ph27_test")]
    d = ph27_spawn(work / "d", 2, {"backend": "gloo", "cases": {"d": {
        "kind": "main", "shards": shards,
        "argv": ["--config-file", str(yaml), *opts]}}}, tag)
    d0, d1 = d[0]["d"], d[1]["d"]
    ph27_k1_exact("d", [d0, d1], tag)
    lines = [json.loads(ln) for ln in
             (out_dir / "metrics.json").read_text().splitlines()]
    ckpts = sorted(os.listdir(out_dir / "checkpoints"))
    if [ln["iteration"] for ln in lines] != [PH27_MAIN_STEPS - 1,
                                             PH27_MAIN_STEPS] or \
            ckpts != [f"model_{PH27_MAIN_STEPS:07d}.pth"] or \
            not (out_dir / "log.txt.rank1").exists():
        raise Fail(f"phase 27: (d) metrics.json iterations "
                   f"{[ln['iteration'] for ln in lines]}, checkpoints "
                   f"{ckpts}: want rank 0's alone")
    if d1["results"] != {"ph27_test": {}} or d1["dets"]:
        raise Fail(f"phase 27: (d) rank 1 returned {d1['results']} and "
                   f"evaluated {len(d1['dets'])} times")
    from drn_wsod_torch.tools import train_net

    stashing = stashing_voc_evaluator()
    one = entry_main(27, dev, yaml, ["--eval-only", "--resume", *opts], hw,
                     patches=((train_net, "PascalVOCDetectionEvaluator",
                               stashing),), evaluator=stashing)
    check_detections(27, one, PH27_TEST)
    n_dets = sum(len(v) for v in stashing.stash[0].values())
    if one["results"] != d0["results"] or d0["dets"] != stashing.stash \
            or not n_dets:
        raise Fail(f"phase 27: (d) two ranks' evaluation {d0['results']} "
                   f"(of {sum(len(v) for v in d0['dets'][0].values())} "
                   f"detections) != one process's {one['results']} (of "
                   f"{n_dets})")
    launches["d"] = d0["launches"]["roi_pool"] + d1["launches"]["roi_pool"]
    launches["d_one_process_eval"] = one["launches"]["roi_pool"]
    losses = [ln.get("total_loss") for ln in lines]
    print(f"phase 27: (d) train_net.main as two gloo ranks on cuda:0 "
          f"(flagship YAML, IMS_PER_BATCH 4 = 2 a rank, {PH27_MAIN_STEPS} "
          f"steps from a packed shard, the YAML's TTA over the "
          f"{PH27_TEST} test records, 2 a rank, gathered to rank 0): rank 0 "
          f"alone wrote metrics.json (total_loss {losses}) and {ckpts}; "
          f"rank 1 returned {d1['results']}; rank 0's VOC metrics "
          f"{json.dumps(one['metrics'])} and the {n_dets} detections it "
          f"gathered and evaluated equal a one-process --eval-only "
          f"--resume's; main {d0['main_s']:.1f} s (rank 0), "
          f"{d1['main_s']:.1f} s (rank 1), peak {d0['peak_gib']:.2f} / "
          f"{d1['peak_gib']:.2f} GiB; K1 launches {d0['launches']['roi_pool']}"
          f" + {d1['launches']['roi_pool']}; {time.perf_counter() - t:.1f} s "
          f"{tag}", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    shutil.rmtree(dwork, ignore_errors=True)
    print(f"phase 27: K1 launches {launches}; phase "
          f"{time.perf_counter() - t_phase:.1f} s {tag}", flush=True)
    reset_launches()
    return {**read_launches(), "roi_pool": sum(launches.values())}


PH28_HW, PH28_P = (512, 512), 2048          # the export CLI's defaults
PH28_VOC, PH28_VOC_P = 8, 2048
PH28_CALLS = 5
PH28_TRAIN_STEPS, PH28_BENCH_ITERS, PH28_IMAGENET_ITERS = 2, 3, 3
PH28_DATASET = "ph28_voc_2007_trainval"


def ph28_voc(root: Path, rs):
    """A VOC-layout tree as ``tests/test_torch_common.py:write_voc`` writes
    one: PH28_VOC VOC-sized JPEGs (written by the port's encoder: the
    machine has no Pillow) of smooth content, XML annotations of 1-3
    objects of random classes, the trainval split, and a proposal pickle of
    PH28_VOC_P boxes an image. Returns (directory, proposal file, paths)."""
    import pickle

    from drn_wsod_torch.data.datasets.voc import VOC_CLASS_NAMES
    from drn_wsod_torch.native import jpeg_encode

    d = root / "VOC2007"
    for sub in ("Annotations", "ImageSets/Main", "JPEGImages"):
        (d / sub).mkdir(parents=True)
    props = {"ids": [], "boxes": [], "objectness_logits": [], "bbox_mode": 0}
    paths = []
    for i in range(PH28_VOC):
        fid = f"{i + 1:06d}"
        H, W = EVAL_SIZES[i % len(EVAL_SIZES)]
        _, rec = eval_image(rs, H, W, i + 1, P=PH28_VOC_P)
        path = d / "JPEGImages" / f"{fid}.jpg"
        path.write_bytes(jpeg_encode(smooth_image(rs, H, W)))
        paths.append(path)
        objs = ""
        for a in rec["annotations"]:
            x1, y1, x2, y2 = (int(v) for v in a["bbox"])
            objs += (f"<object><name>{VOC_CLASS_NAMES[a['category_id']]}"
                     f"</name><difficult>0</difficult><bndbox><xmin>"
                     f"{x1 + 1}</xmin><ymin>{y1 + 1}</ymin><xmax>{x2 + 1}"
                     f"</xmax><ymax>{y2 + 1}</ymax></bndbox></object>")
        (d / "Annotations" / f"{fid}.xml").write_text(
            f"<annotation><size><width>{W}</width><height>{H}</height>"
            f"<depth>3</depth></size>{objs}</annotation>\n")
        props["ids"].append(fid)
        props["boxes"].append(rec["proposal_boxes"])
        props["objectness_logits"].append(rec["proposal_objectness_logits"])
    (d / "ImageSets" / "Main" / "trainval.txt").write_text(
        "\n".join(props["ids"]) + "\n")
    prop_file = root / "proposals.pkl"
    with open(prop_file, "wb") as f:
        pickle.dump(props, f)
    return d, str(prop_file), paths


def ph28_opts(work: Path, props: str) -> list:
    """The flagship YAML's overrides for the tree: its own data, seeded
    random weights (``MODEL.WEIGHTS`` is not in the repository)."""
    return ["MODEL.WEIGHTS", "", "OUTPUT_DIR", str(work / "out"),
            "DATASETS.TRAIN", f"('{PH28_DATASET}',)",
            "DATASETS.TEST", f"('{PH28_DATASET}',)",
            "DATASETS.PROPOSAL_FILES_TRAIN", f"('{props}',)",
            "DATASETS.PROPOSAL_FILES_TEST", f"('{props}',)"]


def ph28_launches(fn):
    """(fn's result, K1 launches in it), the counts set to 0 just before
    and read just after."""
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, read_launches()["roi_pool"]


def ph28_export(dev, tag) -> int:
    """(a) ``export.export_inference`` of the flagship at the export CLI's
    default shape, reloaded and run on the card."""
    import io

    import drn_wsod_torch
    from drn_wsod_torch.export import (export_inference, holds_roi_pool,
                                       load_exported)
    from drn_wsod_torch.ops import roi_pool as rp
    from drn_wsod_torch.tools import ablate_bench

    cfg = ablate_bench.flagship_cfg(overrides=("TEST.AUG.ENABLED", False))
    gen = torch.Generator(device=dev).manual_seed(28)
    model = drn_wsod_torch.build_model(cfg, device=dev, generator=gen)
    batch = drn_wsod_torch.synthetic_batch(1, *PH28_HW, PH28_P, 20, seed=28,
                                           device=dev)
    t = time.perf_counter()
    data = export_inference(model, batch)
    export_s = time.perf_counter() - t
    t = time.perf_counter()
    program = load_exported(data)
    load_s = time.perf_counter() - t
    ops = holds_roi_pool(program.program)
    if ops != 1:
        raise Fail(f"phase 28: (a) the exported graph holds {ops} K1 ops")
    captured = {}
    launch = rp._launch_batched

    def capturing(features, boxes, spatial_scale, resolution, roi_scale,
                  order):
        out = launch(features, boxes, spatial_scale, resolution, roi_scale,
                     order)
        captured.update(args=(features, boxes, spatial_scale, resolution,
                              roi_scale), out=out)
        return out
    with mock.patch.object(rp, "_launch_batched", capturing):
        got, launches = ph28_launches(
            lambda: [program.call(batch) for _ in range(PH28_CALLS)][-1])
    if launches != PH28_CALLS:
        raise Fail(f"phase 28: (a) {launches} K1 launches in "
                   f"{PH28_CALLS} calls of the exported program")
    err = exact("roi_pool (exported program)", captured["out"],
                rp.roi_pool_plain(*captured["args"]), phase=28)
    live = model.inference_scores(batch)
    if not all(torch.equal(g, w) for g, w in zip(got, live)):
        diffs = [(g.float() - w.float()).abs().max().item()
                 for g, w in zip(got, live)]
        raise Fail(f"phase 28: (a) exported program != live model, "
                   f"max|diff| {diffs}")
    fns = {"exported": lambda: program.call(batch),
           "eager": lambda: model.inference_scores(batch)}
    ms_prog, ms_live = (cuda_ms(fn, 10) for fn in fns.values())
    # at B = 1 the host issues a call slower than the card runs it, so
    # calls queued behind a sleep would time the host: the card's time is
    # the trace's kernel time
    issue = {k: statistics.median(host_us(fn, 1) for _ in range(5)) / 1e3
             for k, fn in fns.items()}
    ph28_trace(fns, tag)
    print(f"phase 28: (a) export of the flagship (bf16, B=1, "
          f"{PH28_HW[0]}x{PH28_HW[1]}, P={PH28_P}): torch.export "
          f"{export_s:.2f} s, {len(data)} bytes, load {load_s:.2f} s; the "
          f"graph holds the K1 op once; {PH28_CALLS} calls of the loaded "
          f"program launched K1 {launches} times, K1 == plain on its pooled "
          f"inputs (max|diff| {err}, map {tuple(captured['args'][0].shape)}); "
          f"scores and boxes bit-equal to the live model; inference_scores "
          f"{ms_prog:.3f} ms exported, {ms_live:.3f} ms eager (CUDA events, "
          f"median of 10), the host's issue of a call "
          f"{issue['exported']:.3f} / {issue['eager']:.3f} ms (median of 5) "
          f"{tag}", flush=True)
    del program, model, data, live, got, captured
    torch.cuda.empty_cache()
    return launches


def ph28_trace(fns: dict, tag, calls: int = 3) -> None:
    """One ``torch.profiler`` trace (CPU and CUDA) of ``calls`` calls of
    each of ``fns`` after a warm-up call. Prints, a call: the wall time
    under the profiler, the card's kernel time (every kernel's duration
    summed) and the ops whose self device time and self host time part the
    two most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    seen = {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3 / calls
        events = prof.key_averages()
        kernels = sum(e.device_time_total for e in events
                      if e.device_type == DeviceType.CUDA) / 1e3 / calls
        ops = {e.key: (e.self_device_time_total / 1e3 / calls,
                       e.self_cpu_time_total / 1e3 / calls, e.count // calls)
               for e in events if e.device_type == DeviceType.CPU}
        seen[name] = (wall, kernels, ops)
        print(f"phase 28: (a) trace of {name}: {wall:.3f} ms a call under "
              f"the profiler, kernels {kernels:.3f} ms a call, "
              f"{sum(c for *_, c in ops.values())} op calls {tag}",
              flush=True)
    (a, (_, _, ops_a)), (b, (_, _, ops_b)) = seen.items()
    zero = (0.0, 0.0, 0)
    for i, what in ((0, "device"), (1, "host")):
        parted = sorted(set(ops_a) | set(ops_b), key=lambda k: -abs(
            ops_a.get(k, zero)[i] - ops_b.get(k, zero)[i]))[:8]
        print(f"phase 28: (a) self {what} ms a call, {a} / {b} (calls): "
              + "; ".join(f"{k} {ops_a.get(k, zero)[i]:.3f} / "
                          f"{ops_b.get(k, zero)[i]:.3f} "
                          f"({ops_a.get(k, zero)[2]} / "
                          f"{ops_b.get(k, zero)[2]})" for k in parted),
              flush=True)


def ph28_k1_dispatch(dev, tag) -> None:
    """K1 at phase 3's flagship inputs through the ``torch.library`` op
    (``roi_pool_batched``, the wrapper's route) beside the direct ctypes
    launch the wrapper made before (check, ``top_row_order``,
    ``_launch_batched``): a call and queued, in turns."""
    from drn_wsod_torch.ops import roi_pool as rp

    gen = torch.Generator(device=dev).manual_seed(0)
    feats, boxes, scale = pool_inputs(dev, gen)

    def direct():
        rp._check_batched(feats, boxes, scale)
        return rp._launch_batched(feats, boxes, 0.125, 7, scale,
                                  rp.top_row_order(boxes))

    def op():
        return rp.roi_pool_batched(feats, boxes, 0.125, 7, scale)

    exact("roi_pool (op vs direct)", op(), direct(), phase=28)
    rows = {"op": ([], []), "direct": ([], [])}
    for _ in range(3):
        for name, fn in (("op", op), ("direct", direct)):
            rows[name][0].append(cuda_ms(fn, 20))
            rows[name][1].append(queued_ms(fn, 20))
    med = {k: (statistics.median(a), statistics.median(q))
           for k, (a, q) in rows.items()}
    print(f"phase 28: K1 at {tuple(feats.shape)} bf16, P={P}: through the "
          f"torch.library op {med['op'][0]:.4f} ms a call, "
          f"{med['op'][1]:.4f} queued; the direct launch "
          f"{med['direct'][0]:.4f} / {med['direct'][1]:.4f} (medians of 3 "
          f"turns) {tag}", flush=True)
    del feats


def ph28_generate_pgt(dev, work: Path, props: str, tag):
    """(b) ``generate_pgt`` over the tree; its boxes against
    ``make_detect_fn``'s top box for each present class."""
    import drn_wsod_torch
    from drn_wsod_torch.data import (DatasetMapper, EvalLoader,
                                     get_detection_dataset_dicts)
    from drn_wsod_torch.engine import defaults
    from drn_wsod_torch.tools import ablate_bench, generate_pgt

    # random weights spread their scores over the classes: a deep top-k
    # reaches each image's present classes
    opts = ph28_opts(work, props) + ["TEST.DETECTIONS_PER_IMAGE", "1000",
                                     "MODEL.ROI_HEADS.SCORE_THRESH_TEST",
                                     "0.0"]
    out = work / "pgt.json"
    t = time.perf_counter()
    with mock.patch.object(defaults, "setup_logger", entry_logger):
        coco, launches = ph28_launches(lambda: generate_pgt.main(
            ["--config-file", ablate_bench.FLAGSHIP, "--out", str(out),
             *opts], device=dev))
    pgt_s = time.perf_counter() - t
    close_logging()
    if launches != PH28_VOC:
        raise Fail(f"phase 28: (b) K1 launched {launches} times for "
                   f"{PH28_VOC} images")
    cfg = ablate_bench.flagship_cfg(overrides=opts)
    model = drn_wsod_torch.build_model(cfg, device=dev)
    detect = drn_wsod_torch.make_detect_fn(
        model, cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST,
        cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST, cfg.TEST.DETECTIONS_PER_IMAGE,
        device=dev)
    records = get_detection_dataset_dicts([PH28_DATASET], [props])
    want, dets = {}, {}
    for batch, _ in EvalLoader(records, DatasetMapper(cfg, False),
                               process_index=0, process_count=1):
        d = {k: v[0].cpu().numpy() for k, v in detect(batch).items()}
        r = records[int(batch.image_id[0])]
        name = os.path.basename(r["file_name"])
        dets[name] = d
        for c in {a["category_id"] for a in r["annotations"]}:
            hit = d["valid"] & (d["classes"] == c)
            if hit.any():
                top = d["scores"][hit].max()
                # near-ties of the top score may come in either order
                want[(name, c + 1)] = (float(top), d["boxes"][
                    hit & (d["scores"] >= top * (1 - 1e-3))])
    files = {im["id"]: im["file_name"] for im in coco["images"]}
    got = {(files[a["image_id"]], a["category_id"]):
           (a["score"], np.asarray(a["bbox"][:2] + [
               a["bbox"][0] + a["bbox"][2], a["bbox"][1] + a["bbox"][3]]))
           for a in coco["annotations"]}
    bad = [k for k in want if k not in got
           or abs(got[k][0] - want[k][0]) > 1e-3 * want[k][0]
           or np.abs(want[k][1] - got[k][1]).max(1).min() > 1e-2]
    if set(got) != set(want) or bad or not got:
        raise Fail(f"phase 28: (b) generate_pgt's {len(got)} pseudo boxes "
                   f"against make_detect_fn's {len(want)} top boxes: "
                   f"{sorted(set(got) ^ set(want))} unmatched, {bad} differ")
    print(f"phase 28: (b) generate_pgt over {PH28_VOC} VOC-sized JPEGs "
          f"(flagship YAML, full width, P={PH28_VOC_P}, top 1000, score "
          f"threshold 0): {len(got)} pseudo boxes over "
          f"{len(coco['images'])} images, each make_detect_fn's top box of "
          f"a present class, ids + 1; K1 {launches} launches; "
          f"{pgt_s:.1f} s {tag}", flush=True)
    del model
    torch.cuda.empty_cache()
    return launches, dets


def ph28_visualise(dev, work: Path, props: str, paths, dets, tag) -> int:
    """(c) (b)'s detections drawn and written, PNG and JPEG; the demo's
    ``--output`` on two frames; ``train_net.do_train`` with
    ``PGTVisualization``."""
    import drn_wsod_torch
    from drn_wsod_torch.data.datasets.voc import VOC_CLASS_NAMES
    from drn_wsod_torch.data.mapper import read_image
    from drn_wsod_torch.data.png import read_png
    from drn_wsod_torch.engine import defaults
    from drn_wsod_torch.tools import ablate_bench, demo, train_net
    from drn_wsod_torch.utils.visualizer import Visualizer

    t = time.perf_counter()
    draw_ms = []
    for path in paths:
        d = dets[path.name]
        t0 = time.perf_counter()
        v = Visualizer(read_image(str(path), "BGR"), VOC_CLASS_NAMES)
        v.draw_instance_predictions(d["boxes"], d["scores"], d["classes"],
                                    d["valid"])
        draw_ms.append((time.perf_counter() - t0) * 1e3)
        png, jpg = work / "vis" / f"{path.stem}.png", work / "vis" / path.name
        v.save(str(png))
        v.save(str(jpg))
        if not np.array_equal(read_png(str(png)), v.get_image()):
            raise Fail(f"phase 28: (c) {png.name} does not read back")
        back = read_image(str(jpg), "RGB")
        if back.shape != v.get_image().shape:
            raise Fail(f"phase 28: (c) {jpg.name} decodes to {back.shape}")
    opts = ph28_opts(work, props)
    frames = [str(p) for p in paths[:2]]
    n, demo_launches = ph28_launches(lambda: demo.main(
        ["--config-file", ablate_bench.FLAGSHIP, "--input", *frames,
         "--proposals", props, "--output", str(work / "demo"),
         "--confidence-threshold", "0.0", "MODEL.WEIGHTS", ""], device=dev))
    for f in frames:
        out = read_image(str(work / "demo" / os.path.basename(f)), "RGB")
        if out.shape != read_image(f, "RGB").shape:
            raise Fail(f"phase 28: (c) the demo's {f} output {out.shape}")
    cfg = ablate_bench.flagship_cfg(overrides=opts + [
        "VIS_PERIOD", "1", "SOLVER.MAX_ITER", str(PH28_TRAIN_STEPS),
        "SOLVER.IMS_PER_BATCH", "2", "SOLVER.CHECKPOINT_PERIOD", "1000",
        "TEST.EVAL_PERIOD", "0"])
    model = drn_wsod_torch.build_model(cfg, device=dev)
    with mock.patch.object(defaults, "setup_logger", entry_logger):
        defaults.default_setup(cfg)
        _, train_launches = ph28_launches(
            lambda: train_net.do_train(cfg, model, device=dev))
    close_logging()
    pngs = sorted((work / "out" / "pgt_vis").iterdir())
    # one launch a step and one a hook's mining pass
    if len(pngs) != 2 * PH28_TRAIN_STEPS or train_launches != \
            2 * PH28_TRAIN_STEPS:
        raise Fail(f"phase 28: (c) PGTVisualization wrote {len(pngs)} "
                   f"PNGs, K1 {train_launches} launches in "
                   f"{PH28_TRAIN_STEPS} steps")
    shape = read_png(str(pngs[0])).shape
    print(f"phase 28: (c) {len(paths)} images drawn with (b)'s detections "
          f"(host ms an image, median {statistics.median(draw_ms):.1f}), "
          f"each PNG read back equal by data/png.py and each JPEG decoded "
          f"by the port's decoder; the demo's --output on 2 frames (video "
          f"visualizer, {n} detections, K1 {demo_launches}); do_train "
          f"{PH28_TRAIN_STEPS} steps with VIS_PERIOD 1: {len(pngs)} "
          f"pgt_vis PNGs of {shape}, K1 {train_launches}; "
          f"{time.perf_counter() - t:.1f} s {tag}", flush=True)
    del model
    torch.cuda.empty_cache()
    return demo_launches + train_launches


def ph28_clis(dev, work: Path, props: str, tag) -> int:
    """(d) analyze_model, benchmark, plain_train_net and imagenet on the
    card."""
    from drn_wsod_torch.engine import defaults
    from drn_wsod_torch.engine.defaults import default_argument_parser
    from drn_wsod_torch.tools import (ablate_bench, analyze_model, benchmark,
                                      imagenet, plain_train_net)

    t = time.perf_counter()
    (counts, flops), a_launches = ph28_launches(lambda: analyze_model.main(
        ["--config-file", ablate_bench.FLAGSHIP], device=dev))
    total = sum(counts.values())
    cfg = ablate_bench.flagship_cfg(overrides=ph28_opts(work, props) + [
        "SOLVER.IMS_PER_BATCH", "2", "TEST.AUG.MIN_SIZES",
        "(480, 576, 688, 864, 1000, 1200)", "TEST.AUG.MAX_SIZE", "2000"])
    bench = {}
    for name, fn in (
            ("train", lambda: benchmark.benchmark_train_synthetic(
                cfg, PH28_BENCH_ITERS, device=dev)),
            ("eval", lambda: benchmark.benchmark_eval_synthetic(
                cfg, PH28_BENCH_ITERS, 2, device=dev)),
            ("tta", lambda: benchmark.benchmark_tta_synthetic(
                cfg, 2, device=dev)),
            ("data", lambda: benchmark.benchmark_data(
                cfg, PH28_BENCH_ITERS))):
        bench[name], n = ph28_launches(fn)
        bench[name]["K1"] = n
        torch.cuda.empty_cache()
    args = default_argument_parser().parse_args(
        ["--config-file", ablate_bench.FLAGSHIP, *ph28_opts(work, props),
         "SOLVER.MAX_ITER", str(PH28_TRAIN_STEPS), "SOLVER.IMS_PER_BATCH",
         "2", "OUTPUT_DIR", str(work / "plain")])
    with mock.patch.object(defaults, "setup_logger", entry_logger):
        state, p_launches = ph28_launches(
            lambda: plain_train_net.main(args, device=dev))
    close_logging()
    if state.step != PH28_TRAIN_STEPS or p_launches != PH28_TRAIN_STEPS:
        raise Fail(f"phase 28: (d) plain_train_net step {state.step}, K1 "
                   f"{p_launches}")
    del state
    torch.cuda.empty_cache()
    last = imagenet.main(["--synthetic", "--batch-size", "8", "--iters",
                          str(PH28_IMAGENET_ITERS), "--out",
                          str(work / "imagenet")], device=dev)
    if not math.isfinite(last["loss"]):
        raise Fail(f"phase 28: (d) imagenet loss {last}")
    k1 = a_launches + p_launches + sum(b["K1"] for b in bench.values())
    print(f"phase 28: (d) analyze_model: {total / 1e6:.2f} M parameters "
          f"{json.dumps({k: v for k, v in sorted(counts.items())})}, forward "
          f"{flops / 1e9:.2f} GFLOP (FlopCounterMode, B=1 704^2, P=4096), "
          f"K1 {a_launches}; benchmark (CUDA events; tta and data by the "
          f"host clock) {json.dumps(bench)}; plain_train_net "
          f"{PH28_TRAIN_STEPS} steps, K1 {p_launches}; imagenet (WS-R50, "
          f"BN on batch statistics, B=8, 112^2) {PH28_IMAGENET_ITERS} steps, "
          f"loss {last['loss']:.4f}; {time.perf_counter() - t:.1f} s {tag}",
          flush=True)
    return k1


def phase28_last_slice(dev, tag) -> dict:
    """Export, generate_pgt, the visualizers and writers, and the other
    CLIs, at the flagship's full width; every part run with the
    launch counts set to 0 just before it and read just after."""
    import shutil

    from drn_wsod_torch.data import DatasetCatalog
    from drn_wsod_torch.data.datasets.voc import register_pascal_voc

    t_phase = time.perf_counter()
    work = Path(__file__).resolve().parent / "build" / "chip_smoke_ph28"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    launches = {"export": ph28_export(dev, tag)}
    ph28_k1_dispatch(dev, tag)
    d, props, paths = ph28_voc(work / "voc", np.random.RandomState(28))
    if PH28_DATASET not in DatasetCatalog:
        register_pascal_voc(PH28_DATASET, str(d), "trainval", 2007)
    launches["generate_pgt"], dets = ph28_generate_pgt(dev, work, props, tag)
    launches["visualise"] = ph28_visualise(dev, work, props, paths, dets, tag)
    launches["clis"] = ph28_clis(dev, work, props, tag)
    shutil.rmtree(work, ignore_errors=True)
    print(f"phase 28: K1 launches {launches}; phase "
          f"{time.perf_counter() - t_phase:.1f} s {tag}", flush=True)
    reset_launches()
    return {**read_launches(), "roi_pool": sum(launches.values())}


# ------------------------------------------------------------- phase 29
PH29_STEPS, PH29_DECODES, PH29_IMAGENET_ITERS = 4, 20, 3
# (fixture tool, file) of the VOC tree's JPEGImages, each copied as
# <id>.jpg: the new kinds at VOC size beside a baseline file; the
# last two are the test split, evaluated from their files
PH29_TRAIN = (("jpeg", "voc/cmyk_500x375.jpg"),
              ("jpeg", "voc/arith_500x375.jpg"),
              ("jpeg", "voc/arith_500x375_progressive.jpg"),
              ("jpeg", "voc/truncated_500x375_ac1.jpg"),
              ("jpeg", "voc/truncated_500x375_between.jpg"),
              ("jpeg", "voc/truncated_500x375_refine.jpg"),
              ("png", "voc/rgb16_500x375.png"),
              ("jpeg", "voc_500x375_q90.jpg"))
PH29_TEST = (("jpeg", "voc/ycck_500x375.jpg"),
             ("png", "voc/adam7_rgb8_500x375.png"))
# the imagenet tool's two-class tree (each file named .JPEG)
PH29_IMAGENET = {"n01": PH29_TRAIN[:4] + (PH29_TEST[1],),
                 "n02": (PH29_TEST[0], PH29_TRAIN[6], PH29_TRAIN[7],
                         ("jpeg", "voc_500x375_q90_progressive.jpg"),
                         ("jpeg", "voc/truncated_500x375_refine.jpg"))}
PH29_TIMED = {"CMYK": ("jpeg", "voc/cmyk_500x375.jpg"),
              "YCCK": ("jpeg", "voc/ycck_500x375.jpg"),
              "arithmetic": ("jpeg", "voc/arith_500x375.jpg"),
              "arithmetic progressive": (
                  "jpeg", "voc/arith_500x375_progressive.jpg"),
              "block smoothing": ("jpeg", "voc/truncated_500x375_refine.jpg"),
              "baseline": ("jpeg", "voc_500x375_q90.jpg"),
              "Adam7 PNG": ("png", "voc/adam7_rgb8_500x375.png"),
              "16-bit PNG": ("png", "voc/rgb16_500x375.png")}


def ph29_fixture(tool: str, name: str):
    """(path, RGB digest of the JAX package's read_image, (H, W)) of a
    fixture of the JPEG or the PNG tool."""
    from drn_wsod_torch.tools import make_jpeg_fixtures, make_png_fixtures

    if tool == "jpeg":
        e = json.loads((make_jpeg_fixtures.FIXTURE_DIR / "manifest.json")
                       .read_text())["files"][name]
        return (make_jpeg_fixtures.FIXTURE_DIR / name,
                e["read_image_sha256"], tuple(e["shape"][:2]))
    e = make_png_fixtures.load_manifest()["files"][name]
    return (make_png_fixtures.FIXTURE_DIR / name, e["rgb_sha256"],
            tuple(e["shape"][:2]))


def ph29_decodes(tag) -> str:
    """(a) Pillow blocked: every fixture added for this phase's kinds at
    each scale its manifest records, and through ``read_image`` to the
    JAX package's digest (misnamed files included); every PNG fixture of
    ``modes/`` and ``voc/`` (Adam7 and 16-bit among them) through
    ``read_png`` and ``read_png_rgb`` to Pillow's digests; (d) the host
    ms of a decode of each PH29_TIMED file, median of PH29_DECODES."""
    from drn_wsod_torch import native
    from drn_wsod_torch.data import mapper, png
    from drn_wsod_torch.tools import make_jpeg_fixtures, make_png_fixtures

    jdir = make_jpeg_fixtures.FIXTURE_DIR
    jman = json.loads((jdir / "manifest.json").read_text())
    pman = make_png_fixtures.load_manifest()
    with no_pillow():
        scales = check_jpeg_digests(29, jdir, jman, make_jpeg_fixtures.MADE)
        for name in make_jpeg_fixtures.MADE:
            got = sha256_of(mapper.read_image(str(jdir / name), "RGB"))
            if got != jman["files"][name]["read_image_sha256"]:
                raise Fail(f"phase 29: read_image on {name} differs from "
                           "the JAX package's")
        pngs = [n for n in pman["files"] if n.startswith(("modes/", "voc/"))]
        for name in pngs:
            path, e = str(make_png_fixtures.FIXTURE_DIR / name), \
                pman["files"][name]
            if make_png_fixtures.digest(png.read_png(path)) != e["sha256"]:
                raise Fail(f"phase 29: read_png on {name} differs from "
                           "Pillow's")
            if sha256_of(png.read_png_rgb(path)) != e["rgb_sha256"]:
                raise Fail(f"phase 29: read_png_rgb on {name} differs "
                           "from Pillow's")
        ms = {}
        for what, (tool, name) in PH29_TIMED.items():
            data = ph29_fixture(tool, name)[0].read_bytes()
            decode = native.jpeg_decode if tool == "jpeg" else \
                png.decode_png_rgb
            times = []
            for _ in range(PH29_DECODES):
                t = time.perf_counter()
                decode(data)
                times.append((time.perf_counter() - t) * 1e3)
            ms[what] = statistics.median(times)
    line = (f"phase 29: (a) {scales} JPEG decodes of "
            f"{len(make_jpeg_fixtures.MADE)} new fixtures at their recorded "
            f"scales and {len(make_jpeg_fixtures.MADE)} read_image decodes "
            f"equal their manifest digests, {len(pngs)} PNG fixtures through "
            "read_png and read_png_rgb equal Pillow's (Pillow blocked); (d) "
            f"host ms a 500x375 decode (median of {PH29_DECODES}, the "
            "host's clock, not the card's): " + ", ".join(
                f"{k} {v:.3f}" for k, v in ms.items()) + f" {tag}")
    print(line, flush=True)
    return line


def ph29_imagenet(dev, work: Path, tag) -> dict:
    """(c) the imagenet tool, PH29_IMAGENET_ITERS steps of WS-R50 at B=8
    (224^2, the size it reads a folder at) over a two-class tree holding
    CMYK, YCCK, PNGs named .JPEG, arithmetic coding and progressive files
    cut short, each decoded by ``read_image`` (counted), Pillow blocked."""
    import shutil

    from drn_wsod_torch.data import mapper
    from drn_wsod_torch.tools import imagenet

    root = work / "imagenet"
    for cls, files in PH29_IMAGENET.items():
        (root / cls).mkdir(parents=True)
        for i, (tool, name) in enumerate(files):
            shutil.copyfile(ph29_fixture(tool, name)[0],
                            root / cls / f"{cls}_{i}.JPEG")
    decoded = []
    read = mapper.read_image

    def counted(path, fmt="BGR"):
        decoded.append(Path(path).name)
        return read(path, fmt)

    t = time.perf_counter()
    with no_pillow(), mock.patch.object(mapper, "read_image", counted):
        last = imagenet.main(["--data", str(root), "--batch-size", "8",
                              "--iters", str(PH29_IMAGENET_ITERS),
                              "--num-classes", "2", "--out",
                              str(work / "imagenet_out")], device=dev)
    torch.cuda.synchronize()
    if not math.isfinite(last.get("loss", float("nan"))) or \
            len(decoded) != 8 * PH29_IMAGENET_ITERS:
        raise Fail(f"phase 29: (c) imagenet {last}, {len(decoded)} "
                   "decodes")
    print(f"phase 29: (c) imagenet (WS-R50, BN on batch statistics, B=8, "
          f"224^2) {PH29_IMAGENET_ITERS} steps over a two-class tree of "
          f"{sum(len(v) for v in PH29_IMAGENET.values())} files (CMYK, YCCK, "
          "PNGs named .JPEG, arithmetic, cut progressive), "
          f"{len(decoded)} read_image decodes, Pillow blocked; loss "
          f"{last['loss']:.4f}; {time.perf_counter() - t:.1f} s {tag}",
          flush=True)
    torch.cuda.empty_cache()
    return last


def phase29_image_formats(dev, tag) -> dict:
    """Every image file the JAX package's readers decode, decoded by the
    port without Pillow (blocked here, absent on the machine): (a) the
    new fixtures' digests; (b) a VOC tree whose JPEGImages mix VOC-sized
    CMYK, arithmetic, cut progressive, 16-bit and interlaced PNG files
    with a baseline one, all named .jpg, packed by ``pack_dataset``
    (pixels the JAX package's ``read_image`` digests in BGR), then
    ``train_net.main`` on the flagship YAML at full width, PH29_STEPS
    steps of B=4 from the shard and the YAML's TTA eval of the two test
    records (YCCK and an Adam7 PNG), each decoded from its file by
    ``read_image``: losses finite, K1 once a step and a TTA group and
    exact at the largest map, detections finite and inside their images;
    (c) the imagenet tool (``ph29_imagenet``); (d) host decode ms
    (``ph29_decodes``). Returns the K1 launches of (b)."""
    import shutil

    import drn_wsod_torch
    from drn_wsod_torch import tta
    from drn_wsod_torch.data import (DatasetCatalog, MetadataCatalog,
                                     RecordDataset, pack_dataset)
    from drn_wsod_torch.data.datasets.voc import (VOC_CLASS_NAMES,
                                                  load_voc_instances)

    t_phase = time.perf_counter()
    here = Path(__file__).resolve().parent
    ph29_decodes(tag)
    work = here / "build" / "chip_smoke_ph29"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    sources, want = {}, {}
    for i, (tool, name) in enumerate(PH29_TRAIN + PH29_TEST):
        fid = f"{i:06d}" if i < len(PH29_TRAIN) else \
            f"{100 + i - len(PH29_TRAIN):06d}"
        path, digest, shape = ph29_fixture(tool, name)
        sources[fid] = (path, shape)
        want[fid] = digest
    with no_pillow():
        voc, prop_file, hw = voc_tree(work, sources,
                                      np.random.RandomState(29))
        shard = work / "ph29_train.rec"
        t = time.perf_counter()
        n_packed = pack_dataset(load_voc_instances(str(voc), "trainval"),
                                str(shard))
        pack_s = time.perf_counter() - t
        packed = list(RecordDataset(str(shard)))
        if n_packed != len(PH29_TRAIN) or len(packed) != len(PH29_TRAIN):
            raise Fail(f"phase 29: packed {n_packed} records, want "
                       f"{len(PH29_TRAIN)}")
        for r in packed:
            if sha256_of(r["image"][:, :, ::-1]) != want[r["image_id"]]:
                raise Fail(f"phase 29: packed pixels of {r['image_id']} are "
                           "not the JAX package's read_image decode")
        for name, get in (("ph29_train",
                           lambda: list(RecordDataset(str(shard)))),
                          ("ph29_test",
                           lambda: load_voc_instances(str(voc), "test"))):
            if name in DatasetCatalog:
                DatasetCatalog.remove(name)
            DatasetCatalog.register(name, get)
            MetadataCatalog.get(name).set(
                thing_classes=list(VOC_CLASS_NAMES),
                evaluator_type="pascal_voc", year=2007, split=name)
        yaml = here / "configs" / "PascalVOC-Detection" / \
            "oicr_WSR_50_DC5_1x.yaml"
        yaml_is(29, yaml, MODEL__ROI_BOX_HEAD__DAN_DIM=[2048, 4096],
                SOLVER__IMS_PER_BATCH=4, INPUT__CROP__ENABLED=True,
                INPUT__MAX_SIZE_TRAIN=2000, MODEL__DTYPE="bfloat16",
                TEST__AUG__ENABLED=True, TEST__AUG__FLIP=True)
        opts = ["DATASETS.TRAIN", "('ph29_train',)",
                "DATASETS.TEST", "('ph29_test',)",
                "DATASETS.PROPOSAL_FILES_TRAIN", repr((prop_file,)),
                "DATASETS.PROPOSAL_FILES_TEST", repr((prop_file,)),
                "MODEL.WEIGHTS", "", "OUTPUT_DIR", str(work / "output"),
                "SEED", "0", "TEST.EVAL_PERIOD", "0",
                "SOLVER.MAX_ITER", str(PH29_STEPS),
                "SOLVER.CHECKPOINT_PERIOD", str(PH29_STEPS),
                "TEST.EVAL_TRAIN", "False",
                # as phase 22: every finite score kept
                "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "-1.0"]
        test_hw = {k: v for k, v in hw.items() if int(k) >= 100}
        cfg = drn_wsod_torch.get_cfg()
        cfg.merge_from_file(str(yaml))
        cfg.merge_from_list(opts)
        tta_groups = tta_group_count(cfg, test_hw)
        decoded = []
        read = tta.read_image

        def counted_read(path, fmt="BGR"):
            decoded.append(Path(path).name)
            return read(path, fmt)

        captured = {}
        run = entry_main(29, dev, yaml, opts, hw, [
            k1_capture(captured), (tta, "read_image", counted_read)])
    per_step = check_steps(29, run, ["plain"] * PH29_STEPS,
                           {"plain": OICR_NAMES})
    if run["launches"]["roi_pool"] != PH29_STEPS + tta_groups:
        raise Fail(f"phase 29: K1 launches {run['launches']['roi_pool']}, "
                   f"want {PH29_STEPS} steps + {tta_groups} TTA groups")
    check_detections(29, run, len(PH29_TEST))
    if any(n == 0 for _, n in run["dets"]):
        raise Fail(f"phase 29: images without a finite score: "
                   f"{run['dets']}")
    if sorted(decoded) != sorted(f"{i}.jpg" for i in test_hw):
        raise Fail(f"phase 29: the TTA eval decoded {decoded}, want the "
                   f"{len(PH29_TEST)} test files")
    k1 = k1_exact(29, captured)
    print_entry(29, f"(b) a VOC tree of {len(PH29_TRAIN)} + "
                f"{len(PH29_TEST)} VOC-sized files named .jpg (CMYK, YCCK, "
                "arithmetic sequential and progressive, progressive cut in "
                "its first AC scan, between scans and in a refinement "
                "scan, 16-bit and Adam7 PNG, baseline), Pillow blocked: "
                f"pack_dataset of {len(PH29_TRAIN)} records in {pack_s:.2f} "
                "s, pixels equal the JAX package's read_image digests; the "
                f"flagship train_net.main, {PH29_STEPS} steps of B=4 (DAN "
                "[2048, 4096], bfloat16, crop, P=4096, seeded random "
                f"weights) from the shard, then TTA eval of the "
                f"{len(PH29_TEST)} unpacked test records (YCCK, Adam7 PNG) "
                f"decoded by read_image ({len(decoded)} decodes)", per_step,
                run, k1, f"{PH29_STEPS} steps + {tta_groups} TTA groups",
                len(PH29_TEST), "", tag)
    ph29_imagenet(dev, work, tag)
    shutil.rmtree(work, ignore_errors=True)
    print(f"phase 29: {time.perf_counter() - t_phase:.1f} s {tag}",
          flush=True)
    return run["launches"]


def main() -> int:
    t_run = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        return 1
    # the package beside this script, whatever the working directory
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        from drn_wsod_torch.tools.ablate_bench import card
    except ModuleNotFoundError as e:
        print(f"chip_smoke: the drn_wsod_torch package is not beside this "
              f"script ({e}); run it from a checkout of the repository",
              file=sys.stderr)
        return 1

    card_line = card()
    tag = f"[{card_line}]"
    print(f"phase 1: card {card_line}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    # the port's float32 paths run in full float32; the flagship runs bf16
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from drn_wsod_torch.ops import _build

    t0 = time.perf_counter()
    # the JPEG decoder and encoder (host code) build beside the CUDA
    # sources
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as pool:
        host = pool.submit(_build.build_host, "jpeg_decode")
        encoder = pool.submit(_build.build_host, "jpeg_encode")
        logs = _build.build_all()
        host_build, encoder_build = host.result(), encoder.result()
    print(f"phase 2: built {sorted(logs)} in "
          f"{time.perf_counter() - t0:.2f} s, one nvcc per source in parallel "
          f"{tag}; the JPEG decoder by {host_build['compiler']} in "
          f"{host_build['seconds']:.2f} s, the JPEG encoder in "
          f"{encoder_build['seconds']:.2f} s", flush=True)
    for name, log in logs.items():
        for kernel, lines in ptxas_report(log):
            print(f"  {name}: {kernel}: {'; '.join(lines)}")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    try:
        kernels = phase3_kernels(dev, gen, tag)
        paths = {}
        for name, phase in (("detect", lambda: phase4_detect(dev, gen, tag)),
                            ("train", lambda: phase5_train(dev, gen, tag)),
                            ("ablate", lambda: phase6_ablate(tag)),
                            ("banded_probe", lambda: phase7_banded_probe(tag)),
                            ("dtype_probe", lambda: phase8_dtype_probe(tag))):
            paths[name] = phase()
            torch.cuda.empty_cache()
        phase9_tests(tag)
        paths["eval"] = phase10_eval(dev, gen, tag)
        torch.cuda.empty_cache()
        paths["train_entry"] = phase11_train_entry(dev, tag)
        torch.cuda.empty_cache()
        paths["pcl"] = phase12_pcl(dev, tag)
        torch.cuda.empty_cache()
        paths["csc"] = phase13_csc(dev, tag)
        torch.cuda.empty_cache()
        paths["vgg"] = phase14_vgg(dev, tag)
        torch.cuda.empty_cache()
        paths["plain_resnet"] = phase15_plain_resnet(dev, tag)
        torch.cuda.empty_cache()
        paths["wsjds"] = phase16_wsjds(dev, tag)
        torch.cuda.empty_cache()
        paths["coco"] = phase17_coco(dev, tag)
        torch.cuda.empty_cache()
        paths["bn"] = phase18_bn(dev, tag)
        torch.cuda.empty_cache()
        paths["supervised"] = phase19_supervised(dev, tag)
        torch.cuda.empty_cache()
        paths["fpn"] = phase20_fpn(dev, tag)
        torch.cuda.empty_cache()
        paths["deform"] = phase21_deform(dev, tag)
        torch.cuda.empty_cache()
        paths["jpeg"], jpeg_line = phase22_jpeg(dev, tag, host_build)
        torch.cuda.empty_cache()
        paths["masks"] = phase23_masks(dev, tag)
        torch.cuda.empty_cache()
        paths["retinanet"] = phase24_retinanet(dev, tag)
        torch.cuda.empty_cache()
        paths["dense"] = phase25_dense(dev, tag)
        torch.cuda.empty_cache()
        paths["rotated_lvis_cityscapes"] = phase26_rotated_lvis_cityscapes(
            dev, tag)
        torch.cuda.empty_cache()
        paths["multi_device"] = phase27_multi_device(dev, tag)
        torch.cuda.empty_cache()
        paths["last_slice"] = phase28_last_slice(dev, tag)
        torch.cuda.empty_cache()
        paths["image_formats"] = phase29_image_formats(dev, tag)
    except Fail as e:
        print(f"FAIL {e}")
        return 1
    # K3 is two kernels, both launched once per call
    counted = {"roi_pool_banded": ("roi_pool_banded", "roi_pool_banded_rest")}
    for k in kernels.values():
        k["launches"] = sum(p[c] for p in paths.values()
                            for c in counted.get(k["name"], (k["name"],)))
    idle = [k["name"] for k in kernels.values() if k["launches"] == 0]
    if idle:
        print(f"FAIL no path launched {idle}")
        return 1
    print(f"launches per path: {json.dumps(paths)}")
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_run:.1f} s {tag}")
    print(jpeg_line)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--ph27-rank":
        sys.exit(ph27_rank(sys.argv[2]))
    sys.exit(main())
