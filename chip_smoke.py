"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU (H100).

Drives the port's eleven paths (``cinema_tpu_torch``), serving, MAE
pretraining, ConvViT fine-tuning, ConvUNetR segmentation fine-tuning,
landmark localization, the M&Ms and M&Ms2 tasks, the EMIDEC, MyoPS2020,
Rescan and Kaggle tasks with the evaluation of run folders, the UNet and
ResNet baselines, the example scripts, the offline preprocessing CLIs, and
the C++ frame reader with the distributed train steps, at
full width and holds every
hand-written kernel of those paths against its plain PyTorch version on the
card:

1. device: a CUDA card must be present; prints its name and power limit;
2. build: compiles every kernel under ``cinema_tpu_torch/csrc`` with nvcc
   (one process per source, all at once), prints ptxas's registers and
   spills, counts the TF32 tensor-core instructions of the f32 forward and
   backward in the built code, and prints what one TF32 product does with the low 13
   mantissa bits of an f32 operand;
3. kernels: the packed and the per-head attention forward and backward
   kernels against their plain versions at the paths' shapes (the landmark
   paths' 257 tokens, EMIDEC's 289 and MyoPS2020's 577 among them) and at
   ragged and cross-attention shapes, the f32 backward of each layout also
   at a ragged shape whose every score is near -160 (log2 domain)
   (the per-head ones with v as the strided v
   half of a fused kv projection and through transposed views), with each
   one's time per call, its device time alone (launches back to back,
   enqueued while the device sleeps, so the host's share is hidden), the
   plain version's, one PyTorch library call's (a yardstick only; per call
   and device alone) and the card's lower bound (f32, forward and backward:
   three TF32 passes on the tensor cores, and ``bound_simt_ms``, one f32 pass
   on the CUDA cores); each backward also with its passes apart (dk/dv, dq,
   delta); then the stems' depthwise 5^nd convolution (forward, data
   gradient, weight gradient) against its plain versions in f32 at the
   fine-tuning, serving and pretraining shapes (SAX as the sparse stem's
   strided view, LAX 2-D, f32), with the same times, cuDNN's as the library
   call and the CUDA cores' f32 rate or the bytes as the bound, and the weight
   gradient bit-identical over two calls;
4. serving: ConvUNetR-base from the packaged ACDC config with seeded random
   weights serves a 50-frame 192x192x16 SAX cine in chunks of 8 and one
   192x192x24 study by sliding window, in bf16; the launch counts of the
   serving run are checked, and one chunk's f32 logits through the kernel
   are held against the plain attention path; the JAX package's
   ``configs/segmentation/acdc.yaml``, read by the port's YAML reader, must
   equal the packaged config, and ``python -m cinema_tpu_torch.serve
   --config`` with it serves 8 frames in a process of its own with the same
   weights (its labels against this process's); ``load_run`` rebuilds a run
   folder whose ``config.yaml`` the JAX package's writer left (a test
   fixture);
5. training: CineMA-base from the packaged MAE config with seeded random
   weights, bf16, four views, batch 16, on 32 seeded synthetic studies
   written as the UKB preprocessing writes them (``<pid>/<pid>_<view>.nii.gz``,
   uint8, one gzip member per frame; SAX 192x192x16, LAX 256x256x1; 10
   frames where UKB has 50): ``tasks.pretrain.run`` takes one epoch (the
   manifest, the loader's worker processes, ``device_prefetch``) and writes
   the manifest's cache, its checkpoint and ``cinema.safetensors``, which are
   reloaded, and a second scan reads the cache; the pretraining loader alone
   (ms per batch of 16, items/s) with threads and with processes, which must
   give the same batches; six steps fed through ``device_prefetch`` from the
   processes (ms per step, the loader's wait per step; each batch on the card
   equal to the loader's); six timed steps with the batch already on the
   card, with the launch counts, losses and counters checked, a NaN batch
   that must leave the state bit-identical, and one f32 step at batch 2
   whose loss and gradients through the kernels are held against the plain
   attention path;
6. fine-tuning: ConvViT-base from the packaged ACDC classification config
   (SAX 192x192x16, two frames as channels, 2305 tokens, batch 4, bf16,
   seeded weights, seeded synthetic studies in the processed ACDC layout:
   uint8 NIfTI and ``train_metadata.csv``, training items augmented as the
   config says): steps of the default model through the packed kernels, then of the ``rotary=True`` model through the
   per-head kernels (timed, with the launch counts, one step with block
   recomputation, a NaN batch, an f32 step against the plain attention
   path), a short ``run_train`` with evaluations whose checkpoint and
   safetensors are reloaded, and the regression task for one step and one
   evaluation;
7. segmentation: ConvUNetR-base from the packaged ACDC segmentation config
   (SAX 192x192x16, batch 4, bf16, seeded weights) on 20 seeded synthetic
   studies in the processed ACDC layout (uint8 NIfTI images and labels,
   three nested ellipsoid shells, and ``train_metadata.csv``; training items
   augmented as the config says) of three sizes: 192x192x16, 224x208x10 (four in-plane patches, padded in z) and
   200x200x18 (padded to 20 by the z bucket, two z-patches). Timed steps with
   the ViT blocks recomputed (``grad_ckpt``, the config's default: 24 packed
   forward and 12 backward launches a step) and without (12 + 12), a NaN
   batch, an f32 step against the plain attention path, one evaluated study
   of each size (12 forward launches a frame, the HD95 host time apart), and
   two epochs of ``tasks.segmentation.acdc.run`` with an evaluation each,
   whose metrics, checkpoint and safetensors are checked;
8. landmark: the 2-D ``lax_2c`` view at 256x256 (257 tokens), bf16, batch 4,
   seeded weights, on seeded synthetic 8-bit PNGs and metadata tables in the
   JAX preprocessing's layout (uint8 noise with three bright discs; 16
   training images of 256x256). ConvUNetR-base heatmaps
   (``tasks.segmentation.landmark``): timed ``grad_ckpt`` steps (24 packed
   forward and 12 backward launches a step), a NaN batch, an f32 step against
   the plain attention path, one evaluated image of 256x256 (one patch) and
   one of 320x288 (four patches), 12 forward launches each, whose argmax
   coordinates on the card are held to ``heatmap_argmax`` of the same logits
   on the CPU, and two epochs of ``run``. ConvViT-base coordinates
   (``tasks.regression.landmark``, six outputs): the same steps, counts, NaN
   batch and f32 step, one evaluation of four 256x256 images (12 launches
   each), and two epochs of ``run``. Each ``run``'s metrics are checked and
   its checkpoint and safetensors reloaded to the same outputs;
9. mnms: seeded synthetic M&Ms and M&Ms2 trees in the preprocessing's layout
   (14 training and 5 validation studies each, SAX 192x192xz with z from 10
   to 14, uint8 images with a bright LV/MYO/RV blob and their labels;
   metadata with ``pid``, ``n_slices``, ``pathology``, ``ef`` and, for M&Ms,
   ``age``). The augmented training loader of ``segmentation/mnms`` alone
   (ms per batch of 4 and items/s with 1 thread, ``train.n_workers`` threads
   and as many processes, which must give the same batches); ConvUNetR-base
   ``grad_ckpt`` steps at batch 4 fed from that loader through
   ``device_prefetch`` inside the loop (a warm-up and six timed steps with 4 threads and with 4 processes at
   ``transform.prob`` 0.5, and with 4 threads, as ``run_train`` loads, at
   ``prob`` 0:
   ms per step, the loader's wait per step, peak memory, 24 + 12 launches a
   step; with ``--profile`` the card's idle share of a fed step); one epoch
   of each of the six entry points' ``run``, with finite metrics, the
   launches its steps and evaluated items need, and its checkpoint and
   safetensors reloaded to the same outputs;
10. cine: seeded synthetic trees in the preprocessing's layouts. EMIDEC
   (96x96x8, labels 0-4; ConvUNetR-base as packaged, 289 tokens) and
   MyoPS2020 (192x192x4, three sequences as channels; 577 tokens), each:
   timed ``grad_ckpt`` steps at batch 4 (24 + 12 launches a step), a NaN
   batch, an f32 step against the plain attention path, one test volume
   larger than the patch evaluated on the card with its grouped-class
   metrics held to the CPU's from the same log-probabilities (rtol 1e-6),
   and one epoch of the task's ``run`` with its checkpoint reloaded. Frame
   seeks: a 192x192x16x25 cine written frame-indexed and as one gzip member,
   ms per ``load_nifti_frame`` of each. Rescan (cines of 192x192x16x25):
   ``grad_ckpt`` steps fed in the loop through ``device_prefetch`` by the augmented loader of per-frame
   items (the loader's wait a step), one epoch of ``rescan.run``, and the
   label-free EF reproducibility (``rescan_ef_eval.main``, bfloat16, 48
   launches a cine) over scan/rescan pairs. Kaggle: ``evaluate_kaggle`` on
   three 30-frame cines (48 float32 launches a cine at (8, 2305)). Then
   ``tasks.evaluate.main`` (float32, as in the JAX package, through the
   kernel: every call's dtype noted) on the EMIDEC, MyoPS2020 and Rescan
   run folders (the Rescan one on a labelled split and on test_retest_100)
   and on an ED/ES run folder of the packaged ACDC model with a JAX-style
   ``config.yaml``. Each is called with torch's default TF32 flags (this
   script turns TF32 off elsewhere): every attention call must run with
   TF32 off for cuBLAS and cuDNN, set by the entry point, and the flags
   must be torch's defaults again after it;
11. baselines: the UNet (``PACKAGED["segmentation/acdc"]`` with
   ``model.name=unet``: chans 32-512, instance norm, 192x192x16) and the
   ResNet (``classification/acdc`` and ``regression/acdc`` with
   ``model.name=resnet``: basic blocks [3, 4, 6, 3], ED and ES as two
   channels) in bf16 at batch 4 on eight synthetic ACDC studies: timed steps
   with peak memory, a NaN batch (the ResNet's running statistics too), f32
   logits and one f32 step on the card against the CPU's from the same
   weights (a 96x96x16 crop for the UNet), one 224x208x10 study evaluated by
   sliding window, one regression step, and one epoch of the segmentation
   and classification entry points' ``run`` with the checkpoint reloaded;
   no attention kernel is launched;
12. examples: the example scripts (``cinema_tpu_torch.examples``) from seeded
   full-width weights written as a user has them, a safetensors file with a
   ``config.yaml`` beside it. ``segmentation_sax`` (ConvUNetR-base) on a
   192x192x16x30 SAX NIfTI and ``serve`` with ``.nii.gz`` in and out, each
   through ``python -m`` in a process of its own: their labels against
   ``serve.segment_cine`` in this process (agreement >= 0.999), the input's
   spacing kept, the GIF and PNG signatures. In this process through
   ``main(argv)``: ``segmentation_lax_4c`` (256x256x1x30), ``classification_cvd``
   and ``regression_ef`` (ConvViT-base, 192x192x16), the landmark pair on
   256x256 PNGs written by ``viz.write_png`` (gray and RGB), ``mae`` and
   ``mae_feature_extraction`` (CineMA-base, four views), each output against
   the same model called here (rtol 1e-3; argmax coordinates equal but for
   ties; the MAE's loss and reconstructions on the script's masks), each
   script's model load, first forward and ``main`` timed; then the four
   training tutorials for one epoch each on synthetic ACDC (12 studies of
   three classes) and UKB studies (finite loss, the safetensors reloaded);
   both packed kernels must be launched;
13. preprocess: the ten preprocessing CLIs of ``cinema_tpu_torch.data.preprocess``
   (``python -m`` entry points; ACDC, M&Ms, M&Ms2, EMIDEC, MyoPS2020, landmark,
   Kaggle, rescan, UKB ``dicom_to_nifti`` and ``cinema_reindex_nifti``) run in
   this process, Kaggle's with two worker processes, on small raw trees from
   this script's seeded writers, each output tree held to the JAX CLI's from
   the same tree (``tests/fixtures/preprocess_jax``): the same files, NIfTI and
   CSV bytes equal, PNG pixels equal (where a NIfTI differs: its voxels that
   differ and the largest difference, with numpy's and scipy's versions). Then
   at real size: one ACDC study (216x256x10x30 float at 1.5625x1.5625x10 mm)
   through ``acdc`` and the port's segmentation evaluation with
   ConvUNetR-base on the card (bf16, 12 packed forward launches a frame), and
   one UKB eid of DICOM (SAX 10 slices x 50 frames of 208x210, LAX 2C, 3C
   and 4C, the manifest with its comma dates) through ``dicom_to_nifti``
   (``python -m``, in a process of its own started before phase 11: zlib at
   level 9 on the uncropped float32 volumes takes ~150 s of one core),
   ``scan_manifest`` and ``UKBCineDataset`` into one CineMA-base MAE forward
   on the card (12 + 8 launches); the seconds of each CLI a study and the
   phase's ``phase_s``;
14. distribution: the C++ NIfTI frame reader (built in step 2 with g++; the
   compiler and whether ``zlib.h`` was found printed; it must be the active
   reader) reads every frame of phase 5's 32 UKB studies and phase 10's two
   cines, each by a direct call of ``inflate_at`` or ``read_at``, byte-equal to
   the Python reader's bytes, ms a frame of each cine under each reader in
   turns, and the UKB loader alone (items/s) and five fed CineMA-base steps
   (ms, the wait) with 16 threads and 16 processes under each reader, in turns
   (A B B A); under the native reader ``CINEMA_TORCH_NATIVE=1``, so a read
   that it refuses fails the phase instead of falling back to Python.
   Then two gloo ranks on the card (NCCL puts no two ranks on one device;
   gloo takes the CUDA tensors where they lie) take an f32
   CineMA-base step at batch 2 under DDP (1 + 1 rows), tensor parallelism
   (``n_model=2``, the packed kernels at 384 and 256 wide) and FSDP, each held
   to this process's step on the whole batch (the f32 step gates), while
   ``pretrain.run`` and the regression ``run_train`` run with
   ``mesh.multiprocess=true`` in a one-rank NCCL group against the same runs
   without it (cuDNN deterministic in both; bit equality reported, the loss
   held to rtol 1e-5, launch counts equal).
15. last slice: a seeded 256x256 8-bit gray landmark image written by this
   script's PNG encoder as 8-bit and 4-bit palette PNGs (16 gray levels for
   the 4-bit one), Adam7-interlaced, and 16-bit RGB with each sample v * 257,
   each read by ``data.read_png_gray`` equal to its 8-bit original; a raw
   landmark tree of such images through ``landmark_preprocess`` (scale 1:
   each output equal to its original) into ``LandmarkDetectionDataset`` and
   one ConvUNetR-base heatmap forward on the card (12 packed forward
   launches); every run folder that a ``run_train`` of phases 8 to 11 wrote
   (checked where ``check_run_and_reload`` reads it): the JAX package's name
   ``%Y%m%d_%H%M%S-<three tags>``, its ``config.yaml`` read back equal to the
   run's config, a flat ``run.json`` with ``get_run_tags``' tags (phase 9's
   six M&Ms folders among them; phase 10's ``tasks.evaluate.main`` reads
   ``config.yaml``); and ``examples.cine_cmr.main`` with no ``--image``: the
   960x960 RGB PNG it writes equal to the picture rendered here, the slices
   drawn after the textured one with the outline colour at their projected
   corners.

Every f32 check step (phases 5-8 and 10) is also timed through the kernels
and through the plain attention, and its backward launches are counted apart
from its path's (the ``f32_steps`` line; ``f32_step_launches`` in the
kernels line): only those steps run the f32 backward.

The depthwise kernels' calls are counted on every path: serving, one forward
each depthwise convolution of a chunk; the timed steps of phases 5 to 11, one
forward, data gradient and weight gradient each depthwise convolution of a
step; the other paths' sums go to the kernels line.

Any failed check exits non-zero. The last two lines of stdout are the
kernels JSON line and ``{"ok": true, "device": {...}}``.

Usage:
    python3 chip_smoke.py [--out report.json] [--profile]

``--profile`` adds a torch.profiler pass over one serving chunk, one
pretraining step and one fed through ``device_prefetch``, one fine-tuning
step, one segmentation step, one landmark heatmap step, one fed M&Ms step,
one EMIDEC and one MyoPS2020 step and one UNet and one ResNet step and
prints the device time by kernel.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import json
import math
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W power limit): bf16 and TF32 on the tensor cores,
# f32 on the CUDA cores
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
# the f32 kernels, forward and backward, run their products as three TF32 passes on the tensor cores (split TF32),
# so their bound is three passes at the TF32 peak (one f32 pass on the CUDA cores is kept as ``bound_simt_ms``)
F32_PASSES = 3

# kernel vs plain version, largest abs error on the output:
# - f32: both sum in f32, in another order; exp2 against exp (a few ulp)
# - bf16: both round the output to bf16 once, and the kernel also rounds the
#   probabilities to bf16 before P.V. One bf16 ulp of x is at most x * 2^-7,
#   so the bound is two ulps of the largest output, 2^-6 * max|plain|. With
#   randn inputs at T=2305 the scores are ~N(0, 1) and each output averages
#   ~850 keys (|out| ~ 0.03, max < 0.5), so the bound is a few 1e-3 there.
ATOL_F32 = 1e-4
BF16_REL = 2.0**-6
# q is also scaled by this at the serving shape: scores ~N(0, 16) put most of
# a row's weight on a few keys, so outputs are O(1) and a skipped key tile or
# a softmax scale a few percent off moves them by far more than the bound
SHARP_Q = 4.0
# the row log-sum-exp (log2 domain, |values| up to a few tens with sharp
# scores) against torch.logsumexp: f32 on both sides, bf16 inputs are exact
# in f32, so only the summation order and exp2/log2 against exp/log differ
LSE_ATOL = 1e-3
# f32 ConvUNetR-base logits, kernel attention against the plain attention:
# per-call differences of ~1e-6 carried through 12 blocks and the decoder
LOGITS_ATOL = 1e-3
# one f32 CineMA-base step at batch 2, kernels against the plain attention
# (torch autograd through it): the loss is a mean of O(1) squares, compared
# relatively; each parameter's gradient is compared to the largest gradient
# entry of that parameter, the per-call differences of ~1e-6 being carried
# through 20 blocks forward and back
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-3
# f32 UNet and ResNet logits, the card (cuDNN, TF32 off) against the CPU from the same weights: the two sum
# each convolution in another order (~1e-6 relative), carried through 20-40 layers; against the largest logit
BASELINE_LOGITS_RTOL = 1e-4
# the ResNet's f32 train-mode gradient, the card's against the CPU's float64 one: within this factor of the CPU's
# own float32 gradient's largest distance from its float64 one (each relative to a parameter's largest entry)
RESNET_F32_WITNESS_FACTOR = 2.0


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def median_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of one call, by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, n: int = 20, warmup: int = 2) -> float:
    """Device time of one call: CUDA events around ``n`` calls issued back to back, divided by ``n``. The
    device first sleeps (``torch.cuda._sleep``) while the host enqueues the calls, so that the host's time
    is hidden even where it is the longer, as at small shapes; the sleep doubles until the host has
    enqueued every call before the device wakes."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 20_000_000  # ~10 ms at the H100's clocks
    for _ in range(6):
        slept, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        slept.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        end.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        if enqueue_ms < slept.elapsed_time(start):
            return start.elapsed_time(end) / n
        cycles *= 2
    fail(f"the device woke before the host had enqueued {n} calls ({enqueue_ms:.1f} ms)")


def timings(row: dict, kernel, plain, library, bound: tuple[float, str]) -> None:
    """A kernel's times at one shape into ``row``: per call (``ms``, host included), on the device alone
    (``device_ms``), the plain version's, the library call's (per call and on the device alone), the bound
    and its shares of both of the kernel's times."""
    row["ms"] = median_ms(kernel)
    row["device_ms"] = device_ms(kernel)
    row["plain_ms"] = median_ms(plain, reps=5)
    row["library_ms"] = median_ms(library)
    row["library_device_ms"] = device_ms(library)
    row["bound_ms"], row["bound_by"] = bound
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["device_bound_share"] = row["bound_ms"] / row["device_ms"]


def flop_s(flop: float, dtype: torch.dtype, simt: bool = False) -> float:
    """Seconds of a kernel's ``flop`` at the card's peak: bf16 on the tensor cores; f32 as the kernels' three
    TF32 passes on the tensor cores, or with ``simt`` as one f32 pass on the CUDA cores (the kernels'
    earlier design, kept as ``bound_simt_ms``)."""
    if dtype == torch.float32 and not simt:
        return F32_PASSES * flop / PEAK_TF32
    return flop / PEAK_FLOPS[dtype]


# The depthwise 5^nd convolution of the conv stems at the main paths' shapes: (label, (batch, chans, *spatial),
# memory layout, passes). ConvUNetR-base fine-tuning (batch 4) and serving (a chunk of 8) at both SAX stem
# levels, channels_last; CineMA-base pretraining (batch 16), SAX as the sparse stem's densified image hands it
# over ((batch, z, x, y, chans) in memory) and LAX channels_last; f32 as the f32 evaluation and check steps
# run it
DEPTHWISE_SHAPES = (
    ("finetune", (4, 64, 48, 48, 16), "channels_last", torch.bfloat16, ("fwd", "dgrad", "wgrad")),
    ("finetune", (4, 128, 24, 24, 16), "channels_last", torch.bfloat16, ("fwd", "dgrad", "wgrad")),
    ("serve", (8, 64, 48, 48, 16), "channels_last", torch.bfloat16, ("fwd",)),
    ("serve", (8, 128, 24, 24, 16), "channels_last", torch.bfloat16, ("fwd",)),
    ("pretrain_sax", (16, 64, 48, 48, 16), "densified", torch.bfloat16, ("fwd", "dgrad", "wgrad")),
    ("pretrain_sax", (16, 128, 24, 24, 16), "densified", torch.bfloat16, ("fwd", "dgrad", "wgrad")),
    ("pretrain_lax", (16, 64, 64, 64), "channels_last", torch.bfloat16, ("fwd", "dgrad", "wgrad")),
    ("pretrain_lax", (16, 128, 32, 32), "channels_last", torch.bfloat16, ("fwd", "dgrad", "wgrad")),
    ("f32", (4, 64, 48, 48, 16), "channels_last", torch.float32, ("fwd", "dgrad", "wgrad")),
    ("f32", (4, 64, 64, 64), "channels_last", torch.float32, ("fwd", "dgrad", "wgrad")),
)
# kernel against the plain version in f32 from the same inputs (cuDNN, TF32 off), largest error relative to the
# largest reference entry: the bf16 forward and data gradient round each output once (half an ulp, 2^-9), so
# 2^-8 leaves room for the f32 sums' order; a skipped tap moves outputs by ~1/sqrt(125) of their scale. The f32
# ones and the weight gradient (f32 out; sums of up to 16 * 48 * 48 * 16 terms, in another order) 1e-5 and 1e-4
DEPTHWISE_REL = {torch.bfloat16: 2.0**-8, torch.float32: 1e-5}
DEPTHWISE_WGRAD_REL = 1e-4


DEPTHWISE_COUNTERS = ("depthwise.launches", "depthwise.dgrad_launches", "depthwise.wgrad_launches")


def depthwise_blocks(model) -> int:
    """The model's depthwise convolutions (MaskedConvBlock.dw_conv), over every view's stem."""
    from cinema_tpu_torch.models.layers import DepthwiseConv2d, DepthwiseConv3d

    return sum(isinstance(m, (DepthwiseConv2d, DepthwiseConv3d)) for m in model.modules())


def _depthwise_operand(shape: tuple, layout: str, dtype: torch.dtype, gen: torch.Generator) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    if layout == "densified":  # (batch, z, x, y, chans) in memory
        return x.permute(0, 4, 2, 3, 1).contiguous().permute(0, 4, 2, 3, 1)
    return x.contiguous(memory_format=torch.channels_last_3d if x.ndim == 5 else torch.channels_last)


def depthwise_bound_ms(shape: tuple, dtype: torch.dtype) -> tuple[float, str]:
    """The card's least time for one pass: 125 (or 25) FMAs an output on the CUDA cores' f32 rate, or two
    tensors of ``shape`` (in and out; the weight gradient's x and g) moved once at 3.35 TB/s, whichever is
    larger."""
    numel = math.prod(shape)
    taps = 5 ** (len(shape) - 2)
    simt_ms = 2 * taps * numel / PEAK_FLOPS[torch.float32] * 1e3
    bytes_ms = 2 * numel * torch.finfo(dtype).bits / 8 / PEAK_BYTES * 1e3
    return (simt_ms, "simt") if simt_ms >= bytes_ms else (bytes_ms, "bytes")


def check_depthwise_shapes(gen: torch.Generator) -> dict[str, list[dict]]:
    """The depthwise kernels (forward, data gradient, weight gradient) against their plain versions at the main
    paths' shapes, with each one's device time, bound and share, the plain version's time and, as a yardstick
    the port never calls, cuDNN's (``library_ms``: F.conv{2,3}d and its two gradients). The weight gradient is
    also called twice and must be bit-identical."""
    from torch.nn import functional as F

    from cinema_tpu_torch import trace
    from cinema_tpu_torch.ops import depthwise_conv as dc

    rows: dict[str, list[dict]] = {"fwd": [], "dgrad": [], "wgrad": []}
    for label, shape, layout, dtype, passes in DEPTHWISE_SHAPES:
        nd, chans = len(shape) - 2, shape[1]
        x, g = (_depthwise_operand(shape, layout, dtype, gen) for _ in range(2))
        w = torch.randn((chans, 1, *(5,) * nd), generator=gen, device="cuda") * 0.2
        b = torch.randn((chans,), generator=gen, device="cuda")
        wd, bd = w.to(dtype), b.to(dtype)
        conv = F.conv2d if nd == 2 else F.conv3d
        common = {"label": label, "shape": list(shape), "layout": layout, "dtype": str(dtype).split(".")[-1]}

        def library_bwd(mask):
            return lambda: torch.ops.aten.convolution_backward(g, x, wd, None, [1] * nd, [2] * nd, [1] * nd, False,
                                                               [0] * nd, chans, mask)

        # pass -> (kernel, plain version on the same operands, plain version in f32 as the reference, cuDNN)
        calls = {
            "fwd": (lambda: dc.depthwise_conv_forward(x, w, b), lambda: dc.depthwise_conv_plain(x, w, b),
                    lambda: dc.depthwise_conv_plain(x.float(), wd.float(), bd.float()),
                    lambda: conv(x, wd, bd, padding=2, groups=chans)),
            "dgrad": (lambda: dc.depthwise_conv_dgrad(g, w), lambda: dc.depthwise_conv_dgrad_plain(g, w),
                      lambda: dc.depthwise_conv_dgrad_plain(g.float(), wd.float()), library_bwd([True, False, False])),
            "wgrad": (lambda: dc.depthwise_conv_wgrad(x, g), lambda: dc.depthwise_conv_wgrad_plain(x, g),
                      lambda: dc.depthwise_conv_wgrad_plain(x.float(), g.float()), library_bwd([False, True, True])),
        }
        for name in passes:
            kernel, plain, reference, library = calls[name]
            counter = DEPTHWISE_COUNTERS[("fwd", "dgrad", "wgrad").index(name)]
            before = trace.counter(counter)
            got = kernel()
            got = got if isinstance(got, tuple) else (got,)
            if name == "wgrad":
                check(all(torch.equal(a, c) for a, c in zip(got, kernel())),
                      f"the depthwise weight gradient at {shape} differs between two calls")
            launches = trace.counter(counter) - before
            check(launches == (2 if name == "wgrad" else 1), f"depthwise {name} counted {launches} calls")
            want = reference()
            want = want if isinstance(want, tuple) else (want,)
            abs_errs = [(a.float() - c).abs().max().item() for a, c in zip(got, want)]
            errs = [e / c.abs().max().item() for e, c in zip(abs_errs, want)]
            gate = DEPTHWISE_WGRAD_REL if name == "wgrad" else DEPTHWISE_REL[dtype]
            row = {**common, "max_abs_err": max(abs_errs), "rel_errs": errs, "rel_gate": gate}
            check(all(e <= gate for e in errs), f"depthwise {name} at {shape} {dtype} differs by {errs} (gate {gate})")
            row["ms"] = median_ms(kernel)
            row["device_ms"] = device_ms(kernel)
            row["plain_ms"] = median_ms(plain, reps=3, warmup=1)
            row["library_ms"] = median_ms(library)
            # cuDNN's gradients take tens of ms of host time a call: fewer calls, so the device's sleep
            # outlasts their enqueueing
            row["library_device_ms"] = device_ms(library, n=5)
            row["bound_ms"], row["bound_by"] = depthwise_bound_ms(shape, dtype)
            row["bound_share"] = row["bound_ms"] / row["ms"]
            row["device_bound_share"] = row["bound_ms"] / row["device_ms"]
            rows[name].append(row)
            print(f"depthwise_{name}", json.dumps(row), flush=True)
    return rows


def attention_bound_ms(batch: int, n_q: int, n_k: int, embed: int, dtype: torch.dtype,
                       simt: bool = False) -> tuple[float, str]:
    """Least time on an H100 for packed attention: 4*B*Tq*Tk*E flop (q.k^T and
    P.v, see flop_s) against q, k, v read once and the output written once."""
    op_s = flop_s(4 * batch * n_q * n_k * embed, dtype, simt)
    byte_s = (2 * batch * n_q * embed + 2 * batch * n_k * embed) * torch.finfo(dtype).bits / 8 / PEAK_BYTES
    return max(op_s, byte_s) * 1e3, ("operations" if op_s >= byte_s else "bytes")


def _attention_inputs(batch, n_q, n_k, embed, dtype, gen, q_scale):
    q = (torch.randn(batch, n_q, embed, device="cuda", generator=gen) * q_scale).to(dtype)
    kv = torch.randn(batch, n_k, 2 * embed, device="cuda", generator=gen).to(dtype)
    # k, v: column slices of the fused kv projection, as the model passes them
    return q, kv[..., :embed], kv[..., embed:]


def check_attention(batch, n_q, n_k, embed, n_heads, dtype, gen, timed, q_scale=1.0):
    """Forward kernel against its plain version: the output and the saved row log-sum-exp."""
    from cinema_tpu_torch.ops import flash_attention as fa

    q, k, v = _attention_inputs(batch, n_q, n_k, embed, dtype, gen, q_scale)
    out = fa.flash_attention_packed(q, k, v, n_heads)
    out_lse, lse = fa.flash_attention_packed_forward(q, k, v, n_heads, save_lse=True)
    torch.cuda.synchronize()
    want = fa.flash_attention_packed_plain(q, k, v, n_heads)
    check(out.dtype == dtype and out.shape == q.shape, f"kernel output {out.dtype} {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "kernel output is not finite")
    check(torch.equal(out, out_lse), "the forward output changes when the log-sum-exp is saved")
    err = (out.float() - want.float()).abs().max().item()
    want_max = want.float().abs().max().item()
    tol = ATOL_F32 if dtype == torch.float32 else BF16_REL * want_max
    lse_err = (lse - fa.flash_attention_packed_lse_plain(q, k, n_heads)).abs().max().item()
    row = {"shape": [batch, n_q, n_k, embed, n_heads], "dtype": str(dtype).split(".")[-1], "q_scale": q_scale,
           "max_abs_err": err, "tol": tol, "max_abs_plain": want_max, "lse_err": lse_err, "lse_tol": LSE_ATOL}
    if timed:
        d = embed // n_heads
        qh, kh, vh = (x.unflatten(-1, (n_heads, d)).transpose(1, 2) for x in (q, k, v))
        timings(row, lambda: fa.flash_attention_packed(q, k, v, n_heads),
                lambda: fa.flash_attention_packed_plain(q, k, v, n_heads),
                lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh),
                attention_bound_ms(batch, n_q, n_k, embed, dtype))
        if dtype == torch.float32:
            row["bound_simt_ms"] = attention_bound_ms(batch, n_q, n_k, embed, dtype, simt=True)[0]
    print("attention", json.dumps(row), flush=True)
    check(err <= tol, f"kernel disagrees with the plain version at {row}")
    check(lse_err <= LSE_ATOL, f"saved log-sum-exp disagrees with the plain one at {row}")
    return row


def attention_bwd_bound_ms(batch: int, n_q: int, n_k: int, embed: int, dtype: torch.dtype,
                           simt: bool = False) -> tuple[float, str]:
    """Least time on an H100 for the packed attention backward: five products,
    10*B*Tq*Tk*E flop (see flop_s), against q, k, v, o, g read once and dq, dk, dv written once."""
    op_s = flop_s(10 * batch * n_q * n_k * embed, dtype, simt)
    byte_s = (4 * batch * n_q * embed + 4 * batch * n_k * embed) * torch.finfo(dtype).bits / 8 / PEAK_BYTES
    return max(op_s, byte_s) * 1e3, ("operations" if op_s >= byte_s else "bytes")


def check_attention_bwd(batch, n_q, n_k, embed, n_heads, dtype, gen, timed, q_scale=1.0, low_scores=False):
    """Backward kernel against flash_attention_packed_bwd_plain on the same q, k, v, out, g; with
    ``low_scores`` every score near -LOW_SCORES (log2 domain)."""
    from cinema_tpu_torch.ops import flash_attention as fa

    q, k, v = _attention_inputs(batch, n_q, n_k, embed, dtype, gen, q_scale)
    if low_scores:
        _scores_near_minus_low(q.unflatten(-1, (n_heads, -1)), k.unflatten(-1, (n_heads, -1)))
    g = torch.randn(batch, n_q, embed, device="cuda", generator=gen).to(dtype)
    out, lse = fa.flash_attention_packed_forward(q, k, v, n_heads, save_lse=True)
    check(not low_scores or lse.max().item() < -128, f"a row's log-sum-exp is {lse.max().item()}, not below -128")
    got = fa.flash_attention_packed_backward(q, k, v, out, lse, g, n_heads)
    torch.cuda.synchronize()
    want = fa.flash_attention_packed_bwd_plain(q, k, v, out, g, n_heads)
    row = {"shape": [batch, n_q, n_k, embed, n_heads], "dtype": str(dtype).split(".")[-1], "q_scale": q_scale,
           "low_scores": low_scores}
    worst = 0.0
    for name, x, w, ref in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        check(x.dtype == dtype and x.shape == ref.shape, f"{name} is {x.dtype} {tuple(x.shape)}")
        check(bool(torch.isfinite(x).all()), f"{name} is not finite at {row}")
        w_max = w.float().abs().max().item()
        err = (x.float() - w.float()).abs().max().item()
        # f32: relative to the largest gradient once that exceeds 1. bf16: as the forward, with the f32
        # tolerance as a floor: with one key P = 1 and dS = P * (dP - delta) = 0 exactly, so dq and dk
        # are zero and what both sides hold is the f32 rounding of dP - delta (~1e-6)
        tol = ATOL_F32 * max(1.0, w_max) if dtype == torch.float32 else max(BF16_REL * w_max, ATOL_F32)
        row[name] = {"max_abs_err": err, "tol": tol, "max_abs_plain": w_max}
        worst = max(worst, err)
    row["max_abs_err"] = worst
    again = fa.flash_attention_packed_backward(q, k, v, out, lse, g, n_heads)
    check(all(torch.equal(a, b) for a, b in zip(got, again)), f"the backward changes from run to run at {row}")
    if timed:
        d = embed // n_heads
        # the library's backward alone: autograd.grad on a saved graph of one SDPA call
        qh, kh, vh = (x.unflatten(-1, (n_heads, d)).transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        gh = g.unflatten(-1, (n_heads, d)).transpose(1, 2)
        sdpa = torch.nn.functional.scaled_dot_product_attention(qh, kh, vh)
        timings(row, lambda: fa.flash_attention_packed_backward(q, k, v, out, lse, g, n_heads),
                lambda: fa.flash_attention_packed_bwd_plain(q, k, v, out, g, n_heads),
                lambda: torch.autograd.grad(sdpa, (qh, kh, vh), gh, retain_graph=True),
                attention_bwd_bound_ms(batch, n_q, n_k, embed, dtype))
        if dtype == torch.float32:
            row["bound_simt_ms"] = attention_bwd_bound_ms(batch, n_q, n_k, embed, dtype, simt=True)[0]
        # the passes apart, through the same entry point: each call also runs the delta pre-pass
        dq, dk, dv = got
        row["dkdv_ms"] = median_ms(lambda: fa._launch_bwd(q, k, v, out, lse, g, n_heads, None, dk, dv))
        row["dq_ms"] = median_ms(lambda: fa._launch_bwd(q, k, v, out, lse, g, n_heads, dq, None, None))
        row["delta_ms"] = median_ms(lambda: fa._launch_bwd(q, k, v, out, lse, g, n_heads, None, None, None))
    print("attention_bwd", json.dumps(row), flush=True)
    for name in ("dq", "dk", "dv"):
        check(row[name]["max_abs_err"] <= row[name]["tol"], f"backward kernel's {name} disagrees with the plain "
                                                           f"version at {row}")
    return row


# (batch, n_q, n_k, embed, n_heads) of the two attention calls of a CineMA-base pretraining step
TRAIN_ENCODER = (16, 769, 769, 768, 12)
TRAIN_DECODER = (16, 2305, 768, 512, 16)
# the attention call of default ConvViT-base: a fine-tuning micro-batch and an evaluation study
FINETUNE_PACKED = (4, 2305, 2305, 768, 12)
EVAL_PACKED = (1, 2305, 2305, 768, 12)
RAGGED = [(2, 1, 1, 768, 12), (2, 127, 127, 768, 12), (2, 129, 129, 768, 12), (2, 129, 200, 512, 16)]
# A key past n_k has a zero row of k, so its score is 0 and, unmasked, its P = exp2(0 - lse) overflows once
# every real score of the row is below -128 (log2 domain): the f32 dq pass masks such keys on its last stage.
# One ragged f32 backward check of each layout runs with every score near -LOW_SCORES to show that mask.
LOW_SCORES = 160.0


def _scores_near_minus_low(q, k) -> None:
    """In place, on (..., heads, head_dim) views: the last column of every head of q set to -LOW_SCORES /
    (head_dim^-0.5 * log2 e) and that of k to 1, which puts every score, log2 domain, near -LOW_SCORES."""
    d = q.shape[-1]
    q[..., d - 1] = -LOW_SCORES / (d**-0.5 * 1.4426950408889634)
    k[..., d - 1] = 1.0
# the landmark paths' attention: a 256x256 lax_2c image, patch 4 and two x2 stem levels give a 16x16 grid,
# 256 tokens + cls = 2 * 128 + 1 (two full q tiles and a one-row tail); a training micro-batch or a
# four-patch evaluation, and a one-patch evaluation
LANDMARK_PACKED = (4, 257, 257, 768, 12)
LANDMARK_EVAL = (1, 257, 257, 768, 12)
# the cine phase's training micro-batches: an EMIDEC patch of 96x96x8 gives a 6x6x8 grid, 288 tokens + cls =
# 2 * 128 + 33; a MyoPS2020 patch of 192x192x4 a 12x12x4 grid, 576 + 1 = 4 * 128 + 65 (other q-tile tails
# than the 257 / 769 / 2305 of the other paths)
EMIDEC_PACKED = (4, 289, 289, 768, 12)
MYOPS_PACKED = (4, 577, 577, 768, 12)


def check_attention_shapes(gen, timed=True) -> list[dict]:
    """The forward kernel against its plain version at the paths' shapes (the landmark, EMIDEC and MyoPS2020
    shapes with sharp scores too) and at ragged and cross-attention shapes, bf16 then f32; the first row is
    the serving shape."""
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        rows.append(check_attention(8, 2305, 2305, 768, 12, dtype, gen, timed))  # serving chunk
        rows.append(check_attention(8, 2305, 2305, 768, 12, dtype, gen, False, q_scale=SHARP_Q))
        rows.append(check_attention(2, 2305, 2305, 768, 12, dtype, gen, timed))  # sliding window
        rows.append(check_attention(*TRAIN_ENCODER, dtype, gen, timed))
        rows.append(check_attention(*TRAIN_DECODER, dtype, gen, timed))
        rows.append(check_attention(*FINETUNE_PACKED, dtype, gen, timed))
        rows.append(check_attention(*EVAL_PACKED, dtype, gen, timed))
        rows.append(check_attention(*LANDMARK_PACKED, dtype, gen, timed))
        rows.append(check_attention(*LANDMARK_EVAL, dtype, gen, timed))
        rows.append(check_attention(*LANDMARK_PACKED, dtype, gen, False, q_scale=SHARP_Q))
        for shape in (EMIDEC_PACKED, MYOPS_PACKED):
            rows.append(check_attention(*shape, dtype, gen, timed))
            rows.append(check_attention(*shape, dtype, gen, False, q_scale=SHARP_Q))
        for shape in RAGGED:
            rows.append(check_attention(*shape, dtype, gen, False))
    return rows


def check_attention_bwd_shapes(gen, timed=True) -> list[dict]:
    """The backward kernel against its plain version at the two pretraining shapes (the first two
    rows), the fine-tuning, landmark, EMIDEC and MyoPS2020 shapes, with sharp scores, and at ragged and
    cross shapes; bf16 then f32, and an f32 ragged shape with every score near -LOW_SCORES."""
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        rows.append(check_attention_bwd(*TRAIN_ENCODER, dtype, gen, timed))
        rows.append(check_attention_bwd(*TRAIN_DECODER, dtype, gen, timed))
        rows.append(check_attention_bwd(*FINETUNE_PACKED, dtype, gen, timed))
        rows.append(check_attention_bwd(*TRAIN_ENCODER, dtype, gen, False, q_scale=SHARP_Q))
        rows.append(check_attention_bwd(*TRAIN_DECODER, dtype, gen, False, q_scale=SHARP_Q))
        rows.append(check_attention_bwd(*LANDMARK_PACKED, dtype, gen, timed))
        rows.append(check_attention_bwd(*LANDMARK_PACKED, dtype, gen, False, q_scale=SHARP_Q))
        for shape in (EMIDEC_PACKED, MYOPS_PACKED):
            rows.append(check_attention_bwd(*shape, dtype, gen, timed))
            rows.append(check_attention_bwd(*shape, dtype, gen, False, q_scale=SHARP_Q))
        for shape in RAGGED:
            rows.append(check_attention_bwd(*shape, dtype, gen, False))
    rows.append(check_attention_bwd(*RAGGED[2], torch.float32, gen, False, low_scores=True))
    return rows


# (batch, n_q, n_k, heads, head_dim) of the per-head attention calls of ConvViT-base with rotary:
# a fine-tuning micro-batch and an evaluation study
FINETUNE_HEADS = (4, 2305, 2305, 12, 64)
EVAL_HEADS = (1, 2305, 2305, 12, 64)
# ragged and cross shapes: (shape, layout); "bhtd" reads (batch, heads, tokens, head_dim) storage through
# transposed views, "mixed" only k and v, so that q's strides differ from theirs
HEADS_RAGGED = [((2, 129, 200, 16, 32), "kvhalf"), ((2, 130, 77, 12, 64), "bhtd"), ((2, 130, 77, 12, 64), "mixed"),
                ((2, 1, 1, 12, 64), "kvhalf"), ((2, 127, 127, 12, 64), "kvhalf")]


def _heads_inputs(batch, n_q, n_k, heads, d, dtype, gen, q_scale, layout):
    """q, k fresh tensors; v the strided v half of a fused kv projection, as the model's per-head path passes it."""
    q = (torch.randn(batch, n_q, heads, d, device="cuda", generator=gen) * q_scale).to(dtype)
    k = torch.randn(batch, n_k, heads, d, device="cuda", generator=gen).to(dtype)
    if layout == "kvhalf":
        v = torch.randn(batch, n_k, 2, heads, d, device="cuda", generator=gen).to(dtype)[:, :, 1]
    else:
        k = k.transpose(1, 2).contiguous().transpose(1, 2)
        v = torch.randn(batch, heads, n_k, d, device="cuda", generator=gen).to(dtype).transpose(1, 2)
        if layout == "bhtd":
            q = q.transpose(1, 2).contiguous().transpose(1, 2)
    return q, k, v


def heads_bound_ms(batch, n_q, n_k, heads, d, dtype, products: int, simt: bool = False) -> tuple[float, str]:
    """Least time on an H100 for per-head attention: ``products`` matrix products of 2*B*Tq*Tk*H*D flop
    (2 forward, 5 backward; see flop_s) against each operand read once and each result written once (forward
    q, k, v, out; backward also g, dq, dk, dv)."""
    op_s = flop_s(products * 2 * batch * n_q * n_k * heads * d, dtype, simt)
    n_tensors = 2 if products == 2 else 4  # tensors of q's size, and as many of k's size
    byte_s = n_tensors * batch * (n_q + n_k) * heads * d * torch.finfo(dtype).bits / 8 / PEAK_BYTES
    return max(op_s, byte_s) * 1e3, ("operations" if op_s >= byte_s else "bytes")


def check_heads(batch, n_q, n_k, heads, d, dtype, gen, timed, q_scale=1.0, layout="kvhalf"):
    """Per-head forward kernel against its plain version: the output and the saved row log-sum-exp."""
    from cinema_tpu_torch.ops import flash_attention as fa

    q, k, v = _heads_inputs(batch, n_q, n_k, heads, d, dtype, gen, q_scale, layout)
    out = fa.flash_attention(q, k, v)
    out_lse, lse = fa.flash_attention_forward(q, k, v, save_lse=True)
    torch.cuda.synchronize()
    want = fa.flash_attention_plain(q, k, v)
    check(out.dtype == dtype and out.shape == q.shape and out.is_contiguous(), f"kernel output {out.dtype} {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "per-head kernel output is not finite")
    check(torch.equal(out, out_lse), "the per-head forward output changes when the log-sum-exp is saved")
    err = (out.float() - want.float()).abs().max().item()
    want_max = want.float().abs().max().item()
    tol = ATOL_F32 if dtype == torch.float32 else BF16_REL * want_max
    lse_err = (lse - fa.flash_attention_lse_plain(q, k)).abs().max().item()
    row = {"shape": [batch, n_q, n_k, heads, d], "dtype": str(dtype).split(".")[-1], "q_scale": q_scale,
           "layout": layout, "v_strides": list(v.stride()), "max_abs_err": err, "tol": tol,
           "max_abs_plain": want_max, "lse_err": lse_err, "lse_tol": LSE_ATOL}
    if timed:
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        timings(row, lambda: fa.flash_attention(q, k, v), lambda: fa.flash_attention_plain(q, k, v),
                lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh),
                heads_bound_ms(batch, n_q, n_k, heads, d, dtype, products=2))
        if dtype == torch.float32:
            row["bound_simt_ms"] = heads_bound_ms(batch, n_q, n_k, heads, d, dtype, products=2, simt=True)[0]
    print("heads_attention", json.dumps(row), flush=True)
    check(err <= tol, f"per-head kernel disagrees with the plain version at {row}")
    check(lse_err <= LSE_ATOL, f"per-head saved log-sum-exp disagrees with the plain one at {row}")
    return row


def check_heads_bwd(batch, n_q, n_k, heads, d, dtype, gen, timed, q_scale=1.0, layout="kvhalf", low_scores=False):
    """Per-head backward kernel against flash_attention_bwd_plain on the same q, k, v, out, g; with
    ``low_scores`` every score near -LOW_SCORES (log2 domain)."""
    from cinema_tpu_torch.ops import flash_attention as fa

    q, k, v = _heads_inputs(batch, n_q, n_k, heads, d, dtype, gen, q_scale, layout)
    if low_scores:
        _scores_near_minus_low(q, k)
    g = torch.randn(batch, n_q, heads, d, device="cuda", generator=gen).to(dtype)
    out, lse = fa.flash_attention_forward(q, k, v, save_lse=True)
    check(not low_scores or lse.max().item() < -128, f"a row's log-sum-exp is {lse.max().item()}, not below -128")
    got = fa.flash_attention_backward(q, k, v, out, lse, g)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_plain(q, k, v, out, g)
    row = {"shape": [batch, n_q, n_k, heads, d], "dtype": str(dtype).split(".")[-1], "q_scale": q_scale,
           "layout": layout, "low_scores": low_scores, "dv_strides": list(got[2].stride())}
    if layout == "kvhalf":  # dv lands in the v half of a buffer shaped like the fused kv projection
        check(got[2].stride() == v.stride(), f"dv strides {got[2].stride()} are not those of v {v.stride()}")
    worst = 0.0
    for name, x, w, ref in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        check(x.dtype == dtype and x.shape == ref.shape, f"{name} is {x.dtype} {tuple(x.shape)}")
        check(bool(torch.isfinite(x).all()), f"{name} is not finite at {row}")
        w_max = w.float().abs().max().item()
        err = (x.float() - w.float()).abs().max().item()
        # the tolerances of the packed backward, see check_attention_bwd
        tol = ATOL_F32 * max(1.0, w_max) if dtype == torch.float32 else max(BF16_REL * w_max, ATOL_F32)
        row[name] = {"max_abs_err": err, "tol": tol, "max_abs_plain": w_max}
        worst = max(worst, err)
    row["max_abs_err"] = worst
    again = fa.flash_attention_backward(q, k, v, out, lse, g)
    check(all(torch.equal(a, b) for a, b in zip(got, again)), f"the per-head backward changes from run to run at {row}")
    if timed:
        qh, kh, vh = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention(qh, kh, vh)
        gh = g.transpose(1, 2)
        timings(row, lambda: fa.flash_attention_backward(q, k, v, out, lse, g),
                lambda: fa.flash_attention_bwd_plain(q, k, v, out, g),
                lambda: torch.autograd.grad(sdpa, (qh, kh, vh), gh, retain_graph=True),
                heads_bound_ms(batch, n_q, n_k, heads, d, dtype, products=5))
        if dtype == torch.float32:
            row["bound_simt_ms"] = heads_bound_ms(batch, n_q, n_k, heads, d, dtype, products=5, simt=True)[0]
        # the passes apart, as check_attention_bwd
        dq, dk, dv = got
        row["dkdv_ms"] = median_ms(lambda: fa._launch_heads_bwd(q, k, v, out, lse, g, None, dk, dv))
        row["dq_ms"] = median_ms(lambda: fa._launch_heads_bwd(q, k, v, out, lse, g, dq, None, None))
        row["delta_ms"] = median_ms(lambda: fa._launch_heads_bwd(q, k, v, out, lse, g, None, None, None))
    print("heads_attention_bwd", json.dumps(row), flush=True)
    for name in ("dq", "dk", "dv"):
        check(row[name]["max_abs_err"] <= row[name]["tol"], f"per-head backward kernel's {name} disagrees with the "
                                                           f"plain version at {row}")
    return row


def check_heads_shapes(gen, timed=True) -> tuple[list[dict], list[dict]]:
    """The per-head kernels against their plain versions at the fine-tuning and evaluation shapes
    (the first rows), with sharp scores, and at ragged, cross and transposed shapes; bf16 then f32, and the
    backward at an f32 ragged shape with every score near -LOW_SCORES."""
    fwd, bwd = [], []
    for dtype in (torch.bfloat16, torch.float32):
        for rows, fn in ((fwd, check_heads), (bwd, check_heads_bwd)):
            rows.append(fn(*FINETUNE_HEADS, dtype, gen, timed))
            rows.append(fn(*EVAL_HEADS, dtype, gen, timed))
            rows.append(fn(*FINETUNE_HEADS, dtype, gen, False, q_scale=SHARP_Q))
            for shape, layout in HEADS_RAGGED:
                rows.append(fn(*shape, dtype, gen, False, layout=layout))
    shape, layout = HEADS_RAGGED[1]
    bwd.append(check_heads_bwd(*shape, torch.float32, gen, False, layout=layout, low_scores=True))
    return fwd, bwd


def check_kv_gradient(gen) -> dict:
    """The gradient of the fused kv projection on the per-head path: ``split_kv`` hands on the buffer
    that already holds dv and copies dk into it; autograd's own slicing zero-fills and adds two
    buffers of kv's size. Both must give the same bits; both are timed (forward + backward)."""
    from cinema_tpu_torch.ops import flash_attention as fa

    batch, n, heads, d = FINETUNE_HEADS[0], FINETUNE_HEADS[1], FINETUNE_HEADS[3], FINETUNE_HEADS[4]
    q = torch.randn(batch, n, heads, d, device="cuda", generator=gen).bfloat16().requires_grad_()
    kv = torch.randn(batch, n, 2 * heads * d, device="cuda", generator=gen).bfloat16().requires_grad_()

    def run(split: bool):
        if split:
            k, v = fa.split_kv(kv, heads)
        else:
            kv5 = kv.unflatten(-1, (2, heads, d))
            k, v = kv5[:, :, 0], kv5[:, :, 1]
        out = fa.flash_attention(q, k * 1.0, v)  # k changed per head, as qk-norm and rotary change it
        return torch.autograd.grad(out.float().square().mean(), (q, kv))

    reused = fa.split_kv.reused
    a, b = run(True), run(False)
    check(fa.split_kv.reused == reused + 1, "split_kv did not take over the buffer that held dv")
    check(all(torch.equal(x, y) for x, y in zip(a, b)), "split_kv's gradient differs from autograd's slicing")
    row = {"shape": list(FINETUNE_HEADS), "split_kv_ms": median_ms(lambda: run(True)),
           "autograd_slicing_ms": median_ms(lambda: run(False))}
    print("kv_gradient", json.dumps(row), flush=True)
    return row


ROOT = Path(__file__).resolve().parent
# the JAX package's config of the serving model: a data file, read by the port's YAML reader
ACDC_YAML = ROOT / "cinema_tpu" / "configs" / "segmentation" / "acdc.yaml"
# a run folder's config.yaml as the JAX package's writer (yaml.safe_dump) leaves it, of a tiny ConvUNetR
SEG_SAX_FIXTURE = ROOT / "tests" / "fixtures" / "example_ckpts" / "seg_sax-0be5929fde2c"


def serve_from_yaml(model, rng: torch.Generator, smi: str) -> dict:
    """``python -m cinema_tpu_torch.serve --config`` with the JAX package's acdc.yaml, in a process of its own on
    the card, with ``model``'s weights: its labels of a few frames against this process's ``segment_cine``. And
    ``load_run`` on a run folder of the tiny fixture as the JAX package's writer left it (config.yaml)."""
    from cinema_tpu_torch.config import PACKAGED, load_config
    from cinema_tpu_torch.convert import save_safetensors
    from cinema_tpu_torch.serve import segment_cine
    from cinema_tpu_torch.tasks import evaluate

    check(load_config(ACDC_YAML) == PACKAGED["segmentation/acdc"], f"{ACDC_YAML} reads as another config")
    x, y, z = model.image_size_dict["sax"]
    video = (torch.rand((x, y, z, 8), generator=rng) * 1000).numpy()
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        save_safetensors(d / "model.safetensors", {k: v.float().cpu().numpy() for k, v in model.state_dict().items()})
        np.save(d / "video.npy", video)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "cinema_tpu_torch.serve", "--config", str(ACDC_YAML), "--model",
                               str(d / "model.safetensors"), "--video", str(d / "video.npy"), "--out",
                               str(d / "labels.npy"), "--device", "cuda"], cwd=ROOT, capture_output=True, text=True,
                              timeout=600)
        seconds = time.perf_counter() - t0
        check(proc.returncode == 0, f"serve --config exited {proc.returncode}: {proc.stderr[-3000:]}")
        labels = np.load(d / "labels.npy")
        check(labels.shape == video.shape and labels.dtype == np.uint8, f"served labels {labels.shape} {labels.dtype}")
        agree = float((labels == segment_cine(model, video)).mean())
        # the same bf16 weights and kernels in two processes; cuDNN may pick other convolution algorithms there
        check(agree >= 0.999, f"serve --config labels agree with this process's on {agree:.6f} of the voxels")

        run = d / "jax_run"
        run.mkdir()
        (run / "config.yaml").write_bytes(next(SEG_SAX_FIXTURE.glob("*.yaml")).read_bytes())
        (run / "model_0.safetensors").write_bytes(next(SEG_SAX_FIXTURE.glob("*.safetensors")).read_bytes())
        config, tiny = evaluate.load_run(run, device="cuda")
        check(config.model.convunetr.size == "tiny" and next(tiny.parameters()).is_cuda,
              "load_run of a JAX-written config.yaml")
    out = {"frames": video.shape[-1], "seconds": seconds, "label_agreement": agree,
           "load_run_jax_config": {"size": config.model.convunetr.size, "parameters": sum(p.numel() for p in tiny.parameters())}}
    print("serve_yaml", json.dumps(out), f"on {smi}", flush=True)
    return out


def serve_phase(report: dict, smi: str, rng: torch.Generator, profile: bool) -> tuple[int, int]:
    """ConvUNetR-base serving at full width; returns the forward launches of the serving run."""
    from cinema_tpu_torch.config import PACKAGED, from_dict
    from cinema_tpu_torch.factory import get_convunetr_model, init_weights
    from cinema_tpu_torch.inference import sliding_window_forward
    from cinema_tpu_torch.models import vit
    from cinema_tpu_torch import trace
    from cinema_tpu_torch.ops.flash_attention import flash_attention_packed_kv, flash_attention_packed_kv_plain
    from cinema_tpu_torch.serve import segment_cine

    config = from_dict(PACKAGED["segmentation/acdc"])
    model = init_weights(get_convunetr_model(config, dtype=torch.bfloat16, device="cuda"), seed=0)
    x, y, z = model.image_size_dict["sax"]
    n_frames, chunk = 50, 8
    video = (torch.rand((x, y, z, n_frames), generator=rng) * 1000).numpy()
    segment_cine(model, video[..., :chunk], chunk)  # warm-up, one chunk
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    trace.reset("attention.packed.launches", "depthwise.launches")
    t0 = time.perf_counter()
    labels = segment_cine(model, video, chunk)
    serve_s = time.perf_counter() - t0
    serve_launches = trace.counter("attention.packed.launches")
    n_chunks = -(-n_frames // chunk)
    expected = len(model.encoder.blocks) * n_chunks
    print(f"serve: {n_frames} frames of {(x, y, z)}, {serve_launches} kernel launches "
          f"(expected {expected})", flush=True)
    check(serve_launches == expected, f"serving launched the kernel {serve_launches} times, expected {expected}")
    # the SAX stem's depthwise convolutions: two levels of two blocks, one forward launch each a chunk
    dw_expected = depthwise_blocks(model) * n_chunks
    counted = trace.counter("depthwise.launches")
    check(depthwise_blocks(model) == 4 and counted == dw_expected,
          f"serving launched the depthwise kernel {counted} times, expected {dw_expected}")
    check(labels.shape == video.shape and labels.dtype.name == "uint8", f"labels {labels.shape} {labels.dtype}")
    check(int(labels.max()) < config.model.out_chans, "labels out of range")
    repeats = []
    for _ in range(2):
        t0 = time.perf_counter()
        segment_cine(model, video, chunk)
        repeats.append(time.perf_counter() - t0)
    study_s = statistics.median([serve_s, *repeats])
    report["serve"] = {
        "frames": n_frames, "chunk": chunk, "launches": serve_launches, "depthwise_launches": counted,
        "seconds": [serve_s, *repeats],
        "ms_per_study": study_s * 1e3, "frames_per_s": n_frames / study_s,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    print("serve", json.dumps(report["serve"]), f"on {smi}", flush=True)

    study = torch.rand((1, x, y, 24, 1), generator=rng).cuda()
    with torch.no_grad():
        sliding_window_forward(model, {"sax": study}, {"sax": (x, y, z)})  # warm-up
        torch.cuda.synchronize()
        trace.reset("attention.packed.launches")
        t0 = time.perf_counter()
        logp = sliding_window_forward(model, {"sax": study}, {"sax": (x, y, z)})["sax"]
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    window_launches = trace.counter("attention.packed.launches")
    check(window_launches == len(model.encoder.blocks), f"sliding window launched {window_launches} times")
    check(logp.shape == (1, x, y, 24, config.model.out_chans) and bool(torch.isfinite(logp).all()),
          f"sliding window output {tuple(logp.shape)} not finite or mis-shaped")
    check(bool(torch.allclose(logp.exp().sum(-1), torch.ones(()), atol=1e-4)), "window probabilities do not sum to 1")
    report["window"] = {"image": [x, y, 24], "launches": window_launches, "ms": window_s * 1e3}
    print("window", json.dumps(report["window"]), f"on {smi}", flush=True)

    # one chunk in f32: kernel attention against the plain attention, same weights
    model32 = get_convunetr_model(config, dtype=torch.float32, device="cuda")
    model32.load_state_dict(model.state_dict())
    frames = torch.rand((chunk, x, y, z, 1), generator=rng).cuda()
    with torch.no_grad():
        got = model32({"sax": frames})["sax"]
        vit.flash_attention_packed_kv = flash_attention_packed_kv_plain
        try:
            want = model32({"sax": frames})["sax"]
        finally:
            vit.flash_attention_packed_kv = flash_attention_packed_kv
    logits_err = (got - want).abs().max().item()
    report["logits_f32"] = {"max_abs_err": logits_err, "atol": LOGITS_ATOL, "max_abs": want.abs().max().item()}
    print("logits_f32", json.dumps(report["logits_f32"]), flush=True)
    check(bool(torch.isfinite(got).all()), "f32 logits are not finite")
    check(logits_err <= LOGITS_ATOL, f"f32 logits through the kernel differ by {logits_err}")
    if profile:
        with torch.no_grad():
            report["profile"] = profile_call(
                "profile", lambda: model.predict_labels({"sax": frames.to(torch.bfloat16)}), smi
            )
    report["serve_yaml"] = serve_from_yaml(model, rng, smi)
    return serve_launches, counted


# UKB cines hold 50 frames; 10 keep the writing of the synthetic studies short, and a frame seek reads one
# frame's gzip member whatever their number
UKB_FRAMES = 10
# the loader's and the fed steps' epoch lists the synthetic studies this many times (16 batches of 16)
UKB_REPEAT = 8


def write_ukb_studies(data_dir: Path, n: int, sizes: dict, n_frames: int, seed: int) -> list:
    """Seeded synthetic studies as the UKB preprocessing writes them (cinema_tpu/data/preprocess/ukb_dicom.py):
    ``<pid>/<pid>_<view>.nii.gz``, uint8, one gzip member per frame, ``sax`` (x, y, z, t) and the ``lax_*``
    views (x, y, 1, t); noise with a bright disc whose radius follows the frame. Eight threads write them
    (zlib works without the interpreter lock). Returns the pids."""
    from concurrent.futures import ThreadPoolExecutor

    from cinema_tpu_torch.data import save_nifti

    def write(i: int) -> str:
        rng = np.random.default_rng([seed, i])
        pid = f"{1000000 + i}_2"
        (data_dir / pid).mkdir()
        for view, size in sizes.items():
            shape = (*size, 1) if len(size) == 2 else tuple(size)
            image = rng.integers(0, 60, (*shape, n_frames), dtype=np.uint8)
            gx, gy = np.ogrid[: shape[0], : shape[1]]
            r2 = (gx - shape[0] / 2) ** 2 + (gy - shape[1] / 2) ** 2
            for t in range(n_frames):
                image[r2 < (20 + 2 * t) ** 2, ..., t] += 150
            save_nifti(data_dir / pid / f"{pid}_{view}.nii.gz", image, spacing=(1.0, 1.0, 10.0, 1.0),
                       frame_indexed=True)
        return pid

    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(write, range(n)))


def train_phase(report: dict, smi: str, profile: bool) -> tuple[int, int, list[int]]:
    """CineMA-base MAE pretraining at full width on synthetic UKB studies; returns the (forward, backward)
    launches of the path: ``pretrain.run``, the steps fed through ``device_prefetch`` and the timed steps, and
    the depthwise kernels' (forward, data gradient, weight gradient) calls in the timed steps."""
    import copy
    import itertools

    from cinema_tpu_torch.config import PACKAGED, from_dict
    from cinema_tpu_torch.convert import load_safetensors
    from cinema_tpu_torch.data import BatchLoader, UKBCineDataset, device_prefetch
    from cinema_tpu_torch.data.transforms import get_pretrain_transforms
    from cinema_tpu_torch.factory import get_mae_model, init_weights
    from cinema_tpu_torch.models import vit
    from cinema_tpu_torch import trace
    from cinema_tpu_torch.ops.flash_attention import flash_attention_packed_kv, flash_attention_packed_kv_plain
    from cinema_tpu_torch.ops.masking import random_patch_mask
    from cinema_tpu_torch.tasks import pretrain
    from cinema_tpu_torch.train.checkpoint import latest_checkpoint, load_checkpoint
    from cinema_tpu_torch.train.optim import build_optimizer
    from cinema_tpu_torch.train.state import TrainState, make_mae_train_step

    t_phase = time.perf_counter()
    cuda = torch.device("cuda")
    batch_size, n_studies, n_timed, n_fed = 16, 32, 6, 10
    config = from_dict(PACKAGED["mae"])
    config.grad_ckpt = False  # remat off: one forward launch per attention call
    config.train.batch_size = batch_size  # no accumulation: every step is an update
    config.train.n_epochs = 1
    views = list(config.model.views)
    sizes = {v: tuple(config.data.sax.patch_size if v == "sax" else config.data.lax.patch_size) for v in views}
    n_blocks = 12 + 8  # ViT-base encoder and decoder depth: attention calls per step
    n_workers = config.train.n_workers_per_device
    path_launches = [0, 0]

    def read_launches() -> tuple:
        got = (trace.counter("attention.packed.launches"), trace.counter("attention.packed.bwd_launches"))
        path_launches[0] += got[0]
        path_launches[1] += got[1]
        return got

    with tempfile.TemporaryDirectory() as tmp:
        data_dir = Path(tmp) / "ukb"
        data_dir.mkdir()
        t0 = time.perf_counter()
        pids = write_ukb_studies(data_dir, n_studies, sizes, UKB_FRAMES, seed=2)
        write_s = time.perf_counter() - t0
        config.data.dir = str(data_dir)
        config.logging.dir = str(Path(tmp) / "runs")

        # a. the entry point: the manifest, one epoch of two steps fed by its loader's worker processes,
        # checkpoint and export; then a second scan of the folder reads the manifest's cache
        trace.reset("attention.packed.launches", "attention.packed.bwd_launches")
        t0 = time.perf_counter()
        out_dir = pretrain.run(config, device="cuda")
        run_s = time.perf_counter() - t0
        steps = n_studies // batch_size
        run_launches = read_launches()
        check(run_launches == (n_blocks * steps, n_blocks * steps),
              f"pretrain.run launched {run_launches}, expected {n_blocks * steps} each way")
        cache = data_dir / f"manifest_pids_{'_'.join(sorted(views))}.json"
        check(cache.exists() and json.loads(cache.read_text()) == {"pids": pids, "n_dir_entries": n_studies},
              "pretrain.run did not write the manifest cache of its studies")
        written_ns = cache.stat().st_mtime_ns
        t0 = time.perf_counter()
        cached = pretrain.scan_manifest(data_dir, views)
        cached_ms = (time.perf_counter() - t0) * 1e3
        check(cached == pids and cache.stat().st_mtime_ns == written_ns,
              "a second scan did not take the studies from the manifest's cache")
        t0 = time.perf_counter()
        scanned = pretrain.scan_manifest(data_dir, views, rescan=True)
        scan_ms = (time.perf_counter() - t0) * 1e3
        check(scanned == pids, "a fresh scan lists other studies than the manifest's cache")
        record = json.loads((out_dir / "metrics.jsonl").read_text().splitlines()[-1])
        check(record["n_samples"] == n_studies and record["skipped_nan"] == 0, f"epoch record {record}")
        check(record["loss"] == record["loss"] and abs(record["loss"]) < 1e4, f"epoch loss {record['loss']}")
        ckpt = latest_checkpoint(out_dir)
        check(ckpt is not None and (out_dir / "cinema.safetensors").exists(),
              "checkpoint or cinema.safetensors missing")

        model = init_weights(get_mae_model(config, dtype=torch.bfloat16, device="cuda"), seed=config.seed)
        initial = {k: v.clone() for k, v in model.state_dict().items()}
        # a slow warm-up, as the packaged config's ten epochs of it: seeded random weights stay well conditioned
        tx = build_optimizer(dict(model.named_parameters()), lr=config.train.lr, min_lr=config.train.min_lr,
                             warmup_steps=100, max_n_steps=1000, betas=tuple(config.train.betas),
                             weight_decay=config.train.weight_decay, clip_grad=config.train.clip_grad)
        state = load_checkpoint(ckpt, TrainState.create(model, tx))
        check(state.step == steps and state.n_samples == n_studies and int(state.opt_state.count) == steps,
              f"reloaded counters {state.step} {state.n_samples} {int(state.opt_state.count)}")
        exported = load_safetensors(out_dir / "cinema.safetensors")
        check(set(exported) == set(initial), "cinema.safetensors keys differ from the model's")
        check(all(torch.equal(torch.from_numpy(exported[k]).cuda(), v) for k, v in model.state_dict().items()),
              "cinema.safetensors differs from the checkpoint's parameters")
        moved = sum(not torch.equal(initial[k], v) for k, v in model.state_dict().items())
        check(moved == len(initial), f"only {moved} of {len(initial)} parameters moved in pretrain.run")
        report["pretrain_run"] = {"steps": steps, "seconds": run_s, "loss": record["loss"], "launches": run_launches,
                                  "ckpt_mib": ckpt.stat().st_size / 2**20, "write_s": write_s,
                                  "manifest_cached_ms": cached_ms, "manifest_scan_ms": scan_ms}
        print("pretrain_run", json.dumps(report["pretrain_run"]), f"on {smi}", flush=True)

        # b. the loader alone, as pretrain.run builds it, over an epoch of many batches: the 32 studies listed
        # UKB_REPEAT times (an item draws its frames and zoom from (seed, epoch, index), so no two items are
        # alike). The loader looks ahead depth * batch + workers items (48 here), more than an epoch of two
        # batches, and submits nothing of the next epoch until it is asked for, so short epochs would time
        # the epoch's cold start; a UKB epoch is thousands of batches. Two batches start the workers and fill
        # the look-ahead, the next ones are timed (four with a single thread, the rest of the epoch with the
        # workers); every mode gives the same batches
        dataset = UKBCineDataset(data_dir, pids * UKB_REPEAT, views, get_pretrain_transforms(config), seed=config.seed)
        n_long = len(dataset) // batch_size
        loader_rows, loaders, reference = {}, {}, None
        for mode, workers, processes in (("1_thread", 1, False), ("threads", n_workers, False),
                                         ("processes", n_workers, True)):
            loader = BatchLoader(dataset, batch_size, seed=config.seed, n_workers=workers, processes=processes)
            first = loader.epoch(0)
            t0 = time.perf_counter()
            batches = [next(first), next(first)]
            start_s = time.perf_counter() - t0
            n_batches = 4 if workers == 1 else n_long - 2
            t0 = time.perf_counter()
            batches += list(itertools.islice(first, n_batches))
            timed_s = time.perf_counter() - t0
            first.close()
            if workers == 1:
                loader.close()
            else:
                loaders[mode] = loader
            check(len(batches) == 2 + n_batches and all(batches[0][v].shape == (batch_size, *sizes[v], 1) for v in views),
                  f"{mode} loader batches {len(batches)}, {[batches[0][v].shape for v in views]}")
            if reference is None:
                reference = batches
            check(all(np.array_equal(a[v], b[v]) for a, b in zip(reference, batches) for v in views),
                  f"the {mode} loader gave other batches than one thread")
            loader_rows[mode] = {"workers": workers, "host_cpus": len(os.sched_getaffinity(0)),
                                 "epoch_batches": n_long, "start_s": start_s, "batches_timed": n_batches,
                                 "ms_per_batch": timed_s * 1e3 / n_batches, "items_per_s": n_batches * batch_size / timed_s}
            print("pretrain_loader", mode, json.dumps(loader_rows[mode]), f"on {smi}", flush=True)
        report["pretrain_loader"] = loader_rows
        del batches

        # c. steps fed through device_prefetch inside one long epoch, from the worker processes (as pretrain.run
        # feeds them on a host of more than 4 cores) and from the threads; no synchronisation between steps,
        # the wait is the time blocked on the next batch on the card. A warm-up step takes the epoch's first
        # batch; each batch on the card equals the loader's
        step_fn = make_mae_train_step(model, tx, config.train.enc_mask_ratio, seed=config.seed)
        report["train_fed"] = {}
        for epoch, mode in enumerate(("processes", "threads"), start=1):
            host = []

            def recorded(loader, epoch=epoch, host=host):
                for b in loader.epoch(epoch):
                    host.append(b)
                    yield b

            with loaders[mode] as loader:
                fed_iter = device_prefetch(recorded(loader), cuda, depth=2)
                on_card = [next(fed_iter)]
                state, _ = step_fn(state, on_card[0])  # warm-up
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                trace.reset("attention.packed.launches", "attention.packed.bwd_launches")
                waits, losses = [], []
                t0 = time.perf_counter()
                for _ in range(n_fed):
                    w0 = time.perf_counter()
                    on_card.append(next(fed_iter))
                    waits.append(time.perf_counter() - w0)
                    state, metrics = step_fn(state, on_card[-1])
                    losses.append(metrics["loss"])
                torch.cuda.synchronize()
                fed_s = time.perf_counter() - t0
                fed_launches = read_launches()
                if profile and mode == "processes":  # a fed step's device time against its wall time
                    report["train_fed_profile"] = profile_call("train_fed_profile",
                                                               lambda: step_fn(state, next(fed_iter)), smi)
                fed_iter.close()
            losses = [float(x) for x in losses]
            check(fed_launches == (n_blocks * n_fed, n_blocks * n_fed),
                  f"{n_fed} fed steps launched {fed_launches}, expected {n_blocks} each way per step")
            check(all(x == x and abs(x) < 1e4 for x in losses), f"fed losses not finite: {losses}")
            check(all(torch.equal(d[v].cpu(), torch.from_numpy(h[v])) for d, h in zip(on_card, host) for v in views)
                  and set(on_card[0]) == set(views), f"a batch on the card differs from the {mode} loader's")
            report["train_fed"][mode] = {
                "batch": batch_size, "steps": n_fed, "workers": n_workers, "epoch_batches": n_long,
                "ms_per_step": fed_s * 1e3 / n_fed, "clips_per_s": n_fed * batch_size / fed_s,
                "loader_wait_ms_per_step": sum(waits) * 1e3 / n_fed, "loader_wait_ms": [w * 1e3 for w in waits],
                "losses": losses, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                "launches_fwd": fed_launches[0], "launches_bwd": fed_launches[1]}
            print("train_fed", mode, json.dumps(report["train_fed"][mode]), f"on {smi}", flush=True)
            del on_card, host
        batches = [{v: torch.from_numpy(b[v]).cuda() for v in views} for b in reference[:steps]]

    # d. the same steps with the batch already on the card, through make_mae_train_step
    done_before = state.step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trace.reset("attention.packed.launches", "attention.packed.bwd_launches", *DEPTHWISE_COUNTERS)
    losses, skipped, seconds = [], [], []
    for i in range(n_timed):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batches[i % len(batches)])
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        skipped.append(float(metrics["skipped_nan"]))
    fwd, bwd = read_launches()
    check(fwd == n_blocks * n_timed and bwd == n_blocks * n_timed,
          f"{n_timed} train steps launched {fwd} forward and {bwd} backward kernels, expected {n_blocks} each per step")
    # the four views' stems: two levels of two blocks each, one call of each depthwise kernel a block and step
    dw_blocks = depthwise_blocks(model)
    dw = [trace.counter(name) for name in DEPTHWISE_COUNTERS]
    check(dw_blocks == 4 * len(views) and dw == [dw_blocks * n_timed] * 3,
          f"{n_timed} train steps called the depthwise kernels {dw} times, expected {dw_blocks * n_timed} each")
    check(all(x == x and abs(x) < 1e4 for x in losses), f"losses not finite: {losses}")
    check(sum(skipped) == 0, f"steps skipped: {skipped}")
    done = done_before + n_timed
    check(state.step == done and state.n_samples == done * batch_size and int(state.opt_state.count) == done,
          f"counters {state.step} {state.n_samples} {int(state.opt_state.count)}, expected {done} steps")
    moved = sum(not torch.equal(before[k], v) for k, v in model.state_dict().items())
    check(moved == len(before), f"only {moved} of {len(before)} parameters moved in the timed steps")
    check(trace.counter("attention.packed.grad_copies") == 0, "the backward copied a gradient it should read "
          "in place")
    step_s = statistics.median(seconds)
    report["train"] = {
        "batch": batch_size, "steps": n_timed, "launches_fwd": fwd, "launches_bwd": bwd, "depthwise_launches": dw,
        "losses": losses,
        "seconds": seconds, "ms_per_step": step_s * 1e3, "clips_per_s": batch_size / step_s,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    print("train", json.dumps(report["train"]), f"on {smi}", flush=True)

    # e. a batch of NaNs leaves parameters, moments and count bit-identical
    snapshot = copy.deepcopy((model.state_dict(), state.opt_state.state_dict()))
    state, metrics = step_fn(state, {v: torch.full_like(x, float("nan")) for v, x in batches[0].items()})
    check(float(metrics["skipped_nan"]) == 1.0, "the NaN batch was not skipped")
    now = (model.state_dict(), state.opt_state.state_dict())
    same = all(torch.equal(a, b) for a, b in zip(snapshot[0].values(), now[0].values()))
    same &= torch.equal(snapshot[1]["count"], now[1]["count"])
    same &= all(torch.equal(a, b) for name in ("mu", "nu") for a, b in zip(snapshot[1][name], now[1][name]))
    check(same, "the NaN batch changed parameters, moments or count")
    check(state.step == done + 1, "the NaN batch did not advance the step counter")
    print("nan_guard: a NaN batch left parameters, moments and count bit-identical", flush=True)
    if profile:
        report["train_profile"] = profile_call("train_profile", lambda: step_fn(state, batches[0]), smi)
    del snapshot, now, before, initial, state, tx

    # f. one f32 step at batch 2: loss and gradients through the kernels against the plain attention
    model32 = get_mae_model(config, dtype=torch.float32, device="cuda")
    model32.load_state_dict(model.state_dict())
    del model
    small = {v: x[:2] for v, x in batches[1].items()}
    gen = torch.Generator(device="cuda").manual_seed(3)
    masks = {v: random_patch_mask(gen, 2, model32.enc_down_dict[v].n_patches, 0.75, "cuda") for v in small}
    params = list(model32.parameters())

    def loss_and_grads():
        loss = model32(small, 0.75, masks)[0]
        return loss.detach(), torch.autograd.grad(loss, params)

    before = trace.counter("attention.packed.bwd_launches")
    loss_k, grads_k = loss_and_grads()
    f32_bwd = trace.counter("attention.packed.bwd_launches") - before
    ms = f32_step_ms(loss_and_grads, lambda: None)
    vit.flash_attention_packed_kv = flash_attention_packed_kv_plain
    try:
        loss_p, grads_p = loss_and_grads()
        plain_ms = f32_step_ms(loss_and_grads, lambda: None)
    finally:
        vit.flash_attention_packed_kv = flash_attention_packed_kv
    F32_STEPS["train_f32"] = {"packed_bwd": f32_bwd, "heads_bwd": 0, "ms": ms, "plain_ms": plain_ms}
    check(f32_bwd > 0, "the f32 MAE step launched no backward kernel")
    norm_k, norm_p = (torch.linalg.vector_norm(torch.stack([g.norm() for g in gs])).item() for gs in (grads_k, grads_p))
    worst = max(((a - b).abs().max() / b.abs().max().clamp(min=1e-12)).item() for a, b in zip(grads_k, grads_p))
    report["train_f32"] = {"loss": loss_k.item(), "loss_plain": loss_p.item(), "grad_norm": norm_k,
                           "grad_norm_plain": norm_p, **F32_STEPS["train_f32"], "max_rel_grad_err": worst,
                           "loss_rtol": TRAIN_LOSS_RTOL, "grad_rtol": TRAIN_GRAD_RTOL}
    print("train_f32", json.dumps(report["train_f32"]), flush=True)
    check(abs(loss_k.item() - loss_p.item()) <= TRAIN_LOSS_RTOL * abs(loss_p.item()), "f32 losses differ")
    check(abs(norm_k - norm_p) <= TRAIN_GRAD_RTOL * norm_p, "f32 gradient norms differ")
    check(worst <= TRAIN_GRAD_RTOL, f"f32 gradients through the kernels differ by {worst} of a parameter's largest")
    report["train_phase"] = {"launches": path_launches, "phase_s": time.perf_counter() - t_phase}
    print("train_phase", json.dumps(report["train_phase"]), f"on {smi}", flush=True)
    return path_launches[0], path_launches[1], dw


def write_metadata(path: Path, rows: list[dict]) -> None:
    """A metadata table as the JAX preprocessing writes it (pandas' ``to_csv``: a header, an empty field where
    a value is missing)."""
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)


def write_edes_studies(data_dir: Path, n: int, size: tuple, seed: int) -> None:
    """Seeded synthetic ED + ES studies in the processed ACDC layout (``train/<pid>/<pid>_sax_{ed,es}.nii.gz``,
    uint8, and ``train_metadata.csv``): noise with one slab along z brightened by the class, ``pathology``
    the class of five, ``ef`` a target that follows it."""
    from cinema_tpu_torch.config import PACKAGED
    from cinema_tpu_torch.data import save_nifti

    classes = PACKAGED["classification/acdc"]["data"]["pathology"]
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        label = i % 5
        image = rng.random((*size, 2), dtype=np.float32) * 60
        image[:, :, 3 * label : 3 * label + 3] += 80 + 25 * label
        pid = f"patient{i:03d}"
        (data_dir / "train" / pid).mkdir(parents=True)
        for f, frame in enumerate(("ed", "es")):
            save_nifti(data_dir / "train" / pid / f"{pid}_sax_{frame}.nii.gz", image[..., f].astype(np.uint8),
                       spacing=(1.0, 1.0, 10.0))
        rows.append({"pid": pid, "n_slices": size[2], "pathology": classes[label],
                     "ef": round(float(20 + 8 * label + rng.normal()), 4)})
    write_metadata(data_dir / "train_metadata.csv", rows)


def _snapshot(model, state):
    return [t.clone() for t in (*model.state_dict().values(), *state.opt_state.mu, *state.opt_state.nu,
                                state.opt_state.count)]


def check_nan_batch(label: str, launches, model, state, step_fn, batch: dict, image_key: str):
    """A batch whose ``image_key`` is all NaN is skipped: parameters, moments and count stay bit-identical
    and the step counter advances. Returns the state."""
    snapshot = _snapshot(model, state)
    steps_before = state.step
    bad = dict(batch, **{image_key: torch.full_like(batch[image_key], float("nan"))})
    launches.reset()
    state, metrics = step_fn(state, bad)
    launches.read()
    check(float(metrics["skipped_nan"]) == 1.0, f"the NaN {label} batch was not skipped")
    check(all(torch.equal(a, b) for a, b in zip(snapshot, _snapshot(model, state))),
          f"the NaN {label} batch changed parameters, moments or count")
    check(state.step == steps_before + 1, "the NaN batch did not advance the step counter")
    print(f"{label}_nan_guard: a NaN batch left parameters, moments and count bit-identical", flush=True)
    return state


class Launches:
    """The launch counters of the packed and the per-head attention kernels and of the depthwise kernels:
    ``reset`` sets them to 0, ``read`` returns the attention's (packed fwd, packed bwd, per-head fwd, per-head
    bwd), keeps the depthwise (forward, data gradient, weight gradient) calls as ``depthwise`` and adds both to
    ``totals``, a path's sum."""

    COUNTERS = ("attention.packed.launches", "attention.packed.bwd_launches", "attention.heads.launches",
                "attention.heads.bwd_launches")

    def __init__(self) -> None:
        self.totals = {"packed_fwd": 0, "packed_bwd": 0, "heads_fwd": 0, "heads_bwd": 0,
                       "depthwise_fwd": 0, "depthwise_dgrad": 0, "depthwise_wgrad": 0}
        self.depthwise = (0, 0, 0)

    @staticmethod
    def reset() -> None:
        from cinema_tpu_torch import trace

        trace.reset(*Launches.COUNTERS, *DEPTHWISE_COUNTERS)

    def read(self) -> tuple:
        from cinema_tpu_torch import trace

        got = tuple(map(trace.counter, self.COUNTERS))
        self.depthwise = tuple(map(trace.counter, DEPTHWISE_COUNTERS))
        for key, n in zip(self.totals, got + self.depthwise):
            self.totals[key] += n
        return got


@contextlib.contextmanager
def swapped(module, name: str, value):
    """``module.name`` is ``value`` inside the block (the plain attention in place of a kernel's wrapper)."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def supervised_step(config, model, loss_fn) -> tuple:
    """A train state and ``make_supervised_train_step`` over ``model`` with the config's optimizer and a
    slow warm-up, as the packaged configs' warm-up epochs: seeded random weights stay well conditioned."""
    from cinema_tpu_torch.train.optim import build_optimizer
    from cinema_tpu_torch.train.state import TrainState, make_supervised_train_step

    tx = build_optimizer(dict(model.named_parameters()), lr=config.train.lr, min_lr=config.train.min_lr,
                         warmup_steps=100, max_n_steps=1000, betas=tuple(config.train.betas),
                         weight_decay=config.train.weight_decay, clip_grad=config.train.clip_grad)
    return TrainState.create(model, tx), make_supervised_train_step(model, tx, loss_fn, seed=0)


def timed_steps(launches: Launches, smi: str, label: str, model, state, step_fn, batches: list, n: int,
                expected: tuple, may_stay: frozenset = frozenset()) -> dict:
    """One warm-up and ``n`` timed steps (host clock to ``torch.cuda.synchronize()``) with their launches
    (``expected`` per step; each depthwise convolution's call one launch of each depthwise kernel), losses,
    skips and peak memory checked; every parameter but those of ``may_stay`` must move. ``state`` advances in
    place."""
    from cinema_tpu_torch.models.layers import DepthwiseConv2d, DepthwiseConv3d

    state, _ = step_fn(state, batches[0])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    dw_calls = []
    hooks = [m.register_forward_hook(lambda *_: dw_calls.append(1)) for m in model.modules()
             if isinstance(m, (DepthwiseConv2d, DepthwiseConv3d))]
    launches.reset()
    losses, skipped, seconds = [], [], []
    for i in range(n):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batches[(i + 1) % len(batches)])
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        skipped.append(float(metrics["skipped_nan"]))
    got = launches.read()
    for hook in hooks:
        hook.remove()
    check(got == tuple(n * x for x in expected),
          f"{n} {label} steps launched (packed fwd, packed bwd, per-head fwd, per-head bwd) = {got}, "
          f"expected {expected} per step")
    check(len(dw_calls) == n * len(hooks) and launches.depthwise == (len(dw_calls),) * 3,
          f"{n} {label} steps called the {len(hooks)} depthwise convolutions {len(dw_calls)} times and launched "
          f"the depthwise (forward, data gradient, weight gradient) kernels {launches.depthwise} times")
    check(all(x == x and abs(x) < 1e4 for x in losses), f"{label} losses not finite: {losses}")
    check(sum(skipped) == 0, f"{label} steps skipped: {skipped}")
    still = {k for k, v in model.state_dict().items() if torch.equal(before[k], v)}
    check(still <= may_stay, f"parameters {sorted(still)} did not move in the {label} steps")
    step_s = statistics.median(seconds)
    batch_size = batches[0][next(k for k in batches[0] if k.endswith("_image"))].shape[0]
    row = {"batch": batch_size, "steps": n, "launches": dict(zip(launches.totals, got + launches.depthwise)),
           "losses": losses,
           "seconds": seconds, "ms_per_step": step_s * 1e3, "samples_per_s": batch_size / step_s,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    print(label, json.dumps(row), f"on {smi}", flush=True)
    return row


# every f32 check step: its backward launches (packed, per-head), counted apart from the paths' totals they
# are part of, and its time through the kernels and through the plain attention
F32_STEPS: dict = {}


def f32_step_ms(loss_and_grads, reset) -> float:
    """Host-clock ms of one more call of an f32 step's ``loss_and_grads`` (to ``torch.cuda.synchronize()``),
    whose launches ``reset`` then drops: the checked call before it counted them."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_and_grads()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    reset()
    return ms


def check_f32_step(label: str, launches: Launches, model, loss_fn, batch: dict, plain_attention,
                   expected: tuple) -> dict:
    """One f32 step's loss and gradients through the kernels (``expected`` launches) against the same
    step inside ``plain_attention`` (a context that swaps the plain attention in; no launch): the loss
    within TRAIN_LOSS_RTOL, each parameter's gradient within TRAIN_GRAD_RTOL of its largest entry."""
    params = list(model.parameters())

    def loss_and_grads():
        loss = loss_fn(model, batch)[0]
        return loss.detach(), torch.autograd.grad(loss, params)

    launches.reset()
    loss_k, grads_k = loss_and_grads()
    check(launches.read() == expected, f"the {label} step did not go through the kernels")
    ms = f32_step_ms(loss_and_grads, launches.reset)
    with plain_attention:
        launches.reset()
        loss_p, grads_p = loss_and_grads()
        check(launches.read() == (0, 0, 0, 0), "the plain attention path launched a kernel")
        plain_ms = f32_step_ms(loss_and_grads, launches.reset)
    norm_k, norm_p = (torch.linalg.vector_norm(torch.stack([g.norm() for g in gs])).item()
                      for gs in (grads_k, grads_p))
    errs = [((a - b).abs().max() / b.abs().max().clamp(min=1e-12)).item() for a, b in zip(grads_k, grads_p)]
    worst = max(errs)
    worst_name = [name for name, _ in model.named_parameters()][errs.index(worst)]
    F32_STEPS[label] = {"packed_bwd": expected[1], "heads_bwd": expected[3], "ms": ms, "plain_ms": plain_ms}
    row = {"loss": loss_k.item(), "loss_plain": loss_p.item(), "grad_norm": norm_k, "grad_norm_plain": norm_p,
           **F32_STEPS[label], "max_rel_grad_err": worst, "worst_parameter": worst_name,
           "worst_parameter_max_grad": grads_p[errs.index(worst)].abs().max().item(),
           "loss_rtol": TRAIN_LOSS_RTOL, "grad_rtol": TRAIN_GRAD_RTOL}
    print(label, json.dumps(row), flush=True)
    check(abs(loss_k.item() - loss_p.item()) <= TRAIN_LOSS_RTOL * abs(loss_p.item()), f"{label}: losses differ")
    check(abs(norm_k - norm_p) <= TRAIN_GRAD_RTOL * norm_p, f"{label}: gradient norms differ")
    check(worst <= TRAIN_GRAD_RTOL, f"{label}: gradients through the kernels differ by {worst} of a "
                                    f"parameter's largest")
    return row


def finetune_phase(report: dict, smi: str, profile: bool) -> dict:
    """ConvViT-base fine-tuning and evaluation at full width; returns each kernel's launches on this path."""
    from cinema_tpu_torch.config import PACKAGED, from_dict
    from cinema_tpu_torch.convert import load_safetensors
    from cinema_tpu_torch.factory import get_convvit_model, init_weights
    from cinema_tpu_torch.ops import attention
    from cinema_tpu_torch import trace
    from cinema_tpu_torch.ops.flash_attention import flash_attention_plain
    from cinema_tpu_torch.tasks.classification import acdc as clf_acdc
    from cinema_tpu_torch.tasks.classification import classification_loss_fn
    from cinema_tpu_torch.tasks.regression import acdc as reg_acdc
    from cinema_tpu_torch.train.checkpoint import latest_checkpoint, load_checkpoint
    from cinema_tpu_torch.data import to_device

    launches = Launches()
    reset, read, counters = launches.reset, launches.read, launches.totals

    def rotary_model(config, dtype=torch.float32, device="cuda", **kwargs):
        """What a user passes as ``get_model_fn`` to train ConvViT with rotary embedding: no config key sets it."""
        return get_convvit_model(config, dtype=dtype, device=device, rotary=True, **kwargs)

    batch_size, n_studies, n_timed, depth = 4, 30, 6, 12
    config = from_dict(PACKAGED["classification/acdc"])
    config.grad_ckpt = False  # recomputation off: one forward launch per attention call
    config.train.batch_size = batch_size  # no accumulation: every step is an update
    size = tuple(config.data.sax.patch_size)

    def make_step(model):
        return supervised_step(config, model, classification_loss_fn)

    with tempfile.TemporaryDirectory() as tmp:
        data_dir = Path(tmp) / "studies"
        data_dir.mkdir()
        write_edes_studies(data_dir, n_studies, size, seed=4)
        config.data.dir = str(data_dir)
        train_ds, val_ds = clf_acdc.load_dataset(config)
        check((len(train_ds), len(val_ds)) == (n_studies - 10, 10), f"split {len(train_ds)} / {len(val_ds)}")
        from cinema_tpu_torch.data import BatchLoader

        batches = [to_device(b, torch.device("cuda")) for b in BatchLoader(train_ds, batch_size, seed=0).epoch(0)]
        check(batches[0]["sax_image"].shape == (batch_size, *size, 2), f"batch {tuple(batches[0]['sax_image'].shape)}")

        # a. the default model: the packed kernels, as users run it
        model = init_weights(get_convvit_model(config, dtype=torch.bfloat16, device="cuda"), seed=config.seed)
        state, step_fn = make_step(model)
        report["finetune_default"] = timed_steps(launches, smi, "finetune_default", model, state, step_fn, batches, 3,
                                                 (depth, depth, 0, 0))
        del state, step_fn

        # b. rotary=True through get_model_fn: the per-head kernels and no packed launch
        rotary = rotary_model(config, dtype=torch.bfloat16, device="cuda")
        rotary.load_state_dict(model.state_dict())
        del model
        state, step_fn = make_step(rotary)
        report["finetune_rotary"] = timed_steps(launches, smi, "finetune_rotary", rotary, state, step_fn, batches,
                                                n_timed, (0, 0, depth, depth))
        check(trace.counter("attention.heads.grad_copies") == 0,
              "the per-head backward copied a gradient it should read in place")

        # a NaN batch leaves parameters, moments and count bit-identical
        state = check_nan_batch("finetune", launches, rotary, state, step_fn, batches[0], "sax_image")
        if profile:
            reset()
            report["finetune_profile"] = profile_call("finetune_profile", lambda: step_fn(state, batches[0]), smi)
            read()
        del state, step_fn

        # the same step with the blocks recomputed in the backward pass: two forward launches per block
        remat = rotary_model(config, dtype=torch.bfloat16, device="cuda", remat=True)
        remat.load_state_dict(rotary.state_dict())
        state, step_fn = make_step(remat)
        report["finetune_rotary_remat"] = timed_steps(launches, smi, "finetune_rotary_remat", remat, state, step_fn,
                                                      batches, 2, (0, 0, 2 * depth, depth))
        del remat, state, step_fn

        # c. one f32 step at batch 2: loss and gradients through the per-head kernels against the plain attention
        rotary32 = rotary_model(config, dtype=torch.float32, device="cuda").train()
        rotary32.load_state_dict(rotary.state_dict())
        for module in rotary32.modules():  # no drop-path noise: both passes see the same network
            if hasattr(module, "rate"):
                module.rate = 0.0
        small = {k: v[:2] for k, v in batches[1].items()}
        report["finetune_f32"] = check_f32_step("finetune_f32", launches, rotary32, classification_loss_fn, small,
                                                swapped(attention, "flash_attention", flash_attention_plain),
                                                (0, 0, depth, depth))
        del rotary32, rotary

        # d. the entry point: a short run_train of the rotary model with an evaluation per epoch
        n_epochs = 3
        config.logging.dir = str(Path(tmp) / "runs")
        config.train.update(n_epochs=n_epochs, n_warmup_epochs=0, eval_interval=1, lr=1.0e-4)
        reset()
        t0 = time.perf_counter()
        out_dir = clf_acdc.run(config, device="cuda", get_model_fn=rotary_model)
        run_s = time.perf_counter() - t0
        got = read()
        steps = n_epochs * (len(train_ds) // batch_size)
        evals = n_epochs * len(val_ds)  # batch 1: one per-head forward launch per block and study
        check(got == (0, 0, depth * (steps + evals), depth * steps),
              f"run_train launched {got}, expected {depth} per-head forward launches per step and per evaluated "
              f"study and {depth} backward launches per step")
        records = [json.loads(line) for line in (out_dir / "metrics.jsonl").read_text().splitlines()]
        train_loss = [r["train_loss"] for r in records if "train_loss" in r]
        val = [r for r in records if "val_accuracy" in r]
        check(len(train_loss) == n_epochs and len(val) == n_epochs, f"metrics.jsonl holds {records}")
        check(all(x == x and abs(x) < 1e4 for x in train_loss), f"run_train losses not finite: {train_loss}")
        check(train_loss[-1] < train_loss[0], f"run_train's loss did not decrease: {train_loss}")
        check(all(0.0 <= r["val_accuracy"] <= 1.0 and r["val_entropy"] == r["val_entropy"] for r in val), f"{val}")
        ckpt = latest_checkpoint(out_dir)
        check(ckpt is not None and Path(f"{ckpt}.meta.json").exists(), "checkpoint or its sidecar missing")
        epoch = json.loads(Path(f"{ckpt}.meta.json").read_text())["epoch"]
        reloaded = rotary_model(config, dtype=torch.bfloat16, device="cuda")
        state, _ = make_step(reloaded)
        state = load_checkpoint(ckpt, state)
        check(state.step == (epoch + 1) * (len(train_ds) // batch_size), f"reloaded step counter {state.step}")
        exported = load_safetensors(out_dir / f"model_{epoch}.safetensors")
        check(set(exported) == set(reloaded.state_dict()), "model safetensors keys differ from the model's")
        check(all(torch.equal(torch.from_numpy(exported[k]).cuda(), v) for k, v in reloaded.state_dict().items()),
              "model safetensors differs from the checkpoint's parameters")
        report["finetune_run"] = {"epochs": n_epochs, "steps": steps, "evaluated_studies": evals, "seconds": run_s,
                                  "train_loss": train_loss, "val_accuracy": [r["val_accuracy"] for r in val],
                                  "launches": dict(zip(counters, got)), "saved_epoch": epoch}
        print("finetune_run", json.dumps(report["finetune_run"]), f"on {smi}", flush=True)
        del reloaded, state

        # e. the regression task, default model: one step and one evaluation of four studies
        reg = from_dict(PACKAGED["regression/acdc"])
        reg.grad_ckpt = False
        reg.data.dir = str(data_dir)
        reg.data.max_n_samples = 4
        reg.logging.dir = str(Path(tmp) / "runs_reg")
        reg.train.update(n_epochs=1, n_warmup_epochs=0, eval_interval=1, batch_size=4)
        reset()
        out_dir = reg_acdc.run(reg, device="cuda")
        got = read()
        check(got == (depth * (1 + 4), depth, 0, 0), f"the regression task launched {got}")
        records = [json.loads(line) for line in (out_dir / "metrics.jsonl").read_text().splitlines()]
        val = next(r for r in records if "val_mae" in r)
        check(val["val_mae"] == val["val_mae"] and abs(val["val_denormalised_mae"] - val["val_mae"] * reg.data.ef.std)
              <= 1e-6 * abs(val["val_denormalised_mae"]), f"regression evaluation {val}")
        check((out_dir / "model_0.safetensors").exists(), "the regression run saved no model")
        report["finetune_regression"] = {"train_loss": records[0]["train_loss"], "val_mae": val["val_mae"],
                                         "launches": dict(zip(counters, got))}
        print("finetune_regression", json.dumps(report["finetune_regression"]), f"on {smi}", flush=True)
    report["finetune_launches"] = counters
    return counters


# ACDC-like study sizes of the segmentation phase: an exact patch; wider than the patch in x and y
# (four patches) and padded in z; padded in z by the bucket of 4 to 20, then two patches along z
SEG_SIZES = [(192, 192, 16), (224, 208, 10), (200, 200, 18)]


def seg_frames(rng: np.random.Generator, size: tuple, scales: tuple = (1.0, 0.85)) -> tuple[np.ndarray, np.ndarray]:
    """(image, label) of one seeded synthetic study of ``size``, uint8 (x, y, z, len(scales)) each, the frames
    on the last axis (by default ED and ES): per frame three nested ellipsoid shells at a seeded centre and a
    radius times the frame's scale, the LV cavity (1) inside the myocardium (2) and the RV (3) beside it; the
    image brightens by class on noise."""
    axes = np.meshgrid(*(np.arange(s, dtype=np.float32) for s in size), indexing="ij")
    centre = np.array(size, np.float32) * (0.42 + rng.uniform(-0.04, 0.04, 3).astype(np.float32) * (1, 1, 0.2))
    radii = np.array(size, np.float32) * (rng.uniform(0.15, 0.2), rng.uniform(0.15, 0.2), 0.45)
    labels = []
    for frame_scale in scales:
        r = radii * frame_scale
        d_lv = np.sqrt(sum(((a - c) / s) ** 2 for a, c, s in zip(axes, centre, r)))
        rv_centre = centre + (1.3 * r[0], 0, 0)
        d_rv = np.sqrt(sum(((a - c) / s) ** 2 for a, c, s in zip(axes, rv_centre, r * (0.8, 1.2, 1.0))))
        label = np.zeros(size, np.uint8)
        label[d_rv < 1] = 3
        label[d_lv < 1] = 2
        label[d_lv < 0.6] = 1
        labels.append(label)
    label = np.stack(labels, axis=-1)
    image = np.array([30, 220, 110, 165], np.float32)[label] + rng.normal(0, 25, label.shape).astype(np.float32)
    return np.clip(image, 0, 255).astype(np.uint8), label


def write_seg_study(split_dir: Path, pid: str, image: np.ndarray, label: np.ndarray) -> None:
    """One study's ED and ES SAX frames and labels as the preprocessing writes them, under ``split_dir/pid``."""
    from cinema_tpu_torch.data import save_nifti

    (split_dir / pid).mkdir(parents=True)
    for f, frame in enumerate(("ed", "es")):
        save_nifti(split_dir / pid / f"{pid}_sax_{frame}.nii.gz", image[..., f], spacing=(1.0, 1.0, 10.0))
        save_nifti(split_dir / pid / f"{pid}_sax_{frame}_gt.nii.gz", label[..., f], spacing=(1.0, 1.0, 10.0))


def write_seg_studies(data_dir: Path, n: int, seed: int) -> None:
    """Seeded synthetic ED + ES segmentation studies in the processed ACDC layout (``seg_frames``), sizes in
    turn from SEG_SIZES, with ``train_metadata.csv`` (``pid``, ``n_slices``, ``pathology``)."""
    from cinema_tpu_torch.config import PACKAGED

    classes = PACKAGED["classification/acdc"]["data"]["pathology"]
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        size = SEG_SIZES[i % len(SEG_SIZES)]
        pid = f"patient{i:03d}"
        write_seg_study(data_dir / "train", pid, *seg_frames(rng, size))
        rows.append({"pid": pid, "n_slices": size[2], "pathology": classes[i % 5]})
    write_metadata(data_dir / "train_metadata.csv", rows)


def segmentation_phase(report: dict, smi: str, profile: bool) -> dict:
    """ConvUNetR-base segmentation fine-tuning and evaluation at full width; returns the packed kernels'
    launches on this path."""
    from cinema_tpu_torch import metrics as seg_metrics
    from cinema_tpu_torch.config import PACKAGED, from_dict
    from cinema_tpu_torch.convert import load_safetensors
    from cinema_tpu_torch.data import BatchLoader, to_device
    from cinema_tpu_torch.factory import get_convunetr_model, get_segmentation_model, init_weights
    from cinema_tpu_torch.models import vit
    from cinema_tpu_torch import trace
    from cinema_tpu_torch.ops.flash_attention import flash_attention_packed_kv_plain
    from cinema_tpu_torch.ops.window import crop_start, get_patch_grid
    from cinema_tpu_torch.tasks.segmentation import (
        acdc as seg_acdc,
        patch_and_spacing_dicts,
        segmentation_eval_batch,
        segmentation_loss_fn,
    )
    from cinema_tpu_torch.train.checkpoint import latest_checkpoint, load_checkpoint

    launches = Launches()
    reset, read, counters = launches.reset, launches.read, launches.totals
    # 4 studies of each of 5 pathologies: two of each held out leave 10 training studies, 20 frames, 5 steps
    # an epoch, and 20 validation frames, which cover every size of SEG_SIZES
    batch_size, n_studies = 4, 20
    config = from_dict(PACKAGED["segmentation/acdc"])  # grad_ckpt on, as the packaged config
    config.train.batch_size = batch_size  # no accumulation: every step is an update
    depth = 12
    patch_size_dict, spacing_dict = patch_and_spacing_dicts(config)
    cuda = torch.device("cuda")
    # the LayerNorm over the one-channel input image outputs its bias: its weight's gradient is zero
    # analytically and weight decay skips it, so it may stay where it is
    may_stay = frozenset({"dec_image_conv_block_dict.sax.norm1.weight"})

    def make_step(model):
        return supervised_step(config, model, segmentation_loss_fn)

    with tempfile.TemporaryDirectory() as tmp:
        data_dir = Path(tmp) / "studies"
        data_dir.mkdir()
        write_seg_studies(data_dir, n_studies, seed=5)
        config.data.dir = str(data_dir)
        train_ds, val_ds = seg_acdc.load_dataset(config)
        check((len(train_ds), len(val_ds)) == (2 * (n_studies - 10), 20), f"split {len(train_ds)} / {len(val_ds)}")
        val_sizes = {tuple(int(val_ds.load(i, 0)[k]) for k in ("sax_width", "sax_height", "n_slices"))
                     for i in range(0, len(val_ds), 2)}
        check(val_sizes == set(SEG_SIZES), f"validation sizes {val_sizes}, expected {SEG_SIZES}")
        batches = [to_device(b, cuda) for b in BatchLoader(train_ds, batch_size, seed=0).epoch(0)]
        check(batches[0]["sax_image"].shape == (batch_size, *patch_size_dict["sax"], 1)
              and batches[0]["sax_label"].shape == (batch_size, *patch_size_dict["sax"]),
              f"batch {tuple(batches[0]['sax_image'].shape)} {tuple(batches[0]['sax_label'].shape)}")

        # a. the packaged model, the ViT blocks recomputed in the backward pass (grad_ckpt)
        model = init_weights(get_segmentation_model(config, dtype=torch.bfloat16, device=cuda), seed=config.seed)
        check(model.encoder.remat, "grad_ckpt did not reach the encoder")
        state, step_fn = make_step(model)
        report["segmentation_remat"] = timed_steps(launches, smi, "segmentation_remat", model, state, step_fn, batches,
                                                   6, (2 * depth, depth, 0, 0), may_stay)
        check(trace.counter("attention.packed.grad_copies") == 0,
              "the packed backward copied a gradient it should read in place")

        # a NaN batch leaves parameters, moments and count bit-identical
        state = check_nan_batch("segmentation", launches, model, state, step_fn, batches[0], "sax_image")
        if profile:
            reset()
            report["segmentation_profile"] = profile_call("segmentation_profile", lambda: step_fn(state, batches[0]),
                                                          smi)
            read()
        del state, step_fn

        # b. the same model without recomputation: one forward launch per block
        plain = get_convunetr_model(config, dtype=torch.bfloat16, device=cuda, remat=False)
        plain.load_state_dict(model.state_dict())
        state, step_fn = make_step(plain)
        report["segmentation_plain"] = timed_steps(launches, smi, "segmentation_plain", plain, state, step_fn, batches,
                                                   2, (depth, depth, 0, 0), may_stay)
        del plain, state, step_fn

        # c. one f32 step at batch 2: loss and gradients through the packed kernels against the plain attention
        model32 = get_segmentation_model(config, dtype=torch.float32, device=cuda).train()
        model32.load_state_dict(model.state_dict())
        for module in model32.modules():  # no dropout or drop-path noise: both passes see the same network
            if hasattr(module, "rate"):
                module.rate = 0.0
        small = {k: v[:2] for k, v in batches[1].items()}
        report["segmentation_f32"] = check_f32_step("segmentation_f32", launches, model32, segmentation_loss_fn, small,
                                                    swapped(vit, "flash_attention_packed_kv",
                                                            flash_attention_packed_kv_plain),
                                                    (2 * depth, depth, 0, 0))
        del model32, model

        # d. the entry point: a short run_train with an evaluation per epoch
        n_epochs = 2
        config.logging.dir = str(Path(tmp) / "runs")
        config.train.update(n_epochs=n_epochs, eval_interval=1)
        reset()
        t0 = time.perf_counter()
        out_dir = seg_acdc.run(config, device="cuda")
        run_s = time.perf_counter() - t0
        got = read()
        steps = n_epochs * (len(train_ds) // batch_size)
        frames = n_epochs * len(val_ds)  # batch 1: one forward of all a frame's patches
        check(got == (2 * depth * steps + depth * frames, depth * steps, 0, 0),
              f"the segmentation run_train launched {got}, expected {2 * depth} packed forward and {depth} backward "
              f"launches per step and {depth} forward launches per evaluated frame")
        records = [json.loads(line) for line in (out_dir / "metrics.jsonl").read_text().splitlines()]
        train_loss = [r["train_loss"] for r in records if "train_loss" in r]
        val = [r for r in records if "val_mean_dice_score" in r]
        check(len(train_loss) == n_epochs and len(val) == n_epochs, f"metrics.jsonl holds {records}")
        check(all(x == x and abs(x) < 1e4 for x in train_loss), f"segmentation run_train losses not finite: {train_loss}")
        # every validation label holds every class, so Dice is defined; HD95 is NaN for a class the model
        # does not predict yet, which a short run from seeded weights decides, so it must only not be infinite
        dice_keys = ["val_mean_dice_score"] + [f"val_class_{c}_dice_score" for c in (1, 2, 3)]
        hd95_keys = ["val_mean_hausdorff_distance_95"] + [f"val_class_{c}_hausdorff_distance_95" for c in (1, 2, 3)]
        keys = dice_keys + hd95_keys
        check(all(k in r for r in val for k in keys), f"segmentation evaluation keys missing: {val}")
        check(all(0.0 <= r[k] <= 1.0 for r in val for k in dice_keys), f"segmentation Dice not in [0, 1]: {val}")
        check(all(np.isnan(r[k]) or 0.0 <= r[k] < np.inf for r in val for k in hd95_keys),
              f"segmentation HD95 infinite or negative: {val}")
        ckpt = latest_checkpoint(out_dir)
        check(ckpt is not None and Path(f"{ckpt}.meta.json").exists(), "checkpoint or its sidecar missing")
        epoch = json.loads(Path(f"{ckpt}.meta.json").read_text())["epoch"]
        reloaded = get_segmentation_model(config, dtype=torch.bfloat16, device=cuda)
        state, _ = make_step(reloaded)
        state = load_checkpoint(ckpt, state)
        check(state.step == (epoch + 1) * (len(train_ds) // batch_size), f"reloaded step counter {state.step}")
        exported = load_safetensors(out_dir / f"model_{epoch}.safetensors")
        check(set(exported) == set(reloaded.state_dict()), "model safetensors keys differ from the model's")
        check(all(torch.equal(torch.from_numpy(exported[k]).cuda(), v) for k, v in reloaded.state_dict().items()),
              "model safetensors differs from the checkpoint's parameters")
        report["segmentation_run"] = {
            "epochs": n_epochs, "steps": steps, "evaluated_frames": frames, "seconds": run_s, "train_loss": train_loss,
            **{k: [r[k] for r in val] for k in keys}, "launches": dict(zip(counters, got)), "saved_epoch": epoch}
        print("segmentation_run", json.dumps(report["segmentation_run"]), f"on {smi}", flush=True)

        # e. one evaluated study of each size, ED + ES, sliding window and metrics, with the run's saved
        # weights; HD95's host time apart
        hd95_s = []
        hausdorff_distance_95 = seg_metrics.hausdorff_distance_95

        def timed_hd95(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return hausdorff_distance_95(*args, **kwargs)
            finally:
                hd95_s.append(time.perf_counter() - t0)

        def evaluate_study(items: list) -> tuple:
            """Each frame's metrics row and its cropped log-probabilities, left on the card."""
            rows, logits = [], []
            for item in items:
                batch = {**item, **to_device({k: item[k] for k in ("sax_image", "sax_label")}, cuda)}
                logits_dict, row = segmentation_eval_batch(model, batch, patch_size_dict, spacing_dict, z_bucket=4)
                rows.append(row)
                logits.append(logits_dict["sax"])
            return rows, logits

        def check_metrics_on_the_host(size: tuple, items: list, rows: list, logits: list) -> None:
            """The card's metrics of each frame against segmentation_metrics of the same log-probabilities on
            the CPU (rtol 1e-6: the same argmax, counts exact in f32, the same host HD95); HD95 is finite for
            exactly the classes that both the prediction and the label hold."""
            for item, row, frame_logits in zip(items, rows, logits):
                host_logits = frame_logits.float().cpu()
                label = crop_start(torch.from_numpy(np.asarray(item["sax_label"])), host_logits.shape[:-1])
                want = {k: float(v[0]) for k, v in
                        seg_metrics.segmentation_metrics(host_logits, label, spacing_dict["sax"]).items()}
                check(set(want) == set(row) - {f"sax_{k}" for k in want}, f"{size} frame metric keys {sorted(row)}")
                differ = {k: (row[k], v) for k, v in want.items()
                          if not (np.isnan(v) and np.isnan(row[k]) or abs(row[k] - v) <= 1e-6 * abs(v) + 1e-9)}
                check(not differ, f"{size} frame metrics, card against CPU: {differ}")
                pred = host_logits.argmax(-1)
                for c in (1, 2, 3):
                    both = bool((pred == c).any()) and bool((label == c).any())
                    check(np.isfinite(row[f"class_{c}_hausdorff_distance_95"]) == both,
                          f"{size} frame: class {c} HD95 {row[f'class_{c}_hausdorff_distance_95']} where the "
                          f"prediction and the label {'both' if both else 'do not both'} hold the class")

        model = reloaded.eval()
        del state
        seg_metrics.hausdorff_distance_95 = timed_hd95
        evals = []
        try:
            with torch.no_grad():
                for size in SEG_SIZES:
                    first = next(i for i in range(0, len(val_ds), 2)
                                 if tuple(int(val_ds.load(i, 0)[k]) for k in ("sax_width", "sax_height", "n_slices")) == size)
                    items = [{k: v[None] for k, v in val_ds.load(i, 0).items() if k != "pid"}
                             for i in (first, first + 1)]  # ED, ES
                    evaluate_study(items)  # warm-up
                    torch.cuda.synchronize()
                    hd95_s.clear()
                    reset()
                    t0 = time.perf_counter()
                    rows, logits = evaluate_study(items)
                    study_s = time.perf_counter() - t0
                    got = read()
                    hd95_ms = sum(hd95_s) * 1e3
                    check_metrics_on_the_host(size, items, rows, logits)
                    check(got == (2 * depth, 0, 0, 0), f"an evaluated {size} study launched {got}, expected "
                                                        f"{depth} packed forward launches per frame")
                    check(all(np.isfinite(r["mean_dice_score"]) and 0.0 <= r["mean_dice_score"] <= 1.0 for r in rows),
                          f"evaluation of a {size} study: {rows}")
                    x, y, z = items[0]["sax_image"].shape[1:4]  # padded to the patch size, then z to the bucket
                    n_patches = len(get_patch_grid((x, y, max(patch_size_dict["sax"][2], -(-z // 4) * 4)), patch_size_dict["sax"],
                                                   [p // 2 for p in patch_size_dict["sax"]]))
                    evals.append({"size": list(size), "patches": n_patches, "launches": got[0],
                                  "ms_per_study": study_s * 1e3, "hd95_ms": hd95_ms,
                                  "mean_dice_score": [r["mean_dice_score"] for r in rows],
                                  "mean_hausdorff_distance_95": [r["mean_hausdorff_distance_95"] for r in rows]})
        finally:
            seg_metrics.hausdorff_distance_95 = hausdorff_distance_95
        report["segmentation_eval"] = evals
        print("segmentation_eval", json.dumps(evals), f"on {smi}", flush=True)
    keys = ("ms_per_step", "samples_per_s", "peak_mem_gib")
    report["segmentation"] = {
        "grad_ckpt": {k: report["segmentation_remat"][k] for k in keys},
        "no_grad_ckpt": {k: report["segmentation_plain"][k] for k in keys},
        "eval_ms_per_study": {"x".join(map(str, e["size"])): {"ms": e["ms_per_study"], "hd95_ms": e["hd95_ms"]}
                              for e in evals},
        "run_s": run_s,
    }
    print("segmentation", json.dumps(report["segmentation"]), f"on {smi}", flush=True)
    report["segmentation_launches"] = counters
    return counters


def write_landmark_data(root: Path, sizes: dict, seed: int) -> None:
    """Seeded synthetic landmark data in the JAX preprocessing's layout: ``lax_2c/images/<uid>.png`` and
    ``{train,val}_metadata.csv`` (uid, view, path, x1..y3); ``sizes[name]`` lists each image's (x, y) size.
    An image is uint8 noise with three bright discs at seeded landmark coordinates, an 8-bit gray PNG."""
    from cinema_tpu_torch import viz

    rng = np.random.default_rng(seed)
    (root / "lax_2c" / "images").mkdir(parents=True)
    for name, name_sizes in sizes.items():
        lines = ["uid,view,path,x1,y1,x2,y2,x3,y3"]
        for i, (w, h) in enumerate(name_sizes):
            coords = np.stack([rng.integers(16, w - 16, size=3), rng.integers(16, h - 16, size=3)], axis=-1)
            xx, yy = np.mgrid[:w, :h]
            image = rng.integers(0, 80, size=(w, h))
            for cx, cy in coords:
                image[(xx - cx) ** 2 + (yy - cy) ** 2 <= 16] = 230
            uid = f"{name}{i:03d}"
            viz.write_png(root / "lax_2c" / "images" / f"{uid}.png", image.T.astype(np.uint8))  # rows are y
            lines.append(",".join([uid, "lax_2c", f"lax_2c/images/{uid}.png", *map(str, coords.reshape(-1))]))
        (root / f"{name}_metadata.csv").write_text("\n".join(lines) + "\n")


def check_run_and_reload(label: str, config, out_dir: Path, make_model, make_step, steps_per_epoch: int,
                         images: dict, val_keys: tuple) -> dict:
    """A ``run``'s metrics (train losses finite; the validation metrics ``val_keys`` finite at every evaluation),
    its latest checkpoint reloaded into a train state (the step counter) and its safetensors into a second
    model: the two models' parameters and their outputs on ``images`` (view -> batch) equal."""
    from cinema_tpu_torch.convert import load_safetensors
    from cinema_tpu_torch.train.checkpoint import latest_checkpoint, load_checkpoint

    check_run_folder(label, config, out_dir)
    records = [json.loads(line) for line in (out_dir / "metrics.jsonl").read_text().splitlines()]
    train_loss = [r["train_loss"] for r in records if "train_loss" in r]
    val = [r for r in records if val_keys[0] in r]
    n_epochs = config.train.n_epochs
    check(len(train_loss) == n_epochs and len(val) == n_epochs, f"{label} metrics.jsonl holds {records}")
    check(all(x == x and abs(x) < 1e6 for x in train_loss), f"{label} run losses not finite: {train_loss}")
    check(all(np.isfinite(r[k]) for r in val for k in val_keys), f"{label} evaluation not finite: {val}")
    ckpt = latest_checkpoint(out_dir)
    check(ckpt is not None and Path(f"{ckpt}.meta.json").exists(), f"{label} checkpoint or its sidecar missing")
    epoch = json.loads(Path(f"{ckpt}.meta.json").read_text())["epoch"]
    reloaded = make_model()
    state, _ = make_step(reloaded)
    state = load_checkpoint(ckpt, state)
    check(state.step == (epoch + 1) * steps_per_epoch, f"{label} reloaded step counter {state.step}")
    exported = load_safetensors(out_dir / f"model_{epoch}.safetensors")
    again = make_model()
    check(set(exported) == set(again.state_dict()), f"{label} model safetensors keys differ from the model's")
    again.load_state_dict({k: torch.from_numpy(v) for k, v in exported.items()})
    check(all(torch.equal(a, b) for a, b in zip(reloaded.state_dict().values(), again.state_dict().values())),
          f"{label} model safetensors differs from the checkpoint's parameters")
    with torch.no_grad():
        outs = [m.eval()(images) for m in (reloaded, again)]
    outs = [torch.cat(list(o.values())) if isinstance(o, dict) else o for o in outs]
    check(torch.equal(outs[0], outs[1]), f"{label}: the checkpoint and the safetensors give other outputs")
    return {"epochs": n_epochs, "train_loss": train_loss, **{k: [r[k] for r in val] for k in val_keys},
            "saved_epoch": epoch}


# the run folders checked by check_run_folder: label -> what was found
RUN_FOLDERS: dict = {}


def check_run_folder(label: str, config, out_dir: Path) -> None:
    """A folder that ``run_train`` wrote is the JAX package's (cinema_tpu/log.py:89-120, train/loop.py:290):
    named ``%Y%m%d_%H%M%S-`` and the first three of ``get_run_tags``, its ``config.yaml`` read back as the
    run's config (the batch sizes as ``run_train`` may have halved them), and its ``run.json`` holding those
    tags and the config flattened."""
    import re

    from cinema_tpu_torch.config import load_config
    from cinema_tpu_torch.log import flatten_dict, get_run_tags

    tags = get_run_tags(config)
    check(re.fullmatch(r"\d{8}_\d{6}-" + re.escape("-".join(tags[:3])), out_dir.name) is not None,
          f"{label}: the run folder's name {out_dir.name} is not the JAX package's")
    check((out_dir / "config.yaml").exists(), f"{label}: the run folder has no config.yaml")
    saved = load_config(out_dir / "config.yaml")
    expected = json.loads(json.dumps(config))
    for key in ("batch_size", "batch_size_per_device"):
        check(saved.train[key] <= expected["train"][key], f"{label}: config.yaml's train.{key} grew")
        expected["train"][key] = saved.train[key]
    check(saved == expected, f"{label}: config.yaml reads back as another config than the run's")
    record = json.loads((out_dir / "run.json").read_text())
    check(record["tags"] == tags and record["config"] == flatten_dict(saved)
          and not any(isinstance(v, dict) for v in record["config"].values()),
          f"{label}: run.json is not the JAX package's record (tags {record['tags']}, expected {tags})")
    RUN_FOLDERS[label] = {"name": out_dir.name, "config_yaml_bytes": (out_dir / "config.yaml").stat().st_size,
                          "run_json_keys": len(record["config"])}


# (x, y) sizes of the heatmap validation images: one patch, and 2 x 2 patches (overlap 128)
LANDMARK_VAL_SIZES = [(256, 256), (256, 256), (320, 288), (320, 288)]
LANDMARK_VAL_KEYS = ("val_mean_landmark_distance", "val_mean_coordinate_error")


def landmark_phase(report: dict, smi: str, profile: bool) -> dict:
    """Landmark localization at full width on the 2-D lax_2c view: ConvUNetR-base heatmaps and ConvViT-base
    coordinates; returns the packed kernels' launches on this path."""
    from cinema_tpu_torch import metrics as lmk_metrics
    from cinema_tpu_torch.config import PACKAGED, from_dict
    from cinema_tpu_torch.data import BatchLoader, to_device
    from cinema_tpu_torch.factory import get_segmentation_model, init_weights
    from cinema_tpu_torch.models import vit
    from cinema_tpu_torch.ops.flash_attention import flash_attention_packed_kv_plain
    from cinema_tpu_torch.ops.window import get_patch_grid
    from cinema_tpu_torch.tasks.classification import get_classification_model
    from cinema_tpu_torch.tasks.regression import landmark as reg_landmark
    from cinema_tpu_torch.tasks.segmentation import landmark as seg_landmark

    t_phase = time.perf_counter()
    launches = Launches()
    reset, read, counters = launches.reset, launches.read, launches.totals
    batch_size, n_train, n_timed, depth, view = 4, 16, 6, 12, "lax_2c"
    cuda = torch.device("cuda")

    def plain_attention():
        return swapped(vit, "flash_attention_packed_kv", flash_attention_packed_kv_plain)

    def f32_copy(build, config, model):
        """An f32 copy of ``model`` in train mode without dropout or drop-path noise."""
        model32 = build(config, dtype=torch.float32, device=cuda).train()
        model32.load_state_dict(model.state_dict())
        for module in model32.modules():
            if hasattr(module, "rate"):
                module.rate = 0.0
        return model32

    with tempfile.TemporaryDirectory() as tmp:
        # a. heatmaps: ConvUNetR-base, grad_ckpt on as the packaged config
        heat_dir = Path(tmp) / "heatmap"
        write_landmark_data(heat_dir, {"train": [(256, 256)] * n_train, "val": LANDMARK_VAL_SIZES}, seed=6)
        config = from_dict(PACKAGED["segmentation/landmark"])
        config.train.batch_size = batch_size  # no accumulation: every step is an update
        config.data.dir = str(heat_dir)
        patch = tuple(config.data.lax.patch_size)
        train_ds, val_ds = seg_landmark.load_dataset(config)
        check((len(train_ds), len(val_ds)) == (n_train, len(LANDMARK_VAL_SIZES)), f"split {len(train_ds)} / {len(val_ds)}")
        batches = [to_device(b, cuda) for b in BatchLoader(train_ds, batch_size, seed=0).epoch(0)]
        check(batches[0][f"{view}_image"].shape == (batch_size, *patch, 1)
              and batches[0][f"{view}_label"].shape == (batch_size, *patch, 3),
              f"heatmap batch {tuple(batches[0][f'{view}_image'].shape)}")

        def make_heat_step(model):
            return supervised_step(config, model, seg_landmark.landmark_loss_fn)

        model = init_weights(get_segmentation_model(config, dtype=torch.bfloat16, device=cuda), seed=config.seed)
        check(model.encoder.remat, "grad_ckpt did not reach the encoder")
        state, step_fn = make_heat_step(model)
        # the LayerNorm over the one-channel input image outputs its bias: its weight may stay (phase 7)
        report["landmark_heatmap"] = timed_steps(launches, smi, "landmark_heatmap", model, state, step_fn, batches,
                                                 n_timed, (2 * depth, depth, 0, 0),
                                                 frozenset({f"dec_image_conv_block_dict.{view}.norm1.weight"}))
        state = check_nan_batch("landmark_heatmap", launches, model, state, step_fn, batches[0], f"{view}_image")
        if profile:
            reset()
            report["landmark_profile"] = profile_call("landmark_profile", lambda: step_fn(state, batches[0]), smi)
            read()
        del state, step_fn
        small = {k: v[:2] for k, v in batches[1].items()}
        model32 = f32_copy(get_segmentation_model, config, model)
        report["landmark_heatmap_f32"] = check_f32_step("landmark_heatmap_f32", launches, model32,
                                                        seg_landmark.landmark_loss_fn, small, plain_attention(),
                                                        (2 * depth, depth, 0, 0))
        del model32

        # one evaluated image of each size: sigmoid window, crop, argmax; the card's coordinates against
        # heatmap_argmax of the same logits on the CPU, where they differ a tie
        model.eval()
        evals = []
        with torch.no_grad():
            for index in (0, 2):
                item = {k: v[None] for k, v in val_ds.load(index).items()}
                batch = dict(item, **{f"{view}_image": torch.from_numpy(item[f"{view}_image"]).to(cuda)})
                seg_landmark.landmark_eval_batch(model, batch, view, patch)  # warm-up
                torch.cuda.synchronize()
                reset()
                t0 = time.perf_counter()
                logits, pred, true = seg_landmark.landmark_eval_batch(model, batch, view, patch)
                pred = pred.cpu()
                image_s = time.perf_counter() - t0
                got = read()
                size = tuple(item[f"{view}_image"].shape[1:3])
                n_patches = len(get_patch_grid(size, patch, [p // 2 for p in patch]))
                check(got == (depth, 0, 0, 0), f"an evaluated {size} image launched {got}, expected {depth}")
                host = logits.float().cpu()
                check(host.shape == (1, *size, 3) and bool(torch.isfinite(host).all()), f"{size} logits {host.shape}")
                want = lmk_metrics.heatmap_argmax(host)
                ties = 0
                for c in range(3):
                    (gx, gy), (wx, wy) = pred[0, 2 * c : 2 * c + 2].tolist(), want[0, 2 * c : 2 * c + 2].tolist()
                    if (gx, gy) != (wx, wy):
                        check(bool(host[0, gx, gy, c] == host[0, wx, wy, c]),
                              f"{size} channel {c}: card argmax ({gx}, {gy}) against the CPU's ({wx}, {wy})")
                        ties += 1
                evals.append({"size": list(size), "patches": n_patches, "launches": got[0], "ms_per_image": image_s * 1e3,
                              "coords": pred[0].tolist(), "true_coords": true[0].tolist(), "ties": ties})
        report["landmark_heatmap_eval"] = evals
        print("landmark_heatmap_eval", json.dumps(evals), f"on {smi}", flush=True)
        del model

        # the entry point: two epochs with an evaluation each
        config.logging.dir = str(Path(tmp) / "runs_heatmap")
        config.train.update(n_epochs=2, eval_interval=1)
        reset()
        t0 = time.perf_counter()
        out_dir = seg_landmark.run(config, device="cuda")
        heat_run_s = time.perf_counter() - t0
        got = read()
        steps_per_epoch = n_train // batch_size
        steps, images = 2 * steps_per_epoch, 2 * len(val_ds)
        check(got == (2 * depth * steps + depth * images, depth * steps, 0, 0),
              f"the heatmap run launched {got}, expected {2 * depth} + {depth} a step and {depth} an evaluated image")
        report["landmark_heatmap_run"] = {
            "seconds": heat_run_s, "steps": steps, "evaluated_images": images, "launches": dict(zip(counters, got)),
            **check_run_and_reload("landmark_heatmap_run", config, out_dir,
                                   lambda: get_segmentation_model(config, dtype=torch.bfloat16, device=cuda),
                                   make_heat_step, steps_per_epoch, {view: batches[0][f"{view}_image"][:1]},
                                   LANDMARK_VAL_KEYS)}
        print("landmark_heatmap_run", json.dumps(report["landmark_heatmap_run"]), f"on {smi}", flush=True)

        # b. coordinates: ConvViT-base, six outputs, grad_ckpt on as the packaged config
        coord_dir = Path(tmp) / "coordinates"
        n_val = 4
        write_landmark_data(coord_dir, {"train": [(256, 256)] * n_train, "val": [(256, 256)] * n_val}, seed=7)
        reg = from_dict(PACKAGED["regression/landmark"])
        reg.train.batch_size = batch_size
        reg.data.dir = str(coord_dir)
        train_ds, val_ds = reg_landmark.load_dataset(reg)
        batches = [to_device(b, cuda) for b in BatchLoader(train_ds, batch_size, seed=0).epoch(0)]
        check(batches[0]["label"].shape == (batch_size, 6), f"coordinate labels {tuple(batches[0]['label'].shape)}")

        def make_coord_step(model):
            return supervised_step(reg, model, reg_landmark.landmark_regression_loss_fn)

        model = init_weights(get_classification_model(reg, dtype=torch.bfloat16, device=cuda), seed=reg.seed)
        check(model.pred_head_dict["cls"].out_features == 6 and model.encoder.remat, "coordinate model")
        state, step_fn = make_coord_step(model)
        report["landmark_coordinate"] = timed_steps(launches, smi, "landmark_coordinate", model, state, step_fn,
                                                    batches, n_timed, (2 * depth, depth, 0, 0))
        state = check_nan_batch("landmark_coordinate", launches, model, state, step_fn, batches[0], f"{view}_image")
        del state, step_fn
        model32 = f32_copy(get_classification_model, reg, model)
        report["landmark_coordinate_f32"] = check_f32_step(
            "landmark_coordinate_f32", launches, model32, reg_landmark.landmark_regression_loss_fn,
            {k: v[:2] for k, v in batches[1].items()}, plain_attention(), (2 * depth, depth, 0, 0))
        del model32

        # one evaluation of the validation images: a plain forward each
        loader = BatchLoader(val_ds, 1, shuffle=False, drop_last=False)
        reg_landmark.landmark_regression_eval_dataloader(model, loader, reg)  # warm-up
        torch.cuda.synchronize()
        reset()
        t0 = time.perf_counter()
        coord_metrics = reg_landmark.landmark_regression_eval_dataloader(model, loader, reg)
        coord_eval_s = time.perf_counter() - t0
        got = read()
        check(got == (depth * n_val, 0, 0, 0), f"the coordinate evaluation launched {got}, expected {depth} an image")
        check(all(np.isfinite(v) for v in coord_metrics.values()), f"coordinate evaluation {coord_metrics}")
        report["landmark_coordinate_eval"] = {"images": n_val, "ms_per_image": coord_eval_s * 1e3 / n_val,
                                              **coord_metrics}
        print("landmark_coordinate_eval", json.dumps(report["landmark_coordinate_eval"]), f"on {smi}", flush=True)
        del model

        reg.logging.dir = str(Path(tmp) / "runs_coordinates")
        reg.train.update(n_epochs=2, eval_interval=1)
        reset()
        t0 = time.perf_counter()
        out_dir = reg_landmark.run(reg, device="cuda")
        coord_run_s = time.perf_counter() - t0
        got = read()
        steps = 2 * steps_per_epoch
        check(got == (2 * depth * steps + depth * 2 * n_val, depth * steps, 0, 0),
              f"the coordinate run launched {got}, expected {2 * depth} + {depth} a step and {depth} an image")
        report["landmark_coordinate_run"] = {
            "seconds": coord_run_s, "steps": steps, "evaluated_images": 2 * n_val, "launches": dict(zip(counters, got)),
            **check_run_and_reload("landmark_coordinate_run", reg, out_dir,
                                   lambda: get_classification_model(reg, dtype=torch.bfloat16, device=cuda),
                                   make_coord_step, steps_per_epoch, {view: batches[0][f"{view}_image"][:1]},
                                   LANDMARK_VAL_KEYS)}
        print("landmark_coordinate_run", json.dumps(report["landmark_coordinate_run"]), f"on {smi}", flush=True)
    keys = ("ms_per_step", "samples_per_s", "peak_mem_gib")
    report["landmark"] = {
        "heatmap": {k: report["landmark_heatmap"][k] for k in keys},
        "coordinate": {k: report["landmark_coordinate"][k] for k in keys},
        "heatmap_eval_ms_per_image": {"x".join(map(str, e["size"])): e["ms_per_image"] for e in evals},
        "coordinate_eval_ms_per_image": report["landmark_coordinate_eval"]["ms_per_image"],
        "heatmap_run_s": heat_run_s, "coordinate_run_s": coord_run_s, "phase_s": time.perf_counter() - t_phase,
    }
    print("landmark", json.dumps(report["landmark"]), f"on {smi}", flush=True)
    report["landmark_launches"] = counters
    return counters


# SAX depths of the M&Ms phase's studies, drawn from 10 to 14 slices as the preprocessing's resampling to
# 10 mm leaves them; every study is one patch of 192x192x16 after padding
MNMS_Z = (10, 15)
MNMS_TASKS = ("classification/mnms", "classification/mnms2", "regression/mnms", "regression/mnms2",
              "segmentation/mnms", "segmentation/mnms2")


def write_mnms_tree(root: Path, name: str, n_train: int, n_val: int, seed: int) -> None:
    """Seeded synthetic M&Ms (``name`` "mnms") or M&Ms2 ("mnms2") studies in the preprocessing's layout: per
    split ``<split>/<pid>/`` the SAX ED and ES frames of 192x192xz, z drawn from MNMS_Z (``seg_frames``: uint8
    images with a bright LV/MYO/RV blob, uint8 labels), and ``<split>_metadata.csv`` with ``pid``,
    ``n_slices``, ``pathology`` (the config's classes in turn), ``ef`` and, for M&Ms, ``age``."""
    from cinema_tpu_torch.config import PACKAGED

    classes = PACKAGED[f"classification/{name}"]["data"]["pathology"]
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        rows = []
        for i in range(n):
            pid = f"{split[0].upper()}{i:04d}" if name == "mnms" else str(i + 1 + (0 if split == "train" else 160))
            z = int(rng.integers(*MNMS_Z))
            write_seg_study(root / split, pid, *seg_frames(rng, (192, 192, z)))
            row = {"pid": pid, "n_slices": z, "pathology": classes[i % len(classes)],
                   "ef": round(float(rng.uniform(30, 70)), 3)}
            if name == "mnms":
                row["age"] = int(rng.integers(20, 80))
            rows.append(row)
        write_metadata(root / f"{split}_metadata.csv", rows)


def mnms_phase(report: dict, smi: str, profile: bool) -> dict:
    """The M&Ms and M&Ms2 tasks on processed NIfTI at full width: the augmented training loader of
    ``segmentation/mnms`` alone (threads and processes), ConvUNetR-base steps fed from it inside the loop, and
    one epoch of each of the six entry points; returns the packed kernels' launches on this path."""
    import importlib

    from cinema_tpu_torch.config import PACKAGED, from_dict
    from cinema_tpu_torch.data import BatchLoader, device_prefetch, to_device
    from cinema_tpu_torch.factory import get_segmentation_model, init_weights
    from cinema_tpu_torch.tasks.classification import get_classification_model
    from cinema_tpu_torch.tasks.segmentation import mnms as seg_mnms
    from cinema_tpu_torch.tasks.segmentation import segmentation_loss_fn

    t_phase = time.perf_counter()
    launches = Launches()
    reset, read, counters = launches.reset, launches.read, launches.totals
    # 14 training studies: 28 frames, 7 batches of 4, a warm-up and six timed steps in one epoch
    batch_size, n_train, n_val, n_timed, depth = 4, 14, 5, 6, 12
    cuda = torch.device("cuda")
    config = from_dict(PACKAGED["segmentation/mnms"])  # grad_ckpt on, transform.prob 0.5, as packaged
    config.train.batch_size = batch_size  # no accumulation: every step is an update
    n_workers = config.train.n_workers
    patch = tuple(config.data.sax.patch_size)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        for i, name in enumerate(("mnms", "mnms2")):
            write_mnms_tree(Path(tmp) / name, name, n_train, n_val, seed=20 + i)
        write_s = time.perf_counter() - t0
        config.data.dir = str(Path(tmp) / "mnms")

        def train_dataset(prob: float):
            augmented = from_dict(config)
            augmented.transform.prob = prob
            train_ds, _ = seg_mnms.load_dataset(augmented)
            check(len(train_ds) == 2 * n_train, f"M&Ms training frames {len(train_ds)}")
            return train_ds

        # a. the augmented training loader alone: an epoch to start its workers, then one timed; every mode
        # gives the same batches. b. ConvUNetR-base steps fed from the 4-thread and the 4-process loader
        # through device_prefetch inside the loop, as run_train feeds them (no synchronisation between steps;
        # the loader's wait is the time blocked on its next batch on the card), then from a loader of items
        # without augmentation
        model = init_weights(get_segmentation_model(config, dtype=torch.bfloat16, device=cuda), seed=config.seed)
        check(model.encoder.remat, "grad_ckpt did not reach the encoder")

        def fed_steps(label: str, loader, epoch: int, prob: float) -> dict:
            state, step_fn = supervised_step(config, model, segmentation_loss_fn)
            batches = device_prefetch(loader.epoch(epoch), cuda, depth=2)
            state, _ = step_fn(state, next(batches))  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset()
            waits, losses = [], []
            t0 = time.perf_counter()
            for _ in range(n_timed):
                w0 = time.perf_counter()
                batch = next(batches)
                waits.append(time.perf_counter() - w0)
                state, metrics = step_fn(state, batch)
                losses.append(metrics["loss"])
            torch.cuda.synchronize()
            total_s = time.perf_counter() - t0
            got = read()
            if profile and label == "threads":  # a fed step's device time against its wall time
                again = device_prefetch(loader.epoch(epoch + 1), cuda, depth=2)
                reset()
                report["mnms_fed_profile"] = profile_call("mnms_fed_profile", lambda: step_fn(state, next(again)), smi)
                read()
            losses = [float(x) for x in losses]
            check(got == (n_timed * 2 * depth, n_timed * depth, 0, 0),
                  f"{n_timed} fed M&Ms steps launched {got}, expected {2 * depth} + {depth} a step")
            check(all(x == x and abs(x) < 1e4 for x in losses), f"fed M&Ms losses not finite: {losses}")
            row = {"prob": prob, "workers": loader.n_workers,
                   "processes": loader.processes, "steps": n_timed, "ms_per_step": total_s * 1e3 / n_timed,
                   "samples_per_s": n_timed * batch_size / total_s,
                   "loader_wait_ms_per_step": sum(waits) * 1e3 / n_timed, "loader_wait_ms": [w * 1e3 for w in waits],
                   "losses": losses, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                   "launches": dict(zip(counters, got))}
            print(f"mnms_fed_{label}", json.dumps(row), f"on {smi}", flush=True)
            return row

        loader_rows, fed, first_batches = {}, {}, None
        for mode, workers, processes in (("1_thread", 1, False), (f"{n_workers}_threads", n_workers, False),
                                         (f"{n_workers}_processes", n_workers, True)):
            with BatchLoader(train_dataset(config.transform.prob), batch_size, seed=config.seed, n_workers=workers,
                             processes=processes) as loader:
                t0 = time.perf_counter()
                n_first = len(list(loader.epoch(0)))
                start_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                batches = list(loader.epoch(1))
                epoch_s = time.perf_counter() - t0
                check(n_first == len(batches) == 2 * n_train // batch_size
                      and batches[0]["sax_image"].shape == (batch_size, *patch, 1)
                      and batches[0]["sax_label"].shape == (batch_size, *patch), f"{mode} loader batches")
                if first_batches is None:
                    first_batches = batches
                check(all(np.array_equal(a[k], b[k]) for a, b in zip(first_batches, batches)
                          for k in ("sax_image", "sax_label")), f"the {mode} loader gave other batches than one thread")
                loader_rows[mode] = {"workers": workers, "processes": processes, "first_epoch_s": start_s,
                                     "ms_per_batch": epoch_s * 1e3 / len(batches),
                                     "items_per_s": len(batches) * batch_size / epoch_s}
                print("mnms_loader", mode, json.dumps(loader_rows[mode]), f"on {smi}", flush=True)
                if workers > 1:
                    label = "processes" if processes else "threads"
                    fed[label] = fed_steps(label, loader, 2, config.transform.prob)
        with BatchLoader(train_dataset(0.0), batch_size, seed=config.seed, n_workers=n_workers) as loader:
            fed["no_augmentation"] = fed_steps("no_augmentation", loader, 0, 0.0)
        report["mnms_loader"], report["mnms_fed"] = loader_rows, fed
        del model

        # c. one epoch of each entry point's run, evaluated once; its checkpoint and safetensors reloaded
        runs = {}
        val_keys = {"classification": ("val_accuracy",), "regression": ("val_mae", "val_rmse"),
                    "segmentation": ("val_mean_dice_score",)}
        for task in MNMS_TASKS:
            family, name = task.split("/")
            entry = importlib.import_module(f"cinema_tpu_torch.tasks.{family}.{name}")
            cfg = from_dict(PACKAGED[task])
            cfg.data.dir = str(Path(tmp) / name)
            cfg.logging.dir = str(Path(tmp) / "runs" / family / name)
            cfg.train.update(n_epochs=1, eval_interval=1, batch_size=batch_size)
            train_ds, val_ds = entry.load_dataset(cfg)
            steps = len(train_ds) // batch_size
            image = torch.from_numpy(val_ds.load(0, 0)["sax_image"][None]).to(cuda)
            reset()
            t0 = time.perf_counter()
            out_dir = entry.run(cfg, device="cuda")
            run_s = time.perf_counter() - t0
            got = read()
            # grad_ckpt as packaged: two forward launches a block and step; one per block and evaluated item
            # (a classified study or a segmented frame, each one patch)
            check(got == (2 * depth * steps + depth * len(val_ds), depth * steps, 0, 0),
                  f"the {task} run launched {got}, expected {2 * depth} + {depth} a step and {depth} an evaluated item")
            build = get_segmentation_model if family == "segmentation" else get_classification_model
            runs[task] = {"seconds": run_s, "steps": steps, "evaluated": len(val_ds), "launches": dict(zip(counters, got)),
                          **check_run_and_reload(task, cfg, out_dir, lambda: build(cfg, dtype=torch.bfloat16, device=cuda),
                                                 lambda m: supervised_step(cfg, m, segmentation_loss_fn), steps,
                                                 {"sax": image}, val_keys[family])}
            print(f"mnms_run {task}", json.dumps(runs[task]), f"on {smi}", flush=True)
        report["mnms_runs"] = runs
    report["mnms"] = {
        "write_s": write_s,
        "loader_ms_per_batch": {k: v["ms_per_batch"] for k, v in loader_rows.items()},
        "fed_ms_per_step": {k: v["ms_per_step"] for k, v in fed.items()},
        "fed_loader_wait_ms_per_step": {k: v["loader_wait_ms_per_step"] for k, v in fed.items()},
        "fed_peak_mem_gib": fed["threads"]["peak_mem_gib"],
        **({"fed_idle_share": report["mnms_fed_profile"]["idle_share"]} if profile else {}),
        "run_s": {k: v["seconds"] for k, v in runs.items()},
        "phase_s": time.perf_counter() - t_phase,
    }
    print("mnms", json.dumps(report["mnms"]), f"on {smi}", flush=True)
    report["mnms_launches"] = counters
    return counters


# sizes of the cine phase's data. EMIDEC: training volumes of one 96x96x8 patch; the evaluated test volume
# 128x112x8, 2 x 2 patches. MyoPS2020: one 192x192x4 patch; the evaluated test volume 224x208x5, 2 x 2
# patches in-plane and, its 5 slices padded to the z bucket of 8, 3 along z. Rescan: SAX cines of 192x192x16
# with 25 frames. Kaggle: SAX cines of 192x192x12 (padded to 16) with 30 frames
EMIDEC_SIZES = {"train": (96, 96, 8), "test": (128, 112, 8)}
MYOPS_SIZES = {"train": (192, 192, 4), "test": (224, 208, 5)}
RESCAN_CINE = (192, 192, 16, 25)
KAGGLE_CINE = (192, 192, 12, 30)


def cine_frames(rng: np.random.Generator, size: tuple) -> tuple[np.ndarray, np.ndarray]:
    """(image, label) uint8 (x, y, z, t) of one seeded synthetic cine of ``size`` (``seg_frames``), the shells
    contracting from 1 at t = 0 to 0.85 mid-cycle and back."""
    n = size[3]
    return seg_frames(rng, size[:3], tuple(1.0 - 0.075 * (1.0 - np.cos(2 * np.pi * t / n)) for t in range(n)))


def write_volume_studies(root: Path, name: str, n_train: int, n_test: int, seed: int) -> None:
    """Seeded synthetic EMIDEC (``name`` "emidec") or MyoPS2020 ("myops2020") studies in the preprocessing's
    layout, from the shells of ``seg_frames``: EMIDEC ``<pid>/<pid>.nii.gz`` with labels 0-4 (cavity,
    myocardium, an infarct in part of the myocardium and a no-reflow core in part of that), pids ``Case_N0ii``
    and ``Case_P0ii`` in turn; MyoPS2020 ``<pid>/<pid>_{c0,de,t2}.nii.gz``, three contrasts, with labels 0-3
    (myocardium, edema, scar), integer pids; each with ``<pid>_gt.nii.gz`` and ``<split>_metadata.csv``
    (``pid``, ``n_slices``). Sizes from EMIDEC_SIZES or MYOPS_SIZES; the first test study is the larger one."""
    from cinema_tpu_torch.data import save_nifti

    sizes = EMIDEC_SIZES if name == "emidec" else MYOPS_SIZES
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("test", n_test)):
        rows = []
        for i in range(n):
            size = sizes["test"] if split == "test" and i == 0 else sizes["train"]
            _, shells = seg_frames(rng, size, (1.0,))
            shells = shells[..., 0]
            x = np.arange(size[0])[:, None, None] > size[0] * 0.42
            y = np.arange(size[1])[None, :, None] > size[1] * 0.42
            if name == "emidec":
                label = np.where(shells == 3, 0, shells).astype(np.uint8)
                label[(label == 2) & x] = 3
                label[(label == 3) & y] = 4
                contrasts = {"": (30, 110, 160, 240, 70)}
                pid = f"Case_{'NP'[i % 2]}{i // 2 + 1 + 100 * (split == 'test'):03d}"
            else:
                label = np.where(shells == 2, 1, 0).astype(np.uint8)
                label[(label == 1) & x] = 2
                label[(label == 2) & y] = 3
                contrasts = {"_c0": (30, 200, 180, 170), "_de": (40, 60, 150, 250), "_t2": (50, 90, 230, 200)}
                pid = str(101 + i + 100 * (split == "test"))
            (root / split / pid).mkdir(parents=True)
            spacing = (1.458, 1.458, 10.0) if name == "emidec" else (1.0, 1.0, 10.0)
            for suffix, levels in contrasts.items():
                image = np.array(levels, np.float32)[label] + rng.normal(0, 25, size).astype(np.float32)
                save_nifti(root / split / pid / f"{pid}{suffix}.nii.gz", np.clip(image, 0, 255).astype(np.uint8),
                           spacing=spacing)
            save_nifti(root / split / pid / f"{pid}_gt.nii.gz", label, spacing=spacing)
            rows.append({"pid": pid, "n_slices": size[2]})
        write_metadata(root / f"{split}_metadata.csv", rows)


def write_rescan_studies(root: Path, seed: int) -> None:
    """Seeded synthetic Rescan cines (``cine_frames``, RESCAN_CINE, frame-indexed as the port writes them): per
    study ``<split>/<pid>/sax_t.nii.gz`` and ``sax_gt_t.nii.gz``; ``train`` four studies of two groups
    (``G00/s_0001``..``s_0003``, ``G01/s_0001``), ``test`` one, and ``test_retest_100`` two subjects scanned
    twice (``scan_0i_{A,B}``, images only, ``ef`` given for the A scans), each split with its metadata table."""
    from cinema_tpu_torch.data import save_nifti

    rng = np.random.default_rng(seed)
    splits = {"train": ["G00/s_0001", "G00/s_0002", "G00/s_0003", "G01/s_0001"], "test": ["G02/s_0001"],
              "test_retest_100": [f"scan_{i:02d}_{acq}" for i in range(2) for acq in "AB"]}
    for split, pids in splits.items():
        rows = []
        for pid in pids:
            image, label = cine_frames(rng, RESCAN_CINE)
            (root / split / pid).mkdir(parents=True)
            save_nifti(root / split / pid / "sax_t.nii.gz", image, spacing=(1.0, 1.0, 10.0, 1.0), frame_indexed=True)
            row = {"pid": pid, "n_slices": RESCAN_CINE[2], "n_frames": RESCAN_CINE[3]}
            if split == "test_retest_100":
                row["ef"] = round(float(rng.uniform(45, 65)), 2) if pid.endswith("A") else ""
            else:
                save_nifti(root / split / pid / "sax_gt_t.nii.gz", label, spacing=(1.0, 1.0, 10.0, 1.0),
                           frame_indexed=True)
            rows.append(row)
        write_metadata(root / f"{split}_metadata.csv", rows)


def write_kaggle_studies(root: Path, n: int, seed: int) -> None:
    """Seeded synthetic Kaggle cines (``cine_frames``, KAGGLE_CINE): ``validate/<pid>/<pid>_sax_t.nii.gz`` and
    ``validate_metadata.csv`` with the volumes (``diastole_volume``, ``systole_volume``)."""
    from cinema_tpu_torch.data import save_nifti

    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        pid = str(700 + i)
        image, _ = cine_frames(rng, KAGGLE_CINE)
        (root / "validate" / pid).mkdir(parents=True)
        save_nifti(root / "validate" / pid / f"{pid}_sax_t.nii.gz", image, spacing=(1.0, 1.0, 10.0, 1.0))
        edv = round(float(rng.uniform(100, 200)), 1)
        rows.append({"pid": pid, "n_slices": KAGGLE_CINE[2], "n_frames": KAGGLE_CINE[3], "diastole_volume": edv,
                     "systole_volume": round(edv * float(rng.uniform(0.35, 0.6)), 1)})
    write_metadata(root / "validate_metadata.csv", rows)


@contextlib.contextmanager
def attention_dtypes(dtypes: list, flags: list | None = None):
    """Inside the block the models' packed attention notes the dtype of each call's q in ``dtypes`` and, where
    ``flags`` is given, the TF32 flags it ran under there (``precision_flags``)."""
    from cinema_tpu_torch.models import vit

    inner = vit.flash_attention_packed_kv

    def noting(q, kv, n_heads):
        dtypes.append(q.dtype)
        if flags is not None:
            flags.append(precision_flags())
        return inner(q, kv, n_heads)

    with swapped(vit, "flash_attention_packed_kv", noting):
        yield


# (float32 matmul precision, cuDNN TF32): torch's defaults (cuBLAS in full f32, cuDNN convolutions in TF32) and
# the float32 evaluation's (TF32 off for both, set by its entry point)
TORCH_DEFAULT_FLAGS = ("highest", True)
TF32_OFF = ("highest", False)


def precision_flags() -> tuple:
    return torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32


@contextlib.contextmanager
def torch_default_precision():
    """torch's default TF32 flags inside the block, as a user's process has them (this script turns TF32 off
    for its f32 comparisons); this script's flags are restored after it."""
    saved = precision_flags()
    torch.set_float32_matmul_precision(TORCH_DEFAULT_FLAGS[0])
    torch.backends.cudnn.allow_tf32 = TORCH_DEFAULT_FLAGS[1]
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]


def cine_phase(report: dict, smi: str, profile: bool) -> dict:
    """The EMIDEC, MyoPS2020, Rescan and Kaggle tasks, NIfTI frame seeks and the evaluation of run folders
    (``tasks.evaluate``, float32 as in the JAX package, and the bfloat16 label-free EF) at full width; returns
    the packed kernels' launches on this path."""
    from cinema_tpu_torch import metrics as seg_metrics
    from cinema_tpu_torch.config import PACKAGED, from_dict
    from cinema_tpu_torch.data import (
        BatchLoader,
        EMIDECDataset,
        MYOPS2020Dataset,
        device_prefetch,
        load_nifti_frame,
        read_metadata,
        save_nifti,
        to_device,
    )
    from cinema_tpu_torch.data.transforms import get_segmentation_transforms
    from cinema_tpu_torch.factory import get_segmentation_model, init_weights
    from cinema_tpu_torch.models import vit
    from cinema_tpu_torch.ops.flash_attention import flash_attention_packed_kv_plain
    from cinema_tpu_torch.ops.window import crop_start
    from cinema_tpu_torch.tasks import evaluate
    from cinema_tpu_torch.tasks.segmentation import (
        emidec,
        kaggle,
        myops2020,
        patch_and_spacing_dicts,
        rescan,
        rescan_ef_eval,
        segmentation_eval_batch,
        segmentation_loss_fn,
    )
    from cinema_tpu_torch.train.checkpoint import save_params_safetensors

    t_phase = time.perf_counter()
    launches = Launches()
    reset, read, counters = launches.reset, launches.read, launches.totals
    batch_size, n_timed, depth = 4, 6, 12
    cuda = torch.device("cuda")
    out: dict = {}

    def plain_attention():
        return swapped(vit, "flash_attention_packed_kv", flash_attention_packed_kv_plain)

    def cinema_eval(label: str, folder: Path, split: str, expected: int, tables: tuple, key: str) -> dict:
        """``tasks.evaluate.main`` on a run folder: float32, as in the JAX package, through the kernel, ``expected``
        launches; it must write ``tables`` to ``<folder>/<data>_eval`` (data: the run's dataset, the label's first
        word) and a finite ``key`` mean. It is called with torch's default TF32 flags, as a user's process has
        them: every attention call must run with TF32 off, set by the entry point, and the flags must be torch's
        defaults again after the call."""
        dtypes: list = []
        flags: list = []
        reset()
        t0 = time.perf_counter()
        with torch_default_precision(), attention_dtypes(dtypes, flags):
            before = precision_flags()
            evaluate.main(["--folder_path", str(folder), "--split", split, "--device", "cuda"])
            after = precision_flags()
        seconds = time.perf_counter() - t0
        got = read()
        check(got == (expected, 0, 0, 0) and len(dtypes) == expected and set(dtypes) == {torch.float32},
              f"cinema_eval {label} launched {got} over {len(dtypes)} calls of {set(dtypes)}, expected {expected} "
              f"float32 packed forward launches")
        check(before == after == TORCH_DEFAULT_FLAGS and set(flags) == {TF32_OFF},
              f"cinema_eval {label}: flags {before} before the call, {set(flags)} inside, {after} after; expected "
              f"{TORCH_DEFAULT_FLAGS}, {TF32_OFF}, {TORCH_DEFAULT_FLAGS}")
        out_dir = folder / f"{label.split('_')[0]}_eval"
        written = sorted(p.name for p in out_dir.iterdir())
        check(set(tables) <= set(written), f"cinema_eval {label} wrote {written}, expected {tables}")
        (means,) = list(csv.DictReader((out_dir / "mean_metrics.csv").read_text().splitlines()))
        check(np.isfinite(float(means[key])), f"cinema_eval {label}: {key} {means[key]}")
        row = {"split": split, "seconds": seconds, "f32_launches": got[0], key: float(means[key]),
               "flags": {"before": before, "inside": sorted(set(flags)), "after": after}}
        print(f"cine_eval {label}", json.dumps(row), f"on {smi}", flush=True)
        return row

    def volume_task(name: str, entry, dataset_cls, metrics_fn, data_dir: Path) -> tuple:
        """EMIDEC or MyoPS2020: timed grad_ckpt steps, a NaN batch, an f32 step, the larger test volume evaluated
        on the card and its grouped metrics held to the CPU's, one epoch of ``run``; returns (rows, run folder)."""
        config = from_dict(PACKAGED[f"segmentation/{name}"])  # grad_ckpt on, as packaged
        config.train.batch_size = batch_size  # no accumulation: every step is an update
        config.data.dir = str(data_dir)
        patch_size_dict, spacing_dict = patch_and_spacing_dicts(config)
        patch = patch_size_dict["sax"]
        in_chans = config.data.sax.in_chans
        train_ds, val_ds = entry.load_dataset(config)
        with BatchLoader(train_ds, batch_size, seed=0) as loader:
            batches = [to_device(b, cuda) for b in loader.epoch(0)]
        check(batches[0]["sax_image"].shape == (batch_size, *patch, in_chans)
              and batches[0]["sax_label"].shape == (batch_size, *patch), f"{name} batch {batches[0]['sax_image'].shape}")
        model = init_weights(get_segmentation_model(config, dtype=torch.bfloat16, device=cuda), seed=config.seed)
        check(model.encoder.remat, "grad_ckpt did not reach the encoder")
        state, step_fn = supervised_step(config, model, segmentation_loss_fn)
        # a one-channel input's LayerNorm outputs its bias: its weight may stay (phase 7)
        may_stay = frozenset({"dec_image_conv_block_dict.sax.norm1.weight"} if in_chans == 1 else ())
        rows = {"steps": timed_steps(launches, smi, name, model, state, step_fn, batches, n_timed,
                                     (2 * depth, depth, 0, 0), may_stay)}
        state = check_nan_batch(name, launches, model, state, step_fn, batches[0], "sax_image")
        if profile:
            reset()
            rows["profile"] = profile_call(f"{name}_profile", lambda: step_fn(state, batches[0]), smi)
            read()
        del state, step_fn
        model32 = get_segmentation_model(config, dtype=torch.float32, device=cuda).train()
        model32.load_state_dict(model.state_dict())
        for module in model32.modules():  # no dropout or drop-path noise: both passes see the same network
            if hasattr(module, "rate"):
                module.rate = 0.0
        small = {k: v[:2] for k, v in batches[1].items()}
        rows["f32"] = check_f32_step(f"{name}_f32", launches, model32, segmentation_loss_fn, small, plain_attention(),
                                     (2 * depth, depth, 0, 0))
        del model32

        # the larger test volume: sliding window on the card, the grouped metrics against the CPU's from the
        # same log-probabilities (the same argmax, counts exact in f32, the same host HD95)
        _, val_transform = get_segmentation_transforms(config)
        test = dataset_cls(data_dir / "test", read_metadata(data_dir / "test_metadata.csv"), val_transform)
        item = {k: v[None] for k, v in test.load(0).items() if k != "pid"}
        size = tuple(int(item[k][0]) for k in ("sax_width", "sax_height", "n_slices"))
        batch = {**item, **to_device({k: item[k] for k in ("sax_image", "sax_label")}, cuda)}
        model.eval()
        with torch.no_grad():
            segmentation_eval_batch(model, batch, patch_size_dict, spacing_dict, metrics_fn, z_bucket=4)  # warm-up
            torch.cuda.synchronize()
            reset()
            t0 = time.perf_counter()
            logits, row = segmentation_eval_batch(model, batch, patch_size_dict, spacing_dict, metrics_fn, z_bucket=4)
            eval_s = time.perf_counter() - t0
            got = read()
        check(got == (depth, 0, 0, 0), f"an evaluated {name} volume launched {got}, expected {depth}")
        host = logits["sax"].float().cpu()
        check(host.shape == (1, *size, config.model.out_chans), f"{name} evaluated logits {tuple(host.shape)}")
        label = crop_start(torch.from_numpy(np.asarray(item["sax_label"])), host.shape[:-1])
        want = {k: float(v[0]) for k, v in metrics_fn(host, label, spacing_dict["sax"]).items()}
        differ = {k: (row[k], v) for k, v in want.items()
                  if not (np.isnan(v) and np.isnan(row[k]) or abs(row[k] - v) <= 1e-6 * abs(v) + 1e-9)}
        check(not differ, f"{name} evaluated metrics, card against CPU: {differ}")
        rows["eval"] = {"size": list(size), "launches": got[0], "ms": eval_s * 1e3,
                        "mean_dice_score": row["mean_dice_score"]}
        print(f"{name}_eval", json.dumps(rows["eval"]), f"on {smi}", flush=True)

        # one epoch of the entry point, evaluated once; its checkpoint and safetensors reloaded
        config.logging.dir = str(data_dir.parent / "runs" / name)
        config.train.update(n_epochs=1, eval_interval=1)
        steps = len(train_ds) // batch_size
        reset()
        t0 = time.perf_counter()
        out_dir = entry.run(config, device="cuda")
        run_s = time.perf_counter() - t0
        got = read()
        check(got == (2 * depth * steps + depth * len(val_ds), depth * steps, 0, 0),
              f"the {name} run launched {got}, expected {2 * depth} + {depth} a step and {depth} an evaluated volume")
        image = torch.from_numpy(val_ds.load(0, 0)["sax_image"][None]).to(cuda)
        rows["run"] = {"seconds": run_s, "steps": steps, "evaluated": len(val_ds), "launches": dict(zip(counters, got)),
                       **check_run_and_reload(name, config, out_dir,
                                              lambda: get_segmentation_model(config, dtype=torch.bfloat16, device=cuda),
                                              lambda m: supervised_step(config, m, segmentation_loss_fn), steps,
                                              {"sax": image}, ("val_mean_dice_score",))}
        print(f"{name}_run", json.dumps(rows["run"]), f"on {smi}", flush=True)
        return rows, out_dir

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        write_volume_studies(root / "emidec", "emidec", 12, 2, seed=30)
        write_volume_studies(root / "myops2020", "myops2020", 10, 2, seed=31)
        write_rescan_studies(root / "rescan", seed=32)
        write_kaggle_studies(root / "kaggle", 3, seed=33)
        out["write_s"] = time.perf_counter() - t0

        # a. EMIDEC and MyoPS2020, 289 and 577 tokens
        out["emidec"], emidec_dir = volume_task("emidec", emidec, EMIDECDataset, emidec.emidec_segmentation_metrics,
                                                root / "emidec")
        out["myops2020"], myops_dir = volume_task("myops2020", myops2020, MYOPS2020Dataset,
                                                  myops2020.myops2020_segmentation_metrics, root / "myops2020")

        # b. frame seeks: one cine written frame-indexed and as one gzip member, each frame read alone
        image, _ = cine_frames(np.random.default_rng(34), RESCAN_CINE)
        reads = {}
        for kind, indexed in (("frame_indexed", True), ("single_member", False)):
            path = root / f"seek_{kind}.nii.gz"
            save_nifti(path, image, spacing=(1.0, 1.0, 10.0, 1.0), frame_indexed=indexed)
            seconds = []
            for t in range(RESCAN_CINE[3]):
                t0 = time.perf_counter()
                frame, _ = load_nifti_frame(path, t)
                seconds.append(time.perf_counter() - t0)
                check(np.array_equal(frame, image[..., t]), f"{kind} frame {t} differs from the written one")
            reads[kind] = {"ms_per_frame": statistics.mean(seconds) * 1e3, "ms_first": seconds[0] * 1e3,
                           "ms_last": seconds[-1] * 1e3, "file_mb": path.stat().st_size / 1e6}
        print("frame_seek", json.dumps(reads), f"on {smi}", flush=True)
        out["frame_seek"] = reads

        # c. Rescan: ConvUNetR-base grad_ckpt steps fed from the augmented loader of per-frame items in the loop,
        # then one epoch of rescan.run
        config = from_dict(PACKAGED["segmentation/rescan"])
        config.train.batch_size = batch_size
        config.data.dir = str(root / "rescan")
        train_ds, val_ds = rescan.load_dataset(config)
        check((len(train_ds), len(val_ds)) == (2 * RESCAN_CINE[3], 2 * RESCAN_CINE[3]),
              f"Rescan split {len(train_ds)} / {len(val_ds)} frames")
        model = init_weights(get_segmentation_model(config, dtype=torch.bfloat16, device=cuda), seed=config.seed)
        state, step_fn = supervised_step(config, model, segmentation_loss_fn)
        with BatchLoader(train_ds, batch_size, seed=config.seed, n_workers=config.train.n_workers) as loader:
            epoch = device_prefetch(loader.epoch(0), cuda, depth=2)
            state, _ = step_fn(state, next(epoch))  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset()
            waits, losses = [], []
            t0 = time.perf_counter()
            for _ in range(n_timed):
                w0 = time.perf_counter()
                batch = next(epoch)
                waits.append(time.perf_counter() - w0)
                state, metrics = step_fn(state, batch)
                losses.append(metrics["loss"])
            torch.cuda.synchronize()
            total_s = time.perf_counter() - t0
            got = read()
        losses = [float(x) for x in losses]
        check(got == (n_timed * 2 * depth, n_timed * depth, 0, 0), f"{n_timed} fed Rescan steps launched {got}")
        check(all(x == x and abs(x) < 1e4 for x in losses), f"fed Rescan losses not finite: {losses}")
        out["rescan_fed"] = {"workers": config.train.n_workers, "steps": n_timed, "ms_per_step": total_s * 1e3 / n_timed,
                             "loader_wait_ms_per_step": sum(waits) * 1e3 / n_timed,
                             "loader_wait_ms": [w * 1e3 for w in waits], "losses": losses,
                             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
        print("rescan_fed", json.dumps(out["rescan_fed"]), f"on {smi}", flush=True)
        del model, state, step_fn

        config.logging.dir = str(root / "runs" / "rescan")
        config.train.update(n_epochs=1, eval_interval=1)
        steps = len(train_ds) // batch_size
        reset()
        t0 = time.perf_counter()
        rescan_dir = rescan.run(config, device="cuda")
        run_s = time.perf_counter() - t0
        got = read()
        check(got == (2 * depth * steps + depth * len(val_ds), depth * steps, 0, 0),
              f"the Rescan run launched {got}, expected {2 * depth} + {depth} a step and {depth} an evaluated frame")
        image = torch.from_numpy(val_ds.load(0, 0)["sax_image"][None]).to(cuda)
        out["rescan_run"] = {"seconds": run_s, "steps": steps, "evaluated": len(val_ds),
                             "launches": dict(zip(counters, got)),
                             **check_run_and_reload("rescan", config, rescan_dir,
                                                    lambda: get_segmentation_model(config, dtype=torch.bfloat16,
                                                                                   device=cuda),
                                                    lambda m: supervised_step(config, m, segmentation_loss_fn), steps,
                                                    {"sax": image}, ("val_mean_dice_score",))}
        print("rescan_run", json.dumps(out["rescan_run"]), f"on {smi}", flush=True)

        # d. the label-free EF reproducibility of the run folder, bfloat16 as its entry point loads it: every cine
        # in chunks of 8 frames, 25 frames padded to 32
        chunks = -(-RESCAN_CINE[3] // kaggle.VIDEO_CHUNK)
        n_retest = len(read_metadata(root / "rescan" / "test_retest_100_metadata.csv"))
        dtypes: list = []
        reset()
        t0 = time.perf_counter()
        with attention_dtypes(dtypes):
            rescan_ef_eval.main(["--folder_path", str(rescan_dir), "--device", "cuda"])
        ef_s = time.perf_counter() - t0
        got = read()
        check(got == (n_retest * chunks * depth, 0, 0, 0) and set(dtypes) == {torch.bfloat16},
              f"rescan_ef_eval launched {got} ({set(dtypes)}), expected {chunks * depth} bfloat16 launches a cine")
        ef_rows = list(csv.DictReader((rescan_dir / "rescan_test_retest_100_ef_eval" / "ef_metrics.csv").read_text()
                                      .splitlines()))
        check(len(ef_rows) == n_retest and all(0.0 <= float(r["esv"]) <= float(r["edv"]) for r in ef_rows),
              f"rescan_ef_eval rows {ef_rows}")
        out["rescan_ef_eval"] = {"seconds": ef_s, "cines": n_retest, "ms_per_cine": ef_s * 1e3 / n_retest,
                                 "bf16_launches": got[0], "ef": [r["ef"] for r in ef_rows]}
        print("rescan_ef_eval", json.dumps(out["rescan_ef_eval"]), f"on {smi}", flush=True)

        # e. Kaggle: the label-free EF of whole cines, float32 as cinema_eval runs it, with the Rescan run's weights
        kaggle_config, model32 = evaluate.load_run(rescan_dir, device="cuda")
        kaggle_config.data.dir = str(root / "kaggle")
        n_videos = len(read_metadata(root / "kaggle" / "validate_metadata.csv"))
        chunks = -(-kaggle.MAX_N_FRAMES // kaggle.VIDEO_CHUNK)  # every video is padded to MAX_N_FRAMES
        # a library call, not an entry point: it states its precision with the entry points' context
        with torch_default_precision(), evaluate.float32_precision():
            kaggle.evaluate_kaggle(model32, kaggle_config, "validate", 1)  # warm-up
            torch.cuda.synchronize()
            dtypes, flags = [], []
            reset()
            t0 = time.perf_counter()
            with attention_dtypes(dtypes, flags):
                metrics = kaggle.evaluate_kaggle(model32, kaggle_config, "validate")
            kaggle_s = time.perf_counter() - t0
        got = read()
        check(got == (n_videos * chunks * depth, 0, 0, 0) and set(dtypes) == {torch.float32},
              f"evaluate_kaggle launched {got} ({set(dtypes)}), expected {chunks * depth} float32 launches a video")
        check(set(flags) == {TF32_OFF}, f"evaluate_kaggle ran attention under the flags {set(flags)}")
        check(metrics["n_samples"] == n_videos and all(k in metrics for k in ("ef_mae", "ef_rmse", "ef_region_accuracy")),
              f"evaluate_kaggle {metrics}")
        out["kaggle"] = {"videos": n_videos, "ms_per_video": kaggle_s * 1e3 / n_videos, "f32_launches": got[0],
                         **metrics}
        print("kaggle", json.dumps(out["kaggle"]), f"on {smi}", flush=True)
        del model32

        # f. cinema_eval on the run folders of this phase and on an ED/ES one, float32 through the kernel
        # one forward a test volume (all its patches together), one a chunk of 8 frames of a cine
        per_item = ("metrics.csv", "mean_metrics.csv")
        evals = {name: cinema_eval(name, folder, "test", 2 * depth, per_item, "mean_dice_score")
                 for name, folder in (("emidec", emidec_dir), ("myops2020", myops_dir))}
        evals["rescan"] = cinema_eval("rescan", rescan_dir, "test", depth * -(-RESCAN_CINE[3] // 8), per_item,
                                      "mean_dice_score")
        evals["rescan_test_retest_100"] = cinema_eval(
            "rescan_test_retest_100", rescan_dir, "test_retest_100",
            n_retest * depth * -(-RESCAN_CINE[3] // kaggle.VIDEO_CHUNK), ("ef_metrics.csv", "mean_metrics.csv"),
            "n_pairs")
        # an ED/ES run folder of the packaged ACDC model as the JAX package leaves one, on two studies of one patch
        # (SEG_SIZES[0]) in the processed ACDC layout: its config.yaml is the JAX package's acdc.yaml (a data
        # file, read by the port's YAML reader) with data.dir set, beside the model safetensors
        acdc_dir = root / "runs" / "acdc"
        acdc_config = from_dict(PACKAGED["segmentation/acdc"])
        acdc_config.data.dir = str(root / "acdc")
        rng = np.random.default_rng(35)
        for i in range(2):
            write_seg_study(root / "acdc" / "test", f"patient{i:03d}", *seg_frames(rng, SEG_SIZES[0]))
        write_metadata(root / "acdc" / "test_metadata.csv",
                       [{"pid": f"patient{i:03d}", "n_slices": SEG_SIZES[0][2], "pathology": "NOR"} for i in range(2)])
        acdc_dir.mkdir(parents=True)
        default_dir = "  dir: ~/.cache/cinema_datasets/acdc/processed\n"
        check(ACDC_YAML.read_text().count(default_dir) == 1, f"{ACDC_YAML} has no single data.dir line")
        (acdc_dir / "config.yaml").write_text(ACDC_YAML.read_text().replace(default_dir, f"  dir: '{root / 'acdc'}'\n"))
        check(evaluate.run_config(acdc_dir) == acdc_config, "the ACDC run folder's config.yaml reads as another config")
        save_params_safetensors(init_weights(get_segmentation_model(acdc_config, device=cuda), seed=0),
                                acdc_dir / "model_0.safetensors")
        evals["acdc"] = cinema_eval("acdc", acdc_dir, "test", depth * 4, (*per_item, "ef_metrics.csv"),
                                    "mean_dice_score")
        out["cinema_eval"] = evals

    out["phase_s"] = time.perf_counter() - t_phase
    report["cine"] = out
    summary = {
        "write_s": out["write_s"],
        "ms_per_step": {k: out[k]["steps"]["ms_per_step"] for k in ("emidec", "myops2020")},
        "peak_mem_gib": {k: out[k]["steps"]["peak_mem_gib"] for k in ("emidec", "myops2020")},
        **({"idle_share": {k: out[k]["profile"]["idle_share"] for k in ("emidec", "myops2020")}} if profile else {}),
        "eval_ms": {k: out[k]["eval"]["ms"] for k in ("emidec", "myops2020")},
        "frame_seek_ms": {k: v["ms_per_frame"] for k, v in out["frame_seek"].items()},
        "rescan_fed_ms_per_step": out["rescan_fed"]["ms_per_step"],
        "rescan_fed_loader_wait_ms": out["rescan_fed"]["loader_wait_ms_per_step"],
        "run_s": {"emidec": out["emidec"]["run"]["seconds"], "myops2020": out["myops2020"]["run"]["seconds"],
                  "rescan": out["rescan_run"]["seconds"]},
        "rescan_ef_eval_ms_per_cine": out["rescan_ef_eval"]["ms_per_cine"],
        "kaggle_ms_per_video": out["kaggle"]["ms_per_video"],
        "cinema_eval_s": {k: v["seconds"] for k, v in out["cinema_eval"].items()},
        "f32_launches": sum(v["f32_launches"] for v in out["cinema_eval"].values()) + out["kaggle"]["f32_launches"],
        "phase_s": out["phase_s"],
    }
    print("cine", json.dumps(summary), f"on {smi}", flush=True)
    report["cine_summary"], report["cine_launches"] = summary, counters
    return counters


def write_baseline_studies(data_dir: Path, n: int, seed: int) -> None:
    """Seeded synthetic ED + ES studies in the processed ACDC layout (``seg_frames``; 192x192x16 and 224x208x10
    in turn) with ``train_metadata.csv``: ``pid``, ``n_slices``, ``pathology`` (DCM and NOR in pairs: each
    class holds n / 2 studies, two of them held out for validation) and an ``ef`` that follows the class."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        size = SEG_SIZES[i % 2]
        pid = f"patient{i:03d}"
        write_seg_study(data_dir / "train", pid, *seg_frames(rng, size))
        label = (i // 2) % 2
        rows.append({"pid": pid, "n_slices": size[2], "pathology": ("DCM", "NOR")[label],
                     "ef": round(float(25 + 30 * label + rng.normal()), 4)})
    write_metadata(data_dir / "train_metadata.csv", rows)


def check_against_the_cpu(label: str, build, state_dict: dict, loss_fn, batch: dict,
                          noise: frozenset = frozenset(), grad_dtype: torch.dtype = torch.float32) -> dict:
    """From the same weights (``state_dict`` into ``build(device, dtype)``), on the card against the CPU: the
    f32 logits in eval mode within BASELINE_LOGITS_RTOL of their largest; one train-mode step's f32 loss
    within TRAIN_LOSS_RTOL; its gradients, computed in ``grad_dtype`` on both devices, each within
    TRAIN_GRAD_RTOL of its parameter's largest entry, or for a bias that a norm removes (``noise``: zero
    gradient analytically, rounding noise on both sides) of its convolution's weight gradient's largest.

    ``grad_dtype`` float64 is for the ResNet, whose train-mode gradient at seeded weights is too ill-conditioned
    for the 1e-3 gate in float32 on any device: ``tools/resnet_grad_conditioning.py`` finds the CPU's own
    float32 gradient 21 % of a parameter's largest entry off its float64 one, and the float64 gradient 4.2 %
    off itself when every weight moves by 1e-7 relative (BatchNorm over batch statistics behind ReLU and
    max-pool switches; PERF.md section 6). The card's float32 gradient is then held as a witness against the
    CPU's float64 one: no parameter's further from it than RESNET_F32_WITNESS_FACTOR times the CPU's own
    float32 worst. That limit separates gross faults only (a gradient lost, its sign flipped, or off by a
    factor of 2: 1 or more of the largest); the float64 comparison holds the same code to 1e-3."""
    outputs, losses, grads, names = [], [], {}, None
    for device in (torch.device("cuda"), torch.device("cpu")):
        for dtype in dict.fromkeys((torch.float32, grad_dtype)):
            model = build(device, dtype).to(dtype)
            model.load_state_dict(state_dict)
            on_device = {k: v.to(device, dtype) if v.is_floating_point() else v.to(device) for k, v in batch.items()}
            if dtype == torch.float32:
                images = {k[: -len("_image")]: v for k, v in on_device.items() if k.endswith("_image")}
                with torch.no_grad():
                    out = model.eval()(images)
                outputs.append((torch.cat(list(out.values())) if isinstance(out, dict) else out).float().cpu())
            loss = loss_fn(model.train(), on_device)[0]
            if dtype == torch.float32:
                losses.append(loss.item())
            names = [name for name, _ in model.named_parameters()]
            grads[device.type, dtype] = [g.double().cpu() for g in torch.autograd.grad(loss, list(model.parameters()))]
    logits_err = (outputs[0] - outputs[1]).abs().max().item()
    logits_max = outputs[1].abs().max().item()

    def distances(got: list, ref: list) -> dict:
        """Each parameter's largest difference relative to its largest entry (a removed bias: to its
        convolution weight's)."""
        want = dict(zip(names, ref))
        return {name: ((a - b).abs().max() / (want[name[: -len("bias")] + "weight"] if name in noise else b)
                       .abs().max().clamp(min=1e-12)).item() for name, a, b in zip(names, got, ref)}

    errs = distances(grads["cuda", grad_dtype], grads["cpu", grad_dtype])
    worst = max(errs, key=errs.get)
    row = {"logits_max_abs_err": logits_err, "logits_max_abs": logits_max, "logits_rtol": BASELINE_LOGITS_RTOL,
           "loss": losses[0], "loss_cpu": losses[1], "grad_dtype": str(grad_dtype).split(".")[-1],
           "max_rel_grad_err": errs[worst], "worst_parameter": worst, "loss_rtol": TRAIN_LOSS_RTOL,
           "grad_rtol": TRAIN_GRAD_RTOL}
    if grad_dtype != torch.float32:
        cpu32 = distances(grads["cpu", torch.float32], grads["cpu", grad_dtype])
        card32 = distances(grads["cuda", torch.float32], grads["cpu", grad_dtype])
        row["f32_witness"] = {"cpu_f32_worst": max(cpu32.values()), "cpu_f32_worst_parameter": max(cpu32, key=cpu32.get),
                              "card_f32_worst": max(card32.values()), "card_f32_worst_parameter": max(card32, key=card32.get),
                              "limit": RESNET_F32_WITNESS_FACTOR * max(cpu32.values())}
    print(label, json.dumps(row), flush=True)
    check(logits_err <= BASELINE_LOGITS_RTOL * logits_max, f"{label}: f32 logits on the card differ from the CPU's")
    check(abs(losses[0] - losses[1]) <= TRAIN_LOSS_RTOL * abs(losses[1]), f"{label}: f32 losses differ")
    check(errs[worst] <= TRAIN_GRAD_RTOL, f"{label}: the gradient of {worst} differs by {errs[worst]} of its largest")
    if "f32_witness" in row:
        witness = row["f32_witness"]
        check(witness["card_f32_worst"] <= witness["limit"],
              f"{label}: the card's f32 gradient of {witness['card_f32_worst_parameter']} is "
              f"{witness['card_f32_worst']} of its largest off the CPU's {grad_dtype}, beyond {witness['limit']}")
    return row


def baseline_phase(report: dict, smi: str, profile: bool) -> dict:
    """The UNet and ResNet baselines at full width (bf16, batch 4) on synthetic ACDC studies: timed steps, a
    NaN batch, f32 logits and an f32 step on the card against the CPU's, a sliding-window study, a regression
    step and one epoch of two entry points' ``run``; no attention kernel is launched. Returns the phase's
    launch counts (all 0)."""
    import itertools

    from cinema_tpu_torch.config import PACKAGED, from_dict
    from cinema_tpu_torch.data import BatchLoader, EDESSegmentationDataset, read_metadata, to_device
    from cinema_tpu_torch.data.transforms import get_segmentation_transforms
    from cinema_tpu_torch.factory import get_segmentation_model, init_weights
    from cinema_tpu_torch.tasks.classification import acdc as clf_acdc
    from cinema_tpu_torch.tasks.classification import classification_loss_fn, get_classification_model
    from cinema_tpu_torch.tasks.regression import acdc as reg_acdc
    from cinema_tpu_torch.tasks.regression import regression_loss_fn
    from cinema_tpu_torch.tasks.segmentation import acdc as seg_acdc
    from cinema_tpu_torch.tasks.segmentation import (
        patch_and_spacing_dicts,
        segmentation_eval_batch,
        segmentation_loss_fn,
    )

    t_phase = time.perf_counter()
    launches = Launches()
    cuda = torch.device("cuda")
    batch_size, n_studies, n_timed = 4, 8, 6
    out = {}

    def baseline_config(task: str, data_dir: Path, runs: Path):
        config = from_dict(PACKAGED[task])
        config.model.name = "unet" if task.startswith("segmentation") else "resnet"
        config.data.dir, config.logging.dir = str(data_dir), str(runs)
        config.train.update(batch_size=batch_size, n_epochs=1, eval_interval=1)
        return config

    def loader_batches(entry, config, n: int) -> tuple:
        """The first ``n`` augmented training batches of the task on the card, and its (train, val) datasets."""
        train_ds, val_ds = entry.load_dataset(config)
        with BatchLoader(train_ds, batch_size, seed=config.seed, n_workers=config.train.n_workers) as loader:
            batches = [to_device(b, cuda) for b in itertools.islice(loader.epoch(0), n)]
        return batches, train_ds, val_ds

    with tempfile.TemporaryDirectory() as tmp:
        data_dir = Path(tmp) / "acdc"
        t0 = time.perf_counter()
        write_baseline_studies(data_dir, n_studies, seed=40)
        write_s = time.perf_counter() - t0
        configs = {task: baseline_config(task, data_dir, Path(tmp) / "runs")
                   for task in ("segmentation/acdc", "classification/acdc", "regression/acdc")}

        # a. UNet (chans 32-512, instance norm) on 192x192x16: timed steps, a NaN batch, f32 against the CPU
        seg_cfg = configs["segmentation/acdc"]
        seg_batches, _, _ = loader_batches(seg_acdc, seg_cfg, 2)
        unet = init_weights(get_segmentation_model(seg_cfg, dtype=torch.bfloat16, device=cuda), seed=seg_cfg.seed)
        # the stem's and each residual block's first convolution feed an instance norm, which removes their bias
        normed = frozenset(k for k in unet.state_dict() if k.endswith(("in_conv.conv.bias", "conv1.bias")))
        state, step_fn = supervised_step(seg_cfg, unet, segmentation_loss_fn)
        out["unet"] = timed_steps(launches, smi, "baseline_unet", unet, state, step_fn, seg_batches, n_timed,
                                  (0, 0, 0, 0), may_stay=normed)
        state = check_nan_batch("baseline_unet", launches, unet, state, step_fn, seg_batches[0], "sax_image")
        if profile:
            report["baseline_unet_profile"] = profile_call("baseline_unet_profile",
                                                           lambda: step_fn(state, seg_batches[0]), smi)
        exact = from_dict(seg_cfg)
        exact.model.unet.dropout = 0.0  # no dropout draws, which differ between the devices
        # a 96x96x16 crop of one item: the full width at a quarter of the voxels, for the CPU's sake
        crop = {k: seg_batches[0][k][:1, 48:144, 48:144] for k in ("sax_image", "sax_label")}
        out["unet_f32"] = check_against_the_cpu(
            "baseline_unet_f32", lambda d, dtype: get_segmentation_model(exact, dtype=dtype, device=d),
            unet.state_dict(), segmentation_loss_fn, crop, noise=normed)

        # b. one 224x208x10 study (ED and ES) evaluated by sliding window (four patches a frame)
        _, val_tf = get_segmentation_transforms(seg_cfg)
        studies = EDESSegmentationDataset(data_dir / "train", read_metadata(data_dir / "train_metadata.csv"), "sax",
                                          val_tf)
        patch_size_dict, spacing_dict = patch_and_spacing_dicts(seg_cfg)
        first = next(i for i in range(0, len(studies), 2) if int(studies.load(i, 0)["sax_width"]) == 224)
        items = [{k: v[None] for k, v in studies.load(i, 0).items() if k != "pid"} for i in (first, first + 1)]
        unet.eval()

        def evaluate_study() -> list:
            return [segmentation_eval_batch(unet, {**item, **to_device({k: item[k] for k in ("sax_image", "sax_label")},
                                                                       cuda)},
                                            patch_size_dict, spacing_dict, z_bucket=4)[1] for item in items]

        with torch.no_grad():
            evaluate_study()  # warm-up
            torch.cuda.synchronize()
            launches.reset()
            t0 = time.perf_counter()
            rows = evaluate_study()
            study_s = time.perf_counter() - t0
        check(launches.read() == (0, 0, 0, 0), "the evaluated UNet study launched an attention kernel")
        check(all(0.0 <= r["mean_dice_score"] <= 1.0 for r in rows), f"UNet evaluation of a 224x208x10 study: {rows}")
        out["unet_eval"] = {"size": [224, 208, 10], "ms_per_study": study_s * 1e3,
                            "mean_dice_score": [r["mean_dice_score"] for r in rows]}
        print("baseline_unet_eval", json.dumps(out["unet_eval"]), f"on {smi}", flush=True)
        del unet, state, step_fn

        # c. ResNet classification (ED and ES as two channels, basic blocks [3, 4, 6, 3]) on 192x192x16: timed
        # steps, a NaN batch (its running statistics too: they are in the state_dict), f32 against the CPU;
        # then one regression step
        clf_cfg = configs["classification/acdc"]
        clf_batches, _, _ = loader_batches(clf_acdc, clf_cfg, 1)
        resnet = init_weights(get_classification_model(clf_cfg, dtype=torch.bfloat16, device=cuda), seed=clf_cfg.seed)
        state, step_fn = supervised_step(clf_cfg, resnet, classification_loss_fn)
        stats = {k: v.clone() for k, v in resnet.state_dict().items() if "running" in k}
        out["resnet_clf"] = timed_steps(launches, smi, "baseline_resnet_clf", resnet, state, step_fn, clf_batches,
                                        n_timed, (0, 0, 0, 0))
        check(all(not torch.equal(v, resnet.state_dict()[k]) for k, v in stats.items()),
              "the ResNet steps left a running statistic as it was")
        state = check_nan_batch("baseline_resnet_clf", launches, resnet, state, step_fn, clf_batches[0], "sax_image")
        if profile:
            report["baseline_resnet_profile"] = profile_call("baseline_resnet_profile",
                                                             lambda: step_fn(state, clf_batches[0]), smi)
        out["resnet_clf_f32"] = check_against_the_cpu(
            "baseline_resnet_clf_f32", lambda d, dtype: get_classification_model(clf_cfg, dtype=dtype, device=d),
            resnet.state_dict(), classification_loss_fn, {k: v[:2] for k, v in clf_batches[0].items()},
            grad_dtype=torch.float64)
        del resnet, state, step_fn

        reg_cfg = configs["regression/acdc"]
        reg_batches, _, _ = loader_batches(reg_acdc, reg_cfg, 1)
        resnet = init_weights(get_classification_model(reg_cfg, dtype=torch.bfloat16, device=cuda), seed=reg_cfg.seed)
        state, step_fn = supervised_step(reg_cfg, resnet, regression_loss_fn)
        launches.reset()
        state, metrics = step_fn(state, reg_batches[0])
        check(launches.read() == (0, 0, 0, 0), "the ResNet regression step launched an attention kernel")
        out["resnet_reg"] = {"loss": float(metrics["loss"]), "skipped_nan": float(metrics["skipped_nan"])}
        check(np.isfinite(out["resnet_reg"]["loss"]) and out["resnet_reg"]["skipped_nan"] == 0.0,
              f"ResNet regression step {out['resnet_reg']}")
        print("baseline_resnet_reg", json.dumps(out["resnet_reg"]), f"on {smi}", flush=True)
        del resnet, state, step_fn

        # d. one epoch of run of each, evaluated once; its checkpoint and safetensors reloaded
        runs = {}
        for task, entry, build, loss_fn, val_keys in (
                ("segmentation/acdc", seg_acdc, get_segmentation_model, segmentation_loss_fn, ("val_mean_dice_score",)),
                ("classification/acdc", clf_acdc, get_classification_model, classification_loss_fn, ("val_accuracy",))):
            cfg = configs[task]
            train_ds, val_ds = entry.load_dataset(cfg)
            steps = len(train_ds) // batch_size
            image = torch.from_numpy(val_ds.load(0, 0)["sax_image"][None]).to(cuda)
            launches.reset()
            t0 = time.perf_counter()
            out_dir = entry.run(cfg, device="cuda")
            run_s = time.perf_counter() - t0
            check(launches.read() == (0, 0, 0, 0), f"the {task} {cfg.model.name} run launched an attention kernel")
            runs[task] = {"model": cfg.model.name, "seconds": run_s, "steps": steps, "evaluated": len(val_ds),
                          **check_run_and_reload(f"{task} {cfg.model.name}", cfg, out_dir,
                                                 lambda: build(cfg, dtype=torch.bfloat16, device=cuda),
                                                 lambda m: supervised_step(cfg, m, loss_fn), steps, {"sax": image},
                                                 val_keys)}
            print(f"baseline_run {task}", json.dumps(runs[task]), f"on {smi}", flush=True)
        out["runs"] = runs
    check(all(n == 0 for n in launches.totals.values()), f"the baselines launched attention kernels: {launches.totals}")
    report["baselines"] = {
        "write_s": write_s,
        **{k: {m: out[k][m] for m in ("ms_per_step", "samples_per_s", "peak_mem_gib")} for k in ("unet", "resnet_clf")},
        **({"unet_idle_share": report["baseline_unet_profile"]["idle_share"],
            "resnet_idle_share": report["baseline_resnet_profile"]["idle_share"]} if profile else {}),
        "unet_eval_ms_per_study": out["unet_eval"]["ms_per_study"],
        "run_s": {k: v["seconds"] for k, v in out["runs"].items()},
        "launches": launches.totals,
        "phase_s": time.perf_counter() - t_phase,
    }
    report["baseline_detail"] = out
    print("baselines", json.dumps(report["baselines"]), f"on {smi}", flush=True)
    return launches.totals


def write_example_acdc(data_dir: Path, n: int, n_classes: int, seed: int) -> None:
    """Seeded synthetic ACDC studies for the training tutorials: ED and ES SAX frames of 192x192x16 with
    labels (``seg_frames``) and ``train_metadata.csv`` with ``pid``, ``n_slices``, ``pathology`` (the first
    ``n_classes`` classes in turn: the tutorials hold two studies of each out) and ``ef``."""
    from cinema_tpu_torch.config import PACKAGED

    classes = PACKAGED["classification/acdc"]["data"]["pathology"][:n_classes]
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        pid = f"patient{i:03d}"
        write_seg_study(data_dir / "train", pid, *seg_frames(rng, (192, 192, 16)))
        label = i % n_classes
        rows.append({"pid": pid, "n_slices": 16, "pathology": classes[label], "ef": round(float(20 + 8 * label), 4)})
    write_metadata(data_dir / "train_metadata.csv", rows)


def examples_phase(report: dict, smi: str) -> dict:
    """The example scripts at full width, from seeded weights written as a user has them (a safetensors file and
    a config.yaml beside it): ``segmentation_sax`` and ``serve`` (NIfTI in and out) each in a process of its own,
    the other inference examples and the four training tutorials in this one through ``main(argv)``, each
    output held to the same model called in this process. Returns the packed kernels' launches of the path."""
    import io

    from cinema_tpu_torch import viz
    from cinema_tpu_torch.config import PACKAGED, from_dict, load_config, save_config
    from cinema_tpu_torch.convert import load_safetensors, save_safetensors
    from cinema_tpu_torch.data import load_nifti, save_nifti
    from cinema_tpu_torch.examples.inference import (
        classification_cvd,
        edes,
        landmark_coordinate,
        landmark_heatmap,
        mae,
        mae_feature_extraction,
        regression_ef,
        segmentation_lax_4c,
    )
    from cinema_tpu_torch.examples.train import classification, pretrain, regression, segmentation
    from cinema_tpu_torch.factory import (
        from_finetuned,
        get_convunetr_model,
        get_convvit_model,
        get_mae_model,
        get_segmentation_model,
        init_weights,
        mae_from_pretrained,
    )
    from cinema_tpu_torch.metrics import heatmap_argmax
    from cinema_tpu_torch.serve import segment_cine
    from cinema_tpu_torch.tasks.classification import get_classification_model

    t_phase = time.perf_counter()
    launches = Launches()
    cuda = torch.device("cuda")
    rng = np.random.default_rng(12)
    scripts, out = {}, {}

    def save_model(folder: Path, model, config: dict) -> list:
        """The model's weights and its config.yaml in ``folder``; returns the scripts' --model/--config."""
        folder.mkdir(parents=True)
        save_safetensors(folder / "model.safetensors", {k: v.float().cpu().numpy() for k, v in model.state_dict().items()})
        save_config(config, folder / "config.yaml")  # the JAX package's save_config bytes
        check(load_config(folder / "config.yaml") == config, f"{folder / 'config.yaml'} reads back as another config")
        return ["--model", str(folder / "model.safetensors"), "--config", str(folder / "config.yaml")]

    def run_main(name: str, main, argv: list):
        """``main(argv)`` on the card with its launches counted and its printout kept; returns its result."""
        stdout = io.StringIO()
        torch.cuda.synchronize()
        launches.reset()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout):
            result = main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = launches.read()
        scripts.setdefault(name, {}).update(main_s=seconds, launches=list(got))
        print(f"example {name}: {seconds:.2f} s, launches {got}: " + " | ".join(stdout.getvalue().splitlines()[-3:]),
              flush=True)
        return result, stdout.getvalue()

    def load_and_first_forward(name: str, load, forward):
        """The in-process model (its load timed) and its first forward (timed), as the script loads and runs it."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = load()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.no_grad():
            result = forward(model)
        torch.cuda.synchronize()
        scripts.setdefault(name, {}).update(load_s=t1 - t0, first_forward_s=time.perf_counter() - t1)
        return model, result

    def close(got, want, what: str, rtol: float = 1e-3):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        err = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))
        check(got.shape == want.shape and err <= rtol, f"{what}: {got.shape} against {want.shape}, rel err {err}")
        return err

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # a. segmentation_sax and serve, each in a process of its own, on a 192x192x16x30 SAX cine
        sax_config = PACKAGED["segmentation/acdc"]
        sax_args = save_model(tmp / "seg_sax", init_weights(get_convunetr_model(from_dict(sax_config),
                                                                                dtype=torch.bfloat16, device=cuda),
                                                            seed=12), sax_config)
        image, _ = seg_frames(rng, (192, 192, 16), scales=tuple(1.0 - 0.15 * np.sin(np.pi * t / 30) for t in range(30)))
        spacing = (1.25, 1.25, 8.0, 1.0)
        save_nifti(tmp / "sax_t.nii.gz", image, spacing=spacing)
        model, labels = load_and_first_forward("segmentation_sax", lambda: from_finetuned(
            "convunetr", sax_args[1], sax_args[3], dtype=torch.bfloat16, device=cuda), lambda m: segment_cine(m, image))
        del model
        # the two processes run at once, as two users' would: each is mostly host work (its start, the model's
        # build, the files, the GIF) beside ~1 s on the card
        commands = {
            # --t_step 2: the GIF of every other frame, its LZW (in Python) half as long
            "segmentation_sax": (["-m", "cinema_tpu_torch.examples.inference.segmentation_sax", *sax_args,
                                  "--image", str(tmp / "sax_t.nii.gz"), "--out", str(tmp / "sax_out"),
                                  "--t_step", "2"],
                                 tmp / "sax_out" / "segmentation_sax_t.nii.gz"),
            "serve_nifti": (["-m", "cinema_tpu_torch.serve", "--config", sax_args[3], "--model", sax_args[1],
                             "--video", str(tmp / "sax_t.nii.gz"), "--out", str(tmp / "served.nii.gz")],
                            tmp / "served.nii.gz"),
        }
        procs = {}
        try:
            for name, (argv, _) in commands.items():
                with open(tmp / f"{name}.out", "w") as out, open(tmp / f"{name}.err", "w") as err:
                    procs[name] = (subprocess.Popen([sys.executable, *argv], cwd=ROOT, stdout=out, stderr=err),
                                   time.perf_counter())
            seconds, deadline = {}, time.perf_counter() + 600
            while len(seconds) < len(procs) and time.perf_counter() < deadline:
                for name, (proc, t0) in procs.items():
                    if name not in seconds and proc.poll() is not None:
                        seconds[name] = time.perf_counter() - t0
                time.sleep(0.05)
        finally:
            for proc, _ in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for name, (proc, _) in procs.items():
            check(proc.returncode == 0, f"{name} exited {proc.returncode}: {(tmp / f'{name}.err').read_text()[-3000:]}")
            got, header = load_nifti(commands[name][1])
            check(got.shape == image.shape and got.dtype == np.uint8, f"{name} labels {got.shape} {got.dtype}")
            check(header.spacing == spacing, f"{name} wrote spacing {header.spacing}, the input has {spacing}")
            agree = float((got == labels).mean())
            # the same bf16 weights and kernels in two processes; cuDNN may pick other convolution algorithms there
            check(agree >= 0.999, f"{name} labels agree with this process's segment_cine on {agree:.6f} of the voxels")
            scripts.setdefault(name, {}).update(process_s=seconds[name], label_agreement=agree,
                                                stdout=(tmp / f"{name}.out").read_text().strip().splitlines()[-2:])
        gif = (tmp / "sax_out" / "segmentation_sax.gif").read_bytes()
        png = (tmp / "sax_out" / "ventricle_volumes.png").read_bytes()
        check(gif.startswith(b"GIF89a") and png.startswith(b"\x89PNG\r\n\x1a\n"), "segmentation_sax's GIF or PNG")
        check(any(line.startswith("LVEF = ") for line in scripts["segmentation_sax"]["stdout"]), "no LVEF printed")
        scripts["segmentation_sax"].update(gif_bytes=len(gif), png_bytes=len(png))

        parts_s = {"processes": time.perf_counter() - t_phase}
        # b. segmentation_lax_4c: ConvUNetR-base on lax_4c 256x256, 30 frames in one forward
        lax_config = from_dict(sax_config)
        lax_config.model.views = "lax_4c"
        lax_config.data.lax = {"spacing": [1.0, 1.0], "patch_size": [256, 256], "in_chans": 1}
        lax_args = save_model(tmp / "seg_lax", init_weights(get_segmentation_model(lax_config, dtype=torch.bfloat16,
                                                                                  device=cuda), seed=13), lax_config)
        video = rng.integers(0, 200, size=(256, 256, 1, 30)).astype(np.uint8)
        video[96:160, 100:170] += 50
        save_nifti(tmp / "lax_t.nii.gz", video, spacing=(1.4, 1.4, 8.0, 1.0))
        model, (_, lax_labels) = load_and_first_forward("segmentation_lax_4c", lambda: from_finetuned(
            "convunetr", lax_args[1], lax_args[3], dtype=torch.bfloat16, device=cuda),
            lambda m: segmentation_lax_4c.segment_lax(m, video))
        del model
        run_main("segmentation_lax_4c", segmentation_lax_4c.main, [*lax_args, "--image", str(tmp / "lax_t.nii.gz"),
                                                                   "--out", str(tmp / "lax_out")])
        got, header = load_nifti(tmp / "lax_out" / "segmentation_lax_4c_t.nii.gz")
        agree = float((got == lax_labels).mean())
        check(got.shape == (256, 256, 1, 30) and agree >= 0.999, f"segmentation_lax_4c {got.shape}, agreement {agree}")
        check(header.spacing == (1.4, 1.4, 8.0, 1.0) or np.allclose(header.spacing, (1.4, 1.4, 8.0, 1.0)),
              f"segmentation_lax_4c spacing {header.spacing}")
        scripts["segmentation_lax_4c"]["label_agreement"] = agree

        # c. classification_cvd and regression_ef: ConvViT-base, ED and ES of 192x192x16 as channels
        for frame in ("ed", "es"):
            save_nifti(tmp / f"{frame}.nii.gz", seg_frames(rng, (192, 192, 16))[0][..., 0], spacing=(1.25, 1.25, 10.0))
        for name, main, task in (("classification_cvd", classification_cvd.main, "classification"),
                                 ("regression_ef", regression_ef.main, "regression")):
            config = PACKAGED[f"{task}/acdc"]
            args = save_model(tmp / name, init_weights(get_convvit_model(from_dict(config), dtype=torch.bfloat16,
                                                                         device=cuda), seed=14), config)
            study = edes.edes_image(tmp / "ed.nii.gz", tmp / "es.nii.gz", (192, 192, 16))
            _, want = load_and_first_forward(name, lambda a=args: from_finetuned(
                "convvit", a[1], a[3], dtype=torch.bfloat16, device=cuda), lambda m, t=task: edes.edes_forward(m, t, study))
            got, _ = run_main(name, main, [*args, "--ed", str(tmp / "ed.nii.gz"), "--es", str(tmp / "es.nii.gz")])
            got = np.asarray(got, np.float64).reshape(-1)
            scripts[name].update(output=got.tolist(), rel_err=close(got, np.reshape(want, -1), name))

        # d. the landmark pair on 256x256 PNGs written by viz.write_png (gray and RGB)
        image = rng.integers(0, 80, size=(256, 256)).astype(np.uint8)
        for cx, cy in ((60, 80), (128, 200), (190, 100)):
            image[cx - 4 : cx + 4, cy - 4 : cy + 4] = 230
        viz.write_png(tmp / "lax_2c.png", image.T)  # rows are y
        viz.write_png(tmp / "lax_2c_rgb.png", np.repeat(image.T[..., None], 3, axis=-1))
        heat_config = PACKAGED["segmentation/landmark"]
        heat_args = save_model(tmp / "lmk_heat", init_weights(get_segmentation_model(from_dict(heat_config),
                                                                                    dtype=torch.bfloat16, device=cuda),
                                                             seed=15), heat_config)
        png_image, size = landmark_heatmap.png_input(tmp / "lax_2c.png", (256, 256))
        model, logits = load_and_first_forward("landmark_heatmap", lambda: from_finetuned(
            "convunetr", heat_args[1], heat_args[3], dtype=torch.bfloat16, device=cuda),
            lambda m: landmark_heatmap.heatmap_logits(m, png_image, size))
        del model
        host = logits.float().cpu()
        want = heatmap_argmax(host)[0].reshape(3, 2).numpy()
        ties = 0
        for png in ("lax_2c.png", "lax_2c_rgb.png"):
            got, _ = run_main("landmark_heatmap", landmark_heatmap.main, [*heat_args, "--image", str(tmp / png)])
            for c in range(3):
                if tuple(got[c]) != tuple(want[c]):  # a tie: the two maxima hold the same logit
                    check(bool(host[0, got[c][0], got[c][1], c] == host[0, want[c][0], want[c][1], c]),
                          f"landmark_heatmap {png} channel {c}: {got[c]} against this process's {want[c]}")
                    ties += 1
        scripts["landmark_heatmap"].update(coords=got.tolist(), ties=ties)

        coord_config = PACKAGED["regression/landmark"]
        coord_args = save_model(tmp / "lmk_coord", init_weights(get_classification_model(
            from_dict(coord_config), dtype=torch.bfloat16, device=cuda), seed=16), coord_config)
        model, out_coord = load_and_first_forward("landmark_coordinate", lambda: from_finetuned(
            "convvit", coord_args[1], coord_args[3], dtype=torch.bfloat16, device=cuda),
            lambda m: m({"lax_2c": torch.from_numpy(png_image).to(cuda)}).float().cpu().numpy())
        del model
        scaled = out_coord[0].reshape(3, 2) * np.array(size)
        got, _ = run_main("landmark_coordinate", landmark_coordinate.main, [*coord_args, "--image", str(tmp / "lax_2c.png")])
        # within one bf16 rounding of the scaled output (2^-8 relative, at least one pixel) and the truncation
        diff = np.abs(got - scaled)
        check(bool((diff <= np.maximum(np.abs(scaled) * 2.0**-8, 1.0) + 1.0).all()),
              f"landmark_coordinate {got.tolist()} against this process's {scaled.tolist()}")
        scripts["landmark_coordinate"].update(coords=got.tolist(), max_abs_diff=float(diff.max()))

        # e. mae and mae_feature_extraction: CineMA-base, four views, a study of 3 frames
        mae_config = PACKAGED["mae"]
        mae_args = save_model(tmp / "mae", init_weights(get_mae_model(from_dict(mae_config), dtype=torch.bfloat16,
                                                                      device=cuda), seed=17), mae_config)
        study = tmp / "1000001_2"
        study.mkdir()
        sizes = {"sax": (192, 192, 16), "lax_2c": (256, 256), "lax_3c": (256, 256), "lax_4c": (256, 256)}
        for view, view_size in sizes.items():
            shape = (*view_size, 1) if len(view_size) == 2 else view_size
            save_nifti(study / f"{study.name}_{view}_t.nii.gz", rng.integers(0, 255, size=(*shape, 3)).astype(np.uint8),
                       spacing=(1.0, 1.0, 10.0, 1.0), frame_indexed=True)
        mae_model, images = load_and_first_forward("mae", lambda: mae_from_pretrained(
            mae_args[1], mae_args[3], dtype=torch.bfloat16, device=cuda), lambda m: mae.study_images(m, study))
        result, _ = run_main("mae", mae.main, [*mae_args, "--study_dir", str(study), "--out", str(tmp / "mae_out")])
        loss, _, masks, recons, _ = mae.reconstruct(mae_model, images, 0.75, result[2])
        scripts["mae"].update(loss=float(result[0]), loss_rel_err=close(float(result[0]), float(loss), "mae loss"))
        for view in sizes:
            close(np.load(tmp / "mae_out" / f"recon_{view}.npy"), recons[view], f"mae recon_{view}.npy")
        check((tmp / "mae_out" / "mae_reconstruction.png").read_bytes()[:4] == b"\x89PNG", "no MAE reconstruction PNG")
        feats, _ = run_main("mae_feature_extraction", mae_feature_extraction.main,
                            [*mae_args, "--study_dir", str(study), "--out", str(tmp / "features.npz")])
        with torch.no_grad():
            want = mae_model.feature_forward({v: torch.from_numpy(x).to(cuda) for v, x in images.items()})
        check(sorted(np.load(tmp / "features.npz").files) == sorted(["cls", *sizes]), "the features' keys")
        for key, value in want.items():
            close(feats[key], value.float().cpu().numpy(), f"mae_feature_extraction {key}")
        scripts["mae_feature_extraction"]["shapes"] = {k: list(v.shape) for k, v in feats.items()}
        del mae_model

        parts_s["in_process"] = time.perf_counter() - t_phase - parts_s["processes"]
        # f. the four training tutorials, one short epoch each on synthetic data
        acdc = tmp / "acdc"
        write_example_acdc(acdc, 12, 3, seed=18)  # 6 held out, 6 to train on: one or two steps of 4
        ukb = tmp / "ukb"
        ukb.mkdir()
        write_ukb_studies(ukb, 8, {"sax": (192, 192, 16), "lax_2c": (256, 256), "lax_3c": (256, 256),
                                   "lax_4c": (256, 256)}, 4, seed=19)
        for name, main, task, data_dir in (("train_classification", classification.main, "classification/acdc", acdc),
                                           ("train_regression", regression.main, "regression/acdc", acdc),
                                           ("train_segmentation", segmentation.main, "segmentation/acdc", acdc),
                                           ("train_pretrain", pretrain.main, "mae", ukb)):
            overrides = ["train.batch_size_per_device=4", "train.eval_interval=1", f"logging.dir={tmp / name}"]
            _, printed = run_main(name, main, ["--data_dir", str(data_dir), "--n_epochs", "1", *overrides])
            loss = float(printed.split("train loss ")[1].split()[0])
            check(np.isfinite(loss), f"{name}: train loss {loss}")
            path = tmp / name / ("last.safetensors" if task == "mae" else "best.safetensors")
            config = from_dict(PACKAGED[task])
            build = {"mae": get_mae_model, "segmentation/acdc": get_segmentation_model}.get(task, get_classification_model)
            model = build(config, dtype=torch.bfloat16, device=cuda)
            model.load_state_dict({k: torch.from_numpy(v) for k, v in load_safetensors(path).items()}, strict=True)
            scripts[name].update(loss=loss, reloaded=str(path.name))
            del model
            check(scripts[name]["launches"][0] > 0 and scripts[name]["launches"][1] > 0,
                  f"{name} launched no packed forward or backward kernel: {scripts[name]['launches']}")
    check(launches.totals["packed_fwd"] > 0 and launches.totals["packed_bwd"] > 0,
          f"the examples launched no packed kernel: {launches.totals}")
    phase_s = time.perf_counter() - t_phase
    parts_s["tutorials"] = phase_s - parts_s["processes"] - parts_s["in_process"]
    report["examples"] = {"scripts": scripts, "launches": launches.totals, "parts_s": parts_s, "phase_s": phase_s}
    print("examples", json.dumps(report["examples"]), f"on {smi}", flush=True)
    return launches.totals


# --- 13. preprocess: the offline preprocessing CLIs on seeded raw trees ---------------------------------------
#
# Each raw tree is written by a seeded writer below, in the layout of the download or export that the CLI reads.
# The writers draw from np.random.RandomState (a stream that numpy keeps across versions) and use only + - * /
# and comparisons on floats, so the same seed writes the same bytes on every machine. tests/fixtures/
# preprocess_jax/<cli>/ holds what the JAX package's CLI writes from each small tree (the CPU tests regenerate
# it and hold the port's CLIs to it); this phase holds the port's CLIs, run on the card's machine, to it.

PREPROCESS_FIXTURES = ROOT / "tests" / "fixtures" / "preprocess_jax"
# the classes of the shells of raw_heart (1 LV cavity, 2 myocardium, 3 RV, as M&Ms numbers them) as ACDC
# numbers them (3 LV, 2 myocardium, 1 RV)
ACDC_RAW_CLASSES = np.array([0, 3, 2, 1], np.uint8)
# the real-size cells of the phase: one ACDC study as ACDC ships it, one UKB eid of DICOM
ACDC_REAL = {"size": (216, 256, 10), "n_frames": 30, "spacing": (1.5625, 1.5625, 10.0)}
UKB_REAL = {"rows": 208, "cols": 210, "n_sax": 10, "n_frames": 50, "pixel_spacing": 1.8, "noise": 20}


def raw_heart(rs: np.random.RandomState, size: tuple, scales: tuple, noise: int = 1) -> tuple:
    """(image float32 (x, y, z, t), label uint8 (x, y, z, t)) of a seeded synthetic heart: per frame three nested
    ellipsoids at a seeded centre, their radii times the frame's scale, the LV cavity (1) inside the myocardium
    (2) and the RV (3) beside it; the image is a level per class plus integer noise in [-noise, noise]."""
    axes = np.meshgrid(*(np.arange(s, dtype=np.float64) for s in size), indexing="ij")
    centre = np.array(size, np.float64) * (0.45 + rs.uniform(-0.04, 0.04, 3) * (1, 1, 0.2))
    radii = np.array(size, np.float64) * (rs.uniform(0.15, 0.2), rs.uniform(0.15, 0.2), 0.45)
    rv_radii = radii * (0.8, 1.2, 1.0)
    labels = []
    for scale in scales:
        lv = sum(((a - c) / (r * scale)) ** 2 for a, c, r in zip(axes, centre, radii))
        rv_centre = centre + (1.3 * radii[0] * scale, 0, 0)
        rv = sum(((a - c) / (r * scale)) ** 2 for a, c, r in zip(axes, rv_centre, rv_radii))
        label = np.zeros(size, np.uint8)
        label[rv < 1] = 3
        label[lv < 1] = 2
        label[lv < 0.36] = 1
        labels.append(label)
    label = np.stack(labels, axis=-1)
    image = np.array([30, 220, 110, 165], np.float32)[label] + rs.randint(-noise, noise + 1, label.shape)
    return image.astype(np.float32), label


def cycle(n_frames: int) -> tuple:
    """The scale of each frame of a cardiac cycle: 1 at frame 0 (ED), 0.85 at frame n/2 (ES), linear between."""
    return tuple(1.0 - 0.15 * min(t, n_frames - t) / (n_frames / 2) for t in range(n_frames))


def write_raw_nifti(path: Path, array: np.ndarray, spacing: tuple, **kwargs) -> None:
    """``save_nifti`` of a raw input, gzipped at level 1 where the path ends in ``.gz``: a reader takes any
    level, and the writers' time stays small at the real sizes (level 9, the preprocessing's own, writes the
    float32 volumes of this phase at about 1 MB/s)."""
    import gzip

    from cinema_tpu_torch.data import save_nifti

    if not str(path).endswith(".gz"):
        save_nifti(path, array, spacing=spacing, **kwargs)
        return
    plain = path.with_suffix("")  # .nii
    save_nifti(plain, array, spacing=spacing, **kwargs)
    path.write_bytes(gzip.compress(plain.read_bytes(), compresslevel=1, mtime=0))
    plain.unlink()


def write_raw_acdc(root: Path, seed: int, size: tuple = (40, 36, 6), n_frames: int = 4,
                   spacing: tuple = (1.5, 1.25, 5.0), n_train: int = 2, n_test: int = 1) -> None:
    """ACDC as it ships: ``{training,testing}/patientNNN/`` with ``Info.cfg`` (ED and ES 1-based, Group, Height
    as an integer for one study and a float for another, Weight, NbFrame), the float cine ``_4d.nii.gz`` and the
    ED and ES frames ``_frameNN.nii.gz`` with their ``_gt`` labels (3 LV, 2 myocardium, 1 RV)."""
    rs = np.random.RandomState(seed)
    for split, n in (("training", n_train), ("testing", n_test)):
        for i in range(n):
            pid = f"patient{1 + i + 100 * (split == 'testing'):03d}"
            d = root / split / pid
            d.mkdir(parents=True)
            image, label = raw_heart(rs, size, cycle(n_frames))
            ed, es = 1, n_frames // 2 + 1
            write_raw_nifti(d / f"{pid}_4d.nii.gz", image, spacing=(*spacing, 1.0))
            for idx in (ed, es):
                write_raw_nifti(d / f"{pid}_frame{idx:02d}.nii.gz", image[..., idx - 1], spacing=spacing)
                write_raw_nifti(d / f"{pid}_frame{idx:02d}_gt.nii.gz", ACDC_RAW_CLASSES[label[..., idx - 1]],
                                spacing=spacing)
            (d / "Info.cfg").write_text(f"ED: {ed}\nES: {es}\nGroup: {('DCM', 'NOR', 'MINF')[i % 3]}\n"
                                        f"Height: {'184.0' if i % 2 == 0 else 171}\nNbFrame: {n_frames}\n"
                                        f"Weight: {70 + 5 * i}.0\n")


def write_raw_mnms(root: Path, seed: int, size: tuple = (40, 36, 5), n_frames: int = 4) -> None:
    """M&Ms as it ships: the information table (an unnamed index column first; Age empty for one study, so that
    pandas reads the column as floats; one study without a folder) and ``Training/Labeled``, ``Validation`` and
    ``Testing`` folders of ``<pid>/<pid>_sa.nii.gz`` float cines with ``_sa_gt`` labels at ED and ES only."""
    rs = np.random.RandomState(seed)
    splits = {"Training/Labeled": ["A0S9V9", "A1D0Q7"], "Validation": ["B3D0N1"], "Testing": ["C8J7L5"]}
    lines = [",External code,VendorName,Vendor,Centre,ED,ES,Age,Pathology,Sex,Height,Weight"]
    ed, es = 0, n_frames // 2
    for i, pid in enumerate([*(p for pids in splits.values() for p in pids), "D9X9X9"]):
        age = "" if i == 1 else str(50 + 3 * i)
        lines.append(f"{i},{pid},Siemens,A,{1 + i % 3},{ed},{es},{age},{('HCM', 'NOR', 'DCM')[i % 3]},"
                     f"{'MF'[i % 2]},{170.5 + i},{80 + i}")
    (root / "211230_M&Ms_Dataset_information_diagnosis_opendataset.csv").parent.mkdir(parents=True, exist_ok=True)
    (root / "211230_M&Ms_Dataset_information_diagnosis_opendataset.csv").write_text("\n".join(lines) + "\n")
    for sub, pids in splits.items():
        for pid in pids:
            image, label = raw_heart(rs, size, cycle(n_frames))
            label[..., [t for t in range(n_frames) if t not in (ed, es)]] = 0
            (root / sub / pid).mkdir(parents=True)
            write_raw_nifti(root / sub / pid / f"{pid}_sa.nii.gz", image, spacing=(1.25, 1.25, 10.0, 1.0))
            write_raw_nifti(root / sub / pid / f"{pid}_sa_gt.nii.gz", label, spacing=(1.25, 1.25, 10.0, 1.0))


def write_raw_mnms2(root: Path, seed: int, size: tuple = (40, 36, 5), lax_size: tuple = (48, 44, 1)) -> None:
    """M&Ms-2 as it ships: ``dataset_information.csv`` (one row with an empty field, which the CLI drops, in an
    integer column that pandas then reads as floats) and ``dataset/<pid>/<pid>_{SA,LA}_{ED,ES}.nii.gz`` with
    ``_gt`` labels (1 LV, 2 myocardium, 3 RV), a study in each of the train, val and test pid ranges."""
    rs = np.random.RandomState(seed)
    lines = ["SUBJECT_CODE,DISEASE,VENDOR,SCANNER,FIELD,AGE"]
    for pid, age in ((1, "54"), (2, ""), (161, "61"), (201, "70")):
        lines.append(f"{pid},{'NOR' if pid % 2 else 'LV'},{'SIEMENS' if pid < 200 else 'GE'},Avanto,1.5,{age}")
        if age == "":
            continue  # dropped by the CLI: no folder
        d = root / "dataset" / str(pid)
        d.mkdir(parents=True)
        image, label = raw_heart(rs, size, (1.0, 0.85))
        lax, lax_label = raw_heart(rs, lax_size, (1.0, 0.85))
        for f, tag in enumerate(("ED", "ES")):
            write_raw_nifti(d / f"{pid}_SA_{tag}.nii.gz", image[..., f], spacing=(1.25, 1.25, 10.0))
            write_raw_nifti(d / f"{pid}_SA_{tag}_gt.nii.gz", label[..., f], spacing=(1.25, 1.25, 10.0))
            write_raw_nifti(d / f"{pid}_LA_{tag}.nii.gz", lax[..., f], spacing=(1.5, 1.5, 8.0))
            write_raw_nifti(d / f"{pid}_LA_{tag}_gt.nii.gz", lax_label[..., f], spacing=(1.5, 1.5, 8.0))
    (root / "dataset_information.csv").write_text("\n".join(lines) + "\n")


def write_raw_emidec(root: Path, seed: int, size: tuple = (36, 40, 5)) -> None:
    """EMIDEC as it ships: ``Case <pid>.txt`` clinical fields and ``Case_<pid>/{Images,Contours}/Case_<pid>.nii.gz``
    (labels 0-4: cavity, myocardium, infarct, no-reflow), a normal and a pathological case."""
    rs = np.random.RandomState(seed)
    root.mkdir(parents=True, exist_ok=True)
    for i, pid in enumerate(("N001", "P002")):
        image, shells = raw_heart(rs, size, (1.0,))
        label = np.where(shells[..., 0] == 3, 0, shells[..., 0]).astype(np.uint8)
        label[(label == 2) & (np.arange(size[0])[:, None, None] > size[0] * 0.45)] = 3
        label[(label == 3) & (np.arange(size[1])[None, :, None] > size[1] * 0.45)] = 4
        (root / f"Case {pid}.txt").write_text(f"GBS: {i}\nSex: {'FM'[i]}\nAge: {60 + i}\nTobacco: N\n"
                                              f"FEVG: {55.5 - 10 * i}\n")
        for sub, array in (("Images", image[..., 0]), ("Contours", label)):
            (root / f"Case_{pid}" / sub).mkdir(parents=True)
            write_raw_nifti(root / f"Case_{pid}" / sub / f"Case_{pid}.nii.gz", array, spacing=(1.6, 1.6, 10.0))


def write_raw_myops2020(root: Path, seed: int, size: tuple = (196, 194, 2)) -> None:
    """MyoPS2020 as it ships: ``train25/myops_training_<pid>_{C0,DE,T2}.nii.gz`` with
    ``train25_myops_gd/myops_training_<pid>_gd.nii.gz`` (labels 0, 200, 500, 600, 1220, 2221) and
    ``test20/myops_test_<pid>_*`` without labels; the slices are larger than the 192x192 crop."""
    rs = np.random.RandomState(seed)
    for split, image_dir, pid in (("training", "train25", "101"), ("test", "test20", "201")):
        (root / image_dir).mkdir(parents=True)
        image, shells = raw_heart(rs, size, (1.0,))
        for k, tag in enumerate(("C0", "DE", "T2")):
            write_raw_nifti(root / image_dir / f"myops_{split}_{pid}_{tag}.nii.gz", image[..., 0] * (1 + k) + 7 * k,
                       spacing=(0.73, 0.73, 12.0))
        if split == "training":
            (root / "train25_myops_gd").mkdir()
            gd = np.array([0, 500, 200, 600], np.int16)[shells[..., 0]]
            gd[(gd == 200) & (np.arange(size[0])[:, None, None] > size[0] * 0.45)] = 1220
            gd[(gd == 1220) & (np.arange(size[1])[None, :, None] > size[1] * 0.45)] = 2221
            write_raw_nifti(root / "train25_myops_gd" / f"myops_{split}_{pid}_gd.nii.gz", gd,
                            spacing=(0.73, 0.73, 12.0))


def write_raw_landmark(root: Path, seed: int) -> None:
    """The landmark PNGs and their headerless tables ``<view>.csv`` (cohort_name, uid, view, landmark_number, x,
    y): ``lax_2c`` with integer uids, gray PNGs of two sizes, the landmarks out of order, one uid with two
    landmarks and one without an image; ``lax_4c`` with string uids and RGB PNGs."""
    from cinema_tpu_torch import viz

    rs = np.random.RandomState(seed)
    for view, uids, rgb in (("lax_2c", [str(1000 + 7 * i) for i in range(11)], False),
                            ("lax_4c", [f"U{i:02d}" for i in range(6)], True)):
        (root / view / "images").mkdir(parents=True)
        lines = []
        for i, uid in enumerate(uids):
            w, h = (64, 52) if i % 2 else (60, 72)
            numbers = [3, 1, 2] if i % 3 else [1, 2, 3]
            for n in numbers[: 2 if (view == "lax_2c" and i == 4) else 3]:
                lines.append(f"cohort{i % 2},{uid},{view},{n},{rs.uniform(0, w):.2f},{rs.uniform(0, h):.2f}")
            if view == "lax_2c" and i == 7:
                continue  # a table entry without its image
            image = rs.randint(0, 256, (h, w, 3) if rgb else (h, w)).astype(np.uint8)
            viz.write_png(root / view / "images" / f"{uid}.png", image)
        (root / f"{view}.csv").write_text("\n".join(lines) + "\n")


def _dicom_element(group: int, element: int, vr: bytes, value: bytes, implicit: bool) -> bytes:
    if len(value) % 2:
        value += b"\x00"
    head = struct.pack("<HH", group, element)
    if implicit:
        return head + struct.pack("<I", len(value)) + value
    if vr in (b"OB", b"OW", b"SQ", b"UN", b"UT"):
        return head + vr + b"\x00\x00" + struct.pack("<I", len(value)) + value
    return head + vr + struct.pack("<H", len(value)) + value


def write_dicom(path: Path, pixels: np.ndarray, position: tuple, orientation: tuple, pixel_spacing: float,
                series_uid: str, series_description: str, instance: int, trigger_time: float, n_frames: int,
                spacing_between_slices: float = 0.0, implicit: bool = False) -> None:
    """One single-frame uint16 MR DICOM part-10 file in explicit (or implicit) VR little endian with the tags
    that the cine pipelines read: geometry, series, instance, trigger time and CardiacNumberOfImages."""
    def ds(values) -> bytes:
        return "\\".join(f"{v:g}" for v in np.atleast_1d(values)).encode()

    def el(group, element, vr, value):
        return _dicom_element(group, element, vr, value, implicit)

    syntax = b"1.2.840.10008.1.2" if implicit else b"1.2.840.10008.1.2.1"
    body = [el(0x0008, 0x103E, b"LO", series_description.encode()), el(0x0018, 0x0050, b"DS", ds(8.0))]
    if spacing_between_slices:
        body.append(el(0x0018, 0x0088, b"DS", ds(spacing_between_slices)))
    body += [el(0x0018, 0x1060, b"DS", ds(trigger_time)), el(0x0018, 0x1090, b"IS", str(n_frames).encode()),
             el(0x0020, 0x000E, b"UI", series_uid.encode()), el(0x0020, 0x0013, b"IS", str(instance).encode()),
             el(0x0020, 0x0032, b"DS", ds(position)), el(0x0020, 0x0037, b"DS", ds(orientation)),
             el(0x0028, 0x0010, b"US", struct.pack("<H", pixels.shape[0])),
             el(0x0028, 0x0011, b"US", struct.pack("<H", pixels.shape[1])),
             el(0x0028, 0x0030, b"DS", ds((pixel_spacing, pixel_spacing))),
             el(0x0028, 0x0100, b"US", struct.pack("<H", 16)), el(0x0028, 0x0103, b"US", struct.pack("<H", 0)),
             el(0x7FE0, 0x0010, b"OW", pixels.astype("<u2").tobytes())]
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(b"\x00" * 128 + b"DICM" + _dicom_element(0x0002, 0x0010, b"UI", syntax, False) + b"".join(body))


def cine_geometry(rows: int, cols: int, spacing: float, n_sax: int, gap: float) -> dict:
    """DICOM (LPS) positions and orientations of a study: SAX slices ``gap`` apart along z, a 2C plane of
    constant x and a 4C plane of constant y through the middle of the SAX slices (a little off it), and a 3C plane
    parallel to the 2C one; each LAX image spans the SAX stack."""
    px, py = -cols * spacing / 2, -rows * spacing / 2
    z0 = -rows * spacing / 2 + n_sax * gap / 2
    return {
        "sax": [((px, py, k * gap), (1, 0, 0, 0, 1, 0)) for k in range(n_sax)],
        "lax_2c": ((px + cols * spacing / 2 + 1.0, py, z0), (0, 1, 0, 0, 0, 1)),
        "lax_3c": ((px + cols * spacing / 2 - 9.0, py, z0), (0, 1, 0, 0, 0, 1)),
        "lax_4c": ((px, py + rows * spacing / 2 - 2.0, z0), (1, 0, 0, 0, 0, 1)),
    }


def cine_pixels(rs: np.random.RandomState, rows: int, cols: int, n_frames: int, noise: int = 3) -> np.ndarray:
    """(n_frames, rows, cols) uint16 cine pixels: a bright disc whose radius follows the cycle on a dim
    background, with integer noise in [-noise, noise]."""
    yy, xx = np.mgrid[:rows, :cols]
    r2 = ((yy - rows / 2) / rows) ** 2 + ((xx - cols / 2) / cols) ** 2
    frames = [np.where(r2 < (0.18 * s) ** 2, 600, 150) + rs.randint(-noise, noise + 1, (rows, cols))
              for s in cycle(n_frames)]
    return np.stack(frames).astype(np.uint16)


def write_kaggle_study(study_dir: Path, rs: np.random.RandomState, rows: int, cols: int, n_frames: int,
                       n_sax: int, implicit: bool, odd_slice: bool) -> None:
    """One study of the Kaggle Data Science Bowl: ``2ch_*`` and ``4ch_*`` LAX folders and numbered ``sax_*``
    folders of one cine slice each, frames shuffled on disk, no SeriesInstanceUID; ``odd_slice`` gives the last
    SAX slice another pixel spacing, which the CLI's filter drops."""
    geo = cine_geometry(rows, cols, 1.8, n_sax, 8.0)
    folders = [("2ch_21", *geo["lax_2c"], 2.0), ("4ch_22", *geo["lax_4c"], 2.0)]
    folders += [(f"sax_{k + 5}", pos, orient, 2.1 if odd_slice and k == n_sax - 1 else 1.8)
                for k, (pos, orient) in enumerate(geo["sax"])]
    for name, position, orientation, spacing in folders:
        pixels = cine_pixels(rs, rows, cols, n_frames)
        for file_index, t in enumerate(rs.permutation(n_frames)):
            write_dicom(study_dir / name / f"IM-{file_index:04d}.dcm", pixels[t], position, orientation, spacing,
                        "", name, int(t) + 1, 30.0 * float(t), n_frames,
                        spacing_between_slices=8.0 if name.startswith("sax") else 0.0, implicit=implicit)


def write_raw_kaggle(root: Path, seed: int, rows: int = 24, cols: int = 20, n_frames: int = 3, n_sax: int = 4) -> None:
    """The Kaggle Data Science Bowl layout: ``{train,validate,test}/<split>/<pid>/study/`` (one study in implicit
    VR, one with an inconsistent SAX slice) with ``train.csv`` and ``validate.csv`` (Id, Systole, Diastole; the
    validate study's row missing) and ``solution.csv`` (``<Id>_{Diastole,Systole}``, Volume, Usage)."""
    rs = np.random.RandomState(seed)
    for split, pids in (("train", (1, 12)), ("validate", (3,)), ("test", (4,))):
        for pid in pids:
            write_kaggle_study(root / split / split / str(pid) / "study", rs, rows, cols, n_frames, n_sax,
                               implicit=pid == 12, odd_slice=pid == 1)
    (root / "train.csv").write_text("Id,Systole,Diastole\n1,60,150\n12,45.5,120.5\n")
    (root / "validate.csv").write_text("Id,Systole,Diastole\n2,70,160\n")
    (root / "solution.csv").write_text("Id,Volume,Usage\n4_Diastole,140.0,Public\n4_Systole,52.5,Public\n")


def write_raw_rescan(root: Path, seed: int, n_slices: int = 3, n_frames: int = 4, ny: int = 24, nx: int = 20) -> None:
    """The rescan study's pickles: ``train/<group>/<scan>/{2C,4C,SAX,SAX_segs}.pickle`` (SAX voxels (z, t, y,
    x), apex first, with labels 1 LV) and ``test_retest_100/<id>/`` scans without labels paired by
    ``labels.csv`` (A, B1, B2, EDV/ESV of each; one pair without B2)."""
    import pickle

    rs = np.random.RandomState(seed)

    def scan(scan_dir: Path, with_label: bool) -> None:
        scan_dir.mkdir(parents=True)
        geo = cine_geometry(ny, nx, 1.8, n_slices, 8.0)
        voxels = np.stack([cine_pixels(rs, ny, nx, n_frames) for _ in range(n_slices)])
        sax = {"image_voxels": voxels.astype(np.float32),
               "ImagePositionPatient": np.array([pos for pos, _ in geo["sax"]][::-1], np.float64),
               "ImageOrientationPatient": np.array(geo["sax"][0][1], np.float64),
               "PixelSpacing": np.array([1.8, 1.8]), "SliceSpacing": 8.0}
        pickles = {"SAX": sax}
        if with_label:
            seg = np.zeros((n_slices, n_frames, ny, nx), np.uint8)
            for t, s in enumerate(cycle(n_frames)):
                y0, y1, x0, x1 = (int(n * (0.5 + sign * 0.2 * s)) for n in (ny, nx) for sign in (-1, 1))
                seg[:, t, y0:y1, x0:x1] = 1
            pickles["SAX_segs"] = {**{k: v for k, v in sax.items() if k != "image_voxels"}, "image_segmentation": seg}
        for view, key in (("2C", "lax_2c"), ("4C", "lax_4c")):
            position, orientation = geo[key]
            pickles[view] = {"image_voxels": cine_pixels(rs, ny, nx, n_frames).astype(np.float32),
                             "ImagePositionPatient": np.array(position, np.float64),
                             "ImageOrientationPatient": np.array(orientation, np.float64),
                             "PixelSpacing": np.array([2.0, 2.0])}
        for name, data in pickles.items():
            with open(scan_dir / f"{name}.pickle", "wb") as f:
                pickle.dump(data, f)

    scan(root / "train" / "G1" / "s_0001", True)
    scan(root / "train" / "G2" / "s_0007", True)
    for scan_id in (7, 8, 9, 10, 11):
        scan(root / "test_retest_100" / str(scan_id), False)
    (root / "test_retest_100" / "labels.csv").write_text(
        "A,B1,B2,EDV_A,ESV_A,EDV_B1,ESV_B1,EDV_B2,ESV_B2\n7,8,9,100,40,110.5,50,90,30\n10,11,,80,30,82,31,,\n")


def write_raw_ukb(root: Path, seed: int, rows: int = 24, cols: int = 20, n_sax: int = 3, n_frames: int = 3,
                  noise: int = 3, eid: str = "1000001") -> tuple:
    """One UK Biobank eid as its bulk export holds it: the flat DICOM folders ``<eid>_20209_2_0`` (LAX 2C, 3C, 4C)
    and ``<eid>_20208_2_0`` (SAX slices ``CINE_segmented_SAX_b<k>``, 10 mm apart) with their ``manifest.csv``
    (unquoted comma dates that the CLI fixes; a derived InlineVF series whose file is absent, with empty
    numeric fields). Returns the two folders."""
    rs = np.random.RandomState(seed)
    geo = cine_geometry(rows, cols, UKB_REAL["pixel_spacing"], n_sax, 10.0)
    series = {"lax": [(f"CINE_segmented_LAX_{c}Ch", *geo[f"lax_{c}c"]) for c in (2, 3, 4)],
              "sax": [(f"CINE_segmented_SAX_b{k + 1}", *geo["sax"][k]) for k in range(n_sax)]}
    folders = []
    count = 0
    for suffix, field in (("lax", "20209"), ("sax", "20208")):
        folder = root / f"{eid}_{field}_2_0"
        folder.mkdir(parents=True)
        lines = ["filename,date,series discription,rows,columns,acquisition"]
        for s, (name, position, orientation) in enumerate(series[suffix]):
            pixels = cine_pixels(rs, rows, cols, n_frames, noise)
            for t in range(n_frames):
                count += 1
                fname = f"IM-{count:05d}.dcm"
                write_dicom(folder / fname, pixels[t], position, orientation, UKB_REAL["pixel_spacing"],
                            f"1.2.826.{field}.{s}", name, t + 1, 25.0 * t, n_frames, spacing_between_slices=10.0)
                lines.append(f"{fname},Aug 30, 2015,{name},{rows},{cols},{s + 1}")
        if suffix == "lax":
            lines.append("IM-99999.dcm,Sep 1, 2015,InlineVF_Results,,,")
        (folder / "manifest.csv").write_text("\n".join(lines) + "\n")
        folders.append(folder)
    return tuple(folders)


def write_raw_reindex(root: Path, seed: int) -> None:
    """4-D NIfTI files as an earlier preprocessing left them, one gzip stream each: a uint8 cine, an int16 one
    with scaling (slope 2, intercept -1) and its own description, one already frame-indexed, and a 3-D volume,
    which the CLI skips."""
    from cinema_tpu_torch.data import save_nifti

    rs = np.random.RandomState(seed)
    (root / "a").mkdir(parents=True)
    save_nifti(root / "a" / "1_sax_t.nii.gz", rs.randint(0, 256, (12, 10, 3, 5)).astype(np.uint8),
               spacing=(1.0, 1.0, 10.0, 1.0))
    save_nifti(root / "a" / "2_sax_t.nii.gz", rs.randint(-300, 300, (10, 12, 2, 4)).astype(np.int16),
               spacing=(1.4, 1.4, 8.0, 1.0), descrip=b"scanner export", scl=(2.0, -1.0))
    save_nifti(root / "3_lax_t.nii.gz", rs.randint(0, 256, (16, 16, 1, 3)).astype(np.uint8), frame_indexed=True)
    save_nifti(root / "4.nii.gz", rs.randint(0, 256, (8, 8, 4)).astype(np.uint8))


def _ukb_args(raw: Path, out: Path) -> list:
    return [["--lax_dicom_dir", str(raw / "1000001_20209_2_0"), "--sax_dicom_dir", str(raw / "1000001_20208_2_0"),
             "--out_dir", str(out)]]


def _dir_args(*extra: str):
    """The argument lists of one call with ``--data_dir`` and ``--out_dir``, then ``extra``."""
    return lambda raw, out: [["--data_dir", str(raw), "--out_dir", str(out), *extra]]


# the ten preprocessing CLIs by their JAX console-script names (pyproject.toml): the module under
# ``<package>.data.preprocess`` and its function, both the same in the JAX package and the port; the raw
# tree's writer; and the argument lists of the calls, each CLI called once per list
PREPROCESS_CLIS = {
    "acdc_preprocess": ("acdc", "main", write_raw_acdc, _dir_args()),
    "mnms_preprocess": ("mnms", "main", write_raw_mnms, _dir_args()),
    "mnms2_preprocess": ("mnms2", "main", write_raw_mnms2, _dir_args()),
    "emidec_preprocess": ("emidec", "main", write_raw_emidec, _dir_args()),
    "myops2020_preprocess": ("myops2020", "main", write_raw_myops2020, _dir_args()),
    "landmark_preprocess": ("landmark", "main", write_raw_landmark,
                            lambda raw, out: [["--data_dir", str(raw), "--out_dir", str(out), "--view", view]
                                              for view in ("lax_2c", "lax_4c")]),
    "kaggle_preprocess": ("dicom_based", "main_kaggle", write_raw_kaggle, _dir_args("--max_n_cpus", "2")),
    "rescan_preprocess": ("dicom_based", "main_rescan", write_raw_rescan,
                          _dir_args("--splits", "train", "test_retest_100")),
    "dicom_to_nifti": ("dicom_based", "main_dicom_to_nifti", write_raw_ukb, _ukb_args),
    "cinema_reindex_nifti": ("reindex", "main", write_raw_reindex, _dir_args("--n_workers", "2")),
}


def run_port_cli(name: str, raw: Path, out: Path) -> float:
    """Write CLI ``name``'s seeded raw tree under ``raw`` (seed 13) and run the port's CLI on it into ``out``, in
    this process; returns the CLI's seconds."""
    import importlib

    module, function, writer, argv = PREPROCESS_CLIS[name]
    writer(raw, seed=13)
    entry = getattr(importlib.import_module(f"cinema_tpu_torch.data.preprocess.{module}"), function)
    t0 = time.perf_counter()
    for args in argv(raw, out):
        entry(args)
    return time.perf_counter() - t0


def compare_trees(got: Path, want: Path) -> dict:
    """What differs between two output trees, by relative path: a file in one tree only; a PNG whose decoded
    pixels differ; any other file whose bytes differ, and for a NIfTI then the number of voxels that differ and
    the largest difference, or the header fields that do. Empty where the trees are the same."""
    from cinema_tpu_torch.data import load_nifti, read_png_gray

    if not want.is_dir():
        return {"": f"no reference tree at {want}"}
    files = {p.relative_to(got).as_posix() for p in got.rglob("*") if p.is_file()}
    wanted = {p.relative_to(want).as_posix() for p in want.rglob("*") if p.is_file()}
    problems = {name: "only in the port's output" for name in sorted(files - wanted)}
    problems.update({name: "missing from the port's output" for name in sorted(wanted - files)})
    for name in sorted(files & wanted):
        a, b = got / name, want / name
        if name.endswith(".png"):
            x, y = read_png_gray(a), read_png_gray(b)
            if x.shape != y.shape or not np.array_equal(x, y):
                problems[name] = {"pixels": "shape" if x.shape != y.shape else int(np.sum(x != y))}
        elif a.read_bytes() != b.read_bytes():
            problems[name] = "bytes differ"
            if name.endswith((".nii", ".nii.gz")):
                (x, hx), (y, hy) = load_nifti(a), load_nifti(b)
                if x.shape == y.shape and x.dtype == y.dtype:
                    diff = np.abs(x.astype(np.float64) - y.astype(np.float64))
                    problems[name] = {"voxels_differ": int(np.sum(diff > 0)), "max_abs_diff": float(diff.max()),
                                      "header_differs": [k for k in ("spacing", "descrip", "scl_slope", "scl_inter")
                                                         if getattr(hx, k) != getattr(hy, k)]
                                      + (["affine"] if not np.array_equal(hx.affine, hy.affine) else [])}
                else:
                    problems[name] = {"shape": [list(x.shape), list(y.shape)], "dtype": [str(x.dtype), str(y.dtype)]}
    return problems


@contextlib.contextmanager
def ukb_ingest():
    """Write the real-size UKB eid of phase 13 (``UKB_REAL``) and start its CLI, ``python -m
    cinema_tpu_torch.data.preprocess.ukb_dicom``, in a process of its own; yields ``{"process", "out", "log",
    "t0", "write_raw_s"}``, ``t0`` by ``time.time()``. The CLI spends most of its ~150 s on the host in zlib at level 9, the JAX
    pipeline's writes of the uncropped float32 volumes, so ``main`` starts it before phases 11 and 12 and
    phase 13 waits for it: one core of eight busy beside them. On exit the process is stopped if it still
    runs, and its folder removed."""
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        t0 = time.perf_counter()
        lax_dir, sax_dir = write_raw_ukb(work / "raw", seed=15, rows=UKB_REAL["rows"], cols=UKB_REAL["cols"],
                                         n_sax=UKB_REAL["n_sax"], n_frames=UKB_REAL["n_frames"],
                                         noise=UKB_REAL["noise"])
        write_s = time.perf_counter() - t0
        with open(work / "ukb_dicom.log", "w") as log:
            t0 = time.time()  # the file system's clock, which dates the CLI's last file
            process = subprocess.Popen(
                [sys.executable, "-m", "cinema_tpu_torch.data.preprocess.ukb_dicom", "--lax_dicom_dir",
                 str(lax_dir), "--sax_dicom_dir", str(sax_dir), "--out_dir", str(work / "out")],
                cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
            try:
                yield {"process": process, "out": work / "out", "log": work / "ukb_dicom.log", "t0": t0,
                       "write_raw_s": write_s}
            finally:
                if process.poll() is None:
                    process.kill()
                process.wait()


def preprocess_exactness(work: Path) -> dict:
    """Phase 13 (a): the ten port CLIs on their seeded raw trees, in this process, each output tree against the
    JAX CLI's (``PREPROCESS_FIXTURES``). Returns the seconds of each CLI and what differs."""
    seconds, problems = {}, {}
    for name in PREPROCESS_CLIS:
        seconds[name] = run_port_cli(name, work / name / "raw", work / name / "out")
        found = compare_trees(work / name / "out", PREPROCESS_FIXTURES / name)
        if found:
            problems[name] = found
    return {"seconds": seconds, "problems": problems}


def preprocess_phase(report: dict, smi: str, ukb: dict) -> dict:
    """The preprocessing CLIs on the card's machine (no pandas, no PIL): (a) the ten CLIs on small seeded raw trees,
    their outputs equal to the JAX CLIs'; (b) a real-size ACDC study through ``acdc`` and then the port's
    segmentation evaluation with ConvUNetR-base on the card, and a real-size UKB eid of DICOM through
    ``dicom_to_nifti`` (``ukb``, the process that ``ukb_ingest`` started), ``scan_manifest`` and
    ``UKBCineDataset`` into one CineMA-base MAE forward on the card. Returns the packed kernels' launches of
    the path."""
    import importlib.util

    import scipy

    from cinema_tpu_torch.config import PACKAGED, from_dict
    from cinema_tpu_torch.data import BatchLoader, EDESSegmentationDataset, UKBCineDataset, collate, load_nifti
    from cinema_tpu_torch.data import read_metadata, to_device
    from cinema_tpu_torch.data.preprocess import acdc
    from cinema_tpu_torch.data.transforms import get_pretrain_transforms, get_segmentation_transforms
    from cinema_tpu_torch.factory import get_mae_model, get_segmentation_model, init_weights
    from cinema_tpu_torch.tasks.pretrain import scan_manifest
    from cinema_tpu_torch.tasks.segmentation import segmentation_eval_dataloader

    t_phase = time.perf_counter()
    launches = Launches()
    reset, read, counters = launches.reset, launches.read, launches.totals
    cuda = torch.device("cuda")
    result = {"numpy": np.__version__, "scipy": scipy.__version__,
              "pandas_installed": importlib.util.find_spec("pandas") is not None,
              "pil_installed": importlib.util.find_spec("PIL") is not None}
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        # a. exactness: the ten CLIs against the JAX CLIs' outputs of the same raw trees
        exact = preprocess_exactness(work / "small")
        result["small_s"] = exact["seconds"]
        print("preprocess_small", json.dumps({"seconds": exact["seconds"], "numpy": np.__version__,
                                               "scipy": scipy.__version__}), flush=True)
        if exact["problems"]:
            print("preprocess_problems", json.dumps(exact["problems"]), f"numpy {np.__version__} scipy "
                  f"{scipy.__version__}", flush=True)
        check(not exact["problems"], f"a port CLI's output differs from the JAX CLI's: {sorted(exact['problems'])} "
                                     f"(numpy {np.__version__}, scipy {scipy.__version__})")
        # the CLIs ran without pandas and PIL, whether or not the machine has them
        result["imported"] = sorted({m.split(".")[0] for m in sys.modules} & {"pandas", "PIL", "jax", "yaml"})
        check(not result["imported"], f"the preprocessing CLIs imported {result['imported']}")

        # b1. one ACDC study at the size ACDC ships, through the CLI, then evaluated on the card
        raw, out = work / "acdc_real" / "raw", work / "acdc_real" / "out"
        t0 = time.perf_counter()
        write_raw_acdc(raw, seed=14, size=ACDC_REAL["size"], n_frames=ACDC_REAL["n_frames"],
                       spacing=ACDC_REAL["spacing"], n_train=1, n_test=0)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        acdc.main(["--data_dir", str(raw), "--out_dir", str(out)])
        acdc_s = time.perf_counter() - t0
        rows = read_metadata(out / "train_metadata.csv")
        pid = rows[0]["pid"]
        ed, _ = load_nifti(out / "train" / pid / f"{pid}_sax_ed.nii.gz")
        video, _ = load_nifti(out / "train" / pid / f"{pid}_sax_t.nii.gz")
        check(len(rows) == 1 and ed.shape == (192, 192, 10) and video.shape == (192, 192, 10, 30)
              and ed.dtype == np.uint8, f"processed ACDC study {rows} {ed.shape} {video.shape}")
        config = from_dict(PACKAGED["segmentation/acdc"])
        model = init_weights(get_segmentation_model(config, dtype=torch.bfloat16, device=cuda), seed=14).eval()
        _, val_transform = get_segmentation_transforms(config)
        loader = BatchLoader(EDESSegmentationDataset(out / "train", rows, "sax", val_transform), 1, shuffle=False,
                             drop_last=False)
        depth = 12
        with loader, torch.no_grad():
            reset()
            t0 = time.perf_counter()
            metrics = segmentation_eval_dataloader(model, loader, config)
            torch.cuda.synchronize()
            eval_s = time.perf_counter() - t0
            got = read()
        check(got == (2 * depth, 0, 0, 0), f"the processed ACDC study's evaluation launched {got}, expected "
                                           f"{depth} packed forward launches for each of ED and ES")
        check(0.0 <= metrics["mean_dice_score"] <= 1.0, f"ACDC evaluation of the processed study: {metrics}")
        result["acdc_real"] = {"size": list(ACDC_REAL["size"]), "n_frames": ACDC_REAL["n_frames"],
                               "write_raw_s": write_s, "cli_s_per_study": acdc_s, "eval_s": eval_s,
                               "launches": got[0], "mean_dice_score": metrics["mean_dice_score"]}
        del model

        # b2. the real-size UKB eid, processed by its CLI's own process, into one MAE forward on the card
        t0 = time.perf_counter()
        ukb_rc = ukb["process"].wait(timeout=900)
        waited_s = time.perf_counter() - t0
        check(ukb_rc == 0, f"python -m cinema_tpu_torch.data.preprocess.ukb_dicom exited {ukb_rc}: "
                           f"{ukb['log'].read_text()[-2000:]}")
        out = ukb["out"]
        # the CLI's seconds: from its start to its last file written (it may have ended before this phase)
        ukb_s = max(f.stat().st_mtime for f in out.rglob("*") if f.is_file()) - ukb["t0"]
        config = from_dict(PACKAGED["mae"])
        views = list(config.model.views)
        pids = scan_manifest(out, views)
        check(pids == ["1000001_2"], f"scan_manifest of the processed eid: {pids}")
        dataset = UKBCineDataset(out, pids, views=views, transform=get_pretrain_transforms(config), seed=0)
        batch = to_device({k: v for k, v in collate([dataset.load(0)]).items() if k in views}, cuda)
        model = init_weights(get_mae_model(config, dtype=torch.bfloat16, device=cuda), seed=15).eval()
        with torch.no_grad():
            reset()
            t0 = time.perf_counter()
            loss, _, _, _ = model(batch, config.train.enc_mask_ratio, generator=torch.Generator(cuda).manual_seed(0))
            loss = float(loss)
            mae_s = time.perf_counter() - t0
            got = read()
        check(got == (12 + 8, 0, 0, 0), f"the MAE forward of the processed eid launched {got}, expected 12 + 8")
        check(np.isfinite(loss), f"the MAE loss of the processed eid is {loss}")
        result["ukb_real"] = {"sax": [UKB_REAL["cols"], UKB_REAL["rows"], UKB_REAL["n_sax"], UKB_REAL["n_frames"]],
                              "write_raw_s": ukb["write_raw_s"], "cli_s_per_study": ukb_s, "waited_s": waited_s,
                              "mae_forward_s": mae_s,
                              "launches": got[0], "loss": loss,
                              "shapes": {v: list(batch[v].shape) for v in views}}
        del model
    result["phase_s"] = time.perf_counter() - t_phase
    result["launches"] = dict(counters)
    report["preprocess"] = result
    print("preprocess", json.dumps(result), f"on {smi}", flush=True)
    return counters


# phase 14: the native reader and distribution
TWO_RANK_MODES = {"ddp": (2, 1, False), "tp": (1, 2, False), "fsdp": (2, 1, True)}  # (n_data, n_model, fsdp)
TWO_RANK_BATCH = 2


@contextlib.contextmanager
def frame_reader(mode: str):
    """The port's NIfTI frame reads through the C++ reader (``"native"``) or through Python, in this process
    and in the loader processes started inside (``CINEMA_TORCH_NATIVE`` reaches a spawned worker). The native
    reader is required (``CINEMA_TORCH_NATIVE=1``): a read that it refuses raises instead of falling back
    to Python, so what is timed as native is native."""
    from cinema_tpu_torch import native

    saved = (native._lib, native._loaded, os.environ.get("CINEMA_TORCH_NATIVE"))
    if mode == "python":
        native._lib, native._loaded = None, True
        os.environ["CINEMA_TORCH_NATIVE"] = "0"
    else:
        check(native.reader() == "native", "the native reader is not active")
        os.environ["CINEMA_TORCH_NATIVE"] = "1"
    try:
        yield
    finally:
        native._lib, native._loaded = saved[0], saved[1]
        if saved[2] is None:
            os.environ.pop("CINEMA_TORCH_NATIVE", None)
        else:
            os.environ["CINEMA_TORCH_NATIVE"] = saved[2]


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _two_rank_worker(rank: int, port: int, work: str) -> None:
    """One of two ranks on the one card over gloo (NCCL puts no two ranks on one device; gloo takes the CUDA
    tensors where they lie, FSDP2's collectives included): per mode of TWO_RANK_MODES, CineMA-base in f32 from
    the seeded weights, this rank's rows of the batch and the masks, the loss and the gradients reduced over
    the ranks; rank 0 saves the loss, the whole gradients (gathered), the launches and the local widths."""
    import torch.distributed as dist

    from cinema_tpu_torch.config import from_dict
    from cinema_tpu_torch.factory import get_mae_model, init_weights
    from cinema_tpu_torch import trace
    from cinema_tpu_torch.ops.masking import PatchMask
    from cinema_tpu_torch.parallel.mesh import make_mesh, parallelize

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE="2",
                      LOCAL_RANK="0")
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", rank=rank, world_size=2)
    inputs = torch.load(Path(work) / "inputs.pt", weights_only=True)
    config = from_dict(json.loads(inputs["config"]))
    for mode, (n_data, n_model, fsdp) in TWO_RANK_MODES.items():
        mesh = make_mesh(n_data, n_model, "cuda")
        model = init_weights(get_mae_model(config, dtype=torch.float32, device="cuda"), seed=config.seed)
        par = parallelize(model, mesh, fsdp=fsdp)
        rows = TWO_RANK_BATCH // n_data
        own = slice(par.data_rank * rows, (par.data_rank + 1) * rows)
        batch = {v: x[own].cuda() for v, x in inputs["batch"].items()}
        masks = {v: PatchMask(*(t[own].cuda() for t in m)) for v, m in inputs["masks"].items()}
        trace.reset("attention.packed.launches", "attention.packed.bwd_launches")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = model(batch, 0.75, masks)[0]
        grads = par.gradients(loss, model)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        launches = (trace.counter("attention.packed.launches"), trace.counter("attention.packed.bwd_launches"))
        loss = par.mean_metrics({"loss": loss.detach()})["loss"]
        full = {name: par.full_tensor(name, g).cpu() for name, g in zip(par.names, grads)}
        widths = sorted({tuple(m.weight.shape) for name, m in model.named_modules() if name.endswith("attn.q")})
        if rank == 0:
            torch.save({"loss": float(loss), "grads": full, "launches": launches, "q_widths": widths,
                        "step_ms": step_ms, "backend": dist.get_backend()}, Path(work) / f"{mode}.pt")
        del model, par, grads, full
        torch.cuda.empty_cache()
    dist.destroy_process_group()


@contextlib.contextmanager
def two_rank_steps(config, work: Path, smi: str):
    """Two ranks on the one card over gloo with CUDA tensors (``_two_rank_worker``), started on entry and
    waited for on exit (the caller's work runs beside them): an f32 CineMA-base step at batch 2 under DDP
    (1 + 1 rows), TP (n_model=2: 384 wide with 6 heads in the encoder, 256 with 8 in the decoder) and FSDP,
    each against this process's step on the whole batch: the loss within TRAIN_LOSS_RTOL, each parameter's
    gradient within TRAIN_GRAD_RTOL of its largest entry. Yields the result's dict, filled on exit; the
    ranks are stopped if the caller's work fails."""
    import torch.multiprocessing as mp

    from cinema_tpu_torch.factory import get_mae_model, init_weights
    from cinema_tpu_torch.ops.masking import random_patch_mask

    views = list(config.model.views)
    sizes = {v: tuple(config.data.sax.patch_size if v == "sax" else config.data.lax.patch_size) for v in views}
    gen = torch.Generator(device="cuda").manual_seed(5)
    rng = np.random.default_rng(6)
    batch = {v: torch.from_numpy(rng.random((TWO_RANK_BATCH, *sizes[v], 1), dtype=np.float32)) for v in views}
    model32 = init_weights(get_mae_model(config, dtype=torch.float32, device="cuda"), seed=config.seed)
    masks = {v: random_patch_mask(gen, TWO_RANK_BATCH, model32.enc_down_dict[v].n_patches, 0.75, "cuda")
             for v in views}
    work.mkdir()
    torch.save({"config": json.dumps(config), "batch": batch,
                "masks": {v: tuple(t.cpu() for t in m) for v, m in masks.items()}}, work / "inputs.pt")
    params = list(model32.parameters())
    names = [n for n, _ in model32.named_parameters()]
    loss_ref = model32({v: x.cuda() for v, x in batch.items()}, 0.75, masks)[0]
    grads_ref = {n: g for n, g in zip(names, torch.autograd.grad(loss_ref, params))}
    loss_ref = loss_ref.item()
    del model32, params
    t0 = time.perf_counter()
    ranks = mp.spawn(_two_rank_worker, args=(free_port(), str(work)), nprocs=2, join=False)
    result: dict = {}
    try:
        yield result
        while not ranks.join():
            pass
    finally:
        for proc in ranks.processes:
            if proc.is_alive():
                proc.terminate()
    spawn_s = time.perf_counter() - t0
    two_rank = {}
    for mode in TWO_RANK_MODES:
        got = torch.load(work / f"{mode}.pt", weights_only=True)
        worst = max(((got["grads"][n].cuda() - g).abs().max() / g.abs().max().clamp(min=1e-12)).item()
                    for n, g in grads_ref.items())
        two_rank[mode] = {"loss": got["loss"], "loss_one_process": loss_ref,
                          "loss_rel_err": abs(got["loss"] - loss_ref) / abs(loss_ref), "max_rel_grad_err": worst,
                          "launches_rank0": got["launches"], "q_widths_rank0": got["q_widths"],
                          "step_ms_rank0": got["step_ms"], "backend": got["backend"]}
        check(abs(got["loss"] - loss_ref) <= TRAIN_LOSS_RTOL * abs(loss_ref),
              f"{mode}: loss {got['loss']} against {loss_ref}")
        check(worst <= TRAIN_GRAD_RTOL, f"{mode}: gradients differ by {worst} of a parameter's largest")
        check(got["launches"] == (20, 20), f"{mode}: rank 0 launched {got['launches']}")
    check(two_rank["tp"]["q_widths_rank0"] == [(256, 512), (384, 768)],
          f"TP rank 0's q layers are {two_rank['tp']['q_widths_rank0']}, not the heads' half")
    result.update(modes=two_rank, spawn_s=spawn_s, loss_rtol=TRAIN_LOSS_RTOL, grad_rtol=TRAIN_GRAD_RTOL)
    print("two_rank", json.dumps(result), f"on {smi}", flush=True)


def distribution_phase(report: dict, smi: str) -> dict:
    """Phase 14: the C++ frame reader on the card's host against Python, and the distributed steps on the one
    card; returns the launches of this process's steps."""
    import copy
    import itertools

    import torch.distributed as dist

    from cinema_tpu_torch import native
    from cinema_tpu_torch.config import PACKAGED, from_dict
    from cinema_tpu_torch.convert import load_safetensors
    from cinema_tpu_torch.data import BatchLoader, UKBCineDataset, device_prefetch, load_nifti_frame, save_nifti
    from cinema_tpu_torch.data import nifti as nifti_reads
    from cinema_tpu_torch.data.nifti import load_nifti_header, read_frame_index
    from cinema_tpu_torch.data.transforms import get_pretrain_transforms
    from cinema_tpu_torch.factory import get_mae_model, init_weights
    from cinema_tpu_torch.tasks import pretrain
    from cinema_tpu_torch.tasks.regression import acdc as reg_acdc
    from cinema_tpu_torch.train.optim import build_optimizer
    from cinema_tpu_torch.train.state import TrainState, make_mae_train_step

    t_phase = time.perf_counter()
    launches = Launches()
    out: dict = {}
    parts_s: dict = {}

    # a. the native reader: the compiler and zlib.h of this host, the build, every frame of phase 5's UKB studies
    # and of phase 10's two cines byte-equal to the Python reads, ms per frame, the loader and fed steps
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True, timeout=60).stdout.splitlines()[0]
    zlib_h = subprocess.run(["g++", "-E", "-x", "c++", "-"], input="#include <zlib.h>\n", capture_output=True,
                            text=True, timeout=60).returncode == 0
    active = native.reader()  # built in step 2, before the loaders' processes first read a frame
    out["native_build"] = {"gxx": gxx, "zlib_h": zlib_h, "reader": active, **native.build_info}
    print("native_build", json.dumps(out["native_build"]), f"on {smi}", flush=True)
    check(active == "native", f"the frame reader on this host is {active}, not native")

    config = from_dict(PACKAGED["mae"])
    config.grad_ckpt = False
    config.train.batch_size = 16
    views = list(config.model.views)
    sizes = {v: tuple(config.data.sax.patch_size if v == "sax" else config.data.lax.patch_size) for v in views}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        data_dir = root / "ukb"
        data_dir.mkdir()
        pids = write_ukb_studies(data_dir, 32, sizes, UKB_FRAMES, seed=2)  # phase 5's studies
        image, _ = cine_frames(np.random.default_rng(34), RESCAN_CINE)  # phase 10's cine, both layouts
        cines = {}
        for kind, indexed in (("frame_indexed", True), ("single_member", False)):
            cines[kind] = root / f"seek_{kind}.nii.gz"
            save_nifti(cines[kind], image, spacing=(1.0, 1.0, 10.0, 1.0), frame_indexed=indexed)
        paths = [data_dir / p / f"{p}_{v}.nii.gz" for p in pids for v in views] + list(cines.values())
        # each frame's bytes from the native functions called directly (a refusal raises here) against the
        # Python reads of the same byte range; load_nifti_frame under each reader is held to the same image in
        # the timed reads below and, through the loader, to the same batches
        n_frames, differ = {"inflate_at": 0, "read_at": 0}, []
        for path in paths:
            header = load_nifti_header(path)
            nt = header.shape[3]
            frame_bytes = int(np.prod(header.shape[:3])) * header.dtype.itemsize
            index = read_frame_index(path)
            check(index is not None or path == cines["single_member"], f"{path.name} is not frame-indexed")
            for t in range(nt):
                if index is not None:
                    span = (int(index[t]), int(index[t + 1]))
                    direct = native.inflate_at(path, span[0], span[1] - span[0], frame_bytes)
                    with frame_reader("python"):
                        python_bytes = bytes(nifti_reads._read_member(path, *span, frame_bytes))
                    n_frames["inflate_at"] += 1
                else:
                    offset = header.vox_offset + t * frame_bytes
                    direct = native.read_at(path, offset, frame_bytes)
                    with frame_reader("python"):
                        python_bytes = bytes(nifti_reads._seek_read(path, offset, frame_bytes))
                    n_frames["read_at"] += 1
                if direct.tobytes() != python_bytes:
                    differ.append(f"{path.name}:{t}")
        check(not differ, f"frames differ between the readers: {differ[:5]}")
        check(n_frames["read_at"] == RESCAN_CINE[3], f"read_at ran on {n_frames['read_at']} frames")
        reads = {}
        for kind, path in cines.items():
            for mode in ("native", "python", "python", "native"):  # in turns
                with frame_reader(mode):
                    t0 = time.perf_counter()
                    for t in range(RESCAN_CINE[3]):
                        check(np.array_equal(load_nifti_frame(path, t)[0], image[..., t]), f"{kind} frame {t}")
                    ms = (time.perf_counter() - t0) * 1e3 / RESCAN_CINE[3]
                reads.setdefault(kind, {}).setdefault(mode, []).append(ms)
        out["native_frames"] = {"files": len(paths), "frames_byte_equal": sum(n_frames.values()),
                                "frames_by_native_call": n_frames,
                                "ms_per_frame": {k: {m: statistics.mean(v) for m, v in r.items()}
                                                 for k, r in reads.items()},
                                "ms_per_frame_runs": reads}
        print("native_frames", json.dumps(out["native_frames"]), f"on {smi}", flush=True)

        # the pretraining loader alone and steps fed from it, 16 threads and 16 processes, each with both readers
        # in turns (A B B A); a fed step as phase 5 times it. Each loader's workers start once, under their
        # reader (a worker process takes the reader of its start), and every loader's first batches are compared
        n_workers = config.train.n_workers_per_device
        dataset = UKBCineDataset(data_dir, pids * UKB_REPEAT, views, get_pretrain_transforms(config), seed=config.seed)
        model = init_weights(get_mae_model(config, dtype=torch.bfloat16, device="cuda"), seed=config.seed)
        tx = build_optimizer(dict(model.named_parameters()), lr=config.train.lr, min_lr=config.train.min_lr,
                             warmup_steps=100, max_n_steps=1000, betas=tuple(config.train.betas),
                             weight_decay=config.train.weight_decay, clip_grad=config.train.clip_grad)
        state = TrainState.create(model, tx)
        step_fn = make_mae_train_step(model, tx, config.train.enc_mask_ratio, seed=config.seed)
        n_batches, n_fed = 6, 5
        out["reader_loader"], out["reader_fed"] = {}, {}
        orders = {"threads": ("native", "python", "python", "native"),
                  "processes": ("python", "native", "native", "python")}
        with contextlib.ExitStack() as pools:
            loaders, reference = {}, None
            for kind in orders:
                for mode in ("native", "python"):
                    with frame_reader(mode):
                        loader = pools.enter_context(BatchLoader(dataset, 16, seed=config.seed, n_workers=n_workers,
                                                                 processes=kind == "processes"))
                        start = loader.epoch(0)
                        first = [next(start), next(start)]
                        start.close()
                    reference = first if reference is None else reference
                    check(all(np.array_equal(a[v], b[v]) for a, b in zip(reference, first) for v in views),
                          f"the {kind} loader with the {mode} reader gave other batches")
                    loaders[kind, mode] = loader
            epoch = 0
            for kind, order in orders.items():
                for mode in order:
                    loader = loaders[kind, mode]
                    with frame_reader(mode):
                        batches = loader.epoch(0)
                        ahead = [next(batches), next(batches)]  # the look-ahead filled
                        t0 = time.perf_counter()
                        timed = list(itertools.islice(batches, n_batches))
                        load_s = time.perf_counter() - t0
                        batches.close()
                        check(len(timed) == n_batches and all(np.array_equal(a[v], b[v]) for a, b in
                                                              zip(reference, ahead) for v in views),
                              f"the {kind} loader with the {mode} reader gave other batches")
                        loaded = {"workers": n_workers, "batches_timed": n_batches,
                                  "items_per_s": n_batches * 16 / load_s, "ms_per_batch": load_s * 1e3 / n_batches}
                        epoch += 1
                        fed = device_prefetch(loader.epoch(epoch), "cuda", depth=2)
                        state, _ = step_fn(state, next(fed))  # warm-up
                        torch.cuda.synchronize()
                        launches.reset()
                        waits = []
                        t0 = time.perf_counter()
                        for _ in range(n_fed):
                            w0 = time.perf_counter()
                            device_batch = next(fed)
                            waits.append(time.perf_counter() - w0)
                            state, metrics = step_fn(state, device_batch)
                        torch.cuda.synchronize()
                        fed_s = time.perf_counter() - t0
                        fed.close()
                        got = launches.read()
                        check(got[:2] == (20 * n_fed, 20 * n_fed), f"fed steps launched {got}")
                        check(float(metrics["loss"]) == float(metrics["loss"]), "a fed step's loss is not finite")
                    fed_run = {"steps": n_fed, "ms_per_step": fed_s * 1e3 / n_fed,
                               "loader_wait_ms_per_step": sum(waits) * 1e3 / n_fed}
                    out["reader_loader"].setdefault(f"{kind}_{mode}", []).append(loaded)
                    out["reader_fed"].setdefault(f"{kind}_{mode}", []).append(fed_run)
                    print("reader_loader", kind, mode, json.dumps(loaded), "reader_fed", json.dumps(fed_run),
                          f"on {smi}", flush=True)
        out["reader_summary"] = {key: {
            "items_per_s": statistics.mean(r["items_per_s"] for r in out["reader_loader"][key]),
            "fed_ms_per_step": statistics.mean(r["ms_per_step"] for r in out["reader_fed"][key]),
            "fed_wait_ms_per_step": statistics.mean(r["loader_wait_ms_per_step"] for r in out["reader_fed"][key]),
        } for key in out["reader_loader"]}
        print("reader_summary", json.dumps(out["reader_summary"]), f"on {smi}", flush=True)
        del model, state, tx, reference, first

        # b. distribution on the one card. A one-rank NCCL group: pretrain.run and run_train (the regression
        # task) with mesh.multiprocess=true against the same runs without a group; cuDNN held to deterministic
        # algorithms in both, so that run-to-run noise does not hide a difference
        edes_dir = root / "acdc"
        edes_dir.mkdir()
        write_edes_studies(edes_dir, 16, tuple(from_dict(PACKAGED["regression/acdc"]).data.sax.patch_size), seed=4)
        pre = copy.deepcopy(config)
        pre.data.dir = str(data_dir)
        pre.data.max_n_samples = 16
        pre.train.update(n_epochs=1, n_warmup_epochs=0, use_process_workers=False)
        reg = from_dict(PACKAGED["regression/acdc"])
        reg.grad_ckpt = False
        reg.data.dir = str(edes_dir)
        reg.data.max_n_samples = 4
        reg.train.update(n_epochs=1, n_warmup_epochs=0, eval_interval=1, batch_size=4)
        one_rank = {}
        parts_s["reader"] = time.perf_counter() - t_phase
        t0 = time.perf_counter()
        # the two ranks' steps run beside the one-rank runs; leaving the block waits for them and checks them
        with two_rank_steps(config, root / "two_rank", smi) as two_rank:
            deterministic = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
            os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), RANK="0", WORLD_SIZE="1",
                              LOCAL_RANK="0")
            try:
                for name, cfg, entry, export in (("pretrain", pre, pretrain.run, "cinema.safetensors"),
                                                 ("run_train", reg, reg_acdc.run, "model_0.safetensors")):
                    runs = {}
                    for multiprocess in (False, True):
                        c = copy.deepcopy(cfg)
                        c.mesh = {**dict(c.get("mesh") or {}), "multiprocess": multiprocess}
                        c.logging.dir = str(root / f"runs_{name}_{multiprocess}")
                        launches.reset()
                        out_dir = entry(c, device="cuda")
                        got = launches.read()
                        records = [json.loads(line) for line in (out_dir / "metrics.jsonl").read_text().splitlines()]
                        runs[multiprocess] = (records, load_safetensors(out_dir / export), got)
                    check(dist.is_initialized() and dist.get_backend() == "nccl" and dist.get_world_size() == 1,
                          "the runs with mesh.multiprocess joined no one-rank NCCL group")
                    (rec_a, w_a, l_a), (rec_b, w_b, l_b) = runs[False], runs[True]
                    loss_key = "loss" if name == "pretrain" else "train_loss"
                    loss_a, loss_b = rec_a[0][loss_key], rec_b[0][loss_key]
                    bit_equal = loss_a == loss_b and all(np.array_equal(w_a[k], w_b[k]) for k in w_a)
                    one_rank[name] = {"loss": loss_a, "loss_group": loss_b, "bit_equal": bit_equal, "launches": l_b,
                                      "max_abs_weight_diff": max(float(np.abs(w_a[k].astype(np.float64) - w_b[k]).max())
                                                                 for k in w_a)}
                    check(l_a == l_b and l_b[0] > 0, f"{name}: launches {l_a} without the group, {l_b} with it")
                    check(abs(loss_a - loss_b) <= TRAIN_LOSS_RTOL * abs(loss_a), f"{name}: losses {loss_a} {loss_b}")
            finally:
                torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic
                if dist.is_initialized():
                    dist.destroy_process_group()
                for key in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
                    os.environ.pop(key, None)
            out["one_rank_nccl"] = one_rank
            print("one_rank_nccl", json.dumps(one_rank), f"on {smi}", flush=True)
        out["two_rank"] = two_rank
        parts_s["distribution"] = time.perf_counter() - t0
    out["launches"] = launches.totals
    modes = out["two_rank"]["modes"].values()
    out["rank_launches"] = {"packed_fwd": sum(m["launches_rank0"][0] for m in modes),
                            "packed_bwd": sum(m["launches_rank0"][1] for m in modes)}
    out["phase_s"] = time.perf_counter() - t_phase
    out["parts_s"] = parts_s
    report["distribution"] = out
    print("distribution_phase", json.dumps({"launches": out["launches"], "rank_launches": out["rank_launches"],
                                            "parts_s": parts_s, "phase_s": out["phase_s"]}), f"on {smi}", flush=True)
    return out


# Adam7: (x start, y start, x step, y step) of each pass
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def encode_png(samples: np.ndarray, colour_type: int, depth: int, interlace: bool = False,
               palette: np.ndarray | None = None) -> bytes:
    """A PNG of ``samples`` (height, width, channels) integers of ``depth`` bits (the card's machine has no PIL to
    write one): row r of each (sub-)image filtered None, Sub, Up, Average or Paeth by (r + width) % 5, Adam7 pass
    by pass where ``interlace``, a ``PLTE`` of ``palette`` (n, 3) for colour type 3, the data in three IDATs."""
    channels = samples.shape[2]
    bpp = max(1, channels * depth // 8)

    def scanlines(image: np.ndarray) -> bytes:
        h, w = image.shape[:2]
        if not h or not w:
            return b""
        flat = image.reshape(h, w * channels).astype(np.int64)
        if depth == 16:
            rows = flat.astype(">u2").view(np.uint8).reshape(h, -1)
        elif depth == 8:
            rows = flat.astype(np.uint8)
        else:
            bits = ((flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1).astype(np.uint8)
            rows = np.packbits(bits.reshape(h, -1), axis=1)
        x = rows.astype(np.int64)
        up = np.vstack([np.zeros((1, x.shape[1]), np.int64), x[:-1]])
        left = np.hstack([np.zeros((h, bpp), np.int64), x[:, :-bpp]])
        upleft = np.hstack([np.zeros((h, bpp), np.int64), up[:, :-bpp]])
        pa, pb, pc = abs(up - upleft), abs(left - upleft), abs(left + up - 2 * upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        kinds = (np.arange(h) + w) % 5
        predicted = np.choose(kinds[:, None], [np.zeros_like(x), left, up, (left + up) // 2, paeth])
        return np.hstack([kinds[:, None], (x - predicted) % 256]).astype(np.uint8).tobytes()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    height, width = samples.shape[:2]
    if interlace:
        raw = b"".join(scanlines(samples[y0::dy, x0::dx]) for x0, y0, dx, dy in ADAM7)
    else:
        raw = scanlines(samples)
    header = struct.pack(">IIBBBBB", width, height, depth, colour_type, 0, 0, int(interlace))
    plte = chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()) if palette is not None else b""
    data = zlib.compress(raw)
    cuts = [0, len(data) // 3, 2 * len(data) // 3, len(data)]
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header) + plte
            + b"".join(chunk(b"IDAT", data[a:b]) for a, b in zip(cuts, cuts[1:])) + chunk(b"IEND", b""))


PNG_VARIANTS = ("gray8", "palette8", "palette4", "adam7", "rgb16")


def png_variant(image: np.ndarray, variant: str) -> tuple[bytes, np.ndarray]:
    """(a PNG of the uint8 (height, width) ``image`` in ``variant``, the 8-bit gray image it holds): 8-bit gray;
    8-bit palette of the 256 grays; 4-bit palette of 16 grays (the image cut to 16 levels, v // 17 * 17);
    8-bit gray Adam7; 16-bit RGB with each sample v * 257."""
    ramp = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    if variant == "gray8":
        return encode_png(image[..., None], 0, 8), image
    if variant == "palette8":
        return encode_png(image[..., None], 3, 8, palette=ramp), image
    if variant == "palette4":
        levels = image // 17
        return encode_png(levels[..., None], 3, 4, palette=ramp[::17]), (levels * 17).astype(np.uint8)
    if variant == "adam7":
        return encode_png(image[..., None], 0, 8, interlace=True), image
    if variant == "rgb16":
        return encode_png(np.repeat(image[..., None].astype(np.uint16) * 257, 3, axis=2), 2, 16), image
    raise ValueError(variant)


def write_raw_landmark_variants(root: Path, seed: int, size: tuple = (256, 256), n: int = 10) -> dict:
    """A raw landmark tree as the landmark preprocessing reads it (``lax_2c.csv`` headerless, cohort_name, uid,
    view, landmark_number, x, y; ``lax_2c/images/<uid>.png``): ``n`` seeded (width, height) = ``size`` images,
    noise with three bright discs at the landmarks, image ``i`` written as ``PNG_VARIANTS[i % 5]``. Returns
    uid -> the 8-bit (height, width) image each file holds."""
    rs = np.random.RandomState(seed)
    (root / "lax_2c" / "images").mkdir(parents=True)
    w, h = size
    lines, originals = [], {}
    yy, xx = np.mgrid[:h, :w]
    for i in range(n):
        uid = f"U{i:03d}"
        image = rs.randint(0, 80, (h, w))
        for number in (1, 2, 3):
            x, y = rs.randint(16, w - 16), rs.randint(16, h - 16)
            image[(xx - x) ** 2 + (yy - y) ** 2 <= 16] = 230
            lines.append(f"cohort{i % 2},{uid},lax_2c,{number},{x}.00,{y}.00")
        png, originals[uid] = png_variant(image.astype(np.uint8), PNG_VARIANTS[i % len(PNG_VARIANTS)])
        (root / "lax_2c" / "images" / f"{uid}.png").write_bytes(png)
    (root / "lax_2c.csv").write_text("\n".join(lines) + "\n")
    return originals


def png_rgb(path: Path) -> np.ndarray:
    """The (height, width, 3) pixels of an 8-bit RGB PNG as ``viz.write_png`` writes it (one IDAT, filter 0)."""
    data = path.read_bytes()
    width, height, depth, colour_type = struct.unpack(">IIBB", data[16:26])
    check((depth, colour_type) == (8, 2), f"{path} is not an 8-bit RGB PNG")
    idat = data.index(b"IDAT")
    rows = np.frombuffer(zlib.decompress(data[idat + 4 : idat + int.from_bytes(data[idat - 4 : idat], "big") + 4]),
                         np.uint8).reshape(height, 3 * width + 1)
    check(not rows[:, 0].any(), f"{path}: a row with another filter than None")
    return rows[:, 1:].reshape(height, width, 3)


def last_slice_phase(report: dict, smi: str) -> dict:
    """Phase 15: PNGs as PIL reads them through the landmark preprocessing and heatmap forward, the run folders
    in the JAX package's format, and the cine_cmr example; returns the packed kernels' launches."""
    from cinema_tpu_torch.config import PACKAGED, from_dict
    from cinema_tpu_torch.data import LandmarkDetectionDataset, load_nifti, read_metadata, read_png_gray
    from cinema_tpu_torch.data.preprocess import landmark as landmark_preprocess
    from cinema_tpu_torch.examples import cine_cmr
    from cinema_tpu_torch.factory import get_segmentation_model, init_weights

    t_phase = time.perf_counter()
    launches = Launches()
    reset, read, counters = launches.reset, launches.read, launches.totals
    cuda, view, depth = torch.device("cuda"), "lax_2c", 12
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # a. one seeded landmark image in every variant, each read equal to its 8-bit original
        t0 = time.perf_counter()
        image = np.random.RandomState(15).randint(0, 256, (256, 256)).astype(np.uint8)
        for variant in PNG_VARIANTS:
            png, original = png_variant(image, variant)
            (tmp / f"{variant}.png").write_bytes(png)
            check(np.array_equal(read_png_gray(tmp / f"{variant}.png"), original.T.astype(np.float32)),
                  f"the {variant} PNG does not read as its 8-bit original")
        out["png_variants_s"] = time.perf_counter() - t0
        # b. a raw tree of such PNGs through landmark_preprocess (scale 1: the images stay 256x256) into the
        # dataset and one heatmap forward on the card
        t0 = time.perf_counter()
        originals = write_raw_landmark_variants(tmp / "raw", seed=15)
        landmark_preprocess.main(["--data_dir", str(tmp / "raw"), "--out_dir", str(tmp / "processed"),
                                  "--scale", "1.0"])
        out["landmark_preprocess_s"] = time.perf_counter() - t0
        for uid, original in originals.items():
            check(np.array_equal(read_png_gray(tmp / "processed" / view / "images" / f"{uid}.png"),
                                 original.T.astype(np.float32)), f"the processed {uid} is not its original")
        rows = read_metadata(tmp / "processed" / "train_metadata.csv")
        dataset = LandmarkDetectionDataset(tmp / "processed", rows, view)
        check(len(dataset) == 8, f"{len(dataset)} training images, expected 8 of 10")
        item = dataset.load(0, 0)
        check(item[f"{view}_image"].shape == (256, 256, 1), f"landmark item {item[f'{view}_image'].shape}")
        config = from_dict(PACKAGED["segmentation/landmark"])
        model = init_weights(get_segmentation_model(config, dtype=torch.bfloat16, device=cuda), seed=0).eval()
        batch = {view: torch.from_numpy(item[f"{view}_image"][None]).to(cuda, torch.bfloat16)}
        reset()
        with torch.no_grad():
            logits = model(batch)[view]
        torch.cuda.synchronize()
        got = read()
        check(got == (depth, 0, 0, 0), f"the heatmap forward launched {got}, expected {depth} packed forward")
        check(tuple(logits.shape) == (1, 256, 256, 3) and bool(torch.isfinite(logits).all()),
              f"heatmap logits {tuple(logits.shape)} not finite or of another shape")
        del model
        # c. the run folders of phases 8 to 11, checked as each was read
        check(all(task in RUN_FOLDERS for task in MNMS_TASKS), f"phase 9's run folders not all checked: "
                                                                f"{sorted(RUN_FOLDERS)}")
        out["run_folders"] = RUN_FOLDERS
        # d. cine_cmr with no --image: its PNG against the picture rendered here
        t0 = time.perf_counter()
        png = cine_cmr.main(["--out", str(tmp / "cmr" / "cine_cmr.png")])
        volume, header = load_nifti(tmp / "cmr" / "synthetic_sax_t.nii.gz")
        picture = cine_cmr.render_cmr_views(volume, header, 0, 4)
        pixels = png_rgb(png)
        check(pixels.shape == (cine_cmr.SIZE, cine_cmr.SIZE, 3) and np.array_equal(pixels, picture["canvas"]),
              f"cine_cmr's PNG {pixels.shape} is not the picture rendered here")
        after = picture["order"][picture["order"].index(("texture", 4)) + 1:]
        corners = [picture["corners"][d] for kind, d in after]
        check(len(corners) >= 1 and all(tuple(pixels[int(round(r)), int(round(c))]) == cine_cmr.OUTLINE
                                        for ring in corners for r, c in ring),
              "a slice drawn after the textured one lacks the outline colour at a projected corner")
        out["cine_cmr"] = {"png_bytes": png.stat().st_size, "corners_checked": 4 * len(corners),
                           "seconds": time.perf_counter() - t0}
    out["launches"] = dict(counters)
    out["phase_s"] = time.perf_counter() - t_phase
    report["last_slice"] = out
    print("last_slice", json.dumps({k: v for k, v in out.items() if k != "run_folders"}),
          f"run_folders {len(RUN_FOLDERS)}", f"on {smi}", flush=True)
    return counters


def tf32_sass() -> dict:
    """TF32 tensor-core instructions (``HMMA ... TF32``) of each f32 function, forward (``flash_fwd_tf32x3``) and
    backward (``flash_bwd_dkdv_tf32x3``, ``flash_bwd_dq_tf32x3``), in the built libraries' machine code, by
    cuobjdump (None where the toolkit has none)."""
    from cinema_tpu_torch import build

    tool = Path(build.nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    counts: dict = {}
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        sass = subprocess.run([str(tool), "--dump-sass", str(build.library_path(name))],
                              capture_output=True, text=True, timeout=300, check=True).stdout
        function = ""
        for line in sass.splitlines():
            if "Function :" in line:
                function = line.split("Function :")[1].strip()
                if "tf32x3" in function:
                    counts[function] = 0
            elif function in counts and "HMMA" in line and "TF32" in line:
                counts[function] += 1
    return counts


def tf32_probe() -> dict:
    """What one TF32 product on the tensor core (``tf32_probe`` of csrc/flash_attention_fwd.cu) does with the
    low 13 mantissa bits of an f32 operand (values off the TF32 grid by less than one TF32 ulp, from a zero
    sum) and how it rounds a sum (1 and -1 plus 0.75 of an f32 ulp of 1, exact in TF32)."""
    import ctypes

    from cinema_tpu_torch import build

    entry = build.load("flash_attention_fwd").cinema_tf32_probe
    entry.argtypes = [ctypes.c_void_p] * 4
    x = [1 + 2**-11 + 2**-12, -(1 + 2**-11 + 2**-12), 1 + 2**-10 - 2**-23, 1 + 3 * 2**-11, 3 * 2**-25, -3 * 2**-25]
    c = [0.0, 0.0, 0.0, 0.0, 1.0, -1.0]
    xs, cs = (torch.tensor(v + [0.0] * (16 - len(v)), device="cuda") for v in (x, c))
    y = torch.zeros(16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    check(entry(xs.data_ptr(), cs.data_ptr(), y.data_ptr(), stream) == 0, "the TF32 probe failed")
    got = y[:len(x)].tolist()
    modes = {"operand": (got[:4], [1.0, -1.0, 1.0, 1 + 2**-10], [1 + 2**-10, -(1 + 2**-10), 1 + 2**-10]),
             "sum": (got[4:], [1.0, -1.0], [1 + 2**-23, -(1 + 2**-23)])}
    out = {}
    for name, (read, toward_zero, nearest) in modes.items():
        out[name] = ("toward zero" if read == toward_zero else "to nearest" if read[:len(nearest)] == nearest
                     else "neither toward zero nor to nearest")
    return {**out, "x": x, "c": c, "read_as": got}


def kernel_row(name: str, source: str, replaces: str, launches: int, by_path: dict, rows: list[dict]) -> dict:
    """A kernel's entry of the kernels line: the headline numbers are the first
    row's, every timed shape is listed under ``shapes``."""
    keys = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_device_ms",
            "bound_share", "device_bound_share")
    timed = [r for r in rows if "ms" in r]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
        **{k: timed[0][k] for k in keys}, "launches_by_path": by_path,
        "shapes": [{"shape": r["shape"], "dtype": r["dtype"], **{k: r[k] for k in keys},
                    **{k: r[k] for k in ("bound_simt_ms", "dkdv_ms", "dq_ms", "delta_ms") if k in r}} for r in timed],
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="also write the full report as JSON to this path")
    parser.add_argument("--profile", action="store_true", help="profile one serving chunk and one training step")
    args = parser.parse_args()

    # 1. device
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on the card only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}", flush=True)
    # f32 comparisons in full f32; the evaluation's entry points are called with torch's defaults instead
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from cinema_tpu_torch import build
    from cinema_tpu_torch.ops import flash_attention as fa

    report = {"device": smi}

    # 2. build
    t0 = time.perf_counter()
    report["build_s"] = build.build()
    print(f"build {report['build_s']} total {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in build.build_logs.items():  # ptxas -v: registers, shared memory, spills per function
        function = "?"
        for line in log.splitlines():
            if "Compiling entry function" in line:
                function = line.split("'")[1]
            elif "registers" in line or "spill" in line or "wgmma" in line:  # wgmma: serialized products
                print(f"ptxas {name} {function}: {line.replace('ptxas info    :', '').strip()}", flush=True)
    # the C++ NIfTI frame reader (g++, seconds): built here, before the loaders' worker processes first read
    from cinema_tpu_torch import native

    report["native_reader"] = {"reader": native.reader(), **native.build_info}
    print("native_reader", json.dumps(report["native_reader"]), flush=True)
    check(report["native_reader"]["reader"] == "native", "the C++ NIfTI frame reader did not build or load")
    report["tf32_sass"] = tf32_sass()
    print("tf32_sass", json.dumps(report["tf32_sass"] if report["tf32_sass"] is not None else "cuobjdump not found"),
          flush=True)
    check(report["tf32_sass"] is None or (len(report["tf32_sass"]) == 3 * len(fa.HEAD_DIMS)
                                         and all(report["tf32_sass"].values())),
          "an f32 function (forward, dk/dv and dq, one each per head_dim) has no TF32 tensor-core instruction")
    report["tf32_probe"] = tf32_probe()
    print("tf32_probe", json.dumps(report["tf32_probe"]), flush=True)

    # 3. kernels against their plain versions
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    fwd_rows = check_attention_shapes(gen)
    bwd_rows = check_attention_bwd_shapes(gen)
    report["attention"], report["attention_bwd"] = fwd_rows, bwd_rows
    heads_fwd_rows, heads_bwd_rows = check_heads_shapes(gen)
    report["heads_attention"], report["heads_attention_bwd"] = heads_fwd_rows, heads_bwd_rows
    report["kv_gradient"] = check_kv_gradient(gen)
    dw_rows = check_depthwise_shapes(gen)
    report["depthwise"] = dw_rows
    report["kernels_s"] = time.perf_counter() - t0
    print(f"kernels checked and timed in {report['kernels_s']:.1f} s", flush=True)

    # 4. to 15. the paths at full width, launch counts set to 0 before each and read after
    t0 = time.perf_counter()
    serve_launches, serve_dw = serve_phase(report, smi, torch.Generator().manual_seed(1), args.profile)
    train_fwd, train_bwd, train_dw = train_phase(report, smi, args.profile)
    tune = finetune_phase(report, smi, args.profile)
    seg = segmentation_phase(report, smi, args.profile)
    lmk = landmark_phase(report, smi, args.profile)
    mnms = mnms_phase(report, smi, args.profile)
    cine = cine_phase(report, smi, args.profile)
    with ukb_ingest() as ukb:  # phase 13's real-size UKB CLI, in its own process beside phases 11 and 12
        baseline_phase(report, smi, args.profile)
        examples = examples_phase(report, smi)
        prep = preprocess_phase(report, smi, ukb)
    dist_out = distribution_phase(report, smi)
    dist_launches, rank_launches = dist_out["launches"], dist_out["rank_launches"]
    last = last_slice_phase(report, smi)
    report["paths_s"] = time.perf_counter() - t0
    print(f"paths driven in {report['paths_s']:.1f} s", flush=True)

    kernels = [
        kernel_row("flash_attention_packed_fwd", "cinema_tpu_torch/csrc/flash_attention_fwd.cu",
                   "cinema_tpu/ops/pallas/flash_attention.py:483",
                   serve_launches + train_fwd + tune["packed_fwd"] + seg["packed_fwd"] + lmk["packed_fwd"]
                   + mnms["packed_fwd"] + cine["packed_fwd"] + examples["packed_fwd"] + prep["packed_fwd"]
                   + dist_launches["packed_fwd"] + rank_launches["packed_fwd"] + last["packed_fwd"],
                   {"serve": serve_launches, "train": train_fwd, "finetune": tune["packed_fwd"],
                    "segmentation": seg["packed_fwd"], "landmark": lmk["packed_fwd"], "mnms": mnms["packed_fwd"],
                    "cine": cine["packed_fwd"], "examples": examples["packed_fwd"], "preprocess": prep["packed_fwd"],
                    "distribution": dist_launches["packed_fwd"], "distribution_rank0": rank_launches["packed_fwd"],
                    "last_slice": last["packed_fwd"]},
                   fwd_rows),
        kernel_row("flash_attention_packed_bwd", "cinema_tpu_torch/csrc/flash_attention_bwd.cu",
                   "cinema_tpu/ops/pallas/flash_attention.py:565",
                   train_bwd + tune["packed_bwd"] + seg["packed_bwd"] + lmk["packed_bwd"] + mnms["packed_bwd"]
                   + cine["packed_bwd"] + examples["packed_bwd"] + dist_launches["packed_bwd"]
                   + rank_launches["packed_bwd"],
                   {"train": train_bwd, "finetune": tune["packed_bwd"], "segmentation": seg["packed_bwd"],
                    "landmark": lmk["packed_bwd"], "mnms": mnms["packed_bwd"], "cine": cine["packed_bwd"],
                    "examples": examples["packed_bwd"], "distribution": dist_launches["packed_bwd"],
                    "distribution_rank0": rank_launches["packed_bwd"]}, bwd_rows),
        kernel_row("flash_attention_heads_fwd", "cinema_tpu_torch/csrc/flash_attention_fwd.cu",
                   "cinema_tpu/ops/pallas/flash_attention.py:143", tune["heads_fwd"],
                   {"finetune": tune["heads_fwd"]}, heads_fwd_rows),
        kernel_row("flash_attention_heads_bwd", "cinema_tpu_torch/csrc/flash_attention_bwd.cu",
                   "cinema_tpu/ops/pallas/flash_attention.py:285", tune["heads_bwd"],
                   {"finetune": tune["heads_bwd"]}, heads_bwd_rows),
    ]
    dw_src = "cinema_tpu_torch/csrc/depthwise_conv.cu"
    dw_replaces = "none: cuDNN's depthwise convolution (MaskedConvBlock.dw_conv)"
    # serving runs the forward alone; the timed MAE steps and every path counted through Launches all three
    dw_paths = {"finetune": tune, "segmentation": seg, "landmark": lmk, "mnms": mnms, "cine": cine,
                "examples": examples, "preprocess": prep, "distribution": dist_launches, "last_slice": last}
    for i, name in enumerate(("fwd", "dgrad", "wgrad")):
        by_path = {"serve": serve_dw if i == 0 else 0, "train": train_dw[i],
                   **{path: counts[f"depthwise_{name}"] for path, counts in dw_paths.items()}}
        kernels.append(kernel_row(f"depthwise_conv_{name}", dw_src, dw_replaces, sum(by_path.values()), by_path,
                                  dw_rows[name]))
    check(all(k["launches"] > 0 for k in kernels), "a kernel of the main paths was never launched")
    check(all(k["launches_by_path"]["landmark"] > 0 for k in kernels[:2]), "the landmark path launched no packed kernel")
    check(all(k["launches_by_path"]["mnms"] > 0 for k in kernels[:2]), "the M&Ms path launched no packed kernel")
    check(all(k["launches_by_path"]["cine"] > 0 for k in kernels[:2]), "the cine path launched no packed kernel")
    check(all(k["launches_by_path"]["examples"] > 0 for k in kernels[:2]), "the examples launched no packed kernel")
    check(kernels[0]["launches_by_path"]["preprocess"] > 0, "the preprocessed studies launched no packed forward")
    check(kernels[0]["launches_by_path"]["last_slice"] > 0, "the converted landmark PNG launched no packed forward")
    check(all(k["launches_by_path"][p] > 0 for k in kernels[:2] for p in ("distribution", "distribution_rank0")),
          "the distribution phase launched no packed kernel")
    check(all(k["launches_by_path"][p] > 0 for k in kernels[4:]
              for p in ("train", "finetune", "segmentation", "landmark", "mnms", "cine")),
          "a training path ran its conv stems without one of the depthwise kernels")
    # the f32 backward (split TF32) runs in the f32 check steps only: its launches there, apart
    f32_bwd = {key: sum(step[key] for step in F32_STEPS.values()) for key in ("packed_bwd", "heads_bwd")}
    report["f32_steps"] = {"steps": F32_STEPS, **f32_bwd}
    print("f32_steps", json.dumps(report["f32_steps"]), f"on {smi}", flush=True)
    kernels[1]["f32_step_launches"], kernels[3]["f32_step_launches"] = f32_bwd["packed_bwd"], f32_bwd["heads_bwd"]
    check(f32_bwd["packed_bwd"] > 0 and f32_bwd["heads_bwd"] > 0, "an f32 check step launched no f32 backward")
    report["kernels"] = kernels
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


def profile_call(label: str, fn, smi: str) -> dict:
    """Device time by kernel over one call of ``fn`` (torch.profiler), after one warm-up call and one
    call timed on the host clock without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        profiled_wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    check(bool(kernels), "the profiler recorded no device time")
    rows = sorted(((e.key, e.device_time_total / 1e3, e.count) for e in kernels), key=lambda r: -r[1])
    # the time the device was busy: the union of its kernels' intervals (kernels may overlap, so their
    # durations can add up to more than the wall time); the idle share takes busy time and wall time
    # from the same profiled call
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                              if e.device_type == torch.autograd.DeviceType.CUDA):
        busy_us += max(stop - max(start, end), 0.0)
        end = max(end, stop)
    result = {
        "device_busy_ms": busy_us / 1e3, "idle_share": 1.0 - busy_us / 1e3 / profiled_wall_ms,
        "wall_ms": wall_ms, "wall_ms_while_profiled": profiled_wall_ms,
        "attention_fwd_ms": sum(ms for key, ms, _ in rows if "flash_fwd" in key),
        "attention_bwd_ms": sum(ms for key, ms, _ in rows if "flash_bwd" in key),
        "top": [{"kernel": key[:100], "ms": ms, "calls": n} for key, ms, n in rows[:25]],
    }
    print(label, json.dumps(result), f"on {smi}", flush=True)
    return result


if __name__ == "__main__":
    main()
