#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure raises and exits non-zero:

  1. device   a CUDA card must be present; its name and power limit
  2. build    ``nvcc`` builds every kernel from this checkout's sources, one
              compiler per source, all started together
  3. kernels  each hand-written kernel against its plain PyTorch version on
              the card, at the shapes the main paths give it (the VGG trunk
              at 224x224, batch 4: its served forward, its prepare and its
              training step), with its time, the plain version's, the
              library call's and the least time the card could take
              (``bound_ms``); the tile DFTs' rows (forward and inverse)
              name the kernel form the wrapper launched (``form``, which
              must be the specialised one at these shapes) and give the
              achieved TB/s and the device time of the kernel and of the
              library call (``device_ms``, ``library_device_ms``: taken
              after every other timing, so these rows come out last); each
              inverse (kernels 2, 4, 6, 7) again at every other compiled
              tiles a block (``dft_bt``: 4 and 16 beside the default 8)
              over its main-path pass, its launch counted under that
              value, held to its plain version and timed (``tiles`` rows,
              the ``inverse_tiles`` line), and its generic form at delta 8
              at 4, 8 and 16 (``inverse_generic``); and the training
              step's dk (cuDNN) in both formulations
  4. slice    ``repro_torch.launch.serve --analyze`` serves the VGG trunk on
              backend ``fft-cuda`` (plan_network -> plan-lint of every
              layer on fake tensors -> prepare -> request batches ->
              weight-update sweep); launch counters show every forward ran
              the forward tile DFT, the CGEMM and the fused inverse once per
              layer, and every prepare the forward tile DFT once per layer;
              the output is held against the same trunk on backend
              ``direct`` (cuDNN, TF32 off)
  5. profile  kernel time by name for one served forward (torch.profiler)
  6. rect     the same trunk, weights and batch through the raw stage ops
              on the rect layout (the (16, 9) rfft2 grid, P = 144, which no
              plan uses): the rect forward tile DFT for stages 1 and 2, the
              CGEMM, and the rect inverse with bias + ReLU fused (a second
              pass: the plain rect inverse, then the epilogue); exact
              launches per forward and per transform sweep, both outputs
              against cuDNN, the p50 beside the slice's
  7. train    training steps (forward + backward) of the same trunk built
              from ``models.layers.conv_block`` on ``fft-cuda``: exact
              launches of every kernel per step, every layer's dk and
              d_bias against the same step on ``direct`` in float64
              (cuDNN) through the same ReLU masks and pool argmaxes, the
              masks and argmaxes that differ from a free float64 step's
              (a bounded few), the step times beside ``direct`` in
              float32, and device time by kernel over one step of each;
              then, reported only, the same comparisons with the input
              scaled by 1 + 1e-7 and 1 + 3e-7, for each forward form and
              for cuDNN (``train_witness``)
  8. trainer  ``repro_torch.examples.train_cnn_fftconv`` at its defaults on
              ``fft-cuda`` (its own asserts), its exact launches, and its
              first losses against the same run on ``direct``
  9. serve_trace  ``repro_torch.launch.serve --serve-trace`` on ``fft-cuda``:
              the continuous-batching engine over the full-width trunk,
              buckets (1, 2, 4, 8), one CUDA graph per bucket, a burst
              replay of a 64-request ragged trace.  Launches are counted at
              prepare, warm-up and capture and must be exactly theirs (the
              trace replays graphs and launches nothing from the host);
              graph replays equal the batches run; zero plan-cache misses
              after warm-up.  The first and last requests' results and one
              per bucket are held to the eager prepared forward of the same
              bucket (``GRAPH_TOL``) and to cuDNN (``SLICE_TOL``); so are
              two new inputs replayed through the batch-4 graph (with no
              launch) and a replay after ``update_weights`` (a recapture).
              Reported, not gated: per-bucket p50/p99/occupancy,
              throughput, start-up split, the graphs' memory, a lone
              batch-4 request's p50 and device busy time beside the eager
              ``slice``/``profile`` numbers, and the ``pad-max`` and
              ``replan`` engines on the same trace with the two ratios
              that ``serve --serve-compare`` gates
 10. tune     the measured autotuner on the served trunk, on a fresh
              temporary cache at the default budget: ``plan_network(...,
              backend="tuned")`` misses and measures all 9 layers, and the
              kernels' launches during the sweep are exactly every
              ``fft-cuda`` candidate's warm-up and timed calls (so every
              candidate of every layer was measured inside the budget: they
              come last), by CGEMM tile too; one line per layer with every
              candidate's time (``autotune.candidates`` and the tuner's own
              measuring function, again), the winner, and the ``fft-cuda``
              default point's time beside the winner's; the tuned trunk's
              prepared forward launches exactly its ``fft-cuda`` layers'
              kernels, each pinned CGEMM row among them, and is held to
              cuDNN (``SLICE_TOL``); so is the trunk on ``fft-cuda`` with
              each layer pinned to its fastest measured CGEMM tile and
              ``dft_bt`` (a pinned row on the main path, whatever won);
              every layer's ``fft-cuda`` default point timed at ``dft_bt``
              None and ``DFT_BT_ALT``, and the fused inverse launched at
              each plan's ``dft_bt`` (by value) in the sweep and the
              forwards; after
              ``autotune.reset()`` a fresh plan hits the cache on all 9
              layers, measures nothing and launches nothing, with the same
              winners, from a file of this ``CACHE_VERSION``.  Reported,
              not gated: both trunks' p50 and busy time beside the eager
              ``slice``/``profile``
 11. sharded  the paper's schedules on a one-rank NCCL mesh (one card: NCCL
              takes one rank per GPU): a process group started from a
              ``HashStore`` with ``device_id=cuda:0``, ``make_mesh((1, 1),
              ("data", "model"))``, and the served trunk (the slice's
              weights and request batch) through ``plan_network(mesh=)`` ->
              ``prepare`` -> forward on ``fft-cuda``, for ``nfft`` and
              ``wfft`` each with ``overlap="off"`` and ``"slab:2"``; then
              one layer one-shot on ``nfft``, with and without
              ``replicate_kernel_transform``.  Gates: the output's
              ``full_tensor()`` within ``GRAPH_TOL`` of the eager local
              ``fft-cuda`` trunk (phase ``slice``) and ``SLICE_TOL`` of
              cuDNN; exact launches per prepare and per forward, counted
              per layer and per slab, every slab of a layer on one CGEMM
              row, no generic tile DFT; exact collectives (prepared nfft
              ``2k`` boundary all-to-alls a layer and no all-reduce,
              one-shot one more unless the kernel transform is replicated;
              wfft ``k`` all-reduces a layer and no all-to-all).
              Before the trunks, the CGEMM at each configuration's
              per-slab shapes and pinned tile row against its plain
              version (``CGEMM_TOL``), and so is the CGEMM of each
              configuration's training forward and dx plans (phase 12's);
              and the forward tile DFT (stages 1 and 2), the fused inverse
              and the plain inverse at the tile counts each rank runs in
              those plans, slab by slab, against their plain versions
              (``FORWARD_TOL``, ``INVERSE_TOL``).  Reported, not gated: each
              configuration's p50 and busy time beside the local trunk's,
              and the device time of the NCCL kernels
 12. sharded_train  inside phase 11's process group, before it ends:
              training steps of phase 7's trunk, weights, biases, input and
              loss weights through ``plan_conv(..., schedule=, mesh=,
              overlap=)`` on ``fft-cuda`` for each configuration of phase
              11 (the plan-level VJP over the mesh: one-shot dx plans on the
              forward's schedule and slabs, dk and d_bias reduced over the
              mesh), pools on each rank's block, loss ``(h.full_tensor() *
              r).sum()``.  Gates: every layer's dk and d_bias a plain
              tensor; a step's grads within ``SHARDED_GRAD_TOL`` of a local
              ``fft-cuda`` step's, both with cuDNN held to its
              deterministic algorithms (its weight gradient, dk, may
              differ in its last bits from run to run: the timed step's
              grads against phase 7's last step are reported); the timed
              step's within ``GRAD_TOL`` of
              a float64 step through the step's own branches, with at most
              ``FLIP_LIMIT`` branches unlike a free float64 step's; exact
              launches per step (per layer and slab) and exact collectives
              per step (nfft ``2k + 1`` boundary all-to-alls a plan and no
              all-reduce, wfft ``k`` all-reduces a plan and no all-to-all,
              and the dk and d_bias reductions under their own kinds).
              Reported, not gated: the median step, one step's device busy
              time, NCCL device time, idle share and collective bytes,
              beside the local step's
 13. sharded_tune  inside phase 11's process group, before it ends: the
              tuner over the sharded schedules on the trunk, on a fresh
              temporary cache at the default budget: ``plan_network(...,
              mesh=, backend="tuned", overlap="auto")`` misses and
              measures all 9 layers (nfft/wfft x fft-torch/fft-cuda x
              off/slab:2/slab:4); the launches during the sweep are
              exactly those of the ``fft-cuda`` candidates it measured
              (``autotune.sweeps()``: a warm-up and ``reps`` one-shot
              calls each, per slab); every winner is a sharded schedule;
              the tuned trunk, prepared, launches exactly its ``fft-cuda``
              layers' kernels and is within ``GRAPH_TOL`` of the local
              trunk and ``SLICE_TOL`` of cuDNN; after ``autotune.reset()``
              a second planning hits the file on all 9 layers, measures
              and launches nothing.  Reported, not gated: each layer's
              measured candidates and how many of them the budget let it
              reach, the sweep's time, the tuned trunk's p50 and busy time
              beside phase 11's configurations
 14. sharded_serve  inside phase 11's process group, before it ends: phase
              9's engine (``ServeEngine``: the full-width trunk, buckets
              (1, 2, 4, 8), the same weights, inputs and 64-request burst
              trace) over the mesh, ``ServeEngine(..., mesh=, schedule=,
              overlap=, backend="fft-cuda")``, for each (schedule,
              overlap) of ``SERVE_SHARDED``: one CUDA graph per bucket
              captured over every layer's NCCL collectives and the gather
              of the output into a plain tensor.  Gates: a replay of the
              batch-4 graph runs the device operations of one eager run
              of the callable it captured, name by name and count by
              count (NCCL's one-rank all-to-alls are copies there, named
              by its ranges in the eager run; a one-rank all-reduce in
              place enqueues nothing, so only more ranks can show it in a
              graph), in one of up to ``READINGS`` profiler readings,
              since a session now and then drops a run of device records
              (none may hold an operation more; the eager side's reference
              is the per-name maximum of its readings, ``replay_gate``);
              launches (each bucket prepared afresh) and collectives
              (prepared nfft ``2k``
              all-to-alls a layer, wfft ``k`` all-reduces, one
              ``output_gather`` a forward) exact at start-up and again at
              ``update_weights``, none during the trace or a replay; graph
              replays equal the batches; zero plan-cache misses after
              warm-up; phase 9's placements; the first and last requests
              and one per bucket a plain tensor within ``GRAPH_TOL`` of the
              eager sharded forward of its bucket and of phase 9's result
              for the same request, and ``SLICE_TOL`` of cuDNN; the same
              for a request after ``update_weights``.  Reported, not gated:
              per-bucket p50/p99, throughput, start-up and capture seconds,
              graph memory, rank broadcasts, and a lone batch-4 request's
              p50, busy and NCCL device time beside phase 9's lone request
              and phase 11's eager sharded forward
 15. entry_points  the deprecated ``fft_conv2d_pallas`` on ``ONE_SHOT_LAYER``
              (batch 4): exactly the launches of that layer's one-shot
              ``fft-cuda`` plan (kernel 3 twice, the CGEMM, kernel 4: no
              epilogue, so the plain inverse), its ``DeprecationWarning``,
              within ``GRAPH_TOL`` of the plan and ``SLICE_TOL`` of cuDNN;
              then the example twins at their defaults on the card, their
              own asserts included: ``examples.quickstart`` (``auto`` plans
              ``fft-torch``/``direct``: none of the kernels) and
              ``examples.serve_batcher`` (``fft-cuda`` behind CUDA graphs:
              exact launches at start-up and at the weight update, one
              replay a batch)
 16. plan_lint  inside phase 11's process group, before it ends: the
              plan-lint analyzer (``repro_torch.conv.analyze``) on the card.
              Gates: the served trunk's ``fft-cuda`` plans analyzed on fake
              CUDA tensors are all certified, launch no kernel and leave
              ``memory_allocated`` unchanged, and give the facts of the
              same analysis on the host; on the NCCL mesh, for nfft and
              wfft x off and slab:2, each layer's static collective counts,
              bytes and stage counts equal what ``stage_trace`` records
              around one real forward of the same plan; ``analyze --check``
              over ``LINT_LIMIT`` Table-I layers exits 0, and 1 with
              ``--inject extra-collective``.  Reported, not gated: each
              layer's estimated peak live bytes of a prepared forward
              beside the measured ``max_memory_allocated`` increase
 17. plan_artifacts  after phase 10, and its sharded half inside phase 11's
              process group after phase 16: plan artifacts
              (``repro_torch.conv.export``).  Phase 9's engine (every
              bucket prepared afresh) exports its plans and slabs
              (``export_plans``: no launch, every prepare a cache hit), and
              a fresh ``ServeEngine(load_plans=)`` serves phase 9's trace
              from the file.  Gates: ``plan_source`` ``"aot"``; plan-cache
              hits and misses unchanged by the load; start-up launches
              those of phase 9's start-up less its prepares (the warm-up
              and capture forwards only); no launch in the trace, a replay
              a batch, zero plan-cache misses after warm-up, phase 9's
              placements; every loaded slab bit-equal (and stride-equal)
              to the live prepare's; the first and last requests and one
              per bucket within ``GRAPH_TOL`` of phase 9's results and
              ``SLICE_TOL`` of cuDNN; ``verify`` ok on all 36 layer
              entries; batch 4's fingerprints equal on the card's fake
              tensors, the host's and in the file; a copy stamped for
              another device warns, loads live and serves the same
              results; an engine of another ``weights_version`` falls
              back.  Then ``serve --serve-trace --conv-backend fft-cuda
              --load-plans`` in a fresh process exits 0 with source
              ``"aot"``, fingerprints verified and 0 misses, beside the
              same command planning live.  Phase 10's tuned trunk, loaded
              after ``autotune.reset()`` onto an empty temporary cache,
              measures and launches nothing, has the export's backend, tile
              row and ``dft_bt`` on every layer, and is within
              ``SLICE_TOL`` of cuDNN.  On the mesh, phase 14's nfft ``off``
              engine: ``load_network(mesh=)`` launches nothing, runs no
              counted collective, holds the caller's mesh and slabs
              bit-equal to the live prepare's; the engine from the file
              starts without prepares and serves within ``GRAPH_TOL`` of
              phase 14's results and ``SLICE_TOL`` of cuDNN.  Reported, not
              gated: export seconds, the file's MB and distinct slab
              members, load and capture seconds, slab bytes on the card
              live and loaded, both fresh processes' cold starts, the
              tuned load's seconds beside phase 10's sweep

 18. lm_serve  the LM serving path, which runs no hand-written kernel (its
              reference computes it all in plain ``jnp``), last: each of the
              ten architectures at its small form, float32 weights drawn on
              the host and copied to the card: ``serve.generate``'s prefill
              step and ``LM_STEPS`` greedy decode steps over the cache (from
              ``serve``'s decode position) and ``lm_forward`` (whisper:
              ``encode``, the prefill step, the decode steps and
              ``decode_train``), in float32 on the card against the same
              calls on the host (``LM_TOL`` of the largest |logit|, equal
              greedy tokens), and in bf16 on the card the decode steps
              against the teacher-forced forward (``LM_DECODE_TOL``, the
              reference's rtol and atol, gated for every arch but
              ``LM_DECODE_UNGATED``, mixtral, whose top-k sees other
              tokens in a decode step, and reported for it);
              then ``repro_torch.launch.serve``'s ``main`` (what ``python
              -m`` runs) with ``--arch qwen3-14b --batch 4 --prompt-len 32
              --gen 16``, at full width, in a child process (this process's
              memory freed first), whose last
              decode step's logits are held to ``lm_forward`` over the
              prompt and the generated tokens in that process
              (``LM_FULL_TOL`` of the largest |logit|, bf16; every planted
              fault of ``lm_planted_faults`` and the logits one position
              off beyond it), and the same
              prefill and decode steps in float32, teacher-forced on the
              served tokens, to the float32 forward (``LM_TOL``).  No
              kernel may launch.  Reported: prefill ms, decode ms a step,
              tokens/s, peak memory and one decode step's device time by
              kernel, beside the card's name and power limit

and then the ``kernels`` summary line (all seven kernels), the card's name
and power limit as ``nvidia-smi`` gives them, and the final ``{"ok": true,
...}`` line.  The launch counters are set to 0 right before each main path
(4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 17, 18) and read right after it; each
path must launch its own kernels and none of the others (phase 18 none),
and every tile DFT, forward and inverse, only in its specialised form.

Float32 references run in full float32: TF32 is off for matmuls and cuDNN.
"""
import collections
import dataclasses
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
from torch.distributed.tensor import DTensor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import ARCH_NAMES, get_config  # noqa: E402
from repro_torch.configs.paper_convs import network_convs  # noqa: E402
import torch.nn.functional as TF  # noqa: E402

from repro_torch.conv import (  # noqa: E402
    Epilogue, autodiff, autotune, autotune_info, clear_plan_cache,
    clear_prepared_cache, plan_cache_info, plan_conv, plan_network, stages)
from repro_torch.conv.analyze import main as analyze_main  # noqa: E402
from repro_torch.conv.backends import _cuda_fused_inverse  # noqa: E402
from repro_torch.core import fft_conv2d_pallas  # noqa: E402
from repro_torch.core.dft import compact_layout, num_freq_real  # noqa: E402
from repro_torch.core.fftconv import freq_count  # noqa: E402
from repro_torch.examples import (  # noqa: E402
    quickstart, serve_batcher, train_cnn_fftconv)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.cgemm import (  # noqa: E402
    cgemm_cuda, cgemm_ref, choose_variant, operand_variant,
    shape_for_blocks)
from repro_torch.kernels.dft_tile import (  # noqa: E402
    tile_fft_cuda, tile_fft_ref, tile_ifft_cuda, tile_ifft_epilogue_cuda,
    tile_ifft_epilogue_ref, tile_ifft_ref, tile_irfft_cuda,
    tile_irfft_epilogue_cuda, tile_irfft_epilogue_ref, tile_irfft_ref,
    tile_rfft_cuda, tile_rfft_ref)
from repro_torch.kernels.dft_tile import ops as dft_ops  # noqa: E402
from repro_torch.launch import batcher, serve  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402
from repro_torch.models import whisper as WH  # noqa: E402
from repro_torch.models.layers import conv_block, maxpool2x2  # noqa: E402

IMAGE, BATCH, GEN, SEED = 224, 4, 10, 0
TRAIN_STEPS = 5                         # timed training steps per backend
DFT_SRC = "src/repro_torch/kernels/dft_tile/csrc/dft_tile.cu"
# name -> (wrapper whose .launches counts its kernel, source, TPU kernel)
KERNELS = {
    "cgemm": (cgemm_cuda, "src/repro_torch/kernels/cgemm/csrc/cgemm.cu",
              "src/repro/kernels/cgemm/kernel.py:25"),
    "tile_irfft_epilogue": (tile_irfft_epilogue_cuda, DFT_SRC,
                            "src/repro/kernels/dft_tile/kernel.py:88"),
    "tile_rfft": (tile_rfft_cuda, DFT_SRC,
                  "src/repro/kernels/dft_tile/kernel.py:40"),
    "tile_irfft": (tile_irfft_cuda, DFT_SRC,
                   "src/repro/kernels/dft_tile/kernel.py:79"),
    "tile_fft": (tile_fft_cuda, DFT_SRC,
                 "src/repro/kernels/dft_tile/kernel.py:20"),
    "tile_ifft": (tile_ifft_cuda, DFT_SRC,
                  "src/repro/kernels/dft_tile/kernel.py:121"),
    "tile_ifft_epilogue": (tile_ifft_epilogue_cuda, DFT_SRC,
                           "src/repro/kernels/dft_tile/kernel.py:137"),
}

# NVIDIA H100 SXM data sheet, dense rates
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12,     # float32 outside the tensor cores
              torch.bfloat16: 989e12}   # bf16 tensor cores
CGEMM_TOL = {torch.float32: 2e-5, torch.bfloat16: 5e-2}  # scaled atol
INVERSE_TOL = 1e-4                                        # scaled atol
FORWARD_TOL = 2e-5                      # scaled atol, forward tile DFT
SLICE_TOL = 1e-3                        # max|y - y_direct| / max|y_direct|
GRAD_TOL = 3e-4                         # max|g - g_f64| / max|g_f64|,
#                                         same branches (PERF.md §6)
FLIP_LIMIT = 100                        # ReLU/pool choices unlike float64's
WITNESS_EPS = (0.0, 1e-7, 3e-7)         # input scalings, branch_witness
LOSS_TOL = 1e-3                         # |l - l_direct| / |l_direct|
GRAPH_TOL = 1e-5                        # graph replay vs the eager prepared
#                                         forward, scaled by max|y|
SERVE_MAX_BATCH, SERVE_REQUESTS = 8, 64
SERVE_WINDOW_MS = 2.0                   # serve --batch-window-ms default
LONE_REQUESTS = 20                      # timed lone batch-4 requests
# the tuner's settings, unset for phase tune (its defaults: 2000 ms a
# layer, 3 timed calls a candidate); its cache goes to a temporary file
SHARDED = [("nfft", "off"), ("nfft", "slab:2"), ("wfft", "off"),
           ("wfft", "slab:2")]          # (schedule, overlap) of phases 11-12
SHARDED_GRAD_TOL = 1e-6                 # sharded vs local step's grads,
#                                         scaled by max|g|, on one rank
ONE_SHOT_LAYER = "Vconv3.1"
# (schedule, overlap) of phase 14, the engine over the mesh
SERVE_SHARDED = [("nfft", "off"), ("wfft", "off"), ("wfft", "slab:2")]
READINGS = 5                            # profiler readings a side of the
#                                         replay gate may take (PERF.md §7)
LM_BATCH, LM_PROMPT, LM_STEPS = 2, 8, 3  # phase 18's small-form runs
LM_TOL = 1e-4                           # card vs host, float32, of the
                                        # largest |logit|
LM_DECODE_TOL = 2e-2                    # bf16 decode vs forward: rtol and
                                        # atol of tests/test_models.py
# mixtral's top-k and capacity see other tokens in a decode step than in
# the forward, so its decode is reported, not gated; every other arch's is
LM_DECODE_UNGATED = ("mixtral-8x7b",)
# qwen3-14b at full width: the served (bf16) last decode step against
# lm_forward, of the largest |logit|.  40 layers of bf16 rounding (8
# significant bits) in products of other shapes part the two: 4.53e-2 on
# the H100 (PERF.md, PR 26).  The weakest planted fault, the last layer
# skipped, reads 0.168, qk-norm off 1.15, RoPE theta 1e4 1.50, one position
# off 1.47: the gate sits near the geometric middle of 4.53e-2 and 0.168,
# and each fault must read beyond it.  The same tokens in float32 are held
# to LM_TOL.
LM_FULL_TOL = 0.1
LM_FULL_ARGS = ["--arch", "qwen3-14b", "--batch", "4", "--prompt-len", "32",
                "--gen", "16"]
TUNE_ENV = ("REPRO_TORCH_AUTOTUNE", "REPRO_TORCH_AUTOTUNE_CACHE",
            "REPRO_TORCH_AUTOTUNE_BUDGET_MS", "REPRO_TORCH_AUTOTUNE_REPS")


# the inverse kernels: (wrapper, plain version, compact layout, fused tail)
INVERSES = {
    "tile_irfft_epilogue": (tile_irfft_epilogue_cuda, tile_irfft_epilogue_ref,
                            True, True),
    "tile_irfft": (tile_irfft_cuda, tile_irfft_ref, True, False),
    "tile_ifft": (tile_ifft_cuda, tile_ifft_ref, False, False),
    "tile_ifft_epilogue": (tile_ifft_epilogue_cuda, tile_ifft_epilogue_ref,
                           False, True),
}
# the inverse's tiles a block other than its default, timed in phase 3
OTHER_TILES = tuple(t for t in dft_ops.INVERSE_TILES
                    if t != dft_ops.DEFAULT_TILES)

# wrappers whose kernel has forms (``dft_ops.choose_form``,
# ``dft_ops.choose_inverse_form``)
FORMS = {"tile_rfft": tile_rfft_cuda, "tile_fft": tile_fft_cuda,
         "tile_irfft_epilogue": tile_irfft_epilogue_cuda,
         "tile_irfft": tile_irfft_cuda, "tile_ifft": tile_ifft_cuda,
         "tile_ifft_epilogue": tile_ifft_epilogue_cuda}


def zero_counts():
    for wrapper, _, _ in KERNELS.values():
        wrapper.launches = 0
    for wrapper in FORMS.values():
        wrapper.form_launches = dict.fromkeys(wrapper.form_launches, 0)
    for wrapper, *_ in INVERSES.values():
        wrapper.tiles_launches = dict.fromkeys(wrapper.tiles_launches, 0)
    cgemm_cuda.variant_launches = dict.fromkeys(
        cgemm_cuda.variant_launches, 0)


def read_counts():
    """Launches per kernel, and the tile DFTs' launches in their generic
    form (``<kernel> generic``)."""
    counts = {name: wrapper.launches
              for name, (wrapper, _, _) in KERNELS.items()}
    for name, wrapper in FORMS.items():
        counts[f"{name} generic"] = wrapper.form_launches["generic"]
    return counts


def expect_counts(what, got, want):
    """``want`` names the kernels the path launches; every other kernel
    must not have been launched, nor a tile DFT in its generic form (every
    main path's tiles and planes take the specialised one)."""
    want = {**{k: 0 for k in got}, **want}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def ptxas_report(log):
    """Registers and spill bytes of each kernel in a ``-Xptxas -v`` log,
    the kernel named by its template arguments."""
    rows, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            t = re.search(r"([a-z]+\d*_kernel)I(.*?)EEv", name)
            if t:
                args = re.sub(r"L[ib](\d+)E", r"\1,", t.group(2))
                args = args.replace("13__nv_bfloat16", "bf16,")
                args = re.sub(r"^f", "float,", args)
                name = f"{t.group(1)}<{args.rstrip(',')}>"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append(f"{name}: {m.group(1)} registers, {spill} B spilled")
            name = None
    return rows


def time_ms(fn, reps=10, groups=5, short_groups=25):
    """Median over ``groups`` of the mean time of ``reps`` back-to-back
    calls, on CUDA events, after a warm-up.  A call under 0.1 ms takes
    ``short_groups`` groups: its time is the wrapper's host time, which
    the host's noise moves in bursts that a longer window outvotes."""
    fn()
    torch.cuda.synchronize()
    means = []
    while len(means) < (short_groups if means and means[0] < 0.1
                        else groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / reps)
    return statistics.median(means)


def bound(nbytes, flops, dtype):
    """Least time for the work: the larger of bytes over the memory rate
    and operations over the peak for the operand type."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops,
                peak_tflops=PEAK_FLOPS[dtype] / 1e12,
                hbm_tb_s=HBM_BYTES_S / 1e12)


def main_path_layers():
    """(name, ConvSpec) of every layer of the served trunk."""
    layers = network_convs(serve._vgg_scale(IMAGE), BATCH)
    net = plan_network(layers, backend="fft-cuda")
    return [(name, plan.spec) for name, plan in net.items()]


def dx_plan_layers():
    """(name, ConvSpec) of the dx plan of every layer but the first (whose
    input, the image, needs no grad) in a training step of the trunk."""
    layers = network_convs(serve._vgg_scale(IMAGE), BATCH)
    net = plan_network(layers, backend="fft-cuda")
    return [(name, autodiff._transposed_plan(plan).spec)
            for name, plan in list(net.items())[1:]]


def cgemm_row(name, P, M, C, N, dtype, three_m, spectrum, gen, shape=None,
              **extra):
    """One CGEMM case: the wrapper (on tile row ``shape`` of ``SHAPES``
    when given, else the chooser's) against ``cgemm_ref`` within
    ``CGEMM_TOL``, timed beside the plain version and complex64
    ``torch.matmul``; emitted as a ``kernel`` row naming the variant
    launched, the achieved rate of 3M/4M operations and of bytes, and the
    bound's share of the time."""
    Dr, Di = (torch.randn((P, M, C), generator=gen, device="cuda")
              .to(dtype) for _ in range(2))
    Gr, Gi = (torch.randn((P, C, N), generator=gen, device="cuda")
              .to(dtype) for _ in range(2))
    Zr, Zi = cgemm_cuda(Dr, Di, Gr, Gi, three_m=three_m, shape=shape)
    Rr, Ri = cgemm_ref(Dr, Di, Gr, Gi, three_m=three_m)
    torch.cuda.synchronize()
    err = max((Zr.float() - Rr.float()).abs().max().item(),
              (Zi.float() - Ri.float()).abs().max().item())
    scale = Rr.float().abs().max().item() + 1e-9
    if not err / scale <= CGEMM_TOL[dtype]:
        raise AssertionError(
            f"cgemm {name} {dtype} three_m={three_m} shape={shape} "
            f"{[P, M, C, N]}: scaled error {err / scale:.3e} > "
            f"{CGEMM_TOL[dtype]}")
    ms = time_ms(lambda: cgemm_cuda(Dr, Di, Gr, Gi, three_m=three_m,
                                    shape=shape))
    plain_ms = time_ms(lambda: cgemm_ref(Dr, Di, Gr, Gi, three_m=three_m))
    library_ms = None
    if dtype == torch.float32:
        Dc, Gc = torch.complex(Dr, Di), torch.complex(Gr, Gi)
        library_ms = time_ms(lambda: torch.matmul(Dc, Gc))
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = 2 * size * (P * M * C + P * C * N + P * M * N)
    flops = (6 if three_m else 8) * P * M * C * N
    b = bound(nbytes, flops, dtype)
    v = operand_variant(Dr, Di, Gr, Gi, shape)
    row = dict(kernel="cgemm", layer=name, shape=[P, M, C, N],
               spectrum=spectrum, dtype=str(dtype).removeprefix("torch."),
               three_m=three_m, variant=v.name, variant_code=v.code,
               max_abs_err=err, scaled_err=err / scale, ms=ms,
               plain_ms=plain_ms, library_ms=library_ms,
               tflops=flops / ms / 1e9, tb_s=nbytes / ms / 1e9,
               bound_share=b["bound_ms"] / ms, **extra, **b)
    emit("kernel", **row)
    return row


def check_cgemm(layers, gen):
    """At the served forward's shapes (P = 130) in float32 3M and 4M and
    with bf16 operands, and at the rect path's (P = 144) in float32 3M,
    each on the chooser's tile row."""
    return [cgemm_row(name, freq_count(spec, spectrum), spec.M, spec.C,
                      spec.Cout, dtype, three_m, spectrum, gen)
            for dtype, three_m, spectrum in (
                (torch.float32, True, "real"),
                (torch.float32, False, "real"),
                (torch.bfloat16, True, "real"),
                (torch.float32, True, "rect"))
            for name, spec in layers]


def check_inverse(layers, gen):
    """The fused compact inverse at every output tile count of the served
    trunk (ReLU), under the other activations at Vconv1.2, and on planes
    padded to P = 136 with NaN past point 130.  No single library call
    computes it.  The rows are emitted by ``device_times``."""
    cases = [(name, spec, "relu", freq_count(spec, "real"))
             for name, spec in layers]
    name12, spec12 = layers[1]
    cases += [(name12, spec12, act, 130) for act in ("none", "gelu", "silu")]
    cases.append((name12, spec12, "relu", 136))        # P padded past 130
    return [epilogue_row(name, spec.B * spec.Cout * spec.X * spec.D, P, act,
                         gen)
            for name, spec, act, P in cases]


def epilogue_row(name, n, P, act, gen, d=16, **extra):
    """The fused compact inverse on ``n`` tiles of ``P`` points (NaN past
    point 130, which must never be read) under ``act`` against its plain
    version, timed beside it, at the kernel's default tiles a block.  The
    row is emitted by ``device_times``."""
    Zr, Zi = (torch.randn((n, P), generator=gen, device="cuda")
              for _ in range(2))
    if P > 130:                      # trailing points must never be read
        Zr[:, 130:] = float("nan")
        Zi[:, 130:] = float("nan")
    b = torch.randn((n,), generator=gen, device="cuda")
    y, form = form_launch(tile_irfft_epilogue_cuda, Zr, Zi, b,
                          activation=act, delta=d)
    y0 = tile_irfft_epilogue_ref(Zr[:, :130], Zi[:, :130], b,
                                 activation=act, delta=d)
    torch.cuda.synchronize()
    err = (y - y0).abs().max().item()
    scale = y0.abs().max().item() + 1e-9
    if not err / scale <= INVERSE_TOL:
        raise AssertionError(
            f"tile_irfft_epilogue {name} {act} P={P} {extra}: scaled "
            f"error {err / scale:.3e} > {INVERSE_TOL}")
    ms = time_ms(lambda: tile_irfft_epilogue_cuda(
        Zr, Zi, b, activation=act, delta=d))
    plain_ms = time_ms(lambda: tile_irfft_epilogue_ref(
        Zr, Zi, b, activation=act, delta=d))
    dh = d // 2 + 1
    nbytes = 4 * (2 * n * P + n + n * d * d)
    flops = n * (8 * d * dh * d + 4 * d * d * dh)
    bd = bound(nbytes, flops, torch.float32)
    return dict(kernel="tile_irfft_epilogue", layer=name, shape=[n, P, d],
                activation=act, tiles=dft_ops.DEFAULT_TILES,
                max_abs_err=err, scaled_err=err / scale,
                ms=ms, plain_ms=plain_ms, library_ms=None,
                **form_fields(ms, form, bd), **extra, **bd)


def device_ms(fn, reps=20):
    """Device time of one call of ``fn``: the device time of every kernel
    that ``reps`` calls launched (``device_profile``), over ``reps``."""
    fn()
    torch.cuda.synchronize()
    return device_profile(lambda: [fn() for _ in range(reps)])[1] / reps / 1e3


def form_launch(wrapper, *args, **kw):
    """One launch of a tile DFT wrapper at a main path's shape, which must
    take the specialised form there: the wrapper's per-form count names
    the form it launched, and an inverse's per-value count the tiles a
    block it launched at (``tiles=``, else the default)."""
    before = dict(wrapper.form_launches)
    tiles_before = dict(getattr(wrapper, "tiles_launches", {}))
    out = wrapper(*args, **kw)
    form = [f for f, c in wrapper.form_launches.items() if c != before[f]]
    if form != ["specialised"]:
        raise AssertionError(f"{wrapper.__name__} launched form {form} on "
                             f"{tuple(args[0].shape)}, not the specialised")
    if tiles_before:
        moved = [t for t, c in wrapper.tiles_launches.items()
                 if c != tiles_before[t]]
        want = dft_ops.resolve_tiles(kw.get("tiles"))
        if moved != [want]:
            raise AssertionError(f"{wrapper.__name__} launched at tiles "
                                 f"{moved}, not {want}")
    return out, form[0]


def form_fields(ms, form, b):
    """The tile DFT rows' own fields: the form launched, the achieved bytes
    rate and the bound's share of the time ``ms``."""
    return dict(form=form, tb_s=b["bytes"] / ms / 1e9,
                bound_share=b["bound_ms"] / ms)


def device_calls(row, d=16):
    """The kernel call (an inverse at the row's ``tiles``) and the library
    call (None where there is none, or where the row timed none) of a tile
    DFT row, on fresh inputs of the row's shape."""
    kernel, n = row["kernel"], row["shape"][0]
    dh = d // 2 + 1
    tiles = row.get("tiles")
    if kernel in ("tile_rfft", "tile_fft"):
        x = torch.randn((n, d, d), device="cuda")
        if kernel == "tile_rfft":
            store = compact_layout(d, "cuda")[0].long()
            return (lambda: tile_rfft_cuda(x, delta=d),
                    lambda: torch.fft.rfft2(x).reshape(n, -1).index_select(
                        1, store))
        return (lambda: tile_fft_cuda(x, delta=d),
                lambda: torch.fft.rfft2(x))
    if kernel == "tile_ifft":
        Z = torch.fft.rfft2(torch.randn((n, d, d), device="cuda"))
        Zr, Zi = Z.real.contiguous(), Z.imag.contiguous()
        return (lambda: tile_ifft_cuda(Zr, Zi, delta=d, tiles=tiles),
                lambda: torch.fft.irfft2(Z, s=(d, d)))
    if kernel == "tile_ifft_epilogue":
        Zr, Zi = (torch.randn((n, d, dh), device="cuda") for _ in range(2))
        b = torch.randn((n,), device="cuda")
        return (lambda: tile_ifft_epilogue_cuda(
            Zr, Zi, b, activation=row["activation"], delta=d, tiles=tiles),
            None)
    P = row["shape"][1]
    Zr, Zi = (torch.randn((n, P), device="cuda") for _ in range(2))
    if kernel == "tile_irfft":
        _, src, sgn = compact_layout(d, "cuda")
        src = src.long()
        return (lambda: tile_irfft_cuda(Zr, Zi, delta=d, tiles=tiles),
                lambda: torch.fft.irfft2(torch.complex(
                    Zr.index_select(1, src), Zi.index_select(1, src) * sgn)
                    .view(n, d, dh), s=(d, d)))
    b = torch.randn((n,), device="cuda")
    return (lambda: tile_irfft_epilogue_cuda(
        Zr, Zi, b, activation=row["activation"], delta=d, tiles=tiles),
        None)


def device_times(rows):
    """Add to each tile DFT row the device time of its kernel and of its
    library call (``device_ms``, ``library_device_ms``; None where no
    single library call computes the same function), on fresh inputs of
    the row's shape, and emit the row.  Run after every other timing of
    the script, so that no profiler session runs among timed calls."""
    for row in rows:
        kernel, library = device_calls(row)
        if row.get("library_ms") is None:
            library = None
        row.update(device_ms=device_ms(kernel),
                   library_device_ms=(device_ms(library) if library
                                      else None))
        emit("kernel", **row)
        del kernel, library


def check_forward(layers, gen):
    """The forward tile DFT at every stage-1 and every stage-2 tile count
    of the served trunk (stage 2 runs in every prepare and, for the
    forward's and the dx plan's kernels, twice a training step).  The
    rows are emitted by ``device_times``."""
    cases = [(name, "stage1", spec.B * spec.C * spec.X * spec.D)
             for name, spec in layers]
    cases += [(name, "stage2", spec.Cout * spec.C) for name, spec in layers]
    return [forward_row(name, n, gen, stage=stage)
            for name, stage, n in cases]


def forward_row(name, n, gen, d=16, **extra):
    """The forward tile DFT on ``n`` tiles against its plain version,
    timed beside it and the library call, which is two:
    ``torch.fft.rfft2`` of the tiles and the ``store`` gather.  The row is
    emitted by ``device_times``."""
    store = compact_layout(d, "cuda")[0].long()
    P = store.numel()
    x = torch.randn((n, d, d), generator=gen, device="cuda")
    (Tr, Ti), form = form_launch(tile_rfft_cuda, x, delta=d)
    Rr, Ri = tile_rfft_ref(x, d)
    torch.cuda.synchronize()
    err = max((Tr - Rr).abs().max().item(), (Ti - Ri).abs().max().item())
    scale = max(Rr.abs().max().item(), Ri.abs().max().item()) + 1e-9
    if not err / scale <= FORWARD_TOL:
        raise AssertionError(
            f"tile_rfft {name} {extra}: scaled error {err / scale:.3e} > "
            f"{FORWARD_TOL}")
    ms = time_ms(lambda: tile_rfft_cuda(x, delta=d))
    plain_ms = time_ms(lambda: tile_rfft_ref(x, d))
    library_ms = time_ms(lambda: torch.fft.rfft2(x).reshape(
        n, -1).index_select(1, store))
    dh = d // 2 + 1
    nbytes = 4 * (n * d * d + 2 * n * P)
    flops = n * (4 * d * d * dh + 8 * d * P)
    b = bound(nbytes, flops, torch.float32)
    return dict(kernel="tile_rfft", layer=name, shape=[n, d, P],
                max_abs_err=err, scaled_err=err / scale, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms,
                library="torch.fft.rfft2 + index_select (two calls)",
                **form_fields(ms, form, b), **extra, **b)


def dft_key(row):
    """What makes a compact tile DFT case: the kernel, the tile count, the
    points a tile and the activation (None without one)."""
    n, a, b = row["shape"]
    return (row["kernel"], n, b if row["kernel"] == "tile_rfft" else a,
            row.get("activation"))


def plain_inverse_row(name, n, P, gen, d=16, **extra):
    """The plain compact inverse on ``n`` tiles of ``P`` points against
    its plain version, timed beside it and the library call, which is
    two: the ``src``/``sgn`` scatter (a gather, a sign product, a complex
    pack) and ``torch.fft.irfft2``.  The row is emitted by
    ``device_times``."""
    dh = d // 2 + 1
    _, src, sgn = compact_layout(d, "cuda")
    src = src.long()
    Zr, Zi = (torch.randn((n, P), generator=gen, device="cuda")
              for _ in range(2))
    y, form = form_launch(tile_irfft_cuda, Zr, Zi, delta=d)
    y0 = tile_irfft_ref(Zr, Zi, d)
    torch.cuda.synchronize()
    err = (y - y0).abs().max().item()
    scale = y0.abs().max().item() + 1e-9
    if not err / scale <= INVERSE_TOL:
        raise AssertionError(
            f"tile_irfft {name} dx plan {extra}: scaled error "
            f"{err / scale:.3e} > {INVERSE_TOL}")
    ms = time_ms(lambda: tile_irfft_cuda(Zr, Zi, delta=d))
    plain_ms = time_ms(lambda: tile_irfft_ref(Zr, Zi, d))
    library_ms = time_ms(lambda: torch.fft.irfft2(torch.complex(
        Zr.index_select(1, src), Zi.index_select(1, src) * sgn)
        .view(n, d, dh), s=(d, d)))
    nbytes = 4 * (2 * n * P + n * d * d)
    flops = n * (8 * d * dh * d + 4 * d * d * dh)
    b = bound(nbytes, flops, torch.float32)
    return dict(kernel="tile_irfft", layer=name, stage="dx plan",
                shape=[n, P, d], tiles=dft_ops.DEFAULT_TILES,
                max_abs_err=err, scaled_err=err / scale,
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                library="scatter + torch.fft.irfft2 (two steps)",
                **form_fields(ms, form, b), **extra, **b)


def check_plain_inverse(dx_layers, gen):
    """The plain compact inverse at the tile count of every dx plan of a
    training step."""
    return [plain_inverse_row(name, spec.B * spec.Cout * spec.X * spec.D,
                              freq_count(spec, "real"), gen)
            for name, spec in dx_layers]


def rect_bytes_flops(n, d, tail=False):
    """One rect tile DFT over n tiles, either way: each tile's d*d floats
    and its two R-point planes (and a bias with the tail) moved once; the
    two products 12*d*R operations a tile (w axis then u axis forward,
    the reverse inverse)."""
    R = d * (d // 2 + 1)
    return 4 * (n * d * d + 2 * n * R + (n if tail else 0)), 12 * d * R * n


def check_rect_forward(layers, gen):
    """Kernel 5 at every stage-1 tile count and every stage-2 count of the
    served trunk.  The library call is one: ``torch.fft.rfft2``.  The rows
    are emitted by ``device_times``."""
    rows = []
    d = 16
    cases = [(name, "stage1", spec.B * spec.C * spec.X * spec.D)
             for name, spec in layers]
    cases += [(name, "stage2", spec.Cout * spec.C) for name, spec in layers]
    for name, stage, n in cases:
        x = torch.randn((n, d, d), generator=gen, device="cuda")
        (Tr, Ti), form = form_launch(tile_fft_cuda, x, delta=d)
        Rr, Ri = tile_fft_ref(x, d)
        X = torch.fft.rfft2(x)
        torch.cuda.synchronize()
        err = max((Tr - Rr).abs().max().item(), (Ti - Ri).abs().max().item())
        scale = max(Rr.abs().max().item(), Ri.abs().max().item()) + 1e-9
        if not err / scale <= FORWARD_TOL:
            raise AssertionError(
                f"tile_fft {name} {stage}: scaled error {err / scale:.3e} >"
                f" {FORWARD_TOL}")
        library_err = max((Tr - X.real).abs().max().item(),
                          (Ti - X.imag).abs().max().item())
        ms = time_ms(lambda: tile_fft_cuda(x, delta=d))
        plain_ms = time_ms(lambda: tile_fft_ref(x, d))
        library_ms = time_ms(lambda: torch.fft.rfft2(x))
        b = bound(*rect_bytes_flops(n, d), torch.float32)
        row = dict(kernel="tile_fft", layer=name, stage=stage,
                   shape=[n, d, d // 2 + 1], max_abs_err=err,
                   scaled_err=err / scale, library_abs_diff=library_err,
                   ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   library="torch.fft.rfft2", **form_fields(ms, form, b),
                   **b)
        rows.append(row)
    return rows


def check_rect_inverse(layers, gen):
    """Kernels 6 and 7 at every output tile count of the served trunk,
    kernel 7 with ReLU there and under the other activations at Vconv1.2.
    Kernel 6 reads spectra made by an rfft2 of real tiles, so that its
    library call, ``torch.fft.irfft2``, is defined on them (cuFFT's C2R
    is unspecified on a non-Hermitian grid); kernel 7 reads random planes
    and has no single library call.  The rows are emitted by
    ``device_times``."""
    rows6, rows7 = [], []
    d = 16
    dh = d // 2 + 1
    cases = [(name, spec, "relu") for name, spec in layers]
    cases += [(layers[1][0], layers[1][1], act)
              for act in ("none", "gelu", "silu")]
    for name, spec, act in cases:
        n = spec.B * spec.Cout * spec.X * spec.D
        if act == "relu":
            Z = torch.fft.rfft2(torch.randn((n, d, d), generator=gen,
                                            device="cuda"))
            Zr, Zi = Z.real.contiguous(), Z.imag.contiguous()
            y, form = form_launch(tile_ifft_cuda, Zr, Zi, delta=d)
            y0 = tile_ifft_ref(Zr, Zi, d)
            y_lib = torch.fft.irfft2(Z, s=(d, d))
            torch.cuda.synchronize()
            err = (y - y0).abs().max().item()
            scale = y0.abs().max().item() + 1e-9
            if not err / scale <= INVERSE_TOL:
                raise AssertionError(
                    f"tile_ifft {name}: scaled error {err / scale:.3e} > "
                    f"{INVERSE_TOL}")
            ms = time_ms(lambda: tile_ifft_cuda(Zr, Zi, delta=d))
            bd = bound(*rect_bytes_flops(n, d), torch.float32)
            row = dict(kernel="tile_ifft", layer=name, shape=[n, d, dh],
                       tiles=dft_ops.DEFAULT_TILES,
                       max_abs_err=err, scaled_err=err / scale,
                       library_abs_diff=(y - y_lib).abs().max().item(),
                       ms=ms,
                       plain_ms=time_ms(lambda: tile_ifft_ref(Zr, Zi, d)),
                       library_ms=time_ms(
                           lambda: torch.fft.irfft2(Z, s=(d, d))),
                       library="torch.fft.irfft2",
                       **form_fields(ms, form, bd), **bd)
            rows6.append(row)
            del Z, Zr, Zi, y, y0, y_lib
        Zr, Zi = (torch.randn((n, d, dh), generator=gen, device="cuda")
                  for _ in range(2))
        b = torch.randn((n,), generator=gen, device="cuda")
        y, form = form_launch(tile_ifft_epilogue_cuda, Zr, Zi, b,
                              activation=act, delta=d)
        y0 = tile_ifft_epilogue_ref(Zr, Zi, b, activation=act, delta=d)
        torch.cuda.synchronize()
        err = (y - y0).abs().max().item()
        scale = y0.abs().max().item() + 1e-9
        if not err / scale <= INVERSE_TOL:
            raise AssertionError(
                f"tile_ifft_epilogue {name} {act}: scaled error "
                f"{err / scale:.3e} > {INVERSE_TOL}")
        ms = time_ms(lambda: tile_ifft_epilogue_cuda(
            Zr, Zi, b, activation=act, delta=d))
        bd = bound(*rect_bytes_flops(n, d, tail=True), torch.float32)
        row = dict(kernel="tile_ifft_epilogue", layer=name, shape=[n, d, dh],
                   activation=act, tiles=dft_ops.DEFAULT_TILES,
                   max_abs_err=err, scaled_err=err / scale,
                   ms=ms, plain_ms=time_ms(lambda: tile_ifft_epilogue_ref(
                       Zr, Zi, b, activation=act, delta=d)),
                   library_ms=None, **form_fields(ms, form, bd), **bd)
        rows7.append(row)
    return rows6, rows7


def inverse_operands(kernel, n, gen, d=16):
    """Random operands of inverse ``kernel`` on ``n`` tiles: compact
    (n, P) or rect (n, d, d//2 + 1) planes, and a bias with the tail (then
    ReLU); (args, keywords)."""
    _, _, compact, tail = INVERSES[kernel]
    shape = (n, num_freq_real(d)) if compact else (n, d, d // 2 + 1)
    args = tuple(torch.randn(shape, generator=gen, device="cuda")
                 for _ in range(2))
    if tail:
        args += (torch.randn((n,), generator=gen, device="cuda"),)
    return args, (dict(activation="relu") if tail else {})


def inverse_bytes_flops(kernel, n, d=16):
    """One inverse over n tiles: its planes (and bias) read once and its
    tiles written once, and its operations, as each kernel's own rows
    count them."""
    _, _, compact, tail = INVERSES[kernel]
    if not compact:
        return rect_bytes_flops(n, d, tail)
    dh = d // 2 + 1
    return (4 * (2 * n * num_freq_real(d) + n * d * d + (n if tail else 0)),
            n * (8 * d * dh * d + 4 * d * d * dh))


def tiles_row(kernel, name, n, tiles, gen, d=16):
    """Inverse ``kernel`` on ``n`` tiles (a main path's count) at
    ``tiles`` tiles a block: the specialised form, the launch counted
    under ``tiles``, held to its plain version within ``INVERSE_TOL`` and
    timed.  The row is emitted by ``device_times``."""
    wrapper, ref, _, _ = INVERSES[kernel]
    args, kw = inverse_operands(kernel, n, gen, d)
    y, form = form_launch(wrapper, *args, delta=d, tiles=tiles, **kw)
    y0 = ref(*args, delta=d, **kw)
    torch.cuda.synchronize()
    err = (y - y0).abs().max().item()
    scale = y0.abs().max().item() + 1e-9
    if not err / scale <= INVERSE_TOL:
        raise AssertionError(f"{kernel} {name} tiles={tiles}: scaled error "
                             f"{err / scale:.3e} > {INVERSE_TOL}")
    ms = time_ms(lambda: wrapper(*args, delta=d, tiles=tiles, **kw))
    b = bound(*inverse_bytes_flops(kernel, n, d), torch.float32)
    shape = list(args[0].shape) if len(args[0].shape) == 3 \
        else [n, args[0].shape[1], d]
    return dict(kernel=kernel, layer=name, shape=shape, tiles=tiles,
                activation=kw.get("activation"), max_abs_err=err,
                scaled_err=err / scale, ms=ms, plain_ms=None,
                library_ms=None, **form_fields(ms, form, b), **b)


def inverse_passes(layers, dx_layers):
    """(kernel, layer, tile count) of each inverse's pass on its main
    path: kernels 2, 6 and 7 over a served forward's output tiles, kernel
    4 over a training step's dx plans."""
    served = [(name, spec.B * spec.Cout * spec.X * spec.D)
              for name, spec in layers]
    dx = [(name, spec.B * spec.Cout * spec.X * spec.D)
          for name, spec in dx_layers]
    return [(kernel, name, n) for kernel in INVERSES
            for name, n in (dx if kernel == "tile_irfft" else served)]


def check_inverse_tiles(layers, dx_layers, gen):
    """Every inverse at every compiled tiles a block but the default (its
    rows are ``check_inverse``'s and the others') over its main-path
    pass.  The rows are emitted by ``device_times``."""
    return [tiles_row(kernel, name, n, tiles, gen)
            for tiles in OTHER_TILES
            for kernel, name, n in inverse_passes(layers, dx_layers)]


def check_generic_tiles(gen, n=1001, d=8):
    """The generic form of each inverse (delta 8: no plan runs it) at
    every compiled tiles a block, against its plain version: the pin is
    honoured at every delta, as the reference honours ``bt``."""
    rows = []
    for kernel, (wrapper, ref, _, _) in INVERSES.items():
        for tiles in dft_ops.INVERSE_TILES:
            args, kw = inverse_operands(kernel, n, gen, d)
            forms = dict(wrapper.form_launches)
            counts = dict(wrapper.tiles_launches)
            y = wrapper(*args, delta=d, tiles=tiles, **kw)
            y0 = ref(*args, delta=d, **kw)
            torch.cuda.synchronize()
            forms["generic"] += 1
            counts[tiles] += 1
            err = (y - y0).abs().max().item() / (y0.abs().max().item()
                                                 + 1e-9)
            if wrapper.form_launches != forms \
                    or wrapper.tiles_launches != counts \
                    or not err <= INVERSE_TOL:
                raise AssertionError(
                    f"{kernel} generic delta {d} tiles={tiles}: forms "
                    f"{wrapper.form_launches}, tiles "
                    f"{wrapper.tiles_launches}, scaled error {err:.3e}")
            rows.append(dict(kernel=kernel, tiles=tiles, scaled_err=err))
    emit("inverse_generic", delta=d, tiles_count=n, tol=INVERSE_TOL,
         rows=rows)


def tiles_summary(default_rows, tiles_rows):
    """Each inverse's main-path pass at each tiles a block: its summed
    time, device time and bound, from the default rows (``tiles`` 8) and
    ``check_inverse_tiles``' rows, after ``device_times``."""
    out = {}
    for kernel in INVERSES:
        per = {}
        for tiles in dft_ops.INVERSE_TILES:
            rows = [r for r in (default_rows if tiles == dft_ops.DEFAULT_TILES
                                else tiles_rows)
                    if r["kernel"] == kernel and r["tiles"] == tiles]
            per[tiles] = dict(rows=len(rows),
                              ms=sum(r["ms"] for r in rows),
                              device_ms=sum(r["device_ms"] for r in rows),
                              bound_ms=sum(r["bound_ms"] for r in rows),
                              max_scaled_err=max(r["scaled_err"]
                                                 for r in rows))
        out[kernel] = per
    emit("inverse_tiles", passes=out)


def check_dk(gen):
    """dk of every layer of the trunk's training step as the plan-level VJP
    computes it (cuDNN's weight-gradient routine), against the JAX
    package's formulation of the same correlation: a forward convolution
    with batch as the contraction axis, whose kernel spans the image."""
    rows = []
    for l in network_convs(serve._vgg_scale(IMAGE), BATCH):
        plan = plan_conv(l.x_shape, l.k_shape, padding=l.padding,
                         backend="fft-cuda")
        x = torch.randn(l.x_shape, generator=gen, device="cuda")
        dz = torch.randn(plan.out_shape, generator=gen, device="cuda")
        ph, pw = plan.padding

        def conv_form():
            xp = TF.pad(x, (pw, pw, ph, ph))
            return TF.conv2d(xp.transpose(0, 1),
                             dz.transpose(0, 1)).transpose(0, 1)
        dk = autodiff._dk_direct(plan, x, dz, torch.float32)
        dk0 = conv_form()
        torch.cuda.synchronize()
        err = ((dk - dk0).abs().max() / dk0.abs().max()).item()
        if not err <= GRAD_TOL:
            raise AssertionError(f"dk {l.name}: the two forms differ by "
                                 f"{err:.3e}")
        rows.append(dict(layer=l.name, rel_diff=err, ms=time_ms(
            lambda: autodiff._dk_direct(plan, x, dz, torch.float32)),
            conv2d_form_ms=time_ms(conv_form, reps=3, groups=3)))
    emit("dk", rows=rows, ms=sum(r["ms"] for r in rows),
         conv2d_form_ms=sum(r["conv2d_form_ms"] for r in rows))


def summarize(name, rows, launches, has_library):
    """One pass's worth (a served forward, on the compact or the rect
    path, or a training step's dx plans): the main-path calls summed."""
    _, source, replaces = KERNELS[name]
    by_kind = {"bytes": 0.0, "operations": 0.0}
    for r in rows:
        by_kind[r["bound_by"]] += r["bound_ms"]
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows),
        "bound_by": max(by_kind, key=by_kind.get),
        "library_ms": (sum(r["library_ms"] for r in rows)
                       if has_library else None),
    }


def device_profile(fn):
    """Run ``fn`` once more under torch.profiler: (device operation rows
    sorted by device time as (us, name, calls), device busy us, wall us,
    range rows).  The range rows are the profiler's device spans of host
    ranges (``nccl:all_to_all`` and the like, each the span of the device
    work enqueued inside it): they are kept apart, since that work is
    among the operation rows already."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows, ranges = [], []
    for ev in prof.key_averages():
        if "CUDA" not in str(getattr(ev, "device_type", "")):
            continue                    # host ops: their kernels are listed
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0)) or 0
        if t > 0:
            (ranges if ev.is_user_annotation else rows).append(
                (t, ev.key, ev.count))
    rows.sort(reverse=True)
    return rows, sum(t for t, _, _ in rows), wall_us, ranges


def device_activity(fn):
    """Run ``fn`` once under torch.profiler: (its device operations as
    {name: count}, NCCL's ranges as {name: count}, the device operations
    inside those ranges as {name: count}).  A CUDA graph's replay runs no
    host op, so it has no ranges: its operations are compared by name
    and count."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops, nccl = [], []
    for ev in prof.events():
        if "CUDA" not in str(getattr(ev, "device_type", "")):
            continue
        if not ev.is_user_annotation:
            ops.append(ev)
        elif ev.name.startswith("nccl:"):
            nccl.append(ev)
    inside = [o for o in ops if any(
        r.time_range.start <= o.time_range.start
        and o.time_range.end <= r.time_range.end for r in nccl)]
    return tuple(dict(collections.Counter(e.name for e in evs))
                 for evs in (ops, nccl, inside))


def profile_forward(res):
    """Device time by kernel name over one served forward, and the share
    of the forward's wall time the device spends idle."""
    prepared = res.net.prepare(res.kernels, weights_version=0)  # cache hit
    forward = serve._vgg_forward(res.biases)
    with torch.inference_mode():
        forward(prepared, res.x)
        torch.cuda.synchronize()
        rows, busy, wall_us, _ = device_profile(
            lambda: forward(prepared, res.x))
    p50_us = serve._percentile(res.latencies_s, 50) * 1e6
    emit("profile", device_busy_us=busy,
         kernel_launches=sum(c for _, _, c in rows),
         profiled_wall_us=wall_us,
         idle_share_profiled=1 - busy / wall_us,
         idle_share_vs_p50=1 - busy / p50_us,
         kernels=[{"name": k[:90], "device_us": t, "calls": c}
                  for t, k, c in rows[:16]])
    return busy


def rect_forward(layers, G, biases, x, fused):
    """The served trunk through the raw stage ops on the rect layout: per
    layer the rect forward tile DFT (stage 1), the CGEMM at P = 144, and
    the rect inverse with bias + ReLU fused into its tail (``fused``) or
    the plain rect inverse and then the epilogue; the trunk's pools."""
    ep = Epilogue(bias=True, activation="relu")
    route = (dict(inverse_fn=_cuda_fused_inverse) if fused
             else dict(tile_ifft=tile_ifft_cuda))
    h = x
    for name, spec in layers:
        Dr, Di = stages.stage_input_transform(h, spec, "rect",
                                              tile_fft=tile_fft_cuda)
        Zr, Zi = stages.stage_cgemm(Dr, Di, *G[name], three_m=True,
                                    cgemm_fn=cgemm_cuda)
        h = stages.stage_output_inverse(Zr, Zi, spec, epilogue=ep,
                                        bias=biases[name], spectrum="rect",
                                        **route)
        if name in serve._VGG_POOL_AFTER:
            h = maxpool2x2(h)
    return h


def rect_phase(res, layers, y_ref, slice_p50_ms):
    """The served trunk's weights, biases and request batch through the
    rect path: one transform sweep (stage 2 of every layer), then GEN
    synchronized forwards fused and GEN unfused, each held to cuDNN."""
    n_layers = len(layers)
    counts = {}
    with torch.inference_mode():
        zero_counts()
        t0 = time.perf_counter()
        G = {name: stages.stage_kernel_transform(
            res.kernels[name], spec, "rect", tile_fft=tile_fft_cuda)
            for name, spec in layers}
        torch.cuda.synchronize()
        sweep_ms = (time.perf_counter() - t0) * 1e3
        counts["sweep"] = read_counts()
        expect_counts("rect transform sweep", counts["sweep"],
                      {"tile_fft": n_layers})
        out = {}
        for fused in (True, False):
            route = "fused" if fused else "unfused"
            rect_forward(layers, G, res.biases, res.x, fused)   # warm-up
            torch.cuda.synchronize()
            zero_counts()
            lats = []
            for _ in range(GEN):
                t0 = time.perf_counter()
                y = rect_forward(layers, G, res.biases, res.x, fused)
                torch.cuda.synchronize()
                lats.append(time.perf_counter() - t0)
            counts[route] = read_counts()
            inverse = "tile_ifft_epilogue" if fused else "tile_ifft"
            expect_counts(f"rect forward, {route}", counts[route], {
                "tile_fft": GEN * n_layers, "cgemm": GEN * n_layers,
                inverse: GEN * n_layers})
            rel = ((y - y_ref).abs().max() / y_ref.abs().max()).item()
            if tuple(y.shape) != tuple(y_ref.shape) or not rel <= SLICE_TOL:
                raise AssertionError(f"rect trunk, {route}, vs cuDNN: shape "
                                     f"{tuple(y.shape)}, {rel:.3e} > "
                                     f"{SLICE_TOL}")
            out[route] = dict(rel_err_vs_cudnn=rel,
                              p50_ms=serve._percentile(lats, 50) * 1e3,
                              max_ms=max(lats) * 1e3,
                              latencies_ms=[t * 1e3 for t in lats])
        rows, busy, wall_us, _ = device_profile(
            lambda: rect_forward(layers, G, res.biases, res.x, True))
    emit("rect", image=IMAGE, batch=BATCH, forwards_per_route=GEN,
         launches_per_forward={"tile_fft": n_layers, "cgemm": n_layers,
                               "tile_ifft_epilogue or tile_ifft": n_layers},
         launches_per_sweep={"tile_fft": n_layers}, sweep_ms=sweep_ms,
         tol=SLICE_TOL, slice_p50_ms=slice_p50_ms, **out,
         launches=counts, profile=dict(
             device_busy_us=busy, profiled_wall_us=wall_us,
             kernel_launches=sum(c for _, _, c in rows),
             idle_share_vs_p50=1 - busy / (out["fused"]["p50_ms"] * 1e3),
             kernels=[{"name": k[:90], "device_us": t, "calls": c}
                      for t, k, c in rows[:16]]))
    return {k: sum(c[k] for c in counts.values()) for k in KERNELS}


def full(t):
    """The global tensor of a ``DTensor`` (a sharded plan's output); a
    plain tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def vgg_train_loss(layers, backend, kernels, biases, x, r, branches=None,
                   plans=None):
    """The VGG trunk of ``serve --convnet vgg`` as a model would train it:
    ``conv_block`` (bias + ReLU fused) and ``maxpool2x2``; loss sum(y*r).
    With ``plans`` (a plan per layer, bias + ReLU fused, on a mesh) each
    layer runs its plan instead, its ``DTensor`` output feeding the next
    and the pools on each rank's block.  A list ``branches`` receives the
    run's discrete choices in order: each ReLU's mask and each pool's
    argmax indices."""
    h = x
    for l in layers:
        if plans is None:
            h = conv_block(h, kernels[l.name], biases[l.name],
                           activation="relu", padding=l.padding,
                           backend=backend)
        else:
            h = plans[l.name](h, kernels[l.name], bias=biases[l.name])
        if branches is not None:
            branches.append(full(h.detach()) > 0)
        if l.name in serve._VGG_POOL_AFTER:
            if branches is not None:
                branches.append(TF.max_pool2d(full(h.detach()), 2, 2,
                                              return_indices=True)[1])
            h = maxpool2x2(h)
    return (full(h) * r).sum()


def vgg_branch_loss(layers, kernels, biases, x, r, branches):
    """The same trunk on ``direct`` making none of its own discrete
    choices: each ReLU applies the mask and each pool takes the argmax
    that ``branches`` recorded in another run, so that the grads of the
    two runs differ by their rounding alone."""
    h, taken = x, iter(branches)
    for l in layers:
        h = conv_block(h, kernels[l.name], biases[l.name],
                       padding=l.padding, backend="direct") * next(taken)
        if l.name in serve._VGG_POOL_AFTER:
            idx = next(taken)
            h = h.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
    return (h * r).sum()


def flip_counts(branches, branches64):
    """Per ReLU and pool of the trunk, how many of its choices differ
    between two runs."""
    return [int((a != b).sum().item()) for a, b in zip(branches, branches64)]


def rel_errs(layers, grads, grads64):
    """Every layer's dk and d_bias: max|g - g64| / max|g64|."""
    n, errs = len(layers), {}
    for i, l in enumerate(layers):
        for kind, j in (("dk", i), ("dbias", n + i)):
            g, g64 = grads[j], grads64[j]
            errs[f"{l.name}/{kind}"] = (
                (g.double() - g64).abs().max() / g64.abs().max()).item()
    return errs


class forced_generic_form:
    """Within the block, every tile DFT, forward and inverse, launches its
    generic form (the one kernel of every delta before the specialised
    forms came), whatever ``choose_form`` and ``choose_inverse_form``
    would pick."""

    def __enter__(self):
        self.saved = dft_ops.choose_form, dft_ops.choose_inverse_form
        dft_ops.choose_form = lambda delta, ptr: dft_ops.GENERIC
        dft_ops.choose_inverse_form = lambda delta, ptrs, ld: dft_ops.GENERIC

    def __exit__(self, *exc):
        dft_ops.choose_form, dft_ops.choose_inverse_form = self.saved


def train_inputs():
    """The trunk's layers and phase 7's weights, biases, input and loss
    weights on the card, made from ``SEED`` with numpy."""
    layers = network_convs(serve._vgg_scale(IMAGE), BATCH)
    rng = np.random.default_rng(SEED)

    def init(shape, s=0.05):
        return torch.as_tensor(s * rng.standard_normal(shape),
                               dtype=torch.float32).cuda()
    kernels = {l.name: init(l.k_shape) for l in layers}
    biases = {l.name: init((l.k_shape[0],)) for l in layers}
    x = init(layers[0].x_shape, 1.0)
    r = init((BATCH, 512, IMAGE // 32, IMAGE // 32), 1.0)
    return layers, kernels, biases, x, r


def make_train_step(inputs, backend, dtype, taken=None, scale=1.0,
                    plans=None):
    """A training step of ``train_inputs()`` on input ``x * scale``:
    ``step(record)`` returns the loss and the grads of every layer's
    kernel, then of every layer's bias, and appends its branches to the
    list ``record``; with ``taken`` the step follows those branches
    (``vgg_branch_loss``, on direct); with ``plans`` it runs them."""
    layers, kernels, biases, x, r = inputs
    ks = {n: k.to(dtype).requires_grad_() for n, k in kernels.items()}
    bs = {n: b.to(dtype).requires_grad_() for n, b in biases.items()}
    params = [ks[l.name] for l in layers] + [bs[l.name] for l in layers]
    xd, rd = (x * scale).to(dtype), r.to(dtype)

    def step(record=None):
        if taken is None:
            loss = vgg_train_loss(layers, backend, ks, bs, xd, rd, record,
                                  plans)
        else:
            loss = vgg_branch_loss(layers, ks, bs, xd, rd, taken)
        return loss, torch.autograd.grad(loss, params)
    return step


def train_phase():
    """Training steps of the full-width trunk on fft-cuda and on direct
    (float32, timed), and on direct in float64: exact launches per step,
    every layer's grads against the float64 step taken through the same
    branches, the branches that flip against the float64 step's own,
    median step times; then ``branch_witness``.

    The grads of the last timed fft-cuda step are held to a float64 step
    that takes that step's own ReLU masks and pool argmaxes
    (``vgg_branch_loss``), within ``GRAD_TOL``; and the choices of that
    step that differ from a float64 step making its own must number at
    most ``FLIP_LIMIT``.  Against a free float64 step the grads are no
    measure of the kernels: a float32 forward flips a few ReLUs and pool
    choices whose inputs lie within rounding of a tie, each flip moves a
    grad by up to a few 1e-3 of its largest entry, and which ones flip
    changes with any change of rounding (PERF.md §6).  That
    comparison is reported beside the gated one, as is cuDNN's float32
    step.  Returns the launches, and the last timed fft-cuda step's grads
    with the step's median time and device profile (phase 12's
    reference)."""
    inputs = train_inputs()
    layers = inputs[0]

    def make_step(backend, dtype, taken=None, scale=1.0):
        return make_train_step(inputs, backend, dtype, taken, scale)

    out, local = {}, {}
    for backend in ("fft-cuda", "direct"):
        step = make_step(backend, torch.float32)
        step()                                          # warm-up
        torch.cuda.synchronize()
        zero_counts()
        times, grads = [], None
        for _ in range(TRAIN_STEPS):
            branches = []               # every timed step records its own
            t0 = time.perf_counter()
            prev, (loss, grads) = grads, step(branches)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[backend] = (loss, grads, times, read_counts(), branches)
        rows, busy, wall_us, _ = device_profile(step)
        idle = 1 - busy / (statistics.median(times) * 1e6)
        emit("train_profile", backend=backend, device_busy_us=busy,
             kernel_launches=sum(c for _, _, c in rows),
             profiled_wall_us=wall_us, idle_share_vs_median_step=idle,
             kernels=[{"name": k[:90], "device_us": t, "calls": c}
                      for t, k, c in rows[:24]])
        if backend == "fft-cuda":
            # the same step twice: cuDNN's weight-gradient routine (dk)
            # may differ from run to run in its last bits
            local = dict(grads=grads,
                         step_ms=statistics.median(times) * 1e3,
                         device_busy_us=busy, idle_share=idle)
            repeat_err = max(rel_errs(layers, grads, prev).values())
    n = len(layers)
    # per step: forward x and k tiles of every layer, the dx plans' dz and
    # k tiles of layers 2-9; one CGEMM per plan; the forward's bias-only
    # pre-activation plans fuse the bias into the inverse, the dx plans
    # run the plain inverse
    per_step = {"tile_rfft": 2 * n + 2 * (n - 1), "cgemm": 2 * n - 1,
                "tile_irfft_epilogue": n, "tile_irfft": n - 1}
    counts = out["fft-cuda"][3]
    expect_counts("train step", counts,
                  {k: TRAIN_STEPS * v for k, v in per_step.items()})
    expect_counts("train step on direct", out["direct"][3],
                  {k: 0 for k in per_step})

    # the last timed steps' grads: fft-cuda's against the float64 step
    # through its branches; both against the float64 step through its own
    loss, grads, _, _, branches = out["fft-cuda"]
    _, grads64 = make_step("direct", torch.float64, taken=branches)()
    branches64 = []
    _, grads64_own = make_step("direct", torch.float64)(branches64)
    errs = rel_errs(layers, grads, grads64)
    flips = flip_counts(branches, branches64)
    worst = max(errs, key=errs.get)
    if not errs[worst] <= GRAD_TOL:
        raise AssertionError(f"train {worst} on fft-cuda vs cuDNN float64 "
                             f"through the same branches: "
                             f"{errs[worst]:.3e} > {GRAD_TOL}")
    if not sum(flips) <= FLIP_LIMIT:
        raise AssertionError(f"train on fft-cuda: {sum(flips)} ReLU and "
                             f"pool choices differ from cuDNN float64's "
                             f"{flips} > {FLIP_LIMIT}")
    errs_own = rel_errs(layers, grads, grads64_own)
    errs_direct = rel_errs(layers, out["direct"][1], grads64_own)
    emit("train", backend="fft-cuda", image=IMAGE, batch=BATCH,
         steps=TRAIN_STEPS, launches_per_step=per_step,
         loss=loss.item(), loss_direct=out["direct"][0].item(),
         rel_err_vs_cudnn_f64_same_branches=errs, tol=GRAD_TOL,
         max_rel_err_vs_cudnn_f64_same_branches=errs[worst],
         branch_flips_vs_f64=flips, flip_limit=FLIP_LIMIT,
         branch_choices=sum(b.numel() for b in branches),
         rel_err_vs_cudnn_f64_own_branches=errs_own,
         max_rel_err_vs_cudnn_f64_own_branches=max(errs_own.values()),
         direct_f32_rel_err_vs_cudnn_f64=errs_direct,
         max_direct_f32_rel_err=max(errs_direct.values()),
         direct_f32_branch_flips_vs_f64=flip_counts(out["direct"][4],
                                                    branches64),
         repeat_max_rel_err=repeat_err,
         step_ms=statistics.median(out["fft-cuda"][2]) * 1e3,
         step_ms_direct=statistics.median(out["direct"][2]) * 1e3,
         step_ms_all=[t * 1e3 for t in out["fft-cuda"][2]],
         step_ms_direct_all=[t * 1e3 for t in out["direct"][2]])
    branch_witness(layers, make_step)
    return counts, local


def branch_witness(layers, make_step):
    """Why the grads are not held to a free float64 step: with the input
    scaled by 1 + eps for eps in ``WITNESS_EPS``, each float32 step (the
    tile DFTs in their specialised forms, in their generic forms, and
    cuDNN) against the free float64 step at the same input, and against
    the float64 step through its own branches, with its flips.  Reported,
    not held: a change of rounding as small as eps moves which choices
    flip, and with them the free comparison, while the comparison
    through the same branches stays put."""
    for eps in WITNESS_EPS:
        branches64 = []
        _, grads64 = make_step("direct", torch.float64,
                               scale=1 + eps)(branches64)
        for mode in ("specialised", "generic", "direct"):
            branches = []
            if mode == "generic":
                with forced_generic_form():
                    _, grads = make_step("fft-cuda", torch.float32,
                                         scale=1 + eps)(branches)
            else:
                _, grads = make_step(
                    "direct" if mode == "direct" else "fft-cuda",
                    torch.float32, scale=1 + eps)(branches)
            _, grads64_same = make_step("direct", torch.float64,
                                        taken=branches, scale=1 + eps)()
            emit("train_witness", eps=eps, step=mode,
                 max_rel_err_vs_f64_own_branches=max(
                     rel_errs(layers, grads, grads64).values()),
                 max_rel_err_vs_f64_same_branches=max(
                     rel_errs(layers, grads, grads64_same).values()),
                 branch_flips_vs_f64=flip_counts(branches, branches64))


def trainer_phase():
    """The trainer twin at its defaults (60 steps, batch 32) on fft-cuda,
    its launches, and its first losses against the same run on direct."""
    zero_counts()
    res = train_cnn_fftconv.main(["--conv-backend", "fft-cuda",
                                  "--seed", str(SEED)])
    counts = read_counts()
    steps = len(res.losses)
    # per step: 2 layers' x and k tiles, layer 2's dx plan (dz and k
    # tiles); the eval prepares 2 kernels once and runs 2 prepared layers
    expect_counts("trainer", counts, {
        "tile_rfft": 6 * steps + 2 + 2, "cgemm": 3 * steps + 2,
        "tile_irfft_epilogue": 2 * steps + 2, "tile_irfft": steps})
    ref = train_cnn_fftconv.main(["--conv-backend", "direct",
                                  "--seed", str(SEED)])
    rel = max(abs(a - b) / abs(b)
              for a, b in zip(res.losses[:10], ref.losses[:10]))
    if not rel <= LOSS_TOL:
        raise AssertionError(f"trainer first 10 losses vs direct: {rel:.3e}"
                             f" > {LOSS_TOL}")
    emit("trainer", backend="fft-cuda", steps=steps, batch=32,
         final_loss=res.losses[-1], accuracy=res.accuracy,
         prepared_cache_hits=res.prepared_cache.hits,
         loss_rel_err_vs_direct=rel, tol=LOSS_TOL, seconds=res.seconds,
         seconds_direct=ref.seconds, launches=counts,
         losses=res.losses[:10], losses_direct=ref.losses[:10])
    return counts


def rel_err(y, y0):
    """max|y - y0| / max|y0|."""
    return ((y - y0).abs().max() / y0.abs().max()).item()


def serve_checks(eng, res, rid, x, kernels, version=0, local=None):
    """Request ``rid`` (input ``x``) against the eager prepared forward of
    the bucket it ran in (gathered whole on a mesh), the request's rows at
    the same offset of a zero-padded batch, and against cuDNN at its own
    batch size; with ``local``, against that result too (phase 9's local
    engine's, for the same request), within ``GRAPH_TOL``.  The result
    must be a plain tensor."""
    label, _, off = eng.placements[rid]
    bucket, rows = int(label[1:]), x.shape[0]
    y = eng.results[rid]
    if type(y) is not torch.Tensor:
        raise AssertionError(f"serve request {rid}: a {type(y).__name__}, "
                             "not a plain tensor")
    prepared = eng.nets[(bucket, None)].prepare(   # the graph's spectra
        kernels, weights_version=version)
    xpad = torch.zeros((bucket,) + tuple(x.shape[1:]), device=x.device)
    xpad[off:off + rows] = x
    direct = plan_network(res.make_layers(rows), backend="direct")
    with torch.inference_mode():
        y_eager = full(res.forward(prepared, xpad))[off:off + rows]
        y_direct = res.forward(direct.prepare(kernels), x)
    batcher._sync(y.device)
    out = dict(rid=rid, bucket=label, rows=rows, offset=off,
               rel_err_vs_eager=rel_err(y, y_eager),
               rel_err_vs_cudnn=rel_err(y, y_direct))
    ok = (bool(torch.isfinite(y).all())
          and out["rel_err_vs_eager"] <= GRAPH_TOL
          and out["rel_err_vs_cudnn"] <= SLICE_TOL)
    if local is not None:
        out["rel_err_vs_local_engine"] = rel_err(y, local)
        ok = ok and out["rel_err_vs_local_engine"] <= GRAPH_TOL
    if not ok:
        raise AssertionError(
            f"serve request {out}: not within {GRAPH_TOL} of eager (and "
            f"of the local engine) and {SLICE_TOL} of cuDNN")
    return out


def serve_trace_phase(slice_p50_ms, profile_busy_us):
    """``serve --serve-trace`` on the full-width trunk: the engine's
    launches (prepare, warm-up and capture only), its graph replays and
    plan-cache misses, its results against eager and cuDNN, new inputs
    and new weights through the graphs, and the numbers of the trace,
    beside the pad-max and replan engines on the same trace.  Returns the
    launches and what phase 14 serves again (``Served``)."""
    n_layers = len(serve._vgg_scale(IMAGE))
    zero_counts()
    res = serve.main(["--serve-trace", "--conv-backend", "fft-cuda",
                      "--image", str(IMAGE),
                      "--max-batch", str(SERVE_MAX_BATCH),
                      "--trace-requests", str(SERVE_REQUESTS),
                      "--trace-rate", "0", "--seed", str(SEED)])
    torch.cuda.synchronize()
    counts = read_counts()
    eng, rep = res.engines["bucketed"], res.reports["bucketed"]
    # the trace itself only replays
    at_capture = engine_launches(n_layers, len(eng.policy.batch_buckets()))
    expect_counts("serve trace", counts, at_capture)
    n_batches = sum(b["n_batches"] for b in rep["buckets"].values())
    replays = sum(map(sum, rep["graph_replays"].values()))
    if (rep["executor"], replays, rep["n_requests"],
            rep["plan_cache_misses_after_warmup"]) != (
            "cuda-graph", n_batches, SERVE_REQUESTS, 0):
        raise AssertionError(
            f"serve trace: executor {rep['executor']}, {replays} replays "
            f"for {n_batches} batches, {rep['n_requests']} requests, "
            f"{rep['plan_cache_misses_after_warmup']} plan-cache misses "
            f"after warm-up")

    # the first and last requests, and the first of every bucket
    rids = {0, SERVE_REQUESTS - 1}
    for label in rep["buckets"]:
        rids.add(min(r for r, p in eng.placements.items() if p[0] == label))
    checked = [serve_checks(eng, res, rid,
                            res.inputs[res.trace[rid].batch], res.kernels)
               for rid in sorted(rids)]

    # new inputs through the batch-4 graph: replays only, each its own
    # eager output (a graph that missed the ctypes launches would replay
    # what it saw at capture)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    shape = (4,) + tuple(res.inputs[res.trace[0].batch].shape[1:])
    xa, xb = (torch.randn(shape, generator=gen, device="cuda")
              for _ in range(2))
    zero_counts()
    new_rids = []
    for x in (xa, xb):
        new_rids.append(eng.submit(x))
        eng.drain(force=True)
    expect_counts("replays of new inputs", read_counts(), {})
    new_inputs = [serve_checks(eng, res, rid, x, res.kernels)
                  for rid, x in zip(new_rids, (xa, xb))]

    # a lone batch-4 request: host p50 and device busy time
    lats = []
    for _ in range(LONE_REQUESTS):
        t0 = time.perf_counter()
        eng.submit(xa)
        eng.drain(force=True)
        lats.append(time.perf_counter() - t0)
    rows, busy, wall_us, _ = device_profile(
        lambda: (eng.submit(xa), eng.drain(force=True)))
    lone_p50_ms = serve._percentile(lats, 50) * 1e3

    # new weights: re-prepare and recapture every bucket
    kernels2 = {n: k + 0.01 for n, k in res.kernels.items()}
    zero_counts()
    t0 = time.perf_counter()
    eng.update_weights(kernels2, weights_version=1)
    update_s = time.perf_counter() - t0
    update_counts = read_counts()
    expect_counts("update_weights", update_counts, at_capture)
    rid = eng.submit(xa)
    eng.drain(force=True)
    updated = serve_checks(eng, res, rid, xa, kernels2, version=1)
    launches = {k: counts[k] + update_counts[k] for k in KERNELS}
    served = Served(
        res=res, results={r: eng.results[r] for r in range(SERVE_REQUESTS)},
        placements={r: eng.placements[r] for r in range(SERVE_REQUESTS)},
        xa=xa, kernels2=kernels2, updated=eng.results[rid],
        lone_b4_p50_ms=lone_p50_ms, lone_b4_busy_us=busy)

    # the baselines on the same trace and inputs
    reports = {"bucketed": rep}
    for mode in ("pad-max", "replan"):
        base = batcher.ServeEngine(
            res.make_layers, res.kernels, policy=eng.policy,
            forward=res.forward, window_s=SERVE_WINDOW_MS * 1e-3, mode=mode,
            device="cuda", backend="fft-cuda")
        reports[mode] = batcher.run_trace(
            base, res.trace, make_input=lambda b, _: res.inputs[b],
            realtime=False)
        del base
    tput_x, p99_x, fails = serve.compare_modes(reports)
    res.engines.clear()                 # their graphs' memory goes
    del eng
    torch.cuda.empty_cache()

    def summary(r):
        return dict(throughput_rows_s=r["throughput_rows_s"],
                    p50_ms=r["p50_us"] / 1e3, p99_ms=r["p99_us"] / 1e3,
                    occupancy=r["occupancy"], wall_s=r["wall_s"],
                    startup_s=r["startup_s"],
                    graph_pool_bytes=r["graph_pool_bytes"])
    emit("serve_trace", backend="fft-cuda", image=IMAGE,
         max_batch=SERVE_MAX_BATCH, requests=SERVE_REQUESTS,
         window_ms=SERVE_WINDOW_MS, launches=counts,
         launches_at_capture=at_capture, batches=n_batches,
         graph_replays=rep["graph_replays"],
         plan_cache_misses_after_warmup=rep[
             "plan_cache_misses_after_warmup"],
         buckets={label: dict(p50_ms=b["p50_us"] / 1e3,
                              p99_ms=b["p99_us"] / 1e3,
                              service_p50_ms=b["service_p50_us"] / 1e3,
                              occupancy=b["occupancy"],
                              n_requests=b["n_requests"],
                              n_batches=b["n_batches"])
                  for label, b in rep["buckets"].items()},
         **summary(rep), queue_depth_max=rep["queue_depth_max"],
         startup_plan_prepare_s=rep["startup_plan_prepare_s"],
         startup_capture_s=rep["startup_capture_s"],
         graph_pool_bytes_by_bucket=rep["graph_pool_bytes_by_bucket"],
         tol=GRAPH_TOL, tol_cudnn=SLICE_TOL, checked=checked,
         new_inputs=new_inputs, update_weights=dict(
             seconds=update_s, launches=update_counts, **updated),
         lone_b4=dict(p50_ms=lone_p50_ms, max_ms=max(lats) * 1e3,
                      device_busy_us=busy, profiled_wall_us=wall_us,
                      idle_share_vs_p50=1 - busy / (lone_p50_ms * 1e3),
                      kernel_launches=sum(c for _, _, c in rows),
                      eager_slice_p50_ms=slice_p50_ms,
                      eager_profile_busy_us=profile_busy_us,
                      kernels=[{"name": k[:90], "device_us": t, "calls": c}
                               for t, k, c in rows[:8]]),
         pad_max=summary(reports["pad-max"]),
         replan=summary(reports["replan"]),
         tput_ratio_vs_pad_max=tput_x, p99_ratio_replan_over_bucketed=p99_x,
         serve_compare_gates_failed=fails)
    return launches, served

@dataclasses.dataclass(frozen=True, eq=False)
class Served:
    """What phase 9's local engine served, for phase 14 to serve again
    over the mesh: the trace's set-up (``serve.TraceResult``, engines
    dropped), each request's result and placement, the new input ``xa``
    and weights ``kernels2`` with the result after ``update_weights``, and
    the lone batch-4 request's p50 and busy time."""
    res: object
    results: dict
    placements: dict
    xa: torch.Tensor
    kernels2: dict
    updated: torch.Tensor
    lone_b4_p50_ms: float
    lone_b4_busy_us: float


def cgemm_tile(spec, cfg):
    """The CGEMM tile (the variant's name without its load form) that a
    plan or tuned config (its ``bm``/``bn``/``bk``) launches at ``spec``."""
    row = shape_for_blocks(cfg.bm, cfg.bn, cfg.bk)
    v = choose_variant(1, spec.M, spec.C, spec.Cout, torch.float32, True,
                       row)
    return v.name.removesuffix("-scalar")


def tiles_of(variant_launches):
    """CGEMM launches by tile, from launches by variant name."""
    out = collections.Counter()
    for name, n in variant_launches.items():
        if n:
            out[name.removesuffix("-scalar")] += n
    return dict(out)


def tune_sweep_launches(specs, reps):
    """The launches of a tuning sweep that measures every candidate of
    these layers: one warm-up and ``reps`` timed one-shot calls of each
    ``fft-cuda`` candidate, a real-spectrum call launching the forward
    tile DFT twice (input and kernel) and the CGEMM and fused inverse
    once, a complex one the CGEMM only.  (kernel counts, CGEMM launches
    by tile)."""
    counts, tiles = collections.Counter(), collections.Counter()
    for spec in specs:
        for c in autotune.candidates(spec):
            if c.backend != "fft-cuda":
                continue
            calls = 1 + reps
            counts["cgemm"] += calls
            if c.spectrum == "real":
                counts["tile_rfft"] += 2 * calls
                counts["tile_irfft_epilogue"] += calls
            tiles[cgemm_tile(spec, c)] += calls
    return dict(counts), dict(tiles)


def inverse_tiles_launches(configs, calls):
    """The fused inverse's launches by tiles a block when each real
    ``fft-cuda`` config (a tuned candidate, or a plan: its ``dft_bt``)
    makes ``calls`` calls, one a slab of an overlapped plan."""
    out = dict.fromkeys(dft_ops.INVERSE_TILES, 0)
    for c in configs:
        if c.backend == "fft-cuda" and c.spectrum == "real":
            out[dft_ops.resolve_tiles(c.dft_bt)] += calls * getattr(
                c, "num_slabs", 1)
    return out


def check_inverse_tiles_launched(what, want):
    """The fused inverse launched exactly ``want`` by tiles a block: each
    pinned ``dft_bt`` reached the kernel."""
    got = dict(tile_irfft_epilogue_cuda.tiles_launches)
    if got != want:
        raise AssertionError(f"{what}: fused inverse launches by tiles a "
                             f"block {got}, want {want}")


def check_dft_bt_axis(sweeps):
    """Every sweep timed its layer's ``fft-cuda`` default point (real, the
    chooser's tile) at ``dft_bt`` None and at ``DFT_BT_ALT``."""
    for sw in sweeps:
        timed = {c.dft_bt for c in sw["measured"]
                 if (c.backend, c.spectrum, c.bm) == ("fft-cuda", "real",
                                                      None)}
        if timed != {None, autotune.DFT_BT_ALT}:
            raise AssertionError(
                f"tune sweep {sw['x_shape']}: the fft-cuda default point "
                f"timed at dft_bt {timed}, want None and "
                f"{autotune.DFT_BT_ALT}")


def tuned_forward_launches(plans, forwards, prepares):
    """The launches of ``prepares`` prepares and ``forwards`` prepared
    forwards of these plans: a real ``fft-cuda`` layer launches the
    forward tile DFT per prepare and the forward tile DFT, CGEMM and fused
    inverse per forward, a complex one the CGEMM per forward; ``direct``
    and ``fft-torch`` none.  (kernel counts, CGEMM launches by tile)."""
    counts, tiles = collections.Counter(), collections.Counter()
    for plan in plans:
        if plan.backend != "fft-cuda":
            continue
        counts["cgemm"] += forwards
        tiles[cgemm_tile(plan.spec, plan)] += forwards
        if plan.spectrum == "real":
            counts["tile_rfft"] += prepares + forwards
            counts["tile_irfft_epilogue"] += forwards
    return dict(counts), dict(tiles)


def check_tune_sweep(info, n_layers, counts, want, tiles, want_tiles):
    """The sweep missed and measured every layer and fell back on none,
    and its launches are exactly every ``fft-cuda`` candidate's, by tile
    too: since those candidates come last, every candidate of every layer
    was measured inside the budget."""
    if tuple(info) != (0, n_layers, 0, n_layers):
        raise AssertionError(f"tune sweep: tuner counters {info}, want "
                             f"{n_layers} misses, all measured")
    expect_counts("tune sweep", counts, want)
    if tiles != want_tiles:
        raise AssertionError(f"tune sweep: CGEMM launches by tile {tiles},"
                             f" want {want_tiles} (a candidate unmeasured)")


def check_pinned_rows(plans, tiles, want_tiles):
    """The tuned forward's CGEMM launches by tile are exactly its
    ``fft-cuda`` layers', so every layer whose winner pinned a row
    launched that row."""
    if tiles != want_tiles:
        pinned = [(p.spec.M, p.bm) for p in plans
                  if p.backend == "fft-cuda" and p.bm is not None]
        raise AssertionError(f"tuned forward: CGEMM launches by tile "
                             f"{tiles}, want {want_tiles} (pinned rows "
                             f"(M, bm): {pinned})")


def check_tune_round_trip(info, n_layers, winners, again, version):
    """After ``autotune.reset()`` a fresh plan hits the file on every
    layer, measures nothing, finds the same winners, and the file has
    this ``CACHE_VERSION``."""
    if tuple(info) != (n_layers, 0, 0, 0) or again != winners \
            or version != autotune.CACHE_VERSION:
        raise AssertionError(
            f"tune round trip: counters {info} (want {n_layers} hits), "
            f"winners {again} vs {winners}, file version {version} (want "
            f"{autotune.CACHE_VERSION})")


def winners_of(net):
    return {name: (p.backend, p.schedule, p.spectrum, p.overlap, p.bm, p.bn,
                   p.bk, p.dft_bt)
            for name, p in net.items()}


def trunk_phase(what, net, res, y_ref):
    """The served trunk's weights and request batch through ``net``'s
    plans, prepared (weights version ``None``: no cache), GEN synchronized
    forwards with bias + ReLU + pools: exactly its ``fft-cuda`` layers'
    launches, by CGEMM tile too, and within ``SLICE_TOL`` of cuDNN; its
    p50 and busy time."""
    plans = list(net.plans.values())
    forward = serve._vgg_forward(res.biases)
    zero_counts()
    lats = []
    with torch.inference_mode():
        prepared = net.prepare(res.kernels)
        for _ in range(GEN):
            t0 = time.perf_counter()
            y = forward(prepared, res.x)
            torch.cuda.synchronize()
            lats.append(time.perf_counter() - t0)
    counts = read_counts()
    tiles = tiles_of(cgemm_cuda.variant_launches)
    want, want_tiles = tuned_forward_launches(plans, GEN, 1)
    expect_counts(what, counts, want)
    check_pinned_rows(plans, tiles, want_tiles)
    check_inverse_tiles_launched(what, inverse_tiles_launches(plans, GEN))
    rel = rel_err(y, y_ref)
    if tuple(y.shape) != tuple(y_ref.shape) \
            or not bool(torch.isfinite(y).all()) or not rel <= SLICE_TOL:
        raise AssertionError(f"{what} vs cuDNN: shape {tuple(y.shape)}, "
                             f"{rel:.3e} > {SLICE_TOL}")
    with torch.inference_mode():
        rows, busy, wall_us, _ = device_profile(
            lambda: forward(prepared, res.x))
    p50_ms = serve._percentile(lats, 50) * 1e3
    return dict(backends={n: p.backend for n, p in net.items()},
                forwards=GEN, launches=counts, cgemm_tiles=tiles,
                rel_err_vs_cudnn=rel, tol=SLICE_TOL, p50_ms=p50_ms,
                max_ms=max(lats) * 1e3, device_busy_us=busy,
                profiled_wall_us=wall_us,
                idle_share_vs_p50=1 - busy / (p50_ms * 1e3),
                kernel_launches=sum(c for _, _, c in rows))


def tune_phase(res, y_ref, slice_p50_ms, profile_busy_us):
    """The measured autotuner on the served trunk, on a fresh temporary
    cache at the default budget (the home cache would measure nothing):
    the sweep, every candidate's time again per layer, the tuned trunk's
    forward against cuDNN, and the cache's round trip."""
    convs = network_convs(serve._vgg_scale(IMAGE), BATCH)
    n_layers = len(convs)
    saved = {k: os.environ.pop(k) for k in TUNE_ENV if k in os.environ}
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_tune_")
    cache = os.path.join(tmp.name, "tune.json")
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = cache
    cuda = torch.device("cuda")
    try:
        autotune.reset()
        reps, budget_ms = autotune._env_reps(), autotune.budget_ms()
        with autotune.measure_on(cuda):
            zero_counts()
            t0 = time.perf_counter()
            net = plan_network(convs, backend="tuned")
            torch.cuda.synchronize()
            sweep_s = time.perf_counter() - t0
            sweep_counts = read_counts()
            sweep_tiles = tiles_of(cgemm_cuda.variant_launches)
            info = autotune_info()
            plans = list(net.plans.values())
            want, want_tiles = tune_sweep_launches([p.spec for p in plans],
                                                   reps)
            check_tune_sweep(info, n_layers, sweep_counts, want,
                             sweep_tiles, want_tiles)
            check_inverse_tiles_launched("tune sweep", inverse_tiles_launches(
                [c for p in plans for c in autotune.candidates(p.spec)],
                1 + reps))
            sweeps = autotune.sweeps()
            check_dft_bt_axis(sweeps)
            report = net.tuning_report()

            # every candidate again, through the tuner's own measuring
            # function (not a main path: its launches are not counted)
            table = {}
            for name, plan in net.items():
                spec, cands = plan.spec, []
                for c in autotune.candidates(spec):
                    us = autotune._measure_candidate(
                        c, plan.x_shape, plan.k_shape, padding=plan.padding,
                        delta=spec.delta, three_m=True, compute_dtype=None,
                        reps=reps, device=cuda)
                    cands.append(dict(
                        backend=c.backend, spectrum=c.spectrum, bm=c.bm,
                        bn=c.bn, bk=c.bk, dft_bt=c.dft_bt, us=us,
                        tile=(cgemm_tile(spec, c)
                              if c.backend == "fft-cuda" else None)))
                win = report[name]
                point = (win["backend"], win["spectrum"], win["bm"],
                         win["dft_bt"])

                def us_at(*at):
                    return next(c["us"] for c in cands if (
                        c["backend"], c["spectrum"], c["bm"],
                        c["dft_bt"]) == at)
                again = us_at(*point)
                default = us_at("fft-cuda", "real", None, None)
                default_alt = us_at("fft-cuda", "real", None,
                                    autotune.DFT_BT_ALT)
                pinned = [c for c in cands if c["backend"] == "fft-cuda"
                          and c["spectrum"] == "real" and c["bm"]]
                table[name] = dict(winner=point, winner_us=win[
                    "us_per_call"], fft_cuda_default_us=default,
                    fft_cuda_default_alt_us=default_alt, candidates=cands)
                emit("tune_layer", layer=name,
                     shape=[spec.B, spec.C, spec.Cout, spec.H, spec.W],
                     M=spec.M, candidates=cands, winner=win,
                     winner_us_in_sweep=win["us_per_call"],
                     winner_us_again=again,
                     fft_cuda_default_us=default,
                     fft_cuda_default_alt_us=default_alt,
                     dft_bt_alt=autotune.DFT_BT_ALT,
                     measured_in_sweep=len(next(
                         sw for sw in sweeps
                         if (sw["x_shape"], sw["k_shape"])
                         == (plan.x_shape, plan.k_shape))["measured"]),
                     fft_cuda_default_tile=cgemm_tile(
                         spec, autotune.TunedConfig("fft-cuda", "local")),
                     best_pinned_over_default=(
                         min(c["us"] for c in pinned) / default
                         if pinned else None))

            # the tuned trunk, prepared, with bias + ReLU + pools
            tuned = trunk_phase("tuned trunk", net, res, y_ref)
            # fft-cuda on every layer at its fastest measured CGEMM tile: a
            # pinned row on the main path, whichever backend won above
            rows_at = {
                name: min((c for c in table[name]["candidates"]
                           if (c["backend"], c["spectrum"])
                           == ("fft-cuda", "real")),
                          key=lambda c: c["us"]) for name in table}
            pinned_net = plan_network(
                [dataclasses.replace(l, overrides=tuple(
                    (k, rows_at[l.name][k])
                    for k in ("bm", "bn", "bk", "dft_bt")))
                 for l in convs], backend="fft-cuda")
            pinned = trunk_phase("fft-cuda trunk at the fastest tiles",
                                 pinned_net, res, y_ref)
            pinned["tiles"] = {name: cgemm_tile(p.spec, p)
                               for name, p in pinned_net.items()}
            pinned["dft_bt"] = {name: p.dft_bt
                                for name, p in pinned_net.items()}

            # the cache's round trip: a fresh process's view of the file
            autotune.reset()
            zero_counts()
            net2 = plan_network(convs, backend="tuned")
            rt_counts = read_counts()
            expect_counts("tune round trip", rt_counts, {})
            with open(cache) as fh:
                version = json.load(fh)["version"]
            rt_info = autotune_info()
            check_tune_round_trip(rt_info, n_layers, winners_of(net),
                                  winners_of(net2), version)
    finally:
        for k in TUNE_ENV:
            os.environ.pop(k, None)
        os.environ.update(saved)
        autotune.reset()
        tmp.cleanup()
    emit("tune", image=IMAGE, batch=BATCH, layers=n_layers,
         budget_ms=budget_ms, reps=reps,
         sweep_s=sweep_s, sweep_info=info._asdict(),
         sweep_launches=sweep_counts, sweep_cgemm_tiles=sweep_tiles,
         winners={n: list(w) for n, w in winners_of(net).items()},
         winner_us={n: t["winner_us"] for n, t in table.items()},
         fft_cuda_default_us={n: t["fft_cuda_default_us"]
                              for n, t in table.items()},
         fft_cuda_default_alt_us={n: t["fft_cuda_default_alt_us"]
                                  for n, t in table.items()},
         sweep_reached={str(sw["x_shape"]): [sw["reached"],
                                             sw["candidates"]]
                        for sw in sweeps},
         tuned=tuned, fft_cuda_fastest_tiles=pinned,
         eager_slice_p50_ms=slice_p50_ms,
         eager_profile_busy_us=profile_busy_us,
         round_trip=dict(info=rt_info._asdict(), launches=rt_counts,
                         cache_version=version))
    return {k: sweep_counts[k] + tuned["launches"][k]
            + pinned["launches"][k] for k in KERNELS}, net, sweep_s


def sharded_launches(n_layers, slabs, forwards, prepares, one_shot=False):
    """Launches of a sharded ``fft-cuda`` trunk: per layer and forward,
    per slab, one forward tile DFT (stage 1), one CGEMM and one fused
    inverse; per layer one forward tile DFT per prepare, or per forward
    when one-shot (stage 2 inline, never slabbed)."""
    per_fwd = n_layers * slabs * forwards
    stage2 = n_layers * (forwards if one_shot else prepares)
    return {"tile_rfft": per_fwd + stage2, "cgemm": per_fwd,
            "tile_irfft_epilogue": per_fwd}


def sharded_collectives(schedule, slabs, one_shot=False, replicate=False):
    """Collectives of one sharded layer's forward: nfft two boundary
    all-to-alls per slab (#1, #3), and #2 when one-shot with the kernel
    transform not replicated, never an all-reduce; wfft one all-reduce
    per slab and no all-to-all."""
    if schedule == "nfft":
        return {"all_to_all": 2 * slabs + (one_shot and not replicate),
                "all_reduce": 0}
    return {"all_to_all": 0, "all_reduce": slabs}


def check_collectives(what, trace, want, n_layers, forwards):
    """``trace`` (a ``stage_trace``) holds exactly ``want`` per layer and
    forward, and one boundary all-to-all per all-to-all issued."""
    got = {kind: trace[("collective", kind)] for kind in want}
    need = {kind: n * n_layers * forwards for kind, n in want.items()}
    if got != need or trace["boundary_a2a"] != got["all_to_all"]:
        raise AssertionError(
            f"{what}: collectives {got} ({trace['boundary_a2a']} boundary "
            f"all-to-alls), expected {need}")
    return got


def check_one_row(what, per_layer, slabs):
    """Every slab of a layer launched the CGEMM on one tile row:
    ``per_layer`` maps a layer to its launches by variant in one
    forward."""
    for name, variants in per_layer.items():
        rows = tiles_of(variants)
        if len(rows) != 1 or sum(rows.values()) != slabs:
            raise AssertionError(
                f"{what} {name}: CGEMM launches {variants}, expected "
                f"{slabs} on one tile row")


def sharded_forward(prepared, x, biases, per_layer=None):
    """The served trunk through a sharded network's prepared layers (their
    ``DTensor`` outputs chained, pools on each rank's block); with
    ``per_layer``, each layer's CGEMM launches by variant go into it."""
    h = x
    for name in prepared:
        before = dict(cgemm_cuda.variant_launches)
        h = prepared[name](h, bias=biases[name])
        if per_layer is not None:
            per_layer[name] = {v: n - before[v] for v, n in
                               cgemm_cuda.variant_launches.items()
                               if n != before[v]}
        if name in serve._VGG_POOL_AFTER:
            h = maxpool2x2(h)
    return h


def nccl_us(ranges):
    """Device us of NCCL's ranges among ``device_profile``'s range rows:
    the span of the device work NCCL enqueued (one-rank all-to-alls are
    copies; a one-rank all-reduce in place enqueues none)."""
    return sum(t for t, k, _ in ranges if k.startswith("nccl:"))


def sharded_trunk(schedule, overlap, mesh, convs, res, y_local, y_ref):
    """One sharded configuration of the served trunk: a prepare, one
    forward counted layer by layer, GEN timed forwards, a profiled one;
    the gates of phase 11.  Returns (report, launches)."""
    what = f"sharded {schedule} {overlap}"
    net = plan_network(convs, backend="fft-cuda", mesh=mesh,
                       schedule=schedule, overlap=overlap)
    slabs = {p.num_slabs for p in net.plans.values()}
    if len(slabs) != 1:
        raise AssertionError(f"{what}: slab counts {slabs}")
    slabs = slabs.pop()
    n_layers = len(net)
    total = dict.fromkeys(KERNELS, 0)
    with torch.inference_mode():
        zero_counts()
        prepared = net.prepare(res.kernels)
        torch.cuda.synchronize()
        counts = read_counts()
        expect_counts(f"{what} prepare", counts,
                      sharded_launches(n_layers, slabs, 0, 1))
        total = {k: total[k] + counts[k] for k in KERNELS}

        zero_counts()
        per_layer = {}
        with stages.stage_trace() as trace:
            y = sharded_forward(prepared, res.x, res.biases, per_layer)
            torch.cuda.synchronize()
        counts = read_counts()
        expect_counts(f"{what} forward", counts,
                      sharded_launches(n_layers, slabs, 1, 0))
        check_one_row(what, per_layer, slabs)
        collectives = check_collectives(
            what, trace, sharded_collectives(schedule, slabs), n_layers, 1)
        total = {k: total[k] + counts[k] for k in KERNELS}
        full = y.full_tensor()
        rel_local, rel_ref = rel_err(full, y_local), rel_err(full, y_ref)
        if tuple(full.shape) != tuple(y_ref.shape) \
                or not bool(torch.isfinite(full).all()) \
                or not (rel_local <= GRAPH_TOL and rel_ref <= SLICE_TOL):
            raise AssertionError(
                f"{what}: shape {tuple(full.shape)}, {rel_local:.3e} from "
                f"the local trunk (<= {GRAPH_TOL}), {rel_ref:.3e} from "
                f"cuDNN (<= {SLICE_TOL})")

        zero_counts()
        lats = []
        for _ in range(GEN):
            t0 = time.perf_counter()
            sharded_forward(prepared, res.x, res.biases)
            torch.cuda.synchronize()
            lats.append(time.perf_counter() - t0)
        counts = read_counts()
        expect_counts(f"{what} timed forwards", counts,
                      sharded_launches(n_layers, slabs, GEN, 0))
        total = {k: total[k] + counts[k] for k in KERNELS}
        rows, busy, wall_us, ranges = device_profile(
            lambda: sharded_forward(prepared, res.x, res.biases))
    p50_ms = serve._percentile(lats, 50) * 1e3
    return dict(
        schedule=schedule, overlap=overlap, slabs=slabs,
        cgemm_rows={n: tiles_of(v) for n, v in per_layer.items()},
        launches_per_forward=sharded_launches(n_layers, slabs, 1, 0),
        collectives_per_forward=collectives,
        collective_bytes_per_forward={
            kind: trace[("collective_bytes", kind)]
            for kind in collectives},
        rel_err_vs_local=rel_local, rel_err_vs_cudnn=rel_ref,
        p50_ms=p50_ms, max_ms=max(lats) * 1e3, device_busy_us=busy,
        nccl_device_us=nccl_us(ranges), profiled_wall_us=wall_us,
        idle_share_vs_p50=1 - busy / (p50_ms * 1e3),
        kernels=[{"name": k[:90], "device_us": t, "calls": c}
                 for t, k, c in rows[:12]]), total


def sharded_one_shot(mesh, convs, res, gen):
    """One layer one-shot on nfft, with and without the replicated kernel
    transform, against the local one-shot plan (``GRAPH_TOL``) and cuDNN
    (``SLICE_TOL``): exact launches and collectives."""
    conv = next(c for c in convs if c.name == ONE_SHOT_LAYER)
    ep = conv.epilogue
    x = torch.randn(conv.x_shape, generator=gen, device="cuda")
    k, b = res.kernels[conv.name], res.biases[conv.name]
    kw = dict(padding=conv.padding, epilogue=ep)
    with torch.inference_mode():
        y_local = plan_conv(conv.x_shape, conv.k_shape, backend="fft-cuda",
                            **kw)(x, k, bias=b)
        y_ref = plan_conv(conv.x_shape, conv.k_shape, backend="direct",
                          **kw)(x, k, bias=b)
    out, total = [], dict.fromkeys(KERNELS, 0)
    for replicate in (False, True):
        what = f"sharded one-shot {conv.name} replicate={replicate}"
        plan = plan_conv(conv.x_shape, conv.k_shape, backend="fft-cuda",
                         mesh=mesh, schedule="nfft",
                         replicate_kernel_transform=replicate, **kw)
        zero_counts()
        with stages.stage_trace() as trace, torch.inference_mode():
            y = plan(x, k, bias=b).full_tensor()
            torch.cuda.synchronize()
        counts = read_counts()
        expect_counts(what, counts,
                      sharded_launches(1, plan.num_slabs, 1, 0, True))
        got = check_collectives(what, trace, sharded_collectives(
            "nfft", plan.num_slabs, True, replicate), 1, 1)
        rel_local, rel_ref = rel_err(y, y_local), rel_err(y, y_ref)
        if not (rel_local <= GRAPH_TOL and rel_ref <= SLICE_TOL):
            raise AssertionError(f"{what}: {rel_local:.3e} from local, "
                                 f"{rel_ref:.3e} from cuDNN")
        with torch.inference_mode():
            ms = time_ms(lambda: plan(x, k, bias=b), reps=5)
        out.append(dict(layer=conv.name, replicate=replicate,
                        collectives=got, rel_err_vs_local=rel_local,
                        rel_err_vs_cudnn=rel_ref, ms=ms))
        total = {n: total[n] + counts[n] for n in KERNELS}
    return out, total


def sharded_train_plans(mesh, convs, schedule, overlap):
    """Phase 12's plan of each layer of the trunk: one-shot, bias + ReLU
    fused, on ``mesh``."""
    return {c.name: plan_conv(c.x_shape, c.k_shape, padding=c.padding,
                              backend="fft-cuda", schedule=schedule,
                              mesh=mesh, overlap=overlap,
                              epilogue=Epilogue(bias=True,
                                                activation="relu"))
            for c in convs}


def slab_plans(mesh, convs):
    """(schedule, overlap, layer, plan, role) of every plan that phases 11
    and 12 run: each configuration's served forward plans (``"served"``:
    prepared, ReLU fused), its training step's forward plans
    (``"train"``: one-shot, the bias-only pre-activation plan's inverse)
    and the dx plans of the step (``"dx"``: every layer's but the
    first's, whose input needs no grad)."""
    for schedule, overlap in SHARDED:
        net = plan_network(convs, backend="fft-cuda", mesh=mesh,
                           schedule=schedule, overlap=overlap)
        for name, plan in net.items():
            yield schedule, overlap, name, plan, "served"
        train = sharded_train_plans(mesh, convs, schedule, overlap)
        for name, plan in train.items():
            yield schedule, overlap, name, plan, "train"
        for name, plan in list(train.items())[1:]:
            yield (schedule, overlap, name, autodiff._transposed_plan(plan),
                   "dx")


def slab_blocks(plan):
    """(padded spec, model axis size, per-slab batches) of a sharded plan
    on its mesh: each rank runs the slabs of its B/n_data block."""
    spec = stages.padded_sharded_spec(plan)
    n_data = stages.axis_size(plan.mesh, plan.data_axis)
    return (spec, stages.axis_size(plan.mesh, plan.model_axis),
            stages._slab_sizes(spec.B // n_data, plan.num_slabs))


def check_slab_cgemm(mesh, convs, gen, checked):
    """The CGEMM of each sharded plan (``slab_plans``) at the shapes its
    stage 3 runs, one per slab (nfft: P/N, M_slab, C, C'/N; wfft: P,
    M_slab, C/N, C'), on the tile row its plan pins, against
    ``cgemm_ref``.  A shape and variant already held (``checked``: (P, M,
    C, N, variant) keys, ``check_cgemm``'s first) is not repeated."""
    rows = []
    for schedule, overlap, name, plan, role in slab_plans(mesh, convs):
        spec, n, slabs = slab_blocks(plan)
        P = freq_count(spec, "real")
        if schedule == "nfft":
            P, C, N = (P + (-P) % n) // n, spec.C, spec.Cout // n
        else:
            C, N = spec.C // n, spec.Cout
        row = shape_for_blocks(plan.bm, plan.bn, plan.bk)
        for b in slabs:
            M = b * spec.n_tiles
            key = (P, M, C, N, choose_variant(P, M, C, N, torch.float32,
                                              True, row).name)
            if key in checked:
                continue
            checked.add(key)
            rows.append(cgemm_row(
                name, P, M, C, N, torch.float32, plan.three_m, "real", gen,
                row, schedule=schedule, overlap=overlap, slab_batch=b,
                pinned_row=row, dx_plan=role == "dx"))
    return rows


def check_slab_dft(mesh, convs, gen, checked):
    """The compact tile DFTs of each sharded plan (``slab_plans``) at the
    tile counts the rank runs, against their plain versions: stage 1 per
    slab on the rank's (b, C/N) block of the input; stage 2 on the
    kernel, whole in a prepare of nfft or a replicated transform, else
    the rank's C/N block of it; stage 4 per slab on its (b, C'/N) block
    of the output, fused with ReLU (served), the bias alone (train) or
    plain (dx).  A case already held (``checked``: ``dft_key``s, those of
    ``check_forward``, ``check_inverse`` and ``check_plain_inverse``
    first) is not repeated.  The rows are emitted by ``device_times``."""
    rows = []
    for schedule, overlap, name, plan, role in slab_plans(mesh, convs):
        spec, n, slabs = slab_blocks(plan)
        P = freq_count(spec, "real")
        tiles = spec.X * spec.D
        whole = schedule == "nfft" and (role == "served"
                                        or plan.replicate_kernel_transform)
        cases = [("tile_rfft", spec.Cout * spec.C // (1 if whole else n),
                  None, "stage2", None)]
        for b in slabs:
            cases.append(("tile_rfft", b * spec.C // n * tiles, None,
                          "stage1", b))
            cases.append((
                "tile_irfft" if role == "dx" else "tile_irfft_epilogue",
                b * spec.Cout // n * tiles,
                {"dx": None, "train": "none", "served": "relu"}[role],
                "stage4", b))
        for kernel, count, act, stage, b in cases:
            key = (kernel, count, P, act)
            if key in checked:
                continue
            checked.add(key)
            extra = dict(schedule=schedule, overlap=overlap, role=role,
                         slab_batch=b, dx_plan=role == "dx")
            if kernel == "tile_rfft":
                rows.append(forward_row(name, count, gen, stage=stage,
                                        **extra))
            elif kernel == "tile_irfft":
                rows.append(plain_inverse_row(name, count, P, gen, **extra))
            else:
                rows.append(epilogue_row(name, count, P, act, gen, **extra))
    return rows


def sharded_train_launches(n_layers, slabs, steps):
    """Launches of phase 12's training steps: per step, each layer's
    one-shot forward (stage 2 once; per slab stage 1, the CGEMM and the
    inverse with the bias fused) and the dx plan of every layer but the
    first (stage 2 of the flipped kernel once; per slab stage 1 of dz,
    the CGEMM and the plain inverse)."""
    n, k = n_layers, slabs
    return {"tile_rfft": steps * (2 * n - 1) * (1 + k),
            "cgemm": steps * (2 * n - 1) * k,
            "tile_irfft_epilogue": steps * n * k,
            "tile_irfft": steps * (n - 1) * k}


def sharded_train_collectives(schedule, slabs, n_layers):
    """Collectives of one phase-12 step: a one-shot plan's
    (``sharded_collectives``) for each of the ``2n - 1`` forward and dx
    plans; per layer one all-reduce over data and one all-gather over
    model for dk and again for d_bias, and for every layer but the first
    (whose input is the plain image) the gather of x or dz over model that
    dk needs; no grad gathered whole (every operand that takes a grad is
    a ``DTensor``)."""
    n = n_layers
    plans = sharded_collectives(schedule, slabs, one_shot=True)
    return {**{kind: (2 * n - 1) * c for kind, c in plans.items()},
            "grad_all_reduce": 2 * n, "grad_all_gather": 2 * n + (n - 1),
            "grad_full": 0}


def deterministic_grads(step):
    """The grads of one call of ``step`` with cuDNN held to its
    deterministic algorithms (TF32 off, as everywhere here)."""
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        return step()[1]


def sharded_train(mesh, local):
    """Phase 12: for each configuration of ``SHARDED`` a warm-up and
    ``TRAIN_STEPS`` timed training steps of phase 7's trunk on ``mesh``
    and a profiled one; the gates of the phase, against ``local`` (phase
    7's last fft-cuda step).  Returns (reports, launches)."""
    inputs = train_inputs()
    layers = inputs[0]
    n = len(layers)
    branches64 = []
    make_train_step(inputs, "direct", torch.float64)(branches64)
    local_det = deterministic_grads(make_train_step(inputs, "fft-cuda",
                                                    torch.float32))
    reports, total = [], dict.fromkeys(KERNELS, 0)
    for schedule, overlap in SHARDED:
        what = f"sharded_train {schedule} {overlap}"
        plans = sharded_train_plans(mesh, layers, schedule, overlap)
        slabs = {p.num_slabs for p in plans.values()}
        if len(slabs) != 1:
            raise AssertionError(f"{what}: slab counts {slabs}")
        slabs = slabs.pop()
        step = make_train_step(inputs, None, torch.float32, plans=plans)
        step()                                          # warm-up
        torch.cuda.synchronize()
        zero_counts()
        times = []
        with stages.stage_trace() as trace:
            for _ in range(TRAIN_STEPS):
                branches = []
                t0 = time.perf_counter()
                _, grads = step(branches)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        counts = read_counts()
        expect_counts(what, counts,
                      sharded_train_launches(n, slabs, TRAIN_STEPS))
        want = sharded_train_collectives(schedule, slabs, n)
        collectives = check_collectives(what, trace, want, 1, TRAIN_STEPS)
        total = {k: total[k] + counts[k] for k in KERNELS}
        kinds = {type(g).__name__ for g in grads}
        if kinds != {"Tensor"}:
            raise AssertionError(f"{what}: grads of kinds {sorted(kinds)}")
        errs_det = rel_errs(layers, deterministic_grads(step), local_det)
        errs = rel_errs(layers, grads, make_train_step(
            inputs, "direct", torch.float64, taken=branches)()[1])
        flips = flip_counts(branches, branches64)
        worst_det = max(errs_det, key=errs_det.get)
        worst = max(errs, key=errs.get)
        if not errs_det[worst_det] <= SHARDED_GRAD_TOL:
            raise AssertionError(
                f"{what} {worst_det} vs the local fft-cuda step, cuDNN "
                f"deterministic: {errs_det[worst_det]:.3e} > "
                f"{SHARDED_GRAD_TOL}")
        if not errs[worst] <= GRAD_TOL:
            raise AssertionError(
                f"{what} {worst} vs cuDNN float64 through the same "
                f"branches: {errs[worst]:.3e} > {GRAD_TOL}")
        if not sum(flips) <= FLIP_LIMIT:
            raise AssertionError(f"{what}: {sum(flips)} ReLU and pool "
                                 f"choices differ from cuDNN float64's "
                                 f"{flips} > {FLIP_LIMIT}")
        rows, busy, wall_us, ranges = device_profile(step)
        step_ms = statistics.median(times) * 1e3
        reports.append(dict(
            schedule=schedule, overlap=overlap, slabs=slabs,
            launches_per_step=sharded_train_launches(n, slabs, 1),
            collectives_per_step={k: v // TRAIN_STEPS
                                  for k, v in collectives.items()},
            collective_bytes_per_step={
                kind: trace[("collective_bytes", kind)] // TRAIN_STEPS
                for kind in want},
            max_rel_err_vs_local_deterministic=errs_det[worst_det],
            tol_vs_local=SHARDED_GRAD_TOL,
            max_rel_err_vs_local=max(
                rel_errs(layers, grads, local["grads"]).values()),
            max_rel_err_vs_cudnn_f64_same_branches=errs[worst],
            tol=GRAD_TOL, branch_flips_vs_f64=flips,
            flip_limit=FLIP_LIMIT,
            step_ms=step_ms, step_ms_all=[t * 1e3 for t in times],
            device_busy_us=busy, nccl_device_ms=nccl_us(ranges) / 1e3,
            profiled_wall_us=wall_us,
            idle_share_vs_median_step=1 - busy / (step_ms * 1e3),
            kernels=[{"name": k[:90], "device_us": t, "calls": c}
                     for t, k, c in rows[:12]]))
    return reports, total


def sharded_tune_launches(plans, calls, prepares=0, one_shot=True):
    """Launches of ``calls`` calls of each of these sharded ``fft-cuda``
    configurations (``plans``; direct-free): per call and slab the forward
    tile DFT, the CGEMM and the fused inverse (real) or the CGEMM alone
    (complex), and stage 2's forward tile DFT once a call one-shot, once a
    prepare otherwise."""
    counts = dict.fromkeys(KERNELS, 0)
    for plan in plans:
        if plan.backend != "fft-cuda":
            continue
        counts["cgemm"] += calls * plan.num_slabs
        if plan.spectrum == "real":
            counts["tile_rfft"] += calls * plan.num_slabs + (
                calls if one_shot else prepares)
            counts["tile_irfft_epilogue"] += calls * plan.num_slabs
    return {k: n for k, n in counts.items() if n}


def sweep_plans(mesh, sweeps):
    """The plan of every ``fft-cuda`` candidate each sweep measured, as
    the tuner planned it (no launch)."""
    return [autotune._candidate_plan(c, sw["x_shape"], sw["k_shape"],
                                     padding=sw["padding"],
                                     delta=sw["delta"], three_m=True,
                                     compute_dtype=None, mesh=mesh)
            for sw in sweeps for c in sw["measured"]
            if c.backend == "fft-cuda"]


def sharded_tune(mesh, convs, res, y_local, y_ref, configs):
    """Phase 13: the tuner over the sharded schedules on the trunk, on the
    one-rank NCCL mesh and a fresh temporary cache at the default budget:
    ``plan_network(convs, mesh=, backend="tuned", overlap="auto")``
    misses and measures every layer; its launches are exactly those of
    the ``fft-cuda`` candidates it measured (a warm-up and ``reps`` timed
    one-shot calls each); every winner is a sharded schedule; the tuned
    trunk, prepared, within ``GRAPH_TOL`` of the local trunk and
    ``SLICE_TOL`` of cuDNN; after ``autotune.reset()`` a second planning
    hits the file on every layer, measures and launches nothing and finds
    the same winners.  Reported: each layer's measured candidates, how
    many of its candidates the budget let it reach, the sweep's time, the
    tuned trunk's p50 and busy time beside phase 11's configurations."""
    n_layers = len(convs)
    saved = {k: os.environ.pop(k) for k in TUNE_ENV if k in os.environ}
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_sharded_tune_")
    cache = os.path.join(tmp.name, "tune.json")
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = cache
    kw = dict(mesh=mesh, backend="tuned", overlap="auto")
    try:
        autotune.reset()
        reps = autotune._env_reps()
        with autotune.measure_on(torch.device("cuda")):
            zero_counts()
            t0 = time.perf_counter()
            net = plan_network(convs, **kw)
            torch.cuda.synchronize()
            sweep_s = time.perf_counter() - t0
            counts, info = read_counts(), autotune_info()
            sweeps = autotune.sweeps()
            measured = sweep_plans(mesh, sweeps)
            if tuple(info) != (0, n_layers, 0, n_layers):
                raise AssertionError(f"sharded tune: tuner counters {info}, "
                                     f"want {n_layers} misses, all measured")
            expect_counts("sharded tune sweep", counts,
                          sharded_tune_launches(measured, 1 + reps))
            check_inverse_tiles_launched(
                "sharded tune sweep",
                inverse_tiles_launches(measured, 1 + reps))
            plans = list(net.plans.values())
            off_mesh = [n for n, p in net.items()
                        if p.schedule not in ("nfft", "wfft")
                        or p.mesh is not mesh]
            if off_mesh:
                raise AssertionError(f"sharded tune: layers {off_mesh} "
                                     "won off the sharded schedules")
            report = net.tuning_report()

            with torch.inference_mode():
                zero_counts()
                prepared = net.prepare(res.kernels)
                y = sharded_forward(prepared, res.x, res.biases)
                torch.cuda.synchronize()
                counts_fwd = read_counts()
                expect_counts("sharded tuned trunk", counts_fwd,
                              sharded_tune_launches(plans, 1, 1, False))
                check_inverse_tiles_launched(
                    "sharded tuned trunk", inverse_tiles_launches(plans, 1))
                full = y.full_tensor()
                rel_local = rel_err(full, y_local)
                rel_ref = rel_err(full, y_ref)
                if tuple(full.shape) != tuple(y_ref.shape) \
                        or not bool(torch.isfinite(full).all()) \
                        or not (rel_local <= GRAPH_TOL
                                and rel_ref <= SLICE_TOL):
                    raise AssertionError(
                        f"sharded tuned trunk: shape {tuple(full.shape)}, "
                        f"{rel_local:.3e} from the local trunk (<= "
                        f"{GRAPH_TOL}), {rel_ref:.3e} from cuDNN (<= "
                        f"{SLICE_TOL})")
                lats = []
                for _ in range(GEN):
                    t1 = time.perf_counter()
                    sharded_forward(prepared, res.x, res.biases)
                    torch.cuda.synchronize()
                    lats.append(time.perf_counter() - t1)
                rows, busy, wall_us, ranges = device_profile(
                    lambda: sharded_forward(prepared, res.x, res.biases))

            autotune.reset()
            zero_counts()
            net2 = plan_network(convs, **kw)
            rt_counts = read_counts()
            expect_counts("sharded tune round trip", rt_counts, {})
            with open(cache) as fh:
                version = json.load(fh)["version"]
            rt_info = autotune_info()
            check_tune_round_trip(rt_info, n_layers, winners_of(net),
                                  winners_of(net2), version)
    finally:
        for k in TUNE_ENV:
            os.environ.pop(k, None)
        os.environ.update(saved)
        autotune.reset()
        tmp.cleanup()
    p50_ms = serve._percentile(lats, 50) * 1e3
    layers = []
    for name, plan in net.items():
        sw = next(sw for sw in sweeps if (sw["x_shape"], sw["k_shape"])
                  == (plan.x_shape, plan.k_shape))
        layers.append(dict(
            layer=name, winner=report[name], reached=sw["reached"],
            candidates=sw["candidates"],
            measured=[dict(backend=c.backend, schedule=c.schedule,
                           spectrum=c.spectrum, overlap=c.overlap, bm=c.bm,
                           us=c.us_per_call) for c in sw["measured"]]))
    emit("sharded_tune", mesh=[1, 1], backend="nccl", image=IMAGE,
         batch=BATCH, budget_ms=autotune.budget_ms(), reps=reps,
         sweep_s=sweep_s, sweep_info=info._asdict(), sweep_launches=counts,
         layers=layers,
         winners={n: list(w) for n, w in winners_of(net).items()},
         launches_per_forward=sharded_tune_launches(plans, 1),
         rel_err_vs_local=rel_local, rel_err_vs_cudnn=rel_ref,
         p50_ms=p50_ms, max_ms=max(lats) * 1e3, device_busy_us=busy,
         nccl_device_us=nccl_us(ranges), profiled_wall_us=wall_us,
         idle_share_vs_p50=1 - busy / (p50_ms * 1e3),
         phase11_p50_ms={f"{c['schedule']} {c['overlap']}": c["p50_ms"]
                         for c in configs},
         phase11_busy_us={f"{c['schedule']} {c['overlap']}":
                          c["device_busy_us"] for c in configs},
         round_trip=dict(info=rt_info._asdict(), launches=rt_counts,
                         cache_version=version))
    return {k: counts[k] + counts_fwd[k] for k in KERNELS}


def serve_bucket_slabs(eng, what):
    """Bucket key -> the slab count every layer of its network runs."""
    slabs = {}
    for key, net in eng.nets.items():
        counts = {p.num_slabs for p in net.plans.values()}
        if len(counts) != 1:
            raise AssertionError(f"{what} b{key[0]}: slab counts {counts}")
        slabs[key] = counts.pop()
    return slabs


def serve_capture_counts(eng, schedule, n_layers, what):
    """The launches and collectives of an engine's start-up or weight
    update on the mesh: per bucket a prepare (a forward tile DFT a layer,
    no collective), then ``WARMUP_PASSES`` eager forwards and the capture,
    each with its layers' per-slab kernels and collectives and one output
    gather."""
    launches, collectives = dict.fromkeys(KERNELS, 0), collections.Counter()
    passes = batcher.WARMUP_PASSES + 1
    for slabs in serve_bucket_slabs(eng, what).values():
        for k, n in sharded_launches(n_layers, slabs, passes, 1).items():
            launches[k] += n
        for k, n in sharded_collectives(schedule, slabs).items():
            collectives[k] += n * n_layers * passes
        collectives["output_gather"] += passes
    return launches, dict(collectives)


def check_serve_collectives(what, trace, want):
    """``trace`` holds exactly the collectives ``want`` (kind -> count),
    one boundary all-to-all per all-to-all, and no other kind."""
    got = {k[1]: n for k, n in trace.items()
           if isinstance(k, tuple) and k[0] == "collective" and n}
    want = {k: n for k, n in want.items() if n}
    if got != want or trace["boundary_a2a"] != want.get("all_to_all", 0):
        raise AssertionError(
            f"{what}: collectives {got} ({trace['boundary_a2a']} boundary "
            f"all-to-alls), expected {want}")
    return got


def check_replay_activity(what, eager, replays):
    """A graph's replay ran the device operations of one eager run of the
    callable it captured, name by name and count by count (``{name:
    count}`` each).  ``replays`` are profiler readings of replays: a
    profiler session now and then drops a run of device records, so one
    complete reading suffices, while a reading that holds an operation
    the eager run lacks, or more of one, fails at once (a dropped record
    never adds one).  Returns the number of operations."""
    for replay in replays:
        extra = {k: (eager.get(k, 0), n) for k, n in sorted(replay.items())
                 if n > eager.get(k, 0)}
        if extra:
            raise AssertionError(
                f"{what}: a replay ran device operations that the eager "
                f"callable did not, as (eager, replay): {extra}")
    if eager not in replays:
        fullest = max(replays, key=lambda r: sum(r.values()), default={})
        diff = {k: (n, fullest.get(k, 0)) for k, n in sorted(eager.items())
                if fullest.get(k, 0) != n}
        raise AssertionError(
            f"{what}: a replay's device operations differ from the eager "
            f"callable's in each of {len(replays)} readings; the fullest, "
            f"as (eager, replay): {diff}")
    return sum(eager.values())


def readings_until(read, done):
    """Readings ``read()`` taken until ``done(readings)`` holds or
    ``READINGS`` were taken."""
    readings = []
    while len(readings) < READINGS:
        readings.append(read())
        if done(readings):
            break
    return readings


def agreed(readings):
    """The first reading that an earlier one equals, or None: a reading
    two profiler sessions agree on lost no record."""
    return next((r for i, r in enumerate(readings) if r in readings[:i]),
                None)


def fullest(readings):
    """The per-name maximum over profiler readings of one callable, in
    each dict of a reading (``device_activity``'s three): a session only
    ever drops records, so no session saw more than this."""
    return tuple({k: max(r[i].get(k, 0) for r in readings)
                  for k in sorted(set().union(*(r[i] for r in readings)))}
                 for i in range(len(readings[0])))


def replay_gate(what, read_eager, read_replay):
    """Profiler readings (``device_activity``'s tuples) of a graph's
    replay held to the eager callable it captured: the eager callable is
    read until two readings agree, and its reference is the per-name
    maximum of its readings (``fullest``); the replay is read until a
    reading equals that; where none does and a replay reading holds more
    of an operation than the reference, the eager callable is read again
    until the reference equals a replay reading (at most ``READINGS``
    each time); then ``check_replay_activity``.  The reference only
    grows, so a replay that lacks an operation that any eager reading
    saw never passes.  Returns (the operations' count, the reference, the
    eager readings, the replay readings)."""
    eager_reads = readings_until(read_eager,
                                 lambda rs: agreed(rs) is not None)
    if agreed(eager_reads) is None:
        raise AssertionError(
            f"{what}: no two of {len(eager_reads)} profiler readings of "
            "the eager callable agree")
    eager = fullest(eager_reads)
    replays = readings_until(read_replay, lambda rs: rs[-1][0] == eager[0])
    seen = [r[0] for r in replays]
    if eager[0] not in seen and any(n > eager[0].get(k, 0) for r in seen
                                    for k, n in r.items()):
        eager_reads += readings_until(
            read_eager, lambda rs: fullest(eager_reads + rs)[0] in seen)
        eager = fullest(eager_reads)
    n_ops = check_replay_activity(what, eager[0], seen)
    return n_ops, eager, eager_reads, replays


def replay_activity(eng, what, batch=4):
    """What one replay of bucket ``batch``'s graph runs on the device,
    held to one eager run of the callable it captured (the sharded
    forward and the output gather) on the same static input
    (``replay_gate``).
    Returns the operations' count, the NCCL kernels among them, NCCL's
    ranges in the eager run and the operations inside them (on one rank
    NCCL makes an all-to-all a device-to-device copy and an all-reduce in
    place nothing, and a replay has no ranges to name them), and how
    many readings each side took."""
    ex = eng._executor((batch, None), 0)

    def read_eager():
        with torch.inference_mode():
            return device_activity(
                lambda: ex._forward(ex._prepared, ex.static_x))

    n_ops, eager, eager_reads, replays = replay_gate(
        f"{what} b{batch}", read_eager,
        lambda: device_activity(ex.graph.replay))
    return dict(bucket=batch, device_ops=n_ops,
                nccl_kernels=sum(n for k, n in eager[0].items()
                                 if "nccl" in k.lower()),
                eager_nccl_ranges=eager[1], eager_ops_in_nccl_ranges=eager[2],
                readings={"eager": [sum(r[0].values()) for r in eager_reads],
                          "replay": [sum(r[0].values()) for r in replays]})


def sharded_serve(mesh, served, configs):
    """Phase 14: phase 9's engine over the one-rank NCCL mesh, one CUDA
    graph per bucket captured over every layer's collectives and the
    output gather, for each (schedule, overlap) of ``SERVE_SHARDED``, on
    phase 9's trace, weights and inputs.  Gates: a replay runs the eager
    callable's device operations (``replay_activity``); launches and
    collectives only at prepare, warm-up and capture, and exact; none on
    a replay; replays equal the batches; zero plan-cache misses after
    warm-up; each checked
    result a plain tensor within ``GRAPH_TOL`` of the eager sharded
    forward and of phase 9's result for the same request, and
    ``SLICE_TOL`` of cuDNN; the same after ``update_weights``.  Reported:
    per-bucket p50/p99, throughput, start-up, capture, graph memory, rank
    broadcasts, and a lone batch-4 request's p50 and busy time beside
    phase 9's and phase 11's.  ``configs`` are phase 11's reports.
    Returns (reports, launches, nfft ``off``'s results by rid)."""
    res = served.res
    n_layers = len(serve._vgg_scale(IMAGE))
    eager = {(c["schedule"], c["overlap"]): c for c in configs}
    reports, total = [], dict.fromkeys(KERNELS, 0)
    for schedule, overlap in SERVE_SHARDED:
        what = f"sharded serve {schedule} {overlap}"
        # every bucket prepares afresh, as in a new server: a bucket whose
        # plan another configuration shares (slab:2 plans batch 1 as off)
        # would otherwise find its spectra in the prepared cache
        clear_prepared_cache()
        zero_counts()
        with stages.stage_trace() as trace:
            eng = batcher.ServeEngine(
                res.make_layers, res.kernels,
                policy=batcher.BucketPolicy(max_batch=SERVE_MAX_BATCH),
                forward=res.forward, window_s=SERVE_WINDOW_MS * 1e-3,
                device="cuda", backend="fft-cuda", mesh=mesh,
                schedule=schedule, overlap=overlap)
            torch.cuda.synchronize()
        counts = read_counts()
        slabs = {f"b{k[0]}": n
                 for k, n in serve_bucket_slabs(eng, what).items()}
        want_launches, want_coll = serve_capture_counts(
            eng, schedule, n_layers, what)
        expect_counts(f"{what} start-up", counts, want_launches)
        at_capture = check_serve_collectives(f"{what} start-up", trace,
                                             want_coll)
        total = {k: total[k] + counts[k] for k in KERNELS}

        zero_counts()
        with stages.stage_trace() as trace:
            rep = batcher.run_trace(
                eng, res.trace, make_input=lambda b, _: res.inputs[b],
                realtime=False)
        expect_counts(f"{what} trace", read_counts(), {})
        check_serve_collectives(f"{what} trace", trace, {})
        n_batches = sum(b["n_batches"] for b in rep["buckets"].values())
        replays = sum(map(sum, rep["graph_replays"].values()))
        if (rep["executor"], replays, rep["n_requests"],
                rep["plan_cache_misses_after_warmup"]) != (
                "cuda-graph", n_batches, SERVE_REQUESTS, 0):
            raise AssertionError(
                f"{what}: executor {rep['executor']}, {replays} replays "
                f"for {n_batches} batches, {rep['n_requests']} requests, "
                f"{rep['plan_cache_misses_after_warmup']} plan-cache "
                "misses after warm-up")
        if eng.placements != served.placements:
            raise AssertionError(f"{what}: placements differ from phase "
                                 "9's local engine's")
        rids = {0, SERVE_REQUESTS - 1}
        for label in rep["buckets"]:
            rids.add(min(r for r, p in eng.placements.items()
                         if p[0] == label))
        checked = [serve_checks(eng, res, rid,
                                res.inputs[res.trace[rid].batch],
                                res.kernels, local=served.results[rid])
                   for rid in sorted(rids)]
        if (schedule, overlap) == ("nfft", "off"):   # phase 17's reference
            kept = {r: eng.results[r] for r in range(SERVE_REQUESTS)}
        activity = replay_activity(eng, what)

        # a lone batch-4 request: host p50 and device busy time
        lats = []
        for _ in range(LONE_REQUESTS):
            t0 = time.perf_counter()
            eng.submit(served.xa)
            eng.drain(force=True)
            lats.append(time.perf_counter() - t0)
        rows, busy, wall_us, ranges = device_profile(
            lambda: (eng.submit(served.xa), eng.drain(force=True)))
        lone_p50_ms = serve._percentile(lats, 50) * 1e3
        # rank 0's word alone: a drain of the empty queue takes one (its
        # broadcast and the all-reduce of the ranks' flags), as a lone
        # request's drain does
        words = []
        for _ in range(LONE_REQUESTS):
            t0 = time.perf_counter()
            eng.drain()
            words.append(time.perf_counter() - t0)

        zero_counts()
        t0 = time.perf_counter()
        with stages.stage_trace() as trace:
            eng.update_weights(served.kernels2, weights_version=1)
            torch.cuda.synchronize()
        update_s = time.perf_counter() - t0
        update_counts = read_counts()
        expect_counts(f"{what} update_weights", update_counts, want_launches)
        check_serve_collectives(f"{what} update_weights", trace, want_coll)
        total = {k: total[k] + update_counts[k] for k in KERNELS}
        zero_counts()
        rid = eng.submit(served.xa)
        eng.drain(force=True)
        expect_counts(f"{what} replay after update", read_counts(), {})
        updated = serve_checks(eng, res, rid, served.xa, served.kernels2,
                               version=1, local=served.updated)
        report = eng.report()
        del eng
        torch.cuda.empty_cache()
        base = eager[(schedule, overlap)]
        reports.append(dict(
            schedule=schedule, overlap=overlap,
            slabs_by_bucket=slabs,
            launches_at_capture=want_launches,
            collectives_at_capture=at_capture,
            batches=n_batches, graph_replays=rep["graph_replays"],
            plan_cache_misses_after_warmup=rep[
                "plan_cache_misses_after_warmup"],
            mesh=rep["mesh"], rank_broadcasts=report["rank_broadcasts"],
            buckets={label: dict(p50_ms=b["p50_us"] / 1e3,
                                 p99_ms=b["p99_us"] / 1e3,
                                 service_p50_ms=b["service_p50_us"] / 1e3,
                                 occupancy=b["occupancy"],
                                 n_requests=b["n_requests"],
                                 n_batches=b["n_batches"])
                     for label, b in rep["buckets"].items()},
            throughput_rows_s=rep["throughput_rows_s"],
            p50_ms=rep["p50_us"] / 1e3, p99_ms=rep["p99_us"] / 1e3,
            wall_s=rep["wall_s"], startup_s=rep["startup_s"],
            startup_plan_prepare_s=rep["startup_plan_prepare_s"],
            startup_capture_s=rep["startup_capture_s"],
            graph_pool_bytes=rep["graph_pool_bytes"],
            graph_pool_bytes_by_bucket=rep["graph_pool_bytes_by_bucket"],
            tol=GRAPH_TOL, tol_cudnn=SLICE_TOL, checked=checked,
            replay_activity=activity,
            update_weights=dict(seconds=update_s, launches=update_counts,
                                **updated),
            lone_b4=dict(
                p50_ms=lone_p50_ms, max_ms=max(lats) * 1e3,
                device_busy_us=busy, profiled_wall_us=wall_us,
                nccl_device_us=nccl_us(ranges),
                rank0_word_p50_us=serve._percentile(words, 50) * 1e6,
                idle_share_vs_p50=1 - busy / (lone_p50_ms * 1e3),
                local_engine_p50_ms=served.lone_b4_p50_ms,
                local_engine_busy_us=served.lone_b4_busy_us,
                eager_sharded_p50_ms=base["p50_ms"],
                eager_sharded_busy_us=base["device_busy_us"],
                kernels=[{"name": k[:90], "device_us": t, "calls": c}
                         for t, k, c in rows[:8]])))
    return reports, total, kept


def engine_launches(n_layers, n_buckets):
    """Launches of a local ``fft-cuda`` engine's start-up on the card: per
    bucket one prepare (a forward tile DFT a layer), and the
    ``WARMUP_PASSES`` eager forwards and the capture (a forward tile DFT,
    a CGEMM and a fused inverse a layer each)."""
    forwards = n_buckets * (batcher.WARMUP_PASSES + 1)
    return {"tile_rfft": n_layers * (n_buckets + forwards),
            "cgemm": n_layers * forwards,
            "tile_irfft_epilogue": n_layers * forwards}


def check_quickstart(quick):
    """The quickstart twin's own numbers: within ``SLICE_TOL`` of its
    direct oracle, the prepared call equal to the one-shot."""
    if not (quick.rel_err <= SLICE_TOL and quick.prepared_matches):
        raise AssertionError(f"quickstart twin: rel err {quick.rel_err}, "
                             f"prepared matches {quick.prepared_matches}")


def check_serve_batcher(sb, executor):
    """The serve_batcher twin served its 16 requests on ``executor``, each
    batch one replay (none on the host), refused the oversize request and
    kept a request's rows through the weight update.  Returns (batches,
    replays)."""
    rep = sb.report
    n_batches = sum(b["n_batches"] for b in rep["buckets"].values())
    replays = sum(map(sum, rep["graph_replays"].values()))
    want_replays = n_batches if executor == "cuda-graph" else 0
    if (rep["executor"], replays, rep["n_requests"], sb.rejected,
            sb.updated_shape) != (executor, want_replays, 16, True,
                                  (3, 16, 32, 32)):
        raise AssertionError(
            f"serve_batcher twin: executor {rep['executor']}, {replays} "
            f"replays for {n_batches} batches, {rep['n_requests']} "
            f"requests, rejected {sb.rejected}, {sb.updated_shape}")
    return n_batches, replays


def entry_points_phase():
    """Phase 15: the deprecated ``fft_conv2d_pallas`` on one trunk layer
    (``ONE_SHOT_LAYER``, batch 4) launches exactly what that layer's
    one-shot ``fft-cuda`` plan launches (kernel 3 for stages 1 and 2, the
    CGEMM, and kernel 4: no epilogue, so the plain inverse), warns, and is
    held to cuDNN; then the two example twins at their defaults on the
    card, their own asserts included: the quickstart (``auto`` plans
    ``fft-torch`` or ``direct``, which launch none of the kernels) and
    ``serve_batcher`` (``fft-cuda``, one CUDA graph per bucket, exact
    launches at prepare, warm-up and capture, twice with the weight
    update, none on a replay).  Returns the launches of the shim and the
    twins."""
    layer = next(l for l in network_convs(serve._vgg_scale(IMAGE), BATCH)
                 if l.name == ONE_SHOT_LAYER)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    x = torch.randn(layer.x_shape, generator=gen, device="cuda")
    k = 0.05 * torch.randn(layer.k_shape, generator=gen, device="cuda")
    plan = plan_conv(layer.x_shape, layer.k_shape, padding=layer.padding,
                     backend="fft-cuda")
    one_shot = {"tile_rfft": 2, "cgemm": 1, "tile_irfft": 1}
    with torch.inference_mode():
        zero_counts()
        y_plan = plan(x, k)
        torch.cuda.synchronize()
        expect_counts("one-shot fft-cuda plan", read_counts(), one_shot)
        zero_counts()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            y = fft_conv2d_pallas(x, k, padding=layer.padding)
        torch.cuda.synchronize()
        shim_counts = read_counts()
        y_ref = TF.conv2d(x, k, padding=layer.padding)
    expect_counts("fft_conv2d_pallas", shim_counts, one_shot)
    warned = [str(w.message) for w in caught
              if issubclass(w.category, DeprecationWarning)]
    shim = dict(layer=layer.name, x_shape=list(layer.x_shape),
                k_shape=list(layer.k_shape), launches=shim_counts,
                rel_err_vs_plan=rel_err(y, y_plan),
                rel_err_vs_cudnn=rel_err(y, y_ref), warned=warned)
    if not (warned and shim["rel_err_vs_plan"] <= GRAPH_TOL
            and shim["rel_err_vs_cudnn"] <= SLICE_TOL):
        raise AssertionError(f"fft_conv2d_pallas: {shim}")

    zero_counts()
    quick = quickstart.main([])
    quick_counts = read_counts()
    expect_counts("quickstart twin", quick_counts, {})
    check_quickstart(quick)

    zero_counts()
    sb = serve_batcher.main([])
    sb_counts = read_counts()
    # start-up and the weight update: per bucket a prepare, the warm-up
    # passes and the capture of its two layers
    expect_counts("serve_batcher twin", sb_counts, {
        k: 2 * n for k, n in engine_launches(2, 3).items()})
    n_batches, replays = check_serve_batcher(sb, "cuda-graph")
    rep = sb.report
    emit("entry_points", fft_conv2d_pallas=shim,
         quickstart=dict(backend=quick.backend,
                         tiny_backend=quick.tiny_backend,
                         rel_err=quick.rel_err, grad_norm=quick.grad_norm,
                         prepared_matches=quick.prepared_matches,
                         launches=quick_counts),
         serve_batcher=dict(
             launches=sb_counts, batches=n_batches, graph_replays=replays,
             buckets={label: dict(n_requests=b["n_requests"],
                                  n_batches=b["n_batches"],
                                  occupancy=b["occupancy"])
                      for label, b in rep["buckets"].items()},
             p50_ms=rep["p50_us"] / 1e3, p99_ms=rep["p99_us"] / 1e3,
             plan_cache_misses_after_warmup=rep[
                 "plan_cache_misses_after_warmup"],
             updated_shape=list(sb.updated_shape)))
    del sb
    torch.cuda.empty_cache()
    return {k: shim_counts[k] + quick_counts[k] + sb_counts[k]
            for k in KERNELS}


# the analyzer's facts that must not depend on where its fake tensors lie
LINT_FACTS = ("stage_counts", "collectives", "collective_bytes",
              "collective_dtypes", "cgemm_dtypes", "cgemm_shapes")
# Table-I layers of phase 16's gate (the sweep of ``analyze --check``),
# and of its run with a seeded violation: about 30 s together
LINT_LIMIT, LINT_INJECT_LIMIT = 2, 1
# a stage_trace collective kind -> the analyzer's name for it
LINT_KINDS = {"all_to_all": "all_to_all", "all_reduce": "psum"}


def lint_facts(profile):
    return {f: getattr(profile, f) for f in LINT_FACTS}


def lint_trunk(net):
    """Phase 16 (b): the trunk's plans analyzed on fake CUDA tensors:
    every layer certified, no launch, no byte allocated, and the same
    facts as the analysis on the host.  Returns the profile and the
    seconds it took."""
    torch.cuda.synchronize()
    zero_counts()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    prof = net.analyze(device="cuda")
    seconds = time.perf_counter() - t0
    counts, after = read_counts(), torch.cuda.memory_allocated()
    prof.raise_if_failed()
    expect_counts("plan-lint of the trunk", counts, {})
    if after != before:
        raise AssertionError(f"plan-lint of the trunk allocated "
                             f"{after - before} bytes on the card")
    host = net.analyze(device="cpu")
    for name, p in prof.layers.items():
        if lint_facts(p) != lint_facts(host.layers[name]):
            raise AssertionError(
                f"plan-lint {name}: on the card {lint_facts(p)}, on the "
                f"host {lint_facts(host.layers[name])}")
    return prof, seconds


def lint_peaks(net, res, gen):
    """Phase 16 (e), reported: each layer's estimated peak live bytes of
    its prepared forward beside the ``max_memory_allocated`` increase over
    one real prepared forward of the layer (the inputs x, G and the bias
    were allocated before it)."""
    rows = []
    for name, plan in net.items():
        est = plan.analyze(prepared=True, device="cuda")
        with torch.inference_mode():
            prepared = plan.prepare(res.kernels[name])
            x = torch.randn(plan.x_shape, generator=gen, device="cuda")
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            y = prepared(x, bias=res.biases[name])
            torch.cuda.synchronize()
            measured = torch.cuda.max_memory_allocated() - base
        inputs = sum(t.numel() * t.element_size()
                     for t in (x, *prepared.state, res.biases[name]))
        rows.append(dict(layer=name, peak_live_bytes=est.peak_live_bytes,
                         input_bytes=inputs, measured_increase=measured,
                         output_bytes=y.numel() * y.element_size()))
        del prepared, x, y
    torch.cuda.empty_cache()
    return rows


def lint_dynamic(mesh, convs, res, gen):
    """Phase 16 (c): on the NCCL mesh, for nfft and wfft x off and
    slab:2, each trunk layer's static profile (fake CUDA tensors on the
    mesh) against what ``stage_trace`` records around one real one-shot
    forward of the same plan: collective counts and bytes by kind
    (``all_reduce`` is the analyzer's ``psum``) and stage-op counts."""
    rows = []
    for schedule, overlap in SHARDED:
        net = plan_network(convs, backend="fft-cuda", schedule=schedule,
                           mesh=mesh, overlap=overlap)
        for name, plan in net.items():
            p = plan.analyze()
            x = torch.randn(plan.x_shape, generator=gen, device="cuda")
            with stages.stage_trace() as trace, torch.inference_mode():
                plan(x, res.kernels[name], bias=res.biases[name])
                torch.cuda.synchronize()
            kinds = {k[1] for k in trace
                     if isinstance(k, tuple) and k[0] == "collective"}
            dynamic = {LINT_KINDS.get(k, k): trace[("collective", k)]
                       for k in kinds}
            dyn_bytes = sum(trace[("collective_bytes", k)] for k in kinds)
            static = {k: v for k, v in p.collectives.items() if v}
            stage_counts = {k: v for k, v in trace.items()
                            if isinstance(k, str)}
            if (static, p.collective_bytes, p.stage_counts) \
                    != (dynamic, dyn_bytes, stage_counts):
                raise AssertionError(
                    f"plan-lint {schedule}/{overlap} {name}: static "
                    f"{static}, {p.collective_bytes} bytes, "
                    f"{p.stage_counts}; one real forward {dynamic}, "
                    f"{dyn_bytes} bytes, {stage_counts}")
            p.check().raise_if_failed()
            rows.append(dict(schedule=schedule, overlap=overlap, layer=name,
                             collectives=static,
                             collective_bytes=p.collective_bytes))
    return rows


def lint_gate(*flags):
    """``python -m repro_torch.conv.analyze --check`` with ``flags``, on
    the running NCCL group: its exit code, its profile count and
    seconds."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "profiles.json")
        t0 = time.perf_counter()
        rc = analyze_main(["--check", "--batch", str(BATCH), "--json-out",
                           out, *flags])
        seconds = time.perf_counter() - t0
        with open(out) as fh:
            n = len(json.load(fh))
    return rc, n, seconds


def plan_lint_phase(mesh, convs, res):
    """Phase 16, inside phase 11's process group: plan-lint
    (``repro_torch.conv.analyze``) on the card.  Gates: the served trunk's
    ``fft-cuda`` plans certified on fake CUDA tensors with no launch and
    no byte allocated, with the facts of the same analysis on the host;
    on the NCCL mesh, every layer's static collective counts, bytes and
    stage counts equal to one real forward's (nfft and wfft x off and
    slab:2); the ``--check`` sweep exits 0 (``LINT_LIMIT`` Table-I
    layers), and 1 with ``--inject extra-collective``.  Reported, not
    gated: each layer's estimated peak live bytes beside the measured
    increase of one real prepared forward."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    net = plan_network(convs, backend="fft-cuda")
    prof, seconds = lint_trunk(net)
    peaks = lint_peaks(net, res, gen)
    dynamic = lint_dynamic(mesh, convs, res, gen)
    rc, n, gate_s = lint_gate("--limit", str(LINT_LIMIT))
    if rc != 0:
        raise AssertionError(f"analyze --check exited {rc}")
    inject_rc, inject_n, inject_s = lint_gate(
        "--limit", str(LINT_INJECT_LIMIT), "--inject", "extra-collective")
    if inject_rc != 1:
        raise AssertionError(f"analyze --check --inject extra-collective "
                             f"exited {inject_rc}, expected 1")
    emit("plan_lint", image=IMAGE, batch=BATCH, layers=len(prof.layers),
         trunk_seconds=seconds, launches=0, allocated_bytes=0,
         total_collectives=prof.total_collectives,
         peak_live_bytes=prof.peak_live_bytes, peaks=peaks,
         static_vs_dynamic=dynamic,
         gate=dict(limit=LINT_LIMIT, profiles=n, seconds=gate_s, rc=rc),
         gate_inject=dict(limit=LINT_INJECT_LIMIT, profiles=inject_n,
                          seconds=inject_s, rc=inject_rc))


# --------------------------------------------------------------------------
# Phase 17: plan artifacts (repro_torch.conv.export)
# --------------------------------------------------------------------------

def loaded_start_launches(n_layers, n_buckets, slabs=1):
    """Launches of an engine's start-up from a plan artifact: the
    ``WARMUP_PASSES`` eager forwards and the capture of every bucket, and
    no prepare (no stage 2)."""
    return sharded_launches(n_layers, slabs,
                            n_buckets * (batcher.WARMUP_PASSES + 1), 0)


def prepared_of(eng, key):
    """The prepared network bucket ``key``'s executor runs (replica 0)."""
    return eng._exec[0][key]._prepared


def slab_bytes(eng):
    """Bytes of the distinct prepared slabs an engine's executors hold."""
    seen = {}
    for ex in eng._exec[0].values():
        for layer in ex._prepared.layers.values():
            st = layer.state
            for t in (st if isinstance(st, tuple) else (st,)):
                s = t.untyped_storage()
                seen[s.data_ptr()] = s.nbytes()
    return sum(seen.values())


def check_loaded_slabs(what, aot, live):
    """Every bucket's loaded slabs equal the live engine's prepare's, bit
    for bit and stride for stride (a CGEMM operand of other strides would
    take another load form).  Returns the layer entries checked."""
    n = 0
    for key in live._exec[0]:
        loaded, prepared = prepared_of(aot, key), prepared_of(live, key)
        for name, layer in prepared.items():
            for a, b in zip(loaded[name].state, layer.state):
                if not (torch.equal(a, b) and a.stride() == b.stride()):
                    raise AssertionError(
                        f"{what} b{key[0]} {name}: a loaded slab differs "
                        "from the live prepare's")
            n += 1
    return n


def artifact_check(eng, res, rid, local):
    """Request ``rid`` of an engine served from an artifact (or its live
    fallback) against ``local`` (phase 9's or 14's result for the same
    request), within ``GRAPH_TOL``, and against cuDNN at its own batch,
    within ``SLICE_TOL``."""
    x = res.inputs[res.trace[rid].batch]
    y = eng.results[rid]
    direct = plan_network(res.make_layers(x.shape[0]), backend="direct")
    with torch.inference_mode():
        y_direct = res.forward(direct.prepare(res.kernels), x)
    torch.cuda.synchronize()
    out = dict(rid=rid, bucket=eng.placements[rid][0],
               rel_err_vs_served=rel_err(y, local),
               rel_err_vs_cudnn=rel_err(y, y_direct))
    if type(y) is not torch.Tensor or not bool(torch.isfinite(y).all()) \
            or not out["rel_err_vs_served"] <= GRAPH_TOL \
            or not out["rel_err_vs_cudnn"] <= SLICE_TOL:
        raise AssertionError(
            f"artifact request {out}: not a finite plain tensor within "
            f"{GRAPH_TOL} of the served result and {SLICE_TOL} of cuDNN")
    return out


def trace_through(eng, res, served_results, what):
    """Phase 9's trace through ``eng``: no launch, a replay a batch, zero
    plan-cache misses after warm-up, phase 9's placements; the first and
    last requests and the first of every bucket checked against
    ``served_results`` (``artifact_check``).  Returns (report, checks)."""
    zero_counts()
    rep = batcher.run_trace(eng, res.trace,
                            make_input=lambda b, _: res.inputs[b],
                            realtime=False)
    expect_counts(f"{what} trace", read_counts(), {})
    n_batches = sum(b["n_batches"] for b in rep["buckets"].values())
    replays = sum(map(sum, rep["graph_replays"].values()))
    if (rep["executor"], replays, rep["n_requests"],
            rep["plan_cache_misses_after_warmup"]) != (
            "cuda-graph", n_batches, SERVE_REQUESTS, 0):
        raise AssertionError(
            f"{what}: executor {rep['executor']}, {replays} replays for "
            f"{n_batches} batches, {rep['n_requests']} requests, "
            f"{rep['plan_cache_misses_after_warmup']} plan-cache misses "
            "after warm-up")
    rids = {0, SERVE_REQUESTS - 1}
    for label in rep["buckets"]:
        rids.add(min(r for r, p in eng.placements.items() if p[0] == label))
    checks = [artifact_check(eng, res, rid, served_results[rid])
              for rid in sorted(rids)]
    return rep, checks


def engine_of(res, **kw):
    """Phase 9's engine (its policy, forward, window and weights) on the
    card, with ``kw`` (``load_plans=``, ``mesh=``, ...)."""
    return batcher.ServeEngine(
        res.make_layers, res.kernels,
        policy=batcher.BucketPolicy(max_batch=SERVE_MAX_BATCH),
        forward=res.forward, window_s=SERVE_WINDOW_MS * 1e-3,
        device="cuda", backend="fft-cuda", **kw)


def warned_load(res, path, **kw):
    """An engine from ``path`` that must fall back to live planning with
    the engine's warning: (engine, the warning)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng = engine_of(res, load_plans=path, **kw)
    msgs = [str(w.message) for w in caught
            if "falling back to live planning" in str(w.message)]
    if eng.plan_source != "live" or not msgs:
        raise AssertionError(f"a stale artifact loaded as "
                             f"{eng.plan_source!r}, warnings {msgs}")
    return eng, msgs[0]


def tamper(path, out, **fields):
    """A copy of the artifact at ``path`` with manifest ``fields``
    replaced, every member copied as it is stored."""
    import zipfile
    with zipfile.ZipFile(path) as zin, \
            zipfile.ZipFile(out, "w", zipfile.ZIP_STORED) as zout:
        for info in zin.infolist():
            data = zin.read(info)
            if info.filename == "manifest.json":
                data = json.dumps(dict(json.loads(data), **fields))
            zout.writestr(info, data)
    return out


def coldstart(path=None):
    """``serve --serve-trace --conv-backend fft-cuda`` in a fresh process,
    with ``--load-plans path`` when given: its cold-start report, exit
    code, command seconds and certification line."""
    out = path + ".cs.json" if path else os.path.join(
        tempfile.gettempdir(), f"chip_smoke_live_{os.getpid()}.cs.json")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--serve-trace",
           "--conv-backend", "fft-cuda", "--coldstart-out", out]
    if path:
        cmd += ["--load-plans", path]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600, env=dict(
                              os.environ, PYTHONPATH=os.path.join(ROOT,
                                                                  "src")))
    seconds = time.perf_counter() - t0
    if proc.returncode:
        raise AssertionError(
            f"serve {'--load-plans' if path else 'live'} in a fresh "
            f"process exited {proc.returncode}:\n{proc.stdout[-2000:]}\n"
            f"{proc.stderr[-2000:]}")
    with open(out) as fh:
        report = json.load(fh)
    os.remove(out)
    line = next((ln for ln in proc.stdout.splitlines()
                 if ln.startswith("load-plans")), None)
    return dict(report, command_s=seconds, certification=line)


def plan_artifacts_phase(served, tuned_net, tune_sweep_s):
    """Phase 17, on the card: phase 9's engine exported from a live engine
    and served from the artifact in a fresh engine, its tampered and stale
    copies falling back, ``serve --load-plans`` in a fresh process beside
    a live one, and phase 10's tuned trunk loaded onto an empty tuning
    cache.  Returns the launches."""
    from repro_torch.conv import export as planx
    res = served.res
    n_layers = len(serve._vgg_scale(IMAGE))
    n_buckets = len(batcher.BucketPolicy(
        max_batch=SERVE_MAX_BATCH).batch_buckets())
    total = dict.fromkeys(KERNELS, 0)

    def add(counts):
        for k in KERNELS:
            total[k] += counts[k]
        return counts

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_plans_")
    path = os.path.join(tmp.name, "vgg.rpa")
    try:
        # the live engine: every bucket prepared afresh
        clear_prepared_cache()
        zero_counts()
        live = engine_of(res)
        expect_counts("artifact live engine", add(read_counts()),
                      engine_launches(n_layers, n_buckets))
        zero_counts()
        t0 = time.perf_counter()
        live.export_plans(path)
        export_s = time.perf_counter() - t0
        # every prepare hits the live engine's prepared spectra
        expect_counts("export", add(read_counts()), {})
        manifest = planx.read_manifest(path)
        layers = [e for n in manifest["nets"].values()
                  for e in n["layers"].values()]
        slab_members = {m for e in layers for m in e["state"]}

        # a fresh engine from the artifact
        plans = plan_cache_info()
        zero_counts()
        aot = engine_of(res, load_plans=path)
        torch.cuda.synchronize()
        start_counts = add(read_counts())
        want_start = loaded_start_launches(n_layers, n_buckets)
        expect_counts("engine from the artifact", start_counts, want_start)
        if aot.plan_source != "aot" or plan_cache_info() != plans:
            raise AssertionError(
                f"engine from the artifact: source {aot.plan_source}, plan "
                f"cache {plan_cache_info()} (was {plans})")
        n_slabs_checked = check_loaded_slabs("artifact", aot, live)
        rep, checks = trace_through(aot, res, served.results, "artifact")
        if aot.placements != served.placements:
            raise AssertionError("artifact: placements differ from phase "
                                 "9's")
        bytes_live, bytes_loaded = slab_bytes(live), slab_bytes(aot)
        t0 = time.perf_counter()
        cert = planx.verify(path)
        verify_s = time.perf_counter() - t0
        if not cert["ok"] or cert["n_checked"] != n_layers * n_buckets:
            raise AssertionError(f"verify: {cert}")
        # the fingerprint on the card's default device and on the host
        net4 = live.nets[(4, None)]
        fps = {name: (planx.plan_fingerprint(p, prepared=True),
                      planx.plan_fingerprint(p, prepared=True, device="cpu"),
                      manifest["nets"]["b4"]["layers"][name]["fingerprint"])
               for name, p in net4.items()}
        if any(len(set(f)) != 1 for f in fps.values()):
            raise AssertionError(f"fingerprints differ between the card's "
                                 f"analysis, the host's and the export's: "
                                 f"{fps}")
        aot_report = aot.report()
        del aot, live
        torch.cuda.empty_cache()

        # a copy stamped for another device falls back, with equal results
        bad = tamper(path, os.path.join(tmp.name, "other_device.rpa"),
                     device_name="NVIDIA A100-SXM4-80GB")
        zero_counts()
        eng, device_warning = warned_load(res, bad)
        add(read_counts())
        _, tampered_checks = trace_through(eng, res, served.results,
                                           "tampered artifact")
        del eng
        os.remove(bad)
        # an engine of another weights_version falls back
        zero_counts()
        eng, version_warning = warned_load(res, path, weights_version=7,
                                           warm=False)
        add(read_counts())
        del eng
        clear_prepared_cache()
        torch.cuda.empty_cache()

        # fresh processes: live, then from the artifact
        cold_live = coldstart()
        cold_aot = coldstart(path)
        if (cold_aot["source"], cold_aot["fingerprints_verified"],
                cold_aot["plan_cache_misses_after_warmup"]) != (
                "aot", True, 0):
            raise AssertionError(f"serve --load-plans: {cold_aot}")
        artifact_mb = os.path.getsize(path) / 1e6
        os.remove(path)

        tuned = tuned_artifact(tuned_net, served, tmp.name, add)
    finally:
        tmp.cleanup()
    emit("plan_artifacts", image=IMAGE, max_batch=SERVE_MAX_BATCH,
         requests=SERVE_REQUESTS, buckets=n_buckets, layers=n_layers,
         export_s=export_s, artifact_mb=artifact_mb,
         layer_entries=len(layers), distinct_slab_members=len(slab_members),
         distinct_slab_sets=len({tuple(e["state"]) for e in layers}),
         distinct_members=len(manifest["tensors"]),
         load_s=aot_report["startup_load_s"],
         capture_s=aot_report["startup_capture_s"],
         startup_s=aot_report["startup_s"],
         launches_at_start=start_counts,
         slab_entries_bit_equal=n_slabs_checked,
         slab_bytes_live=bytes_live, slab_bytes_loaded=bytes_loaded,
         batches=sum(b["n_batches"] for b in rep["buckets"].values()),
         graph_replays=rep["graph_replays"],
         plan_cache_misses_after_warmup=rep[
             "plan_cache_misses_after_warmup"],
         tol=GRAPH_TOL, tol_cudnn=SLICE_TOL, checked=checks,
         verify=dict(ok=cert["ok"], n_checked=cert["n_checked"],
                     seconds=verify_s),
         fingerprints_card_equal_host=len(fps),
         tampered_device=dict(warning=device_warning[:300],
                              checked=tampered_checks),
         stale_weights_version=dict(warning=version_warning[:300]),
         coldstart_live=cold_live, coldstart_aot=cold_aot,
         tuned=dict(tuned, sweep_s_phase10=tune_sweep_s))
    return total


def tuned_artifact(net, served, tmp, add):
    """Phase 10's tuned trunk exported, then loaded after
    ``autotune.reset()`` onto an empty temporary tuning cache: nothing
    measured, no launch, every layer's resolved backend, CGEMM row and
    ``dft_bt`` those of the export, the output within ``SLICE_TOL`` of
    cuDNN."""
    from repro_torch.conv import export as planx
    res = served.res
    path = os.path.join(tmp, "tuned.rpa")
    zero_counts()
    t0 = time.perf_counter()
    net.export(path, params=res.kernels, weights_version=0)
    export_s = time.perf_counter() - t0
    add(read_counts())
    saved = {k: os.environ.pop(k) for k in TUNE_ENV if k in os.environ}
    cache = os.path.join(tmp, "empty_tune.json")
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = cache
    try:
        autotune.reset()
        zero_counts()
        t0 = time.perf_counter()
        loaded = planx.load_network(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        load_counts = add(read_counts())
        expect_counts("tuned artifact load", load_counts, {})
        info = autotune_info()
        if loaded.source != "aot" or autotune.sweeps() or info.measured \
                or os.path.exists(cache):
            raise AssertionError(
                f"tuned artifact load: source {loaded.source}, "
                f"{info}, sweeps {autotune.sweeps()}")
        keys = ("backend", "schedule", "spectrum", "bm", "bn", "bk",
                "dft_bt", "overlap")
        differ = {name: [k for k in keys if getattr(layer.plan, k)
                         != getattr(net[name], k)]
                  for name, layer in loaded.items()}
        if any(differ.values()):
            raise AssertionError(f"tuned artifact: layers differ from the "
                                 f"export's in {differ}")
        zero_counts()
        direct = plan_network(network_convs(serve._vgg_scale(IMAGE), BATCH),
                              backend="direct")
        x = served.xa                   # batch 4, the tuned trunk's
        with torch.inference_mode():
            y = res.forward(loaded, x)
            y_ref = res.forward(direct.prepare(res.kernels), x)
        torch.cuda.synchronize()
        add(read_counts())
        rel = rel_err(y, y_ref)
        if not bool(torch.isfinite(y).all()) or not rel <= SLICE_TOL:
            raise AssertionError(f"tuned artifact vs cuDNN: {rel:.3e}")
    finally:
        for k in TUNE_ENV:
            os.environ.pop(k, None)
        os.environ.update(saved)
        autotune.reset()
    return dict(export_s=export_s, load_s=load_s, load_launches=load_counts,
                artifact_mb=os.path.getsize(path) / 1e6,
                backends={n: layer.plan.backend
                          for n, layer in loaded.items()},
                rel_err_vs_cudnn=rel, tol=SLICE_TOL)


def sharded_artifacts(mesh, served, served14):
    """Phase 17's sharded half, inside phase 11's process group: phase
    14's nfft ``off`` engine exported from a live engine over the mesh
    (rank 0 gathers and writes) and loaded with ``load_network(mesh=)``
    (no stage 2, no collective, the caller's mesh, slabs bit-equal to the
    live prepare's), then served from the artifact (start-up without
    prepares) with results within ``GRAPH_TOL`` of phase 14's and
    ``SLICE_TOL`` of cuDNN.  Returns the launches."""
    from repro_torch.conv import export as planx
    res = served.res
    n_layers = len(serve._vgg_scale(IMAGE))
    n_buckets = len(batcher.BucketPolicy(
        max_batch=SERVE_MAX_BATCH).batch_buckets())
    total = dict.fromkeys(KERNELS, 0)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_plans_")
    path = os.path.join(tmp.name, "vgg_nfft.rpa")
    kw = dict(mesh=mesh, schedule="nfft", overlap="off")
    try:
        clear_prepared_cache()
        zero_counts()
        live = engine_of(res, warm=False, **kw)
        t0 = time.perf_counter()
        live.export_plans(path)
        export_s = time.perf_counter() - t0
        counts = read_counts()
        total = {k: total[k] + counts[k] for k in KERNELS}
        expect_counts("sharded export", counts, {
            "tile_rfft": n_layers * n_buckets})   # the live prepares only

        zero_counts()
        t0 = time.perf_counter()
        with stages.stage_trace() as trace:
            nets = planx.load_network(path, mesh=mesh)
            torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        expect_counts("sharded load", read_counts(), {})
        check_serve_collectives("sharded load", trace, {})
        if {n.source for n in nets.values()} != {"aot"} or any(
                layer.plan.mesh is not mesh
                for n in nets.values() for layer in n.layers.values()):
            raise AssertionError("sharded load: not ahead of time on the "
                                 "caller's mesh")
        n_equal = 0
        for key in live._exec[0]:
            prepared = prepared_of(live, key)
            for name, layer in nets[f"b{key[0]}"].items():
                for a, b in zip(layer.state, prepared[name].state):
                    if not (torch.equal(a, b) and a.stride() == b.stride()):
                        raise AssertionError(
                            f"sharded load b{key[0]} {name}: a slab "
                            "differs from the live prepare's")
                n_equal += 1
        del nets, live
        clear_prepared_cache()
        torch.cuda.empty_cache()

        zero_counts()
        with stages.stage_trace() as trace:
            eng = engine_of(res, load_plans=path, **kw)
            torch.cuda.synchronize()
        counts = read_counts()
        total = {k: total[k] + counts[k] for k in KERNELS}
        expect_counts("sharded engine from the artifact", counts,
                      loaded_start_launches(n_layers, n_buckets))
        if eng.plan_source != "aot":
            raise AssertionError(f"sharded engine: {eng.plan_source}")
        rep, checks = trace_through(eng, res, served14, "sharded artifact")
        report = eng.report()
        del eng
        torch.cuda.empty_cache()
        artifact_mb = os.path.getsize(path) / 1e6
    finally:
        tmp.cleanup()
    emit("plan_artifacts_sharded", mesh=[1, 1], backend="nccl",
         schedule="nfft", overlap="off", export_s=export_s,
         artifact_mb=artifact_mb, load_s=load_s,
         slab_entries_bit_equal=n_equal,
         engine_load_s=report["startup_load_s"],
         engine_capture_s=report["startup_capture_s"],
         rank_broadcasts=report["rank_broadcasts"],
         graph_replays=rep["graph_replays"], tol=GRAPH_TOL,
         tol_cudnn=SLICE_TOL, checked=checks)
    return total


def sharded_phase(res, y_ref, slice_p50_ms, profile_busy_us, checked,
                  checked_dft, local_train, served):
    """Phases 11-14, 16 and 17's sharded half: the paper's schedules on a
    one-rank NCCL mesh: serving, training, tuning, phase 9's engine over
    the mesh (``served``: what phase 9 served), plan-lint, and the nfft
    engine's plan artifact.  A process group that fails to
    start fails the smoke: there is no fallback.  ``checked`` and ``checked_dft``
    hold the CGEMM and compact tile DFT cases held already; ``local_train``
    is phase 7's fft-cuda step.  Returns the launches of both phases and
    the compact tile DFT rows, for ``device_times``."""
    tmesh.start_process_group("nccl", device_id=torch.device("cuda", 0))
    try:
        mesh = tmesh.make_mesh((1, 1), ("data", "model"))
        convs = network_convs(serve._vgg_scale(IMAGE), BATCH)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
        slab_rows = check_slab_cgemm(mesh, convs, gen, checked)
        dft_rows = check_slab_dft(mesh, convs, gen, checked_dft)
        configs, total = [], dict.fromkeys(KERNELS, 0)
        for schedule, overlap in SHARDED:
            report, counts = sharded_trunk(schedule, overlap, mesh, convs,
                                           res, res.y, y_ref)
            configs.append(report)
            total = {k: total[k] + counts[k] for k in KERNELS}
        one_shot, counts = sharded_one_shot(mesh, convs, res, gen)
        total = {k: total[k] + counts[k] for k in KERNELS}
        train, train_counts = sharded_train(mesh, local_train)
        tune_counts = sharded_tune(mesh, convs, res, res.y, y_ref, configs)
        serve_reports, serve_counts, served14 = sharded_serve(
            mesh, served, configs)
        plan_lint_phase(mesh, convs, res)
        artifact_counts = sharded_artifacts(mesh, served, served14)
    finally:
        tmesh.destroy_process_group()
    emit("sharded", mesh=[1, 1], backend="nccl", image=IMAGE, batch=BATCH,
         configs=configs, one_shot=one_shot, launches=total,
         slab_cgemm_cases=len(slab_rows),
         slab_cgemm_dx_plan_cases=sum(r["dx_plan"] for r in slab_rows),
         slab_dft_cases=dict(collections.Counter(
             r["kernel"] for r in dft_rows)),
         local_slice_p50_ms=slice_p50_ms,
         local_profile_busy_us=profile_busy_us)
    emit("sharded_train", mesh=[1, 1], backend="nccl", image=IMAGE,
         batch=BATCH, steps=TRAIN_STEPS, configs=train,
         launches=train_counts, local_step_ms=local_train["step_ms"],
         local_device_busy_us=local_train["device_busy_us"],
         local_idle_share_vs_median_step=local_train["idle_share"])
    emit("sharded_serve", mesh=[1, 1], backend="nccl", image=IMAGE,
         max_batch=SERVE_MAX_BATCH, requests=SERVE_REQUESTS,
         window_ms=SERVE_WINDOW_MS, configs=serve_reports,
         launches=serve_counts)
    return {k: total[k] + train_counts[k] + tune_counts[k]
            + serve_counts[k] + artifact_counts[k] for k in KERNELS}, dft_rows


def lm_greedy(cfg, params, device, pos0=None):
    """``serve.generate`` (``serve``'s prefill step then ``LM_STEPS`` greedy
    decode steps, from position ``pos0``, by default ``serve``'s) on
    ``device``, and the teacher-forced forward over the prompt and the
    generated tokens (whisper: ``decode_train`` over the first prompt token
    and them).  Returns (the steps' logits, the tokens, the forward's
    logits)."""
    rng = np.random.default_rng(SEED)
    prompts = torch.tensor(rng.integers(1, cfg.vocab, (LM_BATCH, LM_PROMPT)),
                           device=device)
    frames = None
    if cfg.encdec:
        frames = torch.tensor(rng.standard_normal((LM_BATCH, 24, cfg.d_model)),
                              dtype=torch.float32, device=device)
    out = serve.generate(cfg, params, prompts, LM_STEPS + 1, frames, pos0)
    with torch.inference_mode():
        if cfg.encdec:
            forward = WH.decode_train(
                params, cfg, WH.encode(params, cfg, frames),
                torch.cat([prompts[:, :1], out.tokens[:, :-1]], 1))
        else:
            forward = LM.lm_forward(
                params, cfg, torch.cat([prompts, out.tokens[:, :-1]], 1))
    return out.steps, out.tokens, forward


def lm_scaled_err(got, want):
    return ((got.double().cpu() - want.double().cpu()).abs().max()
            / want.double().abs().max()).item()


def lm_planted_faults(params, cfg, seq):
    """The last position's logits of ``lm_forward`` over ``seq`` as three
    wrong models would compute them: without the per-head q/k RMSNorm,
    with RoPE's theta at 1e4 (the default) for the config's, and with the
    last layer skipped.  The bf16 gate of phase 18 must tell each from
    the served decode step."""
    def skip_last(t):
        return t[:-1]
    with torch.inference_mode():
        return {
            "qk_norm_off": LM.lm_forward(
                params, dataclasses.replace(cfg, qk_norm=False),
                seq)[:, -1],
            "rope_theta_1e4": LM.lm_forward(
                params, dataclasses.replace(cfg, rope_theta=1e4),
                seq)[:, -1],
            "last_layer_skipped": LM.lm_forward(
                dict(params, layers=[torch.utils._pytree.tree_map(
                    skip_last, u) for u in params["layers"]]),
                dataclasses.replace(cfg, n_layers=cfg.n_layers - 1),
                seq)[:, -1],
        }


def lm_small(arch, device="cuda"):
    """Phase 18 for one architecture's small form: float32 on ``device``
    (the card) against the host, and bf16 decode against forward on
    ``device``."""
    cfg32 = dataclasses.replace(get_config(arch, smoke=True),
                                dtype="float32")
    init = WH.init_whisper_params if cfg32.encdec else LM.init_lm_params
    host = init(cfg32, torch.Generator().manual_seed(SEED))
    card = torch.utils._pytree.tree_map(lambda t: t.to(device), host)
    h_steps, h_toks, h_fwd = lm_greedy(cfg32, host, "cpu")
    c_steps, c_toks, c_fwd = lm_greedy(cfg32, card, device)
    errs = [lm_scaled_err(c, h) for c, h in zip(c_steps + [c_fwd],
                                                 h_steps + [h_fwd])]
    if not max(errs) <= LM_TOL:
        raise AssertionError(f"{arch}: card vs host {errs} > {LM_TOL}")
    if not torch.equal(c_toks.cpu(), h_toks):
        raise AssertionError(f"{arch}: greedy tokens differ on the card: "
                             f"{c_toks.tolist()} vs {h_toks.tolist()}")
    # bf16 on the card: each step against the teacher-forced forward, at
    # consistent positions (no vision-stub offset)
    cfg = get_config(arch, smoke=True)
    meta = 0 if cfg.encdec else cfg.n_meta_tokens
    first = 0 if cfg.encdec else meta + LM_PROMPT - 1
    steps, _, fwd = lm_greedy(cfg, card, device,
                              1 if cfg.encdec else LM_PROMPT + meta)
    worst, within = 0.0, True
    for i, lg in enumerate(steps):
        a, b = lg[:, -1].double(), fwd[:, first + i].double()
        worst = max(worst, (a - b).abs().max().item())
        within &= bool(((a - b).abs()
                        <= LM_DECODE_TOL * (1 + b.abs())).all())
    gated = arch not in LM_DECODE_UNGATED
    if gated and not within:
        raise AssertionError(f"{arch}: bf16 decode vs forward beyond rtol = "
                             f"atol = {LM_DECODE_TOL}")
    return {"arch": arch, "card_vs_host_max": max(errs),
            "card_vs_host": errs, "tokens": c_toks.tolist(),
            "bf16_decode_vs_forward_max_abs": worst,
            "bf16_decode_vs_forward_within": within,
            "bf16_decode_vs_forward_gated": gated}


LM_CHILD = r"""
import dataclasses, json, sys, time
import torch
import chip_smoke as smoke
from repro_torch.launch import serve
from repro_torch.models import lm as LM
torch.backends.cuda.matmul.allow_tf32 = False
torch.cuda.reset_peak_memory_stats()
res = serve.main(sys.argv[1:])
serve_peak = torch.cuda.max_memory_allocated()
cfg, p = res.cfg, res.params
B, P = res.prompts.shape
n = res.tokens.shape[1]
seq = torch.cat([res.prompts, res.tokens[:, :-1]], 1)


def scaled(a, b):
    a, b = a.double(), b.double()
    return ((a - b).abs().max() / b.abs().max()).item()


with torch.inference_mode():
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = LM.lm_forward(p, cfg, seq)
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    faults = smoke.lm_planted_faults(p, cfg, seq)
    # the same weights and tokens in float32: prefill, the decode steps
    # teacher-forced on the served tokens, and the forward
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    dev = res.prompts.device
    cache = LM.init_cache(cfg32, B, P + n + 8, device=dev)
    lg, cache, _ = LM.lm_prefill(p, cfg32, res.prompts, cache,
                                 use_flash=False)
    for i in range(n - 1):
        lg, cache = LM.lm_decode_step(p, cfg32, res.tokens[:, i:i + 1],
                                      P + i, cache)
    full32 = LM.lm_forward(p, cfg32, seq)
    # device time by kernel of one more bf16 decode step
    cache = LM.init_cache(cfg, B, P + n + 8, device=dev)
    step = lambda: LM.lm_decode_step(p, cfg, res.tokens[:, -1:], P + n - 1,
                                     cache)
    step()
    torch.cuda.synchronize()
    rows, busy_us, wall_us, _ = smoke.device_profile(step)
a, b = res.logits[:, -1], full[:, -1]
print("lm_full " + json.dumps({
    "finite": bool(torch.isfinite(res.logits).all()),
    "tokens_shape": list(res.tokens.shape),
    "logits_shape": list(res.logits.shape),
    "err": scaled(a, b),
    "rel_l2": ((a - b).double().norm() / b.double().norm()).item(),
    "err_one_position_off": scaled(a, full[:, -2]),
    "err_planted_faults": {k: scaled(a, f) for k, f in faults.items()},
    "err_float32": scaled(lg[:, -1], full32[:, -1]),
    "max_abs_logit": b.abs().max().item(),
    "teacher_forced_token_agreement": (
        full[:, P - 1:].argmax(-1) == res.tokens).double().mean().item(),
    "prefill_ms": res.prefill_s * 1e3,
    "decode_ms_per_step": res.decode_s * 1e3 / (n - 1),
    "tokens_per_s": res.tokens_per_s,
    "forward_ms": forward_s * 1e3,
    "serve_peak_bytes": serve_peak,
    "peak_bytes": torch.cuda.max_memory_allocated(),
    "n_params": cfg.n_params(),
    "param_bytes": sum(t.numel() * t.element_size() for t in
                       torch.utils._pytree.tree_leaves(p)),
    "decode_step_profile": {
        "busy_ms": busy_us / 1e3, "wall_ms": wall_us / 1e3,
        "top": [[name.split("(")[0][:100], us / 1e3, calls]
                for us, name, calls in rows[:8]]},
}))
"""


def check_lm_full(r):
    """The gates on the child's ``lm_full`` record: finite logits and
    tokens of the served shapes; the last decode step within
    ``LM_FULL_TOL`` of ``lm_forward`` in bf16 and ``LM_TOL`` in float32;
    and every planted fault (``lm_planted_faults``, and the logits one
    position off) beyond ``LM_FULL_TOL``, so that the bf16 gate is shown
    to see them."""
    if not (r["finite"] and r["tokens_shape"] == [4, 16]
            and r["logits_shape"][-1] == get_config("qwen3-14b").vocab):
        raise AssertionError(f"qwen3-14b serve output: {r}")
    if not (r["err"] <= LM_FULL_TOL and r["err_float32"] <= LM_TOL):
        raise AssertionError(
            f"qwen3-14b: last decode step vs lm_forward {r['err']:.3e} "
            f"(bf16, tol {LM_FULL_TOL}), {r['err_float32']:.3e} (float32, "
            f"tol {LM_TOL})")
    faults = dict(r["err_planted_faults"],
                  one_position_off=r["err_one_position_off"])
    unseen = {k: e for k, e in faults.items() if not e > LM_FULL_TOL}
    if unseen:
        raise AssertionError(f"qwen3-14b: the bf16 gate ({LM_FULL_TOL}) "
                             f"cannot tell these planted faults: {unseen}")


def lm_full():
    """qwen3-14b at full width: ``serve --arch`` in a child process, its
    last decode step held to ``lm_forward`` there."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", LM_CHILD, *LM_FULL_ARGS], cwd=ROOT,
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    seconds = time.perf_counter() - t0
    if proc.returncode:
        raise AssertionError(f"serve {' '.join(LM_FULL_ARGS)} exited "
                             f"{proc.returncode}:\n{proc.stdout[-2000:]}\n"
                             f"{proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    r = json.loads(next(ln for ln in lines
                        if ln.startswith("lm_full "))[len("lm_full "):])
    check_lm_full(r)
    serve_line = next(ln for ln in lines if ln.startswith("arch="))
    busy = r["decode_step_profile"]["busy_ms"]
    return dict(r, serve_line=serve_line, command_s=seconds,
                decode_idle_share=1 - busy / r["decode_ms_per_step"])


def lm_serve_phase():
    """Phase 18: the LM serving path (no hand-written kernel)."""
    gc.collect()
    torch.cuda.empty_cache()
    before = {"allocated_bytes": torch.cuda.memory_allocated(),
              "reserved_bytes": torch.cuda.memory_reserved()}
    zero_counts()
    t0 = time.perf_counter()
    small = [lm_small(arch) for arch in ARCH_NAMES]
    small_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    full = lm_full()
    counts = read_counts()
    expect_counts("lm_serve", counts, {})
    emit("lm_serve", archs=small, tol=LM_TOL, decode_tol=LM_DECODE_TOL,
         small_s=small_s, launches=counts)
    emit("lm_serve_full", args=LM_FULL_ARGS, tol=LM_FULL_TOL,
         this_process_before=before, nvidia_smi=nvidia_smi(), **full)
    return counts


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    emit("device", nvidia_smi=card, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    t0 = time.perf_counter()
    _build.build()
    emit("build", seconds=time.perf_counter() - t0,
         ptxas={k: ptxas_report(_build.build_log(k))
                for k in _build.KERNELS})

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    layers = main_path_layers()
    dx_layers = dx_plan_layers()
    cg_rows = check_cgemm(layers, gen)
    inv_rows = check_inverse(layers, gen)
    fwd_rows = check_forward(layers, gen)
    binv_rows = check_plain_inverse(dx_layers, gen)
    rfwd_rows = check_rect_forward(layers, gen)
    rinv_rows, rinv_ep_rows = check_rect_inverse(layers, gen)
    tiles_rows = check_inverse_tiles(layers, dx_layers, gen)
    check_generic_tiles(gen)
    check_dk(gen)

    # the slice: counters at 0 right before the served run, read right after
    zero_counts()
    res = serve.main(["--convnet", "vgg", "--conv-backend", "fft-cuda",
                      "--image", str(IMAGE), "--batch", str(BATCH),
                      "--gen", str(GEN), "--timing", "per-request",
                      "--seed", str(SEED), "--analyze"])
    slice_counts = read_counts()
    n_forward = GEN + 1                # request loop + post-update forward
    n_prepare = 2                      # weights versions 0 and 1
    n_layers = len(layers)
    # per forward one forward tile DFT, CGEMM and fused inverse a layer;
    # per prepare one forward tile DFT a layer
    expect_counts("served slice", slice_counts, {
        "cgemm": n_layers * n_forward,
        "tile_irfft_epilogue": n_layers * n_forward,
        "tile_rfft": n_layers * (n_forward + n_prepare), "tile_irfft": 0})
    y = res.y
    want = (BATCH, 512, IMAGE // 32, IMAGE // 32)
    if tuple(y.shape) != want or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"served output {tuple(y.shape)} (want "
                             f"{want}) or not finite")
    direct = plan_network(network_convs(serve._vgg_scale(IMAGE), BATCH),
                          backend="direct")
    with torch.inference_mode():
        y_ref = serve._vgg_forward(res.biases)(direct.prepare(res.kernels),
                                               res.x)
    torch.cuda.synchronize()
    rel = ((y - y_ref).abs().max() / y_ref.abs().max()).item()
    if not rel <= SLICE_TOL:
        raise AssertionError(f"fft-cuda trunk vs cuDNN: {rel:.3e} > "
                             f"{SLICE_TOL}")
    slice_p50_ms = serve._percentile(res.latencies_s, 50) * 1e3
    emit("slice", backend="fft-cuda", image=IMAGE, batch=BATCH,
         forwards=n_forward, prepares=n_prepare, launches=slice_counts,
         launches_per_forward={"tile_rfft": n_layers, "cgemm": n_layers,
                               "tile_irfft_epilogue": n_layers},
         launches_per_prepare={"tile_rfft": n_layers},
         rel_err_vs_cudnn=rel, tol=SLICE_TOL, prepare_ms=res.prepare_s * 1e3,
         p50_ms=slice_p50_ms,
         p99_ms=serve._percentile(res.latencies_s, 99) * 1e3,
         latencies_ms=[t * 1e3 for t in res.latencies_s])

    profile_busy_us = profile_forward(res)
    rect_counts = rect_phase(res, layers, y_ref, slice_p50_ms)
    train_counts, local_train = train_phase()
    trainer_counts = trainer_phase()
    trace_counts, served = serve_trace_phase(slice_p50_ms, profile_busy_us)
    tune_counts, tuned_net, tune_sweep_s = tune_phase(
        res, y_ref, slice_p50_ms, profile_busy_us)
    artifact_counts = plan_artifacts_phase(served, tuned_net, tune_sweep_s)
    checked = {(*r["shape"], r["variant"]) for r in cg_rows
               if r["dtype"] == "float32" and r["three_m"]
               and r["spectrum"] == "real"}
    sharded_counts, sdft_rows = sharded_phase(
        res, y_ref, slice_p50_ms, profile_busy_us, checked,
        {dft_key(r) for r in fwd_rows + inv_rows + binv_rows}, local_train,
        served)
    entry_counts = entry_points_phase()
    device_times(fwd_rows + rfwd_rows + inv_rows + binv_rows + sdft_rows
                 + rinv_rows + rinv_ep_rows + tiles_rows)
    # phase 18 last, with this process's tensors and caches freed for the
    # full-width model in its child process
    res = y = y_ref = direct = served = tuned_net = local_train = None
    clear_plan_cache()
    clear_prepared_cache()
    lm_counts = lm_serve_phase()

    # launches: the main paths together (slice, rect, train, trainer,
    # serve_trace, tune, plan_artifacts, sharded, sharded_train,
    # sharded_tune, sharded_serve, plan_artifacts_sharded, entry_points,
    # lm_serve)
    launches = {k: slice_counts[k] + rect_counts[k] + train_counts[k]
                + trainer_counts[k] + trace_counts[k] + tune_counts[k]
                + artifact_counts[k] + sharded_counts[k] + entry_counts[k]
                + lm_counts[k] for k in KERNELS}
    main_cg = [r for r in cg_rows if r["dtype"] == "float32"
               and r["three_m"] and r["spectrum"] == "real"]
    main_inv = inv_rows[:n_layers]
    main_fwd = [r for r in fwd_rows if r["stage"] == "stage1"]
    rect_fwd = [r for r in rfwd_rows if r["stage"] == "stage1"]
    rect_ep = [r for r in rinv_ep_rows if r["activation"] == "relu"]
    tiles_summary(main_inv + binv_rows + rinv_rows + rect_ep, tiles_rows)
    print(json.dumps({"kernels": [
        summarize("cgemm", main_cg, launches["cgemm"], True),
        summarize("tile_irfft_epilogue", main_inv,
                  launches["tile_irfft_epilogue"], False),
        summarize("tile_rfft", main_fwd, launches["tile_rfft"], True),
        summarize("tile_irfft", binv_rows, launches["tile_irfft"], True),
        summarize("tile_fft", rect_fwd, launches["tile_fft"], True),
        summarize("tile_ifft", rinv_rows, launches["tile_ifft"], True),
        summarize("tile_ifft_epilogue", rect_ep,
                  launches["tile_ifft_epilogue"], False),
    ]}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
